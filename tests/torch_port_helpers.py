"""Shared helpers of the port's tests (tests/test_torch_*.py): the same
schema, config and weights built for both packages from numpy."""

import jax
import jax.numpy as jnp
import numpy as np

import deepfm_tpu.config as jcfg
import deepfm_tpu.data.schema as jschema
import deepfm_tpu_torch.config as tcfg
import deepfm_tpu_torch.data.schema as tschema

# (name, type, vocab, dim, max_length)
SYNTH_SPEC = [
    ("user", "sparse", 50, 16, 1),
    ("item", "sparse", 80, 16, 1),
    ("tags", "sequence", 12, 8, 4),
    ("price", "dense", 0, 8, 1),
    ("hour", "dense", 0, 4, 1),
]

# the MovieLens adapter's 16 fields and widths, at small vocabularies
MOVIELENS_SPEC = [
    ("user_id", "sparse", 41, 16, 1),
    ("movie_id", "sparse", 57, 16, 1),
    ("gender", "sparse", 3, 4, 1),
    ("age", "sparse", 8, 4, 1),
    ("occupation", "sparse", 22, 8, 1),
    ("zip_prefix", "sparse", 30, 8, 1),
    ("genres", "sequence", 19, 8, 6),
    ("release_year_bucket", "sparse", 15, 4, 1),
    ("movie_age_at_rating", "sparse", 7, 4, 1),
    ("num_genres", "sparse", 4, 4, 1),
    ("dow_sin", "dense", 0, 4, 1),
    ("dow_cos", "dense", 0, 4, 1),
    ("hour_sin", "dense", 0, 4, 1),
    ("hour_cos", "dense", 0, 4, 1),
    ("user_rating_count", "dense", 0, 8, 1),
    ("item_rating_count", "dense", 0, 8, 1),
]


def schema_pair(spec):
    """The same DatasetSchema in both packages."""
    out = []
    for mod in (jschema, tschema):
        fields = {
            name: mod.FieldSchema(
                name, mod.FeatureType(kind), vocab, dim, "g",
                max_length=max_len, combiner="mean",
            )
            for name, kind, vocab, dim, max_len in spec
        }
        out.append(mod.DatasetSchema(fields=fields))
    return tuple(out)


def config_pair(raw):
    """The same ExperimentConfig in both packages."""
    return jcfg.config_from_dict(raw), tcfg.config_from_dict(raw)


def random_features(spec, n, seed):
    """Feature dict with random ids (some 0 = padding/OOV) and floats."""
    rng = np.random.default_rng(seed)
    feats = {}
    for name, kind, vocab, _, max_len in spec:
        if kind == "sparse":
            feats[name] = rng.integers(0, vocab, n)
        elif kind == "sequence":
            vals = rng.integers(0, vocab, (n, max_len))
            lengths = rng.integers(0, max_len + 1, n)  # empty bags too
            for i, ln in enumerate(lengths):
                vals[i, ln:] = 0
            feats[name] = vals
        else:
            feats[name] = rng.normal(size=n).astype(np.float32)
    return feats


def init_jax_model(model, ids, dense, seed=0):
    """JAX variables for ``model`` with its BN running statistics moved
    off their (0, 1) init, so eval-mode BatchNorm is really exercised."""
    variables = jax.device_get(
        model.init(jax.random.PRNGKey(seed), jnp.asarray(ids),
                   jnp.asarray(dense))
    )
    rng = np.random.default_rng(seed + 7)
    stats = variables.get("batch_stats", {})
    for layer in stats.get("dnn", {}).values():
        layer["mean"] = rng.normal(0, 0.1, layer["mean"].shape).astype(
            np.float32
        )
        layer["var"] = rng.uniform(0.5, 1.5, layer["var"].shape).astype(
            np.float32
        )
    return variables["params"], stats


def jax_predict(model, params, stats, ids, dense):
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    return np.asarray(
        model.apply(variables, jnp.asarray(ids), jnp.asarray(dense),
                    method=model.predict)
    )[:, 0]


def count_params(tree):
    return sum(int(np.size(x)) for x in jax.tree_util.tree_leaves(tree))
