"""Synthetic datasets: ML-100K-format generator + Criteo-scale CTR adapter.

The port's own copy of ``deepfm_tpu/data/synthetic.py``:
``generate_movielens_like`` writes the same files for the same seed, and
``build_adapter`` is the dataset registry the CLI uses (``movielens``,
``criteo_synthetic`` and the on-disk ``packed`` store of
``data/store.py``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from deepfm_tpu_torch.config import DataConfig
from deepfm_tpu_torch.data.dataset import TabularDataset
from deepfm_tpu_torch.data.schema import DatasetSchema, FeatureType, FieldSchema

_GENRES = [
    "unknown", "Action", "Adventure", "Animation", "Children's", "Comedy",
    "Crime", "Documentary", "Drama", "Fantasy", "Film-Noir", "Horror",
    "Musical", "Mystery", "Romance", "Sci-Fi", "Thriller", "War", "Western",
]
_OCCUPATIONS = [
    "administrator", "artist", "doctor", "educator", "engineer",
    "entertainment", "executive", "healthcare", "homemaker", "lawyer",
    "librarian", "marketing", "none", "other", "programmer", "retired",
    "salesman", "scientist", "student", "technician", "writer",
]
_MONTHS = [
    "Jan", "Feb", "Mar", "Apr", "May", "Jun",
    "Jul", "Aug", "Sep", "Oct", "Nov", "Dec",
]


def generate_movielens_like(
    out_dir: str | Path,
    num_users: int = 300,
    num_items: int = 400,
    num_rows: int = 20_000,
    seed: int = 0,
) -> Path:
    """Write an ML-100K-format dataset with learnable latent structure."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)

    # latent taste factors -> ratings carry real user-item signal
    k = 4
    u_fac = rng.normal(0, 1, (num_users, k))
    i_fac = rng.normal(0, 1, (num_items, k))
    u_bias = rng.normal(0, 0.4, num_users)
    i_bias = rng.normal(0, 0.4, num_items)

    # unique (user, item) pairs, popularity-skewed items
    num_rows = min(num_rows, num_users * num_items)
    item_pop = rng.pareto(1.2, num_items) + 0.05
    item_pop /= item_pop.sum()
    pairs: set[int] = set()
    uid = np.empty(num_rows, np.int64)
    iid = np.empty(num_rows, np.int64)
    filled = 0
    while filled < num_rows:
        need = num_rows - filled
        cu = rng.integers(0, num_users, int(need * 1.5) + 8)
        ci = rng.choice(num_items, size=len(cu), p=item_pop)
        for u, i in zip(cu, ci):
            key = int(u) * num_items + int(i)
            if key in pairs:
                continue
            pairs.add(key)
            uid[filled] = u
            iid[filled] = i
            filled += 1
            if filled == num_rows:
                break

    score = (
        (u_fac[uid] * i_fac[iid]).sum(1) * 0.8
        + u_bias[uid]
        + i_bias[iid]
        + rng.normal(0, 0.6, num_rows)
    )
    rating = np.clip(np.round(3.2 + score), 1, 5).astype(np.int64)
    # ML-100K era timestamps (1997-09 .. 1998-04)
    ts = rng.integers(874_000_000, 893_000_000, num_rows)

    with open(out / "u.data", "w") as f:
        for j in range(num_rows):
            f.write(f"{uid[j] + 1}\t{iid[j] + 1}\t{rating[j]}\t{ts[j]}\n")

    ages = rng.integers(7, 74, num_users)
    genders = rng.choice(["M", "F"], num_users, p=[0.7, 0.3])
    occs = rng.choice(_OCCUPATIONS, num_users)
    zips = rng.integers(10000, 99999, num_users)
    with open(out / "u.user", "w") as f:
        for j in range(num_users):
            f.write(f"{j + 1}|{ages[j]}|{genders[j]}|{occs[j]}|{zips[j]}\n")

    years = rng.integers(1930, 1999, num_items)
    days = rng.integers(1, 29, num_items)
    months = rng.integers(0, 12, num_items)
    missing_date = rng.random(num_items) < 0.02
    n_genre = rng.integers(1, 4, num_items)
    with open(out / "u.item", "w") as f:
        for j in range(num_items):
            date = (
                ""
                if missing_date[j]
                else f"{days[j]:02d}-{_MONTHS[months[j]]}-{years[j]}"
            )
            flags = np.zeros(len(_GENRES), np.int64)
            picks = rng.choice(
                np.arange(1, len(_GENRES)), size=n_genre[j], replace=False
            )
            flags[picks] = 1
            flag_s = "|".join(str(v) for v in flags)
            f.write(
                f"{j + 1}|Movie {j + 1} ({years[j]})|{date}||"
                f"http://example.com/{j + 1}|{flag_s}\n"
            )
    return out


class SyntheticCTRAdapter:
    """In-memory Criteo-scale CTR data with planted feature->label signal.

    Same adapter contract as MovieLensAdapter: ``build()`` returns
    (schema, train, val, test); ``resample_train()`` returns a fresh
    training set (here: entirely fresh rows).
    """

    def __init__(self, config: DataConfig, seed: int = 0) -> None:
        self.config = config
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        nf = config.synthetic_num_fields
        vocab = config.synthetic_vocab_size
        # planted per-field code weights: label depends on (id % 17)
        self._field_coef = np.random.default_rng(seed + 1).normal(
            0, 1.0, (nf, 17)
        )
        fields = {
            f"cat_{i}": FieldSchema(
                f"cat_{i}",
                FeatureType.SPARSE,
                vocab,
                16,
                "user" if i % 2 else "item",
            )
            for i in range(nf)
        }
        fields["dense_0"] = FieldSchema(
            "dense_0", FeatureType.DENSE, 0, 16, "context"
        )
        self.schema = DatasetSchema(fields=fields)

    def _sample(self, n: int) -> TabularDataset:
        cfg = self.config
        rng = self._rng
        nf = cfg.synthetic_num_fields
        vocab = cfg.synthetic_vocab_size
        # popularity-skewed ids in [1, vocab): square a uniform draw
        ids = (
            1 + ((vocab - 1) * rng.random((n, nf)) ** 2)
        ).astype(np.int64)
        ids = np.minimum(ids, vocab - 1)
        dense = rng.normal(0, 1, n).astype(np.float32)
        logit = self._field_coef[np.arange(nf)[None, :], ids % 17].sum(1)
        logit = logit / np.sqrt(nf) + 0.5 * dense
        p = 1.0 / (1.0 + np.exp(-logit))
        labels = (rng.random(n) < p).astype(np.float32)
        feats = {f"cat_{i}": ids[:, i] for i in range(nf)}
        feats["dense_0"] = dense
        return TabularDataset(feats, labels)

    def build(
        self,
    ) -> tuple[DatasetSchema, TabularDataset, TabularDataset, TabularDataset]:
        n = self.config.synthetic_num_rows
        train = self._sample(n)
        val = self._sample(max(n // 10, 1))
        test = self._sample(max(n // 10, 1))
        return self.schema, train, val, test

    def resample_train(self) -> TabularDataset:
        return self._sample(self.config.synthetic_num_rows)

    def rng_state(self) -> dict:
        """The state of the RNG the resamples draw from (a resume
        checkpoint carries it)."""
        return self._rng.bit_generator.state

    def set_rng_state(self, state: dict) -> None:
        self._rng.bit_generator.state = state


def build_adapter(config: DataConfig, seed: int = 0):
    """Dataset registry: name -> adapter instance."""
    name = config.dataset_name
    if name == "movielens":
        from deepfm_tpu_torch.data.movielens import MovieLensAdapter

        return MovieLensAdapter(config, seed=seed)
    if name in ("synthetic", "criteo_synthetic"):
        return SyntheticCTRAdapter(config, seed=seed)
    if name == "packed":
        from deepfm_tpu_torch.data.store import PackedDirAdapter

        return PackedDirAdapter(config, seed=seed)
    raise ValueError(
        f"Unknown dataset: {name!r} "
        "(choose movielens / criteo_synthetic / packed)"
    )
