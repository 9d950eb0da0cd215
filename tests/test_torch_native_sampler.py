"""The port's native negative sampler against the JAX package's, on the CPU.

Both libraries are built with g++ from their own copies of the same source
with the same flags, so a seed draws the same arrays:

  * ``uniform_unseen_batch`` and ``weighted_unseen_batch`` for several
    seeds, on a seen matrix with users who have seen almost everything
    (the dense fallback) and nothing;
  * the MovieLens adapter with its defaults (``use_native_sampler: true``)
    packs the JAX adapter's arrays for a seed, and a per-epoch resample
    (the next seed drawn from the adapter's RNG) stays in step;
  * a compiler that cannot build the library raises, and the adapter
    raises with it: nothing falls back to numpy.
"""

import numpy as np
import pytest
import torch

from deepfm_tpu.config import DataConfig as JaxDataConfig
from deepfm_tpu.data.movielens import MovieLensAdapter as JaxAdapter
from deepfm_tpu.data.packing import pack_schema as jax_pack_schema
from deepfm_tpu.native import sampler as jsampler
from deepfm_tpu_torch.config import DataConfig
from deepfm_tpu_torch.data.movielens import MovieLensAdapter
from deepfm_tpu_torch.data.packing import pack_schema
from deepfm_tpu_torch.data.synthetic import generate_movielens_like
from deepfm_tpu_torch.native import sampler

torch.set_num_threads(1)

SEEDS = (0, 1, 12345, 2**62 - 1)


def _seen(users=12, items=30):
    rng = np.random.default_rng(3)
    seen = (rng.random((users, items)) < 0.4).astype(np.uint8)
    seen[0] = 1
    seen[0, 5] = 0  # one unseen item: the uniform draw's dense fallback
    seen[1] = 0
    return seen


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_draws_match_jax(seed):
    seen = _seen()
    uids = np.repeat(np.arange(seen.shape[0]), 3)
    want = jsampler.uniform_unseen_batch(seen, uids, 4, seed)
    got = sampler.uniform_unseen_batch(seen, uids, 4, seed)
    assert got.dtype == np.int64 and got.shape == (len(uids), 4)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_weighted_draws_match_jax(seed):
    seen = _seen()
    weights = np.random.default_rng(4).random(seen.shape[1]) + 0.1
    uids = np.repeat(np.arange(seen.shape[0]), 2)
    want_items, want_counts = jsampler.weighted_unseen_batch(
        seen, weights, uids, 6, seed)
    items, counts = sampler.weighted_unseen_batch(seen, weights, uids, 6,
                                                  seed)
    np.testing.assert_array_equal(items, want_items)
    np.testing.assert_array_equal(counts, want_counts)
    assert counts[0] == 1 and counts.sum() == len(items)
    assert not seen[np.repeat(uids, counts), items].any()


@pytest.fixture(scope="module")
def ml_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("native_ml")
    generate_movielens_like(root, num_users=40, num_items=60,
                            num_rows=1500, seed=6)
    return root


@pytest.mark.parametrize("split", ["temporal", "leave_one_out"])
def test_adapter_with_the_default_sampler_packs_the_jax_arrays(ml_dir,
                                                               split):
    kw = dict(data_dir=str(ml_dir), num_neg_train=2, num_neg_eval=7,
              split_strategy=split)
    tconfig, jconfig = DataConfig(**kw), JaxDataConfig(**kw)
    assert tconfig.use_native_sampler and jconfig.use_native_sampler
    tad, jad = MovieLensAdapter(tconfig, seed=9), JaxAdapter(jconfig, seed=9)
    tsplits, jsplits = tad.build(), jad.build()
    tpacked, jpacked = pack_schema(tsplits[0]), jax_pack_schema(jsplits[0])
    resampled = (tad.resample_train(), jad.resample_train())
    for got, want in [*zip(tsplits[1:], jsplits[1:]), resampled]:
        g, w = got.pack(tpacked), want.pack(jpacked)
        for name in ("ids", "dense", "labels", "weights", "user_ids"):
            np.testing.assert_array_equal(getattr(g, name),
                                          getattr(w, name))
    assert tad.rng_state() == jad._rng.bit_generator.state


def test_a_compiler_that_cannot_build_raises(ml_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(sampler, "_lib", None)
    monkeypatch.setattr(sampler, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(sampler, "COMPILER", "false")  # exits 1
    with pytest.raises(RuntimeError, match="failed to build"):
        sampler.uniform_unseen_batch(_seen(), np.arange(3), 2, 0)
    monkeypatch.setattr(sampler, "COMPILER", "no-such-compiler-xyz")
    with pytest.raises(RuntimeError, match="not found on PATH"):
        sampler.uniform_unseen_batch(_seen(), np.arange(3), 2, 0)
    adapter = MovieLensAdapter(DataConfig(data_dir=str(ml_dir)), seed=1)
    with pytest.raises(RuntimeError, match="native negative sampler"):
        adapter.build()
    assert not (tmp_path / "build").exists() or not any(
        (tmp_path / "build").glob("*.so"))


def test_the_numpy_sampler_is_a_config_choice(ml_dir, monkeypatch):
    """use_native_sampler: false never loads the library."""
    monkeypatch.setattr(sampler, "_load", None)  # any call would raise
    kw = dict(data_dir=str(ml_dir), num_neg_train=1, num_neg_eval=3,
              use_native_sampler=False)
    tsplits = MovieLensAdapter(DataConfig(**kw), seed=2).build()
    jsplits = JaxAdapter(JaxDataConfig(**kw), seed=2).build()
    tpacked, jpacked = pack_schema(tsplits[0]), jax_pack_schema(jsplits[0])
    np.testing.assert_array_equal(tsplits[1].pack(tpacked).ids,
                                  jsplits[1].pack(jpacked).ids)


def test_the_library_is_built_under_a_hashed_name():
    path = sampler.library_path()
    assert path.parent == sampler.BUILD_DIR
    assert path.name.startswith("sampler-") and path.suffix == ".so"
    sampler.build()
    assert path.exists()
