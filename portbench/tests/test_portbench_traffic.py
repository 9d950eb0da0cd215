"""The traffic generator repeats for a seed and follows its laws."""

from __future__ import annotations

import numpy as np

from portbench.registry import Registry

CARDS = [2000, 50, 3]
CONFIG = {"sparse_fields": 3, "dense_fields": 2, "field_cardinalities": CARDS}


def pool(seed, n=200_000, law="uniform", exponent=1.05):
    gen = Registry().generator("ctr_rows")
    mix = {"pool_rows": n, "id_law": law, "zipf_exponent": exponent,
           "label_codes": 17}
    return gen.make_pool(CONFIG, mix, seed, "cpu")


def test_same_seed_same_rows_other_seed_other_rows():
    for law in ("uniform", "zipf"):
        a, b = pool(2**33 + 5, 5000, law), pool(2**33 + 5, 5000, law)
        c = pool(7, 5000, law)
        for k in ("ids", "dense", "labels"):
            assert np.array_equal(a[k], b[k])
            assert not np.array_equal(a[k], c[k])
        assert a["ids"].dtype == np.int32 and a["ids"].shape == (5000, 3)
        assert a["ids"].min() >= 1
        assert (a["ids"].max(0) <= CARDS).all()
        assert set(np.unique(a["labels"])) <= {0.0, 1.0}


def test_uniform_ids_cover_each_field_evenly():
    ids = pool(13)["ids"]
    for f, n in enumerate(CARDS):
        counts = np.bincount(ids[:, f], minlength=n + 1)
        assert counts[0] == 0 and (counts[1:] > 0).all()
        expected = len(ids) / n
        # a binomial count lies within 6 standard deviations of its mean
        assert np.abs(counts[1:] - expected).max() < 6 * np.sqrt(expected)


def test_ids_follow_the_zipf_law():
    ids = pool(11, law="zipf")["ids"]
    freq = np.sort(np.bincount(ids[:, 0]))[::-1][:100].astype(float)
    rank = np.arange(1, 101)
    slope = np.polyfit(np.log(rank), np.log(freq), 1)[0]
    assert abs(slope + 1.05) < 0.1, slope
    # each field maps ranks to ids through its own permutation
    hot = [np.bincount(ids[:, f]).argmax() for f in range(ids.shape[1])]
    assert hot != [1] * len(hot)


def test_epoch_order_is_the_trainers_shuffle():
    from portbench.entries.train import epoch_order

    order = epoch_order(99, 1000)
    assert sorted(order) == list(range(1000))
    assert np.array_equal(order, epoch_order(99, 1000))
