"""The port's metrics (``deepfm_tpu_torch/training/metrics.py``, a numpy
copy) against the JAX package's on seeded arrays: every function, exactly
(the same numpy operations in the same order)."""

import numpy as np
import pytest

from deepfm_tpu.training import metrics as jm
from deepfm_tpu_torch.training import metrics as tm

KS = (1, 5, 10, 20)


def _scored(seed, n=3000, users=40, ties=False):
    rng = np.random.default_rng(seed)
    labels = (rng.random(n) < 0.3).astype(np.float32)
    scores = rng.random(n).astype(np.float32)
    if ties:
        scores = np.round(scores, 1)  # many tied scores
    user_ids = rng.integers(0, users, n)
    return labels, scores, user_ids


@pytest.mark.parametrize("seed,ties", [(0, False), (1, True), (2, False)])
def test_classification_metrics_match_jax(seed, ties):
    labels, scores, _ = _scored(seed, ties=ties)
    assert tm.compute_auc(labels, scores) == jm.compute_auc(labels, scores)
    assert tm.compute_logloss(labels, scores) == jm.compute_logloss(labels,
                                                                    scores)
    assert tm.compute_calibration(labels, scores) == jm.compute_calibration(
        labels, scores)
    assert tm.compute_calibration(labels, scores, num_bins=7) == \
        jm.compute_calibration(labels, scores, num_bins=7)


def test_single_class_auc_raises_and_no_positive_pcoc():
    labels = np.zeros(10, np.float32)
    scores = np.linspace(0, 1, 10, dtype=np.float32)
    for mod in (tm, jm):
        with pytest.raises(ValueError):
            mod.compute_auc(labels, scores)
    assert tm.compute_calibration(labels, scores) == jm.compute_calibration(
        labels, scores)
    assert "pcoc" not in tm.compute_calibration(labels, scores)


@pytest.mark.parametrize("k", [1, 3, 10])
def test_hr_and_ndcg_at_k_match_jax(k):
    rng = np.random.default_rng(k)
    rankings = [rng.permutation(12) for _ in range(30)]
    assert tm.compute_hr_at_k(rankings, k) == jm.compute_hr_at_k(rankings, k)
    assert tm.compute_ndcg_at_k(rankings, k) == jm.compute_ndcg_at_k(
        rankings, k)


def test_ranking_evaluator_matches_jax():
    rng = np.random.default_rng(5)
    scores = [rng.random(20) for _ in range(25)]
    labels = [np.eye(20, dtype=np.float32)[rng.integers(20)]
              for _ in range(25)]
    for ks in (None, [1, 2, 7]):
        assert tm.RankingEvaluator(ks).evaluate(scores, labels) == \
            jm.RankingEvaluator(ks).evaluate(scores, labels)


@pytest.mark.parametrize("seed", [3, 4])
def test_grouped_ranking_metrics_match_jax(seed):
    labels, scores, users = _scored(seed, n=2000, users=60)
    got = tm.grouped_ranking_metrics(users, scores, labels, KS)
    assert got == jm.grouped_ranking_metrics(users, scores, labels, KS)
    assert set(got) == {f"{m}@{k}" for m in ("HR", "NDCG") for k in KS}
    # users with a single class only are dropped: none left -> {}
    assert tm.grouped_ranking_metrics(users, scores, np.zeros_like(labels),
                                      KS) == {}
