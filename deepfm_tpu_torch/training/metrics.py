"""Classification + ranking metrics for CTR evaluation.

Copy of ``deepfm_tpu/training/metrics.py`` (numpy only; the port keeps its
own copy so that it imports nothing of the JAX package). Metric
definitions match the reference (reference:
deepfm/training/metrics.py:9-111): global AUC/LogLoss over all rows, and
per-user HR@K / NDCG@K with NDCG = 1/log2(rank+1) (single relevant item).

AUC is computed with the exact rank-statistic (Mann-Whitney U with average
ranks for ties) — identical to sklearn.roc_auc_score but pure NumPy and
O(n log n), so evaluation never round-trips through sklearn on the hot path.
"""

from __future__ import annotations

import numpy as np


def _average_ranks(x: np.ndarray) -> np.ndarray:
    """1-based ranks with ties sharing their average rank."""
    order = np.argsort(x, kind="mergesort")
    sx = x[order]
    n = len(x)
    ranks = np.empty(n, dtype=np.float64)
    # boundaries of tied runs in the sorted array
    boundary = np.empty(n + 1, dtype=bool)
    boundary[0] = True
    boundary[1:-1] = sx[1:] != sx[:-1]
    boundary[-1] = True
    idx = np.flatnonzero(boundary)
    for s, e in zip(idx[:-1], idx[1:]):
        ranks[order[s:e]] = 0.5 * (s + 1 + e)  # average of ranks s+1..e
    return ranks


def compute_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Area under the ROC curve (exact, tie-aware).

    Raises ValueError when only one class is present, mirroring sklearn so
    callers keep the same 0.0 fallback behavior (reference trainer.py:284-287).
    """
    labels = np.asarray(labels)
    scores = np.asarray(scores, dtype=np.float64)
    pos = labels > 0.5
    n_pos = int(pos.sum())
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("AUC is undefined with a single class")
    ranks = _average_ranks(scores)
    u = ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def compute_logloss(labels: np.ndarray, scores: np.ndarray) -> float:
    """Binary cross-entropy with 1e-7 probability clipping."""
    labels = np.asarray(labels, dtype=np.float64)
    scores = np.clip(np.asarray(scores, dtype=np.float64), 1e-7, 1 - 1e-7)
    return float(
        -(labels * np.log(scores) + (1 - labels) * np.log(1 - scores)).mean()
    )


def compute_calibration(
    labels: np.ndarray, scores: np.ndarray, num_bins: int = 10
) -> dict[str, float]:
    """Calibration diagnostics for CTR serving (beyond reference scope).

    * ``pcoc`` — predicted-over-observed click rate, mean(p)/mean(y):
      the production CTR calibration headline (1.0 = perfectly
      calibrated in aggregate; >1 over-predicts). Omitted when the
      split has no positives (NaN would poison results.json — strict
      JSON has no NaN token).
    * ``ece`` — expected calibration error: scores bucketed into
      ``num_bins`` equal-width bins, sum over bins of
      (bin weight) * |mean(p) - mean(y)| within the bin.

    Ranking metrics (AUC/HR/NDCG) are invariant to monotone score
    distortions; ads/recs systems that bid or blend on the predicted
    probability need the probability itself to be right — these two
    measure exactly that.
    """
    labels = np.asarray(labels, dtype=np.float64)
    scores = np.asarray(scores, dtype=np.float64)
    n = len(labels)
    mean_y = labels.mean() if n else 0.0
    out: dict[str, float] = {}
    if mean_y > 0:
        out["pcoc"] = float(scores.mean() / mean_y)

    edges = np.linspace(0.0, 1.0, num_bins + 1)
    which = np.clip(np.digitize(scores, edges[1:-1]), 0, num_bins - 1)
    ece = 0.0
    for b in range(num_bins):
        m = which == b
        cnt = int(m.sum())
        if cnt == 0:
            continue
        ece += (cnt / n) * abs(scores[m].mean() - labels[m].mean())
    out["ece"] = float(ece)
    return out


def compute_hr_at_k(rankings: list[np.ndarray], k: int) -> float:
    """Hit rate@K: fraction of users whose positive (index 0) is in top-K."""
    hits = sum(1 for ranking in rankings if 0 in ranking[:k])
    return hits / len(rankings)


def compute_ndcg_at_k(rankings: list[np.ndarray], k: int) -> float:
    """NDCG@K with one relevant item: 1/log2(rank+1) if hit else 0."""
    total = 0.0
    for ranking in rankings:
        positions = np.where(ranking[:k] == 0)[0]
        if len(positions) > 0:
            total += 1.0 / np.log2(positions[0] + 2)
    return total / len(rankings)


class RankingEvaluator:
    """Per-user ranking metrics for the 1-positive + N-negatives protocol."""

    def __init__(self, ks: list[int] | tuple[int, ...] | None = None) -> None:
        self.ks = list(ks) if ks else [5, 10, 20]

    def evaluate(
        self,
        user_scores: list[np.ndarray],
        user_labels: list[np.ndarray],
    ) -> dict[str, float]:
        rankings: list[np.ndarray] = []
        for scores, labels in zip(user_scores, user_labels):
            ranked_indices = np.argsort(-np.asarray(scores), kind="stable")
            rankings.append(np.asarray(labels)[ranked_indices])

        metrics: dict[str, float] = {}
        n = len(rankings)
        for k in self.ks:
            hits = sum(1 for r in rankings if 1 in r[:k])
            metrics[f"HR@{k}"] = hits / n
            ndcg = 0.0
            for r in rankings:
                pos = np.where(r[:k] == 1)[0]
                if len(pos) > 0:
                    ndcg += 1.0 / np.log2(pos[0] + 2)
            metrics[f"NDCG@{k}"] = ndcg / n
        return metrics


def grouped_ranking_metrics(
    user_ids: np.ndarray,
    scores: np.ndarray,
    labels: np.ndarray,
    ks: list[int] | tuple[int, ...],
) -> dict[str, float]:
    """Group rows by user and evaluate ranking metrics.

    Keeps only users with at least one positive AND one negative row
    (reference trainer.py:296-332). Vectorized grouping via argsort.
    """
    user_ids = np.asarray(user_ids)
    order = np.argsort(user_ids, kind="stable")
    sorted_uids = user_ids[order]
    boundaries = np.flatnonzero(
        np.concatenate(([True], sorted_uids[1:] != sorted_uids[:-1], [True]))
    )
    eval_scores: list[np.ndarray] = []
    eval_labels: list[np.ndarray] = []
    for s, e in zip(boundaries[:-1], boundaries[1:]):
        idx = order[s:e]
        ul = labels[idx]
        total = ul.sum()
        if 0 < total < len(ul):
            eval_scores.append(scores[idx])
            eval_labels.append(ul)
    if not eval_scores:
        return {}
    return RankingEvaluator(ks=list(ks)).evaluate(eval_scores, eval_labels)
