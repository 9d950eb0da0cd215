"""Criteo-schema CTR rows, made on the device from the seed.

A mix file gives ``batch``, ``pool_rows``, ``label_codes`` and
``id_law``; the configuration gives the fields and each categorical
field's distinct values n (``field_cardinalities``). The ids of a field
are 1 .. n (id 0 is the port's padding and out-of-vocabulary row, never
drawn), by the mix's law:

* ``"uniform"``: every id of the field equally likely, as DLRM's
  benchmark draws its random indices (facebookresearch/dlrm,
  ``dlrm_s_pytorch.py --data-generation=random``, the default
  ``--rand-data-dist=uniform``);
* ``"zipf"``: rank k = 1 .. n with probability proportional to k^-s
  (s = the mix's ``zipf_exponent``), mapped to an id through a
  permutation of the field's own, so that the hot rows lie across the
  table as hashed ids do.

Dense values are standard normal. Labels follow the planted model of the
port's ``data/synthetic.py`` (``SyntheticCTRAdapter``), widened to many
dense fields: logit = sum_f c[f, id_f mod codes] / sqrt(fields)
+ 0.5 * sum_j x_j / sqrt(dense fields), label ~ Bernoulli(sigmoid(logit)).

Every seed gets the same sizes; only the draws differ.
"""

from __future__ import annotations

import math

import torch

from portbench import seeds

LAWS = ("uniform", "zipf")


def zipf_cdf(ranks: int, exponent: float, device) -> torch.Tensor:
    """(ranks,) float64 cumulative probabilities of ranks 1 .. ranks."""
    k = torch.arange(1, ranks + 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum(k.pow(-exponent), 0)
    return cdf / cdf[-1]


def draw_ids(n: int, cardinalities, mix: dict, g: torch.Generator,
             device) -> torch.Tensor:
    """(n, fields) int32 ids, field f's in [1, cardinalities[f]]."""
    law = mix["id_law"]
    if law not in LAWS:
        raise ValueError(f"id_law {law!r}: one of {LAWS}")
    card = torch.tensor(cardinalities, dtype=torch.float64, device=device)
    if law == "uniform":
        u = torch.rand(n, len(cardinalities), dtype=torch.float64,
                       generator=g, device=device)
        ids = (u * card).floor_().clamp_(max=card - 1) + 1
        return ids.to(torch.int32)
    out = torch.empty(n, len(cardinalities), dtype=torch.int32,
                      device=device)
    for f, size in enumerate(cardinalities):
        cdf = zipf_cdf(size, mix["zipf_exponent"], device)
        perm = torch.randperm(size, generator=g, device=device) + 1
        u = torch.rand(n, dtype=torch.float64, generator=g, device=device)
        rank = torch.searchsorted(cdf, u, right=True).clamp_(max=size - 1)
        out[:, f] = perm[rank].to(torch.int32)
    return out


def make_pool(config: dict, mix: dict, seed: int, device) -> dict:
    """The cell's rows, as host arrays: ``ids`` (n, sparse) int32 local
    ids, ``dense`` (n, dense) float32, ``labels`` (n,) float32."""
    n = mix["pool_rows"]
    ns, nd = config["sparse_fields"], config["dense_fields"]
    g = seeds.generator(seed, "traffic", device)
    ids = draw_ids(n, config["field_cardinalities"], mix, g, device)
    dense = torch.randn(n, nd, generator=g, device=device)
    codes = mix["label_codes"]
    coef = torch.randn(ns, codes, generator=g, device=device)
    col = torch.arange(ns, device=device)[None, :]
    logit = coef[col, ids.long() % codes].sum(1) / math.sqrt(ns)
    logit = logit + 0.5 * dense.sum(1) / math.sqrt(max(nd, 1))
    labels = (torch.rand(n, generator=g, device=device)
              < torch.sigmoid(logit)).float()
    return {"ids": ids.cpu().numpy(), "dense": dense.cpu().numpy(),
            "labels": labels.cpu().numpy()}
