"""Leaf-by-leaf comparison of two train states after the same steps.

The one tolerance rule that the port's tests and ``chip_smoke.py`` hold a
train step to, against the JAX package's ``Trainer`` or against another
path or device of the port. The base is the JAX package's own tolerance
for its two table paths (tests/test_sparse_fused.py): rtol 1e-5 /
atol 1e-7. Two states that took their sums in other orders differ in a
gradient's last bits, and where a gradient is near 0 Adam's normalisation
g / (|g| + eps) turns that into a step difference of up to lr. So:

  * every element of a leaf lies within ``2 * lr * steps`` of its
    reference (the most two Adam trajectories can part); a table moment
    (a leaf named ``*.mu`` or ``*.nu``) within one bf16 step, 2^-7 of its
    value, as a bf16 rounding may land on the neighbour;
  * at most 0.1 % of a leaf's elements lie outside rtol / atol;
  * a leaf whose exact gradient is 0 (``zero_gradient_reference``) hands
    Adam pure rounding noise on both sides: it is held to the band alone,
    and the running means such a leaf shifts to 0.1 (the BatchNorm
    momentum) of it. Three kinds: the bias of a Dense layer feeding a
    train-mode BatchNorm (``dnn.dense_*.bias``); an attention block's key
    bias (``bk``: the softmax over the keys ignores a shift that every key
    shares); and an attention block's LayerNorm bias (``ln_bias``), which
    shifts every DNN input column it reaches by a constant that the
    train-mode BatchNorm of AttentionDeepFM's DNN removes (exactly so for
    the last block, which the configs use; an earlier block's is held to
    the band as well). A model names further leaves of this kind for its
    own architecture (``CTRModel.zero_gradient_leaves``: DNNOnly's
    dense-field biases, which reach the loss only through its DNN's first
    train-mode BatchNorm), passed as ``zero_gradient``.

``share_limit=False`` drops the 0.1 % limit and the moments' bound, for
two devices whose f32 gradients part at ReLU kinks; ``untouched`` (a row
mask of the tables) then holds the rows the batch did not touch, moments
included, to rtol / atol everywhere.
"""

from __future__ import annotations

import math

import torch

RTOL, ATOL = 1e-5, 1e-7
OUTSIDE_SHARE = 1e-3


def zero_gradient_reference(name: str,
                            zero_gradient: dict[str, str] | None = None
                            ) -> str | None:
    """For a leaf whose exact gradient is 0 (see the module docstring), the
    leaf of the same layer whose gradient sets its scale; else None.
    ``zero_gradient`` adds a model's own such leaves (name -> reference)."""
    if zero_gradient and name in zero_gradient:
        return zero_gradient[name]
    head, _, leaf = name.rpartition(".")
    if head.startswith("dnn.dense_") and leaf == "bias":
        return f"{head}.weight"
    if head.startswith("attention.block_") and leaf in ("bk", "ln_bias"):
        return f"{head}.{'wk' if leaf == 'bk' else 'ln_scale'}"
    return None


def compare_leaves(got: dict, want: dict, lr: float, steps: int,
                   share_limit: bool = True,
                   untouched: torch.Tensor | None = None,
                   zero_gradient: dict[str, str] | None = None) -> dict:
    """Each leaf of ``want`` (name -> tensor or array) against ``got``;
    ``zero_gradient``: the model's ``zero_gradient_leaves``.

    Returns ``failed_leaves`` (a list, empty when every leaf passes) and
    the worst readings over the leaves the share limit applies to."""
    band = 2.0 * lr * steps
    failed, worst_err, worst_share, untouched_err = [], 0.0, 0.0, 0.0
    for name, w in want.items():
        g = torch.as_tensor(got[name]).detach().float().cpu()
        w = torch.as_tensor(w).detach().float().cpu()
        err = (g - w).abs()
        moment = name.endswith((".mu", ".nu"))
        zero = zero_gradient_reference(name, zero_gradient) is not None
        exempt = zero or name.endswith("running_mean")
        if moment and not share_limit:
            limit = torch.full_like(w, math.inf)  # they follow the gradient
        elif moment:
            limit = 2.0 ** -7 * torch.maximum(g.abs(), w.abs()) + ATOL
        elif zero:
            limit = torch.full_like(w, band)
        elif name.endswith("running_mean"):
            limit = torch.full_like(w, 0.1 * band + ATOL)
        else:
            limit = torch.full_like(w, band + ATOL)
        outside = err > ATOL + RTOL * w.abs()
        share = outside.float().mean().item() if w.numel() else 0.0
        bad = not bool((err <= limit).all()) or (
            share_limit and not exempt and share > OUTSIDE_SHARE)
        if untouched is not None and "table_w" in name:
            rows = untouched.to(err.device)
            untouched_err = max(untouched_err, err[rows].max().item())
            bad = bad or bool(outside[rows].any())
        if bad:
            failed.append({"leaf": name, "max_err": err.max().item(),
                           "share_outside": share})
        if not exempt and w.numel():
            worst_share = max(worst_share, share)
            worst_err = max(worst_err, err.max().item())
    out = {"max_abs_err": worst_err, "max_share_outside_tol": worst_share,
           "failed_leaves": failed}
    if untouched is not None:
        out["untouched_rows"] = int(untouched.sum())
        out["untouched_max_abs_err"] = untouched_err
    return out
