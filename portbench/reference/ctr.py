"""Plain PyTorch CTR models: forward, loss, autograd backward, clipping
and Adam over every leaf, the embedding table included.

Written from the papers and the configuration files, in float32 with
TF32 off, on whatever device the inputs are on. It takes the benchmark's
weights (``weights.py`` names) and inputs and nothing else. What every
model kind shares is here; each kind's logit is its file's ``logit``
(``models/<kind>.py``, passed in as ``kind``), built on ``embed``,
``dnn`` and ``_linear``.

The model, for F = dense + sparse fields of width D:

* a categorical field f of n_f distinct values has n_f + 1 rows, its
  local ids 1 .. n_f and the masked id 0, after the rows of the fields
  before it; local id i reads row offset_f + i of the table (D + 1
  columns, the last the field's first-order weight); id 0 reads nothing
  (the row is masked);
* a dense field j with value x gives the embedding x * w_j + b_j and the
  first-order term x * fo_w_j + fo_b_j;
* x0 is the (B, F, D) stack of the dense fields' embeddings, then the
  categorical ones';
* logit = the kind's ``logit`` of the first order and x0;
* DNN layer: Linear, BatchNorm (batch statistics with the biased variance
  in training, running statistics in evaluation, eps 1e-5), ReLU;
* loss: binary cross-entropy of the logit, the mean over the batch.

A train step: gradients by autograd (the table's is dense); the
embedding leaves (table, dense weights) get the decay 2 * l2 * p added;
the global norm over all leaves; when it reaches the clip norm every
gradient is scaled by clip / norm; Adam (f32 moments, bias-corrected)
updates every leaf, every row of the table.

``q`` rounds a tensor where the configuration's compute dtype rounds it:
the identity for the reference itself, ``fp8`` for its control.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

EMBEDDING_LEAVES = ("table", "dense_fo_w", "dense_fo_b", "dense_w",
                    "dense_b")
BN_EPS = 1e-5
FP8_MAX = 448.0


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


class _Fp8(torch.autograd.Function):
    """Round to float8 e4m3 with one scale a tensor, its largest magnitude
    at 448; the gradient is rounded the same way."""

    @staticmethod
    def forward(ctx, t):
        return _fp8_round(t)

    @staticmethod
    def backward(ctx, g):
        return _fp8_round(g)


def _fp8_round(t: torch.Tensor) -> torch.Tensor:
    amax = t.detach().abs().amax()
    if not torch.isfinite(amax) or amax == 0:
        return t
    scale = FP8_MAX / amax
    return (t * scale).clamp(-FP8_MAX, FP8_MAX).to(
        torch.float8_e4m3fn).to(t.dtype) / scale


def fp8(t: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(t)


@contextlib.contextmanager
def full_f32():
    """float32 matrix products without TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _linear(x, w, b, q):
    return q(F.linear(q(x), q(w), q(b)))


def embed(config, w, ids, dense, q=identity):
    """(first order (B,), x0 (B, F, D))."""
    d, ns = config["embed_dim"], config["sparse_fields"]
    sizes = torch.tensor([n + 1 for n in config["field_cardinalities"]],
                         device=ids.device)
    offsets = torch.cumsum(sizes, 0) - sizes
    rows = q(w["table"][(ids.long() + offsets).reshape(-1)])
    rows = rows.reshape(ids.shape[0], ns, d + 1) * (ids != 0)[:, :, None]
    x = q(dense)
    first = (rows[:, :, d].sum(1) + x @ q(w["dense_fo_w"])
             + q(w["dense_fo_b"]).sum())
    dense_emb = q(x[:, :, None] * q(w["dense_w"])[None] + q(w["dense_b"]))
    return q(first), torch.cat([dense_emb, rows[:, :, :d]], dim=1)


def dnn(config, w, flat, training: bool, q=identity):
    x = flat
    for i in range(len(config["dnn_hidden_units"])):
        x = _linear(x, w[f"dnn.w{i}"], w[f"dnn.b{i}"], q)
        if config["dnn_batch_norm"]:
            if training:
                mean = x.mean(0)
                var = torch.clamp_min((x * x).mean(0) - mean * mean, 0.0)
            else:
                mean, var = w[f"bn.mean{i}"], w[f"bn.var{i}"]
            x = q((x - mean) * torch.rsqrt(var + BN_EPS) * w[f"bn.gamma{i}"]
                  + w[f"bn.beta{i}"])
        x = torch.relu(x)
    return x


def logits(kind, config, w, ids, dense, training: bool, q=identity):
    """(B,) float32 logits."""
    first, x0 = embed(config, w, ids, dense, q)
    return q(kind.logit(config, w, first, x0, training, q)).float()


def bce(logit, labels):
    return (-labels * F.logsigmoid(logit)
            - (1.0 - labels) * F.logsigmoid(-logit)).mean()


def probabilities(kind, config, w, ids, dense, q=identity,
                  block: int = 4096):
    """Evaluation-mode sigmoid scores of every row, ``block`` rows at a
    time."""
    with full_f32(), torch.no_grad():
        return torch.cat([
            torch.sigmoid(logits(kind, config, w, ids[i:i + block],
                                 dense[i:i + block], False, q))
            for i in range(0, ids.shape[0], block)])


def train_steps(kind, config, w0, batches, q=identity, keep=()) -> dict:
    """Train from the weights ``w0`` over ``batches`` ((ids, dense,
    labels) each). Returns each step's loss; the first step's gradient
    norm of every leaf as the optimizer takes it (decayed and clipped),
    and that gradient itself of the leaves named in ``keep``; each leaf's
    change ||p - p0|| after the last step; and each leaf's size."""
    lr, clip = config["lr"], config["gradient_clip_norm"]
    wd = 2.0 * config["embedding_l2_reg"]
    b1, b2, eps = config["adam_b1"], config["adam_b2"], config["adam_eps"]
    stats = {k for k in w0 if k.startswith(("bn.mean", "bn.var"))}
    leaves = [k for k in w0 if k not in stats]
    params = {k: w0[k].detach().clone() for k in leaves}
    mu = {k: torch.zeros_like(p) for k, p in params.items()}
    nu = {k: torch.zeros_like(p) for k, p in params.items()}
    losses, first_norms, first_grads = [], None, {}
    with full_f32():
        for t, (ids, dense, labels) in enumerate(batches, start=1):
            live = {k: p.requires_grad_() for k, p in params.items()}
            loss = bce(logits(kind, config,
                              {**live, **{k: w0[k] for k in stats}},
                              ids, dense, True, q), labels)
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, [live[k] for k in leaves])))
            losses.append(float(loss.detach()))
            with torch.no_grad():
                for k in EMBEDDING_LEAVES:
                    grads[k] = grads[k] + wd * params[k]
                norm = math.sqrt(sum(float(torch.sum(g * g))
                                     for g in grads.values()))
                if clip > 0 and norm >= clip:
                    grads = {k: g / norm * clip for k, g in grads.items()}
                if first_norms is None:
                    first_norms = {k: float(torch.linalg.vector_norm(g))
                                   for k, g in grads.items()}
                    first_grads = {k: grads[k].clone() for k in keep}
                bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
                for k in leaves:
                    g = grads[k]
                    mu[k] = (1.0 - b1) * g + b1 * mu[k]
                    nu[k] = (1.0 - b2) * g * g + b2 * nu[k]
                    params[k] = (params[k].detach() - lr * (mu[k] / bc1)
                                 / (torch.sqrt(nu[k] / bc2) + eps))
            del grads, live, loss
    change = {k: float(torch.linalg.vector_norm(params[k] - w0[k]))
              for k in leaves}
    return {"losses": losses, "grad_norms": first_norms,
            "first_grads": first_grads, "change_norms": change,
            "sizes": {k: params[k].numel() for k in leaves}}
