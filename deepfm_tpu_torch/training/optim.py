"""``deepfm_tpu/training/trainer.py::build_optimizer``: the optimizer chain
as plain functions on tensors.

The chain is optax's ``inject_hyperparams(chain(add_decayed_weights(2*l2,
mask=embedding), clip_by_global_norm(clip), adam|adamw|sgd(0.9)))``; on
the fused table paths and under ``lazy_adam`` it is ``masked(adam)`` over
the non-table leaves, and the decay and clip run in the step
(``steps.chain_second_half``; the lazy step's global clip). Every update
keeps optax's literal f32 op order, because Adam's normalisation turns
last-ulp differences into lr-sized ones within two steps:

  * decay ``g + wd * p``; clip ``where(norm < clip, g, g / norm * clip)``
    with the norm a left fold of the leaves' sums of squares in the JAX
    tree's leaf order (sorted key paths, ``leaf_order``);
  * Adam ``mu = (1 - b1) * g + b1 * mu``, ``nu = (1 - b2) * g^2 + b2 * nu``,
    ``u = (mu / bc1) / (sqrt(nu / bc2) + eps)`` with ``bc = 1 - b^count``
    in f32 (not Python doubles), then ``p + (-lr) * u``. ``torch.optim.Adam``
    folds lr / bc1 into one step size and divides by sqrt(v) / sqrt(bc2):
    another rounding, so it is not used.

The learning rate is state (``OptState.lr``, a 0-dim f32 tensor), the
counterpart of ``inject_hyperparams``: it can change between steps
without rebuilding anything.

Under a model-sharded mesh each rank holds a slab of every table
(``parallel/sharding.py``): the decay and the inner optimizer act on the
slab element by element, and the clip norm's term of a table is the
slabs' sums of squares summed over the model group (``table_sumsq``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from deepfm_tpu_torch.config import ExperimentConfig

B1, B2, EPS = 0.9, 0.999, 1e-8
ADAMW_WEIGHT_DECAY = 1e-4  # optax.adamw's default
SGD_MOMENTUM = 0.9
OPTIMIZERS = ("adam", "adamw", "sgd")


def jax_path(name: str) -> tuple[str, ...]:
    """The JAX params key path of a port parameter name (``weight`` is a
    flax Dense ``kernel``, or a BatchNorm ``scale``)."""
    parts = name.split(".")
    if parts[-1] == "weight":
        parts[-1] = ("scale" if len(parts) > 1 and parts[-2].startswith("bn_")
                     else "kernel")
    return tuple(parts)


def leaf_order(names) -> list[str]:
    """Port parameter names in the JAX tree's leaf order (dict keys sorted
    at every level, which is sorting the key paths)."""
    return sorted(names, key=jax_path)


def global_norm(sq: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the left fold of the leaves' sums of squares, in the order
    given (``optax.global_norm``'s ``sum(...)`` over the leaves)."""
    total = sq[0]
    for s in sq[1:]:
        total = total + s
    return torch.sqrt(total)


def sumsq(g: torch.Tensor) -> torch.Tensor:
    return torch.sum(g * g)


def table_sumsq(model_group, sq: dict[str, torch.Tensor]
                ) -> dict[str, torch.Tensor]:
    """Each table slab's sum of squares in ``sq`` (name -> 0-dim f32)
    summed over the model group into the whole table's, in one
    all-reduce; ``sq`` as given without a model group."""
    from deepfm_tpu_torch.parallel import collectives

    if model_group is None or not sq:
        return dict(sq)
    names = list(sq)
    total = collectives.all_reduce_(model_group,
                                    torch.stack([sq[n] for n in names]))
    return dict(zip(names, total.unbind()))


def clip_fn(g: torch.Tensor, gnorm: torch.Tensor, clip: float,
            trigger: torch.Tensor) -> torch.Tensor:
    """optax's ``select(norm < clip, g, (g / norm) * clip)``."""
    return torch.where(trigger, g, g / gnorm * clip)


@dataclass
class OptState:
    lr: torch.Tensor  # inject_hyperparams' learning_rate, f32 0-dim
    count: torch.Tensor  # adam / adamw step count, int32 0-dim
    mu: dict[str, torch.Tensor] = field(default_factory=dict)  # sgd: trace
    nu: dict[str, torch.Tensor] = field(default_factory=dict)


class Optimizer:
    """``build_optimizer``'s chain. ``masked`` names the leaves the inner
    optimizer leaves alone (the tables, on the fused paths, where
    ``apply`` alone is used and the decay and clip run in the step)."""

    def __init__(self, name: str, lr: float, l2_reg: float,
                 clip_norm: float, masked: frozenset[str] = frozenset(),
                 slabs: frozenset[str] = frozenset(), model_group=None):
        if name not in OPTIMIZERS:
            raise ValueError(f"Unknown optimizer: {name}")
        self.name = name
        self.lr = lr
        self.wd = 2.0 * l2_reg
        self.clip = clip_norm
        self.masked = masked
        # the table slabs of a model-sharded mesh, whose clip-norm terms
        # are summed over ``model_group``
        self.slabs = slabs
        self.model_group = model_group

    def init(self, params: dict[str, torch.Tensor]) -> OptState:
        dev = next(iter(params.values())).device
        state = OptState(
            lr=torch.full((), self.lr, dtype=torch.float32, device=dev),
            count=torch.zeros((), dtype=torch.int32, device=dev),
        )
        for name, p in params.items():
            if name in self.masked:
                continue
            state.mu[name] = torch.zeros_like(p, dtype=torch.float32)
            if self.name != "sgd":
                state.nu[name] = torch.zeros_like(p, dtype=torch.float32)
        return state

    def update(self, grads: dict[str, torch.Tensor],
               params: dict[str, torch.Tensor], state: OptState) -> None:
        """The whole chain (decay masked to the embedding, clip, inner
        optimizer), parameters updated in place."""
        grads = dict(grads)
        if self.wd > 0:  # add_decayed_weights(2 * l2, mask=embedding)
            for name, g in grads.items():
                if name.startswith("embedding."):
                    grads[name] = g + self.wd * params[name]
        if self.clip > 0:
            gnorm = self.norm(grads)
            trigger = gnorm < self.clip
            grads = {n: clip_fn(g, gnorm, self.clip, trigger)
                     for n, g in grads.items()}
        self.apply(grads, params, state)

    def norm(self, grads: dict[str, torch.Tensor]) -> torch.Tensor:
        """optax's global norm of ``grads`` (the JAX tree's leaf order),
        each table slab's term summed over the model group."""
        order = leaf_order(grads)
        sq = {n: sumsq(grads[n]) for n in order}
        sq.update(table_sumsq(self.model_group, {
            n: sq[n] for n in order if n in self.slabs}))
        return global_norm([sq[n] for n in order])

    def apply(self, grads: dict[str, torch.Tensor],
              params: dict[str, torch.Tensor], state: OptState) -> None:
        """The inner optimizer on every unmasked leaf, in place."""
        neg_lr = -state.lr
        if self.name == "sgd":  # trace(0.9): t = g + 0.9 * t; u = t
            for name, g in grads.items():
                if name in self.masked:
                    continue
                t = g + SGD_MOMENTUM * state.mu[name]
                state.mu[name] = t
                with torch.no_grad():
                    params[name].copy_(params[name] + neg_lr * t)
            return
        count = state.count + 1
        t = count.to(torch.float32)
        bc1 = 1.0 - torch.pow(torch.full_like(t, B1), t)
        bc2 = 1.0 - torch.pow(torch.full_like(t, B2), t)
        for name, g in grads.items():
            if name in self.masked:
                continue
            mu = (1.0 - B1) * g + B1 * state.mu[name]
            nu = (1.0 - B2) * (g * g) + B2 * state.nu[name]
            state.mu[name], state.nu[name] = mu, nu
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
            p = params[name]
            if self.name == "adamw":
                u = u + ADAMW_WEIGHT_DECAY * p
            with torch.no_grad():
                p.copy_(p + neg_lr * u)
        state.count = count


def build_optimizer(config: ExperimentConfig, table_names,
                    fused: bool, model_group=None) -> Optimizer:
    """The chain for ``config``; on the fused table paths (``fused``) and
    under ``lazy_adam`` the tables are masked out of an Adam, their update
    being the kernels' or the row-sparse one (``training/sparse_opt.py``),
    and the step applies the masked Adam alone (``Optimizer.apply``).
    ``model_group``: the tables are slabs, their clip-norm terms summed
    over it."""
    tc = config.training
    lazy = tc.optimizer == "lazy_adam"
    return Optimizer(
        "adam" if lazy else tc.optimizer, tc.lr,
        config.feature.embedding_l2_reg, tc.gradient_clip_norm,
        masked=frozenset(table_names) if fused or lazy else frozenset(),
        slabs=frozenset(table_names) if model_group is not None
        else frozenset(),
        model_group=model_group,
    )
