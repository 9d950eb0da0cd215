"""The train window: whole epochs of the port's ``Trainer._train_epoch``.

Set-up builds the ``Trainer`` once, on the benchmark's weights and rows,
and runs ``warmup_epochs`` epochs of it; the first three steps of the
first epoch are read for the comparison (``FirstSteps``). The same object
then runs whole epochs until ``--seconds`` have passed; the trainer
reshuffles and stages each as a user's ``train`` does, with no evaluation
and no checkpoint. The rate is the window's examples over all its time,
which ends in a synchronise.

After the window the program is freed and the reference follows the same
three steps from the same weights and rows (``reference/ctr.py``).
"""

from __future__ import annotations

import gc
import math
import resource
import time

import numpy as np
import torch

from portbench import check, counts, port, seeds, weights
from portbench.reference import ctr
from portbench.spans import Spans
from portbench.trace import DeviceTrace, mark_operations

CHECKED_STEPS = 3


def epoch_order(seed: int, n: int) -> np.ndarray:
    """The row order of the trainer's first epoch: the port's ``Trainer``
    shuffles ``arange(n)`` with ``numpy.random.default_rng(rng_seed)``,
    and the benchmark passes ``seeds.derive(seed, "shuffle")`` as
    ``rng_seed``."""
    order = np.arange(n)
    np.random.default_rng(seeds.derive(seed, "shuffle")).shuffle(order)
    return order


class FirstSteps:
    """Stands in for ``trainer._train_step`` during set-up and reads each
    of the first three steps' loss; after step 1, every leaf's Adam first
    moment (mu / (1 - b1): the gradient as the optimizer took it), its
    norm on the device and, for the leaves of at least
    ``check.WIDE_LEAF`` elements, a host copy; after step 3, before step 4
    runs, every leaf's change from the initial weights."""

    def __init__(self, trainer, kind, config: dict, seed: int,
                 device) -> None:
        self.trainer, self.kind, self.config = trainer, kind, config
        self.seed, self.device = seed, device
        self.leaves = port.leaf_names(kind, config)
        self.step = trainer._train_step
        self.losses, self.grad, self.change = [], None, None
        self.first: dict[str, torch.Tensor] = {}
        trainer._train_step = self

    def __call__(self, *batch):
        loss = self.step(*batch)
        k = len(self.losses) + 1
        if k <= CHECKED_STEPS:
            self.losses.append(loss.detach().float().clone())
        if k == 1:
            self.grad = self._first_moments()
        if k == CHECKED_STEPS:
            self.change = self._changes()
        return loss

    def _first_moments(self) -> torch.Tensor:
        state = self.trainer.state
        out = []
        for ours, theirs in self.leaves.items():
            table = (state.table_opt or {}).get(theirs)
            mu = table.mu if table is not None else state.opt_state.mu[theirs]
            out.append(torch.linalg.vector_norm(mu.float()))
            if mu.numel() >= check.WIDE_LEAF:
                self.first[ours] = mu.to("cpu", copy=True)
        return torch.stack(out) / (1.0 - self.config["adam_b1"])

    def _changes(self) -> torch.Tensor:
        w0 = weights.make_weights(self.kind, self.config, self.seed,
                                  self.device)
        params = dict(self.trainer.model.named_parameters())
        out = torch.stack([
            torch.linalg.vector_norm(params[theirs].detach() - w0[ours])
            for ours, theirs in self.leaves.items()])
        del w0
        return out

    def close(self) -> dict:
        """The readings (``first_grads`` on the host, as mu)."""
        del self.trainer._train_step
        names = list(self.leaves)
        return {"losses": [float(x) for x in self.losses],
                "grad_norms": dict(zip(names, self.grad.tolist())),
                "change_norms": dict(zip(names, self.change.tolist())),
                "first_moments": self.first}


HOST_USE = ("user_s", "system_s", "minor_faults", "involuntary_switches")


def _host_use() -> tuple:
    """This process's CPU seconds, page faults and preemptions so far: by
    epoch, they tell the program's own host work from a host that others
    share."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime, ru.ru_stime, ru.ru_minflt, ru.ru_nivcsw


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(ctx) -> dict:
    kind, config, mix, dev = ctx.kind, ctx.config, ctx.mix, ctx.device
    pool = ctx.registry.generator(mix["generator"]).make_pool(
        config, mix, ctx.seed, dev)
    ctx.mark("pool")
    w = weights.make_weights(kind, config, ctx.seed, dev)
    cfg, packed, model = port.build_model(kind, config, mix, w, dev,
                                          seeds.derive(ctx.seed, "port"))
    del w
    ctx.mark("model")
    trainer = port.build_trainer(cfg, packed, model, pool,
                                 seeds.derive(ctx.seed, "shuffle"))
    ctx.mark("trainer")
    batch = mix["batch"]
    steps_per_epoch = len(pool["labels"]) // batch
    if steps_per_epoch < CHECKED_STEPS:
        raise ValueError(f"an epoch of {steps_per_epoch} steps: the check "
                         f"reads the first {CHECKED_STEPS}")
    probe = FirstSteps(trainer, kind, config, ctx.seed, dev)
    for _ in range(mix["warmup_epochs"]):
        trainer._train_epoch()
    prog = probe.close()
    _sync(dev)
    ctx.mark("warmup")

    spans = Spans()
    if ctx.trace:
        spans.wrap(trainer, "_train_step", "step")
        spans.wrap_iter(trainer, "_chunk_plan", "plan")
        mark_operations(spans, model, ctx.registry.opmaps())
    stage0 = trainer._stage_seconds
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    window_start = time.time()
    t0 = time.perf_counter()
    epochs = examples = failed = 0
    traced, ends, traced_wall = None, [], 0.0
    host = [_host_use()]
    while True:
        if ctx.trace and epochs == 1 and torch.device(dev).type == "cuda":
            spans.paused, t_in = True, time.perf_counter()
            s_in = trainer._stage_seconds
            with DeviceTrace() as traced:
                loss, n = trainer._train_epoch()
            spans.paused, traced_wall = False, time.perf_counter() - t_in
            stage0 += trainer._stage_seconds - s_in
        else:
            loss, n = trainer._train_epoch()
        ends.append(time.perf_counter() - t0)
        host.append(_host_use())
        epochs += 1
        examples += n
        if not math.isfinite(loss):
            failed += steps_per_epoch
        if time.perf_counter() - t0 >= ctx.seconds and (
                not ctx.trace or epochs >= 2):
            break
    _sync(dev)
    window_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(dev).type == "cuda" else None)
    spans.restore()
    stage_s = trainer._stage_seconds - stage0
    summary = traced.summary() if traced is not None else None

    del trainer, model, probe
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()

    w0 = weights.make_weights(kind, config, ctx.seed, dev)
    order = epoch_order(ctx.seed, len(pool["labels"]))
    batches = []
    for k in range(CHECKED_STEPS):
        rows = order[k * batch:(k + 1) * batch]
        batches.append((torch.from_numpy(pool["ids"][rows]).to(dev).long(),
                        torch.from_numpy(pool["dense"][rows]).to(dev),
                        torch.from_numpy(pool["labels"][rows]).to(dev)))
    ref = ctr.train_steps(kind, config, w0, batches,
                          keep=list(prog["first_moments"]))
    prog["first_grads"] = {
        k: v.to(dev).float() / (1.0 - config["adam_b1"])
        for k, v in prog.pop("first_moments").items()}
    numbers, where = check.train_numbers(prog, ref)
    where["epoch_ends_s"] = ends
    where["epoch_host"] = {
        k: [round(b[i] - a[i], 4) for a, b in zip(host, host[1:])]
        for i, k in enumerate(HOST_USE)}

    steps = epochs * steps_per_epoch
    return {
        "end_to_end": {"train_examples_per_s": examples / window_s},
        "window_start": window_start,
        "attempted": steps,
        "failed": failed,
        "memory_peak_bytes": peak,
        "numbers": numbers,
        "where": where,
        "readings": {
            "window_s": window_s,
            "span_window_s": window_s - traced_wall,
            "steps": steps,
            "spans": dict(spans.seconds, stage=stage_s),
            "span_counts": dict(spans.count),
            "trace": summary,
            "traced_steps": steps_per_epoch,
            "ops": counts.step_ops(kind, config, batch, train=True),
        },
    }

