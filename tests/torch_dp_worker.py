"""Rank processes of the port's data-parallel and model-sharded CPU tests.

``spawn(world, target, args, tmp, timeout, axes)`` starts ``world``
processes with ``torch.multiprocessing``'s spawn context, each one rank of
a gloo process group that meets through a file under ``tmp`` (no TCP
port, so parallel test workers cannot collide), builds the (data, model)
mesh ``axes`` (default: every rank on the data axis), runs
``target(mesh, *args)`` and returns each rank's result. Past ``timeout``
seconds every rank is killed and the call raises. This module imports no
JAX: the JAX oracle runs in the test process, and the ranks run the port
alone.
"""

from __future__ import annotations

import traceback
from pathlib import Path

import numpy as np
import torch


def spawn(world: int, target, args: tuple, tmp: Path,
          timeout: float = 240.0, axes: tuple[int, int] = (-1, 1)) -> list:
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    outs = [tmp / f"rank{r}.pt" for r in range(world)]
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, str(tmp / "store"), target, args,
                               str(outs[r]), axes))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        if hung:
            raise TimeoutError(f"ranks {hung} still ran after {timeout} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    errors = [Path(f"{o}.err").read_text() for o in outs
              if Path(f"{o}.err").exists()]
    if errors or any(p.exitcode != 0 for p in procs):
        raise RuntimeError(
            f"rank exit codes {[p.exitcode for p in procs]}:\n"
            + "\n".join(errors))
    return [torch.load(o, weights_only=False) for o in outs]


def _rank_main(rank, world, store, target, args, out, axes):
    import torch.distributed as dist

    from deepfm_tpu_torch.parallel import build_mesh, initialize_distributed

    torch.set_num_threads(1)
    try:
        initialize_distributed(env={}, device="cpu",
                               init_method=f"file://{store}", rank=rank,
                               world_size=world, timeout_s=120)
        result = target(build_mesh(*axes, device="cpu"), *args)
        torch.save(result, out)
    except BaseException:
        Path(f"{out}.err").write_text(f"rank {rank}:\n"
                                      + traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# targets
# ---------------------------------------------------------------------------


def port_state(trainer) -> dict:
    """Host copies of what a step changes: the model's state_dict, the
    table moments and the carried table sums of squares."""
    st = trainer.state
    return {
        "model": {k: v.detach().cpu().clone()
                  for k, v in trainer.model.state_dict().items()},
        "table_opt": {n: (s.mu.cpu().clone(), s.nu.cpu().clone())
                      for n, s in (st.table_opt or {}).items()},
        "table_psq": {n: v.cpu().clone()
                      for n, v in (st.table_psq or {}).items()},
    }


def _trainer(mesh, case):
    from deepfm_tpu_torch.config import config_from_dict
    from deepfm_tpu_torch.models import create_model
    from deepfm_tpu_torch.training.trainer import Trainer

    from deepfm_tpu_torch.training.persistence import slab_state

    config = config_from_dict(case["raw"])
    model = create_model(config.model_name, case["packed"], config,
                         device="cpu", mesh=mesh)
    if case.get("init") is not None:
        model.load_state_dict(slab_state(model, case["init"]["model"]))
    trainer = Trainer(model, case["packed"], config, mesh=mesh)
    if case.get("init") is not None and trainer.state.table_psq is not None:
        trainer.state.table_psq = dict(case["init"]["table_psq"])
    return trainer


def _planted(fault: str | None, mesh=None):
    """Replace one collective of the step for the run of a planted fault:
    "skip_reduce" (rank 1 takes part in the flat all-reduce but keeps its
    own gradients, so neither rank waits forever), "skip_gather" (every
    rank keeps its own (id, cotangent) pairs; the replica check still
    gathers), "local_bn" (BatchNorm's statistics stay per rank),
    "world_reduce" (the flat all-reduce of the dense gradients runs over
    the world, not the data group), "no_shift" (each slab takes the
    global sorted ids unshifted); "peer_rows" is ``run_steps``' (model
    peers given different rows). Returns a function that puts the
    collective back."""
    import deepfm_tpu_torch.training.steps as steps
    from deepfm_tpu_torch.parallel import collectives

    if fault == "skip_reduce":
        real = collectives.all_reduce_flat

        def own_on_rank_1(m, tensors):
            summed = real(m, tensors)
            return list(tensors) if m.rank == 1 else summed

        collectives.all_reduce_flat = own_on_rank_1
        return lambda: setattr(collectives, "all_reduce_flat", real)
    if fault == "world_reduce":
        real = collectives.all_reduce_flat
        collectives.all_reduce_flat = lambda g, tensors: real(
            mesh.world_group, tensors)
        return lambda: setattr(collectives, "all_reduce_flat", real)
    if fault == "no_shift":
        real = steps.slab_ids
        steps.slab_ids = lambda sids, j, rows: sids
        return lambda: setattr(steps, "slab_ids", real)
    if fault == "local_bn":
        real = collectives.all_reduce_sum
        collectives.all_reduce_sum = lambda m, t: t
        return lambda: setattr(collectives, "all_reduce_sum", real)
    if fault == "skip_gather":
        real_module = steps.collectives

        class OwnPairs:
            def __getattr__(self, attr):
                if attr == "all_gather_rows":
                    return lambda m, t: t
                return getattr(real_module, attr)

        steps.collectives = OwnPairs()
        return lambda: setattr(steps, "collectives", real_module)
    assert fault in (None, "peer_rows"), fault
    return lambda: None


def _rows(mesh, n: int, fault: str | None) -> slice:
    """The rank's rows of a global batch of ``n`` rows; under the planted
    fault "peer_rows" the rows of data index rank % data, which hands the
    model peers of a data row different rows."""
    from deepfm_tpu_torch.parallel import batch_rows

    if fault != "peer_rows":
        return batch_rows(mesh, n)
    per = n // mesh.data
    i = mesh.rank % mesh.data
    return slice(i * per, (i + 1) * per)


def run_steps(mesh, cases: list[dict]) -> list[dict]:
    """Each case's trainer under ``mesh``: ``case["batches"]`` (global
    numpy batches), each rank stepping on its rows, the replicas checked
    after every step. Returns per case the losses, whether every replica
    check passed (and the first refusal), and the final state."""
    out = []
    for case in cases:
        trainer = _trainer(mesh, case)
        restore = _planted(case.get("fault"), mesh)
        losses, refusal = [], None
        try:
            for ids, dense, labels, weights in case["batches"]:
                rows = _rows(mesh, len(labels), case.get("fault"))
                losses.append(float(trainer._train_step(
                    ids[rows], dense[rows], labels[rows], weights[rows])))
                try:
                    trainer.check_replicas(f"step {len(losses)}")
                except RuntimeError as e:
                    refusal = refusal or str(e)
        finally:
            restore()
        out.append({"name": case["name"], "path": trainer.path,
                    "losses": losses, "replica_refusal": refusal,
                    "state": port_state(trainer)})
    return out


def batchnorm_global(mesh, x: np.ndarray, weight: np.ndarray) -> dict:
    """A train-mode BatchNorm on the rank's rows of ``x`` with global
    statistics: its output, its running statistics, and the gradient of
    sum(out * weight) (over the global batch) by the rank's rows and by
    the scale and bias."""
    from deepfm_tpu_torch.ops.dnn import BatchNorm
    from deepfm_tpu_torch.parallel import batch_rows, collectives

    bn = BatchNorm(x.shape[1], eps=1e-5, momentum=0.1)
    bn.mesh = mesh
    rows = batch_rows(mesh, x.shape[0])
    xs = torch.from_numpy(x[rows]).requires_grad_()
    y = bn(xs)
    (y * torch.from_numpy(weight[rows])).sum().backward()
    grads = collectives.all_reduce_flat(mesh, [bn.weight.grad, bn.bias.grad])
    return {"out": y.detach(), "x_grad": xs.grad,
            "running_mean": bn.running_mean.clone(),
            "running_var": bn.running_var.clone(),
            "scale_grad": grads[0], "bias_grad": grads[1]}


def loop_config(root: Path, run: str, epochs: int, extra=()):
    """configs/xdeepfm_movielens_cin_tuned.yaml cut to small widths on the
    small MovieLens set under ``root``, ``run``'s output under ``root``;
    ``extra`` overrides appended."""
    from deepfm_tpu_torch.config import load_config

    return load_config("configs/xdeepfm_movielens_cin_tuned.yaml", [
        f"data.data_dir={root / 'data'}", "data.num_neg_train=1",
        "data.num_neg_eval=5", "data.use_native_sampler=false",
        "feature.fm_embed_dim=8", "cin.layer_sizes=[8,8]",
        "dnn.hidden_units=[16,8]", f"training.num_epochs={epochs}",
        "training.batch_size=64", "training.resume=true", "device=cpu",
        f"output_dir={root / run}", *extra])


def dp_loop(mesh, root: str) -> dict:
    """The trainer loop on every rank through the CLI's commands: ``train``
    for 2 epochs ("dp"), ``evaluate`` of its checkpoint and of a
    one-process run's ("single"), a run of 1 epoch resumed to 2
    ("resumed"), and a resume of the one-process run at this world size
    (refused: the model has dropout)."""
    from deepfm_tpu_torch.cli import evaluate_command, train_command

    root = Path(root)
    trainer = train_command(loop_config(root, "dp", 2))
    out = {"rank": mesh.rank, "history": trainer.history,
           "throughput": trainer.throughput,
           "mesh": None if trainer.mesh is None else trainer.mesh.shape,
           "evaluate_dp": evaluate_command(loop_config(root, "dp", 2)),
           "evaluate_single": evaluate_command(
               loop_config(root, "single", 2))}
    train_command(loop_config(root, "resumed", 1))
    out["resumed_history"] = train_command(
        loop_config(root, "resumed", 2)).history
    try:
        train_command(loop_config(root, "single", 3))
        out["cross_world_resume"] = None
    except ValueError as e:
        out["cross_world_resume"] = str(e)
    return out


# the model-sharded loop's mesh: one data row of two slabs, routed
SHARD_LOOP = ("mesh.model_axis=2", "mesh.embedding_strategy=all_to_all")


def shard_loop(mesh, root: str) -> dict:
    """The trainer loop at a (1, 2) mesh through the CLI's commands:
    ``train`` for 2 epochs ("sharded"), ``evaluate`` of its checkpoint and
    of a one-process run's ("single"), a run of 1 epoch resumed to 2
    ("resumed"), and the one-process run resumed to 3 epochs at this mesh
    ("single_on_mesh", a copy of "single": the data axis matches, so its
    dropout generator carries on)."""
    import shutil

    from deepfm_tpu_torch.cli import evaluate_command, train_command

    root = Path(root)
    trainer = train_command(loop_config(root, "sharded", 2, SHARD_LOOP))
    out = {"rank": mesh.rank, "history": trainer.history,
           "mesh": None if trainer.mesh is None else trainer.mesh.shape,
           "slab_rows": {n: p.shape[0] for n, p in trainer.params.items()
                         if n in trainer.table_names},
           "evaluate_sharded": evaluate_command(
               loop_config(root, "sharded", 2, SHARD_LOOP)),
           "evaluate_single": evaluate_command(
               loop_config(root, "single", 2, SHARD_LOOP))}
    train_command(loop_config(root, "resumed", 1, SHARD_LOOP))
    out["resumed_history"] = train_command(
        loop_config(root, "resumed", 2, SHARD_LOOP)).history
    if mesh.rank == 0:
        shutil.copytree(root / "single", root / "single_on_mesh")
    from deepfm_tpu_torch.parallel import collectives

    collectives.barrier(mesh)
    out["single_on_mesh_history"] = train_command(
        loop_config(root, "single_on_mesh", 3, SHARD_LOOP)).history
    return out
