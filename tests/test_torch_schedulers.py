"""The port's learning-rate schedulers against the JAX package's: the same
learning rate, as a Python float, after every epoch of a sequence of
metrics, and the same state dicts."""

import jax.numpy as jnp
import pytest
import torch

from deepfm_tpu.config import config_from_dict as jax_config
from deepfm_tpu.training import schedulers as jsched
from deepfm_tpu_torch.config import config_from_dict
from deepfm_tpu_torch.training import schedulers as tsched
from deepfm_tpu_torch.training.optim import OptState

torch.set_num_threads(1)

# AUC-like metrics: rises, a plateau within the 1e-4 threshold, drops
METRICS = [0.70, 0.72, 0.72, 0.72005, 0.719, 0.718, 0.73, 0.73, 0.729,
           0.7291, 0.70, 0.70, 0.71, 0.69, 0.74, 0.74]


def _run(scheduler):
    lrs = [scheduler.lr]
    for m in METRICS:
        lrs.append(scheduler.step(m))
    return lrs, scheduler.state_dict()


@pytest.mark.parametrize("kwargs", [
    {}, {"patience": 0}, {"factor": 0.1, "patience": 1, "threshold": 1e-2},
    {"enabled": False},
])
def test_plateau_matches_jax(kwargs):
    want = _run(jsched.PlateauScheduler(lr=1e-3, **kwargs))
    got = _run(tsched.PlateauScheduler(lr=1e-3, **kwargs))
    assert got == want
    assert len(set(got[0])) > 1 or kwargs.get("enabled") is False


@pytest.mark.parametrize("total,warmup", [(4, 2), (10, 0), (16, 3), (1, 5),
                                          (3, 7)])
def test_cosine_matches_jax(total, warmup):
    want = _run(jsched.CosineScheduler(lr=3e-3, total_epochs=total,
                                       warmup_epochs=warmup))
    got = _run(tsched.CosineScheduler(lr=3e-3, total_epochs=total,
                                      warmup_epochs=warmup))
    assert got == want


@pytest.mark.parametrize("name", ["reduce_on_plateau", "none",
                                  "warmup_cosine", "cyclic"])
def test_build_scheduler_follows_the_config(name):
    raw = {"training": {"scheduler": name, "warmup_epochs": 2,
                        "num_epochs": 5, "lr": 2e-3}}
    config = config_from_dict(raw)
    if name not in tsched.SCHEDULERS:
        with pytest.raises(ValueError, match=f"Unknown scheduler: {name}"):
            tsched.build_scheduler(config.training)
        return
    jtc = jax_config(raw).training
    if name == "warmup_cosine":
        want = jsched.CosineScheduler(lr=jtc.lr, total_epochs=jtc.num_epochs,
                                      warmup_epochs=jtc.warmup_epochs)
    else:
        want = jsched.PlateauScheduler(
            lr=jtc.lr, enabled=name == "reduce_on_plateau")
    got = tsched.build_scheduler(config.training)
    assert type(got).__name__ == type(want).__name__
    assert _run(got) == _run(want)


def test_set_lr_rounds_to_f32_as_jax():
    state = OptState(lr=torch.zeros((), dtype=torch.float32),
                     count=torch.zeros((), dtype=torch.int32))
    lr = 1e-3 / 3
    tsched.set_lr(state, lr)
    assert state.lr.dtype == torch.float32 and state.lr.shape == ()
    assert float(state.lr) == float(jnp.asarray(lr, dtype=jnp.float32))
