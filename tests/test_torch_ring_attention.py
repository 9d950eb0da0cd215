"""The port's ring attention over the field axis
(``deepfm_tpu_torch/parallel/ring_attention.py``) against the JAX op
(``deepfm_tpu/parallel/ring_attention.py``) and the unsharded oracle of
tests/test_parallel.py, on the CPU.

One spawn of 4 gloo ranks (``tests/torch_dp_worker.py::spawn``, targets in
``tests/torch_shard_worker.py``) runs every case: at (1, 4) and at (2, 2)
(each data row its own ring over its rows of the batch), the same seeded
q / k / v as the JAX test's. The JAX op runs on the conftest's 8 CPU
devices at the matching model axis (``build_mesh(2, 4)``, ``build_mesh(4,
2)``). Each rank's output block, and in the gradient cases its blocks of
the gradients of sum(out²) by q, k and v, are held to the same block of
the JAX result and of the oracle's.

Tolerances: f32 forward rtol 2e-5 / atol 2e-6 and gradients rtol 2e-4 /
atol 2e-5 (the JAX test's); bf16 forward atol 1e-2, about one bf16 ulp
(2^-7) of outputs below 2, against the JAX op and the oracle on the same
bf16 inputs (both round the scores and the output to bf16; the oracle's
softmax is bf16 throughout: 3.7e-3 from the port, which equals the JAX
op's bits here).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

import torch_dp_worker  # noqa: E402
import torch_shard_worker  # noqa: E402

from deepfm_tpu.parallel import build_mesh as jax_build_mesh  # noqa: E402
from deepfm_tpu.parallel.ring_attention import (  # noqa: E402
    ring_field_attention as jax_ring,
)
from deepfm_tpu_torch.parallel import (  # noqa: E402
    Mesh,
    field_block,
    ring_field_attention,
)

torch.set_num_threads(1)

FWD_TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_TOL = dict(rtol=0, atol=1e-2)
# name -> (axes, F, dtype, gradients)
CASES = {
    "f32_1x4": ((1, 4), 32, "float32", False),
    "grads_1x4": ((1, 4), 8, "float32", True),
    "bf16_1x4": ((1, 4), 32, "bfloat16", False),
    "f32_2x2": ((2, 2), 32, "float32", True),
}


def _qkv(b=4, f=32, h=2, dh=8, seed=0):
    """tests/test_parallel.py's ``TestRingAttention._qkv``, as numpy."""
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, f, h, dh)).astype(np.float32)
                 for _ in range(3))


def _oracle(q, k, v):
    scale = 1.0 / np.sqrt(q.shape[-1])
    s = jnp.einsum("bqhd,bkhd->bqhk", q, k) * scale
    return jnp.einsum("bqhk,bkhd->bqhd", jax.nn.softmax(s, -1), v)


def _loss(fn):
    return lambda q, k, v: jnp.sum(fn(q, k, v).astype(jnp.float32) ** 2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases = []
    for axes, f, dtype, grads in CASES.values():
        q, k, v = _qkv(f=f)
        cases.append({"axes": axes, "dtype": dtype, "grads": grads,
                      "q": q, "k": k, "v": v})
    ranks = torch_dp_worker.spawn(
        4, torch_shard_worker.ring_attention, (cases,),
        tmp_path_factory.mktemp("ring_attention"), axes=(1, 4))
    return {name: [r[i] for r in ranks] for i, name in enumerate(CASES)}


def _want(name):
    """The JAX op's output (and gradients) and the oracle's, whole."""
    axes, f, dtype, grads = CASES[name]
    mesh = jax_build_mesh(8 // axes[1], axes[1])
    q, k, v = (jnp.asarray(x, getattr(jnp, dtype)) for x in _qkv(f=f))
    ring = lambda *a: jax_ring(*a, mesh)  # noqa: E731
    out = {"jax": {"out": ring(q, k, v)}, "oracle": {"out": _oracle(q, k, v)}}
    if grads:
        for key, fn in (("jax", ring), ("oracle", _oracle)):
            g = jax.grad(_loss(fn), argnums=(0, 1, 2))(q, k, v)
            out[key].update(dq=g[0], dk=g[1], dv=g[2])
    return {key: {n: np.asarray(jnp.asarray(x, jnp.float32))
                  for n, x in rec.items()} for key, rec in out.items()}


def _block(whole, rec, axes):
    """The rank's block of a whole (B, F, ...) array."""
    d, m = axes
    b, f = whole.shape[:2]
    i, j = rec["data_index"], rec["model_index"]
    return whole[i * b // d:(i + 1) * b // d, j * f // m:(j + 1) * f // m]


def _check(name, ranks, keys, tol):
    want = _want(name)
    axes = CASES[name][0]
    assert sorted((r["data_index"], r["model_index"]) for r in ranks) == [
        (i, j) for i in range(axes[0]) for j in range(axes[1])]
    for r in ranks:
        for key in keys:
            got = r[key].numpy()
            for ref in ("jax", "oracle"):
                np.testing.assert_allclose(
                    got, _block(want[ref][key], r, axes), **tol,
                    err_msg=f"{name} {key} against {ref}")


@pytest.mark.parametrize("name", ["f32_1x4", "f32_2x2"])
def test_forward_matches_jax_and_the_oracle(runs, name):
    _check(name, runs[name], ("out",), FWD_TOL)


@pytest.mark.parametrize("name", ["grads_1x4", "f32_2x2"])
def test_q_k_v_gradients_match_jax_and_the_oracle(runs, name):
    _check(name, runs[name], ("dq", "dk", "dv"), GRAD_TOL)


def test_bf16_forward_matches_jax(runs):
    _check("bf16_1x4", runs["bf16_1x4"], ("out",), BF16_TOL)


@pytest.mark.parametrize("mesh", [None, Mesh(
    data=8, model=1, rank=0, world=8, local_rank=0,
    device=torch.device("cpu"), backend=None)])
def test_model_axis_one_is_plain_softmax_attention(mesh):
    q, k, v = _qkv(f=16)
    got = ring_field_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                               mesh).numpy()
    want = jax_ring(*(jnp.asarray(x) for x in (q, k, v)),
                    jax_build_mesh(8, 1))
    np.testing.assert_allclose(got, np.asarray(want), **FWD_TOL)
    np.testing.assert_allclose(got, np.asarray(_oracle(q, k, v)), **FWD_TOL)
    assert field_block(mesh, torch.from_numpy(q)).shape == q.shape


def test_fields_the_model_axis_does_not_divide_are_refused_as_jax_does():
    q, k, v = _qkv(f=30)
    with pytest.raises(ValueError) as jax_error:
        jax_ring(*(jnp.asarray(x) for x in (q, k, v)), jax_build_mesh(2, 4))
    mesh = Mesh(data=1, model=4, rank=1, world=4, local_rank=1,
                device=torch.device("cpu"), backend=None)
    with pytest.raises(ValueError) as port_error:
        field_block(mesh, torch.from_numpy(q))
    assert str(port_error.value) == str(jax_error.value) == (
        "F=30 must divide model axis 4")
    assert field_block(mesh, torch.zeros(2, 32)).shape == (2, 8)
