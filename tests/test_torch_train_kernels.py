"""The table-update kernels' plain versions against the JAX functions they
replace, and the kernels against their plain versions on the card.

Each plain version (``deepfm_tpu_torch/ops/kernels/{grad,adam,
sparse_adam}.py``) is held against the Pallas kernel of the JAX package,
run in interpret mode on the CPU as the JAX package's own tests run it,
on the same numpy inputs:

  * ``segment_sumsq`` against ``segment_sumsq_pairs`` and the
    associative-scan oracle at the four carry topologies of
    tests/test_sparse_fused.py: rel 1e-5 (another f32 summation order);
  * logical ``sparse_table_adam`` against ``sparse_table_adam_packed`` on
    ``pack_table``'d inputs, compared after ``unpack_table``; and
    ``fused_table_adam`` against the JAX one. First against the update in
    numpy f32 with every operation rounded on its own (the literal op order
    the kernels keep): mu/nu bit for bit, p rtol 1e-6 / atol 1e-7
    (PyTorch's CPU ``sqrt`` is not correctly rounded for about 0.6 % of
    inputs; numpy's is). Then against JAX: p rtol 1e-6 /
    atol 1e-7, psq rel 1e-5, and mu/nu within FMA_ULPS ulps of their two
    terms: XLA:CPU contracts ``g + wd*p`` and ``b1*mu + (1-b1)*g`` into
    fused multiply-adds, which moves many f32 moments by one ulp and,
    rarely, a bf16 moment by one bf16 step. The cotangents are multiples of 2^-12
    below 2, so their sums are exact in f32 in any order and the TPU
    kernel's one-hot matmul and the port's run sums see one gradient;
  * ``densify_rows_grad`` against ``np.add.at`` (bit for bit: both add in
    the original order) and the JAX one, whose 3-way bf16 split sums each
    mantissa part on its own "to f32 working precision": within 1e-6 of
    the row's sum of |ct| (8 ulps of it).

``vector_split``, the fused kernel's cut of a table into a scalar head, a
body of 16-byte vectors and a scalar tail (the C launch recomputes it from
the pointers), is checked here on addresses alone.

The kernels themselves are held against these plain versions on the card
by tests/test_torch_train_cuda.py and chip_smoke.py.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

from deepfm_tpu.ops.pallas.adam_kernel import (  # noqa: E402
    fused_table_adam as jax_fused_table_adam,
)
from deepfm_tpu.ops.pallas.grad_kernel import (  # noqa: E402
    densify_rows_grad as jax_densify,
)
from deepfm_tpu.ops.pallas.sparse_adam_kernel import (  # noqa: E402
    segment_sumsq_pairs,
    sorted_segment_sumsq_scan,
    sparse_table_adam_packed,
)
from deepfm_tpu.ops.pallas.sparse_adam_kernel import (  # noqa: E402
    sort_pairs as jax_sort_pairs,
)
from deepfm_tpu.utils.layout import pack_table  # noqa: E402
from deepfm_tpu.utils.layout import unpack_table as jax_unpack  # noqa: E402
from deepfm_tpu_torch.convert import unpack_table  # noqa: E402
from deepfm_tpu_torch.ops.kernels import build  # noqa: E402
from deepfm_tpu_torch.ops.kernels.adam import (  # noqa: E402
    VECTOR,
    fused_table_adam,
    fused_table_adam_plain,
    vector_split,
)
from deepfm_tpu_torch.ops.kernels.grad import (  # noqa: E402
    densify_rows_grad,
    densify_rows_grad_plain,
    sort_pairs,
)
from deepfm_tpu_torch.ops.kernels.sparse_adam import (  # noqa: E402
    segment_sumsq,
    segment_sumsq_plain,
    sparse_table_adam,
    sparse_table_adam_plain,
)

torch.set_num_threads(1)

D = 17  # d + 1 columns of a width-16 table
LR, WD = 1e-3, 2e-5
MOMENT_DTYPES = {"float32": (np.float32, torch.float32),
                 "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.numpy()


def _table_inputs(rows, n, seed, exact=False):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, rows, n).astype(np.int32)
    if exact:  # multiples of 2^-12 in (-2, 2): f32 sums of them are exact
        ct = rng.integers(-8192, 8192, (n, D)).astype(np.float32) / 4096.0
    else:
        ct = rng.normal(size=(n, D)).astype(np.float32) * 0.1
    p = rng.normal(size=(rows, D)).astype(np.float32) * 0.05
    mu = rng.normal(size=(rows, D)).astype(np.float32) * 0.01
    nu = (rng.normal(size=(rows, D)).astype(np.float32) * 0.01) ** 2
    return ids, ct, p, mu, nu


FMA_ULPS = 2  # one rounding each for the two contracted multiply-adds
BF16_STEP_SHARE = 1e-3  # bf16 moments one step apart: at most this share


def _literal_adam(p, g, mu, nu, gnorm, clip, step, mdt):
    """The update in numpy f32, each operation rounded on its own:
    (p', mu', nu') with the moments cast to ``mdt``, and the f32 magnitudes
    of the two terms of each moment update (for the FMA bound)."""
    f = np.float32
    mu32, nu32 = mu.astype(f), nu.astype(f)
    g = g + f(WD) * p
    if 0 < clip <= gnorm:
        g = g / f(gnorm) * f(clip)
    t = f(step + 1)
    bc1 = f(1) - np.power(f(0.9), t)
    bc2 = f(1) - np.power(f(0.999), t)
    m = f(1 - 0.9) * g + f(0.9) * mu32
    v = f(1 - 0.999) * (g * g) + f(0.999) * nu32
    p2 = p - f(LR) * ((m / bc1) / (np.sqrt(v / bc2) + f(1e-8)))
    mterms = np.abs(f(1 - 0.9) * g) + np.abs(f(0.9) * mu32)
    vterms = np.abs(f(1 - 0.999) * (g * g)) + np.abs(f(0.999) * nu32)
    return p2, m.astype(mdt), v.astype(mdt), mterms, vterms


def _assert_moment_near_jax(got, want, terms, mdt):
    """Equal up to XLA:CPU's FMA contraction (see the module docstring):
    within FMA_ULPS f32 ulps of the update's two terms, plus, for bf16
    moments, one bf16 step (at most 2^-7 of the value) on at most
    BF16_STEP_SHARE of the elements."""
    got, want = got.astype(np.float32), want.astype(np.float32)
    bound = FMA_ULPS * 2.0**-23 * terms
    if mdt != np.float32:
        assert (got != want).mean() <= BF16_STEP_SHARE
        bound = bound + 2.0**-7 * np.maximum(np.abs(got), np.abs(want))
    assert np.all(np.abs(got - want) <= bound)


@pytest.mark.parametrize("n,vocab", [
    (37, 10),        # ragged single chunk
    (1500, 7),       # few runs, multi-chunk, runs span chunks
    (5000, 100000),  # nearly all-unique, multi-chunk
    (4096, 1),       # one run across all chunks
])
def test_segment_sumsq_matches_jax(n, vocab):
    rng = np.random.default_rng(n)
    ids = rng.integers(0, vocab, n).astype(np.int32)
    ct = rng.normal(size=(n, D)).astype(np.float32)
    jsids, jcts = jax_sort_pairs(jnp.asarray(ids), jnp.asarray(ct))
    want_pairs = float(segment_sumsq_pairs(jsids, jcts))
    want_scan = float(sorted_segment_sumsq_scan(jsids, jcts))
    sids, cts = sort_pairs(torch.from_numpy(ids), torch.from_numpy(ct))
    np.testing.assert_array_equal(sids.numpy(), np.asarray(jsids))
    got = float(segment_sumsq(sids, cts))
    assert got == pytest.approx(want_pairs, rel=1e-5)
    assert got == pytest.approx(want_scan, rel=1e-5)


@pytest.mark.parametrize("moments", sorted(MOMENT_DTYPES))
@pytest.mark.parametrize("clip", [0.0, 5.0])
def test_sparse_table_adam_matches_packed_jax(clip, moments):
    """The logical kernel's plain version == the TPU's packed kernel,
    compared in the logical layout (ragged phys vs TILE_PHYS covered)."""
    pack, phys = 7, 640
    rows = phys * pack
    jdt, tdt = MOMENT_DTYPES[moments]
    ids, ct, p, mu, nu = _table_inputs(rows, 3000, seed=0, exact=True)
    mu, nu = (np.asarray(jnp.asarray(m).astype(jdt)) for m in (mu, nu))
    gnorm, step = 7.5, 3  # clip 5 is active, clip 0 disables clipping

    jsids, jcts = jax_sort_pairs(jnp.asarray(ids), jnp.asarray(ct))
    jp, jmu, jnu, jpsq = sparse_table_adam_packed(
        *(jnp.asarray(pack_table(a, D, pack, phys)) for a in (p, mu, nu)),
        jsids, jcts, LR, WD, gnorm, clip, jnp.asarray(step, jnp.int32), pack,
    )
    want = [jax_unpack(np.asarray(a), D, pack, rows) for a in (jp, jmu, jnu)]

    tp, tmu, tnu = (_to_torch(a) for a in (p, mu, nu))
    assert tmu.dtype == tdt
    sids, cts = sort_pairs(torch.from_numpy(ids), torch.from_numpy(ct))
    out = sparse_table_adam(tp, tmu, tnu, sids, cts, LR, WD, gnorm, clip,
                            torch.tensor(step, dtype=torch.int32))
    assert out[0] is tp and out[1] is tmu and out[2] is tnu  # in place

    g = np.zeros((rows, D), np.float32)
    np.add.at(g, ids, ct)
    lp, lmu, lnu, mterms, vterms = _literal_adam(p, g, mu, nu, gnorm, clip,
                                                 step, jdt)
    np.testing.assert_allclose(tp.numpy(), lp, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(_np(tmu), lmu.astype(np.float32))
    np.testing.assert_array_equal(_np(tnu), lnu.astype(np.float32))

    _assert_moment_near_jax(_np(tmu), want[1], mterms, jdt)
    _assert_moment_near_jax(_np(tnu), want[2], vterms, jdt)
    np.testing.assert_allclose(tp.numpy(), want[0], rtol=1e-6, atol=1e-7)
    assert float(out[3]) == pytest.approx(float(jpsq), rel=1e-5)
    assert float(out[3]) == pytest.approx(float(np.sum(want[0] ** 2)),
                                          rel=1e-5)


@pytest.mark.parametrize("moments", sorted(MOMENT_DTYPES))
@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_fused_table_adam_matches_jax(clip, moments):
    rows = 1000
    jdt, _ = MOMENT_DTYPES[moments]
    rng = np.random.default_rng(5)
    _, _, p, mu, nu = _table_inputs(rows, 1, seed=5)
    g = rng.normal(size=(rows, D)).astype(np.float32) * 0.1
    mu, nu = (np.asarray(jnp.asarray(m).astype(jdt)) for m in (mu, nu))
    gnorm, step = 2.5, 0
    want = jax_fused_table_adam(
        jnp.asarray(p), jnp.asarray(mu), jnp.asarray(nu), jnp.asarray(g),
        LR, WD, gnorm, clip, jnp.asarray(step, jnp.int32),
    )
    tp, tmu, tnu = (_to_torch(a) for a in (p, mu, nu))
    fused_table_adam(tp, tmu, tnu, torch.from_numpy(g), LR, WD,
                     torch.tensor(gnorm), clip,
                     torch.tensor(step, dtype=torch.int32))
    lp, lmu, lnu, mterms, vterms = _literal_adam(p, g, mu, nu, gnorm, clip,
                                                 step, jdt)
    np.testing.assert_allclose(tp.numpy(), lp, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(_np(tmu), lmu.astype(np.float32))
    np.testing.assert_array_equal(_np(tnu), lnu.astype(np.float32))
    _assert_moment_near_jax(_np(tmu), np.asarray(want[1]), mterms, jdt)
    _assert_moment_near_jax(_np(tnu), np.asarray(want[2]), vterms, jdt)
    np.testing.assert_allclose(tp.numpy(), np.asarray(want[0]), rtol=1e-6,
                               atol=1e-7)


def test_sparse_and_fused_adam_agree():
    """sparse_table_adam == densify + fused_table_adam (the relation the
    JAX package tests between its two kernels), bit for bit here: both
    plain versions share the segmented sum and the update."""
    rows = 900
    ids, ct, p, mu, nu = _table_inputs(rows, 2500, seed=9)
    args = (LR, WD, torch.tensor(3.0), 1.0, torch.tensor(4, dtype=torch.int32))
    a = [torch.from_numpy(x.copy()) for x in (p, mu, nu)]
    b = [torch.from_numpy(x.copy()) for x in (p, mu, nu)]
    sids, cts = sort_pairs(torch.from_numpy(ids), torch.from_numpy(ct))
    *_, psq = sparse_table_adam(*a, sids, cts, *args)
    g = densify_rows_grad(torch.from_numpy(ct), torch.from_numpy(ids), rows)
    fused_table_adam(*b, g, *args)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert float(psq) == pytest.approx(float(torch.sum(b[0] ** 2)), rel=1e-6)


@pytest.mark.parametrize("rows,n,vocab", [(1000, 3000, 1000), (300, 500, 3)])
def test_densify_matches_jax_and_add_at(rows, n, vocab):
    rng = np.random.default_rng(rows)
    ids = rng.integers(0, vocab, n).astype(np.int32)
    ct = rng.normal(size=(n, D)).astype(np.float32)
    want = np.zeros((rows, D), np.float32)
    np.add.at(want, ids, ct)
    got = densify_rows_grad(torch.from_numpy(ct), torch.from_numpy(ids), rows)
    np.testing.assert_array_equal(got.numpy(), want)
    jgot = np.asarray(jax_densify(jnp.asarray(ct), jnp.asarray(ids), rows))
    mass = np.zeros((rows, D), np.float32)
    np.add.at(mass, ids, np.abs(ct))
    assert np.all(np.abs(got.numpy() - jgot) <= 1e-6 * mass)


def test_sort_pairs_is_stable_and_unpack_matches_jax():
    ids = torch.tensor([3, 1, 3, 0, 1, 3])
    ct = torch.arange(6, dtype=torch.float32)[:, None].repeat(1, 2)
    sids, cts = sort_pairs(ids, ct)
    assert sids.dtype == torch.int32
    assert sids.tolist() == [0, 1, 1, 3, 3, 3]
    assert cts[:, 0].tolist() == [3, 1, 4, 0, 2, 5]
    logical = np.random.default_rng(0).normal(size=(50, D)).astype(np.float32)
    packed = pack_table(logical, D, 7, 8)
    np.testing.assert_array_equal(unpack_table(packed, D, 7, 56),
                                  jax_unpack(packed, D, 7, 56))


def test_plain_versions_handle_empty_and_out_of_range_ids():
    cts = torch.ones(3, D)
    sids = torch.tensor([-1, 2, 9], dtype=torch.int32)
    g = densify_rows_grad_plain(cts, sids, 5)
    assert g.sum() == D and g[2].sum() == D
    empty = torch.zeros(0, dtype=torch.int32)
    assert float(segment_sumsq_plain(empty, torch.zeros(0, D))) == 0.0
    p, mu, nu = torch.ones(4, D), torch.zeros(4, D), torch.zeros(4, D)
    *_, psq = sparse_table_adam_plain(p, mu, nu, empty, torch.zeros(0, D),
                                      LR, 0.0, 1.0, 0.0,
                                      torch.tensor(0, dtype=torch.int32))
    assert torch.all(p == 1.0) and float(psq) == 4 * D
    fused_table_adam_plain(p, mu, nu, torch.zeros(4, D), LR, 0.0, 1.0, 0.0,
                           torch.tensor(1, dtype=torch.int32))
    assert torch.all(p == 1.0)


def _covered(numel, split):
    """Each element's count of the split's pieces that take it."""
    seen = np.zeros(numel, dtype=int)
    seen[:split.head] += 1
    body = split.head + VECTOR * split.vectors
    seen[split.head:body] += 1
    seen[body:body + split.tail] += 1
    return seen, body


@pytest.mark.parametrize("moment_size", [4, 2])
@pytest.mark.parametrize("offset", range(8))
def test_vector_split_covers_each_element_once(offset, moment_size):
    """Tables of 0-40 elements whose four arrays sit ``offset`` elements
    past a 256-byte boundary (a view one or more elements off): every
    element falls in exactly one of head, vectors and tail, the head is
    shorter than a vector, and every vector starts 16-byte aligned in all
    four arrays."""
    bases = (256, 4096, 65536, 1 << 20)
    sizes = (4, 4, moment_size, moment_size)
    for numel in range(41):
        addrs = [(b + offset * sz, sz) for b, sz in zip(bases, sizes)]
        split = vector_split(numel, addrs)
        seen, body = _covered(numel, split)
        assert (seen == 1).all(), (numel, split)
        assert split.head < VECTOR and split.tail < VECTOR
        for v in range(split.vectors):
            i = split.head + VECTOR * v
            assert all((a + i * sz) % 16 == 0 for a, sz in addrs)
        assert body + split.tail == numel


def test_vector_split_without_a_common_alignment_is_all_scalar():
    """Arrays whose misalignments never meet (p one f32 off, the gradient
    aligned) take every element one at a time."""
    addrs = [(256 + 4, 4), (4096, 4), (8192, 2), (16384, 2)]
    for numel in (0, 5, 40, 1001):
        split = vector_split(numel, addrs)
        assert split == (numel, 0, 0)
        assert (_covered(numel, split)[0] == 1).all()


def test_wrappers_refuse_devices_without_a_kernel():
    """No wrapper falls back: a tensor on neither the CPU nor a GPU (meta)
    is refused, as a CUDA tensor is when its kernel cannot launch."""
    m = torch.zeros(4, D, device="meta")
    ids = torch.zeros(4, dtype=torch.int32, device="meta")
    step = torch.tensor(0, dtype=torch.int32)
    calls = [
        lambda: densify_rows_grad(m, ids, 4),
        lambda: segment_sumsq(ids, m),
        lambda: fused_table_adam(m, m, m, m, LR, WD, 1.0, 1.0, step),
        lambda: sparse_table_adam(m, m, m, ids, m, LR, WD, 1.0, 1.0, step),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="unsupported device"):
            call()


def test_editing_a_header_changes_the_library(tmp_path, monkeypatch):
    """A source's library name hashes every csrc/*.cuh: an edited shared
    header can never load a stale library."""
    for name in ("sparse_table_adam.cu", "table_update.cuh"):
        (tmp_path / name).write_bytes((build.CSRC_DIR / name).read_bytes())
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    before = build.library_path("sparse_table_adam.cu")
    assert before == build.library_path("sparse_table_adam.cu")
    with open(tmp_path / "table_update.cuh", "a") as f:
        f.write("\n// edited\n")
    assert build.library_path("sparse_table_adam.cu") != before
    assert set(build.SOURCES) >= {
        "densify_rows_grad.cu", "fused_table_adam.cu", "sparse_table_adam.cu",
    }


@pytest.mark.parametrize("use_grad_kernel", [True, False])
def test_table_gradient_always_comes_from_densify(use_grad_kernel,
                                                  monkeypatch):
    """The embedding gather's backward is the densify wrapper whatever
    ``pallas.use_grad_kernel`` says (no switch routes around the kernel on
    the card), and it equals autograd's own scatter of the same rows."""
    from deepfm_tpu_torch.config import config_from_dict
    from deepfm_tpu_torch.data.packing import pack_schema
    from deepfm_tpu_torch.data.schema import (
        DatasetSchema,
        FeatureType,
        FieldSchema,
    )
    from deepfm_tpu_torch.models import create_model
    from deepfm_tpu_torch.ops.kernels import grad as grad_mod

    fields = {f"f{i}": FieldSchema(f"f{i}", FeatureType.SPARSE, 30, 16, "g")
              for i in range(3)}
    packed = pack_schema(DatasetSchema(fields=fields))
    config = config_from_dict({
        "model_name": "deepfm", "device": "cpu",
        "dnn": {"hidden_units": [8], "dropout": 0.0},
        "pallas": {"use_grad_kernel": use_grad_kernel},
    })
    model = create_model("deepfm", packed, config, device="cpu", seed=0)
    calls = []

    def counted(ct, ids, num_rows):
        calls.append(num_rows)
        return densify_rows_grad(ct, ids, num_rows)

    monkeypatch.setattr(grad_mod, "densify_rows_grad", counted)
    rng = np.random.default_rng(5)
    ids = torch.from_numpy(rng.integers(0, 30, (16, 3)))
    dense = torch.zeros(16, 0)
    model(ids, dense).sum().backward()
    table = model.embedding.table_w16
    assert calls == [table.shape[0]]

    flat = model.embedding.local_ids(0, ids).reshape(-1)
    rows = table.detach()[flat].requires_grad_()
    (ct,) = torch.autograd.grad(
        model(ids, dense, {"table_w16": rows}).sum(), rows)
    want = torch.zeros_like(table).index_add_(0, flat, ct)
    np.testing.assert_allclose(table.grad.numpy(), want.numpy(),
                               rtol=1e-6, atol=1e-7)
