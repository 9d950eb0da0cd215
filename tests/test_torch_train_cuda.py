"""The table-update kernels and the train step on the card, against the
port's own plain versions on the same inputs. Every test needs an NVIDIA
GPU and skips without one; the file imports no JAX, so it runs on a GPU
machine without it:

    python -m pytest --noconftest tests/test_torch_train_cuda.py -m cuda

Tolerances (the kernels round every f32 operation as PyTorch's separate
elementwise ops do, csrc/table_update.cuh):

  * densify, logical and packed, and the row gather: bit for bit (both add
    each run in stream order; a gather copies); a packed result's dead
    lanes are 0;
  * sparse / fused table Adam: mu and nu bit for bit, p within 1e-6
    relative (the same roundings; a square root may differ in its last
    bit), psq and the segment sums rel 1e-5 (another summation order);
    fused table Adam on ragged tables whose tensors are views one element
    off their allocation (its scalar head and tail): p, mu and nu bit for
    bit;
  * packed sparse table Adam against the logical kernel on the unpacked
    state: p, mu and nu bit for bit (the same run sums and arithmetic),
    also on runs longer than a staged window of pairs and on tables one or
    three elements off their allocation;
  * sparse table Adam and the segment sums on the widest logical rows the
    table kernel takes (511 and 4096 columns): the same rules;
  * every kernel gives the same bits on a second launch;
  * the train step on the card against the CPU step: the rule of
    ``deepfm_tpu_torch/training/parity.py`` (rtol 1e-5 / atol 1e-7 on all
    but 0.1 % of a leaf, within 2 * lr per step everywhere; BN-fed biases
    and their running means by their band), with TF32 off.
"""

import numpy as np
import pytest
import torch

from deepfm_tpu_torch.config import config_from_dict
from deepfm_tpu_torch.data.packing import pack_features, pack_schema
from deepfm_tpu_torch.data.schema import DatasetSchema, FeatureType, FieldSchema
from deepfm_tpu_torch.models import create_model
from deepfm_tpu_torch.ops.kernels import build
from deepfm_tpu_torch.ops.kernels.adam import (
    fused_table_adam,
    fused_table_adam_plain,
)
from deepfm_tpu_torch.ops.kernels.gather import row_gather, row_gather_plain
from deepfm_tpu_torch.ops.kernels.grad import (
    densify_rows_grad,
    densify_rows_grad_plain,
    sort_pairs,
)
from deepfm_tpu_torch.ops.kernels.packed_grad import (
    densify_rows_grad_packed,
    densify_rows_grad_packed_plain,
)
from deepfm_tpu_torch.ops.kernels.sparse_adam import (
    segment_sumsq,
    segment_sumsq_plain,
    sparse_table_adam,
    sparse_table_adam_plain,
)
from deepfm_tpu_torch.training.parity import compare_leaves
from deepfm_tpu_torch.training.trainer import Trainer
from deepfm_tpu_torch.utils.layout import pack_table, unpack_table

torch.set_num_threads(1)

D = 17
LR, WD = 1e-3, 2e-5
B = 64
HIDDEN = [16, 8]
PATHS = {
    "plain": {"fused_table_adam": False},
    "two_pass": {"fused_backward": False},
    "sparse_fused": {},
}


def _cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU launch")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _table(rows, seed):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(rows, D)).astype(np.float32) * 0.05
    mu = rng.normal(size=(rows, D)).astype(np.float32) * 0.01
    nu = (rng.normal(size=(rows, D)).astype(np.float32) * 0.01) ** 2
    return p, mu, nu


@pytest.mark.cuda
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_table_kernels_match_plain_on_cuda(moments):
    dev = _cuda()
    mdt = getattr(torch, moments)
    # ragged tiles, one run across everything, all but unique ids
    for rows, n, vocab in [(1000, 3000, 1000), (300, 4096, 1),
                           (257, 37, 10), (5000, 2000, 5000)]:
        rng = np.random.default_rng(rows)
        ids = torch.from_numpy(rng.integers(0, vocab, n).astype(np.int32))
        ct = torch.from_numpy(rng.normal(size=(n, D)).astype(np.float32))
        ids, ct = ids.to(dev), ct.to(dev)
        p, mu, nu = _table(rows, rows)
        sids, cts = sort_pairs(ids, ct)

        g = densify_rows_grad(ct, ids, rows)
        assert torch.equal(g, densify_rows_grad_plain(ct, ids, rows))
        assert torch.equal(g, densify_rows_grad(ct, ids, rows))
        ssq = segment_sumsq(sids, cts)
        assert float(ssq) == pytest.approx(
            float(segment_sumsq_plain(sids, cts)), rel=1e-5)
        assert torch.equal(ssq, segment_sumsq(sids, cts))

        def fresh():
            return [torch.from_numpy(p.copy()).to(dev),
                    torch.from_numpy(mu.copy()).to(dev, mdt),
                    torch.from_numpy(nu.copy()).to(dev, mdt)]

        for clip in (0.0, 1.0):
            args = (LR, WD, torch.tensor(3.0, device=dev), clip,
                    torch.tensor(2, dtype=torch.int32, device=dev))
            k, q, k2 = fresh(), fresh(), fresh()
            *_, kpsq = sparse_table_adam(*k, sids, cts, *args)
            *_, qpsq = sparse_table_adam_plain(*q, sids, cts, *args)
            *_, kpsq2 = sparse_table_adam(*k2, sids, cts, *args)
            assert torch.equal(k[1], q[1]) and torch.equal(k[2], q[2])
            torch.testing.assert_close(k[0], q[0], rtol=1e-6, atol=0)
            assert float(kpsq) == pytest.approx(float(qpsq), rel=1e-5)
            assert all(torch.equal(a, b) for a, b in zip(k, k2))
            assert torch.equal(kpsq, kpsq2)
            k, q = fresh(), fresh()
            fused_table_adam(*k, g, *args)
            fused_table_adam_plain(*q, g, *args)
            assert torch.equal(k[1], q[1]) and torch.equal(k[2], q[2])
            torch.testing.assert_close(k[0], q[0], rtol=1e-6, atol=0)
    # fused table Adam on ragged, misaligned tables: 1003 * D = 8k + 3 and
    # 5 * D = 8k + 5 elements, each tensor a view `off` elements past its
    # allocation (its scalar head and tail); p, mu and nu bit for bit
    def shifted(t, off):
        flat = torch.empty(t.numel() + off, dtype=t.dtype, device=dev)
        view = flat[off:].view(t.shape)
        view.copy_(t)
        return view

    for rows in (1003, 5):
        p, mu, nu = _table(rows, rows)
        g = torch.from_numpy(np.random.default_rng(rows).normal(
            size=(rows, D)).astype(np.float32)).to(dev)
        state = [torch.from_numpy(p).to(dev), torch.from_numpy(mu).to(dev, mdt),
                 torch.from_numpy(nu).to(dev, mdt)]
        for off in (1, 3):
            for clip in (0.0, 1.0):
                args = (LR, WD, torch.tensor(3.0, device=dev), clip,
                        torch.tensor(2, dtype=torch.int32, device=dev))
                k = [shifted(t, off) for t in state]
                q = [t.clone() for t in state]
                fused_table_adam(*k, shifted(g, off), *args)
                fused_table_adam_plain(*q, g, *args)
                assert all(torch.equal(a, b) for a, b in zip(k, q)), (rows, off)
    # the densify kernel's edges (ids drawn in [lo, hi)): no pairs, no
    # rows, every id out of range, rows not a multiple of 4 or of a tile,
    # D of 1, 5, 17 and 33, runs longer than a chunk of staged pairs
    for rows, n, d, lo, hi in [
        (1000, 0, 17, 0, 1), (0, 50, 17, 0, 5), (999, 500, 17, 999, 5000),
        (999, 500, 5, -50, 0), (10_001, 3000, 1, 0, 10_001),
        (4_003, 3000, 5, 0, 4_003), (2_999, 3000, 33, 0, 2_999),
        (5, 5000, 17, 0, 2), (3, 5000, 1, 0, 3),
    ]:
        rng = np.random.default_rng(rows + n + d)
        ids = torch.from_numpy(rng.integers(lo, hi, n).astype(np.int32))
        ct = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
        ids, ct = ids.to(dev), ct.to(dev)
        g = densify_rows_grad(ct, ids, rows)
        assert g.shape == (rows, d)
        assert torch.equal(g, densify_rows_grad_plain(ct, ids, rows))
        assert torch.equal(g, densify_rows_grad(ct, ids, rows))
    torch.cuda.synchronize()


def _at(t, off):
    """A copy of ``t`` as a view ``off`` elements past its allocation."""
    flat = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    view = flat[off:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("pack", [1, 7])
def test_sparse_table_adam_long_runs_and_offsets_on_cuda(moments, pack):
    """Sparse table Adam, logical (pack 1) and packed (pack 7), on runs
    longer than a staged window of pairs (carried from window to window;
    one in the table's last tile) and on tables whose p and moments lie 0, 1 or
    3 elements past their allocation (each tile's scalar head and tail;
    with p and the moments off by different amounts, no common 16-byte
    boundary: every element scalar): mu and nu bit for bit against the
    plain version, p within 1e-6, psq rel 1e-5, the same bits twice, and
    packed equal to the logical kernel on the unpacked state."""
    from deepfm_tpu_torch.ops.kernels.sparse_adam import (
        CHUNK,
        SCAN,
        window_pairs,
    )

    dev = _cuda()
    mdt = getattr(torch, moments)
    rng = np.random.default_rng(pack)
    phys = -(-7000 // pack)
    rows = phys * pack  # logical rows
    n = 20_000
    ids = rng.integers(0, rows, n).astype(np.int32)
    ids[:5000] = 0
    ids[5000:5001 + CHUNK] = 1234  # segment_sumsq: a run past its chunk
    ids[6000:6000 + CHUNK + SCAN + 1] = 4321  # a long run (past SCAN)
    ids[7000:8000] = rows - 1
    ids[9000:9001 + window_pairs(D)] = 2345  # one pair more than a window
    ct = rng.normal(size=(n, D)).astype(np.float32)
    sids, cts = sort_pairs(torch.from_numpy(ids).to(dev),
                           torch.from_numpy(ct).to(dev))
    p, mu, nu = (np.resize(a, (rows, D)) for a in _table(rows // 3, 5))

    def fresh(p_off=0, m_off=0, logical=False):
        ts = [torch.from_numpy(a.copy()) for a in (p, mu, nu)]
        if pack > 1 and not logical:
            ts = [pack_table(t, D, pack, phys) for t in ts]
        ts = [ts[0].to(dev)] + [t.to(dev, mdt) for t in ts[1:]]
        return [_at(ts[0], p_off)] + [_at(t, m_off) for t in ts[1:]]

    for p_off, m_off in ((0, 0), (1, 1), (3, 3), (1, 0)):
        for clip in (0.0, 1.0):
            args = (LR, WD, torch.tensor(3.0, device=dev), clip,
                    torch.tensor(2, dtype=torch.int32, device=dev))
            what = (p_off, m_off, clip)
            k, k2 = fresh(p_off, m_off), fresh(p_off, m_off)
            q = fresh()
            *_, kpsq = sparse_table_adam(*k, sids, cts, *args, pack=pack)
            *_, kpsq2 = sparse_table_adam(*k2, sids, cts, *args, pack=pack)
            *_, qpsq = sparse_table_adam_plain(*q, sids, cts, *args,
                                               pack=pack)
            assert torch.equal(k[1], q[1]) and torch.equal(k[2], q[2]), what
            torch.testing.assert_close(k[0], q[0], rtol=1e-6, atol=0)
            assert float(kpsq) == pytest.approx(float(qpsq), rel=1e-5), what
            assert all(torch.equal(a, b) for a, b in zip(k, k2)), what
            assert torch.equal(kpsq, kpsq2), what
            if pack > 1:
                lg = fresh(p_off, m_off, logical=True)
                sparse_table_adam(*lg, sids, cts, *args)
                for a, b in zip(k, lg):
                    assert torch.equal(unpack_table(a, D, pack, rows), b), what
    ssq = segment_sumsq(sids, cts)
    assert float(ssq) == pytest.approx(
        float(segment_sumsq_plain(sids, cts)), rel=1e-5)
    assert torch.equal(ssq, segment_sumsq(sids, cts))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dcol", [511, 4096])
def test_sparse_kernels_take_wide_rows_on_cuda(dcol):
    """The widest logical rows sparse table Adam takes, 511 columns (a tile
    of 8 rows, 9 pairs a window) and 4096 (a tile of one row, one pair a
    window; segment_sumsq sums its columns in 16 passes), with a run
    longer than a window (and, for segment_sumsq, long): mu and nu
    bit for bit against the plain version, p within 1e-6, psq and the
    segment sums rel 1e-5, the same bits twice."""
    dev = _cuda()
    rng = np.random.default_rng(dcol)
    rows, n = 50, 400
    ids = rng.integers(0, rows, n).astype(np.int32)
    ids[:100] = 7
    ct = rng.normal(size=(n, dcol)).astype(np.float32)
    sids, cts = sort_pairs(torch.from_numpy(ids).to(dev),
                           torch.from_numpy(ct).to(dev))
    p = rng.normal(size=(rows, dcol)).astype(np.float32) * 0.05
    mu = rng.normal(size=(rows, dcol)).astype(np.float32) * 0.01
    nu = (rng.normal(size=(rows, dcol)).astype(np.float32) * 0.01) ** 2
    args = (LR, WD, torch.tensor(3.0, device=dev), 1.0,
            torch.tensor(2, dtype=torch.int32, device=dev))
    for mdt in (torch.float32, torch.bfloat16):
        def fresh():
            return [torch.from_numpy(p.copy()).to(dev)] + [
                torch.from_numpy(a.copy()).to(dev, mdt) for a in (mu, nu)]

        k, k2, q = fresh(), fresh(), fresh()
        *_, kpsq = sparse_table_adam(*k, sids, cts, *args)
        *_, kpsq2 = sparse_table_adam(*k2, sids, cts, *args)
        *_, qpsq = sparse_table_adam_plain(*q, sids, cts, *args)
        assert torch.equal(k[1], q[1]) and torch.equal(k[2], q[2]), mdt
        torch.testing.assert_close(k[0], q[0], rtol=1e-6, atol=0)
        assert float(kpsq) == pytest.approx(float(qpsq), rel=1e-5)
        assert all(torch.equal(a, b) for a, b in zip(k, k2))
        assert torch.equal(kpsq, kpsq2)
    ssq = segment_sumsq(sids, cts)
    assert float(ssq) == pytest.approx(
        float(segment_sumsq_plain(sids, cts)), rel=1e-5)
    assert torch.equal(ssq, segment_sumsq(sids, cts))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dcol,pack", [(17, 7), (9, 14), (5, 25), (128, 1),
                                       (1, 128)])
def test_packed_kernels_match_plain_on_cuda(dcol, pack):
    dev = _cuda()
    rng = np.random.default_rng(dcol)
    num_rows, n = 6000, 4000
    ids = rng.integers(0, num_rows, n).astype(np.int32)
    ids[:300] = 0  # a long run
    ids[300:340] = 777  # runs on both sides of a physical-row boundary
    ids[340:380] = 777 + pack - 777 % pack
    ids = torch.from_numpy(ids).to(dev)
    ct = torch.from_numpy(rng.normal(size=(n, dcol)).astype(np.float32)).to(dev)
    g = densify_rows_grad_packed(ct, ids, num_rows, pack)
    assert torch.equal(g, densify_rows_grad_packed_plain(ct, ids, num_rows, pack))
    assert torch.equal(g, densify_rows_grad_packed(ct, ids, num_rows, pack))
    assert not g[:, pack * dcol:].any()
    # the packed densify's edges (ids drawn in [lo, hi)): no pairs, every
    # id out of range, a table ending inside a physical row and a tile,
    # runs longer than a chunk of staged pairs
    for rows, m, lo, hi in [(1001, 0, 0, 1), (1001, 300, 1001, 5000),
                            (1001, 300, -9, 0), (4_099, 5000, 0, 3)]:
        eids = torch.from_numpy(rng.integers(lo, hi, m).astype(np.int32))
        ect = torch.from_numpy(rng.normal(size=(m, dcol)).astype(np.float32))
        eids, ect = eids.to(dev), ect.to(dev)
        eg = densify_rows_grad_packed(ect, eids, rows, pack)
        assert eg.shape == (-(-rows // pack), 128)
        assert torch.equal(
            eg, densify_rows_grad_packed_plain(ect, eids, rows, pack))
        assert torch.equal(eg, densify_rows_grad_packed(ect, eids, rows, pack))

    phys = -(-num_rows // pack)
    rows = phys * pack
    sids, cts = sort_pairs(ids, ct)
    p, mu, nu = (np.resize(a, (rows, dcol)) for a in _table(rows // 4, 1))
    for mdt in (torch.float32, torch.bfloat16):
        def fresh(logical=False):
            ts = [torch.from_numpy(a.copy()) for a in (p, mu, nu)]
            if not logical:
                ts = [pack_table(t, dcol, pack, phys) for t in ts]
            return [ts[0].to(dev)] + [t.to(dev, mdt) for t in ts[1:]]

        for clip in (0.0, 1.0):
            args = (LR, WD, torch.tensor(3.0, device=dev), clip,
                    torch.tensor(2, dtype=torch.int32, device=dev))
            k, q, k2, lg = fresh(), fresh(), fresh(), fresh(logical=True)
            *_, kpsq = sparse_table_adam(*k, sids, cts, *args, pack=pack)
            *_, qpsq = sparse_table_adam_plain(*q, sids, cts, *args, pack=pack)
            *_, kpsq2 = sparse_table_adam(*k2, sids, cts, *args, pack=pack)
            *_, lpsq = sparse_table_adam(*lg, sids, cts, *args)
            assert torch.equal(k[1], q[1]) and torch.equal(k[2], q[2])
            torch.testing.assert_close(k[0], q[0], rtol=1e-6, atol=0)
            assert float(kpsq) == pytest.approx(float(qpsq), rel=1e-5)
            assert all(torch.equal(a, b) for a, b in zip(k, k2))
            assert torch.equal(kpsq, kpsq2)
            for a, b in zip(k, lg):
                assert torch.equal(unpack_table(a, dcol, pack, rows), b)
                assert not a[:, pack * dcol:].float().any()
            assert float(kpsq) == pytest.approx(float(lpsq), rel=1e-6)

    table = torch.from_numpy(p).to(dev)
    gids = torch.cat([ids.long(), torch.tensor([-1, rows, 5], device=dev)])
    got = row_gather(table, gids)
    assert torch.equal(got, row_gather_plain(table, gids))
    assert not got[-3:-1].any()
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("cols", [1, 17, 128])
def test_row_gather_edges_on_cuda(cols):
    """The row gather bit for bit against its plain version and on a second
    launch: no ids, every id outside the table, row counts that end inside
    a warp's 32 rows and inside a 16-byte store, ids at both ends."""
    dev = _cuda()
    rng = np.random.default_rng(cols)
    rows = 1000
    table = torch.from_numpy(
        rng.normal(size=(rows, cols)).astype(np.float32)).to(dev)
    for ids in (np.zeros(0, np.int64), rng.integers(rows, 3 * rows, 77),
                rng.integers(-50, 0, 33), rng.integers(0, rows, 1),
                rng.integers(-3, rows + 3, 4_099),
                np.array([0, rows - 1, rows, -1, 5] * 7)):
        gids = torch.from_numpy(ids).to(dev)
        got = row_gather(table, gids)
        assert got.shape == (len(ids), cols)
        assert torch.equal(got, row_gather_plain(table, gids))
        assert torch.equal(got, row_gather(table, gids))
        assert torch.equal(got, row_gather(table, gids.int()))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_wrapper_raises_without_its_kernel(tmp_path, monkeypatch):
    """On the card a wrapper whose kernel cannot be built raises; it does
    not fall back to the plain version."""
    dev = _cuda()

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "nvcc_path", no_nvcc)
    monkeypatch.setattr(build, "_libs", {})
    ct = torch.ones(4, D, device=dev)
    ids = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="nvcc"):
        densify_rows_grad(ct, ids, 8)


def _schema():
    fields = {
        "user": FieldSchema("user", FeatureType.SPARSE, 50, 16, "g"),
        "item": FieldSchema("item", FeatureType.SPARSE, 80, 16, "g"),
        "tags": FieldSchema("tags", FeatureType.SEQUENCE, 12, 8, "g",
                            max_length=4, combiner="mean"),
        "price": FieldSchema("price", FeatureType.DENSE, 0, 8, "g"),
    }
    return pack_schema(DatasetSchema(fields=fields))


def _batch(packed):
    rng = np.random.default_rng(3)
    feats = {"user": rng.integers(0, 50, B), "item": rng.integers(0, 80, B),
             "tags": rng.integers(0, 12, (B, 4)),
             "price": rng.normal(size=B).astype(np.float32)}
    labels = rng.integers(0, 2, B).astype(np.float32)
    return pack_features(packed, feats, labels)


@pytest.mark.cuda
@pytest.mark.parametrize("path", sorted(PATHS))
def test_card_step_matches_cpu_step(path):
    _card_step_matches_cpu_step(path, {})


@pytest.mark.cuda
@pytest.mark.parametrize("path", sorted(PATHS))
def test_packed_card_step_matches_cpu_step(path):
    _card_step_matches_cpu_step(path, {"table_layout": "packed"})


@pytest.mark.cuda
def test_embedding_kernel_card_step_matches_cpu_step():
    _card_step_matches_cpu_step("two_pass", {"use_embedding_kernel": True},
                                training={})


def _card_step_matches_cpu_step(path, pallas, training=None):
    _cuda()
    packed = _schema()
    arr = _batch(packed)
    trainers = {}
    for device in ("cpu", "cuda"):
        config = config_from_dict({
            "model_name": "deepfm", "device": device,
            "dnn": {"hidden_units": HIDDEN, "dropout": 0.0},
            "training": {"batch_size": B, "lr": LR,
                         **(PATHS[path] if training is None else training)},
            "pallas": pallas,
        })
        model = create_model("deepfm", packed, config, device="cpu", seed=1)
        trainers[device] = Trainer(model, packed, config)
        assert trainers[device].path == path
    w = np.ones(B, np.float32)
    for _ in range(2):
        want, got = (float(t._train_step(arr.ids, arr.dense, arr.labels, w))
                     for t in (trainers["cpu"], trainers["cuda"]))
        assert got == pytest.approx(want, rel=1e-6)
    failed = compare_leaves(trainers["cuda"].model.state_dict(),
                            trainers["cpu"].model.state_dict(), LR,
                            steps=2)["failed_leaves"]
    assert not failed, failed
