#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (deepfm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

  build      compile every CUDA kernel of the port from csrc/ (nvcc, one
             process per source, all at once) and print the card's name
             and power limit as nvidia-smi reports them;
  cin_stack  hold the CIN-stack kernel against its plain PyTorch version
             on the card at four shapes (the serving config, bench.py's
             xDeepFM shape in f32 and bf16, and a ragged shape the TPU
             kernel's gate refuses), element by element (CIN_TOL), with
             the kernel's, the plain version's and a library yardstick's
             median times (CUDA events) beside the shape's bound; in
             bf16 the check must also refuse two controls, the plain
             version without its hidden-state or outer-product rounding;
  serve      the port's serving path at full width: synthetic MovieLens
             at ML-100K scale, xDeepFM from
             configs/xdeepfm_movielens_cin_tuned.yaml with seeded random
             weights saved as the best checkpoint, the `serve` prologue,
             the HTTP server on an ephemeral port, GET /health, POST
             /score and GET /recommend; the served scores are held against
             the same checkpoint on the CPU, and every kernel's launch
             count must have risen;
  kernels    one line listing every ported kernel with its launch count
             on the serve path and its numbers from the serving shape.

The last line is {"ok": true, "device": {...}}. Without CUDA, or outside a
checkout of the repository, the script fails before printing any result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

REPO = Path(__file__).resolve().parent

# H100 SXM data sheet (dense): FP32 outside the tensor cores, bf16 tensor
# cores, HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# (name, B, F, D, layer_sizes, split_half, dtype)
CIN_SHAPES = [
    ("serving", 4096, 16, 16, (128, 128, 64), True, "float32"),
    ("bench_f32", 16384, 27, 16, (128, 128), True, "float32"),
    ("bench_bf16", 16384, 27, 16, (128, 128), True, "bfloat16"),
    ("ragged", 1000, 13, 16, (10, 7), True, "float32"),
]
# The kernel is held against the plain version element by element,
# |kernel - plain| <= atol + rtol * |plain|, and, in bf16, by its mean
# relative error sum|kernel - plain| / sum|plain| as well.
#   f32: rtol 2e-4 / atol 1e-5, the tolerance of the port's CPU tests: the
#        same f32 sums (up to 1728 terms) taken in another order.
#   bf16: rtol 2^-7, at least one ulp of the bf16 output (an ulp of v is
#        at most 2^-7 |v|): kernel and plain round the same f32 values,
#        which differ in their last f32 bits, so a rounding may land one
#        bf16 step apart, and a hidden value that lands one step apart
#        moves the next layer by far less than one more. atol 1e-3 covers
#        outputs near zero (ReLU cut most of the sum).
#        The mean limit sits between the kernel's reading and those of two
#        controls, the plain version with its hidden-state or its outer-
#        product rounding left out: a kernel that skipped either rounding
#        flips a large share of the outputs by an ulp and is refused. The
#        phase fails if the check does not refuse both controls.
CIN_TOL = {
    "float32": {"rtol": 2e-4, "atol": 1e-5, "mean_rel": None},
    "bfloat16": {"rtol": 2.0 ** -7, "atol": 1e-3, "mean_rel": 3e-5},
}
# Served probabilities against the same checkpoint on the CPU.
SERVE_TOL = 1e-4


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_build() -> str:
    from deepfm_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    logs = build.build()
    seconds = time.perf_counter() - t0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    gpu = smi.stdout.strip().splitlines()[0]
    print(gpu, flush=True)
    ptxas = [
        line.strip() for log in logs.values() for line in log.splitlines()
        if "Used" in line or "spill" in line or "Compiling entry" in line
    ]
    emit({"phase": "build", "seconds": seconds,
          "sources": sorted(logs), "gpu": gpu, "ptxas": ptxas})
    return gpu


def cin_library(x0, weights, biases, layer_sizes, split_half):
    """Yardstick only, never called by the port: the same function as an
    einsum outer product plus torch.matmul per layer, in x0's dtype."""
    import torch

    from deepfm_tpu_torch.ops.cin import cin_layer_sizes

    direct_sizes, _ = cin_layer_sizes(layer_sizes, split_half)
    n = len(layer_sizes)
    bsz, f, d = x0.shape
    hidden, outs = x0, []
    for i in range(n):
        outer = torch.einsum("bhd,bfd->bhfd", hidden, x0).reshape(bsz, -1, d)
        comp = torch.relu(
            torch.matmul(weights[i].to(x0.dtype), outer)
            + biases[i].to(x0.dtype)[:, None]
        )
        if split_half and i < n - 1:
            direct, hidden = comp[:, : direct_sizes[i]], comp[:, direct_sizes[i]:]
        else:
            direct = hidden = comp
        outs.append(direct.float().sum(dim=2))
    return torch.cat(outs, dim=1).to(x0.dtype)


def cin_control(x0, weights, biases, layer_sizes, split_half, skip):
    """The plain bf16 version with one rounding point left out, ``skip`` =
    "hidden" (the hidden state handed on in f32) or "outer" (the outer
    product used unrounded): what a kernel that dropped that rounding
    would return. The bf16 check must refuse it."""
    import torch

    from deepfm_tpu_torch.ops.cin import cin_compress, cin_layer_sizes

    def rnd(t):
        return t.to(torch.bfloat16).float()

    direct_sizes, _ = cin_layer_sizes(layer_sizes, split_half)
    n = len(layer_sizes)
    x = x0.float()
    hidden, outs = x, []
    for i in range(n):
        comp = torch.relu(cin_compress(
            hidden, x, rnd(weights[i].float()), biases[i].float(),
            (lambda t: t) if skip == "outer" else rnd,
        ))
        if split_half and i < n - 1:
            direct, hidden = comp[:, : direct_sizes[i]], comp[:, direct_sizes[i]:]
        else:
            direct = hidden = comp
        if skip != "hidden":
            hidden = rnd(hidden)
        outs.append(direct.sum(dim=2))
    return torch.cat(outs, dim=1).to(x0.dtype)


def compare(got, want, tol) -> dict:
    """Error statistics of ``got`` against ``want`` and whether they pass
    ``tol`` (see CIN_TOL)."""
    import torch

    got, want = got.float(), want.float()
    err = (got - want).abs()
    allowed = tol["atol"] + tol["rtol"] * want.abs()
    stats = {
        "max_abs_err": err.max().item(),
        "max_rel_err": (err / want.abs().clamp_min(1e-3)).max().item(),
        "max_err_over_tol": (err / allowed).max().item(),
        "mean_rel_err": (err.sum() / want.abs().sum().clamp_min(1e-30)).item(),
        "share_differing": (err > 0).float().mean().item(),
    }
    ok = bool(torch.isfinite(got).all()) and stats["max_err_over_tol"] <= 1.0
    if tol["mean_rel"] is not None:
        ok = ok and stats["mean_rel_err"] <= tol["mean_rel"]
    stats["ok"] = ok
    return stats


def cin_bound(bsz, f, d, layer_sizes, split_half, bf16):
    """(bound_ms, bound_by, flops): the larger of the operations over the
    peak rate for the operand type and the bytes (x0, weights, biases and
    output, each once) over the memory rate."""
    from deepfm_tpu_torch.ops.cin import cin_layer_sizes

    direct_sizes, next_sizes = cin_layer_sizes(layer_sizes, split_half)
    es = 2 if bf16 else 4
    flops, nbytes, h = 0, bsz * f * d * es, f
    for i, m in enumerate(layer_sizes):
        flops += 2 * bsz * m * h * f * d + bsz * h * f * d
        nbytes += m * h * f * es + 4 * m
        h = next_sizes[i]
    nbytes += bsz * sum(direct_sizes) * es
    t_ops = flops / (PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    if t_ops >= t_bytes:
        return 1e3 * t_ops, "operations", flops
    return 1e3 * t_bytes, "bytes", flops


def phase_cin_stack() -> dict:
    import torch

    from deepfm_tpu_torch.ops.cin import cin_layer_sizes
    from deepfm_tpu_torch.ops.kernels.cin_stack import (
        cin_stack_forward,
        cin_stack_plain,
        plan_tile,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    results, failures = {}, []
    for k, (name, bsz, f, d, layers, split, dtype) in enumerate(CIN_SHAPES):
        gen = torch.Generator(device=dev).manual_seed(1000 + k)
        dt = getattr(torch, dtype)
        bf16 = dt == torch.bfloat16
        tol = CIN_TOL[dtype]
        x0 = torch.randn(bsz, f, d, generator=gen, device=dev).to(dt)
        _, next_sizes = cin_layer_sizes(layers, split)
        ws, bs, h = [], [], f
        for i, m in enumerate(layers):
            bound = (h * f) ** -0.5
            ws.append((torch.rand(m, h * f, generator=gen, device=dev) * 2 - 1) * bound)
            bs.append((torch.rand(m, generator=gen, device=dev) * 2 - 1) * bound)
            h = next_sizes[i]

        def kernel():
            return cin_stack_forward(x0, ws, bs, layers, split, bf16_operands=True)

        def plain():
            return cin_stack_plain(x0, ws, bs, layers, split, bf16_operands=True)

        def library():
            return cin_library(x0, ws, bs, layers, split)

        got = kernel()
        want = plain()
        stats = compare(got, want, tol)
        if not stats["ok"]:
            failures.append(f"{name}: kernel outside tolerance {tol}: {stats}")
        controls = {}
        if bf16:
            for skip in ("hidden", "outer"):
                ctl = compare(cin_control(x0, ws, bs, layers, split, skip), want, tol)
                controls[f"no_{skip}_round"] = ctl
                if ctl["ok"]:
                    failures.append(
                        f"{name}: the bf16 check passes a kernel without "
                        f"{skip} rounding: {ctl}")
        big = bsz >= 16384
        ms = time_ms(kernel, reps=10 if big else 20)
        plain_ms = time_ms(plain, reps=3 if big else 10, warmup=1)
        library_ms = time_ms(library, reps=3 if big else 10, warmup=1)
        bound_ms, bound_by, flops = cin_bound(bsz, f, d, layers, split, bf16)
        rec = {
            "phase": "cin_stack", "shape": name, "B": bsz, "F": f, "D": d,
            "layers": list(layers), "split_half": split, "dtype": dtype,
            "tile": list(plan_tile(bsz, f, d, layers)[:2]),
            **stats, "tol": tol, "controls": controls,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "gflop": flops / 1e9,
            "tflops": flops / (ms * 1e-3) / 1e12,
            "launches": cin_stack_forward.launches,
        }
        emit(rec)
        results[name] = rec
        del x0, ws, bs, got, want
        torch.cuda.empty_cache()
    if failures:
        fail("; ".join(failures))
    return results


def _http(method: str, url: str, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data, method=method,
        headers={"Content-Type": "application/json"},
    )
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        body = json.loads(r.read())
        status = r.status
    return status, body, 1e3 * (time.perf_counter() - t0)


def request_breakdown(transform, packed, predictor, reps: int = 5) -> dict:
    """Median host-clock ms of the three host/device stages of a request:
    the adapter's feature transform, packing, and the predictor (H2D copy,
    model, D2H fetch; it ends in a host fetch, so the device is done)."""
    t = {"transform": [], "pack": [], "predict": []}
    for _ in range(reps):
        t0 = time.perf_counter()
        ds = transform()
        t1 = time.perf_counter()
        arrays = ds.pack(packed)
        t2 = time.perf_counter()
        predictor.predict(arrays)
        t3 = time.perf_counter()
        t["transform"].append(t1 - t0)
        t["pack"].append(t2 - t1)
        t["predict"].append(t3 - t2)
    out = {k: 1e3 * statistics.median(v) for k, v in t.items()}
    out["rows"] = len(arrays)
    return out


def device_profile(predictor, arrays) -> dict:
    """torch.profiler over one warm predict: device time by kernel and the
    device's busy share of the host wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    predictor.predict(arrays)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        predictor.predict(arrays)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    device_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    return {
        "rows": len(arrays), "wall_ms": wall_us / 1e3,
        "device_ms": device_us / 1e3,
        "device_busy_share": device_us / wall_us if wall_us else None,
        "top_device_ms": {e.key[:60]: e.self_device_time_total / 1e3 for e in top},
    }


def phase_serve(tmp: Path) -> dict:
    import numpy as np
    import torch

    from deepfm_tpu_torch.cli import _build_data, _restore_predictor
    from deepfm_tpu_torch.config import load_config
    from deepfm_tpu_torch.data.synthetic import generate_movielens_like
    from deepfm_tpu_torch.models import create_model
    from deepfm_tpu_torch.ops.kernels.cin_stack import cin_stack_forward
    from deepfm_tpu_torch.serving import ScoringService, make_http_server
    from deepfm_tpu_torch.training.persistence import load_best, save_best
    from deepfm_tpu_torch.training.predict import Predictor

    t0 = time.perf_counter()
    data_dir = generate_movielens_like(
        tmp / "ml-100k", num_users=943, num_items=1682, num_rows=100_000,
        seed=0,
    )
    config = load_config(
        REPO / "configs" / "xdeepfm_movielens_cin_tuned.yaml",
        [f"data.data_dir={data_dir}", f"output_dir={tmp / 'run'}",
         "device=cuda"],
    )
    # seeded random weights stand in for a trained checkpoint
    _, _, packed0, _, _, _ = _build_data(config)
    save_best(create_model(config.model_name, packed0, config, device="cpu"),
              config.output_dir)
    setup_s = time.perf_counter() - t0

    # --- the main path: every kernel count starts at 0 here -------------
    cin_stack_forward.launches = 0
    t0 = time.perf_counter()
    adapter, packed, _, _, model, predictor = _restore_predictor(
        config, require=("serve", "score_id_pairs", "known_pair",
                         "now_timestamp", "recommend_candidates"),
    )
    service = ScoringService(adapter, packed, predictor, config.model_name)
    service.warmup()
    prologue_s = time.perf_counter() - t0
    server = make_http_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = "http://%s:%d" % server.server_address
        raw = np.loadtxt(data_dir / "u.data", dtype=np.int64)
        pick = np.random.default_rng(0).choice(len(raw), 300, replace=False)
        rows = [[int(u), int(m)] for u, m in raw[pick, :2]]
        rows.append([10**9, rows[0][1]])  # unknown user -> null
        user = rows[0][0]
        st_h, health, health_ms = _http("GET", f"{base}/health")
        st_s, scored, score_ms = _http("POST", f"{base}/score", {"rows": rows})
        st_r, rec, rec_ms = _http("GET", f"{base}/recommend?user={user}&k=10")
        torch.cuda.synchronize()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    launches = {"cin_stack_fwd": cin_stack_forward.launches}
    # --- end of the main path --------------------------------------------

    failures = []
    if (st_h, st_s, st_r) != (200, 200, 200):
        failures.append(f"HTTP status {st_h}/{st_s}/{st_r}")
    if health.get("status") != "ok" or health.get("n_params") != predictor.n_params:
        failures.append(f"/health answered {health}")
    scores = scored["scores"]
    if scores[-1] is not None or scored["n_scored"] != len(rows) - 1:
        failures.append("unknown id was scored, or a known one was not")
    served = np.asarray(scores[:-1], np.float64)
    if not (np.isfinite(served).all() and (served >= 0).all() and (served <= 1).all()):
        failures.append("served scores are not finite probabilities")
    items = rec["items"]
    rec_scores = [it["score"] for it in items]
    if len(items) != 10 or rec_scores != sorted(rec_scores, reverse=True):
        failures.append(f"/recommend answered {rec}")

    # reference: the same checkpoint on the CPU, where the plain version runs
    cpu_model = create_model(config.model_name, packed, config, device="cpu")
    load_best(cpu_model, config.output_dir)
    cpu = Predictor(cpu_model, packed, config, device="cpu")
    users = np.asarray([r[0] for r in rows[:-1]])
    ds, kept = adapter.score_id_pairs(users, np.asarray([r[1] for r in rows[:-1]]))
    want = cpu.predict(ds.pack(packed))
    score_err = float(np.abs(served[kept] - want).max())
    cds, cand = adapter.recommend_candidates(user)
    cwant = dict(zip(cand.tolist(), cpu.predict(cds.pack(packed)).tolist()))
    rec_err = max(abs(it["score"] - cwant[it["item"]]) for it in items)
    breakdown = {
        "score": request_breakdown(
            lambda: adapter.score_id_pairs(users, np.asarray([r[1] for r in rows[:-1]]))[0],
            packed, predictor),
        "recommend": request_breakdown(
            lambda: adapter.recommend_candidates(user)[0], packed, predictor),
    }
    profile = device_profile(predictor, cds.pack(packed))
    if max(score_err, rec_err) > SERVE_TOL:
        failures.append(f"served scores differ from the CPU by {score_err}/{rec_err}")
    if launches["cin_stack_fwd"] < 1:
        failures.append("the CIN-stack kernel was not launched on the serve path")
    out = {
        "phase": "serve", "model": config.model_name,
        "config": "configs/xdeepfm_movielens_cin_tuned.yaml",
        "users": 943, "items": 1682, "rows": 100_000,
        "n_params": health.get("n_params"), "score_rows": len(rows),
        "setup_s": setup_s, "prologue_s": prologue_s,
        "health_ms": health_ms, "score_ms": score_ms, "recommend_ms": rec_ms,
        "candidates": len(cand), "max_abs_err_score": score_err,
        "max_abs_err_recommend": rec_err, "tol": SERVE_TOL,
        "breakdown_ms": breakdown, "profile_recommend_predict": profile,
        "launches": launches, "ok": not failures,
    }
    emit(out)
    if failures:
        fail("; ".join(failures))
    return out


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a GPU")
    if not (REPO / "deepfm_tpu_torch" / "__init__.py").is_file():
        fail(f"no deepfm_tpu_torch package beside {Path(__file__).name}: "
             "run it from a checkout of the repository")
    sys.path.insert(0, str(REPO))

    phase_build()
    cin = phase_cin_stack()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        serve = phase_serve(Path(tmp))
    a = cin["serving"]
    emit({"kernels": [{
        "name": "cin_stack_fwd",
        "route": "cuda",
        "source": "deepfm_tpu_torch/csrc/cin_stack_fwd.cu",
        "replaces": "deepfm_tpu/ops/pallas/cin_stack_kernel.py:646",
        "launches": serve["launches"]["cin_stack_fwd"],
        "max_abs_err": a["max_abs_err"],
        "ms": a["ms"],
        "plain_ms": a["plain_ms"],
        "bound_ms": a["bound_ms"],
        "bound_by": a["bound_by"],
        "library_ms": a["library_ms"],
    }]})
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})


if __name__ == "__main__":
    main()
