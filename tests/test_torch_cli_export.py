"""The port's ``export`` command on the CPU (cf. the JAX CLI's,
tests/test_export.py).

A tiny MovieLens-format run (the port's ``synth-data``; xDeepFM of
``configs/xdeepfm_movielens_cin_tuned.yaml`` at small widths, trained one
epoch on packed tables, so the export restores a packed checkpoint into
the logical serving model) is exported by the command, which verifies the
round trip itself (1e-4, or 0.05 with ``--quantize int8``). Held:

  * f32, ``--quantize int8`` (no f32 table, its val AUC delta logged) and a
    pinned ``--batch-size`` larger than the val split (padded with id-0
    rows) each write a verified artifact;
  * the int8 artifact scores the val split within rtol 2e-4 / atol 1e-5
    of the restored f32 model with its tables replaced by the dequantized
    int8 rows ``q * scale`` (the function it serves, by the f32 route);
  * a process that imports no module of ``deepfm_tpu_torch`` loads the
    artifacts with ``torch.export.load`` and scores the val split as
    ``load_scoring`` does, and the f32 scores are the in-process CPU
    predict's within 1e-4;
  * ``--platforms`` takes one platform: ``tpu`` and ``cpu,cuda`` are
    refused, and so is ``cuda`` without a CUDA device (moving the program
    needs one), as is the default platform of ``device: auto`` there;
    ``--quantize`` takes only ``int8``.
"""

import contextlib
import logging
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from deepfm_tpu_torch.cli import _restore_predictor, export_command, main
from deepfm_tpu_torch.config import load_config
from deepfm_tpu_torch.utils.export import (
    input_shapes,
    load_scoring,
    quantize_embedding_tables,
    serving_config,
)

torch.set_num_threads(1)

CONFIG = "configs/xdeepfm_movielens_cin_tuned.yaml"
PINNED = 65536


@contextlib.contextmanager
def _messages_of(name):
    """The INFO and higher messages logged to ``name`` meanwhile."""
    messages = []
    handler = logging.Handler(logging.INFO)
    handler.emit = lambda record: messages.append(record.getMessage())
    logger = logging.getLogger(name)
    logger.addHandler(handler)
    try:
        yield messages
    finally:
        logger.removeHandler(handler)


def _overrides(root, device="cpu"):
    return [
        f"data.data_dir={root / 'data'}", "data.num_neg_train=1",
        "data.num_neg_eval=5", "feature.fm_embed_dim=8",
        "cin.layer_sizes=[8,8]", "dnn.hidden_units=[16,8]",
        "training.batch_size=512", "training.num_epochs=1",
        "pallas.table_layout=packed", f"device={device}",
        f"output_dir={root / 'run'}",
    ]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli_export")
    main(["synth-data", "--dir", str(root / "data"), "--users", "60",
          "--items", "80", "--rows", "2500", "--seed", "3"])
    main(["train", "--config", CONFIG, "--override", *_overrides(root)])
    config = load_config(CONFIG, _overrides(root))
    out = {}
    for kind, kwargs in (("f32", {}), ("int8", {"quantize": "int8"}),
                         ("pinned", {"batch_size": PINNED})):
        path = root / f"{kind}.pt2"
        with _messages_of("deepfm_tpu_torch") as messages:
            result = export_command(config, str(path), None,
                                    kwargs.get("batch_size"),
                                    kwargs.get("quantize"))
        out[kind] = {"path": path, "result": result, "log": messages}
    return root, config, out


def test_export_writes_a_verified_artifact(run):
    _, config, out = run
    f32 = out["f32"]
    assert f32["result"]["bytes"] == f32["path"].stat().st_size > 0
    assert f32["result"]["platform"] == "cpu"
    assert f32["result"]["max_abs_err"] <= 1e-4
    assert any(m.startswith("Exported xdeepfm") for m in f32["log"])
    assert any(m.startswith("Round-trip verification on 256 rows")
               for m in f32["log"])
    shapes = f32["result"]["inputs"]
    assert not shapes[0][0].isdigit() and shapes[0][0] == shapes[1][0]


def test_export_quantized(run):
    _, _, out = run
    q = out["int8"]
    # (at these vocabularies the tables do not dominate the artifact's
    # size: tests/test_torch_export.py holds the size at larger ones)
    program = load_scoring(q["path"]).program
    assert not [n for n in {**program.state_dict, **program.constants}
                if "table_w" in n]
    assert q["result"]["max_abs_err"] <= 0.05
    assert abs(q["result"]["auc_delta"]) < 0.05
    assert any(m.startswith("Quantized val AUC") for m in q["log"])


def test_export_quantized_scores_as_the_dequantized_tables(run):
    _, config, out = run
    _, _, val_d, _, model, *_ = _restore_predictor(serving_config(config))
    state = model.state_dict()
    for dcol, (q, scale) in quantize_embedding_tables(model).items():
        state[f"embedding.table_w{dcol - 1}"] = torch.from_numpy(
            q.astype(np.float32) * scale[:, None])
    model.load_state_dict(state)
    model.eval()
    with torch.no_grad():
        want = model.predict(torch.from_numpy(val_d.ids),
                             torch.from_numpy(val_d.dense))[:, 0].numpy()
    got = load_scoring(out["int8"]["path"])(val_d.ids, val_d.dense)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


def test_export_static_batch_exceeding_val(run):
    root, config, out = run
    pinned = out["pinned"]
    assert pinned["result"]["inputs"][0][0] == str(PINNED)
    _, _, val_d, *_ = _restore_predictor(serving_config(config))
    assert len(val_d) < PINNED
    assert any(m.startswith(f"Round-trip verification on {len(val_d)} rows")
               for m in pinned["log"])
    assert pinned["result"]["max_abs_err"] <= 1e-4


LOADER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch

    ids = torch.from_numpy(np.load(sys.argv[1]))
    dense = torch.from_numpy(np.load(sys.argv[2]))
    for path in sys.argv[3:]:
        score = torch.export.load(path).module()
        np.save(path + ".npy", score(ids, dense).detach().numpy())
    assert not [m for m in sys.modules if m.startswith("deepfm_tpu")]
""")


def test_artifacts_load_without_the_package(run, tmp_path):
    _, config, out = run
    _, _, val_d, _, _, predictor, _ = _restore_predictor(
        serving_config(config))
    np.save(tmp_path / "ids.npy", val_d.ids)
    np.save(tmp_path / "dense.npy", val_d.dense)
    paths = [str(out[k]["path"]) for k in ("f32", "int8")]
    proc = subprocess.run(
        [sys.executable, "-c", LOADER, str(tmp_path / "ids.npy"),
         str(tmp_path / "dense.npy"), *paths],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    for path in paths:
        np.testing.assert_array_equal(
            np.load(path + ".npy"), load_scoring(path)(val_d.ids, val_d.dense))
    np.testing.assert_allclose(np.load(paths[0] + ".npy"),
                               predictor.predict(val_d), rtol=0, atol=1e-4)


@pytest.mark.parametrize("platforms", ["tpu", "cpu,cuda", "cuda, cpu", ""])
def test_export_refuses_other_platforms(run, platforms):
    root, _, _ = run
    with pytest.raises(SystemExit, match="one of cpu, cuda"):
        main(["export", "--config", CONFIG, "--override", *_overrides(root),
              "--output", str(root / "refused.pt2"), "--platforms",
              platforms])
    assert not (root / "refused.pt2").exists()


@pytest.mark.parametrize("device,platforms", [("cpu", "cuda"),
                                              ("auto", None)])
def test_export_cuda_needs_a_card(run, device, platforms):
    root, _, _ = run
    args = ["export", "--config", CONFIG, "--override",
            *_overrides(root, device), "--output", str(root / "cuda.pt2")]
    if platforms:
        args += ["--platforms", platforms]
    if torch.cuda.is_available():  # on a card: written and verified
        main(args)
        assert (root / "cuda.pt2").stat().st_size > 0
        return
    with pytest.raises(SystemExit, match="move_to_device_pass"):
        main(args)
    assert not (root / "cuda.pt2").exists()


def test_export_refuses_other_quantizations(run):
    root, config, _ = run
    with pytest.raises(SystemExit):
        main(["export", "--config", CONFIG, "--override", *_overrides(root),
              "--output", str(root / "q4.pt2"), "--quantize", "int4"])
    with pytest.raises(SystemExit, match="supports 'int8'"):
        export_command(config, str(root / "q4.pt2"), None, None, "int4")
    assert not (root / "q4.pt2").exists()


def test_input_shapes_of_the_loaded_program(run):
    _, _, out = run
    program = load_scoring(out["pinned"]["path"]).program
    assert [s[0] for s in input_shapes(program)] == [str(PINNED)] * 2
