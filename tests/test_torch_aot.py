"""PyTorch port, the serving export (convert/aot.py, tools/convert.py
--export-aot, tools/speed.py --aot) on the CPU: the port's form of each
check of tests/test_aot.py. The program's class maps are held equal, bit
for bit, to the pipeline run directly and to the eager class-map path
(engine.make_inference_classmap, folded bf16) on the same weights."""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pidnet_tpu_torch import engine
from pidnet_tpu_torch.convert import weights as W
from pidnet_tpu_torch.convert.aot import export_serving, load_serving, make_serving_fn
from pidnet_tpu_torch.convert.fold import fold_state_dict
from pidnet_tpu_torch.models import ddrnet
from pidnet_tpu_torch.models import pidnet as M
from pidnet_tpu_torch.ops import upsample_argmax as ua
from pidnet_tpu_torch.tools import convert, speed
from pidnet_tpu_torch.train import checkpoint as ckpt

torch.set_num_threads(2)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
WEIGHTS = os.path.join(REPO, "runs", "train2k", "weights_f16.npz")


@pytest.fixture(scope="module")
def net():
    """PIDNet-S single-head spec and the train2k weights."""
    return M.spec_for("pidnet_s", 19, augment=False), W.load_npz(WEIGHTS)


@pytest.fixture(scope="module")
def artifact(net, tmp_path_factory):
    """A 1x64x64 program written by tools.convert --export-aot from the
    .npz."""
    path = tmp_path_factory.mktemp("aot") / "serve.pt2"
    convert.main([WEIGHTS, str(path), "--a", "pidnet-s", "--c", "19", "--export-aot",
                  "--r", "64", "64"])
    return path


def _image(rng, h, w, n=1):
    return torch.from_numpy(rng.standard_normal((n, h, w, 3)).astype(np.float32))


def test_roundtrip_matches_direct_and_eager(net, rng):
    spec, sd = net
    x = _image(rng, 64, 128)
    blob = export_serving(sd, spec, (64, 128))
    assert isinstance(blob, bytes) and len(blob) > 0
    got = load_serving(blob, device="cpu")(x)

    folded = fold_state_dict(sd, spec)
    with torch.no_grad():
        direct = make_serving_fn(folded, spec, device="cpu")(x)
    eager = engine.make_inference_classmap(engine.config(), spec, folded, folded=True,
                                           compute_dtype=torch.bfloat16, device="cpu")(x)
    assert got.shape == (1, 64, 128) and got.dtype == torch.int32
    assert torch.equal(got, direct)
    assert torch.equal(got, eager)


def test_file_loads_in_a_fresh_process_without_model_code(artifact):
    code = (
        "import sys, torch\n"
        "from pidnet_tpu_torch.convert.aot import load_serving\n"
        f"serve = load_serving({str(artifact)!r}, device='cpu')\n"
        "out = serve(torch.zeros(serve.input_shape))\n"
        "assert out.shape == (1, 64, 64) and out.dtype == torch.int32, out.shape\n"
        "bad = [m for m in sys.modules if m.startswith(('pidnet_tpu_torch.models', 'jax',\n"
        "                                                'pidnet_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('served', serve.input_shape)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "served (1, 64, 64, 3)" in proc.stdout


def test_convert_cli_export_aot_from_pt_and_npz(net, artifact, rng, tmp_path):
    spec, sd = net
    x = _image(rng, 64, 64)
    from_npz = load_serving(str(artifact), device="cpu")(x)
    src = tmp_path / "model.pt"
    state = {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}
    ckpt.save_model(str(src), {k: v for k, v in sd.items() if k not in state}, state)
    dst = tmp_path / "serve.pt2"
    convert.main([str(src), str(dst), "--a", "pidnet-s", "--c", "19", "--export-aot",
                  "--r", "64", "64"])
    from_pt = load_serving(str(dst), device="cpu")(x)
    assert from_pt.shape == (1, 64, 64) and from_pt.dtype == torch.int32
    assert 0 <= int(from_pt.min()) and int(from_pt.max()) < 19
    assert torch.equal(from_pt, from_npz)


def test_export_requires_resolution(tmp_path, net):
    with pytest.raises(SystemExit, match="--r"):
        convert.main([str(tmp_path / "x.pt"), str(tmp_path / "y"), "--export-aot"])
    with pytest.raises(ValueError, match="multiples of 64"):
        export_serving(net[1], net[0], (64, 96))


def test_speed_cli_aot_mode(artifact, capsys, monkeypatch):
    # the protocol's own function, with a shorter calibration and run
    monkeypatch.setattr(speed, "measure_fps",
                        functools.partial(speed.measure_fps, calibrate_s=0.05, run_s=0.2))
    speed.main(["--aot", str(artifact), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "AOT Artifact Speed Testing" in out
    assert "64x64 batch=1" in out and "FPS" in out


def test_operator_fake_gives_shape_and_dtype():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        logits = torch.empty((2, 8, 16, 19), dtype=torch.bfloat16)
        out = torch.ops.pidnet_tpu_torch.upsample_argmax(logits, 64, 128, True)
    assert tuple(out.shape) == (2, 64, 128) and out.dtype == torch.int32


def test_operator_is_the_python_function_on_the_cpu(rng):
    x = torch.from_numpy(rng.standard_normal((2, 8, 16, 19)).astype(np.float32))
    before = ua.launches
    for align in (True, False):
        got = torch.ops.pidnet_tpu_torch.upsample_argmax(x, 64, 128, align)
        assert torch.equal(got, ua.upsample_argmax_plain(x, (64, 128), align))
    assert ua.launches == before  # the CPU launches no kernel


def test_ddrnet_export_roundtrips(rng):
    spec = ddrnet.spec_for("ddrnet_23_adb_bag", 19, augment=True)
    sd = M.init(spec, torch.Generator().manual_seed(0))
    x = _image(rng, 64, 64)
    serve = load_serving(export_serving(sd, spec, (64, 64)), device="cpu")
    got = serve(x)
    with torch.no_grad():
        want = make_serving_fn(fold_state_dict(sd, spec), spec, device="cpu")(x)
    assert got.shape == (1, 64, 64) and got.dtype == torch.int32
    assert torch.equal(got, want)


def test_program_records_no_cast_that_changes_nothing(artifact):
    """Every `aten.to` in the program changes a dtype: a no-op cast is
    recorded by the trace, with an `_assert_tensor_metadata` before it,
    and a serving program would dispatch both on every call."""
    program = load_serving(str(artifact), device="cpu").program
    casts = [n for n in program.graph.nodes if n.target == torch.ops.aten.to.dtype]
    asserts = [n for n in program.graph.nodes
               if n.target == torch.ops.aten._assert_tensor_metadata.default]
    assert casts, "the program casts its f32 input to bf16"
    for node in casts:
        assert node.args[0].meta["val"].dtype != node.meta["val"].dtype, node.format_node()
    assert len(asserts) <= len(casts)


def test_loaded_program_runs_no_assert_and_checks_its_input(artifact):
    """The loaded module drops the trace's metadata asserts (dispatches on
    every call) and checks the input's dtype at the call instead; the
    module itself checks its shape."""
    serve = load_serving(str(artifact), device="cpu")
    assert not [n for n in serve._fn.graph.nodes
                if n.target == torch.ops.aten._assert_tensor_metadata.default]
    with pytest.raises(ValueError, match="float32"):
        serve(torch.zeros(serve.input_shape, dtype=torch.float64))
    with pytest.raises(Exception):
        serve(torch.zeros((1, 64, 128, 3)))
