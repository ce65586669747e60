"""PyTorch port, slice 1 as a whole on the CPU: the inference closures, the
frozen train2k class maps at full resolution, PNG decoding, the CLIs, and
the rule that the port imports nothing of JAX or pidnet_tpu."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pidnet_tpu import engine as jengine
from pidnet_tpu.models import pidnet as JM
from pidnet_tpu_torch import engine, resolve_device
from pidnet_tpu_torch.convert.fold import fold_state_dict
from pidnet_tpu_torch.convert.weights import load_npz, to_jax
from pidnet_tpu_torch.data.png import read_png, write_png
from pidnet_tpu_torch.data.transforms import input_transform
from pidnet_tpu_torch.models import pidnet as M
from pidnet_tpu_torch.ops import upsample_argmax as TU
from pidnet_tpu_torch.ops.resize import resize_bilinear
from pidnet_tpu_torch.tools import custom, speed, train
from pidnet_tpu_torch.tools import eval as eval_tool

torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..")
WEIGHTS = os.path.join(ROOT, "runs", "train2k", "weights_f16.npz")
GOLDENS = os.path.join(ROOT, "tests", "goldens", "classmaps_train2k.npz")
SAMPLES = os.path.join(ROOT, "samples")


@pytest.fixture(scope="module")
def trained():
    return load_npz(WEIGHTS)


def test_classmap_matches_argmax_of_inference(rng, trained):
    """make_inference_classmap == argmax of the raw resized logits, and
    agrees with argmax(make_inference) up to exp() rounding ties."""
    cfg = engine.config(num_outputs=2, align_corners=True, output_index=1)
    spec = M.spec_for("pidnet_s", 19, augment=True)
    x = rng.standard_normal((1, 64, 128, 3)).astype(np.float32)
    probs = engine.make_inference(cfg, spec, trained, device="cpu")(x)
    classes = engine.make_inference_classmap(cfg, spec, trained, device="cpu")(x)
    assert classes.dtype == torch.int32 and tuple(classes.shape) == (1, 64, 128)
    assert tuple(probs.shape) == (1, 64, 128, 19) and probs.dtype == torch.float32
    with torch.no_grad():
        logits = M.build(spec, trained, device="cpu")(torch.from_numpy(x))[1]
    want = torch.argmax(resize_bilinear(logits, (64, 128), True), dim=-1)
    assert torch.equal(classes.long(), want)
    assert (classes.long() == probs.argmax(-1)).float().mean().item() >= 0.999
    infer = engine.make_inference_classmap(cfg, spec, trained, device="cpu")
    for bad in (x[:, :, :96], x[..., :1], x[0]):
        with pytest.raises(ValueError, match="multiples of 64"):
            infer(bad)


def test_classmap_matches_jax_engine(rng, trained):
    """The port's class-map closure against the JAX engine's on the same
    weights and frame (fp32, unfolded)."""
    cfg = engine.config(num_outputs=2, align_corners=True, output_index=1)
    spec = M.spec_for("pidnet_s", 19, augment=True)
    params, state = to_jax(trained)
    x = rng.standard_normal((1, 64, 128, 3)).astype(np.float32)
    want = np.asarray(jengine.make_inference_classmap(
        cfg, JM.spec_for("pidnet_s", 19, augment=True), params, state)(jnp.asarray(x)))
    got = engine.make_inference_classmap(cfg, spec, trained, device="cpu")(x).numpy()
    assert (got == want).mean() >= 0.9999


def test_folded_bf16_classmap_agrees_on_confident_pixels(rng, trained):
    """The served form (folded, bf16) against the fp32 unfolded maps on
    pixels whose fp32 top-2 margin exceeds 1.0, as the bench gate does."""
    spec = M.spec_for("pidnet_s", 19, augment=False)
    cfg = engine.config()
    x = rng.standard_normal((1, 64, 128, 3)).astype(np.float32)
    served = engine.make_inference_classmap(cfg, spec, fold_state_dict(trained, spec),
                                            folded=True, compute_dtype=torch.bfloat16,
                                            device="cpu")(x)
    logits = engine.make_inference(cfg, spec, trained, device="cpu")(x).log()
    top2 = logits.topk(2, dim=-1).values
    conf = (top2[..., 0] - top2[..., 1]) > 1.0
    agree = (served.long() == logits.argmax(-1))[conf].float().mean().item()
    assert conf.float().mean().item() > 0.3 and agree >= 0.999


def test_train2k_goldens_full_resolution(trained):
    """The port's fp32 pipeline (unfolded, head 1 of augment=True,
    align_corners=True) reproduces the frozen class maps at 1024x2048."""
    goldens = np.load(GOLDENS)
    cfg = engine.config(num_outputs=2, align_corners=True, output_index=1)
    infer = engine.make_inference_classmap(cfg, M.spec_for("pidnet_s", 19, augment=True),
                                           trained, device="cpu")
    for name in goldens.files:
        x = input_transform(read_png(os.path.join(SAMPLES, name)), bgr_to_rgb=False)[None]
        got = infer(x)[0].numpy()
        agreement = float((got == goldens[name]).mean())
        assert agreement >= 0.995, (name, agreement)


def test_png_decode_equals_cv2():
    cv2 = pytest.importorskip("cv2")
    for name in sorted(os.listdir(SAMPLES)):
        path = os.path.join(SAMPLES, name)
        got = read_png(path)
        assert got.shape == (1024, 2048, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, cv2.imread(path)[:, :, ::-1])


def test_png_round_trip_and_all_filters(tmp_path, rng):
    cv2 = pytest.importorskip("cv2")
    img = rng.integers(0, 256, (23, 41, 3), dtype=np.uint8)
    ours = str(tmp_path / "ours.png")
    write_png(ours, img)
    np.testing.assert_array_equal(read_png(ours), img)
    np.testing.assert_array_equal(cv2.imread(ours)[:, :, ::-1], img)
    # cv2 picks a filter per row; a smooth image exercises Sub/Up/Average/Paeth
    smooth = np.cumsum(rng.integers(0, 3, (40, 64, 3)), axis=1).astype(np.uint8)
    theirs = str(tmp_path / "theirs.png")
    cv2.imwrite(theirs, smooth[:, :, ::-1])
    np.testing.assert_array_equal(read_png(theirs), smooth)
    # 8-bit greyscale (colour type 0) both ways, cv2's filters included
    write_png(str(tmp_path / "gray.png"), img[:, :, 0])
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "gray.png"), cv2.IMREAD_UNCHANGED),
                                  img[:, :, 0])
    cv2.imwrite(str(tmp_path / "gray_cv2.png"), smooth[:, :, 1])
    got = read_png(str(tmp_path / "gray_cv2.png"))
    assert got.shape == (40, 64) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, smooth[:, :, 1])
    with pytest.raises(ValueError, match="RGB"):
        write_png(str(tmp_path / "two.png"), img[:, :, :2])
    cv2.imwrite(str(tmp_path / "rgba.png"), np.dstack([img, img[:, :, :1]]))
    with pytest.raises(ValueError, match="RGB"):
        read_png(str(tmp_path / "rgba.png"))


def test_input_transform_matches_golden_recipe(rng):
    img = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    want = (img.astype(np.float32)[:, :, ::-1] / 255.0 - mean) / std
    np.testing.assert_array_equal(input_transform(img, bgr_to_rgb=True), want)


@pytest.mark.parametrize("bf16", [False, True])
def test_custom_cli_writes_colourised_maps(tmp_path, rng, bf16):
    root = tmp_path / "imgs"
    root.mkdir()
    write_png(str(root / "a.png"), rng.integers(0, 256, (64, 128, 3), dtype=np.uint8))
    argv = ["--a", "pidnet-s", "--p", WEIGHTS, "--r", str(root) + "/", "--device", "cpu"]
    custom.main(argv + (["--bf16"] if bf16 else []))
    out = read_png(str(root / "outputs" / "a.png"))
    assert out.shape == (64, 128, 3)
    palette = {tuple(c) for c in custom.COLOR_MAP}
    assert {tuple(p) for p in out.reshape(-1, 3)} <= palette


def test_speed_protocol_counts_iterations():
    calls = []
    latency, fps = speed.measure_fps(lambda x: calls.append(x), 0, torch.device("cpu"),
                                     warmup=2, calibrate_s=1e-9, run_s=0.0)
    assert len(calls) == 2 + 100 + 1 and latency > 0 and fps > 0
    model, dtype = speed.build_speed_model("pidnet-s", 19, fold=True, device="cpu")
    assert dtype == torch.bfloat16 and not any(k.startswith("seghead") for k in model.state_dict())
    with torch.inference_mode():
        out = model(torch.zeros((1, 64, 64, 3), dtype=dtype))
    assert tuple(out.shape) == (1, 8, 8, 19)
    wall, busy, rows = speed.device_breakdown(lambda x: x + 1, torch.zeros(4),
                                              torch.device("cpu"), steps=2)
    assert wall > 0 and busy == 0 and rows == []  # no device kernels on the CPU


def test_entry_points_default_to_cuda_and_never_fall_back(trained):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.make_inference_classmap(engine.config(), M.spec_for("pidnet_s", 19, False),
                                       trained)
    with pytest.raises(RuntimeError, match="CUDA"):
        M.build(M.spec_for("pidnet_s", 19, True), trained)
    yaml = os.path.join(ROOT, "configs", "cityscapes", "pidnet_small_cityscapes.yaml")
    for cli in (train, eval_tool):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["--cfg", yaml])
    assert resolve_device("cpu") == torch.device("cpu")
    assert TU.launches == 0


def test_port_imports_no_jax():
    """Every module of the port (parallel/spatial.py among them), and
    chip_smoke.py, import without jax, pidnet_tpu, cv2 or PIL (the card's
    machine has neither of the last two)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import pidnet_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(pidnet_tpu_torch.__path__, 'pidnet_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'pidnet_tpu', 'cv2', 'PIL')]\n"
        "n = sum(k.startswith('pidnet_tpu_torch') for k in sys.modules)\n"
        "print(n, bad)\n"
        "sys.exit(1 if bad or n < 15 or 'pidnet_tpu_torch.parallel.spatial' not in sys.modules\n"
        "         else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=os.path.abspath(ROOT), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
