"""PyTorch port on the card: the CUDA kernels against their plain versions,
and the launch counts of the served path, the train step and the eval
step. Every test here is marked `cuda` and skips without a GPU. The file imports neither JAX nor pidnet_tpu, so it
also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from pidnet_tpu_torch import engine
from pidnet_tpu_torch.convert.fold import fold_state_dict
from pidnet_tpu_torch.convert.weights import load_npz
from pidnet_tpu_torch.losses.criterion import FullLoss
from pidnet_tpu_torch.models import pidnet as M
from pidnet_tpu_torch.ops import ce_front as TC
from pidnet_tpu_torch.ops import conv3x3 as TK
from pidnet_tpu_torch.ops import upsample_argmax as TU
from pidnet_tpu_torch.train.step import TrainState, make_eval_step, make_train_step

pytestmark = pytest.mark.cuda

torch.set_num_threads(2)

WEIGHTS = os.path.join(os.path.dirname(__file__), "..", "runs", "train2k", "weights_f16.npz")


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize(
    "shape,out_hw",
    [((1, 128, 256, 19), (1024, 2048)), ((2, 16, 32, 19), (128, 256)),
     ((1, 90, 120, 11), (720, 960)), ((1, 16, 32, 19), (16, 32)), ((1, 5, 7, 3), (1, 1))],
)
def test_upsample_argmax_kernel_matches_plain(cuda_device, dtype, align, shape, out_hw):
    """>=0.9999 agreement, and exact wherever the fp32 top-2 margin of the
    upsampled logits exceeds 1e-3 (the two sum in different orders)."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy((rng.standard_normal(shape) * 2).astype(np.float32))
    x = x.to(cuda_device, getattr(torch, dtype))
    before = TU.launches
    got = TU.upsample_argmax(x, out_hw, align)
    assert TU.launches == before + 1
    want = TU.upsample_argmax_plain(x, out_hw, align)
    up = torch.nn.functional.interpolate(x.permute(0, 3, 1, 2).float(), size=out_hw,
                                         mode="bilinear", align_corners=align)
    top2 = up.topk(2, dim=1).values
    confident = (top2[:, 0] - top2[:, 1]) > 1e-3
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert (got == want).float().mean().item() >= 0.9999
    assert torch.equal(got[confident], want[confident])


def test_upsample_argmax_wrapper_rejects_bad_input(cuda_device):
    with pytest.raises(ValueError, match="contiguous"):
        TU.upsample_argmax(torch.zeros((1, 3, 4, 4), device=cuda_device).permute(0, 2, 3, 1),
                           (8, 8), True)
    with pytest.raises(TypeError):
        TU.upsample_argmax(torch.zeros((1, 4, 4, 3), device=cuda_device, dtype=torch.float16),
                           (8, 8), True)
    with pytest.raises(ValueError, match="expected"):
        TU.upsample_argmax(torch.zeros((4, 4, 3), device=cuda_device), (8, 8), True)


def test_served_classmap_launches_the_kernel(cuda_device):
    """The folded bf16 class-map closure on the card launches the kernel
    once per request and matches the same closure on the CPU on every
    pixel the CPU's fp32 logits decide by a margin above 1.0."""
    spec = M.spec_for("pidnet_s", 19, augment=False)
    sd = fold_state_dict(load_npz(WEIGHTS), spec)
    x = np.random.default_rng(0).standard_normal((2, 128, 256, 3)).astype(np.float32)
    cfg = engine.config()
    before = TU.launches
    got = engine.make_inference_classmap(cfg, spec, sd, folded=True,
                                         compute_dtype=torch.bfloat16)(x)
    assert TU.launches == before + 1
    assert got.device.type == "cuda" and tuple(got.shape) == (2, 128, 256)
    probs = engine.make_inference(cfg, spec, sd, folded=True, device="cpu")(x)
    top2 = probs.log().topk(2, dim=-1).values
    conf = (top2[..., 0] - top2[..., 1]) > 1.0
    agree = (got.cpu().long() == probs.argmax(-1))[conf].float().mean().item()
    assert agree >= 0.9999


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize(
    "shape,out_hw",
    [((2, 16, 16, 19), (128, 128)), ((2, 16, 24, 11), (120, 96)), ((1, 16, 16, 19), (16, 16)),
     ((1, 5, 7, 3), (1, 1)), ((1, 64, 64, 19), (16, 16)),
     # bands of 4 rows over h = 126; column tiles; 40 classes, in chunks of 32
     ((6, 126, 128, 19), (1008, 1024)), ((1, 16, 512, 19), (128, 4096)),
     ((1, 16, 16, 40), (128, 128)),
     # the eval shape; 100 classes, four lanes a pixel
     ((2, 128, 256, 19), (1024, 2048)), ((1, 16, 16, 100), (128, 128))],
)
def test_ce_front_kernels_match_plain(cuda_device, dtype, align, shape, out_hw):
    """K2: w exact, ignored and out-of-range pixels 0, nll within 1e-4 of the
    plain version. K3: against autograd of the plain forward, cosine >
    0.99999 and max-abs within 2^-7 (bf16 output) or 1e-5 (fp32) of the
    largest value. For each, a second launch on the same inputs gives the
    same output bit for bit (no atomics, one fixed order of sums)."""
    rng = np.random.default_rng(3)
    n, _, _, c = shape
    x = torch.from_numpy((rng.standard_normal(shape) * 2).astype(np.float32))
    x = x.to(cuda_device, getattr(torch, dtype))
    lab = np.where(rng.random((n, *out_hw)) < 0.1, 255, rng.integers(0, c, (n, *out_hw)))
    lab.reshape(-1)[:3] = c + 1
    labels = torch.from_numpy(lab.astype(np.int32)).to(cuda_device)
    cw = torch.from_numpy((0.8 + rng.random(c)).astype(np.float32)).to(cuda_device)
    g = torch.from_numpy(rng.random((n, *out_hw)).astype(np.float32)).to(cuda_device)
    before = (TC.fwd_launches, TC.bwd_launches)
    nll, w = TC.ce_front_fwd(x, labels, cw, 255, out_hw, align)
    nll2, w2 = TC.ce_front_fwd(x, labels, cw, 255, out_hw, align)
    dl = TC.ce_front_bwd(x, labels, 255, out_hw, align, g)
    again = TC.ce_front_bwd(x, labels, 255, out_hw, align, g)
    assert (TC.fwd_launches, TC.bwd_launches) == (before[0] + 2, before[1] + 2)
    xr = x.detach().clone().requires_grad_()
    nll_p, w_p = TC.ce_front_fwd_plain(xr, labels, cw, 255, out_hw, align)
    (dl_p,) = torch.autograd.grad(nll_p, xr, g)
    torch.cuda.synchronize()
    inert = (labels == 255) | (labels == c + 1)
    assert torch.equal(w, w_p) and not nll[inert].any() and not w[inert].any()
    assert (nll - nll_p).abs().max().item() <= 1e-4
    assert torch.equal(nll.view(torch.int32), nll2.view(torch.int32)) and torch.equal(w, w2)
    assert dl.dtype == x.dtype and dl.shape == x.shape
    assert torch.equal(dl.view(torch.int16 if dtype == "bfloat16" else torch.int32),
                       again.view(torch.int16 if dtype == "bfloat16" else torch.int32))
    a, b = dl.float().flatten(), dl_p.float().flatten()
    if b.abs().max() > 0:
        assert (a @ b / (a.norm() * b.norm())).item() > 0.99999
    tol = 2 ** -7 if dtype == "bfloat16" else 1e-5
    assert (a - b).abs().max().item() <= tol * b.abs().max().item()


def test_ce_front_wrappers_reject_bad_input(cuda_device):
    x = torch.zeros((1, 4, 4, 3), device=cuda_device)
    lab = torch.zeros((1, 8, 8), dtype=torch.int32, device=cuda_device)
    g = torch.zeros((1, 8, 8), device=cuda_device)
    before = TC.fwd_launches
    with pytest.raises(ValueError, match="1024"):
        TC.ce_front_fwd(torch.zeros((1, 4, 4, 1025), device=cuda_device), lab, None, 255, (8, 8),
                        True)
    assert TC.fwd_launches == before
    with pytest.raises(TypeError):
        TC.ce_front_fwd(x.half(), lab, None, 255, (8, 8), True)
    with pytest.raises(ValueError, match="labels"):
        TC.ce_front_fwd(x, lab.long(), None, 255, (8, 8), True)
    with pytest.raises(ValueError, match="labels"):
        TC.ce_front_fwd(x, lab.cpu(), None, 255, (8, 8), True)
    with pytest.raises(ValueError, match="contiguous"):
        TC.ce_front_bwd(x.permute(0, 2, 1, 3), lab, 255, (8, 8), True, g)
    with pytest.raises(ValueError, match="g must"):
        TC.ce_front_bwd(x, lab, 255, (8, 8), True, g[:, :4])


def test_train_step_launches_the_kernels(cuda_device):
    """One bf16 PIDNet-S step on the card: 1 K1, 2 K2 and 2 K3 launches,
    a finite loss, and parameters that moved."""
    spec = M.spec_for("pidnet_s", 19, augment=True)
    model = M.build(spec, M.init(spec, torch.Generator().manual_seed(0)), device=cuda_device,
                    train=True)
    ts = TrainState.create(model)
    step = make_train_step(ts, FullLoss(ignore_label=255, ohem_kept=1000),
                           compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.standard_normal((2, 128, 128, 3)).astype(np.float32))
    lab = torch.from_numpy(rng.integers(0, 19, (2, 128, 128)).astype(np.int32))
    edge = torch.from_numpy((rng.random((2, 128, 128)) < 0.1).astype(np.float32))
    before = (TU.launches, TC.fwd_launches, TC.bwd_launches)
    w0 = ts.params()["conv1.0.weight"].clone()
    metrics = step(img.to(cuda_device), lab.to(cuda_device), edge.to(cuda_device), 0.01)
    assert (TU.launches, TC.fwd_launches, TC.bwd_launches) == (
        before[0] + 1, before[1] + 2, before[2] + 2)
    assert np.isfinite(float(metrics["loss"]))
    assert not torch.equal(w0, ts.params()["conv1.0.weight"])


@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("epilogue", ["none", "bias", "relu", "bias+relu", "stats",
                                      "bias+relu+stats"])
@pytest.mark.parametrize("shape", [(1, 16, 24, 128, 128), (2, 8, 8, 256, 128),
                                   (1, 3, 5, 64, 256), (3, 13, 40, 128, 128),
                                   (1, 5, 200, 128, 128)])
def test_conv3x3_kernel_matches_plain(cuda_device, out_dtype, epilogue, shape):
    """y within atol 0.0079 / rtol 0.01 in bf16 (one ulp; the two sum in
    other orders) and 1e-4 / 1e-4 in fp32; the statistics within 2e-5 of
    the sums of |y| and y^2 of the kernel's own fp32 output (fp32 atomics
    reorder them from run to run); one launch counted per call. The last
    two shapes have pixel tiles that straddle the bottom and the right edge
    (W = 40 in tiles of 64 x 2) and column tiles of a W above 128."""
    n, h, w, cin, cout = shape
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((n, h, w, cin), dtype=np.float32)).to(cuda_device)
    wt = torch.from_numpy(rng.standard_normal((3, 3, cin, cout), dtype=np.float32) * 0.02)
    wt = wt.to(cuda_device)
    b = torch.from_numpy(rng.standard_normal(cout, dtype=np.float32)).to(cuda_device)
    kw = dict(b=b if "bias" in epilogue else None, relu="relu" in epilogue,
              stats="stats" in epilogue)
    dtype = getattr(torch, out_dtype)
    before = TK.launches
    got = TK.conv3x3(x, wt, out_dtype=dtype, **kw)
    assert TK.launches == before + 1
    want = TK.conv3x3_plain(x, wt, out_dtype=dtype, **kw)
    if kw["stats"]:
        (got, st), (want, _) = got, want
        y32 = TK.conv3x3(x, wt, kw["b"], relu=kw["relu"], out_dtype=torch.float32)
        y32 = y32.double().reshape(-1, cout)
        own = torch.stack([y32.sum(0), (y32 * y32).sum(0)])
        scale = torch.stack([y32.abs().sum(0), (y32 * y32).sum(0)])
        assert st.dtype == torch.float32 and tuple(st.shape) == (2, cout)
        assert bool(((st.double() - own).abs() <= 2e-5 * scale + 1e-30).all())
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape == (n, h, w, cout)
    atol, rtol = (0.0079, 0.01) if dtype == torch.bfloat16 else (1e-4, 1e-4)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


def test_conv3x3_wrapper_rejects_bad_input(cuda_device):
    x = torch.zeros((1, 4, 4, 96), device=cuda_device, dtype=torch.bfloat16)
    before = TK.launches
    with pytest.raises(ValueError, match="multiple of 64"):
        TK.conv3x3(x, torch.zeros((3, 3, 96, 128), device=cuda_device))
    x = torch.zeros((1, 4, 4, 128), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 64"):
        TK.conv3x3(x, torch.zeros((3, 3, 128, 64), device=cuda_device))
    with pytest.raises(ValueError, match="w"):
        TK.conv3x3(x, torch.zeros((1, 1, 128, 128), device=cuda_device))
    with pytest.raises(ValueError, match="contiguous"):
        TK.conv3x3(x.permute(0, 2, 1, 3), torch.zeros((3, 3, 128, 128), device=cuda_device))
    with pytest.raises(TypeError, match="out_dtype"):
        TK.conv3x3(x, torch.zeros((3, 3, 128, 128), device=cuda_device), out_dtype=torch.half)
    assert TK.launches == before


@pytest.mark.parametrize("dtype,k1", [(None, 1), (torch.bfloat16, 3)])
def test_eval_step_launches_the_kernels(cuda_device, dtype, k1):
    """One eval batch of PIDNet-S on the card: K1 once for the accuracy and,
    in bf16, once per segmentation head's matrix; K2 twice; K3 never; the
    matrices count the real samples' pixels."""
    spec = M.spec_for("pidnet_s", 19, augment=True)
    model = M.build(spec, M.init(spec, torch.Generator().manual_seed(0)), device=cuda_device)
    step = make_eval_step(model, FullLoss(ignore_label=255, ohem_kept=1000), num_classes=19,
                          compute_dtype=dtype)
    rng = np.random.default_rng(0)
    img = rng.standard_normal((2, 128, 128, 3)).astype(np.float32)
    lab = rng.integers(0, 19, (2, 128, 128)).astype(np.int32)
    edge = (rng.random((2, 128, 128)) < 0.1).astype(np.float32)
    before = (TU.launches, TC.fwd_launches, TC.bwd_launches)
    metrics, cms = step(img, lab, edge, np.array([1.0, 0.0], np.float32))
    assert (TU.launches, TC.fwd_launches, TC.bwd_launches) == (
        before[0] + k1, before[1] + 2, before[2])
    assert float(metrics["weight"]) == 1.0 and np.isfinite(float(metrics["loss"]))
    assert cms.device.type == "cuda" and [int(c.sum()) for c in cms] == [128 * 128] * 2
