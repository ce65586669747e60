"""PyTorch port on the card: the CUDA kernels against their plain versions,
the served path's launch count and the train step's. Every test here is marked `cuda` and
skips without a GPU. The file imports neither JAX nor pidnet_tpu, so it
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
from pidnet_tpu_torch.ops import upsample_argmax as TU
from pidnet_tpu_torch.train.step import TrainState, make_train_step

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
     ((1, 5, 7, 3), (1, 1)), ((1, 64, 64, 19), (16, 16))],
)
def test_ce_front_kernels_match_plain(cuda_device, dtype, align, shape, out_hw):
    """K2: w exact, ignored and out-of-range pixels 0, nll within 1e-4 of the
    plain version. K3: against autograd of the plain forward, cosine >
    0.99999 and max-abs within 2^-7 (bf16 output) or 1e-5 (fp32) of the
    largest value; fp32 atomics reorder its sums from run to run."""
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
    dl = TC.ce_front_bwd(x, labels, 255, out_hw, align, g)
    assert (TC.fwd_launches, TC.bwd_launches) == (before[0] + 1, before[1] + 1)
    xr = x.detach().clone().requires_grad_()
    nll_p, w_p = TC.ce_front_fwd_plain(xr, labels, cw, 255, out_hw, align)
    (dl_p,) = torch.autograd.grad(nll_p, xr, g)
    torch.cuda.synchronize()
    inert = (labels == 255) | (labels == c + 1)
    assert torch.equal(w, w_p) and not nll[inert].any() and not w[inert].any()
    assert (nll - nll_p).abs().max().item() <= 1e-4
    assert dl.dtype == x.dtype and dl.shape == x.shape
    a, b = dl.float().flatten(), dl_p.float().flatten()
    if b.abs().max() > 0:
        assert (a @ b / (a.norm() * b.norm())).item() > 0.99999
    tol = 2 ** -7 if dtype == "bfloat16" else 1e-5
    assert (a - b).abs().max().item() <= tol * b.abs().max().item()


def test_ce_front_wrappers_reject_bad_input(cuda_device):
    x = torch.zeros((1, 4, 4, 3), device=cuda_device)
    lab = torch.zeros((1, 8, 8), dtype=torch.int32, device=cuda_device)
    g = torch.zeros((1, 8, 8), device=cuda_device)
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
