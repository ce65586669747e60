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
from pidnet_tpu_torch.models import bisenet
from pidnet_tpu_torch.models import pidnet as M
from pidnet_tpu_torch.ops import batch_norm as TB
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
     ((1, 90, 120, 11), (720, 960)), ((1, 16, 32, 19), (16, 32)), ((1, 5, 7, 3), (1, 1)),
     # BiSeNet serves its logits at the input's size: K1 at scale 1
     ((1, 1024, 2048, 19), (1024, 2048))],
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


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("shape,out_hw", [((1, 16, 16, 100), (128, 128)),
                                          ((1, 8, 8, 1100), (32, 32))])
def test_upsample_argmax_lanes_and_direct_match_plain(cuda_device, dtype, align, shape, out_hw):
    """100 classes (the walk, four lanes a pixel) and 1100 (above the walk's
    1024: the direct kernel), one launch counted each, at the gate of
    test_upsample_argmax_kernel_matches_plain."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy((rng.standard_normal(shape) * 2).astype(np.float32))
    x = x.to(cuda_device, getattr(torch, dtype))
    walk = TU.plan(*shape, *out_hw, align)
    assert (walk is None) == (shape[-1] > 1024) and (walk is None or walk.lpp == 4)
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


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape,out_hw", [((1, 128, 256, 19), (1024, 2048)),
                                          ((6, 128, 128, 19), (1024, 1024)),
                                          ((1, 16, 16, 100), (128, 128)),
                                          ((1, 8, 8, 1100), (32, 32))])
def test_upsample_argmax_launches_are_bit_identical(cuda_device, dtype, shape, out_hw):
    """Two launches on the same inputs give the same map: the serving and
    training shapes, four lanes a pixel, and the direct kernel."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy((rng.standard_normal(shape) * 2).astype(np.float32))
    x = x.to(cuda_device, getattr(torch, dtype))
    a = TU.upsample_argmax(x, out_hw, True)
    b = TU.upsample_argmax(x, out_hw, True)
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("c,tied", [(19, (2, 7)), (19, (3, 11)), (100, (5, 6)),
                                    (100, (2, 97))])
def test_upsample_argmax_ties_go_to_the_lowest_class(cuda_device, dtype, align, c, tied):
    """Two classes with the same logits at every source pixel, above all
    others, tie at every output pixel, and the lower class wins: 5 apart (2
    and 7) and 8 apart (3 and 11) in one lane's running compare, and in
    different lanes at 100 classes (5 and 6; 2 and 97)."""
    x = torch.from_numpy(_tied_logits((1, 16, 32, c), tied)).to(cuda_device, getattr(torch, dtype))
    got = TU.upsample_argmax(x, (128, 256), align)
    assert bool((got == min(tied)).all())


def _tied_logits(shape, tied, seed=6) -> np.ndarray:
    """Seeded logits in [-2, -1) but for the `tied` classes, which share one
    field in [0, 1) (tests/test_torch_upsample_argmax.py::tied_logits)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, -1, shape).astype(np.float32)
    x[..., list(tied)] = rng.uniform(0, 1, shape[:-1] + (1,))
    return x


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


@pytest.mark.parametrize("align", [True, False])
def test_upsample_argmax_operator_launches_the_kernel(cuda_device, align):
    """torch.ops.pidnet_tpu_torch.upsample_argmax on a CUDA tensor launches
    K1 once (counted in the same `launches`) and gives the Python
    function's map bit for bit."""
    x = torch.from_numpy((np.random.default_rng(9).standard_normal((1, 128, 256, 19)) * 2)
                         .astype(np.float32)).to(cuda_device, torch.bfloat16)
    before = TU.launches
    got = torch.ops.pidnet_tpu_torch.upsample_argmax(x, 1024, 2048, align)
    assert TU.launches == before + 1
    assert torch.equal(got, TU.upsample_argmax(x, (1024, 2048), align))
    want = TU.upsample_argmax_plain(x, (1024, 2048), align)
    assert (got == want).float().mean().item() >= 0.9999


def test_serving_program_on_the_card_equals_eager(cuda_device):
    """A program exported on the CPU and loaded on the card launches K1
    once a call and gives the eager folded bf16 class map bit for bit."""
    from pidnet_tpu_torch.convert.aot import export_serving, load_serving

    spec = M.spec_for("pidnet_s", 19, augment=False)
    sd = load_npz(WEIGHTS)
    serve = load_serving(export_serving(sd, spec, (128, 256)))
    x = np.random.default_rng(1).standard_normal((1, 128, 256, 3)).astype(np.float32)
    before = TU.launches
    got = serve(torch.from_numpy(x).to(cuda_device))
    assert TU.launches == before + 1
    eager = engine.make_inference_classmap(engine.config(), spec, fold_state_dict(sd, spec),
                                           folded=True, compute_dtype=torch.bfloat16)(x)
    assert got.dtype == torch.int32 and torch.equal(got, eager)


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
     ((2, 128, 256, 19), (1024, 2048)), ((1, 16, 16, 100), (128, 128)),
     # BiSeNet's training shape: its heads arrive at the labels' size
     ((6, 1024, 1024, 19), (1024, 1024))],
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


# (logits, output): the x8 of PIDNet's and DDRNet's heads, BiSeNet's scale 1,
# and scale 1 with 1100 classes, whose plan is None: the direct K1 over a
# window (K2 and K3 take at most 1024 classes)
WINDOW_CASES = {"x8": ((2, 16, 32, 19), (128, 256)), "scale1": ((2, 64, 128, 19), (64, 128)),
                "direct": ((1, 32, 32, 1100), (32, 32))}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("ranks,s", [(2, 0), (2, 1), (4, 0), (4, 1), (4, 3)])
@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_windowed_kernels_match_windowed_plain(cuda_device, dtype, align, ranks, s, case):
    """K1, K2 and K3 over rank s's window of `ranks` spatial ranks
    (H-sharding: the rank's rows of the logits with their halo, the whole
    image's taps) against their windowed plain versions, with the gates of
    the whole image's tests above; the window's launches count in the same
    counters and in the counts of windowed launches. The "direct" case
    holds K1's direct kernel over the window (its plan is None)."""
    from pidnet_tpu_torch.parallel import spatial as SP

    class Rank:
        n_spatial, spatial_index = ranks, s

    rng = np.random.default_rng(5)
    (n, h, w, c), out_hw = WINDOW_CASES[case]
    whole = torch.from_numpy((rng.standard_normal((n, h, w, c)) * 2).astype(np.float32))
    top, bottom, rows = SP.halo_for_resize(h // ranks, out_hw[0] // ranks, align, Rank, margin=1)
    padded = torch.nn.functional.pad(whole, (0, 0, 0, 0, h, h))
    x = padded[:, h + rows.src_start:h + rows.src_start + h // ranks + top + bottom].contiguous()
    x = x.to(cuda_device, getattr(torch, dtype))
    hw = (out_hw[0] // ranks, out_hw[1])
    direct = case == "direct"
    assert (TU.plan(*x.shape, *hw, align, rows) is None) == direct
    lab = np.where(rng.random((n, *hw)) < 0.1, 255, rng.integers(0, c, (n, *hw)))
    labels = torch.from_numpy(lab.astype(np.int32)).to(cuda_device)
    cw = torch.from_numpy((0.8 + rng.random(c)).astype(np.float32)).to(cuda_device)
    g = torch.from_numpy(rng.random((n, *hw)).astype(np.float32)).to(cuda_device)
    def counts():
        return (TU.launches, TC.fwd_launches, TC.bwd_launches, TU.window_launches,
                TC.fwd_window_launches, TC.bwd_window_launches)

    before = counts()
    classes = TU.upsample_argmax_rows(x, hw, align, rows)
    want = TU.upsample_argmax_plain(x, hw, align, rows)
    top2 = TC._z(x, hw, align, rows).topk(2, dim=-1).values
    same = classes == want
    assert same.float().mean().item() >= 0.9999
    assert not (~same & (top2[..., 0] - top2[..., 1] > 1e-3)).any()
    if direct:
        assert counts() == tuple(b + (i in (0, 3)) for i, b in enumerate(before))
        return
    nll, wm = TC.ce_front_fwd(x, labels, cw, 255, hw, align, rows)
    dl = TC.ce_front_bwd(x, labels, 255, hw, align, g, rows)
    assert counts() == tuple(b + 1 for b in before)
    xr = x.detach().clone().requires_grad_()
    nll_p, w_p = TC.ce_front_fwd_plain(xr, labels, cw, 255, hw, align, rows)
    (dl_p,) = torch.autograd.grad(nll_p, xr, g)
    torch.cuda.synchronize()
    assert torch.equal(wm, w_p) and (nll - nll_p).abs().max().item() <= 1e-4
    a, b = dl.float().flatten(), dl_p.float().flatten()
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


@pytest.mark.parametrize("name,bns", [("pidnet_s", 79), ("pidnet_l", 90)])
def test_train_step_runs_every_bn_on_the_kernels(cuda_device, name, bns):
    """One bf16 step: each of the model's train-mode BN calls (counted by
    forward hooks) launches the BN forward once and its backward once."""
    spec = M.spec_for(name, 19, augment=True)
    model = M.build(spec, M.init(spec, torch.Generator().manual_seed(0)), device=cuda_device,
                    train=True)
    calls = []
    for mod in model.modules():
        if isinstance(mod, M.BatchNorm):
            mod.register_forward_pre_hook(lambda m, inp: calls.append(m))
    ts = TrainState.create(model)
    step = make_train_step(ts, FullLoss(ignore_label=255, ohem_kept=1000),
                           compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.standard_normal((2, 128, 128, 3)).astype(np.float32))
    lab = torch.from_numpy(rng.integers(0, 19, (2, 128, 128)).astype(np.int32))
    edge = torch.from_numpy((rng.random((2, 128, 128)) < 0.1).astype(np.float32))
    before = (TB.fwd_launches, TB.bwd_launches)
    metrics = step(img.to(cuda_device), lab.to(cuda_device), edge.to(cuda_device), 0.01)
    assert np.isfinite(float(metrics["loss"])) and len(calls) == bns
    assert (TB.fwd_launches, TB.bwd_launches) == (before[0] + bns, before[1] + bns)


def test_bisenet_train_step_at_the_cells_size_counts_its_launches(cuda_device):
    """One bf16 BiSeNetV1 step at the recipe's 12 x 1024^2, as the
    benchmark's cell `bisenetv1.train.b12` runs it (heads upsampled to the
    input's size inside the model): 3 K2 and 3 K3 launches at scale 1
    (the two auxiliary heads' CE and the final head's maps, which serve its
    OHEM and the boundary-aware CE), 1 K1 (the accuracy), and 50 BN
    launches each way; a finite loss."""
    spec = bisenet.spec_for("bisenet_adb_bag", 19, augment=True)
    model = M.build(spec, M.init(spec, torch.Generator().manual_seed(0)), device=cuda_device,
                    train=True)
    ts = TrainState.create(model)
    loss_fn = FullLoss(num_outputs=3, balance_weights=M.balance_weights(spec), ignore_label=255,
                       ohem_kept=262144)
    step = make_train_step(ts, loss_fn, compute_dtype=torch.bfloat16)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    img = torch.randn((12, 1024, 1024, 3), generator=g, device=cuda_device)
    lab = torch.randint(0, 19, (12, 1024, 1024), generator=g, device=cuda_device,
                        dtype=torch.int32)
    edge = (torch.rand((12, 1024, 1024), generator=g, device=cuda_device) < 0.1).float()
    before = (TU.launches, TC.fwd_launches, TC.bwd_launches, TB.fwd_launches, TB.bwd_launches)
    metrics = step(img, lab, edge, 0.01)
    after = (TU.launches, TC.fwd_launches, TC.bwd_launches, TB.fwd_launches, TB.bwd_launches)
    assert np.isfinite(float(metrics["loss"]))
    assert [a - b for a, b in zip(after, before)] == [1, 3, 3, 50, 50]


# (N, C, H, W) of train-mode BN: PIDNet-L's stem at 12 x 1024^2 and 1/64 of
# it, DAPPM's 560 channels at 1/64 resolution, the last stage's 1024 at
# 1/32, pooled vectors, ragged rows, 96 and 19 channels (8-byte and 2-byte
# loads in bf16)
BN_SHAPES = [(12, 64, 512, 512), (12, 64, 64, 64), (12, 560, 16, 16), (12, 1024, 32, 32),
             (4, 1024, 1, 1), (3, 96, 5, 7), (2, 19, 3, 5)]


def _bn_inputs(shape, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    c = shape[1]
    x = torch.randn(shape, generator=g, device=device) * 3 + 1
    dy = torch.randn(shape, generator=g, device=device)
    x, dy = (t.to(dtype).contiguous(memory_format=torch.channels_last) for t in (x, dy))
    gamma, beta, rm = (torch.randn(c, generator=g, device=device) for _ in range(3))
    rv = torch.rand(c, generator=g, device=device) + 0.5
    return x, dy, gamma, beta, rm, rv


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", BN_SHAPES)
def test_batch_norm_kernels_match_plain(cuda_device, dtype, shape):
    """The kernels against their plain versions on the card, one launch
    counted each way. Both sum in fp32 in other orders: dbeta and dgamma
    within 1e-5 of the sum of their terms' magnitudes, the per-channel
    numbers within 1e-4 + 1e-5 of each; y and dx within one step of their
    dtype (2^-7 in bf16, 1e-5 in fp32) and 1e-5 of their largest value
    (the per-channel numbers they are formed from differ in their last
    bits). The clamp's mask is equal."""
    dtype = getattr(torch, dtype)
    x, dy, gamma, beta, rm, rv = _bn_inputs(shape, dtype, cuda_device)
    before = (TB.fwd_launches, TB.bwd_launches)
    y, ws = TB.bn_forward(x, gamma, beta, rm, rv, 0.1)
    dx, dg, db = TB.bn_backward(x, dy, ws)
    torch.cuda.synchronize()
    assert (TB.fwd_launches, TB.bwd_launches) == (before[0] + 1, before[1] + 1)
    y_p, ws_p = TB.bn_forward_plain(x, gamma, beta, rm, rv, 0.1)
    dx_p, dg_p, db_p = TB.bn_backward_plain(x, dy, ws_p)
    assert y.dtype == dx.dtype == dtype and y.shape == dx.shape == x.shape
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert dx.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(ws[TB.VAR_MASK], ws_p[TB.VAR_MASK])
    for row in (TB.MEAN, TB.RSTD, TB.SCALE, TB.SHIFT, TB.NEW_MEAN, TB.NEW_VAR):
        torch.testing.assert_close(ws[row], ws_p[row], rtol=1e-4, atol=1e-5)
    xh = (x.float() - ws_p[TB.MEAN].view(1, -1, 1, 1)) * ws_p[TB.RSTD].view(1, -1, 1, 1)
    for got, want, terms in ((db, db_p, dy.float().abs()), (dg, dg_p, (dy.float() * xh).abs())):
        mass = terms.sum(dim=(0, 2, 3))
        assert bool(((got - want).abs() <= 1e-5 * mass).all())
    step = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
    for got, want in ((y, y_p), (dx, dx_p)):
        want = want.float()
        torch.testing.assert_close(got.float(), want, rtol=step,
                                   atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(12, 64, 64, 64), (12, 1024, 32, 32)])
def test_batch_norm_launches_are_bit_identical(cuda_device, dtype, shape):
    """No atomics: two launches on the same inputs give the same bits."""
    x, dy, gamma, beta, rm, rv = _bn_inputs(shape, getattr(torch, dtype), cuda_device, seed=1)
    first = [*TB.bn_forward(x, gamma, beta, rm, rv, 0.1)]
    first += TB.bn_backward(x, dy, first[1])
    second = [*TB.bn_forward(x, gamma, beta, rm, rv, 0.1)]
    second += TB.bn_backward(x, dy, second[1])
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_batch_norm_wrapper_rejects_bad_input(cuda_device):
    """A tensor that is not channels_last, or not bf16/fp32, and
    per-channel tensors of another type or size raise; nothing launches."""
    x, dy, gamma, beta, rm, rv = _bn_inputs((2, 32, 4, 4), torch.bfloat16, cuda_device)
    before = (TB.fwd_launches, TB.bwd_launches)
    with pytest.raises(ValueError, match="channels_last"):
        TB.bn_forward(x.contiguous(), gamma, beta, rm, rv, 0.1)
    with pytest.raises(ValueError, match="channels_last"):
        TB.bn_forward(x[:, :16], gamma[:16], beta[:16], rm[:16], rv[:16], 0.1)
    with pytest.raises(TypeError, match="dtype"):
        TB.bn_forward(x.half(), gamma, beta, rm, rv, 0.1)
    with pytest.raises(TypeError, match="dtype"):
        TB.bn_forward(x.to(torch.int32), gamma, beta, rm, rv, 0.1)
    with pytest.raises(ValueError, match="per-channel"):
        TB.bn_forward(x, gamma.bfloat16(), beta, rm, rv, 0.1)
    with pytest.raises(ValueError, match="per-channel"):
        TB.bn_forward(x, gamma[:16], beta, rm, rv, 0.1)
    _, ws = TB.bn_forward(x, gamma, beta, rm, rv, 0.1)
    with pytest.raises(ValueError, match="channels_last"):
        TB.bn_backward(x, dy.contiguous(), ws)
    with pytest.raises(ValueError, match="do not match"):
        TB.bn_backward(x, dy.float(), ws)
    assert (TB.fwd_launches, TB.bwd_launches) == (before[0] + 1, before[1])


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
