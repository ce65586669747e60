"""PyTorch port: the fused upsample + CE loss front (ops/ce_front.py) on the
CPU against the JAX package's ce_maps (its Pallas kernels in interpret
mode for bf16 logits, its XLA path for fp32), from the same seeded numpy
inputs. On the CPU the port runs its plain versions; the CUDA kernels are
held to those on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pidnet_tpu.ops import ce_front as JC
from pidnet_tpu_torch.ops import _build
from pidnet_tpu_torch.ops import ce_front as TC
from pidnet_tpu_torch.ops.resize import _interp_matrix, source_taps
from pidnet_tpu_torch.tools import ce_bwd_ablate, ce_fwd_ablate

torch.set_num_threads(2)

# (N, h, w, C) -> (OH, OW): tests/test_ce_front.py's two shapes
SHAPES = [((2, 16, 16, 19), (128, 128)), ((2, 16, 24, 11), (120, 96))]


def _case(shape, out_hw, seed=304):
    rng = np.random.default_rng(seed)
    n, _, _, c = shape
    logits = (rng.standard_normal(shape) * 2).astype(np.float32)
    labels = rng.integers(0, c + 2, (n, *out_hw)).astype(np.int32)
    labels = np.where(labels >= c, 255, labels)  # some ignore pixels
    cw = (0.8 + rng.random(c)).astype(np.float32)
    return logits, labels, cw


def _port(logits, labels, cw, out_hw, align, dtype=torch.float32):
    """(nll, w, d(sum(nll*w)/sum(w))/dlogits) of the port, as numpy."""
    x = torch.from_numpy(logits).to(dtype).requires_grad_()
    nll, w = TC.ce_maps(x, torch.from_numpy(labels), cw, 255, out_hw, align)
    ((nll * w).sum() / w.sum()).backward()
    return nll.detach().numpy(), w.numpy(), x.grad.float().numpy()


def _jax(fn, logits, labels, cw, out_hw, align, dtype=jnp.float32):
    def loss(lg):
        n_, w_ = fn(lg, labels, cw, 255, out_hw, align)
        return jnp.sum(n_ * w_) / jnp.sum(w_), (n_, w_)

    (_, (nll, w)), g = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(logits, dtype))
    return np.asarray(nll), np.asarray(w), np.asarray(g, np.float32)


def _cos(a, b):
    return float((a * b).sum() / np.sqrt((a ** 2).sum() * (b ** 2).sum()))


@pytest.mark.parametrize("shape,out_hw", SHAPES)
def test_bf16_matches_jax_kernel(shape, out_hw):
    """bf16 logits against the JAX Pallas kernels (interpret mode). That
    kernel builds its operators and W-interp scratch in bf16, the port
    lerps in fp32, so the nll bound is test_ce_front's (rtol = atol =
    0.05) and the gradient's is cos > 0.9999, max-abs <= 0.02 * max."""
    logits, labels, cw = _case(shape, out_hw)
    kernel = lambda *a: JC.ce_maps(*a, interpret=True)  # noqa: E731
    nll_j, w_j, g_j = _jax(kernel, logits, labels, cw, out_hw, True, jnp.bfloat16)
    nll_t, w_t, g_t = _port(logits, labels, cw, out_hw, True, torch.bfloat16)
    np.testing.assert_array_equal(w_t, w_j)
    ignored = labels == 255
    assert nll_t[ignored].max() == 0 == w_t[ignored].max()
    np.testing.assert_allclose(nll_t, nll_j, rtol=0.05, atol=0.05)
    assert _cos(g_t, g_j) > 0.9999
    assert np.abs(g_t - g_j).max() <= 0.02 * np.abs(g_j).max()


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("shape,out_hw", SHAPES + [((2, 16, 24, 11), (16, 24))])
def test_fp32_matches_jax_xla(shape, out_hw, align):
    """fp32 logits against the JAX XLA path (`_xla_ce_maps` and its
    autodiff), both align_corners modes and the identity size: w exact,
    nll within 1e-5, gradient within rtol 1e-4."""
    logits, labels, cw = _case(shape, out_hw)
    nll_j, w_j, g_j = _jax(JC._xla_ce_maps, logits, labels, cw, out_hw, align)
    nll_t, w_t, g_t = _port(logits, labels, cw, out_hw, align)
    np.testing.assert_array_equal(w_t, w_j)
    np.testing.assert_allclose(nll_t, nll_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g_t, g_j, rtol=1e-4, atol=1e-6 * np.abs(g_j).max())


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("shape,out_hw", SHAPES + [((1, 5, 7, 3), (1, 1)),
                                                   ((2, 16, 24, 11), (16, 24))])
def test_bwd_plain_is_autograd_of_fwd_plain(shape, out_hw, align):
    """The explicit A^T (g (softmax - onehot)) B of ce_front_bwd_plain
    against torch autograd of ce_front_fwd_plain (rtol 1e-5)."""
    logits, labels, cw = _case(shape, out_hw)
    g = np.random.default_rng(1).random((shape[0], *out_hw)).astype(np.float32)
    x = torch.from_numpy(logits).requires_grad_()
    lab = torch.from_numpy(labels)
    nll, _ = TC.ce_front_fwd_plain(x, lab, cw, 255, out_hw, align)
    (want,) = torch.autograd.grad(nll, x, torch.from_numpy(g))
    got = TC.ce_front_bwd_plain(x.detach(), lab, 255, out_hw, align, torch.from_numpy(g))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6 * float(want.abs().max()))


def test_labels_outside_classes_follow_the_xla_oracle():
    """A label neither ignore nor in [0, C) gives nll 0, w 0 and no
    gradient, as `_per_pixel_ce` (the JAX XLA path) does; the JAX Pallas
    kernel would write nll = logsumexp there (a reference quirk)."""
    shape, out_hw = (1, 8, 8, 5), (32, 32)
    logits, labels, cw = _case(shape, out_hw)
    labels[0, :4] = 7
    labels[0, 4:8] = -3
    nll_j, w_j, g_j = _jax(JC._xla_ce_maps, logits, labels, cw, out_hw, True)
    nll_t, w_t, g_t = _port(logits, labels, cw, out_hw, True)
    assert not nll_t[0, :8].any() and not w_t[0, :8].any()
    np.testing.assert_array_equal(w_t, w_j)
    np.testing.assert_allclose(nll_t, nll_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g_t, g_j, rtol=1e-4, atol=1e-6 * np.abs(g_j).max())


def test_cpu_runs_the_plain_versions_and_other_devices_raise():
    logits, labels, cw = _case((1, 4, 4, 3), (8, 8))
    before = (TC.fwd_launches, TC.bwd_launches)
    x = torch.from_numpy(logits).requires_grad_()
    nll, w = TC.ce_maps(x, torch.from_numpy(labels), None, 255, (8, 8), True)
    nll.sum().backward()
    assert (TC.fwd_launches, TC.bwd_launches) == before
    assert set(np.unique(w.numpy())) <= {0.0, 1.0} and not w.requires_grad
    meta = torch.empty((1, 4, 4, 3), device="meta")
    lab = torch.empty((1, 8, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        TC.ce_front_fwd(meta, lab, cw, 255, (8, 8), True)
    with pytest.raises(ValueError, match="device"):
        TC.ce_front_bwd(meta, lab, 255, (8, 8), True, torch.empty((1, 8, 8), device="meta"))


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("hw,out_hw,c", [((128, 128), (1024, 1024), 19),
                                         ((90, 120), (720, 960), 11),
                                         ((128, 128), (128, 128), 19),
                                         ((16, 24), (120, 96), 11),
                                         ((64, 64), (16, 16), 19),
                                         ((5, 7), (1, 1), 3),
                                         ((16, 512), (128, 4096), 19)])
def test_backward_plan_counts_every_tap_once(hw, out_hw, c, align):
    """The backward kernel's decomposition (backward_plan), walked in
    torch on the CPU: each band of source rows and tile of source columns
    adds, over its output rows and columns, only the taps inside the band
    and the tile, and writes its part of dL once. Assembled, dL equals
    ce_front_bwd_plain within 1e-5 of its largest value, so every tap is
    counted exactly once, halo rows and columns included; every row and
    column a block walks has a tap in its band or tile; each block's
    shared memory fits the 227 KB opt-in. The last shape forces column
    tiles."""
    (h, w), (oh, ow) = hw, out_hw
    plan = TC.backward_plan(1, h, w, c, oh, ow, align, 2)
    assert plan.smem <= TC.SMEM_OPT_IN
    assert plan.blocks == len(plan.rows) * len(plan.cols)
    assert (plan.cols[:, 1] - plan.cols[:, 0]).max() + 2 == plan.xw
    logits, labels, _ = _case((1, h, w, c), out_hw)
    g = torch.from_numpy(np.random.default_rng(2).random((1, oh, ow)).astype(np.float32))
    x, lab = torch.from_numpy(logits), torch.from_numpy(labels).long()
    want = TC.ce_front_bwd_plain(x, lab, 255, out_hw, align, g)[0]

    p = torch.softmax(TC._z(x, out_hw, align), dim=-1)[0]
    counted = (lab[0] != 255) & (lab[0] >= 0) & (lab[0] < c)
    onehot = torch.nn.functional.one_hot(torch.where(counted, lab[0], 0), c).float()
    dz = torch.where(counted, g[0], 0.0)[..., None] * (p - onehot)
    a = torch.from_numpy(_interp_matrix(h, oh, align))
    b = torch.from_numpy(_interp_matrix(w, ow, align))
    got = torch.zeros((h, w, c))
    writes = torch.zeros((h, w), dtype=torch.int64)
    for i0, (ya, yb) in zip(range(0, h, plan.band), plan.rows):
        i1 = min(i0 + plan.band, h)
        a_band = a[ya:yb, i0:i1]
        assert (a_band != 0).any(dim=1).all()
        for j0, (xa, xb) in zip(range(0, w, plan.tile), plan.cols):
            j1 = min(j0 + plan.tile, w)
            b_tile = b[xa:xb, j0:j1]
            assert (b_tile != 0).any(dim=1).all()
            got[i0:i1, j0:j1] = torch.einsum("yi,yxc,xj->ijc", a_band, dz[ya:yb, xa:xb], b_tile)
            writes[i0:i1, j0:j1] += 1
    assert bool((writes == 1).all())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("name", sorted(ce_bwd_ablate.VARIANTS))
def test_ce_bwd_ablate_edits_match_the_kernel_source(name):
    """Each ablation of tools/ce_bwd_ablate.py edits the backward kernel's
    current source where it means to (each edit matches exactly once), and
    only the full variant is the source itself."""
    src = ce_bwd_ablate.variant_source(name)
    assert (src == (_build.CSRC / "ce_front.cu").read_text()) == (name == "full")


# (h, w) -> (OH, OW) of the forward plan: the two test shapes, CamVid, the
# eval shape, a downsample, a 1x1 output and an identity size
FWD_PLAN_CASES = [((16, 16), (128, 128)), ((16, 24), (120, 96)), ((90, 120), (720, 960)),
                  ((128, 256), (1024, 2048)), ((64, 64), (16, 16)), ((5, 7), (1, 1)),
                  ((16, 16), (16, 16))]


def _fwd_layout_bytes(c, window, lpp, itemsize):
    """FwdLayout of csrc/ce_front.cu: the staged window, each pixel's
    classes in lpp slices of ceil(C / lpp) rounded up to 4, 16-byte
    aligned, then C fp32 class weights."""
    cb = (-(-c // lpp) + 3) // 4 * 4
    return (window * lpp * cb * itemsize + 15) // 16 * 16 + 4 * c


@pytest.mark.parametrize("c", [3, 19, 40, 100])
@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("hw,out_hw", FWD_PLAN_CASES)
def test_forward_plan_writes_every_pixel_once(hw, out_hw, align, c):
    """The forward kernel's blocks (forward_plan): bands of output rows
    times tiles of output columns own every output pixel exactly once; each
    block's staged source rows and columns hold every tap of its pixels,
    and its window has room for them and for the two more rows and columns
    that the device's float32 taps may reach; lpp is the fewest lanes that
    hold C in slices of 32; the threads fit; the shared memory equals the
    kernel's layout and fits the opt-in."""
    (h, w), (oh, ow) = hw, out_hw
    for itemsize in (2, 4):
        plan = TC.forward_plan(2, h, w, c, oh, ow, align, itemsize)
        assert plan.smem == _fwd_layout_bytes(c, plan.window, plan.lpp, itemsize)
        assert plan.smem <= TC.SMEM_OPT_IN
    assert plan.blocks == 2 * len(plan.rows) * len(plan.cols)
    assert plan.lpp * 32 >= c and (plan.lpp == 1 or plan.lpp * 16 < c)
    assert plan.tile * plan.lpp <= plan.threads <= TC.FWD_THREADS and plan.threads % 32 == 0
    writes = np.zeros((oh, ow), np.int64)
    for ya, yb in plan.rows:
        for xa, xb in plan.cols:
            writes[ya:yb, xa:xb] += 1
    assert (writes == 1).all()
    for (in_size, out_size), spans, src in (((h, oh), plan.rows, plan.src_rows),
                                           ((w, ow), plan.cols, plan.src_cols)):
        i0, i1, _ = source_taps(in_size, out_size, align)
        for (a, b), (s0, s1) in zip(spans, src):
            assert a < b and s0 <= i0[a:b].min() and i1[a:b].max() < s1 <= in_size
    nr = int((plan.src_rows[:, 1] - plan.src_rows[:, 0]).max())
    nq = int((plan.src_cols[:, 1] - plan.src_cols[:, 0]).max())
    assert min(nr + 2, h) * min(nq + 2, w) <= plan.window


@pytest.mark.parametrize("shape,out_hw", [((6, 128, 128, 19), (1024, 1024)),
                                          ((2, 128, 256, 19), (1024, 2048))])
def test_forward_plan_fills_the_card(shape, out_hw):
    """At the training and eval shapes the grid gives each of the H100's
    132 SMs at least two blocks of 256 threads, and a block fits three to
    an SM in shared memory."""
    plan = TC.forward_plan(*shape, *out_hw, True, 2)
    assert plan.blocks >= 2 * 132 and plan.threads == 256 and 3 * plan.smem <= 227 * 1024


def test_forward_plan_refuses_more_than_1024_classes():
    TC.forward_plan(1, 4, 4, 1024, 8, 8, True, 4)
    with pytest.raises(ValueError, match="1024"):
        TC.forward_plan(1, 4, 4, 1025, 8, 8, True, 4)


def _walk_forward(logits, labels, cw, out_hw, align):
    """The forward kernel's arithmetic on its plan, in fp32 torch: block by
    block, the window staged with classes padded to lane slices (slot j of
    lane l holds class l + lpp j), column by column (vectorised over the
    tile), row by row with the W-lerped source rows reused while y0 stays;
    per counted pixel z = top + h1 dif, the lanes' partial maxima then
    their max, one exp2 a real class, lg2 of the sum, z[label] lerped from
    the staged taps. The host's taps stand in for the device's."""
    n, h, w, c = logits.shape
    oh, ow = out_hw
    plan = TC.forward_plan(n, h, w, c, oh, ow, align, 4)
    cb = TC.class_slice(c, plan.lpp)
    cs = plan.lpp * cb
    slot = torch.arange(cs)
    cls = slot // cb + plan.lpp * (slot % cb)  # the class of each slot
    real = cls < c
    i0, i1, l1 = source_taps(h, oh, align)
    j0, j1, m1 = source_taps(w, ow, align)
    log2e = torch.tensor(1.4426950408889634)
    x, lab, cw = torch.from_numpy(logits), torch.from_numpy(labels).long(), torch.from_numpy(cw)
    nll = torch.full((n, oh, ow), float("nan"))
    wmap = torch.full((n, oh, ow), float("nan"))
    for b in range(n):
        for (ya, yb), (r0, r1) in zip(plan.rows, plan.src_rows):
            for (xa, xb), (q0, q1) in zip(plan.cols, plan.src_cols):
                stage = torch.zeros((r1 - r0, q1 - q0, cs))
                stage[..., real] = x[b, r0:r1, q0:q1][..., cls[real]]
                left = torch.from_numpy(j0[xa:xb] - q0)
                right = torch.from_numpy(j1[xa:xb] - q0)
                wl1 = torch.from_numpy(m1[xa:xb])[:, None]
                cur = -1
                for y in range(ya, yb):
                    row0, row1 = stage[i0[y] - r0], stage[i1[y] - r0]
                    if i0[y] != cur:
                        top = (1 - wl1) * row0[left] + wl1 * row0[right]
                        dif = torch.where(real, (1 - wl1) * row1[left] + wl1 * row1[right] - top,
                                          0.0)
                        top = torch.where(real, top, -torch.inf)
                        cur = i0[y]
                    z = top + float(l1[y]) * dif
                    m = z.view(-1, plan.lpp, cb).amax(-1).amax(-1)
                    e = torch.where(real, torch.exp2(z * log2e - (m * log2e)[:, None]), 0.0)
                    s = e.view(-1, plan.lpp, cb).sum(-1).sum(-1)
                    label = lab[b, y, xa:xb]
                    hit = (label != 255) & (label >= 0) & (label < c)
                    k = torch.where(hit, label, 0)
                    at = k % plan.lpp * cb + k // plan.lpp  # the slot of the label
                    tt = (1 - wl1[:, 0]) * row0[left, at] + wl1[:, 0] * row0[right, at]
                    tb = (1 - wl1[:, 0]) * row1[left, at] + wl1[:, 0] * row1[right, at]
                    zt = tt + float(l1[y]) * (tb - tt)
                    nll[b, y, xa:xb] = torch.where(hit, torch.log2(s) * np.log(2) + m - zt, 0.0)
                    wmap[b, y, xa:xb] = torch.where(hit, cw[k], 0.0)
    return nll.numpy(), wmap.numpy()


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("shape,out_hw", SHAPES + [((2, 16, 24, 11), (16, 24)),
                                                   ((1, 5, 7, 3), (1, 1)),
                                                   ((1, 64, 64, 19), (16, 16)),
                                                   ((1, 8, 8, 40), (64, 64))])
def test_forward_walk_matches_plain(shape, out_hw, align):
    """The walk of the forward plan (_walk_forward) against
    ce_front_fwd_plain in fp32 (w exact, nll within 1e-5) and against the
    JAX package's XLA ce_maps on the same seeded inputs at
    test_fp32_matches_jax_xla's tolerance; labels include the ignore label
    and labels outside [0, C), which give (0, 0). The 40-class case takes
    two lanes a pixel."""
    logits, labels, cw = _case(shape, out_hw)
    labels.reshape(-1)[:5] = [shape[-1], -2, shape[-1] + 7, 255, 0][:labels.size]
    nll, w = _walk_forward(logits, labels, cw, out_hw, align)
    nll_p, w_p = TC.ce_front_fwd_plain(torch.from_numpy(logits), torch.from_numpy(labels), cw,
                                       255, out_hw, align)
    np.testing.assert_array_equal(w, w_p.numpy())
    np.testing.assert_allclose(nll, nll_p.numpy(), rtol=0, atol=1e-5)
    nll_j, w_j = JC._xla_ce_maps(jnp.asarray(logits), labels, cw, 255, out_hw, align)
    np.testing.assert_array_equal(w, np.asarray(w_j))
    np.testing.assert_allclose(nll, np.asarray(nll_j), rtol=1e-5, atol=1e-5)
    inert = (labels == 255) | (labels < 0) | (labels >= shape[-1])
    assert not nll[inert].any() and not w[inert].any()


@pytest.mark.parametrize("name", sorted(ce_fwd_ablate.VARIANTS))
def test_ce_fwd_ablate_edits_match_the_kernel_source(name):
    """Each ablation of tools/ce_fwd_ablate.py edits the forward kernel's
    current source where it means to (each edit matches exactly once), and
    only the full variant is the source itself."""
    src = ce_fwd_ablate.variant_source(name)
    assert (src == (_build.CSRC / "ce_front.cu").read_text()) == (name == "full")
