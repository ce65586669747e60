"""PyTorch port: the fused upsample + argmax (ops/upsample_argmax.py) on the
CPU. The walk's plan is checked block by block, and the walk's arithmetic
(`_walk_argmax`: its staged window, W-lerped rows, one FMA a class, the
running (max, slot), the lanes' merge) is held
against the plain version and against the JAX package's XLA
resize+argmax on the same seeded numpy inputs. The CUDA kernel itself is
held to the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pidnet_tpu.ops import resize as JR
from pidnet_tpu.ops import upsample_argmax as JU
from pidnet_tpu_torch.ops import _build
from pidnet_tpu_torch.ops import _walk
from pidnet_tpu_torch.ops import upsample_argmax as TU
from pidnet_tpu_torch.ops.resize import source_taps
from pidnet_tpu_torch.tools import ua_ablate

torch.set_num_threads(2)

# (h, w) -> (OH, OW): the 8x test size, CamVid, the serving shape, two
# identity sizes, a 1x1 output and a downsample
PLAN_CASES = [((16, 16), (128, 128)), ((90, 120), (720, 960)), ((128, 256), (1024, 2048)),
              ((128, 256), (128, 256)), ((16, 16), (16, 16)), ((5, 7), (1, 1)),
              ((64, 64), (16, 16))]


@pytest.mark.parametrize("c", [3, 19, 100, 1024])
@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("hw,out_hw", PLAN_CASES)
def test_plan_writes_every_pixel_once(hw, out_hw, align, c):
    """The walk's blocks: bands of output rows times tiles of output columns
    own every output pixel exactly once; each block's staged source rows
    and columns hold every tap of its pixels, and its window has room for
    them and for the two more rows and columns that the device's float32
    taps may reach; the threads fit; the shared memory is the staged
    window's in fp32 and fits the opt-in. Only the downsample at 1024
    classes needs a window larger than the opt-in, and goes to the direct
    kernel."""
    (h, w), (oh, ow) = hw, out_hw
    plan = TU.plan(2, h, w, c, oh, ow, align)
    if plan is None:
        assert c == 1024 and oh < h
        return
    assert plan.smem == _walk.stage_bytes(c, plan.window, plan.lpp, 4)
    assert plan.smem <= _walk.SMEM_OPT_IN and plan.band <= 64
    assert plan.lpp == _walk.lanes_per_pixel(c, "test") and plan.lpp * 32 >= c
    assert plan.tile * plan.lpp <= plan.threads <= _walk.THREADS and plan.threads % 32 == 0
    assert plan.blocks == 2 * len(plan.rows) * len(plan.cols)
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


@pytest.mark.parametrize("n,out_hw", [(1, (1024, 2048)), (2, (1024, 2048))])
def test_plan_fills_the_card(n, out_hw):
    """At the serving shape (one image: 2.1 M pixels) and the eval shape the
    grid still gives each of the H100's 132 SMs two blocks of 256 threads,
    and four blocks fit an SM's shared memory."""
    plan = TU.plan(n, 128, 256, 19, *out_hw, True)
    assert plan.blocks >= 2 * 132 and plan.threads == 256 and 4 * plan.smem <= 227 * 1024
    assert n > 1 or plan.band <= 16


def test_more_than_1024_classes_go_to_the_direct_kernel():
    assert TU.plan(1, 4, 4, 1024, 8, 8, True) is not None
    assert TU.plan(1, 4, 4, 1025, 8, 8, True) is None


def _take(v, k, ov, ok):
    """The kernel's merge of lanes: the larger value, the lower class on a
    tie."""
    t = (ov > v) | ((ov == v) & (ok < k))
    return torch.where(t, ov, v), torch.where(t, ok, k)


def _walk_argmax(logits: np.ndarray, out_hw, align: bool) -> np.ndarray:
    """The walk kernel's arithmetic on its plan, in fp32 torch: block by
    block, the window staged with classes padded to lane slices (slot j of
    lane l holds class l + lpp j), column by column (vectorised over the
    tile), row by row with the W-lerped source rows reused while y0 stays;
    per pixel z = top + h1 dif into a running (max, slot) with a strict >
    in slot order, then the lanes merged by the xor butterfly, keeping the
    lower class on a tie. The host's taps stand in for the device's."""
    n, h, w, c = logits.shape
    oh, ow = out_hw
    plan = TU.plan(n, h, w, c, oh, ow, align)
    lpp = plan.lpp
    cb = _walk.class_slice(c, lpp)
    cs = lpp * cb
    slot = torch.arange(cs)
    cls = slot // cb + lpp * (slot % cb)  # the class of each slot
    real = (cls < c).view(lpp, cb)
    lanes = torch.arange(lpp)
    i0, i1, l1 = source_taps(h, oh, align)
    j0, j1, m1 = source_taps(w, ow, align)
    x = torch.from_numpy(logits)
    out = torch.full((n, oh, ow), -1, dtype=torch.int64)
    for b in range(n):
        for (ya, yb), (r0, r1) in zip(plan.rows, plan.src_rows):
            for (xa, xb), (q0, q1) in zip(plan.cols, plan.src_cols):
                stage = torch.zeros((r1 - r0, q1 - q0, cs))
                stage[..., cls < c] = x[b, r0:r1, q0:q1][..., cls[cls < c]]
                stage = stage.view(r1 - r0, q1 - q0, lpp, cb)
                left = torch.from_numpy(j0[xa:xb] - q0)
                right = torch.from_numpy(j1[xa:xb] - q0)
                assert left.min() >= 0 and right.max() < q1 - q0
                wl1 = torch.from_numpy(m1[xa:xb])[:, None, None]
                cur = -1
                for y in range(ya, yb):
                    assert r0 <= i0[y] and i1[y] < r1
                    if i0[y] != cur:
                        row0, row1 = stage[i0[y] - r0], stage[i1[y] - r0]
                        top = (1 - wl1) * row0[left] + wl1 * row0[right]
                        bot = (1 - wl1) * row1[left] + wl1 * row1[right]
                        dif = torch.where(real, bot - top, 0.0)
                        top = torch.where(real, top, -torch.inf)
                        cur = i0[y]
                    z = top + float(l1[y]) * dif  # (columns, lpp, cb)
                    best = z[..., 0].clone()  # (columns, lpp)
                    slot_of = torch.zeros(best.shape, dtype=torch.int64)
                    for k in range(1, cb):
                        gt = z[..., k] > best
                        best = torch.where(gt, z[..., k], best)
                        slot_of = torch.where(gt, k, slot_of)
                    klass = lanes + lpp * slot_of
                    bit = 1
                    while bit < lpp:
                        partner = lanes ^ bit
                        best, klass = _take(best, klass, best[:, partner], klass[:, partner])
                        bit <<= 1
                    assert (out[b, y, xa:xb] == -1).all()
                    out[b, y, xa:xb] = klass[:, 0]
    assert (out >= 0).all() and (out < c).all()
    return out.to(torch.int32).numpy()


def _margin(x: np.ndarray, out_hw, align: bool) -> np.ndarray:
    """The fp32 top-2 margin of the JAX package's exact upsample (infinite
    for one class)."""
    up = np.sort(np.asarray(JR.resize_bilinear(jnp.asarray(x), out_hw, align)), axis=-1)
    if up.shape[-1] == 1:
        return np.full(up.shape[:-1], np.inf, np.float32)
    return up[..., -1] - up[..., -2]


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("shape,out_hw", [((2, 16, 32, 19), (128, 256)),
                                          ((1, 9, 12, 11), (72, 96)),
                                          ((1, 8, 16, 19), (8, 16)),
                                          ((1, 5, 7, 3), (1, 1)),
                                          ((1, 64, 64, 19), (16, 16)),
                                          ((1, 4, 4, 1), (16, 16)),
                                          ((1, 8, 8, 40), (64, 64)),
                                          ((1, 8, 8, 100), (32, 32))])
def test_walk_matches_plain_and_jax(shape, out_hw, align):
    """The walk (_walk_argmax) against upsample_argmax_plain and the JAX
    package's `_xla_upsample_argmax`: >= 0.9999 agreement, and exact
    wherever the fp32 top-2 margin exceeds 1e-4 (the sums differ by ulps),
    as test_upsample_argmax_plain_matches_xla. One class, the identity, a
    1x1 output and a downsample included; 40 and 100 classes take two and
    four lanes a pixel."""
    x = (np.random.default_rng(12).standard_normal(shape) * 2).astype(np.float32)
    got = _walk_argmax(x, out_hw, align)
    plain = TU.upsample_argmax_plain(torch.from_numpy(x), out_hw, align).numpy()
    xla = np.asarray(JU._xla_upsample_argmax(jnp.asarray(x), out_hw, align))
    sure = _margin(x, out_hw, align) > 1e-4
    for want in (plain, xla):
        assert got.shape == want.shape == (shape[0], *out_hw)
        assert (got == want).mean() >= 0.9999
        np.testing.assert_array_equal(got[sure], want[sure])


def tied_logits(shape, tied, seed=6, field=True) -> np.ndarray:
    """Seeded logits in [-2, -1) but for the `tied` classes, which share one
    field in [0, 1) (or 0 everywhere, with field=False): their upsampled
    values are equal, bit for bit, wherever each class is lerped by the
    same arithmetic, and above every other class at every output pixel."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, -1, shape).astype(np.float32)
    x[..., list(tied)] = rng.uniform(0, 1, shape[:-1] + (1,)) if field else 0.0
    return x


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("c,tied", [(19, (2, 7)), (19, (3, 11)), (100, (5, 6)),
                                    (100, (2, 97))])
def test_ties_go_to_the_lowest_class(c, tied, align):
    """Equal maxima in classes 5 apart (2 and 7) and 8 apart (3 and 11) of
    one lane's running compare, and in different lanes at 100 classes (5
    and 6; 2 and 97): the walk gives the lower class at every pixel, on a shared
    random field and on a zero field; the plain version and the JAX
    package do on the zero field (CPU F.interpolate lerps some channels in
    vector lanes and others in a scalar tail, which round apart by an ulp,
    so a random field ties there only where it happens to)."""
    want = np.full((1, 64, 128), min(tied))
    for field in (True, False):
        x = tied_logits((1, 8, 16, c), tied, field=field)
        np.testing.assert_array_equal(_walk_argmax(x, (64, 128), align), want)
    np.testing.assert_array_equal(
        TU.upsample_argmax_plain(torch.from_numpy(x), (64, 128), align).numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(JU._xla_upsample_argmax(jnp.asarray(x), (64, 128), align)), want)


@pytest.mark.parametrize("name", sorted(ua_ablate.VARIANTS))
def test_ua_ablate_edits_match_the_kernel_source(name):
    """Each ablation of tools/ua_ablate.py edits the kernel's current source
    where it means to (each edit matches exactly once), and only the full
    variant is the source itself."""
    src = ua_ablate.variant_source(name)
    assert (src == (_build.CSRC / "upsample_argmax.cu").read_text()) == (name == "full")
