"""PyTorch port: the fused 3x3 conv (ops/conv3x3.py, K4) and its A/B entry
point on the CPU. On a CPU tensor `conv3x3` is its plain version, held here
to the JAX Pallas kernel run by the Mosaic interpreter, as
tests/test_conv3x3.py runs it, and to an independent float64 convolution.
The CUDA kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
from pidnet_tpu.ops.conv3x3 import conv3x3 as jax_conv3x3
from pidnet_tpu_torch.ops import conv3x3 as K
from pidnet_tpu_torch.ops import _build
from pidnet_tpu_torch.tools import conv_ab, conv_ablate

torch.set_num_threads(2)


def _inputs(rng, n, h, w, cin, cout=None):
    cout = cout or cin
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, cin, cout)) * 0.02).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    return x, wt, b


def _stats_tol(y32: np.ndarray) -> np.ndarray:
    """Tolerance of [sum y, sum y^2]: rtol 2e-5 of the sum of magnitudes,
    the scale of the fp32 rounding (equal to |sum y| when the ReLU leaves
    no negative value)."""
    flat = y32.reshape(-1, y32.shape[-1]).astype(np.float64)
    return 2e-5 * np.stack([np.abs(flat).sum(0), (flat * flat).sum(0)])


@pytest.mark.parametrize(
    "n,h,w,c,tile_h,epilogue",
    [
        (2, 32, 32, 128, 8, dict(bias=True, relu=True, stats=True)),  # P/D stage, scaled down
        (1, 16, 16, 256, 16, dict(bias=False, relu=False, stats=False)),  # layer4-like
        (1, 16, 24, 128, 8, dict(bias=False, relu=False, stats=False)),  # W not a tile multiple
    ],
)
def test_conv3x3_matches_jax_kernel(rng, n, h, w, c, tile_h, epilogue):
    """y within one bf16 ulp at unit magnitude (atol 0.0079, rtol 0.01: the
    two sum the taps in other orders in fp32); stats at rtol 2e-5."""
    x, wt, b = _inputs(rng, n, h, w, c)
    xj, wj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(wt, jnp.bfloat16)
    bj = jnp.asarray(b) if epilogue["bias"] else None
    with pltpu.force_tpu_interpret_mode():
        want = jax_conv3x3(xj, wj, bj, relu=epilogue["relu"], stats=epilogue["stats"],
                           tile_h=tile_h)
    got = K.conv3x3(torch.from_numpy(x), torch.from_numpy(wt),
                    torch.from_numpy(b) if epilogue["bias"] else None,
                    relu=epilogue["relu"], stats=epilogue["stats"])
    if epilogue["stats"]:
        (got, got_st), (want, want_st) = got, want
        np.testing.assert_allclose(got_st.numpy(), np.asarray(want_st), rtol=2e-5)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (n, h, w, c)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=0.0079,
                               rtol=0.01)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", [(2, 8, 12, 64, 128), (1, 5, 3, 128, 256), (1, 1, 1, 64, 128)])
def test_plain_version_matches_float64_conv(rng, shape, relu):
    """The plain version with out_dtype=fp32 against F.conv2d in float64 on
    the same bf16-rounded inputs (OIHW from HWIO, asymmetric seeded
    weights, so a swapped tap or channel axis fails): y within 1e-5, the
    statistics within 2e-5 of their magnitudes."""
    n, h, w, cin, cout = shape
    x, wt, b = _inputs(rng, n, h, w, cin, cout)
    xr = torch.from_numpy(x).to(torch.bfloat16).double()
    wr = torch.from_numpy(wt).to(torch.bfloat16).double()
    want = F.conv2d(xr.permute(0, 3, 1, 2), wr.permute(3, 2, 0, 1), padding=1)
    want = want.permute(0, 2, 3, 1) + torch.from_numpy(b).double()
    if relu:
        want = want.clamp(min=0)
    y, st = K.conv3x3(torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(b), relu=relu,
                      stats=True, out_dtype=torch.float32)
    assert y.dtype == torch.float32 and st.dtype == torch.float32 and tuple(st.shape) == (2, cout)
    np.testing.assert_allclose(y.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
    flat = want.reshape(-1, cout)
    want_st = torch.stack([flat.sum(0), (flat * flat).sum(0)]).numpy()
    assert np.all(np.abs(st.numpy() - want_st) <= _stats_tol(want.numpy()) + 1e-6)


def test_bf16_output_is_the_rounded_fp32_output(rng):
    x, wt, b = _inputs(rng, 1, 6, 10, 64, 128)
    args = (torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(b))
    y16, st16 = K.conv3x3(*args, relu=True, stats=True)
    y32, st32 = K.conv3x3(*args, relu=True, stats=True, out_dtype=torch.float32)
    assert torch.equal(y16, y32.to(torch.bfloat16)) and torch.equal(st16, st32)


def test_wrapper_runs_the_plain_version_on_the_cpu(rng):
    """A CPU tensor never reaches the kernel: no launch is counted."""
    x, wt, _ = _inputs(rng, 1, 4, 4, 96)
    before = K.launches
    y = K.conv3x3(torch.from_numpy(x), torch.from_numpy(wt))
    assert K.launches == before and tuple(y.shape) == (1, 4, 4, 96)


def test_conv_ab_runs_every_mode_on_the_cpu():
    """The A/B entry point's function at a tiny shape on the CPU: every mode
    through the plain version and F.conv2d, and the number of calls it made
    through the wrapper."""
    rows, calls = conv_ab.run("cpu", shapes=[("tiny", 1, 8, 16, 128)], batches=1, per_batch=1)
    assert [r[2] for r in rows] == list(conv_ab.MODES)
    assert calls == len(rows) * (1 + 3 + 1)
    for name, shape, mode, t_kernel, t_lib, gflop, err in rows:
        assert shape == (1, 8, 16, 128) and t_kernel > 0 and t_lib > 0
        assert gflop == pytest.approx(2 * 8 * 16 * 9 * 128 * 128 / 1e9)
        assert err <= 0.07  # bf16 library output, and its bias added in bf16
        assert "of bf16 peak" not in conv_ab.format_row(rows[0], torch.device("cpu"))
    assert [s[1:] for s in conv_ab.SHAPES] == [(8, 128, 128, 128), (8, 32, 32, 256),
                                              (8, 16, 16, 512)]


@pytest.mark.parametrize(
    "n,h,w,cin,cout",
    [(n, h, w, c, c) for n, h, w, c in chip_smoke.CONV_CASES]
    + [(1, 1, 7, 64, 128), (3, 9, 24, 64, 256), (2, 1, 300, 128, 128), (1, 200, 17, 64, 128)],
)
def test_tile_plan_covers_every_output_once(n, h, w, cin, cout):
    """The kernel's tile plan (`_plan`, what the wrapper passes to the
    kernel), decoded as the kernel decodes block x (column tile x %
    tiles_x, row tile (x // tiles_x) % tiles_y, image x // (tiles_x *
    tiles_y)) and clipped at the image's edge as its epilogue masks: every
    output pixel and channel belongs to exactly one block, no block is
    empty, TW x TH = 128, every TMA box dimension is at most 256, and the
    grid has at least 128 blocks wherever the shape has 128 tiles of 64
    channels."""
    th, tw, bn, stages, (grid_x, grid_y) = K._plan(n, h, w, cin, cout)
    assert th * tw == 128 and tw in (16, 32, 64, 128) and bn in (64, 128)
    assert stages == K.STAGES and 3 <= stages <= 5
    assert max(64, tw, th, 1) <= 256  # x box (64, TW, TH, 1); w box (64, 64)
    tiles_x, tiles_y = -(-w // tw), -(-h // th)
    assert grid_x == n * tiles_x * tiles_y and grid_y * bn == cout
    pixels = np.zeros((n, h, w), np.int64)
    for bx in range(grid_x):
        tx, rest = bx % tiles_x, bx // tiles_x
        ty, img = rest % tiles_y, rest // tiles_y
        y0, x0 = ty * th, tx * tw
        assert img < n and y0 < h and x0 < w
        pixels[img, y0:y0 + th, x0:x0 + tw] += 1
    channels = np.zeros(cout, np.int64)
    for by in range(grid_y):
        channels[by * bn:(by + 1) * bn] += 1
    assert (pixels == 1).all() and (channels == 1).all()
    if grid_x * cout // 64 >= 128:
        assert grid_x * grid_y >= 128


@pytest.mark.parametrize("n,h,w,cin,cout", [(1, 5, 24, 64, 128), (2, 3, 40, 128, 256),
                                        (1, 2, 130, 64, 128), (132, 8, 16, 64, 128)])
def test_tile_plan_and_loads_reproduce_the_conv(rng, n, h, w, cin, cout):
    """The kernel's indexing, emulated in float64: for each block of the
    plan (BN = 64, and 128 in the last case) and each K step (tap, 64 input
    channels), the A box of x at (c0, x0+dx-1, y0+dy-1, n) with zeros
    outside the image, flattened to rows th*TW + tw, times the B boxes of w
    viewed as (9*Cin, Cout) at rows tap*Cin + c0 and columns n0 + 64 j; the
    tile's pixels inside the image are stored. The result is the plain
    version's conv."""
    x, wt, _ = _inputs(rng, n, h, w, cin, cout)
    th, tw, bn, _, (grid_x, grid_y) = K._plan(n, h, w, cin, cout)
    xr = torch.from_numpy(x).to(torch.bfloat16).double().numpy()
    xz = np.pad(xr, ((0, 0), (1, th + 1), (1, tw + 1), (0, 0)))  # TMA's zero fill
    w2 = torch.from_numpy(wt).to(torch.bfloat16).double().numpy().reshape(9 * cin, cout)
    tiles_x, tiles_y = -(-w // tw), -(-h // th)
    y = np.full((n, h, w, cout), np.nan)
    for bx in range(grid_x):
        tx, rest = bx % tiles_x, bx // tiles_x
        ty, img = rest % tiles_y, rest // tiles_y
        y0, x0 = ty * th, tx * tw
        for by in range(grid_y):
            n0 = by * bn
            acc = np.zeros((th * tw, bn))
            for tap in range(9):
                dy, dx = divmod(tap, 3)
                for c0 in range(0, cin, 64):
                    box = xz[img, y0 + dy:y0 + dy + th, x0 + dx:x0 + dx + tw, c0:c0 + 64]
                    b = np.concatenate([w2[tap * cin + c0:tap * cin + c0 + 64,
                                           n0 + 64 * j:n0 + 64 * j + 64]
                                        for j in range(bn // 64)], axis=1)
                    acc += box.reshape(th * tw, 64) @ b
            acc = acc.reshape(th, tw, bn)[:h - y0, :w - x0]
            y[img, y0:y0 + th, x0:x0 + tw, n0:n0 + bn] = acc
    want = K.conv3x3(torch.from_numpy(x), torch.from_numpy(wt), out_dtype=torch.float32)
    assert bn == (128 if n == 132 else 64)
    np.testing.assert_allclose(y, want.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", sorted(conv_ablate.VARIANTS))
def test_conv_ablate_edits_match_the_kernel_source(name):
    """Each ablation of tools/conv_ablate.py edits the kernel's current
    source where it means to (each edit matches exactly once), and only the
    full variant is the source itself."""
    src = conv_ablate.variant_source(name)
    assert (src == (_build.CSRC / "conv3x3.cu").read_text()) == (name == "full")


def test_conv_ab_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        conv_ab.main([])
