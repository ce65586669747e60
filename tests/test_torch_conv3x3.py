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

from pidnet_tpu.ops.conv3x3 import conv3x3 as jax_conv3x3
from pidnet_tpu_torch.ops import conv3x3 as K
from pidnet_tpu_torch.tools import conv_ab

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


def test_conv_ab_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        conv_ab.main([])
