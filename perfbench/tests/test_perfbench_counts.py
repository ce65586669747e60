"""The yardstick's arithmetic against hand counts."""

import pytest

from perfbench.harness import counts, readers, trace


def test_one_conv_by_hand():
    """A 3x3/s2 conv of 3 -> 32 channels on a (2, 3, 64, 128) image is the
    stem's first: 2 x 32 x 32 x 64 outputs x 3 x 9 MACs."""
    config = {"family": "pidnet", "m": 2, "n": 3, "planes": 32, "ppm_planes": 96,
              "head_planes": 128, "num_classes": 19}
    macs = counts.conv_macs(config, False, 2, 64, 128)
    name, first, is_image = macs[0]
    assert (name, is_image) == ("conv1.0", True)
    assert first == 2 * 32 * 32 * 64 * 3 * 9
    assert all(not image for _, _, image in macs[1:])
    total = sum(m for _, m, _ in macs)
    assert counts.forward_flops(config, False, 2, 64, 128) == 2 * total
    assert counts.train_flops(config, 2, 64, 128) == 2 * (
        3 * sum(m for _, m, _ in counts.conv_macs(config, True, 2, 64, 128)) - first)


def test_published_model_sizes():
    """PIDNet-S and -L at 2048x1024: 47.6 and 275.8 GMACs in the paper."""
    s = {"family": "pidnet", "m": 2, "n": 3, "planes": 32, "ppm_planes": 96, "head_planes": 128,
         "num_classes": 19}
    l_ = {**s, "m": 3, "n": 4, "planes": 64, "ppm_planes": 112, "head_planes": 256}
    assert counts.forward_flops(s, False, 1, 1024, 2048) / 2e9 == pytest.approx(47.6, rel=0.02)
    assert counts.forward_flops(l_, False, 1, 1024, 2048) / 2e9 == pytest.approx(275.8, rel=0.02)


def test_k1_bound_by_hand():
    """(16,128,256,19) bf16 -> (1024,2048): 19.9 MB of logits and 134.2 MB
    of map bound it by bytes at 3.35 TB/s."""
    t, by = counts.upsample_argmax_bound_s((16, 128, 256, 19), (1024, 2048), 2)
    nbytes = 16 * 128 * 256 * 19 * 2 + 16 * 1024 * 2048 * 4
    assert by == "bytes" and t == pytest.approx(nbytes / 3.35e12)


@pytest.mark.parametrize("backward", [False, True])
def test_k2_k3_bounds_by_hand(backward):
    """(12,128,128,19) bf16 -> (1024,1024) with 11 M counted pixels: the
    exps bind (20 a pixel at 16 an SM a clock)."""
    counted = 11_000_000
    t, by = counts.ce_bound_s((12, 128, 128, 19), (1024, 1024), 2, counted, backward)
    assert by == "operations"
    assert t == pytest.approx(counted * 20 / (132 * 16 * 1.98e9))
    t0, by0 = counts.ce_bound_s((12, 128, 128, 19), (1024, 1024), 2, 0, backward)
    pixels = 12 * 1024 * 1024
    logits = 12 * 128 * 128 * 19 * 2
    nbytes = 2 * logits + 2 * pixels * 4 if backward else logits + pixels * 4 + 76 + 2 * pixels * 4
    assert by0 == "bytes" and t0 == pytest.approx(nbytes / 3.35e12)


def test_trace_reading():
    """Union of the card's activity inside the window, gaps named after
    the innermost host operation at their middle."""
    events = [
        {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 0, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::outer", "ts": 0, "dur": 60},
        {"ph": "X", "cat": "cpu_op", "name": "aten::inner", "ts": 20, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 5, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "k_b", "ts": 15, "dur": 5},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 40, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 90, "dur": 20},
    ]
    r = trace.read(events)
    assert r["busy_s"] == pytest.approx((20 + 10 + 10) * 1e-6)
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["kernels"]["k_a"] == [pytest.approx(30e-6), 2]
    assert [g[0] for g in r["idle_gaps"]] == ["host_idle", "aten::inner", "aten::outer"]
    assert trace.kernel_seconds(r, "k_") == (pytest.approx(35e-6), 3)
    run = type("Run", (), {"trace": r})()
    assert readers.idle_pct(run) == pytest.approx(60.0)
    assert readers.roofline_pct(run, "k_b", 2.5e-6) == pytest.approx(50.0)
    assert readers.roofline_pct(run, "absent", 1e-6) is None
