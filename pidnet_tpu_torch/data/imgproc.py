"""The cv2 calls of the training pipeline, reproduced bit for bit in numpy.

The machine that trains the port has neither cv2 nor PIL, and the data
pipeline (data/transforms.py, the counterpart of pidnet_tpu/data/
transforms.py) must give the same label, edge and image bytes as the JAX
package's cv2 calls: a label that moves by one pixel changes the loss.
Each function here follows OpenCV's own arithmetic (resize.cpp, canny.cpp,
morph), not a float formula of the same idea:

- `canny_edges`: `cv2.Canny(img, 0.1, 0.2)`, the L1 gradient;
- `dilate`: `cv2.dilate(img, np.ones((k, k)))`, pixels outside ignored;
- `resize_nearest`: `cv2.resize(..., INTER_NEAREST)`;
- `resize_linear_u8`: `cv2.resize(u8, ..., INTER_LINEAR)`: 11-bit fixed
  point weights, an exact 2x downscale taken as INTER_AREA, the same size
  a copy;
- `pad_constant`: `cv2.copyMakeBorder(img, 0, pad_h, 0, pad_w,
  BORDER_CONSTANT, value)`.

Images are (H, W) or (H, W, C) uint8 (`canny_edges`: (H, W) only). The
arithmetic is int32: every intermediate fits (below 2^27).
"""

from __future__ import annotations

import numpy as np

_TG22 = 13573  # tan(22.5 deg) * 2^15, canny.cpp's CANNY_SHIFT = 15
_COEF_BITS = 11  # INTER_RESIZE_COEF_BITS
_COEF_SCALE = 1 << _COEF_BITS
_BAND = 32  # output rows a band of resize_linear_u8


def _check_u8(image: np.ndarray, name: str) -> None:
    if image.dtype != np.uint8 or image.ndim not in (2, 3):
        raise ValueError(f"{name}: expected (H, W) or (H, W, C) uint8, got {image.dtype} "
                         f"{image.shape}")


def canny_edges(image: np.ndarray) -> np.ndarray:
    """`cv2.Canny(image, 0.1, 0.2)` (aperture 3, L1 gradient), the boundary
    call of the training pipeline, of an (H, W) uint8 image -> (H, W)
    uint8 in {0, 255}.

    Sobel 3x3 with replicated border, m = |dx| + |dy|, magnitude 0 outside
    the image, then OpenCV's non-maximum suppression (the direction
    sectors from tan 22.5 deg * 2^15). OpenCV floors both thresholds to 0,
    so every pixel that survives the suppression with m > 0 is strong and
    the hysteresis adds nothing."""
    if image.dtype != np.uint8 or image.ndim != 2:
        raise ValueError(f"canny_edges: expected (H, W) uint8, got {image.dtype} {image.shape}")
    h, w = image.shape
    p = np.pad(image, 1, mode="edge").astype(np.int16)
    # separable Sobel: a difference along one axis, [1 2 1] along the other
    ddx = p[:, 2:] - p[:, :-2]  # (h+2, w)
    ddy = p[2:, :] - p[:-2, :]  # (h, w+2)
    dx = ddx[:-2] + 2 * ddx[1:-1] + ddx[2:]
    dy = ddy[:, :-2] + 2 * ddy[:, 1:-1] + ddy[:, 2:]
    mag = np.zeros((h + 2, w + 2), np.int32)  # a zero frame: no magnitude outside
    mag[1:-1, 1:-1] = np.abs(dx) + np.abs(dy)
    # only pixels with a gradient can be edges; most of a label map has none
    cand = np.flatnonzero(mag[1:-1, 1:-1])
    out = np.zeros(h * w, np.uint8)
    ys, xs = np.divmod(cand, w)
    row = w + 2
    c = (ys + 1) * row + (xs + 1)  # index in the framed magnitude
    flat = mag.reshape(-1)
    m = flat[c]
    gx = dx.reshape(-1)[cand].astype(np.int32)
    gy = dy.reshape(-1)[cand].astype(np.int32)
    ax, ay = np.abs(gx), np.abs(gy) << 15
    tg22 = ax * _TG22
    horiz = ay < tg22
    vert = ~horiz & (ay > tg22 + (ax << 16))
    s = np.where((gx ^ gy) < 0, -1, 1)
    # the two neighbours along the gradient, for each sector
    before = np.where(horiz, c - 1, np.where(vert, c - row, c - row - s))
    after = np.where(horiz, c + 1, np.where(vert, c + row, c + row + s))
    keep = (m > flat[before]) & np.where(horiz | vert, m >= flat[after], m > flat[after])
    out[cand[keep]] = 255
    return out.reshape(h, w)


def _max_filter_1d(a: np.ndarray, k: int, axis: int) -> np.ndarray:
    """Running max over a window of k along `axis`, anchored at k // 2 as
    OpenCV anchors a kernel; positions outside the array are ignored
    (padded with 0, the least uint8)."""
    pad = [(0, 0)] * a.ndim
    pad[axis] = (k // 2, k - 1 - k // 2)
    p = np.pad(a, pad)
    n = a.shape[axis]

    def window(i):
        index = [slice(None)] * a.ndim
        index[axis] = slice(i, i + n)
        return p[tuple(index)]

    out = window(0).copy()
    for i in range(1, k):
        np.maximum(out, window(i), out=out)
    return out


def dilate(image: np.ndarray, size: int) -> np.ndarray:
    """`cv2.dilate(image, np.ones((size, size), np.uint8))`: out[y, x] is
    the max of image[y-a .. y-a+size-1, x-a .. x-a+size-1], a = size // 2,
    over the pixels inside the image."""
    _check_u8(image, "dilate")
    return _max_filter_1d(_max_filter_1d(image, size, 0), size, 1)


def _nearest_index(dst: int, src: int) -> np.ndarray:
    # resize.cpp: ifx = 1./fx with fx = dst/src, sx = min(cvFloor(x*ifx), src-1)
    inv = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * inv).astype(np.int64), src - 1)


def resize_nearest(image: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """`cv2.resize(image, (new_w, new_h), interpolation=INTER_NEAREST)`."""
    _check_u8(image, "resize_nearest")
    h, w = image.shape[:2]
    if (new_h, new_w) == (h, w):
        return image.copy()
    rows = np.take(image, _nearest_index(new_h, h), axis=0)
    return np.take(rows, _nearest_index(new_w, w), axis=1)


def _linear_taps(dst: int, src: int, clamp_weights: bool):
    """(first source index, second source index, weight of the first,
    weight of the second) per destination index, in 11-bit fixed point as
    resize.cpp computes them: f = float((d + 0.5) * scale - 0.5), s =
    floor(f), frac = f - s in float32, c0 = round((1 - frac) * 2048).
    Along x (`clamp_weights`) a tap left or right of the image becomes
    the edge pixel at full weight; along y only the indices are clamped."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    frac = (f - s.astype(np.float32)).astype(np.float32)
    if clamp_weights:
        low = s < 0
        high = s >= src - 1
        frac = np.where(low | high, np.float32(0), frac)
        s = np.where(low, 0, np.where(high, src - 1, s))
    c0 = np.rint((np.float32(1) - frac) * np.float32(_COEF_SCALE)).astype(np.int32)
    c1 = _COEF_SCALE - c0
    s0 = np.clip(s, 0, src - 1)
    s1 = np.clip(s + 1, 0, src - 1)
    return s0, s1, c0, c1


def resize_linear_u8(image: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """`cv2.resize(image, (new_w, new_h), interpolation=INTER_LINEAR)` of a
    uint8 image, bit for bit: a row pass H = (S[s0] c0 + S[s1] c1) >> 4,
    then a column pass ((H0 b0) >> 16) + ((H1 b1) >> 16) + 2) >> 2. The
    same size is a copy, and an exact 2x downscale on both axes is cv2's
    INTER_AREA: (a + b + c + d + 2) >> 2. Output rows go in bands of
    `_BAND`, so that each band's int32 rows stay in the CPU's cache."""
    _check_u8(image, "resize_linear_u8")
    h, w = image.shape[:2]
    if (new_h, new_w) == (h, w):
        return image.copy()
    if (h, w) == (2 * new_h, 2 * new_w):
        a = image.astype(np.int32)
        s = a[0::2, 0::2] + a[0::2, 1::2] + a[1::2, 0::2] + a[1::2, 1::2]
        return ((s + 2) >> 2).astype(np.uint8)
    c = image.shape[2] if image.ndim == 3 else 1
    xs0, xs1, xc0, xc1 = _linear_taps(new_w, w, clamp_weights=True)
    ys0, ys1, yc0, yc1 = _linear_taps(new_h, h, clamp_weights=False)
    # rows flattened to (W * C): per output column, its two source columns
    i0 = (xs0[:, None] * c + np.arange(c)).reshape(-1)
    i1 = (xs1[:, None] * c + np.arange(c)).reshape(-1)
    c0, c1 = np.repeat(xc0, c), np.repeat(xc1, c)
    src = image.reshape(h, w * c)
    out = np.empty((new_h, new_w * c), np.uint8)
    for y in range(0, new_h, _BAND):
        e = min(y + _BAND, new_h)
        top = int(min(ys0[y:e].min(), ys1[y:e].min()))
        rows = src[top:int(max(ys0[y:e].max(), ys1[y:e].max())) + 1]
        hrow = np.take(rows, i0, axis=1).astype(np.int32)
        hrow *= c0
        second = np.take(rows, i1, axis=1).astype(np.int32)
        second *= c1
        hrow += second
        hrow >>= 4
        acc = hrow[ys0[y:e] - top]
        acc *= yc0[y:e, None]
        acc >>= 16
        second = hrow[ys1[y:e] - top]
        second *= yc1[y:e, None]
        second >>= 16
        acc += second
        acc += 2
        acc >>= 2
        out[y:e] = acc
    return out.reshape((new_h, new_w) + image.shape[2:])


def pad_constant(image: np.ndarray, pad_h: int, pad_w: int, value) -> np.ndarray:
    """`cv2.copyMakeBorder(image, 0, pad_h, 0, pad_w, BORDER_CONSTANT,
    value=value)`: bottom and right only. `value` becomes cv2's Scalar
    (up to 4 values, the rest 0: a bare number fills channel 0 only),
    rounded and saturated to uint8 as cv2 casts it."""
    _check_u8(image, "pad_constant")
    h, w = image.shape[:2]
    scalar = np.zeros(4)
    given = np.atleast_1d(np.asarray(value, np.float64))
    scalar[:given.size] = given
    fill = np.clip(np.rint(scalar), 0, 255).astype(np.uint8)
    out = np.empty((h + pad_h, w + pad_w) + image.shape[2:], np.uint8)
    out[...] = fill[:image.shape[2]] if image.ndim == 3 else fill[0]
    out[:h, :w] = image
    return out
