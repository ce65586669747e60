"""The training pipeline's host-side augmentation (counterpart of
pidnet_tpu/data/transforms.py), numpy only: the cv2 calls are
data/imgproc.py's bit-exact reproductions.

- boundary target: Canny(label) -> zero a 6-px frame (Cityscapes only) ->
  dilate with an (edge_size x edge_size) ones kernel -> binarize (>50);
- multi-scale: rand_scale = 0.5 + integers(0, scale_factor + 1) / 10, long
  side scaled, image bilinear, label and edge nearest;
- pad to the crop size (label pad = ignore_label, edge and image pad 0),
  then a uniform random crop;
- normalise: optional channel reversal, /255, ImageNet mean/std;
- random horizontal flip of image, label and edge together.

Every draw comes from the caller's `np.random.Generator`, in the JAX
package's order (scale, crop x, crop y, flip), so the same generator gives
the same sample bit for bit. Outputs stay NHWC-ready (H, W, 3).
"""

from __future__ import annotations

import numpy as np

from pidnet_tpu_torch.data import imgproc

Y_K_SIZE = 6
X_K_SIZE = 6
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def input_transform(image: np.ndarray, *, bgr_to_rgb: bool) -> np.ndarray:
    """(H, W, 3) image -> float32: optional channel reversal, /255, then
    ImageNet mean/std."""
    image = image.astype(np.float32)
    if bgr_to_rgb:
        image = image[:, :, ::-1]
    image = image / 255.0
    image -= IMAGENET_MEAN
    image /= IMAGENET_STD
    return image


def gen_edge_gt(label: np.ndarray, *, edge_size: int = 4, edge_pad: bool = True) -> np.ndarray:
    """Boundary target of an (H, W) uint8 label map, uint8 {0, 1}: the
    label's Canny edges (thresholds 0.1, 0.2), a 6-px frame zeroed when
    `edge_pad`, dilated by an edge_size x edge_size square."""
    edge = imgproc.canny_edges(label)
    if edge_pad:
        edge = edge[Y_K_SIZE:-Y_K_SIZE, X_K_SIZE:-X_K_SIZE]
        edge = np.pad(edge, ((Y_K_SIZE, Y_K_SIZE), (X_K_SIZE, X_K_SIZE)), mode="constant")
    return (imgproc.dilate(edge, edge_size) > 50).astype(np.uint8)


def pad_image(image: np.ndarray, size: tuple[int, int], padvalue) -> np.ndarray:
    """Pad bottom and right with `padvalue` up to `size` (H, W)."""
    h, w = image.shape[:2]
    pad_h = max(size[0] - h, 0)
    pad_w = max(size[1] - w, 0)
    if pad_h > 0 or pad_w > 0:
        image = imgproc.pad_constant(image, pad_h, pad_w, padvalue)
    return image


def rand_crop(rng: np.random.Generator, image, label, edge, crop_size, ignore_label):
    image = pad_image(image, crop_size, (0.0, 0.0, 0.0))
    label = pad_image(label, crop_size, (ignore_label,))
    edge = pad_image(edge, crop_size, (0.0,))
    new_h, new_w = label.shape
    x = int(rng.integers(0, new_w - crop_size[1] + 1))
    y = int(rng.integers(0, new_h - crop_size[0] + 1))
    image = image[y : y + crop_size[0], x : x + crop_size[1]]
    label = label[y : y + crop_size[0], x : x + crop_size[1]]
    edge = edge[y : y + crop_size[0], x : x + crop_size[1]]
    return image, label, edge


def multi_scale_aug(
    rng: np.random.Generator,
    image,
    label,
    edge,
    *,
    base_size: int,
    rand_scale: float,
    crop_size,
    ignore_label,
    do_crop: bool = True,
):
    long_size = int(base_size * rand_scale + 0.5)
    h, w = image.shape[:2]
    if h > w:
        new_h, new_w = long_size, int(w * long_size / h + 0.5)
    else:
        new_w, new_h = long_size, int(h * long_size / w + 0.5)
    image = imgproc.resize_linear_u8(image, new_h, new_w)
    label = imgproc.resize_nearest(label, new_h, new_w)
    edge = imgproc.resize_nearest(edge, new_h, new_w)
    if do_crop:
        image, label, edge = rand_crop(rng, image, label, edge, crop_size, ignore_label)
    return image, label, edge


def gen_sample(
    rng: np.random.Generator,
    image: np.ndarray,
    label: np.ndarray,
    *,
    multi_scale: bool,
    is_flip: bool,
    base_size: int,
    crop_size,
    scale_factor: int,
    ignore_label: int,
    edge_pad: bool = True,
    edge_size: int = 4,
    bgr_to_rgb: bool = True,
    edge: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full train-time pipeline of a uint8 image and label -> (image HWC
    f32, label HW u8, edge HW f32).

    `edge` short-circuits the Canny+dilate stage with a precomputed
    full-resolution u8 edge map (SegDataset's decoded-sample cache: the
    edge target is deterministic in the label)."""
    if edge is None:
        edge = gen_edge_gt(label, edge_size=edge_size, edge_pad=edge_pad)

    if multi_scale:
        rand_scale = 0.5 + int(rng.integers(0, scale_factor + 1)) / 10.0
        image, label, edge = multi_scale_aug(
            rng,
            image,
            label,
            edge,
            base_size=base_size,
            rand_scale=rand_scale,
            crop_size=crop_size,
            ignore_label=ignore_label,
        )

    image = input_transform(image, bgr_to_rgb=bgr_to_rgb)
    label = np.array(label).astype(np.uint8)

    if is_flip and int(rng.integers(0, 2)) == 0:  # the reference's `*2-1 == -1`
        image = image[:, ::-1]
        label = label[:, ::-1]
        edge = edge[:, ::-1]

    return (
        np.ascontiguousarray(image),
        np.ascontiguousarray(label),
        np.ascontiguousarray(edge, dtype=np.float32),
    )
