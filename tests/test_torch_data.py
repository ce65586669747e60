"""PyTorch port, the data layer on the CPU: data/imgproc.py against the cv2
calls it reproduces, and the augmentation pipeline, the datasets, the
loader and the decoded-sample cache against the JAX package's on the same
seeded inputs, bit for bit; then the training and validation loops fed by
the port's loader over a small Cityscapes tree."""

import importlib.util
import os

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from pidnet_tpu import data as jdata
from pidnet_tpu.data import native as jnative
from pidnet_tpu.data import transforms as JT
from pidnet_tpu.data.base import _ByteLRU as JByteLRU
from pidnet_tpu_torch import data, engine
from pidnet_tpu_torch.data import imgproc as P
from pidnet_tpu_torch.data import transforms as T
from pidnet_tpu_torch.data.base import _ByteLRU
from pidnet_tpu_torch.data.camvid import COLOR_LIST
from pidnet_tpu_torch.data.cityscapes import CLASS_WEIGHTS, LABEL_MAPPING, _build_luts
from pidnet_tpu_torch.data.png import read_png
from pidnet_tpu_torch.losses.criterion import FullLoss
from pidnet_tpu_torch.models import pidnet as M
from pidnet_tpu_torch.train.step import TrainState, make_eval_step, make_train_step

torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..")
GOLDENS = os.path.join(ROOT, "tests", "goldens", "classmaps_train2k.npz")
SAMPLES = os.path.join(ROOT, "samples")
# gen_sample's scales: 0.5 + integers(0, 17) / 10
SCALES = [0.5 + i / 10 for i in range(17)]


@pytest.fixture
def numpy_jax(monkeypatch):
    """The JAX package's data pipeline with its numpy fallbacks: its host
    library normalises through a float32 LUT (v * scale + shift), which
    rounds differently from numpy's (v / 255 - mean) / std."""
    monkeypatch.setattr(jnative, "_lib", None)


@pytest.fixture(scope="module")
def frames():
    """(RGB uint8 frame, uint8 golden train-id map) of both sample frames."""
    goldens = np.load(GOLDENS)
    return [(read_png(os.path.join(SAMPLES, k)), goldens[k].astype(np.uint8))
            for k in goldens.files]


def _blocky(rng, h, w, n=34):
    lab = np.zeros((h, w), np.uint8)
    for _ in range(max(4, h * w // 600)):
        y, x = rng.integers(0, max(1, h - 4)), rng.integers(0, max(1, w - 4))
        lab[y:y + rng.integers(2, 40), x:x + rng.integers(2, 40)] = rng.integers(0, n)
    return lab


# (H, W) of the label maps and images the cv2 comparisons run on
SHAPES = [(1, 9), (5, 7), (33, 47), (97, 211), (128, 160), (128, 256), (256, 320)]


@pytest.mark.parametrize("shape", SHAPES)
def test_canny_and_dilate_equal_cv2(rng, shape):
    """Blocky label maps, a noisy one and a gradient: cv2.Canny at the
    pipeline's thresholds; cv2.dilate with square kernels of 1-5."""
    h, w = shape
    images = [_blocky(rng, h, w), rng.integers(0, 256, shape).astype(np.uint8),
              (np.add.outer(np.arange(h) * 3, np.arange(w) * 5) % 256).astype(np.uint8),
              np.full(shape, 7, np.uint8)]
    for image in images:
        edge = P.canny_edges(image)
        np.testing.assert_array_equal(edge, cv2.Canny(image, 0.1, 0.2), err_msg=f"{shape}")
        for k in (1, 2, 3, 4, 5):
            np.testing.assert_array_equal(P.dilate(edge, k),
                                          cv2.dilate(edge, np.ones((k, k), np.uint8)))
        rgb = np.stack([image, image[::-1], image[:, ::-1]], axis=2)
        np.testing.assert_array_equal(P.dilate(rgb, 4), cv2.dilate(rgb, np.ones((4, 4), np.uint8)))
    assert P.canny_edges(_blocky(rng, h, w)).dtype == np.uint8


def test_canny_equals_cv2_on_the_full_resolution_goldens(frames, rng):
    """Both 1024x2048 golden maps, and one with 5% of its pixels 255."""
    noisy = frames[1][1].copy()
    noisy[rng.random(noisy.shape) < 0.05] = 255
    for label in (frames[0][1], frames[1][1], noisy):
        got = P.canny_edges(label)
        np.testing.assert_array_equal(got, cv2.Canny(label, 0.1, 0.2))
        assert got.any()


def _sizes(h, w):
    """gen_sample's 17 target sizes of an (h, w) frame (the long side at
    base = the frame's own long side), an exact 2x downscale, the same
    size, and two odd ones."""
    out = []
    for scale in SCALES:
        long_size = int(max(h, w) * scale + 0.5)
        if h > w:
            out.append((long_size, int(w * long_size / h + 0.5)))
        else:
            out.append((int(h * long_size / w + 0.5), long_size))
    return out + [(h // 2, w // 2), (h, w), (h + 3, max(1, w - 1)), (max(1, h // 3), w + 7)]


@pytest.mark.parametrize("shape", [(37, 53, 3), (101, 67), (64, 128, 3), (128, 256, 3), (9, 14),
                                   (1024, 2048, 3)])
def test_resizes_equal_cv2(rng, frames, shape):
    """INTER_LINEAR (11-bit fixed point, 2x-down as INTER_AREA, same size
    a copy) and INTER_NEAREST at every gen_sample scale; the last shape is
    the first sample frame."""
    image = (frames[0][0] if shape == (1024, 2048, 3)
             else rng.integers(0, 256, shape).astype(np.uint8))
    h, w = shape[:2]
    sizes = _sizes(h, w)
    assert (h // 2, w // 2) in sizes and (h, w) in sizes
    for nh, nw in sizes:
        if nh < 1 or nw < 1:
            continue
        np.testing.assert_array_equal(
            P.resize_linear_u8(image, nh, nw),
            cv2.resize(image, (nw, nh), interpolation=cv2.INTER_LINEAR), err_msg=f"{nh}x{nw}")
        np.testing.assert_array_equal(
            P.resize_nearest(image, nh, nw),
            cv2.resize(image, (nw, nh), interpolation=cv2.INTER_NEAREST), err_msg=f"{nh}x{nw}")


@pytest.mark.parametrize("value", [(0.0, 0.0, 0.0), (255,), 7, (1, 2, 3), (-1,), (300.4,),
                                   (2.5, 3.5)])
def test_pad_constant_equals_copy_make_border(rng, value):
    for shape in [(5, 7), (5, 7, 3), (1, 1, 3), (33, 20)]:
        image = rng.integers(0, 256, shape).astype(np.uint8)
        for ph, pw in ((0, 0), (3, 0), (0, 5), (7, 9)):
            np.testing.assert_array_equal(
                P.pad_constant(image, ph, pw, value),
                cv2.copyMakeBorder(image, 0, ph, 0, pw, cv2.BORDER_CONSTANT, value=value))


def test_imgproc_rejects_other_dtypes():
    with pytest.raises(ValueError, match="uint8"):
        P.resize_linear_u8(np.zeros((4, 4), np.float32), 8, 8)
    with pytest.raises(ValueError, match="uint8"):
        P.canny_edges(np.zeros((4, 4, 3), np.uint8))


@pytest.mark.parametrize("edge_pad", [True, False])
def test_gen_edge_gt_equals_jax(frames, rng, edge_pad):
    """The full-resolution golden map and small blocky maps."""
    for label in (frames[0][1], _blocky(rng, 96, 128), _blocky(rng, 13, 30)):
        got = T.gen_edge_gt(label, edge_size=4, edge_pad=edge_pad)
        want = JT.gen_edge_gt(label, edge_size=4, edge_pad=edge_pad)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    assert got.any()


def _small_frame(frames, i=0):
    """A 128x256 RGB frame and its label map: the sample frame at 1/8."""
    image, label = frames[i]
    return image[::8, ::8].copy(), label[::8, ::8].copy()


@pytest.mark.parametrize("seed", range(24))
def test_augmentation_equals_jax(frames, numpy_jax, seed):
    """pad_image, rand_crop, multi_scale_aug and gen_sample against the JAX
    functions on the same generator: the port takes RGB, the JAX package
    BGR, and the outputs are equal bit for bit (the image too, against
    the JAX package's numpy normalisation)."""
    image, label = _small_frame(frames, seed % 2)
    bgr = image[:, :, ::-1].copy()
    rng = np.random.default_rng(seed)
    label = label.copy()
    label[rng.random(label.shape) < 0.02] = 255
    edge = T.gen_edge_gt(label)
    crop = [(96, 192), (160, 300), (64, 64)][seed % 3]

    for size, value in ((crop, (0.0, 0.0, 0.0)), ((200, 100), (255,))):
        arr = image if len(value) == 3 else label
        want = JT.pad_image(bgr if len(value) == 3 else label, size, value)
        got = T.pad_image(arr, size, value)
        np.testing.assert_array_equal(got, want[:, :, ::-1] if got.ndim == 3 else want)

    ours = T.rand_crop(np.random.default_rng(seed), image, label, edge, crop, 255)
    theirs = JT.rand_crop(np.random.default_rng(seed), bgr, label, edge, crop, 255)
    np.testing.assert_array_equal(ours[0], theirs[0][:, :, ::-1])
    for a, b in zip(ours[1:], theirs[1:]):
        np.testing.assert_array_equal(a, b)

    scale = SCALES[seed % len(SCALES)]
    kw = dict(base_size=256, rand_scale=scale, crop_size=crop, ignore_label=255,
              do_crop=bool(seed % 2))
    ours = T.multi_scale_aug(np.random.default_rng(seed), image, label, edge, **kw)
    theirs = JT.multi_scale_aug(np.random.default_rng(seed), bgr, label, edge, **kw)
    np.testing.assert_array_equal(ours[0], theirs[0][:, :, ::-1])
    for a, b in zip(ours[1:], theirs[1:]):
        np.testing.assert_array_equal(a, b)

    kw = dict(multi_scale=True, is_flip=True, base_size=256, crop_size=crop, scale_factor=16,
              ignore_label=255, edge_pad=bool(seed % 2))
    ours = T.gen_sample(np.random.default_rng(seed), image, label, bgr_to_rgb=False, **kw)
    theirs = JT.gen_sample(np.random.default_rng(seed), bgr, label, bgr_to_rgb=True, **kw)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape and a.flags.c_contiguous
        np.testing.assert_array_equal(a, b)
    # without multi-scale: no crop, the flip alone
    kw.update(multi_scale=False)
    ours = T.gen_sample(np.random.default_rng(seed), image, label, bgr_to_rgb=False, **kw)
    theirs = JT.gen_sample(np.random.default_rng(seed), bgr, label, bgr_to_rgb=True, **kw)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


def test_images_within_1e6_of_the_jax_host_library(frames):
    """Where the JAX package's host library is built, it normalises through
    a float32 LUT; the port's numpy normalisation is within 1e-6 of it, and
    labels and edges are equal."""
    image, label = _small_frame(frames)
    kw = dict(multi_scale=True, is_flip=True, base_size=256, crop_size=(96, 192),
              scale_factor=16, ignore_label=255)
    worst = 0.0
    for seed in range(8):
        ours = T.gen_sample(np.random.default_rng(seed), image, label, bgr_to_rgb=False, **kw)
        theirs = JT.gen_sample(np.random.default_rng(seed), image[:, :, ::-1].copy(), label,
                               bgr_to_rgb=True, **kw)
        worst = max(worst, float(np.abs(ours[0] - theirs[0]).max()))
        for a, b in zip(ours[1:], theirs[1:]):
            np.testing.assert_array_equal(a, b)
    assert worst <= 1e-6


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_data_digests_are_cv2s(frames, numpy_jax):
    """chip_smoke.py's SHA-256 constants are the bytes that cv2 and the JAX
    package give, and the port gives them too."""
    cs = _chip_smoke()
    image, label = frames[0]
    assert cs.data_digests(JT, image, label, bgr=True) == cs.DATA_SHA256
    assert cs.data_digests(T, image, label) == cs.DATA_SHA256


def test_label_luts_equal_jax():
    from pidnet_tpu.data.cityscapes import LABEL_MAPPING as J_MAPPING
    from pidnet_tpu.data.cityscapes import _build_luts as j_build_luts

    assert LABEL_MAPPING == J_MAPPING
    for ignore in (255, 254, 19):
        for a, b in zip(_build_luts(ignore), j_build_luts(ignore)):
            np.testing.assert_array_equal(a, b)
    _, inv = _build_luts(255)
    assert inv[255] == 30  # the reference's inverse of ignore: the last ignored raw id


# --- datasets over a small tree written by cv2 and PIL ------------------------------------


@pytest.fixture(scope="module")
def city_root(tmp_path_factory, frames):
    """A Cityscapes tree of 5 frames of 128x256, written by cv2: the sample
    frames at 1/8 and three crops of them, labels the goldens mapped back
    to raw ids (every 9th pixel of a crop set to raw 0, an ignored id)."""
    root = tmp_path_factory.mktemp("city")
    for d in ("cityscapes/img", "cityscapes/gt", "list/cityscapes"):
        (root / d).mkdir(parents=True)
    _, inv = _build_luts(255)
    items = [_small_frame(frames, 0), _small_frame(frames, 1)]
    for i, (y, x) in enumerate(((300, 500), (600, 1200), (100, 1700))):
        image, label = frames[i % 2]
        items.append((image[y:y + 128, x:x + 256], label[y:y + 128, x:x + 256]))
    lines = []
    for i, (image, label) in enumerate(items):
        raw = inv[label]
        if i >= 2:
            raw = raw.copy()
            raw.reshape(-1)[::9] = 0
        cv2.imwrite(str(root / "cityscapes" / "img" / f"{i}.png"), image[:, :, ::-1])
        cv2.imwrite(str(root / "cityscapes" / "gt" / f"{i}_gtFine_labelIds.png"), raw)
        lines.append(f"img/{i}.png\tgt/{i}_gtFine_labelIds.png")
    (root / "list" / "cityscapes" / "train.lst").write_text("\n".join(lines))
    (root / "list" / "cityscapes" / "val.lst").write_text("\n".join(lines[:3]))
    (root / "list" / "cityscapes" / "test.lst").write_text(
        "\n".join(line.split("\t")[0] for line in lines))
    return str(root) + os.sep


SPLITS = {
    "train": dict(list_path="list/cityscapes/train.lst", base_size=256, crop_size=(96, 192)),
    "val": dict(list_path="list/cityscapes/val.lst", multi_scale=False, flip=False,
                base_size=256, crop_size=(128, 256)),
    "test": dict(list_path="list/cityscapes/test.lst", multi_scale=False, flip=False,
                 base_size=256, crop_size=(128, 256)),
}


def _assert_items_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("split", sorted(SPLITS))
@pytest.mark.parametrize("cache", [False, True])
def test_cityscapes_items_equal_jax(city_root, numpy_jax, split, cache):
    """Cityscapes[i] for every i over 2 epochs, with and without the
    decoded-sample cache (the JAX dataset uncached)."""
    kw = dict(root=city_root, seed=11, **SPLITS[split])
    ours = data.build_dataset("cityscapes", cache=cache, **kw)
    theirs = jdata.build_dataset("cityscapes", **kw)
    assert len(ours) == len(theirs) == (3 if split == "val" else 5)
    np.testing.assert_array_equal(ours.class_weights, CLASS_WEIGHTS)
    for epoch in (1, 2):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for i in range(len(ours)):
            _assert_items_equal(ours[i], theirs[i])
    if split == "train":
        img, lab, edge, size, name = ours[3]
        assert img.shape == (96, 192, 3) and lab.shape == edge.shape == (96, 192)
        assert name == "3_gtFine_labelIds" and tuple(size) == (128, 256, 3)


def test_cityscapes_reads_cv2_files_exactly(city_root):
    ds = data.Cityscapes(root=city_root, **SPLITS["val"])
    path = os.path.join(city_root, "cityscapes", "gt", "2_gtFine_labelIds.png")
    raw = read_png(path)
    np.testing.assert_array_equal(raw, cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    np.testing.assert_array_equal(ds._load_label("gt/2_gtFine_labelIds.png"), ds.convert_label(raw))
    path = os.path.join(city_root, "cityscapes", "img", "2.png")
    np.testing.assert_array_equal(ds._load_image("img/2.png"), cv2.imread(path)[:, :, ::-1])
    with pytest.raises(ValueError, match="greyscale"):
        ds._load_label("img/2.png")


def test_save_pred_round_trips(city_root, tmp_path, rng):
    """Cityscapes writes raw ids as greyscale PNGs, CamVid colour maps as
    RGB: the same files' pixels as the JAX package's (PIL), from logits and
    from class maps."""
    preds = rng.integers(0, 19, (2, 16, 24)).astype(np.int32)
    logits = np.eye(19, dtype=np.float32)[preds]
    ours = data.Cityscapes(root=city_root, **SPLITS["val"])
    theirs = jdata.Cityscapes(root=city_root, **SPLITS["val"])
    for i, p in enumerate((preds, logits)):
        (tmp_path / f"a{i}").mkdir()
        (tmp_path / f"b{i}").mkdir()
        ours.save_pred(p, str(tmp_path / f"a{i}"), ["x", "y"])
        theirs.save_pred(p, str(tmp_path / f"b{i}"), ["x", "y"])
        for j, name in enumerate(("x", "y")):
            got = read_png(str(tmp_path / f"a{i}" / f"{name}.png"))
            want = np.array(Image.open(tmp_path / f"b{i}" / f"{name}.png"))
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(cv2.imread(str(tmp_path / f"a{i}" / f"{name}.png"),
                                                     cv2.IMREAD_GRAYSCALE), want)
            np.testing.assert_array_equal(ours.convert_label(got), preds[j])

    cam_ours, cam_theirs = _camvid_pair(tmp_path, rng)
    (tmp_path / "c").mkdir()
    (tmp_path / "d").mkdir()
    ids = rng.integers(0, 11, (2, 16, 24)).astype(np.int32)
    cam_ours.save_pred(ids, str(tmp_path / "c"), ["x", "y"])
    cam_theirs.save_pred(ids, str(tmp_path / "d"), ["x", "y"])
    for j, name in enumerate(("x", "y")):
        got = read_png(str(tmp_path / "c" / f"{name}.png"))
        np.testing.assert_array_equal(got, np.array(Image.open(tmp_path / "d" / f"{name}.png")))
        np.testing.assert_array_equal(cam_ours.color2label(got), ids[j])


def _camvid_pair(tmp_path, rng, **kw):
    """The port's and the JAX package's CamVid over a 3-frame tree written
    by PIL: RGB images and colour-map labels (a few pixels off-palette)."""
    root = tmp_path / "camdata"
    if not root.exists():
        for d in ("camvid/img", "camvid/lab", "list/camvid"):
            (root / d).mkdir(parents=True)
        palette = np.array(COLOR_LIST, np.uint8)
        lines = []
        for i in range(3):
            ids = _blocky(rng, 96, 128, n=11)
            color = palette[ids]
            color[rng.random((96, 128)) < 0.01] = (1, 2, 3)
            Image.fromarray(color).save(root / "camvid" / "lab" / f"{i}.png")
            image = rng.integers(0, 256, (96, 128, 3)).astype(np.uint8)
            Image.fromarray(image).save(root / "camvid" / "img" / f"{i}.png")
            lines.append(f"img/{i}.png\tlab/{i}.png")
        (root / "list" / "camvid" / "train.lst").write_text("\n".join(lines))
        (root / "list" / "camvid" / "test.lst").write_text(
            "\n".join(line.split("\t")[0] for line in lines))
    args = dict(root=str(root) + os.sep, list_path="list/camvid/train.lst", base_size=128,
                crop_size=(64, 96), seed=5)
    args.update(kw)
    return data.build_dataset("camvid", **args), jdata.build_dataset("camvid", **args)


@pytest.mark.parametrize("split", ["train", "test"])
def test_camvid_items_equal_jax(tmp_path, rng, numpy_jax, split):
    """CamVid[i] over 2 epochs (no 6-px frame in its edges, RGB throughout)."""
    kw = {} if split == "train" else dict(list_path="list/camvid/test.lst", multi_scale=False,
                                          flip=False, crop_size=(96, 128))
    ours, theirs = _camvid_pair(tmp_path, rng, **kw)
    assert not ours.edge_pad and not ours.bgr_to_rgb and ours.class_weights is None
    for epoch in (1, 2):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for i in range(len(ours)):
            _assert_items_equal(ours[i], theirs[i])
    palette = np.array(COLOR_LIST, np.uint8)
    ids = rng.integers(0, 11, (8, 8))
    np.testing.assert_array_equal(ours.color2label(palette[ids]), ids)
    np.testing.assert_array_equal(ours.label2color(ids), palette[ids])


def test_build_dataset_names():
    assert sorted(data.DATASETS) == sorted(jdata.DATASETS) == ["camvid", "cityscapes"]
    with pytest.raises(ValueError, match="Unknown dataset"):
        data.build_dataset("ade20k", root="", list_path="")


# --- the loader --------------------------------------------------------------------------


class _TinyDataset:
    """In-memory dataset for the loader's order and failure semantics."""

    def __init__(self, n=8, raise_at=None, sleep_at=None):
        self.n = n
        self.raise_at = raise_at
        self.sleep_at = sleep_at
        self.epochs = []

    def __len__(self):
        return self.n

    def set_epoch(self, epoch):
        self.epochs.append(epoch)

    def __getitem__(self, i):
        if self.raise_at is not None and i == self.raise_at:
            raise ValueError(f"corrupt sample {i}")
        if self.sleep_at is not None and i == self.sleep_at:
            import time

            time.sleep(0.05)
        img = np.full((4, 4, 3), i, np.float32)
        lab = np.full((4, 4), i, np.uint8)
        edge = np.zeros((4, 4), np.float32)
        return img, lab, edge, np.array([4, 4]), str(i)


def _names(loader):
    return [list(batch[4]) for batch in loader]


@pytest.mark.parametrize("n,batch,shards,drop_last", [(8, 2, 1, True), (11, 3, 1, False),
                                                      (10, 2, 3, True), (10, 3, 3, False),
                                                      (7, 2, 3, False)])
def test_loader_order_equals_jax(n, batch, shards, drop_last):
    """Every shard's batches over 3 epochs: the shuffle of (seed, epoch),
    set_epoch, skip_batches, the wrap-pad and samples_per_epoch."""
    for shard in range(shards):
        kw = dict(batch_size=batch, shuffle=True, drop_last=drop_last, num_workers=3, seed=9,
                  num_shards=shards, shard_index=shard)
        ours = data.Loader(_TinyDataset(n, sleep_at=1), **kw)
        theirs = jdata.Loader(_TinyDataset(n), **kw)
        assert len(ours) == len(theirs)
        assert ours.samples_per_epoch == theirs.samples_per_epoch
        for step in range(3):
            if step == 1:
                ours.set_epoch(7)
                theirs.set_epoch(7)
            if step == 2:
                ours.skip_batches(1)
                theirs.skip_batches(1)
            got, want = _names(ours), _names(theirs)
            assert got == want and len(got) == len(ours) - (step == 2)
        assert ours.dataset.epochs == [1, 7, 8]
    # 3 shards of 10 samples: 4 a shard; padded positions 10 and 11 land on
    # shards 1 and 2, whose last sample is a duplicate
    assert [data.Loader(_TinyDataset(10), 2, num_shards=3, shard_index=s).samples_per_epoch
            for s in range(3)] == [4, 3, 3]


def test_loader_batching(city_root):
    ds = data.Cityscapes(root=city_root, **SPLITS["train"])
    loader = data.Loader(ds, batch_size=2, shuffle=True, drop_last=True, num_workers=2)
    assert len(loader) == 2
    batches = list(loader)
    assert len(batches) == 2
    imgs, labels, edges, sizes, names = batches[0]
    assert imgs.shape == (2, 96, 192, 3) and imgs.dtype == np.float32
    assert labels.shape == (2, 96, 192) and labels.dtype == np.int32
    assert edges.shape == (2, 96, 192) and edges.dtype == np.float32
    assert len(names) == 2 and sizes.shape == (2, 3)
    test = data.Loader(data.Cityscapes(root=city_root, **SPLITS["test"]), 2)
    imgs, sizes, names = next(iter(test))
    assert imgs.shape == (2, 128, 256, 3) and names == ["0", "1"]


def test_loader_batches_equal_jax_across_threads(city_root, numpy_jax):
    """Two epochs of shuffled Cityscapes batches with 1 and 4 workers equal
    the JAX loader's; the epochs differ."""

    def batches(package, workers):
        ds = package.Cityscapes(root=city_root, seed=11, **SPLITS["train"])
        loader = package.Loader(ds, batch_size=2, shuffle=True, drop_last=True,
                                num_workers=workers, seed=11)
        return [list(loader) for _ in range(2)]

    want = batches(jdata, 2)
    for workers in (1, 4):
        got = batches(data, workers)
        for ep_a, ep_b in zip(got, want):
            assert len(ep_a) == len(ep_b) == 2
            for a, b in zip(ep_a, ep_b):
                _assert_items_equal(a, b)
    assert any(not np.array_equal(x[0], y[0]) for x, y in zip(want[0], want[1]))


def test_loader_propagates_worker_exception():
    loader = data.Loader(_TinyDataset(raise_at=5), batch_size=2, num_workers=2)
    with pytest.raises(ValueError, match="corrupt sample 5"):
        for _ in loader:
            pass


def test_loader_first_batch_exception():
    loader = data.Loader(_TinyDataset(raise_at=0), batch_size=2, num_workers=1)
    with pytest.raises(ValueError, match="corrupt sample 0"):
        next(iter(loader))


def test_loader_early_break_stops_producer():
    loader = data.Loader(_TinyDataset(n=64), batch_size=2, num_workers=2, prefetch=1)
    it = iter(loader)
    next(it)
    it.close()  # the generator's finally, as `break` runs it through GC
    loader._producer.join(timeout=10.0)
    assert not loader._producer.is_alive()


def test_loader_completes_after_failure_run():
    ds = _TinyDataset(n=6)
    loader = data.Loader(ds, batch_size=2, num_workers=2)
    ds.raise_at = 3
    with pytest.raises(ValueError):
        list(loader)
    ds.raise_at = None
    assert len(list(loader)) == 3


def test_byte_lru_budget(city_root, numpy_jax):
    """DATASET.CACHE_GB: the LRU never exceeds its budget, evicts the least
    recently used, re-decodes after eviction to the same bytes, and keeps
    the JAX package's accounting; a zero budget stores nothing."""
    lru, jlru = _ByteLRU(100), JByteLRU(100)
    for key, nbytes in ((1, 40), (2, 40), (1, 0), (3, 40), (4, 200), (2, 0)):
        for cache in (lru, jlru):
            if nbytes:
                cache.put(key, (np.zeros(nbytes, np.uint8),))
            else:
                cache.get(key)
        assert (len(lru), lru.bytes, lru.hits, lru.misses) == (
            len(jlru), jlru.bytes, jlru.hits, jlru.misses)
        assert lru.bytes <= 100
    assert list(lru._od) == [1, 3] and lru.stats() == jlru.stats()

    kw = dict(root=city_root, seed=7, **SPLITS["train"])
    plain = data.Cityscapes(**kw)
    probe = data.Cityscapes(cache=True, cache_gb=64.0, **kw)
    probe.set_epoch(1)
    _ = probe[0]
    budget = probe._cache.bytes * 3 // 2  # fits one entry, not two
    cached = data.Cityscapes(cache=True, cache_gb=budget / 2**30, **kw)
    for epoch in (1, 2):
        cached.set_epoch(epoch)
        plain.set_epoch(epoch)
        for i in range(len(plain)):
            for x, y in zip(cached[i][:3], plain[i][:3]):
                np.testing.assert_array_equal(x, y)
            assert cached._cache.bytes <= budget
    assert len(cached._cache) == 1 and cached._cache.misses > len(plain)
    none = data.Cityscapes(cache=True, cache_gb=0.0, **kw)
    none.set_epoch(1)
    _ = none[1]
    assert len(none._cache) == 0


# --- the loops fed by the loader ---------------------------------------------------------


class _NoWriter:
    def add_scalar(self, tag, value, step):
        pass


def test_train_and_validate_from_the_loader(city_root):
    """engine.train_one_epoch takes 2 steps of 2 crops of 64x128 from the
    port's Loader through a narrow PIDNet (fp32), then engine.validate runs
    the 3 val frames at 128x256 in batches of 2: the losses are finite and
    each confusion matrix totals the labelled pixels of the val frames."""
    spec = M.PIDNetSpec(2, 3, 19, 8, 16, 16, True)
    ts = TrainState.create(M.build(spec, M.init(spec, torch.Generator().manual_seed(0)),
                                   train=True))
    loss_fn = FullLoss(ignore_label=255, class_weights=CLASS_WEIGHTS, ohem_kept=1000)
    step = make_train_step(ts, loss_fn)
    losses = []

    def recording_step(*args):
        metrics = step(*args)
        losses.append(float(metrics["loss"]))
        return metrics

    train = data.Cityscapes(root=city_root, list_path="list/cityscapes/train.lst",
                            base_size=256, crop_size=(64, 128), seed=3)
    loader = data.Loader(train, 2, shuffle=True, drop_last=True, num_workers=2, seed=3)
    cfg = engine.config(ignore_label=255, print_freq=1)
    _, done = engine.train_one_epoch(cfg, 0, len(loader), 4, 0.01, loader, recording_step, ts,
                                     {"writer": _NoWriter(), "train_global_steps": 0})
    assert done == len(loader) == 2 and len(losses) == 2 and np.isfinite(losses).all()
    assert loader.epoch == 1

    val = data.Cityscapes(root=city_root, **SPLITS["val"])
    eval_step = make_eval_step(ts.model.eval(), loss_fn, num_classes=19)
    cms = []

    def recording_eval(*batch):
        metrics, batch_cms = eval_step(*batch)
        cms.append(batch_cms.numpy())
        return metrics, batch_cms

    ave_loss, miou, iou = engine.validate(cfg, data.Loader(val, 2), recording_eval,
                                          {"writer": _NoWriter(), "valid_global_steps": 0})
    labelled = sum(int((val[i][1] != 255).sum()) for i in range(len(val)))
    assert len(cms) == 2 and np.isfinite(ave_loss) and iou.shape == (19,)
    assert [int(c.sum()) for c in sum(cms)] == [labelled, labelled]
