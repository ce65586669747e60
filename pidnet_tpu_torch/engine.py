"""The training epoch, the evaluation loops and the inference closures
(counterpart of pidnet_tpu/engine.py).

`train_one_epoch` drives a train step (train/step.py) over a loader;
`validate` drives an eval step (`train.step.make_eval_step`) over a
labelled loader; `testval` and `test` drive an inference closure over
labelled and unlabelled loaders.

`make_inference` returns probabilities at input size (model -> pick
TEST.OUTPUT_INDEX -> bilinear resize -> exp), `make_inference_classmap`
the (N,H,W) int32 class map (model -> pick TEST.OUTPUT_INDEX -> fused
upsample+argmax, ops/upsample_argmax.py), `make_ms_flip_inference` the
multi-scale + flip test-time augmentation of TEST.MULTI_SCALE /
TEST.FLIP_TEST. They take NHWC float images (numpy or tensor; H and W
multiples of 64, as the network's 1/64 stage and 1/8 fusions need) and
return tensors on the model's device. With `data_devices` the first two
split the batch over one model replica per device (`_data_parallel_infer`);
with `spatial_mesh` (parallel/spatial.py) they split each image's H rows
over the ranks of the mesh and return the whole result on every rank.
Each call of theirs is the span `serve.call` (utils/spans.py), which holds
`serve.input`, `serve.model` and `serve.classmap`.

Over a data mesh (parallel/mesh.py) every rank runs `train_one_epoch` and
`validate` on its own loader shard with the mesh's steps; only rank 0 logs
the meters and writes TensorBoard. Over a (data, spatial) mesh the ranks of
a spatial row read the same samples and `shard_rows` keeps each one's rows.

`cfg` needs MODEL.NUM_OUTPUTS, MODEL.ALIGN_CORNERS and TEST.OUTPUT_INDEX,
PRINT_FREQ and TRAIN.END_EPOCH for training, DATASET.NUM_CLASSES and
TRAIN.IGNORE_LABEL for evaluation, and TEST.IMAGE_SIZE, BASE_SIZE,
SCALE_LIST, MULTI_SCALE and FLIP_TEST for the TTA; `config()` builds one
with the JAX package's defaults.
"""

from __future__ import annotations

import logging
import math
import os
import time
from functools import lru_cache
from types import SimpleNamespace

import numpy as np
import torch

from pidnet_tpu_torch import resolve_device
from pidnet_tpu_torch.metrics import acc_from_cm, confusion_matrix, iou_from_cm
from pidnet_tpu_torch.models import pidnet as M
from pidnet_tpu_torch.ops.resize import resize_bilinear
from pidnet_tpu_torch.ops.upsample_argmax import upsample_argmax, upsample_argmax_rows
from pidnet_tpu_torch.parallel import spatial as SP
from pidnet_tpu_torch.train.lr import poly_lr
from pidnet_tpu_torch.utils.logging import AverageMeter
from pidnet_tpu_torch.utils.spans import span

log = logging.getLogger("pidnet_tpu_torch")


def _tensor(a) -> torch.Tensor:
    return a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))


def _place_on(device):
    """`place_batch` that moves host arrays (or tensors) to `device`: images
    and edges float32, labels int32."""

    def place(images, labels, edges):
        return (_tensor(images).to(device, torch.float32),
                _tensor(labels).to(device, torch.int32),
                _tensor(edges).to(device, torch.float32))

    return place


def _place_rows(mesh):
    """`place_batch` over a (data, spatial) mesh: this rank's rows
    (`parallel.spatial.shard_rows`), images and edges float32, labels
    int32, a sample mask float32."""

    def place(images, labels, edges, *mask):
        images, labels, edges, *mask = SP.shard_rows(mesh, images, labels, edges, *mask)
        return (images.float(), labels.to(torch.int32), edges.float(),
                *(m.float() for m in mask))

    return place


def _is_primary(mesh) -> bool:
    return mesh is None or mesh.rank == 0


def train_one_epoch(cfg, epoch: int, epoch_iters: int, num_iters: int, base_lr: float, loader,
                    step_fn, ts, writer_dict, place_batch=None, should_stop=None,
                    start_iter: int = 0, mesh=None):
    """One training epoch (reference utils/function.py:21-75); returns
    (ts, completed iterations).

    `loader` yields (images, labels, edges, _, _); `place_batch(images,
    labels, edges)` puts a batch where `step_fn(images, labels, edges, lr)`
    runs it, by default on `mesh`'s device (this rank's share, as
    `parallel.shard_batch` places it) or on the device of `ts.model`; under gradient
    accumulation the caller passes `parallel.shard_microbatches`; over a
    (data, spatial) mesh the default keeps this rank's rows
    (`parallel.spatial.shard_rows`). Over a mesh only rank 0 logs the
    meters and writes TensorBoard. The update at global
    iteration g uses poly(g-1), as the reference adjusts the LR after each
    step. One step's metrics stay in flight unsynced and are folded into
    the meters at the next step, and at once on PRINT_FREQ iterations; a
    non-finite loss raises FloatingPointError there. `should_stop()` is
    polled before each step. `start_iter` resumes mid-epoch: the loader
    skips that many batches (`skip_batches`)."""
    if place_batch is None:
        if isinstance(mesh, SP.SpatialMesh):
            place_batch = _place_rows(mesh)
        else:
            place_batch = _place_on(next(ts.model.parameters()).device if mesh is None
                                    else mesh.device)
    primary = _is_primary(mesh)

    batch_time = AverageMeter()
    ave_loss = AverageMeter()
    ave_acc = AverageMeter()
    avg_sem_loss = AverageMeter()
    avg_bce_loss = AverageMeter()
    tic = time.time()
    cur_iters = epoch * epoch_iters

    def fold(it, metrics):
        m = {k: float(v) for k, v in metrics.items()}
        if not math.isfinite(m["loss"]):
            raise FloatingPointError(
                f"non-finite training loss {m['loss']} at epoch {epoch} iter {it} (global "
                f"iter {it + cur_iters}): diverged; resume from the last checkpoint with a "
                "lower TRAIN.LR")
        ave_loss.update(m["loss"])
        ave_acc.update(m["acc"])
        avg_sem_loss.update(m["sem_loss"])
        avg_bce_loss.update(m["bce_loss"])

    pending = None
    done = start_iter
    if hasattr(loader, "set_epoch"):
        loader.set_epoch(epoch + 1)
    if start_iter:
        if not hasattr(loader, "skip_batches"):
            raise ValueError(f"start_iter={start_iter} needs a loader with skip_batches()")
        loader.skip_batches(start_iter)
    for i_iter, (images, labels, edges, _, _) in enumerate(loader, start=start_iter):
        if should_stop is not None and should_stop():
            log.info("stop requested: ending epoch %d early at iter %d", epoch, i_iter)
            break
        g = i_iter + cur_iters
        lr = poly_lr(base_lr, num_iters, max(0, g - 1))
        metrics = step_fn(*place_batch(images, labels, edges), lr)
        done = i_iter + 1
        lr = poly_lr(base_lr, num_iters, g)  # what the reference logs

        if pending is not None:
            fold(*pending)
        pending = (i_iter, metrics)
        batch_time.update(time.time() - tic)
        tic = time.time()

        if i_iter % cfg.PRINT_FREQ == 0:
            fold(*pending)
            pending = None
            if primary:
                log.info(
                    "Epoch: [%d/%d] Iter:[%d/%d], Time: %.2f, lr: [%s], Loss: %.6f, Acc:%.6f, "
                    "Semantic loss: %.6f, BCE loss: %.6f, SB loss: %.6f",
                    epoch, cfg.TRAIN.END_EPOCH, i_iter, epoch_iters, batch_time.average(),
                    f"{lr:.6g}", ave_loss.average(), ave_acc.average(), avg_sem_loss.average(),
                    avg_bce_loss.average(),
                    ave_loss.average() - avg_sem_loss.average() - avg_bce_loss.average())

    if pending is not None:
        fold(*pending)

    if ave_loss.count and primary:
        writer = writer_dict["writer"]
        writer.add_scalar("train_loss", ave_loss.average(), writer_dict["train_global_steps"])
        writer_dict["train_global_steps"] += 1
    return ts, done


def validate(cfg, loader, eval_step, writer_dict, num_outputs: int = 2, place_batch=None,
             should_stop=None, mesh=None):
    """Loss and per-output confusion matrices over a labelled loader
    (reference utils/function.py:77-128); returns (ave_loss, mean IoU of
    the last output, its IoU array).

    `loader` yields (images, labels, edges, _, _) and has `batch_size`; a
    final partial batch is padded to it with copies of its last image,
    ignore labels, zero edges and a sample mask of 0. A loader with
    `samples_per_epoch` (a rank's wrap-padded epoch) has the duplicates at
    its tail masked too. `eval_step(images, labels, edges, mask)` returns
    (metrics, cms) (`train.step.make_eval_step`); `place_batch(images,
    labels, edges, mask)` may move the batch first, and over a (data,
    spatial) mesh by default keeps this rank's rows
    (`parallel.spatial.shard_rows`). The loss meter is
    weighted by `metrics["weight"]`, the matrices accumulate on the host in
    float64. `should_stop()` is polled before each batch; when it stops the
    epoch early the partial results are returned and no scalar is
    written. Over a `mesh` each rank reads its loader shard; the mesh's
    eval step returns the global weight and matrices, so every rank returns
    the same results, and only rank 0 logs them and writes TensorBoard."""
    primary = _is_primary(mesh)
    if place_batch is None and isinstance(mesh, SP.SpatialMesh):
        place_batch = _place_rows(mesh)
    ave_loss = AverageMeter()
    num_classes = cfg.DATASET.NUM_CLASSES
    cms = np.zeros((num_outputs, num_classes, num_classes), np.float64)
    batch_size = loader.batch_size
    n_real_epoch = getattr(loader, "samples_per_epoch", None)
    stopped = False
    n_seen = 0

    for idx, (images, labels, edges, _, _) in enumerate(loader):
        if should_stop is not None and should_stop():
            log.info("stop requested: ending validation early at batch %d", idx)
            stopped = True
            break
        images, labels, edges = (np.asarray(a) for a in (images, labels, edges))
        n_real = images.shape[0]
        if n_real < batch_size:
            pad = batch_size - n_real
            images = np.concatenate([images, np.repeat(images[-1:], pad, 0)])
            labels = np.concatenate(
                [labels, np.full((pad, *labels.shape[1:]), cfg.TRAIN.IGNORE_LABEL, labels.dtype)])
            edges = np.concatenate([edges, np.zeros((pad, *edges.shape[1:]), edges.dtype)])
        mask = (np.arange(batch_size) < n_real).astype(np.float32)
        if n_real_epoch is not None:
            mask *= (n_seen + np.arange(batch_size) < n_real_epoch).astype(np.float32)
        n_seen += n_real
        batch = (images, np.asarray(labels, np.int32), edges, mask)
        if place_batch is not None:
            batch = place_batch(*batch)
        metrics, batch_cms = eval_step(*batch)
        cms += (batch_cms.cpu().numpy() if torch.is_tensor(batch_cms) else np.asarray(batch_cms))
        ave_loss.update(float(metrics["loss"]), float(metrics.get("weight", mask.sum())))
        if idx % 10 == 0 and primary:
            log.info("validating: %d", idx)

    for i in range(num_outputs):
        iou, miou = iou_from_cm(cms[i])
        if primary:
            log.info("%d %s %s", i, iou, miou)
    iou_array, mean_iou = iou_from_cm(cms[-1])

    if not stopped and primary:
        writer = writer_dict["writer"]
        writer.add_scalar("valid_loss", ave_loss.average(), writer_dict["valid_global_steps"])
        writer.add_scalar("valid_mIoU", mean_iou, writer_dict["valid_global_steps"])
        writer_dict["valid_global_steps"] += 1
    return ave_loss.average(), mean_iou, iou_array


def config(num_outputs: int = 2, align_corners: bool = True, output_index: int = -1,
           print_freq: int = 20, end_epoch: int = 484, num_classes: int = 19,
           ignore_label: int = -1, image_size=(2048, 1024), base_size: int = 2048,
           multi_scale: bool = False, flip_test: bool = False,
           scale_list=(0.5, 0.75, 1.0, 1.25, 1.5, 1.75)):
    """The inference, training-loop, evaluation and TTA keys of the JAX
    package's config, with its defaults (TEST.IMAGE_SIZE is width,
    height)."""
    return SimpleNamespace(
        MODEL=SimpleNamespace(NUM_OUTPUTS=num_outputs, ALIGN_CORNERS=align_corners),
        DATASET=SimpleNamespace(NUM_CLASSES=num_classes),
        TEST=SimpleNamespace(OUTPUT_INDEX=output_index, IMAGE_SIZE=list(image_size),
                             BASE_SIZE=base_size, MULTI_SCALE=multi_scale,
                             FLIP_TEST=flip_test, SCALE_LIST=list(scale_list)),
        TRAIN=SimpleNamespace(END_EPOCH=end_epoch, IGNORE_LABEL=ignore_label),
        PRINT_FREQ=print_freq,
    )


def _select_output(cfg, out):
    """Pick TEST.OUTPUT_INDEX from a multi-output model result.
    NUM_OUTPUTS==1 with a multi-output (augment=True) model is a
    misconfiguration; error rather than argmax the 1-channel boundary head."""
    if isinstance(out, (list, tuple)):
        if cfg.MODEL.NUM_OUTPUTS > 1:
            return out[cfg.TEST.OUTPUT_INDEX]
        raise ValueError(
            "model returned multiple outputs but MODEL.NUM_OUTPUTS==1; "
            "set MODEL.NUM_OUTPUTS and TEST.OUTPUT_INDEX consistently"
        )
    return out


def _prepare(spec, state_dict, folded, compute_dtype, device):
    """(model, device) for the closures: the model on `device` in
    channels_last. A folded model is cast to `compute_dtype` once here; an
    unfolded one keeps fp32 weights (its BN affines are formed in fp32)
    and casts them at each conv."""
    dev = resolve_device(device)
    model = M.build(spec, state_dict, folded=folded, device=dev)
    if folded and compute_dtype is not None:
        model = model.to(compute_dtype)
    return model.to(memory_format=torch.channels_last), dev


def _runner(cfg, model, dev, compute_dtype):
    def run(x):
        """NHWC image -> (selected NHWC logits, input (H, W))."""
        if x.ndim != 4 or x.shape[3] != 3 or x.shape[1] % 64 or x.shape[2] % 64:
            raise ValueError(f"expected (N,H,W,3) images with H and W multiples of 64, "
                             f"got {tuple(x.shape)}")
        with span("serve.input"):
            x = (x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))).to(dev)
            if compute_dtype is not None:
                x = x.to(compute_dtype)
        with span("serve.model"):
            return _select_output(cfg, model(x)), (x.shape[1], x.shape[2])

    return run


def _data_parallel_infer(fn, devices):
    """An inference closure over one model replica per device: `fn(device)`
    returns a one-device closure, the batch is split along dim 0 into
    len(devices) equal parts (it must divide: engine.testval/test pad it
    with `batch_pad`), each part runs on its replica, and the results are
    gathered on the first device. One host thread calls the replicas in
    order; each call enqueues its device's work without a sync, so the
    devices' work overlaps. Eval-mode BN has no cross-sample operation, so
    each part's result is what the one-device closure gives that part."""
    devices = [resolve_device(d) for d in devices]
    replicas = [fn(d) for d in devices]

    def infer(x):
        x = _tensor(x)
        if x.shape[0] % len(replicas):
            raise ValueError(f"a batch of {x.shape[0]} does not split over {len(replicas)} "
                             "devices; pad it to a multiple (batch_pad)")
        with span("serve.call"):  # each replica's call is a serve.call inside it
            outs = [run(part) for run, part in zip(replicas, x.chunk(len(replicas)))]
            return torch.cat([o.to(devices[0]) for o in outs])

    return infer


def _spatial_runner(cfg, spec, state_dict, folded, compute_dtype, mesh, data_devices):
    """`run(x)` of an inference closure over a (data, spatial) mesh: it
    takes the whole NHWC image batch on every rank and returns this rank's
    rows of the selected head, computed under
    `models.pidnet.spatial_sharding`, and the input's (H, W)."""
    if data_devices is not None:
        raise ValueError("data_devices and spatial_mesh do not compose: H-shard each image, or "
                         "split the batch")
    model, _ = _prepare(spec, state_dict, folded, compute_dtype, mesh.device)

    def sharded(x):
        if x.ndim != 4 or x.shape[3] != 3 or x.shape[2] % 64:
            raise ValueError(f"expected (N,H,W,3) images with W a multiple of 64, got "
                             f"{tuple(x.shape)}")
        with span("serve.input"):
            x = SP.shard_rows(mesh, _tensor(x).float())
            if compute_dtype is not None:
                x = x.to(compute_dtype)
        with span("serve.model"), M.spatial_sharding(model, mesh):
            out = _select_output(cfg, model(x))
        return out, (x.shape[1] * mesh.n_spatial, x.shape[2])

    return sharded


def make_inference(cfg, spec, state_dict, *, folded=False, compute_dtype=None, device=None,
                   data_devices=None, spatial_mesh=None):
    """Single-image inference closure: model -> TEST.OUTPUT_INDEX ->
    bilinear to input size (align_corners=cfg.MODEL.ALIGN_CORNERS) ->
    exp(), as (N,H,W,C) float32. With `data_devices` (a list, one entry
    per replica; a device may repeat) the batch is split over them
    (`_data_parallel_infer`) and `device` is not used. With `spatial_mesh`
    (`parallel.spatial.make_mesh_2d`) every rank passes the same images,
    the model runs on the rank's H rows (its device is the mesh's), the
    1/8 logits are gathered and every rank returns the whole result."""
    if spatial_mesh is not None:
        run = _spatial_runner(cfg, spec, state_dict, folded, compute_dtype, spatial_mesh,
                              data_devices)

        @torch.inference_mode()
        def infer_rows(x):
            with span("serve.call"):
                out, hw = run(x)
                with span("serve.classmap"):
                    out = SP.gather_rows(out, spatial_mesh, dim=1)
                    return torch.exp(resize_bilinear(out, hw, cfg.MODEL.ALIGN_CORNERS).float())

        return infer_rows
    if data_devices is not None:
        return _data_parallel_infer(
            lambda d: make_inference(cfg, spec, state_dict, folded=folded,
                                     compute_dtype=compute_dtype, device=d), data_devices)
    model, dev = _prepare(spec, state_dict, folded, compute_dtype, device)
    run = _runner(cfg, model, dev, compute_dtype)

    @torch.inference_mode()
    def infer(x):
        with span("serve.call"):
            out, hw = run(x)
            with span("serve.classmap"):
                pred = resize_bilinear(out, hw, cfg.MODEL.ALIGN_CORNERS)
                return torch.exp(pred.float())

    return infer


def make_inference_classmap(cfg, spec, state_dict, *, folded=False, compute_dtype=None,
                            device=None, data_devices=None, spatial_mesh=None):
    """Class-map inference closure: model -> TEST.OUTPUT_INDEX -> fused
    bilinear-upsample+argmax -> (N,H,W) int32. Argmax-equivalent to
    `make_inference` (exp() is monotonic) while never materializing
    full-resolution logits; on CUDA the upsample+argmax is the hand-written
    kernel. `data_devices` as in `make_inference`. With `spatial_mesh` the
    model runs on each rank's H rows, the windowed kernel
    (`upsample_argmax_rows`) makes the rank's rows of the map from its
    logits and their halo, and an all-gather of the rows gives every rank
    the whole map."""
    if spatial_mesh is not None:
        run = _spatial_runner(cfg, spec, state_dict, folded, compute_dtype, spatial_mesh,
                              data_devices)

        @torch.inference_mode()
        def infer_rows(x):
            with span("serve.call"):
                out, (h, w) = run(x)
                with span("serve.classmap"):
                    rows_out = h // spatial_mesh.n_spatial
                    out, rows = SP.halo_rows(out, rows_out, cfg.MODEL.ALIGN_CORNERS,
                                             spatial_mesh)
                    classes = upsample_argmax_rows(out.contiguous(), (rows_out, w),
                                                   cfg.MODEL.ALIGN_CORNERS, rows)
                    return SP.gather_rows(classes, spatial_mesh, dim=1)

        return infer_rows
    if data_devices is not None:
        return _data_parallel_infer(
            lambda d: make_inference_classmap(cfg, spec, state_dict, folded=folded,
                                              compute_dtype=compute_dtype, device=d),
            data_devices)
    model, dev = _prepare(spec, state_dict, folded, compute_dtype, device)
    run = _runner(cfg, model, dev, compute_dtype)

    @torch.inference_mode()
    def infer(x):
        with span("serve.call"):
            out, hw = run(x)
            with span("serve.classmap"):
                return upsample_argmax(out.contiguous(), hw, cfg.MODEL.ALIGN_CORNERS)

    return infer


@lru_cache(maxsize=8)
def _overlap_count(rows, cols, stride_h, stride_w, crop_h, crop_w, ph, pw):
    """(1, ph, pw, 1) fp32 window-overlap counts of a sliding grid, as numpy."""
    cnt = np.zeros((1, ph, pw, 1), np.float32)
    for r in range(rows):
        for q in range(cols):
            r0, q0 = r * stride_h, q * stride_w
            cnt[:, r0:r0 + crop_h, q0:q0 + crop_w] += 1.0
    return cnt


def make_ms_flip_inference(cfg, spec, state_dict, *, folded=False, compute_dtype=None,
                           device=None):
    """Multi-scale + flip test-time-augmentation closure (the JAX package's
    `make_ms_flip_inference`, the HRNet-Semantic-Segmentation protocol
    behind the reference's unused TEST.MULTI_SCALE / TEST.FLIP_TEST keys).

    Per scale s in TEST.SCALE_LIST (only 1.0, at the input's own size,
    without TEST.MULTI_SCALE): resize the image (align_corners=False) so its
    long side is int(TEST.BASE_SIZE * s + 0.5), aspect kept; run the model
    on it zero-padded to the TEST.IMAGE_SIZE crop if it fits, else on a
    grid of crop windows with stride int(crop * 2/3) over the image
    zero-padded to the grid, averaging overlaps by their count. With
    TEST.FLIP_TEST each window's 1/8-resolution fp32 logits are averaged
    with the W-flipped logits of the W-flipped window before one batched
    bilinear upsample to the crop (MODEL.ALIGN_CORNERS) and exp(). Each
    scale's probabilities are resized back to the input size
    (align_corners=False) and the scales summed: (N,H,W,C) fp32, the
    contract of `make_inference`.

    The windows of a scale and their flips run as model batches of at most
    8 windows x images (chunks of 8, 4, 2, 1), which bounds the memory.
    Overlapping windows are summed in place into one canvas. The JAX
    package's per-resolution jit cache has nothing to cache here and is
    dropped."""
    model, dev = _prepare(spec, state_dict, folded, compute_dtype, device)
    crop_h, crop_w = int(cfg.TEST.IMAGE_SIZE[1]), int(cfg.TEST.IMAGE_SIZE[0])
    flip = bool(cfg.TEST.FLIP_TEST)
    multi_scale = bool(cfg.TEST.MULTI_SCALE)
    scales = [float(s) for s in cfg.TEST.SCALE_LIST] if multi_scale else [1.0]
    align = cfg.MODEL.ALIGN_CORNERS
    base = int(cfg.TEST.BASE_SIZE)
    # HRNet's window stride: int() truncation of crop * 2/3
    stride_h, stride_w = max(1, int(crop_h * 2 / 3)), max(1, int(crop_w * 2 / 3))

    def batch_logits(xw):
        """(B, crop_h, crop_w, 3) -> the 1/8-resolution fp32 logits."""
        x = xw if compute_dtype is None else xw.to(compute_dtype)
        return _select_output(cfg, model(x)).float()

    def chunk_plan(k: int, n: int) -> list[int]:
        """k windows as model calls of 8, 4, 2 or 1 windows, each call at
        most 8 windows x images."""
        sizes = [c for c in (8, 4, 2, 1) if c == 1 or c * n <= 8]
        plan = []
        while k:
            c = next(s for s in sizes if s <= k)
            plan.append(c)
            k -= c
        return plan

    def windows_probs(xp, offsets):
        """(K, N, crop_h, crop_w, C) exp'd probabilities of every window."""
        n = xp.shape[0]
        wins = torch.stack([xp[:, r0:r0 + crop_h, q0:q0 + crop_w] for r0, q0 in offsets])
        if flip:
            # [w0, flip(w0), w1, flip(w1), ...]: a window and its flip share a chunk
            wins = torch.stack([wins, torch.flip(wins, dims=[3])], 1).reshape(
                (-1,) + tuple(wins.shape[1:]))
        k2 = wins.shape[0]
        flat = wins.reshape((-1,) + tuple(wins.shape[2:]))
        zs, i = [], 0
        for c in chunk_plan(k2, n):
            zs.append(batch_logits(flat[i * n:(i + c) * n]))
            i += c
        z = torch.cat(zs) if len(zs) > 1 else zs[0]
        z = z.reshape((k2, n) + tuple(z.shape[1:]))
        if flip:
            z = 0.5 * (z[0::2] + torch.flip(z[1::2], dims=[3]))
        k = z.shape[0]
        pr = torch.exp(resize_bilinear(z.reshape((k * n,) + tuple(z.shape[2:])),
                                       (crop_h, crop_w), align))
        return pr.reshape((k, n, crop_h, crop_w, pr.shape[-1]))

    def scale_probs(x, nh: int, nw: int):
        """Exp'd probabilities for one scale, at (nh, nw)."""
        xs = x if (nh, nw) == (x.shape[1], x.shape[2]) else resize_bilinear(x, (nh, nw), False)
        if nh <= crop_h and nw <= crop_w:
            xp = torch.nn.functional.pad(xs, (0, 0, 0, crop_w - nw, 0, crop_h - nh))
            return windows_probs(xp, [(0, 0)])[0][:, :nh, :nw]
        rows = 1 + max(0, -(-(nh - crop_h) // stride_h))
        cols = 1 + max(0, -(-(nw - crop_w) // stride_w))
        ph = stride_h * (rows - 1) + crop_h
        pw = stride_w * (cols - 1) + crop_w
        xp = torch.nn.functional.pad(xs, (0, 0, 0, pw - nw, 0, ph - nh))
        offsets = [(r * stride_h, q * stride_w) for r in range(rows) for q in range(cols)]
        probs = windows_probs(xp, offsets)
        acc = torch.zeros((x.shape[0], ph, pw, probs.shape[-1]), dtype=torch.float32,
                          device=x.device)
        for k, (r0, q0) in enumerate(offsets):
            acc[:, r0:r0 + crop_h, q0:q0 + crop_w] += probs[k]
        cnt = _overlap_count(rows, cols, stride_h, stride_w, crop_h, crop_w, ph, pw)
        return (acc / torch.from_numpy(cnt).to(x.device))[:, :nh, :nw]

    @torch.inference_mode()
    def infer(x):
        x = _tensor(x).to(dev, torch.float32)
        ori_h, ori_w = x.shape[1], x.shape[2]
        final = None
        for s in scales:
            if not multi_scale:
                # flip-only TTA never rescales (reference base_dataset.py inference())
                nh, nw = ori_h, ori_w
            elif ori_h > ori_w:
                nh = int(base * s + 0.5)
                nw = max(1, int(ori_w * nh / ori_h + 0.5))
            else:
                nw = int(base * s + 0.5)
                nh = max(1, int(ori_h * nw / ori_w + 0.5))
            p = scale_probs(x, nh, nw)
            if (nh, nw) != (ori_h, ori_w):
                p = resize_bilinear(p, (ori_h, ori_w), False)
            final = p if final is None else final + p
        return final

    return infer


def _pad_rows(images, batch_pad: int):
    """Pad dim 0 to a multiple of `batch_pad` by repeating the last sample;
    returns (images, real count)."""
    n_real = images.shape[0]
    pad = -n_real % batch_pad
    if pad:
        images = np.concatenate([images, np.repeat(images[-1:], pad, axis=0)])
    return images, n_real


def testval(cfg, dataset, loader, infer, sv_dir: str = "./", sv_pred: bool = False,
            batch_pad: int = 1):
    """Labelled single-scale evaluation (reference utils/function.py:131-177);
    returns (mean IoU, IoU array, pixel accuracy, mean accuracy).

    `loader` yields (images, labels, _, _, names); `infer` returns
    probabilities (N,H,W,C) or a class map (N,H,W). Every batch is padded
    to a multiple of `batch_pad` before `infer` and its padded predictions
    dropped, so they never reach the matrix; the matrix accumulates on the
    host in float64. With `sv_pred` each batch's predictions go to
    `dataset.save_pred(preds, sv_dir/val_results, names)`."""
    num_classes = cfg.DATASET.NUM_CLASSES
    cm = np.zeros((num_classes, num_classes), np.float64)
    for index, (images, labels, _, _, names) in enumerate(loader):
        images, n_real = _pad_rows(np.asarray(images), batch_pad)
        pred = infer(images)[:n_real]
        labels = _tensor(np.asarray(labels, np.int32)).to(pred.device)
        cm += confusion_matrix(pred, labels, num_classes, cfg.TRAIN.IGNORE_LABEL).cpu().numpy()
        if sv_pred:
            sv_path = os.path.join(sv_dir, "val_results")
            os.makedirs(sv_path, exist_ok=True)
            dataset.save_pred(pred.cpu().numpy(), sv_path, names)
        if index % 100 == 0:
            log.info("processing: %d images", index)
            log.info("mIoU: %.4f", iou_from_cm(cm)[1])

    iou_array, mean_iou = iou_from_cm(cm)
    pixel_acc, mean_acc = acc_from_cm(cm)
    return mean_iou, iou_array, pixel_acc, mean_acc


def test(cfg, dataset, loader, infer, sv_dir: str = "./", sv_pred: bool = True,
         batch_pad: int = 1):
    """Unlabelled inference for the test server (reference
    utils/function.py:180-202): `loader` yields (images, sizes, names);
    with `sv_pred` the predictions go to
    `dataset.save_pred(preds, sv_dir/test_results, names)`."""
    for images, _, names in loader:
        images, n_real = _pad_rows(np.asarray(images), batch_pad)
        pred = infer(images)
        if sv_pred:
            sv_path = os.path.join(sv_dir, "test_results")
            os.makedirs(sv_path, exist_ok=True)
            dataset.save_pred(pred[:n_real].cpu().numpy(), sv_path, names)
