"""Training losses on tensors (counterpart of
pidnet_tpu/losses/criterion.py; reference utils/criterion.py and
utils/utils.py):

- `cross_entropy`      = nn.CrossEntropyLoss(weight, ignore_index) mean, or
                         the OHEM criterion's aux-head mean over all pixels
                         (`divide_by="numel"`);
- `ohem_cross_entropy` = keep valid pixels whose true-class probability is
                         below max(thres, k-th smallest probability), then
                         the plain mean of their weighted losses;
- `weighted_bce`       = class-balanced BCE with logits over the boundary
                         map, weight 0 for targets outside {0,1}, mean over
                         all pixels;
- `FullLoss`           = loss_s + loss_b + loss_sb, the boundary-aware CE on
                         pixels where sigmoid(boundary logit) > 0.8.

Logits are NHWC (..., C); labels (N,H,W) int. The low-resolution heads of
FullLoss go through ops/ce_front.ce_maps (the fused upsample + CE kernels
on CUDA) and its pixel accuracy through ops/upsample_argmax.

Over an H-sharded batch (`FullLoss(..., mesh=SpatialMesh)`,
parallel/spatial.py) each rank holds its rows of the labels and of the
heads; FullLoss follows the JAX package's global program, in which every
mean is a global mean: each rank adds its partial numerators over the
global denominators (pixel counts, class-weight sums, OHEM's kept count,
the BCE's positive and negative counts, all summed over the mesh) and
OHEM's threshold is the exact k-th smallest probability of the global
pool. A rank's loss and metrics are its contributions: their sums over
the mesh are the global values, and the gradients of the global loss are
the sum over the mesh of each rank's gradient.
"""

from __future__ import annotations

import torch

from pidnet_tpu_torch.ops.ce_front import ce_maps, class_weights_on
from pidnet_tpu_torch.ops.resize import resize_bilinear, resize_rows
from pidnet_tpu_torch.ops.upsample_argmax import upsample_argmax_rows
from pidnet_tpu_torch.parallel import spatial as SP
from pidnet_tpu_torch.utils.spans import span

_BIG = 2.0  # sentinel probability of invalid pixels; any real one is < 1


def _per_pixel_ce(logits, labels, class_weights, ignore_label):
    """(raw per-pixel nll, per-pixel class weight, valid mask) from (..., C)
    logits and (...,) labels. A label outside [0, C) that is not the
    ignore label is valid with nll 0 and weight 0, as in the JAX package."""
    c = logits.shape[-1]
    valid = labels != ignore_label
    safe = torch.where(valid, labels, 0).long()
    onehot = safe[..., None] == torch.arange(c, device=logits.device)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.where(onehot, logp, 0.0).sum(-1)
    if class_weights is not None:
        cw = class_weights_on(class_weights, c, logits.device)
        w = torch.where(onehot, cw, 0.0).sum(-1)
    else:
        w = torch.ones_like(nll)
    return nll, torch.where(valid, w, 0.0), valid


def _own(t):
    """A reduction over this rank's pixels alone: no mesh."""
    return t


def _ce_from_maps(nll, w, divide_by: str = "weights", numel=None, total=_own):
    """Reduce per-pixel (nll, weight) maps to the scalar CE; `total` sums a
    denominator over the mesh (H-sharding), where `numel` is this rank's
    count."""
    wl = nll * w
    if divide_by == "numel":
        if total is not _own:
            return wl.sum() / torch.clamp(total(wl.numel() if numel is None else numel), min=1)
        denom = wl.numel() if numel is None else torch.clamp(torch.as_tensor(numel), min=1)
        return wl.sum() / denom
    return wl.sum() / torch.clamp(total(w.sum()), min=1e-12)


def _ohem_from_maps(nll, w, valid, thres: float, min_kept: int, mesh=None):
    """OHEM reduction over per-pixel maps (reference criterion.py:63-78).
    The k-th smallest valid probability is read from the sorted
    probabilities, exactly, as the reference sorts; k is min(min_kept,
    nvalid-1), so an almost all-ignored batch keeps what the reference
    keeps. (torch.kthvalue is exact too, but wants k on the host and took
    30 ms per call on the 6.3 M pixels of a training batch on an H100.)

    Over a `mesh` (H-sharding) the pool is global: k counts the mesh's
    valid pixels, the k-th smallest is read from the sorted union of every
    rank's min_kept + 1 smallest (padded with +inf), which holds the
    global k + 1 smallest, and the kept count is the mesh's; the result is
    this rank's kept losses over it."""
    min_kept = max(1, int(min_kept))
    wl = nll * w
    true_prob = torch.where(valid, torch.exp(-nll.detach()), _BIG).reshape(-1)
    with span("loss.ohem"):
        if mesh is None:
            k = torch.clamp(valid.sum() - 1, max=min_kept).clamp(0, true_prob.numel() - 1)
            kth = torch.take(torch.sort(true_prob).values, k)
        else:
            k = torch.clamp(mesh.total(valid.sum()) - 1, max=min_kept)
            k = k.clamp(0, mesh.size * true_prob.numel() - 1)
            smallest = torch.sort(true_prob).values[:min_kept + 1]
            smallest = torch.nn.functional.pad(smallest, (0, min_kept + 1 - smallest.numel()),
                                               value=float("inf"))
            kth = torch.take(torch.sort(mesh.world_gather(smallest)).values, k)
    threshold = torch.clamp(kth, min=thres)
    keep = valid.reshape(-1) & (true_prob < threshold)
    kept = torch.where(keep, wl.reshape(-1), 0.0)
    count = keep.sum() if mesh is None else mesh.total(keep.sum())
    return kept.sum() / torch.clamp(count, min=1)


def cross_entropy(logits, labels, class_weights=None, ignore_label=-1,
                  divide_by: str = "weights", numel=None):
    """Mean-reduced weighted CE: divided by the sum of kept class weights
    ("weights", torch's CrossEntropyLoss mean) or by the pixel count
    ("numel", the reference OHEM criterion's aux-head quirk; `numel`
    overrides the count)."""
    nll, w, _ = _per_pixel_ce(logits, labels, class_weights, ignore_label)
    return _ce_from_maps(nll, w, divide_by, numel)


def ohem_cross_entropy(logits, labels, class_weights=None, ignore_label=-1,
                       thres: float = 0.7, min_kept: int = 100000):
    """Online hard-example mining CE (reference criterion.py:63-78)."""
    nll, w, valid = _per_pixel_ce(logits, labels, class_weights, ignore_label)
    return _ohem_from_maps(nll, w, valid, thres, min_kept)


def weighted_bce(bd_logits, targets, numel=None, total=_own):
    """Class-balanced BCE-with-logits on the 1-channel boundary logits,
    (N,H,W,1) or (N,H,W); targets outside {0,1} get weight 0. Mean over all
    pixels; `numel` overrides the denominator. `total` sums the positive
    and negative counts over the mesh (H-sharding), where `numel` is the
    global count."""
    logits = bd_logits.reshape(-1).float()
    t = targets.reshape(-1).float()
    pos, neg = t == 1.0, t == 0.0
    pos_num, neg_num = total(pos.sum()), total(neg.sum())
    counted = torch.clamp(pos_num + neg_num, min=1)
    weight = torch.where(pos, neg_num / counted, torch.where(neg, pos_num / counted, 0.0))
    bce = torch.clamp(logits, min=0.0) - logits * t + torch.log1p(torch.exp(-logits.abs()))
    denom = logits.numel() if numel is None else torch.clamp(torch.as_tensor(numel), min=1)
    return (weight * bce).sum() / denom


def boundary_loss(bd_logits, targets, coeff_bce: float = 20.0):
    """BondaryLoss [sic] (reference criterion.py:122-132)."""
    return coeff_bce * weighted_bce(bd_logits, targets)


class FullLoss:
    """The PIDNet training objective (reference utils/utils.py:21-57).

    `loss, metrics = full_loss(outputs, labels, bd_gt)` with outputs =
    [p_logits, logits, d_logits] NHWC at 1/8 resolution; every head is
    compared at label size with align_corners=`align_corners`. With
    `mesh=` (a `parallel.spatial.SpatialMesh`) the outputs and labels are
    this rank's rows of an H-sharded batch, and the loss and metrics its
    contributions to the global values (the module docstring)."""

    def __init__(self, *, num_outputs: int = 2, align_corners: bool = True,
                 ignore_label: int = 255, class_weights=None, use_ohem: bool = True,
                 ohem_thres: float = 0.9, ohem_kept: int = 131072,
                 balance_weights=(0.4, 1.0), sb_weights: float = 1.0, bd_coeff: float = 20.0):
        self.align_corners = align_corners
        self.ignore_label = ignore_label
        self.class_weights = class_weights
        self.use_ohem = use_ohem
        self.ohem_thres = ohem_thres
        self.ohem_kept = ohem_kept
        self.balance_weights = tuple(balance_weights)
        self.sb_weights = sb_weights
        self.bd_coeff = bd_coeff
        if num_outputs != len(self.balance_weights):
            raise ValueError(f"num_outputs {num_outputs} != {len(self.balance_weights)} "
                             "balance weights")

    def _maps(self, logits, labels, out_hw, rows=None):
        """Per-pixel (nll, weight, valid) at label resolution from low-res
        logits, through the fused upsample + CE (ops/ce_front.ce_maps), over
        the window `rows` of output rows (None: the whole image)."""
        if self.class_weights is not None:
            # kept on the device after the first call: a copy from host
            # memory waits for the device
            self.class_weights = class_weights_on(self.class_weights, logits.shape[-1],
                                                  logits.device)
        nll, w = ce_maps(logits, labels, self.class_weights, self.ignore_label, out_hw,
                         self.align_corners, rows)
        return nll, w, labels != self.ignore_label

    def _single_maps(self, maps, use_ohem, numel=None, mesh=None):
        nll, w, valid = maps
        if use_ohem:
            return _ohem_from_maps(nll, w, valid, self.ohem_thres, self.ohem_kept, mesh)
        # inside the OHEM criterion the aux head's plain CE is normalised by
        # the pixel count; the non-OHEM criterion uses torch's weighted mean
        divide_by = "numel" if self.use_ohem else "weights"
        return _ce_from_maps(nll, w, divide_by, numel, _own if mesh is None else mesh.total)

    def sem_loss(self, scores: list, labels, numel=None, out_hw=None, final_maps=None,
                 mesh=None, windows=None):
        """Balance-weighted semantic loss: plain CE on all but the last
        head, OHEM on the last; `final_maps` supplies the last head's maps.
        Over a `mesh`, `windows` holds each (halo'd) head's window of output
        rows and `numel` is this rank's pixel count."""
        out_hw = out_hw or (labels.shape[1], labels.shape[2])
        if len(scores) != len(self.balance_weights):
            raise ValueError(
                f"lengths of prediction ({len(scores)}) and LOSS.BALANCE_WEIGHTS "
                f"({len(self.balance_weights)}) are not identical")
        windows = windows or [None] * len(scores)
        losses = []
        for i, (bw, s, rows) in enumerate(zip(self.balance_weights, scores, windows)):
            is_last = i == len(scores) - 1
            maps = (final_maps if is_last and final_maps is not None
                    else self._maps(s, labels, out_hw, rows))
            losses.append(bw * self._single_maps(maps, self.use_ohem and is_last, numel, mesh))
        return sum(losses)

    def halo_heads(self, outputs: list, h: int, mesh=None) -> list:
        """Each head with its halo rows and its window of the `h` label rows
        (H-sharding, parallel/spatial.halo_rows); the head itself and None
        on one device."""
        return [(o, None) if mesh is None else SP.halo_rows(o, h, self.align_corners, mesh)
                for o in outputs]

    def __call__(self, outputs: list, labels, bd_gt, sample_mask=None, mesh=None, heads=None):
        """`sample_mask` (N,) in {0,1} makes padding samples inert in every
        term (ignore labels for CE/OHEM, weight 0 in the BCE, out of the
        accuracy and of the numel denominator). `mesh`: see the class
        docstring; `heads`, where the caller has them, `halo_heads` of the
        outputs."""
        h, w = labels.shape[1], labels.shape[2]
        heads = heads if heads is not None else self.halo_heads(outputs, h, mesh)
        seg_heads = [o for o, _ in heads[:-1]]
        windows = [rows for _, rows in heads[:-1]]
        seg_final, final_rows = heads[-2]
        bd_head, bd_rows = heads[-1]
        if bd_rows is not None:
            bd_head = resize_rows(bd_head.permute(0, 3, 1, 2), (h, w), self.align_corners,
                                  bd_rows).permute(0, 2, 3, 1)
        elif tuple(bd_head.shape[1:3]) != (h, w):
            bd_head = resize_bilinear(bd_head, (h, w), self.align_corners)
        total = _own if mesh is None else mesh.total

        numel = None
        sample_valid = None
        if sample_mask is not None:
            sample_valid = sample_mask.reshape(-1, 1, 1) > 0
            labels = torch.where(sample_valid, labels, self.ignore_label)
            bd_gt = torch.where(sample_valid, bd_gt, -1.0)
            numel = sample_mask.float().sum() * (h * w)
        elif mesh is not None:
            numel = labels.numel()

        # pixel accuracy of the final head; as in the reference every label
        # >= 0 counts, so ignored pixels count against it
        preds = upsample_argmax_rows(seg_final.detach().contiguous(), (h, w),
                                     self.align_corners, final_rows)
        valid = labels >= 0
        if sample_valid is not None:
            valid = valid & sample_valid
        acc = (valid & (preds == labels)).sum() / (total(valid.sum()) + 1e-10)

        # one ce_maps call serves both final-head terms: the boundary-aware
        # CE differs from the OHEM term only in which pixels are valid
        nll_f, w_f, valid_f = self._maps(seg_final, labels, (h, w), final_rows)
        final_maps = (nll_f, w_f, valid_f)

        loss_s = self.sem_loss(seg_heads, labels, numel, (h, w), final_maps, mesh, windows)
        with span("loss.boundary"):
            loss_b = self.bd_coeff * weighted_bce(
                bd_head, bd_gt, numel if mesh is None else total(numel), total)

            bd_conf = torch.sigmoid(bd_head[..., 0].float()) > 0.8
            sb_maps = (nll_f, torch.where(bd_conf, w_f, 0.0), valid_f & bd_conf)
            loss_sb = self.sb_weights * self._single_maps(sb_maps, self.use_ohem, numel, mesh)

        loss = loss_s + loss_b + loss_sb
        metrics = {"loss": loss, "acc": acc, "sem_loss": loss_s, "bce_loss": loss_b,
                   "sb_loss": loss_sb}
        return loss, metrics
