"""K3 (csrc/ce_front.cu ce_bwd_kernel): the bound of every launch in the
traced steps, at its logits' shape and on its labels and incoming
gradient (the pixels whose label lies in [0, C) and whose gradient is not
0 need the softmax), over its device time there."""

import torch

from perfbench.harness.readers import ce_roofline_pct, launches_of


def _counted(logits, labels, ignore_label, out_hw, align_corners, g, *rest):
    return ((labels >= 0) & (labels < logits.shape[-1]) & (g != 0)).sum()


def during_trace(run):
    from pidnet_tpu_torch.ops import ce_front

    return launches_of(run, "k3", ce_front, "ce_front_bwd", _counted)


@torch.no_grad()
def read(run):
    return ce_roofline_pct(run, "k3", "ce_bwd_kernel", backward=True)
