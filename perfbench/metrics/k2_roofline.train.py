"""K2 (csrc/ce_front.cu ce_fwd_kernel): the bound of every launch in the
traced steps, at its logits' shape and on its labels (the pixels whose
label lies in [0, C) need the softmax), over its device time there."""

import torch

from perfbench.harness.readers import ce_roofline_pct, launches_of


def _counted(logits, labels, *args):
    return ((labels >= 0) & (labels < logits.shape[-1])).sum()


def during_trace(run):
    from pidnet_tpu_torch.ops import ce_front

    return launches_of(run, "k2", ce_front, "ce_front_fwd", _counted)


@torch.no_grad()
def read(run):
    return ce_roofline_pct(run, "k2", "ce_fwd_kernel", backward=False)
