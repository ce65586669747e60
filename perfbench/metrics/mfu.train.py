"""A training step's conv FLOPs (the forward, and the backward's input and
weight products but the image's input gradient, counted from the
reference's conv shapes) times the window's steps, over the window's
seconds x 989 TFLOP/s."""

from perfbench.harness import counts
from perfbench.harness.readers import utilisation_pct


def read(run):
    t = run.traffic
    flops = counts.train_flops(run.config, t["batch"], t["height"], t["width"])
    return utilisation_pct(flops, run.obs["steps"], run.obs["window_s"])
