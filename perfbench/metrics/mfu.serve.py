"""The served network's conv FLOPs (2 x the MACs at the mix's batch and
frame size, counted from the reference's conv shapes) times the window's
calls, over the window's seconds x 989 TFLOP/s."""

from perfbench.harness import counts
from perfbench.harness.readers import utilisation_pct


def read(run):
    t = run.traffic
    flops = counts.forward_flops(run.config, False, t["batch"], t["height"], t["width"])
    return utilisation_pct(flops, run.obs["calls"], run.obs["window_s"])
