"""K1 (csrc/upsample_argmax.cu): its bound a call, at the served logits'
shape (the batch at 1/8 of the frame, in the served dtype) to the frame's class map, over
its device time a call in the traced calls."""

from perfbench.harness import counts
from perfbench.harness.program import DTYPES
from perfbench.harness.readers import roofline_pct


def read(run):
    t = run.traffic
    shape = (t["batch"], t["height"] // 8, t["width"] // 8, run.config["num_classes"])
    itemsize = DTYPES[run.config["serve"]["dtype"]].itemsize
    bound, _ = counts.upsample_argmax_bound_s(shape, (t["height"], t["width"]), itemsize)
    return roofline_pct(run, "upsample_argmax", bound * run.trace_count)
