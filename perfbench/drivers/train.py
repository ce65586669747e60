"""Training: a closed loop of the program's training step,
`train.step.make_train_step`, on the configuration's recipe (its model in
training mode, `losses.criterion.FullLoss` with the recipe's OHEM, class
weights, balance and boundary weights, SGD with momentum and weight decay,
convs in the configured dtype on fp32 weights).

Set-up builds the one step object from the harness's seeded weights and
drives it through its first `checked_steps` steps, each on another of the
mix's pre-made batches, reading each step's loss, the update direction
the optimizer holds after the first (its momentum buffers, g + wd*p) and
each leaf's change after the last; then `warmup_steps` more. The window
hands that same object on and runs steps, cycling over the batches,
without synchronising between them; it ends when the last step's loss is
read. `traffic` keys: batch, height, width, batches, regions,
ignore_share, noise, edge_width, checked_steps, warmup_steps, trace_steps.

`correct` (`judge`): the reference follows the first `checked_steps`
steps in float32 from the same weights on the same batches (the recipe's
leaves are the parameters and the BN running statistics). Per leaf, the
gap between the program's norm and the reference's, over the larger of
the reference's norm of that leaf and of the median leaf, is read for
the first step's update direction and for the change over the checked
steps, and the relative norm of the difference of the whole first update
direction; each step's loss gap is read too (`readings`). Three are
compared (`compared`). Leaves whose first gradient in the reference is
under a thousandth of the median leaf's (a conv bias under a BN: nought
to rounding, moved by round-off alone) are left out of all of them.
"""

from __future__ import annotations

import gc
import statistics
import time

import torch

from perfbench.harness import inputs
from perfbench.harness.cell import mark
from perfbench.harness.program import DTYPES, spec_of
from perfbench.reference import train as R
from perfbench.reference.quant import float8


def recipe(run) -> dict:
    """The configuration's training recipe at the mix's batch: OHEM's
    kept pixels in proportion to the batch per GPU."""
    t = dict(run.config["train"])
    t["min_kept"] = t["ohem_kept"] * run.traffic["batch"] // t["batch_per_gpu"]
    return t


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _faulty(step, ts, fault: str | None):
    """The step with a planted fault (the benchmark's own tests)."""
    if fault is None:
        return step
    if fault == "unchanged":
        def unchanged(images, labels, edges, lr):
            leaves = [*ts.model.parameters(), *ts.model.buffers(), *ts.momentum.values()]
            saved = [t.detach().clone() for t in leaves]
            out = step(images, labels, edges, lr)
            with torch.no_grad():
                torch._foreach_copy_(leaves, saved)
            return out
        return unchanged
    if fault == "half_batch":
        def half(images, labels, edges, lr):
            n = images.shape[0] // 2
            return step(images[:n], labels[:n], edges[:n], lr)
        return half
    raise ValueError(f"train has no fault {fault!r}")


def _norms(tensors) -> list[float]:
    return torch.stack(torch._foreach_norm([t.float() for t in tensors])).tolist()


def setup(run) -> dict:
    from pidnet_tpu_torch.losses.criterion import FullLoss
    from pidnet_tpu_torch.models import pidnet as M
    from pidnet_tpu_torch.train.step import TrainState, make_train_step

    rec = recipe(run)
    mark(run, "port_imports")
    spec = spec_of(run.config, augment=True)
    torch.empty(0, device=run.device)  # the CUDA context
    mark(run, "context")
    weights = inputs.weights(run.config, run.device, run.seed)
    mark(run, "weights")
    ts = TrainState.create(M.build(spec, weights, device=run.device, train=True))
    loss_fn = FullLoss(
        num_outputs=len(rec["balance_weights"]), align_corners=rec["align_corners"],
        ignore_label=rec["ignore_label"],
        class_weights=torch.tensor(rec["class_weights"], device=run.device),
        use_ohem=True, ohem_thres=rec["ohem_thres"], ohem_kept=rec["min_kept"],
        balance_weights=rec["balance_weights"], sb_weights=rec["sb_weights"],
        bd_coeff=rec["bd_coeff"])
    step = make_train_step(ts, loss_fn, momentum=rec["momentum"],
                           weight_decay=rec["weight_decay"], nesterov=rec["nesterov"],
                           compute_dtype=DTYPES[rec["dtype"]])
    step = _faulty(step, ts, run.fault)
    mark(run, "program")
    batches = inputs.crops(run.traffic, run.config, run.device, run.seed)
    mark(run, "crops")
    checked = run.traffic["checked_steps"]
    if len(batches) < checked:
        raise ValueError("the mix needs a batch of its own for each checked step")
    names = [k for k, _ in ts.model.named_parameters()]
    leaves = dict(ts.model.named_parameters())
    leaves.update({k: v for k, v in ts.model.named_buffers() if k.endswith(R.STAT_SUFFIXES)})
    losses = []
    for s in range(checked):
        losses.append(float(step(*batches[s], rec["lr"])["loss"]))
        mark(run, f"step{s}")
        if s == 0:
            first = {k: ts.momentum[k].detach().clone() for k in names}
    after = {k: v.detach().clone() for k, v in leaves.items()}
    change = dict(zip(after, _norms([v - weights[k] for k, v in after.items()])))
    for s in range(run.traffic["warmup_steps"]):
        float(step(*batches[(checked + s) % len(batches)], rec["lr"])["loss"])
    mark(run, "warmup")
    program = {"losses": losses, "first": first, "change": change, "after": after,
               "dir1": dict(zip(names, _norms([first[k] for k in names])))}
    return {"step": step, "ts": ts, "weights": weights, "batches": batches, "rec": rec,
            "program": program, "next": checked + run.traffic["warmup_steps"]}


def window(run, st: dict, seconds: float) -> dict:
    step, batches, lr = st["step"], st["batches"], st["rec"]["lr"]
    enqueue = []
    _sync(run.device)
    t0 = time.perf_counter()
    steps = 0
    while True:
        t = time.perf_counter()
        metrics = step(*batches[(st["next"] + steps) % len(batches)], lr)
        enqueue.append(time.perf_counter() - t)
        steps += 1
        if time.perf_counter() - t0 >= seconds:
            break
    loss = float(metrics["loss"])
    window_s = time.perf_counter() - t0
    st["next"] += steps
    finite = loss == loss and abs(loss) != float("inf")
    return {"window_s": window_s, "steps": steps, "units": steps * batches[0][0].shape[0],
            "enqueue_s": enqueue, "attempted": steps, "failed": 0 if finite else 1}


def profile(run, st: dict) -> tuple:
    step, batches, lr = st["step"], st["batches"], st["rec"]["lr"]

    def one(i):
        step(*batches[(st["next"] + i) % len(batches)], lr)

    return one, run.traffic["trace_steps"]


def free(st: dict) -> None:
    st["step"] = st["ts"] = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def readings(mine: dict, ref: dict, start: dict) -> dict:
    """Every number one run (`mine`) reads against the reference (`ref`,
    `reference.train.sgd_steps`'s), both from the leaves `start`: the
    relative gap of each step's loss; per leaf, the gap of the norms of
    the first update direction and of the change (the worst leaf's and
    the median leaf's); the relative norm of the difference of the whole
    first update direction; and, of the worst leaf's change, the norms
    that show its cause (`change_worst_norms`: the reference's change, the
    run's, their difference, and the leaf's norm at the start)."""
    med_g = statistics.median(ref["grad1"].values())
    kept = sorted(k for k, g in ref["grad1"].items() if g >= 1e-3 * med_g)
    kept_change = sorted(k for k in ref["change"] if k in kept or k.endswith(R.STAT_SUFFIXES))

    def gaps(a, b, keys):
        med = statistics.median(b[k] for k in keys)
        return {k: abs(a[k] - b[k]) / max(b[k], med) for k in keys}

    grad, moved = gaps(mine["dir1"], ref["dir1"], kept), gaps(mine["change"], ref["change"],
                                                              kept_change)
    diff = sum(float((mine["first"][k] - ref["first"][k]).float().square().sum()) for k in kept)
    total = sum(float(ref["first"][k].float().square().sum()) for k in kept)
    worst = max(moved, key=moved.get)
    return {
        "loss_steps": [abs(a - b) / abs(b) for a, b in zip(mine["losses"], ref["losses"])],
        "grad_worst": max(grad.values()), "grad_worst_leaf": max(grad, key=grad.get),
        "grad_median": statistics.median(grad.values()),
        "grad_diff": (diff / total) ** 0.5,
        "change_worst": moved[worst], "change_worst_leaf": worst,
        "change_worst_norms": {
            "reference": ref["change"][worst], "run": mine["change"][worst],
            "difference": float((mine["after"][worst] - ref["after"][worst]).float().norm()),
            "start": float(start[worst].float().norm())},
        "change_median": statistics.median(moved.values()),
        "left_out": sorted(set(ref["grad1"]) - set(kept)),
    }


def compared(r: dict) -> dict:
    """The numbers `correct` holds to their limits: the median leaf's gap
    of the norms of the first update direction (`grad`) and of the change
    (`change`), and the relative difference of the whole first update
    direction (`update`), the one of these that a float8 step moves far
    past a bfloat16 one. The losses and the worst leaf's gaps are read
    (`readings`) and not compared: PERF.md gives the readings behind each
    choice and limit."""
    return {"grad": r["grad_median"], "change": r["change_median"], "update": r["grad_diff"]}


def _reference(run, st: dict, precision=None):
    checked = run.traffic["checked_steps"]
    return R.sgd_steps(inputs.reference(run.config), st["weights"], st["batches"][:checked],
                       {**run.config, "augment": True}, st["rec"], checked,
                       precision=precision)


def judge(run, st: dict) -> dict:
    free(st)
    st["readings"] = readings(st["program"], _reference(run, st), st["weights"])
    return compared(st["readings"])


def control(run, st: dict) -> dict:
    """The control's reading: the reference in float8 put in the
    program's place, from the same weights on the same batches."""
    free(st)
    low = _reference(run, st, precision=float8)
    st["readings"] = readings(low, _reference(run, st), st["weights"])
    return compared(st["readings"])
