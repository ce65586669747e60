"""Checkpoint save and restore (counterpart of
pidnet_tpu/train/checkpoint.py), the reference's three artifacts
(tools/train.py:190-210):

- ``checkpoint.pt``  - the whole training state {epoch, iter, best_mIoU,
  params, state, momentum}, the resume target;
- ``best.pt``        - params and BN state on an mIoU improvement;
- ``final_state.pt`` - params and BN state at the end.

A model payload written by `tools.convert --fold` holds BN-folded tensors
(convert/fold.py) and no BN state, tagged ``"folded": True``: its conv
weights share the unfolded names, so loaders route on `is_folded` and
never merge it into an unfolded model.

Tensors are keyed by the JAX package's names, in the port's layout (conv
weights OIHW). The format is `torch.save`, written to a temporary file and
moved into place. The JAX package writes flax msgpack, which the port
cannot read or write; convert/weights.py carries a state across in memory.
"""

from __future__ import annotations

import os
from typing import Any

import torch

from pidnet_tpu_torch.train.step import TrainState


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree.detach().cpu().clone() if torch.is_tensor(tree) else tree


def save(path: str, payload: dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(_to_host(payload), tmp)
    os.replace(tmp, path)


def load(path: str) -> dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=True)


def save_train_checkpoint(out_dir: str, epoch: int, best_miou: float, ts: TrainState,
                          it: int = 0) -> str:
    """`it` is the count of iterations completed within `epoch` (0 at an
    epoch boundary), so a resume skips the steps already applied."""
    path = os.path.join(out_dir, "checkpoint.pt")
    save(path, {"epoch": epoch, "iter": int(it), "best_mIoU": float(best_miou),
                "params": ts.params(), "state": ts.state(), "momentum": ts.momentum})
    return path


def load_train_checkpoint(out_dir: str):
    path = os.path.join(out_dir, "checkpoint.pt")
    if not os.path.isfile(path):
        return None
    return load(path)


@torch.no_grad()
def restore_train_state(ts: TrainState, payload: dict) -> TrainState:
    """Copy a checkpoint's params, BN state and momentum into `ts` in place."""
    tensors = {**payload["params"], **payload["state"]}
    for k, v in ts.model.state_dict().items():
        v.copy_(tensors[k])
    for k, v in ts.momentum.items():
        v.copy_(payload["momentum"][k])
    return ts


def save_model(path: str, params: dict, state: dict, *, folded: bool = False) -> None:
    payload = {"params": params, "state": state}
    if folded:
        payload["folded"] = True
    save(path, payload)


def is_folded(path: str) -> bool:
    """True when `path` is a model payload tagged as BN-folded."""
    if path.endswith(".npz"):
        return False
    payload = load(path)
    return isinstance(payload, dict) and bool(payload.get("folded", False))


def load_model(path: str):
    payload = load(path)
    return payload["params"], payload["state"]
