"""Weight formats in and out of the port (counterpart of
pidnet_tpu/convert/torch_weights.py).

- JAX parameter/state dicts (HWIO conv weights, any float dtype) <->
  port state dicts (OIHW float32 torch tensors, the same key names), and a
  whole JAX TrainState (params, state, SGD momentum keyed like params);
- the `.npz` format of runs/train2k/weights_f16.npz: `p.<name>` params and
  `s.<name>` BN state, float16, HWIO;
- reference PyTorch `.pt`/`.pth.tar` checkpoints, whose keys may carry the
  FullModel `model.` prefix and BN `num_batches_tracked` counters, and the
  port's own `{params, state}` payloads (train/checkpoint.py);
- the tolerant merge of any of them into a model's state dict, and the
  reference layout out (`export_state_dict`).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

log = logging.getLogger(__name__)


def normalize_keys(sd: dict) -> dict:
    """Strip the FullModel ``model.`` prefix if present and drop BN counters."""
    out = {}
    for k, v in sd.items():
        if k.startswith("model."):
            k = k[len("model."):]
        if k.endswith("num_batches_tracked"):
            continue
        out[k] = v
    return out


def from_jax(params: dict, state: dict) -> dict:
    """JAX (params, state) of numpy-convertible arrays -> port state dict:
    float32 tensors, conv weights HWIO -> OIHW."""
    sd = {}
    for k, v in {**params, **state}.items():
        arr = np.asarray(v, dtype=np.float32)
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        sd[k] = torch.tensor(arr)
    return sd


def to_jax(state_dict: dict) -> tuple[dict, dict]:
    """Port state dict -> JAX (params, state) numpy dicts (OIHW -> HWIO);
    BN running statistics go to `state`."""
    params, state = {}, {}
    for k, v in state_dict.items():
        arr = v.detach().cpu().float().numpy()
        if arr.ndim == 4:
            arr = np.ascontiguousarray(arr.transpose(2, 3, 1, 0))
        target = state if k.endswith(("running_mean", "running_var")) else params
        target[k] = arr
    return params, state


def train_state_from_jax(params: dict, state: dict, momentum: dict) -> tuple[dict, dict]:
    """A JAX TrainState's (params, state, momentum) -> (port state dict,
    port momentum dict), both OIHW float32."""
    return from_jax(params, state), from_jax(momentum, {})


def train_state_to_jax(state_dict: dict, momentum: dict) -> tuple[dict, dict, dict]:
    """Port (state dict, momentum dict) -> JAX (params, state, momentum)
    numpy dicts, HWIO."""
    params, state = to_jax(state_dict)
    return params, state, to_jax(momentum)[0]


def load_npz(path: str) -> dict:
    """The `p.`/`s.` npz format (e.g. runs/train2k/weights_f16.npz) -> port
    state dict."""
    with np.load(path) as z:
        params = {k[2:]: z[k] for k in z.files if k.startswith("p.")}
        state = {k[2:]: z[k] for k in z.files if k.startswith("s.")}
    return from_jax(params, state)


def load_pt(path: str) -> dict:
    """A reference `.pt`/`.pth.tar` checkpoint, bare or under a `state_dict`
    key, or one of the port's `{params, state}` payloads -> port state dict
    (float32, already OIHW)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if "params" in payload:
        payload = {**payload["params"], **payload["state"]}
    elif "state_dict" in payload:
        payload = payload["state_dict"]
    return {k: v.float() for k, v in normalize_keys(payload).items()}


def load(path: str) -> dict:
    """Load `.npz` (train2k format) or `.pt`/`.pth`/`.pth.tar` weights."""
    if path.endswith(".npz"):
        return load_npz(path)
    return load_pt(path)


def merge_state_dict(sd: dict, template: dict) -> tuple[dict, int]:
    """Merge state dict `sd` (port layout; `model.` prefixes and BN counters
    allowed) into `template`, the reference's strict=False load
    (models/pidnet.py:196,208): keys the template lacks, or whose shapes
    differ, are skipped. Returns (merged float32 state dict, tensors
    loaded)."""
    merged = dict(template)
    n_loaded = 0
    for k, v in normalize_keys(sd).items():
        if k not in merged:
            log.debug("skip (unknown): %s", k)
            continue
        v = torch.as_tensor(v).detach().to("cpu", torch.float32)
        if tuple(merged[k].shape) != tuple(v.shape):
            log.debug("skip (shape): %s %s vs %s", k, tuple(merged[k].shape), tuple(v.shape))
            continue
        merged[k] = v
        n_loaded += 1
    log.info("Loaded %d parameters!", n_loaded)
    return merged, n_loaded


def export_state_dict(state_dict: dict, prefix: str = "model.") -> dict:
    """Port state dict -> the reference's layout: float32 CPU tensors under
    the FullModel `model.` prefix, conv weights OIHW, which the reference's
    get_seg_model loads."""
    return {prefix + k: v.detach().to("cpu", torch.float32) for k, v in state_dict.items()}
