"""Weight formats in and out of the port (counterpart of
pidnet_tpu/convert/torch_weights.py).

- JAX parameter/state dicts (HWIO conv weights, any float dtype) <->
  port state dicts (OIHW float32 torch tensors, the same key names), and a
  whole JAX TrainState (params, state, SGD momentum keyed like params);
- the `.npz` format of runs/train2k/weights_f16.npz: `p.<name>` params and
  `s.<name>` BN state, float16, HWIO;
- reference PyTorch `.pt`/`.pth.tar` checkpoints, whose keys may carry the
  FullModel `model.` prefix and BN `num_batches_tracked` counters.
"""

from __future__ import annotations

import numpy as np
import torch


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
    """A reference `.pt`/`.pth.tar` checkpoint -> port state dict (float32,
    already OIHW)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in payload:
        payload = payload["state_dict"]
    return {k: v.float() for k, v in normalize_keys(payload).items()}


def load(path: str) -> dict:
    """Load `.npz` (train2k format) or `.pt`/`.pth`/`.pth.tar` weights."""
    if path.endswith(".npz"):
        return load_npz(path)
    return load_pt(path)
