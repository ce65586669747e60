"""Shared CLI plumbing (counterpart of pidnet_tpu/tools/common.py): the
model spec from a config, random weights, weight loading from every
container the CLIs take, and the XLA.PROFILE_DIR trace.

Weights are port state dicts (train/checkpoint.py's names, conv weights
OIHW, float32 on the CPU); a `template` is the state dict of the model
being filled, usually `init_model`'s.
"""

from __future__ import annotations

import logging
import os

import torch

from pidnet_tpu_torch.convert import weights as W
from pidnet_tpu_torch.convert.fold import fold_state_dict
from pidnet_tpu_torch.models import pidnet as M
from pidnet_tpu_torch.train import checkpoint as ckpt
from pidnet_tpu_torch.utils import spans

log = logging.getLogger("pidnet_tpu_torch")


def spec_from_name(name: str, num_classes: int, augment: bool = True):
    """The model spec of a name: `ddrnet*` and `bisenet*` build the
    reference's paper ablations (models/ddrnet.py, models/bisenet.py);
    every other name follows the reference's pidnet substring rule
    (models/pidnet.py:186-191)."""
    if "ddrnet" in name:
        from pidnet_tpu_torch.models import ddrnet

        return ddrnet.spec_for(name, num_classes, augment)
    if "bisenet" in name:
        from pidnet_tpu_torch.models import bisenet

        return bisenet.spec_for(name, num_classes, augment)
    return M.spec_for(name, num_classes, augment)


def build_spec(cfg, augment: bool = True):
    """The model spec of MODEL.NAME (`spec_from_name`)."""
    return spec_from_name(cfg.MODEL.NAME, cfg.DATASET.NUM_CLASSES, augment)


def init_model(cfg, spec, seed: int = 0) -> dict:
    """Random unfolded weights from `seed` (`models.pidnet.init`; its draws
    differ from the JAX package's for the same seed)."""
    return M.init(spec, torch.Generator().manual_seed(seed))


def is_folded_checkpoint(path: str) -> bool:
    """True when `path` is a BN-folded (inference-only) payload written by
    `tools.convert --fold`. Its conv weights keep the unfolded names, so
    merging it into an unfolded model would apply BN twice: every loader
    routes on this."""
    return not path.endswith(".msgpack") and ckpt.is_folded(path)


def load_folded(path: str, spec, template: dict) -> dict:
    """A folded payload as the folded state dict itself (for
    `build(..., folded=True)`), checked against the keys that
    `convert.fold.fold_state_dict` gives for `spec`."""
    payload = ckpt.load(path)
    if not payload.get("folded", False):
        raise ValueError(f"{path} is not a folded checkpoint")
    got = payload["params"]
    want = set(fold_state_dict(template, spec))
    missing = want - set(got)
    if missing:
        raise SystemExit(
            f"folded checkpoint {path} is missing {len(missing)} tensors for this "
            f"architecture (e.g. {sorted(missing)[:3]}); was it converted with the same --a/--c?")
    log.info("Loaded %d folded parameters!", len(want))
    return {k: got[k].float() for k in want}


def load_weights(path: str, template: dict) -> tuple[dict, int]:
    """Merge the weights in `path` into `template` (`convert.weights.
    merge_state_dict`: unknown keys and other shapes are skipped).
    Returns (state dict, tensors loaded).

    - `.npz`: the `p.`/`s.` format of runs/train2k/weights_f16.npz;
    - `.pt`/`.pth`/`.pth.tar`: a reference checkpoint, bare or under a
      `state_dict` key, or the port's own `{params, state}` payload
      (checkpoint.pt, best.pt, final_state.pt, `tools.convert`'s output).

    A folded payload is refused (see `is_folded_checkpoint`), and so is the
    JAX package's `.msgpack`."""
    if path.endswith(".msgpack"):
        raise SystemExit(
            f"{path} is a flax msgpack checkpoint of the JAX package; reading it needs flax. "
            "Save its params and state as .npz (the p./s. format), or carry them across in "
            "memory with convert.weights.from_jax")
    if is_folded_checkpoint(path):
        raise SystemExit(
            f"{path} is a BN-folded inference-only checkpoint: it cannot be loaded into an "
            "unfolded model (conv weights share names but have BN baked in). Use eval "
            "--fold-bn, which loads it onto the folded path directly.")
    return W.merge_state_dict(W.load(path), template)


def maybe_load_pretrained(cfg, template: dict) -> dict:
    """MODEL.PRETRAINED merged into `template` if the file exists (the
    reference's tools/train.py:79-80, models/pidnet.py:184-216); a missing
    file logs a warning and leaves the weights as they were."""
    path = cfg.MODEL.PRETRAINED
    if path and os.path.isfile(path):
        return load_weights(path, template)[0]
    if path:
        log.warning("pretrained file %s not found; training from scratch", path)
    return template


class ProfileTrace:
    """torch.profiler from its creation to `stop()`, written then as the
    Chrome trace `profile_dir`/`file`, with the program's spans recorded
    (`utils.spans.recording`) while it runs, so that they lie above the
    device lanes; does nothing for an empty `profile_dir`. `stop()` may be
    called again."""

    def __init__(self, profile_dir: str, file: str, dev: torch.device):
        self.path = os.path.join(profile_dir, file) if profile_dir else ""
        self.prof = None
        if profile_dir:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.spans = spans.recording()
            self.spans.__enter__()
            self.prof.start()

    def stop(self) -> None:
        if self.prof is not None:
            self.prof.stop()
            self.spans.__exit__(None, None, None)
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            self.prof.export_chrome_trace(self.path)
            self.prof = None
