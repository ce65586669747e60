"""BatchNorm folding for the inference path (counterpart of
pidnet_tpu/convert/fold.py).

- every conv+BN pair (each module's `fold_pairs`) collapses into a biased
  conv:  w' = w * g/sqrt(v+eps),  b' = beta - g*m/sqrt(v+eps) (+ the conv's
  own bias times the same scale, for the stem);
- every remaining standalone BN (pre-activation BNs of the heads, PAPPM,
  DAPPM and Bag; BiSeNet's `bn_atten` and FFM `bn`, which follow a plain
  conv that `fold_pairs` does not list, as the JAX fold records only
  `ops.convbn` pairs) becomes a per-channel `scale`/`shift`.

It works for every family (`models.pidnet.module_for`).

The JAX package also emits space-to-depth stem weights (`s2d.*`); the port
runs the canonical stem and has none. `models.pidnet.build(spec, sd,
folded=True)` consumes the result. `calibrate_bn` settles the running
statistics of random weights before folding.
"""

from __future__ import annotations

import torch

from pidnet_tpu_torch.models import pidnet as M
from pidnet_tpu_torch.nn.functional import BN_EPS


@torch.no_grad()
def calibrate_bn(state_dict: dict, spec, x, iters: int = 12) -> dict:
    """BN running statistics settled on real activations: `iters`
    training-mode forwards of NHWC `x` (no gradient step), on x's device.
    Returns the new running_mean/running_var tensors by name.

    At random init BN is the identity, so activations and logits explode
    with depth; a few training-mode forwards move the running statistics
    toward the activations' own, as a real run's first steps do."""
    x = torch.as_tensor(x)
    model = M.build(spec, state_dict, device=x.device, train=True)
    for _ in range(iters):
        model(x)
    return {k: v for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _bn_scale(sd: dict, bn: str) -> torch.Tensor:
    return sd[bn + ".weight"] * torch.reciprocal(torch.sqrt(sd[bn + ".running_var"] + BN_EPS))


def fold_state_dict(sd: dict, spec) -> dict:
    """Unfolded state dict -> folded state dict for `spec` (keys of heads
    the spec does not build are ignored)."""
    with torch.device("meta"):
        model = M.module_for(spec)(spec)
    pairs = model.conv_bn_pairs()
    paired_bns = {bn for _, bn in pairs}
    folded = {}
    for conv, bn in pairs:
        scale = _bn_scale(sd, bn)
        folded[conv + ".weight"] = sd[conv + ".weight"] * scale.view(-1, 1, 1, 1)
        bias = sd[bn + ".bias"] - sd[bn + ".running_mean"] * scale
        if conv + ".bias" in sd:  # the stem convs already carry a bias
            bias = bias + sd[conv + ".bias"] * scale
        folded[conv + ".bias"] = bias
    for name, mod in model.named_modules():
        if isinstance(mod, M.Conv2d) and name + ".weight" not in folded:
            folded[name + ".weight"] = sd[name + ".weight"]
            if mod.bias is not None:
                folded[name + ".bias"] = sd[name + ".bias"]
        elif isinstance(mod, M.BatchNorm) and name not in paired_bns:
            scale = _bn_scale(sd, name)
            folded[name + ".scale"] = scale
            folded[name + ".shift"] = sd[name + ".bias"] - sd[name + ".running_mean"] * scale
    return folded
