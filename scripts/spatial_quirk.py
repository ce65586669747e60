"""The JAX package's H-sharded train step against its global program, per
family, on the CPU's virtual devices: the update's cosine and the loss of
`parallel/spatial.make_spatial_train_step` on a (1, 2) and a (2, 2) mesh
against the same function on a (1, 1) mesh, the global program
unpartitioned.

    JAX_PLATFORMS=cpu python scripts/spatial_quirk.py [--hint]

2 samples of 128x128, fp32, the plain layouts (stem_s2d=False,
wfold=False), weights from `init(PRNGKey(0))`, the loss the recipe's
FullLoss with each family's balance weights (OHEMKEEP 500). DDRNet-23's
forward never calls the "pre_spp"/"post_spp" hint, so GSPMD partitions its
DAPPM's large-padding pools; `--hint` runs a copy of that forward with
PIDNet's two hints added (the 1/64 output resized to 8x the map), to show
where the (2, 2) step's gradient goes wrong. The port gathers as the
hinted copy does (pidnet_tpu_torch/models/ddrnet.py).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from pidnet_tpu.losses import FullLoss  # noqa: E402
from pidnet_tpu.models import bisenet, ddrnet  # noqa: E402
from pidnet_tpu.models import pidnet as M  # noqa: E402
from pidnet_tpu.parallel import spatial as S  # noqa: E402
from pidnet_tpu.train import TrainState  # noqa: E402

H = 128


def hinted_ddrnet(ops, x, spec):
    """DDRNet's forward with PIDNet's partitioning hints: the 1/32 map
    unsharded before layer5 and the DAPPM, their output resized to 8x the
    1/64 map and sharded again."""
    seen = {}

    def hint(name, t):
        return M._hint(ops, name, t)

    def layer(ops_, name, t, *args, **kw):
        if name == "layer5":
            t = hint("pre_spp", t)
        return original_layer(ops_, name, t, *args, **kw)

    def dappm(ops_, name, t, *args):
        out = original_dappm(ops_, name, t, *args)
        seen["hw"] = (8 * out.shape[1], 8 * out.shape[2])
        return out

    def resize(t, hw, align):
        if "hw" in seen and t.shape[1] * 8 == seen["hw"][0]:
            seen.pop("hw")
            return hint("post_spp", original_resize(t, (8 * t.shape[1], 8 * t.shape[2]), align))
        return original_resize(t, hw, align)

    original_layer, original_dappm = ddrnet._layer, ddrnet._dappm
    original_resize = ddrnet.resize_bilinear
    ddrnet._layer, ddrnet._dappm, ddrnet.resize_bilinear = layer, dappm, resize
    try:
        return ddrnet._forward(ops, x, spec)
    finally:
        ddrnet._layer, ddrnet._dappm = original_layer, original_dappm
        ddrnet.resize_bilinear = original_resize


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--hint", action="store_true",
                        help="DDRNet-23 with PIDNet's pre_spp/post_spp hints added")
    args = parser.parse_args(argv)
    rng = np.random.default_rng(11)
    img = rng.standard_normal((2, H, H, 3)).astype(np.float32)
    lab = rng.integers(0, 19, (2, H, H)).astype(np.int32)
    edge = (rng.random((2, H, H)) < 0.1).astype(np.float32)
    plain = dict(stem_s2d=False, wfold=False)
    families = [("ddrnet_23", ddrnet, (0.4, 1.0)), ("bisenet", bisenet, (0.4, 0.4, 1.0)),
                ("pidnet_l", M, (0.4, 1.0))]
    for name, mod, bw in families:
        spec = mod.spec_for(name, 19, True)
        if args.hint and mod is ddrnet:
            spec = dataclasses.replace(spec, forward_fn=hinted_ddrnet)
        params, state = jax.device_get(M.init(jax.random.PRNGKey(0), spec))
        loss = FullLoss(num_outputs=len(bw), balance_weights=bw, ignore_label=255,
                        ohem_thres=0.9, ohem_kept=500)
        out = {}
        for shape in ((1, 1), (1, 2), (2, 2)):
            mesh = S.make_mesh_2d(*shape)
            step = S.make_spatial_train_step(spec, loss, mesh, weight_decay=5e-4, **plain)
            fresh = jax.tree.map(jax.numpy.asarray, (params, state))  # the step donates them
            ts, m = step(TrainState.create(*fresh), *S.put_batch(mesh, img, lab, edge), 0.01)
            ts = jax.device_get(ts)
            update = np.concatenate([(np.asarray(ts.params[k]) - np.asarray(params[k])).ravel()
                                     for k in sorted(params)])
            out[shape] = (float(m["loss"]), update)
        ref_loss, ref = out[(1, 1)]
        for shape in ((1, 2), (2, 2)):
            got_loss, got = out[shape]
            cos = float(got @ ref / np.linalg.norm(got) / np.linalg.norm(ref))
            print(f"{name}{' (hinted)' if args.hint and mod is ddrnet else ''} {shape} vs (1, "
                  f"1): loss {got_loss:.7f} vs {ref_loss:.7f}, update cosine {cos:.6f}",
                  flush=True)


if __name__ == "__main__":
    main()
