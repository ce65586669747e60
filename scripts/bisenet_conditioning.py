"""How far one fp32 train step of BiSeNetV1 moves when its input moves by
a relative 1e-7: the cosine between the updates of two one-device steps
(`train.step.make_train_step`, FullLoss with BiSeNet's three balance
weights, OHEM kept 500) from the same seeded weights, on noise frames of
128x128 and on the same frames perturbed, for batches of 2 and of 4.

    python scripts/bisenet_conditioning.py [--device cpu]

BiSeNet's BNs after each global pool normalise an (N, C, 1, 1) vector in
training mode. Over the pooled vectors of 2 noise frames, which nearly
coincide, they amplify rounding, so two correct implementations of the
step (one device and an H-sharded mesh, or the port and the JAX package)
differ at 2 samples by more than tests/test_torch_spatial.py's step bound;
tests/test_torch_spatial_families.py takes 4.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pidnet_tpu_torch import resolve_device  # noqa: E402
from pidnet_tpu_torch.losses.criterion import FullLoss  # noqa: E402
from pidnet_tpu_torch.models import pidnet as M  # noqa: E402
from pidnet_tpu_torch.tools.common import spec_from_name  # noqa: E402
from pidnet_tpu_torch.train.step import TrainState, make_train_step  # noqa: E402

H = 128


def update(spec, sd, batch, dev) -> np.ndarray:
    """The flat parameter update of one fp32 step on `batch`."""
    bw = M.balance_weights(spec)
    ts = TrainState.create(M.build(spec, sd, device=dev, train=True))
    loss = FullLoss(num_outputs=len(bw), balance_weights=bw, ignore_label=255, ohem_thres=0.9,
                    ohem_kept=500)
    make_train_step(ts, loss, momentum=0.9, weight_decay=5e-4)(
        *(torch.from_numpy(a).to(dev) for a in batch), 0.01)
    return np.concatenate([(v.cpu().numpy() - sd[k].numpy()).ravel()
                           for k, v in sorted(ts.params().items())])


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help="the card unless cpu is named")
    dev = resolve_device(parser.parse_args(argv).device)
    torch.backends.cudnn.allow_tf32 = False
    spec = spec_from_name("bisenet", 19)
    sd = M.init(spec, torch.Generator().manual_seed(3))
    for n in (2, 4):
        rng = np.random.default_rng(11)
        img = rng.standard_normal((n, H, H, 3)).astype(np.float32)
        lab = rng.integers(0, 19, (n, H, H)).astype(np.int32)
        lab[0, :8] = 255
        edge = (rng.random((n, H, H)) < 0.1).astype(np.float32)
        noise = np.random.default_rng(1).standard_normal(img.shape)
        moved = (img * (1 + 1e-7 * noise)).astype(np.float32)
        a, b = update(spec, sd, (img, lab, edge), dev), update(spec, sd, (moved, lab, edge), dev)
        cos = float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))
        print(f"BiSeNetV1, {n} samples of {H}x{H} on {dev}: update cosine {cos:.6f} under a "
              f"1e-7 relative input perturbation", flush=True)


if __name__ == "__main__":
    main()
