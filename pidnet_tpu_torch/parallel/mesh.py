"""The data-parallel mesh and its collectives (counterpart of
pidnet_tpu/parallel/mesh.py).

The JAX package's 1-D `data` mesh is one XLA program over many devices:
shard_map runs each shard's forward and `lax.pmean` reduces across them.
Here the mesh is a `torch.distributed` process group with one rank per
device. Each rank holds a replica of the model on its own device and its
share of the global batch, and the steps call the collectives explicitly:

- `Mesh.all_reduce_mean` averages a list of fp32 tensors as one flat
  bucket (a train step's gradients, new BN statistics and metrics), and
  `Mesh.all_reduce_sums` adds them (the H-sharded step's, whose ranks hold
  contributions to one global loss: parallel/spatial.py);
- `Mesh.pmean` is the autograd-aware mean of sync BN: its forward and its
  backward are the same all-reduce mean, the transpose of `lax.pmean`
  inside shard_map;
- `Mesh.all_reduce_sum` adds in place (the eval step's weighted metrics
  and confusion matrices).

One process with no process group is a mesh of one device whose
collectives do nothing. `init_process_group` joins a group from torchrun's
environment: nccl for CUDA devices and gloo for the CPU, unless a backend
is named. gloo also takes CUDA tensors (it stages them through the host),
which lets two ranks share one card where NCCL refuses.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from pidnet_tpu_torch import resolve_device

DATA_AXIS = "data"

TORCHRUN_ENV = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def default_backend(device) -> str:
    """nccl for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_process_group(device, backend: str | None = None) -> str:
    """Join the default process group from torchrun's environment
    (RANK, LOCAL_RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) over
    `backend`, by default `default_backend(device)`; returns the backend.
    Raises, naming torchrun, where that environment is missing."""
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"a multi-process run reads torchrun's environment and {', '.join(missing)} "
            "is not set: start it as torchrun --nproc-per-node N -m "
            "pidnet_tpu_torch.tools.train --multihost ... (or tools.eval --spatial N ...)")
    backend = backend or default_backend(device)
    dist.init_process_group(backend, init_method="env://", rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return backend


class _PMean(torch.autograd.Function):
    """pmean with its transpose: the cotangent is mean-all-reduced too."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        y = x.detach().clone()
        dist.all_reduce(y, group=mesh.group)
        return y / mesh.size

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.mesh.group)
        return g / ctx.mesh.size, None


@dataclass(frozen=True)
class Mesh:
    """A 1-D data mesh: `size` ranks, this process's `rank` and `device`,
    and the process `group` (None for one process without a group)."""

    size: int
    rank: int
    device: torch.device
    group: object = None

    @property
    def backend(self) -> str | None:
        return None if self.group is None else dist.get_backend(self.group)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """`t` summed over the ranks, in place."""
        if self.group is not None:
            dist.all_reduce(t, group=self.group)
        return t

    def all_reduce_mean(self, tensors: list) -> list:
        """The mean over the ranks of each fp32 tensor, as views of one
        flat bucket: a single collective for the whole list."""
        return self._bucket(tensors, mean=True)

    def all_reduce_sums(self, tensors: list) -> list:
        """The sum over the ranks of each fp32 tensor, as views of one flat
        bucket: a single collective for the whole list."""
        return self._bucket(tensors, mean=False)

    def _bucket(self, tensors: list, mean: bool) -> list:
        if self.group is None:
            return list(tensors)
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self.group)
        if mean:
            flat /= self.size
        return [v.view(t.shape) for v, t in zip(flat.split([t.numel() for t in tensors]),
                                                 tensors)]

    def pmean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean over the ranks, differentiable (sync BN's statistics)."""
        return t if self.group is None else _PMean.apply(t, self)


def make_mesh(n_devices: int = -1, device=None) -> Mesh:
    """The data mesh over the default process group (-1 or 0: every rank),
    or over this process alone when there is no group. `device` is this
    rank's (`resolve_device`; a bare "cuda" takes the current device).
    Raises when more devices are asked for than the group has, and when
    fewer: every rank of the group is a shard."""
    if dist.is_available() and dist.is_initialized():
        group, world, rank = dist.group.WORLD, dist.get_world_size(), dist.get_rank()
    else:
        group, world, rank = None, 1, 0
    if n_devices in (-1, 0, None):
        n_devices = world
    if n_devices > world:
        raise ValueError(f"requested {n_devices} devices, have {world}: one process per device "
                         "(torchrun --nproc-per-node N)")
    if n_devices < world:
        raise ValueError(f"requested {n_devices} devices of a group of {world}: the mesh spans "
                         "every rank")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(world, rank, dev, group)


def _on(device, a) -> torch.Tensor:
    return (a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))).to(device)


def shard_batch(mesh: Mesh, *arrays):
    """This rank's batch on its device. One process: the arrays are the
    global batch, which its single rank holds whole. Several processes:
    each passes its local share (the Loader's `shard_index` rows), so the
    global batch is the ranks' shares in rank order."""
    out = tuple(_on(mesh.device, a) for a in arrays)
    return out if len(out) > 1 else out[0]


def shard_microbatches(mesh: Mesh, accum: int, *arrays):
    """`(A*G, ...)` batches as `(A, G, ...)` microbatch stacks on this
    rank's device, the input of `train.step.make_train_step(accum_steps=A)`:
    consecutive G-sized chunks are the microbatches, so the samples fall
    into virtual shards as they would on A times the devices. Raises
    ValueError when a batch does not split into `accum` microbatches."""

    def put(a):
        t = _on(mesh.device, a)
        if t.shape[0] % accum:
            raise ValueError(f"batch of {t.shape[0]} does not split into {accum} microbatches")
        return t.reshape(accum, t.shape[0] // accum, *t.shape[1:])

    out = tuple(put(a) for a in arrays)
    return out if len(out) > 1 else out[0]
