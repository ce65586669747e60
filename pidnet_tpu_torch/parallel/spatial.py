"""Spatial partitioning: the image's H rows sharded over the ranks of a
(data, spatial) mesh (counterpart of pidnet_tpu/parallel/spatial.py).

The JAX package jits the unchanged network under
`NamedSharding(P(data, spatial))` and lets XLA's SPMD partitioner insert
the conv halo exchanges, the cross-shard BatchNorm and pooling reductions
and the global OHEM collectives; it turns its Pallas kernels off inside,
because the partitioner cannot split an opaque custom call. Torch has no
partitioner, so here the partitioning is written out:

- `make_mesh_2d` lays the ranks of the default `torch.distributed` group
  out as (data, spatial), the spatial axis minor (rank = d * S + s), with
  one process group a spatial row (the S ranks that share the same images);
- `shard_rows` keeps this rank's rows of a batch;
- `halo_exchange` gives a shard the rows above and below it that its
  neighbours hold, zeros at the image's border, and its backward returns
  the halo rows' cotangents to their owners;
- `gather_rows` / `scatter_rows` are the model's "pre_spp" and "post_spp"
  points: the 1/64 stage (layer5 and the PPM of PIDNet and DDRNet-23) runs
  on the whole map, replicated on the S ranks of a row;
- `conv_rows`, `resize_sharded` and `max_pool_rows` are a sharded conv,
  bilinear resize and max pool: the rows that the whole image's would give
  this shard; `global_pool_rows` is the whole image's global average pool
  on every rank of the row (BiSeNet's attention and fusion gates);
- models/pidnet.spatial_sharding installs them in a model, and
  losses/criterion.FullLoss, train/step.make_spatial_train_step and
  make_spatial_eval_step take the global program's reductions over the
  mesh, with the hand-written kernels K1-K3 over each rank's window of
  output rows (ops/upsample_argmax.upsample_argmax_rows,
  ops/ce_front.ce_maps(rows=...)).

Semantics, as the JAX spatial step's: a global-batch program. BatchNorm
takes the statistics of the global batch and OHEM its threshold over the
global pixel pool, because the shards of one image must share both.

gloo has no CUDA all-gather, so the row collectives stage CUDA tensors
through the host there (as bytes, whatever their dtype); the computation
stays on the card. NCCL takes them as they are.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from pidnet_tpu_torch.nn.functional import global_avg_pool
from pidnet_tpu_torch.ops import resize as R
from pidnet_tpu_torch.parallel.mesh import Mesh, _on, make_mesh

SPATIAL_AXIS = "spatial"
STAGE = 32  # the shards split evenly down to the 1/32 stage, gathered before the 1/64


def _all_gather(t: torch.Tensor, group, world: int) -> list:
    """`t` from each of the `world` ranks of `group`, in rank order, as
    bytes: any dtype, CUDA tensors staged through the host under gloo."""
    t = t.contiguous()
    flat = t.reshape(-1).view(torch.uint8)
    staged = t.is_cuda and dist.get_backend(group) == "gloo"
    if staged:
        flat = flat.cpu()
    parts = [torch.empty_like(flat) for _ in range(world)]
    dist.all_gather(parts, flat, group=group)
    return [p.to(t.device).view(t.dtype).view(t.shape) for p in parts]


@dataclass(frozen=True)
class SpatialMesh:
    """A (data, spatial) mesh: `n_data` x `n_spatial` ranks, this
    process's `rank` and `device`, the data mesh of every rank (`world`,
    whose collectives reduce over the whole mesh) and the process group of
    this rank's spatial row (`row_group`, None where a row is one rank)."""

    n_data: int
    n_spatial: int
    rank: int
    device: torch.device
    world: Mesh
    row_group: object = None

    @property
    def size(self) -> int:
        return self.n_data * self.n_spatial

    @property
    def data_index(self) -> int:
        return self.rank // self.n_spatial

    @property
    def spatial_index(self) -> int:
        return self.rank % self.n_spatial

    @property
    def backend(self) -> str | None:
        return self.world.backend

    def row_gather(self, t: torch.Tensor) -> list:
        """`t` from each rank of this rank's spatial row, in row order."""
        if self.row_group is None:
            return [t]
        return _all_gather(t, self.row_group, self.n_spatial)

    def row_sum(self, t: torch.Tensor) -> torch.Tensor:
        """`t` summed over this rank's spatial row, in place."""
        if self.row_group is not None:
            dist.all_reduce(t, group=self.row_group)
        return t

    def world_gather(self, t: torch.Tensor) -> torch.Tensor:
        """`t` from every rank of the mesh, concatenated in rank order."""
        if self.world.group is None:
            return t
        return torch.cat(_all_gather(t, self.world.group, self.size))

    def total(self, t) -> torch.Tensor:
        """The sum over the mesh of a scalar or tensor, detached: a global
        count or denominator."""
        t = torch.as_tensor(t, device=self.device).detach().clone()
        return self.world.all_reduce_sum(t)


def make_mesh_2d(n_data: int, n_spatial: int, device=None) -> SpatialMesh:
    """The (data, spatial) mesh over the default process group, one process
    a device, spatial minor: rank = d * n_spatial + s. Every rank builds the
    n_data row groups, in the same order. One process without a group is
    the (1, 1) mesh, whose collectives do nothing. Raises when n_data x
    n_spatial differs from the group's size."""
    if n_data < 1 or n_spatial < 1:
        raise ValueError(f"a mesh of ({n_data}, {n_spatial}) devices")
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    need = n_data * n_spatial
    if need > world:
        raise ValueError(f"requested {need} devices, have {world}: one process per device "
                         "(torchrun --nproc-per-node N)")
    world_mesh = make_mesh(need, device)
    row_group = None
    if world_mesh.group is not None and n_spatial > 1:
        for d in range(n_data):
            group = dist.new_group(list(range(d * n_spatial, (d + 1) * n_spatial)))
            if d == world_mesh.rank // n_spatial:
                row_group = group
    return SpatialMesh(n_data, n_spatial, world_mesh.rank, world_mesh.device, world_mesh,
                       row_group)


def check_split(h: int, n_spatial: int) -> None:
    """Raise ValueError unless H splits over the spatial ranks as the
    network needs: every shard's rows halve evenly down to the 1/32 stage
    (H a multiple of 32 x n_spatial), and the whole 1/32 map halves once
    more (H a multiple of 64)."""
    if h % (STAGE * n_spatial) or h % 64:
        raise ValueError(
            f"H = {h} does not split over {n_spatial} spatial ranks: H must be a multiple of "
            f"{STAGE} x {n_spatial} = {STAGE * n_spatial}, so that each shard's rows halve evenly "
            "down to the 1/32 stage (the 1/64 stage runs on the gathered map), and of 64")


def shard_rows(mesh: SpatialMesh, *arrays):
    """This rank's share of a batch on its device: image-like arrays (rank
    >= 2, H at dim 1: NHWC images, (N,H,W) labels and edges) keep rows
    [s H/S, (s+1) H/S), per-sample vectors (rank 1, the sample mask) stay
    whole. Each rank passes its data row's samples (the Loader's
    `shard_index` = rank // n_spatial share). Raises ValueError where the
    rows do not split (`check_split`)."""

    def put(a):
        if a.ndim < 2:
            return _on(mesh.device, a)
        check_split(a.shape[1], mesh.n_spatial)
        h = a.shape[1] // mesh.n_spatial
        s = mesh.spatial_index
        part = a[:, s * h:(s + 1) * h]
        if not torch.is_tensor(part):
            part = np.ascontiguousarray(part)
        return _on(mesh.device, part).contiguous()

    out = tuple(put(a) for a in arrays)
    return out if len(out) > 1 else out[0]


class _Halo(torch.autograd.Function):
    """Rows from the neighbours along `dim`; the backward sends them back."""

    @staticmethod
    def forward(ctx, x, top, bottom, mesh, dim):
        ctx.args = (top, bottom, mesh, dim)
        n, s, last = x.shape[dim], mesh.spatial_index, mesh.n_spatial - 1
        # what the ranks above and below need: my first `bottom`, my last `top` rows
        got = mesh.row_gather(torch.cat([x.narrow(dim, 0, bottom), x.narrow(dim, n - top, top)],
                                        dim))

        def zeros(k):
            shape = list(x.shape)
            shape[dim] = k
            return x.new_zeros(shape)

        above = got[s - 1].narrow(dim, bottom, top) if s > 0 else zeros(top)
        below = got[s + 1].narrow(dim, 0, bottom) if s < last else zeros(bottom)
        return torch.cat([above, x, below], dim)

    @staticmethod
    def backward(ctx, g):
        top, bottom, mesh, dim = ctx.args
        n, s, last = g.shape[dim] - top - bottom, mesh.spatial_index, mesh.n_spatial - 1
        got = mesh.row_gather(torch.cat([g.narrow(dim, 0, top), g.narrow(dim, top + n, bottom)],
                                        dim))
        dx = g.narrow(dim, top, n).clone()
        if s < last:  # the rank below's top halo is my last `top` rows
            dx.narrow(dim, n - top, top).add_(got[s + 1].narrow(dim, 0, top))
        if s > 0:  # the rank above's bottom halo is my first `bottom` rows
            dx.narrow(dim, 0, bottom).add_(got[s - 1].narrow(dim, top, bottom))
        return dx, None, None, None, None


def halo_exchange(x: torch.Tensor, top: int, bottom: int, mesh: SpatialMesh,
                  dim: int = 2) -> torch.Tensor:
    """`x` (this rank's rows along `dim`: 2 for NCHW, 1 for NHWC) with
    `top` rows of the rank above and `bottom` rows of the rank below, zero
    rows at the image's border (never at a shard's). Differentiable: the
    halo rows' cotangents go back to the ranks that own the rows, which add
    them to their edge rows. Every rank of a row passes the same top and
    bottom, at most its own row count."""
    if top < 0 or bottom < 0 or max(top, bottom) > x.shape[dim]:
        raise ValueError(f"a halo of ({top}, {bottom}) rows around a shard of {x.shape[dim]}")
    if top == bottom == 0:
        return x
    return _Halo.apply(x, top, bottom, mesh, dim)


class _GatherRows(torch.autograd.Function):
    """All-gather along `dim`; the backward is this rank's slice of the sum."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.args = (mesh, dim, x.shape[dim], x.dtype)
        return torch.cat(mesh.row_gather(x), dim)

    @staticmethod
    def backward(ctx, g):
        mesh, dim, n, dtype = ctx.args
        # summed in fp32 at least (bf16 cotangents)
        g = mesh.row_sum(g.to(torch.promote_types(dtype, torch.float32)).contiguous())
        return g.narrow(dim, mesh.spatial_index * n, n).to(dtype), None, None


def gather_rows(x: torch.Tensor, mesh: SpatialMesh, dim: int = 2) -> torch.Tensor:
    """The whole image's rows along `dim` from this rank's, on every rank
    of its spatial row ("pre_spp"). Its backward is this rank's slice of
    the cotangents summed over the row (a reduce-scatter: each rank's
    replica contributes a part of the gradient, not a copy of it)."""
    if mesh.n_spatial == 1:
        return x
    return _GatherRows.apply(x, mesh, dim)


def scatter_rows(x: torch.Tensor, mesh: SpatialMesh, dim: int = 2) -> torch.Tensor:
    """This rank's rows along `dim` of a whole (replicated) image
    ("post_spp"); its backward leaves the other rows' cotangents at 0."""
    n = x.shape[dim] // mesh.n_spatial
    return x.narrow(dim, mesh.spatial_index * n, n)


def max_pool_rows(x: torch.Tensor, kernel: int, stride: int, padding: int,
                  mesh: SpatialMesh) -> torch.Tensor:
    """This rank's rows of a kernel x kernel max pool (stride, padding) of
    the whole image, from NCHW `x`, its rows: `padding` rows from the rank
    above and kernel - stride - padding from the rank below (3x3/s2/p1: 1
    and 0), the image's border padded with the dtype's lowest value (the
    padding never wins, as torch's and the JAX package's pools), then the
    pool with H padding 0. The shard's first row must be a multiple of the
    stride. Differentiable: the halo rows' cotangents go back through the
    halo exchange."""
    if mesh.n_spatial == 1:
        return F.max_pool2d(x, kernel, stride, padding)
    top, bottom = padding, max(kernel - stride - padding, 0)
    xh = halo_exchange(x, top, bottom, mesh)
    s, n = mesh.spatial_index, xh.shape[2]
    low = torch.finfo(x.dtype).min
    if s == 0 and top:
        xh = torch.cat([xh.new_full((*xh.shape[:2], top, xh.shape[3]), low), xh[:, :, top:]], 2)
    if s == mesh.n_spatial - 1 and bottom:
        xh = torch.cat([xh[:, :, :n - bottom], xh.new_full((*xh.shape[:2], bottom, xh.shape[3]),
                                                           low)], 2)
    return F.max_pool2d(xh, kernel, stride, (0, padding))


class _GlobalPoolRows(torch.autograd.Function):
    """The mean over the whole image's H x W of NCHW rows, in fp32 at least."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.args = (mesh, x.shape, x.dtype)
        acc = torch.promote_types(x.dtype, torch.float32)  # bf16 sums in fp32
        total = mesh.row_sum(x.sum(dim=(2, 3), keepdim=True, dtype=acc).contiguous())
        return (total / (x.shape[2] * mesh.n_spatial * x.shape[3])).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        mesh, shape, dtype = ctx.args
        # each rank's use of the pooled vector gives a part of its cotangent
        acc = torch.promote_types(dtype, torch.float32)
        g = mesh.row_sum(g.to(acc, copy=True).contiguous())
        g = g / (shape[2] * mesh.n_spatial * shape[3])
        return g.expand(shape).to(dtype), None


def global_pool_rows(x: torch.Tensor, mesh: SpatialMesh) -> torch.Tensor:
    """AdaptiveAvgPool2d(1) of the whole image on every rank of the spatial
    row, from NCHW `x`, this rank's rows: each rank sums its rows in fp32,
    the row adds the sums, and the result is divided by the image's H x W
    (N, C, 1, 1, in x's dtype). Its backward adds the cotangents over the
    row before it spreads them over the rank's rows."""
    if mesh.n_spatial == 1:
        return global_avg_pool(x)
    return _GlobalPoolRows.apply(x, mesh)


def hint(name: str, x: torch.Tensor, mesh: SpatialMesh) -> torch.Tensor:
    """The model's partitioning points (models/pidnet.PIDNet._hint): the
    1/32 map is gathered before layer5 and the PPM, and their 1/8 output
    scattered back to the rank's rows."""
    if name == "pre_spp":
        return gather_rows(x, mesh)
    if name == "post_spp":
        return scatter_rows(x, mesh)
    return x


def halo_for_resize(n_src: int, n_out: int, align_corners: bool, mesh: SpatialMesh,
                    margin: int = 0) -> tuple[int, int, R.Rows]:
    """(top, bottom, window) of a resize of this rank's `n_src` source rows
    to its `n_out` output rows, the image's being S times each: the halo
    rows, the same on every rank (the most any rank's taps read beyond its
    own rows, derived from the whole image's taps, and `margin` more where
    the neighbour holds them), and the window of the halo'd rows
    (ops/resize.Rows)."""
    big_s = mesh.n_spatial
    i0, i1, _ = R.source_taps(n_src * big_s, n_out * big_s, align_corners)
    need = [(r * n_src - int(i0[r * n_out:(r + 1) * n_out].min()),
             int(i1[r * n_out:(r + 1) * n_out].max()) + 1 - (r + 1) * n_src)
            for r in range(big_s)]
    top = max(max(t for t, _ in need), 0)
    bottom = max(max(b for _, b in need), 0)
    if max(top, bottom) > n_src:
        raise ValueError(f"a resize of {n_src} rows a shard to {n_out} reads {top} rows above "
                         f"and {bottom} below, more than a neighbour holds")
    top, bottom = min(top + margin, n_src), min(bottom + margin, n_src)
    window = R.Rows(n_src * big_s, mesh.spatial_index * n_src - top, n_out * big_s,
                    mesh.spatial_index * n_out)
    return top, bottom, window


def halo_rows(x: torch.Tensor, n_out: int, align_corners: bool, mesh: SpatialMesh,
              dim: int = 1) -> tuple[torch.Tensor, R.Rows | None]:
    """(x with its halo, window) for the kernels' resize of this rank's
    rows of `x` along `dim` (NHWC logits: 1) to its `n_out` output rows:
    one row of margin beyond the taps (the device's float32 source index
    may round by one ulp the other way than the host's). On a mesh of one
    spatial rank: (x, None), the whole image."""
    if mesh.n_spatial == 1:
        return x, None
    top, bottom, window = halo_for_resize(x.shape[dim], n_out, align_corners, mesh, margin=1)
    return halo_exchange(x, top, bottom, mesh, dim), window


def resize_sharded(x: torch.Tensor, out_hw, align_corners: bool,
                   mesh: SpatialMesh) -> torch.Tensor:
    """This rank's rows of the bilinear resize of the whole image, from
    NCHW `x`, its rows, to `out_hw` (its rows' share of the output): the
    halo the whole image's taps read, exchanged, then
    ops/resize.resize_rows. On a mesh of one spatial rank,
    ops/resize.interpolate."""
    if mesh.n_spatial == 1:
        return R.interpolate(x, out_hw, align_corners)
    top, bottom, window = halo_for_resize(x.shape[2], int(out_hw[0]), align_corners, mesh)
    return R.resize_rows(halo_exchange(x, top, bottom, mesh), out_hw, align_corners, window)


def conv_rows(x: torch.Tensor, weight: torch.Tensor, bias, stride: int, groups: int,
              mesh: SpatialMesh) -> torch.Tensor:
    """This rank's rows of a k x k conv with padding k//2 of the whole
    image, from NCHW `x`, its rows: p = k//2 rows from the rank above and
    k - stride - p from the rank below (3x3/s1: 1 and 1, 3x3/s2: 1 and 0),
    then the conv with H padding 0 and W padding p. The shard's first row
    must be a multiple of the stride (`check_split`). In x's dtype, as
    nn.functional.conv2d."""
    k = weight.shape[-1]
    p = k // 2
    xh = halo_exchange(x, p, max(k - stride - p, 0), mesh) if mesh.n_spatial > 1 else None
    w = weight if weight.dtype == x.dtype else weight.to(x.dtype)
    b = bias if bias is None or bias.dtype == x.dtype else bias.to(x.dtype)
    if xh is None:
        return F.conv2d(x, w, b, stride=stride, padding=p, groups=groups)
    return F.conv2d(xh, w, b, stride=stride, padding=(0, p), groups=groups)


@dataclass(frozen=True)
class ReplicatedSync:
    """Sync BN on a map replicated over the S ranks of a spatial row (the
    gathered 1/64 stage, BiSeNet's pooled vectors): the ranks of a row hold
    the same map, so the mean over every rank is the global batch's and a
    layer's global pixel count is the local count x n_data (not x the
    mesh's size, which would skew the unbiased running_var). The `sync` of
    nn/functional.batch_norm_train."""

    world: Mesh
    size: int

    def pmean(self, t: torch.Tensor) -> torch.Tensor:
        return self.world.pmean(t)


def replicated_sync(mesh: SpatialMesh) -> ReplicatedSync:
    return ReplicatedSync(mesh.world, mesh.n_data)
