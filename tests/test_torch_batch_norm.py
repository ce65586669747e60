"""Train-mode BN of the port (pidnet_tpu_torch/ops/batch_norm.py) on the CPU:
the plain versions of the kernels, behind the autograd Function that
nn/functional.batch_norm_train takes without `sync`, against autograd of
the eager ops that path ran before (kept here as `eager_batch_norm_train`);
the launch plan; and the sync path, which keeps the eager ops. The kernels
themselves are held against the plain versions on the card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from pidnet_tpu_torch.nn import functional as TF
from pidnet_tpu_torch.ops import batch_norm as BN

torch.set_num_threads(2)


def eager_batch_norm_train(x, gamma, beta, running_mean, running_var, momentum=0.1):
    """nn/functional.batch_norm_train's eager ops without `sync`, as the
    port ran them before the kernels."""
    n = x.numel() // x.shape[1]
    mean = torch.mean(x, dim=(0, 2, 3), dtype=torch.float32)
    mean_sq = torch.mean(torch.square(x.float()), dim=(0, 2, 3))
    var = torch.clamp(mean_sq - torch.square(mean), min=0.0)
    scale = torch.rsqrt(var + TF.BN_EPS) * gamma
    shift = beta - mean * scale
    y = TF.affine(x, scale, shift)
    with torch.no_grad():
        unbiased = var * (n / max(n - 1, 1))
        new_mean = (1.0 - momentum) * running_mean + momentum * mean
        new_var = (1.0 - momentum) * running_var + momentum * unbiased
    return y, new_mean, new_var


def exact_batch_norm(x, gamma, beta):
    """y of the same function in float64 (no rounding to speak of)."""
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = torch.clamp((x * x).mean(dim=(0, 2, 3), keepdim=True) - mean * mean, min=0.0)
    return (x - mean) * torch.rsqrt(var + TF.BN_EPS) * gamma.view(1, -1, 1, 1) + beta.view(
        1, -1, 1, 1)


def inputs(shape, dtype, seed=0, loc=1.0):
    """Seeded channels_last NCHW x and dy, and fp32 gamma, beta, running
    mean and running variance."""
    rng = np.random.default_rng(seed)
    n, c, h, w = shape
    x = torch.from_numpy((rng.standard_normal(shape) * 3 + loc).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    x, dy = (t.to(dtype).contiguous(memory_format=torch.channels_last) for t in (x, dy))
    gamma, beta, rm = (torch.from_numpy(rng.standard_normal(c).astype(np.float32))
                       for _ in range(3))
    rv = torch.from_numpy((0.5 + rng.random(c)).astype(np.float32))
    return x, dy, gamma, beta, rm, rv


def run(fn, x, dy, gamma, beta, rm, rv):
    """(y, new mean, new var, dx, dgamma, dbeta) of `fn` under autograd."""
    x, gamma, beta = (t.detach().clone().requires_grad_(True) for t in (x, gamma, beta))
    y, nm, nv = fn(x, gamma, beta, rm, rv)
    assert not nm.requires_grad and not nv.requires_grad
    dx, dg, db = torch.autograd.grad(y, (x, gamma, beta), dy)
    return y.detach(), nm, nv, dx, dg, db


SHAPES = {"ragged": (3, None, 5, 7), "pooled": (4, None, 1, 1)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("c", [19, 32, 96, 1024])
@pytest.mark.parametrize("kind", list(SHAPES))
def test_plain_function_matches_eager_autograd(dtype, c, kind):
    """y, the new running statistics, dx, dgamma and dbeta of bn_train's
    plain path against autograd of the eager ops, on channels_last x. The
    statistics are the same ops: equal. fp32: the rest within 1e-5 of the
    largest value. bf16: the eager ops round scale, shift, x*scale, dgamma
    and dbeta to bf16 and the plain version rounds y and dx once from fp32,
    so each of its outputs lies no further from the float64 function than
    the eager ones'."""
    shape = list(SHAPES[kind])
    shape[1] = c
    args = inputs(tuple(shape), dtype, seed=c)
    got = run(BN.bn_train, *args)
    want = run(eager_batch_norm_train, *args)
    assert got[0].dtype == got[3].dtype == dtype
    assert got[0].is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    if dtype == torch.float32:
        for g, w in zip(got, want):
            tol = 1e-5 * float(w.abs().max())
            torch.testing.assert_close(g, w, rtol=0, atol=tol)
        return
    x, dy, gamma, beta = (t.double() for t in args[:4])
    x.requires_grad_(True), gamma.requires_grad_(True), beta.requires_grad_(True)
    y = exact_batch_norm(x, gamma, beta)
    exact = (y.detach(), *torch.autograd.grad(y, (x, gamma, beta), dy))
    for i, e in zip((0, 3, 4, 5), exact):
        err_got = float((got[i].double() - e).abs().max())
        err_want = float((want[i].double() - e).abs().max())
        assert err_got <= err_want, (i, err_got, err_want)


def test_clamped_variance_passes_no_gradient():
    """A channel at 1000 with a spread of 0.01, where mean_sq - mean^2 in
    fp32 falls below 0: var is clamped to 0, the variance's term of dx is
    0 as in the eager graph, and that term is large (without the rule dx
    would differ). The eager graph forms that channel's dgamma as
    rstd * (sum(dy * x) - mean * sum(dy)), which cancels in fp32; the plain
    version's sum(dy * xh) is held to float64 on its own mean and rstd."""
    for seed in range(50):
        x, dy, gamma, beta, rm, rv = inputs((2, 4, 3, 5), torch.float32, seed=seed)
        noise = torch.from_numpy(np.random.default_rng(seed).standard_normal((2, 3, 5)))
        x[:, 0] = 1000.0 + 0.01 * noise.float()
        mean = torch.mean(x[:, 0], dtype=torch.float32)
        if float(torch.mean(torch.square(x[:, 0])) - mean * mean) < 0:
            break
    else:
        pytest.fail("no seed gave a clamped variance")
    _, ws = BN.bn_forward_plain(x, gamma, beta, rm, rv, 0.1)
    assert ws[BN.VAR_MASK, 0] == 0 and bool((ws[BN.VAR_MASK, 1:] == 1).all())
    got = run(BN.bn_train, x, dy, gamma, beta, rm, rv)
    want = run(eager_batch_norm_train, x, dy, gamma, beta, rm, rv)
    exact = float((dy[:, 0].double() * (x[:, 0].double() - float(ws[BN.MEAN, 0]))).sum()
                  * float(ws[BN.RSTD, 0]))
    assert abs(float(got[4][0]) - exact) <= 1e-4 * abs(exact)
    got[4][0] = want[4][0]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5 * float(w.abs().max()))
    unmasked = ws.clone()
    unmasked[BN.VAR_MASK] = 1
    dx_unmasked = BN.bn_backward_plain(x, dy, unmasked)[0]
    assert float((dx_unmasked[:, 0] - want[3][:, 0]).abs().max()) > 1.0


PLAN_CASES = [
    # (M, C, itemsize, alignment): PIDNet-L's stem BN at 12 x 1024^2, a mid
    # map, the last stage's, DAPPM's 560 channels, pooled vectors, ragged
    # channels and rows, pointers aligned to less than 16 bytes
    (12 * 512 * 512, 64, 2, 16), (12 * 128 * 128, 128, 2, 16), (12 * 32 * 32, 1024, 2, 16),
    (12 * 32 * 32, 560, 2, 16), (12, 1024, 4, 16), (4, 96, 2, 16), (105, 19, 4, 16),
    (105, 19, 2, 16), (1, 32, 2, 16), (1000, 96, 2, 4), (1000, 64, 4, 8), (77777, 1024, 4, 16),
    (6 * 256 * 256, 32, 2, 16), (3, 1, 4, 16),
]


@pytest.mark.parametrize("m,c,itemsize,align", PLAN_CASES)
def test_plan_covers_every_row_and_channel_once(m, c, itemsize, align):
    """Every element of [M, C] falls to one thread of one block, each
    thread's load is a whole vector inside C on an aligned address, and
    the grid fits the kernels' limits."""
    p = BN.plan(m, c, itemsize, align)
    assert p.vec * itemsize <= 16 and c % p.vec == 0 and align % (p.vec * itemsize) == 0
    assert p.lanes * p.rows <= BN.THREADS and p.rpc % p.rows == 0
    assert p.lanes * p.vec * p.ctiles >= c > p.lanes * p.vec * (p.ctiles - 1)
    assert p.chunks * p.ctiles <= BN.SMS * BN.BLOCKS_PER_SM or p.rpc == p.rows
    channels = np.zeros(c, np.int64)
    for tile in range(p.ctiles):
        for tx in range(p.lanes):
            first = (tile * p.lanes + tx) * p.vec
            if first < c:
                channels[first:first + p.vec] += 1
    rows = np.zeros(m, np.int64)
    for chunk in range(p.chunks):
        end = min(m, (chunk + 1) * p.rpc)
        for ty in range(p.rows):
            np.add.at(rows, np.arange(chunk * p.rpc + ty, end, p.rows), 1)
    assert (channels == 1).all() and (rows == 1).all()


class FakeSync:
    """A mesh of one rank that records its pmeans."""

    size = 1

    def __init__(self):
        self.calls = 0

    def pmean(self, t):
        self.calls += 1
        return t


def test_sync_takes_the_eager_path(monkeypatch):
    """With `sync` set, batch_norm_train runs its own eager ops: the sync's
    pmean is called, bn_train is not, and the result is the eager one's."""
    x, dy, gamma, beta, rm, rv = inputs((2, 32, 4, 4), torch.float32)
    sync = FakeSync()
    before = BN.fwd_launches, BN.bwd_launches
    calls = []
    monkeypatch.setattr(TF, "bn_train", lambda *a: calls.append(a) or BN.bn_train(*a))
    got = run(lambda *a: TF.batch_norm_train(*a, sync=sync), x, dy, gamma, beta, rm, rv)
    assert sync.calls == 1 and not calls
    assert (BN.fwd_launches, BN.bwd_launches) == before == (0, 0)
    want = run(eager_batch_norm_train, x, dy, gamma, beta, rm, rv)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_no_sync_takes_bn_train():
    """Without `sync`, batch_norm_train is bn_train's result."""
    x, dy, gamma, beta, rm, rv = inputs((2, 32, 4, 4), torch.bfloat16)
    got = run(TF.batch_norm_train, x, dy, gamma, beta, rm, rv)
    want = run(BN.bn_train, x, dy, gamma, beta, rm, rv)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_cpu_tensor_never_counts(dtype):
    """A CPU tensor runs the plain versions forward and backward, and the
    launch counters do not move."""
    before = BN.fwd_launches, BN.bwd_launches
    run(BN.bn_train, *inputs((2, 64, 3, 3), dtype))
    assert (BN.fwd_launches, BN.bwd_launches) == before

