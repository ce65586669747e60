"""Start the ranks of a data-parallel run on one machine, as
`torchrun --nproc-per-node N` does, from inside a program: the CPU tests
run their gloo ranks through it and `chip_smoke.py` its two ranks on one
card.

    results = spawn(fn, world, *args, backend="gloo")

runs `fn(rank, *args)` in `world` fresh processes and returns what each
returned, in rank order. `fn` and `args` are pickled (`fn` by its import
path), so `fn` is a module-level function.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import socket
import time
import traceback

import torch.distributed as dist


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, world: int, port: int, backend, args, results) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    try:
        if backend is not None:
            dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank,
                                    world_size=world)
        try:
            if backend is not None:
                dist.barrier()  # every rank is up before the first collective
            value = fn(rank, *args)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        results.put((rank, True, value))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def spawn(fn, world: int, *args, backend: str | None = "gloo", timeout: float = 900.0) -> list:
    """`fn(rank, *args)` in `world` processes (the spawn start method), each
    with torchrun's environment (RANK, LOCAL_RANK = rank, WORLD_SIZE,
    MASTER_ADDR localhost, MASTER_PORT a free port). With `backend` each
    rank joins the default process group over it and meets the others at a
    barrier before `fn` runs; with None, `fn` joins it itself (a CLI under
    --multihost). Raises RuntimeError with the traceback of a rank that
    failed, TimeoutError after `timeout` seconds; stops every rank before
    it returns."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(fn, rank, world, port, backend, args, results),
                         daemon=True) for rank in range(world)]
    for p in procs:
        p.start()
    out = {}
    try:
        deadline = time.monotonic() + timeout
        while len(out) < world:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in out and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no result") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world - len(out)} rank(s) gave no result within "
                                       f"{timeout} s") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30 if len(out) == world else 0)
            if p.is_alive():
                p.terminate()
                p.join()
    return [out[r] for r in range(world)]
