"""Start N rank processes on one machine: the port's launcher for data
parallelism (`--gpus N` of the CLIs, the tests, chip_smoke.py).

    results = launch(fn, args, devices=["cuda:0", "cuda:1"])

Each rank is a process of its own, started with the *spawn* method (a
forked child would inherit a parent's CUDA context or its JAX runtime),
joins a group on a free localhost port (parallel/mesh.init_distributed),
runs `fn(*args)` and returns its value; `launch` returns the values in rank
order. `fn` must be importable by name in a fresh interpreter (defined at
the top level of a module). The device list is explicit, so two ranks can
share one card; the backend is NCCL when every rank has a card of its own
and gloo otherwise (NCCL refuses two ranks on one device).

Nothing fails quietly: a rank that raises makes `launch` raise with that
rank's traceback, a rank that dies without a word makes it raise with its
exit code, and a run longer than `timeout` seconds kills every rank and
raises. The other ranks are stopped in each case.

When a rank runs on a card, the kernels (ops/_kernels.py) are built here,
in the parent, before the ranks start: N ranks on a cold build directory
would otherwise run N nvcc builds of every source at once.
"""

from __future__ import annotations

import os
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def default_backend(devices: Sequence[str]) -> str:
    devs = [torch.device(d) for d in devices]
    cards = [d for d in devs if d.type == "cuda"]
    if len(cards) == len(devs) and len({d.index for d in cards}) == len(devs):
        return "nccl"
    return "gloo"


def _rank_main(rank: int, world: int, port: int, device: str, backend: str,
               coll_timeout: float, threads: Optional[int], fn: Callable,
               args: tuple, out) -> None:
    from tpu_asr_torch.parallel import mesh

    try:
        if threads:
            torch.set_num_threads(threads)
        mesh.init_distributed(world, rank, backend, device,
                              f"tcp://127.0.0.1:{port}", coll_timeout)
        try:
            value = fn(*args)
            mesh.sync_processes("launch_done")
        finally:
            mesh.shutdown()
        out.put((rank, True, value))
    except BaseException:             # the parent raises with this text
        out.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def launch(fn: Callable, args: tuple, devices: Sequence[str],
           timeout: Optional[float] = 1800.0,
           coll_timeout: Optional[float] = None,
           threads: Optional[int] = None) -> List[Any]:
    """Run `fn(*args)` on len(devices) ranks, rank r on `devices[r]`; the
    return values in rank order (plain Python or numpy values: a tensor
    would outlive its process's shared memory). `timeout`: the seconds the
    whole run may take (None: no limit); `coll_timeout`: the seconds any
    collective may wait (default `timeout`, else 1800); `threads`: torch's
    intra-op threads a rank (CPU ranks default to cores / ranks)."""
    devices = [str(d) for d in devices]
    world = len(devices)
    backend = default_backend(devices)
    if threads is None and all(d == "cpu" for d in devices):
        threads = max(1, (os.cpu_count() or 1) // world)
    if any(torch.device(d).type == "cuda" for d in devices):
        from tpu_asr_torch.ops import _kernels
        _kernels.build()
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=False,
                         args=(r, world, port, devices[r], backend,
                               coll_timeout or timeout or 1800.0, threads,
                               fn, tuple(args), out))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + (timeout if timeout else float("inf"))
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"launch: {world - len(results)} of "
                                   f"{world} ranks still running after "
                                   f"{timeout:.0f} s")
            try:
                rank, ok, value = out.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode is not None]
                if dead:
                    # its message may still be in flight
                    try:
                        rank, ok, value = out.get(timeout=5.0)
                    except queue_mod.Empty:
                        raise RuntimeError(
                            f"launch: rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} and no result")
                else:
                    continue
            if not ok:
                raise RuntimeError(f"launch: rank {rank} of {world} "
                                   f"failed:\n{value}")
            results[rank] = value
        for p in procs:
            p.join(timeout=max(5.0, min(60.0, deadline - time.monotonic())))
        bad = [(r, p.exitcode) for r, p in enumerate(procs)
               if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"launch: ranks exited with {bad}")
        return [results[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10.0)
        out.close()
