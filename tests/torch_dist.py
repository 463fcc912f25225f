"""Run a function on N ranks of a gloo process group on the CPU, each in
its own spawned process, for the port's multi-rank tests.

The ranks meet through a ``file://`` store under the test's directory (no
port is shared between concurrent tests), each rank writes its result with
``torch.save``, and the parent waits at most ``timeout`` seconds: a rank
that fails or outlives it takes every rank down, and the failing rank's
traceback is raised in the test."""

from __future__ import annotations

import multiprocessing as mp
import os
import time
import traceback

import torch


def _child(fn, rank, world, store, out_dir, args):
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    try:
        import torch.distributed as dist

        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        result = fn(rank, world, *args)
        torch.save(result, os.path.join(out_dir, f"result_{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def run_ranks(fn, world: int, tmp_dir, *args, timeout: float = 240.0):
    """``[fn(rank, world, *args) for each rank]``, each rank in its own
    process inside one gloo group."""
    out_dir = os.path.join(str(tmp_dir), f"ranks_{time.monotonic_ns()}")
    os.makedirs(out_dir)
    store = os.path.join(out_dir, "store")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child,
                         args=(fn, r, world, store, out_dir, args),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after {timeout} s")
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(5)
    errors = [open(os.path.join(out_dir, f)).read()
              for f in sorted(os.listdir(out_dir)) if f.startswith("error")]
    if errors or any(p.exitcode != 0 for p in procs):
        raise RuntimeError("a rank failed:\n" + "\n".join(errors or [
            f"exit codes {[p.exitcode for p in procs]}"]))
    return [torch.load(os.path.join(out_dir, f"result_{r}.pt"),
                       weights_only=False) for r in range(world)]
