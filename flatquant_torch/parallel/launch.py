"""Start one process per rank, run a function on every rank, collect the
results: the rank launch glue of the tests and of chip_smoke.py.

`run_ranks(fn, world_size, ...)` spawns `world_size` processes (start
method "spawn": a CUDA context does not survive fork), each of which joins
one process group through a `file://` rendezvous (no port is shared with
any other run), calls `fn(rank, world_size, *args, *rank_args[rank])` and
sends its return value back. The parent waits for every rank under one
time limit. A rank that raises, dies, or outlives the limit fails the
whole run: every rank still alive is killed and `run_ranks` raises with
the failing rank's traceback. Nothing is caught and passed over. Results
come back by plain pickle (tensors copied), arguments go out by
torch.multiprocessing's (CUDA tensors shared with the child).
"""

from __future__ import annotations

import datetime
import gc
import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch
import torch.multiprocessing as mp

from flatquant_torch.parallel.distributed import backend_for


class RankFailure(RuntimeError):
    """A rank raised, died or ran past the time limit."""


def _rank_main(rank, world_size, fn, inbox, backend, init_file, threads,
               timeout_s, out):
    import torch.distributed as dist

    try:
        if threads:
            torch.set_num_threads(threads)
        # the arguments come through a queue, not the process object, so
        # that they can be dropped before the process exits (which runs
        # no destructor): the parent frees a CUDA block it shared only
        # once every child has released it
        args = inbox.get()
        dist.init_process_group(
            backend, init_method=f"file://{init_file}",
            world_size=world_size, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            result = fn(rank, world_size, *args)
        finally:
            del args
            gc.collect()
            dist.destroy_process_group()
        # plain pickle: the multiprocessing queue would share tensors
        # through file descriptors that die with this process
        out.put((rank, True, pickle.dumps(result)))
    except BaseException:  # reported to the parent, which raises
        out.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn: Callable, world_size: int, args: Sequence = (),
              rank_args: Optional[List[Sequence]] = None,
              device="cuda", timeout_s: float = 300.0,
              threads: int = 0, rendezvous_dir: Optional[str] = None):
    """[fn(0, ...), ..., fn(world_size - 1, ...)], each run in its own
    process in one process group. `fn` must be importable by name (a
    module-level function); `args` go to every rank, `rank_args[r]` to
    rank r only (CUDA tensors among them are shared with the child, not
    copied). `device`: where the ranks compute (a device type, or any
    rank's device); the process group's backend is
    distributed.backend_for(device, world_size). `threads` > 0 sets each
    rank's torch thread count.
    `rendezvous_dir` holds the rendezvous file (a fresh temporary
    directory by default)."""
    backend = backend_for(device, world_size)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    inboxes = [ctx.Queue() for _ in range(world_size)]
    rank_args = rank_args or [()] * world_size
    tmp = None
    if rendezvous_dir is None:
        tmp = tempfile.TemporaryDirectory(prefix="fq_ranks_")
        rendezvous_dir = tmp.name
    init_file = os.path.join(rendezvous_dir, f"rdzv_{os.getpid()}_"
                             f"{time.monotonic_ns()}")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world_size, fn, inboxes[r], backend,
                               init_file, threads, timeout_s, out),
                         daemon=True)
             for r in range(world_size)]
    for p, box, mine in zip(procs, inboxes, rank_args):
        p.start()
        box.put(tuple(args) + tuple(mine))
    results, failure = {}, None
    deadline = time.monotonic() + timeout_s
    try:
        while len(results) < world_size and failure is None:
            left = deadline - time.monotonic()
            if left <= 0:
                late = sorted(set(range(world_size)) - set(results))
                failure = (f"ranks {late} did not finish within "
                           f"{timeout_s:.0f} s")
                break
            try:
                rank, ok, value = out.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode is not None]
                if dead:
                    # a rank may have put its result just before exiting
                    try:
                        rank, ok, value = out.get(timeout=2.0)
                    except queue_mod.Empty:
                        failure = (f"rank {dead[0]} exited with code "
                                   f"{procs[dead[0]].exitcode} and no result")
                        break
                else:
                    continue
            if ok:
                results[rank] = pickle.loads(value)
            else:
                failure = f"rank {rank} raised:\n{value}"
    finally:
        for p in procs:
            if failure is not None and p.is_alive():
                p.kill()
            p.join(timeout=30.0)
            if p.is_alive():
                p.kill()
                p.join()
        for box in inboxes:  # a rank that died unread must not hang exit
            box.cancel_join_thread()
            box.close()
        if tmp is not None:
            tmp.cleanup()
    if failure is not None:
        raise RankFailure(failure)
    return [results[r] for r in range(world_size)]
