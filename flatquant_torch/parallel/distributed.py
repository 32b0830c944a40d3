"""Process groups, collectives and profiling (port of
flatquant_tpu/parallel/distributed.py).

JAX runs one SPMD program under shard_map, with psum / pmax / pmin and
ppermute inserted by name. The port runs one process per rank over
torch.distributed and writes every collective out, as Megatron does:
`all_reduce` (SUM / MAX / MIN), `all_gather`, `broadcast`, `send` /
`recv` and `ring_shift` (one hop around an axis, ppermute's ring), each
over one mesh axis (parallel/mesh.py `Axis`).

Backends: NCCL where every rank has a card of its own; gloo where ranks
share one card (NCCL refuses two ranks on one device), and gloo on the
CPU. A gloo group cannot move CUDA tensors, so with CUDA tensors over gloo
every helper copies through the host: that is written once, here
(`_host`), and counted in `TRANSPORT` by the name of the route that ran
("nccl", "gloo", or "gloo+host" for host staging), so a run can say how
its ranks talked. It is a transport, not a fallback: the kernels still run
on the card, on each rank's shard. These collectives are not
differentiable; parallel/tp_autograd.py wraps them with a stated backward
for training under a mesh.
"""

from __future__ import annotations

import contextlib
import os
from collections import Counter
from typing import Optional

import torch
import torch.distributed as dist

# collectives run, by transport ("nccl", "gloo", "gloo+host")
TRANSPORT: Counter = Counter()


def backend_for(device, world_size: int) -> str:
    """"nccl" when `device` is a card and there is one card per rank,
    else "gloo" (ranks sharing a card, or the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device="cuda") -> int:
    """init_process_group from arguments or the environment; returns this
    process's rank (0 and no group when there is one process).

    The world size comes from `num_processes`, FLATQUANT_NUM_PROCESSES
    (JAX's variable) or torchrun's WORLD_SIZE; the rank from `process_id`,
    FLATQUANT_PROCESS_ID or RANK; the address ("host:port" or a full
    init_method URL such as file:///path) from `coordinator_address`,
    FLATQUANT_COORDINATOR or MASTER_ADDR:MASTER_PORT. The backend is
    `backend_for(device, world size)`."""
    env = os.environ
    if num_processes is None:
        num_processes = int(env.get("FLATQUANT_NUM_PROCESSES",
                                    env.get("WORLD_SIZE", "1")))
    if num_processes <= 1:
        return 0
    if process_id is None:
        process_id = int(env.get("FLATQUANT_PROCESS_ID", env.get("RANK",
                                                                 "0")))
    addr = coordinator_address or env.get("FLATQUANT_COORDINATOR")
    if addr is None:
        addr = (f"{env.get('MASTER_ADDR', 'localhost')}:"
                f"{env.get('MASTER_PORT', '12355')}")
    method = addr if "://" in addr else f"tcp://{addr}"
    dist.init_process_group(backend_for(device, num_processes),
                            init_method=method, world_size=num_processes,
                            rank=process_id)
    return dist.get_rank()


@contextlib.contextmanager
def profile(trace_dir: Optional[str]):
    """torch.profiler trace of the block into `trace_dir` (a Chrome trace
    per rank); a no-op when trace_dir is None."""
    if not trace_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile as tprofile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    rank = dist.get_rank() if dist.is_initialized() else 0
    with tprofile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(trace_dir, f"rank{rank}.json"))


# ---------------------------------------------------------------------------
# collectives over one mesh axis
# ---------------------------------------------------------------------------


def _host(t: torch.Tensor, axis) -> bool:
    """Whether `t` must be staged through the host for this axis's group
    (a CUDA tensor over gloo); counts the transport."""
    staged = t.is_cuda and axis.backend == "gloo"
    TRANSPORT["gloo+host" if staged else axis.backend] += 1
    return staged


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def all_reduce(t: torch.Tensor, op: str, axis) -> torch.Tensor:
    """The reduction of `t` over the axis's ranks ("sum", "max", "min"),
    as a new tensor in t's dtype, as JAX's psum / pmax / pmin (a bf16
    sum of two ranks rounds once)."""
    if axis.size == 1:
        return t
    if _host(t, axis):
        cpu = t.cpu()
        dist.all_reduce(cpu, op=_OPS[op], group=axis.group)
        return cpu.to(t.device)
    buf = t.clone()
    dist.all_reduce(buf, op=_OPS[op], group=axis.group)
    return buf


def all_gather(t: torch.Tensor, dim: int, axis) -> torch.Tensor:
    """Every rank's `t` concatenated along `dim` in axis order."""
    if axis.size == 1:
        return t
    src = t.contiguous()
    staged = _host(src, axis)
    if staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(parts, src, group=axis.group)
    out = torch.cat(parts, dim=dim)
    return out.to(t.device) if staged else out


def broadcast(t: torch.Tensor, src: int, axis) -> torch.Tensor:
    """Rank `src`'s (index on the axis) `t` on every rank of the axis; the
    other ranks pass a tensor of the same shape and dtype to fill."""
    if axis.size == 1:
        return t
    buf = t.contiguous()
    staged = _host(buf, axis)
    if staged:
        buf = buf.cpu()
    dist.broadcast(buf, src=axis.ranks[src], group=axis.group)
    return buf.to(t.device) if staged else buf


class _Pending:
    """An isend in flight; `wait` before the buffer may be reused."""

    def __init__(self, work, keep):
        self.work, self.keep = work, keep

    def wait(self):
        self.work.wait()


def send(t: torch.Tensor, dst: int, axis) -> _Pending:
    """Start sending `t` to index `dst` on the axis; returns the pending
    send (wait on it before reusing t)."""
    buf = t.contiguous()
    if _host(buf, axis):
        buf = buf.cpu()
    return _Pending(dist.isend(buf, dst=axis.ranks[dst], group=axis.group),
                    buf)


def recv(shape, dtype, src: int, axis, device) -> torch.Tensor:
    """Receive a tensor of `shape` / `dtype` from index `src` on the axis,
    onto `device`."""
    dev = torch.device(device)
    staged = dev.type == "cuda" and axis.backend == "gloo"
    TRANSPORT["gloo+host" if staged else axis.backend] += 1
    buf = torch.empty(shape, dtype=dtype,
                      device="cpu" if staged else dev)
    dist.recv(buf, src=axis.ranks[src], group=axis.group)
    return buf.to(dev) if staged else buf


def ring_shift(t: torch.Tensor, axis) -> torch.Tensor:
    """One hop around the axis's ring: send `t` to index + 1, return what
    index - 1 sent (JAX's ppermute with perm [(i, (i + 1) % n)])."""
    if axis.size == 1:
        return t
    n, i = axis.size, axis.index
    buf = t.contiguous()
    staged = _host(buf, axis)
    if staged:
        buf = buf.cpu()
    out = torch.empty_like(buf)
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, buf, axis.ranks[(i + 1) % n], axis.group),
        dist.P2POp(dist.irecv, out, axis.ranks[(i - 1) % n], axis.group)])
    for w in works:
        w.wait()
    return out.to(t.device) if staged else out
