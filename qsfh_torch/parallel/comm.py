"""The collectives of the amplitude-sharded engine, on ``torch.distributed``.

The JAX engine's two collectives and its rank index
(``qsfh_tpu/parallel/shmap_engine.py:45-57``, ``sharded_compiled.py``) map to

* :func:`exchange` for ``jax.lax.ppermute`` along the XOR pairing: rank d
  swaps a tensor with rank d ^ m_hi in one ``dist.batch_isend_irecv``
  (:func:`exchange_into`: several tensors in one batch, each received into
  a tensor the caller holds, such as a stacked pair's second half);
* :func:`all_sum` for ``jax.lax.psum``: the per-rank partials gathered and
  summed in RANK ORDER, so every rank holds the same bits on every call (an
  all-reduce's order is the backend's, and Adam, which divides by |g|,
  turns last-bit differences into trajectories that part);
* ``dist.get_rank()`` for ``jax.lax.axis_index``.

Backends: ``nccl`` moves device tensors, one card per rank; ``gloo``
stages a device tensor through the host explicitly, and its bytes and
milliseconds are counted in :data:`COUNTS` (``staging_ms``).  The caller
names the backend; nothing switches from one to the other.

:func:`spawn_ranks` starts a process group of D ranks on one machine: a
``dist.FileStore`` in a temporary directory (parallel test workers never
collide on a port), the kernel library built once in the parent before the
ranks start (D ranks would otherwise each run nvcc on the same source), and
a time limit after which every rank is killed and the call raises.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

# exchanges, rank-order sums and gathers since the last reset_counts(), their
# bytes (sent by this rank), and the milliseconds spent staging device
# tensors through the host (gloo)
COUNTS = dict(exchanges=0, exchange_bytes=0, sums=0, sum_bytes=0, gathers=0, gather_bytes=0,
              staging_ms=0.0)


def reset_counts() -> None:
    for key in COUNTS:
        COUNTS[key] = 0.0 if key == "staging_ms" else 0


def counts() -> dict:
    return dict(COUNTS)


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _real(t: torch.Tensor) -> torch.Tensor:
    """A real view of t (the backends move real tensors)."""
    return torch.view_as_real(t) if t.is_complex() else t


def _staged(t: torch.Tensor) -> bool:
    return t.device.type != "cpu" and dist.get_backend() != "nccl"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    torch.cuda.current_stream(t.device).synchronize()  # the producing kernels: not staging
    t0 = time.perf_counter()
    out = t.cpu()
    COUNTS["staging_ms"] += (time.perf_counter() - t0) * 1e3
    return out


def exchange(t: torch.Tensor, m_hi: int) -> torch.Tensor:
    """The tensor ``t`` of rank d ^ m_hi, as a new tensor on t's device (the
    XOR pairing is its own inverse: both ranks of a pair call this with the
    same m_hi).  m_hi = 0 returns t itself."""
    if m_hi == 0:
        return t
    out = torch.empty_like(t, memory_format=torch.contiguous_format)
    exchange_into([t], [out], m_hi)
    return out


def exchange_into(ts, outs, m_hi: int) -> None:
    """Each tensor of ``ts`` sent to rank d ^ m_hi, and that rank's tensor
    received into the contiguous tensor of ``outs`` at the same place (its
    shape and dtype), in ONE ``batch_isend_irecv``: one exchange in
    :data:`COUNTS`.  gloo with device tensors receives into the host and
    copies each into its ``out``; no other device tensor is allocated.
    m_hi = 0 copies each t into its out."""
    me = rank()
    partner = me ^ int(m_hi)
    if partner == me:
        for t, out in zip(ts, outs):
            out.copy_(t)
        return
    if partner >= world_size():
        raise ValueError(f"exchange: rank {me} has no partner {partner} in a group of "
                         f"{world_size()}")
    ops, staged = [], []
    for t, out in zip(ts, outs):
        if not out.is_contiguous() or out.shape != t.shape or out.dtype != t.dtype:
            raise ValueError("exchange_into: each out must be contiguous, of its t's shape "
                             "and dtype")
        send, recv = _real(t.contiguous()), _real(out)
        if _staged(t):
            send = _to_host(send)
            recv = torch.empty_like(send)
            staged.append((recv, out))
        ops += [dist.P2POp(dist.isend, send, partner), dist.P2POp(dist.irecv, recv, partner)]
        COUNTS["exchange_bytes"] += send.numel() * send.element_size()
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    COUNTS["exchanges"] += 1
    if staged:
        t0 = time.perf_counter()
        for host, out in staged:
            _real(out).copy_(host)
        torch.cuda.current_stream(staged[0][1].device).synchronize()
        COUNTS["staging_ms"] += (time.perf_counter() - t0) * 1e3


def _to_device(t: torch.Tensor, device) -> torch.Tensor:
    t0 = time.perf_counter()
    out = t.to(device)
    if out.is_cuda:
        torch.cuda.current_stream(out.device).synchronize()
    COUNTS["staging_ms"] += (time.perf_counter() - t0) * 1e3
    return out


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """sum over ranks of x (any shape, real or complex), added in rank order:
    the same bits on every rank.  A group of one returns x."""
    world = world_size()
    if world == 1:
        return x
    v = _real(x.contiguous())
    staged = _staged(x)
    if staged:
        v = _to_host(v)
    parts = [torch.empty_like(v) for _ in range(world)]
    dist.all_gather(parts, v)
    COUNTS["sums"] += 1
    COUNTS["sum_bytes"] += v.numel() * v.element_size()
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    if staged:
        total = _to_device(total, x.device)
    return torch.view_as_complex(total) if x.is_complex() else total


def all_gather_cat(x: torch.Tensor) -> torch.Tensor:
    """The ranks' x concatenated in rank order (the full state from its
    shards), on every rank."""
    world = world_size()
    if world == 1:
        return x.clone()
    v = _real(x.contiguous())
    staged = _staged(x)
    if staged:
        v = _to_host(v)
    parts = [torch.empty_like(v) for _ in range(world)]
    dist.all_gather(parts, v)
    COUNTS["gathers"] += 1
    COUNTS["gather_bytes"] += v.numel() * v.element_size()
    out = torch.cat(parts)
    if staged:
        out = _to_device(out, x.device)
    return torch.view_as_complex(out) if x.is_complex() else out


def rank_zero_first(fn):
    """``fn()`` on rank 0, then on the other ranks once rank 0 has returned
    (a barrier between): what rank 0 writes, such as an ED cache file, the
    others read.  A group of one calls ``fn()``."""
    if world_size() == 1:
        return fn()
    if rank() == 0:
        out = fn()
        dist.barrier()
        return out
    dist.barrier()
    return fn()


# -- launching a group -----------------------------------------------------------------


def _rank_main(fn, rank_, world, backend, device, store_path, timeout, args, results):
    try:
        from .mesh import amplitude_mesh

        if device is not None and torch.device(device).type == "cpu":
            torch.set_num_threads(max(1, torch.get_num_threads() // world))
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, store=store, rank=rank_, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout or 1800))
        mesh = amplitude_mesh(world, backend=backend, device=device)
        results.put((rank_, True, fn(mesh, *args)))
    except Exception:  # the parent raises it, naming the rank
        results.put((rank_, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn, world: int, backend: str = "nccl", device=None, timeout=None, args=()):
    """Run ``fn(mesh, *args)`` on ``world`` new processes, one rank each, in
    one process group of ``backend`` (``nccl``: one card a rank, cuda:rank;
    ``gloo``: every rank on ``device``, ``cuda`` (cuda:0) by default, or the
    CPU on request); returns the ranks' results in rank order.

    ``fn`` and ``args`` must be picklable (a module-level function): the
    ranks start fresh interpreters.  Raises the first failing rank's
    traceback, or ``TimeoutError`` when the ranks have not all returned
    after ``timeout`` seconds (``None``: no limit); either way every rank
    still running is killed.
    """
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: use 'nccl' or 'gloo'")
    if device is None:
        device = "cuda"
    if torch.device(device).type == "cuda":
        from ..engine import kernels

        kernels.build()  # once, here, before the ranks load it
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="qsfh_ranks_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, backend, device,
                                                  os.path.join(tmp, "store"), timeout, args,
                                                  results))
             for r in range(world)]
    out: dict = {}
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(out) < world:
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"spawn_ranks: {world - len(out)} of {world} ranks had not "
                                   f"returned after {timeout} s")
            try:
                r, ok, payload = results.get(timeout=0.5)
            except queue_mod.Empty:
                dead = [i for i, p in enumerate(procs) if p.exitcode not in (None, 0)
                        and i not in out]
                if dead:
                    raise RuntimeError(f"spawn_ranks: rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no result")
                continue
            if not ok:
                raise RuntimeError(f"spawn_ranks: rank {r} failed:\n{payload}")
            out[r] = payload
    finally:
        for p in procs:
            p.join(timeout=10 if len(out) == world else 0.1)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world)]
