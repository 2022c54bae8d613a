"""The amplitude mesh: D ranks of one ``torch.distributed`` group.

Counterpart of ``qsfh_tpu/parallel/mesh.py``.  The 2^n-amplitude
statevector is sharded by its top k = log2(D) flat bits (qubits 0..k-1):
rank d holds the amplitudes b = (d, l), l the n - k low bits.  Gates on
the low qubits stay on the rank; gates on the high qubits exchange the
shard with rank d ^ m_hi (:func:`comm.exchange`).

The JAX module's ``amp_sharding``, ``replicated`` and ``constrain_amp`` are
GSPMD placement hints: torch has no SPMD partitioner, so they have no
counterpart.  A shard here is a plain tensor on the rank's device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..engine.state import as_state, resolve_device
from . import comm


@dataclass(frozen=True)
class Mesh:
    """This process's place in the amplitude mesh."""

    size: int
    rank: int
    backend: Optional[str]
    device: torch.device

    @property
    def k(self) -> int:
        return self.size.bit_length() - 1


def amplitude_mesh(n_devices: Optional[int] = None, backend: Optional[str] = None,
                   device=None) -> Mesh:
    """The mesh of the initialized process group (of ``n_devices`` ranks).

    ``n_devices`` must be a power of two (it divides every 2^n state).  A
    mesh of one needs no group.  A larger one needs a group of that world
    size: one started by :func:`comm.spawn_ranks`, or by ``torchrun``, whose
    environment (``WORLD_SIZE``, ``MASTER_ADDR``, ...) initializes it here
    with ``backend``.  ``nccl`` puts rank r on cuda:r and raises where the
    machine has fewer cards than ranks; ``gloo`` puts every rank on
    ``device`` (``cuda`` by default, cuda:0; ``cpu`` on request).
    """
    if n_devices is None:
        n_devices = comm.world_size()
    if n_devices < 1 or n_devices & (n_devices - 1):
        raise ValueError(f"amplitude mesh needs a power-of-two device count, got {n_devices}")
    return group_mesh(n_devices, backend, device)


def group_mesh(n_devices: Optional[int] = None, backend: Optional[str] = None,
               device=None) -> Mesh:
    """:func:`amplitude_mesh` without its power-of-two rule: the mesh of the
    initialized group of ``n_devices`` ranks, as any axis over the ranks
    (multistart's start axis) takes it."""
    if n_devices is None:
        n_devices = comm.world_size()
    if n_devices < 1:
        raise ValueError(f"a mesh needs at least one device, got {n_devices}")
    if n_devices > 1 and not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend or "nccl", init_method="env://")
    world = comm.world_size()
    if n_devices > 1 and not dist.is_initialized():
        raise RuntimeError(
            f"a mesh of {n_devices} ranks needs an initialized process group of "
            f"{n_devices} ranks: start them with qsfh_torch.parallel.spawn_ranks(fn, "
            f"{n_devices}, backend=...) or torchrun --nproc-per-node {n_devices}")
    if n_devices != world and n_devices > 1:
        raise ValueError(f"requested {n_devices} devices, the process group has {world} ranks")
    backend = dist.get_backend() if dist.is_initialized() else backend
    if backend == "nccl":
        if torch.cuda.device_count() < n_devices:
            raise RuntimeError(f"nccl needs one card per rank: {n_devices} ranks, "
                               f"{torch.cuda.device_count()} cards; use backend='gloo'")
        dev = torch.device("cuda", comm.rank())
        torch.cuda.set_device(dev)
    else:
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", 0)
    return Mesh(n_devices, comm.rank() if n_devices > 1 else 0, backend, dev)


def local_qubits(n_qubits: int, mesh: Mesh) -> int:
    """The low qubits whose gates never leave a rank: n - log2(D)."""
    return n_qubits - mesh.k


def shard_statevector(psi: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's shard of a full state (its slice d of the leading bits),
    a new contiguous tensor on the mesh's device."""
    size = psi.shape[0] // mesh.size
    return psi[mesh.rank * size:(mesh.rank + 1) * size].to(mesh.device).clone()


def gather_statevector(psi_l: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The full state from the ranks' shards, on every rank."""
    return comm.all_gather_cat(psi_l) if mesh.size > 1 else psi_l.clone()


def shard_input(vec, mesh: Mesh, n_qubits: int, dtype) -> torch.Tensor:
    """This rank's shard of a state given whole (2^n entries: a numpy array
    or a tensor, host or device) or as the rank's shard (2^n / D entries),
    told apart by its length: a tensor of ``dtype`` on the mesh's device (a
    shard already there is returned as it is)."""
    size = int(vec.shape[0])
    if size == 1 << n_qubits:
        full = vec if torch.is_tensor(vec) else torch.from_numpy(np.array(vec))
        return shard_statevector(full, mesh).to(dtype)
    if size == (1 << n_qubits) // mesh.size:
        return as_state(vec, mesh.device, dtype)
    raise ValueError(f"a state of {size} entries is neither the {n_qubits}-qubit state nor "
                     f"its shard over {mesh.size} ranks")


def sharded_norm2(psi_l: torch.Tensor) -> float:
    """<psi|psi> over the whole state in float64 (each shard's share
    widened, then summed in rank order)."""
    share = torch.linalg.vector_norm(psi_l.to(torch.complex128)) ** 2
    return float(comm.all_sum(share.reshape(1))[0])
