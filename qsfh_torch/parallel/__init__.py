"""Amplitude sharding of the statevector over ranks of ``torch.distributed``:
the port of ``qsfh_tpu/parallel/`` (its GSPMD placement hints
``amp_sharding``, ``replicated`` and ``constrain_amp`` have no torch
counterpart; :mod:`.comm` and :func:`spawn_ranks` are the port's own)."""

from .comm import all_sum, exchange, spawn_ranks
from .mesh import (Mesh, amplitude_mesh, gather_statevector, group_mesh, local_qubits,
                   shard_input, shard_statevector, sharded_norm2)
from .sharded_hva import build_sharded_hva_step
from .sharded_hva_shmap import build_sharded_hva_step_shmap, build_sharded_hva_train_step
from .sharded_stream import sharded_expectation_stream

__all__ = [
    "Mesh",
    "all_sum",
    "amplitude_mesh",
    "build_sharded_hva_step",
    "build_sharded_hva_step_shmap",
    "build_sharded_hva_train_step",
    "exchange",
    "gather_statevector",
    "group_mesh",
    "local_qubits",
    "shard_input",
    "shard_statevector",
    "sharded_expectation_stream",
    "sharded_norm2",
    "spawn_ranks",
]
