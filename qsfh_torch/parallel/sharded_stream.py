"""The sharded expectation in the partner form of the streaming kernels.

Counterpart of ``qsfh_tpu/parallel/sharded_stream.py``, which runs the
Pallas ``expectation_stream_planes`` (``qsfh_tpu/engine/pallas_kernels.py``
:1596) under ``shard_map`` with the XOR partner's planes as its partner
inputs.  The port's sharded expectation is already that form:
:class:`.sharded_compiled.ShardedObservable` splits the terms by x_hi (one
exchange per distinct value delivers the partner's shard), folds z_hi into
a per-rank sign on the coefficients, and runs the local x_lo / z_lo through
the inner-product tile kernel on the shard: ``expectation_grouped`` for
x_hi = 0 and ``expectation_partner`` (Re sum_t c_t <psi_l|P_t|psi_partner>)
for the others; the ranks' values meet in one rank-order sum.  This module
keeps the JAX module's names: :func:`pack_stream_groups`, its host layout,
and :func:`sharded_expectation_stream`, served by that class.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..engine.state import qmask_to_bmask
from .sharded_compiled import ShardedObservable
from .shmap_engine import ShardedPauliEngine


def pack_stream_groups(op, n: int, k: int
                       ) -> Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray, np.ndarray,
                                                        np.ndarray]]:
    """Host prep: op's terms split by their (x_hi, z_hi) shard-bit patterns:
    {(x_hi, z_hi): (xlo, zlo, cre, cim)} with the LOCAL flat masks and the
    (-1)^{|z & x|}-adjusted float32 coefficients (the JAX module's layout)."""
    lo_mask = (1 << (n - k)) - 1
    groups: Dict[Tuple[int, int], List[List]] = {}
    for x, z, c in zip(op.x, op.z, op.c):
        x, z = int(x), int(z)
        c_adj = complex(c) * ((-1.0) ** bin(z & x).count("1"))
        xb, zb = qmask_to_bmask(x, n), qmask_to_bmask(z, n)
        groups.setdefault((xb >> (n - k), zb >> (n - k)), []).append(
            [xb & lo_mask, zb & lo_mask, c_adj.real, c_adj.imag])
    packed = {}
    for key, terms in sorted(groups.items()):
        arr = np.asarray(terms, np.float64)
        packed[key] = (np.asarray([t[0] for t in terms], np.uint32),
                       np.asarray([t[1] for t in terms], np.uint32),
                       arr[:, 2].astype(np.float32), arr[:, 3].astype(np.float32))
    return packed


def sharded_expectation_stream(engine: ShardedPauliEngine, op, impl=None):
    """fn(psi_l) -> Re<psi|op|psi> (the same bits on every rank): the JAX
    module's name for :meth:`.sharded_compiled.ShardedObservable.expectation`,
    whose x_hi != 0 groups take the partner form."""
    obs = ShardedObservable.of(engine, op)
    return lambda psi_l: obs.expectation(psi_l, impl=impl)
