"""Host layouts of the stream kernels: local runs and flip-mask groups.

Counterpart of the host side of the HBM-streaming kernels in
``qsfh_tpu/engine/pallas_kernels.py`` (``_order_runs`` :1030,
``_stream_groups`` :1057), without their TPU workarounds (256-term SMEM
chunks, (8, 128) row blocks, one-hot slots, group-permuted outputs).

Past a cap on the qubit count the engine stops launching once per term:

* above ``CHAIN_MAX_QUBITS``, rotations and the adjoint sweep are cut by
  :func:`order_runs` into order-preserving runs of consecutive terms whose
  flip mask stays inside a tile of ``2^local_bits`` amplitudes; a run
  costs one pass over the state (``rotation_local_runs`` /
  ``adjoint_local_runs``), and every block-crossing term is a run of one
  that the per-term pair kernels take;
* above ``INNER_CHAIN_MAX_QUBITS``, expectation values and pool screening,
  sums over terms, group the terms by flip mask (:func:`group_by_x`) and
  ``pauli_inner_grouped`` reads the partner side once per group; results
  come back in input term order.

Layouts are built once per segment, observable or pool (the engine caches
them beside its term tensors).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

# The caps, timed on an H100 with both routes back to back (chip_smoke.py
# --routes; numbers in PERF.md).  Rotations and the adjoint sweep: up to 20
# qubits the state (8 MiB at most) stays in the 50 MB L2, a per-term
# launch costs about what a term costs inside a local-run tile, and the
# per-term adjoint sweep was 17% (18 qubits) and 10% (20 qubits) faster
# than the runs; at 24 qubits every launch streams the 128 MiB state from
# HBM and the runs were 2.3x faster.  Inner products: grouping was faster
# at every size timed (18, 20, 24 qubits); 18 keeps the 18-qubit path on
# the per-term kernel, as the JAX package's chain cap does.
CHAIN_MAX_QUBITS = 20
INNER_CHAIN_MAX_QUBITS = 18
# Local bits of a run tile: 2^14 complex64 = 128 KiB of shared memory for
# rotations; the adjoint holds psi and lambda, two tiles of 2^13.
ROT_LOCAL_BITS = 14
ADJ_LOCAL_BITS = 13
# Terms of one flip-mask group per kernel pass (the kernel stages their
# z masks and per-warp sums in shared memory); larger groups are split.
MAX_GROUP_TERMS = 256


def order_runs(xs, local_bits: int) -> List[Tuple[int, List[int]]]:
    """Order-preserving run partition of a rotation-like term sequence.

    Consecutive terms whose flip mask lies below bit ``local_bits`` merge
    into one run; every block-crossing term is a run of one.  Returns
    ``[(xh, [term indices])]`` with ``xh = x >> local_bits`` (0 for a
    local run), the contract of the JAX package's ``_order_runs`` with
    ``local_bits`` in place of ``LANE_BITS + bb``.
    """
    xh_all = (np.asarray(xs, np.uint64) >> np.uint64(local_bits)).astype(np.int64)
    runs: list = []
    for t, h in enumerate(xh_all):
        h = int(h)
        if h == 0 and runs and runs[-1][0] == 0:
            runs[-1][1].append(t)
        else:
            runs.append((h, [t]))
    return runs


class RunLayout:
    """The spans an engine call walks for one term sequence.

    ``spans`` is a list of ``(local, t0, t1)``: a local run of terms
    ``[t0, t1)`` for the run kernels, or consecutive block-crossing terms
    for the per-term pair kernels (one launch per term either way).
    """

    __slots__ = ("local_bits", "spans", "n_local_runs", "n_crossing")

    def __init__(self, xs, local_bits: int):
        self.local_bits = local_bits
        spans: list = []
        for xh, idx in order_runs(xs, local_bits):
            local = xh == 0
            if not local and spans and not spans[-1][0]:
                spans[-1][2] = idx[-1] + 1
            else:
                spans.append([local, idx[0], idx[-1] + 1])
        self.spans = [tuple(s) for s in spans]
        self.n_local_runs = sum(1 for s in self.spans if s[0])
        self.n_crossing = sum(t1 - t0 for local, t0, t1 in self.spans if not local)

    @property
    def passes(self) -> int:
        """State passes of one call: one per local run and per crossing term."""
        return self.n_local_runs + self.n_crossing


def group_by_x(xs, max_terms: int = MAX_GROUP_TERMS):
    """Stable grouping of a term list by flip mask: ``(order, starts)``.

    Groups are ordered by the first appearance of their mask and keep
    their terms in input order; a group larger than ``max_terms`` is split
    into consecutive pieces with the same mask.  ``order[j]`` is the input
    index of the j-th grouped term, so grouped results land back in input
    order at ``out[order[j]]``; group g holds grouped terms
    ``[starts[g], starts[g + 1])``.
    """
    xs = np.asarray(xs, np.int64)
    _, first, inv = np.unique(xs, return_index=True, return_inverse=True)
    rank = np.argsort(np.argsort(first))
    order = np.argsort(rank[inv.reshape(-1)], kind="stable").astype(np.int64)
    xs_sorted = xs[order]
    starts = [0]
    for j in range(1, xs.size + 1):
        if j == xs.size or xs_sorted[j] != xs_sorted[starts[-1]] or j - starts[-1] == max_terms:
            starts.append(j)
    return order, np.asarray(starts, np.int64)


class GroupLayout:
    """The flip-mask grouping of one term list (flip masks ``xs``, phase
    masks ``zs``), as :func:`group_by_x` gives it."""

    def __init__(self, xs, zs, max_terms: int = MAX_GROUP_TERMS):
        self.order, self.starts = group_by_x(xs, max_terms)
        self.gx = np.asarray(xs, np.int64)[self.order][self.starts[:-1]]
        self.zs = np.asarray(zs, np.int64)[self.order]
        self.largest = int(np.diff(self.starts).max(initial=0))
        self._cache = {}

    def __len__(self):
        """The number of groups (kernel passes)."""
        return int(self.gx.size)

    def chunks(self, max_terms: int):
        """Consecutive group ranges ``[(g0, g1)]`` of at most ``max_terms``
        terms (or one group) and 65535 groups each: one kernel launch each."""
        key = ("chunks", max_terms)
        if key not in self._cache:
            out, g0 = [], 0
            for g in range(1, len(self)):
                if self.starts[g + 1] - self.starts[g0] > max_terms or g - g0 == 65535:
                    out.append((g0, g))
                    g0 = g
            if len(self):
                out.append((g0, len(self)))
            self._cache[key] = out
        return self._cache[key]

    def tensors(self, device):
        """(gx, starts, zs in group order, order) as int32 tensors on
        ``device``, built once per device."""
        key = str(device)
        if key not in self._cache:
            self._cache[key] = tuple(
                torch.as_tensor(a.astype(np.int32), device=device)
                for a in (self.gx, self.starts, self.zs, self.order)
            )
        return self._cache[key]
