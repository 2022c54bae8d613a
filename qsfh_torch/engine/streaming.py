"""Host layouts of the stream kernels: tile runs and flip-mask groups.

Counterpart of the host side of the HBM-streaming kernels in
``qsfh_tpu/engine/pallas_kernels.py`` (``_order_runs`` :1030,
``_stream_groups`` :1057), without their TPU workarounds (256-term SMEM
chunks, (8, 128) row blocks, one-hot slots, group-permuted outputs).

Past a cap on the qubit count the engine stops launching once per term:

* above ``CHAIN_MAX_QUBITS``, rotations and the adjoint sweep are cut by
  :func:`order_tile_runs` into order-preserving runs of consecutive terms
  whose flip masks all lie inside one tile: the low ``TILE_LOW_BITS``
  flat bits plus higher bits chosen per run, ``2^k`` amplitudes in all
  (:class:`TileLayout`).  A run costs one pass over the state
  (``rotation_tile_runs`` / ``adjoint_tile_runs``).  The JAX package's
  tiles are the low bits only, so every term that flips a higher bit
  costs a pass of its own there; here only a term that fits no tile does
  (none at 24 qubits), and the per-term pair kernels take it;
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

# The caps, timed with chip_smoke.py --routes on an NVIDIA H100 80GB HBM3
# at its 700 W power limit, both routes interleaved (numbers in PERF.md).
# Rotations and the adjoint sweep: the tile runs won the 2x5 (20-qubit)
# train step in all five runs that timed them, 2.3-3.3 ms against 8.8-9.4
# ms per term, and the 18-qubit step as well (1.7-2.6 against 4.5-6.0
# ms); the cap sits at 18 so that the 3x3 main path keeps its per-term
# kernels.  Inner products: grouping was faster at every size timed (18,
# 20, 24 qubits); 18 keeps the 18-qubit path on the per-term kernel, as
# the JAX package's chain cap does.
CHAIN_MAX_QUBITS = 18
INNER_CHAIN_MAX_QUBITS = 18
# Tile runs: a tile holds 2^TILE_BITS amplitudes, the low TILE_LOW_BITS
# flat bits (rows of 2^c contiguous amplitudes, 128 bytes) and the others
# chosen per run.  Timed on the 2x6 segment over k = 12, 13 and c = 4, 5
# (chip_smoke.py --tiles, two runs): 12 / 4 was the fastest for the
# rotations and the adjoint both, 46 state passes each way.
TILE_BITS = 12
TILE_LOW_BITS = 4
# A thread holds the 2^REG_BITS slots of a tile that differ in REG_BITS
# chosen tile bits, in registers; terms per run, staged in shared memory.
REG_BITS = 4
MAX_RUN_TERMS = 256
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


def _positions(mask: int) -> List[int]:
    return [b for b in range(mask.bit_length()) if mask >> b & 1]


def pext(values, positions) -> np.ndarray:
    """Bit j of the result is bit ``positions[j]`` of each value (int64)."""
    values = np.asarray(values, np.int64)
    out = np.zeros_like(values)
    for j, p in enumerate(positions):
        out |= ((values >> p) & 1) << j
    return out


def order_tile_runs(xs, k: int, c: int, max_terms: int = MAX_RUN_TERMS):
    """Order-preserving greedy partition of a rotation-like term sequence
    into tile runs.

    A run's tile spans the low ``c`` flat bits plus ``k - c`` higher bits:
    the union ``hi`` of its terms' flip bits at and above ``c``, padded
    later.  A term joins the open run while that union stays within
    ``k - c`` bits and the run within ``max_terms`` terms.  A term whose
    own flips above ``c`` exceed ``k - c`` bits, or whose flips exceed the
    ``REG_BITS`` a register group holds, fits no tile and is a run of its
    own with ``hi = None``.  Returns ``[(t0, t1, hi)]``.  Greedy is optimal
    here: any sub-run of a feasible run is feasible.
    """
    low = (1 << c) - 1
    runs: list = []
    for t, x in enumerate(np.asarray(xs, np.int64).tolist()):
        h = x & ~low
        if bin(h).count("1") > k - c or bin(x).count("1") > REG_BITS:
            runs.append([t, t + 1, None])
            continue
        last = runs[-1] if runs else None
        if (last is not None and last[2] is not None and t - last[0] < max_terms
                and bin(last[2] | h).count("1") <= k - c):
            last[1], last[2] = t + 1, last[2] | h
        else:
            runs.append([t, t + 1, h])
    return [tuple(r) for r in runs]


def _pad(mask: int, want: int, candidates) -> int:
    """``mask`` with the first unused ``candidates`` added until it has
    ``want`` bits."""
    for b in candidates:
        if bin(mask).count("1") >= want:
            break
        mask |= (1 << b) & ~mask
    return mask


class TileRuns:
    """Consecutive tile runs of one term span, in the tables the tile-run
    kernels read (term indices relative to the span).

    Run ``r`` covers terms ``[run_start[r], run_start[r + 1])``; its tile
    is the flat bit set ``run_mask[r]`` (the low ``c`` bits and ``k - c``
    others), and tile coordinate bit j is the j-th lowest bit of that set.
    Its register groups are ``[run_group[r], run_group[r + 1])``: group g
    covers terms ``[group_start[g], group_start[g + 1])`` whose flip masks
    in tile coordinates lie inside the ``REG_BITS`` tile bits packed 4
    bits each in ``group_regs[g]`` (ascending).  A thread holds the
    2^REG_BITS slots that differ in those bits, so every term of the group
    pairs slots inside one thread.  Per term: ``code = x_reg | z_reg << 4``
    (flip and phase masks compressed to the register bits), ``z_tile``
    (phase mask in tile coordinates) and ``z_out = z & ~run_mask`` (the
    phase bits outside the tile: one sign per block and term).
    """

    def __init__(self, xs, zs, runs, n: int, k: int, c: int):
        self.k, self.c = k, c
        xs, zs = np.asarray(xs, np.int64), np.asarray(zs, np.int64)
        t_base = runs[0][0]
        run_start, run_mask, run_group = [0], [], [0]
        group_start, group_regs = [], []
        code, z_tile, z_out = [], [], []
        for t0, t1, hi in runs:
            mask = _pad((1 << c) - 1 | hi, k, range(c, n))
            pos = _positions(mask)
            xt, zt = pext(xs[t0:t1], pos), pext(zs[t0:t1], pos)
            for g0, g1, union in _register_groups(xt):
                regs = _positions(_pad(union, REG_BITS, range(k - 1, -1, -1)))
                group_start.append(t0 - t_base + g0)
                group_regs.append(sum(p << (4 * j) for j, p in enumerate(regs)))
                code.extend((pext(xt[g0:g1], regs) | pext(zt[g0:g1], regs) << 4).tolist())
            z_tile.extend(zt.tolist())
            z_out.extend((zs[t0:t1] & ~mask).tolist())
            run_start.append(t1 - t_base)
            run_mask.append(mask)
            run_group.append(len(group_start))
        group_start.append(run_start[-1])
        i32 = lambda a: np.asarray(a, np.int64).astype(np.int32)  # noqa: E731
        self.run_start, self.run_mask, self.run_group = i32(run_start), i32(run_mask), i32(run_group)
        self.group_start, self.group_regs = i32(group_start), i32(group_regs)
        self.code, self.z_tile, self.z_out = i32(code), i32(z_tile), i32(z_out)
        self.term_mask = np.repeat(self.run_mask, np.diff(self.run_start))
        self._cache = {}

    def __len__(self):
        """The number of runs (state passes, kernel launches)."""
        return int(self.run_mask.size)

    @property
    def n_terms(self) -> int:
        return int(self.run_start[-1])

    @property
    def n_groups(self) -> int:
        return int(self.group_regs.size)

    def tensors(self, device):
        """(code, z_tile, z_out, group_start, group_regs) as int32 tensors
        on ``device``, built once per device."""
        key = str(device)
        if key not in self._cache:
            self._cache[key] = tuple(
                torch.as_tensor(a, device=device)
                for a in (self.code, self.z_tile, self.z_out, self.group_start, self.group_regs)
            )
        return self._cache[key]


def _register_groups(x_tile):
    """Greedy order-preserving groups of a run's flip masks (tile
    coordinates) whose union has at most ``REG_BITS`` bits: ``[(t0, t1,
    union)]`` with term indices relative to the run."""
    groups: list = []
    for t, x in enumerate(x_tile.tolist()):
        if groups and bin(groups[-1][2] | x).count("1") <= REG_BITS:
            groups[-1][1], groups[-1][2] = t + 1, groups[-1][2] | x
        else:
            groups.append([t, t + 1, x])
    return groups


class TileLayout:
    """The spans an engine call walks for one term sequence past
    ``CHAIN_MAX_QUBITS``.

    ``spans`` is a list of ``(tiles, t0, t1)``: consecutive tile runs of
    terms ``[t0, t1)`` for the tile-run kernels (``tiles`` a
    :class:`TileRuns`), or, with ``tiles = None``, consecutive terms that
    fit no tile, for the per-term pair kernels.
    """

    __slots__ = ("k", "c", "spans", "n_runs", "n_single")

    def __init__(self, xs, zs, n: int, k: int, c: int):
        k = min(k, n)
        c = min(c, k)
        if k < REG_BITS:
            raise ValueError(f"a tile of {k} bits cannot hold {REG_BITS} register bits")
        self.k, self.c = k, c
        pieces: list = []
        for run in order_tile_runs(xs, k, c):
            fits = run[2] is not None
            if pieces and pieces[-1][0] == fits:
                pieces[-1][1].append(run)
            else:
                pieces.append((fits, [run]))
        self.spans = [
            (TileRuns(xs, zs, runs, n, k, c) if fits else None, runs[0][0], runs[-1][1])
            for fits, runs in pieces
        ]
        self.n_runs = sum(len(s[0]) for s in self.spans if s[0] is not None)
        self.n_single = sum(t1 - t0 for tiles, t0, t1 in self.spans if tiles is None)

    @property
    def n_groups(self) -> int:
        return sum(s[0].n_groups for s in self.spans if s[0] is not None)

    @property
    def passes(self) -> int:
        """State passes of one call: one per tile run and per term that
        fits no tile."""
        return self.n_runs + self.n_single


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
