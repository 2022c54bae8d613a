"""Host layouts of the stream kernels: tile runs and inner-product tiles.

Counterpart of the host side of the HBM-streaming kernels in
``qsfh_tpu/engine/pallas_kernels.py`` (``_order_runs`` :1030,
``_stream_groups`` :1057), without their TPU workarounds (256-term SMEM
chunks, (8, 128) row blocks, one-hot slots, group-permuted outputs).

* Rotations and the adjoint sweep are cut by :func:`order_tile_runs` into
  order-preserving runs of consecutive terms whose flip masks all lie
  inside one tile: the low ``c`` flat bits plus higher bits chosen per
  run, ``2^k`` amplitudes in all (:class:`TileLayout`).  The JAX
  package's tiles are the low bits only, so every term that flips a
  higher bit costs a pass of its own there; here only a term that fits no
  tile does (none on the 3x3 and 2x6 paths), and the per-term pair kernels
  take it.  Up to ``CHAIN_MAX_QUBITS`` the state sits in the card's L2:
  tiles of ``RESIDENT_TILE_BITS`` / ``RESIDENT_TILE_LOW_BITS``, and a
  whole span of runs is ONE launch (``rotation_resident`` /
  ``adjoint_resident``: persistent blocks, a grid barrier between runs).
  Above it a run costs one pass over the state in HBM, one launch each
  (``rotation_tile_runs`` / ``adjoint_tile_runs``, tiles of ``TILE_BITS``
  / ``TILE_LOW_BITS``).  Inside a run, each group of 3-8 consecutive
  commuting terms that :func:`fused_groups` finds (a double excitation's 8
  strings) runs as ONE closed-form pair rotation, its table of 2^R angles
  formed on the device every call; every other term runs alone.
* Expectation values and pool screening, sums over terms, cut the terms
  into items (one flip mask, phase masks equal off ``REG_BITS`` bits) and
  cover the items with tiles of chosen bits (:class:`GroupTiles`: the low
  ``INNER_TILE_LOW_BITS`` flat bits plus bits chosen per tile,
  ``2^INNER_TILE_BITS`` amplitudes); one pass of the state serves every
  item inside a tile (the inner-product tile kernel).  The engine's
  layout takes the x = 0 terms out of the items as one diagonal: a
  Walsh-Hadamard transform of conj(a) psi over a tile serves all of them.
  Blocks take slices of a tile's items where the tiles alone would leave
  the card half empty (:meth:`GroupTiles.schedule`).  A term whose mask
  has more than ``REG_BITS`` bits takes the per-term ``pauli_inner``
  (none in a Hubbard term list).

Layouts are built once per segment, observable or pool (the engine caches
them beside its term tensors).
"""

from __future__ import annotations

from itertools import combinations
from typing import List, Tuple

import numpy as np
import torch

# The cap, timed with chip_smoke.py --routes on an NVIDIA H100 80GB HBM3
# at its 700 W power limit, the routes interleaved (numbers in PERF.md).
# Rotations and the adjoint sweep: up to the cap the resident route (one
# launch per span), above it one launch per tile run; the cap is the
# size whose state sits in L2.  Inner products take the tiles at every
# size from kernels.INNER_TILE_MIN_BITS (9) qubits on.
CHAIN_MAX_QUBITS = 18
# Tile runs: a tile holds 2^TILE_BITS amplitudes, the low TILE_LOW_BITS
# flat bits (rows of 2^c contiguous amplitudes, 128 bytes) and the others
# chosen per run.  Timed on the 2x6 segment over k = 12, 13 and c = 4, 5
# (chip_smoke.py --tiles, two runs): 12 / 4 was the fastest for the
# rotations and the adjoint both, 46 state passes each way.
TILE_BITS = 12
TILE_LOW_BITS = 4
# Resident tile runs (up to CHAIN_MAX_QUBITS): the same layout, one
# cooperative launch per span.  An 18-qubit state has 2^14 threads of 16
# slots whatever the tile, so a larger tile means fewer runs and grid
# barriers but fewer blocks: at 12 bits 64 blocks would leave half of the
# H100's 132 SMs idle.
RESIDENT_TILE_BITS = 11
RESIDENT_TILE_LOW_BITS = 3
# The float64 group engine's resident route (native.statevec.Rot64Program,
# Group64Runs): tiles of 2^RESIDENT64_TILE_BITS complex128 amplitudes (32
# KiB at 11 bits), the low RESIDENT64_TILE_LOW_BITS flat bits and the
# run's flip bits above them; a run's group tables (cos, sin and r, 24
# bytes an entry) at most RESIDENT64_RUN_ENTRIES entries (48 KiB), at most
# RESIDENT64_RUN_GROUPS groups.  On the 3x3 checkpoint (1931 groups), timed
# with chip_smoke.py's polish phase on an NVIDIA H100 80GB HBM3 at 700 W
# (value_and_grad, ms): 11 / 1 (521 runs) 10.03, 11 / 0 (488) 10.55,
# 11 / 2 (553) 10.07, 11 / 3 (609) 10.81, 12 / 1 (424, 64 blocks) 11.58,
# 10 / 1 (639) 11.24; the table budget closes no run at any of them.  A
# block stages the next run beside the current one, so where two stage
# buffers of RESIDENT64_RUN_ENTRIES would not fit beside the tiles (12
# bits) a run takes fewer entries (resident64_run_entries).
RESIDENT64_TILE_BITS = 11
RESIDENT64_TILE_LOW_BITS = 1
RESIDENT64_RUN_ENTRIES = 2048
RESIDENT64_RUN_GROUPS = 128
# the shared memory a block may take (the kernels' kMaxDynamicSmem: the
# H100's opt-in per block)
RESIDENT64_SMEM = 232448
# tile shapes the kernels take: a warp of pair threads at least, two 64 KiB
# complex128 tiles at most
RESIDENT64_MIN_BITS = 6
RESIDENT64_MAX_BITS = 12
# threads of a block, both kernels (capped at the tile's pairs, at least an
# eighth of its slots: a thread copies at most 8)
RESIDENT64_THREADS = 256
# int32 words of a group record (the kernels' kRes64Rec): xt, pxor, its
# table's base in the run's tables, rank, the basis in tile coordinates (8)
# and flat (8)
RESIDENT64_RECORD = 20
# A thread holds the 2^REG_BITS slots of a tile that differ in REG_BITS
# chosen tile bits, in registers; terms per run, staged in shared memory.
REG_BITS = 4
MAX_RUN_TERMS = 256
# Fused groups (fused_groups): the terms of one group_terms group, at least
# FUSED_MIN_TERMS, whose phase masks have rank at most FUSED_MAX_RANK over
# GF(2), run in closed form from a table of 2^rank (cos, sin) entries, each
# a register group of its own; a group of higher rank is cut into
# consecutive pieces.  A pair (a Givens rotation's two strings, a hopping
# bond's XX and YY) runs its terms alone: as a register group of its own it
# took longer than beside its neighbours (PERF.md, PR 22).  FUSED_RECORD
# int32 words a group (the kernels' kFusedRec; TileRuns.frec).  A fused
# group's register word carries FUSED_GROUP (above the 4 register bits'
# 16); its terms' code words (x_reg 0-3, z_reg 4-7; 8-10 the kernels' own)
# their coefficient masks over the group's basis at FUSED_COEF_SHIFT, its
# first term's also the group's terms less one at FUSED_SIZE_SHIFT and its
# record within the run at FUSED_INDEX_SHIFT.
FUSED_MAX_RANK = 4
FUSED_MIN_TERMS = 3
FUSED_CAP = 8
FUSED_RECORD = 12
FUSED_GROUP = 1 << 16
FUSED_COEF_SHIFT = 12
FUSED_SIZE_SHIFT = 16
FUSED_INDEX_SHIFT = 20
# Inner-product tiles: 2^INNER_TILE_BITS amplitudes, the low
# INNER_TILE_LOW_BITS flat bits and the others chosen per tile so that the
# bits of every item of the tile lie inside.  The kernel keeps 16 bucket
# sums per item in shared memory (128 bytes); at most MAX_TILE_ITEMS items
# per tile, and a mask with more items is cut into pieces.  Timed on the
# 2x6 pool screen (chip_smoke.py --tiles, two runs, H100): 12 / 2 took
# 9.70 and 9.74 ms (30 passes), 12 / 4 10.40 and 10.34 (46), 13 / 4 13.28
# and 13.37 (31); caps of 16 and 32 items moved no shape by more than 0.5 ms.
INNER_TILE_BITS = 12
INNER_TILE_LOW_BITS = 2
MAX_TILE_ITEMS = 128
# XOR swizzle of an inner-product tile in shared memory: tile bit b >= 4
# adds INNER_SWIZZLE[b - 4] to the slot's low 4 bits.  With the unit
# vectors of bits 0-3 the columns are distinct nonzero 4-bit values, and a
# plane of 4-bit values holds 7, so any 8 of 12 (9 of 13) columns span all
# 16: whichever 4 bits an item takes for its buckets, 4 lane bits can be
# found whose columns span them, and each half-warp's 64-bit loads then
# spread over all 32 banks.
INNER_SWIZZLE = (3, 5, 6, 9, 10, 12, 7, 11, 13)
# The application tile kernel: a thread owns the 16 slots of a tile that
# differ in its top APPLY_TOP_BITS bits.  Fixed by the kernel (kApplyTopBits
# in the CUDA source, where a thread copies 8 slot pairs); item_ehi is built
# for it.
APPLY_TOP_BITS = 4
# A layout built with diagonals (the engine's) takes the x = 0 items of a
# tile that has at least APPLY_DIAG_ITEMS of them as one diagonal: a
# Walsh-Hadamard transform of the tile, ~30 instructions a slot (~60 for
# complex coefficients), in place of ~5 (~10) a slot and item.  The
# Hubbard H has 20-29 such items in its first tile and none in the others
# at 18, 20 and 24 qubits, so the threshold decides only for other term
# lists; the diagonal took 8-11% off the application's device time at each
# of those sizes (chip_smoke.py --routes, H100).
APPLY_DIAG_ITEMS = 5
# The inner-product kernel's schedule (GroupTiles.schedule): a block takes
# up to INNER_TILE_POSITIONS tile positions of one unit, a unit being a
# slice of a tile's items (at least INNER_SLICE_ITEMS, one per warp) or
# the list's diagonal; positions per block are halved, then the items of
# a slice, while the launch has fewer than INNER_BLOCKS_PER_SM blocks per
# SM.  INNER_MAX_SLICES caps the grid's position slices (its y dimension).
INNER_TILE_POSITIONS = 32
INNER_SLICE_ITEMS = 8
INNER_BLOCKS_PER_SM = 8
INNER_MAX_SLICES = 65535
# The float64 tile kernels' layouts (GroupTiles of the float64 Rayleigh
# readout, expectation_norm_f64_tiles, and of the polish engine's H psi,
# happly64_tiles): tiles of 2^k amplitudes, the low c flat bits.  The
# readout keeps the float32 inner products' shape (a complex64 tile, 32 KiB
# at 12 bits, and the same schedule, its diagonal unit always present: it
# takes N); H psi holds a complex128 tile (32 KiB at 11 bits) and, on a
# tile with a diagonal, its spectrum beside it (apply64_layout).  The shapes
# are timed with chip_smoke.py --tiles (k = 10, 11, 12; numbers in PERF.md).
INNER64_TILE_BITS = 12
INNER64_TILE_LOW_BITS = 2
APPLY64_TILE_LOW_BITS = 2


def _positions(mask: int) -> List[int]:
    return [b for b in range(mask.bit_length()) if mask >> b & 1]


def pext(values, positions) -> np.ndarray:
    """Bit j of the result is bit ``positions[j]`` of each value (int64)."""
    values = np.asarray(values, np.int64)
    out = np.zeros_like(values)
    for j, p in enumerate(positions):
        out |= ((values >> p) & 1) << j
    return out


def order_tile_runs(xs, k: int, c: int, max_terms: int = MAX_RUN_TERMS, ends=None):
    """Order-preserving greedy partition of a rotation-like term sequence
    into tile runs.

    A run's tile spans the low ``c`` flat bits plus ``k - c`` higher bits:
    the union ``hi`` of its terms' flip bits at and above ``c``, padded
    later.  A term joins the open run while that union stays within
    ``k - c`` bits and the run within ``max_terms`` terms, counted to
    ``ends[t]``, the end of the term's fused group (``t + 1`` for a term
    alone, the default): a fused group, one flip mask, is never cut.  A
    term whose own flips above ``c`` exceed ``k - c`` bits, or whose flips
    exceed the ``REG_BITS`` a register group holds, fits no tile and is a
    run of its own with ``hi = None``.  Returns ``[(t0, t1, hi)]``.  Greedy
    is optimal here: any sub-run of a feasible run is feasible.
    """
    low = (1 << c) - 1
    runs: list = []
    for t, x in enumerate(np.asarray(xs, np.int64).tolist()):
        h = x & ~low
        if bin(h).count("1") > k - c or bin(x).count("1") > REG_BITS:
            runs.append([t, t + 1, None])
            continue
        last = runs[-1] if runs else None
        end = t + 1 if ends is None else int(ends[t])
        if (last is not None and last[2] is not None and end - last[0] <= max_terms
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
    (flip and phase masks compressed to the register bits) and the fused
    bits (``FUSED_COEF_SHIFT`` ...), ``z_tile`` (phase mask in tile
    coordinates) and ``z_out = z & ~run_mask`` (the phase bits outside the
    tile: one sign per block and term).

    ``fused`` lists the span's fused groups ``[(t0, t1)]`` (indices of the
    term list that ``runs`` cuts, :func:`fused_groups`; ``self.fused``
    holds them relative to the span); each is a register group of its own
    (``FUSED_GROUP`` in its register word), which the kernels run through
    shared memory.  Run ``r``'s are records ``[run_fgroup[r], run_fgroup[r
    + 1])`` of ``frec`` (``FUSED_RECORD`` words each): the first term
    (run-relative) | terms
    less one << 8 | rank R << 12 | unit << 15 (1: odd parity, the strings'
    phases +-i), then the columns of the register bits (nibble j: bit i
    set where basis mask i holds register bit j), the basis (group_basis
    of the phase masks) in tile coordinates (4 words) and flat (4 words),
    zero past R, and two words the kernels fill.  A slot's pattern, bit i =
    parity(b & basis_i), indexes the group's table of 2^R angles
    phi_q = sum_k a_k w_k (1 - 2 parity(q & coef_k)) (a_k the term's angle,
    w_k its phase over the unit, coef_k at ``FUSED_COEF_SHIFT`` in its
    code), which the kernels form from the call's angles.
    """

    def __init__(self, xs, zs, runs, n: int, k: int, c: int, fused=()):
        self.k, self.c = k, c
        xs, zs = np.asarray(xs, np.int64), np.asarray(zs, np.int64)
        t_base = runs[0][0]
        fused = sorted((int(a), int(b)) for a, b in fused)
        run_start, run_mask, run_group, run_fgroup = [0], [], [0], [0]
        group_start, group_regs = [], []
        code, z_tile, z_out, frec = [], [], [], []
        f = 0
        for t0, t1, hi in runs:
            mask = _pad((1 << c) - 1 | hi, k, range(c, n))
            pos = _positions(mask)
            xt, zt = pext(xs[t0:t1], pos), pext(zs[t0:t1], pos)
            f1 = f  # the run's fused groups: fused[f:f1]
            while f1 < len(fused) and fused[f1][0] < t1:
                f1 += 1
            run_fused = [(a - t0, b - t0) for a, b in fused[f:f1]]
            if run_fused and (run_fused[0][0] < 0 or run_fused[-1][1] > t1 - t0):
                raise ValueError(f"a fused group crosses run [{t0}, {t1})")
            run_code, term_regs = [], []
            for g0, g1, union in _register_groups(xt, run_fused):
                regs = _positions(_pad(union, REG_BITS, range(k - 1, -1, -1)))
                term_regs.extend([regs] * (g1 - g0))
                group_start.append(t0 - t_base + g0)
                group_regs.append(sum(p << (4 * j) for j, p in enumerate(regs))
                                  | (FUSED_GROUP if (g0, g1) in run_fused else 0))
                run_code.extend((pext(xt[g0:g1], regs) | pext(zt[g0:g1], regs) << 4).tolist())
            run_code = np.asarray(run_code, np.int64)
            for n_f, (a, b) in enumerate(fused[f:f1]):
                group_z = zs[a:b].tolist()
                basis, coef = group_basis(group_z)
                # the basis in tile coordinates: the staged z_tile of the terms it came from
                zbt = [int(zt[a - t0 + group_z.index(z)]) for z in basis]
                regs = term_regs[a - t0]
                cols = sum((zb >> r & 1) << (4 * j + i)
                           for i, zb in enumerate(zbt) for j, r in enumerate(regs))
                unit = bin(group_z[0] & int(xs[a])).count("1") & 1
                pad = [0] * (4 - len(basis))
                frec.append([(a - t0) | (b - a - 1) << 8 | len(basis) << 12 | unit << 15, cols,
                             *zbt, *pad, *basis, *pad, 0, 0])
                for m, cm in enumerate(coef):
                    run_code[a - t0 + m] |= cm << FUSED_COEF_SHIFT
                run_code[a - t0] |= (b - a - 1) << FUSED_SIZE_SHIFT | n_f << FUSED_INDEX_SHIFT
            code.extend(run_code.tolist())
            z_tile.extend(zt.tolist())
            z_out.extend((zs[t0:t1] & ~mask).tolist())
            run_start.append(t1 - t_base)
            run_mask.append(mask)
            run_group.append(len(group_start))
            run_fgroup.append(run_fgroup[-1] + f1 - f)
            f = f1
        if f != len(fused):
            raise ValueError("a fused group lies outside the span's runs")
        group_start.append(run_start[-1])
        i32 = lambda a: np.asarray(a, np.int64).astype(np.int32)  # noqa: E731
        self.run_start, self.run_mask, self.run_group = i32(run_start), i32(run_mask), i32(run_group)
        self.group_start, self.group_regs = i32(group_start), i32(group_regs)
        self.code, self.z_tile, self.z_out = i32(code), i32(z_tile), i32(z_out)
        self.run_fgroup = i32(run_fgroup)
        self.frec = i32(np.reshape(frec, (-1, FUSED_RECORD)))
        self.fused = np.asarray([(a - t_base, b - t_base) for a, b in fused],
                                np.int64).reshape(-1, 2)
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

    @property
    def fused_groups(self) -> int:
        """Groups run in closed form."""
        return int(self.fused.shape[0])

    @property
    def fused_terms(self) -> int:
        """Terms inside those groups."""
        return int((self.fused[:, 1] - self.fused[:, 0]).sum())

    def tensors(self, device):
        """(code, z_tile, z_out, group_start, group_regs, frec) as int32
        tensors on ``device``, built once per device."""
        key = str(device)
        if key not in self._cache:
            self._cache[key] = tuple(
                torch.as_tensor(a, device=device)
                for a in (self.code, self.z_tile, self.z_out, self.group_start, self.group_regs,
                          self.frec.reshape(-1))
            )
        return self._cache[key]

    def run_tensors(self, device):
        """(run_start, run_mask, run_group, run_fgroup) as int32 tensors on
        ``device`` (a resident launch reads them there), built once per
        device."""
        key = ("runs", str(device))
        if key not in self._cache:
            self._cache[key] = tuple(
                torch.as_tensor(a, device=device)
                for a in (self.run_start, self.run_mask, self.run_group, self.run_fgroup)
            )
        return self._cache[key]

    @property
    def most_terms(self) -> int:
        """The terms of the longest run."""
        return int(np.diff(self.run_start).max())


def _register_groups(x_tile, fused=()):
    """Greedy order-preserving groups of a run's flip masks (tile
    coordinates) whose union has at most ``REG_BITS`` bits: ``[(t0, t1,
    union)]`` with term indices relative to the run.  Each fused group
    ``[a, b)`` of ``fused`` (run-relative) is a group of its own."""
    ends = dict(fused)
    groups: list = []
    grows = False  # whether the last group takes more terms
    x_tile = x_tile.tolist()
    t = 0
    while t < len(x_tile):
        x = x_tile[t]
        if t in ends:
            groups.append([t, ends[t], x])
            grows, t = False, ends[t]
            continue
        if grows and bin(groups[-1][2] | x).count("1") <= REG_BITS:
            groups[-1][1], groups[-1][2] = t + 1, groups[-1][2] | x
        else:
            groups.append([t, t + 1, x])
            grows = True
        t += 1
    return groups


class TileLayout:
    """The spans an engine call walks for one term sequence.

    ``spans`` is a list of ``(tiles, t0, t1)``: consecutive tile runs of
    terms ``[t0, t1)`` for the resident or the tile-run kernels (``tiles`` a
    :class:`TileRuns`), or, with ``tiles = None``, consecutive terms that
    fit no tile, for the per-term pair kernels.
    """

    __slots__ = ("k", "c", "spans", "n_runs", "n_single")

    def __init__(self, xs, zs, n: int, k: int, c: int, pidx=None, phre=None, phim=None):
        k = min(k, n)
        c = min(c, k)
        if k < REG_BITS:
            raise ValueError(f"a tile of {k} bits cannot hold {REG_BITS} register bits")
        self.k, self.c = k, c
        fused = fused_groups(xs, zs, pidx, phre, phim)
        ends = np.arange(1, len(xs) + 1)
        for a, b in fused:
            ends[a:b] = b
        pieces: list = []
        for run in order_tile_runs(xs, k, c, ends=ends):
            fits = run[2] is not None
            if pieces and pieces[-1][0] == fits:
                pieces[-1][1].append(run)
            else:
                pieces.append((fits, [run]))
        self.spans = [
            (TileRuns(xs, zs, runs, n, k, c,
                      [g for g in fused if runs[0][0] <= g[0] < runs[-1][1]])
             if fits else None, runs[0][0], runs[-1][1])
            for fits, runs in pieces
        ]
        self.n_runs = sum(len(s[0]) for s in self.spans if s[0] is not None)
        self.n_single = sum(t1 - t0 for tiles, t0, t1 in self.spans if tiles is None)

    @property
    def n_groups(self) -> int:
        return sum(s[0].n_groups for s in self.spans if s[0] is not None)

    @property
    def fused_terms(self) -> int:
        """Terms the tile kernels run in closed form (:func:`fused_groups`)."""
        return sum(s[0].fused_terms for s in self.spans if s[0] is not None)

    @property
    def passes(self) -> int:
        """State passes of one call: one per tile run and per term that
        fits no tile."""
        return self.n_runs + self.n_single


def group_basis(zs):
    """A GF(2) basis of a group's phase masks, greedy in term order.

    Returns ``(basis, coef)``: ``basis`` the masks of ``zs`` independent of
    the earlier ones, and ``coef[k]`` the basis elements whose XOR is
    ``zs[k]`` (bit j: element j).  Then parity(b & zs[k]) = parity(q &
    coef[k]) with q bit j = parity(b & basis[j]).
    """
    basis, rows, coef = [], [], []
    for z in np.asarray(zs, np.int64).tolist():
        v, combo = z, 0
        for pivot, vec, vcombo in rows:  # insertion order: no pivot comes back
            if v >> pivot & 1:
                v ^= vec
                combo ^= vcombo
        if v:
            j = len(basis)
            basis.append(z)
            rows.append((v.bit_length() - 1, v, combo ^ (1 << j)))
            coef.append(1 << j)
        else:
            coef.append(combo)
    return basis, coef


def group_terms(xb, zb, scale, pidx, phre, phim, cap=FUSED_CAP):
    """Group consecutive rot terms by (x, pidx, parity(x&z)), cap subterms.

    The closed form is exact because same-x equal-parity strings mutually
    commute; exact per-group lengths, no padding, and the per-term phase is
    folded into a REAL weight w_k = scale_k * (ph_k / unit) with unit = 1
    (parity even, ph in {+-1}) or i (parity odd, ph in {+-i}).  Returns
    (gx uint32, gpidx int32, gflip uint8, goff int64, zsub uint32, wsub
    float64), the JAX package's arrays; raises ValueError where a phase is
    off its unit.
    """
    gx, gpidx, gflip, goff, zflat, wflat = [], [], [], [0], [], []
    key = None
    count = 0
    for t in range(len(xb)):
        x, z = int(xb[t]), int(zb[t])
        par = (x & z).bit_count() & 1
        kt = (x, int(pidx[t]), par)
        if kt != key or count >= cap:
            gx.append(x)
            gpidx.append(int(pidx[t]))
            gflip.append(par)
            goff.append(goff[-1])
            key = kt
            count = 0
        if par == 0:
            if abs(phim[t]) >= 1e-12:
                raise ValueError(f"term {t}: even parity with an imaginary phase")
            w = float(scale[t]) * float(phre[t])
        else:
            if abs(phre[t]) >= 1e-12:
                raise ValueError(f"term {t}: odd parity with a real phase")
            w = float(scale[t]) * float(phim[t])
        zflat.append(z)
        wflat.append(w)
        goff[-1] += 1
        count += 1
    return (
        np.asarray(gx, np.uint32),
        np.asarray(gpidx, np.int32),
        np.asarray(gflip, np.uint8),
        np.asarray(goff, np.int64),
        np.asarray(zflat, np.uint32),
        np.asarray(wflat, np.float64),
    )


def fused_groups(xs, zs, pidx, phre, phim):
    """The groups of a rot term list that the float32 tile kernels run in
    closed form: ``[(t0, t1)]``, the :func:`group_terms` groups cut into
    maximal consecutive pieces whose phase masks have rank at most
    ``FUSED_MAX_RANK``, the pieces of at least ``FUSED_MIN_TERMS`` terms.
    Empty without ``pidx`` and the phases, or where a phase is off its
    unit: every term then runs alone."""
    if pidx is None or phre is None or phim is None:
        return []
    zs = np.asarray(zs, np.int64)
    try:
        goff = group_terms(xs, zs, np.ones(zs.size), pidx, phre, phim)[3].tolist()
    except ValueError:
        return []
    out = []
    for g0, g1 in zip(goff[:-1], goff[1:]):
        a = g0
        while a < g1:
            b = a + 1
            while b < g1 and len(group_basis(zs[a:b + 1])[0]) <= FUSED_MAX_RANK:
                b += 1
            if b - a >= FUSED_MIN_TERMS:
                out.append((a, b))
            a = b
    return out


def order_group_runs(gx, entries, k: int, c: int, max_entries: int, max_groups: int):
    """Order-preserving greedy partition of a float64 group program into
    tile runs, by :func:`order_tile_runs`' rule: a group joins the open run
    while the union of the run's flip bits at and above ``c`` stays within
    ``k - c`` bits, its tables within ``max_entries`` entries and the run
    within ``max_groups`` groups.  Returns ``[(g0, g1, hi)]``, or None when
    a group fits no tile (its own flip bits or tables too many)."""
    low = (1 << c) - 1
    runs: list = []
    for g, (x, e) in enumerate(zip(np.asarray(gx, np.int64).tolist(), entries)):
        h = x & ~low
        if bin(h).count("1") > k - c or e > max_entries:
            return None
        if runs:
            g0, _, hi, used = runs[-1]
            if (g - g0 < max_groups and used + e <= max_entries
                    and bin(hi | h).count("1") <= k - c):
                runs[-1] = [g0, g + 1, hi | h, used + e]
                continue
        runs.append([g, g + 1, h, e])
    return [(g0, g1, hi) for g0, g1, hi, _ in runs]


class Group64Runs:
    """Tile runs of a float64 group program (``native.statevec``), in the
    tables ``rot64_resident`` / ``adjoint64_resident`` read.

    Run ``r`` covers groups ``[run_start[r], run_start[r + 1])``; its tile
    is the flat bit set ``run_mask[r]`` (the low ``c`` bits and ``k - c``
    others), tile coordinate bit j being the j-th lowest bit of the set.
    Group g's phase masks have the basis ``zb[bstart[g]:bstart[g + 1]]``
    (:func:`group_basis`; rank R_g), term t the coefficient mask
    ``csub[t]``; its tables hold ``max(2, 2^R_g)`` entries from
    ``toff[g]`` (entry q: r = sum_k w_k (1 - 2 parity(q & csub_k)), summed
    in term order), ``tgroup`` names each entry's group.  Per group, in
    its run's tile coordinates: the flip mask ``xt`` and the basis ``zbt``;
    ``pxor`` (bit j = parity(x & zb_j)) maps a pattern to its partner's
    (all ones where the group's unit is i, else 0).  The kernels read a
    record per group, ``grec`` (``RESIDENT64_RECORD`` words: xt, pxor, the
    table's base in its run's tables, rank, zbt and zb padded to 8 each).
    A run holds at most ``max_groups`` groups and ``max_entries`` table
    entries, the latter cut to :func:`resident64_run_entries` (the kernels
    stage the next run beside the current one).  Raises ValueError where a
    group fits no tile (:func:`group_runs_fit`).
    """

    def __init__(self, gx, goff, zsub, n: int, k: int, c: int,
                 max_entries: int = RESIDENT64_RUN_ENTRIES,
                 max_groups: int = RESIDENT64_RUN_GROUPS):
        self.n, self.k, self.c = n, k, c
        self.gx = np.asarray(gx, np.int64)
        goff = np.asarray(goff, np.int64)
        zsub = np.asarray(zsub, np.int64)
        zb, bstart, csub, pxor, entries = [], [0], [], [], []
        for g, x in enumerate(self.gx.tolist()):
            basis, coef = group_basis(zsub[goff[g]:goff[g + 1]])
            zb.extend(basis)
            bstart.append(len(zb))
            csub.extend(coef)
            pxor.append(sum((bin(x & z).count("1") & 1) << j for j, z in enumerate(basis)))
            entries.append(max(2, 1 << len(basis)))
        max_entries = min(max_entries, resident64_run_entries(k, max_groups))
        runs = order_group_runs(self.gx, entries, k, c, max_entries, max_groups)
        if n < k or runs is None:
            raise ValueError(f"a group of the program fits no {k}-bit tile of {n} qubits")
        i32 = lambda a: np.asarray(a, np.int64).astype(np.int32)  # noqa: E731
        self.zb, self.bstart, self.csub, self.pxor = i32(zb), i32(bstart), i32(csub), i32(pxor)
        self.toff = i32(np.concatenate([[0], np.cumsum(entries)]))
        self.tgroup = i32(np.repeat(np.arange(len(entries)), entries))
        self.run_start = i32([g0 for g0, _, _ in runs] + [len(self.gx)])
        self.run_mask = i32([_pad((1 << c) - 1 | hi, k, range(c, n)) for _, _, hi in runs])
        self._place()

    def _place(self):
        """The tile coordinates of every group from ``run_mask``."""
        xt, zbt = np.zeros_like(self.gx), np.zeros(len(self.zb), np.int64)
        for r, mask in enumerate(self.run_mask.tolist()):
            g0, g1 = self.run_start[r], self.run_start[r + 1]
            pos = _positions(mask)
            xt[g0:g1] = pext(self.gx[g0:g1], pos)
            b0, b1 = self.bstart[g0], self.bstart[g1]
            zbt[b0:b1] = pext(self.zb[b0:b1], pos)
        self.xt, self.zbt = xt.astype(np.int32), zbt.astype(np.int32)
        rec = np.zeros((self.n_groups, RESIDENT64_RECORD), np.int64)
        rank = np.diff(self.bstart)
        run_of = np.repeat(np.arange(len(self)), np.diff(self.run_start))
        rec[:, 0], rec[:, 1], rec[:, 3] = self.xt, self.pxor, rank
        rec[:, 2] = self.toff[:-1] - self.toff[self.run_start[run_of]]
        for g in range(self.n_groups):
            b0, b1 = self.bstart[g], self.bstart[g + 1]
            rec[g, 4:4 + b1 - b0] = self.zbt[b0:b1]
            rec[g, 12:12 + b1 - b0] = self.zb[b0:b1]
        self.grec = rec.astype(np.int32)
        self._cache = {}

    def __len__(self):
        """The number of runs (state passes of one launch)."""
        return int(self.run_mask.size)

    @property
    def n_groups(self) -> int:
        return int(self.gx.size)

    @property
    def n_entries(self) -> int:
        return int(self.toff[-1])

    @property
    def most_entries(self) -> int:
        """The table entries of the largest run (shared memory)."""
        return int(np.diff(self.toff[self.run_start]).max())

    @property
    def most_groups(self) -> int:
        return int(np.diff(self.run_start).max())

    def group_mask(self) -> np.ndarray:
        """Each group's tile bit set (its run's)."""
        return np.repeat(self.run_mask.astype(np.int64), np.diff(self.run_start))

    def check(self, name: str):
        """Raise unless the runs cover the groups in order and every flip
        mask lies inside its run's tile."""
        starts = np.diff(self.run_start)
        if self.run_start[0] != 0 or self.run_start[-1] != self.n_groups or (starts < 1).any():
            raise ValueError(f"{name}: the runs do not cover the groups in order")
        bad = np.flatnonzero(self.gx & ~self.group_mask())
        if bad.size:
            raise ValueError(f"{name}: group {int(bad[0])} flips bits outside its run's tile")

    def tensors(self, device):
        """(run_start, run_mask, grec, toff, tgroup, csub) as int32 tensors
        on ``device``, built once per device."""
        key = str(device)
        if key not in self._cache:
            self._cache[key] = tuple(
                torch.as_tensor(a, device=device)
                for a in (self.run_start, self.run_mask, self.grec, self.toff, self.tgroup,
                          self.csub))
        return self._cache[key]


def resident64_threads(k: int) -> int:
    """Threads of a float64 resident block at tiles of k bits:
    ``RESIDENT64_THREADS`` capped at the tile's pairs, and at least an
    eighth of its slots (a thread copies at most 8)."""
    return max(min(RESIDENT64_THREADS, 1 << (k - 1)), 1 << (k - 3))


def resident64_smem(adjoint: bool, k: int, most_entries: int, most_groups: int) -> int:
    """Bytes of shared memory a float64 resident block takes at tiles of k
    bits for a largest run of ``most_entries`` table entries and
    ``most_groups`` groups (the kernels' ``Res64Smem``): its tile (psi and
    lam for the adjoint), two stage buffers (a 16-byte header, the group
    records, the cos and sin table planes, and r for the adjoint), the
    groups' outer patterns and the adjoint's per-warp sums."""
    planes = 3 if adjoint else 2
    buffer = 16 + 4 * RESIDENT64_RECORD * most_groups + 8 * planes * most_entries
    patterns = -(-4 * most_groups // 16) * 16
    sums = 8 * (resident64_threads(k) // 32) * most_groups if adjoint else 0
    return ((2 if adjoint else 1) << (k + 4)) + 2 * buffer + patterns + sums


def resident64_run_entries(k: int, max_groups: int = RESIDENT64_RUN_GROUPS) -> int:
    """The table entries a run at tiles of k bits may hold:
    ``RESIDENT64_RUN_ENTRIES``, or, where the adjoint's block (the larger)
    would then pass ``RESIDENT64_SMEM``, what each of its two stage buffers
    holds of the room its tiles, patterns and sums leave (an even count)."""
    spare = RESIDENT64_SMEM - resident64_smem(True, k, 0, max_groups)
    return min(RESIDENT64_RUN_ENTRIES, spare // (2 * 8 * 3) // 2 * 2)


def group_runs_fit(gx, n: int, k: int, c: int) -> bool:
    """Whether a program of flip masks ``gx`` takes the resident route at
    tiles of k bits (the low c flat bits): n >= k and every group's flip
    bits above c fit k - c bits (the tables of a group, at most 256
    entries, always fit a run)."""
    low = (1 << c) - 1
    return n >= k and all(bin(x & ~low).count("1") <= k - c
                          for x in np.asarray(gx, np.int64).tolist())


def group_by_x(xs, max_terms: int = 0):
    """Stable grouping of a term list by flip mask: ``(order, starts)``.

    Groups are ordered by the first appearance of their mask and keep
    their terms in input order; with ``max_terms``, a larger group is split
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


def cover_masks(hi, counts, room: int, most: int):
    """Greedy cover of mask pieces by tiles: ``[(bits, [piece ids])]``.

    ``hi`` holds each piece's bits outside the tile's fixed low bits,
    ``counts`` its weight (items); a tile has ``room`` chosen bits and at
    most ``most`` weight.  A tile grows by the piece whose bits, joined to
    the tile's, cover the most open pieces (then the fewest bits, then the
    first piece), and takes every open piece inside its bits while the
    weight allows.  Every piece must fit (at most ``room`` bits in ``hi``,
    ``counts <= most``).
    """
    hi = np.asarray(hi, np.int64)
    counts = np.asarray(counts, np.int64)
    open_ = np.ones(hi.size, bool)
    tiles = []
    while open_.any():
        bits, weight, members = 0, 0, []
        while True:
            cand = np.nonzero(open_ & (weight + counts <= most))[0]
            joined = bits | hi[cand]
            ok = np.bitwise_count(joined) <= room
            cand, joined = cand[ok], joined[ok]
            if not cand.size:
                break
            inside = (hi[open_][None, :] & ~joined[:, None]) == 0
            best = np.lexsort((cand, np.bitwise_count(joined), -inside.sum(1)))[0]
            bits = int(joined[best])
            first = int(cand[best])
            for p in [first] + [int(p) for p in np.nonzero(open_ & ((hi & ~bits) == 0))[0]]:
                if open_[p] and weight + counts[p] <= most:
                    weight += int(counts[p])
                    open_[p] = False
                    members.append(p)
        tiles.append((bits, members))
    return tiles


def inner_column(b: int) -> int:
    """Where tile bit ``b`` of an inner-product tile lands in shared memory:
    slot t sits at the XOR of the columns of its set bits (the
    ``INNER_SWIZZLE`` fold into the low 4 bits)."""
    return (1 << b) ^ (INNER_SWIZZLE[b - 4] if b >= 4 else 0)


def _rank4(values) -> int:
    """Rank over GF(2) of 4-bit values."""
    rows, rank = list(values), 0
    for bit in (8, 4, 2, 1):
        pivot = next((v for v in rows if v & bit), None)
        if pivot is None:
            continue
        rows = [v ^ pivot if v & bit else v for v in rows if v != pivot]
        rank += 1
    return rank


def _lanes(free: List[int]) -> Tuple[List[int], List[int]]:
    """(lane bits, chunk bits) of an item from its free tile bits: lane
    bits 0-3 with columns that span all 16 low-nibble values when the tile
    allows (each half-warp's 64-bit loads then hit 16 distinct bank pairs,
    the least wavefronts), then one more lane bit; the rest chunk bits,
    ascending."""
    nib = [inner_column(b) & 15 for b in free]
    lanes = free[:5]
    for pick in combinations(range(len(free)), 4):
        if _rank4([nib[i] for i in pick]) == 4:
            rest = [i for i in range(len(free)) if i not in pick]
            lanes = [free[i] for i in pick] + [free[rest[0]]]
            break
    return lanes, [b for b in free if b not in lanes]


def _item_bits(x: int, zs, n: int) -> int:
    """The ``REG_BITS`` flat bits J of a flip mask x's items: x's bits, then
    the bits that, added one by one, leave the fewest classes of phase
    masks ``z & ~J`` (ties: the lowest bit)."""
    J = x
    while bin(J).count("1") < min(REG_BITS, n):
        classes = [(np.unique(zs & ~(J | 1 << b)).size, b) for b in range(n) if not J >> b & 1]
        J |= 1 << min(classes)[1]
    return J


class GroupTiles:
    """The terms of a term list (flip masks ``xs``, phase masks ``zs``) in
    items covered by tiles of chosen bits, in the tables the inner-product
    tile kernel reads.

    An item is a set of terms with one flip mask x and ``REG_BITS`` flat
    bits J containing x (x's bits first, then pads, :func:`_item_bits`)
    whose phase masks agree outside J.  Then for every slot pair (i, i ^ x)
    of a tile the item's terms differ only in the sign (-1)^(d . j), j the
    slot's bits on J and d the term's phase bits there, so the kernel sums
    conj(a[i]) s(i) psi[i ^ x] into 16 buckets by j, s(i) the sign of the
    common phase bits, and each term is a signed sum of the 16 buckets.

    Tile ``r`` is the flat bit set ``tile_mask[r]``: the low ``c`` bits
    and ``k - c`` bits chosen so that the J of each of its items lies
    inside; tile coordinate bit b is the b-th lowest bit of the set.  Tile
    r has items ``[tile_items[r], tile_items[r + 1])``; item i has
    ``item_cols[i]`` (the shared-memory columns, :func:`inner_column`, of
    its tile bits in kernel order: 5 lane bits, J, ``k - 9`` chunk bits),
    ``item_x[i] = 2^|x| - 1`` (x in J's bits), ``item_zlc[i]`` (the common
    phase bits on the lane and chunk bits, in kernel order), ``item_zout[i]
    = z & ~tile_mask`` (one sign per tile position) and the tile terms
    ``[item_start[i], item_start[i + 1])``.  Per tile term: ``term_d`` (its
    phase bits on J) and ``order`` (its input index).  Each term lies in
    exactly one item.

    A mask with more than ``REG_BITS`` bits, or with J above the low ``c``
    bits wider than ``k - c``, fits no tile: its terms (input indices
    ``spill_index``, ascending) take the per-term kernel, one pass each.

    The application tile kernel (``pauli_apply_grouped``) reads the same
    items in tile coordinates: ``item_jt`` (J's tile bits, x's first, 4
    bits each: bit m of a bucket j is tile bit ``item_jt >> 4m & 15``),
    ``item_zt`` (the common phase bits on the tile), ``item_xa`` (x on
    the tile, tile coordinates; that kernel keeps its tiles unswizzled)
    and ``item_ehi``: for each of the top ``APPLY_TOP_BITS`` tile bits,
    which a thread's register slots span, the bucket bits it sets and
    (bit 4) its phase bit, 5 bits each: the slot's index in the item's
    table of its 16 bucket coefficients and their negatives.  With
    ``diagonal`` it also gathers the x = 0 items of a tile into one
    diagonal (:meth:`_diagonals`).

    With ``inner_diagonal`` (the inner products' layout) the x = 0 terms
    form no items: they are the list's diagonal, served by the last tile
    (a tile of the low bits, with no items, where the list has no other
    terms).  Diagonal term e has input index ``order[item_start[-1] +
    e]``, its phase bits on that tile ``idiag_zin[e]`` (tile coordinates)
    and off it ``idiag_zout[e]``: v = sum over tile positions p of
    (-1)^popc(outer_p & zout) U_p[zin], U_p the Walsh-Hadamard transform
    over the tile of conj(a) psi at position p.  Its rows follow the last
    tile's terms.
    """

    def __init__(self, xs, zs, n: int, k: int, c: int, max_items: int = MAX_TILE_ITEMS,
                 diagonal: bool = True, inner_diagonal: bool = False):
        k = min(k, n)
        c = min(c, k)
        self.k, self.c = k, c
        xs, zs = np.asarray(xs, np.int64), np.asarray(zs, np.int64)
        low = (1 << c) - 1
        order, starts = group_by_x(xs)  # one group per flip mask
        pieces, spill = [], []  # pieces: (x, J, [term index arrays, one per item])
        idiag = np.zeros(0, np.int64)
        for g in range(starts.size - 1):
            idx = order[starts[g]:starts[g + 1]]
            x = int(xs[idx[0]])
            if inner_diagonal and x == 0:
                idiag = idx
            J = _item_bits(x, zs[idx], n) if bin(x).count("1") <= REG_BITS else -1
            if J < 0 or bin(J & ~low).count("1") > k - c:
                spill.append(idx)
                continue
            _, first, inv = np.unique(zs[idx] & ~J, return_index=True, return_inverse=True)
            items = [idx[inv.reshape(-1) == u] for u in np.argsort(first)]
            pieces.extend((x, J, items[i:i + max_items]) for i in range(0, len(items), max_items))
        self.spill_index = np.sort(np.concatenate(spill + [np.zeros(0, np.int64)]))
        self.spill_xs = xs[self.spill_index]
        def cover(ids):
            found = cover_masks([pieces[p][1] & ~low for p in ids],
                                [len(pieces[p][2]) for p in ids], k - c, max_items)
            return [(bits, [ids[m] for m in members]) for bits, members in found]

        if idiag.size:
            # the diagonal's x = 0 pieces take no tile: the cover of the others,
            # or the cover of all without them, whichever has fewer tiles
            diag = {p for p, (x, _, _) in enumerate(pieces) if x == 0}
            alone = cover([p for p in range(len(pieces)) if p not in diag])
            within = [(bits, [p for p in members if p not in diag])
                      for bits, members in cover(list(range(len(pieces))))]
            within = [t for t in within if t[1]]
            tiles = within if len(within) < len(alone) else alone
        else:
            tiles = cover(list(range(len(pieces))))
        tiles.sort(key=lambda t: -sum(len(pieces[p][2]) for p in t[1]))  # the heaviest first
        if idiag.size and not tiles:
            tiles = [(0, [])]  # the diagonal's tile: the low bits
        tile_mask, tile_items, item_start = [], [0], [0]
        item_cols, item_x, item_zlc, item_zout, term_d, t_order = [], [], [], [], [], []
        item_jt, item_zt, item_xa, item_ehi = [], [], [], []
        for bits, members in tiles:
            mask = _pad(low | bits, k, range(c, n))
            pos = _positions(mask)
            tile_mask.append(mask)
            for x, J, items in (pieces[p] for p in members):
                jt = sorted(pos.index(b) for b in _positions(x))
                jt += sorted(pos.index(b) for b in _positions(J & ~x))
                lanes, chunks = _lanes([b for b in range(k) if b not in jt])
                l9 = lanes + chunks
                cols = [inner_column(b) for b in lanes + jt + chunks]
                xa = 0
                for b in jt[:bin(x).count("1")]:
                    xa |= 1 << b
                for idx in items:
                    zc = int(zs[idx[0]]) & ~J
                    zt = int(pext([zc], pos)[0])
                    item_cols.append(cols + [0] * (16 - k))
                    item_x.append((1 << bin(x).count("1")) - 1)
                    item_zlc.append(int(pext([zc], [pos[b] for b in l9])[0]))
                    item_zout.append(zc & ~mask)
                    item_jt.append(sum(b << (4 * m) for m, b in enumerate(jt)))
                    item_zt.append(zt)
                    item_xa.append(xa)
                    ehi = 0
                    for tb in range(max(k - APPLY_TOP_BITS, 0), k):
                        e = sum(1 << m for m, b in enumerate(jt) if b == tb)
                        ehi |= (e | (zt >> tb & 1) << 4) << (5 * (tb - k + APPLY_TOP_BITS))
                    item_ehi.append(ehi)
                    term_d.extend(pext(zs[idx], [pos[b] for b in jt]).tolist())
                    t_order.extend(idx.tolist())
                    item_start.append(len(t_order))
            tile_items.append(len(item_x))
        i32 = lambda a: np.asarray(a, np.int64).astype(np.int32).reshape(-1)  # noqa: E731
        self.tile_mask, self.tile_items = i32(tile_mask), i32(tile_items)
        self.item_start = i32(item_start)
        self.item_cols = i32(item_cols).reshape(-1, 16)
        self.item_x, self.item_zlc, self.item_zout = i32(item_x), i32(item_zlc), i32(item_zout)
        self.term_d, self.order = i32(term_d), np.asarray(t_order, np.int64)
        self.item_jt, self.item_zt = i32(item_jt), i32(item_zt)
        self.item_xa, self.item_ehi = i32(item_xa), i32(item_ehi)
        self._diagonals(zs, diagonal)
        last = int(tile_mask[-1]) if tile_mask else 0
        self.order = np.concatenate([self.order, idiag])
        self.idiag_zin = i32(pext(zs[idiag], _positions(last)))
        self.idiag_zout = i32(zs[idiag] & ~last)
        self.n_terms = int(xs.size)
        self._cache = {}

    def _diagonals(self, zs, diagonal: bool):
        """The application kernel's diagonals (none without ``diagonal``):
        the terms of the x = 0 items of each tile that has at least
        ``APPLY_DIAG_ITEMS`` of them, by their phase bits on the tile
        ``zin`` (tile coordinates; one entry per ``zin``, ascending).  Tile
        r has entries ``[tile_diag[r], tile_diag[r + 1])``; entry e sits at
        ``diag_zin[e]`` and sums the terms ``[diag_start[e], diag_start[e +
        1])``: input index ``diag_term``, phase bits off the tile
        ``diag_zout``, in tile order."""
        tile_diag, zin_all, start, term, zout_all = [0], [], [0], [], []
        for r in range(self.n_tiles):
            items = range(self.tile_items[r], self.tile_items[r + 1])
            diag = [it for it in items if self.item_x[it] == 0]
            if diagonal and len(diag) >= APPLY_DIAG_ITEMS:
                idx = self.order[np.concatenate(
                    [np.arange(self.item_start[it], self.item_start[it + 1]) for it in diag])]
                mask = int(self.tile_mask[r])
                zin = pext(zs[idx], _positions(mask))
                for v in np.unique(zin):
                    sel = idx[zin == v]
                    zin_all.append(int(v))
                    term.extend(sel.tolist())
                    zout_all.extend((zs[sel] & ~mask).tolist())
                    start.append(len(term))
            tile_diag.append(len(zin_all))
        i32 = lambda a: np.asarray(a, np.int64).astype(np.int32).reshape(-1)  # noqa: E731
        self.tile_diag, self.diag_zin, self.diag_start = i32(tile_diag), i32(zin_all), i32(start)
        self.diag_term, self.diag_zout = i32(term), i32(zout_all)

    def __len__(self):
        """State passes of one call: one per tile and per term of a mask
        that fits no tile."""
        return self.n_tiles + int(self.spill_index.size)

    @property
    def n_tiles(self) -> int:
        return int(self.tile_mask.size)

    @property
    def n_items(self) -> int:
        return int(self.item_x.size)

    @property
    def n_diag(self) -> int:
        """The terms of the inner products' diagonal."""
        return int(self.idiag_zin.size)

    def tile_terms(self, r: int) -> Tuple[int, int]:
        """The tile terms ``[t0, t1)`` of tile ``r`` (rows of ``order``;
        the last tile's include the diagonal's)."""
        extra = self.n_diag if r == self.n_tiles - 1 else 0
        return (int(self.item_start[self.tile_items[r]]),
                int(self.item_start[self.tile_items[r + 1]]) + extra)

    def most_items(self, r0: int, r1: int) -> int:
        """The most items of one tile among tiles ``[r0, r1)``."""
        return int(np.diff(self.tile_items[r0:r1 + 1]).max(initial=0))

    def schedule(self, n: int, sms: int, diagonal_unit: bool = False):
        """``(positions, units)`` of the inner-product tile kernel at n
        qubits on a card of ``sms`` SMs: a block takes ``positions``
        consecutive tile positions (2^(n - k) in all) of one unit; unit u
        is the row ``units[u] = (tile, first item, items, diagonal)``: a
        slice of a tile's items, or (diagonal 1, no items) the diagonal on
        the last tile.  Units go tile by tile, a tile's slices in item
        order, the diagonal last (with ``diagonal_unit`` also where the
        list has no x = 0 term: the float64 readout takes N there; its
        tile is then the last one, or the low k bits where there is none).
        Positions per block start at
        ``INNER_TILE_POSITIONS`` and items per slice at ``MAX_TILE_ITEMS``
        (a slice per tile); while the launch has fewer than
        ``INNER_BLOCKS_PER_SM`` blocks per SM, positions are halved down
        to one, then the slices down to ``INNER_SLICE_ITEMS`` items.
        Built once per (n, sms, diagonal_unit)."""
        key = ("schedule", n, sms) + (("diagonal unit",) if diagonal_unit else ())
        if key not in self._cache:
            every = 1 << (n - self.k)
            least = max(1, -(-every // INNER_MAX_SLICES))
            positions, per = max(least, min(INNER_TILE_POSITIONS, every)), MAX_TILE_ITEMS

            def units(per):
                out = []
                for r in range(self.n_tiles):
                    i0, i1 = int(self.tile_items[r]), int(self.tile_items[r + 1])
                    out += [(r, i, min(per, i1 - i), 0) for i in range(i0, i1, per)]
                if self.n_diag or diagonal_unit:
                    out.append((max(self.n_tiles - 1, 0), 0, 0, 1))
                return out

            while -(-every // positions) * len(units(per)) < INNER_BLOCKS_PER_SM * sms:
                if positions > least:
                    positions //= 2
                elif per > INNER_SLICE_ITEMS:
                    per = max(INNER_SLICE_ITEMS, per // 2)
                else:
                    break
            self._cache[key] = (positions, np.asarray(units(per), np.int32).reshape(-1, 4))
        return self._cache[key]

    def plan(self, n: int, sms: int, cap: int):
        """``(positions, width, rows, launches)`` of one inner-product call at
        n qubits on a card of ``sms`` SMs with partials of at most ``cap``
        entries: the :meth:`schedule`'s positions a block, position slices
        ``width`` (the partials' row length), the most partial ``rows`` of
        a launch, and per launch (a chunk of :meth:`chunks`) ``(u0, units,
        t0, rows, most items of a unit)``.  Built once per (n, sms, cap)."""
        key = ("plan", n, sms, cap)
        if key not in self._cache:
            positions, units = self.schedule(n, sms)
            width = -(-(1 << (n - self.k)) // positions)
            chunks = self.chunks(width, cap)
            first = np.searchsorted(units[:, 0], [r0 for r0, _ in chunks] + [self.n_tiles])
            launches = []
            for j, (r0, r1) in enumerate(chunks):
                u0, u1 = int(first[j]), int(first[j + 1])
                t0, t1 = self.tile_terms(r0)[0], self.tile_terms(r1 - 1)[1]
                launches.append((u0, u1 - u0, t0, t1 - t0, int(units[u0:u1, 2].max())))
            rows = max(nr for _, _, _, nr, _ in launches)
            self._cache[key] = (positions, width, rows, launches)
        return self._cache[key]

    def chunks(self, width: int, cap: int):
        """Consecutive tile ranges ``[(r0, r1)]`` whose (terms, width)
        partials fit ``cap`` (or one tile): one kernel launch each."""
        key = ("chunks", width, cap)
        if key not in self._cache:
            out, r0 = [], 0
            for r in range(1, self.n_tiles + 1):
                last = r == self.n_tiles
                if last or (self.tile_terms(r)[1] - self.tile_terms(r0)[0]) * width > cap:
                    out.append((r0, r))
                    r0 = r
            self._cache[key] = out
        return self._cache[key]

    def term_mask(self) -> np.ndarray:
        """The tile mask of each row of ``order`` (the diagonal's: the last
        tile's)."""
        sizes = [t1 - t0 for t0, t1 in map(self.tile_terms, range(self.n_tiles))]
        return np.repeat(self.tile_mask, sizes)

    def tensors(self, device):
        """(tile_mask, tile_items, item_cols, item_x, item_zlc, item_zout,
        item_start, term_d, order, idiag_zin, idiag_zout) as int32 tensors
        on ``device``, built once per device (an empty table as one zero,
        so that every pointer is valid)."""
        key = str(device)
        if key not in self._cache:
            self._cache[key] = tuple(
                torch.as_tensor(np.ascontiguousarray(a if a.size else np.zeros(1)).astype(np.int32),
                                device=device)
                for a in (self.tile_mask, self.tile_items, self.item_cols, self.item_x,
                          self.item_zlc, self.item_zout, self.item_start, self.term_d, self.order,
                          self.idiag_zin, self.idiag_zout)
            )
        return self._cache[key]

    def unit_tensor(self, n: int, sms: int, device, diagonal_unit: bool = False) -> torch.Tensor:
        """The units of :meth:`schedule` as an int32 tensor on ``device``."""
        key = ("units", n, sms, str(device), diagonal_unit)
        if key not in self._cache:
            self._cache[key] = torch.as_tensor(self.schedule(n, sms, diagonal_unit)[1],
                                               device=device)
        return self._cache[key]

    @property
    def diag_mask(self) -> int:
        """The tile of the list's diagonal (``idiag_zin`` is in its
        coordinates): the last tile, or the low k bits where there is none."""
        return int(self.tile_mask[-1]) if self.n_tiles else (1 << self.k) - 1

    def apply_tensors(self, device):
        """(item_jt, item_zt, item_xa, item_ehi, diag_zin, diag_start,
        diag_term, diag_zout), the application kernel's item and diagonal
        tables, as int32 tensors on ``device``, built once per device (an
        empty table as one zero, so that every pointer is valid)."""
        key = ("apply", str(device))
        if key not in self._cache:
            self._cache[key] = tuple(
                torch.as_tensor(np.ascontiguousarray(a if a.size else np.zeros(1, np.int32)),
                                device=device)
                for a in (self.item_jt, self.item_zt, self.item_xa, self.item_ehi, self.diag_zin,
                          self.diag_start, self.diag_term, self.diag_zout)
            )
        return self._cache[key]


def apply64_layout(xs, zs, n: int) -> GroupTiles:
    """The application tiles of ``happly64_tiles`` for the terms (xs, zs) at
    n qubits: 11 bits to 18 qubits, 12 above (the fastest of 10, 11 and 12
    at 18, 20 and 24 qubits), the low ``APPLY64_TILE_LOW_BITS`` flat."""
    return GroupTiles(xs, zs, n, 11 if n <= 18 else 12, APPLY64_TILE_LOW_BITS)
