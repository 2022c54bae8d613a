#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``qsfh_torch``) on one CUDA card.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py [--out results.json] [--profile] [--routes] [--tiles] [--sweeps]

Phases (any failed check raises and the script exits nonzero):

1. Card and build: torch version, device name, ``nvidia-smi`` name and
   power limit; build the CUDA kernels from ``qsfh_torch/csrc/``.
2. Kernels at n = 18 on the real 3x3 term arrays: each kernel against its
   plain PyTorch version on the same inputs (||kernel - plain|| /
   ||plain|| <= 1e-5, float32 rounding), timed with CUDA events after
   warm-up, with its bound: max(bytes / 3.35 TB/s, float32 flops /
   67 TFLOP/s), H100 SXM published peaks.  The resident kernels (the main
   path's rotations and adjoint sweep, one launch per span of tile runs)
   also on a grid of fewer blocks than a run has tiles, where they must
   give the same bits, and twice on the same inputs (the adjoint: the same
   bits), each timed beside the same runs as one launch each (the
   tile-run kernels); then at n = 20 on the same terms (the chain cap's
   other candidate).  H psi through the application tiles
   (``pauli_apply_grouped``, the engine's route) twice (the same bits),
   timed in turns with the per-term ``pauli_apply`` on the same inputs.
   The engine's inner products through the folded inner-product tiles
   (``expectation_grouped`` on H, Sz on a tilted state and S^2,
   ``screen_grouped`` on the pool) twice (the same bits), within 1e-5 of
   the plain result or of sum_t |c_t| ||a|| ||psi||, timed in turns with
   the per-term ``pauli_inner`` folded in torch, each with its device and
   host ms per call.
3. Main path: ``qsfh_torch.algos.adapt.ADAPT`` on the 3x3 Hubbard lattice
   (t=1, U=6, 5 up / 4 down, complex64 on cuda) with the exact 4-state
   ground manifold read from the committed cache: one operator selection
   from the empty ansatz, 5 train steps of the 12-operator ansatz
   (theta = 0.05, Adam lr 1e-2) and one short ``run()``, with every launch
   counter set to 0 just before and read just after each, the selection's
   and the steps' counts held to the resident and inner tile layouts (1
   resident rotation and 1 resident adjoint per step, 2 resident rotations
   per selection, one ``pauli_apply_grouped`` launch per tile of H for
   each H psi, one ``expectation_grouped`` launch for each of E, Sz and
   S^2, one ``screen_grouped`` launch per selection, no per-term rotation
   or inner product, no stream kernel).  The same selection
   and steps then run through the plain versions on the card: energy,
   gnorm, Sz, S^2 and fidelity agree at every step (``STEP_TOLERANCES``),
   the pool gradients within 1e-4 of max |grad|, and the selected
   operators as a set (unless a tie sits within that tolerance).
4. Kernels at n = 24 on the real 2x6 term arrays (the first 6 pool
   operators and the Givens network): the stream route (tile runs, the
   folded inner-product tiles) against the plain versions on the same
   inputs (1e-5 relative), timed beside its bound, the plain versions and
   the old per-term route on the same inputs, with the launches and state
   passes of each call.  H, S^2 and the pool run on the main path's state;
   Sz and S^2 also on a tilted state whose <Z_q> do not cancel.  H psi
   through the application tiles (twice: the same bits), timed in turns
   with the per-term ``pauli_apply``, and as one ``torch.mv`` with a CSR
   H (a yardstick).
5. 24-qubit main path: ``ADAPT`` on 2x6 (t=1, U=6, 6 up / 6 down,
   ``ground_truth=False``): one selection from the empty ansatz and 5
   train steps of the first 6 pool operators, with every launch counter
   set to 0 just before and read just after and held to the counts the
   tile and inner-tile layouts predict (no per-term rotation: every term
   fits a tile; no per-term inner product or application: every flip
   mask fits an inner tile); then one selection and 2 steps through the
   plain versions:
   gradients within 1e-4 of max |grad|, the same selected set unless a tie
   sits within that tolerance, energy, gnorm and S^2 within 1e-4
   relative, Sz within 1e-4 of 0.
6. ``xor_gather`` and the one-term rotation ``pauli_rotation_one``
   (``pauli_rotation_out``; TPU kernels off every path) at 18 and 24
   qubits against their plain versions (exact for the gather, 1e-5 for
   the rotation), timed beside their bound, the rotation in turns with the
   gather (the same bytes), the gather in turns with
   ``torch.index_select`` with a prebuilt index, each split into host,
   wall and device ms per call.
7. The float64 Rayleigh readout on the 3x3 and 2x6 main paths' states:
   ``expectation_norm_f64_tiles`` (the inner-product tiles, the route of
   ``expectation_norm_df`` from 9 qubits on) and ``expectation_norm_f64``
   (per term) against their plain version (the state upcast to complex128;
   the Rayleigh quotient and N within 1e-12 relative, the same bits on two
   calls, one launch a call), a planted fault (one item's coefficient
   dropped) that the tile gate must fail, the gap to the float32
   ``expectation_grouped`` energy, both timed in turns (CUDA events, and in
   a CUDA graph) beside the bound (bytes at 3.35 TB/s, float64 operations
   at 34 TFLOP/s: the least of either design), the plain version and a
   library yardstick (the state upcast, a complex128 CSR ``torch.mv`` and
   ``torch.vdot``); H psi of the 2x6 state upcast to complex128 (24
   qubits, ``happly64_tiles`` and ``happly64``: H psi within 1e-11 relative,
   E within 1e-11 of the plain version, the same bits on two calls, in
   turns, a planted fault); the 3x3 H with a term on
   a 5-bit mask (it fits no tile) through both tile kernels, the spilled
   term through the per-term kernels; at 10, 12, 14 and 16 qubits (the 1x5,
   2x3, 1x7, 2x4 H on a seeded state) both readouts and both H psi kernels
   against their plain versions and in turns (CUDA events and CUDA graph
   replays), beside the route the code takes there
   (``kernels.F64_TILE_MIN_QUBITS``).
8. The fused runner (``qsfh_torch.algos.adapt_fused.FusedAdaptRunner``) at
   3x3 on the 12-operator ansatz, on the CUDA graph path: captures of K =
   1, 10 and 100 train steps (capture ms, graph-pool memory, whether the
   cooperative launches captured, launches counted per capture and its
   warm-up step: graph nodes per step); two replays of K = 10 against 20
   eager ``ADAPT`` steps (``STEP_TOLERANCES``: energy, gnorm), no wrapper
   launch during a replay; the chunk's float64 energy within 1e-10 of the
   plain complex128 Rayleigh quotient of the graph's final state; ms per
   step at K = 1, 10, 100 in turns with the eager step (host clock), with
   the idle share of a replay (``torch.profiler``); a one-epoch ``run()``
   stopped after its first chunk and resumed from the in-flight file: the
   same selection, the resumed chunk within tolerance of the run's.  At
   2x6: captures of K = 1, 2 and 8, one replay of K = 2 against 2 eager
   steps (``STEP_TOLERANCES_24``), ms per step at K = 2 and 8.
9. The port's exact diagonalization of the 3x3 4-state ground manifold on
   the card (the sector Lanczos in complex128): energy within 1e-10 of the
   committed cache's, subspace fidelity within 1e-10 of 1, and its seconds
   beside the host solve's (16.5-21.2 s, PERF.md section 6).
10. The HVA driver (``qsfh_torch.algos.hva.HVA``), the reference's
   ``hva_for_3x3.py`` experiment: 3x3, reps = 10 (1017 rotation terms, 71
   parameters; 297 of the terms the trainable x = 0 Z/ZZ strings of the
   Coulomb layers), complex64, the 4-state manifold from the committed
   cache, theta ~ normal(0, 0.05) from ``default_rng(11)``: 5 train steps
   with every launch counter set to 0 just before and read just after
   each, held to the layouts (1 ``rotation_resident`` and 1
   ``adjoint_resident``, one ``pauli_apply_grouped`` per tile of H, the
   ``expectation_grouped`` launches of E, Sz and S^2, no per-term
   kernel); the same steps on the plain versions (``STEP_TOLERANCES``)
   and one step's gradients within 1e-4 of max |g|; a ``run()`` of 2
   epochs resumed from its checkpoint to 3 against the same driver
   carried on in process; the unrolled lowering (autograd through the
   gates) against the split one at reps = 2 (energy 1e-5 relative,
   gradients 1e-4 of max |g|); 2x6, reps = 2 (252 terms, 9 parameters,
   ``ground_truth=False``): 2 steps on the tile runs, launches held to the
   layouts, the first against one plain step, its gradients within 1e-4
   of max |g|.
11. The iQCC driver (``qsfh_torch.algos.iqcc.IQCC``), complex64 states
   and float32 parameters, every launch counter set to 0 just before and
   read just after each run: (a) the 2x3 dense-exact iQCC-ILC campaign
   (``benchmarks/demo_iqcc_2x3_r4/run_ilc.py``'s arguments: U = 4,
   L-BFGS, ``ilc_cap=48``, ``ilc_rounds=3``) from scratch, cut to 3
   epochs of at most 150 inner iterations: per epoch the selection, DIS
   size, nnz, energy and its error to the exact -6.332962199384616, ms
   per inner step, of the DIS, the U passes, the ZGEMM pair and each ILC
   fold; every dressed matrix (after each dressing and fold) keeps the
   lowest eigenvalue within 1e-9 and the Frobenius norm within 1e-10
   relative, each fold's predicted energy is <psi|H_folded|psi> within
   1e-10; (b) LiH r = 0.8 (the reference's ``iqcc.py:207-213``: Adam,
   threshold 1e-2, symbolic dressing, FCI from the port's Lanczos), cut
   to 2 epochs of at most 150: H terms, layout build, dressing and step
   ms; (c) 2x2 (``iqcc_hubbard.py:215-231``), 3 epochs, the per-term
   kernels, its epoch energies within 1e-4 relative of the same run on
   the plain versions.  At 12 qubits each holds one loss and gradient
   evaluation on the epoch-2 segment (the trained parameters with tau
   moved off the minimum) against the plain path (E 1e-4 relative, tau,
   theta and phi gradients within 1e-4 of the largest |g|), and times
   the segment's rotation kernels and, on LiH's dressed H, E, the DIS
   screen and H psi against their plain versions.
12. Product states at 26, 28 and 30 qubits (the 1x13, 2x7 and 3x5
   lattices of ``benchmarks/tpu_stream_big.py``, t=1, U=6; angles from
   ``default_rng(n)``): the state built on the card
   (``engine.product_state``), then against float64 closed forms on the
   host: E of H (``expectation_grouped``) and |psi|^2 within 1e-4
   relative; 8 seeded hopping-like rotations on ``rotation_tile_runs``,
   the rotated E against the dressed closed form; their gradients from
   ``adjoint_tile_runs`` with lambda = 2 H psi (``pauli_apply_grouped``)
   within 1e-3 of max |g| of central differences; the ADAPT pool's screen
   (``screen_grouped``) between psi and a product state w that differs
   from it on 3 qubits (so the values are O(|c|)) within 1e-4 of the
   largest, and <phi|H psi> (``pauli_apply_grouped``) within 1e-4
   relative.  Launch counters set to 0 just before and read just after
   each size; ms per call beside the bound, the peak memory; then planted
   faults (a screen of zeros, psi with its upper half dropped) that the
   screen and <phi|H psi> checks must fail.
13. The HEA driver (``qsfh_torch.algos.hea.VQE``, one rot segment): H2 r =
   0.8, reps = 5, lr 0.1 (the reference configuration; the per-term
   kernels) and LiH (12 qubits; the resident kernels), 20 steps each with
   the launches of every step, energy and gnorm within 1e-4 relative of
   the unrolled plain path (autograd through the gates); H2's ``run()``
   to its threshold, the distance to FCI printed; a profile of the LiH
   step (device kernel time, idle share).
14. VQD (``qsfh_torch.algos.vqd.VQD``): H2 3 levels (reps 3, beta 5, 500
   epochs, ``benchmarks/demo_vqd_h2/run.py``) within 1e-3 Ha of the dense
   spectrum; LiH 2 levels of 20 steps, the kernels against the plain
   versions (histories within 1e-4 relative).
15. Trotter dynamics (``qsfh_torch.algos.dynamics.TrotterEvolution``): the
   3x3 Neel quench of ``benchmarks/tpu_dynamics.py`` (U = 4, dt = 0.05,
   Strang, 15 steps, one ``rotation_resident`` launch a step): double
   occupancy within 1e-3 relative of ``benchmarks/dynamics_expected.json``,
   <H> drift as its sanity check, the final state within 1e-4 of the plain
   path; ms per step (CUDA events around host-launched steps), a profile
   of 20 steps (device kernel time, idle share) and 20 steps in a CUDA
   graph (the device's time with no host between launches).
16. Imaginary-time evolution (``qsfh_torch.algos.ite``): 3x3, dbeta =
   0.01, order 2, from the seed-19 state of ``benchmarks/tpu_ite.py``: the
   first 4 energies and variances within 1e-3 of
   ``benchmarks/ite_expected.json``, then 300 steps in blocks of 50 (ms per
   step; 2 H psi a step, one ``pauli_apply_grouped`` launch per tile), a
   profile of 50 steps and 50 steps in a CUDA graph.
17. The 3x3 analysis scripts' paths (``benchmarks/correlations_3x3.py``,
   ``observables_3x3.py``, ``irrep_analysis_3x3.py``) on the committed
   checkpoints, loaded with the port's ``load_model`` (ADAPT: 1719
   operators of the extended pool; HVA reps = 10), the states normalised:
   the spin correlation matrix, rho per spin and the pair matrix on the
   kernel route (each matrix one ``pauli_inner_grouped`` layout: the
   launches held to it) within 1e-5 of the largest entry of the complex128
   per-entry plain loop on the same state, trace rho_up = 5 and rho_dn = 4
   within 1e-5, the entropies within 1e-5; the irrep seed norms and the
   HVA irrep weights against the committed JSON (the ADAPT JSONs came
   from an older checkpoint: printed, not gated); ms and launches per
   matrix beside the per-entry loops; a planted fault (the entry index
   shifted by one) that must fail.
18. ``benchmarks/spectral_3x3.py`` (9 k-points x 2 branches, m = 80) and
   ``sqw_3x3.py`` (spin, 9 q-points) from the ED cache's manifold[0]
   through ``linalg.spectral`` (H psi on ``pauli_apply_grouped``): the sum
   rules against the kernel-route n_k and static correlator (1e-5), the
   band edges against ``spectral.json`` (2e-3), the S^zz weights against
   ``sqw.json`` (1e-5), A(omega) of the first 10 Lanczos levels against
   the complex128 plain Lanczos (2e-2 of the largest value; all 80
   levels logged); ms per Lanczos step and H psi's share; a zeroed H psi
   that must fail.
19. ``benchmarks/demo_multistart/run.py`` in full (2x2, B = 16, 400
   epochs on the per-term kernels): the best start one of the JSON's
   starts that end within 1e-6 of its best (3, 7 and 15, 7.3e-9 apart in
   float64: float32 cannot order them) and its energy within 1e-5 of the
   ED energy; a 3x3 reps = 10 ``MultistartHVA`` and a LiH
   ``MultistartHEA`` at B = 4, each start's trajectory within 1e-4
   relative of a single-start ``HVA`` / ``VQE`` from its angles; ms and
   launches per epoch; planted faults (the saddle's zero-init start as
   the best, the starts' rows rotated by one) that must fail.
20. ``benchmarks/tpu_sampling.py``'s configuration (3x3 H, 32 QWC groups,
   2048 shots, a default_rng(13) state): the analytic E
   (``expectation_grouped``) against ``sampling_expected.json`` (1e-5),
   the estimate within 5 sigma, the determinism probe, ms per grouped
   estimate; on the ED ground state the estimate within 5 sigma and a
   planted fault (the basis change skipped) that must fail.
21. The command line, ``qsfh_torch.cli.main`` in-process on the card:
   ``adapt`` at 3x3 at full width (2 epochs of 20 inner iterations, no ED
   cache: the 4-state manifold solved on the card, within 1e-10 of the
   committed cache; launch counters set to 0 just before and read just
   after, TPU kernels 1-5 launched and no plain version called; its
   selections, energies and fidelities equal to the same ADAPT built
   through the Python API, a float32 tie in the screen logged and either
   side accepted); ``ed`` at 2x6 (24 qubits, 853,776 sector rows: host
   build, entries, card Krylov seconds, peak memory, E to 12 digits; the
   state put back into complex64 and checked through the 24-qubit kernels:
   ||H psi - E psi|| / sum|c| within 1e-6 on ``pauli_apply_grouped``, the
   Rayleigh quotient within 1e-5 relative on ``expectation_grouped``, N = 12
   and Sz = 0 within 1e-5, no weight outside the sector, E below every 2x6
   variational energy of the earlier phases; a planted fault, the Ritz
   vector of 8 Krylov steps, that the residual gate must fail); then
   ``hva``, ``hea``, ``vqd``, ``iqcc --molecule LiH``, ``dynamics
   --initial neel``, ``ite``, ``symmetry``, ``spectral`` and
   ``multistart`` (2x2, H2, LiH), each printed value or JSON file against
   the same call through the Python API, and ``python -m qsfh_torch.cli
   ed`` (2x2) in a process of its own.
22. The float64 polish engine (``qsfh_torch.native.statevec.Rot64Program``;
   on its resident route ``rot64_resident`` and ``adjoint64_resident``, one
   cooperative launch a pass over 521 tile runs, and ``happly64_tiles``, H
   in 2 application tiles, one launch each; the
   per-group route ``rot64_groups`` / ``adjoint64_groups``, one launch per
   group, beside it as the yardstick) on the committed 3x3 ADAPT checkpoint (1719 operators
   of the extended pool, loaded with ``load_model`` in complex128), the path
   of ``benchmarks/demo_3x3/polish_fast.py``: (a) the grouped program is
   the JAX package's (18 qubits, 1931 groups of 14123 terms: 1721 of 8, 145
   of 2, 65 of 1; 68 diagonal, 212 static; H 100 terms); (b) E within 1e-10
   and ||g|| within 1e-9 of the JAX package's records at the checkpoint,
   E within 1e-10 at ``polish_fast_best.npz``; (c) at the checkpoint and
   at a default_rng(5) step of 0.01 from it, the kernels against the plain
   complex128 versions (state 1e-11, H psi 1e-11 relative, E 1e-11,
   gradient 1e-10), two calls the same bits, central differences (1e-7),
   a symmetric HVP (1e-6); the resident route against the per-group route
   in the same call (state 1e-15 relative, its bits compared; gradient
   1e-13 of max |g|), both resident kernels on a grid of 37 blocks the
   same bits; (d) two planted faults: the static groups' angle 0, that (b)
   must fail, and a layout whose run misses a flip bit of one of its
   groups (built past the constructor's check), that (c) must fail, and H
   without one item's coefficient, that the H psi gate must fail; (e)
   L-BFGS-B as the script runs it, cut at 674
   evaluations: evaluations 1-10 within 1e-9 of ``polish_fast.jsonl``, the
   first parting printed, the best E below -5.562290; (f) Newton-CG on
   central-difference HVPs, time-boxed to 20 s, never above its start, its
   gap to ED in uHa; then the same L-BFGS-B on the per-group route (its
   seconds beside the resident route's); (g) ms per apply, h_apply,
   value_and_grad and hvp on both routes in turns and per wrapper call
   against the plain versions and the bounds (bytes at 3.35 TB/s, float64
   at 34 TFLOP/s), launches per call, the idle share of 3 evaluations on
   each route (``torch.profiler``), H psi in turns on ``happly64`` and
   ``happly64_tiles`` (CUDA events and CUDA graph replays), a complex128
   CSR ``torch.mv`` as H psi's library yardstick,
   the resident route's ms at other
   tile shapes (``POLISH_TILE_SHAPES``), and the cost of a run (each
   resident kernel on layouts of 1, 2, 4 groups a run at most and the
   shipped cap: a line through (runs, ms)).  The launch counters are set to 0
   just before the polish run and read just after: one resident launch
   each way and the ``happly64_tiles`` launches of its H layout an
   evaluation (``Rot64Program.h_launches``; the tables and the folds inside
   the launches), no per-group and no per-term H launch.  The best point goes to the
   run's temporary directory.
23. The amplitude-sharded engine (``qsfh_torch.parallel``), after the
   optional phases: ``ADAPT(mesh_devices=D)`` on D ranks started by
   ``parallel.spawn_ranks``, all on this one card, their exchanges and
   rank-order sums over gloo staged through the host (no NVLink or NCCL
   time): 3x3 at D = 2 and 4 (the 12-operator bench ansatz, 2 selections
   and 5 steps) and 2x6 at D = 2 (23 local qubits: the tile runs; 2
   selections and 2 steps), with the launch, exchange, byte and staging
   counters set to 0 just before and read just after on every rank: each
   configuration's kernels launched on every rank, the exchanges a step
   those its rotation runs predict; against the single-card path on the
   same configuration (``mesh_reference``): steps within
   ``STEP_TOLERANCES`` (2x6: ``_24``), the gradients at theta = 0.05
   within 1e-4 of max |g|, the pool gradients and selection as
   ``check_selection``; thetas, gradients and pool gradients the same bits
   on every rank; the peak device memory of each rank and of the single
   card over the selections and over the steps; rank 0's kernels held to
   their plain versions over a step and the selection from the trained
   ansatz (psi_k no basis state); a planted fault (the observable's
   exchanges with rank d ^ m ^ 1, swapped in on its engine) the energy gate
   must fail; ``expectation_partner`` at 17
   and 23 local qubits on rank 0's shard of the H's cross terms and three
   x_lo = 0 terms against its plain version, timed beside its bound.
   ``--mesh-only`` runs the card phase and this one alone.
24. A ``kernels`` JSON line (the readouts' launches counted
   per capture, its replays beside them; every kernel's graph nodes per
   fused step; its launches on the HVA, iQCC, product-state, HEA, VQD,
   Trotter, ITE, analysis, Lanczos, multistart and sampling paths; ms and
   bound at 26-30 qubits and per correlation matrix; the launches of the
   CLI's 3x3 adapt run and of the 2x6 ED's checks, and of the float64
   polish run, where the six float64 kernels report theirs; the old
   ``expectation_norm_f64`` and ``happly64`` beside the tile kernels that
   redesign them, with their launches on the spilled-mask H; the partner
   form ``expectation_partner``, and every kernel's launches on the sharded
   path), then the device JSON line, last.

``--compare PARENT`` runs both main paths (3x3 and 2x6 selection and
train step, host clock and profile) of the port in the checkout PARENT
(loaded under another name) and of this one in one process, in rounds
of parent, change, change, parent.

``--sweeps`` runs phase 1 and then only the resident sweeps: float64
(``rot64_resident``, ``adjoint64_resident``) on the 1719-operator 3x3
checkpoint's polish program (521 runs) and on its runs cut to one group
each (a run's fixed cost), each result against the plain version and
against ``rot64_groups`` / ``adjoint64_groups``; float32
(``rotation_resident``, ``adjoint_resident``) on the checkpoint's train
segment, on its runs cut to one term each and on HVA 3x3 reps = 10, each
result against the plain version and bit for bit against the tile-run
kernels over the same layout.  CUDA-event ms a launch and us a run; with
``--compare PARENT``, the parent's kernels in rounds of parent, change,
change, parent, and bit for bit against them.

``--routes`` also times the per-term route, the resident route (at 18
and 20 qubits) and the stream route at 18 (3x3), 20 (2x5) and 24 qubits
(2x6), call by call and end to end, and the inner-product routes (per
term, the tiles folded in torch, the folded tiles) on the pool, H, Sz
(tilted) and S^2 and the two application kernels on H psi at each size
(the tile kernel also without its diagonal), each with its device and
host ms per call; ``--profile`` breaks a train step and a selection down
by device kernel (and the HVA train step at 3x3 and 2x6); ``--tiles``
times the resident kernels over other tile shapes on the 3x3 segment,
the 24-qubit tile-run kernels over other tile sizes (k, c) on the 2x6
segment, the folded inner-product tiles over tile
shapes and item caps on the pool, H, Sz and S^2 at 18 qubits and on the
pool, H and S^2 at 24, and the application tile kernel over the same
shapes on H psi at 18 and 24 qubits, and the float64 tile kernels (the
readout at 3x3 and 2x6, H psi at 18 and 24 qubits) at tiles of 10, 11 and
12 bits.

It imports nothing of JAX or of the JAX package ``qsfh_tpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
GROUND_STATE = os.path.join(
    HERE, "benchmarks", "demo_3x3", "ground_state_results",
    "Hubbard-3x3 (t=1, U=6, n_electrons=9) deg4.npz",
)
E_EXACT = -5.562308836311793  # the cached 4-state manifold's energy
ED_TOL = 1e-10  # the card's 3x3 manifold against the committed cache: energy, 1 - fidelity
HOST_ED_SECONDS = "16.5-21.2"  # the 3x3 4-state solve on the host (PERF.md section 6)

# H100 SXM published peaks (NVIDIA data sheet), at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
F64_FLOPS_PER_S = 34e12  # float64 outside the tensor cores
STATE_RTOL = 1e-5
# kernel path vs plain path, per train step: (metric, rtol, atol); float32
# over 934 rotations a step, at least 10x the differences an H100 shows
STEP_TOLERANCES = (
    ("energy", 1e-4, 0.0),
    ("gnorm", 1e-4, 0.0),
    ("S2", 1e-4, 0.0),
    ("Sz", 0.0, 1e-4),
    ("fidelity", 0.0, 1e-4),
)

TPU_KERNELS = "qsfh_tpu/engine/pallas_kernels.py"
REPLACES = {
    "pauli_rotation": f"{TPU_KERNELS}:482,571",
    "pauli_apply": f"{TPU_KERNELS}:715",
    "pauli_apply_grouped": f"{TPU_KERNELS}:715,1870,2002",
    "pauli_inner": f"{TPU_KERNELS}:645,927",
    "expectation_grouped": f"{TPU_KERNELS}:645,1581,1596,1714,1804",
    "screen_grouped": f"{TPU_KERNELS}:927,1474,1522",
    "expectation_partner": f"{TPU_KERNELS}:1596 (expectation_stream_planes, partner planes)",
    "pauli_rotation_out": f"{TPU_KERNELS}:571",
    "adjoint_rotation": f"{TPU_KERNELS}:826",
    "rotation_tile_runs": f"{TPU_KERNELS}:2268",
    "adjoint_tile_runs": f"{TPU_KERNELS}:2142",
    "pauli_inner_grouped": f"{TPU_KERNELS}:1581,1596,1714,1804,1474,1522",
    "xor_gather": f"{TPU_KERNELS}:378",
    "rotation_resident": f"{TPU_KERNELS}:482",
    "adjoint_resident": f"{TPU_KERNELS}:826",
    # no Pallas kernel: the JAX package's double-float readout in plain jnp
    "expectation_norm_f64": "qsfh_tpu/engine/dfloat.py:229 (expectation_norm_df, plain jnp; "
                            "no TPU Pallas counterpart)",
    "expectation_norm_f64_tiles": "qsfh_tpu/engine/dfloat.py:229 (expectation_norm_df, plain "
                                  "jnp; no TPU Pallas counterpart)",
    # no Pallas kernel: the JAX package's host C++ float64 engine
    "rot64_groups": "qsfh_tpu/native/statevec64.cpp:153 (qsfh_sv64_apply, host C++; "
                    "no TPU Pallas counterpart)",
    "happly64": "qsfh_tpu/native/statevec64.cpp:171 (qsfh_sv64_happly, host C++; "
                "no TPU Pallas counterpart)",
    "happly64_tiles": "qsfh_tpu/native/statevec64.cpp:171 (qsfh_sv64_happly, host C++; "
                      "no TPU Pallas counterpart)",
    "adjoint64_groups": "qsfh_tpu/native/statevec64.cpp:203 (qsfh_sv64_adjoint, host C++; "
                        "no TPU Pallas counterpart)",
    "rot64_resident": "qsfh_tpu/native/statevec64.cpp:153 (qsfh_sv64_apply, host C++; "
                      "no TPU Pallas counterpart)",
    "adjoint64_resident": "qsfh_tpu/native/statevec64.cpp:203 (qsfh_sv64_adjoint, host C++; "
                          "no TPU Pallas counterpart)",
}
# the kernels timed at 24 qubits only: the tile runs (past the chain cap)
# and the inner-product tiles returning v_t (the folded wrappers' kernel)
STREAM_KERNELS = ("rotation_tile_runs", "adjoint_tile_runs", "pauli_inner_grouped")
# the resident kernels, the 18-qubit main path's rotations and adjoint sweep
RESIDENT_KERNELS = ("rotation_resident", "adjoint_resident")
# The least float32 arithmetic of each function, per amplitude.  Rule: a
# complex multiply is 6 flops and a complex add 2; a factor of +-1 or +-i
# (the parity sign, the phase (-i)^k) is a sign or a swap and costs
# nothing.  Rotation: cos * psi[b] (2) + (+-sin or +-i sin) * psi[b^x] (2)
# + the add (2) = 6 per term.  Adjoint: the inner product (8) and two
# rotations (6 + 6) = 20 per term.  The stream kernels compute the same
# functions.  Inner products and applications share work between the terms
# of one flip mask: see inner_flops() and apply_flops().
FLOPS_PER_TERM_AMP = {
    "pauli_rotation": 6,
    "adjoint_rotation": 20,
    "rotation_tile_runs": 6,
    "adjoint_tile_runs": 20,
    "rotation_resident": 6,
    "adjoint_resident": 20,
}


def inner_flops(xs, a_is_psi, dim):
    """Least float32 flops of v_t = <a|P_t|psi> over the terms with flip
    masks ``xs`` (a tensor): the terms of one mask share conj(a[b])
    psi[b^x] (6 per mask and amplitude) and each adds it with its sign (2
    per term and amplitude); with a = psi the x = 0 product is |psi[b]|^2
    (3) and its terms add a real number (1)."""
    n_masks = int(xs.unique().numel())
    n_diag = int((xs == 0).sum()) if a_is_psi else 0
    per_amp = 6 * n_masks + 2 * len(xs)
    if n_diag:
        per_amp -= 3 + n_diag  # 6 -> 3 for the product, 2 -> 1 per term
    return per_amp * dim


def inner_bound_flops(xs, a_is_psi, tiles, dim):
    """The operations bound's flops of an inner-product tile call: the
    larger of :func:`inner_flops` and the Walsh-Hadamard diagonal's own
    work where the layout has one (the product, 3 flops a slot for a = psi
    and 6 otherwise, and k adds a slot, 2k for complex values)."""
    flops = inner_flops(xs, a_is_psi, dim)
    if tiles.n_diag:
        flops = max(flops, ((3 + tiles.k) if a_is_psi else (6 + 2 * tiles.k)) * dim)
    return flops


def apply_flops(xs, c, tiles, dim):
    """Least float32 flops found for sum_t c_t P_t psi over the terms with
    flip masks ``xs`` and coefficients ``c`` (tensors), laid out in
    ``tiles`` (their ``GroupTiles``): the application tile kernel's own
    work per amplitude, in which an item's terms are one table entry.  Per
    item one add of its entry (2; 1 where every coefficient is real), per
    flip mask one multiply of psi[b^x] and its accumulation into the output
    (8; 4 where real); a term of a mask that fits no tile is an item of its
    own."""
    real = not bool(c.imag.any())
    items = tiles.n_items + int(tiles.spill_index.size)
    return ((4 if real else 8) * int(xs.unique().numel()) + (1 if real else 2) * items) * dim


CONFIG = dict(
    threshold1=1e-2, threshold2=1e-2, x_dimension=3, y_dimension=3, n_electrons=9,
    n_spin_up=5, n_spin_down=4, tunneling=1, coulomb=6, degenerate_subspace=4,
    ground_state_path=GROUND_STATE, plot=False, log_metrics=False,
)
N_ANSATZ = 12
N_STEPS = 5

# the JAX package's own 24-qubit configuration (benchmarks/tpu_step_fused.py)
CONFIG_24 = dict(
    threshold1=1e-2, threshold2=1e-2, x_dimension=2, y_dimension=6, n_electrons=12,
    n_spin_up=6, n_spin_down=6, tunneling=1, coulomb=6, ground_truth=False,
    plot=False, log_metrics=False,
)
N_ANSATZ_24 = 6
N_PLAIN_STEPS_24 = 2
# kernel path vs plain path at 24 qubits, per train step; S^2 of the 6 up /
# 6 down singlet sector sits near 0, where only an absolute floor means
# anything
STEP_TOLERANCES_24 = (
    ("energy", 1e-4, 0.0),
    ("gnorm", 1e-4, 0.0),
    ("S2", 1e-4, 1e-4),
    ("Sz", 0.0, 1e-4),
)
GRAD_RTOL = 1e-4  # selection gradients, relative to max |grad|, both sizes
# the 2x5 lattice (20 qubits), for the route comparison of --routes only
CONFIG_20 = dict(CONFIG_24, y_dimension=5, n_electrons=10, n_spin_up=5, n_spin_down=5)


def log(msg):
    print(msg, flush=True)


def rel_err(got, ref):
    import torch

    return float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref))


def max_abs(got, ref):
    return float((got - ref).abs().max())


def inner_err(got, ref, scale):
    """(||got - ref|| / max(||ref||, scale), max |got - ref|) of a vector of
    inner products <a|P_t|psi>.  Each entry is bounded by scale = ||a||
    ||psi||, and a float32 sum over 2^n products carries an absolute
    error of that order times the rounding, whatever the value: entries
    that cancel to ~0 (Sz and the diagonal S^2 terms on a spin-symmetric
    state) have no relative precision, so the norm has that floor."""
    import torch

    den = max(float(torch.linalg.vector_norm(ref)), scale)
    return float(torch.linalg.vector_norm(got - ref)) / den, max_abs(got, ref)


def time_cuda(fn, reps, warmup=2):
    """ms per call from CUDA events around ``reps`` calls after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def timed_once(fn):
    """(ms, result) of one call, from CUDA events."""
    import torch

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop), out


def bound(bytes_moved, flops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# -- phase 1 ------------------------------------------------------------------------


def phase_card():
    import torch

    from qsfh_torch.engine import kernels as K

    log(f"torch {torch.__version__} (CUDA {torch.version.cuda}), python {sys.version.split()[0]}")
    log(f"device: {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    t0 = time.time()
    so = K.build()
    K._load()
    log(f"built {os.path.relpath(so, HERE)} in {time.time() - t0:.2f} s "
        f"(nvcc {K.build_info.get('seconds', 0.0):.2f} s)")
    for line in K.build_info.get("log", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    return smi


# -- phase 2 ------------------------------------------------------------------------


def recorder(results, n):
    """record(name, call, T, bytes, errs, ms, plain_ms, ...): one kernel
    measurement at n qubits into ``results[name]``, logged, and held to
    STATE_RTOL."""
    dim = 1 << n

    def record(name, call, T, bytes_moved, errs, ms, plain_ms, library_ms=None, flops=None,
               **extra):
        flops = FLOPS_PER_TERM_AMP[name] * T * dim if flops is None else flops
        b_ms, b_by = bound(bytes_moved, flops)
        entry = dict(call=call, terms=T, n=n, rel_err=max(e[0] for e in errs),
                     max_abs_err=max(e[1] for e in errs), ms=ms, plain_ms=plain_ms,
                     bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                     bytes=bytes_moved, flops=flops, **extra)
        results.setdefault(name, []).append(entry)
        log(f"  {name:16s} {call:28s} T={T:5d} rel_err={entry['rel_err']:.2e} "
            f"(tol {STATE_RTOL:g}) max_abs={entry['max_abs_err']:.2e} ms={ms:.4f} "
            f"plain_ms={plain_ms:.3f} bound_ms={b_ms:.5f} ({b_by})"
            + ("" if library_ms is None else f" library_ms={library_ms:.4f}")
            + "".join(f" {k}={v}" for k, v in extra.items()))
        if entry["rel_err"] > STATE_RTOL:
            raise AssertionError(f"{name} ({call}) disagrees with its plain version")

    return record


def resident_span(seg, n, direction, k=None, c=None):
    """The one span of tile runs of a segment's resident layout at n
    qubits (the shipped shape unless k, c are given); raises if a term
    fits no tile."""
    from qsfh_torch.engine import streaming

    k = streaming.RESIDENT_TILE_BITS if k is None else k
    c = streaming.RESIDENT_TILE_LOW_BITS if c is None else c
    layout = seg.tiles(direction, n, k, c)
    if layout.n_single or len(layout.spans) != 1:
        raise AssertionError(f"a term of the segment fits no resident tile of {k} bits, low {c}")
    return layout.spans[0][0]


def resident_checks(seg, n, calls, adj, psi, lam, record):
    """The resident kernels on one segment's terms at n qubits, one launch
    per call: ``rotation_resident`` over ``calls`` [(call, direction,
    arrays)] and ``adjoint_resident`` over ``adj`` (the reversed arrays),
    against the plain versions; again on a grid of a fifth of a run's
    tiles (a block then takes five tiles a run), which must give the same
    bits, and the adjoint twice on the same inputs (the same bits).  CUDA
    events; returns the grids and the per-run launches' times
    (:func:`per_launch_ms`)."""
    import torch

    from qsfh_torch.engine import kernels as K

    dim = 1 << n
    T = len(seg)
    term_bytes = T * 20
    grids, per_launch = {}, []
    for call, direction, arrs in calls:
        tiles = resident_span(seg, n, direction)
        grid = K.resident_grid(psi, tiles, False)
        few = max(1, (1 << (n - tiles.k)) // 5)
        got = K.rotation_resident(psi.clone(), *arrs, tiles)
        small = K.rotation_resident(psi.clone(), *arrs, tiles, blocks=few)
        ref = K.rotation_resident_plain(psi.clone(), *arrs, tiles)
        torch.cuda.synchronize()
        if not torch.equal(small, got):
            raise AssertionError(f"rotation_resident ({call}): {few} blocks give other bits")
        buf = psi.clone()
        ms = time_cuda(lambda: K.rotation_resident(buf, *arrs, tiles), reps=20)
        plain_ms = time_cuda(lambda: K.rotation_resident_plain(buf, *arrs, tiles), reps=2,
                             warmup=1)
        log(f"  rotation_resident n={n} {call}: {len(tiles)} runs, {tiles.n_groups} register "
            f"groups, tiles of {tiles.k} bits (low {tiles.c}), {grid} blocks; {few} blocks: "
            f"the same bits; " + per_launch_ms(seg, n, direction, arrs, psi, None, ms, per_launch))
        record("rotation_resident", call, T, 2 * 8 * dim + term_bytes,
               [(rel_err(got, ref), max_abs(got, ref))], ms, plain_ms)
        grids[call] = grid

    tiles = resident_span(seg, n, -1)
    grid = K.resident_grid(psi, tiles, True)
    few = max(1, (1 << (n - tiles.k)) // 5)

    def sweep(fn, **blocks):
        p, l = psi.clone(), lam.clone()
        return fn(p, l, *adj, tiles, **blocks), p, l

    first, again = sweep(K.adjoint_resident), sweep(K.adjoint_resident)
    small = sweep(K.adjoint_resident, blocks=few)
    v_ref, p_ref, l_ref = sweep(K.adjoint_resident_plain)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for other in (again, small) for a, b in zip(first, other)):
        raise AssertionError("adjoint_resident: two calls, or two grids, give other bits")
    errs = [(rel_err(a, b), max_abs(a, b)) for a, b in zip(first, (v_ref, p_ref, l_ref))]
    pb, lb = psi.clone(), lam.clone()
    ms = time_cuda(lambda: K.adjoint_resident(pb, lb, *adj, tiles), reps=20)
    plain_ms = time_cuda(lambda: K.adjoint_resident_plain(pb, lb, *adj, tiles), reps=2, warmup=1)
    log(f"  adjoint_resident n={n}: {len(tiles)} runs, {tiles.n_groups} register groups, "
        f"{grid} blocks; a second call and {few} blocks: the same bits; "
        + per_launch_ms(seg, n, -1, adj, psi, lam, ms, per_launch))
    record("adjoint_resident", "gradient sweep", T, 4 * 8 * dim + term_bytes + 8 * T, errs, ms,
           plain_ms)
    grids["gradient sweep"] = grid
    return grids, per_launch


def per_launch_ms(seg, n, direction, arrs, psi, lam, resident_ms, out):
    """The same terms as one launch per tile run (``rotation_tile_runs``,
    or ``adjoint_tile_runs`` with ``lam``), at the resident tile shape and
    at the stream route's (CUDA events, ms per call) into ``out``; returns
    a log fragment beside ``resident_ms``."""
    from qsfh_torch.engine import kernels as K
    from qsfh_torch.engine import streaming

    parts = []
    shapes = ((streaming.RESIDENT_TILE_BITS, streaming.RESIDENT_TILE_LOW_BITS),
              (streaming.TILE_BITS, streaming.TILE_LOW_BITS))
    for k, c in shapes:
        tiles = resident_span(seg, n, direction, k, c)
        p, l = psi.clone(), None if lam is None else lam.clone()
        if lam is None:
            ms = time_cuda(lambda: K.rotation_tile_runs(p, *arrs, tiles), reps=20)
        else:
            ms = time_cuda(lambda: K.adjoint_tile_runs(p, l, *arrs, tiles), reps=20)
        what = "adjoint" if lam is not None else ("forward" if direction == 1 else "inverse")
        out.append(dict(n=n, call=what, k=k, c=c, launches=len(tiles), ms=ms,
                        resident_ms=resident_ms))
        parts.append(f"{len(tiles)} launches of {k}/{c} tiles {ms:.4f} ms")
    return "one launch per run: " + ", ".join(parts) + f" (resident {resident_ms:.4f} ms)"


# (k, c) of the resident tiles that --tiles times on the 3x3 segment (the
# adjoint's kernel takes at most 12 bits: kernels.RESIDENT_ADJOINT_MAX_BITS)
RESIDENT_TILE_SHAPES = ((10, 3), (10, 4), (11, 3), (11, 4), (12, 3), (12, 4))


def sweep_resident_shapes(seg, n, psi, lam, rot, adj, ref, v_ref):
    """The resident kernels on the 3x3 segment over other tile shapes (k
    bits, the low c): ms per forward segment and adjoint sweep (CUDA
    events, one launch each), runs, register groups and blocks, each held
    to the plain results."""
    import torch

    from qsfh_torch.engine import kernels as K

    rows = []
    for k, c in RESIDENT_TILE_SHAPES:
        fwd, back = resident_span(seg, n, 1, k, c), resident_span(seg, n, -1, k, c)
        buf = psi.clone()
        err = rel_err(K.rotation_resident(psi.clone(), *rot, fwd), ref)
        ms = time_cuda(lambda: K.rotation_resident(buf, *rot, fwd), reps=10)
        pb, lb = psi.clone(), lam.clone()
        adj_err = rel_err(K.adjoint_resident(psi.clone(), lam.clone(), *adj, back), v_ref)
        adj_ms = time_cuda(lambda: K.adjoint_resident(pb, lb, *adj, back), reps=10)
        torch.cuda.synchronize()
        if max(err, adj_err) > STATE_RTOL:
            raise AssertionError(f"resident sweep k={k} c={c}: errors {err:.2e}, {adj_err:.2e}")
        row = dict(k=k, c=c, ms=ms, adjoint_ms=adj_ms, runs=len(fwd), adjoint_runs=len(back),
                   groups=fwd.n_groups, blocks=K.resident_grid(psi, fwd, False),
                   adjoint_blocks=K.resident_grid(psi, back, True), rel_err=max(err, adj_err))
        rows.append(row)
        log(f"  resident tiles k={k} c={c}: forward {ms:.4f} ms ({row['runs']} runs, "
            f"{row['blocks']} blocks), adjoint {adj_ms:.4f} ms ({row['adjoint_runs']} runs, "
            f"{row['adjoint_blocks']} blocks), rel_err {row['rel_err']:.2e}")
    return rows


def phase_kernels(adapt, dev, sweep_tiles=False):
    """Each kernel against its plain version at the main path's shapes."""
    import torch

    from qsfh_torch.engine import kernels as K
    from qsfh_torch.engine.compiled import CompiledCircuit

    n = adapt.n_qubits
    dim = 1 << n
    p = adapt.problem
    cc = CompiledCircuit(adapt._ansatz_ops(range(N_ANSATZ)) + adapt._net_ops, n,
                         global_phase=adapt._net_phase)
    seg = cc.segments[0]
    thetas = torch.full((N_ANSATZ,), 0.05, dtype=torch.float32, device=dev)
    d = seg.tensors(dev, torch.float32, N_ANSATZ)
    angles = torch.cat([thetas, thetas.new_ones(1)])[d["pidx"]] * d["scale"]
    rot = (d["xb"], d["zb"], angles, d["phre"], d["phim"])
    rot_inv = tuple(a.flip(0) for a in (d["xb"], d["zb"], -angles, d["phre"], d["phim"]))
    T_rot = len(seg)

    gen = torch.Generator(device=dev).manual_seed(0)

    def random_state():
        v = torch.randn(dim, dtype=torch.complex64, device=dev, generator=gen)
        return v / torch.linalg.vector_norm(v)

    psi, w = random_state(), random_state()
    h_xs, h_zs, h_c = p.observables["H"]._tensors(psi)
    s2_xs, s2_zs, _ = p.observables["S^2"]._tensors(psi)
    pool = adapt.packed_pool
    pool_xs, pool_zs, _, _ = pool._tensors(psi)
    log(f"main-path shapes: n={n}, rot segment {T_rot} terms, H {len(h_xs)}, "
        f"S^2 {len(s2_xs)}, pool {pool.size} generators / {len(pool_xs)} terms")

    results = {}
    record = recorder(results, n)
    term_bytes_rot = T_rot * (4 + 4 + 4 + 4 + 4)

    # pauli_rotation: the forward segment and its inverse
    for call, arrs in (("forward ansatz+network", rot), ("inverse (reversed)", rot_inv)):
        got = K.pauli_rotation(psi.clone(), *arrs)
        ref = K.pauli_rotation_plain(psi.clone(), *arrs)
        torch.cuda.synchronize()
        errs = [(rel_err(got, ref), max_abs(got, ref))]
        if call.startswith("inverse"):
            # 934 float32 rotations: expect ~sqrt(934) x 3e-7 ~ 1e-5 drift
            back = K.pauli_rotation(K.pauli_rotation(psi.clone(), *rot), *rot_inv)
            drift = rel_err(back, psi)
            log(f"  pauli_rotation   forward then inverse: ||back - psi|| = {drift:.2e} (tol 1e-4)")
            if drift > 1e-4:
                raise AssertionError("the inverse rotation does not undo the forward one")
        buf = psi.clone()
        ms = time_cuda(lambda: K.pauli_rotation(buf, *arrs), reps=10)
        plain_ms = time_cuda(lambda: K.pauli_rotation_plain(buf, *arrs), reps=2, warmup=1)
        record("pauli_rotation", call, T_rot, 2 * 8 * dim + term_bytes_rot, errs, ms, plain_ms)

    # pauli_apply on H, with a CSR sparse product as the library yardstick
    hargs = (h_xs, h_zs, h_c.real, h_c.imag)
    got = K.pauli_apply(psi, *hargs)
    ref = K.pauli_apply_plain(psi, *hargs)
    torch.cuda.synchronize()
    errs = [(rel_err(got, ref), max_abs(got, ref))]
    ms = time_cuda(lambda: K.pauli_apply(psi, *hargs), reps=20)
    plain_ms = time_cuda(lambda: K.pauli_apply_plain(psi, *hargs), reps=3, warmup=1)
    library_ms = library_sparse_apply(psi, h_xs, h_zs, h_c, ref)
    record("pauli_apply", "lambda = H psi", len(h_xs), 2 * 8 * dim + 16 * len(h_xs), errs,
           ms, plain_ms, library_ms,
           flops=apply_flops(h_xs, h_c, p.observables["H"].groups(), dim))
    apply_tiles_check(p.observables["H"], psi, ref, plain_ms, library_ms, record,
                      "lambda = H psi (tiles)")
    if sweep_tiles:
        results["apply_tile_sweep"] = sweep_apply_tile_sizes(p.observables["H"], psi, ref)

    # pauli_inner: expectations (a = psi) and pool screening (a = w)
    for call, a, xs, zs in (
        ("<psi|H|psi> terms", psi, h_xs, h_zs),
        ("<psi|S^2|psi> terms", psi, s2_xs, s2_zs),
        ("pool screening <w|P|psi>", w, pool_xs, pool_zs),
    ):
        got = K.pauli_inner(a, psi, xs, zs)
        ref = K.pauli_inner_plain(a, psi, xs, zs)
        torch.cuda.synchronize()
        errs = [(rel_err(got, ref), max_abs(got, ref))]
        ms = time_cuda(lambda: K.pauli_inner(a, psi, xs, zs), reps=10)
        plain_ms = time_cuda(lambda: K.pauli_inner_plain(a, psi, xs, zs), reps=2, warmup=1)
        n_inputs = 1 if a is psi else 2
        T = len(xs)
        record("pauli_inner", call, T, n_inputs * 8 * dim + T * (8 + 8), errs, ms, plain_ms,
               flops=inner_flops(xs, a is psi, dim))

    # the engine's inner products: the folded tile wrappers, Sz on a tilted state
    calls = inner_calls(adapt, psi, w, tilted_state(psi, n))
    inner_fold_checks(calls, record)
    if sweep_tiles:
        results["inner_tile_sweep"] = {
            call: sweep_inner_tile_sizes(call, n, owner, a, b, fold_fns(owner, a, b)[1]["plain"]())
            for call, owner, a, b in calls}

    # adjoint_rotation over the reversed segment, from psi and lambda = 2 H psi
    lam = 2.0 * K.pauli_apply(psi, *hargs)
    adj = tuple(a.flip(0) for a in (d["xb"], d["zb"], angles, d["phre"], d["phim"]))
    p1, l1, p2, l2 = psi.clone(), lam.clone(), psi.clone(), lam.clone()
    got = K.adjoint_rotation(p1, l1, *adj)
    ref = K.adjoint_rotation_plain(p2, l2, *adj)
    torch.cuda.synchronize()
    errs = [(rel_err(got, ref), max_abs(got, ref)), (rel_err(p1, p2), max_abs(p1, p2)),
            (rel_err(l1, l2), max_abs(l1, l2))]
    ms = time_cuda(lambda: K.adjoint_rotation(p1, l1, *adj), reps=10)
    plain_ms = time_cuda(lambda: K.adjoint_rotation_plain(p2, l2, *adj), reps=2, warmup=1)
    record("adjoint_rotation", "gradient sweep", T_rot,
           4 * 8 * dim + term_bytes_rot + 8 * T_rot, errs, ms, plain_ms)

    # the resident kernels, the main path's route: at 18 qubits, then on the
    # same terms at 20 (the chain cap's other candidate: psi and lam 16 MiB)
    calls = (("forward ansatz+network", 1, rot), ("inverse (reversed)", -1, rot_inv))
    results["resident_grids"], results["per_launch"] = resident_checks(seg, n, calls, adj, psi,
                                                                       lam, record)
    psi20, lam20 = (torch.randn(1 << 20, dtype=torch.complex64, device=dev, generator=gen)
                    for _ in range(2))
    psi20 /= torch.linalg.vector_norm(psi20)
    results["n20"] = {}
    results["n20"]["grids"], results["n20"]["per_launch"] = resident_checks(
        seg, 20, calls, adj, psi20, lam20, recorder(results["n20"], 20))
    del psi20, lam20
    if sweep_tiles:
        ref = K.pauli_rotation_plain(psi.clone(), *rot)
        v_ref = K.adjoint_rotation_plain(psi.clone(), lam.clone(), *adj)
        results["resident_sweep"] = sweep_resident_shapes(seg, n, psi, lam, rot, adj, ref, v_ref)
    return results


def in_turns(fns, reps, warmup=1):
    """ms per call of each of two functions on the same inputs, timed in
    the order a, b, b, a (CUDA events) and averaged: a drift of the card
    between the two falls on both."""
    (a, fa), (b, fb) = fns.items()
    ms = {a: [], b: []}
    for name, fn in ((a, fa), (b, fb), (b, fb), (a, fa)):
        ms[name].append(time_cuda(fn, reps=reps, warmup=warmup))
    return {name: sum(v) / len(v) for name, v in ms.items()}


def apply_tiles_check(obs, psi, ref, plain_ms, library_ms, record, call):
    """``pauli_apply_grouped`` on H psi against its plain result ``ref``,
    twice (the same bits), timed in turns with the per-term
    ``pauli_apply`` on the same inputs; recorded with its launches and
    state passes (one per tile)."""
    import torch

    from qsfh_torch.engine import kernels as K

    xs, zs, c = obs._tensors(psi)
    tiles = obs.groups()
    args = (psi, xs, zs, c.real, c.imag)
    got, launches = launches_of(lambda: K.pauli_apply_grouped(*args, tiles))
    again = K.pauli_apply_grouped(*args, tiles)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"pauli_apply_grouped ({call}): two calls give other bits")
    ms = in_turns({"tiles": lambda: K.pauli_apply_grouped(*args, tiles),
                   "per-term": lambda: K.pauli_apply(*args)}, reps=20)
    dim = psi.shape[0]
    record("pauli_apply_grouped", call, len(xs), 2 * 8 * dim + 16 * len(xs),
           [(rel_err(got, ref), max_abs(got, ref))], ms["tiles"], plain_ms, library_ms,
           flops=apply_flops(xs, c, tiles, dim), per_term_ms=ms["per-term"], launches=launches,
           passes=len(tiles), items=tiles.n_items, tiles=tiles.n_tiles)


def sweep_apply_tile_sizes(obs, psi, ref):
    """``pauli_apply_grouped`` on H psi over other tile shapes (k bits, the
    low c, item caps of ``APPLY_TILE_SHAPES``), each with and without its
    diagonal (the x = 0 terms as items): device and host ms per call
    (:func:`host_device_split`), state passes, items and diagonal
    entries, each held to the plain result."""
    from qsfh_torch.engine import kernels as K
    from qsfh_torch.engine import streaming

    xs, zs, c = obs._tensors(psi)
    n = psi.shape[0].bit_length() - 1
    hx, hz = xs.cpu().numpy(), zs.cpu().numpy()
    rows = []
    for (k, low, cap), diag in [(s, d) for s in APPLY_TILE_SHAPES for d in (True, False)]:
        tiles = streaming.GroupTiles(hx, hz, n, k, low, cap, diagonal=diag)
        err = rel_err(K.pauli_apply_grouped(psi, xs, zs, c.real, c.imag, tiles), ref)
        if tiles.spill_index.size or err > STATE_RTOL:
            raise AssertionError(f"apply tile sweep n={n} k={k} c={low} cap={cap}: {err:.2e}")
        split = host_device_split(
            lambda: K.pauli_apply_grouped(psi, xs, zs, c.real, c.imag, tiles), reps=20)
        rows.append(dict(n=n, k=k, c=low, max_items=cap, diagonal=diag, **split,
                         passes=len(tiles), items=tiles.n_items,
                         diagonal_entries=int(tiles.diag_zin.size), rel_err=err))
        log(f"  apply tiles, H psi n={n}: k={k} c={low} max_items={cap}"
            + ("" if diag else ", x = 0 terms as items") + f": device {ms_text(split['device_ms'])}"
            f", graph {split['graph_ms']:.4f} ms, host {split['host_ms']:.4f} ms, {len(tiles)} "
            f"passes, {tiles.n_items} items, "
            f"{tiles.diag_zin.size} diagonal entries, rel_err {err:.2e}")
    return rows


def sparse_h(psi, xs, zs, c):
    """The CSR matrix of sum_t c_t P_t in psi's dtype on psi's device (a
    yardstick only; the port never builds it), built on the card mask by
    mask: row b holds one entry per distinct flip mask x, at column b ^ x,
    the sum of c_t s_t(b) over the terms of x (columns sorted within each
    row; 37 x 2^n entries for the Hubbard H)."""
    import torch

    from qsfh_torch.engine.state import index_bits, parity_signs

    dim = psi.shape[0]
    idx = index_bits(dim.bit_length() - 1, psi.device)
    masks = xs.unique()
    vals = torch.zeros((dim, masks.numel()), dtype=psi.dtype, device=psi.device)
    for m, x in enumerate(masks):
        for t in torch.nonzero(xs == x).flatten().tolist():
            vals[:, m] += c[t] * parity_signs(idx, zs[t], psi.real.dtype)
    cols = (idx[:, None] ^ masks[None, :]).to(torch.int32)
    cols, perm = cols.sort(dim=1)
    vals = vals.gather(1, perm)
    del perm
    nnz = vals.numel()
    crow = torch.arange(0, nnz + 1, masks.numel(), dtype=torch.int32, device=psi.device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "sparse support is in beta"
        return torch.sparse_csr_tensor(crow, cols.flatten(), vals.flatten(), (dim, dim))


def library_sparse_apply(psi, xs, zs, c, ref):
    """ms of one ``torch`` CSR sparse matrix-vector product computing H psi
    (:func:`sparse_h`; a yardstick only, the port never calls it), or None
    where this torch build cannot multiply a complex CSR matrix on the
    card."""
    import torch

    csr = sparse_h(psi, xs, zs, c)
    nnz = csr.values().numel()
    try:
        out = torch.mv(csr, psi)
    except RuntimeError as exc:  # a missing sparse kernel in this torch build
        log(f"  library yardstick unavailable: {str(exc).splitlines()[0]}")
        return None
    if rel_err(out, ref) > STATE_RTOL:
        raise AssertionError("the sparse yardstick disagrees with H psi")
    log(f"  library yardstick: CSR H with {nnz} nonzeros")
    return time_cuda(lambda: torch.mv(csr, psi), reps=20)


def host_device_split(fn, reps=200):
    """Where one call's time goes, over ``reps`` back-to-back calls: the
    host's ms per call to enqueue them (host clock, no sync), the wall ms
    per call (host clock ended by a device sync: the larger of the two
    sides once the queue is full), the device ms per call (the kernels'
    time in ``torch.profiler``; None where the profile caught no kernel,
    which happens now and then) and the graph ms per call (:func:`graph_ms`:
    the device's time with no host in the way)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    device_us = sum(r[2] for r in _device_kernels(prof))
    return dict(host_ms=1e3 * (t1 - t0) / reps, wall_ms=1e3 * (t2 - t0) / reps,
                device_ms=device_us / 1e3 / reps if device_us else None,
                graph_ms=graph_ms(fn, min(reps, 50)))


def graph_ms(fn, reps, replays=5):
    """ms per call of ``reps`` calls of ``fn`` captured in one CUDA graph
    and replayed ``replays`` times between CUDA events: every launch of
    the calls, back to back, with no host time between them (the gaps
    between kernels stay).  The calls run once on the capture stream
    first, so that per-stream words and cached layouts exist before the
    capture."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / (replays * reps)
    del graph
    return ms


def ms_text(ms):
    """A device time for the log: ms, or "not measured" (None)."""
    return "not measured" if ms is None else f"{ms:.4f} ms"


def inner_calls(adapt, psi, w, tilted):
    """The engine's four inner-product calls on these states: (call, owner,
    a, b) for <a|P_t|b>: the pool screen (a = w), H and S^2 (a = b = psi)
    and Sz on a tilted state, whose <Z_q> do not cancel."""
    obs = adapt.problem.observables
    return (("pool screen <w|P|psi>", adapt.packed_pool, w, psi),
            ("<psi|H|psi>", obs["H"], psi, psi),
            ("<t|Sz|t>, tilted state", obs["Sz"], tilted, tilted),
            ("<psi|S^2|psi>", obs["S^2"], psi, psi))


def fold_fns(owner, a, b, tiles=None):
    """The folded call of an expectation value (a = b) or a pool screen's
    per-term contributions on ``tiles`` (the engine's ``inner_groups()``
    unless given), as callables: "tiles" the folded wrapper, "plain" its
    plain version, "per-term" the per-term ``pauli_inner`` folded in torch
    (the parent's 18-qubit route); and the name of the wrapper."""
    from qsfh_torch.engine import kernels as K

    xs, zs, c = owner._tensors(b)[:3]
    tiles = owner.inner_groups() if tiles is None else tiles
    args = (xs, zs, c.real, c.imag, tiles)
    if a is b:
        return "expectation_grouped", {
            "tiles": lambda: K.expectation_grouped(b, *args),
            "plain": lambda: K.expectation_grouped_plain(b, *args),
            "per-term": lambda: (c * K.pauli_inner(b, b, xs, zs)).real.sum()}
    return "screen_grouped", {
        "tiles": lambda: K.screen_grouped(a, b, *args),
        "plain": lambda: K.screen_grouped_plain(a, b, *args),
        "per-term": lambda: 2.0 * (c * K.pauli_inner(a, b, xs, zs)).imag}


def fold_scale(owner, a, b):
    """The largest norm the folded result could have: sum_t |c_t| ||a||
    ||b|| for an expectation, 2 ||c|| ||a|| ||b|| for the screen's vector."""
    import torch

    c = owner._tensors(b)[2]
    ab = float(torch.linalg.vector_norm(a) * torch.linalg.vector_norm(b))
    return ab * (float(c.abs().sum()) if a is b else 2.0 * float(torch.linalg.vector_norm(c)))


def inner_fold_checks(calls, record):
    """The folded wrappers on the engine's calls against their plain
    versions (:func:`fold_err`) and twice (the same bits), timed in turns
    with the per-term route (CUDA events), each with its device and host
    ms per call (:func:`host_device_split`), launches, units, items and
    diagonal terms."""
    import torch

    from qsfh_torch.engine import kernels as K

    for call, owner, a, b in calls:
        name, fns = fold_fns(owner, a, b)
        tiles = owner.inner_groups()
        n = b.shape[0].bit_length() - 1
        got, launches = launches_of(fns["tiles"])
        again = fns["tiles"]()
        ref = fns["plain"]()
        old = fns["per-term"]()
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"{name} ({call}): two calls give other bits")
        scale = fold_scale(owner, a, b)
        errs = [(fold_err(got, ref, scale), max_abs(got, ref)),
                (fold_err(old, ref, scale), max_abs(old, ref))]
        ms = in_turns({"tiles": fns["tiles"], "per-term": fns["per-term"]}, reps=10)
        plain_ms = time_cuda(fns["plain"], reps=2, warmup=1)
        split = {route: host_device_split(fns[route], reps=split_reps(ms[route]))
                 for route in ("tiles", "per-term")}
        xs = owner._tensors(b)[0]
        positions, units = tiles.schedule(n, K.sm_count(b.device))
        record(name, call, len(xs), (1 if a is b else 2) * 8 * b.shape[0] + 16 * len(xs), errs,
               ms["tiles"], plain_ms, flops=inner_bound_flops(xs, a is b, tiles, b.shape[0]),
               per_term_ms=ms["per-term"], launches=launches, device_ms=split["tiles"]["device_ms"],
               graph_ms=split["tiles"]["graph_ms"], host_ms=split["tiles"]["host_ms"],
               per_term_device_ms=split["per-term"]["device_ms"],
               per_term_graph_ms=split["per-term"]["graph_ms"],
               per_term_host_ms=split["per-term"]["host_ms"], tiles=tiles.n_tiles,
               items=tiles.n_items, diagonal=tiles.n_diag, units=len(units),
               positions=positions)


def phase_single(dev, n):
    """xor_gather and the one-term rotation at n qubits against their plain
    versions; the gather also against ``torch.index_select`` with a
    prebuilt index (a yardstick only; the port never calls it), each with
    its host and device ms per call (:func:`host_device_split`)."""
    import torch

    from qsfh_torch.engine import kernels as K
    from qsfh_torch.engine.state import index_bits

    dim = 1 << n
    gen = torch.Generator(device=dev).manual_seed(n)
    psi = torch.randn(dim, dtype=torch.complex64, device=dev, generator=gen)
    psi /= torch.linalg.vector_norm(psi)
    # a double-excitation-like flip mask (bits at both ends and inside) and a JW string
    x = (1 << (n - 1)) | (1 << (n // 2)) | (1 << (n // 2 - 1)) | 1
    z = ((1 << (n - 1)) - 1) & ~((1 << (n // 2 - 1)) - 1) | 0b110
    ph = (-1j) ** (bin(x & z).count("1") % 4)
    results = {}
    state_bytes = 2 * 8 * dim  # one read, one write

    xdev = torch.tensor([x], dtype=torch.int64, device=dev)
    got = K.xor_gather(psi, xdev)
    ref = K.xor_gather_plain(psi, x)
    perm = index_bits(n, dev) ^ x
    torch.cuda.synchronize()
    err = max_abs(got, ref)
    if err != 0.0 or not torch.equal(K.xor_gather(psi, x), ref):
        raise AssertionError(f"xor_gather (n={n}) disagrees with its plain version")
    b_ms, b_by = bound(state_bytes, 0)
    gather = lambda: K.xor_gather(psi, xdev)  # noqa: E731
    library = lambda: torch.index_select(psi, 0, perm)  # noqa: E731
    ms = in_turns({"kernel": gather, "library": library}, reps=200, warmup=20)
    results["xor_gather"] = dict(
        call=f"psi[b ^ x], n={n}", n=n, terms=1, rel_err=0.0, max_abs_err=err, ms=ms["kernel"],
        plain_ms=time_cuda(lambda: K.xor_gather_plain(psi, xdev), reps=5),
        bound_ms=b_ms, bound_by=b_by, library_ms=ms["library"],
        split=host_device_split(gather), library_split=host_device_split(library))
    for what in ("split", "library_split"):
        s = results["xor_gather"][what]
        log(f"  xor_gather n={n} {'index_select' if what[0] == 'l' else 'kernel'}: host "
            f"{s['host_ms']:.4f} ms, wall {s['wall_ms']:.4f} ms, device {ms_text(s['device_ms'])}, "
            f"graph {s['graph_ms']:.4f} ms per call (200 back-to-back calls)")

    args = (x, z, 0.37, ph.real, ph.imag)
    got = K.pauli_rotation_one(psi, *args)
    ref = K.pauli_rotation_one_plain(psi, *args)
    torch.cuda.synchronize()
    b_ms, b_by = bound(state_bytes + 20, 6 * dim)
    rotate = lambda: K.pauli_rotation_one(psi, *args)  # noqa: E731
    results["pauli_rotation_one"] = dict(
        call=f"exp(-i theta P) psi, one term, n={n}", n=n, terms=1, rel_err=rel_err(got, ref),
        max_abs_err=max_abs(got, ref),
        plain_ms=time_cuda(lambda: K.pauli_rotation_one_plain(psi, *args), reps=5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, split=host_device_split(rotate))
    ms = in_turns({"kernel": rotate, "gather": gather}, reps=200, warmup=20)
    results["pauli_rotation_one"].update(ms=ms["kernel"], gather_ms=ms["gather"])
    s = results["pauli_rotation_one"]["split"]
    log(f"  pauli_rotation_one n={n}: host {s['host_ms']:.4f} ms, wall {s['wall_ms']:.4f} ms, "
        f"device {ms_text(s['device_ms'])}, graph {s['graph_ms']:.4f} ms per call (200 "
        f"back-to-back calls)")
    for name, e in results.items():
        log(f"  {name:18s} n={n} rel_err={e['rel_err']:.2e} max_abs={e['max_abs_err']:.2e} "
            f"ms={e['ms']:.4f} plain_ms={e['plain_ms']:.4f} bound_ms={e['bound_ms']:.5f} "
            f"({e['bound_by']})" + ("" if e["library_ms"] is None
                                   else f" library_ms={e['library_ms']:.4f} (index_select)"))
        if e["rel_err"] > STATE_RTOL:
            raise AssertionError(f"{name} (n={n}) disagrees with its plain version")
    return results


# -- phase 3 ------------------------------------------------------------------------


def bench_steps(adapt, dev, n_ansatz=N_ANSATZ, n_steps=N_STEPS):
    """``n_steps`` train steps of the first ``n_ansatz`` pool operators;
    per-step metrics."""
    import torch

    indices = tuple(range(n_ansatz))
    adapt.selected_indices = list(indices)
    adapt.params_t = torch.full((n_ansatz,), 0.05, dtype=adapt._rdt, device=dev)
    optimizer = torch.optim.Adam([adapt.params_t], lr=1e-2)
    step = adapt._build_step(indices)
    rows = []
    for i in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, e, sz, s2, fid, gnorm = step(adapt.params_t, optimizer)
        e, sz, s2, fid, gnorm = map(float, (e, sz, s2, fid, gnorm))
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        rows.append(dict(step=i + 1, energy=e, Sz=sz, S2=s2, fidelity=fid, gnorm=gnorm, ms=ms))
    return rows


def check_steps(rows, n_up, n_down, label, e_floor=E_EXACT):
    """Finite metrics, Sz at its exact value, and (where a ground truth
    exists, ``e_floor`` not None) fidelity in [0, 1] and no energy below it."""
    sz_exact = 0.5 * (n_up - n_down)
    for r in rows:
        log(f"  [{label}] step {r['step']}: E={r['energy']:.7f} Sz={r['Sz']:.3e} "
            f"S^2={r['S2']:.5f} fidelity={r['fidelity']:.6f} gnorm={r['gnorm']:.5f} "
            f"{r['ms']:.2f} ms")
        vals = (r["energy"], r["Sz"], r["S2"], r["fidelity"], r["gnorm"])
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"{label}: non-finite step metrics {r}")
        if abs(r["Sz"] - sz_exact) > 1e-4:
            raise AssertionError(f"{label}: Sz drifted from {sz_exact}: {r['Sz']}")
        if r["gnorm"] <= 0:
            raise AssertionError(f"{label}: zero gradient")
        if e_floor is None:
            continue
        if not -1e-5 <= r["fidelity"] <= 1 + 1e-5:
            raise AssertionError(f"{label}: fidelity out of [0, 1]: {r['fidelity']}")
        if r["energy"] < e_floor - 1e-3:
            raise AssertionError(f"{label}: energy below the exact ground energy")


def compare_steps(rows, plain_rows, tolerances):
    for a, b in zip(rows, plain_rows):
        for key, rtol, atol in tolerances:
            if abs(a[key] - b[key]) > rtol * abs(b[key]) + atol:
                raise AssertionError(f"step {a['step']}: {key} {a[key]} vs plain {b[key]}")
    log("  plain path: per step " + ", ".join(
        f"{key} within {rtol:g} relative + {atol:g}" for key, rtol, atol in tolerances))


def build_adapt(dev, tmp, name, config=CONFIG, **extra):
    from qsfh_torch.algos.adapt import ADAPT

    t0 = time.time()
    adapt = ADAPT(n_epoch=1, results_root=os.path.join(tmp, name), device=dev,
                  **config, **extra)
    log(f"ADAPT {config['x_dimension']}x{config['y_dimension']} ({name}) built in "
        f"{time.time() - t0:.2f} s: {adapt.n_qubits} qubits, {len(adapt.fermion_pool)} pool "
        f"operators, E_exact={adapt.ground_state_energy}")
    return adapt


def timed_select(adapt, label, calls=2):
    """select_operator() ``calls`` times from the empty ansatz: the first
    call pays one-time set-up (host-to-device term arrays, layouts, lazy
    CUDA module loads); returns the selection, its gradients and the last
    call's host-clock ms."""
    import torch

    times, picks = [], []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        picks.append(adapt.select_operator())
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    selected, grads = picks[0]
    if any(again[0] != selected for again in picks[1:]):
        raise AssertionError(f"{label}: two selections from the same state differ")
    log(f"  [{label}] select_operator: {len(selected)} operators, max |g|={max(grads):.6f}, "
        + ", ".join(f"{t:.1f}" for t in times) + " ms")
    return selected, grads, times[-1]


def inner_launches(tiles, n):
    """Launches of the inner-product tile kernel for one call over
    ``tiles`` at n qubits on this card: one per chunk of tiles whose
    partials fit ``PARTIALS_CAP``."""
    import torch

    from qsfh_torch.engine import kernels as K

    positions = tiles.schedule(n, K.sm_count(torch.device("cuda")))[0]
    return len(tiles.chunks(-(-(1 << (n - tiles.k)) // positions), K.PARTIALS_CAP))


def resident_expected(adapt):
    """Launches per selection from the empty ansatz (the Givens network
    forward and inverse, H w, the pool screen) and per train step (the
    bench segment forward and its adjoint sweep, H psi, E, Sz, S^2) at 18
    qubits, from the resident tile layouts: one resident launch per span
    of tile runs, one per-term launch per term that fits no tile."""
    from qsfh_torch.engine import kernels as K
    from qsfh_torch.engine import streaming
    from qsfh_torch.engine.compiled import CompiledCircuit

    n = adapt.n_qubits
    net = CompiledCircuit(adapt._net_ops, n).segments[0]
    seg = CompiledCircuit(adapt._ansatz_ops(range(N_ANSATZ)) + adapt._net_ops, n).segments[0]

    def layout(s, direction):
        return s.tiles(direction, n, streaming.RESIDENT_TILE_BITS,
                       streaming.RESIDENT_TILE_LOW_BITS)

    def spans(lay):
        return sum(tiles is not None for tiles, _, _ in lay.spans)

    sel = (layout(net, 1), layout(net, -1))
    fwd, adj = layout(seg, 1), layout(seg, -1)
    obs = adapt.problem.observables
    h = obs["H"].groups()  # H psi: one launch per tile
    spill = int(bool(h.spill_index.size))  # the per-term kernel for masks that fit no tile
    pool = adapt.packed_pool.inner_groups()
    expect = [obs[k].inner_groups() for k in ("H", "Sz", "S^2")]
    zero = dict.fromkeys(K.launch_counts(), 0)
    per_select = dict(zero, rotation_resident=sum(map(spans, sel)),
                      pauli_rotation=sum(lay.n_single for lay in sel), pauli_apply=spill,
                      pauli_apply_grouped=h.n_tiles, screen_grouped=inner_launches(pool, n),
                      pauli_inner=int(bool(pool.spill_index.size)))
    per_step = dict(zero, rotation_resident=spans(fwd), adjoint_resident=spans(adj),
                    pauli_rotation=fwd.n_single, adjoint_rotation=adj.n_single, pauli_apply=spill,
                    pauli_apply_grouped=h.n_tiles,
                    expectation_grouped=sum(inner_launches(t, n) for t in expect),
                    pauli_inner=sum(bool(t.spill_index.size) for t in expect))
    return per_select, per_step, dict(forward=fwd.n_runs, adjoint=adj.n_runs,
                                      network=[lay.n_runs for lay in sel])


def phase_main_path(adapt, dev, tmp):
    import torch

    from qsfh_torch.engine import kernels as K

    if adapt.dtype != torch.complex64:
        raise AssertionError(f"expected complex64 on cuda, got {adapt.dtype}")
    results = {}
    per_select, per_step, runs = resident_expected(adapt)
    if (per_select["rotation_resident"], per_step["rotation_resident"],
            per_step["adjoint_resident"]) != (2, 1, 1) or per_select["pauli_rotation"] or \
            per_step["pauli_rotation"] or per_step["adjoint_rotation"]:
        raise AssertionError(f"a 3x3 term fits no resident tile: {per_select}, {per_step}")
    K.reset_launch_counts()
    selected, grads, results["select_ms"] = timed_select(adapt, "kernels")
    select_counts = K.launch_counts()
    K.reset_launch_counts()
    results["steps"] = bench_steps(adapt, dev)
    step_counts = K.launch_counts()
    check_steps(results["steps"], CONFIG["n_spin_up"], CONFIG["n_spin_down"], "kernels")
    log(f"  launches: 2 selections {select_counts}; {N_STEPS} steps {step_counts}")
    for what, got, per, times in (("selection", select_counts, per_select, 2),
                                  ("train step", step_counts, per_step, N_STEPS)):
        want = {name: times * v for name, v in per.items()}
        if got != want:
            raise AssertionError(f"{what} launches {got}, the resident layouts predict {want}")
    log(f"  launches match the resident layouts: per step 1 rotation_resident ({runs['forward']} "
        f"runs) + 1 adjoint_resident ({runs['adjoint']} runs), per selection 2 "
        f"rotation_resident ({runs['network']} runs), no per-term rotation; H psi "
        f"{per_step['pauli_apply_grouped']} pauli_apply_grouped launches (one per tile) and "
        f"{per_step['pauli_apply']} pauli_apply; E, Sz, S^2 {per_step['expectation_grouped']} "
        f"expectation_grouped launches, the pool {per_select['screen_grouped']} screen_grouped, "
        f"{per_step['pauli_inner']} / {per_select['pauli_inner']} pauli_inner per step / "
        f"selection")
    results.update(launches_per_select=per_select, launches_per_step=per_step, runs=runs)

    run_adapt = build_adapt(dev, tmp, "run", max_inner_iterations=3)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_adapt.run()
    torch.cuda.synchronize()
    results["run_s"] = time.perf_counter() - t0
    run_counts = K.launch_counts()
    losses = res["iteration loss"]
    if len(losses) != 3 or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"run(): expected 3 finite losses, got {losses}")
    if sorted(run_adapt.selected_indices) != sorted(selected):
        raise AssertionError("run() selected other operators than select_operator()")
    if not os.path.exists(run_adapt.model_filepath):
        raise AssertionError("run() wrote no checkpoint")
    counts = {name: select_counts[name] + step_counts[name] + run_counts[name]
              for name in run_counts}
    results["launches"] = counts
    log(f"  run(): {len(run_adapt.selected_indices)} operators, losses {losses}, "
        f"{results['run_s']:.2f} s, launches {run_counts}")
    log(f"  launches on the main path: {counts}")
    on_path = RESIDENT_KERNELS + ("pauli_apply_grouped", "expectation_grouped", "screen_grouped")
    for name, c in run_counts.items():
        if (c > 0) != (name in on_path):
            raise AssertionError(f"{name}: {c} launches in the 18-qubit run()")

    # the same selection and steps through the plain versions on the card
    plain = build_adapt(dev, tmp, "plain")
    plain.impl = K.PLAIN
    K.reset_launch_counts()
    plain_selected, _, results["plain_select_ms"] = timed_select(plain, "plain")
    results["plain_steps"] = bench_steps(plain, dev)
    check_steps(results["plain_steps"], CONFIG["n_spin_up"], CONFIG["n_spin_down"], "plain")
    if any(K.launch_counts().values()):
        raise AssertionError("the plain path launched a CUDA kernel")
    check_selection(empty_ansatz_gradients(adapt), empty_ansatz_gradients(plain), selected,
                    plain_selected)
    compare_steps(results["steps"], results["plain_steps"], STEP_TOLERANCES)
    return results


# -- phases 4 and 5: 24 qubits ------------------------------------------------------


@contextlib.contextmanager
def chain_cap(cap):
    """The engine with its rotation cap set to ``cap`` (None keeps it): the
    resident rotations up to it, the tile runs above."""
    from qsfh_torch.engine import streaming

    saved = streaming.CHAIN_MAX_QUBITS
    if cap is not None:
        streaming.CHAIN_MAX_QUBITS = cap
    try:
        yield
    finally:
        streaming.CHAIN_MAX_QUBITS = saved


def per_term_impl():
    """The engine's kernels with the per-term rotation and adjoint in place
    of the resident ones, the per-term ``pauli_apply`` in place of the
    application tiles and the per-term ``pauli_inner``, folded in torch, in
    place of the folded inner-product tiles: the first route of the port,
    one launch per rotation term up to the chain cap, on the same spans."""
    import torch

    from qsfh_torch.engine import kernels as K

    def rotation(psi, xs, zs, angles, phre, phim, tiles):
        return K.pauli_rotation(psi, xs, zs, angles, phre, phim)

    def adjoint(psi, lam, xs, zs, angles, phre, phim, tiles):
        return K.adjoint_rotation(psi, lam, xs, zs, angles, phre, phim)

    def apply(psi, xs, zs, cre, cim, tiles):
        return K.pauli_apply(psi, xs, zs, cre, cim)

    def expectation(psi, xs, zs, cre, cim, tiles):
        return (K.pauli_inner(psi, psi, xs, zs) * torch.complex(cre, cim)).real.sum()

    def screen(w, psi, xs, zs, cre, cim, tiles):
        return 2.0 * (K.pauli_inner(w, psi, xs, zs) * torch.complex(cre, cim)).imag

    return dataclasses.replace(K.KERNELS, rotation_resident=rotation, adjoint_resident=adjoint,
                               apply_grouped=apply, expectation_grouped=expectation,
                               screen_grouped=screen)


@contextlib.contextmanager
def per_term_route():
    """The old route of one per-term launch at every n: yields the Impl."""
    from qsfh_torch.engine import kernels as K

    with chain_cap(K.MAX_QUBITS):
        yield per_term_impl()


def tilted_state(v, n):
    """v with every amplitude scaled by 1.5 per clear bit and 0.5 per set
    bit, normalised: each <Z_q> is about (1.5^2 - 0.5^2) / (1.5^2 + 0.5^2)
    = 0.8, so no spin symmetry cancels Sz or the diagonal S^2 terms."""
    import torch

    from qsfh_torch.engine.state import index_bits

    idx = index_bits(n, v.device)
    weight = torch.ones(v.shape[0], dtype=torch.float32, device=v.device)
    for q in range(n):
        weight *= 1.5 - ((idx >> q) & 1).to(torch.float32)
    del idx
    v = v * weight
    return v / torch.linalg.vector_norm(v)


def launches_of(fn):
    """(result, launch counts) of one call."""
    import torch

    from qsfh_torch.engine import kernels as K

    K.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in K.launch_counts().items() if v}


def phase_kernels_24(adapt, dev, sweep_tiles=False):
    """The stream route at n = 24 on the real 2x6 term arrays: against the
    plain versions, the old per-term route and the bound."""
    import numpy as np
    import torch

    from qsfh_torch.engine import kernels as K
    from qsfh_torch.engine import streaming
    from qsfh_torch.engine.compiled import CompiledCircuit, adjoint_sweep, run_segments

    n = adapt.n_qubits
    dim = 1 << n
    p = adapt.problem
    seg = CompiledCircuit(adapt._ansatz_ops(range(N_ANSATZ_24)) + adapt._net_ops, n).segments[0]
    T = len(seg)
    thetas = torch.full((N_ANSATZ_24,), 0.05, dtype=torch.float32, device=dev)
    d = seg.tensors(dev, torch.float32, N_ANSATZ_24)
    angles = torch.cat([thetas, thetas.new_ones(1)])[d["pidx"]] * d["scale"]
    rot = (d["xb"], d["zb"], angles, d["phre"], d["phim"])
    rev = tuple(a.flip(0) for a in rot)
    k, c = streaming.TILE_BITS, streaming.TILE_LOW_BITS
    layouts = {1: seg.tiles(1, n, k, c), -1: seg.tiles(-1, n, k, c)}
    adj_layout = layouts[-1]

    gen = torch.Generator(device=dev).manual_seed(24)

    def random_state():
        v = torch.randn(dim, dtype=torch.complex64, device=dev, generator=gen)
        return v / torch.linalg.vector_norm(v)

    psi = random_state()
    h = p.observables["H"]
    lam = 2.0 * h.apply_scan(psi)

    def describe(layout):
        return (f"tiles of {layout.k} bits (low {layout.c}): {layout.n_runs} runs, "
                f"{layout.n_groups} register groups, {layout.n_single} terms that fit no tile "
                f"= {layout.passes} state passes")

    log(f"24-qubit shapes: rot segment {T} terms; forward {describe(layouts[1])}; inverse "
        f"{describe(layouts[-1])}; adjoint {describe(adj_layout)}")

    results = {}

    def record(name, call, T_work, bytes_moved, errs, ms, plain_ms, old_ms, launches, passes,
               flops=None, library_ms=None, **extra):
        flops = FLOPS_PER_TERM_AMP[name] * T_work * dim if flops is None else flops
        b_ms, b_by = bound(bytes_moved, flops)
        entry = dict(call=call, terms=T_work, n=n, rel_err=max(e[0] for e in errs),
                     max_abs_err=max(e[1] for e in errs), ms=ms, plain_ms=plain_ms,
                     old_route_ms=old_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                     bytes=bytes_moved, flops=flops, launches=launches, passes=passes, **extra)
        results.setdefault(name, []).append(entry)
        log(f"  {call:34s} T={T_work:5d} rel_err={entry['rel_err']:.2e} (tol {STATE_RTOL:g}) "
            f"ms={ms:.4f} old_route_ms="
            + ("-" if old_ms is None else f"{old_ms:.3f}")
            + f" plain_ms={plain_ms:.1f} bound_ms={b_ms:.5f} ({b_by}) passes={passes} "
            f"launches={launches}"
            + ("" if library_ms is None else f" library_ms={library_ms:.4f}")
            + "".join(f" {k}={v}" for k, v in extra.items()))
        if entry["rel_err"] > STATE_RTOL:
            raise AssertionError(f"{name} ({call}) disagrees with its plain version")

    def errs_of(pairs):
        return [(rel_err(a, b), max_abs(a, b)) for a, b in pairs]

    term_bytes = T * 20

    # the forward segment and its inverse: tile runs (and any term that fits no tile)
    refs = {}
    for call, direction in (("forward segment (stream route)", 1),
                            ("inverse segment (stream route)", -1)):
        route = lambda impl: run_segments([seg], psi, thetas, n, direction=direction, impl=impl)
        got, launches = launches_of(lambda: route(K.KERNELS))
        plain_ms, refs[direction] = timed_once(lambda: route(K.PLAIN))
        with per_term_route() as per_term:
            old = route(per_term)
            old_ms = time_cuda(lambda: route(per_term), reps=2, warmup=0)
        errs = errs_of([(got, refs[direction]), (old, refs[direction])])
        ms = time_cuda(lambda: route(K.KERNELS), reps=5, warmup=1)
        record("rotation_tile_runs", call, T, 2 * 8 * dim + term_bytes, errs, ms, plain_ms,
               old_ms, launches, layouts[direction].passes)
    back = run_segments([seg], run_segments([seg], psi, thetas, n), thetas, n, direction=-1)
    drift = rel_err(back, psi)
    log(f"  forward then inverse: ||back - psi|| / ||psi|| = {drift:.2e} (tol 1e-4)")
    if drift > 1e-4:
        raise AssertionError("the inverse segment does not undo the forward one")

    def tile_spans(layout, arrs):
        return [(tiles, tuple(a[t0:t1] for a in arrs))
                for tiles, t0, t1 in layout.spans if tiles is not None]

    # the tile-run launches alone (the kernel's own time on the forward segment)
    fwd_spans = tile_spans(layouts[1], rot)
    T_tiles = sum(tiles.n_terms for tiles, _ in fwd_spans)
    buf = psi.clone()
    kernel_only = dict(rotation_tile_runs=dict(
        call=f"{layouts[1].n_runs} tile runs of the forward segment", terms=T_tiles,
        ms=time_cuda(lambda: [K.rotation_tile_runs(buf, *arrs, tiles)
                              for tiles, arrs in fwd_spans], reps=5, warmup=1),
        plain_ms=timed_once(lambda: [K.rotation_tile_runs_plain(buf, *arrs, tiles)
                                     for tiles, arrs in fwd_spans])[0],
        bound=bound(2 * 8 * dim + T_tiles * 20, 6 * T_tiles * dim)))

    # the adjoint sweep: per-term <lam|P psi>, psi0 and lambda0
    def sweep(impl):
        p1, l1 = psi.clone(), lam.clone()
        return adjoint_sweep(seg, p1, l1, rev, n, impl), p1, l1

    (v, p1, l1), launches = launches_of(lambda: sweep(K.KERNELS))
    plain_ms, (v_ref, p_ref, l_ref) = timed_once(lambda: sweep(K.PLAIN))
    with per_term_route() as per_term:
        v_old, p_old, l_old = sweep(per_term)
        old_ms = time_cuda(lambda: sweep(per_term), reps=2, warmup=0)
    errs = errs_of([(v, v_ref), (p1, p_ref), (l1, l_ref), (v_old, v_ref), (p_old, p_ref)])
    ms = time_cuda(lambda: sweep(K.KERNELS), reps=5, warmup=1)
    record("adjoint_tile_runs", "adjoint sweep (stream route)", T,
           4 * 8 * dim + term_bytes + 8 * T, errs, ms, plain_ms, old_ms, launches,
           adj_layout.passes)
    adj_spans = tile_spans(adj_layout, rev)
    T_adj_tiles = sum(tiles.n_terms for tiles, _ in adj_spans)
    pb, lb = psi.clone(), lam.clone()
    kernel_only["adjoint_tile_runs"] = dict(
        call=f"{adj_layout.n_runs} tile runs of the adjoint sweep", terms=T_adj_tiles,
        ms=time_cuda(lambda: [K.adjoint_tile_runs(pb, lb, *arrs, tiles)
                              for tiles, arrs in adj_spans], reps=5, warmup=1),
        plain_ms=timed_once(lambda: [K.adjoint_tile_runs_plain(pb, lb, *arrs, tiles)
                                     for tiles, arrs in adj_spans])[0],
        bound=bound(4 * 8 * dim + T_adj_tiles * 28, 20 * T_adj_tiles * dim))
    if sweep_tiles:
        results["tile_sweep"] = sweep_tile_sizes(seg, n, rot, rev, psi, lam, refs[1], v_ref)

    # the engine's inner products (the folded tile wrappers on its layouts):
    # H, S^2 (a = psi) and the pool (a = w) on the main path's state psi =
    # U(theta) psi_0 and w = H psi.  There every <Z_q> cancels to ~1e-7
    # (half filling, uniform density), far below the floor of fold_err,
    # so Sz and S^2 are also held on a state tilted toward empty modes,
    # where <Z_q> ~ 0.8 and a wrong Sz or diagonal S^2 term cannot hide
    # under the floor.  Each also as v_t in input order
    # (pauli_inner_grouped on the same layout).
    psi = run_segments([seg], adapt._initial_state(), thetas, n)
    w = h.apply_scan(psi)
    tilted = tilted_state(random_state(), n)
    pool = adapt.packed_pool
    for call, a, b, owner in (
        ("<psi|H|psi>", psi, psi, h),
        ("<psi|S^2|psi>", psi, psi, p.observables["S^2"]),
        ("<t|Sz|t>, tilted state", tilted, tilted, p.observables["Sz"]),
        ("<t|S^2|t>, tilted state", tilted, tilted, p.observables["S^2"]),
        ("pool screen <w|P|psi>", w, psi, pool),
    ):
        xs, zs, c = owner._tensors(b)[:3]
        layout = owner.inner_groups()
        name, fns = fold_fns(owner, a, b)
        n_masks = len(np.unique(xs.cpu().numpy()))
        plain_ms, v_ref = timed_once(lambda: K.pauli_inner_grouped_plain(a, b, xs, zs, layout))
        ref = (c * v_ref).real.sum() if a is b else 2.0 * (c * v_ref).imag
        got, launches = launches_of(fns["tiles"])
        again = fns["tiles"]()
        inner = lambda: K.pauli_inner_grouped(a, b, xs, zs, layout)  # noqa: E731
        v, v_launches = launches_of(inner)
        old = fns["per-term"]()
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"{name} ({call}) at 24 qubits: two calls give other bits")
        old_ms = time_cuda(fns["per-term"], reps=2, warmup=0)
        ms = time_cuda(fns["tiles"], reps=5, warmup=1)
        v_ms = time_cuda(inner, reps=5, warmup=1)
        split = host_device_split(fns["tiles"], reps=split_reps(ms))
        scale = fold_scale(owner, a, b)
        ab = float(torch.linalg.vector_norm(a) * torch.linalg.vector_norm(b))
        n_inputs = 1 if a is b else 2
        positions, units = layout.schedule(n, K.sm_count(b.device))
        passes = (f"{len(layout)} ({layout.n_tiles} tiles, {layout.n_items} items, "
                  f"{layout.n_diag} diagonal terms, {len(units)} units; {n_masks} flip masks)")
        flops = inner_bound_flops(xs, a is b, layout, dim)
        record(name, call, len(xs), n_inputs * 8 * dim + 16 * len(xs),
               [(fold_err(got, ref, scale), max_abs(got, ref)),
                (fold_err(old, ref, scale), max_abs(old, ref))], ms, plain_ms, old_ms, launches,
               passes, flops=flops, device_ms=split["device_ms"], host_ms=split["host_ms"])
        record("pauli_inner_grouped", call + " (v_t)", len(xs), n_inputs * 8 * dim + 16 * len(xs),
               [inner_err(v, v_ref, ab)], v_ms, plain_ms, None, v_launches, passes, flops=flops)
        if sweep_tiles and a is not tilted:
            results.setdefault("inner_tile_sweep", {})[call] = sweep_inner_tile_sizes(
                call, n, owner, a, b, ref)
    del tilted

    # H psi: the tile kernel (the engine's route) beside the per-term pauli_apply
    hx, hz, hc = h._tensors(psi)
    hargs = (hx, hz, hc.real, hc.imag)
    htiles = h.groups()
    got, launches = launches_of(lambda: K.pauli_apply_grouped(psi, *hargs, htiles))
    again = K.pauli_apply_grouped(psi, *hargs, htiles)
    old, old_launches = launches_of(lambda: K.pauli_apply(psi, *hargs))
    plain_ms, ref = timed_once(lambda: K.pauli_apply_plain(psi, *hargs))
    if not torch.equal(got, again):
        raise AssertionError("pauli_apply_grouped at 24 qubits: two calls give other bits")
    ms = in_turns({"tiles": lambda: K.pauli_apply_grouped(psi, *hargs, htiles),
                   "per-term": lambda: K.pauli_apply(psi, *hargs)}, reps=5)
    library_ms = library_sparse_apply(psi, hx, hz, hc, ref)
    passes = f"{len(htiles)} ({htiles.n_tiles} tiles, {htiles.n_items} items)"
    record("pauli_apply_grouped", "lambda = H psi (tiles)", len(hx), 2 * 8 * dim + 16 * len(hx),
           errs_of([(got, ref)]), ms["tiles"], plain_ms, ms["per-term"], launches, passes,
           flops=apply_flops(hx, hc, htiles, dim), library_ms=library_ms)
    record("pauli_apply", "lambda = H psi (pauli_apply)", len(hx), 2 * 8 * dim + 16 * len(hx),
           errs_of([(old, ref)]), ms["per-term"], plain_ms, None, old_launches, 1,
           flops=apply_flops(hx, hc, htiles, dim), library_ms=library_ms)
    if sweep_tiles:
        results["apply_tile_sweep"] = sweep_apply_tile_sizes(h, psi, ref)
    for name, k in kernel_only.items():
        b_ms, b_by = k["bound"]
        log(f"  {name} alone: {k['call']}, {k['terms']} terms: {k['ms']:.4f} ms, "
            f"plain {k['plain_ms']:.1f} ms, bound {b_ms:.5f} ms ({b_by})")
    return results, kernel_only


def sweep_tile_sizes(seg, n, rot, rev, psi, lam, ref, v_ref):
    """The tile-run kernels on the 2x6 segment over other tile sizes (k
    bits, the low c): ms per forward segment and adjoint sweep (CUDA
    events), state passes and register groups, each held to the plain
    results of the shipped layout."""
    import torch

    from qsfh_torch.engine import kernels as K
    from qsfh_torch.engine.streaming import TileLayout

    rows = []
    xs, zs = seg.data["xb"], seg.data["zb"]
    for what in ("forward", "adjoint"):
        for k in (12, 13):
            for c in (4, 5):
                if what == "forward":
                    layout = TileLayout(xs, zs, n, k, c)
                    spans = [(t, tuple(a[t0:t1] for a in rot)) for t, t0, t1 in layout.spans]

                    def call():
                        out = psi.clone()
                        for tiles, arrs in spans:
                            K.rotation_tile_runs(out, *arrs, tiles)
                        return out
                    err = rel_err(call(), ref)
                else:
                    layout = TileLayout(xs[::-1], zs[::-1], n, k, c)
                    spans = [(t, tuple(a[t0:t1] for a in rev)) for t, t0, t1 in layout.spans]

                    def call():
                        p1, l1 = psi.clone(), lam.clone()
                        return [K.adjoint_tile_runs(p1, l1, *arrs, tiles) for tiles, arrs in spans]
                    err = rel_err(torch.cat(call()), v_ref)
                if layout.n_single or err > STATE_RTOL:
                    raise AssertionError(f"tile sweep {what} k={k} c={c}: error {err:.2e}")
                ms = time_cuda(call, reps=5, warmup=1)
                rows.append(dict(call=what, k=k, c=c, ms=ms, passes=layout.passes,
                                 groups=layout.n_groups, rel_err=err))
                log(f"  tiles {what:8s} k={k} c={c}: {ms:.4f} ms, {layout.passes} passes, "
                    f"{layout.n_groups} register groups, rel_err {err:.2e}")
    return rows


# (k, c, most items a tile) of the inner-product tiles that --tiles times
INNER_TILE_SHAPES = ((12, 4, 128), (12, 2, 128), (13, 4, 128), (13, 2, 128), (11, 4, 128),
                     (11, 2, 128), (10, 2, 128), (12, 2, 32))
# (k, c, most items a tile) of the application tiles that --tiles times:
# the inner-product shapes and smaller tiles (more blocks a launch where
# the state is small)
APPLY_TILE_SHAPES = INNER_TILE_SHAPES[:5] + ((11, 2, 128), (10, 2, 128), (12, 2, 32))


def sweep_inner_tile_sizes(call, n, owner, a, b, ref):
    """The folded inner-product call on ``owner`` (the pool screen, H, Sz
    or S^2) over tile shapes (k bits, the low c) and item caps, each
    layout the engine's kind (the x = 0 terms as one diagonal): device and
    host ms per call (:func:`host_device_split`), state passes, units and
    blocks, each held to the plain result ``ref``."""
    from qsfh_torch.engine import kernels as K
    from qsfh_torch.engine.streaming import GroupTiles

    rows = []
    hx, hz = (v.cpu().numpy() for v in owner._tensors(b)[:2])
    scale = fold_scale(owner, a, b)
    for k, c, cap in INNER_TILE_SHAPES:
        tiles = GroupTiles(hx, hz, n, k, c, cap, diagonal=False, inner_diagonal=True)
        _, fns = fold_fns(owner, a, b, tiles)
        err = fold_err(fns["tiles"](), ref, scale)
        if tiles.spill_index.size or err > STATE_RTOL:
            raise AssertionError(f"inner tile sweep {call} k={k} c={c} cap={cap}: error {err:.2e}")
        split = host_device_split(fns["tiles"], reps=50)
        positions, units = tiles.schedule(n, K.sm_count(b.device))
        blocks = len(units) * -(-(1 << (n - k)) // positions)
        rows.append(dict(k=k, c=c, max_items=cap, **split, passes=len(tiles), units=len(units),
                         blocks=blocks, rel_err=err))
        log(f"  inner tiles, {call} n={n}: k={k} c={c} max_items={cap}: device "
            f"{ms_text(split['device_ms'])}, graph {split['graph_ms']:.4f} ms, host "
            f"{split['host_ms']:.4f} ms, {len(tiles)} passes, {len(units)} units, {blocks} blocks, "
            f"rel_err {err:.2e}")
    return rows


def empty_ansatz_gradients(adapt):
    """The signed pool gradients that a selection from the empty ansatz
    screens (numpy)."""
    return adapt._screen_for(())(adapt.params_t[:0]).cpu().numpy()


def check_selection(grads, plain_grads, selected, plain_selected):
    """Gradients within GRAD_RTOL of max |grad|; the same selected set
    unless the gap at the selection boundary is within that tolerance."""
    import numpy as np

    tol = GRAD_RTOL * float(np.abs(plain_grads).max())
    diff = float(np.abs(grads - plain_grads).max())
    log(f"  selection gradients: max |kernel - plain| = {diff:.3e} (tol {tol:.3e})")
    if diff > tol:
        raise AssertionError("the kernel path's pool gradients disagree with the plain path's")
    if set(selected) == set(plain_selected):
        log(f"  same selected set: {sorted(selected)}")
        return
    g = np.abs(plain_grads)
    chosen = np.zeros(g.size, bool)
    chosen[list(plain_selected)] = True
    gap = g[chosen].min() - (g[~chosen].max() if (~chosen).any() else 0.0)
    log(f"  selected sets differ ({sorted(selected)} vs {sorted(plain_selected)}); "
        f"boundary gap {gap:.3e}")
    if gap > tol:
        raise AssertionError("the selected operators differ beyond a tie")


def phase_main_path_24(adapt, dev, tmp):
    """One selection and N_STEPS steps of ``adapt`` (2x6) on the kernels,
    then one selection and N_PLAIN_STEPS_24 steps on the plain versions."""
    import numpy as np

    from qsfh_torch.engine import kernels as K
    from qsfh_torch.engine import streaming
    from qsfh_torch.engine.compiled import CompiledCircuit

    up, down = CONFIG_24["n_spin_up"], CONFIG_24["n_spin_down"]
    results = {}
    K.reset_launch_counts()
    selected, _, results["select_ms"] = timed_select(adapt, "kernels 24q")
    results["steps"] = bench_steps(adapt, dev, N_ANSATZ_24, N_STEPS)
    counts = K.launch_counts()
    grads = empty_ansatz_gradients(adapt)
    results["launches"] = counts
    check_steps(results["steps"], up, down, "kernels 24q", e_floor=None)
    log(f"  launches on the 24-qubit main path: {counts}")

    # the counts the layouts predict: 2 selections (network forward and
    # inverse, the pool) and N_STEPS steps (segment forward and adjoint;
    # H, Sz, S^2; H psi)
    n = adapt.n_qubits
    net = CompiledCircuit(adapt._net_ops, n).segments[0]
    seg = CompiledCircuit(adapt._ansatz_ops(range(N_ANSATZ_24)) + adapt._net_ops, n).segments[0]
    k, c = streaming.TILE_BITS, streaming.TILE_LOW_BITS
    obs = adapt.problem.observables

    inner = [adapt.packed_pool.inner_groups()] + [obs[k].inner_groups()
                                                  for k in ("H", "Sz", "S^2")]
    sel = [net.tiles(1, n, k, c), net.tiles(-1, n, k, c)]
    fwd, adj = seg.tiles(1, n, k, c), seg.tiles(-1, n, k, c)
    expected = dict(
        dict.fromkeys(K.launch_counts(), 0),  # every other kernel: none
        pauli_rotation=2 * sum(t.n_single for t in sel) + N_STEPS * fwd.n_single,
        adjoint_rotation=N_STEPS * adj.n_single,
        rotation_tile_runs=2 * sum(t.n_runs for t in sel) + N_STEPS * fwd.n_runs,
        adjoint_tile_runs=N_STEPS * adj.n_runs,
        pauli_inner_grouped=0,
        screen_grouped=2 * inner_launches(inner[0], n),
        expectation_grouped=N_STEPS * sum(inner_launches(t, n) for t in inner[1:]),
        pauli_apply=0,
        pauli_apply_grouped=(2 + N_STEPS) * obs["H"].groups().n_tiles,
        pauli_inner=0,
        xor_gather=0,
        rotation_resident=0,
        adjoint_resident=0,
        pauli_rotation_out=0,
        expectation_norm_f64=0,
    )
    if counts != expected:
        raise AssertionError(f"24-qubit launches {counts}, the layouts predict {expected}")
    if counts["pauli_rotation"] or counts["adjoint_rotation"]:
        raise AssertionError("a 2x6 term fits no tile: the per-term kernels ran")
    if any(t.spill_index.size for t in inner):
        raise AssertionError("a 2x6 flip mask fits no inner tile: the per-term kernel ran")
    if counts["pauli_apply"]:
        raise AssertionError("H psi took the per-term pauli_apply at 24 qubits")
    # one partial-sum pass per adjoint sweep: the whole sweep's partials fit one chunk
    if len(seg) << (n - k) > K.SWEEP_PARTIALS_CAP:
        raise AssertionError("the adjoint sweep's partials take more than one chunk")
    log(f"  launches match the layouts: {fwd.n_runs} forward and {adj.n_runs} adjoint tile "
        f"runs per step, {sum(t.n_runs for t in sel)} network runs per selection, no "
        f"per-term rotation; one partial-sum pass per adjoint sweep; inner-product state passes "
        f"per call: pool {len(inner[0])}, H {len(inner[1])}, Sz {len(inner[2])}, "
        f"S^2 {len(inner[3])}, no per-term pass; H psi {obs['H'].groups().n_tiles} "
        f"pauli_apply_grouped launches, no pauli_apply")
    results["inner_passes"] = dict(zip(("pool", "H", "Sz", "S^2"), map(len, inner)))

    plain = build_adapt(dev, tmp, "plain24", CONFIG_24)
    plain.impl = K.PLAIN
    K.reset_launch_counts()
    plain_selected, _, results["plain_select_ms"] = timed_select(plain, "plain 24q", calls=1)
    plain_grads = empty_ansatz_gradients(plain)
    results["plain_steps"] = bench_steps(plain, dev, N_ANSATZ_24, N_PLAIN_STEPS_24)
    check_steps(results["plain_steps"], up, down, "plain 24q", e_floor=None)
    if any(K.launch_counts().values()):
        raise AssertionError("the plain path launched a CUDA kernel")
    check_selection(grads, plain_grads, selected, plain_selected)
    compare_steps(results["steps"], results["plain_steps"], STEP_TOLERANCES_24)
    results["max_grad"] = float(np.abs(grads).max())
    return results


def built_for(adapt, impl, indices):
    """(train step, selection from the empty ansatz) of ``adapt`` built on
    ``impl`` (the driver takes its Impl when it builds them)."""
    saved = adapt.impl, adapt._screen_cache
    adapt.impl, adapt._screen_cache = impl, {}
    try:
        return adapt._build_step(indices), adapt._screen_for(())
    finally:
        adapt.impl, adapt._screen_cache = saved


def phase_routes(cases, dev, out, rounds=15):
    """The routes at each size, in one process: each call family of a
    train step and a selection, then the whole step and selection.  The
    per-term route (one launch per rotation term, per-term inner
    products and applications), the resident route (one launch per span,
    at 18 and 20 qubits), the stream route (one launch per tile run) and
    the engine's own cap (``streaming``), the last three with the inner
    and application tiles, take turns, one call each per round and each round
    starting one route later, so a slow spell of the shared host, or the
    card's state after a route, falls on all of them; host-clock ms per call, each
    ended by a device sync, median and least over ``rounds`` rounds after
    two warm-up rounds."""
    import torch

    from qsfh_torch.engine import kernels as K
    from qsfh_torch.engine.compiled import CompiledCircuit, run_rot_adjoint, run_segments

    rows = out.setdefault("routes", [])
    for label, adapt, n_ansatz in cases:
        n = adapt.n_qubits
        obs = adapt.problem.observables
        seg = CompiledCircuit(adapt._ansatz_ops(range(n_ansatz)) + adapt._net_ops, n).segments[0]
        thetas = torch.full((n_ansatz,), 0.05, dtype=adapt._rdt, device=dev)
        psi = run_segments([seg], adapt._initial_state(), thetas, n)
        lam = 2.0 * obs["H"].apply_scan(psi)
        params = thetas.clone()
        optimizer = torch.optim.Adam([params], lr=1e-2)
        # (route, chain cap, Impl); a cap of None keeps the engine's
        routes = [("per-term", K.MAX_QUBITS, per_term_impl()),
                  ("resident", K.MAX_QUBITS, K.KERNELS),
                  ("stream", n - 1, K.KERNELS), ("caps", None, K.KERNELS)]
        if n > 20:
            routes = [r for r in routes if r[0] != "resident"]
        built = {route: built_for(adapt, impl, tuple(range(n_ansatz))) for route, _, impl in routes}
        impls = {route: impl for route, _, impl in routes}
        calls = (
            ("forward segment", lambda r: run_segments([seg], psi, thetas, n, impl=impls[r])),
            ("adjoint sweep", lambda r: run_rot_adjoint(seg, psi, lam, thetas, n, impl=impls[r])),
            ("E, Sz, S^2", lambda r: [obs[k].expectation_scan(psi, impl=impls[r])
                                      for k in ("H", "Sz", "S^2")]),
            ("H psi", lambda r: obs["H"].apply_scan(psi, impl=impls[r])),
            ("pool screen", lambda r: adapt.packed_pool.screen_scan(psi, lam, impl=impls[r])),
            ("train step", lambda r: built[r][0](params, optimizer)),
            ("selection", lambda r: built[r][1](params[:0])),
        )
        for call, fn in calls:
            times = {route[0]: [] for route in routes}
            for r in range(rounds + 2):
                # each round starts one route later: no route always follows the same one
                for route, cap, _ in routes[r % len(routes):] + routes[:r % len(routes)]:
                    with chain_cap(cap):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        fn(route)
                        torch.cuda.synchronize()
                    if r >= 2:
                        times[route].append(1e3 * (time.perf_counter() - t0))
            ms = {route: sorted(t)[len(t) // 2] for route, t in times.items()}
            least = {route: min(t) for route, t in times.items()}
            for route in times:
                rows.append(dict(lattice=label, n=n, call=call, route=route, ms=ms[route],
                                 least_ms=least[route]))
            log(f"  {label} (n={n}) {call:16s} " + ", ".join(
                f"{route} {ms[route]:9.3f} ({least[route]:9.3f})" for route in times)
                + f" ms; stream / per-term {ms['stream'] / ms['per-term']:.3f}"
                + ("" if "resident" not in ms else
                   f", resident / per-term {ms['resident'] / ms['per-term']:.3f}"))


def fold_err(got, ref, scale):
    """|got - ref| / max(|ref|, scale) of a folded result (a 0-d
    expectation or a vector of screening gradients), with ``scale`` the
    largest value the terms could sum to (sum_t |c_t| ||a|| ||psi||):
    float32 sums over 2^n products carry an absolute error of that order
    times the rounding, whatever the value (Sz cancels to ~1e-7 on a
    spin-symmetric state)."""
    import torch

    den = max(float(torch.linalg.vector_norm(ref)), scale)
    return float(torch.linalg.vector_norm(got - ref)) / den


def split_reps(ms):
    """Back-to-back calls for :func:`host_device_split`: about 100 ms of
    work, 5 to 200 calls."""
    return int(min(200, max(5, 100.0 / max(ms, 1e-3))))


def unfolded_impl():
    """The engine's kernels with the inner-product tiles returning v_t
    (``pauli_inner_grouped``) and the coefficients folded in torch, as the
    parent of the folded wrappers ran them past 18 qubits."""
    import torch

    from qsfh_torch.engine import kernels as K

    def expectation(psi, xs, zs, cre, cim, tiles):
        return (K.pauli_inner_grouped(psi, psi, xs, zs, tiles) * torch.complex(cre, cim)).real.sum()

    def screen(w, psi, xs, zs, cre, cim, tiles):
        return 2.0 * (K.pauli_inner_grouped(w, psi, xs, zs, tiles) * torch.complex(cre, cim)).imag

    return dataclasses.replace(K.KERNELS, expectation_grouped=expectation, screen_grouped=screen)


def phase_inner_routes(cases, dev, out, rounds=5):
    """The inner-product routes on the same inputs at each size, as the
    engine calls them: the pool screen (``PackedPool.screen_scan``, a = w
    = H psi) and the expectation values of H and S^2 (a = psi) and of Sz
    on a tilted state (``Observable.expectation_scan``); "per-term" is the
    per-term ``pauli_inner`` folded in torch (the parent's 18-qubit
    route), "unfolded" ``pauli_inner_grouped`` on the engine's layout
    folded in torch, "tiles" the engine's folded wrappers.  CUDA events,
    the routes in turns each round, median over ``rounds`` rounds of 3
    calls, then each one's device and host ms per call
    (:func:`host_device_split`); each held to the per-term result
    (:func:`fold_err`).  Then the two application kernels on H psi
    (``pauli_apply``, ``pauli_apply_grouped``, the latter also on the same
    layout without its diagonal), the same way."""
    import torch

    from qsfh_torch.engine import kernels as K
    from qsfh_torch.engine.streaming import GroupTiles

    rows = out.setdefault("inner_routes", [])
    impls = (("per-term", per_term_impl()), ("unfolded", unfolded_impl()), ("tiles", K.KERNELS))
    for label, adapt in cases:
        n = adapt.n_qubits
        gen = torch.Generator(device=dev).manual_seed(n)
        psi = torch.randn(1 << n, dtype=torch.complex64, device=dev, generator=gen)
        psi /= torch.linalg.vector_norm(psi)
        obs = adapt.problem.observables
        w = obs["H"].apply_scan(psi)
        tilted = tilted_state(psi, n)
        pool = adapt.packed_pool
        for call, owner, a, b in (("pool screen", pool, w, psi), ("H terms", obs["H"], psi, psi),
                                  ("Sz terms, tilted state", obs["Sz"], tilted, tilted),
                                  ("S^2 terms", obs["S^2"], psi, psi)):
            tiles = owner.inner_groups()
            scale = fold_scale(owner, a, b)

            def engine(impl, owner=owner, a=a, b=b):
                if owner is pool:
                    return lambda: pool.screen_scan(b, a, impl=impl)
                return lambda: owner.expectation_scan(b, impl=impl)

            routes = tuple((route, engine(impl)) for route, impl in impls)
            ref = routes[0][1]()
            for route, f in routes[1:]:
                err = fold_err(f(), ref, scale)
                if err > STATE_RTOL:
                    raise AssertionError(
                        f"{label} {call}: {route} disagrees with per-term ({err:.2e})")
            times = {route: [] for route, _ in routes}
            for r in range(rounds):
                for route, f in routes:
                    times[route].append(time_cuda(f, reps=3, warmup=1 if r == 0 else 0))
            ms = {route: sorted(t)[len(t) // 2] for route, t in times.items()}
            split = {route: host_device_split(f, reps=split_reps(ms[route])) for route, f in routes}
            rows.append(dict(lattice=label, n=n, call=call, ms=ms, split=split,
                             tile_passes=len(tiles), units=len(tiles.schedule(n, K.sm_count(dev))[1])))
            log(f"  {label} (n={n}) {call:22s} " + ", ".join(
                f"{route} {ms[route]:8.4f} ms (device {ms_text(split[route]['device_ms'])}, graph "
                f"{split[route]['graph_ms']:.4f} ms, host {split[route]['host_ms']:.4f} ms)"
                for route in ms) + f" ({len(tiles)} passes)")
        xs, zs, c = obs["H"]._tensors(psi)
        tiles = obs["H"].groups()
        flat = GroupTiles(*obs["H"]._scan_terms()[:2], n, tiles.k, tiles.c, diagonal=False)
        args = (psi, xs, zs, c.real, c.imag)
        routes = (("per-term", lambda: K.pauli_apply(*args)),
                  ("tiles", lambda: K.pauli_apply_grouped(*args, tiles)),
                  ("tiles, no diagonal", lambda: K.pauli_apply_grouped(*args, flat)))
        ref = routes[0][1]()
        for route, fn in routes[1:]:
            err = rel_err(fn(), ref)
            if err > STATE_RTOL:
                raise AssertionError(f"{label} H psi: {route} disagrees with per-term ({err:.2e})")
        times = {route: [] for route, _ in routes}
        for r in range(rounds):
            for route, fn in routes:
                times[route].append(time_cuda(fn, reps=3, warmup=1 if r == 0 else 0))
        ms = {route: sorted(t)[len(t) // 2] for route, t in times.items()}
        split = {route: host_device_split(fn, reps=split_reps(ms[route])) for route, fn in routes}
        rows.append(dict(lattice=label, n=n, call="H psi", ms=ms, split=split,
                         tile_passes=len(tiles)))
        log(f"  {label} (n={n}) {'H psi':12s} " + ", ".join(
            f"{route} {ms[route]:8.4f} ms (device {ms_text(split[route]['device_ms'])}, graph "
            f"{split[route]['graph_ms']:.4f} ms, host {split[route]['host_ms']:.4f} ms)"
            for route in ms) + f" ({len(tiles)} passes)")


def _device_kernels(prof):
    """(name, count, device us) of every device kernel in a profile."""
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        if getattr(ev, "is_user_annotation", False) or ("#" in ev.key and "(" not in ev.key):
            continue  # a range such as "Optimizer.step#Adam.step", not a kernel (whose
            # signature may hold a "{lambda(long)#1}")
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        rows.append((ev.key, ev.count, us))
    return sorted(rows, key=lambda r: -r[2])


def profile_phase(adapt, n_ansatz, step_ms, select_ms, out, label):
    """Device kernel time by name over 2 train steps and 1 selection
    (torch.profiler); the idle share compares the device kernel time with
    the unprofiled host-clock time of the same work."""
    import torch

    step = adapt._build_step(tuple(range(n_ansatz)))
    optimizer = torch.optim.Adam([adapt.params_t], lr=1e-2)
    step(adapt.params_t, optimizer)
    torch.cuda.synchronize()
    profile_calls((
        ("train step", 2, lambda: step(adapt.params_t, optimizer), step_ms),
        ("selection", 1, lambda: adapt._screen_for(())(adapt.params_t[:0]), select_ms),
    ), out, label)


def profile_hva(hva, step_ms, out, label):
    """Device kernel time by name over 2 HVA train steps (as profile_phase)."""
    import torch

    th = hva_thetas(hva)
    optimizer = torch.optim.Adam([th], lr=hva.lr)
    hva._step(th, optimizer)
    torch.cuda.synchronize()
    profile_calls((("train step", 2, lambda: hva._step(th, optimizer), step_ms),), out, label)


def profile_calls(calls, out, label):
    """Profile each (what, reps, fn, unprofiled ms per call) of ``calls``:
    device kernel time by name per call and the idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    prof_out = out.setdefault("profile", {})
    for what, reps, fn, ref_ms in calls:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = _device_kernels(prof)
        busy_ms = sum(r[2] for r in rows) / 1e3 / reps
        log(f"profile, {label} {what}: device kernel time {busy_ms:.3f} ms per call against "
            f"{ref_ms:.3f} ms unprofiled: idle share {1 - busy_ms / ref_ms:.3f}")
        for key, count, us in rows[:8]:
            log(f"  {us / 1e3 / reps:9.4f} ms  {count / reps:6.2f}x  {key[:80]}")
        prof_out[f"{label} {what}"] = dict(
            kernel_ms=busy_ms, unprofiled_ms=ref_ms, idle_share=1 - busy_ms / ref_ms,
            rows=[dict(name=k, launches=c / reps, device_ms=u / 1e3 / reps) for k, c, u in rows],
        )


def median_ms(rows):
    """Median host-clock ms of steps 2 and later (step 1 pays set-up)."""
    ms = sorted(r["ms"] for r in rows[1:])
    return ms[len(ms) // 2]


# -- --compare: the parent's port against this one -----------------------------------------


def load_port(root, alias):
    """The package ``qsfh_torch`` of the checkout ``root`` imported under the
    name ``alias`` (its imports of itself are relative), beside this
    checkout's: two ports in one process, each with its own kernel build."""
    import importlib
    import importlib.util

    init = os.path.join(os.path.abspath(root), "qsfh_torch", "__init__.py")
    spec = importlib.util.spec_from_file_location(
        alias, init, submodule_search_locations=[os.path.dirname(init)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return importlib.import_module(f"{alias}.algos.adapt").ADAPT


def phase_compare(parent, dev, tmp, out):
    """The parent's port (the checkout ``parent``, e.g. ``git archive`` of the
    parent commit unpacked into a directory .gitignore lists, loaded under
    another name) against this one in one process: on each lattice (3x3,
    2x6) an ADAPT of each, then rounds of parent, change, change, parent,
    each one selection from the empty ansatz and one train step of the
    main path's ansatz (host clock ended by a device sync, the step's
    metrics read as numbers, as :func:`bench_steps` does); medians of each
    side, and each side's device time from a profile of 2 steps and a
    selection (:func:`profile_phase`)."""
    import torch

    from qsfh_torch.algos.adapt import ADAPT

    ports = {"parent": load_port(parent, "qsfh_torch_parent"), "change": ADAPT}
    rows = out.setdefault("compare", {})
    for lattice, config, n_ansatz, rounds in (("3x3", CONFIG, N_ANSATZ, 12),
                                              ("2x6", CONFIG_24, N_ANSATZ_24, 3)):
        runs = {}
        for side, cls in ports.items():
            adapt = cls(n_epoch=1, results_root=os.path.join(tmp, f"compare_{side}_{lattice}"),
                        device=dev, **config)
            indices = tuple(range(n_ansatz))
            adapt.selected_indices = list(indices)
            adapt.params_t = torch.full((n_ansatz,), 0.05, dtype=adapt._rdt, device=dev)
            optimizer = torch.optim.Adam([adapt.params_t], lr=1e-2)
            step = adapt._build_step(indices)
            select = adapt._screen_for(())
            calls = {"selection": lambda s=select, a=adapt: s(a.params_t[:0]).cpu(),
                     "step": lambda s=step, a=adapt, o=optimizer: [float(v) for v in
                                                                   s(a.params_t, o)[2:]]}
            for fn in calls.values():  # set-up: layouts, term tensors, lazy module loads
                fn()
                fn()
            runs[side] = (adapt, calls)
        times = {side: {call: [] for call in ("selection", "step")} for side in ports}
        for _ in range(rounds):
            for side in ("parent", "change", "change", "parent"):
                for call, fn in runs[side][1].items():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    times[side][call].append(1e3 * (time.perf_counter() - t0))
        for side, (adapt, _) in runs.items():
            med = {call: sorted(v)[len(v) // 2] for call, v in times[side].items()}
            prof = {}
            profile_phase(adapt, n_ansatz, med["step"], med["selection"], prof, f"{side} {lattice}")
            rows[f"{side} {lattice}"] = dict(
                selection_ms=med["selection"], step_ms=med["step"], times=times[side],
                **{f"{what}_device_ms": prof["profile"][f"{side} {lattice} {what}"]["kernel_ms"]
                   for what in ("train step", "selection")})
        log(f"  {lattice}: " + "; ".join(
            f"{side} selection {rows[f'{side} {lattice}']['selection_ms']:.3f} ms, step "
            f"{rows[f'{side} {lattice}']['step_ms']:.3f} ms (host clock, median of "
            f"{2 * rounds}), device {rows[f'{side} {lattice}']['selection_device_ms']:.3f} / "
            f"{rows[f'{side} {lattice}']['train step_device_ms']:.3f} ms" for side in ports))


# -- --sweeps: the resident sweeps, launch by launch -----------------------------------------

SWEEP_ROUNDS = 6  # rounds of parent, change, change, parent (the change alone: one a round)
SWEEP_REPS = 20  # launches a CUDA-event timing


def first_terms(tiles, arrs, n):
    """The runs of ``tiles`` cut to their first term, nothing fused: the
    same passes over the state with almost no work inside (a run's fixed
    cost), and those terms' arrays."""
    import numpy as np
    import torch

    from qsfh_torch.engine import streaming

    idx = torch.as_tensor(tiles.run_start[:-1].astype(np.int64), device=arrs[0].device)
    sub = tuple(a[idx] for a in arrs)
    runs = [(r, r + 1, int(m)) for r, m in enumerate(tiles.run_mask)]
    return streaming.TileRuns(sub[0].cpu().numpy(), sub[1].cpu().numpy(), runs, n, tiles.k,
                              tiles.c), sub


def sweep_programs(dev):
    """The programs --sweeps times on the float32 resident kernels, each
    one span of resident tile runs both ways: [(label, n, forward span,
    adjoint span, forward arrays, reversed arrays)] for the committed
    1719-operator 3x3 checkpoint's train segment at its angles (14,123
    terms, 609 runs each way), the same runs cut to their first term
    (:func:`first_terms`) and HVA 3x3 reps = 10 (1017 terms, 80 runs) at
    :func:`hva_thetas`."""
    import torch

    from qsfh_torch.algos.adapt import ADAPT
    from qsfh_torch.algos.hva import HVA, hva_program_rot
    from qsfh_torch.engine.compiled import CompiledCircuit
    from qsfh_torch.ops.pool import hubbard_interaction_pool_extended

    adapt = ADAPT(n_epoch=0, threshold1=1e-3, threshold2=1e-3, results_root=DEMO_ADAPT,
                  pool=hubbard_interaction_pool_extended(3, 3), device=dev, **ANALYSIS_3X3)
    hva = HVA(n_epoch=0, reps=10, lr=1e-2, results_root=DEMO_HVA, device=dev, **ANALYSIS_3X3)
    n = adapt.n_qubits
    programs = []
    for label, ops, thetas in (
            ("3x3 checkpoint", adapt._ansatz_ops(adapt.selected_indices) + adapt._net_ops,
             adapt.params_t.detach()),
            ("HVA 3x3 reps=10", hva_program_rot(hva.reps, hva._v_rot, hva._h_rot, hva._u_rot),
             hva_thetas(hva))):
        seg = CompiledCircuit(ops, n).segments[0]
        d = seg.tensors(dev, torch.float32, thetas.shape[0])
        ext = torch.cat([thetas.to(device=dev, dtype=torch.float32),
                         torch.ones(1, dtype=torch.float32, device=dev)])
        fwd = (d["xb"], d["zb"], ext[d["pidx"]] * d["scale"], d["phre"], d["phim"])
        rev = tuple(a.flip(0) for a in fwd)
        spans = [resident_span(seg, n, s) for s in (1, -1)]
        programs.append((label, n, *spans, fwd, rev))
        if label == "3x3 checkpoint":
            (one_f, one_fwd), (one_a, one_rev) = (first_terms(spans[0], fwd, n),
                                                  first_terms(spans[1], rev, n))
            programs.append(("3x3 checkpoint, one term a run", n, one_f, one_a, one_fwd, one_rev))
    return programs


def phase_sweeps(dev, out, parent=None):
    """--sweeps: the float64 resident sweeps (:func:`sweeps64`), then
    ``rotation_resident`` and ``adjoint_resident`` on each of
    :func:`sweep_programs`, one launch a span, CUDA-event ms a launch and
    us a run (the median of ``SWEEP_ROUNDS`` timings of ``SWEEP_REPS``
    launches), with the port in the checkout ``parent`` (loaded under
    another name, with its own kernel build) in rounds of parent, change,
    change, parent.  Each side's state, psi and lam (relative 2-norm) and
    per-term vector (over its largest entry) are held to the plain version
    in complex128 within GRAD_RTOL (float32 over ~1e4 terms) and
    compared bit for bit with the parent's and with the tile-run kernels
    (``rotation_tile_runs``, ``adjoint_tile_runs``: one launch a run) over
    the same layout."""
    import importlib

    import numpy as np
    import torch

    from qsfh_torch.engine import kernels as K

    ports = {"change": K}
    if parent:
        load_port(parent, "qsfh_torch_parent")
        ports = {"parent": importlib.import_module("qsfh_torch_parent.engine.kernels"),
                 "change": K}
        ports["parent"]._load()
    for side, Kx in ports.items():  # the resident kernels' registers, stack and spills
        lines = Kx.build_info.get("log", "").splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and "_resident_kernel" in line:
                log(f"  ptxas ({side}): {line.split()[-1]}: "
                    + "; ".join(x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]))
    order = ("parent", "change", "change", "parent") if parent else ("change",)
    rng = np.random.default_rng(24)
    rows = out.setdefault("sweeps", {})
    sweeps64(dev, rows, ports, order)
    for label, n, ftiles, atiles, fwd, rev in sweep_programs(dev):
        states = []
        for _ in range(2):
            v = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
            states.append(torch.as_tensor(v / np.linalg.norm(v), device=dev))
        psi, lam = (s.to(torch.complex64) for s in states)
        wide = lambda arrs: tuple(a.to(torch.float64) if a.is_floating_point() else a  # noqa: E731
                                  for a in arrs)
        ref = K.rotation_resident_plain(states[0].clone(), *wide(fwd), ftiles)
        pr, lr = states[0].clone(), states[1].clone()
        v_ref = K.adjoint_resident_plain(pr, lr, *wide(rev), atiles)
        got, row = {}, dict(terms=ftiles.n_terms, runs=len(ftiles), adjoint_runs=len(atiles),
                            most_terms=ftiles.most_terms, fused_terms=ftiles.fused_terms)
        for side, Kx in ports.items():
            Kx.reset_launch_counts()
            state = Kx.rotation_resident(psi.clone(), *fwd, ftiles)
            p, l = psi.clone(), lam.clone()
            v = Kx.adjoint_resident(p, l, *rev, atiles)
            tile_state = Kx.rotation_tile_runs(psi.clone(), *fwd, ftiles)
            tp, tl = psi.clone(), lam.clone()
            tv = Kx.adjoint_tile_runs(tp, tl, *rev, atiles)
            torch.cuda.synchronize()
            got[side] = (state, v, p, l)
            errs = [rel_err(state.to(torch.complex128), ref),
                    max_abs(v.to(torch.complex128), v_ref) / float(v_ref.abs().max()),
                    rel_err(p.to(torch.complex128), pr), rel_err(l.to(torch.complex128), lr)]
            row[side] = dict(
                rel_err=max(errs), grid=Kx.resident_grid(psi, ftiles, False),
                adjoint_grid=Kx.resident_grid(psi, atiles, True),
                tile_runs_bit_equal=dict(
                    forward=torch.equal(state, tile_state),
                    adjoint=all(torch.equal(a, b) for a, b in ((v, tv), (p, tp), (l, tl)))),
                staged_runs=dict(forward=len(ftiles) - 1, adjoint=len(atiles) - 1),
                forward_ms=[], adjoint_ms=[])
            if max(errs) > GRAD_RTOL:
                raise AssertionError(f"--sweeps {label} ({side}): errors {errs} against plain")
        if parent:
            row["bit_equal_to_parent"] = [torch.equal(a, b)
                                          for a, b in zip(got["parent"], got["change"])]
        for _ in range(SWEEP_ROUNDS):
            for side in order:
                Kx = ports[side]
                buf, p, l = psi.clone(), psi.clone(), lam.clone()
                row[side]["forward_ms"].append(time_cuda(
                    lambda: Kx.rotation_resident(buf, *fwd, ftiles), reps=SWEEP_REPS, warmup=1))
                row[side]["adjoint_ms"].append(time_cuda(
                    lambda: Kx.adjoint_resident(p, l, *rev, atiles), reps=SWEEP_REPS, warmup=1))
        for side in ports:
            r = row[side]
            for what, runs in (("forward", len(ftiles)), ("adjoint", len(atiles))):
                ms = sorted(r[f"{what}_ms"])
                r[f"{what}_median_ms"] = ms[len(ms) // 2]
                r[f"{what}_us_per_run"] = 1e3 * r[f"{what}_median_ms"] / runs
            log(f"  {label} ({side}): forward {r['forward_median_ms']:.4f} ms "
                f"({r['forward_us_per_run']:.3f} us a run of {len(ftiles)}, {r['grid']} blocks), "
                f"adjoint {r['adjoint_median_ms']:.4f} ms ({r['adjoint_us_per_run']:.3f} us a "
                f"run of {len(atiles)}, {r['adjoint_grid']} blocks); rel_err {r['rel_err']:.2e}; "
                f"bit-equal to the tile runs {r['tile_runs_bit_equal']}; runs staged a run ahead "
                f"{r['staged_runs']}")
        if parent:
            log(f"  {label}: bit-equal to the parent (state, v, psi, lam) "
                f"{row['bit_equal_to_parent']}")
        rows[label] = row


def first_groups(prog):
    """The float64 program ``prog``'s resident runs cut to their first
    group, one run each (``max_groups=1``): the same passes over the state
    with one group's work inside (a run's fixed cost), as (Groups64,
    Group64Runs) on the program's device, read with its ``theta_ext``."""
    import numpy as np
    import torch

    from qsfh_torch.engine import streaming
    from qsfh_torch.engine.kernels import Groups64

    sel = prog.runs.run_start[:-1].astype(np.int64)
    goff = prog.goff.astype(np.int64)
    terms = np.concatenate([np.arange(goff[g], goff[g + 1]) for g in sel])
    sub_goff = np.concatenate([[0], np.cumsum(goff[sel + 1] - goff[sel])])
    gpidx = prog.gpidx[sel].astype(np.int64)
    rows = np.flatnonzero(gpidx >= 0)
    by_param = rows[np.argsort(gpidx[rows], kind="stable")]
    counts = np.bincount(gpidx[rows], minlength=prog.n_params)
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int64).astype(np.int32),  # noqa: E731
                                    device=prog.device)
    groups = Groups64(
        gx=i32(prog.gx[sel]), goff=i32(sub_goff), gflip=i32(prog.gflip[sel]),
        gpidx=i32(np.where(gpidx < 0, prog.n_params, gpidx)), zsub=i32(prog.zsub[terms]),
        wsub=torch.as_tensor(prog.wsub[terms], device=prog.device),
        param_off=i32(np.concatenate([[0], np.cumsum(counts)])), param_groups=i32(by_param))
    runs = streaming.Group64Runs(prog.gx[sel], sub_goff, prog.zsub[terms], prog.n, prog.runs.k,
                                 prog.runs.c, max_groups=1)
    return groups, runs


def sweeps64(dev, rows, ports, order):
    """--sweeps, float64: ``rot64_resident`` and ``adjoint64_resident`` of
    each side in ``ports`` on the committed 3x3 checkpoint's float64
    program (``Rot64Program.from_adapt``: 1931 groups in 521 runs) at its
    angles and on the same runs cut to their first group
    (:func:`first_groups`), CUDA-event ms a launch and us a run in rounds
    of ``order``.  Each side's forward state is held bit for bit to
    ``rot64_groups`` and within 1e-12 (2-norm) to the plain version, its
    gradient within 1e-12 of max |g| to ``adjoint64_groups`` and to the
    plain version; with a parent, the state, the gradient and the
    adjoint's psi and lam are compared bit for bit with its kernels."""
    import numpy as np
    import torch

    from qsfh_torch.algos.adapt import ADAPT
    from qsfh_torch.engine import kernels as K
    from qsfh_torch.native.statevec import Rot64Program
    from qsfh_torch.ops.pool import hubbard_interaction_pool_extended

    vqe = ADAPT(n_epoch=0, threshold1=1e-3, threshold2=1e-3, results_root=DEMO_ADAPT,
                pool=hubbard_interaction_pool_extended(3, 3), device=dev,
                dtype=torch.complex128, **ANALYSIS_3X3)
    prog = Rot64Program.from_adapt(vqe)
    th_ext = prog._angles(vqe.params_t.detach().cpu().numpy()).clone()
    rng = np.random.default_rng(26)
    states = []
    for _ in range(2):
        v = rng.standard_normal(1 << prog.n) + 1j * rng.standard_normal(1 << prog.n)
        states.append(torch.as_tensor(v / np.linalg.norm(v), device=dev))
    psi, lam = states
    for label, (groups, runs) in (("3x3 float64 checkpoint", (prog.groups, prog.runs)),
                                  ("3x3 float64 checkpoint, one group a run", first_groups(prog))):
        ref = K.rot64_resident_plain(psi.clone(), groups, th_ext, runs)
        g_ref = K.adjoint64_resident_plain(psi.clone(), lam.clone(), groups, th_ext, runs)
        by_group = K.rot64_groups(psi.clone(), groups, th_ext)
        g_groups = K.adjoint64_groups(psi.clone(), lam.clone(), groups, th_ext)
        gmax = float(g_ref.abs().max())
        got, row = {}, dict(groups=runs.n_groups, runs=len(runs), most_entries=runs.most_entries,
                            most_groups=runs.most_groups, staged_runs=len(runs) - 1)
        for side, Kx in ports.items():
            state = Kx.rot64_resident(psi.clone(), groups, th_ext, runs)
            p, l = psi.clone(), lam.clone()
            g = Kx.adjoint64_resident(p, l, groups, th_ext, runs)
            torch.cuda.synchronize()
            got[side] = (state, g, p, l)
            errs = dict(state=rel_err(state, ref), g=float((g - g_ref).abs().max()) / gmax,
                        g_groups=float((g - g_groups).abs().max()) / gmax)
            row[side] = dict(errors=errs, grid=Kx.resident64_grid(psi, runs, False),
                             adjoint_grid=Kx.resident64_grid(psi, runs, True),
                             groups_state_bit_equal=torch.equal(state, by_group),
                             forward_ms=[], adjoint_ms=[])
            if max(errs.values()) > 1e-12 or not row[side]["groups_state_bit_equal"]:
                raise AssertionError(f"--sweeps {label} ({side}): {row[side]} against plain and "
                                     "the per-group kernels")
        if len(ports) > 1:
            row["bit_equal_to_parent"] = [torch.equal(a, b)
                                          for a, b in zip(got["parent"], got["change"])]
        for _ in range(SWEEP_ROUNDS):
            for side in order:
                Kx = ports[side]
                buf, p, l = psi.clone(), psi.clone(), lam.clone()
                row[side]["forward_ms"].append(time_cuda(
                    lambda: Kx.rot64_resident(buf, groups, th_ext, runs), reps=SWEEP_REPS,
                    warmup=1))
                row[side]["adjoint_ms"].append(time_cuda(
                    lambda: Kx.adjoint64_resident(p, l, groups, th_ext, runs), reps=SWEEP_REPS,
                    warmup=1))
        for side in ports:
            r = row[side]
            for what in ("forward", "adjoint"):
                ms = sorted(r[f"{what}_ms"])
                r[f"{what}_median_ms"] = ms[len(ms) // 2]
                r[f"{what}_us_per_run"] = 1e3 * r[f"{what}_median_ms"] / len(runs)
            log(f"  {label} ({side}): forward {r['forward_median_ms']:.4f} ms "
                f"({r['forward_us_per_run']:.3f} us a run of {len(runs)}, {r['grid']} blocks), "
                f"adjoint {r['adjoint_median_ms']:.4f} ms ({r['adjoint_us_per_run']:.3f} us a "
                f"run, {r['adjoint_grid']} blocks); errors {r['errors']}; state bit-equal to "
                f"rot64_groups {r['groups_state_bit_equal']}; runs staged a run ahead "
                f"{row['staged_runs']}")
        if len(ports) > 1:
            log(f"  {label}: bit-equal to the parent (state, g, psi, lam) "
                f"{row['bit_equal_to_parent']}")
        rows[label] = row


# -- the float64 readout, the fused runner and exact diagonalization --------------------


def f64_bound(xs, cim, dim, k):
    """(bound ms, by) of the float64 Rayleigh readout of a complex64 state
    of ``dim`` amplitudes over the terms with flip masks ``xs`` (a tensor)
    and imaginary parts ``cim``: one read of the state and of the terms
    (masks and float64 coefficients), 32 bytes out, against the least
    float64 arithmetic of either design per amplitude, at 34 TFLOP/s.
    Per term (``expectation_norm_f64``): |psi[b]|^2 and its sum (4); per
    flip mask the product conj(psi[b]) psi[b^x] (6; 3 for x = 0) and its
    real part against the weight and the sum (2 for real weights, 4 for
    complex); per term its signed coefficient added to the weight (1 real,
    2 complex).  Over the tiles (``expectation_norm_f64_tiles``, tiles of
    k bits): |psi[b]|^2 and N (4); per flip mask x != 0 half a product, the
    pair (b, b^x) sharing one (3), and its bucket sum (1); the x = 0 terms
    one Walsh-Hadamard transform of |psi|^2 over the tile (k adds); the
    per-item and per-term work is once per tile position, 2^-k of it an
    amplitude.  The smaller count is the bound, so that neither kernel can
    read under it."""
    real = not bool(cim.any())
    masks = xs.unique().tolist()
    terms = 4 + sum((3 if int(x) == 0 else 6) + (2 if real else 4) for x in masks)
    terms += (1 if real else 2) * xs.shape[0]
    tiles = 4 + 4 * sum(1 for x in masks if int(x)) + (k if 0 in masks else 0)
    bytes_moved = 8 * dim + 24 * xs.shape[0] + 32
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, min(terms, tiles) * dim / F64_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def h_apply_flops(xs, cim, tiles, dim):
    """The least float64 arithmetic of H psi with E = Re <psi|H psi> and N
    over the terms with flip masks ``xs`` (numpy) of either design, per
    amplitude times ``dim``: E and N (4 each) and, per term
    (``happly64``), per flip mask the coefficient times psi[b^x] and its
    accumulation (4 for real coefficients, 8 complex) and per term its
    signed coefficient (1 real, 2 complex); over the application tiles
    (``happly64_tiles``, ``tiles`` its layout) the same per flip mask x !=
    0, per item of x != 0 its table entry (1, 2), and per tile with a
    diagonal one Walsh-Hadamard transform of the spectrum over the tile (k
    adds, 2k complex) and its product with psi and accumulation (4, 8);
    masks that fit no tile as per term.  The smaller count."""
    import numpy as np

    real = not bool(np.asarray(cim).any())
    w, f = (4, 1) if real else (8, 2)
    xs = np.asarray(xs, np.int64)
    terms = (8 + w * np.unique(xs).size + f * xs.size) * dim
    has_diag = np.diff(tiles.tile_diag) > 0
    tile_of = np.repeat(np.arange(tiles.n_tiles), np.diff(tiles.tile_items))
    own = (tiles.item_x != 0) | ~has_diag[tile_of]  # items not taken by a diagonal
    item_x = xs[tiles.order[tiles.item_start[:-1]]]
    spill = xs[tiles.spill_index]
    per_amp = (8 + w * np.unique(item_x[own]).size + f * int(own.sum())
               + int(has_diag.sum()) * (f * tiles.k + w) + w * np.unique(spill).size
               + f * spill.size)
    return min(terms, per_amp * dim)


def ansatz_state(adapt, n_ansatz, dev):
    """The main path's state: the first ``n_ansatz`` pool operators at
    theta = 0.05 and the Givens network, on the kernels."""
    import torch

    adapt.selected_indices = list(range(n_ansatz))
    return adapt.state(torch.full((n_ansatz,), 0.05, dtype=adapt._rdt, device=dev))


F64_READOUT_RTOL = 1e-12  # both readouts against the plain version, the Rayleigh quotient
F64_HPSI_RTOL = 1e-11  # H psi against the plain version, relative (the polish gate)
F64_E_ATOL = 1e-11  # E = Re <psi|H psi> against the plain version
# --tiles: the float64 tile kernels' shapes (k, c), timed beside the shipped ones
F64_TILE_SHAPES = ((10, 2), (11, 2), (12, 2))


def f64_dropped(tiles, cre):
    """A copy of ``cre`` with the coefficient of the first term of the
    layout's first item of x != 0 set to 0 (a planted fault)."""
    it = next(i for i in range(tiles.n_items) if tiles.item_x[i])
    t = int(tiles.order[tiles.item_start[it]])
    faulty = cre.clone()
    faulty[t] = 0.0
    return faulty, dict(item=it, term=t, coefficient=float(cre[t]))


def readout_rel(got, ref):
    """(Rayleigh quotient relative error, N relative error)."""
    from qsfh_torch.engine.dfloat import combine_rayleigh

    e, e_ref = combine_rayleigh(got.cpu().numpy()), combine_rayleigh(ref.cpu().numpy())
    return abs(e - e_ref) / abs(e_ref), abs(float(got[2] - ref[2])) / float(ref[2])


def library_readout(psi, xs, zs, c, ref):
    """ms of the readout's library yardstick on a complex64 state: the state
    upcast to complex128, a complex128 CSR ``torch.mv`` of H (built as
    :func:`library_sparse_apply` builds it) and two ``torch.vdot`` (never
    called by the port), checked against the readout ``ref``; None where
    the matrix does not fit beside the phase or this torch build cannot
    multiply it."""
    import torch

    from qsfh_torch.engine.dfloat import combine_rayleigh

    try:
        csr = sparse_h(psi.to(torch.complex128), xs, zs, c.to(torch.complex128))
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
        log("  readout yardstick: the complex128 CSR does not fit beside the phase")
        return None

    def readout():
        q = psi.to(torch.complex64).to(torch.complex128)  # what the readout reads
        return torch.stack([torch.vdot(q, torch.mv(csr, q)).real, torch.vdot(q, q).real])

    try:
        got = readout()
    except RuntimeError as exc:  # a missing sparse kernel in this torch build
        log(f"  readout yardstick unavailable: {str(exc).splitlines()[0]}")
        return None
    e, e_ref = float(got[0] / got[1]), combine_rayleigh(ref.cpu().numpy())
    if abs(e - e_ref) > F64_READOUT_RTOL * abs(e_ref):
        raise AssertionError(f"the readout's yardstick disagrees: {e} against {e_ref}")
    out = time_cuda(readout, reps=10)
    del csr
    torch.cuda.empty_cache()
    return out


def f64_shapes(layout_of, call, ref, close, reps):
    """--tiles: a float64 tile kernel at each of F64_TILE_SHAPES: its
    layout's tiles and items, ms (least of two runs of ``reps``, CUDA
    events; and ``reps`` calls replayed in a CUDA graph), checked against
    ``ref`` by ``close``."""
    rows = []
    for k, c in F64_TILE_SHAPES:
        tiles = layout_of(k, c)
        got = call(tiles)
        ms = min(time_cuda(lambda: call(tiles), reps) for _ in range(2))
        rows.append(dict(k=k, c=c, tiles=tiles.n_tiles, items=tiles.n_items, ms=ms,
                         graph_ms=graph_ms(lambda: call(tiles), reps), err=close(got, ref)))
        log(f"    tiles {k} / {c}: {tiles.n_tiles} tiles, {tiles.n_items} items, {ms:.4f} ms, "
            f"in a CUDA graph {rows[-1]['graph_ms']:.4f} ms, error {rows[-1]['err']:.2e}")
    return rows


def readout_turns(psi, terms, layout, reps):
    """ms of the two float64 readouts in turns (per term, tiles, tiles, per
    term): ({"terms": [a, b], "tiles": [a, b]} from CUDA events around
    ``reps`` calls, the same from 20 calls replayed in a CUDA graph)."""
    from qsfh_torch.engine import kernels as K

    calls = {"terms": lambda: K.expectation_norm_f64(psi, *terms),
             "tiles": lambda: K.expectation_norm_f64_tiles(psi, *layout)}
    turns, graph = {"terms": [], "tiles": []}, {"terms": [], "tiles": []}
    for side in ("terms", "tiles", "tiles", "terms"):
        turns[side].append(time_cuda(calls[side], reps=reps))
        graph[side].append(graph_ms(calls[side], reps=20))
    return turns, graph


# the lattices (x, y) of f64_route_sizes: 10, 12, 14 and 16 qubits, under
# the main paths' 18 and 24
F64_ROUTE_LATTICES = ((1, 5), (2, 3), (1, 7), (2, 4))


def f64_route_sizes(dev):
    """The float64 routes below the main paths' sizes: at each lattice of
    F64_ROUTE_LATTICES, on a seeded random state under its H, both readouts
    (complex64 state) and both H psi kernels (complex128, scale 2) against
    their plain versions (the gates of phase_f64 and happly64_checks, a
    planted fault included) and timed in turns, CUDA events and CUDA graph
    replays; beside them the route the code takes there
    (``dfloat.f64_route``, ``kernels.f64_tile_layout``) and which kernel
    was faster in turns."""
    import numpy as np
    import torch

    from qsfh_torch.algos.base import HubbardProblem
    from qsfh_torch.engine import kernels as K
    from qsfh_torch.engine import streaming
    from qsfh_torch.engine.dfloat import f64_layout, f64_route, f64_terms

    rows = []
    for x, y in F64_ROUTE_LATTICES:
        sites = x * y
        obs = HubbardProblem(x, y, 1.0, 4.0, sites, (sites + 1) // 2, sites // 2).observables["H"]
        n = obs.n
        gen = torch.Generator().manual_seed(23 + n)
        psi = torch.randn(1 << n, dtype=torch.complex64, generator=gen)
        psi = (psi / torch.linalg.vector_norm(psi)).to(dev)
        terms, layout = f64_terms(obs, dev), f64_layout(obs, dev)
        K.reset_launch_counts()
        got, again = (K.expectation_norm_f64_tiles(psi, *layout) for _ in range(2))
        old = K.expectation_norm_f64(psi, *terms)
        torch.cuda.synchronize()
        ref = K.expectation_norm_f64_tiles_plain(psi, *layout)
        rel, old_rel = readout_rel(got, ref)[0], readout_rel(old, ref)[0]
        faulty_cre, where = f64_dropped(layout[4], layout[2])
        fault_rel = readout_rel(K.expectation_norm_f64_tiles(
            psi, layout[0], layout[1], faulty_cre, layout[3], layout[4]), ref)[0]
        turns, graph = readout_turns(psi, terms, layout, reps=50)
        xs, zs, cre, cim = obs._scan_terms()
        i32 = lambda a: torch.as_tensor(np.asarray(a, np.int64).astype(np.int32), device=dev)  # noqa
        f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)  # noqa: E731
        order = np.argsort(np.asarray(xs, np.int64), kind="stable")
        h_input = (i32(xs), i32(zs), f64(cre), f64(cim))
        h_sorted = tuple(a[torch.as_tensor(order, device=dev)] for a in h_input)
        tiles = streaming.apply64_layout(xs, zs, n)
        h, h_ok, _ = happly64_checks(psi.to(torch.complex128), h_input, h_sorted, tiles, 2.0, 50)
        readout = dict(layout=dict(k=layout[4].k, tiles=layout[4].n_tiles,
                                   items=layout[4].n_items, diag=layout[4].n_diag),
                       rel_err=rel, old_rel_err=old_rel, same_bits=bool(torch.equal(got, again)),
                       planted=dict(where, rel_err=fault_rel),
                       ms=sum(turns["tiles"]) / 2, old_ms=sum(turns["terms"]) / 2,
                       graph_ms=sum(graph["tiles"]) / 2, old_graph_ms=sum(graph["terms"]) / 2,
                       turns_ms=turns, graph_turns_ms=graph, route=f64_route(obs, dev))
        h["route"] = ("terms" if K.f64_tile_layout("happly64_tiles", n, lambda: tiles) is None
                      else "tiles")
        row = dict(lattice=f"{x}x{y}", n=n, terms=len(obs), readout=readout, happly64=h)
        for key, r in (("readout", readout), ("happly64", h)):
            r["faster"] = "tiles" if r["ms"] < r["old_ms"] else "terms"
            r["faster_graph"] = "tiles" if r["graph_ms"] < r["old_graph_ms"] else "terms"
            log(f"  {key} {row['lattice']} (n={n}, {r['layout']}): route {r['route']}; ms tiles "
                f"{r['ms']:.4f} / per term {r['old_ms']:.4f} (in turns; in a CUDA graph "
                f"{r['graph_ms']:.4f} / {r['old_graph_ms']:.4f}); faster {r['faster']} / "
                f"{r['faster_graph']}")
        log(f"    readout {rel:.2e} / {old_rel:.2e}, planted {fault_rel:.2e}; H psi "
            f"{h['hpsi_rel']:.2e} / {h['old_hpsi_rel']:.2e}, E {h['e_err']:.2e}, planted "
            f"{h['planted']['hpsi_rel']:.2e}")
        if not (rel <= F64_READOUT_RTOL and old_rel <= F64_READOUT_RTOL and readout["same_bits"]
                and h_ok):
            raise AssertionError(f"the float64 kernels at {row['lattice']} failed a gate: {row}")
        if fault_rel <= F64_READOUT_RTOL or h["planted"]["hpsi_rel"] <= F64_HPSI_RTOL:
            raise AssertionError(f"a planted fault at {row['lattice']} passed its gate")
        rows.append(row)
    return rows


def route_sizes(rows, key, tiles):
    """{n: [ms in turns, ms in a CUDA graph, the route there]} of one of the
    two kernels of ``key`` from :func:`f64_route_sizes`' rows."""
    return {r["n"]: [r[key]["ms" if tiles else "old_ms"],
                     r[key]["graph_ms" if tiles else "old_graph_ms"], r[key]["route"]]
            for r in rows}


def phase_f64(cases, dev, sweep_tiles=False):
    """The float64 Rayleigh readout on the main paths' states (3x3 and 2x6,
    H): ``expectation_norm_f64_tiles`` (the route of ``expectation_norm_df``
    from 9 qubits on) and ``expectation_norm_f64`` (per term, the route of
    smaller states and spilled masks) against their plain version (the
    state upcast to complex128): the Rayleigh quotient and N within 1e-12
    relative, the same bits on two calls, one launch a call; a planted
    fault (one item's coefficient dropped) that the tile gate must fail;
    timed in turns (per term, tiles, tiles, per term) beside the bound, the
    plain version and the library yardstick (the upcast state, a complex128
    CSR ``torch.mv`` and ``torch.vdot``); the float32 gap.  At 2x6 also
    H psi (``happly64_tiles`` and ``happly64``) on the state upcast to
    complex128, 24 qubits, past L2: H psi within 1e-11 relative and E
    within 1e-11 of the plain version, the same bits, in turns, a planted
    fault.  Then the 3x3 H with one term on a 5-bit mask (it fits no tile):
    both tile kernels against their plain versions, the spilled term
    through the per-term kernels.  ``sweep_tiles``: the tile kernels at
    F64_TILE_SHAPES."""
    import numpy as np
    import torch

    from qsfh_torch.engine import kernels as K
    from qsfh_torch.engine import streaming
    from qsfh_torch.engine.dfloat import f64_layout, f64_terms

    rows = []
    for label, adapt, n_ansatz in cases:
        n = adapt.n_qubits
        psi = ansatz_state(adapt, n_ansatz, dev)
        obs = adapt.problem.observables["H"]
        terms, layout = f64_terms(obs, dev), f64_layout(obs, dev)
        tiles = layout[4]
        K.reset_launch_counts()
        got, again = (K.expectation_norm_f64_tiles(psi, *layout) for _ in range(2))
        old, old_again = (K.expectation_norm_f64(psi, *terms) for _ in range(2))
        torch.cuda.synchronize()
        launches = {k: v for k, v in K.launch_counts().items() if v}
        ref = K.expectation_norm_f64_tiles_plain(psi, *layout)
        e32 = float(obs.expectation_scan(psi))
        rel, n_rel = readout_rel(got, ref)
        old_rel, old_n_rel = readout_rel(old, ref)
        same = bool(torch.equal(got, again)) and bool(torch.equal(old, old_again))
        faulty_cre, where = f64_dropped(tiles, layout[2])
        fault_rel = readout_rel(K.expectation_norm_f64_tiles(psi, layout[0], layout[1], faulty_cre,
                                                             layout[3], tiles), ref)[0]
        reps = 50 if n <= 18 else 10
        turns, graph = readout_turns(psi, terms, layout, reps)
        b_ms, b_by = f64_bound(terms[0], terms[3], 1 << n, tiles.k)
        xs64, zs64 = terms[0].long(), terms[1].long()
        c = torch.complex(terms[2], terms[3])
        row = dict(call=f"H of {label}, {len(obs)} terms, {terms[4].shape[0] - 1} flip masks",
                   n=n, terms=len(obs), layout=dict(k=tiles.k, c=tiles.c, tiles=tiles.n_tiles,
                                                    items=tiles.n_items, diag=tiles.n_diag,
                                                    units=len(tiles.schedule(
                                                        n, K.sm_count(dev), True)[1])),
                   rel_err=rel, norm_rel_err=n_rel, max_abs_err=max_abs(got, ref),
                   old_rel_err=old_rel, old_norm_rel_err=old_n_rel,
                   old_max_abs_err=max_abs(old, ref), same_bits=same, launches=launches,
                   planted=dict(where, rel_err=fault_rel), norm=float(got[2]),
                   f32_energy=e32, f32_gap=abs(e32 - float(got[0])),
                   ms=sum(turns["tiles"]) / 2, old_ms=sum(turns["terms"]) / 2, turns_ms=turns,
                   graph_ms=sum(graph["tiles"]) / 2, old_graph_ms=sum(graph["terms"]) / 2,
                   graph_turns_ms=graph,
                   plain_ms=time_cuda(lambda: K.expectation_norm_f64_tiles_plain(psi, *layout),
                                      reps=3),
                   bound_ms=b_ms, bound_by=b_by,
                   library_ms=library_readout(psi, xs64, zs64, c, ref))
        log(f"  readout {label} (n={n}, {row['layout']}): tiles {rel:.2e}, per term "
            f"{old_rel:.2e} (Rayleigh, relative; tol {F64_READOUT_RTOL:g}), N {n_rel:.2e} / "
            f"{old_n_rel:.2e}; same bits on two calls {same}; launches {launches}; planted fault "
            f"{where}: {fault_rel:.2e}; float32 gap {row['f32_gap']:.3e}; ms tiles "
            f"{row['ms']:.4f} / per term {row['old_ms']:.4f} (in turns {turns}; in a CUDA graph "
            f"{row['graph_ms']:.4f} / {row['old_graph_ms']:.4f}), plain "
            f"{row['plain_ms']:.3f}, bound {b_ms:.5f} ({b_by}), library {row['library_ms']}")
        if not (rel <= F64_READOUT_RTOL and n_rel <= F64_READOUT_RTOL and same
                and old_rel <= F64_READOUT_RTOL and old_n_rel <= F64_READOUT_RTOL
                and launches == {"expectation_norm_f64_tiles": 2, "expectation_norm_f64": 2}):
            raise AssertionError(f"the float64 readout ({label}) failed a gate: {row}")
        if fault_rel <= F64_READOUT_RTOL:
            raise AssertionError(f"the readout's planted fault ({label}) passed its gate")
        if sweep_tiles:
            log(f"  readout tile shapes, {label}:")
            row["tile_shapes"] = f64_shapes(
                lambda k, c: streaming.GroupTiles(
                    *(a.cpu().numpy() for a in layout[:2]), n, k, c, diagonal=False,
                    inner_diagonal=True),
                lambda t: K.expectation_norm_f64_tiles(psi, *layout[:4], t), ref,
                lambda a, b: readout_rel(a, b)[0], reps)
        if n > 18:
            row["happly64"] = happly64_24(psi.to(torch.complex128), obs, dev, sweep_tiles)
        rows.append(row)
    rows.append(f64_spilled(cases[0][1], dev))
    rows.append(f64_route_sizes(dev))
    return rows


def happly64_checks(psi, h_input, h_sorted, tiles, scale, reps):
    """``happly64_tiles`` and ``happly64`` on psi (complex128) against the
    plain version: H psi (relative), E, N, the same bits on two calls, the
    launches, a planted fault (one item's coefficient dropped) that the H
    psi gate must fail; ms in turns (per term, tiles, tiles, per term),
    CUDA events and CUDA graph replays."""
    import torch

    from qsfh_torch.engine import kernels as K

    K.reset_launch_counts()
    (h, st), (h2, st2) = (K.happly64_tiles(psi, *h_input, tiles, scale) for _ in range(2))
    (ho, sto), (ho2, sto2) = (K.happly64(psi, *h_sorted, scale) for _ in range(2))
    torch.cuda.synchronize()
    launches = {k: v for k, v in K.launch_counts().items() if v}
    ref, st_ref = K.happly64_tiles_plain(psi, *h_input, tiles, scale)
    faulty, where = f64_dropped(tiles, h_input[2])
    hf = K.happly64_tiles(psi, h_input[0], h_input[1], faulty, h_input[3], tiles, scale)[0]
    calls = {"terms": lambda: K.happly64(psi, *h_sorted, scale),
             "tiles": lambda: K.happly64_tiles(psi, *h_input, tiles, scale)}
    turns, graph = ({side: [] for side in calls} for _ in range(2))
    for side in ("terms", "tiles", "tiles", "terms"):
        turns[side].append(time_cuda(calls[side], reps=reps))
        graph[side].append(graph_ms(calls[side], reps=reps))
    res = dict(hpsi_rel=rel_err(h, ref), hpsi_max_abs=max_abs(h, ref),
               e_err=abs(float(st[0] - st_ref[0])), n_rel=abs(float(st[2] - st_ref[2])) /
               float(st_ref[2]), old_hpsi_rel=rel_err(ho, ref), old_hpsi_max_abs=max_abs(ho, ref),
               old_e_err=abs(float(sto[0] - st_ref[0])),
               same_bits=bool(torch.equal(h, h2) and torch.equal(st, st2)
                              and torch.equal(ho, ho2) and torch.equal(sto, sto2)),
               launches=launches, planted=dict(where, hpsi_rel=rel_err(hf, ref)),
               ms=sum(turns["tiles"]) / 2, old_ms=sum(turns["terms"]) / 2, turns_ms=turns,
               graph_ms=sum(graph["tiles"]) / 2, old_graph_ms=sum(graph["terms"]) / 2,
               graph_turns_ms=graph, energy=float(st[0]), layout=dict(k=tiles.k, c=tiles.c, tiles=tiles.n_tiles,
                                                items=tiles.n_items))
    ok = (res["hpsi_rel"] <= F64_HPSI_RTOL and res["e_err"] <= F64_E_ATOL
          and res["n_rel"] <= F64_READOUT_RTOL and res["old_hpsi_rel"] <= F64_HPSI_RTOL
          and res["old_e_err"] <= F64_E_ATOL and res["same_bits"]
          and launches == {"happly64_tiles": 2 * tiles.n_tiles, "happly64": 2})
    return res, ok, ref


def happly64_24(psi, obs, dev, sweep_tiles):
    """H psi of the 2x6 main path's state upcast to complex128 (24 qubits):
    :func:`happly64_checks` on the shipped application layout, bound,
    plain ms; ``sweep_tiles``: F64_TILE_SHAPES."""
    import numpy as np
    import torch

    from qsfh_torch.engine import kernels as K
    from qsfh_torch.engine import streaming

    n = psi.shape[0].bit_length() - 1
    xs, zs, cre, cim = obs._scan_terms()
    tiles = streaming.apply64_layout(xs, zs, n)
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int64).astype(np.int32), device=dev)  # noqa
    f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)  # noqa: E731
    h_input = (i32(xs), i32(zs), f64(cre), f64(cim))
    order = np.argsort(np.asarray(xs, np.int64), kind="stable")
    h_sorted = (i32(np.asarray(xs)[order]), i32(np.asarray(zs)[order]),
                f64(np.asarray(cre)[order]), f64(np.asarray(cim)[order]))
    res, ok, ref = happly64_checks(psi, h_input, h_sorted, tiles, 2.0, reps=5)
    dim = 1 << n
    flops = h_apply_flops(xs, cim, tiles, dim)
    t_bytes, t_ops = (32 * dim + 24 * len(xs)) / HBM_BYTES_PER_S, flops / F64_FLOPS_PER_S
    res.update(bound_ms=1e3 * max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               plain_ms=time_cuda(lambda: K.happly64_tiles_plain(psi, *h_input, tiles, 2.0), 1,
                                  warmup=0))
    log(f"  happly64 at {n} qubits (complex128, {res['layout']}): tiles H psi "
        f"{res['hpsi_rel']:.2e} relative, E {res['e_err']:.2e}, per term {res['old_hpsi_rel']:.2e} "
        f"/ {res['old_e_err']:.2e} (tol {F64_HPSI_RTOL:g}, {F64_E_ATOL:g}); same bits "
        f"{res['same_bits']}; launches {res['launches']}; planted fault {res['planted']}; ms "
        f"tiles {res['ms']:.4f} / per term {res['old_ms']:.4f} (in turns; in a CUDA graph "
        f"{res['graph_ms']:.4f} / {res['old_graph_ms']:.4f}), plain "
        f"{res['plain_ms']:.1f}, bound {res['bound_ms']:.5f} ({res['bound_by']})")
    if not ok:
        raise AssertionError(f"happly64 at {n} qubits failed a gate: {res}")
    if res["planted"]["hpsi_rel"] <= F64_HPSI_RTOL:
        raise AssertionError(f"happly64's planted fault at {n} qubits passed its gate")
    if sweep_tiles:
        log(f"  happly64 tile shapes, {n} qubits:")
        res["tile_shapes"] = f64_shapes(
            lambda k, c: streaming.GroupTiles(xs, zs, n, k, c),
            lambda t: K.happly64_tiles(psi, *h_input, t, 2.0)[0], ref, rel_err, 5)
    return res


def f64_spilled(adapt, dev):
    """The 3x3 H with one more term on a 5-bit mask (it fits no tile): the
    readout and H psi on the main path's state against their plain
    versions, the spilled term through the per-term kernels (one launch
    each beside the tile kernels')."""
    import numpy as np
    import torch

    from qsfh_torch.engine import kernels as K
    from qsfh_torch.engine import streaming

    n = adapt.n_qubits
    xs, zs, cre, cim = adapt.problem.observables["H"]._scan_terms()
    wide = 0b1001001001 | 1 << (n - 1)  # 5 flip bits: 0, 3, 6, 9 and the top one
    xs = np.r_[np.asarray(xs, np.int64), wide]
    zs, cre, cim = np.r_[np.asarray(zs, np.int64), 0b110], np.r_[cre, 0.125], np.r_[cim, 0.0]
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int64).astype(np.int32), device=dev)  # noqa
    f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)  # noqa: E731
    args = (i32(xs), i32(zs), f64(cre), f64(cim))
    rd = streaming.GroupTiles(xs, zs, n, streaming.INNER64_TILE_BITS,
                              streaming.INNER64_TILE_LOW_BITS, diagonal=False, inner_diagonal=True)
    ap = streaming.apply64_layout(xs, zs, n)
    if rd.spill_index.tolist() != [len(xs) - 1] or ap.spill_index.tolist() != [len(xs) - 1]:
        raise AssertionError("the 5-bit mask fits a tile")
    psi = ansatz_state(adapt, N_ANSATZ, dev)
    K.reset_launch_counts()
    got = K.expectation_norm_f64_tiles(psi, *args, rd)
    h, st = K.happly64_tiles(psi.to(torch.complex128), *args, ap, 1.0)
    torch.cuda.synchronize()
    launches = {k: v for k, v in K.launch_counts().items() if v}
    rel = readout_rel(got, K.expectation_norm_f64_tiles_plain(psi, *args, rd))[0]
    ref, st_ref = K.happly64_tiles_plain(psi.to(torch.complex128), *args, ap, 1.0)
    res = dict(call="3x3 H + a 5-bit mask (spilled)", readout_rel=rel, hpsi_rel=rel_err(h, ref),
               e_err=abs(float(st[0] - st_ref[0])), launches=launches)
    log(f"  spilled mask, 3x3 H + 1 term: readout {rel:.2e}, H psi {res['hpsi_rel']:.2e}, E "
        f"{res['e_err']:.2e}; launches {launches}")
    if not (rel <= F64_READOUT_RTOL and res["hpsi_rel"] <= F64_HPSI_RTOL
            and res["e_err"] <= F64_E_ATOL
            and launches == {"expectation_norm_f64_tiles": 1, "expectation_norm_f64": 1,
                             "happly64_tiles": ap.n_tiles, "happly64": 1}):
        raise AssertionError(f"the spilled mask failed a gate: {res}")
    return res


def eager_rows(adapt, indices, dev, n_steps):
    """``n_steps`` eager train steps from theta = 0.05 (Adam lr 1e-2), the
    reference of a replayed chunk: per-step energy and gnorm."""
    import torch

    th = torch.full((len(indices),), 0.05, dtype=adapt._rdt, device=dev)
    opt = torch.optim.Adam([th], lr=1e-2)
    step = adapt._build_step(indices)
    rows = []
    for i in range(n_steps):
        out = step(th, opt)
        rows.append(dict(step=i + 1, energy=float(out[2]), gnorm=float(out[6])))
    return rows


def fused_chunk(runner, adapt, k, dev):
    """(chunk callable, capture record) of a ``k``-step CUDA graph of
    ``adapt``'s ansatz from theta = 0.05 (capturable Adam, lr 1e-2), with
    the peak device memory over the capture."""
    import torch

    th = torch.full((len(adapt.selected_indices),), 0.05, dtype=adapt._rdt, device=dev)
    opt = torch.optim.Adam([th], lr=1e-2, capturable=True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    chunk = runner.build_chunk(th, opt, k)
    return chunk, dict(runner.capture_stats[-1],
                       peak_bytes=torch.cuda.max_memory_allocated() - base)


def capture_chunks(runner, adapt, ks, dev, out):
    """Capture a chunk at each K of ``ks``: the chunks by K; the capture
    records and the launches each capture counted (with its warm-up step)
    into ``out``."""
    from qsfh_torch.engine import kernels as K

    chunks = {}
    out.update(captures={}, launches={})
    K.reset_launch_counts()
    for k in ks:
        before = K.launch_counts()
        chunks[k], out["captures"][k] = fused_chunk(runner, adapt, k, dev)
        after = K.launch_counts()
        out["launches"][k] = {name: after[name] - before[name] for name in after}
        rec = out["captures"][k]
        log(f"  capture K={k}: {rec['ms']:.1f} ms, graph pool {rec['pool_bytes'] / 2**20:.1f} MiB "
            f"(peak over the capture {rec['peak_bytes'] / 2**20:.1f} MiB); launches recorded (one "
            f"warm-up step + the capture): "
            f"{{{', '.join(f'{a}: {b}' for a, b in out['launches'][k].items() if b)}}}")
    return chunks


def check_replays(runner, adapt, chunk, n_replays, k, dev, tolerances, label):
    """``n_replays`` replays of ``chunk`` (no wrapper launch among them)
    against as many eager steps (``tolerances`` on energy and gnorm), and
    the chunk's float64 energy against the plain complex128 Rayleigh
    quotient of the graph's final state (1e-10 relative)."""
    from qsfh_torch.engine import kernels as K
    from qsfh_torch.engine.dfloat import combine_rayleigh

    K.reset_launch_counts()
    res = [chunk() for _ in range(n_replays)]
    if any(K.launch_counts().values()):
        raise AssertionError(f"{label}: a replay launched through a wrapper: {K.launch_counts()}")
    eager = eager_rows(adapt, tuple(adapt.selected_indices), dev, n_replays * k)
    replay = [dict(step=i + 1, energy=e, gnorm=g) for i, (e, g) in
              enumerate((e, g) for r in res for e, g in zip(r["energy"], r["gnorm"]))]
    for a, b in zip(replay, eager):
        for key, rtol, atol in tolerances[:2]:  # energy, gnorm
            if abs(a[key] - b[key]) > rtol * abs(b[key]) + atol:
                raise AssertionError(f"{label} step {b['step']}: {key} {a[key]} vs eager {b[key]}")
    e_df = combine_rayleigh(res[-1]["df"])
    e_ref = rayleigh_plain_c128(adapt, runner.final_state)
    rel = abs(e_df - e_ref) / abs(e_ref)
    log(f"  {n_replays} replays of K={k} against {n_replays * k} eager steps: energy and gnorm "
        f"within {tolerances[0][1]:g} relative; E_df {e_df:.15f} against the plain complex128 "
        f"Rayleigh quotient {e_ref:.15f} of the graph's final state (rel {rel:.2e}, tol 1e-10); "
        f"float32 E of the last step {res[-1]['energy'][-1]:.10f}")
    if rel > 1e-10:
        raise AssertionError(f"{label}: E_df disagrees with the plain Rayleigh quotient")
    return dict(e_df=e_df, e_df_plain=e_ref, e_df_rel=rel,
                replay_vs_eager=dict(replay=replay, eager=eager))


def steps_in_turns(adapt, chunk, k, rounds, dev):
    """Median host-clock ms per step of the eager step and of the chunk
    (over K), in ``rounds`` rounds of eager, fused, fused, eager."""
    import numpy as np
    import torch

    n = len(adapt.selected_indices)
    step = adapt._build_step(tuple(adapt.selected_indices))
    th = torch.full((n,), 0.05, dtype=adapt._rdt, device=dev)
    opt = torch.optim.Adam([th], lr=1e-2)
    calls = {"eager": lambda: [float(v) for v in step(th, opt)[2:]], "fused": chunk}
    for fn in calls.values():
        fn()
    times = {side: [] for side in calls}
    for _ in range(rounds):
        for side in ("eager", "fused", "fused", "eager"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            calls[side]()
            torch.cuda.synchronize()
            times[side].append(1e3 * (time.perf_counter() - t0) / (k if side == "fused" else 1))
    return {side: float(np.median(v)) for side, v in times.items()}, times


def profile_chunk(chunk):
    """(device kernel ms, kernel launches, rows) of one replay of a chunk
    (torch.profiler; the graph's kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        chunk()
        torch.cuda.synchronize()
    rows = _device_kernels(prof)
    return sum(r[2] for r in rows) / 1e3, sum(r[1] for r in rows), rows


def rayleigh_plain_c128(adapt, psi):
    """<psi|H|psi> / <psi|psi> of a state upcast to complex128, through the
    plain H application on the card."""
    import torch

    from qsfh_torch.engine import kernels as K

    p = psi.to(torch.complex128)
    hp = adapt.problem.observables["H"].apply_scan(p, impl=K.PLAIN)
    return float(torch.vdot(p, hp).real / torch.vdot(p, p).real)


FUSED_KS = (1, 10, 100)
FUSED_ROUNDS = (8, 4, 2)  # rounds of eager, fused, fused, eager at each K


def check_f64_readout_route(launches, label):
    """Each capture (with its warm-up step) took the chunk's float64 readout
    through the tile kernel, and none through the per-term one."""
    for k, counts in launches.items():
        if counts["expectation_norm_f64_tiles"] < 1 or counts["expectation_norm_f64"]:
            raise AssertionError(f"{label}: the capture of K={k} read the float64 energy through "
                                 f"{counts['expectation_norm_f64_tiles']} tile and "
                                 f"{counts['expectation_norm_f64']} per-term launches")


def phase_fused(dev, tmp):
    """``FusedAdaptRunner`` on the 3x3 main path's 12-operator ansatz, on the
    CUDA graph path: captures at K = 1, 10 and 100 (capture ms, graph-pool
    memory, launches counted per capture: none at replay); two replays of
    K = 10 against 20 eager steps (STEP_TOLERANCES); the float64 energy
    against the plain complex128 Rayleigh quotient of the graph's final
    state (1e-10 relative); ms per step in turns with the eager step, with
    the idle share of a replay; then a short ``run()`` stopped after its
    first chunk and resumed from the in-flight file."""
    from qsfh_torch.algos.adapt_fused import FusedAdaptRunner

    adapt = build_adapt(dev, tmp, "fused")
    adapt.selected_indices = list(range(N_ANSATZ))
    runner = FusedAdaptRunner(adapt, verbose=False)
    out = dict(timing={})
    chunks = capture_chunks(runner, adapt, FUSED_KS, dev, out)
    launches = out["launches"]
    per_step = {name: (launches[10][name] - launches[1][name]) // 9 for name in launches[1]}
    for name, v in per_step.items():
        if launches[100][name] - launches[10][name] != 90 * v:
            raise AssertionError(f"{name}: graph nodes per step differ between K=10 and K=100")
    if per_step["rotation_resident"] != 1 or per_step["adjoint_resident"] != 1:
        raise AssertionError(f"a captured step holds {per_step} resident launches")
    check_f64_readout_route(launches, "fused 3x3")
    out["nodes_per_step"] = per_step
    log(f"  cooperative launches captured: yes ({launches[1]['rotation_resident']} "
        f"rotation_resident + {launches[1]['adjoint_resident']} adjoint_resident in the "
        f"K=1 capture and its warm-up step); counted graph nodes per step: "
        f"{{{', '.join(f'{a}: {b}' for a, b in per_step.items() if b)}}}")
    out.update(check_replays(runner, adapt, chunks[10], 2, 10, dev, STEP_TOLERANCES, "fused 3x3"))

    for k, rounds in zip(FUSED_KS, FUSED_ROUNDS):
        med, times = steps_in_turns(adapt, chunks[k], k, rounds, dev)
        busy, n_kernels, rows = profile_chunk(chunks[k])
        idle = 1 - busy / (med["fused"] * k)
        out["timing"][k] = dict(fused_ms_per_step=med["fused"], eager_ms_per_step=med["eager"],
                                replay_device_ms=busy, kernel_launches=n_kernels, idle_share=idle,
                                times=times, top=[dict(name=a, launches=b, device_ms=c / 1e3)
                                                  for a, b, c in rows[:8]])
        log(f"  K={k:3d}: fused {med['fused']:.4f} ms/step, eager {med['eager']:.4f} ms/step "
            f"(host clock, median of {2 * rounds}, in turns); replay device kernel time "
            f"{busy / k:.4f} ms/step, {n_kernels} kernels a replay, idle share {idle:.3f}")
    t = out["timing"]
    out["kernels_per_step"] = (t[100]["kernel_launches"] - t[10]["kernel_launches"]) / 90
    log(f"  graph kernel nodes per step (all kernels, torch's included): "
        f"{out['kernels_per_step']:.1f}")
    out["replays"] = runner.replays
    del chunks
    out["resume"] = fused_resume(dev, tmp)
    return out


def fused_resume(dev, tmp):
    """A 3x3 ``run()`` of one epoch (a selection from the empty ansatz, 2
    chunks of K = 10) against the same run stopped after its first chunk
    and resumed from the in-flight file in a fresh ADAPT: the same
    selection, the resumed chunk within STEP_TOLERANCES of the run's."""
    from qsfh_torch.algos.adapt_fused import FusedAdaptRunner

    class Stop(Exception):
        pass

    class StopAfterFirst(FusedAdaptRunner):
        def _save_inflight(self, *args, **kw):
            super()._save_inflight(*args, **kw)
            raise Stop

    whole = build_adapt(dev, tmp, "fused_whole", max_inner_iterations=20)
    FusedAdaptRunner(whole, chunk_iters=10, verbose=False).run()
    cut = build_adapt(dev, tmp, "fused_cut", max_inner_iterations=20)
    try:
        StopAfterFirst(cut, chunk_iters=10, verbose=False).run()
        raise AssertionError("the run did not stop after its first chunk")
    except Stop:
        pass
    again = build_adapt(dev, tmp, "fused_cut", max_inner_iterations=20)
    runner = FusedAdaptRunner(again, chunk_iters=10, verbose=False)
    if runner.load_inflight() is None:
        raise AssertionError("no in-flight file after the first chunk")
    runner.run()
    if again.selected_indices != whole.selected_indices:
        raise AssertionError("the resumed run selected other operators")
    ref = whole.results["iteration loss"][10:]
    got = again.results["iteration loss"]
    if len(got) != len(ref) or len(got) != 10:
        raise AssertionError(f"resumed {len(got)} iterations, the run {len(ref)} after its "
                             f"first chunk")
    for i, (a, b) in enumerate(zip(got, ref)):
        if abs(a - b) > STEP_TOLERANCES[0][1] * abs(b):
            raise AssertionError(f"resumed step {i + 11}: energy {a} vs {b}")
    df, df_ref = again.results["epoch loss df"][-1], whole.results["epoch loss df"][-1]
    log(f"  resume: {len(whole.selected_indices)} operators selected in both; the resumed "
        f"chunk's energies within {STEP_TOLERANCES[0][1]:g} of the run's (last {got[-1]:.10f} "
        f"vs {ref[-1]:.10f}); epoch E_df {df:.12f} vs {df_ref:.12f}")
    return dict(selected=whole.selected_indices, losses=got, losses_ref=ref, e_df=df,
                e_df_ref=df_ref)


def phase_fused_24(adapt24, dev):
    """``FusedAdaptRunner`` on the 2x6 main path's ansatz (first 6 pool
    operators): captures of K = 1, 2 and 8 (graph nodes per step, pool
    memory), one replay of K = 2 against 2 eager steps
    (STEP_TOLERANCES_24), and ms per step at K = 2 and 8 in turns with the
    eager step (a chunk adds one forward pass for the float64 energy and
    Sz, S^2 once: K = 8 is the runner's default)."""
    from qsfh_torch.algos.adapt_fused import FusedAdaptRunner

    adapt24.selected_indices = list(range(N_ANSATZ_24))
    runner = FusedAdaptRunner(adapt24, verbose=False)
    out = dict(timing={})
    chunks = capture_chunks(runner, adapt24, (1, 2, 8), dev, out)
    out["nodes_per_step"] = {name: out["launches"][2][name] - out["launches"][1][name]
                             for name in out["launches"][2]}
    check_f64_readout_route(out["launches"], "fused 2x6")
    log(f"  counted graph nodes per step: "
        f"{{{', '.join(f'{a}: {b}' for a, b in out['nodes_per_step'].items() if b)}}}")
    del chunks[1]
    out.update(check_replays(runner, adapt24, chunks[2], 1, 2, dev, STEP_TOLERANCES_24,
                             "fused 2x6"))
    for k in (2, 8):
        med, times = steps_in_turns(adapt24, chunks[k], k, 2, dev)
        out["timing"][k] = dict(fused_ms_per_step=med["fused"], eager_ms_per_step=med["eager"],
                                times=times)
        log(f"  K={k}: fused {med['fused']:.3f} ms/step, eager {med['eager']:.3f} ms/step (host "
            f"clock, median of 4, in turns)")
    return out


def phase_ed(dev):
    """The port's exact diagonalization of the 3x3 4-state ground manifold on
    the card (complex128): the energy within ED_TOL of the committed cache's,
    the subspace fidelity tr(P_port P_cache) / 4 within ED_TOL of 1; its
    seconds beside the host solve it replaces."""
    import numpy as np
    import torch

    from qsfh_torch.algos.base import HubbardProblem
    from qsfh_torch.io.checkpoint import load_ground_state
    from qsfh_torch.linalg.lanczos import degenerate_ground_space

    c = CONFIG
    p = HubbardProblem(c["x_dimension"], c["y_dimension"], c["tunneling"], c["coulomb"],
                       c["n_electrons"], c["n_spin_up"], c["n_spin_down"],
                       results_root=tempfile.mkdtemp(prefix="qsfh_torch_ed_"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    energy, states = degenerate_ground_space(p.qubit_hamiltonian, p.n_qubits, c["n_electrons"],
                                             c["n_spin_up"], c["n_spin_down"], n_states=4,
                                             device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    e_cache, cached = load_ground_state(GROUND_STATE)
    mine = torch.stack(states).cpu().numpy()
    ref = np.stack(cached)
    overlap = mine.conj() @ ref.T
    fidelity = float(np.sum(np.abs(overlap) ** 2)) / len(cached)
    log(f"  3x3 ED (card, complex128): {len(states)} states, E0 {energy:.15f} (cache "
        f"{e_cache:.15f}, |diff| {abs(energy - E_EXACT):.2e}, tol {ED_TOL:g}), subspace "
        f"fidelity {fidelity:.15f} (tol 1 - {ED_TOL:g}), {seconds:.3f} s (the host solve: "
        f"{HOST_ED_SECONDS} s)")
    if len(states) != 4 or abs(energy - E_EXACT) > ED_TOL or abs(1 - fidelity) > ED_TOL:
        raise AssertionError("the port's 3x3 exact diagonalization disagrees with the cache")
    return dict(energy=energy, fidelity=fidelity, seconds=seconds, n_states=len(states))


# -- HVA: the second driver on the kernels --------------------------------------------------

# the reference's hva_for_3x3.py experiment (benchmarks/demo_hva_3x3/run_3x3_hva.py): 1017
# rotation terms, 71 parameters
CONFIG_HVA = dict(
    reps=10, lr=1e-2, x_dimension=3, y_dimension=3, n_electrons=9, n_spin_up=5, n_spin_down=4,
    tunneling=1, coulomb=6, degenerate_subspace=4, ground_state_path=GROUND_STATE, plot=False,
    log_metrics=False,
)
# 24 qubits: depth cut to 2 reps (252 terms, 9 parameters) and 2 steps for the time limit
CONFIG_HVA_24 = dict(
    reps=2, lr=1e-2, x_dimension=2, y_dimension=6, n_electrons=12, n_spin_up=6, n_spin_down=6,
    tunneling=1, coulomb=6, ground_truth=False, plot=False, log_metrics=False,
)
HVA_SHAPES = {(3, 3, 10): (1017, 71), (3, 3, 2): (225, 15), (2, 6, 2): (252, 9)}
HVA_STEPS_24 = 2
# split vs unrolled energy at reps = 2, complex64 over two lowerings
HVA_ENERGY_RTOL = 1e-5


def build_hva(dev, tmp, name, config=CONFIG_HVA, **extra):
    from qsfh_torch.algos.hva import HVA

    config = dict(config, **extra)
    t0 = time.time()
    hva = HVA(n_epoch=1, results_root=os.path.join(tmp, name), device=dev, **config)
    key = (config["x_dimension"], config["y_dimension"], config["reps"])
    terms = sum(len(r) for r in hva._v_rot + hva._h_rot) * hva.reps + len(hva._u_rot) * (
        hva.reps + 1)
    log(f"HVA {key[0]}x{key[1]} reps={key[2]} ({name}, {hva.circuit_mode}) built in "
        f"{time.time() - t0:.2f} s: {hva.n_qubits} qubits, {terms} rotation terms, "
        f"{sum(hva.sizes)} parameters {hva.sizes}")
    if (terms, sum(hva.sizes)) != HVA_SHAPES[key]:
        raise AssertionError(f"HVA {key}: expected (terms, parameters) {HVA_SHAPES[key]}")
    return hva


def hva_thetas(hva):
    """theta ~ normal(0, 0.05) from default_rng(11), flat [U | v | h], as
    benchmarks/tpu_step_hva.py draws them: zero angles sit on symmetry
    saddles."""
    import numpy as np
    import torch

    rng = np.random.default_rng(11)
    return torch.tensor(rng.normal(0, 0.05, size=sum(hva.sizes)), dtype=hva._rdt,
                        device=hva.device)


def hva_expected(hva):
    """(segment, launches per train step, runs) from the HVA segment's tile
    layouts: the resident kernels up to the chain cap (one launch per span
    of tile runs), the tile runs past it (one launch per run); H psi one
    pauli_apply_grouped launch per tile; E, Sz, S^2 on the inner tiles."""
    from qsfh_torch.algos.hva import hva_program_rot
    from qsfh_torch.engine import kernels as K
    from qsfh_torch.engine import streaming
    from qsfh_torch.engine.compiled import CompiledCircuit

    n = hva.n_qubits
    seg = CompiledCircuit(hva_program_rot(hva.reps, hva._v_rot, hva._h_rot, hva._u_rot),
                          n).segments[0]
    resident = n <= streaming.CHAIN_MAX_QUBITS
    if resident:
        k, c = streaming.RESIDENT_TILE_BITS, streaming.RESIDENT_TILE_LOW_BITS
    else:
        k, c = streaming.TILE_BITS, streaming.TILE_LOW_BITS
    fwd, adj = seg.tiles(1, n, k, c), seg.tiles(-1, n, k, c)
    obs = hva.problem.observables
    h = obs["H"].groups()
    expect = [obs[key].inner_groups() for key in ("H", "Sz", "S^2")]
    per_step = dict.fromkeys(K.launch_counts(), 0)
    if resident:
        per_step.update(rotation_resident=sum(t is not None for t, _, _ in fwd.spans),
                        adjoint_resident=sum(t is not None for t, _, _ in adj.spans))
    else:
        per_step.update(rotation_tile_runs=fwd.n_runs, adjoint_tile_runs=adj.n_runs)
    per_step.update(pauli_rotation=fwd.n_single, adjoint_rotation=adj.n_single,
                    pauli_apply=int(bool(h.spill_index.size)), pauli_apply_grouped=h.n_tiles,
                    expectation_grouped=sum(inner_launches(t, n) for t in expect),
                    pauli_inner=sum(bool(t.spill_index.size) for t in expect))
    runs = dict(forward=fwd.n_runs, adjoint=adj.n_runs, terms=len(seg),
                x0_terms=int((seg.data["xb"] == 0).sum()))
    return seg, per_step, runs


def hva_steps(hva, n_steps, label, per_step=None):
    """``n_steps`` train steps from hva_thetas(), every launch counter set to
    0 just before and read just after each, held to ``per_step`` where
    given; per-step metrics and the summed counts."""
    import torch

    from qsfh_torch.engine import kernels as K

    th = hva_thetas(hva)
    optimizer = torch.optim.Adam([th], lr=hva.lr)
    rows, total = [], dict.fromkeys(K.launch_counts(), 0)
    for i in range(n_steps):
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, e, sz, s2, fid, gnorm = hva._step(th, optimizer)
        e, sz, s2, fid, gnorm = map(float, (e, sz, s2, fid, gnorm))
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        counts = K.launch_counts()
        if per_step is not None and counts != per_step:
            raise AssertionError(f"{label} step {i + 1}: launches {counts}, the layouts "
                                 f"predict {per_step}")
        total = {k: total[k] + v for k, v in counts.items()}
        rows.append(dict(step=i + 1, energy=e, Sz=sz, S2=s2, fidelity=fid, gnorm=gnorm, ms=ms))
    return rows, total


def hva_grads(hva, impl):
    """(E, gradients) of the split stages built on ``impl`` at hva_thetas()."""
    saved = hva.impl
    hva.impl = impl
    try:
        raw = hva._build_stages()
    finally:
        hva.impl = saved
    th = hva_thetas(hva)
    psi = raw["fwd"](th)
    return float(raw["energy"](psi)), raw["adjoint"](psi, raw["cotangent"](psi), th)


def check_grads(g, g_ref, n_u, label):
    """Gradients within GRAD_RTOL of max |g|; logs the Coulomb angles' (the
    trainable x = 0 terms')."""
    tol = GRAD_RTOL * float(g_ref.abs().max())
    diff = float((g - g_ref).abs().max())
    diff_u = float((g[:n_u] - g_ref[:n_u]).abs().max())
    log(f"  [{label}] gradients: max |kernel - plain| = {diff:.3e} (tol {tol:.3e}); the "
        f"{n_u} Coulomb angles (x = 0 terms): max |diff| {diff_u:.3e}, |g_U| "
        f"{float(g_ref[:n_u].abs().min()):.3e}..{float(g_ref[:n_u].abs().max()):.3e}")
    if diff > tol:
        raise AssertionError(f"{label}: the kernels' HVA gradients disagree with the plain "
                             "path's")
    return diff


def hva_kernel_times(hva):
    """The rotation and adjoint kernels of the HVA path on its own segment,
    state (psi at hva_thetas()) and lambda = 2 H psi: the resident kernels
    at 18 qubits (:func:`resident_checks`: against the plain versions, on
    fewer blocks, twice), the tile runs past the chain cap (the engine's
    walk of the layout, one launch per run), each against its plain
    version, timed with CUDA events beside its bound."""
    import torch

    from qsfh_torch.engine import kernels as K
    from qsfh_torch.engine import streaming
    from qsfh_torch.engine.compiled import adjoint_sweep, rotate_segment

    n, dim = hva.n_qubits, 1 << hva.n_qubits
    seg = hva_expected(hva)[0]
    th = hva_thetas(hva)
    d = seg.tensors(hva.device, hva._rdt, th.shape[0])
    angles = torch.cat([th, th.new_ones(1)])[d["pidx"]] * d["scale"]
    rot = (d["xb"], d["zb"], angles, d["phre"], d["phim"])
    adj = tuple(a.flip(0) for a in rot)
    raw = hva._step.raw_stages
    psi = raw["fwd"](th)
    lam = raw["cotangent"](psi)
    results = {}
    record = recorder(results, n)
    if n <= streaming.CHAIN_MAX_QUBITS:
        resident_checks(seg, n, [("HVA forward", 1, rot)], adj, psi, lam, record)
        return results
    T, term_bytes = len(seg), 20 * len(seg)
    got = rotate_segment(seg, psi.clone(), rot, n, 1, K.KERNELS)
    ref = rotate_segment(seg, psi.clone(), rot, n, 1, K.PLAIN)
    buf = psi.clone()
    ms = time_cuda(lambda: rotate_segment(seg, buf, rot, n, 1, K.KERNELS), reps=10)
    plain_ms = timed_once(lambda: rotate_segment(seg, buf, rot, n, 1, K.PLAIN))[0]
    record("rotation_tile_runs", "HVA forward (24 qubits)", T, 2 * 8 * dim + term_bytes,
           [(rel_err(got, ref), max_abs(got, ref))], ms, plain_ms)

    def sweep(impl):
        p, l = psi.clone(), lam.clone()
        return adjoint_sweep(seg, p, l, adj, n, impl), p, l

    got, ref = sweep(K.KERNELS), sweep(K.PLAIN)
    ms = time_cuda(lambda: sweep(K.KERNELS), reps=5)
    plain_ms = timed_once(lambda: sweep(K.PLAIN))[0]
    record("adjoint_tile_runs", "HVA gradient sweep (24 qubits)", T,
           4 * 8 * dim + term_bytes + 8 * T,
           [(rel_err(a, b), max_abs(a, b)) for a, b in zip(got, ref)], ms, plain_ms)
    return results


def plain_hva_steps(hva, n_steps, label):
    """The same steps on the plain versions (no kernel may launch)."""
    from qsfh_torch.engine import kernels as K

    hva.impl = K.PLAIN
    hva._step = hva._build_step()
    try:
        rows, counts = hva_steps(hva, n_steps, label)
    finally:
        hva.impl = K.KERNELS
        hva._step = hva._build_step()
    if any(counts.values()):
        raise AssertionError(f"{label}: the plain path launched a CUDA kernel: {counts}")
    return rows


def phase_hva(dev, tmp):
    """The HVA driver on the card: 3x3 reps = 10 (resident kernels, 5 steps
    against the plain path, gradients, launches, a run() stopped and
    resumed), the reps = 2 unrolled cross-check, and 2x6 reps = 2 (tile
    runs, one step against the plain path)."""
    import torch

    from qsfh_torch.engine import kernels as K

    res = {}
    hva = build_hva(dev, tmp, "hva")
    if hva.dtype != torch.complex64:
        raise AssertionError(f"expected complex64 on cuda, got {hva.dtype}")
    _, per_step, runs = hva_expected(hva)
    if (per_step["rotation_resident"], per_step["adjoint_resident"]) != (1, 1) or \
            per_step["pauli_rotation"] or per_step["adjoint_rotation"]:
        raise AssertionError(f"a 3x3 HVA term fits no resident tile: {per_step}")
    n_u = hva.sizes[0]
    res["steps"], steps_counts = hva_steps(hva, N_STEPS, "hva kernels", per_step)
    check_steps(res["steps"], CONFIG_HVA["n_spin_up"], CONFIG_HVA["n_spin_down"], "hva kernels")
    log(f"  launches per step match the layouts: 1 rotation_resident ({runs['forward']} runs) + "
        f"1 adjoint_resident ({runs['adjoint']} runs) over {runs['terms']} terms "
        f"({runs['x0_terms']} of them x = 0, trainable), {per_step['pauli_apply_grouped']} "
        f"pauli_apply_grouped (one per tile of H), {per_step['expectation_grouped']} "
        f"expectation_grouped (E, Sz, S^2), {per_step['pauli_apply']} pauli_apply, "
        f"{per_step['pauli_inner']} pauli_inner, no per-term rotation")
    e_k, g = hva_grads(hva, K.KERNELS)
    res["plain_steps"] = plain_hva_steps(hva, N_STEPS, "hva plain")
    check_steps(res["plain_steps"], CONFIG_HVA["n_spin_up"], CONFIG_HVA["n_spin_down"],
                "hva plain")
    compare_steps(res["steps"], res["plain_steps"], STEP_TOLERANCES)
    e_p, g_ref = hva_grads(hva, K.PLAIN)
    res["grad_max_abs_diff"] = check_grads(g, g_ref, n_u, "3x3 reps=10")
    res.update(launches_per_step=per_step, runs=runs, step_ms=median_ms(res["steps"]),
               plain_step_ms=median_ms(res["plain_steps"]))
    log("  the resident kernels on the HVA segment (CUDA events, ms per call):")
    res["kernels"] = hva_kernel_times(hva)
    log(f"  3x3 HVA step {res['step_ms']:.3f} ms host clock (median of steps 2-{N_STEPS}), "
        f"plain versions {res['plain_step_ms']:.1f} ms")

    # a short run(): 2 epochs and a checkpoint, resumed from it to 3, against
    # the same driver carried on in process (its live Adam)
    run_a = build_hva(dev, tmp, "hva_run")
    run_a.n_epoch = 2
    run_a.params_t = hva_thetas(run_a)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    run_a.run()
    torch.cuda.synchronize()
    res["run_s"] = time.perf_counter() - t0
    run_counts = K.launch_counts()
    if not os.path.exists(run_a.model_filepath):
        raise AssertionError("HVA run() wrote no checkpoint")
    run_b = build_hva(dev, tmp, "hva_run", load_model=True)
    run_b.n_epoch = 3
    run_a.n_epoch = 3
    K.reset_launch_counts()
    resumed = run_b.run()["loss"]
    straight = run_a.run()["loss"]
    run_counts = {k: v + K.launch_counts()[k] for k, v in run_counts.items()}
    want = {k: 4 * v for k, v in per_step.items()}  # 2 + 1 + 1 steps
    if run_counts != want:
        raise AssertionError(f"HVA run(): launches {run_counts}, 4 steps predict {want}")
    diff = max(abs(a - b) for a, b in zip(resumed, straight))
    log(f"  run(): losses {straight} in process, {resumed} resumed from the checkpoint "
        f"(max |diff| {diff:.3e}); {res['run_s']:.2f} s for 2 epochs")
    if len(straight) != 3 or len(resumed) != 3 or not all(map(math.isfinite, straight)) or \
            diff > 1e-6 * max(abs(v) for v in straight):
        raise AssertionError("the resumed HVA run() disagrees with the run carried on")
    res["launches"] = {k: steps_counts[k] + run_counts[k] for k in steps_counts}
    res["run_losses"] = straight
    del run_a, run_b

    # the unrolled cross-check at reps = 2 (autograd keeps every gate's state)
    split2 = build_hva(dev, tmp, "hva_r2", reps=2)
    unrolled2 = build_hva(dev, tmp, "hva_r2u", reps=2, circuit_mode="unrolled")
    e_s, g_s = hva_grads(split2, K.KERNELS)
    th = hva_thetas(unrolled2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms_first, out = timed_once(lambda: unrolled2._step(th, torch.optim.Adam([th], lr=1e-2)))
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    e_u = float(out[2])
    again = hva_thetas(unrolled2)  # a second call: the first pays one-time set-up
    ms, _ = timed_once(lambda: unrolled2._step(again, torch.optim.Adam([again], lr=1e-2)))
    diff_e = abs(e_u - e_s) / abs(e_s)
    g_diff = float((th.grad - g_s).abs().max())
    log(f"  unrolled cross-check (3x3 reps=2): E split {e_s:.7f} unrolled {e_u:.7f} (rel "
        f"{diff_e:.2e}, tol {HVA_ENERGY_RTOL:g}); gradients max |diff| {g_diff:.3e} (tol "
        f"{GRAD_RTOL * float(g_s.abs().max()):.3e}); unrolled step {ms:.1f} ms (first call "
        f"{ms_first:.1f}), {peak:.0f} MiB of autograd memory")
    if diff_e > HVA_ENERGY_RTOL or g_diff > GRAD_RTOL * float(g_s.abs().max()):
        raise AssertionError("the unrolled HVA lowering disagrees with the split lowering")
    res["unrolled"] = dict(energy_rel_err=diff_e, grad_max_abs_diff=g_diff, ms=ms,
                           first_ms=ms_first, autograd_mib=peak)
    del split2, unrolled2, out

    # 24 qubits: the tile runs on the same driver
    hva24 = build_hva(dev, tmp, "hva24", CONFIG_HVA_24)
    _, per_step24, runs24 = hva_expected(hva24)
    if per_step24["pauli_rotation"] or per_step24["adjoint_rotation"] or \
            per_step24["rotation_resident"]:
        raise AssertionError(f"a 2x6 HVA term fits no tile: {per_step24}")
    rows24, counts24 = hva_steps(hva24, HVA_STEPS_24, "hva 24q kernels", per_step24)
    check_steps(rows24, 6, 6, "hva 24q kernels", e_floor=None)
    _, g24 = hva_grads(hva24, K.KERNELS)
    plain24 = plain_hva_steps(hva24, 1, "hva 24q plain")
    check_steps(plain24, 6, 6, "hva 24q plain", e_floor=None)
    compare_steps(rows24[:1], plain24, STEP_TOLERANCES_24)
    _, g24_ref = hva_grads(hva24, K.PLAIN)
    check_grads(g24, g24_ref, hva24.sizes[0], "2x6 reps=2")
    log(f"  2x6 HVA: {runs24['forward']} forward and {runs24['adjoint']} adjoint tile runs per "
        f"step ({runs24['x0_terms']} x = 0 terms), {per_step24['pauli_apply_grouped']} "
        f"pauli_apply_grouped, {per_step24['expectation_grouped']} expectation_grouped; step "
        f"{rows24[-1]['ms']:.2f} ms host clock (step {HVA_STEPS_24}), plain "
        f"{plain24[0]['ms']:.0f} ms")
    log("  the tile-run kernels on the 2x6 HVA segment (CUDA events, ms per call):")
    res["hva_24"] = dict(steps=rows24, plain_steps=plain24, launches=counts24,
                         launches_per_step=per_step24, runs=runs24, step_ms=rows24[-1]["ms"],
                         kernels=hva_kernel_times(hva24))
    return res, hva, hva24


# -- iQCC: the third driver family on the kernels -------------------------------------------

# benchmarks/demo_iqcc_2x3_r4/run_ilc.py's arguments, from scratch, cut to 3 epochs of at most
# 150 inner iterations (epochs 1-3 select 10, 61 and 258 generators in run_dense.log)
CONFIG_IQCC_2X3 = dict(
    n_epoch=3, lr=1e-2, threshold=5e-3, max_inner_iterations=150, inner_optimizer="lbfgs",
    dense_dressing=True, ilc=True, ilc_cap=48, ilc_rounds=3, plot=False, log_metrics=False,
)
IQCC_2X3_EXACT = -6.332962199384616  # full-space lowest eigenvalue of the 2x3 U = 4 H
# the reference's molecular configuration (iqcc.py:207-213), cut to 2 epochs of at most 150
CONFIG_IQCC_LIH = dict(n_epoch=2, lr=1e-2, threshold=1e-2, max_inner_iterations=150, plot=False,
                       log_metrics=False)
# the reference iqcc_hubbard.py:215-231 config, cut to 3 epochs
CONFIG_IQCC_2X2 = dict(n_epoch=3, lr=1e-2, threshold=5e-3, plot=False, log_metrics=False)
IQCC_ENERGY_RTOL = 1e-4
# the dressed matrix after each dressing and ILC fold: lowest eigenvalue (absolute) and
# Frobenius norm (relative) against the undressed one's; the fold's predicted energy
IQCC_SPECTRUM_TOL, IQCC_NORM_RTOL, IQCC_FOLD_TOL = 1e-9, 1e-10, 1e-10
IQCC_12Q_KERNELS = ("rotation_resident", "adjoint_resident", "screen_grouped")
IQCC_SYMBOLIC_KERNELS = IQCC_12Q_KERNELS + ("expectation_grouped", "pauli_apply_grouped")
IQCC_PER_TERM_KERNELS = ("pauli_rotation", "adjoint_rotation", "pauli_inner", "pauli_apply")


def build_iqcc(dev, tmp, name, hamiltonian, config, **extra):
    """An IQCC driver on ``dev`` whose per-iteration lines are not echoed."""
    from qsfh_torch.algos.iqcc import IQCC

    driver = IQCC(hamiltonian, results_root=os.path.join(tmp, name), tag=name, device=dev,
                  **dict(config, **extra))
    driver.metrics.echo = False
    return driver


def iqcc_run(driver, label, tmp, plain=False):
    """``driver.run()`` with every launch counter set to 0 just before and
    read just after (its printed lines to a file under ``tmp``), the epoch's
    observable, segment and trained parameters kept from each epoch; with
    ``plain`` on the plain versions, where no kernel may launch.  Returns
    (launches, captures by epoch, seconds)."""
    import torch

    from qsfh_torch.engine import kernels as K

    captured = {}
    drive = driver._drive

    def capture(observable, seg, *args, **kwargs):
        inner = drive(observable, seg, *args, **kwargs)
        captured[len(driver.loss_history["epoch"]) + 1] = (
            observable, seg, {k: v.detach().clone() for k, v in driver.params.items()})
        return inner

    driver._drive = capture
    driver.impl = K.PLAIN if plain else K.KERNELS
    try:
        with open(os.path.join(tmp, f"{label}.log"), "a") as fh, contextlib.redirect_stdout(fh):
            K.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            driver.run()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = K.launch_counts()
    finally:
        driver._drive = drive
        driver.impl = K.KERNELS
    if plain and any(counts.values()):
        raise AssertionError(f"{label}: the plain path launched a CUDA kernel: {counts}")
    return counts, captured, seconds


def iqcc_epochs(driver, exact, label):
    """Per-epoch records from ``driver.epoch_stats``: selected, DIS size, H
    terms, energy, error to ``exact``, ms per inner step (median) and the
    phases' ms; logged; raises on a non-finite or sub-exact energy."""
    rows = []
    for st in driver.epoch_stats:
        steps = sorted(st.get("step_ms", []))
        row = dict(epoch=st["epoch"], selected=st["selected"], dis_size=st["dis_size"],
                   h_terms=st["h_terms"], energy=st["energy"], error=st["energy"] - exact,
                   steps=len(steps), step_ms_median=steps[len(steps) // 2] if steps else None,
                   **{k: st[k] for k in ("dis_ms", "screen_ms", "layout_ms", "dress_ms",
                                         "dress_u_ms", "dress_zgemm_ms", "ilc_ms", "ilc")
                      if k in st})
        rows.append(row)
        extra = " ".join(f"{k}={row[k]:.1f}" for k in ("dis_ms", "layout_ms", "screen_ms",
                                                         "dress_ms", "dress_u_ms",
                                                         "dress_zgemm_ms") if k in row)
        folds = ", ".join(f"{ms:.1f}" for ms in row.get("ilc_ms", []))
        log(f"  [{label}] epoch {row['epoch']}: {row['selected']} selected of {row['dis_size']} "
            f"DIS generators, H terms {row['h_terms']}, E {row['energy']:.9f} (error "
            f"{row['error']:.6f}), {row['steps']} inner steps, median "
            f"{row['step_ms_median']:.2f} ms; {extra}" + (f"; ILC folds ms [{folds}]"
                                                          if folds else ""))
        if not math.isfinite(row["energy"]) or row["energy"] < exact - 1e-4:
            raise AssertionError(f"{label}: epoch energy {row['energy']} against exact {exact}")
    return rows


def iqcc_off_minimum(params):
    """The trained parameters with tau moved off the epoch's minimum by
    normal(0, 0.1) from default_rng(11): at the minimum every gradient is
    below the threshold, where only float32 rounding is left to compare."""
    import numpy as np
    import torch

    tau = params["tau"]
    noise = np.random.default_rng(11).normal(0, 0.1, size=tau.shape[0])
    return dict(params, tau=tau + torch.as_tensor(noise, dtype=tau.dtype, device=tau.device))


def iqcc_grads(driver, captured, impl):
    """(E, {tau, theta, phi} gradients, launches) of one loss and gradient
    evaluation on an epoch's observable and segment, at its trained
    parameters moved off the minimum (:func:`iqcc_off_minimum`), through
    ``impl``."""
    import torch

    from qsfh_torch.engine import kernels as K

    obs, seg, params = captured
    p = {k: v.clone().requires_grad_(True) for k, v in iqcc_off_minimum(params).items()}
    K.reset_launch_counts()
    e = obs.expectation_auto(driver._state(p, seg, impl), impl=impl)
    e.backward()
    torch.cuda.synchronize()
    return float(e.detach()), {k: v.grad for k, v in p.items()}, K.launch_counts()


def iqcc_hold(driver, captured, label):
    """The kernel path against the plain path on an epoch's segment and
    state (:func:`iqcc_grads`): E within 1e-4 relative, the tau, theta and
    phi gradients within GRAD_RTOL of the largest |g|; returns (errors, the
    kernel evaluation's launches)."""
    from qsfh_torch.engine import kernels as K

    e_k, g_k, launches = iqcc_grads(driver, captured, K.KERNELS)
    e_p, g_p, plain_launches = iqcc_grads(driver, captured, K.PLAIN)
    if any(plain_launches.values()):
        raise AssertionError(f"{label}: the plain evaluation launched {plain_launches}")
    # one scale, the largest |g| of the three: phi's gradient vanishes where
    # theta sits at 0 or pi (a basis state's phases are global)
    scale = max(float(g.abs().max()) for g in g_p.values())
    errs = dict(energy_rel=abs(e_k - e_p) / abs(e_p), grad_scale=scale)
    for k in ("tau", "theta", "phi"):
        errs[k] = float((g_k[k] - g_p[k]).abs().max()) / scale
    log(f"  [{label}] kernel vs plain on the epoch's segment ({len(captured[1])} terms): E "
        f"{e_k:.7f} vs {e_p:.7f} (rel {errs['energy_rel']:.2e}, tol {IQCC_ENERGY_RTOL:g}); "
        f"gradients, max |diff| / max |g| ({scale:.3e}): " + ", ".join(
            f"{k} {errs[k]:.2e}" for k in ("tau", "theta", "phi")) + f" (tol {GRAD_RTOL:g})")
    if errs["energy_rel"] > IQCC_ENERGY_RTOL or \
            max(errs[k] for k in ("tau", "theta", "phi")) > GRAD_RTOL:
        raise AssertionError(f"{label}: the kernels' iQCC energy or gradients disagree with the "
                             "plain path's")
    return errs, {k: v for k, v in launches.items() if v}


def iqcc_kernel_times(driver, captured, label):
    """The rotation kernels of an epoch's segment at its final state and
    lambda = 2 H psi (the trained parameters moved off the minimum,
    :func:`iqcc_off_minimum`), against their plain versions and timed: the resident
    kernels (:func:`resident_checks`) where every term fits one span of
    resident tiles, else the engine's walk of the layout; for a symbolic
    H also the inner-product tiles (E and the DIS screen) and H psi on the
    application tiles (:func:`inner_fold_checks`, :func:`apply_tiles_check`)."""
    import torch

    from qsfh_torch.engine import kernels as K
    from qsfh_torch.engine import streaming
    from qsfh_torch.engine.compiled import adjoint_sweep, rotate_segment
    from qsfh_torch.engine.expectation import Observable, PackedPool
    from qsfh_torch.ops.dressing import dis_generators

    obs, seg, params = captured
    params = iqcc_off_minimum(params)
    n, dim = driver.n_qubits, 1 << driver.n_qubits
    results = {}
    record = recorder(results, n)
    with torch.no_grad():
        psi = driver._state(params, seg)
        lam = 2.0 * obs.apply_auto(psi)
    d = seg.tensors(psi.device, driver._rdt, params["tau"].shape[0])
    angles = torch.cat([params["tau"], params["tau"].new_ones(1)])[d["pidx"]] * d["scale"]
    rot = (d["xb"], d["zb"], angles, d["phre"], d["phim"])
    adj = tuple(a.flip(0) for a in rot)
    shape = (streaming.RESIDENT_TILE_BITS, streaming.RESIDENT_TILE_LOW_BITS)
    layouts = [seg.tiles(direction, n, *shape) for direction in (1, -1)]
    if all(len(lay.spans) == 1 and not lay.n_single for lay in layouts):
        resident_checks(seg, n, [(f"{label} forward", 1, rot)], adj, psi, lam, record)
    else:
        T = len(seg)
        got = rotate_segment(seg, psi.clone(), rot, n, 1, K.KERNELS)
        ref = rotate_segment(seg, psi.clone(), rot, n, 1, K.PLAIN)
        buf = psi.clone()
        ms = time_cuda(lambda: rotate_segment(seg, buf, rot, n, 1, K.KERNELS), reps=20)
        plain_ms = timed_once(lambda: rotate_segment(seg, buf, rot, n, 1, K.PLAIN))[0]
        log(f"  [{label}] the segment spans {len(layouts[0].spans)} resident launches and "
            "per-term terms: timed as the engine walks it")
        record("rotation_resident", f"{label} forward (engine walk)", T, 2 * 8 * dim + 20 * T,
               [(rel_err(got, ref), max_abs(got, ref))], ms, plain_ms)

        def sweep(impl):
            p, l = psi.clone(), lam.clone()
            return adjoint_sweep(seg, p, l, adj, n, impl), p, l

        got, ref = sweep(K.KERNELS), sweep(K.PLAIN)
        ms = time_cuda(lambda: sweep(K.KERNELS), reps=20)
        plain_ms = timed_once(lambda: sweep(K.PLAIN))[0]
        record("adjoint_resident", f"{label} gradient sweep (engine walk)", T,
               4 * 8 * dim + 20 * T + 8 * T,
               [(rel_err(a, b), max_abs(a, b)) for a, b in zip(got, ref)], ms, plain_ms)
    if isinstance(obs, Observable):
        pool = PackedPool([0.5 * P for _, P in dis_generators(obs.op)], n)
        w = obs.apply_scan(psi)
        inner_fold_checks([(f"{label} <psi|H|psi>", obs, psi, psi),
                           (f"{label} DIS screen <w|P|psi>", pool, w, psi)], record)
        xs, zs, c = obs._tensors(psi)
        ref = K.pauli_apply_grouped_plain(psi, xs, zs, c.real, c.imag, obs.groups())
        plain_ms = time_cuda(lambda: K.pauli_apply_grouped_plain(psi, xs, zs, c.real, c.imag,
                                                                 obs.groups()), reps=2, warmup=1)
        library_ms = library_sparse_apply(psi, xs, zs, c, ref)
        apply_tiles_check(obs, psi, ref, plain_ms, library_ms, record, f"{label} H psi (tiles)")
    return results


def check_iqcc_launches(counts, names, label, absent=()):
    """Every kernel of ``names`` launched in the run, none of ``absent``."""
    missing = [k for k in names if not counts[k]]
    stray = [k for k in absent if counts[k]]
    if missing or stray:
        raise AssertionError(f"{label}: no launch of {missing}, or launches of {stray}: {counts}")
    log(f"  [{label}] launches: " + ", ".join(f"{k} {v}" for k, v in counts.items() if v))


def iqcc_dense_checks(recorded, h0_norm, exact):
    """Each dressed matrix the run made (after each dress_dense and each ILC
    fold): its lowest eigenvalue within IQCC_SPECTRUM_TOL of ``exact``,
    its Frobenius norm within IQCC_NORM_RTOL of the undressed one's; each
    fold's predicted energy within IQCC_FOLD_TOL of <psi|H_folded|psi>."""
    import torch

    rows = []
    for kind, H, psi, e_pred in recorded:
        t0 = time.perf_counter()
        e0 = float(torch.linalg.eigvalsh(H)[0])
        eig_s = time.perf_counter() - t0
        norm_rel = abs(float(torch.linalg.matrix_norm(H)) - h0_norm) / h0_norm
        row = dict(kind=kind, lowest=e0, spectrum_err=abs(e0 - exact), norm_rel=norm_rel,
                   eigvalsh_s=eig_s)
        if kind == "ilc":
            row["fold_err"] = abs(float(torch.real(torch.vdot(psi, H @ psi))) - e_pred)
        rows.append(row)
        if row["spectrum_err"] > IQCC_SPECTRUM_TOL or norm_rel > IQCC_NORM_RTOL or \
                row.get("fold_err", 0.0) > IQCC_FOLD_TOL:
            raise AssertionError(f"the dense dressing on the card is not exact: {row}")
    log(f"  {len(rows)} dressed matrices ({sum(r['kind'] == 'ilc' for r in rows)} ILC folds): "
        f"lowest eigenvalue within {max(r['spectrum_err'] for r in rows):.2e} of {exact} (tol "
        f"{IQCC_SPECTRUM_TOL:g}), Frobenius norm within "
        f"{max(r['norm_rel'] for r in rows):.2e} relative (tol {IQCC_NORM_RTOL:g}), folds' "
        f"predicted energy within {max(r.get('fold_err', 0.0) for r in rows):.2e} (tol "
        f"{IQCC_FOLD_TOL:g}); eigvalsh {sum(r['eigvalsh_s'] for r in rows):.1f} s in all")
    return rows


def phase_iqcc(dev, tmp):
    """The iQCC driver on the card: the 2x3 dense-exact iQCC-ILC campaign and
    LiH (symbolic) at 12 qubits, the 2x2 reference config at 8 qubits."""
    import torch

    import qsfh_torch.algos.iqcc as iqcc_mod
    from qsfh_torch.engine import kernels as K
    from qsfh_torch.molecules import LiH
    from qsfh_torch.ops.lattice import fermi_hubbard

    res, launches = {}, dict.fromkeys(K.launch_counts(), 0)

    # 1. 2x3 dense-exact iQCC-ILC, each dressed matrix kept for the checks
    t0 = time.perf_counter()
    d23 = build_iqcc(dev, tmp, "iqcc_2x3_dense", fermi_hubbard(2, 3, 1.0, 4.0, periodic=True),
                     CONFIG_IQCC_2X3)
    build_s = time.perf_counter() - t0
    if abs(d23.ground_state_energy - IQCC_2X3_EXACT) > IQCC_SPECTRUM_TOL:
        raise AssertionError(f"2x3 ground truth {d23.ground_state_energy} on the card")
    recorded = []
    similarity, ilc_step = iqcc_mod.similarity, iqcc_mod.ilc_step_dense

    def dressed(U, H):
        out = similarity(U, H)
        recorded.append(("dress", out, None, None))
        return out

    def folded(H, psi, gens, n, cap=32):
        Hd, e, info = ilc_step(H, psi, gens, n, cap=cap)
        recorded.append(("ilc", Hd, psi, e))
        return Hd, e, info

    h0 = iqcc_mod.paulisum_to_dense_fast(d23.current_hamiltonian, d23.n_qubits, dev)
    iqcc_mod.similarity, iqcc_mod.ilc_step_dense = dressed, folded
    try:
        counts, captured, seconds = iqcc_run(d23, "iqcc_2x3_dense", tmp)
    finally:
        iqcc_mod.similarity, iqcc_mod.ilc_step_dense = similarity, ilc_step
    log(f"  2x3 dense iQCC-ILC (12 qubits, L-BFGS): {seconds:.1f} s for 3 epochs (driver and "
        f"ground truth built in {build_s:.1f} s)")
    rows = iqcc_epochs(d23, IQCC_2X3_EXACT, "2x3 dense")
    check_iqcc_launches(counts, IQCC_12Q_KERNELS, "2x3 dense",
                        absent=("expectation_grouped", "pauli_apply_grouped"))
    launches = {k: launches[k] + v for k, v in counts.items()}
    errs, per_step = iqcc_hold(d23, captured[2], "2x3 dense epoch 2")
    checks = iqcc_dense_checks(recorded, float(torch.linalg.matrix_norm(h0)), IQCC_2X3_EXACT)
    del recorded, h0
    kern = iqcc_kernel_times(d23, captured[2], "2x3 epoch 2")
    res["2x3_dense"] = dict(epochs=rows, launches=counts, seconds=seconds, hold=errs,
                            launches_per_step=per_step, dense_checks=checks, kernels=kern,
                            selected_ops=len(d23.selected_ops))
    del d23, captured

    # 2. LiH, r = 0.8, symbolic dressing, Adam
    t0 = time.perf_counter()
    mol = LiH(0.8)
    lih = build_iqcc(dev, tmp, "iqcc_lih", mol, CONFIG_IQCC_LIH)
    build_s = time.perf_counter() - t0
    counts, captured, seconds = iqcc_run(lih, "iqcc_lih", tmp)
    log(f"  LiH r=0.8 (12 qubits, symbolic, Adam): {seconds:.1f} s for 2 epochs; molecule, "
        f"FCI {mol.fci_energy:.9f} and driver in {build_s:.1f} s")
    rows = iqcc_epochs(lih, mol.fci_energy, "LiH")
    check_iqcc_launches(counts, IQCC_SYMBOLIC_KERNELS, "LiH")
    launches = {k: launches[k] + v for k, v in counts.items()}
    errs, per_step = iqcc_hold(lih, captured[2], "LiH epoch 2")
    kern = iqcc_kernel_times(lih, captured[2], "LiH epoch 2")
    res["lih"] = dict(epochs=rows, launches=counts, seconds=seconds, hold=errs,
                      launches_per_step=per_step, kernels=kern, fci=mol.fci_energy,
                      hf=mol.hf_energy)
    del lih, captured

    # 3. 2x2, the reference config: per-term kernels, against the plain path
    h22 = fermi_hubbard(2, 2, 1.0, 4.0, periodic=True)
    k22 = build_iqcc(dev, tmp, "iqcc_2x2", h22, CONFIG_IQCC_2X2)
    counts, captured, seconds = iqcc_run(k22, "iqcc_2x2", tmp)
    log(f"  2x2 (8 qubits, symbolic, Adam): {seconds:.1f} s for 3 epochs")
    rows = iqcc_epochs(k22, k22.ground_state_energy, "2x2")
    check_iqcc_launches(counts, IQCC_PER_TERM_KERNELS, "2x2",
                        absent=IQCC_SYMBOLIC_KERNELS)
    launches = {k: launches[k] + v for k, v in counts.items()}
    _, per_step = iqcc_hold(k22, captured[2], "2x2 epoch 2")
    p22 = build_iqcc(dev, tmp, "iqcc_2x2_plain", h22, CONFIG_IQCC_2X2)
    _, _, plain_s = iqcc_run(p22, "iqcc_2x2_plain", tmp, plain=True)
    plain_rows = iqcc_epochs(p22, p22.ground_state_energy, "2x2 plain")
    diffs = [abs(a["energy"] - b["energy"]) / abs(b["energy"]) for a, b in zip(rows, plain_rows)]
    log(f"  2x2 epoch energies against the plain path's ({plain_s:.1f} s): rel "
        + ", ".join(f"{d:.2e}" for d in diffs) + f" (tol {IQCC_ENERGY_RTOL:g})")
    if len(rows) != len(plain_rows) or max(diffs) > IQCC_ENERGY_RTOL:
        raise AssertionError("2x2: the kernels' epoch energies disagree with the plain path's")
    res["2x2"] = dict(epochs=rows, plain_epochs=plain_rows, launches=counts, seconds=seconds,
                      plain_seconds=plain_s, energy_rel=diffs, launches_per_step=per_step)
    res["launches"] = launches
    return res


# -- product states at 26-30 qubits, HEA, VQD, dynamics, ITE ----------------------------

# the 26-30 qubit lattices of benchmarks/tpu_stream_big.py:35-36: t=1, U=6,
# periodic, the state a phased product state (closed-form expectations)
BIG_LATTICES = {26: (1, 13), 28: (2, 7), 30: (3, 5)}
BIG_RTOL = 1e-4  # E, |psi|^2, screen and <phi|H psi> against the float64 closed form
BIG_GRAD_RTOL = 1e-3  # adjoint gradients against central differences, of max |g|
BIG_ROTATIONS = 8
# w and phi are psi with this many qubits' angles drawn anew: every other
# per-qubit overlap is 1, so the screen and <phi|H psi> are O(|c|) where two
# unrelated product states would give ~2^(-n/2) |c|
BIG_CHANGED = 3
# the kernels of the product-state path, by the check that drives each
BIG_KERNELS = ("expectation_grouped", "screen_grouped", "pauli_apply_grouped",
               "rotation_tile_runs", "adjoint_tile_runs")


def big_rotations(n, rng):
    """Hopping-like rotations: flips on two qubits i < j at most 3 apart,
    the Jordan-Wigner Z string between them, every second term a YY (both
    ends in z too); angles in [0.2, 1.0), every third negative."""
    rots = []
    for k in range(BIG_ROTATIONS):
        i = int(rng.integers(0, n - 1))
        j = min(n - 1, i + int(rng.integers(1, 4)))
        x = (1 << i) | (1 << j)
        z = sum(1 << q for q in range(i + 1, j)) | (x if k % 2 else 0)
        rots.append((x, z, float(rng.uniform(0.2, 1.0)) * (-1.0 if k % 3 == 0 else 1.0)))
    return rots


def big_closed_grads(H, n, rots, th, al, h=1e-5):
    """dE/dtheta_t of the rotated product state by central differences of the
    dressed closed form (float64)."""
    import numpy as np

    from qsfh_torch.engine import product_state as ps

    out = []
    for t in range(len(rots)):
        e = [ps.product_expectation(ps.rotated_hamiltonian(
            H, [(x, z, a + (d if k == t else 0.0)) for k, (x, z, a) in enumerate(rots)]),
            n, th, al) for d in (h, -h)]
        out.append((e[0] - e[1]) / (2 * h))
    return np.asarray(out)


def big_size(n, lattice, dev):
    """One lattice of phase_product_state: the checks against the closed
    forms (every launch counter set to 0 just before, read just after),
    then the kernels' times beside their bounds."""
    import numpy as np
    import torch

    from qsfh_torch.engine import kernels as K
    from qsfh_torch.engine import product_state as ps
    from qsfh_torch.engine import streaming
    from qsfh_torch.engine.compiled import (
        CompiledCircuit, adjoint_sweep, rotate_segment, run_rot_adjoint)
    from qsfh_torch.engine.expectation import Observable, PackedPool
    from qsfh_torch.ops.jw import jordan_wigner
    from qsfh_torch.ops.lattice import fermi_hubbard
    from qsfh_torch.ops.pauli import PauliSum
    from qsfh_torch.ops.pool import hubbard_interaction_pool_simplified

    x, y = lattice
    dim, t_host = 1 << n, time.perf_counter()
    H = jordan_wigner(fermi_hubbard(x, y, 1.0, 6.0, periodic=True))
    obs = Observable(H, n)
    pool = PackedPool([jordan_wigner(g) for g in hubbard_interaction_pool_simplified(x, y)], n)
    rng = np.random.default_rng(n)
    th, al = rng.uniform(0.4, 2.7, n), rng.uniform(-np.pi, np.pi, n)
    changed = rng.choice(n, BIG_CHANGED, replace=False)
    thw, alw = th.copy(), al.copy()
    thw[changed] = rng.uniform(0.4, 2.7, BIG_CHANGED)
    alw[changed] = rng.uniform(-np.pi, np.pi, BIG_CHANGED)
    rots = big_rotations(n, rng)
    ops, thetas = ps.rotation_ops(n, rots)
    (seg,) = CompiledCircuit(ops, n).segments
    fwd = seg.tiles(1, n, streaming.TILE_BITS, streaming.TILE_LOW_BITS)
    adj = seg.tiles(-1, n, streaming.TILE_BITS, streaming.TILE_LOW_BITS)
    if fwd.n_single or adj.n_single:
        raise AssertionError(f"{n} qubits: a rotation fits no tile")
    # the closed forms (host, float64)
    e_closed = ps.product_expectation(H, n, th, al)
    dressed = ps.rotated_hamiltonian(H, rots)
    e_rot_closed = ps.product_expectation(dressed, n, th, al)
    g_closed = big_closed_grads(H, n, rots, th, al)
    gens = pool.generators
    ks = np.repeat(np.arange(len(gens)), [len(g) for g in gens])
    flat = PauliSum(np.concatenate([g.x for g in gens]), np.concatenate([g.z for g in gens]),
                    np.concatenate([g.c for g in gens]))
    v_pool = ps.product_pair_term_values(flat, n, (thw, alw), (th, al))
    screen_closed = np.bincount(ks, 2.0 * v_pool.imag, len(gens))
    screen_scale = float(np.abs(screen_closed).max())
    h_phi_psi = ps.product_pair_term_values(H, n, (thw, alw), (th, al)).sum()
    obs.groups(), obs.inner_groups(), pool.inner_groups()  # host layouts, built once
    host_s = time.perf_counter() - t_host
    th_t = torch.tensor(thetas, dtype=torch.float32, device=dev)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_dev = time.perf_counter()
    K.reset_launch_counts()
    build_ms, psi = timed_once(lambda: ps.product_state(n, th, al, dev))
    e = float(obs.expectation_scan(psi))
    norm = float(torch.vdot(psi, psi).real)
    phi = ps.product_state(n, thw, alw, dev)
    screen = pool.screen_scan(psi, phi).double().cpu().numpy()
    h_psi = obs.apply_scan(psi)
    phi_h_psi = complex(torch.vdot(phi, h_psi))
    del phi, h_psi  # at 30 qubits each state is 8 GiB
    rotated = CompiledCircuit(ops, n).apply(psi, th_t)
    e_rot = float(obs.expectation_scan(rotated))
    lam = obs.apply_scan(rotated).mul_(2.0)
    p_buf, l_buf, grads = run_rot_adjoint(seg, rotated, lam, th_t, n)
    grads = grads.double().cpu().numpy()
    torch.cuda.synchronize()
    counts = K.launch_counts()
    device_s = time.perf_counter() - t_dev

    def screen_err(got):
        return float(np.abs(got - screen_closed).max() / screen_scale)

    def h_psi_err(got):
        return abs(got - h_phi_psi) / abs(h_phi_psi)

    errs = dict(
        energy=abs(e - e_closed) / abs(e_closed), norm=abs(norm - 1.0),
        rotated_energy=abs(e_rot - e_rot_closed) / abs(e_rot_closed),
        gradient=float(np.abs(grads - g_closed).max() / np.abs(g_closed).max()),
        screen=screen_err(screen), h_psi=h_psi_err(phi_h_psi))
    log(f"  {n} qubits ({x}x{y}, {len(H)} H terms, {pool.size} pool generators / "
        f"{pool.scan_arrays()[0].size} terms, {len(seg)} rotations in {fwd.n_runs} / "
        f"{adj.n_runs} tile runs, dressed H {len(dressed)} terms): E {e:.7f} (closed "
        f"{e_closed:.7f}, rel {errs['energy']:.2e}), |psi|^2 - 1 {norm - 1.0:.2e}, rotated E "
        f"rel {errs['rotated_energy']:.2e}, gradients {errs['gradient']:.2e} of max |g| "
        f"{np.abs(g_closed).max():.4f}, screen {errs['screen']:.2e} of max |screen| "
        f"{screen_scale:.4f}, <phi|H psi> {h_phi_psi:.4f} rel {errs['h_psi']:.2e} (tol "
        f"{BIG_RTOL:g}; gradients {BIG_GRAD_RTOL:g})")
    if max(errs["energy"], errs["norm"], errs["rotated_energy"], errs["screen"],
           errs["h_psi"]) > BIG_RTOL or errs["gradient"] > BIG_GRAD_RTOL:
        raise AssertionError(f"{n} qubits: the kernels disagree with the closed forms: {errs}")
    for name in BIG_KERNELS:
        if not counts[name]:
            raise AssertionError(f"{n} qubits: {name} did not launch on the product-state path")
    runs = {"rotation_tile_runs": fwd.n_runs, "adjoint_tile_runs": adj.n_runs}
    for name, expected in runs.items():
        if counts[name] != expected:
            raise AssertionError(f"{n} qubits: {counts[name]} {name} launches, the layout "
                                 f"has {expected} runs")

    # times, after the counted path, on buffers reused in place; each state
    # freed once its timings are taken
    d = seg.tensors(dev, torch.float32, len(rots))
    angles = th_t[d["pidx"]] * d["scale"]
    arrs = (d["xb"], d["zb"], angles, d["phre"], d["phim"])
    rev = tuple(a.flip(0) for a in arrs)
    xs, zs, c = obs._tensors(psi)
    pxs = pool._tensors(psi)[0]
    times = {"adjoint_tile_runs": (
        time_cuda(lambda: adjoint_sweep(seg, p_buf, l_buf, rev, n), 3, 1), 32 * dim,
        20 * len(seg) * dim)}
    del p_buf, l_buf, lam
    times["rotation_tile_runs"] = (time_cuda(lambda: rotate_segment(seg, rotated, arrs, n), 3, 1),
                                   16 * dim, 6 * len(seg) * dim)
    del rotated
    times["expectation_grouped"] = (time_cuda(lambda: obs.expectation_scan(psi), 3, 1), 8 * dim,
                                    inner_bound_flops(xs, True, obs.inner_groups(), dim))
    times["pauli_apply_grouped"] = (time_cuda(lambda: obs.apply_scan(psi), 3, 1), 16 * dim,
                                    apply_flops(xs, c, obs.groups(), dim))
    phi = ps.product_state(n, thw, alw, dev)
    times["screen_grouped"] = (time_cuda(lambda: pool.screen_scan(psi, phi), 3, 1), 16 * dim,
                               inner_bound_flops(pxs, False, pool.inner_groups(), dim))
    kern = {}
    for name, (ms, bytes_moved, flops) in times.items():
        b_ms, b_by = bound(bytes_moved, flops)
        kern[name] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by, launches=counts[name])
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"    ms per call: " + ", ".join(f"{k} {v['ms']:.3f} (bound {v['bound_ms']:.3f}, "
                                         f"{v['bound_by']})" for k, v in kern.items())
        + f"; product state built in {build_ms:.1f} ms; peak {peak:.1f} GiB; host {host_s:.1f} s,"
          f" checks on the card {device_s:.1f} s")

    # planted faults, which the checks above must see: a screen of zeros, and
    # the screen and <phi|H psi> of psi with its upper half dropped
    psi[dim // 2:] = 0
    planted = dict(zero_screen=screen_err(np.zeros_like(screen_closed)),
                   half_screen=screen_err(pool.screen_scan(psi, phi).double().cpu().numpy()),
                   half_h_psi=h_psi_err(complex(torch.vdot(phi, obs.apply_scan(psi)))))
    log("    planted faults: " + ", ".join(f"{k} {v:.2e}" for k, v in planted.items()))
    if min(planted.values()) <= BIG_RTOL:
        raise AssertionError(f"{n} qubits: a planted fault passes the checks: {planted}")
    del psi, phi
    torch.cuda.empty_cache()
    return dict(lattice=f"{x}x{y}", h_terms=len(H), pool_terms=int(pool.scan_arrays()[0].size),
                rotations=len(seg), runs=runs, dressed_terms=len(dressed), errors=errs,
                planted=planted, screen_scale=screen_scale, h_phi_psi=abs(h_phi_psi),
                energy=e, energy_closed=e_closed, launches=counts, kernels=kern,
                build_ms=build_ms, peak_gib=peak, host_s=host_s, device_s=device_s)


def phase_product_state(dev):
    """The kernels at 26, 28 and 30 qubits against float64 closed forms."""
    t0 = time.perf_counter()
    res = {n: big_size(n, lattice, dev) for n, lattice in BIG_LATTICES.items()}
    res["seconds"] = time.perf_counter() - t0
    log(f"  product-state phase: {res['seconds']:.1f} s")
    return res


HEA_REPS = 5
HEA_STEPS = 20  # kernel against plain, both molecules
HEA_RTOL = 1e-4  # energy and gnorm per step, relative


@functools.lru_cache(maxsize=None)
def lih_molecule():
    """LiH r = 0.8, STO-3G, with its FCI energy (the port's Lanczos)."""
    from qsfh_torch.molecules import LiH

    return LiH(0.8)


def hea_steps(vqe, n_steps, label):
    """``n_steps`` train steps of ``vqe`` from its initial angles, every
    launch counter set to 0 just before and read just after each."""
    import torch

    from qsfh_torch.engine import kernels as K

    th = vqe.params.clone()
    optimizer = torch.optim.Adam([th], lr=vqe.lr)
    rows, total = [], dict.fromkeys(K.launch_counts(), 0)
    for i in range(n_steps):
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        th, optimizer, e, g = vqe._step(th, optimizer)
        e, g = float(e), float(g)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        counts = K.launch_counts()
        total = {k: total[k] + v for k, v in counts.items()}
        rows.append(dict(step=i + 1, energy=e, gnorm=g, ms=ms))
    return rows, total, counts


def hea_case(mol, label, dev, tmp, n_epoch):
    """HEA_STEPS steps on the kernels against the unrolled plain path, and
    for H2 the reference run() to its threshold."""
    from qsfh_torch.algos.hea import VQE
    from qsfh_torch.engine import kernels as K
    from qsfh_torch.engine import streaming

    kw = dict(n_epoch=n_epoch, reps=HEA_REPS, lr=1e-1, threshold=0.002, plot=False,
              log_metrics=False, device=dev)
    vqe = VQE(mol, results_root=os.path.join(tmp, f"hea_{label}"), **kw)
    n = vqe.n_qubits
    seg = vqe._segment.segment
    rows, total, per_step = hea_steps(vqe, HEA_STEPS, label)
    plain = VQE(mol, results_root=os.path.join(tmp, f"hea_{label}_plain"), circuit_mode="unrolled",
                **kw)
    plain_rows, plain_counts, _ = hea_steps(plain, HEA_STEPS, label + " plain")
    if any(plain_counts.values()):
        raise AssertionError(f"HEA {label}: the unrolled path launched a kernel: {plain_counts}")
    diffs = [max(abs(a[k] - b[k]) / abs(b[k]) for k in ("energy", "gnorm"))
             for a, b in zip(rows, plain_rows)]
    resident = n >= K.TILE_MIN_BITS
    expected = ("rotation_resident", "adjoint_resident") if resident else \
        ("pauli_rotation", "adjoint_rotation")
    for name in expected + (("expectation_grouped", "pauli_apply_grouped") if resident else
                            ("pauli_inner", "pauli_apply")):
        if not per_step[name]:
            raise AssertionError(f"HEA {label}: {name} did not launch in a step")
    if resident and (per_step["rotation_resident"], per_step["adjoint_resident"],
                     per_step["pauli_rotation"], per_step["adjoint_rotation"]) != (1, 1, 0, 0):
        raise AssertionError(f"HEA {label}: a step is not one resident launch each way: "
                             f"{per_step}")
    layout = seg.tiles(1, n, streaming.RESIDENT_TILE_BITS, streaming.RESIDENT_TILE_LOW_BITS)
    ms = median_ms(rows)
    log(f"  HEA {label} ({n} qubits, reps {HEA_REPS}: {len(seg)} rotation terms"
        + (f", {layout.n_runs} resident runs" if resident else ", the per-term kernels")
        + f"): {HEA_STEPS} steps, {ms:.2f} ms a step (unrolled plain "
        f"{median_ms(plain_rows):.2f}), E {rows[-1]['energy']:.6f}, energy and gnorm within "
        f"{max(diffs):.2e} of the plain path (tol {HEA_RTOL:g}); launches a step "
        + ", ".join(f"{k} {v}" for k, v in per_step.items() if v))
    if max(diffs) > HEA_RTOL:
        raise AssertionError(f"HEA {label}: the kernels disagree with the unrolled path")
    res = dict(n=n, terms=len(seg), runs=layout.n_runs if resident else None, steps=rows,
               plain_steps=plain_rows, rel=diffs, launches=total, launches_per_step=per_step,
               step_ms=ms, plain_step_ms=median_ms(plain_rows))
    if mol.fci_energy is not None:
        res["fci"] = mol.fci_energy
        res["fci_gap"] = rows[-1]["energy"] - mol.fci_energy
    return res, vqe


def phase_hea(dev, tmp):
    """The HEA driver: H2 (4 qubits, per-term kernels; the reference
    configuration's run() to its threshold) and LiH (12 qubits, resident
    kernels), each held to the unrolled plain path for HEA_STEPS steps;
    a profile of the LiH step."""
    import torch

    from qsfh_torch.engine import kernels as K
    from qsfh_torch.molecules import H2

    t0 = time.perf_counter()
    res = {}
    res["h2"], vqe = hea_case(H2(r=0.8), "H2", dev, tmp, n_epoch=100)
    K.reset_launch_counts()
    t_run = time.perf_counter()
    losses = vqe.run()
    res["h2"]["run"] = dict(epochs=len(losses), seconds=time.perf_counter() - t_run,
                            energy=losses[-1], fci_gap=losses[-1] - vqe.molecule.fci_energy,
                            launches=K.launch_counts())
    log(f"  H2 reference run(): {len(losses)} epochs in {res['h2']['run']['seconds']:.2f} s, "
        f"E {losses[-1]:.6f}, {res['h2']['run']['fci_gap']:.2e} above FCI (not gated)")
    res["lih"], lih = hea_case(lih_molecule(), "LiH", dev, tmp, n_epoch=HEA_STEPS)
    th = lih.params.clone()
    optimizer = torch.optim.Adam([th], lr=lih.lr)
    lih._step(th, optimizer)
    torch.cuda.synchronize()
    profile_calls((("train step", 2, lambda: lih._step(th, optimizer), res["lih"]["step_ms"]),),
                  res["lih"], "HEA LiH")
    res["seconds"] = time.perf_counter() - t0
    log(f"  HEA phase: {res['seconds']:.1f} s")
    return res


VQD_LEVEL_TOL = 1e-3  # Ha, each level against the dense spectrum
VQD_STEPS_LIH = 20


def phase_vqd(dev, tmp):
    """VQD: H2 3 levels (benchmarks/demo_vqd_h2/run.py) against the dense
    spectrum; LiH 2 levels of VQD_STEPS_LIH steps, kernels against plain."""
    import numpy as np

    from qsfh_torch.algos.vqd import VQD
    from qsfh_torch.engine import kernels as K
    from qsfh_torch.molecules import H2
    from qsfh_torch.ops.jw import jordan_wigner
    from qsfh_torch.utils.dense import paulisum_to_dense

    t0 = time.perf_counter()
    res = {}
    m = H2(r=0.8)
    evals = np.linalg.eigvalsh(paulisum_to_dense(jordan_wigner(m.get_molecular_hamiltonian()), 4))
    K.reset_launch_counts()
    t_run = time.perf_counter()
    v = VQD(m, n_levels=3, n_epoch=500, reps=3, lr=1e-1, beta=5.0, seed=1, log_metrics=False,
            results_root=os.path.join(tmp, "vqd_h2"), device=dev)
    energies = v.run()
    seconds = time.perf_counter() - t_run
    counts = K.launch_counts()
    errs = [e - x for e, x in zip(energies, evals[:3])]
    steps = sum(len(h) for h in v.histories)
    log(f"  VQD H2 (4 qubits, 3 levels): E {', '.join(f'{e:.6f}' for e in energies)}, error to "
        f"the dense spectrum {', '.join(f'{e:.2e}' for e in errs)} Ha (tol {VQD_LEVEL_TOL:g}); "
        f"{steps} steps in {seconds:.2f} s ({1e3 * seconds / steps:.2f} ms a step)")
    if max(abs(e) for e in errs) > VQD_LEVEL_TOL:
        raise AssertionError("VQD H2: a level misses the dense spectrum")
    for name in ("pauli_rotation", "adjoint_rotation", "pauli_inner", "pauli_apply"):
        if not counts[name]:
            raise AssertionError(f"VQD H2: {name} did not launch")
    res["h2"] = dict(energies=energies, dense=evals[:3].tolist(), errors=errs,
                     epochs=[len(h) for h in v.histories], seconds=seconds, launches=counts,
                     ms_per_step=1e3 * seconds / steps)

    runs = {}
    for name, impl in (("kernels", K.KERNELS), ("plain", K.PLAIN)):
        lih = VQD(lih_molecule(), n_levels=2, n_epoch=VQD_STEPS_LIH, reps=3, lr=1e-1, beta=5.0,
                  threshold=0.0, log_metrics=False, results_root=os.path.join(tmp, "vqd_" + name),
                  device=dev)
        lih.impl = impl
        K.reset_launch_counts()
        t_run = time.perf_counter()
        lih.run()
        runs[name] = (lih, time.perf_counter() - t_run, K.launch_counts())
    (k, k_s, k_counts), (p, p_s, p_counts) = runs["kernels"], runs["plain"]
    if any(p_counts.values()):
        raise AssertionError(f"VQD LiH: the plain path launched a kernel: {p_counts}")
    for name in ("rotation_resident", "adjoint_resident", "expectation_grouped",
                 "pauli_apply_grouped"):
        if not k_counts[name]:
            raise AssertionError(f"VQD LiH: {name} did not launch")
    rel = max(abs(a - b) / abs(b) for hk, hp in zip(k.histories, p.histories)
              for a, b in zip(hk, hp))
    rel = max([rel] + [abs(a - b) / abs(b) for a, b in zip(k.energies, p.energies)])
    log(f"  VQD LiH (12 qubits, 2 levels of {VQD_STEPS_LIH} steps): E {k.energies[0]:.6f}, "
        f"{k.energies[1]:.6f}; histories and final energies within {rel:.2e} of the plain "
        f"path (tol {HEA_RTOL:g}); {1e3 * k_s / (2 * VQD_STEPS_LIH):.2f} ms a step (plain "
        f"{1e3 * p_s / (2 * VQD_STEPS_LIH):.2f})")
    if rel > HEA_RTOL:
        raise AssertionError("VQD LiH: the kernels disagree with the plain path")
    launches = {name: res["h2"]["launches"][name] + k_counts[name] for name in k_counts}
    res["lih"] = dict(energies=k.energies, plain_energies=p.energies, rel=rel, launches=k_counts,
                      ms_per_step=1e3 * k_s / (2 * VQD_STEPS_LIH),
                      plain_ms_per_step=1e3 * p_s / (2 * VQD_STEPS_LIH))
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t0
    log(f"  VQD phase: {res['seconds']:.1f} s")
    return res


DYN_STEPS = 15
DYN_TRACE = os.path.join(HERE, "benchmarks", "dynamics_expected.json")
ITE_TRACE = os.path.join(HERE, "benchmarks", "ite_expected.json")
TRACE_RTOL = 1e-3  # the JAX harnesses' gate on their committed float traces


def phase_dynamics(dev):
    """The 3x3 Neel quench of benchmarks/tpu_dynamics.py (U = 4, dt = 0.05,
    Strang, 15 steps): double occupancy per step against the committed
    trace, <H> drift as a sanity check, the final state against the plain
    path on the card; ms per Trotter step and its profile."""
    import numpy as np
    import torch

    from qsfh_torch.algos.base import HubbardProblem
    from qsfh_torch.algos.dynamics import TrotterEvolution, neel_occupied
    from qsfh_torch.engine import kernels as K
    from qsfh_torch.engine import streaming
    from qsfh_torch.engine.expectation import Observable
    from qsfh_torch.engine.state import basis_state
    from qsfh_torch.ops.jw import jordan_wigner

    t0 = time.perf_counter()
    with open(DYN_TRACE) as fh:
        trace = json.load(fh)
    p = HubbardProblem(3, 3, 1.0, 4.0, 9, 5, 4)
    ev = TrotterEvolution(p, dt=0.05, order=2, device=dev)
    obs = {"UD": Observable(jordan_wigner(p.interacting_term), 18), "H": p.observables["H"]}
    psi0 = basis_state(18, neel_occupied(3, 3), dtype=torch.complex64, device=dev)
    ev.evolve(psi0, 1, observables=obs)  # first use: layouts and tables
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t_run = time.perf_counter()
    psi, rec = ev.evolve(psi0, DYN_STEPS, observables=obs)
    run_ms = 1e3 * (time.perf_counter() - t_run) / DYN_STEPS
    counts = K.launch_counts()
    ud_err = float(np.max(np.abs(rec["UD"] - trace["energies"]) / np.abs(trace["energies"])))
    h_err = float(np.max(np.abs(rec["H"] - trace["gnorms"]) / np.abs(trace["gnorms"])))
    ev.impl = K.PLAIN
    psi_plain, _ = ev.evolve(psi0, DYN_STEPS)
    ev.impl = K.KERNELS
    state_err = rel_err(psi, psi_plain)
    layout = ev.segment.tiles(1, 18, streaming.RESIDENT_TILE_BITS,
                              streaming.RESIDENT_TILE_LOW_BITS)
    per_step = {k: v / DYN_STEPS for k, v in counts.items() if v}
    step_ms = time_cuda(lambda: ev.step(psi), 50)
    log(f"  Trotter 3x3 Neel quench (18 qubits, {len(ev.segment)} rotation terms a Strang step, "
        f"{layout.n_runs} resident runs): double occupancy within {ud_err:.2e} of the committed "
        f"trace (tol {TRACE_RTOL:g}), <H> drift {h_err:.2e} (sanity, tol 1), final state within "
        f"{state_err:.2e} of the plain path (tol {STATE_RTOL * 10:g}); {step_ms:.4f} ms a step "
        f"(CUDA events), {run_ms:.3f} ms a recorded step (host clock, E and UD each step); "
        f"launches a step " + ", ".join(f"{k} {v:g}" for k, v in per_step.items()))
    if ud_err > TRACE_RTOL or h_err > 1.0 or state_err > 10 * STATE_RTOL:
        raise AssertionError("Trotter: the kernels disagree with the trace or the plain path")
    if counts["rotation_resident"] != DYN_STEPS or counts["pauli_rotation"]:
        raise AssertionError(f"Trotter: a step is not one resident launch: {counts}")
    res = dict(ud_rel=ud_err, h_drift_rel=h_err, state_rel=state_err, terms=len(ev.segment),
               runs=layout.n_runs, launches=counts, launches_per_step=per_step,
               step_ms=step_ms, recorded_step_ms=run_ms, ud=rec["UD"].tolist())
    profile_calls((("step", 20, lambda: ev.step(psi), step_ms),), res, "Trotter 3x3")
    res["graph_ms"] = graph_ms(lambda: ev.step(psi), 20)
    log(f"  Trotter step in a CUDA graph: {res['graph_ms']:.4f} ms (no host between launches; "
        f"idle share of the host-launched step {1 - res['graph_ms'] / step_ms:.3f})")
    res["seconds"] = time.perf_counter() - t0
    return res


ITE_STEPS = 300
ITE_BLOCK = 50


def phase_ite(dev):
    """3x3 ITE (t=1, U=6, 5 up / 4 down, dbeta = 0.01, order 2) from the
    seed-19 state of benchmarks/tpu_ite.py: the first 4 energies and
    variances against the committed trace, then a timed run and a profile
    of one block's steps."""
    import numpy as np
    import torch

    from qsfh_torch.algos.base import HubbardProblem
    from qsfh_torch.algos.ite import ImaginaryTimeEvolution
    from qsfh_torch.engine import kernels as K

    t0 = time.perf_counter()
    with open(ITE_TRACE) as fh:
        trace = json.load(fh)
    p = HubbardProblem(3, 3, 1.0, 6.0, 9, 5, 4)
    ite = ImaginaryTimeEvolution(p, dbeta=0.01, order=2, device=dev)
    rng = np.random.default_rng(19)
    v = rng.standard_normal(1 << 18) + 1j * rng.standard_normal(1 << 18)
    v /= np.linalg.norm(v)
    K.reset_launch_counts()
    _, rec = ite.run(v, n_steps=4, block=4)
    counts = K.launch_counts()

    def rel(a, b):
        return float(np.max(np.abs(a - np.asarray(b))) / np.max(np.abs(b)))

    e_err, v_err = rel(rec["energies"], trace["energies"]), rel(rec["variances"],
                                                                trace["variances"])
    torch.cuda.synchronize()
    t_run = time.perf_counter()
    psi, long = ite.run(v, n_steps=ITE_STEPS, block=ITE_BLOCK)
    step_ms = 1e3 * (time.perf_counter() - t_run) / ITE_STEPS
    per_step = {k: c / 4 for k, c in counts.items() if c}
    tiles = ite.observable.groups().n_tiles
    log(f"  ITE 3x3 (18 qubits, order 2): energies within {e_err:.2e} and variances within "
        f"{v_err:.2e} of the committed trace (tol {TRACE_RTOL:g}); {ITE_STEPS} steps in blocks "
        f"of {ITE_BLOCK}: {step_ms:.3f} ms a step (host clock), E {long['energies'][-1]:.6f}, "
        f"variance {long['variances'][-1]:.4f}; launches a step "
        + ", ".join(f"{k} {v:g}" for k, v in per_step.items()))
    if max(e_err, v_err) > TRACE_RTOL:
        raise AssertionError("ITE: the kernels disagree with the committed trace")
    if counts["pauli_apply_grouped"] != 4 * ite.order * tiles:
        raise AssertionError(f"ITE: {counts['pauli_apply_grouped']} pauli_apply_grouped "
                             f"launches in 4 steps, the layout predicts {4 * ite.order * tiles}")
    res = dict(energy_rel=e_err, variance_rel=v_err, launches=counts, launches_per_step=per_step,
               step_ms=step_ms, steps=ITE_STEPS, final_energy=float(long["energies"][-1]),
               final_variance=float(long["variances"][-1]))
    profile_calls((("step", ITE_BLOCK, lambda: ite._step(psi), step_ms),), res, "ITE 3x3")
    res["graph_ms"] = graph_ms(lambda: ite._step(psi), ITE_BLOCK)
    log(f"  ITE step in a CUDA graph: {res['graph_ms']:.4f} ms (no host between launches; "
        f"idle share of the host-clock step {1 - res['graph_ms'] / step_ms:.3f})")
    res["seconds"] = time.perf_counter() - t0
    return res


# -- this slice: the 3x3 analysis, Lanczos spectroscopy, multistart, sampling ------------

DEMO_ADAPT = os.path.join(HERE, "benchmarks", "demo_3x3")
DEMO_HVA = os.path.join(HERE, "benchmarks", "demo_hva_3x3")
DEMO_MULTISTART = os.path.join(HERE, "benchmarks", "demo_multistart")
# the analysis scripts' driver arguments (benchmarks/correlations_3x3.py,
# observables_3x3.py, irrep_analysis_3x3.py)
ANALYSIS_3X3 = dict(x_dimension=3, y_dimension=3, n_electrons=9, n_spin_up=5, n_spin_down=4,
                    tunneling=1, coulomb=6, degenerate_subspace=4, load_model=True, plot=False,
                    log_metrics=False)
ANALYSIS_RTOL = 1e-5  # kernel route against the complex128 plain path, of the largest entry
TRACE_ATOL = 1e-5  # trace rho_up = 5, trace rho_dn = 4
SEED_NORM_ATOL = 1e-6  # the irrep seed norms (complex128 on the ED cache) against the JSON
IRREP_ATOL = 1e-5  # the HVA irrep weights against the JSON the JAX script reproduces


def _json(*parts):
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def labeled_manifold(manifold, nx, ny, dev, seed=0):
    """``labeled_manifold`` of benchmarks/irrep_analysis_3x3.py on the card:
    the cached manifold resolved into s/px/py/d members, seeded with its
    first state, then with unit combinations drawn from default_rng(seed)."""
    import numpy as np
    import torch

    from qsfh_torch.linalg.symmetry import symmetry_adapted_states

    rng = np.random.default_rng(seed)
    seeds = [np.asarray(manifold[0])]
    for _ in range(4):
        c = rng.normal(size=len(manifold)) + 1j * rng.normal(size=len(manifold))
        c /= np.linalg.norm(c)
        seeds.append(sum(ci * np.asarray(v) for ci, v in zip(c, manifold)))
    for psi0 in seeds:
        states, norms = symmetry_adapted_states(torch.from_numpy(psi0).to(dev), nx, ny)
        if len(states) == 4:
            return states, norms
    raise AssertionError(f"could not resolve all four irreps; norms={norms}")


def analysis_matrices(psi, route="auto"):
    """correlations_3x3.py's spin matrix and observables_3x3.py's rho per spin
    and pair matrix of psi (host numpy)."""
    from qsfh_torch.ops import correlations as C

    return {"spin": C.correlation_matrix(psi, 9, "spin", route=route),
            "rho_up": C.one_body_density_matrix(psi, 9, "up", route=route),
            "rho_down": C.one_body_density_matrix(psi, 9, "down", route=route),
            "pair": C.pair_correlation_matrix(psi, 9, route=route)}


def analysis_entries():
    """The one-layout term list of each matrix."""
    from qsfh_torch.ops import correlations as C

    return {"spin": C.spin_entries(9), "rho_up": C.one_body_entries(9, "up"),
            "rho_down": C.one_body_entries(9, "down"), "pair": C.pair_entries(9)}


def analysis_summary(mats, psi):
    """The quantities the three scripts write, from the matrices."""
    import numpy as np

    from qsfh_torch.ops import correlations as C
    from qsfh_torch.ops.entanglement import entanglement_entropy, site_qubits

    s_q = C.structure_factor(mats["spin"], 3, 3)
    pair = mats["pair"]
    out = {"S_q": {f"({kx},{ky})": v for (kx, ky), v in sorted(s_q.items())},
           "nn_correlator": float(mats["spin"][0, 1]),
           "onsite": float(np.mean(np.diag(mats["spin"])))}
    for spin in ("up", "down"):
        rho = mats[f"rho_{spin}"]
        nk = C.momentum_distribution(rho, 3, 3)
        out[f"n_k_{spin}"] = {f"({kx},{ky})": v for (kx, ky), v in sorted(nk.items())}
        out[f"trace_rho_{spin}"] = float(np.trace(rho).real)
    out["double_occupancy"] = float(np.mean(np.diag(pair).real))
    out["pair_nn"] = float(abs(pair[0, 1]))
    out["pair_max_offsite"] = float(np.abs(pair - np.diag(np.diag(pair))).max())
    out["entropy_row0"] = entanglement_entropy(psi, 18, site_qubits((0, 1, 2)))
    out["entropy_site0"] = entanglement_entropy(psi, 18, site_qubits((0,)))
    return out


def _flat_numbers(d, prefix=""):
    """{dotted key: number} of a nested dict of numbers."""
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat_numbers(v, f"{prefix}{k}."))
        elif isinstance(v, (int, float)):
            out[prefix + k] = float(v)
    return out


def analysis_state(name, psi, committed):
    """The kernel route's matrices of a complex64 state against the
    complex128 per-entry plain loop on the same state, the traces, the
    entropies; the committed JSON values printed beside (not gated)."""
    import numpy as np
    import torch

    got = analysis_matrices(psi)
    wide = psi.to(torch.complex128)
    ref = analysis_matrices(wide, route="loop")
    errs = {k: float(np.abs(got[k] - ref[k]).max() / np.abs(ref[k]).max()) for k in got}
    summary = analysis_summary(got, psi)
    ref_summary = analysis_summary(ref, wide)
    ent_err = max(abs(summary[k] - ref_summary[k]) / abs(ref_summary[k])
                  for k in ("entropy_row0", "entropy_site0"))
    trace_err = max(abs(summary["trace_rho_up"] - 5.0), abs(summary["trace_rho_down"] - 4.0))
    mine, theirs = _flat_numbers(summary), _flat_numbers(committed)
    shared = sorted(set(mine) & set(theirs))
    diff = max(abs(mine[k] - theirs[k]) for k in shared) if shared else float("nan")
    log(f"  {name}: kernel route vs complex128 plain loop, of the largest entry: "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f" (tol {ANALYSIS_RTOL:g}); entropies {ent_err:.2e}; trace rho_up - 5, rho_dn - 4 "
        f"within {trace_err:.2e} (tol {TRACE_ATOL:g})")
    log(f"    S(pi-ish) (1,1) {summary['S_q']['(1,1)']:.6f}, nn {summary['nn_correlator']:.6f}, "
        f"double occupancy {summary['double_occupancy']:.6f}, S_row0 "
        f"{summary['entropy_row0']:.6f}; the committed JSON (an older checkpoint: not gated) "
        f"differs by up to {diff:.2e} over {len(shared)} numbers")
    if max(errs.values()) > ANALYSIS_RTOL or ent_err > ANALYSIS_RTOL or trace_err > TRACE_ATOL:
        raise AssertionError(f"analysis {name}: the kernel route disagrees with the plain path")
    return dict(rel_err=errs, entropy_rel_err=ent_err, trace_err=trace_err, summary=summary,
                committed_max_diff=diff, committed_numbers=len(shared))


def matrix_timings(psi, res):
    """Per matrix on the trained state: launches of one call, kernel ms and
    bound, ms per matrix end to end, the host layout build, and the same
    matrix through the per-entry loops (plain; kernels with one layout per
    entry)."""
    import torch

    from qsfh_torch.engine import kernels as K
    from qsfh_torch.engine.expectation import Observable
    from qsfh_torch.ops import correlations as C

    dim = 1 << 18
    entries = analysis_entries()
    routes = {"spin": lambda p, r: C.correlation_matrix(p, 9, "spin", route=r),
              "rho_up": lambda p, r: C.one_body_density_matrix(p, 9, "up", route=r),
              "rho_down": lambda p, r: C.one_body_density_matrix(p, 9, "down", route=r),
              "pair": lambda p, r: C.pair_correlation_matrix(p, 9, route=r)}
    out, launches = {}, dict.fromkeys(K.launch_counts(), 0)
    for name in ("spin", "rho_up", "pair"):
        ent = entries[name]
        tiles = ent.inner_groups()
        _, counts = launches_of(lambda: routes[name](psi, "auto"))
        for k, v in counts.items():
            launches[k] += v
        if counts.get("pauli_inner_grouped", 0) != inner_launches(tiles, 18) or \
                set(counts) - {"pauli_inner_grouped", "pauli_inner"}:
            raise AssertionError(f"{name}: not one pauli_inner_grouped layout: {counts}")
        fresh = C.EntryTerms(ent.ops, 18)
        build_ms, _ = timed_once(fresh.inner_groups)
        xs = torch.as_tensor(ent.arrays[0].astype("int64"), device=psi.device)
        kernel_ms = time_cuda(lambda: ent.term_values(psi), reps=20)
        b_ms, b_by = bound(8 * dim + 8 * len(ent), inner_bound_flops(xs, True, tiles, dim))
        matrix_ms = time_cuda(lambda: routes[name](psi, "auto"), reps=10)
        plain_loop_ms, _ = timed_once(lambda: routes[name](psi, "loop"))

        def kernel_loop():  # one Observable, so one layout, per entry
            return [float(Observable(op, 18).expectation_scan(psi)) for op in ent.ops]

        kernel_loop_ms, _ = timed_once(kernel_loop)
        out[name] = dict(entries=ent.n_entries, terms=len(ent), tiles=tiles.n_tiles,
                         spill=int(tiles.spill_index.size), launches=counts, kernel_ms=kernel_ms,
                         bound_ms=b_ms, bound_by=b_by, matrix_ms=matrix_ms,
                         layout_build_ms=build_ms, plain_loop_ms=plain_loop_ms,
                         kernel_loop_ms=kernel_loop_ms)
        log(f"  {name}: {ent.n_entries} entries, {len(ent)} terms, {tiles.n_tiles} tiles "
            f"({int(tiles.spill_index.size)} terms spill); launches "
            + ", ".join(f"{k} {v}" for k, v in counts.items())
            + f"; pauli_inner_grouped {kernel_ms:.4f} ms (bound {b_ms:.5f}, {b_by}), "
            f"{matrix_ms:.3f} ms per matrix end to end, layout build {build_ms:.1f} ms once; "
            f"per-entry loops: plain {plain_loop_ms:.1f} ms, kernels with a layout per entry "
            f"{kernel_loop_ms:.1f} ms")
    res["matrices"] = out
    res["launches"] = launches


def planted_entry_shift(psi):
    """The planted fault: the spin matrix's entry index shifted by one must
    fail the kernel-against-plain gate."""
    import torch

    from qsfh_torch.engine.expectation import Observable

    ent = analysis_entries()["spin"]
    idx = torch.roll(torch.as_tensor(ent.entry, device=psi.device), 1)
    bad = ent.values(psi, entry=idx).double().cpu()
    wide = psi.to(torch.complex128)
    ref = torch.stack([Observable(op, 18).expectation(wide) for op in ent.ops]).cpu()
    err = float((bad - ref).abs().max() / ref.abs().max())
    log(f"  planted fault (the spin matrix's entry index shifted by one): {err:.2e} of the "
        f"largest entry (must exceed {ANALYSIS_RTOL:g})")
    if err <= ANALYSIS_RTOL:
        raise AssertionError("the shifted entry index passed the analysis gate")
    return err


def phase_analysis(dev):
    """The 3x3 analysis scripts' paths on the committed checkpoints: the
    ADAPT (1719 operators of the extended pool) and HVA (reps = 10) states
    loaded with the port's ``load_model``, their correlation matrices, n_k,
    pair correlator and entropies on the kernel route against the
    complex128 plain path, the irrep weights; ms and launches per matrix."""
    import numpy as np
    import torch

    from qsfh_torch.algos.adapt import ADAPT
    from qsfh_torch.algos.hva import HVA
    from qsfh_torch.linalg.symmetry import irrep_weights
    from qsfh_torch.ops.pool import hubbard_interaction_pool_extended

    t0 = time.perf_counter()
    res = {}
    adapt = ADAPT(n_epoch=0, threshold1=1e-3, threshold2=1e-3, results_root=DEMO_ADAPT,
                  pool=hubbard_interaction_pool_extended(3, 3), device=dev, **ANALYSIS_3X3)
    load_s = time.perf_counter() - t0
    state_ms, psi_a = timed_once(adapt.state)
    hva = HVA(n_epoch=0, reps=10, lr=1e-2, results_root=DEMO_HVA, device=dev, **ANALYSIS_3X3)
    psi_h = hva.state()
    # ~2e4 float32 rotations move |psi|^2 off 1 by ~1e-5: the analysis
    # reads the normalised states, as the scripts' complex128 states are
    norm_err = {k: abs(float(torch.linalg.vector_norm(v.to(torch.complex128))) ** 2 - 1.0)
                for k, v in (("adapt", psi_a), ("hva", psi_h))}
    psi_a = psi_a / torch.linalg.vector_norm(psi_a)
    psi_h = psi_h / torch.linalg.vector_norm(psi_h)
    res["norm_err"] = norm_err
    energy, manifold = adapt.problem.ground_state(degenerate=True, n_states=4)
    frame = [torch.from_numpy(np.asarray(m)).to(dev) for m in manifold]

    def projection(psi):
        wide = psi.to(torch.complex128)
        t = sum(torch.vdot(m, wide) * m for m in frame)
        return (t / torch.linalg.vector_norm(t)).to(torch.complex64)

    log(f"  ADAPT checkpoint: {len(adapt.selected_indices)} operators of the extended pool "
        f"({len(adapt.fermion_pool)}), loaded in {load_s:.1f} s, state {state_ms:.1f} ms; "
        f"HVA reps = 10: {hva.params_t.numel()} parameters; |psi|^2 - 1 before normalising: "
        f"ADAPT {norm_err['adapt']:.2e}, HVA {norm_err['hva']:.2e}")
    sf = _json(DEMO_ADAPT, "structure_factor.json")
    obs = _json(DEMO_ADAPT, "observables.json")
    res["states"] = {}
    for name, psi in (("adapt_trained", psi_a), ("exact_manifold_projection", projection(psi_a))):
        committed = dict(sf[name], **obs[name])
        res["states"][name] = analysis_state(name, psi, committed)
    matrix_timings(psi_a, res)
    res["planted_entry_shift"] = planted_entry_shift(psi_a)

    states, norms = labeled_manifold(manifold, 3, 3, dev)
    irr_a, irr_h = _json(DEMO_ADAPT, "irrep_weights.json"), _json(DEMO_HVA, "irrep_weights.json")
    norm_err = max(abs(norms[k] - irr_h["irrep_seed_norms"][k]) for k in norms)
    weights = {name: irrep_weights(psi, states) for name, psi in (
        ("adapt_trained", psi_a), ("adapt_projection", projection(psi_a)),
        ("hva_trained", psi_h), ("hva_projection", projection(psi_h)))}
    hva_err = max(abs(weights["hva_trained"][k] - irr_h["irrep_weights"][k]) for k in states)
    fid_err = abs(sum(weights["hva_trained"].values()) - irr_h["manifold_fidelity"])
    adapt_diff = max(abs(weights["adapt_trained"][k] - irr_a["irrep_weights"][k]) for k in states)
    log("  irrep weights: " + "; ".join(
        f"{n} " + " ".join(f"{k} {v:.6f}" for k, v in w.items()) for n, w in weights.items()))
    log(f"  irrep seed norms within {norm_err:.2e} of the JSON (tol {SEED_NORM_ATOL:g}); HVA "
        f"weights within {hva_err:.2e}, manifold fidelity within {fid_err:.2e} of "
        f"demo_hva_3x3/irrep_weights.json (tol {IRREP_ATOL:g}; the JAX script reproduces it on "
        f"this checkpoint); ADAPT weights differ from demo_3x3/irrep_weights.json by "
        f"{adapt_diff:.2e} (an older checkpoint: not gated)")
    if norm_err > SEED_NORM_ATOL or hva_err > IRREP_ATOL or fid_err > IRREP_ATOL:
        raise AssertionError("irrep analysis disagrees with the committed HVA weights")
    res["irrep"] = dict(weights=weights, seed_norms=norms, seed_norm_err=norm_err,
                        hva_err=hva_err, hva_fidelity_err=fid_err, adapt_diff=adapt_diff)
    res["seconds"] = time.perf_counter() - t0
    log(f"  analysis phase: {res['seconds']:.1f} s")
    return res


SPECTRAL_M = 80
SPECTRAL_POLE_ATOL = 2e-3  # the band edges against spectral.json
# A(omega) against the complex128 plain Lanczos, of the largest value, from
# the first SPECTRAL_A_LEVELS levels: a complex64 H psi (kernel or plain)
# follows the complex128 recursion for about 10 levels (alpha within
# 1e-4-7e-3 at level 10, O(1) apart by level 20-40 on an H100), past
# which the two runs are different, equally valid finite-precision
# Lanczos processes; the full-depth differences are logged
SPECTRAL_A_RTOL = 2e-2
SPECTRAL_A_LEVELS = 10
SUM_RULE_ATOL = 1e-5
SPECTRAL_OMEGAS = (-4.0, 12.0, 321)
SQW_OMEGAS = (0.0, 10.0, 201)
SPECTRAL_PRECISION_KS = ((0, 0), (1, 1), (2, 2))  # also on the plain complex64 version


def k_ladder(kx, ky, dagger):
    """benchmarks/spectral_3x3.py's momentum ladder c^(dag)_k on the up modes."""
    import numpy as np

    from qsfh_torch.ops.fermion import FermionOperator

    op = FermionOperator.zero()
    for s in range(9):
        x, y = s % 3, s // 3
        phase = np.exp(1j * 2 * np.pi * (kx * x / 3 + ky * y / 3))
        op += FermionOperator(((2 * s, 1 if dagger else 0),),
                              (phase if dagger else phase.conjugate()) / 3.0)
    return op


def main_poles(res):
    """spectral_3x3.py's main poles: weight above 1e-4, the 6 heaviest."""
    live = res["weights"] > 1e-4
    pairs = sorted(zip(res["poles"][live], res["weights"][live]), key=lambda t: -t[1])
    return [[float(p), float(w)] for p, w in pairs[:6]]


def band_edge(poles):
    """The lowest pole of a main-pole list: for the particle branch the
    addition edge E0(N+1) - E0(N), for the hole branch the removal edge
    E0(N-1) - E0(N), the hole pole nearest the Fermi level (the highest in
    the photoemission frequency -pole).  The other end of a main list is an
    unconverged interior pole (0.07-0.11 apart between complex64 and
    complex128 runs at m = 80)."""
    return min(p for p, _ in poles)


def broadened(alphas, betas, norm2, e0, omegas, eta):
    """A(omega) of the Lanczos resolvent of the given coefficients."""
    import numpy as np

    from qsfh_torch.linalg.spectral import resolvent_poles

    theta, w = resolvent_poles(alphas, betas, norm2)
    return ((eta / np.pi) / ((omegas[:, None] - (theta - e0)[None, :]) ** 2 + eta ** 2)) @ w


def resolvent_checks(ham, phi, e0, omegas, eta, planted=False):
    """A(omega) of the kernel route (or, ``planted``, of a zeroed H psi)
    against the complex128 plain Lanczos on the same seed: from the first
    SPECTRAL_A_LEVELS levels (gated) and from all SPECTRAL_M (logged)."""
    import numpy as np
    import torch

    from qsfh_torch.engine import kernels as K
    from qsfh_torch.linalg.spectral import lanczos_tridiagonal

    ref = lanczos_tridiagonal(lambda v: ham.apply_auto(v, K.PLAIN), phi, SPECTRAL_M)
    matvec = (lambda v: torch.zeros_like(v)) if planted else ham.apply_auto
    got = lanczos_tridiagonal(matvec, phi.to(torch.complex64), SPECTRAL_M)
    out = {}
    for key, depth in (("a_err", SPECTRAL_A_LEVELS), ("a_err_full", SPECTRAL_M)):
        want = broadened(ref[0][:depth], ref[1][:depth], ref[2], e0, omegas, eta)
        have = broadened(got[0][:depth], got[1][:depth], got[2], e0, omegas, eta)
        out[key] = float(np.abs(have - want).max() / want.max())
    out["alpha_diff_at_levels"] = float(np.abs(got[0][:SPECTRAL_A_LEVELS]
                                               - ref[0][:SPECTRAL_A_LEVELS]).max())
    return out


def phase_spectral(dev):
    """spectral_3x3.py (9 k-points x 2 branches, m = 80) and sqw_3x3.py (spin,
    9 q-points, m = 80) from the ED cache's manifold[0], through the
    port's entry points: H psi on pauli_apply_grouped, alpha and beta read
    once a run.  Gates: the sum rules against the kernel-route n_k and the
    static correlator, the band edges against spectral.json, the S^zz
    weights against sqw.json, A(omega) against the complex128 plain
    Lanczos (SPECTRAL_A_LEVELS levels); a zeroed H psi (the planted fault)
    must fail."""
    import numpy as np
    import torch

    from qsfh_torch.algos.base import HubbardProblem
    from qsfh_torch.algos.dynamics import apply_on_host, excitation_operator
    from qsfh_torch.engine import kernels as K
    from qsfh_torch.engine.expectation import Observable
    from qsfh_torch.linalg.spectral import (dynamical_structure_factor, lanczos_tridiagonal,
                                            spectral_function_lanczos)
    from qsfh_torch.ops import correlations as C
    from qsfh_torch.ops.fermion import hermitian_conjugated
    from qsfh_torch.ops.jw import jordan_wigner

    t0 = time.perf_counter()
    # the scripts' arguments (1.0, 6.0) name the "t=1, U=6" cache: the tag
    # collapses integer-valued floats (the "t=1.0, U=6.0" file holds the same arrays)
    p = HubbardProblem(3, 3, 1.0, 6.0, 9, 5, 4, results_root=DEMO_ADAPT)
    e0, manifold = p.ground_state(degenerate=True, n_states=4)
    gs, e0 = np.asarray(manifold[0]), float(e0)
    gs64 = torch.from_numpy(gs).to(dev).to(torch.complex64)
    nk_up = C.momentum_distribution(C.one_body_density_matrix(gs64, 9, "up"), 3, 3)
    committed = _json(DEMO_ADAPT, "spectral.json")
    omegas = np.linspace(*SPECTRAL_OMEGAS)
    ham = p.observables["H"]
    tiles = ham.groups().n_tiles

    def seed(op):  # |phi> on the host in complex128, then on the card
        lad = Observable(jordan_wigner(excitation_operator(op)), 18)
        return torch.from_numpy(apply_on_host(lad, gs)).to(dev)

    rows, sweep_s = {}, 0.0
    K.reset_launch_counts()
    for kx in range(3):
        for ky in range(3):
            for branch, dagger in (("particle", True), ("hole", False)):
                op = k_ladder(kx, ky, dagger)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                res = spectral_function_lanczos(p, gs, e0, op, m=SPECTRAL_M, omegas=omegas,
                                                device=dev)
                sweep_s += time.perf_counter() - t1
                expect = (1.0 - nk_up[(kx, ky)]) if dagger else nk_up[(kx, ky)]
                cband = committed["bands"][f"({kx},{ky})"][branch]
                poles = main_poles(res)
                rows[f"({kx},{ky}) {branch}"] = dict(
                    sum_rule=float(res["weights"].sum()), n_k_expected=expect,
                    sum_err=abs(float(res["weights"].sum()) - expect),
                    committed_sum_rule=cband["sum_rule"], edge=band_edge(poles),
                    edge_err=abs(band_edge(poles) - band_edge(cband["main_poles"])),
                    far_end_err=abs(max(q for q, _ in poles)
                                    - max(q for q, _ in cband["main_poles"])),
                    main_poles=poles, op=op)
    counts = {k: v for k, v in K.launch_counts().items() if v}
    expected = len(rows) * SPECTRAL_M * tiles
    if counts.get("pauli_apply_grouped") != expected or set(counts) - {"pauli_apply_grouped"}:
        raise AssertionError(f"spectral: launches {counts}, the layout predicts "
                             f"{expected} pauli_apply_grouped")
    for row in rows.values():
        row.update(resolvent_checks(ham, seed(row.pop("op")), e0, omegas, 0.05))
    precision = {}
    for kx, ky in SPECTRAL_PRECISION_KS:  # the plain complex64 version's full-depth A
        phi = seed(k_ladder(kx, ky, True))
        ref = lanczos_tridiagonal(lambda v: ham.apply_auto(v, K.PLAIN), phi, SPECTRAL_M)
        low = lanczos_tridiagonal(lambda v: ham.apply_auto(v, K.PLAIN), phi.to(torch.complex64),
                                  SPECTRAL_M)
        want = broadened(*ref, e0, omegas, 0.05)
        precision[f"({kx},{ky}) particle"] = float(
            np.abs(broadened(*low, e0, omegas, 0.05) - want).max() / want.max())
    worst = {k: max(r[k] for r in rows.values())
             for k in ("sum_err", "edge_err", "far_end_err", "a_err", "a_err_full",
                       "alpha_diff_at_levels")}
    log(f"  spectral_3x3 (9 k x 2 branches, m = {SPECTRAL_M}): {sweep_s:.2f} s on the kernels "
        f"(the JAX CPU run: {committed['wall_seconds']} s); sum rules within "
        f"{worst['sum_err']:.2e} of the kernel-route n_k (tol {SUM_RULE_ATOL:g}); band edges "
        f"within {worst['edge_err']:.2e} of spectral.json (tol {SPECTRAL_POLE_ATOL:g}); A(omega) "
        f"of the first {SPECTRAL_A_LEVELS} levels within {worst['a_err']:.2e} of the complex128 "
        f"plain Lanczos (tol {SPECTRAL_A_RTOL:g}; alpha within {worst['alpha_diff_at_levels']:.1e}"
        f"); launches " + ", ".join(f"{k} {v}" for k, v in counts.items()))
    log(f"    not gated: all {SPECTRAL_M} levels' A(omega) within {worst['a_err_full']:.2e} of "
        f"complex128 (the plain complex64 version: "
        + ", ".join(f"{k} {v:.2e}" for k, v in precision.items())
        + f"); the far end of the main poles {worst['far_end_err']:.2e} from spectral.json")
    for key, row in rows.items():
        if row["sum_err"] > SUM_RULE_ATOL or row["edge_err"] > SPECTRAL_POLE_ATOL or \
                row["a_err"] > SPECTRAL_A_RTOL:
            log(f"    {key}: sum {row['sum_err']:.2e}, edge {row['edge']:.5f} off by "
                f"{row['edge_err']:.2e}, A {row['a_err']:.2e}; main poles "
                + str([[round(a, 5), round(b, 5)] for a, b in row["main_poles"]]))
    if worst["sum_err"] > SUM_RULE_ATOL or worst["edge_err"] > SPECTRAL_POLE_ATOL or \
            worst["a_err"] > SPECTRAL_A_RTOL:
        raise AssertionError("spectral: a gate failed")
    res_out = dict(rows=rows, worst=worst, precision_complex64_plain=precision,
                   sweep_seconds=sweep_s, launches=counts,
                   launches_per_step={"pauli_apply_grouped": tiles})

    # ms per Lanczos step and H psi's share, on the (0,0) particle seed
    phi = seed(k_ladder(0, 0, True)).to(torch.complex64)
    run_ms, _ = timed_once(lambda: lanczos_tridiagonal(ham.apply_auto, phi, SPECTRAL_M))
    step_ms = run_ms / SPECTRAL_M
    v = phi / torch.linalg.vector_norm(phi)
    hpsi_ms = time_cuda(lambda: ham.apply_auto(v), reps=50)
    res_out.update(step_ms=step_ms, hpsi_ms=hpsi_ms, hpsi_share=hpsi_ms / step_ms)
    log(f"  Lanczos step {step_ms:.4f} ms (a run of {SPECTRAL_M}, host clock), H psi "
        f"{hpsi_ms:.4f} ms of it ({hpsi_ms / step_ms:.2f})")

    # the planted fault: a zeroed H psi in the recursion
    bad = spectral_function_lanczos(p, gs, e0, k_ladder(0, 0, True), m=SPECTRAL_M, device=dev,
                                     impl=dataclasses.replace(
                                         K.KERNELS, apply_grouped=lambda psi, *a: psi * 0))
    bad_edge = abs(band_edge(main_poles(bad))
                   - band_edge(committed["bands"]["(0,0)"]["particle"]["main_poles"]))
    bad_a = resolvent_checks(ham, seed(k_ladder(0, 0, True)), e0, omegas, 0.05,
                             planted=True)["a_err"]
    log(f"  planted fault (a zeroed H psi): band edge off by {bad_edge:.2e} (tol "
        f"{SPECTRAL_POLE_ATOL:g}), A(omega) off by {bad_a:.2e} (tol {SPECTRAL_A_RTOL:g}); "
        f"the sum rule holds by construction "
        f"({abs(float(bad['weights'].sum()) - rows['(0,0) particle']['sum_rule']):.1e})")
    if bad_edge <= SPECTRAL_POLE_ATOL or bad_a <= SPECTRAL_A_RTOL:
        raise AssertionError("the zeroed H psi passed the spectral gates")
    res_out["planted"] = dict(edge_err=bad_edge, a_err=bad_a)

    # sqw_3x3.py: S^zz(q, omega), its weights against the static correlator
    sqw = _json(DEMO_ADAPT, "sqw.json")
    grid = np.load(os.path.join(DEMO_ADAPT, "sqw_grid.npz"))
    omegas_s = np.linspace(*SQW_OMEGAS)
    qrows, sqw_s = {}, 0.0
    for qx in range(3):
        for qy in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            res = dynamical_structure_factor(p, gs, e0, (qx, qy), kind="spin", m=SPECTRAL_M,
                                             omegas=omegas_s, eta=0.1, device=dev)
            sqw_s += time.perf_counter() - t1
            sq = C.spin_q_operator(3, 3, qx, qy)
            static = float(Observable(jordan_wigner(hermitian_conjugated(sq) * sq), 18)
                           .expectation_scan(gs64))
            w_sum = float(res["weights"].sum())
            key = f"{qx},{qy}"
            g_row = grid["A"][[str(q) for q in grid["qs"]].index(key)]
            lad = Observable(jordan_wigner(sq), 18)
            qrows[key] = dict(
                weights_sum=w_sum, static=static, static_err=abs(w_sum - static),
                committed_err=abs(w_sum - sqw["q_rows"][key]["static_SzzQ"]),
                committed_a_err=float(np.abs(res["A"] - g_row).max() / g_row.max()),
                **resolvent_checks(ham, torch.from_numpy(apply_on_host(lad, gs)).to(dev), e0,
                                   omegas_s, 0.1))
    q_worst = {k: max(r[k] for r in qrows.values())
               for k in ("static_err", "committed_err", "a_err", "a_err_full", "committed_a_err")}
    log(f"  sqw_3x3 (spin, 9 q, m = {SPECTRAL_M}): {sqw_s:.2f} s on the kernels (the JAX CPU "
        f"run: {sqw['elapsed_s']} s); weights within {q_worst['static_err']:.2e} of the "
        f"kernel-route static correlator and {q_worst['committed_err']:.2e} of sqw.json (tol "
        f"{SUM_RULE_ATOL:g}); A(omega) of the first {SPECTRAL_A_LEVELS} levels within "
        f"{q_worst['a_err']:.2e} of the complex128 plain Lanczos (tol {SPECTRAL_A_RTOL:g}); not "
        f"gated: all levels {q_worst['a_err_full']:.2e}, sqw_grid.npz "
        f"{q_worst['committed_a_err']:.2e}")
    if q_worst["static_err"] > SUM_RULE_ATOL or q_worst["committed_err"] > SUM_RULE_ATOL or \
            q_worst["a_err"] > SPECTRAL_A_RTOL:
        raise AssertionError("sqw: a gate failed")
    res_out.update(sqw=qrows, sqw_worst=q_worst, sqw_seconds=sqw_s,
                   seconds=time.perf_counter() - t0)
    log(f"  spectral phase: {res_out['seconds']:.1f} s")
    return res_out


MS_DEMO = dict(n_starts=16, n_epoch=400, reps=4, lr=3e-2, x_dimension=2, y_dimension=2,
               n_electrons=4, n_spin_up=2, n_spin_down=2, tunneling=1.0, coulomb=6.0,
               init_scale=0.1, seed=0)  # benchmarks/demo_multistart/run.py
MS_ED_ATOL = 1e-5  # the best energy against the JSON's ED energy
# starts whose float64 finals in multistart.json lie within this of the
# JSON's best end at one minimum: float32 (~1e-7 |E| a rounding, ~1e-6
# after 400 epochs) cannot order them, so the best start is gated to that set
MS_TIE_ATOL = 1e-6
MS_TRAJ_RTOL = 1e-4  # each start's trajectory against a single-start driver
MS_3X3 = dict(n_starts=4, n_epoch=5, reps=10, lr=1e-2, x_dimension=3, y_dimension=3,
              n_electrons=9, n_spin_up=5, n_spin_down=4, tunneling=1, coulomb=6,
              init_scale=0.1, seed=0, ground_truth=False)
MS_LIH = dict(n_starts=4, n_epoch=10, reps=HEA_REPS, lr=1e-1, seed=0)


def trajectory_errors(energies, singles):
    """The largest relative difference of each start's trajectory
    (``energies[:, b]``) from its single-start run, and the same for the
    planted fault: the rows rotated by one, as a batching bug that mixed
    up the starts would leave them."""
    import numpy as np

    singles = np.asarray(singles).T  # (epochs, B)

    def err(got):
        return float(np.max(np.abs(got - singles) / np.abs(singles)))

    return dict(traj_rel_err=err(energies), planted_rel_err=err(np.roll(energies, 1, axis=1)))


def multistart_epochs(ms, label):
    """ms.run() with the launch counters set to 0 just before and read just
    after, then the final evaluation alone: ms and launches per epoch."""
    import functools

    import torch

    from qsfh_torch.algos.multistart import batched_train
    from qsfh_torch.engine import kernels as K

    adam = functools.partial(torch.optim.Adam, lr=ms.lr)
    batched_train(ms.loss, ms.batch_params, adam, 1)  # first use: layouts and tables
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = ms.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    total = K.launch_counts()
    K.reset_launch_counts()
    t1 = time.perf_counter()
    batched_train(ms.loss, ms.batch_params, adam, 0)
    torch.cuda.synchronize()
    final_s = time.perf_counter() - t1
    final = K.launch_counts()
    per_epoch = {k: (total[k] - final[k]) / ms.n_epoch for k in total if total[k] - final[k]}
    ms_epoch = 1e3 * (run_s - final_s) / ms.n_epoch
    log(f"  {label}: {ms.n_epoch} epochs of {ms.n_starts} starts in {run_s:.2f} s, "
        f"{ms_epoch:.2f} ms an epoch; launches an epoch "
        + ", ".join(f"{k} {v:g}" for k, v in per_epoch.items()))
    return out, dict(run_seconds=run_s, ms_per_epoch=ms_epoch, launches=total,
                     launches_per_epoch=per_epoch)


def phase_multistart(dev, tmp):
    """benchmarks/demo_multistart/run.py in full (2x2, B = 16, 400 epochs;
    the per-term kernels): the best start among the JSON's tied best
    starts and its energy within 1e-5 of the ED energy; then at full width
    a 3x3 reps = 10 MultistartHVA (B = 4, 5 epochs) and a LiH MultistartHEA
    (B = 4, 10 epochs), each start's trajectory against a single-start HVA
    / VQE from its angles.  Planted faults: the saddle's zero-init start as
    the best, and the starts' rows rotated by one."""
    import functools

    import numpy as np
    import torch

    from qsfh_torch.algos.hea import VQE
    from qsfh_torch.algos.hva import HVA
    from qsfh_torch.algos.multistart import MultistartHEA, MultistartHVA, batched_train

    t0 = time.perf_counter()
    res = {}
    committed = _json(DEMO_MULTISTART, "multistart.json")
    ms = MultistartHVA(results_root=DEMO_MULTISTART, device=dev, **MS_DEMO)
    out, res["2x2"] = multistart_epochs(ms, "2x2 demo (B = 16, reps = 4)")
    diffs = np.abs(out["final_energies"] - np.asarray(committed["final_energies"]))
    zero = {k: torch.zeros_like(v[:1]) for k, v in ms.batch_params.items()}
    _, zero_traj, zero_final = batched_train(
        ms.loss, zero, functools.partial(torch.optim.Adam, lr=ms.lr), ms.n_epoch)
    zero_final = float(zero_final[0])
    ed_err = abs(out["best_energy"] - committed["ed_energy"])
    log("  final energies (port | JSON): " + "; ".join(
        f"{b}: {e:.9f} | {c:.9f}" for b, (e, c) in
        enumerate(zip(out["final_energies"], committed["final_energies"]))))
    json_e = np.asarray(committed["final_energies"])
    ties = sorted(int(b) for b in np.nonzero(json_e - json_e.min() < MS_TIE_ATOL)[0])
    zero_err = abs(zero_final - committed["ed_energy"])
    log(f"  largest difference {diffs.max():.2e}; best start {out['best_index']} (the JSON's "
        f"starts {ties} end within {float(np.ptp(json_e[ties])):.1e} of its best, below "
        f"float32's resolution: the gate takes any of them), best energy "
        f"{out['best_energy']:.9f}, {ed_err:.2e} from the ED energy (tol {MS_ED_ATOL:g}); the "
        f"zero-init run ends at {zero_final:.6f} (JSON {committed['zero_init_final']:.6f}; "
        f"rounding noise at the saddle: not gated)")
    res["2x2"].update(final_energies=out["final_energies"].tolist(), best_index=out["best_index"],
                      json_best_starts=ties, max_final_diff=float(diffs.max()),
                      best_ed_err=ed_err, zero_init_final=zero_final)
    if out["best_index"] not in ties or ed_err > MS_ED_ATOL:
        raise AssertionError("multistart 2x2: the best start or its energy disagrees with the JSON")
    # the planted fault: the zero-init start, stuck at the saddle, as the best
    log(f"  planted fault (the zero-init start, the saddle, taken as the best): {zero_err:.2e} "
        f"from the ED energy (must exceed {MS_ED_ATOL:g})")
    if zero_err <= MS_ED_ATOL:
        raise AssertionError("the saddle start passed the multistart ED gate")

    # 3x3 reps = 10: each start against a single-start HVA from its angles
    ms = MultistartHVA(results_root=os.path.join(tmp, "ms3x3"), device=dev, **MS_3X3)
    out, res["3x3"] = multistart_epochs(ms, "3x3 HVA reps = 10 (B = 4)")
    hva = HVA(n_epoch=MS_3X3["n_epoch"], reps=10, lr=MS_3X3["lr"], x_dimension=3, y_dimension=3,
              n_electrons=9, n_spin_up=5, n_spin_down=4, tunneling=1, coulomb=6,
              ground_truth=False, plot=False, log_metrics=False,
              results_root=os.path.join(tmp, "ms3x3_single"), device=dev)
    singles = []
    for b in range(ms.n_starts):
        th = torch.cat([ms.batch_params[k][b] for k in ("theta_U", "theta_v", "theta_h")])
        th = th.clone()
        opt = torch.optim.Adam([th], lr=hva.lr)
        traj = []
        for _ in range(ms.n_epoch):
            th, opt, e, *_ = hva._step(th, opt)
            traj.append(float(e))
        singles.append(traj)
    res["3x3"].update(trajectory_errors(out["energies"], singles))
    log(f"  3x3: every start within {res['3x3']['traj_rel_err']:.2e} of a single-start HVA (tol "
        f"{MS_TRAJ_RTOL:g}); planted fault (the starts' rows rotated by one): "
        f"{res['3x3']['planted_rel_err']:.2e} (must exceed {MS_TRAJ_RTOL:g})")

    # LiH: each start against a single-start VQE from its angles
    ms = MultistartHEA(lih_molecule(), device=dev, **MS_LIH)
    out, res["lih"] = multistart_epochs(ms, "LiH HEA (B = 4)")
    vqe = VQE(lih_molecule(), n_epoch=MS_LIH["n_epoch"], reps=MS_LIH["reps"], lr=MS_LIH["lr"],
              threshold=0.0, plot=False, log_metrics=False,
              results_root=os.path.join(tmp, "ms_lih_single"), device=dev)
    singles = []
    for b in range(ms.n_starts):
        th = ms.batch_params[b].clone()
        opt = torch.optim.Adam([th], lr=vqe.lr)
        traj = []
        for _ in range(ms.n_epoch):
            th, opt, e, _ = vqe._step(th, opt)
            traj.append(float(e))
        singles.append(traj)
    res["lih"].update(trajectory_errors(out["energies"], singles))
    log(f"  LiH: every start within {res['lih']['traj_rel_err']:.2e} of a single-start VQE (tol "
        f"{MS_TRAJ_RTOL:g}; planted fault, rows rotated: {res['lih']['planted_rel_err']:.2e}); "
        f"best {out['best_energy']:.6f}, {out['best_gap']:.2e} above FCI")
    for cell in ("3x3", "lih"):
        if res[cell]["traj_rel_err"] > MS_TRAJ_RTOL:
            raise AssertionError(f"multistart {cell}: a start disagrees with its single-start driver")
        if res[cell]["planted_rel_err"] <= MS_TRAJ_RTOL:
            raise AssertionError(f"multistart {cell}: the rotated rows passed the trajectory gate")
    for cell, names in (("3x3", ("rotation_resident", "adjoint_resident")),
                        ("lih", ("rotation_resident", "adjoint_resident")),
                        ("2x2", ("pauli_rotation", "adjoint_rotation"))):
        missing = [k for k in names if not res[cell]["launches_per_epoch"].get(k)]
        if missing:
            raise AssertionError(f"multistart {cell}: {missing} did not launch")
    res["seconds"] = time.perf_counter() - t0
    log(f"  multistart phase: {res['seconds']:.1f} s")
    return res


SAMPLING_SHOTS = 2048  # benchmarks/tpu_sampling.py
SAMPLING_E_RTOL = 1e-5
SAMPLING_Z = 5.0


def phase_sampling(dev):
    """benchmarks/tpu_sampling.py's configuration: the 3x3 H in 32 QWC
    groups, a default_rng(13) random state, 2048 shots a group: the
    analytic E (``expectation_grouped``) against sampling_expected.json,
    the grouped estimate within 5 sigma of it, the determinism probe;
    ms per grouped estimate.  On a random state every Pauli string but the
    identity averages ~2^(-n/2), so the estimate also runs on the cached
    ED ground state (E0 = -5.5623, its hopping groups far from 0), where a
    planted fault (the basis change skipped) must fail the 5 sigma gate."""
    import numpy as np
    import torch

    from qsfh_torch.algos.base import HubbardProblem
    from qsfh_torch.engine import kernels as K
    from qsfh_torch.engine import sampling as S

    t0 = time.perf_counter()
    expected = _json(HERE, "benchmarks", "sampling_expected.json")
    p = HubbardProblem(3, 3, 1.0, 6.0, 9, 5, 4, results_root=DEMO_ADAPT)
    ham, obs = p.qubit_hamiltonian, p.observables["H"]
    groups = S.qwc_groups(ham)
    const, masks, *_ = S.pack_groups(ham, 18, groups)
    rng = np.random.default_rng(13)
    v = rng.standard_normal(1 << 18) + 1j * rng.standard_normal(1 << 18)
    v /= np.linalg.norm(v)
    psi = torch.from_numpy(v).to(dev).to(torch.complex64)
    gen = torch.Generator(device=dev).manual_seed(17)

    def z_score(state, analytic):
        est = S.estimate_expectation_scan(state, 18, ham, SAMPLING_SHOTS, generator=gen,
                                          groups=groups)
        return est, abs(est.mean - analytic) / max(est.stderr, 1e-12)

    K.reset_launch_counts()
    analytic = float(obs.expectation_scan(psi))
    est, z = z_score(psi, analytic)
    counts = {k: c for k, c in K.launch_counts().items() if c}
    e_err = abs(analytic - expected["analytic"]) / abs(expected["analytic"])
    probe = torch.zeros(16, dtype=torch.complex64, device=dev)
    probe[1] = 1.0
    dp = int((S.sample_bitstrings(probe, 4, 64, generator=gen) != 1).sum())
    basis = torch.zeros(1 << 18, dtype=torch.complex64, device=dev)
    basis[123457] = 1.0
    dp += int((S.sample_bitstrings(basis, 18, SAMPLING_SHOTS, generator=gen) != 123457).sum())
    est_ms = time_cuda(lambda: S.estimate_expectation_scan(psi, 18, ham, SAMPLING_SHOTS,
                                                           generator=gen, groups=groups), reps=3,
                       warmup=1)
    log(f"  {masks.shape[0]} QWC groups (JSON {expected['n_groups']}), {SAMPLING_SHOTS} shots a "
        f"group: analytic E {analytic:.7f} within {e_err:.2e} of sampling_expected.json (tol "
        f"{SAMPLING_E_RTOL:g}); estimate {est.mean:.5f} +- {est.stderr:.5f}, z = {z:.2f} (tol "
        f"{SAMPLING_Z:g}); determinism probe {dp} (must be 0); {est_ms:.2f} ms per grouped "
        f"estimate; launches " + ", ".join(f"{k} {c}" for k, c in counts.items()))
    if masks.shape[0] != expected["n_groups"] or e_err > SAMPLING_E_RTOL or z > SAMPLING_Z or dp:
        raise AssertionError("sampling: a gate failed")
    if counts != {"expectation_grouped": inner_launches(obs.inner_groups(), 18)}:
        raise AssertionError(f"sampling: unexpected launches {counts}")
    # the ground state, and the planted fault: samples of the unrotated state
    gs = torch.from_numpy(np.asarray(p.ground_state(degenerate=True, n_states=4)[1][0]))
    gs = gs.to(dev).to(torch.complex64)
    e_gs = float(obs.expectation_scan(gs))
    est_gs, z_gs = z_score(gs, e_gs)
    rotate = S._rotate_data_driven
    S._rotate_data_driven = lambda psi_, n, xb, yb: psi_
    try:
        bad, bad_z = z_score(gs, e_gs)
    finally:
        S._rotate_data_driven = rotate
    log(f"  ground state: E {e_gs:.6f}, estimate {est_gs.mean:.5f} +- {est_gs.stderr:.5f}, z = "
        f"{z_gs:.2f} (tol {SAMPLING_Z:g}); planted fault (the basis change skipped): estimate "
        f"{bad.mean:.4f}, z = {bad_z:.1f} (must exceed {SAMPLING_Z:g})")
    if z_gs > SAMPLING_Z:
        raise AssertionError("sampling: the ground-state estimate is off")
    if bad_z <= SAMPLING_Z:
        raise AssertionError("the skipped basis change passed the sampling gate")
    return dict(n_groups=int(masks.shape[0]), analytic=analytic, analytic_rel_err=e_err,
                estimate=est.mean, stderr=est.stderr, z=z, determinism_probe=dp,
                estimate_ms=est_ms, launches=counts, ground_energy=e_gs,
                ground_estimate=est_gs.mean, ground_z=z_gs, planted_z=bad_z,
                seconds=time.perf_counter() - t0)


# -- the command line: qsfh_torch.cli on the card -------------------------------------------

CLI_ADAPT_ITERS = 20  # inner iterations per epoch of the 3x3 CLI run (2 epochs)
CLI_RTOL = 1e-5  # the CLI runs against the same calls through the Python API, relative
SCREEN_TIE = 1e-5  # two screen values within this share of max |g| are a float32 tie
# ||H psi - E psi|| / sum_t |c_t| of the 2x6 ground state put back into complex64: its
# rounding (2^-24 relative per amplitude) gives ~1e-8 (6.7e-9 on the H100); a Ritz vector of
# an 8-step Krylov run gives ~3e-2
ED24_RESIDUAL_TOL = 1e-6
ED24_RTOL = 1e-5  # the Rayleigh quotient against E, relative; N and Sz, absolute
CONFIG_ED24 = dict(x_dimension=2, y_dimension=6, tunneling=1.0, coulomb=6.0, n_electrons=12,
                   n_spin_up=6, n_spin_down=6)
CLI_KERNELS = ("rotation_resident", "pauli_apply_grouped", "expectation_grouped",
               "adjoint_resident", "screen_grouped")  # TPU kernels 1-5: the 3x3 main path


@contextlib.contextmanager
def cli_instruments():
    """Records of the runs made inside: ``adapts``, every ADAPT built (the
    driver objects); ``selections``, each ``select_operator`` call's
    (selected, gradients); ``solves``, the seconds of each sector Lanczos
    solve that ``HubbardProblem.ground_state`` ran (card synchronized);
    ``plain``, the calls of each plain version in ``engine/kernels.py``.
    Everything is put back on exit."""
    import torch

    from qsfh_torch.algos import adapt as adapt_mod
    from qsfh_torch.algos import base
    from qsfh_torch.engine import kernels as K

    rec = dict(adapts=[], selections=[], solves=[], plain={})
    saved = []

    def patch(owner, name, make):
        original = getattr(owner, name)
        saved.append((owner, name, original))
        setattr(owner, name, make(original))

    def init(original):
        def wrapped(self, *a, **k):
            rec["adapts"].append(self)
            original(self, *a, **k)
        return wrapped

    def select(original):
        def wrapped(self, *a, **k):
            out = original(self, *a, **k)
            rec["selections"].append((list(out[0]), [float(g) for g in out[1]]))
            return out
        return wrapped

    def solve(original):
        def wrapped(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = original(*a, **k)
            torch.cuda.synchronize()
            rec["solves"].append(time.perf_counter() - t0)
            return out
        return wrapped

    def count(name):
        def make(original):
            def wrapped(*a, **k):
                rec["plain"][name] = rec["plain"].get(name, 0) + 1
                return original(*a, **k)
            return wrapped
        return make

    patch(adapt_mod.ADAPT, "__init__", init)
    patch(adapt_mod.ADAPT, "select_operator", select)
    patch(base, "degenerate_ground_space", solve)
    patch(base, "lanczos_ground_state", solve)
    for name in dir(K):
        if name.endswith("_plain") and callable(getattr(K, name)):
            patch(K, name, count(name))
    try:
        yield rec
    finally:
        for owner, name, original in reversed(saved):
            setattr(owner, name, original)


def run_cli(argv, workdir):
    """``qsfh_torch.cli.main(argv)`` in ``workdir`` (its JSON files land
    there; results under ``workdir/results``), stdout captured: (stdout,
    seconds on the host clock, card synchronized)."""
    import io

    import torch

    from qsfh_torch import cli

    os.makedirs(workdir, exist_ok=True)
    buf, cwd = io.StringIO(), os.getcwd()
    os.chdir(workdir)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(list(argv) + ["--results-root", os.path.join(workdir, "results")])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    out = buf.getvalue()
    last = [s for s in out.splitlines() if s.strip()][-1:]
    log(f"  qsfh_torch.cli {' '.join(argv)}: {seconds:.2f} s; last line: {last[0] if last else ''}")
    return out, seconds


def quiet(fn):
    """fn()'s result, its printing captured (the drivers' per-step lines)."""
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        return fn()


def json_close(got, ref, rtol, path="$"):
    """Raise unless two parsed JSON values agree: numbers within rtol of
    max(1, |ref|), everything else equal."""
    if isinstance(ref, dict):
        if not isinstance(got, dict) or set(got) != set(ref):
            raise AssertionError(f"{path}: keys {sorted(got)} vs {sorted(ref)}")
        for k in ref:
            json_close(got[k], ref[k], rtol, f"{path}.{k}")
    elif isinstance(ref, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(ref):
            raise AssertionError(f"{path}: lengths differ")
        for i, (g, r) in enumerate(zip(got, ref)):
            json_close(g, r, rtol, f"{path}[{i}]")
    elif isinstance(ref, (int, float)) and not isinstance(ref, bool):
        if not abs(float(got) - float(ref)) <= rtol * max(1.0, abs(float(ref))):
            raise AssertionError(f"{path}: {got} vs {ref} (rtol {rtol:g})")
    elif got != ref:
        raise AssertionError(f"{path}: {got!r} vs {ref!r}")


def results_json(root):
    """{file name: parsed} of the drivers' results JSON under ``root``."""
    out = {}
    folder = os.path.join(root, "vqe_results")
    for name in sorted(os.listdir(folder)):
        if name.endswith(".json"):
            with open(os.path.join(folder, name)) as fh:
                out[name] = json.load(fh)
    return out


def manifold_against_cache(path):
    """(energy, |E - E_cache|, 1 - subspace fidelity) of a 4-state manifold
    file against the committed cache."""
    import numpy as np

    from qsfh_torch.io.checkpoint import load_ground_state

    energy, states = load_ground_state(path)
    e_cache, cached = load_ground_state(GROUND_STATE)
    overlap = np.stack(states).conj() @ np.stack(cached).T
    fidelity = float(np.sum(np.abs(overlap) ** 2)) / len(cached)
    if len(states) != len(cached):
        raise AssertionError(f"{path}: {len(states)} states, the cache {len(cached)}")
    return energy, abs(energy - e_cache), abs(1.0 - fidelity)


def cli_adapt_3x3(dev, tmp):
    """``cli adapt`` at 3x3 (18 qubits, 2 epochs of CLI_ADAPT_ITERS inner
    iterations) solving its 4-state manifold on the card, against the
    committed cache and against the same run through the Python API."""
    import torch

    from qsfh_torch.algos.adapt import ADAPT
    from qsfh_torch.engine import kernels as K

    c = CONFIG
    lattice = ["--x-dimension", "3", "--y-dimension", "3", "--n-electrons", "9",
               "--n-spin-up", "5", "--n-spin-down", "4"]
    argv = ["adapt"] + lattice + ["--degenerate-subspace", "4", "--n-epoch", "2",
                                  "--max-inner-iterations", str(CLI_ADAPT_ITERS), "--no-plot"]
    work = os.path.join(tmp, "cli_adapt")
    with cli_instruments() as rec:
        K.reset_launch_counts()
        _, seconds = run_cli(argv, work)
        counts = K.launch_counts()
    (driver,) = rec["adapts"]
    cache = driver.problem.ground_state_path().replace(".npz", " deg4.npz")
    energy, e_err, f_err = manifold_against_cache(cache)
    (solve_s,) = rec["solves"]
    log(f"  the 4-state manifold solved on the card in {solve_s:.3f} s (the host: "
        f"{HOST_ED_SECONDS} s): E0 {energy:.15f}, |E - cache| {e_err:.2e}, "
        f"1 - fidelity {f_err:.2e} (tol {ED_TOL:g})")
    if e_err > ED_TOL or f_err > ED_TOL:
        raise AssertionError("cli adapt: the card's 3x3 manifold disagrees with the cache")
    missing = [k for k in CLI_KERNELS if not counts[k]]
    if missing or rec["plain"]:
        raise AssertionError(f"cli adapt: kernels {missing} not launched, plain versions "
                             f"{rec['plain']} called")
    timer = driver.timer
    step_ms = 1e3 * timer.totals["inner iteration"] / timer.counts["inner iteration"]
    select_ms = 1e3 * timer.totals["screening"] / timer.counts["screening"]
    log(f"  launches: {{{', '.join(f'{k}: {counts[k]}' for k in CLI_KERNELS)}}}, plain "
        f"versions 0; {step_ms:.2f} ms per step, {select_ms:.1f} ms per selection (the "
        f"driver's phase timer), {len(driver.selected_indices)} operators")

    api_root = os.path.join(tmp, "api_adapt")
    with cli_instruments() as rec_api:
        kw = {k: c[k] for k in ("x_dimension", "y_dimension", "n_electrons", "n_spin_up",
                                "n_spin_down", "tunneling", "coulomb")}
        api = ADAPT(n_epoch=2, threshold1=1e-2, threshold2=1e-2,
                    max_inner_iterations=CLI_ADAPT_ITERS, degenerate_subspace=4,
                    results_root=api_root, plot=False, dtype=torch.complex64, device=dev,
                    ground_state_path=cache, **kw)
        quiet(api.run)
    got = results_json(os.path.join(work, "results"))
    ref = results_json(api_root)
    (name,) = got
    rows, api_rows = got[name], ref[name]
    ties = []
    for epoch, ((sel, grads), (api_sel, _)) in enumerate(zip(rec["selections"],
                                                            rec_api["selections"])):
        if set(sel) == set(api_sel):
            continue
        g, top = [abs(x) for x in grads], max(abs(x) for x in grads)
        only = set(sel) ^ set(api_sel)
        if max(g[i] for i in only) - min(g[i] for i in only) > SCREEN_TIE * top:
            raise AssertionError(f"cli adapt: epoch {epoch + 1} selected {sorted(set(sel))} "
                                 f"against the API's {sorted(set(api_sel))}")
        ties.append(epoch + 1)
        log(f"  epoch {epoch + 1}: a float32 tie in the screen ({sorted(only)}), either "
            "accepted; later values not compared")
        break
    if not ties:
        if rows["selected operators"] != api_rows["selected operators"]:
            raise AssertionError("cli adapt: selected operators differ from the API run")
        for key in ("epoch loss", "iteration loss", "fidelity", "Sz", "S^2", "n_params"):
            json_close(rows[key], api_rows[key], CLI_RTOL, key)
    log(f"  the API run: {len(api_rows['iteration loss'])} steps, the same selections"
        f"{' up to the tie' if ties else ''}, energies and fidelities within {CLI_RTOL:g}; "
        f"final E {rows['iteration loss'][-1]:.6f}, fidelity {rows['fidelity'][-1]:.6f}")
    return dict(seconds=seconds, solve_seconds=solve_s, energy=energy, energy_err=e_err,
                fidelity_err=f_err, launches=counts, step_ms=step_ms, select_ms=select_ms,
                n_operators=len(driver.selected_indices), ties=ties,
                final_energy=rows["iteration loss"][-1], final_fidelity=rows["fidelity"][-1])


def ed24_checks(p, energy, psi, dev, label):
    """(residual / sum |c|, Rayleigh relative error, N, Sz, weight outside
    the sector, launches) of a 2x6 full-space state ``psi`` (complex64 on
    the card) against energy E: H psi on ``pauli_apply_grouped``, the
    expectation values on ``expectation_grouped``."""
    import numpy as np
    import torch

    from qsfh_torch.engine import kernels as K
    from qsfh_torch.engine.expectation import Observable
    from qsfh_torch.linalg.sectors import jw_number_spin_indices
    from qsfh_torch.ops.jw import jordan_wigner

    n = p.n_qubits
    H = p.observables["H"]
    _, _, cre, cim = H._scan_terms()
    sum_c = float(np.abs(cre + 1j * cim).sum())
    number = Observable(jordan_wigner(p.fermion_operators["particle number"]), n)
    K.reset_launch_counts()
    norm2 = float(torch.linalg.vector_norm(psi)) ** 2
    residual = float(torch.linalg.vector_norm(H.apply_auto(psi) - energy * psi)) / sum_c
    rayleigh = float(H.expectation_auto(psi)) / norm2
    n_val = float(number.expectation_auto(psi)) / norm2
    sz = float(p.observables["Sz"].expectation_auto(psi)) / norm2
    counts = K.launch_counts()
    inside = torch.zeros(1 << n, dtype=torch.bool, device=dev)
    inside[torch.as_tensor(jw_number_spin_indices(p.n_electrons, p.n_spin_up, p.n_spin_down, n),
                           device=dev)] = True
    outside = float(psi[~inside].abs().max())
    rel = abs(rayleigh - energy) / abs(energy)
    log(f"  [{label}] ||H psi - E psi|| / sum|c| = {residual:.3e} (tol {ED24_RESIDUAL_TOL:g}; "
        f"sum|c| = {sum_c:g}), Rayleigh {rayleigh:.10f} (rel {rel:.2e}, tol {ED24_RTOL:g}), "
        f"N {n_val:.7f}, Sz {sz:.2e}, max |psi| outside the sector {outside:g}; launches "
        f"pauli_apply_grouped {counts['pauli_apply_grouped']}, expectation_grouped "
        f"{counts['expectation_grouped']}")
    return dict(residual=residual, rayleigh=rayleigh, rayleigh_rel_err=rel, N=n_val, Sz=sz,
                outside=outside, launches=counts, sum_c=sum_c)


def cli_ed_2x6(dev, tmp, variational):
    """``cli ed`` at 2x6 (24 qubits, 853,776 sector rows) on the card: the
    state through the 24-qubit application and inner-product kernels (the
    residual, the Rayleigh quotient, N and Sz, no weight outside the
    sector), E below every 2x6 variational energy of the earlier phases,
    and a planted fault (a Ritz vector of 8 Krylov steps) the residual gate
    must fail."""
    import numpy as np
    import torch

    from qsfh_torch.algos.base import HubbardProblem
    from qsfh_torch.engine import kernels as K
    from qsfh_torch.io.checkpoint import load_ground_state
    from qsfh_torch.linalg import lanczos

    c = CONFIG_ED24
    argv = ["ed", "--x-dimension", "2", "--y-dimension", "6", "--n-electrons", "12",
            "--n-spin-up", "6", "--n-spin-down", "6"]
    work = os.path.join(tmp, "cli_ed24")
    torch.cuda.reset_peak_memory_stats()
    with cli_instruments() as rec:
        K.reset_launch_counts()
        stdout, seconds = run_cli(argv, work)
        cli_counts = K.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    (solve_s,) = rec["solves"]
    printed = float(stdout.split("ground energy:")[1].split()[0])
    p = HubbardProblem(**c, results_root=os.path.join(work, "results"))
    energy, (state,) = load_ground_state(p.ground_state_path())
    if printed != energy:
        raise AssertionError(f"cli ed 2x6 printed {printed}, its cache holds {energy}")
    if any(cli_counts.values()) or rec["plain"]:
        raise AssertionError("cli ed 2x6 launched a statevector kernel or a plain version")

    # the pieces of the solve, timed apart: the host build and the card's Krylov run
    t0 = time.perf_counter()
    mat, idx = lanczos.sector_hamiltonian(p.qubit_hamiltonian, p.n_qubits, c["n_electrons"],
                                          c["n_spin_up"], c["n_spin_down"])
    build_s = time.perf_counter() - t0
    entries = int(mat.nnz)
    card_bytes = entries * (16 + 8) + (mat.shape[0] + 1) * 8
    csr = lanczos.device_matrix(mat, dev)
    v0 = lanczos._start_vector(idx.size, 7, torch.complex128, dev)  # the solver's default
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evals, _ = lanczos.lanczos_eigsh(lambda v: csr @ v, v0, k=160)
    torch.cuda.synchronize()
    krylov_s = time.perf_counter() - t0
    log(f"  2x6 ED (card, complex128): E = {energy:.12f}; host build {build_s:.2f} s, "
        f"{entries:,} entries ({card_bytes / 2**20:.1f} MiB on the card as CSR, "
        f"{mat.shape[0]:,} rows); card Krylov run (160 steps) {krylov_s:.2f} s (E "
        f"{float(evals[0]):.12f}); the whole solve {solve_s:.2f} s, the CLI call {seconds:.2f} s; "
        f"peak card memory {peak_gib:.2f} GiB")
    if abs(float(evals[0]) - energy) > 1e-9:
        raise AssertionError("the timed 2x6 Krylov run disagrees with the CLI's")

    psi = torch.from_numpy(state).to(dev).to(torch.complex64)
    del state
    checks = ed24_checks(p, energy, psi, dev, "2x6 ground state")
    if checks["residual"] > ED24_RESIDUAL_TOL:
        raise AssertionError("2x6 ED: the residual gate failed")
    if checks["rayleigh_rel_err"] > ED24_RTOL:
        raise AssertionError("2x6 ED: the Rayleigh quotient disagrees with E")
    if abs(checks["N"] - c["n_electrons"]) > ED24_RTOL or abs(checks["Sz"]) > ED24_RTOL:
        raise AssertionError("2x6 ED: N or Sz off the sector's")
    if checks["outside"] != 0.0:
        raise AssertionError("2x6 ED: weight outside the sector")
    if not checks["launches"]["pauli_apply_grouped"] or not checks["launches"][
            "expectation_grouped"]:
        raise AssertionError("2x6 ED checks: the 24-qubit kernels did not run")
    lowest = min(variational)
    log(f"  E {energy:.10f} below every 2x6 variational energy of the earlier phases "
        f"({len(variational)} values, the lowest {lowest:.8f})")
    if not energy < lowest:
        raise AssertionError("2x6 ED: a variational energy lies below E")

    _, vecs = lanczos.lanczos_eigsh(lambda v: csr @ v, v0, k=8)
    planted = torch.zeros(1 << p.n_qubits, dtype=torch.complex64, device=dev)
    planted[torch.from_numpy(idx).to(dev)] = vecs[0].to(torch.complex64)
    e8 = float(torch.vdot(vecs[0], csr @ vecs[0]).real)
    fault = ed24_checks(p, e8, planted, dev, "planted fault: 8 Krylov steps")
    if fault["residual"] <= ED24_RESIDUAL_TOL:
        raise AssertionError("the 8-step Ritz vector passed the 2x6 residual gate")
    del csr, psi, planted
    torch.cuda.empty_cache()
    return dict(energy=energy, seconds=seconds, solve_seconds=solve_s, build_seconds=build_s,
                krylov_seconds=krylov_s, entries=entries, card_bytes=card_bytes,
                rows=int(mat.shape[0]), peak_gib=peak_gib, lowest_variational=lowest,
                planted_residual=fault["residual"],
                **{k: v for k, v in checks.items() if k != "launches"},
                launches=checks["launches"])


def cli_small(dev, tmp):
    """The other subcommands at 2x2 / H2 / LiH on the card, each against the
    same call through the Python API: (per subcommand seconds, launches)."""
    import numpy as np
    import torch

    from qsfh_torch.algos.base import HubbardProblem
    from qsfh_torch.algos.dynamics import TrotterEvolution, neel_occupied
    from qsfh_torch.algos.hea import VQE
    from qsfh_torch.algos.hva import HVA
    from qsfh_torch.algos.iqcc import IQCC
    from qsfh_torch.algos.ite import ImaginaryTimeEvolution
    from qsfh_torch.algos.multistart import MultistartHVA
    from qsfh_torch.algos.vqd import VQD
    from qsfh_torch.engine import kernels as K
    from qsfh_torch.engine.expectation import Observable
    from qsfh_torch.engine.state import basis_state
    from qsfh_torch.linalg.spectral import spectral_function_lanczos
    from qsfh_torch.linalg.symmetry import momentum_weights, symmetry_adapted_states
    from qsfh_torch.molecules import H2, LiH
    from qsfh_torch.ops.correlations import _momentum_sum
    from qsfh_torch.ops.fermion import FermionOperator
    from qsfh_torch.ops.jw import jordan_wigner

    c64 = torch.complex64
    lat = dict(x_dimension=2, y_dimension=2, tunneling=1.0, coulomb=6.0, n_electrons=4,
               n_spin_up=2, n_spin_down=2)
    out = {}

    def cli(name, argv):
        K.reset_launch_counts()
        work = os.path.join(tmp, f"cli_{name}")
        stdout, seconds = run_cli(argv, work)
        out[name] = dict(seconds=seconds, launches=K.launch_counts())
        return stdout, work

    def api_root(name):
        return os.path.join(tmp, f"api_{name}")

    def same_results(name, work, rtol):
        json_close(results_json(os.path.join(work, "results")), results_json(api_root(name)),
                   rtol, name)

    _, work = cli("hva", ["hva", "--n-epoch", "5", "--reps", "2", "--lr", "5e-2", "--no-plot"])
    quiet(HVA(n_epoch=5, reps=2, lr=5e-2, threshold=1e-2, results_root=api_root("hva"),
              plot=False, dtype=c64, device=dev, **lat).run)
    same_results("hva", work, HVA_ENERGY_RTOL)

    _, work = cli("hea", ["hea", "--molecule", "H2", "--n-epoch", "20", "--no-plot"])
    quiet(VQE(H2(0.8), n_epoch=20, reps=5, lr=0.1, threshold=2e-3, results_root=api_root("hea"),
              plot=False, dtype=c64, device=dev).run)
    same_results("hea", work, HEA_RTOL)

    stdout, work = cli("vqd", ["vqd", "--molecule", "H2", "--n-levels", "2", "--n-epoch", "40"])
    energies = quiet(VQD(H2(0.8), n_levels=2, n_epoch=40, reps=3, lr=0.1, beta=5.0,
                         threshold=1e-4, results_root=api_root("vqd"), tag="VQD-H2", dtype=c64,
                         device=dev).run)
    printed = json.loads(stdout.split("VQD energies:")[1].strip().splitlines()[0])
    json_close(printed, energies, HEA_RTOL, "vqd")
    same_results("vqd", work, HEA_RTOL)

    _, work = cli("iqcc", ["iqcc", "--molecule", "LiH", "--n-epoch", "1", "--no-plot"])
    quiet(IQCC(LiH(1.0), n_epoch=1, lr=1e-2, threshold=5e-3, results_root=api_root("iqcc"),
               tag="iqcc-LiH", plot=False, dtype=c64, device=dev).run)
    same_results("iqcc", work, IQCC_ENERGY_RTOL)

    p = HubbardProblem(**lat, results_root=api_root("problem"))
    _, work = cli("dynamics", ["dynamics", "--initial", "neel"])
    obs = {"H": p.observables["H"],
           "double_occupancy_U": Observable(jordan_wigner(p.interacting_term), p.n_qubits),
           "Sz": p.observables["Sz"]}
    psi0 = basis_state(p.n_qubits, neel_occupied(2, 2), dtype=c64, device=dev)
    _, rec = TrotterEvolution(p, dt=0.02, order=2, dtype=c64, device=dev).evolve(psi0, 100, obs)
    with open(os.path.join(work, "dynamics.json")) as fh:
        disk = json.load(fh)
    json_close({k: disk[k] for k in rec}, {k: [float(v) for v in s] for k, s in rec.items()},
               CLI_RTOL, "dynamics")

    _, work = cli("ite", ["ite", "--dbeta", "0.05", "--order", "6", "--n-steps", "200",
                          "--initial", "neel"])
    ite = ImaginaryTimeEvolution(p, dbeta=0.05, order=6, dtype=c64, device=dev)
    _, rec = ite.run(psi0, n_steps=200, block=50, variance_tol=1e-8)
    with open(os.path.join(work, "ite.json")) as fh:
        disk = json.load(fh)
    json_close(disk, {"dbeta": ite.dbeta, "order": 6, "initial": "neel",
                      "steps": len(rec["energies"]), "energy": float(rec["energies"][-1]),
                      "variance": float(rec["variances"][-1])}, CLI_RTOL, "ite")

    e0, gs = p.ground_state(device=dev)
    stdout, _ = cli("symmetry", ["symmetry"])
    _, norms = symmetry_adapted_states(gs, 2, 2, device=dev)
    weights = momentum_weights(gs, 2, 2, device=dev)
    json_close(json.loads(stdout[stdout.index("{"):]),
               {"energy": e0, "c4_irrep_norms": {k: round(v, 8) for k, v in norms.items()},
                "momentum_weights": {f"({kx},{ky})": round(w, 8)
                                     for (kx, ky), w in weights.items() if w > 1e-10}},
               CLI_RTOL, "symmetry")

    _, work = cli("spectral", ["spectral", "--kind", "particle", "--kx", "1", "--ky", "1",
                               "--m", "40"])
    op = _momentum_sum(2, 2, 1, 1, lambda s: FermionOperator(((2 * s, 1),)))
    omegas = np.linspace(-10.0, 10.0, 201)
    res = spectral_function_lanczos(p, gs, float(e0), op, m=40, omegas=omegas, eta=0.1,
                                    dtype=c64, device=dev)
    with open(os.path.join(work, "spectral.json")) as fh:
        disk = json.load(fh)
    live = res["weights"] > 1e-8
    json_close({k: disk[k] for k in ("ground_energy", "norm2", "poles", "weights", "A")},
               {"ground_energy": float(e0), "norm2": float(res["norm2"]),
                "poles": [round(float(x), 8) for x in res["poles"][live]],
                "weights": [round(float(x), 8) for x in res["weights"][live]],
                "A": res["A"].tolist()}, CLI_RTOL, "spectral")

    stdout, _ = cli("multistart", ["multistart", "--n-starts", "4", "--n-epoch", "20",
                                   "--reps", "2"])
    ms = MultistartHVA(n_starts=4, n_epoch=20, reps=2, lr=3e-2, init_scale=0.1, seed=0,
                       results_root=api_root("multistart"), dtype=c64, device=dev, **lat)
    res = ms.run()
    # Adam divides by |g|, so a gradient whose last bits vary (an atomic
    # fold) parts the trajectories: a second run must give the same bits
    again = ms.run()
    if not (np.array_equal(res["energies"], again["energies"])
            and np.array_equal(res["final_energies"], again["final_energies"])):
        raise AssertionError("multistart: two API runs on the same seed gave different energies")
    line = stdout.splitlines()[0]
    if f"best start {res['best_index']} energy {res['best_energy']:.8f}" not in line:
        raise AssertionError(f"multistart: {line!r} against the API's best start "
                             f"{res['best_index']} {res['best_energy']:.8f}")

    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    work = os.path.join(tmp, "cli_ed_module")
    os.makedirs(work)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "qsfh_torch.cli", "ed", "--results-root",
                           os.path.join(work, "results")], cwd=work, env=env,
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"python -m qsfh_torch.cli ed failed: {proc.stderr[-2000:]}")
    printed = float(proc.stdout.split("ground energy:")[1].split()[0])
    out["ed_module"] = dict(seconds=time.perf_counter() - t0, energy=printed)
    log(f"  python -m qsfh_torch.cli ed (2x2, a process of its own): {proc.stdout.strip()} "
        f"in {out['ed_module']['seconds']:.1f} s")
    if abs(printed - e0) > ED_TOL:
        raise AssertionError(f"python -m qsfh_torch.cli ed: {printed} against the API's {e0}")
    log("  hva, hea, vqd, iqcc LiH, dynamics, ite, symmetry, spectral, multistart and the "
        "module's ed equal the same calls through the Python API on the card")
    return out


def phase_cli(dev, tmp, variational_24):
    """The port through its command line (``qsfh_torch.cli``) on the card:
    adapt at 3x3 at full width, ed at 2x6, the other subcommands small."""
    t0 = time.perf_counter()
    out = dict(adapt_3x3=cli_adapt_3x3(dev, tmp))
    out["ed_2x6"] = cli_ed_2x6(dev, tmp, variational_24)
    out["small"] = cli_small(dev, tmp)
    out["seconds"] = time.perf_counter() - t0
    log(f"  CLI phase: {out['seconds']:.1f} s")
    return out


# -- this slice: the float64 polish engine on the flagship checkpoint ----------------------

# benchmarks/demo_3x3/floor_hessian.json and polish_fast.jsonl eval 1: the
# checkpoint's E and ||g||_2 on the JAX package's host float64 engine
POLISH_E_CHECKPOINT = -5.562280730087479
POLISH_GNORM_CHECKPOINT = 1.4643792537358481e-3
POLISH_RECORD_E_ATOL = 1e-10
POLISH_RECORD_G_ATOL = 1e-9
# the kernels against their plain complex128 versions on the card
POLISH_E_ATOL = 1e-11
POLISH_G_ATOL = 1e-10
POLISH_STATE_ATOL = 1e-11  # 2-norm of the difference
POLISH_HPSI_RTOL = 1e-11
POLISH_FD_ATOL = 1e-7  # central differences at eps 1e-6
POLISH_HVP_RTOL = 1e-6  # <u, H v> = <v, H u>
# polish_fast.py:117-125's L-BFGS-B, cut at the record's 674 evaluations
POLISH_LBFGS = dict(maxiter=100000, maxcor=100, ftol=0.0, gtol=1e-9, maxls=60)
POLISH_LBFGS_EVALS = 674
POLISH_TRACE_ATOL = 1e-9  # evaluations 1-10 against polish_fast.jsonl
POLISH_LBFGS_E_BOUND = -5.562290  # a gap under 18.8 uHa (the record: 14.06)
POLISH_NEWTON_SECONDS = 20.0
POLISH_HVP_EPS = 1e-6
# Rot64Program.from_adapt on the committed checkpoint, as the JAX package groups it
POLISH_STRUCTURE = dict(n=18, n_params=1719, groups=1931, subterms=14123,
                        lengths={1: 65, 2: 145, 8: 1721}, diagonal=68, static=212, h_terms=100)
F64_GROUP_KERNELS = ("rot64_groups", "happly64", "adjoint64_groups")
F64_RESIDENT_KERNELS = ("rot64_resident", "adjoint64_resident")
# the resident route against the plain versions (of max |g|, beside the absolute
# POLISH_G_ATOL) and against the per-group route in the same call: the pair
# arithmetic is the same, so equal state bits are expected; the gradient's sums
# run in another order
POLISH_G_RTOL = 1e-10
POLISH_ROUTE_STATE_RTOL = 1e-15
POLISH_ROUTE_G_RTOL = 1e-13
POLISH_FEW_BLOCKS = 37  # fewer blocks than the 128 tiles of a run: the same bits
# the resident route's other tile shapes (k, c), timed beside the shipped one
POLISH_TILE_SHAPES = ((11, 1), (11, 0), (11, 2), (11, 3), (12, 1), (10, 1))


def polish_structure(prog):
    import numpy as np

    lengths = np.bincount(np.diff(prog.goff))
    return dict(n=prog.n, n_params=prog.n_params, groups=prog.G, subterms=len(prog.zsub),
                lengths={k: int(v) for k, v in enumerate(lengths) if v},
                diagonal=int((prog.gx == 0).sum()), static=int((prog.gpidx < 0).sum()),
                h_terms=len(prog.hx))


def polish_bounds(prog):
    """(bound ms, by) of apply, h_apply, value_and_grad and hvp: the state in
    and out (16 bytes an amplitude each way; value_and_grad and hvp read
    psi0 and write floats) and the program's arrays read once, at 3.35
    TB/s, against the least float64 arithmetic at 34 TFLOP/s.  Per
    amplitude and group: the rotation 6 (cos psi[a] + (+-i) sin psi[a ^ x]:
    2 + 2 + 2; a diagonal phase 6), the adjoint 17 (the contribution r
    Im(conj(L) psi[a ^ x]) and its sum 5, two rotations 12).  H psi with E
    and N: :func:`h_apply_flops`, the least of the per-term and the tile
    design."""
    dim = 1 << prog.n
    prog_bytes = 4 * (3 * prog.G + len(prog.zsub)) + 8 * len(prog.wsub)
    h_bytes = 24 * len(prog.hx)
    h_flops = h_apply_flops(prog.hx, prog.hcim, prog.h_tiles, dim)
    fwd, adj = 6 * dim * prog.G, 17 * dim * prog.G

    def bound(nbytes, flops):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F64_FLOPS_PER_S
        return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

    vg = bound(16 * dim + prog_bytes + h_bytes + 8 * (prog.n_params + 1), fwd + h_flops + adj)
    return {
        "apply": bound(32 * dim + prog_bytes + 8 * prog.n_params, fwd),
        "h_apply": bound(32 * dim + h_bytes, h_flops),
        "adjoint": bound(64 * dim + prog_bytes + 8 * prog.n_params, adj),
        "value_and_grad": vg,
        "hvp": (2 * vg[0], vg[1]),
    }


def polish_kernel_checks(prog, plain, th, psi0, label):
    """Gate (c) at one point: the kernels against the plain complex128
    versions (state, H psi, E, gradient), two calls the same bits, central
    differences on 3 coordinates, a symmetric HVP."""
    import numpy as np
    import torch

    from qsfh_torch.engine import kernels as K

    psi, psi_p = prog.apply(th, psi0), plain.apply(th, psi0)
    state_err = float(torch.linalg.vector_norm(psi - psi_p))
    h, h_p = prog.h_apply(psi), plain.h_apply(psi)
    h_err = rel_err(h, h_p)
    h_old = K.happly64(psi, *prog.h_arrays("terms"))[0]  # the per-term kernel on the same state
    e, g = prog.value_and_grad(th, psi0)
    e2, g2 = prog.value_and_grad(th, psi0)
    e_p, g_p = plain.value_and_grad(th, psi0)
    res = dict(state_err=state_err, state_max_abs=max_abs(psi, psi_p), hpsi_rel=h_err,
               hpsi_max_abs=max_abs(h, h_p), hpsi_old_rel=rel_err(h_old, h_p),
               hpsi_old_max_abs=max_abs(h_old, h_p), h_route=prog.h_route, e_err=abs(e - e_p),
               g_err=float(np.abs(g - g_p).max()), same_bits=e2 == e and np.array_equal(g2, g),
               energy=e, gnorm=float(np.linalg.norm(g)), route=prog.route)
    res["g_rel"] = res["g_err"] / float(np.abs(g_p).max())
    eps, fd = 1e-6, {}
    for k in (0, prog.n_params // 2, prog.n_params - 1):
        tp, tm = th.copy(), th.copy()
        tp[k] += eps
        tm[k] -= eps
        fd[k] = (prog.energy(tp, psi0) - prog.energy(tm, psi0)) / (2 * eps) - g[k]
    res["fd_err"] = max(abs(v) for v in fd.values())
    rng = np.random.default_rng(17)
    u, v = rng.standard_normal(len(th)), rng.standard_normal(len(th))
    hu = prog.hvp(th, psi0, u, eps=POLISH_HVP_EPS)
    hv = prog.hvp(th, psi0, v, eps=POLISH_HVP_EPS)
    uhv, vhu = float(np.dot(u, hv)), float(np.dot(v, hu))
    res.update(u_hv=uhv, v_hu=vhu, hvp_rel=abs(uhv - vhu) / abs(uhv))
    log(f"  {label}: E {e:+.15f}, ||g|| {res['gnorm']:.10e}; kernels against plain: state "
        f"{state_err:.2e} (tol {POLISH_STATE_ATOL:g}), H psi {h_err:.2e} relative on the "
        f"{prog.h_route} route, {res['hpsi_old_rel']:.2e} per term (tol {POLISH_HPSI_RTOL:g}), "
        f"E {res['e_err']:.2e} (tol {POLISH_E_ATOL:g}), max |dg| "
        f"{res['g_err']:.2e} (tol {POLISH_G_ATOL:g}), {res['g_rel']:.2e} of max |g| (tol "
        f"{POLISH_G_RTOL:g}), same bits on two calls {res['same_bits']}; "
        f"central differences {res['fd_err']:.2e} (tol {POLISH_FD_ATOL:g}); <u,Hv> {uhv:.10e} "
        f"<v,Hu> {vhu:.10e}, {res['hvp_rel']:.2e} relative (tol {POLISH_HVP_RTOL:g})")
    if not (state_err <= POLISH_STATE_ATOL and h_err <= POLISH_HPSI_RTOL
            and res["hpsi_old_rel"] <= POLISH_HPSI_RTOL
            and res["e_err"] <= POLISH_E_ATOL and res["g_err"] <= POLISH_G_ATOL
            and res["g_rel"] <= POLISH_G_RTOL
            and res["same_bits"] and res["fd_err"] <= POLISH_FD_ATOL
            and res["hvp_rel"] <= POLISH_HVP_RTOL):
        raise AssertionError(f"f64 polish, {label}: a kernel gate failed: {res}")
    return res, psi, h, psi_p, g_p


def polish_route_checks(prog, groups, th, psi0, psi_p, g_p, label):
    """Gate (c), the routes: the resident kernels against the per-group
    kernels in the same call (state and gradient), the per-group kernels
    against the plain results ``psi_p`` / ``g_p`` (gate (c)'s tolerances),
    and both resident kernels on a grid of POLISH_FEW_BLOCKS blocks
    against the full grid, bit for bit."""
    import numpy as np
    import torch

    from qsfh_torch.engine import kernels as K

    psi, psi_g = prog.apply(th, psi0), groups.apply(th, psi0)
    e, g = prog.value_and_grad(th, psi0)
    e_g, g_g = groups.value_and_grad(th, psi0)
    th_ext = prog._angles(th).clone()
    few = K.rot64_resident(prog._state(psi0), prog.groups, th_ext, prog.runs,
                           blocks=POLISH_FEW_BLOCKS)
    lam = 2.0 * prog.h_apply(psi)
    g_full = K.adjoint64_resident(psi.clone(), lam.clone(), prog.groups, th_ext, prog.runs)
    g_few = K.adjoint64_resident(psi.clone(), lam.clone(), prog.groups, th_ext, prog.runs,
                                 blocks=POLISH_FEW_BLOCKS)
    res = dict(state_rel=rel_err(psi, psi_g), state_equal_bits=bool(torch.equal(psi, psi_g)),
               e_diff=abs(e - e_g), g_rel=float(np.abs(g - g_g).max() / np.abs(g_g).max()),
               few_blocks_same_bits=bool(torch.equal(few, psi) and torch.equal(g_full, g_few)),
               grid=K.resident64_grid(psi, prog.runs, False), runs=len(prog.runs),
               groups_state_err=float(torch.linalg.vector_norm(psi_g - psi_p)),
               groups_state_max_abs=max_abs(psi_g, psi_p),
               groups_g_err=float(np.abs(g_g - g_p).max()))
    log(f"  {label}: resident ({res['runs']} runs, {res['grid']} blocks) against per-group: "
        f"state {res['state_rel']:.2e} relative (tol {POLISH_ROUTE_STATE_RTOL:g}; equal bits "
        f"{res['state_equal_bits']}), E {res['e_diff']:.2e}, g {res['g_rel']:.2e} of max |g| "
        f"(tol {POLISH_ROUTE_G_RTOL:g}); {POLISH_FEW_BLOCKS} blocks the same bits "
        f"{res['few_blocks_same_bits']}; per-group against plain: state "
        f"{res['groups_state_err']:.2e}, max |dg| {res['groups_g_err']:.2e}")
    if not (res["state_rel"] <= POLISH_ROUTE_STATE_RTOL and res["g_rel"] <= POLISH_ROUTE_G_RTOL
            and res["few_blocks_same_bits"] and res["groups_state_err"] <= POLISH_STATE_ATOL
            and res["groups_g_err"] <= POLISH_G_ATOL):
        raise AssertionError(f"f64 polish, {label}: the routes disagree: {res}")
    return res


def planted_layout_fault(prog):
    """A copy of ``prog`` whose layout misses a flip bit of one group in
    its middle run (the bit swapped for one outside the tile, so the tile
    keeps k bits), built past the constructor's check."""
    import numpy as np

    runs = copy.copy(prog.runs)
    r = len(runs) // 2
    g = next(g for g in range(runs.run_start[r], runs.run_start[r + 1]) if prog.gx[g])
    mask = int(runs.run_mask[r])
    bit = 1 << (int(prog.gx[g]).bit_length() - 1)
    spare = next(1 << b for b in range(prog.n) if not mask >> b & 1)
    runs.run_mask = runs.run_mask.copy()
    runs.run_mask[r] = np.int32(mask ^ bit ^ spare)
    runs._place()
    faulty = copy.copy(prog)
    faulty.runs = runs
    return faulty, dict(run=r, group=g, mask=mask, dropped_bit=bit, added_bit=spare)


def polish_records_gate(prog, x0, best, psi0, label):
    """Gate (b): E and ||g|| at the checkpoint, E at polish_fast_best.npz,
    against the JAX package's records.  Returns (errors, passed)."""
    import numpy as np

    e0, g0 = prog.value_and_grad(x0, psi0)
    e_best = prog.energy(best["t"], psi0)
    errs = dict(e_checkpoint=abs(e0 - POLISH_E_CHECKPOINT),
                gnorm_checkpoint=abs(float(np.linalg.norm(g0)) - POLISH_GNORM_CHECKPOINT),
                e_best=abs(e_best - float(best["energy"])))
    passed = (errs["e_checkpoint"] <= POLISH_RECORD_E_ATOL
              and errs["gnorm_checkpoint"] <= POLISH_RECORD_G_ATOL
              and errs["e_best"] <= POLISH_RECORD_E_ATOL)
    log(f"  {label}: checkpoint E {e0:+.15f} ({errs['e_checkpoint']:.2e} from the record), "
        f"||g|| {np.linalg.norm(g0):.16e} ({errs['gnorm_checkpoint']:.2e}); "
        f"polish_fast_best E {e_best:+.15f} ({errs['e_best']:.2e}): "
        f"{'within' if passed else 'outside'} the gates ({POLISH_RECORD_E_ATOL:g}, "
        f"{POLISH_RECORD_G_ATOL:g})")
    return dict(errs, e0=e0, gnorm0=float(np.linalg.norm(g0)), e_best=e_best), passed


def polish_run(prog, x0, psi0, ed, tmp, newton=True):
    """Gates (e) and (f): polish_fast.py's path on the card from the
    checkpoint, L-BFGS-B cut at 674 evaluations, then (``newton``)
    Newton-CG on central-difference HVPs time-boxed by the script's
    Deadline (checked in the HVPs too, so one CG solve cannot outrun it).
    The best point goes to ``tmp``."""
    import numpy as np
    from scipy.optimize import minimize

    best_path = os.path.join(tmp, "polish_best.npz")
    st = dict(n=0, best_e=np.inf, best_x=None, phase="lbfgs", trace=[], newton={})

    class Deadline(Exception):
        pass

    def f(x):
        e, g = prog.value_and_grad(x, psi0)
        st["n"] += 1
        st["trace"].append((st["phase"], e, float(np.linalg.norm(g))))
        if st["phase"] == "newton":
            st["newton"][x.tobytes()] = e
        if e < st["best_e"]:
            st["best_e"], st["best_x"] = e, np.array(x, np.float64)
            np.savez(best_path + ".tmp.npz", t=st["best_x"], energy=e)
            os.replace(best_path + ".tmp.npz", best_path)
        if st["phase"] == "lbfgs" and st["n"] >= POLISH_LBFGS_EVALS:
            raise Deadline
        if st["phase"] == "newton" and time.perf_counter() - st["t0"] > POLISH_NEWTON_SECONDS:
            raise Deadline
        return e, g

    def hessp(x, p):
        if time.perf_counter() - st["t0"] > POLISH_NEWTON_SECONDS:
            raise Deadline
        st["hvps"] += 1
        return prog.hvp(x, psi0, p, eps=POLISH_HVP_EPS)

    t0 = time.perf_counter()
    try:
        res = minimize(f, x0, jac=True, method="L-BFGS-B", options=POLISH_LBFGS)
        lbfgs_msg = f"status {res.status}: {res.message}"
    except Deadline:
        lbfgs_msg = f"cut at {POLISH_LBFGS_EVALS} evaluations"
    lbfgs_s = time.perf_counter() - t0
    lbfgs_evals, lbfgs_best = st["n"], st["best_e"]
    if not newton:
        return dict(lbfgs_msg=lbfgs_msg, lbfgs_s=lbfgs_s, lbfgs_evals=lbfgs_evals,
                    lbfgs_best=lbfgs_best, lbfgs_gap_uHa=1e6 * (lbfgs_best - ed),
                    trace=st["trace"])
    x = st["best_x"]
    st.update(phase="newton", t0=time.perf_counter(), hvps=0)
    accepted = []

    def callback(xk):
        accepted.append(st["newton"].get(np.asarray(xk).tobytes()))

    try:
        res = minimize(f, x, jac=True, hessp=hessp, method="Newton-CG", callback=callback,
                       options=dict(maxiter=300, xtol=1e-14))
        newton_msg = f"status {res.status}: {res.message}"
    except Deadline:
        newton_msg = f"time box ({POLISH_NEWTON_SECONDS:g} s)"
    newton_s = time.perf_counter() - st["t0"]
    newton_evals = st["n"] - lbfgs_evals
    return dict(lbfgs_msg=lbfgs_msg, lbfgs_s=lbfgs_s, lbfgs_evals=lbfgs_evals,
                lbfgs_best=lbfgs_best, lbfgs_gap_uHa=1e6 * (lbfgs_best - ed),
                newton_msg=newton_msg, newton_s=newton_s, newton_evals=newton_evals,
                newton_hvps=st["hvps"], newton_start=lbfgs_best, newton_accepted=accepted,
                best_e=st["best_e"], gap_uHa=1e6 * (st["best_e"] - ed), best_path=best_path,
                trace=st["trace"])


def polish_times(prog, groups, plain, th, psi0, psi, h, bounds):
    """Gate (g): ms per apply, h_apply, value_and_grad and hvp (CUDA events
    and host clock) on the resident route and the per-group route in turns
    (resident, groups, groups, resident) and on the plain versions, each
    wrapper's own ms per call, launches per call, beside the bounds."""
    import numpy as np
    import torch

    from qsfh_torch.engine import kernels as K

    u = np.random.default_rng(19).standard_normal(len(th))
    th_ext = torch.cat([torch.from_numpy(th), torch.ones(1, dtype=torch.float64)]).to(psi.device)
    lam = 2.0 * h
    calls = {
        "apply": (lambda p: p.apply(th, psi0), 20),
        "h_apply": (lambda p: p.h_apply(psi), 50),
        "value_and_grad": (lambda p: p.value_and_grad(th, psi0), 20),
        "hvp": (lambda p: p.hvp(th, psi0, u, eps=POLISH_HVP_EPS), 5),
    }

    def launches_of(fn):
        K.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        return {k: v for k, v in K.launch_counts().items() if v}

    def host_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / reps

    out = {}
    for what, (fn, reps) in calls.items():
        launches = launches_of(lambda: fn(prog))
        groups_launches = launches_of(lambda: fn(groups))
        ms, g_ms, host, g_host = [], [], [], []
        for route in ("resident", "groups", "groups", "resident"):
            p = prog if route == "resident" else groups
            (ms if route == "resident" else g_ms).append(time_cuda(lambda: fn(p), reps))
            (host if route == "resident" else g_host).append(host_ms(lambda: fn(p), reps))
        plain_ms = time_cuda(lambda: fn(plain), 1, warmup=0)
        b_ms, b_by = bounds[what]
        out[what] = dict(ms=sum(ms) / 2, host_ms=sum(host) / 2, groups_ms=sum(g_ms) / 2,
                         groups_host_ms=sum(g_host) / 2, turns_ms=ms, groups_turns_ms=g_ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, launches=launches,
                         groups_launches=groups_launches)
        r = out[what]
        log(f"  {what}: resident {r['ms']:.4f} ms (host clock {r['host_ms']:.4f}), per-group "
            f"{r['groups_ms']:.4f} ms (host {r['groups_host_ms']:.4f}), in turns; plain "
            f"{plain_ms:.1f} ms, bound {b_ms:.5f} ms ({b_by}): {r['ms'] / b_ms:.1f}x / "
            f"{r['groups_ms'] / b_ms:.1f}x; launches "
            + ", ".join(f"{k} {v}" for k, v in launches.items()) + " / "
            + ", ".join(f"{k} {v}" for k, v in groups_launches.items()))
    # each wrapper's own call, on fresh copies of its inputs
    g, h_terms = prog.groups, prog.h_arrays("terms")
    kern = {
        "rot64_groups": (lambda impl: impl.rot64_groups(psi0.clone(), g, th_ext), "apply"),
        "happly64": (lambda impl: impl.happly64(psi, *h_terms, 2.0), "h_apply"),
        "happly64_tiles": (lambda impl: impl.happly64_tiles(psi, *prog.h_args, prog.h_tiles, 2.0),
                           "h_apply"),
        "adjoint64_groups": (lambda impl: impl.adjoint64_groups(psi.clone(), lam.clone(), g,
                                                                th_ext), "adjoint"),
        "rot64_resident": (lambda impl: impl.rot64_resident(psi0.clone(), g, th_ext, prog.runs),
                           "apply"),
        "adjoint64_resident": (lambda impl: impl.adjoint64_resident(
            psi.clone(), lam.clone(), g, th_ext, prog.runs), "adjoint"),
    }
    for name, (fn, what) in kern.items():
        ms = time_cuda(lambda: fn(K.KERNELS), 10)
        plain_ms = time_cuda(lambda: fn(K.PLAIN), 1, warmup=0)
        b_ms, b_by = bounds[what]
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        log(f"  {name} alone: {ms:.4f} ms, plain {plain_ms:.1f} ms, bound {b_ms:.5f} ms "
            f"({b_by}): {ms / b_ms:.1f}x")
    # the two H psi kernels in turns (per term, tiles, tiles, per term), 5 rounds,
    # CUDA events around 20 calls and 20 calls replayed in a CUDA graph
    sides = ("happly64", "happly64_tiles")
    turns, graph = ({name: [] for name in sides} for _ in range(2))
    for _ in range(5):
        for name in sides + sides[::-1]:
            turns[name].append(time_cuda(lambda: kern[name][0](K.KERNELS), 20))
            graph[name].append(graph_ms(lambda: kern[name][0](K.KERNELS), 20))
    for name, ms in turns.items():
        out[name].update(turns_ms=ms, ms=float(np.median(ms)), graph_turns_ms=graph[name],
                         graph_ms=float(np.median(graph[name])))
    log("  H psi in turns (median of 10 x 20 calls; in a CUDA graph): " + ", ".join(
        f"{name} {out[name]['ms']:.4f} / {out[name]['graph_ms']:.4f} ms" for name in sides))
    return out


def polish_run_cost(prog, th, psi0):
    """The resident kernels' cost of a run: each kernel alone on layouts of
    the shipped tile shape whose runs hold at most 1, 2, 4 groups and the
    shipped cap (the same groups, more runs), and a least-squares line
    through (runs, ms): its slope the cost of a run (barrier, tile copies,
    staging), its intercept the groups' own work."""
    import numpy as np

    from qsfh_torch.engine import kernels as K
    from qsfh_torch.engine import streaming

    th_ext = prog._angles(th).clone()
    psi = prog.apply(th, psi0)
    lam = 2.0 * prog.h_apply(psi)
    rows = []
    for cap in (1, 2, 4, streaming.RESIDENT64_RUN_GROUPS):
        runs = streaming.Group64Runs(prog.gx, prog.goff, prog.zsub, prog.n, prog.runs.k,
                                     prog.runs.c, max_groups=cap)
        rows.append(dict(max_groups=cap, runs=len(runs), forward_ms=time_cuda(
            lambda: K.rot64_resident(psi0.clone(), prog.groups, th_ext, runs), 10),
            adjoint_ms=time_cuda(lambda: K.adjoint64_resident(
                psi.clone(), lam.clone(), prog.groups, th_ext, runs), 10)))
    x = np.array([r["runs"] for r in rows], np.float64)
    out = dict(rows=rows)
    for what in ("forward", "adjoint"):
        slope, intercept = np.polyfit(x, [r[f"{what}_ms"] for r in rows], 1)
        out[what] = dict(us_per_run=1e3 * float(slope), groups_ms=float(intercept))
    log("  run cost: " + ", ".join(f"{r['runs']} runs {r['forward_ms']:.4f} / "
                                   f"{r['adjoint_ms']:.4f} ms" for r in rows)
        + f" (forward / adjoint); a run {out['forward']['us_per_run']:.2f} / "
          f"{out['adjoint']['us_per_run']:.2f} us, the groups' own work "
          f"{out['forward']['groups_ms']:.3f} / {out['adjoint']['groups_ms']:.3f} ms")
    return out


def polish_tile_shapes(vqe, groups, th, psi0):
    """The resident route's ms per apply and value_and_grad at each of
    POLISH_TILE_SHAPES, in turns with the shipped shape, each checked
    against the per-group route's state bits and gradient."""
    import numpy as np
    import torch

    from qsfh_torch.native.statevec import Rot64Program

    psi_g = groups.apply(th, psi0)
    _, g_g = groups.value_and_grad(th, psi0)
    rows = []
    for k, c in POLISH_TILE_SHAPES:
        prog = Rot64Program.from_adapt(vqe, tile_bits=k, low_bits=c)
        same = bool(torch.equal(prog.apply(th, psi0), psi_g))
        g_rel = float(np.abs(prog.value_and_grad(th, psi0)[1] - g_g).max() / np.abs(g_g).max())
        apply_ms = [time_cuda(lambda: prog.apply(th, psi0), 10) for _ in range(2)]
        vg_ms = [time_cuda(lambda: prog.value_and_grad(th, psi0), 10) for _ in range(2)]
        rows.append(dict(k=k, c=c, runs=len(prog.runs), most_entries=prog.runs.most_entries,
                         apply_ms=min(apply_ms), value_and_grad_ms=min(vg_ms),
                         state_equal_bits=same, g_rel=g_rel))
        log(f"  tiles {k} / {c}: {len(prog.runs)} runs, apply {min(apply_ms):.4f} ms, "
            f"value_and_grad {min(vg_ms):.4f} ms (least of 2 x 10); state bits equal to the "
            f"per-group route {same}, g {g_rel:.2e} of max |g|")
        if not same or g_rel > POLISH_ROUTE_G_RTOL:
            raise AssertionError(f"f64 polish: tiles {k} / {c} disagree with the per-group route")
    return rows


def planted_h_fault(prog, plain, psi):
    """(d) A copy of ``prog`` whose H misses one item's coefficient (the
    first term of its first item of x != 0 set to 0): its H psi must fail
    the H psi gate against the plain version."""
    faulty = copy.copy(prog)
    cre, where = f64_dropped(prog.h_tiles, prog.h_args[2])
    faulty.h_args = (prog.h_args[0], prog.h_args[1], cre, prog.h_args[3])
    rel = rel_err(faulty.h_apply(psi), plain.h_apply(psi))
    log(f"  (d) planted fault, H without one item's coefficient {where}: H psi {rel:.2e} "
        f"relative (tol {POLISH_HPSI_RTOL:g})")
    if rel <= POLISH_HPSI_RTOL:
        raise AssertionError("f64 polish: the planted H fault passed the H psi gate")
    return dict(where, hpsi_rel=rel)


def polish_h_shapes(prog, psi):
    """--tiles: ``happly64_tiles`` on the checkpoint's state at
    F64_TILE_SHAPES, against the shipped shape's H psi."""
    from qsfh_torch.engine import kernels as K
    from qsfh_torch.engine import streaming

    log("  happly64 tile shapes, 18 qubits:")
    ref = prog.h_apply(psi)
    return f64_shapes(lambda k, c: streaming.GroupTiles(prog.hx, prog.hz, prog.n, k, c),
                      lambda t: K.happly64_tiles(psi, *prog.h_args, t, 2.0)[0],
                      2.0 * ref, rel_err, 20)


def phase_polish(dev, tmp, sweep_tiles=False):
    """The flagship's float64 endgame on the card: the committed 3x3 ADAPT
    checkpoint (1719 operators of the extended pool) loaded with the port's
    ``load_model``, lowered to the grouped float64 program
    (``qsfh_torch.native.statevec.Rot64Program``, the resident route, the
    per-group route beside it), and ``benchmarks/demo_3x3/polish_fast.py``'s
    path run on it, in complex128, gates (a)-(g) as the module docstring
    lists them."""
    import numpy as np
    import torch

    from qsfh_torch.algos.adapt import ADAPT
    from qsfh_torch.algos.adapt_fused import initial_state
    from qsfh_torch.engine import kernels as K
    from qsfh_torch.native.statevec import Rot64Program
    from qsfh_torch.ops.pool import hubbard_interaction_pool_extended

    t_phase = time.perf_counter()
    vqe = ADAPT(n_epoch=0, threshold1=1e-3, threshold2=1e-3, results_root=DEMO_ADAPT,
                pool=hubbard_interaction_pool_extended(3, 3), device=dev,
                dtype=torch.complex128, **ANALYSIS_3X3)
    ed = float(vqe.ground_state_energy)
    t0 = time.perf_counter()
    prog = Rot64Program.from_adapt(vqe)
    t1 = time.perf_counter()
    groups = Rot64Program.from_adapt(vqe, route="groups")
    plain = Rot64Program.from_adapt(vqe, impl=K.PLAIN, route="groups")
    res = dict(load_s=t0 - t_phase, lower_s=t1 - t0, ed=ed, route=prog.route)
    psi0 = initial_state(vqe)
    x0 = vqe.params_t.cpu().numpy()
    if psi0.dtype != torch.complex128 or x0.dtype != np.float64:
        raise AssertionError("f64 polish: the checkpoint did not load in float64")

    res["structure"] = polish_structure(prog)  # (a)
    runs = prog.runs
    res["layout"] = dict(k=runs.k, c=runs.c, runs=len(runs), most_groups=runs.most_groups,
                         most_entries=runs.most_entries, entries=runs.n_entries)
    log(f"  (a) {res['structure']} (load {res['load_s']:.1f} s, lowering and layout "
        f"{res['lower_s']:.2f} s); route {prog.route}: {res['layout']}")
    res["h_layout"] = dict(route=prog.h_route, k=prog.h_tiles.k, c=prog.h_tiles.c,
                           tiles=prog.h_tiles.n_tiles, items=prog.h_tiles.n_items,
                           launches=prog.h_launches())
    log(f"  H psi route {prog.h_route}: {res['h_layout']}")
    if (res["structure"] != POLISH_STRUCTURE or prog.route != "resident"
            or prog.h_route != "tiles"):
        raise AssertionError(f"f64 polish: the grouped program is not the JAX package's: "
                             f"{res['structure']} against {POLISH_STRUCTURE}, route {prog.route}")
    best = np.load(os.path.join(DEMO_ADAPT, "polish_fast_best.npz"))
    res["records"], passed = polish_records_gate(prog, x0, best, psi0, "(b) records")
    if not passed:
        raise AssertionError("f64 polish: the card's engine disagrees with the JAX package's "
                             "records")
    faulty = copy.copy(prog)  # (d) the static groups' angle 0, not 1.0
    faulty.theta_ext = torch.zeros_like(prog.theta_ext)
    res["planted_static_angle_0"], passed = polish_records_gate(
        faulty, x0, best, psi0, "(d) planted fault, static angle 0")
    if passed:
        raise AssertionError("f64 polish: the planted fault passed the record gates")

    points = {"checkpoint": x0,
              "checkpoint + 0.01 noise": x0 + 0.01 * np.random.default_rng(5).standard_normal(
                  len(x0))}
    res["kernel_checks"], res["route_checks"] = {}, {}
    for label, th in points.items():  # (c)
        res["kernel_checks"][label], psi, h, psi_p, g_p = polish_kernel_checks(
            prog, plain, th, psi0, f"(c) {label}")
        res["route_checks"][label] = polish_route_checks(prog, groups, th, psi0, psi_p, g_p,
                                                         f"(c) routes, {label}")
    faulty, where = planted_layout_fault(prog)  # (d) a run's tile misses a flip bit
    try:
        polish_kernel_checks(faulty, plain, x0, psi0, "(d) planted fault, layout")
    except AssertionError as err:
        res["planted_layout_fault"] = dict(where, failed=str(err)[:300])
    else:
        raise AssertionError("f64 polish: the planted layout fault passed the kernel gates")
    log(f"  (d) planted layout fault {where}: the kernel gates failed, as planted")

    res["h_fault"] = planted_h_fault(prog, plain, psi)  # (d) one item's coefficient dropped
    if sweep_tiles:
        res["h_tile_shapes"] = polish_h_shapes(prog, psi)
    bounds = polish_bounds(prog)  # (g), before the run so its counts are the run's own
    res["times"] = polish_times(prog, groups, plain, x0, psi0, psi, h, bounds)
    res["tile_shapes"] = polish_tile_shapes(vqe, groups, x0, psi0)
    res["run_cost"] = polish_run_cost(prog, x0, psi0)
    profile_calls((
        ("value_and_grad x 3", 3, lambda: prog.value_and_grad(x0, psi0),
         res["times"]["value_and_grad"]["host_ms"]),
        ("per-group value_and_grad x 3", 3, lambda: groups.value_and_grad(x0, psi0),
         res["times"]["value_and_grad"]["groups_host_ms"])), res, "f64 polish")
    # the resident evaluation's device time from CUDA events too: its three kernels
    # alone (torch.profiler may miss a cooperative launch: its times are floors)
    times = res["times"]
    events_ms = sum(times[k]["ms"] for k in ("rot64_resident", "happly64_tiles",
                                             "adjoint64_resident"))
    host_ms = times["value_and_grad"]["host_ms"]
    res["evaluation_split"] = dict(
        events_kernel_ms=events_ms, host_ms=host_ms, idle_share_events=1 - events_ms / host_ms,
        profiler_kernel_ms=res["profile"]["f64 polish value_and_grad x 3"]["kernel_ms"])
    log(f"  a resident evaluation: its kernels {events_ms:.4f} ms alone (CUDA events) against "
        f"{host_ms:.4f} ms on the host clock: idle share {1 - events_ms / host_ms:.3f}; the "
        f"profiler saw {res['evaluation_split']['profiler_kernel_ms']:.3f} ms")
    ref = prog.h_apply(psi)
    hx, hz = (torch.as_tensor(a.astype(np.int64), device=dev) for a in (prog.hx, prog.hz))
    c = torch.as_tensor(prog.hcre + 1j * prog.hcim, device=dev)
    lib_ms = library_sparse_apply(psi, hx, hz, c, ref)
    for name in ("happly64", "happly64_tiles"):
        res["times"][name]["library_ms"] = lib_ms
    log(f"  H psi: library (complex128 CSR torch.mv) {lib_ms} ms")

    records = [json.loads(line) for line in
               open(os.path.join(DEMO_ADAPT, "polish_fast.jsonl"))]
    ref_e = [r["E"] for r in records if r["phase"] == "lbfgs"]
    K.reset_launch_counts()  # the main path of this slice: the polish
    run = polish_run(prog, x0, psi0, ed, tmp)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    res["launches"] = counts
    evals = run["lbfgs_evals"] + run["newton_evals"] + 2 * run["newton_hvps"]
    expected = dict(rot64_resident=evals, adjoint64_resident=evals,
                    **{k: evals * v for k, v in prog.h_launches().items()})
    if any(v != expected.get(k, 0) for k, v in counts.items()):
        raise AssertionError(f"f64 polish: launches {counts} for {evals} evaluations: expected "
                             f"{expected} and no other")
    lbfgs = [e for phase, e, _ in run.pop("trace") if phase == "lbfgs"]
    diffs = [abs(a - b) for a, b in zip(lbfgs, ref_e)]
    part = next((i + 1 for i, d in enumerate(diffs) if d > POLISH_TRACE_ATOL), None)
    run.update(trace_err_1_10=max(diffs[:10]), first_parting_eval=part,
               record_best=min(ref_e), diff_to_record=run["lbfgs_best"] - min(ref_e))
    log(f"  (e) L-BFGS-B ({run['lbfgs_msg']}): {run['lbfgs_evals']} evaluations in "
        f"{run['lbfgs_s']:.2f} s ({1e3 * run['lbfgs_s'] / run['lbfgs_evals']:.2f} ms each); "
        f"evaluations 1-10 within {run['trace_err_1_10']:.2e} of polish_fast.jsonl (tol "
        f"{POLISH_TRACE_ATOL:g}); first parting by more than {POLISH_TRACE_ATOL:g} at "
        f"evaluation {part}; best E {run['lbfgs_best']:+.15f}, gap {run['lbfgs_gap_uHa']:.4f} "
        f"uHa (bound {POLISH_LBFGS_E_BOUND}); the record's {min(ref_e):+.15f}, difference "
        f"{run['diff_to_record']:+.3e}")
    accepted = [e for e in run["newton_accepted"] if e is not None]
    log(f"  (f) Newton-CG ({run['newton_msg']}): {run['newton_evals']} evaluations and "
        f"{run['newton_hvps']} HVPs in {run['newton_s']:.1f} s, {len(run['newton_accepted'])} "
        f"iterates accepted; best E {run['best_e']:+.15f}, gap to ED {run['gap_uHa']:.4f} uHa "
        f"(start {1e6 * (run['newton_start'] - ed):.4f}); best point in {run['best_path']}")
    if run["trace_err_1_10"] > POLISH_TRACE_ATOL:
        raise AssertionError("f64 polish: L-BFGS evaluations 1-10 part from polish_fast.jsonl")
    if run["lbfgs_best"] >= POLISH_LBFGS_E_BOUND or run["lbfgs_evals"] != POLISH_LBFGS_EVALS:
        raise AssertionError("f64 polish: L-BFGS did not reach the bound in 674 evaluations")
    if any(e > run["newton_start"] for e in accepted) or run["best_e"] > run["newton_start"]:
        raise AssertionError("f64 polish: Newton-CG rose above its start")
    res["run"] = run

    K.reset_launch_counts()  # the yardstick: the same L-BFGS-B on the per-group route
    run_g = polish_run(groups, x0, psi0, ed, tmp, newton=False)
    torch.cuda.synchronize()
    counts_g = K.launch_counts()
    lbfgs_g = [e for _, e, _ in run_g.pop("trace")]
    run_g.update(launches=counts_g, trace_err_1_10=max(abs(a - b) for a, b in
                                                        zip(lbfgs_g[:10], ref_e)),
                 first_parting_from_resident=next(
                     (i + 1 for i, (a, b) in enumerate(zip(lbfgs_g, lbfgs)) if a != b), None))
    n_g = run_g["lbfgs_evals"]
    log(f"  (e) per-group route, the same L-BFGS-B: {n_g} evaluations in {run_g['lbfgs_s']:.2f} "
        f"s ({1e3 * run_g['lbfgs_s'] / n_g:.2f} ms each) against the resident route's "
        f"{run['lbfgs_s']:.2f} s; best E {run_g['lbfgs_best']:+.15f}, gap "
        f"{run_g['lbfgs_gap_uHa']:.4f} uHa; evaluations 1-10 within "
        f"{run_g['trace_err_1_10']:.2e} of the record; first evaluation whose E differs from "
        f"the resident run's in any bit: {run_g['first_parting_from_resident']}")
    if (counts_g["rot64_groups"] != n_g * prog.G or counts_g["adjoint64_groups"] != n_g * prog.G
            or counts_g["rot64_resident"] or counts_g["adjoint64_resident"]
            or run_g["trace_err_1_10"] > POLISH_TRACE_ATOL):
        raise AssertionError(f"f64 polish: the per-group run's launches {counts_g} or trace")
    res["run_groups"] = run_g
    res["bounds"] = bounds
    res["seconds"] = time.perf_counter() - t_phase
    log(f"  f64 polish phase: {res['seconds']:.1f} s")
    return res


# -- main ---------------------------------------------------------------------------------


# -- the amplitude-sharded engine (qsfh_torch.parallel) -------------------------------------

# D ranks on the one card of this machine, their exchanges and rank-order
# sums over gloo, staged through the host: no NVLink or NCCL time in them
MESH_TRANSPORT = "gloo through the host, {} ranks on one H100"
MESH_RUNS = {2: ("3x3", "2x6"), 4: ("3x3",)}
MESH_CONFIGS = {"3x3": (CONFIG, N_ANSATZ, N_STEPS), "2x6": (CONFIG_24, N_ANSATZ_24, 2)}
MESH_TIMEOUT = 600
# terms that flip the sharded qubit 0 alone (x_lo = 0 at D = 2): the
# partner form's Walsh-Hadamard diagonal with a != psi
MESH_EXTRA = (("X0", 0.3), ("Y0 Z4", -0.2), ("X0 Z1 Z9", 0.15))
# the kernels each configuration's sharded path must launch on every rank;
# rank 0 holds them to their plain versions over a step and a selection from
# the trained ansatz (at 2x6 the selection's plain screens take ~13 s a call)
MESH_KERNELS = {
    "3x3": ("rotation_resident", "adjoint_resident", "pauli_apply_grouped",
            "expectation_grouped", "expectation_partner", "screen_grouped"),
    "2x6": ("rotation_tile_runs", "adjoint_tile_runs", "pauli_apply_grouped",
            "expectation_grouped", "expectation_partner", "screen_grouped"),
}
# the kernels (Impl fields) a held run compares with their plain versions:
# (field, wrapper name, leading state arguments, what it returns)
HELD = (("rotation", "pauli_rotation", 1, "state"),
        ("rotation_resident", "rotation_resident", 1, "state"),
        ("rotation_runs", "rotation_tile_runs", 1, "state"),
        ("adjoint", "adjoint_rotation", 2, "inner"),
        ("adjoint_resident", "adjoint_resident", 2, "inner"),
        ("adjoint_runs", "adjoint_tile_runs", 2, "inner"),
        ("apply", "pauli_apply", 1, "state"),
        ("apply_grouped", "pauli_apply_grouped", 1, "state"),
        ("inner", "pauli_inner", 2, "inner"),
        ("expectation_grouped", "expectation_grouped", 1, "sum"),
        ("expectation_partner", "expectation_partner", 2, "sum"),
        ("screen_grouped", "screen_grouped", 2, "screen"))


def held_impl(report):
    """The kernel wrappers, each call also run through its plain version on
    copies of the same inputs (on the card) and held to STATE_RTOL: states
    by relative error, inner products by inner_err (scale ||a|| ||psi||,
    times sum |c_t| for a folded sum, 2 max |c_t| for the screen).  Each
    wrapper's calls and largest error go into ``report``."""
    import dataclasses

    import torch

    from qsfh_torch.engine import kernels as K

    def err(got, ref, scale=0.0):
        # relative to max(||ref||, scale); absolute where both are 0 (a zero
        # shard: a basis state's other ranks)
        den = max(float(torch.linalg.vector_norm(ref)), scale)
        diff = float(torch.linalg.vector_norm(got.reshape(-1) - ref.reshape(-1).to(got.dtype)))
        return diff / den if den > 0 else diff

    def held(field, name, n_states, kind):
        kernel, plain = getattr(K.KERNELS, field), getattr(K.PLAIN, field)

        def call(*args, **kw):
            states, rest = args[:n_states], args[n_states:]
            copies = [s.clone() for s in states]
            ref = plain(*copies, *rest)
            got = kernel(*args, **kw)
            norms = [float(torch.linalg.vector_norm(s)) for s in copies]
            errs = [err(s, c) for s, c in zip(states, copies)] if kind != "sum" else []
            if kind in ("inner", "sum", "screen"):
                scale = norms[0] * (norms[1] if n_states > 1 else norms[0])
                if kind in ("sum", "screen"):
                    c = torch.complex(rest[2].double(), rest[3].double()).abs()
                    scale *= float(c.sum()) if kind == "sum" else 2.0 * float(c.max())
                if kind == "screen":
                    errs = []
                errs.append(err(got, ref, scale))
            elif kind == "state" and got is not args[0]:
                errs.append(err(got, ref))
            entry = report.setdefault(name, dict(calls=0, max_rel_err=0.0, max_abs_ref=0.0))
            entry["calls"] += 1
            entry["max_rel_err"] = max([entry["max_rel_err"]] + errs)
            if kind != "state":  # a screen of a basis state is exact, and shows as 0 error
                entry["max_abs_ref"] = max(entry["max_abs_ref"], float(ref.abs().max()))
            if entry["max_rel_err"] > STATE_RTOL:
                raise AssertionError(f"{name} disagrees with its plain version on a shard: "
                                     f"{entry['max_rel_err']:.3e}")
            return got

        return call

    return dataclasses.replace(K.KERNELS, **{f: held(f, n, s, k) for f, n, s, k in HELD})


def partner_timing(engine, problem, psi, partner):
    """The partner-form expectation (``expectation_partner``: Re sum_t c_t
    <psi_own|P_t|psi_partner>) on this rank's shard of the H's cross terms
    (x_hi = 1) and MESH_EXTRA's (x_lo = 0: the diagonal with a != psi),
    against its plain version there and on two seeded random shards (E far
    from 0): error, ms (CUDA events, a CUDA graph) on the main path's
    shards, plain ms, bound, launches a call."""
    import torch

    from qsfh_torch.engine import kernels as K
    from qsfh_torch.ops.pauli import qubit_operator
    from qsfh_torch.parallel.sharded_compiled import ShardedObservable

    op = problem.qubit_hamiltonian
    for term in MESH_EXTRA:
        op = op + qubit_operator(*term)
    part = ShardedObservable.of(engine, op).parts[1]
    xs, zs, c = part._tensors(psi)
    tiles = part.inner_groups()
    gen = torch.Generator(device=psi.device).manual_seed(17)
    dim = psi.shape[0]
    errs, values = [], []
    # the main path's shards, then two seeded random ones (E far from 0)
    for a, b in ((psi, partner), tuple(torch.randn(dim, dtype=psi.dtype, device=psi.device,
                                                   generator=gen) / dim ** 0.5
                                       for _ in range(2))):
        args = (a, b, xs, zs, c.real, c.imag, tiles)
        before = K.launch_counts()["expectation_partner"]
        got = K.expectation_partner(*args)
        launches = K.launch_counts()["expectation_partner"] - before
        ref = K.expectation_partner_plain(*args)
        scale = float(c.abs().sum()) * float(torch.linalg.vector_norm(a) *
                                             torch.linalg.vector_norm(b))
        err = abs(float(got) - float(ref))
        if err > STATE_RTOL * max(abs(float(ref)), scale):
            raise AssertionError(f"expectation_partner disagrees with its plain version: {err:.3e}")
        errs.append((err, err / max(abs(float(ref)), scale)))
        values.append((float(got), float(ref)))
    args = (psi, partner, xs, zs, c.real, c.imag, tiles)  # timed on the main path's shards
    b_ms, b_by = bound(2 * 8 * dim, inner_bound_flops(xs, False, tiles, dim))
    return dict(n_local=engine.n_local, terms=int(xs.shape[0]), x_lo_zero=int((xs == 0).sum()),
                tiles=tiles.n_tiles, n_diag=tiles.n_diag, launches_per_call=launches,
                max_abs_err=max(e[0] for e in errs), rel_err=max(e[1] for e in errs),
                values=values,
                ms=time_cuda(lambda: K.expectation_partner(*args), 20),
                graph_ms=graph_ms(lambda: K.expectation_partner(*args), 10),
                plain_ms=time_cuda(lambda: K.expectation_partner_plain(*args), 2, warmup=1),
                bound_ms=b_ms, bound_by=b_by)


def mesh_case(mesh, label, tmp):
    """One configuration on this rank: two selections from the empty
    ansatz and the sharded train steps, counted (launches, exchanges,
    bytes, staging ms, the rank's peak device memory; counters set to 0
    just before, read just after); the gradient at theta = 0.05; a held
    step and a held selection from the trained ansatz (rank 0's kernels
    against their plain versions, psi_k no basis state); the planted wrong
    partner; the partner-form timing on rank 0."""
    import torch
    import torch.distributed as dist

    from qsfh_torch.algos.adapt import ADAPT
    from qsfh_torch.engine import kernels as K
    from qsfh_torch.parallel import comm
    from qsfh_torch.parallel.sharded_compiled import adjoint_energy_grads

    config, n_ansatz, n_steps = MESH_CONFIGS[label]
    dev = mesh.device
    t0 = time.perf_counter()
    adapt = ADAPT(n_epoch=1, results_root=os.path.join(tmp, f"mesh_{label}_{mesh.size}"),
                  device=dev, mesh_devices=mesh.size, **config)
    res = dict(rank=mesh.rank, build_s=time.perf_counter() - t0)
    K.reset_launch_counts()
    comm.reset_counts()
    mem = peak_memory(dev)
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        selected, _ = adapt.select_operator()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    res.update(select_launches=K.launch_counts(), select_comm=comm.counts(),
               selected=selected, select_ms=times, select_mem=mem())
    res["pool_grads"] = adapt._screen_for(())(adapt.params_t[:0]).cpu().numpy()

    K.reset_launch_counts()
    comm.reset_counts()
    mem = peak_memory(dev)
    res["rows"] = bench_steps(adapt, dev, n_ansatz, n_steps)
    res.update(step_launches=K.launch_counts(), step_comm=comm.counts(), step_mem=mem(),
               thetas=adapt.params_t.cpu().numpy())
    indices = tuple(range(n_ansatz))
    step = adapt._build_step(indices)
    program, ham, extras = step.program, step.observable, step.extras
    res["exchanges_per_step_predicted"] = 2 * program.exchanges + len(
        set(ham.cross) | set(extras.cross))
    res["runs"] = [int(m) for m, _ in program.pieces]
    # terms a run, and the cross terms (x_hi != 0) among all: the work a
    # rank does against one card's, and the exchanges the per-term form
    # would make
    res["run_terms"] = [int(len(seg.data["xb"])) for _, seg in program.pieces]
    res["cross_terms"] = int(((program.full.data["xb"] >> program.engine.n_local) != 0).sum())

    engine = program.engine
    psi0 = engine.basis_state(adapt._occupied_modes, adapt.dtype)
    th = torch.full((n_ansatz,), 0.05, dtype=adapt._rdt, device=dev)
    res["grads"] = adjoint_energy_grads(engine, program, th, psi0, ham)[1].cpu().numpy()

    # rank 0's kernels held to their plain versions over a step, then over
    # the selection from the trained ansatz (psi_k no basis state, so the
    # screen's per-term values are sums, not single exact products)
    held = {}
    if mesh.rank == 0:
        adapt.impl = held_impl(held)
    adapt._screen_cache = {}
    bench_steps(adapt, dev, n_ansatz, 1)
    adapt.select_operator()
    adapt.impl = K.KERNELS
    res["held"] = held

    # the planted fault: the observable's exchanges with rank d ^ m ^ 1 in
    # place of d ^ m, swapped in on this engine alone
    psi = program.apply(psi0, th)
    e_ok = float(ham.expectation(psi))
    ham.engine.exchange = lambda t, m: comm.exchange(t, m ^ 1)
    try:
        e_bad = float(ham.expectation(psi))
    finally:
        del ham.engine.exchange
    res["planted"] = dict(energy=e_ok, energy_wrong_partner=e_bad)

    if mesh.size == 2:
        partner = engine.exchange(psi, 1)
        if mesh.rank == 0:
            res["partner"] = partner_timing(engine, adapt.problem, psi, partner)
    dist.barrier()
    return res


def mesh_rank(mesh, labels, tmp):
    """One rank of phase_mesh: each configuration of ``labels`` in turn."""
    return {label: mesh_case(mesh, label, tmp) for label in labels}


def peak_memory(dev):
    """Starts a reading of the process's peak device memory: returns a
    function giving (MiB allocated at the start, MiB at the peak since)."""
    import torch

    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    return lambda: (base / 2**20, torch.cuda.max_memory_allocated(dev) / 2**20)


def mesh_reference(adapt, n_ansatz, n_steps, dev):
    """The single-card path on the same configuration: the selection and
    pool gradients from the empty ansatz, the adjoint gradient at theta =
    0.05 and ``n_steps`` train steps from there (bench_steps), with the
    peak device memory of the selection and of the steps."""
    import torch

    adapt.selected_indices, adapt.params_t = [], adapt.params_t[:0]
    adapt._screen_cache = {}
    mem = peak_memory(dev)
    selected, _ = adapt.select_operator()
    select_mem = mem()
    pool_grads = empty_ansatz_gradients(adapt)
    raw = adapt._build_stages(tuple(range(n_ansatz)))
    th = torch.full((n_ansatz,), 0.05, dtype=adapt._rdt, device=dev)
    psi = raw["fwd_from"](adapt._initial_state(), th)
    grads = raw["adjoint"](psi, raw["cotangent"](psi), th).cpu().numpy()
    del psi, raw
    mem = peak_memory(dev)
    rows = bench_steps(adapt, dev, n_ansatz, n_steps)
    return dict(selected=selected, pool_grads=pool_grads, grads=grads, rows=rows,
                select_mem=select_mem, step_mem=mem())


def mesh_gates(label, ranks, ref, up, down):
    """The gates of one configuration on D ranks against the single-card
    reference; returns its summary."""
    import numpy as np

    d = len(ranks)
    r0 = ranks[0]
    tol = STEP_TOLERANCES if label == "3x3" else STEP_TOLERANCES_24
    for r in ranks:
        check_steps(r["rows"], up, down, f"{label} D={d} rank {r['rank']}",
                    e_floor=E_EXACT if label == "3x3" else None)
        compare_steps(r["rows"], ref["rows"], tol)
        check_selection(r["pool_grads"], ref["pool_grads"], r["selected"], ref["selected"])
        g_tol = GRAD_RTOL * float(np.abs(ref["grads"]).max())
        g_err = float(np.abs(r["grads"] - ref["grads"]).max())
        if g_err > g_tol:
            raise AssertionError(f"{label} D={d}: gradients {g_err:.3e} from the single card")
        for key in ("thetas", "grads", "pool_grads"):
            if not np.array_equal(r[key], r0[key]):
                raise AssertionError(f"{label} D={d}: rank {r['rank']}'s {key} differ from rank "
                                     f"0's bits")
        for name in MESH_KERNELS[label]:
            if r["step_launches"][name] + r["select_launches"][name] == 0:
                raise AssertionError(f"{label} D={d}: {name} never launched on rank {r['rank']}")
        n_steps = len(r["rows"])
        if r["step_comm"]["exchanges"] != n_steps * r["exchanges_per_step_predicted"]:
            raise AssertionError(f"{label} D={d}: {r['step_comm']['exchanges']} exchanges in "
                                 f"{n_steps} steps, the runs predict "
                                 f"{r['exchanges_per_step_predicted']} a step")
        e_ok, e_bad = r["planted"]["energy"], r["planted"]["energy_wrong_partner"]
        if abs(e_bad - e_ok) <= tol[0][1] * abs(e_ok):
            raise AssertionError(f"{label} D={d}: the wrong partner passes the energy gate")
    held = r0["held"]
    for name in MESH_KERNELS[label]:
        if name not in held:
            raise AssertionError(f"{label} D={d}: {name} was not held on rank 0's shard")
    n_steps = len(r0["rows"])
    per_step = {k: v / n_steps for k, v in r0["step_comm"].items()}
    summary = dict(
        transport=MESH_TRANSPORT.format(d), ranks=d,
        step_ms=median_ms(r0["rows"]) if n_steps > 2 else r0["rows"][-1]["ms"],
        step_ms_by_rank=[[row["ms"] for row in r["rows"]] for r in ranks],
        single_card_step_ms=median_ms(ref["rows"]) if n_steps > 2 else ref["rows"][-1]["ms"],
        select_ms=r0["select_ms"][-1], exchanges_per_step=per_step["exchanges"],
        exchange_bytes_per_step=per_step["exchange_bytes"],
        sum_bytes_per_step=per_step["sum_bytes"], sums_per_step=per_step["sums"],
        staging_ms_per_step=per_step["staging_ms"],
        exchanges_per_selection=r0["select_comm"]["exchanges"] / 2,
        staging_ms_per_selection=r0["select_comm"]["staging_ms"] / 2,
        launches_per_step={k: v / n_steps for k, v in r0["step_launches"].items() if v},
        launches_per_selection={k: v / 2 for k, v in r0["select_launches"].items() if v},
        launches={k: [r["step_launches"][k] + r["select_launches"][k] for r in ranks]
                  for k in r0["step_launches"]},
        runs=r0["runs"], run_terms=r0["run_terms"], cross_terms=r0["cross_terms"],
        work_share=(sum(t * (2 if m else 1) for m, t in zip(r0["runs"], r0["run_terms"]))
                    / (d * sum(r0["run_terms"]))),
        held=held, planted=r0["planted"], build_s=r0["build_s"],
        partner=r0.get("partner"),
        memory_mib=dict(
            note="(allocated at the start, peak) of each process: a rank's, the single card's",
            step=[r["step_mem"] for r in ranks], step_single_card=ref["step_mem"],
            selection=[r["select_mem"] for r in ranks],
            selection_single_card=ref["select_mem"]),
        max_grad_err=max(float(np.abs(r["grads"] - ref["grads"]).max()) for r in ranks),
        selected=r0["selected"])
    log(f"  [{label} D={d}] {summary['transport']}: step {summary['step_ms']:.2f} ms "
        f"(single card {summary['single_card_step_ms']:.2f}), selection "
        f"{summary['select_ms']:.1f} ms; per step {per_step['exchanges']:g} exchanges, "
        f"{per_step['exchange_bytes'] / 2**20:.2f} MiB sent, {per_step['sums']:g} rank-order sums, "
        f"staging {per_step['staging_ms']:.2f} ms; runs {summary['runs']} of "
        f"{summary['run_terms']} terms ({summary['cross_terms']} cross): a rank's rotation work "
        f"{summary['work_share']:.4f} of one card's")
    log(f"  [{label} D={d}] launches per step per rank {summary['launches_per_step']}, per "
        f"selection {summary['launches_per_selection']}")
    log(f"  [{label} D={d}] held on rank 0's shard: " + ", ".join(
        f"{k} {v['calls']} calls {v['max_rel_err']:.1e}" for k, v in held.items())
        + f" (the screen's largest plain value {held['screen_grouped']['max_abs_ref']:.3e})")
    mem = summary["memory_mib"]
    log(f"  [{label} D={d}] device MiB (allocated at the start, peak) a step: ranks "
        + ", ".join(f"({a:.1f}, {p:.1f})" for a, p in mem["step"])
        + f", single card ({mem['step_single_card'][0]:.1f}, {mem['step_single_card'][1]:.1f}); "
        f"a selection: ranks " + ", ".join(f"({a:.1f}, {p:.1f})" for a, p in mem["selection"])
        + f", single card ({mem['selection_single_card'][0]:.1f}, "
        f"{mem['selection_single_card'][1]:.1f})")
    log(f"  [{label} D={d}] planted wrong partner: E {e_bad:.7f} against {e_ok:.7f} (fails the "
        f"gate); thetas, gradients and pool gradients the same bits on every rank; gradients "
        f"within {summary['max_grad_err']:.2e} of the single card")
    if summary["partner"]:
        p = summary["partner"]
        log(f"  [{label} D={d}] expectation_partner at {p['n_local']} local qubits: {p['terms']} "
            f"terms ({p['x_lo_zero']} with x_lo = 0, {p['n_diag']} diagonal), {p['tiles']} tiles, "
            f"{p['launches_per_call']} launches a call; kernel / plain E "
            + ", ".join(f"{g:.7g} / {r:.7g}" for g, r in p["values"])
            + f" (main-path shards, seeded random ones); rel_err {p['rel_err']:.2e}, "
            f"ms {p['ms']:.4f} (graph {p['graph_ms']:.4f}), plain {p['plain_ms']:.3f}, bound "
            f"{p['bound_ms']:.5f} ({p['bound_by']})")
        if not p["x_lo_zero"]:
            raise AssertionError("no cross term with x_lo = 0 in the partner-form check")
    return summary


def phase_mesh(adapt, adapt24, dev, tmp):
    """ADAPT(mesh_devices=D) at 3x3 (D = 2, 4) and 2x6 (D = 2) through the
    Hopper kernels, the ranks on this one card over gloo, against the
    single-card path (mesh_reference)."""
    from qsfh_torch.parallel import spawn_ranks

    refs = {"3x3": mesh_reference(adapt, N_ANSATZ, N_STEPS, dev),
            "2x6": mesh_reference(adapt24, N_ANSATZ_24, 2, dev)}
    spins = {"3x3": (CONFIG["n_spin_up"], CONFIG["n_spin_down"]),
             "2x6": (CONFIG_24["n_spin_up"], CONFIG_24["n_spin_down"])}
    out = {}
    for d, labels in MESH_RUNS.items():
        t0 = time.perf_counter()
        ranks = spawn_ranks(mesh_rank, d, backend="gloo", device="cuda", timeout=MESH_TIMEOUT,
                            args=(labels, tmp))
        log(f"  {d} ranks ({', '.join(labels)}): {time.perf_counter() - t0:.1f} s")
        for label in labels:
            out[f"{label}_D{d}"] = mesh_gates(label, [r[label] for r in ranks], refs[label],
                                              *spins[label])
    return out


# -- the sharded evolution, spectroscopy and start axis (phase_mesh_evolution) --------

MESH_EVOLUTION_RUNS = {2: ("trotter_3x3", "trotter_2x6", "ite", "lanczos", "multistart"),
                       4: ("trotter_3x3", "multistart")}
TROTTER_3X3 = (3, 3, 1.0, 4.0, 9, 5, 4)  # benchmarks/tpu_dynamics.py's quench
TROTTER_2X6 = (2, 6, 1.0, 4.0, 12, 6, 6)
TROTTER_2X6_STEPS = 3
ITE_3X3 = (3, 3, 1.0, 6.0, 9, 5, 4)  # benchmarks/tpu_ite.py
LANCZOS_3X3 = (3, 3, 1.0, 6.0, 9, 5, 4)  # spectral_3x3.py, on the ED cache's manifold[0]
MESH_ITE_STEPS = 50
MS_PLANTED_EPOCHS = 2
# the kernels each case must launch on every rank
EVOLUTION_KERNELS = {
    "trotter_3x3": ("rotation_resident", "expectation_grouped", "expectation_partner"),
    "trotter_2x6": ("rotation_tile_runs", "expectation_grouped", "expectation_partner"),
    "ite": ("pauli_apply_grouped",),
    "lanczos": ("pauli_apply_grouped",),
    "multistart": ("rotation_resident", "adjoint_resident", "expectation_grouped"),
}


def sharded_rotation_launches(program):
    """The rotation launches one pass of a ShardedRotations program makes:
    per piece (its local runs on n_local qubits, a pair run on n_local + 1)
    one resident launch a span up to the chain cap, one tile-run launch a
    run above it, one per-term launch a term that fits no tile."""
    from qsfh_torch.engine.compiled import _tile_route

    out = dict(rotation_resident=0, rotation_tile_runs=0, pauli_rotation=0)
    for m, seg in program.pieces:
        layout, resident = _tile_route(seg, 1, program.engine.n_local + (1 if m else 0))
        for tiles, t0, t1 in layout.spans:
            if tiles is None:
                out["pauli_rotation"] += t1 - t0
            elif resident:
                out["rotation_resident"] += 1
            else:
                out["rotation_tile_runs"] += len(tiles)
    return out


def trotter_setup(cfg, dev, mesh=None):
    """(evolution, observables UD and H, the Neel start) of the quench."""
    import torch

    from qsfh_torch.algos.base import HubbardProblem
    from qsfh_torch.algos.dynamics import TrotterEvolution, neel_occupied
    from qsfh_torch.engine.expectation import Observable
    from qsfh_torch.engine.state import basis_state
    from qsfh_torch.ops.jw import jordan_wigner

    p = HubbardProblem(*cfg)
    ev = TrotterEvolution(p, dt=0.05, order=2, device=dev, mesh=mesh)
    obs = {"UD": Observable(jordan_wigner(p.interacting_term), p.n_qubits),
           "H": p.observables["H"]}
    psi0 = basis_state(p.n_qubits, neel_occupied(cfg[0], cfg[1]), dtype=torch.complex64,
                       device=dev)
    return ev, obs, psi0


def counted(fn, dev):
    """(fn(), ms on the host clock, kernel launches, collectives, (MiB
    allocated at the start, peak MiB)): the counters set to 0 just before,
    read just after."""
    import torch

    from qsfh_torch.engine import kernels as K
    from qsfh_torch.parallel import comm

    K.reset_launch_counts()
    comm.reset_counts()
    mem = peak_memory(dev)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    ms = 1e3 * (time.perf_counter() - t0)
    return out, ms, {k: v for k, v in K.launch_counts().items() if v}, comm.counts(), mem()


def evolution_trotter(mesh, label, n_steps):
    """The quench on the shards: a warm-up step, then ``n_steps`` recorded
    steps counted; at D = 2 on 3x3 also the planted wrong partner (every
    exchange of the evolution with rank d ^ m ^ 1)."""
    from qsfh_torch.parallel import comm
    from qsfh_torch.parallel.mesh import gather_statevector

    cfg = TROTTER_3X3 if label == "trotter_3x3" else TROTTER_2X6
    ev, obs, psi0 = trotter_setup(cfg, mesh.device, mesh)
    ev.evolve(psi0, 1, obs)  # first use: layouts and tables
    (psi, rec), ms, launches, comms, mem = counted(lambda: ev.evolve(psi0, n_steps, obs),
                                                   mesh.device)
    prog = ev.program
    res = dict(records={k: v.tolist() for k, v in rec.items()}, ms_per_step=ms / n_steps,
               launches=launches, comm=comms, memory_mib=mem, runs=[int(m) for m, _ in prog.pieces],
               run_terms=[int(len(seg.data["xb"])) for _, seg in prog.pieces],
               pair_runs=prog.exchanges, rotation_expected=sharded_rotation_launches(prog),
               cross=sorted({m for o in obs.values() for m in ev.sharded(o).cross}))
    if label == "trotter_3x3":
        res["state"] = gather_statevector(psi, mesh).cpu().numpy()
    else:
        res["shard"] = psi.cpu().numpy()
    if label == "trotter_3x3" and mesh.size == 2:
        ev.engine.exchange_into = lambda ts, outs, m: comm.exchange_into(ts, outs, m ^ 1)
        try:
            _, bad = ev.evolve(psi0, n_steps, obs)
        finally:
            del ev.engine.exchange_into
        res["planted_ud"] = bad["UD"].tolist()
    return res


def evolution_ite(mesh, v):
    """ITE from the seed-19 state on the shards: 4 steps counted against the
    layouts, then MESH_ITE_STEPS timed."""
    from qsfh_torch.algos.base import HubbardProblem
    from qsfh_torch.algos.ite import ImaginaryTimeEvolution

    ite = ImaginaryTimeEvolution(HubbardProblem(*ITE_3X3), dbeta=0.01, order=2, mesh=mesh)
    (_, rec), _, launches, comms, _ = counted(lambda: ite.run(v, n_steps=4, block=4),
                                              mesh.device)
    (_, long), ms, _, _, mem = counted(lambda: ite.run(v, n_steps=MESH_ITE_STEPS,
                                                       block=MESH_ITE_STEPS), mesh.device)
    tiles = {int(m): part.groups().n_tiles for m, part in ite.sharded_h.parts.items()}
    return dict(energies=rec["energies"].tolist(), variances=rec["variances"].tolist(),
                launches=launches, comm=comms, tiles=tiles, order=ite.order,
                ms_per_step=ms / MESH_ITE_STEPS, memory_mib=mem,
                final_energy=float(long["energies"][-1]))


def evolution_lanczos(mesh):
    """spectral_3x3.py's k = (0, 0) seeds, both branches, m = SPECTRAL_M on the
    shards: the driver's poles and weights (counted), and the recursion's
    coefficients from the same seed (for A(omega) of the first levels)."""
    import numpy as np
    import torch

    from qsfh_torch.algos.base import HubbardProblem
    from qsfh_torch.algos.dynamics import excitation_operator
    from qsfh_torch.linalg.spectral import lanczos_tridiagonal, spectral_function_lanczos
    from qsfh_torch.ops.jw import jordan_wigner
    from qsfh_torch.parallel.mesh import shard_input
    from qsfh_torch.parallel.sharded_compiled import ShardedObservable
    from qsfh_torch.parallel.shmap_engine import ShardedPauliEngine

    p = HubbardProblem(*LANCZOS_3X3, results_root=DEMO_ADAPT)
    e0, manifold = p.ground_state(degenerate=True, n_states=4)
    gs, e0 = np.asarray(manifold[0]), float(e0)
    omegas = np.linspace(*SPECTRAL_OMEGAS)
    engine = ShardedPauliEngine(p.n_qubits, mesh)
    ham = ShardedObservable.of(engine, p.qubit_hamiltonian)
    out = {}
    for branch, dagger in (("particle", True), ("hole", False)):
        op = k_ladder(0, 0, dagger)
        res, ms, launches, comms, _ = counted(lambda: spectral_function_lanczos(
            p, gs, e0, op, m=SPECTRAL_M, omegas=omegas, mesh=mesh), mesh.device)
        phi = ShardedObservable.of(engine, jordan_wigner(excitation_operator(op))).apply(
            shard_input(gs, mesh, p.n_qubits, torch.complex64))
        coeffs = lanczos_tridiagonal(ham.apply, phi, SPECTRAL_M, mesh=mesh)
        out[branch] = dict(poles=res["poles"], weights=res["weights"], A=res["A"],
                           norm2=res["norm2"], coeffs=coeffs, ms=ms, launches=launches,
                           comm=comms, tiles={int(m): part.groups().n_tiles
                                              for m, part in ham.parts.items()})
    return out


def evolution_multistart(mesh, tmp):
    """MultistartHVA(mesh_devices=D) at 3x3 reps = 10, B = 4: a warm-up epoch,
    the run counted; at D = 2 the planted fault: rank 1's starts shifted by
    one row."""
    import functools

    import torch

    from qsfh_torch.algos import multistart as M

    ms = M.MultistartHVA(results_root=os.path.join(tmp, f"ms_mesh_{mesh.size}"),
                         device=mesh.device, mesh_devices=mesh.size, **MS_3X3)
    M.batched_train(ms.loss, ms.batch_params, functools.partial(torch.optim.Adam, lr=ms.lr), 1,
                    mesh=ms.mesh)
    out, run_ms, launches, comms, mem = counted(ms.run, mesh.device)
    res = dict(energies=out["energies"], final_energies=out["final_energies"],
               best_index=out["best_index"], best_params=out["best_params"],
               run_ms=run_ms, ms_per_epoch=run_ms / ms.n_epoch, launches=launches, comm=comms,
               memory_mib=mem, rows=[M.rank_rows(ms.n_starts, ms.mesh).start,
                                     M.rank_rows(ms.n_starts, ms.mesh).stop])
    if mesh.size == 2:
        original = M.rank_rows
        if mesh.rank == 1:
            M.rank_rows = lambda n, m: slice(original(n, m).start - 1, original(n, m).stop - 1)
        try:
            ms.n_epoch = MS_PLANTED_EPOCHS
            res["planted_energies"] = ms.run()["energies"]
        finally:
            M.rank_rows = original
    return res


def mesh_evolution_rank(mesh, tmp, ite_v):
    """One rank of phase_mesh_evolution: each case of MESH_EVOLUTION_RUNS."""
    import torch.distributed as dist

    cases = MESH_EVOLUTION_RUNS[mesh.size]
    out = dict(rank=mesh.rank, seconds={})
    for case in cases:
        t0 = time.perf_counter()
        if case == "trotter_3x3":
            out[case] = evolution_trotter(mesh, case, DYN_STEPS)
        elif case == "trotter_2x6":
            out[case] = evolution_trotter(mesh, case, TROTTER_2X6_STEPS)
        elif case == "ite":
            out[case] = evolution_ite(mesh, ite_v)
        elif case == "lanczos":
            out[case] = evolution_lanczos(mesh)
        else:
            out[case] = evolution_multistart(mesh, tmp)
        out["seconds"][case] = time.perf_counter() - t0
        dist.barrier()
    return out


def seed_phi(p, gs, op, dev):
    """|phi> = op |gs> on the host in complex128, then on the card."""
    import torch

    from qsfh_torch.algos.dynamics import apply_on_host, excitation_operator
    from qsfh_torch.engine.expectation import Observable
    from qsfh_torch.ops.jw import jordan_wigner

    lad = Observable(jordan_wigner(excitation_operator(op)), p.n_qubits)
    return torch.from_numpy(apply_on_host(lad, gs)).to(dev)


def mesh_evolution_reference(dev, tmp, ite_v):
    """The single-card runs of the phase's inputs, in the same call: the two
    quenches, ITE, the two Lanczos seeds (the kernel route and the complex128
    plain recursion) and the 3x3 multistart."""
    import functools

    import numpy as np
    import torch

    from qsfh_torch.algos.base import HubbardProblem
    from qsfh_torch.algos.ite import ImaginaryTimeEvolution
    from qsfh_torch.algos.multistart import MultistartHVA, batched_train
    from qsfh_torch.engine import kernels as K
    from qsfh_torch.linalg.spectral import lanczos_tridiagonal, spectral_function_lanczos

    ref = {}
    for label, cfg, n_steps in (("trotter_3x3", TROTTER_3X3, DYN_STEPS),
                                ("trotter_2x6", TROTTER_2X6, TROTTER_2X6_STEPS)):
        ev, obs, psi0 = trotter_setup(cfg, dev)
        ev.evolve(psi0, 1, obs)
        (psi, rec), ms, launches, _, mem = counted(lambda: ev.evolve(psi0, n_steps, obs), dev)
        ref[label] = dict(records=rec, state=psi.cpu().numpy(), ms_per_step=ms / n_steps,
                          launches=launches, memory_mib=mem)
        del psi, ev, psi0
    ite = ImaginaryTimeEvolution(HubbardProblem(*ITE_3X3), dbeta=0.01, order=2, device=dev)
    (_, rec), _, launches, _, _ = counted(lambda: ite.run(ite_v, n_steps=4, block=4), dev)
    _, ms, _, _, mem = counted(lambda: ite.run(ite_v, n_steps=MESH_ITE_STEPS,
                                               block=MESH_ITE_STEPS), dev)
    ref["ite"] = dict(energies=rec["energies"], variances=rec["variances"], launches=launches,
                      ms_per_step=ms / MESH_ITE_STEPS, memory_mib=mem)
    p = HubbardProblem(*LANCZOS_3X3, results_root=DEMO_ADAPT)
    e0, manifold = p.ground_state(degenerate=True, n_states=4)
    gs, e0 = np.asarray(manifold[0]), float(e0)
    ham = p.observables["H"]
    ref["lanczos"] = {}
    for branch, dagger in (("particle", True), ("hole", False)):
        op = k_ladder(0, 0, dagger)
        res, ms, launches, _, _ = counted(lambda: spectral_function_lanczos(
            p, gs, e0, op, m=SPECTRAL_M, omegas=np.linspace(*SPECTRAL_OMEGAS), device=dev), dev)
        phi = seed_phi(p, gs, op, dev)
        ref["lanczos"][branch] = dict(
            poles=res["poles"], weights=res["weights"], ms=ms, launches=launches, e0=e0,
            plain128=lanczos_tridiagonal(lambda v: ham.apply_auto(v, K.PLAIN), phi, SPECTRAL_M),
            coeffs=lanczos_tridiagonal(ham.apply_auto, phi.to(torch.complex64), SPECTRAL_M))
    ms = MultistartHVA(results_root=os.path.join(tmp, "ms_mesh_ref"), device=dev, **MS_3X3)
    batched_train(ms.loss, ms.batch_params, functools.partial(torch.optim.Adam, lr=ms.lr), 1)
    out, run_ms, launches, _, mem = counted(ms.run, dev)
    ref["multistart"] = dict(out, run_ms=run_ms, ms_per_epoch=run_ms / ms.n_epoch,
                             launches=launches, memory_mib=mem)
    return ref


def _rel(a, b, floor=0.0):
    """max |a - b| over max(max |b|, floor)."""
    import numpy as np

    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), floor))


def _state_rel(got, ref):
    import numpy as np

    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _same_bits(ranks, case, *keys):
    """Raises unless every rank's ``case`` entries at the dotted ``keys``
    (arrays, lists, tuples of arrays, dicts of them) are rank 0's bits."""
    import numpy as np

    def same(a, b):
        if isinstance(a, dict):
            return sorted(a) == sorted(b) and all(same(a[k], b[k]) for k in a)
        if isinstance(a, (tuple, list)) and a and not np.isscalar(a[0]):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        return np.array_equal(np.asarray(a), np.asarray(b))

    for r in ranks[1:]:
        for key in keys:
            a, b = ranks[0][case], r[case]
            for k in key.split("."):
                a, b = a[k], b[k]
            if not same(a, b):
                raise AssertionError(f"{case}: rank {r['rank']}'s {key} differ from rank 0's bits")


def _need(launches, names, label):
    missing = [k for k in names if not launches.get(k)]
    if missing:
        raise AssertionError(f"{label}: {missing} never launched")


def _per_step(comm_counts, n):
    return {k: v / n for k, v in comm_counts.items()}


def evolution_trotter_gates(label, ranks, ref, n_steps, trace):
    """The quench's gates on D ranks: the records against the single card
    (and, at 3x3, the committed trace), the final state, the same record
    bits on every rank, the launches against the runs, the collectives a
    step; at 3x3 D = 2 the planted wrong partner must move UD."""
    import numpy as np

    d = len(ranks)
    r0 = ranks[0][label]
    if label == "trotter_3x3":
        states = [r[label]["state"] for r in ranks]
        _same_bits(ranks, label, "state")
        state = states[0]
    else:
        state = np.concatenate([r[label]["shard"] for r in ranks])
    summary = dict(ranks=d, transport=MESH_TRANSPORT.format(d), n_steps=n_steps,
                   state_rel=_state_rel(state, ref["state"]))
    # <H> of the Neel quench stays near its start, far below 1: relative to
    # max(|<H>|, 1), the Hamiltonian's energy scale
    errs = {k: _rel(r0["records"][k], ref["records"][k], 1.0) for k in ("UD", "H")}
    summary["records_rel"] = errs
    if trace is not None:
        summary["ud_trace_rel"] = _rel(r0["records"]["UD"], trace["energies"])
    _same_bits(ranks, label, "records")
    expected = r0["rotation_expected"]
    for r in ranks:
        rr = r[label]
        for name in ("rotation_resident", "rotation_tile_runs", "pauli_rotation"):
            if rr["launches"].get(name, 0) != n_steps * expected[name]:
                raise AssertionError(f"{label} D={d} rank {r['rank']}: {name} "
                                     f"{rr['launches'].get(name, 0)} launches in {n_steps} steps, "
                                     f"the runs predict {expected[name]} a step")
        _need(rr["launches"], EVOLUTION_KERNELS[label], f"{label} D={d} rank {r['rank']}")
        want = n_steps * (rr["pair_runs"] + len(rr["cross"]))
        if rr["comm"]["exchanges"] != want or rr["comm"]["sums"] != n_steps:
            raise AssertionError(f"{label} D={d} rank {r['rank']}: {rr['comm']['exchanges']} "
                                 f"exchanges and {rr['comm']['sums']} sums in {n_steps} steps, "
                                 f"predicted {want} and {n_steps}")
    if expected["pauli_rotation"]:
        raise AssertionError(f"{label} D={d}: terms that fit no tile")
    if max(errs.values()) > 10 * STATE_RTOL or summary["state_rel"] > 10 * STATE_RTOL or \
            summary.get("ud_trace_rel", 0.0) > TRACE_RTOL:
        raise AssertionError(f"{label} D={d}: the sharded quench disagrees: {summary}")
    summary.update(
        ms_per_step=[r[label]["ms_per_step"] for r in ranks],
        single_card_ms_per_step=ref["ms_per_step"], runs=r0["runs"], run_terms=r0["run_terms"],
        pair_runs=r0["pair_runs"], cross=r0["cross"],
        launches_per_step={k: v / n_steps for k, v in r0["launches"].items()},
        single_card_launches_per_step={k: v / n_steps for k, v in ref["launches"].items()},
        comm_per_step=_per_step(r0["comm"], n_steps),
        memory_mib=dict(note="(allocated at the start, peak) of each process",
                        ranks=[r[label]["memory_mib"] for r in ranks],
                        single_card=ref["memory_mib"]),
        launches={k: [r[label]["launches"].get(k, 0) for r in ranks]
                  for k in set().union(*(r[label]["launches"] for r in ranks))})
    if "planted_ud" in r0:
        summary["planted_ud_trace_rel"] = _rel(r0["planted_ud"], trace["energies"])
        if summary["planted_ud_trace_rel"] <= TRACE_RTOL:
            raise AssertionError(f"{label} D={d}: the wrong partner passes the UD gate")
    c = summary["comm_per_step"]
    log(f"  [{label} D={d}] {summary['transport']}: {n_steps} steps, "
        + ", ".join(f"{ms:.2f}" for ms in summary["ms_per_step"])
        + f" ms a recorded step by rank (single card {ref['ms_per_step']:.3f}); records within "
        + ", ".join(f"{k} {v:.1e}" for k, v in errs.items())
        + f" and the state within {summary['state_rel']:.1e} of the single card"
        + (f", UD within {summary['ud_trace_rel']:.1e} of the trace" if trace is not None else "")
        + f"; runs {r0['runs']} of {r0['run_terms']} terms; per step {c['exchanges']:g} "
        f"exchanges ({c['exchange_bytes'] / 2**20:.2f} MiB sent), {c['sums']:g} sums, staging "
        f"{c['staging_ms']:.2f} ms; launches a step " + ", ".join(
            f"{k} {v:g}" for k, v in summary["launches_per_step"].items()))
    mem = summary["memory_mib"]
    log(f"  [{label} D={d}] device MiB (allocated at the start, peak): ranks "
        + ", ".join(f"({a:.1f}, {b:.1f})" for a, b in mem["ranks"])
        + f", single card ({mem['single_card'][0]:.1f}, {mem['single_card'][1]:.1f})"
        + (f"; planted wrong partner: UD {summary['planted_ud_trace_rel']:.2e} from the trace "
           f"(fails the gate)" if "planted_ud_trace_rel" in summary else ""))
    return summary


def evolution_ite_gates(ranks, ref, trace):
    import numpy as np

    d = len(ranks)
    r0 = ranks[0]["ite"]
    _same_bits(ranks, "ite", "energies", "variances")
    s = dict(ranks=d, transport=MESH_TRANSPORT.format(d),
             energy_trace_rel=_rel(r0["energies"], trace["energies"]),
             variance_trace_rel=_rel(r0["variances"], trace["variances"]),
             energy_rel=_rel(r0["energies"], ref["energies"]),
             variance_rel=_rel(r0["variances"], ref["variances"]))
    tiles = sum(r0["tiles"].values())
    for r in ranks:
        ri = r["ite"]
        want = 4 * ri["order"] * tiles
        if ri["launches"].get("pauli_apply_grouped") != want:
            raise AssertionError(f"ite D={d} rank {r['rank']}: "
                                 f"{ri['launches'].get('pauli_apply_grouped')} "
                                 f"pauli_apply_grouped launches in 4 steps, the layouts predict "
                                 f"{want}")
        cross = len([m for m in ri["tiles"] if m])
        if ri["comm"]["sums"] != 8 or ri["comm"]["exchanges"] != 4 * ri["order"] * cross:
            raise AssertionError(f"ite D={d}: collectives {ri['comm']}")
    if max(s["energy_trace_rel"], s["variance_trace_rel"]) > TRACE_RTOL or \
            max(s["energy_rel"], s["variance_rel"]) > 10 * STATE_RTOL:
        raise AssertionError(f"ite D={d}: the sharded ITE disagrees: {s}")
    s.update(ms_per_step=[r["ite"]["ms_per_step"] for r in ranks],
             single_card_ms_per_step=ref["ms_per_step"], tiles=r0["tiles"],
             launches_per_step={k: v / 4 for k, v in r0["launches"].items()},
             comm_per_step=_per_step(r0["comm"], 4),
             memory_mib=dict(ranks=[r["ite"]["memory_mib"] for r in ranks],
                             single_card=ref["memory_mib"]),
             final_energy=r0["final_energy"],
             launches={k: [r["ite"]["launches"].get(k, 0) for r in ranks]
                       for k in r0["launches"]})
    c = s["comm_per_step"]
    log(f"  [ite D={d}] energies within {s['energy_trace_rel']:.1e} and variances within "
        f"{s['variance_trace_rel']:.1e} of the trace (single card {s['energy_rel']:.1e}, "
        f"{s['variance_rel']:.1e}); {MESH_ITE_STEPS} steps: "
        + ", ".join(f"{ms:.3f}" for ms in s["ms_per_step"])
        + f" ms a step by rank (single card {ref['ms_per_step']:.3f}); per step "
        f"{c['exchanges']:g} exchanges, {c['sums']:g} sums, staging {c['staging_ms']:.2f} ms; "
        f"pauli_apply_grouped {s['launches_per_step'].get('pauli_apply_grouped', 0):g} a step "
        f"(tiles by x_hi {r0['tiles']})")
    return s


def evolution_lanczos_gates(ranks, ref, committed):
    d = len(ranks)
    omegas = __import__("numpy").linspace(*SPECTRAL_OMEGAS)
    out = dict(ranks=d, transport=MESH_TRANSPORT.format(d))
    for branch in ("particle", "hole"):
        _same_bits(ranks, "lanczos", *(f"{branch}.{k}" for k in ("poles", "weights", "A",
                                                                "coeffs")))
        got, want = ranks[0]["lanczos"][branch], ref["lanczos"][branch]
        e0 = want["e0"]
        lv = SPECTRAL_A_LEVELS
        plain = broadened(want["plain128"][0][:lv], want["plain128"][1][:lv], want["plain128"][2],
                          e0, omegas, 0.05)
        single = broadened(want["coeffs"][0][:lv], want["coeffs"][1][:lv], want["coeffs"][2], e0,
                           omegas, 0.05)
        mine = broadened(got["coeffs"][0][:lv], got["coeffs"][1][:lv], got["coeffs"][2], e0,
                         omegas, 0.05)
        edge = band_edge(main_poles(got))
        row = dict(a_err=float(abs(mine - plain).max() / plain.max()),
                   a_err_single_card=float(abs(mine - single).max() / single.max()),
                   edge=edge, edge_err=abs(edge - band_edge(
                       committed["bands"]["(0,0)"][branch]["main_poles"])),
                   single_card_edge=band_edge(main_poles(want)), ms=got["ms"],
                   single_card_ms=want["ms"], launches=got["launches"],
                   single_card_launches=want["launches"], comm=got["comm"], tiles=got["tiles"])
        _need(got["launches"], EVOLUTION_KERNELS["lanczos"], f"lanczos {branch}")
        floor = SPECTRAL_M * sum(got["tiles"].values())
        if got["launches"].get("pauli_apply_grouped", 0) < floor:
            raise AssertionError(f"lanczos {branch}: fewer H psi launches than {floor}")
        if row["a_err"] > SPECTRAL_A_RTOL or row["edge_err"] > SPECTRAL_POLE_ATOL:
            raise AssertionError(f"lanczos D={d} {branch}: {row}")
        out[branch] = row
        log(f"  [lanczos D={d} {branch}] A(omega) of the first {lv} levels within "
            f"{row['a_err']:.2e} of the complex128 plain Lanczos (tol {SPECTRAL_A_RTOL:g}; the "
            f"single card {row['a_err_single_card']:.2e}); band edge {edge:.5f}, "
            f"{row['edge_err']:.1e} from spectral.json (tol {SPECTRAL_POLE_ATOL:g}); "
            f"{row['ms']:.1f} ms a run of {SPECTRAL_M} (single card {row['single_card_ms']:.1f}); "
            f"{row['comm']['exchanges']} exchanges and {row['comm']['sums']} sums; launches "
            + ", ".join(f"{k} {v}" for k, v in row["launches"].items()))
    out["launches"] = {k: [sum(r["lanczos"][b]["launches"].get(k, 0) for b in
                               ("particle", "hole")) for r in ranks]
                       for k in ranks[0]["lanczos"]["particle"]["launches"]}
    return out


def evolution_multistart_gates(ranks, ref):
    import numpy as np

    d = len(ranks)
    for r in ranks:
        m = r["multistart"]
        same = (np.array_equal(m["energies"], ref["energies"])
                and np.array_equal(m["final_energies"], ref["final_energies"])
                and m["best_index"] == ref["best_index"]
                and all(np.array_equal(m["best_params"][k], v)
                        for k, v in ref["best_params"].items()))
        if not same:
            err = float(np.abs(m["energies"] - ref["energies"]).max())
            raise AssertionError(f"multistart D={d} rank {r['rank']}: not the one process's bits "
                                 f"(trajectories {err:.2e} apart)")
        if m["comm"]["exchanges"] or m["comm"]["sums"] or m["comm"]["gathers"] != 5:
            raise AssertionError(f"multistart D={d}: collectives {m['comm']}")
        _need(m["launches"], EVOLUTION_KERNELS["multistart"], f"multistart D={d}")
    r0 = ranks[0]["multistart"]
    s = dict(ranks=d, transport=MESH_TRANSPORT.format(d), same_bits=True,
             ms_per_epoch=[r["multistart"]["ms_per_epoch"] for r in ranks],
             single_card_ms_per_epoch=ref["ms_per_epoch"],
             rows=[r["multistart"]["rows"] for r in ranks], comm=r0["comm"],
             launches_per_epoch={k: v / MS_3X3["n_epoch"] for k, v in r0["launches"].items()},
             single_card_launches_per_epoch={k: v / MS_3X3["n_epoch"]
                                             for k, v in ref["launches"].items()},
             memory_mib=dict(ranks=[r["multistart"]["memory_mib"] for r in ranks],
                             single_card=ref["memory_mib"]),
             launches={k: [r["multistart"]["launches"].get(k, 0) for r in ranks]
                       for k in r0["launches"]})
    if "planted_energies" in r0:
        planted = r0["planted_energies"]
        s["planted_traj_diff"] = float(np.abs(planted - ref["energies"][:len(planted)]).max())
        if np.array_equal(planted, ref["energies"][:len(planted)]):
            raise AssertionError("multistart: rank 1's shifted rows pass the equality gate")
    log(f"  [multistart D={d}] energies, trajectories, best index and best params the same bits "
        f"as the one process on every rank; "
        + ", ".join(f"{ms:.1f}" for ms in s["ms_per_epoch"])
        + f" ms an epoch by rank (single card {ref['ms_per_epoch']:.1f}, all {MS_3X3['n_starts']} "
        f"starts); the run's collectives {r0['comm']['exchanges']} exchanges, "
        f"{r0['comm']['sums']} sums, {r0['comm']['gathers']} gathers after the last epoch"
        + (f"; planted fault (rank 1's rows shifted by one): trajectories "
           f"{s['planted_traj_diff']:.2e} apart (fails the gate)" if "planted_traj_diff" in s
           else ""))
    return s


def phase_mesh_evolution(dev, tmp):
    """Trotter dynamics (3x3 at D = 2, 4; 2x6 at D = 2), ITE and Lanczos
    spectroscopy (3x3, D = 2) and the multistart start axis (3x3 reps = 10,
    D = 2, 4) through the Hopper kernels, the ranks on this one card over
    gloo, against the single-card runs of the same inputs."""
    import numpy as np

    from qsfh_torch.parallel import spawn_ranks

    t0 = time.perf_counter()
    rng = np.random.default_rng(19)  # phase_ite's start
    dim = 1 << (2 * ITE_3X3[0] * ITE_3X3[1])
    ite_v = rng.standard_normal(dim) + 1j * rng.standard_normal(dim)
    ite_v /= np.linalg.norm(ite_v)
    ref = mesh_evolution_reference(dev, tmp, ite_v)
    log(f"  single-card references: {time.perf_counter() - t0:.1f} s")
    with open(DYN_TRACE) as fh:
        dyn_trace = json.load(fh)
    with open(ITE_TRACE) as fh:
        ite_trace = json.load(fh)
    committed = _json(DEMO_ADAPT, "spectral.json")
    out = {}
    for d, cases in MESH_EVOLUTION_RUNS.items():
        t1 = time.perf_counter()
        ranks = spawn_ranks(mesh_evolution_rank, d, backend="gloo", device="cuda",
                            timeout=MESH_TIMEOUT, args=(tmp, ite_v))
        log(f"  {d} ranks ({', '.join(cases)}): {time.perf_counter() - t1:.1f} s; rank 0's "
            "cases " + ", ".join(f"{k} {v:.1f} s" for k, v in ranks[0]["seconds"].items()))
        for case in cases:
            key = f"{case}_D{d}"
            if case.startswith("trotter"):
                n_steps = DYN_STEPS if case == "trotter_3x3" else TROTTER_2X6_STEPS
                out[key] = evolution_trotter_gates(case, ranks, ref[case], n_steps,
                                                   dyn_trace if case == "trotter_3x3" else None)
            elif case == "ite":
                out[key] = evolution_ite_gates(ranks, ref["ite"], ite_trace)
            elif case == "lanczos":
                out[key] = evolution_lanczos_gates(ranks, ref, committed)
            else:
                out[key] = evolution_multistart_gates(ranks, ref["multistart"])
    out["seconds"] = time.perf_counter() - t0
    log(f"  sharded evolution phase: {out['seconds']:.1f} s")
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="write every measurement to this JSON file")
    parser.add_argument("--profile", action="store_true",
                        help="profile 2 train steps and 1 selection at each size")
    parser.add_argument("--routes", action="store_true",
                        help="time the per-term, resident and stream routes at 18-24 qubits")
    parser.add_argument("--tiles", action="store_true",
                        help="time the resident and tile kernels over other tile shapes")
    parser.add_argument("--sweeps", action="store_true",
                        help="the card phase and the float64 and float32 resident sweeps only "
                             "(with --compare, the parent's in turns)")
    parser.add_argument("--mesh-only", action="store_true",
                        help="the card phase and the sharded engine's phase only (a quick check "
                             "of qsfh_torch.parallel; no kernels line)")
    parser.add_argument("--compare", metavar="PARENT",
                        help="time both main paths of the port in the checkout PARENT against "
                             "this one, in turns")
    args = parser.parse_args()

    if not os.path.isdir(os.path.join(HERE, "qsfh_torch")):
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the smoke test runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()

    smi = phase_card()
    tmp = tempfile.mkdtemp(prefix="qsfh_torch_smoke_")
    if args.sweeps:
        log("the float64 and float32 resident sweeps (CUDA events, median of "
            f"{SWEEP_ROUNDS} timings of {SWEEP_REPS} launches):")
        out = dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi, torch=torch.__version__)
        phase_sweeps(dev, out, args.compare)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as fh:
                json.dump(out, fh, indent=1, default=str)
        log(f"smoke test took {time.time() - t_start:.1f} s")
        return 0
    if args.mesh_only:
        log("the amplitude-sharded engine (ranks on this card over gloo):")
        mesh = phase_mesh(build_adapt(dev, tmp, "mesh_ref"),
                          build_adapt(dev, tmp, "mesh_ref24", CONFIG_24), dev, tmp)
        log("the sharded evolution, spectroscopy and start axis (ranks on this card over gloo):")
        evolution = phase_mesh_evolution(dev, tmp)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as fh:
                json.dump(dict(mesh=mesh, mesh_evolution=evolution, nvidia_smi=smi), fh,
                          indent=1, default=str)
        log(f"smoke test took {time.time() - t_start:.1f} s")
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0
    adapt = build_adapt(dev, tmp, "kernels")
    log("kernels at the main path's shapes (CUDA events, ms per call):")
    kern = phase_kernels(adapt, dev, args.tiles)
    log("main path:")
    main = phase_main_path(adapt, dev, tmp)
    out = dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi, kernels=kern,
               main_path=main, torch=torch.__version__)
    out["step_ms_median"] = median_ms(main["steps"])
    out["plain_step_ms_median"] = median_ms(main["plain_steps"])
    log(f"main-path train step: {out['step_ms_median']:.2f} ms (median of steps 2-{N_STEPS}), "
        f"plain versions {out['plain_step_ms_median']:.2f} ms; "
        f"selection {main['select_ms']:.1f} ms vs plain {main['plain_select_ms']:.1f} ms")

    adapt24 = build_adapt(dev, tmp, "kernels24", CONFIG_24)
    log("kernels at 24 qubits, 2x6 term arrays (CUDA events, ms per call):")
    kern24, alone24 = phase_kernels_24(adapt24, dev, args.tiles)
    log("24-qubit main path:")
    main24 = phase_main_path_24(adapt24, dev, tmp)
    out.update(kernels_24=kern24, kernels_24_alone=alone24, main_path_24=main24)
    out["step_ms_median_24"] = median_ms(main24["steps"])
    out["plain_step_ms_median_24"] = median_ms(main24["plain_steps"])
    log(f"24-qubit train step: {out['step_ms_median_24']:.2f} ms (median of steps 2-{N_STEPS}), "
        f"plain versions {out['plain_step_ms_median_24']:.2f} ms (step 2); selection "
        f"{main24['select_ms']:.1f} ms (second call) vs plain {main24['plain_select_ms']:.1f} ms")
    log("kernels off every path: xor_gather and the one-term rotation (CUDA events):")
    single = {n: phase_single(dev, n) for n in (18, 24)}
    out["single"] = single
    log("the float64 Rayleigh readout on the main paths' states:")
    f64 = phase_f64([("3x3", adapt, N_ANSATZ), ("2x6", adapt24, N_ANSATZ_24)], dev, args.tiles)
    log("the fused runner at 3x3 (CUDA graphs of K train steps):")
    fused = phase_fused(dev, tmp)
    log("the fused runner at 2x6:")
    fused24 = phase_fused_24(adapt24, dev)
    log("the HVA driver (3x3 reps=10, the reps=2 unrolled cross-check, 2x6 reps=2):")
    hva_res, hva, hva24 = phase_hva(dev, tmp)
    out["hva"] = hva_res
    log("the iQCC driver (2x3 dense-exact ILC and LiH at 12 qubits, 2x2 at 8):")
    t_iqcc = time.perf_counter()
    iqcc = phase_iqcc(dev, tmp)
    iqcc["seconds"] = time.perf_counter() - t_iqcc
    out["iqcc"] = iqcc
    log(f"  iQCC phase: {iqcc['seconds']:.1f} s")
    log("exact diagonalization at 3x3 (the port's Lanczos, on the card):")
    ed = phase_ed(dev)
    out.update(f64=f64, fused=fused, fused_24=fused24, ed=ed)
    log("product states at 26, 28 and 30 qubits against float64 closed forms:")
    big = phase_product_state(dev)
    log("the HEA driver (H2 at 4 qubits, LiH at 12):")
    hea_res = phase_hea(dev, tmp)
    log("VQD (H2, 3 levels; LiH, 2 levels):")
    vqd = phase_vqd(dev, tmp)
    log("real-time Trotter dynamics (the 3x3 Neel quench):")
    dyn = phase_dynamics(dev)
    log("imaginary-time evolution (3x3):")
    ite = phase_ite(dev)
    out.update(product_state=big, hea=hea_res, vqd=vqd, dynamics=dyn, ite=ite)
    log("the 3x3 analysis scripts' paths on the committed checkpoints:")
    analysis = phase_analysis(dev)
    log("Lanczos resolvent spectroscopy at 3x3 (spectral_3x3.py, sqw_3x3.py):")
    spectral = phase_spectral(dev)
    log("batched multistart (the 2x2 demo; 3x3 HVA and LiH HEA at B = 4):")
    multistart = phase_multistart(dev, tmp)
    log("shot-based grouped estimation at 3x3 (tpu_sampling.py):")
    sampling = phase_sampling(dev)
    out.update(analysis=analysis, spectral=spectral, multistart=multistart, sampling=sampling)
    log("the command line (qsfh_torch.cli): adapt at 3x3, ed at 2x6, the other subcommands:")
    variational_24 = [r["energy"] for rows in (main24["steps"], main24["plain_steps"],
                                               hva_res["hva_24"]["steps"],
                                               hva_res["hva_24"]["plain_steps"])
                      for r in rows]
    cli_res = phase_cli(dev, tmp, variational_24)
    out["cli"] = cli_res
    log("the float64 polish engine on the 1719-operator 3x3 checkpoint (polish_fast.py's path):")
    polish = phase_polish(dev, tmp, args.tiles)
    out["polish"] = polish
    if args.routes:
        log("routes, host clock, median (least) of 15 interleaved rounds:")
        adapt20 = build_adapt(dev, tmp, "routes20", CONFIG_20)
        phase_routes([("3x3", adapt, N_ANSATZ), ("2x5", adapt20, N_ANSATZ_24),
                      ("2x6", adapt24, N_ANSATZ_24)], dev, out)
        log("inner-product kernels, CUDA events, median of 5 rounds:")
        phase_inner_routes([("3x3", adapt), ("2x5", adapt20), ("2x6", adapt24)], dev, out)
        del adapt20
    if args.profile:
        profile_phase(adapt, N_ANSATZ, out["step_ms_median"], main["select_ms"], out, "3x3")
        profile_phase(adapt24, N_ANSATZ_24, out["step_ms_median_24"], main24["select_ms"], out,
                      "2x6")
        profile_hva(hva, hva_res["step_ms"], out, "3x3 HVA")
        profile_hva(hva24, hva_res["hva_24"]["step_ms"], out, "2x6 HVA")
    if args.compare:
        log(f"the parent's port ({args.compare}) against this one, in turns:")
        phase_compare(args.compare, dev, tmp, out)
    log("the amplitude-sharded engine: ADAPT(mesh_devices=D), ranks on this card over gloo:")
    t_mesh = time.perf_counter()
    mesh = phase_mesh(adapt, adapt24, dev, tmp)
    log(f"  mesh phase: {time.perf_counter() - t_mesh:.1f} s")
    out["mesh"] = mesh
    log("the sharded evolution, spectroscopy and start axis: Trotter, ITE, Lanczos and "
        "multistart on D ranks on this card over gloo:")
    evolution = phase_mesh_evolution(dev, tmp)
    out["mesh_evolution"] = evolution
    log(f"smoke test took {time.time() - t_start:.1f} s")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1, default=str)

    line = []
    source = "qsfh_torch/csrc/statevec_kernels.cu"
    for name in ("pauli_rotation", "pauli_apply", "pauli_inner", "adjoint_rotation"):
        entries = kern[name]
        head = max(entries, key=lambda e: e["terms"])  # the heaviest main-path call
        line.append(dict(
            name=name, route="cuda", source=source, replaces=REPLACES[name],
            launches=main["launches"][name],
            max_abs_err=max(e["max_abs_err"] for e in entries), ms=head["ms"],
            plain_ms=head["plain_ms"], bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"], call=head["call"],
            launches_24q=main24["launches"][name],
        ))
        if name == "pauli_apply":  # TPU kernel 9 at 24 qubits, with its CSR yardstick
            e24 = kern24["pauli_apply"][0]
            line[-1].update(ms_24q=e24["ms"], plain_ms_24q=e24["plain_ms"],
                            bound_ms_24q=e24["bound_ms"], library_ms_24q=e24["library_ms"])
    name = "pauli_apply_grouped"  # H psi on both main paths (TPU kernels 2 and 9)
    g18, g24 = kern[name][0], kern24[name][0]
    line.append(dict(
        name=name, route="cuda", source=source, replaces=REPLACES[name],
        launches=main["launches"][name], max_abs_err=max(g18["max_abs_err"], g24["max_abs_err"]),
        ms=g18["ms"], plain_ms=g18["plain_ms"], bound_ms=g18["bound_ms"],
        bound_by=g18["bound_by"], library_ms=g18["library_ms"], call=g18["call"],
        per_term_ms=g18["per_term_ms"],
        launches_per_step=main["launches_per_step"][name],
        launches_per_selection=main["launches_per_select"][name],
        launches_24q=main24["launches"][name], ms_24q=g24["ms"], plain_ms_24q=g24["plain_ms"],
        bound_ms_24q=g24["bound_ms"], library_ms_24q=g24["library_ms"],
        per_term_ms_24q=g24["old_route_ms"],
    ))
    for name in ("expectation_grouped", "screen_grouped"):  # TPU kernels 3, 5, 8 and 10
        entries, entries24 = kern[name], kern24[name]
        head = max(entries, key=lambda e: e["terms"])  # S^2 or the pool, 18 qubits
        head24 = max(entries24, key=lambda e: e["terms"])
        line.append(dict(
            name=name, route="cuda", source=source, replaces=REPLACES[name],
            launches=main["launches"][name],
            max_abs_err=max(e["max_abs_err"] for e in entries + entries24), ms=head["ms"],
            plain_ms=head["plain_ms"], bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=None, call=head["call"], per_term_ms=head["per_term_ms"],
            launches_per_step=main["launches_per_step"][name],
            launches_per_selection=main["launches_per_select"][name],
            launches_24q=main24["launches"][name],
            calls={e["call"]: {k: e[k] for k in ("ms", "device_ms", "host_ms", "per_term_ms",
                                                 "per_term_device_ms", "per_term_host_ms",
                                                 "bound_ms")} for e in entries},
            ms_24q=head24["ms"], plain_ms_24q=head24["plain_ms"], bound_ms_24q=head24["bound_ms"],
            calls_24q={e["call"]: {k: e[k] for k in ("ms", "device_ms", "host_ms", "bound_ms")}
                       for e in entries24},
        ))
    one = single[24]["pauli_rotation_one"]  # TPU kernel 12 (:571), on no path
    line.append(dict(
        name="pauli_rotation_out", route="cuda", source=source,
        replaces=REPLACES["pauli_rotation_out"], launches=main["launches"]["pauli_rotation_out"],
        max_abs_err=max(single[n]["pauli_rotation_one"]["max_abs_err"] for n in single),
        ms=one["ms"], plain_ms=one["plain_ms"], bound_ms=one["bound_ms"],
        bound_by=one["bound_by"], library_ms=None,
        call=f"{one['call']} (on no path: 0 launches on both main paths)",
        xor_gather_ms=one["gather_ms"], split_24q=one["split"],
        ms_18q=single[18]["pauli_rotation_one"]["ms"],
        xor_gather_ms_18q=single[18]["pauli_rotation_one"]["gather_ms"],
        split_18q=single[18]["pauli_rotation_one"]["split"],
    ))
    for name in RESIDENT_KERNELS:  # the 18-qubit main path's rotations and adjoint sweep
        entries = kern[name]
        head = max(entries, key=lambda e: e["terms"])
        e20 = max(kern["n20"][name], key=lambda e: e["terms"])
        line.append(dict(
            name=name, route="cuda", source=source, replaces=REPLACES[name],
            launches=main["launches"][name],
            max_abs_err=max(e["max_abs_err"] for e in entries + kern["n20"][name]),
            ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=None, call=head["call"],
            launches_per_step=main["launches_per_step"][name],
            launches_per_selection=main["launches_per_select"][name],
            launches_24q=main24["launches"][name],
            ms_20q=e20["ms"], plain_ms_20q=e20["plain_ms"], bound_ms_20q=e20["bound_ms"],
        ))
    for name in STREAM_KERNELS:
        entries = kern24[name]
        if name in alone24:  # the run kernels' own launches over one segment
            head = alone24[name]
            (b_ms, b_by), call = head["bound"], head["call"]
        else:  # the heaviest main-path call
            head = max(entries, key=lambda e: e["terms"])
            b_ms, b_by, call = head["bound_ms"], head["bound_by"], head["call"]
        line.append(dict(
            name=name, route="cuda", source=source, replaces=REPLACES[name],
            launches=main24["launches"][name],
            max_abs_err=max(e["max_abs_err"] for e in entries), ms=head["ms"],
            plain_ms=head["plain_ms"], bound_ms=b_ms, bound_by=b_by, library_ms=None,
            call=f"{call} (24 qubits)", passes=head.get("passes"),
        ))
    head = single[24]["xor_gather"]
    line.append(dict(
        name="xor_gather", route="cuda", source=source, replaces=REPLACES["xor_gather"],
        launches=main24["launches"]["xor_gather"], max_abs_err=head["max_abs_err"],
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=head["library_ms"],
        call=f"{head['call']} (on no path: 0 launches on both main paths)",
        split_18q=single[18]["xor_gather"]["split"], split_24q=head["split"],
        index_select_split_18q=single[18]["xor_gather"]["library_split"],
        index_select_split_24q=head["library_split"],
    ))
    f18, f24, f_spill, f_sizes = f64
    captured = fused["launches"]
    for name in ("expectation_norm_f64_tiles", "expectation_norm_f64"):
        tiles = name.endswith("tiles")
        pick = (lambda row, key: row[key if tiles else f"old_{key}"])  # noqa: E731
        line.append(dict(
            name=name, route="cuda", source=source, replaces=REPLACES[name],
            launches=sum(captured[k][name] for k in captured), replays=fused["replays"],
            max_abs_err=max(pick(f18, "max_abs_err"), pick(f24, "max_abs_err")),
            ms=pick(f18, "ms"), plain_ms=f18["plain_ms"], bound_ms=f18["bound_ms"],
            bound_by=f18["bound_by"], library_ms=f18["library_ms"],
            call=f18["call"] + (" (the fused 3x3 path: launches counted per capture and warm-up "
                                "step)" if tiles else " (states under 9 qubits and masks that "
                                                      "fit no tile: 0 launches on the main paths; "
                                                      "timed in turns with the tiles)"),
            rel_err=max(pick(f18, "rel_err"), pick(f24, "rel_err")), ms_24q=pick(f24, "ms"),
            plain_ms_24q=f24["plain_ms"], bound_ms_24q=f24["bound_ms"],
            bound_by_24q=f24["bound_by"], library_ms_24q=f24["library_ms"],
            launches_24q=sum(fused24["launches"][k][name] for k in fused24["launches"]),
            launches_spilled_h=f_spill["launches"].get(name, 0),
            planted_rel_err=f18["planted"]["rel_err"] if tiles else None,
            ms_by_qubits=route_sizes(f_sizes, "readout", tiles),
        ))
    for entry in line:  # the kernels each captured train step holds, as graph nodes
        entry["graph_nodes_per_fused_step"] = fused["nodes_per_step"][entry["name"]]
        entry["graph_nodes_per_fused_step_24q"] = fused24["nodes_per_step"][entry["name"]]
        # the HVA path: 3x3 reps = 10 (5 steps and a run() of 4), 2x6 reps = 2 (2 steps)
        entry["launches_hva"] = hva_res["launches"][entry["name"]]
        entry["launches_per_hva_step"] = hva_res["launches_per_step"][entry["name"]]
        entry["launches_hva_24q"] = hva_res["hva_24"]["launches"][entry["name"]]
        for suffix, kern_hva in (("hva", hva_res["kernels"]),
                                 ("hva_24q", hva_res["hva_24"]["kernels"])):
            head = kern_hva.get(entry["name"], [None])[0]  # the HVA segment's call
            if head is not None:
                entry.update({f"{key}_{suffix}": head[key] for key in
                              ("ms", "plain_ms", "bound_ms", "max_abs_err")})
    for entry in line:  # the iQCC path: 2x3 dense and LiH at 12 qubits, 2x2 at 8
        entry["launches_iqcc"] = iqcc["launches"][entry["name"]]
        entry["launches_per_iqcc_step"] = {
            cell: iqcc[cell]["launches_per_step"].get(entry["name"], 0)
            for cell in ("2x3_dense", "lih", "2x2")}
        for cell in ("2x3_dense", "lih"):
            head = iqcc[cell]["kernels"].get(entry["name"], [None])[0]
            if head is not None:
                entry.update({f"{key}_iqcc_{cell}": head[key] for key in
                              ("ms", "plain_ms", "bound_ms", "max_abs_err")})
    for entry in line:  # this slice's paths: product states, HEA, VQD, Trotter, ITE
        name = entry["name"]
        entry["launches_product_state"] = sum(big[n]["launches"][name] for n in BIG_LATTICES)
        entry["launches_per_hea_step"] = {cell: hea_res[cell]["launches_per_step"][name]
                                          for cell in ("h2", "lih")}
        entry["launches_vqd"] = vqd["launches"][name]
        entry["launches_per_trotter_step"] = dyn["launches_per_step"].get(name, 0)
        entry["launches_per_ite_step"] = ite["launches_per_step"].get(name, 0)
        for n in BIG_LATTICES:
            head = big[n]["kernels"].get(name)
            if head is not None:
                entry.update({f"{key}_{n}q": head[key] for key in ("ms", "bound_ms", "bound_by")})
    for entry in line:  # this slice's paths: analysis, Lanczos, multistart, sampling
        name = entry["name"]
        # one spin matrix, rho_up and pair matrix on the trained ADAPT state
        entry["launches_analysis"] = analysis["launches"][name]
        entry["launches_spectral"] = spectral["launches"].get(name, 0)
        entry["launches_per_lanczos_step"] = spectral["launches_per_step"].get(name, 0)
        entry["launches_per_multistart_epoch"] = {
            cell: multistart[cell]["launches_per_epoch"].get(name, 0)
            for cell in ("2x2", "3x3", "lih")}
        entry["launches_sampling"] = sampling["launches"].get(name, 0)
        if name == "pauli_inner_grouped":
            for m, row in analysis["matrices"].items():
                entry.update({f"{key}_{m}_matrix": row[key] for key in
                              ("kernel_ms", "bound_ms", "matrix_ms")})
        if name == "pauli_apply_grouped":
            entry.update(ms_lanczos_step=spectral["step_ms"], ms_lanczos_hpsi=spectral["hpsi_ms"])
    for entry in line:  # the command line: adapt at 3x3, the 2x6 ED's checks
        entry["launches_cli_adapt"] = cli_res["adapt_3x3"]["launches"][entry["name"]]
        entry["launches_cli_ed_2x6_checks"] = cli_res["ed_2x6"]["launches"][entry["name"]]
        entry["launches_f64_polish"] = polish["launches"][entry["name"]]
    # the float64 kernels: launches those of the polish run (L-BFGS and Newton-CG, the
    # resident route), ms per wrapper call beside the plain version's
    checks, routes = polish["kernel_checks"].values(), polish["route_checks"].values()
    errs = {"rot64_resident": max(c["state_max_abs"] for c in checks),
            "happly64_tiles": max(c["hpsi_max_abs"] for c in checks),
            "happly64": max(c["hpsi_old_max_abs"] for c in checks),
            "adjoint64_resident": max(c["g_err"] for c in checks),
            "rot64_groups": max(r["groups_state_max_abs"] for r in routes),
            "adjoint64_groups": max(r["groups_g_err"] for r in routes)}
    structure, layout = polish["structure"], polish["layout"]
    per_eval = {"rot64_groups": structure["groups"], "happly64": 0,
                "adjoint64_groups": structure["groups"], "rot64_resident": 1,
                "adjoint64_resident": 1, **polish["h_layout"]["launches"]}
    call = (f"3x3 checkpoint, 18 qubits, {structure['groups']} groups / 100 H terms, "
            f"complex128")
    vg, hvp = polish["times"]["value_and_grad"], polish["times"]["hvp"]
    for name in F64_GROUP_KERNELS + F64_RESIDENT_KERNELS + ("happly64_tiles",):
        head = polish["times"][name]
        entry = dict(
            name=name, route="cuda", source=source, replaces=REPLACES[name],
            launches=polish["launches"][name], max_abs_err=errs[name], ms=head["ms"],
            plain_ms=head["plain_ms"], bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head.get("library_ms"), call=call,
            launches_per_evaluation=per_eval[name], ms_per_evaluation=vg["ms"],
            ms_per_hvp=hvp["ms"], launches_groups_route=polish["run_groups"]["launches"][name])
        if name in ("rot64_groups", "adjoint64_groups"):
            entry.update(call=call + " (the route of programs that fit no tile: 0 launches on "
                                     "the polish run; its L-BFGS run beside it)",
                         ms_per_evaluation=vg["groups_ms"], ms_per_hvp=hvp["groups_ms"])
        if name in F64_RESIDENT_KERNELS:
            entry.update(call=call + f", {layout['runs']} tile runs ({layout['k']} / "
                                     f"{layout['c']}), one cooperative launch a pass",
                         max_route_state_rel=max(r["state_rel"] for r in routes),
                         max_route_g_rel=max(r["g_rel"] for r in routes),
                         grid=max(r["grid"] for r in routes))
        if name in ("happly64", "happly64_tiles"):  # also at 24 qubits, the 2x6 state
            h24, tiles, lay = f24["happly64"], name == "happly64_tiles", polish["h_layout"]
            entry.update(ms_24q=h24["ms" if tiles else "old_ms"], plain_ms_24q=h24["plain_ms"],
                         bound_ms_24q=h24["bound_ms"], bound_by_24q=h24["bound_by"],
                         max_abs_err_24q=h24["hpsi_max_abs" if tiles else "old_hpsi_max_abs"],
                         launches_spilled_h=f_spill["launches"].get(name, 0),
                         ms_by_qubits=route_sizes(f_sizes, "happly64", tiles))
            if tiles:
                entry.update(call=call + f", H in {lay['tiles']} application tiles ({lay['k']} / "
                                         f"{lay['c']}), one launch a tile",
                             planted_hpsi_rel=polish["h_fault"]["hpsi_rel"])
            else:
                entry.update(call=call + " (states under 18 qubits and masks that fit no tile: "
                                         "0 launches on the polish run; timed in turns with "
                                         "happly64_tiles)")
        line.append(entry)
    # the amplitude-sharded path (phase_mesh): the partner form of row 8, and every
    # kernel's launches there, summed over the ranks of each configuration
    p17, p23 = mesh["3x3_D2"]["partner"], mesh["2x6_D2"]["partner"]
    line.append(dict(
        name="expectation_partner", route="cuda", source=source,
        replaces=REPLACES["expectation_partner"],
        launches=sum(sum(m["launches"]["expectation_partner"]) for m in mesh.values()),
        max_abs_err=max(p17["max_abs_err"], p23["max_abs_err"]), ms=p17["ms"],
        plain_ms=p17["plain_ms"], bound_ms=p17["bound_ms"], bound_by=p17["bound_by"],
        library_ms=None,
        call=(f"3x3 H cross terms and 3 x_lo = 0 terms on rank 0's shard, {p17['n_local']} local "
              f"qubits, D = 2 (the sharded path: {MESH_TRANSPORT.format(2)})"),
        graph_ms=p17["graph_ms"], ms_23q=p23["ms"], graph_ms_23q=p23["graph_ms"],
        plain_ms_23q=p23["plain_ms"], bound_ms_23q=p23["bound_ms"], bound_by_23q=p23["bound_by"],
        launches_per_step={c: m["launches_per_step"].get("expectation_partner", 0)
                           for c, m in mesh.items()},
        launches_per_selection={c: m["launches_per_selection"].get("expectation_partner", 0)
                                for c, m in mesh.items()}))
    for entry in line:
        entry["launches_mesh"] = {c: sum(m["launches"].get(entry["name"], [0]))
                                  for c, m in mesh.items()}
        # the sharded Trotter, ITE, Lanczos and multistart runs, summed over the ranks
        entry["launches_mesh_evolution"] = {
            c: sum(m["launches"].get(entry["name"], [0])) for c, m in evolution.items()
            if isinstance(m, dict)}
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
