"""Real-time Trotter dynamics of the Fermi-Hubbard model.

Counterpart of ``qsfh_tpu/algos/dynamics.py``: quench dynamics
``|psi(t)> = exp(-i H t) |psi0>`` by first-order (Lie) or second-order
(Strang) Trotter steps over the HVA's commuting structure (the bond
colouring of ``ops/hva.py``: the terms of one colour class commute, and
H_hop = -t * sum of the class generators exactly).

Kernel route: ONE Trotter step is ONE static rot segment of two
parameters, lowered once: the Coulomb layer as the Z/ZZ rotations of JW(U
term) (parameter 0, the Coulomb angle), then the hopping classes
(parameter 1, the hopping angle), mirrored for Strang.  It runs on
``rotation_resident`` up to ``streaming.CHAIN_MAX_QUBITS`` and on
``rotation_tile_runs`` above (the per-term kernels below
``kernels.TILE_MIN_BITS``).  The rotation form of the Coulomb layer drops
JW(H)'s identity component exactly as the JAX propagator's diagonal does
(``algos/base.py``: the two forms agree, global phase included), so the
step is exp(-i (H - energy_shift) dt) up to the Trotter error, with the
JAX phase: ``greens_function`` overlaps against fixed references.
:class:`ScheduledEvolution` feeds its per-step coupling scales as the
segment's two angles; no segment is built per step.

Observables per step take ``Observable.expectation_scan`` (the
inner-product tiles); ``evolve`` keeps each record on the device and
copies it to the host once, at the end.  Entry points run on ``cuda``
unless ``device`` says otherwise.

``mesh`` (``parallel.amplitude_mesh``, D ranks of an initialized
``torch.distributed`` group): the state is amplitude-sharded.  The step's
segment goes to a ``parallel.sharded_compiled.ShardedRotations`` once (its
local runs on the shard, its pair runs on [own | partner], one exchange
each); each step runs it on the rank's pair buffer with the step's two
angles.  Observables become ``ShardedObservable`` (one exchange per
distinct cross x_hi, shared by all of them), overlaps local ``vdot`` of
the references' shards, and one step's records meet in ONE rank-order sum:
the same bits on every rank.  ``evolve`` takes the start state whole or
as the rank's shard and returns the rank's shard of the final state (the
JAX function returns the whole host state; ``parallel.gather_statevector``
gives it).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..engine.compiled import CompiledCircuit, run_segments
from ..engine.expectation import Observable
from ..engine.kernels import KERNELS
from ..engine.state import as_state, real_dtype
from ..ops.fermion import FermionOperator
from ..ops.jw import jordan_wigner
from .base import default_dtype, resolve_device


def neel_occupied(nx: int, ny: int):
    """Neel (antiferromagnetic) product-state orbitals: spin-up on the
    (x+y)-even checkerboard sites, spin-down on the odd ones (row-major
    sites, up on even JW modes).  On odd lattices (e.g. 3x3) this lands in
    the ceil/floor half-filling sector the flagship demos use."""
    occ = []
    for s in range(nx * ny):
        x, y = s % nx, s // nx
        occ.append(2 * s if (x + y) % 2 == 0 else 2 * s + 1)
    return tuple(occ)


def trotter_program(u_rot, groups, order: int):
    """One Trotter step as ops over two parameters: the Coulomb layer's
    rotations on parameter 0 and every hopping class on parameter 1;
    Strang (order 2) mirrors the sweep (Coulomb, classes, classes
    reversed, Coulomb), each half at half the angles."""
    coulomb = [("rot", tuple(u_rot), 0)]
    hops = [("rot", tuple(g), 1) for g in groups]
    if order == 1:
        return coulomb + hops
    return coulomb + hops + hops[::-1] + coulomb


class TrotterEvolution:
    """Fixed-step real-time propagator for a :class:`HubbardProblem`.

    ``mesh``: a ``parallel.Mesh`` of an initialized group; the state is
    amplitude-sharded over its ranks (the module docstring), the device
    the mesh's."""

    def __init__(self, problem, dt: float, order: int = 2, dtype=None, device=None, mesh=None):
        if order not in (1, 2):
            raise ValueError("order must be 1 (Lie) or 2 (Strang)")
        self.problem = problem
        self.dt = float(dt)
        self.order = order
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.dtype = dtype or default_dtype(self.device)
        self.n_qubits = problem.n_qubits
        # the kernel wrappers; a reference run on the card may set
        # engine.kernels.PLAIN
        self.impl = KERNELS

        h_rots, v_rots = problem.hva_generators()
        self._groups = [g.rotation_terms() for g in (h_rots + v_rots)]
        self._u_rot = jordan_wigner(problem.interacting_term).rotation_terms()
        self._t = float(problem.tunneling)
        ops = trotter_program(self._u_rot, self._groups, order)
        (self.segment,) = CompiledCircuit(ops, self.n_qubits).segments
        # on a mesh: the step's runs on the shards, and the sharded
        # observables (built at first use, one per Observable)
        self.engine = self.program = None
        self._sharded = {}
        if mesh is not None:
            from ..parallel.sharded_compiled import ShardedRotations
            from ..parallel.shmap_engine import ShardedPauliEngine

            self.engine = ShardedPauliEngine(self.n_qubits, mesh)
            self.program = ShardedRotations(self.engine, ops)
        # the Coulomb layer drops JW(H)'s identity component, so the
        # propagator implements exp(-i (H - energy_shift) t): a GLOBAL
        # phase, invisible to expectation values but essential when
        # overlapping against fixed references (Green's functions)
        self.energy_shift = float(problem.qubit_hamiltonian.constant().real)
        self._static = self.step_angles(1.0, 1.0)

    # -- single step --------------------------------------------------------------

    def step_angles(self, t_scale, u_scale) -> torch.Tensor:
        """The segment's (Coulomb, hopping) angles for coupling scales
        ``t_scale`` / ``u_scale`` (scalars or per-step arrays: then one row
        per step), on the device: dt u_scale and -t dt t_scale, halved for
        Strang."""
        h = self.dt if self.order == 1 else self.dt / 2.0
        t_scale = np.asarray(t_scale, np.float64)
        u_scale = np.asarray(u_scale, np.float64)
        angles = np.stack([h * u_scale, -self._t * (h * t_scale)], axis=-1)
        return torch.as_tensor(angles).to(device=self.device, dtype=real_dtype(self.dtype))

    def step(self, psi: torch.Tensor, t_scale=None, u_scale=None) -> torch.Tensor:
        """One Trotter step of ``dt`` (a new state; ``psi`` untouched; on a
        mesh the rank's shard), the couplings scaled by ``t_scale`` /
        ``u_scale`` (None = 1)."""
        if t_scale is None and u_scale is None:
            angles = self._static
        else:
            angles = self.step_angles(1.0 if t_scale is None else t_scale,
                                      1.0 if u_scale is None else u_scale)
        if self.mesh is not None:
            return self.program.apply(psi, angles, impl=self.impl)
        return run_segments([self.segment], psi, angles, self.n_qubits, impl=self.impl)

    def sharded(self, obs: Observable):
        """``obs`` on the mesh's shards (a ``ShardedObservable``, built once
        per observable)."""
        from ..parallel.sharded_compiled import ShardedObservable

        key = id(obs)
        if key not in self._sharded:
            self._sharded[key] = (obs, ShardedObservable.of(self.engine, obs.op))
        return self._sharded[key][1]

    # -- trajectory ---------------------------------------------------------------

    def evolve(
        self,
        psi0,
        n_steps: int,
        observables: Optional[Dict[str, Observable]] = None,
        overlaps: Optional[Dict[str, np.ndarray]] = None,
    ):
        """Propagate ``n_steps`` and record observables after every step.

        ``observables`` record real expectation values; ``overlaps`` maps
        names to FIXED reference vectors and records the complex series
        ``<ref | psi(t)>``.  Returns ``(psi_final, records)``: the final
        state on the device and per record a host numpy series of
        ``n_steps`` values.  On a mesh ``psi0`` and the references are
        whole states or the rank's shards, and ``psi_final`` is the rank's
        shard.
        """
        return self._evolve(psi0, n_steps, observables, overlaps, None)

    def _evolve(self, psi0, n_steps, observables, overlaps, angles):
        obs = observables or {}
        clash = set(obs) & set(overlaps or {})
        if clash:
            raise ValueError(
                f"observable and overlap records share one namespace; "
                f"duplicate name(s): {sorted(clash)}"
            )
        if self.mesh is not None:
            return self._evolve_sharded(psi0, n_steps, obs, overlaps or {}, angles)
        refs = {name: as_state(v, self.device, self.dtype)
                for name, v in (overlaps or {}).items()}
        psi = as_state(psi0, self.device, self.dtype)
        series = {name: [] for name in list(obs) + list(refs)}
        for k in range(n_steps):
            psi = run_segments([self.segment], psi,
                               self._static if angles is None else angles[k],
                               self.n_qubits, impl=self.impl)
            for name, o in obs.items():
                series[name].append(o.expectation_scan(psi, impl=self.impl))
            for name, ref in refs.items():
                series[name].append(torch.vdot(ref, psi))
        records = {}
        for name, vals in series.items():
            complex_ = name in refs
            if vals:
                records[name] = torch.stack(vals).cpu().numpy()
            else:
                records[name] = np.zeros(0, np.complex128 if complex_ else np.float64)
        return psi, records

    def _evolve_sharded(self, psi0, n_steps, obs, overlaps, angles):
        """:meth:`_evolve` on the mesh: the state in the first half of the
        program's pair buffer, the first partner's shard received into its
        second half, one step's records in one rank-order sum."""
        from ..parallel import comm
        from ..parallel.mesh import shard_input

        mesh, prog = self.mesh, self.program
        sharded = {name: self.sharded(o) for name, o in obs.items()}
        refs = {name: shard_input(v, mesh, self.n_qubits, self.dtype)
                for name, v in overlaps.items()}
        cross = {m for o in sharded.values() for m in o.cross}
        buf = prog.pair_buffer(shard_input(psi0, mesh, self.n_qubits, self.dtype))
        half = 1 << self.engine.n_local
        rows = []
        for k in range(n_steps):
            psi = prog.run(buf, self._static if angles is None else angles[k], impl=self.impl)
            partners = self.engine.partners(psi, cross, buf[half:] if prog.exchanges else None)
            vals = [o.partial(psi, partners, self.impl).reshape(1) for o in sharded.values()]
            for ref in refs.values():
                ov = torch.vdot(ref, psi)
                vals.append(torch.stack([ov.real, ov.imag]))
            del partners
            if vals:
                rows.append(comm.all_sum(torch.cat(vals)))
        table = torch.stack(rows).cpu().numpy() if rows else None
        records = {}
        for i, name in enumerate(sharded):
            records[name] = table[:, i] if table is not None else np.zeros(0, np.float64)
        for j, name in enumerate(refs):
            col = len(sharded) + 2 * j
            records[name] = (table[:, col] + 1j * table[:, col + 1] if table is not None
                             else np.zeros(0, np.complex128))
        psi = buf[:half]
        return (psi.clone() if prog.exchanges else psi), records


def _schedule_values(schedule, default, times):
    """Evaluate a coupling schedule: callable tau->value, per-step array,
    scalar, or None (= the problem's static coupling)."""
    if schedule is None:
        return np.full(len(times), float(default))
    if callable(schedule):
        return np.array([float(schedule(t)) for t in times])
    arr = np.asarray(schedule, dtype=np.float64)
    if arr.ndim == 0:
        return np.full(len(times), float(arr))
    if arr.shape != (len(times),):
        raise ValueError(f"schedule must have one value per step, got {arr.shape}")
    return arr


class ScheduledEvolution(TrotterEvolution):
    """Real-time evolution under time-dependent couplings t(tau), U(tau).

    Each Trotter step uses the couplings sampled at the step MIDPOINT
    ``tau_k = (k + 1/2) dt`` (the midpoint product formula).  Schedules
    are callables ``tau -> coupling``, per-step arrays, or scalars, in the
    units of the problem's static ``tunneling``/``coulomb``; ``None``
    keeps the static value.  The values ride as the step segment's two
    angles, one row per step, so every ramp shape runs the same segment.

    The dropped JW identity constant scales with U, so under a U-schedule
    the propagator differs from ``exp(-i int H)`` by the time-dependent
    global phase ``exp(+i shift0 int u_scale)``; ``records['shift_phase']``
    returns that accumulated integral so overlap records can be unfolded.
    """

    def evolve(
        self,
        psi0,
        n_steps: int,
        observables: Optional[Dict[str, Observable]] = None,
        overlaps: Optional[Dict[str, np.ndarray]] = None,
        tunneling=None,
        coulomb=None,
    ):
        if "shift_phase" in (observables or {}) or "shift_phase" in (overlaps or {}):
            raise ValueError("'shift_phase' is a reserved record name")
        times = (np.arange(n_steps) + 0.5) * self.dt
        t_vals = _schedule_values(tunneling, self.problem.tunneling, times)
        u_vals = _schedule_values(coulomb, self.problem.coulomb, times)
        t0 = float(self.problem.tunneling)
        u0 = float(self.problem.coulomb)
        if t0 == 0.0 and np.any(t_vals != 0.0):
            raise ValueError(
                "tunneling schedule needs a problem with nonzero static t "
                "(the hopping layer is scaled relative to it)"
            )
        if u0 == 0.0 and np.any(u_vals != 0.0):
            raise ValueError(
                "coulomb schedule needs a problem with nonzero static U "
                "(the Coulomb diagonal is scaled relative to it)"
            )
        t_scales = np.where(t_vals == 0.0, 0.0, t_vals / (t0 if t0 else 1.0))
        u_scales = np.where(u_vals == 0.0, 0.0, u_vals / (u0 if u0 else 1.0))
        angles = self.step_angles(t_scales, u_scales)
        psi_final, records = self._evolve(psi0, n_steps, observables, overlaps, angles)
        records["shift_phase"] = self.energy_shift * self.dt * np.cumsum(u_scales)
        return psi_final, records


def apply_on_host(obs: Observable, vec, dtype=torch.complex128) -> np.ndarray:
    """``obs`` applied to ``vec`` on the CPU: the plain complex128
    ``Observable.apply``, returned as a host numpy vector of ``dtype``.
    The JAX helper of the same name, for a caller that wants the excited
    vector ``c^(dag)_m |gs>`` as a host array; :func:`greens_function`
    builds it on the propagator's device instead."""
    v = vec.detach().cpu() if torch.is_tensor(vec) else torch.as_tensor(np.asarray(vec))
    out = obs.apply(v.to(torch.complex128)).to(dtype)
    return out.numpy()


def excitation_operator(mode, kind: str = "particle") -> FermionOperator:
    """The ladder operator whose action on |gs> seeds a Green's function.

    ``mode`` may be a JW mode index (``kind`` picks ``c^dag_m`` / ``c_m``)
    or an arbitrary :class:`FermionOperator` (e.g. a momentum-space ladder
    ``c^dag_k = N^{-1/2} sum_r e^{i k.r} c^dag_r`` for A(k, omega)).
    """
    if isinstance(mode, FermionOperator):
        return mode
    if kind == "particle":
        return FermionOperator(((mode, 1),))
    if kind == "hole":
        return FermionOperator(((mode, 0),))
    raise ValueError("kind must be 'particle' or 'hole'")


def greens_function(
    problem,
    ground_state,
    ground_energy: float,
    mode,
    dt: float,
    n_steps: int,
    kind: str = "particle",
    order: int = 2,
    dtype=None,
    device=None,
    mesh=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Retarded single-particle Green's function via real-time evolution.

    ``kind='particle'``: ``G^>(t) = <gs| c_m e^{-i(H - E0) t} c^dag_m |gs>``
    (electron addition); ``kind='hole'`` swaps the ladder operators
    (electron removal).  ``|phi> = c^(dag)_m |gs>`` is built on the
    propagator's device (``Observable.apply_auto``), evolved with the
    Trotter propagator and overlapped against itself each step; the
    ``e^{+i E0 t}`` rotating frame is folded in on the host.  Returns
    ``(times, G)`` (complex, length ``n_steps``).  ``mesh``: the
    evolution on the shards (``ground_state`` whole or the rank's shard),
    ``|phi>`` built on them (the ladder's cross terms on the partner's
    shard), every overlap a rank-order sum.
    """
    ev = TrotterEvolution(problem, dt=dt, order=order, dtype=dtype, device=device, mesh=mesh)
    ladder = jordan_wigner(excitation_operator(mode, kind))
    if mesh is not None:
        from ..parallel.mesh import shard_input
        from ..parallel.sharded_compiled import ShardedObservable

        gs = shard_input(ground_state, mesh, problem.n_qubits, ev.dtype)
        phi = ShardedObservable.of(ev.engine, ladder).apply(gs, impl=ev.impl)
    else:
        op = Observable(ladder, problem.n_qubits)
        phi = op.apply_auto(as_state(ground_state, ev.device, ev.dtype), impl=ev.impl)
    _, rec = ev.evolve(phi, n_steps, overlaps={"G": phi})
    times = (np.arange(n_steps) + 1) * dt
    # the propagator evolves under H - energy_shift (global phase); the
    # rotating frame therefore uses the same shifted ground energy
    return times, rec["G"] * np.exp(1j * (ground_energy - ev.energy_shift) * times)
