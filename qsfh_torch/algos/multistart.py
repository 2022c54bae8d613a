"""Batched multistart VQE: B parameter sets of one ansatz trained together.

Counterpart of ``qsfh_tpu/algos/multistart.py``.  The B starts are the
rows of one parameter tensor (a dict of them for the HVA, as the JAX
driver keeps it), trained by one optimizer over the whole tensor:

* one backward of ``sum_b L_b`` gives each row its own gradient (the rows
  share no parameter);
* ``torch.optim.Adam`` is elementwise, so one Adam over the tensor is a
  per-row Adam, as ``optax.adam`` over the vmapped batch is;
* ``energy_traj[e, b]`` is start b's energy BEFORE update e, and
  ``final_energies`` are evaluated after the last update; both stay on
  the device and are read once at the end.

Each row's circuit runs on its own: the HVA as the one rot segment of
:func:`algos.hva.hva_program_rot` (the resident rotation and adjoint
kernels from 9 qubits, the per-term ones below), the HEA as the rot
segment of :func:`algos.hea.hea_program`; the energy through
``Observable.expectation_auto``.  The initial angles are numpy
``default_rng(seed)`` draws, the JAX driver's, so both packages start from
the same bits.  Entry points run on ``cuda`` unless ``device`` says
otherwise.

The start axis over ranks (``mesh_devices=D``, :func:`start_mesh`): in an
initialized ``torch.distributed`` group of D ranks, rank r trains the rows
[r B/D, (r+1) B/D) of the whole batch, which every rank draws.  The rows
share nothing and Adam is elementwise, so the epochs make no collective,
as the JAX program's scan body compiles to none; after the last epoch the
final parameters, the trajectories and the final energies are gathered in
rank order (``comm.all_gather_cat``), and every rank returns the same full
result, the one process's bits.
"""

from __future__ import annotations

import functools
import math
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from ..engine.circuits import slater_prep_state
from ..engine.compiled import CompiledCircuit, rot_segment
from ..engine.expectation import Observable
from ..engine.kernels import KERNELS
from ..engine.state import real_dtype, zero_state
from ..ops.jw import jordan_wigner
from .base import HubbardProblem, default_dtype, resolve_device
from .hea import hea_program
from .hva import flatten_hva_params, hva_program_rot


def start_mesh(n_devices: Optional[int] = None, backend: Optional[str] = None, device=None):
    """The mesh of the multistart batch axis: the initialized process group
    (``parallel.group_mesh``; any number of ranks, no power-of-two rule).
    Raises where ``n_devices`` is not the group's size, or is above 1 with
    no group."""
    from ..parallel.mesh import group_mesh

    return group_mesh(n_devices, backend, device)


def rank_rows(n_starts: int, mesh) -> slice:
    """The rows of the batch that ``mesh``'s rank trains."""
    per = n_starts // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def _rows(batch_params):
    """(leaves, row(b)) of a (B, ...) tensor or a dict of them."""
    if isinstance(batch_params, dict):
        keys = list(batch_params)
        return [batch_params[k] for k in keys], lambda b: {k: batch_params[k][b] for k in keys}
    return [batch_params], lambda b: batch_params[b]


def batched_train(loss_fn: Callable, batch_params, optimizer: Callable, n_epoch: int,
                  mesh=None):
    """Train every leading-axis row of ``batch_params`` independently.

    ``batch_params``: a (B, ...) tensor or a dict of them (copied, not
    changed); ``loss_fn(row)`` -> a 0-d real tensor, ``row`` the b-th row
    (a dict of rows for a dict); ``optimizer``: a factory of a torch
    optimizer over a list of tensors, e.g. ``functools.partial(
    torch.optim.Adam, lr=lr)`` (the JAX function takes an optax
    transformation).  Each epoch evaluates every row, backpropagates the
    sum and steps the optimizer once.

    Returns ``(final_params, energy_traj, final_energies)`` on the
    parameters' device: ``energy_traj[e, b]`` is start b's energy BEFORE
    update e and ``final_energies[b]`` is evaluated at the final
    parameters.

    ``mesh`` (:func:`start_mesh`, D ranks): ``batch_params`` is the whole
    batch on every rank (B a multiple of D); this rank trains its rows
    (:func:`rank_rows`) with no collective, and the results are gathered
    after the last epoch: every rank returns the whole batch's.
    """
    if mesh is not None and mesh.size > 1:
        leaves, _ = _rows(batch_params)
        n_all = leaves[0].shape[0]
        if n_all % mesh.size:
            raise ValueError(f"{n_all} starts do not divide over {mesh.size} ranks")
        rows = rank_rows(n_all, mesh)
        if isinstance(batch_params, dict):
            batch_params = {k: v[rows] for k, v in batch_params.items()}
        else:
            batch_params = batch_params[rows]
    if isinstance(batch_params, dict):
        params = {k: v.detach().clone().requires_grad_(True) for k, v in batch_params.items()}
    else:
        params = batch_params.detach().clone().requires_grad_(True)
    leaves, row = _rows(params)
    n_starts = leaves[0].shape[0]
    opt = optimizer(leaves)
    traj = []
    for _ in range(n_epoch):
        opt.zero_grad(set_to_none=True)
        vals = torch.stack([loss_fn(row(b)) for b in range(n_starts)])
        vals.sum().backward()
        opt.step()
        traj.append(vals.detach())
    with torch.no_grad():
        final = torch.stack([loss_fn(row(b)) for b in range(n_starts)])
    if isinstance(params, dict):
        final_params = {k: v.detach() for k, v in params.items()}
    else:
        final_params = params.detach()
    if traj:
        traj = torch.stack(traj)
    else:
        traj = torch.zeros((0, n_starts), dtype=final.dtype, device=final.device)
    if mesh is not None and mesh.size > 1:
        from ..parallel.comm import all_gather_cat

        # (rows, epochs) gathered along the rows, then back to (epochs, B)
        if isinstance(final_params, dict):
            final_params = {k: all_gather_cat(v) for k, v in final_params.items()}
        else:
            final_params = all_gather_cat(final_params)
        if n_epoch:
            traj = all_gather_cat(traj.T).T
        else:
            traj = torch.zeros((0, n_starts * mesh.size), dtype=final.dtype, device=final.device)
        final = all_gather_cat(final)
    return final_params, traj, final


def _check_starts(n_starts: int, mesh_devices):
    if n_starts < 1:
        raise ValueError("n_starts must be >= 1")
    if mesh_devices and n_starts % mesh_devices:
        raise ValueError(
            f"n_starts={n_starts} must divide evenly over mesh_devices={mesh_devices}")


def _mesh_and_device(mesh_devices, device):
    """(the start mesh or None, the device): ``mesh_devices`` 0 / None is no
    mesh, as in the JAX driver; the mesh's device is the rank's."""
    if not mesh_devices:
        return None, resolve_device(device)
    mesh = start_mesh(mesh_devices, device=device)
    return mesh, mesh.device


class MultistartHVA:
    """B-start HVA study of one Hubbard instance.

    The physics arguments of ``HVA``; ``n_starts`` starts drawn
    uniform(-init_scale, init_scale) (zero angles are the 2x2 saddle).
    ``batch_params`` is the JAX dict ``{theta_U: (B, reps+1), theta_v: (B,
    reps Nv), theta_h: (B, reps Nh)}`` of tensors on the device (the whole
    batch on every rank).  ``mesh_devices``: the start axis over the D
    ranks of an initialized group (:func:`start_mesh`; D divides B).
    """

    def __init__(
        self,
        n_starts: int,
        n_epoch: int,
        reps: int,
        lr: float,
        x_dimension: int = 2,
        y_dimension: int = 2,
        n_electrons: int = 4,
        n_spin_up: int = 2,
        n_spin_down: int = 2,
        tunneling: float = 1.0,
        coulomb: float = 6.0,
        periodic: bool = True,
        init_scale: float = 0.1,
        seed: int = 0,
        dtype=None,
        mesh_devices: Optional[int] = None,
        ground_truth: bool = True,
        results_root: str = "./results",
        device=None,
    ):
        _check_starts(n_starts, mesh_devices)
        self.n_starts = n_starts
        self.n_epoch = n_epoch
        self.reps = reps
        self.lr = lr
        self.mesh, self.device = _mesh_and_device(mesh_devices, device)
        self.dtype = dtype or default_dtype(self.device)
        rdt = real_dtype(self.dtype)
        self._rdt = rdt
        # the kernel wrappers; a reference run on the card may set PLAIN
        self.impl = KERNELS

        p = HubbardProblem(
            x_dimension=x_dimension,
            y_dimension=y_dimension,
            tunneling=tunneling,
            coulomb=coulomb,
            n_electrons=n_electrons,
            n_spin_up=n_spin_up,
            n_spin_down=n_spin_down,
            periodic=periodic,
            results_root=results_root,
        )
        self.problem = p
        self.n_qubits = p.n_qubits
        h_gen, v_gen = p.hva_generators()
        self._h_rot = [g.rotation_terms() for g in h_gen]
        self._v_rot = [g.rotation_terms() for g in v_gen]
        u_rot = jordan_wigner(p.interacting_term).rotation_terms()
        (self._segment,) = CompiledCircuit(
            hva_program_rot(reps, self._v_rot, self._h_rot, u_rot), self.n_qubits).segments
        self._psi0 = slater_prep_state(
            p.n_qubits, p.spin_up_indices + p.spin_down_indices, p.diagonal, p.decomposition,
            dtype=self.dtype, device=self.device,
        )
        self._obs_h = p.observables["H"]

        Nv, Nh = len(self._v_rot), len(self._h_rot)
        rng = np.random.default_rng(seed)
        np_rdt = np.float32 if rdt == torch.float32 else np.float64

        def init(shape):
            return torch.from_numpy(
                rng.uniform(-init_scale, init_scale, shape).astype(np_rdt)).to(self.device)

        B = n_starts
        self.batch_params = {
            "theta_U": init((B, reps + 1)),
            "theta_v": init((B, reps * Nv)),
            "theta_h": init((B, reps * Nh)),
        }
        if ground_truth:
            from ..parallel.comm import rank_zero_first

            # on a mesh rank 0 solves (or reads) the ED cache first, the
            # other ranks then read the file it wrote
            self.ground_state_energy = float(
                rank_zero_first(lambda: p.ground_state(device=self.device))[0])
        else:
            self.ground_state_energy = None

    def loss(self, params):
        """E of one start: ``params`` the JAX dict of rows or the flat
        [theta_U | theta_v | theta_h] tensor."""
        thetas = flatten_hva_params(params) if isinstance(params, dict) else params
        psi = rot_segment(self._segment, self._psi0, thetas, self.n_qubits, self.impl)
        return self._obs_h.expectation_auto(psi, impl=self.impl)

    def run(self) -> dict:
        return _run_batched(
            self.loss, self.batch_params, self.lr, self.n_epoch, self.mesh,
            reference_energy=self.ground_state_energy,
            reference_key="ground_state_energy",
        )


def _run_batched(loss, batch_params, lr, n_epoch, mesh=None,
                 reference_energy=None, reference_key="reference_energy"):
    final_params, traj, final_e = batched_train(
        loss, batch_params, functools.partial(torch.optim.Adam, lr=lr), n_epoch, mesh=mesh
    )
    e = final_e.double().cpu().numpy()
    traj = traj.double().cpu().numpy()
    finite = np.isfinite(e)
    if not finite.any():
        raise RuntimeError(
            f"all {e.size} starts diverged to non-finite final energies"
        )
    if not finite.all():
        warnings.warn(
            f"{int((~finite).sum())}/{e.size} starts ended non-finite; "
            "selecting best among finite starts",
            stacklevel=2,
        )
    best = int(np.nanargmin(np.where(finite, e, np.inf)))
    if isinstance(final_params, dict):
        best_params = {k: v[best].cpu().numpy() for k, v in final_params.items()}
    else:
        best_params = final_params[best].cpu().numpy()
    result = {
        "energies": traj,
        "final_energies": e,
        "best_index": best,
        "best_energy": float(e[best]),
        "best_params": best_params,
    }
    if reference_energy is not None:
        result[reference_key] = float(reference_energy)
        result["best_gap"] = float(e[best] - reference_energy)
    return result


class MultistartHEA:
    """B-start hardware-efficient VQE on a molecule: the arguments of
    ``hea.VQE`` plus ``n_starts``; the starts are uniform(-pi, pi) draws
    (the reference HEA's band), ``batch_params`` a (B, reps + 1, n, 3)
    tensor; the gap is reported against the molecule's FCI energy when it
    has one.  ``mesh_devices``: the start axis, as for
    :class:`MultistartHVA`."""

    def __init__(
        self,
        molecule,
        n_starts: int,
        n_epoch: int,
        reps: int,
        lr: float,
        seed: int = 0,
        dtype=None,
        mesh_devices: Optional[int] = None,
        device=None,
    ):
        _check_starts(n_starts, mesh_devices)
        self.molecule = molecule
        self.n_starts = n_starts
        self.n_epoch = n_epoch
        self.reps = reps
        self.lr = lr
        self.mesh, self.device = _mesh_and_device(mesh_devices, device)
        self.dtype = dtype or default_dtype(self.device)
        self.n_qubits = molecule.n_qubits
        self.impl = KERNELS

        qubit_h = jordan_wigner(molecule.get_molecular_hamiltonian())
        self._obs = Observable(qubit_h, self.n_qubits)
        ops, self._phase = hea_program(self.n_qubits, reps)
        (self._segment,) = CompiledCircuit(ops, self.n_qubits).segments
        self._psi0 = zero_state(self.n_qubits, dtype=self.dtype, device=self.device)

        rdt = real_dtype(self.dtype)
        np_rdt = np.float32 if rdt == torch.float32 else np.float64
        rng = np.random.default_rng(seed)
        # the reference's +-pi band, one draw per start
        self.batch_params = torch.from_numpy(
            rng.uniform(-math.pi, math.pi, (n_starts, reps + 1, self.n_qubits, 3))
            .astype(np_rdt)).to(self.device)
        self.fci_energy = getattr(molecule, "fci_energy", None)

    def loss(self, params):
        """E of one start, ``params`` its (reps + 1, n, 3) angles."""
        psi = rot_segment(self._segment, self._psi0, params.reshape(-1), self.n_qubits,
                          self.impl) * self._phase
        return self._obs.expectation_auto(psi, impl=self.impl)

    def run(self) -> dict:
        return _run_batched(
            self.loss, self.batch_params, self.lr, self.n_epoch, self.mesh,
            reference_energy=self.fci_energy, reference_key="fci_energy",
        )
