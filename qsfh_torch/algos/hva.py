"""Hamiltonian-Variational-Ansatz VQE driver.

Counterpart of ``qsfh_tpu/algos/hva.py`` (class HVA) with the same
constructor arguments, checkpoint files, result histories and metrics log:

* state prep = the Slater determinant of the occupied momentum modes,
  built once on the device (:func:`engine.circuits.slater_prep_state`);
* each Trotter layer: the Coulomb layer, then the vertical and the
  horizontal hopping classes, one angle each (reference ``hva.py:292-298``);
* parameters: one flat tensor [theta_U (reps+1) | theta_v (reps*Nv) |
  theta_h (reps*Nh)] under one ``torch.optim.Adam``.

``circuit_mode="split"`` (the default; "auto" picks it) is the production
step, composed of stages (``step.raw_stages``): the whole circuit as ONE
rot segment (:func:`hva_program_rot`: the Coulomb layer as shared-angle
Z/ZZ rotations), forward on the kernels, lambda = 2 H psi, the kernels'
adjoint sweep for the gradients, E / Sz / S^2 on the inner-product tiles.
``"unrolled"`` is the cross-check lowering: autograd through the gates of
:mod:`engine.gates` with the Coulomb layer as one diagonal pass.  Entry
points run on ``cuda`` unless ``device`` says otherwise.

``mesh_devices=D > 1`` shards the state over the D ranks of an initialized
``torch.distributed`` group (``qsfh_torch.parallel``; without one the
constructor raises, saying how to start one): the split step on each
rank's shard (``parallel.sharded_hva_shmap``), the same thetas on every
rank, rank 0 alone writing results, checkpoints, metrics and plots.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..engine.circuits import slater_prep_state
from ..engine.compiled import CompiledCircuit, rot_segment, run_rot_adjoint
from ..engine.gates import diagonal_rotation, generator_rotation
from ..engine.kernels import KERNELS
from ..engine.state import ground_fidelity, real_dtype
from ..io import checkpoint as ckpt
from ..io.convert import hva_from_jax, hva_split, hva_to_jax_leaves, load_adam_state
from ..io.metrics import MetricsLogger, plot_energy_fidelity
from ..ops.jw import jordan_wigner
from .base import HubbardProblem, adam_step, default_dtype, resolve_device


def _param_index(reps, Nv, Nh):
    """(U, v, h) -> flat parameter index of [theta_U | theta_v | theta_h]."""
    return (lambda rep: rep,
            lambda rep, i: (reps + 1) + rep * Nv + i,
            lambda rep, i: (reps + 1) + reps * Nv + rep * Nh + i)


def hva_program(reps, v_rot, h_rot, coulomb_diag):
    """The HVA ansatz as a program over a flat theta vector [theta_U (reps+1)
    | theta_v (reps*Nv) | theta_h (reps*Nh)], the Coulomb layer as a
    ``diag`` op on its weight vector (one elementwise pass)."""
    iu, iv, ih = _param_index(reps, len(v_rot), len(h_rot))
    ops = []
    for rep in range(reps):
        ops.append(("diag", coulomb_diag, iu(rep)))
        ops += [("rot", tuple(rot), iv(rep, i)) for i, rot in enumerate(v_rot)]
        ops += [("rot", tuple(rot), ih(rep, i)) for i, rot in enumerate(h_rot)]
    ops.append(("diag", coulomb_diag, iu(reps)))
    return ops


def hva_program_rot(reps, v_rot, h_rot, u_rot):
    """The same program with the Coulomb layer as shared-parameter Z-string
    rotations (JW of the U term is a sum of commuting Z/ZZ strings): the
    whole circuit lowers to ONE rot segment, the kernels' form."""
    iu, iv, ih = _param_index(reps, len(v_rot), len(h_rot))
    ops = []
    for rep in range(reps):
        ops.append(("rot", tuple(u_rot), iu(rep)))
        ops += [("rot", tuple(rot), iv(rep, i)) for i, rot in enumerate(v_rot)]
        ops += [("rot", tuple(rot), ih(rep, i)) for i, rot in enumerate(h_rot)]
    ops.append(("rot", tuple(u_rot), iu(reps)))
    return ops


def flatten_hva_params(params) -> torch.Tensor:
    """The dict {theta_U, theta_v, theta_h} as the flat tensor."""
    return torch.cat([torch.as_tensor(params[k]) for k in ("theta_U", "theta_v", "theta_h")])


def hva_circuit(psi0, n_qubits, coulomb_diag, v_rot, h_rot, reps, thetas):
    """The HVA ansatz on the gates (the unrolled lowering), ``thetas`` flat."""
    iu, iv, ih = _param_index(reps, len(v_rot), len(h_rot))
    psi = psi0
    for rep in range(reps):
        psi = diagonal_rotation(psi, coulomb_diag, thetas[iu(rep)])
        for i, rot in enumerate(v_rot):
            psi = generator_rotation(psi, n_qubits, rot, thetas[iv(rep, i)])
        for i, rot in enumerate(h_rot):
            psi = generator_rotation(psi, n_qubits, rot, thetas[ih(rep, i)])
    return diagonal_rotation(psi, coulomb_diag, thetas[iu(reps)])


class HVA:
    def __init__(
        self,
        n_epoch: int,
        reps: int,
        lr: float,
        threshold: float = 0.0,
        x_dimension: int = 2,
        y_dimension: int = 2,
        n_electrons: int = 4,
        n_spin_up: int = 2,
        n_spin_down: int = 2,
        tunneling: float = 1.0,
        coulomb: float = 6.0,
        periodic: bool = True,
        spinless: bool = False,
        particle_hole_symmetry: bool = False,
        load_model: bool = False,
        dtype=None,
        degenerate_subspace: int = 0,
        early_stop: bool = False,
        results_root: str = "./results",
        plot: bool = True,
        log_metrics: bool = True,
        checkpoint_every: int = 10,
        ground_truth: bool = True,
        circuit_mode: str = "auto",
        device=None,
        ground_state_path: Optional[str] = None,
        mesh_devices: int = 1,
    ):
        """``device``: ``cuda`` by default (raises where none exists).
        ``ground_state_path``: an explicit ground-state cache file instead
        of the one under ``results_root``.  ``mesh_devices``: ranks of the
        amplitude mesh (1: one device; D > 1 needs a process group of D
        ranks: ``parallel.amplitude_mesh``)."""
        self.n_epoch = n_epoch
        self.reps = reps
        self.lr = lr
        self.threshold = threshold
        self.early_stop = early_stop
        self.plot = plot
        self.checkpoint_every = checkpoint_every
        self.device = resolve_device(device)
        self.mesh_devices = int(mesh_devices)
        self.mesh = None
        if self.mesh_devices > 1:
            from ..parallel import amplitude_mesh

            self.mesh = amplitude_mesh(self.mesh_devices, device=self.device)
            self.device = self.mesh.device
        # rank 0 (or the only process) writes results, checkpoints and plots
        self.writes = self.mesh is None or self.mesh.rank == 0
        self.dtype = dtype or default_dtype(self.device)
        self._rdt = real_dtype(self.dtype)
        if circuit_mode == "auto":
            circuit_mode = "split"
        if circuit_mode not in ("split", "unrolled"):
            raise ValueError(
                f"circuit_mode={circuit_mode!r}: use 'split' (default) or "
                "'unrolled' (cross-check lowering)"
            )
        if self.mesh is not None and circuit_mode != "split":
            raise ValueError("mesh_devices > 1 runs the split step on the shards")
        self.circuit_mode = circuit_mode
        # the kernel wrappers; a reference run on the card may set
        # engine.kernels.PLAIN before the step is built
        self.impl = KERNELS

        self.problem = HubbardProblem(
            x_dimension,
            y_dimension,
            tunneling,
            coulomb,
            n_electrons,
            n_spin_up,
            n_spin_down,
            periodic=periodic,
            spinless=spinless,
            particle_hole_symmetry=particle_hole_symmetry,
            results_root=results_root,
        )
        p = self.problem
        self.n_qubits = p.n_qubits

        # ansatz structure
        self.h_generators, self.v_generators = p.hva_generators()
        self.Nh, self.Nv = len(self.h_generators), len(self.v_generators)
        self._h_rot = [g.rotation_terms() for g in self.h_generators]
        self._v_rot = [g.rotation_terms() for g in self.v_generators]
        self._u_rot = jordan_wigner(p.interacting_term).rotation_terms()
        self._coulomb_diag = p.coulomb_diagonal(dtype=self._rdt, device=self.device)
        # the whole circuit as one rot segment: circuit() and the split step
        self._rot_circuit = CompiledCircuit(
            hva_program_rot(reps, self._v_rot, self._h_rot, self._u_rot), self.n_qubits)
        (self._rot_segment,) = self._rot_circuit.segments
        self.sizes = (reps + 1, reps * self.Nv, reps * self.Nh)

        # the Slater determinant of the occupied k-modes, built once
        self._psi0 = slater_prep_state(
            p.n_qubits, p.spin_up_indices + p.spin_down_indices, p.diagonal, p.decomposition,
            dtype=self.dtype, device=self.device,
        )

        # exact ground truth; ground_truth=False skips it (fidelity 0)
        self.degenerate_subspace = degenerate_subspace
        if not ground_truth:
            self.ground_state_energy = None
            gs = []
        elif degenerate_subspace:
            self.ground_state_energy, gs = p.ground_state(
                degenerate=True, n_states=degenerate_subspace, path=ground_state_path,
                device=self.device,
            )
        else:
            self.ground_state_energy, wf = p.ground_state(path=ground_state_path,
                                                          device=self.device)
            gs = [wf]
        self._gs = [torch.as_tensor(w).to(device=self.device, dtype=self.dtype) for w in gs]

        tag = p.tag("HVA", reps=reps)
        self.img_filepath = f"./images/{tag}.png"
        self.result_filepath = os.path.join(results_root, "vqe_results", tag + ".json")
        self.model_filepath = os.path.join(results_root, "saved_model", tag + ".npz")
        self.metrics = MetricsLogger(
            os.path.join(results_root, "vqe_results", tag + ".jsonl")
            if log_metrics and self.writes else None,
            echo=self.writes,
        )

        # the live optimizer (run() keeps it across calls) and Adam state
        # loaded from a checkpoint, installed when run() creates it
        self._optimizer = None
        self._adam_state = None
        if load_model:
            self.load_model()
        else:
            self.params_t = torch.zeros(sum(self.sizes), dtype=self._rdt, device=self.device)
            self.results = {"loss": [], "Sz": [], "S^2": [], "fidelity": []}
        self._step = self._build_step()

    # -- circuit ----------------------------------------------------------------

    @property
    def params(self):
        """The parameters as the JAX driver's dict of numpy arrays."""
        return hva_split(self.params_t, self.sizes)

    def circuit(self, params) -> torch.Tensor:
        """The ansatz state at ``params``, the JAX dict {theta_U, theta_v,
        theta_h} or the flat tensor, differentiable in them: the whole
        circuit as ONE rot segment (:func:`hva_program_rot`) through
        ``engine.compiled.rot_segment`` (the kernels forward, the adjoint
        sweep backward), where the JAX ``HVA.circuit`` runs the gates."""
        if self.mesh is not None:
            raise ValueError("HVA.circuit is the single-device form; on a mesh use state()")
        thetas = flatten_hva_params(params) if isinstance(params, dict) else params
        return rot_segment(self._rot_segment, self._psi0,
                           thetas.to(device=self.device, dtype=self._rdt), self.n_qubits,
                           impl=self.impl)

    def state(self, thetas=None) -> torch.Tensor:
        """The ansatz state (the Coulomb layers as diagonal passes, the
        hopping classes on the kernels; on a mesh the sharded step's
        program, the whole state on every rank)."""
        thetas = self.params_t if thetas is None else thetas
        if self.mesh is not None:
            from ..parallel import gather_statevector

            program, psi0 = self._step.program, self._step.psi0
            return gather_statevector(program.apply(psi0, thetas), self.mesh)
        cc = CompiledCircuit(hva_program(self.reps, self._v_rot, self._h_rot,
                                         self._coulomb_diag), self.n_qubits)
        return cc.apply(self._psi0, thetas, impl=self.impl)

    def _metrics(self, psi, expectation):
        """(Sz, S^2, fidelity) of psi, ``expectation(observable, psi)``."""
        obs = self.problem.observables
        return (expectation(obs["Sz"], psi), expectation(obs["S^2"], psi),
                ground_fidelity(psi, self._gs))

    # -- training ------------------------------------------------------------------

    def _build_stages(self):
        """The split step's stages, as functions on device tensors (the JAX
        HVA's ``raw_stages``): ``fwd`` thetas -> psi; ``fwd_from`` (psi0,
        thetas) -> psi; ``energy`` psi -> E; ``cotangent`` psi -> lambda =
        2 H psi; ``adjoint`` (psi, lambda, thetas) -> gradients; ``metrics``
        psi -> (Sz, S^2, fidelity); ``update`` (thetas, grads, optimizer)
        -> (thetas, optimizer, gnorm), an Adam step in place."""
        obs = self.problem.observables
        impl = self.impl
        n = self.n_qubits
        cc, seg = self._rot_circuit, self._rot_segment

        def fwd_from(psi0, thetas):
            return cc.apply(psi0, thetas, impl=impl)

        def fwd(thetas):
            return fwd_from(self._psi0, thetas)

        def energy(psi):
            return obs["H"].expectation_scan(psi, impl=impl)

        def cotangent(psi):
            return 2.0 * obs["H"].apply_scan(psi, impl=impl)

        def adjoint(psi, lam, thetas):
            return run_rot_adjoint(seg, psi, lam, thetas, n, impl=impl)[2]

        def metrics(psi):
            return self._metrics(psi, lambda o, s: o.expectation_scan(s, impl=impl))

        return dict(fwd=fwd, fwd_from=fwd_from, energy=energy, cotangent=cotangent,
                    adjoint=adjoint, metrics=metrics, update=adam_step)

    def _build_step(self):
        """step(thetas, optimizer) -> (thetas, optimizer, E, Sz, S^2, fid,
        gnorm): updates ``thetas`` in place through ``optimizer`` (a
        ``torch.optim.Adam`` over ``[thetas]``); the metrics are 0-d
        tensors on the device.  Split mode exposes ``step.raw_stages``; on a
        mesh the step is ``parallel.build_sharded_hva_train_step``'s."""
        if self.mesh is not None:
            from ..parallel import build_sharded_hva_train_step

            return build_sharded_hva_train_step(self.problem, self.reps, self.mesh, self.dtype,
                                                self.lr, gs=self._gs, impl=self.impl)[0]
        if self.circuit_mode == "split":
            raw = self._build_stages()

            def step(thetas, optimizer):
                psi = raw["fwd"](thetas)
                energy = raw["energy"](psi)
                grads = raw["adjoint"](psi, raw["cotangent"](psi), thetas)
                sz, s2, fid = raw["metrics"](psi)
                thetas, optimizer, gnorm = raw["update"](thetas, grads, optimizer)
                return thetas, optimizer, energy, sz, s2, fid, gnorm

            step.raw_stages = raw
            return step

        obs = self.problem.observables

        def step(thetas, optimizer):  # "unrolled": autograd through the gates
            th = thetas.detach().requires_grad_(True)
            psi = hva_circuit(self._psi0, self.n_qubits, self._coulomb_diag, self._v_rot,
                              self._h_rot, self.reps, th)
            energy = obs["H"].expectation(psi)
            (grads,) = torch.autograd.grad(energy, th)
            psi = psi.detach()
            sz, s2, fid = self._metrics(psi, lambda o, s: o.expectation(s))
            thetas, optimizer, gnorm = adam_step(thetas, grads, optimizer)
            return thetas, optimizer, energy.detach(), sz, s2, fid, gnorm

        return step

    def _live_optimizer(self) -> torch.optim.Adam:
        """The run's Adam: the live one of an earlier run() call, else a new
        one that takes the checkpoint's state where one was loaded."""
        if self._optimizer is None:
            self._optimizer = torch.optim.Adam([self.params_t], lr=self.lr)
            if self._adam_state is not None:
                load_adam_state(self._optimizer, self.params_t, self._adam_state)
                print("resumed optimizer state from checkpoint")
        self._adam_state = None
        return self._optimizer

    def run(self):
        optimizer = self._live_optimizer()
        i_epoch = len(self.results["loss"])
        while i_epoch < self.n_epoch:
            self.params_t, optimizer, e, sz, s2, fid, gnorm = self._step(self.params_t, optimizer)
            e, sz, s2, fid, gnorm = map(float, (e, sz, s2, fid, gnorm))
            self.results["loss"].append(e)
            self.results["Sz"].append(sz)
            self.results["S^2"].append(s2)
            self.results["fidelity"].append(fid)
            self.metrics.log(
                iter=len(self.results["loss"]),
                loss=e,
                norm=gnorm,
                fidelity=fid,
                Sz=sz,
                S_square=s2,
            )
            if self.plot and self.writes and self.ground_state_energy is not None:
                plot_energy_fidelity(
                    self.img_filepath,
                    self.results["loss"],
                    self.results["fidelity"],
                    self.ground_state_energy,
                    label="HVA",
                )
            if (i_epoch + 1) % self.checkpoint_every == 0:
                self.save_model()
            i_epoch += 1
            if self.early_stop and self.threshold and gnorm < self.threshold:
                break

        self.save_model()
        return self.results

    # -- persistence ------------------------------------------------------------------

    def save_model(self):
        if not self.writes:
            return
        leaves = None
        if self._optimizer is not None:
            leaves = hva_to_jax_leaves(self._optimizer, self.params_t, self.sizes)
        ckpt.save_model(
            self.model_filepath,
            self.params,
            meta={"reps": self.reps, "n_qubits": self.n_qubits},
            opt_leaves=leaves,
        )
        ckpt.save_results(self.result_filepath, self.results)

    def load_model(self):
        if not os.path.exists(ckpt.resolve(self.model_filepath)):
            raise ValueError(f"Please check if the file {self.model_filepath} exists!")
        if not os.path.exists(ckpt.resolve(self.result_filepath)):
            raise ValueError(f"Please check if the file {self.result_filepath} exists!")
        params, _, opt_leaves = ckpt.load_model(self.model_filepath)
        self.params_t, self._adam_state = hva_from_jax(
            params, opt_leaves, device=self.device, dtype=self._rdt
        )
        self._optimizer = None  # loaded leaves supersede any live state
        self.results = ckpt.load_results(self.result_filepath)
