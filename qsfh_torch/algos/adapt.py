"""ADAPT-VQE driver: adaptive ansatz growth with batched pool screening.

Counterpart of ``qsfh_tpu/algos/adapt.py`` (class ADAPT) with the same
constructor arguments, selection rule, training loop, checkpoint files and
result histories.  The ansatz acts in momentum space before the Givens
network Fourier-transforms to real space.

* Selection: dE/de_k = 2 Im <w | G_k psi_k> with w = U_net^dag H U_net
  psi_k, for every pool generator in one launch of the inner-product tile
  kernel, the coefficients folded in (:meth:`PackedPool.screen_scan`).
* Train step: forward (one rot segment: ansatz + network) -> energy ->
  cotangent lambda = 2 H psi -> adjoint gradients -> Sz, S^2, fidelity ->
  Adam update.  Gradients come from the reverse adjoint sweep, two live
  statevectors.  The step is composed from :meth:`ADAPT._build_stages`,
  the JAX ADAPT's ``raw_stages``, which the chunked runner
  (:mod:`qsfh_torch.algos.adapt_fused`) composes K times into one CUDA
  graph.

``circuit_mode="unrolled"`` is the cross-check lowering of the JAX driver
(``qsfh_tpu/algos/adapt.py:537-556``): the same step on the gates of
:mod:`qsfh_torch.engine.gates`, its gradients from the gate-level adjoint
(:func:`qsfh_torch.grad.adjoint.adjoint_apply`) at or above
``adjoint_threshold`` qubits and from autograd below it; it checks that
the kernels' adjoint sweep equals autodiff.  The default ("auto" picks
"split") is the kernel route above.  The JAX driver's ``program_salt`` (a
TPU compile-cache workaround) is gone.  Entry points run on ``cuda`` unless
``device`` says otherwise.

``mesh_devices=D > 1`` shards the state over the D ranks of an initialized
``torch.distributed`` group (``qsfh_torch.parallel``: started by
``parallel.spawn_ranks`` or ``torchrun``; without one the constructor
raises, saying so): the selection and the train step run on each rank's
shard (``parallel.sharded_adapt``), every rank selects the same operators
and holds the same thetas, and rank 0 alone writes results, checkpoints,
metrics and plots, in the single-card schema.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from ..engine.circuits import apply_givens_network
from ..engine.compiled import CompiledCircuit, givens_network_static_ops, run_rot_adjoint
from ..engine.dfloat import expectation_norm_df
from ..engine.expectation import PackedPool, expectation_value
from ..engine.gates import generator_rotation
from ..engine.kernels import KERNELS
from ..engine.state import basis_state, ground_fidelity, real_dtype
from ..grad.adjoint import adjoint_apply, givens_network_ops
from ..io import checkpoint as ckpt
from ..io.metrics import MetricsLogger, plot_energy_iterations
from ..ops.jw import jordan_wigner
from ..ops.pool import hubbard_interaction_pool_simplified
from ..utils.profiling import PhaseTimer
from .base import HubbardProblem, adam_step, default_dtype, resolve_device


class ADAPT:
    def __init__(
        self,
        n_epoch: int,
        threshold1: float,
        threshold2: float,
        x_dimension: int,
        y_dimension: int,
        n_electrons: int,
        n_spin_up: int,
        n_spin_down: int,
        tunneling: float,
        coulomb: float,
        periodic: bool = True,
        spinless: bool = False,
        particle_hole_symmetry: bool = False,
        load_model: bool = False,
        ratio: float = 0.1,
        lr_scale: float = 0.05,
        max_inner_iterations: int = 10000,
        dtype=None,
        degenerate_subspace: int = 0,
        results_root: str = "./results",
        plot: bool = True,
        log_metrics: bool = True,
        pool=None,
        ground_truth: bool = True,
        device=None,
        ground_state_path: Optional[str] = None,
        adjoint_threshold: Optional[int] = None,
        circuit_mode: str = "auto",
        mesh_devices: int = 1,
    ):
        """``device``: ``cuda`` by default (raises where none exists).
        ``ground_state_path``: an explicit ground-state cache file instead
        of the one under ``results_root``.  ``circuit_mode``: "split" (the
        default; "auto" picks it) or "unrolled", the cross-check lowering,
        which takes its gradients from the gate-level adjoint from
        ``adjoint_threshold`` qubits on (default 0 on the CPU, where the
        adjoint is faster at every size, else 20, the reference's
        crossover) and from autograd below.  ``mesh_devices``: ranks of the
        amplitude mesh (1: one device; D > 1 needs a process group of D
        ranks, each on its device: ``parallel.amplitude_mesh``)."""
        self.n_epoch = n_epoch
        self.threshold1 = threshold1
        self.threshold2 = threshold2
        self.ratio = ratio
        self.lr_scale = lr_scale
        self.max_inner_iterations = max_inner_iterations
        self.plot = plot
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
        if adjoint_threshold is None:
            adjoint_threshold = 0 if self.device.type == "cpu" else 20
        self.adjoint_threshold = adjoint_threshold
        # the kernel wrappers; a reference run on the card may set
        # engine.kernels.PLAIN before the first selection or step
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

        self.fermion_pool = (
            pool
            if pool is not None
            else hubbard_interaction_pool_simplified(x_dimension, y_dimension)
        )
        self.qubit_pool = [jordan_wigner(g) for g in self.fermion_pool]
        self.pool_rot = [g.rotation_terms() for g in self.qubit_pool]
        self.packed_pool = PackedPool(self.qubit_pool, self.n_qubits)

        # k-space initial state: occupied lowest momentum modes
        self._occupied_modes = tuple(p.spin_up_indices + p.spin_down_indices)
        self._net_ops, self._net_phase = givens_network_static_ops(
            self.n_qubits, p.diagonal, p.decomposition
        )

        # exact ground truth
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

        tag = p.tag("ADAPT")
        self.img_filepath = f"./images/{tag}.png"
        self.result_filepath = os.path.join(results_root, "vqe_results", tag + ".json")
        self.model_filepath = os.path.join(results_root, "saved_model", tag + ".npz")
        self.metrics = MetricsLogger(
            os.path.join(results_root, "vqe_results", tag + ".jsonl")
            if log_metrics and self.writes else None,
            echo=self.writes,
        )

        self._rdt = real_dtype(self.dtype)
        if load_model:
            self.load_model()
        else:
            self.selected_indices: List[int] = []
            self.params_t = torch.zeros(0, dtype=self._rdt, device=self.device)
            self.results = {
                "epoch loss": [],
                "iteration loss": [],
                "Sz": [],
                "S^2": [],
                "fidelity": [],
                "n_params": [],
                "selected operators": [],
            }
        self._screen_cache = {}

    # -- circuit pieces ----------------------------------------------------------

    def _initial_state(self) -> torch.Tensor:
        return basis_state(self.n_qubits, self._occupied_modes, self.dtype, self.device)

    def _ansatz_ops(self, indices):
        return [("rot", tuple(self.pool_rot[i]), slot) for slot, i in enumerate(indices)]

    def _ansatz_k(self, thetas, indices) -> torch.Tensor:
        """k-space ansatz on the gates: exp(-i theta_i G_i) over the
        selected pool operators."""
        psi = self._initial_state()
        for slot, idx in enumerate(indices):
            psi = generator_rotation(psi, self.n_qubits, self.pool_rot[idx], thetas[slot])
        return psi

    def _to_real(self, psi_k) -> torch.Tensor:
        """The Givens network on the gates (no global phase: the JAX form)."""
        return apply_givens_network(psi_k, self.n_qubits, self.problem.diagonal,
                                    self.problem.decomposition)

    def state(self, thetas=None) -> torch.Tensor:
        """Real-space ansatz state (on a mesh: the whole state, on every
        rank)."""
        thetas = self.params_t if thetas is None else thetas
        if self.mesh is not None:
            from ..parallel import gather_statevector
            from ..parallel.sharded_compiled import ShardedRotations
            from ..parallel.shmap_engine import ShardedPauliEngine

            engine = ShardedPauliEngine(self.n_qubits, self.mesh, self.impl)
            program = ShardedRotations(
                engine, self._ansatz_ops(self.selected_indices) + self._net_ops, self._net_phase)
            psi0 = engine.basis_state(self._occupied_modes, self.dtype)
            return gather_statevector(program.apply(psi0, thetas), self.mesh)
        cc = CompiledCircuit(
            self._ansatz_ops(self.selected_indices) + self._net_ops,
            self.n_qubits,
            global_phase=self._net_phase,
        )
        return cc.apply(self._initial_state(), thetas, impl=self.impl)

    # -- operator selection -------------------------------------------------------

    def _screen_for(self, indices: tuple):
        """Screening fn(thetas) -> |pool| gradients for one ansatz shape."""
        if indices in self._screen_cache:
            return self._screen_cache[indices]
        impl = self.impl
        if self.mesh is not None:
            from ..parallel.sharded_adapt import build_sharded_screen_fn

            fn = build_sharded_screen_fn(self.problem, self.pool_rot, list(indices),
                                         self.packed_pool, self.mesh, self.dtype, impl)
            self._screen_cache[indices] = fn
            return fn
        ansatz = CompiledCircuit(self._ansatz_ops(indices), self.n_qubits)
        net = CompiledCircuit(self._net_ops, self.n_qubits, global_phase=self._net_phase)
        h = self.problem.observables["H"]
        empty = torch.zeros(0, dtype=self._rdt, device=self.device)

        def fn(thetas):
            psi_k = ansatz.apply(self._initial_state(), thetas, impl=impl)
            w_r = h.apply_scan(net.apply(psi_k, empty, impl=impl), impl=impl)
            w_k = net.apply_inverse(w_r, empty, impl=impl)
            return self.packed_pool.screen_scan(psi_k, w_k, impl=impl)

        self._screen_cache[indices] = fn
        return fn

    def select_operator(self):
        """Batched pool-gradient screening.

        Returns (selected_indices, max_grads) with the reference's selection
        rule: |g| >= max(ratio * g_max) AND |g| >= threshold1, sorted by
        descending |g|.
        """
        fn = self._screen_for(tuple(self.selected_indices))
        grads = np.abs(fn(self.params_t).cpu().numpy())
        max_grad = grads.max() if grads.size else 0.0
        mask = (grads >= max_grad * self.ratio) & (grads >= self.threshold1)
        chosen = np.flatnonzero(mask)
        # stable order WITHIN the selected set: descending rounded |g|, ties
        # broken by pool index (symmetric lattices give exactly degenerate
        # pool gradients)
        order = chosen[np.lexsort((chosen, -np.round(grads[chosen], 10)))]
        return [int(i) for i in order], [float(grads[i]) for i in order]

    # -- training ------------------------------------------------------------------

    def _build_stages(self, indices):
        """The train step's stages for one ansatz shape, as functions on
        device tensors (the JAX ADAPT's ``raw_stages``): ``fwd_from``
        (psi0, thetas) -> psi; ``energy`` psi -> E; ``cotangent`` psi ->
        lambda = 2 H psi; ``adjoint`` (psi, lambda, thetas) -> gradients;
        ``metrics`` psi -> (Sz, S^2, fidelity); ``update`` (thetas, grads,
        optimizer) -> (thetas, optimizer, gnorm), an Adam step in place;
        the merged ``cot_e`` psi -> (lambda, E = 1/2 Re <psi|lambda>, no
        separate H pass) and ``adj_upd`` (psi, lambda, thetas, optimizer)
        -> ``update`` of the ``adjoint`` gradients; and ``energy_df`` psi
        -> the float64 Rayleigh readout of H (:mod:`qsfh_torch.engine.dfloat`).
        One device only: on a mesh the step is the sharded one.
        """
        if self.mesh is not None:
            raise ValueError("the stage form (and the fused runner) runs on one device; "
                             "mesh_devices > 1 runs the sharded step")
        obs = self.problem.observables
        impl = self.impl
        n = self.n_qubits
        cc = CompiledCircuit(
            self._ansatz_ops(indices) + self._net_ops, n, global_phase=self._net_phase
        )
        assert len(cc.segments) == 1 and cc.segments[0].kind == "rot"
        seg = cc.segments[0]
        gs = self._gs

        def fwd_from(psi0, thetas):
            return cc.apply(psi0, thetas, impl=impl)

        def energy(psi):
            return obs["H"].expectation_scan(psi, impl=impl)

        def cotangent(psi):
            return 2.0 * obs["H"].apply_scan(psi, impl=impl)

        def adjoint(psi, lam, thetas):
            return run_rot_adjoint(seg, psi, lam, thetas, n, impl=impl)[2]

        def metrics(psi):
            sz = obs["Sz"].expectation_scan(psi, impl=impl)
            s2 = obs["S^2"].expectation_scan(psi, impl=impl)
            return sz, s2, ground_fidelity(psi, gs)

        update = adam_step

        def cot_e(psi):
            lam = cotangent(psi)
            return lam, 0.5 * torch.vdot(psi, lam).real

        def adj_upd(psi, lam, thetas, optimizer):
            return update(thetas, adjoint(psi, lam, thetas), optimizer)

        def energy_df(psi):
            return expectation_norm_df(psi, n, obs["H"], impl=impl)

        return dict(fwd_from=fwd_from, energy=energy, cotangent=cotangent, adjoint=adjoint,
                    metrics=metrics, update=update, cot_e=cot_e, adj_upd=adj_upd,
                    energy_df=energy_df)

    def _build_step(self, indices):
        """step(thetas, optimizer) -> (thetas, optimizer, E, Sz, S^2, fid, gnorm),
        composed from :meth:`_build_stages` (``step.raw_stages``), or the
        unrolled cross-check step (:meth:`_build_step_unrolled`).

        Updates ``thetas`` in place through ``optimizer`` (a
        ``torch.optim.Adam`` over ``[thetas]``); the metrics are 0-d
        tensors on the device.
        """
        if self.mesh is not None:
            from ..parallel.sharded_adapt import build_sharded_adapt_train_step

            return build_sharded_adapt_train_step(self.problem, self.pool_rot, list(indices),
                                                  self.mesh, self.dtype, gs=self._gs,
                                                  impl=self.impl)[0]
        if self.circuit_mode == "unrolled":
            return self._build_step_unrolled(indices)
        raw = self._build_stages(indices)
        psi0 = self._initial_state()

        def step(thetas, optimizer):
            psi = raw["fwd_from"](psi0, thetas)
            energy = raw["energy"](psi)
            lam = raw["cotangent"](psi)
            grads = raw["adjoint"](psi, lam, thetas)
            sz, s2, fid = raw["metrics"](psi)
            thetas, optimizer, gnorm = raw["update"](thetas, grads, optimizer)
            return thetas, optimizer, energy, sz, s2, fid, gnorm

        step.raw_stages = raw
        return step

    def _build_step_unrolled(self, indices):
        """The cross-check step on the gates: from ``adjoint_threshold``
        qubits on, the ansatz and the Givens network as one program under
        :func:`adjoint_apply` and the energy with its analytic cotangent;
        below it, autograd through :meth:`_ansatz_k` and :meth:`_to_real`.
        Sz, S^2 in the plain unrolled forms."""
        obs = self.problem.observables
        n = self.n_qubits
        if n >= self.adjoint_threshold:
            ops = tuple(self._ansatz_ops(indices)
                        + givens_network_ops(n, self.problem.diagonal, self.problem.decomposition))

            def loss_fn(thetas):
                psi = adjoint_apply(n, ops, self._initial_state(), thetas)
                return expectation_value(obs["H"], psi), psi
        else:

            def loss_fn(thetas):
                psi = self._to_real(self._ansatz_k(thetas, indices))
                return obs["H"].expectation(psi), psi

        def step(thetas, optimizer):
            th = thetas.detach().requires_grad_(True)
            energy, psi = loss_fn(th)
            (grads,) = torch.autograd.grad(energy, th)
            psi = psi.detach()
            sz, s2 = obs["Sz"].expectation(psi), obs["S^2"].expectation(psi)
            fid = ground_fidelity(psi, self._gs)
            thetas, optimizer, gnorm = adam_step(thetas, grads, optimizer)
            return thetas, optimizer, energy.detach(), sz, s2, fid, gnorm

        return step

    def run(self):
        timer = PhaseTimer()
        self.timer = timer
        say = print if self.writes else (lambda *a, **k: None)
        if self.ground_state_energy is not None:
            say("ground state energy: ", self.ground_state_energy)
        i_epoch = len(self.results["epoch loss"])

        while i_epoch < self.n_epoch:
            with timer.phase("screening"):
                new_indices, max_grads = self.select_operator()
            if not new_indices:
                say("\nconvergence criterion has satisfied, break the loop!")
                break

            self.selected_indices += new_indices
            self.params_t = torch.cat(
                [self.params_t, torch.zeros(len(new_indices), dtype=self._rdt, device=self.device)]
            )
            self.results["selected operators"] += [
                repr(self.fermion_pool[i]).replace("\n", " ") for i in new_indices
            ]
            self.results["n_params"].append(len(self.selected_indices))

            # dynamic learning rate (reference adapt_vqe.py:392)
            n_new = len(new_indices)
            lr = float(np.linalg.norm(max_grads) / np.sqrt(n_new) * self.lr_scale)
            optimizer = torch.optim.Adam([self.params_t], lr=lr)
            say(f"epoch {i_epoch + 1}: selected {n_new} operators, lr = {lr:.6f}")

            with timer.phase("step build"):
                step = self._build_step(tuple(self.selected_indices))
            inner = 0
            while inner < self.max_inner_iterations:
                with timer.phase("inner iteration"):
                    self.params_t, optimizer, e, sz, s2, fid, gnorm = step(
                        self.params_t, optimizer
                    )
                    # the host read is the sync point; keep it in the phase
                    e, sz, s2, fid, gnorm = map(float, (e, sz, s2, fid, gnorm))
                self.results["iteration loss"].append(e)
                self.results["Sz"].append(sz)
                self.results["S^2"].append(s2)
                self.results["fidelity"].append(fid)
                self.metrics.log(
                    iter=len(self.results["iteration loss"]),
                    loss=e,
                    norm=gnorm,
                    fidelity=fid,
                    Sz=sz,
                    S_square=s2,
                )
                inner += 1
                if gnorm < self.threshold2:
                    break

            self.results["epoch loss"].append(self.results["iteration loss"][-1])
            i_epoch += 1
            with timer.phase("checkpoint"):
                self.save_model()
            if self.plot and self.writes and self.ground_state_energy is not None:
                plot_energy_iterations(
                    self.img_filepath,
                    self.results["iteration loss"],
                    self.results["epoch loss"],
                    self.ground_state_energy,
                )

        say(timer.report())
        return self.results

    def get_ground_state_properties(self):
        """Print the exact ground state's observables: energy, particle
        number, and Sz and S^2 of each cached ED state on the expectation
        route (the inner-product tiles on the card)."""
        print("ground state energy: ", self.ground_state_energy)
        print("particle number: ", self.problem.n_electrons)
        obs = self.problem.observables
        for i, psi in enumerate(self._gs):
            tag = f" [{i}]" if len(self._gs) > 1 else ""
            print(f"Sz{tag}: ", round(float(obs["Sz"].expectation_scan(psi, impl=self.impl)), 6))
            print(f"S^2{tag}: ", round(float(obs["S^2"].expectation_scan(psi, impl=self.impl)), 6))
        print("")

    # -- persistence ------------------------------------------------------------------

    def save_model(self):
        if not self.writes:
            return
        ckpt.save_model(
            self.model_filepath,
            {
                "t": self.params_t.detach().cpu().numpy(),
                "selected_indices": np.asarray(self.selected_indices, dtype=np.int64),
            },
            meta={"n_qubits": self.n_qubits, "pool_size": len(self.fermion_pool)},
        )
        ckpt.save_results(self.result_filepath, self.results)

    def load_model(self):
        if not os.path.exists(ckpt.resolve(self.model_filepath)):
            raise ValueError(f"Please check if the file {self.model_filepath} exists!")
        if not os.path.exists(ckpt.resolve(self.result_filepath)):
            raise ValueError(f"Please check if the file {self.result_filepath} exists!")
        params, meta, _ = ckpt.load_model(self.model_filepath)
        # a checkpoint whose pool is SMALLER resumes under a pool that
        # extends it; a LARGER recorded pool has indices this pool lacks
        ckpt_pool = meta.get("pool_size") if meta else None
        if ckpt_pool is not None and ckpt_pool > len(self.fermion_pool):
            raise ValueError(
                f"checkpoint was written with a larger pool "
                f"({ckpt_pool} ops vs {len(self.fermion_pool)}); resume "
                f"with a pool that extends the recorded one"
            )
        self.params_t = torch.as_tensor(params["t"]).to(device=self.device, dtype=self._rdt)
        self.selected_indices = [int(i) for i in params["selected_indices"]]
        if self.selected_indices and max(self.selected_indices) >= len(self.fermion_pool):
            raise ValueError("checkpoint selects pool indices beyond the current pool")
        self.results = ckpt.load_results(self.result_filepath)
