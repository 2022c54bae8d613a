"""Variational Quantum Deflation: excited states via overlap penalties.

Counterpart of ``qsfh_tpu/algos/vqd.py``.  Level ``m`` minimizes

    L_m(theta) = <psi(theta)|H|psi(theta)>
                 + beta * sum_{i<m} |<psi_i|psi(theta)>|^2

(Higgott, Wang & Brierley, Quantum 3, 156 (2019)) over the hardware-
efficient ansatz (``algos.hea``: one rot segment on the kernels) or an
injected circuit such as ``HVA.circuit``.  The energy and the sector
penalties take ``Observable.expectation_auto`` (the inner-product tiles
forward, the application tiles for the cotangent); the overlap penalty is
autograd through ``torch.vdot``.  Converged level states stay on the
device as complex tensors, where the JAX driver holds real (2, 2^n)
planes (a TPU boundary rule).

Initial parameters: the default HEA draw is uniform in +-pi init_scale
from a ``torch.Generator`` seeded with ``seed + level``; a callable
``init_params`` takes that generator where the JAX driver passes a
``PRNGKey`` (the two give different numbers from one seed).  Entry points
run on ``cuda`` unless ``device`` says otherwise.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional

import torch

from ..engine.expectation import Observable
from ..engine.kernels import KERNELS
from ..engine.state import basis_state, fidelity, real_dtype, zero_state
from ..io import checkpoint as ckpt
from ..io.metrics import MetricsLogger
from ..ops.jw import jordan_wigner
from ..ops.pauli import PauliSum
from .base import default_dtype, resolve_device
from .hea import HEASegment


def _leaves(params) -> List[torch.Tensor]:
    """The tensors of a parameter tensor or a dict of them (the pytrees the
    JAX driver takes), in key order for a dict."""
    return list(params.values()) if isinstance(params, dict) else [params]


class VQD:
    """Sequential deflation over ``n_levels`` eigenstates of a Hamiltonian.

    ``hamiltonian`` may be a FermionOperator, a PauliSum, or anything with
    ``get_molecular_hamiltonian()`` (a Molecule).  The spectrum is over the
    FULL Fock space (no sector restriction) unless ``penalty_ops`` or the
    ansatz confine it.
    """

    def __init__(
        self,
        hamiltonian,
        n_qubits: Optional[int] = None,
        n_levels: int = 2,
        n_epoch: int = 300,
        reps: int = 3,
        lr: float = 1e-1,
        beta: float = 5.0,
        threshold: float = 1e-4,
        dtype=None,
        seed: int = 0,
        results_root: str = "./results",
        tag: str = "VQD",
        log_metrics: bool = True,
        penalty_ops=None,
        initial_occupied=None,
        init_scale: Optional[float] = None,
        circuit=None,
        init_params=None,
        device=None,
    ):
        """The JAX driver's arguments plus ``device``.

        ``penalty_ops``: ``(operator, target, weight)`` triples adding
        ``weight * <(O - target)^2>`` to every level's loss (sector
        targeting).  ``initial_occupied``: qubits set to |1> in the HEA's
        start state; the random init then shrinks to ``init_scale * pi``
        (default 0.2).  ``circuit`` / ``init_params``: an injected ansatz
        ``circuit(params) -> psi`` (differentiable torch) and its initial
        parameters (a tensor, a dict of tensors, or a callable taking a
        ``torch.Generator``)."""
        if hasattr(hamiltonian, "get_molecular_hamiltonian"):
            if n_qubits is None:
                n_qubits = hamiltonian.n_qubits
            hamiltonian = hamiltonian.get_molecular_hamiltonian()
        qubit_h = jordan_wigner(hamiltonian)
        if n_qubits is None:
            n_qubits = qubit_h.n_qubits()
        self.n_qubits = n_qubits
        self.device = resolve_device(device)
        self.dtype = dtype or default_dtype(self.device)
        self.observable = Observable(qubit_h, n_qubits)
        self.penalties = []
        for op, target, weight in penalty_ops or []:
            shifted = jordan_wigner(op) - PauliSum.identity(complex(target))
            self.penalties.append(
                (Observable((shifted * shifted).simplify(), n_qubits), float(weight))
            )
        self.n_levels = n_levels
        self.n_epoch = n_epoch
        self.reps = reps
        self.lr = lr
        self.beta = beta
        self.threshold = threshold
        self.seed = seed
        self.initial_occupied = (
            tuple(initial_occupied) if initial_occupied is not None else None
        )
        if init_scale is None:
            init_scale = 0.2 if initial_occupied is not None else 1.0
        self.init_scale = float(init_scale)
        self.circuit = circuit
        self.init_params = init_params
        # the kernel wrappers of the HEA segment and the observables; a
        # reference run on the card may set engine.kernels.PLAIN
        self.impl = KERNELS
        self._hea = None  # the default ansatz's segment, built at first use

        self.energies: List[float] = []
        self.states: List[torch.Tensor] = []  # converged level states (device)
        self.histories: List[List[float]] = []

        self.result_filepath = os.path.join(
            results_root, "vqe_results", f"{tag}-{n_qubits}q-reps{reps}.json"
        )
        self.metrics = MetricsLogger(
            self.result_filepath.replace(".json", ".jsonl") if log_metrics else None
        )

    # -- per-level training ------------------------------------------------------

    def _apply_circuit(self, params) -> torch.Tensor:
        if self.circuit is not None:
            return self.circuit(params)
        if self.initial_occupied is not None:
            psi0 = basis_state(self.n_qubits, self.initial_occupied, dtype=self.dtype,
                               device=self.device)
        else:
            psi0 = zero_state(self.n_qubits, dtype=self.dtype, device=self.device)
        if self._hea is None or self._hea.impl is not self.impl:
            self._hea = HEASegment(self.n_qubits, self.reps, self.impl)
        return self._hea(params, psi0)

    def _initial_params(self, generator: torch.Generator):
        """A level's starting parameters (fresh leaf tensors on the device)."""
        rdt = real_dtype(self.dtype)
        if self.init_params is None:
            u = torch.rand((self.reps + 1, self.n_qubits, 3), generator=generator,
                           dtype=torch.float64)
            return ((2.0 * u - 1.0) * math.pi * self.init_scale).to(self.device, rdt)
        params = self.init_params(generator) if callable(self.init_params) else self.init_params

        def leaf(v):
            return torch.as_tensor(v).detach().to(device=self.device, dtype=rdt).clone()

        if isinstance(params, dict):
            return {k: leaf(v) for k, v in params.items()}
        return leaf(params)

    def _loss(self, params, priors):
        """(loss, energy) at ``params`` against the converged ``priors``."""
        psi = self._apply_circuit(params)
        energy = self.observable.expectation_auto(psi, impl=self.impl)
        loss = energy
        for prior in priors:
            loss = loss + self.beta * fidelity(psi, prior)
        for p_obs, weight in self.penalties:
            loss = loss + weight * p_obs.expectation_auto(psi, impl=self.impl)
        return loss, energy

    def step(self, params, optimizer, priors):
        """One Adam step of ``optimizer`` (over the leaves of ``params``) in
        place: (loss, energy, gnorm) as 0-d tensors on the device, at the
        pre-update parameters; gnorm is the global norm of the gradients."""
        leaves = _leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, energy = self._loss(params, priors)
        grads = torch.autograd.grad(loss, leaves)
        gnorm = torch.sqrt(sum((g * g).sum() for g in grads))
        with torch.no_grad():
            for p, g in zip(leaves, grads):
                p.grad = g
            optimizer.step()
        for p in leaves:
            p.requires_grad_(False)
            p.grad = None
        return loss.detach(), energy.detach(), gnorm

    def run(self) -> List[float]:
        for level in range(len(self.energies), self.n_levels):
            gen = torch.Generator().manual_seed(self.seed + level)
            params = self._initial_params(gen)
            optimizer = torch.optim.Adam(_leaves(params), lr=self.lr)
            priors = list(self.states)
            history: List[float] = []
            for i_epoch in range(self.n_epoch):
                loss, energy, gnorm = self.step(params, optimizer, priors)
                loss, energy, gnorm = float(loss), float(energy), float(gnorm)
                history.append(energy)
                if (i_epoch + 1) % 25 == 0:
                    self.metrics.log(
                        level=level, epoch=i_epoch + 1, loss=loss, energy=energy, norm=gnorm,
                    )
                if gnorm < self.threshold:
                    break
            # <H> at the FINAL parameters: the history holds pre-update
            # iterates, one optimizer step behind the stored level state
            with torch.no_grad():
                psi = self._apply_circuit(params)
                e_final = float(self.observable.expectation_scan(psi, impl=self.impl))
            self.states.append(psi.detach())
            self.energies.append(e_final)
            self.histories.append(history)
            print(f"VQD level {level}: E = {e_final:.8f} ({len(history)} epochs)")
        ckpt.save_results(
            self.result_filepath,
            {"energies": self.energies, "histories": self.histories},
        )
        return self.energies
