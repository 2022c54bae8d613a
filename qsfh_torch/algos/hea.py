"""Hardware-efficient-ansatz VQE for molecules.

Counterpart of ``qsfh_tpu/algos/hea.py`` (the reference's
``models/vqe_hea.py``): ``reps`` layers of per-qubit Rz·Ry·Rx and a ring
of CNOTs, then a final rotation layer on its OWN parameter row ``reps``
(the JAX fix of the reference's off-by-one), Adam with a gradient-norm
stop, tracked against the FCI energy.

``circuit_mode="segment"`` (the default; "auto" picks it) runs the whole
circuit as ONE rot segment on the kernels (:func:`hea_program`): each
rotation is a single-qubit Pauli rotation exp(-i (r/2) P) (Rx first, Y =
i X Z), and each CNOT is exp(i pi/4 (1 - Z_c)(1 - X_t)), a global phase
e^{i pi/4} times three commuting static rotations (pi/4 on Z_c, pi/4 on
X_t, -pi/4 on Z_c X_t).  Forward and backward go through
``engine.compiled.rot_segment`` (the resident kernels from 9 qubits, the
per-term kernels below), the energy through
``Observable.expectation_auto``.  ``"unrolled"`` is the cross-check:
autograd through ``engine.gates.apply_one_qubit`` / ``cnot`` with the
fused 2x2 u3, exactly as the JAX ``hea_circuit`` runs.

The JAX driver draws its initial angles from ``jax.random``, which the
port cannot reproduce: it draws from a ``torch.Generator`` seeded with
``seed``, and runs compared across packages set ``.params`` on both.
Entry points run on ``cuda`` unless ``device`` says otherwise.
"""

from __future__ import annotations

import cmath
import math
import os
import time

import torch

from ..engine.compiled import CompiledCircuit, rot_segment
from ..engine.expectation import Observable
from ..engine.gates import apply_one_qubit, cnot
from ..engine.kernels import KERNELS
from ..engine.state import real_dtype, zero_state
from ..io import checkpoint as ckpt
from ..io.metrics import MetricsLogger, plot_energy_fidelity
from ..ops.jw import jordan_wigner
from .base import adam_step, default_dtype, resolve_device


def _u3(rx, ry, rz, dtype):
    """Rz(rz) @ Ry(ry) @ Rx(rx) as one 2x2 tensor (differentiable in the
    angles, real tensors)."""
    cx, sx = torch.cos(rx / 2).to(dtype), torch.sin(rx / 2).to(dtype)
    cy, sy = torch.cos(ry / 2).to(dtype), torch.sin(ry / 2).to(dtype)
    Rx = torch.stack([torch.stack([cx, -1j * sx]), torch.stack([-1j * sx, cx])])
    Ry = torch.stack([torch.stack([cy, -sy]), torch.stack([sy, cy])])
    ez = torch.exp(-0.5j * rz.to(dtype))
    zero = torch.zeros((), dtype=dtype, device=ez.device)
    Rz = torch.stack([torch.stack([ez, zero]), torch.stack([zero, ez.conj()])])
    return Rz @ Ry @ Rx


def hea_circuit(params, n_qubits: int, reps: int, dtype, psi0=None) -> torch.Tensor:
    """The HEA on the gates (the unrolled lowering): ``reps`` layers of
    fused per-qubit u3 and ring CNOTs, then a final u3 layer on parameter
    row ``reps``; ``params`` a (reps + 1, n, 3) real tensor, ``psi0`` the
    start state (|0...0> on params' device by default)."""
    n = n_qubits
    psi = zero_state(n, dtype=dtype, device=params.device) if psi0 is None else psi0
    for rep in range(reps):
        for q in range(n):
            psi = apply_one_qubit(psi, n, _u3(*params[rep, q], dtype), q)
        for q in range(n):
            psi = cnot(psi, n, q, (q + 1) % n)
    for q in range(n):
        psi = apply_one_qubit(psi, n, _u3(*params[reps, q], dtype), q)
    return psi


def hea_program(n_qubits: int, reps: int):
    """``(ops, global_phase)``: the HEA as one rot segment over the flat
    parameters ``params.reshape(-1)`` (index (row n + q) 3 + j for
    Rx, Ry, Rz), the CNOTs as static rotations (parameter index -1) and
    the phase e^{i pi/4 n reps} of the n reps CNOTs."""
    n = n_qubits
    ops = []

    def u3_layer(row):
        for q in range(n):
            base = 3 * (row * n + q)
            ops.append(("rot", ((1 << q, 0, 0.5),), base))  # Rx = exp(-i r/2 X)
            ops.append(("rot", ((1 << q, 1 << q, 0.5),), base + 1))  # Ry: Y = i X Z
            ops.append(("rot", ((0, 1 << q, 0.5),), base + 2))  # Rz

    quarter = math.pi / 4
    for rep in range(reps):
        u3_layer(rep)
        for q in range(n):
            c, t = 1 << q, 1 << ((q + 1) % n)
            ops.append(("rot", ((0, c, quarter), (t, 0, quarter), (t, c, -quarter)), -1))
    u3_layer(reps)
    return ops, cmath.exp(1j * quarter * n * reps)


class HEASegment:
    """psi(params) = e^{i phi} U(params) psi0 for the HEA's rot segment,
    differentiable in params (``engine.compiled.rot_segment``: the kernels
    forward, the adjoint sweep backward)."""

    def __init__(self, n_qubits: int, reps: int, impl=None):
        ops, self.phase = hea_program(n_qubits, reps)
        (self.segment,) = CompiledCircuit(ops, n_qubits).segments
        self.n = n_qubits
        self.impl = impl or KERNELS

    def __call__(self, params, psi0):
        psi = rot_segment(self.segment, psi0, params.reshape(-1), self.n, self.impl)
        return psi * self.phase


class VQE:
    def __init__(
        self,
        molecule,
        n_epoch: int,
        reps: int,
        lr: float,
        threshold: float,
        dtype=None,
        seed: int = 0,
        results_root: str = "./results",
        plot: bool = True,
        log_metrics: bool = True,
        circuit_mode: str = "auto",
        device=None,
    ):
        """The JAX driver's arguments plus ``circuit_mode`` ("segment", the
        default, or "unrolled") and ``device`` (``cuda`` by default)."""
        self.molecule = molecule
        self.n_epoch = n_epoch
        self.reps = reps
        self.lr = lr
        self.threshold = threshold
        self.plot = plot
        self.device = resolve_device(device)
        self.dtype = dtype or default_dtype(self.device)
        if circuit_mode == "auto":
            circuit_mode = "segment"
        if circuit_mode not in ("segment", "unrolled"):
            raise ValueError(f"circuit_mode={circuit_mode!r}: use 'segment' (default) or "
                             "'unrolled' (cross-check lowering)")
        self.circuit_mode = circuit_mode
        # the kernel wrappers; a reference run on the card may set
        # engine.kernels.PLAIN and rebuild the step
        self.impl = KERNELS

        self.n_qubits = molecule.n_qubits
        self.n_electrons = molecule.n_electrons
        self.n_orbitals = molecule.n_orbitals

        qubit_h = jordan_wigner(molecule.get_molecular_hamiltonian())
        self.observable = Observable(qubit_h, self.n_qubits)

        # random +-pi init (vqe_hea.py:39), from torch's generator
        gen = torch.Generator().manual_seed(seed)
        u = torch.rand((reps + 1, self.n_qubits, 3), generator=gen, dtype=torch.float64)
        self.params = ((2.0 * u - 1.0) * math.pi).to(self.device, real_dtype(self.dtype))
        self.loss_history = []

        mol_name = getattr(molecule, "name", type(molecule).__name__)
        tag = f"HEA-{mol_name}-{self.n_qubits}q-reps{reps}"
        self.img_filepath = f"./images/{tag}.png"
        self.result_filepath = os.path.join(results_root, "vqe_results", tag + ".json")
        self.metrics = MetricsLogger(
            os.path.join(results_root, "vqe_results", tag + ".jsonl") if log_metrics else None
        )
        self._step = self._build_step()

    # -- circuit ----------------------------------------------------------------

    def circuit(self, params) -> torch.Tensor:
        """The ansatz state at ``params`` ((reps + 1, n, 3)), differentiable."""
        psi0 = zero_state(self.n_qubits, dtype=self.dtype, device=self.device)
        if self.circuit_mode == "unrolled":
            return hea_circuit(params, self.n_qubits, self.reps, self.dtype, psi0=psi0)
        return self._segment(params, psi0)

    # -- training ------------------------------------------------------------------

    def _build_step(self):
        """step(params, optimizer) -> (params, optimizer, E, gnorm): one Adam
        step of ``optimizer`` (a ``torch.optim.Adam`` over ``[params]``) in
        place; E and gnorm are 0-d tensors on the device."""
        self._segment = HEASegment(self.n_qubits, self.reps, self.impl)
        obs, impl = self.observable, self.impl

        def energy(psi):
            if self.circuit_mode == "unrolled":
                return obs.expectation(psi)
            return obs.expectation_auto(psi, impl=impl)

        def step(params, optimizer):
            th = params.detach().requires_grad_(True)
            e = energy(self.circuit(th))
            (grads,) = torch.autograd.grad(e, th)
            params, optimizer, gnorm = adam_step(params, grads, optimizer)
            return params, optimizer, e.detach(), gnorm

        return step

    def run(self):
        optimizer = torch.optim.Adam([self.params], lr=self.lr)
        start = time.time()
        for i_epoch in range(self.n_epoch):
            self.params, optimizer, e, gnorm = self._step(self.params, optimizer)
            e, gnorm = float(e), float(gnorm)
            self.loss_history.append(e)
            if (i_epoch + 1) % 5 == 0:
                self.metrics.log(epoch=i_epoch + 1, loss=e, norm=gnorm)
            if gnorm < self.threshold:
                print(f"gradient norm is less than threshold {self.threshold}, break the loop!")
                break
        print(f"total evaluation time: {time.time() - start}s")
        ckpt.save_results(self.result_filepath, {"loss": self.loss_history})
        if self.plot and self.molecule.fci_energy is not None:
            plot_energy_fidelity(
                self.img_filepath,
                self.loss_history,
                [0.0] * len(self.loss_history),
                self.molecule.fci_energy,
                label="hea",
                xlabel="epoch",
            )
        return self.loss_history


if __name__ == "__main__":
    # the reference's __main__ config (models/vqe_hea.py:103-108)
    from ..molecules import H2

    vqe = VQE(H2(r=0.8), n_epoch=100, reps=5, lr=1e-1, threshold=0.002)
    vqe.run()
