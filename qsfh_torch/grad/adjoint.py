"""Adjoint-method circuit differentiation at the gate level: two live states.

Counterpart of ``qsfh_tpu/grad/adjoint.py``.  :func:`adjoint_apply` is a
``torch.autograd.Function`` over a whole gate program whose backward
replays the gates in reverse (every gate is unitary, a rotation's inverse
is its negated angle) and keeps two live statevectors plus the cotangent,
whatever the depth:

    psi_k      = U_k ... U_1 |psi0>       (recovered by inverse replay)
    lambda_k   = U_{k+1}^dag ... U_T^dag w
    dL/dtheta_k = Im <lambda_k | G_k | psi_k>    (for U_k = exp(-i theta G_k))

where w is torch's gradient of the loss by the output state (2 dL/dpsi*),
so with :func:`expectation_value` (w = 2 c_bar H psi) no intermediate
state is stored.  This is the cross-check of the split lowering, whose
adjoint is the kernels' sweep over one rot segment
(:func:`qsfh_torch.engine.compiled.run_rot_adjoint`).

Program ops:
  ("rot",   rot_terms, param_index)  -- exp(-i theta G), differentiable
  ("fixed", tag, payload)            -- constant gate; tag in
                                        {"rz", "rzlayer", "u4", "se", "x"}
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..engine import gates
from ..engine.circuits import STATIC_RZ_LAYER_MAX_QUBITS
from ..engine.expectation import Observable, expectation_value
from ..engine.state import real_dtype


def givens_network_ops(n_qubits: int, diagonal, decomposition) -> List[tuple]:
    """The Slater/FT Givens network as constant program ops, in the form of
    :func:`qsfh_torch.engine.circuits.apply_givens_network`: one static RZ
    layer and one 4x4 per plan rotation."""
    ops: List[tuple] = []
    angles = tuple(float(np.angle(diagonal[i])) for i in range(n_qubits))
    if n_qubits <= STATIC_RZ_LAYER_MAX_QUBITS:
        ops.append(("fixed", "rzlayer", angles))
    else:
        for i in range(n_qubits):
            ops.append(("fixed", "rz", (angles[i], i)))
    for parallel_ops in reversed(decomposition):
        for op in parallel_ops:
            if op == "pht":
                ops.append(("fixed", "x", (n_qubits - 1,)))
            else:
                i, j, theta, phi = op
                M = gates.givens_plan_matrix(float(theta), float(phi))
                ops.append(("fixed", "u4", (tuple(map(complex, M.ravel())), i, j)))
    return ops


def _apply_op(psi, n, op, thetas, direction=1):
    kind = op[0]
    if kind == "rot":
        _, rot_terms, p_idx = op
        return gates.generator_rotation(psi, n, rot_terms, direction * thetas[p_idx])
    _, tag, payload = op
    if tag == "rz":
        phi, q = payload
        return gates.rz(psi, n, direction * phi, q)
    if tag == "rzlayer":
        phases = gates.static_rz_layer_phases([direction * a for a in payload], n)
        return psi * torch.as_tensor(phases).to(device=psi.device, dtype=psi.dtype)
    if tag == "u4":
        flat, i, j = payload
        M = np.array(flat, dtype=np.complex128).reshape(4, 4)
        if direction < 0:
            M = M.conj().T
        return gates.apply_two_qubit(psi, n, M, i, j)
    if tag == "se":
        ang, i, j = payload
        return gates.single_excitation(psi, n, direction * ang, i, j)
    if tag == "x":
        return gates.pauli_x(psi, n, payload[0])
    raise ValueError(f"unknown op {op}")


def _apply_generator(psi, n, rot_terms):
    """G|psi> for G = sum scale * P (the rotation generator)."""
    out = torch.zeros_like(psi)
    for (x, z, scale) in rot_terms:
        out = out + scale * gates.apply_pauli_string(psi, n, x, z)
    return out


class _AdjointApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, psi0, thetas, n, ops):
        psi = psi0
        for op in ops:
            psi = _apply_op(psi, n, op, thetas)
        ctx.n, ctx.ops = n, ops
        ctx.save_for_backward(psi, thetas)
        return psi

    @staticmethod
    def backward(ctx, w):
        psi, thetas = ctx.saved_tensors
        n = ctx.n
        grads = torch.zeros(thetas.shape, dtype=real_dtype(psi.dtype), device=psi.device)
        lam = w
        for op in reversed(ctx.ops):
            if op[0] == "rot":
                _, rot_terms, p_idx = op
                # Re <w | dpsi/dtheta> = Re <lam | -i G psi> = Im <lam | G psi>
                grads[p_idx] += torch.vdot(lam, _apply_generator(psi, n, rot_terms)).imag
            psi = _apply_op(psi, n, op, thetas, direction=-1)
            lam = _apply_op(lam, n, op, thetas, direction=-1)
        # psi0's cotangent: lam = U_1^dag ... U_T^dag w
        return lam, grads.to(thetas.dtype), None, None


def adjoint_apply(n: int, ops: Sequence[tuple], psi0: torch.Tensor,
                  thetas: torch.Tensor) -> torch.Tensor:
    """|psi> = U_T(theta) ... U_1(theta) |psi0> with adjoint-mode gradients."""
    return _AdjointApply.apply(psi0, thetas, n, tuple(ops))


def build_adjoint_energy(obs: Observable, n: int, ops: Sequence[tuple]):
    """loss(thetas, psi0) -> Re<psi|H|psi> with two-state-memory gradients."""
    ops = tuple(ops)

    def loss(thetas, psi0):
        return expectation_value(obs, adjoint_apply(n, ops, psi0, thetas))

    return loss
