"""Lanczos resolvent spectroscopy: spectral functions without time evolution.

Counterpart of ``qsfh_tpu/linalg/spectral.py``: seed a Krylov space from
the excited vector ``|phi> = c^(dag)_m |gs>``, tridiagonalize H in it, and
read the resolvent

    R(omega) = <phi| [(omega + i eta) - (H - E0)]^{-1} |phi>

off the small tridiagonal: every pole and weight in one Lanczos run
(peaks of ``-Im R / pi`` at the (N+-1)-sector excitation energies
``E_n - E0``, the convention of ``algos/dynamics.greens_function``).

The recursion keeps three vectors on the state's device and no basis (no
reorthogonalization: deep runs can produce near-zero-weight "ghost"
poles, which broaden away).  H psi is ``Observable.apply_auto``: the
application tiles (``pauli_apply_grouped``) on the card.  Alpha and beta
stay on the device for all m steps and are read once; the run is
truncated at Krylov breakdown on the host afterwards.  ``device``: where a
numpy ground state goes (``resolve_device``); a tensor is read on its
device.  ``impl``: the kernel wrappers (``engine.kernels.KERNELS``) or the
plain versions (``PLAIN``, e.g. a complex128 reference run on the card).

``mesh`` (``parallel.amplitude_mesh``): the recursion on the rank's
shards.  ``matvec`` maps a shard to its shard; alpha and beta are
rank-order sums (two a step: the update needs alpha before beta), norm2 a
float64 one, so every rank holds the same coefficients.  The drivers build
|phi> on the shards (``ShardedObservable.apply``: the ladder's cross terms
on the partner's shard) and H psi is ``ShardedObservable.apply``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.linalg
import torch

from ..algos.base import default_dtype, resolve_device, state_on_device
from ..algos.dynamics import apply_on_host, excitation_operator
from ..engine.expectation import Observable
from ..engine.kernels import KERNELS
from ..engine.state import real_dtype
from ..ops.correlations import charge_q_operator, spin_q_operator
from ..ops.jw import jordan_wigner

__all__ = [
    "lanczos_tridiagonal",
    "resolvent_poles",
    "spectral_function_lanczos",
    "dynamical_structure_factor",
]


def lanczos_tridiagonal(matvec, phi, m: int, device=None, mesh=None, n_qubits=None
                        ) -> Tuple[np.ndarray, np.ndarray, float]:
    """``m`` Lanczos steps from ``phi`` keeping three vectors.

    Returns host ``(alphas, betas, norm2)``: the tridiagonal coefficients
    (``betas[j] = ||w_j||`` produced at step j; the off-diagonals of T are
    ``betas[:-1]``) and ``norm2 = <phi|phi>`` in float64.  The recursion
    runs in phi's dtype on phi's device (a numpy phi goes to
    ``resolve_device(device)``), reading the coefficients once at the end.

    ``mesh``: ``phi`` is the rank's shard, or the whole state where it has
    ``2**n_qubits`` entries (then sharded here); ``matvec`` maps the rank's
    shard to its shard; every rank returns the same coefficients.
    """
    if mesh is None:
        phi = state_on_device(phi, device)
        norm2 = float(torch.linalg.vector_norm(phi.to(torch.complex128)) ** 2)

        def norm(w):
            return torch.linalg.vector_norm(w)

        def dot(v, w):
            return torch.vdot(v, w)
    else:
        from ..parallel import comm
        from ..parallel.mesh import shard_input, sharded_norm2

        phi = phi if torch.is_tensor(phi) else torch.from_numpy(np.array(phi))
        if n_qubits is not None:
            phi = shard_input(phi, mesh, n_qubits, phi.dtype)
        phi = phi.to(mesh.device)
        norm2 = sharded_norm2(phi)

        def norm(w):
            return torch.sqrt(comm.all_sum(torch.vdot(w, w).real))

        def dot(v, w):
            return comm.all_sum(torch.vdot(v, w))
    if norm2 < 1e-28:
        return np.zeros(0), np.zeros(0), 0.0
    rdt = real_dtype(phi.dtype)
    v = phi / norm(phi)
    v_prev = torch.zeros_like(v)
    beta_prev = torch.zeros((), dtype=rdt, device=v.device)
    alphas, betas = [], []
    for _ in range(m):
        w = matvec(v)
        alpha = dot(v, w).real.to(rdt)
        w = w - alpha * v - beta_prev * v_prev
        beta = norm(w).to(rdt)
        v_next = torch.where(beta > 1e-14, w / torch.clamp(beta, min=1e-30), w * 0)
        v_prev, v, beta_prev = v, v_next, beta
        alphas.append(alpha)
        betas.append(beta)
    coeffs = torch.stack([torch.stack(alphas), torch.stack(betas)]).to(torch.float64).cpu().numpy()
    alphas, betas = coeffs[0], coeffs[1]
    # truncate at Krylov breakdown (exhausted invariant subspace)
    dead = np.nonzero(betas < 1e-12)[0]
    if dead.size:
        keep = int(dead[0]) + 1
        alphas, betas = alphas[:keep], betas[:keep]
    return alphas, betas, norm2


def resolvent_poles(
    alphas: np.ndarray, betas: np.ndarray, norm2: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Poles (absolute H eigenvalues of T) and weights of
    ``norm2 * e1^T [z - T]^{-1} e1``: ``weights = norm2 * |evec[0, :]|^2``.
    Sum rule: ``weights.sum() == norm2`` exactly.
    """
    if alphas.size == 0:
        return np.zeros(0), np.zeros(0)
    theta, vecs = scipy.linalg.eigh_tridiagonal(alphas, betas[:-1])
    return theta, norm2 * np.abs(vecs[0, :]) ** 2


def spectral_function_lanczos(
    problem,
    ground_state,
    ground_energy: float,
    mode,
    kind: str = "particle",
    m: int = 100,
    omegas: Optional[np.ndarray] = None,
    eta: float = 0.05,
    dtype=None,
    device=None,
    impl=None,
    mesh=None,
):
    """Single-particle spectral function via the Lanczos resolvent.

    ``mode`` is a JW mode index or a :class:`FermionOperator` (``kind`` =
    'particle' / 'hole').  ``|phi>`` is the ladder operator applied to the
    ground state on the host in complex128 (``dynamics.apply_on_host``),
    then cast to ``dtype`` (complex64 on the card by default) on the
    device.  Returns a dict with the discrete ``poles`` (excitation
    energies ``E_n - E0``), their ``weights`` (``sum = <phi|phi>``), and,
    when ``omegas`` is given, the broadened
    ``A(omega) = sum_k w_k * eta/pi / ((omega - pole_k)^2 + eta^2)``.
    ``mesh``: the recursion on the shards (``ground_state`` whole or the
    rank's shard, in ``dtype`` on the rank's device), |phi> built there by
    the partner apply; every rank returns the same result.
    """
    impl = impl or KERNELS
    ladder_op = jordan_wigner(excitation_operator(mode, kind))
    if mesh is not None:
        from ..parallel.mesh import shard_input
        from ..parallel.sharded_compiled import ShardedObservable
        from ..parallel.shmap_engine import ShardedPauliEngine

        dtype = dtype or default_dtype(mesh.device)
        engine = ShardedPauliEngine(problem.n_qubits, mesh)
        gs = shard_input(ground_state, mesh, problem.n_qubits, dtype)
        phi = ShardedObservable.of(engine, ladder_op).apply(gs, impl=impl)
        ham = ShardedObservable.of(engine, problem.qubit_hamiltonian)
        alphas, betas, norm2 = lanczos_tridiagonal(lambda v: ham.apply(v, impl=impl), phi, m,
                                                   mesh=mesh)
    else:
        dev = ground_state.device if torch.is_tensor(ground_state) else resolve_device(device)
        dtype = dtype or default_dtype(dev)
        ladder = Observable(ladder_op, problem.n_qubits)
        phi = torch.from_numpy(apply_on_host(ladder, ground_state, dtype)).to(dev)
        ham = problem.observables["H"]
        alphas, betas, norm2 = lanczos_tridiagonal(lambda v: ham.apply_auto(v, impl), phi, m)
    theta, weights = resolvent_poles(alphas, betas, norm2)
    poles = theta - float(ground_energy)
    out = {"poles": poles, "weights": weights, "norm2": norm2}
    if omegas is not None:
        omegas = np.asarray(omegas, dtype=np.float64)
        lor = (eta / np.pi) / ((omegas[:, None] - poles[None, :]) ** 2 + eta**2)
        out["omegas"] = omegas
        out["A"] = lor @ weights
    return out


def dynamical_structure_factor(
    problem,
    ground_state,
    ground_energy: float,
    q: Tuple[int, int],
    kind: str = "spin",
    m: int = 100,
    omegas: Optional[np.ndarray] = None,
    eta: float = 0.05,
    dtype=None,
    device=None,
    impl=None,
    mesh=None,
):
    """Dynamical spin/charge structure factor via the Lanczos resolvent:
    ``S^{zz}(q, omega)`` (``kind='spin'``) or ``N(q, omega)``
    (``kind='charge'``), seeded from ``O_q|gs>`` with ``O_q = S^z_q`` /
    ``n_q`` (``ops/correlations.py``; the charge operator mean-subtracted
    at ``q = 0`` with the problem's filling).  Sum rule: ``sum(weights) =
    <gs|O_q^dag O_q|gs>``, the static structure factor.  ``q`` indexes the
    discrete momentum grid (``q_phys = 2 pi (qx/nx, qy/ny)``).
    """
    nx, ny = problem.x_dimension, problem.y_dimension
    if kind == "spin":
        op = spin_q_operator(nx, ny, q[0], q[1])
    elif kind == "charge":
        op = charge_q_operator(
            nx, ny, q[0], q[1], filling=problem.n_electrons / (nx * ny)
        )
    else:
        raise ValueError("kind must be 'spin' or 'charge'")
    return spectral_function_lanczos(
        problem,
        ground_state,
        ground_energy,
        op,
        m=m,
        omegas=omegas,
        eta=eta,
        dtype=dtype,
        device=device,
        impl=impl,
        mesh=mesh,
    )
