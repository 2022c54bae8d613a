"""Imaginary-time evolution (ITE) ground-state solver.

Counterpart of ``qsfh_tpu/algos/ite.py``: the power-method flow
``|psi(beta)> ~ exp(-beta H)|psi0>`` converges to the lowest eigenstate
overlapping ``|psi0>`` (within its symmetry sector).  Each step applies
a degree-``order`` Taylor polynomial of ``exp(-dbeta (H - E))`` by
Horner-style accumulation of H psi passes, then renormalizes; the
Rayleigh shift ``E = <H>`` recentres it every step, and the energy
VARIANCE ``<H^2> - <H>^2`` from the same H psi pass is a convergence
certificate (0 iff the state is an eigenstate).

H psi is ``Observable.apply_auto``: ``pauli_apply_grouped`` over the
application tiles from 9 qubits on, the per-term ``pauli_apply`` below.
Where the JAX driver runs a block of steps as one jitted scan, this one
runs them in a host loop and reads a block's energies and variances once,
at its end.  :meth:`thermal_expectation` takes a ``torch.Generator`` (or
the start vectors themselves, ``draws``) where the JAX one takes a
``PRNGKey``; the two give different numbers from one seed.  The JAX
``mesh`` argument is dropped.  Entry points run on ``cuda`` unless
``device`` says otherwise.

Stability: the Taylor polynomial only contracts eigencomponents with
``dbeta * (E_k - E)`` inside a bounded region, so ``dbeta`` must resolve
the spectral width; :func:`suggest_dbeta` gives a safe step from the
Pauli 1-norm bound ``||H - E|| <= sum_k |c_k|``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..engine.expectation import Observable
from ..engine.kernels import KERNELS
from ..engine.state import as_state, real_dtype
from ..linalg.sectors import random_sector_state
from ..ops.pauli import PauliSum
from .base import default_dtype, resolve_device

__all__ = ["ImaginaryTimeEvolution", "suggest_dbeta"]


def suggest_dbeta(op: PauliSum, safety: float = 0.5) -> float:
    """A stable imaginary-time step from the Pauli 1-norm spectral bound.

    ``|E_k - E| <= 2 * sum |c_k|`` for any Rayleigh shift E inside the
    spectrum, and the order>=2 Taylor polynomials of ``exp(-x)`` stay
    contracting for ``|x| <= ~1``; ``safety`` leaves margin.
    """
    c_abs = float(np.abs(op.c).sum())
    return safety / max(2.0 * c_abs, 1e-12)


class ImaginaryTimeEvolution:
    """Taylor-propagated ``exp(-beta H)`` flow for a :class:`HubbardProblem`
    (or any object exposing ``n_qubits`` and ``qubit_hamiltonian``)."""

    def __init__(
        self,
        problem,
        dbeta: Optional[float] = None,
        order: int = 4,
        dtype=None,
        device=None,
    ):
        if order < 1:
            raise ValueError("Taylor order must be >= 1")
        self.problem = problem
        self.n_qubits = problem.n_qubits
        self.device = resolve_device(device)
        self.dtype = dtype or default_dtype(self.device)
        self.order = int(order)
        ham = problem.qubit_hamiltonian
        self.observable = Observable(ham, self.n_qubits)
        self.dbeta = float(dbeta) if dbeta is not None else suggest_dbeta(ham)
        # the kernel wrappers; a reference run on the card may set
        # engine.kernels.PLAIN
        self.impl = KERNELS

    # -- one step -----------------------------------------------------------------

    def _step(self, psi):
        """One normalized Taylor step; returns (psi', energy, variance, logw),
        the last three 0-d real tensors on the device.

        The energy/variance reported are those of the INPUT state (they
        reuse the same H|psi> pass that seeds the polynomial).  ``logw``
        is the log-norm of the UNNORMALIZED step,
        ``log || exp(-dbeta H) psi || = log ||acc|| - dbeta * E`` (the
        polynomial approximates ``exp(-dbeta (H - E))``), which thermal
        typicality accumulates into Boltzmann weights.
        """
        apply = self.observable.apply_auto
        h_psi = apply(psi, impl=self.impl)
        energy = torch.vdot(psi, h_psi).real
        h2 = torch.vdot(h_psi, h_psi).real
        variance = h2 - energy * energy
        # accumulate  sum_j (-dbeta)^j / j! (H - E)^j |psi>
        term = psi
        acc = psi
        for j in range(1, self.order + 1):
            applied = h_psi if j == 1 else apply(term, impl=self.impl)
            term = (-self.dbeta / j) * (applied - energy * term)
            acc = acc + term
        nrm = torch.sqrt(torch.vdot(acc, acc).real)
        logw = torch.log(nrm) - self.dbeta * energy
        return acc / nrm, energy, variance, logw

    # -- driver ---------------------------------------------------------------------

    def run(
        self,
        psi0,
        n_steps: int = 1000,
        block: int = 50,
        variance_tol: Optional[float] = None,
        verbose: bool = False,
    ):
        """Evolve exactly ``n_steps`` steps in blocks of ``block``, reading
        each block's energies and variances once, at its end, and stopping
        early when the last variance drops below ``variance_tol``.

        Returns ``(psi_final, records)``: the final state on the device and
        host numpy ``energies`` and ``variances`` series (one entry per
        executed step).
        """
        psi = as_state(psi0, self.device, self.dtype)
        energies, variances = [], []
        executed = 0
        while executed < n_steps:
            blk = min(block, n_steps - executed)
            rows = []
            for _ in range(blk):
                psi, energy, variance, _logw = self._step(psi)
                rows.append(torch.stack([energy, variance]))
            es, vs = torch.stack(rows).cpu().numpy().T
            energies.append(es)
            variances.append(vs)
            executed += blk
            if verbose:
                print(
                    f"beta: {executed * self.dbeta:9.4f} | "
                    f"energy: {es[-1]: .8f} | variance: {vs[-1]:.3e}"
                )
            if variance_tol is not None and vs[-1] < variance_tol:
                break
        records = {
            "energies": np.concatenate(energies) if energies else np.zeros(0),
            "variances": np.concatenate(variances) if variances else np.zeros(0),
        }
        return psi, records

    # -- finite temperature (canonical typicality) -----------------------------------

    def thermal_expectation(
        self,
        beta: float,
        observables,
        n_samples: int = 16,
        generator: Optional[torch.Generator] = None,
        sector=None,
        draws=None,
    ):
        """Canonical thermal averages ``<O>_beta = Tr_S(e^{-beta H} O)/Z_S``
        by imaginary-time typicality.

        Each random vector ``|r>`` (Haar-Gaussian over the sector ``S``) is
        evolved to ``beta/2`` with the Taylor stepper; the accumulated
        log-weights ``w_r = ||e^{-beta H/2}|r>||^2`` are the stochastic
        Boltzmann weights, and

            <O>_beta  ~=  sum_r w_r <psi_r|O|psi_r> / sum_r w_r .

        The vectors come from ``generator`` (a CPU ``torch.Generator``,
        seeded 0 by default): ``sector`` defaults to the problem's pinned
        ``(N, N_up)`` sector (``sector=False``: the full space).
        ``draws``, a list of start vectors, replaces the draw (and sets
        ``n_samples``).  Returns ``(estimates, diagnostics)``: per-observable
        means plus jackknife standard errors and the log-weight spread.
        """
        n_half = max(int(round((beta / 2.0) / self.dbeta)), 1)
        beta_eff = 2.0 * n_half * self.dbeta
        obs = dict(observables)
        if draws is not None:
            draws = list(draws)
            n_samples = len(draws)
        else:
            generator = generator or torch.Generator().manual_seed(0)
            if sector is None:
                p = self.problem
                sector = (p.n_electrons, p.n_spin_up)

        def draw(r):
            if draws is not None:
                v = draws[r]
            elif sector is False:
                rdt = real_dtype(self.dtype)
                dim = 1 << self.n_qubits
                re = torch.randn(dim, generator=generator, dtype=rdt)
                im = torch.randn(dim, generator=generator, dtype=rdt)
                v = torch.complex(re, im)
                v = v / torch.linalg.vector_norm(v)
            else:
                v = random_sector_state(self.n_qubits, sector[0], sector[1], generator=generator,
                                        dtype=self.dtype, device=generator.device)
            return as_state(v, self.device, self.dtype)

        logws = np.zeros(n_samples)
        values = {name: np.zeros(n_samples) for name in obs}
        for r in range(n_samples):
            psi = draw(r)
            logw = torch.zeros((), dtype=real_dtype(self.dtype), device=self.device)
            for _ in range(n_half):
                psi, _e, _v, lw = self._step(psi)
                logw = logw + lw
            logws[r] = 2.0 * float(logw)  # w_r = ||e^{-beta H/2} r||^2
            for name, o in obs.items():
                values[name][r] = float(o.expectation_scan(psi, impl=self.impl))

        w = np.exp(logws - logws.max())
        w_sum = w.sum()
        estimates = {name: float((w * v).sum() / w_sum) for name, v in values.items()}
        # jackknife standard errors over samples
        stderrs = {}
        for name, v in values.items():
            if n_samples > 1:
                jk = np.array([
                    ((w * v).sum() - w[i] * v[i]) / (w_sum - w[i])
                    for i in range(n_samples)
                ])
                stderrs[name] = float(np.sqrt((n_samples - 1) * np.var(jk)))
            else:
                stderrs[name] = float("nan")
        diagnostics = {
            "beta_effective": beta_eff,
            "n_samples": n_samples,
            "stderrs": stderrs,
            "log_weight_spread": float(logws.max() - logws.min()),
            "effective_samples": float(w_sum**2 / (w**2).sum()),
        }
        return estimates, diagnostics
