"""The least time of the work a cell does: frozen arithmetic.

The larger of operations over the card's peak and bytes over its memory
bandwidth (NVIDIA's published H100 SXM figures, at the 700 W limit).  Each
input is read once and each output written once; the operations are the
least arithmetic of the function, counted from the configuration's terms
and amplitudes whatever kernel does the work:

* a Pauli rotation: 6 float32 operations a term and amplitude; the adjoint
  step (the inner product and two inverse rotations): 20;
* the float64 polish: 6 an amplitude and group (a group is a closed-form
  rotation), the adjoint 17, H psi with E and N as below plus 8;
* E = <psi|H|psi>: 6 a flip mask and amplitude and 2 a term, the x = 0
  product 3 and its terms 1; H psi (real coefficients): 4 a mask and 1 a
  term.

The terms are counted from the configuration alone: a pool generator (one
double excitation) is 8 Pauli strings sharing one flip mask and one group;
the Fourier network is 2 strings, one group, a rotation of this
package's adjacent-mode Givens factorisation of the DFT (fewer than any
lowering applies, so a share is never overstated); H is 2 strings a bond
and spin (one mask) and 3 diagonal strings a site and the identity.  The
chunk's Sz, S^2, fidelity and float64 readout (under 1% of the work) are
left out: the least time is a floor.
"""

from __future__ import annotations

from functools import lru_cache

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
F64_FLOPS_PER_S = 34e12


def least_s(bytes_moved: float, flops: float, f64: bool = False) -> float:
    return max(bytes_moved / HBM_BYTES_PER_S,
               flops / (F64_FLOPS_PER_S if f64 else F32_FLOPS_PER_S))


@lru_cache(maxsize=None)
def n_givens(nx: int, ny: int) -> int:
    from reference.hubbard_ref import _adjacent_givens, fourier_matrix

    return len(_adjacent_givens(fourier_matrix(nx, ny).T)[0])


def rotation_terms(cfg: dict, n_generators: int) -> int:
    return 8 * n_generators + 2 * n_givens(cfg["x_dimension"], cfg["y_dimension"])


def rotation_groups(cfg: dict, n_generators: int) -> int:
    return n_generators + n_givens(cfg["x_dimension"], cfg["y_dimension"])


def hamiltonian_counts(cfg: dict):
    """(flip masks, terms, x = 0 terms) of H's Pauli strings."""
    from reference.hubbard_ref import lattice_edges

    nx, ny = cfg["x_dimension"], cfg["y_dimension"]
    hops = 2 * len(lattice_edges(nx, ny, cfg.get("periodic", True)))
    diag = 3 * nx * ny + 1
    return hops + 1, 2 * hops + diag, diag


def inner_flops_per_amp(masks: int, terms: int, diag: int) -> int:
    per_amp = 6 * masks + 2 * terms
    return per_amp - (3 + diag) if diag else per_amp


def train_least(cfg: dict, n_generators: int, k: int, amp_bytes: int = 8) -> dict:
    """Least seconds of one forward sweep, one adjoint sweep, one step
    (sweeps, E, H psi) and one chunk of ``k`` steps with its extra forward
    pass, in float32."""
    n = 2 * cfg["x_dimension"] * cfg["y_dimension"]
    dim = 1 << n
    T = rotation_terms(cfg, n_generators)
    masks, h_terms, diag = hamiltonian_counts(cfg)
    fwd = (2 * amp_bytes * dim + 16 * T, 6 * T * dim)
    adj = (4 * amp_bytes * dim + 16 * T + 4 * n_generators, 20 * T * dim)
    e = (amp_bytes * dim + 24 * h_terms, inner_flops_per_amp(masks, h_terms, diag) * dim)
    hpsi = (2 * amp_bytes * dim + 24 * h_terms, (4 * masks + h_terms) * dim)
    step = tuple(sum(x) for x in zip(fwd, adj, e, hpsi))
    chunk = tuple(k * s + f for s, f in zip(step, fwd))
    return dict(fwd_s=least_s(*fwd), adj_s=least_s(*adj), step_s=least_s(*step),
                chunk_s=least_s(*chunk), terms=T)


def polish_eval_least(cfg: dict, n_generators: int) -> float:
    """Least seconds of one float64 value_and_grad: the forward pass, H psi
    with E and N, the adjoint sweep (complex128)."""
    n = 2 * cfg["x_dimension"] * cfg["y_dimension"]
    dim = 1 << n
    G = rotation_groups(cfg, n_generators)
    T = rotation_terms(cfg, n_generators)
    masks, h_terms, _ = hamiltonian_counts(cfg)
    flops = (6 * G + 17 * G + 8 + 4 * masks + h_terms) * dim
    nbytes = 16 * dim + 12 * (T + G) + 24 * h_terms + 16 * n_generators
    return least_s(nbytes, flops, f64=True)
