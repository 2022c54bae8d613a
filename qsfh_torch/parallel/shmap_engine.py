"""The explicit amplitude-sharded statevector engine.

Counterpart of ``qsfh_tpu/parallel/shmap_engine.py`` on ``torch.distributed``:
one process per rank, each holding its shard of the state.  The global flat
index is b = (d, l): d the top log2(D) bits (the rank), l the local index.
For a Pauli string with flip mask x = (x_hi, x_lo) and phase mask z = (z_hi,
z_lo):

* local part: t[l] = psi[l ^ x_lo], a flip on the shard;
* cross part: rank d holds what rank d ^ x_hi needs: ONE
  :func:`comm.exchange` along the XOR pairing (``jax.lax.ppermute`` there);
* the Z phases factor: sign(b) = sign_hi(d) sign_lo(l), sign_hi a per-rank
  scalar folded into each term's coefficient or phase on the host.

Expectations reduce on the rank and then :func:`comm.all_sum` over ranks (in
rank order: every rank holds the same bits).  The local parts run through
the statevector kernels (``engine.kernels``) on the local masks: Pauli
applications through ``pauli_apply``, rotations through the rotation runs
of :mod:`.sharded_compiled`, expectations through the inner-product tiles
(and their partner form, ``expectation_partner``).  The two-qubit gate, the
RZ layer and the Givens network built from them are plain torch on the
shard, as the JAX module's are plain ``jnp``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine.gates import givens_plan_matrix
from ..engine.kernels import KERNELS
from ..engine.state import index_bits, real_dtype
from . import comm
from .mesh import Mesh


def _split_mask_flat(flat_mask: int, n: int, k: int):
    """Split a FLAT bitmask into (device-bits value, local flat mask)."""
    hi = flat_mask >> (n - k)
    lo = flat_mask & ((1 << (n - k)) - 1)
    return hi, lo


def _string_phase(x: int, z: int) -> complex:
    """Convert a packed (X^x Z^z) coefficient to the Hermitian-string
    (Y-convention) coefficient: c_str = c_packed * (-i)^{|x&z|}, matching
    PauliSum.string_coeffs()."""
    return (-1j) ** (bin(x & z).count("1") % 4)


def parities(values) -> np.ndarray:
    """popcount(v) & 1 of each value (host integers)."""
    return np.asarray([bin(int(v)).count("1") & 1 for v in np.asarray(values).reshape(-1)],
                      dtype=np.int64)


class ShardedPauliEngine:
    """Sharded gates and expectations for one (n, mesh) pair, on this rank's
    shard of ``2^(n - log2 D)`` amplitudes.  Masks are split on the host per
    Pauli string; ``impl`` (the kernel wrappers by default; ``PLAIN`` for a
    reference run on the card) serves the local parts."""

    def __init__(self, n_qubits: int, mesh: Mesh, impl=None):
        self.n = n_qubits
        self.mesh = mesh
        self.n_devices = mesh.size
        self.k = mesh.k
        if 1 << self.k != self.n_devices:
            raise ValueError("device count must be a power of two")
        self.n_local = n_qubits - self.k
        if self.n_local < 1:
            raise ValueError(f"{n_qubits} qubits over {self.n_devices} ranks leave no local qubit")
        self.rank = mesh.rank
        self.device = mesh.device
        self.impl = impl or KERNELS

    # -- host-side mask algebra ----------------------------------------------------------

    def _flat(self, qmask: int) -> int:
        out = 0
        for q in range(self.n):
            if (qmask >> q) & 1:
                out |= 1 << (self.n - 1 - q)
        return out

    def split(self, flat_mask: int):
        """(x_hi, x_lo) of a flat mask."""
        return _split_mask_flat(int(flat_mask), self.n, self.k)

    def device_sign(self, z_hi: int) -> float:
        """(-1)^popcount(d & z_hi) for this rank d."""
        return -1.0 if bin(self.rank & int(z_hi)).count("1") & 1 else 1.0

    def device_signs(self, z_hi) -> np.ndarray:
        """:meth:`device_sign` of each value of an array."""
        return 1.0 - 2.0 * parities(np.asarray(z_hi, np.int64) & self.rank).astype(np.float64)

    # -- exchanges ---------------------------------------------------------------------------

    def exchange(self, t: torch.Tensor, m_hi: int) -> torch.Tensor:
        return comm.exchange(t, m_hi)

    def exchange_into(self, ts, outs, m_hi: int) -> None:
        comm.exchange_into(ts, outs, m_hi)

    def partners(self, psi: torch.Tensor, ms, spare=None) -> dict:
        """{m: the shard of rank d ^ m} for each distinct nonzero m, one
        exchange each; the first received into ``spare`` where given (a
        tensor of psi's shape, such as a pair buffer's idle half)."""
        out = {}
        for m in sorted(set(int(m) for m in ms) - {0}):
            if spare is None:
                out[m] = self.exchange(psi, m)
            else:
                self.exchange_into([psi], [spare], m)
                out[m], spare = spare, None
        return out

    # -- building blocks ---------------------------------------------------------------------

    def _local_terms(self, psi, xs, zs, c):
        """(xs, zs, c real, c imag) as tensors on psi's device."""
        rdt = real_dtype(psi.dtype)
        dev = psi.device
        c = np.asarray(c, np.complex128)
        return (torch.as_tensor(np.asarray(xs, np.int64), device=dev),
                torch.as_tensor(np.asarray(zs, np.int64), device=dev),
                torch.as_tensor(c.real, device=dev).to(rdt),
                torch.as_tensor(c.imag, device=dev).to(rdt))

    def apply_pauli(self, psi_l, x: int, z: int):
        """P|psi> on the local shard for the Hermitian string P(x, z)."""
        x_hi, x_lo = self.split(self._flat(x))
        z_hi, z_lo = self.split(self._flat(z))
        t = self.exchange(psi_l, x_hi)
        # t[b] (-1)^{z.b} = (-1)^{|z&x|} (X^x Z^z psi)[b]; the (-i)^{|x&z|}
        # phase makes it the Hermitian string (engine.gates.apply_pauli_string)
        c = _string_phase(x, z) * self.device_sign(z_hi)
        return self.impl.apply(t, *self._local_terms(psi_l, [x_lo], [z_lo], [c]))

    def pauli_rotation(self, psi_l, x: int, z: int, theta):
        """exp(-i theta P) psi on the sharded state (a new tensor)."""
        return self.generator_rotation(psi_l, [(x, z, 1.0)], theta)

    def generator_rotation(self, psi_l, rot_terms, theta):
        """prod_t exp(-i theta scale_t P_t) psi, in term order (a new tensor):
        one rot program through the rotation runs."""
        from .sharded_compiled import ShardedRotations

        prog = ShardedRotations(self, [("rot", tuple(rot_terms), 0)])
        th = torch.as_tensor([float(theta)], dtype=real_dtype(psi_l.dtype), device=psi_l.device)
        return prog.apply(psi_l, th)

    def apply_paulisum(self, psi_l, op):
        """op|psi> on the local shard (op: PauliSum, packed coefficients)."""
        from .sharded_compiled import ShardedObservable

        return ShardedObservable.of(self, op).apply(psi_l)

    def apply_generator(self, psi_l, rot_terms):
        """G|psi> for G = sum scale * P (rotation_terms form; all real)."""
        from .sharded_compiled import ShardedObservable, pack_terms

        xs = [int(x) for x, _, _ in rot_terms]
        zs = [int(z) for _, z, _ in rot_terms]
        cs = [float(s) * _string_phase(int(x), int(z)) for x, z, s in rot_terms]
        return ShardedObservable(self, pack_terms(self, xs, zs, cs)).apply(psi_l)

    def expectation(self, psi_l, op):
        """Re<psi|op|psi> over the whole state (the same bits on every rank)."""
        from .sharded_compiled import ShardedObservable

        return ShardedObservable.of(self, op).expectation(psi_l)

    def _bit_vec(self, flat_one_bit: int, rdt, device):
        """The value of one flat bit at every local index (a vector, or a
        per-rank scalar for a sharded bit)."""
        hi, lo = self.split(flat_one_bit)
        if hi:
            return torch.full((1 << self.n_local,), float(bin(self.rank & hi).count("1") & 1),
                              dtype=rdt, device=device)
        idx = index_bits(self.n_local, device)
        return ((idx >> (lo.bit_length() - 1)) & 1).to(rdt)

    def _shifted(self, psi_l, flat_mask: int):
        hi, lo = self.split(flat_mask)
        t = psi_l[index_bits(self.n_local, psi_l.device) ^ lo] if lo else psi_l
        return self.exchange(t, hi)

    def apply_two_qubit(self, psi_l, U4, qa: int, qb: int):
        """Any 4x4 unitary on wires (qa, qb), either of which may be sharded:
        four multiply-adds over the XOR-shifted copies psi, psi^A, psi^B,
        psi^AB (each a local flip and/or one exchange), with coefficient
        vectors selected by the current bit values."""
        rdt = real_dtype(psi_l.dtype)
        U = np.asarray(U4, dtype=np.complex128).reshape(4, 4)
        fa, fb = self._flat(1 << qa), self._flat(1 << qb)
        ba = self._bit_vec(fa, rdt, psi_l.device)
        bb = self._bit_vec(fb, rdt, psi_l.device)
        copies = {(0, 0): psi_l, (1, 0): self._shifted(psi_l, fa),
                  (0, 1): self._shifted(psi_l, fb), (1, 1): self._shifted(psi_l, fa | fb)}
        out = torch.zeros_like(psi_l)
        for (da, db), shift in copies.items():
            # row r = (b_a b_b); source column (b_a ^ da, b_b ^ db)
            coeff = torch.zeros_like(psi_l)
            for ra in (0, 1):
                for rb in (0, 1):
                    u = complex(U[2 * ra + rb, 2 * (ra ^ da) + (rb ^ db)])
                    if u == 0:
                        continue
                    ind_a = ba if ra == 1 else (1.0 - ba)
                    ind_b = bb if rb == 1 else (1.0 - bb)
                    coeff = coeff + u * (ind_a * ind_b).to(psi_l.dtype)
            out = out + coeff * shift
        return out

    def rz_layer(self, psi_l, angles):
        """A layer of static RZ(angles[q]) as one elementwise pass: a local
        angle-sum vector plus a per-rank scalar."""
        rdt = real_dtype(psi_l.dtype)
        idx = index_bits(self.n_local, psi_l.device)
        t_lo = torch.zeros(1 << self.n_local, dtype=rdt, device=psi_l.device)
        t_hi = 0.0
        for q in range(self.n):
            a = float(angles[q])
            if a == 0.0:
                continue
            p = self.n - 1 - q  # flat bit
            if p >= self.n_local:
                t_hi += (a / 2) * (1.0 - 2.0 * ((self.rank >> (p - self.n_local)) & 1))
            else:
                t_lo = t_lo + (a / 2) * (1.0 - 2.0 * ((idx >> p) & 1).to(rdt))
        total = t_lo + t_hi
        return psi_l * torch.complex(torch.cos(total), -torch.sin(total))

    def givens_network(self, psi_l, diagonal, decomposition):
        """The FT/Slater Givens network on the sharded state (the gate form
        of ``engine.circuits.apply_givens_network``)."""
        psi_l = self.rz_layer(psi_l, [float(np.angle(diagonal[i])) for i in range(self.n)])
        for parallel_ops in reversed(decomposition):
            for op in parallel_ops:
                if op == "pht":
                    psi_l = self.apply_pauli(psi_l, 1 << (self.n - 1), 0)
                else:
                    i, j, theta, phi = op
                    M = givens_plan_matrix(float(theta), float(phi))
                    psi_l = self.apply_two_qubit(psi_l, M, i, j)
        return psi_l

    def givens_network_inverse(self, psi_l, diagonal, decomposition):
        """Exact inverse of :meth:`givens_network`."""
        for parallel_ops in decomposition:
            for op in reversed(parallel_ops):
                if op == "pht":
                    psi_l = self.apply_pauli(psi_l, 1 << (self.n - 1), 0)
                else:
                    i, j, theta, phi = op
                    M = givens_plan_matrix(float(theta), float(phi)).conj().T
                    psi_l = self.apply_two_qubit(psi_l, M, i, j)
        return self.rz_layer(psi_l, [-float(np.angle(diagonal[i])) for i in range(self.n)])

    def basis_state(self, occupied_qubits, dtype=torch.complex64):
        """This rank's shard of a computational basis state."""
        index = 0
        for q in occupied_qubits:
            index |= 1 << (self.n - 1 - q)
        hi, lo = index >> self.n_local, index & ((1 << self.n_local) - 1)
        psi_l = torch.zeros(1 << self.n_local, dtype=dtype, device=self.device)
        if self.rank == hi:
            psi_l[lo] = 1.0
        return psi_l


def sharded_expectation(engine: ShardedPauliEngine, op):
    """fn(psi_l) -> Re<psi|op|psi>, the layouts built once."""
    from .sharded_compiled import ShardedObservable

    obs = ShardedObservable.of(engine, op)
    return obs.expectation
