"""Hand-written CUDA kernels of the statevector hot path, with their plain
PyTorch versions.

Counterpart of ``qsfh_tpu/engine/pallas_kernels.py`` for the five chain
kernels of the ADAPT main path:

===================  ==================================================
wrapper              replaces (``qsfh_tpu/engine/pallas_kernels.py``)
===================  ==================================================
``pauli_rotation``   ``pauli_chain_pallas`` (:482)
``pauli_apply``      ``apply_chain_pallas`` (:715)
``pauli_inner``      ``expectation_chain_pallas`` (:645) and
                     ``screen_chain_pallas`` (:927)
``adjoint_rotation`` ``adjoint_chain_pallas`` (:826)
===================  ==================================================

The CUDA source is ``qsfh_torch/csrc/statevec_kernels.cu``.  It is built
with ``nvcc`` for ``sm_90a`` at first use into ``qsfh_torch/_build/`` and
loaded with ctypes over a plain C interface.  The state is interleaved
complex64 (one ``float2`` per amplitude); masks are int64 in torch and
become int32 at the kernel boundary; per-term scalars become float32.

Every wrapper takes the plain version for a tensor on the CPU and launches
its kernel for a tensor on a CUDA device, or raises: there is no fallback.
Each wrapper keeps a plain-integer ``launches`` count of its kernel's
launches: one per term for the two rotations, one per call for
``pauli_apply`` and ``pauli_inner`` (their second, partial-sum pass is not
counted).  The ``*_plain`` functions compute the same thing from
an index gather ``psi[idx ^ x]`` and an XOR-folded popcount parity, on any
device; the CPU tests hold them against the JAX package, and the chip
smoke test holds every kernel against them on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from typing import Callable

import torch

from .state import index_bits, parity_signs, real_dtype

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "statevec_kernels.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# largest state the kernels index with 32-bit flat indices
MAX_QUBITS = 30

_lock = threading.Lock()
_lib = None
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def build() -> str:
    """Compile the kernel library if needed; returns the path of the .so.

    The file name carries a hash of the source, so an edited source is
    rebuilt and a stale library is never loaded.  The compiler's resource
    report (``-Xptxas -v``) and the build seconds land in ``build_info``.
    """
    with open(SOURCE, "rb") as fh:
        digest = hashlib.sha1(fh.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"libstatevec_kernels-{digest}.so")
    if os.path.exists(so):
        build_info.setdefault("seconds", 0.0)
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp.{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_info["seconds"] = time.time() - t0
    build_info["log"] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, so)
    return so


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.qsfh_error_string.restype = ctypes.c_char_p
        lib.qsfh_error_string.argtypes = [i]
        lib.qsfh_inner_blocks.restype = i
        lib.qsfh_inner_blocks.argtypes = [i]
        lib.qsfh_adjoint_blocks.restype = i
        lib.qsfh_adjoint_blocks.argtypes = [i]
        lib.qsfh_pauli_rotation.restype = i
        lib.qsfh_pauli_rotation.argtypes = [p, i, p, p, p, p, p, i, p]
        lib.qsfh_adjoint_rotation.restype = i
        lib.qsfh_adjoint_rotation.argtypes = [p, p, i, p, p, p, p, p, i, p, p, p]
        lib.qsfh_pauli_inner.restype = i
        lib.qsfh_pauli_inner.argtypes = [p, p, i, p, p, i, p, p, p]
        lib.qsfh_pauli_apply.restype = i
        lib.qsfh_pauli_apply.argtypes = [p, p, i, p, p, p, p, i, p]
        _lib = lib
        return lib


def _check(lib, rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}: {lib.qsfh_error_string(rc).decode()}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _n_qubits(psi: torch.Tensor, name: str) -> int:
    """Validate a CUDA state for the kernels; returns its qubit count."""
    if psi.device.type != "cuda":
        raise ValueError(
            f"{name}: the kernels take CUDA tensors (the plain version takes "
            f"all-CPU inputs), got {psi.device}"
        )
    if psi.dtype != torch.complex64:
        raise TypeError(f"{name}: the CUDA kernels take complex64 states, got {psi.dtype}")
    if psi.dim() != 1 or not psi.is_contiguous():
        raise ValueError(f"{name}: expected a flat contiguous state, got shape {tuple(psi.shape)}")
    dim = psi.shape[0]
    n = dim.bit_length() - 1
    if dim != 1 << n or not 1 <= n <= MAX_QUBITS:
        raise ValueError(f"{name}: state length {dim} is not 2^n with 1 <= n <= {MAX_QUBITS}")
    return n


def _terms(psi: torch.Tensor, n_terms: int, name: str, *arrays):
    """Per-term arrays as contiguous int32 / float32 tensors on psi's device."""
    out = []
    for arr, dtype in arrays:
        if arr.device != psi.device:
            raise ValueError(f"{name}: term arrays must be on {psi.device}, got {arr.device}")
        if arr.shape != (n_terms,):
            raise ValueError(f"{name}: expected ({n_terms},) term arrays, got {tuple(arr.shape)}")
        out.append(arr.to(dtype).contiguous())
    return out


_MASK = torch.int32
_SCALAR = torch.float32


def _counted(fn: Callable) -> Callable:
    fn.launches = 0
    return fn


# -- pauli_rotation ---------------------------------------------------------------


@_counted
def pauli_rotation(psi, xs, zs, angles, phre, phim):
    """psi <- exp(-i angles[T-1] P_{T-1}) ... exp(-i angles[0] P_0) psi,
    IN PLACE, with P_t psi[b] = (phre_t + i phim_t) s_t(b) psi[b ^ xs_t].

    ``angles`` carries the full signed angle per term (scale and direction
    folded in).  One kernel launch per term.  Returns psi.
    """
    if psi.device.type == "cpu":
        return pauli_rotation_plain(psi, xs, zs, angles, phre, phim)
    n = _n_qubits(psi, "pauli_rotation")
    T = xs.shape[0]
    if T == 0:
        return psi
    args = _terms(psi, T, "pauli_rotation", (xs, _MASK), (zs, _MASK),
                  (angles, _SCALAR), (phre, _SCALAR), (phim, _SCALAR))
    lib = _load()
    rc = lib.qsfh_pauli_rotation(psi.data_ptr(), n, *(a.data_ptr() for a in args), T, _stream())
    _check(lib, rc, "pauli_rotation")
    pauli_rotation.launches += T
    return psi


def pauli_rotation_plain(psi, xs, zs, angles, phre, phim):
    """Plain version of :func:`pauli_rotation` (in place, any device)."""
    T = xs.shape[0]
    if T == 0:
        return psi
    n = psi.shape[0].bit_length() - 1
    rdt = real_dtype(psi.dtype)
    idx = index_bits(n, psi.device)
    ph = torch.complex(phre.to(rdt), phim.to(rdt))
    cos, sin = torch.cos(angles.to(rdt)), torch.sin(angles.to(rdt))
    out = psi
    for t in range(T):
        ppsi = ph[t] * parity_signs(idx, zs[t], rdt) * out[idx ^ xs[t]]
        out = cos[t] * out - 1j * sin[t] * ppsi
    psi.copy_(out)
    return psi


# -- pauli_apply ------------------------------------------------------------------


@_counted
def pauli_apply(psi, xs, zs, cre, cim):
    """out[b] = sum_t (cre_t + i cim_t) s_t(b) psi[b ^ xs_t] (a new tensor)."""
    if psi.device.type == "cpu":
        return pauli_apply_plain(psi, xs, zs, cre, cim)
    n = _n_qubits(psi, "pauli_apply")
    T = xs.shape[0]
    out = torch.empty_like(psi)
    if T == 0:
        return out.zero_()
    args = _terms(psi, T, "pauli_apply", (xs, _MASK), (zs, _MASK), (cre, _SCALAR), (cim, _SCALAR))
    lib = _load()
    rc = lib.qsfh_pauli_apply(psi.data_ptr(), out.data_ptr(), n,
                              *(a.data_ptr() for a in args), T, _stream())
    _check(lib, rc, "pauli_apply")
    pauli_apply.launches += 1
    return out


def _term_chunks(n: int, T: int):
    """Term chunks for the vectorised plain versions: (chunk, 2^n) gathers
    of at most 2^22 elements."""
    step = max(1, (1 << 22) >> n)
    return ((t0, min(t0 + step, T)) for t0 in range(0, T, step))


def pauli_apply_plain(psi, xs, zs, cre, cim):
    """Plain version of :func:`pauli_apply` (any device)."""
    n = psi.shape[0].bit_length() - 1
    rdt = real_dtype(psi.dtype)
    idx = index_bits(n, psi.device)
    c = torch.complex(cre.to(rdt), cim.to(rdt))
    out = torch.zeros_like(psi)
    for t0, t1 in _term_chunks(n, xs.shape[0]):
        s = parity_signs(idx[None, :], zs[t0:t1, None], rdt)
        out += (c[t0:t1, None] * s * psi[idx[None, :] ^ xs[t0:t1, None]]).sum(0)
    return out


# -- pauli_inner ------------------------------------------------------------------


@_counted
def pauli_inner(a, psi, xs, zs):
    """v_t = sum_b conj(a[b]) s_t(b) psi[b ^ xs_t] for every term (complex, (T,)).

    With a = psi, Re sum_t c_t v_t is an expectation value; with
    a = w = H' psi, 2 Im(c_t v_t) is a pool-screening contribution.
    """
    if psi.device.type == "cpu" and a.device.type == "cpu":
        return pauli_inner_plain(a, psi, xs, zs)
    n = _n_qubits(psi, "pauli_inner")
    if _n_qubits(a, "pauli_inner") != n:
        raise ValueError("pauli_inner: states of different sizes")
    T = xs.shape[0]
    out = torch.empty(T, dtype=torch.complex64, device=psi.device)
    if T == 0:
        return out
    args = _terms(psi, T, "pauli_inner", (xs, _MASK), (zs, _MASK))
    lib = _load()
    partials = torch.empty((T, lib.qsfh_inner_blocks(n)), dtype=torch.complex64,
                           device=psi.device)
    rc = lib.qsfh_pauli_inner(a.data_ptr(), psi.data_ptr(), n, *(t.data_ptr() for t in args),
                              T, partials.data_ptr(), out.data_ptr(), _stream())
    _check(lib, rc, "pauli_inner")
    pauli_inner.launches += -(-T // 65535)  # the C side chunks the 65535-term grid-y limit
    return out


def pauli_inner_plain(a, psi, xs, zs):
    """Plain version of :func:`pauli_inner` (any device)."""
    n = psi.shape[0].bit_length() - 1
    rdt = real_dtype(psi.dtype)
    idx = index_bits(n, psi.device)
    ac = a.conj()
    parts = []
    for t0, t1 in _term_chunks(n, xs.shape[0]):
        s = parity_signs(idx[None, :], zs[t0:t1, None], rdt)
        parts.append((ac[None, :] * s * psi[idx[None, :] ^ xs[t0:t1, None]]).sum(1))
    if not parts:
        return torch.zeros(0, dtype=psi.dtype, device=psi.device)
    return torch.cat(parts)


# -- adjoint_rotation ---------------------------------------------------------------


@_counted
def adjoint_rotation(psi, lam, xs, zs, angles, phre, phim):
    """Reverse adjoint sweep over terms given in REVERSED application order.

    For each term t: v_t = <lam | P_t psi> at the current (post-gate)
    state, then psi <- exp(+i angles_t P_t) psi and lam likewise.  psi and
    lam are updated IN PLACE; returns v (complex, (T,)).  The gradient
    contribution of term t is scale_t * Im v_t.
    """
    if psi.device.type == "cpu" and lam.device.type == "cpu":
        return adjoint_rotation_plain(psi, lam, xs, zs, angles, phre, phim)
    n = _n_qubits(psi, "adjoint_rotation")
    if _n_qubits(lam, "adjoint_rotation") != n:
        raise ValueError("adjoint_rotation: states of different sizes")
    T = xs.shape[0]
    out = torch.empty(T, dtype=torch.complex64, device=psi.device)
    if T == 0:
        return out
    args = _terms(psi, T, "adjoint_rotation", (xs, _MASK), (zs, _MASK),
                  (angles, _SCALAR), (phre, _SCALAR), (phim, _SCALAR))
    lib = _load()
    partials = torch.empty((T, lib.qsfh_adjoint_blocks(n)), dtype=torch.complex64,
                           device=psi.device)
    rc = lib.qsfh_adjoint_rotation(psi.data_ptr(), lam.data_ptr(), n,
                                   *(t.data_ptr() for t in args), T,
                                   partials.data_ptr(), out.data_ptr(), _stream())
    _check(lib, rc, "adjoint_rotation")
    adjoint_rotation.launches += T
    return out


def adjoint_rotation_plain(psi, lam, xs, zs, angles, phre, phim):
    """Plain version of :func:`adjoint_rotation` (in place, any device)."""
    T = xs.shape[0]
    n = psi.shape[0].bit_length() - 1
    rdt = real_dtype(psi.dtype)
    idx = index_bits(n, psi.device)
    ph = torch.complex(phre.to(rdt), phim.to(rdt))
    cos, sin = torch.cos(angles.to(rdt)), torch.sin(angles.to(rdt))
    v = torch.zeros(T, dtype=psi.dtype, device=psi.device)
    p, l = psi, lam
    for t in range(T):
        gather = idx ^ xs[t]
        w = ph[t] * parity_signs(idx, zs[t], rdt)
        pp = w * p[gather]
        v[t] = torch.vdot(l, pp)
        p = cos[t] * p + 1j * sin[t] * pp
        l = cos[t] * l + 1j * sin[t] * (w * l[gather])
    psi.copy_(p)
    lam.copy_(l)
    return v


# -- dispatch -------------------------------------------------------------------------


@dataclass(frozen=True)
class Impl:
    """The four statevector primitives the engine calls."""

    rotation: Callable
    apply: Callable
    inner: Callable
    adjoint: Callable


# the wrappers: CUDA kernels for CUDA tensors, plain versions for CPU tensors
KERNELS = Impl(pauli_rotation, pauli_apply, pauli_inner, adjoint_rotation)
# the plain versions on any device (a reference path on the card)
PLAIN = Impl(pauli_rotation_plain, pauli_apply_plain, pauli_inner_plain, adjoint_rotation_plain)

WRAPPERS = (pauli_rotation, pauli_apply, pauli_inner, adjoint_rotation)


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
