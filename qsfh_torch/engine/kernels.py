"""Hand-written CUDA kernels of the statevector hot path, with their plain
PyTorch versions.

Counterpart of ``qsfh_tpu/engine/pallas_kernels.py`` for the chain and
stream kernels of the ADAPT main path:

=======================  ==================================================
wrapper                  replaces (``qsfh_tpu/engine/pallas_kernels.py``)
=======================  ==================================================
``rotation_resident``    ``pauli_chain_pallas`` (:482): a span of tile runs
                         in one cooperative launch, up to the chain cap
``adjoint_resident``     ``adjoint_chain_pallas`` (:826), the same way
``pauli_rotation``       terms that fit no tile, and states of fewer than
                         ``TILE_MIN_BITS`` qubits
``pauli_rotation_out``   ``pauli_rotation_pallas`` (:571), through
                         ``pauli_rotation_one``: one term, out of place
``pauli_apply_grouped``  ``apply_chain_pallas`` (:715), ``apply_stream_pallas``
                         (:1870) and ``apply_stream_fused`` (:2002): the
                         inner-product tiles, one pass per tile
``pauli_apply``          terms of masks that fit no tile, and states of
                         fewer than ``INNER_TILE_MIN_BITS`` qubits
``expectation_grouped``  ``expectation_chain_pallas`` (:645) and
                         ``expectation_stream_*`` (:1581, :1596, :1714,
                         :1804): E = sum_t Re(c_t <psi|P_t|psi>) over
                         the inner-product tiles, the x = 0 terms as one
                         Walsh-Hadamard diagonal, the coefficients folded
                         into the partial-sum pass
``expectation_partner``  ``expectation_stream_planes`` (:1596) with its
                         partner planes: E = sum_t Re(c_t <a|P_t|psi>),
                         a != psi (a shard and its XOR partner's), the
                         same kernel and fold
``screen_grouped``       ``screen_chain_pallas`` (:927) and
                         ``screen_stream_*`` (:1474, :1522): 2 Im(c_t
                         <w|P_t|psi>) per term, the same way
``pauli_inner_grouped``  the same kernel, v_t in input order (the tests and
                         the route timings)
``pauli_inner``          terms of masks that fit no tile, and states of
                         fewer than ``INNER_TILE_MIN_BITS`` qubits
``adjoint_rotation``     terms that fit no tile, and states of fewer than
                         ``TILE_MIN_BITS`` qubits
``rotation_tile_runs``   ``rotation_stream_pallas`` (:2268, local :2214,
                         crossing :2246)
``adjoint_tile_runs``    ``adjoint_stream_pallas`` (:2142, local :2032,
                         crossing :2095)
``xor_gather``           ``xor_gather_pallas`` (:378)
``expectation_norm_f64_tiles``
                         no Pallas kernel: the float64 Rayleigh readout
                         that ``qsfh_tpu/engine/dfloat.py`` computes in
                         double-float jnp (``expectation_norm_df``), over
                         the inner-product tiles
``expectation_norm_f64`` the same readout one amplitude a thread over the
                         terms: states under the route's threshold
                         (``F64_TILE_MIN_QUBITS``: 9), masks that fit no
                         tile
``rot64_groups``         no Pallas kernel: the forward pass of the host C++
                         float64 engine (``qsfh_tpu/native/statevec64.cpp``
                         ``qsfh_sv64_apply``, :153), complex128 groups of
                         commuting rotations
``happly64_tiles``       the same engine's H psi (``qsfh_sv64_happly``,
                         :171), with E = Re <psi|H psi> beside it, over
                         the application tiles in complex128
``happly64``             the same, one amplitude a thread over the terms:
                         states under the route's threshold
                         (``F64_TILE_MIN_QUBITS``: 18), masks that fit no
                         tile
``adjoint64_groups``     the same engine's fused reverse sweep
                         (``qsfh_sv64_adjoint``, :203), the gradient folded
                         per parameter in a fixed order
``rot64_resident``       ``qsfh_sv64_apply`` (:153) over tile runs of
                         groups in one cooperative launch, where the
                         layout allows (``Rot64Program.route``)
``adjoint64_resident``   ``qsfh_sv64_adjoint`` (:203) the same way, the
                         gradient folded inside the launch
=======================  ==================================================

The CUDA source is ``qsfh_torch/csrc/statevec_kernels.cu``.  It is built
with ``nvcc`` for ``sm_90a`` at first use into ``qsfh_torch/_build/`` and
loaded with ctypes over a plain C interface.  The state is interleaved
complex64 (one ``float2`` per amplitude); masks are int64 in torch and
become int32 at the kernel boundary; per-term scalars become float32.

Every wrapper takes the plain version for a tensor on the CPU and launches
its kernel for a tensor on a CUDA device, or raises: there is no fallback.
The ``*_plain`` functions compute the same thing from an index gather
``psi[idx ^ x]`` and an XOR-folded popcount parity, on any device; the CPU
tests hold them against the JAX package, and the chip smoke test holds
every kernel against them on the card.

Every launch of the library passes through one helper, ``_launch``, which
brackets the library call alone with a device interval of the recorder
(``utils/profiling.py``) named after the kernel (off: one flag check) and
adds the kernel launches the call made to a table under the wrapper's
name: one per span for the two resident kernels (the 18-qubit rotations
and adjoint sweep: one per call where every term fits a tile), one per
term for the two per-term rotations, one per run for the two tile-run
kernels, one per tile for ``pauli_apply_grouped`` and ``happly64_tiles``
(E and N folded inside the last), one per group for ``rot64_groups`` and
``adjoint64_groups``, one per call for ``xor_gather``,
``pauli_rotation_out``, ``expectation_norm_f64``,
``expectation_norm_f64_tiles`` (its fold inside the launch), ``happly64``
and the two float64 resident kernels (each of which fills its tables and,
in the adjoint, folds the gradient inside the launch), one per call (or
per scratch-sized chunk) for ``pauli_apply``, ``pauli_inner`` and the four
inner-product tile wrappers (a partial-sum pass is not counted).
:func:`launch_counts` reads the table and :func:`reset_launch_counts`
zeroes it.  What a launch did beyond that its layout says: the terms it
ran in closed form (``TileRuns.fused_terms``), its passes over the state
(``len(tiles)``, ``TileLayout.passes``), and, for a resident launch, the
runs it staged a run ahead (every run but the first, ``len(tiles) - 1``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import Counter
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..utils import profiling
from . import streaming
from .state import index_bits, parity_signs, real_dtype
from .streaming import INNER_SWIZZLE

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "statevec_kernels.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# largest state the kernels index with 32-bit flat indices
MAX_QUBITS = 30
# float2 entries of block-partial scratch per launch (16 MiB): longer term
# lists are cut into chunks, so the scratch never grows with T x 2^n
PARTIALS_CAP = 1 << 21
# the same for one adjoint tile sweep (64 MiB), summed by one partial-sum
# pass per chunk of runs: at 24 qubits the whole sweep is one chunk
SWEEP_PARTIALS_CAP = 1 << 23
# tiles the tile-run kernels take: 2^(k - 4) threads, one warp to 512
TILE_MIN_BITS = 9
TILE_MAX_BITS = 13
# adjoint_resident's largest tile (the kernel's kResidentAdjointMaxBits: 256
# threads, so that a thread may hold 255 registers)
RESIDENT_ADJOINT_MAX_BITS = 12
# tiles the inner-product tile kernel takes: 5 lane bits and 4 bucket bits
# at least, two 64 KiB tiles at most
INNER_TILE_MIN_BITS = 9
INNER_TILE_MAX_BITS = 13
# streaming.INNER_SWIZZLE packed for the tile kernels: 4 bits per tile bit from 4 up
_SWIZZLE = sum(v << (4 * b) for b, v in enumerate(INNER_SWIZZLE))

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
    if _lib is not None:  # every launch passes here: no lock once loaded
        return _lib
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
        lib.qsfh_rotation_tile_runs.restype = i
        lib.qsfh_rotation_tile_runs.argtypes = [p, i, i, i, i] + [p] * 14
        lib.qsfh_adjoint_tile_runs.restype = i
        lib.qsfh_adjoint_tile_runs.argtypes = [p, p, i, i, i, i] + [p] * 16
        lib.qsfh_resident_capacity.restype = i
        lib.qsfh_resident_capacity.argtypes = [i, i, i]
        lib.qsfh_rotation_resident.restype = i
        lib.qsfh_rotation_resident.argtypes = [p, i, i, i, i, i] + [p] * 16
        lib.qsfh_adjoint_resident.restype = i
        lib.qsfh_adjoint_resident.argtypes = [p, p, i, i, i, i, i] + [p] * 18
        lib.qsfh_xor_gather.restype = i
        lib.qsfh_xor_gather.argtypes = [p, p, i, p, i, p]
        lib.qsfh_pauli_inner_tiles.restype = i
        lib.qsfh_pauli_inner_tiles.argtypes = ([p, p, i, i, i, ctypes.c_ulonglong, p, p, i]
                                               + [p] * 9 + [i] * 6 + [p, i, p, p, i, p, p, p, i, p])
        f = ctypes.c_float
        lib.qsfh_pauli_rotation_out.restype = i
        lib.qsfh_pauli_rotation_out.argtypes = [p, p, i, p, i, p, i, p, f, p, f, p, f, p]
        lib.qsfh_pauli_rotation_out_values.restype = i
        lib.qsfh_pauli_rotation_out_values.argtypes = [p, p, i, i, i, f, f, f, p]
        lib.qsfh_f64_blocks.restype = i
        lib.qsfh_f64_blocks.argtypes = [i]
        lib.qsfh_expectation_norm_f64.restype = i
        lib.qsfh_expectation_norm_f64.argtypes = [p, i, i] + [p] * 8
        lib.qsfh_pauli_apply_grouped.restype = i
        lib.qsfh_pauli_apply_grouped.argtypes = [p, p, i, i, i, i] + [p] * 17 + [i, i, p]
        lib.qsfh_rot64_blocks.restype = i
        lib.qsfh_rot64_blocks.argtypes = [i]
        lib.qsfh_rot64_groups.restype = i
        lib.qsfh_rot64_groups.argtypes = [p, i, i] + [p] * 8
        lib.qsfh_happly64.restype = i
        lib.qsfh_happly64.argtypes = [p, p, i, i] + [p] * 4 + [ctypes.c_double, p, p, p]
        lib.qsfh_expectation_f64_tiles.restype = i
        lib.qsfh_expectation_f64_tiles.argtypes = ([p, i, i, i, ctypes.c_ulonglong, p, p, i]
                                                   + [p] * 9 + [i] * 6 + [p] * 6)
        lib.qsfh_happly64_tiles.restype = i
        lib.qsfh_happly64_tiles.argtypes = [p, p, i, i, i, i, p, p, p, ctypes.c_double] + [p] * 4
        lib.qsfh_adjoint64_groups.restype = i
        lib.qsfh_adjoint64_groups.argtypes = [p, p, i, i] + [p] * 7 + [i] + [p] * 5
        lib.qsfh_res64_capacity.restype = i
        lib.qsfh_res64_capacity.argtypes = [i] * 5
        lib.qsfh_rot64_resident.restype = i
        lib.qsfh_rot64_resident.argtypes = [p] + [i] * 8 + [p] * 4
        lib.qsfh_adjoint64_resident.restype = i
        lib.qsfh_adjoint64_resident.argtypes = [p, p] + [i] * 8 + [p] * 3 + [i] + [p] * 5
        _lib = lib
        return lib


# kernel launches under each wrapper's name since the last reset_launch_counts()
_launches: Counter = Counter()


def _launch(name: str, fn, *args, launches: int = 1):
    """``fn(*args)``, a call of the library that makes ``launches`` kernel
    launches, inside the recorder's device interval ``name``
    (``utils.profiling.device``: CUDA events around the library call alone,
    not the wrapper's preparation); raises on its error code, else adds
    ``launches`` to the table under ``name`` (:func:`launch_counts`).
    Every launch of the library passes here."""
    with profiling.device(name):
        rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}: {_lib.qsfh_error_string(rc).decode()}")
    _launches[name] += launches


def _stream() -> int:
    """The raw handle of the current device's current stream (what
    ``torch.cuda.current_stream().cuda_stream`` gives, without building a
    Python stream object per launch)."""
    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


def _n_qubits(psi: torch.Tensor, name: str, dtype=torch.complex64) -> int:
    """Validate a CUDA state of ``dtype`` for the kernels; returns its qubit count."""
    if not psi.is_cuda:
        raise ValueError(
            f"{name}: the kernels take CUDA tensors (the plain version takes "
            f"all-CPU inputs), got {psi.device}"
        )
    if psi.dtype != dtype:
        raise TypeError(f"{name}: the CUDA kernel takes {dtype} states, got {psi.dtype}")
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


def _chunks(T: int, width: int):
    """Term chunks whose (chunk, width) partials fit ``PARTIALS_CAP``."""
    step = max(1, PARTIALS_CAP // width)
    return [(t0, min(t0 + step, T)) for t0 in range(0, T, step)]


# -- pauli_rotation ---------------------------------------------------------------


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
    _launch("pauli_rotation", lib.qsfh_pauli_rotation, psi.data_ptr(), n,
            *(a.data_ptr() for a in args), T, _stream(), launches=T)
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
    _launch("pauli_apply", lib.qsfh_pauli_apply, psi.data_ptr(), out.data_ptr(), n,
            *(a.data_ptr() for a in args), T, _stream())
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
    xs, zs = _terms(psi, T, "pauli_inner", (xs, _MASK), (zs, _MASK))
    lib = _load()
    width = lib.qsfh_inner_blocks(n)
    chunks = _chunks(T, width)
    partials = torch.empty((chunks[0][1], width), dtype=torch.complex64, device=psi.device)
    for t0, t1 in chunks:
        # the C side also chunks the 65535-term grid-y limit
        _launch("pauli_inner", lib.qsfh_pauli_inner, a.data_ptr(), psi.data_ptr(), n,
                xs[t0:].data_ptr(), zs[t0:].data_ptr(), t1 - t0, partials.data_ptr(),
                out[t0:].data_ptr(), _stream(), launches=-(-(t1 - t0) // 65535))
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
    width = lib.qsfh_adjoint_blocks(n)
    chunks = _chunks(T, width)
    partials = torch.empty((chunks[0][1], width), dtype=torch.complex64, device=psi.device)
    for t0, t1 in chunks:
        _launch("adjoint_rotation", lib.qsfh_adjoint_rotation, psi.data_ptr(), lam.data_ptr(), n,
                *(t[t0:].data_ptr() for t in args), t1 - t0, partials.data_ptr(),
                out[t0:].data_ptr(), _stream(), launches=t1 - t0)
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


# -- tile runs ------------------------------------------------------------------------


def _tile_check(psi, xs, tiles, name: str) -> int:
    """Validate a CUDA call of a tile-run kernel; returns the qubit count."""
    n = _n_qubits(psi, name)
    if xs.shape[0] != tiles.n_terms:
        raise ValueError(f"{name}: {xs.shape[0]} terms against a layout of {tiles.n_terms}")
    if not TILE_MIN_BITS <= tiles.k <= min(n, TILE_MAX_BITS) or not 1 <= tiles.c <= tiles.k - 3:
        raise ValueError(f"{name}: tiles of {tiles.k} bits, {tiles.c} low; the kernel takes "
                         f"{TILE_MIN_BITS} <= k <= min(n, {TILE_MAX_BITS}) and 1 <= c <= k - 3")
    if psi.data_ptr() % 16:
        raise ValueError(f"{name}: the state must be 16-byte aligned")
    return n


def _tile_tables(tiles, r0: int, r1: int):
    """Host pointers of the run tables of runs [r0, r1)."""
    i32 = ctypes.sizeof(ctypes.c_int32)
    return (r1 - r0, *(a.ctypes.data + r0 * i32 for a in (
        tiles.run_start, tiles.run_mask, tiles.run_group, tiles.run_fgroup)))


def _check_tiles(xs, tiles, name: str):
    """Raise unless every flip mask lies inside its run's tile."""
    if xs.shape[0] != tiles.n_terms:
        raise ValueError(f"{name}: {xs.shape[0]} terms against a layout of {tiles.n_terms}")
    mask = torch.as_tensor(tiles.term_mask.astype("int64"), device=xs.device)
    if bool((xs & ~mask).any()):
        raise ValueError(f"{name}: a flip mask leaves its run's tile")


def rotation_tile_runs(psi, xs, zs, angles, phre, phim, tiles):
    """psi <- exp(-i angles[T-1] P_{T-1}) ... exp(-i angles[0] P_0) psi, IN
    PLACE, over the consecutive tile runs ``tiles`` (a
    ``streaming.TileRuns`` built from these xs and zs; terms as in
    :func:`pauli_rotation`).  One launch per run: each run is one pass of
    the state through shared memory and registers.  The kernel reads the
    masks from the layout's tables; xs and zs serve the plain version.
    The layout's fused groups each run as one closed-form pair rotation.
    Returns psi.
    """
    if psi.device.type == "cpu":
        return rotation_tile_runs_plain(psi, xs, zs, angles, phre, phim, tiles)
    n = _tile_check(psi, xs, tiles, "rotation_tile_runs")
    T = xs.shape[0]
    args = _terms(psi, T, "rotation_tile_runs", (angles, _SCALAR), (phre, _SCALAR), (phim, _SCALAR))
    lib = _load()
    _launch("rotation_tile_runs", lib.qsfh_rotation_tile_runs, psi.data_ptr(), n, tiles.k, tiles.c,
            *_tile_tables(tiles, 0, len(tiles)), *(t.data_ptr() for t in tiles.tensors(psi.device)),
            *(a.data_ptr() for a in args), _stream(), launches=len(tiles))
    return psi


def rotation_tile_runs_plain(psi, xs, zs, angles, phre, phim, tiles):
    """Plain version of :func:`rotation_tile_runs`: the plain rotation over
    the terms, one by one (in place, any device)."""
    _check_tiles(xs, tiles, "rotation_tile_runs")
    return pauli_rotation_plain(psi, xs, zs, angles, phre, phim)


def adjoint_tile_runs(psi, lam, xs, zs, angles, phre, phim, tiles):
    """The reverse adjoint sweep (terms in REVERSED order) over the
    consecutive tile runs ``tiles``: the contract of
    :func:`adjoint_rotation`, in one launch per run and one partial-sum
    pass per chunk of runs whose partials fit ``SWEEP_PARTIALS_CAP``.
    psi and lam are updated IN PLACE; returns v (complex, (T,)).
    """
    if psi.device.type == "cpu" and lam.device.type == "cpu":
        return adjoint_tile_runs_plain(psi, lam, xs, zs, angles, phre, phim, tiles)
    n = _tile_check(psi, xs, tiles, "adjoint_tile_runs")
    if _n_qubits(lam, "adjoint_tile_runs") != n or lam.data_ptr() % 16:
        raise ValueError("adjoint_tile_runs: lam must be a 16-byte aligned state of psi's size")
    T = xs.shape[0]
    out = torch.empty(T, dtype=torch.complex64, device=psi.device)
    args = _terms(psi, T, "adjoint_tile_runs", (angles, _SCALAR), (phre, _SCALAR), (phim, _SCALAR))
    lib = _load()
    width = 1 << (n - tiles.k)
    starts = tiles.run_start
    chunks, r0 = [], 0
    for r in range(1, len(tiles) + 1):
        if r == len(tiles) or (starts[r + 1] - starts[r0]) * width > SWEEP_PARTIALS_CAP:
            chunks.append((r0, r))
            r0 = r
    rows = max(int(starts[r1] - starts[r0]) for r0, r1 in chunks)
    partials = torch.empty((rows, width), dtype=torch.complex64, device=psi.device)
    tables = [t.data_ptr() for t in tiles.tensors(psi.device)]
    for r0, r1 in chunks:
        _launch("adjoint_tile_runs", lib.qsfh_adjoint_tile_runs, psi.data_ptr(), lam.data_ptr(), n,
                tiles.k, tiles.c, *_tile_tables(tiles, r0, r1), *tables,
                *(a.data_ptr() for a in args), partials.data_ptr(),
                out[int(starts[r0]):].data_ptr(), _stream(), launches=r1 - r0)
    return out


def adjoint_tile_runs_plain(psi, lam, xs, zs, angles, phre, phim, tiles):
    """Plain version of :func:`adjoint_tile_runs`: the plain adjoint sweep
    over the terms, one by one (in place, any device)."""
    _check_tiles(xs, tiles, "adjoint_tile_runs")
    return adjoint_rotation_plain(psi, lam, xs, zs, angles, phre, phim)


# -- resident tile runs -----------------------------------------------------------------

_capacity: dict = {}
_barriers: dict = {}


def resident_grid(psi, tiles, adjoint: bool, blocks=None) -> int:
    """Blocks G of a resident launch on psi's card: the kernel's co-resident
    capacity (its occupancy at its real dynamic shared memory, for the
    layout's tile shape and longest run, times the SMs; cached per device
    and shape), capped at the tiles of a run and at ``blocks``.  Raises if
    the query fails or the card holds no block of the kernel."""
    n = _n_qubits(psi, "resident_grid")
    return _cooperative_grid(
        n, tiles.k, (psi.device.index, "f32", bool(adjoint), tiles.k, tiles.most_terms),
        lambda lib: lib.qsfh_resident_capacity(int(adjoint), tiles.k, tiles.most_terms),
        f"resident capacity at k={tiles.k}, {tiles.most_terms} terms", blocks)


def _cooperative_grid(n: int, k: int, key, query, what: str, blocks) -> int:
    """The capacity ``query(lib)`` returns (blocks, or a negative CUDA
    error code; cached under ``key``), capped at the 2^(n - k) tiles of a
    run and at ``blocks``."""
    if key not in _capacity:
        lib = _load()
        cap = query(lib)
        if cap <= 0:
            raise RuntimeError(f"{what}: CUDA error {-cap}: {lib.qsfh_error_string(-cap).decode()}")
        _capacity[key] = cap
    grid = min(_capacity[key], 1 << (n - k))
    if blocks is not None:
        if blocks < 1:
            raise ValueError(f"resident launch of {blocks} blocks")
        grid = min(grid, int(blocks))
    return grid


def _barrier(psi) -> torch.Tensor:
    """The grid-barrier word of psi's card and the current stream: zero
    before the first resident launch; a launch leaves its low 31 bits at 0
    (the top bit flips at every barrier)."""
    key = (psi.device.index, _stream())
    if key not in _barriers:
        _barriers[key] = torch.zeros(1, dtype=torch.int32, device=psi.device)
    return _barriers[key]


_fold_counts: dict = {}


def _fold_count(psi) -> torch.Tensor:
    """The arrival count of a folded expectation's partial-sum pass on
    psi's card and the current stream (the block that arrives last sums
    the blocks' values): zero before and after every launch.  A word of
    its own: the resident kernels' barrier word flips its top bit."""
    key = (psi.device.index, _stream())
    if key not in _fold_counts:
        _fold_counts[key] = torch.zeros(1, dtype=torch.int32, device=psi.device)
    return _fold_counts[key]


def rotation_resident(psi, xs, zs, angles, phre, phim, tiles, blocks=None):
    """:func:`rotation_tile_runs` over the whole span ``tiles`` in ONE
    cooperative launch: G persistent blocks walk the runs in order over
    the L2-resident state, block b taking tiles b, b + G, ... of each run,
    with a grid barrier between runs (``blocks`` caps G; see
    :func:`resident_grid`).  A block copies in and stages run r + 1's
    inputs while run r runs, behind a split-phase barrier.  The layout's
    fused groups each run as one closed-form pair rotation
    (``streaming.fused_groups``).  In place; returns psi.
    """
    if psi.device.type == "cpu":
        return rotation_resident_plain(psi, xs, zs, angles, phre, phim, tiles)
    name = "rotation_resident"
    n = _tile_check(psi, xs, tiles, name)
    args = _terms(psi, xs.shape[0], name, (angles, _SCALAR), (phre, _SCALAR), (phim, _SCALAR))
    grid = resident_grid(psi, tiles, False, blocks)
    lib = _load()
    _launch(name, lib.qsfh_rotation_resident, psi.data_ptr(), n, tiles.k, tiles.c, len(tiles), grid,
            tiles.run_start.ctypes.data, *(t.data_ptr() for t in tiles.run_tensors(psi.device)),
            *(t.data_ptr() for t in tiles.tensors(psi.device)), *(a.data_ptr() for a in args),
            _barrier(psi).data_ptr(), _stream())
    return psi


def rotation_resident_plain(psi, xs, zs, angles, phre, phim, tiles):
    """Plain version of :func:`rotation_resident`: the layout check, then
    the plain rotation over the terms, one by one (in place, any device)."""
    _check_tiles(xs, tiles, "rotation_resident")
    return pauli_rotation_plain(psi, xs, zs, angles, phre, phim)


def adjoint_resident(psi, lam, xs, zs, angles, phre, phim, tiles, blocks=None):
    """:func:`adjoint_tile_runs` over the whole span ``tiles`` (terms in
    REVERSED order) in ONE cooperative launch, as
    :func:`rotation_resident`.  Each tile's share of <lam | P_t psi> is a
    partial of its own, and the launch sums each term's partials in a
    fixed order after a last grid barrier: the same bits whatever G.  A
    fused group reads every term's share at the group's end state (its
    terms commute) and rotates back once.  psi and lam are updated IN
    PLACE; returns v (complex, (T,)).
    """
    if psi.device.type == "cpu" and lam.device.type == "cpu":
        return adjoint_resident_plain(psi, lam, xs, zs, angles, phre, phim, tiles)
    name = "adjoint_resident"
    n = _tile_check(psi, xs, tiles, name)
    if tiles.k > RESIDENT_ADJOINT_MAX_BITS:
        raise ValueError(f"{name}: tiles of {tiles.k} bits; the kernel takes at most "
                         f"{RESIDENT_ADJOINT_MAX_BITS}")
    if _n_qubits(lam, name) != n or lam.data_ptr() % 16:
        raise ValueError(f"{name}: lam must be a 16-byte aligned state of psi's size")
    T = xs.shape[0]
    args = _terms(psi, T, name, (angles, _SCALAR), (phre, _SCALAR), (phim, _SCALAR))
    grid = resident_grid(psi, tiles, True, blocks)
    out = torch.empty(T, dtype=torch.complex64, device=psi.device)
    partials = torch.empty((T, 1 << (n - tiles.k)), dtype=torch.complex64, device=psi.device)
    lib = _load()
    _launch(name, lib.qsfh_adjoint_resident, psi.data_ptr(), lam.data_ptr(), n, tiles.k, tiles.c,
            len(tiles), grid, tiles.run_start.ctypes.data,
            *(t.data_ptr() for t in tiles.run_tensors(psi.device)),
            *(t.data_ptr() for t in tiles.tensors(psi.device)), *(a.data_ptr() for a in args),
            partials.data_ptr(), out.data_ptr(), _barrier(psi).data_ptr(), _stream())
    return out


def adjoint_resident_plain(psi, lam, xs, zs, angles, phre, phim, tiles):
    """Plain version of :func:`adjoint_resident`: the layout check, then
    the plain adjoint sweep over the terms, one by one (in place, any
    device)."""
    _check_tiles(xs, tiles, "adjoint_resident")
    return adjoint_rotation_plain(psi, lam, xs, zs, angles, phre, phim)


# -- xor_gather and the one-term rotation ------------------------------------------------


def xor_gather(psi, x):
    """out[b] = psi[b ^ x] (a new tensor); ``x`` is a flat mask, an int or
    a one-element integer tensor on psi's device (read on the device, so
    a traced mask needs no host sync; an int32 or int64 mask is read in
    place, its low 32-bit word)."""
    if psi.device.type == "cpu":
        return xor_gather_plain(psi, x)
    n = _n_qubits(psi, "xor_gather")
    mask_dev, mask = 0, 0
    if isinstance(x, torch.Tensor):
        if x.get_device() != psi.get_device() or x.numel() != 1:
            raise ValueError(f"xor_gather: expected a one-element mask on {psi.device}")
        if x.dtype not in (torch.int32, torch.int64):
            x = x.to(torch.int64)
        mask_dev = x.data_ptr()
    else:
        mask = int(x)
    if psi.data_ptr() % 16:
        raise ValueError("xor_gather: the state must be 16-byte aligned")
    out = torch.empty_like(psi)
    lib = _load()
    _launch("xor_gather", lib.qsfh_xor_gather, psi.data_ptr(), out.data_ptr(), n, mask_dev, mask,
            _stream())
    return out


def xor_gather_plain(psi, x):
    """Plain version of :func:`xor_gather` (any device)."""
    n = psi.shape[0].bit_length() - 1
    if isinstance(x, torch.Tensor):
        x = x.reshape(()).to(torch.int64)
    return psi[index_bits(n, psi.device) ^ x]


def _one_term(psi, x, z, theta, phre, phim):
    """One-term arrays on psi's device (masks int64, scalars real)."""
    rdt = real_dtype(psi.dtype)
    dtypes = (torch.int64, torch.int64, rdt, rdt, rdt)
    return tuple(torch.as_tensor(v, device=psi.device).reshape(1).to(d)
                 for v, d in zip((x, z, theta, phre, phim), dtypes))


_MASK_DTYPES = (torch.int64, torch.int32)
_SCALAR_DTYPES = (torch.float32,)


def _scalar_args(psi, name, x, z, theta, phre, phim):
    """(pointer, value) pairs of the one-term rotation's scalars, and the
    tensors converted for them (to keep alive until the launch)."""
    args, keep = [], []
    for v, dtypes in ((x, _MASK_DTYPES), (z, _MASK_DTYPES), (theta, _SCALAR_DTYPES),
                      (phre, _SCALAR_DTYPES), (phim, _SCALAR_DTYPES)):
        if isinstance(v, torch.Tensor):
            if v.get_device() != psi.get_device() or v.numel() != 1:
                raise ValueError(f"{name}: expected one-element tensors on {psi.device}")
            if v.dtype not in dtypes:
                v = v.to(dtypes[0])
                keep.append(v)
            args += [v.data_ptr(), 0]
        else:
            args += [0, int(v) if dtypes is _MASK_DTYPES else float(v)]
    return args, keep


def _rotation_out(psi, out, x, z, theta, phre, phim):
    """Launch of :func:`pauli_rotation_out` once out is known to be a
    state like psi (counted here)."""
    name = "pauli_rotation_out"
    n = _n_qubits(psi, name)
    if n < 2 or psi.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError(f"{name}: states of at least 2 qubits, 16-byte aligned")
    lib = _load()
    if (type(x) is int and type(z) is int and type(theta) is float and type(phre) is float
            and type(phim) is float):  # plain numbers: the short entry
        _launch(name, lib.qsfh_pauli_rotation_out_values, psi.data_ptr(), out.data_ptr(), n, x,
                z, theta, phre, phim, _stream())
    else:
        args, keep = _scalar_args(psi, name, x, z, theta, phre, phim)
        _launch(name, lib.qsfh_pauli_rotation_out, psi.data_ptr(), out.data_ptr(), n, *args,
                _stream())
    return out


def pauli_rotation_out(psi, out, x, z, theta, phre, phim):
    """out <- exp(-i theta P) psi for ONE term, P psi[b] = (phre + i phim)
    (-1)^popc(b & z) psi[b ^ x]; psi is untouched.  One launch that reads
    psi once and writes out once.  Each of x, z, theta, phre and phim is a
    number (passed by value) or a one-element tensor on psi's device, read
    there in place (an int32 or int64 mask, its low 32-bit word; a float32
    scalar; another dtype is converted first).  Returns out."""
    if psi.device.type == "cpu":
        return out.copy_(pauli_rotation_one_plain(psi, x, z, theta, phre, phim))
    if (out.shape != psi.shape or out.dtype != psi.dtype or out.device != psi.device
            or not out.is_contiguous()):
        raise ValueError("pauli_rotation_out: out must be a contiguous state like psi")
    return _rotation_out(psi, out, x, z, theta, phre, phim)


def pauli_rotation_one(psi, x, z, theta, phre, phim):
    """exp(-i theta P) psi for ONE term, out of place (psi is untouched):
    :func:`pauli_rotation_out` into a new tensor.  Scalars are numbers or
    one-element tensors on psi's device."""
    if psi.device.type == "cpu":
        return pauli_rotation_one_plain(psi, x, z, theta, phre, phim)
    return _rotation_out(psi, torch.empty_like(psi), x, z, theta, phre, phim)


def pauli_rotation_one_plain(psi, x, z, theta, phre, phim):
    """Plain version of :func:`pauli_rotation_one` (any device)."""
    return pauli_rotation_plain(psi.clone(), *_one_term(psi, x, z, theta, phre, phim))


# -- the inner-product tiles ------------------------------------------------------------


def _check_group_tiles(xs, tiles, name: str):
    """Raise unless the layout was built for these xs: every term's flip
    mask inside its tile."""
    if xs.shape[0] != tiles.n_terms:
        raise ValueError(f"{name}: {xs.shape[0]} terms against a layout of {tiles.n_terms}")
    if tiles.order.size:
        idx = torch.as_tensor(tiles.order, device=xs.device)
        mask = torch.as_tensor(tiles.term_mask().astype("int64"), device=xs.device)
        if bool((xs[idx] & ~mask).any()):
            raise ValueError(f"{name}: a flip mask leaves its tile")


def _spill_tensor(tiles, device) -> torch.Tensor:
    """``tiles.spill_index`` on ``device``, built once beside the layout's
    other tables (no host-to-device copy per call: a CUDA graph captures
    the calls)."""
    key = ("spill", str(device))
    if key not in tiles._cache:
        tiles._cache[key] = torch.as_tensor(tiles.spill_index, device=device)
    return tiles._cache[key]


_sms: dict = {}


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (cached)."""
    index = torch.cuda.current_device() if device.index is None else device.index
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sms[index]


# what the fold pass writes: v per term, 2 Im(c v) per term, or sum_t Re(c v)
_FOLD_V, _FOLD_SCREEN, _FOLD_EXPECTATION = 0, 1, 2


def _inner_tiles(name, a, psi, xs, zs, tiles, mode, cre=None, cim=None):
    """The inner-product tile kernel over ``tiles`` (a ``streaming.GroupTiles``
    of xs, zs) and its fold ``mode``: one launch per chunk of tiles whose
    partials fit ``PARTIALS_CAP`` (counted under ``name``); the terms of
    masks that fit no tile (``tiles.spill_index``) take :func:`pauli_inner`
    (counted there) and are folded here in torch."""
    n = _n_qubits(psi, name)
    if _n_qubits(a, name) != n:
        raise ValueError(f"{name}: states of different sizes")
    T = xs.shape[0]
    if T != tiles.n_terms:
        raise ValueError(f"{name}: {T} terms against a layout of {tiles.n_terms}")
    if xs.device != psi.device or zs.device != psi.device:
        raise ValueError(f"{name}: term arrays must be on {psi.device}")
    if mode == _FOLD_V:
        out = torch.empty(T, dtype=torch.complex64, device=psi.device)
        fre = fim = out.view(torch.float32)
        stride = 1
    else:
        fre, fim, stride = _coefficient_planes(psi, cre, cim, T, name)
        shape = (T,) if mode == _FOLD_SCREEN else ()
        out = torch.empty(shape, dtype=torch.float32, device=psi.device)
    if tiles.n_tiles:
        if not INNER_TILE_MIN_BITS <= tiles.k <= min(n, INNER_TILE_MAX_BITS) or not 1 <= tiles.c:
            raise ValueError(f"{name}: tiles of {tiles.k} bits, {tiles.c} low; the kernel takes "
                             f"{INNER_TILE_MIN_BITS} <= k <= min(n, {INNER_TILE_MAX_BITS}), c >= 1")
        sms = sm_count(psi.device)
        positions, width, rows, plan = tiles.plan(n, sms, PARTIALS_CAP)
        folds = -(-rows // 8)  # blocks of the fold pass: a float each for E
        scratch = torch.empty(rows * width + folds, dtype=torch.complex64, device=psi.device)
        bsum = scratch[rows * width:].data_ptr()
        (tmask, _, cols, ix, zlc, zout, start, term_d, order, dzin, dzout) = (
            t.data_ptr() for t in tiles.tensors(psi.device))
        unit_rows = tiles.unit_tensor(n, sms, psi.device)
        count = _fold_count(psi).data_ptr() if mode == _FOLD_EXPECTATION else 0
        lib = _load()
        for j, (u0, n_units, t0, n_rows, most) in enumerate(plan):
            _launch(name, lib.qsfh_pauli_inner_tiles, a.data_ptr(), psi.data_ptr(), n, tiles.k,
                    tiles.c, _SWIZZLE, tmask, unit_rows.data_ptr() + 16 * u0, n_units, cols, ix,
                    zlc, zout, start, term_d, order, dzin, dzout, tiles.n_diag,
                    int(tiles.item_start[-1]), t0, n_rows, most, positions, scratch.data_ptr(),
                    mode, fre.data_ptr(), fim.data_ptr(), stride, out.data_ptr(), bsum, count,
                    int(j > 0), _stream())
    elif mode == _FOLD_EXPECTATION:
        out.zero_()
    if tiles.spill_index.size:
        idx = _spill_tensor(tiles, psi.device)
        v = pauli_inner(a, psi, xs[idx], zs[idx])
        if mode == _FOLD_V:
            out[idx] = v
        else:
            cv = torch.complex(cre[idx].float(), cim[idx].float()) * v
            if mode == _FOLD_SCREEN:
                out[idx] = 2.0 * cv.imag
            else:
                out += cv.real.sum()
    return out


def pauli_inner_grouped(a, psi, xs, zs, tiles):
    """:func:`pauli_inner` over items of terms covered by tiles of chosen
    bits: v in input term order.  ``tiles`` is a ``streaming.GroupTiles``
    of (xs, zs) (with ``inner_diagonal``, its x = 0 terms through one
    Walsh-Hadamard diagonal); one state pass per tile serves every item
    inside it, one launch per chunk of tiles whose partials fit
    ``PARTIALS_CAP`` (counted here).  The terms of masks that fit no tile
    (``tiles.spill_index``) take :func:`pauli_inner` (counted there).  The
    kernel reads the items from the layout's tables; xs and zs serve the
    plain version.  The engine calls the folded :func:`expectation_grouped`
    and :func:`screen_grouped`.
    """
    if psi.device.type == "cpu" and a.device.type == "cpu":
        return pauli_inner_grouped_plain(a, psi, xs, zs, tiles)
    return _inner_tiles("pauli_inner_grouped", a, psi, xs, zs, tiles, _FOLD_V)


def pauli_inner_grouped_plain(a, psi, xs, zs, tiles):
    """Plain version of :func:`pauli_inner_grouped`: :func:`pauli_inner_plain`
    in input order (any device)."""
    _check_group_tiles(xs, tiles, "pauli_inner_grouped")
    return pauli_inner_plain(a, psi, xs, zs)


def expectation_grouped(psi, xs, zs, cre, cim, tiles):
    """E = sum_t Re(c_t <psi|P_t|psi>), c_t = cre_t + i cim_t, a 0-d real
    tensor: :func:`pauli_inner_grouped` with a = psi and the coefficients
    folded into its partial-sum pass (read on the device by input term
    index, a stride of 2 for the views of one complex64 tensor), summed
    in a fixed order.  Launches counted as there.
    """
    if psi.device.type == "cpu":
        return expectation_grouped_plain(psi, xs, zs, cre, cim, tiles)
    return _inner_tiles("expectation_grouped", psi, psi, xs, zs, tiles, _FOLD_EXPECTATION,
                        cre, cim)


def expectation_grouped_plain(psi, xs, zs, cre, cim, tiles):
    """Plain version of :func:`expectation_grouped`: the layout check, then
    :func:`pauli_inner_plain` and the fold in torch (any device)."""
    _check_group_tiles(xs, tiles, "expectation_grouped")
    v = pauli_inner_plain(psi, psi, xs, zs)
    return (torch.complex(cre, cim).to(v.dtype) * v).real.sum()


def expectation_partner(a, psi, xs, zs, cre, cim, tiles):
    """E = sum_t Re(c_t <a|P_t|psi>) with a != psi, a 0-d real tensor: the
    fold of :func:`expectation_grouped` over two states (the kernel loads an
    a tile beside each psi tile; the x = 0 terms' Walsh-Hadamard diagonal
    transforms conj(a) psi).  The partner form of a sharded expectation:
    a = this rank's shard, psi = the shard of its XOR partner, the masks
    local.  Launches counted as there.
    """
    if psi.device.type == "cpu" and a.device.type == "cpu":
        return expectation_partner_plain(a, psi, xs, zs, cre, cim, tiles)
    return _inner_tiles("expectation_partner", a, psi, xs, zs, tiles, _FOLD_EXPECTATION,
                        cre, cim)


def expectation_partner_plain(a, psi, xs, zs, cre, cim, tiles):
    """Plain version of :func:`expectation_partner`: the layout check, then
    :func:`pauli_inner_plain` and the fold in torch (any device)."""
    _check_group_tiles(xs, tiles, "expectation_partner")
    v = pauli_inner_plain(a, psi, xs, zs)
    return (torch.complex(cre, cim).to(v.dtype) * v).real.sum()


def screen_grouped(w, psi, xs, zs, cre, cim, tiles):
    """2 Im(c_t <w|P_t|psi>) for every term, in input order (a real (T,)
    tensor): :func:`pauli_inner_grouped` with a = w and the coefficients
    folded into its partial-sum pass, as :func:`expectation_grouped`.
    """
    if psi.device.type == "cpu" and w.device.type == "cpu":
        return screen_grouped_plain(w, psi, xs, zs, cre, cim, tiles)
    return _inner_tiles("screen_grouped", w, psi, xs, zs, tiles, _FOLD_SCREEN, cre, cim)


def screen_grouped_plain(w, psi, xs, zs, cre, cim, tiles):
    """Plain version of :func:`screen_grouped`: the layout check, then
    :func:`pauli_inner_plain` and the fold in torch (any device)."""
    _check_group_tiles(xs, tiles, "screen_grouped")
    v = pauli_inner_plain(w, psi, xs, zs)
    return 2.0 * (torch.complex(cre, cim).to(v.dtype) * v).imag


# -- pauli_apply_grouped ------------------------------------------------------------------


def _coefficient_planes(psi, cre, cim, n_terms: int, name: str):
    """(cre, cim, stride): float32 coefficient arrays on psi's device as
    they are, read with a stride of ``stride`` floats (2 for the real and
    imaginary views of one complex64 tensor); any other dtype is converted."""
    for arr in (cre, cim):
        if arr.device != psi.device:
            raise ValueError(f"{name}: term arrays must be on {psi.device}, got {arr.device}")
        if arr.shape != (n_terms,):
            raise ValueError(f"{name}: expected ({n_terms},) term arrays, got {tuple(arr.shape)}")
    if (cre.dtype != _SCALAR or cim.dtype != _SCALAR or cre.stride() != cim.stride()
            or cre.stride(0) < 1):
        cre, cim = cre.to(_SCALAR).contiguous(), cim.to(_SCALAR).contiguous()
    return cre, cim, cre.stride(0)


def pauli_apply_grouped(psi, xs, zs, cre, cim, tiles):
    """:func:`pauli_apply` over items of terms covered by tiles of chosen
    bits (``tiles``: the ``streaming.GroupTiles`` of (xs, zs), the layout
    the inner products use): one state pass and one launch per tile,
    counted here; the first tile stores the output, each later one adds to
    it.  The terms of masks that fit no tile (``tiles.spill_index``) take
    :func:`pauli_apply` (counted there), added last.  The kernel reads the
    items from the layout's tables and the coefficients by input term
    index; xs and zs serve the plain version.  Returns a new tensor.
    """
    if psi.device.type == "cpu":
        return pauli_apply_grouped_plain(psi, xs, zs, cre, cim, tiles)
    name = "pauli_apply_grouped"
    n = _n_qubits(psi, name)
    T = xs.shape[0]
    if T != tiles.n_terms:
        raise ValueError(f"{name}: {T} terms against a layout of {tiles.n_terms}")
    if xs.device != psi.device or zs.device != psi.device:
        raise ValueError(f"{name}: term arrays must be on {psi.device}")
    cre, cim, stride = _coefficient_planes(psi, cre, cim, T, name)
    out = torch.empty_like(psi)
    if tiles.n_tiles:
        if (not INNER_TILE_MIN_BITS <= tiles.k <= min(n, INNER_TILE_MAX_BITS)
                or not 1 <= tiles.c <= tiles.k - 3):
            raise ValueError(f"{name}: tiles of {tiles.k} bits, {tiles.c} low; the kernel takes "
                             f"{INNER_TILE_MIN_BITS} <= k <= min(n, {INNER_TILE_MAX_BITS}), "
                             f"1 <= c <= k - 3")
        if psi.data_ptr() % 16:
            raise ValueError(f"{name}: the state must be 16-byte aligned")
        _, _, _, _, _, zout, start, term_d, order = tiles.tensors(psi.device)[:9]
        jt, zt, xa, ehi, dzin, dstart, dterm, dzout = tiles.apply_tensors(psi.device)
        lib = _load()
        _launch(name, lib.qsfh_pauli_apply_grouped, psi.data_ptr(), out.data_ptr(), n, tiles.k,
                tiles.c, tiles.n_tiles, tiles.tile_mask.ctypes.data, tiles.tile_items.ctypes.data,
                tiles.tile_diag.ctypes.data,
                *(t.data_ptr() for t in (start, term_d, order, jt, zt, xa, ehi, zout, dzin,
                                         dstart, dterm, dzout)),
                cre.data_ptr(), cim.data_ptr(), stride, 0, _stream(), launches=tiles.n_tiles)
    else:
        out.zero_()
    if tiles.spill_index.size:
        idx = _spill_tensor(tiles, psi.device)
        out += pauli_apply(psi, xs[idx], zs[idx], cre[idx], cim[idx])
    return out


def pauli_apply_grouped_plain(psi, xs, zs, cre, cim, tiles):
    """Plain version of :func:`pauli_apply_grouped`: the layout check, then
    :func:`pauli_apply_plain` (any device)."""
    _check_group_tiles(xs, tiles, "pauli_apply_grouped")
    return pauli_apply_plain(psi, xs, zs, cre, cim)


# -- the float64 Rayleigh readout ---------------------------------------------------------


def expectation_norm_f64(psi, xs, zs, cre, cim, starts):
    """[E, 0, N, 0], a float64 (4,) tensor: E = sum_t Re(c_t <psi|P_t|psi>),
    c_t = cre_t + i cim_t (float64), and N = <psi|psi>, of a complex64
    state, every product formed exactly and every sum taken in float64.
    The terms come sorted by flip mask: group g is terms starts[g] ..
    starts[g + 1] - 1 (``starts``, int32 on psi's device), all of mask
    xs[starts[g]].  One launch (and a fixed-order partial-sum pass, not
    counted): two calls give the same bits.
    """
    if psi.device.type == "cpu":
        return expectation_norm_f64_plain(psi, xs, zs, cre, cim, starts)
    name = "expectation_norm_f64"
    n = _n_qubits(psi, name)
    T = xs.shape[0]
    if starts.device != psi.device or starts.dim() != 1 or starts.shape[0] < 1:
        raise ValueError(f"{name}: expected (groups + 1,) group offsets on {psi.device}")
    args = _terms(psi, T, name, (xs, _MASK), (zs, _MASK), (cre, torch.float64),
                  (cim, torch.float64))
    starts = starts.to(torch.int32).contiguous()
    lib = _load()
    partials = torch.empty(2 * lib.qsfh_f64_blocks(n), dtype=torch.float64, device=psi.device)
    out = torch.empty(4, dtype=torch.float64, device=psi.device)
    _launch(name, lib.qsfh_expectation_norm_f64, psi.data_ptr(), n, starts.shape[0] - 1,
            starts.data_ptr(), *(a.data_ptr() for a in args), partials.data_ptr(), out.data_ptr(),
            _stream())
    return out


def expectation_norm_f64_plain(psi, xs, zs, cre, cim, starts):
    """Plain version of :func:`expectation_norm_f64` (any device): the
    state's complex64 rounding (what the kernel reads; a complex128 state
    is rounded first, as the JAX package's double-float readout rounds it
    to float32 planes) upcast to complex128, then :func:`pauli_inner_plain`."""
    if starts.shape[0] < 1 or starts.shape[0] - 1 > xs.shape[0]:
        raise ValueError("expectation_norm_f64: bad group offsets")
    return _rayleigh64_plain(psi, xs, zs, cre, cim)


def _rayleigh64_plain(psi, xs, zs, cre, cim):
    """[E, 0, N, 0] of psi's complex64 rounding upcast to complex128."""
    p = psi.to(torch.complex64).to(torch.complex128)
    v = pauli_inner_plain(p, p, xs.to(torch.int64), zs.to(torch.int64))
    e = (torch.complex(cre.to(torch.float64), cim.to(torch.float64)) * v).real.sum()
    zero = torch.zeros((), dtype=torch.float64, device=psi.device)
    return torch.stack([e, zero, torch.vdot(p, p).real, zero])


def _f64_planes(psi, cre, cim, n_terms: int, name: str):
    """(cre, cim) as contiguous float64 tensors on psi's device, the planes
    the float64 tile kernels read by input term index: float64 inputs as
    they are (the same storage, every bit), float32 ones widened exactly;
    never through the float32 planes of :func:`_coefficient_planes`."""
    out = []
    for arr in (cre, cim):
        if arr.device != psi.device:
            raise ValueError(f"{name}: term arrays must be on {psi.device}, got {arr.device}")
        if arr.shape != (n_terms,):
            raise ValueError(f"{name}: expected ({n_terms},) term arrays, got {tuple(arr.shape)}")
        if arr.dtype not in (torch.float64, torch.float32):
            raise TypeError(f"{name}: float64 coefficients, got {arr.dtype}")
        out.append(arr.to(torch.float64).contiguous())
    return out


def _spill64(tiles, device):
    """(index, starts) of the terms of masks that fit no tile, for the
    per-term float64 kernels: their input indices sorted by flip mask
    (stable) and the offsets of each mask's group, as int64 / int32 tensors
    on ``device``, built once beside the layout."""
    key = ("spill64", str(device))
    if key not in tiles._cache:
        order = np.argsort(tiles.spill_xs, kind="stable")
        xs = tiles.spill_xs[order]
        starts = np.r_[np.flatnonzero(np.r_[True, xs[1:] != xs[:-1]]), xs.size]
        tiles._cache[key] = (torch.as_tensor(tiles.spill_index[order], device=device),
                             torch.as_tensor(starts.astype(np.int32), device=device))
    return tiles._cache[key]


# the qubits from which each float64 tile kernel is the route, the per-term
# kernel below: where it was faster in turns on the card (device time; at
# 10-16 qubits the tile readout was, H psi's tiles were not: too few blocks a
# launch), timed by chip_smoke.py f64_route_sizes
F64_TILE_MIN_QUBITS = {"expectation_norm_f64_tiles": INNER_TILE_MIN_BITS, "happly64_tiles": 18}


def f64_tile_layout(kernel: str, n: int, build):
    """The route of the float64 readout (``kernel`` =
    ``"expectation_norm_f64_tiles"``) or H psi (``"happly64_tiles"``) at n
    qubits: the layout ``build()`` (a ``streaming.GroupTiles``) for the tile
    kernel from ``F64_TILE_MIN_QUBITS[kernel]`` qubits on where it holds a
    tile or the list's diagonal; None for the per-term kernel (below the
    threshold ``build`` is not called)."""
    if n < F64_TILE_MIN_QUBITS[kernel]:
        return None
    tiles = build()
    return tiles if tiles.n_tiles or tiles.n_diag else None


# tiles the float64 readout kernel takes: 9 <= k <= 12 (its diagonal holds
# 2^(k - 8) doubles a thread)
INNER64_MAX_BITS = 12


def _readout64_args(tiles, n: int, device):
    """(blocks, the layout's arguments of qsfh_expectation_f64_tiles from
    tile_mask to positions) of the readout at n qubits on ``device``, built
    once: the schedule with its diagonal unit, the tables' pointers, the
    most items and staged terms of a unit."""
    key = ("readout64", n, str(device))
    if key not in tiles._cache:
        positions, units = tiles.schedule(n, sm_count(device), diagonal_unit=True)
        slices = -(-(1 << (n - tiles.k)) // positions)
        (tmask, _, cols, ix, zlc, zout, start, term_d, order, dzin, dzout) = (
            t.data_ptr() for t in tiles.tensors(device))
        rows = units[units[:, 3] == 0]
        most_terms = int((tiles.item_start[rows[:, 1] + rows[:, 2]]
                          - tiles.item_start[rows[:, 1]]).max(initial=0))
        unit_rows = tiles.unit_tensor(n, sm_count(device), device, diagonal_unit=True)
        tiles._cache[key] = (len(units) * slices, (
            tmask, unit_rows.data_ptr(), len(units), cols, ix, zlc, zout, start, term_d, order,
            dzin, dzout, tiles.n_diag, int(tiles.item_start[-1]), tiles.diag_mask,
            int(units[:, 2].max()), most_terms, positions))
    return tiles._cache[key]


def expectation_norm_f64_tiles(psi, xs, zs, cre, cim, tiles):
    """:func:`expectation_norm_f64` over the inner-product tiles: [E, 0, N,
    0], a float64 (4,) tensor, of a complex64 state, every product formed
    exactly and every sum taken in float64.  ``tiles`` is the
    ``streaming.GroupTiles`` of (xs, zs) built with ``inner_diagonal`` (the
    x = 0 terms as one Walsh-Hadamard diagonal, which also takes N); the
    terms are in any order and cre / cim (float64) are read by input index.
    ONE launch, the (E, N) fold inside it (counted here: two calls give the
    same bits, and a CUDA graph replays it).  The terms of masks that fit
    no tile take :func:`expectation_norm_f64` (counted there), never a
    float32 kernel, and add their E.
    """
    if psi.device.type == "cpu":
        return expectation_norm_f64_tiles_plain(psi, xs, zs, cre, cim, tiles)
    name = "expectation_norm_f64_tiles"
    n = _n_qubits(psi, name)
    T = xs.shape[0]
    if T != tiles.n_terms:
        raise ValueError(f"{name}: {T} terms against a layout of {tiles.n_terms}")
    if xs.device != psi.device or zs.device != psi.device:
        raise ValueError(f"{name}: term arrays must be on {psi.device}")
    if not INNER_TILE_MIN_BITS <= tiles.k <= min(n, INNER64_MAX_BITS) or not 1 <= tiles.c <= 8:
        raise ValueError(f"{name}: tiles of {tiles.k} bits, {tiles.c} low; the kernel takes "
                         f"{INNER_TILE_MIN_BITS} <= k <= min(n, {INNER64_MAX_BITS}), 1 <= c <= 8")
    cre, cim = _f64_planes(psi, cre, cim, T, name)
    blocks, args = _readout64_args(tiles, n, psi.device)
    partials = torch.empty(2 * blocks, dtype=torch.float64, device=psi.device)
    out = torch.empty(4, dtype=torch.float64, device=psi.device)
    lib = _load()
    _launch(name, lib.qsfh_expectation_f64_tiles, psi.data_ptr(), n, tiles.k, tiles.c, _SWIZZLE,
            *args, cre.data_ptr(), cim.data_ptr(), partials.data_ptr(), out.data_ptr(),
            _fold_count(psi).data_ptr(), _stream())
    if tiles.spill_index.size:
        idx, starts = _spill64(tiles, psi.device)
        out[:1] += expectation_norm_f64(psi, xs[idx], zs[idx], cre[idx], cim[idx], starts)[:1]
    return out


def expectation_norm_f64_tiles_plain(psi, xs, zs, cre, cim, tiles):
    """Plain version of :func:`expectation_norm_f64_tiles`: the layout
    check, then the readout of :func:`expectation_norm_f64_plain` (any
    device)."""
    _check_group_tiles(xs, tiles, "expectation_norm_f64_tiles")
    return _rayleigh64_plain(psi, xs, zs, cre, cim)


# -- the float64 group engine ---------------------------------------------------------


@dataclass(frozen=True)
class Groups64:
    """A float64 group program at the kernel boundary, on one device: G
    groups of at most 8 commuting rotation terms (one flip mask, one
    parameter, one parity of x & z each; ``streaming.group_terms``).
    ``gx``, ``goff`` (G + 1 offsets into ``zsub`` / ``wsub``), ``gflip`` (1
    where the group's unit is i), ``gpidx`` (the group's entry of
    ``theta_ext``; a static group takes the last one), ``zsub`` are int32,
    ``wsub`` (the real weights) float64; ``param_off`` / ``param_groups``
    (int32) list each parameter's groups in ascending order, the order in
    which its gradient is summed."""

    gx: torch.Tensor
    goff: torch.Tensor
    gflip: torch.Tensor
    gpidx: torch.Tensor
    zsub: torch.Tensor
    wsub: torch.Tensor
    param_off: torch.Tensor
    param_groups: torch.Tensor

    @property
    def n_groups(self) -> int:
        return self.gx.shape[0]

    @property
    def n_params(self) -> int:
        return self.param_off.shape[0] - 1

    def check(self, psi, theta_ext, name: str):
        """Raise unless every array lies on psi's device in the kernel's
        type and ``theta_ext`` holds n_params + 1 float64 angles."""
        for field in dataclasses.fields(self):
            arr = getattr(self, field.name)
            dtype = torch.float64 if field.name == "wsub" else torch.int32
            if arr.device != psi.device or arr.dtype != dtype or not arr.is_contiguous():
                raise ValueError(f"{name}: {field.name} must be contiguous {dtype} on "
                                 f"{psi.device}, got {arr.dtype} on {arr.device}")
        if self.goff.shape[0] != self.n_groups + 1:
            raise ValueError(f"{name}: goff must hold n_groups + 1 offsets")
        if (theta_ext.device != psi.device or theta_ext.dtype != torch.float64
                or theta_ext.shape != (self.n_params + 1,)):
            raise ValueError(f"{name}: theta_ext must be ({self.n_params + 1},) float64 on "
                             f"{psi.device}")


def rot64_groups(psi, groups: Groups64, theta_ext):
    """psi <- exp(-i theta_{G-1} M_{G-1}) ... exp(-i theta_0 M_0) psi IN
    PLACE (complex128), theta_g = theta_ext[gpidx[g]], M_g psi[b] = unit_g
    r_g(b) psi[b ^ x_g], r_g(b) = sum_k w_k (-1)^popcount(b & z_k).  One
    launch per group.  Returns psi."""
    if psi.device.type == "cpu":
        return rot64_groups_plain(psi, groups, theta_ext)
    name = "rot64_groups"
    n = _n_qubits(psi, name, torch.complex128)
    groups.check(psi, theta_ext, name)
    g = groups
    lib = _load()
    _launch(name, lib.qsfh_rot64_groups, psi.data_ptr(), n, g.n_groups, g.gx.data_ptr(),
            g.goff.data_ptr(), g.gflip.data_ptr(), g.gpidx.data_ptr(), g.zsub.data_ptr(),
            g.wsub.data_ptr(), theta_ext.data_ptr(), _stream(), launches=g.n_groups)
    return psi


def _group64_r(idx, groups, g: int, goff):
    """r_g(b) over the flat indices (float64), summed in term order."""
    t0, t1 = goff[g], goff[g + 1]
    z = groups.zsub[t0:t1].to(torch.int64)
    s = parity_signs(idx[None, :], z[:, None], torch.float64)
    r = torch.zeros_like(s[0])
    for k in range(t1 - t0):
        r = r + groups.wsub[t0 + k] * s[k]
    return r


def rot64_groups_plain(psi, groups: Groups64, theta_ext):
    """Plain version of :func:`rot64_groups` (in place, any device)."""
    n = psi.shape[0].bit_length() - 1
    idx = index_bits(n, psi.device)
    ang = theta_ext[groups.gpidx.to(torch.int64)]
    goff, gx, gflip = (groups.goff.tolist(), groups.gx.tolist(), groups.gflip.tolist())
    out = psi
    for g in range(len(gx)):
        r = _group64_r(idx, groups, g, goff)
        c, s = torch.cos(ang[g] * r), torch.sin(ang[g] * r)
        if gx[g] == 0:
            out = torch.complex(c, -s) * out
        else:  # unit 1: cos psi - i sin psi[b ^ x]; unit i: cos psi + sin psi[b ^ x]
            out = c * out + (s if gflip[g] else -1j * s) * out[idx ^ gx[g]]
    psi.copy_(out)
    return psi


def happly64(psi, xs, zs, cre, cim, scale: float = 1.0):
    """(out, stats): out = scale * sum_t (cre_t + i cim_t) s_t(b) psi[b ^
    xs_t] (complex128, a new tensor) and stats = [E, 0, N, 0] (float64), E =
    Re <psi|H psi> before the scale, N = <psi|psi>.  Terms with the same
    flip mask in a row share one gather (callers sort by mask).  One launch
    (and a fixed-order partial-sum pass, not counted)."""
    if psi.device.type == "cpu":
        return happly64_plain(psi, xs, zs, cre, cim, scale)
    name = "happly64"
    n = _n_qubits(psi, name, torch.complex128)
    T = xs.shape[0]
    args = _terms(psi, T, name, (xs, _MASK), (zs, _MASK), (cre, torch.float64),
                  (cim, torch.float64))
    lib = _load()
    out = torch.empty_like(psi)
    partials = torch.empty(2 * lib.qsfh_f64_blocks(n), dtype=torch.float64, device=psi.device)
    stats = torch.empty(4, dtype=torch.float64, device=psi.device)
    _launch(name, lib.qsfh_happly64, psi.data_ptr(), out.data_ptr(), n, T,
            *(a.data_ptr() for a in args), float(scale), partials.data_ptr(), stats.data_ptr(),
            _stream())
    return out, stats


def happly64_plain(psi, xs, zs, cre, cim, scale: float = 1.0):
    """Plain version of :func:`happly64` (any device)."""
    h = pauli_apply_plain(psi, xs.to(torch.int64), zs.to(torch.int64), cre, cim)
    zero = torch.zeros((), dtype=torch.float64, device=psi.device)
    stats = torch.stack([torch.vdot(psi, h).real, zero, torch.vdot(psi, psi).real, zero])
    return scale * h, stats


# tiles the float64 application kernel takes: 2^(k - 3) threads (8 slots
# each), two warps to 512; a 64 KiB complex128 tile and its spectrum at most
APPLY64_MIN_BITS = 9
APPLY64_MAX_BITS = 12


def _apply64_args(tiles, device):
    """The ``arrays`` of qsfh_happly64_tiles on ``device``, a ctypes array
    built once beside the layout: the host tile tables and term offsets
    (numpy, kept alive by the layout) and the device tables."""
    key = ("apply64", str(device))
    if key not in tiles._cache:
        _, _, _, _, _, zout, start, term_d, order = tiles.tensors(device)[:9]
        jt, zt, xa, ehi, dzin, dstart, dterm, dzout = tiles.apply_tensors(device)
        host = (tiles.tile_mask, tiles.tile_items, tiles.tile_diag, tiles.item_start,
                tiles.diag_start)
        if not all(a.dtype == np.int32 and a.flags.c_contiguous for a in host):
            raise TypeError("happly64_tiles: the layout's host tables must be contiguous int32")
        ptrs = [a.ctypes.data for a in host] + [t.data_ptr() for t in (
            start, term_d, order, jt, zt, xa, ehi, zout, dzin, dstart, dterm, dzout)]
        tiles._cache[key] = (ctypes.c_void_p * len(ptrs))(*ptrs)
    return tiles._cache[key]


def happly64_tiles(psi, xs, zs, cre, cim, tiles, scale: float = 1.0):
    """:func:`happly64` over the application tiles: (out, stats), out =
    scale * sum_t (cre_t + i cim_t) s_t(b) psi[b ^ xs_t] (complex128, a new
    tensor) and stats = [E, 0, N, 0] (float64), E = Re <psi|H psi> before
    the scale, N = <psi|psi>.  ``tiles`` is the ``streaming.GroupTiles`` of
    (xs, zs) (with ``diagonal``, a tile's x = 0 items as one Walsh-Hadamard
    diagonal); the terms are in any order and cre / cim (float64) are read
    by input index.  One launch per tile in a fixed order (counted here):
    the first stores out, each later one adds, the last scales and folds E
    and N inside its launch.  The terms of masks that fit no tile take
    :func:`happly64` (counted there), never a float32 kernel, added last.
    """
    if psi.device.type == "cpu":
        return happly64_tiles_plain(psi, xs, zs, cre, cim, tiles, scale)
    name = "happly64_tiles"
    n = _n_qubits(psi, name, torch.complex128)
    T = xs.shape[0]
    if T != tiles.n_terms:
        raise ValueError(f"{name}: {T} terms against a layout of {tiles.n_terms}")
    if xs.device != psi.device or zs.device != psi.device:
        raise ValueError(f"{name}: term arrays must be on {psi.device}")
    if (not tiles.n_tiles or not APPLY64_MIN_BITS <= tiles.k <= min(n, APPLY64_MAX_BITS)
            or not 1 <= tiles.c <= tiles.k - 3):
        raise ValueError(f"{name}: {tiles.n_tiles} tiles of {tiles.k} bits, {tiles.c} low; the "
                         f"kernel takes one tile at least, {APPLY64_MIN_BITS} <= k <= "
                         f"min(n, {APPLY64_MAX_BITS}), 1 <= c <= k - 3")
    cre, cim = _f64_planes(psi, cre, cim, T, name)
    out = torch.empty_like(psi)
    stats = torch.empty(4, dtype=torch.float64, device=psi.device)
    partials = torch.empty(2 << (n - tiles.k), dtype=torch.float64, device=psi.device)
    lib = _load()
    _launch(name, lib.qsfh_happly64_tiles, psi.data_ptr(), out.data_ptr(), n, tiles.k, tiles.c,
            tiles.n_tiles, _apply64_args(tiles, psi.device), cre.data_ptr(), cim.data_ptr(),
            float(scale), partials.data_ptr(), stats.data_ptr(), _fold_count(psi).data_ptr(),
            _stream(), launches=tiles.n_tiles)
    if tiles.spill_index.size:
        idx = _spill64(tiles, psi.device)[0]
        h, s = happly64(psi, xs[idx], zs[idx], cre[idx], cim[idx], scale)
        out += h
        stats[:1] += s[:1]
    return out, stats


def happly64_tiles_plain(psi, xs, zs, cre, cim, tiles, scale: float = 1.0):
    """Plain version of :func:`happly64_tiles`: the layout check, then
    :func:`happly64_plain` (any device)."""
    _check_group_tiles(xs, tiles, "happly64_tiles")
    return happly64_plain(psi, xs, zs, cre, cim, scale)


def adjoint64_groups(psi, lam, groups: Groups64, theta_ext):
    """The reverse sweep of :func:`rot64_groups`, in place on psi (the
    program's output) and lam (the cotangent): per group, last first,
    contrib_g = Im <lam| M_g |psi>, then psi and lam inverse-rotated.
    Returns the gradient (n_params,) float64: per parameter the sum of its
    groups' contributions, in ascending group order (two calls give the
    same bits).  One launch per group (and a fold pass, not counted)."""
    if psi.device.type == "cpu" and lam.device.type == "cpu":
        return adjoint64_groups_plain(psi, lam, groups, theta_ext)
    name = "adjoint64_groups"
    n = _n_qubits(psi, name, torch.complex128)
    if _n_qubits(lam, name, torch.complex128) != n:
        raise ValueError(f"{name}: states of different sizes")
    groups.check(psi, theta_ext, name)
    g = groups
    lib = _load()
    partials = torch.empty(g.n_groups * lib.qsfh_rot64_blocks(n), dtype=torch.float64,
                           device=psi.device)
    grad = torch.empty(g.n_params, dtype=torch.float64, device=psi.device)
    _launch(name, lib.qsfh_adjoint64_groups, psi.data_ptr(), lam.data_ptr(), n, g.n_groups,
            g.gx.data_ptr(), g.goff.data_ptr(), g.gflip.data_ptr(), g.gpidx.data_ptr(),
            g.zsub.data_ptr(), g.wsub.data_ptr(), theta_ext.data_ptr(), g.n_params,
            g.param_off.data_ptr(), g.param_groups.data_ptr(), partials.data_ptr(), grad.data_ptr(),
            _stream(), launches=g.n_groups)
    return grad


def adjoint64_groups_plain(psi, lam, groups: Groups64, theta_ext):
    """Plain version of :func:`adjoint64_groups` (in place, any device; the
    contributions are summed per parameter on the host, in group order)."""
    n = psi.shape[0].bit_length() - 1
    idx = index_bits(n, psi.device)
    ang = theta_ext[groups.gpidx.to(torch.int64)]
    goff, gx, gflip = (groups.goff.tolist(), groups.gx.tolist(), groups.gflip.tolist())
    contrib = torch.zeros(len(gx), dtype=torch.float64, device=psi.device)
    p, l = psi, lam
    for g in reversed(range(len(gx))):
        r = _group64_r(idx, groups, g, goff)
        c, s = torch.cos(ang[g] * r), torch.sin(ang[g] * r)
        if gx[g] == 0:  # M diagonal; psi *= exp(+i theta r)
            contrib[g] = (r * (l.conj() * p).imag).sum()
            rot = torch.complex(c, s)
            p, l = rot * p, rot * l
        else:  # unit 1: Im(conj(L) r psi[b ^ x]); unit i: r Re(conj(L) psi[b ^ x])
            gather = idx ^ gx[g]
            pp, lp = p[gather], l[gather]
            v = l.conj() * pp
            contrib[g] = (r * (v.real if gflip[g] else v.imag)).sum()
            q = -s if gflip[g] else 1j * s
            p, l = c * p + q * pp, c * l + q * lp
    psi.copy_(p)
    lam.copy_(l)
    rows = groups.param_groups.to(torch.int64).cpu()
    owner = torch.repeat_interleave(torch.arange(groups.n_params),
                                    torch.diff(groups.param_off.to(torch.int64).cpu()))
    grad = torch.zeros(groups.n_params, dtype=torch.float64)
    grad.index_add_(0, owner, contrib.cpu()[rows])
    return grad.to(psi.device)


def resident64_grid(psi, runs, adjoint: bool, blocks=None) -> int:
    """Blocks G of a float64 resident launch on psi's card: the kernel's
    co-resident capacity at the layout's tile shape and largest run
    (cached per device and shape), capped at the tiles of a run and at
    ``blocks``, as :func:`resident_grid`."""
    n = _n_qubits(psi, "resident64_grid", torch.complex128)
    threads = streaming.resident64_threads(runs.k)
    return _cooperative_grid(
        n, runs.k,
        (psi.device.index, "f64", bool(adjoint), runs.k, threads, runs.most_entries,
         runs.most_groups),
        lambda lib: lib.qsfh_res64_capacity(int(adjoint), runs.k, threads, runs.most_entries,
                                            runs.most_groups),
        f"float64 resident capacity at k={runs.k}", blocks)


def _res64_args(psi, groups: Groups64, theta_ext, runs, name: str):
    """Checks of a float64 resident launch; returns (n, the 10 device
    pointers of the kernel's layout as a ctypes array, table scratch)."""
    n = _n_qubits(psi, name, torch.complex128)
    groups.check(psi, theta_ext, name)
    if runs.n_groups != groups.n_groups or runs.n != n:
        raise ValueError(f"{name}: the layout is of {runs.n_groups} groups at {runs.n} qubits, "
                         f"the program {groups.n_groups} at {n}")
    g = groups
    arrays = [*runs.tensors(psi.device), g.goff, g.gpidx, g.wsub, theta_ext]
    ptrs = (ctypes.c_void_p * len(arrays))(*(a.data_ptr() for a in arrays))
    tables = torch.empty(3 * runs.n_entries, dtype=torch.float64, device=psi.device)
    return n, ptrs, tables


def rot64_resident(psi, groups: Groups64, theta_ext, runs, blocks=None):
    """:func:`rot64_groups` over the tile runs ``runs``
    (``streaming.Group64Runs``) in ONE cooperative launch: the launch fills
    the groups' tables, then G persistent blocks walk the runs in order
    over the L2-resident state, block b taking tiles b, b + G, ... of each
    run, with a grid barrier between runs, each run's groups and tables
    staged a run ahead (``len(runs) - 1`` runs a launch; ``blocks`` caps G;
    see :func:`resident64_grid`).  In place; returns psi."""
    if psi.device.type == "cpu":
        return rot64_resident_plain(psi, groups, theta_ext, runs)
    name = "rot64_resident"
    n, ptrs, tables = _res64_args(psi, groups, theta_ext, runs, name)
    grid = resident64_grid(psi, runs, False, blocks)
    threads = streaming.resident64_threads(runs.k)
    lib = _load()
    _launch(name, lib.qsfh_rot64_resident, psi.data_ptr(), n, runs.k, len(runs), grid, threads,
            runs.n_entries, runs.most_entries, runs.most_groups, ptrs, tables.data_ptr(),
            _barrier(psi).data_ptr(), _stream())
    return psi


def rot64_resident_plain(psi, groups: Groups64, theta_ext, runs):
    """Plain version of :func:`rot64_resident`: the layout check, then
    :func:`rot64_groups_plain` (in place, any device)."""
    runs.check("rot64_resident")
    return rot64_groups_plain(psi, groups, theta_ext)


def adjoint64_resident(psi, lam, groups: Groups64, theta_ext, runs, blocks=None):
    """:func:`adjoint64_groups` over the tile runs ``runs`` in ONE
    cooperative launch (runs last first, groups last first within a run):
    one partial per (group, tile), and after a last grid barrier each
    parameter's groups summed in ascending order, each group's tiles in
    tile order, so two calls give the same bits whatever G.  psi and lam
    are updated IN PLACE; returns the gradient (n_params,) float64."""
    if psi.device.type == "cpu" and lam.device.type == "cpu":
        return adjoint64_resident_plain(psi, lam, groups, theta_ext, runs)
    name = "adjoint64_resident"
    n, ptrs, tables = _res64_args(psi, groups, theta_ext, runs, name)
    if _n_qubits(lam, name, torch.complex128) != n:
        raise ValueError(f"{name}: states of different sizes")
    grid = resident64_grid(psi, runs, True, blocks)
    g = groups
    partials = torch.empty((g.n_groups, 1 << (n - runs.k)), dtype=torch.float64,
                           device=psi.device)
    grad = torch.empty(g.n_params, dtype=torch.float64, device=psi.device)
    threads = streaming.resident64_threads(runs.k)
    lib = _load()
    _launch(name, lib.qsfh_adjoint64_resident, psi.data_ptr(), lam.data_ptr(), n, runs.k, len(runs),
            grid, threads, runs.n_entries, runs.most_entries, runs.most_groups, ptrs,
            tables.data_ptr(), partials.data_ptr(), g.n_params, g.param_off.data_ptr(),
            g.param_groups.data_ptr(), grad.data_ptr(), _barrier(psi).data_ptr(), _stream())
    return grad


def adjoint64_resident_plain(psi, lam, groups: Groups64, theta_ext, runs):
    """Plain version of :func:`adjoint64_resident`: the layout check, then
    :func:`adjoint64_groups_plain` (in place, any device)."""
    runs.check("adjoint64_resident")
    return adjoint64_groups_plain(psi, lam, groups, theta_ext)


# -- dispatch -------------------------------------------------------------------------


@dataclass(frozen=True)
class Impl:
    """The statevector primitives the engine calls: the per-term ones, the
    resident ones it takes up to the chain cap of ``streaming``, the
    tile-run ones past it, the tile ones of inner products and
    applications, the float64 Rayleigh readout (per term and over the
    tiles), and the float64 group engine of ``qsfh_torch.native.statevec``
    (its H psi per term and over the tiles)."""

    rotation: Callable
    apply: Callable
    inner: Callable
    adjoint: Callable
    rotation_runs: Callable
    adjoint_runs: Callable
    rotation_resident: Callable
    adjoint_resident: Callable
    apply_grouped: Callable
    expectation_grouped: Callable
    screen_grouped: Callable
    expectation_norm_f64: Callable
    rot64_groups: Callable
    happly64: Callable
    adjoint64_groups: Callable
    rot64_resident: Callable
    adjoint64_resident: Callable
    expectation_norm_f64_tiles: Callable
    happly64_tiles: Callable
    expectation_partner: Callable


# the wrappers: CUDA kernels for CUDA tensors, plain versions for CPU tensors
KERNELS = Impl(pauli_rotation, pauli_apply, pauli_inner, adjoint_rotation,
               rotation_tile_runs, adjoint_tile_runs, rotation_resident, adjoint_resident,
               pauli_apply_grouped, expectation_grouped, screen_grouped, expectation_norm_f64,
               rot64_groups, happly64, adjoint64_groups, rot64_resident, adjoint64_resident,
               expectation_norm_f64_tiles, happly64_tiles, expectation_partner)
# the plain versions on any device (a reference path on the card)
PLAIN = Impl(pauli_rotation_plain, pauli_apply_plain, pauli_inner_plain, adjoint_rotation_plain,
             rotation_tile_runs_plain, adjoint_tile_runs_plain, rotation_resident_plain,
             adjoint_resident_plain, pauli_apply_grouped_plain, expectation_grouped_plain,
             screen_grouped_plain, expectation_norm_f64_plain, rot64_groups_plain, happly64_plain,
             adjoint64_groups_plain, rot64_resident_plain, adjoint64_resident_plain,
             expectation_norm_f64_tiles_plain, happly64_tiles_plain, expectation_partner_plain)

WRAPPERS = (pauli_rotation, pauli_apply, pauli_inner, adjoint_rotation,
            rotation_tile_runs, adjoint_tile_runs, pauli_inner_grouped, xor_gather,
            rotation_resident, adjoint_resident, pauli_apply_grouped, expectation_grouped,
            screen_grouped, pauli_rotation_out, expectation_norm_f64, rot64_groups, happly64,
            adjoint64_groups, rot64_resident, adjoint64_resident, expectation_norm_f64_tiles,
            happly64_tiles, expectation_partner)


def launch_counts() -> dict:
    """Kernel launches under each wrapper's name since the last
    :func:`reset_launch_counts` (every wrapper of ``WRAPPERS``, 0 where
    nothing launched)."""
    return {fn.__name__: _launches[fn.__name__] for fn in WRAPPERS}


def reset_launch_counts() -> None:
    _launches.clear()
