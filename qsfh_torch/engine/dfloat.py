"""Float64 Rayleigh readout of a complex64 state.

Counterpart of ``qsfh_tpu/engine/dfloat.py:173-243`` with the same public
API: :func:`expectation_norm_df` returns a (4,) ``[e_hi, e_lo, n_hi,
n_lo]`` tensor, and :func:`combine_rayleigh` / :func:`combine_df` combine
it on the host into <psi|op|psi> / <psi|psi> of the float32 state,
evaluated in float64.

The JAX module carries each value as an unevaluated sum of two float32
(``two_sum``, ``two_prod``, the ``df_*`` arithmetic, ``:46-134``) because
the TPU has no float64.  Those error-free transforms are a TPU workaround
and are not ported: the H100 has native float64, a product of two float32
values is exact in float64, and the sums are taken in float64.  So
``hi`` carries the whole value and ``lo`` is 0.  On a CUDA tensor the
readout is the ``expectation_norm_f64_tiles`` kernel from
``kernels.F64_TILE_MIN_QUBITS`` (9) qubits on (one pass of the state per tile
of the layout :func:`f64_layout`, in float64), and the per-amplitude
``expectation_norm_f64`` kernel on smaller states (:func:`f64_route`); on
the CPU their plain versions (the state upcast to complex128).
"""

from __future__ import annotations

import numpy as np
import torch

from . import streaming
from .expectation import Observable
from .kernels import KERNELS, f64_tile_layout


def f64_terms(obs: Observable, device):
    """(xs, zs, cre, cim, starts) of ``obs``'s terms on ``device`` for the
    readout: sorted by flip mask (stable), int32 masks, float64
    coefficients with the reorder sign (``Observable._scan_terms``), and
    the int32 offsets of each mask's group; built once per device."""
    key = ("f64", str(device))
    cache = obs._tensor_cache
    if key not in cache:
        xs, zs, cre, cim = obs._scan_terms()
        order = np.argsort(xs, kind="stable")
        xs = xs[order]
        starts = np.flatnonzero(np.r_[True, xs[1:] != xs[:-1]]) if xs.size else np.zeros(0, int)
        starts = np.r_[starts, xs.size].astype(np.int32)
        cache[key] = (
            torch.as_tensor(xs.astype(np.int32), device=device),
            torch.as_tensor(zs[order].astype(np.int32), device=device),
            torch.as_tensor(cre[order], device=device),
            torch.as_tensor(cim[order], device=device),
            torch.as_tensor(starts, device=device),
        )
    return cache[key]


def f64_layout(obs: Observable, device):
    """(xs, zs, cre, cim, tiles) of ``obs``'s terms for the tile readout:
    the scan terms in their own order (int32 masks, float64 coefficients
    with the reorder sign, ``Observable._scan_terms``) on ``device``, and
    their ``streaming.GroupTiles`` of ``INNER64_TILE_BITS`` /
    ``INNER64_TILE_LOW_BITS`` with the x = 0 terms as one diagonal (built
    once per observable; its tables once per device, as the tensors)."""
    cache = obs._tensor_cache
    if "f64 tiles" not in cache:
        xs, zs, _, _ = obs._scan_terms()
        cache["f64 tiles"] = streaming.GroupTiles(
            xs, zs, obs.n, streaming.INNER64_TILE_BITS, streaming.INNER64_TILE_LOW_BITS,
            diagonal=False, inner_diagonal=True)
    key = ("f64 tiles", str(device))
    if key not in cache:
        xs, zs, cre, cim = obs._scan_terms()
        cache[key] = (
            torch.as_tensor(np.asarray(xs, np.int64).astype(np.int32), device=device),
            torch.as_tensor(np.asarray(zs, np.int64).astype(np.int32), device=device),
            torch.as_tensor(np.asarray(cre, np.float64), device=device),
            torch.as_tensor(np.asarray(cim, np.float64), device=device),
            cache["f64 tiles"],
        )
    return cache[key]


def f64_route(obs: Observable, device) -> str:
    """The readout's kernel for ``obs``'s states: ``"tiles"``
    (``expectation_norm_f64_tiles`` over :func:`f64_layout`) where
    ``kernels.f64_tile_layout`` takes the layout, else ``"terms"``
    (``expectation_norm_f64``)."""
    tiles = f64_tile_layout("expectation_norm_f64_tiles", obs.n,
                            lambda: f64_layout(obs, device)[4])
    return "terms" if tiles is None else "tiles"


def expectation_norm_df(psi: torch.Tensor, n: int, op, impl=None) -> torch.Tensor:
    """[e_hi, e_lo, n_hi, n_lo] (float64, on psi's device) of the complex64
    state ``psi`` (a complex128 state is rounded to complex64 first, as the
    JAX function rounds it to float32 planes): e = Re <psi|op|psi>,
    n = <psi|psi>, lo parts 0.  ``op`` is a PauliSum or an :class:`Observable` of it (whose
    term tensors and layout are then cached); ``impl`` picks the kernel
    wrappers or the plain versions (``engine.kernels.KERNELS`` by default);
    the kernel is :func:`f64_route`'s."""
    obs = op if isinstance(op, Observable) else Observable(op, n)
    if obs.n != n or psi.shape != (1 << n,):
        raise ValueError(f"expectation_norm_df: a state of {n} qubits and an operator on them")
    impl = impl or KERNELS
    if f64_route(obs, psi.device) == "tiles":
        return impl.expectation_norm_f64_tiles(psi, *f64_layout(obs, psi.device))
    return impl.expectation_norm_f64(psi, *f64_terms(obs, psi.device))


def combine_df(hi_lo) -> float:
    """Host combination of a fetched (hi, lo) pair."""
    arr = np.asarray(hi_lo, np.float64)
    return float(arr[0]) + float(arr[1])


def combine_rayleigh(vals) -> float:
    """Host combination of a fetched (4,) [e_hi, e_lo, n_hi, n_lo]."""
    arr = np.asarray(vals, np.float64)
    return (float(arr[0]) + float(arr[1])) / (float(arr[2]) + float(arr[3]))
