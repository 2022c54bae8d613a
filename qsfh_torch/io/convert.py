"""Carry ADAPT and HVA weights and Adam state between the JAX package and the port.

A JAX ADAPT checkpoint (``qsfh_tpu.io.checkpoint.save_model``) holds
``param__t`` (angles), ``param__selected_indices`` (pool positions) and,
when an optimizer state was saved, the leaves of an ``optax.adam`` state in
``jax.tree_util`` order: ``[count, mu, nu]``.  ``torch.optim.Adam`` keeps
the same three quantities as ``step``, ``exp_avg`` and ``exp_avg_sq`` and
applies the same update (b1=0.9, b2=0.999, eps=1e-8 outside the square
root, bias-corrected), so the conversion is a relabelling;
:func:`to_jax_leaves` relabels back.

A JAX HVA checkpoint holds ``param__theta_U``, ``param__theta_v`` and
``param__theta_h``; the port keeps one flat tensor [theta_U | theta_v |
theta_h] (:data:`HVA_KEYS`) under one ``torch.optim.Adam``, which is
elementwise and so equals ``optax.adam`` over the dict.  The optax leaves
of the dict come in ``jax.tree_util`` order: ``count``, then ``mu`` and
``nu`` each over the keys SORTED (``theta_U``, ``theta_h``, ``theta_v``:
upper case sorts first), not in the flat order; :func:`hva_from_jax` and
:func:`hva_to_jax_leaves` reorder.

A JAX HEA driver holds its (reps + 1, n, 3) angles as one array under one
``optax.adam`` (:func:`hea_from_jax`).

A JAX multistart driver holds its B starts as the leading axis of
``batch_params``: the HVA dict of (B, ...) arrays or the HEA (B, reps + 1,
n, 3) array (:func:`multistart_from_jax`).

A JAX iQCC driver holds ``params`` (``theta``, ``phi``, ``tau``) and its
current Hamiltonian, as the packed ``(H_x, H_z, H_c)`` arrays of a
``PauliSum`` or, with dense dressing, as the complex128 matrix (its
``.dense.npy`` sidecar); :func:`iqcc_from_jax` makes what the port's
``IQCC`` holds of them.  iQCC checkpoints carry no optimizer state (each
epoch starts a fresh optimizer).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.pauli import PauliSum


def from_jax(
    params: Dict[str, np.ndarray],
    opt_leaves: Optional[List[np.ndarray]] = None,
    device="cpu",
    dtype=torch.float64,
) -> Tuple[torch.Tensor, List[int], Optional[dict]]:
    """(thetas, selected_indices, adam_state) from JAX checkpoint arrays.

    ``adam_state`` is a ``torch.optim.Adam`` per-parameter state dict, or
    None when no optimizer leaves are given; install it with
    :func:`load_adam_state`.
    """
    # copies: an optimizer step must not write into the caller's arrays
    thetas = torch.tensor(np.asarray(params["t"]), device=device, dtype=dtype)
    selected = [int(i) for i in np.asarray(params["selected_indices"])]
    return thetas, selected, _adam_state(opt_leaves, thetas)


def _adam_state(opt_leaves: Optional[List[np.ndarray]], param: torch.Tensor) -> Optional[dict]:
    """The ``torch.optim.Adam`` state of ``param`` from the leaves ``[count,
    mu, nu]`` of an ``optax.adam`` state over one array (None for None)."""
    if opt_leaves is None:
        return None
    if len(opt_leaves) != 3:
        raise ValueError(f"expected optax.adam leaves [count, mu, nu], got {len(opt_leaves)}")
    count, mu, nu = opt_leaves
    if np.shape(mu) != tuple(param.shape) or np.shape(nu) != tuple(param.shape):
        raise ValueError("Adam moments do not match the parameter shape")
    return {
        "step": torch.tensor(float(np.asarray(count))),
        "exp_avg": torch.tensor(np.asarray(mu), device=param.device, dtype=param.dtype),
        "exp_avg_sq": torch.tensor(np.asarray(nu), device=param.device, dtype=param.dtype),
    }


def load_adam_state(optimizer: torch.optim.Adam, param: torch.Tensor, state: dict) -> None:
    """Install a converted Adam state for ``param`` in ``optimizer``.  A
    capturable optimizer (CUDA graphs) keeps ``step`` on the parameter's
    device, as ``torch.optim.Adam`` does itself; otherwise it stays on the
    CPU."""
    capturable = any(g.get("capturable", False) for g in optimizer.param_groups)
    step = state["step"].clone()
    optimizer.state[param] = {
        "step": step.to(param.device) if capturable else step,
        "exp_avg": state["exp_avg"].to(param).clone(),
        "exp_avg_sq": state["exp_avg_sq"].to(param).clone(),
    }


def to_jax_leaves(optimizer: torch.optim.Adam, param: torch.Tensor) -> List[np.ndarray]:
    """The inverse of the Adam part of :func:`from_jax`: ``param``'s state in
    ``optimizer`` as the leaves of an ``optax.adam`` state, ``[count
    (int32), mu, nu]`` (a fresh optimizer gives count 0 and zero moments,
    as ``optax.adam(lr).init`` does)."""
    state = optimizer.state.get(param)
    if not state:
        zeros = torch.zeros(param.shape, dtype=param.dtype).numpy()
        return [np.asarray(0, dtype=np.int32), zeros, zeros.copy()]
    return [
        np.asarray(int(state["step"]), dtype=np.int32),
        state["exp_avg"].detach().cpu().numpy().copy(),
        state["exp_avg_sq"].detach().cpu().numpy().copy(),
    ]


def hea_from_jax(
    params: np.ndarray,
    opt_leaves: Optional[List[np.ndarray]] = None,
    device="cpu",
    dtype=torch.float64,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """(params, adam_state) for the port's HEA ``VQE`` (or a VQD level) from
    the JAX driver's (reps + 1, n, 3) angles and the leaves ``[count, mu,
    nu]`` of its ``optax.adam`` state (``jax.tree_util.tree_leaves``);
    ``adam_state`` as in :func:`from_jax`, installed with
    :func:`load_adam_state`."""
    angles = torch.tensor(np.asarray(params), device=device, dtype=dtype)
    if angles.dim() != 3 or angles.shape[2] != 3:
        raise ValueError(f"expected (reps + 1, n, 3) HEA angles, got {tuple(angles.shape)}")
    return angles, _adam_state(opt_leaves, angles)


# the flat order of the port's HVA parameters, and the optax leaf order
HVA_KEYS = ("theta_U", "theta_v", "theta_h")
_HVA_TREE_ORDER = tuple(sorted(HVA_KEYS))


def hva_from_jax(
    params: Dict[str, np.ndarray],
    opt_leaves: Optional[List[np.ndarray]] = None,
    device="cpu",
    dtype=torch.float64,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """(flat thetas, adam_state) from the arrays of a JAX HVA checkpoint;
    ``adam_state`` as in :func:`from_jax` (None without leaves)."""
    parts = {k: np.asarray(params[k]).ravel() for k in HVA_KEYS}
    flat = torch.tensor(np.concatenate([parts[k] for k in HVA_KEYS]), device=device,
                        dtype=dtype)
    if opt_leaves is None:
        return flat, None
    if len(opt_leaves) != 1 + 2 * len(HVA_KEYS):
        raise ValueError(f"expected optax.adam leaves [count, mu x 3, nu x 3] of an HVA "
                         f"dict, got {len(opt_leaves)}")
    count = opt_leaves[0]
    mu = dict(zip(_HVA_TREE_ORDER, opt_leaves[1:4]))
    nu = dict(zip(_HVA_TREE_ORDER, opt_leaves[4:7]))
    for k in HVA_KEYS:
        if np.shape(mu[k]) != parts[k].shape or np.shape(nu[k]) != parts[k].shape:
            raise ValueError(f"Adam moments of {k} do not match its parameter shape")

    def flat_of(moments):
        return torch.tensor(np.concatenate([np.asarray(moments[k]) for k in HVA_KEYS]),
                            device=device, dtype=dtype)

    state = {"step": torch.tensor(float(np.asarray(count))), "exp_avg": flat_of(mu),
             "exp_avg_sq": flat_of(nu)}
    return flat, state


def hva_split(flat, sizes) -> Dict[str, np.ndarray]:
    """A flat [theta_U | theta_v | theta_h] tensor or array as the JAX dict,
    ``sizes`` the three lengths."""
    flat = flat.detach().cpu().numpy() if torch.is_tensor(flat) else np.asarray(flat)
    bounds = np.cumsum((0,) + tuple(sizes))
    if bounds[-1] != flat.shape[0]:
        raise ValueError(f"{flat.shape[0]} parameters, expected {bounds[-1]}")
    return {k: flat[bounds[i]:bounds[i + 1]].copy() for i, k in enumerate(HVA_KEYS)}


def hva_to_jax_leaves(optimizer: torch.optim.Adam, param: torch.Tensor,
                      sizes) -> List[np.ndarray]:
    """The inverse of the Adam part of :func:`hva_from_jax`: the optax leaves
    ``[count, mu_U, mu_h, mu_v, nu_U, nu_h, nu_v]`` of ``param``'s state."""
    count, mu, nu = to_jax_leaves(optimizer, param)
    mu, nu = hva_split(mu, sizes), hva_split(nu, sizes)
    return [count] + [mu[k] for k in _HVA_TREE_ORDER] + [nu[k] for k in _HVA_TREE_ORDER]


def multistart_from_jax(batch_params, device="cpu", dtype=torch.float64):
    """The port's ``batch_params`` from a JAX multistart driver's (as numpy):
    the HVA dict ``{theta_U, theta_v, theta_h}`` of (B, ...) arrays as a
    dict of tensors, or the HEA (B, reps + 1, n, 3) array as a tensor, on
    ``device`` in ``dtype`` (copies)."""
    if isinstance(batch_params, dict):
        missing = set(HVA_KEYS) - set(batch_params)
        if missing:
            raise ValueError(f"HVA batch_params lack {sorted(missing)}")
        out = {k: torch.tensor(np.asarray(batch_params[k]), device=device, dtype=dtype)
               for k in HVA_KEYS}
        if len({v.shape[0] for v in out.values()}) != 1:
            raise ValueError("HVA batch_params disagree on the number of starts")
        return out
    angles = torch.tensor(np.asarray(batch_params), device=device, dtype=dtype)
    if angles.dim() != 4 or angles.shape[3] != 3:
        raise ValueError(f"expected (B, reps + 1, n, 3) HEA angles, got {tuple(angles.shape)}")
    return angles


IQCC_KEYS = ("theta", "phi", "tau")


def iqcc_from_jax(
    params: Dict[str, np.ndarray],
    hamiltonian=None,
    dense=None,
    device="cpu",
    dtype=torch.float64,
) -> dict:
    """What the port's ``IQCC`` holds, from a JAX iQCC driver's state:
    ``params`` (theta, phi, tau arrays) as trainable leaf tensors of
    ``dtype`` on ``device``, ``hamiltonian`` (a ``(H_x, H_z, H_c)`` triple
    or an object with ``x``, ``z``, ``c`` arrays) as a port ``PauliSum``,
    and ``dense`` (the dressed matrix) as a complex128 tensor on
    ``device``.  Returns ``{"params", "hamiltonian", "dense"}``, None where
    not given."""
    out = {k: torch.tensor(np.asarray(params[k], dtype=np.float64), dtype=dtype,
                           device=device).requires_grad_(True) for k in IQCC_KEYS}
    if hamiltonian is not None:
        x, z, c = hamiltonian if isinstance(hamiltonian, (tuple, list)) else \
            (hamiltonian.x, hamiltonian.z, hamiltonian.c)
        hamiltonian = PauliSum(np.asarray(x), np.asarray(z), np.asarray(c))
    if dense is not None:
        dense = torch.as_tensor(np.asarray(dense, dtype=np.complex128)).to(device)
    return {"params": out, "hamiltonian": hamiltonian, "dense": dense}
