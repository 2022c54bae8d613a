"""Carry ADAPT weights and Adam state from the JAX package to the port.

A JAX ADAPT checkpoint (``qsfh_tpu.io.checkpoint.save_model``) holds
``param__t`` (angles), ``param__selected_indices`` (pool positions) and,
when an optimizer state was saved, the leaves of an ``optax.adam`` state in
``jax.tree_util`` order: ``[count, mu, nu]``.  ``torch.optim.Adam`` keeps
the same three quantities as ``step``, ``exp_avg`` and ``exp_avg_sq`` and
applies the same update (b1=0.9, b2=0.999, eps=1e-8 outside the square
root, bias-corrected), so the conversion is a relabelling;
:func:`to_jax_leaves` relabels back.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


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
    if opt_leaves is None:
        return thetas, selected, None
    if len(opt_leaves) != 3:
        raise ValueError(f"expected optax.adam leaves [count, mu, nu], got {len(opt_leaves)}")
    count, mu, nu = opt_leaves
    if np.shape(mu) != tuple(thetas.shape) or np.shape(nu) != tuple(thetas.shape):
        raise ValueError("Adam moments do not match the parameter shape")
    state = {
        "step": torch.tensor(float(np.asarray(count))),
        "exp_avg": torch.tensor(np.asarray(mu), device=device, dtype=dtype),
        "exp_avg_sq": torch.tensor(np.asarray(nu), device=device, dtype=dtype),
    }
    return thetas, selected, state


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
