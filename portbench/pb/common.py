"""What the windows share: the seeded inputs, the port's driver and the
reference."""

from __future__ import annotations

import copy
import time

import numpy as np

from .spec import path


class StopWindow(Exception):
    """Raised by the harness inside the program's loop when the window
    closes."""


class Phases:
    """Host-clock seconds of the set-up's phases, in order."""

    def __init__(self):
        self.seconds = {}
        self._last = time.time()

    def mark(self, name: str):
        now = time.time()
        self.seconds[name] = now - self._last
        self._last = now


def rng_for(seed: int, stream: int = 0) -> np.random.Generator:
    """The generator of one seed (any whole number) and stream."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def ansatz(cfg: dict, seed: int):
    """(pool indices, seeded float64 angles, unseeded angles or None) of the
    configuration: a committed checkpoint's first ``n_operators`` with a
    seeded perturbation, or the first pool operators at seeded angles."""
    a, ts = cfg["ansatz"], cfg["theta_seed"]
    n = int(a["n_operators"])
    if ts["distribution"] != "normal":
        raise ValueError(f"theta_seed distribution {ts['distribution']!r}")
    noise = rng_for(seed).normal(0.0, float(ts["scale"]), n)
    if a["kind"] == "checkpoint":
        d = np.load(path(a["file"]))
        idx = [int(i) for i in d["param__selected_indices"][:n]]
        base = np.asarray(d["param__t"][:n], np.float64)
        if len(idx) != n:
            raise ValueError(f"the checkpoint holds {len(idx)} operators, not {n}")
        return idx, base + noise, base
    if a["kind"] == "pool_prefix":
        return list(range(n)), noise, None
    raise ValueError(f"ansatz kind {a['kind']!r}")


def ground_states(cfg: dict):
    """The configuration's ground-state manifold (complex128 rows), or None."""
    if not cfg.get("ground_states"):
        return None
    return np.load(path(cfg["ground_states"]))["wavefunctions"]


def build_adapt(cfg: dict, device, dtype, results_root: str, log_metrics: bool):
    """The port's ADAPT driver for the configuration (no epochs of its own:
    the window drives it), results under ``results_root``."""
    from qsfh_torch.algos.adapt import ADAPT
    from qsfh_torch.ops.pool import (hubbard_interaction_pool_extended,
                                     hubbard_interaction_pool_simplified)

    nx, ny = cfg["x_dimension"], cfg["y_dimension"]
    pools = {"extended": hubbard_interaction_pool_extended,
             "simplified": hubbard_interaction_pool_simplified}
    truth = (dict(ground_state_path=path(cfg["ground_states"]),
                  degenerate_subspace=int(cfg["degenerate_subspace"]))
             if cfg.get("ground_states") else dict(ground_truth=False))
    return ADAPT(n_epoch=0, threshold1=0.0, threshold2=-1.0, x_dimension=nx, y_dimension=ny,
                 n_electrons=cfg["n_electrons"], n_spin_up=cfg["n_spin_up"],
                 n_spin_down=cfg["n_spin_down"], tunneling=cfg["tunneling"],
                 coulomb=cfg["coulomb"], periodic=cfg.get("periodic", True),
                 pool=pools[cfg["pool"]](nx, ny), plot=False, log_metrics=log_metrics,
                 device=device, dtype=dtype, results_root=results_root, **truth)


def reference_for(cfg: dict, device, store: str = "complex128"):
    """The plain reference of the configuration."""
    from reference.hubbard_ref import Problem, Reference

    problem = Problem(cfg["x_dimension"], cfg["y_dimension"], float(cfg["tunneling"]),
                      float(cfg["coulomb"]), cfg["n_spin_up"], cfg["n_spin_down"], cfg["pool"],
                      cfg.get("periodic", True))
    return Reference(problem, device=device, store=store, ground_states=ground_states(cfg))


def half_gradient(ref):
    """A copy of the reference whose gradient comes out halved (the
    cotangent H psi in place of 2 H psi): a planted fault."""
    faulty = copy.copy(ref)
    sound = ref.value_and_grad

    def value_and_grad(theta, indices):
        e, psi, g = sound(theta, indices)
        return e, psi, 0.5 * g

    faulty.value_and_grad = value_and_grad
    return faulty


def rel(a: float, b: float) -> float:
    """|a - b| / |b| (inf where a is not finite)."""
    if not np.isfinite(a):
        return float("inf")
    return abs(a - b) / abs(b)
