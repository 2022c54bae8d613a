"""Config dataclasses: the parameter surface of every driver.

Counterpart of ``qsfh_tpu/config.py`` with the same dataclasses, fields
and defaults, consumed by the CLI (:mod:`qsfh_torch.cli`) and programmatic
callers.  ``save_config`` / ``load_config`` write and read the JAX
package's JSON (one object per dataclass, keyed by its class name), so a
file saved by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional


@dataclass
class LatticeConfig:
    """Fermi-Hubbard physics parameters (fermi_hubbard + sector)."""

    x_dimension: int = 2
    y_dimension: int = 2
    tunneling: float = 1.0
    coulomb: float = 6.0
    n_electrons: int = 4
    n_spin_up: int = 2
    n_spin_down: int = 2
    periodic: bool = True
    spinless: bool = False
    particle_hole_symmetry: bool = False

    @classmethod
    def half_filling(cls, x: int, y: int, tunneling: float = 1.0, coulomb: float = 6.0):
        n_e = x * y
        n_up = (n_e + 1) // 2
        return cls(
            x_dimension=x,
            y_dimension=y,
            tunneling=tunneling,
            coulomb=coulomb,
            n_electrons=n_e,
            n_spin_up=n_up,
            n_spin_down=n_e - n_up,
        )

    def driver_kwargs(self) -> dict:
        return dataclasses.asdict(self)


@dataclass
class RunConfig:
    """Shared run/IO parameters."""

    results_root: str = "./results"
    load_model: bool = False
    plot: bool = True
    log_metrics: bool = True
    degenerate_subspace: int = 0  # e.g. 4 for the 3x3 ground manifold


@dataclass
class HVAConfig:
    n_epoch: int = 1000
    reps: int = 10
    lr: float = 1e-2
    threshold: float = 1e-2
    early_stop: bool = False
    checkpoint_every: int = 10


@dataclass
class ADAPTConfig:
    n_epoch: int = 100
    threshold1: float = 1e-2
    threshold2: float = 1e-2
    ratio: float = 0.1
    lr_scale: float = 0.05
    max_inner_iterations: int = 10000


@dataclass
class IQCCConfig:
    n_epoch: int = 100
    lr: float = 1e-2
    threshold: float = 5e-3
    max_inner_iterations: int = 10000
    max_terms: Optional[int] = None


@dataclass
class HEAConfig:
    molecule: str = "H2"  # factory name in qsfh_torch.molecules
    r: float = 0.8  # bond length, Angstrom
    n_epoch: int = 100
    reps: int = 5
    lr: float = 1e-1
    threshold: float = 2e-3
    seed: int = 0


def save_config(path: str, *configs) -> None:
    blob = {type(c).__name__: dataclasses.asdict(c) for c in configs}
    with open(path, "w") as fh:
        json.dump(blob, fh, indent=2)


def load_config(path: str, *types):
    with open(path) as fh:
        blob = json.load(fh)
    return tuple(t(**blob[t.__name__]) for t in types)
