"""Metrics logging and training-curve plotting.

Parity with the reference's per-iteration stdout line + live dual-pane PNG
(reference ``models/hva.py:336-352``), plus a structured JSONL stream
the reference lacks (SURVEY.md section 5.5 gap).
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch

try:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    HAVE_MPL = True
except Exception:  # pragma: no cover
    HAVE_MPL = False


class MetricsLogger:
    def __init__(self, jsonl_path: Optional[str] = None, echo: bool = True):
        self.jsonl_path = jsonl_path
        self.echo = echo
        self._t0 = time.time()
        if jsonl_path:
            os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)
            self._fh = open(jsonl_path, "a")
        else:
            self._fh = None

    def log(self, **fields):
        fields.setdefault("wall_time", time.time() - self._t0)
        if self._fh:
            self._fh.write(json.dumps({k: _tofloat(v) for k, v in fields.items()}) + "\n")
            self._fh.flush()
        if self.echo:
            body = " | ".join(
                f"{k}: {v: .6f}" if isinstance(v, float) else f"{k}: {v}"
                for k, v in fields.items()
                if k != "wall_time"
            )
            print(body)

    def close(self):
        if self._fh:
            self._fh.close()


def _tofloat(v):
    if isinstance(v, (np.floating, np.integer)):
        return float(v)
    if isinstance(v, torch.Tensor):
        return float(v)
    return v


def plot_energy_fidelity(
    img_path: str,
    losses,
    fidelities,
    ground_energy: float,
    label: str = "VQE",
    xlabel: str = "epochs",
):
    """Dual-pane energy-vs-ED / fidelity figure (reference hva.py:338-352)."""
    if not HAVE_MPL:
        return
    os.makedirs(os.path.dirname(img_path) or ".", exist_ok=True)
    fig = plt.figure(figsize=(12, 6))
    ax1 = fig.add_subplot(1, 2, 1)
    ax2 = fig.add_subplot(1, 2, 2)
    xs = np.arange(len(losses)) + 1
    ax1.plot(xs, losses, marker="X", color="r", label=label)
    ax1.plot(xs, np.full(len(losses), ground_energy), ls="-", color="g", label="ED")
    ax1.set_xlabel(xlabel)
    ax1.set_ylabel("energy")
    ax1.legend()
    ax1.grid()
    ax2.plot(np.arange(len(fidelities)) + 1, fidelities, marker="X", ls=":", color="coral")
    ax2.set_xlabel(xlabel)
    ax2.set_ylabel("fidelity")
    ax2.grid()
    fig.savefig(img_path)
    plt.close(fig)


def plot_energy_iterations(
    img_path: str,
    iteration_losses,
    epoch_losses,
    ground_energy: float,
    label: str = "ADAPT",
):
    """ADAPT-style iteration/epoch dual pane (reference adapt_vqe.py:445-463)."""
    if not HAVE_MPL:
        return
    os.makedirs(os.path.dirname(img_path) or ".", exist_ok=True)
    fig = plt.figure(figsize=(12, 6))
    ax1 = fig.add_subplot(1, 2, 1)
    ax2 = fig.add_subplot(1, 2, 2)
    n1 = len(iteration_losses)
    ax1.plot(np.arange(n1) + 1, iteration_losses, color="coral", marker="X", ls="--", label=label)
    ax1.plot(np.arange(n1) + 1, np.full(n1, ground_energy), color="violet", label="ED")
    ax1.set_xlabel("iteration")
    ax1.set_ylabel("energy")
    ax1.legend()
    ax1.grid()
    n2 = len(epoch_losses)
    ax2.plot(np.arange(n2) + 1, epoch_losses, color="yellowgreen", marker="X", ls="--", label=label)
    ax2.plot(np.arange(n2) + 1, np.full(n2, ground_energy), color="violet", label="ED")
    ax2.set_xlabel("epoch")
    ax2.set_ylabel("energy")
    ax2.legend()
    ax2.grid()
    fig.savefig(img_path)
    plt.close(fig)
