"""Guards of the port: no JAX, no ``qsfh_tpu``, the card by default.

* ``import qsfh_torch.algos.adapt`` succeeds with ``jax`` blocked and loads
  no ``qsfh_tpu`` module;
* no module of ``qsfh_torch`` (nor ``chip_smoke.py``) imports jax, optax
  or qsfh_tpu;
* ``ADAPT(...)`` with no device raises where CUDA is unavailable.
"""

import ast
import os
import subprocess
import sys

import jax  # noqa: F401  (the conftest pins JAX to the CPU)
import pytest
import torch

from qsfh_torch.algos import adapt as port_adapt
from qsfh_torch.algos.base import default_dtype, resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "optax", "qsfh_tpu")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "qsfh_torch")):
        files += [os.path.join(dirpath, f) for f in names if f.endswith(".py")]
    return files


def _imported_roots(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'optax'):\n"
        "    sys.modules[m] = None\n"
        "import qsfh_torch.algos.adapt, qsfh_torch.io.convert, qsfh_torch.engine.kernels\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] == 'qsfh_tpu')\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import(path):
    if not os.path.exists(path):
        pytest.fail(f"{path} is missing")
    assert not set(_imported_roots(path)) & set(FORBIDDEN)


def test_adapt_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_adapt.ADAPT(
            n_epoch=1, threshold1=1e-2, threshold2=1e-2, x_dimension=2, y_dimension=2,
            n_electrons=4, n_spin_up=2, n_spin_down=2, tunneling=1, coulomb=4,
            ground_truth=False, plot=False, log_metrics=False,
        )


def test_device_and_dtype_policy(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    assert default_dtype("cpu") == torch.complex128
    assert default_dtype("cuda") == torch.complex64
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
