"""Guards of the port: no JAX, no ``qsfh_tpu``, the card by default.

* ``import qsfh_torch.algos.adapt`` (and ``adapt_fused``, ``hva``,
  ``iqcc``, ``hea``, ``vqd``, ``dynamics``, ``ite``, ``grad.adjoint``,
  ``engine.gates``, ``engine.product_state``, ``linalg.lanczos``,
  ``ops.dressing``, ``ops.dense_dressing``, ``ops.ilc``, ``molecules``,
  ``ops.correlations``, ``ops.entanglement``, ``ops.export``,
  ``linalg.spectral``, ``linalg.symmetry``, ``algos.multistart``,
  ``engine.sampling``, ``cli``, ``config``) succeeds with ``jax`` blocked and loads no
  ``qsfh_tpu`` module, and a molecule builds there (its FCI on the port's Lanczos, on the
  CPU, asked for);
* no module of ``qsfh_torch`` (nor ``chip_smoke.py``) imports jax, optax
  or qsfh_tpu;
* ``ADAPT(...)``, ``HVA(...)``, ``IQCC(...)``, ``VQE(...)`` (HEA),
  ``VQD(...)``, ``TrotterEvolution(...)``, ``ImaginaryTimeEvolution(...)``,
  ``MultistartHVA(...)`` and ``MultistartHEA(...)`` with no device raise
  where CUDA is unavailable; so do the sector Lanczos (``ground_state``,
  ``degenerate_ground_space``), ``HubbardProblem.ground_state`` and the
  CLI (``qsfh_torch.cli.main``) with no device.
"""

import ast
import os
import subprocess
import sys

import jax  # noqa: F401  (the conftest pins JAX to the CPU)
import pytest
import torch

from qsfh_torch.algos import adapt as port_adapt
from qsfh_torch.algos import hva as port_hva
from qsfh_torch.algos import iqcc as port_iqcc
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
        "import qsfh_torch.algos.adapt_fused, qsfh_torch.linalg.lanczos\n"
        "import qsfh_torch.algos.hva, qsfh_torch.grad.adjoint, qsfh_torch.engine.gates\n"
        "import qsfh_torch.algos.iqcc, qsfh_torch.ops.dressing, qsfh_torch.ops.dense_dressing\n"
        "import qsfh_torch.ops.ilc, qsfh_torch.molecules, qsfh_torch.utils.dense\n"
        "import qsfh_torch.engine.product_state, qsfh_torch.algos.hea, qsfh_torch.algos.vqd\n"
        "import qsfh_torch.algos.dynamics, qsfh_torch.algos.ite\n"
        "import qsfh_torch.ops.correlations, qsfh_torch.ops.entanglement, qsfh_torch.ops.export\n"
        "import qsfh_torch.linalg.spectral, qsfh_torch.linalg.symmetry\n"
        "import qsfh_torch.algos.multistart, qsfh_torch.engine.sampling\n"
        "import qsfh_torch.cli, qsfh_torch.config, qsfh_torch.native.statevec\n"
        "assert qsfh_torch.molecules.H2(0.74).fci_energy < -1.13\n"
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


def test_hva_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_hva.HVA(
            n_epoch=1, reps=1, lr=1e-2, x_dimension=2, y_dimension=2, n_electrons=4,
            n_spin_up=2, n_spin_down=2, tunneling=1, coulomb=4, ground_truth=False,
            plot=False, log_metrics=False,
        )


def test_device_and_dtype_policy(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    assert default_dtype("cpu") == torch.complex128
    assert default_dtype("cuda") == torch.complex64
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")


def test_iqcc_without_device_raises_without_cuda(monkeypatch):
    from qsfh_torch.ops.lattice import fermi_hubbard

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_iqcc.IQCC(fermi_hubbard(2, 2, 1.0, 4.0), n_epoch=1, lr=1e-2, threshold=5e-3,
                       ground_truth=False, plot=False, log_metrics=False)


def test_new_entry_points_without_device_raise_without_cuda(monkeypatch):
    from qsfh_torch.algos.base import HubbardProblem
    from qsfh_torch.algos.dynamics import TrotterEvolution
    from qsfh_torch.algos.hea import VQE
    from qsfh_torch.algos.ite import ImaginaryTimeEvolution
    from qsfh_torch.algos.multistart import MultistartHEA, MultistartHVA
    from qsfh_torch.algos.vqd import VQD
    from qsfh_torch.molecules import H2

    h2 = H2(0.8)
    p = HubbardProblem(2, 2, 1.0, 4.0, 4, 2, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: VQE(h2, n_epoch=1, reps=1, lr=0.1, threshold=0.0, plot=False,
                              log_metrics=False),
                  lambda: VQD(h2, n_levels=1, log_metrics=False),
                  lambda: TrotterEvolution(p, dt=0.1),
                  lambda: ImaginaryTimeEvolution(p, dbeta=0.01),
                  lambda: MultistartHVA(n_starts=2, n_epoch=1, reps=1, lr=1e-2,
                                        ground_truth=False),
                  lambda: MultistartHEA(h2, n_starts=2, n_epoch=1, reps=1, lr=0.1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    # the CPU on request
    assert VQD(h2, n_levels=1, log_metrics=False, device="cpu").dtype == torch.complex128
    assert TrotterEvolution(p, dt=0.1, device="cpu").device == torch.device("cpu")
    assert MultistartHEA(h2, n_starts=2, n_epoch=1, reps=1, lr=0.1,
                         device="cpu").dtype == torch.complex128


def test_exact_diagonalization_and_cli_default_to_the_card(tmp_path, monkeypatch):
    from qsfh_torch import cli
    from qsfh_torch.algos.base import HubbardProblem
    from qsfh_torch.linalg import lanczos
    from qsfh_torch.ops.jw import jordan_wigner
    from qsfh_torch.ops.lattice import fermi_hubbard

    monkeypatch.delenv("QSFH_ED_CACHE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    hp = jordan_wigner(fermi_hubbard(2, 2, 1.0, 4.0))
    p = HubbardProblem(2, 2, 1.0, 4.0, 4, 2, 2, results_root=str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: lanczos.ground_state(hp, 8, 4, 2, 2),
                  lambda: lanczos.degenerate_ground_space(hp, 8, 4, 2, 2, n_states=2),
                  lambda: p.ground_state(),
                  lambda: cli.main(["ed", "--results-root", str(tmp_path)]),
                  lambda: cli.main(["hea", "--n-epoch", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    # the CPU on request
    e, wf = lanczos.ground_state(hp, 8, 4, 2, 2, device="cpu")
    assert wf.device == torch.device("cpu") and wf.dtype == torch.complex128
    assert not os.path.exists(p.ground_state_path())
