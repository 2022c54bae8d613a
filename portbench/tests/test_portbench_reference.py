"""The plain reference against what it must reproduce: the committed
ground-state cache's energy, the JAX package's float64 polish records,
and the port itself at small sizes (tests may import the port; the
reference may not)."""

import ast
import json
import os

import numpy as np
import pytest
import torch
from scipy.optimize import minimize

from pb.spec import HERE, path
from reference.hubbard_ref import Problem, Reference

E_EXACT = -5.562308836311793  # the committed 4-state manifold's energy
FLAGSHIP = Problem(3, 3, 1.0, 6.0, 5, 4, "extended")


def _ground_states():
    return np.load(path("portbench/data/hubbard3x3_deg4.npz"))


def test_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "math", "dataclasses", "typing", "numpy", "torch"}
    ref_dir = os.path.join(HERE, "reference")
    for name in os.listdir(ref_dir):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(ref_dir, name)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            assert {m.split(".")[0] for m in mods} <= allowed, (name, mods)


def test_ground_state_cache_energy():
    d = _ground_states()
    ref = Reference(FLAGSHIP)
    assert abs(float(d["energy"]) - E_EXACT) < 1e-12
    for wf in d["wavefunctions"]:
        psi = torch.as_tensor(wf)
        assert abs(ref.rayleigh(psi) - E_EXACT) < 1e-10
        assert abs(ref.sz(psi) - 0.5) < 1e-10


def test_polish_records_1_to_10():
    """L-BFGS-B (maxcor 100) on the reference's value_and_grad from the
    committed checkpoint reproduces the JAX package's evaluations 1-10
    (E and ||g||, 1e-9)."""
    ck = np.load(path("portbench/data/adapt3x3_checkpoint.npz"))
    records = json.load(open(path("portbench/data/polish_fast_evals_1_10.json")))["records"]
    idx = [int(i) for i in ck["param__selected_indices"]]
    ref = Reference(FLAGSHIP)
    got = []

    class Done(Exception):
        pass

    def f(x):
        e, _, g = ref.value_and_grad(x, idx)
        got.append((e, float(np.linalg.norm(g))))
        if len(got) == len(records):
            raise Done
        return e, g

    with pytest.raises(Done):
        minimize(f, np.asarray(ck["param__t"], np.float64), jac=True, method="L-BFGS-B",
                 options=dict(maxiter=100, maxcor=100, ftol=0.0, gtol=1e-9, maxls=60))
    for (e, gn), rec in zip(got, records):
        assert abs(e - rec["E"]) < 1e-9 and abs(gn - rec["gnorm"]) < 1e-9, (e, gn, rec)


@pytest.mark.parametrize("nx,ny,up,down,pool", [(2, 2, 2, 2, "extended"),
                                                (2, 3, 3, 2, "simplified"),
                                                (3, 2, 2, 2, "extended")])
def test_reference_is_the_port(nx, ny, up, down, pool, tmp_path):
    from qsfh_torch.algos.adapt import ADAPT
    from qsfh_torch.ops.pool import (hubbard_interaction_pool_extended,
                                     hubbard_interaction_pool_simplified)

    ops = (hubbard_interaction_pool_extended if pool == "extended"
           else hubbard_interaction_pool_simplified)(nx, ny)
    a = ADAPT(n_epoch=0, threshold1=1e-3, threshold2=1e-3, x_dimension=nx, y_dimension=ny,
              n_electrons=up + down, n_spin_up=up, n_spin_down=down, tunneling=1, coulomb=6,
              pool=ops, plot=False, log_metrics=False, device="cpu", dtype=torch.complex128,
              results_root=str(tmp_path), ground_state_path=str(tmp_path / "gs.npz"))
    ref = Reference(Problem(nx, ny, 1.0, 6.0, up, down, pool),
                    ground_states=np.stack([g.numpy() for g in a._gs]))
    assert len(ref.excitations) == len(ops)
    assert ref.occupied == sorted(a.problem.spin_up_indices + a.problem.spin_down_indices)
    rng = np.random.default_rng(nx * 10 + ny)
    idx = [int(i) for i in rng.choice(len(ops), size=10, replace=False)]
    th = rng.normal(0, 0.3, len(idx))
    a.selected_indices = idx
    psi_p = a.state(torch.tensor(th))
    raw = a._build_stages(tuple(idx))
    e, psi_r, g = ref.value_and_grad(th, idx)
    assert abs(abs(complex(torch.vdot(psi_p, psi_r))) - 1) < 1e-12
    g_p = raw["adjoint"](psi_p, raw["cotangent"](psi_p), torch.tensor(th)).numpy()
    assert abs(float(raw["energy"](psi_p)) - e) < 1e-12
    assert np.abs(g_p - g).max() < 1e-12 * max(1.0, np.abs(g).max())
    sz, s2, fid = (float(v) for v in raw["metrics"](psi_p))
    assert abs(sz - ref.sz(psi_r)) < 1e-12 and abs(s2 - ref.s2(psi_r)) < 1e-12
    assert abs(fid - ref.fidelity(psi_r)) < 1e-12
