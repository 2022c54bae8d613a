"""The harness end to end on the CPU: tiny cells of each mix through the
port's plain kernels, the planted faults that must come out not correct,
the control, the result line, and what a run refuses to do."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from portbench_tiny import ROOT, cell

import calibrate
from pb.common import reference_for
from pb.runner import run_cell
from pb.spec import load_cell, load_window

train = load_window("fused_train")
polish = load_window("lbfgs_polish")

SEED = 2**31 + 77  # more than 32 signed bits hold


def _well_formed(result, trace):
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    json.loads(json.dumps(result))
    for key, c in result["checks"].items():
        assert set(c) == {"value", "limit"}
    assert result["attempted"] > 0 and result["failed"] == 0
    if not trace:
        assert "setup_s" in result["metrics"] and len(result["metrics"]) == 2
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and np.isfinite(m["value"])


@pytest.mark.parametrize("name,trace", [("tiny.adapt_train", 0), ("tiny.adapt_train", 1),
                                        ("tiny.polish_f64", 0), ("tiny.polish_f64", 1)])
def test_tiny_cell_is_correct(name, trace):
    result, lines = run_cell(cell(name), SEED, 0.3, bool(trace), "cpu")
    _well_formed(result, trace)
    assert result["correct"], result["checks"]
    assert lines[1].startswith("reference check")
    assert [line.split(":")[0] for line in lines[2:]] == [f"check {k}" for k in result["checks"]]


def _stale_value_and_grad(monkeypatch):
    from qsfh_torch.native.statevec import Rot64Program

    sound = Rot64Program.value_and_grad
    first = {}

    def stale(self, theta, psi0):
        if "answer" not in first:
            first["answer"] = sound(self, theta, psi0)
        return first["answer"]

    monkeypatch.setattr(Rot64Program, "value_and_grad", stale)


def _halved_value_and_grad(monkeypatch):
    from qsfh_torch.native.statevec import Rot64Program

    sound = Rot64Program.value_and_grad
    monkeypatch.setattr(Rot64Program, "value_and_grad",
                        lambda self, theta, psi0: (lambda e, g: (e, 0.5 * g))(
                            *sound(self, theta, psi0)))


def _unchanged_step(monkeypatch):
    import torch

    import qsfh_torch.algos.adapt as adapt

    def no_update(thetas, grads, optimizer):
        return thetas, optimizer, torch.linalg.vector_norm(grads)

    monkeypatch.setattr(adapt, "adam_step", no_update)


def _unchanged_from_the_second_chunk(monkeypatch):
    """Adam leaves the state unchanged from the second chunk's first step
    on: a fault of the state carried from one replay to the next."""
    import qsfh_torch.algos.adapt as adapt

    sound = adapt.adam_step
    k = int(cell("tiny.adapt_train").traffic["chunk_iters"])
    calls = []

    def late_no_update(thetas, grads, optimizer):
        calls.append(1)
        if len(calls) <= k:
            return sound(thetas, grads, optimizer)
        import torch

        return thetas, optimizer, torch.linalg.vector_norm(grads)

    monkeypatch.setattr(adapt, "adam_step", late_no_update)


def _halved_gradient(monkeypatch):
    import qsfh_torch.algos.adapt as adapt

    sound = adapt.run_rot_adjoint

    def halved(*args, **kwargs):
        out = sound(*args, **kwargs)
        return (*out[:2], 0.5 * out[2], *out[3:])

    monkeypatch.setattr(adapt, "run_rot_adjoint", halved)


@pytest.mark.parametrize("name,fault", [
    ("tiny.adapt_train", _unchanged_step), ("tiny.adapt_train", _halved_gradient),
    ("tiny.adapt_train", _unchanged_from_the_second_chunk),
    ("tiny.polish_f64", _stale_value_and_grad), ("tiny.polish_f64", _halved_value_and_grad)])
def test_planted_fault_is_not_correct(name, fault, monkeypatch):
    """A step that returns its state unchanged, and an answer altered where
    it is produced (the gradient halved: the cotangent without its factor
    2), under the timed path: the run comes out not correct; so does a
    train step that leaves its state unchanged from the second chunk on
    only.  The cells run on one card with no batch, so the faults of a
    batch or an exchange have no place."""
    fault(monkeypatch)
    result, _ = run_cell(cell(name), SEED, 0.3, False, "cpu")
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("workload", ["h3x3.adapt_train", "h3x3.polish_f64"])
def test_control_fails_the_cell_limits(workload):
    """The control, the reference one precision down in the program's place
    (bfloat16 storage for the complex64 train cells, complex64 for the
    complex128 polish), fails a number of the real cell's limits, here at
    the tiny size."""
    real = load_cell(workload)
    tiny = cell("tiny.polish_f64" if "polish" in workload else "tiny.adapt_train")
    cfg = dict(tiny.config, train_dtype=real.config.get("train_dtype", "complex64"),
               polish_dtype=real.config.get("polish_dtype", "complex128"))
    tiny.config = cfg
    rec = {}
    run_cell(tiny, SEED, 0.3, False, "cpu", keep=rec)
    nums = calibrate.controls(tiny, SEED, "cpu", rec)["control"]
    assert any(v > real.limits[key] for key, v in nums.items()), nums


def test_no_jax_module_is_loaded():
    code = ("import sys; sys.path[:0] = [%r, %r]; import portbench_tiny as t; "
            "from pb.runner import run_cell, forbidden_modules; "
            "run_cell(t.cell('tiny.adapt_train'), 3, 0.2, False, 'cpu'); "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % (os.path.join(ROOT, "portbench", "tests"), os.path.join(ROOT, "portbench")))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "qsfh_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "qsfh_tpu"}


def _cli(cwd, *args):
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_run_without_a_card_prints_no_result():
    out = _cli(ROOT, "--workload", "h3x3.adapt_train", "--seed", "1", "--seconds", "1")
    assert out.returncode == 3 and out.stdout.strip() == ""


def test_run_without_the_program_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path, "--workload", "h3x3.adapt_train", "--seed", "1", "--seconds", "1")
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "No module named 'qsfh_torch'" in out.stderr


def test_train_numbers_leave_out_angles_at_rounding():
    """An angle whose reference gradient is rounding moves by round-off
    under Adam; the change leaves it out, by the reference's gradient."""
    theta0 = np.zeros(4)
    ref = dict(energy=[1.0], gnorm=[1.0], Sz=[0.0], S2=[0.0], fidelity=[0.0], e_df=[1.0],
               theta=[np.array([0.1, 0.2, 0.0, 0.0])], g1=np.array([1.0, 2.0, 1e-17, 0.0]))
    prog = dict(ref, theta=[np.array([0.1, 0.2, 0.08, -0.08])])
    nums = train.numbers(prog, ref, theta0, fidelity=False)
    assert nums["theta_gap"] == 0.0 and nums["dtheta_norm_gap"] == 0.0


def test_polish_reference_is_the_records_at_sampled_points():
    tiny = cell("tiny.polish_f64")
    rec = {}
    result, _ = run_cell(tiny, SEED, 0.3, False, "cpu", keep=rec)
    run = rec["run"]
    ref = reference_for(tiny.config, "cpu")
    j = run["program"]["picked"][-1]
    e, _, g = ref.value_and_grad(run["program"]["xs"][-1], run["inputs"]["indices"])
    assert j < result["attempted"]
    assert polish.numbers(dict(es=[e], gs=[g]), dict(es=[run["program"]["es"][-1]],
                                                     gs=[run["program"]["gs"][-1]]))["e_gap"] < 1e-12
