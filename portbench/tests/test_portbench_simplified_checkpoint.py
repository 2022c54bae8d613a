"""A checkpoint-kind configuration on the simplified pool, end to end on the
CPU: the shape of ``hubbard2x6_adapt`` (a committed ADAPT checkpoint of
opposite-spin double excitations at a half-filled ladder) cut to a 2x3
lattice, through ``build_adapt``, ``FusedAdaptRunner`` and the plain
reference, two chunks compared on seeded angles."""

import copy
import json
import os

import numpy as np
import pytest

from portbench_tiny import DATA, bench

from pb.common import ansatz, build_adapt, reference_for
from pb.runner import run_cell
from pb.spec import load_cell, load_window

SEED = 2**33 + 5
NAME = "tiny2x3.adapt_train"


def _config(ckpt_file: str, n_ops: int) -> dict:
    return {
        "name": "tiny2x3_simplified", "source": "test",
        "x_dimension": 2, "y_dimension": 3, "periodic": True, "tunneling": 1.0,
        "coulomb": 2.0, "n_electrons": 6, "n_spin_up": 3, "n_spin_down": 3,
        "pool": "simplified", "degenerate_subspace": 0, "ground_states": None,
        "ansatz": {"kind": "checkpoint", "file": ckpt_file, "n_operators": n_ops},
        "train_dtype": "complex128", "polish_dtype": "complex128", "lr": 0.02,
        "theta_seed": {"distribution": "normal", "scale": 0.001}, "reduced": [],
    }


@pytest.fixture(scope="module")
def simplified_cell(tmp_path_factory):
    """A 2x3 cell whose ansatz is a checkpoint of 14 distinct pool
    operators at seeded angles, written as an ADAPT checkpoint."""
    from qsfh_torch.ops.pool import hubbard_interaction_pool_simplified

    base = tmp_path_factory.mktemp("cell")
    rng = np.random.default_rng(29)
    n_pool = len(hubbard_interaction_pool_simplified(2, 3))
    idx = rng.choice(n_pool, 14, replace=False).astype(np.int64)
    ckpt_file = str(base / "ckpt.npz")
    np.savez(ckpt_file, param__t=rng.normal(0.0, 0.2, idx.size),
             param__selected_indices=idx)
    for sub, name, content in (
            ("configs", "tiny2x3_simplified.json", _config(ckpt_file, int(idx.size))),
            ("traffic", "adapt_train.json", json.load(open(os.path.join(
                DATA, "traffic", "adapt_train.json")))),
            ("limits", NAME + ".json", json.load(open(os.path.join(
                DATA, "limits", "tiny.adapt_train.json"))))):
        os.makedirs(base / sub, exist_ok=True)
        with open(base / sub / name, "w") as fh:
            json.dump(content, fh)
    b = copy.deepcopy(bench())
    b["workloads"].append(dict(name=NAME, config="tiny2x3_simplified", traffic="adapt_train",
                               chips=1, why="test"))
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m and "polish" not in m["name"]:
            m["workloads"].append(NAME)
    return load_cell(NAME, b, str(base)), idx


def test_checkpoint_ansatz_reads_the_file(simplified_cell):
    """``pb.common.ansatz`` gives the checkpoint's operators in order and
    its angles plus the seed's draw."""
    cell, idx = simplified_cell
    got, theta, base = ansatz(cell.config, SEED)
    assert got == [int(i) for i in idx]
    assert theta.shape == base.shape == (idx.size,)
    assert 0 < np.abs(theta - base).max() < 0.01


def test_port_and_reference_agree_on_the_pool(simplified_cell, tmp_path):
    """The port's ADAPT and the reference build the same simplified pool
    and the same energy at the checkpoint's angles."""
    import torch

    cell, idx = simplified_cell
    cfg = cell.config
    vqe = build_adapt(cfg, "cpu", torch.complex128, str(tmp_path), False)
    ref = reference_for(cfg, "cpu")
    assert len(vqe.fermion_pool) == len(ref.excitations)
    _, theta, _ = ansatz(cfg, SEED)
    vqe.selected_indices = [int(i) for i in idx]
    psi = vqe.state(torch.as_tensor(theta))
    e_ref, psi_ref, _ = ref.value_and_grad(theta, list(idx))
    assert abs(float(vqe.problem.observables["H"].expectation(psi)) - e_ref) < 1e-10
    assert abs(abs(torch.vdot(psi, psi_ref.to(psi.dtype)).item()) - 1.0) < 1e-10


@pytest.mark.parametrize("trace", [0, 1])
def test_two_chunks_against_the_reference(simplified_cell, trace):
    """The window's two checked chunks (16 fused-runner steps) against the
    reference's 16 steps from the same angles: correct under the tiny
    cells' limits, every compared number present."""
    cell, _ = simplified_cell
    result, _ = run_cell(cell, SEED, 0.3, bool(trace), "cpu")
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == set(cell.limits) - {"fidelity_gap"}
    assert result["attempted"] > 0 and result["failed"] == 0


def test_planted_faults_are_not_correct(simplified_cell):
    """The control and both planted faults, at the tiny limits."""
    cell, _ = simplified_cell
    window = load_window("fused_train")
    record = {}
    run_cell(cell, SEED, 0.2, False, "cpu", keep=record)
    out = window.controls(cell, SEED, "cpu", record["run"],
                          {"complex128": "complex64", "complex64": "bfloat16"})
    for kind in ("control", "fault_state_unchanged", "fault_cotangent_half"):
        nums = out[kind]
        assert any(nums[k] > cell.limits[k] for k in nums if k in cell.limits), (kind, nums)
