"""On the card: each cell runs correct, the control fails each cell's
limits at the cell's own size on three seeds, and a checkout without the
program refuses to run.  Marked ``gpu``; each test skips without a card
(decided in the fixture, not at import)."""

import os
import shutil
import subprocess
import sys

import pytest

import calibrate
from pb.runner import run_cell
from pb.spec import ROOT, load_cell

pytestmark = pytest.mark.gpu
WORKLOADS = ("h3x3.adapt_train", "h3x3.polish_f64")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_is_correct_on_the_card(workload, card):
    result, _ = run_cell(load_cell(workload), 2**31 + 5, 3.0, False, card)
    assert result["correct"], result["checks"]
    assert result["device"]["kind"].startswith("NVIDIA")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_at_the_cells_size(workload, card):
    cell = load_cell(workload)
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        rec = {}
        run_cell(cell, seed, 2.0, False, card, keep=rec)
        nums = calibrate.controls(cell, seed, card, rec)["control"]
        assert any(v > cell.limits[key] for key, v in nums.items() if key in cell.limits), nums


def test_checkout_without_the_program_fails(card, tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "h3x3.adapt_train",
                          "--seed", "1", "--seconds", "1"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
