"""The 2x6 cell ``h2x6.adapt_train``: its committed data on the CPU, its
tile-run layout, and on the card the cell's run and its control.

The checkpoint is the port's own 2x6 ADAPT run (``runs/adapt_2x6/``); the
configuration states its file's sha256.  The tests marked ``gpu`` skip
without a card (decided in the fixture, not at import)."""

import hashlib
import json
import os
import re

import numpy as np
import pytest

from pb.common import ansatz, ground_states
from pb.spec import ROOT, load_cell, path

WORKLOAD = "h2x6.adapt_train"
CONFIG = os.path.join(ROOT, "portbench", "configs", "hubbard2x6_adapt.json")


@pytest.fixture(scope="module")
def cfg():
    with open(CONFIG) as fh:
        return json.load(fh)


def _sha256(file: str) -> str:
    h = hashlib.sha256()
    with open(path(file), "rb") as fh:
        for block in iter(lambda: fh.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _stated_sha256(cfg: dict, name: str) -> str:
    """The sha256 the configuration's ``assumed`` states for a data file."""
    text = cfg["assumed"]["data." + name]
    return re.search(r"sha256 ([0-9a-f]{64})", text).group(1)


def test_the_cell_is_declared(cfg):
    """The cell names the configuration and the train mix on one chip; the
    configuration cuts nothing and names the source."""
    cell = load_cell(WORKLOAD)
    assert cell.chips == 1 and cell.config == cfg
    assert cell.traffic["window"] == "fused_train" and cell.traffic["chunk_iters"] == 8
    assert cfg["reduced"] == [] and cfg["source"].endswith("models/adapt_vqe.py")
    # Sz is not compared: the control and both faults keep it exactly (PERF.md §2)
    assert set(cell.limits) == {"loss_gap", "gnorm_gap", "dtheta_norm_gap", "theta_gap",
                                "s2_gap", "e_df_gap", "fidelity_gap"}
    assert {m["name"] for m in cell.per_layer} == {
        "kernels_per_step.train", "sweep_roofline.train", "idle_share.train", "mfu.train"}


@pytest.mark.parametrize("name", ["adapt2x6_checkpoint.npz", "hubbard2x6_gs.npz"])
def test_data_files_match_the_stated_sha256(cfg, name):
    assert _sha256(os.path.join("portbench", "data", name)) == _stated_sha256(cfg, name)


def test_checkpoint_loads_through_the_harness(cfg):
    """``pb.common.ansatz`` reads the whole checkpoint: ``n_operators``
    indices of the 792-generator 2x6 simplified pool (the selection screens
    the whole pool each epoch, so some operators recur, each with an angle
    of its own), and angles near the checkpoint's."""
    from qsfh_torch.ops.pool import hubbard_interaction_pool_simplified

    n = cfg["ansatz"]["n_operators"]
    idx, theta, base = ansatz(cfg, 2**40 + 3)
    assert len(idx) == n == 347 and len(set(idx)) == 281
    assert len(hubbard_interaction_pool_simplified(2, 6)) == 792
    assert all(0 <= i < 792 for i in idx)
    d = np.load(path(cfg["ansatz"]["file"]))
    assert [int(i) for i in d["param__selected_indices"]] == idx
    assert np.array_equal(base, d["param__t"].astype(np.float64))
    assert 0 < np.abs(theta - base).max() < 0.01


def test_ground_state_file(cfg):
    """One normalised state (the (6, 6) ground state is not degenerate) in
    the 2^24 basis, inside the sector, at the stated ED energy."""
    wfs = ground_states(cfg)
    assert wfs.shape == (cfg["degenerate_subspace"], 1 << 24) == (1, 1 << 24)
    w = wfs[0]
    assert abs(np.linalg.norm(w) - 1.0) < 1e-12
    nz = np.flatnonzero(w)
    assert nz.size == 853776  # C(12, 6)^2
    bits = np.unpackbits(nz.astype(">u4").view(np.uint8).reshape(-1, 4), axis=1)[:, 8:]
    assert (bits[:, 0::2].sum(1) == 6).all() and (bits[:, 1::2].sum(1) == 6).all()
    assert float(np.load(path(cfg["ground_states"]))["energy"]) == pytest.approx(-11.5131600358,
                                                                                 abs=1e-9)


def test_tile_layout_fuses_each_double_excitation(cfg, tmp_path):
    """At the 24-qubit tile-run shape, each double excitation of the
    checkpoint (8 consecutive strings of one parameter) lies inside one
    fused group of the forward layout and of the reversed one, so the
    tile-run kernels rotate it in closed form."""
    from qsfh_torch.algos.adapt import ADAPT
    from qsfh_torch.engine.compiled import CompiledCircuit, _tile_route

    a = ADAPT(n_epoch=0, threshold1=1e-2, threshold2=1e-2, x_dimension=2, y_dimension=6,
              n_electrons=12, n_spin_up=6, n_spin_down=6, tunneling=1, coulomb=2,
              ground_truth=False, plot=False, log_metrics=False, device="cpu",
              results_root=str(tmp_path))
    idx, _, _ = ansatz(cfg, 1)
    seg = CompiledCircuit(a._ansatz_ops(idx) + a._net_ops, 24).segments[0]
    pidx = np.asarray(seg.data["pidx"])
    T = pidx.size
    for direction in (1, -1):
        layout, resident = _tile_route(seg, direction, 24)
        assert not resident and layout.n_single == 0
        groups = [(t0 + a_, t0 + b_) for tiles, t0, _ in layout.spans
                  for a_, b_ in tiles.fused.tolist()]
        order = np.arange(T)[::direction]  # layout position -> segment term
        group_of = np.full(T, -1)
        for g, (a_, b_) in enumerate(groups):
            group_of[order[a_:b_]] = g
        for slot in range(len(idx)):
            terms = np.flatnonzero(pidx == slot)
            assert terms.size == 8
            assert terms.max() - terms.min() == 7
            assert (group_of[terms] == group_of[terms[0]]).all() and group_of[terms[0]] >= 0
        assert layout.fused_terms >= 8 * len(idx)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.gpu
def test_cell_is_correct_on_the_card(card):
    from pb.runner import run_cell

    result, _ = run_cell(load_cell(WORKLOAD), 2**31 + 5, 3.0, False, card)
    assert result["correct"], result["checks"]


@pytest.mark.gpu
def test_control_and_faults_fail_at_the_cells_size(card):
    import calibrate
    from pb.runner import run_cell

    cell = load_cell(WORKLOAD)
    seed = 2**31 + 11
    rec = {}
    run_cell(cell, seed, 2.0, False, card, keep=rec)
    out = calibrate.controls(cell, seed, card, rec)
    for kind in ("control", "fault_state_unchanged", "fault_cotangent_half"):
        nums = out[kind]
        assert any(v > cell.limits[key] for key, v in nums.items() if key in cell.limits), (
            kind, nums)
