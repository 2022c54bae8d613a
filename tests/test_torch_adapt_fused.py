"""The port's FusedAdaptRunner against the JAX runner and the port's ADAPT.

All at 2x2 (t=1, U=6, 2 up / 2 down), complex128, on the CPU, where the
chunk runs eagerly (the CUDA graph replay is held on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``), ``chunk_iters=4``,
``max_inner_iterations=12``:

* the port runner against the JAX runner: the same selections, iteration
  losses within 1e-9, Sz, S^2, fidelity and ``epoch loss df`` likewise,
  with ``metrics_every_iter`` on and off;
* against the port's sequential ``ADAPT.run`` (as
  ``tests/test_adapt_fused.py`` holds the JAX runner), and
  ``dispatch="stages"`` against ``"fused"``;
* the overshoot bound: a chunk runs to its end before the gradient norm
  is tested;
* the in-flight file: written in the JAX schema (the JAX runner reads
  it); a resume after a stop mid-epoch continues bit for bit to where the
  run without the stop ends; a file the JAX runner wrote resumes in the
  port and ends where the JAX runner's run without a stop ends.
"""

import json
import os

import numpy as np
import pytest
import torch

from qsfh_tpu.algos.adapt import ADAPT as JaxADAPT
from qsfh_tpu.algos.adapt_fused import FusedAdaptRunner as JaxRunner
from qsfh_torch.algos.adapt import ADAPT
from qsfh_torch.algos.adapt_fused import FusedAdaptRunner, initial_state

CFG = dict(
    n_epoch=2, threshold1=1e-2, threshold2=1e-2, x_dimension=2, y_dimension=2,
    n_electrons=4, n_spin_up=2, n_spin_down=2, tunneling=1, coulomb=6, plot=False,
    log_metrics=False, max_inner_iterations=12,
)
K = 4
KEYS = ("iteration loss", "Sz", "S^2", "fidelity", "epoch loss", "epoch loss df")


class Stop(Exception):
    pass


def _port(root, **kw):
    return ADAPT(**dict(CFG, **kw), results_root=str(root), device="cpu")


def _jax(root, **kw):
    return JaxADAPT(**dict(CFG, **kw), results_root=str(root))


@pytest.fixture(scope="module", params=[True, False], ids=["every", "last"])
def pair(request, tmp_path_factory):
    every = request.param
    j = _jax(tmp_path_factory.mktemp("jax_fused"))
    JaxRunner(j, chunk_iters=K, metrics_every_iter=every, verbose=False).run()
    t = _port(tmp_path_factory.mktemp("port_fused"))
    runner = FusedAdaptRunner(t, chunk_iters=K, metrics_every_iter=every, verbose=False)
    runner.run()
    return j, t, runner


def test_matches_the_jax_runner(pair):
    j, t, runner = pair
    assert t.selected_indices == j.selected_indices
    assert t.results["selected operators"] == j.results["selected operators"]
    assert t.results["n_params"] == j.results["n_params"]
    for key in KEYS:
        a, b = np.asarray(t.results[key]), np.asarray(j.results[key])
        assert a.shape == b.shape and a.size > 0, key
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9, err_msg=key)
    np.testing.assert_allclose(t.params_t.numpy(), np.asarray(j.params_t), rtol=0, atol=1e-9)
    assert not os.path.exists(runner.inflight_path)
    assert runner.captures == runner.replays == 0  # the CPU runs the chunk eagerly


def test_matches_sequential_adapt_run(tmp_path):
    seq = _port(tmp_path / "seq")
    seq.run()
    fused = _port(tmp_path / "fused")
    FusedAdaptRunner(fused, chunk_iters=K, metrics_every_iter=True, verbose=False).run()
    assert fused.selected_indices == seq.selected_indices
    assert fused.results["n_params"] == seq.results["n_params"]
    a = np.asarray(seq.results["iteration loss"])
    b = np.asarray(fused.results["iteration loss"])
    m = min(12, len(a), len(b))
    np.testing.assert_allclose(a[:m], b[:m], rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(np.asarray(seq.results["Sz"])[:m],
                               np.asarray(fused.results["Sz"])[:m], atol=1e-8)
    # the overshoot is at most K - 1 steps an epoch
    assert len(b) <= len(a) + 2 * (K - 1)


def test_stages_match_fused(tmp_path):
    runs = {}
    for dispatch in ("fused", "stages"):
        a = _port(tmp_path / dispatch, n_epoch=1, max_inner_iterations=8)
        FusedAdaptRunner(a, chunk_iters=K, dispatch=dispatch, verbose=False).run()
        runs[dispatch] = a
    f, s = runs["fused"], runs["stages"]
    assert f.selected_indices == s.selected_indices
    for key in KEYS:
        np.testing.assert_allclose(np.asarray(s.results[key]), np.asarray(f.results[key]),
                                   rtol=0, atol=1e-10, err_msg=key)


def test_overshoot_is_one_chunk(tmp_path):
    # threshold2 met at the first step: ADAPT.run stops there, the runner
    # at the end of the chunk
    seq = _port(tmp_path / "seq", n_epoch=1, threshold2=1e3)
    seq.run()
    fused = _port(tmp_path / "fused", n_epoch=1, threshold2=1e3)
    FusedAdaptRunner(fused, chunk_iters=K, verbose=False).run()
    assert len(seq.results["iteration loss"]) == 1
    assert len(fused.results["iteration loss"]) == K
    assert fused.results["iteration loss"][0] == pytest.approx(seq.results["iteration loss"][0],
                                                              abs=1e-12)


def test_inflight_round_trip(tmp_path):
    a = _port(tmp_path / "rt")
    runner = FusedAdaptRunner(a, chunk_iters=2, verbose=False)
    a.selected_indices = [3, 1]
    th = torch.tensor([0.1, -0.2], dtype=torch.float64)
    opt = torch.optim.Adam([th], lr=1e-2)
    th.grad = torch.tensor([0.5, 0.25], dtype=torch.float64)
    opt.step()
    runner._save_inflight(th, opt, epoch=5, lr=1e-2)
    got = runner.load_inflight()
    assert got["epoch"] == 5 and got["selected_indices"] == [3, 1] and got["lr"] == 1e-2
    np.testing.assert_array_equal(got["t"], th.numpy())
    count, mu, nu = got["opt_leaves"]
    assert count.dtype == np.int32 and int(count) == 1
    np.testing.assert_array_equal(mu, opt.state[th]["exp_avg"].numpy())
    np.testing.assert_array_equal(nu, opt.state[th]["exp_avg_sq"].numpy())
    # the JAX runner reads the port's file
    j = _jax(tmp_path / "jrt")
    jr = JaxRunner(j, chunk_iters=2, inflight_path=runner.inflight_path, verbose=False)
    j.selected_indices = [3]
    jgot = jr.load_inflight()
    assert jgot["epoch"] == 5 and jgot["selected_indices"] == [3, 1]
    for x, y in zip(jgot["opt_leaves"], got["opt_leaves"]):
        np.testing.assert_array_equal(x, y)
    # a mismatching ansatz prefix refuses to resume
    a.selected_indices = [2, 1]
    assert runner.load_inflight() is None


def test_initial_state(tmp_path):
    a = _port(tmp_path / "psi0", ground_truth=False)
    psi = initial_state(a)
    assert psi.dtype == torch.complex128 and int((psi != 0).sum()) == 1
    assert torch.equal(psi, a._initial_state())


def test_resume_continues_bit_for_bit(tmp_path, monkeypatch):
    whole = _port(tmp_path / "whole")
    FusedAdaptRunner(whole, chunk_iters=K, verbose=False).run()

    save = FusedAdaptRunner._save_inflight
    saves = []

    def stop_after_two(self, *args, **kw):
        save(self, *args, **kw)
        saves.append(1)
        if len(saves) == 2:
            raise Stop

    cut = _port(tmp_path / "cut")
    monkeypatch.setattr(FusedAdaptRunner, "_save_inflight", stop_after_two)
    with pytest.raises(Stop):
        FusedAdaptRunner(cut, chunk_iters=K, verbose=False).run()
    monkeypatch.setattr(FusedAdaptRunner, "_save_inflight", save)

    again = _port(tmp_path / "cut")  # a fresh process's view: no epoch checkpoint yet
    runner = FusedAdaptRunner(again, chunk_iters=K, verbose=False)
    assert runner.load_inflight()["n_iters"] == 2 * K
    runner.run()
    assert again.selected_indices == whole.selected_indices
    assert torch.equal(again.params_t, whole.params_t)
    done = again.results["iteration loss"]
    assert done == whole.results["iteration loss"][2 * K:]
    assert again.results["epoch loss df"] == whole.results["epoch loss df"]


def test_jax_inflight_file_resumes_in_the_port(tmp_path, monkeypatch):
    # the JAX runner stopped after its first chunk; the port continues from
    # its file to where the JAX runner's own run without a stop ends
    whole = _jax(tmp_path / "whole", n_epoch=1)
    JaxRunner(whole, chunk_iters=K, verbose=False).run()
    save = JaxRunner._save_inflight

    def stop(self, *args, **kw):
        save(self, *args, **kw)
        raise Stop

    monkeypatch.setattr(JaxRunner, "_save_inflight", stop)
    cut = JaxRunner(_jax(tmp_path / "cut", n_epoch=1), chunk_iters=K, verbose=False)
    with pytest.raises(Stop):
        cut.run()
    t = _port(tmp_path / "port", n_epoch=1)
    tr = FusedAdaptRunner(t, chunk_iters=K, inflight_path=cut.inflight_path, verbose=False)
    assert tr.load_inflight()["n_iters"] == K
    tr.run()
    assert t.selected_indices == whole.selected_indices
    for key in ("iteration loss", "Sz", "S^2", "fidelity"):
        np.testing.assert_allclose(t.results[key], whole.results[key][K:], rtol=0, atol=1e-9,
                                   err_msg=key)
    for key in ("epoch loss", "epoch loss df"):
        np.testing.assert_allclose(t.results[key], whole.results[key], rtol=0, atol=1e-9,
                                   err_msg=key)
    np.testing.assert_allclose(t.params_t.numpy(), np.asarray(whole.params_t), rtol=0, atol=1e-9)


def test_metrics_log_carries_the_float64_energy(tmp_path):
    a = ADAPT(**dict(CFG, n_epoch=1, max_inner_iterations=8, log_metrics=True),
              results_root=str(tmp_path), device="cpu")
    FusedAdaptRunner(a, chunk_iters=K, verbose=False).run()
    with open(a.metrics.jsonl_path) as fh:
        rows = [json.loads(line) for line in fh]
    assert len(rows) == 8
    with_df = [r for r in rows if "E_df" in r]
    assert [r["iter"] for r in with_df] == [4, 8]
    assert with_df[-1]["E_df"] == a.results["epoch loss df"][-1]
