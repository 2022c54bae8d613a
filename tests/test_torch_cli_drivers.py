"""The port's CLI against the JAX CLI on the training drivers (complex128, CPU).

``hva``, ``adapt``, ``iqcc`` and ``hea`` through
``qsfh_torch.cli.main([..., "--device", "cpu", "--x64"])`` and
``qsfh_tpu.cli.main([..., "--platform", "cpu", "--x64"])``: the results
JSON each driver writes and the printed result lines agree within 1e-8
(the drivers' own parity is 1e-9).  Where a driver draws its first angles
from ``jax.random`` (HEA) or starts on a saddle whose gradient is
rounding noise (HVA from zero angles), both drivers are given the same
numpy-seeded angles by a subclass the CLI picks up, as the drivers' own
tests do.  ``test_torch_cli_vqd.py`` holds VQD and multistart.
"""

import numpy as np
import torch

import qsfh_tpu.algos.hea as jhea
import qsfh_tpu.algos.hva as jhva
import qsfh_torch.algos.hea as thea
import qsfh_torch.algos.hva as thva
from test_torch_cli import LATTICE_2X2, _own_solves, assert_close, assert_printed_close, run_both

assert _own_solves  # the fixture applies here too


def _vqe_results(files):
    return {k: v for k, v in files.items() if k.startswith("results/vqe_results/")}


def _after_init(monkeypatch, module, name, setter):
    """Replace ``module.name`` by a subclass that calls ``setter(self)``
    after the driver's own ``__init__``."""
    base = getattr(module, name)

    class Seeded(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            setter(self)

    monkeypatch.setattr(module, name, Seeded)


def _compare_results(res):
    jres, tres = _vqe_results(res["jax"][1]), _vqe_results(res["torch"][1])
    assert jres and set(tres) == set(jres)
    assert_close(tres, jres)
    return tres


def test_hva_matches_jax(tmp_path, capsys, monkeypatch):
    def flat(n):
        return np.random.default_rng(3).normal(0, 0.05, size=n)

    def seed_jax(d):
        sizes = [np.asarray(d.params[k]).size for k in ("theta_U", "theta_v", "theta_h")]
        b = np.cumsum([0] + sizes)
        v = flat(b[-1])
        d.params = {k: jhva.jnp.asarray(v[b[i]:b[i + 1]])
                    for i, k in enumerate(("theta_U", "theta_v", "theta_h"))}

    def seed_torch(d):
        d.params_t = torch.tensor(flat(sum(d.sizes)), dtype=d.params_t.dtype)

    _after_init(monkeypatch, jhva, "HVA", seed_jax)
    _after_init(monkeypatch, thva, "HVA", seed_torch)
    argv = ["hva"] + LATTICE_2X2 + ["--n-epoch", "4", "--reps", "2", "--lr", "5e-2", "--no-plot"]
    tres = _compare_results(run_both(argv, tmp_path, capsys, monkeypatch))
    (losses,) = [v["loss"] for v in tres.values()]
    assert len(losses) == 4 and len(set(losses)) == 4  # off the saddle: the loss moves


def test_adapt_matches_jax(tmp_path, capsys, monkeypatch):
    argv = ["adapt"] + LATTICE_2X2 + ["--coulomb", "4", "--n-epoch", "2",
                                      "--max-inner-iterations", "5", "--no-plot"]
    tres = _compare_results(run_both(argv, tmp_path, capsys, monkeypatch))
    (run,) = tres.values()
    assert len(run["epoch loss"]) == 2 and run["selected operators"]


def test_iqcc_molecule_matches_jax(tmp_path, capsys, monkeypatch):
    argv = ["iqcc", "--molecule", "H2", "--r", "0.8", "--n-epoch", "1", "--no-plot"]
    res = run_both(argv, tmp_path, capsys, monkeypatch)
    tres = _compare_results(res)
    (run,) = tres.values()
    assert len(run["epoch"]) == 1
    tl = [s for s in res["torch"][0].splitlines() if s.startswith("epoch:")]
    jl = [s for s in res["jax"][0].splitlines() if s.startswith("epoch:")]
    assert len(tl) == len(jl) == 1
    assert_printed_close(tl[0], jl[0])


def _hea_angles(shape):
    return np.random.default_rng(5).uniform(-np.pi, np.pi, shape)


def test_hea_matches_jax(tmp_path, capsys, monkeypatch):
    def seed_jax(d):
        d.params = jhea.jnp.asarray(_hea_angles(np.asarray(d.params).shape))

    def seed_torch(d):
        d.params = torch.tensor(_hea_angles(tuple(d.params.shape)), dtype=d.params.dtype)

    _after_init(monkeypatch, jhea, "VQE", seed_jax)
    _after_init(monkeypatch, thea, "VQE", seed_torch)
    argv = ["hea", "--molecule", "H2", "--n-epoch", "6", "--no-plot"]
    tres = _compare_results(run_both(argv, tmp_path, capsys, monkeypatch))
    assert [len(v["loss"]) for v in tres.values()] == [6]
