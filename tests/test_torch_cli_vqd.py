"""The port's CLI against the JAX CLI on VQD and multistart (complex128, CPU).

``vqd`` (molecular H2 and the lattice mode's HVA deflation at 2x2) and
``multistart`` (the 2x2 HVA and ``--molecule H2``) through
``qsfh_torch.cli.main([..., "--device", "cpu", "--x64"])`` and
``qsfh_tpu.cli.main([..., "--platform", "cpu", "--x64"])``: the results
JSON and the printed result lines agree within 1e-8.  VQD's first angles
come from ``jax.random`` in the JAX driver, so both drivers are given the
same numpy-seeded angles by a subclass the CLI picks up; multistart draws
its starts from numpy in both packages.
"""

import numpy as np
import pytest

import qsfh_tpu.algos.vqd as jvqd
import qsfh_torch.algos.vqd as tvqd
from test_torch_cli import LATTICE_2X2, _own_solves, assert_printed_close, run_both
from test_torch_cli_drivers import _after_init, _compare_results

assert _own_solves  # the fixture applies here too


def _vqd_init(d):
    """The same numpy angles for every level: a (reps + 1, n, 3) HEA array,
    or the lattice mode's HVA dict (shapes from its init's parameters)."""
    rng = np.random.default_rng(7)
    if callable(d.init_params):
        shapes = {k: np.asarray(v).shape for k, v in d.init_params.__defaults__[0].items()}
        return {k: 0.05 * rng.standard_normal(s) for k, s in shapes.items()}
    return rng.uniform(-0.6, 0.6, (d.reps + 1, d.n_qubits, 3))


@pytest.mark.parametrize("mode", [["--molecule", "H2"], LATTICE_2X2], ids=["H2", "hva_2x2"])
def test_vqd_matches_jax(tmp_path, capsys, monkeypatch, mode):
    def seed_jax(d):
        init = _vqd_init(d)
        d.init_params = ({k: jvqd.jnp.asarray(v) for k, v in init.items()}
                         if isinstance(init, dict) else jvqd.jnp.asarray(init))

    _after_init(monkeypatch, jvqd, "VQD", seed_jax)
    _after_init(monkeypatch, tvqd, "VQD", lambda d: setattr(d, "init_params", _vqd_init(d)))
    argv = ["vqd"] + mode + ["--n-levels", "2", "--n-epoch", "5"]
    res = run_both(argv, tmp_path, capsys, monkeypatch)
    _compare_results(res)
    tl = [s for s in res["torch"][0].splitlines() if s.startswith("VQD energies")]
    jl = [s for s in res["jax"][0].splitlines() if s.startswith("VQD energies")]
    assert len(tl) == len(jl) == 1
    assert_printed_close(tl[0], jl[0])


@pytest.mark.parametrize("mode", [LATTICE_2X2 + ["--reps", "2"], ["--molecule", "H2", "--reps",
                                                                    "2"]],
                         ids=["hva_2x2", "hea_H2"])
def test_multistart_matches_jax(tmp_path, capsys, monkeypatch, mode):
    argv = ["multistart"] + mode + ["--n-starts", "3", "--n-epoch", "6", "--seed", "1"]
    res = run_both(argv, tmp_path, capsys, monkeypatch)
    tl, jl = res["torch"][0].splitlines(), res["jax"][0].splitlines()
    assert len(tl) == len(jl) == 2
    for got, ref in zip(tl, jl):
        assert_printed_close(got, ref)
