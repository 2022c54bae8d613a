"""``ADAPT.get_ground_state_properties`` of the port against the JAX
driver's (complex128, CPU): the printed energy, particle number and the Sz
and S^2 of each cached ED state (one state, and a 2-state manifold) are
the same text.
"""

import pytest

from qsfh_tpu.algos.adapt import ADAPT as JaxADAPT
from qsfh_torch.algos.adapt import ADAPT

CONFIG = dict(n_epoch=0, threshold1=1e-3, threshold2=1e-3, x_dimension=2, y_dimension=2,
              n_electrons=3, n_spin_up=2, n_spin_down=1, tunneling=1, coulomb=4, plot=False,
              log_metrics=False)


@pytest.mark.parametrize("degenerate", [0, 2])
def test_printed_properties_match_jax(tmp_path, capsys, degenerate):
    JaxADAPT(**CONFIG, degenerate_subspace=degenerate,
             results_root=str(tmp_path)).get_ground_state_properties()
    ref = capsys.readouterr().out
    ADAPT(**CONFIG, degenerate_subspace=degenerate, results_root=str(tmp_path),
          device="cpu").get_ground_state_properties()
    got = capsys.readouterr().out
    assert "Sz" in got and "S^2" in got
    assert got.count("Sz") == max(degenerate, 1)
    assert got == ref
