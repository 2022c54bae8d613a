"""The tile-run wrappers' counters: ``.fused_terms`` and ``.passes``.

``rotation_tile_runs`` and ``adjoint_tile_runs`` (the 24-qubit sweeps) add,
at each launch, the terms their layout runs in closed form and the runs it
makes over the state, in their plain attributes and in the recorder's
counters (``utils/profiling.py``).  The kernels run only on the card, so
here the counting helpers the wrappers call are held to the layouts of a
2x6-shaped train segment (24 qubits, built on the host); the ``gpu`` test
``test_tile_run_counters_checkpoint_2x6`` reads the wrappers themselves.
"""

import numpy as np
import pytest

from qsfh_torch.engine import kernels as K
from qsfh_torch.utils import profiling


@pytest.fixture(scope="module")
def layouts_2x6(tmp_path_factory):
    """(forward layout, adjoint layout, operators) of a 2x6 train segment of
    60 seeded simplified-pool operators, at the tile-run shape."""
    from qsfh_torch.algos.adapt import ADAPT
    from qsfh_torch.engine.compiled import CompiledCircuit, _tile_route

    a = ADAPT(n_epoch=0, threshold1=1e-2, threshold2=1e-2, x_dimension=2, y_dimension=6,
              n_electrons=12, n_spin_up=6, n_spin_down=6, tunneling=1, coulomb=2,
              ground_truth=False, plot=False, log_metrics=False, device="cpu",
              results_root=str(tmp_path_factory.mktemp("r")))
    idx = [int(i) for i in np.random.default_rng(23).choice(len(a.fermion_pool), 60,
                                                             replace=False)]
    seg = CompiledCircuit(a._ansatz_ops(idx) + a._net_ops, 24).segments[0]
    fwd, resident = _tile_route(seg, 1, 24)
    adj, _ = _tile_route(seg, -1, 24)
    assert not resident
    return fwd, adj, idx


@pytest.fixture
def recorder():
    profiling.enable()
    yield
    profiling.disable()
    profiling.collect()


@pytest.mark.parametrize("direction", ["forward", "adjoint"])
def test_counts_follow_the_layout(layouts_2x6, recorder, direction):
    """Two calls over every tile span of the layout add twice its fused
    terms and its runs, in the wrapper's attributes and the recorder's
    counters; the resident wrappers stay at 0."""
    fwd, adj, idx = layouts_2x6
    layout, fn = (fwd, K.rotation_tile_runs) if direction == "forward" else (
        adj, K.adjoint_tile_runs)
    K.reset_launch_counts()
    for _ in range(2):
        for tiles, _, _ in layout.spans:
            if tiles is not None:
                K._count_fused(fn, tiles)
                K._count_passes(fn, tiles)
    assert fn.fused_terms == 2 * layout.fused_terms
    assert fn.passes == 2 * layout.n_runs == 2 * layout.passes
    counters = profiling.collect()["counters"]
    assert counters == {f"{fn.__name__}.fused_terms": fn.fused_terms,
                        f"{fn.__name__}.passes": fn.passes}
    assert K.rotation_resident.fused_terms == K.adjoint_resident.fused_terms == 0
    # every double excitation of the ansatz is one fused group of 8 strings
    assert layout.fused_terms >= 8 * len(idx)


def test_reset_and_wrapper_lists():
    """The tile-run wrappers count fused terms and passes; a reset zeroes both."""
    assert set(K.PASS_WRAPPERS) == {K.rotation_tile_runs, K.adjoint_tile_runs}
    assert set(K.PASS_WRAPPERS) < set(K.FUSED_WRAPPERS)
    for fn in K.PASS_WRAPPERS:
        fn.fused_terms, fn.passes = 5, 7
    K.reset_launch_counts()
    assert all(fn.fused_terms == 0 for fn in K.FUSED_WRAPPERS)
    assert all(fn.passes == 0 for fn in K.PASS_WRAPPERS)


def test_counters_off_keep_nothing(layouts_2x6):
    """With the recorder off the plain attributes still count and the
    recorder keeps no counter."""
    fwd, _, _ = layouts_2x6
    profiling.disable()
    profiling.collect()
    K.reset_launch_counts()
    tiles = next(t for t, _, _ in fwd.spans if t is not None)
    K._count_fused(K.rotation_tile_runs, tiles)
    K._count_passes(K.rotation_tile_runs, tiles)
    assert (K.rotation_tile_runs.fused_terms, K.rotation_tile_runs.passes) == (
        tiles.fused_terms, len(tiles))
    assert profiling.collect()["counters"] == {}
