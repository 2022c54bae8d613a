"""The resident wrappers' counter ``.prefetched_runs``.

``rotation_resident`` and ``adjoint_resident`` (the 18-qubit sweeps, one
cooperative launch a span of tile runs) copy in and stage each run's
inputs while the run before it computes, behind a split-phase grid
barrier: every run of a launch but the first.  Each launch adds those runs
to the wrapper's plain attribute and to the recorder's counter
(``utils/profiling.py``).  The kernels run only on the card, so here the
counting helper the wrappers call is held to the layouts of the committed
1719-operator 3x3 checkpoint's train segment (built on the host); the
``gpu`` test ``test_resident_checkpoint_3x3`` reads the wrappers themselves.
"""

import os

import pytest

from qsfh_torch.engine import kernels as K
from qsfh_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def layouts_3x3():
    """(forward layout, adjoint layout) of the checkpoint's train segment
    (14,123 terms) at the resident tile shape."""
    from qsfh_torch.algos.adapt import ADAPT
    from qsfh_torch.engine.compiled import CompiledCircuit, _tile_route
    from qsfh_torch.ops.pool import hubbard_interaction_pool_extended

    a = ADAPT(pool=hubbard_interaction_pool_extended(3, 3), n_epoch=0, threshold1=1e-3,
              threshold2=1e-3, x_dimension=3, y_dimension=3, n_electrons=9, n_spin_up=5,
              n_spin_down=4, tunneling=1, coulomb=6, degenerate_subspace=4, load_model=True,
              plot=False, log_metrics=False, device="cpu",
              results_root=os.path.join(ROOT, "benchmarks", "demo_3x3"))
    seg = CompiledCircuit(a._ansatz_ops(a.selected_indices) + a._net_ops, 18).segments[0]
    fwd, resident = _tile_route(seg, 1, 18)
    adj, _ = _tile_route(seg, -1, 18)
    assert resident and len(seg) == 14123
    return fwd, adj


@pytest.fixture
def recorder():
    profiling.enable()
    yield
    profiling.disable()
    profiling.collect()


@pytest.mark.parametrize("direction", ["forward", "adjoint"])
def test_prefetched_runs_follow_the_layout(layouts_3x3, recorder, direction):
    """The checkpoint's sweep is one span of 609 runs each way, so a launch
    prefetches 608; two sweeps add twice that in the wrapper's attribute
    and the recorder's counter, and nothing in the other wrappers'."""
    fwd, adj = layouts_3x3
    layout, fn, other = (fwd, K.rotation_resident, K.adjoint_resident) if (
        direction == "forward") else (adj, K.adjoint_resident, K.rotation_resident)
    assert layout.n_single == 0 and len(layout.spans) == 1 and layout.n_runs == 609
    K.reset_launch_counts()
    for _ in range(2):
        for tiles, _, _ in layout.spans:
            K._count_prefetched(fn, tiles)
    assert fn.prefetched_runs == 2 * 608 == 2 * sum(len(t) - 1 for t, _, _ in layout.spans)
    assert profiling.collect()["counters"] == {f"{fn.__name__}.prefetched_runs": 2 * 608}
    assert other.prefetched_runs == 0
    assert K.rotation_tile_runs.passes == K.adjoint_tile_runs.passes == 0


def test_one_run_prefetches_nothing(layouts_3x3, recorder):
    """A span of one run has no run to stage ahead: a launch adds 0."""
    from qsfh_torch.engine import streaming

    fwd, _ = layouts_3x3
    tiles = fwd.spans[0][0]
    one = streaming.TileRuns([0b11], [0], [(0, 1, int(tiles.run_mask[0]))], 18, tiles.k, tiles.c)
    assert len(one) == 1
    K.reset_launch_counts()
    K._count_prefetched(K.rotation_resident, one)
    K._count_prefetched(K.adjoint_resident, tiles)
    assert (K.rotation_resident.prefetched_runs, K.adjoint_resident.prefetched_runs) == (0, 608)
    assert profiling.collect()["counters"] == {"rotation_resident.prefetched_runs": 0,
                                               "adjoint_resident.prefetched_runs": 608}


def test_reset_and_wrapper_lists():
    """The resident wrappers count prefetched runs; a reset zeroes them."""
    assert set(K.PREFETCH_WRAPPERS) == {K.rotation_resident, K.adjoint_resident}
    assert set(K.PREFETCH_WRAPPERS) < set(K.FUSED_WRAPPERS)
    assert not set(K.PREFETCH_WRAPPERS) & set(K.PASS_WRAPPERS)
    for fn in K.PREFETCH_WRAPPERS:
        fn.prefetched_runs = 9
    K.reset_launch_counts()
    assert all(fn.prefetched_runs == 0 for fn in K.PREFETCH_WRAPPERS)


def test_counters_off_keep_nothing(layouts_3x3):
    """With the recorder off the plain attributes still count and the
    recorder keeps no counter."""
    _, adj = layouts_3x3
    profiling.disable()
    profiling.collect()
    K.reset_launch_counts()
    K._count_prefetched(K.adjoint_resident, adj.spans[0][0])
    assert K.adjoint_resident.prefetched_runs == adj.n_runs - 1
    assert profiling.collect()["counters"] == {}
