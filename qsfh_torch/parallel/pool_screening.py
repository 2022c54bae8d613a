"""Pool screening with the pool's terms split over the ranks.

Counterpart of ``qsfh_tpu/parallel/pool_screening.py`` (the data-parallel
axis): every rank holds the whole ansatz state psi and cotangent w, screens
its slice of the pool's flat terms (``screen_grouped`` over the slice's own
inner-product tiles, folded per generator), and one rank-order sum combines
the slices.
"""

from __future__ import annotations

import numpy as np

from ..engine.expectation import PackedPool
from . import comm
from .mesh import Mesh


def build_sharded_pool_screen(pool: PackedPool, mesh: Mesh, impl=None):
    """screen(psi, w) -> grads_k = 2 Im <w | G_k psi> for every generator,
    this rank taking one of ``mesh.size`` contiguous slices of the pool's
    flat terms; the same values as ``PackedPool.screen_scan`` up to the
    order of the sum, the same bits on every rank."""
    xs, zs, cre, cim, ks = pool.scan_arrays()
    part = np.array_split(np.arange(len(xs)), mesh.size)[mesh.rank]
    local = PackedPool.from_scan_arrays(xs[part], zs[part], cre[part], cim[part], ks[part],
                                        pool.size, pool.n)

    def screen(psi, w):
        return comm.all_sum(local.screen_scan(psi, w, impl))

    return screen
