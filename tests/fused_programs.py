"""Mixed rot programs for the fused-group tests (``test_torch_fused_groups.py``
on the CPU, ``test_torch_gpu.py`` on the card): every shape of group that
``streaming.fused_groups`` meets, and terms that fuse with nothing.  No JAX
import."""

import numpy as np

from qsfh_torch.engine.compiled import Segment


def mixed_terms(rng, n, wide=False):
    """Blocks of (x, z, scale, pidx) terms in a random order: 8-string
    odd-parity groups (a double excitation's Y patterns over a shared Z
    string), 2-string even groups (XX and YY) and odd ones (a Givens pair,
    static), a same-x pair of groups on two parameters, 6 Z strings of rank
    6 on one parameter, 10 same-key strings (past the cap), single strings;
    with ``wide`` also a string of 5 flips, which fits no tile."""
    blocks, k = [], 0

    def bits(m):
        return [int(b) for b in sorted(rng.choice(n, size=m, replace=False))]

    def zstring(x):
        return int(rng.integers(0, 1 << n)) & ~x

    for _ in range(3):
        qs = bits(4)
        x, zs = sum(1 << q for q in qs), zstring(sum(1 << q for q in qs))
        ys = [sum(1 << q for i, q in enumerate(qs) if m >> i & 1) for m in range(16)
              if bin(m).count("1") & 1]
        blocks.append([(x, zs | y, rng.uniform(-1, 1) / 8, k) for y in ys])
        k += 1
    for _ in range(2):
        i, j = bits(2)
        x = (1 << i) | (1 << j)
        zs = zstring(x)
        blocks.append([(x, zs, rng.uniform(-1, 1), k), (x, zs | x, rng.uniform(-1, 1), k)])
        k += 1
        blocks.append([(x, zs | 1 << i, 0.5, -1), (x, zs | 1 << j, -0.5, -1)])
    qs = bits(4)
    x = sum(1 << q for q in qs)
    pair = []
    for _ in range(2):
        zs = zstring(x)
        pair += [(x, zs | 1 << q, rng.uniform(-1, 1), k) for q in qs[:3]]
        k += 1
    blocks.append(pair)
    blocks.append([(0, 1 << q, rng.uniform(-1, 1), k) for q in bits(6)])
    k += 1
    i, j = bits(2)
    x = (1 << i) | (1 << j)
    blocks.append([(x, zstring(x) | (x if rng.integers(2) else 0), rng.uniform(-1, 1), k)
                   for _ in range(10)])
    k += 1
    for _ in range(6):
        x = sum(1 << q for q in bits(int(rng.choice([1, 2, 4]))))
        blocks.append([(x, int(rng.integers(0, 1 << n)), rng.uniform(-1, 1), k)])
        k += 1
    if wide:  # a string of 5 flips fits no tile: the per-term kernels, between two spans
        blocks.append([(sum(1 << q for q in bits(5)), int(rng.integers(0, 1 << n)), 0.3, k)])
        k += 1
    order = rng.permutation(len(blocks))
    terms = [t for b in order for t in blocks[b]]
    return terms, k


def mixed_segment(rng, n, wide=False):
    terms, n_params = mixed_terms(rng, n, wide)
    xs, zs = (np.asarray([t[i] for t in terms], np.int64) for i in (0, 1))
    ph = np.array([(-1j) ** (bin(int(x) & int(z)).count("1") % 4) for x, z in zip(xs, zs)])
    data = dict(xb=xs.astype(np.uint32), zb=zs.astype(np.uint32),
                scale=np.asarray([t[2] for t in terms]), pidx=np.asarray([t[3] for t in terms],
                                                                        np.int32),
                phre=ph.real.copy(), phim=ph.imag.copy())
    return Segment("rot", data), n_params
