"""Seeded inputs shared by the port's kernel tests (numpy only, so the
GPU tests can run where JAX is not installed)."""

import numpy as np


def topk_logits(t, v, seed=0):
    rs = np.random.default_rng(seed)
    x = (rs.standard_normal((t, v)) * 3).astype(np.float32)
    x[:, v // 2:v // 2 + 4] = x[:, :1]  # ties, across blocks
    return x


def paged_case(b, hq, hkv, d, page, npg, seed=3, hole=False):
    """Random pool and tables: each row owns a shuffled subset of pages,
    -1 past its pos (and, with ``hole``, one -1 inside row 0's context)."""
    rs = np.random.default_rng(seed)
    pool = b * npg + 3
    kp = rs.standard_normal((pool, page, hkv, d)).astype(np.float32)
    vp = rs.standard_normal((pool, page, hkv, d)).astype(np.float32)
    q = rs.standard_normal((b, hq, d)).astype(np.float32)
    perm = rs.permutation(pool)
    pos = rs.integers(0, npg * page, size=b).astype(np.int32)
    if hole:
        pos[0] = npg * page - 1
    pt = np.full((b, npg), -1, np.int32)
    used = 0
    for i in range(b):
        n = int(pos[i]) // page + 1
        pt[i, :n] = perm[used:used + n]
        used += n
    if hole:
        pt[0, 1] = -1
    return q, kp, vp, pt, pos
