"""Seeded inputs shared by the port's kernel tests (numpy only, so the
GPU tests can run where JAX is not installed)."""

import numpy as np


def topk_logits(t, v, seed=0):
    rs = np.random.default_rng(seed)
    x = (rs.standard_normal((t, v)) * 3).astype(np.float32)
    x[:, v // 2:v // 2 + 4] = x[:, :1]  # ties, across blocks
    return x


def topk_edge_rows(x):
    """``x`` [t, v] with, where it has the rows, row 1 at or below 0 with
    -0.0 and +0.0 among its largest values (equal, so the lower index goes
    first) and row 2 holding a run of -inf (ties among the smallest)."""
    x = x.copy()
    v = x.shape[1]
    if len(x) > 1:
        x[1] = -np.abs(x[1])
        x[1, [5 % v, 17 % v, (v // 2 + 1) % v, v - 1]] = [-0.0, 0.0, -0.0, 0.0]
    if len(x) > 2:
        x[2, v // 3:v // 3 + min(100, v // 3)] = -np.inf
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


def xent_case(t, v, seed=0, scale=4.0):
    """Logits [t, v] f32, labels [t] i32 with every third label -1 (picks
    nothing) and, where t > 1, a row of extreme logits (±1e4), plus a
    cotangent g [t] f32."""
    rs = np.random.default_rng(seed)
    x = (rs.standard_normal((t, v)) * scale).astype(np.float32)
    labels = rs.integers(0, v, size=t).astype(np.int32)
    labels[1::3] = -1
    if t > 1:
        x[0] = np.where(np.arange(v) % 2 == 0, 1e4, -1e4)
        x[0, v // 3] = 5e3
        labels[0] = v // 3
    g = rs.standard_normal(t).astype(np.float32)
    return x, labels, g


def colliding_ids(capacity, n, start=1000):
    """``n`` distinct ids that all hash to one slot of a ``capacity`` table
    (an eviction when they share a batch)."""
    from repro_torch.core.history import slot_for

    cand = np.arange(start, start + 64 * capacity, dtype=np.int64)
    slots = slot_for(cand, capacity)
    target = slots[0]
    return cand[slots == target][:n].astype(np.int32)


def ledger_batches(capacity, batch, steps, seed=0, id_range=None):
    """``steps`` batches of (ids i32, losses f32, valid bool): ids drawn
    with repeats (duplicates within a batch and across batches), a quarter
    of the items masked, and in each batch two distinct ids on one slot,
    the second (later in batch order) evicting the first."""
    rs = np.random.default_rng(seed)
    pair = colliding_ids(capacity, 2 * steps)
    out = []
    for s in range(steps):
        ids = rs.integers(0, id_range or 2 * batch, size=batch).astype(np.int32)
        ids[-2:] = pair[2 * s:2 * s + 2]
        losses = rs.normal(2.0, 1.0, size=batch).astype(np.float32)
        valid = rs.random(batch) > 0.25
        valid[-2:] = True
        out.append((ids, losses, valid))
    return out


class JaxDraws:
    """The random draws a JAX selector takes from ``key`` (permutation,
    Gumbel noise, one normal), served as the port's selection Noise, so
    both packages select with the same numbers. Imports JAX on use only."""

    def __init__(self, key):
        self.key = key

    def permutation(self, n):
        import jax
        import torch

        return torch.from_numpy(np.array(jax.random.permutation(self.key, n)))

    def gumbel(self, n):
        import jax
        import jax.numpy as jnp
        import torch

        return torch.from_numpy(np.array(
            jax.random.gumbel(self.key, (n,), dtype=jnp.float32)))

    def normal(self):
        import jax
        import jax.numpy as jnp
        import torch

        return torch.from_numpy(np.array(
            jax.random.normal(self.key, (), dtype=jnp.float32)))


def decode_case(b, hq, hkv, d, t, seed=0, lens=None):
    """q [b,hq,d], K/V [b,t,hkv,d] f32 and a valid mask [b,t]: row i sees
    its first ``lens[i]`` positions (random lengths in [1, t] by default;
    a length of 0 masks the whole row)."""
    rs = np.random.default_rng(seed)
    q = rs.standard_normal((b, hq, d)).astype(np.float32)
    k = rs.standard_normal((b, t, hkv, d)).astype(np.float32)
    v = rs.standard_normal((b, t, hkv, d)).astype(np.float32)
    if lens is None:
        lens = rs.integers(1, t + 1, size=b)
    valid = np.arange(t)[None, :] < np.asarray(lens)[:, None]
    return q, k, v, valid


def window_mask(pos, t, window):
    """The rolling-slot mask of ``gqa_decode`` for per-row depths ``pos``:
    slot j holds position pos - ((pos - j) mod t), kept if it is >= 0 and
    inside the window."""
    pos = np.asarray(pos)[:, None]
    slot_pos = pos - np.mod(pos - np.arange(t)[None, :], t)
    return (slot_pos >= 0) & (slot_pos > pos - window)


def ssd_case(bsz, s, h, p, g, n, seed=0):
    """x [bsz,s,h,p], dt [bsz,s,h] (softplus of a normal), a [h] (-exp of
    a normal), B/C [bsz,s,g,n] (normal × 0.5), all f32: the draws of
    ``test_ssd_kernel_matches_sequential_ref``, from numpy."""
    rs = np.random.default_rng(seed)
    x = rs.standard_normal((bsz, s, h, p)).astype(np.float32)
    dt = np.logaddexp(rs.standard_normal((bsz, s, h)), 0).astype(np.float32)
    a = (-np.exp(rs.standard_normal(h))).astype(np.float32)
    b = (rs.standard_normal((bsz, s, g, n)) * 0.5).astype(np.float32)
    c = (rs.standard_normal((bsz, s, g, n)) * 0.5).astype(np.float32)
    return x, dt, a, b, c


def ledger_edge_batch(kind, capacity, batch, seed=0, tile_slots=1024):
    """One (ids i32, losses f32, valid bool) batch for the ledger's edge
    cases: "one_tile" (every item's slot in [0, tile_slots), from ids with
    repeats), "one_slot" (every item on one slot, from a few distinct
    ids: the last valid one wins, the others read as unseen),
    "all_masked" (nothing writes; every item is still scored), and
    "random" (ids in [0, 2 batch), a quarter masked; a batch larger than
    the capacity where ``batch`` > ``capacity``)."""
    from repro_torch.core.history import slot_for

    rs = np.random.default_rng(seed)
    losses = rs.normal(2.0, 1.0, size=batch).astype(np.float32)
    valid = rs.random(batch) > 0.25
    if kind == "one_tile":
        cand = np.arange(5000, 5000 + 64 * capacity, dtype=np.int64)
        pool = cand[slot_for(cand, capacity) < tile_slots]
        ids = rs.choice(pool[:4 * batch + 1], size=batch)
    elif kind == "one_slot":
        ids = rs.choice(colliding_ids(capacity, 12, start=7000), size=batch)
    else:
        ids = rs.integers(0, 2 * batch + 1, size=batch)
    if kind == "all_masked":
        valid[:] = False
    return ids.astype(np.int32), losses, valid
