"""The training path's kernel entry points against the JAX package's.

On the CPU the port's ops take their plain PyTorch versions; these must
compute what the Pallas kernels compute (run in interpret mode, at small
shapes, as ``tests/test_kernels.py`` runs them) and what the jnp oracles
compute. The CUDA kernels are held against the same plain versions in
``test_torch_kernels_gpu.py``.

Tolerances: xent loss and lse rtol 1e-6 (f32 sums in another order),
gradients atol 2e-6 (the bound ``tests/test_kernels.py`` uses); the ledger
as ``tests/_ledger_parity.py`` has it, EMA rtol 1e-6, integers exact,
priorities rtol 1e-5 against the Pallas kernel (its test's bound).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _ledger_parity import DERIVED_RTOL, EMA_RTOL
from _torch_cases import ledger_batches, ledger_edge_batch, xent_case
from repro.core.history import HistoryConfig as JHistoryConfig
from repro.core.history import LossHistory as JLossHistory
from repro.kernels import ledger as JL_mod
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import xent as X_mod
from repro_torch.core import device_ledger as tled
from repro_torch.core.history import HistoryConfig
from repro_torch.kernels import ledger as L_mod
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

XENT_RTOL = 1e-6
GRAD_ATOL = 2e-6


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


# ---------------------------------------------------------------------------
# xent
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t,v", [(5, 97), (13, 130), (9, 257), (16, 256)])
def test_xent_fwd_plain_matches_jax_interpret_kernel(t, v):
    """Shapes off the Pallas tiles, -1 labels and a row of ±1e4 logits."""
    x, labels, _ = xent_case(t, v, seed=t)
    want = X_mod.xent_fwd(jnp.asarray(x), jnp.asarray(labels), bt=8, bv=128,
                          interpret=True)
    loss, lse = ops.xent_fwd(*_t(x, labels))
    np.testing.assert_allclose(loss.numpy(), np.asarray(want[0]),
                               rtol=XENT_RTOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want[1]),
                               rtol=XENT_RTOL)
    neg = labels < 0
    np.testing.assert_array_equal(loss.numpy()[neg], lse.numpy()[neg])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xent_fwd_plain_matches_jax_ref(dtype):
    x, labels, _ = xent_case(24, 300, seed=3)
    jx = jnp.asarray(x).astype(dtype)
    want = jref.xent_ref(jx, jnp.asarray(labels))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    loss, lse = ops.xent_fwd(tx, torch.from_numpy(labels))
    np.testing.assert_allclose(loss.numpy(), np.asarray(want[0]),
                               rtol=XENT_RTOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want[1]),
                               rtol=XENT_RTOL)


def test_xent_labels_at_or_past_the_vocab_pick_nothing():
    """A label at or past V picks nothing, as the kernel does: loss = lse
    and the gradient subtracts no one-hot. The JAX package has no single
    answer there (its oracle gives NaN, its Pallas kernel 1e30), so the
    rows with labels in [0, V) are held against the JAX oracle and the
    others against their own lse and softmax."""
    x, labels, g = xent_case(6, 40, seed=2)
    labels[2], labels[4] = 40, 42
    loss, lse = ops.xent_fwd(*_t(x, labels))
    assert loss[2] == lse[2] and loss[4] == lse[4]
    inside = (labels >= 0) & (labels < 40)
    want = jref.xent_ref(jnp.asarray(x[inside]), jnp.asarray(labels[inside]))
    np.testing.assert_allclose(loss.numpy()[inside], np.asarray(want[0]),
                               rtol=XENT_RTOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(
        jref.xent_ref(jnp.asarray(x), jnp.zeros(6, jnp.int32))[1]),
        rtol=XENT_RTOL)
    grad = ops.xent_bwd(*_t(x, labels, lse, g))
    soft = torch.softmax(torch.from_numpy(x), dim=-1) * torch.from_numpy(
        g)[:, None]
    np.testing.assert_allclose(grad.numpy()[[2, 4]], soft.numpy()[[2, 4]],
                               atol=GRAD_ATOL)


def test_xent_extreme_logits_stable():
    x = np.asarray([[1e4, -1e4, 0.0, 5e3]] * 8, np.float32)
    loss, _ = ops.xent_fwd(*_t(x, np.zeros(8, np.int32)))
    assert torch.isfinite(loss).all()
    np.testing.assert_allclose(loss.numpy(), 0.0, atol=1e-3)


@pytest.mark.parametrize("t,v", [(5, 97), (16, 256), (13, 513)])
def test_xent_bwd_plain_matches_jax_interpret_kernel(t, v):
    x, labels, g = xent_case(t, v, seed=v)
    _, lse = jref.xent_ref(jnp.asarray(x), jnp.asarray(labels))
    want = X_mod.xent_bwd(jnp.asarray(x), jnp.asarray(labels), lse,
                          jnp.asarray(g), bt=8, bv=128, interpret=True)
    got = ops.xent_bwd(*_t(x, labels, lse, g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=GRAD_ATOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref.xent_grad_ref(
            jnp.asarray(x), jnp.asarray(labels), lse, jnp.asarray(g))),
        atol=GRAD_ATOL)


def test_xent_loss_autograd_matches_autograd_of_plain_forward():
    """The autograd.Function's backward (the backward kernel's plain
    version, from the saved lse) against torch autograd through the plain
    forward, and against the JAX custom VJP."""
    import jax

    x, labels, _ = xent_case(12, 65, seed=1)
    a = torch.from_numpy(x).requires_grad_(True)
    b = torch.from_numpy(x).requires_grad_(True)
    torch.tanh(ops.xent_loss(a, torch.from_numpy(labels))).sum().backward()
    torch.tanh(ref.xent_ref(b, torch.from_numpy(labels))[0]).sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=GRAD_ATOL)
    jg = jax.grad(lambda l: jnp.sum(jnp.tanh(
        jops.xent_loss(l, jnp.asarray(labels), "interpret"))))(jnp.asarray(x))
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(jg), atol=GRAD_ATOL)


def test_xent_bwd_keeps_the_logits_dtype():
    x, labels, g = xent_case(6, 40)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    _, lse = ops.xent_fwd(xb, torch.from_numpy(labels))
    assert ops.xent_bwd(xb, torch.from_numpy(labels), lse,
                        torch.from_numpy(g)).dtype == torch.bfloat16


def test_cuda_impl_refuses_cpu_tensors():
    x, labels, g = _t(*xent_case(3, 16))
    with pytest.raises(ValueError, match="CUDA"):
        ops.xent_fwd(x, labels, impl="cuda")
    st = tled.init_state(HistoryConfig(capacity=256), "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        ops.ledger_record_priority(
            st.ema, st.count, st.last_seen, st.owner, labels, g, 0,
            decay=0.9, unseen_priority=1e6, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        from repro_torch.kernels.xent import xent_fwd_cuda

        xent_fwd_cuda(x, labels)


# ---------------------------------------------------------------------------
# ledger record + priority
# ---------------------------------------------------------------------------


def _table(cap):
    return (np.zeros(cap, np.float32), np.zeros(cap, np.int32),
            np.full(cap, -1, np.int32), np.full(cap, -1, np.int32))


def _assert_tx_close(got, want, pri_rtol=EMA_RTOL):
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]),
                               rtol=EMA_RTOL)
    for g, w in zip(got[1:4], want[1:4]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    np.testing.assert_allclose(np.asarray(got[4]), np.asarray(want[4]),
                               rtol=pri_rtol)


@pytest.mark.parametrize("variant", ["fori", "block"])
@pytest.mark.parametrize("half_life", [float("inf"), 4.0])
def test_ledger_plain_matches_jax_interpret_kernel_chained(variant, half_life):
    """Chained transactions with duplicates, masked items and an eviction
    inside every batch, against each Pallas variant in interpret mode."""
    cap = 1024
    st_j = tuple(jnp.asarray(a) for a in _table(cap))
    st_t = _t(*_table(cap))
    kw = dict(decay=0.8, unseen_priority=1e6, staleness_half_life=half_life)
    for step, (ids, losses, valid) in enumerate(
            ledger_batches(cap, 24, 4, seed=7, id_range=300)):
        out_j = jops.ledger_record_priority(
            *st_j, jnp.asarray(ids), jnp.asarray(losses), jnp.int32(2 * step),
            valid=jnp.asarray(valid), impl="interpret", variant=variant, **kw)
        out_t = ops.ledger_record_priority(
            *st_t, *_t(ids, losses), 2 * step, valid=torch.from_numpy(valid),
            variant=variant, **kw)
        _assert_tx_close(out_t, out_j, pri_rtol=DERIVED_RTOL)
        assert out_t[4][-2] == 1e6  # evicted later in its own batch
        st_j, st_t = out_j[:4], out_t[:4]


def test_ledger_plain_matches_jax_ref_on_a_large_batch():
    """A batch past the JAX package's LEDGER_BLOCK_MIN_BATCH, against the
    jnp oracle."""
    cap = 2048
    ids, losses, valid = ledger_batches(cap, 513, 1, seed=2)[0]
    kw = dict(decay=0.9, unseen_priority=1e6, staleness_half_life=40.0)
    want = jref.ledger_record_priority_ref(
        *(jnp.asarray(a) for a in _table(cap)), jnp.asarray(ids),
        jnp.asarray(losses), jnp.int32(5), kw["decay"], kw["unseen_priority"],
        kw["staleness_half_life"], jnp.asarray(valid))
    got = ops.ledger_record_priority(*_t(*_table(cap)), *_t(ids, losses), 5,
                                     valid=torch.from_numpy(valid), **kw)
    _assert_tx_close(got, want)


def test_ledger_intra_batch_duplicates_last_write_wins():
    ids = np.asarray([5, 9, 5, 5], np.int32)
    losses = np.asarray([1.0, 2.0, 3.0, 8.0], np.float32)
    out = ops.ledger_record_priority(*_t(*_table(128)), *_t(ids, losses), 0,
                                     decay=0.5, unseen_priority=1e6)
    np.testing.assert_allclose(out[4].numpy(), [8.0, 2.0, 8.0, 8.0],
                               rtol=1e-6)


def test_ledger_plain_matches_host_loss_history():
    cfg = JHistoryConfig(capacity=1024, decay=0.8)
    h = JLossHistory(cfg)
    st = _t(*_table(cfg.capacity))
    kw = dict(decay=cfg.decay, unseen_priority=cfg.unseen_priority,
              staleness_half_life=cfg.staleness_half_life)
    for step, (ids, losses, _) in enumerate(
            ledger_batches(cfg.capacity, 13, 4, seed=4, id_range=5000)):
        h.record(ids.astype(np.int64), losses, step)
        out = ops.ledger_record_priority(*st, *_t(ids, losses), step, **kw)
        st = out[:4]
        np.testing.assert_allclose(out[4].numpy(),
                                   h.priority(ids.astype(np.int64), step),
                                   rtol=DERIVED_RTOL)
    sd = h.state_dict()
    np.testing.assert_allclose(st[0].numpy(), sd["ema"], rtol=EMA_RTOL)
    for got, key in zip(st[1:], ("count", "last_seen", "owner")):
        np.testing.assert_array_equal(got.numpy(), sd[key].astype(np.int32))


@pytest.mark.parametrize("use_signals", [False, True])
def test_record_priority_equals_record_then_priority_bitwise(use_signals):
    """The trainer writes through record_priority: the state it leaves is
    bit for bit record's, and the plain ledger transaction (ops) gives the
    same four tables and priorities."""
    cfg = HistoryConfig(capacity=512, decay=0.8, staleness_half_life=6.0)
    st_a = st_b = tled.init_state(cfg, "cpu")
    tables = (st_a.ema, st_a.count, st_a.last_seen, st_a.owner)
    rs = np.random.default_rng(0)
    for step, (ids, losses, valid) in enumerate(
            ledger_batches(cfg.capacity, 40, 4, seed=9, id_range=200)):
        ids, losses, valid = _t(ids, losses, valid)
        sig = (torch.from_numpy(rs.standard_normal((40, 2)).astype(np.float32))
               if use_signals else None)
        st_a, pri_a = tled.record_priority(cfg, st_a, ids, losses, step,
                                           valid=valid, signals=sig)
        st_b = tled.record(cfg, st_b, ids, losses, step, valid=valid,
                           signals=sig)
        pri_b = tled.priority(cfg, st_b, ids, step)
        for name in ("ema", "count", "last_seen", "owner", "sig"):
            assert torch.equal(getattr(st_a, name), getattr(st_b, name)), name
        assert torch.equal(pri_a, pri_b)
        out = ops.ledger_record_priority(
            *tables, ids, losses, step, decay=cfg.decay,
            unseen_priority=cfg.unseen_priority,
            staleness_half_life=cfg.staleness_half_life, valid=valid)
        tables = out[:4]
        for got, want in zip(out, (st_b.ema, st_b.count, st_b.last_seen,
                                   st_b.owner, pri_b)):
            assert torch.equal(got, want)


def test_sig_scatter_matches_record_sig():
    cfg = HistoryConfig(capacity=256, decay=0.7)
    st = tled.init_state(cfg, "cpu")
    rs = np.random.default_rng(1)
    for step, (ids, losses, valid) in enumerate(
            ledger_batches(cfg.capacity, 30, 3, seed=3, id_range=100)):
        ids, losses, valid = _t(ids, losses, valid)
        sig = torch.from_numpy(rs.standard_normal((30, 2)).astype(np.float32))
        got = tled._sig_scatter(cfg, st, ids, sig, valid)
        st = tled.record(cfg, st, ids, losses, step, valid=valid, signals=sig)
        assert torch.equal(got, st.sig)


def test_ledger_variant_dispatch_by_batch():
    """None dispatches by batch size by the JAX package's rule (for tables
    of at least two 128-slot rows), at the port's threshold (measured on
    the H100) and at the JAX package's; an unknown variant raises."""
    assert ops.LEDGER_BLOCK_MIN_BATCH >= jops.LEDGER_BLOCK_MIN_BATCH
    for thr in (ops.LEDGER_BLOCK_MIN_BATCH, jops.LEDGER_BLOCK_MIN_BATCH):
        for b in (1, 8, thr - 1, thr, 4 * thr):
            for forced in (None, "fori", "block"):
                assert L_mod.resolve_variant(forced, b, thr) == \
                    JL_mod.resolve_variant(forced, b, thr, rows=8)
    with pytest.raises(ValueError):
        L_mod.resolve_variant("tiles", 8, thr)


# ---------------------------------------------------------------------------
# the CUDA kernel's tile plan, and the edge batches its card tests use
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("log_cap", range(7, 21))
def test_ledger_tile_plan_covers_the_table_within_shared_memory(log_cap):
    """Tiles of a power-of-two size cover every slot once; a block's
    shared memory (header, the tile, its item list and winners) stays
    within what it declares and what the card allows; the ids walked over
    all blocks stay within WALK_ITEMS unless the shared-memory ceiling
    needs more tiles."""
    cap = 1 << log_cap
    for b in (0, 1, 31, 32, 512, 1024, 4096, 8192, 32768, 1 << 16):
        tiles, slots, room, smem = L_mod.tile_plan(cap, b)
        assert tiles * slots == cap
        assert tiles & (tiles - 1) == 0 and slots & (slots - 1) == 0
        owner = np.arange(cap) // slots  # the tile that owns each slot
        assert owner[0] == 0 and owner[-1] == tiles - 1
        assert (np.bincount(owner, minlength=tiles) == slots).all()
        assert smem == (4 * (L_mod.HEADER_INTS + 5 * slots)
                        + 8 * room) <= L_mod.MAX_SMEM
        assert slots <= L_mod.MAX_TILE_SLOTS
        assert L_mod.MIN_ROOM <= room <= L_mod.MAX_ROOM
        assert room >= min(L_mod.MAX_ROOM, b * slots // cap)
        assert (tiles * b <= L_mod.WALK_ITEMS
                or tiles == cap // L_mod.MAX_TILE_SLOTS)
    assert L_mod.tile_plan(65536, 32)[0] == 65536 // L_mod.TILE_SLOTS


@pytest.mark.parametrize("variant", ["fori", "block"])
@pytest.mark.parametrize("kind,cap,batch", [
    ("random", 1024, 32), ("random", 1024, 512),
    ("one_tile", 4096, 600), ("one_slot", 1024, 300),
    ("random", 512, 2000),  # more items than slots
    ("random", 1024, 0), ("all_masked", 1024, 64)])
def test_ledger_edge_batches_match_jax_interpret_kernel(variant, kind, cap,
                                                        batch):
    """The batches the card's edge-case test feeds the kernel (every item
    in one tile, or on one slot; more items than slots; none; every item
    masked), three transactions chained, through the port's plain version
    against each Pallas variant in interpret mode (B = 0 against the jnp
    oracle: the Pallas kernel takes no empty batch): integers exact, ema
    rtol 1e-6, priorities 1e-5."""
    kw = dict(decay=0.8, unseen_priority=1e6, staleness_half_life=3.0)
    st_j = tuple(jnp.asarray(a) for a in _table(cap))
    st_t = _t(*_table(cap))
    for step in range(3):
        ids, losses, valid = ledger_edge_batch(kind, cap, batch, seed=step)
        if batch:
            out_j = jops.ledger_record_priority(
                *st_j, jnp.asarray(ids), jnp.asarray(losses),
                jnp.int32(2 * step), valid=jnp.asarray(valid),
                impl="interpret", variant=variant, **kw)
        else:
            out_j = jref.ledger_record_priority_ref(
                *st_j, jnp.asarray(ids), jnp.asarray(losses),
                jnp.int32(2 * step), kw["decay"], kw["unseen_priority"],
                kw["staleness_half_life"], jnp.asarray(valid))
        out_t = ops.ledger_record_priority(
            *st_t, *_t(ids, losses), 2 * step, valid=torch.from_numpy(valid),
            variant=variant, **kw)
        _assert_tx_close(out_t, out_j, pri_rtol=DERIVED_RTOL)
        if kind == "all_masked":
            for g, w in zip(out_t[:4], st_t):
                assert torch.equal(g, w)
        st_j, st_t = out_j[:4], out_t[:4]
