"""The CUDA kernels against their plain PyTorch versions, on a card.

Skips without a CUDA device. Imports no JAX, so on a machine with a card
and without JAX it runs with the repo's conftest switched off:

    PYTHONPATH=src python -m pytest --noconftest -m gpu \
        tests/test_torch_kernels_gpu.py
"""

import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from _torch_cases import (decode_case, ledger_batches, ledger_edge_batch,
                          paged_case, ssd_case, topk_edge_rows, topk_logits,
                          window_mask, xent_case)
from repro_torch.core.history import HistoryConfig
from repro_torch.kernels import ops, ref
from repro_torch.kernels import topk_lse as TK
from repro_torch.models.ssm import ssd_chunked


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# the serve shape (llama3's vocab, k = 64) and k of 1, 65, a few hundred and
# 4096 (past a block's threads: no bound, the cluster-wide select, survivors
# sorted in shared memory); a vocabulary no multiple of a 16-byte load with
# k = 64 and k = V (sorted in global scratch); a row shorter than a warp's
# loads; the other archs' vocabularies at the serve shape (deepseek-7b and
# deepseek-v2-236b, qwen3-14b, granite-34b, mixtral-8x22b, pixtral-12b,
# musicgen-medium)
TOPK_CASES = [(8, 128256, 64), (8, 128256, 1), (8, 128256, 65),
              (8, 128256, 256), (4, 128256, 4096), (3, 4097, 64),
              (3, 4097, 4097), (5, 97, 7), (8, 102400, 64), (8, 151936, 64),
              (8, 49152, 64), (8, 32768, 64), (8, 131072, 64),
              (8, 2048, 64)]


def _topk_check(x, k):
    """Indices and values exact, lse within 1e-4 (f32 sums in another
    order)."""
    got = ops.topk_lse(x, k, impl="cuda")
    want = ref.topk_lse_ref(x, k)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,v,k", TOPK_CASES)
def test_topk_lse_kernel_matches_plain(cuda, t, v, k, dtype):
    """Ties across blocks, -0.0 tied with +0.0 among a row's largest values,
    and a run of -inf; bf16 logits read in their own dtype."""
    x = torch.from_numpy(topk_edge_rows(topk_logits(t, v))).to(cuda)
    _topk_check(x.to(dtype), k)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_topk_lse_kernel_routes_match_plain(cuda, monkeypatch, dtype):
    """Each route at a small size: survivors sorted in global scratch (the
    shared-memory sort capped at 64) and keys past a block's shared-memory
    cache read again (the cache capped at 1024 keys); an all-equal row
    (every logit ties)."""
    x = torch.from_numpy(topk_edge_rows(topk_logits(4, 40000, seed=5)))
    x[3] = 1.5
    x = x.to(cuda).to(dtype)
    monkeypatch.setattr(TK, "SORT_SMEM_MAX", 64)
    for k in (64, 65, 300):
        _topk_check(x, k)
    monkeypatch.setattr(TK, "KEY_CACHE_MAX", 1024)
    for k in (1, 64, 300):
        _topk_check(x, k)


# (Hq, Hkv, D): llama3-8b's heads, the JAX test's G = 16, granite-34b's
# G = 48 (three head slices), D = 36 (rows of 144 bytes in f32, of 72 in
# bf16, which take the scalar copy), deepseek-7b's G = 1 and qwen3-14b's
# G = 5; musicgen-medium's 24 kv heads of 64 (G = 1, D = 64)
PAGED_HEADS = [(32, 8, 128), (16, 1, 64), (48, 1, 128), (8, 2, 36),
               (32, 32, 128), (40, 8, 128), (24, 24, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page,npg", [(16, 10), (256, 3), (5, 7)])
@pytest.mark.parametrize("heads", PAGED_HEADS)
def test_paged_decode_attn_kernel_matches_plain(cuda, dtype, page, npg,
                                                heads):
    """Pages that a 128-position tile crosses (16 and 5) and pages longer
    than a tile (256), a -1 page inside a row's context, a row whose pages
    are all -1 and a row with pos = -1 (both the mean of V over the
    positions the table addresses, a -1 page read as page 0)."""
    hq, hkv, d = heads
    case = paged_case(5, hq, hkv, d, page, npg, hole=True)
    q, kp, vp, pt, pos = (torch.from_numpy(a).to(cuda) for a in case)
    pt[1] = -1
    pos[2] = -1
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    got = ops.paged_decode_attn(q, kp, vp, pt, pos, impl="cuda")
    assert got.dtype == dtype
    want = ref.paged_decode_attn_ref(q.float(), kp.float(), vp.float(), pt,
                                     pos)
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    mean = vp[0].float().mean(dim=0).repeat_interleave(hq // hkv, dim=0)
    torch.testing.assert_close(got[1].float(), mean, rtol=tol, atol=tol)


@pytest.mark.gpu
def test_paged_decode_attn_kernel_asserts_on_page_past_the_pool(cuda):
    """A table entry past the pool trips the kernel's device assert instead
    of being skipped. The assert ends the CUDA context, so it runs in a
    process of its own."""
    code = textwrap.dedent("""
        import torch
        from repro_torch.kernels import ops
        q = torch.zeros((1, 4, 16), device="cuda")
        kp = torch.zeros((3, 4, 2, 16), device="cuda")
        pt = torch.tensor([[0, 3]], dtype=torch.int32, device="cuda")
        pos = torch.tensor([7], dtype=torch.int32, device="cuda")
        ops.paged_decode_attn(q, kp, kp, pt, pos, impl="cuda")
        torch.cuda.synchronize()
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert "assert" in (proc.stdout + proc.stderr).lower()


# the training path's shapes (T = 1024 kept tokens, V = llama3's vocab) and
# edge cases: a row length that is no multiple of 16 bytes (scalar loop),
# tiny rows, -1 labels and a row of ±1e4 logits in every case; the kept
# tokens at qwen3-14b's and granite-34b's vocabularies; mixtral-8x22b's,
# deepseek-v2-236b's and pixtral-12b's selection forward (T = 4096) and kept
# tokens (T = 1024); musicgen-medium's kept tokens (recycled)
XENT_CASES = [(1024, 128256, torch.bfloat16), (64, 128256, torch.float32),
              (7, 128257, torch.bfloat16), (5, 97, torch.float32),
              (3, 130, torch.bfloat16), (1024, 151936, torch.bfloat16),
              (1024, 49152, torch.bfloat16), (4096, 32768, torch.bfloat16),
              (1024, 32768, torch.bfloat16), (4096, 102400, torch.bfloat16),
              (1024, 102400, torch.bfloat16), (4096, 131072, torch.bfloat16),
              (1024, 131072, torch.bfloat16), (1024, 2048, torch.bfloat16)]


def _xent_inputs(cuda, t, v, dtype):
    x, labels, g = xent_case(t, v, seed=t + v)
    return (torch.from_numpy(x).to(cuda).to(dtype),
            torch.from_numpy(labels).to(cuda), torch.from_numpy(g).to(cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("t,v,dtype", XENT_CASES)
def test_xent_fwd_kernel_matches_plain(cuda, t, v, dtype):
    """Loss and lse in f32 within 1e-5 + 1e-6 * |value| (a few f32 units in
    the last place of the lse): the kernel sums the row's exponentials in
    another order than torch.logsumexp."""
    logits, labels, _ = _xent_inputs(cuda, t, v, dtype)
    loss, lse = ops.xent_fwd(logits, labels, impl="cuda")
    rl, rlse = ref.xent_ref(logits, labels)
    torch.testing.assert_close(loss, rl, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(lse, rlse, rtol=1e-6, atol=1e-5)
    neg = labels < 0
    assert torch.equal(loss[neg], lse[neg])


# per entry: both versions compute in f32 and round once to the logits'
# dtype, so an entry may differ by one bf16 unit in the last place (exp may
# differ in its last f32 bit and round the other way) or a few f32 units,
# with the dtype's smallest normal as the floor for entries that underflow
XENT_BWD_RTOL = {torch.bfloat16: 2**-7, torch.float32: 1e-6}


def _assert_grad_close(got, want):
    tol = (XENT_BWD_RTOL[want.dtype] * want.float().abs()
           + torch.finfo(want.dtype).tiny)
    bad = (got.float() - want.float()).abs() > tol
    assert not bad.any(), f"{int(bad.sum())} entries out of tolerance"


@pytest.mark.gpu
@pytest.mark.parametrize("t,v,dtype", XENT_CASES)
def test_xent_bwd_kernel_matches_plain(cuda, t, v, dtype):
    """Every entry against the plain version, relative to its own size;
    the ±1e4 row also against its closed form: exp(max - lse) g (g/n up to
    the lse's f32 rounding) on its n largest logits, -g at the label (5e3
    below them), 0 elsewhere."""
    logits, labels, g = _xent_inputs(cuda, t, v, dtype)
    _, lse = ref.xent_ref(logits, labels)
    got = ops.xent_bwd(logits, labels, lse, g, impl="cuda")
    assert got.dtype == dtype
    _assert_grad_close(got, ref.xent_grad_ref(logits, labels, lse, g))
    top = logits[0] == logits[0].max()
    closed = torch.where(top, torch.exp(logits[0].max().float() - lse[0])
                         * g[0], 0.0)
    closed[labels[0].long()] = -g[0]
    _assert_grad_close(got[0], closed.to(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_xent_kernels_pick_nothing_for_labels_past_the_vocab(cuda, dtype):
    """Labels V and V + 2: loss = lse exactly, and the gradient is the
    softmax times g with no one-hot, as the plain versions give."""
    logits, labels, g = _xent_inputs(cuda, 64, 128256, dtype)
    labels[3], labels[5] = 128256, 128258
    loss, lse = ops.xent_fwd(logits, labels, impl="cuda")
    rl, rlse = ref.xent_ref(logits, labels)
    torch.testing.assert_close(loss, rl, rtol=1e-6, atol=1e-5)
    assert loss[3] == lse[3] and loss[5] == lse[5]
    got = ops.xent_bwd(logits, labels, rlse, g, impl="cuda")
    _assert_grad_close(got, ref.xent_grad_ref(logits, labels, rlse, g))


@pytest.mark.gpu
def test_xent_loss_autograd_matches_plain_autograd(cuda):
    logits, labels, _ = _xent_inputs(cuda, 12, 1000, torch.float32)
    a = logits.clone().requires_grad_(True)
    b = logits.clone().requires_grad_(True)
    torch.tanh(ops.xent_loss(a, labels, impl="cuda")).sum().backward()
    torch.tanh(ref.xent_ref(b, labels)[0]).sum().backward()
    torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=2e-6)


def _ledger_table(cuda, cap):
    return (torch.zeros(cap, device=cuda),
            torch.zeros(cap, dtype=torch.int32, device=cuda),
            torch.full((cap,), -1, dtype=torch.int32, device=cuda),
            torch.full((cap,), -1, dtype=torch.int32, device=cuda))


def _ledger_tx_check(cuda, st_k, st_r, ids, losses, valid, step, **kw):
    """One transaction through the kernel and the plain version: integers
    exact, ema and priority within rtol 1e-6 -> both new tables."""
    ids, losses = (torch.from_numpy(a).to(cuda) for a in (ids, losses))
    valid = None if valid is None else torch.from_numpy(valid).to(cuda)
    step_t = torch.full((), step, dtype=torch.int32, device=cuda)
    out_k = ops.ledger_record_priority(*st_k, ids, losses, step_t,
                                       valid=valid, impl="cuda", **kw)
    out_r = ops.ledger_record_priority(*st_r, ids, losses, step, valid=valid,
                                       impl="ref", **kw)
    for got, want in zip(out_k[1:4], out_r[1:4]):
        assert torch.equal(got, want)
    for got, want in (out_k[0], out_r[0]), (out_k[4], out_r[4]):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    return out_k, out_r


@pytest.mark.gpu
@pytest.mark.parametrize("cap,batch", [(65536, 32), (65536, 512),
                                       (1 << 18, 32768)])
@pytest.mark.parametrize("variant", [None, "fori", "block"])
@pytest.mark.parametrize("half_life", [float("inf"), 3.0])
def test_ledger_kernel_matches_plain_chained(cuda, cap, batch, variant,
                                             half_life):
    """Capacity 65536 (HistoryConfig's) and 2^18 (the JAX kernel's
    per-shard ceiling), five chained transactions with duplicates, masked
    items and an eviction inside each batch: integers exact, ema and
    priority within rtol 1e-6."""
    cfg = HistoryConfig()
    st_k = st_r = _ledger_table(cuda, cap)
    kw = dict(decay=cfg.decay, unseen_priority=cfg.unseen_priority,
              staleness_half_life=half_life, variant=variant)
    for step, (ids, losses, valid) in enumerate(
            ledger_batches(cap, batch, 5, seed=batch)):
        out_k, out_r = _ledger_tx_check(cuda, st_k, st_r, ids, losses, valid,
                                        2 * step, **kw)
        assert out_k[4][-2] == cfg.unseen_priority  # evicted in its batch
        st_k, st_r = out_k[:4], out_r[:4]


# (kind, capacity, batch): every item in one tile, every item on one slot
# (past the tile's item list: the patch pass reads the winner array and the
# score pass walks the batch again), more items than slots, an empty
# batch, every item masked, a table smaller than a 16-byte vector
LEDGER_EDGES = [("one_tile", 65536, 4096), ("one_slot", 65536, 4096),
                ("one_slot", 1 << 18, 32768), ("random", 1024, 4096),
                ("random", 65536, 0), ("all_masked", 65536, 512),
                ("random", 2, 9)]


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["fori", "block"])
@pytest.mark.parametrize("kind,cap,batch", LEDGER_EDGES)
def test_ledger_kernel_matches_plain_at_the_edges(cuda, kind, cap, batch,
                                                  variant):
    """Three chained transactions each, under each variant name, against
    the plain version; a masked batch leaves the tables as they were."""
    kw = dict(decay=0.8, unseen_priority=1e6, staleness_half_life=3.0,
              variant=variant)
    st_k = st_r = _ledger_table(cuda, cap)
    for step in range(3):
        ids, losses, valid = ledger_edge_batch(kind, cap, batch, seed=step)
        out_k, out_r = _ledger_tx_check(cuda, st_k, st_r, ids, losses, valid,
                                        step, **kw)
        if kind == "all_masked":
            for got, was in zip(out_k[:4], st_k):
                assert torch.equal(got, was)
        st_k, st_r = out_k[:4], out_r[:4]


@pytest.mark.gpu
def test_ledger_kernel_reads_unaligned_ids(cuda):
    """ids, losses and valid that start one element into their buffers
    (not 16-byte aligned), and no valid mask at all, under each variant
    name."""
    cap = 65536
    ids, losses, valid = ledger_edge_batch("random", cap, 514, seed=5)
    st = _ledger_table(cuda, cap)
    full = [torch.from_numpy(a).to(cuda) for a in (ids, losses, valid)]
    sub = [x[1:] for x in full]
    kw = dict(decay=0.8, unseen_priority=1e6, staleness_half_life=3.0)
    for valid_t, variant in ((sub[2], "fori"), (None, "fori"),
                             (sub[2], "block"), (None, "block")):
        got = ops.ledger_record_priority(*st, sub[0], sub[1], 4,
                                         valid=valid_t, impl="cuda",
                                         variant=variant, **kw)
        want = ops.ledger_record_priority(*st, sub[0], sub[1], 4,
                                          valid=valid_t, impl="ref", **kw)
        for g, w in zip(got[1:4], want[1:4]):
            assert torch.equal(g, w)
        for g, w in (got[0], want[0]), (got[4], want[4]):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=0)


@pytest.mark.gpu
def test_ledger_kernel_outputs_are_disjoint_views(cuda):
    """The five outputs are views of one buffer: an in-place write into
    any one of them leaves the other four as they were."""
    ids, losses, valid = (torch.from_numpy(a).to(cuda) for a in
                          ledger_edge_batch("random", 1024, 64, seed=1))
    out = ops.ledger_record_priority(*_ledger_table(cuda, 1024), ids, losses,
                                     3, valid=valid, impl="cuda", decay=0.8,
                                     unseen_priority=1e6)
    base = out[0].untyped_storage().data_ptr()
    assert all(o.untyped_storage().data_ptr() == base for o in out)
    for k in range(5):
        before = [o.clone() for o in out]
        out[k].fill_(7)
        for j in range(5):
            if j != k:
                assert torch.equal(out[j], before[j]), (k, j)


# decode_attn at the serving shapes (llama3-8b's dense cache, zamba2's shared
# block: D = 80, G = 1), the JAX test's shapes (T no multiple of the tile or
# of the span, G = 16), a granite-34b-like MQA group (G = 48, sliced over
# three blocks), D = 256 with a group of 16 (the most shared memory a block
# takes), rows of mixed lengths in a 2048-slot cache (empty tiles skipped)
# and the prefix checks' dense caches: pixtral-12b's 1,024 patches + 128
# tokens + 16 new ones, musicgen-medium's 64 frames + 128 + 16
DECODE_CASES = [(8, 32, 8, 128, 160), (8, 32, 32, 80, 332),
                (2, 8, 2, 64, 300), (3, 8, 1, 64, 700), (2, 4, 2, 32, 129),
                (3, 16, 1, 64, 700), (8, 48, 1, 128, 512),
                (2, 16, 1, 256, 300), (8, 32, 8, 128, 2048),
                (2, 32, 8, 128, 1168), (2, 24, 24, 64, 208)]
# test_decode_attn_matches_ref's tolerances: f32 summation order only; bf16
# inputs rounded once, weights kept in f32 by both versions
DECODE_TOL = {torch.float32: 2e-6, torch.bfloat16: 3e-2}
# bf16 also per (row, query head), relative in L2 over D: at a 4,096-slot
# context the absolute limit is as large as a typical output, this one
# fails a kernel that drops a tile of 64 positions (chip_smoke.py shows it)
DECODE_BF16_REL = 2e-2


def _decode_close(got, want, dtype):
    torch.testing.assert_close(got.float(), want, rtol=0,
                               atol=DECODE_TOL[dtype])
    if dtype == torch.bfloat16:
        rel = ((got.float() - want).norm(dim=-1)
               / want.norm(dim=-1).clamp_min(1e-30)).max().item()
        assert rel <= DECODE_BF16_REL, rel


@pytest.mark.gpu
@pytest.mark.parametrize("shape", DECODE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attn_kernel_matches_plain(cuda, shape, dtype):
    """Random row lengths, with row 0 masked whole (the mean of V) and
    row 1 seeing one position."""
    b, hq, hkv, d, t = shape
    lens = np.random.default_rng(t).integers(1, t + 1, size=b)
    lens[0], lens[1] = 0, 1
    q, k, v, valid = (torch.from_numpy(a).to(cuda)
                      for a in decode_case(b, hq, hkv, d, t, lens=lens))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    got = ops.decode_attn(q, k, v, valid, impl="cuda")
    assert got.dtype == dtype
    want = ref.decode_attn_ref(q.float(), k.float(), v.float(), valid)
    tol = DECODE_TOL[dtype]
    torch.testing.assert_close(got.float(), want, rtol=0, atol=tol)
    mean = v[0].float().mean(dim=0).repeat_interleave(hq // hkv, dim=0)
    torch.testing.assert_close(got[0].float(), mean, rtol=0, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attn_kernel_matches_plain_at_wide_groups(cuda, dtype):
    """The JAX test's G = 16 case (past the first kernel's G <= 8) and a
    group of 64, with the valid positions of a row inside one span, spans
    with none between valid ones, and an all-masked row."""
    for b, hq, hkv, d, t in ((3, 16, 1, 64, 700), (2, 64, 1, 64, 333)):
        q, k, v, _ = decode_case(b, hq, hkv, d, t, seed=hq)
        valid = np.zeros((b, t), bool)
        valid[1, 40:60] = True  # one span only
        valid[-1, :5] = valid[-1, t - 5:] = True  # the two ends
        q, k, v, valid = (torch.from_numpy(a).to(cuda)
                          for a in (q, k, v, valid))
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        got = ops.decode_attn(q, k, v, valid, impl="cuda")
        want = ref.decode_attn_ref(q.float(), k.float(), v.float(), valid)
        torch.testing.assert_close(got.float(), want, rtol=0,
                                   atol=DECODE_TOL[dtype])
        mean = v[0].float().mean(dim=0).repeat_interleave(hq // hkv, dim=0)
        torch.testing.assert_close(got[0].float(), mean, rtol=0,
                                   atol=DECODE_TOL[dtype])


@pytest.mark.gpu
def test_decode_attn_kernel_refuses_head_dims_past_its_limit(cuda):
    """Any group size runs; a head dim past 256 raises instead of
    launching."""
    q, k, v, valid = (torch.from_numpy(a).to(cuda)
                      for a in decode_case(1, 4, 2, 264, 40))
    with pytest.raises(ValueError, match="D <= 256"):
        ops.decode_attn(q, k, v, valid, impl="cuda")


@pytest.mark.gpu
def test_decode_attn_kernel_matches_plain_with_rolling_window(cuda):
    """The mask of a rolling 64-slot window at depths past the cache."""
    b, hq, hkv, d, t = 4, 8, 2, 64, 64
    q, k, v, _ = decode_case(b, hq, hkv, d, t, seed=9)
    valid = window_mask([3, 63, 64, 200], t, 48)
    q, k, v, valid = (torch.from_numpy(a).to(cuda) for a in (q, k, v, valid))
    got = ops.decode_attn(q, k, v, valid, impl="cuda")
    torch.testing.assert_close(got, ref.decode_attn_ref(q, k, v, valid),
                               rtol=0, atol=DECODE_TOL[torch.float32])


# mixtral-8x22b's decode, 8 rows of 48 query heads over 8 kv heads of 128:
# the short-prompt serve (128-token prompts, 32 new tokens) at contexts
# 129-160 of a 160-slot cache, and the 4,096-slot rolling window with rows
# before, at and past the wrap (the long-prompt serve reads 4,160-token
# contexts)
MIXTRAL_DECODE = {
    "short": (160, np.arange(160)[None] < np.asarray(
        [160, 152, 148, 144, 140, 136, 132, 129])[:, None]),
    "window": (4096, window_mask(
        [0, 127, 4095, 4096, 4160, 4175, 5000, 9000], 4096, 4096)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(MIXTRAL_DECODE))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attn_kernel_matches_plain_at_mixtral_shapes(cuda, case,
                                                           dtype):
    t, valid = MIXTRAL_DECODE[case]
    q, k, v, _ = decode_case(8, 48, 8, 128, t, seed=11)
    q, k, v, valid = (torch.from_numpy(a).to(cuda) for a in (q, k, v, valid))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    got = ops.decode_attn(q, k, v, valid, impl="cuda")
    want = ref.decode_attn_ref(q.float(), k.float(), v.float(), valid)
    _decode_close(got, want, dtype)


# the JAX test's shapes (S no multiple of the chunk, G = 2) and the serving
# prefills of zamba2 (H 80, N 64) and mamba2 (H 32, N 128) at 300 tokens
SSD_CASES = [(2, 64, 4, 16, 1, 32, 16, torch.float32),
             (1, 96, 2, 32, 2, 16, 32, torch.float32),
             (2, 50, 4, 16, 1, 16, 16, torch.float32),
             (1, 300, 80, 64, 1, 64, 128, torch.float32),
             (1, 300, 32, 64, 1, 128, 128, torch.bfloat16),
             # one chunk (a short prompt), an exact multiple of the chunk,
             # N = 256 at L = 128 (bf16, and f32: 32 output rows a block), and
             # the long case's two batch rows
             (1, 100, 80, 64, 1, 64, 128, torch.bfloat16),
             (1, 256, 32, 64, 1, 128, 128, torch.bfloat16),
             (1, 300, 8, 64, 1, 256, 128, torch.bfloat16),
             (1, 300, 8, 64, 1, 256, 128, torch.float32),
             (2, 1024, 8, 64, 2, 64, 128, torch.bfloat16)]
SSD_TOL = dict(atol=3e-4, rtol=1e-3)  # test_ssd_kernel_matches_sequential_ref
# bf16 y: both versions compute in f32 from the same bf16 inputs and round
# once, so an entry may differ by one bf16 unit in the last place
SSD_BF16_RTOL, SSD_BF16_ATOL = 2**-7, 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("bsz,s,h,p,g,n,chunk,dtype", SSD_CASES)
def test_ssd_kernel_matches_plain(cuda, bsz, s, h, p, g, n, chunk, dtype):
    x, dt, a, b, c = (torch.from_numpy(t).to(cuda)
                      for t in ssd_case(bsz, s, h, p, g, n, seed=s))
    x, b, c = x.to(dtype), b.to(dtype), c.to(dtype)
    y, st = ops.ssd_scan(x, dt, a, b, c, chunk=chunk, impl="cuda")
    assert y.dtype == dtype and st.dtype == torch.float32
    cy, cst = ssd_chunked(x, dt, a, b, c, chunk=min(chunk, s))
    torch.testing.assert_close(st, cst, **SSD_TOL)
    if dtype == torch.float32:
        torch.testing.assert_close(y, cy, **SSD_TOL)
        ry, rst = ref.ssd_ref(x, dt, a, b, c)
        torch.testing.assert_close(y, ry, **SSD_TOL)
        torch.testing.assert_close(st, rst, **SSD_TOL)
    else:
        torch.testing.assert_close(y.float(), cy.float(), rtol=SSD_BF16_RTOL,
                                   atol=SSD_BF16_ATOL)


# ssd_bwd at mamba2-370m's train shape (8 x 512 kept rows, H 32, N 128) in
# bf16 and f32, zamba2-2.7b's heads (H 80, N 64), G = 2, S = 300 (a short
# last chunk), S < L, and a non-zero final-state cotangent
# (bsz, s, h, p, g, n, chunk, dtype, final-state cotangent)
SSD_BWD_CASES = [(8, 512, 32, 64, 1, 128, 128, torch.bfloat16, False),
                 (8, 512, 32, 64, 1, 128, 128, torch.float32, False),
                 (2, 512, 80, 64, 1, 64, 128, torch.bfloat16, False),
                 (2, 300, 8, 64, 2, 64, 128, torch.float32, False),
                 (2, 300, 8, 64, 2, 64, 128, torch.bfloat16, True),
                 (1, 100, 32, 64, 1, 128, 128, torch.bfloat16, False),
                 (2, 300, 32, 64, 1, 128, 128, torch.float32, True),
                 (2, 50, 4, 16, 2, 16, 16, torch.float32, True)]
# f32 sums in another order: |kernel - plain| <= atol * max|plain| + rtol
# * |plain| (the decays e^{cum_i - cum_j} differ where cum_i and cum_j are
# large and close); a bf16 dx, dB or dC also by one bf16 unit in the last
# place (both versions compute in f32 and round once)
SSD_BWD_ATOL, SSD_BWD_RTOL, SSD_BWD_BF16_RTOL = 2e-4, 1e-3, 2**-7


def _ssd_bwd_case(cuda, bsz, s, h, p, g, n, dtype, fin):
    x, dt, a, b, c = (torch.from_numpy(t).to(cuda)
                      for t in ssd_case(bsz, s, h, p, g, n, seed=s))
    rs = np.random.default_rng(s + 1)
    dy = torch.from_numpy(rs.standard_normal(x.shape).astype(np.float32))
    df = (torch.from_numpy(rs.standard_normal((bsz, h, p, n)).astype(
        np.float32)).to(cuda) if fin else None)
    return (x.to(dtype), dt, a, b.to(dtype), c.to(dtype),
            dy.to(cuda).to(dtype), df)


@pytest.mark.gpu
@pytest.mark.parametrize("bsz,s,h,p,g,n,chunk,dtype,fin", SSD_BWD_CASES)
def test_ssd_bwd_kernel_matches_plain(cuda, bsz, s, h, p, g, n, chunk, dtype,
                                      fin):
    x, dt, a, b, c, dy, df = _ssd_bwd_case(cuda, bsz, s, h, p, g, n, dtype,
                                           fin)
    y, st, states = ops._ssd_forward(x, dt, a, b, c, chunk, "cuda", True)
    _, _, want_states = ssd_chunked(x, dt, a, b, c, chunk=chunk,
                                    return_states=True)
    torch.testing.assert_close(states, want_states.contiguous(), **SSD_TOL)
    got = ops.ssd_bwd(x, dt, a, b, c, states, dy, df, chunk, impl="cuda")
    want = ops.ssd_bwd(x, dt, a, b, c, states, dy, df, chunk, impl="ref")
    for name, k, w in zip(("dx", "ddt", "da", "dB", "dC"), got, want):
        assert k.dtype == w.dtype and k.shape == w.shape, name
        kf, wf = k.float(), w.float()
        rtol = SSD_BWD_BF16_RTOL if k.dtype == torch.bfloat16 else \
            SSD_BWD_RTOL
        lim = SSD_BWD_ATOL * wf.abs().max() + rtol * wf.abs()
        assert ((kf - wf).abs() <= lim).all(), \
            f"{name}: err {(kf - wf).abs().max().item()}"
    again = ops.ssd_bwd(x, dt, a, b, c, states, dy, df, chunk, impl="cuda")
    for k, k2 in zip(got, again):  # no atomics: the same bits every call
        assert torch.equal(k, k2)


@pytest.mark.gpu
def test_ssd_scan_autograd_launches_the_backward_kernel(cuda):
    """Through ``ssd_scan`` under autograd: the forward kernel keeps its
    states, the backward kernel gives the gradients, the launch counts
    tick once each, and a no-grad call launches the forward alone."""
    x, dt, a, b, c, dy, _ = _ssd_bwd_case(cuda, 2, 300, 8, 64, 1, 64,
                                          torch.bfloat16, False)
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, a, b, c)]
    before = dict(ops.LAUNCHES)
    y, _ = ops.ssd_scan(*leaves, chunk=128)
    y.backward(dy)
    assert ops.LAUNCHES["ssd"] == before["ssd"] + 1
    assert ops.LAUNCHES["ssd_bwd"] == before["ssd_bwd"] + 1
    y2, _, st = ops._ssd_forward(x, dt, a, b, c, 128, "cuda", True)
    assert torch.equal(y.detach(), y2)
    want = ops.ssd_bwd(x, dt, a, b, c, st, dy, None, 128, impl="cuda")
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)
    with torch.no_grad():
        ops.ssd_scan(*leaves, chunk=128)
    assert ops.LAUNCHES["ssd_bwd"] == before["ssd_bwd"] + 2


def test_ssd_bwd_cuda_refuses_cpu_tensors():
    """``impl="cuda"`` on CPU tensors raises instead of taking the plain
    version (no card needed)."""
    x, dt, a, b, c = (torch.from_numpy(t) for t in ssd_case(1, 20, 2, 8, 1,
                                                            8))
    _, _, states = ssd_chunked(x, dt, a, b, c, chunk=16, return_states=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.ssd_bwd(x, dt, a, b, c, states, torch.ones_like(x), None, 16,
                    impl="cuda")
