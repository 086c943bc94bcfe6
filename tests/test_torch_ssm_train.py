"""Training the ssm family in the port against the JAX package.

The SSD scan's plain backward (``ref.ssd_bwd_ref``, the formulas written
out) against ``jax.vjp`` of the JAX ``ssd_chunked`` and against torch
autograd through the port's ``ssd_chunked``, over several chunks, a short
last chunk, S < L, G = 2 and a non-zero final-state cotangent, in f32 and
bf16. Tolerances, |port - reference| <= atol * max|reference| + rtol *
|reference| entry by entry: f32 sums in another order (atol 1e-5, rtol
1e-5); a bf16 dx, dB or dC may also differ by one bf16 unit in the last
place (both sides compute in f32 and round once: rtol 2^-7).

The train step: JAX ``make_train_step`` and the port's from the same
weights on mamba2-370m's smoke config in f32, rows of 24 tokens (a chunk of
16 and a short one of 8), with SGD-momentum (after one step its state
holds the kept rows' grads), in the modes of
``test_train_step_matches_jax``: per-example losses rtol 1e-5, kept rows
exact, grads (the optimizer state) rtol 1e-4 atol 1e-6, params atol 1e-6
(an update of lr = 0.05 times the grads), the device ledger
through ``assert_ledger_states_close``. Then the same grads with and
without remat, the no-grad scan that keeps nothing, and the train CLI on
the ssm and the hybrid family.

The bf16 backward kernel's plan, before any card: its arithmetic written
out in torch with the kernel's rounding points (bf16 operands exact, each
f32 operand split into hi + lo bf16, f32 sums) against the plain backward
within the card's tolerances, and its shared-memory layouts and limits
(``kernels/ssd.py::bwd_smem_bytes``, ``bwd_limit``) against sums by hand.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _ledger_parity import assert_ledger_states_close
from _torch_cases import JaxDraws, ssd_case
from repro import configs as jconfigs
from repro import optim as JO
from repro.core import device_ledger as jled
from repro.core import obftf as JOB
from repro.core.history import HistoryConfig as JHistoryConfig
from repro.data import DataConfig, SyntheticLMStream
from repro.models import model as JM
from repro.models import ssm as JS
from repro.models.params import materialize as jmaterialize
from repro_torch import configs
from repro_torch import optim as O
from repro_torch.core import device_ledger as tled
from repro_torch.core import obftf as OB
from repro_torch.core.history import HistoryConfig
from repro_torch.core.selection import SelectionConfig
from repro_torch.kernels import ops, ref
from repro_torch.launch import train
from repro_torch.models import model as M
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import from_jax, tree_leaves

torch.set_num_threads(1)

F32_TOL = dict(atol=1e-5, rtol=1e-5)  # f32 sums in another order
BF16_RTOL = 2**-7  # one bf16 unit in the last place, rounded once
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)  # as test_torch_moe.py's grads
PARAM_ATOL = 1e-6
ARCH = "mamba2-370m"
JCFG = dataclasses.replace(jconfigs.get_smoke(ARCH), param_dtype="float32",
                           compute_dtype="float32")
CFG = ModelConfig(**dataclasses.asdict(JCFG))
N_ROWS, SEQ = 8, 24  # chunks of 16 and 8 at the smoke config's chunk of 16


def _close(got, want, what, rtol, atol=F32_TOL["atol"]):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    lim = atol * np.abs(want).max(initial=1.0) + rtol * np.abs(want)
    err = np.abs(got - want)
    assert (err <= lim).all(), f"{what}: err {err.max()} (limit {lim.max()})"


# ---------------------------------------------------------------------------
# the scan's plain backward
# ---------------------------------------------------------------------------

# (bsz, s, h, p, g, n, chunk, final-state cotangent)
BWD_CASES = {
    "chunks": (2, 64, 4, 16, 1, 32, 16, False),
    "short_last": (1, 50, 4, 8, 1, 16, 16, False),
    "s_below_chunk": (2, 10, 2, 8, 1, 8, 16, False),
    "g2": (1, 40, 4, 8, 2, 8, 16, False),
    "final_cotangent": (2, 40, 2, 8, 1, 8, 16, True),
}


def _bwd_inputs(case, dtype):
    bsz, s, h, p, g, n, chunk, fin = case
    x, dt, a, b, c = ssd_case(bsz, s, h, p, g, n, seed=s)
    rs = np.random.default_rng(s + 1)
    dy = rs.standard_normal(x.shape).astype(np.float32)
    df = (rs.standard_normal((bsz, h, p, n)).astype(np.float32) if fin
          else None)
    t = [torch.from_numpy(v) for v in (x, dt, a, b, c, dy)]
    for i in (0, 3, 4, 5):  # x, B, C and dy in the working dtype
        t[i] = t[i].to(dtype)
    return t, (None if df is None else torch.from_numpy(df)), min(chunk, s)


def _jnp(t):
    """A torch tensor as a jnp array of the same dtype and values."""
    arr = jnp.asarray(t.float().numpy())
    return arr.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else arr


@functools.cache
def _jax_vjp(chunk):
    def vjp(x, dt, a, b, c, dy, dfinal):
        _, back = jax.vjp(functools.partial(JS.ssd_chunked, chunk=chunk),
                          x, dt, a, b, c)
        return back((dy, dfinal))

    return jax.jit(vjp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", BWD_CASES.values(), ids=BWD_CASES.keys())
def test_ssd_bwd_ref_matches_jax_vjp_and_autograd(case, dtype):
    (x, dt, a, b, c, dy), df, chunk = _bwd_inputs(case, dtype)
    _, _, states = S.ssd_chunked(x, dt, a, b, c, chunk=chunk,
                                 return_states=True)
    got = ref.ssd_bwd_ref(x, dt, a, b, c, states, dy, df, chunk=chunk)
    assert [g.dtype for g in got] == [dtype, torch.float32, torch.float32,
                                      dtype, dtype]

    jdf = (jnp.zeros(states[:, :, 0].shape, jnp.float32) if df is None
           else jnp.asarray(df.numpy()))
    want_jax = _jax_vjp(chunk)(*map(_jnp, (x, dt, a, b, c, dy)), jdf)

    leaves = [t.clone().requires_grad_(True) for t in (x, dt, a, b, c)]
    y, final = S.ssd_chunked(*leaves, chunk=chunk)
    outs, cots = [y], [dy]
    if df is not None:
        outs.append(final)
        cots.append(df)
    want_torch = torch.autograd.grad(outs, leaves, cots)

    for name, mine, wj, wt in zip(("dx", "ddt", "da", "dB", "dC"), got,
                                  want_jax, want_torch):
        rtol = BF16_RTOL if mine.dtype == torch.bfloat16 else F32_TOL["rtol"]
        _close(mine.float().numpy(), np.asarray(wj, np.float32),
               f"{name} vs jax", rtol)
        _close(mine.float().numpy(), wt.float().numpy(), f"{name} vs torch",
               rtol)

    # ops.ssd_scan differentiates through the same backward on the CPU
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, a, b, c)]
    y, final = ops.ssd_scan(*leaves, chunk=chunk)
    torch.autograd.backward([y] + ([final] if df is not None else []), cots)
    for name, mine, leaf in zip(("dx", "ddt", "da", "dB", "dC"), got,
                                leaves):
        assert torch.equal(leaf.grad, mine), name


# the card's tolerances for the backward kernel (chip_smoke.py's and
# tests/test_torch_kernels_gpu.py's SSD_BWD_*): |kernel - plain| <=
# SSD_BWD_ATOL * max|plain| + rtol * |plain|, rtol SSD_BWD_BF16_RTOL for a
# bf16 dx, dB or dC, else SSD_BWD_RTOL
SSD_BWD_ATOL, SSD_BWD_RTOL, SSD_BWD_BF16_RTOL = 2e-4, 1e-3, 2**-7


def _split(t):
    """An f32 operand as the kernel feeds it to the tensor cores: hi the
    nearest bf16, lo the nearest bf16 to the rest (both as f32)."""
    hi = t.to(torch.bfloat16).float()
    return hi, (t - hi).to(torch.bfloat16).float()


def _tc(eq, u, v, split):
    """einsum ``eq`` of u and v as mma.sync takes it: the f32 operand
    (``split`` = 0 for u, 1 for v) as hi + lo, two products in f32; the
    other operand is exact bf16."""
    if split == 0:
        hi, lo = _split(u)
        return torch.einsum(eq, hi, v) + torch.einsum(eq, lo, v)
    hi, lo = _split(v)
    return torch.einsum(eq, u, hi) + torch.einsum(eq, u, lo)


def _design_bwd(x, dt, a, b, c, states, dy, dfinal, chunk):
    """The bf16 path of csrc/ssd_bwd.cu written out with its rounding
    points -> (dx, ddt, da, dB, dC) in f32, before the outputs' rounding.
    The contribution grid's dy^T (C e^{cum}) and the fold; the query side
    (per block of i rows) dC_i = e^{cum_i} S^T dy_i + sum_{j <= i} W_ij
    B_j, its row term sum_j W_ij (C_i . B_j) + e^{cum_i} C_i . S^T dy_i;
    the key side (per block of j rows) dB_j = e^{total - cum_j} dt_j dS'^T
    x_j + sum_{i >= j} W_ij C_i and its column sums sum_i M_ij q_ij, and
    dx_j = dt_j (e^{total - cum_j} dS' B_j + sum_{i >= j} M_ij dy_i) with
    x_j . dS' B_j; then g, ddt and da from those terms."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep, nc = h // g, -(-s // chunk)
    pad = nc * chunk - s

    def chunks(t):  # [B, S, ...] -> f32 [B, nc, L, ...], zero-padded
        t = t.float()
        if pad:
            t = torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(bsz, nc, chunk, *t.shape[2:])

    xf, dyf, dtf = chunks(x), chunks(dy), chunks(dt)
    bh = chunks(b).repeat_interleave(rep, dim=3)
    ch = chunks(c).repeat_interleave(rep, dim=3)
    cum = torch.cumsum(dtf * a, dim=2)
    total = cum[:, :, -1]
    ecum, tail = torch.exp(cum), torch.exp(total[:, :, None] - cum)
    st = states.float().transpose(1, 2)  # [B, nc, H, P, N]

    u = _tc("bclhp,bclhn->bchpn", dyf, ch * ecum[..., None], 1)
    gcur = (torch.zeros((bsz, h, p, n)) if dfinal is None
            else dfinal.float())
    gs = [None] * nc
    for ci in reversed(range(nc)):
        gs[ci] = gcur
        gcur = torch.exp(total[:, ci])[..., None, None] * gcur + u[:, ci]
    gs = torch.stack(gs, dim=1)

    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
    causal = causal[None, None, :, :, None]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    decay = torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)),
                        0.0)
    sc = torch.einsum("bcihn,bcjhn->bcijh", ch, bh)  # exact C . B^T
    q = torch.einsum("bcihp,bcjhp->bcijh", dyf, xf)  # exact dy . x^T
    m = sc * decay
    w = decay * q * dtf[:, :, None]

    sdy = _tc("bcihp,bchpn->bcihn", dyf, st, 1)  # S^T dy_i
    dc = ecum[..., None] * sdy + _tc("bcijh,bcjhn->bcihn", w, bh, 0)
    qrow = (w * sc).sum(3) + ecum * (ch * sdy).sum(-1)
    db = ((tail * dtf)[..., None] * _tc("bcjhp,bchpn->bcjhn", xf, gs, 1)
          + _tc("bcijh,bcihn->bcjhn", w, ch, 0))
    colr = (m * q).sum(2)
    gb = _tc("bcjhn,bchpn->bcjhp", bh, gs, 1)  # dS' B_j
    krow = tail * (xf * gb).sum(-1)
    dxu = tail[..., None] * gb + _tc("bcijh,bcihp->bcjhp", m, dyf, 0)
    glast = (torch.exp(total) * (gs * st).sum((-1, -2))
             + (dtf * krow).sum(dim=2))
    gcum = qrow - dtf * (colr + krow)
    gcum[:, :, -1] += glast
    dda = torch.flip(torch.cumsum(torch.flip(gcum, [2]), dim=2), [2])

    def unchunk(t):
        return t.reshape(bsz, nc * chunk, *t.shape[3:])[:, :s]

    def group_sum(t):
        return t.reshape(*t.shape[:3], g, rep, n).sum(dim=4)

    return (unchunk(dtf[..., None] * dxu), unchunk(colr + krow + a * dda),
            (dtf * dda).sum((0, 1, 2)), unchunk(group_sum(db)),
            unchunk(group_sum(dc)))


# (bsz, s, h, p, g, n, chunk, final-state cotangent): mamba2-370m's widths
# with two chunks; zamba2-2.7b's N, a short last chunk, G = 2 and a final
# cotangent
DESIGN_CASES = {"mamba2": (1, 256, 4, 64, 1, 128, 128, False),
                "zamba2_short_g2": (1, 200, 4, 64, 2, 64, 128, True)}


@pytest.mark.parametrize("case", DESIGN_CASES.values(),
                         ids=DESIGN_CASES.keys())
def test_bwd_split_design_is_within_half_the_card_tolerance(case):
    """The bf16 kernel's design before any chip call: bf16 operands exact,
    every f32 operand (the decayed M and W, C e^{cum}, S and dS') split
    into hi + lo bf16, sums in f32, the column and row terms of g taken as
    x_j . u_j and C_i . dC_i. Before rounding it uses under half of the
    card's tolerances against the plain version in f32 on the same inputs
    (at f32's rtol even for dx, dB and dC); rounded to the outputs' types,
    it holds against the plain version within the tolerances the card
    holds the kernel to."""
    (x, dt, a, b, c, dy), df, chunk = _bwd_inputs(case, torch.bfloat16)
    _, _, states = S.ssd_chunked(x, dt, a, b, c, chunk=chunk,
                                 return_states=True)
    design = _design_bwd(x, dt, a, b, c, states, dy, df, chunk)
    f32 = [t.float() for t in (x, b, c, dy)]
    plain32 = ref.ssd_bwd_ref(f32[0], dt, a, f32[1], f32[2], states, f32[3],
                              df, chunk=chunk)
    plain = ref.ssd_bwd_ref(x, dt, a, b, c, states, dy, df, chunk=chunk)
    for name, d, w32, w in zip(("dx", "ddt", "da", "dB", "dC"), design,
                               plain32, plain):
        lim = SSD_BWD_ATOL * w32.abs().max() + SSD_BWD_RTOL * w32.abs()
        used = ((d - w32).abs() / lim).max().item()
        assert used < 0.5, f"{name}: {used:.3f} of the f32 tolerance"
        rtol = (SSD_BWD_BF16_RTOL if w.dtype == torch.bfloat16
                else SSD_BWD_RTOL)
        wf = w.float()
        lim = SSD_BWD_ATOL * wf.abs().max() + rtol * wf.abs()
        err = (d.to(w.dtype).float() - wf).abs()
        assert (err <= lim).all(), f"{name}: err {err.max().item()}"


# the card's shared memory: 228 KB an SM, 1 KB of it kept for each
# resident block, at most 232,448 bytes for one block
SM_SMEM, BLOCK_RESERVED = 233472, 1024


@pytest.mark.parametrize("chunk,p,n,total,blocks_per_sm", [
    (128, 64, 128, 18432 + 34816 + 33792 + 1024 + 26624, 2),  # mamba2-370m
    (128, 64, 64, 18432 + 18432 + 17408 + 1024 + 18432, 3),  # zamba2-2.7b
    (128, 64, 256, 18432 + 67584 + 66560 + 1024 + 43008, 1),  # N = 256
    (64, 64, 128, 9216 + 17408 + 33792 + 512 + 26624, 2),  # chunks of 64
    (16, 16, 16, 768 + 768 + 1280 + 128 + 6144, 16)])  # the smoke configs
def test_bwd_tc_chunk_grid_layout_mirror(chunk, p, n, total, blocks_per_sm):
    """csrc/ssd_bwd.cu's chunk_tc summed by hand: [L16, P16 + 8] bf16 (x or
    dy), [L16, Np + 8] bf16 (B or C), the f32 state [P16, Np + 4], dt and
    cum [L16], then 4 warps' own rows [16, P16 + 8] and [16, Np + 8] bf16.
    At mamba2-370m's and zamba2-2.7b's shapes two blocks or more fit an SM
    beside their reserved kilobyte each."""
    from repro_torch.kernels import ssd as SSD

    need = SSD.bwd_smem_bytes(chunk, p, n, 2)
    assert need == total
    assert blocks_per_sm * (need + BLOCK_RESERVED) <= SM_SMEM
    assert (blocks_per_sm + 1) * (need + BLOCK_RESERVED) > SM_SMEM \
        or blocks_per_sm == 16  # 2,048 threads an SM
    assert 2 * need <= SSD.MAX_SMEM or blocks_per_sm == 1
    assert SSD.bwd_limit(chunk, p, n, n, 2) is None


@pytest.mark.parametrize("chunk,p,n,why", [
    (129, 64, 64, "chunk 129 is past 128 in bf16"),
    (256, 32, 64, "chunk 256 is past 128 in bf16"),
    (128, 72, 64, "P=72 is past 64 in bf16"),
    (128, 64, 264, "N=264 is past 256 in bf16"),
    (128, 60, 64, "P=60 and N=64 must be multiples of 8 in bf16"),
    (128, 64, 100, "P=64 and N=100 must be multiples of 8 in bf16")])
def test_bwd_tc_limits_refuse_with_the_reason(chunk, p, n, why):
    """The bf16 path's limits, where its header puts them: chunks up to 128
    (two 16-row tiles a warp), P up to 64 (the dx tile), N up to 256,
    P and N multiples of 8; the wrapper raises with the reason."""
    from repro_torch.kernels import ssd as SSD

    assert SSD.bwd_limit(chunk, p, n, n, 2).startswith(why)
    x, dt, a, b, c = (torch.from_numpy(t)
                      for t in ssd_case(1, chunk, 1, p, 1, n))
    states = torch.zeros((1, 1, 1, p, n))
    x, b, c = (t.to(torch.bfloat16) for t in (x, b, c))
    with pytest.raises(ValueError, match="CUDA"):  # before any limit
        ops.ssd_bwd(x, dt, a, b, c, states, x, None, chunk, impl="cuda")


def test_bwd_f32_path_keeps_its_limits_and_layout():
    """The f32 path (the CUDA-core code) as before: 191,488 bytes at L 128,
    P 64 whatever N, chunks to 256 with L P up to 8192."""
    from repro_torch.kernels import ssd as SSD

    for n in (16, 64, 128, 256):
        assert SSD.bwd_smem_bytes(128, 64, n, 4) == 191488
        assert SSD.bwd_limit(128, 64, n, n, 4) is None
    assert SSD.bwd_limit(257, 16, 64, 64, 4).startswith("chunk 257 is past")
    assert "register tiles" in SSD.bwd_limit(128, 72, 64, 64, 4)
    assert "shared memory" in SSD.bwd_limit(256, 32, 64, 64, 4)
    assert SSD.bwd_contrib_smem_bytes(128, 64, 128, 2) == \
        SSD.state_smem_bytes(128, 64, 128, 2)


def test_no_grad_scan_keeps_no_states_and_equals_the_old_forward(
        monkeypatch):
    """Without a gradient to take, ``ssd_scan`` runs the forward alone
    (no states kept) and gives the chunked scan's bits; with one, it keeps
    the states and its outputs are the same bits."""
    case = [torch.from_numpy(v) for v in ssd_case(2, 40, 4, 8, 1, 16)]
    want = S.ssd_chunked(*case, chunk=16)
    seen = []
    forward = ops._ssd_forward

    def spy(*args):
        seen.append(args[-1])
        return forward(*args)

    monkeypatch.setattr(ops, "_ssd_forward", spy)
    before = dict(ops.LAUNCHES)
    for run in ("plain", "no_grad"):
        with torch.set_grad_enabled(run == "plain"):
            y, final = ops.ssd_scan(*case, chunk=16)
        assert y.grad_fn is None and final.grad_fn is None
        assert torch.equal(y, want[0]) and torch.equal(final, want[1])
    leaves = [t.clone().requires_grad_(True) for t in case]
    with torch.no_grad():
        ops.ssd_scan(*leaves, chunk=16)
    assert seen == [False, False, False]
    y, final = ops.ssd_scan(*leaves, chunk=16)
    assert seen[-1] is True and y.grad_fn is not None
    assert torch.equal(y.detach(), want[0])
    assert torch.equal(final.detach(), want[1])
    assert ops.LAUNCHES == before  # the CPU launches no kernel


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    jp = jax.jit(lambda k: jmaterialize(JM.param_specs(JCFG), k,
                                        jnp.float32))(jax.random.key(0))
    raw = SyntheticLMStream(DataConfig(N_ROWS, SEQ, CFG.vocab_size,
                                       seed=4)).batch(0)
    labels = raw["labels"].copy()
    labels[1, -3:] = -1  # masked positions
    rec = np.random.default_rng(2).uniform(1, 9, N_ROWS).astype(np.float32)
    batch = {"tokens": raw["tokens"], "labels": labels,
             "instance_id": raw["instance_id"].astype(np.int32),
             "recorded_loss": rec}
    return jax.tree.map(np.asarray, jp), batch


_jax_eval = jax.jit(JOB.make_eval_step(JM.loss_fn(JCFG)))


def _sgd(M_):
    return M_.sgd_momentum(M_.constant(0.05), momentum=0.9)


CASES = [("full", "obftf", False), ("obftf", "maxk", False),
         ("obftf", "maxk", True), ("obftf", "obftf", False),
         ("obftf", "obftf", True)]


@pytest.mark.parametrize("mode,method,recycle", CASES,
                         ids=["full", "maxk", "maxk-recycled",
                              "obftf-noise", "obftf-noise-recycled"])
def test_train_step_matches_jax(setup, mode, method, recycle):
    jp, batch = setup
    jopt, topt = _sgd(JO), _sgd(O)
    jstep = jax.jit(JOB.make_train_step(
        JM.loss_fn(JCFG), jopt, JOB.OBFTFConfig(
            selection=JOB.SelectionConfig(method=method, ratio=0.25),
            recycle_forward=recycle, mode=mode)))
    tstep = OB.make_train_step(M.loss_fn(CFG), topt, OB.OBFTFConfig(
        selection=SelectionConfig(method=method, ratio=0.25),
        recycle_forward=recycle, mode=mode))
    jparams = jax.tree.map(jnp.asarray, jp)
    tparams = from_jax(jp, "cpu")
    rng = jax.random.key(5)
    jnew, jm = jstep({"params": jparams, "opt": jopt.init(jparams),
                      "step": jnp.zeros((), jnp.int32)},
                     {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    tnew, tm = tstep({"params": tparams, "opt": topt.init(tparams),
                      "step": torch.zeros((), dtype=torch.int32)},
                     {k: torch.from_numpy(v) for k, v in batch.items()},
                     JaxDraws(jax.random.split(rng, 3)[1]))

    np.testing.assert_allclose(tm["per_example_loss"].numpy(),
                               np.asarray(jm["per_example_loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_array_equal(tm["per_example_fresh"].numpy(),
                                  np.asarray(jm["per_example_fresh"]))
    if mode == "obftf":  # the kept rows: the JAX selector on its losses
        jsel = JOB.SelectionConfig(method=method, ratio=0.25)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jl = (jb["recorded_loss"] if recycle
              else _jax_eval(jparams, jb, rng))
        _, jidx, _ = JOB.select_and_gather(jsel, jax.random.split(rng, 3)[1],
                                           jl, jb)
        np.testing.assert_array_equal(tm["selected"].numpy(),
                                      np.asarray(jidx))
    for k in ("kept", "step_cost"):
        assert float(tm[k]) == float(jm[k]), k
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    # SGD-momentum's state after one step is the kept rows' grads
    for t, j in zip(tree_leaves(tnew["opt"]["m"]),
                    jax.tree.leaves(jnew["opt"]["m"])):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **GRAD_TOL)
    ssm = tnew["opt"]["m"]["blocks"]["ssm"]
    for k in ("a_log", "dt_bias", "conv_w"):  # reached through the scan only
        assert float(ssm[k].abs().max()) > 0, k
    for t, j in zip(tree_leaves(tnew["params"]),
                    jax.tree.leaves(jnew["params"])):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=PARAM_ATOL)
    # the fresh losses into each package's device ledger
    ids = batch["instance_id"]
    jlcfg = JHistoryConfig(capacity=1 << 8)
    jl = jax.jit(functools.partial(jled.record, jlcfg))(
        jled.init_state(jlcfg), jnp.asarray(ids), jm["per_example_loss"], 1,
        valid=jm["per_example_fresh"])
    tlcfg = HistoryConfig(capacity=1 << 8)
    tl, _ = tled.record_priority(
        tlcfg, tled.init_state(tlcfg, "cpu"), torch.from_numpy(ids),
        tm["per_example_loss"], 1, valid=tm["per_example_fresh"])
    assert_ledger_states_close(tled.state_dict_of(tl), jled.state_dict_of(jl),
                               rtol=LOSS_RTOL)


def test_remat_gives_the_same_grads(setup):
    jp, batch = setup
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads = []
    for remat in (False, True):
        cfg = dataclasses.replace(CFG, remat=remat)
        params = from_jax(jp, "cpu")
        for p in tree_leaves(params):
            p.requires_grad_(True)
        M.loss_fn(cfg)(params, OB.model_inputs(tb)).mean().backward()
        grads.append([p.grad for p in tree_leaves(params)])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("arch", [ARCH, "zamba2-2.7b"])
def test_train_cli_runs_the_family_with_the_jax_json_names(arch, tmp_path,
                                                           capsys):
    """The train CLI on the ssm (mamba2-370m) and hybrid (zamba2-2.7b)
    smoke configs, with the JAX trainer's summary names."""
    from test_torch_train import _jax_summary_names

    out = tmp_path / "run.json"
    assert train.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--steps", "3", "--global-batch", "8", "--seq-len",
                       str(SEQ), "--log-every", "1", "--json-out",
                       str(out)]) == 0
    s = json.loads(out.read_text())
    names = _jax_summary_names()
    assert names["summary"] <= set(s)
    assert names["health"] == set(s["health"])
    assert s["steps"] == 3
    assert s["layers"] == configs.get_smoke(arch).num_layers
    assert s["mean_step_cost"] == pytest.approx(1.75)
    assert s["moe_dropped_share"] is None
    assert np.isfinite([s["loss_first"], s["loss_last"]]).all()
    assert "step     0 loss=" in capsys.readouterr().out
