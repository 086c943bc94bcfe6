"""The port's MLA (DeepSeek-V2 multi-head latent attention) and
deepseek-v2-236b against the JAX package: ``models/layers.py``'s MLA
functions one by one, the model on deepseek-v2-236b's smoke config (MLA,
a ``first_k_dense`` layer, a shared expert, ungated top-k), one OBFTF
step, the smoke config cut to its one dense layer (an empty MoE stack),
the serving engine and both CLIs; and the MoE routing count under remat.
Float32 unless a test says otherwise, inputs from numpy seeds, weights the
port's seeded draw carried to JAX as numpy.

Tolerances: MLA layer outputs atol 1e-5; model logits and hidden states
atol 1e-4 (``tests/test_models_smoke.py``'s bound); per-example losses
rtol 1e-5, grads rtol 1e-4 + atol 1e-6, params after AdamW atol 1e-6 (2 lr
where a grad is below 1e-6, as in ``tests/test_torch_moe.py``), ledgers
through ``assert_ledger_states_close``; in bf16 MLA's attention and decode
equal the JAX package's bit for bit, the softmax weights rounded to bf16
before the value product in both.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _ledger_parity import DERIVED_RTOL, assert_ledger_states_close
from _torch_cases import JaxDraws
from repro import configs as jconfigs
from repro import optim as JO
from repro.core import device_ledger as jled
from repro.core import obftf as JOB
from repro.core.history import HistoryConfig as JHistoryConfig
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import moe as JMoE
from repro.serving import Engine as JEngine
from repro.serving import OutcomeRecorder as JRecorder
from repro_torch import configs
from repro_torch import optim as O
from repro_torch.core import device_ledger as tled
from repro_torch.core import obftf as OB
from repro_torch.core.history import HistoryConfig
from repro_torch.core.selection import SelectionConfig
from repro_torch.launch import serve, train
from repro_torch.models import layers as TL
from repro_torch.models import model as M
from repro_torch.models import moe as MoE
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import from_jax, materialize, tree_leaves
from repro_torch.serving import Engine, OutcomeRecorder

torch.set_num_threads(1)
# the JAX side's programs compile without LLVM's optimizations (as in
# tests/test_torch_archs.py): reference values move by a few f32 units
jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0})

ARCH = "deepseek-v2-236b"
LAYER_ATOL = 1e-5
ATOL = 1e-4
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-6
LR = 1e-3


def _cfgs(**kw):
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH),
                               param_dtype="float32",
                               compute_dtype="float32", **kw)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _np(t):
    return t.detach().float().numpy()


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _to_numpy(tree):
    """Numpy leaves, keys sorted as ``jax.tree.leaves`` orders them."""
    if isinstance(tree, dict):
        return {k: _to_numpy(tree[k]) for k in sorted(tree)}
    return tree.numpy()


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.fixture(scope="module")
def attn():
    """(JAX config, port config, JAX MLA weights, port MLA weights)."""
    jcfg, cfg = _cfgs()
    tp = materialize(TL.mla_specs(cfg), 3, torch.float32, "cpu")
    return jcfg, cfg, _to_numpy(tp), tp


def _model(**kw):
    jcfg, cfg = _cfgs(**kw)
    jp = _to_numpy(materialize(M.param_specs(cfg), 0, torch.float32, "cpu"))
    return jcfg, cfg, jp, from_jax(jp, "cpu")


@pytest.fixture(scope="module")
def model():
    return _model()


# ---------------------------------------------------------------------------
# the config and the MLA functions of models/layers.py
# ---------------------------------------------------------------------------


def _spec_items(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_items(tree[k],
                                                             path + (k,))]
    return [(path, tuple(tree.shape), tree.init, tree.scale)]


def test_config_specs_and_param_tree_match_jax():
    for get, jget in ((configs.get, jconfigs.get),
                      (configs.get_smoke, jconfigs.get_smoke)):
        assert dataclasses.asdict(get(ARCH)) == dataclasses.asdict(jget(ARCH))
    jcfg, cfg = _cfgs()
    jitems = _spec_items(JL.mla_specs(jcfg))
    assert _spec_items(TL.mla_specs(cfg)) == jitems
    assert [x[0] for x in jitems] == [("kv_norm",), ("q_norm",), ("wkv_a",),
                                      ("wkv_b",), ("wo",), ("wq_a",),
                                      ("wq_b",)]
    jshapes = jax.tree.map(lambda s: s.shape, JM.param_specs(jcfg),
                           is_leaf=lambda s: hasattr(s, "axes"))
    tshapes = jax.tree.map(lambda s: s.shape, _to_numpy(materialize(
        M.param_specs(cfg), 0, torch.float32, "cpu")))
    assert tshapes == jshapes
    assert set(jshapes) == {"dense_blocks", "blocks", "embed", "final_norm",
                            "lm_head"}
    full = configs.get(ARCH)
    assert full.attn_impl == "mla" and not full.route_norm
    assert (full.kv_lora_rank + full.qk_rope_head_dim) == 576


def test_mla_q_and_kv_latent_match_jax(attn):
    """Positions shared by the batch, and a row of positions per example
    (the engine's decode)."""
    jcfg, cfg, jp, tp = attn
    x = _x((3, 7, cfg.d_model), 1)
    for pos in (np.arange(7), np.arange(21).reshape(3, 7) * 3):
        jq = jit(lambda x, p, s: (JL._mla_q(x, p, jcfg, s),
                                  JL._mla_kv_latent(x, p, jcfg, s)))(
            jnp.asarray(x), jp, jnp.asarray(pos))
        tx, tpos = torch.from_numpy(x), torch.from_numpy(pos)
        tq = (*TL._mla_q(tx, tp, cfg, tpos),
              *TL._mla_kv_latent(tx, tp, cfg, tpos))
        for got, want in zip(tq, jax.tree.leaves(jq), strict=True):
            assert got.shape == want.shape
            np.testing.assert_allclose(_np(got), np.asarray(want),
                                       atol=LAYER_ATOL)


@pytest.mark.parametrize("branch", ["dense", "blocked"])
def test_mla_attend_matches_jax(attn, branch):
    """The score-matrix branch, and the blocked branch (q/k of nope + rope
    = 24 against V of 16) through ``blocked_attn_min`` lowered below the
    sequence; both branches agree."""
    jcfg, cfg, jp, tp = attn
    if branch == "blocked":
        jcfg = dataclasses.replace(jcfg, blocked_attn_min=8)
        cfg = dataclasses.replace(cfg, blocked_attn_min=8)
    x = _x((2, 12, cfg.d_model), 2)
    pos = np.arange(12)
    want = jit(lambda x, p: JL.mla_attend(x, p, jcfg, jnp.asarray(pos)))(
        jnp.asarray(x), jp)
    got = TL.mla_attend(torch.from_numpy(x), tp, cfg, torch.from_numpy(pos))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LAYER_ATOL)
    other = dataclasses.replace(
        cfg, blocked_attn_min=8 if branch == "dense" else 8192)
    np.testing.assert_allclose(
        _np(TL.mla_attend(torch.from_numpy(x), tp, other,
                          torch.from_numpy(pos))), _np(got), atol=LAYER_ATOL)


def test_gqa_blocked_takes_a_narrower_v_than_q_and_k():
    """``_gqa_blocked`` at blocks of 4 over 11 positions (a ragged tail)
    with q/k of 24 and V of 16, against the JAX helper; scaled by the q/k
    dim."""
    q, k = _x((2, 11, 4, 24), 3), _x((2, 11, 4, 24), 4)
    v = _x((2, 11, 4, 16), 5)
    pos = np.arange(11)
    want = JL._gqa_blocked(*map(jnp.asarray, (q, k, v, pos)), None, block=4)
    got = TL._gqa_blocked(*map(torch.from_numpy, (q, k, v, pos)), None,
                          block=4)
    assert got.shape == (2, 11, 4, 16)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LAYER_ATOL)


@pytest.mark.parametrize("per_slot", [False, True], ids=["scalar", "per_slot"])
def test_mla_fill_cache_and_decode_match_jax(attn, per_slot):
    """Prefill 9 positions into a 16-slot latent cache, then three decode
    steps: the batch at one depth (scalar pos), or rows at depths 9, 4 and
    1 (each row ropes its token and masks its cache at its own depth).
    Outputs and both cache leaves, written in place in the port."""
    jcfg, cfg, jp, tp = attn
    b, s, t = 3, 9, 16
    x = _x((b, s, cfg.d_model), 6)
    jout, jc = jit(lambda x, p: JL.mla_fill_cache(
        x, p, jcfg, jnp.arange(s), t))(jnp.asarray(x), jp)
    tout, tc = TL.mla_fill_cache(torch.from_numpy(x), tp, cfg,
                                 torch.arange(s), t)
    np.testing.assert_allclose(_np(tout), np.asarray(jout), atol=LAYER_ATOL)
    assert tc["ckv"].shape == (b, t, cfg.kv_lora_rank)
    assert tc["kpe"].shape == (b, t, cfg.qk_rope_head_dim)
    pos = np.asarray([s, 4, 1], np.int32) if per_slot else np.int32(s)
    step = jit(lambda x, p, c, pos: JL.mla_decode(x, p, jcfg, c, pos, t))
    for i in range(3):
        xi = _x((b, 1, cfg.d_model), 10 + i)
        jo, jc = step(jnp.asarray(xi), jp, jc, jnp.asarray(pos))
        cache = tc
        to, tc = TL.mla_decode(torch.from_numpy(xi), tp, cfg, tc,
                               torch.from_numpy(np.asarray(pos)), t)
        assert tc is cache  # written in place
        np.testing.assert_allclose(_np(to), np.asarray(jo), atol=LAYER_ATOL,
                                   err_msg=f"step {i}")
        for key in ("ckv", "kpe"):
            np.testing.assert_allclose(_np(tc[key]), np.asarray(jc[key]),
                                       atol=LAYER_ATOL)
        pos = pos + 1


def test_wkv_b_splits_k_then_v_on_its_last_dim(attn):
    """wkv_b [R, H, nope + vd]: the first nope entries make K, the last vd
    make V. With the V half zero, MLA's attention output is 0 in the full
    sequence and in decode; with the K half zero, the scores come from the
    rope halves alone, as in the JAX package."""
    jcfg, cfg, jp, tp = attn
    nope = cfg.qk_nope_head_dim
    x = _x((2, 6, cfg.d_model), 7)
    pos = torch.arange(6)
    no_v = dict(tp, wkv_b=tp["wkv_b"].clone())
    no_v["wkv_b"][..., nope:] = 0
    assert not TL.mla_attend(torch.from_numpy(x), no_v, cfg, pos).any()
    _, c = TL.mla_fill_cache(torch.from_numpy(x), no_v, cfg, pos, 8)
    out, _ = TL.mla_decode(torch.from_numpy(x[:, :1]), no_v, cfg, c,
                           torch.tensor(6), 8)
    assert not out.any()
    no_k = dict(tp, wkv_b=tp["wkv_b"].clone())
    no_k["wkv_b"][..., :nope] = 0
    jno_k = dict(jp, wkv_b=no_k["wkv_b"].numpy())
    got = TL.mla_attend(torch.from_numpy(x), no_k, cfg, pos)
    assert got.abs().max() > 0
    want = jit(lambda x, p: JL.mla_attend(x, p, jcfg, jnp.arange(6)))(
        jnp.asarray(x), jno_k)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LAYER_ATOL)


def test_bf16_rounds_softmax_weights_before_the_value_product(attn):
    """In bf16 the JAX MLA rounds the softmax weights to bf16 before the
    value (latent) product, in ``mla_attend`` and in ``mla_decode``. The
    port follows it bit for bit; weights kept in f32 through the latent
    sum give another output."""
    jcfg, cfg, jp, tp = attn
    jcfg = dataclasses.replace(jcfg, compute_dtype="bfloat16")
    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    bf = torch.bfloat16
    b, t, nope = 3, 24, cfg.qk_nope_head_dim
    x = torch.from_numpy(_x((b, 1, cfg.d_model), 8)).to(bf)
    cache = {"ckv": torch.from_numpy(_x((b, t, cfg.kv_lora_rank), 9,
                                        4.0)).to(bf),
             "kpe": torch.from_numpy(_x((b, t, cfg.qk_rope_head_dim), 10,
                                        4.0)).to(bf)}
    pos = torch.tensor([5, 17, 23], dtype=torch.int32)

    def jbf(t_):
        return jnp.asarray(t_.float().numpy()).astype(jnp.bfloat16)

    jo, _ = jit(lambda x, p, c, pos: JL.mla_decode(x, p, jcfg, c, pos, t))(
        jbf(x), jp, {k: jbf(v) for k, v in cache.items()},
        jnp.asarray(pos.numpy()))
    jo = np.asarray(jo.astype(jnp.float32))
    c = {k: v.clone() for k, v in cache.items()}
    got, _ = TL.mla_decode(x, tp, cfg, c, pos, t)
    np.testing.assert_array_equal(_np(got), jo)
    # the same chain with the weights kept in f32 through the latent sum
    q_nope, q_pe = TL._mla_q(x, tp, cfg, pos[:, None])
    wkv = tp["wkv_b"].to(bf)
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, wkv[..., :nope])
    scores = (torch.einsum("bshr,btr->bhst", q_lat.float(), c["ckv"].float())
              + torch.einsum("bshk,btk->bhst", q_pe.float(),
                             c["kpe"].float())) * TL._mla_scale(cfg)
    valid = torch.arange(t)[None] <= pos.long()[:, None]
    w = torch.softmax(torch.where(valid[:, None, None], scores, -1e30), -1)
    ctx = torch.einsum("bhst,btr->bshr", w, c["ckv"].float()).to(bf)
    f32_w = TL._out_proj(torch.einsum("bshr,rhv->bshv", ctx, wkv[..., nope:]),
                         tp["wo"])
    assert np.abs(_np(f32_w) - jo).max() > 0
    xs = torch.from_numpy(_x((2, 10, cfg.d_model), 11)).to(bf)
    want = jit(lambda x, p: JL.mla_attend(x, p, jcfg, jnp.arange(10)))(
        jbf(xs), jp)
    np.testing.assert_array_equal(
        _np(TL.mla_attend(xs, tp, cfg, torch.arange(10))),
        np.asarray(want.astype(jnp.float32)))


def test_ungated_top_k_matches_jax():
    """DeepSeek-V2 keeps the top-k router probabilities as they are
    (``route_norm=False``): the gates sum to less than 1, in the port's
    MoE FFN (with its shared expert) as in the JAX one."""
    jcfg, cfg = _cfgs()
    assert not cfg.route_norm and cfg.num_shared_experts == 1
    logits = _x((2, 9, cfg.num_experts), 12, 2.0)
    jg, ji, _ = JMoE._top_k_gates(jnp.asarray(logits), 2, False)
    tg, ti, _ = MoE._top_k_gates(torch.from_numpy(logits), 2, False)
    np.testing.assert_array_equal(_np(ti), np.asarray(ji))
    np.testing.assert_allclose(_np(tg), np.asarray(jg), atol=1e-6)
    assert float(tg.sum(-1).max()) < 1.0 - 1e-3
    tp = materialize(MoE.moe_specs(cfg), 5, torch.float32, "cpu")
    x = _x((2, 12, cfg.d_model), 13)
    jout, jaux = jit(lambda x, p: JMoE.moe_ffn(x, p, jcfg))(
        jnp.asarray(x), _to_numpy(tp))
    tout, taux = MoE.moe_ffn(torch.from_numpy(x), tp, cfg)
    np.testing.assert_allclose(_np(tout), np.asarray(jout), atol=LAYER_ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_forward_with_aux_and_loss_match_jax(model):
    jcfg, cfg, jp, tp = model
    toks = _tokens(cfg, 2, 12, seed=1)
    labels = _tokens(cfg, 2, 12, seed=2)
    labels[1, -3:] = -1
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    (jh, jaux), jloss = jit(lambda p, b: (
        JM.forward_hidden(p, jcfg, b["tokens"]),
        JM.loss_fn(jcfg)(p, b, None)))(jp, jb)
    th, taux = M.forward_hidden(tp, cfg, tb["tokens"])
    np.testing.assert_allclose(_np(th), np.asarray(jh), atol=ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    assert float(taux) > 0
    np.testing.assert_allclose(_np(M.loss_fn(cfg)(tp, tb)), np.asarray(jloss),
                               rtol=LOSS_RTOL)


def test_prefill_then_decode_match_full_forward_and_jax(model):
    """Prefill 16 tokens into a 24-slot latent cache, then decode 8 at
    per-row depths: logits against the full forward and the JAX steps. At
    capacity factor 8 (the JAX package's ``test_decode_consistency_fp32``)
    no group drops a token, so prefill, decode and the full forward route
    alike."""
    jcfg, cfg, jp, tp = model
    jcfg, cfg = (dataclasses.replace(c, capacity_factor=8.0)
                 for c in (jcfg, cfg))
    b, s, s0 = 2, 24, 16
    toks = _tokens(cfg, b, s, seed=4)
    th, _ = M.forward_hidden(tp, cfg, torch.from_numpy(toks))
    full = _np(M.unembed(tp, cfg, th))
    jl, jc = jit(lambda p, t: JM.prefill(p, jcfg, t, s))(
        jp, jnp.asarray(toks[:, :s0]))
    tl, tc = M.prefill(tp, cfg, torch.from_numpy(toks[:, :s0]), s)
    assert set(tc) == set(jc) == {"dense_blocks", "blocks"}
    assert set(tc["blocks"]) == {"ckv", "kpe"}
    np.testing.assert_allclose(_np(tl), full[:, s0 - 1], atol=ATOL)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL)
    jdec = jit(lambda p, c, t, pos: JM.decode_step(p, jcfg, c, t, pos))
    for t in range(s0, s):
        pos = np.full((b,), t, np.int32)
        jl, jc = jdec(jp, jc, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(pos))
        tl, tc = M.decode_step(tp, cfg, tc, torch.from_numpy(toks[:, t:t + 1]),
                               torch.from_numpy(pos))
        np.testing.assert_allclose(_np(tl), full[:, t], atol=ATOL,
                                   err_msg=f"position {t}")
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL,
                                   err_msg=f"position {t}")
    for key in tc:
        for leaf in tc[key]:
            np.testing.assert_allclose(_np(tc[key][leaf]),
                                       np.asarray(jc[key][leaf]), atol=ATOL)


def _obftf_step_matches_jax(jcfg, cfg, jp, tp, ledger=True):
    """Selection forward, obftf with a noisy target, backward on the kept
    rows, AdamW, then (with ``ledger``) the fresh losses into each
    package's device ledger: per-example losses, kept rows, grad norm, the
    step's grads (AdamW's first moment, 0.1 g), params and ledgers ->
    the port's step's first moment."""
    n, s = 8, 12
    toks = _tokens(cfg, n, s, seed=5)
    labels = _tokens(cfg, n, s, seed=6)
    labels[2, -4:] = -1
    batch = {"tokens": toks, "labels": labels}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jopt = JO.adamw(JO.constant(LR), JO.AdamWConfig(weight_decay=0.1))
    topt = O.adamw(O.constant(LR), O.AdamWConfig(weight_decay=0.1))
    jsel = JOB.SelectionConfig(method="obftf", ratio=0.25)
    jstep = jit(JOB.make_train_step(JM.loss_fn(jcfg), jopt,
                                    JOB.OBFTFConfig(selection=jsel)))
    tstep = OB.make_train_step(M.loss_fn(cfg), topt, OB.OBFTFConfig(
        selection=SelectionConfig(method="obftf", ratio=0.25)))
    jparams = jax.tree.map(jnp.asarray, jp)
    rng = jax.random.key(7)
    jnew, jm = jstep({"params": jparams, "opt": jopt.init(jparams),
                      "step": jnp.zeros((), jnp.int32)}, jb, rng)
    tnew, tm = tstep({"params": tp, "opt": topt.init(tp),
                      "step": torch.zeros((), dtype=torch.int32)}, tb,
                     JaxDraws(jax.random.split(rng, 3)[1]))
    np.testing.assert_allclose(_np(tm["per_example_loss"]),
                               np.asarray(jm["per_example_loss"]),
                               rtol=LOSS_RTOL)
    for k in ("kept", "step_cost"):
        assert float(tm[k]) == float(jm[k]), k
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    tm1, jm1 = tnew["opt"]["m"], jnew["opt"]["m"]
    for t, j in zip(tree_leaves(tm1), jax.tree.leaves(jm1)):
        assert t.shape == j.shape
        np.testing.assert_allclose(_np(t), np.asarray(j), rtol=1e-4,
                                   atol=1e-7)
    # AdamW's first update is lr * g / (|g| + eps): where the step's own
    # (clipped) grad, m / (1 - b1), is below 1e-6 it turns f32 noise in g
    # into a visible change, so those entries are held to 2 lr
    for t, j, m in zip(tree_leaves(tnew["params"]),
                       jax.tree.leaves(jnew["params"]),
                       jax.tree.leaves(jm1)):
        big = np.abs(np.asarray(m)) / 0.1 >= 1e-6
        diff = np.abs(_np(t) - np.asarray(j))
        assert diff[big].max(initial=0.0) <= PARAM_ATOL
        assert diff[~big].max(initial=0.0) <= 2 * LR
    if not ledger:
        return tm1
    ids = np.arange(100, 100 + n, dtype=np.int32)
    jlcfg = JHistoryConfig(capacity=1 << 8)
    jl = jit(functools.partial(jled.record, jlcfg))(
        jled.init_state(jlcfg), jnp.asarray(ids), jm["per_example_loss"], 1,
        valid=jm["per_example_fresh"])
    tl, _ = tled.record_priority(
        HistoryConfig(capacity=1 << 8),
        tled.init_state(HistoryConfig(capacity=1 << 8), "cpu"),
        torch.from_numpy(ids), tm["per_example_loss"], 1,
        valid=tm["per_example_fresh"])
    assert_ledger_states_close(tled.state_dict_of(tl), jled.state_dict_of(jl),
                               rtol=LOSS_RTOL)
    return tm1


def test_obftf_train_step_matches_jax(model):
    m1 = _obftf_step_matches_jax(*model)
    assert float(m1["blocks"]["attn"]["wkv_b"].abs().max()) > 0
    assert float(m1["blocks"]["moe"]["router"].abs().max()) > 0


def test_one_layer_cut_runs_an_empty_moe_stack():
    """``configs.get(arch, layers=1)`` keeps the ``first_k_dense`` layer
    and leaves a MoE stack of depth 0, as the card's train runs do: params,
    one OBFTF step with AdamW (the forward's losses; the empty leaves get
    empty grads and stay empty), the cache, prefill and decode, all against
    JAX."""
    one = configs.get(ARCH, smoke=True, layers=1)
    assert one.num_layers == one.first_k_dense == 1
    jcfg, cfg, jp, tp = _model(num_layers=1)
    assert tp["blocks"]["moe"]["w1"].shape[0] == 0
    assert tp["dense_blocks"]["attn"]["wkv_b"].shape[0] == 1
    toks = _tokens(cfg, 2, 10, seed=8)
    _, taux = M.forward_hidden(tp, cfg, torch.from_numpy(toks))
    assert float(taux) == 0.0
    MoE.reset_routing_counts()
    m1 = _obftf_step_matches_jax(jcfg, cfg, jp, tp, ledger=False)
    assert m1["blocks"]["moe"]["w1"].shape[0] == 0
    assert MoE.dropped_share() is None  # nothing was routed
    cache = M.init_cache(cfg, 2, 12, "cpu")
    assert cache["blocks"]["ckv"].shape == (0, 2, 12, cfg.kv_lora_rank)
    jl, jc = jit(lambda p, t: JM.prefill(p, jcfg, t, 12))(
        jp, jnp.asarray(toks))
    tl, tc = M.prefill(tp, cfg, torch.from_numpy(toks), 12)
    assert tc["blocks"]["ckv"].shape == cache["blocks"]["ckv"].shape
    nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
    jl, _ = jit(lambda p, c, t: JM.decode_step(p, jcfg, c, t, jnp.int32(10)))(
        jp, jc, jnp.asarray(nxt))
    tl, _ = M.decode_step(tp, cfg, tc, torch.from_numpy(nxt), torch.tensor(10))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL)


def test_routing_count_is_equal_with_and_without_remat():
    """The dropped-token share's count: a forward and backward of the
    mixtral smoke config counts each MoE layer's choices once, with
    per-layer checkpointing (whose backward runs each layer again) as
    without it."""
    cfg = dataclasses.replace(configs.get_smoke("mixtral-8x22b"),
                              param_dtype="float32", compute_dtype="float32",
                              capacity_factor=0.5)
    tp = materialize(M.param_specs(cfg), 0, torch.float32, "cpu")
    toks = torch.from_numpy(_tokens(cfg, 4, 16, seed=9))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    counts = []
    for remat in (False, True):
        MoE.reset_routing_counts()
        OB.loss_and_grads(M.loss_fn(dataclasses.replace(cfg, remat=remat)),
                          tp, batch)
        counts.append((MoE.ROUTED["choices"], int(MoE.ROUTED["kept"]),
                       MoE.dropped_share()))
    assert counts[0] == counts[1]
    layers, k = cfg.num_layers, cfg.experts_per_token
    assert counts[0][0] == layers * 4 * 16 * k
    assert 0.0 < counts[0][2] < 1.0  # capacity 0.5 drops some


# ---------------------------------------------------------------------------
# serving: the engine and both CLIs
# ---------------------------------------------------------------------------

LEDGER = dict(capacity=1 << 12, decay=0.8)
SLOTS, MAX_PROMPT, MAX_GEN, TOPK = 3, 12, 6, 16


def test_engine_matches_jax_engine(model):
    """Exact-length prompts of 12 and 7 tokens into the latent cache, 6 new
    tokens, greedy: equal tokens, ledgers and stats."""
    jcfg, cfg, jp, tp = model
    rs = np.random.default_rng(8)
    reqs = [(rs.integers(0, 256, n).astype(np.int32),
             rs.integers(0, 256, MAX_GEN).astype(np.int32), 100 + i)
            for i, n in enumerate((12, 7, 12, 7))]
    jrec = JRecorder(SLOTS, MAX_GEN, jcfg.vocab_size,
                     JHistoryConfig(**LEDGER), ledger="device",
                     retention="topk", topk=TOPK)
    je = JEngine(jcfg, jax.tree.map(jnp.asarray, jp), jrec, slots=SLOTS,
                 max_prompt=MAX_PROMPT, max_gen=MAX_GEN)
    trec = OutcomeRecorder(SLOTS, MAX_GEN, cfg.vocab_size,
                           HistoryConfig(**LEDGER), ledger="device",
                           retention="topk", topk=TOPK, device="cpu")
    te = Engine(cfg, tp, trec, slots=SLOTS, max_prompt=MAX_PROMPT,
                max_gen=MAX_GEN)
    assert te.prompt_buckets is None  # moe: exact-length prefill
    assert set(te._estate.cache["blocks"]) == {"ckv", "kpe"}
    for eng in (je, te):
        for prompt, labels, iid in reqs:
            eng.submit(prompt, max_new=MAX_GEN, labels=labels,
                       instance_id=iid)
        eng.run(max_steps=200)
    assert set(je.finished) == set(te.finished) == {r[2] for r in reqs}
    for i in je.finished:
        np.testing.assert_array_equal(te.finished[i], je.finished[i],
                                      err_msg=f"instance {i}")
    assert_ledger_states_close(te.ledger_state_dict(), je.ledger_state_dict(),
                               rtol=DERIVED_RTOL)
    js, ts = je.stats(), te.stats()
    for key in ts:
        assert ts[key] == js[key], key


def test_serve_and_train_clis_run_the_arch(tmp_path, capsys):
    out = tmp_path / "serve.json"
    assert serve.main([
        "--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
        "--prompt-len", "10", "--gen", "4", "--requests", "3",
        "--retain", "topk", "--topk", "8", "--ledger", "device",
        "--json-out", str(out)]) == 0
    assert "served 3 requests" in capsys.readouterr().out
    s = json.loads(out.read_text())
    assert s["evicted"] == 3 and s["layers"] == 3 and s["recorded"] == 12
    for layers, extra, cost in ((0, ["--recycle", "--ledger", "device",
                                     "--instance-pool", "16"], 0.75),
                                (1, [], 1.75)):
        out = tmp_path / f"train{layers}.json"
        assert train.main([
            "--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
            "--global-batch", "8", "--seq-len", "8", "--layers", str(layers),
            *extra, "--json-out", str(out)]) == 0
        s = json.loads(out.read_text())
        assert s["mean_step_cost"] == pytest.approx(cost)
        assert np.isfinite([s["loss_first"], s["loss_last"]]).all()
        if layers == 1:  # the dense layer alone: nothing routed
            assert s["moe_dropped_share"] is None and s["layers"] == 1
        else:
            assert 0.0 <= s["moe_dropped_share"] < 1.0
