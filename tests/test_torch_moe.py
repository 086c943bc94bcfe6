"""The port's MoE family against the JAX package's: ``models/moe.py``
function by function, the moe branches of ``models/model.py`` on
mixtral-8x22b's smoke config (and a ``first_k_dense`` variant with a
shared expert), one OBFTF train step and the serving engine. Float32,
inputs from numpy seeds, weights the port's seeded draw carried to JAX as
numpy (``from_jax`` for the JAX package's own trees).

Tolerances: routing indices, capacities and dispatch tensors exact; gates
and router probs atol 1e-6 (a softmax over f32 logits in another order);
``moe_ffn`` atol 1e-5 and its aux loss rtol 1e-5; model logits and hidden
states atol 1e-4 (``tests/test_models_smoke.py``'s bound); per-example
losses rtol 1e-5, grads rtol 1e-4 + atol 1e-6, grad norm rtol 1e-4,
params after AdamW atol 1e-6 (2 lr where a grad is below 1e-6: see the
train step's test) and ledgers through ``assert_ledger_states_close`` (those of
``tests/test_torch_train.py`` and ``tests/test_torch_ssm.py``).
"""

import dataclasses
import functools

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
from repro_torch.models import model as M
from repro_torch.models import moe as MoE
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import (from_jax, is_spec, materialize,
                                       tree_leaves)
from repro_torch.serving import Engine, OutcomeRecorder

torch.set_num_threads(1)
# the JAX side's programs compile without LLVM's optimizations (as in
# tests/test_torch_archs.py): reference values move by a few f32 units
jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0})

GATE_ATOL = 1e-6
FFN_ATOL = 1e-5
AUX_RTOL = 1e-5
ATOL = 1e-4
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-6
LR = 1e-3
ARCH = "mixtral-8x22b"


def _cfgs(**kw):
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH),
                               param_dtype="float32",
                               compute_dtype="float32", **kw)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _np(t):
    return t.detach().numpy()


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# models/moe.py, function by function
# ---------------------------------------------------------------------------


def test_config_equals_jax():
    for get, jget in ((configs.get, jconfigs.get),
                      (configs.get_smoke, jconfigs.get_smoke)):
        assert dataclasses.asdict(get(ARCH)) == dataclasses.asdict(jget(ARCH))


def _spec_items(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_items(tree[k],
                                                             path + (k,))]
    return [(path, tuple(tree.shape), tree.init, tree.scale)]


@pytest.mark.parametrize("shared", [0, 2], ids=["routed", "shared"])
def test_moe_specs_match_jax(shared):
    jcfg, cfg = _cfgs(num_shared_experts=shared)
    want = _spec_items(JMoE.moe_specs(jcfg))
    got = _spec_items(MoE.moe_specs(cfg))
    assert got == want
    assert len(got) == (7 if shared else 4)
    assert all(is_spec(s) for s in tree_leaves(MoE.moe_specs(cfg)))


def test_capacity_matches_jax_over_a_grid():
    jcfg, cfg = _cfgs()
    for e, ks in ((4, (1, 2)), (8, (1, 2)), (160, (1, 6))):
        for k in ks:
            for cf in (0.5, 1.25, 1.5, 2.0, 8.0):
                jc = dataclasses.replace(jcfg, num_experts=e,
                                         experts_per_token=k,
                                         capacity_factor=cf)
                tc = dataclasses.replace(cfg, num_experts=e,
                                         experts_per_token=k,
                                         capacity_factor=cf)
                for tokens in (1, 3, 12, 100, 128, 4160):
                    c = MoE.capacity(tc, tokens)
                    assert c == JMoE.capacity(jc, tokens), (e, k, cf, tokens)
                    assert c >= 4 and c % 4 == 0
    full = configs.get(ARCH)
    # a decode row is its own group; a 4,160-token prompt one group
    assert MoE.capacity(full, 1) == 4 and MoE.capacity(full, 4160) == 2080


@pytest.mark.parametrize("norm", [True, False], ids=["route_norm", "raw"])
def test_top_k_gates_and_load_balance_loss_match_jax(norm):
    logits = _x((3, 7, 8), 1) * 2
    jg, ji, jp = jit(JMoE._top_k_gates, static_argnums=(1, 2))(
        jnp.asarray(logits), 2, norm)
    tg, ti, tp = MoE._top_k_gates(torch.from_numpy(logits), 2, norm)
    np.testing.assert_array_equal(_np(ti), np.asarray(ji))
    np.testing.assert_allclose(_np(tg), np.asarray(jg), atol=GATE_ATOL)
    np.testing.assert_allclose(_np(tp), np.asarray(jp), atol=GATE_ATOL)
    if norm:
        np.testing.assert_allclose(_np(tg.sum(-1)), 1.0, atol=GATE_ATOL)
    np.testing.assert_allclose(
        float(MoE.load_balance_loss(tp, ti, 8)),
        float(jit(JMoE.load_balance_loss, static_argnums=2)(jp, ji, 8)),
        rtol=AUX_RTOL)


def test_router_ties_go_to_the_lowest_expert():
    """A zero router gives every expert the same probability: experts
    0..k-1 win, as ``jax.lax.top_k`` picks them; a partial tie keeps its
    lowest experts too."""
    for k in (1, 2, 3):
        flat = np.zeros((2, 5, 4), np.float32)
        _, ti, _ = MoE._top_k_gates(torch.from_numpy(flat), k, True)
        _, ji, _ = JMoE._top_k_gates(jnp.asarray(flat), k, True)
        np.testing.assert_array_equal(_np(ti), np.asarray(ji))
        assert (_np(ti) == np.arange(k)).all()
    part = np.asarray([[[1.0, 3.0, 0.0, 3.0, 3.0, -1.0]]], np.float32)
    _, ti, _ = MoE._top_k_gates(torch.from_numpy(part), 2, False)
    _, ji, _ = JMoE._top_k_gates(jnp.asarray(part), 2, False)
    assert _np(ti).tolist() == np.asarray(ji).tolist() == [[[1, 3]]]
    # a zero router in the whole FFN: every token goes to experts 0..k-1,
    # each at gate 1/k (capacity 8 a group of 6 tokens drops none)
    _, cfg = _cfgs()
    p = materialize(MoE.moe_specs(cfg), 2, torch.float32, "cpu")
    p["router"].zero_()
    x = torch.from_numpy(_x((2, 6, cfg.d_model), 3))
    out, _ = MoE.moe_ffn(x, p, cfg)
    k = cfg.experts_per_token
    want = sum(torch.nn.functional.silu(x @ p["w1"][e]) * (x @ p["w3"][e])
               @ p["w2"][e] for e in range(k)) / k
    np.testing.assert_allclose(_np(out), _np(want), atol=FFN_ATOL)


def test_dispatch_combine_exact_and_earlier_tokens_win():
    g, s, e, k, c = 2, 12, 4, 2, 4
    rs = np.random.default_rng(4)
    idx = np.stack([np.stack([rs.permutation(e)[:k] for _ in range(s)])
                    for _ in range(g)]).astype(np.int32)
    idx[0, :, 0] = 0  # every token of group 0 picks expert 0 first
    idx[0, :, 1] = 1 + np.arange(s) % 3
    gates = rs.uniform(0.1, 1.0, (g, s, k)).astype(np.float32)
    jd, jc = jit(JMoE._dispatch_combine, static_argnums=(2, 3))(
        jnp.asarray(idx), jnp.asarray(gates), e, c)
    td, tc = MoE._dispatch_combine(torch.from_numpy(idx).long(),
                                   torch.from_numpy(gates), e, c)
    np.testing.assert_array_equal(_np(td), np.asarray(jd))
    np.testing.assert_array_equal(_np(tc), np.asarray(jc))
    # expert 0's four slots went to tokens 0-3, in order; the rest dropped
    assert (_np(td[0, :4, 0]) == np.eye(4, dtype=bool)).all()
    assert not td[0, 4:, 0].any()
    assert int(td.sum()) < g * s * k
    # a slot holds at most one token, a token at most one slot per expert
    assert int(td.sum(dim=1).max()) == 1 and int(td.sum(dim=3).max()) == 1


MOE_CASES = {
    "mixtral": {},
    "drops": dict(capacity_factor=0.5),
    "groups": dict(moe_group=4),
    "shared": dict(num_shared_experts=1, route_norm=False),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_ffn_matches_jax(case):
    jcfg, cfg = _cfgs(**MOE_CASES[case])
    tp = materialize(MoE.moe_specs(cfg), 5, torch.float32, "cpu")
    jp = _to_numpy(tp)
    x = _x((2, 12, cfg.d_model), 6)
    jout, jaux = jit(lambda x, p: JMoE.moe_ffn(x, p, jcfg))(jnp.asarray(x), jp)
    MoE.reset_routing_counts()
    tout, taux = MoE.moe_ffn(torch.from_numpy(x), tp, cfg)
    np.testing.assert_allclose(_np(tout), np.asarray(jout), atol=FFN_ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=AUX_RTOL)
    assert MoE.ROUTED["choices"] == 2 * 12 * cfg.experts_per_token
    dropped = MoE.dropped_share()
    if case == "drops":  # 16 slots (4 experts x 4) for 24 choices a group
        assert dropped > 0.3
    else:  # cf 2.0 with k = 2 of 4 experts: capacity is the group's length
        assert dropped == 0


def test_routing_stats_match_jax():
    logits = _x((2, 9, 8), 7) * 3
    got = MoE.routing_stats(torch.from_numpy(logits), 2)
    want = jit(JMoE.routing_stats, static_argnums=1)(jnp.asarray(logits), 2)
    assert set(got) == set(want) == {"router_entropy", "router_top1"}
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-6, err_msg=key)


# ---------------------------------------------------------------------------
# the model: mixtral's smoke config and a first_k_dense + shared variant
# ---------------------------------------------------------------------------

VARIANTS = {
    "mixtral": {},
    "first_dense_shared": dict(num_layers=3, first_k_dense=1, d_ff=96,
                               num_shared_experts=1, route_norm=False),
}


def _model(name):
    """(name, JAX config, port config, JAX weights (numpy), port weights)."""
    jcfg, cfg = _cfgs(**VARIANTS[name])
    jp = _to_numpy(materialize(M.param_specs(cfg), 0, torch.float32, "cpu"))
    return name, jcfg, cfg, jp, from_jax(jp, "cpu")


@pytest.fixture(scope="module", params=list(VARIANTS))
def model(request):
    return _model(request.param)


@pytest.fixture(scope="module")
def mixtral():
    return _model("mixtral")


def _to_numpy(tree):
    """Numpy leaves, keys sorted as ``jax.tree.leaves`` orders them."""
    if isinstance(tree, dict):
        return {k: _to_numpy(tree[k]) for k in sorted(tree)}
    return tree.numpy()


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_param_tree_and_forward_with_aux_match_jax(model):
    name, jcfg, cfg, jp, tp = model
    jshapes = jax.tree.map(lambda s: s.shape, JM.param_specs(jcfg),
                           is_leaf=lambda s: hasattr(s, "axes"))
    assert jax.tree.map(np.shape, jp) == jshapes
    if name == "first_dense_shared":
        assert tp["dense_blocks"]["mlp"]["w1"].shape == (1, 64, 96)
        assert tp["blocks"]["moe"]["shared"]["w1"].shape == (2, 64, 64)
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
    np.testing.assert_allclose(float(taux), float(jaux), rtol=AUX_RTOL)
    assert float(taux) > 0  # E * sum frac * mean prob: 1 when balanced
    np.testing.assert_allclose(_np(M.loss_fn(cfg)(tp, tb)), np.asarray(jloss),
                               rtol=LOSS_RTOL)
    ce, aux = M.per_example_loss(tp, cfg, tb)
    np.testing.assert_allclose(
        _np(M.loss_fn(cfg)(tp, tb)),
        _np(ce + cfg.router_aux_coef * aux), rtol=1e-7)
    _, _, saux = M.per_example_signals(tp, cfg, tb)
    assert torch.equal(saux, taux)


def test_remat_keeps_the_aux_gradient(model):
    """Under per-layer checkpointing the aux loss still reaches the
    router: the gradients of loss_fn with and without remat agree."""
    _, _, cfg, _, tp = model
    toks = torch.from_numpy(_tokens(cfg, 2, 8, seed=3))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    grads = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        _, g = OB.loss_and_grads(M.loss_fn(c), tp, batch)
        grads.append(g)
    router = [g["blocks"]["moe"]["router"] for g in grads]
    assert router[0].abs().max() > 0
    for a, b in zip(tree_leaves(grads[0]), tree_leaves(grads[1])):
        np.testing.assert_allclose(_np(b), _np(a), rtol=1e-5, atol=1e-7)
    # the aux term alone moves the router's gradient
    c0 = dataclasses.replace(cfg, router_aux_coef=0.0, remat=True)
    _, g0 = OB.loss_and_grads(M.loss_fn(c0), tp, batch)
    assert not torch.allclose(g0["blocks"]["moe"]["router"], router[1])


def test_prefill_then_decode_match_full_forward_and_jax(model):
    """Prefill 16 tokens, then decode 8 past the 16-token window (the
    rolling cache wraps): logits against the full forward, as
    ``tests/test_models_smoke.py::test_decode_consistency_fp32`` holds
    the JAX model, and against the JAX prefill and decode step by step.
    At cf 2.0, k = 2 of 4 experts no group drops a token, so the groups of
    prefill (the prompt), decode (a row) and the full forward agree."""
    _, jcfg, cfg, jp, tp = model
    b, s, s0 = 2, 24, 16
    toks = _tokens(cfg, b, s, seed=4)
    th, _ = M.forward_hidden(tp, cfg, torch.from_numpy(toks))
    full = _np(M.unembed(tp, cfg, th))
    jl, jc = jit(lambda p, t: JM.prefill(p, jcfg, t, s))(
        jp, jnp.asarray(toks[:, :s0]))
    tl, tc = M.prefill(tp, cfg, torch.from_numpy(toks[:, :s0]), s)
    assert set(tc) == set(jc)
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


def test_paging_refuses_the_family():
    """MoE capacity and rolling windows keep the dense per-slot cache, as
    in the JAX package (``init_paged_cache``)."""
    cfg = configs.get_smoke(ARCH)
    with pytest.raises(NotImplementedError, match="family"):
        M.init_paged_cache(cfg, 4, 4, "cpu")
    with pytest.raises(NotImplementedError, match="family"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--page-size", "4", "--batch", "2", "--prompt-len", "8",
                    "--gen", "2"])


# ---------------------------------------------------------------------------
# one OBFTF train step, with AdamW and the ledger write
# ---------------------------------------------------------------------------


def test_obftf_train_step_matches_jax(mixtral):
    """Selection forward, obftf with a noisy target, backward on the kept
    rows, AdamW, then the fresh losses into the device ledger: per-example
    losses (CE plus ``router_aux_coef`` x aux) and kept rows, the kept
    rows' grads, the params after AdamW and the ledgers."""
    _, jcfg, cfg, jp, tp = mixtral
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
    # the kept rows' grads, each package's own backward
    sel = _np(tm["selected"])
    sub = {k: v[sel] for k, v in batch.items()}
    jg = jit(jax.grad(lambda p, b: jnp.mean(JM.loss_fn(jcfg)(p, b, None))))(
        jparams, {k: jnp.asarray(v) for k, v in sub.items()})
    _, tg = OB.loss_and_grads(M.loss_fn(cfg), tp,
                              {k: torch.from_numpy(v) for k, v in sub.items()})
    for t, j in zip(tree_leaves(tg), jax.tree.leaves(jg)):
        np.testing.assert_allclose(_np(t), np.asarray(j), rtol=1e-4,
                                   atol=1e-6)
    assert float(tg["blocks"]["moe"]["router"].abs().max()) > 0
    # AdamW's first update is lr * g / (|g| + eps): where |g| is below
    # 1e-6 it turns f32 noise in g into a visible change (lr / eps = 1e5),
    # so those entries are held to the update's own size, 2 lr
    for t, j, g in zip(tree_leaves(tnew["params"]),
                       jax.tree.leaves(jnew["params"]), jax.tree.leaves(jg)):
        big = np.abs(np.asarray(g)) >= 1e-6
        diff = np.abs(_np(t) - np.asarray(j))
        assert diff[big].max(initial=0.0) <= PARAM_ATOL
        assert diff[~big].max(initial=0.0) <= 2 * LR
    # the fresh losses (aux included) into each package's device ledger
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


# ---------------------------------------------------------------------------
# serving: the engine and both CLIs
# ---------------------------------------------------------------------------

LEDGER = dict(capacity=1 << 12, decay=0.8)
SLOTS, MAX_PROMPT, MAX_GEN, TOPK = 3, 12, 8, 16


def test_engine_matches_jax_engine(mixtral):
    """Exact-length prompts of 12 and 9 tokens and 8 new ones, so every
    request's rolling 16-slot cache wraps; greedy: equal tokens, ledgers
    and stats."""
    _, jcfg, cfg, jp, tp = mixtral
    rs = np.random.default_rng(8)
    reqs = [(rs.integers(0, 256, n).astype(np.int32),
             rs.integers(0, 256, MAX_GEN).astype(np.int32), 100 + i)
            for i, n in enumerate((12, 9, 12, 9, 12))]
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
    assert je.prompt_buckets is None and te.prompt_buckets is None
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


def test_serve_and_train_clis_run_the_family(tmp_path, capsys):
    import json

    out = tmp_path / "serve.json"
    assert serve.main([
        "--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
        "--prompt-len", "10", "--gen", "8", "--requests", "3",
        "--retain", "topk", "--topk", "8", "--ledger", "device",
        "--layers", "1", "--json-out", str(out)]) == 0
    assert "served 3 requests" in capsys.readouterr().out
    s = json.loads(out.read_text())
    assert s["evicted"] == 3 and s["layers"] == 1 and s["recorded"] == 24
    out = tmp_path / "train.json"
    assert train.main([
        "--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "3",
        "--global-batch", "8", "--seq-len", "8", "--recycle",
        "--ledger", "device", "--instance-pool", "16",
        "--json-out", str(out)]) == 0
    s = json.loads(out.read_text())
    assert s["mean_step_cost"] == pytest.approx(0.75)
    assert np.isfinite([s["loss_first"], s["loss_last"]]).all()
    assert 0.0 <= s["moe_dropped_share"] < 1.0
