"""deepseek-7b (MHA), qwen3-14b (qk-norm, GQA), granite-34b (MQA, the
GELU MLP) and the prefix-embedding families, pixtral-12b (vlm) and
musicgen-medium (audio, MHA with heads of 16 in its smoke config), in the
port against the JAX package, on their smoke configs in float32 with the
same weights (the port's seeded draw, carried to JAX as numpy and back by
``from_jax``). The prefix archs also run with a prefix of frame or patch
embeddings (numpy draws): the forward, the loss over the token positions
only, the signals, and prefill with ``last_pos`` counting the prefix, then
decode, through the dense cache and a page pool.

Tolerances are those of ``tests/test_torch_model.py`` and
``tests/test_torch_train.py`` for llama3-8b: logits atol 1e-4, per-example
losses rtol 1e-5, updated params atol 1e-6 after an SGD-momentum step (its
update is linear in the grads), grad norms rtol 1e-4; selected rows, kept
and step cost exact. The GELU MLP holds ``jax.nn.gelu``'s tanh form to
1e-6 where it and the erf form differ most. Both CLIs run each arch on the
CPU: serve with the paged and the dense cache, train with the host and the
device ledger.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_cases import JaxDraws
from repro import configs as jconfigs
from repro import optim as JO
from repro.core import obftf as JOB
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch import configs
from repro_torch import optim as O
from repro_torch.core import obftf as OB
from repro_torch.core.selection import SelectionConfig
from repro_torch.launch import serve, train
from repro_torch.models import layers as TL
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import from_jax, materialize, tree_leaves

torch.set_num_threads(1)
# the JAX side's programs compile without LLVM's optimizations: the
# reference values move by a few f32 units at most, compiles run faster
jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0})

ARCHS = ["deepseek-7b", "qwen3-14b", "granite-34b", "pixtral-12b",
         "musicgen-medium"]
PREFIX_ARCHS = ["pixtral-12b", "musicgen-medium"]
ATOL = 1e-4
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-6


@functools.lru_cache(maxsize=None)
def _arch(name):
    """(name, JAX config, port config, JAX weights, port weights)."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(name),
                               param_dtype="float32", compute_dtype="float32")
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    # the port's seeded weights as a JAX tree (keys sorted, as
    # jax.tree.leaves orders them) and the port's tree of it
    jp = jax.tree.map(lambda x: x.numpy(), materialize(
        M.param_specs(cfg), 0, torch.float32, "cpu"))
    return name, jcfg, cfg, jp, from_jax(jp, "cpu")


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    return _arch(request.param)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_configs_equal_jax():
    for name in ARCHS:
        for get, jget in ((configs.get, jconfigs.get),
                          (configs.get_smoke, jconfigs.get_smoke)):
            assert dataclasses.asdict(get(name)) == dataclasses.asdict(
                jget(name)), name


def test_forward_and_per_example_loss_match_jax(arch):
    name, jcfg, cfg, jp, tp = arch
    toks = _tokens(cfg, 2, 12, seed=1)
    labels = _tokens(cfg, 2, 12, seed=2)
    labels[1, -3:] = -1
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    jlogits, jloss = jit(lambda p, b: (
        JM.unembed(p, jcfg, JM.forward_hidden(p, jcfg, b["tokens"])[0]),
        JM.per_example_loss(p, jcfg, b)[0]))(jp, jb)
    tlogits = M.unembed(tp, cfg, M.forward_hidden(tp, cfg, tb["tokens"])[0])
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=ATOL)
    np.testing.assert_allclose(M.per_example_loss(tp, cfg, tb)[0].numpy(),
                               np.asarray(jloss), rtol=LOSS_RTOL)
    # what makes the arch: its heads, its qk-norm, its MLP
    blk = tp["blocks"]
    assert blk["attn"]["wk"].shape[2] == cfg.num_kv_heads
    assert ("q_norm" in blk["attn"]) == (name == "qwen3-14b")
    assert ("w3" in blk["mlp"]) == (name != "granite-34b")


def _paged_from_dense(cache, b, npg, page, perm):
    """The prefilled dense K/V [L, B, T, kv, hd] laid into a shuffled page
    pool [L, P, page, kv, hd] (numpy), and its page table [B, NP]."""
    k, v = (np.asarray(cache["blocks"][n]) for n in ("k", "v"))
    pool = len(perm)
    kp = np.zeros((k.shape[0], pool, page, *k.shape[3:]), k.dtype)
    vp = np.zeros_like(kp)
    table = perm[:b * npg].reshape(b, npg).astype(np.int32)
    for i in range(b):
        for blk in range(npg):
            sl = slice(blk * page, (blk + 1) * page)
            kp[:, table[i, blk]] = k[:, i, sl]
            vp[:, table[i, blk]] = v[:, i, sl]
    return {"blocks": {"kp": kp, "vp": vp}}, table


def test_prefill_and_decode_dense_and_paged_match_jax(arch):
    """Right-padded prompts, then three decode steps at per-row depths,
    through the dense cache and through a shuffled page pool."""
    _, jcfg, cfg, jp, tp = arch
    b, plen, page, npg = 3, 9, 4, 4
    toks = _tokens(cfg, b, plen, seed=3)
    last = np.asarray([8, 5, 2], np.int32)
    jl, jc = jit(lambda p, t, lp: JM.prefill(p, jcfg, t, npg * page,
                                                 last_pos=lp))(
        jp, jnp.asarray(toks), jnp.asarray(last))
    tl, tc = M.prefill(tp, cfg, torch.from_numpy(toks), npg * page,
                       last_pos=torch.from_numpy(last))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    perm = np.random.default_rng(4).permutation(b * npg + 2)
    jpool, table = _paged_from_dense(jc, b, npg, page, perm)
    tpool = from_jax(jpool, "cpu")
    jpool = jax.tree.map(jnp.asarray, jpool)
    jdec = jit(lambda p, c, t, pos: JM.decode_step(p, jcfg, c, t, pos))
    jpaged = jit(lambda p, c, t, pos, pt: JM.decode_step(
        p, jcfg, c, t, pos, page_table=pt))
    pos = last + 1
    nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
    for step in range(3):
        jl, jc = jdec(jp, jc, jnp.asarray(nxt), jnp.asarray(pos))
        jlp, jpool = jpaged(jp, jpool, jnp.asarray(nxt), jnp.asarray(pos),
                            jnp.asarray(table))
        tl, tc = M.decode_step(tp, cfg, tc, torch.from_numpy(nxt),
                               torch.from_numpy(pos))
        tlp, tpool = M.decode_step(tp, cfg, tpool, torch.from_numpy(nxt),
                                   torch.from_numpy(pos),
                                   page_table=torch.from_numpy(table))
        for got, want, what in ((tl, jl, "dense"), (tlp, jlp, "paged")):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=ATOL, err_msg=f"{what} {step}")
        np.testing.assert_allclose(tlp.numpy(), tl.numpy(), atol=1e-5)
        nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
        pos = pos + 1


def test_obftf_train_step_matches_jax(arch):
    """One OBFTF step, noisy target, from the JAX step's own draws:
    per-example losses, kept rows, step cost, grad norm and new params."""
    name, jcfg, cfg, jp, tp = arch
    n, s = 8, 12
    toks = _tokens(cfg, n, s, seed=5)
    labels = _tokens(cfg, n, s, seed=6)
    labels[2, -4:] = -1
    batch = {"tokens": toks, "labels": labels}
    jopt = JO.sgd_momentum(JO.constant(0.05), momentum=0.9)
    topt = O.sgd_momentum(O.constant(0.05), momentum=0.9)
    jstep = jit(JOB.make_train_step(JM.loss_fn(jcfg), jopt, JOB.OBFTFConfig(
        selection=JOB.SelectionConfig(method="obftf", ratio=0.25))))
    tstep = OB.make_train_step(M.loss_fn(cfg), topt, OB.OBFTFConfig(
        selection=SelectionConfig(method="obftf", ratio=0.25)))
    jparams = jax.tree.map(jnp.asarray, jp)
    rng = jax.random.key(7)
    jnew, jm = jstep({"params": jparams, "opt": jopt.init(jparams),
                      "step": jnp.zeros((), jnp.int32)},
                     {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    tnew, tm = tstep({"params": tp, "opt": topt.init(tp),
                      "step": torch.zeros((), dtype=torch.int32)},
                     {k: torch.from_numpy(v) for k, v in batch.items()},
                     JaxDraws(jax.random.split(rng, 3)[1]))
    np.testing.assert_allclose(tm["per_example_loss"].numpy(),
                               np.asarray(jm["per_example_loss"]),
                               rtol=LOSS_RTOL)
    for k in ("kept", "step_cost"):
        assert float(tm[k]) == float(jm[k]), k
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    # the kept rows: the JAX selector on the JAX selection forward's losses,
    # with the step's selection key
    eval_step = JOB.make_eval_step(JM.loss_fn(jcfg))

    @jit
    def jpick(params, jb, rng):
        return JOB.select_and_gather(
            JOB.SelectionConfig(method="obftf", ratio=0.25),
            jax.random.split(rng, 3)[1], eval_step(params, jb, rng), jb)[1]

    jidx = jpick(jparams, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    np.testing.assert_array_equal(tm["selected"].numpy(), np.asarray(jidx))
    for t, j in zip(tree_leaves(tnew["params"]),
                    jax.tree.leaves(jnew["params"])):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=PARAM_ATOL)
    if name == "qwen3-14b":  # qk-norm took its gradient
        for k in ("q_norm", "k_norm"):
            assert not torch.equal(tnew["params"]["blocks"]["attn"][k],
                                   tp["blocks"]["attn"][k]), k


def test_gelu_mlp_matches_jax_tanh_form():
    """``jax.nn.gelu`` defaults to the tanh form and torch's ``gelu`` to the
    erf form; they differ by up to 4.7e-4 near |x| = 2.7. The port's MLP
    follows JAX to 1e-6 there."""
    rs = np.random.default_rng(8)
    d, f = 4, 6
    x = rs.standard_normal((1, 5, d)).astype(np.float32)
    w1 = np.zeros((d, f), np.float32)
    w1[0] = [-2.9, -2.7, -2.5, 2.5, 2.7, 2.9]  # pre-activations at ±2.7
    x[..., 0] = 1.0
    x[..., 1:] *= 1e-3
    w1[1:] = rs.standard_normal((d - 1, f)) * 0.01
    w2 = np.eye(f, d, dtype=np.float32) + 0.1
    jp = {"w1": jnp.asarray(w1), "w2": jnp.asarray(w2)}
    want = np.asarray(JL.mlp(jnp.asarray(x), jp))
    got = TL.mlp(torch.from_numpy(x), {"w1": torch.from_numpy(w1),
                                       "w2": torch.from_numpy(w2)})
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    h = torch.from_numpy(x @ w1)
    gap = (F.gelu(h) - F.gelu(h, approximate="tanh")).abs().max()
    assert gap > 4e-4  # the hazard the port steps around is real
    specs = TL.mlp_specs(d, f, gelu=True)
    assert set(specs) == {"w1", "w2"} and "w3" in TL.mlp_specs(d, f)


@pytest.mark.parametrize("page_size", ["4", "0"], ids=["paged", "dense"])
def test_serve_cli_runs_each_arch(arch, page_size, tmp_path, capsys):
    name = arch[0]
    summary = tmp_path / "run.json"
    serve.main([
        "--arch", name, "--smoke", "--device", "cpu", "--batch", "2",
        "--prompt-len", "6", "--gen", "3", "--requests", "3",
        "--page-size", page_size, "--retain", "topk", "--topk", "8",
        "--ledger", "device", "--json-out", str(summary)])
    assert "served 3 requests" in capsys.readouterr().out
    s = json.loads(summary.read_text())
    assert s["evicted"] == 3 and not s["queued"] and not s["in_flight"]


@pytest.mark.parametrize("ledger", ["host", "device"])
def test_train_cli_runs_each_arch(arch, ledger, tmp_path):
    out = tmp_path / "run.json"
    assert train.main([
        "--arch", arch[0], "--smoke", "--device", "cpu", "--steps", "3",
        "--global-batch", "8", "--seq-len", "8", "--recycle",
        "--ledger", ledger, "--instance-pool", "16",
        "--json-out", str(out)]) == 0
    s = json.loads(out.read_text())
    assert s["mean_step_cost"] == pytest.approx(0.75)
    assert np.isfinite([s["loss_first"], s["loss_last"]]).all()


# ---------------------------------------------------------------------------
# the prefix-embedding families with a prefix
# ---------------------------------------------------------------------------


def _prefix(cfg, b, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.prefix_len, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("name", PREFIX_ARCHS)
def test_forward_loss_and_signals_with_a_prefix_match_jax(name):
    """``prefix_embed`` [B, P, D] in front of the tokens: hidden states at
    every position, the per-example losses (token positions only) and
    signals, each against the JAX package's."""
    _, jcfg, cfg, jp, tp = _arch(name)
    toks = _tokens(cfg, 2, 10, seed=11)
    labels = _tokens(cfg, 2, 10, seed=12)
    labels[0, -2:] = -1
    pre = _prefix(cfg, 2, 13)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
          "prefix_embed": jnp.asarray(pre)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels),
          "prefix_embed": torch.from_numpy(pre)}
    (jh, _), jloss, (jce, jsig, _) = jit(lambda p, b: (
        JM.forward_hidden(p, jcfg, b["tokens"], b["prefix_embed"]),
        JM.loss_fn(jcfg)(p, b, None), JM.per_example_signals(p, jcfg, b)))(
        jp, jb)
    th, _ = M.forward_hidden(tp, cfg, tb["tokens"], tb["prefix_embed"])
    assert th.shape == (2, cfg.prefix_len + 10, cfg.d_model)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL)
    np.testing.assert_allclose(M.loss_fn(cfg)(tp, tb).numpy(),
                               np.asarray(jloss), rtol=LOSS_RTOL)
    tce, tsig, _ = M.per_example_signals(tp, cfg, tb)
    np.testing.assert_allclose(tce.numpy(), np.asarray(jce), rtol=LOSS_RTOL)
    for key in jsig:
        np.testing.assert_allclose(tsig[key].numpy(), np.asarray(jsig[key]),
                                   rtol=LOSS_RTOL, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("name", PREFIX_ARCHS)
def test_loss_is_over_the_token_positions_only(name):
    """As the JAX package's ``test_vlm_loss_masks_prefix``: one loss per
    example, 0 where every label is -1; and the loss is the token
    positions' CE, read past the prefix, which moves it."""
    _, _, cfg, _, tp = _arch(name)
    toks = torch.from_numpy(_tokens(cfg, 2, 8, seed=14))
    labels = torch.from_numpy(_tokens(cfg, 2, 8, seed=15))
    pre = torch.from_numpy(_prefix(cfg, 2, 16))
    batch = {"tokens": toks, "labels": labels, "prefix_embed": pre}
    losses, _ = M.per_example_loss(tp, cfg, batch)
    assert losses.shape == (2,)
    masked, _ = M.per_example_loss(tp, cfg, dict(
        batch, labels=torch.full_like(labels, -1)))
    np.testing.assert_allclose(masked.numpy(), 0.0)
    hidden, _ = M.forward_hidden(tp, cfg, toks, pre)
    logits = M.unembed(tp, cfg, hidden[:, cfg.prefix_len:])
    ce = F.cross_entropy(logits.transpose(1, 2), labels.long(),
                         reduction="none").mean(-1)
    np.testing.assert_allclose(losses.numpy(), ce.numpy(), rtol=1e-6)
    plain, _ = M.per_example_loss(tp, cfg, {"tokens": toks, "labels": labels})
    assert not torch.allclose(plain, losses)


@pytest.mark.parametrize("name", PREFIX_ARCHS)
def test_prefill_with_a_prefix_then_decode_match_jax(name):
    """A prefix and right-padded prompts, ``last_pos`` counting the prefix
    positions, then three decode steps at per-row depths through the dense
    cache and through a shuffled page pool, each against the JAX steps."""
    _, jcfg, cfg, jp, tp = _arch(name)
    b, plen, page = 3, 6, 4
    p_ = cfg.prefix_len
    npg = (p_ + plen + 4) // page + 1
    toks = _tokens(cfg, b, plen, seed=17)
    pre = _prefix(cfg, b, 18)
    last = p_ + np.asarray([5, 3, 1], np.int32)
    jl, jc = jit(lambda p, t, x, lp: JM.prefill(
        p, jcfg, t, npg * page, prefix=x, last_pos=lp))(
        jp, jnp.asarray(toks), jnp.asarray(pre), jnp.asarray(last))
    tl, tc = M.prefill(tp, cfg, torch.from_numpy(toks), npg * page,
                       prefix=torch.from_numpy(pre),
                       last_pos=torch.from_numpy(last))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    perm = np.random.default_rng(19).permutation(b * npg + 2)
    jpool, table = _paged_from_dense(jc, b, npg, page, perm)
    tpool = from_jax(jpool, "cpu")
    jdec = jit(lambda p, c, t, pos: JM.decode_step(p, jcfg, c, t, pos))
    pos = last + 1
    nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
    for step in range(3):
        jl, jc = jdec(jp, jc, jnp.asarray(nxt), jnp.asarray(pos))
        tl, tc = M.decode_step(tp, cfg, tc, torch.from_numpy(nxt),
                               torch.from_numpy(pos))
        tlp, tpool = M.decode_step(tp, cfg, tpool, torch.from_numpy(nxt),
                                   torch.from_numpy(pos),
                                   page_table=torch.from_numpy(table))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   err_msg=f"step {step}")
        np.testing.assert_allclose(tlp.numpy(), tl.numpy(), atol=1e-5)
        nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
        pos = pos + 1
