"""The port's paper experiments and their helpers against the JAX package's.

Datasets: the same arrays, bit for bit. ``Prefetcher``: the cases of
``tests/test_substrates.py``. ``ema_init``/``ema_update``: rtol 1e-6.
``brute_force_obftf``: residuals to 1e-6, equal indices where the best
mask wins by more than 1e-5. ``per_example_signals``: 1e-5 abs + 1e-5 rel
on four smoke configs in f32, weights carried by ``from_jax``. One step of
each bench's step function against the JAX bench's computation on the same
picked rows: the linreg GD step at rtol 1e-6, the MLP SGD step and the
policy ledger update at 1e-5, the Table 3 policy step at the tolerances of
``tests/test_torch_train.py``. Each twin's grid constants and CSV tables
(header and keys, through ``benchmarks.diff_tables.parse_tables``) equal
the JAX bench's.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import JaxDraws
from benchmarks import fig1_linreg as jfig1
from benchmarks import fig2_mnist as jfig2
from benchmarks import table3_lm_proxy as jtable3
from benchmarks.diff_tables import parse_tables
from repro import configs as jconfigs
from repro import data as jdata
from repro import optim as JO
from repro.core import device_ledger as jdledger
from repro.core import selection as JS
from repro.core.history import HistoryConfig as JHistoryConfig
from repro.models import model as JM
from repro_torch import data as tdata
from repro_torch import optim as O
from repro_torch.benchmarks import (
    cli, fig1_linreg, fig2_mnist, run, table3_lm_proxy,
)
from repro_torch.core import device_ledger as dledger
from repro_torch.core import selection as S
from repro_torch.core.history import HistoryConfig
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import from_jax, materialize, tree_leaves

torch.set_num_threads(1)
# the JAX side's programs compile without LLVM's optimizations: the
# reference values move by a few f32 units at most, compiles run faster
jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0})

LOSS_RTOL = 1e-5  # tests/test_torch_train.py
PARAM_ATOL = 1e-6
SIGNAL_TOL = 1e-5  # abs and rel


def _f32(arch):
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch),
                               param_dtype="float32", compute_dtype="float32")
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _weights(cfg, seed=0):
    """The port's seeded weights as a JAX tree of numpy arrays (dict keys
    sorted, the order of ``jax.tree.leaves``) and as the port's tree of it,
    whose ``tree_leaves`` line up with the JAX leaves."""
    w = materialize(M.param_specs(cfg), seed, torch.float32, "cpu")
    jp = jax.tree.map(lambda x: x.numpy(), w)
    return jp, from_jax(jp, "cpu")


# ---------------------------------------------------------------------------
# data, prefetcher, EMA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("outliers", [False, True], ids=["clean", "outliers"])
def test_synthetic_regression_equals_jax(outliers):
    a = tdata.SyntheticRegression(outliers=outliers, seed=3)
    b = jdata.SyntheticRegression(outliers=outliers, seed=3)
    for k in ("x_train", "y_train", "x_test", "y_test"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)


def test_mnist_like_equals_jax():
    for a, b in zip(tdata.mnist_like(512, 128, seed=0),
                    jdata.mnist_like(512, 128, seed=0)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_prefetcher_keeps_order(depth):
    it = iter([{"a": i} for i in range(5)])
    out = list(tdata.Prefetcher(it, depth=depth))
    assert [o["a"] for o in out] == [0, 1, 2, 3, 4]


def test_prefetcher_close_stops_its_thread():
    pf = tdata.Prefetcher(iter(range(10**6)), depth=2)
    assert next(pf) == 0
    pf.close()
    pf.close()  # again: the thread has put its end marker by now
    pf.thread.join(timeout=5)
    assert not pf.thread.is_alive()


def test_ema_matches_jax():
    _, cfg = _f32("llama3-8b")
    trees = [jax.tree.map(lambda x: x.astype(jnp.bfloat16),
                          _weights(cfg, seed=s)[0]) for s in range(3)]
    je = JO.ema_init(trees[0])  # eager, as the JAX package calls them
    te = O.ema_init(from_jax(trees[0], "cpu"))
    for tree, mom in ((trees[1], 0.9), (trees[2], 0.9999)):
        je = JO.ema_update(je, tree, mom)
        te = O.ema_update(te, from_jax(tree, "cpu"), mom)
    te_default = O.ema_update(te, from_jax(trees[1], "cpu"))
    je_default = JO.ema_update(je, trees[1])
    for t, j in ((te, je), (te_default, je_default)):
        for a, b in zip(tree_leaves(t), jax.tree.leaves(j)):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


# ---------------------------------------------------------------------------
# the brute-force oracle
# ---------------------------------------------------------------------------

BRUTE_CASES = [(4, 1), (5, 2), (6, 3), (7, 2), (8, 4), (9, 3), (10, 5),
               (11, 4), (12, 6), (12, 1), (12, 11)]


def _residual(losses, idx):
    return abs(float(np.mean(losses[np.asarray(idx)])) - float(losses.mean()))


@pytest.mark.parametrize("n,b", BRUTE_CASES)
def test_brute_force_obftf_matches_jax(n, b):
    losses = np.random.default_rng(n * 31 + b).gamma(
        2.0, 1.5, n).astype(np.float32)
    got = S.brute_force_obftf(torch.from_numpy(losses), b)
    want = np.asarray(JS.brute_force_obftf(jnp.asarray(losses), b))
    assert got.dtype == torch.int64 and got.shape == (b,)
    assert torch.equal(got, torch.sort(got).values)
    np.testing.assert_allclose(_residual(losses, got), _residual(losses, want),
                               atol=1e-6)
    # every size-b mask's residual: the indices agree where the best wins
    codes = np.arange(2**n)
    bits = (codes[:, None] >> np.arange(n)[None, :]) & 1
    res = np.sort(np.abs(bits[bits.sum(1) == b] @ losses.astype(np.float64)
                         / b - losses.mean()))
    if len(res) > 1 and res[1] - res[0] > 1e-5:
        np.testing.assert_array_equal(got.numpy(), want)
    # the heuristic never beats the exact solver
    noise = S.GeneratorNoise(torch.Generator().manual_seed(n))
    heur = S.select_obftf(noise, torch.from_numpy(losses), b)
    assert _residual(losses, heur) >= _residual(losses, got) - 1e-6


# ---------------------------------------------------------------------------
# per_example_signals
# ---------------------------------------------------------------------------

SIGNAL_ARCHS = ["llama3-8b", "deepseek-7b", "qwen3-14b", "granite-34b"]


@pytest.mark.parametrize("arch", SIGNAL_ARCHS)
def test_per_example_signals_match_jax(arch):
    jcfg, cfg = _f32(arch)
    jp, tp = _weights(cfg)
    rs = np.random.default_rng(7)
    tokens = rs.integers(0, cfg.vocab_size, (3, 10)).astype(np.int32)
    labels = rs.integers(0, cfg.vocab_size, (3, 10)).astype(np.int32)
    labels[1, -4:] = -1
    labels[2, :] = -1  # nothing to average: zeros in both
    jce, js, jaux = jit(lambda p, b: JM.per_example_signals(p, jcfg, b))(
        jp, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})
    tce, ts, taux = M.per_example_signals(
        tp, cfg, {"tokens": torch.from_numpy(tokens),
                  "labels": torch.from_numpy(labels)})
    for got, want in ((tce, jce), (ts["entropy"], js["entropy"]),
                      (ts["margin"], js["margin"])):
        assert got.dtype == torch.float32 and got.shape == (3,)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=SIGNAL_TOL, rtol=SIGNAL_TOL)
    assert float(taux) == float(jaux) == 0.0
    assert float(tce[2]) == 0.0


# ---------------------------------------------------------------------------
# one step of each bench's step function, on the same picked rows
# ---------------------------------------------------------------------------


def test_linreg_gd_step_matches_jax():
    data = tdata.SyntheticRegression(outliers=True)
    rs = np.random.default_rng(0)
    idx = rs.permutation(1000)[:100]
    sel = np.sort(rs.permutation(100)[:25])
    w0 = np.asarray([0.7, -0.3], np.float32)
    xb, yb = data.x_train[idx], data.y_train[idx]

    def jloss(w):  # the JAX bench's per_example, meaned over the picks
        pred = jnp.asarray(xb[sel])[:, 0] * w[0] + w[1]
        return jnp.mean(jnp.square(pred - jnp.asarray(yb[sel])))

    want = jnp.asarray(w0) - 1e-2 * jax.grad(jloss)(jnp.asarray(w0))
    got = fig1_linreg.gd_step(torch.from_numpy(w0), torch.from_numpy(xb),
                              torch.from_numpy(yb), torch.from_numpy(sel),
                              1e-2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.fixture(scope="module")
def mnist():
    """The data, and He-normal MLP weights drawn with numpy (the two
    packages' ``init_mlp`` draw from different generators)."""
    xtr, ytr, _, _ = tdata.mnist_like(512, 128, seed=0)
    rs = np.random.default_rng(0)
    sizes = (784, 256, 256, 10)
    jp = [{"b": rs.standard_normal(b).astype(np.float32) * 0.1,
           "w": (rs.standard_normal((a, b)) * (2.0 / a) ** 0.5).astype(
               np.float32)}
          for a, b in zip(sizes[:-1], sizes[1:])]
    return xtr, ytr, jp


def _mlp(jp):
    """The JAX bench's list of layers as the port's tree of them."""
    return {str(i): {k: torch.from_numpy(np.array(v))
                     for k, v in layer.items()} for i, layer in enumerate(jp)}


def _close_mlp(tp, jp, tol):
    for tl, jl in zip(tp.values(), jp):
        for k in ("w", "b"):
            np.testing.assert_allclose(tl[k].numpy(), np.asarray(jl[k]),
                                       atol=tol, rtol=tol)


@jit
def _jax_sgd_step(params, xs, ys):  # the JAX bench's step after its pick
    grads = jax.grad(lambda p: jnp.mean(jfig2.per_example_ce(p, xs, ys)))(
        params)
    return jax.tree.map(lambda p, g: p - 0.1 * g, params, grads)


def test_mlp_sgd_step_matches_jax(mnist):
    xtr, ytr, jp = mnist
    idx = np.random.default_rng(1).permutation(512)[:128]
    sel = np.sort(np.random.default_rng(2).permutation(128)[:32])
    want = _jax_sgd_step(jp, xtr[idx][sel], ytr[idx][sel])
    got = fig2_mnist.sgd_step(_mlp(jp), torch.from_numpy(xtr[idx]),
                              torch.from_numpy(ytr[idx]),
                              torch.from_numpy(sel), 0.1)
    _close_mlp(got, want, 1e-5)


@jit
def _jax_policy_step(params, ema, sig, seen, x, y, rows):
    """The JAX bench's policy step body after its pick (decay 0.9, lr
    0.1)."""
    def mean_ce(p):
        ce, ent, mar = jfig2.signals_ce(p, x[rows], y[rows])
        return jnp.mean(ce), (ce, ent, mar)

    (_, (ce, ent, mar)), grads = jax.value_and_grad(
        mean_ce, has_aux=True)(params)
    params = jax.tree.map(lambda p, g: p - 0.1 * g, params, grads)
    new_sig = jnp.stack([ent, mar], axis=-1)
    prev_e = jnp.where(seen[rows], ema[rows], ce)
    prev_s = jnp.where(seen[rows, None], sig[rows], new_sig)
    ema = ema.at[rows].set(0.9 * prev_e + (1 - 0.9) * ce)
    sig = sig.at[rows].set(0.9 * prev_s + (1 - 0.9) * new_sig)
    return params, ema, sig, seen.at[rows].set(True)


def test_mlp_policy_step_and_ledger_match_jax(mnist):
    """Two policy steps, the second over a batch led by the first's rows,
    so it EMAs entries the first made; the picks from the JAX draws."""
    xtr, ytr, jp = mnist
    n, b, cold = 512, 32, 1e3
    pol, jpol = S.get_policy("margin"), JS.get_policy("margin")
    jema, jsig = jnp.zeros((n,), jnp.float32), jnp.zeros((n, 2), jnp.float32)
    jseen = jnp.zeros((n,), bool)
    jparams = jax.tree.map(jnp.asarray, jp)
    tparams = _mlp(jp)
    tema, tsig = torch.zeros(n), torch.zeros(n, 2)
    tseen = torch.zeros(n, dtype=torch.bool)
    order = np.random.default_rng(3).permutation(n)
    idx = order[:128]
    @jit
    def jpick(key, ema, sig, seen, idx):  # the JAX bench's pick
        scores = JS.policy_score(jpol, ema[idx], sig[idx], seen[idx], cold)
        return idx[JS.select_by_score(key, scores, b)]

    for step in range(2):
        key = jax.random.key(step)
        rows = jpick(key, jema, jsig, jseen, jnp.asarray(idx))
        trows = fig2_mnist.policy_pick(
            pol, JaxDraws(key), tema, tsig, tseen, torch.from_numpy(idx), b,
            cold)
        np.testing.assert_array_equal(trows.numpy(), np.asarray(rows))
        jparams, jema, jsig, jseen = _jax_policy_step(
            jparams, jema, jsig, jseen, xtr, ytr, rows)
        tparams, tema, tsig, tseen = fig2_mnist.policy_step(
            tparams, tema, tsig, tseen, torch.from_numpy(xtr),
            torch.from_numpy(ytr), trows, 0.1, 0.9)
        _close_mlp(tparams, jparams, 1e-5)
        np.testing.assert_allclose(tema.numpy(), np.asarray(jema), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(tsig.numpy(), np.asarray(jsig), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_array_equal(tseen.numpy(), np.asarray(jseen))
        # next: the rows just trained on and 16 unseen ones, so the cold
        # score picks all 16 and the policy's scores half of the rest
        idx = np.concatenate([np.asarray(rows), order[128:144]])
    assert int(tseen.sum()) == 2 * b - 16


def test_table3_policy_step_matches_jax():
    """Two recycle-loop steps of the smoke llama in f32 with SGD-momentum
    (linear in the grads, as in tests/test_torch_train.py), the picks by
    the loss_ema policy from the JAX draws: params and the whole ledger
    after each step, the second taken by both packages from
    the JAX state after the first."""
    jcfg, cfg = _f32("llama3-8b")
    jp, _ = _weights(cfg)
    jopt = JO.sgd_momentum(JO.constant(0.05), momentum=0.9)
    topt = O.sgd_momentum(O.constant(0.05), momentum=0.9)
    jl, tl = JHistoryConfig(capacity=1 << 10), HistoryConfig(capacity=1 << 10)
    jpol, tpol = JS.get_policy("loss_ema"), S.get_policy("loss_ema")
    # 4 ids, 3 picks a step: the second step picks its one unseen id and
    # records two again
    stream = tdata.SyntheticLMStream(tdata.DataConfig(4, 12, cfg.vocab_size,
                                                      instance_pool=4))

    @jit
    def jstep(state, lstate, bt, sel):  # the JAX bench's jstep after its pick
        sub = {"tokens": bt["tokens"][sel], "labels": bt["labels"][sel]}

        def mean_loss(p):
            loss, s, _aux = JM.per_example_signals(p, jcfg, sub)
            return jnp.mean(loss), (loss, s)

        (_, (loss, s)), grads = jax.value_and_grad(
            mean_loss, has_aux=True)(state["params"])
        updates, opt_state = jopt.update(grads, state["opt"], state["params"])
        new = {"params": JO.apply_updates(state["params"], updates),
               "opt": opt_state, "step": state["step"] + 1}
        signals = jnp.stack([s["entropy"], s["margin"]], axis=-1)
        lstate = jdledger.record(jl, lstate, bt["instance_id"][sel], loss,
                                 new["step"], signals=signals)
        return new, lstate

    @jit
    def jpick(key, lstate, ids):  # the JAX bench's pick
        ema, sig, seen = jdledger.lookup_signals(lstate, ids)
        return JS.select_by_score(
            key, JS.policy_score(jpol, ema, sig, seen, 1e3), 3)

    jparams = jax.tree.map(jnp.asarray, jp)
    jstate = {"params": jparams, "opt": jopt.init(jparams),
              "step": jnp.zeros((), jnp.int32)}
    jlstate = jdledger.init_state(jl)
    tparams = from_jax(jp, "cpu")
    tstate = {"params": tparams, "opt": topt.init(tparams),
              "step": torch.zeros((), dtype=torch.int32)}
    tlstate = dledger.init_state(tl, "cpu")
    for t in range(2):
        if t:  # each step from the same state: one step's tolerances
            tstate = from_jax(jax.tree.map(np.asarray, jstate), "cpu")
            tlstate = dledger.LedgerState(*(
                torch.from_numpy(np.array(getattr(jlstate, f)))
                for f in ("ema", "count", "last_seen", "owner", "sig")))
        raw = stream.batch(t)
        raw["instance_id"] = raw["instance_id"].astype(np.int32)
        key = jax.random.key(10 + t)
        sel = jpick(key, jlstate, jnp.asarray(raw["instance_id"]))
        tbt = {k: torch.from_numpy(v) for k, v in raw.items()}
        tsel = table3_lm_proxy.policy_pick(tpol, JaxDraws(key), tlstate,
                                           tbt["instance_id"], 3)
        np.testing.assert_array_equal(tsel.numpy(), np.asarray(sel))
        jstate, jlstate = jstep(jstate, jlstate,
                                {k: jnp.asarray(v) for k, v in raw.items()},
                                sel)
        tstate, tlstate = table3_lm_proxy.policy_step(
            cfg, topt, tl, tstate, tlstate, tbt, tsel)
        assert int(tstate["step"]) == int(jstate["step"]) == t + 1
        for a, b in zip(tree_leaves(tstate["params"]),
                        jax.tree.leaves(jstate["params"])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       atol=PARAM_ATOL)
        for name in ("count", "last_seen", "owner"):
            np.testing.assert_array_equal(getattr(tlstate, name).numpy(),
                                          np.asarray(getattr(jlstate, name)),
                                          err_msg=name)
        for name in ("ema", "sig"):
            np.testing.assert_allclose(getattr(tlstate, name).numpy(),
                                       np.asarray(getattr(jlstate, name)),
                                       rtol=LOSS_RTOL, err_msg=name)
    assert sorted(tlstate.count[tlstate.owner >= 0].tolist()) == [1, 1, 2, 2]


# ---------------------------------------------------------------------------
# the grids and the tables
# ---------------------------------------------------------------------------

TWINS = [(fig1_linreg, jfig1), (fig2_mnist, jfig2), (table3_lm_proxy, jtable3)]


@pytest.mark.parametrize("twin,ref", TWINS, ids=["fig1", "fig2", "table3"])
def test_grids_equal_jax(twin, ref):
    for name in ("METHODS", "RATIOS", "POLICY_RATIOS"):
        assert getattr(twin, name, None) == getattr(ref, name, None), name


def _jax_tables(ref, monkeypatch):
    """The JAX bench's fast-profile tables with its training stubbed out
    (every metric 0.5): the header lines and keys its format gives."""
    for fn in ("train_linreg", "train_mnist", "train_mnist_policy",
               "train_lm", "train_lm_policy"):
        if hasattr(ref, fn):
            monkeypatch.setattr(ref, fn, lambda *a, **k: 0.5)
    return "\n".join(ref.main(fast=True))


def _port_tables(twin, monkeypatch):
    """A run of two steps of every arm of the port's bench, on the CPU
    (Table 3's held-out loss over one eval batch, not four)."""
    if twin is fig2_mnist:
        return twin.main(device="cpu", epochs=1,
                         data=tdata.mnist_like(256, 64, seed=0))
    monkeypatch.setattr(table3_lm_proxy, "EVAL_STEPS", range(10_000, 10_001))
    return twin.main(device="cpu", steps=2)


@pytest.mark.parametrize("twin,ref", TWINS, ids=["fig1", "fig2", "table3"])
def test_tables_parse_to_the_jax_keys(twin, ref, monkeypatch):
    lines = _port_tables(twin, monkeypatch)
    want_text = _jax_tables(ref, monkeypatch)
    assert ([x for x in lines if x.startswith("table,")]
            == [x for x in want_text.splitlines() if x.startswith("table,")])
    got, want = parse_tables("\n".join(lines)), parse_tables(want_text)
    assert list(got) == list(want)
    for key, vals in got.items():
        assert list(vals) == list(want[key]), key
        assert all(math.isfinite(v) for v in vals.values()), key


def test_cli_hands_its_flags_to_the_bench(capsys):
    cli(lambda fast, device: ["table,x", f"{fast},{device}"],
        ["--fast", "--device", "cpu"])
    cli(lambda fast, device: [f"{fast},{device}"], [])
    assert capsys.readouterr().out == "table,x\nTrue,cpu\nFalse,cuda\n"


def test_run_prints_sections_that_parse(monkeypatch, capsys):
    monkeypatch.setattr(run, "SECTIONS", (
        ("fig1", "Fig.1 linear regression (clean + outliers)",
         lambda fast, device: fig1_linreg.main(fast, device, steps=2)),
        ("fig2", "Fig.2 MNIST-like classification", None)))
    assert run.main(["--device", "cpu", "--only", "fig1"]) == 0
    out = capsys.readouterr().out
    assert "=== Fig.1 linear regression (clean + outliers) ===" in out
    assert "[fig1: " in out and "Fig.2" not in out
    assert len(parse_tables(out)) == 2 * len(fig1_linreg.METHODS) * len(
        fig1_linreg.RATIOS)
