"""The port's training path against the JAX package's.

The train step: JAX ``make_train_step`` and the port's from the same
weights (``from_jax``) on the llama3-8b smoke config in float32, with
SGD-momentum, whose update is linear in the grads (AdamW's first update is
about lr * sign(g), which a grad near 0 flips; it is held step for step on
identical grads in ``test_torch_optim.py``). The port selects with the
JAX step's own draws (``JaxDraws`` on its selection key). Per-example
losses rtol 1e-5 (f32 forwards in another summation order), selected
indices, fresh masks, kept and step cost exact, updated params atol 1e-6.

The CLI: ``repro_torch.launch.train.main`` in-process on the CPU.
"""

import ast
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import JaxDraws
from repro import configs as jconfigs
from repro import optim as JO
from repro.core import obftf as JOB
from repro.core.history import HistoryConfig as JHistoryConfig
from repro.core.history import LossHistory as JLossHistory
from repro.data import DataConfig, SyntheticLMStream
from repro.models import model as JM
from repro.models.params import materialize as jmaterialize
from repro_torch import optim as O
from repro_torch.core import obftf as OB
from repro_torch.core.selection import SelectionConfig
from repro_torch.launch import train
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import from_jax, tree_leaves

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-6
JCFG = dataclasses.replace(jconfigs.get_smoke("llama3-8b"),
                           param_dtype="float32", compute_dtype="float32")
CFG = ModelConfig(**dataclasses.asdict(JCFG))
N, S = 8, 12


@pytest.fixture(scope="module")
def setup():
    jp = jax.jit(lambda k: jmaterialize(JM.param_specs(JCFG), k,
                                        jnp.float32))(jax.random.key(0))
    raw = SyntheticLMStream(DataConfig(N, S, CFG.vocab_size, seed=4)).batch(0)
    labels = raw["labels"].copy()
    labels[1, -3:] = -1  # masked positions
    rec = np.random.default_rng(2).uniform(1, 9, N).astype(np.float32)
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
    jsel = JOB.SelectionConfig(method=method, ratio=0.25)
    tsel = SelectionConfig(method=method, ratio=0.25)
    jopt, topt = _sgd(JO), _sgd(O)
    jstep = jax.jit(JOB.make_train_step(
        JM.loss_fn(JCFG), jopt,
        JOB.OBFTFConfig(selection=jsel, recycle_forward=recycle, mode=mode)))
    tstep = OB.make_train_step(
        M.loss_fn(CFG), topt,
        OB.OBFTFConfig(selection=tsel, recycle_forward=recycle, mode=mode))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jparams = jax.tree.map(jnp.asarray, jp)
    jstate = {"params": jparams, "opt": jopt.init(jparams),
              "step": jnp.zeros((), jnp.int32)}
    tparams = from_jax(jp, "cpu")
    tstate = {"params": tparams, "opt": topt.init(tparams),
              "step": torch.zeros((), dtype=torch.int32)}
    rng = jax.random.key(5)
    draws = JaxDraws(jax.random.split(rng, 3)[1])  # the step's selection key

    jnew, jm = jstep(jstate, jb, rng)
    tnew, tm = tstep(tstate, tb, draws)

    np.testing.assert_allclose(tm["per_example_loss"].numpy(),
                               np.asarray(jm["per_example_loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_array_equal(tm["per_example_fresh"].numpy(),
                                  np.asarray(jm["per_example_fresh"]))
    for k in ("kept", "step_cost"):
        assert float(tm[k]) == float(jm[k]), k
    for k in ("loss", "selected_mean_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["selection_residual"]),
                               float(jm["selection_residual"]), atol=1e-4)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    assert int(tnew["step"]) == int(jnew["step"]) == 1
    for t, j in zip(tree_leaves(tnew["params"]),
                    jax.tree.leaves(jnew["params"])):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=PARAM_ATOL)

    if mode == "obftf":
        # the selected indices: the same selector on each package's losses
        # (the recorded ones, or the selection forward's)
        if recycle:
            jl, tl = jb["recorded_loss"], tb["recorded_loss"]
        else:
            jl = _jax_eval(jparams, jb, rng)
            tl = OB.make_eval_step(M.loss_fn(CFG))(tparams, tb)
        _, jidx, _ = JOB.select_and_gather(jsel, jax.random.split(rng, 3)[1],
                                           jl, jb)
        _, tidx, _ = OB.select_and_gather(tsel, draws, tl, tb)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(tm["selected"].numpy(), np.asarray(jidx))


def test_per_token_loss_masks_after_the_kernel(setup):
    """labels < 0 give 0 (the plain xent gives lse there), and the
    per-example mean divides by the label count only."""
    jp, batch = setup
    tparams = from_jax(jp, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits = M.unembed(tparams, CFG, M.forward_hidden(tparams, CFG,
                                                      tb["tokens"])[0])
    ce = M.per_token_loss(logits, tb["labels"])
    assert (ce[1, -3:] == 0).all() and (ce[1, :-3] > 0).all()
    want = JM.per_token_loss(jnp.asarray(logits.detach().numpy()),
                             jnp.asarray(batch["labels"]))
    np.testing.assert_allclose(ce.detach().numpy(), np.asarray(want),
                               rtol=1e-6)
    jl = jax.jit(lambda p, b: JM.per_example_loss(p, JCFG, b)[0])(
        jax.tree.map(jnp.asarray, jp),
        {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(M.per_example_loss(tparams, CFG, tb)[0].detach(),
                               np.asarray(jl), rtol=LOSS_RTOL)


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


# ---------------------------------------------------------------------------
# the CLI, in-process on the CPU
# ---------------------------------------------------------------------------

SMOKE = ["--arch", "llama3-8b", "--smoke", "--device", "cpu",
         "--global-batch", "8", "--seq-len", "12", "--log-every", "1"]


def _jax_summary_names():
    """The keys of the JAX trainer's --json-out summary and of its
    ``health`` entry, read from its source."""
    tree = ast.parse((ROOT / "src/repro/launch/train.py").read_text())
    names = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            tgt = node.targets[0]
            if isinstance(tgt, ast.Name) and tgt.id == "summary":
                names["summary"] = {k.value for k in node.value.keys}
        if isinstance(node, ast.FunctionDef) and node.name == "train_health":
            ret = [n for n in ast.walk(node) if isinstance(n, ast.Return)][0]
            names["health"] = {k.value for k in ret.value.keys}
    return names


def test_cli_default_path_json_names_match_jax(tmp_path, capsys):
    out = tmp_path / "run.json"
    assert train.main(SMOKE + ["--steps", "3", "--json-out", str(out)]) == 0
    summary = json.loads(out.read_text())
    names = _jax_summary_names()
    assert names["summary"] <= set(summary)
    assert names["health"] == set(summary["health"])
    assert summary["steps"] == 3 and summary["guarded_steps"] == 0
    assert summary["mean_step_cost"] == pytest.approx(1.75)
    assert np.isfinite([summary["loss_first"], summary["loss_last"]]).all()
    assert "step     0 loss=" in capsys.readouterr().out


def test_cli_recycle_device_ledger_npz_loads_into_jax(tmp_path):
    led = tmp_path / "ledger.npz"
    out = tmp_path / "run.json"
    assert train.main(SMOKE + [
        "--steps", "4", "--recycle", "--ledger", "device",
        "--instance-pool", "16", "--ledger-out", str(led),
        "--json-out", str(out)]) == 0
    summary = json.loads(out.read_text())
    assert summary["mean_step_cost"] == pytest.approx(0.75)
    assert summary["ledger_hits_first"] == 0.0
    assert summary["ledger_hits_mean"] > 0  # the pool repeats from step 2
    h = JLossHistory(JHistoryConfig())
    h.load_state_dict(dict(np.load(led)))
    sd = h.state_dict()
    live = sd["owner"] >= 0
    assert set(sd["owner"][live]) <= set(range(16))
    _, seen = h.lookup(np.arange(16))
    assert seen.sum() == live.sum()
    # only the kept rows are recorded: 2 of 8 per step over 4 steps
    assert sd["count"][live].sum() == 8


def test_cli_checkpoint_then_resume_with_ledger(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    args = SMOKE + ["--recycle", "--ledger", "host", "--instance-pool", "8",
                    "--ckpt-dir", ck, "--ckpt-every", "2"]
    assert train.main(args + ["--steps", "2"]) == 0
    assert "final checkpoint at step 2" in capsys.readouterr().out
    out = tmp_path / "resumed.json"
    assert train.main(args + ["--steps", "4", "--resume", "auto",
                              "--json-out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "resumed from step 2 (with ledger)" in text
    assert "ledger restored from checkpoint" in text
    summary = json.loads(out.read_text())
    assert summary["steps"] == 2  # steps 2 and 3
    # the first resumed batch is answered by the checkpoint's ledger
    h = JLossHistory(JHistoryConfig())
    h.load_state_dict(dict(np.load(Path(ck) / "step_0000000002/ledger.npz")))
    assert summary["ledger_hits_first"] == h.lookup(np.arange(8))[1].mean()
    assert summary["ledger_hits_first"] > 0


def test_checkpoint_is_readable_by_the_jax_manager(tmp_path):
    """bf16 leaves are saved as 2-byte records named "bfloat16", as the JAX
    package's ml_dtypes arrays are, so its manager restores them."""
    from repro.checkpoint import manager as JCK
    from repro_torch.checkpoint import CheckpointManager

    state = {"params": {"w": torch.randn(3, 4).to(torch.bfloat16),
                        "b": torch.randn(4)},
             "step": torch.tensor(7, dtype=torch.int32)}
    ck = CheckpointManager(str(tmp_path), keep=1)
    ck.save(7, state, block=True, ledger={"owner": np.arange(4)})
    ck.save(8, state, block=True)
    assert ck.latest() == 8 and JCK.latest_step(str(tmp_path)) == 8
    target = jax.tree.map(lambda x: np.zeros(x.shape, np.float32),
                          {"params": {"w": np.zeros((3, 4)),
                                      "b": np.zeros(4)},
                           "step": np.zeros(())})
    got = JCK.load_checkpoint(str(tmp_path), 8, target)
    np.testing.assert_array_equal(
        np.asarray(got["params"]["w"], np.float32),
        state["params"]["w"].float().numpy())
    back = ck.restore(8, state)
    assert back["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(back["params"]["w"], state["params"]["w"])
    assert int(back["step"]) == 7
    assert ck.restore_ledger(8) is None


def test_jax_train_state_carries_over_and_both_take_the_same_step(setup):
    """A JAX train state after one AdamW step ({"params", "opt": {"step",
    "m", "v"}, "step"}) comes across through ``from_jax``; from it, both
    packages take the next step (the maxk selector needs no draws)."""
    jp, batch = setup
    sel = ("obftf", "maxk", False)
    jopt = JO.adamw(JO.warmup_cosine(1e-3, 1, 10),
                    JO.AdamWConfig(weight_decay=0.1))
    topt = O.adamw(O.warmup_cosine(1e-3, 1, 10),
                   O.AdamWConfig(weight_decay=0.1))
    jstep = jax.jit(JOB.make_train_step(JM.loss_fn(JCFG), jopt,
                                        JOB.OBFTFConfig(JOB.SelectionConfig(
                                            method=sel[1]))))
    tstep = OB.make_train_step(M.loss_fn(CFG), topt, OB.OBFTFConfig(
        SelectionConfig(method=sel[1])))
    jparams = jax.tree.map(jnp.asarray, jp)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    j1, _ = jstep({"params": jparams, "opt": jopt.init(jparams),
                   "step": jnp.zeros((), jnp.int32)}, jb, jax.random.key(1))
    t1 = from_jax(jax.tree.map(np.asarray, j1), "cpu")
    assert t1["opt"]["m"]["embed"].dtype == torch.float32
    assert t1["step"].dtype == torch.int32 and int(t1["step"]) == 1
    j2, jm = jstep(j1, jb, jax.random.key(2))
    t2, tm = tstep(t1, tb, None)
    assert int(t2["opt"]["step"]) == int(j2["opt"]["step"]) == 2
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    for t, j in zip(tree_leaves(t2["params"]), jax.tree.leaves(j2["params"])):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=PARAM_ATOL)


def test_cli_sigterm_saves_a_final_checkpoint_with_the_ledger(
        tmp_path, capsys, monkeypatch):
    """SIGTERM mid-run: the step finishes, the loop stops, and the final
    blocking save carries the ledger. The signal is sent from inside the
    third step's bookkeeping, so it always lands on an installed handler."""
    import os
    import signal

    observe = train.Watchdog.observe

    def observe_then_signal(self, dt):
        if self.n == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return observe(self, dt)

    monkeypatch.setattr(train.Watchdog, "observe", observe_then_signal)
    ck = str(tmp_path / "ck")
    before = signal.getsignal(signal.SIGTERM)
    assert train.main(SMOKE + ["--steps", "50", "--recycle", "--ledger",
                               "device", "--ckpt-dir", ck]) == 0
    text = capsys.readouterr().out
    assert f"signal {int(signal.SIGTERM)}: checkpoint + exit" in text
    from repro_torch.checkpoint import latest_step, load_ledger

    assert latest_step(ck) == 3 and "final checkpoint at step 3" in text
    assert (load_ledger(ck, 3)["owner"] >= 0).sum() > 0
    assert signal.getsignal(signal.SIGTERM) is before  # handler restored


@pytest.mark.parametrize("policy", ["loss_ema", "entropy", "margin",
                                    "uniform"])
def test_recycle_feed_matches_jax(policy):
    """The host and engine joins against one ledger give the JAX feed's
    recorded_loss and hit rate; the device feed passes batches through."""
    from repro.data import RecycleFeed as JRecycleFeed
    from repro_torch.core.history import HistoryConfig, LossHistory
    from repro_torch.data import DataConfig as TDataConfig
    from repro_torch.data import RecycleFeed, SyntheticLMStream as TStream

    rs = np.random.default_rng(0)
    ids = np.arange(0, 40, 2)
    jh, th = JLossHistory(JHistoryConfig()), LossHistory(HistoryConfig())
    losses = rs.uniform(0, 5, ids.size).astype(np.float32)
    sig = rs.normal(0, 2, (ids.size, 2)).astype(np.float32)
    for h in (jh, th):
        h.record(ids, losses, 3, signals=sig)
    jfeed = JRecycleFeed(SyntheticLMStream(DataConfig(16, 8, 64)), jh,
                         policy=policy)
    tstream = TStream(TDataConfig(16, 8, 64))
    for ledger in ("host", "engine"):
        tfeed = RecycleFeed(tstream, th, ledger=ledger, policy=policy)
        for step in range(2):
            want, got = jfeed.batch(step), tfeed.batch(step)
            np.testing.assert_allclose(got["recorded_loss"],
                                       want["recorded_loss"], rtol=1e-6)
            assert got["ledger_hit_rate"] == want["ledger_hit_rate"]
    raw = RecycleFeed(tstream, ledger="device").batch(1)
    assert "recorded_loss" not in raw
    np.testing.assert_array_equal(raw["tokens"], tstream.batch(1)["tokens"])
    with pytest.raises(ValueError):
        RecycleFeed(tstream, ledger="host")
