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
without remat, the no-grad scan that keeps nothing, and the train CLI.
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


def test_train_cli_runs_the_family_with_the_jax_json_names(tmp_path, capsys):
    from test_torch_train import _jax_summary_names

    out = tmp_path / "run.json"
    assert train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--steps", "3", "--global-batch", "8", "--seq-len",
                       str(SEQ), "--log-every", "1", "--json-out",
                       str(out)]) == 0
    s = json.loads(out.read_text())
    names = _jax_summary_names()
    assert names["summary"] <= set(s)
    assert names["health"] == set(s["health"])
    assert s["steps"] == 3 and s["layers"] == CFG.num_layers
    assert s["mean_step_cost"] == pytest.approx(1.75)
    assert s["moe_dropped_share"] is None
    assert np.isfinite([s["loss_first"], s["loss_last"]]).all()
    assert "step     0 loss=" in capsys.readouterr().out
