"""Training the hybrid family in the port against the JAX package.

zamba2-2.7b's smoke config in f32 (4 SSM layers in 2 groups, each group
led by the one weight-shared attention block), rows of 24 tokens (a scan
chunk of 16 and a short one of 8), weights carried across by ``from_jax``:

* one OBFTF train step (obftf with a noisy target at ratio 0.25, with a
  selection forward and with recycled losses) against JAX
  ``make_train_step``, with SGD-momentum so that the state after one step
  holds the kept rows' grads: per-example losses rtol 1e-5, kept rows
  equal, grads leaf by leaf within GRAD_ATOL * max|jax| + GRAD_RTOL *
  |jax| (f32 sums in another order: the tied embedding's grad sums every
  token's, entries up to about 4.5, so its absolute part scales with the
  leaf), params atol 1e-6;
* ``shared_attn``'s grad on the kept rows, leaf by leaf: equal to the
  sum of the grads of per-group copies of the block (rtol 1e-6 atol
  1e-7: the shared block's grad is the sum of its uses, one a group), and
  to the JAX step's (``jax.value_and_grad`` of the JAX loss) within the
  grads' limit;
* the same grads with and without remat (rtol 1e-6 atol 1e-7).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import JaxDraws
from repro import configs as jconfigs
from repro import optim as JO
from repro.core import obftf as JOB
from repro.data import DataConfig, SyntheticLMStream
from repro.models import model as JM
from repro.models.params import materialize as jmaterialize
from repro_torch import optim as O
from repro_torch.core import obftf as OB
from repro_torch.core.selection import SelectionConfig
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import from_jax, tree_leaves, tree_map

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4  # the atol scaled by the leaf's max
PARAM_ATOL = 1e-6
REMAT_TOL = dict(rtol=1e-6, atol=1e-7)
ARCH = "zamba2-2.7b"
JCFG = dataclasses.replace(jconfigs.get_smoke(ARCH), param_dtype="float32",
                           compute_dtype="float32")
CFG = ModelConfig(**dataclasses.asdict(JCFG))
N_ROWS, SEQ = 8, 24


def _grad_close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    lim = GRAD_ATOL * np.abs(want).max() + GRAD_RTOL * np.abs(want)
    err = np.abs(got - want)
    assert got.shape == want.shape and (err <= lim).all(), \
        f"{what}: err {err.max()} (limit {lim.max()})"
    assert np.abs(got).max() > 0, f"{what}: no gradient"


def _paths(tree, prefix=()):
    """The leaves' paths, in ``tree_leaves``' order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, prefix + (k,))]
    return ["/".join(prefix)]


@pytest.fixture(scope="module")
def setup():
    assert CFG.family == "hybrid" and CFG.num_layers // \
        CFG.hybrid_attn_every == 2
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


def _sgd(M_):
    return M_.sgd_momentum(M_.constant(0.05), momentum=0.9)


SEL = dict(method="obftf", ratio=0.25)


def _jax_program(recycle):
    """One jitted JAX program a mode (each compiles once): the OBFTF train
    step and the JAX selector's kept rows on the losses it selects by (the
    recorded ones, or a selection forward)."""
    opt = _sgd(JO)
    step = JOB.make_train_step(JM.loss_fn(JCFG), opt, JOB.OBFTFConfig(
        selection=JOB.SelectionConfig(**SEL), recycle_forward=recycle))
    evaluate = JOB.make_eval_step(JM.loss_fn(JCFG))

    def run(params, batch, rng):
        new, metrics = step({"params": params, "opt": opt.init(params),
                             "step": jnp.zeros((), jnp.int32)}, batch, rng)
        losses = (batch["recorded_loss"] if recycle
                  else evaluate(params, batch, rng))
        _, kept, _ = JOB.select_and_gather(
            JOB.SelectionConfig(**SEL), jax.random.split(rng, 3)[1], losses,
            batch)
        return new, metrics, kept

    return jax.jit(run)


RNG_SEED = 5
_RUNS = {}


def _jax_run(setup, recycle):
    """(new state, metrics, kept rows) of the JAX program, once a mode."""
    if recycle not in _RUNS:
        jp, batch = setup
        out = _jax_program(recycle)(
            jax.tree.map(jnp.asarray, jp),
            {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.key(RNG_SEED))
        _RUNS[recycle] = jax.tree.map(np.asarray, out)
    return _RUNS[recycle]


def _port_step(setup, recycle):
    jp, batch = setup
    topt = _sgd(O)
    tstep = OB.make_train_step(M.loss_fn(CFG), topt, OB.OBFTFConfig(
        selection=SelectionConfig(**SEL), recycle_forward=recycle))
    tparams = from_jax(jp, "cpu")
    return tstep({"params": tparams, "opt": topt.init(tparams),
                  "step": torch.zeros((), dtype=torch.int32)},
                 {k: torch.from_numpy(v) for k, v in batch.items()},
                 JaxDraws(jax.random.split(jax.random.key(RNG_SEED), 3)[1]))


@pytest.mark.parametrize("recycle", [False, True],
                         ids=["selection-forward", "recycled"])
def test_train_step_matches_jax(setup, recycle):
    jnew, jm, jidx = _jax_run(setup, recycle)
    tnew, tm = _port_step(setup, recycle)

    np.testing.assert_allclose(tm["per_example_loss"].numpy(),
                               jm["per_example_loss"], rtol=LOSS_RTOL)
    np.testing.assert_array_equal(tm["per_example_fresh"].numpy(),
                                  jm["per_example_fresh"])
    np.testing.assert_array_equal(tm["selected"].numpy(), jidx)
    for k in ("kept", "step_cost"):
        assert float(tm[k]) == float(jm[k]), k
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    # SGD-momentum's state after one step is the kept rows' grads
    for path, t, j in zip(_paths(tnew["opt"]["m"]),
                          tree_leaves(tnew["opt"]["m"]),
                          jax.tree.leaves(jnew["opt"]["m"])):
        _grad_close(t.numpy(), j, path)
    for path, t, j in zip(_paths(tnew["params"]), tree_leaves(tnew["params"]),
                          jax.tree.leaves(jnew["params"])):
        np.testing.assert_allclose(t.numpy(), j, atol=PARAM_ATOL,
                                   err_msg=path)


def _untied_loss(params, cfg, batch):
    """The hybrid loss with the shared block untied: each group's use
    takes its own copy of ``shared_attn`` -> (mean loss, the copies)."""
    copies = [tree_map(lambda _, p: p.detach().clone().requires_grad_(True),
                       params["shared_attn"]) for _ in range(2)]
    x = M.embed_tokens(params, cfg, batch["tokens"])
    positions = torch.arange(x.shape[1])
    for g, shared in enumerate(copies):
        x = M._hybrid_group(x, shared, M.layer(params["blocks"], g), cfg,
                            positions)
    x = M.L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    ce = M.per_token_loss(M.unembed(params, cfg, x), batch["labels"])
    denom = torch.clamp((batch["labels"] >= 0).sum(-1), min=1)
    return (ce.sum(-1) / denom).mean(), copies


def test_shared_block_grad_is_the_sum_of_its_uses_and_matches_jax(setup):
    """``shared_attn`` is one weight set used at the head of each group:
    its grad is the sum of the groups' uses, each through its own group's
    activations. On the recycled step's kept rows the tied grad equals the
    sum of the grads of per-group copies of the block, and both equal the
    JAX step's (its ``jax.value_and_grad`` of the JAX loss)."""
    jp, batch = setup
    jnew, _, jidx = _jax_run(setup, True)
    kept = {k: torch.from_numpy(batch[k][jidx])
            for k in ("tokens", "labels")}
    params = from_jax(jp, "cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    M.loss_fn(CFG)(params, kept).mean().backward()
    tied = tree_map(lambda _, p: p.grad, params["shared_attn"])
    loss, copies = _untied_loss(from_jax(jp, "cpu"), CFG, kept)
    loss.backward()
    want = jnew["opt"]["m"]["shared_attn"]
    names = _paths(tied)
    assert {"attn/wq", "mlp/w2", "attn_norm", "ffn_norm"} <= set(names)
    for name, t, a, b, j in zip(
            names, tree_leaves(tied), *(tree_leaves(c) for c in copies),
            jax.tree.leaves(want)):
        assert float(a.grad.abs().max()) > 0 and \
            float(b.grad.abs().max()) > 0, name  # each group uses it
        torch.testing.assert_close(t, a.grad + b.grad, **REMAT_TOL,
                                   msg=f"shared_attn/{name}")
        _grad_close(t.numpy(), j, f"shared_attn/{name}")


def _port_grads(jp, batch, cfg):
    """The grad of the mean per-example loss over the whole batch."""
    params = from_jax(jp, "cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    M.loss_fn(cfg)(params, OB.model_inputs(tb)).mean().backward()
    return tree_map(lambda _, p: p.grad, params)


def test_remat_gives_the_same_grads(setup):
    jp, batch = setup
    grads = [tree_leaves(_port_grads(jp, batch,
                                     dataclasses.replace(CFG, remat=r)))
             for r in (False, True)]
    for name, a, b in zip(_paths(from_jax(jp, "cpu")), *grads):
        torch.testing.assert_close(a, b, **REMAT_TOL, msg=name)
