"""The port's data-parallel OBFTF step and train CLI against the JAX
package's, on four ranks.

Four gloo ranks (``tests/_torch_ranks.py``, torch and ``repro_torch``
only) run the port's ``make_train_step(mesh=)`` for two steps of each
``DP_CASES`` case on the smoke llama3-8b config in float32, each rank on
its 8 rows of a 32-row batch, with ZeRO-1 AdamW moments (SGD in one case).
The reference is JAX's ``make_train_step(mesh=Mesh(4 CPU devices))``,
computed in one subprocess under
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (the pytest process
keeps its one-device view; a second such process runs the JAX CLI). The ranks import no JAX: the parent records
each rank's draws, ``fold_in(split(rng, 3)[1], rank)`` (the global
selection's: the unfolded key), and hands them over in an npz.

Tolerances are ``test_torch_train.py``'s: per-example losses (the ranks'
segments concatenated) rtol 1e-5 and fresh masks equal; kept, step cost
and the kept rows' global indices equal; loss rtol 1e-5, residual atol
1e-4, grad norm rtol 1e-4; params after two steps atol 1e-6, except where
AdamW's update is a sign of f32 noise (a grad below 1e-6 in either step,
read from JAX's first moments; ``test_torch_moe.py``'s rule), held to the
updates' size, 2 lr a step. Every rank's params and gathered moments have
the same bits. The params are FSDP-placed, as the JAX trainer places them:
each rank holds its quarter of every leaf whose JAX param spec names
``data`` (the dims of ``param_partition_specs``), and the params and
moments are compared gathered whole. One case, ``obftf-int8``, holds the
params in a layout of ``FSDP_RULES`` with ``int8_gather`` (every layer's
weights int8-quantized, in the selection forward too) against JAX's step
traced under ``use_rules(mesh, FSDP_RULES with int8_gather)``, at the
same tolerances.

The same ranks and JAX subprocesses also check the int8 collectives: the
int8 ring all-reduce equals JAX's under ``shard_map`` rank by rank, bit
for bit; the int8 ZeRO-3 gather's values equal JAX's on the (4, 1) mesh
bit for bit, sliced leaves and a leaf held whole, and its grads JAX's
(whose cotangent is the sum of the ranks' partial cotangents) within the
bounds ``test_int8_zero3_gather_equals_jax`` states. And one full-method SGD step of the hybrid smoke config in f32 with remat
(the shared block gathered a use, its grads reduce-scattered a use) against
the port's mesh-less step on the whole batch, computed in the parent.

Then the train CLI on the four ranks (``--model-parallel 1``) against the
JAX CLI on the 4 devices, both resuming one checkpoint of the JAX CLI's
initial bf16 state: ``--method full``, recycled maxk on the device
ledger pinned and routed through a2a at capacity factor 0.125, and on the
host ledger (every rank's ``LossHistory`` fed the gathered losses). Last,
the hazards: a checkpoint of the four ranks resumed on four, one and two,
a sharded table resumed from a checkpoint, a SIGTERM on one rank, the
refusals of ``--model-parallel`` and of batches that do not divide.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as R
from repro import configs as jconfigs
from repro import optim as JO
from repro.checkpoint import save_checkpoint as jsave
from repro.data import DataConfig, SyntheticLMStream
from repro.models import model as JM
from repro.models.params import materialize as jmaterialize
from repro_torch import obs
from repro_torch.launch import train

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-6
SMALL_GRAD = 1e-6
# the CLIs run the smoke config in bf16 (params and compute): the two
# packages' forwards round differently, a few bf16 ulps (2^-8) apart
CLI_RTOL = 1e-2

SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro import configs, optim as JO
from repro.core import obftf as JOB
from repro.core.selection import SelectionConfig
from repro.launch import train as jtrain
from repro.models import model as JM

out_dir, part = sys.argv[1:]
spec = json.load(open(os.path.join(out_dir, "dp_spec.json")))
assert jax.device_count() == 4
mesh = Mesh(np.asarray(jax.devices()).reshape(4, 1), ("data", "model"))
inp = dict(np.load(os.path.join(out_dir, "dp_inputs.npz")))
if part == "cli":
    for name, extra in spec["cli"].items():
        assert jtrain.main(spec["argv"] + extra + [
            "--ckpt-dir", os.path.join(out_dir, f"ck-jax-{name}"),
            "--resume", "auto",
            "--json-out", os.path.join(out_dir, f"jax-{name}.json"),
            "--ledger-out", os.path.join(out_dir, f"jax-{name}.npz")]) == 0
    # the int8 ring (each device's result) and the int8 ZeRO-3 gather
    from jax.sharding import PartitionSpec as P
    from repro.distributed import compression as JC, sharding as JS
    from repro.distributed.compat import shard_map
    ring = jax.jit(shard_map(
        lambda a: JC.int8_ring_all_reduce(a[0], "data")[None], mesh=mesh,
        in_specs=P("data"), out_specs=P("data")))
    out = {"int8/ring": np.asarray(ring(jnp.asarray(inp["int8/ring/x"])))}
    for name, (_, _, _, _, chunk, dtype) in spec["int8"].items():
        w = jnp.asarray(inp[f"int8/{name}/w"]).astype(dtype)
        c = jnp.asarray(sum(inp[f"int8/{name}/c{r}"] for r in range(4)))
        gather = lambda w: JS._int8_zero3_gather(w, mesh, chunk)
        out[f"int8/{name}/value"] = np.asarray(
            jax.jit(gather)(w).astype(jnp.float32))
        out[f"int8/{name}/grad"] = np.asarray(jax.jit(jax.grad(
            lambda w: jnp.sum(gather(w).astype(jnp.float32) * c)))(w)
            .astype(jnp.float32))
    np.savez(os.path.join(out_dir, "jax-int8.npz"), **out)
    sys.exit(0)
cfg = dataclasses.replace(configs.get_smoke("llama3-8b"),
                          param_dtype="float32", compute_dtype="float32")
specs = JM.param_specs(cfg)
flat = jax.tree_util.tree_flatten_with_path(
    specs, is_leaf=lambda x: hasattr(x, "axes"))[0]
paths = ["/".join(k.key for k in p) for p, _ in flat]
treedef = jax.tree_util.tree_structure(
    specs, is_leaf=lambda x: hasattr(x, "axes"))
params = jax.tree_util.tree_unflatten(
    treedef, [jnp.asarray(inp["params/" + p]) for p in paths])
batch = {k: jnp.asarray(inp["batch/" + k])
         for k in ("tokens", "labels", "recorded_loss", "instance_id")}
import contextlib
from repro.distributed import sharding as JS
plain_evals = jax.jit(JOB.make_eval_step(JM.loss_fn(cfg)))
out = {}
for case, (mode, method, ratio, recycle, local, opt,
           int8) in spec["cases"].items():
  # the int8 case traces its steps (the selection forward's too) under
  # the int8 rules, as the JAX dryrun's fsdp int8 strategy runs
  with (JS.use_rules(mesh, dataclasses.replace(JS.FSDP_RULES,
                                               int8_gather=True))
        if int8 else contextlib.nullcontext()):
    evals = (jax.jit(JOB.make_eval_step(JM.loss_fn(cfg))) if int8
             else plain_evals)
    sel = SelectionConfig(method=method, ratio=ratio)
    o = (JO.sgd_momentum(JO.constant(0.05), momentum=0.9) if opt == "sgd"
         else JO.adamw(JO.constant(spec["lr"]),
                       JO.AdamWConfig(weight_decay=0.1)))
    step = jax.jit(JOB.make_train_step(
        JM.loss_fn(cfg), o, JOB.OBFTFConfig(
            selection=sel, recycle_forward=recycle, mode=mode,
            shard_local=local), mesh=mesh, dp_axes=("data",)))
    pick = jax.jit(lambda k, l, b: JOB.select_and_gather(
        sel, k, l, b, mesh=mesh if local else None)[1])
    state = {"params": params, "opt": o.init(params),
             "step": jnp.zeros((), jnp.int32)}
    for t in range(spec["steps"]):
        rng = jax.random.fold_in(jax.random.key(5), t)
        if mode != "full":
            losses = (batch["recorded_loss"] if recycle
                      else evals(state["params"], batch, rng))
            out[f"{case}/{t}/selected"] = np.asarray(
                pick(jax.random.split(rng, 3)[1], losses, batch))
        state, m = step(state, batch, rng)
        for k, v in m.items():
            out[f"{case}/{t}/{k}"] = np.asarray(v)
        for p, x in zip(paths, jax.tree.leaves(state["opt"]["m"])):
            out[f"{case}/{t}/m/{p}"] = np.asarray(x)
    for p, x in zip(paths, jax.tree.leaves(state["params"])):
        out[f"{case}/params/{p}"] = np.asarray(x)
np.savez(os.path.join(out_dir, "jax-steps.npz"), **out)
"""


@pytest.fixture(autouse=True)
def telemetry_off():
    yield
    obs.install(obs.OFF)


def _flat(tree, prefix):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {prefix + "/".join(k.key for k in p): np.asarray(x)
            for p, x in flat}


def _inputs(out_dir: Path) -> None:
    """The parent's part: f32 params, the global batch and every rank's
    draws for the step cases; the JAX CLI's initial state as a checkpoint
    for both CLIs to resume."""
    cfg = jconfigs.get_smoke("llama3-8b")
    jcfg = dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")
    params = jax.jit(lambda k: jmaterialize(JM.param_specs(jcfg), k,
                                            jnp.float32))(jax.random.key(0))
    raw = SyntheticLMStream(DataConfig(R.DP_N, R.DP_SEQ, jcfg.vocab_size,
                                       seed=4)).batch(0)
    labels = raw["labels"].copy()
    labels[1, -3:] = -1  # masked positions, in two ranks' segments
    labels[13, -2:] = -1
    rs = np.random.default_rng(2)
    inp = _flat(params, "params/")
    inp.update({"batch/tokens": raw["tokens"], "batch/labels": labels,
                "batch/instance_id": raw["instance_id"].astype(np.int32),
                "batch/recorded_loss": rs.uniform(1, 9, R.DP_N).astype(
                    np.float32)})
    n_local = R.DP_N // R.WORLD
    for t in range(R.DP_STEPS):
        ksel = jax.random.split(jax.random.fold_in(jax.random.key(5), t),
                                3)[1]
        keys = {f"rank{r}": (jax.random.fold_in(ksel, r), n_local)
                for r in range(R.WORLD)}
        keys["global"] = (ksel, R.DP_N)
        for who, (k, n) in keys.items():
            inp[f"draws/{t}/{who}/perm"] = np.asarray(
                jax.random.permutation(k, n))
            inp[f"draws/{t}/{who}/gumbel"] = np.asarray(
                jax.random.gumbel(k, (n,), dtype=jnp.float32))
            inp[f"draws/{t}/{who}/normal"] = np.asarray(
                jax.random.normal(k, (), dtype=jnp.float32))
    # each rank's term of the int8 ring (one all-zero chunk, one rank's
    # terms 1000 times another's); each int8 gather's leaf and the ranks'
    # partial cotangents
    x = rs.standard_normal((R.WORLD,) + R.RING_SHAPE).astype(np.float32)
    x[1] *= 1000.0
    x[2].reshape(-1)[256:512] = 0.0
    inp["int8/ring/x"] = x
    for name, (_, _, shape, _, _, _) in R.INT8_CASES.items():
        inp[f"int8/{name}/w"] = rs.standard_normal(shape).astype(np.float32)
        for r in range(R.WORLD):
            inp[f"int8/{name}/c{r}"] = rs.standard_normal(shape).astype(
                np.float32)
    np.savez(out_dir / "dp_inputs.npz", **inp)
    (out_dir / "dp_spec.json").write_text(json.dumps({
        "cases": R.DP_CASES, "steps": R.DP_STEPS, "lr": R.DP_LR,
        "argv": R.CLI, "cli": R.CLI_RUNS, "int8": R.INT8_CASES}))
    # the JAX CLI's state before its first step (seed 0, bf16)
    p0 = jmaterialize(JM.param_specs(cfg), jax.random.key(0),
                      jnp.dtype(cfg.param_dtype))
    opt = JO.adamw(JO.constant(1e-3)).init(p0)
    state = jax.tree.map(np.asarray, {"params": p0, "opt": opt,
                                      "step": jnp.zeros((), jnp.int32)})
    jsave(str(out_dir / "ck0"), 0, state)
    for name in R.CLI_RUNS:
        for who in ("port", "jax"):
            shutil.copytree(out_dir / "ck0", out_dir / f"ck-{who}-{name}")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp")
    _inputs(out)
    env = {"PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "HOME": str(out), "TMPDIR": str(out), "OMP_NUM_THREADS": "1",
           "PATH": os.environ.get("PATH", "/usr/bin:/bin")}
    # the JAX steps and the JAX CLI runs, in two processes beside the ranks
    jprocs = [subprocess.Popen([sys.executable, "-c", SCRIPT, str(out), part],
                               env=env, cwd=ROOT, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
              for part in ("steps", "cli")]
    procs = R.start("train", out)
    # the mesh-less references, beside the ranks
    plain = {case: R.hybrid_step(case) for case in ("plain", "tied")}
    ranks = R.finish(procs, "train", out, timeout=150)
    for p in jprocs:
        log, _ = p.communicate(timeout=150)
        assert p.returncode == 0, log
    ref = dict(np.load(out / "jax-steps.npz"))
    ref.update(np.load(out / "jax-int8.npz"))
    return out, ranks, ref, plain


def _paths(ref: dict, prefix: str) -> list[str]:
    return sorted(k[len(prefix):] for k in ref if k.startswith(prefix))


@pytest.mark.parametrize("case", list(R.DP_CASES))
def test_dp_step_matches_jax_on_four_ranks(runs, case):
    _, ranks, ref, _ = runs
    mode, _, ratio, recycle, _, opt, int8 = R.DP_CASES[case]
    if int8:  # the quantization moves JAX's losses far past the tolerance
        a, b = (ref[f"{c}/0/per_example_loss"] for c in ("obftf-noise", case))
        assert np.abs(a - b).max() > 100 * LOSS_RTOL * np.abs(a).max()
    for t in range(R.DP_STEPS):
        key = f"{case}/{t}/"
        got = np.concatenate([r[key + "per_example_loss"] for r in ranks])
        np.testing.assert_allclose(got, ref[key + "per_example_loss"],
                                   rtol=LOSS_RTOL, err_msg=key)
        np.testing.assert_array_equal(
            np.concatenate([r[key + "per_example_fresh"] for r in ranks]),
            ref[key + "per_example_fresh"], err_msg=key)
        for r, out in enumerate(ranks):
            for k in ("kept", "step_cost"):
                assert float(out[key + k]) == float(ref[key + k]), (key, k)
            for k in ("loss", "selected_mean_loss"):
                np.testing.assert_allclose(out[key + k], ref[key + k],
                                           rtol=LOSS_RTOL, err_msg=key + k)
            np.testing.assert_allclose(out[key + "selection_residual"],
                                       ref[key + "selection_residual"],
                                       atol=1e-4, err_msg=key)
            np.testing.assert_allclose(out[key + "grad_norm"],
                                       ref[key + "grad_norm"], rtol=1e-4,
                                       err_msg=key)
            want = (np.arange(R.DP_N) if mode == "full"
                    else ref[key + "selected"])
            np.testing.assert_array_equal(out[key + "selected"], want,
                                          err_msg=f"{key} rank {r}")
    if case == "ratio-0.3":  # S * budget(n_local), not budget(n)
        assert float(ranks[0][f"{case}/0/kept"]) == 8 != round(0.3 * R.DP_N)
    # params after the steps; AdamW turns a grad below SMALL_GRAD into a
    # visible step of f32 noise, so those entries are held to 2 lr a step
    for p in _paths(ref, f"{case}/params/"):
        want = ref[f"{case}/params/{p}"]
        diff = np.abs(ranks[0][f"{case}/params/{p}"] - want)
        small = np.zeros(want.shape, bool)
        if opt == "adamw":
            m_prev = 0.0
            for t in range(R.DP_STEPS):
                m = ref[f"{case}/{t}/m/{p}"]
                small |= np.abs((m - 0.9 * m_prev) / 0.1) < SMALL_GRAD
                m_prev = m
        assert diff[~small].max(initial=0.0) <= PARAM_ATOL, (case, p)
        assert diff[small].max(initial=0.0) <= 2 * R.DP_LR * R.DP_STEPS, p
    # every rank holds the same params and (gathered) moments, bit for bit
    keys = [k for k in ranks[0] if k.startswith(f"{case}/")
            and k.split("/")[1] in ("params", "m", "v")]
    assert keys
    for out in ranks[1:]:
        for k in keys:
            np.testing.assert_array_equal(out[k], ranks[0][k], err_msg=k)


def test_each_rank_holds_a_quarter_of_each_sliced_leaf(runs):
    """The params a rank holds: of each leaf whose JAX param spec on the
    (4, 1) mesh names ``data``, a quarter of that dim; the others whole."""
    from jax.sharding import PartitionSpec

    from repro.distributed import sharding as JS
    from repro.models.params import is_spec

    _, ranks, _, _ = runs
    jcfg = dataclasses.replace(jconfigs.get_smoke("llama3-8b"),
                               param_dtype="float32", compute_dtype="float32")
    jspecs = JM.param_specs(jcfg)
    parts = JS.param_partition_specs(jspecs, JS.DEFAULT_RULES, type(
        "M", (), {"shape": {"data": R.WORLD, "model": 1}})())
    flat = jax.tree_util.tree_flatten_with_path(
        parts, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    shapes = {"/".join(k.key for k in p): s.shape for p, s in
              jax.tree_util.tree_flatten_with_path(jspecs, is_leaf=is_spec)[0]}
    sliced = 0
    for p, spec in flat:
        path = "/".join(k.key for k in p)
        want = list(shapes[path])
        for i, a in enumerate(spec):
            if a == "data":
                want[i] //= R.WORLD
                sliced += 1
        for out in ranks:
            assert list(out["held/" + path]) == want, path
    assert sliced == len(flat)  # every llama leaf has an FSDP'd embed dim


def test_int8_ring_all_reduce_equals_jax_rank_by_rank(runs):
    _, ranks, ref, _ = runs
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["int8/ring"], ref["int8/ring"][r],
                                      err_msg=f"rank {r}")
    # the ring order differs between ranks: not the same bits everywhere
    assert any(not np.array_equal(out["int8/ring"], ranks[0]["int8/ring"])
               for out in ranks[1:])


@pytest.mark.parametrize("name", list(R.INT8_CASES))
def test_int8_zero3_gather_equals_jax(runs, name):
    """Values bit for bit on every rank. The grads against JAX's bf16(c),
    c = sum_r c_r (``sharding._Int8Gather``'s doc gives the orders): a
    sliced f32 leaf's (the ranks' quarters joined) is bf16 of the f32
    reduce-scatter, so within one bf16 ulp of JAX's where the f32 sums'
    order crosses a rounding boundary, and equal elsewhere; a leaf held
    whole (the ranks' grads summed, as the step's all-reduce sums them) is
    the unrounded sum, within JAX's rounding, 2^-8 |c|; a bf16 leaf's
    partial cotangents are bf16 already, so within the roundings of the
    partials, the sum and JAX's, (S + 1) 2^-8 sum_r |c_r|."""
    out_dir, ranks, ref, _ = runs
    _, _, shape, dim, _, dtype = R.INT8_CASES[name]
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out[f"int8/{name}/value"],
                                      ref[f"int8/{name}/value"],
                                      err_msg=f"rank {r}")
    grads = [out[f"int8/{name}/grad"] for out in ranks]
    got = sum(grads) if dim is None else np.concatenate(grads, dim)
    inp = np.load(out_dir / "dp_inputs.npz")
    mag = sum(np.abs(inp[f"int8/{name}/c{r}"]) for r in range(R.WORLD))
    want = ref[f"int8/{name}/grad"]
    err = np.abs(got - want)
    if dtype == "bfloat16":
        assert (err <= (R.WORLD + 1) * 2.0**-8 * mag).all(), err.max()
    elif dim is None:
        bound = 2.0**-8 * (1 + 2.0**-7) * np.abs(want) + 2.0**-24 * mag
        assert (err <= bound).all(), (err - bound).max()
    else:
        bound = 2.0**-7 * np.abs(want) + 2.0**-24 * mag
        assert (err <= bound).all(), (err - bound).max()
        assert (err == 0).mean() > 0.99, (err == 0).mean()
    w = inp[f"int8/{name}/w"]
    assert got.shape == w.shape == shape
    # the gather is within a chunk's max|w| / 127 of the leaf
    assert np.abs(ref[f"int8/{name}/value"] - w).max() <= \
        np.abs(w).max() / 127


@pytest.mark.parametrize("case", ["plain", "tied"])
def test_hybrid_step_on_four_ranks_equals_the_mesh_less_step(runs, case):
    """The shared attention block is gathered at each of its uses and its
    grad is the sum of their reduce-scattered grads (with tied embeddings,
    the table gathered once for both uses): per-example losses and the
    loss rtol 1e-5, grad norm rtol 1e-4, the params after the SGD step
    atol 1e-6, gathered on every rank."""
    _, ranks, _, plain = runs
    m, params = plain[case]
    key = f"hybrid/{case}/"
    np.testing.assert_allclose(
        np.concatenate([r[key + "per_example_loss"] for r in ranks]),
        m["per_example_loss"], rtol=LOSS_RTOL)
    want = R._flat(params, key + "params/")
    assert any("shared_attn" in k for k in want)
    assert (key + "params/lm_head" in want) == (case == "plain")
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out[key + "loss"], m["loss"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(out[key + "grad_norm"], m["grad_norm"],
                                   rtol=1e-4)
        for k, v in want.items():
            np.testing.assert_allclose(out[k], v, rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"{k} rank {r}")


def test_int8_rules_reach_the_steps_gathers(runs):
    """The hybrid's step with its params in a layout of ``FSDP_RULES`` with
    ``int8_gather``: every layer's weights (the ssm layers' leaves held
    whole and the shared block's too) come int8-quantized (within
    max|w|/127 a chunk), so the loss moves off the plain step's, by less
    than 1 %."""
    _, ranks, _, plain = runs
    want = float(plain["plain"][0]["loss"])
    for out in ranks:
        got = float(out["hybrid/int8/loss"])
        assert got != want and abs(got - want) <= 1e-2 * abs(want)


def _summary(out: Path, name: str) -> dict:
    return json.loads((out / f"{name}.json").read_text())


@pytest.mark.parametrize("name", list(R.CLI_RUNS))
def test_cli_on_four_ranks_matches_the_jax_cli(runs, name):
    out, _, _, _ = runs
    got, want = _summary(out, f"port-{name}"), _summary(out, f"jax-{name}")
    for k in ("steps", "mean_step_cost", "ledger_hits_first",
              "ledger_hits_mean", "a2a_overflow", "exchange",
              "capacity_factor", "method"):
        assert got[k] == want[k], k
    for k in ("loss_first", "loss_last"):
        np.testing.assert_allclose(got[k], want[k], rtol=CLI_RTOL, err_msg=k)
    if name == "a2a":
        assert got["a2a_overflow"] > 0
    if name in ("pinned", "host"):
        assert got["ledger_hits_mean"] > 0
    sd, jsd = (dict(np.load(out / f"{w}-{name}.npz")) for w in ("port",
                                                                 "jax"))
    assert set(sd) == set(jsd)
    for k in sd:
        if k == "ema":
            np.testing.assert_allclose(sd[k], jsd[k], rtol=CLI_RTOL)
        else:
            np.testing.assert_array_equal(sd[k], jsd[k], err_msg=k)
    assert (sd["owner"] >= 0).sum() > 0


def test_a_sharded_ledger_resumes_from_a_checkpoint_of_four_ranks(runs):
    """The pinned run's final checkpoint holds its table (``pinned_shards``
    4); resumed on the four ranks, the first batch hits it."""
    from repro_torch.checkpoint import load_ledger

    out, _, _, _ = runs
    sd = load_ledger(str(out / "ck-port-pinned"), 4)
    assert int(sd["pinned_shards"]) == R.WORLD
    s = _summary(out, "port-pinned-resumed")
    assert s["steps"] == 2 and s["ledger_hits_first"] > 0


def test_cli_on_four_ranks_has_the_jax_summary_keys(runs):
    from test_torch_train import _jax_summary_names

    out, _, _, _ = runs
    s = _summary(out, "port-obftf")
    names = _jax_summary_names()
    assert names["summary"] <= set(s)
    assert names["health"] == set(s["health"])
    assert s["steps"] == 3 and s["mean_step_cost"] == pytest.approx(1.75)
    assert s["guarded_steps"] == 0
    assert np.isfinite([s["loss_first"], s["loss_last"]]).all()


def test_a_checkpoint_of_four_ranks_resumes_on_one_and_on_two(runs,
                                                               monkeypatch):
    """``--method full``, so the selection cannot differ: the four ranks'
    checkpoint at step 2 of 4 resumed on four, one and two ranks, against
    their uninterrupted run. On four the run is the same, bit for bit.
    On one and two the restored state gives step 2's loss (rtol 1e-5: the
    batch mean summed in another order); step 3's differs more, since the
    bf16 grads of step 2 are summed over another number of ranks and
    round differently (rtol 1e-4)."""
    from repro.checkpoint import manager as JCK
    from repro_torch.obs import read_jsonl

    out, _, _, _ = runs
    ck = out / "ck-save"
    # the JAX manager reads it as its own: full moments, one-device layout
    assert JCK.latest_step(str(ck)) == 4
    cfg = jconfigs.get_smoke("llama3-8b")
    p0 = jax.eval_shape(lambda: jmaterialize(
        JM.param_specs(cfg), jax.random.key(0), jnp.dtype(cfg.param_dtype)))
    target = jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), {
        "params": p0, "opt": jax.eval_shape(JO.adamw(JO.constant(1.0)).init,
                                            p0),
        "step": jax.ShapeDtypeStruct((), jnp.int32)})
    got = JCK.load_checkpoint(str(ck), 2, target)
    assert int(got["step"]) == int(got["opt"]["step"]) == 2
    for k in ("m", "v"):
        for x, t in zip(jax.tree.leaves(got["opt"][k]),
                        jax.tree.leaves(target["opt"][k])):
            assert x.shape == t.shape and np.isfinite(x).all()
    want = _summary(out, "full4")
    loss2 = [e["loss"] for e in read_jsonl(str(out / "full4.jsonl"))
             if e.get("kind") == "loop_health" and e["steps"] == 3][0]
    four = _summary(out, "resume4")
    assert (four["steps"], four["loss_first"], four["loss_last"]) == \
        (2, loss2, want["loss_last"])
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    shutil.copytree(ck, out / "ck-resume1")
    one = out / "resume1.json"
    assert train.main(R.FULL + [
        "--steps", "4", "--resume", "2", "--ckpt-dir",
        str(out / "ck-resume1"), "--json-out", str(one)]) == 0
    shutil.copytree(ck, out / "ck-resume")
    R.finish(R.start("resume", out, world=2), "resume", out)
    for got in (json.loads(one.read_text()), _summary(out, "resume")):
        assert got["steps"] == 2  # steps 2 and 3
        np.testing.assert_allclose(got["loss_first"], loss2, rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["loss_last"], want["loss_last"],
                                   rtol=1e-4)


def test_a_sigterm_on_one_rank_stops_every_rank_after_the_same_step(runs):
    from repro_torch.checkpoint import latest_step

    out, _, _, _ = runs
    s = _summary(out, "term")
    assert s["steps"] == 1
    assert latest_step(str(out / "ck-term")) == 1
    assert sorted(os.listdir(out / "ck-term")) == ["step_0000000001"]


@pytest.mark.parametrize("mp,ranks", [(0, 2), (2, 2), (2, 1)])
def test_model_parallel_is_refused_before_any_group(monkeypatch, mp, ranks):
    import torch.distributed as dist

    monkeypatch.setenv("WORLD_SIZE", str(ranks))
    with pytest.raises(SystemExit, match="Queue 1 item 2"):
        train.main(R.FULL + ["--model-parallel", str(mp)])
    assert not dist.is_initialized()


def test_a_batch_that_does_not_divide_is_refused():
    """``validate_batch`` and the feed's split refuse a global batch that
    does not divide over the ranks; global selection refuses a kept count
    that does not divide (before any collective)."""
    import types

    from repro_torch.core import obftf as OB
    from repro_torch.core.selection import SelectionConfig
    from repro_torch.data import local_rows
    from repro_torch.distributed.zero import data_layout
    from repro_torch.launch.mesh import validate_batch
    from repro_torch.models import model as M
    from repro_torch.optim import constant, sgd_momentum

    mesh = types.SimpleNamespace(shape={"data": 4, "model": 1})
    assert validate_batch(32, mesh) == 8
    with pytest.raises(ValueError, match="not divisible by 4"):
        validate_batch(30, mesh)
    with pytest.raises(ValueError, match="does not divide"):
        local_rows({"tokens": np.zeros((30, 4))}, 0, 4)
    cfg = R.dp_config()
    opt = sgd_momentum(constant(0.1), layout=data_layout(
        M.param_specs(cfg), mesh, 0))
    step = OB.make_train_step(
        M.loss_fn(cfg), opt, OB.OBFTFConfig(
            SelectionConfig(ratio=0.3), shard_local=False), mesh=mesh)
    batch = {"tokens": torch.zeros((8, 4), dtype=torch.int64),
             "labels": torch.zeros((8, 4), dtype=torch.int64)}
    with pytest.raises(ValueError, match="keeps 10 rows of 32"):
        step({"params": {}, "opt": {}, "step": torch.zeros(())}, batch, None)
