"""The port's (data, model) mesh and tensor-parallel OBFTF step and train
CLI against the JAX package's, on four ranks.

Four gloo ranks (``tests/_torch_ranks.py``'s ``tp`` scenario, torch and
``repro_torch`` only) run the port's ``make_train_step(mesh=)`` for two
AdamW steps of each ``TP_CASES`` case, each on a mesh of (1, 4) or (2, 2)
from ``make_elastic_mesh``: the params placed as JAX's ``state_specs``
places them under ``DEFAULT_RULES`` (heads, kv heads, MLP columns and
vocab rows cut over ``model`` where they divide, the ``embed`` dims over
``data``), in all three head layouts: (a) heads and kv heads cut, (b)
heads cut and kv heads whole (the smoke llama3-8b at M = 4, granite-34b's
MQA), (c) heads whole (6 heads over 4), and with ``qk_norm`` in (a) and
(b) (``q_norm`` and ``k_norm`` inside the region, or ``k_norm`` before
it). The reference is JAX's
``make_train_step(mesh=)`` on the same mesh of 4 CPU devices, jitted with
the state's shardings under ``use_rules(mesh, DEFAULT_RULES)``, in two
subprocesses under ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
(a third runs the JAX CLIs), beside the ranks. The parent records each
data row's draws, ``fold_in(split(rng, 3)[1], data index)``.

Tolerances are ``test_torch_dp_train.py``'s: in f32 the per-example
losses, the loss and ``grad_norm`` rtol 1e-5, the params after two steps
atol 1e-6 but where AdamW's update is the sign of f32 noise (a grad below
1e-6 in either step), held to 2 lr a step; the bf16 case within 2^-7
relative of JAX's (losses and grad norm; the params, whose steps are lr
apart, within 2^-7 of their size plus 2 lr a step). Each leaf's first
moment after the last step, which holds its grads' scale where AdamW's
update does not, against JAX's: in f32 rtol 1e-5 with an atol of 1e-5 of
the leaf's largest entry, in bf16 a relative L2 of 2^-5. The kept rows equal
JAX's and are the same on every rank of a model group, and every rank
holds the same params and moments once gathered. Then the vocab-parallel
loss against JAX's ``per_token_loss`` (labels -1, 0, V-1 and each slice's
borders), the train CLI with ``--model-parallel 0`` and ``2`` against
JAX's CLI, a (2, 2) checkpoint restored on (1, 4), (4, 1) and one rank,
the mesh's shapes and coordinates against JAX's ``make_elastic_mesh``, the
serve CLI's mesh, and the refusals.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import types
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
from repro_torch.launch import serve, train

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-6
SMALL_GRAD = 1e-6
BF16_RTOL = 2.0**-7
CLI_RTOL = 1e-2  # the CLIs' bf16 smoke runs (test_torch_dp_train's)
# a bf16 leaf's first moment, relative L2 against JAX's: its grads are
# bf16 matmuls whose partial sums both sides round in another order (found
# 0.0163 at most, on (2, 2)); a grad summed over the model axis twice, or
# not at all, would be off by 1 or 0.5
BF16_MOMENT_RTOL = 2.0**-5

SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro import configs, optim as JO
from repro.core import obftf as JOB
from repro.core.selection import SelectionConfig
from repro.distributed.sharding import DEFAULT_RULES, use_rules
from repro.launch.specs import state_specs
from repro.models import model as JM

out_dir, part = sys.argv[1:]
spec = json.load(open(os.path.join(out_dir, "tp_spec.json")))
assert jax.device_count() == 4
devs = jax.devices()
inp = dict(np.load(os.path.join(out_dir, "tp_inputs.npz")))
if part == "cli":
    from repro.launch import serve as jserve, train as jtrain
    from repro.launch.mesh import make_elastic_mesh
    meshes = {}
    for n in (1, 2, 4):
        for mp in (0, 1, 2, 4):
            try:
                m = make_elastic_mesh(devs[:n], mp)
            except ValueError as e:
                meshes[f"{n}/{mp}"] = str(e)
                continue
            pos = {int(d.id): [int(i) for i in np.argwhere(
                np.asarray(m.devices) == d)[0]] for d in devs[:n]}
            meshes[f"{n}/{mp}"] = [dict(m.shape), pos]
    json.dump(meshes, open(os.path.join(out_dir, "jax-meshes.json"), "w"))
    for name, extra in spec["cli"].items():
        assert jtrain.main(spec["argv"] + extra + [
            "--ckpt-dir", os.path.join(out_dir, f"ck-jax-{name}"),
            "--resume", "auto",
            "--json-out", os.path.join(out_dir, f"jax-{name}.json"),
            "--ledger-out", os.path.join(out_dir, f"jax-{name}.npz")]) == 0
    assert jserve.main(spec["serve"] + [
        "--json-out", os.path.join(out_dir, "serve-jax.json")]) == 0
    sys.exit(0)
out = {}
for case in spec["parts"][part]:
    arch, mp, mode, method, ratio, dtype, recycled = spec["cases"][case]
    name, extra = spec["archs"][arch]
    cfg = dataclasses.replace(configs.get_smoke(name), param_dtype=dtype,
                              compute_dtype=dtype, **extra)
    mesh = Mesh(np.asarray(devs).reshape(4 // mp, mp), ("data", "model"))
    specs = JM.param_specs(cfg)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: hasattr(x, "axes"))[0]
    paths = ["/".join(k.key for k in p) for p, _ in flat]
    treedef = jax.tree_util.tree_structure(
        specs, is_leaf=lambda x: hasattr(x, "axes"))
    params = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(inp[f"{arch}/params/{p}"]).astype(dtype) for p in paths])
    batch = {k: jnp.asarray(inp[f"{arch}/batch/{k}"])
             for k in ("tokens", "labels", "recorded_loss")}
    if not recycled:
        del batch["recorded_loss"]
    _, state_sh, _ = state_specs(cfg, mesh, DEFAULT_RULES)
    o = JO.adamw(JO.constant(spec["lr"]), JO.AdamWConfig(weight_decay=0.1))
    sel = SelectionConfig(method=method, ratio=ratio)
    with use_rules(mesh, DEFAULT_RULES):
        step = jax.jit(JOB.make_train_step(
            JM.loss_fn(cfg), o, JOB.OBFTFConfig(
                selection=sel, recycle_forward=recycled, mode=mode),
            mesh=mesh, dp_axes=("data",)), out_shardings=(state_sh, None))
        evals = jax.jit(JOB.make_eval_step(JM.loss_fn(cfg)))
        pick = jax.jit(lambda k, l, b: JOB.select_and_gather(
            sel, k, l, b, mesh=mesh)[1])
        state = jax.device_put({"params": params, "opt": o.init(params),
                                "step": jnp.zeros((), jnp.int32)}, state_sh)
        for t in range(spec["steps"]):
            rng = jax.random.fold_in(jax.random.key(5), t)
            if mode != "full":
                losses = (batch["recorded_loss"] if recycled
                          else evals(state["params"], batch, rng))
                out[f"{case}/{t}/selected"] = np.asarray(
                    pick(jax.random.split(rng, 3)[1], losses, batch))
            state, m = step(state, batch, rng)
            for k, v in m.items():
                out[f"{case}/{t}/{k}"] = np.asarray(v.astype(jnp.float32))
            for p, x in zip(paths, jax.tree.leaves(state["opt"]["m"])):
                out[f"{case}/{t}/m/{p}"] = np.asarray(x)
    for p, x in zip(paths, jax.tree.leaves(state["params"])):
        out[f"{case}/params/{p}"] = np.asarray(x.astype(jnp.float32))
np.savez(os.path.join(out_dir, f"jax-{part}.npz"), **out)
"""
# the JAX step cases, in two processes
PARTS = {"steps0": ["llama-b-obftf", "llama-b-full", "llama-a-obftf",
                    "llama-a-bf16"],
         "steps1": ["granite-b-full", "heads6-c-full", "musicgen-a-full",
                    "qknorm-a-full", "qknorm-b-full"]}


def _jax_config(arch: str, dtype: str = "float32"):
    name, extra = R.TP_ARCHS[arch]
    return dataclasses.replace(jconfigs.get_smoke(name), param_dtype=dtype,
                               compute_dtype=dtype, **extra)


def _flat(tree, prefix):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {prefix + "/".join(k.key for k in p): np.asarray(x)
            for p, x in flat}


def _inputs(out: Path) -> None:
    """The parent's part: f32 params and a batch a config (both sides take
    the same), each data row's draws a case, the vocab-parallel loss's inputs, and the JAX CLI's
    initial state as a checkpoint for both CLIs to resume."""
    from repro_torch.models import model as M
    from repro_torch.models.params import materialize

    inp = {}
    for arch in R.TP_ARCHS:
        cfg = _jax_config(arch)
        # f32 params from the seed (the port's draw, taken by both sides)
        inp.update(R._flat(materialize(M.param_specs(R.tp_config(
            arch, "float32")), 0, torch.float32, "cpu"), f"{arch}/params/"))
        raw = SyntheticLMStream(DataConfig(R.TP_N, R.TP_SEQ, cfg.vocab_size,
                                           seed=4)).batch(0)
        labels = raw["labels"].copy()
        labels[1, -3:] = -1  # masked positions, in both data rows
        labels[13, -2:] = -1
        inp[f"{arch}/batch/tokens"] = raw["tokens"]
        inp[f"{arch}/batch/labels"] = labels
        inp[f"{arch}/batch/recorded_loss"] = np.random.default_rng(2).uniform(
            1, 9, R.TP_N).astype(np.float32)
    for case, (_, mp, mode, *_rest) in R.TP_CASES.items():
        if mode == "full":
            continue
        rows = R.WORLD // mp
        for t in range(R.TP_STEPS):
            ksel = jax.random.split(jax.random.fold_in(jax.random.key(5), t),
                                    3)[1]
            for d in range(rows):
                k, n = jax.random.fold_in(ksel, d), R.TP_N // rows
                pre = f"draws/{case}/{t}/{d}/"
                inp[pre + "perm"] = np.asarray(jax.random.permutation(k, n))
                inp[pre + "gumbel"] = np.asarray(
                    jax.random.gumbel(k, (n,), dtype=jnp.float32))
                inp[pre + "normal"] = np.asarray(
                    jax.random.normal(k, (), dtype=jnp.float32))
    rs = np.random.default_rng(6)
    v = _jax_config("llama").vocab_size
    labels = rs.integers(0, v, R.XENT_T)
    labels[:len(R.XENT_LABELS)] = R.XENT_LABELS
    inp["xent/logits"] = (3 * rs.standard_normal((R.XENT_T, v))).astype(
        np.float32)
    inp["xent/labels"] = labels
    inp["xent/cot"] = rs.standard_normal(R.XENT_T).astype(np.float32)
    np.savez(out / "tp_inputs.npz", **inp)
    (out / "tp_spec.json").write_text(json.dumps({
        "cases": R.TP_CASES, "archs": R.TP_ARCHS, "steps": R.TP_STEPS,
        "lr": R.DP_LR, "parts": PARTS, "argv": R.TP_CLI,
        "cli": R.TP_CLI_RUNS, "serve": R.TP_SERVE}))
    cfg = jconfigs.get_smoke("llama3-8b")  # the CLIs' state: bf16, seed 0
    p0 = jmaterialize(JM.param_specs(cfg), jax.random.key(0),
                      jnp.dtype(cfg.param_dtype))
    state = jax.tree.map(np.asarray, {
        "params": p0, "opt": JO.adamw(JO.constant(1e-3)).init(p0),
        "step": jnp.zeros((), jnp.int32)})
    jsave(str(out / "ck0"), 0, state)
    for name in R.TP_CLI_RUNS:
        for who in ("port", "jax"):
            shutil.copytree(out / "ck0", out / f"ck-{who}-{name}")


@pytest.fixture(autouse=True)
def telemetry_off():
    yield
    obs.install(obs.OFF)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp")
    _inputs(out)
    env = {"PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "HOME": str(out), "TMPDIR": str(out), "OMP_NUM_THREADS": "1",
           "PATH": os.environ.get("PATH", "/usr/bin:/bin")}
    jprocs = [subprocess.Popen([sys.executable, "-c", SCRIPT, str(out), part],
                               env=env, cwd=ROOT, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
              for part in ("cli", *PARTS)]
    procs = R.start("tp", out)
    tied = R.tied_step()  # the mesh-less reference, beside the ranks
    with pytest.MonkeyPatch.context() as mp:
        for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
            mp.delenv(k, raising=False)
        # the routed serve on a world of one, beside the ranks
        assert serve.main(R.TP_SERVE + [
            "--device", "cpu", "--json-out", str(out / "serve-one.json"),
            "--ledger-out", str(out / "serve-one.npz")]) == 0
        ranks = R.finish(procs, "tp", out, timeout=150)
        # the (2, 2) checkpoint resumed on one rank
        shutil.copytree(out / "ck-port-mp2", out / "ck-resume-1")
        assert train.main(R.TP_CLI + ["--device", "cpu"] + R.TP_RESUME + [
            "--ckpt-dir", str(out / "ck-resume-1"), "--json-out",
            str(out / "resume-1.json")]) == 0
    ref = {}
    for p in jprocs:
        log, _ = p.communicate(timeout=150)
        assert p.returncode == 0, log
    for part in PARTS:
        ref.update(np.load(out / f"jax-{part}.npz"))
    return out, ranks, ref, tied


def _summary(out: Path, name: str) -> dict:
    return json.loads((out / f"{name}.json").read_text())


def _paths(ref: dict, prefix: str) -> list[str]:
    return sorted(k[len(prefix):] for k in ref if k.startswith(prefix))


@pytest.mark.parametrize("case", list(R.TP_CASES))
def test_tp_step_matches_jax_on_four_ranks(runs, case):
    _, ranks, ref, _ = runs
    _, mp, mode, _, _, dtype, _ = R.TP_CASES[case]
    rows = R.WORLD // mp
    rtol = BF16_RTOL if dtype == "bfloat16" else LOSS_RTOL
    for t in range(R.TP_STEPS):
        key = f"{case}/{t}/"
        # a data row's segment, from its first model rank
        got = np.concatenate([ranks[d * mp][key + "per_example_loss"]
                              for d in range(rows)])
        np.testing.assert_allclose(got, ref[key + "per_example_loss"],
                                   rtol=rtol, err_msg=key)
        for r, out in enumerate(ranks):
            for k in ("kept", "step_cost"):
                assert float(out[key + k]) == float(ref[key + k]), (key, k)
            for k in ("loss", "selected_mean_loss", "grad_norm"):
                np.testing.assert_allclose(out[key + k], ref[key + k],
                                           rtol=rtol, err_msg=key + k)
            want = (np.arange(R.TP_N) if mode == "full"
                    else ref[key + "selected"])
            np.testing.assert_array_equal(out[key + "selected"], want,
                                          err_msg=f"{key} rank {r}")
            # a model group's ranks: the same rows, losses and metrics
            first = ranks[(r // mp) * mp]
            for k in ("selected", "per_example_loss", "loss", "grad_norm"):
                np.testing.assert_array_equal(out[key + k], first[key + k],
                                              err_msg=f"{key}{k} rank {r}")
    for p in _paths(ref, f"{case}/params/"):
        want = ref[f"{case}/params/{p}"]
        diff = np.abs(ranks[0][f"{case}/params/{p}"] - want)
        small = np.zeros(want.shape, bool)
        m_prev = 0.0
        for t in range(R.TP_STEPS):
            m = ref[f"{case}/{t}/m/{p}"].astype(np.float32)
            small |= np.abs((m - 0.9 * m_prev) / 0.1) < SMALL_GRAD
            m_prev = m
        noise = 2 * R.DP_LR * R.TP_STEPS
        if dtype == "bfloat16":
            assert (diff <= BF16_RTOL * np.abs(want) + noise).all(), p
            continue
        assert diff[~small].max(initial=0.0) <= PARAM_ATOL, (case, p)
        assert diff[small].max(initial=0.0) <= noise, (case, p)
    # each leaf's first moment holds its grads' scale, which AdamW's
    # update does not: a grad summed over the model axis once too often,
    # or not at all, shows here
    for p in _paths(ref, f"{case}/{R.TP_STEPS - 1}/m/"):
        want = ref[f"{case}/{R.TP_STEPS - 1}/m/{p}"].astype(np.float32)
        got = ranks[0][f"{case}/m/{p}"]
        if dtype == "bfloat16":
            err = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert err <= BF16_MOMENT_RTOL, (case, p, err)
            continue
        np.testing.assert_allclose(got, want, rtol=rtol,
                                   atol=rtol * np.abs(want).max(),
                                   err_msg=f"{case} m/{p}")
    keys = [k for k in ranks[0] if k.startswith(f"{case}/")
            and k.split("/")[1] in ("params", "m")]
    assert keys
    for out in ranks[1:]:
        for k in keys:
            np.testing.assert_array_equal(out[k], ranks[0][k], err_msg=k)


def _jax_parts(arch: str, shape: dict):
    from jax.sharding import PartitionSpec

    from repro.distributed import sharding as JS
    from repro.distributed import zero as JZ

    jspecs = JM.param_specs(_jax_config(arch))
    mesh = types.SimpleNamespace(shape=shape)
    flat = lambda t: {"/".join(k.key for k in p): s for p, s in
                      jax.tree_util.tree_flatten_with_path(
                          t, is_leaf=lambda x: isinstance(
                              x, PartitionSpec))[0]}
    shapes = {"/".join(k.key for k in p): s.shape for p, s in
              jax.tree_util.tree_flatten_with_path(
                  jspecs, is_leaf=lambda x: hasattr(x, "axes"))[0]}
    return (flat(JS.param_partition_specs(jspecs, JS.DEFAULT_RULES, mesh)),
            flat(JZ.zero1_partition_specs(jspecs, JS.DEFAULT_RULES, mesh)),
            shapes)


def _jax_piece(x: np.ndarray, spec, d: int, m: int, shape: dict):
    """Device (d, m)'s piece of a full leaf under a JAX partition spec (one
    mesh axis an entry, as ``DEFAULT_RULES`` give)."""
    at = {"data": d, "model": m}
    for i, a in enumerate(spec):
        if a is not None:
            n = x.shape[i] // shape[a]
            x = x[(slice(None),) * i + (slice(at[a] * n, (at[a] + 1) * n),)]
    return x


@pytest.mark.parametrize("case", list(R.TP_CASES))
def test_each_rank_holds_jaxs_pieces(runs, case):
    """The params a rank held in each case: of each leaf, device (d, m)'s
    piece under JAX's param spec on the case's mesh (the model slice, and
    the data slice of it)."""
    _, ranks, _, _ = runs
    arch, mp, *_ = R.TP_CASES[case]
    shape = {"data": R.WORLD // mp, "model": mp}
    parts, _, shapes = _jax_parts(arch, shape)
    cut = 0
    for path, spec in parts.items():
        full = np.zeros(shapes[path])
        for r, out in enumerate(ranks):
            d, m = divmod(r, mp)
            want = _jax_piece(full, spec, d, m, shape).shape
            assert tuple(out[f"{case}/held/{path}"]) == want, (path, r)
        cut += "model" in spec
    assert cut > 0


def test_layout_cuts_both_axes_in_jaxs_order():
    """On a (2, 2) mesh every rank's held params and ZeRO-1 moment slices
    are JAX's device pieces, bit for bit: the embedding [vocab, embed] cut
    (model, data), the data cut taken of the model slice."""
    from repro_torch import configs
    from repro_torch.distributed.zero import ALL, data_layout
    from repro_torch.models import model as M
    from repro_torch.models.params import materialize, tree_map

    shape = {"data": 2, "model": 2}
    parts, moments, _ = _jax_parts("llama", shape)
    assert parts["embed"] == ("model", "data")
    assert parts["blocks/attn/wk"] == (None, "data", "model", None)
    specs = M.param_specs(configs.get("llama3-8b", smoke=True))
    full = materialize(specs, 0, torch.float32, "cpu")
    x = {}
    tree_map(lambda p, t: x.__setitem__("/".join(p), t.numpy()), full)
    mesh = types.SimpleNamespace(shape=shape)
    for r in range(4):
        d, m = divmod(r, 2)
        lay = data_layout(specs, mesh, d, model_rank=m)
        held = {}
        tree_map(lambda p, x: held.__setitem__("/".join(p), x),
                 lay.hold(full))
        mom = {}
        tree_map(lambda p, x: mom.__setitem__("/".join(p), x),
                 lay.slice(lay.model_view(full), ALL))
        for path in parts:
            np.testing.assert_array_equal(
                held[path].numpy(),
                _jax_piece(x[path], parts[path], d, m, shape), path)
            np.testing.assert_array_equal(
                mom[path].numpy(),
                _jax_piece(x[path], moments[path], d, m, shape), path)


def test_vocab_parallel_loss_matches_jax_per_token_loss(runs):
    """Four slices of the llama smoke vocab through the cross-entropy
    kernel (its plain version here), combined: the loss on every rank and
    the slices' grads joined against JAX's ``per_token_loss`` and its
    grad, rtol 1e-5 (the global lse is a logsumexp of four, not of 256);
    masked labels give 0 and no grad."""
    out_dir, ranks, _, _ = runs
    inp = np.load(out_dir / "tp_inputs.npz")
    x, labels, cot = (jnp.asarray(inp[f"xent/{k}"])
                      for k in ("logits", "labels", "cot"))
    want, vjp = jax.vjp(lambda z: JM.per_token_loss(z[None], labels[None])[0],
                        x)
    (grad,) = vjp(cot)
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["xent/loss"], want, rtol=LOSS_RTOL,
                                   err_msg=f"rank {r}")
        np.testing.assert_array_equal(out["xent/loss"], ranks[0]["xent/loss"])
    got = np.concatenate([out["xent/grad"] for out in ranks], 1)
    np.testing.assert_allclose(got, grad, rtol=LOSS_RTOL, atol=1e-7)
    masked = np.asarray(labels) < 0
    assert masked.sum() == 2 and (ranks[0]["xent/loss"][masked] == 0).all()
    assert (got[masked] == 0).all()


@pytest.mark.parametrize("name", list(R.TP_CLI_RUNS))
def test_cli_on_four_ranks_matches_the_jax_cli(runs, name):
    out, ranks, _, _ = runs
    got, want = _summary(out, f"port-{name}"), _summary(out, f"jax-{name}")
    mp = 4 if name == "mp0" else 2
    mesh = f"mesh={{'data': {4 // mp}, 'model': {mp}}}"
    assert mesh in str(ranks[0][f"cli/{name}/said"])
    assert not str(ranks[1][f"cli/{name}/said"])  # rank 0 alone prints
    for k in ("steps", "mean_step_cost", "ledger_hits_first",
              "ledger_hits_mean", "a2a_overflow", "method"):
        assert got[k] == want[k], k
    for k in ("loss_first", "loss_last"):
        np.testing.assert_allclose(got[k], want[k], rtol=CLI_RTOL, err_msg=k)
    sd, jsd = (dict(np.load(out / f"{w}-{name}.npz")) for w in ("port",
                                                                 "jax"))
    assert set(sd) == set(jsd)
    for k in sd:
        if k == "ema":
            np.testing.assert_allclose(sd[k], jsd[k], rtol=CLI_RTOL)
        else:
            np.testing.assert_array_equal(sd[k], jsd[k], err_msg=k)
    if name == "mp2":  # the table sharded over the data axis of 2
        assert int(sd["pinned_shards"]) == 2 and got["ledger_hits_mean"] > 0


def test_a_checkpoint_of_2x2_resumes_on_1x4_4x1_and_one_rank(runs):
    """The (2, 2) run's final checkpoint restored into the layouts of
    (1, 4) and (4, 1) and gathered: its params and first moments bit for
    bit on every rank; the CLI resumed from it for a step on (1, 4) and on
    one rank: the same first loss within the bf16 runs' CLI_RTOL."""
    from repro.checkpoint import manager as JCK

    out, ranks, _, _ = runs
    ck = str(out / "ck-port-mp2")
    assert JCK.latest_step(ck) == 2
    with open(os.path.join(ck, "step_0000000002", "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    for key, meta in leaves.items():
        if not key.startswith(("params/", "opt/m/")):
            continue
        arr = np.load(os.path.join(ck, "step_0000000002", meta["file"]))
        if meta["dtype"] == "bfloat16":
            arr = (arr.view(np.uint16).astype(np.uint32) << 16).view(
                np.float32)
        k = key.replace("opt/m/", "m/")
        for mp in (4, 1):
            for r, got in enumerate(ranks):
                np.testing.assert_array_equal(
                    got[f"restore/{mp}/{k}"], arr, err_msg=f"{k} {mp} {r}")
    a, b = _summary(out, "resume-14"), _summary(out, "resume-1")
    assert a["steps"] == b["steps"] == 1
    np.testing.assert_allclose(a["loss_first"], b["loss_first"],
                               rtol=CLI_RTOL)


def test_mesh_shapes_and_coordinates_match_jax(runs):
    """``model_degree`` and the coordinates of each rank for worlds of 1,
    2 and 4 against JAX's ``make_elastic_mesh(devices[:n], mp)`` (rank i
    where JAX puts device i), its refusal message included; the four
    ranks' live meshes at their coordinates."""
    from repro_torch.launch.mesh import model_degree

    out, ranks, _, _ = runs
    meshes = json.loads((out / "jax-meshes.json").read_text())
    for key, want in meshes.items():
        n, mp = map(int, key.split("/"))
        if isinstance(want, str):
            with pytest.raises(ValueError, match=want):
                model_degree(n, mp)
            continue
        m = model_degree(n, mp)
        assert {"data": n // m, "model": m} == want[0], key
        for r in range(n):
            assert list(divmod(r, m)) == want[1][str(r)], (key, r)
            if n == R.WORLD:
                np.testing.assert_array_equal(
                    ranks[r][f"mesh/{mp}"], [*divmod(r, m), n // m, m])
    assert "4/0" in meshes and meshes["4/0"][0] == {"data": 1, "model": 4}


def test_serve_cli_builds_jaxs_mesh(runs):
    """``--ledger-route`` on four ranks: JAX's serve mesh (data 1, model
    4), so the table is whole, as on JAX's four devices (``shards`` 1, its
    a2a overflow) and equals the routed run's on a world of one."""
    out, _, _, _ = runs
    got, one = _summary(out, "serve-port"), _summary(out, "serve-one")
    jsum = _summary(out, "serve-jax")
    for k in ("shards", "a2a_overflow", "recorded", "routed", "exchange"):
        assert got[k] == jsum[k] == one[k], k
    assert got["shards"] == 1 and got["a2a_overflow"] > 0
    sd, sd1 = (dict(np.load(out / f"serve-{w}.npz")) for w in ("port",
                                                                "one"))
    for k in sd1:
        np.testing.assert_array_equal(sd[k], sd1[k], err_msg=k)


def test_a_tied_table_sums_both_uses_on_the_model_axis(runs):
    """The llama smoke config with its table tied to the head, on (1, 4):
    the table is cut over the vocab for both uses (embedding and head) and
    its grad is the sum of the two; one SGD step against the mesh-less
    step: loss and per-example losses rtol 1e-5, grad norm rtol 1e-5, the
    params atol 1e-6, gathered on every rank."""
    _, ranks, _, (m, params) = runs
    want = R._flat(params, "tied/params/")
    assert "tied/params/embed" in want and "tied/params/lm_head" not in want
    for r, out in enumerate(ranks):
        for k in ("loss", "grad_norm", "per_example_loss"):
            np.testing.assert_allclose(out[f"tied/{k}"], m[k], rtol=LOSS_RTOL,
                                       err_msg=f"{k} rank {r}")
        for k, v in want.items():
            np.testing.assert_allclose(out[k], v, rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"{k} rank {r}")


def test_model_axis_of_one_changes_nothing():
    """Without a mesh, or on a model axis of one, the region operations
    return their input (no group is set up here, so a collective would
    raise); ``activation_constraint`` is the identity while ``seq_axis``
    is None and raises with it set."""
    from repro_torch.distributed import sharding as S

    x, w = torch.randn(2, 3, requires_grad=True), torch.randn(3)
    assert S.enter(x) is x and S.leave(x) is x
    assert S.enter(x, w) == (x, w)
    assert S.model_place() == (0, 1) and not S.model_cut(("embed",))
    mesh = types.SimpleNamespace(shape={"data": 1, "model": 1})
    with S.use_rules(mesh, S.DEFAULT_RULES):
        assert S.activation_constraint(x, "residual") is x
    with S.use_rules(mesh, dataclasses.replace(S.DEFAULT_RULES,
                                               seq_axis="model")):
        with pytest.raises(NotImplementedError, match="sequence"):
            S.activation_constraint(x, "residual")


def test_a_layout_runs_only_under_its_mesh(monkeypatch):
    """The layout owns the model axis, and its collectives run over the
    registered mesh axes: a layout cut for another mesh than the one
    registered raises in ``enter``, ``leave``, ``model_gather`` and
    ``gather`` (rather than sum or gather the wrong pieces); a model axis
    above one needs the rank's model index; an axis of one with a group of
    its own still issues its collectives (the card's NCCL check), one
    without none; ``tensor_parallel_refusal`` refuses a kv group cut in
    parts and the families outside the dense one."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.distributed import compat
    from repro_torch.distributed import sharding as S
    from repro_torch.distributed.zero import data_layout
    from repro_torch.launch.mesh import make_elastic_mesh
    from repro_torch.models import model as M
    from repro_torch.models.params import materialize

    cfg = configs.get("llama3-8b", smoke=True)
    specs = M.param_specs(cfg)
    two = types.SimpleNamespace(shape={"data": 1, "model": 2})
    with pytest.raises(ValueError, match="model_rank"):
        data_layout(specs, two, 0)
    refuse = M.tensor_parallel_refusal
    assert refuse(cfg, 1) is None and refuse(cfg, 2) is None
    assert "kv group" in refuse(dataclasses.replace(
        cfg, num_heads=24, num_kv_heads=6), 4)
    assert "Queue 1 item 2" in refuse(configs.get("mamba2-370m", True), 2)
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    mesh = make_elastic_mesh(device="cpu")  # (1, 1)
    try:
        full = materialize(specs, 0, torch.float32, "cpu")
        lay = data_layout(specs, two, 0, model_rank=1)
        x = torch.randn(2, 3, requires_grad=True)
        with S.use_rules(mesh, S.DEFAULT_RULES, lay):
            for fn in (S.enter, S.leave):
                with pytest.raises(RuntimeError, match="rank 0 of 1"):
                    fn(x)
        with pytest.raises(RuntimeError, match="rank 0 of 1"):
            lay.model_gather(lay.model_view(full))
        dlay = data_layout(specs, types.SimpleNamespace(
            shape={"data": 2, "model": 1}), 1)
        with pytest.raises(RuntimeError, match="rank 0 of 1"):
            dlay.gather(dlay.slice(full))
        calls = []
        reduce = dist.all_reduce
        monkeypatch.setattr(dist, "all_reduce", lambda *a, **k: (
            calls.append(1), reduce(*a, **k))[1])
        xs = [torch.randn(3, 4), torch.randn(5).to(torch.bfloat16)]
        for got in (compat.all_reduce_buckets(xs, compat.MODEL),
                    compat.all_gather_along(xs, [1, 0], compat.MODEL)):
            for a, b in zip(got, xs):
                assert torch.equal(a, b)
        assert not calls  # the mesh's axes of one: no group, no collective
        own = dist.new_group([0])
        compat.set_axes({compat.MODEL: compat.Axis(own, (0,), 0)})
        got = compat.all_reduce_buckets(xs, compat.MODEL)
        assert len(calls) == 2 and all(torch.equal(a, b)
                                       for a, b in zip(got, xs))
        dist.destroy_process_group(own)
    finally:
        mesh.close()
