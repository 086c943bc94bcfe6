"""Rank programs of the port's multi-process tests, and the inputs they share
with the parent test.

    python tests/_torch_ranks.py {ledger|serving|train|resume|tp} RANK \
        WORLD STORE OUT_DIR

Each rank joins a gloo group through a ``FileStore`` at STORE (no TCP
port, so parallel test workers cannot collide), with a 60 s timeout on
every collective, so a rank that falls out of lockstep fails the test
instead of hanging it. It imports torch, numpy and ``repro_torch`` only,
and writes what it computed to OUT_DIR/<scenario>-<rank>.npz; the parent
holds that against its references.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.history import HistoryConfig, slot_for

WORLD = 4
ROOT = Path(__file__).resolve().parents[1]


def start(scenario: str, out_dir: Path,
          world: int = WORLD) -> list[subprocess.Popen]:
    """Start the ``world`` ranks of ``scenario``, each a process of its
    own."""
    env = {"PYTHONPATH": str(ROOT / "src"), "HOME": str(out_dir),
           "TMPDIR": str(out_dir), "OMP_NUM_THREADS": "1",
           "PATH": os.environ.get("PATH", "/usr/bin:/bin")}
    store = out_dir / f"{scenario}.store"
    return [subprocess.Popen(
        [sys.executable, __file__, scenario, str(r), str(world), str(store),
         str(out_dir)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]


def finish(procs, scenario: str, out_dir: Path,
           timeout: float = 120.0) -> list[dict]:
    """Wait for every rank (killing all past ``timeout`` seconds) -> their
    outputs in rank order; a rank that failed fails the caller with its
    log."""
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    assert not bad, f"ranks failed {bad}:\n" + "\n".join(logs)
    return [dict(np.load(out_dir / f"{scenario}-{r}.npz"))
            for r in range(len(procs))]

# -- the sharded ledger ops ----------------------------------------------------

CAP, B, STEPS = 1024, 16, 5  # a rank: 256 slots, 16 items an op
LEDGER_CFG = dict(capacity=CAP, decay=0.8, staleness_half_life=50.0)
# name -> (route, exchange, capacity_factor)
PLACEMENTS = {
    "pinned": (False, "gather", 1.25),
    "gather": (True, "gather", 1.25),
    "a2a-0.125": (True, "a2a", 0.125),
    "a2a-1.25": (True, "a2a", 1.25),
    "a2a-4": (True, "a2a", 4.0),
}
STREAMS = ("balanced", "skewed")
FIELDS = ("rec_ids", "rec_loss", "rec_valid", "rec_sig", "read_ids",
          "rp_ids", "rp_loss", "rp_valid", "rp_sig")


def home_of(ids: np.ndarray) -> np.ndarray:
    return slot_for(ids, CAP) // (CAP // WORLD)


def _pools(seed: int = 7):
    """Per home rank: a hot pool of 24 ids (repeats across steps) and a wide
    pool of 3x the rank's slots (slot collisions, evictions)."""
    ids = np.arange(1, 64 * CAP, dtype=np.int64)
    home = home_of(ids)
    rs = np.random.default_rng(seed)
    hot, wide = [], []
    for h in range(WORLD):
        mine = rs.permutation(ids[home == h])
        hot.append(mine[:24])
        wide.append(mine[24:24 + 3 * CAP // WORLD])
    return hot, wide


def ledger_stream(stream: str, seed: int = 0) -> list[dict]:
    """STEPS steps of global batches ([WORLD * B], rank r's segment at
    [r*B, (r+1)*B)). ``balanced``: every rank's segment holds B / WORLD
    ids of each home; ``skewed``: every id homes to rank 1. Each step
    repeats one id across ranks 0 and 1 and one inside rank 0's segment."""
    hot, wide = _pools()
    rs = np.random.default_rng(seed + (stream == "skewed"))

    def ids_for(homes):
        pick_hot = rs.random(homes.size) < 0.6
        return np.asarray([
            rs.choice(hot[h]) if p else rs.choice(wide[h])
            for h, p in zip(homes, pick_hot)], np.int64)

    def batch():
        if stream == "balanced":
            homes = np.concatenate([rs.permutation(
                np.repeat(np.arange(WORLD), B // WORLD)) for _ in
                range(WORLD)])
        else:
            homes = np.ones(WORLD * B, np.int64)
        ids = ids_for(homes)
        ids[B] = ids[0]  # rank 1 repeats rank 0's first id
        ids[5] = ids[2]  # rank 0 repeats an id of its own
        return ids

    steps = []
    for _ in range(STEPS):
        n = WORLD * B
        rec = batch()
        read = rec.copy()  # a quarter replaced by ids likely unseen
        fresh = rs.random(n) < 0.25
        read[fresh] = ids_for(rs.integers(0, WORLD, int(fresh.sum())))
        steps.append(dict(
            rec_ids=rec, rec_loss=(rs.random(n) * 5).astype(np.float32),
            rec_valid=rs.random(n) < 0.75,
            rec_sig=rs.standard_normal((n, 2)).astype(np.float32),
            read_ids=rs.permutation(read), rp_ids=batch(),
            rp_loss=(rs.random(n) * 5).astype(np.float32),
            rp_valid=rs.random(n) < 0.75,
            rp_sig=rs.standard_normal((n, 2)).astype(np.float32),
        ))
    return steps


def expected_overflow(ids, active, cap: int) -> int:
    """Items past ``cap`` rows a (sending rank, home), over the group."""
    n = 0
    for r in range(WORLD):
        seg = slice(r * B, (r + 1) * B)
        counts = np.bincount(home_of(ids[seg])[active[seg]],
                             minlength=WORLD)
        n += int(np.maximum(counts - cap, 0).sum())
    return n


def run_ledger(rank: int) -> dict:
    from repro_torch.distributed.ledger import sharded_ledger_ops
    from repro_torch.launch.mesh import make_elastic_mesh

    mesh = make_elastic_mesh(1, device="cpu")
    seg = slice(rank * B, (rank + 1) * B)
    out = {}
    for stream in STREAMS:
        steps = ledger_stream(stream)
        for name, (route, exchange, cf) in PLACEMENTS.items():
            ops = sharded_ledger_ops(mesh, HistoryConfig(**LEDGER_CFG),
                                     route=route, exchange=exchange,
                                     capacity_factor=cf)
            st = ops.init()
            key = f"{stream}/{name}"
            for t, g in enumerate(steps, start=1):
                x = {k: torch.from_numpy(np.ascontiguousarray(g[k][seg]))
                     for k in FIELDS}
                st, s1 = ops.record(st, x["rec_ids"], x["rec_loss"], t,
                                    x["rec_valid"], signals=x["rec_sig"],
                                    return_stats=True)
                ema, seen = ops.lookup(st, x["read_ids"])
                e2, sig, seen2 = ops.lookup_signals(st, x["read_ids"])
                pri = ops.priority(st, x["read_ids"], t)
                st, pri2, s2 = ops.record_priority(
                    st, x["rp_ids"], x["rp_loss"], t, x["rp_valid"],
                    signals=x["rp_sig"], return_stats=True)
                for k, v in dict(ema=ema, seen=seen, ema2=e2, sig=sig,
                                 seen2=seen2, pri=pri, pri2=pri2,
                                 ovf_rec=s1["a2a_overflow"],
                                 ovf_rp=s2["a2a_overflow"]).items():
                    out[f"{key}/{t}/{k}"] = v.numpy()
            sd = ops.state_dict(st)
            back = ops.state_dict(ops.load_state_dict(sd))
            for k in sd:  # the collective export round-trips on every rank
                assert np.array_equal(np.asarray(back[k]), np.asarray(sd[k])), k
            for k, v in sd.items():
                out[f"{key}/sd/{k}"] = np.asarray(v)
    mesh.close()
    return out


# -- the serving engine ----------------------------------------------------------

SLOTS, GEN, MP = 8, 5, 12  # slots divide over the 4 ledger shards
ENGINE_LEDGER = dict(capacity=4096, decay=0.8)
# name -> (exchange, capacity_factor, page_size, late topk retention)
ENGINE_RUNS = {
    "dense-gather": ("gather", 1.25, None, False),
    "dense-a2a-4": ("a2a", 4.0, None, False),
    "dense-a2a-0.125": ("a2a", 0.125, None, False),
    "paged-a2a-0.125": ("a2a", 0.125, 4, False),
    "late-gather": ("gather", 1.25, None, True),
}


def engine_config():
    from repro_torch import configs

    return dataclasses.replace(configs.get("llama3-8b", smoke=True),
                               param_dtype="float32",
                               compute_dtype="float32")


def engine_schedule(vocab: int):
    rs = np.random.default_rng(0)
    return [(rs.integers(0, vocab, int(rs.integers(3, MP + 1))),
             int(rs.integers(2, GEN + 1)), rs.integers(0, vocab, GEN))
            for _ in range(2 * SLOTS)]


def run_engine(run: str, mesh=None):
    """One schedule through an engine -> (engine, instance ids); a sharded
    table over ``mesh``, the single table without one."""
    from repro_torch.models import model as Mdl
    from repro_torch.models.params import materialize
    from repro_torch.serving import Engine, OutcomeRecorder, delayed_outcomes

    exchange, cf, page, late = ENGINE_RUNS[run]
    cfg = engine_config()
    params = materialize(Mdl.param_specs(cfg), 0, torch.float32, "cpu")
    rec = OutcomeRecorder(
        SLOTS, GEN, cfg.vocab_size, HistoryConfig(**ENGINE_LEDGER),
        ledger="device", mesh=mesh, route=mesh is not None,
        exchange=exchange, capacity_factor=cf,
        retention="topk" if late else "full", topk=16, device="cpu")
    eng = Engine(cfg, params, rec, slots=SLOTS, max_prompt=MP, max_gen=GEN,
                 page_size=page)
    sched = engine_schedule(cfg.vocab_size)
    if late:
        outs = [(eng.submit(p, max_new=g, expect_labels=True), lab[:g])
                for p, g, lab in sched]
        eng.run(max_steps=800, on_step=delayed_outcomes(outs, 2))
        ids = [i for i, _ in outs]
    else:
        ids = [eng.submit(p, max_new=g, labels=lab[:g])
               for p, g, lab in sched]
        eng.run(max_steps=500)
    return eng, ids


def engine_tokens(eng, ids) -> np.ndarray:
    """Every request's generated tokens, in submission order, -1 padded."""
    out = np.full((len(ids), GEN), -1, np.int64)
    for n, i in enumerate(ids):
        toks = eng.finished[i]
        out[n, :len(toks)] = toks
    return out


def run_serving(rank: int) -> dict:
    from repro_torch.launch.mesh import make_elastic_mesh

    mesh = make_elastic_mesh(1, device="cpu")
    out = {}
    for run in ENGINE_RUNS:
        eng, ids = run_engine(run, mesh)
        stats = eng.stats()
        assert stats["in_flight"] == 0 and stats["queued"] == 0, stats
        out[f"{run}/tokens"] = engine_tokens(eng, ids)
        out[f"{run}/a2a_overflow"] = np.int64(stats["a2a_overflow"])
        out[f"{run}/recorded"] = np.int64(stats["recorded"])
        for k, v in eng.ledger_state_dict().items():  # a collective
            out[f"{run}/sd/{k}"] = np.asarray(v)
    mesh.close()
    return out


# -- the data-parallel train step and the train CLI ----------------------------

# 8 rows a rank. AdamW's update lr * m / sqrt(v) amplifies the grads' f32
# noise where m nearly cancels (a grad that turns sign between the steps):
# at lr 1e-3 a few entries land more than 1e-6 from JAX's. At 1e-4 every
# update (about lr an entry a step) is still 100 times the params' 1e-6
# tolerance, so a misplaced or stale moment slice shows.
DP_N, DP_SEQ, DP_STEPS, DP_LR = 32, 12, 2, 1e-4
# name -> (mode, method, ratio, recycle_forward, shard_local, optimizer,
# int8 gathers: the step under FSDP_RULES with int8_gather, JAX's under
# the same rules)
DP_CASES = {
    "obftf-noise": ("obftf", "obftf", 0.25, False, True, "adamw", False),
    "maxk-recycled": ("obftf", "maxk", 0.25, True, True, "adamw", False),
    "full": ("full", "obftf", 0.25, False, True, "adamw", False),
    "global": ("obftf", "obftf", 0.25, False, False, "adamw", False),
    "ratio-0.3": ("obftf", "obftf", 0.3, False, True, "adamw", False),
    # SGD's update is linear in the grads, so a grad scaled wrongly
    # (a mean of per-rank means, a sum) shows in the params; AdamW's would
    # hide it
    "global-sgd": ("obftf", "obftf", 0.25, False, False, "sgd", False),
    # every layer's weights int8-quantized, in the selection forward too
    "obftf-int8": ("obftf", "obftf", 0.25, False, True, "adamw", True),
}


def int8_rules():
    """The int8 gather's rules, as the JAX ``dryrun`` builds them:
    ``FSDP_RULES`` (which set ``gather_params``) with ``int8_gather``."""
    from repro_torch.distributed import sharding as S

    return dataclasses.replace(S.FSDP_RULES, int8_gather=True)
DRAWS = ("perm", "gumbel", "normal")
CLI = ["--arch", "llama3-8b", "--smoke", "--global-batch", "16",
       "--seq-len", "16", "--log-every", "1", "--model-parallel", "1"]
# name -> extra flags; the port's and the JAX CLI's runs of these resume
# from one checkpoint of the JAX CLI's initial state
CLI_RUNS = {
    "full": ["--method", "full", "--steps", "4"],
    # two kept rows a rank against an a2a capacity of one a destination
    "pinned": ["--method", "maxk", "--ratio", "0.5", "--recycle",
               "--ledger", "device", "--instance-pool", "32", "--steps", "4"],
    "a2a": ["--method", "maxk", "--ratio", "0.5", "--recycle", "--ledger",
            "device", "--instance-pool", "32", "--steps", "4",
            "--ledger-route", "--ledger-exchange", "a2a",
            "--capacity-factor", "0.125"],
    # every rank's LossHistory fed the gathered per-example losses
    "host": ["--method", "maxk", "--ratio", "0.5", "--recycle", "--ledger",
             "host", "--instance-pool", "32", "--steps", "4"],
}
FULL = CLI + ["--device", "cpu", "--method", "full"]


def dp_config():
    from repro_torch import configs

    return dataclasses.replace(configs.get("llama3-8b", smoke=True),
                               param_dtype="float32",
                               compute_dtype="float32")


class FixedDraws:
    """The selection's draws, recorded beforehand (the JAX selector's, from
    the parent), as the port's Noise."""

    def __init__(self, perm, gumbel, normal):
        self.perm = torch.from_numpy(np.asarray(perm, np.int64))
        self.gum = torch.from_numpy(np.asarray(gumbel, np.float32))
        self.norm = torch.from_numpy(np.asarray(normal, np.float32))

    def permutation(self, n):
        assert n == self.perm.shape[0], (n, self.perm.shape)
        return self.perm

    def gumbel(self, n):
        assert n == self.gum.shape[0], (n, self.gum.shape)
        return self.gum

    def normal(self):
        return self.norm


def _optimizer(name: str, layout):
    from repro_torch import optim as O

    if name == "sgd":
        return O.sgd_momentum(O.constant(0.05), momentum=0.9, layout=layout)
    return O.adamw(O.constant(DP_LR), O.AdamWConfig(weight_decay=0.1),
                   layout=layout)


def _tree_from(flat: dict, prefix: str, like):
    from repro_torch.models.params import tree_map

    return tree_map(lambda p, _: torch.from_numpy(
        np.array(flat[prefix + "/".join(p)])), like)


def _flat(tree, prefix: str) -> dict:
    from repro_torch.models.params import tree_map

    out = {}
    tree_map(lambda p, x: out.__setitem__(prefix + "/".join(p), np.array(
        x.detach().numpy() if isinstance(x, torch.Tensor) else x)), tree)
    return out


def run_dp_steps(rank: int, mesh) -> dict:
    """Every case of ``DP_CASES``: DP_STEPS steps of ``make_train_step(mesh=)``
    on this rank's rows, the params held FSDP-placed in the optimizer's
    layout, with the draws the parent recorded; the params and moments
    written gathered whole, and, once, the shape of each leaf this rank
    holds."""
    from repro_torch.checkpoint.manager import full_state
    from repro_torch.core import obftf as OB
    from repro_torch.core.selection import SelectionConfig
    from repro_torch.distributed.zero import HELD, data_layout
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_map

    cfg = dp_config()
    specs = M.param_specs(cfg)
    inp = dict(np.load(OUT / "dp_inputs.npz"))
    n_local = DP_N // WORLD
    seg = slice(rank * n_local, (rank + 1) * n_local)
    batch = {k: torch.from_numpy(np.ascontiguousarray(inp[f"batch/{k}"][seg]))
             for k in ("tokens", "labels", "recorded_loss", "instance_id")}
    out = {}
    for case, (mode, method, ratio, recycle, local, opt,
               int8) in DP_CASES.items():
        layout = (data_layout(specs, mesh, rank, int8_rules()) if int8
                  else data_layout(specs, mesh, rank))
        optimizer = _optimizer(opt, layout)
        step = OB.make_train_step(M.loss_fn(cfg), optimizer, OB.OBFTFConfig(
            selection=SelectionConfig(method=method, ratio=ratio),
            recycle_forward=recycle, mode=mode, shard_local=local),
            mesh=mesh)
        params = layout.hold(_tree_from(inp, "params/", specs))
        state = {"params": params, "opt": optimizer.init(params),
                 "step": torch.zeros((), dtype=torch.int32)}
        for t in range(DP_STEPS):
            who = "global" if not local else f"rank{rank}"
            noise = FixedDraws(*(inp[f"draws/{t}/{who}/{d}"] for d in DRAWS))
            state, m = step(state, batch, noise)
            for k, v in m.items():
                out[f"{case}/{t}/{k}"] = v.numpy()
        if case == "full":
            out.update(_flat(tree_map(lambda _, x: np.asarray(x.shape),
                                      state["params"]), "held/"))
        whole = (full_state(state, layout) if opt == "adamw" else {
            "params": layout.gather(state["params"], HELD),
            "opt": {"m": layout.gather(state["opt"]["m"], HELD)}})
        out.update(_flat(whole["params"], f"{case}/params/"))
        opt_state = whole["opt"]
        for k in ("m", "v"):
            if k in opt_state:
                out.update(_flat(opt_state[k], f"{case}/{k}/"))
    return out


# the int8 ZeRO-3 gather's cases: name -> (arch whose layout places the
# leaf, its params path; None: the gather called directly), the leaf's
# shape, the dim each rank holds a quarter of (None: the leaf held whole),
# the chunk, the dtype. "odd" cuts rows across the pieces' edges and pads;
# "in_proj" is a layer's view (through param_gather_constraint, one run a
# rank); "w2" a whole stack; "conv_w" a layer's leaf held whole, quantized
# where it is
INT8_CASES = {
    "odd": (None, None, (5, 12, 7), 1, 16, "float32"),
    "in_proj": ("mamba2-370m", ("blocks", "ssm", "in_proj"), (64, 296), 0,
                256, "bfloat16"),
    "w2": ("llama3-8b", ("blocks", "mlp", "w2"), (2, 128, 64), 2, 256,
           "float32"),
    "conv_w": ("mamba2-370m", ("blocks", "ssm", "conv_w"), (4, 160), None,
               256, "float32"),
}
RING_SHAPE = (5, 301)  # a rank's term of the int8 ring all-reduce


def run_int8(rank: int, mesh) -> dict:
    """The int8 ring all-reduce of this rank's term, and each INT8_CASES
    gather of this rank's quarter of the leaf (or of the whole leaf): its
    value (whole) and the grad of what the rank holds for this rank's
    cotangent."""
    from repro_torch import configs
    from repro_torch.distributed import sharding as S
    from repro_torch.distributed.compression import int8_ring_all_reduce
    from repro_torch.distributed.zero import data_layout
    from repro_torch.models import model as M

    inp = dict(np.load(OUT / "dp_inputs.npz"))
    x = torch.from_numpy(inp["int8/ring/x"][rank])
    out = {"int8/ring": int8_ring_all_reduce(x).numpy()}
    rules = int8_rules()
    for name, (arch, path, shape, dim, chunk, dtype) in INT8_CASES.items():
        w = torch.from_numpy(inp[f"int8/{name}/w"]).to(getattr(torch, dtype))
        if dim is not None:
            k = shape[dim] // WORLD
            w = w.narrow(dim, rank * k, k)
        x = w.clone().requires_grad_(True)
        if arch is None:
            y = S._Int8Gather.apply(x, dim, chunk)
        else:
            layout = data_layout(M.param_specs(configs.get(arch, smoke=True)),
                                 mesh, rank, rules)
            with S.use_rules(mesh, rules, layout):
                y = S.param_gather_constraint({path[-1]: x},
                                              path[:-1])[path[-1]]
        c = torch.from_numpy(inp[f"int8/{name}/c{rank}"])
        (y.float() * c).sum().backward()
        out[f"int8/{name}/value"] = y.detach().float().numpy()
        out[f"int8/{name}/grad"] = x.grad.float().numpy()
    return out


# one full-method step of the hybrid smoke config in f32, remat on (each
# group's recompute gathers again), SGD (linear in the grads): HYB_N rows
# of HYB_SEQ tokens, against the mesh-less step on the whole batch. name ->
# (tied embeddings, int8 gathers): "tied" gathers the shared table once for
# its two uses; "int8" holds the params in a layout of ``int8_rules()``
HYB_N, HYB_SEQ, HYB_LR = 8, 12, 0.05
HYB_CASES = {"plain": (False, False), "tied": (True, False),
             "int8": (False, True)}


def hybrid_config(tied: bool = False):
    from repro_torch import configs

    return dataclasses.replace(configs.get("zamba2-2.7b", smoke=True),
                               param_dtype="float32",
                               compute_dtype="float32", remat=True,
                               tie_embeddings=tied)


def hybrid_step(case: str, mesh=None, rank: int = 0):
    """(metrics, the params after the step, whole) of one full-method step
    of HYB_CASES[case] on this rank's rows (the whole batch without a
    mesh)."""
    from repro_torch import optim as O
    from repro_torch.core import obftf as OB
    from repro_torch.distributed import sharding as S
    from repro_torch.distributed.zero import HELD, data_layout
    from repro_torch.models import model as M
    from repro_torch.models.params import materialize

    tied, int8 = HYB_CASES[case]
    cfg = hybrid_config(tied)
    specs = M.param_specs(cfg)
    rs = np.random.default_rng(3)
    batch = {k: torch.from_numpy(rs.integers(0, cfg.vocab_size,
                                             (HYB_N, HYB_SEQ)))
             for k in ("tokens", "labels")}
    params = materialize(specs, 0, torch.float32, "cpu")
    layout = None
    if mesh is not None:
        n = HYB_N // WORLD
        batch = {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}
        layout = data_layout(specs, mesh, rank,
                             int8_rules() if int8 else S.DEFAULT_RULES)
        params = layout.hold(params)
    opt = O.sgd_momentum(O.constant(HYB_LR), momentum=0.9, layout=layout)
    step = OB.make_train_step(M.loss_fn(cfg), opt, OB.OBFTFConfig(
        mode="full"), mesh=mesh)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    state, m = step(state, batch, None)
    whole = (state["params"] if layout is None
             else layout.gather(state["params"], HELD))
    return {k: v.numpy() for k, v in m.items()}, whole


def run_hybrid(rank: int, mesh) -> dict:
    out = {}
    for case in HYB_CASES:
        m, params = hybrid_step(case, mesh, rank)
        out.update({f"hybrid/{case}/{k}": v for k, v in m.items()})
        out.update(_flat(params, f"hybrid/{case}/params/"))
    return out


def run_train(rank: int) -> dict:
    """The int8 checks, the hybrid step, the step cases, then the train CLI
    on the four ranks: the runs of
    ``CLI_RUNS`` resumed from the JAX CLI's initial state, the pinned one
    resumed from its own final checkpoint, an obftf run,
    a 4-step run of ``FULL`` checkpointed at step 2 and its resumption
    from there, and a SIGTERM to rank 1 as its first step starts."""
    import os
    import shutil
    import signal

    import torch.distributed as dist

    from repro_torch.data import pipeline
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_elastic_mesh

    mesh = make_elastic_mesh(1, device="cpu")
    out = run_int8(rank, mesh)
    out.update(run_hybrid(rank, mesh))
    out.update(run_dp_steps(rank, mesh))
    for name, extra in CLI_RUNS.items():
        assert train.main(CLI + ["--device", "cpu"] + extra + [
            "--ckpt-dir", str(OUT / f"ck-port-{name}"), "--resume", "auto",
            "--json-out", str(OUT / f"port-{name}.json"),
            "--ledger-out", str(OUT / f"port-{name}.npz")]) == 0
    # the pinned run's final checkpoint (its table sharded) resumed
    assert train.main(CLI + ["--device", "cpu"] + CLI_RUNS["pinned"] + [
        "--steps", "6", "--ckpt-dir", str(OUT / "ck-port-pinned"),
        "--resume", "auto", "--json-out",
        str(OUT / "port-pinned-resumed.json")]) == 0
    assert train.main(CLI + ["--device", "cpu", "--steps", "3", "--json-out",
                             str(OUT / "port-obftf.json")]) == 0
    assert train.main(FULL + ["--steps", "4", "--ckpt-every", "2",
                              "--ckpt-dir", str(OUT / "ck-save"),
                              "--json-out", str(OUT / "full4.json"),
                              "--metrics-out", str(OUT / "full4.jsonl"),
                              "--metrics-every", "1"]) == 0
    if rank == 0:
        shutil.copytree(OUT / "ck-save", OUT / "ck-resume4")
    dist.barrier()
    assert train.main(FULL + ["--steps", "4", "--resume", "2", "--ckpt-dir",
                              str(OUT / "ck-resume4"), "--json-out",
                              str(OUT / "resume4.json")]) == 0
    batch = pipeline.SyntheticLMStream.batch

    def batch_then_signal(self, step):
        if rank == 1 and step == 0:
            os.kill(os.getpid(), signal.SIGTERM)
        return batch(self, step)

    pipeline.SyntheticLMStream.batch = batch_then_signal
    assert train.main(FULL + ["--steps", "5", "--ckpt-dir",
                              str(OUT / "ck-term"), "--json-out",
                              str(OUT / "term.json")]) == 0
    pipeline.SyntheticLMStream.batch = batch
    mesh.close()
    return out


def run_resume(rank: int) -> dict:
    """``FULL`` resumed from the four ranks' checkpoint (``ck-resume``) on
    this world."""
    from repro_torch.launch import train

    assert train.main(FULL + ["--steps", "4", "--resume", "2",
                              "--ckpt-dir", str(OUT / "ck-resume"),
                              "--json-out", str(OUT / "resume.json")]) == 0
    return {}


# -- tensor parallelism: the (data, model) mesh -------------------------------

# the step cases hold JAX's mesh step on the same 4 devices; 16 rows of 12
# tokens, 2 AdamW steps at DP_LR (its reasoning holds here)
TP_N, TP_SEQ, TP_STEPS = 16, 12, 2
# arch key -> (config, overrides of its smoke config)
TP_ARCHS = {
    "llama": ("llama3-8b", {}),  # 4 heads, kv 2, vocab 256, mlp 128
    "granite": ("granite-34b", {}),  # kv 1 (MQA), the GELU MLP
    "heads6": ("llama3-8b", {"num_heads": 6}),  # 6 % 4: heads whole
    "musicgen": ("musicgen-medium", {}),  # MHA, vocab 128
    "qknorm": ("llama3-8b", {"qk_norm": True}),  # q_norm, k_norm in regions
}
# name -> (arch, model axis, mode, method, ratio, dtype, recycled): the
# head layouts (a) heads and kv heads cut, (b) heads cut and kv whole, (c)
# heads whole. The bf16 case selects from recorded losses: its selection
# forward's losses are within about 1.3e-3 of JAX's (bf16 rounding), which
# reorders rows whose losses lie closer than that and so moves obftf's pick
TP_CASES = {
    "llama-b-obftf": ("llama", 4, "obftf", "obftf", 0.25, "float32", False),
    "llama-b-full": ("llama", 4, "full", "obftf", 0.25, "float32", False),
    "llama-a-obftf": ("llama", 2, "obftf", "obftf", 0.25, "float32", False),
    "llama-a-bf16": ("llama", 2, "obftf", "obftf", 0.25, "bfloat16", True),
    "granite-b-full": ("granite", 4, "full", "obftf", 0.25, "float32",
                       False),
    "heads6-c-full": ("heads6", 4, "full", "obftf", 0.25, "float32", False),
    "musicgen-a-full": ("musicgen", 2, "full", "obftf", 0.25, "float32",
                        False),
    "qknorm-a-full": ("qknorm", 2, "full", "obftf", 0.25, "float32", False),
    "qknorm-b-full": ("qknorm", 4, "full", "obftf", 0.25, "float32", False),
}
# the vocab-parallel loss: logits [T, V] of the llama smoke vocab, labels at
# -1, 0, V-1 and each slice's borders (4 slices of 64), the rest drawn
XENT_T = 24
XENT_LABELS = [-1, 0, 255, 63, 64, 127, 128, 191, 192, -1]
TP_CLI = ["--arch", "llama3-8b", "--smoke", "--global-batch", "16",
          "--seq-len", "16", "--log-every", "1"]
# name -> extra flags; the port's and JAX's runs resume one checkpoint of
# JAX's initial state, as ``CLI_RUNS`` do
TP_CLI_RUNS = {
    "mp0": ["--model-parallel", "0", "--method", "full", "--steps", "2"],
    "mp2": ["--model-parallel", "2", "--method", "maxk", "--ratio", "0.5",
            "--recycle", "--ledger", "device", "--instance-pool", "16",
            "--steps", "2"],
}
# the (2, 2) run's checkpoint at step 2 resumed for a step (its ledger too)
TP_RESUME = TP_CLI_RUNS["mp2"][2:-2] + ["--steps", "3", "--resume", "2"]
# the serve CLI with the routed ledger (``test_torch_serving_sharded``'s)
TP_SERVE = ["--arch", "llama3-8b", "--smoke", "--batch", "4", "--requests",
            "10", "--prompt-len", "16", "--gen", "6", "--page-size", "4",
            "--retain", "topk", "--topk", "16", "--ledger", "device",
            "--outcome-delay", "2", "--ledger-route", "--ledger-exchange",
            "a2a", "--capacity-factor", "0.125"]


def tp_config(arch: str, dtype: str):
    from repro_torch import configs

    name, extra = TP_ARCHS[arch]
    return dataclasses.replace(configs.get(name, smoke=True),
                               param_dtype=dtype, compute_dtype=dtype,
                               **extra)


def _tp_steps(case: str, mesh, inp: dict) -> dict:
    """TP_STEPS steps of TP_CASES[case] on this rank's data rows and model
    slices, with the draws of its data index: the metrics, the params and
    moments gathered whole, and the shape of each leaf the rank holds."""
    from repro_torch import optim as O
    from repro_torch.checkpoint.manager import full_state
    from repro_torch.core import obftf as OB
    from repro_torch.core.selection import SelectionConfig
    from repro_torch.distributed.zero import data_layout
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_map

    arch, _, mode, method, ratio, dtype, recycled = TP_CASES[case]
    cfg = tp_config(arch, dtype)
    specs = M.param_specs(cfg)
    d, dsize = mesh.data_index, mesh.shape["data"]
    layout = data_layout(specs, mesh, d, model_rank=mesh.model_index)
    opt = O.adamw(O.constant(DP_LR), O.AdamWConfig(weight_decay=0.1),
                  layout=layout)
    step = OB.make_train_step(M.loss_fn(cfg), opt, OB.OBFTFConfig(
        selection=SelectionConfig(method=method, ratio=ratio),
        recycle_forward=recycled, mode=mode), mesh=mesh)
    full = tree_map(lambda _, x: x.to(getattr(torch, dtype)),
                    _tree_from(inp, f"{arch}/params/", specs))
    params = layout.hold(full)
    n = TP_N // dsize
    batch = {k: torch.from_numpy(np.ascontiguousarray(
        inp[f"{arch}/batch/{k}"][d * n:(d + 1) * n]))
        for k in ("tokens", "labels", "recorded_loss")}
    if not recycled:
        del batch["recorded_loss"]
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    out = _flat(tree_map(lambda _, x: np.asarray(x.shape), params),
                f"{case}/held/")
    for t in range(TP_STEPS):
        noise = None if mode == "full" else FixedDraws(
            *(inp[f"draws/{case}/{t}/{d}/{k}"] for k in DRAWS))
        state, m = step(state, batch, noise)
        for k, v in m.items():
            out[f"{case}/{t}/{k}"] = v.float().numpy()
    whole = full_state(state, layout)
    f32 = lambda t: tree_map(lambda _, x: x.float(), t)
    out.update(_flat(f32(whole["params"]), f"{case}/params/"))
    out.update(_flat(whole["opt"]["m"], f"{case}/m/"))
    return out


def _tp_xent(mesh, inp: dict) -> dict:
    """The vocab-parallel loss on this rank's slice of XENT logits (llama's
    layout on ``mesh``): the per-token loss and the grad of its slice for
    the parent's cotangent."""
    from repro_torch.distributed import sharding as S
    from repro_torch.distributed.zero import data_layout
    from repro_torch.models import model as M

    specs = M.param_specs(tp_config("llama", "float32"))
    layout = data_layout(specs, mesh, mesh.data_index,
                         model_rank=mesh.model_index)
    v = inp["xent/logits"].shape[1] // mesh.shape["model"]
    m = mesh.model_index
    x = torch.from_numpy(inp["xent/logits"][:, m * v:(m + 1) * v].copy())
    x.requires_grad_(True)
    labels = torch.from_numpy(inp["xent/labels"])
    with S.use_rules(mesh, S.DEFAULT_RULES, layout):
        loss = M.per_token_loss(x[None], labels[None], vocab_cut=True)[0]
    (loss * torch.from_numpy(inp["xent/cot"])).sum().backward()
    return {"xent/loss": loss.detach().numpy(), "xent/grad": x.grad.numpy()}


def tied_step(mesh=None):
    """(metrics, the params after the step, whole) of one full-method SGD
    step (linear in the grads, so a grad counted twice shows) of the llama
    smoke config in f32 with its table tied to the head, on this rank's
    slices of ``mesh`` (the whole model without one)."""
    from repro_torch import optim as O
    from repro_torch.checkpoint.manager import full_state
    from repro_torch.core import obftf as OB
    from repro_torch.distributed.zero import data_layout
    from repro_torch.models import model as M
    from repro_torch.models.params import materialize

    cfg = dataclasses.replace(tp_config("llama", "float32"),
                              tie_embeddings=True)
    specs = M.param_specs(cfg)
    rs = np.random.default_rng(3)
    batch = {k: torch.from_numpy(rs.integers(0, cfg.vocab_size, (8, 12)))
             for k in ("tokens", "labels")}
    params = materialize(specs, 0, torch.float32, "cpu")
    layout = None
    if mesh is not None:
        layout = data_layout(specs, mesh, mesh.data_index,
                             model_rank=mesh.model_index)
        params = layout.hold(params)
    opt = O.sgd_momentum(O.constant(0.05), momentum=0.9, layout=layout)
    step = OB.make_train_step(M.loss_fn(cfg), opt, OB.OBFTFConfig(
        mode="full"), mesh=mesh)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    state, m = step(state, batch, None)
    whole = state["params"] if layout is None else full_state(
        dict(state, opt={}), layout)["params"]
    return {k: v.numpy() for k, v in m.items()}, whole


def _restore_on(mesh, ck: Path, step: int) -> dict:
    """The (2, 2) run's checkpoint restored into this rank's layout on
    ``mesh``, then gathered whole: what a resume starts from."""
    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import full_state
    from repro_torch.distributed.zero import data_layout
    from repro_torch.launch.train import build_optimizer
    from repro_torch.models import model as M
    from repro_torch.models.params import materialize

    cfg = configs.get("llama3-8b", smoke=True)
    specs = M.param_specs(cfg)
    layout = data_layout(specs, mesh, mesh.data_index,
                         model_rank=mesh.model_index)
    opt = build_optimizer(1e-3, 2, layout)
    params = layout.hold(materialize(specs, 1, torch.bfloat16, "cpu"))
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    state = CheckpointManager(str(ck), layout=layout).restore(step, state)
    whole = full_state(state, layout)
    return _flat({"params": {k: v.float() for k, v in _leaves(
        whole["params"]).items()}, "m": whole["opt"]["m"]}, "")


def _leaves(tree) -> dict:
    """A tree's leaves by their path joined with "/"."""
    from repro_torch.models.params import tree_map

    out = {}
    tree_map(lambda p, x: out.__setitem__("/".join(p), x), tree)
    return out


def run_tp(rank: int) -> dict:
    """The mesh's coordinates for each model axis, every TP_CASES case,
    the vocab-parallel loss, the train CLI runs of TP_CLI_RUNS against
    JAX's, the (2, 2) run's checkpoint restored on (1, 4) and (4, 1), the
    CLI resuming it on (1, 4), and the serve CLI with the routed ledger."""
    import contextlib
    import io
    import shutil

    import torch.distributed as dist

    from repro_torch.launch import serve, train
    from repro_torch.launch.mesh import make_elastic_mesh

    inp = dict(np.load(OUT / "tp_inputs.npz"))
    out = {}
    for mp in (0, 1, 2, 4):
        mesh = make_elastic_mesh(mp, device="cpu")
        out[f"mesh/{mp}"] = np.asarray([mesh.data_index, mesh.model_index,
                                        mesh.shape["data"],
                                        mesh.shape["model"]])
        for case, spec in TP_CASES.items():
            if spec[1] == mp:
                out.update(_tp_steps(case, mesh, inp))
        if mp == 4:
            out.update(_tp_xent(mesh, inp))
            m, whole = tied_step(mesh)
            out.update({f"tied/{k}": v for k, v in m.items()})
            out.update(_flat(whole, "tied/params/"))
        mesh.close()
    for name, extra in TP_CLI_RUNS.items():
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            assert train.main(TP_CLI + ["--device", "cpu"] + extra + [
                "--ckpt-dir", str(OUT / f"ck-port-{name}"), "--resume",
                "auto", "--json-out", str(OUT / f"port-{name}.json"),
                "--ledger-out", str(OUT / f"port-{name}.npz")]) == 0
        out[f"cli/{name}/said"] = np.asarray(said.getvalue())
    dist.barrier()  # rank 0 alone writes the checkpoints: wait for them
    # the (2, 2) run's final checkpoint, restored on (1, 4) and (4, 1)
    ck = OUT / "ck-port-mp2"
    for mp in (4, 1):
        mesh = make_elastic_mesh(mp, device="cpu")
        out.update({f"restore/{mp}/{k}": v
                    for k, v in _restore_on(mesh, ck, 2).items()})
        mesh.close()
    if rank == 0:
        shutil.copytree(ck, OUT / "ck-resume-14")
    dist.barrier()
    assert train.main(TP_CLI + ["--device", "cpu"] + TP_RESUME + [
        "--model-parallel", "0", "--ckpt-dir", str(OUT / "ck-resume-14"),
        "--json-out", str(OUT / "resume-14.json")]) == 0
    assert serve.main(TP_SERVE + [
        "--device", "cpu", "--json-out", str(OUT / "serve-port.json"),
        "--ledger-out", str(OUT / "serve-port.npz")]) == 0
    return out


OUT = Path(".")  # the rank's output directory (main sets it)


def main(argv) -> int:
    import torch.distributed as dist

    global OUT
    scenario, rank, world, store, out_dir = argv
    rank, world = int(rank), int(world)
    OUT = Path(out_dir)
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=60))
    run = {"ledger": run_ledger, "serving": run_serving, "train": run_train,
           "resume": run_resume, "tp": run_tp}[scenario]
    np.savez(f"{out_dir}/{scenario}-{rank}.npz", **run(rank))
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
