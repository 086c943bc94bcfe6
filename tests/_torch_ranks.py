"""Rank programs of the port's multi-process tests, and the inputs they share
with the parent test.

    python tests/_torch_ranks.py {ledger|serving} RANK WORLD STORE OUT_DIR

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


def start(scenario: str, out_dir: Path) -> list[subprocess.Popen]:
    """Start the WORLD ranks of ``scenario``, each a process of its own."""
    env = {"PYTHONPATH": str(ROOT / "src"), "HOME": str(out_dir),
           "TMPDIR": str(out_dir), "OMP_NUM_THREADS": "1",
           "PATH": os.environ.get("PATH", "/usr/bin:/bin")}
    store = out_dir / f"{scenario}.store"
    return [subprocess.Popen(
        [sys.executable, __file__, scenario, str(r), str(WORLD), str(store),
         str(out_dir)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]


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
            for r in range(WORLD)]

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

    mesh = make_elastic_mesh(device="cpu")
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

    mesh = make_elastic_mesh(device="cpu")
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


def main(argv) -> int:
    import torch.distributed as dist

    scenario, rank, world, store, out_dir = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=60))
    run = {"ledger": run_ledger, "serving": run_serving}[scenario]
    np.savez(f"{out_dir}/{scenario}-{rank}.npz", **run(rank))
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
