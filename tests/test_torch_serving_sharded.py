"""The port's serving engine and both CLIs on the sharded ledger.

Four gloo ranks (``tests/_torch_ranks.py``) each run the same smoke
llama3-8b engine on the same schedule, recording into a table sharded over
the ranks and routed inside the fused step: dense and paged caches, the
gather exchange, a2a at capacity factors 4 and 0.125 (where the residual
round must fire), and late outcomes delivered through
``recorder.replicate``. Every rank's tokens must equal the single-table
engine's, and the merged table must equal its table field for field (port
against port on one device: ``==``).

Then the serve CLI with ``--ledger-route`` at a world of one on the CPU:
its summary has the JAX CLI's keys and, on the same requests, its values
for the routing keys and the engine's counts, and its ``--ledger-out`` is
the unrouted run's. Last, the train CLI's three flags at one rank, and its
refusal of more than one rank.
"""

import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_ranks as R
from repro import obs as jobs
from repro.launch import serve as jserve
from repro_torch import obs
from repro_torch.launch import serve, train
from repro_torch.serving import Engine, OutcomeRecorder

torch.set_num_threads(1)

# the port's summary keys beyond the JAX CLIs' (as in test_torch_obs.py)
SERVE_EXTRAS = {"seconds", "device", "layers", "guarded_steps", "step_ms",
                "instance_ids"}


@pytest.fixture(autouse=True)
def telemetry_off():
    """A CLI installs its telemetry process-wide: put both packages back
    to the disabled default after each test."""
    yield
    obs.install(obs.OFF)
    jobs.install(jobs.OFF)


def test_four_ranks_serve_the_single_engines_tokens_and_table(tmp_path):
    procs = R.start("serving", tmp_path)
    single = {}  # the single-table engines, run while the ranks run
    for run in R.ENGINE_RUNS:
        eng, ids = R.run_engine(run)
        single[run] = (R.engine_tokens(eng, ids), eng.stats(),
                       eng.ledger_state_dict())
    ranks = R.finish(procs, "serving", tmp_path)
    for run, (tokens, stats, sd) in single.items():
        for r, out in enumerate(ranks):
            np.testing.assert_array_equal(out[f"{run}/tokens"], tokens,
                                          err_msg=f"{run} rank {r}")
            assert out[f"{run}/recorded"] == stats["recorded"], (run, r)
            for k, v in sd.items():
                np.testing.assert_array_equal(
                    out[f"{run}/sd/{k}"], v, err_msg=f"{run} rank {r} {k}")
        ovf = {int(out[f"{run}/a2a_overflow"]) for out in ranks}
        assert len(ovf) == 1, (run, ovf)  # the group's count on every rank
        if run.endswith("a2a-0.125"):
            assert ovf.pop() > 0, run
        else:
            assert ovf == {0}, run


def test_an_unsharded_recorder_leaves_the_params_where_they_are():
    """Without a mesh ``replicate`` hands a tree back as it is, as the JAX
    recorder does, so params on another device than the recorder's are
    refused, never copied over."""
    cfg = R.engine_config()
    rec = OutcomeRecorder(R.SLOTS, R.GEN, cfg.vocab_size, device="cpu")
    tree = {"embed": torch.zeros(2), "rows": [torch.ones(3)]}
    assert rec.replicate(tree) is tree
    params = {"embed": torch.empty(cfg.vocab_size, cfg.d_model,
                                   device="meta")}
    with pytest.raises(ValueError, match="recorder on cpu, params on meta"):
        Engine(cfg, params, rec, slots=R.SLOTS, max_prompt=R.MP,
               max_gen=R.GEN)


SERVE = ["--arch", "llama3-8b", "--smoke", "--batch", "4", "--requests", "10",
         "--prompt-len", "16", "--gen", "6", "--page-size", "4", "--retain",
         "topk", "--topk", "16", "--ledger", "device", "--outcome-delay", "2"]
ROUTED = ["--ledger-route", "--ledger-exchange", "a2a",
          "--capacity-factor", "0.125"]


def _serve(main, argv, tmp_path, name):
    j, led = tmp_path / f"{name}.json", tmp_path / f"{name}.npz"
    assert main(argv + ["--json-out", str(j), "--ledger-out", str(led)]) == 0
    with open(j) as f:
        return json.load(f), dict(np.load(led))


def test_serve_cli_routes_at_a_world_of_one(tmp_path, monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    port = SERVE + ["--device", "cpu"]
    plain, plain_sd = _serve(serve.main, port, tmp_path, "plain")
    runs = {name: _serve(serve.main, port + extra, tmp_path, name)
            for name, extra in (("a2a", ROUTED),
                                ("gather", ["--ledger-route"]))}
    assert not dist.is_initialized()  # the CLI ends the group it set up
    jsum, _ = _serve(jserve.main, SERVE + ROUTED, tmp_path, "jax")
    summary = runs["a2a"][0]
    assert set(summary) == set(jsum) | SERVE_EXTRAS
    assert set(summary["health"]) == set(jsum["health"])
    for k in ("routed", "exchange", "capacity_factor", "shards",
              "a2a_overflow", "recorded", "steps", "admitted", "evicted",
              "generated_tokens"):
        assert summary[k] == jsum[k], k
    assert summary["health"]["a2a_overflow_rate"] == pytest.approx(
        jsum["health"]["a2a_overflow_rate"])
    assert summary["a2a_overflow"] > 0
    assert runs["gather"][0]["exchange"] == "gather"
    assert runs["gather"][0]["a2a_overflow"] == 0
    assert (plain["routed"], plain["exchange"], plain["shards"]) == \
        (False, "none", 1)
    for name, (s, sd) in runs.items():
        assert s["routed"] and s["shards"] == 1
        for k, v in plain_sd.items():
            np.testing.assert_array_equal(sd[k], v, err_msg=f"{name} {k}")
    with pytest.raises(SystemExit, match="requires --ledger device"):
        serve.main(port[:-2] + ["--ledger", "host", "--ledger-route"])


TRAIN = ["--arch", "llama3-8b", "--smoke", "--device", "cpu", "--steps", "3",
         "--global-batch", "8", "--seq-len", "16", "--recycle", "--ledger",
         "device", "--instance-pool", "16", "--log-every", "3"]


def test_train_cli_takes_the_routing_flags_at_one_rank(tmp_path, monkeypatch):
    def run(extra, name):
        path = tmp_path / f"{name}.json"
        assert train.main(TRAIN + extra + ["--json-out", str(path)]) == 0
        with open(path) as f:
            return json.load(f)

    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    plain = run([], "plain")
    routed = run(ROUTED, "routed")
    assert set(routed) == set(plain)
    for k in ("loss_first", "loss_last", "mean_step_cost",
              "ledger_hits_mean"):
        assert routed[k] == plain[k], k
    # the JAX trainer's one-device values
    assert (plain["exchange"], plain["capacity_factor"]) == ("none", 1.25)
    assert (routed["exchange"], routed["capacity_factor"],
            routed["a2a_overflow"]) == ("a2a", 0.125, 0)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="Queue 1 item 2"):
        train.main(TRAIN)
