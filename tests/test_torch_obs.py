"""The port's telemetry layer (``repro_torch.obs``) against the JAX
package's (``repro.obs``).

The units on the same inputs through both: the registry's snapshot, the
event log's rows (a torn last line skipped), a trace's events saved and
loaded (and bounded, the oldest kept), ``rate_of`` and ``ledger_drift``.
A disabled telemetry hands out the shared null instruments and spans, and
an engine built under it keeps no drift shadow. Then both CLIs of each
package run in this process on the same smoke arguments with
``--metrics-out`` and ``--trace-out``: the metric names, the event kinds,
the ``loop_health`` keys, the spans and the summary's keys are the JAX
CLIs' (the port's summary adds its own named keys), and the engine's
counters equal ``Engine.stats()``.
"""

import json

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.launch import serve as jserve
from repro.launch import train as jtrain
from repro_torch import configs, obs
from repro_torch.core.history import HistoryConfig
from repro_torch.launch import serve, train
from repro_torch.models import model as M
from repro_torch.models.params import materialize
from repro_torch.serving import Engine, OutcomeRecorder

torch.set_num_threads(1)

# the port's summary keys beyond the JAX CLIs' (the card's checks read them)
SERVE_EXTRAS = {"seconds", "device", "layers", "guarded_steps", "step_ms",
                "instance_ids"}
TRAIN_EXTRAS = {"moe_dropped_share", "device", "layers", "guarded_steps",
                "step_ms"}


@pytest.fixture(autouse=True)
def telemetry_off():
    """A CLI installs its telemetry process-wide: put both packages back
    to the disabled default after each test."""
    yield
    obs.install(obs.OFF)
    jobs.install(jobs.OFF)


def _drive_units(pkg, tmp_path):
    """The same calls through one package's units -> what they give."""
    reg = pkg.MetricsRegistry()
    c = reg.counter("reqs", path="admit")
    c.inc()
    c.inc(4)
    assert reg.counter("reqs", path="admit") is c
    reg.gauge("occupancy").set(0.75)
    h = reg.histogram("lat_ms", bounds=(1.0, 10.0))
    for v in (0.5, 5.0, 50.0, 10.0):
        h.observe(v)
    reg.histogram("empty_ms")
    path = tmp_path / f"{pkg.__name__}.jsonl"
    log = pkg.EventLog(str(path))
    log.write("loop_health", steps=3, rate=np.float32(0.5),
              arr=np.arange(2))
    log.write("summary", done=True)
    log.close()
    with open(path, "a") as f:
        f.write('{"torn')
    rows = [{k: v for k, v in r.items() if k != "t"}
            for r in pkg.read_jsonl(str(path))]
    tr = pkg.TraceRecorder(max_events=3)
    with tr.span("outer", cat="test", k=1):
        with tr.span("inner"):
            pass
    for i in range(3):
        tr.instant(f"e{i}", cat="mark", i=i)
    tpath = tmp_path / f"{pkg.__name__}.trace.json"
    tr.save(str(tpath))
    events = [{k: e[k] for k in ("ph", "name", "cat", "args", "s")
               if k in e} for e in pkg.load_trace(str(tpath))]
    with open(tpath) as f:
        other = json.load(f)["otherData"]
    sd = {"owner": np.array([1, 2, -1, 4]),
          "ema": np.array([1.0, 2.0, 3.0, 0.0]),
          "sig": np.array([[1.0, 2.0], [0.5, 0.0], [1.0, 1.0], [0, 0]])}
    dev = {"owner": np.array([1, 2, 5, 3]),
           "ema": np.array([1.0, 2.5, 3.0, 1.0]),
           "sig": np.array([[1.5, 2.0], [0.5, 0.0], [9.0, 1.0], [0, 0]])}
    drift = pkg.ledger_drift(sd, dev, ("entropy", "margin"))
    empty = pkg.ledger_drift(sd, {**dev, "owner": -np.ones(4, int)},
                             ("entropy",))
    rates = [pkg.rate_of(3, 4), pkg.rate_of(3, 0), pkg.rate_of(0.5, 2)]
    return reg.snapshot(), rows, events, other, drift, empty, rates, \
        pkg.series_key("x", {"b": 1, "a": 2}), pkg.DEFAULT_MS_BUCKETS


def test_units_equal_the_jax_package(tmp_path):
    mine = _drive_units(obs, tmp_path)
    want = _drive_units(jobs, tmp_path)
    assert mine == want
    snap, rows, events, other = mine[:4]
    assert snap["counters"]["reqs{path=admit}"] == 5
    assert snap["histograms"]["lat_ms"]["buckets"] == \
        {"le_1": 1, "le_10": 2, "inf": 1}
    assert [r["kind"] for r in rows] == ["loop_health", "summary"]
    assert rows[0]["arr"] == [0, 1] and rows[0]["seq"] == 0
    # bounded: the run's head kept, the rest counted
    assert [e["name"] for e in events] == ["inner", "outer", "e0"]
    assert events[1]["args"] == {"k": 1} and other["dropped_events"] == 2
    assert mine[4]["slots_compared"] == 2.0 and mine[4]["ema"] == 0.2
    assert mine[5] == {"slots_compared": 0.0, "ema": 0.0, "entropy": 0.0}


def test_disabled_default_binds_null_instruments():
    t = obs.current()
    assert t is obs.OFF and not t.enabled
    for inst in (t.counter("x"), t.gauge("x"), t.histogram("x")):
        assert inst is obs.NULL_INSTRUMENT
    assert t.span("s") is obs.NULL_SPAN and obs.span("s") is obs.NULL_SPAN
    t.counter("x").inc(3)
    t.event("never", x=1)
    obs.mark("m")
    assert t.snapshot() == {} and t.registry is None and t.events is None
    t.close(summary={"unused": True})
    cfg = configs.get_smoke("llama3-8b")
    params = materialize(M.param_specs(cfg), 0, torch.float32, "cpu")
    rec = OutcomeRecorder(2, 3, cfg.vocab_size, HistoryConfig(1 << 8),
                          ledger="device", device="cpu")
    eng = Engine(cfg, params, rec, slots=2, max_prompt=8, max_gen=3)
    assert eng.telemetry is obs.OFF and eng._shadow is None
    assert eng._c_steps is obs.NULL_INSTRUMENT
    eng.submit(np.arange(1, 6), 3, np.arange(3))
    eng.run()
    h = eng.loop_health(drift=True)
    assert "ledger_drift" not in h and h["steps"] == eng.steps_run > 0


SERVE = ["--arch", "llama3-8b", "--smoke", "--batch", "2", "--requests", "5",
         "--prompt-len", "8", "--gen", "4", "--retain", "topk", "--topk",
         "8", "--ledger", "device", "--metrics-every", "3"]


def _telemetry_run(main, argv, tmp_path, name):
    m, t, j = (str(tmp_path / f"{name}.{ext}")
               for ext in ("jsonl", "trace.json", "json"))
    assert main(argv + ["--metrics-out", m, "--trace-out", t,
                        "--json-out", j]) == 0
    rows = obs.read_jsonl(m)
    with open(j) as f:
        summary = json.load(f)
    spans = {e["name"] for e in obs.load_trace(t)}
    return rows, summary, spans


def _names(snapshot):
    return {kind: set(series) for kind, series in snapshot.items()}


@pytest.mark.parametrize("page_size", ["0", "4"], ids=["dense", "paged"])
def test_serve_cli_writes_the_jax_names(tmp_path, page_size):
    argv = SERVE + ["--page-size", page_size]
    rows, summary, spans = _telemetry_run(
        serve.main, argv + ["--device", "cpu"], tmp_path, "port")
    jrows, jsummary, jspans = _telemetry_run(jserve.main, argv, tmp_path,
                                             "jax")
    assert [r["kind"] for r in rows] == [r["kind"] for r in jrows]
    assert rows[-1]["kind"] == "summary" and len(rows) > 2
    for r, jr in zip(rows[:-1], jrows[:-1]):
        assert set(r) == set(jr)
        assert set(r["ledger_drift"]) == set(jr["ledger_drift"])
        assert r["ledger_drift"]["ema"] < 1e-4
    assert set(rows[-1]) == set(jrows[-1]) | SERVE_EXTRAS
    assert set(summary) == set(jsummary) | SERVE_EXTRAS
    assert set(summary["health"]) == set(jsummary["health"])
    assert _names(summary["metrics"]) == _names(jsummary["metrics"])
    assert spans == jspans >= {"engine.admit", "engine.prefill",
                               "engine.decode_step", "engine.fetch_metrics",
                               "engine.evict_fetch"}
    c = summary["metrics"]["counters"]
    for counter, stat in (("steps", "steps"), ("admitted", "admitted"),
                          ("evicted", "evicted"),
                          ("generated_tokens", "generated_tokens"),
                          ("ledger_records", "recorded"),
                          ("topk_miss", "topk_misses"),
                          ("missed_outcomes", "missed_outcomes"),
                          ("a2a_overflow", "a2a_overflow")):
        assert c[f"engine.{counter}"] == summary[stat], counter
    if page_size != "0":
        assert c["engine.deferred_admissions"] == \
            summary["deferred_admissions"]
    assert summary["metrics"]["histograms"]["engine.step_ms"]["count"] == \
        summary["steps"]
    # the engine counts as the JAX engine does on the same requests
    assert {k: summary[k] for k in jsummary if k in (
        "admitted", "evicted", "steps", "generated_tokens", "recorded")} == \
        {k: jsummary[k] for k in jsummary if k in (
            "admitted", "evicted", "steps", "generated_tokens", "recorded")}


def test_train_cli_writes_the_jax_names(tmp_path):
    argv = ["--arch", "llama3-8b", "--smoke", "--steps", "4",
            "--global-batch", "8", "--seq-len", "16", "--recycle",
            "--ledger", "device", "--instance-pool", "16",
            "--metrics-every", "2", "--log-every", "4"]
    rows, summary, spans = _telemetry_run(
        train.main, argv + ["--device", "cpu", "--ckpt-dir",
                            str(tmp_path / "port_ckpt")], tmp_path, "port")
    jrows, jsummary, jspans = _telemetry_run(
        jtrain.main, argv + ["--ckpt-dir", str(tmp_path / "jax_ckpt")],
        tmp_path, "jax")
    kinds = [r["kind"] for r in rows]
    assert kinds == [r["kind"] for r in jrows] == \
        ["loop_health", "loop_health", "summary"]
    assert set(rows[0]) == set(jrows[0])
    assert set(summary) == set(jsummary) | TRAIN_EXTRAS
    assert set(rows[-1]) == set(jrows[-1]) | TRAIN_EXTRAS
    assert set(summary["health"]) == set(jsummary["health"])
    assert _names(summary["metrics"]) == _names(jsummary["metrics"])
    assert spans == jspans >= {"train.step", "train.fetch_metrics",
                               "checkpoint.fetch", "checkpoint.save"}
    c = summary["metrics"]["counters"]
    assert c["trainer.steps"] == 4 and c["trainer.a2a_overflow"] == 0
    g = summary["metrics"]["gauges"]
    assert g["trainer.step_cost"] == pytest.approx(0.75)
    assert g["trainer.step_cost_savings"] == pytest.approx(0.75)
    assert g["trainer.loss"] == pytest.approx(summary["loss_last"])
    assert summary["metrics"]["histograms"]["trainer.step_ms"]["count"] == 4
    # a resume reads the checkpoint back under its span
    rows, _, spans = _telemetry_run(
        train.main, argv + ["--device", "cpu", "--steps", "5", "--ckpt-dir",
                            str(tmp_path / "port_ckpt"), "--resume", "auto"],
        tmp_path, "resume")
    assert "checkpoint.restore" in spans
