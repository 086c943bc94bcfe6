"""The port's serving engine and CLI against the JAX package's.

The JAX ``Engine`` and the port's ``Engine`` serve the same
``SyntheticLMStream`` requests on the llama3-8b smoke config in float32 at
temperature 0, with 4-token pages, top-k retention and the device ledger:
generated tokens must be equal and the ledgers agree (EMA rtol 1e-5,
integers exact). Sampled decode is checked inside the port only: its noise
is a stateless hash, not JAX's threefry.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _ledger_parity import DERIVED_RTOL, assert_ledger_states_close
from repro import configs as jconfigs
from repro.core import device_ledger as jled
from repro.core.history import HistoryConfig as JHistoryConfig
from repro.core.history import LossHistory as JLossHistory
from repro.models import model as JM
from repro.models.params import materialize as jmaterialize
from repro.serving import Engine as JEngine
from repro.serving import OutcomeRecorder as JRecorder
from repro.serving import recorder as jrec
from repro_torch.core.history import HistoryConfig
from repro_torch.data import DataConfig, SyntheticLMStream
from repro_torch.launch import serve
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import from_jax
from repro_torch.serving import Engine, OutcomeRecorder, make_slot_sampler
from repro_torch.serving import recorder as trec

torch.set_num_threads(1)

JCFG = dataclasses.replace(jconfigs.get_smoke("llama3-8b"),
                           param_dtype="float32", compute_dtype="float32")
CFG = ModelConfig(**dataclasses.asdict(JCFG))
SLOTS, MAX_PROMPT, MAX_GEN, PAGE, TOPK = 4, 8, 6, 4, 16
LEDGER = dict(capacity=1 << 12, decay=0.8)


def _requests(waves=3, seed=3):
    stream = SyntheticLMStream(DataConfig(SLOTS, MAX_PROMPT + MAX_GEN,
                                          CFG.vocab_size, seed=seed))
    out = []
    for w in range(waves):
        raw = stream.batch(w)
        for r in range(SLOTS):
            plen = MAX_PROMPT - (r % 3) * 2
            toks = raw["tokens"][r]
            out.append((toks[:plen], toks[plen:plen + MAX_GEN],
                        int(raw["instance_id"][r])))
    return out


def _drive(engine, reqs):
    for prompt, labels, iid in reqs:
        engine.submit(prompt, max_new=len(labels), labels=labels,
                      instance_id=iid)
    engine.run()
    return engine


def _port_engine(params, slots=SLOTS, **kw):
    rec = OutcomeRecorder(slots, MAX_GEN, CFG.vocab_size,
                          HistoryConfig(**LEDGER), ledger="device",
                          retention="topk", topk=TOPK, device="cpu")
    return Engine(CFG, params, rec, slots=slots, max_prompt=MAX_PROMPT,
                  max_gen=MAX_GEN, **kw)


@pytest.fixture(scope="module")
def params():
    jp = jmaterialize(JM.param_specs(JCFG), jax.random.key(0), jnp.float32)
    return jp, from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def engines(params):
    jp, tp = params
    reqs = _requests()
    jrecd = JRecorder(SLOTS, MAX_GEN, JCFG.vocab_size,
                      JHistoryConfig(**LEDGER), ledger="device",
                      retention="topk", topk=TOPK)
    je = _drive(JEngine(JCFG, jp, jrecd, slots=SLOTS, max_prompt=MAX_PROMPT,
                        max_gen=MAX_GEN, page_size=PAGE), reqs)
    te = _drive(_port_engine(tp, page_size=PAGE), reqs)
    return je, te


def test_engine_tokens_match_jax(engines):
    je, te = engines
    assert set(je.finished) == set(te.finished)
    flips = [i for i in je.finished
             if not np.array_equal(je.finished[i], te.finished[i])]
    assert not flips, f"generated tokens differ for instances {flips}"


def test_engine_ledger_and_counters_match_jax(engines):
    je, te = engines
    assert_ledger_states_close(te.ledger_state_dict(), je.ledger_state_dict(),
                               rtol=DERIVED_RTOL)
    js, ts = je.stats(), te.stats()
    for key in ts:
        assert ts[key] == js[key], key


def test_paged_engine_matches_dense_engine_in_the_port(params):
    _, tp = params
    reqs = _requests(waves=2, seed=7)
    dense = _drive(_port_engine(tp), reqs)
    paged = _drive(_port_engine(tp, page_size=2), reqs)
    for i in dense.finished:
        np.testing.assert_array_equal(dense.finished[i], paged.finished[i])
    assert_ledger_states_close(paged.ledger_state_dict(),
                               dense.ledger_state_dict(), rtol=DERIVED_RTOL)
    st = paged.stats()
    assert st["pages_free"] == st["pages_total"] and st["pages_reserved"] == 0


def test_synthetic_stream_matches_jax():
    from repro.data import DataConfig as JDataConfig
    from repro.data import SyntheticLMStream as JStream

    for kw in (dict(seed=4), dict(seed=1, outlier_frac=0.3,
                                  instance_pool=50)):
        ours = SyntheticLMStream(DataConfig(6, 9, 300, **kw), 1, 2)
        theirs = JStream(JDataConfig(6, 9, 300, **kw), 1, 2)
        for step in (0, 3, 17):
            a, b = ours.batch(step), theirs.batch(step)
            for key in ("tokens", "labels", "instance_id"):
                np.testing.assert_array_equal(a[key], b[key])


def test_full_retention_host_ledger_matches_device_ledger(params):
    """The dense-logits oracle with the ledger on the host and on the
    device: same records."""
    _, tp = params
    reqs = _requests(waves=2, seed=13)
    runs = []
    for ledger in ("host", "device"):
        rec = OutcomeRecorder(SLOTS, MAX_GEN, CFG.vocab_size,
                              HistoryConfig(**LEDGER), ledger=ledger,
                              retention="full", device="cpu")
        runs.append(_drive(Engine(CFG, tp, rec, slots=SLOTS,
                                  max_prompt=MAX_PROMPT, max_gen=MAX_GEN),
                           reqs))
    host, dev = runs
    assert host.stats()["topk_misses"] == 0
    assert_ledger_states_close(dev.ledger_state_dict(),
                               host.ledger_state_dict())


def test_sampled_decode_invariant_to_slot_and_schedule(params):
    """temperature > 0: a rerun, fewer slots and the paged layout give the
    same tokens (noise keyed by instance id, position and token only), and
    sampling leaves the greedy path somewhere."""
    _, tp = params
    reqs = _requests(waves=2, seed=11)
    kw = dict(temperature=0.8, top_p=0.9, sample_seed=3)
    runs = {
        "a": _drive(_port_engine(tp, **kw), reqs),
        "rerun": _drive(_port_engine(tp, **kw), reqs),
        "fewer_slots": _drive(_port_engine(tp, slots=2, **kw), reqs),
        "paged": _drive(_port_engine(tp, page_size=2, **kw), reqs),
        "greedy": _drive(_port_engine(tp), reqs),
    }
    base = runs["a"].finished
    for name in ("rerun", "fewer_slots", "paged"):
        for iid in base:
            np.testing.assert_array_equal(base[iid], runs[name].finished[iid],
                                          err_msg=name)
    assert any(not np.array_equal(base[i], runs["greedy"].finished[i])
               for i in base)


def test_sampler_semantics():
    """temperature <= 0 is argmax; top-p keeps a token iff the sorted mass
    strictly before it is < top_p (top-1 always survives)."""
    logits = torch.randn((3, 64), generator=torch.Generator().manual_seed(2))
    inst = torch.tensor([5, -1, 9], dtype=torch.int32)
    gidx = torch.tensor([0, 2, 7], dtype=torch.int32)
    greedy = make_slot_sampler(0.0, 0.5, 11)
    assert torch.equal(greedy(logits, inst, gidx),
                       torch.argmax(logits, -1).to(torch.int32))
    probs = torch.log(torch.tensor([[0.6, 0.3, 0.05, 0.05]]))
    one = torch.tensor([7], dtype=torch.int32)
    for top_p, allowed in ((0.5, {0}), (0.7, {0, 1}), (1.0, {0, 1, 2, 3})):
        s = make_slot_sampler(1.0, top_p, 0)
        got = {int(s(probs, one, torch.tensor([g], dtype=torch.int32))[0])
               for g in range(300)}
        assert got <= allowed and 0 in got, (top_p, got)
        if top_p == 1.0:
            assert len(got) == 4


def test_topk_score_and_signals_match_jax():
    rs = np.random.default_rng(0)
    logits = (rs.standard_normal((5, 3, 50)) * 2).astype(np.float32)
    labels = rs.integers(-1, 50, (5, 3)).astype(np.int32)
    vals = -np.sort(-logits, axis=-1)[..., :8]
    idx = np.argsort(-logits, axis=-1, kind="stable")[..., :8].astype(np.int32)
    lse = np.log(np.exp(logits).sum(-1)).astype(np.float32)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (vals, idx, lse)]
    for got, want in zip(trec.topk_score(*t, torch.from_numpy(labels)),
                         jrec.topk_score(vals, idx, lse, labels)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    for got, want in zip(trec.topk_signals(t[0], t[2]),
                         jrec.topk_signals(vals, lse)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    for got, want in zip(trec.full_signals(torch.from_numpy(logits), t[2]),
                         jrec.full_signals(logits, lse)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


def test_cli_ledger_out_loads_into_jax(tmp_path, capsys):
    out = tmp_path / "ledger.npz"
    summary = tmp_path / "run.json"
    serve.main([
        "--arch", "llama3-8b", "--smoke", "--device", "cpu", "--batch", "4",
        "--prompt-len", "8", "--gen", "4", "--requests", "6",
        "--page-size", "4", "--retain", "topk", "--topk", "16",
        "--ledger", "device", "--outcome-delay", "1",
        "--ledger-out", str(out), "--json-out", str(summary),
    ])
    text = capsys.readouterr().out
    assert "served 6 requests" in text and "ledger hit rate=1.00" in text
    sd = dict(np.load(out))
    ids = np.asarray(json.loads(summary.read_text())["instance_ids"])
    host = JLossHistory(JHistoryConfig())
    host.load_state_dict(sd)
    assert host.lookup(ids)[1].all()
    dev = jled.state_from_dict(sd)
    assert np.asarray(jled.lookup(dev, ids)[1]).all()
    assert_ledger_states_close(jled.state_dict_of(dev), host.state_dict())
