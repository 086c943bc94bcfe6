"""The port's sharded recycle ledger (``repro_torch.distributed``) against
the JAX package's.

In this process, against JAX on one device: ``a2a_capacity`` and
``exchange_bytes_per_op`` over a grid, ``bin_by_home`` (its invariants and
its answers on the same arrays), the state-dict migration helpers with the
pinned marker, ``record(order=)`` on a batch that arrives out of order,
``lookup(variant="onehot")``, the ``DeviceLedger`` class, and the data-axis
mesh as a group of one.

Then four gloo ranks (``tests/_torch_ranks.py``, one subprocess each) run
the five ops for five steps under every placement (pinned; routed gather;
routed a2a at capacity factors 0.125, 1.25 and 4) on a balanced and a
skewed stream. JAX's module doc says what they must equal: a routed table
is the single global table fed the global batch, and a pinned table is
four single tables, one per rank's segment. So the references run on one
device here, never as the JAX ``shard_map`` programs: the port's own
tables must be equal bit for bit, JAX's to the convention of
``tests/_ledger_parity.py`` (integers equal, EMA to rtol 1e-6, priorities
1e-5).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_ranks as R
from _ledger_parity import DERIVED_RTOL, EMA_RTOL
from repro.core import device_ledger as jled
from repro.core.history import HistoryConfig as JHistoryConfig
from repro.core.history import LossHistory as JLossHistory
from repro.distributed import ledger as jdl
from repro_torch.core import device_ledger as dl
from repro_torch.core.history import HistoryConfig, LossHistory
from repro_torch.distributed import ledger as tdl
from repro_torch.launch import mesh as tmesh

torch.set_num_threads(1)


def test_a2a_capacity_and_exchange_bytes_match_jax():
    for b, s, cf in itertools.product((1, 7, 16, 32, 100), (1, 2, 4, 8),
                                      (0.125, 0.5, 1.0, 1.25, 4.0, 8.0)):
        assert tdl.a2a_capacity(b, s, cf) == jdl.a2a_capacity(b, s, cf)
        for ex, ovf in itertools.product(tdl.EXCHANGES, (False, True)):
            assert tdl.exchange_bytes_per_op(ex, s, b, cf, overflow=ovf) \
                == jdl.exchange_bytes_per_op(ex, s, b, cf, overflow=ovf)
    with pytest.raises(ValueError):
        tdl.a2a_capacity(8, 4, 0.0)
    with pytest.raises(ValueError):
        tdl.exchange_bytes_per_op("ring", 4, 8)


def test_the_ports_a2a_never_moves_fewer_bytes_than_gather():
    """The port runs the residual round on every op that can overflow, so
    its a2a cost (``overflow=None``) is JAX's overflow-step cost there and
    its overflow-free cost elsewhere, and never below gather's."""
    for b, s, cf in itertools.product((1, 7, 16, 32, 100), (1, 2, 4, 8),
                                      (0.125, 0.5, 1.0, 1.25, 4.0, 8.0)):
        res = tdl.residual_round(b, s, cf)
        assert res == (tdl.a2a_capacity(b, s, cf) < b)
        port = tdl.exchange_bytes_per_op("a2a", s, b, cf)
        assert port == jdl.exchange_bytes_per_op("a2a", s, b, cf,
                                                 overflow=res)
        assert port >= tdl.exchange_bytes_per_op("gather", s, b, cf)


@pytest.mark.parametrize("seed,shards,cap,masked", [
    (0, 4, 1, False), (1, 4, 3, True), (2, 2, 5, True), (3, 8, 2, False),
    (4, 1, 4, True), (5, 4, 40, True)])
def test_bin_by_home_invariants_and_jax_parity(seed, shards, cap, masked):
    rs = np.random.default_rng(seed)
    n = 37
    home = rs.integers(0, shards, n)
    active = rs.random(n) < 0.7 if masked else np.ones(n, bool)
    pos, kept, ovf = (x.numpy() for x in tdl.bin_by_home(
        torch.from_numpy(home), shards, cap, torch.from_numpy(active)))
    jpos, jkept, jovf = (np.asarray(x) for x in jdl.bin_by_home(
        jnp.asarray(home, jnp.int32), shards, cap, jnp.asarray(active)))
    np.testing.assert_array_equal(kept, jkept)
    np.testing.assert_array_equal(ovf, jovf)
    np.testing.assert_array_equal(pos[active], jpos[active])
    # kept and overflow partition the active set
    assert not (kept & ovf).any() and ((kept | ovf) == active).all()
    # each home's kept rows are 0..k-1, k <= cap, earlier items first
    for h in range(shards):
        mine = np.flatnonzero(kept & (home == h))
        np.testing.assert_array_equal(pos[mine], np.arange(mine.size))
        assert mine.size <= cap
        assert mine.size == min(cap, int((active & (home == h)).sum()))
    # a permuted batch bins the same items (the split may move)
    perm = rs.permutation(n)
    _, pk, po = tdl.bin_by_home(torch.from_numpy(home[perm]), shards, cap,
                                torch.from_numpy(active[perm]))
    np.testing.assert_array_equal((pk | po).numpy(), (kept | ovf)[perm])


def _filled_history(cap=256, n=120, seed=0):
    rs = np.random.default_rng(seed)
    h = LossHistory(HistoryConfig(capacity=cap, decay=0.8))
    for step in range(1, 4):
        h.record(rs.integers(0, 4 * cap, n), rs.random(n) * 3, step,
                 signals=rs.standard_normal((n, 2)).astype(np.float32))
    return h.state_dict()


def test_split_and_merge_state_dicts_match_jax():
    sd = _filled_history()
    parts = tdl.split_state_dict(sd, 4)
    for p, jp in zip(parts, jdl.split_state_dict(sd, 4)):
        for k in sd:
            np.testing.assert_array_equal(p[k], jp[k], err_msg=k)
    back = tdl.merge_shard_state_dicts(parts)
    jback = jdl.merge_shard_state_dicts(parts)
    for k in sd:  # the hash-home split is lossless
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)
        np.testing.assert_array_equal(back[k], jback[k], err_msg=k)
    # four pinned tables (records on consumer shards) merge as JAX merges
    pinned = [_filled_history(cap=64, n=30, seed=s) for s in range(4)]
    got = tdl.merge_shard_state_dicts(pinned, 256)
    want = jdl.merge_shard_state_dicts(pinned, 256)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # a pinned export loads into any other table by re-hashing
    raw = {k: np.concatenate([p[k] for p in pinned]) for k in pinned[0]}
    raw["pinned_shards"] = np.int64(4)
    led = dl.DeviceLedger(HistoryConfig(capacity=256, decay=0.8), "cpu")
    led.load_state_dict(raw)
    jh = JLossHistory(JHistoryConfig(capacity=256, decay=0.8))
    jh.load_state_dict(raw)
    for k, v in led.state_dict().items():
        np.testing.assert_array_equal(v, jh.state_dict()[k], err_msg=k)
    with pytest.raises(ValueError):
        tdl.split_state_dict(sd, 3)


CAP = 256
JCFG = JHistoryConfig(capacity=CAP, decay=0.8, staleness_half_life=50.0)
TCFG = HistoryConfig(capacity=CAP, decay=0.8, staleness_half_life=50.0)


def _dup_batch(rs, b=40):
    ids = rs.integers(0, 3 * CAP, b)
    ids[10:14] = ids[0]  # one id five times
    ids[20] = ids[30]
    return (ids, (rs.random(b) * 4).astype(np.float32), rs.random(b) < 0.8,
            rs.standard_normal((b, 2)).astype(np.float32))


def test_record_order_keys_pick_the_winner_out_of_arrival_order():
    """The routed a2a write records a batch in arrival order with its
    global positions as ``order``: the table must be the in-order one,
    whatever the arrival, and JAX's ``record(order=)`` on the same
    arrival."""
    rs = np.random.default_rng(0)
    st = dl.init_state(TCFG, "cpu")
    jst = jled.init_state(JCFG)
    for step in range(1, 5):
        ids, loss, valid, sig = _dup_batch(rs)
        perm = rs.permutation(ids.size)
        t = (torch.from_numpy(ids), torch.from_numpy(loss))
        want = dl.record(TCFG, st, *t, step, valid=torch.from_numpy(valid),
                         signals=torch.from_numpy(sig))
        st = dl.record(
            TCFG, st, t[0][perm], t[1][perm], step,
            valid=torch.from_numpy(valid[perm]),
            signals=torch.from_numpy(sig[perm]),
            order=torch.from_numpy(perm.astype(np.int32)))
        for k, v in dl.state_dict_of(want).items():
            np.testing.assert_array_equal(dl.state_dict_of(st)[k], v, k)
        jst = jled.record(JCFG, jst, jnp.asarray(ids[perm], jnp.int32),
                          jnp.asarray(loss[perm]), step,
                          valid=jnp.asarray(valid[perm]),
                          signals=jnp.asarray(sig[perm]),
                          order=jnp.asarray(perm, jnp.int32))
        got, jsd = dl.state_dict_of(st), jled.state_dict_of(jst)
        for k in ("count", "last_seen", "owner"):
            np.testing.assert_array_equal(got[k], jsd[k], err_msg=k)
        for k in ("ema", "sig"):
            np.testing.assert_allclose(got[k], jsd[k], rtol=EMA_RTOL)


def test_lookup_onehot_equals_gather_and_jax():
    rs = np.random.default_rng(1)
    st = dl.init_state(TCFG, "cpu")
    jst = jled.init_state(JCFG)
    ids, loss, valid, sig = _dup_batch(rs)
    st = dl.record(TCFG, st, torch.from_numpy(ids), torch.from_numpy(loss), 1)
    jst = jled.record(JCFG, jst, jnp.asarray(ids, jnp.int32),
                      jnp.asarray(loss), 1)
    probe = np.concatenate([ids, rs.integers(0, 3 * CAP, 20)])
    ema, seen = dl.lookup(st, torch.from_numpy(probe), variant="onehot")
    gema, gseen = dl.lookup(st, torch.from_numpy(probe))
    np.testing.assert_array_equal(ema.numpy(), gema.numpy())
    np.testing.assert_array_equal(seen.numpy(), gseen.numpy())
    jema, jseen = jled.lookup(jst, jnp.asarray(probe, jnp.int32),
                              variant="onehot")
    np.testing.assert_array_equal(seen.numpy(), np.asarray(jseen))
    np.testing.assert_allclose(ema.numpy(), np.asarray(jema), rtol=EMA_RTOL)
    with pytest.raises(ValueError):
        dl.lookup(st, torch.from_numpy(probe), variant="scan")


def test_device_ledger_class_matches_jax():
    rs = np.random.default_rng(2)
    led = dl.DeviceLedger(TCFG, "cpu")
    jl = jled.DeviceLedger(JCFG)
    for step in range(1, 4):
        ids, loss, valid, sig = _dup_batch(rs)
        led.record(ids, loss, step, valid=valid, signals=sig)
        jl.record(jnp.asarray(ids, jnp.int32), jnp.asarray(loss), step,
                  jnp.asarray(valid), jnp.asarray(sig))
        probe = np.concatenate([ids, rs.integers(0, 3 * CAP, 8)])
        jp = jnp.asarray(probe, jnp.int32)
        for got, want, rtol in (
                (led.lookup(probe), jl.lookup(jp), EMA_RTOL),
                (led.lookup(probe, "onehot"), jl.lookup(jp, "onehot"),
                 EMA_RTOL),
                (led.lookup_signals(probe), jl.lookup_signals(jp), EMA_RTOL),
                ((led.priority(probe, step + 3),),
                 (jl.priority(jp, step + 3),), DERIVED_RTOL)):
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=rtol)
        ids, loss, valid, sig = _dup_batch(rs)
        pri = led.record_priority(ids, loss, step, valid=valid, signals=sig)
        jpri = jl.record_priority(jnp.asarray(ids, jnp.int32),
                                  jnp.asarray(loss), step,
                                  valid=jnp.asarray(valid),
                                  signals=jnp.asarray(sig))
        np.testing.assert_allclose(pri.numpy(), np.asarray(jpri),
                                   rtol=DERIVED_RTOL)
    got, want = led.state_dict(), jl.state_dict()
    for k in ("count", "last_seen", "owner"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("ema", "sig"):
        np.testing.assert_allclose(got[k], want[k], rtol=EMA_RTOL)
    host = led.to_host()
    back = dl.DeviceLedger.from_host(host, "cpu")
    for k, v in got.items():
        np.testing.assert_array_equal(host.state_dict()[k], v, err_msg=k)
        np.testing.assert_array_equal(back.state_dict()[k], v, err_msg=k)


def test_mesh_is_a_group_of_one_without_torchrun(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="1 devices not divisible by TP=2"):
        tmesh.make_elastic_mesh(2, device="cpu")  # JAX's check, no group
    assert not dist.is_initialized()
    mesh = tmesh.make_elastic_mesh(device="cpu")
    try:
        assert (mesh.rank, mesh.size, mesh.backend) == (0, 1, "gloo")
        assert mesh.shape == {"data": 1, "model": 1}
        assert tmesh.validate_batch(8, mesh) == 8
        assert tmesh.world_size() == 1
        joined = tmesh.make_elastic_mesh(device="cpu")  # the same group
        assert not joined.owns_group
        with pytest.raises(ValueError):
            tmesh.make_elastic_mesh(device="cpu", backend="nccl")
        with pytest.raises(ValueError):  # JAX's checks
            tdl.sharded_ledger_ops(mesh, HistoryConfig(capacity=96))
        with pytest.raises(ValueError):
            tdl.sharded_ledger_ops(mesh, TCFG, exchange="ring")
        with pytest.raises(ValueError):
            tdl.sharded_ledger_ops(mesh, TCFG, capacity_factor=0.0)
        # one rank: every placement is the single table
        ids = torch.arange(40) * 7
        for route, ex in ((False, "gather"), (True, "gather"),
                          (True, "a2a")):
            ops = tdl.sharded_ledger_ops(mesh, TCFG, route=route,
                                         exchange=ex, capacity_factor=0.125)
            st, pri, stats = ops.record_priority(
                ops.init(), ids, ids.float() / 40, 1, return_stats=True)
            one, opri = dl.record_priority(TCFG, dl.init_state(TCFG, "cpu"),
                                           ids, ids.float() / 40, 1)
            np.testing.assert_array_equal(pri.numpy(), opri.numpy())
            # a2a: a capacity of ceil(40 * 0.125) = 5 rows, 35 residual
            assert int(stats["a2a_overflow"]) == (35 if ex == "a2a" else 0)
            for k, v in dl.state_dict_of(one).items():
                np.testing.assert_array_equal(ops.state_dict(st)[k], v, k)
    finally:
        mesh.close()
    assert not dist.is_initialized()


# -- four gloo ranks ------------------------------------------------------------


class _Lib:
    """The single-table functions of one package on host arrays."""

    def __init__(self, jax_side: bool):
        self.jax = jax_side

    def _ids(self, x):
        return jnp.asarray(x, jnp.int32) if self.jax else torch.from_numpy(x)

    def _arr(self, x):
        return jnp.asarray(x) if self.jax else torch.from_numpy(x)

    def cfg(self, capacity):
        kw = dict(R.LEDGER_CFG, capacity=capacity)
        return JHistoryConfig(**kw) if self.jax else HistoryConfig(**kw)

    def init(self, cfg):
        return jled.init_state(cfg) if self.jax else dl.init_state(cfg, "cpu")

    def step(self, cfg, st, x, t):
        m = jled if self.jax else dl
        a = self._arr
        st = m.record(cfg, st, self._ids(x["rec_ids"]), a(x["rec_loss"]), t,
                      valid=a(x["rec_valid"]), signals=a(x["rec_sig"]))
        read = self._ids(x["read_ids"])
        ema, seen = m.lookup(st, read)
        ema2, sig, seen2 = m.lookup_signals(st, read)
        pri = m.priority(cfg, st, read, t)
        st, pri2 = m.record_priority(cfg, st, self._ids(x["rp_ids"]),
                                     a(x["rp_loss"]), t,
                                     valid=a(x["rp_valid"]),
                                     signals=a(x["rp_sig"]))
        out = dict(ema=ema, seen=seen, ema2=ema2, sig=sig, seen2=seen2,
                   pri=pri, pri2=pri2)
        return st, {k: np.asarray(v) for k, v in out.items()}

    def state_dict(self, st):
        return jled.state_dict_of(st) if self.jax else dl.state_dict_of(st)


def _reference(lib: _Lib, stream: str, route: bool):
    """The single tables the sharded ones must equal -> (per step the
    answers over the global batch, the table in the export layout)."""
    n = R.WORLD * R.B
    if route:
        parts = [(lib.cfg(R.CAP), slice(0, n))]
    else:
        parts = [(lib.cfg(R.CAP // R.WORLD), slice(r * R.B, (r + 1) * R.B))
                 for r in range(R.WORLD)]
    states = [lib.init(cfg) for cfg, _ in parts]
    answers = []
    for t, g in enumerate(R.ledger_stream(stream), start=1):
        per = []
        for j, (cfg, seg) in enumerate(parts):
            states[j], a = lib.step(cfg, states[j],
                                    {k: g[k][seg] for k in R.FIELDS}, t)
            per.append(a)
        answers.append({k: np.concatenate([a[k] for a in per])
                        for k in per[0]})
    sds = [lib.state_dict(s) for s in states]
    return answers, {k: np.concatenate([s[k] for s in sds]) for k in sds[0]}


INT_FIELDS = ("count", "last_seen", "owner")


def test_four_gloo_ranks_match_the_single_tables(tmp_path):
    procs = R.start("ledger", tmp_path)
    refs = {}  # built on one device while the ranks run
    for stream, route in itertools.product(R.STREAMS, (False, True)):
        refs[stream, route] = (_reference(_Lib(False), stream, route),
                               _reference(_Lib(True), stream, route))
    ranks = R.finish(procs, "ledger", tmp_path)

    def gathered(key):  # the ranks' segments in rank order
        return np.concatenate([r[key] for r in ranks])

    for stream, (name, (route, exchange, cf)) in itertools.product(
            R.STREAMS, R.PLACEMENTS.items()):
        key = f"{stream}/{name}"
        (port, port_sd), (jax_, jax_sd) = refs[stream, route]
        steps = R.ledger_stream(stream)
        cap = tdl.a2a_capacity(R.B, R.WORLD, cf)
        for t, g in enumerate(steps, start=1):
            for k in port[0]:
                got = gathered(f"{key}/{t}/{k}")
                np.testing.assert_array_equal(got, port[t - 1][k],
                                              err_msg=f"{key} {t} {k}")
                if got.dtype == bool:
                    np.testing.assert_array_equal(got, jax_[t - 1][k])
                    continue
                rtol = DERIVED_RTOL if k.startswith("pri") else EMA_RTOL
                np.testing.assert_allclose(got, jax_[t - 1][k], rtol=rtol,
                                           err_msg=f"jax {key} {t} {k}")
            a2a = exchange == "a2a" and route
            want_rec = R.expected_overflow(g["rec_ids"], g["rec_valid"],
                                           cap) if a2a else 0
            want_rp = R.expected_overflow(
                g["rp_ids"], np.ones(g["rp_ids"].size, bool),
                cap) if a2a else 0
            for r in ranks:  # the group's count, on every rank
                assert r[f"{key}/{t}/ovf_rec"] == want_rec, (key, t)
                assert r[f"{key}/{t}/ovf_rp"] == want_rp, (key, t)
        for r in ranks:
            sd = {k[len(key) + 4:]: v for k, v in r.items()
                  if k.startswith(f"{key}/sd/")}
            assert ("pinned_shards" in sd) == (not route), key
            for k in port_sd:
                np.testing.assert_array_equal(sd[k], port_sd[k],
                                              err_msg=f"{key} {k}")
                if k in INT_FIELDS:
                    np.testing.assert_array_equal(sd[k], jax_sd[k])
                else:
                    np.testing.assert_allclose(sd[k], jax_sd[k],
                                               rtol=EMA_RTOL)
            gsd = {k: r[f"{stream}/gather/sd/{k}"] for k in port_sd}
            if route:  # every routed table is the gather table
                for k in gsd:
                    np.testing.assert_array_equal(sd[k], gsd[k], err_msg=k)
        # where the stream overflows the a2a capacity
        ovf = [int(ranks[0][f"{key}/{t}/ovf_rec"])
               + int(ranks[0][f"{key}/{t}/ovf_rp"])
               for t in range(1, R.STEPS + 1)]
        if name == "a2a-0.125" or (name == "a2a-1.25"
                                   and stream == "skewed"):
            assert min(ovf) > 0, (key, ovf)
        else:
            assert max(ovf) == 0, (key, ovf)
