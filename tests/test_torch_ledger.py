"""The port's ledger against the JAX package's: hash, record semantics and
the ``.npz`` interchange in both directions.

Tolerances follow ``tests/_ledger_parity.py``: EMA channels to rtol 1e-6,
integer tables bit-exact.
"""

import numpy as np
import pytest
import torch

from _ledger_parity import assert_ledger_states_close
from repro.core import device_ledger as jled
from repro.core.history import HistoryConfig as JHistoryConfig
from repro.core.history import LossHistory as JLossHistory
from repro.core.history import slot_for as jslot_for
from repro_torch.core import device_ledger as tled
from repro_torch.core.history import HistoryConfig, LossHistory

torch.set_num_threads(1)

CAP = 1 << 10
JCFG = JHistoryConfig(capacity=CAP, decay=0.8, staleness_half_life=50.0)
TCFG = HistoryConfig(capacity=CAP, decay=0.8, staleness_half_life=50.0)


def test_slot_for_matches_numpy_and_jax_on_wrapping_ids():
    """The uint32 multiply must wrap: ids near and past 2^31 / 2^32 and
    negative ones hit the same slots in all three implementations."""
    ids = np.asarray([0, 1, 2, 12345, 2**20, 2**31 - 1, 2**31, 2**32 - 1,
                      2**32 + 7, -1, -2**31, 987654321], np.int64)
    want = jslot_for(ids, CAP)
    got = tled.slot_for_torch(torch.from_numpy(ids), CAP).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        np.asarray(jled.slot_for_jnp(np.asarray(ids[:7], np.int32), CAP)),
        want[:7],
    )


def _batches(seed=0, n=5, b=24):
    """Batches with in-batch duplicate ids and slot collisions (ids spread
    over 3x the capacity), random valid masks and signals."""
    rs = np.random.default_rng(seed)
    for step in range(1, n + 1):
        ids = rs.integers(0, 3 * CAP, size=b).astype(np.int64)
        ids[b // 2:b // 2 + 4] = ids[0]  # the same id four more times
        yield (ids, rs.random(b).astype(np.float32) * 5,
               rs.random(b) < 0.8,
               rs.standard_normal((b, 2)).astype(np.float32), step)


@pytest.mark.parametrize("use_valid,use_signals", [(False, False),
                                                   (True, True),
                                                   (True, False)])
def test_record_matches_jax_device_ledger(use_valid, use_signals):
    js = jled.init_state(JCFG)
    ts = tled.init_state(TCFG, "cpu")
    for ids, losses, valid, sig, step in _batches():
        kw_j = dict(valid=valid if use_valid else None,
                    signals=sig if use_signals else None)
        js = jled.record(JCFG, js, ids, losses, step, **kw_j)
        ts = tled.record(
            TCFG, ts, torch.from_numpy(ids), torch.from_numpy(losses),
            torch.tensor(step),
            valid=torch.from_numpy(valid) if use_valid else None,
            signals=torch.from_numpy(sig) if use_signals else None,
        )
    assert_ledger_states_close(tled.state_dict_of(ts), jled.state_dict_of(js))
    ids = np.arange(0, 3 * CAP, 7, dtype=np.int64)
    je, js_ = jled.lookup(js, ids)
    te, ts_ = tled.lookup(ts, torch.from_numpy(ids))
    np.testing.assert_array_equal(ts_.numpy(), np.asarray(js_))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-6)
    np.testing.assert_allclose(
        tled.priority(TCFG, ts, torch.from_numpy(ids), 9).numpy(),
        np.asarray(jled.priority(JCFG, js, ids, 9)), rtol=1e-5,
    )
    jsig = jled.lookup_signals(js, ids)[1]
    np.testing.assert_allclose(
        tled.lookup_signals(ts, torch.from_numpy(ids))[1].numpy(),
        np.asarray(jsig), rtol=1e-6,
    )


def test_duplicate_ids_last_write_wins():
    """Four writes of one id in one batch: the last one wins, as numpy's
    fancy assignment (and the host LossHistory) does."""
    ids = torch.tensor([5, 5, 5, 5])
    losses = torch.tensor([1.0, 2.0, 3.0, 4.0])
    st = tled.record(TCFG, tled.init_state(TCFG, "cpu"), ids, losses,
                     torch.tensor(3))
    host = LossHistory(TCFG)
    host.record(ids.numpy(), losses.numpy(), 3)
    assert_ledger_states_close(tled.state_dict_of(st), host.state_dict())
    ema, seen = tled.lookup(st, torch.tensor([5]))
    assert bool(seen[0]) and float(ema[0]) == pytest.approx(4.0)


def test_masked_items_never_write():
    st = tled.record(TCFG, tled.init_state(TCFG, "cpu"), torch.tensor([9, 9]),
                     torch.tensor([1.0, 7.0]), torch.tensor(1),
                     valid=torch.tensor([True, False]))
    assert float(tled.lookup(st, torch.tensor([9]))[0][0]) == \
        pytest.approx(1.0)
    st = tled.record(TCFG, st, torch.tensor([3]), torch.tensor([2.0]),
                     torch.tensor(2), valid=torch.tensor([False]))
    assert not bool(tled.lookup(st, torch.tensor([3]))[1][0])


def test_npz_interchange_both_directions(tmp_path):
    ts = tled.init_state(TCFG, "cpu")
    for ids, losses, valid, sig, step in _batches(seed=2):
        ts = tled.record(TCFG, ts, torch.from_numpy(ids),
                         torch.from_numpy(losses), torch.tensor(step),
                         signals=torch.from_numpy(sig))
    path = tmp_path / "port.npz"
    np.savez(path, **tled.state_dict_of(ts))
    # port -> JAX: host LossHistory and device_ledger both load it
    jh = JLossHistory(JCFG)
    jh.load_state_dict(dict(np.load(path)))
    assert_ledger_states_close(jh.state_dict(), tled.state_dict_of(ts))
    js = jled.state_from_dict(dict(np.load(path)))
    assert_ledger_states_close(jled.state_dict_of(js), tled.state_dict_of(ts))
    # JAX -> port, after one more JAX record
    ids, losses, _, sig, _ = next(_batches(seed=3))
    js = jled.record(JCFG, js, ids, losses, 9, signals=sig)
    path2 = tmp_path / "jax.npz"
    np.savez(path2, **jled.state_dict_of(js))
    back = tled.load_state_dict(TCFG, dict(np.load(path2)), "cpu")
    assert_ledger_states_close(tled.state_dict_of(back),
                               jled.state_dict_of(js))


def test_load_rehashes_a_foreign_capacity():
    host = JLossHistory(JHistoryConfig(capacity=CAP * 2))
    host.record(np.arange(40), np.linspace(0, 1, 40, dtype=np.float32), 4)
    st = tled.load_state_dict(TCFG, host.state_dict(), "cpu")
    ours = LossHistory(TCFG)
    ours.load_state_dict(host.state_dict())
    assert_ledger_states_close(tled.state_dict_of(st), ours.state_dict())
