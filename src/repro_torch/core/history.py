"""Per-instance loss history recorded from inference forward passes.

The paper's production insight (§1): deployed systems already run forward
passes at serving time; record "a constant amount of information per
instance" from them and use it when composing training batches. This module
is that record — a fixed-capacity host-side store (one slot per instance id,
hashed) holding an EMA of observed losses, an observation count, and the
last-seen step. The data pipeline uses ``priority`` to bias candidate
selection toward instances whose loss signal says they still matter, and the
train step's in-batch OBFTF selection then does the fine-grained pick.

This host-side store is the *reference implementation* and checkpoint
interchange format. The device-resident ledger (`repro_torch.core.device_ledger`)
shares the slot addressing below, so `state_dict` round-trips between the
two. It is deterministic, picklable (checkpointable), and O(1) per update.

This module is a copy of `repro.core.history` (numpy only), kept in the port
so that the port imports nothing of the JAX package. Its `.npz` state dicts
are the same format in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# Auxiliary per-instance signal channels recorded alongside the loss EMA —
# derived at serving time from the retained top-k+lse summary (predictive
# entropy, top-1/top-2 margin; see serving.recorder) and consumed by the
# selection policies. The ledger's
# ``sig`` array is [capacity, N_AUX] f32 in THIS order; it EMAs under the
# same decay/ownership rules as the loss channel. Checkpoints written
# before the channel existed load with sig = 0 (no serve-time signal yet).
AUX_CHANNELS = ("entropy", "margin")
N_AUX = len(AUX_CHANNELS)

# 32-bit Fibonacci multiplier (2^32/phi). Addressing is deliberately 32-bit
# so the device ledger — which keeps int32 owners — computes the *same* slot
# for the same id. Instance ids are keyed by their low 32 bits; ids must stay
# below 2^31 for host<->device owner comparison to agree (the synthetic
# pipeline's pool is 2^20). The tensor twin is device_ledger.slot_for_torch.
FIB32 = 0x9E3779B9


def slot_for(ids: np.ndarray, capacity: int) -> np.ndarray:
    """Hash instance ids to table slots (shared host/device addressing)."""
    x = np.asarray(ids, np.int64).astype(np.uint32)
    h = x * np.uint32(FIB32)  # wrapping u32 multiply
    h = h ^ (h >> np.uint32(16))
    return (h & np.uint32(capacity - 1)).astype(np.int64)


def rehash_state_dict(
    sd: dict[str, np.ndarray], new_capacity: int
) -> dict[str, np.ndarray]:
    """Re-hash a ledger ``state_dict`` into a new slot layout (host-side).

    The input is treated as a bag of live records (slot positions are
    ignored except for tie-breaking), so this one function covers every
    layout migration: global -> global on a capacity change, and the merge
    of per-shard local tables into the global layout on a shard-count
    change (concatenate the local state_dicts, then rehash).

    Records colliding in the new layout evict deterministically by recency:
    the largest ``last_seen`` wins, ties broken by input slot order —
    matching the ledger's lossy-cache semantics (eviction = back to unseen).
    """
    assert new_capacity & (new_capacity - 1) == 0, "capacity must be 2^k"
    owner = np.asarray(sd["owner"], np.int64)
    live = owner >= 0
    ids = owner[live]
    out = {
        "ema": np.zeros((new_capacity,), np.float32),
        "count": np.zeros((new_capacity,), np.int64),
        "last_seen": np.full((new_capacity,), -1, np.int64),
        "owner": np.full((new_capacity,), -1, np.int64),
        "sig": np.zeros((new_capacity, N_AUX), np.float32),
    }
    if ids.size == 0:
        return out
    sig_in = np.asarray(
        sd.get("sig", np.zeros((owner.shape[0], N_AUX))), np.float32
    )
    last_seen = np.asarray(sd["last_seen"], np.int64)[live]
    # numpy fancy assignment: the LAST duplicate index wins, so writing in
    # ascending last_seen order makes the most recent record survive.
    order = np.argsort(last_seen, kind="stable")
    slots = slot_for(ids, new_capacity)[order]
    out["ema"][slots] = np.asarray(sd["ema"], np.float32)[live][order]
    out["count"][slots] = np.asarray(sd["count"], np.int64)[live][order]
    out["last_seen"][slots] = last_seen[order]
    out["owner"][slots] = ids[order]
    out["sig"][slots] = sig_in[live][order]
    return out


@dataclasses.dataclass
class HistoryConfig:
    capacity: int = 1 << 16  # slots (power of two)
    decay: float = 0.9  # EMA decay for recorded losses
    unseen_priority: float = 1e6  # instances never scored sort first
    staleness_half_life: float = 10_000.0  # steps; stale records decay back up


class LossHistory:
    """Fixed-capacity EMA loss ledger keyed by instance id."""

    def __init__(self, cfg: HistoryConfig = HistoryConfig()):
        assert cfg.capacity & (cfg.capacity - 1) == 0, "capacity must be 2^k"
        self.cfg = cfg
        n = cfg.capacity
        self.ema = np.zeros((n,), np.float32)
        self.count = np.zeros((n,), np.int64)
        self.last_seen = np.full((n,), -1, np.int64)
        self.owner = np.full((n,), -1, np.int64)  # id owning the slot
        self.sig = np.zeros((n, N_AUX), np.float32)  # AUX_CHANNELS order

    # -- addressing ---------------------------------------------------------

    def _slot(self, ids: np.ndarray) -> np.ndarray:
        # Fibonacci hashing keeps sequential production ids well spread.
        return slot_for(ids, self.cfg.capacity)

    # -- writes -------------------------------------------------------------

    def record(
        self,
        ids: np.ndarray,
        losses: np.ndarray,
        step: int,
        signals: Optional[np.ndarray] = None,
    ) -> None:
        """Record per-instance losses observed at ``step`` (serving or train).

        Collisions evict: the newest instance owns the slot (production
        ledgers are lossy caches; eviction = falling back to unseen).

        ``signals`` (optional [B, N_AUX] f32, ``AUX_CHANNELS`` order) EMAs
        the auxiliary channels under the same decay and ownership rules as
        the loss. Without it, a same-owner record leaves the channels
        untouched (a train-side loss record must not erase the serve-side
        signal) and an evicting record zeroes them (the new owner has no
        signal yet).
        """
        ids = np.asarray(ids, np.int64)
        losses = np.asarray(losses, np.float32)
        slots = self._slot(ids)
        fresh = self.owner[slots] != ids
        d = self.cfg.decay
        prev = np.where(fresh, losses, self.ema[slots])
        self.ema[slots] = d * prev + (1.0 - d) * losses
        if signals is None:
            self.sig[slots] = np.where(
                fresh[:, None], 0.0, self.sig[slots]
            )
        else:
            signals = np.asarray(signals, np.float32).reshape(len(ids), N_AUX)
            prev_sig = np.where(fresh[:, None], signals, self.sig[slots])
            self.sig[slots] = d * prev_sig + (1.0 - d) * signals
        self.count[slots] = np.where(fresh, 1, self.count[slots] + 1)
        self.last_seen[slots] = step
        self.owner[slots] = ids

    # -- reads --------------------------------------------------------------

    def lookup(self, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Return (ema_loss, seen_mask) for instance ids."""
        ids = np.asarray(ids, np.int64)
        slots = self._slot(ids)
        seen = self.owner[slots] == ids
        return np.where(seen, self.ema[slots], 0.0).astype(np.float32), seen

    def lookup_signals(
        self, ids: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Return (ema_loss [B], sig [B, N_AUX], seen_mask [B]).

        ``sig`` columns follow ``AUX_CHANNELS``; unseen rows are 0 — feed
        the triple to ``selection.policy_score`` for the cold fallback.
        """
        ids = np.asarray(ids, np.int64)
        slots = self._slot(ids)
        seen = self.owner[slots] == ids
        ema = np.where(seen, self.ema[slots], 0.0).astype(np.float32)
        sig = np.where(seen[:, None], self.sig[slots], 0.0).astype(np.float32)
        return ema, sig, seen

    def priority(self, ids: np.ndarray, step: int) -> np.ndarray:
        """Training priority: unseen ≫ high-EMA-loss; staleness re-inflates.

        score = unseen ? unseen_priority
                       : ema * 2^((step - last_seen)/half_life)
        """
        ids = np.asarray(ids, np.int64)
        slots = self._slot(ids)
        seen = self.owner[slots] == ids
        age = np.maximum(step - self.last_seen[slots], 0).astype(np.float32)
        boost = np.exp2(age / self.cfg.staleness_half_life)
        score = self.ema[slots] * boost
        return np.where(seen, score, self.cfg.unseen_priority).astype(np.float32)

    def top_candidates(
        self, ids: np.ndarray, k: int, step: int, rng: Optional[np.random.Generator] = None
    ) -> np.ndarray:
        """Pick k of ``ids`` by priority (ties broken randomly)."""
        score = self.priority(ids, step)
        if rng is not None:
            score = score * (1.0 + 1e-3 * rng.random(score.shape, dtype=np.float32))
        k = min(k, len(ids))
        part = np.argpartition(-score, k - 1)[:k]
        return np.asarray(ids)[part]

    # -- checkpointing ------------------------------------------------------

    def state_dict(self) -> dict[str, np.ndarray]:
        return {
            "ema": self.ema,
            "count": self.count,
            "last_seen": self.last_seen,
            "owner": self.owner,
            "sig": self.sig,
        }

    def load_state_dict(self, state: dict[str, np.ndarray]) -> None:
        state = dict(state)
        # a sharded-pinned export's slot placement is foreign (records sit
        # on consumer shards); re-hash it — and any capacity mismatch —
        # into this table's layout
        foreign = state.pop("pinned_shards", None) is not None
        if foreign or np.asarray(state["ema"]).shape[0] != self.cfg.capacity:
            state = rehash_state_dict(state, self.cfg.capacity)
        self.ema = np.asarray(state["ema"], np.float32).copy()
        self.count = np.asarray(state["count"], np.int64).copy()
        self.last_seen = np.asarray(state["last_seen"], np.int64).copy()
        self.owner = np.asarray(state["owner"], np.int64).copy()
        # pre-signal-channel checkpoints: no serve-time signal recorded yet
        sig = state.get("sig")
        self.sig = (
            np.zeros((self.cfg.capacity, N_AUX), np.float32)
            if sig is None else np.asarray(sig, np.float32).copy()
        )
