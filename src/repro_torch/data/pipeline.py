"""Synthetic LM stream with per-instance ids, and the recycle feed that
joins the ledger's signal onto it (copy of ``repro.data.pipeline``).

``DataConfig`` and ``SyntheticLMStream`` are numpy only; the port keeps its
own copy so that it imports nothing of the JAX package, and the copy gives
the same tokens and instance ids as the JAX stream for the same seed:

* stateless & restart-exact — batch t is a pure function of
  (seed, step, shard);
* shard-aware — each data shard draws a disjoint id range;
* learnable — tokens follow per-sequence affine recurrences
  (t_{i+1} = a*t_i + b mod V, (a, b) drawn per instance);
* heavy-tail knob — a fraction of instances are pure-noise "outliers".
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    vocab_size: int
    seed: int = 0
    outlier_frac: float = 0.0  # fraction of pure-noise instances
    instance_pool: int = 1 << 20  # distinct instance ids before reuse
    # True: each id always lands on the same data shard (a feed keyed by a
    # stable partitioner — what the zero-communication sharded ledger
    # assumes). False: the id->shard assignment rotates every step, the
    # adversarial case for shard-local state, which the JAX package's
    # routed ledger exists for.
    pin_shards: bool = True


class SyntheticLMStream:
    """Deterministic LM batches: {tokens, labels, instance_id}."""

    def __init__(self, cfg: DataConfig, shard: int = 0, num_shards: int = 1):
        assert cfg.global_batch % num_shards == 0
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        self.local_batch = cfg.global_batch // num_shards

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.Generator(
            np.random.Philox(
                key=[self.cfg.seed, self.shard], counter=[step, 0, 0, 0]
            )
        )

    def instance_ids(self, step: int) -> np.ndarray:
        """Global ids for batch `step` on this shard (disjoint across shards).

        With ``pin_shards=False`` the global batch is rotated by one shard
        slice per step before slicing, so every id cycles through all the
        shards over time (deterministic and restart-exact, like the pinned
        layout — only the id->shard assignment moves).
        """
        base = (step * self.cfg.global_batch) % self.cfg.instance_pool
        shard = self.shard
        if not self.cfg.pin_shards:
            shard = (self.shard + step) % self.num_shards
        start = base + shard * self.local_batch
        return (np.arange(self.local_batch, dtype=np.int64) + start) % (
            self.cfg.instance_pool
        )

    def batch(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = self._rng(step)
        ids = self.instance_ids(step)
        # per-instance affine recurrence params (deterministic in the id)
        a = 1 + 2 * (ids % 16).astype(np.int64)  # odd multipliers
        b = (ids // 16 % 64).astype(np.int64) + 1
        t0 = ids % cfg.vocab_size
        seq = np.empty((self.local_batch, cfg.seq_len + 1), np.int64)
        seq[:, 0] = t0
        for i in range(cfg.seq_len):
            seq[:, i + 1] = (a * seq[:, i] + b) % cfg.vocab_size
        if cfg.outlier_frac > 0:
            is_outlier = (ids % 1000) < int(cfg.outlier_frac * 1000)
            noise = rng.integers(
                0, cfg.vocab_size, size=seq.shape, dtype=np.int64
            )
            seq = np.where(is_outlier[:, None], noise, seq)
        return {
            "tokens": seq[:, :-1].astype(np.int32),
            "labels": seq[:, 1:].astype(np.int32),
            "instance_id": ids,
        }

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class RecycleFeed:
    """Joins the recycle ledger's signal onto a batch stream.

    ``ledger`` picks where the serve->train join happens:

    * ``"host"`` — ``history`` is a host ``LossHistory``, probed when the
      batch is built; ``recorded_loss`` ships with the batch;
    * ``"engine"`` — the same join against a live serving engine's ledger
      (``serving.EngineLedgerHandle``, or anything with its ``lookup`` /
      ``lookup_signals``);
    * ``"device"`` — pass-through: the join runs inside the train step
      against the device ledger.

    Unseen instances get ``cold_loss`` (must-see). ``policy`` names a
    ``core.selection.POLICIES`` entry; a policy other than ``loss_ema``
    ships its score of the ledger's channels under ``recorded_loss``.
    """

    LEDGERS = ("host", "engine", "device")

    def __init__(
        self,
        stream: SyntheticLMStream,
        history=None,
        ledger: str = "host",
        cold_loss: float = 1e3,
        policy: str = "loss_ema",
    ):
        from repro_torch.core.selection import get_policy

        if ledger not in self.LEDGERS:
            raise ValueError(f"ledger {ledger!r} not in {self.LEDGERS}")
        if ledger != "device" and not hasattr(history, "lookup"):
            raise ValueError(f"a {ledger} ledger feed needs a history or "
                             "handle with lookup()")
        self.stream = stream
        self.history = history
        self.ledger = ledger
        self.cold_loss = cold_loss
        self.policy = get_policy(policy)  # validate the name eagerly

    def batch(self, step: int) -> dict[str, np.ndarray]:
        raw = self.stream.batch(step)
        if self.ledger == "device":
            return raw
        if self.policy.name == "loss_ema":
            ema, seen = self.history.lookup(raw["instance_id"])
            seen = np.asarray(seen)
            raw["recorded_loss"] = np.where(
                seen, np.asarray(ema), self.cold_loss).astype(np.float32)
        else:
            from repro_torch.core.selection import policy_score

            ema, sig, seen = self.history.lookup_signals(raw["instance_id"])
            seen = np.asarray(seen)
            raw["recorded_loss"] = policy_score(
                self.policy, torch.from_numpy(np.asarray(ema, np.float32)),
                torch.from_numpy(np.asarray(sig, np.float32)),
                torch.from_numpy(seen), self.cold_loss,
            ).numpy()
        # fraction of the batch the ledger could answer
        raw["ledger_hit_rate"] = float(seen.mean())
        return raw

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
