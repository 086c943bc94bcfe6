"""Synthetic LM stream with per-instance ids, the recycle feed that joins
the ledger's signal onto it, the paper's small datasets and a host
prefetcher (copy of ``repro.data.pipeline``).

``DataConfig``, ``SyntheticLMStream``, ``SyntheticRegression`` and
``mnist_like`` are numpy only; the port keeps its own copy so that it
imports nothing of the JAX package, and the copy gives the same arrays as
the JAX package's for the same seed, bit for bit. The LM stream is

* stateless & restart-exact — batch t is a pure function of
  (seed, step, shard);
* shard-aware — each data shard draws a disjoint id range;
* learnable — tokens follow per-sequence affine recurrences
  (t_{i+1} = a*t_i + b mod V, (a, b) drawn per instance);
* heavy-tail knob — a fraction of instances are pure-noise "outliers".
"""

from __future__ import annotations

import dataclasses
import queue
import threading
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


def local_rows(batch: dict, rank: int, shards: int) -> dict:
    """Rank ``rank``'s rows of a global batch: rows ``[r*n_local,
    (r+1)*n_local)`` of every array (the JAX package's ``P("data")``
    layout of the data-parallel step); scalars, such as the feed's
    ``ledger_hit_rate``, pass through."""

    def rows(x):
        x = np.asarray(x)
        if x.ndim == 0:
            return x.item()
        if x.shape[0] % shards:
            raise ValueError(f"batch of {x.shape[0]} rows does not divide "
                             f"over {shards} ranks")
        n = x.shape[0] // shards
        return x[rank * n:(rank + 1) * n]

    return {k: rows(v) for k, v in batch.items()}


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


class SyntheticRegression:
    """The paper's Fig.1 linear-regression data: y = 2x + 1 + U(-5, 5),
    with an optional 2% outlier band (+U(-20, 20))."""

    def __init__(
        self,
        n_train: int = 1000,
        n_test: int = 10_000,
        outliers: bool = False,
        n_outliers: int = 20,
        seed: int = 0,
    ):
        rng = np.random.Generator(np.random.Philox(key=[seed, 1]))
        self.x_train = rng.uniform(-10, 10, size=(n_train, 1)).astype(np.float32)
        self.y_train = (
            2.0 * self.x_train[:, 0]
            + 1.0
            + rng.uniform(-5, 5, size=n_train)
        ).astype(np.float32)
        if outliers:
            idx = rng.choice(n_train, size=n_outliers, replace=False)
            self.y_train[idx] += rng.uniform(-20, 20, size=n_outliers).astype(
                np.float32
            )
        self.x_test = rng.uniform(-10, 10, size=(n_test, 1)).astype(np.float32)
        self.y_test = (
            2.0 * self.x_test[:, 0] + 1.0 + rng.uniform(-5, 5, size=n_test)
        ).astype(np.float32)


def mnist_like(
    n_train: int = 8192, n_test: int = 2048, seed: int = 0
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """MNIST-shaped synthetic classification (no datasets offline).

    10 class prototypes in 784-d + per-sample Gaussian noise + a rotation
    per class pair. Only 60 of 784 dims carry class signal and 8% of the
    TRAIN labels are flipped (test labels stay clean): the label noise makes
    the hard/outlier loss spread the sampling methods trade off on.
    """
    rng = np.random.Generator(np.random.Philox(key=[seed, 2]))
    informative = 60
    label_noise = 0.08
    protos = np.zeros((10, 784), np.float32)
    protos[:, :informative] = rng.normal(0, 0.9, size=(10, informative))
    mix = np.zeros((10, 784, 16), np.float32)
    mix[:, :informative, :] = rng.normal(0, 0.6, size=(10, informative, 16))

    def make(n, noisy):
        y = rng.integers(0, 10, size=n)
        z = rng.normal(0, 1, size=(n, 16)).astype(np.float32)
        x = protos[y] + np.einsum("nk,ndk->nd", z, mix[y]) + rng.normal(
            0, 1.0, size=(n, 784)
        ).astype(np.float32)
        if noisy:
            flip = rng.random(n) < label_noise
            y = np.where(flip, rng.integers(0, 10, size=n), y)
        return x.astype(np.float32), y.astype(np.int32)

    xtr, ytr = make(n_train, noisy=True)
    xte, yte = make(n_test, noisy=False)
    return xtr, ytr, xte, yte


class Prefetcher:
    """Host-side prefetch: a thread fills a queue of ``depth`` items from
    ``it`` while the caller consumes them; ``close()`` stops the thread at
    its next item and drains the queue."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._stop = threading.Event()

        def work():
            try:
                for item in it:
                    if self._stop.is_set():
                        return
                    self.q.put(item)
            finally:
                self.q.put(self._done)

        self.thread = threading.Thread(target=work, daemon=True)
        self.thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is self._done:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
