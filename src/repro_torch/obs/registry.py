"""Metrics registry: counters, gauges, histograms with labeled series.

The telemetry contract for hot paths (the engine's fused decode step, the
trainer's step) is **host-side accumulation of already-materialized
values**: the step reads its metrics back to the host ONCE, after the
step — which it did before telemetry existed — and every instrument
update below is plain Python arithmetic on those numpy scalars. No
instrument ever touches a ``torch.Tensor``, so instrumentation can add no
device sync and no host transfer inside the guarded step.

Series are keyed by ``(name, sorted labels)`` and render as
``name{k=v,...}`` in snapshots. Everything here is stdlib-only.
"""

from __future__ import annotations

import bisect
import json
import threading
import time
from typing import Optional

# generic latency bounds (milliseconds); callers may pass their own
DEFAULT_MS_BUCKETS = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0,
)


def series_key(name: str, labels: dict) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotone accumulator. ``inc`` is the only mutator."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-write-wins point-in-time value."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bound histogram: per-bucket counts + count/sum/min/max.

    ``bounds`` are inclusive upper edges; one implicit overflow bucket
    catches everything above the last edge.
    """

    __slots__ = ("bounds", "counts", "count", "sum", "min", "max")

    def __init__(self, bounds=DEFAULT_MS_BUCKETS):
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def summary(self) -> dict:
        if not self.count:
            return {"count": 0}
        buckets = {f"le_{b:g}": c for b, c in zip(self.bounds, self.counts)}
        buckets["inf"] = self.counts[-1]
        return {
            "count": self.count,
            "sum": self.sum,
            "mean": self.sum / self.count,
            "min": self.min,
            "max": self.max,
            "buckets": buckets,
        }


class _NullInstrument:
    """Shared no-op stand-in handed out by a disabled Telemetry: bound
    once at construction time, so a disabled hot path pays one attribute
    call per update and nothing else."""

    __slots__ = ()
    value = 0.0

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass


NULL_INSTRUMENT = _NullInstrument()


class MetricsRegistry:
    """Get-or-create store of labeled instrument series.

    Creation is locked (instruments may be created from the checkpoint
    save thread); updates are lock-free — instruments mutate single
    attributes under the GIL, and every reader (``snapshot``) tolerates
    mid-update values.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def _get(self, store, name, labels, make):
        key = series_key(name, labels)
        inst = store.get(key)
        if inst is None:
            with self._lock:
                inst = store.setdefault(key, make())
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(self._counters, name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(self._gauges, name, labels, Gauge)

    def histogram(
        self, name: str, bounds=DEFAULT_MS_BUCKETS, **labels
    ) -> Histogram:
        return self._get(
            self._histograms, name, labels, lambda: Histogram(bounds)
        )

    def snapshot(self) -> dict:
        """One JSON-able view of every series (the ``--json-out`` /
        final-summary payload and the periodic JSONL snapshot body)."""
        return {
            "counters": {k: c.value for k, c in sorted(self._counters.items())},
            "gauges": {k: g.value for k, g in sorted(self._gauges.items())},
            "histograms": {
                k: h.summary() for k, h in sorted(self._histograms.items())
            },
        }


class EventLog:
    """Append-only structured JSONL event stream (``--metrics-out``).

    One JSON object per line: ``{"t": unix_s, "seq": n, "kind": str,
    ...fields}``. Opened with explicit utf-8 and line buffering so a
    SIGTERM'd run still leaves parseable prefix lines.
    """

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "w", encoding="utf-8", buffering=1)
        self._seq = 0
        self._lock = threading.Lock()

    def write(self, kind: str, **fields) -> None:
        with self._lock:
            rec = {"t": time.time(), "seq": self._seq, "kind": kind}
            rec.update(fields)
            self._f.write(json.dumps(rec, default=_jsonable) + "\n")
            self._seq += 1

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()


def _jsonable(x):
    """Fallback encoder: numpy scalars/arrays (and anything with
    ``.item()``/``.tolist()``) degrade to plain Python without obs
    importing numpy."""
    for attr in ("item", "tolist"):
        fn = getattr(x, attr, None)
        if fn is not None:
            try:
                return fn()
            except Exception:
                pass
    return repr(x)


def read_jsonl(path: str) -> list[dict]:
    """Parse a JSONL event file (tests + ``diff_tables --emit-metrics``
    consumers); tolerates a torn final line."""
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                pass  # torn tail from an interrupted writer
    return out


__all__ = [
    "Counter",
    "DEFAULT_MS_BUCKETS",
    "EventLog",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_INSTRUMENT",
    "read_jsonl",
    "series_key",
]
