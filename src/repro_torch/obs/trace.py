"""Hot-path timing spans -> Chrome ``trace_event`` JSON (Perfetto-loadable).

``span("engine.decode_step", slot_count=8)`` times a host-side region and
appends one complete ("ph": "X") event; ``TraceRecorder.save`` writes the
standard ``{"traceEvents": [...]}`` envelope that chrome://tracing and
https://ui.perfetto.dev open directly (``--trace-out``).

Spans measure HOST wall time at dispatch granularity: a span around a
call that launches device work times its enqueue, and a span around the
metrics read that follows (``engine.fetch_metrics``,
``train.fetch_metrics``) takes the wait for the device, which together are
the engine/trainer step latency the loop-health gauges report. No CUDA
event is recorded: a span adds no device work and no sync.

Stdlib-only; thread-safe appends (the checkpoint save thread emits spans).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional


class _NullSpan:
    """Reusable no-op context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class Span:
    __slots__ = ("_rec", "name", "cat", "args", "_t0")

    def __init__(self, rec: "TraceRecorder", name: str, cat: str, args: dict):
        self._rec = rec
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._rec._complete(
            self.name, self.cat, self._t0, time.perf_counter(), self.args
        )
        return False


class TraceRecorder:
    """In-memory trace_event buffer, bounded to ``max_events`` (oldest
    kept: the interesting part of a runaway run is usually the start —
    warmup, compiles, first admissions — and a bound keeps --trace-out
    safe to leave on)."""

    def __init__(self, max_events: int = 200_000):
        self.max_events = max_events
        self.events: list[dict] = []
        self.dropped = 0
        self._epoch = time.perf_counter()
        self._lock = threading.Lock()

    def _complete(self, name, cat, t0, t1, args) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        ev = {
            "ph": "X",
            "name": name,
            "cat": cat,
            "ts": (t0 - self._epoch) * 1e6,  # trace_event ts unit: us
            "dur": (t1 - t0) * 1e6,
            "pid": os.getpid(),
            "tid": threading.get_ident() & 0x7FFFFFFF,
        }
        if args:
            ev["args"] = args
        with self._lock:
            self.events.append(ev)

    def span(self, name: str, cat: str = "host", **args) -> Span:
        return Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "host", **args) -> None:
        """A zero-duration marker (ph "i"): admissions, evictions,
        deliveries — the discrete control-plane events between spans."""
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        ev = {
            "ph": "i",
            "s": "t",
            "name": name,
            "cat": cat,
            "ts": (time.perf_counter() - self._epoch) * 1e6,
            "pid": os.getpid(),
            "tid": threading.get_ident() & 0x7FFFFFFF,
        }
        if args:
            ev["args"] = args
        with self._lock:
            self.events.append(ev)

    def save(self, path: str) -> None:
        with self._lock, open(path, "w", encoding="utf-8") as f:
            json.dump(
                {
                    "traceEvents": self.events,
                    "displayTimeUnit": "ms",
                    "otherData": {"dropped_events": self.dropped},
                },
                f,
            )


def load_trace(path: str) -> list[dict]:
    """The saved trace's event list (test/consumer helper)."""
    with open(path, encoding="utf-8") as f:
        return json.load(f)["traceEvents"]


__all__ = ["NULL_SPAN", "Span", "TraceRecorder", "load_trace"]
