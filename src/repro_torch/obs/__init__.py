"""repro_torch.obs — dependency-free telemetry for the recycle loop.

The port's copy of ``repro.obs``, with its names, event kinds and JSONL
schema (the JAX package's ``docs/observability.md``). One subsystem, three
outputs, the serving engine, the trainer and the checkpoint manager
reporting through it:

* :class:`MetricsRegistry` — counters/gauges/histograms with labeled
  series. Hot paths update instruments from **already-fetched** numpy
  step metrics only (host-side accumulation): instrumentation adds no
  device sync, so the warm fused serve step and the warm train step keep
  running under ``torch.cuda.set_sync_debug_mode("error")`` on the card.
* :class:`TraceRecorder` + ``span()`` — host wall-time spans around the
  hot paths (admission, prefill, fused decode, metrics fetch, trainer
  step, checkpoint save/restore), exported as Chrome ``trace_event`` JSON
  (``--trace-out``, open in Perfetto).
* :class:`EventLog` — structured JSONL (``--metrics-out``): periodic
  loop-health snapshots (rates + EMA drift, see
  :mod:`repro_torch.obs.health`) and a final summary that subsumes
  ``Engine.stats()`` / ``--json-out``.

Library code reaches telemetry through :func:`current` (a disabled
:class:`Telemetry` by default — null instruments, null spans, ~one
attribute call of overhead); CLIs build a real one and :func:`install` it.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.obs.health import ledger_drift, rate_of
from repro_torch.obs.registry import (
    DEFAULT_MS_BUCKETS,
    EventLog,
    MetricsRegistry,
    NULL_INSTRUMENT,
    read_jsonl,
    series_key,
)
from repro_torch.obs.trace import NULL_SPAN, TraceRecorder, load_trace


class Telemetry:
    """Facade bundling a registry, an optional JSONL event log, and an
    optional trace recorder. A disabled instance (``enabled=False``) hands
    out shared null instruments/spans so call sites bind once and hot
    loops pay (almost) nothing.
    """

    def __init__(
        self,
        *,
        metrics_out: Optional[str] = None,
        trace_out: Optional[str] = None,
        enabled: bool = True,
    ):
        self.enabled = enabled
        self.registry = MetricsRegistry() if enabled else None
        self.events = (
            EventLog(metrics_out) if (enabled and metrics_out) else None
        )
        self.trace_out = trace_out
        self.trace = (
            TraceRecorder() if (enabled and trace_out) else None
        )

    # -- instruments (bind once, update per step) ----------------------------

    def counter(self, name: str, **labels):
        if self.registry is None:
            return NULL_INSTRUMENT
        return self.registry.counter(name, **labels)

    def gauge(self, name: str, **labels):
        if self.registry is None:
            return NULL_INSTRUMENT
        return self.registry.gauge(name, **labels)

    def histogram(self, name: str, bounds=DEFAULT_MS_BUCKETS, **labels):
        if self.registry is None:
            return NULL_INSTRUMENT
        return self.registry.histogram(name, bounds, **labels)

    # -- spans / events ------------------------------------------------------

    def span(self, name: str, cat: str = "host", **args):
        if self.trace is None:
            return NULL_SPAN
        return self.trace.span(name, cat, **args)

    def mark(self, name: str, cat: str = "host", **args) -> None:
        if self.trace is not None:
            self.trace.instant(name, cat, **args)

    def event(self, kind: str, **fields) -> None:
        if self.events is not None:
            self.events.write(kind, **fields)

    # -- output --------------------------------------------------------------

    def snapshot(self) -> dict:
        return self.registry.snapshot() if self.registry is not None else {}

    def close(self, summary: Optional[dict] = None) -> None:
        """Flush everything: write the final ``summary`` event (if any),
        save the trace file, close the event log. Idempotent."""
        if summary is not None and self.events is not None:
            self.events.write("summary", **summary)
        if self.trace is not None and self.trace_out:
            self.trace.save(self.trace_out)
        if self.events is not None:
            self.events.close()


OFF = Telemetry(enabled=False)
_current: Telemetry = OFF


def install(t: Telemetry) -> Telemetry:
    """Make ``t`` the process-wide telemetry returned by :func:`current`
    (what library code binds when not handed one explicitly)."""
    global _current
    _current = t
    return t


def current() -> Telemetry:
    return _current


def add_cli_args(ap) -> None:
    """Attach the shared telemetry flags (the serve and train CLIs both
    take them, with identical semantics)."""
    ap.add_argument("--metrics-out", default="",
                    help="write telemetry as JSONL: periodic loop_health "
                         "snapshots (--metrics-every) and a final summary "
                         "event")
    ap.add_argument("--trace-out", default="",
                    help="write hot-path timing spans as Chrome trace_event "
                         "JSON (open in chrome://tracing or ui.perfetto.dev)")
    ap.add_argument("--metrics-every", type=int, default=25,
                    help="loop-health snapshot cadence in steps")


def from_args(args) -> Telemetry:
    """Build AND install process-wide telemetry from the CLI flags —
    disabled (null instruments, null spans) when neither output was
    requested; installed either way so un-threaded call sites (checkpoint
    manager, ledger ops) resolve consistently."""
    return install(
        Telemetry(
            metrics_out=args.metrics_out or None,
            trace_out=args.trace_out or None,
            enabled=bool(args.metrics_out or args.trace_out),
        )
    )


def span(name: str, cat: str = "host", **args):
    """Convenience: a span on the currently-installed telemetry — for
    call sites (checkpoint manager, ledger ops) that don't thread a
    Telemetry handle."""
    return _current.span(name, cat, **args)


def mark(name: str, cat: str = "host", **args) -> None:
    _current.mark(name, cat, **args)


__all__ = [
    "DEFAULT_MS_BUCKETS",
    "EventLog",
    "MetricsRegistry",
    "NULL_INSTRUMENT",
    "NULL_SPAN",
    "OFF",
    "Telemetry",
    "TraceRecorder",
    "add_cli_args",
    "current",
    "from_args",
    "install",
    "ledger_drift",
    "load_trace",
    "mark",
    "rate_of",
    "read_jsonl",
    "series_key",
    "span",
]
