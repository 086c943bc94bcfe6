"""Loop-health derivations shared by the engine and trainer surfaces.

Rates, not totals: a counter that only ever grows says nothing about
whether the loop is currently healthy — ``rate_of`` and the helpers here
turn the already-accumulated counters into the fractions the JSONL
snapshots and final summaries report (overflow per record, deferrals per
admission attempt, top-k misses per record, occupancy, hit rate).

``ledger_drift`` is the per-channel EMA drift gauge: the engine (when
telemetry is enabled on a device-ledger run) feeds a host ``LossHistory``
shadow the same (ids, losses, signals) rows its fused step already
fetched, and this compares the shadow against the device table's exported
state_dict (sums in another order make device EMAs agree to ~1e-6
relative, not bit-exact; a drift far beyond that flags a real divergence,
e.g. a dropped or double-applied record).
"""

from __future__ import annotations

import numpy as np


def rate_of(part: float, whole: float) -> float:
    """``part / whole`` with an empty-denominator convention of 0.0."""
    return float(part) / float(whole) if whole else 0.0


def ledger_drift(
    shadow_sd: dict, device_sd: dict, channels: tuple[str, ...] = ()
) -> dict[str, float]:
    """Max relative |shadow - device| per EMA channel over slots whose
    ownership agrees (an eviction racing the snapshot is a layout
    difference, not drift). Returns ``{"ema": x, "<channel>": x, ...,
    "slots_compared": n}``; all-zero drift on an empty intersection.
    """
    so, do = np.asarray(shadow_sd["owner"]), np.asarray(device_sd["owner"])
    both = (so >= 0) & (so == do)
    out = {"slots_compared": float(both.sum())}

    def rel(a, b):
        if not both.any():
            return 0.0
        a, b = np.asarray(a, np.float64)[both], np.asarray(b, np.float64)[both]
        denom = np.maximum(np.abs(a), np.abs(b))
        return float(
            np.max(np.where(denom > 0, np.abs(a - b) / np.maximum(denom, 1e-300), 0.0))
        ) if a.size else 0.0

    out["ema"] = rel(shadow_sd["ema"], device_sd["ema"])
    s_sig, d_sig = shadow_sd.get("sig"), device_sd.get("sig")
    for c, name in enumerate(channels):
        if s_sig is None or d_sig is None:
            out[name] = 0.0
        else:
            out[name] = rel(
                np.asarray(s_sig)[:, c], np.asarray(d_sig)[:, c]
            )
    return out


__all__ = ["ledger_drift", "rate_of"]
