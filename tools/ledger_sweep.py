#!/usr/bin/env python3
"""Device span of the port's ledger transaction over batch sizes, at the
two capacities ``chip_smoke.py`` checks, one JSON line a point.

    python3 tools/ledger_sweep.py [--src TREE/src] [--plans]

Needs one CUDA card. ``--src`` imports ``repro_torch`` from another tree
(an earlier commit unpacked with ``git archive`` into a git-ignored
directory), so two versions are timed in one call on one card. A tree
with one launch (``kernels/ledger.py::tile_plan``) is timed once a point;
an earlier tree once per variant name ("fori", "block"), the launch route
each forces there. With ``--plans`` the tile plan's constants are varied
(slots a tile at small batches, ids walked over all tiles). Spans are ``chip_smoke.ledger_span_ms``
(CUDA events around each call, calls queued behind a sleep kernel), each
beside ``chip_smoke.ledger_bound``, the kernels' device time by the
profiler (``chip_smoke.kernel_ms``, summed over the call's kernels) and
by CUDA graph replay of 20 calls (``chip_smoke.time_ms_graph``). A first
line gives the same three for an empty kernel (``torch.cuda._sleep(0)``):
what one launch costs in each.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

PLANS = ((512, 1 << 22), (1024, 1 << 21), (1024, 1 << 22), (1024, 1 << 23),
         (2048, 1 << 22))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--plans", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ledger_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.core.history import HistoryConfig
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import ledger as L

    _build.libraries()
    cfg = HistoryConfig()
    kw = dict(decay=cfg.decay, unseen_priority=cfg.unseen_priority,
              staleness_half_life=cfg.staleness_half_life)
    tiled = hasattr(L, "tile_plan")
    plans = PLANS if args.plans and tiled else (None,)
    card = cs.card_line()

    def times(fn, prefix):
        dev = cs.kernel_ms(torch, fn)
        return dict(span_ms=cs.ledger_span_ms(torch, fn),
                    kernel_ms=sum(v[0] for k, v in dev.items()
                                  if prefix in k),
                    graph_ms=cs.time_ms_graph(fn, [()] * 20))

    print(json.dumps(dict(src=args.src, case="empty kernel", card=card,
                          **times(lambda: torch.cuda._sleep(0), ""))),
          flush=True)
    names = (None,) if tiled else L.VARIANTS
    step = torch.full((), 7, dtype=torch.int32, device="cuda")
    for cap in cs.LEDGER_CAPS:
        table = (torch.zeros(cap, device="cuda"),
                 torch.zeros(cap, dtype=torch.int32, device="cuda"),
                 torch.full((cap,), -1, dtype=torch.int32, device="cuda"),
                 torch.full((cap,), -1, dtype=torch.int32, device="cuda"))
        for b in cs.LEDGER_SWEEP:
            ids, losses, valid = cs.ledger_batch(torch, cap, b, b)
            for plan in plans:
                if plan is not None:
                    L.TILE_SLOTS, L.WALK_ITEMS = plan
                    L.tile_plan.cache_clear()
                for variant in names:
                    row = dict(src=args.src, capacity=cap, batch=b,
                               bound_ms=cs.ledger_bound(cap, b)[0],
                               card=card, **times(
                                   lambda v=variant:
                                   ops.ledger_record_priority(
                                       *table, ids, losses, step,
                                       valid=valid, impl="cuda", variant=v,
                                       **kw), "ledger"))
                    row["variant"] = variant
                    if tiled:
                        row.update(tile_slots=L.TILE_SLOTS,
                                   walk_items=L.WALK_ITEMS,
                                   tiles=L.tile_plan(cap, b)[0])
                    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
