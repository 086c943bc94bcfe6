#!/usr/bin/env python3
"""Times of the port's SSD scan at the shapes ``chip_smoke.py`` checks,
one JSON line a shape.

    python3 tools/ssd_times.py [--src TREE/src]

Needs one CUDA card. ``--src`` imports ``repro_torch`` from another tree
(an earlier commit unpacked with ``git archive`` into a git-ignored
directory), so two versions are timed in one call on one card. Each shape
is checked against the plain chunked scan (``chip_smoke.ssd_check``) where
the tree takes it, then timed by ``chip_smoke.time_ms`` (eager, host cost
included) and by ``chip_smoke.kernel_ms`` (the two grids' device time,
torch.profiler); a shape the tree refuses prints its error instead.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

# chip_smoke's timed bf16 shapes (zamba2's and mamba2's prefills, the long
# case), N = 256 in both dtypes and zamba2's shape in f32
SHAPES = {"zamba2": (1, 300, 80, 64, 1, 64, "bf16"),
          "mamba2": (1, 300, 32, 64, 1, 128, "bf16"),
          "long": (4, 2048, 80, 64, 1, 64, "bf16"),
          "n256": (1, 300, 8, 64, 1, 256, "bf16"),
          "zamba2_f32": (1, 300, 80, 64, 1, 64, "f32"),
          "n256_f32": (1, 300, 8, 64, 1, 256, "f32")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ssd_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels import _build, ops, ref

    _build.libraries()
    card = cs.card_line()
    g = torch.Generator(device="cuda").manual_seed(3)
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    for name, (*shape, dt) in SHAPES.items():
        case = cs.ssd_inputs(torch, g, *shape, dtypes[dt])
        row = dict(src=args.src, shape=name, dims=shape, dtype=dt, card=card)
        try:
            row["max_abs_err"] = cs.ssd_check(torch, ops, ref, case, 128)[0]
        except ValueError as e:  # a shape the tree's wrapper refuses
            row["refused"] = str(e)
            print(json.dumps(row), flush=True)
            continue

        def call(case=case):
            return ops.ssd_scan(*case, chunk=128, impl="cuda")

        row["ms"] = cs.time_ms(call)
        per = cs.kernel_ms(torch, call)
        row["grids_ms"] = [sum(v[0] for k, v in per.items() if key in k)
                           for key in ("ssd_scan_state", "ssd_scan_out")]
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
