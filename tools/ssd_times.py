#!/usr/bin/env python3
"""Times of the port's SSD scan and of its backward at the shapes
``chip_smoke.py`` checks, one JSON line a shape.

    python3 tools/ssd_times.py [--src TREE/src] [--only fwd|bwd|train]

Needs one CUDA card. ``--src`` imports ``repro_torch`` from another tree
(an earlier commit unpacked with ``git archive`` into a git-ignored
directory), so two versions are timed in one call on one card: run the
script once per tree, parent, change, change, parent. Each shape is
checked against the plain version where the tree takes it (the forward by
``chip_smoke.ssd_check`` against the chunked scan; the backward by
``chip_smoke.ssd_bwd_check`` against ``ssd_bwd_ref`` and autograd), then
timed by ``chip_smoke.time_ms`` (eager, host cost included) and by
``chip_smoke.kernel_ms`` (each grid's device time, torch.profiler); a
shape the tree refuses prints its error instead. ``--only train`` runs
mamba2-370m's two train runs of ``chip_smoke.py`` instead (48 layers, 32
rows of 512, (a) 4 steps with a selection forward, (b) 6 recycled) and
prints each one's steady step, peak memory and launches.
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
# the backward: mamba2-370m's train shape (8 kept rows of 512) in bf16 and
# f32, zamba2-2.7b's heads (H 80, N 64) and N = 256 in bf16
BWD_SHAPES = {"bwd_train": (8, 512, 32, 64, 1, 128, "bf16"),
              "bwd_train_f32": (8, 512, 32, 64, 1, 128, "f32"),
              "bwd_zamba2": (2, 512, 80, 64, 1, 64, "bf16"),
              "bwd_n256": (2, 300, 8, 64, 1, 256, "bf16")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--only", choices=("fwd", "bwd", "train"), default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ssd_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels import _build, ops, ref

    _build.libraries()
    card = cs.card_line()
    if args.only == "train":
        import tempfile

        for name, extra in (("a", ()), ("b", cs.RECYCLED)):
            argv = [*cs.TRAIN_ARGV, "--steps", "6" if extra else "4", *extra]
            argv[argv.index("--arch") + 1] = "mamba2-370m"
            argv[argv.index("--layers") + 1] = "0"
            argv[argv.index("--seq-len") + 1] = "512"
            with tempfile.TemporaryDirectory() as tmp:
                r = cs.train_run(torch, ops, argv, os.path.join(tmp, "t.json"))
            print(json.dumps(dict(
                src=args.src, train=f"mamba2-370m ({name})", card=card,
                steady_ms=r["steady_ms"], step_ms=r["step_ms"],
                peak_gib=r["peak_gib"], launches=r["launches"])), flush=True)
        return 0
    g = torch.Generator(device="cuda").manual_seed(3)
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    for name, (*shape, dt) in SHAPES.items():
        if args.only == "bwd":
            break
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
    for name, (*shape, dt) in BWD_SHAPES.items():
        if args.only == "fwd":
            break
        case = cs.ssd_bwd_inputs(torch, g, *shape, dtypes[dt], False)
        row = dict(src=args.src, shape=name, dims=shape, dtype=dt, card=card)
        try:
            err, (used, where) = cs.ssd_bwd_check(torch, ops, case, 128)
        except ValueError as e:
            row["refused"] = str(e)
            print(json.dumps(row), flush=True)
            continue
        row.update(max_abs_err=err, tol_used=used, tol_used_at=where)
        x, dt_, a, b, c, dy, _ = case
        states = ops._ssd_forward(x, dt_, a, b, c, 128, "cuda", True)[2]

        def back(x=x, dt_=dt_, a=a, b=b, c=c, states=states, dy=dy):
            return ops.ssd_bwd(x, dt_, a, b, c, states, dy, None, 128,
                               impl="cuda")

        row["ms"] = cs.time_ms(back, iters=10, reps=5)
        row["grids_ms"] = cs.grid_ms(cs.kernel_ms(torch, back), "ssd_bwd")
        row["device_ms"] = sum(row["grids_ms"].values())
        print(json.dumps(row), flush=True)
        del case, states
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
