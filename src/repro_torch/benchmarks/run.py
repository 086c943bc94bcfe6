"""The port's benchmark harness: one section per paper table or figure.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--full] \
        [--only fig1,fig2,table3] [--device cpu]

The twin of ``benchmarks/run.py``'s paper sections, with its section
titles and per-section wall-time lines. Default is the fast profile;
``--full`` runs the paper's grids at full step counts. Exits 1 if a
section failed (the others still run).
"""

from __future__ import annotations

import argparse
import sys
import time

from repro_torch.benchmarks import fig1_linreg, fig2_mnist, table3_lm_proxy

SECTIONS = (
    ("fig1", "Fig.1 linear regression (clean + outliers)", fig1_linreg.main),
    ("fig2", "Fig.2 MNIST-like classification", fig2_mnist.main),
    ("table3", "Table 3 proxy (LM, full OBFTF train step)",
     table3_lm_proxy.main),
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--only", default="", help="comma-list: fig1,fig2,table3")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    only = set(args.only.split(",")) if args.only else None
    failures = 0
    for key, title, section_main in SECTIONS:
        if only and key not in only:
            continue
        print(f"\n=== {title} ===")
        t0 = time.time()
        try:
            for line in section_main(fast=not args.full, device=args.device):
                print(line)
            print(f"[{key}: {time.time() - t0:.1f}s]")
        except Exception as e:  # report, continue other sections
            failures += 1
            print(f"[{key} FAILED: {type(e).__name__}: {e}]")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
