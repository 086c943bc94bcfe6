"""The paper's experiments on the port: twins of ``benchmarks/fig1_linreg.py``,
``fig2_mnist.py`` and ``table3_lm_proxy.py``, and ``run.py`` over them.

Each prints the JAX bench's CSV tables (same table names, headers and
column order), so ``python -m benchmarks.diff_tables`` reads a port run as
it reads a JAX run. Run one with ``python -m repro_torch.benchmarks.<name>``
(``--fast`` for the fast profile, ``--device cpu`` off the card).
"""

from __future__ import annotations

import argparse


def parser() -> argparse.ArgumentParser:
    """The flags every bench takes: ``--fast`` and ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true", help="fast profile")
    ap.add_argument("--device", default="cuda")
    return ap


def cli(main_fn, argv=None) -> None:
    """Run a bench's ``main`` with ``--fast`` and ``--device``; print its
    tables."""
    args = parser().parse_args(argv)
    print("\n".join(main_fn(fast=args.fast, device=args.device)))
