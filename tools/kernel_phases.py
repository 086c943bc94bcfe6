#!/usr/bin/env python3
"""Where a block's time goes inside the port's decode-attention, top-k and
ledger kernels: clock stamps at the numbered points of a block's life.

    python3 tools/kernel_phases.py [--json FILE] [--only NAME]

Needs one CUDA card. Builds ``src/repro_torch/kernels/csrc`` again with
``-DKERNEL_PHASES`` (the stamps compile in only then, into libraries of
their own beside the usual ones), runs each case a few times and reads
back, for blocks 0 and 1 of the last call, the ``clock64()`` cycles from
the block's start to each point that thread 0 reached (``PHASE`` in the
sources). Cycles count at the SM's clock, at most ``clocks.max.sm`` (1980
MHz on an H100 SXM). The stamps say how a block's time divides;
``chip_smoke.py`` says how long a call takes.

Cases, bf16 unless named: ``topk_lse`` at the serve shape (T = 8, V =
128256) with k = 64, also f32, k = 256 and k = 4096 (blocks 0 and 1 are
row 0's first two chunks); ``paged_decode_attn`` at llama3-8b's heads with
16-token pages at the serve shape (a 160-position table, contexts
129-160) and in a 2048-position table with contexts 129-160 and 50-2048
(blocks 0 and 1 are spans 0 and 1 of row 0, kv head 0); ``decode_attn`` at
zamba2's shared block (T = 332); ``ledger_record_priority`` at
capacities 65536 and 2^18 with batches of 32 and 32768 (blocks 0 and 1
are tiles 0 and 1). One JSON line per case; ``--only`` keeps the cases
whose name starts with NAME.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402

TOPK_POINTS = {0: "start", 1: "chunk read", 2: "block reduced",
               3: "bound on K*", 4: "candidates sent (cluster barrier)",
               13: "counts (cluster barrier)",
               14: "survivors written (cluster barrier)", 15: "sorted"}
# the passes of the kernel's selects in order: the bound's, then the
# candidates' (in the first block) or the cluster's
TOPK_POINTS.update({5 + i: f"radix pass {i + 1}" for i in range(8)})
DECODE_POINTS = {0: "start", 1: "q and probe read, first tile issued",
                 26: "tiles done", 27: "partial written",
                 28: "cluster barrier", 29: "merged"}
LEDGER_POINTS = {0: "start", 1: "copy issued, winners cleared",
                 2: "batch walked", 3: "tile in shared memory",
                 4: "winners patched", 5: "tile written, items scored"}
for _t in range(6):
    DECODE_POINTS.update({2 + 4 * _t: f"tile {_t + 1} in place",
                          3 + 4 * _t: f"tile {_t + 1} scored",
                          4 + 4 * _t: f"tile {_t + 1} softmax",
                          5 + 4 * _t: f"tile {_t + 1} P.V"})


def stamps(torch, lib, names, fn, reps: int = 3) -> list[dict]:
    """Run ``fn`` ``reps`` times, then the cycles from start to each point
    reached by blocks 0 and 1 of the last call."""
    lib.read_phases.argtypes = [ctypes.c_void_p]
    for _ in range(reps):
        torch.cuda.synchronize()
        if lib.clear_phases() != 0:
            raise RuntimeError("clear_phases failed")
        fn()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 64)()
    if lib.read_phases(ctypes.addressof(buf)) != 0:
        raise RuntimeError("read_phases failed")
    out = []
    for blk in range(2):
        v = buf[32 * blk:32 * blk + 32]
        out.append({names.get(i, str(i)): v[i] - v[0]
                    for i in range(32) if v[i] and v[i] >= v[0]})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", default=None)
    ap.add_argument("--only", default="")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_phases: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.history import HistoryConfig
    from repro_torch.kernels import _build, ops

    _build.NVCC_FLAGS = _build.NVCC_FLAGS + ("-DKERNEL_PHASES",)
    libs = _build.libraries()
    card = cs.card_line()
    sink = open(args.json, "a") if args.json else None

    def emit(case, lib, points, fn):
        if not case.startswith(args.only):
            return
        blocks = stamps(torch, lib, points, fn)
        line = json.dumps(dict(case=case, card=card, block0=blocks[0],
                               block1=blocks[1]))
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")

    g = torch.Generator(device="cuda").manual_seed(0)
    logits = torch.randn((8, 128256), device="cuda", generator=g) * 3
    for dtype, k in ((torch.bfloat16, 64), (torch.float32, 64),
                     (torch.bfloat16, 256), (torch.bfloat16, 4096)):
        x = logits.to(dtype)
        emit(f"topk_lse T=8 V=128256 k={k} {str(dtype)[6:]}",
             libs["topk_lse"], TOPK_POINTS,
             lambda: ops.topk_lse(x, k, impl="cuda"))
    for name, npg, pos in (("160-position table, contexts 129-160", 10,
                            cs.SERVE_POS),
                           ("2048-position table, contexts 129-160", 128,
                            cs.SERVE_POS),
                           ("2048-position table, contexts 50-2048", 128,
                            cs.MIXED_POS)):
        case = cs.paged_case(torch, torch.bfloat16, g, npg=npg, pos=pos,
                             hole=False)
        emit(f"paged_decode_attn B=8 Hq=32 Hkv=8 D=128 page=16, {name}",
             libs["decode_attn"], DECODE_POINTS,
             lambda: ops.paged_decode_attn(*case, impl="cuda"))
        del case
    q, k, v = cs.decode_inputs(torch, g, 8, 32, 32, 80, 332, torch.bfloat16)
    valid = cs.depth_mask(torch, cs.HYBRID_POS, 332)
    emit("decode_attn B=8 Hq=32 Hkv=32 D=80 T=332, contexts 301-332",
         libs["decode_attn"], DECODE_POINTS,
         lambda: ops.decode_attn(q, k, v, valid, impl="cuda"))
    cfg = HistoryConfig()
    kw = dict(decay=cfg.decay, unseen_priority=cfg.unseen_priority,
              staleness_half_life=cfg.staleness_half_life)
    step = torch.full((), 7, dtype=torch.int32, device="cuda")
    for cap in cs.LEDGER_CAPS:
        table = (torch.zeros(cap, device="cuda"),
                 torch.zeros(cap, dtype=torch.int32, device="cuda"),
                 torch.full((cap,), -1, dtype=torch.int32, device="cuda"),
                 torch.full((cap,), -1, dtype=torch.int32, device="cuda"))
        for b in (32, 32768):
            ids, losses, valid = cs.ledger_batch(torch, cap, b, b)
            emit(f"ledger_record_priority capacity={cap} B={b}",
                 libs["ledger"], LEDGER_POINTS,
                 lambda: ops.ledger_record_priority(
                     *table, ids, losses, step, valid=valid, impl="cuda",
                     **kw))
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
