#!/usr/bin/env python3
"""Time the port's decode attention beyond the serving shapes.

    python3 tools/decode_attn_sweep.py [--src DIR] [--paged] [--sweep]
                                       [--json FILE]

Needs one CUDA card. ``--src`` names the ``src`` directory of the tree
whose ``repro_torch`` is timed (default: this checkout's), so two versions
of the kernel can be compared on the same card: run the script once per
tree, in one session. Every case is first checked against the plain
version (``DECODE_TOL``), then timed four ways: eager (``time_ms``),
eager with a cold L2, device time alone (CUDA graph replay) warm and cold,
beside SDPA timed the same ways (``chip_smoke.py``'s helpers). Cases, bf16,
B = 8:

- the two serving shapes, as ``chip_smoke.py`` times them: zamba2-2.7b's
  shared block (32 heads of 80 on 32 kv heads, T 332, contexts 301-332)
  and llama3-8b's dense cache (32 on 8, D 128, T 160, contexts 129-160);
- the same heads in a 2048-slot cache, full and with contexts spread
  from 50 to 2048 (a cache sized for the longest request holding prompts
  of every length).

``--sweep`` (trees with ``split_plan``) adds, at zamba2's heads
(G = 1, D = 80), device time against T with every position valid, and at
T = 332 against the plan's tile bytes and target block count: whether the
time follows the bytes read or a fixed cost per call.

``--paged`` (trees with the paged wrapper in ``decode_attn.py``) times
the paged kernel
instead, beside page gather + SDPA, at llama3-8b's heads in bf16 with
16-token pages: the serve shape (a 160-position table, contexts
129-160), and a 2048-position table with contexts 50-2048 and with
contexts 129-160 (spans past pos read nothing: the plan comes from
shapes, never from pos). With ``--sweep`` it then times each of those
three cases as device time alone, warm and cold, against the plan's tile
bytes and target block count. Each result is one JSON line on stdout
(and in ``--json``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def timings(torch, ops, ref, q, k, v, valid, library_too=True) -> dict:
    import torch.nn.functional as F

    cs.decode_check(torch, ops, ref, q, k, v, valid)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)

    def kernel(q, k, v, valid):
        return ops.decode_attn(q, k, v, valid, impl="cuda")

    def library(q, kt, vt, valid):
        return F.scaled_dot_product_attention(
            q[:, :, None], kt, vt, attn_mask=valid[:, None, None],
            enable_gqa=True)

    n = -(-cs.COLD_BYTES // (2 * k.numel() * k.element_size()))
    copies = [tuple(x.clone() for x in (q, k, v, valid)) for _ in range(n)]
    lib_copies = [(a, b.transpose(1, 2), c.transpose(1, 2), m)
                  for a, b, c, m in copies]
    hkv, d = k.shape[2], k.shape[3]
    ntok = int(valid.sum().item())
    moved = (2 * ntok * hkv * d * k.element_size()
             + 2 * q.numel() * q.element_size() + valid.numel())
    out = dict(
        ms=cs.time_ms(lambda: kernel(q, k, v, valid)),
        cold_ms=cs.time_ms_cold(kernel, copies),
        dev_ms=cs.time_ms_graph(kernel, [(q, k, v, valid)] * 10),
        dev_cold_ms=cs.time_ms_graph(kernel, copies),
        bound_ms=cs.bound(moved, 4.0 * ntok * q.shape[1] * d, "bf16")[0],
        mbytes=moved / 1e6,
    )
    if library_too:
        out.update(
            library_ms=cs.time_ms(lambda: library(q, kt, vt, valid)),
            library_cold_ms=cs.time_ms_cold(library, lib_copies),
            library_dev_ms=cs.time_ms_graph(library,
                                            [(q, kt, vt, valid)] * 10),
            library_dev_cold_ms=cs.time_ms_graph(library, lib_copies))
    del copies, lib_copies
    return out


PAGED_CASES = (("serve: table 160, contexts 129-160", 10, cs.SERVE_POS),
               ("table 2048, contexts 50-2048", 128, cs.MIXED_POS),
               ("table 2048, contexts 129-160", 128, cs.SERVE_POS))


def paged(torch, ops, ref, DA, emit, sweep: bool) -> None:
    """The paged kernel's cases and, with ``sweep``, its plan constants."""
    g = torch.Generator(device="cuda").manual_seed(3)
    b, hq, hkv, d = 8, 32, 8, 128
    for name, npg, pos in PAGED_CASES:
        case = cs.paged_case(torch, torch.bfloat16, g, npg=npg, pos=pos,
                             hole=False)
        cs.paged_check(torch, ops, ref, case, cs.PAGED_BF16_TOL)
        r = cs.paged_timings(torch, ops, ref, case)
        r["bound_ms"], _ = r.pop("bound")
        emit(dict(case=f"paged {name}",
                  plan=DA.split_plan(b, hq, hkv, npg * 16, d, 2), **r))
        if not sweep:
            continue

        def kernel(q, kp, vp, pt, pos):
            return ops.paged_decode_attn(q, kp, vp, pt, pos, impl="cuda")

        n = -(-cs.COLD_BYTES // (2 * case[1].numel() * 2))
        copies = [tuple(x.clone() for x in case) for _ in range(n)]
        base = (DA.TILE_BYTES, DA.TARGET_BLOCKS)
        for tile_bytes in (18 << 10, 36 << 10, 72 << 10):
            for target in (132, 330, 660):
                DA.TILE_BYTES, DA.TARGET_BLOCKS = tile_bytes, target
                DA.split_plan.cache_clear()
                emit(dict(case=f"paged {name}, plan sweep",
                          tile_bytes=tile_bytes, target_blocks=target,
                          plan=DA.split_plan(b, hq, hkv, npg * 16, d, 2),
                          dev_ms=cs.time_ms_graph(kernel, [case] * 10),
                          dev_cold_ms=cs.time_ms_graph(kernel, copies)))
        DA.TILE_BYTES, DA.TARGET_BLOCKS = base
        DA.split_plan.cache_clear()
        del copies, case


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("decode_attn_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels import decode_attn as DA
    from repro_torch.kernels import ops, ref

    tree = os.path.relpath(os.path.abspath(args.src), ROOT)
    sink = open(args.json, "a") if args.json else None

    def emit(rec):
        rec = dict(tree=tree, card=cs.card_line(), **rec)
        line = json.dumps(rec)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")

    if args.paged:
        paged(torch, ops, ref, DA, emit, args.sweep)
        if sink:
            sink.close()
        return 0
    g = torch.Generator(device="cuda").manual_seed(2)
    bf = torch.bfloat16
    heads = {"zamba2": (32, 32, 80), "llama3-8b": (32, 8, 128)}
    serving = {"zamba2": (332, cs.HYBRID_POS), "llama3-8b": (160, cs.SERVE_POS)}
    for name, (hq, hkv, d) in heads.items():
        t, pos = serving[name]
        case = cs.decode_inputs(torch, g, 8, hq, hkv, d, t, bf)
        emit(dict(case=f"{name} serving T={t}",
                  **timings(torch, ops, ref, *case, cs.depth_mask(
                      torch, pos, t))))
        case = cs.decode_inputs(torch, g, 8, hq, hkv, d, 2048, bf)
        for what, pos in (("full", (2047,) * 8),
                          ("mixed 50-2048", cs.MIXED_POS)):
            emit(dict(case=f"{name} T=2048 {what}",
                      **timings(torch, ops, ref, *case, cs.depth_mask(
                          torch, pos, 2048))))
        del case
    if args.sweep:
        hq, hkv, d = heads["zamba2"]
        for t in (83, 166, 332, 664, 1328):
            case = cs.decode_inputs(torch, g, 8, hq, hkv, d, t, bf)
            valid = torch.ones((8, t), dtype=torch.bool, device="cuda")
            emit(dict(case=f"zamba2 heads, T={t} all valid",
                      plan=DA.split_plan(8, hq, hkv, t, d, 2),
                      **timings(torch, ops, ref, *case, valid)))
        case = cs.decode_inputs(torch, g, 8, hq, hkv, d, 332, bf)
        valid = cs.depth_mask(torch, cs.HYBRID_POS, 332)
        base = (DA.TILE_BYTES, DA.TARGET_BLOCKS)
        for tile_bytes in (9 << 10, 18 << 10, 36 << 10, 72 << 10):
            for target in (132, 330, 660, 1320):
                DA.TILE_BYTES, DA.TARGET_BLOCKS = tile_bytes, target
                DA.split_plan.cache_clear()
                plan = DA.split_plan(8, hq, hkv, 332, d, 2)
                r = timings(torch, ops, ref, *case, valid, False)
                emit(dict(case="zamba2 serving T=332, plan sweep",
                          tile_bytes=tile_bytes, target_blocks=target,
                          plan=plan, ms=r["ms"], dev_ms=r["dev_ms"],
                          dev_cold_ms=r["dev_cold_ms"]))
        DA.TILE_BYTES, DA.TARGET_BLOCKS = base
        DA.split_plan.cache_clear()
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
