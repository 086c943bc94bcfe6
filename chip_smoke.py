#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check what it computes.

    python3 chip_smoke.py

Phases, one line each (any failure raises, exits non-zero and prints no
``ok`` line):

1. device — the card's name and power limit (nvidia-smi);
2. build — every kernel under ``src/repro_torch/kernels/csrc`` built from
   source (one nvcc per file, in parallel);
3. one phase per kernel — the kernel against its plain PyTorch version at
   the shapes of the serving path, with its time, the plain version's time,
   a PyTorch library yardstick (never called by the port) and the least
   time the card could take (bytes over 3.35 TB/s, operations over the
   published peak);
4. serve — ``repro_torch.launch.serve.main`` at the full width of
   llama3-8b (32 layers, bf16, random weights from a seed): 8 slots, 16
   requests, prompt 128, 32 new tokens, paged KV (16-token pages), top-k
   retention (k = 64), device ledger, greedy. The engine runs its warm fused
   step with host syncs made errors. Every kernel's launch count over this
   phase must be > 0, every request must finish and the ledger must hold
   every instance id;
5. profile — the same configuration again, five warm decode steps timed
   by the host clock and five under torch.profiler: device time per step,
   kernel launches per step and the kernels that take the most time;
6. reference — the same engine on the smoke config in float32, once on the
   card (kernels) and once on the CPU (plain versions): equal tokens and
   ledgers agreeing to 1e-5.

It then prints the kernels as one JSON line, the card again, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}  # dense, outside sparsity
TOPK_TOL = 1e-4  # lse: f32 sums in another order (values/indices exact)
PAGED_F32_TOL = 2e-5  # f32 kernel vs f32 plain: summation order only
PAGED_BF16_TOL = 1e-2  # bf16 output: within ~2 bf16 ulps of the plain one


SERVE_ARGV = [
    "--arch", "llama3-8b", "--batch", "8", "--requests", "16",
    "--prompt-len", "128", "--gen", "32", "--page-size", "16",
    "--retain", "topk", "--topk", "64", "--ledger", "device",
    "--temperature", "0", "--device", "cuda",
]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, reps: int = 10, warmup: int = 5) -> float:
    """Median over ``iters`` batches of ``reps`` back-to-back calls, each
    batch timed by CUDA events, per call: the device's queue stays full, so
    the host's launch cost hides behind the work wherever the work is the
    longer of the two."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    times.sort()
    return times[len(times) // 2]


def bound(bytes_moved: float, flops: float, kind: str) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def topk_phase(torch, ops, ref) -> dict:
    t, v, k = 8, 128256, 64  # slots, llama3 vocab, --topk default
    g = torch.Generator(device="cuda").manual_seed(0)
    logits = torch.randn((t, v), device="cuda", generator=g) * 3
    logits[:, 1000:1100] = logits[:, 5:6]  # a 100-way tie on every row
    logits[:, 70000] = logits.amax(dim=1)  # a tie with the row's maximum
    vals, idx, lse = ops.topk_lse(logits, k, impl="cuda")
    rv, ri, rl = ref.topk_lse_ref(logits, k)
    torch.cuda.synchronize()
    if not torch.equal(idx, ri):
        raise AssertionError("topk_lse: indices differ from the plain version")
    err = max((vals - rv).abs().max().item(), (lse - rl).abs().max().item())
    if err > TOPK_TOL:
        raise AssertionError(f"topk_lse: max abs err {err} > {TOPK_TOL}")
    ms = time_ms(lambda: ops.topk_lse(logits, k, impl="cuda"))
    plain_ms = time_ms(lambda: ref.topk_lse_ref(logits, k))
    lib_ms = time_ms(lambda: (torch.topk(logits, k, dim=-1),
                              torch.logsumexp(logits, dim=-1)))
    b, by = bound(t * v * 4 + t * k * 8 + t * 4, 3.0 * t * v, "f32")
    return dict(
        name="topk_lse", route="cuda",
        source="src/repro_torch/kernels/csrc/topk_lse.cu",
        replaces="src/repro/kernels/topk_lse.py:118",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
        library_ms=lib_ms, shape=f"T={t} V={v} k={k} f32", tol=TOPK_TOL,
    )


def paged_case(torch, dtype, g, page=16, npg=10,
               pos=(0, 15, 16, 31, 47, 100, 127, 159), hole=True):
    """llama3-8b decode shapes: 8 rows, 32 query / 8 kv heads of 128, a
    shuffled pool; -1 past every row's pos and, with ``hole``, a -1 page
    inside row 5's context."""
    b, hq, hkv, d = len(pos), 32, 8, 128
    p_ = b * npg + 3
    kp = torch.randn((p_, page, hkv, d), device="cuda", generator=g).to(dtype)
    vp = torch.randn((p_, page, hkv, d), device="cuda", generator=g).to(dtype)
    q = torch.randn((b, hq, d), device="cuda", generator=g).to(dtype)
    perm = torch.randperm(p_, device="cuda", generator=g).tolist()
    pt = torch.full((b, npg), -1, dtype=torch.int32)
    used = 0
    for i, p in enumerate(pos):
        n = p // page + 1
        pt[i, :n] = torch.tensor(perm[used:used + n])
        used += n
    if hole:
        pt[5, 1] = -1
    return (q, kp, vp, pt.cuda(),
            torch.tensor(pos, dtype=torch.int32, device="cuda"))


def paged_check(torch, ops, ref, case, tol) -> float:
    """Kernel against the plain version run in f32 -> max abs error."""
    q, kp, vp, pt, pos = case
    out = ops.paged_decode_attn(q, kp, vp, pt, pos, impl="cuda")
    want = ref.paged_decode_attn_ref(q.float(), kp.float(), vp.float(), pt,
                                     pos)
    diff = (out.float() - want).abs()
    if (diff > tol * (1 + want.abs())).any():
        raise AssertionError(f"paged_decode_attn {q.dtype} page "
                             f"{kp.shape[1]}: err {diff.max().item()}")
    return diff.max().item()


# the serve phase's rows decode at contexts 81-160 (prompts 80-128 plus up
# to 32 new tokens); the timed case puts every row in its top half
SERVE_POS = (159, 151, 147, 143, 139, 135, 131, 128)


def paged_phase(torch, ops, ref) -> dict:
    """Correctness at page edges, holes and pages of 256 (larger than the
    kernel's tile); time and bound at the serve phase's shapes and load."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(1)
    err32 = max(
        paged_check(torch, ops, ref, paged_case(torch, torch.float32, g),
                    PAGED_F32_TOL),
        paged_check(torch, ops, ref, paged_case(
            torch, torch.float32, g, page=256, npg=3,
            pos=(0, 255, 256, 300, 511, 600, 700, 767)), PAGED_F32_TOL),
    )
    err = max(
        paged_check(torch, ops, ref, paged_case(torch, torch.bfloat16, g),
                    PAGED_BF16_TOL),
        paged_check(torch, ops, ref, paged_case(
            torch, torch.bfloat16, g, page=256, npg=3,
            pos=(0, 255, 256, 300, 511, 600, 700, 767)), PAGED_BF16_TOL),
    )
    case = paged_case(torch, torch.bfloat16, g, pos=SERVE_POS, hole=False)
    err = max(err, paged_check(torch, ops, ref, case, PAGED_BF16_TOL))
    q, kp, vp, pt, pos = case
    ms = time_ms(lambda: ops.paged_decode_attn(q, kp, vp, pt, pos, impl="cuda"))
    plain_ms = time_ms(lambda: ref.paged_decode_attn_ref(q, kp, vp, pt, pos))
    b, hq, d = q.shape
    page, hkv = kp.shape[1], kp.shape[2]
    t = pt.shape[1] * page
    tpos = torch.arange(t, device="cuda")
    valid = (tpos[None] <= pos[:, None]) & (pt >= 0).repeat_interleave(page, 1)

    def library():
        k = kp[pt.long().clamp(min=0)].reshape(b, t, hkv, d).transpose(1, 2)
        v = vp[pt.long().clamp(min=0)].reshape(b, t, hkv, d).transpose(1, 2)
        return F.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=valid[:, None, None],
            enable_gqa=True,
        )

    lib_ms = time_ms(library)
    ntok = int(valid.sum().item())  # attended positions, summed over rows
    moved = (2 * ntok * hkv * d * 2 + 2 * q.numel() * 2 + pt.numel() * 4
             + pos.numel() * 4)
    bnd, by = bound(moved, 4.0 * ntok * (hq // hkv) * hkv * d, "bf16")
    return dict(
        name="paged_decode_attn", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_decode_attn.cu",
        replaces="src/repro/kernels/decode_attn.py:115",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
        bound_by=by, library_ms=lib_ms, f32_max_abs_err=err32,
        shape=f"B={b} Hq={hq} Hkv={hkv} D={d} page={page} ctx "
              f"{min(SERVE_POS) + 1}-{max(SERVE_POS) + 1} bf16 (checked "
              f"also at page 256 and in f32, f32 err {err32:.3g})",
        tol=PAGED_BF16_TOL,
    )


def serve_phase(torch, ops, tmp: str) -> dict:
    from repro_torch.core.history import HistoryConfig, LossHistory
    from repro_torch.launch import serve

    summary_path = os.path.join(tmp, "serve.json")
    ledger_path = os.path.join(tmp, "ledger.npz")
    argv = SERVE_ARGV + ["--json-out", summary_path,
                         "--ledger-out", ledger_path]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    serve.main(argv)
    launches = dict(ops.LAUNCHES)
    with open(summary_path) as f:
        summary = json.load(f)
    if summary["guarded_steps"] != summary["steps"] - 1:
        raise AssertionError("a warm fused step ran without the sync guard: "
                             f"{summary['guarded_steps']} of "
                             f"{summary['steps'] - 1}")
    if summary["evicted"] != 16 or summary["queued"] or summary["in_flight"]:
        raise AssertionError(f"not every request finished: {summary}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched: {launches}")
    import numpy as np

    hist = LossHistory(HistoryConfig())
    hist.load_state_dict(dict(np.load(ledger_path)))
    ema, seen = hist.lookup(np.asarray(summary["instance_ids"]))
    if not seen.all() or not np.isfinite(ema).all():
        raise AssertionError("ledger misses an instance id or holds non-finite")
    summary["launches"] = launches
    summary["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return summary


def profile_phase(torch) -> str:
    """Where a steady decode step's time goes, at the serve phase's
    configuration: host wall time per step, device kernel time per step
    (torch.profiler), kernel launches per step and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import model as Mdl
    from repro_torch.models.params import materialize

    args = serve.parse_args(SERVE_ARGV)
    cfg = configs.get(args.arch)
    params = materialize(Mdl.param_specs(cfg), args.seed, torch.bfloat16,
                         "cuda")
    eng = serve.build_engine(args, cfg, params, torch.device("cuda"))
    serve.submit_stream(eng, args, cfg)
    for _ in range(3):  # admit the first wave and warm up
        eng.step()
    n = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        eng.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    # device-side events only: an operator's row repeats its kernels' time
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(dev_us(e) for e in kernels) / 1e3 / n
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernelEx",
                                "cuLaunchKernel")) / n
    top = sorted(kernels, key=dev_us, reverse=True)[:5]
    tops = "; ".join(f"{e.key[:40]} {dev_us(e) / 1e3 / n:.3f}" for e in top)
    if device_ms <= 0:
        raise AssertionError("the profiler saw no device time")
    return (f"steady decode step {wall_ms:.2f} ms host wall (8 slots), "
            f"device busy {device_ms:.2f} ms/step "
            f"({100 * device_ms / wall_ms:.1f}%), {launches:.0f} kernel "
            f"launches/step; top device ms/step: {tops}")


def reference_phase(torch) -> str:
    """The smoke config in f32 through the card's kernels and through the
    CPU's plain versions: same tokens, ledgers within 1e-5."""
    import dataclasses

    import numpy as np

    from repro_torch import configs
    from repro_torch.core.history import HistoryConfig
    from repro_torch.data import DataConfig, SyntheticLMStream
    from repro_torch.models import model as Mdl
    from repro_torch.models.params import materialize, tree_map
    from repro_torch.serving import Engine, OutcomeRecorder

    cfg = dataclasses.replace(configs.get_smoke("llama3-8b"),
                              param_dtype="float32", compute_dtype="float32")
    stream = SyntheticLMStream(DataConfig(4, 22, cfg.vocab_size, seed=5))
    weights = materialize(Mdl.param_specs(cfg), 0, torch.float32, "cpu")
    results = []
    for device in ("cuda", "cpu"):
        params = tree_map(lambda _, x: x.to(device), weights)
        rec = OutcomeRecorder(4, 6, cfg.vocab_size, HistoryConfig(1 << 12),
                              ledger="device", retention="topk", topk=16,
                              device=device)
        eng = Engine(cfg, params, rec, slots=4, max_prompt=16, max_gen=6,
                     page_size=4)
        for w in range(2):
            raw = stream.batch(w)
            for r in range(4):
                toks = raw["tokens"][r]
                eng.submit(toks[:16], 6, toks[16:22],
                           int(raw["instance_id"][r]))
        eng.run()
        results.append((eng.finished, eng.ledger_state_dict()))
    (fa, la), (fb, lb) = results
    if fa.keys() != fb.keys() or any(
            not np.array_equal(fa[i], fb[i]) for i in fa):
        raise AssertionError("card and CPU engines generated different tokens")
    for key in la:
        np.testing.assert_allclose(la[key], lb[key], rtol=1e-5, err_msg=key)
    return f"{len(fa)} requests, tokens equal, ledgers within rtol 1e-5"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build, ops, ref

    card = card_line()
    print(f"device: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    _build.libraries()
    rep = _build.build_report()
    print(f"build: {len(list(_build.CSRC.glob('*.cu')))} sources, "
          f"{rep.get('built', 0)} compiled in {time.perf_counter() - t0:.1f}s",
          flush=True)
    for line in rep.get("log", "").splitlines():
        if "registers" in line:
            print(f"build:   {line.strip()}")
    kernels = []
    for phase in (topk_phase, paged_phase):
        row = phase(torch, ops, ref)
        kernels.append(row)
        print(f"kernel {row['name']} ({row['shape']}): ok, max_abs_err "
              f"{row['max_abs_err']:.3g} (tol {row['tol']}), {row['ms']:.4f} ms"
              f" | plain {row['plain_ms']:.4f} ms | library "
              f"{row['library_ms']:.4f} ms | bound {row['bound_ms']:.5f} ms "
              f"({row['bound_by']})", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        s = serve_phase(torch, ops, tmp)
    print(f"serve: llama3-8b 32 layers bf16, {s['evicted']} requests, "
          f"{s['generated_tokens']} tokens in {s['seconds']:.2f}s = "
          f"{s['tok_per_s']:.1f} tok/s, {s['steps']} engine steps, "
          f"{s['recorded']} records, launches {s['launches']}, peak "
          f"{s['peak_gib']:.1f} GiB, sync guard on {s['guarded_steps']} warm "
          f"steps; step ms first "
          f"{s['step_ms'][0]:.1f}, median "
          f"{sorted(s['step_ms'])[len(s['step_ms']) // 2]:.2f}", flush=True)
    print(f"profile: {profile_phase(torch)}", flush=True)
    print(f"reference: {reference_phase(torch)}", flush=True)
    for row in kernels:
        row["launches"] = s["launches"][row["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in kernels]}))
    print(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
