#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check what it computes.

    python3 chip_smoke.py

Phases, one line each (any failure raises, exits non-zero and prints no
``ok`` line):

1. device — the card's name and power limit (nvidia-smi);
2. build — every kernel under ``src/repro_torch/kernels/csrc`` built from
   source (one nvcc per file, in parallel);
3. one phase per kernel — the kernel against its plain PyTorch version at
   the shapes of the serving paths, with its time, the plain version's
   time, a PyTorch library yardstick (never called by the port) and the
   least time the card could take (bytes over 3.35 TB/s, operations over
   the published peak): top-k + lse (bf16 logits as the recorder passes
   them, and f32; k of 1 to 4096 and k = V, ±0 and -inf ties, k = 64 at
   the vocabularies of deepseek-7b (and deepseek-v2-236b), qwen3-14b,
   granite-34b, mixtral-8x22b, pixtral-12b and musicgen-medium; timed warm,
   cold and as device time alone, also by k and route), paged decode
   attention (pages of 5, 16 and 256, G = 1, 4, 5, 16 and 48 with the
   heads of llama3-8b, deepseek-7b, qwen3-14b, granite-34b and
   musicgen-medium (24 of 64), D = 36,
   rows that attend nothing; timed as the dense kernel is, also in a
   2048-position table), dense-cache
   decode attention (zamba2's D = 80, G = 1 and llama3-8b's shapes, an
   all-masked row, a rolling window, f32 (also D = 256), the JAX test's
   G = 16 and a granite-34b-like G = 48 with a row valid in one span only,
   contexts of 50 to 2048 in a 2048-slot cache, mixtral-8x22b's 48/8 heads
   in its wrapped 4,096-slot window and in the short serve's 160-slot
   cache in bf16 and f32, bf16 also to a relative limit that a dropped
   tile of 64 positions fails, the prefix checks' caches of pixtral-12b
   and musicgen-medium; also timed
   with a cold L2 and as device time alone), the SSD scan (zamba2's and
   mamba2's 300-token prefills, a long case, one chunk, an exact multiple
   of the chunk, N = 256 in bf16 and in f32, the JAX test's odd shapes in
   f32, against the chunked scan and the sequential oracle; each grid's
   device time), and the scan's backward (``ssd_bwd``: mamba2-370m's
   train shape, 8 kept rows of 512, in bf16 and f32, zamba2-2.7b's heads,
   G = 2, a short last chunk, S < L, a final-state cotangent, N = 256 and
   chunks of 64 in bf16, against its plain version and autograd through
   the chunked scan; two calls equal bits; each of its grids' device time,
   its bound at the design's units and the bf16 chunk grid's blocks an SM,
   from ptxas's registers and its shared memory);
4. serve — ``repro_torch.launch.serve.main`` at the full width of
   llama3-8b (32 layers, bf16, random weights from a seed): 8 slots, 16
   requests, prompt 128, 32 new tokens, paged KV (16-token pages), top-k
   retention (k = 64), device ledger, greedy. The engine runs its warm fused
   step with host syncs made errors. ``paged_decode_attn`` must launch 32
   times a step and ``topk_lse`` once a step and once an admission, every
   request must finish and the ledger must hold every instance id;
5. profile — the same configuration again, five warm decode steps timed
   by the host clock and two under torch.profiler: device time per step,
   kernel launches per step and the kernels that take the most time;
5a. telemetry — phase 4's serve again with ``--metrics-out``,
   ``--trace-out`` and ``--metrics-every 8`` (``repro_torch.obs``): phase
   4's gates (the sync guard on every warm step with the instruments on,
   the kernels' launches), ``loop_health`` events in the JSONL with the
   device ledger's EMA drift against its host shadow under 1e-4, one
   ``summary`` whose engine counters equal the run's, and the engine's
   spans in the trace; its tok/s beside phase 4's;
5b. routed serves (A) — phase 4's serve with ``--ledger-route`` over a data
   axis of one rank on NCCL, once with ``--ledger-exchange gather`` and once
   with ``a2a --capacity-factor 0.125`` (one row of 8, so 7 records a step
   take the residual round): phase 4's gates, the sync guard on every warm
   step with the collectives inside it, phase 4's tokens and
   ``--ledger-out`` table field for field, the kernels launched as often,
   the JAX summary's routing keys and an overflow count above 0 under
   a2a; then the a2a serve profiled as in phase 5 (launches and NCCL
   events a step beside phase 5's);
6. reference — the same engine on the smoke config in float32, once on the
   card (kernels) and once on the CPU (plain versions): equal tokens and
   ledgers agreeing to 1e-5; then two OBFTF train steps of the smoke config
   in float32 on the card and on the CPU, with the same selection draws:
   equal selected rows, losses and ledger tables within 1e-5, and one
   step's parameter gradients within ``REF_GRAD_ATOL`` · max +
   ``REF_GRAD_RTOL`` · |cpu| leaf by leaf;
6a. the slice's serving paths, each through ``launch.serve.main`` at full
   width and depth, dense cache, top-k retention, device ledger, greedy, 8
   slots and 16 requests: zamba2-2.7b (54 layers, prompts of 300, 32 new
   tokens; ``ssd`` launched 54 times per admission and ``decode_attn`` 9
   times per decode step), mamba2-370m (48 layers, prompts of 200, 16 new
   tokens; ``ssd`` 48 times per admission) and llama3-8b with
   ``--page-size 0`` (``decode_attn`` 32 times per step); every request
   finishes, the warm steps run under the sync guard, the ledger holds
   every id. Then a profile of zamba2's decode step, its 300-token prefill
   timed and profiled, and the mamba2 and zamba2 smoke configs in float32
   on the card and on the CPU: equal greedy tokens, logits within 1e-4,
   and zamba2's engine with equal tokens and ledgers; then mamba2-370m's
   and zamba2-2.7b's smoke configs trained two steps in f32 on the card
   (xent, ledger, ssd and ssd_bwd kernels) and on the CPU: equal kept
   rows, losses, priorities and ledgers within 1e-5, one step's grads
   within ``REF_GRAD_*`` (the llama3-8b reference of phase 6 checks them
   too; zamba2's shared attention block's leaves named);
7. xent and ledger — the training path's kernels against their plain
   versions at its shapes (cross-entropy at T = 4096 and 1024 rows of the
   128256-token vocabulary in bf16, with -1 labels, a row of ±1e4 logits
   and a vocabulary that is no multiple of the tile, and at the shapes of
   the other train paths: qwen3-14b's, granite-34b's, mixtral-8x22b's,
   deepseek-v2-236b's, pixtral-12b's and musicgen-medium's vocabularies in
   bf16 and the smoke configs' in f32, as Table 3 gives them; the ledger at
   capacity 65536 with batches of 32 and 512 and at 2^18 with 32 and
   32768, duplicates, masked items, five chained transactions and an
   eviction inside each batch, both variant names forced), timed as above
   (the ledger also by device span, by the wrapper's host cost and by the
   profiler's kernel time); then the ledger's device span at batches of 32
   to 32768 at both capacities, each beside its bound;
7a. sharded ops (B) — four ranks, spawned processes sharing the one card
   through gloo (NCCL refuses two ranks on one GPU; the tables stay on the
   card and the collectives stage through host memory), run the five ops
   and ``record_priority`` for 5 steps at capacity 65,536 (16,384 slots a
   rank), 32 items a rank, on a balanced and a home-skewed stream, under
   pinned, gather and a2a at capacity factors 4, 1.25 and 0.125: every
   answer and table equal to the single card table fed the global batch
   (the pinned table to four single tables, one a segment), the overflow
   count equal to the stream's items past capacity, the ledger kernel
   launched 5 times a rank on the pinned and gather paths; each op's span;
8. train — ``repro_torch.launch.train.main`` at the full width of
   llama3-8b cut to 8 of 32 layers (bf16, random weights from seed 0),
   global batch 32 × 128 tokens, obftf at ratio 0.25, AdamW: (a) 4 steps
   with a selection forward, (b) 6 steps with ``--recycle --ledger device
   --instance-pool 64``. Every warm step runs with host syncs made errors;
   every loss must be finite, each new kernel must launch in the run that
   uses it, (b) must cost 0.75 forwards a step and leave the kept rows in
   the ledger; the steady step time and peak memory are printed; (C) run
   (b) again with ``--ledger-route --ledger-exchange a2a``: on one rank the
   single table, so the JAX summary's keys, ``exchange`` "a2a",
   ``a2a_overflow`` 0, (b)'s launches and (b)'s losses;
8a. data-parallel step (D) — ``make_train_step(mesh=)`` called
   directly over an NCCL group of one (the CLI passes no mesh on one
   rank; the FSDP layout holds every leaf whole there), run
   (a)'s configuration, 3 steps, each step's losses then written through
   the sharded ledger's ``record_priority`` (pinned): kept rows, losses,
   ``grad_norm`` and the table equal to the mesh-less step's on the same
   weights, batches and draws (within ``REF_TRAIN_RTOL``), the warm steps
   under the sync guard, the kernels launched, and a profiled step showing
   NCCL events and the xent and ledger kernels;
8b. data-parallel ranks (E) — four spawned ranks sharing the card through
   gloo, each calling the train CLI with ``--model-parallel 1`` on
   mamba2-370m at full width and depth (48 layers), rows of 512, 8 rows a
   rank, the params FSDP-placed (a quarter of each leaf with an ``embed``
   dim a rank): (a) obftf at 0.25 (2 steps), (b) recycled on the device
   ledger routed through gather (3 steps), (c) ``--method full`` in bf16
   and (c-f32) in f32 (2 steps each). Gates: every rank's final params,
   gathered whole, the same bits, each rank's param bytes its layout's,
   kept rows and step cost (1.75 / 0.75 / 3.0), finite losses,
   xent, ssd and ssd_bwd (and the ledger kernel in (b)) launched on every
   rank,
   (b)'s table equal to the single table of the ranks' writes, the losses
   of (c) within ``DP_BF16_RTOL`` and of (c-f32) within ``REF_TRAIN_RTOL``
   of one rank's run in the same dtype (bf16 grads summed over four ranks
   round otherwise than one rank's); each run's steady step, its host
   time in gloo's collectives and the peak memory a rank beside one
   rank's and the replicated layout's; then on the same ranks 12 layers
   of mamba2-370m's in_proj stack gathered through
   ``param_gather_constraint``, plain and under ``FSDP_RULES`` with
   ``int8_gather`` (timed; int8 within max|w|/127 a chunk, its backward
   within a bf16 ulp of the summed cotangents), and
   ``int8_ring_all_reduce`` against gloo's
   ``all_reduce`` (timed; within the sum of the ranks' max|x|/254 a
   chunk);
9. train profile — run (a)'s configuration again, two warm steps timed by
   the host clock and one under torch.profiler;
10. the other dense archs — deepseek-7b (15 of 30 layers, MHA),
   qwen3-14b (20 of 40, qk-norm, G = 5) and granite-34b (44 of 88, MQA
   with G = 48, the GELU MLP) — and the prefix-embedding families without
   a prefix, as their CLIs serve them — pixtral-12b (20 of 40, vlm) and
   musicgen-medium (24 of 48, audio, 24 heads of 64) — served as in phase
   4 at full width and half depth (``ARCH_LAYERS``), with the same gates
   (``paged_decode_attn`` once per layer a step), each followed by a
   profile of its steady decode step; their smoke configs in f32 on the
   card and on the CPU (equal tokens, ledgers within 1e-5, the signal
   channels also within 1e-6 absolute); then qwen3-14b,
   granite-34b, pixtral-12b and musicgen-medium trained at full width, cut
   to the deepest that fits (``ARCH_TRAIN``; musicgen-medium at full
   depth): qwen3-14b and pixtral-12b as run (a), granite-34b and
   musicgen-medium as run (b), each with finite losses, its step cost and
   its kernels launched; mamba2-370m at full depth (48 layers, the ssm
   family) on rows of 512 tokens (four chunks of its scan) as runs (a)
   and (b), with ``ssd_bwd`` launched 48 times a step and ``ssd`` as often
   as ``ssd_launches_per_step`` derives from the code (144 a step in (a):
   the selection forward, the kept rows' forward and the remat recompute;
   96 in (b)); zamba2-2.7b (the hybrid family) the same way at full depth
   (54 layers: ``ssd_bwd`` 54 a step, ``ssd`` 162 and 108), its run (b)
   with ``--metrics-out`` and ``--trace-out`` (loop_health events, one
   summary, the trainer's spans), each beside its floors (matmul
   operations at the bf16 peak, AdamW's bytes); then a profile of each
   one's steady step (device time of ``ssd`` and ``ssd_bwd`` a step among
   the kinds of kernel, and the device time under the stacked layers'
   index backward);
10a. mixtral-8x22b (moe: 8 experts, top-2, a 4,096-token window) at full
   width cut to 12 of 56 layers, dense cache: 8 slots and 16 requests of
   128-token prompts, 32 new tokens; then 4 requests of 4,160-token
   prompts (past the window: every decode step reads a wrapped cache), 16
   new tokens; each with the serve gates (``decode_attn`` 12 a step,
   ``topk_lse`` once a step and an admission, the sync guard, the ledger)
   and its weights-read floor; a profile of the short path's decode step,
   a 4,160-token prefill timed and profiled, its smoke config's engine
   card against CPU; trained cut to 1 layer as runs (a) and (b)
   (``ARCH_TRAIN``), each with the share of token choices that capacity
   dropped over the run's MoE layers;
10b. deepseek-v2-236b (moe with MLA: a 576-value latent cache a token, 2
   shared and 160 routed experts, top-6 ungated, one dense lead layer) at
   full width cut to 8 of 60 layers, dense latent cache: 8 slots and 16
   requests of 128-token prompts, 32 new tokens; then 2 requests of
   8,192-token prompts (MLA's blocked prefill), 16 new tokens; each with
   the serve gates (no attention kernel, ``topk_lse`` once a step and an
   admission, the sync guard, the ledger), its peak memory and its
   weights-read floor; a profile of the short path's decode step, an
   8,192-token prefill timed and profiled, its smoke config's engine card
   against CPU; trained cut to 1 layer (the dense lead layer alone: nothing
   routed) as runs (a) and (b) (``ARCH_TRAIN``);
10c. prefix — pixtral-12b and musicgen-medium at full width and depth
   through the model's own entry points: two rows of a random
   ``prefix_len``-frame prefix and 128 tokens prefilled into the dense
   cache, 16 greedy decode steps (``decode_attn`` once per layer a step),
   each step's logits against one ``forward_hidden`` over prefix + every
   token within ``PREFIX_TOL``, which the same forward without the prefix
   misses;
11. paper — the port's twins of the paper's experiments
   (``repro_torch.benchmarks``: Fig. 1, Fig. 2 and Table 3 with their
   policy A/B arms), fast profile, at the JAX benches' sizes: every CSV
   row printed, every row of the grids present and finite, accuracies in
   [0, 1], the cross-entropy kernels launched during Table 3; then, not
   gated, whether obftf beats uniform at each ratio and the policy arms'
   order (the paper's claims, noisy at these sizes).

It then prints the seconds each group of phases took (a run must end
within 1,200 s), its wall time, the kernels as one JSON line
(``launches`` over each kernel's first main path, ``launches_by_path``
over every path that ran it), the card again, and last ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
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
# xent loss/lse in f32: the row's exponentials summed in another order, so
# |kernel - plain| <= XENT_ATOL + XENT_RTOL * |plain| (a few f32 units in
# the last place of the lse)
XENT_ATOL, XENT_RTOL = 1e-5, 1e-6
# xent gradient, entry by entry: both versions compute in f32 and round once
# to the logits' dtype, so |kernel - plain| <= rtol * |plain| + the dtype's
# smallest normal (entries that underflow); rtol is one bf16 unit in the last
# place (exp may differ in its last f32 bit and round the other way), or
# about eight f32 units
XENT_BWD_RTOL = {"torch.bfloat16": 2**-7, "torch.float32": 1e-6}
# decode_attn against its plain version, absolute, as in the JAX package's
# test_decode_attn_matches_ref: f32 sums in another order; bf16 inputs with
# f32 weights in both versions, the output rounded once
DECODE_TOL = {"torch.float32": 2e-6, "torch.bfloat16": 3e-2}
# and in bf16 also relative, for each (row, query head): |kernel - plain|
# over |plain| in L2 across D. The absolute limit is as large as a typical
# output at a 4,096-position context; this one is not, so it fails a kernel
# that drops one tile of 64 positions from such a row (the phase shows it)
DECODE_BF16_REL = 2e-2
# ssd in f32: test_ssd_kernel_matches_sequential_ref's atol and rtol; a bf16
# y may differ by one bf16 unit in the last place (both versions compute in
# f32 from the same bf16 inputs and round once), plus SSD_BF16_ATOL where
# the f32 sums cancel; the state is f32 in every case
SSD_ATOL, SSD_RTOL = 3e-4, 1e-3
SSD_BF16_RTOL, SSD_BF16_ATOL = 2**-7, 1e-3
# ssd_bwd against its plain version and against autograd through the
# chunked scan, entry by entry: |kernel - plain| <= SSD_BWD_ATOL *
# max|plain| + rtol * |plain|. Every version computes in f32 and sums in
# its own order; each gradient entry sums up to L (P + N) products, and the
# decays e^{cum_i - cum_j} of two large, close cums carry their rounding
# (cum reaches a few hundred over a chunk), hence the absolute part, scaled
# by the output's largest entry, and rtol 1e-3 (SSD_RTOL); ddt and da are
# f32 in every case. A bf16 dx, dB or dC is rounded once from f32 in each
# version, so it may also differ by one bf16 unit in the last place (2^-7)
SSD_BWD_ATOL, SSD_BWD_RTOL, SSD_BWD_BF16_RTOL = 2e-4, 1e-3, 2**-7
REF_LOGIT_TOL = 1e-4  # card vs CPU logits of the ssm/hybrid smoke configs
LEDGER_RTOL = 1e-6  # ema / priority; the integer tables must be equal
REF_TRAIN_RTOL = 1e-5  # card vs CPU train steps in f32
# one step's parameter gradients, card vs CPU in f32, leaf by leaf:
# |card - cpu| <= REF_GRAD_ATOL * max|cpu| + REF_GRAD_RTOL * |cpu|. Every
# kernel on the path (xent, ssd, ssd_bwd) sums in its own order, and the
# backward adds those differences up over the layers; a scan whose
# gradient went missing leaves its parameters' grads off by all of them
REF_GRAD_ATOL, REF_GRAD_RTOL = 1e-4, 1e-3
# the ledger's signal channels, card vs CPU, besides rtol 1e-5: the margin
# is the difference of the two largest f32 logits, so a logit's last-bit
# difference (5e-7 at 4) is a large relative one where the two are close;
# the signals' tolerance of tests/test_torch_serving.py
SIG_ATOL = 1e-6
TRAIN_LAYERS = 8  # of llama3-8b's 32: 2.80 B params fit the card's 80 GB


SERVE_KERNELS = ("topk_lse", "paged_decode_attn")
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


def topk_check(torch, ops, ref, x, k) -> float:
    """Kernel against the plain version: indices and values exact, the lse
    within TOPK_TOL -> its max abs error."""
    vals, idx, lse = ops.topk_lse(x, k, impl="cuda")
    rv, ri, rl = ref.topk_lse_ref(x, k)
    what = f"topk_lse {x.dtype} {tuple(x.shape)} k={k}"
    if not torch.equal(idx, ri):
        raise AssertionError(f"{what}: indices differ from the plain version")
    if not torch.equal(vals, rv):
        raise AssertionError(f"{what}: values differ from the plain version")
    err = (lse - rl).abs().max().item()
    if not err <= TOPK_TOL:
        raise AssertionError(f"{what}: lse err {err} > {TOPK_TOL}")
    return err


def topk_edges(torch, x):
    """``x`` with row 1 at or below 0 and -0.0 and +0.0 among its largest
    values (they tie: the lower index first), and a run of -inf in row 2."""
    x = x.clone()
    v = x.shape[1]
    x[1] = -x[1].abs()
    x[1, [5, 17, v // 2 + 1, v - 1]] = torch.tensor([-0.0, 0.0, -0.0, 0.0],
                                                    device=x.device)
    x[2, v // 3:v // 3 + 100] = float("-inf")
    return x


TOPK_KS = (1, 64, 65, 256, 4096)  # 4096: the most sorted in shared memory
# the vocabularies of deepseek-7b (and deepseek-v2-236b), qwen3-14b,
# granite-34b, mixtral-8x22b, pixtral-12b and musicgen-medium
ARCH_VOCABS = (102400, 151936, 49152, 32768, 131072, 2048)


def topk_phase(torch, ops, ref) -> dict:
    """The recorder's call at the serve shape (T = 8 slots, llama3's vocab,
    k = 64) on bf16 logits, as the model gives them, and on f32; k of 1 to
    4096, V = 4097 with k = 64 and k = V (sorted in global scratch), ties
    across blocks, ±0 and -inf ties. Timed eager, with a cold L2 and as
    device time alone (CUDA graph replay) beside torch.topk + logsumexp;
    device time at each k and route."""
    t, v, k = 8, 128256, 64  # slots, llama3 vocab, --topk default
    g = torch.Generator(device="cuda").manual_seed(0)
    logits = torch.randn((t, v), device="cuda", generator=g) * 3
    logits[:, 1000:1100] = logits[:, 5:6]  # a 100-way tie on every row
    logits[:, 70000] = logits.amax(dim=1)  # a tie with the row's maximum
    edges = topk_edges(torch, logits)
    small = topk_edges(torch, torch.randn((3, 4097), device="cuda",
                                          generator=g) * 3)
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for x in (logits, edges):
            for kk in TOPK_KS:
                err = max(err, topk_check(torch, ops, ref, x.to(dtype), kk))
        for kk in (64, 4097):
            err = max(err, topk_check(torch, ops, ref, small.to(dtype), kk))
    for va in ARCH_VOCABS:  # the other dense archs' serve shape
        xa = topk_edges(torch, torch.randn((t, va), device="cuda",
                                           generator=g) * 3)
        for dtype in (torch.float32, torch.bfloat16):
            err = max(err, topk_check(torch, ops, ref, xa.to(dtype), k))
        del xa
    x = logits.to(torch.bfloat16)

    def kernel(x, kk=k):
        return ops.topk_lse(x, kk, impl="cuda")

    def library(x, kk=k):
        return (torch.topk(x, kk, dim=-1),
                torch.logsumexp(x.to(torch.float32), dim=-1))

    copies = [(x.clone(),) for _ in range(-(-COLD_BYTES // (x.numel() * 2)))]
    r = dict(
        ms=time_ms(lambda: kernel(x)),
        plain_ms=time_ms(lambda: ref.topk_lse_ref(x, k)),
        library_ms=time_ms(lambda: library(x)),
        cold_ms=time_ms_cold(kernel, copies),
        cold_library_ms=time_ms_cold(library, copies),
        dev_ms=time_ms_graph(kernel, [(x,)] * 10),
        dev_library_ms=time_ms_graph(library, [(x,)] * 10),
        dev_cold_ms=time_ms_graph(kernel, copies),
        dev_cold_library_ms=time_ms_graph(library, copies),
        f32_ms=time_ms(lambda: kernel(logits)),
        f32_dev_ms=time_ms_graph(kernel, [(logits,)] * 10),
        f32_dev_library_ms=time_ms_graph(library, [(logits,)] * 10),
    )
    del copies
    per_k = {kk: time_ms_graph(lambda x, kk=kk: kernel(x, kk), [(x,)] * 10)
             for kk in (1, 64, 256, 4096, 8192)}  # 8192: global scratch
    xs = small.to(torch.bfloat16)
    per_k["V=4097, k=V"] = time_ms_graph(lambda x: kernel(x, 4097),
                                         [(xs,)] * 10)
    b, by = bound(t * v * 2 + t * k * 8 + t * 4, 3.0 * t * v, "f32")
    b32 = bound(t * v * 4 + t * k * 8 + t * 4, 3.0 * t * v, "f32")[0]
    return dict(
        name="topk_lse", route="cuda",
        source="src/repro_torch/kernels/csrc/topk_lse.cu",
        replaces="src/repro/kernels/topk_lse.py:118",
        max_abs_err=err, ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=b,
        bound_by=by, library_ms=r["library_ms"], dev_ms=r["dev_ms"],
        dev_cold_ms=r["dev_cold_ms"], dev_library_ms=r["dev_library_ms"],
        shape=(f"T={t} V={v} k={k} bf16; cold L2 {r['cold_ms']:.4f} ms, "
               f"library cold {r['cold_library_ms']:.4f}; device time alone "
               f"(CUDA graph replay) warm {r['dev_ms']:.4f}, cold "
               f"{r['dev_cold_ms']:.4f}, library warm "
               f"{r['dev_library_ms']:.4f}, cold "
               f"{r['dev_cold_library_ms']:.4f}; f32 logits {r['f32_ms']:.4f} "
               f"ms, device {r['f32_dev_ms']:.4f}, library device "
               f"{r['f32_dev_library_ms']:.4f}, bound {b32:.5f}; device warm "
               f"by k (bf16): "
               + ", ".join(f"{kk} {ms:.4f}" for kk, ms in per_k.items())
               + f"; one launch per call, a cluster per row; checked at k "
               f"{', '.join(map(str, TOPK_KS))} in f32 and bf16, V=4097 at "
               f"k=64 and k=V, ties across blocks, ±0 and -inf ties, and at "
               f"k={k} for V in {list(ARCH_VOCABS)} in f32 and bf16"),
        tol=f"{TOPK_TOL} lse; values and indices exact",
    )


def paged_case(torch, dtype, g, page=16, npg=10,
               pos=(0, 15, 16, 31, 47, 100, 127, 159), hole=True,
               heads=(32, 8, 128), empty=False):
    """llama3-8b decode shapes by default: 8 rows, 32 query / 8 kv heads of
    128, a shuffled pool; -1 past every row's pos and, with ``hole``, a -1
    page inside row 5's context; with ``empty``, row 1's pages all -1 and
    row 2's pos -1 (both attend nothing: the mean of V)."""
    b, (hq, hkv, d) = len(pos), heads
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
    pos = list(pos)
    if empty:
        pt[1] = -1
        pos[2] = -1
    return (q, kp, vp, pt.cuda(),
            torch.tensor(pos, dtype=torch.int32, device="cuda"))


def paged_check(torch, ops, ref, case, tol) -> float:
    """Kernel against the plain version run in f32 -> max abs error."""
    q, kp, vp, pt, pos = case
    out = ops.paged_decode_attn(q, kp, vp, pt, pos, impl="cuda")
    if out.dtype != q.dtype:
        raise AssertionError(f"paged_decode_attn gave {out.dtype} for "
                             f"{q.dtype}")
    want = ref.paged_decode_attn_ref(q.float(), kp.float(), vp.float(), pt,
                                     pos)
    diff = (out.float() - want).abs()
    if not (diff <= tol * (1 + want.abs())).all():
        raise AssertionError(f"paged_decode_attn {q.dtype} page "
                             f"{kp.shape[1]} heads {q.shape[1]}/"
                             f"{kp.shape[2]}: err {diff.max().item()}")
    return diff.max().item()


# the serve phase's rows decode at contexts 81-160 (prompts 80-128 plus up
# to 32 new tokens); the timed case puts every row in its top half
SERVE_POS = (159, 151, 147, 143, 139, 135, 131, 128)
# (Hq, Hkv, D): llama3-8b's heads, the JAX test's G = 16, granite-34b's
# G = 48 (three head slices), D = 36 (144-byte rows in f32, 72-byte ones
# in bf16, which take the scalar copy), deepseek-7b's G = 1 and qwen3-14b's
# G = 5; musicgen-medium's 24 kv heads of 64 (G = 1, D = 64); pixtral-12b's
# are llama3-8b's
PAGED_HEADS = ((32, 8, 128), (16, 1, 64), (48, 1, 128), (8, 2, 36),
               (32, 32, 128), (40, 8, 128), (24, 24, 64))
# pages of 256 (spans inside one page) and of 5 (a tile crosses many)
PAGED_LAYOUTS = ({}, dict(page=256, npg=3,
                          pos=(0, 255, 256, 300, 511, 600, 700, 767)),
                 dict(page=5, npg=32, pos=(0, 4, 5, 77, 100, 120, 150, 159)))


def paged_timings(torch, ops, ref, case, plain=False) -> dict:
    """Eager, cold-L2 and device-alone (CUDA graph replay) times of the
    kernel and of page gather + SDPA on ``case``, and the bound."""
    import torch.nn.functional as F

    q, kp, vp, pt, pos = case
    b, hq, d = q.shape
    page, hkv = kp.shape[1], kp.shape[2]
    t = pt.shape[1] * page
    tpos = torch.arange(t, device="cuda")
    valid = (tpos[None] <= pos[:, None]) & (pt >= 0).repeat_interleave(page, 1)

    def kernel(q, kp, vp, pt, pos, valid):
        return ops.paged_decode_attn(q, kp, vp, pt, pos, impl="cuda")

    def library(q, kp, vp, pt, pos, valid):
        k = kp[pt.long().clamp(min=0)].reshape(b, t, hkv, d).transpose(1, 2)
        v = vp[pt.long().clamp(min=0)].reshape(b, t, hkv, d).transpose(1, 2)
        return F.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=valid[:, None, None],
            enable_gqa=True,
        )

    args = (q, kp, vp, pt, pos, valid)
    n = -(-COLD_BYTES // (2 * kp.numel() * kp.element_size()))
    copies = [tuple(x.clone() for x in args) for _ in range(n)]
    ntok = int(valid.sum().item())  # attended positions, summed over rows
    moved = (2 * ntok * hkv * d * kp.element_size()
             + 2 * q.numel() * q.element_size() + pt.numel() * 4
             + pos.numel() * 4)
    out = dict(
        ms=time_ms(lambda: kernel(*args)),
        library_ms=time_ms(lambda: library(*args)),
        cold_ms=time_ms_cold(kernel, copies),
        cold_library_ms=time_ms_cold(library, copies),
        dev_ms=time_ms_graph(kernel, [args] * 10),
        dev_library_ms=time_ms_graph(library, [args] * 10),
        dev_cold_ms=time_ms_graph(kernel, copies),
        dev_cold_library_ms=time_ms_graph(library, copies),
        bound=bound(moved, 4.0 * ntok * hq * d, "bf16"),
    )
    if plain:
        out["plain_ms"] = time_ms(
            lambda: ref.paged_decode_attn_ref(q, kp, vp, pt, pos))
    del copies
    return out


def paged_phase(torch, ops, ref) -> dict:
    """Correctness at page edges, holes, pages of 5 and 256, the heads of
    llama3-8b, deepseek-7b, qwen3-14b and granite-34b (G = 4, 1, 5, 48),
    G = 16, D = 36, rows that attend nothing (all pages -1, pos = -1), f32
    and bf16, and each head shape at the serve phase's contexts;
    time and bound at the serve phase's shapes and load, warm, cold and as
    device time alone, beside page gather + SDPA; device time at a
    2048-position table with contexts 50-2048 and 129-160."""
    from repro_torch.kernels.decode_attn import split_plan

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
    for heads in PAGED_HEADS:
        for kw in PAGED_LAYOUTS:
            err32 = max(err32, paged_check(torch, ops, ref, paged_case(
                torch, torch.float32, g, heads=heads, empty=True, **kw),
                PAGED_F32_TOL))
            err = max(err, paged_check(torch, ops, ref, paged_case(
                torch, torch.bfloat16, g, heads=heads, empty=True, **kw),
                PAGED_BF16_TOL))
        err = max(err, paged_check(torch, ops, ref, paged_case(
            torch, torch.bfloat16, g, pos=SERVE_POS, hole=False,
            heads=heads), PAGED_BF16_TOL))
    case = paged_case(torch, torch.bfloat16, g, pos=SERVE_POS, hole=False)
    err = max(err, paged_check(torch, ops, ref, case, PAGED_BF16_TOL))
    r = paged_timings(torch, ops, ref, case, plain=True)
    q, kp = case[0], case[1]
    b, hq, d = q.shape
    page, hkv = kp.shape[1], kp.shape[2]
    plan = split_plan(b, hq, hkv, case[3].shape[1] * page, d, 2)
    del case
    longs = {}
    for name, pos in (("contexts 50-2048", MIXED_POS),
                      ("contexts 129-160", SERVE_POS)):
        case = paged_case(torch, torch.bfloat16, g, npg=128, pos=pos,
                          hole=False)
        err = max(err, paged_check(torch, ops, ref, case, PAGED_BF16_TOL))
        longs[name] = paged_timings(torch, ops, ref, case)
        del case
    lp = split_plan(b, hq, hkv, 2048, d, 2)
    return dict(
        name="paged_decode_attn", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attn.cu",
        replaces="src/repro/kernels/decode_attn.py:115",
        max_abs_err=err, ms=r["ms"], plain_ms=r["plain_ms"],
        bound_ms=r["bound"][0], bound_by=r["bound"][1],
        library_ms=r["library_ms"], dev_ms=r["dev_ms"],
        dev_cold_ms=r["dev_cold_ms"], dev_library_ms=r["dev_library_ms"],
        f32_max_abs_err=err32,
        shape=(f"B={b} Hq={hq} Hkv={hkv} D={d} page={page} ctx "
               f"{min(SERVE_POS) + 1}-{max(SERVE_POS) + 1} bf16, "
               f"{plan[2]} spans of {plan[3]}; cold L2 {r['cold_ms']:.4f} "
               f"ms, library cold {r['cold_library_ms']:.4f}; device time "
               f"alone (CUDA graph replay) warm {r['dev_ms']:.4f}, cold "
               f"{r['dev_cold_ms']:.4f}, library warm "
               f"{r['dev_library_ms']:.4f}, cold "
               f"{r['dev_cold_library_ms']:.4f}; a 2048-position table "
               f"({lp[2]} spans of {lp[3]}), device cold kernel / library: "
               + "; ".join(f"{n} {x['dev_cold_ms']:.4f} / "
                           f"{x['dev_cold_library_ms']:.4f} (bound "
                           f"{x['bound'][0]:.5f})" for n, x in longs.items())
               + f"; library = page gather + SDPA; checked also at pages of "
               f"5 and 256, (Hq, Hkv, D) in {list(PAGED_HEADS)}, rows with "
               f"every page -1 and pos=-1, and in f32 (err {err32:.3g})"),
        tol=f"{PAGED_BF16_TOL} bf16, {PAGED_F32_TOL} f32 (times 1 + |plain|)",
    )


def decode_inputs(torch, g, b, hq, hkv, d, t, dtype):
    """q [b,hq,d], K/V [b,t,hkv,d] in ``dtype`` on the card."""
    q = torch.randn((b, hq, d), device="cuda", generator=g).to(dtype)
    k = torch.randn((b, t, hkv, d), device="cuda", generator=g).to(dtype)
    v = torch.randn((b, t, hkv, d), device="cuda", generator=g).to(dtype)
    return q, k, v


def depth_mask(torch, pos, t):
    """[B, T]: row i attends positions 0..pos[i] (an occupancy mask)."""
    pos = torch.tensor(pos, device="cuda")
    return torch.arange(t, device="cuda")[None] <= pos[:, None]


def window_mask(torch, pos, t, window):
    """[B, T]: the rolling-slot mask of gqa_decode at depths ``pos``."""
    pos = torch.tensor(pos, device="cuda")[:, None]
    slot_pos = pos - torch.remainder(pos - torch.arange(t, device="cuda"), t)
    return (slot_pos >= 0) & (slot_pos > pos - window)


def rel_l2(got, want) -> float:
    """The largest |got - want| / |want| in L2 over the last axis."""
    return ((got - want).norm(dim=-1)
            / want.norm(dim=-1).clamp_min(1e-30)).max().item()


def decode_check(torch, ops, ref, q, k, v, valid, worst: dict) -> None:
    """Kernel against the plain version run in f32; the largest errors so
    far go into ``worst`` (absolute by dtype, and bf16's relative)."""
    out = ops.decode_attn(q, k, v, valid, impl="cuda")
    if out.dtype != q.dtype:
        raise AssertionError(f"decode_attn gave {out.dtype} for {q.dtype}")
    want = ref.decode_attn_ref(q.float(), k.float(), v.float(), valid)
    diff = (out.float() - want).abs()
    tol = DECODE_TOL[str(q.dtype)]
    if not (diff <= tol).all():
        raise AssertionError(f"decode_attn {tuple(k.shape)} {q.dtype}: err "
                             f"{diff.max().item()} > {tol}")
    if q.dtype == torch.bfloat16:
        rel = rel_l2(out.float(), want)
        if rel > DECODE_BF16_REL:
            raise AssertionError(f"decode_attn {tuple(k.shape)} bf16: "
                                 f"relative err {rel} > {DECODE_BF16_REL}")
        worst["rel"] = max(worst.get("rel", 0.0), rel)
    dead = ~valid.any(dim=1)  # rows with no valid position: the mean of V
    if dead.any():
        g = q.shape[1] // k.shape[2]
        mean = v[dead].float().mean(dim=1).repeat_interleave(g, dim=1)
        if not ((out[dead].float() - mean).abs() <= tol).all():
            raise AssertionError("decode_attn: an all-masked row is not the "
                                 "mean of V")
    key = str(q.dtype)
    worst[key] = max(worst.get(key, 0.0), diff.max().item())


# the hybrid serve phase's rows decode at contexts 301-332 (prompts of 300,
# up to 32 new tokens) in a 332-slot cache; the dense-cache llama3-8b phase's
# at 81-160 in a 160-slot one (SERVE_POS: every row in the top half)
HYBRID_POS = tuple(300 + 31 - 4 * i for i in range(8))
# rows of a 2048-slot cache at contexts spread from 50 to 2048: the cache is
# sized for the longest request, the rows hold prompts of every length
MIXED_POS = tuple(49 + (2047 - 49) * i // 7 for i in range(8))
# mixtral-8x22b's decode: 48 query heads over 8 kv heads of 128 in its
# 4,096-slot rolling window; rows before the wrap, at it and past it (the
# long-prompt serve decodes at depths 4160-4175). The short-prompt serve
# decodes at contexts 129-160 in a 160-slot cache, as llama3-8b's does
MIXTRAL_DECODE = (8, 48, 8, 128, 4096)
MIXTRAL_POS = (127, 4095, 4096, 4160, 4163, 4167, 4171, 4175)
MIXTRAL_SHORT = (8, 48, 8, 128, 160)
# the prefix checks' dense caches (2 rows, prefix + 128 prompt tokens + 16
# new ones): pixtral-12b's 32/8 heads of 128 after 1,024 patches,
# musicgen-medium's 24/24 heads of 64 after 64 frames; the rows decode at
# contexts prefix + 129 to prefix + 144
PREFIX_DECODE = ((2, 32, 8, 128, 1168), (2, 24, 24, 64, 208))


def time_ms_cold(fn, copies, iters: int = 20, warmup: int = 2) -> float:
    """As ``time_ms``, but each batch is one pass of ``fn`` over ``copies``
    (argument tuples whose bytes together exceed the 50 MB L2): every call
    finds its inputs out of L2, as a layer of the serve step finds its own
    cache; host launch costs count as in ``time_ms``."""
    import torch

    for _ in range(warmup):
        for c in copies:
            fn(*c)
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for c in copies:
            fn(*c)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / len(copies))
    times.sort()
    return times[len(times) // 2]


def time_ms_graph(fn, copies, iters: int = 20) -> float:
    """Device time per call: one call of ``fn`` on each argument tuple of
    ``copies`` captured in a CUDA graph, the graph replayed ``iters`` times
    (median, CUDA events), so no host launch cost sits between the calls.
    With copies whose bytes together exceed the 50 MB L2, every call finds
    its inputs out of L2, as a layer of the serve step finds its own
    cache; with one tuple repeated, they stay in L2."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up: build, opt in, scratch
        for c in copies:
            fn(*c)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for c in copies:
            fn(*c)
    graph.replay()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / len(copies))
    del graph
    times.sort()
    return times[len(times) // 2]


def kernel_ms(torch, fn, n: int = 10) -> dict:
    """Device time of ``fn``'s kernels by name: torch.profiler over ``n``
    calls after a warm-up -> {name: (ms per launch, launches seen)}, each
    name's time over the launches of it that the profiler saw. It may see
    fewer than were made: once the process has run the serve profiles,
    each profiler run loses a few launches, and a run of ten ledger calls
    has lost some or all of its ten. Every kernel this is used on launches
    once a call, so ms per launch is ms per call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.count:
            us = getattr(e, "self_device_time_total", None) or getattr(
                e, "self_cuda_time_total", 0.0)
            out[e.key] = (us / 1e3 / e.count, e.count)
    return out


COLD_BYTES = 128 << 20  # input copies a cold timing rotates through


def decode_attn_phase(torch, ops, ref) -> dict:
    """The dense-cache kernel at zamba2's shared-block shape (G = 1, D = 80,
    T = 332) and llama3-8b's dense-cache shape (G = 4, D = 128, T = 160) in
    bf16, an all-masked and a one-position row, f32 cases, a rolling
    window, the JAX test's G = 16 and a granite-34b-like G = 48, a row whose
    valid positions lie in one span and T no multiple of the span,
    mixtral-8x22b's two serve shapes (G = 6, T = 160 and the wrapped
    4,096-slot window) in bf16 and f32; timed at zamba2's, llama3-8b's and
    mixtral's window shape, warm (inputs in L2) and cold."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attn import split_plan

    g = torch.Generator(device="cuda").manual_seed(2)
    zamba = decode_inputs(torch, g, 8, 32, 32, 80, 332, torch.bfloat16)
    llama = decode_inputs(torch, g, 8, 32, 8, 128, 160, torch.bfloat16)
    zmask = depth_mask(torch, HYBRID_POS, 332)
    lmask = depth_mask(torch, SERVE_POS, 160)
    worst = {}
    decode_check(torch, ops, ref, *zamba, zmask, worst)
    decode_check(torch, ops, ref, *llama, lmask, worst)
    edge = zmask.clone()
    edge[0] = False  # no valid position: the mean of V
    edge[1] = False
    edge[1, 17] = True  # one valid position: its value
    decode_check(torch, ops, ref, *zamba, edge, worst)
    for shape, mask in (
            ((2, 8, 2, 64, 300), depth_mask(torch, (299, 40), 300)),
            ((8, 32, 32, 80, 332), window_mask(
                torch, (10, 331, 332, 500, 700, 1000, 0, 400), 332, 256)),
            ((4, 32, 8, 128, 129), depth_mask(torch, (-1, 0, 64, 128), 129)),
            # D = 256 with a group of 16: the largest block the plan makes
            ((2, 16, 1, 256, 300), depth_mask(torch, (299, 40), 300))):
        case = decode_inputs(torch, g, *shape, torch.float32)
        decode_check(torch, ops, ref, *case, mask, worst)
    # mixed prompt lengths in a long cache: spans of several tiles, the
    # empty ones not read
    mixed = decode_inputs(torch, g, 8, 32, 8, 128, 2048, torch.bfloat16)
    decode_check(torch, ops, ref, *mixed, depth_mask(torch, MIXED_POS, 2048),
                 worst)
    del mixed
    # wide groups: the JAX test's G = 16 (T = 700, no multiple of its span)
    # and 48 query heads on one kv head (three head slices); row 1 valid in
    # one span only, row 2 at both ends with empty spans between
    wide = []
    for shape in ((3, 16, 1, 64, 700), (8, 48, 1, 128, 512)):
        b_, hq_, hkv_, d_, t_ = shape
        _, _, nsplit, span, _ = split_plan(b_, hq_, hkv_, t_, d_, 2)
        mask = depth_mask(torch, tuple(range(t_ - 1, -1, -(t_ // b_)))[:b_],
                          t_)
        mask[0] = False
        mask[1] = False
        mask[1, span + 2:span + 9] = True
        mask[2] = False
        mask[2, :3] = True
        mask[2, t_ - 3:] = True
        for dtype in (torch.bfloat16, torch.float32):
            case = decode_inputs(torch, g, *shape, dtype)
            decode_check(torch, ops, ref, *case, mask, worst)
        wide.append(f"B={b_} Hq={hq_} Hkv={hkv_} T={t_}: {nsplit} spans of "
                    f"{span}")
    for shape in PREFIX_DECODE:
        t_ = shape[-1]
        for dtype in (torch.bfloat16, torch.float32):
            case = decode_inputs(torch, g, *shape, dtype)
            decode_check(torch, ops, ref, *case,
                         depth_mask(torch, (t_ - 1, t_ - 16), t_), worst)
    mixtral = {}
    for dtype in (torch.bfloat16, torch.float32):
        for shape, mask in (
                (MIXTRAL_SHORT, depth_mask(torch, SERVE_POS, 160)),
                (MIXTRAL_DECODE, window_mask(torch, MIXTRAL_POS, 4096, 4096))):
            case = decode_inputs(torch, g, *shape, dtype)
            decode_check(torch, ops, ref, *case, mask, worst)
            if dtype == torch.bfloat16:
                mixtral = (case, mask)
    # the relative limit's power: the plain version with one 64-position
    # tile dropped from a full 4,096-position row must fail it
    (q, k, v), mask = mixtral
    args = (q.float(), k.float(), v.float())
    cut = mask.clone()
    cut[1, 1024:1088] = False  # row 1 attends all 4,096 slots
    dropped = rel_l2(ref.decode_attn_ref(*args, cut),
                     ref.decode_attn_ref(*args, mask))
    if dropped <= DECODE_BF16_REL:
        raise AssertionError(f"decode_attn: a dropped tile gives relative "
                             f"err {dropped}, inside {DECODE_BF16_REL}")

    def timed(q, k, v, valid):
        b, hq, d = q.shape
        hkv, t = k.shape[2], k.shape[1]
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        ntok = int(valid.sum().item())  # attended positions, all rows
        moved = (2 * ntok * hkv * d * k.element_size()
                 + 2 * q.numel() * q.element_size() + valid.numel())

        def kernel(q, k, v, valid):
            return ops.decode_attn(q, k, v, valid, impl="cuda")

        def library(q, kt, vt, valid):
            return F.scaled_dot_product_attention(
                q[:, :, None], kt, vt, attn_mask=valid[:, None, None],
                enable_gqa=True)

        n = -(-COLD_BYTES // (2 * k.numel() * k.element_size()))
        copies = [tuple(x.clone() for x in (q, k, v, valid))
                  for _ in range(n)]
        lib_copies = [(q_, k_.transpose(1, 2), v_.transpose(1, 2), m_)
                      for q_, k_, v_, m_ in copies]
        out = dict(
            ms=time_ms(lambda: kernel(q, k, v, valid)),
            plain_ms=time_ms(lambda: ref.decode_attn_ref(q, k, v, valid)),
            library_ms=time_ms(lambda: library(q, kt, vt, valid)),
            cold_ms=time_ms_cold(kernel, copies),
            cold_library_ms=time_ms_cold(library, lib_copies),
            dev_ms=time_ms_graph(kernel, [(q, k, v, valid)] * 10),
            dev_library_ms=time_ms_graph(library, [(q, kt, vt, valid)] * 10),
            dev_cold_ms=time_ms_graph(kernel, copies),
            dev_cold_library_ms=time_ms_graph(library, lib_copies),
            bound=bound(moved, 4.0 * ntok * hq * d, "bf16"),
            plan=split_plan(b, hq, hkv, t, d, k.element_size()),
        )
        del copies, lib_copies
        return out

    def more_times(r):
        return (f"cold L2 {r['cold_ms']:.4f} ms, library cold "
                f"{r['cold_library_ms']:.4f}; device time alone (CUDA graph "
                f"replay) warm {r['dev_ms']:.4f}, cold {r['dev_cold_ms']:.4f}, "
                f"library warm {r['dev_library_ms']:.4f}, cold "
                f"{r['dev_cold_library_ms']:.4f}")

    z, lt = timed(*zamba, zmask), timed(*llama, lmask)
    mx = timed(*mixtral[0], mixtral[1])
    del mixtral
    return dict(
        name="decode_attn", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attn.cu",
        replaces="src/repro/kernels/decode_attn.py:176",
        max_abs_err=worst["torch.bfloat16"], ms=z["ms"],
        plain_ms=z["plain_ms"], bound_ms=z["bound"][0], bound_by=z["bound"][1],
        library_ms=z["library_ms"], f32_max_abs_err=worst["torch.float32"],
        tol=f"{DECODE_TOL['torch.bfloat16']} bf16 and {DECODE_BF16_REL} "
            f"relative per (row, head) in L2, {DECODE_TOL['torch.float32']} "
            f"f32",
        shape=(f"B=8 Hq=32 Hkv=32 D=80 T=332 ctx {min(HYBRID_POS) + 1}-"
               f"{max(HYBRID_POS) + 1} bf16, {z['plan'][2]} spans of "
               f"{z['plan'][3]}; {more_times(z)}; at llama3-8b's B=8 Hq=32 "
               f"Hkv=8 D=128 T=160 ({lt['plan'][2]} spans of "
               f"{lt['plan'][3]}): {lt['ms']:.4f} ms, plain "
               f"{lt['plain_ms']:.4f}, library {lt['library_ms']:.4f}, bound "
               f"{lt['bound'][0]:.5f}, {more_times(lt)}; at mixtral-8x22b's "
               f"B=8 Hq=48 Hkv=8 D=128 T=4096 rolling window, contexts "
               f"{min(MIXTRAL_POS) + 1}-{max(MIXTRAL_POS) + 1} "
               f"({mx['plan'][2]} spans of {mx['plan'][3]}): {mx['ms']:.4f} "
               f"ms, plain {mx['plain_ms']:.4f}, library "
               f"{mx['library_ms']:.4f}, bound {mx['bound'][0]:.5f}, "
               f"{more_times(mx)}; checked also at the short mixtral "
               f"serve's T=160, contexts {min(SERVE_POS) + 1}-"
               f"{max(SERVE_POS) + 1}, and at the prefix checks' (B, Hq, Hkv, "
               f"D, T) {list(PREFIX_DECODE)} at contexts T-15 and T in bf16 "
               f"and f32; a tile of 64 positions dropped from a "
               f"full window row gives relative err {dropped:.3g}, which the "
               f"bf16 limit rejects (the kernel's worst, every bf16 case: "
               f"{worst['rel']:.3g}); one grid per call, "
               f"spans merged in a thread-block cluster; checked also with "
               f"an all-masked row, one valid position, a rolling window, "
               f"{'; '.join(wide)} (a row valid in one span, empty spans "
               f"between valid ones), contexts 50-2048 of T=2048, and in f32 "
               f"(also D=256, G=16; err {worst['torch.float32']:.3g})"),
    )


def ssd_inputs(torch, g, bsz, s, h, p, gr, n, dtype):
    """x, dt = softplus(normal), a = -exp(normal), B/C = normal / 2: the
    draws of the JAX package's ssd test, on the card."""
    import torch.nn.functional as F

    def rnd(*shape):
        return torch.randn(shape, device="cuda", generator=g)

    return (rnd(bsz, s, h, p).to(dtype), F.softplus(rnd(bsz, s, h)),
            -torch.exp(rnd(h)), (rnd(bsz, s, gr, n) * 0.5).to(dtype),
            (rnd(bsz, s, gr, n) * 0.5).to(dtype))


def _close(torch, got, want, atol, rtol, what) -> tuple[float, float]:
    """-> (max abs error, largest share of its tolerance an entry used)."""
    diff = (got.float() - want.float()).abs()
    tol = atol + rtol * want.float().abs()
    if not (diff <= tol).all():
        raise AssertionError(f"{what}: err {diff.max().item()}")
    return diff.max().item(), (diff / tol).max().item()


def ssd_check(torch, ops, ref, case, chunk) -> tuple[float, float, float]:
    """Kernel against the plain chunked scan and the sequential oracle, in
    y and in the final state -> (max abs err of y, of the state, largest
    share of the tolerance used by an entry of y)."""
    from repro_torch.models.ssm import ssd_chunked

    y, st = ops.ssd_scan(*case, chunk=chunk, impl="cuda")
    x = case[0]
    if y.dtype != x.dtype or st.dtype != torch.float32:
        raise AssertionError(f"ssd gave {y.dtype}/{st.dtype} for {x.dtype}")
    f32 = x.dtype == torch.float32
    atol, rtol = (SSD_ATOL, SSD_RTOL) if f32 else (SSD_BF16_ATOL,
                                                    SSD_BF16_RTOL)
    ey = es = used = 0.0
    what = f"ssd {tuple(x.shape)} {x.dtype}"
    for wy, wst in (ssd_chunked(*case, chunk=min(chunk, x.shape[1])),
                    ref.ssd_ref(*case)):
        e, u = _close(torch, y, wy, atol, rtol, what + " y")
        ey, used = max(ey, e), max(used, u)
        es = max(es, _close(torch, st, wst, SSD_ATOL, SSD_RTOL,
                            what + " state")[0])
    return ey, es, used


def ssd_flops(bsz, s, h, p, n, chunk, part="all") -> float:
    """Operations of the chunk scan: per head and chunk of Lc steps, the
    scores on and below the diagonal, n Lc (Lc + 1) ("scores", C . B^T),
    their product with x, p Lc (Lc + 1), and the inter-chunk output and
    the state update, 4 n p Lc ("rest" is all but the scores)."""
    total = 0.0
    for c0 in range(0, s, chunk):
        lc = min(chunk, s - c0)
        sc = n * lc * (lc + 1)
        rest = p * lc * (lc + 1) + 4 * n * p * lc
        total += {"all": sc + rest, "scores": sc, "rest": rest}[part]
    return bsz * h * total


def ssd_bounds(bsz, s, h, p, gr, n, dtype) -> dict:
    """Least times of one call, each against the input and output bytes at
    3.35 TB/s: "design", the kernel's bound, at the rate of the units it
    uses: in bf16 every product on the tensor cores at 989 TFLOP/s, the
    three with an f32 operand (all but the scores) counted twice for their
    hi and lo halves, the fastest rate that keeps them near f32; "f32",
    every operation at the CUDA cores' 67 TFLOP/s, the bound the first,
    CUDA-core design of the kernel was read against."""
    isz = dtype.itemsize
    moved = (2 * bsz * s * h * p * isz + 2 * bsz * s * gr * n * isz
             + bsz * s * h * 4 + h * 4 + bsz * h * p * n * 4)
    sc = ssd_flops(bsz, s, h, p, n, 128, "scores")
    rest = ssd_flops(bsz, s, h, p, n, 128, "rest")
    design = ((sc + 2 * rest, "bf16") if isz == 2 else (sc + rest, "f32"))
    return {"f32": bound(moved, sc + rest, "f32"),
            "design": bound(moved, *design)}


def ssd_phase(torch, ops, ref) -> dict:
    """The scan at zamba2's and mamba2's 300-token prefills (three chunks,
    the last one short), a long case, one chunk (a 100-token prompt), an
    exact multiple of the chunk and N = 256 in bf16, and the JAX test's odd
    shapes and N = 256 in f32; timed at the prefills and the long case."""
    from repro_torch.kernels import ssd as SSD
    from repro_torch.models.ssm import ssd_chunked

    g = torch.Generator(device="cuda").manual_seed(3)
    bf = torch.bfloat16
    shapes = {"zamba2": (1, 300, 80, 64, 1, 64, bf),
              "mamba2": (1, 300, 32, 64, 1, 128, bf),
              "long": (4, 2048, 80, 64, 1, 64, bf)}
    cases = {k: ssd_inputs(torch, g, *v) for k, v in shapes.items()}
    ey = es = used = 0.0
    for case in cases.values():
        a, b, u = ssd_check(torch, ops, ref, case, 128)
        ey, es, used = max(ey, a), max(es, b), max(used, u)
    for shape in ((1, 100, 80, 64, 1, 64, bf), (1, 256, 32, 64, 1, 128, bf),
                  (1, 300, 8, 64, 1, 256, bf)):
        a, b, u = ssd_check(torch, ops, ref, ssd_inputs(torch, g, *shape),
                            128)
        ey, es, used = max(ey, a), max(es, b), max(used, u)
    ey32 = 0.0
    for shape, chunk in (((2, 50, 4, 16, 2, 16), 16),
                         ((2, 64, 4, 16, 1, 32), 16),
                         ((1, 96, 2, 32, 2, 16), 32),
                         ((1, 100, 8, 64, 1, 64), 128),
                         ((1, 300, 8, 64, 1, 256), 128)):
        a, b, _ = ssd_check(torch, ops, ref, ssd_inputs(
            torch, g, *shape, torch.float32), chunk)
        ey32, es = max(ey32, a), max(es, b)
    times = {k: time_ms(lambda c=c: ops.ssd_scan(*c, chunk=128, impl="cuda"))
             for k, c in cases.items()}
    grids = {}  # device ms of each of the call's two grids
    for k, c in cases.items():
        per = kernel_ms(torch, lambda c=c: ops.ssd_scan(*c, chunk=128,
                                                        impl="cuda"))
        grids[k] = tuple(sum(v[0] for n, v in per.items() if key in n)
                         for key in ("ssd_scan_state", "ssd_scan_out"))
    bnd = {k: ssd_bounds(*v) for k, v in shapes.items()}
    smem = {k: SSD.smem_bytes(128, v[3], v[5], 2) for k, v in shapes.items()}
    z = cases["zamba2"]

    def others(k):
        b = bnd[k]
        return (f"{times[k]:.4f} ms, bound {b['design'][0]:.5f} "
                f"({b['design'][1]} at the design's units), "
                f"{b['f32'][0]:.5f} ({b['f32'][1]} at the f32 rate)")

    split = ", ".join(f"{k} {a:.4f} + {b:.4f}" for k, (a, b) in grids.items())

    return dict(
        name="ssd", route="cuda", source="src/repro_torch/kernels/csrc/ssd.cu",
        replaces="src/repro/kernels/ssd.py:89", max_abs_err=max(ey, ey32),
        ms=times["zamba2"],
        plain_ms=time_ms(lambda: ssd_chunked(*z, chunk=128)),
        bound_ms=bnd["zamba2"]["design"][0],
        bound_by=bnd["zamba2"]["design"][1],
        bound_f32_ms=bnd["zamba2"]["f32"][0], library_ms=None,
        tol=(f"y bf16 {SSD_BF16_ATOL} + 2^-7·|plain|, f32 {SSD_ATOL} + "
             f"{SSD_RTOL}·|plain|; state {SSD_ATOL} + {SSD_RTOL}·|plain|"),
        shape=(f"x [1,300,80,64] G=1 N=64 chunk 128 bf16 (zamba2 prefill), "
               f"bound at the design's units; at the CUDA cores' f32 rate "
               f"{bnd['zamba2']['f32'][0]:.5f} ({bnd['zamba2']['f32'][1]}); "
               f"mamba2 [1,300,32,64] N=128: {others('mamba2')}; long "
               f"[4,2048,80,64] N=64: {others('long')}; two grids per call, "
               f"device ms of the state grid + the output grid "
               f"(torch.profiler): {split}; "
               f"shared memory per block {smem['zamba2']} B (zamba2), "
               f"{smem['mamba2']} B (mamba2); checked also at S=100 (one "
               f"chunk), S=256 and N=256 (bf16 and f32); max err y bf16 "
               f"{ey:.3g} (at most {used:.2f} of an entry's tolerance), y "
               f"f32 {ey32:.3g}, "
               f"state {es:.3g}; no single PyTorch call computes the scan"),
    )


def ssd_bwd_inputs(torch, g, bsz, s, h, p, gr, n, dtype, fin):
    """ssd_inputs, a cotangent dy of y and, with ``fin``, one of the final
    state, on the card."""
    x, dt, a, b, c = ssd_inputs(torch, g, bsz, s, h, p, gr, n, dtype)
    dy = torch.randn(x.shape, device="cuda", generator=g).to(dtype)
    df = (torch.randn((bsz, h, p, n), device="cuda", generator=g) if fin
          else None)
    return x, dt, a, b, c, dy, df


def ssd_bwd_check(torch, ops, case, chunk) -> tuple[float, tuple]:
    """The backward kernel against its plain version (``ssd_bwd_ref``) and
    against torch autograd through the plain chunked scan, on the states
    the forward kernel kept -> (max abs err against the plain version,
    (largest share of the tolerance an entry used, where))."""
    from repro_torch.models.ssm import ssd_chunked

    x, dt, a, b, c, dy, df = case
    _, _, states = ops._ssd_forward(x, dt, a, b, c, chunk, "cuda", True)
    got = ops.ssd_bwd(x, dt, a, b, c, states, dy, df, chunk, impl="cuda")
    plain = ops.ssd_bwd(x, dt, a, b, c, states, dy, df, chunk, impl="ref")
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (x, dt, a, b, c)]
    y, final = ssd_chunked(*leaves, chunk=chunk)
    outs, cots = ([y, final], [dy, df]) if df is not None else ([y], [dy])
    auto = torch.autograd.grad(outs, leaves, cots)
    what = f"ssd_bwd {tuple(x.shape)} N={b.shape[3]} G={b.shape[2]} {x.dtype}"
    err, used = 0.0, (0.0, "")
    for name, k, w, v in zip(("dx", "ddt", "da", "dB", "dC"), got, plain,
                             auto):
        if k.dtype != w.dtype or k.shape != w.shape:
            raise AssertionError(f"{what} {name}: {k.dtype} {tuple(k.shape)}"
                                 f" for {w.dtype} {tuple(w.shape)}")
        rtol = (SSD_BWD_BF16_RTOL if k.dtype == torch.bfloat16
                else SSD_BWD_RTOL)
        for want, against in ((w, "plain"), (v, "autograd")):
            atol = SSD_BWD_ATOL * want.float().abs().max().item()
            e, u = _close(torch, k, want, atol, rtol,
                          f"{what} {name} vs {against}")
            used = max(used, (u, f"{name} vs {against}"))
            if against == "plain":
                err = max(err, e)
    return err, used


def ssd_bwd_flops(bsz, s, h, p, n, chunk, design=False) -> float:
    """Operations of the scan's gradient by its formulas (``ssd_bwd_ref``):
    per head and chunk of Lc steps, C . B^T, q = dy . x^T, M^T dy, W B and
    W^T C on and below the diagonal (3 n + 2 p) Lc (Lc + 1), and the five
    [Lc, P] x [P, N]-sized products (the chunk's dy C^T, dS' B_j, S C_i,
    S^T dy_i, dS'^T x_j) 10 Lc p n. With ``design``, as the bf16 kernel
    feeds the tensor cores: every product with an f32 operand (M^T dy, W B,
    W^T C and the five state products) counted twice, for its hi and lo
    halves, (5 n + 3 p) Lc (Lc + 1) + 20 Lc p n."""
    total = 0.0
    for c0 in range(0, s, chunk):
        lc = min(chunk, s - c0)
        if design:
            total += (5 * n + 3 * p) * lc * (lc + 1) + 20 * lc * p * n
        else:
            total += (3 * n + 2 * p) * lc * (lc + 1) + 10 * lc * p * n
    return bsz * h * total


def ssd_bwd_bounds(bsz, s, h, p, gr, n, dtype, chunk=128) -> dict:
    """Least times of one call: the bytes (x, dy, B, C, dt, a and the
    kept states read once; dx, ddt, da, dB, dC written once) at 3.35 TB/s
    against the operations at the inputs' peak rate ("type": bf16 on the
    tensor cores, f32 on the CUDA cores), at the rate of the units the
    kernel uses ("design": in bf16 the tensor cores with each split product
    counted twice, in f32 the CUDA cores) and at the CUDA cores' f32 rate,
    the units of the f32 path ("f32")."""
    isz = dtype.itemsize
    nc = -(-s // chunk)
    moved = (3 * bsz * s * h * p * isz + 4 * bsz * s * gr * n * isz
             + 2 * bsz * s * h * 4 + 2 * h * 4 + bsz * h * nc * p * n * 4)
    ops_ = ssd_bwd_flops(bsz, s, h, p, n, chunk)
    design = ((ssd_bwd_flops(bsz, s, h, p, n, chunk, True), "bf16")
              if isz == 2 else (ops_, "f32"))
    return {"type": bound(moved, ops_, "bf16" if isz == 2 else "f32"),
            "design": bound(moved, *design), "f32": bound(moved, ops_, "f32"),
            "bytes": moved, "flops": ops_, "design_flops": design[0]}


def grid_ms(per: dict, prefix: str) -> dict:
    """{kernel: device ms a call} of ``kernel_ms``'s entries whose name
    holds ``prefix``, each name cut to the kernel's own."""
    import re

    out = {}
    for name, (ms, _) in per.items():
        m = re.search(rf"{prefix}\w*", name)
        if m:
            out[m.group(0)] = out.get(m.group(0), 0.0) + ms
    return out


def ptxas_regs(log: str) -> dict:
    """{kernel entry (mangled): registers a thread} from ``nvcc -Xptxas=-v``
    output (``_build.build_report()["log"]``)."""
    import re

    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out[entry] = int(m.group(1))
    return out


def blocks_per_sm(regs: int, threads: int, smem: int) -> int:
    """Blocks of ``threads`` that fit one H100 SM by registers (65,536, in
    granules of 256 a warp), shared memory (233,472 bytes, 1 KB kept for
    each block) and threads (2,048)."""
    per_warp = -(-regs * 32 // 256) * 256
    by_regs = 65536 // (per_warp * (threads // 32))
    return min(by_regs, 233472 // (smem + 1024), 2048 // threads)


def ssd_bwd_phase(torch, ops) -> dict:
    """The scan's backward kernel at mamba2-370m's train shape (8 kept rows
    of 512, H 32, N 128) in bf16 and f32, zamba2-2.7b's heads (H 80, N 64)
    in bf16, G = 2, S = 300 (a short last chunk), S < L, a non-zero
    final-state cotangent, N = 256 and chunks of 64 in bf16, each against
    its plain version and autograd through the chunked scan; two calls give
    the same bits; timed at the train shape in bf16 (each of its grids by
    the profiler); the bf16 chunk grid's blocks an SM at mamba2's and
    zamba2's N, from ptxas's registers and its shared memory (at least
    two)."""
    from repro_torch.kernels import ssd as SSD

    g = torch.Generator(device="cuda").manual_seed(5)
    bf, f32 = torch.bfloat16, torch.float32
    train = (8, 512, 32, 64, 1, 128)
    shapes = {"mamba2 train bf16": (*train, bf, False),
              "mamba2 train f32": (*train, f32, False),
              "zamba2 bf16": (2, 512, 80, 64, 1, 64, bf, False),
              "G=2 S=300 bf16": (2, 300, 8, 64, 2, 64, bf, False),
              "G=2 S=300 f32, final cotangent": (2, 300, 8, 64, 2, 64, f32,
                                                 True),
              "S=300 bf16, final cotangent": (2, 300, 32, 64, 1, 128, bf,
                                              True),
              "S=100 < L bf16": (2, 100, 32, 64, 1, 128, bf, False),
              "N=256 bf16, final cotangent": (2, 300, 8, 64, 1, 256, bf,
                                              True),
              "chunk 64 G=2 bf16": (2, 200, 16, 64, 2, 128, bf, False)}
    err, used = 0.0, (0.0, "")
    for key, case_shape in shapes.items():
        chunk = 64 if key.startswith("chunk 64") else 128
        e, (u, where) = ssd_bwd_check(torch, ops, ssd_bwd_inputs(
            torch, g, *case_shape), chunk)
        err, used = max(err, e), max(used, (u, f"{where}, {key}"))
        _free(torch)
    x, dt, a, b, c, dy, df = ssd_bwd_inputs(torch, g, *train, bf, False)
    _, _, states = ops._ssd_forward(x, dt, a, b, c, 128, "cuda", True)

    def kernel():
        return ops.ssd_bwd(x, dt, a, b, c, states, dy, None, 128,
                           impl="cuda")

    first, second = kernel(), kernel()
    if not all(torch.equal(u, v) for u, v in zip(first, second)):
        raise AssertionError("ssd_bwd: two calls gave other bits")
    del first, second
    ms = time_ms(kernel, iters=10, reps=5)
    plain_ms = time_ms(lambda: ops.ssd_bwd(x, dt, a, b, c, states, dy, None,
                                           128, impl="ref"),
                       iters=5, reps=2, warmup=2)
    grids = grid_ms(kernel_ms(torch, kernel), "ssd_bwd")
    bnd = ssd_bwd_bounds(*train, bf)
    split = ", ".join(f"{k[8:]} {v:.4f}" for k, v in grids.items())
    from repro_torch.kernels import _build

    regs = ptxas_regs(_build.build_report().get("log", ""))
    fit = {}  # blocks of the bf16 chunk grid an SM, mamba2's and zamba2's
    for key, n, ntm in (("mamba2", 128, 16), ("zamba2", 64, 8)):
        r = next((v for k, v in regs.items()
                  if f"ssd_bwd_chunk_tcILi{ntm}E" in k), None)
        smem = SSD.bwd_smem_bytes(128, 64, n, 2)
        fit[key] = (r, smem, None if r is None else blocks_per_sm(
            r, SSD.BWD_TC_THREADS, smem))
        if r is not None and fit[key][2] < 2:
            raise AssertionError(f"ssd_bwd_chunk_tc at {key}'s N={n}: "
                                 f"{fit[key][2]} block an SM ({r} "
                                 f"registers, {smem} B)")
    fits = "; ".join(f"{k} {v[2]} ({v[0]} registers, {v[1]} B)"
                     for k, v in fit.items())
    return dict(
        name="ssd_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/ssd_bwd.cu",
        replaces="src/repro/kernels/ssd.py:89",
        replaces_note=("the gradient of that kernel, which the JAX package "
                       "takes by autodiff through "
                       "src/repro/models/ssm.py:76 ssd_chunked"),
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        dev_ms=sum(grids.values()), grids_ms=grids,
        bound_ms=bnd["type"][0], bound_by=bnd["type"][1],
        bound_design_ms=bnd["design"][0], bound_f32_ms=bnd["f32"][0],
        library_ms=None, tol_used=used[0],
        tol=(f"{SSD_BWD_ATOL}·max|plain| + {SSD_BWD_RTOL}·|plain| (f32; "
             f"bf16 dx/dB/dC 2^-7·|plain|), also against autograd"),
        shape=(f"x [8,512,32,64] G=1 N=128 chunk 128 bf16 (mamba2-370m's "
               f"kept rows), {bnd['bytes'] / 1e6:.1f} MB moved, "
               f"{bnd['flops'] / 1e9:.2f} GFLOP; bound at the design's "
               f"units (bf16 tensor cores, each split product twice, "
               f"{bnd['design_flops'] / 1e9:.2f} GFLOP) "
               f"{bnd['design'][0]:.4f} ({bnd['design'][1]}), at the CUDA "
               f"cores' f32 rate {bnd['f32'][0]:.4f}; device ms by grid "
               f"(torch.profiler): {split}; the bf16 chunk grid's blocks an "
               f"SM: {fits}; f32 chunk grid {SSD.bwd_smem_bytes(128, 64, 128)}"
               f" B; checked also at {', '.join(list(shapes)[1:])}; at most "
               f"{used[0]:.2f} of an entry's tolerance ({used[1]}); two "
               f"calls equal bits; no single PyTorch call computes this "
               f"gradient"),
    )


def serve_phase(torch, ops, tmp: str, argv=SERVE_ARGV,
                kernels=SERVE_KERNELS) -> dict:
    """``launch.serve.main(argv)`` with every launch count set to 0 just
    before and read just after: every request finishes, the warm fused
    steps run under the sync guard, each of ``kernels`` launches and the
    ledger holds every instance id. The summary comes back with the
    generated tokens of each request (``tokens``, read off the CLI's
    engine) and the ``--ledger-out`` table (``ledger``)."""
    from repro_torch.core.history import HistoryConfig, LossHistory
    from repro_torch.launch import serve

    _free(torch)
    summary_path = os.path.join(tmp, "serve.json")
    ledger_path = os.path.join(tmp, "ledger.npz")
    argv = list(argv) + ["--json-out", summary_path,
                         "--ledger-out", ledger_path]
    engines = []
    build = serve.build_engine

    def keep(*a, **k):
        engines.append(build(*a, **k))
        return engines[-1]

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    serve.build_engine = keep
    try:
        serve.main(argv)
    finally:
        serve.build_engine = build
    launches = dict(ops.LAUNCHES)
    tokens = {int(i): t.tolist() for i, t in engines[0].finished.items()}
    del engines
    with open(summary_path) as f:
        summary = json.load(f)
    if summary["guarded_steps"] != summary["steps"] - 1:
        raise AssertionError("a warm fused step ran without the sync guard: "
                             f"{summary['guarded_steps']} of "
                             f"{summary['steps'] - 1}")
    requests = int(argv[argv.index("--requests") + 1])
    if (summary["evicted"] != requests or summary["queued"]
            or summary["in_flight"]):
        raise AssertionError(f"not every request finished: {summary}")
    if min(launches[k] for k in kernels) <= 0:
        raise AssertionError(f"a serving kernel never launched: {launches}")
    import numpy as np

    ledger = dict(np.load(ledger_path))
    hist = LossHistory(HistoryConfig())
    hist.load_state_dict(ledger)
    ema, seen = hist.lookup(np.asarray(summary["instance_ids"]))
    if not seen.all() or not np.isfinite(ema).all():
        raise AssertionError("ledger misses an instance id or holds non-finite")
    summary["launches"] = launches
    summary["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    summary["tokens"] = tokens
    summary["ledger"] = ledger
    return summary


# phase A: phase 4's serve with the ledger routed over a data axis of one
# rank (NCCL); at 8 slots a capacity factor of 0.125 leaves one row, so
# every other record of a step takes the a2a residual round
ROUTED_ARGV = {
    "gather": ["--ledger-route", "--ledger-exchange", "gather"],
    "a2a": ["--ledger-route", "--ledger-exchange", "a2a",
            "--capacity-factor", "0.125"],
}


def routed_serve_phase(torch, ops, tmp: str, base: dict) -> tuple:
    """Phase 4's serve (``base``) again under ``--ledger-route``, once per
    exchange of ``ROUTED_ARGV``: phase 4's gates (the sync guard on every
    warm step, each kernel's launches), then the same tokens, the same
    ``--ledger-out`` table field for field, the kernels launched as often
    as in ``base``, the JAX summary's routing keys, and an overflow count
    above 0 under a2a -> (summaries, lines)."""
    import numpy as np

    out, lines = {}, []
    for name, extra in ROUTED_ARGV.items():
        t0 = time.perf_counter()
        r = serve_phase(torch, ops, tmp, SERVE_ARGV + extra)
        serve_gates(r, 32)
        want = dict(routed=True, exchange=name, shards=1,
                    capacity_factor=0.125 if name == "a2a" else 1.25)
        if {k: r[k] for k in want} != want:
            raise AssertionError(f"routed {name} summary: {r}")
        if r["tokens"] != base["tokens"]:
            raise AssertionError(f"routed {name}: tokens differ from the "
                                 "unrouted serve's")
        for k, v in base["ledger"].items():
            if not np.array_equal(r["ledger"][k], v):
                raise AssertionError(f"routed {name}: ledger {k} differs "
                                     "from the unrouted serve's")
        for k in SERVE_KERNELS:
            if r["launches"][k] != base["launches"][k]:
                raise AssertionError(f"routed {name}: {k} launched "
                                     f"{r['launches'][k]} times, unrouted "
                                     f"{base['launches'][k]}")
        if (r["a2a_overflow"] > 0) != (name == "a2a"):
            raise AssertionError(f"routed {name}: a2a_overflow "
                                 f"{r['a2a_overflow']}")
        out[name] = r
        lines.append(
            f"{serve_line(f'routed serve ({name}): llama3-8b 32 layers', r)}"
            f"; a2a_overflow {r['a2a_overflow']} of {r['recorded']} records"
            f"; unrouted step ms median {_median(base['step_ms']):.2f}; "
            f"tokens and ledger equal to the unrouted serve's; "
            f"{time.perf_counter() - t0:.1f} s")
    return out, lines


def telemetry_serve_phase(torch, ops, tmp: str, base: dict) -> tuple:
    """Phase 4's serve again with ``--metrics-out``, ``--trace-out`` and
    ``--metrics-every 8``: the same gates (the sync guard on every warm
    step, the kernels' launches), then the JSONL's loop_health events (the
    device ledger's EMA drift against its host shadow under 1e-4) and its
    one summary, and the engine's spans in the trace -> (summary, line)."""
    from repro_torch import obs

    path = os.path.join(tmp, "serve_telemetry")
    argv = SERVE_ARGV + ["--metrics-out", path + ".jsonl", "--trace-out",
                         path + ".trace.json", "--metrics-every", "8"]
    try:
        s = serve_phase(torch, ops, tmp, argv)
    finally:
        obs.install(obs.OFF)
    serve_gates(s, 32)
    rows = obs.read_jsonl(path + ".jsonl")
    kinds = [r["kind"] for r in rows]
    health = [r for r in rows if r["kind"] == "loop_health"]
    spans = {e["name"] for e in obs.load_trace(path + ".trace.json")}
    want = {"engine.admit", "engine.prefill", "engine.decode_step",
            "engine.fetch_metrics", "engine.evict_fetch"}
    if (kinds.count("summary") != 1 or kinds[-1] != "summary" or not health
            or not want <= spans):
        raise AssertionError(f"serve telemetry: kinds {kinds}, spans {spans}")
    drift = max(r["ledger_drift"][c] for r in health
                for c in ("ema", "entropy", "margin"))
    if drift >= 1e-4:
        raise AssertionError(f"ledger drift {drift}")
    c = rows[-1]["metrics"]["counters"]
    if (c["engine.steps"] != s["steps"]
            or c["engine.ledger_records"] != s["recorded"]):
        raise AssertionError(f"engine counters {c} against {s}")
    return s, (f"{serve_line('telemetry serve: llama3-8b 32 layers, paged', s)}"
               f"; phase 4 without telemetry {base['tok_per_s']:.1f} tok/s, "
               f"step ms median {_median(base['step_ms']):.2f}; "
               f"{len(health)} loop_health events (ledger drift at most "
               f"{drift:.3g}) and a summary, spans {sorted(spans)}")


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def serve_line(name: str, s: dict) -> str:
    return (f"{name}: {s['evicted']} requests, {s['generated_tokens']} tokens "
            f"in {s['seconds']:.2f}s = {s['tok_per_s']:.1f} tok/s, "
            f"{s['steps']} engine steps, {s['recorded']} records, launches "
            f"{s['launches']}, peak {s['peak_gib']:.1f} GiB, sync guard on "
            f"{s['guarded_steps']} warm steps; step ms first "
            f"{s['step_ms'][0]:.1f}, median {_median(s['step_ms']):.2f}")


def _per_path(s: dict, counts: dict) -> None:
    """Each kernel's launches against its count per admission or per
    decode step on this path."""
    for name, (per, unit) in counts.items():
        n = s["admitted"] if unit == "admission" else s["steps"]
        if s["launches"][name] != per * n:
            raise AssertionError(f"{name} launched {s['launches'][name]} "
                                 f"times, not {per} per {unit} x {n}")


# the slice's serving paths, each at full width and full depth, dense cache
HYBRID_ARGV = [
    "--arch", "zamba2-2.7b", "--batch", "8", "--requests", "16",
    "--prompt-len", "300", "--gen", "32", "--retain", "topk", "--topk", "64",
    "--ledger", "device", "--temperature", "0", "--device", "cuda",
]
MAMBA_ARGV = [
    "--arch", "mamba2-370m", "--batch", "8", "--requests", "16",
    "--prompt-len", "200", "--gen", "16", "--retain", "topk", "--topk", "64",
    "--ledger", "device", "--temperature", "0", "--device", "cuda",
]
DENSE_ARGV = [
    "--arch", "llama3-8b", "--batch", "8", "--requests", "16",
    "--prompt-len", "128", "--gen", "32", "--page-size", "0",
    "--retain", "topk", "--topk", "64", "--ledger", "device",
    "--temperature", "0", "--device", "cuda",
]


def slice_serve_phases(torch, ops, tmp: str) -> dict:
    """zamba2-2.7b (54 Mamba2 layers in 9 groups, each led by the shared
    attention block), mamba2-370m (48 layers) and llama3-8b through the
    dense cache (32 layers): ssd launches once per SSM layer per admission,
    decode_attn once per attention block per decode step."""
    out = {}
    out["hybrid"] = s = serve_phase(torch, ops, tmp, HYBRID_ARGV,
                                    ("ssd", "decode_attn", "topk_lse"))
    _per_path(s, {"ssd": (54, "admission"), "decode_attn": (9, "step")})
    out["mamba2"] = s = serve_phase(torch, ops, tmp, MAMBA_ARGV,
                                    ("ssd", "topk_lse"))
    _per_path(s, {"ssd": (48, "admission"), "decode_attn": (0, "step")})
    out["dense"] = s = serve_phase(torch, ops, tmp, DENSE_ARGV,
                                   ("decode_attn", "topk_lse"))
    _per_path(s, {"decode_attn": (32, "step"),
                  "paged_decode_attn": (0, "step")})
    return out


def _averages(prof):
    """``prof.key_averages()``, grouped once a profile: each call walks
    every event again, and a train step's profile holds tens of
    thousands."""
    if not hasattr(prof, "_grouped"):
        prof._grouped = prof.key_averages()
    return prof._grouped


def _profile_summary(torch, prof, n) -> tuple[float, float, str]:
    """(device ms per step, kernel launches per step, top five kernels)."""
    events = _averages(prof)

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
    return device_ms, launches, tops


KERNEL_GROUPS = (("matmul", ("nvjet", "gemm", "cutlass", "xmma")),
                 ("xent", ("xent_",)), ("ledger", ("ledger_",)),
                 ("ssd", ("ssd_scan",)), ("ssd_bwd", ("ssd_bwd",)),
                 ("decode_attn", ("dense_decode",)),
                 ("paged_decode_attn", ("paged_decode",)),
                 ("topk_lse", ("topk",)), ("nccl", ("nccl",)),
                 ("elementwise", ("elementwise",)), ("reduce", ("reduce",)))


# each wrapper of kernels.ops -> a piece of the device names of its kernels
KERNEL_NAMES = {"topk_lse": "topk_lse_kernel",
                "paged_decode_attn": "paged_decode",
                "decode_attn": "dense_decode", "ssd": "ssd_scan",
                "ssd_bwd": "ssd_bwd", "xent_fwd": "xent_fwd_kernel",
                "xent_bwd": "xent_bwd_kernel",
                "ledger_record_priority": "ledger_tiles"}


def _seen(torch, prof, made: dict) -> str:
    """How many of the hand-written kernels' launches the profiler saw,
    beside the wrappers' calls made under it (``made``; ssd and ssd_bwd
    launch several kernels a call, the others one)."""
    seen = {k: 0 for k in made}
    for e in _averages(prof):
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for k in made:
                if KERNEL_NAMES[k] in e.key:
                    seen[k] += e.count
    return ", ".join(f"{k} {seen[k]} for {n} calls"
                     for k, n in made.items() if n)


def _kernel_groups(torch, prof, n) -> str:
    """Device ms per step by kind of kernel, from the kernels' names."""
    sums: dict[str, float] = {}
    for e in _averages(prof):
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)
        name = e.key.lower()
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in name for k in keys)), "other")
        sums[group] = sums.get(group, 0.0) + us / 1e3 / n
    return ", ".join(f"{g} {ms:.2f}" for g, ms in
                     sorted(sums.items(), key=lambda kv: -kv[1]))


def profile_phase(torch, argv=SERVE_ARGV) -> str:
    """Where a steady decode step's time goes, at a serve phase's
    configuration: host wall time per step, device kernel time per step
    (torch.profiler), kernel launches per step and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_elastic_mesh
    from repro_torch.models import model as Mdl
    from repro_torch.models.params import materialize

    _free(torch)
    args = serve.parse_args(argv)
    cfg = configs.get(args.arch, layers=args.layers)
    params = materialize(Mdl.param_specs(cfg), args.seed, torch.bfloat16,
                         "cuda")
    mesh = make_elastic_mesh() if args.ledger_route else None
    eng = serve.build_engine(args, cfg, params, torch.device("cuda"),
                             mesh=mesh)
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
    before = dict(ops.LAUNCHES)
    # two steps profiled: the profiler's handling of a step's thousands of
    # events costs more than the step
    n = 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
    seen = _seen(torch, prof, {k: v - before[k]
                               for k, v in ops.LAUNCHES.items()})
    device_ms, launches, tops = _profile_summary(torch, prof, n)
    groups = _kernel_groups(torch, prof, n)
    # the routed ledger's collectives, host and device events alike
    nccl = sum(e.count for e in _averages(prof)
               if "nccl" in e.key.lower()) / n
    del eng, params
    if mesh is not None:
        mesh.close()
    return (f"steady decode step {wall_ms:.2f} ms host wall (8 slots), "
            f"device busy {device_ms:.2f} ms/step "
            f"({100 * device_ms / wall_ms:.1f}%), {launches:.0f} kernel "
            f"launches/step, {nccl:.0f} NCCL events/step; device ms/step "
            f"by kind: {groups}; top device ms/step: {tops}; kernel launches "
            f"the profiler saw: {seen}")


def prefill_phase(torch, arch="zamba2-2.7b", layers=0, length=300,
                  max_seq=332) -> str:
    """One ``length``-token prefill of ``arch`` (cut to ``layers`` where
    given) at batch 1, what an admission runs: host wall time with the
    device drained, median of 5, and its device time by kind of kernel
    under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.models import model as Mdl
    from repro_torch.models.params import materialize

    _free(torch)
    cfg = configs.get(arch, layers=layers)
    params = materialize(Mdl.param_specs(cfg), 0, torch.bfloat16, "cuda")
    g = torch.Generator(device="cuda").manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (1, length), device="cuda",
                         generator=g, dtype=torch.int32)

    def run():
        Mdl.prefill(params, cfg, toks, max_seq=max_seq)
        torch.cuda.synchronize()

    run()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        run()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    device_ms, launches, tops = _profile_summary(torch, prof, 1)
    groups = _kernel_groups(torch, prof, 1)
    del params
    return (f"{arch} ({cfg.num_layers} layers) prefill of {length} tokens: "
            f"{_median(walls):.2f} ms host "
            f"wall (median of 5), device busy {device_ms:.2f} ms, "
            f"{launches:.0f} kernel launches; device ms by kind: {groups}; "
            f"top device ms: {tops}")


def _smoke_f32(arch: str):
    import dataclasses

    from repro_torch import configs

    return dataclasses.replace(configs.get_smoke(arch),
                               param_dtype="float32", compute_dtype="float32")


def engine_reference(torch, arch: str, page_size, sig_atol=0.0) -> int:
    """The engine on ``arch``'s smoke config in f32, on the card (kernels)
    and on the CPU (plain versions): same tokens, ledgers within 1e-5 (the
    signal channels also within ``sig_atol``) -> the number of requests."""
    import numpy as np

    from repro_torch.core.history import HistoryConfig
    from repro_torch.data import DataConfig, SyntheticLMStream
    from repro_torch.models import model as Mdl
    from repro_torch.models.params import materialize, tree_map
    from repro_torch.serving import Engine, OutcomeRecorder

    cfg = _smoke_f32(arch)
    stream = SyntheticLMStream(DataConfig(4, 22, cfg.vocab_size, seed=5))
    weights = materialize(Mdl.param_specs(cfg), 0, torch.float32, "cpu")
    results = []
    for device in ("cuda", "cpu"):
        params = tree_map(lambda _, x: x.to(device), weights)
        rec = OutcomeRecorder(4, 6, cfg.vocab_size, HistoryConfig(1 << 12),
                              ledger="device", retention="topk", topk=16,
                              device=device)
        eng = Engine(cfg, params, rec, slots=4, max_prompt=16, max_gen=6,
                     page_size=page_size)
        for w in range(2):
            raw = stream.batch(w)
            for r in range(4):
                toks = raw["tokens"][r]
                plen = 16 - 3 * (r % 2)  # exact-length families: two lengths
                eng.submit(toks[:plen], 6, toks[16:22],
                           int(raw["instance_id"][r]))
        eng.run()
        results.append((eng.finished, eng.ledger_state_dict()))
    (fa, la), (fb, lb) = results
    if fa.keys() != fb.keys() or any(
            not np.array_equal(fa[i], fb[i]) for i in fa):
        raise AssertionError(f"{arch}: card and CPU engines generated "
                             "different tokens")
    for key in la:
        np.testing.assert_allclose(la[key], lb[key], rtol=1e-5,
                                   atol=sig_atol if key == "sig" else 0.0,
                                   err_msg=f"{arch} {key}")
    return len(fa)


def reference_phase(torch) -> str:
    """The smoke config in f32 through the card's kernels and through the
    CPU's plain versions: same tokens, ledgers within 1e-5; then the same
    for two train steps."""
    n = engine_reference(torch, "llama3-8b", 4)
    return (f"serve: {n} requests, tokens equal, ledgers within rtol "
            f"1e-5; train: {train_reference(torch)}")


def hybrid_reference_phase(torch, ops) -> str:
    """The mamba2 and zamba2 smoke configs in f32: prefill of 37 tokens
    (three scan chunks of 16, the last one short) and 6 greedy decode
    steps, on the card through the kernels and on the CPU through the plain
    versions: equal tokens, logits within REF_LOGIT_TOL; then the engine on
    zamba2's smoke config, card against CPU."""
    from repro_torch.models import model as Mdl
    from repro_torch.models.params import materialize, tree_map

    lines = []
    for arch, kernels in (("mamba2-370m", ("ssd",)),
                          ("zamba2-2.7b", ("ssd", "decode_attn"))):
        cfg = _smoke_f32(arch)
        weights = materialize(Mdl.param_specs(cfg), 0, torch.float32, "cpu")
        toks = torch.randint(0, cfg.vocab_size, (3, 37), dtype=torch.int32,
                             generator=torch.Generator().manual_seed(6))
        runs = []
        for device in ("cuda", "cpu"):
            ops.reset_launches()
            params = tree_map(lambda _, x: x.to(device), weights)
            logits, cache = Mdl.prefill(params, cfg, toks.to(device), 44)
            pos = torch.full((3,), 37, dtype=torch.int32, device=device)
            seq, lgs = [], [logits.cpu()]
            for _ in range(6):
                nxt = Mdl.greedy_token(cfg, logits)[:, None]
                seq.append(nxt.cpu())
                logits, cache = Mdl.decode_step(params, cfg, cache, nxt, pos)
                lgs.append(logits.cpu())
                pos = pos + 1
            runs.append((torch.cat(seq, 1), torch.stack(lgs),
                         dict(ops.LAUNCHES)))
        (ta, la, ka), (tb, lb, kb) = runs
        if min(ka[k] for k in kernels) <= 0 or any(kb.values()):
            raise AssertionError(f"{arch}: kernels {ka} on the card, {kb} on "
                                 f"the CPU")
        if not torch.equal(ta, tb):
            raise AssertionError(f"{arch}: card and CPU tokens differ")
        err = (la - lb).abs().max().item()
        if err > REF_LOGIT_TOL:
            raise AssertionError(f"{arch}: logits differ by {err}")
        lines.append(f"{arch} tokens equal, logits max abs diff {err:.3g}")
    n = engine_reference(torch, "zamba2-2.7b", None)
    return "; ".join(lines) + (f"; zamba2 engine: {n} requests, tokens "
                               f"equal, ledgers within rtol 1e-5")


class SharedDraws:
    """Selection draws made on the host from one seed and moved to the
    device, so the card's and the CPU's steps select with equal numbers."""

    def __init__(self, torch, device, seed):
        self.torch, self.device = torch, device
        self.g = torch.Generator().manual_seed(seed)

    def permutation(self, n):
        return self.torch.randperm(n, generator=self.g).to(self.device)

    def gumbel(self, n):
        e = self.torch.empty(n).exponential_(generator=self.g)
        return (-self.torch.log(e)).to(self.device)

    def normal(self):
        return self.torch.randn((), generator=self.g).to(self.device)


def train_reference(torch, arch: str = "llama3-8b",
                    resync: bool = False) -> str:
    """Two OBFTF steps (selection forward, obftf with a noisy target,
    AdamW), each followed by the ledger write of the fresh losses, on the
    arch's smoke config in f32 (rows of 24 tokens: two chunks, 16 and 8, of
    the ssm and hybrid smoke configs' scan): on the card (xent, ledger and,
    for the ssm and hybrid families, ssd and ssd_bwd kernels) and on the
    CPU (plain versions), with the same weights, batches and draws; then
    one step's parameter gradients on both (the hybrid's shared attention
    block's leaves named with their share of the tolerance).

    With ``resync`` the card's second step starts from the CPU's state
    after the first (each device keeps its own ledger), so each step is
    held to ``REF_TRAIN_RTOL`` on equal inputs: a config whose first AdamW
    update turns f32 rounding into larger weight differences (AdamW's
    first update is about lr times the grad's sign wherever |grad| is far
    above its eps) is checked step by step. The card's own chained second
    step, and on the CPU the same two steps from weights perturbed by
    1e-7 relative, are then reported beside it, not gated."""
    import dataclasses

    import numpy as np

    from repro_torch import configs
    from repro_torch.core import device_ledger as dledger
    from repro_torch.core.history import HistoryConfig
    from repro_torch.core.obftf import (OBFTFConfig, loss_and_grads,
                                        make_train_step, model_inputs)
    from repro_torch.core.selection import SelectionConfig
    from repro_torch.data import DataConfig, SyntheticLMStream
    from repro_torch.kernels import ops
    from repro_torch.launch.train import build_optimizer
    from repro_torch.models import model as Mdl
    from repro_torch.models.params import materialize, tree_leaves, tree_map

    cfg = dataclasses.replace(configs.get_smoke(arch),
                              param_dtype="float32", compute_dtype="float32")
    stream = SyntheticLMStream(DataConfig(16, 24, cfg.vocab_size, seed=3))
    weights = materialize(Mdl.param_specs(cfg), 0, torch.float32, "cpu")
    lcfg = HistoryConfig(capacity=1 << 12)
    runs, grads, cpu_states = {}, {}, []

    def two_steps(device, start, states=None, restart=None):
        """The two steps on ``device`` from the params ``start``; with
        ``restart`` the second step starts from that state instead."""
        opt = build_optimizer(1e-3, 2)
        step_fn = make_train_step(Mdl.loss_fn(cfg), opt, OBFTFConfig(
            SelectionConfig(method="obftf", ratio=0.25)))
        params = tree_map(lambda _, x: x.to(device), start)
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32, device=device)}
        led = dledger.init_state(lcfg, device)
        draws = SharedDraws(torch, device, 7)
        out = []
        for step in range(2):
            if step and restart is not None:
                state = tree_map(lambda _, x: x.to(device), restart)
            raw = stream.batch(step)
            batch = {k: torch.from_numpy(raw[k]).to(device)
                     for k in ("tokens", "labels")}
            state, m = step_fn(state, batch, draws)
            if states is not None:
                states.append(tree_map(lambda _, x: x.detach().clone(),
                                       state))
            ids = torch.from_numpy(raw["instance_id"].astype(np.int32))
            led, pri = dledger.record_priority(
                lcfg, led, ids.to(device), m["per_example_loss"],
                state["step"], valid=m["per_example_fresh"])
            out.append({k: m[k].cpu().numpy() for k in
                        ("per_example_loss", "selected", "loss")})
            out[-1]["priority"] = pri.cpu().numpy()
        return out, dledger.state_dict_of(led)

    for device in (("cpu", "cuda") if resync else ("cuda", "cpu")):
        ops.reset_launches()
        raw = stream.batch(7)
        params = tree_map(lambda _, x: x.to(device), weights)
        _, g = loss_and_grads(Mdl.loss_fn(cfg), params, model_inputs(
            {k: torch.from_numpy(raw[k]).to(device)
             for k in ("tokens", "labels")}))
        grads[device] = tree_map(lambda _, x: x.detach().cpu(), g)
        runs[device] = two_steps(
            device, weights, cpu_states if device == "cpu" else None,
            cpu_states[0] if resync and device == "cuda" else None)
        if device == "cuda" and cfg.family in ("ssm", "hybrid") and min(
                ops.LAUNCHES[k] for k in ("ssd", "ssd_bwd")) <= 0:
            raise AssertionError(f"{arch} on the card skipped a scan "
                                 f"kernel: {ops.LAUNCHES}")
    chained = ""
    if resync:
        def second_step_rel(out):
            a = out[1]["per_example_loss"]
            b = runs["cpu"][0][1]["per_example_loss"]
            return float(np.max(np.abs(a - b) / np.abs(b)))

        gen = torch.Generator().manual_seed(1)
        nudged = tree_map(lambda _, x: x * (1 + 1e-7 * torch.randn(
            x.shape, generator=gen)), weights)
        chained = (f"; not gated: the card's own chained second step "
                   f"{second_step_rel(two_steps('cuda', weights)[0]):.3g} "
                   f"max relative loss difference, the CPU's from weights "
                   f"perturbed by 1e-7 relative "
                   f"{second_step_rel(two_steps('cpu', nudged)[0]):.3g}")
    grads = [grads["cuda"], grads["cpu"]]
    runs = [runs["cuda"], runs["cpu"]]
    (ca, la), (cb, lb) = runs
    for sa, sb in zip(ca, cb):
        if not np.array_equal(sa["selected"], sb["selected"]):
            raise AssertionError("card and CPU train steps kept other rows")
        for k in ("per_example_loss", "loss", "priority"):
            np.testing.assert_allclose(sa[k], sb[k], rtol=REF_TRAIN_RTOL,
                                       err_msg=k)
    for key in la:
        np.testing.assert_allclose(la[key], lb[key], rtol=REF_TRAIN_RTOL,
                                   err_msg=key)
    worst, shared = 0.0, {}
    for (name, gc), gh in zip(_named_leaves(grads[0]),
                              tree_leaves(grads[1])):
        lim = REF_GRAD_ATOL * gh.abs().max() + REF_GRAD_RTOL * gh.abs()
        diff = (gc - gh).abs()
        if not (diff <= lim).all():
            raise AssertionError(f"{arch} grad {name}: card and CPU differ "
                                 f"by {diff.max().item()}")
        used = (diff / lim.clamp_min(1e-30)).max().item()
        worst = max(worst, used)
        if name[0] == "shared_attn":
            shared["/".join(name[1:])] = used
    if cfg.family in ("ssm", "hybrid"):  # reached through the scan alone
        ssm = grads[0]["blocks"]["ssm"]
        for k in ("a_log", "dt_bias", "conv_w"):
            if not ssm[k].abs().max() > 0:
                raise AssertionError(f"{arch}: no gradient reached {k}")
    if cfg.family == "hybrid" and (len(shared) < 9 or not all(
            grads[0]["shared_attn"]["attn"][k].abs().max() > 0
            for k in ("wq", "wk", "wv", "wo"))):
        raise AssertionError(f"{arch}: shared block grads {shared}")
    names = (f"; shared block leaves (share of the tolerance): "
             + ", ".join(f"{k} {v:.2f}" for k, v in shared.items())
             if shared else "")
    how = ", the second from equal states" if resync else ""
    return (f"{arch}: 2 steps{how}, kept rows equal "
            f"{[s['selected'].tolist() for s in ca]}, losses, priorities and "
            f"ledgers within rtol {REF_TRAIN_RTOL}; one step's grads within "
            f"{REF_GRAD_ATOL}·max + {REF_GRAD_RTOL}·|cpu| (at most "
            f"{worst:.2f} of it){names}{chained}")


def _named_leaves(tree):
    """(path, tensor) of a params tree, in ``tree_leaves``' order."""
    from repro_torch.models.params import tree_map

    out = []
    tree_map(lambda path, x: out.append((path, x)), tree)
    return out


def xent_case(torch, t, v, dtype, seed):
    """Logits [t, v] in ``dtype`` (normal × 4), labels with every third -1
    and a row of ±1e4 logits, cotangent g."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((t, v), device="cuda", generator=g) * 4
    labels = torch.randint(0, v, (t,), device="cuda", generator=g,
                           dtype=torch.int32)
    labels[1::3] = -1
    x[0] = torch.where(torch.arange(v, device="cuda") % 2 == 0, 1e4, -1e4)
    x[0, v // 3] = 5e3
    labels[0] = v // 3
    cot = torch.randn((t,), device="cuda", generator=g)
    return x.to(dtype), labels, cot


def _grad_check(torch, got, want, what) -> float:
    """Every entry within XENT_BWD_RTOL of the plain one -> max abs error."""
    rtol, tiny = XENT_BWD_RTOL[str(want.dtype)], torch.finfo(want.dtype).tiny
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    bad = diff > rtol * want.abs() + tiny
    if bad.any():
        i = int(bad.flatten().nonzero()[0])
        raise AssertionError(f"{what}: {int(bad.sum())} entries out of "
                             f"tolerance, first at {i}: "
                             f"{got.flatten()[i].item()} vs "
                             f"{want.flatten()[i].item()}")
    return diff.max().item()


def xent_check(torch, ops, ref, case) -> tuple[float, float]:
    """Forward and backward against the plain versions -> max abs errors;
    the ±1e4 row's gradient also against its closed form."""
    x, labels, cot = case
    loss, lse = ops.xent_fwd(x, labels, impl="cuda")
    rl, rlse = ref.xent_ref(x, labels)
    ferr = 0.0
    for got, want, name in ((loss, rl, "loss"), (lse, rlse, "lse")):
        diff = (got - want).abs()
        if (diff > XENT_ATOL + XENT_RTOL * want.abs()).any():
            raise AssertionError(f"xent_fwd {name} {tuple(x.shape)} "
                                 f"{x.dtype}: err {diff.max().item()}")
        ferr = max(ferr, diff.max().item())
    if not torch.equal(loss[labels < 0], lse[labels < 0]):
        raise AssertionError("xent_fwd: a -1 label picked a logit")
    grad = ops.xent_bwd(x, labels, rlse, cot, impl="cuda")
    if grad.dtype != x.dtype:
        raise AssertionError(f"xent_bwd gave {grad.dtype} for {x.dtype}")
    what = f"xent_bwd {tuple(x.shape)} {x.dtype}"
    berr = _grad_check(torch, grad, ref.xent_grad_ref(x, labels, rlse, cot),
                       what)
    # row 0: exp(max - lse) g (g/n up to the lse's f32 rounding) on its n
    # largest logits, -g at the label (5e3 below them), 0 elsewhere
    top = x[0] == x[0].max()
    closed = torch.where(top, torch.exp(x[0].max().float() - rlse[0]) * cot[0],
                         0.0)
    closed[labels[0].long()] = -cot[0]
    _grad_check(torch, grad[0], closed.to(x.dtype), what + " ±1e4 row")
    return ferr, berr


# the other train paths' (T, V, dtype): qwen3-14b's selection forward and
# kept rows, granite-34b's kept rows, Table 3's smoke llama (its full
# arm's bf16 logits and per_example_signals' f32 ones) and mixtral-8x22b's
# selection forward and kept rows; deepseek-v2-236b's and pixtral-12b's
# selection forward and kept rows, musicgen-medium's kept rows (recycled)
XENT_ARCH_CASES = ((4096, 151936, "bfloat16"), (1024, 151936, "bfloat16"),
                   (1024, 49152, "bfloat16"), (2048, 256, "bfloat16"),
                   (512, 256, "float32"), (4096, 32768, "bfloat16"),
                   (1024, 32768, "bfloat16"), (4096, 102400, "bfloat16"),
                   (1024, 102400, "bfloat16"), (4096, 131072, "bfloat16"),
                   (1024, 131072, "bfloat16"), (1024, 2048, "bfloat16"))


def xent_phases(torch, ops, ref) -> list[dict]:
    """Both cross-entropy kernels at the train path's shapes: the
    selection forward (T = 4096) and the kept rows (T = 1024), V = 128256,
    bf16; also an f32 case, V = 128257 (rows not 16-byte aligned) and
    ``XENT_ARCH_CASES``."""
    v = 128256
    cases = {t: xent_case(torch, t, v, torch.bfloat16, t) for t in (4096,
                                                                  1024)}
    ferr = berr = 0.0
    for case in (*cases.values(), xent_case(torch, 64, v, torch.float32, 1),
                 xent_case(torch, 7, v + 1, torch.bfloat16, 2)):
        f, b = xent_check(torch, ops, ref, case)
        ferr, berr = max(ferr, f), max(berr, b)
    for t, va, dt in XENT_ARCH_CASES:
        f, b = xent_check(torch, ops, ref, xent_case(
            torch, t, va, getattr(torch, dt), t + va))
        ferr, berr = max(ferr, f), max(berr, b)
    fwd = {}
    for t, (x, labels, _) in cases.items():
        fwd[t] = dict(
            ms=time_ms(lambda: ops.xent_fwd(x, labels, impl="cuda")),
            plain_ms=time_ms(lambda: ref.xent_ref(x, labels)),
            library_ms=time_ms(lambda: (
                torch.logsumexp(x, dim=-1),
                x.gather(1, labels.long().clamp(min=0)[:, None]))),
            bound=bound(t * v * 2 + t * 12, 4.0 * t * v, "f32"),
        )
    x, labels, cot = cases[1024]
    _, lse = ref.xent_ref(x, labels)
    onehot_rows = torch.arange(1024, device="cuda")

    def library_bwd():
        p = torch.softmax(x, dim=-1)
        p[onehot_rows, labels.long().clamp(min=0)] -= 1.0
        return p * cot[:, None].to(p.dtype)

    t = 4096
    rows = [dict(
        name="xent_fwd", route="cuda",
        source="src/repro_torch/kernels/csrc/xent.cu",
        replaces="src/repro/kernels/xent.py:88", max_abs_err=ferr,
        ms=fwd[t]["ms"], plain_ms=fwd[t]["plain_ms"],
        bound_ms=fwd[t]["bound"][0], bound_by=fwd[t]["bound"][1],
        library_ms=fwd[t]["library_ms"],
        tol=f"{XENT_ATOL} + {XENT_RTOL}·|plain|",
        shape=(f"T=4096 V={v} bf16; at T=1024: {fwd[1024]['ms']:.4f} ms, "
               f"plain {fwd[1024]['plain_ms']:.4f}, library "
               f"{fwd[1024]['library_ms']:.4f}, bound "
               f"{fwd[1024]['bound'][0]:.5f}; checked also at (T, V) "
               + ", ".join(f"({t_}, {v_}) {d_}"
                           for t_, v_, d_ in XENT_ARCH_CASES)),
    ), dict(
        name="xent_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/xent.cu",
        replaces="src/repro/kernels/xent.py:132", max_abs_err=berr,
        ms=time_ms(lambda: ops.xent_bwd(x, labels, lse, cot, impl="cuda")),
        plain_ms=time_ms(lambda: ref.xent_grad_ref(x, labels, lse, cot)),
        library_ms=time_ms(library_bwd),
        tol=f"{XENT_BWD_RTOL['torch.bfloat16']}·|plain| per entry",
        shape=(f"T=1024 V={v} bf16; checked also at the forward's other "
               f"shapes"),
    )]
    rows[1]["bound_ms"], rows[1]["bound_by"] = bound(
        2 * 1024 * v * 2 + 1024 * 12, 4.0 * 1024 * v, "f32")
    return rows


def ledger_batch(torch, cap, b, seed):
    """(ids, losses, valid) on the card: ids in [0, 2b) (duplicates), a
    quarter masked, and two ids of one slot last, the later evicting the
    earlier."""
    import numpy as np

    from repro_torch.core.history import slot_for

    g = torch.Generator(device="cuda").manual_seed(seed)
    ids = torch.randint(0, 2 * b, (b,), device="cuda", generator=g,
                        dtype=torch.int32)
    start = 10**6 + 17 * seed
    cand = np.arange(start, start + 64 * cap)  # about 64 ids per slot
    slots = slot_for(cand, cap)
    pair = cand[slots == slots[0]][:2]
    ids[-2:] = torch.from_numpy(pair.astype(np.int32)).cuda()
    losses = torch.randn((b,), device="cuda", generator=g) + 2.0
    valid = torch.rand((b,), device="cuda", generator=g) > 0.25
    valid[-2:] = True
    return ids, losses, valid


# the ledger's capacities: HistoryConfig's 65536, and 2^18, the per-shard
# ceiling of the JAX kernel's docstring; (capacity, batch) checked against
# the plain version; batch sizes timed at each capacity, from the train
# path's 32 up
LEDGER_CAPS = (65536, 1 << 18)
LEDGER_CHECKS = ((65536, 32), (65536, 512), (1 << 18, 32), (1 << 18, 32768))
LEDGER_SWEEP = (32, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768)
LEDGER_PROFILED = 100  # calls the profiler records at B = 32


def ledger_span_ms(torch, fn, n: int = 20) -> float:
    """Median device span of one ledger transaction: CUDA events recorded
    just before and just after the call, so the launch's own latency
    counts. The calls queue behind a sleep kernel, so the host's launch
    cost stays out, as it does on the train path, where the host runs ahead
    of the card."""
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    torch.cuda._sleep(20_000_000)
    for a, b in events:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    spans = sorted(a.elapsed_time(b) for a, b in events)
    return spans[n // 2]


def ledger_host_ms(torch, fn, n: int = 200) -> float:
    """Host wall time of one call, ``n`` calls queued behind a sleep kernel
    so the card never makes the host wait: the wrapper's host cost alone."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    return host


def ledger_bound(cap: int, b: int) -> tuple[float, str]:
    """The four arrays read and written once, the batch's ids, losses,
    valid bytes and priorities, and the step."""
    return bound(2 * cap * 16 + b * (4 + 4 + 1 + 4) + 4, 0.0, "f32")


def ledger_phase(torch, ops, ref) -> tuple[dict, str]:
    """The ledger kernel against its plain version at each of
    LEDGER_CHECKS, both variant names forced (they take the same launch),
    five chained transactions each; timed at B = 32, the train path's
    batch, at both capacities (eager, device span, the wrapper's host cost,
    the kernel's device time by the profiler); then the device span over
    LEDGER_SWEEP at both capacities, each beside its bound."""
    from repro_torch.core.history import HistoryConfig
    from repro_torch.kernels.ledger import tile_plan

    cfg = HistoryConfig()
    kw = dict(decay=cfg.decay, unseen_priority=cfg.unseen_priority,
              staleness_half_life=cfg.staleness_half_life)

    def table(cap):
        return (torch.zeros(cap, device="cuda"),
                torch.zeros(cap, dtype=torch.int32, device="cuda"),
                torch.full((cap,), -1, dtype=torch.int32, device="cuda"),
                torch.full((cap,), -1, dtype=torch.int32, device="cuda"))

    err = 0.0
    states = {}
    for cap, b in LEDGER_CHECKS:
        for variant in ("fori", "block"):
            st_k, st_r = table(cap), table(cap)
            for s in range(5):
                ids, losses, valid = ledger_batch(torch, cap, b, 100 * b + s)
                step = torch.full((), 3 * s, dtype=torch.int32, device="cuda")
                out_k = ops.ledger_record_priority(
                    *st_k, ids, losses, step, valid=valid, impl="cuda",
                    variant=variant, **kw)
                out_r = ops.ledger_record_priority(
                    *st_r, ids, losses, step, valid=valid, impl="ref", **kw)
                what = f"capacity {cap} B={b} ({variant}), transaction {s}"
                for name, got, want in zip(("count", "last_seen", "owner"),
                                           out_k[1:4], out_r[1:4]):
                    if not torch.equal(got, want):
                        raise AssertionError(f"ledger {name} differs at "
                                             f"{what}")
                for name, got, want in (("ema", out_k[0], out_r[0]),
                                        ("priority", out_k[4], out_r[4])):
                    rel = ((got - want).abs()
                           / want.abs().clamp(min=1e-30)).max()
                    if rel.item() > LEDGER_RTOL:
                        raise AssertionError(
                            f"ledger {name} at {what}: rel err {rel.item()}")
                    err = max(err, (got - want).abs().max().item())
                if out_k[4][-2].item() != cfg.unseen_priority:
                    raise AssertionError(f"an id evicted in its batch read "
                                         f"as seen at {what}")
                st_k, st_r = out_k[:4], out_r[:4]
        states[cap] = st_k
    sweep, at32 = {}, {}
    step = torch.full((), 7, dtype=torch.int32, device="cuda")
    for cap in LEDGER_CAPS:
        for b in LEDGER_SWEEP:
            ids, losses, valid = ledger_batch(torch, cap, b, b)
            args = (*states[cap], ids, losses, step)

            def call(impl="cuda", args=args, valid=valid):
                return ops.ledger_record_priority(
                    *args, valid=valid, impl=impl, **kw)

            sweep[cap, b] = ledger_span_ms(torch, call)
            if b == 32:
                at32[cap] = dict(
                    ms=time_ms(call), host_ms=ledger_host_ms(torch, call),
                    plain_ms=time_ms(lambda call=call: call("ref")),
                    # (ms, launches seen of LEDGER_PROFILED): a long run,
                    # so the few launches a profiler run loses leave most
                    dev=next((v for k, v in kernel_ms(
                        torch, call, LEDGER_PROFILED).items()
                        if "ledger" in k), (None, 0)))
                if at32[cap]["dev"][1] == 0:
                    raise AssertionError(
                        f"the profiler saw none of the ledger kernel's "
                        f"launches at capacity {cap}")
    lines = []
    for cap in LEDGER_CAPS:
        pts = [f"B={b} {sweep[cap, b]:.4f} (bound "
               f"{ledger_bound(cap, b)[0]:.5f}, tiles "
               f"{tile_plan(cap, b)[0]})" for b in LEDGER_SWEEP]
        a = at32[cap]
        dev = f"{a['dev'][0]:.4f} ms"
        lines.append(
            f"ledger at capacity {cap}: device span per call in ms: "
            + "; ".join(pts) + f"; at B=32 eager {a['ms']:.4f} ms, host "
            f"{a['host_ms']:.4f} ms, kernel (profiler) {dev} "
            f"({a['dev'][1]} of {LEDGER_PROFILED} launches seen), plain "
            f"{a['plain_ms']:.4f} ms")
    cap, b = cfg.capacity, 32
    a = at32[cap]
    bnd, by = ledger_bound(cap, b)
    return dict(
        name="ledger_record_priority", route="cuda",
        source="src/repro_torch/kernels/csrc/ledger.cu",
        replaces="src/repro/kernels/ledger.py:268", max_abs_err=err,
        ms=a["ms"], plain_ms=a["plain_ms"], bound_ms=bnd, bound_by=by,
        library_ms=None, tol=LEDGER_RTOL, span_ms=sweep[cap, b],
        host_ms=a["host_ms"], dev_ms=a["dev"][0],
        shape=(f"capacity {cap}, B=32, device span {sweep[cap, b]:.4f} "
               f"ms/call, host {a['host_ms']:.4f} ms/call; checked at "
               f"(capacity, B) in {list(LEDGER_CHECKS)}, both variant "
               f"names; no single PyTorch call does this transaction"),
    ), "\n".join(lines)


# phase B: the sharded ledger's ops on four ranks that share the one card
# through gloo (NCCL refuses two ranks on one GPU); the tables live on the
# card, and the collectives stage through host memory
SHARD_WORLD, SHARD_CAP, SHARD_B, SHARD_STEPS = 4, 65536, 32, 5
SHARD_PLACEMENTS = {  # name -> (route, exchange, capacity_factor)
    "pinned": (False, "gather", 1.25),
    "gather": (True, "gather", 1.25),
    "a2a-4": (True, "a2a", 4.0),  # cap = B: no residual round to run
    "a2a-1.25": (True, "a2a", 1.25),
    "a2a-0.125": (True, "a2a", 0.125),
}
SHARD_STREAMS = ("balanced", "skewed")
SHARD_OPS = ("record", "lookup", "lookup_signals", "priority",
             "record_priority")
SHARD_FIELDS = ("rec_ids", "rec_loss", "rec_valid", "rec_sig", "read_ids",
                "rp_ids", "rp_loss", "rp_valid", "rp_sig")


def shard_home(ids):
    from repro_torch.core.history import slot_for

    return slot_for(ids, SHARD_CAP) // (SHARD_CAP // SHARD_WORLD)


def shard_stream(stream: str) -> list[dict]:
    """SHARD_STEPS global batches of SHARD_WORLD * SHARD_B items (rank r's
    segment at [r*B, (r+1)*B)): ``balanced`` gives every segment B/4 ids
    of each home rank, ``skewed`` homes every id to rank 1; ids come from a
    hot pool of 24 a home (repeats across steps) and a wide one (slot
    collisions), and each step repeats an id across ranks 0 and 1 and one
    inside rank 0."""
    import numpy as np

    w, b = SHARD_WORLD, SHARD_B
    ids = np.arange(1, 8 * SHARD_CAP, dtype=np.int64)
    home = shard_home(ids)
    rs = np.random.default_rng(11)
    hot, wide = [], []
    for h in range(w):
        mine = rs.permutation(ids[home == h])
        hot.append(mine[:24])
        wide.append(mine[24:24 + 3 * SHARD_CAP // w])
    rs = np.random.default_rng(12 + (stream == "skewed"))

    def ids_for(homes):
        pick = rs.random(homes.size) < 0.6
        return np.asarray([rs.choice(hot[h]) if p else rs.choice(wide[h])
                           for h, p in zip(homes, pick)], np.int64)

    def batch():
        homes = (np.concatenate([rs.permutation(np.repeat(np.arange(w),
                                                          b // w))
                                 for _ in range(w)])
                 if stream == "balanced" else np.ones(w * b, np.int64))
        out = ids_for(homes)
        out[b], out[5] = out[0], out[2]
        return out

    steps = []
    n = w * b
    for _ in range(SHARD_STEPS):
        rec = batch()
        read = rec.copy()
        fresh = rs.random(n) < 0.25
        read[fresh] = ids_for(rs.integers(0, w, int(fresh.sum())))
        steps.append(dict(
            rec_ids=rec, rec_loss=(rs.random(n) * 5).astype(np.float32),
            rec_valid=rs.random(n) < 0.75,
            rec_sig=rs.standard_normal((n, 2)).astype(np.float32),
            read_ids=rs.permutation(read), rp_ids=batch(),
            rp_loss=(rs.random(n) * 5).astype(np.float32),
            rp_valid=rs.random(n) < 0.75,
            rp_sig=rs.standard_normal((n, 2)).astype(np.float32)))
    return steps


def shard_overflow(ids, active, cap: int) -> int:
    """Items past ``cap`` rows a (sending rank, home), over the group."""
    import numpy as np

    n = 0
    for r in range(SHARD_WORLD):
        seg = slice(r * SHARD_B, (r + 1) * SHARD_B)
        counts = np.bincount(shard_home(ids[seg])[active[seg]],
                             minlength=SHARD_WORLD)
        n += int(np.maximum(counts - cap, 0).sum())
    return n


def _ledger_rank(rank: int, store: str, out_dir: str, src: str) -> None:
    """One rank of phase B: joins the gloo group, runs every op of every
    placement on both streams with its table slice on the card, and saves
    its answers, overflow counts, ledger kernel launches and op spans."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, src)
    from repro_torch.core.history import HistoryConfig
    from repro_torch.distributed.ledger import sharded_ledger_ops
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_elastic_mesh

    dist.init_process_group(
        "gloo", store=dist.FileStore(store, SHARD_WORLD), rank=rank,
        world_size=SHARD_WORLD, timeout=datetime.timedelta(seconds=120))
    mesh = make_elastic_mesh(device="cuda:0")
    seg = slice(rank * SHARD_B, (rank + 1) * SHARD_B)
    out = {}
    for stream in SHARD_STREAMS:
        steps = shard_stream(stream)
        for name, (route, exchange, cf) in SHARD_PLACEMENTS.items():
            led = sharded_ledger_ops(mesh, HistoryConfig(capacity=SHARD_CAP),
                                     route=route, exchange=exchange,
                                     capacity_factor=cf)
            st = led.init()
            key = f"{stream}/{name}"
            spans = {op: [] for op in SHARD_OPS}
            ops.reset_launches()
            for t, g in enumerate(steps, start=1):
                x = {k: torch.from_numpy(np.ascontiguousarray(
                    g[k][seg])).cuda() for k in SHARD_FIELDS}
                step = torch.full((), t, dtype=torch.int32, device="cuda")

                def timed(op, *a, **k):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = getattr(led, op)(*a, **k)
                    torch.cuda.synchronize()
                    spans[op].append((time.perf_counter() - t0) * 1e3)
                    return res

                st, s1 = timed("record", st, x["rec_ids"], x["rec_loss"],
                               step, x["rec_valid"], signals=x["rec_sig"],
                               return_stats=True)
                ema, seen = timed("lookup", st, x["read_ids"])
                e2, sig, seen2 = timed("lookup_signals", st, x["read_ids"])
                pri = timed("priority", st, x["read_ids"], step)
                st, pri2, s2 = timed(
                    "record_priority", st, x["rp_ids"], x["rp_loss"], step,
                    x["rp_valid"], signals=x["rp_sig"], return_stats=True)
                for k, v in dict(ema=ema, seen=seen, ema2=e2, sig=sig,
                                 seen2=seen2, pri=pri, pri2=pri2,
                                 ovf_rec=s1["a2a_overflow"],
                                 ovf_rp=s2["a2a_overflow"]).items():
                    out[f"{key}/{t}/{k}"] = v.cpu().numpy()
            out[f"{key}/launches"] = np.int64(
                ops.LAUNCHES["ledger_record_priority"])
            for op, ms in spans.items():
                out[f"{key}/span/{op}"] = np.asarray(ms)
            for k, v in led.state_dict(st).items():
                out[f"{key}/sd/{k}"] = np.asarray(v)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


def _shard_reference(torch, stream: str, route: bool, plain: bool):
    """The single tables on the card that phase B's tables must equal: the
    global table fed the global batch (``route``) or one table of C/4 slots
    a rank fed its segment. ``plain`` records ``record_priority`` as record
    then priority (the a2a path's write), else through the ledger kernel
    -> (per step the answers over the global batch, the export table)."""
    import numpy as np

    from repro_torch.core import device_ledger as dl
    from repro_torch.core.history import HistoryConfig

    w, b = SHARD_WORLD, SHARD_B
    parts = ([(HistoryConfig(capacity=SHARD_CAP), slice(0, w * b))] if route
             else [(HistoryConfig(capacity=SHARD_CAP // w),
                    slice(r * b, (r + 1) * b)) for r in range(w)])
    states = [dl.init_state(cfg, "cuda") for cfg, _ in parts]
    answers = []
    for t, g in enumerate(shard_stream(stream), start=1):
        per = []
        for j, (cfg, seg) in enumerate(parts):
            x = {k: torch.from_numpy(np.ascontiguousarray(g[k][seg])).cuda()
                 for k in SHARD_FIELDS}
            st = dl.record(cfg, states[j], x["rec_ids"], x["rec_loss"], t,
                           valid=x["rec_valid"], signals=x["rec_sig"])
            ema, seen = dl.lookup(st, x["read_ids"])
            e2, sig, seen2 = dl.lookup_signals(st, x["read_ids"])
            pri = dl.priority(cfg, st, x["read_ids"], t)
            if plain:
                st = dl.record(cfg, st, x["rp_ids"], x["rp_loss"], t,
                               valid=x["rp_valid"], signals=x["rp_sig"])
                pri2 = dl.priority(cfg, st, x["rp_ids"], t)
            else:
                st, pri2 = dl.record_priority(
                    cfg, st, x["rp_ids"], x["rp_loss"], t,
                    valid=x["rp_valid"], signals=x["rp_sig"])
            states[j] = st
            per.append({k: v.cpu().numpy() for k, v in dict(
                ema=ema, seen=seen, ema2=e2, sig=sig, seen2=seen2, pri=pri,
                pri2=pri2).items()})
        answers.append({k: np.concatenate([a[k] for a in per])
                        for k in per[0]})
    sds = [dl.state_dict_of(st) for st in states]
    return answers, {k: np.concatenate([sd[k] for sd in sds])
                     for k in sds[0]}


def sharded_ops_phase(torch, ops) -> tuple[dict, str]:
    """Phase B: four ranks on the card through gloo (``_ledger_rank``, one
    spawned process each, the kernels built once in this process before
    they start) run the five ops and ``record_priority`` for SHARD_STEPS
    steps under each of SHARD_PLACEMENTS on a balanced and a skewed stream.
    Gates: each routed table and every answer equal to the single card
    table fed the global batch (gather: through the ledger kernel, as the
    gather path's ``record_priority``; a2a: record then priority, as its
    write), the pinned table to four single tables, one a segment; the
    overflow count equal to the stream's items past capacity (above 0
    exactly where it is), the ledger kernel launched once a step on every
    rank on the pinned and gather paths and never under a2a -> (launches
    by path, lines)."""
    import multiprocessing as mp

    import numpy as np

    from repro_torch.distributed.ledger import (a2a_capacity,
                                                exchange_bytes_per_op)

    _free(torch)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_ledger_rank, args=(
            r, os.path.join(tmp, "store"), tmp, os.path.join(ROOT, "src")))
            for r in range(SHARD_WORLD)]
        for p in procs:
            p.start()
        refs = {(stream, route, plain): _shard_reference(torch, stream,
                                                         route, plain)
                for stream in SHARD_STREAMS
                for route, plain in ((False, False), (True, False),
                                     (True, True))}
        deadline = time.monotonic() + 300
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise AssertionError(f"phase B ranks exited with {codes}")
        ranks = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
                 for r in range(SHARD_WORLD)]
    lines, launches = [], {}
    for stream in SHARD_STREAMS:
        steps = shard_stream(stream)
        for name, (route, exchange, cf) in SHARD_PLACEMENTS.items():
            key = f"{stream}/{name}"
            a2a = route and exchange == "a2a"
            answers, sd = refs[stream, route, a2a]
            cap = a2a_capacity(SHARD_B, SHARD_WORLD, cf)
            ovf = []
            for t, g in enumerate(steps, start=1):
                for k, want in answers[t - 1].items():
                    got = np.concatenate([r[f"{key}/{t}/{k}"] for r in ranks])
                    if not np.array_equal(got, want):
                        raise AssertionError(f"phase B {key} step {t}: {k} "
                                             "differs from the single table")
                want = (shard_overflow(g["rec_ids"], g["rec_valid"], cap),
                        shard_overflow(g["rp_ids"],
                                       np.ones(g["rp_ids"].size, bool), cap)
                        ) if a2a else (0, 0)
                for r in ranks:
                    got = (int(r[f"{key}/{t}/ovf_rec"]),
                           int(r[f"{key}/{t}/ovf_rp"]))
                    if got != want:
                        raise AssertionError(f"phase B {key} step {t}: "
                                             f"overflow {got}, not {want}")
                ovf.append(sum(want))
            # balanced: 8 ids a (rank, home), past cap at cf < 1; skewed:
            # 32 to one home, past cap below cf = 4 (cap = B)
            past = a2a and cf < SHARD_WORLD and (cf < 1 or stream == "skewed")
            if (min(ovf) > 0) != past or (max(ovf) > 0) != past:
                raise AssertionError(f"phase B {key}: overflow {ovf}")
            for r in ranks:
                for k, v in sd.items():
                    if not np.array_equal(r[f"{key}/sd/{k}"], v):
                        raise AssertionError(f"phase B {key}: table {k} "
                                             "differs from the single one")
                if (f"{key}/sd/pinned_shards" in r) == route:
                    raise AssertionError(f"phase B {key}: pinned marker")
            n = [int(r[f"{key}/launches"]) for r in ranks]
            if n != [0 if a2a else SHARD_STEPS] * SHARD_WORLD:
                raise AssertionError(f"phase B {key}: ledger kernel "
                                     f"launches {n} a rank")
            launches[key] = sum(n)
            spans = "; ".join(
                f"{op} {_median(list(ranks[0][f'{key}/span/{op}'])):.3f}"
                for op in SHARD_OPS)
            # the port's exchange payload of one op on one rank, by the
            # analytic count (the residual round included wherever it runs)
            moved = (exchange_bytes_per_op(exchange, SHARD_WORLD, SHARD_B,
                                           cf) if route else 0)
            lines.append(f"sharded ops ({key}, 4 ranks, gloo on one card, "
                         f"capacity {SHARD_CAP}, B={SHARD_B} a rank): "
                         f"overflow a step {ovf}, ledger kernel launches a "
                         f"rank {n[0]}, exchange bytes an op a rank {moved}, "
                         f"op span ms (median of {SHARD_STEPS}, rank 0): "
                         f"{spans}")
    # the a2a table is the plain write's, the gather table the kernel's:
    # the integers agree exactly, the EMA to the kernel's tolerance
    for stream in SHARD_STREAMS:
        g, a = refs[stream, True, False][1], refs[stream, True, True][1]
        for k in ("count", "last_seen", "owner"):
            if not np.array_equal(g[k], a[k]):
                raise AssertionError(f"phase B {stream}: a2a {k} differs "
                                     "from gather's")
        rel = np.abs(g["ema"] - a["ema"]) / np.maximum(np.abs(a["ema"]),
                                                       1e-30)
        if rel.max() > LEDGER_RTOL:
            raise AssertionError(f"phase B {stream}: a2a EMA {rel.max()}")
    lines.append(f"sharded ops: {len(lines)} runs passed in "
                 f"{time.perf_counter() - t0:.1f} s")
    return launches, "\n".join(lines)


TRAIN_ARGV = [
    "--arch", "llama3-8b", "--layers", str(TRAIN_LAYERS),
    "--global-batch", "32", "--seq-len", "128", "--method", "obftf",
    "--ratio", "0.25", "--device", "cuda", "--log-every", "1",
]


def _free(torch):
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def train_run(torch, ops, argv, path) -> dict:
    from repro_torch.launch import train

    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    train.main(argv + ["--json-out", path])
    launches = dict(ops.LAUNCHES)
    with open(path) as f:
        s = json.load(f)
    s["launches"] = launches
    s["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    warm = sorted(s["step_ms"][1:])
    s["steady_ms"] = warm[len(warm) // 2]
    if s["guarded_steps"] != s["steps"] - 1:
        raise AssertionError(f"a warm train step ran unguarded: {s}")
    losses = [s["loss_first"], s["loss_last"], s["health"]["loss"]]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite train loss: {losses}")
    return s


def train_phase(torch, ops, tmp: str) -> tuple[dict, dict]:
    import numpy as np

    from repro_torch.core.history import HistoryConfig, LossHistory

    a = train_run(torch, ops, TRAIN_ARGV + ["--steps", "4"],
                  os.path.join(tmp, "train_a.json"))
    if a["launches"]["xent_fwd"] <= 0 or a["launches"]["xent_bwd"] <= 0:
        raise AssertionError(f"run (a) missed a kernel: {a['launches']}")
    if abs(a["mean_step_cost"] - 1.75) > 1e-6:
        raise AssertionError(f"run (a) step cost {a['mean_step_cost']}")
    ledger_path = os.path.join(tmp, "train_ledger.npz")
    b = train_run(torch, ops, TRAIN_ARGV + [
        "--steps", "6", "--recycle", "--ledger", "device",
        "--instance-pool", "64", "--ledger-out", ledger_path],
        os.path.join(tmp, "train_b.json"))
    if min(b["launches"][k] for k in ("xent_fwd", "xent_bwd",
                                      "ledger_record_priority")) <= 0:
        raise AssertionError(f"run (b) missed a kernel: {b['launches']}")
    if abs(b["mean_step_cost"] - 0.75) > 1e-6:
        raise AssertionError(f"run (b) step cost {b['mean_step_cost']}")
    hist = LossHistory(HistoryConfig())
    hist.load_state_dict(dict(np.load(ledger_path)))
    sd = hist.state_dict()
    live = sd["owner"] >= 0
    # 8 kept rows recorded per step, ids from the 64-id pool
    if (sd["count"][live].sum() != 6 * 8
            or not set(sd["owner"][live]) <= set(range(64))
            or not np.isfinite(sd["ema"][live]).all()):
        raise AssertionError("the ledger does not hold the kept rows")
    if b["ledger_hits_first"] != 0 or b["ledger_hits_mean"] <= 0:
        raise AssertionError(f"ledger hits {b['ledger_hits_first']}, "
                             f"{b['ledger_hits_mean']}")
    return a, b


def routed_train_phase(torch, ops, tmp: str, b: dict) -> dict:
    """Phase C: run (b) again with ``--ledger-route --ledger-exchange a2a``.
    On one rank the trainer keeps the single table, as the JAX trainer does
    on one device: the summary's keys are run (b)'s, ``exchange`` is "a2a"
    with the default capacity factor and ``a2a_overflow`` 0, the kernels
    launch as in (b), and the losses are (b)'s (within the card-against-CPU
    tolerance: two runs of one train step need not give the same bits)."""
    c = train_run(torch, ops, TRAIN_ARGV + [
        "--steps", "6", "--recycle", "--ledger", "device",
        "--instance-pool", "64", "--ledger-route", "--ledger-exchange",
        "a2a"], os.path.join(tmp, "train_c.json"))
    want = dict(exchange="a2a", capacity_factor=1.25, a2a_overflow=0)
    if set(c) != set(b) or {k: c[k] for k in want} != want:
        raise AssertionError(f"routed train summary: {c}")
    if c["launches"] != b["launches"]:
        raise AssertionError(f"routed train launches {c['launches']}, run "
                             f"(b) {b['launches']}")
    for k in ("mean_step_cost", "ledger_hits_first", "ledger_hits_mean"):
        if c[k] != b[k]:
            raise AssertionError(f"routed train {k} {c[k]}, run (b) {b[k]}")
    c["loss_rel"] = max(abs(c[k] - b[k]) / abs(b[k])
                        for k in ("loss_first", "loss_last"))
    if c["loss_rel"] > REF_TRAIN_RTOL:
        raise AssertionError(f"routed train losses {c['loss_first']}, "
                             f"{c['loss_last']}; run (b) {b['loss_first']}, "
                             f"{b['loss_last']}")
    return c


# phase D: the data-parallel step over a mesh of one NCCL rank, called
# directly (the train CLI passes no mesh on one rank, as the JAX one does),
# against the mesh-less step on the same inputs and draws
DP_D_STEPS = 3


def _dp_d_run(torch, mesh, profiled: bool = False) -> dict:
    """DP_D_STEPS steps of run (a)'s configuration (llama3-8b at full width,
    TRAIN_LAYERS deep, 32 rows of 128 tokens, obftf at 0.25, AdamW) through
    ``make_train_step(mesh=mesh)`` (None: the mesh-less step; over a mesh
    the params and moments take the FSDP and ZeRO-1 layout, whole on one
    rank, where every gather returns its input), each step's
    per-example losses then written through ``record_priority`` (over the
    mesh: the sharded ops, pinned); the warm steps under the sync guard ->
    each step's metrics and ms, the launches, the table, the peak memory,
    and with ``profiled`` one more step under torch.profiler."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.core import device_ledger as dledger
    from repro_torch.core.guard import no_host_sync
    from repro_torch.core.history import HistoryConfig
    from repro_torch.core.obftf import OBFTFConfig, make_train_step
    from repro_torch.core.selection import GeneratorNoise, SelectionConfig
    from repro_torch.data import DataConfig, SyntheticLMStream
    from repro_torch.distributed.ledger import sharded_ledger_ops
    from repro_torch.distributed.zero import data_layout
    from repro_torch.kernels import ops
    from repro_torch.launch.train import build_optimizer
    from repro_torch.models import model as Mdl
    from repro_torch.models.params import materialize

    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    cfg = configs.get("llama3-8b", layers=TRAIN_LAYERS)
    specs = Mdl.param_specs(cfg)
    layout = None if mesh is None else data_layout(specs, mesh, mesh.rank)
    opt = build_optimizer(1e-3, 100, layout)
    step_fn = make_train_step(Mdl.loss_fn(cfg), opt, OBFTFConfig(
        SelectionConfig(method="obftf", ratio=0.25)), mesh=mesh)
    params = materialize(specs, 0, torch.bfloat16, "cuda")
    if layout is not None:
        params = layout.hold(params)  # one rank: the same tensors
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    del params
    lcfg = HistoryConfig()
    led = None if mesh is None else sharded_ledger_ops(mesh, lcfg)
    lst = dledger.init_state(lcfg, "cuda") if led is None else led.init()
    stream = SyntheticLMStream(DataConfig(32, 128, cfg.vocab_size))
    noise = GeneratorNoise(torch.Generator("cuda").manual_seed(0))

    def step(i):
        nonlocal state, lst
        raw = stream.batch(i)
        batch = {k: torch.from_numpy(raw[k]).cuda() for k in ("tokens",
                                                              "labels")}
        ids = torch.from_numpy(raw["instance_id"].astype(np.int32)).cuda()
        with no_host_sync(i > 0):
            state, m = step_fn(state, batch, noise)
            fresh = m["per_example_fresh"]
            if led is None:
                lst, _ = dledger.record_priority(
                    lcfg, lst, ids, m["per_example_loss"], state["step"],
                    valid=fresh)
            else:
                lst, _ = led.record_priority(lst, ids, m["per_example_loss"],
                                             state["step"], fresh)
        return m

    ops.reset_launches()
    out = {"metrics": [], "step_ms": []}
    for i in range(DP_D_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(i)
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["metrics"].append({k: v.cpu().numpy() for k, v in m.items()})
    out["launches"] = dict(ops.LAUNCHES)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["sd"] = (dledger.state_dict_of(lst) if led is None
                 else led.state_dict(lst))
    if profiled:  # one step more, past the compared ones
        before = dict(ops.LAUNCHES)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(DP_D_STEPS)
            torch.cuda.synchronize()
        events = _averages(prof)
        out["nccl_events"] = sum(e.count for e in events
                                 if "nccl" in e.key.lower())
        out["nccl_kernels"] = sum(
            e.count for e in events if "nccl" in e.key.lower()
            and e.device_type == torch.autograd.DeviceType.CUDA)
        out["seen"] = _seen(torch, prof, {k: v - before[k]
                                          for k, v in ops.LAUNCHES.items()})
        out["profile"] = _profile_summary(torch, prof, 1)
        out["groups"] = _kernel_groups(torch, prof, 1)
    del state, lst
    _free(torch)
    return out


def dp_step_phase(torch, ops) -> tuple[dict, str]:
    """Phase D: ``make_train_step(mesh=)`` over an NCCL group of one against
    the mesh-less step, from the same weights, batches and draws. Gates: on
    every step the kept rows, ``kept`` and the step cost equal, the
    per-example losses, the loss and ``grad_norm`` within REF_TRAIN_RTOL;
    the ledger tables' integers equal and their EMAs within REF_TRAIN_RTOL;
    the xent and ledger kernels launched on both; the warm steps under the
    sync guard (a host sync raises); a profiled step shows NCCL events and
    the xent and ledger kernels -> (the mesh run's launches, the line)."""
    import numpy as np

    from repro_torch.launch.mesh import make_elastic_mesh

    t0 = time.perf_counter()
    plain = _dp_d_run(torch, None)
    mesh = make_elastic_mesh(device="cuda")
    if (mesh.backend, mesh.size) != ("nccl", 1):
        raise AssertionError(f"phase D mesh {mesh.backend} x {mesh.size}")
    dp = _dp_d_run(torch, mesh, profiled=True)
    mesh.close()
    for i, (a, b) in enumerate(zip(dp["metrics"], plain["metrics"])):
        for k in ("selected", "kept", "step_cost", "per_example_fresh"):
            if not np.array_equal(a[k], b[k]):
                raise AssertionError(f"phase D step {i}: {k} {a[k]} differs "
                                     f"from the mesh-less step's {b[k]}")
        for k in ("per_example_loss", "loss", "grad_norm"):
            rel = np.max(np.abs(a[k] - b[k]) / np.abs(b[k]))
            if not rel <= REF_TRAIN_RTOL:
                raise AssertionError(f"phase D step {i}: {k} {a[k]} against "
                                     f"{b[k]} (relative {rel})")
    for k, v in plain["sd"].items():
        got = dp["sd"][k]
        same = (np.array_equal(got, v) if k != "ema" else np.allclose(
            got, v, rtol=REF_TRAIN_RTOL, atol=0))
        if not same:
            raise AssertionError(f"phase D: ledger {k} differs")
    for run in (plain, dp):
        if min(run["launches"][k] for k in ("xent_fwd", "xent_bwd",
                                            "ledger_record_priority")) <= 0:
            raise AssertionError(f"phase D missed a kernel: {run['launches']}")
    if dp["nccl_events"] <= 0:
        raise AssertionError("phase D: the profile shows no NCCL event")
    seen = dp["seen"]
    for k in ("xent_fwd", "xent_bwd", "ledger_record_priority"):
        if f"{k} 0 for" in seen:
            raise AssertionError(f"phase D: the profile missed {k}: {seen}")
    device_ms, launches, tops = dp["profile"]
    warm = lambda r: sorted(r["step_ms"][1:])[len(r["step_ms"][1:]) // 2]
    m0 = dp["metrics"]
    line = (f"dp step (D): llama3-8b {TRAIN_LAYERS} layers bf16, 32 x 128, "
            f"make_train_step(mesh=) over one NCCL rank (FSDP "
            f"params, ZeRO-1 moments, whole on one rank) against the "
            f"mesh-less step, {DP_D_STEPS} "
            f"steps: kept {[int(m['kept']) for m in m0]}, losses "
            f"{[round(float(m['loss']), 4) for m in m0]}, grad_norm "
            f"{[round(float(m['grad_norm']), 4) for m in m0]} equal within "
            f"{REF_TRAIN_RTOL}; step ms (host, synchronized) first "
            f"{dp['step_ms'][0]:.1f}, warm {warm(dp):.1f} (mesh-less "
            f"{warm(plain):.1f}); peak {dp['peak_gib']:.1f} GiB (mesh-less "
            f"{plain['peak_gib']:.1f}); sync guard on "
            f"{DP_D_STEPS - 1} warm steps; profiled step: device busy "
            f"{device_ms:.1f} ms, {launches:.0f} kernel launches, NCCL events "
            f"{dp['nccl_events']} (device kernels {dp['nccl_kernels']}), "
            f"device ms by kind: {dp['groups']}; top: {tops}; kernel "
            f"launches the profiler saw: {seen}; launches {dp['launches']}; "
            f"phase D {time.perf_counter() - t0:.1f} s")
    return dp["launches"], line


# phase E: four spawned ranks sharing the one card through gloo (NCCL
# refuses two ranks on one GPU), each calling the train CLI with
# --model-parallel 1: mamba2-370m at full width and depth (48 layers,
# d_model 1024, 50,280 tokens), rows of 512, a global batch of 32 (8 a
# rank). llama3-8b does not fit four times on one card (8 layers peak at
# 50.8 GiB on one rank)
DP_E_WORLD = 4
DP_E_ARGV = ["--arch", "mamba2-370m", "--global-batch", "32", "--seq-len",
             "512", "--steps", "3", "--device", "cuda", "--log-every", "1"]
DP_E_RUNS = {  # name -> (extra flags, step cost, kept rows of 32, f32)
    # (a) and the (c) runs take two steps: the second loss is the first one
    # an update moved (AdamW's first step runs at the full rate), and the
    # gates need no third; (b) three, so its third step recycles rows
    "a": (["--method", "obftf", "--ratio", "0.25", "--steps", "2"], 1.75, 8,
          False),
    "b": (["--recycle", "--ledger", "device", "--instance-pool", "64",
           "--ledger-route", "--ledger-exchange", "gather"], 0.75, 8, False),
    # dense data-parallel against one rank: (c) in bf16, as the CLI runs,
    # within DP_BF16_RTOL; (c-f32) the same config in f32, within
    # REF_TRAIN_RTOL, where only the order of the sums differs
    "c": (["--method", "full", "--steps", "2"], 3.0, 32, False),
    "c-f32": (["--method", "full", "--steps", "2"], 3.0, 32, True),
}
# (c)'s losses against one rank's in bf16: each rank's grads round to bf16
# before the sum, one rank's once, so AdamW's sign-like steps differ where
# a grad is near 0. For mamba2-370m's smoke config on the CPU (the train
# CLI, 32 rows of 24, two steps) one and four ranks read 4.9e-5 apart at
# the second loss with the params FSDP-placed (5.2e-6 with them replicated
# and the grads all-reduced), and four ranks whose reduce-scatter keeps
# each rank's own grads unsummed 6.8e-4 (replicated, skipping the
# all-reduce: 3.4e-4). A fault of the grads' scale shows in neither: AdamW
# and the clip cancel it (tests/test_torch_dp_train.py holds the scale
# with SGD)
DP_BF16_RTOL = 2e-4
DP_E_KERNELS = ("xent_fwd", "xent_bwd", "ssd", "ssd_bwd")
# the peak a rank of phase E in bf16 with the params replicated and the
# grads all-reduced (PERF.md section 5), which the FSDP-placed runs are
# printed against
DP_E_REPLICATED_PEAK_GIB = 7.11
# the int8 checks after the CLI runs, on mamba2-370m's in_proj stack
# ([48, 1024, 4384] bf16, each rank a quarter of the 1024): its first
# INT8_E_LAYERS layers gathered plain and int8 through
# param_gather_constraint (timed), the first and the last of them checked
# and one layer's backward; the ring on one layer's grad-sized f32 term a
# rank, INT8_E_REPS times
INT8_E_LAYERS, INT8_E_REPS = 12, 5


@contextlib.contextmanager
def f32_configs(on: bool = True):
    """``repro_torch.configs.get`` giving f32 params and compute while
    inside (the train CLI has no dtype flag, as the JAX one has none)."""
    from repro_torch import configs

    get = configs.get
    if on:
        configs.get = lambda *a, **k: dataclasses.replace(
            get(*a, **k), param_dtype="float32", compute_dtype="float32")
    try:
        yield
    finally:
        configs.get = get


def _param_digest(torch, params) -> "np.ndarray":
    """Two int64 sums a leaf over its bits (the plain sum and one weighted
    by position): equal digests on every rank say equal params."""
    import numpy as np

    from repro_torch.models.params import tree_leaves

    out = []
    for x in tree_leaves(params):
        bits = x.contiguous().view(torch.int16).reshape(-1).to(torch.int64)
        w = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
        out.append(torch.stack([bits.sum(), (bits * w).sum()]))
    return np.asarray(torch.stack(out).cpu())


def _int8_rank_checks(torch, rank: int, dev: str = "cuda",
                      smoke: bool = False) -> dict:
    """On this rank of phase E, after the CLI runs: INT8_E_LAYERS layers of
    mamba2-370m's in_proj stack gathered layer by layer through
    ``param_gather_constraint``, plain (bf16) and under ``FSDP_RULES`` with
    ``int8_gather`` (timed); the int8 values of the first and last of them
    within max|w| / 127 a chunk of the flattened layer (JAX's chunks) of
    the plain gather's; one layer's backward for this rank's cotangent:
    the plain gather's is the bf16 reduce-scatter, the int8 gather's the
    f32 one rounded to bf16 once, so within one bf16 ulp of the sum of
    every rank's cotangent, taken from an all-gather; and
    ``int8_ring_all_reduce`` of one layer's grad-sized f32 term against
    gloo's ``all_reduce`` (timed), within the sum of the ranks' max|x| /
    254 a chunk (1 % slack for the f32 sums' order) -> numbers, gates
    raised here. ``dev`` and ``smoke`` (the smoke config) let it run on
    four CPU ranks as a dry run."""
    import dataclasses
    import types

    from repro_torch import configs
    from repro_torch.distributed import compat
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.compression import int8_ring_all_reduce
    from repro_torch.distributed.zero import data_layout
    from repro_torch.models import model as Mdl

    dev = torch.device(dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    specs = Mdl.param_specs(configs.get("mamba2-370m", smoke))
    mesh = types.SimpleNamespace(shape={"data": DP_E_WORLD, "model": 1})
    layout = data_layout(specs, mesh, rank)
    path = ("blocks", "ssm", "in_proj")
    shape = layout.shape_at(path)
    dim = layout.dim_at(path)
    g = torch.Generator(dev).manual_seed(11)  # the same stack on every rank
    w = (torch.randn(shape, generator=g, device=dev) * 0.02).to(torch.bfloat16)
    k = shape[dim] // DP_E_WORLD
    mine = w.narrow(dim, rank * k, k).clone()
    layers = min(INT8_E_LAYERS, shape[0])  # the smoke config has fewer
    plain = SH.DEFAULT_RULES
    int8 = dataclasses.replace(SH.FSDP_RULES, int8_gather=True)

    def gather(rules, x):
        with SH.use_rules(mesh, rules, layout):
            return SH.param_gather_constraint({"in_proj": x},
                                              path[:-1])["in_proj"]

    out = {}
    for name, rules in (("plain", plain), ("int8", int8)):
        gather(rules, mine[0])  # warm
        sync()
        t0 = time.perf_counter()
        for i in range(layers):
            y = gather(rules, mine[i])
        sync()
        out[f"{name}_stack_ms"] = (time.perf_counter() - t0) * 1e3
        del y
    worst = 0.0
    for i in (0, layers - 1):
        ref = gather(plain, mine[i])
        if not torch.equal(ref, w[i]):
            raise AssertionError(f"E int8 checks: the plain gather of layer "
                                 f"{i} is not the layer")
        q = gather(int8, mine[i])
        err = (q.float() - ref.float()).reshape(-1)
        amax = ref.float().abs().reshape(-1)
        pad = (-err.numel()) % 256
        err = torch.nn.functional.pad(err, (0, pad)).view(-1, 256)
        amax = torch.nn.functional.pad(amax, (0, pad)).view(-1, 256)
        ratio = (err.abs().amax(1) / (amax.amax(1) / 127).clamp_min(1e-30))
        worst = max(worst, float(ratio.max()))
        if not worst <= 1.0:
            raise AssertionError(f"E int8 checks: layer {i}'s int8 gather "
                                 f"is {worst} times max|w|/127 off")
    out["int8_err_share"] = worst
    cot = torch.randn(w.shape[1:], generator=torch.Generator(dev).manual_seed(
        100 + rank), device=dev).to(torch.bfloat16)
    grads = {}
    for name, rules in (("plain", plain), ("int8", int8)):
        x = mine[0].clone().requires_grad_(True)
        gather(rules, x).backward(cot)
        grads[name] = x.grad.float()
    every = compat.all_gather(cot.float()[None])  # [ranks, *layer]
    want = every.sum(0).narrow(dim - 1, rank * k, k)
    # one bf16 ulp, and the f32 sums' order where the cotangents cancel
    ulp = (2.0**-7 * want.abs()
           + 2.0**-20 * every.abs().sum(0).narrow(dim - 1, rank * k, k))
    out["int8_bwd_ulps"] = float(((grads["int8"] - want).abs() / ulp).max())
    out["plain_bwd_ulps"] = float(((grads["plain"] - want).abs() / ulp).max())
    if not out["int8_bwd_ulps"] <= 1.0:
        raise AssertionError(f"E int8 checks: the int8 gather's backward is "
                             f"{out['int8_bwd_ulps']} bf16 ulps off the "
                             f"summed cotangents")
    term = torch.randn(w.shape[1:], generator=torch.Generator(dev)
                       .manual_seed(200 + rank), device=dev) * (1 + rank)
    times = {"ring": [], "all_reduce": []}
    for _ in range(INT8_E_REPS):
        sync()
        t0 = time.perf_counter()
        ring = int8_ring_all_reduce(term)
        sync()
        times["ring"].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        exact = compat.all_reduce_sum(term)
        sync()
        times["all_reduce"].append((time.perf_counter() - t0) * 1e3)
    for key, v in times.items():
        out[f"{key}_ms"] = sorted(v)[len(v) // 2]
    chunks = term.reshape(-1).abs()
    pad = (-chunks.numel()) % 256
    cmax = torch.nn.functional.pad(chunks, (0, pad)).view(-1, 256).amax(1)
    bound = compat.all_reduce_sum(cmax) / 254 * 1.01
    err = (ring - exact).reshape(-1).abs()
    err = torch.nn.functional.pad(err, (0, pad)).view(-1, 256).amax(1)
    out["ring_err_share"] = float((err / bound).max())
    if not out["ring_err_share"] <= 1.0:
        raise AssertionError(f"E int8 checks: the ring is "
                             f"{out['ring_err_share']} times its bound off")
    return out


def _train_rank(rank: int, store: str, out_dir: str, src: str) -> None:
    """One rank of phase E: joins the gloo group and runs each of DP_E_RUNS
    through ``train.main``, keeping its final params' digest (gathered
    whole from every rank's slices), the bytes of the params it held and
    of the full tree, its kept counts, its kernel launches, its peak
    memory, its host time in gloo's collectives inside the steps, and in
    run (b) the ledger writes it made; then ``_int8_rank_checks``."""
    import contextlib
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, src)
    from repro_torch.distributed import compat
    from repro_torch.distributed.ledger import ShardedLedgerOps
    from repro_torch.distributed.zero import HELD
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models.params import tree_leaves

    dist.init_process_group(
        "gloo", store=dist.FileStore(store, DP_E_WORLD), rank=rank,
        world_size=DP_E_WORLD, timeout=datetime.timedelta(seconds=300))
    rec = {"state": None, "kept": [], "writes": [], "gloo": 0.0,
           "in_step": False, "layout": None}
    make = train.make_train_step
    layout_of = train.data_layout

    def keep_layout(*a, **k):
        rec["layout"] = layout_of(*a, **k)
        return rec["layout"]

    def make_kept(*a, **k):
        fn = make(*a, **k)

        def run(state, batch, noise):
            state, m = fn(state, batch, noise)
            rec["state"] = state
            rec["kept"].append(float(m["kept"]))
            return state, m

        return run

    record_priority = ShardedLedgerOps.record_priority

    def record_kept(self, state, ids, losses, step, valid=None, **kw):
        rec["writes"].append((ids.cpu().numpy(), losses.cpu().numpy(),
                              int(step), valid.cpu().numpy()))
        return record_priority(self, state, ids, losses, step, valid, **kw)

    def timed(fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                if rec["in_step"]:
                    rec["gloo"] += time.perf_counter() - t0
        return call

    guard = train.no_host_sync

    @contextlib.contextmanager
    def in_step(enabled):
        rec["in_step"] = True
        with guard(enabled):
            yield
        rec["in_step"] = False

    train.make_train_step = make_kept
    train.data_layout = keep_layout
    train.no_host_sync = in_step
    ShardedLedgerOps.record_priority = record_kept
    dist.all_reduce = timed(dist.all_reduce)
    dist.all_to_all_single = timed(dist.all_to_all_single)
    dist.reduce_scatter_tensor = timed(dist.reduce_scatter_tensor)
    compat._all_gather_single = timed(compat._all_gather_single)
    out = {}
    for name, (extra, _, _, f32) in DP_E_RUNS.items():
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        rec.update(kept=[], writes=[], gloo=0.0)
        argv = DP_E_ARGV + ["--model-parallel", "1"] + extra + [
            "--json-out", os.path.join(out_dir, f"{name}.json")]
        if name == "b":
            argv += ["--ledger-out", os.path.join(out_dir, "b_ledger.npz")]
        with f32_configs(f32):
            train.main(argv)
        held, lay = rec["state"]["params"], rec["layout"]
        leaves = tree_leaves(held)
        out[f"{name}/held_bytes"] = np.int64(sum(
            x.numel() * x.element_size() for x in leaves))
        out[f"{name}/want_bytes"] = np.int64(sum(
            math.prod(s) * x.element_size() // (DP_E_WORLD if h else 1)
            for x, s, h in zip(leaves, tree_leaves(lay.shapes),
                               lay.held_mask())))
        out[f"{name}/whole_bytes"] = np.int64(sum(
            math.prod(s) * x.element_size()
            for x, s in zip(leaves, tree_leaves(lay.shapes))))
        out[f"{name}/digest"] = _param_digest(torch, lay.gather(held, HELD))
        rec["state"] = held = None
        out[f"{name}/kept"] = np.asarray(rec["kept"])
        out[f"{name}/gloo_s"] = np.float64(rec["gloo"])
        out[f"{name}/peak_gib"] = np.float64(
            torch.cuda.max_memory_allocated() / 2**30)
        for k, v in ops.LAUNCHES.items():
            out[f"{name}/launches/{k}"] = np.int64(v)
        for t, (ids, losses, step, valid) in enumerate(rec["writes"]):
            out[f"{name}/write/{t}/ids"] = ids
            out[f"{name}/write/{t}/losses"] = losses
            out[f"{name}/write/{t}/step"] = np.int64(step)
            out[f"{name}/write/{t}/valid"] = valid
        torch.cuda.empty_cache()
    for k, v in _int8_rank_checks(torch, rank).items():
        out[f"int8/{k}"] = np.float64(v)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


def dp_ranks_phase(torch, ops, tmp: str) -> tuple[dict, list[str]]:
    """Phase E: four ranks (``_train_rank``, spawned, the kernels built in
    this process before they start) each run DP_E_RUNS through the train
    CLI, the params FSDP-placed. Gates, each run: every rank's final
    params, gathered whole, the same bits; every rank's param bytes those of
    its layout, a quarter of each sliced leaf and the whole of the others
    (and below half of the whole tree's); every
    step's kept rows and the step cost as DP_E_RUNS gives them; finite
    losses; each rank launching xent_fwd, xent_bwd, ssd and ssd_bwd (and
    in (b) ledger_record_priority); (b)'s ``--ledger-out`` table equal to
    the single card table that the ranks' writes give (the global batch
    rank-major, through the ledger kernel as the gather path writes); the
    losses of (c) and (c-f32) within DP_BF16_RTOL and REF_TRAIN_RTOL of one
    rank's ``--method full`` run of the same config in the same dtype
    (dense data-parallel equals one device); then the int8 gather and ring
    checks of ``_int8_rank_checks`` on every rank -> (launches by run and
    rank, lines)."""
    import multiprocessing as mp

    import numpy as np

    from repro_torch.core import device_ledger as dledger
    from repro_torch.core.history import HistoryConfig

    _free(torch)
    t0 = time.perf_counter()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_train_rank, args=(
        r, os.path.join(tmp, "dp_store"), tmp, os.path.join(ROOT, "src")))
        for r in range(DP_E_WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + 420
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise AssertionError(f"phase E ranks exited with {codes}")
    ranks_s = time.perf_counter() - t0
    ranks = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
             for r in range(DP_E_WORLD)]
    one = {}
    for name in ("c", "c-f32"):
        with f32_configs(DP_E_RUNS[name][3]):
            one[name] = train_run(torch, ops, DP_E_ARGV + DP_E_RUNS[name][0],
                                  os.path.join(tmp, f"{name}_one.json"))
    lines, launches = [], {}
    for name, (_, cost, kept, f32) in DP_E_RUNS.items():
        with open(os.path.join(tmp, f"{name}.json")) as f:
            s = json.load(f)
        for r in ranks[1:]:
            if not np.array_equal(r[f"{name}/digest"],
                                  ranks[0][f"{name}/digest"]):
                raise AssertionError(f"phase E ({name}): the ranks' gathered "
                                     "params differ")
        held = [int(r[f"{name}/held_bytes"]) for r in ranks]
        whole = int(ranks[0][f"{name}/whole_bytes"])
        for r, h in zip(ranks, held):
            if h != int(r[f"{name}/want_bytes"]) or not h < whole / 2:
                raise AssertionError(
                    f"phase E ({name}): a rank holds {h} param bytes, its "
                    f"layout {int(r[f'{name}/want_bytes'])}, of {whole}")
        for r in ranks:
            if list(r[f"{name}/kept"]) != [kept] * s["steps"]:
                raise AssertionError(f"phase E ({name}) kept "
                                     f"{r[f'{name}/kept']}")
        if abs(s["mean_step_cost"] - cost) > 1e-6:
            raise AssertionError(f"phase E ({name}) step cost "
                                 f"{s['mean_step_cost']}")
        if not all(math.isfinite(x) for x in (s["loss_first"],
                                              s["loss_last"])):
            raise AssertionError(f"phase E ({name}) losses {s}")
        want = DP_E_KERNELS + (("ledger_record_priority",) if name == "b"
                               else ())
        for r, out in enumerate(ranks):
            n = {k: int(out[f"{name}/launches/{k}"]) for k in ops.LAUNCHES}
            launches[f"{name} rank {r}"] = n
            if min(n[k] for k in want) <= 0:
                raise AssertionError(f"phase E ({name}) rank {r} missed a "
                                     f"kernel: {n}")
        note = ""
        if name == "b":
            lcfg = HistoryConfig()
            st = dledger.init_state(lcfg, "cuda")
            for t in range(s["steps"]):
                g = {k: np.concatenate([r[f"b/write/{t}/{k}"] for r in ranks])
                     for k in ("ids", "losses", "valid")}
                st, _ = dledger.record_priority(
                    lcfg, st, torch.from_numpy(g["ids"]).cuda(),
                    torch.from_numpy(g["losses"]).cuda(),
                    int(ranks[0][f"b/write/{t}/step"]),
                    valid=torch.from_numpy(g["valid"]).cuda())
            single = dledger.state_dict_of(st)
            got = dict(np.load(os.path.join(tmp, "b_ledger.npz")))
            for k, v in single.items():
                if not np.array_equal(got[k], v):
                    raise AssertionError(f"phase E (b): table {k} differs "
                                         "from the single table")
            note = (f", the routed table equal to the single one "
                    f"({int((single['owner'] >= 0).sum())} live slots)")
        if name in one:
            o, tol = one[name], REF_TRAIN_RTOL if f32 else DP_BF16_RTOL
            rel = max(abs(s[k] - o[k]) / abs(o[k])
                      for k in ("loss_first", "loss_last"))
            note = (f", one rank's losses {o['loss_first']:.6f} -> "
                    f"{o['loss_last']:.6f} (this run's {s['loss_first']:.6f}"
                    f" -> {s['loss_last']:.6f}; largest relative difference "
                    f"{rel:.3g}, tol {tol}), one rank's steady step "
                    f"{o['steady_ms']:.1f} ms, peak {o['peak_gib']:.2f} GiB")
            if rel > tol:
                raise AssertionError(f"phase E ({name}): losses "
                                     f"{s['loss_first']}, {s['loss_last']}; "
                                     f"one rank {o['loss_first']}, "
                                     f"{o['loss_last']} (tol {tol})")
        warm = sorted(s["step_ms"][1:])
        steady = warm[len(warm) // 2]
        gloo = float(ranks[0][f"{name}/gloo_s"]) * 1e3 / s["steps"]
        peaks = [round(float(r[f"{name}/peak_gib"]), 2) for r in ranks]
        lines.append(
            f"dp ranks (E, {name}): mamba2-370m 48 layers "
            f"{'f32' if f32 else 'bf16'}, 4 gloo ranks "
            f"on one card, 32 x 512 (8 rows a rank), {' '.join(DP_E_RUNS[name][0])}: "
            f"loss {s['loss_first']:.4f} -> {s['loss_last']:.4f}, step cost "
            f"{s['mean_step_cost']:.3f}C, kept {kept} a step, gathered "
            f"params equal on every rank, step ms (rank 0) first {s['step_ms'][0]:.1f}, "
            f"steady (median of warm) {steady:.1f}, of which in gloo's "
            f"collectives (host-staged; rank 0, a step) {gloo:.1f} "
            f"({100 * gloo / (sum(s['step_ms']) / s['steps']):.0f}% of the "
            f"mean step), peak GiB a rank {peaks} (params replicated, "
            f"bf16: {DP_E_REPLICATED_PEAK_GIB}), param bytes a "
            f"rank {held} of {whole} whole ({held[0] / whole:.4f}), "
            f"launches rank 0 {launches[f'{name} rank 0']}" + note)
    i8 = {k[5:]: [float(r[k]) for r in ranks] for k in ranks[0]
          if k.startswith("int8/")}
    med = lambda k: sorted(i8[k])[len(i8[k]) // 2]
    lines.append(
        f"dp ranks (E, int8): {INT8_E_LAYERS} layers of mamba2-370m's "
        f"in_proj stack [48, 1024, 4384] bf16, a quarter a rank, gathered "
        f"layer by layer through param_gather_constraint: plain "
        f"{med('plain_stack_ms'):.1f} ms, int8_gather (FSDP_RULES) "
        f"{med('int8_stack_ms'):.1f} ms the {INT8_E_LAYERS} (median of the "
        f"ranks); int8 within {max(i8['int8_err_share']):.3f} of max|w|/127 "
        f"a chunk (the first and last layers), its backward within "
        f"{max(i8['int8_bwd_ulps']):.3f} bf16 ulps of the summed cotangents "
        f"(the plain gather's bf16 reduce-scatter "
        f"{max(i8['plain_bwd_ulps']):.3f}); int8_ring_all_reduce of a "
        f"[1024, 4384] f32 "
        f"term {med('ring_ms'):.2f} ms against gloo's all_reduce "
        f"{med('all_reduce_ms'):.2f} ms (median of {INT8_E_REPS}), within "
        f"{max(i8['ring_err_share']):.3f} of its bound")
    lines.append(f"phase E: {ranks_s:.1f} s the ranks, "
                 f"{time.perf_counter() - t0:.1f} s in all")
    return launches, lines


def train_profile_phase(torch, arch="llama3-8b", layers=TRAIN_LAYERS,
                        seq=128) -> str:
    """Where a steady train step of run (a)'s configuration goes (32 rows
    of ``seq`` tokens, obftf at 0.25, AdamW): host wall time per step,
    device kernel time per step (torch.profiler), kernel launches per step,
    device time by kind of kernel and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.core.obftf import OBFTFConfig, make_train_step
    from repro_torch.core.selection import GeneratorNoise, SelectionConfig
    from repro_torch.data import DataConfig, SyntheticLMStream
    from repro_torch.kernels import ops
    from repro_torch.launch.train import build_optimizer
    from repro_torch.models import model as Mdl
    from repro_torch.models.params import materialize

    _free(torch)
    cfg = configs.get(arch, layers=layers)
    opt = build_optimizer(1e-3, 100)
    step_fn = make_train_step(Mdl.loss_fn(cfg), opt, OBFTFConfig(
        SelectionConfig(method="obftf", ratio=0.25)))
    params = materialize(Mdl.param_specs(cfg), 0, torch.bfloat16, "cuda")
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    del params
    stream = SyntheticLMStream(DataConfig(32, seq, cfg.vocab_size))
    noise = GeneratorNoise(torch.Generator("cuda").manual_seed(0))

    def step(i):
        nonlocal state
        raw = stream.batch(i)
        batch = {k: torch.from_numpy(raw[k]).cuda() for k in ("tokens",
                                                              "labels")}
        state, _ = step_fn(state, batch, noise)

    for i in range(2):
        step(i)
    n = 2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        step(2 + i)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    before = dict(ops.LAUNCHES)
    # one step profiled: the profiler's handling of its events costs more
    # than the step
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(4)
        torch.cuda.synchronize()
    seen = _seen(torch, prof, {k: v - before[k]
                               for k, v in ops.LAUNCHES.items()})
    device_ms, launches, tops = _profile_summary(torch, prof, 1)
    groups = _kernel_groups(torch, prof, 1)
    stacks = _op_device_ms(prof, 1, ("SelectBackward0", "AccumulateGrad"))
    del state
    _free(torch)
    return (f"steady train step {wall_ms:.1f} ms host wall (run a), device "
            f"busy {device_ms:.1f} ms/step ({100 * device_ms / wall_ms:.1f}%)"
            f", {launches:.0f} kernel launches/step; device ms/step by kind: "
            f"{groups}; device ms/step under the stacks' layer-index "
            f"backward and the grads' accumulation: {stacks}; top device "
            f"ms/step: {tops}; kernel launches the profiler saw: {seen}")


def _op_device_ms(prof, n, ops_: tuple) -> str:
    """Device ms per step of the kernels each operator of ``ops_`` ran,
    its children's included (``SelectBackward0``: the backward of a
    layer's index into a stacked tensor, which writes a zero tensor the
    size of the whole stack), with the operator's calls per step."""

    def dev_us(e):
        return getattr(e, "device_time_total", None) or getattr(
            e, "cuda_time_total", 0.0)

    out = []
    events = _averages(prof)
    for op in ops_:
        # the operator's own row, or the autograd engine's row around it
        # ("autograd::engine::evaluate_function: <op>"), whichever holds
        # more: the outer one includes the inner
        best = max((e for e in events if e.key.endswith(op)), key=dev_us,
                   default=None)
        us, calls = (dev_us(best), best.count) if best else (0.0, 0)
        out.append(f"{op} {us / 1e3 / n:.2f} ({calls / n:.0f} calls)")
    return ", ".join(out)


# the dense archs and the prefix-embedding families (served without a
# prefix, as the serve CLI serves them): each served at full width through
# the paged cache, as the llama3-8b phase (prompts of 128/112/96/80, 32
# new tokens), at half its depth (30, 40, 88, 40 and 48 layers whole):
# the cut that pays for phase E's FSDP runs within the script's time
# limit (the whole script took 707.3 s with them at full depth)
ARCH_LAYERS = {"deepseek-7b": 15, "qwen3-14b": 20, "granite-34b": 44,
               "pixtral-12b": 20, "musicgen-medium": 24}


def arch_argv(arch: str) -> list[str]:
    argv = list(SERVE_ARGV) + ["--layers", str(ARCH_LAYERS[arch])]
    argv[argv.index("--arch") + 1] = arch
    return argv


def serve_gates(s: dict, layers: int, kernel="paged_decode_attn") -> None:
    """A serve path's launch counts: its attention ``kernel``
    (``paged_decode_attn`` on the paged cache, ``decode_attn`` on the dense
    one, None for MLA's latent cache, which no kernel reads) once per layer
    a step and the others never, ``topk_lse`` once a step and once an
    admission."""
    _per_path(s, {k: (layers if k == kernel else 0, "step")
                  for k in ("paged_decode_attn", "decode_attn")})
    if s["launches"]["topk_lse"] != s["steps"] + s["admitted"]:
        raise AssertionError(f"topk_lse launched {s['launches']['topk_lse']} "
                             f"times, not one per step and per admission")


def arch_serve_phases(torch, ops, tmp: str) -> dict:
    """deepseek-7b (MHA, G = 1), qwen3-14b (qk-norm, G = 5), granite-34b
    (MQA, G = 48, the GELU MLP), pixtral-12b (vlm, G = 4) and
    musicgen-medium (audio, G = 1, D = 64) served at full width and half
    depth (ARCH_LAYERS), each with a profile of its steady decode step; then each smoke config
    in f32 on the card and on the CPU: equal tokens, ledgers within 1e-5
    -> each serve's summary."""
    out = {}
    for arch, layers in ARCH_LAYERS.items():
        out[arch] = s = serve_phase(torch, ops, tmp, arch_argv(arch),
                                    SERVE_KERNELS)
        serve_gates(s, layers)
        print(serve_line(f"serve: {arch} {layers} layers bf16, paged", s),
              flush=True)
        print(f"{arch} profile: {profile_phase(torch, arch_argv(arch))}",
              flush=True)
    n = [engine_reference(torch, arch, 4, SIG_ATOL) for arch in ARCH_LAYERS]
    print(f"arch reference: {', '.join(ARCH_LAYERS)} smoke configs in f32, "
          f"{n} requests, tokens equal, ledgers within rtol 1e-5 (signal "
          f"channels also atol {SIG_ATOL})", flush=True)
    return out


# the archs' train runs at full width, depth cut to the deepest that
# trains on the card (launch.train one layer deeper, with these flags,
# runs out of memory in AdamW's first step: qwen3-14b at 8 of 40 layers,
# granite-34b at 9 of 88): qwen3-14b with a selection forward (qk-norm
# under a gradient), granite-34b recycled (the GELU MLP, MQA, the ledger
# kernel); mixtral-8x22b at 1 of 56 layers (2.9 B params, about llama3-8b's
# 8-layer cut; two layers, 5.4 B, would need about 97 GB at the 18 bytes a
# parameter that one layer's peak bears out: not run), both ways;
# deepseek-v2-236b at 1 of 60 layers, its dense lead layer with MLA (1.39
# B params; two layers, 5.36 B with the first MoE layer, would need about
# 100 GB: not run), both ways, so no MoE layer of it trains here;
# pixtral-12b with a selection forward at 9 of 40 layers (3.79 B params;
# at 10 the train CLI runs out of memory); musicgen-medium recycled at full
# depth; mamba2-370m and zamba2-2.7b (the hybrid family: 54 SSM layers in
# 9 groups, each led by the weight-shared attention block; 2.42 B params)
# at full depth both ways, on rows of 512 tokens (``ARCH_SEQ``: four chunks
# of the scan, so its backward's reverse fold runs)
RECYCLED = ("--recycle", "--ledger", "device", "--instance-pool", "64")
ARCH_TRAIN = (("qwen3-14b", 7, ()), ("granite-34b", 8, RECYCLED),
              ("mixtral-8x22b", 1, ()), ("mixtral-8x22b", 1, RECYCLED),
              ("deepseek-v2-236b", 1, ()), ("deepseek-v2-236b", 1, RECYCLED),
              ("pixtral-12b", 9, ()),
              ("musicgen-medium", 0, RECYCLED),
              ("mamba2-370m", 0, ()), ("mamba2-370m", 0, RECYCLED),
              ("zamba2-2.7b", 0, ()), ("zamba2-2.7b", 0, RECYCLED))
# the others' rows: TRAIN_ARGV's 128
ARCH_SEQ = {"mamba2-370m": 512, "zamba2-2.7b": 512}
# zamba2-2.7b's run (b) also writes its telemetry (the trainer's spans)
TELEMETRY_TRAIN = "zamba2-2.7b (b)"


def ssd_launches_per_step(cfg, recycled: bool) -> tuple[int, int]:
    """(ssd, ssd_bwd) launches of one train step of an ssm or hybrid
    model, from ``core.obftf``'s step and ``models.model.forward_hidden``:
    one scan an SSM layer in each forward, which are the selection forward
    (no grad, skipped when recycled) and the kept rows' forward, plus the
    backward's recompute under remat (of each layer, or for the hybrid of
    each group, which runs each of its SSM layers once); one backward an
    SSM layer."""
    forwards = (0 if recycled else 1) + 1 + (1 if cfg.remat else 0)
    return cfg.num_layers * forwards, cfg.num_layers


def train_floors(cfg, rows=32, seq=512, ratio=0.25) -> dict:
    """The least time one OBFTF step could take on the card: the matmuls'
    operations over the bf16 dense peak and AdamW's bytes over the memory
    rate. Matmul work is 2 flops a token for each effective parameter
    (every weight a token multiplies: the SSM and attention stacks, the
    hybrid's shared block once a group, the unembedding; the embedding is
    a gather), for the selection forward over every row and, on the kept
    rows, the forward, the backward (twice the forward) and the remat
    recompute; AdamW reads p, g, mu and nu and writes p, mu and nu once."""
    from repro_torch.models import model as Mdl
    from repro_torch.models.params import tree_leaves

    specs = Mdl.param_specs(cfg)

    def count(tree):
        return sum(math.prod(s.shape) for s in tree_leaves(tree))

    total = count(specs)
    eff = total - count(specs["embed"])
    if cfg.tie_embeddings:
        eff += count(specs["embed"])
    if "shared_attn" in specs:
        eff += (cfg.num_layers // cfg.hybrid_attn_every - 1) * count(
            specs["shared_attn"])
    kept = rows * ratio
    per_fwd = 2 * eff * seq
    flops_a = per_fwd * (rows + kept * (1 + 2 + (1 if cfg.remat else 0)))
    flops_b = flops_a - per_fwd * rows
    adamw_bytes = total * (2 + 2 + 4 + 4 + 2 + 4 + 4)
    return {"params": total, "effective": eff,
            "a_ms": flops_a / PEAK_FLOPS["bf16"] * 1e3, "a_tflop": flops_a /
            1e12, "b_ms": flops_b / PEAK_FLOPS["bf16"] * 1e3,
            "b_tflop": flops_b / 1e12, "adamw_gb": adamw_bytes / 1e9,
            "adamw_ms": adamw_bytes / HBM_BYTES_PER_S * 1e3}


def telemetry_train_check(path: str) -> str:
    """A train run's ``--metrics-out`` and ``--trace-out``: loop_health
    events, one summary, the trainer's spans."""
    from repro_torch import obs

    rows = obs.read_jsonl(path + ".jsonl")
    kinds = [r["kind"] for r in rows]
    spans = {e["name"] for e in obs.load_trace(path + ".trace.json")}
    if (kinds.count("summary") != 1 or kinds[-1] != "summary"
            or "loop_health" not in kinds
            or not {"train.step", "train.fetch_metrics"} <= spans):
        raise AssertionError(f"train telemetry: kinds {kinds}, spans {spans}")
    c = rows[-1]["metrics"]["counters"]
    if c["trainer.steps"] != rows[-1]["steps"]:
        raise AssertionError(f"trainer.steps {c['trainer.steps']}")
    return (f"telemetry: {kinds.count('loop_health')} loop_health events "
            f"and a summary, spans {sorted(spans)}")


def arch_train_phase(torch, ops, tmp: str) -> dict:
    """Each ``ARCH_TRAIN`` run -> its summary, keyed "<arch> (a)" for a
    run with a selection forward, "<arch> (b)" for a recycled one."""
    from repro_torch import configs

    out = {}
    for arch, layers, extra in ARCH_TRAIN:
        argv = [*TRAIN_ARGV, "--steps", "4" if not extra else "6", *extra]
        argv[argv.index("--arch") + 1] = arch
        argv[argv.index("--layers") + 1] = str(layers)
        argv[argv.index("--seq-len") + 1] = str(ARCH_SEQ.get(arch, 128))
        key = f"{arch} ({'b' if extra else 'a'})"
        telem = os.path.join(tmp, "train_telemetry")
        if key == TELEMETRY_TRAIN:
            argv += ["--metrics-out", telem + ".jsonl", "--trace-out",
                     telem + ".trace.json", "--metrics-every", "2"]
        r = train_run(torch, ops, argv, os.path.join(tmp, f"{key}.json"))
        note = ""
        if key == TELEMETRY_TRAIN:
            from repro_torch import obs

            obs.install(obs.OFF)
            note = f", {telemetry_train_check(telem)}"
        want = ("xent_fwd", "xent_bwd") + (("ledger_record_priority",)
                                           if extra else ())
        if min(r["launches"][k] for k in want) <= 0:
            raise AssertionError(f"{arch} train missed a kernel: "
                                 f"{r['launches']}")
        cost = 0.75 if extra else 1.75
        if abs(r["mean_step_cost"] - cost) > 1e-6:
            raise AssertionError(f"{arch} step cost {r['mean_step_cost']}")
        share = r["moe_dropped_share"]
        if share is not None and not 0.0 <= share < 1.0:
            raise AssertionError(f"{arch} dropped-token share {share}")
        cfg = configs.get(arch, layers=layers)
        if cfg.family in ("ssm", "hybrid"):
            fwd, bwd = ssd_launches_per_step(cfg, bool(extra))
            _per_path(r, {"ssd": (fwd, "step"), "ssd_bwd": (bwd, "step")})
            fl = train_floors(cfg, seq=ARCH_SEQ[arch])
            note += (f", floors: {fl['effective'] / 1e9:.3f} B effective "
                     f"params a token ({fl['params'] / 1e9:.3f} B params), "
                     f"matmuls {fl['b_tflop' if extra else 'a_tflop']:.1f} "
                     f"TFLOP = {fl['b_ms' if extra else 'a_ms']:.1f} ms at "
                     f"the bf16 peak, AdamW {fl['adamw_gb']:.1f} GB = "
                     f"{fl['adamw_ms']:.1f} ms")
        routes = cfg.uses_moe and cfg.num_layers > cfg.first_k_dense
        if (share is not None) != routes:
            raise AssertionError(f"{arch}: dropped-token share {share} with "
                                 f"MoE layers {routes}")
        print(f"train: {key} {r['layers']} of "
              f"{configs.get(arch).num_layers} layers "
              f"bf16, {r['steps']} steps, recycle={r['recycle']} "
              f"ledger={r['ledger']}, loss {r['loss_first']:.4f} -> "
              f"{r['loss_last']:.4f}, mean step cost "
              f"{r['mean_step_cost']:.3f}C, launches {r['launches']}, step ms "
              f"first {r['step_ms'][0]:.1f}, steady (median of warm) "
              f"{r['steady_ms']:.1f}, peak {r['peak_gib']:.1f} GiB, sync "
              f"guard on {r['guarded_steps']} warm steps"
              + (f", dropped-token share {share:.4f}" if share is not None
                 else ", no MoE layer in the cut: nothing routed, no "
                      "dropped share" if cfg.uses_moe else "") + note,
              flush=True)
        out[key] = r
    return out


# mixtral-8x22b (moe: 8 experts of 6144 x 16384, top-2, capacity factor 2,
# a 4,096-token sliding window) at full width cut to 12 of 56 layers: 30.5 B
# params, 61 GB of bf16 weights beside its rolling dense cache; 8 slots,
# 16 requests of 128-token prompts (exact length, as the CLI gives them to
# a moe model), 32 new tokens
MIXTRAL_LAYERS = 12
MIXTRAL_ARGV = [
    "--arch", "mixtral-8x22b", "--layers", str(MIXTRAL_LAYERS),
    "--batch", "8", "--requests", "16", "--prompt-len", "128", "--gen", "32",
    "--retain", "topk", "--topk", "64", "--ledger", "device",
    "--temperature", "0", "--device", "cuda",
]
# past the window: 4 requests of 4,160-token prompts (long-context chat or
# RAG), 16 new tokens, so every decode step reads a wrapped rolling cache
MIXTRAL_LONG_ARGV = [
    "--arch", "mixtral-8x22b", "--layers", str(MIXTRAL_LAYERS),
    "--batch", "4", "--requests", "4", "--prompt-len", "4160", "--gen", "16",
    "--retain", "topk", "--topk", "64", "--ledger", "device",
    "--temperature", "0", "--device", "cuda",
]


def weights_floor_ms(argv) -> float:
    """The time to read a serve config's bf16 weights once at the card's
    memory rate: a decode step's floor (the MoE step reads every expert)."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import model as Mdl
    from repro_torch.models.params import tree_leaves

    args = serve.parse_args(argv)
    cfg = configs.get(args.arch, layers=args.layers)
    n = sum(math.prod(sp.shape) for sp in tree_leaves(Mdl.param_specs(cfg)))
    return 2 * n / HBM_BYTES_PER_S * 1e3


def mixtral_phases(torch, ops, tmp: str) -> dict:
    """mixtral-8x22b served below and past its window (``decode_attn``
    once per layer a step, ``topk_lse`` once a step and an admission, the
    sync guard, the ledger), a profile of its steady decode step, one
    4,160-token prefill timed and profiled, and its smoke config in f32 on
    the card and on the CPU -> each serve's summary."""
    from repro_torch import configs

    out = {}
    for key, argv, what in (
            ("short", MIXTRAL_ARGV, "prompts of 128"),
            ("long", MIXTRAL_LONG_ARGV, "prompts of 4160, past the window")):
        out[key] = s = serve_phase(torch, ops, tmp, argv,
                                   ("decode_attn", "topk_lse"))
        serve_gates(s, MIXTRAL_LAYERS, kernel="decode_attn")
        print(serve_line(f"serve: mixtral-8x22b {MIXTRAL_LAYERS} of "
                         f"{configs.get('mixtral-8x22b').num_layers} layers "
                         f"bf16, dense cache, {what}", s)
              + f"; weights-read floor {weights_floor_ms(argv):.2f} "
              f"ms a step", flush=True)
    print(f"mixtral profile: {profile_phase(torch, MIXTRAL_ARGV)}", flush=True)
    pre = prefill_phase(torch, "mixtral-8x22b", MIXTRAL_LAYERS, 4160, 4176)
    print(f"mixtral prefill: {pre}", flush=True)
    n = engine_reference(torch, "mixtral-8x22b", None)
    print(f"mixtral reference: smoke config in f32, {n} requests past its "
          f"16-token window, tokens equal, ledgers within rtol 1e-5",
          flush=True)
    return out


# deepseek-v2-236b (MLA with a 512 + 64 latent a token, 2 shared and 160
# routed experts of 5120 x 1536, top-6 ungated, one dense lead layer) at
# full width cut to 8 of 60 layers (the lead layer and 7 MoE layers: 29.19
# B params, 58.4 GB of bf16 weights; 9 layers would be 66.3 GB), dense
# latent cache, exact-length prefill: 8 slots, 16 requests of 128-token
# prompts, 32 new tokens; then 2 slots, 2 requests of 8,192-token prompts
# (long-document summarisation, RAG: the prefill takes MLA's blocked
# branch, each decode step reads 8,208 positions of latent cache), 16 new
DEEPSEEK_LAYERS = 8
DEEPSEEK_ARGV = [
    "--arch", "deepseek-v2-236b", "--layers", str(DEEPSEEK_LAYERS),
    "--batch", "8", "--requests", "16", "--prompt-len", "128", "--gen", "32",
    "--retain", "topk", "--topk", "64", "--ledger", "device",
    "--temperature", "0", "--device", "cuda",
]
DEEPSEEK_LONG = 8192
DEEPSEEK_LONG_ARGV = [
    "--arch", "deepseek-v2-236b", "--layers", str(DEEPSEEK_LAYERS),
    "--batch", "2", "--requests", "2", "--prompt-len", str(DEEPSEEK_LONG),
    "--gen", "16", "--retain", "topk", "--topk", "64", "--ledger", "device",
    "--temperature", "0", "--device", "cuda",
]


def deepseek_phases(torch, ops, tmp: str) -> dict:
    """deepseek-v2-236b served with short and long prompts (no attention
    kernel: MLA's latent cache is read by einsums, as in the JAX package;
    ``topk_lse`` once a step and an admission, the sync guard, the ledger;
    the peak memory), a profile of the short path's decode step, one
    8,192-token prefill timed and profiled, and its smoke config's engine
    in f32 on the card and on the CPU -> each serve's summary."""
    from repro_torch import configs

    out = {}
    for key, argv, what in (
            ("short", DEEPSEEK_ARGV, "prompts of 128"),
            ("long", DEEPSEEK_LONG_ARGV,
             f"prompts of {DEEPSEEK_LONG}, MLA's blocked prefill")):
        out[key] = s = serve_phase(torch, ops, tmp, argv, ("topk_lse",))
        serve_gates(s, DEEPSEEK_LAYERS, kernel=None)
        print(serve_line(f"serve: deepseek-v2-236b {DEEPSEEK_LAYERS} of "
                         f"{configs.get('deepseek-v2-236b').num_layers} "
                         f"layers bf16, dense latent cache, {what}", s)
              + f"; weights-read floor {weights_floor_ms(argv):.2f} "
              f"ms a step", flush=True)
    print(f"deepseek-v2 profile: {profile_phase(torch, DEEPSEEK_ARGV)}",
          flush=True)
    pre = prefill_phase(torch, "deepseek-v2-236b", DEEPSEEK_LAYERS,
                        DEEPSEEK_LONG, DEEPSEEK_LONG + 16)
    print(f"deepseek-v2 prefill: {pre}", flush=True)
    n = engine_reference(torch, "deepseek-v2-236b", None)
    print(f"deepseek-v2 reference: smoke config in f32 (MLA, a dense lead "
          f"layer, a shared expert, ungated top-2), {n} requests, tokens "
          f"equal, ledgers within rtol 1e-5", flush=True)
    return out


# the prefix checks: the model's own entry points, since no CLI carries a
# prefix. Two rows, a random prefix at the token embeddings' scale (0.02),
# 128 prompt tokens, 16 greedy decode steps through the dense cache
# (decode_attn); each step's logits against one forward over prefix + all
# tokens, relative L2 per (row, step) over the vocabulary. Both sides run in
# bf16 and round differently (the decode kernel keeps its softmax weights
# in f32, the full forward's einsums round them), so the limit is bf16's,
# widened for the depth; the same forward without the prefix must miss it
PREFIX_TOL = 5e-2
PREFIX_PROMPT, PREFIX_NEW = 128, 16


def prefix_phase(torch, ops, arch: str) -> dict:
    """``arch`` at full width and depth: prefill its ``prefix_len``-frame
    prefix and a prompt into the dense cache, then greedy decode steps,
    held against ``forward_hidden`` over prefix + every token -> the
    launches and errors."""
    from repro_torch import configs
    from repro_torch.models import model as Mdl
    from repro_torch.models.params import materialize

    _free(torch)
    cfg = configs.get(arch)
    params = materialize(Mdl.param_specs(cfg), 0, torch.bfloat16, "cuda")
    g = torch.Generator(device="cuda").manual_seed(7)
    b, p_ = 2, cfg.prefix_len
    prefix = (torch.randn((b, p_, cfg.d_model), device="cuda", generator=g)
              * 0.02).to(torch.bfloat16)
    toks = torch.randint(0, cfg.vocab_size, (b, PREFIX_PROMPT),
                         device="cuda", generator=g, dtype=torch.int32)
    max_seq = p_ + PREFIX_PROMPT + PREFIX_NEW
    with torch.no_grad():
        ops.reset_launches()
        logits, cache = Mdl.prefill(params, cfg, toks, max_seq, prefix=prefix)
        pos = torch.full((b,), p_ + PREFIX_PROMPT, dtype=torch.int32,
                         device="cuda")
        new, steps = [], []
        for _ in range(PREFIX_NEW):
            nxt = Mdl.greedy_token(cfg, logits)[:, None]
            new.append(nxt)
            logits, cache = Mdl.decode_step(params, cfg, cache, nxt, pos)
            steps.append(logits.float())
            pos = pos + 1
        launches = dict(ops.LAUNCHES)
        every = torch.cat([toks, *new], dim=1)
        dec = torch.stack(steps, dim=1)  # [B, new, V]

        def rel(pre):
            h, _ = Mdl.forward_hidden(params, cfg, every, pre)
            full = Mdl.unembed(params, cfg, h[:, -PREFIX_NEW:]).float()
            return ((dec - full).norm(dim=-1)
                    / full.norm(dim=-1).clamp_min(1e-30))

        err = rel(prefix)
        without = rel(None).min().item()
    del params, cache
    _free(torch)
    if launches["decode_attn"] != cfg.num_layers * PREFIX_NEW or launches[
            "paged_decode_attn"]:
        raise AssertionError(f"{arch} prefix decode launches {launches}")
    if not torch.isfinite(dec).all():
        raise AssertionError(f"{arch}: non-finite decode logits")
    if err.max().item() > PREFIX_TOL:
        raise AssertionError(f"{arch}: decode after a prefix differs from "
                             f"the full forward by {err.max().item()}")
    if without <= PREFIX_TOL:
        raise AssertionError(f"{arch}: the forward without the prefix is "
                             f"within {PREFIX_TOL} ({without})")
    print(f"prefix: {arch} {cfg.num_layers} layers bf16, {b} rows of a "
          f"{p_}-frame prefix + {PREFIX_PROMPT} tokens prefilled, "
          f"{PREFIX_NEW} greedy decode steps (launches {launches}); logits "
          f"against one forward over prefix + all tokens, relative L2: last "
          f"step {err[:, -1].max().item():.3g}, every step "
          f"{err.max().item():.3g} (tol {PREFIX_TOL}); without the prefix "
          f"at least {without:.3g}", flush=True)
    return launches


# the paper's three experiments (the port's twins of the JAX benches), fast
# profile: lower is better for every metric but accuracy
PAPER_BETTER = {"normalized_test_loss": min, "test_accuracy": max,
                "eval_loss": min}


def _rows(lines):
    """CSV rows -> {(table, arm, ratio): (metric name, value)}."""
    rows, header = {}, None
    for line in lines:
        cells = line.split(",")
        if cells[0] == "table":
            header = cells
        elif len(cells) == 4 and header:
            rows[(cells[0], cells[1], cells[2])] = (header[3], float(cells[3]))
    return rows


def _expected_rows(fig1, fig2, table3, policies):
    want = [(f"fig1_{t}", m, str(r)) for t in ("clean", "outliers")
            for m in fig1.METHODS for r in fig1.RATIOS]
    for name, mod in (("fig2_mnist", fig2), ("table3_lm", table3)):
        want += [(name, "full", "1.0")]
        want += [(name, m, str(r)) for m in mod.METHODS for r in mod.RATIOS]
        want += [(f"{name}_policy", p, str(r)) for p in sorted(policies)
                 for r in mod.POLICY_RATIOS]
    return want


def _claims(rows) -> list[str]:
    """Not gated: does obftf beat uniform at each ratio, and how do the
    policy arms order against uniform and loss_ema (the paper's claims)."""
    out = []
    tables = sorted({k[0] for k in rows})
    for t in tables:
        arms = {(a, r): v for (tt, a, r), v in rows.items() if tt == t}
        metric = next(iter(arms.values()))[0]
        best = PAPER_BETTER[metric]
        if t.endswith("_policy"):
            for r in sorted({r for _, r in arms}):
                order = sorted(((v[1], a) for (a, rr), v in arms.items()
                                if rr == r), reverse=best is max)
                ranked = " > ".join(f"{a} {v:.4f}" for v, a in order)
                out.append(f"paper claim {t} ratio {r} ({metric}, best "
                           f"first): {ranked}")
            continue
        verdicts = []
        for (a, r), (_, v) in sorted(arms.items()):
            if a != "obftf":
                continue
            u = arms[("uniform", r)][1]
            won = best(v, u) == v and v != u
            verdicts.append(f"{r} {'yes' if won else 'no'} ({v:.4f} vs "
                            f"{u:.4f})")
        out.append(f"paper claim {t} ({metric}): obftf beats uniform at "
                   + "; ".join(verdicts))
    return out


def paper_phase(torch, ops) -> tuple[dict, list[str]]:
    """The three twins' fast profiles on the card: every CSV row, each
    bench's wall time; every row of the grids present and finite,
    accuracies in [0, 1], and the cross-entropy kernels launched by Table 3
    (counts set to 0 just before it, read just after) -> (Table 3's
    launches, the claim lines)."""
    from repro_torch.benchmarks import fig1_linreg, fig2_mnist, table3_lm_proxy
    from repro_torch.core.selection import POLICIES

    _free(torch)
    lines, launches = [], {}
    for name, mod in (("fig1", fig1_linreg), ("fig2", fig2_mnist),
                      ("table3", table3_lm_proxy)):
        ops.reset_launches()
        t0 = time.perf_counter()
        out = mod.main(fast=True, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[name] = dict(ops.LAUNCHES)
        for line in out:
            print(f"paper {name}: {line}")
        print(f"paper {name}: wall {wall:.1f} s, kernel launches "
              f"{launches[name]}", flush=True)
        lines += out
    rows = _rows(lines)
    want = _expected_rows(fig1_linreg, fig2_mnist, table3_lm_proxy, POLICIES)
    missing = [k for k in want if k not in rows]
    if missing or len(rows) != len(want):
        raise AssertionError(f"paper rows missing {missing} or extra "
                             f"{sorted(set(rows) - set(want))}")
    for key, (metric, v) in rows.items():
        if not math.isfinite(v) or (metric == "test_accuracy"
                                    and not 0.0 <= v <= 1.0):
            raise AssertionError(f"paper row {key}: {metric} {v}")
    t3 = launches["table3"]
    if t3["xent_fwd"] <= 0 or t3["xent_bwd"] <= 0:
        raise AssertionError(f"Table 3 ran without the xent kernels: {t3}")
    return t3, _claims(rows)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    start = time.perf_counter()
    laps, last = [], [start]

    def lap(name: str) -> None:
        """Seconds since the previous lap, for the phase-times line."""
        now = time.perf_counter()
        laps.append(f"{name} {now - last[0]:.1f}")
        last[0] = now

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
    lap("build")
    kernels = []

    def show(row):
        kernels.append(row)
        lib = ("none" if row["library_ms"] is None
               else f"{row['library_ms']:.4f} ms")
        print(f"kernel {row['name']} ({row['shape']}): ok, max_abs_err "
              f"{row['max_abs_err']:.3g} (tol {row['tol']}), {row['ms']:.4f} ms"
              f" | plain {row['plain_ms']:.4f} ms | library {lib} | bound "
              f"{row['bound_ms']:.5f} ms ({row['bound_by']})", flush=True)

    for phase in (topk_phase, paged_phase, decode_attn_phase, ssd_phase):
        show(phase(torch, ops, ref))
    show(ssd_bwd_phase(torch, ops))
    lap("kernel checks")
    _free(torch)
    with tempfile.TemporaryDirectory() as tmp:
        s = serve_phase(torch, ops, tmp)
    serve_gates(s, 32)
    print(serve_line("serve: llama3-8b 32 layers bf16, paged", s), flush=True)
    print(f"profile: {profile_phase(torch)}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        st, line = telemetry_serve_phase(torch, ops, tmp, s)
    print(line, flush=True)
    lap("serve, profile, telemetry")
    t_a = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        routed, lines = routed_serve_phase(torch, ops, tmp, s)
    for line in lines:
        print(line, flush=True)
    print(f"routed profile (a2a): "
          f"{profile_phase(torch, SERVE_ARGV + ROUTED_ARGV['a2a'])}",
          flush=True)
    print(f"phase A: {time.perf_counter() - t_a:.1f} s", flush=True)
    lap("A")
    print(f"reference: {reference_phase(torch)}", flush=True)
    lap("reference")
    with tempfile.TemporaryDirectory() as tmp:
        sl = slice_serve_phases(torch, ops, tmp)
    for key, name in (("hybrid", "zamba2-2.7b 54 layers"),
                      ("mamba2", "mamba2-370m 48 layers"),
                      ("dense", "llama3-8b 32 layers, dense cache")):
        print(serve_line(f"serve: {name} bf16", sl[key]), flush=True)
    print(f"hybrid profile: {profile_phase(torch, HYBRID_ARGV)}", flush=True)
    print(f"hybrid prefill: {prefill_phase(torch)}", flush=True)
    print(f"hybrid reference: {hybrid_reference_phase(torch, ops)}",
          flush=True)
    print(f"mamba2 train reference: "
          f"{train_reference(torch, 'mamba2-370m')}", flush=True)
    print(f"zamba2 train reference: "
          f"{train_reference(torch, 'zamba2-2.7b', resync=True)}",
          flush=True)
    # launches over each kernel's own main path: the paged llama3-8b serve
    # for topk_lse and paged_decode_attn, the zamba2 serve for the slice's
    # two kernels, the two train runs for the training kernels
    lap("ssm and hybrid serves, references")
    launches = {k: s["launches"][k] for k in SERVE_KERNELS}
    launches.update({k: sl["hybrid"]["launches"][k]
                     for k in ("decode_attn", "ssd")})
    _free(torch)
    for row in xent_phases(torch, ops, ref):
        show(row)
    row, spans = ledger_phase(torch, ops, ref)
    show(row)
    print(spans, flush=True)
    lap("xent, ledger")
    shard_launches, lines = sharded_ops_phase(torch, ops)
    print(lines, flush=True)
    lap("B")
    with tempfile.TemporaryDirectory() as tmp:
        a, b = train_phase(torch, ops, tmp)
        t_c = time.perf_counter()
        c = routed_train_phase(torch, ops, tmp, b)
    for name, r in (("a", a), ("b", b)):
        print(f"train ({name}): llama3-8b {r['layers']} layers bf16, "
              f"{r['steps']} steps, recycle={r['recycle']} "
              f"ledger={r['ledger']}, loss {r['loss_first']:.4f} -> "
              f"{r['loss_last']:.4f}, mean step cost "
              f"{r['mean_step_cost']:.3f}C, ledger hits "
              f"{r['ledger_hits_mean']}, launches {r['launches']}, step ms "
              f"first {r['step_ms'][0]:.1f}, steady (median of warm) "
              f"{r['steady_ms']:.1f}, peak {r['peak_gib']:.1f} GiB, sync "
              f"guard on {r['guarded_steps']} warm steps", flush=True)
    print(f"routed train (b, --ledger-route --ledger-exchange a2a): loss "
          f"{c['loss_first']:.4f} -> {c['loss_last']:.4f} (run (b) "
          f"{b['loss_first']:.4f} -> {b['loss_last']:.4f}, largest relative "
          f"difference {c['loss_rel']:.3g}), exchange {c['exchange']}, "
          f"a2a_overflow {c['a2a_overflow']}, launches {c['launches']}, step "
          f"ms steady {c['steady_ms']:.1f}; phase C: "
          f"{time.perf_counter() - t_c:.1f} s", flush=True)
    for k in ("xent_fwd", "xent_bwd", "ledger_record_priority"):
        launches[k] = a["launches"][k] + b["launches"][k]
    lap("train a, b, C")
    d_launches, line = dp_step_phase(torch, ops)
    print(line, flush=True)
    lap("D")
    with tempfile.TemporaryDirectory() as tmp:
        e_launches, lines = dp_ranks_phase(torch, ops, tmp)
    for line in lines:
        print(line, flush=True)
    lap("E")
    print(f"train profile: {train_profile_phase(torch)}", flush=True)
    lap("train profile")
    by_path = {"serve llama3-8b paged": s["launches"],
               "serve llama3-8b paged, telemetry": st["launches"],
               "serve zamba2-2.7b": sl["hybrid"]["launches"],
               "serve mamba2-370m": sl["mamba2"]["launches"],
               "serve llama3-8b dense": sl["dense"]["launches"],
               "serve llama3-8b paged, routed gather":
                   routed["gather"]["launches"],
               "serve llama3-8b paged, routed a2a": routed["a2a"]["launches"],
               "train a": a["launches"], "train b": b["launches"],
               "train b, routed a2a": c["launches"],
               "train dp step, one NCCL rank (D)": d_launches}
    for key, n in e_launches.items():
        by_path[f"train dp mamba2-370m ({key}, 4 gloo ranks, E)"] = n
    for key, n in shard_launches.items():
        by_path[f"sharded ops {key} (4 ranks)"] = dict(
            {k: 0 for k in ops.LAUNCHES}, ledger_record_priority=n)
    with tempfile.TemporaryDirectory() as tmp:
        serves = arch_serve_phases(torch, ops, tmp)
        lap("dense archs' serves")
        mixtral = mixtral_phases(torch, ops, tmp)
        lap("mixtral")
        deepseek = deepseek_phases(torch, ops, tmp)
        lap("deepseek-v2")
        trains = arch_train_phase(torch, ops, tmp)
        lap("archs' trains")
    for arch, r in serves.items():
        by_path[f"serve {arch} paged"] = r["launches"]
    for key, r in mixtral.items():
        by_path[f"serve mixtral-8x22b {key}"] = r["launches"]
    for key, r in deepseek.items():
        by_path[f"serve deepseek-v2-236b {key}"] = r["launches"]
    for key, r in trains.items():
        by_path[f"train {key}"] = r["launches"]
    # ssd_bwd's main path: mamba2-370m's two train runs
    launches["ssd_bwd"] = sum(trains[f"mamba2-370m ({k})"]["launches"]
                              ["ssd_bwd"] for k in "ab")
    for row in kernels:
        row["launches"] = launches[row["name"]]
    print(f"mamba2 train profile: "
          f"{train_profile_phase(torch, 'mamba2-370m', 0, 512)}", flush=True)
    print(f"zamba2 train profile: "
          f"{train_profile_phase(torch, 'zamba2-2.7b', 0, 512)}", flush=True)
    lap("ssm train profiles")
    for arch in ("pixtral-12b", "musicgen-medium"):
        by_path[f"prefix {arch}"] = prefix_phase(torch, ops, arch)
    lap("prefix")
    t3, claims = paper_phase(torch, ops)
    lap("paper")
    by_path["paper table3"] = t3
    for line in claims:
        print(line, flush=True)
    for row in kernels:
        row["launches_by_path"] = {p: n[row["name"]]
                                   for p, n in by_path.items()
                                   if n[row["name"]]}
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # ssd and ssd_bwd: their bounds at the CUDA cores' f32 rate (ssd_bwd:
    # also at its design's units, its grids' device time, the share of the
    # tolerance it used, and what the JAX package differentiates in its
    # place); topk_lse and paged_decode_attn: device time alone, warm and
    # cold, and the library's
    extra = ("bound_design_ms", "bound_f32_ms", "dev_ms", "grids_ms",
             "tol_used", "dev_cold_ms", "dev_library_ms", "span_ms",
             "host_ms", "replaces_note", "launches_by_path")
    print(f"phase times (s): {', '.join(laps)}", flush=True)
    print(f"total: every phase passed in {time.perf_counter() - start:.1f} "
          f"s", flush=True)
    print(json.dumps({"kernels": [
        {k: r[k] for k in keys + extra if k in keys or k in r}
        for r in kernels]}))
    print(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
