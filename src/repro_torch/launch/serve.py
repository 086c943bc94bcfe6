"""Serving entry point of the port: a thin CLI over the continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --page-size 16 --retain topk --ledger device

The same flags and printed lines as ``repro.launch.serve``, plus
``--device`` (default ``cuda``) and ``--layers`` (cut the depth, keeping
the widths). The dense family (llama3-8b, deepseek-7b, qwen3-14b,
granite-34b) and the prefix-embedding families (pixtral-12b, musicgen-medium;
served without a prefix, as the JAX CLI serves them) go through the paged
(``--page-size`` > 0) or the dense cache; mixtral-8x22b, deepseek-v2-236b
(MLA's latent cache), mamba2-370m and zamba2-2.7b through the dense cache
only, each prompt prefilled at its exact length (a pad would take MoE
capacity from real tokens, or enter a recurrent state or rolling window). Requests come from the
deterministic ``SyntheticLMStream`` with the trainer's instance ids, and
``--ledger-out`` writes the ``.npz`` ledger interchange format that the JAX
package's ``LossHistory`` and ``device_ledger.state_from_dict`` load.

``--metrics-out``, ``--trace-out`` and ``--metrics-every`` (``repro_torch.obs``)
write the JAX CLI's telemetry: a ``loop_health`` event every
``--metrics-every`` engine steps (with the device ledger's EMA drift
against its host shadow) and a final ``summary`` event holding the
``--json-out`` summary with the instruments' snapshot under ``metrics``;
the engine's spans go to a Chrome trace. The summary has the JAX CLI's
keys and the port's own: ``seconds``, ``device``, ``layers``,
``guarded_steps``, ``step_ms`` and ``instance_ids``.

``--ledger-route`` shards the device ledger over the ranks of the data
axis (``launch.mesh``: one rank a device, from the ``torchrun``
environment, else a group of one in-process; NCCL on the card, gloo on the
CPU) and routes each record to the rank owning its global slot, through
``--ledger-exchange`` (``gather`` or ``a2a``, sized by
``--capacity-factor``). Each rank runs the same engine on the same
requests with the same seed, the multi-controller form of the JAX
engine's mesh-replicated state; only rank 0 prints and writes the output
files. On a box with N GPUs:

    torchrun --nproc-per-node N -m repro_torch.launch.serve \
        --arch llama3-8b --page-size 16 --retain topk --ledger device \
        --ledger-route --ledger-exchange a2a
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch import configs, obs
from repro_torch.core.history import HistoryConfig
from repro_torch.data import DataConfig, SyntheticLMStream
from repro_torch.launch.mesh import make_elastic_mesh
from repro_torch.models import model as Mdl
from repro_torch.models.params import materialize
from repro_torch.serving import Engine, OutcomeRecorder, delayed_outcomes, pad_safe


def build_engine(args, cfg, params, device, telemetry=None,
                 mesh=None) -> Engine:
    recorder = OutcomeRecorder(
        args.batch,
        args.gen,
        cfg.vocab_size,
        HistoryConfig(),
        ledger=args.ledger,
        mesh=mesh,
        route=args.ledger_route,
        exchange=args.ledger_exchange,
        capacity_factor=args.capacity_factor,
        retention=args.retain,
        topk=args.topk,
        device=device,
    )
    return Engine(
        cfg,
        params,
        recorder,
        slots=args.batch,
        max_prompt=args.prompt_len,
        max_gen=args.gen,
        page_size=args.page_size if args.page_size > 0 else None,
        num_pages=args.num_pages if args.num_pages > 0 else None,
        temperature=args.temperature,
        top_p=args.top_p,
        sample_seed=args.seed,
        telemetry=telemetry,
    )


def submit_stream(engine, args, cfg):
    """Queue --requests requests off the deterministic synthetic stream
    (prompt lengths vary per row on pad-safe families; labels are the
    stream's continuation; instance ids are the stream's own)."""
    stream = SyntheticLMStream(
        DataConfig(
            args.batch,
            args.prompt_len + args.gen,
            cfg.vocab_size,
            seed=args.seed,
            instance_pool=args.instance_pool,
        )
    )
    waves = -(-args.requests // args.batch)
    vary = pad_safe(cfg) and args.prompt_len >= 8
    n = 0
    submitted = []
    for w in range(waves):
        raw = stream.batch(w)
        for r in range(args.batch):
            if n >= args.requests:
                break
            plen = args.prompt_len - (r % 4) * (args.prompt_len // 8) if vary \
                else args.prompt_len
            toks = raw["tokens"][r]
            labels = toks[plen : plen + args.gen]
            iid = engine.submit(
                toks[:plen],
                max_new=len(labels),
                labels=None if args.outcome_delay else labels,
                instance_id=int(raw["instance_id"][r]),
                expect_labels=bool(args.outcome_delay),
            )
            submitted.append((iid, labels))
            n += 1
    return waves, submitted


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cpu runs the kernels' "
                         "plain versions)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model to this many layers, widths kept "
                         "(0 = the config's depth)")
    ap.add_argument("--batch", type=int, default=8,
                    help="decode slots (the fixed-size continuous batch)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32,
                    help="max new tokens per request")
    ap.add_argument("--requests", type=int, default=0,
                    help="requests to stream through the engine "
                         "(0 = 3 waves, i.e. 3x --batch)")
    ap.add_argument("--outcome-delay", type=int, default=0,
                    help="deliver each request's labels N engine steps "
                         "after admission (0 = attach at submit)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--page-size", type=int, default=0,
                    help="paged KV cache page size in tokens (0 = dense "
                         "per-slot reservation)")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="global KV page pool size (0 = dense-equivalent "
                         "slots * ceil(max_seq / page_size))")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="per-slot sampling temperature (0 = greedy argmax)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (only with --temperature>0)")
    ap.add_argument("--instance-pool", type=int, default=1 << 20,
                    help="distinct stream instance ids before reuse")
    ap.add_argument("--retain", default="full", choices=("full", "topk"),
                    help="retained-outcome layout: dense logits or the "
                         "(top-k values/indices, exact lse) summary")
    ap.add_argument("--topk", type=int, default=64,
                    help="retained top-k width under --retain topk")
    ap.add_argument("--ledger", default="host", choices=("host", "device"),
                    help="record outcomes into the host numpy ledger or the "
                         "device-resident one")
    ap.add_argument("--ledger-route", action="store_true",
                    help="shard the device ledger over the ranks and route "
                         "each record to the rank owning its global slot "
                         "(sharded_ledger_ops(route=True) inside the step)")
    ap.add_argument("--ledger-exchange", default="gather",
                    choices=("gather", "a2a"),
                    help="routed exchange realization: all_gather+home-mask "
                         "(2*shards*batch items an op) or capacity-factor "
                         "all_to_all (2*shards*cap items) plus, whenever "
                         "cap < batch, the exact residual gather round on "
                         "every op (this port has no host-synced skip of "
                         "it), so a2a never moves fewer bytes than gather "
                         "here; results are bit-identical")
    ap.add_argument("--capacity-factor", type=float, default=1.25,
                    help="a2a send-buffer slack: per-destination capacity = "
                         "ceil(batch*cf/shards); items past it are resolved "
                         "by the residual gather round (counted in "
                         "a2a_overflow), which runs on every op while "
                         "cap < batch")
    ap.add_argument("--ledger-out", default="",
                    help="save the ledger state_dict as .npz (the "
                         "interchange format of both packages)")
    ap.add_argument("--ledger-in", default="",
                    help="warm-start from an .npz state_dict")
    ap.add_argument("--json-out", default="",
                    help="write a run summary as JSON")
    obs.add_cli_args(ap)
    args = ap.parse_args(argv)
    if args.requests <= 0:
        args.requests = 3 * args.batch
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.ledger_route and args.ledger != "device":
        raise SystemExit("--ledger-route requires --ledger device")
    mesh = make_elastic_mesh(device=args.device) if args.ledger_route \
        else None
    try:
        return _serve(args, mesh)
    finally:
        if mesh is not None:
            mesh.close()


def _serve(args, mesh) -> int:
    device = torch.device(args.device) if mesh is None else mesh.device
    # every rank records, reads the ledger back and snapshots the loop at
    # the same points (the ledger's state_dict is a collective); rank 0
    # alone prints and writes the output files
    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    cfg = configs.get(args.arch, args.smoke, args.layers)
    telem = obs.from_args(args) if lead else obs.install(obs.Telemetry(
        enabled=bool(args.metrics_out or args.trace_out)))
    params = materialize(
        Mdl.param_specs(cfg), args.seed, Mdl.dtype_of(cfg.param_dtype), device
    )
    engine = build_engine(args, cfg, params, device, telemetry=telem,
                          mesh=mesh)

    if args.ledger_in:
        engine.load_ledger_state_dict(dict(np.load(args.ledger_in)))
        live = int((np.asarray(engine.ledger_state_dict()["owner"]) >= 0).sum())
        say(f"ledger warm-start from {args.ledger_in} ({live} live slots)")

    waves, submitted = submit_stream(engine, args, cfg)
    shards = engine.recorder.ops.shards if engine.recorder.ops else 1
    bps = engine.recorder.retained_bytes_per_slot()
    say(
        f"arch={cfg.name} layers={cfg.num_layers} slots={args.batch} "
        f"requests={args.requests} "
        f"({waves} waves) gen<= {args.gen} ledger={args.ledger}"
        + (f"[routed x{shards}]" if args.ledger_route else "")
        + f" retain={args.retain}"
        + (f"[k={args.topk}]" if args.retain == "topk" else "")
        + f" ({bps / 1e6:.3f} MB retained/slot)"
    )

    deliver = (
        delayed_outcomes(submitted, args.outcome_delay)
        if args.outcome_delay else None
    )

    def on_step(eng, metrics):
        if deliver is not None:
            deliver(eng, metrics)
        if args.metrics_out and eng.steps_run % args.metrics_every == 0:
            # drift=True reads the device ledger back: the snapshot
            # cadence, never inside a step (on every rank: a collective)
            telem.event("loop_health", **eng.loop_health(drift=True))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.time()
    stats = engine.run(max_steps=100_000, on_step=on_step)
    sync()
    dt = time.time() - t0
    tok_s = stats["generated_tokens"] / max(dt, 1e-9)
    say(
        f"served {stats['evicted']} requests, "
        f"{stats['generated_tokens']} decode tokens in {dt:.2f}s "
        f"({tok_s:.1f} tok/s, {stats['steps']} engine steps)"
    )

    ids = np.asarray([iid for iid, _ in submitted], np.int64)
    ema, seen = engine.ledger.lookup(ids)
    ema, seen = np.asarray(ema), np.asarray(seen)
    say(
        f"recorded serving losses: {stats['recorded']} positions, "
        f"mean ema={float(ema[seen].mean() if seen.any() else 0):.3f}; "
        f"ledger hit rate={float(seen.mean()):.2f}"
    )
    if args.retain == "topk":
        say(
            f"top-k tail-floor records: {stats['topk_misses']} of "
            f"{stats['recorded']} (rest scored exactly)"
        )
    if args.ledger_out:
        sd = engine.ledger_state_dict()
        if lead:
            np.savez(args.ledger_out, **sd)
        say(f"ledger saved to {args.ledger_out} ({args.ledger} layout)")
    say("sample generations (token ids):")
    for iid in list(engine.finished)[:2]:
        say("  ", engine.finished[iid][:12].tolist())
    # one summary for --json-out and the final "summary" event of
    # --metrics-out
    summary = dict(
        stats,
        tok_per_s=tok_s,
        waves=waves,
        ledger=args.ledger,
        routed=bool(args.ledger_route),
        exchange=args.ledger_exchange if args.ledger_route else "none",
        capacity_factor=args.capacity_factor,
        shards=shards,
        hit_rate=float(seen.mean()),
        outcome_delay=args.outcome_delay,
        retention=args.retain,
        topk=args.topk,
        retained_bytes_per_slot=bps,
        health=engine.loop_health(drift=True),
        seconds=dt,
        device=str(device),
        layers=cfg.num_layers,
        guarded_steps=engine.guarded_steps,
        step_ms=engine.step_ms,
        instance_ids=ids.tolist(),
    )
    if telem.registry is not None:
        summary["metrics"] = telem.snapshot()
    if args.json_out and lead:
        with open(args.json_out, "w") as f:
            json.dump(summary, f)
    telem.close(summary=summary)
    return 0


if __name__ == "__main__":
    sys.exit(main())
