"""Train entry point of the port: OBFTF training on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
        --smoke --device cpu --steps 20 --method obftf --ratio 0.25

The single-device path of ``repro.launch.train`` with its flags, printed
lines and ``--json-out`` names, for every family (the vlm and audio archs
train on tokens alone, as the JAX CLI feeds no ``prefix_embed``; the moe
family's per-example losses carry ``router_aux_coef`` times the router's
load-balancing loss, in the step and in the ledger, as in the JAX package;
the ssm and hybrid families' scan takes its gradient from the ``ssd_bwd``
kernel on the card, and the hybrid family's ``--layers`` is a multiple of
its ``hybrid_attn_every``):
  * batches from ``SyntheticLMStream``, or through ``RecycleFeed`` under
    ``--recycle --ledger host``;
  * the OBFTF step (``core.obftf``): selection forward (or recycled
    losses), subset selection, forward + backward on the kept rows, AdamW
    with a warmup-cosine schedule and weight decay 0.1;
  * under ``--recycle --ledger device`` the ledger lookup and write run in
    the step on the device, the write through
    ``core.device_ledger.record_priority`` (the ledger kernel on the card);
    otherwise the fresh per-example losses go to the host ``LossHistory``;
  * async atomic keep-3 checkpoints with the ledger beside them,
    ``--resume auto``, a final save on SIGTERM/SIGINT, and the step-time
    straggler watchdog;
  * telemetry (``repro_torch.obs``, the JAX trainer's names):
    ``--metrics-out`` writes a ``loop_health`` event every
    ``--metrics-every`` steps and a final ``summary`` event holding the
    ``--json-out`` summary with the instruments' snapshot under
    ``metrics``; ``--trace-out`` writes the spans ``train.step`` and
    ``train.fetch_metrics`` (and the checkpoint manager's) as a Chrome
    trace.

Added: ``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
versions) and ``--layers`` (cut the depth, keeping the widths). On the
card every step after the first runs with host syncs made errors, and the
summary counts those steps in ``guarded_steps``; the metrics are fetched
once, after the step. The summary's ``moe_dropped_share`` is the share of
routing choices that expert capacity dropped over the run (null where no
MoE layer routed any). ``--ledger-route``, ``--ledger-exchange`` and
``--capacity-factor`` are taken as the JAX trainer takes them on one
device: the table stays single, and the summary reports the exchange and
the capacity factor, with ``a2a_overflow`` 0. Not ported: ``--model-parallel``
and training on more than one rank, which refuses to start (the
data-parallel OBFTF step, ``make_train_step(mesh=, dp_axes=)``, is the
only way the JAX trainer reaches the sharded ledger: ROADMAP Queue 1
item 2).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import signal
import sys
import time

import numpy as np
import torch

from repro_torch import configs, obs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import device_ledger as dledger
from repro_torch.core.guard import no_host_sync
from repro_torch.core.history import HistoryConfig, LossHistory
from repro_torch.core.obftf import (
    OBFTFConfig,
    make_train_step,
    step_cost_savings,
)
from repro_torch.core.selection import (
    POLICIES,
    GeneratorNoise,
    SelectionConfig,
    get_policy,
    policy_score,
)
from repro_torch.data import DataConfig, RecycleFeed, SyntheticLMStream
from repro_torch.launch.mesh import world_size
from repro_torch.models import model as Mdl
from repro_torch.models import moe
from repro_torch.models.params import materialize
from repro_torch.optim import AdamWConfig, adamw, warmup_cosine

COLD_LOSS = 1e3  # recorded-loss fallback for ledger misses (cold start)


class Watchdog:
    """Step-time EMA; flags stragglers (steps > `factor` x EMA)."""

    def __init__(self, factor: float = 3.0, warmup: int = 5):
        self.factor = factor
        self.warmup = warmup
        self.ema = None
        self.n = 0
        self.flagged = 0

    def observe(self, dt: float) -> bool:
        self.n += 1
        if self.ema is None:
            self.ema = dt
            return False
        slow = self.n > self.warmup and dt > self.factor * self.ema
        if slow:
            self.flagged += 1
        else:  # don't poison the EMA with outliers
            self.ema = 0.9 * self.ema + 0.1 * dt
        return slow


def build_optimizer(lr: float, total_steps: int):
    """The optimizer of ``repro.launch.specs.state_specs`` on one device:
    AdamW (weight decay 0.1, clip 1.0) on a warmup-cosine schedule."""
    warmup = min(2000, max(1, total_steps // 10))
    return adamw(warmup_cosine(lr, warmup, total_steps),
                 AdamWConfig(weight_decay=0.1))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cpu runs the kernels' "
                         "plain versions)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model to this many layers, widths kept "
                         "(0 = the config's depth)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=32)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--method", default="obftf", help="selection method")
    ap.add_argument("--ratio", type=float, default=0.25)
    ap.add_argument("--recycle", action="store_true",
                    help="reuse recorded losses as the selection signal")
    ap.add_argument("--policy", default="loss_ema", choices=sorted(POLICIES),
                    help="selection policy scoring the recycled ledger "
                         "signals; only meaningful with --recycle")
    ap.add_argument("--ledger", default="host", choices=("host", "device"),
                    help="recycle ledger placement: host numpy store, or "
                         "device-resident (lookup + record inside the step)")
    ap.add_argument("--ledger-in", default="",
                    help="warm-start the ledger from an .npz state_dict")
    ap.add_argument("--ledger-out", default="",
                    help="save the final ledger state_dict as .npz")
    ap.add_argument("--ledger-route", action="store_true",
                    help="cross-shard id routing for the sharded device "
                         "ledger: exchange each id to the shard owning its "
                         "global slot before record/lookup, for feeds that "
                         "do not pin instances to a data shard")
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
    ap.add_argument("--json-out", default="",
                    help="write a run summary (losses, step cost) as JSON")
    ap.add_argument("--instance-pool", type=int, default=0,
                    help="distinct instance ids before the stream repeats "
                         "(0 = DataConfig default 2^20)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", default="", help="'auto' or a step number")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    obs.add_cli_args(ap)
    return ap.parse_args(argv)


def _fetch(metrics: dict) -> dict:
    """Device metrics -> host values: the scalars in one copy, the
    per-example arrays as numpy."""
    names = [k for k, v in metrics.items() if v.dim() == 0]
    out = dict(zip(names, torch.stack(
        [metrics[k].to(torch.float32) for k in names]).tolist()))
    out.update({k: v.cpu().numpy() for k, v in metrics.items() if v.dim()})
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    if world_size() > 1:
        raise SystemExit(
            f"training on {world_size()} ranks is not ported: the "
            "data-parallel OBFTF step (make_train_step(mesh=, dp_axes=)), "
            "through which the JAX trainer reaches the sharded ledger, is "
            "ROADMAP Queue 1 item 2; train on one rank"
        )
    device = torch.device(args.device)
    cfg = configs.get(args.arch, args.smoke, args.layers)
    telem = obs.from_args(args)
    print(
        f"arch={cfg.name} layers={cfg.num_layers} device={device} "
        f"global_batch={args.global_batch} method={args.method} "
        f"ratio={args.ratio}"
    )

    sel = SelectionConfig(method=args.method, ratio=args.ratio)
    obftf = OBFTFConfig(selection=sel, recycle_forward=args.recycle,
                        mode="full" if args.method == "full" else "obftf")
    optimizer = build_optimizer(args.lr, args.steps)
    step_fn = make_train_step(Mdl.loss_fn(cfg), optimizer, obftf)
    params = materialize(Mdl.param_specs(cfg), args.seed,
                         Mdl.dtype_of(cfg.param_dtype), device)
    state = {
        "params": params,
        "opt": optimizer.init(params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }

    ckpt = CheckpointManager(args.ckpt_dir, keep=3) if args.ckpt_dir else None
    start_step = 0
    resume_ledger = None  # applied below, once the ledger exists
    if ckpt and args.resume:
        s = ckpt.latest() if args.resume == "auto" else int(args.resume)
        if s is not None:
            state = ckpt.restore(s, state)
            start_step = int(state["step"])
            resume_ledger = ckpt.restore_ledger(s)
            print(f"resumed from step {start_step}"
                  + (" (with ledger)" if resume_ledger is not None else ""))

    dcfg = DataConfig(args.global_batch, args.seq_len, cfg.vocab_size,
                      seed=args.seed)
    if args.instance_pool:
        if args.instance_pool % args.global_batch:
            raise SystemExit(
                f"--instance-pool {args.instance_pool} must be a multiple "
                f"of --global-batch {args.global_batch}"
            )
        dcfg = dataclasses.replace(dcfg, instance_pool=args.instance_pool)
    stream = SyntheticLMStream(dcfg)
    lcfg = HistoryConfig()
    use_device_ledger = args.recycle and args.ledger == "device"
    led_state = history = None
    feed = stream
    if use_device_ledger:
        led_state = dledger.init_state(lcfg, device)
        if args.ledger_in:
            led_state = dledger.load_state_dict(
                lcfg, dict(np.load(args.ledger_in)), device)
            print(f"ledger warm-start from {args.ledger_in} "
                  f"({int((led_state.owner >= 0).sum())} live slots)")
    else:
        history = LossHistory(lcfg)
        if args.ledger_in:
            history.load_state_dict(dict(np.load(args.ledger_in)))
            print(f"ledger warm-start from {args.ledger_in} "
                  f"({int((history.owner >= 0).sum())} live slots)")
        if args.recycle:
            feed = RecycleFeed(stream, history, ledger="host",
                               cold_loss=COLD_LOSS, policy=args.policy)
    if resume_ledger is not None:
        # the checkpoint's ledger wins over --ledger-in: it is the recycle
        # signal as of the resumed step
        if use_device_ledger:
            led_state = dledger.load_state_dict(lcfg, resume_ledger, device)
        else:
            history.load_state_dict(resume_ledger)
        live = int((np.asarray(resume_ledger["owner"]) >= 0).sum())
        print(f"ledger restored from checkpoint ({live} live slots)")

    def ledger_state_dict():
        if use_device_ledger:
            return dledger.state_dict_of(led_state)
        return history.state_dict()

    policy = get_policy(args.policy)

    def step_with_ledger(state, lstate, batch, noise):
        """Ledger probe -> OBFTF step -> ledger write, all on the device.
        Non-default policies score the ledger's channels in the step."""
        ids = batch["instance_id"]
        if policy.name == "loss_ema":
            ema, seen = dledger.lookup(lstate, ids)
            rec = torch.where(seen, ema, COLD_LOSS)
        else:
            ema, sig, seen = dledger.lookup_signals(lstate, ids)
            rec = policy_score(policy, ema, sig, seen, COLD_LOSS)
        state, metrics = step_fn(state, dict(batch, recorded_loss=rec), noise)
        # the step's TRUE per-example losses, written only where computed
        # this step (`fresh`: the kept subset under --recycle). The write
        # goes through record_priority, whose table equals record's; the
        # priorities are not needed here.
        lstate, _ = dledger.record_priority(
            lcfg, lstate, ids, metrics.pop("per_example_loss"),
            state["step"], valid=metrics.pop("per_example_fresh"),
        )
        del metrics["selected"]  # no [batch] arrays to the host
        metrics["ledger_hits"] = seen.to(torch.float32).mean()
        return state, lstate, metrics

    noise = GeneratorNoise(torch.Generator(device).manual_seed(args.seed))
    watchdog = Watchdog()
    stop = {"now": False}

    def _sigterm(signum, frame):
        print(f"signal {signum}: checkpoint + exit after this step")
        stop["now"] = True

    handlers = {s: signal.signal(s, _sigterm)
                for s in (signal.SIGTERM, signal.SIGINT)}
    losses_log, cost_log, hits_log, step_ms = [], [], [], []
    guarded_steps = 0
    moe.reset_routing_counts()

    # telemetry: bound once; each step updates them from the metrics it
    # has already read back, so nothing enters the guarded step. No
    # EMA-drift shadow here: the device-ledger step returns no per-example
    # arrays, so the loop-health gauges are rates only, as in the JAX
    # trainer
    c_steps = telem.counter("trainer.steps")
    c_straggler = telem.counter("trainer.stragglers")
    # one rank holds the single table and takes no exchange: bound for the
    # JAX names, stays 0
    telem.counter("trainer.a2a_overflow")
    g_loss = telem.gauge("trainer.loss")
    g_cost = telem.gauge("trainer.step_cost")
    g_savings = telem.gauge("trainer.step_cost_savings")
    g_hits = telem.gauge("trainer.ledger_hit_rate")
    h_step = telem.histogram("trainer.step_ms")

    def train_health() -> dict:
        steps_done = len(losses_log)
        return {
            "steps": steps_done,
            "loss": losses_log[-1] if losses_log else None,
            "step_cost": cost_log[-1] if cost_log else None,
            "step_cost_savings": (
                step_cost_savings(cost_log[-1]) if cost_log else None
            ),
            "mean_step_cost": float(np.mean(cost_log)) if cost_log else None,
            "ledger_hit_rate": hits_log[-1] if hits_log else None,
            "a2a_overflow_rate": 0.0,  # no routed exchange on one device
            "straggler_rate": obs.rate_of(watchdog.flagged, steps_done),
            "step_ms_ema": (watchdog.ema or 0.0) * 1e3,
        }

    try:
        for step in range(start_step, args.steps):
            t0 = time.time()
            raw = feed.batch(step)
            batch = {
                "tokens": torch.from_numpy(raw["tokens"]).to(device),
                "labels": torch.from_numpy(raw["labels"]).to(device),
            }
            if use_device_ledger:
                batch["instance_id"] = torch.from_numpy(
                    raw["instance_id"].astype(np.int32)).to(device)
            elif args.recycle:
                batch["recorded_loss"] = torch.from_numpy(
                    raw["recorded_loss"]).to(device)
            guard = device.type == "cuda" and step > start_step
            with telem.span("train.step", step=step), no_host_sync(guard):
                if use_device_ledger:
                    state, led_state, metrics = step_with_ledger(
                        state, led_state, batch, noise)
                else:
                    state, metrics = step_fn(state, batch, noise)
            guarded_steps += guard
            with telem.span("train.fetch_metrics"):
                metrics = _fetch(metrics)
            dt = time.time() - t0
            step_ms.append(dt * 1e3)
            slow = watchdog.observe(dt)
            if history is not None:
                # true per-example losses from the step's forwards, only
                # those computed THIS step
                fresh = np.asarray(metrics["per_example_fresh"], bool)
                if fresh.any():
                    history.record(raw["instance_id"][fresh],
                                   metrics["per_example_loss"][fresh], step)
            if use_device_ledger:
                hits_log.append(metrics["ledger_hits"])
            elif args.recycle:
                hits_log.append(float(raw.get("ledger_hit_rate", 0.0)))
            losses_log.append(metrics["loss"])
            cost_log.append(metrics["step_cost"])
            c_steps.inc()
            if slow:
                c_straggler.inc()
            g_loss.set(losses_log[-1])
            g_cost.set(cost_log[-1])
            g_savings.set(step_cost_savings(cost_log[-1]))
            h_step.observe(dt * 1e3)
            if hits_log:
                g_hits.set(hits_log[-1])
            if telem.events is not None and \
                    (step + 1) % args.metrics_every == 0:
                telem.event("loop_health", **train_health())
            if step % args.log_every == 0 or slow:
                print(
                    f"step {step:5d} loss={metrics['loss']:.4f} "
                    f"sel_resid={metrics['selection_residual']:.4f} "
                    f"kept={int(metrics['kept'])} "
                    f"gnorm={metrics['grad_norm']:.3f} {dt*1e3:.0f}ms"
                    + ("  [STRAGGLER]" if slow else "")
                )
            if ckpt and (step + 1) % args.ckpt_every == 0:
                ckpt.save(step + 1, state, ledger=ledger_state_dict())
            if stop["now"]:
                break
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)

    if ckpt:
        # the final (or SIGTERM) save carries the ledger too
        ckpt.save(int(state["step"]), state, block=True,
                  ledger=ledger_state_dict())
        print(f"final checkpoint at step {int(state['step'])}")
    if args.ledger_out:
        np.savez(args.ledger_out, **ledger_state_dict())
        print(f"ledger saved to {args.ledger_out} (global layout)")
    mean_cost = float(np.mean(cost_log)) if cost_log else 0.0
    print(f"done: {len(losses_log)} steps, "
          f"loss {losses_log[0]:.4f} -> {losses_log[-1]:.4f}, "
          f"step_cost {mean_cost:.3f}C, "
          f"stragglers flagged: {watchdog.flagged}")
    summary = {
        "steps": len(losses_log),
        "loss_first": losses_log[0],
        "loss_last": losses_log[-1],
        "mean_step_cost": mean_cost,
        "step_cost_savings": step_cost_savings(mean_cost),
        "method": args.method,
        "ratio": args.ratio,
        "recycle": bool(args.recycle),
        "policy": args.policy,
        "ledger": args.ledger,
        "exchange": (args.ledger_exchange if args.ledger_route
                     else "none"),
        "capacity_factor": args.capacity_factor,
        # of every MoE forward in the run, selection forwards included;
        # None where nothing was routed (no MoE layer)
        "moe_dropped_share": moe.dropped_share(),
        "a2a_overflow": 0,
        "stragglers": watchdog.flagged,
        "ledger_hits_first": hits_log[0] if hits_log else None,
        "ledger_hits_mean": float(np.mean(hits_log)) if hits_log else None,
        "health": train_health(),
        "device": str(device),
        "layers": cfg.num_layers,
        "guarded_steps": guarded_steps,
        "step_ms": step_ms,
    }
    if telem.registry is not None:
        summary["metrics"] = telem.snapshot()
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(summary, f)
    telem.close(summary=summary)
    return 0


if __name__ == "__main__":
    sys.exit(main())
