"""Train entry point of the port: OBFTF training on one device or
data-parallel over several ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
        --smoke --device cpu --steps 20 --method obftf --ratio 0.25
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --device cpu --model-parallel 1 --arch llama3-8b --smoke --steps 20
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --device cpu --model-parallel 2 --arch llama3-8b --smoke --steps 20

``repro.launch.train`` with its flags, printed lines and ``--json-out``
names, for every family (the vlm and audio archs
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
the capacity factor, with ``a2a_overflow`` 0.

On N ranks (``torchrun``, or a caller that set up the default group) the
mesh is JAX's (``launch.mesh``; NCCL between cards, gloo on the CPU):
``--model-parallel`` M ranks on the model axis (0, the default, picks JAX's
degree: the largest power of two at most min(16, N) dividing N) and N / M
on the data axis; ``--model-parallel 1`` puts every rank on the data
axis. Rank 0 prints the mesh as JAX's CLI prints it, ``mesh={'data': D,
'model': M}``.
  * the params are placed as the JAX trainer's ``state_specs`` places
    them (``distributed.zero``): drawn whole from the seed, then cut at
    once to this rank's model slice of every leaf whose spec names
    ``model`` (tensor parallelism: heads, kv heads, MLP columns, vocab
    rows, of the dense family) and its data slice of every leaf whose spec
    names ``data`` (FSDP), the others held whole, and the full copy freed;
    an earlier line prints each rank's param bytes;
  * each rank takes its data index's rows of the global batch
    (``data.local_rows``; the model ranks of a data row take the same) and
    runs ``make_train_step(mesh=)`` with an optimizer built on this rank's
    layout, under ``DEFAULT_RULES`` (no int8, as JAX's CLI): shard-local
    selection with its data row's draws (``fold_seed(seed, data index)``),
    every layer gathering its weights over the data axis as it runs and
    reduce-scattering their grads (ZeRO-3), the tensor-parallel regions'
    sums over the model axis, the whole params' grads all-reduced over the
    data axis, AdamW on the slices and on ZeRO-1 moment slices;
  * ``--ledger device`` shards the table over the data axis
    (``distributed.ledger.sharded_ledger_ops``, with the three routing
    flags; the model ranks of a data row hold equal replicas of its slice
    and make the same writes); ``--ledger host`` keeps the same
    ``LossHistory`` on every rank, fed the all-gathered per-example
    losses;
  * every rank makes the same collective calls; a stop signal on any rank
    is agreed at the end of the step, so all ranks stop after the same
    step; rank 0 alone prints and writes ``--json-out``, ``--metrics-out``,
    ``--trace-out``, ``--ledger-out`` and the checkpoints (saving gathers
    the param and moment slices; a checkpoint resumes on any number of
    ranks).
A model axis that does not divide the ranks refuses before any group is
set up, with JAX's message, and so does a model axis above 1 for the
families whose tensor parallelism is not ported (moe, ssm, hybrid and
MLA's deepseek-v2-236b; ROADMAP Queue 1 item 2).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
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
    fold_seed,
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
from repro_torch.data import (
    DataConfig,
    RecycleFeed,
    SyntheticLMStream,
    local_rows,
)
from repro_torch.distributed import compat
from repro_torch.distributed.ledger import sharded_ledger_ops
from repro_torch.distributed.sharding import DEFAULT_RULES
from repro_torch.distributed.zero import data_layout
from repro_torch.launch.mesh import (
    make_elastic_mesh,
    model_degree,
    validate_batch,
    world_size,
)
from repro_torch.models import model as Mdl
from repro_torch.models import moe
from repro_torch.models.params import materialize, tree_leaves
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


def build_optimizer(lr: float, total_steps: int, layout=None):
    """The optimizer of ``repro.launch.specs.state_specs``: AdamW (weight
    decay 0.1, clip 1.0) on a warmup-cosine schedule; ``layout`` (a
    ``distributed.zero.DataLayout``) places its state over the data axis
    as ``state_specs`` places it on a mesh: the moments sliced, and the
    params as the layout holds them."""
    warmup = min(2000, max(1, total_steps // 10))
    return adamw(warmup_cosine(lr, warmup, total_steps),
                 AdamWConfig(weight_decay=0.1), layout=layout)


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
    ap.add_argument("--model-parallel", type=int, default=0,
                    help="the mesh's model axis (tensor parallelism of the "
                         "dense family): 0 picks JAX's degree, the largest "
                         "power of two <= min(16, ranks) dividing the "
                         "ranks; 1 gives a data axis of every rank")
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


def _refuse_model_axis(model_parallel: int, ranks: int, cfg) -> None:
    """Refuse, before any group is set up, a model axis that does not
    divide the ranks (JAX's message) and one above 1 that
    ``models.model.tensor_parallel_refusal`` refuses for the config."""
    if model_parallel > 0 and ranks % model_parallel:
        raise SystemExit(f"--model-parallel {model_parallel}: {ranks} "
                         f"devices not divisible by TP={model_parallel}")
    why = Mdl.tensor_parallel_refusal(cfg, model_degree(ranks,
                                                        model_parallel))
    if why is not None:
        raise SystemExit(f"--model-parallel {model_parallel} on {ranks} "
                         f"ranks: {why}; pass --model-parallel 1 to train "
                         "it data-parallel")


def _gather_per_example(metrics: dict) -> dict:
    """The per-example arrays of every data rank's segment, in rank
    order: the global arrays the JAX trainer's ``device_get`` sees (one
    gather over the data axis)."""
    row = torch.stack([metrics["per_example_loss"],
                       metrics["per_example_fresh"].to(torch.float32)], 1)
    g = compat.all_gather(row, compat.DATA)
    return dict(metrics, per_example_loss=g[:, 0],
                per_example_fresh=g[:, 1] > 0)


def _say_param_bytes(say, params, layout, device) -> None:
    """Print every rank's param bytes, in rank order, against the whole
    tree's (a gather over each axis)."""
    leaves = tree_leaves(params)
    mine = sum(x.numel() * x.element_size() for x in leaves)
    whole = sum(math.prod(s) * x.element_size()
                for x, s in zip(leaves, tree_leaves(layout.shapes)))
    col = compat.all_gather(torch.tensor([mine], dtype=torch.int64,
                                         device=device), compat.DATA)
    # [model, data] -> rank order, data index * M + model index
    per = compat.all_gather(col[None], compat.MODEL).T.reshape(-1).tolist()
    say(f"params a rank (bytes): {per} of {whole} whole "
        f"({sum(layout.held_mask())} of {len(leaves)} leaves sliced over "
        f"{layout.shards} ranks"
        + (f", {sum(layout.model_mask())} cut over a model axis of "
           f"{layout.model_shards}" if layout.model_shards > 1 else "")
        + ")")


def main(argv=None) -> int:
    args = parse_args(argv)
    ranks = world_size()
    _refuse_model_axis(args.model_parallel, ranks,
                       configs.get(args.arch, args.smoke, args.layers))
    mesh = None
    if ranks > 1:
        mesh = make_elastic_mesh(model_parallel=args.model_parallel,
                                 device=args.device)
    try:
        return _train(args, mesh)
    finally:
        if mesh is not None:
            mesh.close()


def _train(args, mesh) -> int:
    rules = DEFAULT_RULES
    if mesh is None:
        device, rank, shards = torch.device(args.device), 0, 1
        local_batch = args.global_batch
        lead = True
    else:
        # the batch, the draws and the ledger go by the data axis
        device, rank = mesh.device, mesh.data_index
        shards = mesh.shape["data"]
        local_batch = validate_batch(args.global_batch, mesh,
                                     rules.batch_axes)
        lead = mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    cfg = configs.get(args.arch, args.smoke, args.layers)
    if lead:
        telem = obs.from_args(args)
    else:  # the same instruments, no files
        telem = obs.install(obs.Telemetry(
            enabled=bool(args.metrics_out or args.trace_out)))
    say(
        f"arch={cfg.name} layers={cfg.num_layers} device={device} "
        + ("" if mesh is None else
           f"ranks={mesh.size} mesh={mesh.shape} backend={mesh.backend} ")
        + f"global_batch={args.global_batch} (x{local_batch}/shard) "
        f"method={args.method} ratio={args.ratio}"
    )

    sel = SelectionConfig(method=args.method, ratio=args.ratio)
    obftf = OBFTFConfig(selection=sel, recycle_forward=args.recycle,
                        mode="full" if args.method == "full" else "obftf")
    specs = Mdl.param_specs(cfg)
    layout = (None if mesh is None else
              data_layout(specs, mesh, rank, rules, mesh.model_index))
    optimizer = build_optimizer(args.lr, args.steps, layout)
    step_fn = make_train_step(Mdl.loss_fn(cfg), optimizer, obftf, mesh=mesh,
                              dp_axes=rules.batch_axes)
    params = materialize(specs, args.seed, Mdl.dtype_of(cfg.param_dtype),
                         device)
    if layout is not None:
        params = layout.hold(params)  # the full tree is freed here
        _say_param_bytes(say, params, layout, device)
    state = {
        "params": params,
        "opt": optimizer.init(params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }

    ckpt = (CheckpointManager(args.ckpt_dir, keep=3, layout=layout)
            if args.ckpt_dir else None)
    start_step = 0
    resume_ledger = None  # applied below, once the ledger exists
    if ckpt and args.resume:
        s = ckpt.latest() if args.resume == "auto" else int(args.resume)
        if s is not None:
            state = ckpt.restore(s, state)
            start_step = int(state["step"])
            resume_ledger = ckpt.restore_ledger(s)
            say(f"resumed from step {start_step}"
                + (" (with ledger)" if resume_ledger is not None else ""))

    dcfg = DataConfig(args.global_batch, args.seq_len, cfg.vocab_size,
                      seed=args.seed)
    if args.instance_pool:
        if args.instance_pool % args.global_batch:
            # keeps each id at a fixed batch offset across pool wraps: the
            # id -> rank pinning the pinned sharded ledger relies on
            raise SystemExit(
                f"--instance-pool {args.instance_pool} must be a multiple "
                f"of --global-batch {args.global_batch}"
            )
        dcfg = dataclasses.replace(dcfg, instance_pool=args.instance_pool)
    stream = SyntheticLMStream(dcfg)
    lcfg = HistoryConfig()
    use_device_ledger = args.recycle and args.ledger == "device"
    led_state = history = led_ops = None
    feed = stream

    def load_device_sd(sd):
        if led_ops is not None:
            return led_ops.load_state_dict(sd)
        return dledger.load_state_dict(lcfg, sd, device)

    def live_slots() -> int:
        n = (led_state.owner >= 0).sum()
        return int(n if led_ops is None
                   else compat.all_reduce_sum(n, compat.DATA))

    if use_device_ledger:
        if mesh is None:
            led_state = dledger.init_state(lcfg, device)
        else:
            led_ops = sharded_ledger_ops(
                mesh, lcfg, rules.batch_axes, route=args.ledger_route,
                exchange=args.ledger_exchange,
                capacity_factor=args.capacity_factor)
            led_state = led_ops.init()
        if args.ledger_in:
            led_state = load_device_sd(dict(np.load(args.ledger_in)))
            n_live = live_slots()
            say(f"ledger warm-start from {args.ledger_in} "
                f"({n_live} live slots)")
    else:
        history = LossHistory(lcfg)
        if args.ledger_in:
            history.load_state_dict(dict(np.load(args.ledger_in)))
            say(f"ledger warm-start from {args.ledger_in} "
                f"({int((history.owner >= 0).sum())} live slots)")
        if args.recycle:
            feed = RecycleFeed(stream, history, ledger="host",
                               cold_loss=COLD_LOSS, policy=args.policy)
    if resume_ledger is not None:
        # the checkpoint's ledger wins over --ledger-in: it is the recycle
        # signal as of the resumed step
        if use_device_ledger:
            led_state = load_device_sd(resume_ledger)
        else:
            history.load_state_dict(resume_ledger)
        live = int((np.asarray(resume_ledger["owner"]) >= 0).sum())
        say(f"ledger restored from checkpoint ({live} live slots)")

    def ledger_state_dict():
        """The ledger's state_dict (a collective on a sharded table: every
        rank calls it)."""
        if use_device_ledger:
            if led_ops is not None:
                return led_ops.state_dict(led_state)
            return dledger.state_dict_of(led_state)
        return history.state_dict()

    policy = get_policy(args.policy)
    a2a_record = (led_ops is not None and led_ops.route
                  and led_ops.exchange == "a2a")

    def step_with_ledger(state, lstate, batch, noise):
        """Ledger probe -> OBFTF step -> ledger write, all on the device.
        Non-default policies score the ledger's channels in the step."""
        ids = batch["instance_id"]
        lookup = dledger if led_ops is None else led_ops
        if policy.name == "loss_ema":
            ema, seen = lookup.lookup(lstate, ids)
            rec = torch.where(seen, ema, COLD_LOSS)
        else:
            ema, sig, seen = lookup.lookup_signals(lstate, ids)
            rec = policy_score(policy, ema, sig, seen, COLD_LOSS)
        state, metrics = step_fn(state, dict(batch, recorded_loss=rec), noise)
        # the step's TRUE per-example losses, written only where computed
        # this step (`fresh`: the kept subset under --recycle). The write
        # goes through record_priority, whose table equals record's and
        # whose write is the ledger kernel on the card; the priorities are
        # not needed here. The a2a exchange writes through `record`, as
        # the JAX trainer does (its a2a_overflow counts the valid items).
        losses = metrics.pop("per_example_loss")
        valid = metrics.pop("per_example_fresh")
        hits = seen.to(torch.float32).sum()
        if led_ops is None:
            lstate, _ = dledger.record_priority(
                lcfg, lstate, ids, losses, state["step"], valid=valid)
            ovf = torch.zeros((), dtype=torch.int32, device=device)
        else:
            if a2a_record:
                lstate, lstats = led_ops.record(
                    lstate, ids, losses, state["step"], valid,
                    return_stats=True)
            else:
                lstate, _, lstats = led_ops.record_priority(
                    lstate, ids, losses, state["step"], valid,
                    return_stats=True)
            ovf = lstats["a2a_overflow"]
            hits = compat.all_reduce_sum(hits, compat.DATA)
        del metrics["selected"]  # no [batch] arrays to the host
        metrics["ledger_hits"] = hits / args.global_batch
        metrics["a2a_overflow"] = ovf
        return state, lstate, metrics

    # shard-local selection draws its data row's own numbers (JAX's
    # fold_in(rng, data index)); one rank keeps the run's seed
    noise = GeneratorNoise(torch.Generator(device).manual_seed(
        args.seed if mesh is None else fold_seed(args.seed, rank)))
    watchdog = Watchdog()
    stop = {"now": False}

    def _sigterm(signum, frame):
        print(f"signal {signum}: checkpoint + exit after this step"
              + ("" if mesh is None else f" (rank {mesh.rank})"))
        stop["now"] = True

    handlers = {s: signal.signal(s, _sigterm)
                for s in (signal.SIGTERM, signal.SIGINT)}
    losses_log, cost_log, hits_log, step_ms = [], [], [], []
    guarded_steps = 0
    a2a_overflow = 0  # items that took the a2a residual round
    moe.reset_routing_counts()

    # telemetry: bound once; each step updates them from the metrics it
    # has already read back, so nothing enters the guarded step. No
    # EMA-drift shadow here: the device-ledger step returns no per-example
    # arrays, so the loop-health gauges are rates only, as in the JAX
    # trainer
    c_steps = telem.counter("trainer.steps")
    c_straggler = telem.counter("trainer.stragglers")
    c_overflow = telem.counter("trainer.a2a_overflow")
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
            "a2a_overflow_rate": obs.rate_of(a2a_overflow, steps_done),
            "straggler_rate": obs.rate_of(watchdog.flagged, steps_done),
            "step_ms_ema": (watchdog.ema or 0.0) * 1e3,
        }

    # a gloo group on a card stages every collective through host memory,
    # which the sync guard would refuse: only NCCL steps run guarded
    staged = mesh is not None and compat.host_staged()
    try:
        for step in range(start_step, args.steps):
            t0 = time.time()
            raw = feed.batch(step)  # the global batch, on every rank
            mine = raw if mesh is None else local_rows(raw, rank, shards)
            batch = {
                "tokens": torch.from_numpy(mine["tokens"]).to(device),
                "labels": torch.from_numpy(mine["labels"]).to(device),
            }
            if use_device_ledger:
                batch["instance_id"] = torch.from_numpy(
                    mine["instance_id"].astype(np.int32)).to(device)
            elif args.recycle:
                batch["recorded_loss"] = torch.from_numpy(
                    mine["recorded_loss"]).to(device)
            guard = (device.type == "cuda" and step > start_step
                     and not staged)
            with telem.span("train.step", step=step), no_host_sync(guard):
                if use_device_ledger:
                    state, led_state, metrics = step_with_ledger(
                        state, led_state, batch, noise)
                else:
                    state, metrics = step_fn(state, batch, noise)
            guarded_steps += guard
            with telem.span("train.fetch_metrics"):
                if history is not None and mesh is not None:
                    metrics = _gather_per_example(metrics)
                metrics = _fetch(metrics)
            dt = time.time() - t0
            step_ms.append(dt * 1e3)
            slow = watchdog.observe(dt)
            if history is not None:
                # true per-example losses from the step's forwards, only
                # those computed THIS step (the global arrays on every
                # rank, so every rank's feed draws the same next batch)
                fresh = np.asarray(metrics["per_example_fresh"], bool)
                if fresh.any():
                    history.record(raw["instance_id"][fresh],
                                   metrics["per_example_loss"][fresh], step)
            if use_device_ledger:
                hits_log.append(metrics["ledger_hits"])
                a2a_overflow += int(metrics["a2a_overflow"])
                c_overflow.inc(int(metrics["a2a_overflow"]))
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
                say(
                    f"step {step:5d} loss={metrics['loss']:.4f} "
                    f"sel_resid={metrics['selection_residual']:.4f} "
                    f"kept={int(metrics['kept'])} "
                    f"gnorm={metrics['grad_norm']:.3f} {dt*1e3:.0f}ms"
                    + ("  [STRAGGLER]" if slow else "")
                )
            if ckpt and (step + 1) % args.ckpt_every == 0:
                ckpt.save(step + 1, state, ledger=ledger_state_dict())
            # a stop on any rank stops every rank after this step
            if (stop["now"] if mesh is None
                    else compat.any_rank(stop["now"], device)):
                break
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)

    if ckpt:
        # the final (or SIGTERM) save carries the ledger too
        ckpt.save(int(state["step"]), state, block=True,
                  ledger=ledger_state_dict())
        say(f"final checkpoint at step {int(state['step'])}")
    if args.ledger_out:
        sd = ledger_state_dict()
        if lead:
            np.savez(args.ledger_out, **sd)
        layout_name = "pinned-sharded" if "pinned_shards" in sd else "global"
        say(f"ledger saved to {args.ledger_out} ({layout_name} layout)")
    mean_cost = float(np.mean(cost_log)) if cost_log else 0.0
    say(f"done: {len(losses_log)} steps, "
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
        "a2a_overflow": a2a_overflow,
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
    if args.json_out and lead:
        with open(args.json_out, "w") as f:
            json.dump(summary, f)
    telem.close(summary=summary)
    return 0


if __name__ == "__main__":
    sys.exit(main())
