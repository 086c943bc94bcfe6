"""Outcome recording for the serving engine: late labels -> ledger records.

The PyTorch counterpart of ``repro.serving.recorder`` (see its module doc
for the retention modes and their guarantees). Per slot and generated
position the recorder retains either

* ``retention="topk"`` — ``(top-k values, top-k indices, exact lse)``,
  computed inside the fused decode step by ``kernels.ops.topk_lse`` (the
  hand-written CUDA kernel on the card); constant size in V. A late label
  is scored exactly on a top-k hit and at the tail floor
  ``lse - min(topk)`` on a miss; or
* ``retention="full"`` — the dense logits row (the exact oracle),

plus the labels (-1 = unknown) and which positions were scored. Each fused
step scores at most one position per slot, the oldest labeled-but-unscored
one, and records it into the device ledger (``ledger="device"``, inside the
step, nothing read back to the host) or hands it to a host ``LossHistory``
(``ledger="host"``). With a ``mesh`` (``launch.mesh``: one rank a device,
each rank running the same engine) the device table is sharded over the
ranks (``distributed.ledger``) and each rank records its segment of the
slots, as each JAX shard records its segment.

State tensors are updated in place (the JAX version returns new arrays and
donates the old ones); the ledger table is replaced by each record.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import device_ledger as dledger
from repro_torch.core.history import HistoryConfig, LossHistory
from repro_torch.core.scatter import put_rows
from repro_torch.distributed.ledger import ShardedLedgerOps, sharded_ledger_ops
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import Mesh

I32 = torch.int32
F32 = torch.float32

LEDGERS = ("host", "device")
RETENTIONS = ("full", "topk")


def topk_score(
    vals: torch.Tensor, idx: torch.Tensor, lse: torch.Tensor,
    labels: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Score labels against (top-k, lse) summaries -> (loss, hit): exact
    ``lse - logit[label]`` on a hit, the tail floor ``lse - min(topk)`` (a
    lower bound of the true loss) on a miss. Negative labels never hit."""
    inset = idx == labels[..., None]
    hit = inset.any(dim=-1) & (labels >= 0)
    v = vals.to(F32)
    picked = torch.where(inset, v, 0.0).sum(dim=-1)
    tail = v.amin(dim=-1)
    return lse.to(F32) - torch.where(hit, picked, tail), hit


def topk_signals(
    vals: torch.Tensor, lse: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(entropy, margin) from a (top-k values sorted descending, exact lse)
    summary: the retained terms of the entropy plus the tail mass at the
    tail floor (a lower bound, exact when K = V), and the top-1/top-2 gap
    (0 when K < 2)."""
    v = vals.to(F32)
    lse = lse.to(F32)
    p = torch.exp(v - lse[..., None])
    p_tail = torch.clamp(1.0 - p.sum(dim=-1), min=0.0)
    entropy = (p * (lse[..., None] - v)).sum(dim=-1) + p_tail * (
        lse - v.amin(dim=-1)
    )
    if v.shape[-1] < 2:
        margin = torch.zeros_like(lse)
    else:
        margin = v[..., 0] - v[..., 1]
    return entropy, margin


def full_signals(
    logits: torch.Tensor, lse: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact (entropy, margin) from dense logits [..., V]."""
    x = logits.to(F32)
    lse = lse.to(F32)
    entropy = lse - (torch.softmax(x, dim=-1) * x).sum(dim=-1)
    if x.shape[-1] < 2:
        margin = torch.zeros_like(lse)
    else:
        top2 = torch.topk(x, 2, dim=-1).values
        margin = top2[..., 0] - top2[..., 1]
    return entropy, margin


@dataclasses.dataclass
class RecorderState:
    """Device state of the outcome recorder. The fields of the other
    retention mode are None."""

    ledger: Optional[dledger.LedgerState]  # None for ledger="host"
    logits: Optional[torch.Tensor]  # [S, G, V] (retention="full")
    topk_vals: Optional[torch.Tensor]  # [S, G, K] f32 (retention="topk")
    topk_idx: Optional[torch.Tensor]  # [S, G, K] i32
    lse: Optional[torch.Tensor]  # [S, G] f32
    labels: torch.Tensor  # [S, G] i32, -1 = unknown
    scored: torch.Tensor  # [S, G] bool
    n_recorded: torch.Tensor  # [] i32: ledger records made
    n_miss: torch.Tensor  # [] i32: topk records clamped to the tail floor


class OutcomeRecorder:
    """Owns the ledger placement and the scoring/record functions.

    ``ledger="device"`` keeps the table as tensors on ``device`` and
    records inside the fused step; with a ``mesh`` the table is sharded
    over its ranks (``route=True`` adds the cross-rank exchange, realized
    by ``exchange`` with ``capacity_factor``) and the mesh's device is the
    recorder's. ``ledger="host"`` keeps a numpy ``LossHistory`` the engine
    records the step's rows into. ``retention`` picks the retained layout.
    """

    def __init__(
        self,
        slots: int,
        max_gen: int,
        vocab: int,
        cfg: HistoryConfig = HistoryConfig(),
        *,
        ledger: str = "device",
        mesh: Optional[Mesh] = None,
        dp_axes: Sequence[str] = ("data",),
        route: bool = False,
        exchange: str = "gather",
        capacity_factor: float = 1.25,
        retention: str = "full",
        topk: int = 64,
        device: torch.device | str = "cuda",
    ):
        if ledger not in LEDGERS:
            raise ValueError(f"ledger {ledger!r} not in {LEDGERS}")
        if retention not in RETENTIONS:
            raise ValueError(f"retention {retention!r} not in {RETENTIONS}")
        self.slots = slots
        self.max_gen = max_gen
        self.vocab = vocab
        self.cfg = cfg
        self.ledger = ledger
        self.retention = retention
        self.topk = min(int(topk), vocab)
        if self.topk <= 0:
            raise ValueError(f"topk must be positive, got {topk}")
        self.device = torch.device(device) if mesh is None else mesh.device
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.ops: Optional[ShardedLedgerOps] = None
        if ledger == "device" and mesh is not None:
            self.ops = sharded_ledger_ops(
                mesh, cfg, dp_axes, route=route, exchange=exchange,
                capacity_factor=capacity_factor,
            )
            if slots % self.ops.shards:
                raise ValueError(
                    f"engine slots {slots} not divisible by "
                    f"{self.ops.shards} ledger shards"
                )
        self.host_history: Optional[LossHistory] = (
            LossHistory(cfg) if ledger == "host" else None
        )

    @property
    def route(self) -> bool:
        return self.ops is not None and self.ops.route

    def retained_bytes_per_slot(self) -> int:
        """Device bytes of one slot's retained outcomes (labels/scored
        bookkeeping excluded — identical across modes)."""
        g = self.max_gen
        if self.retention == "full":
            return g * self.vocab * 4  # f32 logits
        return g * (self.topk * (4 + 4) + 4)

    def _summarize(self, logits: torch.Tensor):
        """[T, V] -> (vals [T,K], idx [T,K], lse [T]) via the kernel, which
        reads the logits in their own dtype (bf16 -> f32 is exact)."""
        return kops.topk_lse(logits, self.topk)

    # -- state ---------------------------------------------------------------

    def replicate(self, tree):
        """Place every tensor of ``tree`` (tensors in dicts, lists, tuples
        and dataclasses) on the mesh's device (sharded recorders only; an
        unsharded recorder returns the tree as it is, as the JAX recorder
        does). Under one rank a device this is what the JAX recorder's
        mesh-replicated placement comes to: the engine routes its params,
        its state and each host-made row through here before they meet the
        guarded step."""
        if self.ops is None:
            return tree
        if isinstance(tree, torch.Tensor):
            return tree.to(self.device)
        if isinstance(tree, dict):
            return {k: self.replicate(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.replicate(v) for v in tree)
        if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
            return dataclasses.replace(tree, **{
                f.name: self.replicate(getattr(tree, f.name))
                for f in dataclasses.fields(tree)})
        return tree

    def init_state(self) -> RecorderState:
        s, g, v, k = self.slots, self.max_gen, self.vocab, self.topk
        dev = self.device
        full = self.retention == "full"
        if self.ledger == "host":
            led = None
        elif self.ops is not None:
            led = self.ops.init()
        else:
            led = dledger.init_state(self.cfg, dev)
        return RecorderState(
            ledger=led,
            logits=torch.zeros((s, g, v), dtype=F32, device=dev)
            if full else None,
            topk_vals=None if full
            else torch.zeros((s, g, k), dtype=F32, device=dev),
            topk_idx=None if full
            else torch.full((s, g, k), -1, dtype=I32, device=dev),
            lse=None if full else torch.zeros((s, g), dtype=F32, device=dev),
            labels=torch.full((s, g), -1, dtype=I32, device=dev),
            scored=torch.zeros((s, g), dtype=torch.bool, device=dev),
            n_recorded=torch.zeros((), dtype=I32, device=dev),
            n_miss=torch.zeros((), dtype=I32, device=dev),
        )

    def clear_slot(
        self, state: RecorderState, slot: int, logits0: torch.Tensor,
        labels_row: torch.Tensor,
    ) -> RecorderState:
        """Reset a slot at admission; position 0's outcome comes from the
        prefill logits ``logits0`` [V]."""
        if self.retention == "full":
            state.logits[slot] = 0
            state.logits[slot, 0] = logits0.to(F32)
        else:
            v0, i0, l0 = self._summarize(logits0[None])
            state.topk_vals[slot] = 0
            state.topk_idx[slot] = -1
            state.lse[slot] = 0
            state.topk_vals[slot, 0] = v0[0]
            state.topk_idx[slot, 0] = i0[0]
            state.lse[slot, 0] = l0[0]
        state.labels[slot] = labels_row.to(I32)
        state.scored[slot] = False
        return state

    def observe(
        self, state: RecorderState, gen_idx: torch.Tensor,
        logits: torch.Tensor, writing: torch.Tensor,
    ) -> RecorderState:
        """Retain this step's outcome summary at [slot, gen_idx] where
        ``writing``; the other rows write nothing."""
        bidx = torch.arange(self.slots, device=logits.device)
        flat = bidx * self.max_gen + gen_idx.long()
        if self.retention == "full":
            put_rows(state.logits.view(-1, self.vocab), flat,
                     logits.to(F32), writing)
            return state
        vals, idx, lse = self._summarize(logits)
        put_rows(state.topk_vals.view(-1, self.topk), flat, vals, writing)
        put_rows(state.topk_idx.view(-1, self.topk), flat, idx, writing)
        put_rows(state.lse.view(-1), flat, lse, writing)
        return state

    def deliver(
        self, state: RecorderState, slot: int, labels_row: torch.Tensor
    ) -> RecorderState:
        """Write late labels for a slot (-1 entries keep the existing
        value — partial outcomes may arrive in pieces)."""
        row = labels_row.to(I32)
        state.labels[slot] = torch.where(row >= 0, row, state.labels[slot])
        return state

    def score_one(
        self,
        state: RecorderState,
        inst: torch.Tensor,  # [S] i32, -1 = free slot
        produced: torch.Tensor,  # [S] generated positions retained
        step: torch.Tensor,  # [] i32 ledger record step
    ) -> tuple[RecorderState, dict[str, torch.Tensor]]:
        """Score the oldest labeled-but-unscored position of every slot and
        record it. Returns the state and {loss, entropy, margin, valid,
        pending, miss} per slot and ``a2a_overflow``, the group's count of
        records that took the a2a residual round (see
        ``repro.serving.recorder``). A sharded recorder records this rank's
        segment of the slots."""
        s, g = self.slots, self.max_gen
        dev = inst.device
        bidx = torch.arange(s, device=dev)
        giota = torch.arange(g, device=dev)[None, :]
        unscored = (state.labels >= 0) & ~state.scored
        cand = unscored & (giota < produced[:, None])
        has = cand.any(dim=1)
        pos = torch.argmax(cand.to(I32), dim=1)  # first True (0 if none)
        sel_label = state.labels[bidx, pos]
        if self.retention == "full":
            sel_logits = state.logits[bidx, pos].to(F32)
            lse = torch.logsumexp(sel_logits, dim=-1)
            picked = sel_logits.gather(
                1, sel_label.clamp(min=0).long()[:, None])[:, 0]
            loss = lse - picked
            hit = torch.ones((s,), dtype=torch.bool, device=dev)
            entropy, margin = full_signals(sel_logits, lse)
        else:
            sel_vals = state.topk_vals[bidx, pos]
            sel_lse = state.lse[bidx, pos]
            loss, hit = topk_score(sel_vals, state.topk_idx[bidx, pos],
                                   sel_lse, sel_label)
            entropy, margin = topk_signals(sel_vals, sel_lse)
        signals = torch.stack([entropy, margin], dim=-1)  # AUX_CHANNELS
        valid = has & (inst >= 0)
        miss = valid & ~hit
        put_rows(state.scored.view(-1), bidx * g + pos,
                 torch.ones_like(valid), valid)
        a2a_overflow = torch.zeros((), dtype=I32, device=dev)
        if self.ops is not None:
            n = s // self.ops.shards
            seg = slice(self.ops.rank * n, (self.ops.rank + 1) * n)
            state.ledger, lstats = self.ops.record(
                state.ledger, inst[seg], loss[seg], step, valid[seg],
                signals=signals[seg], return_stats=True,
            )
            a2a_overflow = lstats["a2a_overflow"]
        elif state.ledger is not None:
            state.ledger = dledger.record(
                self.cfg, state.ledger, inst, loss, step, valid=valid,
                signals=signals,
            )
        state.n_recorded += valid.sum().to(I32)
        state.n_miss += miss.sum().to(I32)
        pending = (
            (state.labels >= 0) & ~state.scored & (giota < produced[:, None])
        ).any(dim=1)
        return state, {
            "loss": loss, "entropy": entropy, "margin": margin,
            "valid": valid, "pending": pending, "miss": miss,
            "a2a_overflow": a2a_overflow,
        }

    # -- host interchange ----------------------------------------------------

    def record_host(self, ids, losses, valid, step: int, signals=None) -> None:
        """The ledger="host" record (host side, numpy)."""
        v = np.asarray(valid, bool)
        if v.any():
            with obs.span("recorder.record_host", n=int(v.sum())):
                self.host_history.record(
                    np.asarray(ids, np.int64)[v], np.asarray(losses)[v],
                    step, signals=None if signals is None
                    else np.asarray(signals, np.float32)[v],
                )

    def counters(self, state: RecorderState) -> tuple[int, int]:
        """(n_recorded, n_miss) in one device read."""
        n_rec, n_miss = torch.stack([state.n_recorded, state.n_miss]).tolist()
        return int(n_rec), int(n_miss)

    def state_dict(self, state: RecorderState) -> dict[str, np.ndarray]:
        """The ledger's interchange dict; collective on a sharded recorder
        (every rank calls it and gets the global layout)."""
        if self.ledger == "host":
            return self.host_history.state_dict()
        if self.ops is not None:
            return self.ops.state_dict(state.ledger)
        return dledger.state_dict_of(state.ledger)

    def load_state_dict(
        self, state: RecorderState, sd: dict[str, np.ndarray]
    ) -> RecorderState:
        if self.ledger == "host":
            self.host_history.load_state_dict(sd)
        elif self.ops is not None:
            state.ledger = self.ops.load_state_dict(sd)
        else:
            state.ledger = dledger.load_state_dict(self.cfg, sd, self.device)
        return state
