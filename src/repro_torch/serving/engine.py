"""Continuous-batching serving engine with fused outcome recording.

The PyTorch counterpart of ``repro.serving.engine`` (see its module doc): a
fixed batch of ``slots`` that requests flow through —

* **admission**: a queued request takes a free slot; its prompt is
  prefilled at batch 1 (right-padded to a length bucket where the family
  allows it, at its exact length otherwise), and the cache is written into
  the slot's row (dense) or the slot's pages (paged);
* **decode**: ONE fused step advances every occupied slot by one token at
  its own depth, retains the outcome summary, and lets the
  :class:`~repro_torch.serving.recorder.OutcomeRecorder` score and record
  the oldest labeled-but-unscored position of each slot into the device
  ledger. The step reads nothing back to the host: on the card it runs
  under ``torch.cuda.set_sync_debug_mode("error")`` once warm (the twin of
  the JAX engine's ``jax.transfer_guard("disallow")``);
* **eviction**: a slot frees when its generation finished and its outcome
  backlog drained.

Instance ids are stable and monotone (0, 1, 2, ... unless the caller
gives its own).
Sampling at ``temperature > 0`` draws Gumbel noise from a stateless hash of
(seed, instance id, generated position, token), so tokens depend neither on
the slot nor on the schedule. The JAX engine's threefry lanes cannot be
reproduced in PyTorch; the two engines agree at temperature 0.

Control plane (queue, admission, eviction, page accounting) is host Python
between steps; the data plane is the fused step, which updates the engine's
tensors in place.

Telemetry (``repro_torch.obs``, the JAX engine's names): the instruments
are bound once in ``__init__`` and updated from the metrics ``step()``
reads back after the fused step, so nothing is added inside the guarded
step; spans time admission, prefill, the fused step, the metrics read,
deliveries and eviction fetches on the host clock; ``loop_health`` gives
the loop's rates, and on a device-ledger run with telemetry on, the EMA
drift of the device ledger against a host ``LossHistory`` fed the rows
each step read back.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.core.device_ledger import mul32
from repro_torch.core.guard import no_host_sync
from repro_torch.core.history import AUX_CHANNELS, LossHistory
from repro_torch.core.scatter import put_rows
from repro_torch.models import model as Mdl
from repro_torch.models.config import ModelConfig
from repro_torch.serving.pages import PagePool, pages_for
from repro_torch.serving.recorder import OutcomeRecorder, RecorderState

I32 = torch.int32
_MASK32 = 0xFFFFFFFF

# families where a right-padded prompt cannot perturb real positions
_PAD_SAFE_FAMILIES = ("dense", "vlm", "audio")


def pad_safe(cfg: ModelConfig) -> bool:
    return cfg.family in _PAD_SAFE_FAMILIES and cfg.sliding_window is None


@dataclasses.dataclass
class Request:
    """One serving request. ``labels`` may come now or later through
    ``Engine.deliver_outcome``; ``expect_labels`` holds the slot open after
    generation until they arrive."""

    prompt: np.ndarray
    max_new: int
    instance_id: int
    labels: Optional[np.ndarray] = None
    expect_labels: bool = False


@dataclasses.dataclass
class EngineState:
    """Per-slot device state. ``inst == -1`` marks a free slot."""

    cache: Any  # model decode cache, batch dim = slots
    cur_tok: torch.Tensor  # [S, 1] next input token
    pos: torch.Tensor  # [S] tokens already in the cache
    gen_idx: torch.Tensor  # [S] generated positions produced so far
    inst: torch.Tensor  # [S] instance id, -1 = free
    max_new: torch.Tensor  # [S]
    out_toks: torch.Tensor  # [S, G] generated tokens
    step: torch.Tensor  # [] i32 decode-step counter (= ledger step)
    page_table: Optional[torch.Tensor] = None  # [S, NP] i32 (paged mode)


def _cache_batch_axis(cfg: ModelConfig, key: str) -> int:
    # the hybrid stacks its SSM blocks [groups, every, batch, ...];
    # everything else is [layers, batch, ...]
    return 2 if (cfg.family == "hybrid" and key == "blocks") else 1


def insert_cache_slot(
    cfg: ModelConfig, cache: dict, new: dict, slot: int
) -> dict:
    """Write a batch-1 prefill cache into row ``slot`` of the batch cache
    (the batch dim is 1 for [L, B, ...] leaves and 2 for the hybrid's
    [groups, every, B, ...] SSM stack), in place."""
    for key, sub in cache.items():
        ax = _cache_batch_axis(cfg, key)
        for name, c in sub.items():
            c.select(ax, slot).copy_(new[key][name].select(ax, 0))
    return cache


def insert_paged_cache_slot(
    cfg: ModelConfig, cache: dict, new: dict, pt_row: torch.Tensor,
    page_size: int,
) -> dict:
    """Write a batch-1 dense prefill cache into the pages a slot owns, in
    place. ``pt_row`` [NP] maps the slot's logical blocks to physical pages;
    -1 entries (not yet allocated) drop their writes. The prefill cache's
    T need not fill NP pages: the tail pads with zeros, which lands only in
    allocated pages past the prompt, where decode writes before reading."""
    del cfg
    npg = pt_row.shape[0]
    keep = pt_row >= 0
    pages = pt_row[keep].long()  # admission runs outside the fused step
    for dst, src in (("kp", "k"), ("vp", "v")):
        pool = cache["blocks"][dst]
        dense = new["blocks"][src][:, 0]  # [L, T, kv, hd]
        d = F.pad(dense, (0, 0, 0, 0, 0, npg * page_size - dense.shape[1]))
        d = d.reshape(d.shape[0], npg, page_size, *d.shape[2:])
        pool[:, pages] = d[:, keep]
    return cache


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def uniform_noise(
    seed: int, inst: torch.Tensor, gen_idx: torch.Tensor, vocab: int
) -> torch.Tensor:
    """[S, V] uniforms in (0, 1), a pure function of (seed, instance id,
    generated position, token)."""
    lane = _mix32(torch.full_like(inst, seed, dtype=torch.int64) & _MASK32)
    lane = _mix32(lane ^ (inst.to(torch.int64) & _MASK32))
    lane = _mix32(lane ^ (gen_idx.to(torch.int64) & _MASK32))
    tok = torch.arange(vocab, device=inst.device, dtype=torch.int64)
    h = _mix32(lane[:, None] ^ _mix32(tok)[None, :])
    return ((h >> 8).to(torch.float32) + 0.5) * 2.0**-24


def make_slot_sampler(temperature: float, top_p: float, seed: int):
    """Per-slot token sampler for the fused step: ``fn(logits [S,V],
    inst [S], gen_idx [S]) -> [S] i32``.

    ``temperature <= 0`` is exact greedy argmax. Otherwise the Gumbel-max
    draw over ``logits / temperature`` uses :func:`uniform_noise`, so each
    (instance, position) has its own lane, independent of slot and batch.
    ``top_p < 1`` first keeps a token iff the probability mass strictly
    before it in sorted order is < top_p (the top-1 token always survives).
    """
    if temperature <= 0.0:
        return lambda logits, inst, gen_idx: torch.argmax(
            logits, dim=-1).to(I32)

    def sample(logits, inst, gen_idx):
        x = logits.to(torch.float32) / temperature
        if top_p < 1.0:
            srt = torch.sort(x, dim=-1, descending=True).values
            p = torch.softmax(srt, dim=-1)
            keep = (torch.cumsum(p, dim=-1) - p) < top_p
            cut = torch.where(keep, srt, torch.inf).amin(dim=-1, keepdim=True)
            x = torch.where(x >= cut, x, -torch.inf)
        u = uniform_noise(seed, inst, gen_idx, x.shape[-1])
        return torch.argmax(x - torch.log(-torch.log(u)), dim=-1).to(I32)

    return sample


class Engine:
    """Continuous batching over a request queue (see module doc).

    The device is the one ``params`` live on; ``recorder`` must use the
    same one (a sharded recorder places ``params`` on its mesh's device
    first, ``recorder.replicate``). ``stats()["a2a_overflow"]`` counts the
    records that took the a2a residual round of a routed recorder. On
    pad-safe families prompts pad with token 0 up to the
    nearest length bucket (``prompt_buckets``, by default powers of two from
    8, then ``max_prompt``); recurrent and MoE families (a pad would take
    expert capacity from real tokens) and sliding windows prefill at the
    exact prompt length and refuse buckets. On the card the warm
    fused step runs with host syncs made errors; ``guarded_steps`` counts
    those steps.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params: Any,
        recorder: OutcomeRecorder,
        *,
        slots: int = 8,
        max_prompt: int = 64,
        max_gen: Optional[int] = None,
        page_size: Optional[int] = None,
        num_pages: Optional[int] = None,
        temperature: float = 0.0,
        top_p: float = 1.0,
        sample_seed: int = 0,
        prompt_buckets: Optional[tuple[int, ...]] = None,
        telemetry: Optional[obs.Telemetry] = None,
    ):
        self.cfg = cfg
        self.recorder = recorder
        # a sharded recorder: params, state and every host-made row meet
        # the guarded step on this rank's device (recorder.replicate)
        self.params = recorder.replicate(params)
        self.device = self.params["embed"].device
        if recorder.device != self.device:
            raise ValueError(f"recorder on {recorder.device}, params on "
                             f"{self.device}")
        self.slots = slots
        self.max_prompt = max_prompt
        self.max_gen = max_gen if max_gen is not None else recorder.max_gen
        if self.max_gen > recorder.max_gen or recorder.slots != slots:
            raise ValueError("recorder sized for fewer slots/positions")
        self.max_seq = max_prompt + self.max_gen

        self.page_size = page_size
        self.pool: Optional[PagePool] = None
        if page_size is not None:
            if page_size <= 0:
                raise ValueError(f"page_size {page_size} must be positive")
            self.pages_per_slot = pages_for(self.max_seq, page_size)
            if num_pages is None:  # dense-equivalent capacity
                num_pages = slots * self.pages_per_slot
            if num_pages < self.pages_per_slot:
                raise ValueError(f"{num_pages} pages cannot hold one slot "
                                 f"({self.pages_per_slot})")
            self.num_pages = num_pages
            self.pool = PagePool(num_pages, page_size)
            self._slot_pages: dict[int, list[int]] = {}
            self._slot_reserve: dict[int, int] = {}
            self._pos_host = np.zeros((slots,), np.int64)
        self.deferred_admissions = 0

        self.temperature = float(temperature)
        self.top_p = float(top_p)
        self._sample = make_slot_sampler(
            self.temperature, self.top_p, sample_seed
        )
        if prompt_buckets is None and pad_safe(cfg):
            b, buckets = 8, []
            while b < max_prompt:
                buckets.append(b)
                b *= 2
            prompt_buckets = (*buckets, max_prompt)
        if prompt_buckets is not None and not pad_safe(cfg):
            raise ValueError(
                f"{cfg.family} family (or sliding-window attention) cannot "
                "right-pad prompts (pads perturb recurrent state / rolling "
                "caches); use exact-length prefill (prompt_buckets=None)"
            )
        self.prompt_buckets: Optional[tuple[int, ...]] = (
            tuple(sorted(prompt_buckets)) if prompt_buckets else None
        )

        self._id_next = 0
        self._queue: list[Request] = []
        self._slot_of: dict[int, int] = {}
        self._max_new_of: dict[int, int] = {}
        self._free = list(range(slots))[::-1]  # pop() -> lowest slot first
        self._await_labels: dict[int, bool] = {}
        self._admission_seq: dict[int, int] = {}
        # slots with labels delivered since the last fused step: their
        # ``pending`` metric predates the delivery, so eviction waits
        self._fresh_labels: set[int] = set()
        self._last_metrics: Optional[dict] = None
        self._warm = False
        self._ledger_epoch = 0  # bumped on out-of-band ledger mutation

        self.finished: dict[int, np.ndarray] = {}
        self.generated_tokens = 0
        self.admitted = 0
        self.evicted = 0
        self.steps_run = 0
        self.guarded_steps = 0  # fused steps run with host syncs as errors
        self.missed_outcomes = 0
        # records that missed the a2a send capacity and took the exact
        # residual round (0 unless the recorder routes exchange="a2a")
        self.a2a_overflow = 0
        # host wall time of each fused step, metrics read included
        self.step_ms: list[float] = []

        self._estate = recorder.replicate(self._init_state())
        self._rstate = recorder.init_state()

        # telemetry: instruments bound once here; each step updates them
        # from the metrics it has already read back to the host
        t = telemetry if telemetry is not None else obs.current()
        self.telemetry = t
        self._c_steps = t.counter("engine.steps")
        self._c_tokens = t.counter("engine.generated_tokens")
        self._c_records = t.counter("engine.ledger_records")
        self._c_miss = t.counter("engine.topk_miss")
        self._c_overflow = t.counter("engine.a2a_overflow")
        self._c_admitted = t.counter("engine.admitted")
        self._c_evicted = t.counter("engine.evicted")
        self._c_deferred = t.counter("engine.deferred_admissions")
        self._c_missed = t.counter("engine.missed_outcomes")
        self._g_occupancy = t.gauge("engine.occupancy")
        self._g_queue = t.gauge("engine.queue_depth")
        self._h_step_ms = t.histogram("engine.step_ms")
        # host mirrors of the device record/miss counters, so
        # loop_health() derives rates without a device read
        self._records_host = 0
        self._miss_host = 0
        # the EMA-drift shadow: a host LossHistory fed the rows the fused
        # step records on the device, compared in loop_health(drift=True);
        # device-ledger runs with telemetry on only (a host ledger is its
        # own shadow)
        self._shadow: Optional[LossHistory] = (
            LossHistory(recorder.cfg)
            if t.enabled and recorder.ledger == "device" else None
        )

    # -- device state --------------------------------------------------------

    def _init_state(self) -> EngineState:
        s, g, dev = self.slots, self.max_gen, self.device

        def full(shape, value):
            return torch.full(shape, value, dtype=I32, device=dev)

        if self.page_size is not None:
            cache = Mdl.init_paged_cache(
                self.cfg, self.num_pages, self.page_size, dev
            )
            page_table = full((s, self.pages_per_slot), -1)
        else:
            cache = Mdl.init_cache(self.cfg, s, self.max_seq, dev)
            page_table = None
        return EngineState(
            cache=cache, page_table=page_table, cur_tok=full((s, 1), 0),
            pos=full((s,), 0), gen_idx=full((s,), 0), inst=full((s,), -1),
            max_new=full((s,), 0),
            out_toks=full((s, g), 0), step=full((), 0),
        )

    def _insert(self, new_cache, logits0, slot, inst, plen, max_new,
                labels_row, pt_row=None) -> None:
        es = self._estate
        if pt_row is None:
            insert_cache_slot(self.cfg, es.cache, new_cache, slot)
        else:
            insert_paged_cache_slot(
                self.cfg, es.cache, new_cache, pt_row, self.page_size
            )
            es.page_table[slot] = pt_row
        inst_v = torch.full((1,), inst, dtype=I32, device=self.device)
        t0 = self._sample(logits0, inst_v, torch.zeros_like(inst_v))[0]
        es.out_toks[slot] = 0
        es.out_toks[slot, 0] = t0
        es.cur_tok[slot, 0] = t0
        es.pos[slot] = plen
        es.gen_idx[slot] = 1
        es.inst[slot] = inst
        es.max_new[slot] = max_new
        self.recorder.clear_slot(self._rstate, slot, logits0[0], labels_row)

    def _fused_step(self, es: EngineState, rs: RecorderState) -> dict:
        """Decode every slot one token, retain the outcome, score, record —
        all on the device, nothing read back to the host."""
        occupied = es.inst >= 0
        decoding = occupied & (es.gen_idx < es.max_new)
        logits, _ = Mdl.decode_step(
            self.params, self.cfg, es.cache, es.cur_tok, es.pos,
            page_table=es.page_table,
        )
        nxt = self._sample(logits, es.inst, es.gen_idx)
        bidx = torch.arange(self.slots, device=self.device)
        put_rows(es.out_toks.view(-1), bidx * self.max_gen + es.gen_idx,
                 nxt, decoding)
        es.cur_tok = torch.where(decoding[:, None], nxt[:, None], es.cur_tok)
        self.recorder.observe(rs, es.gen_idx, logits, decoding)
        adv = decoding.to(I32)
        es.gen_idx = es.gen_idx + adv
        es.pos = es.pos + adv
        es.step = es.step + 1
        _, info = self.recorder.score_one(rs, es.inst, es.gen_idx, es.step)
        return {
            "inst": es.inst,
            "occupied": occupied,
            "decoding": decoding,
            "gen_idx": es.gen_idx,
            "finished": occupied & (es.gen_idx >= es.max_new),
            "pending": info["pending"],
            "loss_valid": info["valid"],
            "topk_miss": info["miss"],
            "loss": info["loss"],
            "entropy": info["entropy"],
            "margin": info["margin"],
            "a2a_overflow": info["a2a_overflow"],
        }

    _INT_METRICS = ("inst", "occupied", "decoding", "gen_idx", "finished",
                    "pending", "loss_valid", "topk_miss")
    _FLOAT_METRICS = ("loss", "entropy", "margin")

    def _fetch(self, metrics: dict) -> dict:
        """Two device reads for the whole metrics dict (the step's
        ``a2a_overflow`` count rides the integer read as one more row)."""
        ints = torch.stack(
            [metrics[k].to(torch.int64) for k in self._INT_METRICS]
            + [metrics["a2a_overflow"].to(torch.int64).expand(self.slots)]
        ).cpu().numpy()
        floats = torch.stack(
            [metrics[k].to(torch.float32) for k in self._FLOAT_METRICS]
        ).cpu().numpy()
        out = {k: ints[i] for i, k in enumerate(self._INT_METRICS)}
        out["a2a_overflow"] = int(ints[-1, 0])
        for k in ("occupied", "decoding", "finished", "pending",
                  "loss_valid", "topk_miss"):
            out[k] = out[k].astype(bool)
        out.update({k: floats[i] for i, k in enumerate(self._FLOAT_METRICS)})
        return out

    # -- paged-cache host bookkeeping ----------------------------------------

    def _pages_needed(self, req: Request) -> tuple[int, int, int]:
        """(allocate now, reserve for growth, total) pages for a request."""
        ps = self.page_size
        n_now = pages_for(self._bucket(req.prompt.size), ps)
        n_total = max(n_now, pages_for(req.prompt.size + req.max_new, ps))
        return n_now, n_total - n_now, n_total

    def _grow_pages(self) -> None:
        """Allocate pages from each slot's reservation so the next step's
        K/V write at ``pos`` lands in an owned page."""
        ups: list[tuple[int, int, int]] = []
        for slot in self._slot_of.values():
            need = pages_for(int(self._pos_host[slot]) + 1, self.page_size)
            while len(self._slot_pages[slot]) < need:
                self._slot_reserve[slot] -= 1
                pg = self.pool.grow()
                ups.append((slot, len(self._slot_pages[slot]), pg))
                self._slot_pages[slot].append(pg)
        if ups:
            s, i, p = (torch.tensor(col, device=self.device)
                       for col in zip(*ups))
            self._estate.page_table[s, i] = p.to(I32)

    # -- host API ------------------------------------------------------------

    def submit(
        self,
        prompt: np.ndarray,
        max_new: Optional[int] = None,
        labels: Optional[np.ndarray] = None,
        instance_id: Optional[int] = None,
        expect_labels: Optional[bool] = None,
    ) -> int:
        """Queue a request; returns its (monotone, stable) instance id."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if not 0 < prompt.size <= self.max_prompt:
            raise ValueError(
                f"prompt length {prompt.size} not in (0, {self.max_prompt}]"
            )
        max_new = self.max_gen if max_new is None else max_new
        if not 0 < max_new <= self.max_gen:
            raise ValueError(f"max_new {max_new} not in (0, {self.max_gen}]")
        if instance_id is None:
            instance_id = self._id_next
            self._id_next += 1
        else:
            # an explicit id at or past the next auto id: advance past it
            self._id_next = max(self._id_next, int(instance_id) + 1)
        self._queue.append(
            Request(prompt, max_new, int(instance_id),
                    None if labels is None else np.asarray(labels, np.int64),
                    bool(expect_labels))
        )
        return int(instance_id)

    def deliver_outcome(self, instance_id: int, labels: np.ndarray) -> bool:
        """Late labels for a request: attached if still queued, written to
        its slot if resident, dropped and counted missed after eviction or
        past the request's ``max_new``."""
        slot = self._slot_of.get(int(instance_id))
        if slot is None:
            for req in self._queue:
                if req.instance_id == int(instance_id) and req.labels is None:
                    req.labels = np.asarray(labels, np.int64)
                    req.expect_labels = False
                    return True
            self.missed_outcomes += 1
            self._c_missed.inc()
            return False
        limit = self._max_new_of.get(int(instance_id), self.max_gen)
        row = np.full((self.recorder.max_gen,), -1, np.int64)
        labels = np.asarray(labels, np.int64).reshape(-1)
        use = min(labels.size, limit)
        row[:use] = labels[:use]
        cut = int((labels[limit:] >= 0).sum())
        self.missed_outcomes += cut
        self._c_missed.inc(cut)
        with self.telemetry.span("engine.deliver", inst=int(instance_id),
                                 slot=slot):
            self.recorder.deliver(
                self._rstate, slot,
                self.recorder.replicate(
                    torch.from_numpy(row).to(self.device)),
            )
        self._await_labels[int(instance_id)] = False
        self._fresh_labels.add(slot)
        return True

    def _bucket(self, n: int) -> int:
        if self.prompt_buckets is None:
            return n
        for b in self.prompt_buckets:
            if b >= n:
                return b
        return self.max_prompt

    def _admit(self, req: Request) -> None:
        with self.telemetry.span("engine.admit", inst=req.instance_id,
                                 prompt=int(req.prompt.size)):
            self._admit_inner(req)
        self._c_admitted.inc()

    def _admit_inner(self, req: Request) -> None:
        slot = self._free.pop()
        pt_row = None
        if self.pool is not None:
            n_now, n_later, _ = self._pages_needed(req)
            pages = self.pool.admit(n_now, n_later)
            row = np.full((self.pages_per_slot,), -1, np.int32)
            row[: len(pages)] = pages
            pt_row = self.recorder.replicate(
                torch.from_numpy(row).to(self.device))
            self._slot_pages[slot] = list(pages)
            self._slot_reserve[slot] = n_later
            self._pos_host[slot] = req.prompt.size
        p = self._bucket(req.prompt.size)
        toks = np.zeros((1, p), np.int32)
        toks[0, : req.prompt.size] = req.prompt
        with self.telemetry.span("engine.prefill", padded_len=p):
            logits0, new_cache = Mdl.prefill(
                self.params, self.cfg,
                torch.from_numpy(toks).to(self.device), max_seq=self.max_seq,
                last_pos=torch.full((1,), req.prompt.size - 1,
                                    device=self.device),
            )
        row = np.full((self.recorder.max_gen,), -1, np.int64)
        if req.labels is not None:
            row[: min(req.labels.size, req.max_new)] = \
                req.labels[: req.max_new]
            # labels past max_new have no decoded position to score against
            cut = int((req.labels[req.max_new:] >= 0).sum())
            self.missed_outcomes += cut
            self._c_missed.inc(cut)
        self._insert(
            new_cache, logits0, slot, req.instance_id, req.prompt.size,
            req.max_new,
            self.recorder.replicate(torch.from_numpy(row).to(self.device)),
            pt_row,
        )
        self._slot_of[req.instance_id] = slot
        self._max_new_of[req.instance_id] = req.max_new
        self._await_labels[req.instance_id] = req.expect_labels
        self.admitted += 1
        self._admission_seq[req.instance_id] = self.admitted

    def _evict_done(self) -> None:
        m = self._last_metrics
        if m is None:
            return
        done = [
            (inst, slot, int(m["gen_idx"][slot]))
            for inst, slot in self._slot_of.items()
            if m["finished"][slot] and not m["pending"][slot]
            and slot not in self._fresh_labels
            and not self._await_labels.get(inst, False)
        ]
        if not done:
            return
        with self.telemetry.span("engine.evict_fetch", n=len(done)):
            rows = self._estate.out_toks[[s for _, s, _ in done]].cpu().numpy()
        cleared: list[int] = []
        for (inst, slot, gen), row in zip(done, rows):
            self.finished[inst] = row[:gen]
            del self._slot_of[inst]
            self._max_new_of.pop(inst, None)
            self._await_labels.pop(inst, None)
            self._admission_seq.pop(inst, None)
            self._free.append(slot)
            self.evicted += 1
            self._c_evicted.inc()
            if self.pool is not None:
                self.pool.release(
                    self._slot_pages.pop(slot), self._slot_reserve.pop(slot)
                )
                self._pos_host[slot] = 0
                cleared.append(slot)
        if cleared:
            # a freed row's table goes back to -1, so the slot's frozen K/V
            # writes can never land in pages that moved on to another owner
            self._estate.page_table[self.recorder.replicate(
                torch.tensor(cleared, device=self.device))] = -1

    def in_flight_admissions(self) -> tuple[tuple[int, int], ...]:
        """(instance id, admission sequence number) per resident slot."""
        return tuple(
            (iid, self._admission_seq[iid]) for iid in self._slot_of
        )

    def step(self) -> Optional[dict]:
        """One engine tick: evict -> admit -> fused decode+score+record."""
        self._evict_done()
        while self._free:
            # a request whose id is resident waits for that slot to evict;
            # in paged mode a request whose worst case exceeds the pool's
            # headroom defers (a smaller one behind it may still admit)
            idx = None
            for i, r in enumerate(self._queue):
                if r.instance_id in self._slot_of:
                    continue
                if (self.pool is not None
                        and not self.pool.fits(self._pages_needed(r)[2])):
                    self.deferred_admissions += 1
                    self._c_deferred.inc()
                    continue
                idx = i
                break
            if idx is None:
                break
            self._admit(self._queue.pop(idx))
        if not self._slot_of:
            return None
        if self.pool is not None:
            self._grow_pages()
        t0 = time.perf_counter()
        guard = self._warm and self.device.type == "cuda"
        with self.telemetry.span("engine.decode_step",
                                 occupied=len(self._slot_of)):
            with no_host_sync(guard):
                metrics = self._fused_step(self._estate, self._rstate)
        self._warm = True
        self.guarded_steps += guard
        with self.telemetry.span("engine.fetch_metrics"):
            metrics = self._fetch(metrics)  # waits for the step's work
        self.step_ms.append((time.perf_counter() - t0) * 1e3)
        self._fresh_labels.clear()
        signals = np.stack([metrics["entropy"], metrics["margin"]], -1)
        if self.recorder.host_history is not None:
            self.recorder.record_host(
                metrics["inst"], metrics["loss"], metrics["loss_valid"],
                self.steps_run + 1, signals=signals,
            )
        if self._shadow is not None:
            # the drift shadow: the rows and step number the fused step
            # recorded on the device, from the metrics already read back
            v = metrics["loss_valid"]
            if v.any():
                self._shadow.record(metrics["inst"][v], metrics["loss"][v],
                                    self.steps_run + 1, signals=signals[v])
        self._last_metrics = metrics
        self.steps_run += 1
        self.generated_tokens += int(metrics["decoding"].sum())
        self.a2a_overflow += metrics["a2a_overflow"]
        if self.pool is not None:
            self._pos_host += metrics["decoding"]
        self._obs_on_step(metrics, (time.perf_counter() - t0) * 1e3)
        return metrics

    def _obs_on_step(self, metrics: dict, dt_ms: float) -> None:
        """Update the instruments from one step's metrics, already numpy
        on the host: plain host arithmetic, no tensor anywhere."""
        n_rec = int(metrics["loss_valid"].sum())
        n_miss = int(metrics["topk_miss"].sum())
        self._records_host += n_rec
        self._miss_host += n_miss
        self._c_steps.inc()
        self._c_tokens.inc(int(metrics["decoding"].sum()))
        self._c_records.inc(n_rec)
        self._c_miss.inc(n_miss)
        self._c_overflow.inc(metrics["a2a_overflow"])
        self._g_occupancy.set(len(self._slot_of) / self.slots)
        self._g_queue.set(len(self._queue))
        self._h_step_ms.observe(dt_ms)

    def loop_health(self, drift: bool = False) -> dict:
        """The loop's health as rates, the keys of the JAX engine's: the
        body of the periodic ``--metrics-out`` snapshot and of the
        summary's ``health``. Host arithmetic on counters the engine keeps;
        ``drift=True`` also reads the device ledger back and compares it
        channel by channel with the host shadow (a device read, so at the
        snapshot cadence, never inside a step)."""
        steps = self.steps_run
        attempts = self.admitted + self.deferred_admissions
        h = {
            "steps": steps,
            "occupancy": obs.rate_of(len(self._slot_of), self.slots),
            "queue_depth": len(self._queue),
            "admission_rate": obs.rate_of(self.admitted, steps),
            "eviction_rate": obs.rate_of(self.evicted, steps),
            "deferral_rate": obs.rate_of(self.deferred_admissions, attempts),
            "tokens_per_step": obs.rate_of(self.generated_tokens, steps),
            "records_per_step": obs.rate_of(self._records_host, steps),
            "topk_miss_frac": obs.rate_of(self._miss_host,
                                          self._records_host),
            "a2a_overflow_rate": obs.rate_of(self.a2a_overflow,
                                             self._records_host),
            "missed_outcome_rate": obs.rate_of(
                self.missed_outcomes,
                self._records_host + self.missed_outcomes,
            ),
        }
        if self.pool is not None:
            h.update({f"pool_{k}": v for k, v in self.pool.stats().items()})
        if drift and self._shadow is not None:
            h["ledger_drift"] = obs.ledger_drift(
                self._shadow.state_dict(), self.ledger_state_dict(),
                AUX_CHANNELS,
            )
        return h

    def run(self, max_steps: int = 1_000_000, on_step=None) -> dict:
        """Drive until the queue is empty and every slot drained and
        evicted. ``on_step(engine, metrics)`` runs after every tick."""
        n = 0
        while (self._queue or self._slot_of) and n < max_steps:
            metrics = self.step()
            if on_step is not None:
                on_step(self, metrics)
            self._evict_done()
            n += 1
        return self.stats()

    def stats(self) -> dict:
        n_rec, n_miss = self.recorder.counters(self._rstate)
        out = {
            "admitted": self.admitted,
            "evicted": self.evicted,
            "steps": self.steps_run,
            "generated_tokens": self.generated_tokens,
            "recorded": n_rec,
            "topk_misses": n_miss,
            "a2a_overflow": self.a2a_overflow,
            "missed_outcomes": self.missed_outcomes,
            "queued": len(self._queue),
            "in_flight": len(self._slot_of),
        }
        if self.pool is not None:
            out.update(
                pages_total=self.num_pages,
                pages_free=self.pool.free_pages,
                pages_reserved=self.pool.reserved_pages,
                deferred_admissions=self.deferred_admissions,
            )
        return out

    # -- ledger interchange ---------------------------------------------------

    def ledger_state_dict(self) -> dict[str, np.ndarray]:
        return self.recorder.state_dict(self._rstate)

    def load_ledger_state_dict(self, sd: dict[str, np.ndarray]) -> None:
        self.recorder.load_state_dict(self._rstate, dict(sd))
        self._ledger_epoch += 1  # invalidate live-handle snapshots

    @property
    def ledger(self):
        """Live lookup/state_dict handle on the engine's ledger."""
        if self.recorder.host_history is not None:
            return self.recorder.host_history
        return EngineLedgerHandle(self)


def delayed_outcomes(outcomes, delay: int):
    """A ``run(on_step=...)`` hook delivering each instance's labels
    ``delay`` engine steps after its admission. ``outcomes`` is a dict
    ``{instance_id: labels}`` or ``(instance_id, labels)`` pairs; a repeated
    id queues per-residency labels first in, first out."""
    q: dict[int, deque] = {}
    items = outcomes.items() if isinstance(outcomes, dict) else outcomes
    for iid, labels in items:
        q.setdefault(int(iid), deque()).append(labels)
    due: dict[int, int] = {}
    seen: set[tuple[int, int]] = set()

    def on_step(engine: Engine, metrics) -> None:
        del metrics
        for iid, seq in engine.in_flight_admissions():
            if (iid, seq) not in seen:
                seen.add((iid, seq))
                if iid in q:
                    due[iid] = engine.steps_run + delay
        for iid, at in list(due.items()):
            if engine.steps_run >= at:
                engine.deliver_outcome(iid, q[iid].popleft())
                if not q[iid]:
                    del q[iid]
                del due[iid]

    return on_step


class EngineLedgerHandle:
    """Read-only live view of an engine's device ledger, answered from a
    host snapshot refreshed whenever the engine has stepped since."""

    def __init__(self, engine: Engine):
        self._engine = engine
        self._snap_at: Optional[tuple] = None
        self._hist: Optional[LossHistory] = None

    def _refresh(self) -> LossHistory:
        at = (int(self._engine._estate.step), self._engine._ledger_epoch)
        if self._hist is None or at != self._snap_at:
            h = LossHistory(self._engine.recorder.cfg)
            h.load_state_dict(self._engine.ledger_state_dict())
            self._hist, self._snap_at = h, at
        return self._hist

    def lookup(self, ids):
        return self._refresh().lookup(ids)

    def lookup_signals(self, ids):
        return self._refresh().lookup_signals(ids)

    def priority(self, ids, step):
        return self._refresh().priority(ids, step)

    def state_dict(self):
        return self._engine.ledger_state_dict()
