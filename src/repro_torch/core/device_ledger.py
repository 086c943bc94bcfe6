"""Device-resident recycle ledger: ``LossHistory`` as tensor functions.

The PyTorch counterpart of ``repro.core.device_ledger``: the fixed-capacity
EMA table of ``core.history.LossHistory`` held as tensors on the device,
with ``record`` / ``lookup`` / ``priority`` as functions that return new
state and never read anything back to the host, so the serving engine can
record inside its decode step.

Addressing is shared with the host ledger (``history.slot_for``, the 32-bit
Fibonacci hash), so ``state_dict`` round-trips between the two and with the
JAX package's ledgers. Collision semantics match exactly, including the
deterministic last-write-wins on intra-batch slot collisions (numpy
fancy-assignment order), which a plain ``index_put_`` with duplicate
indices does not promise on CUDA.

Sharding: ``repro_torch.distributed.ledger`` runs these functions on each
rank's slice of the table, so capacity grows with the data-parallel
degree.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.history import (  # noqa: F401  (re-exported)
    AUX_CHANNELS,
    FIB32,
    N_AUX,
    HistoryConfig,
    LossHistory,
    rehash_state_dict,
    slot_for,
)
from repro_torch.core.scatter import put_rows

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32
_MASK32 = 0xFFFFFFFF


@dataclasses.dataclass
class LedgerState:
    """The ledger table as tensors. ``count``/``last_seen``/``owner`` are
    int32 on the device; the host interchange format is int64. Ids are
    keyed by their low 32 bits."""

    ema: torch.Tensor  # [capacity] f32
    count: torch.Tensor  # [capacity] i32
    last_seen: torch.Tensor  # [capacity] i32, -1 = never
    owner: torch.Tensor  # [capacity] i32, -1 = empty
    sig: torch.Tensor  # [capacity, N_AUX] f32 (history.AUX_CHANNELS order)

    @property
    def capacity(self) -> int:
        return self.ema.shape[0]


def init_state(cfg: HistoryConfig, device: torch.device | str) -> LedgerState:
    if cfg.capacity & (cfg.capacity - 1):
        raise ValueError(f"capacity {cfg.capacity} must be a power of two")
    n = cfg.capacity
    return LedgerState(
        ema=torch.zeros((n,), dtype=F32, device=device),
        count=torch.zeros((n,), dtype=I32, device=device),
        last_seen=torch.full((n,), -1, dtype=I32, device=device),
        owner=torch.full((n,), -1, dtype=I32, device=device),
        sig=torch.zeros((n, N_AUX), dtype=F32, device=device),
    )


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for int64 ``x`` in [0, 2^32) and a 32-bit
    constant: split so no product leaves int64 (a uint32 multiply wraps; an
    int64 one past 2^63 would not be defined)."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def slot_for_torch(ids: torch.Tensor, capacity: int) -> torch.Tensor:
    """Tensor twin of ``history.slot_for`` — bit-identical for any int
    input: the low 32 bits of the id, a wrapping uint32 multiply and a
    xor-shift, computed in int64 and masked to 32 bits."""
    x = ids.to(I64) & _MASK32
    h = mul32(x, FIB32)
    h = h ^ (h >> 16)
    return h & (capacity - 1)


def _as_i32_ids(ids: torch.Tensor) -> torch.Tensor:
    """Low 32 bits as int32, like the JAX ledger's ``astype(int32)``."""
    x = ids.to(I64) & _MASK32
    return torch.where(x >= 2**31, x - 2**32, x).to(I32)


def _winner_mask(
    slots: torch.Tensor, capacity: int, order: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """True for the last batch item targeting each slot (numpy fancy-index
    semantics). Items whose slot is ``capacity`` (masked-out writes) never
    win. A max-reduction of the batch order per slot is order-independent,
    so the result is deterministic on every device.

    ``order`` ([B] int, optional) replaces the in-batch position as the
    winner key: the item with the largest ``order`` wins its slot. The
    routed all-to-all exchange records a batch that arrives re-binned
    under its global batch order this way. Keys must be unique among the
    items that can share a slot."""
    if order is None:
        order = torch.arange(slots.shape[0], device=slots.device, dtype=I64)
    else:
        order = order.to(I64)
    last = torch.full((capacity + 1,), -1, dtype=I64, device=slots.device)
    last = last.scatter_reduce(0, slots, order, reduce="amax")
    return (slots < capacity) & (last[slots] == order)


def record(
    cfg: HistoryConfig,
    state: LedgerState,
    ids: torch.Tensor,
    losses: torch.Tensor,
    step,
    valid: Optional[torch.Tensor] = None,
    signals: Optional[torch.Tensor] = None,
    order: Optional[torch.Tensor] = None,
) -> LedgerState:
    """Scatter-EMA write returning a new state; semantics identical to
    ``LossHistory.record``. ``valid`` (bool [B]) drops masked-out items
    entirely: they neither write nor take part in last-write-wins.
    ``signals`` ([B, N_AUX] f32) EMAs the auxiliary channels; without it a
    same-owner record keeps them and an evicting record zeroes them.
    ``order`` ([B] int) is the last-write-wins key in place of the batch
    position (``_winner_mask``); every item reads the table as it was
    before the batch, so only the winner choice depends on it."""
    ids = _as_i32_ids(ids)
    losses = losses.to(F32)
    slots = slot_for_torch(ids, state.capacity)
    fresh = state.owner[slots] != ids
    d = cfg.decay
    prev = torch.where(fresh, losses, state.ema[slots])
    new_ema = d * prev + (1.0 - d) * losses
    new_count = torch.where(fresh, 1, state.count[slots] + 1).to(I32)
    if signals is None:
        new_sig = torch.where(fresh[:, None], 0.0, state.sig[slots])
    else:
        signals = signals.to(F32).reshape(ids.shape[0], N_AUX)
        prev_sig = torch.where(fresh[:, None], signals, state.sig[slots])
        new_sig = d * prev_sig + (1.0 - d) * signals
    if valid is not None:
        slots = torch.where(valid.to(torch.bool), slots, state.capacity)
    keep = _winner_mask(slots, state.capacity, order)
    step32 = torch.as_tensor(step, device=ids.device).to(I32)
    out = LedgerState(
        ema=state.ema.clone(),
        count=state.count.clone(),
        last_seen=state.last_seen.clone(),
        owner=state.owner.clone(),
        sig=state.sig.clone(),
    )
    put_rows(out.ema, slots, new_ema, keep)
    put_rows(out.count, slots, new_count, keep)
    put_rows(out.last_seen, slots, step32.expand(ids.shape), keep)
    put_rows(out.owner, slots, ids, keep)
    put_rows(out.sig, slots, new_sig, keep)
    return out


LOOKUP_VARIANTS = ("gather", "onehot")


def lookup(
    state: LedgerState, ids: torch.Tensor, variant: str = "gather"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Hash-probe read -> (ema_loss f32, seen_mask bool); unseen rows 0.

    ``variant`` is how the EMA column is read: ``"gather"``, ``ema[slots]``,
    or ``"onehot"``, ``one_hot(slots, C) @ ema`` as one [B, C] x [C]
    product (the JAX package's form for the TPU's matrix unit). Both give
    the same bits: each one-hot row has a single 1.0, so every other term
    is an exact 0.0. The owner probe stays a gather."""
    if variant not in LOOKUP_VARIANTS:
        raise ValueError(f"lookup variant {variant!r} not in "
                         f"{LOOKUP_VARIANTS}")
    ids = _as_i32_ids(ids)
    slots = slot_for_torch(ids, state.capacity)
    seen = state.owner[slots] == ids
    if variant == "onehot":
        cols = torch.arange(state.capacity, device=slots.device)
        ema = (slots[:, None] == cols[None, :]).to(F32) @ state.ema
    else:
        ema = state.ema[slots]
    return torch.where(seen, ema, 0.0), seen


def lookup_signals(
    state: LedgerState, ids: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Hash-probe read -> (ema [B], sig [B, N_AUX], seen [B])."""
    ids = _as_i32_ids(ids)
    slots = slot_for_torch(ids, state.capacity)
    seen = state.owner[slots] == ids
    ema = torch.where(seen, state.ema[slots], 0.0)
    sig = torch.where(seen[:, None], state.sig[slots], 0.0)
    return ema, sig, seen


def priority(
    cfg: HistoryConfig, state: LedgerState, ids: torch.Tensor, step
) -> torch.Tensor:
    """Staleness-boosted score, identical to ``LossHistory.priority``."""
    ids = _as_i32_ids(ids)
    slots = slot_for_torch(ids, state.capacity)
    seen = state.owner[slots] == ids
    step32 = torch.as_tensor(step, device=ids.device).to(I32)
    age = torch.clamp(step32 - state.last_seen[slots], min=0).to(F32)
    score = state.ema[slots] * torch.exp2(age / cfg.staleness_half_life)
    return torch.where(seen, score, cfg.unseen_priority).to(F32)


def _sig_scatter(
    cfg: HistoryConfig,
    state: LedgerState,
    ids: torch.Tensor,
    signals: Optional[torch.Tensor],
    valid: Optional[torch.Tensor],
) -> torch.Tensor:
    """The ``sig`` half of ``record`` alone -> the new [capacity, N_AUX]
    channels: the ledger kernel carries the four scalar arrays, and the
    channels ride this scatter beside it with the same slots, ownership
    and winners."""
    ids = _as_i32_ids(ids)
    slots = slot_for_torch(ids, state.capacity)
    fresh = state.owner[slots] != ids
    if signals is None:
        new_sig = torch.where(fresh[:, None], 0.0, state.sig[slots])
    else:
        signals = signals.to(F32).reshape(ids.shape[0], N_AUX)
        prev_sig = torch.where(fresh[:, None], signals, state.sig[slots])
        new_sig = cfg.decay * prev_sig + (1.0 - cfg.decay) * signals
    if valid is not None:
        slots = torch.where(valid.to(torch.bool), slots, state.capacity)
    keep = _winner_mask(slots, state.capacity)
    sig = state.sig.clone()
    put_rows(sig, slots, new_sig, keep)
    return sig


def record_priority(
    cfg: HistoryConfig,
    state: LedgerState,
    ids: torch.Tensor,
    losses: torch.Tensor,
    step,
    valid: Optional[torch.Tensor] = None,
    signals: Optional[torch.Tensor] = None,
) -> tuple[LedgerState, torch.Tensor]:
    """Record the batch, then score every id at the same step, in one
    transaction -> (new state, priority [B] f32).

    The state it leaves is bit for bit the one ``record`` leaves (the
    contract of ``repro.core.device_ledger.record_priority``), so a caller
    that only needs the write may take this path and drop the priorities:
    the trainer does. On the card the four scalar arrays go through the
    ledger kernel (``kernels.ops.ledger_record_priority``) and ``sig``
    through ``_sig_scatter``; on the CPU it is ``record`` followed by
    ``priority``."""
    if not state.ema.is_cuda:
        new = record(cfg, state, ids, losses, step, valid=valid,
                     signals=signals)
        return new, priority(cfg, new, ids, step)
    from repro_torch.kernels import ops as kops

    sig = _sig_scatter(cfg, state, ids, signals, valid)
    ema, count, last_seen, owner, pri = kops.ledger_record_priority(
        state.ema, state.count, state.last_seen, state.owner,
        _as_i32_ids(ids), losses, step,
        decay=cfg.decay, unseen_priority=cfg.unseen_priority,
        staleness_half_life=cfg.staleness_half_life, valid=valid,
    )
    return LedgerState(ema, count, last_seen, owner, sig), pri


def state_dict_of(state: LedgerState) -> dict[str, np.ndarray]:
    """Export in the ``LossHistory`` checkpoint format (int64 host dtypes):
    the ``.npz`` interchange shared with the JAX package's ledgers."""
    return {
        "ema": state.ema.cpu().numpy().astype(np.float32),
        "count": state.count.cpu().numpy().astype(np.int64),
        "last_seen": state.last_seen.cpu().numpy().astype(np.int64),
        "owner": state.owner.cpu().numpy().astype(np.int64),
        "sig": state.sig.cpu().numpy().astype(np.float32),
    }


def state_from_dict(
    sd: dict[str, np.ndarray], device: torch.device | str = "cpu"
) -> LedgerState:
    """Load the host interchange format onto ``device`` (dicts written
    before the signal channels existed get sig = 0)."""
    n = np.asarray(sd["ema"]).shape[0]
    sig = np.asarray(sd.get("sig", np.zeros((n, N_AUX))), np.float32)

    def t(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device, dtype)

    return LedgerState(
        ema=t(np.asarray(sd["ema"], np.float32), F32),
        count=t(np.asarray(sd["count"]).astype(np.int32), I32),
        last_seen=t(np.asarray(sd["last_seen"]).astype(np.int32), I32),
        owner=t(np.asarray(sd["owner"]).astype(np.int32), I32),
        sig=t(sig, F32),
    )


def load_state_dict(
    cfg: HistoryConfig, sd: dict[str, np.ndarray], device: torch.device | str
) -> LedgerState:
    """``state_from_dict`` after re-hashing a foreign layout (another
    capacity, or a sharded-pinned export) into ``cfg``'s table."""
    sd = dict(sd)
    foreign = sd.pop("pinned_shards", None) is not None
    if foreign or np.asarray(sd["ema"]).shape[0] != cfg.capacity:
        sd = rehash_state_dict(sd, cfg.capacity)
    return state_from_dict(sd, device)


class DeviceLedger:
    """Object wrapper with the ``LossHistory`` API over a table held as
    tensors on ``device`` (the JAX package's ``DeviceLedger``). The state
    leaves the device only through ``state_dict()``; the functions above
    are what a step that keeps everything on the device calls."""

    def __init__(
        self, cfg: HistoryConfig = HistoryConfig(),
        device: torch.device | str = "cuda",
    ):
        self.cfg = cfg
        self.device = torch.device(device)
        self.state = init_state(cfg, self.device)

    def _t(self, x, dtype) -> torch.Tensor:
        """Host arrays or tensors -> ``dtype`` on the ledger's device."""
        return torch.as_tensor(x).to(self.device, dtype)

    # -- LossHistory-compatible surface ------------------------------------

    def record(self, ids, losses, step, valid=None, signals=None) -> None:
        self.state = record(
            self.cfg, self.state, self._t(ids, I64), self._t(losses, F32),
            step, valid=None if valid is None else self._t(valid, torch.bool),
            signals=None if signals is None else self._t(signals, F32),
        )

    def lookup(self, ids, variant: str = "gather"):
        return lookup(self.state, self._t(ids, I64), variant=variant)

    def lookup_signals(self, ids):
        return lookup_signals(self.state, self._t(ids, I64))

    def priority(self, ids, step) -> torch.Tensor:
        return priority(self.cfg, self.state, self._t(ids, I64), step)

    def record_priority(self, ids, losses, step, valid=None,
                        signals=None) -> torch.Tensor:
        self.state, pri = record_priority(
            self.cfg, self.state, self._t(ids, I64), self._t(losses, F32),
            step, valid=None if valid is None else self._t(valid, torch.bool),
            signals=None if signals is None else self._t(signals, F32),
        )
        return pri

    # -- host interchange ---------------------------------------------------

    def state_dict(self) -> dict[str, np.ndarray]:
        """Export in the ``LossHistory`` checkpoint format (int64 host
        dtypes)."""
        return state_dict_of(self.state)

    def load_state_dict(self, sd: dict[str, np.ndarray]) -> None:
        """Load any layout: another capacity, or a pinned sharded export
        (its ``pinned_shards`` marker), is re-hashed into this table."""
        self.state = load_state_dict(self.cfg, sd, self.device)

    @classmethod
    def from_host(cls, history: LossHistory,
                  device: torch.device | str = "cuda") -> "DeviceLedger":
        led = cls(history.cfg, device)
        led.load_state_dict(history.state_dict())
        return led

    def to_host(self) -> LossHistory:
        h = LossHistory(self.cfg)
        h.load_state_dict(self.state_dict())
        return h
