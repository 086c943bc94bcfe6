"""Sharded recycle ledger: each rank owns a slice of the table.

The port's counterpart of ``repro.distributed.ledger`` (see its module doc
for the two placements and the two exchanges). The JAX package runs each
op inside ``shard_map`` over the data axes; here each rank of the data
axis (``launch.mesh``, one rank a device) calls each op with its own
segment of the batch and holds its own [C/S]-slot slice of the table, and
the exchanges are collectives over the group (``distributed.compat``).
Every rank must call every op in the same order with the same shapes: a
branch on the rank would leave the others waiting in a collective. On a
mesh with a model axis the ops run over the data group (``compat``'s
default axis): the model ranks of a data row hold equal replicas of its
slice and make the same writes, as JAX's ledger is replicated over
``model``.

* **pinned** (``route=False``): ids hash into the rank's own slice; no
  communication.
* **routed** (``route=True``): each item goes to the rank that owns its
  GLOBAL slot, ``home = slot_for(id, C) // (C/S)``, so the sharded table
  is bit for bit the single global table cut into S slices.

  - ``exchange="gather"``: one ``all_gather`` of the batch (rank-major,
    the global batch order), a home mask, and for reads a masked
    ``all_reduce`` that returns each answer to the rank that asked.
  - ``exchange="a2a"``: ``bin_by_home`` packs each rank's items into
    ``cap = a2a_capacity(b, S, cf)`` rows a destination, and one
    ``all_to_all`` carries ids, global order keys ``rank*b + i`` and the
    payloads; the home rank visits its slice and a second ``all_to_all``
    returns the answers. Items past capacity are resolved exactly by a
    residual gather round, and ``a2a_overflow`` counts them over the
    group. JAX enters that round under a ``lax.cond`` on the replicated
    count; an eager ``if`` on it would read the count back to the host,
    so here the round runs, masked to the overflow set, on every op whose
    capacity can overflow (``residual_round``: ``cap < b``) and never on
    one whose cannot. So in the port a2a never moves fewer bytes than
    gather (``exchange_bytes_per_op``): it is kept for its results, which
    are gather's bit for bit, and for the JAX flag.

Several fields of a batch travel as one int32 tensor (floats bit-cast), so
each exchange is one collective and moves every bit unchanged.

``state_dict`` is collective: every rank calls it and gets the global
interchange layout (a pinned multi-shard table keeps its placement and a
``pinned_shards`` marker). ``load_state_dict`` needs no communication.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import device_ledger as dl
from repro_torch.core.device_ledger import LedgerState
from repro_torch.core.history import HistoryConfig, rehash_state_dict
from repro_torch.distributed import compat
from repro_torch.launch.mesh import Mesh

I32 = torch.int32
F32 = torch.float32

EXCHANGES = ("gather", "a2a")


def a2a_capacity(batch: int, shards: int, capacity_factor: float) -> int:
    """Send-buffer rows a destination for one rank's batch of ``batch``
    items: ``max(1, ceil(batch * capacity_factor / shards))``. At
    ``capacity_factor >= shards`` every binning fits (cap >= b) and no
    item can overflow."""
    if capacity_factor <= 0:
        raise ValueError(f"capacity_factor must be > 0, got {capacity_factor}")
    return max(1, int(np.ceil(batch * capacity_factor / shards)))


def bin_by_home(
    home: torch.Tensor, n_shards: int, capacity: int,
    active: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GShard's cumsum position assignment: bin items by ``home`` into
    ``capacity`` rows a destination, earlier items first ->
    ``(pos, kept, overflow)``. ``pos`` [B] int32 is an item's rank among the
    active items of its home (its row where ``kept``); ``kept`` the active
    items that won a row; ``overflow`` the active items past capacity.
    Inactive items (``active`` False) are neither and take no row.

    Invariants: kept and overflow partition the active set; within each
    home the kept positions are 0..k-1 with k <= capacity; permuting the
    batch permutes kept ∪ overflow (earlier items win the rows)."""
    if active is None:
        active = torch.ones(home.shape, dtype=torch.bool, device=home.device)
    homes = torch.arange(n_shards, dtype=home.dtype, device=home.device)
    oh = ((home[:, None] == homes[None, :]) & active[:, None]).to(I32)
    pos = ((torch.cumsum(oh, dim=0) - oh) * oh).sum(dim=1).to(I32)
    kept = active & (pos < capacity)
    return pos, kept, active & ~kept


def residual_round(batch: int, shards: int, capacity_factor: float) -> bool:
    """Whether the port's a2a exchange runs its residual gather round on
    every op at this size: wherever the capacity can overflow,
    ``a2a_capacity(batch, shards, capacity_factor) < batch``, whether or
    not an item overflows (module doc)."""
    return a2a_capacity(batch, shards, capacity_factor) < batch


def exchange_bytes_per_op(
    exchange: str,
    shards: int,
    batch: int,
    capacity_factor: float = 1.25,
    item_bytes: int = 16,
    overflow: Optional[bool] = None,
) -> int:
    """Analytic exchange payload of ONE routed op on one rank, both
    directions at ``item_bytes`` an item (id, order, loss, valid = 16):
    ``gather`` moves ``2 * S * b * item_bytes`` whatever the balance;
    ``a2a`` two all-to-alls of ``S * cap`` rows, plus one gather round trip
    when ``overflow`` (the residual round is the gather exchange applied to
    the overflow set).

    ``overflow`` True or False prices the JAX package's exchange, which
    pays the round only on a step that overflows: there a2a moves fewer
    bytes than gather iff ``capacity_factor < shards``. ``None`` (the
    default) prices the port's: the round runs on every op where
    ``residual_round`` holds, so a2a never moves fewer bytes than gather.
    At ``cap >= b`` its two all-to-alls alone move ``2 * S * cap >= 2 * S
    * b`` items; below, the round adds gather's whole round trip to them.
    """
    if exchange not in EXCHANGES:
        raise ValueError(f"exchange {exchange!r} not in {EXCHANGES}")
    gather_round = 2 * shards * batch * item_bytes
    if exchange == "gather":
        return gather_round
    if overflow is None:
        overflow = residual_round(batch, shards, capacity_factor)
    cap = a2a_capacity(batch, shards, capacity_factor)
    return 2 * shards * cap * item_bytes + (gather_round if overflow else 0)


def _pack(*xs: torch.Tensor) -> tuple[torch.Tensor, list]:
    """[B] / [B, n] int32, float32 or bool tensors -> one [B, k] int32
    tensor (floats bit-cast, bools as 0/1) and the layout ``_unpack``
    splits it back by."""
    parts, layout = [], []
    for x in xs:
        col = x.reshape(x.shape[0], -1)
        if col.dtype == F32:
            col = col.contiguous().view(I32)
        parts.append(col.to(I32))
        layout.append((x.dtype, tuple(x.shape[1:])))
    return torch.cat(parts, dim=1), layout


def _unpack(packed: torch.Tensor, layout: list) -> list[torch.Tensor]:
    out, c = [], 0
    for dtype, tail in layout:
        n = math.prod(tail)
        col = packed[:, c:c + n]
        c += n
        if dtype == F32:
            col = col.contiguous().view(F32)
        elif dtype == torch.bool:
            col = col != 0
        out.append(col.reshape((packed.shape[0],) + tail))
    return out


def _as_f32_cols(*xs: torch.Tensor) -> tuple[torch.Tensor, list]:
    """Answers -> one [B, k] f32 tensor (bools as 0.0/1.0) and its widths.
    A sum over ranks where one rank holds the answer and the others 0.0
    keeps the answer's bits (``_return_route``)."""
    cols = [x.reshape(x.shape[0], -1).to(F32) for x in xs]
    return torch.cat(cols, dim=1), [(x.dtype, tuple(x.shape[1:])) for x in xs]


def _from_f32_cols(packed: torch.Tensor, layout: list) -> list[torch.Tensor]:
    out, c = [], 0
    for dtype, tail in layout:
        n = math.prod(tail)
        col = packed[:, c:c + n].reshape((packed.shape[0],) + tail)
        c += n
        out.append(col > 0 if dtype == torch.bool else col)
    return out


@dataclasses.dataclass(frozen=True)
class ShardedLedgerOps:
    """The ledger ops of one rank, closed over (mesh, dp_axes, per-shard
    config). Every op takes and returns this rank's ``LedgerState`` slice
    ([C/S] slots on ``mesh.device``); ids, losses and masks are this rank's
    segment of the batch. Nothing is read back to the host: the ops run
    inside the engine's guarded step."""

    mesh: Mesh
    dp_axes: tuple[str, ...]
    cfg: HistoryConfig  # global config; capacity = global slots
    local_cfg: HistoryConfig  # this rank's slice
    route: bool = False
    exchange: str = "gather"  # routed-mode realization: "gather" | "a2a"
    capacity_factor: float = 1.25  # a2a send-buffer slack

    @property
    def shards(self) -> int:
        return math.prod(self.mesh.shape[a] for a in self.dp_axes)

    @property
    def rank(self) -> int:
        return compat.linear_axis_index()

    @property
    def _a2a(self) -> bool:
        return self.route and self.exchange == "a2a"

    def _span(self, name: str, **args):
        return obs.span(f"ledger.{name}", cat="ledger", shards=self.shards,
                        **args)

    def _exchange_name(self) -> str:
        return self.exchange if self.route else "pinned"

    # -- routing helpers ------------------------------------------------------

    def _home(self, ids: torch.Tensor) -> torch.Tensor:
        """The rank owning each id's global slot: slot_for(id, C) // (C/S)."""
        return dl.slot_for_torch(ids, self.cfg.capacity) \
            // self.local_cfg.capacity

    def _exchange(self, *per_rank: torch.Tensor) -> list[torch.Tensor]:
        """The routing hop: gather every rank's batch (rank-major, the
        global batch order) -> the gathered fields and ``mine``, the items
        homed to this rank (the first field is the ids)."""
        packed, layout = _pack(*per_rank)
        gathered = _unpack(compat.all_gather(packed), layout)
        return gathered + [self._home(gathered[0]) == self.rank]

    def _return_route(self, values, mine: torch.Tensor, b: int):
        """Send answers over the gathered batch back to the rank that asked:
        exactly one rank has ``mine`` set for an item, so a masked sum over
        ranks is the inverse exchange; then this rank's segment."""
        packed, layout = _as_f32_cols(*values)
        total = compat.all_reduce_sum(
            torch.where(mine[:, None], packed, 0.0))
        r = self.rank
        return _from_f32_cols(total[r * b:(r + 1) * b], layout)

    # -- a2a helpers ----------------------------------------------------------

    def _a2a_dispatch(self, ids, payloads=(), active=None) -> dict:
        """Bin this rank's batch by home (``bin_by_home``) into send buffers
        of ``cap`` rows a destination and ship ids, global order keys and
        the payloads in one all-to-all. ``recv_ord`` is -1 on a row that no
        item filled."""
        S, b = self.shards, ids.shape[0]
        cap = a2a_capacity(b, S, self.capacity_factor)
        home = self._home(ids)
        pos, kept, overflow = bin_by_home(home, S, cap, active=active)
        order = self.rank * b + torch.arange(b, dtype=I32, device=ids.device)
        packed, layout = _pack(ids, order, *payloads)
        # one dump row past the end for the items that did not win a row
        buf = packed.new_zeros((S * cap + 1, packed.shape[1]))
        buf[:, 1] = -1
        tgt = torch.where(kept, home * cap + pos, S * cap)
        buf.index_copy_(0, tgt, packed)
        recv = _unpack(compat.all_to_all(buf[:S * cap]), layout)
        return dict(cap=cap, home=home, pos=pos, kept=kept,
                    overflow=overflow, recv_ids=recv[0], recv_ord=recv[1],
                    recv=recv[2:],
                    residual=residual_round(b, S, self.capacity_factor))

    def _a2a_collect(self, values, d: dict) -> list[torch.Tensor]:
        """The inverse ship: answers over the received rows go back to the
        rank that sent them, and each kept item reads the row it was sent
        in (the others read row 0, overwritten by the caller)."""
        packed, layout = _as_f32_cols(*values)
        ret = compat.all_to_all(packed)
        idx = torch.where(d["kept"], d["home"] * d["cap"] + d["pos"], 0)
        return _from_f32_cols(ret.index_select(0, idx), layout)

    def _gather_overflow(self, i, d, *payloads):
        """The residual round's hop: the whole batch and its overflow mask,
        gathered -> (ids, payloads..., overflow, mine, this rank's share of
        the overflow set, the group's overflow count)."""
        i_all, *rest, ovf_all, mine = self._exchange(i, *payloads,
                                                     d["overflow"])
        return (i_all, *rest, ovf_all, mine, ovf_all & mine,
                ovf_all.sum().to(I32))

    def _a2a_read(self, st, i, visit):
        """Routed read: ``visit(state, ids) -> answers`` runs on the home
        rank over the received rows; kept items collect theirs over the
        return all-to-all, overflow items over the residual round."""
        b = i.shape[0]
        d = self._a2a_dispatch(i)
        kept = d["kept"]
        ans = self._a2a_collect(visit(st, d["recv_ids"]), d)
        if not d["residual"]:
            return ans
        i_all, _, _, own_ovf, _ = self._gather_overflow(i, d)
        res = self._return_route(visit(st, i_all), own_ovf, b)
        return [torch.where(kept.reshape((b,) + (1,) * (a.dim() - 1)), a, o)
                for a, o in zip(ans, res)]

    def _a2a_write(self, st, i, l, v, s, sg, active):
        """The routed write under a2a: ONE ``record`` over the received
        items and, where capacity can overflow, the gathered overflow items
        homed here, keyed by GLOBAL batch order, so duplicates split across
        the two arrival paths resolve as in the single table. Always the
        plain scatter: the ledger kernel has no order keys. -> (state,
        dispatch, residual gather or None, overflow count)."""
        payloads = (l, v) + (() if sg is None else (sg,))
        d = self._a2a_dispatch(i, payloads, active=active)
        r_l, r_v = d["recv"][0], d["recv"][1] & (d["recv_ord"] >= 0)
        r_sg = d["recv"][2] if sg is not None else None
        if not d["residual"]:
            st2 = dl.record(self.local_cfg, st, d["recv_ids"], r_l, s,
                            valid=r_v, order=d["recv_ord"], signals=r_sg)
            return st2, d, None, torch.zeros((), dtype=I32, device=i.device)
        g = self._gather_overflow(i, d, *payloads)
        i_all, l_all, v_all = g[0], g[1], g[2]
        sg_all = g[3] if sg is not None else None
        own_ovf, n_ovf = g[-2], g[-1]
        cat = torch.cat
        n_all = i_all.shape[0]
        st2 = dl.record(
            self.local_cfg, st, cat([d["recv_ids"], i_all]),
            cat([r_l, l_all]), s, valid=cat([r_v, own_ovf & v_all]),
            order=cat([d["recv_ord"],
                       torch.arange(n_all, dtype=I32, device=i.device)]),
            signals=None if sg is None else cat([r_sg, sg_all]),
        )
        return st2, d, (i_all, own_ovf), n_ovf

    # -- ops ------------------------------------------------------------------

    def init(self) -> LedgerState:
        """This rank's empty [C/S] slice on the mesh's device."""
        return dl.init_state(self.local_cfg, self.mesh.device)

    def _prep(self, ids, losses=None, valid=None, signals=None):
        ids = dl._as_i32_ids(ids)
        out = [ids]
        if losses is not None:
            out.append(losses.to(F32))
            out.append(torch.ones(ids.shape, dtype=torch.bool,
                                  device=ids.device)
                       if valid is None else valid.to(torch.bool))
            out.append(None if signals is None else
                       signals.to(F32).reshape(ids.shape[0], -1))
        return out

    def record(
        self, state: LedgerState, ids, losses, step, valid=None,
        signals=None, return_stats: bool = False,
    ):
        """Record this rank's segment; with ``return_stats=True`` also
        ``{"a2a_overflow": n}``, the group's count of items that missed the
        a2a capacity in this call (0 off the a2a exchange)."""
        i, l, v, sg = self._prep(ids, losses, valid, signals)
        with self._span("record", exchange=self._exchange_name()):
            ovf = torch.zeros((), dtype=I32, device=i.device)
            if self._a2a:
                st, _, _, ovf = self._a2a_write(state, i, l, v, step, sg,
                                                active=v)
            else:
                if self.route:
                    fields = (i, l, v) + (() if sg is None else (sg,))
                    g = self._exchange(*fields)
                    i, l, v = g[0], g[1], g[2] & g[-1]
                    sg = g[3] if sg is not None else None
                st = dl.record(self.local_cfg, state, i, l, step, valid=v,
                               signals=sg)
        if return_stats:
            return st, {"a2a_overflow": ovf}
        return st

    def lookup(self, state: LedgerState, ids):
        """-> (ema [b] f32, seen [b] bool) for this rank's ids."""
        (i,) = self._prep(ids)
        with self._span("lookup"):
            if not self.route:
                return dl.lookup(state, i)
            if self._a2a:
                return tuple(self._a2a_read(state, i, dl.lookup))
            b = i.shape[0]
            i_all, mine = self._exchange(i)
            return tuple(self._return_route(dl.lookup(state, i_all), mine, b))

    def lookup_signals(self, state: LedgerState, ids):
        """-> (ema [b], sig [b, N_AUX], seen [b]); routed mode answers from
        each id's home rank, as ``lookup`` does."""
        (i,) = self._prep(ids)
        with self._span("lookup_signals"):
            if not self.route:
                return dl.lookup_signals(state, i)
            if self._a2a:
                return tuple(self._a2a_read(state, i, dl.lookup_signals))
            b = i.shape[0]
            i_all, mine = self._exchange(i)
            return tuple(self._return_route(
                dl.lookup_signals(state, i_all), mine, b))

    def priority(self, state: LedgerState, ids, step) -> torch.Tensor:
        (i,) = self._prep(ids)

        def visit(st, x):
            return (dl.priority(self.local_cfg, st, x, step),)

        with self._span("priority"):
            if not self.route:
                return visit(state, i)[0]
            if self._a2a:
                return self._a2a_read(state, i, visit)[0]
            b = i.shape[0]
            i_all, mine = self._exchange(i)
            return self._return_route(visit(state, i_all), mine, b)[0]

    def record_priority(
        self, state: LedgerState, ids, losses, step, valid=None,
        signals=None, return_stats: bool = False,
    ):
        """Record this rank's segment, then score every one of its ids at
        the same step -> (state, priority [b][, stats]). Pinned and gather
        go through ``device_ledger.record_priority`` (the ledger kernel on
        the card) on this rank's slice; a2a is ``record`` with order keys
        then ``priority``, as in the JAX package."""
        i, l, v, sg = self._prep(ids, losses, valid, signals)
        b = i.shape[0]
        ovf = torch.zeros((), dtype=I32, device=i.device)
        with self._span("record_priority", exchange=self._exchange_name()):
            if self._a2a:
                # every item is binned: an invalid one skips the write but
                # still needs its score
                st, d, res, ovf = self._a2a_write(state, i, l, v, step, sg,
                                                  active=None)
                (pri,) = self._a2a_collect(
                    (dl.priority(self.local_cfg, st, d["recv_ids"], step),), d)
                if res is None:
                    pri = torch.where(d["kept"], pri, 0.0)
                else:
                    i_all, own_ovf = res
                    (o,) = self._return_route(
                        (dl.priority(self.local_cfg, st, i_all, step),),
                        own_ovf, b)
                    pri = torch.where(d["kept"], pri, o)
            elif not self.route:
                st, pri = dl.record_priority(self.local_cfg, state, i, l,
                                             step, valid=v, signals=sg)
            else:
                fields = (i, l, v) + (() if sg is None else (sg,))
                g = self._exchange(*fields)
                st, pri_all = dl.record_priority(
                    self.local_cfg, state, g[0], g[1], step,
                    valid=g[2] & g[-1],
                    signals=g[3] if sg is not None else None,
                )
                (pri,) = self._return_route((pri_all,), g[-1], b)
        if return_stats:
            return st, pri, {"a2a_overflow": ovf}
        return st, pri

    # -- host interchange ------------------------------------------------------

    def state_dict(self, state: LedgerState) -> dict[str, np.ndarray]:
        """The table as an ``.npz``-able state_dict, on every rank (a
        collective: every rank must call it). Routed tables (and one-rank
        ones) are the global interchange layout. A pinned multi-shard table
        holds records on consumer ranks, so it is exported raw with a
        ``pinned_shards`` marker: ``load_state_dict`` below restores it into
        the same layout, every other loader re-hashes it."""
        packed, layout = _pack(state.ema, state.count, state.last_seen,
                               state.owner, state.sig)
        ema, count, last_seen, owner, sig = _unpack(
            compat.all_gather(packed), layout)
        raw = dl.state_dict_of(LedgerState(ema, count, last_seen, owner, sig))
        if not self.route and self.shards > 1:
            raw["pinned_shards"] = np.int64(self.shards)
        return raw

    def load_state_dict(self, sd: dict[str, np.ndarray]) -> LedgerState:
        """This rank's slice of a state_dict, keeping placement where it can.

        A ``pinned_shards`` export of this layout (pinned, same shard count,
        same capacity) is placed as it is. Anything else is re-hashed into
        the global layout and placed at hash-home ranks: exact for routed
        lookups, but a PINNED multi-shard table then hits only records
        whose consumer rank is their home rank, so that case warns."""
        sd = dict(sd)
        marker = sd.pop("pinned_shards", None)
        n = np.asarray(sd["ema"]).shape[0]
        pinned_match = (marker is not None and int(marker) == self.shards
                        and not self.route and n == self.cfg.capacity)
        if not pinned_match and (marker is not None
                                 or n != self.cfg.capacity):
            sd = rehash_state_dict(sd, self.cfg.capacity)
        if not pinned_match and not self.route and self.shards > 1 \
                and self.rank == 0:
            print(
                "WARNING: loading a foreign-layout ledger into a pinned "
                f"{self.shards}-shard table places records at hash-home "
                "shards; a pinned feed will mostly miss them. Use "
                "route=True (--ledger-route) to look them up there."
            )
        return dl.state_from_dict(
            split_state_dict(sd, self.shards)[self.rank], self.mesh.device)


def sharded_ledger_ops(
    mesh: Mesh,
    cfg: HistoryConfig = HistoryConfig(),
    dp_axes: Sequence[str] = ("data",),
    route: bool = False,
    exchange: str = "gather",
    capacity_factor: float = 1.25,
) -> ShardedLedgerOps:
    """Sharded ledger ops of this rank; the global capacity must divide into
    power-of-two slices over the data axis. ``route=True`` adds the
    cross-rank exchange so unpinned feeds hit their records; ``exchange``
    picks its realization ("gather" or "a2a", the same tables either way);
    ``capacity_factor`` sizes the a2a send buffers (ignored by gather)."""
    if exchange not in EXCHANGES:
        raise ValueError(f"exchange must be one of {EXCHANGES}: {exchange!r}")
    if capacity_factor <= 0:
        raise ValueError(f"capacity_factor must be > 0: {capacity_factor}")
    shards = math.prod(mesh.shape[a] for a in dp_axes)
    if cfg.capacity % shards:
        raise ValueError(
            f"ledger capacity {cfg.capacity} not divisible by {shards} shards"
        )
    local_cap = cfg.capacity // shards
    if local_cap & (local_cap - 1):
        raise ValueError(f"per-shard capacity {local_cap} must be 2^k")
    return ShardedLedgerOps(
        mesh=mesh, dp_axes=tuple(dp_axes), cfg=cfg,
        local_cfg=dataclasses.replace(cfg, capacity=local_cap),
        route=route, exchange=exchange, capacity_factor=capacity_factor,
    )


# ---------------------------------------------------------------------------
# host-side layout migration (numpy)
# ---------------------------------------------------------------------------


def split_state_dict(
    sd: dict[str, np.ndarray], shards: int
) -> list[dict[str, np.ndarray]]:
    """Global layout -> per-shard tables (hash-home placement): the record
    at global slot g lands on shard g // (C/S) at local slot g mod (C/S),
    its local hash slot. Lossless."""
    cap = np.asarray(sd["owner"]).shape[0]
    if cap % shards:
        raise ValueError(f"capacity {cap} not divisible by {shards} shards")
    lc = cap // shards
    if lc & (lc - 1):
        raise ValueError(f"per-shard capacity {lc} must be 2^k")
    return [
        {k: np.asarray(v)[s * lc:(s + 1) * lc].copy() for k, v in sd.items()}
        for s in range(shards)
    ]


def merge_shard_state_dicts(
    sds: Sequence[dict[str, np.ndarray]],
    capacity: Optional[int] = None,
) -> dict[str, np.ndarray]:
    """Per-shard tables -> one global-layout table, the inverse of
    ``split_state_dict``. Records of a pinned feed that collide at one
    global slot resolve to the most recent (the ledger's eviction rule)."""
    keys = ("ema", "count", "last_seen", "owner")
    if all("sig" in sd for sd in sds):  # pre-signal-channel dicts merge too
        keys += ("sig",)
    concat = {
        k: np.concatenate([np.asarray(sd[k]) for sd in sds]) for k in keys
    }
    return rehash_state_dict(concat, capacity or concat["owner"].shape[0])
