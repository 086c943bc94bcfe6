"""Batch subsampling algorithms (paper §3.3, Algorithm 1 + appendix code).

The PyTorch counterpart of ``repro.core.selection``. Every selector is

    (noise, losses[n], b) -> int64 indices[b] on the losses' device

with ``b`` a Python int, and none reads anything back to the host, so the
train step stays free of host syncs. The paper's objective (6) is

    min_z | mean(l) - (1/b) * sum_i z_i * l_i |,   sum z_i = b, z binary

``noise`` supplies the random draws (a permutation, Gumbel noise, one
normal): ``GeneratorNoise`` draws them from a ``torch.Generator``. Torch
cannot reproduce JAX's threefry numbers, so the parity tests hand both
packages the same draws through an object with the same three methods.

Where torch's defaults differ from jnp's, the port follows jnp: argsorts
are stable, ``std`` has no Bessel correction, top-k ties go to the lowest
index (a stable descending sort), and ``nonzero(mask, size=b)`` becomes a
stable argsort of ``~mask`` cut to ``b``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core.history import AUX_CHANNELS

F32 = torch.float32
I64 = torch.int64

# Gumbel-surviving "never pick unless nothing else is left" log-weight (see
# repro.core.selection._SOFT_NEG).
_SOFT_NEG = -1e4


class Noise(Protocol):
    """The random draws the selectors take."""

    def permutation(self, n: int) -> torch.Tensor: ...  # int64 [n]

    def gumbel(self, n: int) -> torch.Tensor: ...  # f32 [n]

    def normal(self) -> torch.Tensor: ...  # f32 0-dim


class GeneratorNoise:
    """Draws from a ``torch.Generator`` on its own device (no host sync)."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.device = generator.device

    def permutation(self, n: int) -> torch.Tensor:
        return torch.randperm(n, generator=self.generator, device=self.device)

    def gumbel(self, n: int) -> torch.Tensor:
        e = torch.empty((n,), dtype=F32, device=self.device)
        return -torch.log(e.exponential_(generator=self.generator))

    def normal(self) -> torch.Tensor:
        return torch.randn((), generator=self.generator, device=self.device)


def _top_b(x: torch.Tensor, b: int) -> torch.Tensor:
    """Indices of the b largest, ties to the lowest index (lax.top_k)."""
    return torch.sort(x, descending=True, stable=True).indices[:b]


# ---------------------------------------------------------------------------
# Baselines from the paper's comparison suite
# ---------------------------------------------------------------------------


def select_uniform(noise: Noise, losses: torch.Tensor, b: int) -> torch.Tensor:
    """Uniform subsampling: b indices without replacement."""
    return noise.permutation(losses.shape[0])[:b].to(I64)


def select_prob(
    noise: Noise, losses: torch.Tensor, b: int, gamma: float = 1.0
) -> torch.Tensor:
    """Selective-Backprop: exactly b draws without replacement with weights
    p_i = tanh(gamma * l_i) by the Gumbel-top-k trick; zero-weight items get
    the ``_SOFT_NEG`` log-weight so a degenerate batch is a uniform draw."""
    losses = losses.to(F32)
    p = torch.tanh(gamma * torch.clamp(losses, min=0.0))
    logits = torch.where(p > 0, torch.log(torch.clamp(p, min=1e-30)),
                         _SOFT_NEG)
    return _top_b(logits + noise.gumbel(losses.shape[0]), b)


def select_mink(
    noise: Noise, losses: torch.Tensor, b: int,
    pool_size: Optional[int] = None,
) -> torch.Tensor:
    """Min-k loss SGD: the b lowest losses, optionally inside a random pool
    of ``max(pool_size, b)`` examples (the appendix variant)."""
    losses = losses.to(F32)
    n = losses.shape[0]
    if pool_size is not None and pool_size < n:
        pool = noise.permutation(n)[:max(int(pool_size), b)]
        order = torch.argsort(losses[pool], stable=True)[:b]
        return pool[order].to(I64)
    return torch.argsort(losses, stable=True)[:b]


def select_maxk(noise: Noise, losses: torch.Tensor, b: int) -> torch.Tensor:
    """Max-prob / biggest losers: the b largest losses."""
    del noise
    return _top_b(losses.to(F32), b)


# ---------------------------------------------------------------------------
# OBFTF
# ---------------------------------------------------------------------------


def select_obftf_prox(
    noise: Noise, losses: torch.Tensor, b: int
) -> torch.Tensor:
    """The paper's ``OBFTF_prox``: equal-quantile picks through the
    descending-sorted losses, at floor(i * n / (b + 1)) for i = 1..b in
    exact integer arithmetic, made on the losses' device (no host copy);
    distinct for b <= n (see repro.core.selection.select_obftf_prox)."""
    del noise
    n = losses.shape[0]
    if not 0 < b <= n:
        raise ValueError(f"prox picks need 0 < b <= n, got b={b}, n={n}")
    order = torch.argsort(-losses.to(F32), stable=True)
    picks = torch.arange(1, b + 1, dtype=I64, device=losses.device)
    return order[torch.clamp(picks * n // (b + 1), max=n - 1)]


def _obftf_target(
    noise: Noise, losses: torch.Tensor, b: int, noisy_target: bool
) -> torch.Tensor:
    """Target mean; optionally the paper's noisy draw N(mean, std/sqrt(b))."""
    mean = losses.mean()
    if not noisy_target:
        return mean
    std = losses.std(correction=0) / float(np.sqrt(np.float32(b)))
    return mean + std * noise.normal()


def select_obftf(
    noise: Noise,
    losses: torch.Tensor,
    b: int,
    *,
    swaps: int = 2,
    noisy_target: bool = False,
) -> torch.Tensor:
    """Prox init + up to ``swaps`` best single (selected, unselected)
    exchanges, each applied only when it lowers |sum(selected) - target|.
    Returns the selected indices in ascending order."""
    n = losses.shape[0]
    if b >= n:
        return torch.arange(n, device=losses.device)
    losses = losses.to(F32)
    total = _obftf_target(noise, losses, b, noisy_target) * b

    init_idx = select_obftf_prox(noise, losses, b)
    mask = torch.zeros((n,), dtype=torch.bool, device=losses.device)
    mask = mask.index_fill(0, init_idx, True)
    s = torch.where(mask, losses, 0.0).sum()
    delta = losses[None, :] - losses[:, None]  # delta[i, j] = l_j - l_i
    for _ in range(swaps):
        resid = s - total
        valid = mask[:, None] & ~mask[None, :]
        score = torch.where(valid, torch.abs(resid + delta), torch.inf)
        flat = torch.argmin(score.reshape(-1)).reshape(1)  # first minimum
        i, j = flat // n, flat % n
        better = (score.reshape(-1).index_select(0, flat)
                  < torch.abs(resid) - 1e-9)[0]
        new_mask = mask.index_fill(0, i, False).index_fill(0, j, True)
        new_s = s - losses.index_select(0, i)[0] + losses.index_select(0, j)[0]
        mask = torch.where(better, new_mask, mask)
        s = torch.where(better, new_s, s)
    # jnp.nonzero(mask, size=b): the selected positions, ascending
    return torch.argsort((~mask).to(torch.int8), stable=True)[:b]


# ---------------------------------------------------------------------------
# Dispatch + config
# ---------------------------------------------------------------------------

METHODS = (
    "uniform",
    "prob",  # Selective-Backprop
    "mink",
    "maxk",
    "obftf_prox",
    "obftf",
)


@dataclasses.dataclass(frozen=True)
class SelectionConfig:
    """How the train step subsamples each batch (paper Algorithm 1)."""

    method: str = "obftf"
    ratio: float = 0.25  # b = round(ratio * n), the paper's sampling rate
    gamma: float = 1.0  # 'prob' only
    swaps: int = 2  # 'obftf' only
    # the appendix draws the target mean from N(mean, std/sqrt(b))
    noisy_target: bool = True
    mink_pool: Optional[int] = None  # 'mink' only: random-pool variant
    # which recorded signal feeds the selector under --recycle
    policy: str = "loss_ema"

    def budget(self, n: int) -> int:
        b = int(max(1, round(self.ratio * n)))
        return min(b, n)


def select(
    cfg: SelectionConfig, noise: Noise, losses: torch.Tensor, b: int
) -> torch.Tensor:
    """Dispatch to the configured selector -> int64 [b]."""
    if cfg.method == "uniform":
        return select_uniform(noise, losses, b)
    if cfg.method in ("prob", "selective_backprop"):
        return select_prob(noise, losses, b, gamma=cfg.gamma)
    if cfg.method == "mink":
        return select_mink(noise, losses, b, pool_size=cfg.mink_pool)
    if cfg.method == "maxk":
        return select_maxk(noise, losses, b)
    if cfg.method == "obftf_prox":
        return select_obftf_prox(noise, losses, b)
    if cfg.method == "obftf":
        return select_obftf(noise, losses, b, swaps=cfg.swaps,
                            noisy_target=cfg.noisy_target)
    raise NotImplementedError(cfg.method)


# ---------------------------------------------------------------------------
# Serve-time signal policies
# ---------------------------------------------------------------------------
#
# A selection *method* decides HOW indices are picked from a score vector; a
# *policy* decides WHICH recorded serve-time signal that score vector is
# (the ledger's loss EMA or one of ``history.AUX_CHANNELS``), mapped to a
# non-negative pseudo-loss where higher means more worth a backward.


@runtime_checkable
class SelectionPolicy(Protocol):
    """Protocol: a named, pure map from signal channels to scores [n]."""

    name: str
    channels: tuple[str, ...]

    def score(self, signals: dict[str, torch.Tensor]) -> torch.Tensor: ...


@dataclasses.dataclass(frozen=True)
class SignalPolicy:
    """Concrete :class:`SelectionPolicy`: a pure function over channels
    ("loss" is the ledger's EMA channel, the rest ``AUX_CHANNELS``)."""

    name: str
    channels: tuple[str, ...]  # channels consumed (() = constant score)
    fn: Callable[[dict[str, torch.Tensor]], torch.Tensor]

    def score(self, signals: dict[str, torch.Tensor]) -> torch.Tensor:
        missing = [c for c in self.channels if c not in signals]
        if missing:
            raise KeyError(f"policy {self.name!r} missing channels {missing}")
        return self.fn(signals).to(F32)


def _uniform_score(signals: dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.zeros_like(next(iter(signals.values())), dtype=F32)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(x, 0), with no threshold cut-over."""
    return torch.logaddexp(x, torch.zeros_like(x))


POLICIES: dict[str, SignalPolicy] = {
    # control arm: constant score, and no cold-start boost
    "uniform": SignalPolicy("uniform", (), _uniform_score),
    "loss_ema": SignalPolicy(
        "loss_ema", ("loss",), lambda s: torch.clamp(s["loss"], min=0.0)
    ),
    "entropy": SignalPolicy(
        "entropy", ("entropy",), lambda s: torch.clamp(s["entropy"], min=0.0)
    ),
    # softplus(-margin): the logistic loss of the top-1-vs-top-2 decision
    "margin": SignalPolicy("margin", ("margin",),
                           lambda s: _softplus(-s["margin"])),
}


def get_policy(name: str) -> SignalPolicy:
    if name not in POLICIES:
        raise KeyError(f"unknown policy {name!r}; have {tuple(POLICIES)}")
    return POLICIES[name]


def policy_score(
    policy: SelectionPolicy,
    ema: torch.Tensor,
    sig: torch.Tensor,
    seen: torch.Tensor,
    cold: float,
) -> torch.Tensor:
    """Ledger lookup -> selection score. Unseen instances score ``cold``,
    except under the uniform control policy, which ignores every signal."""
    signals = {"loss": ema.to(F32)}
    for j, c in enumerate(AUX_CHANNELS):
        signals[c] = sig[..., j].to(F32)
    s = policy.score(signals)
    if policy.name == "uniform":
        return s
    return torch.where(seen, s, cold).to(F32)


def select_by_score(noise: Noise, scores: torch.Tensor, b: int) -> torch.Tensor:
    """Gumbel-top-k draw of ``b`` indices with probability ∝ score; all-equal
    scores degenerate to a uniform draw without replacement."""
    s = torch.clamp(scores.to(F32), min=0.0)
    w = torch.where(s > 0, torch.log(torch.clamp(s, min=1e-30)), _SOFT_NEG)
    return _top_b(w + noise.gumbel(s.shape[0]), b)


def subset_mean_residual(losses: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """|mean(selected) - mean(all)| — the paper's objective value for a pick."""
    losses = losses.to(F32)
    return torch.abs(losses[idx].mean() - losses.mean())


def brute_force_obftf(losses: torch.Tensor, b: int) -> torch.Tensor:
    """Exact solver of (6) for tiny n (a test oracle; mirrors the paper's
    MIP): enumerates all 2^n masks, keeps those of size ``b`` and returns
    the first one with the least residual |sum(kept) / b - mean|, as
    int64 indices in ascending order. Codes are int64 (torch has no uint32
    shift). Only call with n <= ~16."""
    n = losses.shape[0]
    losses = losses.to(F32)
    codes = torch.arange(2**n, dtype=I64, device=losses.device)
    shifts = torch.arange(n, dtype=I64, device=losses.device)
    bits = ((codes[:, None] >> shifts[None, :]) & 1).to(F32)
    size_ok = bits.sum(dim=1) == b
    resid = torch.abs(bits @ losses / b - losses.mean())
    resid = torch.where(size_ok, resid, torch.inf)
    best = torch.argmin(resid)  # the first minimum
    return torch.nonzero(bits[best] > 0)[:, 0]
