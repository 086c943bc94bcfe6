"""Mamba2 block (SSD, state space duality, arXiv:2405.21060).

The PyTorch counterpart of ``repro.models.ssm``: the selective SSM with one
decay per head,

    h_t = exp(a_h * dt_t) * h_{t-1} + dt_t * B_t x_t^T     (state [H, P, N])
    y_t = C_t . h_t + D_h * x_t

run over a whole sequence by the SSD chunked algorithm, and one token at a
time from a (state, conv) cache. Block layout as in Mamba2: in_proj ->
[z (gate), x, B, C, dt], a short causal depthwise conv over (x, B, C), the
scan, a gated RMSNorm, out_proj.

The full-sequence scan goes through ``kernels.ops.ssd_scan``: the CUDA
kernel on the card, and on the CPU ``ssd_chunked`` below, the plain
chunked version. The decode recurrence, the conv and the projections are
plain PyTorch, as the JAX package computes them in jnp outside any kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rmsnorm
from repro_torch.models.params import ParamSpec

F32 = torch.float32


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(x, 0), with no threshold cut-over."""
    return torch.logaddexp(x, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def ssm_specs(cfg: ModelConfig) -> dict[str, ParamSpec]:
    d, di = cfg.d_model, cfg.d_inner
    n, g, h = cfg.ssm_state, cfg.ssm_groups, cfg.ssm_heads
    conv_dim = di + 2 * g * n
    return {
        # order: [z: di | x: di | B: g*n | C: g*n | dt: h]
        "in_proj": ParamSpec((d, 2 * di + 2 * g * n + h),
                             ("embed", "ssm_inner"), scale=d**-0.5),
        "conv_w": ParamSpec((cfg.ssm_conv, conv_dim), ("conv", "ssm_inner"),
                            init="conv"),
        "conv_b": ParamSpec((conv_dim,), ("ssm_inner",), init="zeros"),
        "a_log": ParamSpec((h,), ("ssm_heads",), init="ssm_a"),
        "dt_bias": ParamSpec((h,), ("ssm_heads",), init="ssm_dt"),
        "d_skip": ParamSpec((h,), ("ssm_heads",), init="ones"),
        "norm": ParamSpec((di,), ("ssm_inner",), init="ones"),
        "out_proj": ParamSpec((di, d), ("ssm_inner", "embed"),
                              scale=di**-0.5),
    }


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    di, gn = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state
    z, x, b, c, dt = torch.split(
        zxbcdt, [di, di, gn, gn, cfg.ssm_heads], dim=-1)
    return z, x, b, c, dt


# ---------------------------------------------------------------------------
# SSD chunked scan (prefill): the kernel's plain version
# ---------------------------------------------------------------------------


def ssd_chunked(
    x: torch.Tensor,  # [B, S, H, P]
    dt: torch.Tensor,  # [B, S, H] (already softplus'd, positive)
    a: torch.Tensor,  # [H] (negative)
    bmat: torch.Tensor,  # [B, S, G, N]
    cmat: torch.Tensor,  # [B, S, G, N]
    chunk: int,
    h0: Optional[torch.Tensor] = None,  # [B, H, P, N] initial state
    return_states: bool = False,
) -> tuple[torch.Tensor, ...]:
    """SSD algorithm: intra-chunk quadratic form + inter-chunk state scan.
    -> (y [B,S,H,P] in x's dtype, final state [B,H,P,N] f32), and with
    ``return_states`` also the state entering each chunk [B,H,nc,P,N] f32
    (what ``kernels.ref.ssd_bwd_ref`` takes). A sequence that is no
    multiple of ``chunk`` is padded with dt = 0 steps, which are exact
    no-ops (decay exp(0) = 1, update dt B x = 0)."""
    bsz, s_orig, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    pad = (-s_orig) % chunk
    if pad:
        def zpad(t):
            return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))

        x, dt, bmat, cmat = zpad(x), zpad(dt), zpad(bmat), zpad(cmat)
    s = s_orig + pad
    nc, l_ = s // chunk, chunk
    rep = h // g

    xf = x.to(F32).reshape(bsz, nc, l_, h, p)
    dtf = dt.to(F32).reshape(bsz, nc, l_, h)
    bh = bmat.to(F32).reshape(bsz, nc, l_, g, n).repeat_interleave(rep, dim=3)
    ch = cmat.to(F32).reshape(bsz, nc, l_, g, n).repeat_interleave(rep, dim=3)

    da = dtf * a.to(F32)[None, None, None, :]  # [B,nc,L,H] log-decay
    cum = torch.cumsum(da, dim=2)  # within-chunk cumulative log decay

    # intra-chunk: decay from step j to step i (i >= j) is exp(cum_i - cum_j);
    # above the diagonal the exponent is positive and may overflow, so it is
    # zeroed before the exp, as the JAX version's double where does
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B,nc,Li,Lj,H]
    causal = torch.tril(torch.ones((l_, l_), dtype=torch.bool,
                                   device=x.device))[None, None, :, :, None]
    decay = torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)), 0.0)
    cb = torch.einsum("bclhn,bckhn->bclkh", ch, bh)  # C_i . B_j
    att = cb * decay * dtf[:, :, None, :, :]  # weight on x_j
    y_intra = torch.einsum("bclkh,bckhp->bclhp", att, xf)

    # chunk states: sum_j exp(cum_L - cum_j) dt_j B_j x_j^T
    tail = torch.exp(cum[:, :, -1:, :] - cum)  # [B,nc,L,H]
    xw = xf * (dtf * tail)[..., None]
    chunk_state = torch.einsum("bclhn,bclhp->bchpn", bh, xw)  # [B,nc,H,P,N]
    chunk_decay = torch.exp(da.sum(dim=2))  # [B,nc,H]

    # inter-chunk scan: the state entering each chunk
    state = (torch.zeros((bsz, h, p, n), dtype=F32, device=x.device)
             if h0 is None else h0.to(F32))
    h_in = []
    for ci in range(nc):
        h_in.append(state)
        state = state * chunk_decay[:, ci, :, None, None] + chunk_state[:, ci]
    h_in = torch.stack(h_in, dim=1)  # [B,nc,H,P,N]

    y_inter = torch.einsum("bclhn,bchpn->bclhp",
                           ch * torch.exp(cum)[..., None], h_in)
    y = (y_intra + y_inter).reshape(bsz, s, h, p)[:, :s_orig]
    if return_states:
        return y.to(x.dtype), state, h_in.transpose(1, 2)
    return y.to(x.dtype), state


def ssd_decode_step(
    x: torch.Tensor,  # [B, H, P] single token
    dt: torch.Tensor,  # [B, H]
    a: torch.Tensor,  # [H]
    bvec: torch.Tensor,  # [B, G, N]
    cvec: torch.Tensor,  # [B, G, N]
    state: torch.Tensor,  # [B, H, P, N]
) -> tuple[torch.Tensor, torch.Tensor]:
    """One recurrence step, O(H P N): the SSM's constant-cost decode."""
    rep = x.shape[1] // bvec.shape[1]
    bh = bvec.to(F32).repeat_interleave(rep, dim=1)  # [B,H,N]
    ch = cvec.to(F32).repeat_interleave(rep, dim=1)
    dtf = dt.to(F32)
    decay = torch.exp(dtf * a[None, :])  # [B,H]
    upd = (dtf[..., None] * x.to(F32))[..., None] * bh[:, :, None, :]
    new_state = state * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, ch)
    return y.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# causal depthwise conv with a decode cache
# ---------------------------------------------------------------------------


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """x [B,S,C], w [K,C]: depthwise causal conv, then silu."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = xp[:, 0:s] * w[0][None, None, :]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i][None, None, :]
    return F.silu(out + b[None, None, :])


def conv_decode(
    x: torch.Tensor, cache: torch.Tensor, w: torch.Tensor, b: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B,C] one step; cache [B,K-1,C] holds the previous K-1 inputs."""
    hist = torch.cat([cache, x[:, None, :]], dim=1)  # [B,K,C]
    out = torch.einsum("bkc,kc->bc", hist.to(F32), w.to(F32))
    out = F.silu(out + b[None, :].to(F32)).to(x.dtype)
    return out, hist[:, 1:, :]


# ---------------------------------------------------------------------------
# full Mamba2 block
# ---------------------------------------------------------------------------


def _gated_norm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                eps: float) -> torch.Tensor:
    """Mamba2's RMSNorm(y * silu(z)) output gate."""
    return rmsnorm(y * F.silu(z.to(F32)).to(y.dtype), w, eps)


def _scan_inputs(x: torch.Tensor, p: dict, cfg: ModelConfig):
    """in_proj, conv and the dt/A transforms of a full sequence x [B,S,D]
    -> (z, conv input, x [B,S,H,P], dt, a, B, C [B,S,G,N])."""
    dt_ = x.dtype
    bsz, s, _ = x.shape
    h, pd, n, g = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    zxbcdt = x @ p["in_proj"].to(dt_)
    z, xs, bmat, cmat, dt = _split_proj(zxbcdt, cfg)
    conv_in = torch.cat([xs, bmat, cmat], dim=-1)
    conv_out = causal_conv(conv_in, p["conv_w"].to(F32),
                           p["conv_b"].to(F32)).to(dt_)
    xs, bmat, cmat = torch.split(conv_out, [cfg.d_inner, g * n, g * n], dim=-1)
    dt = _softplus(dt.to(F32) + p["dt_bias"][None, None, :].to(F32))
    a = -torch.exp(p["a_log"].to(F32))
    return (z, conv_in, xs.reshape(bsz, s, h, pd), dt, a,
            bmat.reshape(bsz, s, g, n), cmat.reshape(bsz, s, g, n))


def _block_out(y, xs, z, p, cfg: ModelConfig) -> torch.Tensor:
    """D skip, gated norm and out_proj of the scan's y [B,S,H,P]."""
    bsz, s = y.shape[:2]
    y = y + xs * p["d_skip"].to(y.dtype)[None, None, :, None]
    y = _gated_norm(y.reshape(bsz, s, cfg.d_inner), z, p["norm"],
                    cfg.norm_eps)
    return y @ p["out_proj"].to(y.dtype)


def ssm_block(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence Mamba2 block. x [B,S,D] -> [B,S,D]."""
    z, _, xs, dt, a, bmat, cmat = _scan_inputs(x, p, cfg)
    y, _ = kops.ssd_scan(xs, dt, a, bmat, cmat,
                         chunk=min(cfg.ssm_chunk, x.shape[1]))
    return _block_out(y, xs, z, p, cfg)


def ssm_init_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                   device: torch.device | str) -> dict:
    """{"state": [B,H,P,N] f32, "conv": [B,K-1,conv_dim] in ``dtype``}."""
    h, pd, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {
        "state": torch.zeros((batch, h, pd, n), dtype=F32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                            device=device),
    }


def ssm_fill_cache(
    x: torch.Tensor, p: dict, cfg: ModelConfig
) -> tuple[torch.Tensor, dict]:
    """Prefill: full-sequence output and the final (state, conv) cache."""
    s = x.shape[1]
    z, conv_in, xs, dt, a, bmat, cmat = _scan_inputs(x, p, cfg)
    y, final = kops.ssd_scan(xs, dt, a, bmat, cmat,
                             chunk=min(cfg.ssm_chunk, s))
    out = _block_out(y, xs, z, p, cfg)
    return out, {"state": final, "conv": conv_in[:, s - (cfg.ssm_conv - 1):]}


def ssm_decode(
    x: torch.Tensor, p: dict, cfg: ModelConfig, cache: dict
) -> tuple[torch.Tensor, dict]:
    """Single-token decode. x [B,1,D] -> ([B,1,D], new cache)."""
    dt_ = x.dtype
    bsz = x.shape[0]
    h, pd, n, g = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    zxbcdt = x[:, 0, :] @ p["in_proj"].to(dt_)
    z, xs, bmat, cmat, dt = _split_proj(zxbcdt, cfg)
    conv_in = torch.cat([xs, bmat, cmat], dim=-1)
    conv_out, conv_cache = conv_decode(conv_in, cache["conv"], p["conv_w"],
                                       p["conv_b"])
    xs, bmat, cmat = torch.split(conv_out, [cfg.d_inner, g * n, g * n], dim=-1)
    dt = _softplus(dt.to(F32) + p["dt_bias"][None, :].to(F32))
    a = -torch.exp(p["a_log"].to(F32))
    y, state = ssd_decode_step(
        xs.reshape(bsz, h, pd), dt, a, bmat.reshape(bsz, g, n),
        cmat.reshape(bsz, g, n), cache["state"],
    )
    y = y + xs.reshape(bsz, h, pd) * p["d_skip"].to(dt_)[None, :, None]
    y = _gated_norm(y.reshape(bsz, 1, cfg.d_inner), z[:, None, :], p["norm"],
                    cfg.norm_eps)
    return y @ p["out_proj"].to(dt_), {"state": state, "conv": conv_cache}
