"""Gradient compression for a slow all-reduce: int8 on the wire.

The port's counterpart of ``repro.distributed.compression``. The JAX
package compresses the cross-pod all-reduce, which rides data-center
network; here any data-axis group can take it. An int8 ring all-reduce
with per-chunk scales:

  * quantize: per chunk (default 256 elements) a max-abs scale
    (max|g| / 127, a safe divisor of 1 for an all-zero chunk) and an int8
    payload rounded half to even (``torch.round``, as ``jnp.round``):
    4x fewer bytes than f32 (2x fewer than bf16). The scale is max|g|
    times the f32 reciprocal of 127, as XLA compiles JAX's ``/ 127.0``
    under ``jit``, where the package always runs it (JAX op by op divides,
    and one chunk in about twelve gets a scale one ulp away);
  * ring: P-1 hops, each sending this rank's current contribution to rank
    r+1 and taking rank r-1's (``compat.ring_shift``, JAX's ``ppermute``),
    int8 and f32 scales on the wire, dequantized and accumulated in f32,
    so the loss is quantization only (at most max|x| / 254 a chunk for
    each rank's term), never accumulation. Each hop's dequantize and add
    is one fused multiply-add (``torch.addcmul``), as XLA compiles JAX's
    ``acc + q * s`` on the CPU.

The order of the sum is the JAX code's, not its doc's: rank r adds its
own term first, then rank r-1's, r-2's, and so on around the ring, so
each rank sums the same terms in its own order and the results need not
have the same bits on every rank (JAX's module doc says they do; its code
does not fix the order, and on 16,384 f32 elements over four devices
device 0 and device r differ by up to 2.4e-4). Rank r of the port gives
JAX's device r, bit for bit.

``int8_ring_all_reduce`` takes a tensor on every rank of the data axis (a
collective: every rank calls it); a group of one returns ``x`` untouched,
unquantized, as JAX does.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.distributed import compat
from repro_torch.models.params import tree_map

F32 = torch.float32


def quantize_int8(x: torch.Tensor, chunk: int = 256
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (any shape, f32/bf16) -> (q [N] int8, scales [N/chunk] f32), N the
    element count padded with zeros to a multiple of ``chunk``."""
    flat = x.reshape(-1).to(F32)
    pad = (-flat.numel()) % chunk
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    g = flat.view(-1, chunk)
    scale = g.abs().amax(dim=1) * (1.0 / 127.0)  # XLA's rewrite of / 127
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(g / safe[:, None]), -127, 127)
    return q.to(torch.int8).reshape(-1), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    shape: tuple[int, ...], chunk: int = 256) -> torch.Tensor:
    """The f32 values of ``quantize_int8``'s output, cut to ``shape``."""
    g = q.view(-1, chunk).to(F32) * scale[:, None]
    n = 1
    for d in shape:
        n *= d
    return g.reshape(-1)[:n].reshape(shape)


def int8_ring_all_reduce(x: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """The sum over the data axis of ``x``, int8 on the wire, f32
    accumulation in JAX's ring order (this rank's term, then rank r-1's,
    r-2's, ...), cast back to ``x``'s dtype. A group of one returns ``x``."""
    p = compat.axis_size()
    if p == 1:
        return x
    q, s = quantize_int8(x, chunk)
    acc = q.view(-1, chunk).to(F32) * s[:, None]
    for _ in range(p - 1):
        q, s = compat.ring_shift([q, s])
        # acc + q * s rounded once, as XLA contracts JAX's dequantize-add
        acc = torch.addcmul(acc, q.view(-1, chunk).to(F32), s[:, None])
    return acc.reshape(-1)[:x.numel()].reshape(x.shape).to(x.dtype)


def compressed_psum_tree(tree: Any, chunk: int = 256) -> Any:
    """``int8_ring_all_reduce`` of every leaf of a nested dict."""
    return tree_map(lambda _, x: int8_ring_all_reduce(x, chunk), tree)
