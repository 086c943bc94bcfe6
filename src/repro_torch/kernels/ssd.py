"""Wrapper of the CUDA SSD chunk-scan kernel (``csrc/ssd.cu``).

Replaces the Pallas TPU kernel ``repro.kernels.ssd.ssd``. The source's
header says what bounds it on the H100 and what its design does about that;
its plain version is the chunked scan ``repro_torch.models.ssm.ssd_chunked``
(and the sequential oracle ``kernels.ref.ssd_ref``).
"""

from __future__ import annotations

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# mirror csrc/ssd.cu: rows of the score matrix built at a time, and the
# shared memory one block may use on sm_90
SCORE_ROWS = 32
MAX_SMEM = 232448


def smem_bytes(chunk: int, p: int, n: int) -> int:
    """Shared memory of one block: the [P, N] state, a chunk's B, C and x
    rows, SCORE_ROWS rows of scores and three [L] vectors, in f32."""
    return 4 * (p * (n + 1) + chunk * (n + 1) + chunk * n + chunk * p
                + SCORE_ROWS * chunk + 3 * chunk)


def ssd_cuda(
    x: torch.Tensor,  # [B, S, H, P]
    dt: torch.Tensor,  # [B, S, H] f32
    a: torch.Tensor,  # [H] f32
    b: torch.Tensor,  # [B, S, G, N]
    c: torch.Tensor,  # [B, S, G, N]
    chunk: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the scan on the current stream -> (y [B,S,H,P] in x's dtype,
    final state [B,H,P,N] f32). Chunks of ``chunk`` steps; a shorter last
    chunk runs as it is."""
    from repro_torch.kernels import _build

    tensors = {"x": x, "dt": dt, "a": a, "b": b, "c": c}
    for name, t in tensors.items():
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"ssd: {name} must be on x's CUDA device, got "
                             f"{t.device}")
    if x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise ValueError(f"ssd: x/b/c must share float32 or bfloat16, got "
                         f"{x.dtype}/{b.dtype}/{c.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise ValueError(f"ssd: dt and a must be float32, got {dt.dtype}/"
                         f"{a.dtype}")
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if (dt.shape != (bsz, s, h) or a.shape != (h,) or b.shape[:2] != (bsz, s)
            or c.shape != b.shape or h % g):
        raise ValueError(
            f"ssd: shapes x {tuple(x.shape)} dt {tuple(dt.shape)} a "
            f"{tuple(a.shape)} b {tuple(b.shape)} c {tuple(c.shape)} disagree"
        )
    if chunk <= 0:
        raise ValueError(f"ssd: chunk {chunk} must be positive")
    if smem_bytes(chunk, p, n) > MAX_SMEM:
        raise ValueError(
            f"ssd kernel: chunk {chunk}, P={p}, N={n} need "
            f"{smem_bytes(chunk, p, n)} bytes of shared memory, past the "
            f"card's {MAX_SMEM}"
        )
    x, dt, a = x.contiguous(), dt.contiguous(), a.contiguous()
    b, c = b.contiguous(), c.contiguous()
    y = torch.empty_like(x)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    if bsz == 0 or s == 0:
        return y, state.zero_()
    lib = _build.libraries()["ssd"]
    err = lib.ssd(
        _DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), a.data_ptr(),
        b.data_ptr(), c.data_ptr(), y.data_ptr(), state.data_ptr(),
        bsz, s, h, p, g, n, chunk,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "ssd")
    return y, state
