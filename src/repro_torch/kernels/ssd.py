"""Wrappers of the CUDA SSD chunk-scan kernels (``csrc/ssd.cu``, and its
backward ``csrc/ssd_bwd.cu``).

The forward replaces the Pallas TPU kernel ``repro.kernels.ssd.ssd``; the
backward replaces its gradient, which the JAX package takes by autodiff
through ``repro.models.ssm.ssd_chunked``. Each source's header says what
bounds it on the H100 and what its design does about that. The forward's
plain version is the chunked scan ``repro_torch.models.ssm.ssd_chunked``
(and the sequential oracle ``kernels.ref.ssd_ref``), the backward's
``kernels.ref.ssd_bwd_ref``. A forward call is two grids: the chunks' state
contributions (and their fold into the state entering each chunk), then
the outputs; a backward call four (``csrc/ssd_bwd.cu``).

Each block must fit the card's shared memory (``smem_bytes``): at chunks
of 128 steps and P = 64, f32 takes N up to 272 (the output grid takes 32
rows a block instead of 64 where 64 do not fit) and bf16 N up to 256; the
wrapper raises past that. The backward takes any N, chunks of at most 256
steps with chunk * P at most 8192, and its chunk grid's shared memory
(``bwd_smem_bytes``) within the card's: at P = 64, chunks up to 128.
"""

from __future__ import annotations

import functools

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# mirror csrc/ssd.cu: output rows per block of the f32 second grid, warps'
# scan sums, and the shared memory one block may use on sm_90
OUT_ROWS = 64
OUT_ROWS_SMALL = 32  # where OUT_ROWS of the f32 grid do not fit
_WARPS = 8
MAX_SMEM = 232448
H100_SMS = 132


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def _a16(x: int) -> int:
    return _up(x, 16)


def state_smem_bytes(chunk: int, p: int, nb: int, itemsize: int) -> int:
    """Shared memory of a block of the first grid for its ``nb`` columns of
    N: in bf16 (``state_tc``) x [L16, P16 + 8] and B * w's hi and lo
    [L16, nb + 8] in bf16, three [L16] f32 vectors; in f32 (``state_f32``)
    x [L, P8], B * w [L, nb4] and three [L] vectors; then the scan's sums
    and a flag."""
    if itemsize == 2:
        l16, ps = _up(chunk, 16), _up(p, 16) + 8
        return (_a16(l16 * ps * 2) + 2 * _a16(l16 * (nb + 8) * 2)
                + 3 * _a16(l16 * 4) + _a16(4 * _WARPS) + 16)
    return (_a16(chunk * _up(p, 8) * 4) + _a16(chunk * _up(nb, 4) * 4)
            + 3 * _a16(4 * chunk) + _a16(4 * _WARPS) + 16)


def _out_f32_bytes(chunk: int, p: int, n: int, rows: int) -> int:
    np_, l8, p8 = _up(n, 16), _up(chunk, 8), _up(p, 8)
    cs = np_ + 4
    return (_a16(chunk * p8 * 4) + _a16(l8 * (rows + 4) * 4)
            + _a16(rows * cs * 4) + _a16(max(l8 * cs, np_ * (p8 + 4)) * 4)
            + 2 * _a16(l8 * 4) + _a16(rows * 4) + _a16(_WARPS * 4))


def out_rows(chunk: int, p: int, n: int) -> int:
    """Output rows a block of the f32 second grid takes: OUT_ROWS where
    they fit, else OUT_ROWS_SMALL."""
    if _out_f32_bytes(chunk, p, n, OUT_ROWS) <= MAX_SMEM:
        return OUT_ROWS
    return OUT_ROWS_SMALL


def out_smem_bytes(chunk: int, p: int, n: int, itemsize: int) -> int:
    """Shared memory of a block of the second grid: in bf16 (``out_tc``, a
    whole chunk) C and B [L16, Np + 8], x [L16, P16 + 8] and the entering
    state's hi and lo [P16, Np + 8] in bf16, dt and cum [L16] f32; in f32
    (``out_f32``, R = ``out_rows`` rows of a chunk) x [L, P8], the
    scores^T [L8, R + 4], C [R, Np + 4], then B [L8, Np + 4] or the
    state^T [Np, P8 + 4], and small f32 vectors."""
    np_ = _up(n, 16)
    if itemsize == 2:
        cs, l16, p16 = np_ + 8, _up(chunk, 16), _up(p, 16)
        return (2 * _a16(l16 * cs * 2) + _a16(l16 * (p16 + 8) * 2)
                + 2 * _a16(p16 * cs * 2) + 2 * _a16(l16 * 4)
                + _a16(_WARPS * 4))
    return _out_f32_bytes(chunk, p, n, out_rows(chunk, p, n))


@functools.lru_cache(maxsize=64)
def smem_bytes(chunk: int, p: int, n: int, itemsize: int = 2) -> int:
    """The larger of the two grids' shared memory per block (the first
    grid's with all of N in one block, its largest)."""
    return max(state_smem_bytes(chunk, p, _up(n, 8), itemsize),
               out_smem_bytes(chunk, p, n, itemsize))


def n_parts(bsz: int, h: int, nchunks: int, n: int,
            sms: int = H100_SMS) -> int:
    """Blocks per chunk of the first grid: N is cut in two when one block
    per (batch, head, chunk) would leave the card with fewer than two
    blocks per SM."""
    return 2 if bsz * h * nchunks < 2 * sms and n >= 32 else 1


_TICKETS: dict = {}


def tickets(device: torch.device, n: int) -> torch.Tensor:
    """``n`` int32 counters on ``device`` that are 0 between calls: each
    block of the scan's first grid takes a ticket from its (batch, head)'s
    counter, and the last to arrive folds the chunks and puts the counter
    back to 0, so the counters are zeroed once, when first made or grown,
    and shared by the calls on the device (which run in stream order)."""
    buf = _TICKETS.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _TICKETS[device] = buf
    return buf


def ssd_cuda(
    x: torch.Tensor,  # [B, S, H, P]
    dt: torch.Tensor,  # [B, S, H] f32
    a: torch.Tensor,  # [H] f32
    b: torch.Tensor,  # [B, S, G, N]
    c: torch.Tensor,  # [B, S, G, N]
    chunk: int,
    keep_states: bool = False,
) -> tuple[torch.Tensor, ...]:
    """Launch the scan on the current stream -> (y [B,S,H,P] in x's dtype,
    final state [B,H,P,N] f32), and with ``keep_states`` also the state
    entering each chunk [B,H,nc,P,N] f32 (a view of the scratch the first
    grid folds them into; ``ssd_bwd_cuda`` takes it). Chunks of ``chunk``
    steps; a shorter last chunk runs as it is."""
    from repro_torch.kernels import _build

    _check_scan("ssd", x, dt, a, b, c, chunk)
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    need = smem_bytes(chunk, p, n, x.element_size())
    if need > MAX_SMEM:
        raise ValueError(
            f"ssd kernel: chunk {chunk}, P={p}, N={n} in {x.dtype} need "
            f"{need} bytes of shared memory, past the card's {MAX_SMEM}"
        )
    x, dt, a, b, c = (t if t.is_contiguous() else t.contiguous()
                      for t in (x, dt, a, b, c))
    y = torch.empty_like(x)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    nchunks = -(-s // chunk)
    if bsz == 0 or s == 0:
        empty = (x.new_zeros((bsz, h, nchunks, p, n), dtype=torch.float32),)
        return (y, state.zero_()) + (empty if keep_states else ())
    # f32 scratch: the chunks' [P, N] contributions, then their decays
    ncontrib = bsz * h * nchunks * p * n
    scratch = torch.empty(ncontrib + bsz * h * nchunks, dtype=torch.float32,
                          device=x.device)
    per16 = 16 // x.element_size()
    vec = int(p % per16 == 0 and n % per16 == 0
              and all(t.data_ptr() % 16 == 0 for t in (x, b, c)))
    lib = _build.libraries()["ssd"]
    err = lib.ssd(
        _DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), a.data_ptr(),
        b.data_ptr(), c.data_ptr(), y.data_ptr(), state.data_ptr(),
        scratch.data_ptr(), scratch.data_ptr() + 4 * ncontrib,
        tickets(x.device, bsz * h).data_ptr(),
        bsz, s, h, p, g, n, chunk, n_parts(bsz, h, nchunks, n), vec,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "ssd")
    if keep_states:  # the fold left the entering states in the scratch
        return y, state, scratch[:ncontrib].view(bsz, h, nchunks, p, n)
    return y, state


def _check_scan(what, x, dt, a, b, c, chunk) -> None:
    """The scan's inputs: on x's CUDA device, x/b/c in one of f32 and bf16,
    dt and a in f32, shapes that agree, G dividing H."""
    for name, t in (("x", x), ("dt", dt), ("a", a), ("b", b), ("c", c)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{what}: {name} must be on x's CUDA device, "
                             f"got {t.device}")
    if x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise ValueError(f"{what}: x/b/c must share float32 or bfloat16, got "
                         f"{x.dtype}/{b.dtype}/{c.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise ValueError(f"{what}: dt and a must be float32, got {dt.dtype}/"
                         f"{a.dtype}")
    bsz, s, h, _ = x.shape
    g = b.shape[2]
    if (dt.shape != (bsz, s, h) or a.shape != (h,) or b.shape[:2] != (bsz, s)
            or c.shape != b.shape or h % g):
        raise ValueError(
            f"{what}: shapes x {tuple(x.shape)} dt {tuple(dt.shape)} a "
            f"{tuple(a.shape)} b {tuple(b.shape)} c {tuple(c.shape)} disagree"
        )
    if chunk <= 0:
        raise ValueError(f"{what}: chunk {chunk} must be positive")


# mirror csrc/ssd_bwd.cu: columns of N a tile of the chunk grid, the [L, P]
# register tiles a thread keeps, the longest chunk
BWD_NT = 32
BWD_LP = 2
BWD_MAX_CHUNK = 256
_THREADS = 256


def bwd_contrib_smem_bytes(chunk: int, p: int, nb: int) -> int:
    """Shared memory of a block of the backward's first grid for its ``nb``
    columns of N: dy [L, P4] and C e^{cum} [L, nb4], dt and cum [L4], f32."""
    return (_a16(chunk * _up(p, 4) * 4) + _a16(chunk * _up(nb, 4) * 4)
            + 2 * _a16(_up(chunk, 4) * 4))


@functools.lru_cache(maxsize=64)
def bwd_smem_bytes(chunk: int, p: int) -> int:
    """Shared memory of a block of the backward's chunk grid, in f32 for
    either dtype: x and dy [L4, P4], the L x L matrix [L4, L4 + 4], a tile
    area (the first pass's K-major tiles, the reductions' partial sums or
    the second pass's row-major tiles, the largest of the three), four [L4]
    vectors and a [256] reduction buffer."""
    l4, p4 = _up(chunk, 4), _up(p, 4)
    pass1 = BWD_NT * (2 * (l4 + 4) + 2 * (p4 + 4))
    parts = l4 * (2 * (l4 // 4) + 2 * (p4 // 4))
    pass2 = (BWD_NT + 4) * (2 * l4 + 2 * p4)
    return (2 * _a16(l4 * p4 * 4) + _a16(l4 * (l4 + 4) * 4)
            + _a16(max(pass1, parts, pass2) * 4) + 4 * _a16(l4 * 4)
            + _a16(_THREADS * 4))


def bwd_limit(chunk: int, p: int, n: int, nb: int) -> str | None:
    """Why the backward kernel refuses (chunk, P, N), or None."""
    if chunk > BWD_MAX_CHUNK:
        return f"chunk {chunk} is past {BWD_MAX_CHUNK}"
    if _up(chunk, 4) * _up(p, 4) > 16 * BWD_LP * _THREADS:
        return (f"chunk {chunk} x P={p} is past {16 * BWD_LP * _THREADS} "
                f"(the register tiles of dS' B and S C)")
    need = max(bwd_smem_bytes(chunk, p), bwd_contrib_smem_bytes(chunk, p, nb))
    if need > MAX_SMEM:
        return (f"chunk {chunk}, P={p}, N={n} need {need} bytes of shared "
                f"memory, past the card's {MAX_SMEM}")
    return None


def ssd_bwd_cuda(
    x: torch.Tensor,  # [B, S, H, P]
    dt: torch.Tensor,  # [B, S, H] f32
    a: torch.Tensor,  # [H] f32
    b: torch.Tensor,  # [B, S, G, N]
    c: torch.Tensor,  # [B, S, G, N]
    states: torch.Tensor,  # [B, H, nc, P, N] f32
    dy: torch.Tensor,  # [B, S, H, P] in x's dtype
    dfinal: torch.Tensor | None,  # [B, H, P, N] f32, or None for 0
    chunk: int,
) -> tuple[torch.Tensor, ...]:
    """Launch the scan's backward on the current stream -> (dx, ddt, da,
    dB, dC): dx, dB, dC in x's dtype, ddt [B,S,H] and da [H] f32. The
    states are the forward's (``ssd_cuda(..., keep_states=True)``)."""
    from repro_torch.kernels import _build

    _check_scan("ssd_bwd", x, dt, a, b, c, chunk)
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    nchunks = -(-s // chunk)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"ssd_bwd: dy {tuple(dy.shape)} {dy.dtype} must be "
                         f"x's shape and dtype on its device")
    if (states.shape != (bsz, h, nchunks, p, n)
            or states.dtype != torch.float32 or states.device != x.device):
        raise ValueError(f"ssd_bwd: states {tuple(states.shape)} "
                         f"{states.dtype} must be [{bsz},{h},{nchunks},{p},"
                         f"{n}] f32 on x's device")
    if dfinal is not None and (
            dfinal.shape != (bsz, h, p, n) or dfinal.dtype != torch.float32
            or dfinal.device != x.device):
        raise ValueError(f"ssd_bwd: dfinal {tuple(dfinal.shape)} "
                         f"{dfinal.dtype} must be [{bsz},{h},{p},{n}] f32")
    ns = n_parts(bsz, h, nchunks, n)
    why = bwd_limit(chunk, p, n, _up(-(-n // ns), 8))
    if why:
        raise ValueError(f"ssd_bwd kernel: {why}")
    x, dt, a, b, c, states, dy = (
        t if t.is_contiguous() else t.contiguous()
        for t in (x, dt, a, b, c, states, dy))
    if dfinal is not None and not dfinal.is_contiguous():
        dfinal = dfinal.contiguous()
    dx, db, dc = torch.empty_like(x), torch.empty_like(b), torch.empty_like(c)
    ddt, da = torch.empty_like(dt), torch.empty_like(a)
    if bsz == 0 or s == 0:
        return dx, ddt, da.zero_(), db, dc
    f32 = dict(dtype=torch.float32, device=x.device)
    gs = torch.empty_like(states)  # each chunk's dS'
    dec = torch.empty(bsz * h * nchunks, **f32)
    dapart = torch.empty(bsz * h * nchunks, **f32)
    dbp = torch.empty((bsz, s, h, n), **f32)  # dB, dC of each head
    dcp = torch.empty((bsz, s, h, n), **f32)
    lib = _build.libraries()["ssd_bwd"]
    err = lib.ssd_bwd(
        _DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), a.data_ptr(),
        b.data_ptr(), c.data_ptr(), states.data_ptr(), dy.data_ptr(),
        None if dfinal is None else dfinal.data_ptr(), dx.data_ptr(),
        ddt.data_ptr(), da.data_ptr(), db.data_ptr(), dc.data_ptr(),
        gs.data_ptr(), dec.data_ptr(), dapart.data_ptr(), dbp.data_ptr(),
        dcp.data_ptr(), bsz, s, h, p, g, n, chunk, ns,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "ssd_bwd")
    return dx, ddt, da, db, dc
