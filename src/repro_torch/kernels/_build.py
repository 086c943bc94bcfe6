"""Build and load the hand-written CUDA kernels under ``kernels/csrc/``.

Each ``.cu`` file has a plain C interface and is compiled by ``nvcc`` into
its own shared library for ``sm_90a``, all files in parallel, on first use.
The libraries are loaded with ``ctypes``; nothing includes PyTorch's headers,
which keeps a cold build to seconds instead of minutes.

Libraries land in ``build/kernels/`` at the repository root, named by a
hash of their source and of the headers beside it (``*.cuh``), so an
edited source or header rebuilds and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# exported C function -> argtypes (every one returns a cudaError_t as int)
SIGNATURES = {
    "topk_lse": [
        _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P, _P, _P, _P,
    ],
    "paged_decode_attn": [
        _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I,
        _I, _I, _I, _I, _P,
    ],
    "decode_attn": [
        _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I,
        _I, _P,
    ],
    "ssd": [
        _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
        _I, _I, _I, _P,
    ],
    "ssd_bwd": [_I] + [_P] * 19 + [_I] * 8 + [_P],
    "xent_fwd": [_I, _P, _P, _I, _I, _I, _P, _P, _P],
    "xent_bwd": [_I, _P, _P, _P, _P, _I, _I, _I, _P, _P],
    "ledger_record_priority": [
        _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _F, _F, _F, _F,
        _P, _P,
    ],
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found: nvcc is needed to build "
                           "the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _target(src: Path) -> Path:
    """The library of ``src``, named by a hash of the source, every header
    beside it (a source may include any of them) and the flags."""
    digest = hashlib.sha1(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:12]}.so"


@functools.cache
def libraries() -> dict[str, ctypes.CDLL]:
    """Compile what is missing (one ``nvcc`` per source, all at once) and
    load every library; ``build_report()`` has the timings and ptxas
    output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        out = _target(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        jobs.append((src, out, tmp, proc))
    log = []
    for src, out, tmp, proc in jobs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{text}")
        os.replace(tmp, out)  # atomic: a reader never sees half a library
        log.append(f"{src.name}: {text.strip()}")
    _REPORT.update(seconds=time.perf_counter() - t0, built=len(jobs),
                   log="\n".join(log))
    libs = {}
    for src in sorted(CSRC.glob("*.cu")):
        lib = ctypes.CDLL(str(_target(src)))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name, None)
            if fn is not None:
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        libs[src.stem] = lib
    return libs


_REPORT: dict = {}


def build_report() -> dict:
    """{"seconds", "built", "log"} of the build ``libraries()`` ran."""
    return dict(_REPORT)


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code (cudaError_t)."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError_t {err}")
