"""The CUDA kernels against their plain PyTorch versions, on a card.

Skips without a CUDA device. Imports no JAX, so on a machine with a card
and without JAX it runs with the repo's conftest switched off:

    PYTHONPATH=src python -m pytest --noconftest -m gpu \
        tests/test_torch_kernels_gpu.py
"""

import subprocess
import sys
import textwrap

import pytest
import torch

from _torch_cases import paged_case, topk_logits
from repro_torch.kernels import ops, ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("t,v,k", [(8, 128256, 64), (3, 4097, 64), (5, 97, 7)])
def test_topk_lse_kernel_matches_plain(cuda, t, v, k):
    x = torch.from_numpy(topk_logits(t, v)).to(cuda)
    got = ops.topk_lse(x, k, impl="cuda")
    want = ref.topk_lse_ref(x, k)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page,npg", [(16, 10), (256, 3), (5, 7)])
def test_paged_decode_attn_kernel_matches_plain(cuda, dtype, page, npg):
    """llama3-8b heads; pages smaller than, equal to and larger than the
    kernel's 16-position tile, with a -1 page inside a row's context."""
    case = paged_case(4, 32, 8, 128, page, npg, hole=True)
    q, kp, vp, pt, pos = (torch.from_numpy(a).to(cuda) for a in case)
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    got = ops.paged_decode_attn(q, kp, vp, pt, pos, impl="cuda")
    want = ref.paged_decode_attn_ref(q.float(), kp.float(), vp.float(), pt,
                                     pos)
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)


@pytest.mark.gpu
def test_paged_decode_attn_kernel_asserts_on_page_past_the_pool(cuda):
    """A table entry past the pool trips the kernel's device assert instead
    of being skipped. The assert ends the CUDA context, so it runs in a
    process of its own."""
    code = textwrap.dedent("""
        import torch
        from repro_torch.kernels import ops
        q = torch.zeros((1, 4, 16), device="cuda")
        kp = torch.zeros((3, 4, 2, 16), device="cuda")
        pt = torch.tensor([[0, 3]], dtype=torch.int32, device="cuda")
        pos = torch.tensor([7], dtype=torch.int32, device="cuda")
        ops.paged_decode_attn(q, kp, kp, pt, pos, impl="cuda")
        torch.cuda.synchronize()
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert "assert" in (proc.stdout + proc.stderr).lower()
