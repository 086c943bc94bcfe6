"""The port's kernel entry points against the JAX package's kernels.

On the CPU the port's ops take their plain PyTorch versions; these must
compute what the Pallas kernels compute (run here in interpret mode, at
the smallest shapes) and what the jnp oracles compute. The CUDA kernels
are held against the same plain versions in ``test_torch_kernels_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attn as DA_mod
from repro.kernels import ref as jref
from repro.kernels import topk_lse as TK_mod
from _torch_cases import paged_case as _paged_case
from _torch_cases import topk_logits as _topk_logits
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

TOPK_RTOL = 1e-6  # values are copies; lse is an f32 sum in another order
PAGED_ATOL = 1e-5  # f32 attention, summation order only


def _assert_topk_equal(port, want):
    np.testing.assert_array_equal(port[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(port[0].numpy(), np.asarray(want[0]),
                               rtol=TOPK_RTOL)
    np.testing.assert_allclose(port[2].numpy(), np.asarray(want[2]),
                               rtol=TOPK_RTOL)


@pytest.mark.parametrize("t,v,k", [(8, 128, 8), (5, 97, 16), (3, 300, 64),
                                   (4, 40, 40)])
def test_topk_lse_plain_matches_jax_ref(t, v, k):
    x = _topk_logits(t, v)
    _assert_topk_equal(ops.topk_lse(torch.from_numpy(x), k),
                       jref.topk_lse_ref(jnp.asarray(x), k))


@pytest.mark.parametrize("t,v,k", [(5, 300, 16), (6, 130, 130),
                                   (5, 300, 200)])
def test_topk_lse_plain_matches_jax_interpret_kernel(t, v, k):
    """Includes k == V (a value-sorted permutation of the row) and k = 200
    of 300."""
    x = _topk_logits(t, v, seed=1)
    want = TK_mod.topk_lse(jnp.asarray(x), k, bt=8, bv=128, interpret=True)
    _assert_topk_equal(ops.topk_lse(torch.from_numpy(x), k), want)


def test_topk_lse_plain_matches_jax_interpret_kernel_on_bf16_logits():
    """bf16 logits, which the kernels read in their own dtype: rounding to
    bf16 makes many ties, each going to the lowest index; indices exact."""
    x = _topk_logits(6, 300, seed=2)
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    want = TK_mod.topk_lse(jnp.asarray(xb, jnp.bfloat16), 200, bt=8, bv=128,
                           interpret=True)
    got = ops.topk_lse(torch.from_numpy(xb.copy()).to(torch.bfloat16), 200)
    top = np.sort(xb, axis=1)[:, -200:]
    assert all(len(np.unique(r)) < 200 for r in top)  # ties in every top-k
    _assert_topk_equal(got, want)


def test_topk_lse_signed_zeros_tie_to_the_lowest_index():
    """-0.0 and +0.0 are equal to the Pallas kernel (its max and argmax
    compare values): they tie, and the lower index comes first whichever of
    the two it holds. The jnp oracle's jax.lax.top_k orders +0.0 above
    -0.0; the port follows the kernel."""
    row = np.full(64, -1.0, np.float32)
    row[50] = 2.0
    row[[3, 10, 20, 40]] = [0.0, -0.0, 0.0, -0.0]
    row2 = row.copy()
    row2[[3, 10]] = [-0.0, 0.0]
    x = np.stack([row, row2, np.tile(row[:32], 2)])
    got = ops.topk_lse(torch.from_numpy(x), 5)
    assert got[1][0].tolist() == [50, 3, 10, 20, 40]
    assert got[1][1].tolist() == [50, 3, 10, 20, 40]
    _assert_topk_equal(got, TK_mod.topk_lse(jnp.asarray(x), 5, bt=8,
                                            bv=128, interpret=True))


def test_topk_lse_tie_break_lowest_index():
    """torch.topk promises no order among ties; the port's plain version
    must give jax.lax.top_k's lowest-index-first order."""
    row = np.array([2.0, 5.0, 5.0, 1.0, 5.0, 0.0, 2.0, 7.0], np.float32)
    x = np.tile(row, (4, 32))
    vals, idx, _ = ops.topk_lse(torch.from_numpy(x), 9)
    want = jref.topk_lse_ref(jnp.asarray(x), 9)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want[1]))
    assert idx[0, :4].tolist() == [7, 15, 23, 31]


def test_topk_lse_extreme_logits_stable():
    x = np.asarray([[1e4, -1e4, 0.0, 5e3] * 64] * 8, np.float32)
    port = ops.topk_lse(torch.from_numpy(x), 4)
    assert torch.isfinite(port[0]).all() and torch.isfinite(port[2]).all()
    _assert_topk_equal(port, jref.topk_lse_ref(jnp.asarray(x), 4))


@pytest.mark.parametrize("k", [0, -1, 201])
def test_topk_lse_rejects_k_out_of_range(k):
    x = torch.zeros((2, 200))
    with pytest.raises(ValueError):
        ops.topk_lse(x, k)


@pytest.mark.parametrize("shape,hole", [((2, 8, 2, 32, 16, 4), False),
                                        ((3, 4, 4, 16, 4, 5), True),
                                        ((2, 4, 1, 8, 64, 2), True),
                                        # the JAX test's G = 16, and a
                                        # granite-34b-like G = 48
                                        ((2, 16, 1, 16, 5, 3), True),
                                        ((2, 48, 1, 8, 4, 3), False)])
def test_paged_decode_attn_plain_matches_jax_interpret_kernel(shape, hole):
    case = _paged_case(*shape, hole=hole)
    want = DA_mod.paged_decode_attn(*map(jnp.asarray, case), interpret=True)
    got = ops.paged_decode_attn(*map(torch.from_numpy, case))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=PAGED_ATOL)


@pytest.mark.parametrize("hq", [4, 48])
def test_paged_decode_attn_rows_with_nothing_attended(hq):
    """A row whose pages are all -1 and a row with pos = -1 attend nothing:
    every score is -1e30, so the weights are equal over the NP * page
    positions the table addresses, a -1 page read as page 0 (the Pallas
    kernel's DMA clamps it, the plain version's gather does): the mean of
    V there, in both packages."""
    q, kp, vp, pt, pos = _paged_case(4, hq, 1, 16, 4, 3, seed=6)
    pt[0] = -1
    pos[1] = -1
    want = DA_mod.paged_decode_attn(*map(jnp.asarray, (q, kp, vp, pt, pos)),
                                    interpret=True)
    got = ops.paged_decode_attn(*map(torch.from_numpy, (q, kp, vp, pt, pos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=PAGED_ATOL)
    for row in (0, 1):
        pages = np.maximum(pt[row], 0)
        mean = vp[pages].reshape(-1, 16).mean(axis=0)  # hkv = 1
        np.testing.assert_allclose(got[row].numpy(),
                                   np.broadcast_to(mean, (hq, 16)),
                                   atol=PAGED_ATOL)


def test_paged_decode_attn_plain_matches_jax_ref_without_holes():
    case = _paged_case(2, 8, 2, 32, 8, 3, seed=4)
    want = jref.paged_decode_attn_ref(*map(jnp.asarray, case))
    got = ref.paged_decode_attn_ref(*map(torch.from_numpy, case))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=PAGED_ATOL)


def test_paged_decode_attn_plain_refuses_page_past_the_pool():
    """A table entry past the pool is a caller's bug: the plain version
    raises (the kernel trips a device assert), it does not skip the page."""
    q, kp, vp, pt, pos = map(torch.from_numpy, _paged_case(2, 4, 2, 16, 4, 3))
    pt[1, 0] = kp.shape[0]
    with pytest.raises(IndexError):
        ops.paged_decode_attn(q, kp, vp, pt, pos)


def test_dispatch_follows_the_tensor_device():
    """A CPU tensor takes the plain version and launches nothing; asking
    for the kernel on a CPU tensor raises instead of falling back."""
    x = torch.from_numpy(_topk_logits(3, 64))
    before = dict(ops.LAUNCHES)
    ops.topk_lse(x, 4)
    case = [torch.from_numpy(a) for a in _paged_case(1, 4, 2, 16, 4, 2)]
    ops.paged_decode_attn(*case)
    assert ops.LAUNCHES == before
    with pytest.raises(ValueError):
        ops.topk_lse(x, 4, impl="cuda")
    with pytest.raises(ValueError):
        ops.paged_decode_attn(*case, impl="cuda")
    with pytest.raises(ValueError):
        ops.topk_lse(x, 4, impl="pallas")
