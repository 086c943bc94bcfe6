"""The port's dense-cache decode against the JAX package's.

``ops.decode_attn``'s plain version against the Pallas ``decode_attn`` run
in interpret mode (the contract of ``test_decode_attn_matches_ref``: f32
within 2e-6, bf16 within 3e-2), and the dense-cache layer functions
(``gqa_init_cache``, ``gqa_fill_cache``, ``gqa_decode``) against JAX's on
the llama3-8b smoke config in float32 (outputs within 1e-5) with the bf16
layout, the int8 layout (values and scales equal) and a rolling sliding
window, for more decode steps than the cache holds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import decode_case
from repro import configs as jconfigs
from repro.kernels import decode_attn as DA_mod
from repro.kernels import ref as jref
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.params import materialize as jmaterialize
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import from_jax

torch.set_num_threads(1)

DECODE_TOL = {"float32": 2e-6, "bfloat16": 3e-2}  # test_decode_attn_matches_ref
LAYER_ATOL = 1e-5
JCFG = dataclasses.replace(jconfigs.get_smoke("llama3-8b"),
                           param_dtype="float32", compute_dtype="float32")


def _both(arrays, dtype):
    """The same values as jnp and torch arrays in ``dtype`` (bf16 rounds
    f32 to nearest even in both)."""
    jx = [jnp.asarray(a).astype(dtype) if a.dtype == np.float32
          else jnp.asarray(a) for a in arrays]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype))
          if a.dtype == np.float32 else torch.from_numpy(a) for a in arrays]
    return jx, tx


@pytest.mark.parametrize(
    "b,hq,hkv,d,t",
    [(2, 8, 2, 64, 300), (1, 4, 4, 128, 128), (3, 16, 1, 64, 700),
     (2, 4, 2, 32, 129)],
)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attn_plain_matches_jax_interpret_kernel(b, hq, hkv, d, t,
                                                        dtype):
    (jq, jk, jv, jm), (tq, tk, tv, tm) = _both(decode_case(b, hq, hkv, d, t),
                                               dtype)
    want = DA_mod.decode_attn(jq, jk, jv, jm, bt=128, interpret=True)
    got = ops.decode_attn(tq, tk, tv, tm)
    assert got.dtype == tq.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=DECODE_TOL[dtype])
    np.testing.assert_allclose(
        got.float().numpy(),
        np.asarray(jref.decode_attn_ref(jq, jk, jv, jm), np.float32),
        atol=DECODE_TOL[dtype])


def test_decode_attn_plain_single_valid_position():
    q, k, v, _ = decode_case(1, 2, 1, 16, 64, seed=4)
    valid = (np.arange(64) == 17)[None]
    got = ops.decode_attn(*map(torch.from_numpy, (q, k, v, valid)))
    np.testing.assert_allclose(got[0].numpy(), np.repeat(v[0, 17], 2, 0),
                               atol=1e-5)


def test_decode_attn_plain_all_masked_row_is_the_mean_of_v():
    """A row with no valid position: every score is -1e30, so the weights
    are uniform over all T (the Pallas kernel's answer at a T that needs no
    padding), not 0 and not NaN."""
    q, k, v, valid = decode_case(2, 4, 2, 32, 128, seed=5, lens=[0, 50])
    got = ops.decode_attn(*map(torch.from_numpy, (q, k, v, valid)))
    mean = np.repeat(v[0].mean(axis=0), 2, axis=0)  # [Hq, D]
    np.testing.assert_allclose(got[0].numpy(), mean, atol=2e-6)
    want = DA_mod.decode_attn(*map(jnp.asarray, (q, k, v, valid)), bt=128,
                              interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


def test_decode_attn_dispatch_follows_the_tensor_device():
    case = [torch.from_numpy(a) for a in decode_case(1, 4, 2, 16, 8)]
    before = dict(ops.LAUNCHES)
    ops.decode_attn(*case)
    assert ops.LAUNCHES == before
    with pytest.raises(ValueError):
        ops.decode_attn(*case, impl="cuda")


# ---------------------------------------------------------------------------
# the kernel's spans and their merge (its arithmetic, in plain PyTorch)
# ---------------------------------------------------------------------------


def _span_mask(b, t, span, rng):
    """Row 0 masked whole; row 1 valid only inside span 1 (every other span
    has no valid position); other rows random prefixes."""
    lens = rng.integers(1, t + 1, size=b)
    valid = np.arange(t)[None, :] < lens[:, None]
    valid[0] = False
    valid[1] = False
    valid[1, span + 3:min(t, 2 * span - 5)] = True
    return valid


@pytest.mark.parametrize(
    "b,hq,hkv,d,t",
    [(3, 16, 1, 64, 700),  # the JAX test's G = 16
     (3, 48, 1, 32, 203)],  # granite-34b's MQA group, G = 48
)
def test_decode_attn_partials_merge_matches_plain_and_jax(b, hq, hkv, d, t):
    """The spans the kernel would cut at this shape (``split_plan``;
    the last span shorter), merged: within 2e-6 of the plain version, and
    of the Pallas kernel in interpret mode on the rows with a valid
    position (at a T that is no multiple of its block the Pallas kernel
    averages an all-masked row over the padded length); an all-masked row
    is the mean of V."""
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.decode_attn import split_plan

    _, _, nsplit, span, _ = split_plan(b, hq, hkv, t, d, 4)
    assert nsplit > 1 and t % span != 0  # spans of unequal length
    q, k, v, _ = decode_case(b, hq, hkv, d, t, seed=t)
    valid = _span_mask(b, t, span, np.random.default_rng(t))
    tq, tk, tv, tm = map(torch.from_numpy, (q, k, v, valid))
    m, l_, acc = R.decode_attn_partials(tq, tk, tv, tm, span)
    assert m.shape == (b, hkv, hq // hkv, nsplit)
    # span 0 of row 1 has no valid position: its merge weight is exactly 0
    assert (m[1, ..., 0] == -1e30).all()
    assert (torch.exp(m[1, ..., 0] - m[1].amax(dim=-1)) == 0).all()
    # and it is not read; an all-masked row's spans all are
    assert (l_[1, ..., 0] == 0).all() and (acc[1, ..., 0, :] == 0).all()
    assert (l_[0] > 0).all()
    got = R.decode_attn_merge(m, l_, acc)
    np.testing.assert_allclose(
        got.numpy(), R.decode_attn_ref(tq, tk, tv, tm).numpy(),
        atol=DECODE_TOL["float32"])
    want = DA_mod.decode_attn(*map(jnp.asarray, (q, k, v, valid)), bt=128,
                              interpret=True)
    np.testing.assert_allclose(got[1:].numpy(), np.asarray(want)[1:],
                               atol=DECODE_TOL["float32"])
    mean = np.repeat(v[0].mean(axis=0), hq // hkv, axis=0)
    np.testing.assert_allclose(got[0].numpy(), mean, atol=2e-6)


@pytest.mark.parametrize("span", [16, 64, 100])
def test_decode_attn_partials_skipping_empty_spans_changes_nothing(span):
    """Rows of mixed lengths in a 512-slot cache, an all-masked row and a
    row valid in one span only: the merge of partials that skip the spans
    with no valid position (as the kernel does) equals, within 2e-6, the
    merge of partials that read every span, and the plain version."""
    from repro_torch.kernels import ref as R

    b, hq, hkv, d, t = 5, 8, 2, 32, 512
    q, k, v, _ = decode_case(b, hq, hkv, d, t, seed=span)
    valid = _span_mask(b, t, span, np.random.default_rng(span))
    valid[2] = np.arange(t) < 50  # a short prompt in a long cache
    tq, tk, tv, tm = map(torch.from_numpy, (q, k, v, valid))
    skipped = R.decode_attn_partials(tq, tk, tv, tm, span)
    assert (skipped[1][2, ..., -1] == 0).all()  # row 2's last span
    read = R.decode_attn_partials(tq, tk, tv, tm, span, read_empty=True)
    got = R.decode_attn_merge(*skipped)
    np.testing.assert_allclose(got.numpy(),
                               R.decode_attn_merge(*read).numpy(),
                               atol=DECODE_TOL["float32"])
    np.testing.assert_allclose(
        got.numpy(), R.decode_attn_ref(tq, tk, tv, tm).numpy(),
        atol=DECODE_TOL["float32"])


@pytest.mark.parametrize(
    "shape,plan",
    [((8, 32, 32, 332, 80, 2), (1, 1, 4, 83, 83)),  # zamba2's shared block
     ((8, 32, 8, 160, 128, 2), (1, 4, 5, 32, 32)),  # llama3-8b, dense cache
     ((8, 48, 1, 512, 128, 2), (3, 16, 8, 64, 64)),  # granite-34b-like MQA
     ((3, 16, 1, 700, 64, 4), (1, 16, 8, 88, 64)),  # the JAX test's G = 16
     # llama3-8b's heads at mixed lengths: four tiles a span, each skipped
     # where it holds no valid position
     ((8, 32, 8, 2048, 128, 2), (1, 4, 8, 256, 64)),
     ((2, 16, 1, 300, 256, 4), (1, 16, 8, 38, 16)),  # D = 256 in f32
     ((1, 4, 4, 32768, 128, 2), (1, 1, 8, 4096, 64))],  # a long cache
)
def test_dense_split_plan(shape, plan):
    """Spans, head slices and tiles per call: one tile per span at the
    serving shapes (more spans than tiles where the call would be short of
    blocks), several tiles a span past eight spans (a cluster's most),
    every position in exactly one span, a tile's K and V rows within the
    shared-memory budget."""
    from repro_torch.kernels import decode_attn as DA

    b, hq, hkv, t, d, itemsize = shape
    got = DA.split_plan(b, hq, hkv, t, d, itemsize)
    assert got == plan
    gslices, gsz, nsplit, span, tile = got
    assert gsz <= DA.GROUP_PER_BLOCK and gslices * gsz >= hq // hkv
    assert nsplit <= DA.MAX_SPLIT and tile <= DA.MAX_TILE
    assert (nsplit - 1) * span < t <= nsplit * span
    rowb = -(-d * itemsize // 16) * 16 + 16
    assert 2 * tile * rowb <= DA.TILE_BYTES


@pytest.mark.parametrize(
    "shape",
    [(8, 32, 8, 10, 16, 128, 2),  # the paged llama3-8b serve: T = 160
     (8, 32, 8, 128, 16, 128, 2),  # a 2048-position table
     (8, 48, 1, 32, 16, 128, 2),  # granite-34b-like MQA, G = 48
     (3, 16, 1, 3, 5, 64, 4),  # the JAX test's G = 16, pages of 5
     (4, 32, 8, 3, 256, 128, 2),  # pages of 256: spans inside one page
     (2, 8, 2, 7, 5, 36, 4),  # f32 rows of 144 bytes
     (1, 4, 4, 256, 128, 128, 2)],  # a 32768-position table
)
def test_paged_split_plan(shape):
    """The paged kernel's plan, ``split_plan`` at T = NP * page, from
    shapes alone (never pos): its spans cover the positions the table
    addresses, each exactly once, at most eight to a cluster; its head
    slices cover G; a tile fits the shared-memory budget."""
    from repro_torch.kernels import decode_attn as DA

    b, hq, hkv, npg, page, d, itemsize = shape
    t = npg * page
    gslices, gsz, nsplit, span, tile = DA.split_plan(
        b, hq, hkv, t, d, itemsize)
    g = hq // hkv
    assert gsz <= DA.GROUP_PER_BLOCK
    assert (gslices - 1) * gsz < g <= gslices * gsz
    assert 1 <= nsplit <= DA.MAX_SPLIT
    assert (nsplit - 1) * span < t <= nsplit * span
    assert 1 <= tile <= min(DA.MAX_TILE, span)
    rowb = -(-d * itemsize // 16) * 16 + 16
    assert 2 * tile * rowb <= DA.TILE_BYTES


@pytest.mark.parametrize(
    "chunk,p,n,itemsize,blocks_per_sm",
    [(128, 64, 128, 2, 1),  # mamba2-370m, bf16: 96 blocks at its prefill
     (128, 64, 64, 2, 3),  # zamba2-2.7b, bf16
     (128, 64, 256, 2, 1),  # N = 256 at L = 128: past the old kernel's room
     (128, 64, 64, 4, 1),  # the f32 path
     (128, 64, 256, 4, 1)],  # f32 at N = 256: 32 output rows a block
)
def test_ssd_shared_memory_fits(chunk, p, n, itemsize, blocks_per_sm):
    """The scan's shared memory per block against the card's 227 KB: a
    block of the output grid stages a whole chunk, and zamba2's shape
    leaves room for three of them on an SM."""
    from repro_torch.kernels import ssd as SSD

    need = SSD.smem_bytes(chunk, p, n, itemsize)
    assert blocks_per_sm * need <= SSD.MAX_SMEM
    assert SSD.smem_bytes(chunk, p, n, itemsize) >= SSD.out_smem_bytes(
        chunk, p, n, itemsize)


def test_ssd_shared_memory_refuses_f32_at_n_256():
    """Where the wrapper refuses f32 at N = 256: from chunks of 192 steps
    on. At the chunks of 128 the models use it now fits (the f32 output
    grid takes 32 rows a block where 64 do not fit), and the refusal at
    L = 128 starts past N = 272 in f32 and past 256 in bf16."""
    from repro_torch.kernels import ssd as SSD

    assert SSD.smem_bytes(256, 64, 256, 4) > SSD.MAX_SMEM
    assert SSD.smem_bytes(192, 64, 256, 4) > SSD.MAX_SMEM
    assert SSD.smem_bytes(128, 64, 256, 4) <= SSD.MAX_SMEM
    assert SSD.smem_bytes(128, 64, 272, 4) <= SSD.MAX_SMEM
    assert SSD.smem_bytes(128, 64, 288, 4) > SSD.MAX_SMEM
    assert SSD.smem_bytes(128, 64, 272, 2) > SSD.MAX_SMEM
    assert SSD.n_parts(1, 32, 3, 128) == 2  # mamba2's prefill: 96 chunks
    assert SSD.n_parts(4, 80, 16, 64) == 1  # 5120 chunks


@pytest.mark.parametrize("n,rows,total", [
    (64, 64, 32768 + 34816 + 17408 + 34816 + 1312),
    (128, 64, 32768 + 34816 + 33792 + 67584 + 1312),
    (256, 32, 32768 + 18432 + 33280 + 133120 + 1184)])
def test_ssd_f32_output_layout_mirror(n, rows, total):
    """csrc/ssd.cu's out_f32 at L = 128, P = 64, summed by hand: x [128,
    64], scores^T [128, R + 4], C [R, Np + 4], then B [128, Np + 4] or the
    state^T [Np, 68] in the same bytes, then dt, cum [128], exp(cum) [R]
    and the warps' sums. R = 64 rows a block while that fits, 32 past
    it."""
    from repro_torch.kernels import ssd as SSD

    assert SSD.out_rows(128, 64, n) == rows
    assert SSD.out_smem_bytes(128, 64, n, 4) == total
    assert SSD.smem_bytes(128, 64, n, 4) <= SSD.MAX_SMEM


# ---------------------------------------------------------------------------
# the dense-cache layer functions
# ---------------------------------------------------------------------------

LAYOUTS = {
    "bf16": {},
    "int8": {"kv_cache_dtype": "int8"},
    "window": {"sliding_window": 4},
}


@pytest.fixture(scope="module")
def attn_weights():
    specs = JM.param_specs(JCFG)
    jp = jax.jit(lambda k: jmaterialize(specs, k, jnp.float32))(
        jax.random.key(2))
    ja = jax.tree.map(lambda x: x[0], jp["blocks"]["attn"])
    return ja, from_jax(jax.tree.map(np.asarray, ja), "cpu")


def _assert_cache_equal(tc, jc, int8):
    assert set(tc) == set(jc)
    for name in tc:
        got, want = tc[name].numpy(), np.asarray(jc[name])
        if int8 and name in ("k", "v"):
            assert got.dtype == np.int8
            np.testing.assert_array_equal(got, want, err_msg=name)
        elif int8:
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, atol=LAYER_ATOL,
                                       err_msg=name)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("per_slot", [False, True])
def test_dense_cache_decode_matches_jax(attn_weights, layout, per_slot):
    """Prefill 6 tokens into a cache of max_seq 9 (4 rolling slots with the
    window), then 8 decode steps, past the cache's capacity, with the whole
    batch at one depth (scalar pos) or each row at its own (vector pos)."""
    ja, ta = attn_weights
    jcfg = dataclasses.replace(JCFG, **LAYOUTS[layout])
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    int8 = layout == "int8"
    b, s, max_seq = 3, 6, 9
    rs = np.random.default_rng(11)
    x = rs.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    empty = L.gqa_init_cache(cfg, b, max_seq, torch.float32, "cpu")
    jempty = JL.gqa_init_cache(jcfg, b, max_seq, jnp.float32)
    _assert_cache_equal(empty, jempty, int8)
    jo, jc = jax.jit(JL.gqa_fill_cache, static_argnums=(2, 4))(
        jnp.asarray(x), ja, jcfg, jnp.arange(s), max_seq)
    decode = jax.jit(JL.gqa_decode, static_argnums=(2, 5))
    to, tc = L.gqa_fill_cache(torch.from_numpy(x), ta, cfg,
                              torch.arange(s), max_seq)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=LAYER_ATOL)
    _assert_cache_equal(tc, jc, int8)
    pos = np.array([s, s - 2, s - 5] if per_slot else s, np.int64)
    for step in range(8):
        xt = rs.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
        jo, jc = decode(jnp.asarray(xt), ja, jcfg, jc,
                        jnp.asarray(pos, jnp.int32), max_seq)
        to, tc = L.gqa_decode(torch.from_numpy(xt), ta, cfg, tc,
                              torch.from_numpy(pos), max_seq)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo),
                                   atol=LAYER_ATOL, err_msg=f"step {step}")
        _assert_cache_equal(tc, jc, int8)
        pos = np.asarray(pos + 1)


@pytest.mark.parametrize("layout", ["int8", "window"])
def test_dense_model_decode_with_cache_layouts_matches_jax(layout):
    """prefill + decode_step of the whole smoke model with the int8 or the
    rolling-window cache: logits within 1e-4 (the model tests' bound) and
    the cache sized by ``gqa_cache_len``."""
    jcfg = dataclasses.replace(JCFG, **LAYOUTS[layout])
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    specs = JM.param_specs(jcfg)
    jp = jax.jit(lambda k: jmaterialize(specs, k, jnp.float32))(
        jax.random.key(0))
    tp = from_jax(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 7),
                                             dtype=np.int32)
    jl, jc = jax.jit(JM.prefill, static_argnums=(1, 3))(
        jp, jcfg, jnp.asarray(toks), 12)
    decode = jax.jit(JM.decode_step, static_argnums=1)
    tl, tc = M.prefill(tp, cfg, torch.from_numpy(toks), 12)
    assert M.init_cache(cfg, 2, 12, "cpu")["blocks"]["k"].shape[2] == \
        L.gqa_cache_len(cfg, 12)
    pos = np.array([7, 7], np.int32)
    for step in range(6):
        nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
        jl, jc = decode(jp, jcfg, jc, jnp.asarray(nxt), jnp.asarray(pos))
        tl, tc = M.decode_step(tp, cfg, tc, torch.from_numpy(nxt),
                               torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   err_msg=f"step {step}")
        pos = pos + 1


@pytest.mark.parametrize("change", [{"kv_cache_dtype": "int8"},
                                    {"sliding_window": 8}])
def test_paged_cache_refuses_int8_and_windows(change):
    cfg = dataclasses.replace(ModelConfig(**dataclasses.asdict(JCFG)),
                              **change)
    with pytest.raises(NotImplementedError):
        M.init_paged_cache(cfg, 4, 4, "cpu")
