"""The port's dense model against the JAX package's, weights carried by
``from_jax``, on the llama3-8b smoke config in float32.

Logits agree to atol 1e-4, the bound ``tests/test_models_smoke.py`` uses;
inside the port, paged decode agrees with dense decode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro.models.params import materialize as jmaterialize
from repro_torch import configs
from repro_torch.core.scatter import put_rows
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import from_jax, materialize, tree_leaves

torch.set_num_threads(1)

ATOL = 1e-4
JCFG = dataclasses.replace(jconfigs.get_smoke("llama3-8b"),
                           param_dtype="float32", compute_dtype="float32")
CFG = ModelConfig(**dataclasses.asdict(JCFG))


@pytest.fixture(scope="module")
def weights():
    jp = jmaterialize(JM.param_specs(JCFG), jax.random.key(0), jnp.float32)
    return jp, from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, (b, s)).astype(np.int32)


def test_param_specs_match_jax_shapes():
    jshapes = sorted(x.shape for x in jax.tree.leaves(
        JM.param_specs(JCFG), is_leaf=lambda x: hasattr(x, "axes")))
    tshapes = sorted(s.shape for s in tree_leaves(M.param_specs(CFG)))
    assert jshapes == tshapes
    a = materialize(M.param_specs(CFG), 3, torch.float32, "cpu")
    b = materialize(M.param_specs(CFG), 3, torch.float32, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def test_forward_hidden_matches_jax(weights):
    jp, tp = weights
    toks = _tokens(2, 12)
    want, _ = JM.forward_hidden(jp, JCFG, jnp.asarray(toks))
    got, aux = M.forward_hidden(tp, CFG, torch.from_numpy(toks))
    assert float(aux) == 0.0  # no MoE layer
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_prefill_and_vector_pos_decode_match_jax(weights):
    """Right-padded prompts (last_pos), then per-row depths in decode."""
    jp, tp = weights
    toks = _tokens(3, 10, seed=1)
    last = np.asarray([9, 6, 3], np.int32)
    jl, jc = JM.prefill(jp, JCFG, jnp.asarray(toks), 16,
                        last_pos=jnp.asarray(last))
    tl, tc = M.prefill(tp, CFG, torch.from_numpy(toks), 16,
                       last_pos=torch.from_numpy(last))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    pos = last + 1
    for step in range(3):
        nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
        jl, jc = JM.decode_step(jp, JCFG, jc, jnp.asarray(nxt),
                                jnp.asarray(pos))
        tl, tc = M.decode_step(tp, CFG, tc, torch.from_numpy(nxt),
                               torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   err_msg=f"step {step}")
        pos = pos + 1


def test_scalar_pos_decode_matches_jax(weights):
    jp, tp = weights
    toks = _tokens(2, 6, seed=2)
    jl, jc = JM.prefill(jp, JCFG, jnp.asarray(toks), 9)
    tl, tc = M.prefill(tp, CFG, torch.from_numpy(toks), 9)
    nxt = _tokens(2, 1, seed=3)
    jl, _ = JM.decode_step(jp, JCFG, jc, jnp.asarray(nxt), jnp.asarray(6))
    tl, _ = M.decode_step(tp, CFG, tc, torch.from_numpy(nxt), torch.tensor(6))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)


def test_paged_decode_matches_dense_decode(weights):
    """The same rows decoded through a shuffled page pool and through the
    dense cache give the same logits; a row with no pages drops its K/V
    write instead of wrapping onto the pool's last page."""
    _, tp = weights
    b, plen, page, npg = 3, 7, 4, 4
    toks = torch.from_numpy(_tokens(b, plen, seed=4))
    logits, dense = M.prefill(tp, CFG, toks, npg * page)
    paged = M.init_paged_cache(CFG, b * npg + 2, page, "cpu")
    perm = torch.randperm(b * npg + 2, generator=torch.Generator().manual_seed(0))
    table = perm[: b * npg].reshape(b, npg).to(torch.int32)
    table[2] = -1  # row 2 owns no pages: its writes must drop
    for i in range(b - 1):
        for blk in range(npg):
            for name, src in (("kp", "k"), ("vp", "v")):
                paged["blocks"][name][:, table[i, blk]] = \
                    dense["blocks"][src][:, i, blk * page:(blk + 1) * page]
    last_page = paged["blocks"]["kp"][:, -1].clone()
    pos = torch.full((b,), plen, dtype=torch.int32)
    nxt = torch.argmax(logits, -1)[:, None]
    for _ in range(3):
        ld, dense = M.decode_step(tp, CFG, dense, nxt, pos)
        lp, paged = M.decode_step(tp, CFG, paged, nxt, pos, page_table=table)
        np.testing.assert_allclose(lp[:2].numpy(), ld[:2].numpy(), atol=1e-5)
        nxt = torch.argmax(ld, -1)[:, None]
        pos = pos + 1
    assert torch.equal(paged["blocks"]["kp"][:, -1], last_page)


def test_blocked_attention_matches_jax_blocked_and_dense():
    """The long-prompt path, at a block size that leaves a ragged tail."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL

    rs = np.random.default_rng(5)
    q, k, v = (rs.standard_normal((2, 11, h, 8)).astype(np.float32)
               for h in (4, 2, 2))
    pos = np.arange(11)
    want = JL._gqa_blocked(*map(jnp.asarray, (q, k, v, pos)), None, block=4)
    got = TL._gqa_blocked(*map(torch.from_numpy, (q, k, v, pos)), None,
                          block=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    dense = TL._gqa_core(*map(torch.from_numpy, (q, k, v)),
                         TL.causal_mask(torch.arange(11), torch.arange(11)))
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=1e-5)


def test_put_rows_drops_masked_items_exactly():
    dst = torch.arange(12.0).reshape(6, 2)
    rows = torch.tensor([[-1.0, -1.0], [-2.0, -2.0], [-3.0, -3.0]])
    put_rows(dst, torch.tensor([4, 0, 5]), rows,
             torch.tensor([False, True, False]))
    want = torch.arange(12.0).reshape(6, 2)
    want[0] = -2.0
    assert torch.equal(dst, want)
    put_rows(dst, torch.tensor([1, 2]), rows[:2], torch.tensor([False, False]))
    assert torch.equal(dst, want)


@pytest.mark.parametrize("arch,names", [("pixtral-12b", "vlm family"),
                                        ("deepseek-v2-236b", "MLA")])
def test_unported_archs_raise_naming_their_family(arch, names):
    """Every arch of ``configs.ARCHS`` resolves through ``configs.get`` to
    the JAX package's config, full and smoke. Among them the two that
    raised until the port ran them: pixtral-12b (the vlm family) and
    deepseek-v2-236b (MLA)."""
    assert configs.ARCHS == jconfigs.ARCHS
    for name in configs.ARCHS:
        for smoke in (False, True):
            got = configs.get(name, smoke=smoke)
            want = (jconfigs.get_smoke if smoke else jconfigs.get)(name)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), name
    field, value = {"vlm family": ("family", "vlm"),
                    "MLA": ("attn_impl", "mla")}[names]
    assert getattr(configs.get(arch), field) == value


def test_unported_layer_options_raise():
    """The paged cache refuses an MLA config, as the JAX
    ``init_paged_cache`` does (a latent cache keeps the dense layout; int8
    K/V and sliding windows: ``tests/test_torch_decode.py``)."""
    cfg = dataclasses.replace(CFG, attn_impl="mla", kv_lora_rank=16,
                              v_head_dim=16, qk_rope_head_dim=8,
                              qk_nope_head_dim=16, q_lora_rank=32)
    jcfg = dataclasses.replace(JCFG, **{k: getattr(cfg, k) for k in (
        "attn_impl", "kv_lora_rank", "v_head_dim", "qk_rope_head_dim",
        "qk_nope_head_dim", "q_lora_rank")})
    with pytest.raises(NotImplementedError) as want:
        JM.init_paged_cache(jcfg, 8, 4)
    with pytest.raises(NotImplementedError) as got:
        M.init_paged_cache(cfg, 8, 4, "cpu")
    assert str(got.value) == str(want.value)
    M.init_cache(cfg, 1, 8, "cpu")  # the dense latent cache
    deepseek = configs.get_smoke("deepseek-v2-236b")
    with pytest.raises(NotImplementedError, match="family 'moe'"):
        M.init_paged_cache(deepseek, 8, 4, "cpu")
