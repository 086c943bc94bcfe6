"""The port's optimizers and schedules against the JAX package's.

Both optimizers take the same grads step for step (made with numpy, f32
and bf16 params); params, moments and updates agree to rtol 1e-6 (f32
arithmetic in the same order, up to XLA's fusion; params and moments
also to atol 1e-8 where a sum cancels). Schedules agree to rtol 1e-6 at
every step of their range.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as J
from repro_torch import optim as O
from repro_torch.models.params import from_jax, tree_leaves

torch.set_num_threads(1)

RTOL = 1e-6


def _tree(seed, dtype=np.float32, scale=1.0):
    rs = np.random.default_rng(seed)
    return {
        "embed": (rs.standard_normal((6, 4)) * scale).astype(dtype),
        "blocks": {"w": (rs.standard_normal((2, 4, 3)) * scale).astype(dtype),
                   "norm": (rs.standard_normal((2, 4)) * scale).astype(dtype)},
    }


def _close(t_tree, j_tree, rtol=RTOL, atol=0.0):
    for t, j in zip(tree_leaves(t_tree), jax.tree.leaves(j_tree)):
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j, np.float32),
                                   rtol=rtol, atol=atol)


@pytest.mark.parametrize("make", [
    lambda M: M.adamw(M.warmup_cosine(1e-2, 2, 8),
                      M.AdamWConfig(weight_decay=0.1)),
    lambda M: M.adamw(M.constant(3e-3), M.AdamWConfig(clip_norm=None)),
    lambda M: M.sgd_momentum(M.warmup_linear(0.1, 2, 8)),
    lambda M: M.sgd_momentum(M.constant(0.05), weight_decay=0.01,
                             clip_norm=0.5),
], ids=["adamw_wd_clip", "adamw_noclip", "sgd", "sgd_wd_clip"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_optimizer_matches_jax_step_for_step(make, dtype):
    jp = jax.tree.map(lambda x: jnp.asarray(x).astype(dtype), _tree(0))
    tp = from_jax(jax.tree.map(np.asarray, jp), "cpu")
    jopt, topt = make(J), make(O)
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(5):
        g = _tree(10 + step, scale=3.0 if step % 2 else 0.1)
        jg = jax.tree.map(lambda x: jnp.asarray(x).astype(dtype), g)
        tg = from_jax(jax.tree.map(np.asarray, jg), "cpu")
        ju, js = jopt.update(jg, js, jp)
        tu, ts = topt.update(tg, ts, tp)
        # atol: one f32 ulp of the O(0.1) operands, where a sum (p + u, or
        # momentum * m + g) cancels to near 0
        _close(tu, ju, atol=1e-9)
        _close(ts["m"], js["m"], atol=1e-8)
        jp, tp = J.apply_updates(jp, ju), O.apply_updates(tp, tu)
        # bf16 params: a one-ulp flip of the f32 update rounds apart
        _close(tp, jp, rtol=RTOL if dtype == "float32" else 2**-7,
               atol=1e-8)
        assert int(ts["step"]) == int(js["step"]) == step + 1
    np.testing.assert_allclose(O.global_norm(tp).numpy(),
                               np.asarray(J.global_norm(jp)),
                               rtol=RTOL if dtype == "float32" else 1e-2)


def test_moments_stay_f32_and_params_keep_their_dtype():
    tp = {"w": torch.zeros(3, dtype=torch.bfloat16)}
    opt = O.adamw(O.constant(1e-3))
    st = opt.init(tp)
    u, st = opt.update({"w": torch.ones(3, dtype=torch.bfloat16)}, st, tp)
    assert st["m"]["w"].dtype == st["v"]["w"].dtype == torch.float32
    assert u["w"].dtype == torch.float32
    assert O.apply_updates(tp, u)["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("make", [
    lambda M: M.constant(0.3),
    lambda M: M.warmup_linear(1.0, 5, 40, end=0.1),
    lambda M: M.warmup_cosine(1.0, 5, 40),
    lambda M: M.warmup_cosine(2e-3, 2000, 100_000, end=1e-5),
    lambda M: M.exponential_decay(0.5, 0.97, 2.4),
    lambda M: M.exponential_decay(0.5, 0.97, 2.4, staircase=False),
    lambda M: M.warmup_exponential(0.5, 4, 0.97, 2.4),
], ids=["constant", "warmup_linear", "warmup_cosine", "cosine_long",
        "exponential", "exponential_smooth", "warmup_exponential"])
def test_schedule_matches_jax(make):
    jsched, tsched = make(J), make(O)
    for step in list(range(0, 60)) + [1999, 2000, 2001, 50_000, 100_000]:
        want = np.asarray(jsched(jnp.asarray(step, jnp.int32)))
        got = tsched(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-12)
