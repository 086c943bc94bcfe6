"""The port's selectors and policies against the JAX package's.

Torch cannot reproduce JAX's threefry draws, so each parity test hands the
port the JAX selector's own draws (``JaxDraws``: the permutation, Gumbel
noise or normal that ``repro.core.selection`` takes from the key) and then
requires the same indices exactly. The invariants of
``tests/test_selection_policies.py`` (exactly b unique in-range indices on
degenerate batches) are checked on the port's own noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import JaxDraws
from repro.core import selection as J
from repro_torch.core import selection as S

torch.set_num_threads(1)

KEY = jax.random.key(11)


def _losses(kind, n, seed=0):
    rs = np.random.default_rng(seed)
    if kind == "normal":
        return (rs.standard_normal(n) * 3 + 5).astype(np.float32)
    if kind == "ties":  # few distinct values: stable sorts and first argmin
        return rs.integers(0, 4, n).astype(np.float32)
    if kind == "zeros":
        return np.zeros(n, np.float32)
    if kind == "constant":
        return np.full(n, 2.5, np.float32)
    if kind == "inf":
        x = (rs.standard_normal(n) * 3 + 5).astype(np.float32)
        x[::max(n // 3, 1)] = np.inf
        return x
    raise KeyError(kind)


def _cfgs(method, b):
    return (J.SelectionConfig(method=method, mink_pool=max(b // 2, 1)
                              if method == "mink" else None),
            S.SelectionConfig(method=method, mink_pool=max(b // 2, 1)
                              if method == "mink" else None))


@pytest.mark.parametrize("method", S.METHODS)
@pytest.mark.parametrize("n,b,kind", [(33, 8, "normal"), (20, 7, "ties"),
                                      (9, 3, "zeros")])
def test_select_matches_jax_given_its_draws(method, n, b, kind):
    x = _losses(kind, n, seed=n)
    jcfg, tcfg = _cfgs(method, b)
    want = np.asarray(J.select(jcfg, KEY, jnp.asarray(x), b))
    got = S.select(tcfg, JaxDraws(KEY), torch.from_numpy(x), b)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("noisy", [False, True])
@pytest.mark.parametrize("swaps", [0, 1, 3])
def test_obftf_matches_jax_with_and_without_the_noisy_target(noisy, swaps):
    x = _losses("normal", 48, seed=5)
    want = J.select_obftf(KEY, jnp.asarray(x), 12, swaps=swaps,
                          noisy_target=noisy)
    got = S.select_obftf(JaxDraws(KEY), torch.from_numpy(x), 12, swaps=swaps,
                         noisy_target=noisy)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_obftf_target_std_has_no_bessel_correction():
    """jnp.std has ddof 0; torch.std's default would be ddof 1."""
    x = _losses("normal", 10, seed=2)
    want = J._obftf_target(KEY, jnp.asarray(x), 3, True)
    got = S._obftf_target(JaxDraws(KEY), torch.from_numpy(x), 3, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_prox_and_mink_are_stable_on_ties():
    x = np.asarray([1, 3, 3, 0, 3, 1, 0, 3], np.float32)
    for name in ("select_obftf_prox", "select_maxk"):
        want = getattr(J, name)(KEY, jnp.asarray(x), 5)
        got = getattr(S, name)(JaxDraws(KEY), torch.from_numpy(x), 5)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = J.select_mink(KEY, jnp.asarray(x), 5)
    got = S.select_mink(JaxDraws(KEY), torch.from_numpy(x), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("ratio", [0.25, 0.1, 0.5, 0.3, 1.0])
def test_budget_rounds_as_python_round(ratio):
    for n in (1, 2, 3, 5, 10, 30, 32, 33):
        assert (S.SelectionConfig(ratio=ratio).budget(n)
                == J.SelectionConfig(ratio=ratio).budget(n))


@pytest.mark.parametrize("method", S.METHODS)
@pytest.mark.parametrize("kind", ["zeros", "constant", "inf", "normal"])
def test_selectors_exact_b_unique_in_range(method, kind):
    g = torch.Generator().manual_seed(0)
    for n, b in [(1, 1), (2, 1), (7, 3), (8, 8), (9, 1), (33, 32)]:
        _, cfg = _cfgs(method, b)
        idx = S.select(cfg, S.GeneratorNoise(g),
                       torch.from_numpy(_losses(kind, n)), b)
        assert idx.shape == (b,) and idx.dtype == torch.int64
        assert len(set(idx.tolist())) == b
        assert 0 <= idx.min() and idx.max() < n


def test_prob_degenerate_batch_is_a_gumbel_draw_not_a_prefix():
    x = torch.zeros(64)
    idx = S.select_prob(S.GeneratorNoise(torch.Generator().manual_seed(1)),
                        x, 8)
    assert sorted(idx.tolist()) != list(range(8))
    want = J.select_prob(KEY, jnp.zeros(64), 8)
    np.testing.assert_array_equal(
        S.select_prob(JaxDraws(KEY), x, 8).numpy(), np.asarray(want))


def _signals(n, seed=3):
    rs = np.random.default_rng(seed)
    ema = (rs.standard_normal(n) * 2 + 1).astype(np.float32)
    sig = (rs.standard_normal((n, 2)) * 3).astype(np.float32)
    seen = rs.random(n) < 0.7
    return ema, sig, seen


@pytest.mark.parametrize("name", sorted(S.POLICIES))
def test_policy_score_matches_jax(name):
    ema, sig, seen = _signals(40)
    want = J.policy_score(J.get_policy(name), jnp.asarray(ema),
                          jnp.asarray(sig), jnp.asarray(seen), 1e3)
    got = S.policy_score(S.get_policy(name), torch.from_numpy(ema),
                         torch.from_numpy(sig), torch.from_numpy(seen), 1e3)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert isinstance(S.get_policy(name), S.SelectionPolicy)


def test_margin_policy_softplus_has_no_threshold():
    """torch's softplus turns linear past 20; jax.nn.softplus does not."""
    m = np.asarray([-30.0, -21.0, 0.0, 25.0], np.float32)
    want = J.get_policy("margin").score({"margin": jnp.asarray(m)})
    got = S.get_policy("margin").score({"margin": torch.from_numpy(m)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7)


def test_select_by_score_and_residual_match_jax():
    ema, _, _ = _signals(50)
    want = J.select_by_score(KEY, jnp.asarray(ema), 10)
    got = S.select_by_score(JaxDraws(KEY), torch.from_numpy(ema), 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(
        S.subset_mean_residual(torch.from_numpy(ema), got).numpy(),
        np.asarray(J.subset_mean_residual(jnp.asarray(ema), want)),
        rtol=1e-6)
    with pytest.raises(KeyError):
        S.get_policy("nope")
