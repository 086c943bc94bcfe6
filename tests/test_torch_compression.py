"""The port's int8 compression (``repro_torch.distributed.compression``)
against the JAX package's, and the parameter gather's no-op cases.

The twins of ``tests/test_distributed.py``'s int8 tests, on the same numpy
inputs through both packages (JAX's functions under ``jit``, as the
package runs them: XLA turns the scale's ``/ 127.0`` into a product with
the reciprocal, which the port follows): the quantizer's round-trip bound, its
per-chunk property bound (hypothesis), exact halves rounded to even as
``jnp.round`` rounds them, and a group of one, where the ring returns its
input unquantized. The quantized payloads and scales equal JAX's bit for
bit. Then ``param_gather_constraint`` returns its input with no rules, or
over a data axis of one, as ``tests/test_perf_features.py`` pins for JAX;
the int8 gather follows JAX's gate (``gather_params`` and ``int8_gather``)
and quantizes every leaf of a layer as JAX's ``param_gather_constraint``
does, bit for bit, on one rank; and a checkpointed layer's recompute sees
the forward's rules from another thread. Single-process; the four-rank checks are in
``tests/test_torch_dp_train.py``.
"""

import dataclasses
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch
from _hypothesis_compat import given, settings, st

from repro.distributed import compression as JC
from repro.distributed import sharding as JS
from repro.models import model as JM
from repro_torch import configs
from repro_torch.distributed import compression as C
from repro_torch.distributed import sharding as S
from repro_torch.distributed.zero import data_layout
from repro_torch.launch.mesh import make_elastic_mesh
from repro_torch.models import model as M
from repro_torch.models.params import materialize


_jquantize = jax.jit(JC.quantize_int8, static_argnums=1)
_jdequantize = jax.jit(JC.dequantize_int8, static_argnums=(2, 3))


def _both(x: np.ndarray, chunk: int):
    """(port q, s, dequantized), (JAX q, s, dequantized) as numpy."""
    q, s = C.quantize_int8(torch.from_numpy(x), chunk)
    y = C.dequantize_int8(q, s, x.shape, chunk)
    jq, js = _jquantize(jnp.asarray(x), chunk)
    jy = _jdequantize(jq, js, x.shape, chunk)
    return ((q.numpy(), s.numpy(), y.numpy()),
            (np.asarray(jq), np.asarray(js), np.asarray(jy)))


def _equal(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_quantize_roundtrip_error_bound_and_jax_bits():
    x = (np.random.default_rng(0).standard_normal(1000) * 10).astype(
        np.float32)
    got, want = _both(x, 128)
    _equal(got, want)
    # max error a chunk <= scale/2 = max|x|/254
    bound = float(np.abs(x).max()) / 254 + 1e-6
    assert float(np.abs(got[2] - x).max()) <= bound * 1.01


@settings(max_examples=30, deadline=None)
@given(
    n=st.integers(1, 600),
    scale=st.floats(1e-3, 1e3),
    seed=st.integers(0, 10_000),
)
def test_property_quantize_bound(n, scale, seed):
    x = (np.random.default_rng(seed).standard_normal(n) * scale).astype(
        np.float32)
    got, want = _both(x, 64)
    _equal(got, want)
    chunks = -(-n // 64)
    pad = lambda a: np.pad(a, (0, chunks * 64 - n)).reshape(chunks, 64)
    per_chunk = np.abs(pad(x)).max(axis=1) / 127.0 * 0.5 + 1e-9
    assert (pad(np.abs(got[2] - x)).max(axis=1) <= per_chunk * 1.01).all()


def test_exact_halves_round_to_even_as_jnp_round():
    """A chunk whose max is 127 has scale 1, so x / scale lands exactly on
    the halves: half to even (0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -2.5 -> -2),
    not half away from zero; an all-zero chunk takes the safe divisor."""
    halves = [0.5, 1.5, 2.5, 3.5, -0.5, -1.5, -2.5, 126.5, 127.0, -127.0]
    x = np.zeros(32, np.float32)
    x[:len(halves)] = halves
    got, want = _both(x, 16)
    _equal(got, want)
    np.testing.assert_array_equal(
        got[0][:len(halves)], [0, 2, 2, 4, 0, -2, -2, 126, 127, -127])
    np.testing.assert_array_equal(got[1], [1.0, 0.0])  # the zero chunk
    np.testing.assert_array_equal(got[0][16:], 0)


def test_dequantized_sum_equals_jax_and_bounds_the_ring():
    """The ring's result is the dequantized terms' sum (the four-rank run
    equals JAX's ring rank by rank); here the sum of four quantized terms,
    both packages, within the sum of the terms' max|x| / 254."""
    xs = [np.random.RandomState(i).randn(256).astype(np.float32)
          for i in range(4)]
    deq = []
    for x in xs:
        got, want = _both(x, 64)
        _equal(got, want)
        deq.append(got[2])
    bound = sum(np.abs(x).max() for x in xs) / 254 * 1.01 + 1e-6
    assert np.abs(np.sum(deq, 0) - np.sum(xs, 0)).max() <= bound


def test_a_group_of_one_returns_the_input_unquantized():
    mesh = make_elastic_mesh(device="cpu")
    try:
        x = torch.randn(64)
        assert C.int8_ring_all_reduce(x) is x
        tree = {"a": {"w": torch.randn(3, 5)}, "b": torch.randn(7)}
        out = C.compressed_psum_tree(tree)
        assert out["a"]["w"] is tree["a"]["w"] and out["b"] is tree["b"]
    finally:
        mesh.close()


def _layout(shards: int):
    specs = M.param_specs(configs.get("llama3-8b", smoke=True))
    mesh = types.SimpleNamespace(shape={"data": shards, "model": 1})
    return mesh, data_layout(specs, mesh, 0), specs


def test_param_gather_returns_its_input_without_rules_or_on_one_rank():
    """No rules: the tree itself, as JAX's ``param_gather_constraint``; a
    data axis of one: the same, with no collective (no group is set up
    here, so one would raise)."""
    S.set_rules(None, None)
    tree = {"w": torch.ones(4, 4)}
    assert S.param_gather_constraint(tree)["w"] is tree["w"]
    assert S.param_gather_constraint(tree) is tree
    mesh, layout, specs = _layout(1)
    params = materialize(specs, 0, torch.float32, "cpu")
    assert layout.hold(params) is params
    p = M.layer(params["blocks"], 0)
    with S.use_rules(mesh, S.DEFAULT_RULES, layout):
        assert S.param_gather_constraint(p, ("blocks",)) is p
        assert S.gather_whole(params["embed"], ("embed",)) \
            is params["embed"]
    assert S._current() == (None, None, None)


def test_int8_follows_jax_gate_and_quantizes_every_leaf_of_a_layer():
    """JAX quantizes a layer's weights only where the rules set both
    ``gather_params`` and ``int8_gather``, and then every leaf of the
    layer's tree, the ones its layout holds whole (mamba2's ``conv_w``,
    ``a_log``, ...) too. On one rank (no collective; no group is set up
    here) the port's values equal JAX's ``param_gather_constraint`` under
    the same rules on a one-device mesh, bit for bit."""
    cfg = dataclasses.replace(configs.get("mamba2-370m", smoke=True),
                              param_dtype="float32")
    specs = M.param_specs(cfg)
    mesh = types.SimpleNamespace(shape={"data": 1, "model": 1})
    int8 = dataclasses.replace(S.FSDP_RULES, int8_gather=True)
    layout = data_layout(specs, mesh, 0, int8)
    p = M.layer(materialize(specs, 0, torch.float32, "cpu")["blocks"], 1)
    alone = dataclasses.replace(S.DEFAULT_RULES, int8_gather=True)
    with S.use_rules(mesh, alone, layout):
        assert S.param_gather_constraint(p, ("blocks",)) is p
    with S.use_rules(mesh, int8, layout):
        got = S.param_gather_constraint(p, ("blocks",))
    jmesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                              ("data", "model"))
    jp = jax.tree.map(lambda x: jnp.asarray(x.numpy()), p)
    with JS.use_rules(jmesh, dataclasses.replace(JS.FSDP_RULES,
                                                 int8_gather=True)):
        want = jax.jit(JM.param_gather)(jp)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert {"conv_w", "a_log", "in_proj"} <= {k[-1].key for k, _ in flat}
    for path, w in flat:
        x, g = p, got
        for k in path:
            x, g = x[k.key], g[k.key]
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=str(path))
        if path[-1].key in ("conv_w", "in_proj"):  # held whole; sliced
            assert not torch.equal(g, x), path  # quantized


def test_a_recompute_sees_the_forwards_rules_on_another_thread():
    """``recompute_context`` captures the rules where the forward runs and
    puts them back around the recompute, which autograd runs on its
    device thread for CUDA tensors, where the thread-local context is
    unset."""
    mesh, layout, _ = _layout(4)
    rules = S.DEFAULT_RULES
    with S.use_rules(mesh, rules, layout):
        _, recompute = S.recompute_context()
    seen = {}

    def other():
        seen["before"] = S._current()
        with recompute:
            seen["inside"] = S._current()
        seen["after"] = S._current()

    t = threading.Thread(target=other)
    t.start()
    t.join()
    assert seen["before"] == (None, None, None) == seen["after"]
    assert seen["inside"] == (mesh, rules, layout)
