"""The port's placement tables against the JAX package's.

Every arch's ``param_specs`` carries the JAX logical axes; the partition
specs of the params and of the ZeRO-1 moments equal JAX's under both rule
tables and two data axes (JAX's ``spec_for`` reads only ``mesh.shape``, so
a stub with a ``shape`` dict stands in for a mesh on either side); mixtral's
``shard_overrides`` reach the table; and the ZeRO-1 slice layout covers
every moment leaf exactly once across the ranks. CPU only, in-process.
"""

import types

import jax
import pytest
import torch

from repro import configs as jconfigs
from repro.distributed import sharding as JS
from repro.distributed import zero as JZ
from repro.models import model as JM
from repro.models.params import is_spec
from repro_torch import configs
from repro_torch.distributed import sharding as S
from repro_torch.distributed import zero as Z
from repro_torch.models import model as M
from repro_torch.models.params import materialize, tree_leaves, tree_map

ARCHS = [a.replace("_", "-") for a in configs.ARCHS]
MESHES = {"data4": {"data": 4, "model": 1}, "data2": {"data": 2, "model": 1}}
RULES = {"default": (JS.DEFAULT_RULES, S.DEFAULT_RULES),
         "fsdp": (JS.FSDP_RULES, S.FSDP_RULES)}


def _mesh(name):
    return types.SimpleNamespace(shape=dict(MESHES[name]))


def _jax_leaves(tree, fn=lambda x: x):
    """{path: fn(leaf)} of a JAX tree of specs or partition specs."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: is_spec(x) or isinstance(
            x, jax.sharding.PartitionSpec))[0]
    return {tuple(k.key for k in p): fn(x) for p, x in flat}


def _port_leaves(tree, fn=lambda x: x):
    out = {}
    tree_map(lambda p, x: out.__setitem__(p, fn(x)), tree)
    return out


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_carry_the_jax_logical_axes(arch, smoke):
    jcfg = jconfigs.get_smoke(arch) if smoke else jconfigs.get(arch)
    want = _jax_leaves(JM.param_specs(jcfg),
                       lambda s: (s.shape, s.axes, s.init, s.scale))
    got = _port_leaves(M.param_specs(configs.get(arch, smoke)),
                       lambda s: (s.shape, s.axes, s.init, s.scale))
    assert got == want


def test_a_spec_needs_one_axis_a_dim():
    with pytest.raises(AssertionError):
        M.ParamSpec((4, 8), ("embed",))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("rules", list(RULES))
@pytest.mark.parametrize("arch", ARCHS)
def test_partition_specs_equal_jax(arch, rules, mesh):
    """The params' and the ZeRO-1 moments' specs, each arch's overrides
    applied (``rules_for``), as tuples."""
    jrules, trules = RULES[rules]
    jcfg, cfg = jconfigs.get(arch), configs.get(arch)
    jrules, trules = JS.rules_for(jcfg, jrules), S.rules_for(cfg, trules)
    jspecs, tspecs = JM.param_specs(jcfg), M.param_specs(cfg)
    m = _mesh(mesh)
    assert (_port_leaves(S.param_partition_specs(tspecs, trules, m))
            == _jax_leaves(JS.param_partition_specs(jspecs, jrules, m),
                           tuple))
    assert (_port_leaves(Z.zero1_partition_specs(tspecs, trules, m))
            == _jax_leaves(JZ.zero1_partition_specs(jspecs, jrules, m),
                           tuple))
    # no mesh: no divisibility filter
    assert (_port_leaves(S.param_partition_specs(tspecs, trules))
            == _jax_leaves(JS.param_partition_specs(jspecs, jrules), tuple))
    assert S.batch_spec(trules) == tuple(JS.batch_spec(jrules))
    assert S.batch_spec(trules, "pod") == tuple(JS.batch_spec(jrules, "pod"))


def test_mixtral_overrides_reach_the_table():
    cfg = configs.get("mixtral-8x22b")
    rules = S.rules_for(cfg, S.DEFAULT_RULES)
    assert rules.lookup("experts") is None
    assert rules.lookup("expert_mlp") == "model"
    assert S.rules_for(configs.get("llama3-8b"), S.DEFAULT_RULES) \
        is S.DEFAULT_RULES
    m = _mesh("data4")
    w1 = M.param_specs(cfg)["blocks"]["moe"]["w1"]  # layers, e, d, f
    assert S.spec_for(w1, S.DEFAULT_RULES, m) == (None, "model", "data",
                                                  None)
    assert S.spec_for(w1, rules, m) == (None, None, "data", "model")


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_zero1_slices_cover_every_leaf_once(arch, shards):
    """Across the ranks' layouts each moment leaf is held exactly once
    where its JAX moment spec names the data axis, and whole on every rank
    where it does not; the slices are views that tile the leaf in rank
    order."""
    cfg = configs.get(arch, smoke=True)
    specs = M.param_specs(cfg)
    mesh = types.SimpleNamespace(shape={"data": shards, "model": 1})
    lays = [Z.zero1_layout(specs, mesh, r) for r in range(shards)]
    parts = _port_leaves(Z.zero1_partition_specs(specs, S.DEFAULT_RULES,
                                                 mesh))
    dims = _port_leaves(lays[0].dims)
    for path, spec in parts.items():
        want = [i for i, a in enumerate(spec) if "data" in S.axis_names(a)]
        assert dims[path] == (want[0] if want else None), path
    params = materialize(specs, 0, torch.float32, "cpu")
    counts = tree_map(lambda _, p: torch.zeros(p.shape, dtype=torch.int32),
                      params)
    for lay in lays:
        for c in tree_leaves(lay.slice(counts)):
            c.add_(1)  # views: the count lands in the full leaf
    for (path, d), c, p in zip(dims.items(), tree_leaves(counts),
                               tree_leaves(params)):
        if d is None:
            assert bool((c == shards).all()), path
            continue
        assert bool((c == 1).all()), path
        pieces = [lay.piece(p, d) for lay in lays]
        assert torch.equal(torch.cat(pieces, d), p), path
    cut = sum(d is not None for d in dims.values())
    assert cut > len(dims) // 2, (cut, len(dims))  # most leaves are cut
