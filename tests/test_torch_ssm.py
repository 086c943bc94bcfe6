"""The port's ssm and hybrid families against the JAX package's.

The SSD scan's plain versions (the chunked scan behind ``ops.ssd_scan`` on
the CPU, and the sequential oracle ``ref.ssd_ref``) against the Pallas
``ssd`` in interpret mode and the jnp oracle, at the shapes of
``test_ssd_kernel_matches_sequential_ref`` (atol 3e-4, rtol 1e-3); the
Mamba2 block, prefill and decode on mamba2-370m's smoke config in float32
(rtol 1e-5); whole-model prefill + decode on the mamba2 and zamba2 smoke
configs, weights carried by ``from_jax`` (logits within 1e-4, equal greedy
tokens); and the port's ``Engine`` against the JAX ``Engine`` on zamba2's
smoke config with exact-length prompts at temperature 0. Training the ssm
family is tested in ``test_torch_ssm_train.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _ledger_parity import DERIVED_RTOL, assert_ledger_states_close
from _torch_cases import ssd_case
from repro import configs as jconfigs
from repro.core.history import HistoryConfig as JHistoryConfig
from repro.kernels import ref as jref
from repro.kernels import ssd as SSD_mod
from repro.models import model as JM
from repro.models import ssm as JS
from repro.models.params import materialize as jmaterialize
from repro.serving import Engine as JEngine
from repro.serving import OutcomeRecorder as JRecorder
from repro_torch import configs
from repro_torch.core.history import HistoryConfig
from repro_torch.kernels import ops, ref
from repro_torch.models import model as M
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import from_jax, materialize, tree_leaves
from repro_torch.serving import Engine, OutcomeRecorder

torch.set_num_threads(1)

SCAN_TOL = dict(atol=3e-4, rtol=1e-3)  # test_ssd_kernel_matches_sequential_ref
BLOCK_RTOL = 1e-5
LOGIT_ATOL = 1e-4
ARCHS = ("mamba2-370m", "zamba2-2.7b")


def _f32(arch):
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch),
                               param_dtype="float32", compute_dtype="float32")
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def weights():
    out = {}
    for arch in ARCHS:
        jcfg, cfg = _f32(arch)
        specs = JM.param_specs(jcfg)
        jp = jax.jit(lambda k, specs=specs: jmaterialize(
            specs, k, jnp.float32))(jax.random.key(1))
        out[arch] = (jcfg, cfg, jp, from_jax(jax.tree.map(np.asarray, jp),
                                             "cpu"))
    return out


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "bsz,s,h,p,g,n,chunk",
    [(2, 64, 4, 16, 1, 32, 16), (1, 96, 2, 32, 2, 16, 32),
     (2, 50, 4, 16, 1, 16, 16)],
)
def test_ssd_plain_versions_match_jax_interpret_kernel(bsz, s, h, p, g, n,
                                                       chunk):
    case = ssd_case(bsz, s, h, p, g, n)
    jy, jst = SSD_mod.ssd(*map(jnp.asarray, case), chunk=chunk,
                          interpret=True)
    jry, jrst = jref.ssd_ref(*map(jnp.asarray, case))
    t = list(map(torch.from_numpy, case))
    for y, st in (ops.ssd_scan(*t, chunk=chunk), ref.ssd_ref(*t)):
        for want_y, want_st in ((jy, jst), (jry, jrst)):
            np.testing.assert_allclose(y.numpy(), np.asarray(want_y),
                                       **SCAN_TOL)
            np.testing.assert_allclose(st.numpy(), np.asarray(want_st),
                                       **SCAN_TOL)


def test_ssd_chunked_with_initial_state_matches_jax():
    x, dt, a, b, c = ssd_case(2, 40, 4, 8, 2, 8, seed=3)
    h0 = np.random.default_rng(4).standard_normal((2, 4, 8, 8)).astype(
        np.float32)
    jy, jst = jax.jit(JS.ssd_chunked, static_argnames="chunk")(
        *map(jnp.asarray, (x, dt, a, b, c)), chunk=16, h0=jnp.asarray(h0))
    ty, tst = S.ssd_chunked(*map(torch.from_numpy, (x, dt, a, b, c)),
                            chunk=16, h0=torch.from_numpy(h0))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), rtol=1e-5,
                               atol=1e-6)


def test_ssd_scan_dispatch_follows_the_tensor_device():
    case = list(map(torch.from_numpy, ssd_case(1, 8, 2, 4, 1, 4)))
    before = dict(ops.LAUNCHES)
    ops.ssd_scan(*case, chunk=4)
    assert ops.LAUNCHES == before
    with pytest.raises(ValueError):
        ops.ssd_scan(*case, chunk=4, impl="cuda")


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------


def test_ssm_block_fill_and_decode_match_jax(weights):
    jcfg, cfg, jp, tp = weights["mamba2-370m"]
    jl = jax.tree.map(lambda x: x[0], jp["blocks"]["ssm"])
    tl = {k: v[0] for k, v in tp["blocks"]["ssm"].items()}
    rs = np.random.default_rng(6)
    x = rs.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    close = dict(rtol=BLOCK_RTOL, atol=1e-6)
    block = jax.jit(JS.ssm_block, static_argnums=2)
    fill = jax.jit(JS.ssm_fill_cache, static_argnums=2)
    decode = jax.jit(JS.ssm_decode, static_argnums=2)
    np.testing.assert_allclose(
        S.ssm_block(torch.from_numpy(x), tl, cfg).numpy(),
        np.asarray(block(jnp.asarray(x), jl, jcfg)), **close)
    jo, jc = fill(jnp.asarray(x), jl, jcfg)
    to, tc = S.ssm_fill_cache(torch.from_numpy(x), tl, cfg)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **close)
    for k in ("state", "conv"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **close)
    for step in range(3):
        xt = rs.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jo, jc = decode(jnp.asarray(xt), jl, jcfg, jc)
        to, tc = S.ssm_decode(torch.from_numpy(xt), tl, cfg, tc)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **close,
                                   err_msg=f"step {step}")
        for k in ("state", "conv"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       **close)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_and_init_match_jax(arch):
    jcfg, cfg = _f32(arch)
    jshapes = sorted(x.shape for x in jax.tree.leaves(
        JM.param_specs(jcfg), is_leaf=lambda x: hasattr(x, "axes")))
    tshapes = sorted(s.shape for s in tree_leaves(M.param_specs(cfg)))
    assert jshapes == tshapes
    p = materialize(M.param_specs(cfg), 0, torch.float32, "cpu")
    blocks = p["blocks"]["ssm"]
    a = -torch.exp(blocks["a_log"])
    dt = torch.nn.functional.softplus(blocks["dt_bias"])
    assert a.min() >= -16 - 1e-4 and a.max() <= -1 + 1e-6
    assert dt.min() >= 1e-3 * (1 - 1e-4) and dt.max() <= 0.1 * (1 + 1e-4)
    bound = blocks["conv_w"].shape[-1] ** -0.5
    assert blocks["conv_w"].abs().max() <= bound and blocks["conv_w"].std() > 0
    assert torch.equal(blocks["conv_b"], torch.zeros_like(blocks["conv_b"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(weights, arch):
    jcfg, cfg, jp, tp = weights[arch]
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 20),
                                             dtype=np.int32)
    jl, jc = jax.jit(JM.prefill, static_argnums=(1, 3))(
        jp, jcfg, jnp.asarray(toks), 28)
    tl, tc = M.prefill(tp, cfg, torch.from_numpy(toks), 28)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    empty, jempty = M.init_cache(cfg, 2, 28, "cpu"), JM.init_cache(jcfg, 2, 28)
    assert {k: {n: x.shape for n, x in sub.items()}
            for k, sub in empty.items()} == \
        {k: {n: x.shape for n, x in sub.items()} for k, sub in jempty.items()}
    decode = jax.jit(JM.decode_step, static_argnums=1)
    pos = np.array([20, 20], np.int32)
    for step in range(6):
        nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
        np.testing.assert_array_equal(
            M.greedy_token(cfg, tl).numpy()[:, None], nxt)
        jl, jc = decode(jp, jcfg, jc, jnp.asarray(nxt), jnp.asarray(pos))
        tl, tc = M.decode_step(tp, cfg, tc, torch.from_numpy(nxt),
                               torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL, err_msg=f"step {step}")
        pos = pos + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_training_and_paging_still_refuse_the_family(arch):
    """Their caches are not paged, as in the JAX package: the model and the
    serve CLI's ``--page-size`` refuse both families. Both train (the
    scan's gradient is ``ops.ssd_bwd``; tests/test_torch_ssm_train.py and
    tests/test_torch_hybrid_train.py): ``loss_fn`` builds and the train
    CLI takes a step on the smoke config."""
    from repro_torch.launch import serve, train

    cfg = configs.get_smoke(arch)
    assert callable(M.loss_fn(cfg))
    assert train.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--steps", "1", "--global-batch", "4", "--seq-len",
                       "8"]) == 0
    with pytest.raises(NotImplementedError, match="family"):
        M.init_paged_cache(cfg, 4, 4, "cpu")
    with pytest.raises(NotImplementedError, match="family"):
        serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                    "--page-size", "4", "--batch", "2", "--prompt-len", "8",
                    "--gen", "2"])


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

LEDGER = dict(capacity=1 << 12, decay=0.8)
SLOTS, MAX_PROMPT, MAX_GEN, TOPK = 3, 10, 5, 16


def _requests():
    rs = np.random.default_rng(8)
    lens = (10, 7, 10, 7, 10, 7)  # exact-length prefill at two lengths
    return [(rs.integers(0, 256, n).astype(np.int32),
             rs.integers(0, 256, MAX_GEN).astype(np.int32), 100 + i)
            for i, n in enumerate(lens)]


def test_hybrid_engine_matches_jax_engine(weights):
    jcfg, cfg, jp, tp = weights["zamba2-2.7b"]
    reqs = _requests()
    jrec = JRecorder(SLOTS, MAX_GEN, jcfg.vocab_size,
                     JHistoryConfig(**LEDGER), ledger="device",
                     retention="topk", topk=TOPK)
    je = JEngine(jcfg, jp, jrec, slots=SLOTS, max_prompt=MAX_PROMPT,
                 max_gen=MAX_GEN)
    trec = OutcomeRecorder(SLOTS, MAX_GEN, cfg.vocab_size,
                           HistoryConfig(**LEDGER), ledger="device",
                           retention="topk", topk=TOPK, device="cpu")
    te = Engine(cfg, tp, trec, slots=SLOTS, max_prompt=MAX_PROMPT,
                max_gen=MAX_GEN)
    assert je.prompt_buckets is None and te.prompt_buckets is None
    for eng in (je, te):
        for prompt, labels, iid in reqs:
            eng.submit(prompt, max_new=MAX_GEN, labels=labels,
                       instance_id=iid)
        eng.run(max_steps=200)
    assert set(je.finished) == set(te.finished) == {r[2] for r in reqs}
    for i in je.finished:
        np.testing.assert_array_equal(te.finished[i], je.finished[i],
                                      err_msg=f"instance {i}")
    assert_ledger_states_close(te.ledger_state_dict(), je.ledger_state_dict(),
                               rtol=DERIVED_RTOL)
    js, ts = je.stats(), te.stats()
    for key in ts:
        assert ts[key] == js[key], key


def test_exact_length_families_reject_padding():
    """The twin of the JAX test of that name: recurrent families refuse
    prompt buckets and serve through exact-length prefill."""
    cfg = configs.get_smoke("mamba2-370m")
    p = materialize(M.param_specs(cfg), 1, torch.bfloat16, "cpu")

    def rec():
        return OutcomeRecorder(2, 4, cfg.vocab_size, HistoryConfig(**LEDGER),
                               ledger="device", device="cpu")

    with pytest.raises(ValueError, match="right-pad"):
        Engine(cfg, p, rec(), slots=2, max_prompt=8, max_gen=4,
               prompt_buckets=(8,))
    eng = Engine(cfg, p, rec(), slots=2, max_prompt=8, max_gen=4)
    assert eng.prompt_buckets is None
    rs = np.random.default_rng(29)
    for plen in (5, 7):
        eng.submit(rs.integers(0, cfg.vocab_size, plen), max_new=3,
                   labels=rs.integers(0, cfg.vocab_size, 3))
    eng.run(max_steps=100)
    assert eng.stats()["evicted"] == 2
    assert eng.stats()["recorded"] == 6
