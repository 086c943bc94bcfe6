"""Paper Table 3 proxy: large-scale classification -> LM next-token task.

    PYTHONPATH=src python -m repro_torch.benchmarks.table3_lm_proxy [--fast] \
        [--device cpu] [--arch llama3-8b --layers 2]

The twin of ``benchmarks/table3_lm_proxy.py``: the paper's Table 3
structure (methods x sampling rates) on the synthetic LM stream with the
full OBFTF train step (``core.obftf.make_train_step``, the launcher's),
by default on llama3-8b's smoke config as in the JAX bench; ``--arch``
(with ``--layers`` to cut depth) runs the same grid at a published width.
Metric = held-out eval loss after a fixed number of steps (lower is
better). The policy arms run the recycle loop against the device ledger
at matched compute: ``lookup_signals`` -> ``policy_score`` ->
``select_by_score`` -> forward + backward of ``per_example_signals`` on
the picked rows -> ``device_ledger.record`` of their loss and signals.
Per-token CE goes through the cross-entropy kernels on the card.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch.benchmarks import parser
from repro_torch.core import device_ledger as dledger
from repro_torch.core.history import HistoryConfig
from repro_torch.core.obftf import (
    OBFTFConfig,
    loss_and_grads,
    make_eval_step,
    make_train_step,
)
from repro_torch.core.selection import (
    POLICIES,
    GeneratorNoise,
    SelectionConfig,
    get_policy,
    policy_score,
    select_by_score,
)
from repro_torch.data import DataConfig, SyntheticLMStream
from repro_torch.models import model as Mdl
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import materialize
from repro_torch.optim import Optimizer, adamw, apply_updates, warmup_cosine

METHODS = ("uniform", "maxk", "obftf")
RATIOS = (0.1, 0.25, 0.45)
POLICY_RATIOS = (0.25,)
EVAL_STEPS = range(10_000, 10_004)  # held out: disjoint from training


def _setup(cfg, steps, seed, device):
    cfg = cfg or configs.get_smoke("llama3_8b")
    opt = adamw(warmup_cosine(3e-3, max(1, steps // 10), steps))
    params = materialize(Mdl.param_specs(cfg), seed,
                         Mdl.dtype_of(cfg.param_dtype), device)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    return cfg, opt, state


def _to(raw, keys, device, dtype=None):
    return {k: torch.from_numpy(np.asarray(raw[k], dtype)).to(device)
            for k in keys}


def _eval(cfg, params, stream, device) -> float:
    eval_fn = make_eval_step(Mdl.loss_fn(cfg))
    evals = [eval_fn(params, _to(stream.batch(t), ("tokens", "labels"),
                                 device))
             for t in EVAL_STEPS]
    return float(torch.cat(evals).to(torch.float32).mean())


def train_lm(
    method: str,
    ratio: float,
    *,
    steps: int = 150,
    batch: int = 32,
    seq: int = 64,
    seed: int = 0,
    cfg: Optional[ModelConfig] = None,
    device: str = "cuda",
) -> float:
    """Held-out eval loss after ``steps`` OBFTF steps (``method`` "full":
    the backward on every row)."""
    cfg, opt, state = _setup(cfg, steps, seed, device)
    mode = "full" if method == "full" else "obftf"
    step_fn = make_train_step(
        Mdl.loss_fn(cfg), opt,
        OBFTFConfig(selection=SelectionConfig(method=method, ratio=ratio),
                    mode=mode),
    )
    stream = SyntheticLMStream(DataConfig(batch, seq, cfg.vocab_size,
                                          seed=seed))
    noise = GeneratorNoise(torch.Generator(device).manual_seed(seed))
    for t in range(steps):
        bt = _to(stream.batch(t), ("tokens", "labels"), device)
        state, _ = step_fn(state, bt, noise)
    return _eval(cfg, state["params"], stream, device)


def policy_pick(pol, noise, lstate, ids, b: int, cold: float = 1e3):
    """In-batch positions [b] a policy picks by its score of the ledger."""
    ema, sig, seen = dledger.lookup_signals(lstate, ids)
    return select_by_score(noise, policy_score(pol, ema, sig, seen, cold), b)


def policy_step(cfg: ModelConfig, opt: Optimizer, lcfg: HistoryConfig,
                state: dict, lstate, bt: dict, sel: torch.Tensor):
    """One forward + backward of ``per_example_signals`` on the picked rows
    ``sel``, an optimizer step, and a ledger record of their loss and
    (entropy, margin) at the new step -> (state, ledger state)."""
    sub = {"tokens": bt["tokens"][sel], "labels": bt["labels"][sel]}
    (loss, s, _aux), grads = loss_and_grads(
        lambda p, b: Mdl.per_example_signals(p, cfg, b), state["params"], sub)
    with torch.no_grad():
        updates, opt_state = opt.update(grads, state["opt"], state["params"])
        state = {"params": apply_updates(state["params"], updates),
                 "opt": opt_state, "step": state["step"] + 1}
        signals = torch.stack([s["entropy"], s["margin"]], dim=-1)
        lstate = dledger.record(lcfg, lstate, bt["instance_id"][sel], loss,
                                state["step"], signals=signals)
    return state, lstate


def train_lm_policy(
    policy_name: str,
    ratio: float,
    *,
    steps: int = 150,
    batch: int = 32,
    seq: int = 64,
    seed: int = 0,
    cfg: Optional[ModelConfig] = None,
    device: str = "cuda",
) -> float:
    """A/B harness arm: the recycle loop under one ``SelectionPolicy``, a
    small instance pool so ids recur; every arm (the uniform control
    included) trains on exactly ``b = ratio * batch`` rows a step."""
    cfg, opt, state = _setup(cfg, steps, seed, device)
    pol = get_policy(policy_name)
    b = max(1, int(round(ratio * batch)))
    lcfg = HistoryConfig(capacity=1 << 10)
    lstate = dledger.init_state(lcfg, device)
    stream = SyntheticLMStream(DataConfig(batch, seq, cfg.vocab_size,
                                          seed=seed, instance_pool=batch * 4))
    noise = GeneratorNoise(torch.Generator(device).manual_seed(seed))
    for t in range(steps):
        raw = stream.batch(t)
        bt = _to(raw, ("tokens", "labels"), device)
        bt["instance_id"] = _to(raw, ("instance_id",), device,
                                np.int32)["instance_id"]
        with torch.no_grad():
            sel = policy_pick(pol, noise, lstate, bt["instance_id"], b)
        state, lstate = policy_step(cfg, opt, lcfg, state, lstate, bt, sel)
    return _eval(cfg, state["params"], stream, device)


def main(fast: bool = False, device: str = "cuda",
         cfg: Optional[ModelConfig] = None,
         steps: Optional[int] = None) -> list[str]:
    """Both tables; ``cfg`` (default llama3-8b's smoke config) and
    ``steps`` override the profile's."""
    steps = steps or (60 if fast else 150)
    kw = dict(steps=steps, cfg=cfg, device=device)
    out = ["table,method,ratio,eval_loss"]
    full = train_lm("full", 1.0, **kw)
    out.append(f"table3_lm,full,1.0,{full:.4f}")
    for method in METHODS:
        for ratio in RATIOS:
            loss = train_lm(method, ratio, **kw)
            out.append(f"table3_lm,{method},{ratio},{loss:.4f}")
    # policy A/B arms at matched compute; uniform + loss_ema ride along
    # as the in-run controls diff_tables' policy_check compares against
    out.append("")
    out.append("table,policy,ratio,eval_loss")
    for policy in sorted(POLICIES):
        for ratio in POLICY_RATIOS:
            loss = train_lm_policy(policy, ratio, **kw)
            out.append(f"table3_lm_policy,{policy},{ratio},{loss:.4f}")
    return out


if __name__ == "__main__":
    ap = parser()
    ap.add_argument("--arch", default="",
                    help="run at this arch's published width (default: "
                         "llama3-8b's smoke config)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut --arch to this many layers (0 = its depth)")
    args = ap.parse_args()
    cfg = configs.get(args.arch, layers=args.layers) if args.arch else None
    print("\n".join(main(fast=args.fast, device=args.device, cfg=cfg)))
