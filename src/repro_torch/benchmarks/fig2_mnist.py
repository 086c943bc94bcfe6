"""Paper Fig.2: sampling methods on MNIST-like classification.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig2_mnist [--fast] \
        [--device cpu]

The twin of ``benchmarks/fig2_mnist.py``: paper §4.2 settings on the
synthetic MNIST-shaped dataset (2 hidden layers x 256 units, batch 128,
SGD lr 0.1); metric = test accuracy per (method, sampling rate). The
policy A/B arms train at matched compute: one forward + backward on the
``ratio * batch`` rows a policy picks from a per-example ledger (loss EMA
and entropy/margin EMAs) updated only from the rows trained on; there is
no selection forward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.benchmarks import cli
from repro_torch.benchmarks.fig1_linreg import selection_config
from repro_torch.core.obftf import loss_and_grads
from repro_torch.core.selection import (
    POLICIES,
    GeneratorNoise,
    SelectionConfig,
    get_policy,
    policy_score,
    select,
    select_by_score,
)
from repro_torch.data import mnist_like
from repro_torch.models.params import tree_leaves, tree_map

METHODS = ("uniform", "prob", "mink", "obftf")
RATIOS = (0.1, 0.25, 0.5)
POLICY_RATIOS = (0.1, 0.25)


def init_mlp(gen: torch.Generator, sizes=(784, 256, 256, 10)) -> dict:
    """He-normal weights and zero biases, drawn on the generator's device:
    {"0": {"w", "b"}, "1": ...} in layer order (a ``models.params`` tree;
    the JAX bench's list of layers)."""
    params = {}
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        w = torch.randn((a, b), generator=gen, device=gen.device)
        params[str(i)] = {"w": w * (2.0 / a) ** 0.5,
                          "b": torch.zeros((b,), device=gen.device)}
    return params


def forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    *hidden, out = params.values()
    for layer in hidden:
        x = F.relu(x @ layer["w"] + layer["b"])
    return x @ out["w"] + out["b"]


def _ce(logits, y):
    lse = torch.logsumexp(logits, dim=-1)
    return lse - logits.gather(-1, y[:, None].long())[:, 0], lse


def per_example_ce(params, x, y) -> torch.Tensor:
    return _ce(forward(params, x), y)[0]


def signals_ce(params, x, y):
    """Per-example (ce, entropy, margin) in one forward, the bench twin of
    the serving recorder's signal derivation."""
    logits = forward(params, x)
    ce, lse = _ce(logits, y)
    ent = lse - (torch.softmax(logits, dim=-1) * logits).sum(dim=-1)
    top2 = torch.topk(logits, 2, dim=-1).values
    return ce, ent, top2[:, 0] - top2[:, 1]


def _sgd(params, fn, inputs, lr):
    """(fn's outputs, detached; params - lr * grad of the mean of the
    per-example losses that lead them)."""
    out, grads = loss_and_grads(fn, params, inputs)
    g = iter(tree_leaves(grads))
    return out, tree_map(lambda _, p: p - lr * next(g), params)


def sgd_step(params, xb, yb, sel, lr: float) -> dict:
    """One SGD step on the picked rows ``sel`` of the batch."""
    return _sgd(params, lambda p, b: per_example_ce(p, *b),
                (xb[sel], yb[sel]), lr)[1]


def policy_pick(pol, noise, ema, sig, seen, idx, b: int, cold: float):
    """The rows (dataset positions) a policy trains on from batch ``idx``:
    a Gumbel-top-b draw by its score of the ledger's entries."""
    scores = policy_score(pol, ema[idx], sig[idx], seen[idx], cold)
    return idx[select_by_score(noise, scores, b)]


def policy_step(params, ema, sig, seen, x, y, rows, lr: float,
                decay: float):
    """Train on ``rows`` and EMA their fresh (ce, entropy, margin) into
    the ledger arrays -> (params, ema, sig, seen); a first sighting takes
    the fresh value as its previous one."""
    (ce, ent, mar), params = _sgd(params, lambda p, b: signals_ce(p, *b),
                                  (x[rows], y[rows]), lr)
    new_sig = torch.stack([ent, mar], dim=-1)
    old = seen[rows]
    prev_e = torch.where(old, ema[rows], ce)
    prev_s = torch.where(old[:, None], sig[rows], new_sig)
    ema = ema.index_copy(0, rows, decay * prev_e + (1 - decay) * ce)
    sig = sig.index_copy(0, rows, decay * prev_s + (1 - decay) * new_sig)
    return params, ema, sig, seen.index_fill(0, rows, True)


def _data(data, device):
    data = data if data is not None else mnist_like(8192, 2048, seed=0)
    return [torch.from_numpy(a).to(device) for a in data]


def _accuracy(params, xte, yte) -> float:
    with torch.no_grad():
        pred = torch.argmax(forward(params, xte), dim=-1)
        return float((pred == yte).to(torch.float32).mean())


def _batches(n: int, batch: int, epochs: int, gen: torch.Generator):
    """Each epoch a fresh permutation, cut into n // batch batches."""
    for _ in range(epochs):
        order = torch.randperm(n, generator=gen, device=gen.device)
        for i in range(n // batch):
            yield order[i * batch:(i + 1) * batch]


def train_mnist(
    method: str,
    ratio: float,
    *,
    epochs: int = 20,
    batch: int = 128,
    lr: float = 0.1,
    seed: int = 0,
    device: str = "cuda",
    data=None,
) -> float:
    """Test accuracy after training with the given selection method.
    ``data`` is ``mnist_like``'s four arrays (default: 8192 / 2048)."""
    xtr, ytr, xte, yte = _data(data, device)
    params = init_mlp(torch.Generator(device).manual_seed(seed))
    cfg, b = selection_config(method, ratio, batch)
    gen = torch.Generator(device).manual_seed(seed + 1)
    noise = GeneratorNoise(gen)
    for idx in _batches(xtr.shape[0], batch, epochs, gen):
        xb, yb = xtr[idx], ytr[idx]
        if method == "full":
            sel = torch.arange(batch, device=device)
        else:
            with torch.no_grad():
                sel = select(cfg, noise, per_example_ce(params, xb, yb), b)
        params = sgd_step(params, xb, yb, sel, lr)
    return _accuracy(params, xte, yte)


def train_mnist_policy(
    policy_name: str,
    ratio: float,
    *,
    epochs: int = 20,
    batch: int = 128,
    lr: float = 0.1,
    seed: int = 0,
    decay: float = 0.9,
    cold: float = 1e3,
    device: str = "cuda",
    data=None,
) -> float:
    """A/B harness arm: train under a ``SelectionPolicy`` at matched
    compute. Every arm (the uniform control included) pays one forward +
    backward on the ``b = ratio * batch`` rows its policy picked; arms
    differ only in how they score the ledger."""
    xtr, ytr, xte, yte = _data(data, device)
    params = init_mlp(torch.Generator(device).manual_seed(seed))
    pol = get_policy(policy_name)
    b = SelectionConfig(method="obftf", ratio=ratio).budget(batch)
    n = xtr.shape[0]
    ema = torch.zeros((n,), dtype=torch.float32, device=device)
    sig = torch.zeros((n, 2), dtype=torch.float32, device=device)
    seen = torch.zeros((n,), dtype=torch.bool, device=device)
    gen = torch.Generator(device).manual_seed(seed + 1)
    noise = GeneratorNoise(gen)
    for idx in _batches(n, batch, epochs, gen):
        with torch.no_grad():
            rows = policy_pick(pol, noise, ema, sig, seen, idx, b, cold)
        params, ema, sig, seen = policy_step(params, ema, sig, seen, xtr, ytr,
                                             rows, lr, decay)
    return _accuracy(params, xte, yte)


def main(fast: bool = False, device: str = "cuda", epochs: int | None = None,
         data=None) -> list[str]:
    """Both tables; ``epochs`` and ``data`` override the profile's."""
    epochs = epochs or (6 if fast else 20)
    if data is None:
        data = mnist_like(8192, 2048, seed=0)  # made once, shared by the arms
    kw = dict(epochs=epochs, device=device, data=data)
    out = ["table,method,ratio,test_accuracy"]
    full = train_mnist("full", 1.0, **kw)
    out.append(f"fig2_mnist,full,1.0,{full:.4f}")
    for method in METHODS:
        for ratio in RATIOS:
            acc = train_mnist(method, ratio, **kw)
            out.append(f"fig2_mnist,{method},{ratio},{acc:.4f}")
    # policy A/B arms: same epochs, same matched per-step budget; the
    # uniform row is the control diff_tables compares every policy against
    out.append("")
    out.append("table,policy,ratio,test_accuracy")
    for policy in sorted(POLICIES):
        for ratio in POLICY_RATIOS:
            acc = train_mnist_policy(policy, ratio, **kw)
            out.append(f"fig2_mnist_policy,{policy},{ratio},{acc:.4f}")
    return out


if __name__ == "__main__":
    cli(main)
