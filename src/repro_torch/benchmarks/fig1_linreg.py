"""Paper Fig.1: sampling methods on synthetic linear regression.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig1_linreg [--fast] \
        [--device cpu]

The twin of ``benchmarks/fig1_linreg.py``: y = 2x + 1 + U(-5,5), 1000
train / 10000 test points, the outlier variant adds U(-20,20) to 20
points. Mini-batch GD with each selection method at a sweep of sampling
rates; metric = normalized test loss (test MSE of the subsampled model /
test MSE of full-batch training). Batches are ``randperm(n)[:batch]`` and
the selectors' draws come from one ``torch.Generator`` on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.benchmarks import cli
from repro_torch.core.selection import GeneratorNoise, SelectionConfig, select
from repro_torch.data import SyntheticRegression

METHODS = ("uniform", "prob", "mink", "obftf")
RATIOS = (0.05, 0.1, 0.15, 0.25, 0.5)


def predict(w: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    return xb[:, 0] * w[0] + w[1]


def per_example(w, xb, yb) -> torch.Tensor:
    return torch.square(predict(w, xb) - yb)


def selection_config(method: str, ratio: float, batch: int):
    """(config, budget b): the appendix minK draws the b lowest losses
    inside a fresh random pool of min(batch, 2b)."""
    b = batch if method == "full" else SelectionConfig(
        method=method, ratio=ratio).budget(batch)
    cfg = SelectionConfig(
        method=method, ratio=ratio,
        mink_pool=min(batch, 2 * b) if method == "mink" else None,
    )
    return cfg, b


def gd_step(w, xb, yb, sel, lr: float) -> torch.Tensor:
    """One GD step on the picked rows ``sel`` of the batch: the gradient of
    their mean squared error."""
    w = w.detach().requires_grad_(True)
    loss = per_example(w, xb[sel], yb[sel]).mean()
    (g,) = torch.autograd.grad(loss, w)
    return (w - lr * g).detach()


def train_linreg(
    data: SyntheticRegression,
    method: str,
    ratio: float,
    *,
    steps: int = 300,
    batch: int = 100,
    lr: float = 1e-2,
    seed: int = 0,
    device: str = "cuda",
) -> float:
    """Returns test MSE after training with the given selection method."""
    x = torch.from_numpy(data.x_train).to(device)
    y = torch.from_numpy(data.y_train).to(device)
    n = x.shape[0]
    w = torch.zeros((2,), device=device)  # [slope, intercept]
    cfg, b = selection_config(method, ratio, batch)
    gen = torch.Generator(device).manual_seed(seed)
    noise = GeneratorNoise(gen)
    for _ in range(steps):
        idx = torch.randperm(n, generator=gen, device=device)[:batch]
        xb, yb = x[idx], y[idx]
        if method == "full":
            sel = torch.arange(batch, device=device)
        else:
            with torch.no_grad():
                sel = select(cfg, noise, per_example(w, xb, yb), b)
        w = gd_step(w, xb, yb, sel, lr)
    xt = torch.from_numpy(data.x_test).to(device)
    yt = torch.from_numpy(data.y_test).to(device)
    with torch.no_grad():
        return float(per_example(w, xt, yt).mean())


def run(outliers: bool, seeds=(0, 1, 2), steps: int = 300,
        device: str = "cuda") -> list[str]:
    data = SyntheticRegression(outliers=outliers)
    base = np.mean([
        train_linreg(data, "full", 1.0, steps=steps, seed=s, device=device)
        for s in seeds
    ])
    lines = []
    tag = "outliers" if outliers else "clean"
    for method in METHODS:
        for ratio in RATIOS:
            mse = np.mean([
                train_linreg(data, method, ratio, steps=steps, seed=s,
                             device=device)
                for s in seeds
            ])
            lines.append(f"fig1_{tag},{method},{ratio},{mse / base:.4f}")
    return lines


def main(fast: bool = False, device: str = "cuda",
         steps: int | None = None) -> list[str]:
    """The two tables; ``steps`` overrides the profile's step count."""
    steps = steps or (120 if fast else 300)
    seeds = (0,) if fast else (0, 1, 2)
    out = ["table,method,ratio,normalized_test_loss"]
    out += run(outliers=False, seeds=seeds, steps=steps, device=device)
    out += run(outliers=True, seeds=seeds, steps=steps, device=device)
    return out


if __name__ == "__main__":
    cli(main)
