"""Deterministic synthetic classification sets for the paper's experiments
(twin of ``repro/data/synthetic.py`` ``classification_dataset`` and
``minibatches``).

Drawn from a ``torch.Generator`` on the CPU and then moved, so one seed gives
the same data on every device. The numbers differ from ``jax.random``'s;
parity tests feed both packages the JAX arrays through numpy instead.
"""
from __future__ import annotations

import torch

from .._device import resolve_device


def classification_dataset(generator: torch.Generator, n: int, d: int,
                           n_classes: int, noise: float = 1.0, *, device="cuda"):
    """Gaussian class prototypes + isotropic noise. Returns {"x": (n,d) f32,
    "y": (n,) int64}."""
    dev = resolve_device(device)
    protos = torch.randn(n_classes, d, generator=generator) * 2.0
    y = torch.randint(0, n_classes, (n,), generator=generator)
    x = protos[y] + torch.randn(n, d, generator=generator) * noise
    return {"x": x.float().to(dev), "y": y.to(dev)}


def minibatches(data, batch_size: int, *, seed: int = 0, epochs: int = 1):
    """Shuffled mini-batch iterator over a classification dataset."""
    n = data["x"].shape[0]
    gen = torch.Generator().manual_seed(seed)
    for _ in range(epochs):
        perm = torch.randperm(n, generator=gen).to(data["x"].device)
        for i in range(0, n - batch_size + 1, batch_size):
            idx = perm[i : i + batch_size]
            yield {"x": data["x"][idx], "y": data["y"][idx]}
