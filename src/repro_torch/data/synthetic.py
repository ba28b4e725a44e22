"""Deterministic synthetic data (twin of ``repro/data/synthetic.py``): LM
token batches (``lm_batch``) and the classification sets of the paper's
experiments (``classification_dataset``, ``minibatches``).

Drawn from a ``torch.Generator`` on the CPU and then moved, so one seed gives
the same data on every device. The numbers differ from ``jax.random``'s;
parity tests feed both packages the JAX arrays through numpy instead.
"""
from __future__ import annotations

import torch

from .._device import resolve_device


def lm_batch(generator: torch.Generator, cfg, batch_size: int, seq_len: int, *,
             device="cuda"):
    """Synthetic next-token batch: a noisy periodic token stream (random
    start, steps in [-3, 3] modulo the vocabulary), the process of the
    reference's ``lm_batch``. Returns {"loss_mask" f32, "targets" int64,
    "tokens" int64}, each (batch_size, seq_len)."""
    if cfg.family in ("vlm", "audio"):
        raise NotImplementedError(
            f"{cfg.family} batches carry stub modality embeddings; the family is "
            f"ROADMAP item 18")
    dev = resolve_device(device)
    base = torch.randint(0, cfg.vocab_size, (batch_size, 1), generator=generator)
    steps = torch.randint(0, 7, (batch_size, seq_len), generator=generator) - 3
    stream = torch.remainder(base + torch.cumsum(steps, dim=1), cfg.vocab_size)
    tokens, targets = stream[:, :-1], stream[:, 1:]
    # keep shapes uniform: repeat the last column
    tokens = torch.cat([tokens, tokens[:, -1:]], dim=1)
    targets = torch.cat([targets, targets[:, -1:]], dim=1)
    return {
        "loss_mask": torch.ones((batch_size, seq_len), dtype=torch.float32, device=dev),
        "targets": targets.to(dev),
        "tokens": tokens.to(dev),
    }


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
