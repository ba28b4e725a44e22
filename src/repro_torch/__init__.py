"""PyTorch/CUDA port of the distributed Hessian-free optimizer.

Mirrors ``repro`` (the JAX reference) file for file: ``repro_torch.core.hf``
is the twin of ``repro.core.hf``, and so on. This package imports ``torch``
only; it never imports ``jax`` or ``repro``.

Device rule: every entry point that creates tensors takes ``device``
(default ``"cuda"``). The CPU is used only when the caller passes
``device="cpu"``; without CUDA the default raises instead of falling back.
"""
