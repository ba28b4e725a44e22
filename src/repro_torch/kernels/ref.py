"""Plain PyTorch versions of the fused Krylov kernels (twins of
``repro/kernels/ref.py`` ``bicgstab_x_update_ref``, ``bicgstab_residual_dots_ref``
``dot2_ref`` and, for ``ops.gram_block``, ``gram_block_ref``).

``kernels.ops`` runs these for tensors on the CPU; ``chip_smoke.py`` holds
each CUDA kernel against them on the card. Sums are ``torch.sum`` of the
products, not ``torch.dot``: on the CPU ``torch.dot`` accumulates in f32 in
one sequence (4e-5 relative error at n = 200k), ``torch.sum`` pairwise.
"""
from __future__ import annotations

import torch

# Column block of the reference's Gram kernel (``repro/kernels/cg_fused.py``
# ``BLOCK_GRAM``): the plain Gram sums per-block partials in block order.
BLOCK_GRAM = 16 * 1024


def x_update_ref(x, p, s, alpha, gamma):
    """x + alpha*p + gamma*s in f32."""
    return x.float() + alpha * p.float() + gamma * s.float()


def residual_dots_ref(s, As, r0s, gamma):
    """r = s - gamma*As; returns (r, <r,r0s>, <r,r>)."""
    r = s.float() - gamma * As.float()
    return r, torch.sum(r * r0s.float()), torch.sum(r * r)


def dot2_ref(u, v):
    """(<u,v>, <v,v>) in f32."""
    uf, vf = u.float(), v.float()
    return torch.sum(uf * vf), torch.sum(vf * vf)


def gram_block_ref(U, V):
    """U @ V.T of (s_u, n) and (s_v, n) blocks in f32: per-column-block
    partials over ``BLOCK_GRAM`` columns, added in block order (the
    reference's order of summation)."""
    Uf, Vf = U.float(), V.float()
    out = torch.zeros((Uf.shape[0], Vf.shape[0]), dtype=torch.float32, device=Uf.device)
    for c in range(0, Uf.shape[1], BLOCK_GRAM):
        out = out + Uf[:, c:c + BLOCK_GRAM] @ Vf[:, c:c + BLOCK_GRAM].T
    return out
