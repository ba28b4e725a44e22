"""SSD (Mamba2) chunked scan with its intra-chunk step in a CUDA kernel
(twin of ``repro/kernels/ssd_scan.py``).

``ssd_intra`` launches the kernel of ``csrc/ssd_scan.cu`` (built into the
port's one extension, ``cg_fused.extension``): for each (batch, chunk,
head), with B and C shared across heads, l = cumsum(log_a), y =
((C·Bᵀ) ∘ exp(lᵢ − lⱼ) ∘ causal)·u, the chunk state S = Bᵀ(u ∘ exp(l_Q − l))
and g = exp(l_Q), all f32; the products run on the tensor cores in split
TF32 (bf16 for C·Bᵀ with bf16 B and C). It checks device, dtype, shape, the (Q, N, P) it
takes and contiguity and raises on anything else; it never falls back to
the plain version.

``ssd_chunked_pallas`` is the reference's drop-in for ``ssd_chunked`` with
shared-heads B/C: the intra-chunk step through ``ops.ssd_intra`` (the kernel
for CUDA tensors, ``kernels.ref.ssd_intra_ref`` for CPU ones), then the scan
between chunks and the inter-chunk term in torch. Forward only, as in the
reference; ``models.ssm.apply_mamba`` runs it for the no-grad prefill.
"""
from __future__ import annotations

import torch

from .cg_fused import extension

MAX_Q = 128                  # most Q (chunk)
MAX_NP = 256                 # most N (state) and P (head dim)
MAX_SMEM_BYTES = 232_448     # shared memory one block may use on Hopper
HEADS_PER_BLOCK = 8          # heads of one (batch, chunk) a kernel block takes
BC_DTYPES = (torch.float32, torch.bfloat16)


def _round_up(x, m):
    return -(-x // m) * m


def smem_bytes(Q, N, P):
    """Shared memory of one kernel block (``csrc/ssd_scan.cu``), all f32: B
    (Qp × LN), two slots of u (Qp × LP each), and l and w of the block's
    heads (8 × Qp each); Qp and Np are Q and N rounded up to 16, Pp is P
    rounded up to 8, and LN, LP are Np, Pp rounded up to 32, plus 4."""
    Qp, Np, Pp = _round_up(Q, 16), _round_up(N, 16), _round_up(P, 8)
    LN, LP = _round_up(Np, 32) + 4, _round_up(Pp, 32) + 4
    return 4 * (Qp * LN + 2 * Qp * LP + 2 * HEADS_PER_BLOCK * Qp)


def check_dims(Q, N, P):
    """Raise unless the kernel takes chunk Q (1 to ``MAX_Q``), state N and
    head dim P (1 to ``MAX_NP``) with ``smem_bytes(Q, N, P)`` at most
    ``MAX_SMEM_BYTES`` (at Q = 128 every N, P ≤ 128 fits; N = P = 256 does
    not)."""
    if not (1 <= Q <= MAX_Q and 1 <= N <= MAX_NP and 1 <= P <= MAX_NP):
        raise ValueError(f"ssd_intra takes Q from 1 to {MAX_Q} and N, P from 1 to {MAX_NP}, "
                         f"got Q {Q}, N {N}, P {P}")
    if smem_bytes(Q, N, P) > MAX_SMEM_BYTES:
        raise ValueError(f"ssd_intra at Q {Q}, N {N}, P {P} needs {smem_bytes(Q, N, P)} bytes "
                         f"of shared memory, more than {MAX_SMEM_BYTES}")


def ssd_intra(u, log_a, Bv, Cv):
    """u (B, nc, H, Q, P) and log_a (B, nc, H, Q) f32, Bv and Cv (B, nc, Q, N)
    f32 or bf16 (shared across heads), all contiguous CUDA tensors → (y
    (B, nc, H, Q, P), S (B, nc, H, N, P), g (B, nc, H), l (B, nc, H, Q)), f32."""
    for t, name in ((u, "u"), (log_a, "log_a"), (Bv, "Bv"), (Cv, "Cv")):
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor")
    if u.ndim != 5 or log_a.ndim != 4 or Bv.ndim != 4:
        raise ValueError(f"u must be 5-D and log_a, Bv 4-D, got {tuple(u.shape)}, "
                         f"{tuple(log_a.shape)}, {tuple(Bv.shape)}")
    B, nc, H, Q, P = u.shape
    N = Bv.shape[3]
    if tuple(log_a.shape) != (B, nc, H, Q) or tuple(Bv.shape) != (B, nc, Q, N) \
            or Cv.shape != Bv.shape or min(B, nc, H) == 0:
        raise ValueError(f"u {tuple(u.shape)}, log_a {tuple(log_a.shape)}, Bv "
                         f"{tuple(Bv.shape)}, Cv {tuple(Cv.shape)} do not fit (B, nc, H, Q, P), "
                         f"(B, nc, H, Q) and (B, nc, Q, N)")
    if u.dtype != torch.float32 or log_a.dtype != torch.float32:
        raise TypeError(f"u and log_a must be float32, got {u.dtype}, {log_a.dtype}")
    if Bv.dtype not in BC_DTYPES or Cv.dtype != Bv.dtype:
        raise TypeError(f"Bv and Cv must both be float32 or both bfloat16, got {Bv.dtype}, "
                        f"{Cv.dtype}")
    check_dims(Q, N, P)
    for t, name in ((u, "u"), (log_a, "log_a"), (Bv, "Bv"), (Cv, "Cv")):
        if t.device != u.device:
            raise ValueError(f"{name} must be on {u.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return tuple(extension().ssd_intra(u, log_a, Bv, Cv))


def ssd_chunked_pallas(u, log_a, Bv, Cv, chunk: int, h0=None):
    """Chunked SSD with B/C shared across heads: u (B, L, H, P), log_a (B, L, H),
    Bv and Cv (B, L, N), h0 (B, H, N, P) or None → (y (B, L, H, P) f32,
    h_final (B, H, N, P) f32), as ``models.ssm.ssd_chunked``. L must be a
    multiple of ``chunk``."""
    from . import ops

    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (u, log_a, Bv, Cv, h0)):
        raise RuntimeError("ssd_chunked_pallas is forward only (the SSD kernel has no "
                           "backward): run it under torch.no_grad(), or use ssd_chunked")
    Bb, L, H, P = u.shape
    if L % chunk:
        raise ValueError(f"sequence length {L} is not a multiple of the chunk {chunk}")
    nc, Q = L // chunk, chunk
    N = Bv.shape[-1]
    u_r = u.float().reshape(Bb, nc, Q, H, P).transpose(2, 3).contiguous()
    la_r = log_a.float().reshape(Bb, nc, Q, H).transpose(2, 3).contiguous()
    Bv_r = Bv.reshape(Bb, nc, Q, N).contiguous()
    Cv_r = Cv.reshape(Bb, nc, Q, N).contiguous()
    y_intra, S, g, l = ops.ssd_intra(u_r, la_r, Bv_r, Cv_r)

    # The state after each chunk, S_c <- g_c·S_{c-1} + S_c, in chunk order:
    # ratios of cumulative decay products would underflow f32 within a few
    # chunks (a chunk's g is about e^-16 at the model's shapes).
    states = [S[:, 0]]
    for c in range(1, nc):
        states.append(g[:, c, :, None, None] * states[-1] + S[:, c])
    S_scan = torch.stack(states, dim=1)
    if h0 is not None:
        h0 = h0.float()
        cumg = torch.exp(torch.cumsum(torch.log(torch.clamp_min(g, 1e-38)), dim=1))
        S_scan = S_scan + cumg[..., None, None] * h0[:, None]
    h_final = S_scan[:, -1]
    h_prev = torch.cat([h0[:, None] if h0 is not None else torch.zeros_like(S_scan[:, :1]),
                        S_scan[:, :-1]], dim=1)
    y_inter = torch.einsum("bcin,bchnp->bchip", Cv_r.float(), h_prev) * torch.exp(l)[..., None]
    y = (y_intra + y_inter).transpose(2, 3).reshape(Bb, L, H, P)
    return y, h_final
