"""Mamba2 / SSD blocks: the chunkwise-parallel selective state space (twin
of ``repro/models/ssm.py``).

The SSD recurrence  S_t = a_t·S_{t-1} + B_t u_tᵀ,  y_t = C_tᵀ S_t + D·x_t
runs in its chunked form (Mamba2 §6): the terms inside a chunk as a Q×Q
masked-decay product, the terms between chunks through per-chunk summary
states. ``ssd_chunked`` is the plain torch form, twice differentiable, which
every differentiated path runs; ``ssd_step`` is the one-token recurrence of
decoding.

``apply_mamba(..., ssd_kernel=True)`` runs the intra-chunk step through the
hand-written kernel instead (``kernels.ops.ssd_chunked_pallas``: the CUDA
kernel on the card, its plain version on the CPU), the reference's drop-in
for ``ssd_chunked`` with B and C shared across heads. It is forward only;
the hybrid's no-grad prefill sets it under ``cfg.use_flash_attention`` and
``loss_fn``/``logits_fn`` never do.

``mamba_decode_step`` writes the layer's ``MambaCache`` **in place** and
returns it, as the attention decode writes its KV cache.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .._device import resolve_device
from .layers import _randn, apply_norm, dense, dense_init, norm_init


def ssd_chunked(u, log_a, Bv, Cv, chunk: int, h0=None):
    """Chunked SSD.

    u (B, L, H, P) decay-free inputs; log_a (B, L, H) per-step log decay
    (≤ 0); Bv, Cv (B, L, N) shared across heads or (B, L, H, N) per head;
    h0 (B, H, N, P) or None. Returns (y (B, L, H, P), h_final (B, H, N, P)),
    f32.
    """
    Bb, L, H, P = u.shape
    per_head = Bv.ndim == 4
    N = Bv.shape[-1]
    if L % chunk:
        raise ValueError(f"sequence length {L} is not a multiple of the chunk {chunk}")
    nc, Q = L // chunk, chunk

    u = u.reshape(Bb, nc, Q, H, P).float()
    la = log_a.reshape(Bb, nc, Q, H).float()
    if per_head:
        Br = Bv.reshape(Bb, nc, Q, H, N).float()
        Cr = Cv.reshape(Bb, nc, Q, H, N).float()
    else:
        Br = Bv.reshape(Bb, nc, Q, N).float()
        Cr = Cv.reshape(Bb, nc, Q, N).float()

    l = torch.cumsum(la, dim=2)                                  # inclusive (B,nc,Q,H)
    # intra-chunk: masked decay attention. The exponent is masked, not its
    # result: exp(l_i - l_j) above the diagonal may overflow, and its
    # gradient through a selecting where would be 0·inf.
    rel = l[:, :, :, None, :] - l[:, :, None, :, :]              # l_i - l_j (B,nc,Q,Q,H)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=u.device).tril()
    decay = torch.exp(rel.masked_fill(~causal[None, None, :, :, None], float("-inf")))
    if per_head:
        scores = torch.einsum("bcihn,bcjhn->bcijh", Cr, Br)
    else:
        scores = torch.einsum("bcin,bcjn->bcij", Cr, Br)[..., None]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores * decay, u)

    # per-chunk summary states
    s_decay = torch.exp(l[:, :, -1:, :] - l)                     # exp(l_Q - l_j)
    uw = u * s_decay[..., None]
    if per_head:
        S = torch.einsum("bcjhn,bcjhp->bchnp", Br, uw)
    else:
        S = torch.einsum("bcjn,bcjhp->bchnp", Br, uw)
    g = torch.exp(l[:, :, -1, :])                                # chunk decay (B,nc,H)

    # the state after each chunk, S_c <- g_c·S_{c-1} + S_c, in chunk order
    # (the reference's associative scan computes the same recurrence)
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
                        S_scan[:, :-1]], dim=1)                  # state entering chunk c

    # inter-chunk contribution
    if per_head:
        y_inter = torch.einsum("bcihn,bchnp->bcihp", Cr, h_prev)
    else:
        y_inter = torch.einsum("bcin,bchnp->bcihp", Cr, h_prev)
    y_inter = y_inter * torch.exp(l)[..., None]
    y = (y_intra + y_inter).reshape(Bb, L, H, P)
    return y, h_final


def ssd_step(u_t, log_a_t, B_t, C_t, state):
    """One-token SSD recurrence (decode): u_t (B, H, P), log_a_t (B, H),
    B_t/C_t (B, N) or (B, H, N), state (B, H, N, P) → (y (B, H, P),
    new_state), f32."""
    a = torch.exp(log_a_t.float())[..., None, None]
    if B_t.ndim == 2:
        outer = torch.einsum("bn,bhp->bhnp", B_t.float(), u_t.float())
    else:
        outer = torch.einsum("bhn,bhp->bhnp", B_t.float(), u_t.float())
    new_state = a * state + outer
    if C_t.ndim == 2:
        y = torch.einsum("bn,bhnp->bhp", C_t.float(), new_state)
    else:
        y = torch.einsum("bhn,bhnp->bhp", C_t.float(), new_state)
    return y, new_state


# ------------------------------------------------------------ Mamba2 block --
class MambaCache(NamedTuple):
    conv: torch.Tensor     # (B, K-1, d_conv_in) rolling conv inputs
    state: torch.Tensor    # (B, H, N, P) SSD state, f32


def mamba_init(gen, cfg, dtype, lead=()):
    """The block's parameters, keys sorted; ``A_log``, ``D`` and ``dt_bias``
    are f32 in every model dtype, as in the reference."""
    d, din, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_n_heads
    lead = tuple(lead)
    conv_in = din + 2 * N
    dev, f32 = gen.device, torch.float32
    in_proj = dense_init(gen, d, 2 * din + 2 * N + H, dtype, lead=lead)
    conv_w = (_randn(gen, lead + (cfg.ssm_conv, conv_in)) * 0.2).to(dtype)
    out_proj = dense_init(gen, din, d, dtype, lead=lead)
    return {
        "A_log": torch.zeros(lead + (H,), dtype=f32, device=dev),        # A = -exp(A_log) = -1
        "D": torch.ones(lead + (H,), dtype=f32, device=dev),
        "conv_b": torch.zeros(lead + (conv_in,), dtype=dtype, device=dev),
        "conv_w": conv_w,
        "dt_bias": torch.full(lead + (H,), -2.0, dtype=f32, device=dev),  # softplus ≈ 0.13
        "gate_norm": norm_init(din, dtype, lead=lead, device=dev),
        "in_proj": in_proj,
        "out_proj": out_proj,
    }


def _split_in_proj(cfg, zxbcdt):
    """(z, xBC, dt) of the input projection: sizes [din, din + 2N, H]."""
    din, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_n_heads
    return torch.split(zxbcdt, [din, din + 2 * N, H], dim=-1)


def _causal_conv(xBC, w, b):
    """Depthwise causal conv of kernel K over (B, L, Cin): an explicit sum of
    K shifted products in x's dtype, as the reference sums them (F.conv1d
    would accumulate a bf16 input in f32 and round otherwise)."""
    K = w.shape[0]
    L = xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + L, :] * w[i] for i in range(K))
    return F.silu(out + b)


def apply_mamba(p, x, cfg, h0=None, conv0=None, *, ssd_kernel=False):
    """x (B, L, d) → (y (B, L, d), MambaCache): full sequence (training and
    prefill). ``ssd_kernel`` runs the SSD through ``ops.ssd_chunked_pallas``
    (forward only; the no-grad prefill of the kernel route)."""
    from ..kernels import ops

    B_, L, _ = x.shape
    din, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_n_heads, cfg.ssm_head_dim
    K = cfg.ssm_conv
    z, xBC, dt_raw = _split_in_proj(cfg, dense(p["in_proj"], x))
    if conv0 is not None:
        xBC_in = torch.cat([conv0, xBC], dim=1)[:, -(L + K - 1):]
        conv_out = _causal_conv(xBC_in, p["conv_w"], p["conv_b"])[:, -L:]
    else:
        conv_out = _causal_conv(xBC, p["conv_w"], p["conv_b"])
    xc, Bc, Cc = torch.split(conv_out, [din, N, N], dim=-1)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])                          # (B,L,H)
    A = -torch.exp(p["A_log"])                                              # (H,)
    xh = xc.reshape(B_, L, H, P)
    u = xh.float() * dt[..., None]
    log_a = dt * A
    chunk = cfg.ssm_chunk
    if L % chunk:
        chunk = 1 if L == 1 else next(c for c in range(min(chunk, L), 0, -1) if L % c == 0)
    ssd = ops.ssd_chunked_pallas if ssd_kernel else ssd_chunked
    y, h_final = ssd(u, log_a, Bc, Cc, chunk, h0=h0)
    y = y + xh.float() * p["D"][None, None, :, None]
    y = y.reshape(B_, L, din).to(x.dtype)
    y = apply_norm(p["gate_norm"], y, cfg.norm_eps) * F.silu(z)
    conv_tail = (torch.cat([conv0, xBC], dim=1) if conv0 is not None else xBC)[:, -(K - 1):]
    # copies, not views: a view would keep the layer's whole input projection
    # and stacked chunk states alive for as long as the cache lives (about
    # 25 GB over zamba2-7b's 81 layers at its serving prefill)
    return dense(p["out_proj"], y), MambaCache(conv_tail.contiguous(), h_final.contiguous())


def init_mamba_cache(cfg, batch, dtype, device="cuda") -> MambaCache:
    """Zeroed conv tails and SSD states on ``device`` (the card unless the
    caller asks for the CPU)."""
    device = resolve_device(device)
    din, N = cfg.d_inner, cfg.ssm_state
    H, P = cfg.ssm_n_heads, cfg.ssm_head_dim
    return MambaCache(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, din + 2 * N), dtype=dtype, device=device),
        state=torch.zeros((batch, H, N, P), dtype=torch.float32, device=device),
    )


def mamba_decode_step(p, x, cache: MambaCache, cfg):
    """x (B, 1, d) → (y (B, 1, d), cache), the cache written in place."""
    B_ = x.shape[0]
    din, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_n_heads, cfg.ssm_head_dim
    z, xBC, dt_raw = _split_in_proj(cfg, dense(p["in_proj"], x[:, 0]))
    window = torch.cat([cache.conv, xBC[:, None]], dim=1)                   # (B,K,Cin)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"])
    xc, Bc, Cc = torch.split(conv_out, [din, N, N], dim=-1)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])                          # (B,H)
    A = -torch.exp(p["A_log"])
    xh = xc.reshape(B_, H, P)
    u = xh.float() * dt[..., None]
    y, new_state = ssd_step(u, dt * A, Bc, Cc, cache.state)
    y = y + xh.float() * p["D"][None, :, None]
    y = y.reshape(B_, din).to(x.dtype)
    y = apply_norm(p["gate_norm"], y, cfg.norm_eps) * F.silu(z)
    y = dense(p["out_proj"], y)[:, None]
    cache.conv.copy_(window[:, 1:])
    cache.state.copy_(new_state)
    return y, cache
