"""Attention substrate (counterpart of `repro.models.attention`): RoPE, the
online-softmax (flash-style) chunked attention, GQA grouping, sliding
windows, MLA (latent) attention, and the decode paths.

The training / prefill attention is the reference's online-softmax
recurrence over KV chunks, here a Python loop over the chunks in place of
`lax.scan`: memory O(S·chunk) instead of O(S²), every score and value
product one batched f32 matmul.  As in the reference, every chunk is
computed for every query (a chunk wholly above the causal diagonal or
outside the window is masked, not skipped), and the arithmetic is f32
whatever the input dtype.

Serving fills the masked scores and takes their exp in place, in the
score buffer itself.  When autograd records (grad enabled and q, k or v
requiring grad) the same two steps run out of place, since `amax` has
saved the scores for its backward; the values are the same bits.  Each
layer's chunks are then kept for backward, which the training step's
per-layer remat bounds to one layer at a time.

Masked scores are filled with the finite -1e30, never -inf: a query whose
first chunks are all masked gets m = -1e30 and exp(s - m) = 1 on them, and
the first chunk with a live key wipes that sum through
corr = exp(-1e30 - m_real) = 0.  With -inf the same step is NaN.

Decode is one query against the cache.  MLA decode uses the absorbed-weight
latent path: scores and values are computed against the (kv_lora + d_rope)
latent cache.

Layouts: each function takes and returns the reference's layouts
((B, S, H, d) and (B, C, Hkv, d) caches); inside, K and V are copied once
into (B, Hkv, S, d) f32 (the cast and the transpose in one pass) so that
every product is a plain batched matmul, and GQA stays grouped: q is
viewed (B, Hkv, S·G, d) against un-replicated K/V.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

_NEG_INF = -1e30


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_freqs(d: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=device) / d))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, d) with d even; positions: (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                   # (d/2,)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, d/2)
    cos = torch.cos(angles)[..., None, :]                    # (..., S, 1, d/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _f32_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, S, Hkv, d) -> a contiguous (B, Hkv, S, d) f32 copy, cast and
    transposed in one pass."""
    B, S, Hkv, d = x.shape
    out = torch.empty((B, Hkv, S, d), dtype=torch.float32, device=x.device)
    out.copy_(x.permute(0, 2, 1, 3))
    return out


# --------------------------------------------------------------------------
# flash-style chunked attention (train / prefill)
# --------------------------------------------------------------------------

def flash_attention(
    q: torch.Tensor,            # (B, S, H, dq)
    k: torch.Tensor,            # (B, S, Hkv, dq)
    v: torch.Tensor,            # (B, S, Hkv, dv)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    chunk: int = 512,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Online-softmax attention, O(S·chunk) memory.  Returns (B, S, H, dv).

    GQA stays *grouped*: query head h = i·G + g reads KV head i, and the
    scores are computed against un-replicated K/V.  Ragged S is padded up
    to a whole chunk; padded keys are masked off and padded queries sliced
    away at the end.
    """
    B, S, H, dq = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    dv = v.shape[-1]
    scale = scale if scale is not None else dq ** -0.5
    chunk = min(chunk, S)
    S_real = S
    pad = (-S) % chunk
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        S = S + pad
    n_chunks = S // chunk
    dev = q.device
    # autograd records: the scores it saves must not be overwritten
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)

    # (B, Hkv, S·G, dq): row s·G + g is query s of head i·G + g
    qg = torch.empty((B, Hkv, S, G, dq), dtype=torch.float32, device=dev)
    qg.copy_(q.view(B, S, Hkv, G, dq).permute(0, 2, 1, 3, 4))
    qg = qg.mul_(scale).view(B, Hkv, S * G, dq)
    kf = _f32_heads(k)                                      # (B, Hkv, S, dq)
    vf = _f32_heads(v)                                      # (B, Hkv, S, dv)
    q_pos = torch.arange(S, device=dev)

    m = torch.full((B, Hkv, S * G), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, S * G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, S * G, dv), dtype=torch.float32, device=dev)
    for j in range(n_chunks):
        k_j = kf[:, :, j * chunk:(j + 1) * chunk]
        v_j = vf[:, :, j * chunk:(j + 1) * chunk]
        s = torch.matmul(qg, k_j.transpose(-1, -2))         # (B, Hkv, S·G, chunk)
        k_pos = j * chunk + torch.arange(chunk, device=dev)
        mask = (k_pos[None, :] < S_real).expand(S, chunk)
        if causal:
            mask = mask & (q_pos[:, None] >= k_pos[None, :])
        if window is not None:
            mask = mask & ((q_pos[:, None] - k_pos[None, :]) < window)
        if grad:
            s = s.view(B, Hkv, S, G, chunk).masked_fill(~mask[:, None, :], _NEG_INF)
            s = s.view(B, Hkv, S * G, chunk)
        else:
            s.view(B, Hkv, S, G, chunk).masked_fill_(~mask[:, None, :], _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = (s - m_new[..., None]).exp() if grad else s.sub_(m_new[..., None]).exp_()
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.matmul(p, v_j)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    out = out.view(B, Hkv, S, G, dv).permute(0, 2, 1, 3, 4).reshape(B, S, H, dv)
    out = out.to(q.dtype)
    return out[:, :S_real] if pad else out


# --------------------------------------------------------------------------
# decode attention (one new token against a cache)
# --------------------------------------------------------------------------

def decode_attention(
    q: torch.Tensor,            # (B, H, dq) — the single new query
    k_cache: torch.Tensor,      # (B, C, Hkv, dq)
    v_cache: torch.Tensor,      # (B, C, Hkv, dv)
    valid: torch.Tensor,        # (B, C) bool — which cache slots are live
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Returns (B, H, dv).  Works for full, windowed (ring) and MQA caches.
    Every slot is read, live or not, as in the reference."""
    B, H, dq = q.shape
    Hkv = k_cache.shape[2]
    G = H // Hkv
    scale = scale if scale is not None else dq ** -0.5
    qg = (q.to(torch.float32) * scale).view(B, Hkv, G, dq)
    s = torch.matmul(qg, _f32_heads(k_cache).transpose(-1, -2))   # (B, Hkv, G, C)
    s.masked_fill_(~valid[:, None, None, :], _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(p, _f32_heads(v_cache))                     # (B, Hkv, G, dv)
    return out.reshape(B, H, -1).to(q.dtype)


def mla_decode_attention(
    q_nope: torch.Tensor,       # (B, H, d_nope)
    q_rope: torch.Tensor,       # (B, H, d_rope) — rope already applied
    ckv_cache: torch.Tensor,    # (B, C, r)   latent KV cache
    krope_cache: torch.Tensor,  # (B, C, d_rope) shared rope key cache
    valid: torch.Tensor,        # (B, C)
    w_uk: torch.Tensor,         # (H, d_nope, r)  up-projection K
    w_uv: torch.Tensor,         # (H, r, d_v)     up-projection V
    *,
    scale: float,
) -> torch.Tensor:
    """Absorbed-weight MLA decode: attend in the latent space.

    q_lat = q_nope · W_uk   →  scores = q_lat · c_kv + q_rope · k_rope
    ctx_lat = softmax · c_kv →  out_h = ctx_lat · W_uv
    """
    f32 = torch.float32
    q_lat = torch.einsum("bhd,hdr->bhr", q_nope.to(f32), w_uk.to(f32))
    ckv = ckv_cache.to(f32)
    s = torch.matmul(q_lat, ckv.transpose(1, 2))                   # (B, H, C)
    s = s + torch.matmul(q_rope.to(f32), krope_cache.to(f32).transpose(1, 2))
    s = torch.where(valid[:, None, :], s * scale, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    ctx = torch.matmul(p, ckv)                                      # (B, H, r)
    out = torch.einsum("bhr,hrv->bhv", ctx, w_uv.to(f32))
    return out.to(q_nope.dtype)
