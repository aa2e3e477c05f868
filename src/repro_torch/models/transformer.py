"""Unified LM transformer covering all five assigned architectures
(counterpart of `repro.models.transformer`): forward, the chunked
cross-entropy loss, decode, and optional per-layer remat.

Params are plain nested dicts of tensors with the reference's leaf names,
shapes and dtypes: the layers are stacked on a leading axis
(`dense_layers`, `moe_layers`), which `forward` and `decode_step` walk in
a Python loop where the reference runs `lax.scan`.

Feature matrix (selected per LMConfig):
  GQA / MHA, QKV bias, qk-norm, RoPE, sliding-window, squared-ReLU or SwiGLU,
  MoE (top-k, shared experts, leading dense layers), MLA, MTP block.

Training: `lm_loss` is the next-token cross-entropy (`chunked_xent`), plus
0.01 of the MoE load-balance loss and, with `cfg.mtp`, 0.3 of the depth-1
multi-token-prediction loss (`mtp_loss`).  While autograd records,
`chunked_xent` checkpoints each sequence chunk (`torch.utils.checkpoint`),
so no (B, S, V) logits are held: a chunk's logits are made again in its
backward.  Under `cfg.remat` each layer of `forward` is checkpointed the
same way: "full" keeps only the layer's input, "dots" also its 2-D matmul
outputs (`aten.mm` / `aten.addmm`, the counterpart of the reference's
`dots_with_no_batch_dims_saveable`) and recomputes the rest, the attention
recurrence's batched products included.

Data parallel: with `dp` (a `dist.collectives.DataGroup`) `lm_loss` is
one rank's part of the loss of the global batch, whose blocks the group's
ranks hold: summed over the ranks, the parts and their gradients are the
global loss's.  `chunked_xent` divides by the all-reduced count of
targets >= 0 (MTP's last position and padding are not counted, so the
ranks' counts differ), and every MoE layer routes by the global batch's
expert ids (`moe.moe_ffn(dp=)`).  Without `dp` nothing changes.

Dtypes as in the reference: `rms_norm`, RoPE and attention compute in f32
and cast back to the activations' dtype; the projections run in the
weights' dtype (bf16 for the full configs); logits are f32.

The decode cache is written in place: `decode_step` writes the new token's
K/V (or MLA latents) into slot `pos % ring` of the cache it is given and
returns a cache over the same buffers with `pos + 1`.  The cache passed in
is consumed, as a buffer donated to `jax.jit` would be.  `pos` stays a 0-d
device tensor, so a decode step needs no host sync.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.attention import (
    apply_rope,
    decode_attention,
    flash_attention,
    mla_decode_attention,
)
from repro_torch.models.lm_config import LMConfig
from repro_torch.models.moe import _activation, moe_ffn

Params = Dict[str, Any]
# a leaf's spec: (shape, dtype, init), init "ones", "zeros" or a normal's std
Leaf = Tuple[Tuple[int, ...], torch.dtype, Union[str, float]]
# normal draws are made in f32 this many elements at a time and cast into
# the leaf, so that no full-width leaf needs its whole f32 copy at once
_DRAW_BLOCK = 1 << 26


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.to(torch.float32)).to(x.dtype)


# --------------------------------------------------------------------------
# parameter tree: specs, init, loading
# --------------------------------------------------------------------------

def _out_scale(cfg: LMConfig) -> float:
    return 0.02 / max(1.0, (2 * cfg.n_layers) ** 0.5)


def _attn_leaves(cfg: LMConfig) -> Dict[str, Leaf]:
    D, H, Hkv, dh, dt = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.dtype
    out_scale = _out_scale(cfg)
    p: Dict[str, Leaf] = {"ln1": ((D,), dt, "ones")}
    if cfg.mla is not None:
        m = cfg.mla
        p.update(
            w_dq=((D, m.q_lora_rank), dt, 0.02),
            q_norm=((m.q_lora_rank,), dt, "ones"),
            w_uq=((m.q_lora_rank, H * (m.d_nope + m.d_rope)), dt, 0.02),
            w_dkv=((D, m.kv_lora_rank + m.d_rope), dt, 0.02),
            kv_norm=((m.kv_lora_rank,), dt, "ones"),
            w_uk=((H, m.d_nope, m.kv_lora_rank), dt, 0.02),
            w_uv=((H, m.kv_lora_rank, m.d_v), dt, 0.02),
            wo=((H * m.d_v, D), dt, out_scale),
        )
        return p
    if cfg.fuse_qkv:
        p.update(wqkv=((D, (H + 2 * Hkv) * dh), dt, 0.02),
                 wo=((H * dh, D), dt, out_scale))
    else:
        p.update(wq=((D, H * dh), dt, 0.02), wk=((D, Hkv * dh), dt, 0.02),
                 wv=((D, Hkv * dh), dt, 0.02), wo=((H * dh, D), dt, out_scale))
    if cfg.qkv_bias:
        p.update(bq=((H * dh,), dt, "zeros"), bk=((Hkv * dh,), dt, "zeros"),
                 bv=((Hkv * dh,), dt, "zeros"))
    if cfg.qk_norm:
        p.update(q_normh=((dh,), dt, "ones"), k_normh=((dh,), dt, "ones"))
    return p


def _dense_ffn_leaves(cfg: LMConfig, d_ff: int) -> Dict[str, Leaf]:
    D, dt = cfg.d_model, cfg.dtype
    p: Dict[str, Leaf] = {"ln2": ((D,), dt, "ones"),
                          "w2": ((d_ff, D), dt, _out_scale(cfg))}
    if cfg.act == "swiglu" and cfg.fuse_gate:
        p["w13"] = ((D, 2 * d_ff), dt, 0.02)
    else:
        p["w1"] = ((D, d_ff), dt, 0.02)
        if cfg.act == "swiglu":
            p["w3"] = ((D, d_ff), dt, 0.02)
    return p


def _moe_ffn_leaves(cfg: LMConfig) -> Dict[str, Leaf]:
    D, e, dt = cfg.d_model, cfg.moe, cfg.dtype
    out_scale = _out_scale(cfg)
    p: Dict[str, Leaf] = {
        "ln2": ((D,), dt, "ones"),
        "router": ((D, e.n_experts), torch.float32, 0.02),   # always f32
        "we1": ((e.n_experts, D, e.d_expert), dt, 0.02),
        "we2": ((e.n_experts, e.d_expert, D), dt, out_scale),
    }
    if cfg.act == "swiglu":
        p["we3"] = ((e.n_experts, D, e.d_expert), dt, 0.02)
    if e.n_shared:
        d_sh = e.d_expert * e.n_shared
        p["ws1"] = ((D, d_sh), dt, 0.02)
        p["ws2"] = ((d_sh, D), dt, out_scale)
        if cfg.act == "swiglu":
            p["ws3"] = ((D, d_sh), dt, 0.02)
    return p


def _layer_leaves(cfg: LMConfig, is_moe: bool) -> Dict[str, Dict[str, Leaf]]:
    ffn = _moe_ffn_leaves(cfg) if is_moe else _dense_ffn_leaves(cfg, cfg.d_ff)
    return {"attn": _attn_leaves(cfg), "ffn": ffn}


def _tree_spec(cfg: LMConfig) -> Params:
    """The parameter tree as leaf specs; stacked leaves as (n, spec)."""
    D, dt = cfg.d_model, cfg.dtype
    n_moe = (cfg.n_layers - cfg.n_dense_layers) if cfg.moe else 0
    n_dense = cfg.n_layers - n_moe
    spec: Params = {"embed": ((cfg.vocab, D), dt, 0.02), "final_norm": ((D,), dt, "ones")}
    if not cfg.tie_embeddings:
        spec["head"] = ((D, cfg.vocab), dt, 0.02)
    if n_dense:
        spec["dense_layers"] = (n_dense, _layer_leaves(cfg, False))
    if n_moe:
        spec["moe_layers"] = (n_moe, _layer_leaves(cfg, True))
    if cfg.mtp:
        spec["mtp"] = {
            "proj": ((2 * D, D), dt, 0.02),
            "norm_h": ((D,), dt, "ones"),
            "norm_e": ((D,), dt, "ones"),
            "block": _layer_leaves(cfg, False),
        }
    return spec


def _walk(spec: Params, lead: Tuple[int, ...] = ()):
    """Yields (path, shape with the stack axis, dtype, init) in tree order."""
    for name, s in spec.items():
        if isinstance(s, dict):
            for path, shape, dt, init in _walk(s, lead):
                yield (name,) + path, shape, dt, init
        elif isinstance(s[1], dict):        # (n, layer spec): a stack of n layers
            n, layer = s
            for path, shape, dt, init in _walk(layer, lead + (n,)):
                yield (name,) + path, shape, dt, init
        else:
            shape, dt, init = s
            yield (name,), lead + tuple(shape), dt, init


def _set(tree: Params, path: Tuple[str, ...], value) -> None:
    for name in path[:-1]:
        tree = tree.setdefault(name, {})
    tree[path[-1]] = value


def _get(tree: Params, path: Tuple[str, ...]):
    for name in path:
        tree = tree[name]
    return tree


def param_shapes(cfg: LMConfig) -> Params:
    """The tree of (shape, dtype) that `init_lm` makes (no allocation)."""
    out: Params = {}
    for path, shape, dt, _ in _walk(_tree_spec(cfg)):
        _set(out, path, (shape, dt))
    return out


def _draw_into(gen: torch.Generator, out: torch.Tensor, std: float) -> None:
    flat = out.view(-1)
    for lo in range(0, flat.numel(), _DRAW_BLOCK):
        hi = min(lo + _DRAW_BLOCK, flat.numel())
        draw = torch.randn(hi - lo, generator=gen, device=out.device, dtype=torch.float32)
        flat[lo:hi] = draw.mul_(std)


def init_lm(gen: torch.Generator, cfg: LMConfig) -> Params:
    """Random weights on the generator's device: N(0, 0.02²) projections
    (output projections scaled by 1/sqrt(2·n_layers)), ones for the norms,
    zeros for the QKV biases, as the reference's `init_lm`.  Each layer of
    a stack is drawn into its slice of the stacked leaf, a block of
    `_DRAW_BLOCK` elements at a time."""
    dev = gen.device
    params: Params = {}
    normals = []
    for path, shape, dt, init in _walk(_tree_spec(cfg)):
        if init == "ones":
            leaf = torch.ones(shape, dtype=dt, device=dev)
        elif init == "zeros":
            leaf = torch.zeros(shape, dtype=dt, device=dev)
        else:
            leaf = torch.empty(shape, dtype=dt, device=dev)
            normals.append((path, leaf, init))
        _set(params, path, leaf)
    # leaves outside the stacks in tree order, then each stack layer by
    # layer, leaf by leaf within a layer
    stacks = {"dense_layers": [], "moe_layers": []}
    for path, leaf, std in normals:
        if path[0] in stacks:
            stacks[path[0]].append((leaf, std))
        else:
            _draw_into(gen, leaf, std)
    for group in stacks.values():
        for i in range(group[0][0].shape[0] if group else 0):
            for leaf, std in group:
                _draw_into(gen, leaf[i], std)
    return params


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes' bf16: carry the bits over
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def lm_params_from_numpy(tree: Params, cfg: LMConfig, device: DeviceLike = "cuda") -> Params:
    """The reference's `init_lm` tree, as numpy arrays (bf16 ones with the
    `ml_dtypes` dtype that `np.asarray` of a jax array gives), as the
    port's tree on `device`.  Every leaf's path, shape and dtype must be the
    ones `param_shapes(cfg)` names."""
    dev = resolve_device(device)
    params: Params = {}
    for path, shape, dt, _ in _walk(_tree_spec(cfg)):
        try:
            t = _to_tensor(_get(tree, path))
        except KeyError:
            raise KeyError(f"parameter {'/'.join(path)} missing") from None
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"parameter {'/'.join(path)}: {tuple(t.shape)} {t.dtype}, "
                             f"expected {shape} {dt}")
        _set(params, path, t.to(dev))
    return params


def _layer(stack: Params, i: int) -> Params:
    """Layer i of a stacked tree, as views."""
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i]) for k, v in stack.items()}


def _stack_len(stack: Params) -> int:
    return stack["attn"]["ln1"].shape[0]


def _layer_stacks(params: Params):
    for name, is_moe in (("dense_layers", False), ("moe_layers", True)):
        if name in params:
            yield params[name], is_moe


# --------------------------------------------------------------------------
# forward (prefill)
# --------------------------------------------------------------------------

def _qkv(p: Params, cfg: LMConfig, h: torch.Tensor):
    """The dense attention's q, k, v projections of normed h (..., D)."""
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    if cfg.fuse_qkv:
        q, k, v = torch.split(h @ p["wqkv"], [H * dh, Hkv * dh, Hkv * dh], dim=-1)
    else:
        q, k, v = h @ p["wq"], h @ p["wk"], h @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def _attn_forward(
    p: Params, cfg: LMConfig, x: torch.Tensor, positions: torch.Tensor
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (residual update, kv-tensors-for-prefill)."""
    B, S, D = x.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    h = rms_norm(x, p["ln1"])
    if cfg.mla is not None:
        m = cfg.mla
        cq = rms_norm(h @ p["w_dq"], p["q_norm"])
        q = (cq @ p["w_uq"]).reshape(B, S, H, m.d_nope + m.d_rope)
        q_nope, q_rope = q[..., : m.d_nope], q[..., m.d_nope:]
        dkv = h @ p["w_dkv"]
        ckv = rms_norm(dkv[..., : m.kv_lora_rank], p["kv_norm"])
        k_rope = dkv[..., m.kv_lora_rank:][:, :, None, :]        # (B,S,1,dr)
        q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
        k_rope = apply_rope(k_rope, positions, cfg.rope_theta)
        k_nope = torch.einsum("bsr,hdr->bshd", ckv, p["w_uk"])
        v = torch.einsum("bsr,hrv->bshv", ckv, p["w_uv"])
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        k_full = torch.cat([k_nope, k_rope.expand(B, S, H, m.d_rope)], dim=-1)
        o = flash_attention(
            q_full, k_full, v, causal=True, window=cfg.window, chunk=cfg.attn_chunk,
            scale=(m.d_nope + m.d_rope) ** -0.5,
        )
        kv = {"ckv": ckv, "krope": k_rope[:, :, 0, :]}
        return o.reshape(B, S, H * m.d_v) @ p["wo"], kv

    q, k, v = _qkv(p, cfg, h)
    q = q.reshape(B, S, H, dh)
    k = k.reshape(B, S, Hkv, dh)
    v = v.reshape(B, S, Hkv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_normh"])
        k = rms_norm(k, p["k_normh"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = flash_attention(q, k, v, causal=True, window=cfg.window, chunk=cfg.attn_chunk)
    return o.reshape(B, S, H * dh) @ p["wo"], {"k": k, "v": v}


def _dense_ffn(p: Params, cfg: LMConfig, h: torch.Tensor) -> torch.Tensor:
    """The dense FFN of normed h (..., D)."""
    if cfg.act == "swiglu" and cfg.fuse_gate:
        h1, h3 = torch.chunk(h @ p["w13"], 2, dim=-1)
    else:
        h1 = h @ p["w1"]
        h3 = h @ p["w3"] if cfg.act == "swiglu" else None
    return _activation(h1, h3, cfg.act) @ p["w2"]


def _ffn_forward(
    p: Params, cfg: LMConfig, x: torch.Tensor, is_moe: bool, dp=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (residual update, aux loss)."""
    B, S, D = x.shape
    h = rms_norm(x, p["ln2"])
    if is_moe:
        out, metrics = moe_ffn(p, h.reshape(B * S, D), cfg.moe, cfg.act, dp=dp)
        return out.reshape(B, S, D), metrics.aux_loss
    return _dense_ffn(p, cfg, h), torch.zeros((), dtype=torch.float32, device=x.device)


def _layer_forward(lp: Params, cfg: LMConfig, is_moe: bool, x: torch.Tensor,
                   positions: torch.Tensor, dp=None):
    """One layer: returns (x after the layer, its aux loss, its kv tensors)."""
    upd, kv = _attn_forward(lp["attn"], cfg, x, positions)
    x = x + upd
    upd, aux = _ffn_forward(lp["ffn"], cfg, x, is_moe, dp)
    return x + upd, aux, kv


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the 2-D matmuls' outputs (the projections), recompute the rest."""
    return CheckpointPolicy.MUST_SAVE if op in _MATMULS else CheckpointPolicy.PREFER_RECOMPUTE


def _checkpointed(policy: str, fn, *args):
    """fn(*args) under `torch.utils.checkpoint`, remat policy "full" or "dots"."""
    if policy == "dots":
        return checkpoint(fn, *args, use_reentrant=False, context_fn=functools.partial(
            create_selective_checkpoint_contexts, _dots_policy))
    if policy == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    raise ValueError(f"remat_policy {policy!r}: expected 'full' or 'dots'")


def _recording(*tensors: torch.Tensor) -> bool:
    """Autograd records ops on these tensors."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def forward(
    params: Params,
    cfg: LMConfig,
    tokens: torch.Tensor,                 # (B, S) int
    *,
    collect_kv: bool = False,
    dp=None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[list]]:
    """Returns (hidden (B,S,D), total aux loss, kv caches or None).  The kv
    caches are one dict per layer stack, each leaf (L_stack, B, S, ...).
    While autograd records (and no kv is collected), `cfg.remat`
    checkpoints each layer.  `dp`: this rank's block of a data-parallel
    batch (the MoE layers route by the global batch)."""
    B, S = tokens.shape
    x = params["embed"][tokens.long()]
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    kvs = []
    remat = cfg.remat and not collect_kv and _recording(x)
    for stack, is_moe in _layer_stacks(params):
        layer_kvs = []
        for i in range(_stack_len(stack)):
            lp = _layer(stack, i)
            if remat:
                x, aux, kv = _checkpointed(cfg.remat_policy, _layer_forward, lp, cfg, is_moe,
                                           x, positions, dp)
            else:
                x, aux, kv = _layer_forward(lp, cfg, is_moe, x, positions, dp)
            aux_total = aux_total + aux
            if collect_kv:
                layer_kvs.append(kv)
        if collect_kv:
            kvs.append({k: torch.stack([kv[k] for kv in layer_kvs]) for k in layer_kvs[0]})
    h = rms_norm(x, params["final_norm"])
    return h, aux_total, (kvs if collect_kv else None)


def _head_weight(params: Params) -> torch.Tensor:
    return params["head"] if "head" in params else params["embed"].T


# --------------------------------------------------------------------------
# loss (chunked fused cross-entropy — never materialise (B,S,V))
# --------------------------------------------------------------------------

def _xent_chunk(hx: torch.Tensor, head: torch.Tensor, tx: torch.Tensor) -> torch.Tensor:
    """Σ of the chunk's token NLLs over targets >= 0, in f32."""
    logits = (hx @ head).to(torch.float32)                  # (B, chunk, V)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, tx.clamp_min(0)[..., None])[..., 0]
    return torch.where(tx >= 0, lse - tgt, 0.0).sum()


def chunked_xent(
    h: torch.Tensor,            # (B, S, D)
    head: torch.Tensor,         # (D, V)
    targets: torch.Tensor,      # (B, S) int; -1 = ignore
    chunk: int,
    dp=None,
) -> torch.Tensor:
    """Mean next-token NLL over the targets >= 0, a sequence chunk at a
    time; a ragged S (MTP's S - 1) is padded with ignored targets.  While
    autograd records, each chunk is checkpointed: its (B, chunk, V)
    logits are freed after the forward and made again in the backward.
    With `dp` the sum over this rank's block divided by the count over
    every rank's."""
    B, S, D = h.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad), value=-1)
        S += pad
    remat = _recording(h, head)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for j in range(S // chunk):
        hx, tx = h[:, j * chunk:(j + 1) * chunk], targets[:, j * chunk:(j + 1) * chunk]
        if remat:
            tot = tot + checkpoint(_xent_chunk, hx, head, tx, use_reentrant=False)
        else:
            tot = tot + _xent_chunk(hx, head, tx)
    cnt = (targets >= 0).sum()
    if dp is not None:
        cnt = dp.all_reduce(cnt)
    return tot / torch.clamp_min(cnt, 1)


def mtp_loss(params: Params, cfg: LMConfig, h: torch.Tensor, tokens: torch.Tensor,
             dp=None) -> torch.Tensor:
    """DeepSeek-V3 multi-token prediction (depth 1): position t predicts t+2."""
    p = params["mtp"]
    B, S, D = h.shape
    e_next = params["embed"][tokens[:, 1:].long()]          # (B, S-1, D)
    m = torch.cat([rms_norm(h[:, :-1], p["norm_h"]), rms_norm(e_next, p["norm_e"])],
                  dim=-1) @ p["proj"]                       # (B, S-1, D)
    positions = torch.arange(S - 1, dtype=torch.int32, device=h.device).expand(B, S - 1)
    m, _, _ = _layer_forward(p["block"], cfg, False, m, positions)
    m = rms_norm(m, params["final_norm"])
    # position i of m sees tokens <= i and the embedding of token i+1: it
    # predicts token i+2
    targets = F.pad(tokens[:, 2:], (0, 1), value=-1)        # (B, S-1)
    return chunked_xent(m, _head_weight(params), targets, cfg.loss_chunk, dp)


def lm_loss(
    params: Params, cfg: LMConfig, tokens: torch.Tensor, targets: torch.Tensor,
    *, aux_weight: float = 0.01, mtp_weight: float = 0.3, dp=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total loss, {"xent", "aux"[, "mtp"]}), as the reference's; with `dp`
    this rank's part of each (their sums over the ranks are the global
    batch's)."""
    h, aux, _ = forward(params, cfg, tokens, dp=dp)
    loss = chunked_xent(h, _head_weight(params), targets, cfg.loss_chunk, dp)
    metrics = {"xent": loss, "aux": aux}
    total = loss + aux_weight * aux
    if cfg.mtp:
        lm = mtp_loss(params, cfg, h, tokens, dp)
        metrics["mtp"] = lm
        total = total + mtp_weight * lm
    return total, metrics


# --------------------------------------------------------------------------
# decode (serve_step) — one token against a cache
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DecodeCache:
    """Per-layer stacked KV cache.  GQA: k/v (L,B,C,Hkv,dh); MLA: ckv
    (L,B,C,r) + krope (L,B,C,dr).  `pos` is the absolute decode position, a
    0-d int32 tensor on the cache's device; windowed archs use a ring
    buffer of C = min(window, max_len) slots."""
    data: Dict[str, torch.Tensor]
    pos: torch.Tensor
    length: int                 # ring size

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.data.values())


def init_decode_cache(
    cfg: LMConfig, batch: int, max_len: int, device: DeviceLike = "cuda"
) -> DecodeCache:
    dev = resolve_device(device)
    C = min(cfg.window, max_len) if cfg.window else max_len
    L = cfg.n_layers
    if cfg.mla is not None:
        m = cfg.mla
        shapes = {"ckv": (L, batch, C, m.kv_lora_rank), "krope": (L, batch, C, m.d_rope)}
    else:
        kv = (L, batch, C, cfg.n_kv_heads, cfg.d_head)
        shapes = {"k": kv, "v": kv}
    data = {k: torch.zeros(s, dtype=cfg.dtype, device=dev) for k, s in shapes.items()}
    return DecodeCache(data=data, pos=torch.zeros((), dtype=torch.int32, device=dev),
                       length=C)


def _decode_attn(
    p: Params, cfg: LMConfig, x: torch.Tensor, cache_l: Dict[str, torch.Tensor],
    pos: torch.Tensor, ring: int,
) -> torch.Tensor:
    """x: (B, D) single token.  Writes the token's cache entries into slot
    `pos % ring` of `cache_l` (views of one layer's cache) and returns the
    residual update."""
    B, D = x.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    h = rms_norm(x, p["ln1"])
    idx = (pos % ring).long().view(1)      # ring slot for this absolute position
    pos1 = pos.view(1)                     # (1,) — rope positions for new token
    # valid slots: everything already written, including the one written now
    valid = (torch.arange(ring, device=x.device) <= torch.clamp(pos, max=ring - 1)
             ).expand(B, ring)

    if cfg.mla is not None:
        m = cfg.mla
        cq = rms_norm(h @ p["w_dq"], p["q_norm"])
        q = (cq @ p["w_uq"]).reshape(B, H, m.d_nope + m.d_rope)
        q_nope, q_rope = q[..., : m.d_nope], q[..., m.d_nope:]
        dkv = h @ p["w_dkv"]
        ckv = rms_norm(dkv[..., : m.kv_lora_rank], p["kv_norm"])
        k_rope = dkv[..., m.kv_lora_rank:]
        q_rope = apply_rope(q_rope[:, None], pos1[None, :], cfg.rope_theta)[:, 0]
        k_rope = apply_rope(k_rope[:, None, None, :], pos1[None, :], cfg.rope_theta)[:, 0, 0]
        ckv_c, kr_c = cache_l["ckv"], cache_l["krope"]
        ckv_c.index_copy_(1, idx, ckv[:, None].to(ckv_c.dtype))
        kr_c.index_copy_(1, idx, k_rope[:, None].to(kr_c.dtype))
        o = mla_decode_attention(
            q_nope, q_rope, ckv_c, kr_c, valid, p["w_uk"], p["w_uv"],
            scale=(m.d_nope + m.d_rope) ** -0.5,
        )
        return o.reshape(B, H * m.d_v) @ p["wo"]

    q, k, v = _qkv(p, cfg, h)
    q = q.reshape(B, H, dh)
    k = k.reshape(B, Hkv, dh)
    v = v.reshape(B, Hkv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_normh"])
        k = rms_norm(k, p["k_normh"])
    q = apply_rope(q[:, None], pos1[None, :], cfg.rope_theta)[:, 0]
    k = apply_rope(k[:, None], pos1[None, :], cfg.rope_theta)[:, 0]
    k_c, v_c = cache_l["k"], cache_l["v"]
    k_c.index_copy_(1, idx, k[:, None].to(k_c.dtype))
    v_c.index_copy_(1, idx, v[:, None].to(v_c.dtype))
    o = decode_attention(q, k_c, v_c, valid)
    return o.reshape(B, H * dh) @ p["wo"]


def decode_step(
    params: Params, cfg: LMConfig, cache: DecodeCache, tokens: torch.Tensor
) -> Tuple[torch.Tensor, DecodeCache]:
    """One decode step: tokens (B,) -> (logits (B,V) f32, the cache at
    pos + 1).  Consumes `cache`: its buffers are written in place."""
    x = params["embed"][tokens.long()]
    pos = cache.pos
    off = 0
    for stack, is_moe in _layer_stacks(params):
        n = _stack_len(stack)
        for i in range(n):
            lp = _layer(stack, i)
            cache_l = {k: v[off + i] for k, v in cache.data.items()}
            x = x + _decode_attn(lp["attn"], cfg, x, cache_l, pos, cache.length)
            h = rms_norm(x, lp["ffn"]["ln2"])
            if is_moe:
                out, _ = moe_ffn(lp["ffn"], h, cfg.moe, cfg.act)
            else:
                out = _dense_ffn(lp["ffn"], cfg, h)
            x = x + out
        off += n
    h = rms_norm(x, params["final_norm"])
    logits = (h @ _head_weight(params)).to(torch.float32)
    return logits, DecodeCache(data=cache.data, pos=pos + 1, length=cache.length)


def prefill(
    params: Params, cfg: LMConfig, tokens: torch.Tensor, max_len: int
) -> Tuple[torch.Tensor, DecodeCache]:
    """Prefill S tokens, build the decode cache on the tokens' device.
    Returns (last logits (B,V) f32, cache)."""
    B, S = tokens.shape
    h, _, kvs = forward(params, cfg, tokens, collect_kv=True)
    cache = init_decode_cache(cfg, B, max_len, device=tokens.device)
    C = cache.length
    take = min(S, C)
    # ring slot for absolute position p is p % C — keep prefill and decode
    # consistent so the first decode step (pos=S) lands in slot S % C.
    slots = torch.arange(S - take, S, device=tokens.device) % C
    off = 0
    for kv in kvs:
        n = next(iter(kv.values())).shape[0]
        for k_name, buf in cache.data.items():
            buf[off:off + n].index_copy_(2, slots, kv[k_name][:, :, S - take:].to(buf.dtype))
        off += n
    logits = (h[:, -1] @ _head_weight(params)).to(torch.float32)
    return logits, DecodeCache(
        data=cache.data, pos=torch.full((), S, dtype=torch.int32, device=tokens.device),
        length=C)
