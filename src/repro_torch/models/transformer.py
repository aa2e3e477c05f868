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

Tensor parallel: with `tp` (a `dist.collectives.ModelGroup`, the mesh's
'model' ranks) `params` are this rank's blocks as
`dist.sharding.lm_param_specs` places them, and every function computes
the one-device function, the same on every model rank.  Each block splits
as the placement does: attention on H/m query and Hkv/m KV heads
(column-parallel q/k/v and biases, row-parallel `wo`), or, where the KV
heads do not split, on H/m query heads and the KV heads they read
(`_kv_reads`: wk / wv gathered whole, each rank reading other columns, so
their gradients are summed; a prefill computes every KV head, since the
cache holds them all, as the reference's `cache_specs` places it); the
FFN on d_ff/m hidden units, MoE on E/m experts (`moe.moe_ffn(tp=)`), the
embedding vocab-parallel (each rank looks up its rows, zeros elsewhere,
summed) and the head and `chunked_xent` vocab-parallel (the log-sum-exp
combines the ranks' maxes and sums of exponentials; no rank makes more
than its block of the logits).  Where the reference's layout splits a dim
that replicated code reads whole, it is gathered: MLA's latent cq before
`q_norm`, MTP's projected input before its block, a fused projection's
output (`wqkv`, `w13`: a rank's block does not follow the q / k / v or
gate / up boundary), and the serving logits.  Where a head count or d_ff
does not split (or the query heads' grouping does not follow the ranks'
blocks), the block's split leaves are gathered whole and it runs whole
(`_whole`).

The residual stream between the layers is sequence-parallel wherever the
reference's `_make_layer_fn` holds its carry as P(dp, "model", None):
under `tp`, where S % 8 == 0 and S splits over the ranks (`_seq`;
Megatron's sequence parallelism).  The carry, which remat keeps, is then
this rank's block of S, (B, S/m, D).  A layer norms its block (the norm
weights entering through `copy` in f32: each rank's gradient is its
part), all-gathers the normed activations along S (`gather_sum`, whose
backward reduce-scatters), runs the block as above and reduce-scatters
its partial output along S (`scatter_sum`), where the whole stream took
`copy` in and `sum` out (`_Block` says which ops each block takes); the
embedding's vocab-parallel sum is a reduce-scatter, the final norm runs
on the block, and h is gathered whole before the head.  Decode (S = 1)
and the MTP block (S - 1 tokens; the reference constrains only the layer
scan) keep the stream whole.  Without `tp` the same ops run with no
collective, so on a one-rank group the function is the same bits.  FSDP
(`fsdp=`, `configs.lm_cells.LayerGather`) gathers each layer's leaves
over the batch ranks inside the layer's (checkpointed) call, again at its
recompute.

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

from repro_torch.core import prng
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


# each normal leaf's index in its block's key split, and the split's size
# (the reference's `_init_attn`, `_init_dense_ffn`, `_init_moe_ffn`)
_ATTN_KEYS = {"wqkv": 0, "wq": 0, "wk": 1, "wv": 2, "wo": 3}
_MLA_KEYS = {"w_dq": 0, "w_uq": 1, "w_dkv": 2, "w_uk": 3, "w_uv": 4, "wo": 5}
_DENSE_FFN_KEYS = {"w1": 0, "w13": 0, "w2": 1, "w3": 2}
_MOE_FFN_KEYS = {"router": 0, "we1": 1, "we2": 2, "we3": 3, "ws1": 4, "ws2": 5, "ws3": 6}


def _leaf_key(cfg: LMConfig, layer: prng.Key, block: str, name: str, is_moe: bool) -> prng.Key:
    """The key of leaf `name` of a layer's `block` ("attn" or "ffn") under
    the layer's key: `ka, kf = split(k)`, then `split(ka, 12)`,
    `split(kf, 3)` (dense) or `split(kf, 8)` (MoE) at the leaf's index."""
    ka, kf = prng.split(layer)
    if block == "attn":
        index = (_MLA_KEYS if cfg.mla is not None else _ATTN_KEYS)[name]
        return prng.split(ka, 12)[index]
    if is_moe:
        return prng.split(kf, 8)[_MOE_FFN_KEYS[name]]
    return prng.split(kf, 3)[_DENSE_FFN_KEYS[name]]


def init_lm(key: prng.Key, cfg: LMConfig, *, device: DeviceLike = "cuda") -> Params:
    """Random weights on `device` as the reference's `init_lm(key, cfg)`
    draws them: N(0, 0.02²) projections (output projections scaled by
    1/sqrt(2·n_layers)), ones for the norms, zeros for the QKV biases.
    Every normal leaf is drawn under the reference's key for it:
    `split(key, n_layers + 4)` gives `embed` key 0, `head` key 1, layer
    i (dense layers first, then MoE) key 2 + i and MTP the last, split in
    3 (`proj` under 0, `block` under 1); a layer's leaves follow
    `_leaf_key`.  Each leaf, and each layer of a stacked leaf, is drawn
    in f32 blocks of `prng.FILL_BLOCK` elements and cast (`normal_into`),
    as the reference's `_dense` computes it.  On "meta" nothing is drawn."""
    dev = resolve_device(device)
    n_moe = (cfg.n_layers - cfg.n_dense_layers) if cfg.moe else 0
    keys = prng.split(key, cfg.n_layers + 4)
    mtp = prng.split(keys[-1], 3)
    layer_keys = {"dense_layers": keys[2:2 + cfg.n_layers - n_moe],
                  "moe_layers": keys[2 + cfg.n_layers - n_moe:2 + cfg.n_layers],
                  "mtp": [mtp[1]]}
    top = {("embed",): keys[0], ("head",): keys[1], ("mtp", "proj"): mtp[0]}
    params: Params = {}
    for path, shape, dt, init in _walk(_tree_spec(cfg)):
        if init == "ones":
            leaf = torch.ones(shape, dtype=dt, device=dev)
        elif init == "zeros":
            leaf = torch.zeros(shape, dtype=dt, device=dev)
        else:
            leaf = torch.empty(shape, dtype=dt, device=dev)
            if path in top:
                prng.normal_into(top[path], leaf, init)
            elif path[0] == "mtp":              # ("mtp", "block", block, name)
                prng.normal_into(_leaf_key(cfg, layer_keys["mtp"][0], path[2], path[3], False),
                                 leaf, init)
            else:                               # (stack, block, name), layer i at leaf[i]
                for i, lk in enumerate(layer_keys[path[0]]):
                    prng.normal_into(_leaf_key(cfg, lk, path[1], path[2],
                                               path[0] == "moe_layers"), leaf[i], init)
        _set(params, path, leaf)
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


def _layer_stacks(params: Params, cfg: LMConfig):
    """(name, stack, its number of layers, is_moe) of each layer stack."""
    n_moe = (cfg.n_layers - cfg.n_dense_layers) if cfg.moe else 0
    for name, n, is_moe in (("dense_layers", cfg.n_layers - n_moe, False),
                            ("moe_layers", n_moe, True)):
        if name in params:
            yield name, params[name], n, is_moe


def _layer_at(stack: Params, name: str, i: int, fsdp=None) -> Params:
    """Layer i of stack `name`: views, or with `fsdp` its leaves gathered
    over the batch ranks."""
    return _layer(stack, i) if fsdp is None else fsdp.layer(name, stack, i)


# --------------------------------------------------------------------------
# tensor parallelism: which blocks split over the model ranks
# --------------------------------------------------------------------------

# the replicated leaves `rms_norm` reads: under sequence parallelism they
# enter through `copy` in f32, so that each rank's part of their gradient
# is not rounded to the leaf's dtype before the sum
_NORMS = ("ln1", "ln2", "q_normh", "k_normh", "q_norm", "kv_norm", "final_norm")


def _split(tp, n: int) -> bool:
    """A dim of n entries splits over `tp`'s ranks (`ModelGroup.splits`)."""
    return tp is not None and tp.splits(n)


def _seq(tp, S: int) -> bool:
    """Whether a step's layers hold the residual stream sequence-parallel
    over `tp`: the reference's rule (`_make_layer_fn`: S % 8 == 0 under a
    mesh), where S splits over the model ranks."""
    return tp is not None and S % 8 == 0 and tp.splits(S)


def _norm(w: torch.Tensor, tp, seq: bool) -> torch.Tensor:
    """A replicated norm weight read on this rank's block of S (`seq`): its
    gradient is this rank's part, summed by `copy` in f32."""
    return tp.copy(w.to(torch.float32)) if seq else w


@dataclasses.dataclass(frozen=True)
class _Block:
    """Where one block's work (an attention or an FFN) lies on the model
    ranks `tp` (None: no 'model' group): `split`, its heads or hidden
    units split over them, each rank computing its part, else it runs
    whole on every rank; `seq`, the layer is sequence-parallel.

    Without `seq` the block takes the whole residual stream and computes
    the same on every rank; where it splits, the normed input enters this
    rank's part through `copy` (`act`) and the partial outputs leave
    through `sum` (`leave`).  With `seq` its input, this rank's block of S
    normed, is all-gathered with `gather_sum` (`enter`): each rank's
    gradient of it is then its part, so nothing inside is copied, a
    replicated leaf read by code computed the same on every rank enters
    through `copy` (`leaf`) and the output leaves as this rank's block of
    S: the partial sums reduce-scattered, a whole block's output cut."""
    tp: Any = None
    split: bool = False
    seq: bool = False

    @property
    def ranks(self):
        """The group the block's work splits over, or None."""
        return self.tp if self.split else None

    def enter(self, h: torch.Tensor) -> torch.Tensor:
        return self.tp.gather_sum(h, 1) if self.seq else h

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """x, computed the same on every rank, into this rank's part."""
        return self.tp.copy(x) if self.split and not self.seq else x

    def leaf(self, w: torch.Tensor, own: bool = False) -> torch.Tensor:
        """A replicated leaf of a split block, read by this rank's part
        (`own`) or by code computed the same on every rank; a whole
        block's leaves were taken by `_whole`."""
        return self.tp.copy(w) if self.split and (own or self.seq) else w

    def gather(self, y: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of y along `dim` (its columns of a split
        projection's output) whole, for code computed the same on every
        rank."""
        return self.tp.gather_sum(y, dim) if self.seq else self.tp.gather(y, dim)

    def fused(self, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """h @ w for a fused projection, whole on every rank: each rank's
        block of the output columns is all-gathered; the ranks then take
        pieces that do not follow the blocks, so the gradient is summed
        over them and each takes its block of the sum (`gather_sum`)."""
        return self.tp.gather_sum(self.act(h) @ w, -1) if self.split else h @ w

    def norm(self, w: torch.Tensor) -> torch.Tensor:
        """A replicated norm weight of a split block read by code computed
        the same on every rank (`leaf`, in f32 as `_norm`)."""
        return self.leaf(w.to(torch.float32)) if self.split and self.seq else w

    def leave(self, y: torch.Tensor) -> torch.Tensor:
        """The block's output (B, S, D): partial sums where it splits."""
        if self.split:
            return self.tp.scatter_sum(y, 1) if self.seq else self.tp.sum(y)
        return self.tp.block(y, 1) if self.seq else y


def _whole(p: Params, shapes: Dict[str, Leaf], tp, seq: bool) -> Params:
    """The leaves of a block that `tp`'s placement rule split, gathered
    whole (`dist.sharding._TP_FROM_END`): for a block whose heads or
    hidden units do not divide over the ranks, which then runs whole, the
    same on every rank.  With `seq` each rank computes a part of every
    leaf's gradient: the split leaves are gathered with `gather_sum` and
    the replicated ones (but the layer norms, read outside the block)
    enter through `copy`."""
    from repro_torch.dist.sharding import _TP_FROM_END

    out = dict(p)
    for name, (shape, _, _) in shapes.items():
        if name not in p or name in ("ln1", "ln2"):
            continue
        dim = _TP_FROM_END.get(name)
        if dim is not None and tp.splits(shape[len(shape) - dim]):
            gather = tp.gather_sum if seq else tp.gather
            out[name] = gather(p[name], p[name].ndim - dim)
        elif seq:
            out[name] = tp.copy(p[name].to(torch.float32) if name in _NORMS else p[name])
    return out


def _kv_reads(cfg: LMConfig, tp) -> Optional[Tuple[int, int]]:
    """(first, count) of the KV heads this rank's query heads read, where
    the query heads split over `tp` and the KV heads do not
    (`lm_param_specs` splits wq and wo by heads whatever Hkv is): local
    query head j is global head r·H/m + j and reads KV head
    (r·H/m + j) // (H/Hkv).  None where the grouping does not follow the
    ranks' blocks (H/m and H/Hkv neither divides the other) or a fused
    projection's columns do not split."""
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    if not tp.splits(H) or (cfg.fuse_qkv and not tp.splits((H + 2 * Hkv) * dh)):
        return None
    per, G = H // tp.size, H // Hkv
    if G % per and per % G:
        return None
    return tp.rank * per // G, max(1, per // G)


def _attn_tp(p: Params, cfg: LMConfig, tp, seq: bool = False):
    """(leaves, _Block, KV heads read) of one attention block.  Where every
    head count splits over `tp` each rank holds H/m query and Hkv/m KV
    heads (reads None).  Where only the query heads split, each rank
    computes its H/m (column-parallel `wq`, row-parallel `wo`) and the KV
    heads they read (`_kv_reads`) off `wk` / `wv` (and their biases)
    gathered whole with `gather_sum`, or copied where the placement left
    them whole: each rank reads other columns, so their gradients are
    summed.  Else the cut leaves gathered whole and the block runs whole."""
    if tp is None:
        return p, _Block(), None
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    if tp.splits(H) and (cfg.mla is not None or tp.splits(Hkv)):
        return p, _Block(tp, True, seq), None
    reads = None if cfg.mla is not None else _kv_reads(cfg, tp)
    if reads is None:
        return _whole(p, _attn_leaves(cfg), tp, seq), _Block(tp, False, seq), None
    p = dict(p)
    for name in ("wk", "wv", "bk", "bv"):
        if name in p:
            p[name] = tp.gather_sum(p[name], -1) if tp.splits(Hkv * cfg.d_head) else \
                tp.copy(p[name])
    return p, _Block(tp, True, seq), reads


def _ffn_tp(p: Params, cfg: LMConfig, tp, seq: bool = False):
    """(leaves, _Block) of one dense FFN: split where d_ff splits; else whole."""
    if tp is None:
        return p, _Block()
    if tp.splits(cfg.d_ff):
        return p, _Block(tp, True, seq)
    return _whole(p, _dense_ffn_leaves(cfg, cfg.d_ff), tp, seq), _Block(tp, False, seq)


def _blocks(y: torch.Tensor, sizes, tp) -> list:
    """Block r of m (tp's rank and size; 0 of 1 without) of each of the
    consecutive pieces of y's last dim of global `sizes`: a fused
    projection's q, k, v (or gate and up) for this rank's heads."""
    r, m = (tp.rank, tp.size) if tp is not None else (0, 1)
    out, lo = [], 0
    for n in sizes:
        out.append(y[..., lo + r * n // m: lo + (r + 1) * n // m])
        lo += n
    return out


def _embed(params: Params, cfg: LMConfig, tokens: torch.Tensor, tp=None,
           seq: bool = False) -> torch.Tensor:
    """The embedding rows of `tokens`; vocab-parallel where the vocab splits:
    each rank looks up the tokens its rows hold, zeros elsewhere, summed
    (with `seq` reduce-scattered: this rank's block of S).  With `seq` and
    a vocab that does not split, the rows of this rank's block of the
    tokens, the table entering through `copy`."""
    table = params["embed"]
    if tp is None or not tp.splits(cfg.vocab):
        if seq:
            return tp.copy(table)[tp.block(tokens, 1).long()]
        return table[tokens.long()]
    V_r = table.shape[0]
    idx = tokens.long() - tp.rank * V_r
    own = (idx >= 0) & (idx < V_r)
    rows = torch.where(own[..., None], table[idx.clamp(0, V_r - 1)], 0)
    return tp.scatter_sum(rows, 1) if seq else tp.sum(rows)


def _vocab_tp(cfg: LMConfig, tp):
    """`tp` where the head's vocab columns split over it, else None."""
    return tp if _split(tp, cfg.vocab) else None


def _logits(h: torch.Tensor, head: torch.Tensor, cfg: LMConfig, tp) -> torch.Tensor:
    """f32 logits of h, whole over the vocab on every rank."""
    logits = (h @ head).to(torch.float32)
    return logits if _vocab_tp(cfg, tp) is None else tp.gather(logits, -1)


# --------------------------------------------------------------------------
# forward (prefill)
# --------------------------------------------------------------------------

def _qkv(p: Params, cfg: LMConfig, h: torch.Tensor, blk: _Block,
         kv: Optional[Tuple[int, int]] = None):
    """The dense attention's q, k, v projections of normed h (..., D), for
    this rank's heads where `blk` splits (column-parallel); `kv` (first,
    count): the KV heads to compute out of all Hkv, whose leaves
    `_attn_tp` gathered whole."""
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    kv_cols = None if kv is None else slice(kv[0] * dh, (kv[0] + kv[1]) * dh)
    if cfg.fuse_qkv:
        y = blk.fused(h, p["wqkv"])
        if kv_cols is None:
            q, k, v = _blocks(y, [H * dh, Hkv * dh, Hkv * dh], blk.ranks)
        else:
            q = _blocks(y[..., :H * dh], [H * dh], blk.ranks)[0]
            k, v = y[..., H * dh:][..., kv_cols], y[..., (H + Hkv) * dh:][..., kv_cols]
        bk, bv = p.get("bk"), p.get("bv")
    else:
        h = blk.act(h)
        wk, wv = p["wk"], p["wv"]
        bk, bv = p.get("bk"), p.get("bv")
        if kv_cols is not None:
            wk, wv = wk[:, kv_cols], wv[:, kv_cols]
        q, k, v = h @ p["wq"], h @ wk, h @ wv
    if cfg.qkv_bias:
        if kv_cols is not None:
            bk, bv = bk[kv_cols], bv[kv_cols]
        q, k, v = q + p["bq"], k + bk, v + bv
    return q, k, v


def _mla_q(p: Params, cfg: LMConfig, h: torch.Tensor, blk: _Block) -> torch.Tensor:
    """MLA's queries (..., H_local · (d_nope + d_rope)).  Where `w_dq`'s
    columns split each rank's block of the latent cq is gathered whole
    before `q_norm`, which normalises over all of it; `w_uq` is
    column-parallel on the whole cq."""
    m = cfg.mla
    if blk.split and blk.tp.splits(m.q_lora_rank):
        cq = blk.gather(blk.act(h) @ p["w_dq"], -1)
    else:
        cq = h @ blk.leaf(p["w_dq"])
    cq = rms_norm(cq, blk.norm(p["q_norm"]))
    return blk.act(cq) @ p["w_uq"]


def _qk_norm(p: Params, q: torch.Tensor, k: torch.Tensor, blk: _Block):
    """qk-norm of this rank's heads.  The norms' weights are replicated but
    each rank's heads reach only its part of their gradient: they enter
    through `copy`, which sums it over the ranks, in f32 (`rms_norm`
    computes in f32 anyway), so that the parts, which cancel, are not each
    rounded to the weights' bf16 before the sum."""
    qn, kn = p["q_normh"], p["k_normh"]
    if blk.split:
        qn = blk.leaf(qn.to(torch.float32), own=True)
        kn = blk.leaf(kn.to(torch.float32), own=True)
    return rms_norm(q, qn), rms_norm(k, kn)


def _attn_forward(
    p: Params, cfg: LMConfig, x: torch.Tensor, positions: torch.Tensor, tp=None,
    seq: bool = False, all_kv: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (residual update, kv-tensors-for-prefill).  Under `tp` the
    rank's heads (replicated `w_dkv`, `kv_norm` and MLA's latents, which
    enter the per-head products through `copy`), the update summed; with
    `seq` x is this rank's block of S (`_Block`).  Where only the query
    heads split, each rank computes the KV heads they read, or all of them
    with `all_kv` (the kv tensors fill a cache that holds every KV head)."""
    B = x.shape[0]
    p, blk, reads = _attn_tp(p, cfg, tp, seq)
    h = blk.enter(rms_norm(x, _norm(p["ln1"], tp, seq)))
    S = h.shape[1]
    H = cfg.n_heads // (blk.tp.size if blk.split else 1)
    dh = cfg.d_head
    if cfg.mla is not None:
        m = cfg.mla
        q = _mla_q(p, cfg, h, blk).reshape(B, S, H, m.d_nope + m.d_rope)
        q_nope, q_rope = q[..., : m.d_nope], q[..., m.d_nope:]
        dkv = h @ blk.leaf(p["w_dkv"])
        ckv = rms_norm(dkv[..., : m.kv_lora_rank], blk.norm(p["kv_norm"]))
        k_rope = dkv[..., m.kv_lora_rank:][:, :, None, :]        # (B,S,1,dr)
        q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
        k_rope = apply_rope(k_rope, positions, cfg.rope_theta)
        ckv_h, k_rope_h = blk.act(ckv), blk.act(k_rope)
        k_nope = torch.einsum("bsr,hdr->bshd", ckv_h, p["w_uk"])
        v = torch.einsum("bsr,hrv->bshv", ckv_h, p["w_uv"])
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        k_full = torch.cat([k_nope, k_rope_h.expand(B, S, H, m.d_rope)], dim=-1)
        o = flash_attention(
            q_full, k_full, v, causal=True, window=cfg.window, chunk=cfg.attn_chunk,
            scale=(m.d_nope + m.d_rope) ** -0.5,
        )
        kv = {"ckv": ckv, "krope": k_rope[:, :, 0, :]}
        return blk.leave(o.reshape(B, S, H * m.d_v) @ p["wo"]), kv

    computes = None if reads is None else ((0, cfg.n_kv_heads) if all_kv else reads)
    q, k, v = _qkv(p, cfg, h, blk, computes)
    q = q.reshape(B, S, H, dh)
    k = k.reshape(B, S, -1, dh)
    v = v.reshape(B, S, -1, dh)
    if cfg.qk_norm:
        q, k = _qk_norm(p, q, k, blk)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    kv = {"k": k, "v": v}
    if computes is not None and computes != reads:
        k, v = k[:, :, reads[0]:reads[0] + reads[1]], v[:, :, reads[0]:reads[0] + reads[1]]
    o = flash_attention(q, k, v, causal=True, window=cfg.window, chunk=cfg.attn_chunk)
    return blk.leave(o.reshape(B, S, H * dh) @ p["wo"]), kv


def _dense_ffn(p: Params, cfg: LMConfig, h: torch.Tensor, tp=None,
               seq: bool = False) -> torch.Tensor:
    """The dense FFN of normed h (..., D); under `tp` column-parallel
    `w1` / `w3` (`w13`: the rank's gate and up blocks) and row-parallel
    `w2`, summed; with `seq` h is this rank's block of S (`_Block`)."""
    p, blk = _ffn_tp(p, cfg, tp, seq)
    h = blk.enter(h)
    if cfg.act == "swiglu" and cfg.fuse_gate:
        h1, h3 = _blocks(blk.fused(h, p["w13"]), [cfg.d_ff, cfg.d_ff], blk.ranks)
    else:
        h = blk.act(h)
        h1 = h @ p["w1"]
        h3 = h @ p["w3"] if cfg.act == "swiglu" else None
    return blk.leave(_activation(h1, h3, cfg.act) @ p["w2"])


def _ffn_forward(
    p: Params, cfg: LMConfig, x: torch.Tensor, is_moe: bool, dp=None, tp=None,
    seq: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (residual update, aux loss); with `seq` x and the update are
    this rank's block of S."""
    B, S, D = x.shape
    h = rms_norm(x, _norm(p["ln2"], tp, seq))
    if is_moe:
        if seq:
            h = tp.gather_sum(h, 1)
        out, metrics = moe_ffn(p, h.reshape(-1, D), cfg.moe, cfg.act, dp=dp, tp=tp,
                               seq=h.shape[:2] if seq else None)
        return out.reshape(B, S, D), metrics.aux_loss
    return (_dense_ffn(p, cfg, h, tp, seq),
            torch.zeros((), dtype=torch.float32, device=x.device))


def _layer_forward(lp: Params, cfg: LMConfig, is_moe: bool, x: torch.Tensor,
                   positions: torch.Tensor, dp=None, tp=None, seq: bool = False,
                   all_kv: bool = False):
    """One layer: returns (x after the layer, its aux loss, its kv tensors).
    With `seq` x is this rank's block of S, as the layer's output."""
    upd, kv = _attn_forward(lp["attn"], cfg, x, positions, tp, seq, all_kv)
    x = x + upd
    upd, aux = _ffn_forward(lp["ffn"], cfg, x, is_moe, dp, tp, seq)
    return x + upd, aux, kv


def _stack_layer(stack: Params, name: str, i: int, cfg: LMConfig, is_moe: bool,
                 x: torch.Tensor, positions: torch.Tensor, dp=None, tp=None, fsdp=None,
                 seq: bool = False, all_kv: bool = False):
    """Layer i of stack `name`, its leaves taken (with `fsdp`, gathered)
    inside the call, so that a checkpointed layer gathers them again at
    its recompute and holds them no longer than the layer runs."""
    return _layer_forward(_layer_at(stack, name, i, fsdp), cfg, is_moe, x, positions, dp, tp,
                          seq, all_kv)


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
    tp=None,
    fsdp=None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[list]]:
    """Returns (hidden (B,S,D), total aux loss, kv caches or None).  The kv
    caches are one dict per layer stack, each leaf (L_stack, B, S, ...).
    While autograd records (and no kv is collected), `cfg.remat`
    checkpoints each layer.  `dp`: this rank's block of a data-parallel
    batch (the MoE layers route by the global batch); `tp`: the model
    ranks, `params` this rank's blocks of the leaves; `fsdp`: gathers each
    layer's leaves over the batch ranks as the layer runs (the caller
    gathers the rest, `fsdp.top`).  The kv caches hold this rank's heads
    (every KV head where the query heads split and the KV heads do not).
    Where `_seq` holds, the carry between layers (what remat keeps) is
    this rank's block of S, and the final norm runs on it before h is
    gathered whole."""
    B, S = tokens.shape
    seq = _seq(tp, S)
    x = _embed(params, cfg, tokens, tp, seq)
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    kvs = []
    remat = cfg.remat and not collect_kv and _recording(x)
    for name, stack, n, is_moe in _layer_stacks(params, cfg):
        layer_kvs = []
        for i in range(n):
            args = (stack, name, i, cfg, is_moe, x, positions, dp, tp, fsdp, seq, collect_kv)
            if remat:
                x, aux, kv = _checkpointed(cfg.remat_policy, _stack_layer, *args)
            else:
                x, aux, kv = _stack_layer(*args)
            aux_total = aux_total + aux
            if collect_kv:
                layer_kvs.append(kv)
        if collect_kv:
            kvs.append({k: torch.stack([kv[k] for kv in layer_kvs]) for k in layer_kvs[0]})
    h = rms_norm(x, _norm(params["final_norm"], tp, seq))
    if seq:
        h = tp.gather(h, 1)
    return h, aux_total, (kvs if collect_kv else None)


def _head_weight(params: Params) -> torch.Tensor:
    return params["head"] if "head" in params else params["embed"].T


# --------------------------------------------------------------------------
# loss (chunked fused cross-entropy — never materialise (B,S,V))
# --------------------------------------------------------------------------

def _xent_chunk(hx: torch.Tensor, head: torch.Tensor, tx: torch.Tensor,
                tp=None) -> torch.Tensor:
    """Σ of the chunk's token NLLs over targets >= 0, in f32.  Under `tp`
    (vocab-parallel: `head` holds this rank's block of the vocab) each rank
    makes only its block of the logits: the log-sum-exp combines the
    ranks' maxes and sums of exponentials, and the target's logit comes
    from the rank that holds it.  Without `tp` the same ops on the whole
    vocab."""
    if tp is not None:
        hx = tp.copy(hx)
    logits = (hx @ head).to(torch.float32)                  # (B, chunk, V_r)
    V_r = logits.shape[-1]
    mx = logits.detach().amax(dim=-1, keepdim=True)
    if tp is not None:
        mx = tp.max(mx)
    sumexp = (logits - mx).exp().sum(dim=-1)
    if tp is not None:
        sumexp = tp.sum(sumexp)
    lse = sumexp.log() + mx[..., 0]
    idx = tx.long() - (0 if tp is None else tp.rank * V_r)
    own = (idx >= 0) & (idx < V_r)
    tgt = torch.where(own, torch.gather(logits, -1, idx.clamp(0, V_r - 1)[..., None])[..., 0],
                      0.0)
    if tp is not None:
        tgt = tp.sum(tgt)
    return torch.where(tx >= 0, lse - tgt, 0.0).sum()


def chunked_xent(
    h: torch.Tensor,            # (B, S, D)
    head: torch.Tensor,         # (D, V)
    targets: torch.Tensor,      # (B, S) int; -1 = ignore
    chunk: int,
    dp=None,
    tp=None,
) -> torch.Tensor:
    """Mean next-token NLL over the targets >= 0, a sequence chunk at a
    time; a ragged S (MTP's S - 1) is padded with ignored targets.  While
    autograd records, each chunk is checkpointed: its (B, chunk, V)
    logits are freed after the forward and made again in the backward.
    With `dp` the sum over this rank's block divided by the count over
    every rank's; with `tp` `head` is this rank's vocab block
    (`_xent_chunk`)."""
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
            tot = tot + checkpoint(_xent_chunk, hx, head, tx, tp, use_reentrant=False)
        else:
            tot = tot + _xent_chunk(hx, head, tx, tp)
    cnt = (targets >= 0).sum()
    if dp is not None:
        cnt = dp.all_reduce(cnt)
    return tot / torch.clamp_min(cnt, 1)


def mtp_loss(params: Params, cfg: LMConfig, h: torch.Tensor, tokens: torch.Tensor,
             dp=None, tp=None) -> torch.Tensor:
    """DeepSeek-V3 multi-token prediction (depth 1): position t predicts t+2.
    Under `tp` `proj` is column-parallel: its output is gathered whole for
    the block, a full layer."""
    p = params["mtp"]
    B, S, D = h.shape
    e_next = _embed(params, cfg, tokens[:, 1:], tp)         # (B, S-1, D)
    m = torch.cat([rms_norm(h[:, :-1], p["norm_h"]), rms_norm(e_next, p["norm_e"])], dim=-1)
    if _split(tp, D):
        m = tp.gather(tp.copy(m) @ p["proj"], -1)           # (B, S-1, D)
    else:
        m = m @ p["proj"]
    positions = torch.arange(S - 1, dtype=torch.int32, device=h.device).expand(B, S - 1)
    m, _, _ = _layer_forward(p["block"], cfg, False, m, positions, tp=tp)
    m = rms_norm(m, params["final_norm"])
    # position i of m sees tokens <= i and the embedding of token i+1: it
    # predicts token i+2
    targets = F.pad(tokens[:, 2:], (0, 1), value=-1)        # (B, S-1)
    return chunked_xent(m, _head_weight(params), targets, cfg.loss_chunk, dp,
                        _vocab_tp(cfg, tp))


def lm_loss(
    params: Params, cfg: LMConfig, tokens: torch.Tensor, targets: torch.Tensor,
    *, aux_weight: float = 0.01, mtp_weight: float = 0.3, dp=None, tp=None, fsdp=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total loss, {"xent", "aux"[, "mtp"]}), as the reference's; with `dp`
    this rank's part of each (their sums over the ranks are the global
    batch's); with `tp` the same on every model rank; with `fsdp`
    `params` are the rank's blocks over the batch ranks too."""
    if fsdp is not None:
        params = fsdp.top(params)
    h, aux, _ = forward(params, cfg, tokens, dp=dp, tp=tp, fsdp=fsdp)
    loss = chunked_xent(h, _head_weight(params), targets, cfg.loss_chunk, dp,
                        _vocab_tp(cfg, tp))
    metrics = {"xent": loss, "aux": aux}
    total = loss + aux_weight * aux
    if cfg.mtp:
        lm = mtp_loss(params, cfg, h, tokens, dp, tp)
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
    cfg: LMConfig, batch: int, max_len: int, device: DeviceLike = "cuda", *, tp=None
) -> DecodeCache:
    """A zero cache for `batch` sequences; with `tp` this rank's KV heads
    where they split over the model ranks (`dist.sharding.cache_specs`),
    MLA's latents whole."""
    dev = resolve_device(device)
    C = min(cfg.window, max_len) if cfg.window else max_len
    L = cfg.n_layers
    if cfg.mla is not None:
        m = cfg.mla
        shapes = {"ckv": (L, batch, C, m.kv_lora_rank), "krope": (L, batch, C, m.d_rope)}
    else:
        Hkv = cfg.n_kv_heads // tp.size if _split(tp, cfg.n_kv_heads) else cfg.n_kv_heads
        kv = (L, batch, C, Hkv, cfg.d_head)
        shapes = {"k": kv, "v": kv}
    data = {k: torch.zeros(s, dtype=cfg.dtype, device=dev) for k, s in shapes.items()}
    return DecodeCache(data=data, pos=torch.zeros((), dtype=torch.int32, device=dev),
                       length=C)


def _decode_attn(
    p: Params, cfg: LMConfig, x: torch.Tensor, cache_l: Dict[str, torch.Tensor],
    pos: torch.Tensor, ring: int, tp=None,
) -> torch.Tensor:
    """x: (B, D) single token.  Writes the token's cache entries into slot
    `pos % ring` of `cache_l` (views of one layer's cache) and returns the
    residual update; under `tp` for this rank's heads, as `_attn_forward`."""
    B, D = x.shape
    p, blk, reads = _attn_tp(p, cfg, tp)
    H = cfg.n_heads // (blk.tp.size if blk.split else 1)
    dh = cfg.d_head
    h = rms_norm(x, p["ln1"])
    idx = (pos % ring).long().view(1)      # ring slot for this absolute position
    pos1 = pos.view(1)                     # (1,) — rope positions for new token
    # valid slots: everything already written, including the one written now
    valid = (torch.arange(ring, device=x.device) <= torch.clamp(pos, max=ring - 1)
             ).expand(B, ring)

    if cfg.mla is not None:
        m = cfg.mla
        q = _mla_q(p, cfg, h, blk).reshape(B, H, m.d_nope + m.d_rope)
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
        return blk.leave(o.reshape(B, H * m.d_v) @ p["wo"])

    q, k, v = _qkv(p, cfg, h, blk, None if reads is None else (0, cfg.n_kv_heads))
    q = q.reshape(B, H, dh)
    k = k.reshape(B, -1, dh)
    v = v.reshape(B, -1, dh)
    if cfg.qk_norm:
        q, k = _qk_norm(p, q, k, blk)
    q = apply_rope(q[:, None], pos1[None, :], cfg.rope_theta)[:, 0]
    k = apply_rope(k[:, None], pos1[None, :], cfg.rope_theta)[:, 0]
    k_c, v_c = cache_l["k"], cache_l["v"]
    k_c.index_copy_(1, idx, k[:, None].to(k_c.dtype))
    v_c.index_copy_(1, idx, v[:, None].to(v_c.dtype))
    if reads is not None:           # every KV head written, this rank's read
        k_c, v_c = k_c[:, :, reads[0]:reads[0] + reads[1]], v_c[:, :, reads[0]:reads[0] + reads[1]]
    o = decode_attention(q, k_c, v_c, valid)
    return blk.leave(o.reshape(B, H * dh) @ p["wo"])


def decode_step(
    params: Params, cfg: LMConfig, cache: DecodeCache, tokens: torch.Tensor,
    *, dp=None, tp=None, fsdp=None,
) -> Tuple[torch.Tensor, DecodeCache]:
    """One decode step: tokens (B,) -> (logits (B,V) f32, the cache at
    pos + 1).  Consumes `cache`: its buffers are written in place.  `dp`,
    `tp`, `fsdp` as `forward`'s (the cache this rank's block,
    `init_decode_cache(tp=)`); the logits are whole over the vocab on
    every model rank."""
    if fsdp is not None:
        params = fsdp.top(params)
    x = _embed(params, cfg, tokens, tp)
    pos = cache.pos
    off = 0
    for name, stack, n, is_moe in _layer_stacks(params, cfg):
        for i in range(n):
            lp = _layer_at(stack, name, i, fsdp)
            cache_l = {k: v[off + i] for k, v in cache.data.items()}
            x = x + _decode_attn(lp["attn"], cfg, x, cache_l, pos, cache.length, tp)
            h = rms_norm(x, lp["ffn"]["ln2"])
            if is_moe:
                out, _ = moe_ffn(lp["ffn"], h, cfg.moe, cfg.act, dp=dp, tp=tp)
            else:
                out = _dense_ffn(lp["ffn"], cfg, h, tp)
            x = x + out
        off += n
    h = rms_norm(x, params["final_norm"])
    logits = _logits(h, _head_weight(params), cfg, tp)
    return logits, DecodeCache(data=cache.data, pos=pos + 1, length=cache.length)


def prefill(
    params: Params, cfg: LMConfig, tokens: torch.Tensor, max_len: int,
    *, dp=None, tp=None, fsdp=None,
) -> Tuple[torch.Tensor, DecodeCache]:
    """Prefill S tokens, build the decode cache on the tokens' device.
    Returns (last logits (B,V) f32, cache); `dp`, `tp`, `fsdp` as
    `decode_step`'s."""
    B, S = tokens.shape
    if fsdp is not None:
        params = fsdp.top(params)
    h, _, kvs = forward(params, cfg, tokens, collect_kv=True, dp=dp, tp=tp, fsdp=fsdp)
    cache = init_decode_cache(cfg, B, max_len, device=tokens.device, tp=tp)
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
    logits = _logits(h[:, -1], _head_weight(params), cfg, tp)
    return logits, DecodeCache(
        data=cache.data, pos=torch.full((), S, dtype=torch.int32, device=tokens.device),
        length=C)
