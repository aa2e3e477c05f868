"""Configuration dataclasses for the unified LM transformer family
(counterpart of `repro.models.lm_config`).

One config type covers all five assigned LM architectures:
  qwen1.5-0.5b   dense, MHA (GQA kv=16), QKV bias, SwiGLU
  qwen3-0.6b     dense, GQA kv=8, qk-norm, SwiGLU
  nemotron-4     dense, GQA kv=8, squared-ReLU
  mixtral-8x22b  MoE 8e top-2, GQA kv=8, sliding-window attention
  deepseek-v3    MoE 1 shared + 256 routed top-8, MLA, MTP, 3 dense lead layers

The fields and defaults are the reference's, with `dtype` a torch dtype.
`remat` / `remat_policy` steer the training step's per-layer activation
checkpointing (`torch.utils.checkpoint`; "full" keeps only each layer's
input, "dots" also the 2-D matmul outputs).  Left out: the knobs that
steer XLA and compute nothing here — `unroll` (scans unrolled for the
dry-run's cost pass), `dp_axes` (sharding hints: where the reference sets
it, the port's steps pass their groups, and a step with a 'model' group
holds the layer carry sequence-parallel as the reference's hint does,
`models.transformer`), and the MoE's `shard_experts` (a legacy layout
toggle).  `fuse_qkv` and `fuse_gate`
change the parameter tree, so they stay.  The MoE's `buf_pspec` stays: the
dry run's cells set it (`configs.common._dryrun_cfg`) as the reference's
do, and where it is set the data-parallel route holds the buffer the
reference's placement gives a rank, its capacity split over the batch
ranks, without reading the routing (`models.moe`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int                 # routed experts
    top_k: int
    d_expert: int                  # expert FFN hidden dim
    n_shared: int = 0              # always-on shared experts (DeepSeek)
    capacity_factor: float = 1.25  # tokens/expert buffer = avg·cf (GShard-style)
    router: str = "softmax"        # softmax (Mixtral) | sigmoid (DeepSeek aux-free)
    buf_pspec: Optional[tuple] = None  # the (E, C, D) dispatch buffers' placement, e.g.
                                       # ('model', ('data',), None); set: the static bound


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    d_nope: int = 128              # per-head non-rope q/k dim
    d_rope: int = 64               # per-head rope dim (k_rope is shared)
    d_v: int = 128


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    qkv_bias: bool = False
    qk_norm: bool = False
    act: str = "swiglu"            # swiglu | relu2 (squared ReLU, Nemotron)
    rope_theta: float = 1_000_000.0
    window: Optional[int] = None   # sliding-window attention (Mixtral)
    moe: Optional[MoEConfig] = None
    n_dense_layers: int = 0        # leading dense layers before MoE stack
    mla: Optional[MLAConfig] = None
    mtp: bool = False              # multi-token-prediction head (DeepSeek)
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    attn_chunk: int = 512          # KV-chunk for the online-softmax attention
    loss_chunk: int = 1024         # sequence chunk for the fused xent loss
    remat: bool = True             # activation checkpointing per layer
    remat_policy: str = "full"     # full | dots (save 2-D matmul outputs)
    fuse_qkv: bool = False         # single (D, (H+2Hkv)·dh) projection
    fuse_gate: bool = False        # swiglu w1‖w3 fused the same way

    @property
    def d_q_total(self) -> int:
        if self.mla is not None:
            return self.n_heads * (self.mla.d_nope + self.mla.d_rope)
        return self.n_heads * self.d_head

    def _ffn_params(self, dff: int) -> int:
        return (3 if self.act == "swiglu" else 2) * self.d_model * dff

    def param_count(self) -> int:
        """Analytic parameter count (the reference's, term for term)."""
        D, V, L = self.d_model, self.vocab, self.n_layers
        n = V * D  # embed
        if not self.tie_embeddings:
            n += V * D
        per_layer_attn = 0
        if self.mla is not None:
            m = self.mla
            per_layer_attn += D * m.q_lora_rank + m.q_lora_rank * self.d_q_total
            per_layer_attn += D * (m.kv_lora_rank + m.d_rope)
            per_layer_attn += m.kv_lora_rank * self.n_heads * (m.d_nope + m.d_v)
            per_layer_attn += self.n_heads * m.d_v * D
        else:
            per_layer_attn += D * self.n_heads * self.d_head        # q
            per_layer_attn += 2 * D * self.n_kv_heads * self.d_head  # k, v
            per_layer_attn += self.n_heads * self.d_head * D        # o
        n_moe = L - self.n_dense_layers if self.moe else 0
        n_dense = L - n_moe
        n += L * per_layer_attn + n_dense * self._ffn_params(self.d_ff)
        if self.moe:
            e = self.moe
            per_moe = (e.n_experts + e.n_shared) * self._ffn_params(e.d_expert)
            per_moe += D * e.n_experts  # router
            n += n_moe * per_moe
        n += 2 * L * D + D  # norms
        if self.mtp:
            n += 2 * D * D + per_layer_attn + self._ffn_params(self.d_ff) + 3 * D
        return int(n)

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k + shared only)."""
        if self.moe is None:
            return self.param_count()
        e = self.moe
        inactive = (self.n_layers - self.n_dense_layers) * (
            (e.n_experts - e.top_k) * self._ffn_params(e.d_expert)
        )
        return int(self.param_count() - inactive)
