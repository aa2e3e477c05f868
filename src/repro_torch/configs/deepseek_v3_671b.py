"""deepseek-v3-671b [arXiv:2412.19437]: 61L d=7168 128H, MLA
(q_lora=1536, kv_lora=512, nope=128, rope=64, v=128), MoE 1 shared + 256
routed top-8 (d_expert=2048), first 3 layers dense (d_ff=18432), MTP depth 1,
vocab 129280, sigmoid (aux-free-style) router (counterpart of
`repro.configs.deepseek_v3_671b`)."""
import torch

from repro_torch.configs.common import ArchDef, lm_cells, register
from repro_torch.configs.lm_cells import lm_smoke
from repro_torch.device import DeviceLike
from repro_torch.models.lm_config import LMConfig, MLAConfig, MoEConfig

ARCH_ID = "deepseek-v3-671b"

CONFIG = LMConfig(
    name="deepseek-v3-671b",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, d_head=128,
    d_ff=18432, vocab=129280, act="swiglu",
    n_dense_layers=3,
    moe=MoEConfig(
        n_experts=256, top_k=8, d_expert=2048, n_shared=1,
        router="sigmoid", capacity_factor=1.25,
    ),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, d_nope=128, d_rope=64, d_v=128),
    mtp=True,
    rope_theta=10_000.0, dtype=torch.bfloat16, loss_chunk=128,
)

SMOKE = LMConfig(
    name="deepseek-smoke",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=128, vocab=128, act="swiglu", n_dense_layers=1,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=48, n_shared=1, router="sigmoid"),
    mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, d_nope=16, d_rope=8, d_v=16),
    mtp=True,
    dtype=torch.float32, attn_chunk=16, loss_chunk=16,
)


def smoke(device: DeviceLike = "cuda") -> None:
    """One train step, a prefill and a decode step of `SMOKE` (`lm_smoke`)."""
    lm_smoke(SMOKE, device=device)


ARCH = register(ArchDef(arch_id=ARCH_ID, family="lm", cells=lm_cells(ARCH_ID, CONFIG),
                        smoke=smoke, config=CONFIG))
