"""qwen1.5-0.5b [hf:Qwen/Qwen1.5-0.5B]: 24L d=1024 16H (GQA kv=16 ≡ MHA)
d_ff=2816 vocab=151936, QKV bias, SwiGLU, RoPE (counterpart of
`repro.configs.qwen15_0_5b`)."""
import torch

from repro_torch.configs.common import ArchDef, lm_cells, register
from repro_torch.configs.lm_cells import lm_smoke
from repro_torch.device import DeviceLike
from repro_torch.models.lm_config import LMConfig

ARCH_ID = "qwen1.5-0.5b"

CONFIG = LMConfig(
    name="qwen1.5-0.5b",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_head=64,
    d_ff=2816, vocab=151936, qkv_bias=True, act="swiglu",
    rope_theta=10_000.0, dtype=torch.bfloat16, loss_chunk=512,
)

SMOKE = LMConfig(
    name="qwen1.5-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=128, vocab=128, qkv_bias=True, act="swiglu",
    dtype=torch.float32, attn_chunk=16, loss_chunk=16,
)


def smoke(device: DeviceLike = "cuda") -> None:
    """One train step, a prefill and a decode step of `SMOKE` (`lm_smoke`)."""
    lm_smoke(SMOKE, device=device)


ARCH = register(ArchDef(arch_id=ARCH_ID, family="lm", cells=lm_cells(ARCH_ID, CONFIG),
                        smoke=smoke, config=CONFIG))
