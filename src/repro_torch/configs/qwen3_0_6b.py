"""qwen3-0.6b [hf:Qwen/Qwen3-0.6B family]: 28L d=1024 16H (GQA kv=8)
d_ff=3072 vocab=151936, qk-norm, head_dim=128, SwiGLU (counterpart of
`repro.configs.qwen3_0_6b`)."""
import torch

from repro_torch.configs.common import ArchDef, lm_cells, register
from repro_torch.configs.lm_cells import lm_smoke
from repro_torch.device import DeviceLike
from repro_torch.models.lm_config import LMConfig

ARCH_ID = "qwen3-0.6b"

CONFIG = LMConfig(
    name="qwen3-0.6b",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, d_head=128,
    d_ff=3072, vocab=151936, qk_norm=True, act="swiglu",
    rope_theta=1_000_000.0, dtype=torch.bfloat16, loss_chunk=512,
)

SMOKE = LMConfig(
    name="qwen3-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=32,
    d_ff=128, vocab=128, qk_norm=True, act="swiglu",
    dtype=torch.float32, attn_chunk=16, loss_chunk=16,
)


def smoke(device: DeviceLike = "cuda") -> None:
    """One train step, a prefill and a decode step of `SMOKE` (`lm_smoke`)."""
    lm_smoke(SMOKE, device=device)


ARCH = register(ArchDef(arch_id=ARCH_ID, family="lm", cells=lm_cells(ARCH_ID, CONFIG),
                        smoke=smoke, config=CONFIG))
