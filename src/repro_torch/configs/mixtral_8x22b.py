"""mixtral-8x22b [arXiv:2401.04088]: 56L d=6144 48H (GQA kv=8)
MoE 8 experts top-2 (d_expert=16384), SWA window 4096, vocab 32768
(counterpart of `repro.configs.mixtral_8x22b`).

The only assigned LM arch with sub-quadratic attention structure: its
decode cache is a ring of `window` slots."""
import torch

from repro_torch.configs.common import ArchDef, lm_cells, register
from repro_torch.configs.lm_cells import lm_smoke
from repro_torch.device import DeviceLike
from repro_torch.models.lm_config import LMConfig, MoEConfig

ARCH_ID = "mixtral-8x22b"

CONFIG = LMConfig(
    name="mixtral-8x22b",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
    d_ff=16384, vocab=32768, act="swiglu", window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=16384, router="softmax"),
    rope_theta=1_000_000.0, dtype=torch.bfloat16, loss_chunk=1024,
)

SMOKE = LMConfig(
    name="mixtral-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=128, act="swiglu", window=16,
    moe=MoEConfig(n_experts=4, top_k=2, d_expert=96),
    dtype=torch.float32, attn_chunk=16, loss_chunk=16,
)


def smoke(device: DeviceLike = "cuda") -> None:
    """One train step, a prefill and a decode step of `SMOKE` (`lm_smoke`)."""
    lm_smoke(SMOKE, device=device)


ARCH = register(ArchDef(arch_id=ARCH_ID, family="lm", cells=lm_cells(ARCH_ID, CONFIG),
                        smoke=smoke, config=CONFIG))
