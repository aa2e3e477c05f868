"""nemotron-4-340b [arXiv:2402.16819]: 96L d=18432 96H (GQA kv=8)
d_ff=73728 vocab=256000, squared-ReLU, no gating (counterpart of
`repro.configs.nemotron4_340b`)."""
import torch

from repro_torch.configs.common import ArchDef, lm_cells, register
from repro_torch.configs.lm_cells import lm_smoke
from repro_torch.device import DeviceLike
from repro_torch.models.lm_config import LMConfig

ARCH_ID = "nemotron-4-340b"

CONFIG = LMConfig(
    name="nemotron-4-340b",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8, d_head=192,
    d_ff=73728, vocab=256000, act="relu2",
    rope_theta=10_000.0, dtype=torch.bfloat16, loss_chunk=128,
)

SMOKE = LMConfig(
    name="nemotron-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=256, vocab=128, act="relu2",
    dtype=torch.float32, attn_chunk=16, loss_chunk=16,
)


def smoke(device: DeviceLike = "cuda") -> None:
    """One train step, a prefill and a decode step of `SMOKE` (`lm_smoke`)."""
    lm_smoke(SMOKE, device=device)


ARCH = register(ArchDef(arch_id=ARCH_ID, family="lm", cells=lm_cells(ARCH_ID, CONFIG),
                        smoke=smoke, config=CONFIG))
