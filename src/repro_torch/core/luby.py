"""The MIS result record (counterpart of `repro.core.luby.MISResult`; the
Luby baseline itself is not ported yet)."""
from __future__ import annotations

from typing import NamedTuple

import torch


class MISResult(NamedTuple):
    in_mis: torch.Tensor     # (n,) bool
    rounds: torch.Tensor     # int32 — () global, or (n,) per-vertex
    converged: torch.Tensor  # bool — False iff max_rounds hit
