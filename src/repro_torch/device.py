"""Device policy and the numpy <-> torch helpers.

Device rule: an entry point runs on the device its caller names, "cuda" by
default.  Asking for CUDA where there is none raises; nothing chooses the
CPU on its own.  Only the CPU parity tests ask for `device="cpu"`.  A
model built on "meta" has its shapes and dtypes only and draws nothing
(the dry run's modules).

Packed words: the reference keeps packed tiles and frontiers as uint32.
torch lacks `~`, `>>`, `<<` and `amax` for uint32, so the port carries the
same bits in int32 tensors (`ndarray.view(np.int32)` on the way in).  The
CUDA kernels reinterpret them as uint32; torch code masks after every right
shift, because int32 `>>` is arithmetic.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """The torch device for `device`; raises if it names CUDA and there is
    no CUDA device.  Never substitutes another device."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {str(dev)!r}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and dev.index is None:
        # "cuda" names the current card; tensors report it with its index
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def to_torch(x, device: DeviceLike) -> torch.Tensor:
    """numpy (or array-like) -> tensor on `device`; uint32 arrays arrive as
    int32 tensors holding the same bits."""
    a = np.ascontiguousarray(np.asarray(x))
    if not a.flags.writeable:   # e.g. a view of a jax array: copy, torch writes
        a = a.copy()
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def words_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 word tensor -> the uint32 array with the same bits (the
    reference's dtype for packed tiles and frontiers)."""
    return t.detach().cpu().numpy().view(np.uint32)
