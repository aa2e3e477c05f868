"""Fault-tolerant checkpointing: atomic and checksummed.  The counterpart of
`repro.train.checkpoint` (`save`, `restore`, `restore_latest`,
`available_steps`, `latest_step`, `garbage_collect`, `tree_shapes`,
`CorruptCheckpoint`), over trees of tensors (`train.tree`).

Format: one directory per step, as the reference's —
    ckpt_dir/step_000123/
        manifest.json   {step, leaves: [{file, codec, shape, dtype, crc32}], tree}
        arrays/<i>.bin.zst (or .bin.z)   one compressed raw payload per leaf

* **atomic**: written to `step_X.tmp`, then `os.replace`d: a crash
  mid-write never leaves a directory that `latest_step` picks up.
* **checksummed**: every leaf carries the crc32 of its raw bytes; a
  damaged checkpoint raises `CorruptCheckpoint` at restore, and
  `restore_latest` falls back to the previous step.
* **zstd when `zstandard` imports, zlib otherwise**; the codec is recorded
  per leaf.
* Leaves are stored as whole tensors, one at a time, and restored onto the
  device the caller names (the card by default).
* **placed trees** (DTensor leaves, `dist.sharding.distribute`): `save`
  gathers each leaf on every rank of their mesh (`full_tensor()`), the
  mesh's first rank writes, and every rank returns only once the
  checkpoint is in place (`dist.collectives.mesh_barrier`);
  `restore(placements=)` has every rank read each leaf and keep its own
  block, the counterpart of the reference's `restore(shardings=)`.

Where the reference's manifest is msgpack with a pickled treedef, this one
is JSON with the tree's spec (`train.tree.flatten`): dict keys sorted,
NamedTuples by import path.  The port does not read the reference's
checkpoint files, nor the reference the port's.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Any, List, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.train import tree as T

try:
    import zstandard

    _CTX = zstandard.ZstdCompressor(level=3)
except ImportError:  # optional dependency: fall back to stdlib zlib
    zstandard = None
    _CTX = None

MANIFEST = "manifest.json"


class CorruptCheckpoint(RuntimeError):
    pass


def _compress(raw: bytes) -> Tuple[bytes, str]:
    if _CTX is not None:
        return _CTX.compress(raw), "zstd"
    return zlib.compress(raw, 6), "zlib"


def _decompress(payload: bytes, codec: str) -> bytes:
    """Raises CorruptCheckpoint on damaged frames, RuntimeError on a missing
    codec module (a flipped bit in the frame header fails before the CRC)."""
    if codec == "zstd":
        if zstandard is None:
            raise RuntimeError(
                "checkpoint was written with zstd compression but the "
                "'zstandard' module is not installed: install it or re-save "
                "the checkpoint"
            )
        try:
            return zstandard.ZstdDecompressor().decompress(payload)
        except zstandard.ZstdError as e:
            raise CorruptCheckpoint(f"zstd frame: {e}") from e
    if codec == "zlib":
        try:
            return zlib.decompress(payload)
        except zlib.error as e:
            raise CorruptCheckpoint(f"zlib stream: {e}") from e
    raise CorruptCheckpoint(f"unknown codec {codec!r}")


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[-1]


def _mesh_of(leaves: List[Any]):
    """The mesh of the first DTensor leaf, or None."""
    from torch.distributed.tensor import DTensor

    return next((x.device_mesh for x in leaves if isinstance(x, DTensor)), None)


def save(ckpt_dir: str, step: int, tree: Any) -> str:
    """Atomically write `tree` as checkpoint `step`.  Returns the final path.

    A tree with DTensor leaves is saved by every rank of their mesh
    together: each leaf is gathered on every rank, the mesh's first rank
    alone writes, and every rank returns only once the checkpoint is in
    place."""
    from repro_torch.dist.collectives import mesh_barrier

    leaves, spec = T.flatten(tree)
    mesh = _mesh_of(leaves)
    writer = mesh is None or not any(mesh.get_coordinate())
    final = _step_dir(ckpt_dir, step)
    tmp = final + ".tmp"
    if writer:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(os.path.join(tmp, "arrays"), exist_ok=True)
    manifest: List[dict] = []
    for i, leaf in enumerate(leaves):
        if mesh is not None and hasattr(leaf, "full_tensor"):
            leaf = leaf.full_tensor()
        if not writer:
            continue
        t = torch.as_tensor(leaf).detach().cpu().contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        payload, codec = _compress(raw)
        fname = f"{i}.bin.zst" if codec == "zstd" else f"{i}.bin.z"
        with open(os.path.join(tmp, "arrays", fname), "wb") as f:
            f.write(payload)
        manifest.append(dict(file=fname, codec=codec, shape=list(t.shape),
                             dtype=_dtype_name(t.dtype), crc32=zlib.crc32(raw) & 0xFFFFFFFF))
    if writer:
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(dict(step=step, leaves=manifest, tree=spec), f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    if mesh is not None:
        mesh_barrier(mesh)
    return final


def _read_manifest(path: str) -> dict:
    with open(os.path.join(path, MANIFEST)) as f:
        return json.load(f)


def tree_shapes(ckpt_dir: str, step: int) -> Any:
    """The checkpoint's tree with each leaf as a tensor on the "meta"
    device (shape and dtype, no data); reads no payload."""
    meta = _read_manifest(_step_dir(ckpt_dir, step))
    return T.unflatten(meta["tree"], [
        torch.empty(m["shape"], dtype=getattr(torch, m["dtype"]), device="meta")
        for m in meta["leaves"]])


def restore(ckpt_dir: str, step: int, *, device: DeviceLike = "cuda",
            placements: Any = None) -> Any:
    """Restore checkpoint `step` with its leaves on `device`.  Raises
    CorruptCheckpoint on a crc mismatch or a damaged payload.

    `placements`, a tree of `dist.sharding.Sharding` of the checkpoint's
    structure, places each leaf as a DTensor: every rank reads the leaf
    and keeps its own block on `device`, one leaf at a time."""
    dev = resolve_device(device)
    path = _step_dir(ckpt_dir, step)
    meta = _read_manifest(path)
    where = None
    if placements is not None:
        where, spec = T.flatten(placements)
        if spec != meta["tree"]:
            raise ValueError("the placements' tree is not the checkpoint's")
    leaves = []
    for i, m in enumerate(meta["leaves"]):
        with open(os.path.join(path, "arrays", m["file"]), "rb") as f:
            try:
                raw = _decompress(f.read(), m.get("codec", "zstd"))
            except CorruptCheckpoint as e:
                raise CorruptCheckpoint(f"{path} leaf {i}: {e}") from e
        if (zlib.crc32(raw) & 0xFFFFFFFF) != m["crc32"]:
            raise CorruptCheckpoint(f"{path} leaf {i}: crc mismatch")
        dtype = getattr(torch, m["dtype"])
        flat = (torch.frombuffer(bytearray(raw), dtype=dtype) if raw
                else torch.empty(0, dtype=dtype))
        full = flat.reshape(m["shape"])
        leaves.append(full.to(dev) if where is None else where[i].place(full, dev))
    return T.unflatten(meta["tree"], leaves)


def available_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                out.append(int(name[5:]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = available_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_latest(ckpt_dir: str, *, device: DeviceLike = "cuda") -> Tuple[Optional[int], Any]:
    """Restore the newest *valid* checkpoint, skipping damaged ones: the
    node-failure recovery path."""
    for step in reversed(available_steps(ckpt_dir)):
        try:
            return step, restore(ckpt_dir, step, device=device)
        except (CorruptCheckpoint, FileNotFoundError, ValueError):
            continue
    return None, None


def garbage_collect(ckpt_dir: str, keep: int = 3) -> None:
    steps = available_steps(ckpt_dir)
    for s in steps[:-keep]:
        shutil.rmtree(_step_dir(ckpt_dir, s), ignore_errors=True)
