"""Elastic rescale: restore a checkpoint onto a DIFFERENT mesh
(counterpart of `repro.dist.elastic`).

Checkpoints store whole (gathered) tensors, so growing from one rank to
many, or shrinking back, is a placement policy applied at restore: build
the target specs from the manifest's shapes (no payload read), then let
`checkpoint.restore` read one leaf at a time and keep each rank's block,
so host memory stays bounded by the largest leaf.
"""
from __future__ import annotations

from typing import Any, Callable

from repro_torch.dist.sharding import mesh_device, shardings
from repro_torch.train import checkpoint as ckpt


def reshard_checkpoint(ckpt_dir: str, step: int, mesh, spec_fn: Callable[[Any, Any], Any]) -> Any:
    """Restore checkpoint `step` placed on `mesh`.

    spec_fn(shapes, mesh) -> a tree of `P`: the placement policy, called
    with the checkpoint's tree of "meta" tensors (`checkpoint.tree_shapes`;
    e.g. `lambda t, m: lm_param_specs(t, m)`).  Returns the tree with
    every leaf a DTensor under its spec, its block on this rank's device."""
    specs = spec_fn(ckpt.tree_shapes(ckpt_dir, step), mesh)
    return ckpt.restore(ckpt_dir, step, device=mesh_device(mesh),
                        placements=shardings(specs, mesh))
