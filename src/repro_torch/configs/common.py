"""Cell machinery (counterpart of `repro.configs.common`): every
(architecture × input-shape) pair is a `Cell` that knows how to build its
step, its inputs and their placements on a mesh.  `launch.dryrun` iterates
the cells of `REGISTRY`.

A cell's `build(mesh, variant)` runs inside the dry run's `FakeTensorMode`
on a `DeviceMesh` of a "fake" process group and returns

    (fn, example_inputs, placements)

`example_inputs` are fake tensors placed on the mesh as the step takes
them (DTensors of this rank's blocks, or this rank's own shard): nothing
is allocated.  `placements` is the `dist.sharding.P` spec of each input.
The dry run calls `fn(*example_inputs)` once under a counting mode.

The LM cells.  `variant` "memory" is the production program at full
depth; "cost_a" / "cost_b" are the same program cut to 2 / 4 layers of
its stack (`_with_stack_layers`) with the attention and loss chunks
raised to a sequence's eighth (`_dryrun_cfg`; their FLOPs do not depend
on the chunk), whose counts the dry run extrapolates affinely in the
layer count (`cell.extrapolate`), as the reference's cost passes do.
"memory_a" / "memory_b" are the production program at 2 / 4 layers, the
memory pass's fallback when a full-depth pass would take too long.
Eager torch runs every layer, so "unroll" has no meaning here.

An MoE layer under the data-parallel route sizes its local expert buffer
from the routing it sees (one host read); every pass of the dry run sets
`MoEConfig.buf_pspec` (`_dryrun_cfg`, as the reference's does), so that
it takes the static bound the reference's buffer has, (E, C) split over
the batch ranks (`models.moe`), and the record says so.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.lm_cells import (
    LM_SHAPES,
    lm_decode_flops,
    lm_train_flops,
    make_lm_train_step,
    place_decode_cache,
    place_lm_state,
    prefill_step,
    serve_step,
)
from repro_torch.models import transformer as tf
from repro_torch.models.lm_config import LMConfig


@dataclasses.dataclass(frozen=True)
class Cell:
    arch: str
    shape: str
    kind: str                               # train | prefill | decode | serve | mis
    build: Callable[..., Tuple[Callable, tuple, Any]]  # (mesh, variant=...)
    model_flops: float                      # analytic useful FLOPs per step
    note: str = ""
    skip_reason: Optional[str] = None       # e.g. long_500k on full attention
    # LM cells: cost passes at 2 and 4 layers of the stack, extrapolated
    # affinely in the layer count (a homogeneous stack costs a + b·L)
    extrapolate: Optional[dict] = None      # {"la": 2, "lb": 4, "lfull": L}


@dataclasses.dataclass(frozen=True)
class ArchDef:
    arch_id: str
    family: str                             # lm | gnn | recsys | mis
    cells: Dict[str, Cell]
    smoke: Callable[..., None]              # reduced-config step, smoke(device=...)
    config: Any = None


REGISTRY: Dict[str, ArchDef] = {}


def register(arch: ArchDef) -> ArchDef:
    REGISTRY[arch.arch_id] = arch
    return arch


def fake_module(make: Callable[[], torch.nn.Module], device) -> torch.nn.Module:
    """A module for the dry run: `make()` builds it outside the fake mode
    (a module built under one cannot move its fake parameters:
    `Module._apply` swaps them), on the "meta" device, which gives the
    shapes and dtypes and draws nothing (the reference's `jax.eval_shape`),
    and its parameters and buffers are then replaced by empty tensors on
    `device`, fake under the mode."""
    from repro_torch.hopper.launch import outside_fake_mode

    with outside_fake_mode():
        model = make()
    for mod in model.modules():
        for k, p in mod._parameters.items():
            if p is not None:
                mod._parameters[k] = torch.nn.Parameter(
                    torch.empty(p.shape, dtype=p.dtype, device=device),
                    requires_grad=p.requires_grad)
        for k, b in mod._buffers.items():
            if b is not None:
                mod._buffers[k] = torch.empty(b.shape, dtype=b.dtype, device=device)
    return model


def placed(x: torch.Tensor, spec, mesh):
    """A whole (fake) tensor as the DTensor of this rank's block under `spec`."""
    from repro_torch.dist.sharding import Sharding

    return Sharding(mesh, spec).place(x)


# --------------------------------------------------------------------------
# LM cells (shared by all five transformer archs)
# --------------------------------------------------------------------------

def _dryrun_cfg(cfg: LMConfig, mesh, *, cost: bool, seq: int = 4096) -> LMConfig:
    """The config a pass runs on `mesh`: the production program's, its MoE
    expert buffers placed as the reference's (`buf_pspec`: expert parallel
    on 'model' where the experts split over it, else over the batch axes
    alone), which holds them at their static bound; for a cost pass the
    attention and loss chunks raised to seq // 8, which bounds the host
    time of a fake run (the chunked attention's and loss's FLOPs do not
    depend on the chunk)."""
    if cfg.moe is not None:
        from repro_torch.dist.sharding import _model_size, data_axes

        dp = tuple(data_axes(mesh))
        expert = cfg.moe.n_experts % max(_model_size(mesh), 1) == 0
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, buf_pspec=("model", dp, None) if expert else (None, dp, None)))
    if not cost:
        return cfg
    return dataclasses.replace(cfg, attn_chunk=max(cfg.attn_chunk, seq // 8),
                               loss_chunk=max(cfg.loss_chunk, seq // 8))


def _needs_fsdp(cfg: LMConfig, mesh) -> bool:
    """The reference's rule (sized for a 16 GB v5e): model-parallel-only
    weights above 6e9 bytes a device are also sharded over the batch axes."""
    from repro_torch.dist.sharding import _model_size

    bytes_per_dev = cfg.param_count() * 2 / max(_model_size(mesh), 1)
    return bytes_per_dev > 6e9


def _with_stack_layers(cfg: LMConfig, k: int) -> LMConfig:
    """The stack cut to k layers (dense archs: k in all; MoE archs: the
    dense layers kept + k MoE layers)."""
    if cfg.moe is not None:
        return dataclasses.replace(cfg, n_layers=cfg.n_dense_layers + k)
    return dataclasses.replace(cfg, n_layers=k)


def _lm_stack_size(cfg: LMConfig) -> int:
    return (cfg.n_layers - cfg.n_dense_layers) if cfg.moe else cfg.n_layers


def _lm_extrapolate(cfg: LMConfig) -> dict:
    return {"la": 2, "lb": 4, "lfull": _lm_stack_size(cfg)}


VARIANT_LAYERS = {"cost_a": 2, "cost_b": 4, "memory_a": 2, "memory_b": 4}


def _variant_cfg(cfg: LMConfig, mesh, variant: str, seq: int) -> LMConfig:
    if variant == "memory":
        return _dryrun_cfg(cfg, mesh, cost=False, seq=seq)
    return _dryrun_cfg(_with_stack_layers(cfg, VARIANT_LAYERS[variant]), mesh,
                       cost=variant.startswith("cost"), seq=seq)


def _lm_params(cfg: LMConfig, device: torch.device):
    """The LM's parameter tree as empty tensors (fake in the dry run)."""
    from repro_torch.train import tree as T

    return T.tree_map(lambda sd: torch.empty(sd[0], dtype=sd[1], device=device),
                      tf.param_shapes(cfg), is_leaf=lambda x: isinstance(x, tuple))


def _tokens(mesh, shape, spec):
    from repro_torch.dist.sharding import mesh_device

    return placed(torch.empty(shape, dtype=torch.int32, device=mesh_device(mesh)), spec, mesh)


def _lm_train_cell(arch_id: str, cfg: LMConfig, shape_name: str,
                   batch: Optional[int] = None) -> Cell:
    """train_4k: `make_lm_train_step(mesh=)` on the state `place_lm_state`
    places (`lm_param_specs`, ZeRO-1 moments) and the tokens under
    `batch_spec(mesh, 1)`; `batch` cuts the global batch."""
    s = LM_SHAPES[shape_name]
    B, S = batch or s["global_batch"], s["seq_len"]

    def build(mesh, variant: str = "memory"):
        from repro_torch.dist.sharding import (
            P,
            _axis_size,
            batch_spec,
            data_axes,
            lm_param_specs,
            mesh_device,
        )
        from repro_torch.train.optimizer import AdamWState, OptConfig, zero1_specs

        rcfg = _variant_cfg(cfg, mesh, variant, S)
        fsdp = _needs_fsdp(cfg, mesh)
        whole = _lm_params(rcfg, mesh_device(mesh))
        params, opt = place_lm_state(whole, mesh, fsdp=fsdp)
        p_specs = lm_param_specs(whole, mesh, fsdp=fsdp)
        dp = data_axes(mesh)
        m_specs = zero1_specs(p_specs, whole, mesh_axis=dp, mesh_size=_axis_size(mesh, dp))
        del whole
        tok_spec = batch_spec(mesh, 1)
        inputs = (params, opt, _tokens(mesh, (B, S), tok_spec), _tokens(mesh, (B, S), tok_spec))
        fn = make_lm_train_step(rcfg, OptConfig(total_steps=10000), mesh=mesh, fsdp=fsdp)
        return fn, inputs, (p_specs, AdamWState(step=P(), m=m_specs, v=m_specs), tok_spec,
                            tok_spec)

    return Cell(arch=arch_id, shape=shape_name, kind="train", build=build,
                model_flops=lm_train_flops(cfg, B, S), extrapolate=_lm_extrapolate(cfg))


def _lm_prefill_cell(arch_id: str, cfg: LMConfig, shape_name: str) -> Cell:
    """prefill_32k: `prefill_step(mesh=)` of a prompt of seq_len tokens into
    a cache of that length."""
    s = LM_SHAPES[shape_name]
    B, S = s["global_batch"], s["seq_len"]

    def build(mesh, variant: str = "memory"):
        from repro_torch.dist.sharding import batch_spec, distribute, lm_param_specs, mesh_device

        rcfg = _variant_cfg(cfg, mesh, variant, S)
        fsdp = _needs_fsdp(cfg, mesh)
        whole = _lm_params(rcfg, mesh_device(mesh))
        p_specs = lm_param_specs(whole, mesh, fsdp=fsdp)
        params = distribute(whole, p_specs, mesh)
        del whole
        tok_spec = batch_spec(mesh, 1)

        def step(params, tokens):
            return prefill_step(params, rcfg, tokens, mesh=mesh, fsdp=fsdp)

        return step, (params, _tokens(mesh, (B, S), tok_spec)), (p_specs, tok_spec)

    # prefill ~ forward only: 2·N·D
    return Cell(arch=arch_id, shape=shape_name, kind="prefill", build=build,
                model_flops=lm_train_flops(cfg, B, S) / 3.0, extrapolate=_lm_extrapolate(cfg))


def _lm_decode_cell(arch_id: str, cfg: LMConfig, shape_name: str, skip_reason=None) -> Cell:
    """decode_32k / long_500k: one `serve_step(mesh=)` against a cache of
    seq_len slots placed by `cache_specs` (`place_decode_cache`)."""
    s = LM_SHAPES[shape_name]
    B, S = s["global_batch"], s["seq_len"]

    def build(mesh, variant: str = "memory"):
        from repro_torch.dist.sharding import (
            P,
            _axis_size,
            cache_specs,
            data_axes,
            distribute,
            lm_param_specs,
            mesh_device,
        )

        rcfg = _variant_cfg(cfg, mesh, variant, S)
        fsdp = _needs_fsdp(cfg, mesh)
        dev = mesh_device(mesh)
        whole = _lm_params(rcfg, dev)
        p_specs = lm_param_specs(whole, mesh, fsdp=fsdp)
        params = distribute(whole, p_specs, mesh)
        del whole
        cache = place_decode_cache(tf.init_decode_cache(rcfg, B, S, device=dev), rcfg, mesh)
        c_specs = cache_specs(rcfg, mesh, B, cache.length)
        dp = data_axes(mesh)
        tok_spec = P(dp) if B % _axis_size(mesh, dp) == 0 else P()

        def step(params, cache, tokens):
            return serve_step(params, rcfg, cache, tokens, mesh=mesh, fsdp=fsdp)

        return step, (params, cache, _tokens(mesh, (B,), tok_spec)), (p_specs, c_specs,
                                                                       tok_spec)

    return Cell(arch=arch_id, shape=shape_name, kind="decode", build=build,
                model_flops=lm_decode_flops(cfg, B, min(S, cfg.window or S)),
                skip_reason=skip_reason, extrapolate=_lm_extrapolate(cfg))


def lm_cells(arch_id: str, cfg: LMConfig) -> Dict[str, Cell]:
    full_attention = cfg.window is None
    return {
        "train_4k": _lm_train_cell(arch_id, cfg, "train_4k"),
        "prefill_32k": _lm_prefill_cell(arch_id, cfg, "prefill_32k"),
        "decode_32k": _lm_decode_cell(arch_id, cfg, "decode_32k"),
        "long_500k": _lm_decode_cell(
            arch_id, cfg, "long_500k",
            skip_reason=(
                "full-attention arch: 500k-token decode requires sub-quadratic "
                "attention structure (DESIGN.md §8)" if full_attention else None
            ),
        ),
    }
