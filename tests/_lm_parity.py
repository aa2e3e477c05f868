"""Shared by the LM parity tests: the reference's and the port's config
for each arch, the reference's weights as numpy, both packages' serving
steps jitted once per config and shape on the reference's side."""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import transformer as rtf
from repro_torch.configs import LM_ARCHS
from repro_torch.models import transformer as tf

ARCHS = sorted(LM_ARCHS)
REF_MODULES = {a: importlib.import_module(f"repro.configs.{m.__name__.rsplit('.', 1)[1]}")
               for a, m in LM_ARCHS.items()}
# the reference's LMConfig fields that steer XLA only; the port leaves them out
XLA_ONLY = {"unroll", "dp_axes"}


def configs(arch, which="SMOKE", **changes):
    """(reference config, port config) of `arch`, with the same changes."""
    ref = getattr(REF_MODULES[arch], which)
    port = getattr(LM_ARCHS[arch], which)
    if changes:
        ref = dataclasses.replace(ref, **{k: (v[0] if isinstance(v, tuple) else v)
                                          for k, v in changes.items()})
        port = dataclasses.replace(port, **{k: (v[1] if isinstance(v, tuple) else v)
                                            for k, v in changes.items()})
    return ref, port


def wide_capacity(ref, port, factor=8.0):
    """Capacity wide enough that decode and forward drop nothing (the
    reference's keystone test does the same for its MoE archs)."""
    if port.moe is None:
        return ref, port
    return (dataclasses.replace(ref, moe=dataclasses.replace(ref.moe, capacity_factor=factor)),
            dataclasses.replace(port, moe=dataclasses.replace(port.moe, capacity_factor=factor)))


def as_bf16(ref, port):
    return (dataclasses.replace(ref, dtype=jnp.bfloat16),
            dataclasses.replace(port, dtype=torch.bfloat16))


def ref_weights(ref_cfg, seed=0):
    """The reference's `init_lm` tree and the port's tree of the same
    weights (through `lm_params_from_numpy`, on the CPU)."""
    params = rtf.init_lm(jax.random.key(seed), ref_cfg)
    return params, jax.tree.map(np.asarray, params)


def port_weights(np_tree, port_cfg):
    return tf.lm_params_from_numpy(np_tree, port_cfg, device="cpu")


def tokens(vocab, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol, msg=""):
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(),
                               np.asarray(want, dtype=np.float32), rtol=tol, atol=tol,
                               err_msg=msg)


def head(params):
    return params["head"] if "head" in params else params["embed"].T


class RefServe:
    """The reference's prefill and decode_step, jitted once per config."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.prefill = jax.jit(lambda p, tk, max_len: rtf.prefill(p, cfg, tk, max_len),
                               static_argnums=2)
        self.decode = jax.jit(lambda p, c, tk: rtf.decode_step(p, cfg, c, tk))
        self.forward = jax.jit(lambda p, tk: rtf.forward(p, cfg, tk))
