"""repro_torch — TC-MIS in PyTorch, with hand-written Hopper kernels.

The PyTorch/CUDA port of the JAX package `repro`, which stays the reference
it is held against.  The layout mirrors it so a reader finds each
counterpart:

  graphs/   `Graph`, `from_edges`, the synthetic generators
  core/     BSR tiling, priorities, segment ops, the round engines and the
            convergence loop
  api/      `SolveOptions`, `Plan`, `Solver`
  hopper/   the CUDA kernels' wrappers, their plain-torch versions and the
            nvcc build (sources in `csrc/`)

Entry points run on the CUDA device unless the caller asks for the CPU
(`device="cpu"`); nothing falls back to the CPU on its own.  This package
imports torch, numpy and scipy, never jax and never `repro`.
"""
from repro_torch.api import Plan, SolveOptions, SolveResult, Solver

__all__ = ["Plan", "SolveOptions", "SolveResult", "Solver"]
