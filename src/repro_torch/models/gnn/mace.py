"""MACE, higher-order equivariant message passing (Batatia et al.,
arXiv:2206.07697): the counterpart of `repro.models.gnn.mace`.  Config: 2
layers, 128 channels, l_max=2, correlation order 3, n_rbf=8, E(3)-ACE
product basis.

* Features are dicts {l: (N, 2l+1, C)} of real-spherical-harmonic irreps.
* Equivariant bilinear couplings use real Gaunt tensors (∫ Y Y Y dΩ),
  computed once by Gauss–Legendre × uniform-φ quadrature (exact for l ≤ 2
  products), plus the Levi-Civita tensor for the parity-odd 1⊗1→1 (cross
  product) path; each has unit Frobenius norm.  The list and its order are
  the reference's (`coupling_tensors`, a copy of its numpy code): the order
  fixes the layout of the radial MLP's output and the rows of w_b2 / w_b3.
* Interaction: A_i[l3] = Σ_j Σ_paths R_p(r_ij) · (Y_l1(r̂_ij) ⊗ h_j[l2])_l3,
  a radial Bessel basis (8) with a polynomial cutoff, per-path per-channel
  MLP weights.
* ACE product basis: B2 = (A ⊗ A), B3 = (B2 ⊗ A), correlation order 3, with
  per-path channel weights, linearly mixed into the message.
* Readout: the invariant (l=0) channel -> per-node energy; the energy is
  its sum, rotation-invariant by construction.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core import prng
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.gnn.common import MLP, segment_sum

LMAX = 2
Feats = Dict[int, torch.Tensor]


# --------------------------------------------------------------------------
# real spherical harmonics (unit vectors), l ≤ 2
# --------------------------------------------------------------------------

def real_sph_harm(unit: torch.Tensor) -> Dict[int, torch.Tensor]:
    """unit: (..., 3) unit vectors -> {l: (..., 2l+1)} orthonormal RSH."""
    x, y, z = unit[..., 0], unit[..., 1], unit[..., 2]
    c0 = 0.28209479177387814           # 1/(2 sqrt(pi))
    c1 = 0.4886025119029199
    c2a = 1.0925484305920792
    c2b = 0.31539156525252005
    c2c = 0.5462742152960396
    y0 = torch.full_like(x, c0)[..., None]
    y1 = torch.stack([c1 * y, c1 * z, c1 * x], dim=-1)
    y2 = torch.stack([c2a * x * y, c2a * y * z, c2b * (3 * z * z - 1.0), c2a * x * z,
                      c2c * (x * x - y * y)], dim=-1)
    return {0: y0, 1: y1, 2: y2}


def _np_sph(l: int, pts: np.ndarray) -> np.ndarray:
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    if l == 0:
        return np.stack([np.full_like(x, 0.28209479177387814)], axis=-1)
    if l == 1:
        c = 0.4886025119029199
        return np.stack([c * y, c * z, c * x], axis=-1)
    c2a, c2b, c2c = 1.0925484305920792, 0.31539156525252005, 0.5462742152960396
    return np.stack(
        [c2a * x * y, c2a * y * z, c2b * (3 * z * z - 1), c2a * x * z,
         c2c * (x * x - y * y)], axis=-1)


@lru_cache(maxsize=1)
def coupling_tensors() -> List[Tuple[int, int, int, np.ndarray]]:
    """All non-zero equivariant couplings (l1, l2, l3, K) for l ≤ LMAX:
    Gaunt tensors from quadrature (parity-even) + Levi-Civita for (1,1,1).
    Each K has unit Frobenius norm."""
    # Gauss-Legendre in cosθ (16 pts) × uniform φ (32 pts): exact for the
    # ≤ degree-6 polynomial integrands arising from l ≤ 2 triples.
    xs, wx = np.polynomial.legendre.leggauss(16)
    phis = np.linspace(0, 2 * np.pi, 32, endpoint=False)
    wphi = 2 * np.pi / len(phis)
    ct = xs[:, None]
    st = np.sqrt(1 - ct ** 2)
    pts = np.stack(
        [
            (st * np.cos(phis)[None, :]),
            (st * np.sin(phis)[None, :]),
            np.broadcast_to(ct, (16, len(phis))),
        ],
        axis=-1,
    ).reshape(-1, 3)
    w = (wx[:, None] * wphi * np.ones((1, len(phis)))).reshape(-1)

    Y = {l: _np_sph(l, pts) for l in range(LMAX + 1)}
    out: List[Tuple[int, int, int, np.ndarray]] = []
    for l1 in range(LMAX + 1):
        for l2 in range(LMAX + 1):
            for l3 in range(LMAX + 1):
                if not (abs(l1 - l2) <= l3 <= l1 + l2):
                    continue
                K = np.einsum("pm,pn,pk,p->mnk", Y[l1], Y[l2], Y[l3], w)
                if np.max(np.abs(K)) < 1e-9:
                    continue
                out.append((l1, l2, l3, (K / np.linalg.norm(K)).astype(np.float32)))
    # parity-odd 1 ⊗ 1 → 1: the cross product, missing from Gaunt
    eps = np.zeros((3, 3, 3), np.float32)
    for a, b, c, s in [(0, 1, 2, 1), (1, 2, 0, 1), (2, 0, 1, 1),
                       (1, 0, 2, -1), (2, 1, 0, -1), (0, 2, 1, -1)]:
        eps[a, b, c] = s
    out.append((1, 1, 1, eps / np.linalg.norm(eps)))
    return out


def couple(x: torch.Tensor, y: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Channel-wise equivariant product: (…, 2l1+1, C) ⊗ (…, 2l2+1, C) ->
    (…, 2l3+1, C), as one matmul of K over the outer product's (m, n)."""
    m, n, k = K.shape
    outer = (x[..., :, None, :] * y[..., None, :, :]).flatten(-3, -2)   # (…, m·n, C)
    return torch.matmul(K.reshape(m * n, k).T, outer)


def couple_edge(y_e: torch.Tensor, h_e: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """`couple` of a harmonic Y (E, 2l1+1), the same on every channel, with
    h_e (E, 2l2+1, C): Y and K contract first, so no (E, m·n, C) product
    is formed."""
    t = torch.einsum("em,mnk->ekn", y_e, K)            # (E, 2l3+1, 2l2+1)
    return torch.bmm(t, h_e)


# --------------------------------------------------------------------------
# radial basis
# --------------------------------------------------------------------------

def bessel_rbf(r: torch.Tensor, n_rbf: int, r_cut: float) -> torch.Tensor:
    """Sinc-Bessel radial basis with smooth polynomial cutoff. r: (E,)."""
    rs = torch.clamp(r, min=1e-6)[:, None]
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=r.device)
    basis = (2.0 / r_cut) ** 0.5 * torch.sin(n * np.pi * rs / r_cut) / rs
    u = torch.clamp(r / r_cut, 0, 1)[:, None]
    fcut = 1 - 10 * u ** 3 + 15 * u ** 4 - 6 * u ** 5   # C² polynomial cutoff
    return basis * fcut


# --------------------------------------------------------------------------
# model
# --------------------------------------------------------------------------

class MACELayer(nn.Module):
    def __init__(self, channels: int, n_rbf: int, n_paths: int, *, keys,
                 device: torch.device):
        super().__init__()
        C = channels
        k0, k1, k2, k3 = keys

        def normal(k, shape, scale):
            return nn.Parameter(prng.normal(k, shape, device) * scale)

        self.radial = MLP((n_rbf, 64, n_paths * C), key=k0, device=device)
        # per-path channel mixers for the ACE products
        self.w_b2 = normal(k1, (n_paths, C), C ** -0.5)
        self.w_b3 = normal(k2, (n_paths, C), C ** -0.5)
        # message mix (A ‖ B2 ‖ B3 -> C) and residual, per l (keys str(l))
        self.mix = nn.ParameterDict(
            {str(l): normal(prng.fold_in(k3, l), (3 * C, C), (3 * C) ** -0.5)
             for l in range(LMAX + 1)})
        self.res = nn.ParameterDict(
            {str(l): normal(prng.fold_in(k3, 10 + l), (C, C), C ** -0.5)
             for l in range(LMAX + 1)})


class MACE(nn.Module):
    """`embed`, `layers[i]` (`radial`, `w_b2`, `w_b3`, `mix`, `res`) and
    `readout` (C -> 16 -> n_out), f32, drawn as `mace_init(key)` draws them
    on `device`: layer t under keys 4t to 4t + 3 of `split(key, 4 n_layers
    + 2)` (`mix` / `res` of l under `fold_in` of the fourth by l / 10 +
    l), `embed` under the second last.  n_out = 1 is the energy readout,
    under the last key; the configs' classification cells widen it, and
    draw it under `fold_in(key, 99)` as the reference's `configs.mace`
    does.  `key` defaults to `prng.key(seed)`."""

    def __init__(self, d_in: int, channels: int = 128, n_layers: int = 2, n_rbf: int = 8,
                 r_cut: float = 5.0, n_out: int = 1, *, seed: int = 0,
                 key: Optional[prng.Key] = None, device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        key = prng.key(seed) if key is None else key
        ks = prng.split(key, 4 * n_layers + 2)
        self.n_rbf, self.r_cut = n_rbf, r_cut
        n_paths = len(coupling_tensors())
        self.layers = nn.ModuleList(
            MACELayer(channels, n_rbf, n_paths, keys=ks[4 * t:4 * t + 4], device=dev)
            for t in range(n_layers))
        self.embed = MLP((d_in, channels), key=ks[-2], device=dev)
        self.readout = MLP((channels, 16, n_out),
                           key=ks[-1] if n_out == 1 else prng.fold_in(key, 99), device=dev)
        for p, (*_, K) in enumerate(coupling_tensors()):
            self.register_buffer(f"coupling_{p}", torch.from_numpy(K).to(dev), persistent=False)

    @property
    def couplings(self) -> List[torch.Tensor]:
        """The coupling tensors K, in `coupling_tensors()`'s order."""
        return [getattr(self, f"coupling_{p}") for p in range(len(coupling_tensors()))]

    def forward(self, feats: torch.Tensor, coords: torch.Tensor, senders: torch.Tensor,
                receivers: torch.Tensor, mask: torch.Tensor, *, split=None
                ) -> Tuple[Feats, torch.Tensor]:
        """feats (N, d_in), coords (N, 3) -> (h {l: (N, 2l+1, C)}, readout
        (N, n_out)); the reference's energy is the readout's sum.  `split`:
        a `dist.graph.GraphSplit`, the inputs and outputs this rank's vertex
        rows, the edges the split's; the senders' coordinates are gathered
        once, each h[l] once a layer."""
        n = feats.shape[0]
        s = senders.long()
        h: Feats = {0: self.embed(feats)[:, None, :]}
        C = h[0].shape[-1]

        src = coords if split is None else split.gather(coords)
        rel = coords[receivers.long()] - src[s]
        r = torch.sqrt(torch.sum(rel * rel, dim=-1) + 1e-12)
        unit = rel / torch.clamp(r, min=1e-6)[:, None]
        Y = real_sph_harm(unit)
        rbf = bessel_rbf(r, self.n_rbf, self.r_cut) * mask.to(torch.float32)[:, None]

        for layer in self.layers:
            h_src = h if split is None else {l: split.gather(x) for l, x in h.items()}
            A = self._interaction(layer, h_src, Y, rbf, s, receivers, mask, n)
            # every l present for the product basis
            for l in range(LMAX + 1):
                A.setdefault(l, feats.new_zeros((n, 2 * l + 1, C)))
            B2, B3 = self._ace_products(layer, A)
            h_new: Feats = {}
            for l in range(LMAX + 1):
                parts = torch.cat([A[l], B2.get(l, torch.zeros_like(A[l])),
                                   B3.get(l, torch.zeros_like(A[l]))], dim=-1)   # (N, 2l+1, 3C)
                m = parts @ layer.mix[str(l)]
                h_new[l] = m + h[l] @ layer.res[str(l)] if l in h else m
            h = h_new
        return h, self.readout(h[0][:, 0, :])

    def _interaction(self, layer: MACELayer, h: Feats, Y: Dict[int, torch.Tensor],
                     rbf: torch.Tensor, s: torch.Tensor, receivers: torch.Tensor,
                     mask: torch.Tensor, n: int) -> Feats:
        """A-features: radial-weighted (Y ⊗ h_j) couplings, scattered to
        nodes; `h` the senders' features (every rank's, gathered, on a
        split graph)."""
        C = h[0].shape[-1]
        R = layer.radial(rbf).reshape(rbf.shape[0], len(coupling_tensors()), C)
        w_edge = mask.to(torch.float32)[:, None, None]
        A: Feats = {}
        for p, ((l1, l2, l3, _), K) in enumerate(zip(coupling_tensors(), self.couplings)):
            if l2 not in h:
                continue
            m = couple_edge(Y[l1], h[l2][s], K) * R[:, p][:, None, :] * w_edge
            A[l3] = A.get(l3, 0) + segment_sum(m, receivers, n)
        return A

    def _ace_products(self, layer: MACELayer, A: Feats) -> Tuple[Feats, Feats]:
        """Correlation-2 and -3 symmetric products of the A basis."""
        B2: Feats = {}
        for p, ((l1, l2, l3, _), K) in enumerate(zip(coupling_tensors(), self.couplings)):
            if l1 in A and l2 in A:
                B2[l3] = B2.get(l3, 0) + couple(A[l1], A[l2], K) * layer.w_b2[p]
        B3: Feats = {}
        for p, ((l1, l2, l3, _), K) in enumerate(zip(coupling_tensors(), self.couplings)):
            if l1 in B2 and l2 in A:
                B3[l3] = B3.get(l3, 0) + couple(B2[l1], A[l2], K) * layer.w_b3[p]
        return B2, B3
