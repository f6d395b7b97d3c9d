"""Real spherical harmonics (l ≤ 2) + numerically derived Gaunt/CG couplings:
the port of the reference's `repro.models.equivariant`.

Self-contained E(3)-equivariance machinery for the MACE architecture (no
e3nn): the real-basis Clebsch–Gordan (Gaunt) coefficients are computed
once, in numpy, by quadrature of ∫ Y_{l1 m1} Y_{l2 m2} Y_{l3 m3} dΩ on a
128×256 product Gauss–Legendre × uniform grid, exact to ~1e-12 for l ≤ 2.

Conventions: real spherical harmonics with Condon–Shortley-free real basis,
ordered m = -l..l; irrep slices concatenated [l=0 | l=1 | l=2] (dims 1,3,5).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from repro_torch.models.layers import sharded_view

L_MAX = 2
IRREP_DIMS = [2 * l + 1 for l in range(L_MAX + 1)]       # [1, 3, 5]
IRREP_OFF = np.concatenate([[0], np.cumsum(IRREP_DIMS)])  # [0,1,4,9]
SH_DIM = int(IRREP_OFF[-1])                               # 9


def real_sph_harm_l2(xyz, np_mod=torch):
    """Real spherical harmonics Y_lm(r̂) for l=0..2. xyz: (..., 3) unit
    vectors → (..., 9): a tensor (np_mod=torch, xyz's dtype and device)
    or a numpy array (np_mod=np). The constants are float64 numbers,
    applied in the reference's order."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    c0 = 0.5 * np.sqrt(1.0 / np.pi)
    c1 = float(np.sqrt(3.0 / (4 * np.pi)))
    c2 = float(0.5 * np.sqrt(15 / np.pi))
    out = [
        np.full(x.shape, c0) if np_mod is np else torch.full_like(x, c0),
        c1 * y, c1 * z, c1 * x,
        c2 * x * y,
        c2 * y * z,
        float(0.25 * np.sqrt(5 / np.pi)) * (3 * z * z - 1.0),
        c2 * x * z,
        float(0.25 * np.sqrt(15 / np.pi)) * (x * x - y * y),
    ]
    return np.stack(out, axis=-1) if np_mod is np else torch.stack(out, -1)


@lru_cache(maxsize=1)
def gaunt_tensor() -> np.ndarray:
    """G[i, j, k] = ∫ Y_i Y_j Y_k dΩ over the 9-dim l≤2 basis (numpy)."""
    n_theta, n_phi = 128, 256
    # Gauss-Legendre in cos(theta)
    ct, wt = np.polynomial.legendre.leggauss(n_theta)
    phi = (np.arange(n_phi) + 0.5) * (2 * np.pi / n_phi)
    wp = 2 * np.pi / n_phi
    st = np.sqrt(1 - ct ** 2)
    xyz = np.stack(
        [st[:, None] * np.cos(phi)[None, :],
         st[:, None] * np.sin(phi)[None, :],
         np.broadcast_to(ct[:, None], (n_theta, n_phi))], axis=-1)
    ys = real_sph_harm_l2(xyz, np_mod=np)          # (T, P, 9)
    w = wt[:, None] * wp                           # (T, 1)
    g = np.einsum("tpi,tpj,tpk,tp->ijk", ys, ys, ys,
                  np.broadcast_to(w, ys.shape[:2]))
    g[np.abs(g) < 1e-10] = 0.0
    return g


def irrep_slices():
    return [slice(int(IRREP_OFF[l]), int(IRREP_OFF[l + 1]))
            for l in range(L_MAX + 1)]


def tensor_product(a: torch.Tensor, b: torch.Tensor,
                   g: torch.Tensor) -> torch.Tensor:
    """Equivariant product: out_k = Σ_ij G[i,j,k] a_i b_j, per channel.

    a, b: (..., 9, C); g: (9, 9, 9) → (..., 9, C). The Gaunt contraction is
    the real-basis CG coupling truncated back to l ≤ 2. The order is fixed
    here, not left to an einsum path: the outer product a_i b_j per
    channel, (..., C, 81), then one matrix product with G as (81, 9). The
    intermediate holds 81 floats a row and channel (nine times the
    output); autograd keeps only a and b for the backward (G is a
    constant)."""
    p = a.transpose(-1, -2).unsqueeze(-1) * b.transpose(-1, -2).unsqueeze(-2)
    # a DTensor's (i, j) may be split unevenly (9 over 2 ranks): gathered
    p = sharded_view(p, tuple(p.shape[:-2]) + (SH_DIM * SH_DIM,))
    out = p @ g.reshape(SH_DIM * SH_DIM, SH_DIM).to(p.dtype)
    return out.transpose(-1, -2)
