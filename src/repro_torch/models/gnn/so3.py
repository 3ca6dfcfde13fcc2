"""SO(3) machinery for eSCN-style equivariant networks, the port of
``repro/models/gnn/so3.py``.

- Real spherical harmonics Y_lm via associated-Legendre recursion
  (unrolled over l <= l_max; batched and differentiable), on numpy
  arrays for the host precompute and on torch tensors on the device.
- Real Wigner rotation matrices D^l(R) built numerically from the SH
  evaluator: with K fixed generic unit vectors u_k, ``Y_l(R u) = D_l(R)
  Y_l(u)`` gives ``D_l = (pinv(A) B)^T`` with A = Y_l(u_k), B = Y_l(R
  u_k). pinv(A) is computed once per l on the host in float64 by numpy,
  as the reference computes it, so the constants are the reference's bit
  for bit.
- The edge-alignment rotation r_hat -> z_hat (Rodrigues).

Index convention: coefficients for degree l are ordered m = -l..l; the
flat index of (l, m) is l*l + l + m.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch


def _double_factorial(n: int) -> float:
    out = 1.0
    while n > 1:
        out *= n
        n -= 2
    return out


def real_sph_harm(vec, l_max: int, xp=torch):
    """Real orthonormal SH of unit vectors. vec (..., 3) -> (...,
    (l_max+1)^2), a torch tensor (``xp=torch``) or a numpy array
    (``xp=np``, the host precompute).

    Uses x=sinθcosφ, y=sinθsinφ, z=cosθ, the reference's recursions in
    its order of operations: associated Legendre values divided by
    sin^m θ (polynomials in cosθ, finite at the poles) and the
    Chebyshev-style recurrence on cos(mφ)·sin^m θ, sin(mφ)·sin^m θ, so
    no φ is ever formed.
    """
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    ct = z                                   # cosθ
    # c_m = sin^m θ cos(mφ), s_m = sin^m θ sin(mφ)
    c = [xp.ones_like(x)]
    s = [xp.zeros_like(x)]
    for m in range(1, l_max + 1):
        c_prev, s_prev = c[-1], s[-1]
        c.append(c_prev * x - s_prev * y)
        s.append(s_prev * x + c_prev * y)
    # P̄_l^m = P_l^m(cosθ) / sin^m θ
    pbar: dict = {}
    for m in range(0, l_max + 1):
        pmm = _double_factorial(2 * m - 1) * xp.ones_like(x)  # no Condon-Shortley
        pbar[(m, m)] = pmm
        if m < l_max:
            pbar[(m + 1, m)] = ct * (2 * m + 1) * pmm
        for l in range(m + 2, l_max + 1):
            pbar[(l, m)] = ((2 * l - 1) * ct * pbar[(l - 1, m)]
                            - (l + m - 1) * pbar[(l - 2, m)]) / (l - m)
    out = []
    for l in range(l_max + 1):
        row = [None] * (2 * l + 1)
        for m in range(0, l + 1):
            norm = math.sqrt((2 * l + 1) / (4 * math.pi)
                             * math.factorial(l - m) / math.factorial(l + m))
            if m == 0:
                row[l] = norm * pbar[(l, 0)]
            else:
                base = math.sqrt(2.0) * norm * pbar[(l, m)]
                row[l + m] = base * c[m]
                row[l - m] = base * s[m]
        out.extend(row)
    if xp is np:
        return np.stack(out, axis=-1)
    return torch.stack(out, dim=-1)


def lm_index(l: int, m: int) -> int:
    return l * l + l + m


def n_coeff_full(l_max: int) -> int:
    return (l_max + 1) ** 2


# ---------------------------------------------------------------------------
# Numeric Wigner matrices
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _sample_pinvs(l_max: int, k_extra: int = 2):
    """Fixed generic sample points + per-l pinv(Y_l(u_k)) (host, cached):
    numpy ``RandomState(0)`` points, their SH in float64, ``pinv`` cast
    to float32, the reference's constants bit for bit."""
    rng = np.random.RandomState(0)
    pts = rng.randn(2 * l_max + 1 + k_extra, 3)
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    ys = np.asarray(real_sph_harm(pts.astype(np.float64), l_max, xp=np))
    pinvs = []
    for l in range(l_max + 1):
        a = ys[:, l * l:(l + 1) * (l + 1)]
        pinvs.append(np.linalg.pinv(a).astype(np.float32))
    return np.asarray(pts, np.float32), tuple(pinvs)


def wigner_from_rotation(rot: torch.Tensor, l_max: int) -> list:
    """rot (..., 3, 3) float32 -> [D_0 (..., 1, 1), D_1 (..., 3, 3), ...,
    D_lmax], float32, with Y_l(R u) = D_l(R) @ Y_l(u) for every unit u."""
    pts, pinvs = _sample_pinvs(l_max)
    pts = torch.from_numpy(pts).to(rot.device)
    rotated = torch.einsum("...ij,kj->...ki", rot, pts)     # (..., K, 3)
    yr = real_sph_harm(rotated, l_max)                       # (..., K, n_lm)
    out = []
    for l in range(l_max + 1):
        b = yr[..., l * l:(l + 1) * (l + 1)]                 # (..., K, 2l+1)
        p = torch.from_numpy(pinvs[l]).to(rot.device)
        out.append(torch.einsum("mk,...kn->...nm", p, b))    # (pinv @ B)^T
    return out


def align_to_z(r_hat: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Rodrigues rotation R with R @ r_hat = z_hat. r_hat (..., 3).

    Two edge cases, as the reference: a direction within 1e-6 of -z gets
    the flip about x by pi, and a zero vector (a zero-length edge) the
    identity."""
    z = torch.zeros_like(r_hat)
    z[..., 2] = 1.0
    v = torch.linalg.cross(r_hat, z, dim=-1)
    cos = r_hat[..., 2]
    vx = _skew(v)
    denom = torch.clamp_min(1.0 + cos, eps)[..., None, None]
    eye = torch.eye(3, dtype=r_hat.dtype, device=r_hat.device)
    r = eye + vx + (vx @ vx) / denom
    flip = torch.tensor([[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]],
                        dtype=r_hat.dtype, device=r_hat.device)
    anti = (cos < -1.0 + 1e-6)[..., None, None]
    return torch.where(anti, flip, r)


def _skew(v: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([zero, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], zero, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], zero], -1),
    ], -2)


# ---------------------------------------------------------------------------
# m-truncation bookkeeping (|m| <= m_max in the edge frame)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=32)
def trunc_indices(l_max: int, m_max: int) -> tuple:
    """Returns (flat_idx, l_of, m_of) int32 numpy arrays for the
    coefficients with |m| <= m_max, l ascending, then m."""
    idx, ls, ms = [], [], []
    for l in range(l_max + 1):
        mm = min(l, m_max)
        for m in range(-mm, mm + 1):
            idx.append(lm_index(l, m))
            ls.append(l)
            ms.append(m)
    return (np.asarray(idx, np.int32), np.asarray(ls, np.int32),
            np.asarray(ms, np.int32))


def block_rotate(x: torch.Tensor, wig: list,
                 transpose: bool = False) -> torch.Tensor:
    """Apply the block-diagonal Wigner rotation. x (..., n_lm, C)."""
    outs = []
    for l, d in enumerate(wig):
        seg = x[..., l * l:(l + 1) * (l + 1), :]
        eq = "...nm,...mc->...nc" if not transpose else "...mn,...mc->...nc"
        outs.append(torch.einsum(eq, d, seg))
    return torch.cat(outs, dim=-2)
