"""Closed-form small-matrix inverses (3x3 adjugate, 4x4 affine, 4x4
cofactor), batched over leading dims. Port of `arah_tpu/core/linalg.py`."""
from __future__ import annotations

import functools

import torch


def inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Batched adjugate inverse of (..., 3, 3)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    D = -(b * i - c * h)
    E = a * i - c * g
    F = -(a * h - b * g)
    G = b * f - c * e
    H = -(a * f - c * d)
    I = a * e - b * d
    det = a * A + b * B + c * C
    adj = torch.stack([
        torch.stack([A, D, G], dim=-1),
        torch.stack([B, E, H], dim=-1),
        torch.stack([C, F, I], dim=-1)], dim=-2)
    return adj / det[..., None, None]


def det3x3(m: torch.Tensor) -> torch.Tensor:
    """Batched determinant of (..., 3, 3), by `inv3x3`'s cofactors in its
    order, so that it is the determinant `inv3x3` divides by."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    return a * (e * i - f * h) + b * (-(d * i - f * g)) + c * (d * h - e * g)


@functools.lru_cache(maxsize=None)
def device_const(values: tuple, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """`torch.tensor(values)` (nested tuples of Python numbers) on
    `device`, made once a (values, dtype, device) and then shared: a copy
    from the host waits for the device's stream, so a constant of the
    step is copied on its first use only. Callers never write to it."""
    return torch.tensor(values, dtype=dtype, device=device)


def inv_affine(m: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., 4, 4) affine transforms with last row [0,0,0,1]."""
    A_inv = inv3x3(m[..., :3, :3])
    t_inv = -torch.einsum('...ij,...j->...i', A_inv, m[..., :3, 3])
    top = torch.cat([A_inv, t_inv[..., None]], dim=-1)
    bottom = device_const((0.0, 0.0, 0.0, 1.0), m.dtype,
                          m.device).expand(m.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def inv4x4(m: torch.Tensor) -> torch.Tensor:
    """General batched 4x4 inverse via cofactor expansion."""
    m00, m01, m02, m03 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2], m[..., 0, 3]
    m10, m11, m12, m13 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2], m[..., 1, 3]
    m20, m21, m22, m23 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2], m[..., 2, 3]
    m30, m31, m32, m33 = m[..., 3, 0], m[..., 3, 1], m[..., 3, 2], m[..., 3, 3]

    s0 = m00 * m11 - m10 * m01
    s1 = m00 * m12 - m10 * m02
    s2 = m00 * m13 - m10 * m03
    s3 = m01 * m12 - m11 * m02
    s4 = m01 * m13 - m11 * m03
    s5 = m02 * m13 - m12 * m03

    c5 = m22 * m33 - m32 * m23
    c4 = m21 * m33 - m31 * m23
    c3 = m21 * m32 - m31 * m22
    c2 = m20 * m33 - m30 * m23
    c1 = m20 * m32 - m30 * m22
    c0 = m20 * m31 - m30 * m21

    det = s0 * c5 - s1 * c4 + s2 * c3 + s3 * c2 - s4 * c1 + s5 * c0
    inv_det = 1.0 / det

    rows = [
        [(m11 * c5 - m12 * c4 + m13 * c3), (-m01 * c5 + m02 * c4 - m03 * c3),
         (m31 * s5 - m32 * s4 + m33 * s3), (-m21 * s5 + m22 * s4 - m23 * s3)],
        [(-m10 * c5 + m12 * c2 - m13 * c1), (m00 * c5 - m02 * c2 + m03 * c1),
         (-m30 * s5 + m32 * s2 - m33 * s1), (m20 * s5 - m22 * s2 + m23 * s1)],
        [(m10 * c4 - m11 * c2 + m13 * c0), (-m00 * c4 + m01 * c2 - m03 * c0),
         (m30 * s4 - m31 * s2 + m33 * s0), (-m20 * s4 + m21 * s2 - m23 * s0)],
        [(-m10 * c3 + m11 * c1 - m12 * c0), (m00 * c3 - m01 * c1 + m02 * c0),
         (-m30 * s3 + m31 * s1 - m32 * s0), (m20 * s3 - m21 * s1 + m22 * s0)],
    ]
    return torch.stack([torch.stack([r * inv_det for r in row], dim=-1)
                        for row in rows], dim=-2)
