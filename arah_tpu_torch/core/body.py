"""Canonical-space body math: LBS point skinning, hierarchical softmax,
Vitruvian 02v transforms and canonical coordinate normalization.
Port of `arah_tpu/core/body.py`."""
from __future__ import annotations

import numpy as np
import torch

from arah_tpu_torch.core.linalg import device_const, inv_affine


def skinning(x: torch.Tensor, w: torch.Tensor, tfs: torch.Tensor,
             inverse: bool = False):
    """Linear blend skinning of points.

    x: (..., N, 3); w: (..., N, J); tfs: (..., J, 4, 4).
    Returns (skinned (..., N, 3), per-point transforms (..., N, 4, 4)).
    """
    w_tf = torch.einsum('...pn,...nij->...pij', w, tfs)
    tf = inv_affine(w_tf) if inverse else w_tf
    x_out = torch.einsum('...pij,...pj->...pi', tf[..., :3, :3], x) \
        + tf[..., :3, 3]
    return x_out, w_tf


def apply_transform(T: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) homogeneous transforms to (..., 3) points."""
    return torch.einsum('...ij,...j->...i', T[..., :3, :3], x) + T[..., :3, 3]


def normalize_canonical_points(pts, coord_min, coord_max, center):
    """SMPL canonical metric space -> normalized [-1,1]^3 SDF space."""
    padding = (coord_max - coord_min) * 0.05
    pts = pts - center
    pts = (pts - coord_min + padding) / (coord_max - coord_min) / 1.1
    return (pts - 0.5) * 2.0


def unnormalize_canonical_points(pts, coord_min, coord_max, center):
    """Inverse of :func:`normalize_canonical_points`."""
    padding = (coord_max - coord_min) * 0.05
    return (pts / 2.0 + 0.5) * 1.1 * (coord_max - coord_min) \
        + coord_min - padding + center


def sdf_to_metric(sdf, coord_min, coord_max):
    """Normalized-SDF value -> metric (canonical-space) distance."""
    return sdf / 2.0 * 1.1 * (coord_max - coord_min)


def hierarchical_softmax(x: torch.Tensor) -> torch.Tensor:
    """SNARF hierarchical softmax over the SMPL kinematic tree:
    (..., 25) logits -> (..., 24) probabilities."""
    sig = torch.sigmoid

    def sm3(a, b, c):
        return torch.softmax(torch.stack([a, b, c], dim=-1), dim=-1)

    c = [x[..., i] for i in range(25)]
    p = [None] * 24

    root_gate = sig(c[0])
    hips = sm3(c[1], c[2], c[3])
    p[1] = root_gate * hips[..., 0]
    p[2] = root_gate * hips[..., 1]
    p[3] = root_gate * hips[..., 2]
    p[0] = 1.0 - root_gate

    for child, parent in ((4, 1), (5, 2), (6, 3), (7, 4), (8, 5), (9, 6),
                          (10, 7), (11, 8)):
        s = sig(c[child])
        p[child] = p[parent] * s
        p[parent] = p[parent] * (1 - s)

    spine_gate = sig(c[24])
    spine = sm3(c[12], c[13], c[14])
    p[12] = p[9] * spine_gate * spine[..., 0]
    p[13] = p[9] * spine_gate * spine[..., 1]
    p[14] = p[9] * spine_gate * spine[..., 2]
    p[9] = p[9] * (1 - spine_gate)

    for child, parent in ((15, 12), (16, 13), (17, 14), (18, 16),
                          (19, 17), (20, 18), (21, 19), (22, 20), (23, 21)):
        s = sig(c[child])
        p[child] = p[parent] * s
        p[parent] = p[parent] * (1 - s)
    return torch.stack(p, dim=-1)


def rotation_z(degrees: float) -> np.ndarray:
    """Rz rotation matrix (host-side numpy, float64)."""
    th = np.deg2rad(degrees)
    c, s = np.cos(th), np.sin(th)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]],
                    dtype=np.float64)


def get_02v_bone_transforms(Jtr) -> np.ndarray:
    """(24, 4, 4) float32 A-pose -> Vitruvian leg-chain transforms from
    (24, 3) rest joints, in numpy (float64 inside), for the data path: the
    two leg chains rotated by +-45 degrees about z, translations
    accumulated down each chain. The port's copy of
    `arah_tpu/core/body.py:get_02v_bone_transforms`."""
    Jtr = np.asarray(Jtr, dtype=np.float64)
    out = np.tile(np.eye(4), (24, 1, 1))
    for chain, rot in (([1, 4, 7, 10], rotation_z(45.0)),
                       ([2, 5, 8, 11], rotation_z(-45.0))):
        for i, j_idx in enumerate(chain):
            out[j_idx, :3, :3] = rot
            t = Jtr[j_idx].copy()
            if i > 0:
                parent = chain[i - 1]
                t = rot @ (t - Jtr[parent]) + out[parent, :3, 3]
            out[j_idx, :3, 3] = t
        out[chain, :3, 3] -= Jtr[chain] @ rot.T
    return out.astype(np.float32)


def get_02v_bone_transforms_jnp(Jtr: torch.Tensor) -> torch.Tensor:
    """(24, 4, 4) A-pose -> Vitruvian leg-chain transforms from (24, 3)
    rest joints (the name keeps the JAX package's, for the reader)."""
    out = torch.eye(4, dtype=Jtr.dtype, device=Jtr.device).repeat(24, 1, 1)
    for chain, deg in (([1, 4, 7, 10], 45.0), ([2, 5, 8, 11], -45.0)):
        rot = device_const(tuple(map(tuple, rotation_z(deg).tolist())),
                           Jtr.dtype, Jtr.device)
        ts = []
        for i, j_idx in enumerate(chain):
            t = Jtr[j_idx]
            if i > 0:
                t = rot @ (t - Jtr[chain[i - 1]]) + ts[i - 1]
            ts.append(t)
        ts = torch.stack(ts) - Jtr[device_const(
            tuple(chain), torch.long, Jtr.device)] @ rot.T
        for i, j_idx in enumerate(chain):
            out[j_idx, :3, :3] = rot
            out[j_idx, :3, 3] = ts[i]
    return out
