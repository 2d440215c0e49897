"""SMPL linear blend skinning building blocks in PyTorch.
A frozen copy of the port's `core/smpl.py` (batched, leading batch dim B)."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# SMPL kinematic tree (parent of each of the 24 joints)
SMPL_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18,
     19, 20, 21], dtype=np.int32)

NUM_JOINTS = 24


class SmplModel(NamedTuple):
    """Static SMPL template data (numpy arrays or tensors)."""
    v_template: object   # (V, 3)
    shapedirs: object    # (V, 3, n_betas)
    posedirs: object     # (23*9, V*3)
    J_regressor: object  # (24, V)
    lbs_weights: object  # (V, 24)
    parents: object      # (24,) int32
    faces: object        # (F, 3) int32


def batch_rodrigues(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle (N, 3) -> rotation matrices (N, 3, 3), with the
    reference's `+1e-8` inside the norm."""
    angle = torch.linalg.norm(aa + 1e-8, dim=1, keepdim=True)
    rot_dir = aa / angle
    cos = torch.cos(angle)[:, None]
    sin = torch.sin(angle)[:, None]
    rx, ry, rz = torch.split(rot_dir, 1, dim=1)
    zeros = torch.zeros_like(rx)
    K = torch.stack([zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros],
                    dim=1).reshape(-1, 3, 3)
    ident = torch.eye(3, dtype=aa.dtype, device=aa.device)[None]
    return ident + sin * K + (1.0 - cos) * (K @ K)


def transform_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) + (..., 3) -> homogeneous (..., 4, 4)."""
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                          device=R.device).expand(R.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def batch_rigid_transform(rot_mats: torch.Tensor, joints: torch.Tensor,
                          parents):
    """Compose the kinematic chain. rot_mats (B, J, 3, 3), joints
    (B, J, 3) -> (posed joints (B, J, 3), rel transforms A (B, J, 4, 4),
    abs transforms (B, J, 4, 4))."""
    parents = np.asarray(parents)
    has_parent = torch.as_tensor(parents >= 0, device=joints.device)
    rel_joints = joints - torch.where(
        has_parent[None, :, None], joints[:, np.maximum(parents, 0)],
        torch.zeros_like(joints))
    transforms_mat = transform_mat(rot_mats, rel_joints)

    chain = [transforms_mat[:, 0]]
    for i in range(1, parents.shape[0]):
        chain.append(chain[int(parents[i])] @ transforms_mat[:, i])
    transforms = torch.stack(chain, dim=1)
    posed_joints = transforms[:, :, :3, 3]

    joints_homo = torch.cat([joints, torch.zeros_like(joints[..., :1])],
                            dim=-1)
    init_bone = torch.einsum('bjik,bjk->bji', transforms, joints_homo)
    correction = torch.zeros_like(transforms)
    correction[..., :, 3] = init_bone
    return posed_joints, transforms - correction, transforms


def blend_shapes(betas: torch.Tensor, shape_disps: torch.Tensor):
    """(B, n_betas) x (V, 3, n_betas) -> (B, V, 3)."""
    return torch.einsum('bl,mkl->bmk', betas, shape_disps)


def vertices2joints(J_regressor: torch.Tensor, vertices: torch.Tensor):
    """(J, V) x (B, V, 3) -> (B, J, 3)."""
    return torch.einsum('bik,ji->bjk', vertices, J_regressor)


def smpl_to_device(model: SmplModel, device='cuda') -> SmplModel:
    """The model's arrays as tensors on `device` (float32, faces int32),
    so that `prepare_frame` copies nothing per call. `parents` stays a
    CPU int32 tensor: the kinematic chain is unrolled in Python, and a
    tree on the card would cost a device-to-host copy per frame."""
    def f32(a):
        return torch.as_tensor(np.array(a, np.float32) if not
                               torch.is_tensor(a) else a,
                               dtype=torch.float32, device=device)
    return SmplModel(
        v_template=f32(model.v_template), shapedirs=f32(model.shapedirs),
        posedirs=f32(model.posedirs), J_regressor=f32(model.J_regressor),
        lbs_weights=f32(model.lbs_weights),
        parents=torch.as_tensor(np.asarray(model.parents, np.int32)),
        faces=torch.as_tensor(np.asarray(model.faces, np.int32),
                              device=device))
