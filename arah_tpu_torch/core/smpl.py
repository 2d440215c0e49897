"""SMPL linear blend skinning building blocks in PyTorch.
Port of `arah_tpu/core/smpl.py` (batched, leading batch dim B)."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from arah_tpu_torch.core.linalg import device_const

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
    bottom = device_const((0.0, 0.0, 0.0, 1.0), R.dtype,
                          R.device).expand(R.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def batch_rigid_transform(rot_mats: torch.Tensor, joints: torch.Tensor,
                          parents):
    """Compose the kinematic chain. rot_mats (B, J, 3, 3), joints
    (B, J, 3) -> (posed joints (B, J, 3), rel transforms A (B, J, 4, 4),
    abs transforms (B, J, 4, 4))."""
    parents = np.asarray(parents)
    tree = tuple(int(p) for p in parents)
    has_parent = device_const(tuple(p >= 0 for p in tree), torch.bool,
                              joints.device)
    parent_idx = device_const(tuple(max(p, 0) for p in tree), torch.long,
                              joints.device)
    rel_joints = joints - torch.where(
        has_parent[None, :, None], joints[:, parent_idx],
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


class LbsOutput(NamedTuple):
    verts: torch.Tensor           # (B, V, 3) posed vertices (no trans)
    joints_posed: torch.Tensor    # (B, J, 3)
    joints_rest: torch.Tensor     # (B, J, 3)
    rel_transforms: torch.Tensor  # (B, J, 4, 4) bone transforms "A"
    abs_transforms: torch.Tensor  # (B, J, 4, 4)
    v_posed: torch.Tensor         # (B, V, 3) shaped + pose-blend-shaped


def lbs(model: SmplModel, betas: torch.Tensor, pose: torch.Tensor,
        apply_pose_blendshapes: bool = True) -> LbsOutput:
    """SMPL linear blend skinning of betas (B, n_betas) and axis-angle
    pose (B, 72), root first, on the model's device (`smpl_to_device`).
    Port of `arah_tpu/core/smpl.py:lbs`."""
    B = betas.shape[0]
    v_shaped = model.v_template[None] + blend_shapes(betas, model.shapedirs)
    J = vertices2joints(model.J_regressor, v_shaped)
    rot_mats = batch_rodrigues(pose.reshape(-1, 3)).reshape(B, -1, 3, 3)
    v_posed = v_shaped
    if apply_pose_blendshapes:
        ident = torch.eye(3, dtype=pose.dtype, device=pose.device)
        pose_feature = (rot_mats[:, 1:] - ident).reshape(B, -1)
        v_posed = v_shaped + (pose_feature @ model.posedirs).reshape(
            B, -1, 3)
    parents = model.parents.cpu() if torch.is_tensor(model.parents) \
        else model.parents
    J_transformed, A, abs_A = batch_rigid_transform(rot_mats, J, parents)
    T = (model.lbs_weights[None] @ A.reshape(B, NUM_JOINTS, 16)).reshape(
        B, -1, 4, 4)
    verts = torch.einsum('bvij,bvj->bvi', T[..., :3, :3], v_posed) \
        + T[..., :3, 3]
    return LbsOutput(verts, J_transformed, J, A, abs_A, v_posed)


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


def load_smpl_assets(misc_dir: str, gender: str = 'neutral',
                     device='cuda') -> SmplModel:
    """The reference-format `body_models/misc/*.npz` assets, on `device`
    (`smpl_to_device`): v_templates.npz[gender] (V, 3);
    shapedirs_all.npz[gender] (V, 3, 10); posedirs_all.npz[gender]
    (V, 3, 207), reshaped to (207, V*3); J_regressors.npz[gender] (24, V);
    skinning_weights_all.npz[gender] (V, 24); kintree_table.npy (2, 24),
    whose first row, with -1 at the root, gives the parents;
    faces.npz['faces']."""
    import os

    def load(name, key=gender):
        return np.load(os.path.join(misc_dir, name))[key]
    posedirs = load('posedirs_all.npz')
    posedirs = posedirs.reshape([posedirs.shape[0] * 3, -1]).T
    parents = np.load(os.path.join(misc_dir, 'kintree_table.npy'))[0] \
        .astype(np.int32)
    parents[0] = -1
    return smpl_to_device(SmplModel(
        v_template=load('v_templates.npz'),
        shapedirs=load('shapedirs_all.npz'), posedirs=posedirs,
        J_regressor=load('J_regressors.npz'),
        lbs_weights=load('skinning_weights_all.npz'), parents=parents,
        faces=load('faces.npz', 'faces')), device)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Quaternions (..., 4) in xyzw order, normalised here, -> rotation
    matrices (..., 3, 3): the camera refinement's parameterisation."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                     2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                     2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                     1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)
