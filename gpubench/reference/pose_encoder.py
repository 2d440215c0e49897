"""LEAP-style hierarchical pose encoder: a global 288->6 linear plus one
19->19->ReLU->6 MLP per joint, composed down the kinematic tree; output
(B, 144). A frozen copy of the port's `nn/pose_encoder.py`."""
from __future__ import annotations

import torch

from gpubench.reference.smpl import SMPL_PARENTS, NUM_JOINTS
from gpubench.reference.layers import Draws, init_linear, linear


def init_pose_encoder(gen: Draws, num_joints: int = NUM_JOINTS,
                      device='cpu'):
    return {
        'layer_0': init_linear(gen, 9 * num_joints + 3 * num_joints, 6,
                               device=device),
        'layers': [
            {'fc1': init_linear(gen, 19, 19, device=device),
             'fc2': init_linear(gen, 19, 6, device=device)}
            for _ in range(num_joints)
        ],
    }


def pose_encoder_apply(params, rots: torch.Tensor, Jtrs: torch.Tensor,
                       rel_joints: bool = False) -> torch.Tensor:
    """rots: (B, 24, 9) flattened local rotations; Jtrs: (B, 24, 3)."""
    batch = rots.shape[0]
    parents = SMPL_PARENTS
    if rel_joints:
        Jtrs = torch.cat([Jtrs[:, :1, :],
                          Jtrs[:, 1:, :] - Jtrs[:, parents[1:], :]],
                         dim=1).detach()

    global_feat = linear(params['layer_0'], torch.cat(
        [rots.reshape(batch, -1), Jtrs.reshape(batch, -1)], dim=-1))

    out = [None] * NUM_JOINTS
    for j in range(NUM_JOINTS):
        rot = rots[:, j, :]
        Jtr = Jtrs[:, j, :]
        parent = int(parents[j])
        if parent == -1:
            bone_l = torch.linalg.norm(Jtr, dim=-1, keepdim=True)
            parent_feat = global_feat
        else:
            bone_l = torch.linalg.norm(
                Jtr if rel_joints else Jtr - Jtrs[:, parent, :],
                dim=-1, keepdim=True)
            parent_feat = out[parent]
        in_feat = torch.cat([rot, Jtr, bone_l, parent_feat], dim=-1)
        h = torch.relu(linear(params['layers'][j]['fc1'], in_feat))
        out[j] = linear(params['layers'][j]['fc2'], h)
    return torch.cat(out, dim=-1)
