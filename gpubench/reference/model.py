"""Model assembly: parameter init and per-frame input preparation.
A frozen copy of the port's `model.py`."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gpubench.reference.body import (apply_transform,
                                      get_02v_bone_transforms_jnp,
                                      normalize_canonical_points)
from gpubench.reference.layers import Draws
from gpubench.reference.linalg import inv_affine
from gpubench.reference.smpl import (NUM_JOINTS, SmplModel,
                                      batch_rigid_transform,
                                      batch_rodrigues, blend_shapes,
                                      vertices2joints)
from gpubench.reference.color import init_color
from gpubench.reference.deviation import init_deviation
from gpubench.reference.hypernet import init_hypernet
from gpubench.reference.skinning import init_skinning
from gpubench.reference.ray_tracing import CanonicalFrame, SmplRef
from gpubench.reference.renderer import ModelConfig


def init_model_params(gen: Draws, cfg: ModelConfig,
                      n_latent_frames: int = 0, latent_dim: int = 128,
                      n_cameras: int = 0, deviation_init: float = 1e-3,
                      device='cuda'):
    """The full parameter tree, key for key the JAX one, drawn from
    `gen` with the same init laws (not the same numbers). `latent` has
    one row per training frame plus a fallback row."""
    params = {
        'hypernet': init_hypernet(gen, cfg.hypernet, device),
        'skinning': init_skinning(gen, cfg.skinning, device),
        'color': init_color(gen, cfg.color, device),
        'deviation': init_deviation(deviation_init, device),
    }
    if n_latent_frames > 0:
        params['latent'] = gen.normal((n_latent_frames + 1, latent_dim))
    if n_cameras > 0:
        params['cam_rots'] = torch.tensor(
            [[0.0, 0.0, 0.0, 1.0]] * n_cameras, device=device)
        params['cam_trans'] = torch.zeros((n_cameras, 3), device=device)
    return params


class FrameData(NamedTuple):
    """Everything derived from one frame's SMPL parameters."""
    frame: CanonicalFrame
    smpl: SmplRef
    verts_cano: torch.Tensor      # (V, 3) Vitruvian canonical verts
    rots: torch.Tensor            # (1, 24, 9) local rots, root = I
    rots_full: torch.Tensor       # (1, 24, 9) incl. root
    Jtrs: torch.Tensor            # (1, 24, 3) normalized rest joints
    Jtrs_posed: torch.Tensor      # (1, 24, 3) posed joints (world)
    bounds_min: torch.Tensor      # (3,) world AABB of posed body (+margin)
    bounds_max: torch.Tensor      # (3,)


def prepare_frame(model: SmplModel, betas, pose, trans,
                  box_margin: float = 0.05, device='cuda') -> FrameData:
    """SMPL params (betas (10,), axis-angle pose (72,), trans (3,)) ->
    renderer frame inputs: shaped template and rest joints, pose blend
    shapes, bone transforms, posed verts, the Vitruvian canonicalization
    and the final bone transforms A @ inv(02v). Differentiable, as the
    JAX function is: tensor inputs keep their autograd graph (the SMPL
    refinement of the train step differentiates the frame); a caller
    that wants no graph wraps the call in `torch.no_grad()`. Arrays that
    are not tensors are copied to `device`; a model on the device
    (`core/smpl.py:smpl_to_device`) is used as it is."""
    def t(a):
        if torch.is_tensor(a):
            return a.to(device=device, dtype=torch.float32)
        return torch.as_tensor(np.asarray(a, np.float32), device=device)
    v_template, shapedirs = t(model.v_template), t(model.shapedirs)
    posedirs, J_regressor = t(model.posedirs), t(model.J_regressor)
    W = t(model.lbs_weights)
    parents = np.asarray(model.parents.cpu() if torch.is_tensor(
        model.parents) else model.parents)
    betas, pose, trans = t(betas)[None], t(pose)[None], t(trans)

    v_shaped = v_template[None] + blend_shapes(betas, shapedirs)
    Jtr = vertices2joints(J_regressor, v_shaped)                 # (1, 24, 3)
    rot_mats = batch_rodrigues(pose.reshape(-1, 3)).reshape(1, -1, 3, 3)
    ident = torch.eye(3, device=device)
    pose_feature = (rot_mats[:, 1:] - ident).reshape(1, -1)
    minimal_shape = v_shaped + (pose_feature @ posedirs).reshape(1, -1, 3)

    _, A, _ = batch_rigid_transform(rot_mats, Jtr, parents)
    T = (W @ A.reshape(1, NUM_JOINTS, 16)).reshape(1, -1, 4, 4)
    verts_posed = apply_transform(T, minimal_shape)
    verts_world = verts_posed[0] + trans
    Jtr_posed = apply_transform(A, Jtr) + trans

    tf_02v = get_02v_bone_transforms_jnp(Jtr[0])
    T02 = (W @ tf_02v.reshape(NUM_JOINTS, 16)).reshape(-1, 4, 4)
    verts_cano = apply_transform(T02, minimal_shape[0])
    center = verts_cano.mean(dim=0)
    centered = verts_cano - center
    coord_max, coord_min = centered.max(), centered.min()
    Jtr_norm = normalize_canonical_points(Jtr[0], coord_min, coord_max,
                                          center)
    bone_transforms = A[0] @ inv_affine(tf_02v)

    rots_full = rot_mats.reshape(1, NUM_JOINTS, 9)
    rots_local = torch.cat([ident.reshape(1, 1, 9), rots_full[:, 1:]],
                           dim=1)
    return FrameData(
        frame=CanonicalFrame(bone_transforms.contiguous(), trans, coord_min,
                             coord_max, center),
        smpl=SmplRef(verts_world.contiguous(), W),
        verts_cano=verts_cano, rots=rots_local, rots_full=rots_full,
        Jtrs=Jtr_norm[None], Jtrs_posed=Jtr_posed,
        bounds_min=verts_world.min(dim=0)[0] - box_margin,
        bounds_max=verts_world.max(dim=0)[0] + box_margin)
