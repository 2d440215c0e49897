"""SMPL parameters -> the per-frame npz record the datasets read
(`minimal_shape`, `bone_transforms`, `Jtr_posed`, ...), posed by the port's
`core/smpl.py:lbs` on the model's device. Port of the JAX package's
`preprocess/smpl_frames.py`: the same fields, dtypes and shapes."""
from __future__ import annotations

import numpy as np
import torch

from arah_tpu_torch.core.smpl import SmplModel, blend_shapes, lbs


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def frame_record(model: SmplModel, betas: np.ndarray, root_orient,
                 pose_body, pose_hand, trans, device='cuda') -> dict:
    """One frame's npz fields (the reference's
    `preprocess_ZJU-MoCap.py:152-162`): float32 `minimal_shape` (V, 3),
    `betas` (n_betas,), `Jtr_posed` (24, 3) with `trans`,
    `bone_transforms` (24, 4, 4), `trans` (3,), `root_orient` (3,),
    `pose_body` (63,) and `pose_hand` (6,). `model` lies on `device`
    (`core/smpl.py:load_smpl_assets`)."""
    betas = np.asarray(betas, np.float32).reshape(1, -1)
    pose = np.concatenate([np.asarray(root_orient, np.float32).reshape(3),
                           np.asarray(pose_body, np.float32).reshape(63),
                           np.asarray(pose_hand, np.float32).reshape(-1)])
    tb = torch.as_tensor(betas, device=device)
    with torch.no_grad():
        out = lbs(model, tb, torch.as_tensor(pose, device=device)[None])
        v_shaped = _np(model.v_template[None]
                       + blend_shapes(tb, model.shapedirs))[0]
    trans = np.asarray(trans, np.float32).reshape(3)
    return dict(
        minimal_shape=v_shaped.astype(np.float32),
        betas=betas[0],
        Jtr_posed=_np(out.joints_posed[0]) + trans,
        bone_transforms=_np(out.rel_transforms[0]),
        trans=trans,
        root_orient=pose[:3], pose_body=pose[3:66], pose_hand=pose[66:])


def posed_vertices(model: SmplModel, record: dict,
                   device='cuda') -> np.ndarray:
    """World-space posed vertices (V, 3) of a frame record (for the
    translation refits)."""
    pose = np.concatenate([record['root_orient'], record['pose_body'],
                           record['pose_hand']])
    with torch.no_grad():
        out = lbs(model, torch.as_tensor(record['betas'],
                                         device=device)[None],
                  torch.as_tensor(pose, device=device)[None])
    return _np(out.verts[0]) + record['trans']


def easymocap_record(model: SmplModel, smpl_file: str, verts_file: str,
                     device='cuda') -> dict:
    """The record of one raw frame of the ZJU-MoCap and H36M layouts: the
    EasyMocap parameters `smpl_file` (`Rh` the root orientation, `Th`,
    `shapes`, `poses` with its first three unused), its translation
    refitted so that the posed vertices' mean meets that of the stored
    EasyMocap vertices `verts_file` where that file exists with one
    vertex a model vertex (the reference refits against EasyMocap's own
    SMPL layer, `preprocess_ZJU-MoCap.py:132-141`)."""
    import os
    from scipy.spatial.transform import Rotation
    params = np.load(smpl_file, allow_pickle=True).item()
    root = Rotation.from_rotvec(
        np.asarray(params['Rh']).reshape(-1)).as_rotvec()
    trans = np.asarray(params['Th'], np.float32).reshape(3)
    betas = np.asarray(params['shapes'], np.float32).reshape(-1)
    poses = np.asarray(params['poses'], np.float32).reshape(-1)
    rec = frame_record(model, betas, root, poses[3:66], poses[66:], trans,
                       device)
    if os.path.exists(verts_file):
        target = np.load(verts_file).reshape(-1, 3)
        ours = posed_vertices(model, rec, device)
        if target.shape == ours.shape:
            off = (target - ours).mean(0)
            rec['trans'] = rec['trans'] + off
            rec['Jtr_posed'] = rec['Jtr_posed'] + off
    return rec
