"""Learnable per-frame SMPL and per-camera leaves of the parameter tree,
initialised from a dataset. Port of `arah_tpu/config/factory.py:
smpl_refine_params_from_dataset` and `camera_params_from_dataset`; the
rest of that module (configs, datasets, models from YAML) is not ported.

Both are duck-typed on the dataset: `data` (records with `cam_idx` and
`model_file`, an npz of root_orient, pose_body, pose_hand, trans and
optionally betas), `cam_names` and `cameras` (name -> dict with R, T)."""
from __future__ import annotations

import numpy as np
import torch


def _nonzero_axis_angles(a) -> np.ndarray:
    """(..., 3k) float32 axis-angles with every all-zero triple moved by
    +1e-8, as the reference's initialisation does (its Rodrigues has a
    zero-norm gradient singularity there)."""
    a = np.array(a, np.float32)
    aa = a.reshape(-1, 3)
    aa[(aa == 0.0).all(axis=-1)] += 1e-8
    return aa.reshape(a.shape)


def smpl_refine_params(root_orient, pose_body, pose_hand, trans, betas,
                       device='cuda'):
    """The `smpl_params` and `betas` leaves from per-frame arrays
    (root_orient (F, 3), pose_body (F, 63), pose_hand (F, 6), trans
    (F, 3)) and one betas (10,), all-zero axis-angles fixed up."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)
    return {
        'smpl_params': {
            'root_orient': t(_nonzero_axis_angles(root_orient)),
            'pose_body': t(_nonzero_axis_angles(pose_body)),
            'pose_hand': t(_nonzero_axis_angles(pose_hand)),
            'trans': t(trans),
        },
        'betas': t(betas),
    }


def smpl_refine_params_from_dataset(dataset, device='cuda'):
    """The initial learnable SMPL leaves from the dataset's stored
    estimates: one row per frame of the first camera's records, the
    betas of the first (zeros where it has none)."""
    first_cam = dataset.data[0]['cam_idx']
    rows = {'root_orient': [], 'pose_body': [], 'pose_hand': [],
            'trans': []}
    betas = None
    for rec in dataset.data:
        if rec['cam_idx'] != first_cam:
            break
        md = np.load(rec['model_file'])
        rows['root_orient'].append(md['root_orient'].reshape(3))
        rows['pose_body'].append(md['pose_body'].reshape(-1))
        rows['pose_hand'].append(md['pose_hand'].reshape(-1))
        rows['trans'].append(md['trans'].reshape(3))
        if betas is None:
            betas = md['betas'].reshape(-1) if 'betas' in md \
                else np.zeros(10, np.float32)
    return smpl_refine_params(
        *(np.stack(rows[k]).astype(np.float32) for k in
          ('root_orient', 'pose_body', 'pose_hand', 'trans')),
        betas.astype(np.float32), device=device)


def camera_params_from_dataset(dataset, device='cuda'):
    """(cam_rots (C, 4) xyzw quaternions, cam_trans (C, 3)): the initial
    learnable extrinsics of the dataset's cameras, in `cam_names`
    order."""
    from scipy.spatial.transform import Rotation
    rots, trans = [], []
    for name in dataset.cam_names:
        cam = dataset.cameras[name]
        rots.append(Rotation.from_matrix(
            np.asarray(cam['R'])).as_quat().astype(np.float32))
        trans.append(np.asarray(cam['T'], np.float32).ravel())
    return (torch.as_tensor(np.stack(rots), device=device),
            torch.as_tensor(np.stack(trans), device=device))
