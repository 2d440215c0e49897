"""Retarget AIST++ dance motion onto a preprocessed subject, for animation
in out-of-distribution poses (`data/odp.py:ODPDataset`).

    python -m arah_tpu_torch.preprocess.preprocess_aist --data-dir MOTIONS
        --seqname SEQ --in-dataset PREPROCESSED --out-dir OUT
        [--subject CoreView_377] [--view 1] [--smpl-misc body_models/misc]
        [--device cuda|cpu]

Port of the JAX package's `preprocess/preprocess_aist.py` (the
reference's `preprocess_datasets/preprocess_aist.py:22-124`): every
second pose of `MOTIONS/SEQ.pkl`'s `smpl_poses`; the root rotation made
relative to the first frame's, flipped by Rx(pi) and taken into world
space through view `--view`'s camera; the translation at 2.7 m depth in
that camera, mapped to world; the betas of the subject's first frame.
Writes OUT/{subject}/{SEQ}_view{view}/{cnt:06d}.npz (posed on `--device`)
and copies the subject's `cam_params.json` to OUT/{subject}/."""
from __future__ import annotations

import argparse
import json
import os
import pickle
import shutil

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--data-dir', required=True,
                   help='directory with AIST++ motion pkls')
    p.add_argument('--seqname', required=True)
    p.add_argument('--in-dataset', required=True,
                   help='preprocessed dataset root (for subject + cameras)')
    p.add_argument('--subject', default='CoreView_377')
    p.add_argument('--out-dir', required=True)
    p.add_argument('--view', default='1')
    p.add_argument('--smpl-misc', default='body_models/misc')
    p.add_argument('--device', default='cuda')
    args = p.parse_args(argv)

    from scipy.spatial.transform import Rotation
    from arah_tpu_torch.core.smpl import load_smpl_assets
    from arah_tpu_torch.parallel.distributed import pick_device
    from arah_tpu_torch.preprocess.smpl_frames import frame_record

    device = pick_device(args.device)
    with open(os.path.join(args.data_dir, args.seqname + '.pkl'), 'rb') as f:
        motion = pickle.load(f)

    model = load_smpl_assets(args.smpl_misc, 'neutral', device=device)
    additional_R = Rotation.from_euler(
        'xyz', [np.pi, 0, 0]).as_matrix().astype(np.float32)

    with open(os.path.join(args.in_dataset, args.subject,
                           'cam_params.json')) as f:
        cameras = json.load(f)
    R = np.asarray(cameras[args.view]['R'], np.float32)
    cam_trans = np.asarray(cameras[args.view]['T'], np.float32).ravel()

    models = os.path.join(args.in_dataset, args.subject, 'models')
    subj = np.load(os.path.join(models, sorted(os.listdir(models))[0]))
    betas = subj['betas'].astype(np.float32)

    poses = motion['smpl_poses'][::2]

    out_dir = os.path.join(args.out_dir, args.subject,
                           f'{args.seqname}_view{args.view}')
    if os.path.exists(out_dir):
        shutil.rmtree(out_dir)
    os.makedirs(out_dir)
    cam_json = os.path.join(args.out_dir, args.subject, 'cam_params.json')
    if not os.path.exists(cam_json):
        shutil.copy(os.path.join(args.in_dataset, args.subject,
                                 'cam_params.json'), cam_json)

    root_orient_0_inv = None
    for cnt, pose in enumerate(poses):
        pose = pose.astype(np.float32)
        root = pose[:3]
        if cnt == 0:
            root_orient_0_inv = np.linalg.inv(
                Rotation.from_rotvec(root).as_matrix())
        root_mat = R.T @ additional_R @ root_orient_0_inv \
            @ Rotation.from_rotvec(root).as_matrix()
        root = Rotation.from_matrix(root_mat).as_rotvec().astype(np.float32)

        trans = np.array([0.0, 0.0, 2.7], np.float32)
        trans = (trans - cam_trans) @ R

        rec = frame_record(model, betas, root, pose[3:66], pose[66:], trans,
                           device)
        np.savez(os.path.join(out_dir, f'{cnt:06d}.npz'), **rec)
    print(f'wrote {len(poses)} frames to {out_dir}')


if __name__ == '__main__':
    main()
