"""Out-of-distribution pose (ODP) animation dataset: render a trained
avatar under novel pose sequences (AIST++ / MPI-Limits retargeted SMPL).
Port of `arah_tpu/data/odp.py`.

Pose-only frames (no images: a zero image and mask stand in), eval rays
from one training camera over the posed SMPL box, and `novel_seq=True`
so that latent codes fall back to the last embedding row.
"""
from __future__ import annotations

import glob
import json
import os

import numpy as np

from arah_tpu_torch.data.human_video import HumanVideoDataset


class ODPDataset(HumanVideoDataset):

    def __init__(self, dataset_folder, pose_dir, cam_name='1',
                 img_size=(512, 512), orig_img_size=(1024, 1024), **kwargs):
        self.pose_dir = pose_dir
        self._odp_cam_name = cam_name
        self.orig_img_size = (orig_img_size, orig_img_size) \
            if isinstance(orig_img_size, int) else tuple(orig_img_size)
        kwargs.setdefault('mode', 'test')
        kwargs.setdefault('erode_mask', False)
        super().__init__(dataset_folder, img_size=img_size, **kwargs)

    def _load_cameras(self, subject, views):
        with open(os.path.join(self.dataset_folder, subject,
                               'cam_params.json')) as f:
            cameras = json.load(f)
        return {self._odp_cam_name: cameras[self._odp_cam_name]}

    def _index_frames(self, subject, start, end, rate):
        pose_path = os.path.join(self.dataset_folder, subject,
                                 self.pose_dir)
        sl = slice(start, end if end > 0 else None, rate)
        model_files = sorted(glob.glob(os.path.join(pose_path, '*.npz')))[sl]
        return [{'subject': subject, 'gender': 'neutral', 'cam_idx': 0,
                 'cam_name': self._odp_cam_name, 'frame_idx': i,
                 'data_idx': i, 'model_file': f}
                for i, f in enumerate(model_files)]

    def __getitem__(self, idx):
        rec = self.data[idx]
        cam = self.cameras[rec['cam_name']]
        H, W = self.img_size

        K = self._rescale_K(np.asarray(cam['K'], np.float32),
                            self.orig_img_size)
        R = np.asarray(cam['R'], np.float32)
        cam_trans = np.asarray(cam['T'], np.float32).ravel()
        cam_loc = (-R.T @ cam_trans).astype(np.float32)

        smpl = self._smpl_from_npz(np.load(rec['model_file']))
        verts = smpl['verts_posed']
        bounds = np.stack([verts.min(0) - self.box_margin,
                           verts.max(0) + self.box_margin], axis=0)

        img = np.zeros((H, W, 3), np.float32)
        mask = np.zeros((H, W), np.uint8)
        rays = self._sample_eval_rays(img, mask, mask, K, R, cam_trans,
                                      cam_loc, bounds)
        tf_02v, msv, center, cmin, cmax, Jtr_norm = self._canonicalize(smpl)

        return {
            'image.trans': smpl['trans'],
            'image.bone_transforms': smpl['bone_transforms'],
            'image.bone_transforms_02v': tf_02v,
            'image.coord_max': cmax, 'image.coord_min': cmin,
            'image.center': center,
            'image.minimal_shape': msv,
            'image.smpl_vertices': smpl['verts_posed'],
            'image.skinning_weights':
                smpl['skinning_weights'].astype(np.float32),
            'image.rots': smpl['pose_rot'].astype(np.float32),
            'image.Jtrs': Jtr_norm,
            'image.rots_full': smpl['pose_rot_full'].astype(np.float32),
            'image.Jtrs_posed': smpl['Jtr_posed'],
            'image.K': K, 'image.R': R, 'image.T': cam_trans,
            'image.cam_loc': cam_loc,
            'inputs': rays['pixels'],
            'inputs.ray_dirs': rays['rays'],
            'inputs.ray_dirs_cam': rays['rays_cam'],
            'inputs.body_bounds_intersections':
                rays['bounds_intersections'],
            'inputs.image_mask': rays['image_mask'],
            'inputs.img_height': H, 'inputs.img_width': W,
            'inputs.cam_idx': 0,
            'inputs.frame_idx': rec['frame_idx'],
            'inputs.data_idx': rec['data_idx'],
            'inputs.novel_seq': True,
            'idx': idx,
        }
