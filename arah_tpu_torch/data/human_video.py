"""Host-side multi-view human video datasets: one item a (frame, view),
flat dicts of fixed-size numpy arrays keyed like the reference's
`image.*` / `inputs.*` fields. Port of `arah_tpu/data/human_video.py`:
the base class and the ZJU-MoCap, H36M and People-Snapshot readers. Per
item, on the host:

  1. load, undistort (a camera with non-zero `D`) and resize the image
     and mask, boundary-label the mask (100),
  2. rescale K to the target image size,
  3. SMPL npz -> local/full pose rotations, pose-blend-shaped minimal
     shape, posed vertices via the stored bone transforms,
  4. ray sampling: train = num_fg fg + num_bg bg pixels inside the
     projected SMPL box (with AABB near/far); val/test = all box pixels,
  5. Vitruvian canonicalization (02v transforms, coord_min/max/center,
     normalized rest joints),
  6. regularization point sampling (off-surface / surface skinning /
     inside) via the port's native point-mesh queries.

Images are read, undistorted and resized by the port's own code
(`utils/image.py`), which gives OpenCV's bytes, so an item equals JAX's
for the same seed: the per-item randomness is the same numpy
`RandomState` stream.
"""
from __future__ import annotations

import glob
import json
import os

import numpy as np
from scipy.spatial.transform import Rotation

from arah_tpu_torch import native
from arah_tpu_torch.core.body import get_02v_bone_transforms
from arah_tpu_torch.utils.image import (dilate5, erode5, fill_poly,
                                        read_image, resize_linear,
                                        resize_nearest, undistort)


def get_bound_2d_mask(bounds, K, pose, H, W):
    """Projected-box fill mask (`im2mesh/utils/utils.py:43-54`)."""
    mn, mx = bounds[0], bounds[1]
    corners = np.array([[x, y, z] for x in (mn[0], mx[0])
                        for y in (mn[1], mx[1]) for z in (mn[2], mx[2])])
    pts = corners @ pose[:, :3].T + pose[:, 3]
    pts2d = pts @ K.T
    pts2d = np.round(pts2d[:, :2] / pts2d[:, 2:]).astype(int)
    mask = np.zeros((H, W), np.uint8)
    # corner order here: index bit pattern (x,y,z); same quads as reference
    quads = [[0, 1, 3, 2], [4, 5, 7, 6], [0, 1, 5, 4],
             [2, 3, 7, 6], [0, 2, 6, 4], [1, 3, 7, 5]]
    for q in quads:
        fill_poly(mask, pts2d[q + q[:1]], 1)
    return mask


def get_near_far(bounds, ray_o, ray_d):
    """Ray-AABB slab test (`im2mesh/utils/utils.py:56-73`)."""
    norm_d = np.linalg.norm(ray_d, axis=-1, keepdims=True)
    viewdir = ray_d / norm_d
    viewdir[(viewdir < 1e-5) & (viewdir > -1e-10)] = 1e-5
    viewdir[(viewdir > -1e-5) & (viewdir < 1e-10)] = -1e-5
    tmin = (bounds[:1] - ray_o[:1]) / viewdir
    tmax = (bounds[1:2] - ray_o[:1]) / viewdir
    near = np.minimum(tmin, tmax).max(axis=-1)
    far = np.maximum(tmin, tmax).min(axis=-1)
    mask_at_box = near < far
    return near / norm_d[..., 0], far / norm_d[..., 0], mask_at_box


def sample_surface(verts, faces, n, rng):
    """Area-weighted surface sampling (trimesh.sample equivalent)."""
    tri = verts[faces]
    cross = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    area = 0.5 * np.linalg.norm(cross, axis=-1)
    probs = area / max(area.sum(), 1e-12)
    fidx = rng.choice(len(faces), size=n, p=probs)
    r1 = np.sqrt(rng.rand(n, 1))
    r2 = rng.rand(n, 1)
    a, b, c = tri[fidx, 0], tri[fidx, 1], tri[fidx, 2]
    pts = (1 - r1) * a + r1 * (1 - r2) * b + r1 * r2 * c
    return pts, fidx


class HumanVideoDataset:
    """Base class; subclasses provide camera/file discovery."""

    gender = 'neutral'

    def __init__(self, dataset_folder, smpl_misc_dir='body_models/misc',
                 subjects=('CoreView_313',), mode='train',
                 img_size=(512, 512), num_fg_samples=1024,
                 num_bg_samples=1024, sampling_rate=1, start_frame=0,
                 end_frame=-1, views=(), off_surface_thr=0.2,
                 inside_thr=0.001, box_margin=0.05,
                 sample_reg_surface=False, sample_inside=False,
                 erode_mask=True, seed=None, sample_patch=0):
        assert len(subjects) == 1, 'single-subject training only'
        self.dataset_folder = dataset_folder
        self.mode = mode
        self.num_fg_samples = num_fg_samples
        self.num_bg_samples = num_bg_samples
        self.sample_patch = int(sample_patch)
        self.off_surface_thr = off_surface_thr
        self.inside_thr = inside_thr
        self.box_margin = box_margin
        self.sample_reg_surface = sample_reg_surface
        self.sample_inside = sample_inside
        self.erode_mask = erode_mask
        self.img_size = (img_size, img_size) if isinstance(img_size, int) \
            else tuple(img_size)
        self.rng = np.random.RandomState(seed)

        self.faces = np.load(
            os.path.join(smpl_misc_dir, 'faces.npz'))['faces']
        self.skinning_weights = dict(np.load(
            os.path.join(smpl_misc_dir, 'skinning_weights_all.npz')))
        self.posedirs = dict(np.load(
            os.path.join(smpl_misc_dir, 'posedirs_all.npz')))
        self.J_regressor = dict(np.load(
            os.path.join(smpl_misc_dir, 'J_regressors.npz')))

        self.cameras = self._load_cameras(subjects[0], views)
        self.cam_names = list(self.cameras.keys())

        H, W = self.img_size
        yy, xx = np.meshgrid(np.arange(H, dtype=np.float32),
                             np.arange(W, dtype=np.float32), indexing='ij')
        self.homo_2d = np.stack([xx, yy, np.ones_like(xx)], axis=-1)

        self.data = self._index_frames(subjects[0], start_frame, end_frame,
                                       sampling_rate)

    # -------------------- subclass hooks --------------------
    def _load_cameras(self, subject, views) -> dict:
        raise NotImplementedError

    def _index_frames(self, subject, start, end, rate) -> list:
        raise NotImplementedError

    # -------------------- shared pipeline --------------------
    def __len__(self):
        return len(self.data)

    def _load_image(self, rec):
        image = read_image(rec['img_file'])
        mask = read_image(rec['mask_file'], gray=True)
        return image, mask

    def _get_mask(self, mask_in):
        mask = (mask_in != 0).astype(np.uint8)
        if self.erode_mask or self.mode in ('val', 'test'):
            mask_erode = erode5(mask)
            mask_dilate = dilate5(mask)
            mask[(mask_dilate - mask_erode) == 1] = 100
        return mask

    def _smpl_from_npz(self, model_dict):
        """SMPL npz -> pose rots / minimal shape / posed verts (steps 3+5)."""
        gender = self.gender
        trans = model_dict['trans'].astype(np.float32)
        minimal_shape = model_dict['minimal_shape']
        if minimal_shape.dtype == np.float16:
            minimal_shape = minimal_shape.astype(np.float32)
            minimal_shape += 1e-4 * self.rng.randn(*minimal_shape.shape)
        minimal_shape = minimal_shape.astype(np.float32)
        n_verts = minimal_shape.shape[0]

        bone_transforms = model_dict['bone_transforms'].astype(np.float32)
        root_orient = model_dict['root_orient'].astype(np.float32)
        pose_body = model_dict['pose_body'].astype(np.float32)
        pose_hand = model_dict['pose_hand'].astype(np.float32)
        Jtr_posed = model_dict['Jtr_posed'].astype(np.float32)
        pose = np.concatenate([root_orient, pose_body, pose_hand], axis=-1)
        pose_mat_full = Rotation.from_rotvec(
            pose.reshape([-1, 3])).as_matrix()
        pose_rot = np.concatenate(
            [np.eye(3)[None], pose_mat_full[1:]], axis=0).reshape(-1, 9)
        pose_rot_full = pose_mat_full.reshape(-1, 9)

        J_regressor = self.J_regressor[gender]
        Jtr = J_regressor @ minimal_shape

        pose_feature = (pose_mat_full[1:] - np.eye(3)).reshape([207, 1])
        posedir = self.posedirs[gender]
        pose_offsets = (posedir.reshape(-1, 207) @ pose_feature
                        ).reshape(n_verts, 3)
        minimal_shape = minimal_shape + pose_offsets

        skinning_weights = self.skinning_weights[gender]
        T = (skinning_weights @ bone_transforms.reshape(-1, 16)
             ).reshape(-1, 4, 4)
        homo = np.concatenate(
            [minimal_shape, np.ones((n_verts, 1), np.float32)], axis=-1)
        verts_posed = (np.einsum('vij,vj->vi', T, homo)[:, :3]
                       + trans).astype(np.float32)

        return dict(trans=trans, minimal_shape=minimal_shape,
                    bone_transforms=bone_transforms,
                    root_orient=root_orient, pose_body=pose_body,
                    pose_hand=pose_hand, Jtr_posed=Jtr_posed,
                    pose_rot=pose_rot, pose_rot_full=pose_rot_full,
                    Jtr=Jtr, skinning_weights=skinning_weights,
                    verts_posed=verts_posed)

    def _rescale_K(self, K, orig_img_size):
        K = K.copy()
        side = max(orig_img_size)
        scale = max(self.img_size) / side
        K[:2, 2] *= scale
        K[0, 0] *= scale
        K[1, 1] *= scale
        return K

    def _sample_train_rays(self, img, mask, mask_erode, K, R, cam_trans,
                           cam_loc, bounds):
        H, W = self.img_size
        K_inv = np.linalg.inv(K)
        bound_mask = get_bound_2d_mask(
            bounds, K, np.concatenate([R, cam_trans.reshape(3, 1)], -1),
            H, W)
        yb, xb = np.where(bound_mask != 0)
        fg_mask = mask_erode == 1
        bg_mask = mask_erode == 0

        def pick(y, x, count):
            inds = self.rng.choice(len(x), size=count,
                                   replace=len(x) < count)
            return y[inds], x[inds]

        n_extra = 1024
        yf, xf = np.where(fg_mask)
        yf, xf = pick(yf, xf, self.num_fg_samples + n_extra)
        in_bg = bg_mask[yb, xb]
        ybg, xbg = pick(yb[in_bg], xb[in_bg], self.num_bg_samples + n_extra)

        ys = np.concatenate([yf, ybg])
        xs = np.concatenate([xf, xbg])
        pixels = img[ys, xs].copy()
        pixels[len(yf):] = 0.0
        m = mask[ys, xs] != 0
        me = mask_erode[ys, xs]
        uv = (self.homo_2d[ys, xs].reshape(-1, 3) @ K_inv.T)
        rays_cam = uv / (np.linalg.norm(uv, axis=-1, keepdims=True) + 1e-12)
        rays = uv @ R
        rays /= (np.linalg.norm(rays, axis=-1, keepdims=True) + 1e-12)
        near, far, at_box = get_near_far(
            bounds, np.broadcast_to(cam_loc, rays.shape), rays)

        nf = self.num_fg_samples + n_extra
        keep = []
        for lo, hi, count in ((0, nf, self.num_fg_samples),
                              (nf, len(ys), self.num_bg_samples)):
            valid = np.where(at_box[lo:hi])[0] + lo
            sel = self.rng.choice(len(valid), size=count,
                                  replace=len(valid) < count)
            keep.append(valid[sel])
        keep = np.concatenate(keep)

        out = dict(
            pixels=pixels[keep].astype(np.float32),
            mask=m[keep], mask_erode=me[keep],
            uv=uv[keep].astype(np.float32),
            rays_cam=rays_cam[keep].astype(np.float32),
            rays=rays[keep].astype(np.float32),
            bounds_intersections=np.stack(
                [near[keep], far[keep]], axis=-1).astype(np.float32))

        if self.sample_patch > 0:
            # one ps x ps pixel patch around a random foreground pixel,
            # appended AFTER the per-ray-loss rays (the perceptual-loss
            # contract, `loss.py:62-84`); boundary pixels (in mask but
            # not the eroded mask) carry label 100 so the RGB loss skips
            # them (`loss.py:52-55`)
            ps = self.sample_patch
            ci = self.rng.randint(len(yf))
            cy = int(np.clip(yf[ci] - ps // 2, 0, H - ps))
            cx = int(np.clip(xf[ci] - ps // 2, 0, W - ps))
            gy, gx = np.mgrid[cy:cy + ps, cx:cx + ps]
            gy, gx = gy.reshape(-1), gx.reshape(-1)
            p_pix = img[gy, gx].astype(np.float32).copy()
            p_m = mask[gy, gx] != 0
            # mask_erode already carries the 0/1/100 (bg/fg/boundary)
            # labels from _get_mask; pass them through unchanged
            label = mask_erode[gy, gx].astype(out['mask_erode'].dtype)
            p_pix[label == 0] = 0.0
            p_uv = (self.homo_2d[gy, gx].reshape(-1, 3) @ K_inv.T)
            p_rays_cam = p_uv / (np.linalg.norm(p_uv, axis=-1, keepdims=True)
                                 + 1e-12)
            p_rays = p_uv @ R
            p_rays /= (np.linalg.norm(p_rays, axis=-1, keepdims=True) + 1e-12)
            p_near, p_far, _ = get_near_far(
                bounds, np.broadcast_to(cam_loc, p_rays.shape), p_rays)
            out['pixels'] = np.concatenate([out['pixels'], p_pix])
            out['mask'] = np.concatenate([out['mask'], p_m])
            out['mask_erode'] = np.concatenate([out['mask_erode'], label])
            out['uv'] = np.concatenate(
                [out['uv'], p_uv.astype(np.float32)])
            out['rays_cam'] = np.concatenate(
                [out['rays_cam'], p_rays_cam.astype(np.float32)])
            out['rays'] = np.concatenate(
                [out['rays'], p_rays.astype(np.float32)])
            out['bounds_intersections'] = np.concatenate(
                [out['bounds_intersections'],
                 np.stack([p_near, p_far], -1).astype(np.float32)])
        return out

    def _sample_eval_rays(self, img, mask, mask_erode, K, R, cam_trans,
                          cam_loc, bounds):
        H, W = self.img_size
        K_inv = np.linalg.inv(K)
        bound_mask = get_bound_2d_mask(
            bounds, K, np.concatenate([R, cam_trans.reshape(3, 1)], -1),
            H, W)
        yb, xb = np.where(bound_mask != 0)
        pixels = img[yb, xb].copy()
        bg = (mask_erode == 0)[yb, xb]
        pixels[bg] = 0.0
        uv = (self.homo_2d[yb, xb].reshape(-1, 3) @ K_inv.T)
        rays_cam = uv / (np.linalg.norm(uv, axis=-1, keepdims=True) + 1e-12)
        rays = uv @ R
        rays /= (np.linalg.norm(rays, axis=-1, keepdims=True) + 1e-12)
        near, far, at_box = get_near_far(
            bounds, np.broadcast_to(cam_loc, rays.shape), rays)
        image_mask = np.zeros((H, W), bool)
        image_mask[yb[at_box], xb[at_box]] = True
        return dict(
            pixels=pixels[at_box].astype(np.float32),
            mask=np.ones(at_box.sum(), bool),
            mask_erode=np.ones(at_box.sum(), bool),
            uv=uv[at_box].astype(np.float32),
            rays_cam=rays_cam[at_box].astype(np.float32),
            rays=rays[at_box].astype(np.float32),
            bounds_intersections=np.stack(
                [near[at_box], far[at_box]], -1).astype(np.float32),
            image_mask=image_mask)

    def _canonicalize(self, smpl):
        """Vitruvian canonicalization + normalized rest joints (step 5)."""
        Jtr = smpl['Jtr']
        tf_02v = get_02v_bone_transforms(Jtr)
        sw = smpl['skinning_weights']
        T = (sw @ tf_02v.reshape(-1, 16)).reshape(-1, 4, 4)
        minimal_shape_v = (np.einsum(
            'vij,vj->vi', T[:, :3, :3], smpl['minimal_shape'])
            + T[:, :3, 3]).astype(np.float32)
        center = minimal_shape_v.mean(0)
        centered = minimal_shape_v - center
        coord_max = centered.max()
        coord_min = centered.min()
        padding = (coord_max - coord_min) * 0.05
        Jtr_norm = (Jtr - center - coord_min + padding) \
            / (coord_max - coord_min) / 1.1
        Jtr_norm = (Jtr_norm - 0.5) * 2.0
        return (tf_02v.astype(np.float32), minimal_shape_v,
                center.astype(np.float32), np.float32(coord_min),
                np.float32(coord_max), Jtr_norm.astype(np.float32))

    def _unnormalize(self, pts, coord_min, coord_max, center):
        padding = (coord_max - coord_min) * 0.05
        return (pts / 2.0 + 0.5) * 1.1 * (coord_max - coord_min) \
            + coord_min - padding + center

    def _normalize(self, pts, coord_min, coord_max, center):
        padding = (coord_max - coord_min) * 0.05
        pts = (pts - center - coord_min + padding) \
            / (coord_max - coord_min) / 1.1
        return (pts - 0.5) * 2.0

    def _sample_reg_points(self, minimal_shape_v, sw, coord_min, coord_max,
                           center):
        """Step 6: off-surface / surface-skinning / inside points, via the
        port's native point-mesh queries."""
        faces = self.faces
        intersector = native.MeshIntersector(minimal_shape_v, faces)

        points_uniform = self.rng.rand(4096, 3).astype(np.float32) * 2 - 1
        query = self._unnormalize(points_uniform, coord_min, coord_max,
                                  center)
        occ = intersector.query(query)

        out = {}
        if self.sample_reg_surface:
            pts_surf, _ = sample_surface(minimal_shape_v, faces, 1024,
                                         self.rng)
            all_pts = np.concatenate([query, pts_surf], axis=0)
            sq, fi, bary = native.point_mesh_squared_distance(
                all_pts, minimal_shape_v, faces)
            far_enough = sq[:4096] > self.off_surface_thr
            cand = points_uniform[(~occ) & far_enough]
            sel = self.rng.choice(len(cand), 1024, replace=len(cand) < 1024)
            out['points_uniform'] = cand[sel].astype(np.float32)
            vert_ids = faces[fi[4096:]]
            pts_W = (sw[vert_ids] * bary[4096:, :, None]).sum(axis=1)
            out['points_skinning'] = pts_surf.astype(np.float32)
            out['sampled_weights'] = pts_W.astype(np.float32)
        else:
            sq, _, _ = native.point_mesh_squared_distance(
                query, minimal_shape_v, faces)
            cand = points_uniform[(~occ) & (sq > self.off_surface_thr)]
            sel = self.rng.choice(len(cand), 1024, replace=len(cand) < 1024)
            out['points_uniform'] = cand[sel].astype(np.float32)
            part_idx = sw.argmax(-1)
            pts = np.zeros((24, 3), np.float32)
            W = np.zeros((24, 24), np.float32)
            for j in range(24):
                sel_j = part_idx == j
                if sel_j.any():
                    pts[j] = minimal_shape_v[sel_j].mean(0)
                W[j, j] = 1.0
            out['points_skinning'] = pts
            out['sampled_weights'] = W

        if self.sample_inside:
            part_idx = sw.argmax(-1)
            jtr_pts = np.zeros((22, 3), np.float32)
            for j in range(22):
                sel_j = part_idx == j
                if sel_j.any():
                    jtr_pts[j] = minimal_shape_v[sel_j].mean(0)
            inside, _ = sample_surface(minimal_shape_v, faces, 4096,
                                       self.rng)
            inside = inside + self.rng.normal(scale=0.5, size=inside.shape)
            occ_in = intersector.query(inside)
            inside = inside[occ_in]
            if len(inside):
                sq, fi, bary = native.point_mesh_squared_distance(
                    inside, minimal_shape_v, faces)
                vert_ids = faces[fi]
                w_in = (sw[vert_ids] * bary[:, :, None]).sum(axis=1)
                pidx = w_in.argmax(-1)
                inside = inside[(pidx != 22) & (pidx != 23)
                                & (sq >= self.inside_thr)]
            inside = np.concatenate([inside, jtr_pts], axis=0) \
                if len(inside) else jtr_pts
            sel = self.rng.choice(len(inside), 1024,
                                  replace=len(inside) < 1024)
            out['points_inside'] = self._normalize(
                inside[sel], coord_min, coord_max, center
            ).astype(np.float32)
        return out

    def __getitem__(self, idx):
        rec = self.data[idx]
        cam = self.cameras[rec['cam_name']]

        image, mask = self._load_image(rec)
        mask_erode = self._get_mask(mask)
        orig_size = (image.shape[0], image.shape[1])

        K = np.asarray(cam['K'], np.float32)
        dist = np.asarray(cam['D'], np.float32).ravel()
        R = np.asarray(cam['R'], np.float32)
        cam_trans = np.asarray(cam['T'], np.float32).ravel()
        cam_loc = -R.T @ cam_trans

        if np.abs(dist).max() > 0:
            image = undistort(image, K, dist)
            mask = undistort(mask, K, dist)
            mask_erode = undistort(mask_erode, K, dist)

        H, W = self.img_size
        img = resize_linear(image, (W, H)).astype(np.float32)
        img /= 255.0
        mask = resize_nearest(mask, (W, H))
        mask_erode = resize_nearest(mask_erode, (W, H))
        K = self._rescale_K(K, orig_size)

        smpl = self._smpl_from_npz(np.load(rec['model_file']))
        verts = smpl['verts_posed']
        bounds = np.stack([verts.min(0) - self.box_margin,
                           verts.max(0) + self.box_margin], axis=0)

        if self.mode == 'train':
            rays = self._sample_train_rays(img, mask, mask_erode, K, R,
                                           cam_trans, cam_loc, bounds)
        else:
            rays = self._sample_eval_rays(img, mask, mask_erode, K, R,
                                          cam_trans, cam_loc, bounds)

        tf_02v, msv, center, cmin, cmax, Jtr_norm = self._canonicalize(smpl)
        reg = self._sample_reg_points(msv, smpl['skinning_weights'],
                                      cmin, cmax, center) \
            if self.mode == 'train' else {}

        out = {
            'image.trans': smpl['trans'],
            'image.bone_transforms': smpl['bone_transforms'],
            'image.bone_transforms_02v': tf_02v,
            'image.coord_max': cmax, 'image.coord_min': cmin,
            'image.center': center,
            'image.minimal_shape': msv,
            'image.smpl_vertices': smpl['verts_posed'],
            'image.skinning_weights': smpl['skinning_weights'].astype(
                np.float32),
            'image.root_orient': smpl['root_orient'],
            'image.pose_body': smpl['pose_body'],
            'image.pose_hand': smpl['pose_hand'],
            'image.rots': smpl['pose_rot'].astype(np.float32),
            'image.Jtrs': Jtr_norm,
            'image.rots_full': smpl['pose_rot_full'].astype(np.float32),
            'image.Jtrs_posed': smpl['Jtr_posed'],
            'image.K': K, 'image.R': R, 'image.T': cam_trans,
            'image.cam_loc': cam_loc.astype(np.float32),
            'inputs': rays['pixels'],
            'inputs.mask': rays['mask'],
            'inputs.mask_erode': rays['mask_erode'],
            'inputs.uv': rays['uv'],
            'inputs.ray_dirs': rays['rays'],
            'inputs.ray_dirs_cam': rays['rays_cam'],
            'inputs.body_bounds_intersections':
                rays['bounds_intersections'],
            'inputs.img_height': H, 'inputs.img_width': W,
            'inputs.cam_idx': rec['cam_idx'],
            'inputs.frame_idx': rec['frame_idx'],
            'inputs.data_idx': rec['data_idx'],
            'idx': idx,
        }
        for k, v in reg.items():
            out[f'image.{k}'] = v
        if self.mode != 'train':
            out['inputs.image_mask'] = rays['image_mask']
        return out


class ZJUMoCapDataset(HumanVideoDataset):
    """ZJU-MoCap layout: `cam_params.json` + per-camera jpg/png dirs +
    `models/*.npz` (reference `data/zju_mocap.py`)."""

    def _load_cameras(self, subject, views):
        with open(os.path.join(self.dataset_folder, subject,
                               'cam_params.json')) as f:
            cameras = json.load(f)
        names = views if len(views) else cameras['all_cam_names']
        return {n: cameras[n] for n in names}

    def _index_frames(self, subject, start, end, rate):
        subject_dir = os.path.join(self.dataset_folder, subject)
        sl = slice(start, end if end > 0 else None, rate)
        model_files = sorted(
            glob.glob(os.path.join(subject_dir, 'models/*.npz')))[sl]
        data = []
        for cam_idx, cam_name in enumerate(self.cam_names):
            cam_dir = os.path.join(subject_dir, cam_name)
            img_files = sorted(glob.glob(os.path.join(cam_dir, '*.jpg')))
            frames = list(range(len(img_files)))[sl]
            img_files = img_files[sl]
            mask_files = sorted(
                glob.glob(os.path.join(cam_dir, '*.png')))[sl]
            assert len(model_files) == len(img_files) == len(mask_files)
            for d_idx, (f_idx, imgf, maskf, modelf) in enumerate(
                    zip(frames, img_files, mask_files, model_files)):
                data.append({'subject': subject, 'gender': 'neutral',
                             'cam_idx': cam_idx, 'cam_name': cam_name,
                             'frame_idx': f_idx, 'data_idx': d_idx,
                             'img_file': imgf, 'mask_file': maskf,
                             'model_file': modelf})
        return data


class H36MDataset(ZJUMoCapDataset):
    """Human3.6M (Animatable-NeRF layout): the sequence lives under a
    `Posing/` subdirectory and intrinsics are already expressed at the
    native (1002, 1000) resolution (reference `data/h36m.py:96-128,265`).
    """

    def __init__(self, dataset_folder, img_size=(1002, 1000), **kwargs):
        super().__init__(dataset_folder, img_size=img_size, **kwargs)

    def _load_cameras(self, subject, views):
        with open(os.path.join(self.dataset_folder, subject, 'Posing',
                               'cam_params.json')) as f:
            cameras = json.load(f)
        names = views if len(views) else cameras['all_cam_names']
        return {n: cameras[n] for n in names}

    def _index_frames(self, subject, start, end, rate):
        sub = os.path.join(subject, 'Posing')
        return super()._index_frames(sub, start, end, rate)

    def _rescale_K(self, K, orig_img_size):
        # H36M intrinsics are pre-scaled for the target resolution
        if tuple(self.img_size) == (1002, 1000):
            return K.copy()
        return super()._rescale_K(K, (1002, 1000))


class PeopleSnapshotDataset(ZJUMoCapDataset):
    """Monocular People-Snapshot: a single identity camera from
    `camera.pkl` (intrinsics from camera_f/camera_c, distortion camera_k,
    R = I, T = 0), images under `image/`, masks under `mask/`
    (reference `data/people_snapshot.py:94-134,222-232`)."""

    def __init__(self, dataset_folder, img_size=(1080, 1080), **kwargs):
        super().__init__(dataset_folder, img_size=img_size, **kwargs)

    def _load_cameras(self, subject, views):
        import pickle
        with open(os.path.join(self.dataset_folder, subject,
                               'camera.pkl'), 'rb') as f:
            cam = pickle.load(f, encoding='latin1')
        K = np.zeros((3, 3), np.float32)
        K[0, 0], K[1, 1] = cam['camera_f']
        K[:2, 2] = cam['camera_c']
        K[2, 2] = 1.0
        return {'0': {'K': K.tolist(), 'R': np.eye(3).tolist(),
                      'T': [0.0, 0.0, 0.0],
                      'D': np.asarray(cam['camera_k']).ravel().tolist()}}

    def _index_frames(self, subject, start, end, rate):
        subject_dir = os.path.join(self.dataset_folder, subject)
        sl = slice(start, end if end > 0 else None, rate)
        model_files = sorted(
            glob.glob(os.path.join(subject_dir, 'models/*.npz')))[sl]
        img_files = sorted(
            glob.glob(os.path.join(subject_dir, 'image/*.jpg')))
        frames = list(range(len(img_files)))[sl]
        img_files = img_files[sl]
        mask_files = sorted(
            glob.glob(os.path.join(subject_dir, 'mask/*.png')))[sl]
        assert len(model_files) == len(img_files) == len(mask_files)
        return [{'subject': subject, 'gender': 'neutral', 'cam_idx': 0,
                 'cam_name': '0', 'frame_idx': f_idx, 'data_idx': d_idx,
                 'img_file': imgf, 'mask_file': maskf,
                 'model_file': modelf}
                for d_idx, (f_idx, imgf, maskf, modelf) in enumerate(
                    zip(frames, img_files, mask_files, model_files))]
