"""Write a small on-disk dataset in the ZJU-MoCap layout from the synthetic
body, so that the whole host data path (image reading, ray sampling,
regulariser points) and the CLIs run end to end without the real data.
Port of `arah_tpu/data/fake_dataset.py` (the ZJU layout; the H36M and
People-Snapshot layouts are not ported). It writes through the port's own
image writer (`utils/image.py`) and poses the body with `core/smpl.py:
lbs` on the CPU.

    python -m arah_tpu_torch.data.fake_dataset --root data/fake_zju \\
        --frames 4 --views 1,7
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from arah_tpu_torch import native
from arah_tpu_torch.core.smpl import SmplModel, lbs, smpl_to_device
from arah_tpu_torch.data.synthetic import synthetic_smpl
from arah_tpu_torch.utils.image import write_image

# the body's colour, RGB (JAX's fixture writes (180, 120, 90) as BGR)
BODY_RGB = (90, 120, 180)


def write_smpl_misc(misc_dir: str, model: SmplModel):
    os.makedirs(misc_dir, exist_ok=True)
    names = ['male', 'female', 'neutral']
    np.savez(os.path.join(misc_dir, 'faces.npz'),
             faces=np.asarray(model.faces))
    np.savez(os.path.join(misc_dir, 'skinning_weights_all.npz'),
             **{n: np.asarray(model.lbs_weights) for n in names})
    # reference posedirs layout: (V, 3, 207)
    posedirs = np.asarray(model.posedirs).T.reshape(-1, 3, 207)
    np.savez(os.path.join(misc_dir, 'posedirs_all.npz'),
             **{n: posedirs for n in names})
    np.savez(os.path.join(misc_dir, 'J_regressors.npz'),
             **{n: np.asarray(model.J_regressor) for n in names})
    np.savez(os.path.join(misc_dir, 'v_templates.npz'),
             **{n: np.asarray(model.v_template) for n in names})
    np.savez(os.path.join(misc_dir, 'shapedirs_all.npz'),
             **{n: np.asarray(model.shapedirs) for n in names})
    kintree = np.stack([np.asarray(model.parents),
                        np.arange(24)]).astype(np.int64)
    np.save(os.path.join(misc_dir, 'kintree_table.npy'), kintree)


def _camera(angle_deg: float, dist: float = 2.8, height: float = 0.0,
            f: float = 1000.0, c: float = 512.0, cy: float | None = None):
    th = np.deg2rad(angle_deg)
    # camera position on a circle, looking at the origin
    pos = np.array([dist * np.sin(th), height, -dist * np.cos(th)])
    fwd = -pos / np.linalg.norm(pos)
    up = np.array([0.0, -1.0, 0.0])     # opencv-style y-down
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    up2 = np.cross(fwd, right)
    R = np.stack([right, up2, fwd], axis=0)     # w2c rotation
    T = -R @ pos
    K = np.array([[f, 0, c], [0, f, c if cy is None else cy], [0, 0, 1.0]])
    return K, R, T


def _write_frames(model: SmplModel, rng, n_frames, cams, img_hw,
                  model_dir, img_path, mask_path,
                  trans=np.zeros(3, np.float32)):
    """Write models/*.npz and a rasterised silhouette jpg/png a view.
    cams: {name: (K, R, T)}; img_hw: (H, W); img_path/mask_path:
    (cam_name, frame_idx) -> file path."""
    os.makedirs(model_dir, exist_ok=True)
    faces = np.asarray(model.faces)
    tmodel = smpl_to_device(model, 'cpu')
    H, W = img_hw
    for fidx in range(n_frames):
        betas = (rng.randn(10) * 0.2).astype(np.float32)
        pose = (rng.randn(72) * 0.15).astype(np.float32)
        with torch.no_grad():
            out = lbs(tmodel, torch.as_tensor(betas)[None],
                      torch.as_tensor(pose)[None])
        v_shaped = np.asarray(model.v_template) + np.einsum(
            'l,mkl->mk', betas, np.asarray(model.shapedirs))
        np.savez(os.path.join(model_dir, f'{fidx:06d}.npz'),
                 minimal_shape=v_shaped.astype(np.float32),
                 betas=betas,
                 trans=trans.astype(np.float32),
                 root_orient=pose[:3], pose_body=pose[3:66],
                 pose_hand=pose[66:],
                 Jtr_posed=out.joints_posed[0].numpy() + trans,
                 bone_transforms=out.rel_transforms[0].numpy())

        verts_world = out.verts[0].numpy() + trans
        for v, (K, R, T) in cams.items():
            pc = verts_world @ R.T + T
            depth = pc[:, 2]
            proj = pc[:, :2] / np.maximum(depth[:, None], 1e-6)
            proj = proj * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
            face_buf, _, _ = native.rasterize_mesh(proj, depth, faces,
                                                   H, W)
            sil = (face_buf >= 0).astype(np.uint8)
            img = np.zeros((H, W, 3), np.uint8)
            img[sil > 0] = BODY_RGB
            for p in (img_path(v, fidx), mask_path(v, fidx)):
                os.makedirs(os.path.dirname(p), exist_ok=True)
            write_image(img_path(v, fidx), img)
            write_image(mask_path(v, fidx), sil * 255)


def make_fake_zju_dataset(root: str, subject='CoreView_313', n_frames=2,
                          views=('1', '7'), img_size=1024, n_verts=1024,
                          seed=0):
    """Writes {root}/{subject}/{cam}/*.jpg+png, models/*.npz,
    cam_params.json and {root}/body_models/misc/*.npz. Returns
    (misc_dir, model)."""
    rng = np.random.RandomState(seed)
    model = synthetic_smpl(n_verts=n_verts, seed=seed)
    misc_dir = os.path.join(root, 'body_models', 'misc')
    write_smpl_misc(misc_dir, model)

    sdir = os.path.join(root, subject)
    os.makedirs(os.path.join(sdir, 'models'), exist_ok=True)

    cam_params = {'all_cam_names': list(views)}
    cams = {}
    for i, v in enumerate(views):
        K, R, T = _camera(360.0 * i / max(len(views), 1),
                          c=img_size / 2)
        cam_params[v] = {'K': K.tolist(), 'R': R.tolist(),
                         'T': T.tolist(), 'D': [0, 0, 0, 0, 0]}
        cams[v] = (K, R, T)

    _write_frames(
        model, rng, n_frames, cams, (img_size, img_size),
        os.path.join(sdir, 'models'),
        lambda v, f: os.path.join(sdir, v, f'{f:06d}.jpg'),
        lambda v, f: os.path.join(sdir, v, f'{f:06d}.png'))
    with open(os.path.join(sdir, 'cam_params.json'), 'w') as f:
        json.dump(cam_params, f)
    return misc_dir, model


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(
        description='Write an on-disk fake ZJU dataset (see configs/fake/)')
    p.add_argument('--root', default='data/fake_zju')
    p.add_argument('--layout', choices=('zju',), default='zju')
    p.add_argument('--frames', type=int, default=8)
    p.add_argument('--views', default='1,7')
    p.add_argument('--verts', type=int, default=1024)
    p.add_argument('--img-size', type=int, default=1024)
    p.add_argument('--seed', type=int, default=0)
    args = p.parse_args(argv)
    misc, _ = make_fake_zju_dataset(
        args.root, n_frames=args.frames, views=tuple(args.views.split(',')),
        img_size=args.img_size, n_verts=args.verts, seed=args.seed)
    print(f'wrote {args.layout} fixture under {args.root} (misc: {misc})')


if __name__ == '__main__':
    main()
