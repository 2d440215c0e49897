"""Datasets and parameter trees from config dicts. Port of
`arah_tpu/config/factory.py`: `get_dataset` (the ZJU-MoCap reader; the
other datasets raise, their readers are not ported) and
`init_params_from_cfg` (the latent table sized to the training frames,
the pretrained MetaAvatar SDF and SNARF skinning checkpoints, the
learnable per-frame SMPL and per-camera leaves).

The leaf initialisers are duck-typed on the dataset: `data` (records with
`cam_idx` and `model_file`, an npz of root_orient, pose_body, pose_hand,
trans and optionally betas), `cam_names` and `cameras` (name -> dict with
R, T)."""
from __future__ import annotations

import numpy as np
import torch


def get_dataset(mode: str, cfg: dict, view_split=None, subsampling_rate=None,
                start_frame=None, end_frame=None):
    d = cfg['data']
    dataset_type = d['dataset']
    splits = {'train': d['train_split'], 'val': d['val_split'],
              'test': d['test_split']}[mode]
    views = view_split if view_split is not None else {
        'train': d.get('train_views') or (),
        'val': d.get('val_views') or (),
        'test': d.get('test_views') or ()}[mode]
    rate = subsampling_rate if subsampling_rate is not None \
        else d.get(f'{mode}_subsampling_rate', 1)
    start = start_frame if start_frame is not None \
        else d.get(f'{mode}_start_frame', 0)
    end = end_frame if end_frame is not None \
        else d.get(f'{mode}_end_frame', -1)

    # image resolution: fixed per dataset type, `high_res` doubles it for
    # training only; `data.img_size` overrides both
    img_size = d.get('img_size')
    if img_size is None:
        hi = bool(d.get('high_res')) and mode == 'train'
        img_size = {
            'people_snapshot': (1080, 1080) if hi else (540, 540),
            'h36m': (1002, 1000),
        }.get(dataset_type, (1024, 1024) if hi else (512, 512))

    common = dict(
        smpl_misc_dir=d.get('smpl_misc', 'body_models/misc'),
        img_size=tuple(img_size),
        subjects=tuple(splits), mode=mode,
        num_fg_samples=d.get('num_fg_samples', 1024),
        num_bg_samples=d.get('num_bg_samples', 1024),
        sampling_rate=rate, start_frame=start, end_frame=end,
        views=tuple(views),
        off_surface_thr=d.get('off_surface_thr', 0.2),
        inside_thr=d.get('inside_thr', 0.001),
        box_margin=d.get('box_margin', 0.05),
        sample_reg_surface=d.get('sample_reg_surface', False),
        sample_inside=cfg['training'].get('inside_weight', 0.0) > 0,
        erode_mask=d.get('erode_mask', True),
        # patch rays for the perceptual loss, appended after the
        # per-ray-loss rays, train mode only
        sample_patch=(cfg['training'].get('patch_size', 48)
                      if mode == 'train'
                      and cfg['training'].get('perceptual_weight', 0.0) > 0
                      else 0),
    )

    if dataset_type == 'zju_mocap':
        from arah_tpu_torch.data.human_video import ZJUMoCapDataset
        return ZJUMoCapDataset(d['path'], **common)
    if dataset_type in ('h36m', 'people_snapshot', 'zju_mocap_odp'):
        raise NotImplementedError(
            f'dataset {dataset_type!r}: its reader is not ported yet '
            '(ROADMAP.md, the host pipeline)')
    raise ValueError(f'unknown dataset {dataset_type}')


def init_params_from_cfg(seed: int, cfg: dict, model_cfg, dataset=None,
                         mode: str = 'train', device='cuda'):
    """The parameter tree of a config on `device`, drawn from `seed`: the
    latent table sized to the dataset's training frames, the pretrained
    checkpoints of `model.geometry_net` / `model.skinning_net2` loaded in
    train mode (by `torch.load`, through `train/checkpoints.py`'s
    converters), and the SMPL and camera leaves under `train_smpl` /
    `train_cameras`."""
    from arah_tpu_torch.model import init_model_params
    from arah_tpu_torch.train import checkpoints as ckpt_lib
    from arah_tpu_torch.utils.tree import tree_map

    train_latent = cfg['model'].get('color_pose_encoder') in (
        'hybrid', 'latent') or cfg['model'].get('geo_pose_encoder') in (
        'latent',)
    n_latent = 0
    if train_latent and dataset is not None:
        first_cam = dataset.data[0]['cam_idx']
        n_latent = sum(1 for rec in dataset.data
                       if rec['cam_idx'] == first_cam)
    n_cameras = len(dataset.cam_names) if (
        cfg['model'].get('train_cameras') and dataset is not None) else 0
    params = init_model_params(
        torch.Generator().manual_seed(seed), model_cfg,
        n_latent_frames=n_latent,
        latent_dim=cfg['model'].get('latent_dim', 128),
        n_cameras=n_cameras, device=device)

    if mode == 'train':
        geo_path = cfg['model'].get('geometry_net')
        if geo_path:
            sd = ckpt_lib.load_torch_checkpoint(geo_path)
            params['hypernet']['hypo_init'] = [
                t.to(device) for t in ckpt_lib.load_metaavatar_hypo_init(
                    sd, model_cfg.hypernet)]
        skin_path = cfg['model'].get('skinning_net2')
        if skin_path:
            sd = ckpt_lib.load_torch_checkpoint(skin_path)
            params['skinning'] = tree_map(
                lambda t: t.to(device), ckpt_lib.load_snarf_skinning(
                    sd, model_cfg.skinning.n_layers))

    if cfg['model'].get('train_smpl') and dataset is not None \
            and mode in ('train', 'val'):
        params.update(smpl_refine_params_from_dataset(dataset, device))
    if cfg['model'].get('train_cameras') and dataset is not None \
            and mode in ('train', 'val'):
        params['cam_rots'], params['cam_trans'] = \
            camera_params_from_dataset(dataset, device)
    return params


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
