"""Novel-pose animation of an avatar trained by the port: render it under
a pose sequence and write rgb and normal PNGs and `vis.mp4`.

    python -m arah_tpu_torch.cli.test CONFIG [--pose-dir DIR]
        [--start-frame A --end-frame B] [--test-views V] [--low-vram]
        [--chunk N] [--mesh-res R] [--free-viewpoint N]
        [--device cuda|cuda:K|cpu] [--devices N]
        [--coordinator HOST:PORT --num-processes N --process-id R]
        [--dist-backend nccl|gloo]

The contract of the JAX package's `test.py`: the config's
dataset is read as the pose-only ODP dataset (`data/odp.py`: the SMPL
files of `--pose-dir`, default `data.pose_dir`, seen from camera
`--test-views`); the checkpoint is restored from `out_dir/checkpoints`;
each frame renders its box rays (kernels A-F on the card, with the last
latent row, as for a novel sequence) and the canonical mesh's normal maps
(its SDF grid on kernel J, `eval/mesh_vis.py`), and writes
`out_dir/vis/{rgb,normal,front,back}_{i:06d}.png`; then `vis/vis.mp4`
holds each frame's four PNGs side by side, read back from the files.
The video is Motion-JPEG in an MP4 (`eval/evaluator.py:write_video`),
where JAX's is MPEG-4 Part 2. `--free-viewpoint N` moves each frame's
camera to one of N spiral cameras (`utils/camera_path.py`), cycling over
the frames; as in JAX the frame keeps the rays of the dataset's camera
and takes the spiral camera's position and extrinsics. Runs on the GPU
unless `--device cpu` is given.

Several processes (the flags of `cli/train.py`: `--devices`,
`--coordinator --num-processes --process-id`, `--dist-backend`) split
the frames: rank r renders frames r, r + P, ...; after a barrier rank 0
assembles `vis.mp4` from every rank's PNGs (one shared `out_dir`).
`--devices N` instead splits every ray chunk over N ranks, and rank 0
alone draws the meshes' normal maps and writes the PNGs."""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

PARTS = ('render', 'grid', 'marching_cubes', 'skinning', 'rasterize',
         'write')
KINDS = ('rgb', 'normal', 'front', 'back')


def spiral_cameras(dataset, n: int):
    """The `--free-viewpoint n` cameras: `gen_spiral_path` over the
    dataset's cameras, repeated to four as the JAX package's `test.py`
    does; a list of n (4, 4) world-to-camera matrices. With one camera
    the rig has no spread and every matrix is NaN, as in JAX."""
    from arah_tpu_torch.utils.camera_path import gen_spiral_path
    w2cs = []
    for name in dataset.cam_names:
        cam = dataset.cameras[name]
        m = np.eye(4)
        m[:3, :3] = np.asarray(cam['R'])
        m[:3, 3] = np.asarray(cam['T']).ravel()
        w2cs.append(m)
    return gen_spiral_path(w2cs * max(1, 4 // len(w2cs)),
                           num_render_views=n)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('config')
    p.add_argument('--pose-dir', default=None)
    p.add_argument('--start-frame', type=int, default=0)
    p.add_argument('--end-frame', type=int, default=-1)
    p.add_argument('--test-views', default='1')
    p.add_argument('--low-vram', action='store_true')
    p.add_argument('--chunk', type=int, default=None,
                   help='eval ray chunk; default: pad-aware auto-chunk '
                   '(evaluator.pick_eval_chunk)')
    p.add_argument('--mesh-res', type=int, default=256)
    p.add_argument('--free-viewpoint', type=int, default=0,
                   help='render N spiral novel views of each frame '
                        '(reference gen_path)')
    p.add_argument('--device', default='cuda')
    from arah_tpu_torch.cli.train import add_dist_flags, run_in_group
    add_dist_flags(p, 'split every render ray chunk over N ranks, one '
                      'device each')
    args = p.parse_args(argv)
    run_in_group(p, args, argv, 'arah_tpu_torch.cli.test', _main)


def _main(args, device):
    from arah_tpu_torch.config.factory import (get_dataset,
                                               init_params_from_cfg)
    from arah_tpu_torch.config.loader import (default_config_path,
                                              load_config,
                                              model_config_from_cfg)
    from arah_tpu_torch.data.loader import frame_from_item
    from arah_tpu_torch.data.odp import ODPDataset
    from arah_tpu_torch.eval.evaluator import (render_frame_rays,
                                               save_image, scatter_image,
                                               write_video)
    from arah_tpu_torch.eval.mesh_vis import render_normal_maps
    from arah_tpu_torch.parallel.train_step import TrainState
    from arah_tpu_torch.train import checkpoints as ckpt_lib
    from arah_tpu_torch.parallel import distributed
    from arah_tpu_torch.utils.image import read_image

    cfg = load_config(args.config, default_config_path())
    if args.low_vram:
        args.chunk = min(args.chunk or 4096, 2048)
    model_cfg = model_config_from_cfg(cfg)

    pose_dir = args.pose_dir or cfg['data'].get('pose_dir')
    dataset = ODPDataset(
        cfg['data']['path'], pose_dir=pose_dir,
        cam_name=str(args.test_views),
        smpl_misc_dir=cfg['data'].get('smpl_misc', 'body_models/misc'),
        subjects=tuple(cfg['data']['test_split']),
        start_frame=args.start_frame, end_frame=args.end_frame,
        box_margin=cfg['data'].get('box_margin', 0.05))

    # the parameters of a trained run, its SMPL and camera refinement
    # leaves included (the checkpoint restores by key)
    train_ds = get_dataset('train', cfg)
    params = init_params_from_cfg(0, cfg, model_cfg, train_ds, mode='val',
                                  device=device)
    ckpt_dir = os.path.join(cfg['training']['out_dir'], 'checkpoints')
    restored, step = ckpt_lib.restore_checkpoint(
        ckpt_dir, TrainState(params, None, 0))
    if restored is not None:
        print(f'loaded checkpoint step {step}')
    else:
        print('WARNING: no checkpoint found; rendering random init')

    vis_dir = os.path.join(cfg['training']['out_dir'], 'vis')
    os.makedirs(vis_dir, exist_ok=True)

    spiral = (spiral_cameras(dataset, args.free_viewpoint)
              if args.free_viewpoint > 0 else None)

    rank, world = distributed.process_index(), distributed.process_count()
    mesh = None
    if (args.devices or 1) > 1 and world > 1:
        from arah_tpu_torch.parallel.mesh import make_mesh
        mesh = make_mesh()
        print(f'sharded render over {world} ranks', flush=True)
    # frames split over the ranks, unless every rank renders a share of
    # every chunk (then rank 0 alone draws the normal maps and writes)
    mine = range(len(dataset)) if mesh is not None \
        else range(rank, len(dataset), world)
    writer = mesh is None or rank == 0
    latent = params['latent'][-1] if 'latent' in params else None
    for i in mine:
        times = {}
        t0 = time.perf_counter()
        item = dataset[i]
        if spiral is not None:
            # cycle the spiral cameras over frames
            m = spiral[i % len(spiral)]
            item['image.R'] = m[:3, :3].astype(np.float32)
            item['image.T'] = m[:3, 3].astype(np.float32)
            item['image.cam_loc'] = (-m[:3, :3].T @ m[:3, 3]
                                     ).astype(np.float32)
        fd = frame_from_item(item, device)
        rgb, _, _, _ = render_frame_rays(params, model_cfg, fd, item, latent,
                                         chunk=args.chunk, mesh=mesh)
        pred = scatter_image(rgb, np.asarray(item['inputs.image_mask']))
        times['render'] = time.perf_counter() - t0
        if not writer:
            continue
        normal, front, back = render_normal_maps(
            params, model_cfg, fd, item, latent, resolution=args.mesh_res,
            times=times)
        t0 = time.perf_counter()
        for kind, img in zip(KINDS, (pred, normal, front, back)):
            save_image(os.path.join(vis_dir, f'{kind}_{i:06d}.png'), img)
        times['write'] = time.perf_counter() - t0
        print(f'[{i + 1}/{len(dataset)}] rendered (' + ', '.join(
            f'{k} {times[k]:.3f} s' for k in PARTS if k in times) + ')',
            flush=True)

    # every rank's PNGs are on the shared out_dir before rank 0 reads them
    distributed.sync_global_devices('test_render_done')
    if rank != 0:
        return
    frames = []
    for i in range(len(dataset)):
        row = [read_image(os.path.join(vis_dir, f'{kind}_{i:06d}.png'))
               for kind in KINDS]
        frames.append(np.concatenate(row, axis=1))
    write_video(os.path.join(vis_dir, 'vis.mp4'), frames)
    print('wrote', os.path.join(vis_dir, 'vis.mp4'))


if __name__ == '__main__':
    main()
