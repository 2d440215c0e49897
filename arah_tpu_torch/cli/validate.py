"""Novel-view / novel-pose validation of a checkpoint trained by the port.

    python -m arah_tpu_torch.cli.validate CONFIG
        [--novel-view | --novel-pose [--novel-pose-view V]] [--chunk N]
        [--max-frames N] [--device cuda|cuda:K|cpu] [--devices N]
        [--coordinator HOST:PORT --num-processes N --process-id R]
        [--dist-backend nccl|gloo]

The contract of the JAX package's `validate.py`: --novel-view evaluates
the held-out cameras on training frames (subsampling rate 30);
--novel-pose evaluates held-out frames (from one view with
--novel-pose-view, rate 1). Writes `metrics.json` and per-frame PNGs
(rgb, normal, gt) to `out_dir/val`. Runs on the GPU unless `--device
cpu` is given.

Several processes (the flags of `cli/train.py`) split the frames: rank r
evaluates frames r, r + P, ...; the metric rows are gathered (padded
with -1 to one length, then trimmed) and rank 0 writes `metrics.json`.
`--devices N` instead splits every ray chunk over N ranks (started
locally unless the flags name a group), each rank on its own device, and
rank 0 writes the PNGs and `metrics.json`."""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('config')
    p.add_argument('--novel-view', action='store_true')
    p.add_argument('--novel-pose', action='store_true')
    p.add_argument('--novel-pose-view', default=None,
                   help='evaluate novel poses from this single view '
                        '(subsampling rate 1)')
    p.add_argument('--chunk', type=int, default=None,
                   help='eval ray chunk; default: pad-aware auto-chunk '
                   '(evaluator.pick_eval_chunk)')
    p.add_argument('--max-frames', type=int, default=-1)
    p.add_argument('--device', default='cuda')
    from arah_tpu_torch.cli.train import add_dist_flags, run_in_group
    add_dist_flags(p, 'split every eval ray chunk over N ranks, one '
                      'device each')
    args = p.parse_args(argv)
    if args.novel_pose_view is not None and not args.novel_pose:
        p.error('--novel-pose-view needs --novel-pose')
    run_in_group(p, args, argv, 'arah_tpu_torch.cli.validate', _main)


def _main(args, device):
    from arah_tpu_torch.config.factory import (get_dataset,
                                               init_params_from_cfg)
    from arah_tpu_torch.config.loader import (default_config_path,
                                              load_config,
                                              model_config_from_cfg)
    from arah_tpu_torch.eval.evaluator import evaluate_frame, save_image
    from arah_tpu_torch.parallel.train_step import TrainState
    from arah_tpu_torch.train import checkpoints as ckpt_lib
    from arah_tpu_torch.parallel import distributed
    from arah_tpu_torch.utils.lpips import metric_key

    cfg = load_config(args.config, default_config_path())
    model_cfg = model_config_from_cfg(cfg)

    if args.novel_pose_view is not None:
        dataset = get_dataset('test', cfg, subsampling_rate=1,
                              view_split=[args.novel_pose_view])
    elif args.novel_view and not args.novel_pose:
        dataset = get_dataset('val', cfg, subsampling_rate=30)
    else:
        dataset = get_dataset('test' if args.novel_pose else 'val', cfg)

    train_ds = get_dataset('train', cfg)
    params = init_params_from_cfg(0, cfg, model_cfg, train_ds, mode='val',
                                  device=device)
    ckpt_dir = os.path.join(cfg['training']['out_dir'], 'checkpoints')
    restored, step = ckpt_lib.restore_checkpoint(
        ckpt_dir, TrainState(params, None, 0))
    if restored is not None:
        print(f'loaded checkpoint step {step}')
    else:
        print('WARNING: no checkpoint found; evaluating random init')

    out_dir = os.path.join(cfg['training']['out_dir'], 'val')
    os.makedirs(out_dir, exist_ok=True)
    perc_key = metric_key()
    keys = ('psnr', 'ssim', perc_key)
    n = len(dataset) if args.max_frames < 0 \
        else min(args.max_frames, len(dataset))
    rank, world = distributed.process_index(), distributed.process_count()
    mesh = None
    if (args.devices or 1) > 1 and world > 1:
        from arah_tpu_torch.parallel.mesh import make_mesh
        mesh = make_mesh()
        print(f'sharded eval over {world} ranks', flush=True)
    # frames split over the ranks, unless every rank renders a share of
    # every chunk
    mine = range(n) if mesh is not None else range(rank, n, world)
    writer = mesh is None or rank == 0
    local_rows = []
    for i in mine:
        t0 = time.perf_counter()
        item = dataset[i]
        latent = None
        if 'latent' in params:
            d_idx = int(item['inputs.data_idx'])
            if item.get('inputs.novel_seq') \
                    or d_idx >= params['latent'].shape[0]:
                d_idx = params['latent'].shape[0] - 1
            latent = params['latent'][d_idx]
        m = evaluate_frame(params, model_cfg, item, latent,
                           chunk=args.chunk, mesh=mesh)
        row = {k: float(m[k]) for k in keys}
        local_rows.append([float(i)] + [row[k] for k in keys])
        if writer:
            for kind, key in (('rgb', 'rgb_pred'), ('normal', 'normal_pred'),
                              ('gt', 'rgb_gt')):
                save_image(os.path.join(out_dir, f'{kind}_{i:06d}.png'),
                           m[key])
        print(f'[{i + 1}/{n}] ' + ' '.join(
            f'{k}={v:.4f}' for k, v in row.items())
            + f' ({time.perf_counter() - t0:.2f} s)', flush=True)

    rows = np.asarray(local_rows, np.float64).reshape(-1, 1 + len(keys))
    if world > 1 and mesh is None:
        # ragged shares: pad to one length with -1, gather, trim, order
        pad = np.full((-(-n // world), rows.shape[1]), -1.0)
        pad[:len(rows)] = rows
        rows = distributed.process_allgather(pad).reshape(-1, rows.shape[1])
        rows = rows[rows[:, 0] >= 0]
        rows = rows[np.argsort(rows[:, 0])]
    per_frame = [dict(zip(keys, map(float, r[1:]))) for r in rows]
    summary = {k: float(np.mean([r[k] for r in per_frame])) for k in keys}
    if rank == 0:
        with open(os.path.join(out_dir, 'metrics.json'), 'w') as f:
            json.dump({'per_frame': per_frame, 'mean': summary}, f, indent=2)
        print('mean:', summary)


if __name__ == '__main__':
    main()
