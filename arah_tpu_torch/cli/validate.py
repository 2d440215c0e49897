"""Novel-view / novel-pose validation of a checkpoint trained by the port.

    python -m arah_tpu_torch.cli.validate CONFIG
        [--novel-view | --novel-pose [--novel-pose-view V]] [--chunk N]
        [--max-frames N] [--device cuda|cpu]

The contract of the JAX package's `validate.py` on one device:
--novel-view evaluates the held-out cameras on training frames
(subsampling rate 30); --novel-pose evaluates held-out frames (from one
view with --novel-pose-view, rate 1). Writes `metrics.json` and per-frame
PNGs (rgb, normal, gt) to `out_dir/val`. Runs on the GPU unless `--device
cpu` is given."""
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
    args = p.parse_args(argv)

    from arah_tpu_torch.cli.train import pick_device
    from arah_tpu_torch.config.factory import (get_dataset,
                                               init_params_from_cfg)
    from arah_tpu_torch.config.loader import (default_config_path,
                                              load_config,
                                              model_config_from_cfg)
    from arah_tpu_torch.eval.evaluator import evaluate_frame, save_image
    from arah_tpu_torch.parallel.train_step import TrainState
    from arah_tpu_torch.train import checkpoints as ckpt_lib
    from arah_tpu_torch.utils.lpips import metric_key

    device = pick_device(args.device)
    cfg = load_config(args.config, default_config_path())
    model_cfg = model_config_from_cfg(cfg)

    if args.novel_pose_view is not None:
        if not args.novel_pose:
            p.error('--novel-pose-view needs --novel-pose')
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
    n = len(dataset) if args.max_frames < 0 \
        else min(args.max_frames, len(dataset))
    rows = []
    for i in range(n):
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
                           chunk=args.chunk)
        row = {k: float(m[k]) for k in ('psnr', 'ssim', perc_key)}
        rows.append(row)
        save_image(os.path.join(out_dir, f'rgb_{i:06d}.png'), m['rgb_pred'])
        save_image(os.path.join(out_dir, f'normal_{i:06d}.png'),
                   m['normal_pred'])
        save_image(os.path.join(out_dir, f'gt_{i:06d}.png'), m['rgb_gt'])
        print(f'[{i + 1}/{n}] ' + ' '.join(
            f'{k}={v:.4f}' for k, v in row.items())
            + f' ({time.perf_counter() - t0:.2f} s)', flush=True)

    summary = {k: float(np.mean([r[k] for r in rows]))
               for k in ('psnr', 'ssim', perc_key)}
    with open(os.path.join(out_dir, 'metrics.json'), 'w') as f:
        json.dump({'per_frame': rows, 'mean': summary}, f, indent=2)
    print('mean:', summary)


if __name__ == '__main__':
    main()
