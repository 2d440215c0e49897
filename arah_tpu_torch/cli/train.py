"""Train an avatar with the port.

    python -m arah_tpu_torch.cli.train CONFIG [--epochs-per-run N]
        [--exit-after SECONDS] [--profile-dir DIR] [--seed S]
        [--device cuda|cpu]

The contract of the JAX package's `train.py`: the config inherits
`configs/default.yaml`; a run resumes from `out_dir/checkpoints`;
`--epochs-per-run N` trains N more epochs than the checkpoint's (job
chaining, which skips periodic validation, as the reference does);
`--exit-after` checkpoints and exits with code 2 ("relaunch me") once
the time is spent. Runs on the GPU unless `--device cpu` is given; with
no GPU it raises. One device only (multi-GPU is not ported)."""
from __future__ import annotations

import argparse
import json
import os

import torch


def pick_device(name: str) -> torch.device:
    """The run's device: `cuda` must exist (no silent fall back)."""
    if name.startswith('cuda') and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: pass --device cpu to run on '
                           'the CPU')
    return torch.device(name)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('config')
    p.add_argument('--epochs-per-run', type=int, default=-1)
    p.add_argument('--exit-after', type=float, default=None)
    p.add_argument('--profile-dir', default=None)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--device', default='cuda')
    args = p.parse_args(argv)

    from arah_tpu_torch.config.factory import (get_dataset,
                                               init_params_from_cfg)
    from arah_tpu_torch.config.loader import (default_config_path,
                                              load_config,
                                              loss_weights_from_cfg,
                                              model_config_from_cfg,
                                              optim_config_from_cfg)
    from arah_tpu_torch.train.trainer import train

    device = pick_device(args.device)
    cfg = load_config(args.config, default_config_path())
    model_cfg = model_config_from_cfg(cfg)
    loss_w = loss_weights_from_cfg(cfg)
    optim_cfg = optim_config_from_cfg(cfg)

    dataset = get_dataset('train', cfg)
    params = init_params_from_cfg(args.seed, cfg, model_cfg, dataset,
                                  mode='train', device=device)

    max_epochs = cfg['training'].get('max_epochs', 250)
    if args.epochs_per_run > 0:
        ckpt_meta = os.path.join(cfg['training']['out_dir'], 'checkpoints',
                                 'META.json')
        cur = 0
        if os.path.exists(ckpt_meta):
            with open(ckpt_meta) as f:
                cur = json.load(f).get('epoch', 0)
        max_epochs = min(max_epochs, cur + args.epochs_per_run)

    smpl_model = None
    refine_smpl = bool(cfg['model'].get('train_smpl'))
    if refine_smpl:
        from arah_tpu_torch.core.smpl import load_smpl_assets
        smpl_model = load_smpl_assets(
            cfg['data'].get('smpl_misc', 'body_models/misc'), device=device)

    # periodic validation; job-chaining runs skip it, as the reference does
    val_dataset = None
    val_every = cfg['training'].get('validate_every_n_epochs', 0)
    if val_every and args.epochs_per_run <= 0 \
            and cfg['data'].get('val_split'):
        try:
            val_dataset = get_dataset('val', cfg)
        except (OSError, AssertionError, KeyError) as e:
            print(f'periodic validation disabled (no val data: {e})')

    _, stopped = train(
        cfg, model_cfg, loss_w, optim_cfg, dataset, params,
        max_epochs=max_epochs, exit_after=args.exit_after,
        profile_dir=args.profile_dir,
        pose_input_noise=cfg['training'].get('pose_input_noise', False),
        view_input_noise=cfg['training'].get('view_input_noise', False),
        nv_noise_type=cfg['training'].get('nv_noise_type', 'rotation'),
        seed=args.seed, smpl_model=smpl_model, refine_smpl=refine_smpl,
        refine_cameras=bool(cfg['model'].get('train_cameras')),
        val_dataset=val_dataset)
    if stopped:
        # the timed-exit contract: exit code 2 signals "relaunch me"
        raise SystemExit(2)


if __name__ == '__main__':
    main()
