"""Train an avatar with the port.

    python -m arah_tpu_torch.cli.train CONFIG [--epochs-per-run N]
        [--exit-after SECONDS] [--profile-dir DIR] [--seed S]
        [--device cuda|cuda:K|cpu] [--devices N]
        [--coordinator HOST:PORT --num-processes N --process-id R]
        [--dist-backend nccl|gloo]

The contract of the JAX package's `train.py`: the config inherits
`configs/default.yaml`; a run resumes from `out_dir/checkpoints`;
`--epochs-per-run N` trains N more epochs than the checkpoint's (job
chaining, which skips periodic validation, as the reference does);
`--exit-after` checkpoints and exits with code 2 ("relaunch me") once
the time is spent. Runs on the GPU unless `--device cpu` is given; with
no GPU it raises.

Data parallelism, one device a process (`parallel/distributed.py`):
`--devices N` starts min(N, CUDA devices) local ranks (N with `--device
cpu`: gloo ranks on the CPU); `--coordinator --num-processes
--process-id` join a group started elsewhere (one process a rank, rank 0
at the coordinator's address), and torchrun's environment is read when
no flag is given. Rank r runs on `cuda:<local rank>` unless `--device`
names a device. `--dist-backend` is the one flag JAX's CLI lacks (JAX
picks its own transport): nccl by default on CUDA, gloo on the CPU; two
ranks may share one GPU under gloo only. A rank that fails makes the
others stop (after at most 10 minutes in a collective) and the CLI exit
non-zero."""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch


def add_dist_flags(p: argparse.ArgumentParser, devices_help: str):
    """The multi-process flags the three CLIs share."""
    p.add_argument('--devices', type=int, default=None, help=devices_help)
    p.add_argument('--coordinator', default=None,
                   help='HOST:PORT of rank 0 (the process group\'s store)')
    p.add_argument('--num-processes', type=int, default=None)
    p.add_argument('--process-id', type=int, default=None)
    p.add_argument('--dist-backend', choices=('nccl', 'gloo'), default=None,
                   help='default: nccl on CUDA, gloo on the CPU')


def run_in_group(p: argparse.ArgumentParser, args, argv, module: str,
                 body):
    """body(args, device) in this rank's place: the local ranks of
    `--devices N` are started (each running `module`'s main with the
    manual flags) and waited for, a non-zero common exit code raised as
    SystemExit; or this process joins the group that the flags or
    torchrun's environment name, runs body on its device, and leaves
    the group it joined."""
    from arah_tpu_torch.parallel import distributed
    device, joined = _join_group(p, args, argv, module)
    if device is None:
        return
    try:
        body(args, device)
    finally:
        if joined:
            distributed.shutdown()


def _join_group(p: argparse.ArgumentParser, args, argv, module: str):
    """(this rank's device, whether this call started the group); the
    device is None once `--devices N`'s local ranks have run."""
    from arah_tpu_torch.parallel import distributed
    manual = (args.coordinator, args.num_processes, args.process_id)
    if any(v is not None for v in manual) and any(v is None for v in manual):
        p.error('--coordinator, --num-processes and --process-id go '
                'together')
    if args.devices is not None and args.devices < 1:
        p.error('--devices must be at least 1')
    if args.num_processes is not None and not (
            0 <= args.process_id < args.num_processes):
        p.error('--process-id must lie in [0, --num-processes)')
    in_group = args.num_processes is not None \
        or distributed.process_count() > 1 or 'RANK' in os.environ
    n = args.devices or 1
    if n > 1 and not in_group:
        if torch.device(args.device).type == 'cuda' \
                and torch.device(args.device).index is None:
            n = min(n, max(torch.cuda.device_count(), 1))
        if n > 1:
            argv = list(sys.argv[1:] if argv is None else argv)
            code = distributed.launch_local(module, argv, n)
            if code:
                raise SystemExit(code)
            return None, False
    joined = not torch.distributed.is_initialized()
    device = distributed.initialize(
        args.coordinator, args.num_processes, args.process_id,
        backend=args.dist_backend, device=args.device)
    return device, joined and torch.distributed.is_initialized()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('config')
    p.add_argument('--epochs-per-run', type=int, default=-1)
    p.add_argument('--exit-after', type=float, default=None)
    p.add_argument('--profile-dir', default=None)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--device', default='cuda')
    add_dist_flags(p, 'data-parallel training on N local ranks, one '
                      'device each')
    args = p.parse_args(argv)
    run_in_group(p, args, argv, 'arah_tpu_torch.cli.train', _main)


def _main(args, device):
    from arah_tpu_torch.config.factory import (get_dataset,
                                               init_params_from_cfg)
    from arah_tpu_torch.config.loader import (default_config_path,
                                              load_config,
                                              loss_weights_from_cfg,
                                              model_config_from_cfg,
                                              optim_config_from_cfg)
    from arah_tpu_torch.train.trainer import train

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
