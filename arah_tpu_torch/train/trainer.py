"""Training loop: epochs over frames, checkpoints, logging, validation and
profiling. Port of `arah_tpu/train/trainer.py`: the epoch loop over the
frame sampler with background prefetching (`data/loader.py`), the train
step (`parallel/train_step.py`), resume from `out_dir/checkpoints` (job
chaining), `exit_after` timed exit, periodic validation with the best
step in `BEST.json`, TSV/stdout metrics, and a `torch.profiler` trace of
steps 8-10 under `profile_dir`, with the port's spans (`utils/trace.py`)
and beside it the counts they took (`counters.json`).

In a process group of several ranks (`parallel/distributed.py`) the run
is data parallel, as JAX's over its mesh: each rank takes its shard of
every frame's views (or of the multi-frame permutation), the step
averages the gradients over the ranks, and rank 0 alone logs, writes
`META.json` and validates; checkpoints are written by rank 0 between
barriers; rank 0's `exit_after` decision is broadcast every step, so that
all ranks stop together.

The randomness the JAX step draws from `fold_in(key, step)` comes from a
numpy `RandomState` seeded by (seed, step) (`data/batch.py:
draw_train_draws`), drawn for the global step's blocks, each rank
keeping its own. The host draws of a batch, the dataset's rays and
regulariser points and then the pose/view input noise, come from a
generator of the batch's own, seeded by (seed, epoch, rank, k) for the
epoch's k-th batch (`Prefetcher(seed=...)`), so that a run repeats with
any number of prefetch workers. (JAX's dataset draws from an unseeded
generator and its noise under a lock in whatever order its threads take
it.)"""
from __future__ import annotations

import json
import os
import time
import numpy as np
import torch

from arah_tpu_torch.data.batch import draw_train_draws, sample_noise
from arah_tpu_torch.data.loader import (FrameBatchSampler,
                                        MultiFrameBatchSampler, Prefetcher,
                                        batch_to_device,
                                        collate_train_batch_np)
from arah_tpu_torch.parallel import distributed
from arah_tpu_torch.parallel.train_step import (TrainState, make_train_step,
                                                trainable)
from arah_tpu_torch.train import checkpoints as ckpt_lib
from arah_tpu_torch.train.optim import make_optimizer
from arah_tpu_torch.utils import trace

VAL_MAX_FRAMES = 4      # frames of each periodic validation


class MetricLogger:
    """TSV + stdout metrics. The header is checked against the current
    metric columns on every run: resuming with another loss set appends
    a fresh header row instead of misaligning the columns."""

    def __init__(self, out_dir: str, log_every: int = 10,
                 filename: str = 'metrics.tsv'):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, filename)
        self.log_every = log_every
        self._columns = self._last_header()

    def _last_header(self):
        if not os.path.exists(self.path):
            return None
        cols = None
        with open(self.path) as f:
            for line in f:
                first = line.split('\t', 1)[0]
                if first == 'step':
                    cols = line.rstrip('\n').split('\t')[1:]
        return cols

    def log(self, step: int, metrics: dict):
        if step % self.log_every:
            return
        vals = {k: float(v) for k, v in metrics.items()}
        if self._columns != list(vals):
            with open(self.path, 'a') as f:
                f.write('step\t' + '\t'.join(vals) + '\n')
            self._columns = list(vals)
        with open(self.path, 'a') as f:
            f.write(f'{step}\t' + '\t'.join(f'{v:.6g}'
                                            for v in vals.values()) + '\n')
        print(f'[step {step}] ' + ' '.join(
            f'{k}={v:.4g}' for k, v in vals.items()), flush=True)


def step_rng(seed: int, step: int) -> np.random.RandomState:
    """The step's draws' generator: a function of (seed, step) alone, so
    that a resumed run draws what an unbroken one would."""
    return np.random.RandomState([seed, step])


def train(cfg: dict, model_cfg, loss_w, optim_cfg, dataset, params,
          max_epochs: int | None = None, exit_after: float | None = None,
          profile_dir: str | None = None, pose_input_noise: bool = False,
          view_input_noise: bool = False, nv_noise_type: str = 'rotation',
          seed: int = 0, smpl_model=None, refine_smpl: bool = False,
          refine_cameras: bool = False, val_dataset=None):
    """Run training on the parameters' device; returns (final TrainState,
    stopped_early). Resumes from `out_dir/checkpoints` when there is one;
    `stopped_early` is True when `exit_after` fired (the CLI then exits
    with code 2). The checkpoint and validation periods come from
    `cfg['training']`. In a process group of several ranks the mesh is
    every rank of it (`parallel/mesh.py:make_mesh`)."""
    from arah_tpu_torch.parallel.mesh import make_mesh
    device = params['deviation']['variance'].device
    rank = distributed.process_index()
    world = distributed.process_count()
    is_main = rank == 0
    mesh = make_mesh() if world > 1 else None
    out_dir = cfg['training']['out_dir']
    ckpt_dir = os.path.join(out_dir, 'checkpoints')
    os.makedirs(ckpt_dir, exist_ok=True)
    logger = MetricLogger(out_dir) if is_main else None

    params = trainable(params)
    optimizer, _ = make_optimizer(optim_cfg, params)
    state = TrainState(params, optimizer, 0)

    start_epoch = 0
    restored, step = ckpt_lib.restore_checkpoint(ckpt_dir, state)
    if restored is not None:
        state = restored
        meta_path = os.path.join(ckpt_dir, 'META.json')
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                start_epoch = json.load(f).get('epoch', 0)
        print(f'resumed from step {step} (epoch {start_epoch})', flush=True)
    # DDP's start: every replica from rank 0's parameters and Adam state
    distributed.replicate_over_mesh(state, mesh)

    # per-block-frame mode (`training.multi_frame_batch: true`): each ray
    # block carries its own frame
    multi_frame = bool(cfg['training'].get('multi_frame_batch', False))
    step_fn = make_train_step(model_cfg, loss_w, optimizer, mesh=mesh,
                              smpl_model=smpl_model,
                              refine_smpl=refine_smpl,
                              refine_cameras=refine_cameras,
                              per_block_frame=multi_frame)
    # each rank its shard of the views (JAX's per-process sampler); one
    # device a rank, so no block padding (JAX's block_multiple is 1)
    if multi_frame:
        sampler = MultiFrameBatchSampler(dataset, 1, shuffle=True,
                                         seed=seed, shard_id=rank,
                                         num_shards=world)
    else:
        sampler = FrameBatchSampler(dataset, shuffle=True, seed=seed,
                                    shard_id=rank, num_shards=world)
    if max_epochs is None:
        max_epochs = cfg['training'].get('max_epochs', 250)
    checkpoint_every_n_epochs = cfg['training'].get(
        'checkpoint_every_n_epochs', 10)
    validate_every_n_epochs = cfg['training'].get(
        'validate_every_n_epochs', 0) if val_dataset is not None else 0
    # periodic validation on rank 0 alone (JAX's is too)
    val_logger = MetricLogger(out_dir, log_every=1,
                              filename='val_metrics.tsv') \
        if (val_dataset is not None and validate_every_n_epochs
            and is_main) else None

    best_path = os.path.join(ckpt_dir, 'BEST.json')
    best_psnr = -float('inf')
    if os.path.exists(best_path):
        with open(best_path) as f:
            best_psnr = json.load(f).get('val_psnr', -float('inf'))

    def run_validation(epoch, state):
        """Periodic validation of the first VAL_MAX_FRAMES frames; a new
        best PSNR saves the state and `BEST.json`."""
        nonlocal best_psnr
        from arah_tpu_torch.eval.evaluator import evaluate_frame
        params = state.params
        rows = []
        for i in range(min(VAL_MAX_FRAMES, len(val_dataset))):
            item = val_dataset[i]
            latent = None
            if 'latent' in params:
                d_idx = min(int(item['inputs.data_idx']),
                            params['latent'].shape[0] - 1)
                latent = params['latent'][d_idx].detach()
            m = evaluate_frame(params, model_cfg, item, latent)
            rows.append({k: float(m[k]) for k in ('psnr', 'ssim')})
        agg = {f'val_{k}': float(np.mean([r[k] for r in rows]))
               for k in rows[0]} if rows else {}
        agg['epoch'] = epoch
        val_logger.log(int(state.step), agg)
        if agg.get('val_psnr', -float('inf')) > best_psnr:
            best_psnr = agg['val_psnr']
            if world == 1:
                # the save meets every rank at a barrier, and only rank 0
                # validates: with several ranks BEST.json names the step
                # and the nearest periodic checkpoint holds it, as in JAX
                ckpt_lib.save_checkpoint(ckpt_dir, int(state.step), state)
            with open(best_path, 'w') as f:
                json.dump({'step': int(state.step), 'epoch': epoch,
                           'val_psnr': best_psnr,
                           'val_ssim': agg.get('val_ssim')}, f)

    def save(epoch):
        ckpt_lib.save_checkpoint(ckpt_dir, int(state.step), state)
        if is_main:
            with open(os.path.join(ckpt_dir, 'META.json'), 'w') as f:
                json.dump({'epoch': epoch, 'step': int(state.step)}, f)

    # host-side augmentation: numpy in the prefetch workers, from the
    # batch's own generator (`Prefetcher(seed=...)`)
    def collate(items, rng):
        noise = None
        if pose_input_noise or view_input_noise:
            n_rays = np.asarray(items[0]['inputs.ray_dirs']).shape[0]
            noise = sample_noise(rng, len(items), pose_input_noise,
                                 view_input_noise, nv_noise_type,
                                 n_rays=n_rays)
        return collate_train_batch_np(items, noise,
                                      per_block_frame=multi_frame)

    t_start = time.time()
    prof = None
    stop = False
    done = start_epoch
    for epoch in range(start_epoch, max_epochs):
        with Prefetcher(dataset, sampler, collate,
                        postprocess=lambda b: batch_to_device(b, device),
                        seed=(seed, epoch, rank)) as prefetcher:
            for batch in prefetcher:
                step_i = int(state.step)
                if profile_dir and step_i == 8:
                    from torch.profiler import ProfilerActivity, profile
                    acts = [ProfilerActivity.CPU] + (
                        [ProfilerActivity.CUDA] if device.type == 'cuda'
                        else [])
                    prof = profile(activities=acts)
                    prof.__enter__()
                n_local = batch.ray_dirs.shape[0]
                draws = draw_train_draws(
                    step_rng(seed, step_i), model_cfg, world * n_local,
                    batch.ray_dirs.shape[1], device=device,
                    blocks=slice(rank * n_local, (rank + 1) * n_local))
                state, losses = step_fn(state, batch, draws)
                if logger is not None:
                    logger.log(step_i, losses)
                if prof is not None and step_i == 10:
                    if device.type == 'cuda':
                        torch.cuda.synchronize()
                    prof.__exit__(None, None, None)
                    os.makedirs(profile_dir, exist_ok=True)
                    prof.export_chrome_trace(os.path.join(
                        profile_dir, 'trace.json' if is_main
                        else f'trace_rank{rank}.json'))
                    with open(os.path.join(
                            profile_dir, 'counters.json' if is_main
                            else f'counters_rank{rank}.json'), 'w') as f:
                        json.dump(trace.take_counts(), f, indent=1,
                                  sort_keys=True)
                    prof = None
                if exit_after is not None:
                    # every rank must take rank 0's decision, or a lone
                    # stop strands the others in the next all-reduce
                    over = bool(distributed.broadcast_one_to_all(
                        time.time() - t_start > exit_after))
                    if over:
                        print('exit-after reached; checkpointing',
                              flush=True)
                        stop = True
                        break
        if stop:
            break
        done = epoch + 1
        if done % checkpoint_every_n_epochs == 0:
            save(done)
        if val_logger is not None and done % validate_every_n_epochs == 0:
            run_validation(done, state)
    if prof is not None:
        # the run ended inside the profiled steps: no trace, no counts
        prof.__exit__(None, None, None)
        trace.take_counts()
    save(done)
    return state, stop
