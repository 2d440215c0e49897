"""Training-batch helpers. Port of `arah_tpu/data/batch.py:identity_noise`
and `synthetic_train_batch`, with the same laws drawn from a numpy
`RandomState` (not the same numbers as `jax.random`), and
`draw_train_draws`, the step's random draws that the JAX step takes from
its key."""
from __future__ import annotations

import numpy as np
import torch

from arah_tpu_torch.core.rays import ray_aabb
from arah_tpu_torch.model import FrameData
from arah_tpu_torch.parallel.train_step import TrainBatch, TrainDraws
from arah_tpu_torch.render.ray_tracing import jitter_shapes
from arah_tpu_torch.render.renderer import ModelConfig


def identity_noise(n_blocks: int, device='cuda'):
    """No-op augmentation fields (zero additive noise, identity view
    rotation)."""
    return dict(
        rots_noise=torch.zeros((n_blocks, 24, 9), device=device),
        view_noise=torch.eye(3, device=device).expand(n_blocks, 3, 3)
        .contiguous(),
        rot_noise=torch.zeros((n_blocks, 1, 9), device=device),
        trans_noise=torch.zeros((n_blocks, 1, 3), device=device))


def synthetic_train_batch(rng: np.random.RandomState, fd: FrameData,
                          n_blocks: int = 2, n_rays: int = 256,
                          n_reg: int = 64, latent_idx: int = 0
                          ) -> TrainBatch:
    """Random-but-valid training batch on a prepared frame: cameras
    around (0, 0.3, -2.5), rays aimed at random posed vertices, uniform
    rgb targets, an all-foreground mask and random regulariser points."""
    dev = fd.smpl.verts_posed.device

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
    V = fd.smpl.verts_posed.shape[0]
    cam_loc = t([0.0, 0.3, -2.5]) + t(rng.randn(n_blocks, 3) * 0.3)
    tgt = t(rng.randint(0, V, (n_blocks, n_rays)), torch.long)
    dirs = fd.smpl.verts_posed[tgt] - cam_loc[:, None, :]
    dirs = (dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)).contiguous()
    near, far, _ = ray_aabb(fd.bounds_min, fd.bounds_max,
                            cam_loc[:, None, :].expand(dirs.shape), dirs)
    return TrainBatch(
        cam_loc=cam_loc, ray_dirs=dirs, near=near.contiguous(),
        far=far.contiguous(),
        rgb_gt=t(rng.uniform(size=(n_blocks, n_rays, 3))),
        body_mask=torch.ones((n_blocks, n_rays), dtype=torch.int32,
                             device=dev),
        points_uniform=t((rng.uniform(size=(n_blocks, n_reg, 3)) - 0.5) * 2),
        points_skinning=t(rng.randn(n_blocks, n_reg, 3) * 0.2),
        points_inside=t(rng.randn(n_blocks, n_reg, 3) * 0.1),
        sampled_weights=torch.softmax(t(rng.randn(n_blocks, n_reg, 24)),
                                      dim=-1),
        **identity_noise(n_blocks, dev), uv=dirs,
        cam_idx=torch.arange(n_blocks, dtype=torch.int32, device=dev),
        frame=fd, latent_idx=latent_idx)


def draw_train_draws(rng: np.random.RandomState, cfg: ModelConfig,
                     n_blocks: int, n_rays: int, device='cuda') -> TrainDraws:
    """One step's draws: uniform sample jitter and cfg.n_eik_points
    eikonal points uniform in [-1, 1]^3, per block."""
    def u(shape):
        return torch.as_tensor(rng.uniform(size=shape).astype(np.float32),
                               device=device)
    s1, s2, s3 = jitter_shapes(cfg.tracer, n_rays)
    return TrainDraws(u((n_blocks,) + s1), u((n_blocks,) + s2),
                      u((n_blocks,) + s3),
                      (u((n_blocks, cfg.n_eik_points, 3)) - 0.5) * 2.0)
