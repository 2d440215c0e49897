"""Training-batch helpers. Port of `arah_tpu/data/batch.py`: the
augmentation fields (`identity_noise` on the device; `identity_noise_np`,
`augm_rots` and `sample_noise` in numpy, the same draws from the same
`RandomState` as JAX's), `synthetic_train_batch` with the same laws drawn
from a numpy `RandomState` (not the same numbers as `jax.random`), and
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
from arah_tpu_torch.utils.tree import tree_stack


def identity_noise(n_blocks: int, device='cuda'):
    """No-op augmentation fields (zero additive noise, identity view
    rotation)."""
    return dict(
        rots_noise=torch.zeros((n_blocks, 24, 9), device=device),
        view_noise=torch.eye(3, device=device).expand(n_blocks, 3, 3)
        .contiguous(),
        rot_noise=torch.zeros((n_blocks, 1, 9), device=device),
        trans_noise=torch.zeros((n_blocks, 1, 3), device=device))


def identity_noise_np(n_blocks: int, n_rays: int | None = None,
                      nv_noise_type: str = 'rotation'):
    """Host-side (numpy) no-op augmentation. For `nv_noise_type=
    'gaussian'` the view-noise field is per-ray additive (B, R, 3), so
    that its shape is the same whether the noise is applied or not."""
    if nv_noise_type == 'gaussian':
        assert n_rays is not None, 'gaussian view noise needs n_rays'
        view = np.zeros((n_blocks, n_rays, 3), np.float32)
    else:
        view = np.broadcast_to(np.eye(3, dtype=np.float32),
                               (n_blocks, 3, 3)).copy()
    return dict(
        rots_noise=np.zeros((n_blocks, 24, 9), np.float32),
        view_noise=view,
        rot_noise=np.zeros((n_blocks, 1, 9), np.float32),
        trans_noise=np.zeros((n_blocks, 1, 3), np.float32))


def _axis_rot(axis: int, deg: float) -> np.ndarray:
    sn, cs = np.sin(np.pi / 180.0 * deg), np.cos(np.pi / 180.0 * deg)
    i, j = [(1, 2), (0, 2), (0, 1)][axis]
    r = np.eye(3)
    r[i, i] = cs
    r[j, j] = cs
    # Rx and Rz put -sin above the diagonal, Ry below
    r[i, j], r[j, i] = (sn, -sn) if axis == 1 else (-sn, sn)
    return r


def augm_rots(rng: np.random.RandomState, roll_range: float = 45,
              pitch_range: float = 45, yaw_range: float = 45) -> np.ndarray:
    """The reference's clipped-Euler view-rotation augmentation: roll and
    yaw ~ clip(randn * range, +-2 range) degrees, pitch ~ rand() * range
    degrees (uniform, as the reference draws it), composed as
    Rx @ Ry @ Rz."""
    rx = min(2 * roll_range, max(-2 * roll_range, rng.randn() * roll_range))
    rot_x = _axis_rot(0, rx)
    ry = min(2 * pitch_range, max(-2 * pitch_range,
                                  rng.rand() * pitch_range))
    rot_y = _axis_rot(1, ry)
    rz = min(2 * yaw_range, max(-2 * yaw_range, rng.randn() * yaw_range))
    rot_z = _axis_rot(2, rz)
    return (rot_x @ rot_y @ rot_z).astype(np.float32)


def sample_noise(rng: np.random.RandomState, n_blocks: int,
                 pose_noise: bool, view_noise: bool,
                 nv_noise_type: str = 'rotation',
                 n_rays: int | None = None):
    """Training-time pose and view augmentation on the host (numpy, safe
    in prefetch workers): applied with probability 0.5 a step; std-0.1
    gaussians on the rotation matrices and the root pose; view noise one
    clipped-Euler rotation shared by every block ('rotation') or
    additive per-ray N(0, 0.1) ('gaussian')."""
    out = identity_noise_np(n_blocks, n_rays, nv_noise_type)
    if rng.uniform() > 0.5:
        return out
    if pose_noise:
        out['rots_noise'] = rng.normal(
            0, 0.1, (n_blocks, 24, 9)).astype(np.float32)
        out['rot_noise'] = rng.normal(
            0, 0.1, (n_blocks, 1, 9)).astype(np.float32)
        out['trans_noise'] = rng.normal(
            0, 0.1, (n_blocks, 1, 3)).astype(np.float32)
    if view_noise:
        if nv_noise_type == 'gaussian':
            out['view_noise'] = rng.normal(
                0, 0.1, (n_blocks, n_rays, 3)).astype(np.float32)
        elif nv_noise_type == 'rotation':
            R = augm_rots(rng, 45, 45, 45)
            out['view_noise'] = np.broadcast_to(
                R, (n_blocks, 3, 3)).copy()
        else:
            raise ValueError(f'unknown nv_noise_type {nv_noise_type!r}')
    return out


def synthetic_train_batch(rng: np.random.RandomState, fd: FrameData,
                          n_blocks: int = 2, n_rays: int = 256,
                          n_reg: int = 64, latent_idx: int = 0,
                          fds: list | None = None) -> TrainBatch:
    """Random-but-valid training batch on a prepared frame: cameras
    around (0, 0.3, -2.5), rays aimed at random posed vertices, uniform
    rgb targets, an all-foreground mask and random regulariser points.
    `fds`, a list of n_blocks FrameData, makes a per-block-frame batch
    (block b's rays aimed at frame b's vertices; the frame leaves stacked
    on a leading block dimension; latent indices 0..B-1) for
    `make_train_step(per_block_frame=True)`."""
    if fds is not None:
        assert len(fds) == n_blocks, (len(fds), n_blocks)
        fd = fds[0]
    dev = fd.smpl.verts_posed.device

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
    V = fd.smpl.verts_posed.shape[0]
    cam_loc = t([0.0, 0.3, -2.5]) + t(rng.randn(n_blocks, 3) * 0.3)
    tgt = t(rng.randint(0, V, (n_blocks, n_rays)), torch.long)
    if fds is not None:
        targets = torch.stack([f.smpl.verts_posed[tgt[b]]
                               for b, f in enumerate(fds)])
        bmin = torch.stack([f.bounds_min for f in fds])[:, None, :]
        bmax = torch.stack([f.bounds_max for f in fds])[:, None, :]
    else:
        targets = fd.smpl.verts_posed[tgt]
        bmin, bmax = fd.bounds_min, fd.bounds_max
    dirs = targets - cam_loc[:, None, :]
    dirs = (dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)).contiguous()
    near, far, _ = ray_aabb(bmin, bmax,
                            cam_loc[:, None, :].expand(dirs.shape), dirs)
    if fds is not None:
        frame = tree_stack(fds, torch.stack)
        latent_idx = torch.arange(n_blocks, dtype=torch.int32, device=dev)
    else:
        frame = fd
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
        frame=frame, latent_idx=latent_idx)


def draw_train_draws(rng: np.random.RandomState, cfg: ModelConfig,
                     n_blocks: int, n_rays: int, device='cuda',
                     blocks: slice | None = None) -> TrainDraws:
    """One step's draws: uniform sample jitter and cfg.n_eik_points
    eikonal points uniform in [-1, 1]^3, per block. blocks: keep only
    these of the n_blocks blocks (a rank's share of the global step's
    draws), so that a run over several ranks draws what one rank would
    draw for the whole batch."""
    def u(shape):
        a = rng.uniform(size=shape).astype(np.float32)
        return torch.as_tensor(a if blocks is None else a[blocks],
                               device=device)
    s1, s2, s3 = jitter_shapes(cfg.tracer, n_rays)
    return TrainDraws(u((n_blocks,) + s1), u((n_blocks,) + s2),
                      u((n_blocks,) + s3),
                      (u((n_blocks, cfg.n_eik_points, 3)) - 0.5) * 2.0)
