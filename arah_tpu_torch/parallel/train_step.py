"""The single-device training step. Port of `arah_tpu/parallel/
train_step.py` without a mesh: per ray block, the training render and
the losses; the mean over blocks; one backward; one optimizer update.

The randomness that `jax.random` draws inside the JAX step arrives as a
`TrainDraws` argument: per block, the three sample-jitter arrays and the
eikonal points (`data/batch.py:draw_train_draws` makes them from a numpy
seed; the tests draw them with the JAX step's own keys).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from arah_tpu_torch.model import FrameData
from arah_tpu_torch.render.renderer import ModelConfig, RenderInputs, render
from arah_tpu_torch.train.loss import LossWeights, compute_loss


class TrainBatch(NamedTuple):
    """One step's data, field for field the JAX `TrainBatch`: leading dim
    B = ray blocks on the per-block fields; the frame is shared."""
    cam_loc: Any          # (B, 3)
    ray_dirs: Any         # (B, R, 3)
    near: Any             # (B, R)
    far: Any              # (B, R)
    rgb_gt: Any           # (B, R, 3)
    body_mask: Any        # (B, R) int32 (0 bg, 1 fg, 100 boundary)
    points_uniform: Any   # (B, U, 3) normalized cano
    points_skinning: Any  # (B, S, 3) metric cano
    points_inside: Any    # (B, I, 3) normalized cano
    sampled_weights: Any  # (B, S, 24)
    rots_noise: Any       # (B, 24, 9) additive hypernet pose noise
    view_noise: Any       # (B, 3, 3) view rotation augment (I = off)
    rot_noise: Any        # (B, 1, 9) colour-net root-rot noise
    trans_noise: Any      # (B, 1, 3) colour-net root-trans noise
    uv: Any               # (B, R, 3) K^-1-lifted pixels
    cam_idx: Any          # (B,) int32 camera index
    frame: FrameData
    latent_idx: Any       # int frame index (latent code)


class TrainDraws(NamedTuple):
    """The step's random draws, per block: uniform jitter of the base,
    near-surface and far-surface samples (`ray_tracing.jitter_shapes`)
    and the eikonal points in [-1, 1]^3."""
    u1: Any               # (B, R, n_steps)
    u2: Any               # (B, R, near_surface_vol_samples + 1)
    u3: Any               # (B, R, far_surface_vol_samples)
    points_eik: Any       # (B, E, 3)


class TrainState(NamedTuple):
    params: Any
    optimizer: Any
    step: int


def trainable(params):
    """The parameter tree with every floating leaf a fresh leaf tensor
    that requires grad (the frozen ones too: their gradients are
    computed, as in JAX, and the optimizer leaves them alone)."""
    if isinstance(params, dict):
        return {k: trainable(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(trainable(v) for v in params)
    if params.is_floating_point():
        return params.detach().clone().requires_grad_(True)
    return params


def _block_loss(params, cfg: ModelConfig, loss_w: LossWeights,
                batch: TrainBatch, draws: TrainDraws, latent, b: int):
    """Render + losses of ray block b."""
    fd = batch.frame
    pose_cond_extra = {}
    if latent is not None:
        pose_cond_extra = {'latent_code': latent[None],
                           'rot_noise': batch.rot_noise[b],
                           'trans_noise': batch.trans_noise[b]}
    inp = RenderInputs(
        cam_loc=batch.cam_loc[b], ray_dirs=batch.ray_dirs[b],
        near=batch.near[b], far=batch.far[b], frame=fd.frame, smpl=fd.smpl,
        rots=fd.rots, Jtrs=fd.Jtrs, rots_full=fd.rots_full,
        Jtrs_posed=fd.Jtrs_posed, pose_cond_extra=pose_cond_extra,
        geo_latent=latent, rots_noise=batch.rots_noise[b][None],
        view_noise=batch.view_noise[b],
        points_uniform=batch.points_uniform[b],
        points_skinning=batch.points_skinning[b],
        points_inside=batch.points_inside[b],
        points_eik=draws.points_eik[b])
    out = render(params, cfg, inp, training=True,
                 jitter=(draws.u1[b], draws.u2[b], draws.u3[b]))
    gt = {'rgb': batch.rgb_gt[b], 'body_mask': batch.body_mask[b],
          'sampled_weights': batch.sampled_weights[b]}
    return compute_loss(out, gt, loss_w)


def make_train_step(cfg: ModelConfig, loss_w: LossWeights, optimizer,
                    mesh=None, refine_smpl: bool = False,
                    refine_cameras: bool = False,
                    per_block_frame: bool = False):
    """step(state, batch, draws) -> (state, losses): the mean of the
    blocks' losses, its gradient, and one update of `optimizer` (made by
    `train.optim.make_optimizer` over `state.params`), which updates the
    parameters in place."""
    if mesh is not None:
        raise NotImplementedError('the sharded (multi-GPU) train step is a '
                                  'later slice of the port')
    if refine_smpl or refine_cameras:
        raise NotImplementedError('SMPL and camera refinement are a later '
                                  'slice of the port (prepare_frame runs '
                                  'without gradients)')
    if per_block_frame:
        raise NotImplementedError('per-block frames are a later slice of '
                                  'the port')
    if loss_w.perceptual > 0:
        raise NotImplementedError('the perceptual (LPIPS) loss needs '
                                  'weights that are not in the repository')

    def step_fn(state: TrainState, batch: TrainBatch, draws: TrainDraws):
        params = state.params
        latent = params['latent'][batch.latent_idx] \
            if 'latent' in params else None
        n_blocks = batch.ray_dirs.shape[0]
        optimizer.zero_grad()
        per_block = [_block_loss(params, cfg, loss_w, batch, draws, latent, b)
                     for b in range(n_blocks)]
        losses = {k: torch.stack([bl[k] for bl in per_block]).mean()
                  for k in per_block[0]}
        losses['loss'].backward()
        optimizer.step()
        return (TrainState(params, optimizer, state.step + 1),
                {k: v.detach() for k, v in losses.items()})
    return step_fn
