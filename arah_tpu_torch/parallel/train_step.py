"""The training step. Port of `arah_tpu/parallel/train_step.py`: per ray
block, the training render and the losses; the mean over blocks and its
gradient; one optimizer update. With the options of the JAX step: SMPL
refinement (the block's frame recomputed from the learnable per-frame
SMPL leaves, differentiably), camera refinement (rays from the learnable
extrinsics), the perceptual patch loss, and per-block frames.

With a mesh (`parallel/mesh.py`: one rank a device) each rank takes its
own blocks; the gradients and the losses are then averaged over the
ranks by one all-reduce of a flat buffer (JAX's `pmean` under
`shard_map`), and every rank makes the same update. The JAX step folds
the rank into its key; here each rank's draws arrive as its `TrainDraws`.

The randomness that `jax.random` draws inside the JAX step arrives as a
`TrainDraws` argument: per block, the three sample-jitter arrays and the
eikonal points (`data/batch.py:draw_train_draws` makes them from a numpy
seed; the tests draw them with the JAX step's own keys).

The gradient of the mean over blocks is taken one block at a time (each
block's loss / B, backward, the gradients summed in the leaves), so that
only one block's graph is alive at once: the same gradient, up to the
order of the sums, at the peak memory of one block. What depends only on
a block's frame (the refined frame, the latent code and the SIREN the
hypernetwork generates) is computed for all the blocks in one batched
pass at the step's start; each block takes its row as a leaf of its own,
and after the blocks one backward carries their rows' gradients through
that pass: the same gradient, with the hypernetwork's and the SMPL
chain's small eager ops dispatched once a step instead of once a block.

Spans (`utils/trace.py`, recorded only under a profiler): `train.step`
around a step, `train.block` around each block's render, loss and
backward, `train.frame` around the blocks' refined frames,
`renderer.generate` around their hypernetwork pass, `train.loss`,
`train.backward` (each block's, and the batched pass's), `train.optim`
(Adam) and, with a mesh, `train.allreduce`.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_unflatten

from arah_tpu_torch.core.smpl import quat_to_rot
from arah_tpu_torch.model import FrameData, prepare_frame
from arah_tpu_torch.render.renderer import (ModelConfig, RenderInputs,
                                             generate_sdf_blocks, render)
from arah_tpu_torch.train.loss import LossWeights, compute_loss
from arah_tpu_torch.utils import trace
from arah_tpu_torch.utils.lpips import make_perceptual_loss
from arah_tpu_torch.utils.tree import tree_map


class TrainBatch(NamedTuple):
    """One step's data, field for field the JAX `TrainBatch`: leading dim
    B = ray blocks on the per-block fields; the frame is shared, except
    in per-block-frame mode (`make_train_step(per_block_frame=True)`),
    where the frame leaves and `latent_idx` carry a leading B dim too."""
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
    latent_idx: Any       # frame index (latent code, SMPL leaves): an int
                          # or () tensor; (B,) with per-block frames


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


def _take(a, i):
    """Row i of a, for an int i or an index tensor (gathered on the
    device, without reading the index back to the host)."""
    if torch.is_tensor(i):
        return a.index_select(0, i.reshape(1).to(a.device, torch.long))[0]
    return a[i]


def _rows(a, idx):
    """The rows `idx` of a, kept 2-D: an int (a view) or an index tensor
    of any shape, gathered on the device (without reading the index back
    to the host) a row at a time, so that a row taken twice sums its
    gradients in the rows' order."""
    if torch.is_tensor(idx):
        idx = idx.reshape(-1).to(a.device, torch.long)
        return torch.cat([a.index_select(0, idx[i:i + 1])
                          for i in range(idx.numel())])
    return a[idx:idx + 1]


def _refined_frames(params, smpl_model, frame_idx,
                    box_margin: float = 0.05) -> FrameData:
    """The frames `frame_idx` (an int, or an index tensor of n frames)
    recomputed from the learnable per-frame SMPL leaves, with gradients
    into pose, shape and translation: `prepare_frame` over the rows in
    one vectorised pass (`torch.func.vmap`), every field with a leading
    dim of the rows."""
    sp = params['smpl_params']
    pose = torch.cat([_rows(sp['root_orient'], frame_idx),
                      _rows(sp['pose_body'], frame_idx),
                      _rows(sp['pose_hand'], frame_idx)], dim=-1)
    return torch.func.vmap(
        lambda p, t: prepare_frame(smpl_model, params['betas'], p, t,
                                   box_margin=box_margin, device=p.device))(
        pose, _rows(sp['trans'], frame_idx))


def _refined_rays(params, batch: TrainBatch, b: int):
    """(cam_loc (3,), ray_dirs (R, 3)) of block b from the learnable
    extrinsics (an xyzw quaternion and a translation per camera) and the
    block's K^-1-lifted pixels `uv`."""
    ci = batch.cam_idx[b]
    R = quat_to_rot(_take(params['cam_rots'], ci))
    t = _take(params['cam_trans'], ci)
    cam_loc = -R.T @ t
    rays = batch.uv[b] @ R
    rays = rays / (torch.linalg.norm(rays, dim=-1, keepdim=True) + 1e-12)
    return cam_loc, rays


def _block_loss(params, cfg: ModelConfig, loss_w: LossWeights,
                batch: TrainBatch, draws: TrainDraws, b: int, fd: FrameData,
                latent, gen, refine_cameras: bool = False,
                perceptual_fn=None):
    """Render + losses of ray block b, on its frame `fd`, latent code and
    generated SIREN `gen` (None: the renderer's own, `single_bvp`)."""
    cam_loc, ray_dirs = batch.cam_loc[b], batch.ray_dirs[b]
    if refine_cameras:
        cam_loc, ray_dirs = _refined_rays(params, batch, b)
    pose_cond_extra = {}
    if latent is not None:
        pose_cond_extra = {'latent_code': latent[None],
                           'rot_noise': batch.rot_noise[b],
                           'trans_noise': batch.trans_noise[b]}
    inp = RenderInputs(
        cam_loc=cam_loc, ray_dirs=ray_dirs,
        near=batch.near[b], far=batch.far[b], frame=fd.frame, smpl=fd.smpl,
        rots=fd.rots, Jtrs=fd.Jtrs, rots_full=fd.rots_full,
        Jtrs_posed=fd.Jtrs_posed, pose_cond_extra=pose_cond_extra,
        geo_latent=latent, rots_noise=batch.rots_noise[b][None],
        view_noise=batch.view_noise[b],
        points_uniform=batch.points_uniform[b],
        points_skinning=batch.points_skinning[b],
        points_inside=batch.points_inside[b],
        points_eik=draws.points_eik[b], gen=gen)
    out = render(params, cfg, inp, training=True,
                 jitter=(draws.u1[b], draws.u2[b], draws.u3[b]))
    gt = {'rgb': batch.rgb_gt[b], 'body_mask': batch.body_mask[b],
          'sampled_weights': batch.sampled_weights[b]}
    with trace.span('train.loss'):
        return compute_loss(out, gt, loss_w, perceptual_fn=perceptual_fn)


def _block_row(t, b: int):
    """Row b of a batched input as a leaf of its own (requiring grad
    where the input does), so that block b's backward stops at it; None
    stays None."""
    if t is None:
        return None
    row = t[b].detach()
    return row.requires_grad_(True) if t.requires_grad else row


def _rows_backward(flat: list, rows: list):
    """One backward through the batched pass: each input of `flat` (a
    leading block dim) takes its blocks' rows' gradients, stacked (a row
    without one counts as zeros)."""
    outs, grads = [], []
    for i, t in enumerate(flat):
        if t is None or not t.requires_grad:
            continue
        gs = [r[i].grad for r in rows]
        if all(g is None for g in gs):
            continue
        outs.append(t)
        grads.append(torch.stack([
            g if g is not None else torch.zeros_like(r[i])
            for g, r in zip(gs, rows)]))
    if outs:
        torch.autograd.backward(outs, grads)


def allreduce_mean(leaves, losses: dict, mesh) -> dict:
    """The mean over the mesh's ranks of every leaf's `.grad` (a leaf
    without one counts as zeros, so that every rank reduces the same
    buffer) and of each loss: one all-reduce of one flat buffer, the
    losses at its end. Sets every leaf's `.grad`; returns the averaged
    losses. The leaves share one floating dtype (the port's parameters
    are float32)."""
    dtype = leaves[0].dtype
    if any(p.dtype != dtype for p in leaves):
        raise TypeError('allreduce_mean: leaves of several dtypes '
                        f'{sorted({str(p.dtype) for p in leaves})}')
    keys = list(losses)
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                      .reshape(-1) for p in leaves]
                     + [torch.stack([losses[k].to(dtype) for k in keys])])
    dist.all_reduce(flat, group=mesh.group)
    flat /= mesh.size
    i = 0
    for p in leaves:
        p.grad = flat[i:i + p.numel()].view_as(p)
        i += p.numel()
    return {k: flat[i + j] for j, k in enumerate(keys)}


def grad_leaves(params):
    """The floating leaves of `params` (frozen ones included, as JAX
    computes their gradients too), in the tree's order."""
    from arah_tpu_torch.train.optim import tree_leaves_with_path
    return [leaf for _, leaf in tree_leaves_with_path(params)
            if torch.is_tensor(leaf) and leaf.is_floating_point()]


def make_train_step(cfg: ModelConfig, loss_w: LossWeights, optimizer,
                    mesh=None, smpl_model=None, refine_smpl: bool = False,
                    refine_cameras: bool = False,
                    per_block_frame: bool = False):
    """step(state, batch, draws) -> (state, losses): the mean of the
    blocks' losses, its gradient, and one update of `optimizer` (made by
    `train.optim.make_optimizer` over `state.params`), which updates the
    parameters in place.

    refine_smpl: each block's frame comes from `params['smpl_params']`
    (root_orient, pose_body, pose_hand, trans; a row per frame, taken at
    the block's `latent_idx`) and `params['betas']` through
    `prepare_frame(smpl_model, ...)`; `smpl_model` is a `SmplModel`, best
    on the parameters' device (`core/smpl.py:load_smpl_assets`, or
    `smpl_to_device`). refine_cameras: each block's rays come from
    `params['cam_rots']` / `['cam_trans']` at its `cam_idx` and its `uv`.
    `loss_w.perceptual > 0`: the patch loss on the rays after the first
    `n_ray_loss` (`utils/lpips.py:make_perceptual_loss`: LPIPS, or its
    DSSIM proxy without the weights). per_block_frame: the batch's frame
    leaves and latent_idx carry a leading block dimension
    (`data/loader.py:collate_train_batch_np(per_block_frame=True)`,
    `data/batch.py:synthetic_train_batch(fds=...)`).

    mesh: a `parallel/mesh.py:Mesh`. The batch and the draws are then
    the rank's own blocks (`parallel/mesh.py:local_blocks` of a global
    batch, or its sampler shard), the same count on every rank; after
    the blocks' backward the gradients and losses are averaged over the
    ranks (`allreduce_mean`), so every rank updates its replica alike
    and gets the mean losses of the global batch."""
    if refine_smpl and smpl_model is None:
        raise ValueError('refine_smpl needs the SMPL model (smpl_model=)')
    perceptual_fn = make_perceptual_loss() if loss_w.perceptual > 0 \
        else None

    def batched_inputs(params, batch: TrainBatch, n_blocks: int) -> dict:
        """Every block's frame, latent code and generated SIREN, with a
        leading block dim, in one pass (a frame or latent shared by the
        blocks expanded to them)."""
        idx = batch.latent_idx
        if refine_smpl:
            with trace.span('train.frame'):
                fd = _refined_frames(params, smpl_model, idx)
        elif per_block_frame:
            fd = batch.frame
        else:
            fd = tree_map(lambda a: a[None], batch.frame)
        latent = _rows(params['latent'], idx) if 'latent' in params \
            else None
        fd, latent = tree_map(
            lambda a: None if a is None
            else a.expand((n_blocks,) + a.shape[1:]), (fd, latent))
        rots = fd.rots[:, 0]
        if batch.rots_noise is not None:
            rots = rots + batch.rots_noise
        with trace.span('renderer.generate'):
            gen = generate_sdf_blocks(params, cfg, rots, fd.Jtrs[:, 0],
                                      latent)
        return {'frame': fd, 'latent': latent, 'gen': gen}

    def step_fn(state: TrainState, batch: TrainBatch, draws: TrainDraws):
        with trace.span('train.step'):
            return _step(state, batch, draws)

    def _step(state: TrainState, batch: TrainBatch, draws: TrainDraws):
        params = state.params
        n_blocks = batch.ray_dirs.shape[0]
        # every leaf's, the frozen ones' too (the optimizer's zero_grad
        # skips those): each step's .grad is that step's gradient alone
        leaves = grad_leaves(params)
        for p in leaves:
            p.grad = None
        flat, spec = tree_flatten(batched_inputs(params, batch, n_blocks))
        rows = [[_block_row(t, b) for t in flat] for b in range(n_blocks)]
        per_block = []
        for b in range(n_blocks):
            mine = tree_unflatten(rows[b], spec)
            with trace.span('train.block'):
                bl = _block_loss(params, cfg, loss_w, batch, draws, b,
                                 mine['frame'], mine['latent'], mine['gen'],
                                 refine_cameras=refine_cameras,
                                 perceptual_fn=perceptual_fn)
                with trace.span('train.backward'):
                    (bl['loss'] / n_blocks).backward()
            per_block.append({k: v.detach() for k, v in bl.items()})
        with trace.span('train.backward'):
            _rows_backward(flat, rows)
        losses = {k: torch.stack([bl[k] for bl in per_block]).mean()
                  for k in per_block[0]}
        if mesh is not None:
            with trace.span('train.allreduce'):
                losses = allreduce_mean(leaves, losses, mesh)
        with trace.span('train.optim'):
            optimizer.step()
        return TrainState(params, optimizer, state.step + 1), losses
    return step_fn
