"""The plain reference of the train step, in plain torch (float32 products
with TF32 off, which `step_grads` sets; the shading's and the colour
MLP's operands in bf16 where the configuration states `bf16_shading`).

It covers what the program's `parallel/train_step.py:make_train_step`
does in a step, in the program's order:

- each block's frame, from the learnable per-frame SMPL leaves through
  `model.prepare_frame` (differentiable) where the configuration refines
  SMPL, else the frame as it is;
- each block's training render (`render_train`): the frozen renderer of
  `renderer.py` on its training path, but for the implicit-diff
  correction, which this module carries with its determinant guard;
- the losses of the program's `train/loss.py` (`compute_loss`);
- the step's gradient as the sum over blocks of each block's loss over
  the block count (`step_grads`);
- one Adam update with torch's `Adam` rule over the parameter groups of
  the program's `train/optim.py` (`adam_update`, `label`).

Departures from the JAX package (and ARAH), each as the program has it:
the determinant guard of the correction (`IDIFF_DET_FLOOR`); a ray that
misses the box keeps no samples (`ray_tracing.sample_z_vals`).
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from gpubench.reference.body import (normalize_canonical_points,
                                     sdf_to_metric,
                                     unnormalize_canonical_points)
from gpubench.reference.color import color_apply, color_pose_feature
from gpubench.reference.deviation import deviation_value
from gpubench.reference.hypernet import hypernet_flat_params
from gpubench.reference.linalg import inv3x3, inv_affine
from gpubench.reference.model import prepare_frame
from gpubench.reference.ray_tracing import CanonicalFrame, trace_and_sample
from gpubench.reference.renderer import (ModelConfig, RenderInputs,
                                         _detached, _shade_sdf,
                                         generate_sdf, make_sdf_fn,
                                         make_skin_fn)
from gpubench.reference.root_find import forward_skinning
from gpubench.reference.volsdf import composite_masked, volsdf_density

# The determinant guard of the implicit-diff correction, a departure from
# the JAX package and ARAH, as the program has it: a point whose metric
# skinning Jacobian d x / d x_hat has |det| <= IDIFF_DET_FLOOR keeps its
# value and loses its correction's gradient (at such a fold of the
# skinning field the correction's gradient, ~1/|det|, and the root itself
# are ill-conditioned).
IDIFF_DET_FLOOR = 0.1


def det3x3(m: torch.Tensor) -> torch.Tensor:
    """Batched determinant of (..., 3, 3) by cofactors of the first row."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def idiff_correct(params, cfg: ModelConfig, frame: CanonicalFrame, flat_p,
                  floor: float = IDIFF_DET_FLOOR):
    """(p - J^-1 (f - sg(f)) with the guard, the guard's keep mask (N,)):
    f = fwd_skin(unnormalize(p)), J = df/dp from three forward-mode
    tangents, no gradient through J; a point with |det J| <= floor s_u^3
    (s_u the unnormalisation's scale, so that the floor is on the metric
    Jacobian) takes no correction."""
    skin_fn = make_skin_fn(params, cfg)

    def fwd_batched(p_norm):
        x_hat = unnormalize_canonical_points(
            p_norm, frame.coord_min, frame.coord_max, frame.center)
        return forward_skinning(skin_fn, frame, x_hat)[0]

    with torch.no_grad():
        cols = []
        for k in range(3):
            tk = torch.zeros_like(flat_p)
            tk[:, k] = 1.0
            cols.append(torch.func.jvp(fwd_batched, (flat_p,), (tk,))[1])
        J = torch.stack(cols, dim=-1)
        s_u = 1.1 * (frame.coord_max - frame.coord_min) / 2.0
        ok = det3x3(J).abs() > floor * s_u ** 3
        J_inv = inv3x3(torch.where(ok[:, None, None], J,
                                   torch.eye(3, device=J.device)))
    f = fwd_batched(flat_p)
    step = torch.einsum('nab,nb->na', J_inv, f - f.detach())
    return flat_p - torch.where(ok[:, None], step,
                                torch.zeros_like(step)), ok


def shade_samples(params, cfg: ModelConfig, gen, frame: CanonicalFrame,
                  points_norm, z_vals, transforms_fwd, converge_mask,
                  view_dirs, view_dirs_orig, pose_feature, ray_augm: bool,
                  floor: float):
    """The training shading of `renderer.shade_samples` with the guarded
    correction. Returns (rgb (n_rays, 3), weights_sum (n_rays,), the
    guard's keep mask over the samples (N,))."""
    n_rays, S, _ = points_norm.shape
    flat_p = points_norm.reshape(-1, 3).contiguous()
    flat_T = transforms_fwd.reshape(-1, 4, 4)
    vd = view_dirs[:, None, :].expand(n_rays, S, 3).reshape(-1, 3)
    vd_orig = view_dirs_orig[:, None, :].expand(n_rays, S, 3).reshape(-1, 3)
    if cfg.cano_view_dirs:
        R_bwd = inv_affine(flat_T)[:, :3, :3].detach()
        in_vd = torch.einsum('nab,nb->na', R_bwd, -vd)
        in_vd_orig = torch.einsum('nab,nb->na', R_bwd, -vd_orig)
    else:
        in_vd, in_vd_orig = -vd, -vd_orig
    ok = torch.ones(flat_p.shape[0], dtype=torch.bool, device=flat_p.device)
    if cfg.train_skinning_net:
        flat_p, ok = idiff_correct(params, cfg, frame, flat_p, floor)
    sdf_norm, feats, normal = _shade_sdf(gen, flat_p, True,
                                         cfg.bf16_shading)
    if not cfg.cano_view_dirs:
        normal = torch.einsum('nab,nb->na', flat_T[:, :3, :3], normal)
    if ray_augm:
        normal_n = (normal / torch.linalg.norm(normal, dim=-1,
                                               keepdim=True)).detach()
        nv = torch.sum(normal_n * in_vd, dim=-1)
        invalid = torch.arccos(torch.clamp(nv, -1.0, 1.0)) >= math.pi / 2.0
        in_vd = torch.where(invalid[:, None], in_vd_orig, in_vd)
    rgb = color_apply(params['color'], cfg.color, flat_p, normal, in_vd,
                      feats, pose_feature, bf16=cfg.bf16_shading)
    density = volsdf_density(
        sdf_to_metric(sdf_norm, frame.coord_min, frame.coord_max),
        deviation_value(params['deviation']))
    out = composite_masked(rgb.reshape(n_rays, S, 3),
                           density.reshape(n_rays, S), z_vals,
                           converge_mask, cfg.tracer.n_steps,
                           render_last_pt=cfg.render_last_pt)
    return out.rgb, out.weights_sum, ok


def render_train(params, cfg: ModelConfig, inp: RenderInputs, jitter,
                 floor: float = IDIFF_DET_FLOOR) -> dict:
    """`renderer.render(training=True)` with the guarded correction: the
    outputs the losses read, and `idiff_points` / `idiff_guarded`, the
    converged samples and those of them the guard dropped."""
    rots = inp.rots
    if inp.rots_noise is not None:
        rots = rots + inp.rots_noise
    gen = generate_sdf(params, cfg, rots, inp.Jtrs, inp.geo_latent)
    with torch.no_grad():
        traced = trace_and_sample(
            cfg.tracer, make_sdf_fn(_detached(gen)),
            make_skin_fn(params, cfg), inp.frame, inp.smpl,
            inp.cam_loc.expand(inp.ray_dirs.shape), inp.ray_dirs, inp.near,
            inp.far, eval_mode=False, jitter=jitter)
    samples = traced.samples
    ray_dirs, ray_augm = inp.ray_dirs, False
    if inp.view_noise is not None:
        if tuple(inp.view_noise.shape) == (3, 3):
            ray_dirs = ray_dirs @ inp.view_noise.T
            ray_augm = True
        else:
            ray_dirs = ray_dirs + inp.view_noise
    pose_cond = dict(inp.pose_cond_extra)
    pose_cond.update({'rots_full': inp.rots_full,
                      'Jtrs_posed': inp.Jtrs_posed})
    pose_feature = color_pose_feature(params['color'], cfg.color, pose_cond)
    rgb, weights_sum, ok = shade_samples(
        params, cfg, gen, inp.frame, samples.points_norm, samples.z_vals,
        samples.transforms, samples.converge_mask, ray_dirs, inp.ray_dirs,
        pose_feature, ray_augm, floor)
    valid = samples.converge_mask.reshape(-1)
    out = {
        'rgb_values': rgb, 'weights_sum': weights_sum,
        'network_body_mask': samples.converge_mask.any(dim=-1),
        'sdf_params': hypernet_flat_params(gen),
        'idiff_points': valid.sum(), 'idiff_guarded': (valid & ~ok).sum(),
        # the eikonal is f32, as every other regulariser
        'grad_theta': _shade_sdf(gen, inp.points_eik, True, False)[2],
    }
    sdf_fn = make_sdf_fn(gen)
    out['off_surface_sdf'] = sdf_fn(inp.points_uniform)
    out['inside_sdf'] = sdf_fn(inp.points_inside)
    fr = inp.frame
    out['pred_weights'] = make_skin_fn(params, cfg)(normalize_canonical_points(
        inp.points_skinning, fr.coord_min, fr.coord_max, fr.center))
    return out


class LossWeights(NamedTuple):
    """The loss terms' weights of the configuration's `training` section
    and the rays of the per-ray losses (the first `n_ray_loss`)."""
    rgb: float
    eikonal: float
    mask: float
    off_surface: float
    inside: float
    params: float
    skinning: float
    rgb_loss_type: str
    n_ray_loss: int


def loss_weights(cfg: dict, n_ray_loss: int) -> LossWeights:
    """A configuration's weights, by the published defaults."""
    t = cfg['training']
    return LossWeights(
        rgb=t.get('rgb_weight', 30.0), eikonal=t.get('eikonal_weight', 50.0),
        mask=t.get('mask_weight', 0.0),
        off_surface=t.get('off_surface_weight', 100.0),
        inside=t.get('inside_weight', 0.0),
        params=t.get('params_weight', 100.0),
        skinning=t.get('skinning_weight', 0.0),
        rgb_loss_type=t.get('rgb_loss_type', 'l1'), n_ray_loss=n_ray_loss)


def _norm(x, eps=1e-12):
    return torch.sqrt(torch.clamp(torch.sum(x * x, dim=-1), min=eps))


def compute_loss(out: dict, rgb_gt, body_mask, sampled_weights,
                 w: LossWeights) -> dict:
    """Every loss term of the program's `train/loss.py` (no perceptual
    term: the configurations weigh it 0) and their weighted sum `loss`."""
    n = w.n_ray_loss
    pred, gt = out['rgb_values'][:n], rgb_gt[:n]
    mask, net = body_mask[:n], out['network_body_mask'][:n]
    valid = net & (mask != 100) if bool(body_mask.max() > 1) else net
    if w.rgb_loss_type == 'l1':
        res = torch.abs(pred - gt)
    elif w.rgb_loss_type == 'mse':
        res = (pred - gt) ** 2
    else:
        d = torch.abs(pred - gt)
        res = torch.where(d < 0.1, 0.5 * d * d / 0.1, d - 0.05)
    losses = {'rgb_loss': torch.sum(res * valid[:, None]) / n}
    losses['eikonal_loss'] = torch.sum(torch.abs(
        _norm(out['grad_theta']) - 1.0)) / n
    losses['mask_loss'] = _norm(
        (out['weights_sum'][:n] - mask.float()) * net) / n
    losses['off_surface_loss'] = torch.sum(torch.exp(
        -1e2 * out['off_surface_sdf'])) / n
    losses['inside_loss'] = torch.sum(torch.sigmoid(
        out['inside_sdf'] * 5e3)) / n
    flat = torch.cat([p.reshape(-1) for p in out['sdf_params']])
    losses['sdf_params_loss'] = _norm(flat) / flat.shape[0]
    losses['skinning_loss'] = torch.mean(torch.sum(torch.abs(
        out['pred_weights'] - sampled_weights), dim=-1))
    losses['loss'] = (w.rgb * losses['rgb_loss']
                      + w.eikonal * losses['eikonal_loss']
                      + w.mask * losses['mask_loss']
                      + w.off_surface * losses['off_surface_loss']
                      + w.inside * losses['inside_loss']
                      + w.params * losses['sdf_params_loss']
                      + w.skinning * losses['skinning_loss'])
    return losses


def refined_frame(params, model, idx: int, box_margin: float = 0.05):
    """The frame of training frame `idx` from the SMPL leaves (axis-angle
    root, body and hand poses, translation, one betas), with gradients
    into them."""
    sp = params['smpl_params']
    pose = torch.cat([sp['root_orient'][idx], sp['pose_body'][idx],
                      sp['pose_hand'][idx]], dim=-1)
    return prepare_frame(model, params['betas'], pose, sp['trans'][idx],
                         box_margin=box_margin, device=pose.device)


class Block(NamedTuple):
    """One ray block of a step, on the device."""
    cam_loc: Any            # (3,)
    ray_dirs: Any           # (R, 3)
    near: Any               # (R,)
    far: Any                # (R,)
    rgb_gt: Any             # (R, 3)
    body_mask: Any          # (R,) int32
    points_uniform: Any     # (U, 3)
    points_skinning: Any    # (S, 3)
    points_inside: Any      # (I, 3)
    sampled_weights: Any    # (S, 24)
    rots_noise: Any         # (24, 9)
    view_noise: Any         # (3, 3)
    rot_noise: Any          # (1, 9)
    trans_noise: Any        # (1, 3)
    frame_idx: int          # the training frame (latent row, SMPL row)
    u1: Any                 # the sample jitter and the eikonal points
    u2: Any
    u3: Any
    points_eik: Any


def block_loss(params, cfg: ModelConfig, w: LossWeights, blk: Block, fd,
               model=None, refine: bool = False,
               floor: float = IDIFF_DET_FLOOR):
    """(losses, render outputs) of one block on frame `fd` (the
    reference's `FrameData`), or on the frame the SMPL leaves give."""
    if refine:
        fd = refined_frame(params, model, blk.frame_idx)
    latent = params['latent'][blk.frame_idx]
    inp = RenderInputs(
        cam_loc=blk.cam_loc, ray_dirs=blk.ray_dirs, near=blk.near,
        far=blk.far, frame=fd.frame, smpl=fd.smpl, rots=fd.rots,
        Jtrs=fd.Jtrs, rots_full=fd.rots_full, Jtrs_posed=fd.Jtrs_posed,
        pose_cond_extra={'latent_code': latent[None],
                         'rot_noise': blk.rot_noise,
                         'trans_noise': blk.trans_noise},
        geo_latent=latent, rots_noise=blk.rots_noise[None],
        view_noise=blk.view_noise, points_uniform=blk.points_uniform,
        points_skinning=blk.points_skinning,
        points_inside=blk.points_inside, points_eik=blk.points_eik)
    out = render_train(params, cfg, inp, (blk.u1, blk.u2, blk.u3), floor)
    return compute_loss(out, blk.rgb_gt, blk.body_mask, blk.sampled_weights,
                        w), out


def leaves(tree, path=()):
    """(path, tensor) of every leaf, dicts in their order, lists by index."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))
    else:
        yield path, tree


def step_grads(params, cfg: ModelConfig, w: LossWeights, blocks, frames,
               model=None, refine: bool = False,
               floor: float = IDIFF_DET_FLOOR):
    """The step's mean losses over the blocks, the gradient of their mean
    ({path: tensor}, a block at a time: each block's loss over the block
    count, summed), and the guard's counts over the blocks. `params` is a
    tree of leaf tensors that require grad; `frames[b]` block b's frame
    (unused where `refine`)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for _, p in leaves(params):
        p.grad = None
    per_block = []
    points = guarded = 0
    for blk, fd in zip(blocks, frames):
        losses, out = block_loss(params, cfg, w, blk, fd, model, refine,
                                 floor)
        (losses['loss'] / len(blocks)).backward()
        per_block.append({k: v.detach() for k, v in losses.items()})
        points += int(out['idiff_points'])
        guarded += int(out['idiff_guarded'])
        del out, losses
    mean = {k: torch.stack([b[k] for b in per_block]).mean()
            for k in per_block[0]}
    grads = {path: (p.grad.detach().clone() if p.grad is not None
                    else torch.zeros_like(p))
             for path, p in leaves(params)}
    return mean, grads, {'points': points, 'guarded': guarded}


# The parameter groups of the program's `train/optim.py` and the
# published learning rates (ARAH's `configs/default.yaml` for `lr`,
# `skinning_lr` and `pose_net_factor`; 1e-4 for the colour net, the
# deviation, the latents and the SMPL leaves; latents decayed by 0.05).
COLOR_LR = DEVIATION_LR = AUX_LR = LATENT_LR = 1e-4
LATENT_WEIGHT_DECAY = 0.05
BETAS, EPS = (0.9, 0.999), 1e-8


def label(path, train_skinning_net: bool) -> str:
    """A leaf's group by its path; 'frozen' leaves are not updated."""
    top = path[0]
    if top == 'hypernet':
        return {'hyper_layers': 'sdf_hyper',
                'pose_encoder': 'sdf_pose_encoder'}.get(path[1], 'frozen')
    if top in ('color', 'deviation', 'latent'):
        return top
    if top == 'skinning':
        return 'skinning' if train_skinning_net else 'frozen'
    if top in ('cam_rots', 'cam_trans', 'smpl_params', 'betas'):
        return 'aux'
    return 'frozen'


def group_lrs(cfg: dict) -> dict:
    t = cfg['training']
    lr = t.get('lr', 1e-6)
    return {'sdf_hyper': lr,
            'sdf_pose_encoder': lr * t.get('pose_net_factor', 100.0),
            'color': COLOR_LR, 'deviation': DEVIATION_LR,
            'skinning': t.get('skinning_lr', 1e-4), 'aux': AUX_LR,
            'latent': LATENT_LR}


def adam_update(cfg: dict, params: dict, grads: dict, state: dict,
                denom: dict | None = None) -> dict:
    """{path: tensor} after one Adam step of every grouped leaf from
    `params` ({path: tensor}), `grads` and `state` ({path: (step, m, v)},
    the moments before the step; a leaf with no state starts from zero).
    Frozen leaves are returned as they are. `denom`, where given, gets
    each updated leaf's sqrt(v_hat), the step's denominator but for eps."""
    lrs = group_lrs(cfg)
    train_skin = bool(cfg['training'].get('train_skinning_net', False))
    b1, b2 = BETAS
    out = {}
    for path, p in params.items():
        g = label(path, train_skin)
        if g == 'frozen':
            out[path] = p
            continue
        grad = grads[path]
        if g == 'latent':
            grad = grad + LATENT_WEIGHT_DECAY * p
        step, m, v = state.get(path, (0, torch.zeros_like(p),
                                      torch.zeros_like(p)))
        t = step + 1
        m = b1 * m + (1.0 - b1) * grad
        v = b2 * v + (1.0 - b2) * grad * grad
        m_hat = m / (1.0 - b1 ** t)
        v_hat = v / (1.0 - b2 ** t)
        if denom is not None:
            denom[path] = torch.sqrt(v_hat)
        out[path] = p - lrs[g] * m_hat / (torch.sqrt(v_hat) + EPS)
    return out
