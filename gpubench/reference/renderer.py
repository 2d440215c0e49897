"""The ARAH volume renderer of the plain reference: hypernetwork SDF,
skinning network, ray tracer, colour network and VolSDF compositing, for
eval and training, in plain torch. A frozen copy of the port's
`render/renderer.py` on its plain paths: the shading and the colour MLP
with their explicit backward passes (`shade.py`, `color.py`), and the
implicit-diff Jacobian from three forward-mode tangents. The
configuration's `bf16_shading` rounds the shading's and the colour
MLP's product operands to bf16 (f32 sums), as it states; every other
product is f32 (TF32 off, set by the caller). The randomness arrives as data:
`render(..., jitter=)` and `RenderInputs.points_eik`.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from gpubench.reference.body import (normalize_canonical_points,
                                     sdf_to_metric,
                                     unnormalize_canonical_points)
from gpubench.reference.color import (ColorConfig, color_apply,
                                      color_pose_feature)
from gpubench.reference.deviation import deviation_value
from gpubench.reference.hypernet import (HypernetConfig, hypernet_cond,
                                         hypernet_flat_params,
                                         hypernet_generate)
from gpubench.reference.linalg import inv3x3, inv_affine
from gpubench.reference.ray_tracing import (CanonicalFrame,
                                            RayTracerConfig, SmplRef,
                                            trace_and_sample)
from gpubench.reference.root_find import forward_skinning
from gpubench.reference.shade import shade, shade_grad
from gpubench.reference.siren import GeneratedMLP, siren_apply
from gpubench.reference.skinning import SkinningConfig, skinning_weights
from gpubench.reference.volsdf import composite_masked, volsdf_density


class ModelConfig(NamedTuple):
    hypernet: HypernetConfig = HypernetConfig()
    skinning: SkinningConfig = SkinningConfig()
    color: ColorConfig = ColorConfig()
    tracer: RayTracerConfig = RayTracerConfig()
    cano_view_dirs: bool = True
    train_skinning_net: bool = False
    render_last_pt: bool = False
    # bf16 operands / f32 sums in the shading (SIREN features and
    # normals) and the colour MLP; the solvers stay f32
    bf16_shading: bool = False


def make_skin_fn(params, cfg: ModelConfig):
    """Normalized canonical points (N, 3) -> (N, 24) skinning weights."""
    return lambda x: skinning_weights(params['skinning'], cfg.skinning, x)


def make_sdf_fn(gen: GeneratedMLP):
    """Normalized canonical points (N, 3) -> (N,) normalized SDF."""
    return lambda x: siren_apply(gen, x)[..., 0]


def generate_sdf(params, cfg: ModelConfig, rots, Jtrs, geo_latent=None):
    """Per-frame hypernetwork pass -> generated SIREN weights.
    rots: (1, 24, 9); Jtrs: (1, 24, 3)."""
    cond = hypernet_cond(params['hypernet'], cfg.hypernet, rots, Jtrs)[0]
    latent = None
    if cfg.hypernet.use_film and geo_latent is not None:
        latent = geo_latent
    elif geo_latent is not None:
        cond = cond + geo_latent
    return hypernet_generate(params['hypernet'], cfg.hypernet, cond, latent)


class RenderInputs(NamedTuple):
    """Per-step inputs for one frame. The training fields may be None in
    eval."""
    cam_loc: torch.Tensor          # (3,)
    ray_dirs: torch.Tensor         # (N, 3)
    near: torch.Tensor             # (N,)
    far: torch.Tensor              # (N,)
    frame: CanonicalFrame
    smpl: SmplRef
    rots: torch.Tensor             # (1, 24, 9) local rots (root = I)
    Jtrs: torch.Tensor             # (1, 24, 3) normalized rest joints
    rots_full: torch.Tensor        # (1, 24, 9) incl. root
    Jtrs_posed: torch.Tensor       # (1, 24, 3)
    pose_cond_extra: dict          # latent_code/... (may be {})
    geo_latent: Any = None         # (128,) or None
    rots_noise: Any = None         # (1, 24, 9) hypernet input noise
    view_noise: Any = None         # (3, 3) rotation / (N, 3) additive
    points_uniform: Any = None     # (U, 3) normalized, off-surface reg
    points_skinning: Any = None    # (S, 3) metric cano, skinning reg
    points_inside: Any = None      # (I, 3) normalized, inside reg
    points_eik: Any = None         # (E, 3) eikonal points (training)


def _detached(gen: GeneratedMLP) -> GeneratedMLP:
    return GeneratedMLP(*(tuple(a.detach() for a in part) for part in gen))


def _shade_sdf(gen: GeneratedMLP, flat_p, training: bool, bf16: bool):
    """(sdf (N,), features, normals (N, 3)) of the generated SIREN; in
    training differentiable in `gen` and the points (`shade.shade_grad`,
    its features f32), in eval without gradients (features bf16 under
    `bf16`)."""
    if training:
        out, feats, grads = shade_grad(gen, flat_p, bf16=bf16)
    else:
        out, feats, grads = shade(gen, flat_p, bf16=bf16)
    return out[:, 0], feats, grads


def _idiff_correct(params, cfg: ModelConfig, frame: CanonicalFrame, flat_p):
    """The implicit-differentiation correction p - J^-1 (f - sg(f)), f =
    fwd_skin(unnormalize(p)): the value of p unchanged, its gradient
    reaching the skinning net as -J^-1 df/dtheta. J from three
    forward-mode tangents; no gradient flows through J."""
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
    f = fwd_batched(flat_p)
    return flat_p - torch.einsum('nab,nb->na', inv3x3(J.detach()),
                                 f - f.detach())


def shade_samples(params, cfg: ModelConfig, gen: GeneratedMLP,
                  frame: CanonicalFrame, points_norm, z_vals,
                  transforms_fwd, converge_mask, view_dirs, view_dirs_orig,
                  pose_feature, training: bool = False,
                  ray_augm: bool = False):
    """SDF + colour + VolSDF compositing over dense (n_rays, S) samples.
    Returns (rgb (n_rays, 3), weights_sum (n_rays,))."""
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
    if training and cfg.train_skinning_net:
        flat_p = _idiff_correct(params, cfg, frame, flat_p)
    sdf_norm, feats, normal = _shade_sdf(gen, flat_p, training,
                                         cfg.bf16_shading)
    if not cfg.cano_view_dirs:
        normal = torch.einsum('nab,nb->na', flat_T[:, :3, :3], normal)
    if training and ray_augm:
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
    return out.rgb, out.weights_sum


def render(params, cfg: ModelConfig, inp: RenderInputs,
           training: bool = False, jitter=None):
    """Render one frame's ray block: rgb, weights, the hit mask and
    surface depth, and in training grad_theta and the regulariser
    outputs. Training takes its draws: the sample jitter (u1, u2, u3 of
    `ray_tracing.jitter_shapes`) and `inp.points_eik`."""
    if not training:
        with torch.no_grad():
            return _render(params, cfg, inp, False, None)
    return _render(params, cfg, inp, True, jitter)


def _render(params, cfg: ModelConfig, inp: RenderInputs, training: bool,
            jitter):
    rots = inp.rots
    if training and inp.rots_noise is not None:
        rots = rots + inp.rots_noise
    gen = generate_sdf(params, cfg, rots, inp.Jtrs, inp.geo_latent)
    with torch.no_grad():
        trace = trace_and_sample(
            cfg.tracer, make_sdf_fn(_detached(gen)),
            make_skin_fn(params, cfg),
            inp.frame, inp.smpl, inp.cam_loc.expand(inp.ray_dirs.shape),
            inp.ray_dirs, inp.near, inp.far, eval_mode=not training,
            jitter=jitter)
    samples = trace.samples

    ray_dirs, ray_augm = inp.ray_dirs, False
    if training and inp.view_noise is not None:
        if tuple(inp.view_noise.shape) == (3, 3):
            ray_dirs = ray_dirs @ inp.view_noise.T
            ray_augm = True
        else:
            ray_dirs = ray_dirs + inp.view_noise
    pose_cond = dict(inp.pose_cond_extra)
    pose_cond.update({'rots_full': inp.rots_full,
                      'Jtrs_posed': inp.Jtrs_posed})
    pose_feature = color_pose_feature(params['color'], cfg.color, pose_cond)
    rgb_values, weights_sum = shade_samples(
        params, cfg, gen, inp.frame, samples.points_norm, samples.z_vals,
        samples.transforms, samples.converge_mask, ray_dirs, inp.ray_dirs,
        pose_feature, training, ray_augm)
    out = {
        'rgb_values': rgb_values,
        'weights_sum': weights_sum,
        'network_body_mask': samples.converge_mask.any(dim=-1),
        'surface_depth': trace.surface.start_dis,
        'surface_converged': ~trace.surface.unconverged,
        'sdf_params': hypernet_flat_params(gen),
    }
    if training:
        # the eikonal is f32, as every other regulariser
        out['grad_theta'] = _shade_sdf(gen, inp.points_eik, True, False)[2]
        sdf_fn = make_sdf_fn(gen)
        if inp.points_uniform is not None:
            out['off_surface_sdf'] = sdf_fn(inp.points_uniform)
        if inp.points_inside is not None:
            out['inside_sdf'] = sdf_fn(inp.points_inside)
        if inp.points_skinning is not None:
            fr = inp.frame
            out['pred_weights'] = make_skin_fn(params, cfg)(
                normalize_canonical_points(inp.points_skinning, fr.coord_min,
                                           fr.coord_max, fr.center))
    return out
