"""The ARAH volume renderer: hypernetwork SDF, skinning network, ray
tracer, colour network and VolSDF compositing, for eval and training.
Port of `arah_tpu/render/renderer.py`.

Kernels on the eval path: the shading kernel C (SDF, features and normals
of every sample) and the colour kernel D, plus A, B, E and F inside the
tracer, which gets the generated SIREN (for E and F) and the collapsed
skinning MLP (for B and F) as the JAX renderer hands them over. Training
adds the skinning Jacobian G (the implicit-diff correction), and runs the
shading through the C -> H op (`ops/shade_grad.py`, also for the eikonal
points) and the colour MLP through the D -> I op (`ops/color.py`). Only
the tracer runs without gradients.

The JAX renderer draws its randomness (the sample jitter and the eikonal
points) from a key; the port takes it as data: `render(..., jitter=)`
and `RenderInputs.points_eik`.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from arah_tpu_torch.core.body import (normalize_canonical_points,
                                      sdf_to_metric,
                                      unnormalize_canonical_points)
from arah_tpu_torch.core.linalg import inv3x3, inv_affine
from arah_tpu_torch.nn.color import (ColorConfig, color_apply,
                                     color_pose_feature)
from arah_tpu_torch.nn.deviation import deviation_value
from arah_tpu_torch.nn.hypernet import (HypernetConfig, hypernet_cond,
                                        hypernet_flat_params,
                                        hypernet_generate)
from arah_tpu_torch.nn.siren import GeneratedMLP, siren_apply
from arah_tpu_torch.nn.skinning import (SkinningConfig,
                                        skinning_dense_params,
                                        skinning_weights)
from arah_tpu_torch.ops.shade import siren_shade
from arah_tpu_torch.ops.shade_grad import siren_shade_grad
from arah_tpu_torch.ops.skin_jac import skinning_jac
from arah_tpu_torch.render.ray_tracing import (CanonicalFrame,
                                               RayTracerConfig, SmplRef,
                                               trace_and_sample)
from arah_tpu_torch.render.volsdf import composite_masked, volsdf_density
from arah_tpu_torch.solver.root_find import forward_skinning


class ModelConfig(NamedTuple):
    """Field for field the JAX `ModelConfig`, with its defaults.
    `pallas_*_tile` sized the TPU kernels and are not read; the training
    path takes its eikonal points as data, so `n_eik_points` only sizes
    the draws (`data/batch.py:draw_train_draws`). Of the implicit-diff
    options, `idiff_standalone_jac` takes J from kernel G and otherwise
    three forward-mode tangents give the same J (`idiff_linearize` and
    the JAX per-point jacfwd form compute one function);
    `idiff_kernel_jac` (J from the corr kernel, a TPU A/B) is not
    ported."""
    hypernet: HypernetConfig = HypernetConfig()
    skinning: SkinningConfig = SkinningConfig()
    color: ColorConfig = ColorConfig()
    tracer: RayTracerConfig = RayTracerConfig()
    cano_view_dirs: bool = True
    train_skinning_net: bool = False
    render_last_pt: bool = False
    n_eik_points: int = 1024
    # bf16 operands / f32 accumulation in the shading stage (SIREN
    # features+normals and the colour MLP); solvers stay f32
    bf16_shading: bool = False
    # True: SDF, features and normals from the shading kernel C (CUDA on a
    # CUDA tensor, its plain version on a CPU tensor). False: siren_apply
    # plus one autograd reverse pass for the normals.
    use_pallas_shade: bool = True
    pallas_shade_tile: int = 512
    # training: True = the C -> H op (ops/shade_grad.py) for the shading
    # and eikonal points; False = siren_apply and a double-backward
    use_pallas_shade_grad: bool = True
    pallas_shade_grad_tile: int = 256
    shade_resid_bf16: bool = False
    shade_pack: bool = False
    shade_pack_frac: float = 0.95
    shade_pack_align: int = 512
    idiff_linearize: bool = True
    idiff_kernel_jac: bool = False
    idiff_standalone_jac: bool = True


def make_skin_fn(params, cfg: ModelConfig):
    """Normalized canonical points (N, 3) -> (N, 24) skinning weights."""
    return lambda x: skinning_weights(params['skinning'], cfg.skinning, x)


def make_sdf_fn(gen: GeneratedMLP):
    """Normalized canonical points (N, 3) -> (N,) normalized SDF."""
    return lambda x: siren_apply(gen, x)[..., 0]


def generate_sdf(params, cfg: ModelConfig, rots, Jtrs, geo_latent=None):
    """Per-frame hypernetwork pass -> generated SIREN weights.
    rots: (1, 24, 9); Jtrs: (1, 24, 3)."""
    if 'sdf_plain' in params:
        raise NotImplementedError('the single_bvp SDF variant is not ported')
    cond = hypernet_cond(params['hypernet'], cfg.hypernet, rots, Jtrs)[0]
    latent = None
    if cfg.hypernet.use_film and geo_latent is not None:
        latent = geo_latent
    elif geo_latent is not None:
        cond = cond + geo_latent
    return hypernet_generate(params['hypernet'], cfg.hypernet, cond, latent)


class RenderInputs(NamedTuple):
    """Per-step inputs for one frame, field for field the JAX
    `RenderInputs`. The training fields may be None in eval."""
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


def _shade_sdf(cfg: ModelConfig, gen: GeneratedMLP, flat_p,
               training: bool = False, bf16: bool | None = None):
    """(sdf (N,), features, normals (N, 3)) of the generated SIREN. In
    training, differentiable in `gen` and the points: the C -> H op, or
    siren_apply with a double-backward."""
    bf16 = cfg.bf16_shading if bf16 is None else bf16
    if training and cfg.use_pallas_shade_grad:
        out, feats, grads = siren_shade_grad(gen, flat_p, bf16=bf16)
        return out[:, 0], feats, grads
    if not training and cfg.use_pallas_shade:
        out, feats, grads = siren_shade(gen, flat_p, bf16=bf16,
                                        resid_bf16=cfg.shade_resid_bf16)
        return out[:, 0], feats, grads
    with torch.enable_grad():
        p = flat_p if flat_p.requires_grad \
            else flat_p.detach().requires_grad_(True)
        out, feats = siren_apply(gen, p, return_features=True, bf16=bf16)
        grads, = torch.autograd.grad(out[:, 0].sum(), p,
                                     create_graph=training)
    if training:
        return out[:, 0], feats, grads
    return out[:, 0].detach(), feats.detach(), grads


def _idiff_correct(params, cfg: ModelConfig, frame: CanonicalFrame, flat_p):
    """The implicit-differentiation correction p - J^-1 (f - sg(f)), f =
    fwd_skin(unnormalize(p)): the value of p unchanged, its gradient
    reaching the skinning net as -J^-1 df/dtheta. J from kernel G
    (`idiff_standalone_jac`, a collapsible skinning MLP) or from three
    forward-mode tangents; no gradient flows through J."""
    skin_fn = make_skin_fn(params, cfg)

    def fwd_batched(p_norm):
        x_hat = unnormalize_canonical_points(
            p_norm, frame.coord_min, frame.coord_max, frame.center)
        return forward_skinning(skin_fn, frame, x_hat)[0]

    sd = skinning_dense_params(params['skinning'], cfg.skinning) \
        if cfg.idiff_standalone_jac else None
    if sd is not None:
        with torch.no_grad():
            x_hat = unnormalize_canonical_points(
                flat_p, frame.coord_min, frame.coord_max, frame.center)
            jac = skinning_jac(x_hat, sd[0], sd[1], frame,
                               cfg.skinning.softmax_scale)
        # unnormalize scales each axis by s_u, so J_norm = J_metric * s_u
        J = jac * (1.1 * (frame.coord_max - frame.coord_min) / 2.0)
    else:
        with torch.no_grad():
            cols = []
            for k in range(3):
                tk = torch.zeros_like(flat_p)
                tk[:, k] = 1.0
                cols.append(torch.func.jvp(fwd_batched, (flat_p,),
                                           (tk,))[1])
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
    if cfg.shade_pack:
        raise NotImplementedError('shade_pack (a TPU A/B) is not ported')
    if training and cfg.idiff_kernel_jac:
        raise NotImplementedError('idiff_kernel_jac (J from the corr '
                                  'kernel, a TPU A/B) is not ported')
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
    sdf_norm, feats, normal = _shade_sdf(cfg, gen, flat_p, training)
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


def render(params, cfg: ModelConfig, inp: RenderInputs, key=None,
           training: bool = False, jitter=None):
    """Render one frame's ray block; returns the JAX `render` output dict
    (with `training`, also grad_theta and the regulariser outputs). `key`
    is unused: training takes its draws as data, the sample jitter
    (u1, u2, u3 of `ray_tracing.jitter_shapes`) and `inp.points_eik`."""
    if not training:
        with torch.no_grad():
            return _render(params, cfg, inp, False, None)
    if jitter is None or inp.points_eik is None:
        raise ValueError('render(training=True) takes its draws: jitter '
                         'and inp.points_eik')
    return _render(params, cfg, inp, True, jitter)


def _render(params, cfg: ModelConfig, inp: RenderInputs, training: bool,
            jitter):
    rots = inp.rots
    if training and inp.rots_noise is not None:
        rots = rots + inp.rots_noise
    gen = generate_sdf(params, cfg, rots, inp.Jtrs, inp.geo_latent)
    with torch.no_grad():
        gen_ng = _detached(gen)
        skin_dense = None
        if cfg.tracer.use_pallas_corr or cfg.tracer.use_pallas_iso:
            sd = skinning_dense_params(params['skinning'], cfg.skinning)
            if sd is not None:
                skin_dense = (tuple(w.detach() for w in sd[0]),
                              tuple(b.detach() for b in sd[1]),
                              cfg.skinning.softmax_scale)
        sdf_gen = gen_ng if (cfg.tracer.use_pallas_march
                             or cfg.tracer.use_pallas_iso) else None
        trace = trace_and_sample(
            cfg.tracer, make_sdf_fn(gen_ng), make_skin_fn(params, cfg),
            inp.frame, inp.smpl, inp.cam_loc.expand(inp.ray_dirs.shape),
            inp.ray_dirs, inp.near, inp.far, eval_mode=not training,
            skin_dense=skin_dense, sdf_gen=sdf_gen, jitter=jitter)
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
    n_dense = samples.converge_mask.numel()
    out = {
        'rgb_values': rgb_values,
        'weights_sum': weights_sum,
        'network_body_mask': samples.converge_mask.any(dim=-1),
        'n_samples_valid': samples.converge_mask.sum(),
        'n_samples_dense': n_dense,
        'n_samples_shaded': n_dense,
        'n_samples_overflow': 0,
        'surface_depth': trace.surface.start_dis,
        'surface_converged': ~trace.surface.unconverged,
        'surface_points_norm': trace.surface.points_norm,
        'sdf_params': hypernet_flat_params(gen),
        'deviation': deviation_value(params['deviation']),
    }
    if training:
        # the eikonal stays f32, like every other regulariser
        out['grad_theta'] = _shade_sdf(cfg, gen, inp.points_eik, True,
                                       bf16=False)[2]
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
