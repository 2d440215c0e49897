"""The fit that gives the synthetic avatar a trained-like geometry: a
frozen copy of the port's `utils/bench_scene.py`.

A randomly initialised hypernetwork emits a near-constant positive SDF,
so sphere tracing finds no surface and every solver runs to its cap: a
workload no trained avatar presents. The synthetic body is a union of
capsules whose signed distance and skinning weights have closed forms,
so `pretrain_scene` fits

  * the generated SIREN, through the real hypernetwork and FiLM path, by
    optimising the `hypo_init` base weights the hyper heads add their
    residuals to, to the capsule-body SDF in canonical space, and
  * the skinning MLP to the capsule-softmax weights the body's vertices
    carry,

with Adam (lr 1e-4, 800 steps of 8,192 points): |sdf - capsule sdf| +
0.01 eikonal on 512 near-surface points + 0.5 skinning-weight MSE. The
points are drawn from an explicit `torch.Generator`; `scene_loss` takes
them pre-drawn, so a test can replay numpy draws. Matrix products stay in
full f32 (no TF32) during the fit.
"""
from __future__ import annotations

import numpy as np
import torch

from gpubench.reference.body import (get_02v_bone_transforms_jnp,
                                      normalize_canonical_points,
                                      sdf_to_metric,
                                      unnormalize_canonical_points)
from gpubench.reference.smpl import (SMPL_PARENTS, SmplModel, blend_shapes,
                                      vertices2joints)
from gpubench.reference.siren import siren_apply
from gpubench.reference.skinning import skinning_weights
from gpubench.reference.renderer import generate_sdf


def capsule_segments_02v(model: SmplModel, betas: torch.Tensor):
    """(24, 3) a / (24, 3) b segment endpoints of the canonical (02v)
    capsule body, in the metric space of `FrameData.verts_cano`."""
    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=betas.device)
    v_shaped = t(model.v_template)[None] + blend_shapes(
        betas.reshape(1, -1), t(model.shapedirs))
    Jtr = vertices2joints(t(model.J_regressor), v_shaped)[0]    # (24, 3)
    tf02 = get_02v_bone_transforms_jnp(Jtr)                     # (24, 4, 4)
    J02 = torch.einsum('jab,jb->ja', tf02[:, :3, :3], Jtr) + tf02[:, :3, 3]
    has_parent = torch.as_tensor(SMPL_PARENTS >= 0, device=betas.device)
    a = torch.where(has_parent[:, None], J02[np.maximum(SMPL_PARENTS, 0)],
                    J02)
    return a, J02


def capsule_sdf_and_weights(x, seg_a, seg_b, radius: float = 0.055,
                            temp: float = 0.02):
    """Exact capsule-union SDF and capsule-softmax skinning weights of
    canonical metric points x (N, 3): (sdf (N,), w (N, 24)). The weights
    mirror `data/synthetic.py`'s (softmax of -segment distance / 0.02)."""
    ab = seg_b - seg_a                                          # (24, 3)
    ap = x[:, None, :] - seg_a[None]                            # (N, 24, 3)
    denom = torch.clamp(torch.sum(ab * ab, dim=-1), min=1e-9)
    t = torch.clamp(torch.sum(ap * ab[None], dim=-1) / denom, 0.0, 1.0)
    closest = seg_a[None] + t[..., None] * ab[None]
    d = torch.linalg.norm(x[:, None, :] - closest, dim=-1)     # (N, 24)
    sdf = torch.min(d, dim=-1)[0] - radius
    w = torch.softmax(-d / temp, dim=-1)
    return sdf, w


def sample_points(fd, batch: int, gen: torch.Generator) -> torch.Tensor:
    """One batch of canonical metric points: half the body's canonical
    vertices plus N(0, 0.04^2) noise, half uniform in the normalised box."""
    frame = fd.frame
    dev = fd.verts_cano.device
    n_surf = batch // 2
    idx = torch.randint(0, fd.verts_cano.shape[0], (n_surf,), generator=gen,
                        device=dev)
    noise = torch.randn((n_surf, 3), generator=gen, device=dev) * 0.04
    cube = torch.rand((batch - n_surf, 3), generator=gen,
                      device=dev) * 2.0 - 1.0
    x_cube = unnormalize_canonical_points(cube, frame.coord_min,
                                          frame.coord_max, frame.center)
    return torch.cat([fd.verts_cano[idx] + noise, x_cube], dim=0)


def scene_loss(params, cfg, fd, seg_a, seg_b, x, n_eik: int = 512):
    """The fit's loss at canonical metric points x (B, 3), differentiable
    in `params` (`bench_scene.py:113-137`)."""
    frame = fd.frame
    cmin, cmax = frame.coord_min, frame.coord_max
    x_norm = normalize_canonical_points(x, cmin, cmax, frame.center)
    sdf_t, w_t = capsule_sdf_and_weights(x, seg_a, seg_b)
    gen = generate_sdf(params, cfg, fd.rots, fd.Jtrs, params['latent'][0])
    sdf_m = sdf_to_metric(siren_apply(gen, x_norm)[:, 0], cmin, cmax)
    l_sdf = torch.mean(torch.abs(sdf_m - sdf_t))

    # eikonal on the first (near-surface) points keeps the fitted field
    # 1-Lipschitz where the tracer walks
    q = x_norm[:n_eik].detach().requires_grad_(True)
    s = sdf_to_metric(siren_apply(gen, q)[:, 0], cmin, cmax)
    g, = torch.autograd.grad(s.sum(), q, create_graph=True)
    scale = 2.0 / (1.1 * (cmax - cmin))
    l_eik = torch.mean((torch.linalg.norm(g * scale, dim=-1) - 1.0) ** 2)

    w = skinning_weights(params['skinning'], cfg.skinning, x_norm)
    l_skin = torch.mean(torch.sum((w - w_t) ** 2, dim=-1))
    return l_sdf + 0.01 * l_eik + 0.5 * l_skin


def with_leaves(params, hypo, skin):
    """params with `hypo_init` and the skinning tree replaced."""
    p = dict(params)
    p['hypernet'] = dict(params['hypernet'], hypo_init=list(hypo))
    p['skinning'] = skin
    return p


def pretrain_scene(params, cfg, model: SmplModel, betas: torch.Tensor, fd,
                   steps: int = 800, batch: int = 8192, lr: float = 1e-4,
                   seed: int = 11):
    """Fit `hypo_init` and the skinning parameters to the capsule body of
    `betas`. Returns (params with the fitted leaves, everything else
    shared; (steps,) losses)."""
    seg_a, seg_b = capsule_segments_02v(model, betas)
    hypo = [h.detach().clone().requires_grad_(True)
            for h in params['hypernet']['hypo_init']]
    skin = {'layers': [{k: v.detach().clone().requires_grad_(True)
                        for k, v in lyr.items()}
                       for lyr in params['skinning']['layers']]}
    leaves = hypo + [v for lyr in skin['layers'] for v in lyr.values()]
    p = with_leaves(params, hypo, skin)
    opt = torch.optim.Adam(leaves, lr=lr)
    gen = torch.Generator(device=fd.verts_cano.device).manual_seed(seed)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    losses = []
    try:
        with torch.enable_grad():
            for _ in range(steps):
                loss = scene_loss(p, cfg, fd, seg_a, seg_b,
                                  sample_points(fd, batch, gen))
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                losses.append(loss.detach())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    skin = {'layers': [{k: v.detach() for k, v in lyr.items()}
                       for lyr in skin['layers']]}
    return (with_leaves(params, [h.detach() for h in hypo], skin),
            torch.stack(losses) if losses else torch.zeros(0))
