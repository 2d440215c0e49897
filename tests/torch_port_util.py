"""Shared helpers of the `test_torch_*` files: move configurations,
parameters and render inputs from the JAX package into the port, so both
sides compute the same function on the same numbers (made from numpy
seeds), on the CPU."""
import numpy as np
import torch

import jax
import jax.numpy as jnp


def port_cfg(jcfg):
    """A JAX ModelConfig -> the port's ModelConfig, field for field."""
    from arah_tpu_torch.nn.color import ColorConfig
    from arah_tpu_torch.nn.hypernet import HypernetConfig
    from arah_tpu_torch.nn.skinning import SkinningConfig
    from arah_tpu_torch.render.ray_tracing import RayTracerConfig
    from arah_tpu_torch.render.renderer import ModelConfig
    sub = {'hypernet': HypernetConfig, 'skinning': SkinningConfig,
           'color': ColorConfig, 'tracer': RayTracerConfig}
    kw = {}
    for f in jcfg._fields:
        v = getattr(jcfg, f)
        kw[f] = sub[f](**v._asdict()) if f in sub else v
    return ModelConfig(**kw)


def t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype)


def port_params(jparams):
    from arah_tpu_torch.convert import params_from_jax
    return params_from_jax(jax.tree.map(np.asarray, jparams), device='cpu')


def port_gen(jgen):
    """A JAX GeneratedMLP -> the port's."""
    from arah_tpu_torch.nn.siren import GeneratedMLP
    return GeneratedMLP(*(tuple(t(a) for a in part) for part in jgen))


def port_frame(jframe):
    from arah_tpu_torch.solver.root_find import CanonicalFrame
    return CanonicalFrame(*(t(a) for a in jframe))


def port_inputs(jinp):
    """A JAX RenderInputs (eval fields) -> the port's."""
    from arah_tpu_torch.render.ray_tracing import SmplRef
    from arah_tpu_torch.render.renderer import RenderInputs
    return RenderInputs(
        cam_loc=t(jinp.cam_loc), ray_dirs=t(jinp.ray_dirs),
        near=t(jinp.near), far=t(jinp.far), frame=port_frame(jinp.frame),
        smpl=SmplRef(t(jinp.smpl.verts_posed),
                     t(jinp.smpl.skinning_weights)),
        rots=t(jinp.rots), Jtrs=t(jinp.Jtrs), rots_full=t(jinp.rots_full),
        Jtrs_posed=t(jinp.Jtrs_posed),
        pose_cond_extra={k: t(v) for k, v in jinp.pose_cond_extra.items()},
        geo_latent=None if jinp.geo_latent is None else t(jinp.geo_latent))


def jax_scene(cfg, rng, n_rays=32, n_verts=512, seed=0):
    """A JAX eval scene: the bench ray mix (half the rays at body
    vertices, half at uniform points of the posed box)."""
    from arah_tpu.core.rays import ray_aabb
    from arah_tpu.data.synthetic import synthetic_smpl
    from arah_tpu.model import init_model_params, prepare_frame
    from arah_tpu.render.renderer import RenderInputs
    model = synthetic_smpl(n_verts=n_verts)
    params = init_model_params(jax.random.PRNGKey(seed), cfg,
                               n_latent_frames=2)
    fd = prepare_frame(
        model, jnp.asarray((rng.randn(10) * 0.3).astype(np.float32)),
        jnp.asarray((rng.randn(72) * 0.2).astype(np.float32)),
        jnp.asarray([0.1, 0.0, 0.2], jnp.float32))
    cam = jnp.asarray([0.0, 0.3, -2.5])
    nv = fd.smpl.verts_posed.shape[0]
    tgt_v = fd.smpl.verts_posed[rng.randint(0, nv, n_rays - n_rays // 2)]
    tgt_b = jnp.asarray(rng.uniform(size=(n_rays // 2, 3)).astype(
        np.float32)) * (fd.bounds_max - fd.bounds_min) + fd.bounds_min
    dirs = jnp.concatenate([tgt_v, tgt_b], axis=0) - cam
    dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
    near, far, _ = ray_aabb(fd.bounds_min, fd.bounds_max,
                            jnp.broadcast_to(cam, dirs.shape), dirs)
    latent = params['latent'][0]
    inp = RenderInputs(
        cam_loc=cam, ray_dirs=dirs, near=near, far=far, frame=fd.frame,
        smpl=fd.smpl, rots=fd.rots, Jtrs=fd.Jtrs, rots_full=fd.rots_full,
        Jtrs_posed=fd.Jtrs_posed,
        pose_cond_extra={'latent_code': latent[None]}, geo_latent=latent)
    return model, params, fd, inp


def np_(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def port_frame_data(jfd):
    """A JAX FrameData -> the port's."""
    from arah_tpu_torch.model import FrameData
    from arah_tpu_torch.render.ray_tracing import SmplRef
    return FrameData(
        frame=port_frame(jfd.frame),
        smpl=SmplRef(t(jfd.smpl.verts_posed), t(jfd.smpl.skinning_weights)),
        **{f: t(getattr(jfd, f)) for f in FrameDataFields})


FrameDataFields = ('verts_cano', 'rots', 'rots_full', 'Jtrs', 'Jtrs_posed',
                   'bounds_min', 'bounds_max')


def port_batch(jbatch):
    """A JAX TrainBatch -> the port's."""
    from arah_tpu_torch.parallel.train_step import TrainBatch
    kw = {}
    for f in jbatch._fields:
        v = getattr(jbatch, f)
        if f == 'frame':
            kw[f] = port_frame_data(v)
        elif f == 'latent_idx':
            kw[f] = int(v)
        else:
            a = np.asarray(v)
            kw[f] = torch.as_tensor(a, dtype=torch.int32 if a.dtype.kind
                                    in 'iu' else torch.float32)
    return TrainBatch(**kw)


def jax_draws(cfg, key, n_blocks, n_rays):
    """The draws the JAX train step takes from `key` (one split per
    block, then `render`'s and `sample_z_vals`'s splits), as the port's
    TrainDraws."""
    from arah_tpu_torch.parallel.train_step import TrainDraws
    tr = cfg.tracer
    u1, u2, u3, eik = [], [], [], []
    for kb in jax.random.split(key, n_blocks):
        k_trace, k_eik = jax.random.split(kb)
        k1, k2, k3 = jax.random.split(k_trace, 3)
        u1.append(jax.random.uniform(k1, (n_rays, tr.n_steps)))
        u2.append(jax.random.uniform(
            k2, (n_rays, tr.near_surface_vol_samples + 1)))
        u3.append(jax.random.uniform(
            k3, (n_rays, max(tr.far_surface_vol_samples, 1))))
        eik.append((jax.random.uniform(k_eik, (cfg.n_eik_points, 3))
                    - 0.5) * 2.0)
    return TrainDraws(*(t(np.stack([np.asarray(a) for a in x]))
                        for x in (u1, u2, u3, eik)))
