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
            a = np.asarray(v)
            kw[f] = int(a) if a.ndim == 0 else torch.as_tensor(
                a, dtype=torch.int32)
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


def check_step_vs_jax(jl, jg, jnew, pl, pp, before, labels):
    """One port train step against the JAX step on the same parameters,
    batch and draws. jl, jg, jnew: the JAX losses, gradients and
    parameters after the update; pl: the port's losses; pp: the port's
    parameters after its step (their `.grad` the step's gradients);
    before: the port's leaves before the step by path; labels: the
    optimizer's group of each path. Tolerances as `test_torch_train_step`
    states them. Returns {path: (port gradient, JAX gradient)}."""
    from arah_tpu_torch.train.optim import tree_leaves_with_path
    assert set(pl) == set(jl)
    for k in jl:
        a, b = float(pl[k]), float(jl[k])
        assert np.isfinite(a)
        assert abs(a - b) <= 1e-3 * max(abs(a), abs(b)) + 1e-6, (k, a, b)

    jgrads = jax.tree_util.tree_leaves_with_path(jg)
    jparams = jax.tree_util.tree_leaves(jnew)
    pleaves = list(tree_leaves_with_path(pp))
    assert len(jgrads) == len(pleaves) == len(jparams)
    worst, grads = [], {}
    for (jpath, g), (path, leaf), jn in zip(jgrads, pleaves, jparams):
        assert tuple(getattr(k, 'key', getattr(k, 'idx', None))
                     for k in jpath) == path
        g = np.asarray(g)
        pg = np.zeros_like(g) if leaf.grad is None else leaf.grad.numpy()
        assert pg.shape == g.shape, path
        grads[path] = (pg, g)
        scale = np.abs(g).max()
        if scale > 0:
            rel = np.abs(pg - g).max() / scale
            cos = float((pg * g).sum() / (np.linalg.norm(pg)
                                          * np.linalg.norm(g)))
            assert rel < 1e-2 and cos >= 0.999, (path, rel, cos)
            worst.append(rel)
        else:
            assert np.abs(pg).max() <= 1e-6, path
        b0 = before[path].numpy()
        du_p = leaf.detach().numpy() - b0
        du_j = np.asarray(jn) - b0
        if labels[path] == 'frozen':
            np.testing.assert_array_equal(leaf.detach().numpy(), b0)
            np.testing.assert_array_equal(du_j, 0.0)
            continue
        umax = np.abs(du_j).max()
        if umax > 0:
            signal = np.abs(g) > 1e-3 * scale
            bad = (np.abs(du_p - du_j) > 1e-2 * umax) & signal
            assert not bad.any(), (path, int(bad.sum()))
        else:
            assert np.abs(du_p).max() <= 1e-9, path
    assert worst and float(np.median(worst)) < 1e-4, np.median(worst)
    return grads


# the refinement leaves with a gradient in JAX's step, and the two without
# (they reach the loss only through the tracer, which runs without
# gradients, and the 'latent' colour pose encoder reads no joint position)
MOVED = (('smpl_params', 'root_orient'), ('smpl_params', 'pose_body'),
         ('smpl_params', 'pose_hand'), ('betas',), ('cam_rots',))
STILL = (('smpl_params', 'trans'), ('cam_trans',))


def port_smpl(jmodel):
    """A JAX SmplModel -> the port's, on the CPU."""
    from arah_tpu_torch.core.smpl import SmplModel, smpl_to_device
    return smpl_to_device(SmplModel(*(np.asarray(a) for a in jmodel)),
                          'cpu')


def jax_step(cfg, params, batch, loss_w, key, n_blocks, **opts):
    """(losses, gradients, parameters after one update) of the JAX step
    with the options `opts` of `make_train_step` (smpl_model,
    refine_smpl, refine_cameras, per_block_frame): its loss, the mean
    over blocks of `_block_loss` with the step's split of `key` and its
    perceptual loss, under `jax.value_and_grad`; then one update of the
    flagship optimizer groups."""
    import optax
    from arah_tpu.parallel.train_step import _block_loss
    from arah_tpu.train.optim import OptimConfig, make_optimizer
    from arah_tpu.utils.lpips_jax import make_perceptual_loss
    per_block = opts.get('per_block_frame', False)
    perceptual_fn = make_perceptual_loss() if loss_w.perceptual > 0 \
        else None

    def loss_fn(p):
        keys = jax.random.split(key, n_blocks)
        ls = []
        for b in range(n_blocks):
            idx = batch.latent_idx[b] if per_block else batch.latent_idx
            ls.append(_block_loss(p, cfg, loss_w, batch, p['latent'][idx],
                                  b, keys[b], perceptual_fn=perceptual_fn,
                                  **opts))
        ls = jax.tree.map(lambda *xs: jnp.mean(jnp.stack(xs)), *ls)
        return ls['loss'], ls
    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    opt, _ = make_optimizer(OptimConfig(train_skinning_net=True), params)
    updates, _ = jax.jit(opt.update)(grads, opt.init(params), params)
    return losses, grads, optax.apply_updates(params, updates)


def port_step(cfg, params, batch, loss_w, key, n_blocks, n_rays, **opts):
    """The port's step on the JAX step's inputs (its draws replayed from
    `key`): (losses, parameters after the step, leaves before it by path,
    the optimizer's labels)."""
    from arah_tpu_torch.parallel.train_step import (TrainState,
                                                    make_train_step,
                                                    trainable)
    from arah_tpu_torch.train.loss import LossWeights
    from arah_tpu_torch.train.optim import (OptimConfig, make_optimizer,
                                            tree_leaves_with_path)
    pp = trainable(port_params(params))
    before = {p: l.detach().clone() for p, l in tree_leaves_with_path(pp)}
    opt, labels = make_optimizer(OptimConfig(train_skinning_net=True), pp)
    step = make_train_step(port_cfg(cfg), LossWeights(**loss_w._asdict()),
                           opt, **opts)
    _, pl = step(TrainState(pp, opt, 0), port_batch(batch),
                 jax_draws(cfg, key, n_blocks, n_rays))
    return pl, pp, before, labels


def refine_scene(cfg, rng, n_frames):
    """(JAX SmplModel, params with per-frame SMPL leaves, FrameData of
    each frame): the synthetic body in n_frames random poses of one
    shape, the leaves holding those poses."""
    from arah_tpu.data.synthetic import synthetic_smpl
    from arah_tpu.model import init_model_params, prepare_frame
    model = synthetic_smpl(n_verts=512)
    params = init_model_params(jax.random.PRNGKey(0), cfg,
                               n_latent_frames=n_frames)
    betas = jnp.asarray((rng.randn(10) * 0.3).astype(np.float32))
    poses = (rng.randn(n_frames, 72) * 0.2).astype(np.float32)
    trans = np.tile(np.asarray([0.1, 0.0, 0.2], np.float32), (n_frames, 1))
    params['smpl_params'] = {
        'root_orient': jnp.asarray(poses[:, :3]),
        'pose_body': jnp.asarray(poses[:, 3:66]),
        'pose_hand': jnp.asarray(poses[:, 66:]),
        'trans': jnp.asarray(trans)}
    params['betas'] = betas
    fds = [prepare_frame(model, betas, jnp.asarray(p), jnp.asarray(tr))
           for p, tr in zip(poses, trans)]
    return model, params, fds


def patch_labels(n_blocks, n_loss, ps):
    """(n_blocks, n_loss + ps * ps) mask labels: 1 on the loss rays; on
    each block's patch 1, then 100 (boundary, which the RGB loss skips)
    and 0 (background)."""
    label = np.ones((n_blocks, n_loss + ps * ps), np.int32)
    label[:, n_loss + 20:n_loss + 60] = 100
    label[:, n_loss + 200:] = 0
    return jnp.asarray(label)
