"""`ModelConfig.shade_pack` in the port, against the JAX package with the
pack on both sides, on the CPU: the cases of
`tests/test_renderer.py::TestShadePack` (the eval render packed equals
the dense one when the budget holds every valid sample; the training
values and gradients; a short budget's overflow telemetry), and the
pack's index build on the device without a host sync.

Tolerances: packed against dense in the port, rgb and weights within
1e-6 and every gradient leaf within 1e-5 of its largest magnitude (JAX's
own bounds; per-point work is row-independent); the port against JAX on
JAX's trace samples as `test_torch_train.py::test_shade_samples_training`
(5e-4 of each leaf's largest magnitude); whole renders by
`test_torch_render.py`'s render rule.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_renderer import small_config
from test_torch_render import _check_render, _jax_render
from torch_port_util import (jax_scene, np_, port_cfg, port_frame,
                             port_inputs, port_params, t)

torch.set_num_threads(2)

PACK = dict(shade_pack=True, shade_pack_align=16)


def test_eval_packed_matches_dense(rng):
    """The eval render with the pack (align 16, frac 0.95: no overflow)
    equals the dense render, and the JAX packed render."""
    from arah_tpu_torch.render.renderer import render
    cfg = small_config()
    _, params, _, inp = jax_scene(cfg, rng, n_rays=48)
    pp, pin = port_params(params), port_inputs(inp)
    out_p = render(pp, port_cfg(cfg)._replace(**PACK), pin)
    out_d = render(pp, port_cfg(cfg), pin)
    n_dense = out_d['n_samples_dense']
    K = min(n_dense, -(-int(0.95 * n_dense) // 16) * 16)
    assert out_p['n_samples_shaded'] == K < n_dense
    assert int(out_p['n_samples_overflow']) == 0
    assert int(out_p['n_samples_valid']) <= K
    for k in ('rgb_values', 'weights_sum'):
        np.testing.assert_allclose(np_(out_p[k]), np_(out_d[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    ref = _jax_render(cfg._replace(**PACK), params, inp)
    assert int(ref['n_samples_shaded']) == K
    _check_render(out_p, ref)


def test_overflow_telemetry(rng):
    """A budget that holds 5% of the samples: K is JAX's, the overflow
    is exactly max(n_valid - K, 0), and the render stays finite and
    bounded; the first K valid samples (ray-major) are the ones shaded."""
    from arah_tpu_torch.render.renderer import render
    cfg = small_config()
    _, params, _, inp = jax_scene(cfg, rng, n_rays=48)
    tiny = cfg._replace(shade_pack=True, shade_pack_frac=0.05,
                        shade_pack_align=64)
    out = render(port_params(params), port_cfg(tiny), port_inputs(inp))
    ref = _jax_render(tiny, params, inp)
    K = out['n_samples_shaded']
    assert K == int(ref['n_samples_shaded'])
    n_valid = int(out['n_samples_valid'])
    assert n_valid > K
    assert int(out['n_samples_overflow']) == n_valid - K
    assert int(ref['n_samples_overflow']) == max(
        int(ref['n_samples_valid']) - K, 0)
    rgb = np_(out['rgb_values'])
    assert np.isfinite(rgb).all() and ((rgb >= 0) & (rgb <= 1)).all()
    ws = np_(out['weights_sum'])
    assert np.isfinite(ws).all() and (ws <= 1 + 1e-6).all()


def _jax_samples(cfg, params, inp):
    from arah_tpu.render.ray_tracing import trace_and_sample
    from arah_tpu.render.renderer import (generate_sdf, make_sdf_fn,
                                          make_skin_fn)
    cam = jnp.broadcast_to(inp.cam_loc, inp.ray_dirs.shape)
    gen0 = generate_sdf(params, cfg, inp.rots, inp.Jtrs, inp.geo_latent)
    return jax.jit(lambda: trace_and_sample(
        cfg.tracer, make_sdf_fn(gen0), make_skin_fn(params, cfg), inp.frame,
        inp.smpl, cam, inp.ray_dirs, inp.near, inp.far,
        jax.random.PRNGKey(5), eval_mode=False))().samples


def test_train_values_and_grads(rng):
    """The training branch of `shade_samples` with the pack (the
    implicit-diff correction, C -> H and D -> I on the K packed rows) on
    JAX's trace samples: against the port's dense call (values and every
    gradient leaf) and against JAX's packed `shade_samples`."""
    from arah_tpu.nn.color import color_pose_feature as jpose
    from arah_tpu.render.renderer import generate_sdf, shade_samples
    from arah_tpu_torch.nn.color import color_pose_feature
    from arah_tpu_torch.parallel.train_step import trainable
    from arah_tpu_torch.render import renderer as prend
    from arah_tpu_torch.train.optim import tree_leaves_with_path
    cfg = small_config(train_skinning=True)._replace(shade_pack=True,
                                                     shade_pack_align=8)
    _, params, _, inp = jax_scene(cfg, rng, n_rays=16)
    s = _jax_samples(cfg, params, inp)
    n = inp.ray_dirs.shape[0]
    c_rgb = rng.randn(n, 3).astype(np.float32)
    c_ws = rng.randn(n).astype(np.float32)
    pose_cond = dict(inp.pose_cond_extra, rots_full=inp.rots_full,
                     Jtrs_posed=inp.Jtrs_posed)

    def jloss(p):
        pc = dict(pose_cond, latent_code=p['latent'][0][None])
        gen = generate_sdf(p, cfg, inp.rots, inp.Jtrs, p['latent'][0])
        rgb, ws, aux = shade_samples(
            p, cfg, gen, inp.frame, s.points_norm, s.z_vals, s.transforms,
            s.converge_mask, inp.ray_dirs, inp.ray_dirs,
            jpose(p['color'], cfg.color, pc), True)
        return jnp.sum(rgb * c_rgb) + jnp.sum(ws * c_ws), (rgb, ws, aux)
    (_, (rgb_ref, ws_ref, aux_ref)), gref = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(params)
    jref = [np.asarray(g) for g in jax.tree_util.tree_leaves(gref)]

    def port(pcfg):
        pp = trainable(port_params(params))
        pc = {k: t(v) for k, v in pose_cond.items()}
        pc['latent_code'] = pp['latent'][0][None]
        gen = prend.generate_sdf(pp, pcfg, t(inp.rots), t(inp.Jtrs),
                                 pp['latent'][0])
        rgb, ws, aux = prend.shade_samples(
            pp, pcfg, gen, port_frame(inp.frame), t(s.points_norm),
            t(s.z_vals), t(s.transforms),
            torch.as_tensor(np.asarray(s.converge_mask)), t(inp.ray_dirs),
            t(inp.ray_dirs), color_pose_feature(pp['color'], pcfg.color,
                                                pc), training=True)
        (torch.sum(rgb * t(c_rgb)) + torch.sum(ws * t(c_ws))).backward()
        grads = [np.zeros(l.shape, np.float32) if l.grad is None
                 else l.grad.numpy() for _, l in tree_leaves_with_path(pp)]
        return np_(rgb), np_(ws), aux, grads
    rgb_p, ws_p, aux_p, g_p = port(port_cfg(cfg))
    rgb_d, ws_d, aux_d, g_d = port(port_cfg(cfg)._replace(shade_pack=False))
    assert aux_p['n_samples_shaded'] == int(aux_ref['n_samples_shaded']) \
        < aux_d['n_samples_shaded']
    assert int(aux_p['n_samples_overflow']) == 0
    np.testing.assert_allclose(rgb_p, rgb_d, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ws_p, ws_d, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(rgb_p, np.asarray(rgb_ref), atol=5e-4)
    np.testing.assert_allclose(ws_p, np.asarray(ws_ref), atol=5e-4)
    assert len(g_p) == len(g_d) == len(jref)
    n_grad = 0
    for a, b, r in zip(g_p, g_d, jref):
        scale = max(np.abs(b).max(), 1e-4)
        assert np.abs(a - b).max() / scale < 1e-5, a.shape
        if np.abs(r).max() > 0:
            n_grad += 1
            assert np.abs(a - r).max() <= 5e-4 * np.abs(r).max(), a.shape
    assert n_grad >= 10


def test_pack_index_without_host_sync(monkeypatch):
    """The pack's index list and its scatter back run with no host sync:
    no `nonzero` and no `.item()`, `bool()`, `int()` or `.tolist()` of a
    tensor in their path (each raises here). The list equals JAX's
    `jnp.nonzero(mask, size=K, fill_value=N)` with K short and long."""
    from arah_tpu_torch.render.renderer import _unpack, pack_index
    rs = np.random.RandomState(0)
    mask = rs.rand(1000) < 0.6
    refs = {K: np.asarray(jnp.nonzero(jnp.asarray(mask), size=K,
                                      fill_value=1000)[0])
            for K in (256, 704)}

    def no_sync(*a, **k):
        raise AssertionError('host sync in the pack')
    monkeypatch.setattr(torch, 'nonzero', no_sync)
    for name in ('nonzero', 'item', '__bool__', '__int__', '__index__',
                 'tolist'):
        monkeypatch.setattr(torch.Tensor, name, no_sync)
    m = torch.as_tensor(mask)
    for K, ref in refs.items():
        idx = pack_index(m, K)
        vals = torch.arange(K, dtype=torch.float32)[:, None] + 1
        dense = _unpack(vals, idx, 1000)
        monkeypatch.undo()
        np.testing.assert_array_equal(idx.numpy(), ref)
        d = dense.numpy()[:, 0]
        kept = ref[ref < 1000]
        np.testing.assert_array_equal(d[kept], np.arange(len(kept)) + 1)
        assert (np.delete(d, kept) == 0).all()
        monkeypatch.setattr(torch, 'nonzero', no_sync)
        for name in ('nonzero', 'item', '__bool__', '__int__', '__index__',
                     'tolist'):
            monkeypatch.setattr(torch.Tensor, name, no_sync)
