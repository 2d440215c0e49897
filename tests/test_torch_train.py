"""The training path of the port, module by module, against the JAX
package on the CPU: stratified sampling with the draws the JAX renderer
takes from its key, the training branch of `shade_samples` on the same
trace samples (implicit-diff correction, the C -> H shading op, the
D -> I colour op, `ray_augm`, both `cano_view_dirs` branches), the loss,
the optimizer, and the port's `render(training=True)` refusals of what
is still a later slice.

Tolerances: sampling is the same arithmetic on the same draws (1e-6);
`shade_samples` values and every per-leaf gradient within 5e-4 of each
leaf's largest magnitude (`tests/test_pallas.py:784-787`); the loss
terms within 1e-5 relative; Adam's parameters within 1e-6 after three
steps, frozen leaves bit for bit.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_renderer import small_config
from torch_port_util import (jax_scene, np_, port_cfg, port_frame,
                             port_inputs, port_params, t)

torch.set_num_threads(2)


def _key_leaves(tree):
    return [(tuple(getattr(k, 'key', getattr(k, 'idx', None)) for k in p),
             np.asarray(v)) for p, v in
            jax.tree_util.tree_leaves_with_path(tree)]


class TestStratified:
    def test_stratified_z_vals(self):
        """`core.rays.stratified_z_vals` with the uniform draws of the JAX
        function's key, with and without a pinned sample."""
        from arah_tpu.core.rays import stratified_z_vals as jstrat
        from arah_tpu_torch.core.rays import stratified_z_vals
        key = jax.random.PRNGKey(3)
        z = jnp.sort(jax.random.uniform(jax.random.PRNGKey(4), (7, 9)) * 3,
                     axis=-1)
        u = jax.random.uniform(key, z.shape)
        for fix in (None, 4):
            ref = jstrat(key, z, fix_idx=fix)
            out = stratified_z_vals(t(z), t(u), fix_idx=fix)
            np.testing.assert_allclose(np_(out), np.asarray(ref), atol=1e-6)

    def test_sample_z_vals_training(self, rng):
        """`sample_z_vals(eval_mode=False)` with the jitter the JAX
        renderer draws: `k_trace, k_eik = split(key)`, then `k1, k2, k3 =
        split(k_trace, 3)`; body and background rays."""
        from arah_tpu.render.ray_tracing import sample_z_vals as jsample
        from arah_tpu_torch.render.ray_tracing import (jitter_shapes,
                                                       sample_z_vals)
        jcfg = small_config().tracer
        n = 12
        near = rng.uniform(1.0, 1.5, n).astype(np.float32)
        far = near + rng.uniform(1.0, 2.0, n).astype(np.float32)
        surf = near + rng.uniform(0.2, 0.8, n).astype(np.float32)
        body = rng.uniform(size=n) < 0.6
        key = jax.random.PRNGKey(7)
        k_trace, _ = jax.random.split(key)
        z_ref, m_ref = jsample(jcfg, k_trace, jnp.asarray(body),
                               jnp.asarray(surf), jnp.asarray(near),
                               jnp.asarray(far), eval_mode=False)
        cfg = port_cfg(small_config()).tracer
        keys = jax.random.split(k_trace, 3)
        jitter = tuple(t(jax.random.uniform(k, s)) for k, s in
                       zip(keys, jitter_shapes(cfg, n)))
        z, m = sample_z_vals(cfg, torch.as_tensor(body), t(surf), t(near),
                             t(far), eval_mode=False, jitter=jitter)
        np.testing.assert_array_equal(m.numpy(), np.asarray(m_ref))
        np.testing.assert_allclose(np_(z), np.asarray(z_ref), atol=1e-6)
        # eval mode is the unjittered grid
        z_eval, _ = sample_z_vals(cfg, torch.as_tensor(body), t(surf),
                                  t(near), t(far))
        assert not np.allclose(np_(z_eval), np_(z))


def _rotation(rng, angle=0.2):
    from scipy.spatial.transform import Rotation
    v = rng.randn(3)
    return Rotation.from_rotvec(angle * v / np.linalg.norm(v)) \
        .as_matrix().astype(np.float32)


@pytest.mark.parametrize('cano', [False, True])
def test_shade_samples_training(rng, cano, monkeypatch):
    """The training branch of `shade_samples` (implicit-diff correction
    with J from kernel G's plain version, the C -> H and D -> I ops,
    `ray_augm` with a rotated view) on the samples of the JAX training
    trace: rgb, weights and the gradient of a random-cotangent
    scalarisation for every parameter leaf (through the hypernetwork),
    against the JAX package's XLA training path. The correction's
    determinant guard, the port's departure from JAX, is held by
    `tests/test_torch_idiff_guard.py`; here its floor is 0, so that the
    port computes JAX's unguarded correction (this small random skinning
    net folds space enough that some samples lie under the program's
    floor)."""
    from arah_tpu.nn.color import color_pose_feature as jpose
    from arah_tpu.render.ray_tracing import trace_and_sample
    from arah_tpu.render.renderer import (generate_sdf, make_sdf_fn,
                                          make_skin_fn, shade_samples)
    from arah_tpu_torch.nn.color import color_pose_feature
    from arah_tpu_torch.parallel.train_step import trainable
    from arah_tpu_torch.render import renderer as prend
    from arah_tpu_torch.train.optim import tree_leaves_with_path
    monkeypatch.setattr(prend, 'IDIFF_DET_FLOOR', 0.0)
    cfg = small_config(train_skinning=True)._replace(cano_view_dirs=cano)
    _, params, _, inp = jax_scene(cfg, rng, n_rays=24)
    cam = jnp.broadcast_to(inp.cam_loc, inp.ray_dirs.shape)
    gen0 = generate_sdf(params, cfg, inp.rots, inp.Jtrs, inp.geo_latent)
    trace = jax.jit(lambda: trace_and_sample(
        cfg.tracer, make_sdf_fn(gen0), make_skin_fn(params, cfg), inp.frame,
        inp.smpl, cam, inp.ray_dirs, inp.near, inp.far,
        jax.random.PRNGKey(5), eval_mode=False))()
    s = trace.samples
    assert bool(s.converge_mask.any())
    R = _rotation(rng)
    dirs = inp.ray_dirs @ jnp.asarray(R).T
    n = inp.ray_dirs.shape[0]
    c_rgb = rng.randn(n, 3).astype(np.float32)
    c_ws = rng.randn(n).astype(np.float32)
    pose_cond = dict(inp.pose_cond_extra, rots_full=inp.rots_full,
                     Jtrs_posed=inp.Jtrs_posed)

    def jloss(p):
        pc = dict(pose_cond, latent_code=p['latent'][0][None])
        gen = generate_sdf(p, cfg, inp.rots, inp.Jtrs, p['latent'][0])
        rgb, ws, _ = shade_samples(
            p, cfg, gen, inp.frame, s.points_norm, s.z_vals, s.transforms,
            s.converge_mask, dirs, inp.ray_dirs,
            jpose(p['color'], cfg.color, pc), True, ray_augm=True)
        return jnp.sum(rgb * c_rgb) + jnp.sum(ws * c_ws), (rgb, ws)
    (_, (rgb_ref, ws_ref)), gref = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(params)

    pcfg = port_cfg(cfg)
    pp = trainable(port_params(params))
    fr = port_frame(inp.frame)
    pc = {k: t(v) for k, v in pose_cond.items()}
    pc['latent_code'] = pp['latent'][0][None]
    gen = prend.generate_sdf(pp, pcfg, t(inp.rots), t(inp.Jtrs),
                             pp['latent'][0])
    rgb, ws, _ = prend.shade_samples(
        pp, pcfg, gen, fr, t(s.points_norm), t(s.z_vals), t(s.transforms),
        torch.as_tensor(np.asarray(s.converge_mask)), t(dirs),
        t(inp.ray_dirs), color_pose_feature(pp['color'], pcfg.color, pc),
        training=True, ray_augm=True)
    (torch.sum(rgb * t(c_rgb)) + torch.sum(ws * t(c_ws))).backward()
    np.testing.assert_allclose(np_(rgb), np.asarray(rgb_ref), atol=5e-4)
    np.testing.assert_allclose(np_(ws), np.asarray(ws_ref), atol=5e-4)
    ref = _key_leaves(gref)
    got = list(tree_leaves_with_path(pp))
    assert [p for p, _ in ref] == [p for p, _ in got]
    n_grad = 0
    for (path, g), (_, leaf) in zip(ref, got):
        pg = np.zeros_like(g) if leaf.grad is None else leaf.grad.numpy()
        scale = np.abs(g).max()
        if scale == 0:
            assert np.abs(pg).max() <= 1e-6, path
            continue
        n_grad += 1
        assert np.abs(pg - g).max() <= 5e-4 * scale, \
            (path, np.abs(pg - g).max() / scale)
    # the colour, skinning, latent and hypernet leaves all got gradients
    assert n_grad >= 20, n_grad


def test_shade_resid_bf16_reaches_the_op(rng, monkeypatch):
    """`shade_resid_bf16` reaches kernel C through the C -> H op in a
    training render: the shading call gets `resid_bf16=True`, the f32
    eikonal call `False` (JAX hands its eikonal op neither flag). The
    plain versions honour the flag, as the kernels do: what depends on
    the SDF alone (weights, masks, the eikonal normals) equals the
    flag-off render's bit for bit, and the colour, which reads the
    normals, moves, within JAX's resid bound (2e-2 of its largest
    magnitude, `tests/test_pallas.py::test_resid_bf16_film`)."""
    from arah_tpu_torch.data.batch import draw_train_draws
    from arah_tpu_torch.ops import shade_grad
    from arah_tpu_torch.parallel.train_step import trainable
    from arah_tpu_torch.render.renderer import render
    cfg = small_config(train_skinning=True)
    _, params, _, inp = jax_scene(cfg, rng, n_rays=8)
    pp = trainable(port_params(params))
    draws = draw_train_draws(np.random.RandomState(0), port_cfg(cfg), 1, 8,
                             device='cpu')
    pinp = port_inputs(inp)._replace(
        points_uniform=torch.rand(16, 3) * 2 - 1,
        points_inside=torch.randn(16, 3) * 0.1,
        points_skinning=torch.randn(16, 3) * 0.2,
        points_eik=draws.points_eik[0])
    calls, real = [], shade_grad.siren_shade

    def spy(gen, x, **kw):
        calls.append((x.shape[0], kw.get('resid_bf16')))
        return real(gen, x, **kw)
    monkeypatch.setattr(shade_grad, 'siren_shade', spy)
    outs = {}
    for flag in (False, True):
        calls.clear()
        pcfg = port_cfg(cfg)._replace(shade_resid_bf16=flag)
        outs[flag] = render(pp, pcfg, pinp, training=True,
                            jitter=(draws.u1[0], draws.u2[0], draws.u3[0]))
        n_eik = pcfg.n_eik_points
        assert sorted(calls, key=lambda c: c[0] == n_eik) == \
            [(calls[0][0], flag), (n_eik, False)], calls
        assert calls[0][0] != n_eik
    assert outs[False].keys() == outs[True].keys()
    for k, v in outs[False].items():
        if isinstance(v, torch.Tensor) and k != 'rgb_values':
            assert torch.equal(v, outs[True][k]), k
    rgb0, rgb1 = outs[False]['rgb_values'], outs[True]['rgb_values']
    assert not torch.equal(rgb0, rgb1)
    assert float((rgb1 - rgb0).abs().max()) \
        <= 2e-2 * float(rgb0.abs().max())


def test_loss_vs_jax(rng):
    """`compute_loss`, all eight terms (perceptual 0 with no LPIPS
    function), on random render outputs with boundary pixels."""
    from arah_tpu.train.loss import LossWeights, compute_loss
    from arah_tpu_torch.train.loss import LossWeights as PW
    from arah_tpu_torch.train.loss import compute_loss as pcompute
    n, s = 40, 16
    out = {'rgb_values': rng.uniform(size=(n, 3)),
           'network_body_mask': rng.uniform(size=n) < 0.8,
           'weights_sum': rng.uniform(size=n),
           'grad_theta': rng.randn(32, 3),
           'off_surface_sdf': rng.randn(s, 1) * 0.05,
           'inside_sdf': rng.randn(s, 1) * 1e-3,
           'sdf_params': [rng.randn(8, 4), rng.randn(5)],
           'pred_weights': rng.uniform(size=(s, 24))}
    gt = {'rgb': rng.uniform(size=(n, 3)),
          'body_mask': rng.choice([0, 1, 100], size=n).astype(np.int32),
          'sampled_weights': rng.uniform(size=(s, 24))}
    for kind in ('l1', 'mse', 'smoothed_l1'):
        w = LossWeights(n_ray_loss=32, rgb_loss_type=kind, mask=1.0)
        ref = compute_loss(jax.tree.map(jnp.asarray, out),
                           jax.tree.map(jnp.asarray, gt), w)

        def conv(v):
            if isinstance(v, list):
                return [conv(a) for a in v]
            a = np.asarray(v)
            return torch.as_tensor(a) if a.dtype.kind in 'bi' else t(a)
        got = pcompute({k: conv(v) for k, v in out.items()},
                       {k: conv(v) for k, v in gt.items()},
                       PW(**w._asdict()))
        assert set(got) == set(ref)
        for k in ref:
            assert float(got[k]) == pytest.approx(float(ref[k]), rel=1e-5,
                                                  abs=1e-7), (kind, k)


@pytest.mark.parametrize('schedule', ['constant', 'cosine', 'exponential'])
def test_optimizer_vs_optax(rng, schedule):
    """Three Adam steps of `make_optimizer` on fixed gradient trees
    against optax's, every group (the latent's coupled weight decay, the
    skinning group, aux-free flagship tree), to 1e-6; frozen leaves stay
    bit for bit."""
    from arah_tpu.model import init_model_params
    from arah_tpu.train.optim import OptimConfig, make_optimizer
    import optax
    from arah_tpu_torch.parallel.train_step import trainable
    from arah_tpu_torch.train.optim import OptimConfig as POC
    from arah_tpu_torch.train.optim import make_optimizer as pmake
    from arah_tpu_torch.train.optim import tree_leaves_with_path
    cfg = small_config(train_skinning=True)
    params = init_model_params(jax.random.PRNGKey(0), cfg,
                               n_latent_frames=2)
    # sdf_hyper at 1e-4 (the flagship's 1e-6 moves an f32 leaf by a few
    # ulps), the pose encoder at 100x that
    ocfg = OptimConfig(train_skinning_net=True, lr=1e-4,
                       lr_schedule=schedule, lr_decay_steps=2)
    opt, labels = make_optimizer(ocfg, params)
    state = opt.init(params)
    pp = trainable(port_params(params))
    popt, plabels = pmake(POC(**ocfg._asdict()), pp)
    leaves = _key_leaves(params)
    assert [p for p, _ in leaves] == [p for p, _ in tree_leaves_with_path(pp)]
    assert {p: l for p, l in _key_leaves(labels)} == plabels
    assert set(plabels.values()) >= {'sdf_hyper', 'sdf_pose_encoder',
                                     'color', 'deviation', 'skinning',
                                     'latent', 'frozen'}
    before = {p: a.copy() for p, a in leaves}
    jp = params
    for _ in range(3):
        gs = [np.asarray(rng.randn(*np.shape(a)), np.float32)
              for _, a in leaves]
        gtree = jax.tree.unflatten(jax.tree.structure(params),
                                   [jnp.asarray(g) for g in gs])
        upd, state = opt.update(gtree, state, jp)
        jp = optax.apply_updates(jp, upd)
        popt.zero_grad()
        for (_, leaf), g in zip(tree_leaves_with_path(pp), gs):
            leaf.grad = torch.as_tensor(g)
        popt.step()
    for (path, ref), (_, leaf) in zip(_key_leaves(jp),
                                      tree_leaves_with_path(pp)):
        got = leaf.detach().numpy()
        if plabels[path] == 'frozen':
            np.testing.assert_array_equal(got, before[path])
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0,
                                   err_msg=str(path))
        # and the updates themselves, to f32 resolution of the leaves
        du_ref = np.asarray(ref) - before[path]
        assert np.abs((got - before[path]) - du_ref).max() <= \
            1e-3 * np.abs(du_ref).max() + 1e-7, path
