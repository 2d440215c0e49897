"""The bench-scene fit (`arah_tpu_torch/utils/bench_scene.py`) against
`arah_tpu/utils/bench_scene.py` on the CPU: the capsule body, the fit's
loss and its gradient on the same (numpy-drawn) points, and a short fit
that lowers the loss.

Tolerances: the capsule segments and the capsule SDF/weights are short
f32 chains, held to 1e-6. The loss runs the hypernetwork, the SIREN (with
its sin(30 x) chain), a second-order eikonal term and the skinning net:
value to 1e-5 relative, each gradient leaf to 1e-3 relative (1e-5 of its
largest entry absolute) against JAX's.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_renderer import small_config
from torch_port_util import np_, port_cfg, port_params, t

torch.set_num_threads(2)


@pytest.fixture()
def body(rng):
    """(JAX model, betas, JAX params, JAX frame, port frame) of a small
    posed synthetic body."""
    from arah_tpu.data.synthetic import synthetic_smpl
    from arah_tpu.model import init_model_params, prepare_frame as jprep
    from arah_tpu_torch.model import prepare_frame as pprep
    model = synthetic_smpl(n_verts=512)
    betas = (rng.randn(10) * 0.3).astype(np.float32)
    pose = (rng.randn(72) * 0.2).astype(np.float32)
    trans = np.asarray([0.1, 0.0, 0.2], np.float32)
    params = init_model_params(jax.random.PRNGKey(0), small_config(),
                               n_latent_frames=2)
    jfd = jprep(model, jnp.asarray(betas), jnp.asarray(pose),
                jnp.asarray(trans))
    pfd = pprep(jax.tree.map(np.asarray, model), betas, pose, trans,
                device='cpu')
    return model, betas, params, jfd, pfd


def _points(rng, jfd, n=256):
    """Canonical metric points: half near the body's canonical vertices,
    half uniform in its normalised box (numpy draws)."""
    from arah_tpu.core.body import unnormalize_canonical_points
    v = np.asarray(jfd.verts_cano)
    surf = v[rng.randint(0, len(v), n // 2)] \
        + rng.randn(n // 2, 3).astype(np.float32) * 0.04
    fr = jfd.frame
    cube = np.asarray(unnormalize_canonical_points(
        jnp.asarray(rng.uniform(-1, 1, (n - n // 2, 3)).astype(np.float32)),
        fr.coord_min, fr.coord_max, fr.center))
    return np.concatenate([surf, cube]).astype(np.float32)


def test_capsule_body_vs_jax(rng, body):
    from arah_tpu.utils import bench_scene as J
    from arah_tpu_torch.utils import bench_scene as P
    model, betas, _, jfd, _ = body
    ja, jb = J.capsule_segments_02v(model, jnp.asarray(betas))
    pa, pb = P.capsule_segments_02v(model, t(betas))
    np.testing.assert_allclose(np_(pa), np.asarray(ja), atol=1e-6)
    np.testing.assert_allclose(np_(pb), np.asarray(jb), atol=1e-6)
    x = _points(rng, jfd)
    js, jw = J.capsule_sdf_and_weights(jnp.asarray(x), ja, jb)
    ps, pw = P.capsule_sdf_and_weights(t(x), t(ja), t(jb))
    np.testing.assert_allclose(np_(ps), np.asarray(js), atol=1e-6)
    np.testing.assert_allclose(np_(pw), np.asarray(jw), atol=1e-6)


def test_loss_and_grad_vs_jax(rng, body):
    """`scene_loss` and its gradient in `hypo_init` and the skinning
    parameters against the expression of `arah_tpu/utils/bench_scene.py:
    113-137`, built from the JAX package's functions, at the same
    points."""
    from arah_tpu.core.body import (normalize_canonical_points,
                                    sdf_to_metric)
    from arah_tpu.render.renderer import (generate_sdf, make_sdf_fn,
                                          make_skin_fn)
    from arah_tpu.utils.bench_scene import (capsule_sdf_and_weights,
                                            capsule_segments_02v)
    from arah_tpu_torch.utils.bench_scene import scene_loss, with_leaves
    model, betas, params, jfd, pfd = body
    cfg = small_config()
    x = _points(rng, jfd)
    seg_a, seg_b = capsule_segments_02v(model, jnp.asarray(betas))
    fr = jfd.frame

    def jloss(leaves):
        p = dict(params)
        p['hypernet'] = dict(params['hypernet'], hypo_init=leaves['hypo'])
        p['skinning'] = leaves['skin']
        xj = jnp.asarray(x)
        x_norm = normalize_canonical_points(xj, fr.coord_min, fr.coord_max,
                                            fr.center)
        sdf_t, w_t = capsule_sdf_and_weights(xj, seg_a, seg_b)
        gen = generate_sdf(p, cfg, jfd.rots, jfd.Jtrs, p['latent'][0])
        sdf_fn = make_sdf_fn(gen)
        sdf_m = sdf_to_metric(sdf_fn(x_norm), fr.coord_min, fr.coord_max)
        l_sdf = jnp.mean(jnp.abs(sdf_m - sdf_t))
        g = jax.vmap(jax.jacfwd(
            lambda q: sdf_to_metric(sdf_fn(q[None]), fr.coord_min,
                                    fr.coord_max)[0]))(x_norm[:512])
        scale = 2.0 / (1.1 * (fr.coord_max - fr.coord_min))
        l_eik = jnp.mean((jnp.linalg.norm(g * scale, axis=-1) - 1.0) ** 2)
        w = make_skin_fn(p, cfg)(x_norm)
        l_skin = jnp.mean(jnp.sum((w - w_t) ** 2, axis=-1))
        return l_sdf + 0.01 * l_eik + 0.5 * l_skin

    leaves = {'hypo': params['hypernet']['hypo_init'],
              'skin': params['skinning']}
    jval, jgrad = jax.value_and_grad(jloss)(leaves)

    pp = port_params(params)
    hypo = [h.clone().requires_grad_(True)
            for h in pp['hypernet']['hypo_init']]
    skin = {'layers': [{k: v.clone().requires_grad_(True)
                        for k, v in lyr.items()}
                       for lyr in pp['skinning']['layers']]}
    loss = scene_loss(with_leaves(pp, hypo, skin), port_cfg(cfg), pfd,
                      t(seg_a), t(seg_b), t(x))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jval), rtol=1e-5)

    def close(a, b):
        b = np.asarray(b)
        np.testing.assert_allclose(np_(a.grad), b, rtol=1e-3,
                                   atol=1e-5 * np.abs(b).max())
    for h, jh in zip(hypo, jgrad['hypo']):
        close(h, jh)
    for lyr, jl in zip(skin['layers'], jgrad['skin']['layers']):
        assert set(lyr) == set(jl)
        for k in lyr:
            close(lyr[k], jl[k])


def test_short_fit_lowers_the_loss(rng, body):
    """30 Adam steps of `pretrain_scene` (small config, 1,024-point
    batches) lower the loss at a fixed batch of points, touch only
    `hypo_init` and the skinning net, and leave the input params as they
    were."""
    from arah_tpu_torch.utils.bench_scene import (capsule_segments_02v,
                                                  pretrain_scene, scene_loss)
    model, betas, params, jfd, pfd = body
    cfg = port_cfg(small_config())
    pp = port_params(params)
    before = [h.clone() for h in pp['hypernet']['hypo_init']]
    fit, losses = pretrain_scene(pp, cfg, jax.tree.map(np.asarray, model),
                                 t(betas), pfd, steps=30, batch=1024)
    assert losses.shape == (30,) and bool(torch.isfinite(losses).all())
    x = t(_points(rng, jfd, 1024))
    seg = capsule_segments_02v(model, t(betas))
    with torch.enable_grad():
        l0 = float(scene_loss(pp, cfg, pfd, *seg, x))
        l1 = float(scene_loss(fit, cfg, pfd, *seg, x))
    assert l1 < l0, (l0, l1)
    for a, b in zip(pp['hypernet']['hypo_init'], before):
        assert torch.equal(a, b)
    assert fit['color'] is pp['color']
    assert fit['hypernet']['hyper_layers'] is pp['hypernet']['hyper_layers']
