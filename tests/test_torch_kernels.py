"""The plain PyTorch versions of kernels A-I against their Pallas
originals run in interpret mode on the CPU. Each wrapper in
`arah_tpu_torch/ops/` computes its plain version for a CPU tensor, so
these tests call the wrappers themselves; on the card the same wrappers
launch the CUDA kernels, which `chip_smoke.py` holds against these plain
versions.

Tolerances:
  * A (knn): chosen-vertex distances within 1e-5, as tests/test_pallas.py
    holds the Pallas kernel (indices of near-ties may differ);
  * B (corr): Broyden can move a hard point to another, equally valid
    root, so valid-mask agreement > 0.98, median |dx| < 1e-5 on commonly
    valid points, and masked points frozen exactly;
  * C (shade): the sin(30 x) chain amplifies reassociation ~30x per layer
    at the flagship width 256, so f32 outputs are held at 1e-4 (sdf,
    features) and 1e-3 (normals) absolute; bf16 by median 1e-4 / p99 2e-2;
  * D (color): a ReLU MLP, f32 at 1e-5; bf16 by median 1e-4 / p99 2e-2;
  * E (march): a ray near a convergence threshold or a nearest-vertex
    near-tie can end its march elsewhere, so unfinished/diverged agreement
    >= 0.98, and t, x_norm and T on rays both sides finished within 1e-4;
  * F (iso): as B, valid agreement >= 0.98 and median |dx_hat| < 1e-5 on
    commonly valid rays; every plain-valid ray a root (|g(u)| < 5e-5);
    masked rays exactly at u0. The solve runs 10 steps: on this
    random-init SIREN ~5% of the rays are unconverged at 10 steps and
    wander, and from there on roundoff alone sends a few of them to
    different roots (valid agreement 0.96-0.99 at 20 steps, 1.0 at 10).
  * G (skin_jac): rtol 1e-4, atol 1e-5, as tests/test_pallas.py holds the
    Pallas kernel against forward_skinning_jac;
  * H (the C -> H op): in f32 values within 1e-5 and every gradient leaf
    within 1e-4 of its largest magnitude (reassociation only); under bf16
    a reassociated product can round an operand to the other bf16
    neighbour, so 5e-3 of the largest magnitude (measured ~1e-3);
  * I (the D -> I op): the same two rules, f32 1e-4 and bf16 5e-3.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_port_util import np_, port_gen, t

torch.set_num_threads(2)


def _robust(a, b, med=1e-4, p99=2e-2):
    d = np.abs(np_(a) - np.asarray(b, np.float32))
    assert np.median(d) < med, np.median(d)
    assert np.quantile(d, 0.99) < p99, np.quantile(d, 0.99)


class TestKnn:
    def test_plain_vs_pallas_t(self, rng):
        from arah_tpu.ops.pallas.knn_kernel import nn_idx_pallas_t
        from arah_tpu_torch.ops.knn import nn_idx
        pts = rng.randn(4096, 3).astype(np.float32)
        verts = rng.randn(1500, 3).astype(np.float32)
        ref = np.asarray(nn_idx_pallas_t(jnp.asarray(pts),
                                         jnp.asarray(verts), tile=1024,
                                         v_tile=512, interpret=True))
        out = nn_idx(t(pts), t(verts))
        assert out.dtype == torch.int32 and out.shape == (4096,)
        d_ref = np.linalg.norm(pts - verts[ref], axis=-1)
        d_out = np.linalg.norm(pts - verts[out.numpy()], axis=-1)
        np.testing.assert_allclose(d_out, d_ref, atol=1e-5)


class TestCorr:
    def test_plain_vs_pallas_t(self, rng):
        from arah_tpu.core.body import normalize_canonical_points
        from arah_tpu.core.smpl import batch_rodrigues
        from arah_tpu.nn.skinning import SkinningConfig, init_skinning
        from arah_tpu.ops.pallas.corr_kernel_t import (corr_search_pallas_t,
                                                       skinning_dense_params)
        from arah_tpu.render.ray_tracing import CanonicalFrame
        from arah_tpu.render.renderer import make_skin_fn
        from arah_tpu.solver.root_find import forward_skinning
        from arah_tpu_torch.ops.corr import corr_search

        cfg = SkinningConfig(d_hidden=128, n_layers=4)
        params = init_skinning(jax.random.PRNGKey(0), cfg)
        aa = (rng.randn(24, 3) * 0.15).astype(np.float32)
        tfs = np.tile(np.eye(4, dtype=np.float32), (24, 1, 1))
        tfs[:, :3, :3] = np.asarray(batch_rodrigues(jnp.asarray(aa)))
        tfs[:, :3, 3] = (rng.randn(24, 3) * 0.05).astype(np.float32)
        frame = CanonicalFrame(
            bone_transforms=jnp.asarray(tfs), trans=jnp.zeros(3),
            coord_min=jnp.float32(-1.1), coord_max=jnp.float32(1.0),
            center=jnp.asarray(rng.randn(3).astype(np.float32) * 0.05))
        skin_fn = make_skin_fn({'skinning': params},
                               type('C', (), {'skinning': cfg}))
        n = 512
        x_gt = jnp.asarray(rng.randn(n, 3).astype(np.float32) * 0.3)
        x_bar, _ = forward_skinning(skin_fn, frame, x_gt)
        x0 = x_gt + 0.03 * jnp.asarray(rng.randn(n, 3).astype(np.float32))
        w0 = skin_fn(normalize_canonical_points(
            x0, frame.coord_min, frame.coord_max, frame.center))
        T0 = jnp.einsum('nj,jab->nab', w0, frame.bone_transforms)
        mask = rng.rand(n) > 0.1
        wts, bs = skinning_dense_params(params, cfg)
        args = (x_bar, x0, T0.reshape(n, 16), jnp.asarray(mask), list(wts),
                list(bs), frame.bone_transforms.reshape(24, 16),
                frame.coord_min, frame.coord_max, frame.center)
        ref = corr_search_pallas_t(*args, tile=256, max_steps=20,
                                   interpret=True)
        out = corr_search(
            t(x_bar), t(x0), t(T0.reshape(n, 16)), torch.as_tensor(mask),
            [t(w) for w in wts], [t(b) for b in bs],
            t(frame.bone_transforms.reshape(24, 16)), t(frame.coord_min),
            t(frame.coord_max), t(frame.center), max_steps=20)
        v_ref, v_out = np.asarray(ref[2]), out[2].numpy()
        assert (v_ref == v_out).mean() > 0.98
        both = v_ref & v_out
        assert both.mean() > 0.8
        dx = np.linalg.norm(np_(out[0]) - np.asarray(ref[0]), axis=-1)
        assert np.median(dx[both]) < 1e-5, np.median(dx[both])
        np.testing.assert_allclose(np_(out[1])[both],
                                   np.asarray(ref[1])[both], atol=5e-4)
        np.testing.assert_array_equal(np_(out[0])[~mask],
                                      np.asarray(x0)[~mask])
        np.testing.assert_array_equal(out[3].numpy() & ~mask, False)


def _flagship_gen(rng):
    from arah_tpu.nn.hypernet import (HypernetConfig, hypernet_cond,
                                      hypernet_generate, init_hypernet)
    cfg = HypernetConfig()
    params = init_hypernet(jax.random.PRNGKey(0), cfg)
    cond = hypernet_cond(
        params, cfg, jnp.asarray(rng.randn(1, 24, 9).astype(np.float32)),
        jnp.asarray(rng.randn(1, 24, 3).astype(np.float32)))[0]
    return hypernet_generate(params, cfg, cond, jnp.asarray(
        rng.randn(128).astype(np.float32)))


class TestShade:
    @pytest.mark.parametrize('bf16', [False, True])
    def test_plain_vs_pallas(self, rng, bf16):
        from arah_tpu.ops.pallas.shade_kernel import siren_shade_pallas
        from arah_tpu_torch.ops.shade import siren_shade
        gen = _flagship_gen(rng)
        x = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
        ro, rf, rg = siren_shade_pallas(gen, jnp.asarray(x), tile=128,
                                        bf16=bf16, interpret=True)
        out, feat, grad = siren_shade(port_gen(gen), t(x), bf16=bf16)
        assert feat.dtype == (torch.bfloat16 if bf16 else torch.float32)
        assert out.shape == (300, 1) and grad.shape == (300, 3)
        rf = np.asarray(rf.astype(jnp.float32))
        if bf16:
            for a, b in ((out, ro), (feat, rf), (grad, rg)):
                _robust(a, b)
        else:
            np.testing.assert_allclose(np_(out), np.asarray(ro), atol=1e-4)
            np.testing.assert_allclose(np_(feat), rf, atol=1e-4)
            np.testing.assert_allclose(np_(grad), np.asarray(rg), atol=1e-3)


class TestColor:
    @pytest.mark.parametrize('bf16', [False, True])
    def test_plain_vs_pallas(self, rng, bf16):
        """Flagship layout (x0 = [small 33 | feats | pose 128], skip at
        layer 3) at a narrow hidden width."""
        from arah_tpu.ops.pallas.color_kernel import color_mlp_fused as J
        from arah_tpu_torch.ops.color import color_mlp_fused as P
        S, F, Pw, H, n = 33, 64, 128, 64, 200
        d0 = S + F + Pw
        dims = [(d0, H), (H, H), (H, H // 2), (d0 + H // 2, H), (H, H),
                (H, 3)]
        ws = [(rng.randn(o, i) / np.sqrt(i)).astype(np.float32)
              for i, o in dims]
        bs = [(rng.randn(o) * 0.1).astype(np.float32) for _, o in dims]
        small = rng.randn(n, S).astype(np.float32)
        feats = rng.uniform(-1, 1, (n, F)).astype(np.float32)
        pose = rng.randn(1, Pw).astype(np.float32)
        ref = J([jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs],
                jnp.asarray(small), jnp.asarray(feats), jnp.asarray(pose),
                skips=(3,), bf16=bf16, tile=64, interpret=True)
        feats_t = t(feats).bfloat16() if bf16 else t(feats)
        out = P([t(w) for w in ws], [t(b) for b in bs], t(small), feats_t,
                t(pose), skips=(3,), bf16=bf16)
        assert out.shape == (n, 3)
        if bf16:
            _robust(out, ref)
        else:
            np.testing.assert_allclose(np_(out), np.asarray(ref), atol=1e-5)


def _march_scene(rng, cfg):
    """The scene of tests/test_pallas.py's march and iso kernel tests: a
    460-vertex body, its generated SIREN (FiLM on) and 256 rays aimed at
    posed vertices."""
    from arah_tpu.core.rays import ray_aabb
    from arah_tpu.data.synthetic import synthetic_smpl
    from arah_tpu.model import init_model_params, prepare_frame
    from arah_tpu.render.renderer import generate_sdf
    model = synthetic_smpl(n_verts=460)
    params = init_model_params(jax.random.PRNGKey(0), cfg, n_latent_frames=2)
    pose = jnp.asarray((rng.randn(72) * 0.2).astype(np.float32))
    betas = jnp.asarray((rng.randn(10) * 0.3).astype(np.float32))
    fd = prepare_frame(model, betas, pose,
                       jnp.asarray([0.1, 0.0, 0.2], jnp.float32))
    gen = generate_sdf(params, cfg, fd.rots, fd.Jtrs, params['latent'][0])
    n = 256
    cam = jnp.asarray([0.0, 0.3, -2.5])
    dirs = fd.smpl.verts_posed[rng.randint(0, 460, n)] - cam
    dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
    cam_b = jnp.broadcast_to(cam, dirs.shape)
    near, far, _ = ray_aabb(fd.bounds_min, fd.bounds_max, cam_b, dirs)
    return params, fd, gen, cam_b, dirs, near, far


class TestMarch:
    def test_plain_vs_pallas(self, rng):
        from arah_tpu.ops.pallas.march_kernel import sphere_march_pallas
        from arah_tpu_torch.ops.march import sphere_march, sphere_march_plain
        from test_renderer import small_config
        from torch_port_util import port_frame
        _, fd, gen, cam, dirs, near, far = _march_scene(rng, small_config())
        ref = sphere_march_pallas(
            cam, dirs, near, far, fd.smpl.verts_posed,
            fd.smpl.skinning_weights,
            fd.frame.bone_transforms.reshape(24, 16), list(gen.weights),
            list(gen.biases), list(gen.freqs), list(gen.phases),
            fd.frame.coord_min, fd.frame.coord_max, fd.frame.center,
            fd.frame.trans, tile=128, n_iters=20, interpret=True)
        ref = [np.asarray(a) for a in ref]
        args = (t(cam), t(dirs), t(near), t(far), t(fd.smpl.verts_posed),
                t(fd.smpl.skinning_weights), port_frame(fd.frame),
                port_gen(gen))
        out = sphere_march(*args, n_iters=20)
        assert len(out) == 5 and out[4].shape == (256, 16)
        unf, div = out[1].numpy(), out[2].numpy()
        assert (unf == ref[1]).mean() >= 0.98, (unf == ref[1]).mean()
        assert (div == ref[2]).mean() >= 0.98, (div == ref[2]).mean()
        both = ~unf & ~div & ~ref[1] & ~ref[2]
        assert both.mean() > 0.1, both.mean()
        for a, b in zip(out[0:1] + out[3:5], ref[0:1] + ref[3:5]):
            np.testing.assert_allclose(np_(a)[both], b[both], atol=1e-4)
        # the plain version counts each ray's iterations
        iters = sphere_march_plain(*args, n_iters=20)[5].numpy()
        assert iters.max() <= 20 and (iters[unf] == 20).all()
        assert (iters[np.asarray(near) >= np.asarray(far)] == 0).all()
        assert iters.sum() > 0

    def test_ties_average_weights(self):
        """Two vertices at the same distance: the plain version blends
        their skinning weights half and half (march_kernel.py:21-23), where
        the first-index rule of kernel A would take one of them."""
        from arah_tpu_torch.ops.march import nn_weights_tied
        verts = t([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 3.0, 0.0]])
        sw = torch.zeros((3, 24))
        sw[0, 1] = sw[1, 2] = sw[2, 3] = 1.0
        pts = t([[0.0, 0.0, 0.0], [0.5, 0.0, 0.0]])
        w = nn_weights_tied(pts, verts, sw).numpy()
        np.testing.assert_array_equal(w[0, 1:3], [0.5, 0.5])
        np.testing.assert_array_equal(w[1], sw[0].numpy())


class TestIso:
    def test_plain_vs_pallas(self, rng):
        from arah_tpu.core.body import (normalize_canonical_points,
                                        sdf_to_metric,
                                        unnormalize_canonical_points)
        from arah_tpu.ops.pallas.corr_kernel_t import skinning_dense_params
        from arah_tpu.ops.pallas.iso_kernel import iso_refine_pallas
        from arah_tpu.render.ray_tracing import RayTracerConfig, _march_xla
        from arah_tpu.render.renderer import make_sdf_fn, make_skin_fn
        from arah_tpu.solver.root_find import (forward_skinning,
                                               iso_init_inv_jacobian)
        from arah_tpu_torch.ops.iso import iso_refine
        from test_renderer import small_config
        from torch_port_util import port_frame
        cfg = small_config()
        params, fd, gen, cam, dirs, near, far = _march_scene(rng, cfg)
        sdf_fn, skin_fn = make_sdf_fn(gen), make_skin_fn(params, cfg)
        c = _march_xla(RayTracerConfig(sphere_tracing_iters=12), sdf_fn,
                       fd.frame, fd.smpl, cam, dirs, near, far)
        fr = fd.frame
        x_hat = unnormalize_canonical_points(c.x_norm, fr.coord_min,
                                             fr.coord_max, fr.center)
        valid = np.array(~c.diverged)
        valid[::7] = False                  # a few more masked rays
        n = dirs.shape[0]
        J_inv0 = iso_init_inv_jacobian(sdf_fn, skin_fn, fr, dirs, x_hat)
        u0 = jnp.concatenate([x_hat, c.t[:, None]], axis=-1)
        wts, bs = skinning_dense_params(params['skinning'], cfg.skinning)
        scale = cfg.skinning.softmax_scale
        ref = iso_refine_pallas(
            cam, dirs, u0, c.T_fwd.reshape(n, 16), J_inv0.reshape(n, 16),
            jnp.asarray(valid), list(wts), list(bs),
            fr.bone_transforms.reshape(24, 16), list(gen.weights),
            list(gen.biases), list(gen.freqs), list(gen.phases),
            fr.coord_min, fr.coord_max, fr.center, fr.trans, tile=128,
            max_steps=10, softmax_scale=scale, interpret=True)
        u, T16, ok, act = iso_refine(
            t(cam), t(dirs), t(u0), t(c.T_fwd.reshape(n, 16)),
            t(J_inv0.reshape(n, 16)), torch.as_tensor(valid),
            [t(w) for w in wts], [t(b) for b in bs], port_frame(fr),
            port_gen(gen), max_steps=10, softmax_scale=scale)
        v_ref, v_out = np.asarray(ref[2]), ok.numpy()
        assert (v_ref == v_out).mean() >= 0.98, (v_ref == v_out).mean()
        both = v_ref & v_out
        assert both.mean() > 0.1, both.mean()
        dx = np.linalg.norm(np_(u)[:, :3] - np.asarray(ref[0])[:, :3], axis=-1)
        assert np.median(dx[both]) < 1e-5, np.median(dx[both])
        # every plain-valid ray is a root of the JAX residual
        x_k, z_k = jnp.asarray(np_(u)[:, :3]), jnp.asarray(np_(u)[:, 3])
        xb, _ = forward_skinning(skin_fn, fr, x_k)
        err = xb - (cam + z_k[:, None] * dirs - fr.trans)
        sdf = sdf_to_metric(sdf_fn(normalize_canonical_points(
            x_k, fr.coord_min, fr.coord_max, fr.center)), fr.coord_min,
            fr.coord_max)
        g = np.linalg.norm(np.concatenate(
            [np.asarray(sdf)[:, None], np.asarray(err)], axis=-1), axis=-1)
        assert g[v_out].max() < 5e-5, g[v_out].max()
        # masked rays stay exactly at u0 and T0, never valid or active
        off = ~valid
        assert off.any()
        np.testing.assert_array_equal(np_(u)[off], np.asarray(u0)[off])
        np.testing.assert_array_equal(
            np_(T16)[off], np.asarray(c.T_fwd.reshape(n, 16))[off])
        assert not (v_out[off].any() or act.numpy()[off].any())


class TestSkinJac:
    def test_plain_vs_pallas_and_exact(self, rng):
        """Kernel G's plain version against `skinning_jac_pallas` and
        `forward_skinning_jac`; 300 points (not a tile multiple)."""
        from arah_tpu.core.smpl import batch_rodrigues
        from arah_tpu.nn.skinning import SkinningConfig, init_skinning
        from arah_tpu.ops.pallas.corr_kernel_t import (skinning_dense_params,
                                                       skinning_jac_pallas)
        from arah_tpu.render.ray_tracing import CanonicalFrame
        from arah_tpu.render.renderer import make_skin_fn
        from arah_tpu.solver.root_find import forward_skinning_jac
        from arah_tpu_torch.ops.skin_jac import skinning_jac
        from torch_port_util import port_frame
        cfg = SkinningConfig(d_hidden=64, n_layers=3)
        params = init_skinning(jax.random.PRNGKey(0), cfg)
        aa = (rng.randn(24, 3) * 0.15).astype(np.float32)
        tfs = np.tile(np.eye(4, dtype=np.float32), (24, 1, 1))
        tfs[:, :3, :3] = np.asarray(batch_rodrigues(jnp.asarray(aa)))
        tfs[:, :3, 3] = (rng.randn(24, 3) * 0.05).astype(np.float32)
        frame = CanonicalFrame(
            bone_transforms=jnp.asarray(tfs), trans=jnp.zeros(3),
            coord_min=jnp.float32(-1.1), coord_max=jnp.float32(1.0),
            center=jnp.asarray(rng.randn(3).astype(np.float32) * 0.05))
        x = rng.randn(300, 3).astype(np.float32) * 0.3
        wts, bs = skinning_dense_params(params, cfg)
        ref = skinning_jac_pallas(
            jnp.asarray(x), wts, bs, frame.bone_transforms.reshape(24, 16),
            frame.coord_min, frame.coord_max, frame.center, tile=128,
            interpret=True)
        exact = forward_skinning_jac(
            make_skin_fn({'skinning': params},
                         type('C', (), {'skinning': cfg})),
            frame, jnp.asarray(x))
        out = skinning_jac(t(x), [t(w) for w in wts], [t(b) for b in bs],
                           port_frame(frame))
        assert tuple(out.shape) == (300, 3, 3)
        for r in (ref, exact):
            np.testing.assert_allclose(np_(out), np.asarray(r), rtol=1e-4,
                                       atol=1e-5)


def _small_gen(rng, film):
    from arah_tpu.nn.hypernet import (HypernetConfig, hypernet_cond,
                                      hypernet_generate, init_hypernet)
    cfg = HypernetConfig(hidden_features=64, num_hidden_layers=3,
                         use_film=film)
    params = init_hypernet(jax.random.PRNGKey(0), cfg)
    cond = hypernet_cond(
        params, cfg, jnp.asarray(rng.randn(1, 24, 9).astype(np.float32)),
        jnp.asarray(rng.randn(1, 24, 3).astype(np.float32)))[0]
    return hypernet_generate(params, cfg, cond, jnp.asarray(
        rng.randn(128).astype(np.float32)) if film else None)


def _rel(a, b):
    b = np.asarray(b, np.float32)
    return float(np.abs(np_(a) - b).max() / max(np.abs(b).max(), 1e-3))


class TestShadeGrad:
    @pytest.mark.parametrize('film', [True, False])
    @pytest.mark.parametrize('bf16', [False, True])
    @pytest.mark.parametrize('ref', ['pallas', 'xla'])
    def test_plain_vs_jax(self, rng, film, bf16, ref):
        """The C -> H op (plain versions on CPU tensors): values and the
        gradients of a random-cotangent scalarisation, for every leaf and
        the points, against `siren_shade_grad` (Pallas interpret, tiles
        64/32, 200 points: padded rows) and `siren_shade_grad_xla`."""
        from arah_tpu.ops.pallas.shade_grad_kernel import (
            siren_shade_grad as jop, siren_shade_grad_xla)
        from arah_tpu_torch.ops.shade_grad import siren_shade_grad
        gen = _small_gen(rng, film)
        fn = (lambda g, p: jop(g, p, tile=64, tile_bwd=32, bf16=bf16,
                               interpret=True)) if ref == 'pallas' \
            else (lambda g, p: siren_shade_grad_xla(g, p, bf16=bf16))
        x = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
        cts = [rng.randn(200, d).astype(np.float32) for d in (1, 64, 3)]

        def loss(g, p):
            return sum(jnp.sum(o * c) for o, c in zip(fn(g, p), cts))
        vals = fn(gen, jnp.asarray(x))
        gref = jax.grad(loss, argnums=(0, 1))(gen, jnp.asarray(x))
        pg = port_gen(gen)
        leaves = [a.requires_grad_() for part in pg for a in part]
        xt = t(x).requires_grad_()
        outs = siren_shade_grad(pg, xt, bf16=bf16)
        assert all(o.dtype == torch.float32 for o in outs)
        tol_v, tol_g = (5e-3, 5e-3) if bf16 else (1e-5, 1e-4)
        for a, b in zip(outs, vals):
            assert _rel(a, b) < tol_v
        sum(torch.sum(o * t(c)) for o, c in zip(outs, cts)).backward()
        ref_leaves = jax.tree.leaves(gref[0]) + [gref[1]]
        assert len(ref_leaves) == len(leaves) + 1
        for a, b in zip(leaves + [xt], ref_leaves):
            assert _rel(a.grad, b) < tol_g, (tuple(a.shape), _rel(a.grad, b))

    def test_gradcheck_f64(self):
        """The plain backward (`shade_bwd_plain`) is the gradient of the
        plain forward: torch.autograd.gradcheck in f64 at width 8, two
        outputs, FiLM on."""
        from arah_tpu_torch.nn.siren import GeneratedMLP
        from arah_tpu_torch.ops.shade_grad import siren_shade_grad
        g = torch.Generator().manual_seed(0)
        dt = torch.float64
        W = [torch.randn(8, 3, generator=g, dtype=dt) * 0.3] + \
            [torch.randn(8, 8, generator=g, dtype=dt) * 0.1
             for _ in range(2)] + [torch.randn(2, 8, generator=g, dtype=dt)]
        B = [torch.randn(w.shape[0], generator=g, dtype=dt) * 0.1 for w in W]
        Fq = [1 + 0.1 * torch.randn(8, generator=g, dtype=dt)
              for _ in range(3)]
        Ph = [0.1 * torch.randn(8, generator=g, dtype=dt) for _ in range(3)]
        leaves = [a.requires_grad_() for a in W + B + Fq + Ph]
        x = torch.randn(5, 3, generator=g, dtype=dt).requires_grad_()

        def f(x, *lv):
            return siren_shade_grad(GeneratedMLP(
                tuple(lv[:4]), tuple(lv[4:8]), tuple(lv[8:11]),
                tuple(lv[11:])), x)
        assert torch.autograd.gradcheck(f, (x, *leaves))


class TestKernelPacks:
    def test_corr_pack_of_dense_is_rows_pack(self, rng):
        """Kernel B's pack of dense (out, in) skinning weights (their
        transposed views, as `corr_search` packs them) is kernel L's pack
        of their transposes (`pack_skin_t`): the same buffer and the same
        NetMeta bytes, so the two launch one kernel on the same
        operands."""
        from arah_tpu_torch.ops.corr import pack_skin_t
        dims = (3, 128, 128, 128, 25)
        dense = [t(rng.randn(o, i).astype(np.float32) / np.sqrt(i))
                 for i, o in zip(dims[:-1], dims[1:])]
        biases = [t(rng.randn(o).astype(np.float32) * 0.1) for o in dims[1:]]
        pb, mb = pack_skin_t([w.t() for w in dense], biases)
        pl, ml = pack_skin_t([w.T.contiguous() for w in dense], biases)
        assert torch.equal(pb, pl)
        assert bytes(mb) == bytes(ml)
        assert mb.n_skin == 4 and list(mb.skin_dims)[:5] == list(dims)

    @pytest.mark.parametrize('film', [True, False])
    def test_shade_bf16_pack_round_trips(self, rng, film):
        """Kernel H's bf16 weight pack holds each hidden layer's W_i and
        W_i^T; back in f32 they are exactly the blocks `pack_shade(gen,
        bf16=True)` stores (w_off, wt_off), the weights rounded to bf16."""
        from arah_tpu_torch.ops.shade import pack_shade, pack_shade_bf16
        gen = port_gen(_small_gen(rng, film))
        wb = pack_shade_bf16(gen)
        params, meta = pack_shade(gen, bf16=True)
        L, H = len(gen.weights), gen.weights[0].shape[0]
        assert wb.dtype == torch.bfloat16
        assert tuple(wb.shape) == (L - 2, 2, H, H)
        for i in range(1, L - 1):
            w = params[meta.w_off[i]:meta.w_off[i] + H * H].reshape(H, H)
            wt = params[meta.wt_off[i]:meta.wt_off[i] + H * H].reshape(H, H)
            assert torch.equal(wb[i - 1, 0].float(), w)
            assert torch.equal(wb[i - 1, 1].float(), wt)
            assert torch.equal(w, gen.weights[i].bfloat16().float())


class TestColorGrad:
    def _net(self, rng):
        S, F, Pw, H, n = 33, 64, 128, 64, 200
        d0 = S + F + Pw
        dims = [(d0, H), (H, H), (H, H // 2), (d0 + H // 2, H), (H, H),
                (H, 3)]
        ws = [(rng.randn(o, i) / np.sqrt(i)).astype(np.float32)
              for i, o in dims]
        bs = [(rng.randn(o) * 0.1).astype(np.float32) for _, o in dims]
        ins = (rng.randn(n, S).astype(np.float32),
               rng.uniform(-1, 1, (n, F)).astype(np.float32),
               rng.randn(1, Pw).astype(np.float32))
        return ws, bs, ins, rng.randn(n, 3).astype(np.float32)

    @pytest.mark.parametrize('bf16', [False, True])
    def test_plain_vs_pallas(self, rng, monkeypatch, bf16):
        """The D -> I op (plain versions) against `color_mlp_fused` with
        the Pallas pair in interpret mode (tiles 64/32, 200 points),
        under ARAH_FORCE_PALLAS=1: rgb, and dW, db, dsmall, dfeats and
        dpose of a random-cotangent scalarisation; flagship layout (skip
        at layer 3 and the pose row) at a narrow width."""
        from arah_tpu.ops.pallas.color_kernel import color_mlp_fused as J
        from arah_tpu_torch.ops.color import color_mlp_fused as P
        monkeypatch.setenv('ARAH_FORCE_PALLAS', '1')
        ws, bs, ins, g = self._net(rng)

        def jloss(w, b, s, f, p):
            return jnp.sum(J(w, b, s, f, p, skips=(3,), bf16=bf16, tile=64,
                             tile_bwd=32, interpret=True) * g)
        args = ([jnp.asarray(a) for a in ws], [jnp.asarray(a) for a in bs],
                *(jnp.asarray(a) for a in ins))
        ref_rgb = J(*args, skips=(3,), bf16=bf16, tile=64, interpret=True)
        gref = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*args)
        tw = [t(a).requires_grad_() for a in ws]
        tb = [t(a).requires_grad_() for a in bs]
        ti = [t(a).requires_grad_() for a in ins]
        rgb = P(tw, tb, *ti, skips=(3,), bf16=bf16)
        tol = 5e-3 if bf16 else 1e-4
        assert _rel(rgb, ref_rgb) < tol
        (rgb * t(g)).sum().backward()
        ref_leaves = list(gref[0]) + list(gref[1]) + list(gref[2:])
        for a, b in zip(tw + tb + ti, ref_leaves):
            assert _rel(a.grad, b) < tol, (tuple(a.shape), _rel(a.grad, b))

    def test_f32_equals_autograd_of_plain(self, rng):
        """In f32 the explicit backward is autograd of `color_mlp_plain`
        (up to reassociation: 1e-5 of each leaf's largest magnitude)."""
        from arah_tpu_torch.ops.color import color_mlp_fused, color_mlp_plain
        ws, bs, ins, g = self._net(rng)
        res = []
        for fn in (color_mlp_fused, color_mlp_plain):
            leaves = [t(a).requires_grad_() for a in ws + bs + list(ins)]
            out = fn(leaves[:6], leaves[6:12], *leaves[12:], skips=(3,))
            (out * t(g)).sum().backward()
            res.append((out.detach(), [a.grad for a in leaves]))
        assert _rel(res[0][0], np_(res[1][0])) < 1e-6
        for a, b in zip(res[0][1], res[1][1]):
            assert _rel(a, np_(b)) < 1e-5
