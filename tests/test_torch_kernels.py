"""The plain PyTorch versions of kernels A-I against their Pallas
originals run in interpret mode on the CPU. Each wrapper in
`arah_tpu_torch/ops/` computes its plain version for a CPU tensor, so
these tests call the wrappers themselves; on the card the same wrappers
launch the CUDA kernels, which `chip_smoke.py` holds against these plain
versions.

Tolerances:
  * A (knn): chosen-vertex distances within 1e-5, as tests/test_pallas.py
    holds the Pallas kernel (indices of near-ties may differ), and the
    same indices where duplicated vertices make the tie rule decide;
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
    @pytest.mark.parametrize('case', ['random', 'duplicates'])
    def test_plain_vs_pallas_t(self, rng, case):
        """With duplicates (vertices 0..299 repeated at 1200..1499, every
        point within ~1e-3 of one of them) the tie rule decides every
        point: the indices must be the Pallas kernel's, the first copy."""
        from arah_tpu.ops.pallas.knn_kernel import nn_idx_pallas_t
        from arah_tpu_torch.ops.knn import nn_idx
        verts = rng.randn(1500, 3).astype(np.float32)
        if case == 'duplicates':
            verts[1200:] = verts[:300]
            pts = verts[rng.randint(0, 300, 4096)] \
                + rng.randn(4096, 3).astype(np.float32) * 1e-3
        else:
            pts = rng.randn(4096, 3).astype(np.float32)
        ref = np.asarray(nn_idx_pallas_t(jnp.asarray(pts),
                                         jnp.asarray(verts), tile=1024,
                                         v_tile=512, interpret=True))
        out = nn_idx(t(pts), t(verts))
        assert out.dtype == torch.int32 and out.shape == (4096,)
        idx = out.numpy()
        d_ref = np.linalg.norm(pts - verts[ref], axis=-1)
        d_out = np.linalg.norm(pts - verts[idx], axis=-1)
        np.testing.assert_allclose(d_out, d_ref, atol=1e-5)
        if case == 'duplicates':
            assert idx.max() < 1200 and ref.max() < 1200
            np.testing.assert_array_equal(idx, ref)

    def test_doubled_form_keeps_the_bits(self, rng):
        """`nn_idx_plain` (and the kernel) take |v|^2 - x.(2 v): doubling
        is exact, so every distance has the bits of |v|^2 - 2 (v.x), each
        product and sum rounded on its own in the same order, and the
        indices are the undoubled form's. Coordinates span magnitudes from
        1e-3 to 1e2, ties included."""
        from arah_tpu_torch.ops.knn import nn_idx_plain
        verts = (rng.randn(700, 3) * 10.0 ** rng.uniform(-3, 2, (700, 1))
                 ).astype(np.float32)
        verts[600:] = verts[:100]
        pts = np.concatenate([
            verts[rng.randint(0, 100, 500)],
            (rng.randn(1500, 3) * 10.0 ** rng.uniform(-3, 2, (1500, 1)))
        ]).astype(np.float32)
        p, v = t(pts), t(verts)
        v_sq = v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1] + v[:, 2] * v[:, 2]
        dot = p[:, 0:1] * v[:, 0] + p[:, 1:2] * v[:, 1] + p[:, 2:3] * v[:, 2]
        d = v_sq - 2.0 * dot
        v2 = 2.0 * v
        d2 = v_sq - (p[:, 0:1] * v2[:, 0] + p[:, 1:2] * v2[:, 1]
                     + p[:, 2:3] * v2[:, 2])
        assert torch.equal(d, d2)
        idx = nn_idx_plain(p, v, chunk=256)
        assert torch.equal(idx, torch.argmin(d, dim=-1).to(torch.int32))
        assert int(idx[:500].max()) < 600


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


def _init_close(out, ref, tol=1e-5):
    """An iso init J_inv0 (N, 16) against a reference row by row by the
    condition number of the reference's 4x4 M = inv(ref) (float64): a
    relative change d of M's entries moves the inverse by up to about
    cond(M) d, so each row's max |out - ref| / max |ref| must be at most
    tol cond(M) (float32 roundoff amplified along the SIREN's chain reads
    ~1e-6 cond here). Returns that ratio's maximum."""
    o = np_(out).reshape(-1, 16).astype(np.float64)
    r = np.asarray(ref, np.float64).reshape(-1, 16)
    assert np.isfinite(o).all() and np.isfinite(r).all()
    err = np.abs(o - r).max(-1) / np.abs(r).max(-1)
    cond = np.linalg.cond(np.linalg.inv(r.reshape(-1, 4, 4)))
    assert (err <= tol * cond).all(), (err / cond).max()
    return float((err / cond).max())


class TestIsoInit:
    """The iso init's plain version (`ops/iso_init.py`, which the wrapper
    computes for CPU tensors) against JAX's forward-mode init
    (`arah_tpu/solver/root_find.py:iso_init_inv_jacobian`, CPU JAX at
    highest) and the port's eager one, at the rays' march points of the
    `small_config` scene, with its networks or at flagship widths (the
    256 x 5 hypernet SIREN and the 128 x 4 skinning net), FiLM on or off;
    held row by row by condition number (`_init_close`)."""

    @pytest.mark.parametrize('widths', ['small', 'flagship'])
    @pytest.mark.parametrize('film', [True, False])
    def test_plain_vs_jax_and_eager(self, rng, widths, film):
        from arah_tpu.core.body import unnormalize_canonical_points
        from arah_tpu.nn.hypernet import (HypernetConfig, hypernet_cond,
                                          hypernet_generate, init_hypernet)
        from arah_tpu.nn.skinning import SkinningConfig, init_skinning
        from arah_tpu.ops.pallas.corr_kernel_t import skinning_dense_params
        from arah_tpu.render.ray_tracing import RayTracerConfig, _march_xla
        from arah_tpu.render.renderer import make_sdf_fn, make_skin_fn
        from arah_tpu.solver.root_find import iso_init_inv_jacobian as jinit
        from arah_tpu_torch.nn.skinning import SkinningConfig as PSkin
        from arah_tpu_torch.ops.iso_init import iso_init, iso_init_plain
        from arah_tpu_torch.render import renderer as prend
        from arah_tpu_torch.solver.root_find import iso_init_inv_jacobian
        from test_renderer import small_config
        from torch_port_util import port_frame
        cfg = small_config()
        params, fd, gen, cam, dirs, near, far = _march_scene(rng, cfg)
        fr = fd.frame
        c = _march_xla(RayTracerConfig(sphere_tracing_iters=12),
                       make_sdf_fn(gen), fr, fd.smpl, cam, dirs, near, far)
        x_hat = unnormalize_canonical_points(c.x_norm, fr.coord_min,
                                             fr.coord_max, fr.center)
        hcfg, scfg, skin = cfg.hypernet, cfg.skinning, params['skinning']
        if widths == 'flagship':
            hcfg, scfg = HypernetConfig(), SkinningConfig()
            skin = init_skinning(jax.random.PRNGKey(1), scfg)
        if widths == 'flagship' or not film:
            hcfg = hcfg._replace(use_film=film)
            hp = init_hypernet(jax.random.PRNGKey(2), hcfg)
            cond = hypernet_cond(
                hp, hcfg, jnp.asarray(rng.randn(1, 24, 9).astype(np.float32)),
                jnp.asarray(rng.randn(1, 24, 3).astype(np.float32)))[0]
            gen = hypernet_generate(hp, hcfg, cond, jnp.asarray(
                rng.randn(128).astype(np.float32)) if film else None)
        assert (len(gen.freqs) > 0) == film
        skin_fn = make_skin_fn({'skinning': skin},
                               type('C', (), {'skinning': scfg}))
        ref = jinit(make_sdf_fn(gen), skin_fn, fr, dirs, x_hat)
        wts, bs = skinning_dense_params(skin, scfg)
        args = (t(x_hat), t(dirs), [t(w) for w in wts], [t(b) for b in bs],
                port_frame(fr), port_gen(gen), scfg.softmax_scale)
        out = iso_init(*args)
        n = dirs.shape[0]
        assert tuple(out.shape) == (n, 16)
        assert torch.equal(out, iso_init_plain(*args))
        _init_close(out, ref)
        pskin = {'skinning': jax.tree.map(t, skin)}
        eager = iso_init_inv_jacobian(
            prend.make_sdf_fn(args[5]),
            prend.make_skin_fn(pskin, type('C', (), {
                'skinning': PSkin(**scfg._asdict())})), args[4], args[1],
            args[0])
        _init_close(out, eager.reshape(n, 16))

    def test_shape_check(self, rng):
        """The kernel's shape check: G's limits on the skinning MLP (3 ->
        hidden widths of at most 128 -> 25, at most 8 layers) and E's and
        F's on the SIREN."""
        from arah_tpu_torch.nn.siren import GeneratedMLP
        from arah_tpu_torch.ops.iso_init import check_iso_init
        gen = port_gen(_small_gen(rng, True))

        def mlp(dims):
            return [torch.zeros((o, i)) for i, o in zip(dims[:-1], dims[1:])]
        check_iso_init(gen, mlp([3, 128, 128, 128, 25]))
        check_iso_init(gen, mlp([3, 25]))
        for dims in ([3, 256, 25], [3, 64, 129, 25], [3, 64, 24],
                     [4, 64, 25], [3] + [8] * 8 + [25]):
            with pytest.raises(ValueError, match='skinning MLP'):
                check_iso_init(gen, mlp(dims))
        wide = GeneratedMLP(tuple(torch.zeros(s) for s in
                                  ((260, 3), (260, 260), (1, 260))),
                            gen.biases, gen.freqs, gen.phases)
        with pytest.raises(ValueError, match='SIREN'):
            check_iso_init(wide, mlp([3, 64, 25]))


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
        """The corr kernels' pack (B and L, `pack_corr`) of a dense
        skinning MLP is the skinning part of the tracer's `pack_trace` for
        the same weights: per layer the (in, pad32(out)) transposed weights
        and the bias padded to pad32(out), zeros in the padding, every
        block at a multiple of 4 floats, the same widths, and no SIREN
        (the kernel runs the skinning layers only). Kernel L's pack of the
        (in, out) weights (`corr_search_rows` packs their transposes) is
        the same buffer with the same NetMeta bytes, so B and L launch one
        kernel on the same operands."""
        from arah_tpu_torch.ops.corr import pack_corr
        from arah_tpu_torch.ops.march import pack_trace
        dims = (3, 128, 128, 128, 25)
        dense = [t(rng.randn(o, i).astype(np.float32) / np.sqrt(i))
                 for i, o in zip(dims[:-1], dims[1:])]
        biases = [t(rng.randn(o).astype(np.float32) * 0.1) for o in dims[1:]]
        params, meta = pack_corr(dense, biases)
        tp, tm = pack_trace(port_gen(_small_gen(rng, True)), dense, biases)
        assert meta.n_layers == 0 and meta.n_skin == tm.n_skin == 4
        assert list(meta.skin_dims)[:5] == list(tm.skin_dims)[:5] \
            == list(dims)
        seen = 0
        for l, (w, b) in enumerate(zip(dense, biases)):
            o, i = w.shape
            op = -(-o // 32) * 32
            for off, size in ((meta.skin_wt_off[l], i * op),
                              (meta.skin_b_off[l], op)):
                assert off % 4 == 0
                seen += size
            wo, bo = meta.skin_wt_off[l], meta.skin_b_off[l]
            two, tbo = tm.skin_wt_off[l], tm.skin_b_off[l]
            assert two % 4 == 0 and tbo % 4 == 0
            blk = params[wo:wo + i * op]
            assert torch.equal(blk, tp[two:two + i * op])
            blk = blk.reshape(i, op)
            assert torch.equal(blk[:, :o], w.T)
            assert not bool(blk[:, o:].any())
            assert torch.equal(params[bo:bo + op], tp[tbo:tbo + op])
            assert torch.equal(params[bo:bo + o], b)
            assert not bool(params[bo + o:bo + op].any())
        assert seen == params.numel()
        pl, ml = pack_corr([w.T.contiguous().T for w in dense], biases)
        assert torch.equal(params, pl)
        assert bytes(meta) == bytes(ml)

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


    def test_color_bf16_pack_round_trips(self, rng):
        """Kernel I's bf16 pack (flagship layout at a narrow width): at
        each block's wf_off, the x, small or feats part of a hidden layer,
        (out, width) rounded to bf16 as the plain version rounds it, with
        its width zero-padded to a multiple of 32 (small: 33 -> 64); at
        wb_off its transpose; no block for the pose parts or the last
        layer; the blocks tile the pack."""
        from arah_tpu_torch.ops.color import _pack, _parts, pack_color_bf16
        S, F, Pw, H = 33, 64, 128, 64
        d0 = S + F + Pw
        dims = [(d0, H), (H, H), (H, H // 2), (d0 + H // 2, H), (H, H),
                (H, 3)]
        ws = [t(rng.randn(o, i).astype(np.float32)) for i, o in dims]
        bs = [t(rng.randn(o).astype(np.float32)) for _, o in dims]
        pack = pack_color_bf16(ws, S, F, Pw, (3,))
        _, meta, _ = _pack(ws, bs, S, F, Pw, (3,), True, True, False)
        assert pack.dtype == torch.bfloat16
        L, seen = len(ws), 0
        for l, comps in enumerate(_parts(ws, S, F, Pw, (3,))):
            for c, (name, st, wd) in enumerate(comps):
                if name == 'pose' or l == L - 1:
                    assert meta.wf_off[l][c] == meta.wb_off[l][c] == 0
                    continue
                o, kp = ws[l].shape[0], -(-wd // 32) * 32
                f = pack[meta.wf_off[l][c]:meta.wf_off[l][c] + o * kp]
                b = pack[meta.wb_off[l][c]:meta.wb_off[l][c] + o * kp]
                f, b = f.reshape(o, kp), b.reshape(kp, o)
                assert torch.equal(f[:, :wd].float(),
                                   ws[l][:, st:st + wd].bfloat16().float())
                assert not bool(f[:, wd:].float().any())
                assert torch.equal(b, f.T)
                seen += 2 * o * kp
        assert seen == pack.numel() and seen > 0


    @pytest.mark.parametrize('bf16,feats_bf16', [(True, True),
                                                 (True, False),
                                                 (False, False)])
    def test_color_fwd_operands_walk_to_plain(self, rng, bf16, feats_bf16):
        """Kernel D's operands (flagship layout at a narrow width; the
        eval layout has bf16 features, training f32): under bf16 each
        hidden part's block at wf_off is that part of the weights rounded
        to bf16 as `color_mlp_plain` rounds them, its width zero-padded to
        a multiple of 32; and the forward walked as D's launch reads its
        operands (bias, then the parts in order, each from its block, the
        pose part and the last layer from the f32 buffer, small rows
        zero-padded) gives `color_mlp_plain`'s rgb, up to reassociation
        (a hidden value may round to the other bf16 neighbour: 1e-4)."""
        from arah_tpu_torch.ops.color import (_pack, _pad32, _parts,
                                              color_mlp_plain,
                                              pack_color_bf16)
        S, F, Pw, H, n = 33, 64, 128, 64, 200
        d0 = S + F + Pw
        dims = [(d0, H), (H, H), (H, H // 2), (d0 + H // 2, H), (H, H),
                (H, 3)]
        ws = [t(rng.randn(o, i).astype(np.float32) / np.sqrt(i))
              for i, o in dims]
        bs = [t(rng.randn(o).astype(np.float32) * 0.1) for _, o in dims]
        small = t(rng.randn(n, S).astype(np.float32))
        feats = t(rng.uniform(-1, 1, (n, F)).astype(np.float32))
        if feats_bf16:
            feats = feats.bfloat16()
        pose = t(rng.randn(1, Pw).astype(np.float32))
        params, meta, _ = _pack(ws, bs, S, F, Pw, (3,), True, bf16,
                                feats_bf16)
        wbf = pack_color_bf16(ws, S, F, Pw, (3,)) if bf16 else None
        assert meta.bf16 == int(bf16) and meta.feats_bf16 == int(feats_bf16)
        r = (lambda a: a.bfloat16().float()) if bf16 else (lambda a: a)
        rows = {1: torch.nn.functional.pad(r(small), (0, _pad32(S) - S)),
                2: r(feats.float())}
        ps = r(pose)
        L, x = len(ws), None
        for l, comps in enumerate(_parts(ws, S, F, Pw, (3,))):
            out = meta.out[l]
            z = params[meta.b_off[l]:meta.b_off[l] + out].expand(n, out)
            for c, (name, st, wd) in enumerate(comps):
                assert meta.kind[l][c] == {'x': 0, 'small': 1, 'feats': 2,
                                           'pose': 3}[name]
                if bf16 and name != 'pose' and l < L - 1:
                    kp = _pad32(wd)
                    blk = wbf[meta.wf_off[l][c]:meta.wf_off[l][c] + out * kp]
                    blk = blk.reshape(out, kp).float()
                    assert torch.equal(
                        blk[:, :wd], ws[l][:, st:st + wd].bfloat16().float())
                    assert not bool(blk[:, wd:].any())
                    a = x if name == 'x' else rows[meta.kind[l][c]]
                    z = z + a[:, :kp] @ blk.T
                    continue
                wt = params[meta.w_off[l][c]:meta.w_off[l][c] + wd * out]
                assert torch.equal(wt.reshape(wd, out),
                                   r(ws[l][:, st:st + wd]).T)
                a = ps if name == 'pose' else (
                    x if name == 'x' else rows[meta.kind[l][c]][:, :wd])
                z = z + a @ wt.reshape(wd, out)
            if l < L - 1:
                x = r(torch.relu(z))
        walked = torch.sigmoid(z)
        ref = color_mlp_plain(ws, bs, small, feats, pose, (3,), bf16=bf16)
        assert float((walked - ref).abs().max()) < 1e-4

    @pytest.mark.parametrize('dims', [(3, 128, 128, 128, 128, 25),
                                      (3, 100, 100, 25)])
    def test_skin_jac_pack_pads_with_zeros(self, rng, dims):
        """Kernel G's pack: per layer the (in, out) transposed weights and
        the bias with out zero-padded to a multiple of 32 (the 25 logits
        -> 32, a 100-wide hidden layer -> 128), exact zeros in the padding,
        every block at a multiple of 4 floats (16-byte copies), and the
        NetMeta of the true widths."""
        from arah_tpu_torch.ops.skin_jac import pack_skin_jac
        ws = [t(rng.randn(o, i).astype(np.float32))
              for i, o in zip(dims[:-1], dims[1:])]
        bs = [t(rng.randn(o).astype(np.float32)) for o in dims[1:]]
        params, meta = pack_skin_jac(ws, bs)
        assert meta.n_skin == len(ws)
        assert list(meta.skin_dims)[:len(dims)] == list(dims)
        for l, (w, b) in enumerate(zip(ws, bs)):
            o, i = w.shape
            op = -(-o // 32) * 32
            wo, bo = meta.skin_wt_off[l], meta.skin_b_off[l]
            assert wo % 4 == 0 and bo % 4 == 0
            blk = params[wo:wo + i * op].reshape(i, op)
            assert torch.equal(blk[:, :o], w.T)
            assert not bool(blk[:, o:].any())
            assert torch.equal(params[bo:bo + o], b)
            assert not bool(params[bo + o:bo + op].any())


    @pytest.mark.parametrize('film', [True, False])
    @pytest.mark.parametrize('dims', [(3, 128, 128, 128, 25),
                                      (3, 100, 25)])
    def test_trace_pack_round_trips(self, rng, film, dims):
        """Kernels E and F's one pack (`pack_trace`): every block starts
        at a multiple of 4 floats (16-byte copies into the shared-memory
        ring); the SIREN's hidden layers as (in, hidden) transposed copies,
        its output rows, biases and FiLM rows round-trip to the generated
        SIREN; each skinning layer is its (in, pad32(out)) transposed
        weights and its bias padded to pad32(out), zeros in the padding
        (the 25 logits -> 32, a 100-wide layer -> 128); every float of the
        pack outside those blocks is zero; E's pack (no skinning MLP) is
        the prefix of F's with the same SIREN fields."""
        from arah_tpu_torch.ops.march import pack_trace
        gen = port_gen(_small_gen(rng, film))
        ws = [t(rng.randn(o, i).astype(np.float32))
              for i, o in zip(dims[:-1], dims[1:])]
        bs = [t(rng.randn(o).astype(np.float32)) for o in dims[1:]]
        params, meta = pack_trace(gen, ws, bs)
        L, H = len(gen.weights), gen.weights[0].shape[0]
        assert (meta.n_layers, meta.hidden, meta.film) == (L, H, int(film))
        seen = torch.zeros(params.numel(), dtype=torch.bool)

        def block(off, n):
            assert off % 4 == 0
            assert not bool(seen[off:off + n].any())
            seen[off:off + n] = True
            return params[off:off + n]
        for i in range(L - 1):
            w = gen.weights[i]
            assert torch.equal(block(meta.wt_off[i], w.numel())
                               .reshape(w.shape[1], w.shape[0]), w.T)
            assert torch.equal(block(meta.b_off[i], H), gen.biases[i])
        wl = gen.weights[-1]
        assert torch.equal(block(meta.wl_off, wl.numel()).reshape(wl.shape),
                           wl)
        assert torch.equal(block(meta.b_off[L - 1], wl.shape[0]),
                           gen.biases[-1])
        if film:
            for off, rows in ((meta.freq_off, gen.freqs),
                              (meta.phase_off, gen.phases)):
                assert torch.equal(block(off, (L - 1) * H).reshape(L - 1, H),
                                   torch.stack(rows))
        assert meta.n_skin == len(ws)
        assert list(meta.skin_dims)[:len(dims)] == list(dims)
        for l, (w, b) in enumerate(zip(ws, bs)):
            o, i = w.shape
            op = -(-o // 32) * 32
            blk = block(meta.skin_wt_off[l], i * op).reshape(i, op)
            assert torch.equal(blk[:, :o], w.T)
            assert not bool(blk[:, o:].any())
            bb = block(meta.skin_b_off[l], op)
            assert torch.equal(bb[:o], b) and not bool(bb[o:].any())
        assert not bool(params[~seen].any())
        e_params, e_meta = pack_trace(gen)
        assert torch.equal(params[:e_params.numel()], e_params)
        assert e_meta.n_skin == 0
        for f in ('n_layers', 'hidden', 'film', 'wl_off', 'freq_off',
                  'phase_off'):
            assert getattr(e_meta, f) == getattr(meta, f), f
        assert list(e_meta.wt_off) == list(meta.wt_off)
        assert list(e_meta.b_off) == list(meta.b_off)


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
