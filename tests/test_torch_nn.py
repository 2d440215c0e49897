"""arah_tpu_torch networks, solvers and compositing against arah_tpu on
the CPU, with the JAX parameters moved across by
`convert.params_from_jax`.

Tolerances: plain f32 layers 1e-5 absolute. The generated SIREN is a
sin(30 x) chain, which amplifies torch-vs-XLA reassociation ~30x per
layer, so SIREN outputs get 1e-4 at these narrow widths. Under bf16 an
operand that sits on a bf16 rounding boundary can round the other way on
one side, so bf16 outputs are held by median (1e-4) and p99 (2e-2)
rather than by max. Broyden may send a hard point to another, equally
valid root, so the solvers are held by valid-mask agreement and the
median |dx| on commonly-valid points.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_port_util import np_, port_gen, port_params, t

torch.set_num_threads(2)


def _robust(a, b, med=1e-4, p99=2e-2):
    d = np.abs(np_(a) - np.asarray(b, np.float32))
    assert np.median(d) < med, np.median(d)
    assert np.quantile(d, 0.99) < p99, np.quantile(d, 0.99)


def _gen(rng, cfg, key=0):
    from arah_tpu.nn.hypernet import (hypernet_cond, hypernet_generate,
                                      init_hypernet)
    params = init_hypernet(jax.random.PRNGKey(key), cfg)
    rots = rng.randn(1, 24, 9).astype(np.float32)
    jtrs = rng.randn(1, 24, 3).astype(np.float32)
    latent = rng.randn(cfg.latent_dim).astype(np.float32)
    cond = hypernet_cond(params, cfg, jnp.asarray(rots), jnp.asarray(jtrs))
    gen = hypernet_generate(params, cfg, cond[0], jnp.asarray(latent)
                            if cfg.use_film else None)
    return params, (rots, jtrs, latent), cond, gen


class TestLayers:
    def test_linear_wn_mm_t(self, rng):
        from arah_tpu.nn import layers as J
        from arah_tpu_torch.nn import layers as P
        lin = J.init_wn_linear(jax.random.PRNGKey(0), 40, 24)
        x = rng.randn(30, 40).astype(np.float32)
        pl = port_params(lin)
        for bf in (False, True):
            np.testing.assert_allclose(
                np_(P.wn_linear(pl, t(x), bf)),
                np.asarray(J.wn_linear(lin, jnp.asarray(x), bf)),
                atol=1e-5 if not bf else 1e-4)
        plain = {'w': lin['v'], 'b': lin['b']}
        np.testing.assert_allclose(
            np_(P.linear(port_params(plain), t(x))),
            np.asarray(J.linear(plain, jnp.asarray(x))), atol=1e-5)
        z = (rng.randn(500) * 0.3).astype(np.float32)
        np.testing.assert_allclose(np_(P.softplus100(t(z))),
                                   np.asarray(J.softplus100(jnp.asarray(z))),
                                   atol=1e-6)


class TestHypernetSiren:
    def test_generate_and_apply(self, rng):
        from arah_tpu.nn.hypernet import HypernetConfig
        from arah_tpu.nn.siren import siren_apply as J
        from arah_tpu_torch.nn.hypernet import (hypernet_cond,
                                                hypernet_generate)
        from arah_tpu_torch.nn.siren import siren_apply as P
        cfg = HypernetConfig(hidden_features=64, num_hidden_layers=2,
                             hyper_hidden_ch=64)
        params, (rots, jtrs, latent), cond, gen = _gen(rng, cfg)
        pp = port_params(params)
        from arah_tpu_torch.nn.hypernet import HypernetConfig as PC
        pcfg = PC(**cfg._asdict())
        cond_p = hypernet_cond(pp, pcfg, t(rots), t(jtrs))
        np.testing.assert_allclose(np_(cond_p), np.asarray(cond), atol=1e-5)
        gen_p = hypernet_generate(pp, pcfg, cond_p[0], t(latent))
        for a, b in zip(jax.tree.leaves(gen_p), jax.tree.leaves(gen)):
            np.testing.assert_allclose(np_(a), np.asarray(b), atol=1e-4)
        x = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
        gp = port_gen(gen)
        out, feat = P(gp, t(x), return_features=True)
        ro, rf = J(gen, jnp.asarray(x), return_features=True)
        np.testing.assert_allclose(np_(out), np.asarray(ro), atol=1e-4)
        np.testing.assert_allclose(np_(feat), np.asarray(rf), atol=1e-4)
        out, feat = P(gp, t(x), return_features=True, bf16=True)
        ro, rf = J(gen, jnp.asarray(x), return_features=True, bf16=True)
        assert feat.dtype == torch.bfloat16
        _robust(out, ro)
        _robust(feat, np.asarray(rf.astype(jnp.float32)))


class TestSkinningColor:
    def test_skinning_weights(self, rng):
        from arah_tpu.nn.skinning import (SkinningConfig, init_skinning,
                                          skinning_weights as J)
        from arah_tpu_torch.nn.skinning import (SkinningConfig as PC,
                                                skinning_weights as P)
        cfg = SkinningConfig(d_hidden=64, n_layers=3)
        params = init_skinning(jax.random.PRNGKey(1), cfg)
        x = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
        np.testing.assert_allclose(
            np_(P(port_params(params), PC(**cfg._asdict()), t(x))),
            np.asarray(J(params, cfg, jnp.asarray(x))), atol=1e-5)

    @pytest.mark.parametrize('bf16', [False, True])
    @pytest.mark.parametrize('use_pallas', [False, True])
    def test_color_apply(self, rng, bf16, use_pallas):
        """use_pallas=True on a CPU tensor takes kernel D's plain version
        (the concat path), like the JAX XLA path it is held against."""
        from arah_tpu.nn.color import ColorConfig, color_apply as J, init_color
        from arah_tpu_torch.nn.color import (ColorConfig as PC,
                                             color_apply as P)
        cfg = ColorConfig(d_feature=64 + 32, d_hidden=64, n_layers=4,
                          skips=(2,), use_pallas=False)
        params = init_color(jax.random.PRNGKey(2), cfg)
        n = 150
        a = [rng.randn(n, 3).astype(np.float32) for _ in range(3)]
        feats = rng.uniform(-1, 1, (n, 64)).astype(np.float32)
        pose = rng.randn(1, 32).astype(np.float32)
        ref = J(params, cfg, *map(jnp.asarray, a), jnp.asarray(feats),
                jnp.asarray(pose), bf16=bf16)
        pcfg = PC(**cfg._replace(use_pallas=use_pallas)._asdict())
        out = P(port_params(params), pcfg, *map(t, a), t(feats), t(pose),
                bf16=bf16)
        if bf16:
            _robust(out, ref)
        else:
            np.testing.assert_allclose(np_(out), np.asarray(ref), atol=1e-5)

    def test_pose_feature_and_widths(self, rng):
        from arah_tpu.nn import color as J
        from arah_tpu_torch.nn import color as P
        pc = {'rots_full': rng.randn(1, 24, 9).astype(np.float32),
              'Jtrs_posed': rng.randn(1, 24, 3).astype(np.float32),
              'latent_code': rng.randn(1, 128).astype(np.float32)}
        for enc in ('latent', 'root', 'hybrid', None):
            cj = J.ColorConfig(pose_encoder=enc)
            cp = P.ColorConfig(pose_encoder=enc)
            a = J.color_pose_feature({}, cj, {k: jnp.asarray(v)
                                              for k, v in pc.items()})
            b = P.color_pose_feature({}, cp, {k: t(v)
                                              for k, v in pc.items()})
            if a is None:
                assert b is None
            else:
                np.testing.assert_allclose(np_(b), np.asarray(a), atol=0)
            assert P.feature_width(enc) == J.feature_width(enc)


class TestModelParams:
    def test_tree_shapes_and_laws(self):
        """Same tree, keys and shapes as the JAX init; same init laws
        (zero-init hyper last layers, identity FiLM bias, weight-norm g
        = ||v||)."""
        from arah_tpu.model import init_model_params as J
        from arah_tpu_torch.model import init_model_params as P
        from test_renderer import small_config
        from torch_port_util import port_cfg
        cfg = small_config()
        a = J(jax.random.PRNGKey(0), cfg, n_latent_frames=3, n_cameras=2)
        b = P(torch.Generator().manual_seed(0), port_cfg(cfg),
              n_latent_frames=3, n_cameras=2, device='cpu')
        pa = jax.tree_util.tree_flatten_with_path(a)[0]
        pb = jax.tree_util.tree_flatten_with_path(b)[0]
        assert [jax.tree_util.keystr(k) for k, _ in pa] == \
            [jax.tree_util.keystr(k) for k, _ in pb]
        for (k, x), (_, y) in zip(pa, pb):
            assert tuple(x.shape) == tuple(y.shape), jax.tree_util.keystr(k)
        for blk in b['hypernet']['hyper_layers']:
            assert float(blk['last']['w'].abs().max()) == 0.0
        fb = b['hypernet']['mapping']['last']['b']
        h = fb.shape[0] // 2
        assert bool((fb[:h] == 1).all()) and bool((fb[h:] == 0).all())
        for lyr in b['color']['layers'] + b['skinning']['layers']:
            np.testing.assert_allclose(
                np_(lyr['g'][:, 0]), np_(torch.linalg.norm(lyr['v'], dim=1)),
                rtol=1e-6)


class TestVolsdf:
    def test_density_and_composite(self, rng):
        from arah_tpu.render import volsdf as J
        from arah_tpu_torch.render import volsdf as P
        sdf = (rng.randn(8, 20) * 0.01).astype(np.float32)
        beta = np.float32(0.003)
        np.testing.assert_allclose(
            np_(P.volsdf_density(t(sdf), t(beta))),
            np.asarray(J.volsdf_density(jnp.asarray(sdf), jnp.asarray(beta))),
            rtol=1e-5, atol=1e-3)
        rgb = rng.rand(8, 20, 3).astype(np.float32)
        dens = rng.rand(8, 20).astype(np.float32) * 50
        z = np.sort(rng.rand(8, 20).astype(np.float32), axis=1)
        mask = rng.rand(8, 20) > 0.3
        mask[0] = False
        for last in (False, True):
            ref = J.composite_masked(*map(jnp.asarray, (rgb, dens, z, mask)),
                                     n_steps=64, render_last_pt=last)
            out = P.composite_masked(t(rgb), t(dens), t(z),
                                     torch.as_tensor(mask), n_steps=64,
                                     render_last_pt=last)
            for a, b in zip(out, ref):
                np.testing.assert_allclose(np_(a), np.asarray(b), atol=1e-5)


def _frame(rng):
    from arah_tpu.core.smpl import batch_rodrigues
    from arah_tpu.render.ray_tracing import CanonicalFrame
    aa = (rng.randn(24, 3) * 0.15).astype(np.float32)
    tfs = np.tile(np.eye(4, dtype=np.float32), (24, 1, 1))
    tfs[:, :3, :3] = np.asarray(batch_rodrigues(jnp.asarray(aa)))
    tfs[:, :3, 3] = (rng.randn(24, 3) * 0.05).astype(np.float32)
    return CanonicalFrame(
        bone_transforms=jnp.asarray(tfs), trans=jnp.zeros(3),
        coord_min=jnp.float32(-1.1), coord_max=jnp.float32(1.0),
        center=jnp.asarray(rng.randn(3).astype(np.float32) * 0.05))


class TestSolvers:
    def test_search_canonical_corr(self, rng):
        from arah_tpu.nn.skinning import SkinningConfig, init_skinning
        from arah_tpu.render.renderer import make_skin_fn
        from arah_tpu.core.body import normalize_canonical_points
        from arah_tpu.solver.root_find import (forward_skinning,
                                               search_canonical_corr as J)
        from arah_tpu_torch.nn.skinning import (SkinningConfig as PC,
                                                skinning_weights)
        from arah_tpu_torch.solver.root_find import search_canonical_corr as P
        from torch_port_util import port_frame
        cfg = SkinningConfig(d_hidden=64, n_layers=3)
        params = init_skinning(jax.random.PRNGKey(0), cfg)
        frame = _frame(rng)
        skin_fn = make_skin_fn({'skinning': params},
                               type('C', (), {'skinning': cfg}))
        n = 256
        x_gt = jnp.asarray(rng.randn(n, 3).astype(np.float32) * 0.3)
        x_bar, _ = forward_skinning(skin_fn, frame, x_gt)
        x0 = x_gt + 0.03 * jnp.asarray(rng.randn(n, 3).astype(np.float32))
        w0 = skin_fn(normalize_canonical_points(
            x0, frame.coord_min, frame.coord_max, frame.center))
        T0 = jnp.einsum('nj,jab->nab', w0, frame.bone_transforms)
        mask = rng.rand(n) > 0.1
        ref = J(skin_fn, frame, x_bar, x0, T0, active_init=jnp.asarray(mask))
        pp, pc = port_params(params), PC(**cfg._asdict())
        out = P(lambda x: skinning_weights(pp, pc, x), port_frame(frame),
                t(x_bar), t(x0), t(T0), active_init=torch.as_tensor(mask))
        v_ref, v_out = np.asarray(ref.valid), out.valid.numpy()
        assert (v_ref == v_out).mean() > 0.98
        both = v_ref & v_out
        assert both.mean() > 0.8
        d = np.linalg.norm(np_(out.x_hat) - np.asarray(ref.x_hat), axis=-1)
        assert np.median(d[both]) < 1e-5
        np.testing.assert_array_equal(np_(out.x_hat)[~mask], np.asarray(x0)
                                      [~mask])

    def test_search_iso_surface_depth(self, rng):
        """Joint (x_hat, z) solve on rays that cross a known surface (a
        sphere of radius 0.3 in normalized canonical space, each ray
        through one of its points at depth 2, started 1 cm off), held
        against the JAX solver: converged agreement and median |dz| on
        the rays both sides solve. The init Jacobian's forward-mode
        tangents are held separately through a generated SIREN."""
        from arah_tpu.core.body import unnormalize_canonical_points
        from arah_tpu.nn.hypernet import HypernetConfig
        from arah_tpu.nn.skinning import SkinningConfig, init_skinning
        from arah_tpu.nn.siren import siren_apply
        from arah_tpu.render.renderer import make_skin_fn
        from arah_tpu.solver.root_find import (forward_skinning,
                                               iso_init_inv_jacobian as JJ,
                                               search_iso_surface_depth as J)
        from arah_tpu_torch.nn.siren import siren_apply as psiren
        from arah_tpu_torch.nn.skinning import (SkinningConfig as PC,
                                                skinning_weights)
        from arah_tpu_torch.solver.root_find import (
            iso_init_inv_jacobian as PJ, search_iso_surface_depth as P)
        from torch_port_util import port_frame
        cfg = SkinningConfig(d_hidden=32, n_layers=2)
        params = init_skinning(jax.random.PRNGKey(4), cfg)
        frame = _frame(rng)
        skin_fn = make_skin_fn({'skinning': params},
                               type('C', (), {'skinning': cfg}))
        pp, pc = port_params(params), PC(**cfg._asdict())
        pskin = lambda x: skinning_weights(pp, pc, x)      # noqa: E731
        n = 128
        u = rng.randn(n, 3).astype(np.float32)
        u /= np.linalg.norm(u, axis=-1, keepdims=True)
        x_s = unnormalize_canonical_points(
            jnp.asarray(0.3 * u), frame.coord_min, frame.coord_max,
            frame.center)
        xb, _ = forward_skinning(skin_fn, frame, x_s)
        dirs = rng.randn(n, 3).astype(np.float32)
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        cam = np.asarray(xb) - 2.0 * dirs
        x_hat0 = x_s + 0.01 * jnp.asarray(rng.randn(n, 3).astype(np.float32))
        z0 = (2.0 + 0.01 * rng.randn(n)).astype(np.float32)
        _, T0 = forward_skinning(skin_fn, frame, x_hat0)
        valid = rng.rand(n) > 0.1
        args = (jnp.asarray(cam), jnp.asarray(dirs), jnp.asarray(valid),
                x_hat0, jnp.asarray(z0), T0)
        ref = J(lambda x: jnp.linalg.norm(x, axis=-1) - 0.3, skin_fn, frame,
                *args, max_steps=20)
        out = P(lambda x: torch.linalg.norm(x, dim=-1) - 0.3, pskin,
                port_frame(frame), t(cam), t(dirs), torch.as_tensor(valid),
                t(x_hat0), t(z0), t(T0), max_steps=20)
        c_ref, c_out = np.asarray(ref.converged), out.converged.numpy()
        assert (c_ref == c_out).mean() > 0.95
        both = c_ref & c_out
        assert both.mean() > 0.5, both.mean()
        dz = np.abs(np_(out.z_depth) - np.asarray(ref.z_depth))[both]
        assert np.median(dz) < 1e-5, np.median(dz)

        # init inverse Jacobian through a generated SIREN (30x sine chain:
        # held by median and p99 relative to the entries' scale)
        hcfg = HypernetConfig(hidden_features=32, num_hidden_layers=2,
                              hyper_hidden_ch=32)
        _, _, _, gen = _gen(rng, hcfg, key=3)
        gp = port_gen(gen)
        ji_ref = np.asarray(JJ(lambda x: siren_apply(gen, x)[..., 0],
                               skin_fn, frame, jnp.asarray(dirs), x_hat0))
        ji_out = np_(PJ(lambda x: psiren(gp, x)[..., 0], pskin,
                        port_frame(frame), t(dirs), t(x_hat0)))
        rel = np.abs(ji_out - ji_ref) / (np.abs(ji_ref).max(axis=(1, 2),
                                                            keepdims=True))
        assert np.median(rel) < 1e-5 and np.quantile(rel, 0.99) < 1e-3, \
            (np.median(rel), np.quantile(rel, 0.99))
