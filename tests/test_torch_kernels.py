"""The plain PyTorch versions of kernels A-D against their Pallas
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
  * D (color): a ReLU MLP, f32 at 1e-5; bf16 by median 1e-4 / p99 2e-2.
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
