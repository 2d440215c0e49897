"""arah_tpu_torch core modules against arah_tpu on the CPU: linalg, body
math, positional encoding, ray/box, SMPL, the synthetic body, frame
preparation and configuration parity; plus the port's import hygiene,
its device rule and its straggler write-back.

Tolerances: these are short f32 chains (a handful of adds and products
per output), so 1e-5 absolute (1e-4 where a 4x4 cofactor inverse or the
24-joint kinematic chain compounds rounding) bounds torch-vs-XLA
reassociation with room to spare; integer/bool outputs must be equal.
"""
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_port_util import np_, port_cfg, t

torch.set_num_threads(2)


def _mats(rng, n, k):
    return (np.eye(k) + 0.3 * rng.randn(n, k, k)).astype(np.float32)


class TestLinalg:
    @pytest.mark.parametrize('name', ['inv3x3', 'inv_affine', 'inv4x4'])
    def test_vs_jax(self, rng, name):
        from arah_tpu.core import linalg as J
        from arah_tpu_torch.core import linalg as P
        m = _mats(rng, 64, 3 if name == 'inv3x3' else 4)
        if name == 'inv_affine':
            m[:, 3] = [0, 0, 0, 1]
        ref = np.asarray(getattr(J, name)(jnp.asarray(m)))
        out = np_(getattr(P, name)(t(m)))
        np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


class TestBody:
    def test_skinning_and_normalization(self, rng):
        from arah_tpu.core import body as J
        from arah_tpu_torch.core import body as P
        x = rng.randn(50, 3).astype(np.float32)
        w = rng.dirichlet(np.ones(24), 50).astype(np.float32)
        tfs = _mats(rng, 24, 4)
        tfs[:, 3] = [0, 0, 0, 1]
        for inverse in (False, True):
            ref = J.skinning(jnp.asarray(x), jnp.asarray(w),
                             jnp.asarray(tfs), inverse=inverse)
            out = P.skinning(t(x), t(w), t(tfs), inverse=inverse)
            for a, b in zip(out, ref):
                np.testing.assert_allclose(np_(a), np.asarray(b), atol=1e-4)
        args = (np.float32(-0.9), np.float32(1.1),
                rng.randn(3).astype(np.float32))
        for fn in ('normalize_canonical_points',
                   'unnormalize_canonical_points'):
            ref = getattr(J, fn)(jnp.asarray(x), *map(jnp.asarray, args))
            out = getattr(P, fn)(t(x), *map(t, args))
            np.testing.assert_allclose(np_(out), np.asarray(ref), atol=1e-5)
        np.testing.assert_allclose(
            np_(P.sdf_to_metric(t(x), *map(t, args[:2]))),
            np.asarray(J.sdf_to_metric(jnp.asarray(x),
                                       *map(jnp.asarray, args[:2]))),
            atol=1e-6)

    def test_hierarchical_softmax(self, rng):
        from arah_tpu.core.body import hierarchical_softmax as J
        from arah_tpu_torch.core.body import hierarchical_softmax as P
        logits = (rng.randn(200, 25) * 5).astype(np.float32)
        ref = np.asarray(J(jnp.asarray(logits)))
        out = np_(P(t(logits)))
        np.testing.assert_allclose(out, ref, atol=1e-6)
        np.testing.assert_allclose(out.sum(-1), 1.0, atol=1e-5)

    def test_02v_transforms(self, rng):
        from arah_tpu.core.body import get_02v_bone_transforms_jnp as J
        from arah_tpu_torch.core.body import get_02v_bone_transforms_jnp as P
        jtr = rng.randn(24, 3).astype(np.float32) * 0.5
        np.testing.assert_allclose(np_(P(t(jtr))),
                                   np.asarray(J(jnp.asarray(jtr))),
                                   atol=1e-5)


class TestEmbedderRays:
    @pytest.mark.parametrize('multires', [0, 4, 6])
    def test_positional_encoding(self, rng, multires):
        from arah_tpu.core.embedder import positional_encoding as J
        from arah_tpu_torch.core.embedder import positional_encoding as P
        x = rng.randn(40, 3).astype(np.float32)
        ref = np.asarray(J(jnp.asarray(x), multires))
        out = np_(P(t(x), multires))
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, atol=1e-5)

    def test_ray_aabb(self, rng):
        from arah_tpu.core.rays import ray_aabb as J
        from arah_tpu_torch.core.rays import ray_aabb as P
        bmin = np.asarray([-0.5, -1.0, -0.3], np.float32)
        bmax = np.asarray([0.6, 0.9, 0.4], np.float32)
        o = np.tile(np.asarray([[0.0, 0.3, -2.5]], np.float32), (64, 1))
        d = rng.randn(64, 3).astype(np.float32)
        d[:4, 0] = 0.0                              # exercise the eps clamps
        d[:, 2] = np.abs(d[:, 2]) + 0.5
        ref = J(*(jnp.asarray(a) for a in (bmin, bmax, o, d)))
        out = P(*(t(a) for a in (bmin, bmax, o, d)))
        np.testing.assert_allclose(np_(out[0]), np.asarray(ref[0]), atol=1e-4)
        np.testing.assert_allclose(np_(out[1]), np.asarray(ref[1]), atol=1e-4)
        np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))


class TestSmpl:
    def test_lbs_building_blocks(self, rng):
        from arah_tpu.core import smpl as J
        from arah_tpu_torch.core import smpl as P
        aa = (rng.randn(24, 3) * 0.4).astype(np.float32)
        R_ref = np.asarray(J.batch_rodrigues(jnp.asarray(aa)))
        R = P.batch_rodrigues(t(aa))
        np.testing.assert_allclose(np_(R), R_ref, atol=1e-5)
        joints = rng.randn(1, 24, 3).astype(np.float32) * 0.3
        ref = J.batch_rigid_transform(jnp.asarray(R_ref[None]),
                                      jnp.asarray(joints), J.SMPL_PARENTS)
        out = P.batch_rigid_transform(t(R_ref[None]), t(joints),
                                      P.SMPL_PARENTS)
        for a, b in zip(out, ref):
            np.testing.assert_allclose(np_(a), np.asarray(b), atol=1e-4)
        betas = rng.randn(1, 10).astype(np.float32)
        sd = rng.randn(30, 3, 10).astype(np.float32)
        np.testing.assert_allclose(
            np_(P.blend_shapes(t(betas), t(sd))),
            np.asarray(J.blend_shapes(jnp.asarray(betas), jnp.asarray(sd))),
            atol=1e-5)
        Jr = rng.rand(24, 30).astype(np.float32)
        v = rng.randn(1, 30, 3).astype(np.float32)
        np.testing.assert_allclose(
            np_(P.vertices2joints(t(Jr), t(v))),
            np.asarray(J.vertices2joints(jnp.asarray(Jr), jnp.asarray(v))),
            atol=1e-5)
        np.testing.assert_array_equal(P.SMPL_PARENTS, J.SMPL_PARENTS)
        assert P.NUM_JOINTS == J.NUM_JOINTS

    def test_synthetic_smpl_same_body(self):
        from arah_tpu.data.synthetic import synthetic_smpl as J
        from arah_tpu_torch.data.synthetic import synthetic_smpl as P
        a, b = J(n_verts=700), P(n_verts=700)
        for f in a._fields:
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          np.asarray(getattr(b, f)),
                                          err_msg=f)

    def test_prepare_frame(self, rng):
        from arah_tpu.data.synthetic import synthetic_smpl
        from arah_tpu.model import prepare_frame as J
        from arah_tpu_torch.model import prepare_frame as P
        model = synthetic_smpl(n_verts=512)
        betas = (rng.randn(10) * 0.3).astype(np.float32)
        pose = (rng.randn(72) * 0.2).astype(np.float32)
        trans = np.asarray([0.1, 0.05, 0.2], np.float32)
        ref = J(model, jnp.asarray(betas), jnp.asarray(pose),
                jnp.asarray(trans))
        out = P(jax.tree.map(np.asarray, model), betas, pose, trans,
                device='cpu')
        flat_ref = jax.tree.leaves(ref)
        flat_out = jax.tree.leaves(out)
        assert len(flat_ref) == len(flat_out)
        for a, b in zip(flat_out, flat_ref):
            np.testing.assert_allclose(np_(a), np.asarray(b), atol=1e-4)


class TestConfigs:
    def test_fields_and_defaults(self):
        from arah_tpu.render.renderer import ModelConfig as J
        from arah_tpu_torch.render.renderer import ModelConfig as P
        j, p = J(), P()
        assert j._fields == p._fields
        for f in j._fields:
            a, b = getattr(j, f), getattr(p, f)
            if hasattr(a, '_fields'):
                assert a._fields == b._fields, f
                assert tuple(a) == tuple(b), f
            else:
                assert a == b, f

    def test_flagship(self):
        """The port's flagship is the JAX flagship field for field, with
        every kernel flag (march and iso included) on."""
        from __graft_entry__ import _flagship_config
        from arah_tpu_torch.scene import flagship_config
        cfg = flagship_config()
        assert port_cfg(_flagship_config()) == cfg
        assert cfg.tracer.use_pallas_march and cfg.tracer.use_pallas_iso


class TestPortRules:
    def test_imports_no_jax(self):
        """Importing every arah_tpu_torch module, the CLIs and the data
        path included, loads no jax and no arah_tpu module, and none of
        the packages the card's machine lacks: yaml, cv2, PIL, imageio,
        orbax (the port reads its configs and images with its own
        code)."""
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        code = (
            'import importlib, pkgutil, sys\n'
            'import arah_tpu_torch\n'
            'for m in pkgutil.walk_packages(arah_tpu_torch.__path__, '
            "'arah_tpu_torch.'):\n"
            '    importlib.import_module(m.name)\n'
            "top = ('jax', 'jaxlib', 'arah_tpu', 'yaml', 'cv2', 'PIL', "
            "'imageio', 'orbax')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in top]\n"
            'n = sum(m.startswith("arah_tpu_torch") for m in sys.modules)\n'
            "cli = all(f'arah_tpu_torch.{m}' in sys.modules for m in "
            "('cli.train', 'cli.validate', 'data.human_video', "
            "'utils.image', 'config.yaml_lite', 'train.trainer', "
            "'eval.evaluator', 'native'))\n"
            "print(n, cli, ','.join(bad))\n")
        r = subprocess.run([sys.executable, '-c', code], cwd=root,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr
        n, cli, bad = (r.stdout.strip() + ' ').split(' ', 2)
        assert int(n) >= 30, r.stdout
        assert cli == 'True', r.stdout
        assert bad.strip() == '', bad

    def test_build_scene_needs_a_device(self, monkeypatch):
        from arah_tpu_torch.scene import build_scene, flagship_config
        monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
        with pytest.raises(RuntimeError, match='no CUDA device'):
            build_scene(flagship_config(), 8)

    def test_split_write_back_keeps_element_0(self):
        """Phase-2 results land on exactly the rows phase 2 solved. With
        act=[T,F,T,F,F,F] and a resolve cap of 4, row 0 gets its phase-2
        value. The JAX pattern (nonzero padded with index 0, then a
        scatter of the padded batch) leaves row 0 with its stale phase-1
        value on JAX:CPU: this is where the port differs from JAX."""
        from arah_tpu_torch.render.ray_tracing import (_resolve_idx,
                                                       _split_write_back)
        act = torch.tensor([True, False, True, False, False, False])
        base = torch.arange(6, dtype=torch.float32)
        idx = _resolve_idx(act, 4)
        phase2 = torch.tensor([100.0, 102.0])
        out = _split_write_back(base, idx, phase2)
        np.testing.assert_array_equal(out.numpy(), [100, 1, 102, 3, 4, 5])

        act_j = jnp.asarray(act.numpy())
        idx_j = jnp.nonzero(act_j, size=4, fill_value=0)[0]
        sub_m = jnp.arange(4) < jnp.sum(act_j)
        p2 = jnp.asarray([100.0, 102.0, 0.0, 0.0])
        base_j = jnp.arange(6, dtype=jnp.float32)
        jax_out = np.asarray(base_j.at[idx_j].set(
            jnp.where(sub_m, p2, base_j[idx_j])))
        assert jax_out[2] == 102.0
        # the duplicate-index scatter makes JAX's row 0 order-dependent
        # (stale 0 or fresh 100); the port's is always the phase-2 value
        assert jax_out[0] in (0.0, 100.0)
