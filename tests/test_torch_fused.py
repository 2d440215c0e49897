"""Kernels J (standalone SIREN), K (row-layout nearest vertex) and L
(row-layout corr Broyden), the A/B switch that routes the tracer's
unfused loops through J and K (`arah_tpu_torch/ops/fused.py`,
`ARAH_ENABLE_PALLAS=1`), and the port of `bench_corr.py`, on the CPU.

The wrappers compute their plain versions for CPU tensors, so the tests
call the wrappers; on the card the same wrappers launch the CUDA kernels,
which `chip_smoke.py` holds against these plain versions. The JAX side
runs its Pallas kernels in interpret mode. Tolerances:
  * J: 1e-5 absolute, as tests/test_pallas.py holds the Pallas kernel
    against `siren_apply`;
  * K: chosen-vertex distances within 1e-5 (the Pallas kernel's MXU dot
    rounds otherwise than the plain version's separately rounded
    products, so near-ties may resolve apart), and equal indices where
    vertices are exact duplicates: both take the first;
  * L: the thresholds of tests/test_pallas.py::TestCorrKernel (valid
    agreement > 0.98, x_hat and T16 within 5e-4 on commonly valid
    points), masked points exactly at x0 and T0;
  * the switched render equals the unswitched one bit for bit: on CPU
    tensors J and K compute the very ops of the plain paths.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_renderer import small_config
from test_torch_render import _check_render, _jax_render
from torch_port_util import jax_scene, np_, port_cfg, port_gen, \
    port_inputs, port_params, t

torch.set_num_threads(2)


def _jax_gen(rng, film: bool):
    from arah_tpu.nn.hypernet import (HypernetConfig, hypernet_cond,
                                      hypernet_generate, init_hypernet)
    cfg = HypernetConfig(hidden_features=64, num_hidden_layers=2,
                         hyper_hidden_ch=64, use_film=film)
    params = init_hypernet(jax.random.PRNGKey(0), cfg)
    cond = hypernet_cond(
        params, cfg, jnp.asarray(rng.randn(1, 24, 9).astype(np.float32)),
        jnp.asarray(rng.randn(1, 24, 3).astype(np.float32)))[0]
    latent = jnp.asarray(rng.randn(128).astype(np.float32)) if film \
        else None
    return hypernet_generate(params, cfg, cond, latent)


class TestSiren:
    @pytest.mark.parametrize('film', [True, False])
    def test_plain_vs_pallas(self, rng, film):
        from arah_tpu.ops.pallas.siren_kernel import siren_sdf_pallas
        from arah_tpu_torch.ops.siren import siren_sdf
        gen = _jax_gen(rng, film)
        n, tile = 1000, 256                 # N not a tile multiple
        x = rng.randn(n, 3).astype(np.float32)
        xp = np.concatenate([x, np.zeros(((-n) % tile, 3), np.float32)])
        ref = np.asarray(siren_sdf_pallas(gen, jnp.asarray(xp), tile=tile,
                                          interpret=True))[:n]
        # one intra-op thread: one reduction order for torch's products
        # (the Pallas side's does not change with the thread count). The
        # module's thread count is whatever the last module collected in
        # this process set, and at 4 threads torch sums so that the 30x
        # sine chain moves one element of [True] by 1.16e-5.
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            out = siren_sdf(port_gen(gen), t(x))
        finally:
            torch.set_num_threads(threads)
        assert out.dtype == torch.float32 and out.shape == (n, 1)
        np.testing.assert_allclose(np_(out), ref, atol=1e-5)

    def test_tangents_are_the_plain_sirens(self, rng):
        """J's autograd op takes its tangents from the plain SIREN: the
        iso solve's init Jacobian (three forward-mode tangents through
        `torch.func.jvp`) equals that of the plain SDF bit for bit; reverse
        mode, which the tracer never takes, raises instead of
        differentiating the kernel."""
        from arah_tpu_torch.nn.siren import siren_apply
        from arah_tpu_torch.ops.fused import make_fused_sdf_fn
        from arah_tpu_torch.solver.root_find import (CanonicalFrame,
                                                     iso_init_inv_jacobian)
        gen = port_gen(_jax_gen(rng, True))
        fused = make_fused_sdf_fn(gen)

        def plain(x):
            return siren_apply(gen, x)[..., 0]
        a = (rng.randn(24, 3) * 0.1).astype(np.float32)
        tfs = np.tile(np.eye(4, dtype=np.float32), (24, 1, 1))
        tfs[:, :3, 3] = a
        frame = CanonicalFrame(t(tfs), t(np.zeros(3)), t(-1.1), t(1.0),
                               t(rng.randn(3) * 0.05))
        w = torch.softmax(t(rng.randn(24)), 0)

        def skin_fn(x):
            return w.expand(x.shape[0], 24)
        dirs = torch.nn.functional.normalize(t(rng.randn(64, 3)), dim=-1)
        x_hat = t(rng.randn(64, 3) * 0.3)
        j_k = iso_init_inv_jacobian(fused, skin_fn, frame, dirs, x_hat)
        j_p = iso_init_inv_jacobian(plain, skin_fn, frame, dirs, x_hat)
        assert torch.isfinite(j_p).all()
        assert torch.equal(j_k, j_p)
        x = x_hat.clone().requires_grad_(True)
        with pytest.raises(NotImplementedError):
            torch.autograd.grad(fused(x).sum(), x)

    def test_refuses_unsupported_shapes(self):
        from arah_tpu_torch.nn.siren import GeneratedMLP
        from arah_tpu_torch.ops.siren import pack_siren_sdf
        bad = GeneratedMLP((torch.zeros(30, 3), torch.zeros(1, 30)),
                           (torch.zeros(30), torch.zeros(1)), (), ())
        with pytest.raises(ValueError, match='siren kernel'):
            pack_siren_sdf(bad)            # hidden width not a multiple of 4


class TestKnnRows:
    @pytest.mark.parametrize('case', ['random', 'duplicates'])
    def test_plain_vs_pallas(self, rng, case):
        from arah_tpu.ops.pallas.knn_kernel import nn_idx_pallas
        from arah_tpu_torch.ops.knn import nn_idx_rows
        verts = rng.randn(1500, 3).astype(np.float32)
        if case == 'duplicates':
            # every vertex of 0..299 repeated at 1200..1499; points at them
            verts[1200:] = verts[:300]
            pts = verts[rng.randint(0, 300, 1000)] \
                + rng.randn(1000, 3).astype(np.float32) * 1e-3
        else:
            pts = rng.randn(1000, 3).astype(np.float32)
        n, tile = pts.shape[0], 512           # N not a tile multiple
        pp = np.concatenate([pts, np.zeros(((-n) % tile, 3), np.float32)])
        ref = np.asarray(nn_idx_pallas(jnp.asarray(pp), jnp.asarray(verts),
                                       tile=tile, v_tile=512,
                                       interpret=True))[:n]
        out = nn_idx_rows(t(pts), t(verts))
        assert out.dtype == torch.int32 and out.shape == (n,)
        idx = out.numpy()
        d_ref = np.linalg.norm(pts - verts[ref], axis=-1)
        d_out = np.linalg.norm(pts - verts[idx], axis=-1)
        np.testing.assert_allclose(d_out, d_ref, atol=1e-5)
        if case == 'duplicates':
            assert idx.max() < 1200 and ref.max() < 1200
            np.testing.assert_array_equal(idx, ref)


def _corr_problem(rng, n):
    """The harness of tests/test_pallas.py::TestCorrKernel: (JAX args of
    `corr_search_pallas` with (in, out) weights, mask, the JAX solve)."""
    from arah_tpu.core.body import normalize_canonical_points
    from arah_tpu.core.smpl import batch_rodrigues
    from arah_tpu.nn.skinning import SkinningConfig, init_skinning
    from arah_tpu.ops.pallas.corr_kernel_t import skinning_dense_params
    from arah_tpu.render.ray_tracing import CanonicalFrame
    from arah_tpu.render.renderer import make_skin_fn
    from arah_tpu.solver.root_find import forward_skinning
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
    x_gt = jnp.asarray(rng.randn(n, 3).astype(np.float32) * 0.3)
    x_bar, _ = forward_skinning(skin_fn, frame, x_gt)
    x0 = x_gt + 0.03 * jnp.asarray(rng.randn(n, 3).astype(np.float32))
    w0 = skin_fn(normalize_canonical_points(
        x0, frame.coord_min, frame.coord_max, frame.center))
    T0 = jnp.einsum('nj,jab->nab', w0, frame.bone_transforms)
    mask = rng.rand(n) > 0.1
    wts, bs = skinning_dense_params(params, cfg)
    return (x_bar, x0, T0.reshape(n, 16), jnp.asarray(mask),
            [w.T for w in wts], list(bs),
            frame.bone_transforms.reshape(24, 16), frame.coord_min,
            frame.coord_max, frame.center), mask


class TestCorrRows:
    def test_plain_vs_pallas(self, rng):
        from arah_tpu.ops.pallas.corr_kernel import corr_search_pallas
        from arah_tpu_torch.ops.corr_rows import corr_search_rows
        n = 512
        args, mask = _corr_problem(rng, n)
        ref = corr_search_pallas(*args, tile=256, interpret=True)
        out = corr_search_rows(
            t(args[0]), t(args[1]), t(args[2]), torch.as_tensor(mask),
            [t(w) for w in args[4]], [t(b) for b in args[5]],
            *(t(a) for a in args[6:]))
        assert len(out) == 3
        v_ref, v_out = np.asarray(ref[2]), out[2].numpy()
        assert (v_ref == v_out).mean() > 0.98
        both = v_ref & v_out
        assert both.mean() > 0.8
        np.testing.assert_allclose(np_(out[0])[both],
                                   np.asarray(ref[0])[both], atol=5e-4)
        np.testing.assert_allclose(np_(out[1])[both],
                                   np.asarray(ref[1])[both], atol=5e-4)
        # masked points return their init, x0 and T0, and are not valid
        np.testing.assert_array_equal(np_(out[0])[~mask],
                                      np.asarray(args[1])[~mask])
        np.testing.assert_array_equal(np_(out[1])[~mask],
                                      np.asarray(args[2])[~mask])
        assert not v_out[~mask].any()


def _ab_cfg(cfg):
    """The tracer's unfused A/B path: the march, iso and corr-init kernel
    flags off."""
    return cfg._replace(tracer=cfg.tracer._replace(
        use_pallas_march=False, use_pallas_iso=False, use_pallas_knn=False))


def test_switch_routes_render_through_j_and_k(rng, monkeypatch):
    """With `ARAH_ENABLE_PALLAS=1` and the three flags off, the eval
    render evaluates the tracer's SDF through J and every nearest-vertex
    query through K; without the switch neither is called. On CPU tensors
    the two renders are equal bit for bit, and the switched one matches
    JAX's (whose switch needs a TPU, so JAX runs its XLA paths)."""
    from arah_tpu_torch.ops import fused
    from arah_tpu_torch.render.renderer import render
    cfg = _ab_cfg(small_config())
    _, params, _, inp = jax_scene(cfg, rng, n_rays=32)
    calls = {'siren': 0, 'knn_rows': 0}
    for name, attr in (('siren', 'siren_sdf'), ('knn_rows', 'nn_idx_rows')):
        real = getattr(fused, attr)

        def spy(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(fused, attr, spy)
    p, pc, ip = port_params(params), port_cfg(cfg), port_inputs(inp)
    monkeypatch.setenv('ARAH_ENABLE_PALLAS', '1')
    on = render(p, pc, ip)
    # per march iteration and iso step, and the corr init (K)
    assert calls['siren'] >= 2 and calls['knn_rows'] >= 2, calls
    seen = dict(calls)
    monkeypatch.delenv('ARAH_ENABLE_PALLAS')
    off = render(p, pc, ip)
    assert calls == seen, calls
    for k, v in on.items():
        if torch.is_tensor(v):
            assert torch.equal(v, off[k]), k
    monkeypatch.setenv('ARAH_ENABLE_PALLAS', '1')
    _check_render(on, _jax_render(cfg, params, inp))


def test_bench_corr_problem_is_the_jax_benchs():
    """`make_problem` draws the JAX bench's problem (`bench_corr.py:39-63`,
    the draws `_corr_problem` repeats) from numpy seed 0: the same bone
    transforms, box, inits x0 and mask. Its targets x_bar are the port's
    skinning net applied to the same canonical points x_gt; they cannot
    equal JAX's, whose net is drawn from a PRNG key."""
    from arah_tpu_torch.solver.root_find import forward_skinning
    from arah_tpu_torch.utils.bench_corr import make_problem
    n = 2048
    skin_fn, frame, x_bar, x0, _, mask, _, _ = make_problem(n, 'cpu')
    ref, ref_mask = _corr_problem(np.random.RandomState(0), n)
    np.testing.assert_array_equal(mask.numpy(), ref_mask)
    np.testing.assert_array_equal(np_(x0), np.asarray(ref[1]))
    np.testing.assert_allclose(np_(frame.bone_transforms.reshape(24, 16)),
                               np.asarray(ref[6]), rtol=0, atol=1e-6)
    for a, b in zip((frame.coord_min, frame.coord_max, frame.center),
                    ref[7:]):
        np.testing.assert_array_equal(np_(a), np.asarray(b))
    rng = np.random.RandomState(0)
    rng.randn(24, 3), rng.randn(24, 3), rng.randn(3)   # aa, translations, c
    x_gt = t(rng.randn(n, 3).astype(np.float32) * 0.3)
    with torch.no_grad():
        assert torch.equal(forward_skinning(skin_fn, frame, x_gt)[0], x_bar)


def test_bench_corr_on_cpu():
    """A smoke test of `utils/bench_corr.main`'s command line at n = 2,048
    on the CPU: every variant runs and is timed, and an unknown variant
    raises. On CPU tensors L and B compute their plain versions, the same
    Broyden as `dense`, so their equality with it holds by construction;
    the kernels are held against the plain solve on the card
    (`chip_smoke.py`)."""
    from arah_tpu_torch.utils.bench_corr import main, make_problem
    res = main(['--n', '2048', '--iters', '1', '--variants',
                'dense,chunked,pallas,pallas_t_f32'], device='cpu')
    assert sorted(res) == ['chunked', 'dense', 'pallas', 'pallas_t_f32']
    mask = make_problem(2048, 'cpu')[5]
    ref = res['dense']
    assert 0.8 < float(ref['valid'].float().mean()) <= 0.9
    assert not bool((ref['valid'] & ~mask).any())
    for name in ('chunked', 'pallas', 'pallas_t_f32'):
        assert res[name]['ms'] > 0
        assert torch.equal(res[name]['valid'], ref['valid']), name
        assert torch.equal(res[name]['x_hat'], ref['x_hat']), name
    with pytest.raises(ValueError, match='unknown variants'):
        main(['--variants', 'sorted'], device='cpu')
