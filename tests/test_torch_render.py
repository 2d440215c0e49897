"""The slice as a whole: the port's eval render (`render(training=False)`)
against the JAX package's on the CPU, with the straggler splits off and
with them on (split against split), against both the JAX package's XLA
paths and its Pallas kernels (interpret mode); that the port's render
goes through kernels E and F when their flags are on; plus the port's own
split-vs-single-pass identity and its refusals.

Tolerances: the tracer's march and Broyden solves can move a ray that
sits on a convergence threshold to the other side (or a hard point to
another, equally valid root), so the body masks are held by agreement
(>= 0.95) and rgb by its median on the rays both sides keep (< 1e-3); a
handful of such rays may differ by far more. Depths of rays whose
surface both sides found are held the same way (median < 1e-4).
"""
import numpy as np
import jax
import pytest
import torch

from test_renderer import small_config
from torch_port_util import jax_scene, np_, port_cfg, port_inputs, \
    port_params

torch.set_num_threads(2)


def _split_cfg(cfg):
    """Phase 1 capped at 3 iterations and caps small enough that phase 2
    runs for march, iso and corr."""
    return cfg._replace(tracer=cfg.tracer._replace(
        march_phase1_steps=3, iso_phase1_steps=3, corr_phase1_steps=3,
        march_resolve_cap=16, iso_resolve_cap=16, corr_resolve_cap=256))


def _spy_resolve(monkeypatch):
    """The sizes of the phase-2 batches the port's splits solve, in call
    order (march, iso, corr)."""
    from arah_tpu_torch.render import ray_tracing as prt
    sizes, real = [], prt._resolve_idx

    def spy(active, cap):
        idx = real(active, cap)
        sizes.append(idx.numel())
        return idx
    monkeypatch.setattr(prt, '_resolve_idx', spy)
    return sizes


def _check_render(out, ref):
    """The port's render `out` against the JAX render `ref` (numpy)."""
    m_ref = ref['network_body_mask']
    m_out = out['network_body_mask'].numpy()
    assert m_ref.any() and m_out.any()
    assert (m_ref == m_out).mean() >= 0.95
    both = m_ref & m_out
    d_rgb = np.abs(np_(out['rgb_values']) - ref['rgb_values'])[both]
    assert np.median(d_rgb) < 1e-3, np.median(d_rgb)
    assert float(np_(out['rgb_values']).mean()) > 0.05   # not a black frame
    s_ref = ref['surface_converged']
    s_out = out['surface_converged'].numpy()
    assert (s_ref == s_out).mean() >= 0.95
    s_both = s_ref & s_out
    if s_both.any():
        d_dep = np.abs(np_(out['surface_depth'])
                       - ref['surface_depth'])[s_both]
        assert np.median(d_dep) < 1e-4, np.median(d_dep)
    # the per-frame hypernetwork output: flattened generated weights
    assert len(out['sdf_params']) == len(ref['sdf_params'])
    for a, b in zip(out['sdf_params'], ref['sdf_params']):
        np.testing.assert_allclose(np_(a), b, atol=1e-4)
    assert int(out['n_samples_valid']) == pytest.approx(
        int(ref['n_samples_valid']), rel=0.05)


def _jax_render(cfg, params, inp):
    from arah_tpu.render.renderer import render as jrender
    return jax.tree.map(np.asarray, jax.jit(
        lambda p, i: jrender(p, cfg, i, jax.random.PRNGKey(1),
                             training=False))(params, inp))


def _spy_kernels(monkeypatch):
    """Launch counts of the port's march and iso wrappers as the tracer
    calls them."""
    from arah_tpu_torch.render import ray_tracing as prt
    counts = {'march': 0, 'iso': 0}
    for name, attr in (('march', 'sphere_march'), ('iso', 'iso_refine')):
        real = getattr(prt, attr)

        def spy(*a, _real=real, _name=name, **k):
            counts[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(prt, attr, spy)
    return counts


@pytest.mark.parametrize('split', [False, True])
def test_render_vs_jax(rng, monkeypatch, split):
    from arah_tpu_torch.render.renderer import render as prender
    cfg = _split_cfg(small_config()) if split else small_config()
    _, params, _, inp = jax_scene(cfg, rng, n_rays=48)
    ref = _jax_render(cfg, params, inp)
    resolved = _spy_resolve(monkeypatch)
    out = prender(port_params(params), port_cfg(cfg), port_inputs(inp))
    if split:
        # march, iso and corr each re-solved some stragglers in phase 2
        assert len(resolved) == 3 and min(resolved) > 0, resolved
    else:
        assert resolved == []
    _check_render(out, ref)


@pytest.mark.parametrize('split', [False, True])
def test_render_vs_jax_kernels(rng, monkeypatch, split):
    """Every kernel flag on: the port's plain versions of A-F (CPU
    tensors) against the JAX render with every Pallas kernel in interpret
    mode (ARAH_FORCE_PALLAS=1). The tiles divide the 48 rays, their 768
    samples and the phase-2 caps, so that no JAX kernel falls back to
    XLA; spies check that the JAX march and iso kernels ran."""
    import arah_tpu.ops.pallas.iso_kernel as jiso
    import arah_tpu.ops.pallas.march_kernel as jmarch
    from arah_tpu_torch.render.renderer import render as prender
    cfg = small_config()
    cfg = cfg._replace(pallas_shade_tile=256, tracer=cfg.tracer._replace(
        pallas_march_tile=16, pallas_iso_tile=16, pallas_corr_tile=128,
        pallas_knn_tile=128))
    if split:
        cfg = _split_cfg(cfg)
    _, params, _, inp = jax_scene(cfg, rng, n_rays=48)
    jcalls = []
    for mod, attr in ((jmarch, 'sphere_march_pallas'),
                      (jiso, 'iso_refine_pallas')):
        real = getattr(mod, attr)

        def jspy(*a, _real=real, _attr=attr, **k):
            jcalls.append(_attr)
            return _real(*a, **k)
        monkeypatch.setattr(mod, attr, jspy)
    monkeypatch.setenv('ARAH_FORCE_PALLAS', '1')
    ref = _jax_render(cfg, params, inp)
    n_phase = 2 if split else 1
    assert jcalls.count('sphere_march_pallas') == n_phase, jcalls
    assert jcalls.count('iso_refine_pallas') == n_phase, jcalls
    launched = _spy_kernels(monkeypatch)
    resolved = _spy_resolve(monkeypatch)
    out = prender(port_params(params), port_cfg(cfg), port_inputs(inp))
    assert launched == {'march': n_phase, 'iso': n_phase}, launched
    if split:
        assert len(resolved) == 3 and min(resolved) > 0, resolved
    _check_render(out, ref)


def test_kernel_flags_dispatch(rng, monkeypatch):
    """With `use_pallas_march`/`use_pallas_iso` on, the render goes through
    the wrappers of kernels E and F (the renderer hands the tracer the
    generated SIREN and the collapsed skinning MLP); with them off, the
    plain loops run and the wrappers are never called."""
    from arah_tpu_torch.render.renderer import render
    cfg = port_cfg(small_config())
    _, params, _, inp = jax_scene(small_config(), rng, n_rays=16)
    p, ip = port_params(params), port_inputs(inp)
    launched = _spy_kernels(monkeypatch)
    on = render(p, cfg, ip)
    assert launched == {'march': 1, 'iso': 1}, launched
    off_cfg = cfg._replace(tracer=cfg.tracer._replace(
        use_pallas_march=False, use_pallas_iso=False))
    off = render(p, off_cfg, ip)
    assert launched == {'march': 1, 'iso': 1}, launched
    # the two paths agree on this scene
    assert (on['surface_converged'] == off['surface_converged']).float() \
        .mean() >= 0.9


def test_sphere_trace_shares_one_pack(rng, monkeypatch):
    """The tracer builds kernels E and F's parameter pack once a trace
    (`pack_trace`) and hands the same pack to both phases of both
    kernels; the trace with that shared pack gives the same values as
    with a separate pack for each call (E's own SIREN pack, F's own
    SIREN-and-skinning pack), whose bytes E and F read at the same
    offsets."""
    from arah_tpu_torch.ops.march import pack_trace
    from arah_tpu_torch.render import ray_tracing as prt
    from arah_tpu_torch.render.renderer import render
    cfg = _split_cfg(small_config())
    _, params, _, inp = jax_scene(cfg, rng, n_rays=48)
    p, ip, pcfg = port_params(params), port_inputs(inp), port_cfg(cfg)
    built, seen = [], []

    def pack_spy(*a):
        built.append(pack_trace(*a))
        return built[-1]
    monkeypatch.setattr(prt, 'pack_trace', pack_spy)

    def spy(attr, own):
        real = getattr(prt, attr)

        def f(*a, packed=None, **k):
            seen.append((attr, packed))
            if own:           # a separate pack for this call alone
                gen = a[7] if attr == 'sphere_march' else a[9]
                sk = () if attr == 'sphere_march' else (a[6], a[7])
                own_pack = pack_trace(gen, *sk)
                if attr == 'sphere_march':   # E reads the SIREN prefix
                    n = own_pack.params.numel()
                    assert torch.equal(packed.params[:n], own_pack.params)
                else:
                    assert torch.equal(packed.params, own_pack.params)
                    assert bytes(packed.meta) == bytes(own_pack.meta)
                packed = own_pack
            return real(*a, packed=packed, **k)
        monkeypatch.setattr(prt, attr, f)
    for attr in ('sphere_march', 'iso_refine'):
        spy(attr, own=False)
    shared = render(p, pcfg, ip)
    assert len(built) == 1
    assert [a for a, _ in seen] == ['sphere_march'] * 2 + ['iso_refine'] * 2
    assert all(pk is built[0] for _, pk in seen)
    monkeypatch.undo()
    monkeypatch.setattr(prt, 'pack_trace', pack_spy)
    seen.clear()
    for attr in ('sphere_march', 'iso_refine'):
        spy(attr, own=True)
    separate = render(p, pcfg, ip)
    assert len(seen) == 4 and len(built) == 2
    for k in ('network_body_mask', 'surface_converged', 'surface_depth',
              'rgb_values'):
        assert torch.equal(shared[k], separate[k]), k


def test_split_equals_single_pass(rng, monkeypatch):
    """With caps that hold every straggler, the port's splits reproduce
    the single-pass render: a point's (or ray's) trajectory does not
    depend on the others, phase 2 re-solves the corr and iso stragglers
    from scratch and resumes the march from its depth, and only the
    solved rows are written back."""
    from arah_tpu_torch.render.renderer import render
    cfg = small_config()
    _, params, _, inp = jax_scene(cfg, rng, n_rays=48)
    p, ip = port_params(params), port_inputs(inp)
    pcfg = port_cfg(cfg)
    split = pcfg._replace(tracer=pcfg.tracer._replace(
        march_phase1_steps=3, iso_phase1_steps=3, corr_phase1_steps=3,
        march_resolve_cap=48, iso_resolve_cap=48, corr_resolve_cap=48 * 16))
    a = render(p, pcfg, ip)
    resolved = _spy_resolve(monkeypatch)
    b = render(p, split, ip)
    assert len(resolved) == 3 and min(resolved) > 0, resolved
    assert bool(a['network_body_mask'].any())
    np.testing.assert_array_equal(a['network_body_mask'].numpy(),
                                  b['network_body_mask'].numpy())
    np.testing.assert_array_equal(a['surface_converged'].numpy(),
                                  b['surface_converged'].numpy())
    for k in ('rgb_values', 'weights_sum', 'surface_depth'):
        np.testing.assert_allclose(np_(b[k]), np_(a[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_corr_coarse_stride_vs_jax(rng):
    """`corr_coarse_stride` = 4: `canonicalize_samples` solves slot 0 of
    every block of 4 samples from the nearest-vertex init and warm-starts
    the other 3 from the bracketing coarse roots. The port against JAX,
    plain paths on both sides, on 32 rays x 16 sorted samples between
    near and far: valid masks agree, 99% of the points (converged or not)
    within 1e-4, the masked ones (frozen at their warm init) within 1e-5.
    JAX's stride-0 solve parts from its stride-4 one on this scene (its
    masked points keep the nearest-vertex init), so a port that ignored
    the stride would fail."""
    import jax.numpy as jnp
    from arah_tpu.render import ray_tracing as jrt
    from arah_tpu.render.renderer import make_skin_fn as jskin
    from arah_tpu_torch.render.ray_tracing import canonicalize_samples
    from arah_tpu_torch.render.renderer import make_skin_fn as pskin
    from torch_port_util import t
    cfg = small_config()
    cfg = cfg._replace(tracer=cfg.tracer._replace(
        corr_coarse_stride=4, use_pallas_corr=False, use_pallas_knn=False))
    _, params, _, inp = jax_scene(cfg, rng, n_rays=32)
    n, S = 32, cfg.tracer.n_steps
    near, far = np.asarray(inp.near), np.asarray(inp.far)
    u = np.sort(rng.uniform(size=(n, S)).astype(np.float32), axis=1)
    z = near[:, None] + u * (far - near)[:, None]
    mask = rng.uniform(size=(n, S)) > 0.1
    cam = jnp.broadcast_to(inp.cam_loc, inp.ray_dirs.shape)

    def jax_run(tracer):
        out = jrt.canonicalize_samples(
            tracer, None, jskin(params, cfg), inp.frame, inp.smpl, cam,
            inp.ray_dirs, jnp.asarray(z), jnp.asarray(mask))
        return [np.asarray(a) for a in out[:3]]
    ref, ref0 = jax_run(cfg.tracer), \
        jax_run(cfg.tracer._replace(corr_coarse_stride=0))
    pc, pi = port_cfg(cfg), port_inputs(inp)
    out = [a.numpy() for a in canonicalize_samples(
        pc.tracer, pskin(port_params(params), pc), pi.frame, pi.smpl,
        pi.cam_loc.expand(pi.ray_dirs.shape), pi.ray_dirs, t(z),
        torch.as_tensor(mask))[:3]]

    def parts(a, b):
        dx = np.linalg.norm(a[0] - b[0], axis=-1)
        return (a[2] == b[2]).mean(), (dx < 1e-4).mean(), dx[~mask].max()
    agree, close, masked = parts(out, ref)
    assert agree >= 0.98 and close >= 0.99 and masked < 1e-5, \
        (agree, close, masked)
    both = out[2] & ref[2]
    assert both.mean() > 0.5
    np.testing.assert_allclose(out[1][both], ref[1][both], atol=1e-4)
    assert parts(ref0, ref)[2] > 1e-2


def test_flagship_scene_has_a_surface():
    """`build_scene(pretrain=False)` at the flagship widths (32 rays on the
    CPU, every kernel flag on, so the plain versions) renders a body with
    a surface: the random-init SIREN, lowered by SURFACE_SHIFT, has a
    level set that rays converge on. Without the shift every ray misses
    and the frame is black, leaving the surface paths untested."""
    from arah_tpu_torch.render.renderer import render
    from arah_tpu_torch.scene import build_scene, flagship_config
    cfg = flagship_config()
    params, _, inp = build_scene(cfg, 32, seed=0, device='cpu',
                                 pretrain=False)
    with torch.no_grad():
        out = render(params, cfg, inp)
    rgb = out['rgb_values']
    assert tuple(rgb.shape) == (32, 3)
    assert bool(torch.isfinite(rgb).all())
    assert bool(((rgb >= 0) & (rgb <= 1)).all())
    assert bool(out['network_body_mask'].any())
    assert int(out['surface_converged'].sum()) > 0
    assert float(out['weights_sum'].max()) > 0.5


def test_training_is_a_later_slice(rng):
    """Training renders on the CPU (the train step is ported): with its
    draws, `render(training=True)` returns the training keys, finite;
    without them it and training-mode sampling refuse. The sharded step
    (`mesh=`, ported) refuses what it cannot run: a mesh outside a
    process group, and blocks that do not split over the ranks; SMPL
    refinement (`refine_smpl=`) without an SMPL model is refused."""
    from arah_tpu_torch.data.batch import draw_train_draws
    from arah_tpu_torch.parallel.train_step import make_train_step, trainable
    from arah_tpu_torch.render.ray_tracing import sample_z_vals
    from arah_tpu_torch.render.renderer import render
    from arah_tpu_torch.train.loss import LossWeights
    from arah_tpu_torch.train.optim import OptimConfig, make_optimizer
    cfg = small_config(train_skinning=True)
    _, params, _, inp = jax_scene(cfg, rng, n_rays=8)
    pcfg, pp = port_cfg(cfg), trainable(port_params(params))
    draws = draw_train_draws(np.random.RandomState(0), pcfg, 1, 8,
                             device='cpu')
    pinp = port_inputs(inp)._replace(
        points_uniform=torch.rand(16, 3) * 2 - 1,
        points_inside=torch.randn(16, 3) * 0.1,
        points_skinning=torch.randn(16, 3) * 0.2,
        points_eik=draws.points_eik[0])
    out = render(pp, pcfg, pinp, training=True,
                 jitter=(draws.u1[0], draws.u2[0], draws.u3[0]))
    for k in ('rgb_values', 'weights_sum', 'grad_theta', 'off_surface_sdf',
              'inside_sdf', 'pred_weights'):
        assert bool(torch.isfinite(out[k]).all()), k
    assert tuple(out['grad_theta'].shape) == (pcfg.n_eik_points, 3)
    assert out['rgb_values'].requires_grad
    with pytest.raises(ValueError):
        render(pp, pcfg, pinp, training=True)
    z = torch.ones(4)
    with pytest.raises(ValueError):
        sample_z_vals(pcfg.tracer, z > 0, z, z * 0, z * 2, eval_mode=False)
    opt, _ = make_optimizer(OptimConfig(), pp)
    from arah_tpu_torch.parallel.mesh import local_blocks, make_mesh
    with pytest.raises(RuntimeError, match='process group'):
        make_mesh()
    with pytest.raises(ValueError, match='do not split'):
        local_blocks(draws, 0, 2)
    with pytest.raises(ValueError, match='smpl_model'):
        make_train_step(pcfg, LossWeights(), opt, refine_smpl=True)
