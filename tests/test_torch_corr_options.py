"""Kernel B's two options on the CPU: `want_jac` (the exact d fwd_skin /
d x_hat at each returned point, written by B's own launch) and
`precision` ('split3', 'bf16'), the plain versions against the Pallas
original `corr_search_pallas_t` in interpret mode; the tracer's
straggler split with J; the training render with `idiff_kernel_jac`.

Tolerances:
  * J against `forward_skinning_jac` at the roots, and against the
    interpret kernel's J: rtol 1e-4, atol 1e-5 (JAX's own bound,
    `tests/test_pallas.py:261-262`);
  * roots: Broyden can move a hard point to another valid root, so valid
    agreement > 0.98 and median |dx| on commonly valid points < 1e-5 at
    'f32' and 'split3' (f32-exact products); at 'bf16' the residual
    floors near 1e-3, so agreement with the interpret kernel at its
    relaxed `cvg_thresh` = 5e-3 > 0.95 and median |dx| < 1e-4;
  * 'split3' against 'f32': converged roots within 1e-5.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_port_util import np_, t

torch.set_num_threads(2)


def _problem(rng, n=256, hidden=64, layers=3):
    """A posed random skinning net and n points near their roots (the
    JAX test's set-up, `tests/test_pallas.py:215`)."""
    from arah_tpu.core.body import normalize_canonical_points
    from arah_tpu.core.smpl import batch_rodrigues
    from arah_tpu.nn.skinning import SkinningConfig, init_skinning
    from arah_tpu.ops.pallas.corr_kernel_t import skinning_dense_params
    from arah_tpu.render.ray_tracing import CanonicalFrame
    from arah_tpu.render.renderer import make_skin_fn
    from arah_tpu.solver.root_find import forward_skinning
    cfg = SkinningConfig(d_hidden=hidden, n_layers=layers)
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
    T0 = jnp.einsum('nj,jab->nab', skin_fn(normalize_canonical_points(
        x0, frame.coord_min, frame.coord_max, frame.center)),
        frame.bone_transforms)
    mask = rng.rand(n) > 0.1
    wts, bs = skinning_dense_params(params, cfg)
    jargs = (x_bar, x0, T0.reshape(n, 16), jnp.asarray(mask), list(wts),
             list(bs), frame.bone_transforms.reshape(24, 16),
             frame.coord_min, frame.coord_max, frame.center)
    pargs = (t(x_bar), t(x0), t(T0.reshape(n, 16)), torch.as_tensor(mask),
             [t(w) for w in wts], [t(b) for b in bs],
             t(frame.bone_transforms.reshape(24, 16)), t(frame.coord_min),
             t(frame.coord_max), t(frame.center))
    return skin_fn, frame, mask, jargs, pargs


def _roots(out, ref, mask, agree, med):
    v_ref, v_out = np.asarray(ref[2]), out[2].numpy()
    assert (v_ref == v_out).mean() > agree, (v_ref == v_out).mean()
    both = v_ref & v_out
    assert both.mean() > 0.8
    dx = np.linalg.norm(np_(out[0]) - np.asarray(ref[0]), axis=-1)
    assert np.median(dx[both]) < med, np.median(dx[both])
    np.testing.assert_array_equal(np_(out[0])[~mask],
                                  np.asarray(ref[0])[~mask])
    return both


@pytest.mark.parametrize('precision', ['f32', 'split3', 'bf16'])
def test_want_jac_vs_pallas(rng, precision):
    """B with `want_jac` at each precision: roots as the interpret
    kernel's, and J as the interpret kernel's (the tangent rounded as the
    primal is) and, at f32, as `forward_skinning_jac` at the roots; a
    masked point's J is the one at x0."""
    from arah_tpu.ops.pallas.corr_kernel_t import corr_search_pallas_t
    from arah_tpu.solver.root_find import forward_skinning_jac
    from arah_tpu_torch.ops.corr import corr_search
    skin_fn, frame, mask, jargs, pargs = _problem(rng)
    cvg = 5e-3 if precision == 'bf16' else 1e-5
    ref = corr_search_pallas_t(*jargs, tile=256, max_steps=20,
                               cvg_thresh=cvg, precision=precision,
                               want_jac=True, interpret=True)
    out = corr_search(*pargs, max_steps=20, cvg_thresh=cvg,
                      precision=precision, want_jac=True)
    assert len(out) == 5 and out[4].shape == (256, 3, 3)
    both = _roots(out, ref, mask, 0.95 if precision == 'bf16' else 0.98,
                  1e-4 if precision == 'bf16' else 1e-5)
    np.testing.assert_allclose(np_(out[4])[both], np.asarray(ref[4])[both],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np_(out[4])[~mask],
                               np.asarray(ref[4])[~mask], rtol=1e-4,
                               atol=1e-5)
    if precision == 'f32':
        J = forward_skinning_jac(skin_fn, frame, ref[0])
        np.testing.assert_allclose(np.asarray(ref[4]), np.asarray(J),
                                   rtol=1e-4, atol=1e-5)
        J = forward_skinning_jac(skin_fn, frame, jnp.asarray(np_(out[0])))
        np.testing.assert_allclose(np_(out[4]), np.asarray(J), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize('precision', ['split3', 'bf16'])
def test_precision_vs_pallas(rng, precision):
    """B at each precision against the interpret kernel at the same
    precision (no J), on the flagship's 128x4 skinning net; 'bf16' at
    JAX's relaxed threshold, as `tests/test_pallas.py:265-305`."""
    from arah_tpu.ops.pallas.corr_kernel_t import corr_search_pallas_t
    from arah_tpu_torch.ops.corr import corr_search
    _, _, mask, jargs, pargs = _problem(rng, n=512, hidden=128, layers=4)
    cvg = 5e-3 if precision == 'bf16' else 1e-5
    ref = corr_search_pallas_t(*jargs, tile=256, max_steps=20,
                               cvg_thresh=cvg, precision=precision,
                               interpret=True)
    out = corr_search(*pargs, max_steps=20, cvg_thresh=cvg,
                      precision=precision)
    assert len(out) == 4
    _roots(out, ref, mask, 0.95 if precision == 'bf16' else 0.98,
           1e-4 if precision == 'bf16' else 1e-5)


def test_split3_roots_match_f32(rng):
    """'split3' is f32-exact to ~2^-21: its converged roots lie within
    1e-5 of the 'f32' solve's."""
    from arah_tpu_torch.ops.corr import corr_search
    _, _, _, _, pargs = _problem(rng, n=512, hidden=128, layers=4)
    a = corr_search(*pargs, max_steps=20)
    b = corr_search(*pargs, max_steps=20, precision='split3')
    both = (a[2] & b[2]).numpy()
    assert both.mean() > 0.8
    dx = np.linalg.norm(np_(a[0]) - np_(b[0]), axis=-1)[both]
    assert dx.max() < 1e-5, dx.max()


def test_bf16_is_not_the_f32_solve(rng):
    """The repaired fault: the plain version used to solve in f32 for any
    `precision`, so at 'bf16' it was not the interpret kernel's solve. Now
    its roots stand 10x nearer the interpret kernel's at 'bf16' than the
    f32 solve's do."""
    from arah_tpu.ops.pallas.corr_kernel_t import corr_search_pallas_t
    from arah_tpu_torch.ops.corr import corr_search
    _, _, _, jargs, pargs = _problem(rng, n=512, hidden=128, layers=4)
    ref = corr_search_pallas_t(*jargs, tile=256, max_steps=20,
                               cvg_thresh=5e-3, precision='bf16',
                               interpret=True)
    meds = []
    for prec in ('f32', 'bf16'):
        out = corr_search(*pargs, max_steps=20, cvg_thresh=5e-3,
                          precision=prec)
        both = out[2].numpy() & np.asarray(ref[2])
        dx = np.linalg.norm(np_(out[0]) - np.asarray(ref[0]), axis=-1)
        meds.append(np.median(dx[both]))
    assert meds[1] * 10 < meds[0], meds


def test_pack_corr_halves(rng):
    """`pack_corr`: 'split3' words hold each weight's bf16 halves, hi on
    top (its bits are hi as an f32), lo below; 'bf16' the rounded
    weights; the first layer stays f32 in both."""
    from arah_tpu_torch.ops.corr import pack_corr, pack_precision, split_f32
    ws = [torch.randn(64, 3), torch.randn(64, 64) * 0.1,
          torch.randn(25, 64) * 0.1]
    bs = [torch.randn(64), torch.randn(64), torch.randn(25)]
    for prec in ('split3', 'bf16'):
        p = pack_corr(ws, bs, prec)
        assert p.precision == prec and pack_precision(p) == prec
        m = p.meta
        for l, w in enumerate(ws):
            o, din, dout = m.skin_wt_off[l], m.skin_dims[l], \
                m.skin_dims[l + 1]
            ld = -(-dout // 32) * 32
            blk = p.params[o:o + din * ld].reshape(din, ld)[:, :dout]
            if l == 0:
                assert torch.equal(blk, w.T)
                continue
            hi, lo = split_f32(w.T)
            bits = blk.contiguous().view(torch.int32)
            top = (bits & -65536).view(torch.float32)
            assert torch.equal(top, hi)
            if prec == 'split3':
                assert torch.equal((bits << 16).view(torch.float32), lo)
            else:
                assert torch.equal(blk, hi)
    assert pack_precision(pack_corr(ws, bs)) == 'f32'
    with pytest.raises(ValueError):
        pack_corr(ws, bs, 'fp8')


def test_split_solve_jac_row_rule(rng):
    """The tracer's straggler split with J: phase 2's rows take phase 2's
    J, written back by `_split_write_back` (only the rows it solved, so
    row 0 keeps its own result; ROADMAP §3); every row's J is the exact
    Jacobian at the row's returned point."""
    from arah_tpu_torch.ops.corr import dense_skin_fn
    from arah_tpu_torch.ops.skin_jac import skinning_jac_plain
    from arah_tpu_torch.render import ray_tracing as rt
    from arah_tpu_torch.render.ray_tracing import RayTracerConfig
    from arah_tpu_torch.solver.root_find import CanonicalFrame
    _, _, mask, _, pargs = _problem(rng, n=256)
    x_bar, x0, T0, m, ws, bs, bones16, cmin, cmax, center = pargs
    frame = CanonicalFrame(bones16.reshape(24, 4, 4), torch.zeros(3), cmin,
                           cmax, center)
    cfg = RayTracerConfig(corr_max_steps=20, corr_phase1_steps=2,
                          corr_resolve_cap=4096)
    skin = (ws, bs, 20.0)
    fn = dense_skin_fn(ws, bs, 20.0)
    x1, _, _, act, J1 = rt._corr_solve(cfg, fn, frame, skin, x_bar, x0,
                                       T0.reshape(-1, 4, 4), m, max_steps=2,
                                       want_jac=True)
    assert 0 < int(act.sum()) < 256
    x, _, v, _, J = rt._corr_solve_split(cfg, fn, frame, skin, x_bar, x0,
                                         T0.reshape(-1, 4, 4), m,
                                         want_jac=True)
    assert rt._corr_solve_split(cfg, fn, frame, skin, x_bar, x0,
                                T0.reshape(-1, 4, 4), m)[4] is None
    keep = ~act
    assert torch.equal(J[keep], J1[keep]) and torch.equal(x[keep], x1[keep])
    np.testing.assert_allclose(
        np_(J), np_(skinning_jac_plain(x, ws, bs, frame, 20.0)), rtol=1e-4,
        atol=1e-5)


def test_idiff_kernel_jac_render(rng, monkeypatch):
    """A training render with `idiff_kernel_jac`: the tracer asks B for J
    (the samples carry it), G is not called, and the loss and every
    gradient leaf equal the default render's (J from G), J being the same
    function (rtol 2e-4, atol 1e-6: JAX's TestIdiffKernelJac bound)."""
    from arah_tpu_torch.data.batch import draw_train_draws
    from arah_tpu_torch.parallel.train_step import trainable
    from arah_tpu_torch.render import renderer as prend
    from arah_tpu_torch.train.optim import tree_leaves_with_path
    from test_renderer import small_config
    from torch_port_util import jax_scene, port_cfg, port_inputs, \
        port_params
    cfg = small_config(train_skinning=True)
    _, params, _, inp = jax_scene(cfg, rng, n_rays=16)
    draws = draw_train_draws(np.random.RandomState(0), port_cfg(cfg), 1, 16,
                             device='cpu')
    pinp = port_inputs(inp)._replace(points_eik=draws.points_eik[0])
    jitter = (draws.u1[0], draws.u2[0], draws.u3[0])
    calls, real = [], prend.skinning_jac

    def spy(*a, **k):
        calls.append(a[0].shape[0])
        return real(*a, **k)
    monkeypatch.setattr(prend, 'skinning_jac', spy)
    res = {}
    for on in (False, True):
        calls.clear()
        pp = trainable(port_params(params))
        out = prend.render(pp, port_cfg(cfg)._replace(idiff_kernel_jac=on),
                           pinp, training=True, jitter=jitter)
        loss = (out['rgb_values'] ** 2).sum() + out['weights_sum'].sum()
        loss.backward()
        assert (calls == []) == on, calls
        res[on] = (float(loss), [np.zeros(l.shape) if l.grad is None
                                 else l.grad.numpy() for _, l in
                                 tree_leaves_with_path(pp)])
    assert res[True][0] == pytest.approx(res[False][0], rel=1e-6)
    n = 0
    for a, b in zip(res[True][1], res[False][1]):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-6)
        n += bool(np.abs(b).max() > 0)
    assert n >= 10


@pytest.mark.parametrize('precision', ['f32', 'split3'])
def test_idiff_kernel_jac_step_vs_jax(monkeypatch, precision):
    """The train step with `idiff_kernel_jac` (J from B's `want_jac`) at
    `pallas_precision`, against JAX's with every Pallas kernel forced
    (interpret: its corr kernel's in-kernel J at the same precision), by
    the step rule of `test_torch_train_step.py`."""
    from test_torch_train_step import _cfg, _check_step
    cfg = _cfg(True, False)
    cfg = cfg._replace(idiff_kernel_jac=True, tracer=cfg.tracer._replace(
        pallas_precision=precision))
    _check_step(cfg, monkeypatch, force=True)


def test_bench_corr_precision_variants():
    """`utils/bench_corr.main` runs the JAX bench's kernel variant
    `pallas_t` ('split3') and `pallas_t_bf16` on the CPU (their plain
    versions at n = 1,024): split3's converged roots within 1e-5 of the
    dense f32 solve's, bf16 at the relaxed threshold converging most of
    them."""
    from arah_tpu_torch.utils.bench_corr import main
    res = main(['--n', '1024', '--iters', '1', '--variants',
                'dense,pallas_t,pallas_t_bf16'], device='cpu')
    ref = res['dense']
    both = ref['valid'] & res['pallas_t']['valid']
    assert float(both.float().mean()) > 0.8
    dx = torch.linalg.norm(res['pallas_t']['x_hat'] - ref['x_hat'], dim=-1)
    assert float(dx[both].max()) < 1e-5
    assert not torch.equal(res['pallas_t_bf16']['x_hat'], ref['x_hat'])
    res = main(['--n', '1024', '--iters', '1', '--cvg', '5e-3',
                '--variants', 'pallas_t_bf16'], device='cpu')
    assert float(res['pallas_t_bf16']['valid'].float().mean()) > 0.8


def test_variant_table_matches_the_source():
    """`ops/corr.py:PRECISIONS` and `VARIANTS` against csrc/: the C enum
    of the precisions, and the launch shapes whose dispatch takes B's
    options (`corr_options`) or refuses them (`corr_f32_only`)."""
    import os
    import re
    from arah_tpu_torch.ops import _build
    from arah_tpu_torch.ops.corr import PRECISIONS, SHAPES, VARIANTS
    src = {f: open(os.path.join(_build.CSRC, f)).read()
           for f in ('tile_mlp.cuh', 'corr_rows.cu')}
    enum = dict(re.findall(r'PREC_(\w+) = (\d)', src['tile_mlp.cuh']))
    assert {k.lower(): int(v) for k, v in enum.items()} == PRECISIONS
    cases = re.findall(r'case (\d+): return (corr_options|corr_f32_only)'
                       r'<CorrShape(\d+)>', src['corr_rows.cu'])
    assert [int(c) for c, _, s in cases] == [int(s) for c, _, s in cases] \
        == list(range(len(SHAPES)))
    with_options = {int(s) for _, f, s in cases if f == 'corr_options'}
    assert {v[0] for v in VARIANTS} == with_options
    assert len(VARIANTS) == len(with_options) * (2 * len(PRECISIONS) - 1)
