"""The model variants of JAX's `ModelConfig` beyond the flagship, in the
port against the JAX package on the CPU: the `single_bvp` SDF (a plain,
trainable SIREN in `params['sdf_plain']`, no FiLM) through the render
and the train step, and the geometric initialisation of the skinning
net (`SkinningConfig.geometric_init`).

The plain SIREN is the scene's generated SIREN with its FiLM folded into
its linear layers (`nn/siren.py:fold_film`), so it has the hypernet
render's surface. Tolerances: the folded SIREN against the generated one
within 1e-4 (the sine chain amplifies the fold's rounding); renders by
`test_torch_render.py`'s rule, steps by `test_torch_train_step.py`'s;
`jax.random` cannot be replayed, so the geometric init is held by its
structure (shapes, the exact last bias, the zeroed encoding columns, the
weight norm) and its statistics (means and deviations within a few
standard errors), and its forward pass on JAX's own init carried across
within 1e-5.
"""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_renderer import small_config
from test_torch_render import _check_render, _jax_render
from test_torch_train_step import _cfg, _jax_step
from torch_port_util import (check_step_vs_jax, jax_draws, jax_scene, np_,
                             port_batch, port_cfg, port_inputs, port_params,
                             t)

torch.set_num_threads(2)


def _plain_params(cfg, params, inp):
    """params with `sdf_plain`: the JAX scene's generated SIREN at its
    pose, FiLM folded in (numpy)."""
    from arah_tpu.render.renderer import generate_sdf
    from arah_tpu_torch.nn.siren import fold_film
    from torch_port_util import port_gen
    gen = generate_sdf(params, cfg, inp.rots, inp.Jtrs, inp.geo_latent)
    layers = fold_film(port_gen(gen))
    return dict(params, sdf_plain=[{k: jnp.asarray(v.numpy()) for k, v in
                                    l.items()} for l in layers]), gen


def test_fold_film_identity(rng):
    """The folded plain SIREN computes the generated SIREN's SDF and
    features (1e-4), in JAX (`plain_siren_as_generated`) and in the port,
    and has no FiLM."""
    from arah_tpu.nn.siren import plain_siren_as_generated, siren_apply
    from arah_tpu_torch.nn.siren import plain_siren_as_generated as pplain
    from arah_tpu_torch.nn.siren import siren_apply as papply
    cfg = small_config()
    _, params, _, inp = jax_scene(cfg, rng, n_rays=8)
    plain, gen = _plain_params(cfg, params, inp)
    x = jnp.asarray(rng.uniform(-1, 1, (256, 3)).astype(np.float32))
    ref = siren_apply(gen, x, return_features=True)
    jg = plain_siren_as_generated(plain['sdf_plain'])
    pg = pplain(port_params(plain)['sdf_plain'])
    assert jg.freqs == () and pg.freqs == ()
    for out in (siren_apply(jg, x, return_features=True),
                papply(pg, t(x), return_features=True)):
        for a, b in zip(out, ref):
            np.testing.assert_allclose(np_(a), np.asarray(b), atol=1e-4)


def test_single_bvp_render_vs_jax(rng):
    """The eval render with `sdf_plain`: the port's against JAX's (the
    tracer's plain loops and kernels' plain versions without FiLM), and
    against the hypernet render of the same pose (the same surface)."""
    from arah_tpu_torch.render.renderer import generate_sdf, render
    cfg = small_config()
    _, params, _, inp = jax_scene(cfg, rng, n_rays=48)
    plain, _ = _plain_params(cfg, params, inp)
    pp, pin, pcfg = port_params(plain), port_inputs(inp), port_cfg(cfg)
    gen = generate_sdf(pp, pcfg, pin.rots, pin.Jtrs, pin.geo_latent)
    assert gen.freqs == () and gen.weights[0] is pp['sdf_plain'][0]['w']
    out = render(pp, pcfg, pin)
    _check_render(out, _jax_render(cfg, plain, inp))
    hyper = render(port_params(params), pcfg, pin)
    agree = (out['network_body_mask'] == hyper['network_body_mask'])
    assert float(agree.float().mean()) > 0.95


def test_single_bvp_step_vs_jax(monkeypatch):
    """One train step with `sdf_plain`, against JAX's on the same
    parameters, batch and draws, every Pallas kernel forced on the JAX
    side: every loss term and gradient leaf (the plain SIREN's included)
    as the step rule holds them; `sdf_plain` labelled 'frozen' on both
    sides, so neither step moves it (JAX's optimiser never trains a
    `single_bvp` SDF; ROADMAP §3)."""
    from arah_tpu.data.batch import synthetic_train_batch
    from arah_tpu.train.loss import LossWeights
    from arah_tpu.train.optim import OptimConfig as JOptim
    from arah_tpu.train.optim import make_optimizer as jmake
    from arah_tpu_torch.parallel.train_step import (TrainState,
                                                    make_train_step,
                                                    trainable)
    from arah_tpu_torch.train.loss import LossWeights as PLossWeights
    from arah_tpu_torch.train.optim import (OptimConfig, make_optimizer,
                                            tree_leaves_with_path)
    monkeypatch.setenv('ARAH_FORCE_PALLAS', '1')
    cfg = _cfg(True, False)
    rng = np.random.RandomState(0)
    _, params, fd, inp = jax_scene(cfg, rng, n_rays=8)
    params, _ = _plain_params(cfg, params, inp)
    R = 48
    batch = synthetic_train_batch(jax.random.PRNGKey(1), fd, n_blocks=1,
                                  n_rays=R, n_reg=64)
    loss_w = LossWeights(n_ray_loss=R)
    key = jax.random.PRNGKey(2)
    jl, jg, jnew = _jax_step(cfg, params, batch, loss_w, key)
    _, jlabels = jmake(JOptim(train_skinning_net=True), params)
    assert set(jax.tree.leaves(jlabels['sdf_plain'])) == {'frozen'}
    pp = trainable(port_params(params))
    before = {p: l.detach().clone() for p, l in tree_leaves_with_path(pp)}
    opt, labels = make_optimizer(OptimConfig(train_skinning_net=True), pp)
    plain_paths = [p for p in labels if p[0] == 'sdf_plain']
    assert len(plain_paths) == 2 * len(params['sdf_plain'])
    assert all(labels[p] == 'frozen' for p in plain_paths)
    step = make_train_step(port_cfg(cfg), PLossWeights(**loss_w._asdict()),
                           opt)
    _, pl = step(TrainState(pp, opt, 0), port_batch(batch),
                 jax_draws(cfg, key, 1, R))
    grads = check_step_vs_jax(jl, jg, jnew, pl, pp, before, labels)
    assert any(np.abs(grads[p][1]).max() > 0 for p in plain_paths)


def test_init_plain_siren(rng):
    """`init_plain_siren`: the SIREN init (layer 0 within 1/in, later
    layers within sqrt(6/in)/30), JAX's shapes, and the port's own
    structure of JAX's tree."""
    from arah_tpu.nn.siren import init_plain_siren as jinit
    from arah_tpu_torch.nn.siren import init_plain_siren
    dims = [3, 64, 64, 64, 1]
    ref = jinit(jax.random.PRNGKey(0), dims)
    out = init_plain_siren(torch.Generator().manual_seed(0), dims)
    assert len(out) == len(ref) == 4
    for i, (a, b) in enumerate(zip(out, ref)):
        assert set(a) == set(b) == {'w', 'b'}
        assert tuple(a['w'].shape) == b['w'].shape
        assert tuple(a['b'].shape) == b['b'].shape
        bound = 1.0 / dims[i] if i == 0 else math.sqrt(6.0 / dims[i]) / 30
        for w in (np_(a['w']), np.asarray(b['w'])):
            assert np.abs(w).max() <= bound and np.abs(w).max() > 0.8 * bound


@pytest.mark.parametrize('case', ['plain', 'pe_skip'])
def test_geometric_init_structure(case):
    """`geometric_init_mlp`: shapes as JAX's; the last layer's bias
    exactly -bias and its weights sqrt(pi)/sqrt(in) + N(0, 1e-4); hidden
    weights N(0, 2/out) (mean and deviation within a few standard
    errors), zero biases; with positional encoding, layer 0 reads only the
    xyz columns and a skip layer's encoding columns are zero; the
    weight-norm g the row norms of v. `inside_outside` flips the last
    layer."""
    from arah_tpu.nn.layers import geometric_init_mlp as jgeo
    from arah_tpu_torch.nn.layers import geometric_init_mlp
    kw = dict(bias=0.7) if case == 'plain' else \
        dict(bias=0.7, multires=4, skip_in=(2,))
    d0 = 3 if case == 'plain' else 3 + 3 * 2 * 4
    dims = [d0, 128, 128, 128, 25]
    ref = jgeo(jax.random.PRNGKey(0), dims, **kw)
    out = geometric_init_mlp(torch.Generator().manual_seed(0), dims, **kw)
    assert len(out) == len(ref)
    for l, (a, b) in enumerate(zip(out, ref)):
        assert set(a) == set(b) == {'v', 'g', 'b'}
        for k in a:
            assert tuple(a[k].shape) == b[k].shape, (l, k)
        v = np_(a['v'])
        np.testing.assert_allclose(np_(a['g'])[:, 0],
                                   np.linalg.norm(v, axis=1), rtol=1e-6)
        if l == len(out) - 1:
            np.testing.assert_array_equal(np_(a['b']), np.float32(-0.7))
            mean = math.sqrt(math.pi) / math.sqrt(v.shape[1])
            assert abs(v.mean() - mean) < 1e-5
            assert 0.8e-4 < v.std() < 1.2e-4
            continue
        np.testing.assert_array_equal(np_(a['b']), 0.0)
        live = v
        if case == 'pe_skip' and l == 0:
            np.testing.assert_array_equal(v[:, 3:], 0.0)
            live = v[:, :3]
        if case == 'pe_skip' and l == 2:
            np.testing.assert_array_equal(v[:, -(d0 - 3):], 0.0)
            live = v[:, :-(d0 - 3)]
        std = math.sqrt(2) / math.sqrt(v.shape[0])
        se = std / math.sqrt(live.size)
        assert abs(live.mean()) < 5 * se, (l, live.mean())
        assert abs(live.std() / std - 1) < 5 / math.sqrt(live.size) + 0.02
    flip = geometric_init_mlp(torch.Generator().manual_seed(0), dims,
                              inside_outside=True, **kw)
    np.testing.assert_array_equal(np_(flip[-1]['b']), np.float32(0.7))
    assert np_(flip[-1]['v']).mean() < 0


def test_geometric_init_skinning_vs_jax(rng):
    """`init_skinning` with `geometric_init` takes the geometric init
    (the config's `bias`), in the JAX tree's form; the port's skinning
    weights on JAX's geometric-init parameters carried across equal
    JAX's (1e-5)."""
    from arah_tpu.nn.skinning import SkinningConfig as JCfg
    from arah_tpu.nn.skinning import init_skinning as jinit
    from arah_tpu.nn.skinning import skinning_weights as jweights
    from arah_tpu_torch.nn.skinning import (SkinningConfig, init_skinning,
                                            skinning_weights)
    jcfg = JCfg(geometric_init=True, bias=0.5)
    cfg = SkinningConfig(**jcfg._asdict())
    ref = jinit(jax.random.PRNGKey(0), jcfg)
    out = init_skinning(torch.Generator().manual_seed(0), cfg)
    assert len(out['layers']) == len(ref['layers'])
    for a, b in zip(out['layers'], ref['layers']):
        assert {k: tuple(v.shape) for k, v in a.items()} == \
            {k: v.shape for k, v in b.items()}
    np.testing.assert_array_equal(np_(out['layers'][-1]['b']), -0.5)
    x = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    np.testing.assert_allclose(
        np_(skinning_weights(port_params(ref), cfg, t(x))),
        np.asarray(jweights(ref, jcfg, jnp.asarray(x))), atol=1e-5)
