"""The port's geometric-init SDF MLP (`nn/sdf_mlp.py`) against the JAX
package's (`arah_tpu/nn/sdf_mlp.py`), at the reference's default widths
(256 x 8, skip at 4, the pose code at layer 0, 6 frequencies) and a tiny
one (32 x 3, weight norm off, inside-outside, scale 2, no encoding):

- the same JAX parameters (moved across by `convert.params_from_jax`)
  give the same outputs on the same points and pose, to float32
  roundoff (within 1e-5 of the output's scale);
- the port's own init (an explicit `torch.Generator`) has JAX's tree,
  shapes and laws: the exact biases and zero blocks, the last layer's
  weights at sqrt(pi)/sqrt(in) (negated inside-outside) within 1e-4 * 6
  sigma, the hidden layers' spread at sqrt(2)/sqrt(out) within 10%.
"""
import math

import jax
import numpy as np
import pytest
import torch

from torch_port_util import port_params

CONFIGS = {
    'reference': {},
    'tiny': dict(d_hidden=32, n_layers=3, skip_in=(2,), cond_in=(1,),
                 multires=0, d_out=5, bias=0.3, scale=2.0,
                 inside_outside=True, weight_norm=False),
}


def _cfgs(name):
    from arah_tpu.nn.sdf_mlp import SdfMlpConfig as J
    from arah_tpu_torch.nn.sdf_mlp import SdfMlpConfig as P
    return J(**CONFIGS[name]), P(**CONFIGS[name])


def _inputs(rng, n=300):
    coords = (rng.rand(n, 3).astype(np.float32) - 0.5) * 2
    rots = np.tile(np.eye(3, dtype=np.float32).reshape(1, 1, 9), (1, 24, 1))
    rots = rots + rng.randn(1, 24, 9).astype(np.float32) * 0.1
    jtrs = rng.randn(1, 24, 3).astype(np.float32) * 0.2
    return coords, rots, jtrs


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_apply_vs_jax(name):
    from arah_tpu.nn.sdf_mlp import init_sdf_mlp as jinit
    from arah_tpu.nn.sdf_mlp import sdf_mlp_apply as japply
    from arah_tpu_torch.nn.sdf_mlp import sdf_mlp_apply
    jcfg, pcfg = _cfgs(name)
    params = jinit(jax.random.PRNGKey(3), jcfg)
    coords, rots, jtrs = _inputs(np.random.RandomState(1))
    ref = np.asarray(japply(params, jcfg, coords, rots, jtrs))
    out = sdf_mlp_apply(port_params(params), pcfg, torch.as_tensor(coords),
                        torch.as_tensor(rots), torch.as_tensor(jtrs))
    assert out.shape == ref.shape == (300, pcfg.d_out)
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_init_laws_vs_jax(name):
    from arah_tpu.nn.sdf_mlp import init_sdf_mlp as jinit
    from arah_tpu_torch.nn.sdf_mlp import init_sdf_mlp
    jcfg, pcfg = _cfgs(name)
    jp = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0), jcfg))
    pp = init_sdf_mlp(torch.Generator().manual_seed(0), pcfg)
    assert jax.tree.structure(jp) == jax.tree.structure(
        jax.tree.map(lambda t: 0, pp, is_leaf=torch.is_tensor))
    for jl, pl in zip(jp['layers'], pp['layers']):
        assert jl.keys() == pl.keys()
        for k in jl:
            a, b = pl[k].numpy(), jl[k]
            assert a.shape == b.shape, k
            # the same exact zeros (biases, encoding columns)
            np.testing.assert_array_equal(a == 0, b == 0)
        np.testing.assert_array_equal(pl['b'].numpy(), jl['b'])
    w_of = 'v' if pcfg.weight_norm else 'w'
    last = pp['layers'][-1][w_of].numpy()
    mean = math.sqrt(math.pi) / math.sqrt(last.shape[1])
    mean = -mean if pcfg.inside_outside else mean
    assert np.abs(last - mean).max() <= 6e-4
    for l, layer in enumerate(pp['layers'][:-1]):
        w = layer[w_of].numpy()
        live = w[w != 0]
        want = math.sqrt(2) / math.sqrt(w.shape[0])
        assert abs(live.std() / want - 1) <= 0.1, (l, live.std(), want)
    if pcfg.weight_norm:
        for layer in pp['layers']:
            np.testing.assert_allclose(
                layer['g'].numpy()[:, 0],
                np.linalg.norm(layer['v'].numpy(), axis=1), rtol=1e-6)
