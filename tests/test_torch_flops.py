"""The port's FLOPs accounting (`utils/flops.py`) against the JAX
package's (`arah_tpu/utils/flops.py`), equal to the last digit: the
weight shapes `model_shapes` reads from the tiny test model's trees (the
JAX tree and its port, each with its own generated SIREN) and from the
flagship configuration's skinning and colour nets and generated-SIREN
shapes, and every block of `train_step_flops` on both, over its options.
"""
import jax
import numpy as np
import torch

from test_renderer import small_config
from torch_port_util import port_cfg, port_params

from arah_tpu.utils import flops as jflops
from arah_tpu_torch.utils import flops as pflops

OPTIONS = [dict(), dict(train_skinning_net=False),
           dict(shade_frac=0.37, idiff_standalone=True),
           dict(n_eik=2048, n_reg=512, shade_frac=0.5)]


def _step_kw(shapes, n_verts):
    siren, skin, color, hyper = shapes
    return dict(n_rays=8192, n_samples=64, n_verts=n_verts,
                siren_shapes=siren, skin_shapes=skin, color_shapes=color,
                hypernet_params=hyper, corr_iters=7.25, march_iters=11.5,
                iso_iters=3.75)


def _check(shapes, n_verts):
    siren = shapes[0]
    for f in ('mlp_fwd_flops', 'siren_shade_fwd_flops',
              'siren_shade_bwd_flops'):
        assert getattr(pflops, f)(siren) == getattr(jflops, f)(siren)
    for opts in OPTIONS:
        kw = dict(_step_kw(shapes, n_verts), **opts)
        assert pflops.train_step_flops(**kw) == jflops.train_step_flops(**kw)


def test_tiny_model_vs_jax():
    from arah_tpu.model import init_model_params
    from arah_tpu.render.renderer import generate_sdf as jgen
    from arah_tpu_torch.render.renderer import generate_sdf
    cfg = small_config(train_skinning=True)
    params = init_model_params(jax.random.PRNGKey(0), cfg,
                               n_latent_frames=2)
    rots = np.tile(np.eye(3, dtype=np.float32).reshape(1, 1, 9), (1, 24, 1))
    jtrs = np.random.RandomState(0).randn(1, 24, 3).astype(np.float32) * .1
    jshapes = jflops.model_shapes(
        params, jgen(params, cfg, rots, jtrs, params['latent'][0]))
    pp = port_params(params)
    with torch.no_grad():
        gen = generate_sdf(pp, port_cfg(cfg), torch.as_tensor(rots),
                           torch.as_tensor(jtrs), pp['latent'][0])
    pshapes = pflops.model_shapes(pp, gen)
    assert pshapes == jshapes and pshapes[3] > 0
    _check(pshapes, n_verts=512)


def test_flagship_shapes_vs_jax():
    """The flagship's skinning and colour nets (built by the port, read
    by both) and its generated SIREN's shapes; the hypernetwork's
    parameter count from JAX's shapes alone (`jax.eval_shape`)."""
    from arah_tpu.model import init_model_params
    from arah_tpu_torch.nn.color import init_color
    from arah_tpu_torch.nn.hypernet import siren_layer_dims
    from arah_tpu_torch.nn.siren import GeneratedMLP
    from arah_tpu_torch.nn.skinning import init_skinning
    from arah_tpu_torch.scene import flagship_config
    cfg = flagship_config()
    g = torch.Generator().manual_seed(0)
    params = {'skinning': init_skinning(g, cfg.skinning),
              'color': init_color(g, cfg.color)}
    dims = siren_layer_dims(cfg.hypernet)
    gen = GeneratedMLP(tuple(torch.empty(o, i) for i, o in dims),
                       tuple(torch.empty(o) for _, o in dims), (), ())
    pshapes = pflops.model_shapes(params, gen)
    jparams = {k: {'layers': [{n: np.asarray(a) for n, a in layer.items()}
                              for layer in v['layers']]}
               for k, v in params.items()}
    assert pshapes == jflops.model_shapes(jparams, gen)
    assert pshapes[0] == [(256, 3)] + [(256, 256)] * 5 + [(1, 256)]
    hyper = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(
        jax.eval_shape(lambda k: init_model_params(k, _jax_flagship())
                       ['hypernet'], jax.random.PRNGKey(0))))
    assert hyper > 10 ** 6
    _check(pshapes[:3] + (hyper,), n_verts=6890)


def _jax_flagship():
    """The JAX ModelConfig of the port's flagship_config, field for
    field."""
    from arah_tpu.nn.color import ColorConfig
    from arah_tpu.nn.hypernet import HypernetConfig
    from arah_tpu.nn.skinning import SkinningConfig
    from arah_tpu.render.ray_tracing import RayTracerConfig
    from arah_tpu.render.renderer import ModelConfig
    from arah_tpu_torch.scene import flagship_config
    sub = {'hypernet': HypernetConfig, 'skinning': SkinningConfig,
           'color': ColorConfig, 'tracer': RayTracerConfig}
    cfg = flagship_config()
    return ModelConfig(**{f: sub[f](**getattr(cfg, f)._asdict())
                          if f in sub else getattr(cfg, f)
                          for f in cfg._fields})
