"""The novel-pose visualisation path of the port against the JAX
package's on the CPU: `utils/camera_path.py:gen_spiral_path` (float64,
to 1e-12), `utils/meshing.py` (the grid's point order, and the SDF grid at
resolution 32 against JAX's `eval_sdf_grid` of `siren_apply`, max |d| <=
1e-5; the port's marching cubes on JAX's grid: the same vertices and
faces) and `eval/mesh_vis.py:render_normal_maps` at 48 and 64 px (the
foreground of each map, where the face buffer holds a face, agreeing on
>= 0.99 of the pixels; the median |d| of each image < 1e-5), at the
parameters `params_from_jax` moves across, on an ODP item of a fake ZJU
fixture."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_renderer import small_config
from torch_port_util import port_cfg, port_params

torch.set_num_threads(2)


@pytest.mark.parametrize('n_cams', [1, 4])
def test_spiral_path_vs_jax(n_cams):
    from arah_tpu.utils.camera_path import gen_spiral_path as jgen
    from arah_tpu_torch.utils.camera_path import gen_spiral_path
    from scipy.spatial.transform import Rotation
    rng = np.random.RandomState(n_cams)
    w2cs = []
    for _ in range(n_cams):
        m = np.eye(4)
        m[:3, :3] = Rotation.from_rotvec(rng.randn(3) * 0.5).as_matrix()
        m[:3, 3] = rng.randn(3) * 2
        w2cs.append(m if n_cams > 1 else m[:3])
    w2cs = w2cs * max(1, 4 // n_cams)
    for a, b in zip(gen_spiral_path(w2cs, 7), jgen(w2cs, 7)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


def test_grid_chunk_order():
    """grid_chunk's points are np.meshgrid(lin, lin, lin, 'ij')'s, in
    order, and the last chunk is padded with the origin."""
    from arah_tpu_torch.utils.meshing import grid_chunk
    n = 7
    lin = np.linspace(-1.0, 1.0, n, dtype=np.float32)
    ref = np.stack(np.meshgrid(lin, lin, lin, indexing='ij'),
                   axis=-1).reshape(-1, 3)
    pts = torch.cat([grid_chunk(n, i, 100) for i in range(0, n ** 3, 100)])
    np.testing.assert_array_equal(pts[:n ** 3].numpy(), ref)
    assert not pts[n ** 3:].any()


@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    """(JAX params, cfg, a JAX ODP item, the port's ODP item of the same
    frame, the JAX generated SIREN) on a 2-frame fake ZJU fixture. The
    random-init SIREN is positive over the whole grid; its output bias is
    lowered by the grid's median, so that half the grid is inside."""
    from arah_tpu.data.odp import ODPDataset as J
    from arah_tpu.model import init_model_params
    from arah_tpu.data.loader import frame_from_item
    from arah_tpu.nn.siren import siren_apply
    from arah_tpu.render.renderer import generate_sdf
    from arah_tpu_torch.data.fake_dataset import make_fake_zju_dataset
    from arah_tpu_torch.data.odp import ODPDataset as P
    root = str(tmp_path_factory.mktemp('fake_zju'))
    make_fake_zju_dataset(root, n_frames=2, img_size=128, n_verts=512,
                          seed=2)
    kw = dict(pose_dir='models', cam_name='1', subjects=('CoreView_313',),
              smpl_misc_dir=os.path.join(root, 'body_models', 'misc'),
              img_size=(64, 64), orig_img_size=(128, 128))
    jitem, pitem = J(root, **kw)[1], P(root, **kw)[1]
    cfg = small_config()
    params = init_model_params(jax.random.PRNGKey(4), cfg,
                               n_latent_frames=2)
    fd = frame_from_item(jitem)
    gen = generate_sdf(params, cfg, fd.rots, fd.Jtrs, params['latent'][-1])
    lin = jnp.linspace(-1.0, 1.0, 16)
    pts = jnp.stack(jnp.meshgrid(lin, lin, lin, indexing='ij'),
                    -1).reshape(-1, 3)
    shift = jnp.median(siren_apply(gen, pts))
    hypo = params['hypernet']['hypo_init']
    n_w = cfg.hypernet.hidden_features     # the last layer: (1, hidden)
    hypo[-1] = hypo[-1].at[n_w:].add(-shift)
    gen = generate_sdf(params, cfg, fd.rots, fd.Jtrs, params['latent'][-1])
    return params, cfg, jitem, pitem, gen


def port_gen(params, cfg, item):
    from arah_tpu_torch.data.loader import frame_from_item
    from arah_tpu_torch.render.renderer import generate_sdf
    pp = port_params(params)
    fd = frame_from_item(item, 'cpu')
    with torch.no_grad():
        return generate_sdf(pp, port_cfg(cfg), fd.rots, fd.Jtrs,
                            pp['latent'][-1])


def test_sdf_grid_and_mesh_vs_jax(scene):
    from arah_tpu.eval.mesh_vis import _sdf_grid_chunk
    from arah_tpu.utils.meshing import eval_sdf_grid as jgrid
    from arah_tpu import native as jnative
    from arah_tpu_torch import native
    from arah_tpu_torch.utils.meshing import eval_sdf_grid, extract_mesh
    params, cfg, jitem, pitem, jg = scene
    ref = jgrid(lambda p: _sdf_grid_chunk(jg, p), 32)
    gen = port_gen(params, cfg, pitem)
    grid = eval_sdf_grid(gen, 32, chunk=4096)    # 8 chunks
    assert grid.shape == (32, 32, 32)
    d = np.abs(grid - ref)
    assert d.max() <= 1e-5, d.max()
    assert (ref < 0).any() and (ref > 0).any()    # a surface to mesh
    # the port's marching cubes on JAX's grid: JAX's mesh, bit for bit
    sp = 2.0 / 31
    kw = dict(origin=[-1.0, -1.0, -1.0], spacing=[sp] * 3)
    for a, b in zip(native.marching_cubes(ref, 0.0, **kw),
                    jnative.marching_cubes(ref, 0.0, **kw)):
        np.testing.assert_array_equal(a, b)
    verts, faces = extract_mesh(gen, 32)
    assert len(faces) > 100 and verts.dtype == np.float32


@pytest.mark.parametrize('img_size', [48, 64])
def test_normal_maps_vs_jax(scene, img_size):
    from arah_tpu.data.loader import frame_from_item as jframe
    from arah_tpu.eval.mesh_vis import render_normal_maps as jmaps
    from arah_tpu_torch.data.loader import frame_from_item
    from arah_tpu_torch.eval.mesh_vis import render_normal_maps
    params, cfg, jitem, pitem, _ = scene
    ref = jmaps(params, cfg, jframe(jitem), jitem, params['latent'][-1],
                resolution=32, img_size=img_size)
    pp = port_params(params)
    times = {}
    out = render_normal_maps(pp, port_cfg(cfg), frame_from_item(pitem, 'cpu'),
                             pitem, pp['latent'][-1], resolution=32,
                             img_size=img_size, times=times)
    assert set(times) == {'grid', 'marching_cubes', 'skinning', 'rasterize'}
    shapes = [(64, 64, 3), (img_size, img_size, 3), (img_size, img_size, 3)]
    for name, a, b, shape in zip(('posed', 'front', 'back'), out, ref,
                                 shapes):
        b = np.asarray(b)
        assert a.shape == b.shape == shape, name
        fa, fb = a.any(-1), b.any(-1)
        assert fb.sum() > 20, name              # the body is in view
        assert (fa == fb).mean() >= 0.99, (name, (fa != fb).sum())
        assert np.median(np.abs(a - b)) < 1e-5, name
