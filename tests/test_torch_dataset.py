"""The port's host data path against the JAX package's on the CPU, on a
fake ZJU-layout dataset written under a temporary directory: the native
library (the port's copy of `arah_tpu/native`) bit for bit on random
meshes, `core/smpl.py:lbs` (to 1e-5), the fake dataset writer (the same
masks, cameras and SMPL files: exact, except the posed joints and bone
transforms, which come from each side's lbs, to 1e-6), the
`ZJUMoCapDataset` items in train and val mode (every key exactly equal:
the port reads the JPEGs and resizes as OpenCV does, to the bit; a
camera with distortion: `test_torch_undistort.py`), and
`evaluate_frame` (psnr within 0.05 dB, ssim within 1e-3, the rendered
colour and normal images pixel by pixel, at the parameters
`params_from_jax` moves across)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_renderer import small_config
from torch_port_util import port_cfg, port_params

torch.set_num_threads(2)


def random_mesh(rng, n=60):
    """A closed star-shaped mesh: a jittered UV sphere."""
    from arah_tpu_torch.data.synthetic import _capsule_mesh
    v, f = _capsule_mesh(rng.uniform(-0.3, 0.0, 3), rng.uniform(0.1, 0.5, 3),
                         rng.uniform(0.1, 0.3))
    return (v + rng.randn(*v.shape) * 0.01).astype(np.float32), \
        np.asarray(f, np.int32)


@pytest.mark.parametrize('seed', range(3))
def test_native_vs_jax(seed):
    from arah_tpu import native as jn
    from arah_tpu_torch import native as pn
    rng = np.random.RandomState(seed)
    v, f = random_mesh(rng)
    pts = rng.uniform(-0.6, 0.7, (500, 3)).astype(np.float32)
    np.testing.assert_array_equal(pn.MeshIntersector(v, f).query(pts),
                                  jn.MeshIntersector(v, f).query(pts))
    for a, b in zip(pn.point_mesh_squared_distance(pts, v, f),
                    jn.point_mesh_squared_distance(pts, v, f)):
        np.testing.assert_array_equal(a, b)
    grid = rng.randn(9, 10, 11).astype(np.float32)
    for a, b in zip(pn.marching_cubes(grid, 0.1, [0, 1, 2], [0.5, 1, 2]),
                    jn.marching_cubes(grid, 0.1, [0, 1, 2], [0.5, 1, 2])):
        np.testing.assert_array_equal(a, b)
    proj = rng.uniform(0, 40, (len(v), 2)).astype(np.float32)
    depth = rng.uniform(1, 2, len(v)).astype(np.float32)
    for a, b in zip(pn.rasterize_mesh(proj, depth, f, 32, 48),
                    jn.rasterize_mesh(proj, depth, f, 32, 48)):
        np.testing.assert_array_equal(a, b)


def test_lbs_vs_jax():
    from arah_tpu.core.smpl import lbs as jlbs
    from arah_tpu.data.synthetic import synthetic_smpl
    from arah_tpu_torch.core.smpl import SmplModel, lbs, smpl_to_device
    model = synthetic_smpl(n_verts=512)
    rng = np.random.RandomState(0)
    betas = (rng.randn(2, 10) * 0.3).astype(np.float32)
    pose = (rng.randn(2, 72) * 0.3).astype(np.float32)
    ref = jlbs(model, jnp.asarray(betas), jnp.asarray(pose))
    out = lbs(smpl_to_device(SmplModel(*(np.asarray(a) for a in model)),
                             'cpu'),
              torch.as_tensor(betas), torch.as_tensor(pose))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


@pytest.fixture(scope='module')
def fixtures(tmp_path_factory):
    """(JAX's fixture root, the port's): 2 frames x views 1 and 7, 128 x
    128 images, 512 vertices, seed 3."""
    from arah_tpu.data.fake_dataset import make_fake_zju_dataset as jmake
    from arah_tpu_torch.data.fake_dataset import make_fake_zju_dataset
    jroot = str(tmp_path_factory.mktemp('jax_zju'))
    proot = str(tmp_path_factory.mktemp('port_zju'))
    kw = dict(n_frames=2, views=('1', '7'), img_size=128, n_verts=512,
              seed=3)
    jmake(jroot, **kw)
    make_fake_zju_dataset(proot, **kw)
    return jroot, proot


def test_fake_writer_vs_jax(fixtures):
    from arah_tpu_torch.utils.image import read_image
    jroot, proot = fixtures
    files = sorted(os.path.relpath(os.path.join(d, f), jroot)
                   for d, _, fs in os.walk(jroot) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), proot)
                           for d, _, fs in os.walk(proot) for f in fs)
    assert sum(f.endswith('.png') for f in files) == 4
    for rel in files:
        a, b = os.path.join(jroot, rel), os.path.join(proot, rel)
        if rel.endswith('.npz'):
            ja, pa = np.load(a), np.load(b)
            assert sorted(ja) == sorted(pa)
            for k in ja:
                tol = 1e-6 if k in ('Jtr_posed', 'bone_transforms') else 0
                np.testing.assert_allclose(pa[k], ja[k], rtol=0, atol=tol,
                                           err_msg=f'{rel}:{k}')
        elif rel.endswith('.npy'):
            np.testing.assert_array_equal(np.load(b), np.load(a))
        elif rel.endswith('.json'):
            with open(a) as fa, open(b) as fb:
                assert json.load(fa) == json.load(fb)
        elif rel.endswith('.png'):
            np.testing.assert_array_equal(read_image(b, gray=True),
                                          read_image(a, gray=True))
        else:
            # the port's JPEG of the same frame: the flat body colour
            ra, rb = read_image(a), read_image(b)
            assert np.abs(ra.astype(int) - rb).mean() < 1.0, rel


def _datasets(root, mode, **kw):
    from arah_tpu.data.human_video import ZJUMoCapDataset as J
    from arah_tpu_torch.data.human_video import ZJUMoCapDataset as P
    kw = dict(smpl_misc_dir=os.path.join(root, 'body_models', 'misc'),
              subjects=('CoreView_313',), mode=mode, img_size=(64, 64),
              num_fg_samples=32, num_bg_samples=32, views=('1', '7'),
              sample_reg_surface=True, sample_inside=True, seed=5, **kw)
    return J(root, **kw), P(root, **kw)


@pytest.mark.parametrize('mode,erode', [('train', False), ('train', True),
                                        ('val', False)])
def test_items_vs_jax(fixtures, mode, erode):
    jds, pds = _datasets(fixtures[0], mode, erode_mask=erode)
    assert len(jds) == len(pds) == 4
    for i in range(len(jds)):
        a, b = jds[i], pds[i]
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(b[k]),
                                          np.asarray(a[k]), err_msg=k)


def test_evaluate_frame_vs_jax(fixtures):
    from arah_tpu.eval.evaluator import evaluate_frame as jeval
    from arah_tpu.model import init_model_params
    from arah_tpu_torch.eval.evaluator import evaluate_frame
    jds, pds = _datasets(fixtures[0], 'val')
    cfg = small_config()
    params = init_model_params(jax.random.PRNGKey(0), cfg,
                               n_latent_frames=2)
    item = jds[0]
    n = len(item['inputs.ray_dirs'])
    ref = jeval(params, cfg, item, params['latent'][0], chunk=256)
    pp = port_params(params)
    out = evaluate_frame(pp, port_cfg(cfg), pds[0], pp['latent'][0],
                         chunk=256)
    assert n > 256     # several chunks, the last one padded
    assert np.isfinite(out['psnr'])
    assert abs(out['psnr'] - ref['psnr']) <= 0.05, (out['psnr'],
                                                    ref['psnr'])
    assert abs(out['ssim'] - ref['ssim']) <= 1e-3
    assert out['rgb_pred'].shape == ref['rgb_pred'].shape == (64, 64, 3)
    np.testing.assert_array_equal(out['rgb_gt'], np.asarray(ref['rgb_gt']))
    # pixel by pixel: the colours to float roundoff (max |d| 1.5e-5 here);
    # the normal image on the same converged pixels, its finite differences
    # of depth amplifying roundoff at a few (p99 2.4e-5, max 3.1e-3 here)
    d = np.abs(out['rgb_pred'] - np.asarray(ref['rgb_pred']))
    assert np.median(d) <= 1e-6 and d.max() <= 1e-4, (np.median(d), d.max())
    npred, nref = out['normal_pred'], np.asarray(ref['normal_pred'])
    np.testing.assert_array_equal(np.abs(npred).sum(-1) > 0,
                                  np.abs(nref).sum(-1) > 0)
    d = np.abs(npred - nref)
    assert np.quantile(d, .99) <= 1e-4 and d.max() <= 1e-2, (
        np.quantile(d, .99), d.max())
