"""The port's H36M and People-Snapshot readers against the JAX package's
on the CPU: the fixture writers (the same files: exact, except the posed
joints and bone transforms, from each side's lbs, to 1e-6, and the JPEGs,
each encoder's own, within 1 level on average), the port's JPEG decoder
at H36M's 1002 x 1000 (not a multiple of the 16-pixel MCU) against
cv2.imread, the items in train and val mode (every key exactly equal;
People-Snapshot also with a distorted camera), and `get_dataset` for all
four dataset types (the same class, image size, records and item 0)."""
import json
import os
import pickle

import cv2
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

ZJU = ('zju', 'CoreView_313')
H36M = ('h36m', 'S9')
SNAP = ('snapshot', 'female-3-casual')


def write(layout, root, **kw):
    """Write `layout`'s fixture at `root` with JAX's writer (jax=True) or
    the port's."""
    import importlib
    jax_side = kw.pop('jax')
    mod = importlib.import_module(
        ('arah_tpu' if jax_side else 'arah_tpu_torch')
        + '.data.fake_dataset')
    fn = {'zju': 'make_fake_zju_dataset', 'h36m': 'make_fake_h36m_dataset',
          'snapshot': 'make_fake_snapshot_dataset'}[layout]
    getattr(mod, fn)(root, **kw)
    return root


KW = {'zju': dict(n_frames=2, views=('1', '7'), img_size=128, n_verts=512,
                  seed=3),
      'h36m': dict(n_frames=2, views=('1', '2'), n_verts=512, seed=3),
      'snapshot': dict(n_frames=2, img_size=96, n_verts=512, seed=3)}


@pytest.fixture(scope='module')
def roots(tmp_path_factory):
    """{layout: (JAX's fixture root, the port's)}."""
    out = {}
    for layout in KW:
        out[layout] = tuple(
            write(layout, str(tmp_path_factory.mktemp(f'{layout}_{s}')),
                  jax=s == 'jax', **KW[layout]) for s in ('jax', 'port'))
    return out


def assert_same_fixture(jroot, proot):
    from arah_tpu_torch.utils.image import read_image
    files = sorted(os.path.relpath(os.path.join(d, f), jroot)
                   for d, _, fs in os.walk(jroot) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), proot)
                           for d, _, fs in os.walk(proot) for f in fs)
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
        elif rel.endswith('.pkl'):
            with open(a, 'rb') as fa, open(b, 'rb') as fb:
                ja, pa = pickle.load(fa), pickle.load(fb)
            assert sorted(ja) == sorted(pa)
            for k in ja:
                np.testing.assert_array_equal(pa[k], ja[k], err_msg=k)
        elif rel.endswith('.png'):
            np.testing.assert_array_equal(read_image(b, gray=True),
                                          read_image(a, gray=True))
        else:
            # the port's JPEG of the same frame: the flat body colour
            ra, rb = read_image(a), read_image(b)
            assert ra.shape == rb.shape
            assert np.abs(ra.astype(int) - rb).mean() < 1.0, rel


@pytest.mark.parametrize('layout', ['h36m', 'snapshot'])
def test_fake_writer_vs_jax(roots, layout):
    assert_same_fixture(*roots[layout])


def test_h36m_jpeg_decode_vs_cv2(roots):
    """The port's decoder at 1002 x 1000 (63 x 63 MCUs, the last row and
    column cropped) on JAX's (OpenCV's) JPEG and on its own."""
    from arah_tpu_torch.utils.image import read_image
    for root in roots['h36m']:
        path = os.path.join(root, 'S9', 'Posing', '1', '000001.jpg')
        img = read_image(path)
        assert img.shape == (1002, 1000, 3)
        np.testing.assert_array_equal(img, cv2.imread(path)[..., ::-1])


def datasets(layout, root, mode, **kw):
    import arah_tpu.data.human_video as jh
    import arah_tpu_torch.data.human_video as ph
    name = {'zju': 'ZJUMoCapDataset', 'h36m': 'H36MDataset',
            'snapshot': 'PeopleSnapshotDataset'}[layout]
    subject = {'zju': 'CoreView_313', 'h36m': 'S9',
               'snapshot': 'female-3-casual'}[layout]
    kw = dict(smpl_misc_dir=os.path.join(root, 'body_models', 'misc'),
              subjects=(subject,), mode=mode, num_fg_samples=32,
              num_bg_samples=32, sample_reg_surface=True,
              sample_inside=True, seed=5, **kw)
    return getattr(jh, name)(root, **kw), getattr(ph, name)(root, **kw)


def assert_same_items(jds, pds):
    assert len(jds) == len(pds) > 0
    for i in range(len(jds)):
        a, b = jds[i], pds[i]
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(b[k]),
                                          np.asarray(a[k]), err_msg=k)


@pytest.mark.parametrize('layout,mode,size', [
    ('h36m', 'train', None), ('h36m', 'val', (96, 96)),
    ('snapshot', 'train', (64, 64)), ('snapshot', 'val', None)])
def test_items_vs_jax(roots, layout, mode, size):
    kw = {} if size is None else {'img_size': size}
    if layout == 'h36m':
        kw['views'] = ('1', '2')
    jds, pds = datasets(layout, roots[layout][0], mode, **kw)
    assert pds.img_size == jds.img_size == (
        size or {'h36m': (1002, 1000), 'snapshot': (1080, 1080)}[layout])
    assert_same_items(jds, pds)


def test_snapshot_distorted_vs_jax(roots, tmp_path):
    """People-Snapshot's camera_k is used: a non-zero one undistorts each
    image and mask, as JAX's OpenCV call does."""
    import shutil
    root = str(tmp_path / 'snap')
    shutil.copytree(roots['snapshot'][1], root)
    path = os.path.join(root, 'female-3-casual', 'camera.pkl')
    with open(path, 'rb') as f:
        cam = pickle.load(f)
    cam['camera_k'] = np.array([-0.2, 0.05, 0.0, 0.0, 0.0])
    cam['camera_f'] = np.array([120.0, 120.0])
    with open(path, 'wb') as f:
        pickle.dump(cam, f)
    jds, pds = datasets('snapshot', root, 'val', img_size=(64, 64))
    assert pds.cameras['0']['D'] == [-0.2, 0.05, 0.0, 0.0, 0.0]
    assert_same_items(jds, pds)


def config(layout, root, **data):
    cfg = {'data': {'dataset': {'zju': 'zju_mocap', 'h36m': 'h36m',
                                'snapshot': 'people_snapshot',
                                'odp': 'zju_mocap_odp'}[layout],
                    'path': root,
                    'smpl_misc': os.path.join(root, 'body_models', 'misc'),
                    'num_fg_samples': 16, 'num_bg_samples': 16,
                    'sample_reg_surface': True, 'erode_mask': False,
                    'pose_dir': 'models', **data},
           'training': {'inside_weight': 10.0}}
    subject = {'zju': 'CoreView_313', 'odp': 'CoreView_313', 'h36m': 'S9',
               'snapshot': 'female-3-casual'}[layout]
    for m in ('train', 'val', 'test'):
        cfg['data'][f'{m}_split'] = [subject]
    return cfg


@pytest.mark.parametrize('layout,mode,want', [
    ('zju', 'train', (512, 512)), ('h36m', 'val', (1002, 1000)),
    ('snapshot', 'train', (540, 540)), ('odp', 'test', (512, 512))])
def test_get_dataset_vs_jax(roots, layout, mode, want):
    """The factory builds each type as JAX's does: the class, the image
    size (People-Snapshot (540, 540) unless `high_res`, and then only in
    training), the records, and item 0."""
    from arah_tpu.config.factory import get_dataset as jget
    from arah_tpu_torch.config.factory import get_dataset
    root = roots['zju' if layout == 'odp' else layout][1]
    views = {'zju': ['1', '7'], 'odp': ['1'], 'h36m': ['1', '2'],
             'snapshot': ['0']}[layout]
    cfg = config(layout, root, **{f'{mode}_views': views})
    jds, pds = jget(mode, cfg), get_dataset(mode, cfg)
    assert type(pds).__name__ == type(jds).__name__
    assert pds.img_size == jds.img_size == want
    assert pds.data == jds.data
    if layout == 'snapshot':
        hi = config(layout, root, high_res=True)
        assert get_dataset('train', hi).img_size == (1080, 1080)
        assert get_dataset('val', hi).img_size == (540, 540)
    jds.rng.seed(8)
    pds.rng.seed(8)
    a, b = jds[0], pds[0]
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]),
                                      err_msg=k)
