"""The port's dataset preparation (`arah_tpu_torch/preprocess/`) and raw
fixture writers on the CPU, against the JAX package's:

  * the raw ZJU-MoCap and H36M writers (`data/fake_dataset.py:
    make_fake_raw_zju`, `make_fake_raw_h36m`) write JAX's files for the
    same arguments: `annots.npy` and `new_params` equal, `new_vertices`
    within 1e-6 (each package's lbs), PNG masks equal (ZJU's) or equal
    but on the one edge pixel that the vertices' roundoff flips (H36M's,
    `assert_same_mask`), JPEGs within
    1 level on average (each its own encoder): the rule of
    `test_torch_datasets.py:assert_same_fixture`;
  * both packages' ZJU and H36M scripts on one raw tree written by JAX's
    writer give the same file set, `cam_params.json` and images
    byte-equal and every npz field within 1e-5; the refit translation
    recovers the writer's vertex shift within 1e-4;
  * the port's datasets load the port's output of its own raw tree;
  * `extract_smpl_parameters` round-trips the SMPL pickle layout;
  * AIST++ retargeting as `tests/test_preprocess.py` holds JAX's, with
    JAX's and the port's records within 1e-5, loaded by `ODPDataset`;
  * `--device cuda` without a GPU raises.
The scripts run in this process (`main(argv)`; JAX's with its argv)."""
import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from test_torch_cli import REPO

torch.set_num_threads(2)

ZJU = dict(n_frames=2, views=('1', '7'), img_size=256, n_verts=512,
           verts_offset=0.05)
H36M = dict(n_frames=2, img_size=256, n_verts=512, verts_offset=0.04)


def run_jax(module, argv):
    """A JAX preprocessing script's main() with `argv`."""
    import importlib
    sys.path.insert(0, REPO)
    mod = importlib.import_module(f'preprocess.{module}')
    saved = sys.argv
    sys.argv = [module] + argv
    try:
        mod.main()
    finally:
        sys.argv = saved


def run_port(module, argv):
    import importlib
    importlib.import_module(f'arah_tpu_torch.preprocess.{module}').main(
        argv + ['--device', 'cpu'])


def tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def assert_same_raw(jroot, proot, edge_flips=0):
    """The raw writers' rule (`assert_same_fixture`'s, with the pickled
    `.npy` dicts); at most `edge_flips` mask pixels in the whole tree may
    differ, each on a silhouette's edge (`assert_same_mask`)."""
    from arah_tpu_torch.utils.image import read_image
    files = tree_files(jroot)
    assert files == tree_files(proot)
    flips = 0
    for rel in files:
        a, b = os.path.join(jroot, rel), os.path.join(proot, rel)
        if rel.endswith('.npz'):
            ja, pa = np.load(a), np.load(b)
            assert sorted(ja) == sorted(pa)
            for k in ja:
                np.testing.assert_array_equal(pa[k], ja[k], err_msg=rel)
        elif rel.endswith('.npy'):
            ja = np.load(a, allow_pickle=True)
            pa = np.load(b, allow_pickle=True)
            if ja.dtype == object:
                ja, pa = ja.item(), pa.item()
                assert json.dumps(ja, sort_keys=True, default=np.ndarray.
                                  tolist) == json.dumps(
                    pa, sort_keys=True, default=np.ndarray.tolist), rel
            else:
                tol = 1e-6 if 'new_vertices' in rel else 0
                np.testing.assert_allclose(pa, ja, rtol=0, atol=tol,
                                           err_msg=rel)
        elif rel.endswith('.png'):
            flips += assert_same_mask(read_image(a, gray=True),
                                      read_image(b, gray=True), rel)
        else:
            ra, rb = read_image(a), read_image(b)
            assert ra.shape == rb.shape
            assert np.abs(ra.astype(int) - rb).mean() < 1.0, rel
    assert flips <= edge_flips, (jroot, flips)


def assert_same_mask(ja, pa, rel):
    """The number of pixels in which two masks differ, each of which must
    lie on the edge of JAX's silhouette (both values in its 3 x 3
    neighbourhood): the two packages' lbs give posed vertices 1e-7 apart,
    so the rasteriser may flip a pixel whose centre lies within that
    roundoff of the edge (one of 65,536 in one of the H36M writer's 20
    masks at these sizes)."""
    assert ja.shape == pa.shape, rel
    diff = np.argwhere(ja != pa)
    for y, x in diff:
        nb = ja[max(y - 1, 0):y + 2, max(x - 1, 0):x + 2]
        assert nb.min() != nb.max(), (rel, y, x)
    return len(diff)


def assert_same_output(jroot, proot, tol=1e-5):
    """The preprocessing scripts' outputs: the same files, JSON and
    images byte-equal, npz fields within `tol`."""
    files = tree_files(jroot)
    assert files == tree_files(proot)
    for rel in files:
        a, b = os.path.join(jroot, rel), os.path.join(proot, rel)
        if rel.endswith('.npz'):
            ja, pa = np.load(a), np.load(b)
            assert sorted(ja) == sorted(pa), rel
            for k in ja:
                assert pa[k].dtype == ja[k].dtype and \
                    pa[k].shape == ja[k].shape, (rel, k)
                np.testing.assert_allclose(pa[k], ja[k], rtol=0, atol=tol,
                                           err_msg=f'{rel}:{k}')
        else:
            with open(a, 'rb') as fa, open(b, 'rb') as fb:
                assert fa.read() == fb.read(), rel


@pytest.fixture(scope='module')
def trees(tmp_path_factory):
    """{layout: (JAX's raw tree, the port's raw tree, JAX's output, the
    port's output of JAX's raw tree, the port's output of its own raw
    tree, misc dir)}."""
    from arah_tpu.data import fake_dataset as jf
    from arah_tpu_torch.data import fake_dataset as pf
    out = {}
    for layout, kw, writer, script, seq in (
            ('zju', ZJU, 'make_fake_raw_zju', 'preprocess_zju_mocap',
             'CoreView_313'),
            ('h36m', H36M, 'make_fake_raw_h36m', 'preprocess_h36m', 'S9')):
        d = tmp_path_factory.mktemp(layout)
        jraw, praw = str(d / 'jraw'), str(d / 'praw')
        misc, _ = getattr(jf, writer)(jraw, **kw)
        getattr(pf, writer)(praw, **kw)
        dirs = [str(d / n) for n in ('jout', 'pout', 'pown')]
        for fn, raw, o in ((run_jax, jraw, dirs[0]), (run_port, jraw, dirs[1]),
                           (run_port, praw, dirs[2])):
            fn(script, ['--data-dir', raw, '--out-dir', o, '--seqname', seq,
                        '--smpl-misc', os.path.join(raw, 'body_models',
                                                    'misc')])
        out[layout] = (jraw, praw, *dirs, misc)
    return out


@pytest.mark.parametrize('layout', ['zju', 'h36m'])
def test_raw_writer_vs_jax(trees, layout):
    assert_same_raw(*trees[layout][:2],
                    edge_flips=1 if layout == 'h36m' else 0)


@pytest.mark.parametrize('layout', ['zju', 'h36m'])
def test_scripts_vs_jax(trees, layout):
    _, _, jout, pout, _, _ = trees[layout]
    assert_same_output(jout, pout)
    with open(os.path.join(pout, *(('CoreView_313',) if layout == 'zju'
                                   else ('S9', 'Posing')),
                           'cam_params.json')) as f:
        cams = json.load(f)
    if layout == 'zju':
        assert len(cams['all_cam_names']) == 21
    else:
        assert cams['all_cam_names'] == ['54138969', '55011271']
    assert all(np.linalg.norm(np.asarray(cams[c]['T'])) < 100.0
               for c in cams['all_cam_names'])


@pytest.mark.parametrize('layout', ['zju', 'h36m'])
def test_refit_recovers_the_shift(trees, layout):
    from arah_tpu_torch.core.smpl import load_smpl_assets
    from arah_tpu_torch.preprocess.smpl_frames import posed_vertices
    jraw, _, _, pout, _, misc = trees[layout]
    seq = ('CoreView_313',) if layout == 'zju' else ('S9', 'Posing')
    fidx = 1 if layout == 'zju' else 5
    rec = dict(np.load(os.path.join(pout, *seq, 'models',
                                    f'{fidx:06d}.npz')))
    raw = os.path.join(jraw, *seq)
    params = np.load(os.path.join(raw, 'new_params', f'{fidx}.npy'),
                     allow_pickle=True).item()
    shift = rec['trans'] - np.asarray(params['Th']).reshape(3)
    off = (ZJU if layout == 'zju' else H36M)['verts_offset']
    np.testing.assert_allclose(shift, off, atol=1e-4)
    model = load_smpl_assets(misc, 'neutral', device='cpu')
    target = np.load(os.path.join(raw, 'new_vertices', f'{fidx}.npy'))
    assert np.abs(posed_vertices(model, rec, 'cpu') - target).max() < 1e-4


def test_datasets_load_the_port_output(trees):
    from arah_tpu_torch.data.human_video import H36MDataset, ZJUMoCapDataset
    for layout, cls, subject, views in (
            ('zju', ZJUMoCapDataset, 'CoreView_313', ('1', '7')),
            ('h36m', H36MDataset, 'S9', ('54138969', '55011271'))):
        _, praw, _, _, pown, _ = trees[layout]
        ds = cls(pown, smpl_misc_dir=os.path.join(praw, 'body_models',
                                                  'misc'),
                 subjects=(subject,), mode='train', img_size=(128, 128),
                 num_fg_samples=64, num_bg_samples=64,
                 sample_reg_surface=True, sample_inside=True,
                 erode_mask=False, seed=0, views=views)
        assert len(ds) == 4                      # 2 frames x 2 views
        item = ds[0]
        assert item['inputs'].shape == (128, 3)
        assert item['inputs.mask'][:64].mean() > 0.9
        np.testing.assert_allclose(
            np.linalg.norm(item['inputs.ray_dirs'], axis=-1), 1.0,
            atol=1e-5)


def test_extract_smpl_parameters(tmp_path):
    """SMPL model.pkl files of the official field layout, from the
    synthetic body, through the port's script: `load_smpl_assets` sees
    the same model (lbs within 1e-5)."""
    from arah_tpu_torch.core.smpl import (lbs, load_smpl_assets,
                                          smpl_to_device)
    from arah_tpu_torch.data.synthetic import synthetic_smpl
    from arah_tpu_torch.preprocess import extract_smpl_parameters
    model = synthetic_smpl(n_verts=256)
    nv = int(np.asarray(model.v_template).shape[0])
    smpl_dir = tmp_path / 'smpl'
    for g in ('male', 'female', 'neutral'):
        d = {
            'v_template': np.asarray(model.v_template, np.float64),
            # official pickles carry 300 shape dirs; the script keeps 10
            'shapedirs': np.concatenate(
                [np.asarray(model.shapedirs, np.float64),
                 np.zeros((nv, 3, 290))], axis=-1),
            'posedirs': np.asarray(model.posedirs, np.float64
                                   ).T.reshape(nv, 3, 207),
            'J_regressor': np.asarray(model.J_regressor, np.float64),
            'weights': np.asarray(model.lbs_weights, np.float64),
            'f': np.asarray(model.faces, np.int64),
            'kintree_table': np.stack(
                [np.asarray(model.parents), np.arange(24)]).astype(np.int64),
        }
        os.makedirs(smpl_dir / g)
        with open(smpl_dir / g / 'model.pkl', 'wb') as f:
            pickle.dump(d, f)
    out = str(tmp_path / 'misc')
    extract_smpl_parameters.main(['--smpl-dir', str(smpl_dir),
                                  '--out-dir', out])
    loaded = load_smpl_assets(out, 'neutral', device='cpu')
    rng = np.random.RandomState(0)
    betas = torch.as_tensor(rng.randn(1, 10).astype(np.float32) * 0.2)
    pose = torch.as_tensor(rng.randn(1, 72).astype(np.float32) * 0.2)
    with torch.no_grad():
        ref = lbs(smpl_to_device(model, 'cpu'), betas, pose)
        got = lbs(loaded, betas, pose)
    np.testing.assert_allclose(got.verts.numpy(), ref.verts.numpy(),
                               atol=1e-5)


def test_aist_retarget_vs_jax(trees, tmp_path):
    """A fake AIST++ motion retargeted onto the preprocessed fake-ZJU
    subject by both packages: every second pose, finite records within
    1e-5 of JAX's, and the port's `ODPDataset` loads them."""
    from arah_tpu_torch.data.odp import ODPDataset
    _, _, jout, _, _, misc = trees['zju']
    rng = np.random.RandomState(1)
    motion = {'smpl_poses': (rng.randn(6, 72) * 0.1).astype(np.float32)}
    aist = tmp_path / 'aist'
    os.makedirs(aist)
    with open(aist / 'gBR_sBM_c01.pkl', 'wb') as f:
        pickle.dump(motion, f)
    roots = {}
    for name, fn in (('jax', run_jax), ('port', run_port)):
        roots[name] = str(tmp_path / name)
        fn('preprocess_aist', ['--data-dir', str(aist), '--seqname',
                               'gBR_sBM_c01', '--in-dataset', jout,
                               '--subject', 'CoreView_313', '--out-dir',
                               roots[name], '--view', '1', '--smpl-misc',
                               misc])
    assert_same_output(roots['jax'], roots['port'])
    pose_dir = os.path.join(roots['port'], 'CoreView_313',
                            'gBR_sBM_c01_view1')
    assert len([f for f in os.listdir(pose_dir) if f.endswith('.npz')]) == 3
    rec = dict(np.load(os.path.join(pose_dir, '000000.npz')))
    for k in ('minimal_shape', 'bone_transforms', 'Jtr_posed', 'trans'):
        assert np.isfinite(rec[k]).all(), k
    ds = ODPDataset(roots['port'], pose_dir='gBR_sBM_c01_view1',
                    cam_name='1', img_size=(128, 128),
                    orig_img_size=(256, 256), smpl_misc_dir=misc,
                    subjects=('CoreView_313',), seed=0)
    assert len(ds) == 3
    assert np.isfinite(ds[0]['inputs.ray_dirs']).all()


@pytest.mark.skipif(torch.cuda.is_available(), reason='a GPU is present')
@pytest.mark.parametrize('module', ['preprocess_zju_mocap',
                                    'preprocess_h36m', 'preprocess_aist'])
def test_cuda_without_a_gpu_raises(tmp_path, module):
    import importlib
    mod = importlib.import_module(f'arah_tpu_torch.preprocess.{module}')
    argv = ['--data-dir', str(tmp_path), '--out-dir', str(tmp_path / 'o')]
    if module == 'preprocess_aist':
        argv += ['--seqname', 's', '--in-dataset', str(tmp_path)]
    with pytest.raises(RuntimeError, match='no CUDA device'):
        mod.main(argv + ['--device', 'cuda'])
