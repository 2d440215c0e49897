"""The port's pose-only ODP dataset (`data/odp.py`) against the JAX
package's on the CPU, on a fake ZJU fixture whose `models/` sequence
stands in for a novel pose sequence (as the JAX package's end-to-end
test uses it): every key of every item exactly equal (the zero image and
mask give the same box rays and `image_mask`), for two cameras, image
sizes and frame ranges."""
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    from arah_tpu_torch.data.fake_dataset import make_fake_zju_dataset
    root = str(tmp_path_factory.mktemp('fake_zju'))
    make_fake_zju_dataset(root, n_frames=3, views=('1', '7'), img_size=128,
                          n_verts=512, seed=1)
    return root


@pytest.mark.parametrize('cam,size,start,end', [
    ('1', (64, 64), 0, -1), ('7', (96, 80), 1, 3)])
def test_odp_items_vs_jax(root, cam, size, start, end):
    from arah_tpu.data.odp import ODPDataset as J
    from arah_tpu_torch.data.odp import ODPDataset as P
    kw = dict(pose_dir='models', cam_name=cam, img_size=size,
              orig_img_size=128, subjects=('CoreView_313',),
              smpl_misc_dir=os.path.join(root, 'body_models', 'misc'),
              start_frame=start, end_frame=end, box_margin=0.05)
    jds, pds = J(root, **kw), P(root, **kw)
    assert len(jds) == len(pds) == (3 if end < 0 else end - start)
    assert pds.cam_names == [cam] and pds.mode == 'test'
    for i in range(len(jds)):
        a, b = jds[i], pds[i]
        assert sorted(a) == sorted(b)
        assert b['inputs.novel_seq'] is True
        assert b['inputs.image_mask'].shape == size
        assert b['inputs.image_mask'].sum() == len(b['inputs.ray_dirs']) > 0
        for k in a:
            np.testing.assert_array_equal(np.asarray(b[k]),
                                          np.asarray(a[k]), err_msg=k)
