"""The port's lens undistortion (`utils/image.py:undistort`, the pixel
loop in `native/codec.cpp`) against `cv2.undistort(img, K, D, None)`:
bit-equal on uint8 gray and RGB images, at odd sizes, at H36M's 1002 x
1000 and at a cropped (strided) view of it, for three coefficient sets
(one of them ZJU-MoCap-like, with tangential terms); and a ZJU item whose
camera has distortion equal to the JAX package's, field for field, in
train and val mode (JAX undistorts with OpenCV)."""
import json
import os

import cv2
import numpy as np
import pytest

# (k1, k2, p1, p2, k3): barrel, pincushion with k3, ZJU-MoCap-like
DISTORTIONS = {
    'barrel': [-0.2, 0.05, 0.0, 0.0, 0.0],
    'pincushion': [0.1, -0.03, 0.001, -0.002, 0.01],
    'zju': [-0.34, 0.14, 0.0006, -0.0004, -0.03],
}


def camera(h, w):
    return np.array([[w * 0.9, 0, w / 2 - 0.3], [0, w * 0.91, h / 2 + 0.2],
                     [0, 0, 1]], np.float32)


@pytest.mark.parametrize('size', [(47, 61), (1002, 1000), 'crop'])
@pytest.mark.parametrize('channels', [0, 3])
@pytest.mark.parametrize('dist', sorted(DISTORTIONS))
def test_undistort_vs_cv2(size, channels, dist):
    from arah_tpu_torch.utils.image import undistort
    rng = np.random.RandomState(len(dist) + channels)
    h, w = (1002, 1000) if size == 'crop' else size
    img = rng.randint(0, 256, (h, w, channels) if channels else (h, w)
                      ).astype(np.uint8)
    if size == 'crop':
        img = img[1:-1, 3:]        # a strided view, 1000 x 997
    K = camera(*img.shape[:2])
    D = np.asarray(DISTORTIONS[dist], np.float32)
    ref = cv2.undistort(img, K, D, None)
    out = undistort(img, K, D)
    assert out.shape == ref.shape and out.dtype == np.uint8
    np.testing.assert_array_equal(out, ref)


def test_undistort_labels_and_short_d():
    """A 0/1/100 label mask as the dataset undistorts it, and a 4-entry D
    (k3 = 0), as cv2 reads one."""
    from arah_tpu_torch.utils.image import undistort
    rng = np.random.RandomState(7)
    mask = np.zeros((90, 120), np.uint8)
    mask[20:70, 30:100] = 1
    mask[rng.rand(90, 120) < 0.05] = 100
    K = camera(90, 120)
    D = np.asarray(DISTORTIONS['zju'][:4], np.float32)
    np.testing.assert_array_equal(undistort(mask, K, D),
                                  cv2.undistort(mask, K, D, None))
    with pytest.raises(ValueError):
        undistort(mask, K, np.ones(8, np.float32))


@pytest.fixture(scope='module')
def distorted(tmp_path_factory):
    """A fake ZJU fixture (JAX's writer) whose camera 1 has the ZJU-like
    distortion."""
    from arah_tpu.data.fake_dataset import make_fake_zju_dataset
    root = str(tmp_path_factory.mktemp('zju_d'))
    make_fake_zju_dataset(root, n_frames=2, views=('1', '7'), img_size=128,
                          n_verts=512, seed=4)
    cams = os.path.join(root, 'CoreView_313', 'cam_params.json')
    with open(cams) as f:
        c = json.load(f)
    c['1']['D'] = DISTORTIONS['zju']
    with open(cams, 'w') as f:
        json.dump(c, f)
    return root


@pytest.mark.parametrize('mode', ['train', 'val'])
def test_distorted_items_vs_jax(distorted, mode):
    from arah_tpu.data.human_video import ZJUMoCapDataset as J
    from arah_tpu_torch.data.human_video import ZJUMoCapDataset as P
    kw = dict(smpl_misc_dir=os.path.join(distorted, 'body_models', 'misc'),
              subjects=('CoreView_313',), mode=mode, img_size=(64, 64),
              num_fg_samples=32, num_bg_samples=32, views=('1', '7'),
              sample_reg_surface=True, erode_mask=True, seed=6)
    jds, pds = J(distorted, **kw), P(distorted, **kw)
    assert len(jds) == len(pds) == 4
    for i in range(len(jds)):
        a, b = jds[i], pds[i]
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(b[k]),
                                          np.asarray(a[k]), err_msg=k)


def test_distorted_item_needs_undistort(distorted, monkeypatch):
    """The fixture's distortion moves the item: without the undistortion
    the port's val item would differ from JAX's."""
    from arah_tpu.data.human_video import ZJUMoCapDataset as J
    from arah_tpu_torch.data import human_video
    kw = dict(smpl_misc_dir=os.path.join(distorted, 'body_models', 'misc'),
              subjects=('CoreView_313',), mode='val', img_size=(64, 64),
              views=('1',), seed=6)
    a = J(distorted, **kw)[0]
    monkeypatch.setattr(human_video, 'undistort', lambda img, K, D: img)
    b = human_video.ZJUMoCapDataset(distorted, **kw)[0]
    assert not np.array_equal(a['inputs'], b['inputs'])
