"""The port's image code (`utils/image.py`, `native/codec.cpp`) against
OpenCV on the CPU, on uint8 images made from numpy seeds: PNG and JPEG
decoding give `cv2.imread`'s bytes exactly (the JPEG decoder ports
libjpeg's integer islow IDCT, its fancy upsampling and its fixed-point
colour conversion, so no tolerance is needed), `cv2.imread` reads the
port's PNGs back exactly and decodes its JPEGs within the quality-95
error of OpenCV's own encoder, and the resize, morphology and polygon
fill equal OpenCV's output exactly, at the fixture's 1024 -> 256
downscale and on its bounding boxes too."""
import os

import cv2
import numpy as np
import pytest

from arah_tpu_torch.utils import image as im


def smooth_rgb(rng, h, w, noise=20.0):
    y, x = np.mgrid[:h, :w]
    img = np.stack([128 + 100 * np.sin(x / 17.0 + c) * np.cos(y / 23.0)
                    for c in range(3)], -1)
    return np.clip(img + rng.randn(h, w, 3) * noise, 0, 255).astype(
        np.uint8)


@pytest.mark.parametrize('shape,level', [((37, 53), 1), ((37, 53), 9),
                                         ((64, 80, 3), 1), ((64, 80, 3), 9),
                                         ((256, 256), 3)])
def test_png_vs_cv2(tmp_path, shape, level):
    """cv2-written PNGs (its adaptive filters: every filter type shows
    up in noise) decode to the source; cv2 reads the port's PNGs."""
    rng = np.random.RandomState(level)
    a = (rng.rand(*shape) * 255).astype(np.uint8)
    p = str(tmp_path / 'a.png')
    cv2.imwrite(p, a if a.ndim == 2 else a[..., ::-1],
                [cv2.IMWRITE_PNG_COMPRESSION, level])
    np.testing.assert_array_equal(im.read_image(p, gray=a.ndim == 2), a)
    q = str(tmp_path / 'b.png')
    im.write_image(q, a)
    back = cv2.imread(q, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(back if a.ndim == 2 else back[..., ::-1],
                                  a)


JPEG_PARAMS = {
    '420': [],
    '444': [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444],
    'restart': [cv2.IMWRITE_JPEG_RST_INTERVAL, 3],
    'q60': [cv2.IMWRITE_JPEG_QUALITY, 60],
}


@pytest.mark.parametrize('size', [(64, 64), (37, 53), (256, 200)])
@pytest.mark.parametrize('kind', sorted(JPEG_PARAMS))
def test_jpeg_decode_vs_cv2(tmp_path, size, kind):
    rng = np.random.RandomState(size[0])
    a = smooth_rgb(rng, *size)
    p = str(tmp_path / 'a.jpg')
    cv2.imwrite(p, a[..., ::-1], JPEG_PARAMS[kind])
    np.testing.assert_array_equal(im.read_image(p), cv2.imread(p)[..., ::-1])
    g = str(tmp_path / 'g.jpg')
    cv2.imwrite(g, a[..., 1], JPEG_PARAMS[kind])
    np.testing.assert_array_equal(im.read_image(g, gray=True),
                                  cv2.imread(g, cv2.IMREAD_GRAYSCALE))


def test_fixture_jpeg_vs_cv2(tmp_path):
    """A fixture frame as JAX's writer makes it (cv2, a flat silhouette on
    black, 1024 x 1024): the same bytes as cv2.imread."""
    sil = np.zeros((1024, 1024), np.uint8)
    im.fill_poly(sil, [[300, 100], [700, 150], [650, 900], [350, 950]], 1)
    img = np.zeros((1024, 1024, 3), np.uint8)
    img[sil > 0] = (180, 120, 90)
    p = str(tmp_path / 'f.jpg')
    cv2.imwrite(p, img)
    np.testing.assert_array_equal(im.read_image(p), cv2.imread(p)[..., ::-1])


@pytest.mark.parametrize('size', [(64, 64), (37, 53), (256, 200)])
def test_jpeg_encode_read_by_cv2(tmp_path, size):
    """cv2 decodes the port's JPEGs to what the port decodes, within
    OpenCV's own quality-95 error of the source (+5%)."""
    rng = np.random.RandomState(size[1])
    a = smooth_rgb(rng, *size)
    mine, ref = str(tmp_path / 'm.jpg'), str(tmp_path / 'r.jpg')
    im.write_image(mine, a)
    cv2.imwrite(ref, a[..., ::-1])
    back = cv2.imread(mine)[..., ::-1]
    np.testing.assert_array_equal(back, im.read_image(mine))
    err = np.abs(back.astype(int) - a).mean()
    err_cv2 = np.abs(cv2.imread(ref)[..., ::-1].astype(int) - a).mean()
    assert err <= 1.05 * err_cv2, (err, err_cv2)


@pytest.mark.parametrize('src,dst,ch', [
    ((1024, 1024), (256, 256), 3), ((1024, 1024), (256, 256), 0),
    ((100, 80), (37, 53), 3), ((37, 53), (100, 80), 3),
    ((64, 64), (32, 32), 3), ((50, 70), (50, 35), 0),
    ((1002, 1000), (512, 512), 3), ((20, 20), (7, 3), 0)])
def test_resize_vs_cv2(src, dst, ch):
    rng = np.random.RandomState(src[0] + dst[1])
    shape = src + ((ch,) if ch else ())
    a = (rng.rand(*shape) * 255).astype(np.uint8)
    size = (dst[1], dst[0])
    np.testing.assert_array_equal(
        im.resize_linear(a, size),
        cv2.resize(a, size, interpolation=cv2.INTER_LINEAR))
    np.testing.assert_array_equal(
        im.resize_nearest(a, size),
        cv2.resize(a, size, interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize('seed', range(3))
def test_morphology_vs_cv2(seed):
    rng = np.random.RandomState(seed)
    m = (rng.rand(120, 90) > 0.6).astype(np.uint8)
    k = np.ones((5, 5), np.uint8)
    np.testing.assert_array_equal(im.erode5(m), cv2.erode(m, k))
    np.testing.assert_array_equal(im.dilate5(m), cv2.dilate(m, k))


# quads that cross the border, on which an edge clipped to a border point
# (or to a level segment) once lost the pixels cv2 sets on the first or
# last column
BORDER_QUADS = (
    [[98, 49], [27, 103], [13, 123], [-34, 58]],
    [[0, 33], [109, -20], [128, 119], [-20, -1]],
    [[75, 119], [13, 132], [85, 108], [-39, 34]],
    [[-25, -46], [-31, 119], [0, 21], [7, -31]],
    [[-49, 48], [79, 44], [104, 66], [117, -12]])


@pytest.mark.parametrize('seed', range(4))
def test_fill_poly_vs_cv2(seed):
    """Random polygons of 3-5 integer vertices inside the image; then
    the border regression quads and 100 seeded quads of vertices in
    [-60, 140), most of them crossing the border of the 80 x 64 image."""
    rng = np.random.RandomState(seed)
    polys = [rng.randint(0, 64, (rng.randint(3, 6), 2)) for _ in range(150)]
    polys += [np.asarray(q) for q in BORDER_QUADS]
    polys += [rng.randint(-60, 140, (4, 2)) for _ in range(100)]
    for pts in polys:
        a = np.zeros((64, 80), np.uint8)
        cv2.fillPoly(a, [pts], 1)
        b = im.fill_poly(np.zeros((64, 80), np.uint8), pts, 1)
        np.testing.assert_array_equal(b, a, err_msg=str(pts.tolist()))


def test_bound_mask_vs_cv2():
    """The dataset's projected-box masks (6 quads of a box) on the fake
    fixture's cameras, at 256 x 256: as JAX's `get_bound_2d_mask` with
    cv2 draws them."""
    from arah_tpu.data.human_video import get_bound_2d_mask as jmask
    from arah_tpu_torch.data.fake_dataset import _camera
    from arah_tpu_torch.data.human_video import get_bound_2d_mask as pmask
    rng = np.random.RandomState(0)
    for i in range(8):
        K, R, T = _camera(45.0 * i, c=128.0)
        K = K.copy()
        K[:2, :2] /= 4
        lo = rng.uniform(-0.5, -0.2, 3)
        bounds = np.stack([lo, lo + rng.uniform(0.4, 1.2, 3)])
        pose = np.concatenate([R, T.reshape(3, 1)], -1)
        np.testing.assert_array_equal(pmask(bounds, K, pose, 256, 256),
                                      jmask(bounds, K, pose, 256, 256))


def test_read_refuses(tmp_path):
    p = str(tmp_path / 'x.bin')
    with open(p, 'wb') as f:
        f.write(b'not an image')
    with pytest.raises(ValueError, match='neither PNG nor JPEG'):
        im.read_image(p)
    q = str(tmp_path / 'c.png')
    im.write_image(q, np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ValueError, match='colour image read as gray'):
        im.read_image(q, gray=True)
    assert os.path.getsize(q) > 0
