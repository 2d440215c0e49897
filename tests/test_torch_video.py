"""The port's video writer (`eval/evaluator.py:write_video`): an ISO-BMFF
MP4 of Motion-JPEG samples. Its boxes parse (`read_video`), each sample
is exactly `write_jpeg` of its frame, so it decodes to
`read_jpeg(write_jpeg(frame))` bit for bit; float frames are quantised
as `save_image` quantises them; and OpenCV's own reader (FFmpeg) opens
the file, counts its frames and frame rate, and decodes each frame to
within 2 levels on average of the port's decoder (the two differ in
colour conversion)."""
import cv2
import numpy as np
import pytest


def frames(n=3, h=40, w=72):
    yy, xx = np.mgrid[0:h, 0:w]
    return [np.stack([xx * 3 + 20 * k, yy * 5, xx + yy], -1).clip(0, 255)
            .astype(np.uint8) for k in range(n)]


def test_write_read_bits(tmp_path):
    from arah_tpu_torch.eval.evaluator import read_video, write_video
    from arah_tpu_torch.utils.image import read_jpeg, write_jpeg
    fr = frames()
    path = str(tmp_path / 'vis.mp4')
    write_video(path, fr, fps=20)
    samples, fps, wh = read_video(path)
    assert (len(samples), fps, wh) == (3, 20, (72, 40))
    for s, f in zip(samples, fr):
        assert s == write_jpeg(f, 95)
        np.testing.assert_array_equal(read_jpeg(s), read_jpeg(write_jpeg(f)))
    with open(path, 'rb') as f:
        head = f.read(12)
    assert head[4:12] == b'ftypisom'


def test_float_frames(tmp_path):
    from arah_tpu_torch.eval.evaluator import _to_u8, read_video, write_video
    from arah_tpu_torch.utils.image import write_jpeg
    rng = np.random.RandomState(0)
    fr = [rng.rand(16, 24, 3).astype(np.float32) for _ in range(2)]
    fr[0][0, 0] = np.nan
    write_video(str(tmp_path / 'f.mp4'), fr, fps=5)
    samples, fps, _ = read_video(str(tmp_path / 'f.mp4'))
    assert fps == 5
    assert [s == write_jpeg(_to_u8(f)) for s, f in zip(samples, fr)] == [
        True, True]


def test_opencv_reads_it(tmp_path):
    from arah_tpu_torch.eval.evaluator import read_video, write_video
    from arah_tpu_torch.utils.image import read_jpeg
    fr = frames(4, 64, 96)
    path = str(tmp_path / 'vis.mp4')
    write_video(path, fr, fps=20)
    samples, _, _ = read_video(path)
    cap = cv2.VideoCapture(path)
    assert cap.isOpened()
    assert cap.get(cv2.CAP_PROP_FPS) == 20
    assert cap.get(cv2.CAP_PROP_FRAME_COUNT) == 4
    got = []
    while True:
        ok, img = cap.read()
        if not ok:
            break
        got.append(img[..., ::-1])
    cap.release()
    assert len(got) == 4
    for img, s in zip(got, samples):
        assert img.shape == (64, 96, 3)
        assert np.abs(img.astype(int) - read_jpeg(s)).mean() < 2.0


def test_refuses_mixed_sizes_and_writes_nothing_for_none(tmp_path):
    from arah_tpu_torch.eval.evaluator import write_video
    with pytest.raises(ValueError, match='sizes'):
        write_video(str(tmp_path / 'a.mp4'), [np.zeros((8, 8, 3), np.uint8),
                                              np.zeros((8, 16, 3), np.uint8)])
    write_video(str(tmp_path / 'b.mp4'), [])
    assert not (tmp_path / 'b.mp4').exists()
