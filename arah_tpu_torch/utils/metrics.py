"""Evaluation metrics: PSNR / SSIM / LPIPS. The port's own copy of
`arah_tpu/utils/metrics.py` (numpy and scipy), after the reference's
`im2mesh/utils/eval.py:6-30`:
  * PSNR on ray sets with the same -10 log10(mse) formula,
  * SSIM on mask-bounding-box crops — self-contained implementation of the
    skimage `structural_similarity` defaults (uniform 7x7 window,
    K1=0.01, K2=0.03, per-channel mean) since skimage isn't available,
  * LPIPS through the port's VGG16 in utils/lpips.py (weights converted
    from the torchvision/lpips checkpoints; a multi-scale SSIM proxy,
    reported under its own name, when they are absent).

SSIM data_range protocol: the reference calls skimage with no
`data_range` on float images (`im2mesh/utils/eval.py:17`); skimage then
uses the float dtype range (-1, 1) => **data_range = 2.0**, even though
the images live in [0, 1]. That inflates C1/C2 by 4x/16x relative to the
"correct" data_range=1.0, raising reported SSIM. To be comparable with
the reference's published protocol, `ssim_metric` reproduces the skimage
float default (2.0). Pass `data_range=1.0` explicitly for the
physically-correct [0,1] convention. The JAX copy's golden
tests: tests/test_metrics.py (independent sliding-window oracle).
"""
from __future__ import annotations

import numpy as np


def psnr(img_pred: np.ndarray, img_gt: np.ndarray) -> float:
    mse = np.mean((img_pred - img_gt) ** 2)
    return float(-10.0 * np.log(mse) / np.log(10.0))


def _uniform_filter(img: np.ndarray, size: int) -> np.ndarray:
    from scipy.ndimage import uniform_filter
    return uniform_filter(img, size=size, mode='reflect')


def ssim_single(x: np.ndarray, y: np.ndarray, data_range: float = 1.0,
                win_size: int = 7) -> float:
    """Grayscale SSIM, skimage-default settings."""
    x = x.astype(np.float64)
    y = y.astype(np.float64)
    K1, K2 = 0.01, 0.03
    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    NP = win_size ** x.ndim
    cov_norm = NP / (NP - 1)

    ux = _uniform_filter(x, win_size)
    uy = _uniform_filter(y, win_size)
    uxx = _uniform_filter(x * x, win_size)
    uyy = _uniform_filter(y * y, win_size)
    uxy = _uniform_filter(x * y, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    A1 = 2 * ux * uy + C1
    A2 = 2 * vxy + C2
    B1 = ux ** 2 + uy ** 2 + C1
    B2 = vx + vy + C2
    S = (A1 * A2) / (B1 * B2)
    pad = (win_size - 1) // 2
    return float(S[pad:-pad, pad:-pad].mean())


def ssim(img_pred: np.ndarray, img_gt: np.ndarray,
         data_range: float = 1.0) -> float:
    """Multichannel SSIM (mean over channels), skimage-compatible."""
    if img_pred.ndim == 2:
        return ssim_single(img_pred, img_gt, data_range)
    return float(np.mean([
        ssim_single(img_pred[..., c], img_gt[..., c], data_range)
        for c in range(img_pred.shape[-1])]))


def mask_bbox(mask: np.ndarray):
    """(x, y, w, h) bounding rect of a boolean mask (cv2.boundingRect
    semantics)."""
    ys, xs = np.where(mask)
    if len(xs) == 0:
        return 0, 0, mask.shape[1], mask.shape[0]
    return (int(xs.min()), int(ys.min()),
            int(xs.max() - xs.min() + 1), int(ys.max() - ys.min() + 1))


def ssim_metric(img_pred, img_gt, mask_at_box,
                data_range: float = 2.0) -> float:
    """Reference-protocol SSIM on the mask bounding-box crop.

    data_range defaults to 2.0 = skimage's float-dtype default that the
    reference's numbers were computed with (see module docstring)."""
    x, y, w, h = mask_bbox(np.asarray(mask_at_box).astype(bool))
    return ssim(img_pred[y:y + h, x:x + w], img_gt[y:y + h, x:x + w],
                data_range=data_range)


def lpips_metric(img_pred, img_gt, mask_at_box, lpips_fn=None) -> float:
    x, y, w, h = mask_bbox(np.asarray(mask_at_box).astype(bool))
    a = img_pred[y:y + h, x:x + w]
    b = img_gt[y:y + h, x:x + w]
    if lpips_fn is None:
        from arah_tpu_torch.utils.lpips import get_default_lpips
        lpips_fn = get_default_lpips()
    return float(lpips_fn(a[None], b[None]))
