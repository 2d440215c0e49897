"""The perceptual patch loss: LPIPS with a VGG16 backbone, or a
multi-scale DSSIM proxy where its weights are missing. Port of
`arah_tpu/utils/lpips_jax.py`.

LPIPS(VGG): ImageNet-normalised inputs, the relu1_2, relu2_2, relu3_3,
relu4_3 and relu5_3 features of VGG16, channels normalised to unit
length, learned non-negative 1x1 weights, a spatial mean and a sum over
the five layers. Its weights (`lpips_vgg.npz`, the JAX package's
converter writes them from torchvision's VGG16 and the LPIPS heads) are
not in the repository. Without them the training loss is the
differentiable multi-scale DSSIM proxy, with a warning printed once, and
the metric is named `lpips_proxy_msdssim`, never `lpips`. Images are
(N, H, W, 3) in [0, 1], as in JAX; the convolutions run in NCHW."""
from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

VGG16_CFG = [64, 64, 'M', 128, 128, 'M', 256, 256, 256, 'M',
             512, 512, 512, 'M', 512, 512, 512, 'M']
# indices (into the conv list) after which LPIPS taps features
LPIPS_TAPS = (1, 3, 6, 9, 12)   # relu1_2, relu2_2, relu3_3, relu4_3, relu5_3

_SHIFT = (-.030, -.088, -.188)
_SCALE = (.458, .448, .450)


def vgg16_features(params, x):
    """x: (N, H, W, 3) in [-1, 1]. Returns the 5 tapped feature maps,
    (N, h, w, C) each."""
    shift = torch.tensor(_SHIFT, dtype=x.dtype, device=x.device)
    scale = torch.tensor(_SCALE, dtype=x.dtype, device=x.device)
    x = ((x - shift) / scale).permute(0, 3, 1, 2)
    feats = []
    ci = 0
    for v in VGG16_CFG:
        if v == 'M':
            x = F.max_pool2d(x, 2, 2)
        else:
            conv = params['convs'][ci]
            x = F.relu(F.conv2d(x, conv['w'], conv['b'], padding=1))
            if ci in LPIPS_TAPS:
                feats.append(x.permute(0, 2, 3, 1))
            ci += 1
    return feats


def lpips_distance(params, a, b):
    """a, b: (N, H, W, 3) in [0, 1]. Returns (N,) LPIPS distances."""
    fa = vgg16_features(params, 2.0 * a - 1.0)
    fb = vgg16_features(params, 2.0 * b - 1.0)
    total = 0.0
    for lin, xa, xb in zip(params['lins'], fa, fb):
        na = xa / torch.sqrt(torch.sum(xa * xa, -1, keepdim=True) + 1e-10)
        nb = xb / torch.sqrt(torch.sum(xb * xb, -1, keepdim=True) + 1e-10)
        total = total + torch.mean(torch.sum((na - nb) ** 2 * lin, dim=-1),
                                   dim=(1, 2))
    return total


def load_lpips_params(path: str, device='cuda'):
    """The converted weights (conv{i}_w in torch's (out, in, kh, kw)
    layout, conv{i}_b, lin{0..4}) as tensors on `device`."""
    d = np.load(path)
    n_convs = len([k for k in d.files if k.startswith('conv')]) // 2

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)
    return {
        'convs': [{'w': t(d[f'conv{i}_w']), 'b': t(d[f'conv{i}_b'])}
                  for i in range(n_convs)],
        'lins': [t(d[f'lin{i}']) for i in range(5)],
    }


def weights_path() -> str:
    return os.environ.get(
        'ARAH_LPIPS_WEIGHTS',
        os.path.join(os.path.dirname(__file__), 'lpips_vgg.npz'))


def lpips_available() -> bool:
    """True when converted VGG16 and linear-head weights are on disk."""
    return os.path.exists(weights_path())


def metric_key() -> str:
    """The perceptual metric's name: 'lpips' only with the calibrated
    weights loaded; otherwise the proxy's own name, so that its numbers
    are never mistaken for LPIPS."""
    return 'lpips' if lpips_available() else 'lpips_proxy_msdssim'


_WARNED = False


def _warn_proxy(context: str):
    global _WARNED
    if not _WARNED:
        print(f'WARNING: LPIPS VGG weights not found at {weights_path()}; '
              f'{context} uses a multi-scale DSSIM proxy instead '
              '(reported as "lpips_proxy_msdssim", NOT comparable to '
              'published LPIPS numbers). Run convert_lpips_weights() on '
              'a machine with torchvision+lpips to fix.',
              file=sys.stderr, flush=True)
        _WARNED = True


def _ssim_nhwc(a, b, win: int = 7):
    """Differentiable uniform-window SSIM over (N, H, W, C) in [0, 1]:
    per-image mean SSIM (N,), constants K1 = 0.01, K2 = 0.03, L = 1."""
    def filt(x):
        return F.avg_pool2d(x, win, stride=1)
    a, b = a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2)
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu_a, mu_b = filt(a), filt(b)
    var_a = filt(a * a) - mu_a * mu_a
    var_b = filt(b * b) - mu_b * mu_b
    cov = filt(a * b) - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a * mu_a + mu_b * mu_b + c1) * (var_a + var_b + c2)
    return torch.mean(num / den, dim=(1, 2, 3))


def msdssim(a, b):
    """Differentiable multi-scale structural dissimilarity of patch
    batches (N, H, W, 3) in [0, 1]: the mean over up to three scales
    (halved by 2x2 means, while both sides are >= 8) of 1 - SSIM."""
    vals = []
    x, y = a, b
    for _ in range(3):
        if min(x.shape[1], x.shape[2]) < 8:
            break
        vals.append(1.0 - _ssim_nhwc(x, y))
        x = F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        y = F.avg_pool2d(y.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
    return torch.mean(torch.stack(vals), dim=0)


def make_perceptual_loss():
    """The differentiable patch loss of training: (pred (P, ps, ps, 3),
    gt (P, ps, ps, 3)) in [0, 1] -> the scalar mean distance. LPIPS when
    the converted weights exist (moved to the patches' device at the
    first call there); otherwise the multi-scale DSSIM proxy, with the
    warning."""
    if lpips_available():
        host = load_lpips_params(weights_path(), device='cpu')
        on = {}

        def loss(p, g):
            if p.device not in on:
                on[p.device] = _to(host, p.device)
            return torch.mean(lpips_distance(on[p.device], p, g))
        return loss
    _warn_proxy('the training perceptual loss')
    return lambda p, g: torch.mean(msdssim(p, g))


_DEFAULT = None


def get_default_lpips():
    """The eval perceptual metric, (a (1, H, W, 3), b) numpy in [0, 1] ->
    float: LPIPS on the CPU when the converted weights exist, else JAX's
    multi-scale DSSIM proxy (`metric_key` names which; the proxy is never
    to be reported as LPIPS)."""
    global _DEFAULT
    if _DEFAULT is not None:
        return _DEFAULT
    if lpips_available():
        params = load_lpips_params(weights_path(), device='cpu')

        def fn(a, b):
            with torch.no_grad():
                d = lpips_distance(
                    params, torch.as_tensor(a, dtype=torch.float32),
                    torch.as_tensor(b, dtype=torch.float32))
            return float(d.mean())
        _DEFAULT = fn
    else:
        _warn_proxy('the eval perceptual metric')
        from arah_tpu_torch.utils.metrics import ssim

        def proxy(a, b):
            a = np.asarray(a)[0]
            b = np.asarray(b)[0]
            vals = []
            for scale in (1, 2, 4):
                aa, bb = a[::scale, ::scale], b[::scale, ::scale]
                if min(aa.shape[:2]) >= 8:
                    vals.append(1.0 - ssim(aa, bb))
            return float(np.mean(vals)) if vals else 0.0
        _DEFAULT = proxy
    return _DEFAULT


def _to(params, device):
    return {'convs': [{k: v.to(device) for k, v in c.items()}
                      for c in params['convs']],
            'lins': [v.to(device) for v in params['lins']]}
