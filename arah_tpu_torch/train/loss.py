"""Training losses of the ARAH renderer. Port of `arah_tpu/train/loss.py`:
the weighted sum of the RGB (first `n_ray_loss` rays), patch perceptual,
eikonal, mask, off-surface, inside, hypernet-params and skinning-weight
losses, computed densely with masks and the same denominators."""
from __future__ import annotations

from typing import NamedTuple

import torch


class LossWeights(NamedTuple):
    rgb: float = 30.0
    perceptual: float = 0.0
    eikonal: float = 50.0
    mask: float = 0.0
    off_surface: float = 100.0
    inside: float = 10.0
    params: float = 100.0
    skinning: float = 10.0
    rgb_loss_type: str = 'l1'       # l1 | mse | smoothed_l1
    n_ray_loss: int = 2048          # rays used for the per-ray RGB loss
    patch_size: int = 48            # patch side of the perceptual loss


def safe_norm(x, dim=-1, eps=1e-12):
    """L2 norm with a finite gradient at 0 (sqrt of the clamped square)."""
    return torch.sqrt(torch.clamp(torch.sum(x * x, dim=dim), min=eps))


def _rgb_residual(pred, gt, kind):
    if kind == 'l1':
        return torch.abs(pred - gt)
    if kind == 'mse':
        return (pred - gt) ** 2
    if kind == 'smoothed_l1':
        beta = 0.1
        d = torch.abs(pred - gt)
        return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
    raise ValueError(kind)


def compute_loss(outputs: dict, ground_truth: dict, w: LossWeights,
                 perceptual_fn=None):
    """All loss terms and their weighted sum `loss`, from the outputs of
    `render(training=True)` and the ground truth (rgb (N, 3), body_mask
    (N,) int: fg 1, boundary 100, bg 0; sampled_weights (S, 24))."""
    n_loss = w.n_ray_loss
    zero = outputs['rgb_values'].new_zeros(())
    rgb_pred = outputs['rgb_values'][:n_loss]
    rgb_gt = ground_truth['rgb'][:n_loss]
    body_mask = ground_truth['body_mask'][:n_loss]
    net_mask = outputs['network_body_mask'][:n_loss]
    denom = float(n_loss)
    losses = {}

    # boundary pixels (label 100) are ignored when the mask has them
    has_boundary = bool(ground_truth['body_mask'].max() > 1)
    valid = net_mask & (body_mask != 100) if has_boundary else net_mask
    res = _rgb_residual(rgb_pred, rgb_gt, w.rgb_loss_type)
    losses['rgb_loss'] = torch.sum(res * valid[:, None]) / denom

    if w.perceptual > 0 and perceptual_fn is not None:
        ps = w.patch_size
        losses['perceptual_loss'] = perceptual_fn(
            outputs['rgb_values'][n_loss:].reshape(-1, ps, ps, 3),
            ground_truth['rgb'][n_loss:].reshape(-1, ps, ps, 3))
    else:
        losses['perceptual_loss'] = zero

    if 'grad_theta' in outputs:
        losses['eikonal_loss'] = torch.sum(torch.abs(
            safe_norm(outputs['grad_theta']) - 1.0)) / denom
    else:
        losses['eikonal_loss'] = zero

    # the L2 norm of the whole masked residual vector, the raw mask value
    # (boundary label included) as the target
    diff = (outputs['weights_sum'][:n_loss] - body_mask.float()) * net_mask
    losses['mask_loss'] = safe_norm(diff) / denom

    losses['off_surface_loss'] = torch.sum(torch.exp(
        -1e2 * outputs['off_surface_sdf'])) / denom \
        if 'off_surface_sdf' in outputs else zero
    losses['inside_loss'] = torch.sum(torch.sigmoid(
        outputs['inside_sdf'] * 5e3)) / denom \
        if 'inside_sdf' in outputs else zero

    if 'sdf_params' in outputs:
        flat = torch.cat([p.reshape(-1) for p in outputs['sdf_params']])
        losses['sdf_params_loss'] = safe_norm(flat) / flat.shape[0]
    else:
        losses['sdf_params_loss'] = zero

    if 'pred_weights' in outputs and 'sampled_weights' in ground_truth:
        losses['skinning_loss'] = torch.mean(torch.sum(torch.abs(
            outputs['pred_weights'] - ground_truth['sampled_weights']),
            dim=-1))
    else:
        losses['skinning_loss'] = zero

    losses['loss'] = (w.rgb * losses['rgb_loss']
                      + w.perceptual * losses['perceptual_loss']
                      + w.eikonal * losses['eikonal_loss']
                      + w.mask * losses['mask_loss']
                      + w.off_surface * losses['off_surface_loss']
                      + w.inside * losses['inside_loss']
                      + w.params * losses['sdf_params_loss']
                      + w.skinning * losses['skinning_loss'])
    return losses
