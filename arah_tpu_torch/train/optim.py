"""Optimizer with per-subnetwork parameter groups. Port of
`arah_tpu/train/optim.py` as torch `Adam` parameter groups:

  group               lr
  sdf_hyper           lr (hypernet hyper-layers)
  sdf_pose_encoder    lr * pose_net_factor
  color               color_lr
  deviation           deviation_lr
  skinning            skinning_lr (only with train_skinning_net)
  aux                 aux_lr (cameras, SMPL params)
  latent              latent_lr, coupled L2 weight decay (torch Adam's
                      `weight_decay`, as optax's add_decayed_weights
                      before adam)
  frozen              no update (the FiLM mapping network, `hypo_init`)

Labels come from each leaf's path in the parameter tree. A grouped leaf
whose gradient is None gets a zero gradient before the step, so every
group's moments advance each step as `optax.multi_transform`'s do. The
cosine and exponential decays multiply every group's lr by the same
factor of the step count (`LambdaLR`).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class OptimConfig(NamedTuple):
    lr: float = 1e-6
    pose_net_factor: float = 100.0
    color_lr: float = 1e-4
    deviation_lr: float = 1e-4
    skinning_lr: float = 1e-4
    train_skinning_net: bool = True
    aux_lr: float = 1e-4            # cameras / SMPL params
    latent_lr: float = 1e-4
    latent_weight_decay: float = 0.05
    lr_schedule: str = 'constant'   # constant | cosine | exponential
    lr_decay_steps: int = 0         # horizon (cosine) / half-life period
    lr_gamma: float = 0.5           # exponential factor per decay_steps
    lr_min_factor: float = 0.1      # floor of both schedules


def schedule_factor(cfg: OptimConfig):
    """Step -> multiplicative lr factor, or None for constant."""
    if cfg.lr_schedule == 'constant' or cfg.lr_decay_steps <= 0:
        return None
    if cfg.lr_schedule == 'cosine':
        def factor(step):
            t = min(step / cfg.lr_decay_steps, 1.0)
            cos = 0.5 * (1.0 + math.cos(math.pi * t))
            return cfg.lr_min_factor + (1.0 - cfg.lr_min_factor) * cos
        return factor
    if cfg.lr_schedule == 'exponential':
        def factor(step):
            return max(cfg.lr_gamma ** (step / cfg.lr_decay_steps),
                       cfg.lr_min_factor)
        return factor
    raise ValueError(f'unknown lr_schedule {cfg.lr_schedule!r}')


def tree_leaves_with_path(tree, path=()):
    """(path, tensor) of every leaf of nested dicts/lists/tuples, in key
    order of the dicts as built and index order of the lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves_with_path(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_path(v, path + (i,))
    else:
        yield path, tree


def label_for_path(path, cfg: OptimConfig) -> str:
    top = path[0]
    if top == 'hypernet':
        return {'hyper_layers': 'sdf_hyper',
                'pose_encoder': 'sdf_pose_encoder'}.get(path[1], 'frozen')
    if top in ('color', 'deviation', 'latent'):
        return top
    if top == 'skinning':
        return 'skinning' if cfg.train_skinning_net else 'frozen'
    if top in ('cam_rots', 'cam_trans', 'smpl_params', 'betas'):
        return 'aux'
    return 'frozen'


class Optimizer:
    """torch Adam over the labelled groups (frozen leaves in none), with
    the schedule stepped after every update."""

    def __init__(self, cfg: OptimConfig, params):
        lrs = {'sdf_hyper': cfg.lr,
               'sdf_pose_encoder': cfg.lr * cfg.pose_net_factor,
               'color': cfg.color_lr, 'deviation': cfg.deviation_lr,
               'skinning': cfg.skinning_lr, 'aux': cfg.aux_lr,
               'latent': cfg.latent_lr}
        members = {k: [] for k in lrs}
        self.labels = {}
        for path, leaf in tree_leaves_with_path(params):
            label = label_for_path(path, cfg)
            self.labels[path] = label
            if label != 'frozen':
                members[label].append(leaf)
        groups = [{'params': members[k], 'lr': lr, 'name': k,
                   'weight_decay': cfg.latent_weight_decay
                   if k == 'latent' else 0.0}
                  for k, lr in lrs.items() if members[k]]
        self.adam = torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8)
        factor = schedule_factor(cfg)
        self.schedule = None if factor is None else \
            torch.optim.lr_scheduler.LambdaLR(self.adam, factor)

    def zero_grad(self):
        self.adam.zero_grad(set_to_none=True)

    def step(self):
        for g in self.adam.param_groups:
            for p in g['params']:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        self.adam.step()
        if self.schedule is not None:
            self.schedule.step()


def make_optimizer(cfg: OptimConfig, params):
    """(Optimizer over `params`' leaves, {path: label})."""
    opt = Optimizer(cfg, params)
    return opt, opt.labels
