"""YAML configs with recursive single inheritance, and their mapping onto
the port's typed configs. Port of `arah_tpu/config/loader.py`: a config
may name a parent in `inherit_from`; parents load recursively and the
child overrides them by a recursive dict merge. The files are read with
the port's own reader (`config/yaml_lite.py`), not PyYAML."""
from __future__ import annotations

import os

from arah_tpu_torch.config.yaml_lite import load_file


def load_config(path: str, default_path: str | None = None) -> dict:
    cfg_special = load_file(path)

    inherit_from = cfg_special.get('inherit_from')
    if inherit_from is not None:
        base = os.path.join(os.path.dirname(path), inherit_from) \
            if not os.path.isabs(inherit_from) and not os.path.exists(
                inherit_from) else inherit_from
        cfg = load_config(base, default_path)
    elif default_path is not None:
        cfg = load_file(default_path)
    else:
        cfg = {}

    update_recursive(cfg, cfg_special)
    return cfg


def update_recursive(dict1: dict, dict2: dict):
    """Recursively merge dict2 into dict1 (in place)."""
    for k, v in dict2.items():
        if k not in dict1:
            dict1[k] = {} if isinstance(v, dict) else None
        if isinstance(v, dict):
            if not isinstance(dict1[k], dict):
                dict1[k] = {}
            update_recursive(dict1[k], v)
        else:
            dict1[k] = v
    return dict1


def default_config_path() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), 'configs',
        'default.yaml')


def model_config_from_cfg(cfg: dict):
    """cfg dict -> ModelConfig (networks + tracer + renderer switches)."""
    from arah_tpu_torch.nn.color import ColorConfig, feature_width
    from arah_tpu_torch.nn.hypernet import HypernetConfig
    from arah_tpu_torch.nn.skinning import SkinningConfig
    from arah_tpu_torch.render.ray_tracing import RayTracerConfig
    from arah_tpu_torch.render.renderer import ModelConfig

    m = cfg['model']
    dk = dict(m.get('decoder_kwargs') or {})
    hypernet = HypernetConfig(
        in_features=dk.get('in_features', 3),
        out_features=dk.get('out_features', 1),
        hidden_features=dk.get('hidden_features', 256),
        num_hidden_layers=dk.get('num_hidden_layers', 5),
        hyper_in_ch=dk.get('hyper_in_ch', 144),
        use_film=dk.get('use_FiLM', False),
        hierarchical_pose=dk.get('hierarchical_pose', True),
        rel_joints=dk.get('rel_joints', False),
        latent_dim=cfg['model'].get('latent_dim', 128),
    )

    sk = dict(m.get('skinning_decoder_kwargs') or {})
    skinning = SkinningConfig(
        d_in=sk.get('d_in', 3), d_out=sk.get('d_out', 25),
        d_hidden=sk.get('d_hidden', 128), n_layers=sk.get('n_layers', 4),
        skip_in=tuple(sk.get('skip_in', ())),
        cond_in=tuple(sk.get('cond_in', ())),
        cond_dim=sk.get('cond_dim', 0),
        multires=sk.get('multires', 0), bias=sk.get('bias', 1.0),
        geometric_init=sk.get('geometric_init', False),
        weight_norm=sk.get('weight_norm', True),
    )

    rk = dict(m.get('renderer_kwargs') or {})
    pose_encoder = m.get('color_pose_encoder')
    color = ColorConfig(
        d_feature=feature_width(pose_encoder, m.get('latent_dim', 128),
                                hypernet.hidden_features),
        mode=rk.get('mode', 'idr'),
        d_in=rk.get('d_in', 9), d_out=rk.get('d_out', 3),
        d_hidden=rk.get('d_hidden', 256), n_layers=rk.get('n_layers', 5),
        multires=rk.get('multires', 0),
        multires_view=rk.get('multires_view', 4),
        skips=tuple(rk.get('skips', ())),
        squeeze_out=rk.get('squeeze_out', True),
        pose_encoder=pose_encoder,
        rel_joints=rk.get('rel_joints', True),
    )

    tracer = RayTracerConfig(
        n_steps=m.get('n_steps', 64),
        near_surface_vol_samples=m.get('near_surface_samples', 16),
        far_surface_vol_samples=m.get('far_surface_samples', 16),
        # per-kernel switches back to the plain versions
        use_pallas_corr=m.get('use_pallas_corr', True),
        use_pallas_march=m.get('use_pallas_march', True),
        use_pallas_iso=m.get('use_pallas_iso', True),
        pallas_precision=m.get('pallas_precision', 'f32'),
        corr_coarse_stride=m.get('corr_coarse_stride', 0),
        corr_warm_gate=m.get('corr_warm_gate', 0.1),
        corr_phase1_steps=m.get('corr_phase1_steps', 0),
        corr_resolve_cap=m.get('corr_resolve_cap', 4096),
        use_pallas_knn=m.get('use_pallas_knn', True),
        march_phase1_steps=m.get('march_phase1_steps', 0),
        march_resolve_cap=m.get('march_resolve_cap', 512),
        iso_phase1_steps=m.get('iso_phase1_steps', 0),
        iso_resolve_cap=m.get('iso_resolve_cap', 512),
    )

    return ModelConfig(
        hypernet=hypernet, skinning=skinning, color=color, tracer=tracer,
        cano_view_dirs=m.get('cano_view_dirs', True),
        train_skinning_net=cfg['training'].get('train_skinning_net', False),
        render_last_pt=m.get('render_last_pt', False),
        bf16_shading=m.get('bf16_shading', False),
        use_pallas_shade=m.get('use_pallas_shade', True),
        pallas_shade_tile=m.get('pallas_shade_tile', 512),
        use_pallas_shade_grad=m.get('use_pallas_shade_grad', True),
        pallas_shade_grad_tile=m.get('pallas_shade_grad_tile', 256),
        shade_resid_bf16=m.get('shade_resid_bf16', False),
        idiff_linearize=m.get('idiff_linearize', True),
        idiff_kernel_jac=m.get('idiff_kernel_jac', False),
    )


def loss_weights_from_cfg(cfg: dict):
    from arah_tpu_torch.train.loss import LossWeights
    t = cfg['training']
    return LossWeights(
        rgb=t.get('rgb_weight', 30.0),
        perceptual=t.get('perceptual_weight', 0.0),
        eikonal=t.get('eikonal_weight', 50.0),
        mask=t.get('mask_weight', 0.0),
        off_surface=t.get('off_surface_weight', 100.0),
        inside=t.get('inside_weight', 0.0),
        params=t.get('params_weight', 100.0),
        skinning=t.get('skinning_weight', 0.0),
        rgb_loss_type=t.get('rgb_loss_type', 'l1'),
        # per-ray-loss ray count = the dataset's fg+bg sample budget
        # (patch rays for the perceptual loss come after these)
        n_ray_loss=(cfg['data'].get('num_fg_samples', 1024)
                    + cfg['data'].get('num_bg_samples', 1024)),
        patch_size=t.get('patch_size', 48),
    )


def optim_config_from_cfg(cfg: dict):
    from arah_tpu_torch.train.optim import OptimConfig
    t = cfg['training']
    sched = t.get('lr_schedule', {}) or {}
    return OptimConfig(
        lr=t.get('lr', 1e-6),
        pose_net_factor=t.get('pose_net_factor', 100.0),
        skinning_lr=t.get('skinning_lr', 1e-4),
        train_skinning_net=t.get('train_skinning_net', False),
        lr_schedule=sched.get('type', 'constant'),
        lr_decay_steps=int(sched.get('decay_steps', 0)),
        lr_gamma=float(sched.get('gamma', 0.5)),
        lr_min_factor=float(sched.get('min_factor', 0.1)),
    )
