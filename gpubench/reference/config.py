"""A configuration dict (the merged `configs/*.yaml` as a cell's
`configs/<name>.json` holds it) mapped onto the reference's typed
configs, by the rules of the published `configs/default.yaml` and of the
port's `config/loader.py`."""
from __future__ import annotations

from gpubench.reference.color import ColorConfig
from gpubench.reference.hypernet import HypernetConfig
from gpubench.reference.ray_tracing import RayTracerConfig
from gpubench.reference.renderer import ModelConfig
from gpubench.reference.skinning import SkinningConfig

FEATURE = {None: 0, 'leap': 144, 'root': 12}


def model_config(cfg: dict) -> ModelConfig:
    m, t = cfg['model'], cfg['training']
    dk = m.get('decoder_kwargs') or {}
    hypernet = HypernetConfig(
        in_features=dk.get('in_features', 3),
        out_features=dk.get('out_features', 1),
        hidden_features=dk.get('hidden_features', 256),
        num_hidden_layers=dk.get('num_hidden_layers', 5),
        hyper_in_ch=dk.get('hyper_in_ch', 144),
        use_film=dk.get('use_FiLM', False),
        hierarchical_pose=dk.get('hierarchical_pose', True),
        rel_joints=dk.get('rel_joints', False),
        latent_dim=m.get('latent_dim', 128))
    sk = m.get('skinning_decoder_kwargs') or {}
    skinning = SkinningConfig(
        d_in=sk.get('d_in', 3), d_out=sk.get('d_out', 25),
        d_hidden=sk.get('d_hidden', 128), n_layers=sk.get('n_layers', 4),
        skip_in=tuple(sk.get('skip_in', ())),
        cond_in=tuple(sk.get('cond_in', ())), cond_dim=sk.get('cond_dim', 0),
        multires=sk.get('multires', 0), bias=sk.get('bias', 1.0),
        geometric_init=sk.get('geometric_init', False),
        weight_norm=sk.get('weight_norm', True))
    rk = m.get('renderer_kwargs') or {}
    enc = m.get('color_pose_encoder')
    latent = m.get('latent_dim', 128)
    pose_width = {'latent': latent, 'hybrid': 12 + latent}.get(
        enc, FEATURE.get(enc, 0))
    color = ColorConfig(
        d_feature=hypernet.hidden_features + pose_width,
        mode=rk.get('mode', 'idr'), d_in=rk.get('d_in', 9),
        d_out=rk.get('d_out', 3), d_hidden=rk.get('d_hidden', 256),
        n_layers=rk.get('n_layers', 5), multires=rk.get('multires', 0),
        multires_view=rk.get('multires_view', 4),
        skips=tuple(rk.get('skips', ())),
        squeeze_out=rk.get('squeeze_out', True), pose_encoder=enc,
        rel_joints=rk.get('rel_joints', True))
    tracer = RayTracerConfig(
        n_steps=m.get('n_steps', 64),
        near_surface_vol_samples=m.get('near_surface_samples', 16),
        far_surface_vol_samples=m.get('far_surface_samples', 16),
        corr_phase1_steps=m.get('corr_phase1_steps', 0),
        corr_resolve_cap=m.get('corr_resolve_cap', 4096),
        march_phase1_steps=m.get('march_phase1_steps', 0),
        march_resolve_cap=m.get('march_resolve_cap', 512),
        iso_phase1_steps=m.get('iso_phase1_steps', 0),
        iso_resolve_cap=m.get('iso_resolve_cap', 512))
    return ModelConfig(
        hypernet=hypernet, skinning=skinning, color=color, tracer=tracer,
        cano_view_dirs=m.get('cano_view_dirs', True),
        train_skinning_net=t.get('train_skinning_net', False),
        render_last_pt=m.get('render_last_pt', False),
        bf16_shading=m.get('bf16_shading', False))

