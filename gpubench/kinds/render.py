"""Novel-view cells: whole images rendered by the program's evaluator
(`arah_tpu_torch.eval.evaluator.render_frame_rays`, as `validate.py
--novel-view` renders them) in a closed loop, one image after another.

A request is every box ray of one image: a training frame seen from one
of the configuration's `val_views`. The pool of images and the subject
are one set for every seed; the seed draws their order. Set-up makes the
scene and the pool and renders the pool's first image to warm up. The
window runs whole passes over the pool, so that every run does the same
work. Once it has closed, `checked_images` of the images it finished,
the one of the most rays among them and others drawn from the seed, are
rendered again by the reference in the evaluator's chunks, and the hit
mask, colour and depth of every ray compared.
"""
from __future__ import annotations

import math
import sys
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from gpubench import flops, inputs
from gpubench.harness import Check, Outcome, closed_loop
from gpubench.reference import config as rconfig
from gpubench.reference.renderer import RenderInputs, generate_sdf, render
from gpubench.reference.tree import tree_map

# the evaluator's chunk rule (its candidate chunks and their relative
# throughputs), which sets the straggler splits' batches
CHUNKS = ((8192, 68.0), (16384, 74.4), (32768, 77.6))


def eval_chunk(n_rays: int) -> int:
    best, best_t = None, None
    for c, rate in CHUNKS:
        t = -(-n_rays // c) * c / rate
        if best_t is None or t < best_t:
            best, best_t = c, t
    return best


def reference_image(params, cfg, fd, item, latent, device, chunk=None):
    """(rgb (N, 3), depth (N,), hit (N,)) of an image's box rays by the
    reference, in the evaluator's chunks (`chunk`, or the evaluator's
    rule), each padded to the chunk by repeating its last ray."""
    rays = item['inputs.ray_dirs']
    bounds = item['inputs.body_bounds_intersections']
    n = rays.shape[0]
    chunk = chunk or eval_chunk(n)
    cam = torch.as_tensor(item['image.cam_loc'], device=device)
    outs = []
    for i in range(0, n, chunk):
        j = min(i + chunk, n)
        pad = chunk - (j - i)

        def t(a):
            return torch.as_tensor(np.pad(a[i:j], [(0, pad)] + [(0, 0)] * (
                a.ndim - 1), mode='edge'), device=device)
        inp = RenderInputs(
            cam_loc=cam, ray_dirs=t(rays), near=t(bounds[:, 0]),
            far=t(bounds[:, 1]), frame=fd.frame, smpl=fd.smpl, rots=fd.rots,
            Jtrs=fd.Jtrs, rots_full=fd.rots_full, Jtrs_posed=fd.Jtrs_posed,
            pose_cond_extra={'latent_code': latent[None]},
            geo_latent=latent)
        out = render(params, cfg, inp, training=False)
        k = j - i
        outs.append((out['rgb_values'][:k].float().cpu().numpy(),
                     out['surface_depth'][:k].cpu().numpy(),
                     out['surface_converged'][:k].cpu().numpy()))
    return tuple(np.concatenate(p) for p in zip(*outs))


def depth_gaps(prog, ref):
    """|depth gap| (metres) of the rays both sides hit."""
    both = prog[3] & ref[2]
    return np.abs(prog[2] - ref[1])[both]


def compare(prog, ref, rgb_tol: float, depth_tol: float) -> dict:
    """The image's hit-mask disagreement, the share of rays whose colour
    differs by more than `rgb_tol` in some channel, and the share of the
    rays both sides hit whose depth differs by more than `depth_tol`
    metres (0 where there are none)."""
    p_rgb, _, p_depth, p_hit = prog
    r_rgb, r_depth, r_hit = ref
    far = np.abs(p_rgb - r_rgb).max(-1) > rgb_tol
    gaps = depth_gaps(prog, ref)
    return {'hit_disagree': float(np.mean(p_hit != r_hit)),
            'rgb_far_share': float(np.mean(far)),
            'depth_far_share': float(np.mean(~(gaps <= depth_tol)))
            if gaps.size else 0.0}


def depth_profile(prog, ref) -> str:
    """The shares of the both-hit rays whose depth differs by more than
    1e-6 .. 1e-2 m, for standard error."""
    g = depth_gaps(prog, ref)
    return 'depth gaps over %d rays: ' % g.size + ', '.join(
        '>%g m %.3g' % (t, float(np.mean(~(g <= t))) if g.size else 0.0)
        for t in (1e-6, 1e-5, 1e-4, 1e-3, 1e-2))


class Setup(NamedTuple):
    ref_cfg: Any
    scene: Any
    pool: list           # [(frame, view)]
    items: list          # the pool's eval items


def prepare(r) -> Setup:
    """The scene and the pool of images: one set for every seed, in the
    order the seed draws. On the card the fitted weights are kept in
    `inputs.FIT_CACHE`."""
    device = torch.device(r.device)
    cfg, tr = r.cfg, r.traffic
    data = cfg['data']
    ref_cfg = rconfig.model_config(cfg)
    scene = inputs.build_scene(
        cfg, ref_cfg, device, fit_steps=tr['fit_steps'],
        cache_dir=inputs.FIT_CACHE if device.type == 'cuda' else None)
    cams = inputs.ring_cameras(cfg['scene'])
    frames = range(data['train_end_frame'] - data['train_start_frame'])
    pairs = [(f, v) for f in frames for v in data[tr['views']]]
    # one set of images for every seed, in the seed's order
    pool = inputs.fixed_set(pairs, tr['pool'])
    rng = np.random.RandomState(inputs.seed_words(r.seed, 8))
    pool = [pool[i] for i in rng.permutation(len(pool))]
    items = [inputs.eval_item(scene, cams, f, v, device) for f, v in pool]
    return Setup(ref_cfg, scene, pool, items)


def reference_of(s: Setup, k: int, device, chunk=None):
    """Pool image k by the reference."""
    f = s.pool[k][0]
    return reference_image(s.scene.params, s.ref_cfg, s.scene.frames[f],
                           s.items[k], s.scene.params['latent'][f], device,
                           chunk)


def checked_keys(keys, items, seed: int, n: int) -> list:
    """The n images checked among `keys`: the one of the most rays, and
    others drawn from the seed."""
    keys = sorted(keys, key=lambda k: -items[k]['inputs.ray_dirs'].shape[0])
    rest = list(np.random.RandomState(inputs.seed_words(seed, 9))
                .permutation(keys[1:]))
    return keys[:1] + rest[:n - 1]


def checks_of(images_done: int, compared: list, limits: dict,
              failed: int = 0) -> list:
    """The checks: images finished and compared, none with a value that
    is not finite, and each of `compare`'s numbers at its worst over the
    compared images."""
    worst = {}
    for c in compared:
        for name, v in c.items():
            prev = worst.get(name, 0.0)
            worst[name] = math.nan if math.isnan(v) or math.isnan(prev) \
                else max(prev, v)
    return [Check('images_done', images_done, 1, 'min'),
            Check('images_compared', len(compared), 1, 'min'),
            Check('nonfinite', failed, 0)] + \
        [Check(name, worst.get(name, math.nan), limits[name])
         for name in ('hit_disagree', 'rgb_far_share', 'depth_far_share')]


def run(r) -> Outcome:
    from arah_tpu_torch.config import loader as P_loader
    from arah_tpu_torch.core import smpl as P_smpl
    from arah_tpu_torch.eval.evaluator import render_frame_rays
    from arah_tpu_torch.model import prepare_frame as p_prepare_frame

    device = torch.device(r.device)
    on_gpu = device.type == 'cuda'
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, tr = r.cfg, r.traffic
    s = prepare(r)
    ref_cfg, scene, pool, items = s
    t_inputs = time.perf_counter()

    p_model = P_smpl.smpl_to_device(P_smpl.SmplModel(*scene.model), device)
    with torch.no_grad():
        p_frames = {f: p_prepare_frame(p_model, scene.betas, scene.poses[f],
                                       scene.trans, device=device)
                    for f in sorted({f for f, _ in pool})}
    mcfg = P_loader.model_config_from_cfg(cfg)
    params = tree_map(lambda t: t.detach().clone(), scene.params)

    def call(i):
        k = i % len(pool)
        f = pool[k][0]
        rgb, w, depth, hit = render_frame_rays(
            params, mcfg, p_frames[f], items[k], params['latent'][f],
            chunk=tr['chunk'])
        if r.fault == 'altered_answer':
            rgb = rgb.copy()
            rgb[:tr['chunk'] or eval_chunk(len(rgb))] += 0.1
        elif r.fault == 'half_batch':
            for a in (rgb, depth, hit):
                a[len(a) // 2:] = 0
        elif r.fault == 'moved_roots':
            # a third of the rays' roots moved 5 mm along the ray
            depth = depth.copy()
            depth[::3] += 5e-3
        return k, (rgb, w, depth, hit)

    call(0)        # warm-up: the kernels' build and every launch shape
    if on_gpu:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - r.t0
    print(f'setup: {setup_s:.1f} s, of which the inputs until '
          f'{t_inputs - r.t0:.1f} s (the fit '
          f'{"read back" if scene.fit_cached else "made"} in '
          f'{scene.fit_s:.1f} s, loss {scene.fit_loss:.4g}), the program '
          f'and its warm-up image {time.perf_counter() - t_inputs:.1f} s',
          file=sys.stderr)
    img_s, outs, window_s, summary = closed_loop(
        lambda i: call(i + 1), r.seconds,
        tr['trace_images'] if r.trace else 0, multiple=len(pool))
    peak = torch.cuda.max_memory_allocated() if on_gpu else 0
    n_img = len(outs)
    done_keys = [k for k, _ in outs]
    rays = sum(items[k]['inputs.ray_dirs'].shape[0] for k, _ in outs)
    failed = sum(1 for _, o in outs
                 if not all(np.isfinite(a).all() for a in o[:3]))

    done = {}
    for k, o in outs:
        done.setdefault(k, o)
    chosen = checked_keys(done, items, r.seed, tr['checked_images'])
    del outs
    if on_gpu:
        torch.cuda.empty_cache()
    compared = []
    for k in chosen:
        ref = reference_of(s, k, device, tr['chunk'])
        print(depth_profile(done[k], ref), file=sys.stderr)
        compared.append(compare(done[k], ref, tr['rgb_tol'],
                                tr['depth_tol']))
    checks = checks_of(n_img, compared, r.limits, failed)

    e2e = {'render_rays_per_s': rays / window_s,
           'peak_mem_gib': peak / 2 ** 30, 'setup_s': setup_s}
    facts = {'kind': 'render'}
    if summary is not None:
        # closed_loop traced units 1.., each call(i + 1) of pool item
        # (i + 1) mod the pool
        traced = range(1, 1 + tr['trace_images'])

        def padded(k):
            n = items[k]['inputs.ray_dirs'].shape[0]
            c = tr['chunk'] or eval_chunk(n)
            return -(-n // c) * c
        with torch.no_grad():
            gen = generate_sdf(scene.params, ref_cfg, scene.frames[0].rots,
                               scene.frames[0].Jtrs,
                               scene.params['latent'][0])
        siren, skin, color, hyper = flops.model_shapes(scene.params, gen)
        bf16, S = ref_cfg.bf16_shading, ref_cfg.tracer.n_steps

        def image_s(k):
            # the image's own rays: the chunks' padding is not the model's
            return flops.image_least_s(
                n_rays=items[k]['inputs.ray_dirs'].shape[0], n_samples=S,
                n_verts=cfg['scene']['n_verts'], siren_shapes=siren,
                skin_shapes=skin, color_shapes=color, hypernet_params=hyper,
                bf16=bf16)['total']
        untraced = [i for i in range(n_img) if i not in traced]
        facts.update(
            trace=summary, units=len(traced),
            rays=sum(items[done_keys[i]]['inputs.ray_dirs'].shape[0]
                     for i in traced),
            least_s={
                'C': flops.c_least_s(siren, S * sum(
                    padded(done_keys[i]) for i in traced), bf16),
                # the untraced images' least time and their seconds
                'images': sum(image_s(done_keys[i]) for i in untraced)},
            images_s=sum(img_s[i] for i in untraced))
    return Outcome(e2e, facts, checks, n_img, failed,
                   max(peak, setup_peak) if on_gpu else 0)
