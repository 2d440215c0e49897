#!/usr/bin/env python3
"""Chip smoke run of arah_tpu_torch on one NVIDIA GPU (written for H100).

    python3 chip_smoke.py

1. Builds the CUDA kernels from `arah_tpu_torch/csrc/` (first use, into
   `.cache/torch_ext/`) and prints the build time and each kernel's
   registers, spills and shared memory as ptxas reports them (B/L, the
   corr kernel, must not spill).
2. Builds the flagship bench scene (`scene.build_scene(pretrain=True)`:
   SIREN and skinning net fitted to the capsule body) and prints the
   fit's time and its loss at a fresh batch against the random init's.
3. Holds each kernel against its plain PyTorch version on the card, at
   the shapes of the flagship eval (8192 rays; 8192 x 64 = 524,288
   points), and times both: E march and F iso at their phase-1 shapes
   (8192 rays, 16 iterations) and phase-2 shapes (the stragglers: E
   resumed for 34 iterations, F from scratch at 50 steps); A knn, B corr
   (its `active` set too; also through the straggler split at its phase-2
   shape), C shade, D color_fwd.
4. Drives the port's main path: `render(training=False)` of the flagship
   scene for 3 frames of different poses, with the kernel launch counts
   set to 0 just before and read just after; traces one frame with
   torch.profiler (device time by kernel, the device's idle share);
   renders with the kernels and with the plain versions (splits off on
   both sides), in turns, and compares the two; and renders with the
   kernels with the splits on and off, in turns (the split A/B).
5. The tracer's unfused A/B path: holds J (siren) against its plain
   version at the 8,192 surface points and the 524,288 sample points of
   a flagship frame, K (knn_rows) at the world points of both, and L
   (corr_rows) against its plain version and against B on the frame's
   corr inputs; renders 3 frames with `ARAH_ENABLE_PALLAS=1` and the
   march, iso and corr-init kernel flags off (counted, so that J and K
   and not E, F or A run; one frame traced), compares that render with
   its switch-off twin (in turns, timed) and with the flagship render;
   then runs the corr-variant bench (`utils/bench_corr.main`, 262,144
   points), counted, for L, and holds L and B against the bench's plain
   solve on the bench's own inputs (L's record comes from those inputs).
6. Drives the train step (`scene.build_train_setup`: the flagship step of
   the JAX bench, one block of 8192 rays and 1,024 regulariser points).
   A warm-up step captures the inputs and cotangents the step hands
   kernels G (skin_jac), H (shade_bwd: the shading at N points in bf16
   and the eikonal at 1,024 points in f32) and I (color_bwd); each is
   held against its plain version on them and timed, and H must give the
   same bits on two calls. Then the main path of this phase: one step
   with the launch counts set to 0 just before and read just after, then
   timed steps; one profiled step; and one step with every kernel against
   one with every plain path (splits off on both sides) from the same
   state, batch and draws.

Prints the card (`nvidia-smi`), a `{"kernels": [...]}` line, and as its
last line `{"ok": true, "device": {...}}`. Any failed check exits
non-zero before those lines. Without a CUDA device it exits non-zero.
"""
import contextlib
import json
import os
import subprocess
import sys
import time

PEAK_F32 = 67e12        # H100 SXM, f32 outside the tensor cores (flop/s)
PEAK_BF16 = 989e12      # H100 SXM, dense bf16 tensor cores (flop/s)
PEAK_BYTES = 3.35e12    # H100 SXM HBM3 (B/s)
RAYS = 8192             # rays per frame: N = 524,288 (ray, sample) points
FRAMES = 3              # main-path frames, each with its own pose
REPS = 5                # timed repeats of each kernel and plain version
STEPS = 4               # timed train steps after the counted one
BENCH_POINTS = 262144   # the corr-variant bench (L's path)

FAILURES = []
# the kernels of the flagship train step (A-I); J, K and L run elsewhere
TRAIN_KERNELS = ('knn', 'corr', 'shade', 'color_fwd', 'march', 'iso',
                 'skin_jac', 'shade_bwd', 'color_bwd')
# J against its plain version, absolute: the JAX package's bound for the
# Pallas SIREN (tests/test_pallas.py:28)
J_TOL = 1e-5


def check(ok, msg):
    """Record a failed check; the run goes on to report the other phases
    and exits non-zero at the end, before the result lines."""
    if not ok:
        FAILURES.append(msg)
        print(f'FAILED: {msg}', flush=True)


def timed(fn, reps):
    """Device ms per call of fn (CUDA events around `reps` calls, after
    one warm-up call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def bound(nbytes, flops, peak):
    """(least ms, 'bytes' or 'operations') of work on the H100."""
    tb, to = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    return (tb, 'bytes') if tb >= to else (to, 'operations')


def q(a, p):
    import torch
    return float(torch.quantile(a.float().flatten()[:1 << 24], p))


def tile_max(iters, tile=16):
    """Iterations the kernels execute: each 16-ray tile runs until its
    slowest ray stops, so sum over tiles of (tile max x 16)."""
    import torch
    pad = (-iters.numel()) % tile
    it = torch.cat([iters.int(), iters.new_zeros(pad, dtype=torch.int32)])
    return int(it.reshape(-1, tile).max(dim=1)[0].sum()) * tile


def ptxas_report(log):
    """{kernel: {'registers', 'spill_stores', 'spill_loads', 'stack',
    'smem'}} from a build log of `nvcc -Xptxas -v` (names demangled to
    `name<template args>`)."""
    import re
    out, cur = {}, None
    for line in open(log):
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = demangle(m.group(1))
            out[cur] = {}
            continue
        if cur is None:
            continue
        for key, pat in (('stack', r'(\d+) bytes stack frame'),
                         ('spill_stores', r'(\d+) bytes spill stores'),
                         ('spill_loads', r'(\d+) bytes spill loads'),
                         ('registers', r'Used (\d+) registers'),
                         ('smem', r'(\d+) bytes smem')):
            m = re.search(pat, line)
            if m:
                out[cur][key] = int(m.group(1))
    return out


def demangle(sym):
    """`_Z16shade_bwd_kernelILb1EEv...` -> `shade_bwd_kernel<Lb1>`: the
    name and the raw template arguments of an Itanium-mangled kernel."""
    import re
    m = re.match(r'_Z(\d+)', sym)
    if not m:
        return sym
    i = m.end()
    name = sym[i:i + int(m.group(1))]
    t = re.match(r'I(.*?)E', sym[i + int(m.group(1)):])
    return f'{name}<{t.group(1)}>' if t else name


def card_line():
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        r = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                            '--format=csv,noheader'], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return 'nvidia-smi unavailable'
    lines = r.stdout.strip().splitlines()
    return lines[0] if r.returncode == 0 and lines \
        else 'nvidia-smi unavailable'


def main():
    import torch
    if not torch.cuda.is_available():
        print('no CUDA device: chip_smoke.py runs on the GPU only',
              file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from arah_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def no_tf32():
        check(not torch.backends.cuda.matmul.allow_tf32
              and not torch.backends.cudnn.allow_tf32, 'TF32 got enabled')

    card = card_line()
    print(f'card: {card}', flush=True)
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'python {sys.version.split()[0]}', flush=True)

    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    built = _build.BUILD_SECONDS
    print(f'kernels: load {build_s:.1f} s (nvcc build '
          f'{"cached" if built is None else f"{built:.1f} s"}) '
          f'-> {_build.library_path()}', flush=True)
    log = os.path.join(os.path.dirname(_build.library_path()), 'build.log')
    if os.path.exists(log):
        ptx = ptxas_report(log)
        for name, r in ptx.items():
            print(f'  ptxas: {name}: {r.get("registers")} registers, spill '
                  f'stores {r.get("spill_stores")} B, spill loads '
                  f'{r.get("spill_loads")} B, stack {r.get("stack")} B, '
                  f'smem {r.get("smem", 0)} B')
        corr = [r for name, r in ptx.items() if name == 'corr_rows_kernel']
        check(len(corr) == 1 and corr[0].get('spill_stores') == 0
              and corr[0].get('spill_loads') == 0,
              f'the corr kernel (B/L) spills or is missing: {corr}')

    from arah_tpu_torch.core.embedder import positional_encoding
    from arah_tpu_torch.nn.layers import wn_weight
    from arah_tpu_torch.nn.skinning import skinning_dense_params
    from arah_tpu_torch.ops.color import color_mlp_fused, color_mlp_plain
    from arah_tpu_torch.ops.corr import (corr_search, corr_search_plain,
                                         dense_skin_fn)
    from arah_tpu_torch.ops.knn import nn_idx, nn_idx_plain
    from arah_tpu_torch.ops.shade import siren_shade, siren_shade_plain
    from arah_tpu_torch.render.ray_tracing import (_corr_solve_split,
                                                   corr_init, sample_z_vals,
                                                   sphere_trace)
    from arah_tpu_torch.render.renderer import (generate_sdf, make_sdf_fn,
                                                make_skin_fn)
    from arah_tpu_torch.scene import build_scene, flagship_config

    cfg = flagship_config()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, fd, inp = build_scene(cfg, RAYS, seed=0)
    torch.cuda.synchronize()
    fit_report(cfg, params, fd, time.perf_counter() - t0)
    frame = fd.frame
    dev = inp.ray_dirs.device
    gen = generate_sdf(params, cfg, inp.rots, inp.Jtrs, inp.geo_latent)
    wts, bs = skinning_dense_params(params['skinning'], cfg.skinning)
    skin_dense = (wts, bs, cfg.skinning.softmax_scale)

    records = {}
    no_tf32()
    records['march'] = check_march(cfg, fd, inp, gen, card)
    no_tf32()
    records['iso'] = check_iso(cfg, params, fd, inp, gen, card)

    # ---- main-path inputs of A and B: the samples of one eval frame
    with torch.no_grad():
        cam = inp.cam_loc.expand(inp.ray_dirs.shape)
        surf = sphere_trace(cfg.tracer, make_sdf_fn(gen),
                            make_skin_fn(params, cfg), frame, fd.smpl, cam,
                            inp.ray_dirs, inp.near, inp.far, eval_mode=True,
                            sdf_gen=gen, skin_dense=skin_dense)
        z_vals, smask = sample_z_vals(cfg.tracer, ~surf.unconverged,
                                      surf.start_dis, inp.near, inp.far)
        pts = (cam[:, None, :] + z_vals[..., None]
               * inp.ray_dirs[:, None, :]).reshape(-1, 3).contiguous()
        flat_mask = smask.reshape(-1).contiguous()
    n_pts = pts.shape[0]
    verts = fd.smpl.verts_posed
    print(f'main-path inputs: {n_pts} points, {verts.shape[0]} verts, '
          f'{int(flat_mask.sum())} active samples, '
          f'{int((~surf.unconverged).sum())} surface rays', flush=True)

    # ---- A: knn
    no_tf32()
    idx_k = nn_idx(pts, verts).long()
    idx_p = nn_idx_plain(pts, verts).long()
    d_k = torch.linalg.norm(pts - verts[idx_k], dim=-1)
    d_p = torch.linalg.norm(pts - verts[idx_p], dim=-1)
    err = float((d_k - d_p).abs().max())
    print(f'A knn: max |d_kernel - d_plain| = {err:.3e} (bound 1e-5), '
          f'index agreement {float((idx_k == idx_p).float().mean()):.6f}')
    check(err < 1e-5, 'knn kernel disagrees with its plain version')
    nv = verts.shape[0]
    records['knn'] = dict(
        max_abs_err=err,
        ms=timed(lambda: nn_idx(pts, verts), REPS),
        plain_ms=timed(lambda: nn_idx_plain(pts, verts), REPS),
        bound=bound(n_pts * 16 + nv * 12, n_pts * nv * 8.0, PEAK_F32),
        src='arah_tpu_torch/csrc/knn.cu',
        rep='arah_tpu/ops/pallas/knn_kernel.py:106')

    # ---- B: corr. Phase 1 of the main path: every sample at
    # corr_phase1_steps iterations.
    no_tf32()
    with torch.no_grad():
        x_bar, x0, T0 = corr_init(cfg.tracer, frame, fd.smpl, pts)
    T0_16 = T0.reshape(n_pts, 16).contiguous()
    skin_fn = dense_skin_fn(wts, bs, cfg.skinning.softmax_scale)
    bones16 = frame.bone_transforms.reshape(24, 16).contiguous()
    steps = cfg.tracer.corr_phase1_steps
    kargs = (x_bar, x0, T0_16, flat_mask, wts, bs, bones16,
             frame.coord_min, frame.coord_max, frame.center)
    xk, _, vk, ak = corr_search(*kargs, max_steps=steps)
    xp, _, vp, ap_ = corr_search_plain(*kargs, max_steps=steps)
    max_dx = corr_compare(f'B corr phase 1 ({n_pts} points, {steps} steps)',
                          xk, vk, xp, vp, x_bar, frame, skin_fn)
    act_agree = float((ak == ap_).float().mean())
    print(f'  active at {steps} steps: kernel {int(ak.sum())} plain '
          f'{int(ap_.sum())}, agreement {act_agree:.6f} (bound >= 0.999)',
          flush=True)
    check(act_agree >= 0.999, 'B corr phase 1: the active set disagrees '
          'with the plain solve\'s')

    # Phase 2 and its write-back. Phase 1 cut to one iteration leaves
    # nearly every sample active, so the split re-solves the first
    # corr_resolve_cap of them at corr_max_steps and writes them back;
    # the kernel side must launch twice.
    no_tf32()
    tr1 = cfg.tracer._replace(corr_phase1_steps=1)
    c0 = _build.COUNTS['corr']
    with torch.no_grad():
        xk2, _, vk2, _ = _corr_solve_split(
            tr1, skin_fn, frame, (wts, bs, cfg.skinning.softmax_scale),
            x_bar, x0, T0, flat_mask)
        n_k = _build.COUNTS['corr'] - c0
        xp2, _, vp2, _ = _corr_solve_split(
            tr1._replace(use_pallas_corr=False), skin_fn, frame, None,
            x_bar, x0, T0, flat_mask)
    cap, p2_steps = cfg.tracer.corr_resolve_cap, cfg.tracer.corr_max_steps
    corr_compare(f'B corr split, phase 1 at 1 step, phase 2 on the first '
                 f'{cap} stragglers at {p2_steps} steps', xk2, vk2, xp2, vp2,
                 x_bar, frame, skin_fn)
    check(n_k == 2, f'corr split launched the kernel {n_k} times, not 2')
    sel = torch.nonzero(flat_mask).flatten()[:cap]
    kargs2 = (x_bar[sel].contiguous(), x0[sel].contiguous(),
              T0_16[sel].contiguous(), torch.ones_like(sel, dtype=torch.bool),
              wts, bs, bones16, frame.coord_min, frame.coord_max,
              frame.center)
    ms_k = timed(lambda: corr_search(*kargs2, max_steps=p2_steps), REPS)
    ms_p = timed(lambda: corr_search_plain(*kargs2, max_steps=p2_steps), 2)
    print(f'  phase-2 shape ({sel.numel()} points, {p2_steps} steps): kernel '
          f'{ms_k:.3f} ms, plain {ms_p:.3f} ms [{card}]', flush=True)
    del xk2, vk2, xp2, vp2

    # data-dependent work: each unmasked point's MLP evaluations (the init
    # one plus one per Broyden iteration it ran, from the plain solve of
    # this run); a masked point returns its init without any
    from arah_tpu_torch.solver.root_find import CanonicalFrame
    from arah_tpu_torch.solver.root_find import search_canonical_corr
    res = search_canonical_corr(
        skin_fn, CanonicalFrame(frame.bone_transforms,
                                torch.zeros(3, device=dev), frame.coord_min,
                                frame.coord_max, frame.center),
        x_bar, x0, T0, max_steps=steps, active_init=flat_mask)
    evals = float(int(flat_mask.sum()) + res.iters.sum())
    macs = sum(w.shape[0] * w.shape[1] for w in wts)
    flops_eval = 2 * macs + 4 * sum(w.shape[0] for w in wts[:-1]) \
        + 2 * 24 * 16 + 250
    records['corr'] = dict(
        max_abs_err=max_dx,
        ms=timed(lambda: corr_search(*kargs, max_steps=steps), REPS),
        plain_ms=timed(lambda: corr_search_plain(*kargs, max_steps=steps),
                       max(1, REPS // 2)),
        bound=bound(n_pts * (12 + 12 + 64 + 1 + 12 + 64 + 2)
                    + 4 * (macs + 600), evals * flops_eval, PEAK_F32),
        src='arah_tpu_torch/csrc/corr_rows.cu',
        rep='arah_tpu/ops/pallas/corr_kernel_t.py:291')
    print(f'  corr work: {evals:.0f} MLP evaluations '
          f'({float(res.iters.float().mean()):.3f} iterations per point, '
          f'max {int(res.iters.max())})')

    # ---- C: shade, random-init flagship gen, points uniform in [-1,1]^3
    g = torch.Generator(device='cpu').manual_seed(1)
    xs = (torch.rand((n_pts, 3), generator=g) * 2 - 1).to(dev)
    H = gen.weights[0].shape[0]
    shade_rec = {}
    for bf in (False, True):
        no_tf32()
        ok_, fk, gk = siren_shade(gen, xs, bf16=bf)
        op, fp, gp = siren_shade_plain(gen, xs, bf16=bf)
        ds = (ok_ - op).abs()
        df = (fk.float() - fp.float()).abs()
        dg = (gk - gp).abs()
        print(f'C shade bf16={bf}: median |d| sdf {float(ds.median()):.3e} '
              f'(bound 3e-3) feats {float(df.median()):.3e} (5e-2) normals '
              f'{float(dg.median()):.3e} (5e-2); p99 {q(ds, .99):.3e} '
              f'{q(df, .99):.3e} {q(dg, .99):.3e}; max '
              f'{float(ds.max()):.3e} {float(df.max()):.3e} '
              f'{float(dg.max()):.3e}', flush=True)
        check(float(ds.median()) < 3e-3 and float(df.median()) < 5e-2
              and float(dg.median()) < 5e-2,
              f'shade kernel (bf16={bf}) disagrees with its plain version')
        shade_rec[bf] = (float(ds.max()), fk, gk)
    L = len(gen.weights)
    macs_c = 3 * H + (L - 2) * H * H + H
    flops_c = n_pts * (2 * macs_c + 2 * ((L - 2) * H * H + 3 * H)
                       + 30 * H * (L - 1))
    bf = cfg.bf16_shading
    records['shade'] = dict(
        max_abs_err=shade_rec[bf][0],
        ms=timed(lambda: siren_shade(gen, xs, bf16=bf), REPS),
        plain_ms=timed(lambda: siren_shade_plain(gen, xs, bf16=bf),
                       REPS),
        bound=bound(n_pts * (12 + 4 + H * (2 if bf else 4) + 12)
                    + 8 * sum(w.numel() for w in gen.weights), flops_c,
                    PEAK_BF16 if bf else PEAK_F32),
        src='arah_tpu_torch/csrc/shade.cu',
        rep='arah_tpu/ops/pallas/shade_kernel.py:113')

    # ---- D: color forward, features from C, random view dirs/normals
    cw = [wn_weight(l) for l in params['color']['layers']]
    cb = [l['b'] for l in params['color']['layers']]
    vd = torch.nn.functional.normalize(torch.randn((n_pts, 3), generator=g),
                                       dim=-1).to(dev)
    small = torch.cat([xs, positional_encoding(vd, cfg.color.multires_view),
                       shade_rec[cfg.bf16_shading][2]], dim=-1).contiguous()
    pose = params['latent'][0][None]
    skips = tuple(cfg.color.skips)
    color_rec = {}
    for bf in (False, True):
        no_tf32()
        feats = shade_rec[bf][1]
        rk_ = color_mlp_fused(cw, cb, small, feats, pose, skips, bf16=bf)
        rp_ = color_mlp_plain(cw, cb, small, feats, pose, skips, bf16=bf)
        d = (rk_ - rp_).abs()
        msg = (f'D color_fwd bf16={bf}: max |d rgb| {float(d.max()):.3e}, '
               f'median {float(d.median()):.3e}, p99.9 {q(d, .999):.3e}')
        if bf:
            print(msg + ' (bounds median 1e-4, p99.9 1e-2)', flush=True)
            check(float(d.median()) < 1e-4 and q(d, .999) < 1e-2,
                  'color kernel (bf16) disagrees with its plain version')
        else:
            print(msg + ' (bound max 1e-4)', flush=True)
            check(float(d.max()) < 1e-4,
                  'color kernel (f32) disagrees with its plain version')
        color_rec[bf] = float(d.max())
    bf = cfg.bf16_shading
    feats = shade_rec[bf][1]
    macs_d = sum(w.shape[0] * w.shape[1] for w in cw)
    records['color_fwd'] = dict(
        max_abs_err=color_rec[bf],
        ms=timed(lambda: color_mlp_fused(cw, cb, small, feats, pose, skips,
                                         bf16=bf), REPS),
        plain_ms=timed(lambda: color_mlp_plain(cw, cb, small, feats, pose,
                                               skips, bf16=bf), REPS),
        bound=bound(n_pts * (small.shape[1] * 4 + feats.shape[1]
                             * feats.element_size() + 12) + 4 * macs_d,
                    n_pts * 2.0 * macs_d, PEAK_BF16 if bf else PEAK_F32),
        src='arah_tpu_torch/csrc/color.cu',
        rep='arah_tpu/ops/pallas/color_kernel.py:214')
    del xs, small, feats, shade_rec, res
    torch.cuda.empty_cache()

    launches, frames, flagship_out = run_render(cfg, params, fd, inp, card,
                                                gen, no_tf32)
    per = {name: 'over 3 frames' for name in launches}
    torch.cuda.empty_cache()
    # J and K count launches over the 3 A/B frames, L in the corr bench
    ab_records, ab_launches = run_ab(cfg, params, fd, frames, flagship_out,
                                     card, gen, skin_dense, no_tf32)
    records.update(ab_records)
    launches.update(ab_launches)
    per.update(siren='over 3 A/B frames', knn_rows='over 3 A/B frames',
               corr_rows='in the corr bench')
    del inp, gen, frames, flagship_out
    torch.cuda.empty_cache()
    # G, H and I count launches per train step (the eval path runs none)
    train_records, train_launches = run_train(cfg, params, fd, card,
                                              no_tf32)
    records.update(train_records)
    for name in train_records:
        launches[name] = train_launches[name]
        per[name] = 'per train step'

    out = []
    for name, r in records.items():
        out.append({'name': name, 'route': 'cuda', 'source': r['src'],
                    'replaces': r['rep'], 'launches': launches[name],
                    'max_abs_err': r['max_abs_err'], 'ms': r['ms'],
                    'plain_ms': r['plain_ms'], 'bound_ms': r['bound'][0],
                    'bound_by': r['bound'][1], 'library_ms': None})
        print(f'{name}: {r["ms"]:.3f} ms kernel, {r["plain_ms"]:.3f} ms '
              f'plain, bound {r["bound"][0]:.4f} ms ({r["bound"][1]}), '
              f'launches {launches[name]} {per[name]} [{card}]')
    if FAILURES:
        print(f'{len(FAILURES)} check(s) failed: {FAILURES}', flush=True)
        sys.exit(1)
    print('library_ms: null for all twelve: no single PyTorch call computes '
          'a nearest-vertex argmin, a Broyden solve, a SIREN (with or '
          'without its input gradient), a split-input MLP, a sphere-trace '
          'loop, a skinning Jacobian or the backward of a SIREN or of a '
          'split-input MLP')
    print(json.dumps({'kernels': out}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


def fit_report(cfg, params, fd, build_s):
    """The fit's time, and its loss at a fresh batch of 8,192 points
    against the random init's (the fit must have lowered it)."""
    import numpy as np
    import torch
    from arah_tpu_torch.data.synthetic import synthetic_smpl
    from arah_tpu_torch.model import init_model_params
    from arah_tpu_torch.scene import N_VERTS, scene_frame
    from arah_tpu_torch.utils.bench_scene import (capsule_segments_02v,
                                                  sample_points, scene_loss)
    dev = fd.verts_cano.device
    model = synthetic_smpl(n_verts=N_VERTS)
    betas = scene_frame(model, np.random.RandomState(0), dev)[1]
    seg = capsule_segments_02v(model, torch.as_tensor(betas, device=dev))
    x = sample_points(fd, 8192, torch.Generator(device=dev).manual_seed(7))
    init = init_model_params(torch.Generator().manual_seed(0), cfg,
                             n_latent_frames=4, device=dev)
    with torch.enable_grad():
        l_fit = float(scene_loss(params, cfg, fd, *seg, x).detach())
        l_init = float(scene_loss(init, cfg, fd, *seg, x).detach())
    print(f'scene: flagship, {RAYS} rays, seed 0; build_scene(pretrain=True) '
          f'{build_s:.1f} s with the fit (800 Adam steps of 8192 points); '
          f'loss at a fresh 8192-point batch: fitted {l_fit:.5f}, random '
          f'init {l_init:.5f}', flush=True)
    check(np.isfinite(l_fit) and l_fit < l_init,
          'the bench-scene fit did not lower the loss')


def march_compare(tag, out_k, out_p, gen, mscale, thresh):
    """Hold kernel E's march (out_k) against the plain one (out_p):
    unfinished and diverged agreement >= 0.99, median |dt| < 1e-5 on rays
    both sides finished on a surface, and >= 0.9 of the rays that differ
    (a flag, or |dt| > 1e-4) and that the kernel finished on a surface
    hold it: plain |sdf| at the kernel's x_norm < 2 x thresh. Returns the
    max |dt| on commonly finished rays."""
    import torch
    from arah_tpu_torch.nn.siren import siren_apply
    t_k, unf_k, div_k, xn_k = out_k[:4]
    t_p, unf_p, div_p, xn_p = out_p[:4]
    a_unf = float((unf_k == unf_p).float().mean())
    a_div = float((div_k == div_p).float().mean())
    fin = ~unf_k & ~div_k & ~unf_p & ~div_p
    dt_all = (t_k - t_p).abs()
    dt = dt_all[fin]
    dx = torch.linalg.norm(xn_k - xn_p, dim=-1)[fin]
    med_t = float(dt.median()) if dt.numel() else 0.0
    max_t = float(dt.max()) if dt.numel() else 0.0
    med_x = float(dx.median()) if dx.numel() else 0.0
    max_x = float(dx.max()) if dx.numel() else 0.0
    differ = (unf_k != unf_p) | (div_k != div_p) | (fin & (dt_all > 1e-4))
    sel = differ & ~unf_k & ~div_k
    share = 1.0
    if bool(sel.any()):
        with torch.no_grad():
            sdf = siren_apply(gen, xn_k[sel])[:, 0] * mscale
        share = float((sdf.abs() < 2 * thresh).float().mean())
    print(f'{tag}: unfinished agreement {a_unf:.6f}, diverged agreement '
          f'{a_div:.6f} (bounds >= 0.99); on {int(fin.sum())} rays both '
          f'finished: |dt| median {med_t:.3e} (bound 1e-5) max {max_t:.3e}, '
          f'|dx_norm| median {med_x:.3e} max {max_x:.3e}; {int(differ.sum())}'
          f' rays differ, {int(sel.sum())} of them kernel-finished, share '
          f'on the surface {share:.4f} (bound >= 0.9); unfinished kernel '
          f'{int(unf_k.sum())} plain {int(unf_p.sum())}', flush=True)
    check(a_unf >= 0.99 and a_div >= 0.99 and med_t < 1e-5 and share >= 0.9,
          f'{tag}: march kernel disagrees with its plain version')
    return max_t


def check_march(cfg, fd, inp, gen, card):
    """Kernel E against `sphere_march_plain` at the main path's two
    shapes; its record (phase-1 times, bound from the plain run's
    per-ray iterations)."""
    import torch
    from arah_tpu_torch.ops.march import (kernel_affine, sphere_march,
                                          sphere_march_plain)
    tr = cfg.tracer
    frame, smpl = fd.frame, fd.smpl
    cam = inp.cam_loc.expand(inp.ray_dirs.shape).contiguous()
    p1, cap = tr.march_phase1_steps, tr.march_resolve_cap
    p2 = tr.sphere_tracing_iters - p1
    mscale = kernel_affine(frame)[2]

    def run(fn, c, d, near, far, iters):
        return fn(c, d, near, far, smpl.verts_posed, smpl.skinning_weights,
                  frame, gen, n_iters=iters,
                  thresh=tr.root_finding_threshold, clamp_dist=tr.clamp_dist)

    a1 = (cam, inp.ray_dirs, inp.near, inp.far, p1)
    k1, o1 = run(sphere_march, *a1), run(sphere_march_plain, *a1)
    err = march_compare(f'E march phase 1 ({RAYS} rays, {p1} iterations)',
                        k1, o1, gen, mscale, tr.root_finding_threshold)
    ms = timed(lambda: run(sphere_march, *a1), REPS)
    plain_ms = timed(lambda: run(sphere_march_plain, *a1), 2)
    # phase 2: the first `cap` stragglers of the plain phase 1, resumed
    # from their depth with the remaining budget
    idx = torch.nonzero(o1[1]).flatten()[:cap]
    if idx.numel():
        a2 = (cam[idx], inp.ray_dirs[idx], o1[0][idx], inp.far[idx], p2)
        k2, o2 = run(sphere_march, *a2), run(sphere_march_plain, *a2)
        march_compare(f'E march phase 2 ({idx.numel()} stragglers of '
                      f'{int(o1[1].sum())}, {p2} iterations)', k2, o2, gen,
                      mscale, tr.root_finding_threshold)
        print(f'  phase-2 shape: kernel '
              f'{timed(lambda: run(sphere_march, *a2), REPS):.3f} ms, '
              f'plain {timed(lambda: run(sphere_march_plain, *a2), 2):.3f}'
              f' ms; ray-iterations {int(o2[5].sum())} (tile max '
              f'{tile_max(o2[5])}) [{card}]', flush=True)
    else:
        print('E march phase 2: no stragglers after phase 1')
    # least work: each ray-iteration the plain run needed, at the SIREN's
    # multiply-adds, 8 flops per vertex of the scan and the bone blend
    nv = smpl.verts_posed.shape[0]
    macs = sum(w.numel() for w in gen.weights)
    flops_it = 2 * macs + 8 * nv + 2 * 24 * 16
    its = int(o1[5].sum())
    nbytes = RAYS * (12 + 12 + 4 + 4 + 4 + 1 + 1 + 12 + 64) + nv * 108 \
        + 4 * sum(w.numel() + w.shape[0] for w in gen.weights)
    b = bound(nbytes, its * float(flops_it), PEAK_F32)
    print(f'  E work at phase 1: {its} ray-iterations ({its / RAYS:.3f} per '
          f'ray, max {int(o1[5].max())}); the kernel runs {tile_max(o1[5])} '
          f'(16-ray tiles to their slowest ray); {flops_it} flops each; '
          f'kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b[0]:.4f} '
          f'ms [{card}]', flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound=b,
                src='arah_tpu_torch/csrc/march.cu',
                rep='arah_tpu/ops/pallas/march_kernel.py:175')


def iso_compare(tag, out_k, out_p, resid):
    """Hold kernel F's solve (out_k) against the plain one (out_p): valid
    agreement >= 0.99, median |dx_hat| < 1e-5 on commonly valid rays, and
    every kernel-valid ray a root of the plain residual (|g(u)| < 5e-5).
    resid(sel, u) -> |g(u)| of rays sel. Returns the max |dx_hat| on
    commonly valid rays."""
    import torch
    u_k, _, v_k, a_k = out_k[:4]
    u_p, _, v_p, a_p = out_p[:4]
    agree = float((v_k == v_p).float().mean())
    both = v_k & v_p
    dx = torch.linalg.norm(u_k[:, :3] - u_p[:, :3], dim=-1)[both]
    dz = (u_k[:, 3] - u_p[:, 3]).abs()[both]
    med_x = float(dx.median()) if dx.numel() else 0.0
    max_x = float(dx.max()) if dx.numel() else 0.0
    med_z = float(dz.median()) if dz.numel() else 0.0
    sel = torch.nonzero(v_k).flatten()
    r_max = float(resid(sel, u_k[sel]).max()) if sel.numel() else 0.0
    print(f'{tag}: valid agreement {agree:.6f} (bound >= 0.99); on '
          f'{int(both.sum())} commonly valid rays |dx_hat| median '
          f'{med_x:.3e} (bound 1e-5) max {max_x:.3e}, |dz| median '
          f'{med_z:.3e}; max |g(u)| over kernel-valid rays {r_max:.3e} '
          f'(bound 5e-5); valid kernel {int(v_k.sum())} plain '
          f'{int(v_p.sum())}, active kernel {int(a_k.sum())} plain '
          f'{int(a_p.sum())}', flush=True)
    check(agree >= 0.99 and med_x < 1e-5 and r_max < 5e-5,
          f'{tag}: iso kernel disagrees with its plain version')
    return max_x


def check_iso(cfg, params, fd, inp, gen, card):
    """Kernel F against `iso_refine_plain` at the main path's two shapes,
    from the main path's march (kernel E with its split); its record."""
    import torch
    from arah_tpu_torch.core.body import unnormalize_canonical_points
    from arah_tpu_torch.nn.skinning import skinning_dense_params
    from arah_tpu_torch.ops.iso import (iso_refine, iso_refine_plain,
                                        iso_residual)
    from arah_tpu_torch.render.ray_tracing import _march_split
    from arah_tpu_torch.render.renderer import make_sdf_fn, make_skin_fn
    from arah_tpu_torch.solver.root_find import iso_init_inv_jacobian
    tr = cfg.tracer
    frame = fd.frame
    dirs = inp.ray_dirs
    cam = inp.cam_loc.expand(dirs.shape).contiguous()
    wts, bs = skinning_dense_params(params['skinning'], cfg.skinning)
    scale = cfg.skinning.softmax_scale
    sdf_fn, skin_fn = make_sdf_fn(gen), make_skin_fn(params, cfg)
    with torch.no_grad():
        c = _march_split(tr, sdf_fn, frame, fd.smpl, cam, dirs, inp.near,
                         inp.far, gen)
        x_hat = unnormalize_canonical_points(c.x_norm, frame.coord_min,
                                             frame.coord_max, frame.center)
        J0 = iso_init_inv_jacobian(sdf_fn, skin_fn, frame, dirs, x_hat)
    u0 = torch.cat([x_hat, c.t[:, None]], dim=-1).contiguous()
    T0 = c.T_fwd.reshape(RAYS, 16).contiguous()
    J0 = J0.reshape(RAYS, 16).contiguous()
    mask = (~c.diverged).contiguous()

    def run(fn, rays, steps):
        return fn(*rays, wts, bs, frame, gen, max_steps=steps,
                  cvg_thresh=tr.root_finding_threshold, softmax_scale=scale)

    def resid_of(rays):
        def resid(sel, u):
            g = iso_residual(rays[0][sel], rays[1][sel], wts, bs, frame, gen,
                             scale)
            with torch.no_grad():
                return torch.linalg.norm(g(u)[0], dim=-1)
        return resid

    p1, cap = tr.iso_phase1_steps, tr.iso_resolve_cap
    rays1 = (cam, dirs, u0, T0, J0, mask)
    k1, o1 = run(iso_refine, rays1, p1), run(iso_refine_plain, rays1, p1)
    err = iso_compare(f'F iso phase 1 ({RAYS} rays, {p1} steps)', k1, o1,
                      resid_of(rays1))
    ms = timed(lambda: run(iso_refine, rays1, p1), REPS)
    plain_ms = timed(lambda: run(iso_refine_plain, rays1, p1), 2)
    # phase 2: the first `cap` rays still active after the plain phase 1,
    # re-solved from scratch at iso_max_steps
    idx = torch.nonzero(o1[3]).flatten()[:cap]
    if idx.numel():
        rays2 = tuple(a[idx] for a in rays1[:5]) \
            + (torch.ones_like(idx, dtype=torch.bool),)
        steps = tr.iso_max_steps
        k2, o2 = run(iso_refine, rays2, steps), \
            run(iso_refine_plain, rays2, steps)
        iso_compare(f'F iso phase 2 ({idx.numel()} stragglers of '
                    f'{int(o1[3].sum())}, {steps} steps)', k2, o2,
                    resid_of(rays2))
        ms2 = timed(lambda: run(iso_refine, rays2, steps), REPS)
        plain2 = timed(lambda: run(iso_refine_plain, rays2, steps), 2)
        print(f'  phase-2 shape: kernel {ms2:.3f} ms, plain {plain2:.3f} ms;'
              f' ray-iterations {int(o2[4].sum())} (tile max '
              f'{tile_max(o2[4])}) [{card}]', flush=True)
    else:
        print('F iso phase 2: no stragglers after phase 1')
    # least work: one residual evaluation per ray at init plus one per
    # Broyden iteration the plain run needed: SIREN and skinning MLP
    # multiply-adds, ~200 flops of softmax, blend and 4x4 algebra
    macs = sum(w.numel() for w in gen.weights) + sum(w.numel() for w in wts)
    flops_ev = 2 * macs + 2 * 24 * 16 + 200
    evals = RAYS + int(o1[4].sum())
    nbytes = RAYS * (12 + 12 + 16 + 64 + 64 + 1 + 16 + 64 + 1 + 1) \
        + 4 * sum(w.numel() + w.shape[0] for w in list(gen.weights)
                  + list(wts))
    b = bound(nbytes, evals * float(flops_ev), PEAK_F32)
    print(f'  F work at phase 1: {evals} residual evaluations '
          f'({int(o1[4].sum()) / RAYS:.3f} iterations per ray, max '
          f'{int(o1[4].max())}); the kernel runs {RAYS + tile_max(o1[4])} '
          f'(16-ray tiles to their slowest ray); {flops_ev} flops each; '
          f'kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b[0]:.4f} '
          f'ms [{card}]', flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound=b,
                src='arah_tpu_torch/csrc/iso.cu',
                rep='arah_tpu/ops/pallas/iso_kernel.py:209')


def corr_compare(tag, xk, vk, xp, vp, x_bar, frame, skin_fn):
    """Hold a corr kernel's solve (xk, vk) against another (xp, vp):
    valid agreement >= 0.99, median |dx| < 1e-5 on commonly-valid points,
    and every flip (|dx| > 1e-4) a root on both sides (|fwd_skin(x) -
    x_bar| < 1e-5). Returns the max |dx| on commonly-valid points."""
    import torch
    from arah_tpu_torch.core.body import normalize_canonical_points
    from arah_tpu_torch.core.body import skinning as lbs

    def resid(x_hat, target):
        with torch.no_grad():
            xn = normalize_canonical_points(x_hat, frame.coord_min,
                                            frame.coord_max, frame.center)
            xb, _ = lbs(x_hat, skin_fn(xn), frame.bone_transforms)
        return torch.linalg.norm(xb - target, dim=-1)

    agree = float((vk == vp).float().mean())
    both = vk & vp
    dist = torch.linalg.norm(xk - xp, dim=-1)
    dx = dist[both]
    med = float(dx.median()) if dx.numel() else 0.0
    mx = float(dx.max()) if dx.numel() else 0.0
    p99 = float(torch.quantile(dx[:1 << 24], 0.99)) if dx.numel() else 0.0
    fi = torch.nonzero(both & (dist > 1e-4)).flatten()
    rk, rp = resid(xk[fi], x_bar[fi]), resid(xp[fi], x_bar[fi])
    flip_ok = bool(((rk < 1e-5) & (rp < 1e-5)).all())
    r_max = float(torch.cat([rk, rp, rk.new_zeros(1)]).max())
    print(f'{tag}: valid agreement {agree:.6f} (bound >= 0.99), median |dx| '
          f'{med:.3e} (bound 1e-5), p99 {p99:.3e}, max {mx:.3e} on '
          f'{int(both.sum())} commonly-valid points; {fi.numel()} flips '
          f'(>1e-4) with residual max {r_max:.3e} (bound 1e-5 both sides); '
          f'valid kernel {int(vk.sum())} plain {int(vp.sum())}', flush=True)
    check(agree >= 0.99 and med < 1e-5 and flip_ok,
          f'{tag}: corr kernel disagrees with its plain version')
    return mx


def run_render(cfg, params, fd, inp, card, gen, no_tf32):
    """The main path (counted) and the kernels-vs-plain render."""
    import numpy as np
    import torch
    from arah_tpu_torch.data.synthetic import synthetic_smpl
    from arah_tpu_torch.ops import _build
    from arah_tpu_torch.render.renderer import render
    from arah_tpu_torch.scene import N_VERTS, scene_frame, scene_inputs

    dev = inp.ray_dirs.device
    model = synthetic_smpl(n_verts=N_VERTS)
    rng = np.random.RandomState(100)
    frames = [inp] + [scene_inputs(params, scene_frame(model, rng, dev)[0],
                                   RAYS, rng, dev)
                      for _ in range(FRAMES - 1)]
    render(params, cfg, frames[0])              # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    t0 = time.perf_counter()
    outs = [render(params, cfg, f) for f in frames]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.COUNTS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for i, o in enumerate(outs):
        rgb = o['rgb_values']
        check(bool(torch.isfinite(rgb).all())
              and bool(torch.isfinite(o['weights_sum']).all()),
              f'frame {i}: non-finite output')
        check(bool(((rgb >= 0) & (rgb <= 1)).all()), f'frame {i}: rgb '
              'outside [0, 1]')
        check(tuple(rgb.shape) == (RAYS, 3), f'frame {i}: rgb shape')
        nb = int(o['network_body_mask'].sum())
        check(nb > 0, f'frame {i}: empty network_body_mask')
        check(float(o['weights_sum'].max()) > 0.5, f'frame {i}: black frame')
        print(f'frame {i}: body rays {nb}, surface-converged '
              f'{int(o["surface_converged"].sum())}, valid samples '
              f'{int(o["n_samples_valid"])}, mean rgb '
              f'{float(rgb.mean()):.4f}, mean weights_sum '
              f'{float(o["weights_sum"].mean()):.4f}')
    eval_kernels = ('knn', 'corr', 'shade', 'color_fwd', 'march', 'iso')
    check(all(launches[k] > 0 for k in eval_kernels),
          f'a kernel was not launched on the main path: {launches}')
    ms = wall / len(frames) * 1e3
    print(f'main path: {len(frames)} frames x {RAYS} rays: '
          f'{ms:.1f} ms/frame, {RAYS / (ms / 1e3):.0f} rays/s, peak '
          f'memory {peak:.2f} GiB, launches {launches} [{card}]',
          flush=True)

    profile_frame(lambda: render(params, cfg, frames[0]), ms, card)

    # kernels vs plain, splits off on both sides, rendered in turns (the
    # host's clock varies by ~100 ms between repeats of one frame)
    cfg_k = splits_off(cfg)
    cfg_p = plain_cfg(cfg_k)
    res, t = {}, {'k': [], 'p': []}
    for tag in ('p', 'k', 'k', 'p') * 2:
        no_tf32()
        torch.cuda.synchronize()
        s = time.perf_counter()
        res[tag] = render(params, cfg_k if tag == 'k' else cfg_p, inp)
        torch.cuda.synchronize()
        t[tag].append((time.perf_counter() - s) * 1e3)
    render_gate('render kernels vs plain (splits off)', res['k'], res['p'],
                gen)
    print(f'render splits off, one frame of {RAYS} rays, in turns '
          f'(plain, kernels, kernels, plain) x 2: kernels median '
          f'{float(np.median(t["k"])):.1f} ms {[round(v, 1) for v in t["k"]]}'
          f', plain median {float(np.median(t["p"])):.1f} ms '
          f'{[round(v, 1) for v in t["p"]]} [{card}]', flush=True)

    # the straggler splits, on (the flagship) against off, kernels on both
    # sides, one frame, in turns
    t = {'on': [], 'off': []}
    for tag in ('on', 'off', 'off', 'on') * 2:
        torch.cuda.synchronize()
        s = time.perf_counter()
        res[tag] = render(params, cfg if tag == 'on' else cfg_k, inp)
        torch.cuda.synchronize()
        t[tag].append((time.perf_counter() - s) * 1e3)
    same = float((res['on']['surface_converged']
                  == res['off']['surface_converged']).float().mean())
    print(f'split A/B, kernel render of one frame of {RAYS} rays, in turns '
          f'(on, off, off, on) x 2: splits on median '
          f'{float(np.median(t["on"])):.1f} ms '
          f'{[round(v, 1) for v in t["on"]]}, splits off median '
          f'{float(np.median(t["off"])):.1f} ms '
          f'{[round(v, 1) for v in t["off"]]}; surface agreement {same:.5f}'
          f' [{card}]', flush=True)
    profile_frame(lambda: render(params, cfg_k, inp),
                  float(np.median(t['off'])), card,
                  tag='one frame with the splits off')
    return launches, frames, outs[0]


def render_gate(tag, ok_, op, gen):
    """The render gate of PERF.md §2 between two renders of one frame:
    body-mask agreement > 0.98, rgb median |d| < 1e-2 and depth median
    |d| < 1e-4 on rays both sides keep, and > 0.9 of the rays that flip
    (mask, or depth by > 1e-3) on a valid root (|sdf| < 5e-3) on each
    side that found a surface."""
    import torch
    from arah_tpu_torch.nn.siren import siren_apply
    m_a, m_b = ok_['network_body_mask'], op['network_body_mask']
    both = m_a & m_b
    agree = float((m_a == m_b).float().mean())
    d_rgb = (ok_['rgb_values'] - op['rgb_values']).abs()[both].flatten()
    d_dep = (ok_['surface_depth'] - op['surface_depth']).abs()[both]
    rgb_med = float(d_rgb.median()) if d_rgb.numel() else 0.0
    dep_med = float(d_dep.median()) if d_dep.numel() else 0.0
    flipped = (m_a != m_b) | (both & ((ok_['surface_depth']
                                       - op['surface_depth']).abs() > 1e-3))
    fracs = []
    for o in (ok_, op):
        sel = flipped & o['surface_converged'] & o['network_body_mask']
        if bool(sel.any()):
            with torch.no_grad():
                r = siren_apply(gen, o['surface_points_norm'][sel])[:, 0]
            fracs.append(float((r.abs() < 5e-3).float().mean()))
    fvf = min(fracs) if fracs else 1.0
    print(f'{tag}: mask agreement {agree:.5f} (bound > 0.98), rgb median '
          f'{rgb_med:.3e} (< 1e-2), depth median {dep_med:.3e} (< 1e-4), '
          f'flipped rays {int(flipped.sum())}, flipped_valid_frac {fvf:.4f} '
          f'(> 0.9); surface rays {int(ok_["surface_converged"].sum())} '
          f'against {int(op["surface_converged"].sum())}', flush=True)
    check(agree > 0.98 and rgb_med < 1e-2 and dep_med < 1e-4 and fvf > 0.9,
          f'{tag}: the renders disagree')


def splits_off(cfg):
    """cfg with the straggler splits off (every solve in one pass)."""
    return cfg._replace(tracer=cfg.tracer._replace(
        corr_phase1_steps=0, march_phase1_steps=0, iso_phase1_steps=0))


def plain_cfg(cfg):
    """cfg with every kernel flag off: the plain torch paths (autograd
    for the training gradients, forward-mode tangents for the skinning
    Jacobian)."""
    return cfg._replace(
        use_pallas_shade=False, use_pallas_shade_grad=False,
        idiff_standalone_jac=False,
        color=cfg.color._replace(use_pallas=False),
        tracer=cfg.tracer._replace(use_pallas_knn=False,
                                   use_pallas_corr=False,
                                   use_pallas_march=False,
                                   use_pallas_iso=False))


def ab_cfg(cfg):
    """cfg with the march, iso and corr-init kernel flags off: the
    tracer's unfused loops, which reach J and K under the switch."""
    return cfg._replace(tracer=cfg.tracer._replace(
        use_pallas_march=False, use_pallas_iso=False, use_pallas_knn=False))


@contextlib.contextmanager
def pallas_switch(on=True):
    """`ARAH_ENABLE_PALLAS` set to 1 (or unset) inside, restored after."""
    old = os.environ.pop('ARAH_ENABLE_PALLAS', None)
    if on:
        os.environ['ARAH_ENABLE_PALLAS'] = '1'
    try:
        yield
    finally:
        os.environ.pop('ARAH_ENABLE_PALLAS', None)
        if old is not None:
            os.environ['ARAH_ENABLE_PALLAS'] = old


def run_ab(cfg, params, fd, frames, flagship_out, card, gen, skin_dense,
           no_tf32):
    """Step 5 of the module docstring. Returns (records of J, K and L,
    their launches: J and K over the 3 counted A/B frames, L in the
    counted corr bench)."""
    import numpy as np
    import torch
    from arah_tpu_torch.ops import _build
    from arah_tpu_torch.ops.corr import corr_search, dense_skin_fn
    from arah_tpu_torch.ops.corr_rows import (corr_search_rows,
                                              corr_search_rows_plain)
    from arah_tpu_torch.ops.knn import nn_idx_plain, nn_idx_rows
    from arah_tpu_torch.ops.siren import siren_sdf, siren_sdf_plain
    from arah_tpu_torch.render.ray_tracing import corr_init, trace_and_sample
    from arah_tpu_torch.render.renderer import (make_sdf_fn, make_skin_fn,
                                                render)
    from arah_tpu_torch.utils import bench_corr

    # ---- the inputs J, K and L meet on frame 0 (flagship kernels)
    inp, frame, smpl = frames[0], fd.frame, fd.smpl
    cam = inp.cam_loc.expand(inp.ray_dirs.shape)
    with torch.no_grad():
        tr = trace_and_sample(cfg.tracer, make_sdf_fn(gen),
                              make_skin_fn(params, cfg), frame, smpl, cam,
                              inp.ray_dirs, inp.near, inp.far,
                              skin_dense=skin_dense, sdf_gen=gen)
    s = tr.samples
    xs = {RAYS: tr.surface.points_norm.contiguous(),
          s.points_norm.numel() // 3: s.points_norm.reshape(-1, 3)
          .contiguous()}
    ws = {RAYS: (cam + tr.surface.start_dis[:, None]
                 * inp.ray_dirs).contiguous(),
          s.z_vals.numel(): (cam[:, None, :] + s.z_vals[..., None]
                             * inp.ray_dirs[:, None, :]).reshape(-1, 3)
          .contiguous()}
    verts = smpl.verts_posed
    nv = verts.shape[0]
    macs_j = sum(w.numel() for w in gen.weights)
    recs = {}
    for n, x in xs.items():
        no_tf32()
        d = (siren_sdf(gen, x) - siren_sdf_plain(gen, x)).abs()
        ms = timed(lambda: siren_sdf(gen, x), REPS)
        plain_ms = timed(lambda: siren_sdf_plain(gen, x), REPS)
        b = bound(n * 16 + 4 * sum(w.numel() + w.shape[0]
                                   for w in gen.weights),
                  n * 2.0 * macs_j, PEAK_F32)
        print(f'J siren ({n} normalised points of frame 0): max |d| '
              f'{float(d.max()):.3e} (bound {J_TOL:g}), median '
              f'{float(d.median()):.3e}; kernel {ms:.3f} ms, plain '
              f'{plain_ms:.3f} ms, bound {b[0]:.4f} ms ({b[1]}) [{card}]',
              flush=True)
        check(float(d.max()) < J_TOL,
              f'siren kernel disagrees with its plain version at {n}')
        recs.setdefault('siren', dict(
            max_abs_err=float(d.max()), ms=ms, plain_ms=plain_ms, bound=b,
            src='arah_tpu_torch/csrc/siren.cu',
            rep='arah_tpu/ops/pallas/siren_kernel.py:54'))
    for n, p in ws.items():
        ik, ip = nn_idx_rows(p, verts), nn_idx_plain(p, verts)
        same = bool(torch.equal(ik, ip))
        ms = timed(lambda: nn_idx_rows(p, verts), REPS)
        plain_ms = timed(lambda: nn_idx_plain(p, verts), REPS)
        b = bound(n * 16 + nv * 12, n * nv * 8.0, PEAK_F32)
        print(f'K knn_rows ({n} world points of frame 0, {nv} verts): '
              f'indices equal at every point {same} ({int((ik != ip).sum())}'
              f' differ); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound '
              f'{b[0]:.4f} ms ({b[1]}) [{card}]', flush=True)
        check(same, f'knn_rows kernel disagrees with its plain version at '
              f'{n}')
        recs.setdefault('knn_rows', dict(
            max_abs_err=float((ik - ip).abs().max()), ms=ms,
            plain_ms=plain_ms, bound=b, src='arah_tpu_torch/csrc/knn.cu',
            rep='arah_tpu/ops/pallas/knn_kernel.py:42'))

    # ---- L on the frame's corr inputs (single pass, corr_max_steps)
    no_tf32()
    wts, bs, scale = skin_dense
    wts_t = [w.t() for w in wts]
    pts = ws[s.z_vals.numel()]
    with torch.no_grad():
        x_bar, x0, T0 = corr_init(cfg.tracer, frame, smpl, pts)
    flat_mask = s.sample_mask.reshape(-1).contiguous()
    bones16 = frame.bone_transforms.reshape(24, 16).contiguous()
    largs = (x_bar, x0, T0.reshape(-1, 16).contiguous(), flat_mask, wts_t,
             bs, bones16, frame.coord_min, frame.coord_max, frame.center)
    steps = cfg.tracer.corr_max_steps
    lk = corr_search_rows(*largs, max_steps=steps, softmax_scale=scale)
    lp = corr_search_rows_plain(*largs, max_steps=steps, softmax_scale=scale)
    bk = corr_search(*largs[:4], wts, *largs[5:], max_steps=steps,
                     softmax_scale=scale)
    skin_fn = dense_skin_fn(wts, bs, scale)
    n_pts = pts.shape[0]
    corr_compare(f'L corr_rows vs plain ({n_pts} points of frame 0, {steps} '
                 f'steps)', lk[0], lk[2], lp[0], lp[2], x_bar, frame, skin_fn)
    corr_compare('L corr_rows vs B corr (same inputs)', lk[0], lk[2], bk[0],
                 bk[2], x_bar, frame, skin_fn)
    ms_l = timed(lambda: corr_search_rows(*largs, max_steps=steps,
                                          softmax_scale=scale), REPS)
    ms_b = timed(lambda: corr_search(*largs[:4], wts, *largs[5:],
                                     max_steps=steps, softmax_scale=scale),
                 REPS)
    print(f'  L on these inputs: kernel {ms_l:.3f} ms, B {ms_b:.3f} ms '
          f'[{card}]', flush=True)
    del lk, lp, bk, largs, x_bar, x0, T0, tr, s, xs, ws, pts

    # ---- the A/B render: 3 frames counted, one traced
    cfg_ab = ab_cfg(cfg)
    with pallas_switch():
        no_tf32()
        render(params, cfg_ab, frames[0])          # warm-up, not counted
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_counts()
        t0 = time.perf_counter()
        outs = [render(params, cfg_ab, f) for f in frames]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.COUNTS)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ms = wall / len(frames) * 1e3
        profile_frame(lambda: render(params, cfg_ab, frames[0]), ms, card,
                      tag='one A/B frame')
    for i, o in enumerate(outs):
        rgb = o['rgb_values']
        check(bool(torch.isfinite(rgb).all()) and tuple(rgb.shape)
              == (RAYS, 3) and bool(o['network_body_mask'].any()),
              f'A/B frame {i}: non-finite, misshapen or empty')
    print(f'A/B path (ARAH_ENABLE_PALLAS=1; use_pallas_march, _iso, _knn '
          f'off): {len(frames)} frames x {RAYS} rays: {ms:.1f} ms/frame, '
          f'{RAYS / (ms / 1e3):.0f} rays/s, peak memory {peak:.2f} GiB, '
          f'launches {launches} [{card}]', flush=True)
    check(all(launches[k] > 0 for k in ('siren', 'knn_rows', 'corr',
                                        'shade', 'color_fwd'))
          and all(launches[k] == 0 for k in ('march', 'iso', 'knn')),
          f'the A/B path launched the wrong kernels: {launches}')
    res, t = {}, {'on': [], 'off': []}
    for tag in ('on', 'off', 'off', 'on'):
        with pallas_switch(tag == 'on'):
            no_tf32()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[tag] = render(params, cfg_ab, frames[0])
            torch.cuda.synchronize()
            t[tag].append((time.perf_counter() - t0) * 1e3)
    print(f'A/B render of one frame, in turns (on, off, off, on): switch on '
          f'{[round(v, 1) for v in t["on"]]} ms, off '
          f'{[round(v, 1) for v in t["off"]]} ms [{card}]', flush=True)
    render_gate('A/B render vs its switch-off twin', res['on'], res['off'],
                gen)
    render_gate('A/B render vs the flagship render (E averages tied '
                'weights, the plain march takes the first vertex)',
                outs[0], flagship_out, gen)
    del outs, res
    torch.cuda.empty_cache()

    # ---- L on its path: the corr-variant bench, counted
    no_tf32()
    n_b, dev = BENCH_POINTS, inp.ray_dirs.device
    _build.reset_counts()
    bench = bench_corr.main(['--n', str(n_b), '--iters', '3'], device=dev)
    launches['corr_rows'] = _build.COUNTS['corr_rows']
    check(sorted(bench) == ['chunked', 'dense', 'pallas', 'pallas_t_f32'],
          f'bench_corr ran {sorted(bench)}')
    skin_b, fb, xb, xi, T0b, mb, wb, bb = bench_corr.make_problem(n_b, dev)
    # L's record, every number of it from the bench's own inputs
    err_b = corr_compare(f'L corr_rows vs plain (bench, {n_b} points)',
                         bench['pallas']['x_hat'], bench['pallas']['valid'],
                         bench['dense']['x_hat'], bench['dense']['valid'],
                         xb, fb, skin_b)
    corr_compare('B corr vs plain (bench)', bench['pallas_t_f32']['x_hat'],
                 bench['pallas_t_f32']['valid'], bench['dense']['x_hat'],
                 bench['dense']['valid'], xb, fb, skin_b)
    bargs = (xb, xi, T0b.reshape(n_b, 16).contiguous(), mb,
             [w.t() for w in wb], bb,
             fb.bone_transforms.reshape(24, 16).contiguous(), fb.coord_min,
             fb.coord_max, fb.center)
    # masked points take no MLP evaluation (they return x0 and T0)
    evals = float(int(mb.sum()) + bench['dense']['iters'].sum())
    macs = sum(w.numel() for w in wb)
    flops_eval = 2 * macs + 4 * sum(w.shape[0] for w in wb[:-1]) \
        + 2 * 24 * 16 + 250
    recs['corr_rows'] = dict(
        max_abs_err=err_b,
        ms=timed(lambda: corr_search_rows(*bargs), REPS),
        plain_ms=timed(lambda: corr_search_rows_plain(*bargs), 2),
        bound=bound(n_b * (12 + 12 + 64 + 1 + 12 + 64 + 1)
                    + 4 * (macs + 600), evals * flops_eval, PEAK_F32),
        src='arah_tpu_torch/csrc/corr_rows.cu',
        rep='arah_tpu/ops/pallas/corr_kernel.py:257')
    r = recs['corr_rows']
    print(f'L corr_rows on the bench problem ({n_b} points): kernel '
          f'{r["ms"]:.3f} ms, plain {r["plain_ms"]:.3f} ms, bound '
          f'{r["bound"][0]:.4f} ms ({r["bound"][1]}); {evals:.0f} MLP '
          f'evaluations ({float(bench["dense"]["iters"].float().mean()):.3f}'
          f' iterations per point) [{card}]', flush=True)
    return recs, {k: launches[k] for k in ('siren', 'knn_rows', 'corr_rows')}


def profile_frame(fn, ms_frame, card, tag='one frame'):
    """Device time by kernel over one call of fn (a frame or a step), and
    the share of it the device spent idle: of the traced call's wall
    time, and of the untraced time `ms_frame` (tracing slows the host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: a CPU op's self device time repeats the
    # time of the kernels it launched
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    if not kernels:
        print(f'profile of {tag}: the trace holds no device-side events '
              '(device time and idle share not measured)')
        return
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f'profile of {tag}: traced wall {wall_ms:.1f} ms, device '
          f'busy {busy:.1f} ms in {sum(e.count for e in kernels)} kernel '
          f'launches, idle share {1 - busy / wall_ms:.3f} of the traced '
          f'run, {1 - busy / ms_frame:.3f} of the untraced '
          f'{ms_frame:.1f} ms [{card}]')
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f'  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  '
              f'{e.key[:90]}')


@contextlib.contextmanager
def capture_train_kernels():
    """Record the arguments the train step hands kernels G, H and I (the
    wrappers still launch): {'skin_jac': [...], 'shade_bwd': [...],
    'color_bwd': [...]}, one args tuple per call."""
    from arah_tpu_torch.ops import color as ocolor
    from arah_tpu_torch.ops import shade_grad as oshade
    from arah_tpu_torch.render import renderer as rend
    calls = {'skin_jac': [], 'shade_bwd': [], 'color_bwd': []}
    patched = [(rend, 'skinning_jac', 'skin_jac'),
               (oshade, 'shade_bwd', 'shade_bwd'),
               (ocolor, 'color_bwd', 'color_bwd')]
    saved = [getattr(mod, attr) for mod, attr, _ in patched]
    for (mod, attr, name), real in zip(patched, saved):
        def spy(*args, _real=real, _name=name):
            calls[_name].append(args)
            return _real(*args)
        setattr(mod, attr, spy)
    try:
        yield calls
    finally:
        for (mod, attr, _), real in zip(patched, saved):
            setattr(mod, attr, real)


def rel_stats(k, p):
    """(median, p99.9, max) of |k - p| over p's largest magnitude."""
    import torch
    d = (k.float() - p.float()).abs().flatten()
    s = max(float(p.abs().max()), 1e-30)
    return float(d.median()) / s, q(d, .999) / s, float(d.max()) / s


def check_skin_jac(args, card):
    """Kernel G against `skinning_jac_plain` on the step's own points:
    per point, |dJ| over the point's largest |J| must stay < 1e-3, and
    its median < 1e-5 (f32 on both sides, reassociation only)."""
    import torch
    from arah_tpu_torch.ops.skin_jac import skinning_jac, skinning_jac_plain
    x_hat, wts, bs = args[0], args[1], args[2]
    jk, jp = skinning_jac(*args), skinning_jac_plain(*args)
    d = (jk - jp).abs().amax(dim=(1, 2))
    rel = d / jp.abs().amax(dim=(1, 2)).clamp(min=1e-30)
    n = x_hat.shape[0]
    print(f'G skin_jac ({n} points, f32): per-point |dJ| / max|J| median '
          f'{float(rel.median()):.3e} (bound 1e-5) p99.9 {q(rel, .999):.3e}'
          f' max {float(rel.max()):.3e} (bound 1e-3); max |dJ| '
          f'{float(d.max()):.3e}', flush=True)
    check(float(rel.median()) < 1e-5 and float(rel.max()) < 1e-3,
          'skin_jac kernel disagrees with its plain version')
    macs = sum(w.numel() for w in wts)
    # the primal and three tangents through the MLP, four bone blends,
    # ~400 flops of softmax tangents and LBS per point
    flops = n * (4 * 2.0 * macs + 4 * 2 * 24 * 16 + 400)
    nbytes = n * (12 + 36) + 4 * (macs + sum(b.numel() for b in bs)
                                  + 24 * 16 + 8)
    return dict(
        max_abs_err=float(d.max()),
        ms=timed(lambda: skinning_jac(*args), REPS),
        plain_ms=timed(lambda: skinning_jac_plain(*args), 2),
        bound=bound(nbytes, flops, PEAK_F32),
        src='arah_tpu_torch/csrc/skin_jac.cu',
        rep='arah_tpu/ops/pallas/corr_kernel_t.py:483')


def shade_bwd_work(gen, n, bf16):
    """(bytes, flops, peak) of kernel H at n points: per point the primal
    and reverse chains, the adjoint sweep and its weight-gradient term,
    the primal backward's weight-gradient term and hbar product (six
    hidden-layer products), ~20 flops of chain algebra per unit."""
    H, din = gen.weights[0].shape
    dout = gen.weights[-1].shape[0]
    nl = len(gen.weights) - 1
    macs = 6 * (nl - 1) * H * H + 5 * din * H + 3 * dout * H
    flops = n * (2.0 * macs + 20 * H * nl)
    leaves = sum(a.numel() for part in gen for a in part)
    nbytes = n * 4 * (din + dout + H + din + din) + 4 * 3 * leaves
    return nbytes, flops, PEAK_BF16 if bf16 else PEAK_F32


def check_shade_bwd(args, card, tol):
    """Kernel H against `shade_bwd_plain` on the step's own inputs and
    cotangents (`tol` for every summed leaf, relative to its largest
    magnitude; per-point dx median < 1e-4 and p99.9 < tol of max |dx|)."""
    import torch
    from arah_tpu_torch.ops.shade_grad import shade_bwd, shade_bwd_plain
    gen, x, bf16 = args[0], args[1], args[5]
    with torch.no_grad():
        dxk, gk = shade_bwd(*args)
        dxk2, gk2 = shade_bwd(*args)
        dxp, gp = shade_bwd_plain(*args)
    same = torch.equal(dxk, dxk2) and all(
        torch.equal(a, b) for lk, lk2 in zip(gk, gk2) for a, b in zip(lk, lk2))
    del dxk2, gk2
    med, p999, dmax = rel_stats(dxk, dxp)
    worst, where, per = 0.0, '', []
    for part, (lk, lp) in enumerate(zip(gk, gp)):
        rs = [rel_stats(a, b)[2] for a, b in zip(lk, lp)]
        per.append(f'{gk._fields[part]} '
                   + ' '.join(f'{r:.1e}' for r in rs))
        for i, r in enumerate(rs):
            if r >= worst:
                worst, where = r, f'{gk._fields[part]}[{i}]'
    n = x.shape[0]
    print(f'H shade_bwd ({n} points, bf16={bf16}): dx |d| / max|dx| median '
          f'{med:.3e} (bound 1e-4) p99.9 {p999:.3e} (bound {tol:g}) max '
          f'{dmax:.3e}; summed leaves: worst max |d| / max|leaf| {worst:.3e}'
          f' at {where} (bound {tol:g}); per leaf: {"; ".join(per)}',
          flush=True)
    print(f'  two calls: dx and every leaf bit-equal {same}', flush=True)
    check(med < 1e-4 and p999 < tol and worst < tol,
          f'shade_bwd kernel (bf16={bf16}) disagrees with its plain version')
    check(same, f'shade_bwd kernel (bf16={bf16}): two calls differ')
    with torch.no_grad():
        ms = timed(lambda: shade_bwd(*args), REPS)
        plain_ms = timed(lambda: shade_bwd_plain(*args), 2)
    nbytes, flops, peak = shade_bwd_work(gen, n, bf16)
    b = bound(nbytes, flops, peak)
    print(f'  kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b[0]:.4f} '
          f'ms ({b[1]}) [{card}]', flush=True)
    return dict(max_abs_err=float((dxk - dxp).abs().max()), ms=ms,
                plain_ms=plain_ms, bound=b,
                src='arah_tpu_torch/csrc/shade_bwd.cu',
                rep='arah_tpu/ops/pallas/shade_grad_kernel.py:175')


def check_color_bwd(args, card, tol):
    """Kernel I against `color_mlp_bwd_plain` on the step's own inputs and
    cotangent: every summed leaf (dW, db, dpose) within `tol` of its
    largest magnitude; per point dsmall and dfeats median < 1e-4 and
    p99.9 < tol of their largest magnitude, then point by point in
    `color_bwd_points`."""
    import torch
    from arah_tpu_torch.ops.color import color_bwd, color_mlp_bwd_plain
    weights, small, feats, pose, bf16 = args[0], args[2], args[3], args[4], \
        args[8]
    with torch.no_grad():
        k = color_bwd(*args)
        p = color_mlp_bwd_plain(*args)
    stats = [rel_stats(a, b) for a, b in zip(k[2:4], p[2:4])]
    leaves = list(zip(k[0], p[0])) + list(zip(k[1], p[1]))
    if k[4] is not None:
        leaves.append((k[4], p[4]))
    rs = [rel_stats(a, b)[2] for a, b in leaves]
    worst = max(rs)
    L = len(weights)
    per = (f'dW {" ".join(f"{r:.1e}" for r in rs[:L])}; db '
           f'{" ".join(f"{r:.1e}" for r in rs[L:2 * L])}'
           + (f'; dpose {rs[-1]:.1e}' if k[4] is not None else ''))
    n = small.shape[0]
    print(f'I color_bwd ({n} points, bf16={bf16}): dsmall |d| / max median '
          f'{stats[0][0]:.3e} p99.9 {stats[0][1]:.3e} max {stats[0][2]:.3e},'
          f' dfeats median {stats[1][0]:.3e} p99.9 {stats[1][1]:.3e} max '
          f'{stats[1][2]:.3e} (bounds 1e-4, {tol:g}); summed leaves: worst '
          f'max |d| / max|leaf| {worst:.3e} (bound {tol:g}); per leaf: '
          f'{per}', flush=True)
    check(all(s[0] < 1e-4 and s[1] < tol for s in stats) and worst < tol,
          f'color_bwd kernel (bf16={bf16}) disagrees with its plain version')
    with torch.no_grad():
        color_bwd_points(args, k, p, tol)
    with torch.no_grad():
        ms = timed(lambda: color_bwd(*args), REPS)
        plain_ms = timed(lambda: color_mlp_bwd_plain(*args), 2)
    # least work: the recomputed forward, delta W and the weight gradient
    # per point; the pose row's columns once per call
    S, F = small.shape[1], feats.shape[1]
    P = 0 if pose is None else pose.shape[-1]
    macs_pose = sum(w.shape[0] * P for l, w in enumerate(weights)
                    if l == 0 or l in args[6])
    macs_pt = sum(w.numel() for w in weights) - macs_pose
    flops = n * 6.0 * macs_pt + 6.0 * macs_pose
    nbytes = n * (2 * 4 * S + 2 * feats.element_size() * F + 12) \
        + 4 * 2 * sum(w.numel() for w in weights)
    b = bound(nbytes, flops, PEAK_BF16 if bf16 else PEAK_F32)
    print(f'  kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b[0]:.4f} '
          f'ms ({b[1]}) [{card}]', flush=True)
    return dict(max_abs_err=max(float((a - b).abs().max()) for a, b in
                                leaves + list(zip(k[2:4], p[2:4]))),
                ms=ms, plain_ms=plain_ms, bound=b,
                src='arah_tpu_torch/csrc/color.cu',
                rep='arah_tpu/ops/pallas/color_kernel.py:244')


def color_bwd_points(args, k, p, tol):
    """Kernel I point by point, where `check_color_bwd` bounds only the
    median and p99.9 of dsmall and dfeats. Per slice of CB_CHUNK points,
    `color_bwd_rows` gives the kernel's own recomputed activations and
    deltas, and:
    1. every layer recomputed in plain torch from the kernel's own rows
       of the layer before (its x input, or its delta and ReLU mask)
       matches the kernel's rows to 1e-4 of the layer's largest magnitude
       beyond one bf16 step (2^-8 |v|, activations under bf16 only), and
       dsmall and dfeats from its deltas match to 1e-4: the chain of every
       point, with no difference carried from one layer to the next;
    2. the slices' dsmall and dfeats equal those of the full call bit for
       bit (its chunk loop);
    3. against the plain chain run on its own (`k`, `p` at full N), each
       point is put in a class by where kernel and plain part: an
       activation's sign (a ReLU mask), else the bf16 rounding of an
       activation or delta, else nowhere. The points that part nowhere
       hold max |d| < 1e-4 of the largest magnitude, the points whose
       masks agree < `tol`."""
    import torch
    from arah_tpu_torch.ops.color import CB_CHUNK, _parts, color_bwd_rows
    weights, biases, small, feats, pose, g_rgb, skips, squeeze, bf16 = args
    r = (lambda t: t.bfloat16().float()) if bf16 else (lambda t: t)
    n, S = small.shape
    P = 0 if pose is None else pose.shape[-1]
    parts = _parts(weights, S, feats.shape[1], P, skips)
    pose_row = None if pose is None else pose.reshape(1, P).float()
    Wr = [r(w.float()) for w in weights]
    L = len(weights)

    def layer_z(l, x, src):
        z = biases[l].float()
        for name, st, wd in parts[l]:
            a = x if name == 'x' else (pose_row if name == 'pose'
                                       else src[name])
            z = z + r(a) @ Wr[l][:, st:st + wd].T
        return z

    def delta_last(z, g):
        if not squeeze:
            return g
        s = torch.sigmoid(z)
        return g * s * (1.0 - s)

    local = {}

    def hold(name, kv, tv, step):
        ex = ((kv - tv).abs() - step * tv.abs()).clamp(min=0).max()
        v = float(ex) / max(float(tv.abs().max()), 1e-30)
        local[name] = max(local.get(name, 0.0), v)

    step = 2.0 ** -8 if bf16 else 0.0
    mflip = torch.zeros(n, dtype=torch.bool, device=small.device)
    rflip = torch.zeros_like(mflip)
    same = True
    for c0 in range(0, n, CB_CHUNK):
        sl = slice(c0, min(n, c0 + CB_CHUNK))
        src = {'small': small[sl].float(), 'feats': feats[sl].float()}
        g = g_rgb[sl].float()
        (_, _, dsk, dfk, _), dk, xk = color_bwd_rows(
            weights, biases, small[sl], feats[sl], pose, g, skips, squeeze,
            bf16)
        same = same and torch.equal(dsk, k[2][sl]) \
            and torch.equal(dfk, k[3][sl])
        # 1. each layer from the kernel's own rows of the layer before
        for l in range(L - 1):
            hold(f'x{l + 1}', xk[l + 1], torch.relu(layer_z(l, xk[l], src)),
                 step)
        hold(f'delta{L - 1}', dk[L - 1],
             delta_last(layer_z(L - 1, xk[L - 1], src), g), 0.0)
        dsm, dfe = torch.zeros_like(dsk), torch.zeros_like(dfk)
        for l in range(L - 1, -1, -1):
            for name, st, wd in parts[l]:
                if name == 'pose':
                    continue
                da = r(dk[l]) @ Wr[l][:, st:st + wd]
                if name == 'x':
                    hold(f'delta{l - 1}', dk[l - 1], da * (xk[l] > 0), 0.0)
                elif name == 'small':
                    dsm += da
                else:
                    dfe += da
        hold('dsmall', dsk, dsm, 0.0)
        hold('dfeats', dfk, dfe, 0.0)
        # 3. where the plain chain run on its own parts from the kernel
        xp = [None]
        for l in range(L - 1):
            xp.append(torch.relu(layer_z(l, xp[l], src)))
            mflip[sl] |= ((xk[l + 1] > 0) != (xp[l + 1] > 0)).any(dim=1)
            if bf16:
                rflip[sl] |= (xk[l + 1] != r(xp[l + 1])).any(dim=1)
        dp = delta_last(layer_z(L - 1, xp[L - 1], src), g)
        for l in range(L - 1, -1, -1):
            if bf16:
                rflip[sl] |= (r(dk[l]) != r(dp)).any(dim=1)
            if l > 0:
                st, wd = next((st, wd) for name, st, wd in parts[l]
                              if name == 'x')
                dp = (r(dp) @ Wr[l][:, st:st + wd]) * (xp[l] > 0)
        del dk, xk, xp
    err = torch.maximum(
        (k[2] - p[2]).abs().amax(dim=1) / p[2].abs().max().clamp(min=1e-30),
        (k[3] - p[3]).abs().amax(dim=1) / p[3].abs().max().clamp(min=1e-30))
    exact = ~mflip & ~rflip
    agree = ~mflip

    def top(sel):
        return float(err[sel].max()) if bool(sel.any()) else 0.0
    worst = torch.argsort(err, descending=True)[:10]
    cls = ['mask' if bool(mflip[i]) else ('round' if bool(rflip[i])
                                          else 'none') for i in worst]
    print(f'  I per point: each layer from the kernel\'s own rows, worst '
          f'excess |d| / max {max(local.values()):.3e} (bound 1e-4; '
          + ', '.join(f'{a} {b:.1e}' for a, b in local.items())
          + f'); slices bit-equal to the full call: {same}; points whose '
          f'ReLU masks part {int(mflip.sum())}, whose bf16 roundings only '
          f'part {int((rflip & ~mflip).sum())}, none {int(exact.sum())} of '
          f'{n}; max |d| / max over the points that part nowhere '
          f'{top(exact):.3e} (bound 1e-4), whose masks agree '
          f'{top(agree):.3e} (bound {tol:g}), whose masks part '
          f'{top(mflip):.3e}; the 10 worst points part at '
          f'{cls} with {[f"{float(err[i]):.1e}" for i in worst]}',
          flush=True)
    check(max(local.values()) < 1e-4 and same and top(exact) < 1e-4
          and top(agree) < tol,
          f'color_bwd kernel (bf16={bf16}): a point disagrees with its '
          f'plain chain')


def run_train(cfg, params, fd, card, no_tf32):
    """Step 5 of the module docstring. Returns (records of G, H and I,
    the counted step's launches)."""
    import numpy as np
    import torch
    from arah_tpu_torch.data.batch import draw_train_draws
    from arah_tpu_torch.ops import _build
    from arah_tpu_torch.parallel.train_step import trainable
    from arah_tpu_torch.scene import build_train_setup

    dev = fd.verts_cano.device
    s = build_train_setup(cfg, RAYS, scene=(params, fd))
    rng = np.random.RandomState(3)
    draws = [draw_train_draws(rng, cfg, 1, RAYS, dev)
             for _ in range(2 + STEPS)]
    n_reg = s.batch.points_uniform.shape[1]
    print(f'train setup: flagship, 1 block of {RAYS} rays, {n_reg} '
          f'regulariser points, {cfg.n_eik_points} eikonal points; '
          f'LossWeights(n_ray_loss={RAYS}), '
          f'OptimConfig(train_skinning_net=True)', flush=True)

    # ---- the warm-up step; G, H and I against their plain versions on
    # the inputs and cotangents it handed them
    no_tf32()
    with capture_train_kernels() as calls:
        state, losses = s.step(s.state, s.batch, draws[0])
    torch.cuda.synchronize()
    check(bool(torch.isfinite(losses['loss'])), 'warm-up step: loss not '
          'finite')
    # the kernels-vs-plain step starts here: after one update the
    # hypernet's zero-initialised last layers pass gradients to its pose
    # encoder, so every group moves
    p0 = trainable(s.params)
    first = {'skin_jac': 0, 'shade_bwd': 1, 'color_bwd': 2}
    print('  calls in the warm-up step (points): ' + ', '.join(
        f'{k} {[a[first[k]].shape[0] for a in v]}'
        for k, v in calls.items()), flush=True)
    records = {}
    no_tf32()
    records['skin_jac'] = check_skin_jac(calls['skin_jac'][0], card)
    shade_calls = sorted(calls['shade_bwd'], key=lambda a: -a[1].shape[0])
    no_tf32()
    records['shade_bwd'] = check_shade_bwd(shade_calls[0], card, 5e-3)
    for extra in shade_calls[1:]:
        no_tf32()
        check_shade_bwd(extra, card, 5e-3 if extra[5] else 1e-4)
    no_tf32()
    records['color_bwd'] = check_color_bwd(calls['color_bwd'][0], card,
                                           5e-3)
    del calls, shade_calls
    torch.cuda.empty_cache()

    # ---- the main path: one counted step, then timed steps
    no_tf32()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(1 + STEPS):
        if i == 0:
            _build.reset_counts()
        t0 = time.perf_counter()
        state, losses = s.step(state, s.batch, draws[1 + i])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            launches = dict(_build.COUNTS)
        check(bool(torch.isfinite(losses['loss'])),
              f'train step {i}: loss not finite')
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = float(np.median(times))
    print(f'train main path: {1 + STEPS} steps of 1 block x {RAYS} rays: '
          f'median {ms:.1f} ms/step {[round(v, 1) for v in times]}, '
          f'{RAYS / (ms / 1e3):.0f} rays/s, peak memory {peak:.2f} GiB; '
          f'loss {float(losses["loss"]):.5f}; launches in the counted step '
          f'{launches} [{card}]', flush=True)
    check(all(launches[k] > 0 for k in TRAIN_KERNELS),
          f'a kernel was not launched in the train step: {launches}')
    print(f'  solver launches per step (phase 1 + phase 2 when stragglers '
          f'exist): corr {launches["corr"]}, march {launches["march"]}, iso '
          f'{launches["iso"]}; shade_bwd {launches["shade_bwd"]} (shading + '
          f'eikonal)', flush=True)
    check(launches['shade_bwd'] == 2 and launches['shade'] == 2,
          'the step must run C and H twice (shading and eikonal)')
    profile_frame(lambda: s.step(state, s.batch, draws[1]), ms, card,
                  tag='one train step')
    batch, loss_w = s.batch, s.loss_w
    del state, s
    torch.cuda.empty_cache()
    compare_train_steps(cfg, p0, batch, loss_w, draws[0], card, no_tf32)
    return records, launches


def compare_train_steps(cfg, p0, batch, loss_w, draws, card, no_tf32):
    """One step with every kernel against one with every plain path
    (splits off on both sides), from the same parameters `p0`, batch and
    draws. Every loss term within 1e-2 of its magnitude (+1e-6); the
    median and the least per-leaf gradient cosine >= 0.99 over leaves
    with a gradient on both sides (the bf16 rounding points differ:
    autograd of the plain
    forward rounds elsewhere, and Broyden may move a few samples to
    another root); the loss finite, every non-frozen group moved and no
    frozen leaf moved."""
    import numpy as np
    import torch
    from arah_tpu_torch.parallel.train_step import (TrainState,
                                                    make_train_step,
                                                    trainable)
    from arah_tpu_torch.train.optim import (OptimConfig, make_optimizer,
                                            tree_leaves_with_path)
    res = {}
    for tag, c in (('kernels', splits_off(cfg)),
                   ('plain', plain_cfg(splits_off(cfg)))):
        no_tf32()
        p = trainable(p0)
        opt, labels = make_optimizer(OptimConfig(train_skinning_net=True), p)
        step = make_train_step(c, loss_w, opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, losses = step(TrainState(p, opt, 0), batch, draws)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        leaves = dict(tree_leaves_with_path(p))
        res[tag] = dict(
            losses={k: float(v) for k, v in losses.items()},
            grads={k: v.grad for k, v in leaves.items()},
            moved={k: bool((v.detach() != p0_leaf).any())
                   for (k, v), p0_leaf in zip(
                       leaves.items(),
                       (x for _, x in tree_leaves_with_path(p0)))},
            labels=labels)
        print(f'train step with the {tag} (splits off): {ms:.1f} ms, peak '
              f'memory {peak:.2f} GiB, loss {res[tag]["losses"]["loss"]:.6f} '
              f'[{card}]', flush=True)
        del p, opt, step
        torch.cuda.empty_cache()
    k, p = res['kernels'], res['plain']
    worst_term, bad_terms = 0.0, []
    for term, a in k['losses'].items():
        b = p['losses'][term]
        r = abs(a - b) / (max(abs(a), abs(b)) + 1e-30)
        worst_term = max(worst_term, r if abs(a - b) > 1e-6 else 0.0)
        if abs(a - b) > 1e-2 * max(abs(a), abs(b)) + 1e-6:
            bad_terms.append((term, a, b))
    print('  loss terms kernels / plain: ' + ', '.join(
        f'{t} {k["losses"][t]:.6g} / {p["losses"][t]:.6g}'
        for t in k['losses']), flush=True)
    cos = []
    for path, gk in k['grads'].items():
        gp = p['grads'][path]
        if gk is None or gp is None:
            continue
        nk, npl = float(gk.norm()), float(gp.norm())
        if nk > 0 and npl > 0:
            cos.append((float((gk * gp).sum()) / (nk * npl), path))
    med = float(np.median([c for c, _ in cos])) if cos else 0.0
    lo = min(cos) if cos else (0.0, None)
    print(f'  gradients: {len(cos)} leaves with a gradient on both sides; '
          f'cosine median {med:.6f} (bound >= 0.99), min {lo[0]:.6f} '
          f'(bound >= 0.99) at {lo[1]}; loss terms worst relative |d| '
          f'{worst_term:.3e} (bound 1e-2)', flush=True)
    check(not bad_terms and med >= 0.99 and lo[0] >= 0.99,
          f'train step: kernels disagree with the plain paths {bad_terms}')
    for tag, r in res.items():
        check(np.isfinite(r['losses']['loss']),
              f'train step ({tag}): loss not finite')
        groups = {}
        for path, label in r['labels'].items():
            groups.setdefault(label, []).append(r['moved'][path])
        still = [g for g, m in groups.items() if g != 'frozen' and not any(m)]
        moved = sorted(g for g, m in groups.items()
                       if g != 'frozen' and any(m))
        frozen_moved = sum(groups.get('frozen', []))
        print(f'  {tag}: groups moved {moved}, frozen leaves '
              f'{len(groups.get("frozen", []))} of which moved '
              f'{frozen_moved}', flush=True)
        check(not still and frozen_moved == 0,
              f'train step ({tag}): groups that did not move {still}, '
              f'frozen leaves that moved {frozen_moved}')


if __name__ == '__main__':
    main()
