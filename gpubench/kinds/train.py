"""Train cells: the program's train step (`parallel/train_step.py:
make_train_step`, built as `train/trainer.py` builds it: the
configuration's `model.train_smpl` as `refine_smpl`, its
`training.multi_frame_batch` as `per_block_frame`, Adam from
`train/optim.py:make_optimizer` at the configuration's learning rates)
in a closed loop, one step after another, each synchronised at its end.

The subject, the pool of step batches and the SMPL leaves are one set
for every seed (`gpubench/train_inputs.py`); the seed draws the order of
the pool, which the window runs in whole passes, each step's sample
jitter and eikonal points, and the second compared step. Set-up makes
them, builds the step and runs `warmup_steps` steps.

Before two of the window's steps (its first, and one drawn from the
seed among those after the traced ones), the parameters, Adam's state
and the step's draws go to the host; the step then runs with the
program's counters on (`utils/trace.py`: no profiler trace is kept),
and its losses, its gradients (`.grad`) and the parameters after its
update go to the host, with the counts of its implicit-diff correction.
After the window the plain reference (`reference/train.py`) computes
those steps again from what was copied, and the checks compare: the
loss, each leaf group's gradient and the update, the SMPL leaves' on
their own, the share of corrected points the program's determinant
guard dropped, and the window's steps whose loss or gradient was not
finite (one device flag, read once).

A program without the guard (`render/renderer.py:IDIFF_DET_FLOOR`) or
without its counters cannot run these cells soundly (its implicit-diff
correction divides by near-zero determinants) and is refused at once.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import sys
import tempfile
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from gpubench import inputs, train_inputs
from gpubench.devtrace import WINDOW, summarize, window
from gpubench.harness import Check, Outcome
from gpubench.reference import config as rconfig
from gpubench.reference import train as rtrain
from gpubench.reference.tree import tree_map

SPANS = ('arah.train.step', 'arah.train.backward', 'arah.train.frame')


# the leaf groups that `grad_gap` and `change_gap` hold (`smpl_grad_gap`
# the SMPL leaves'); the deviation, one scalar whose gradient is a sum of
# cancelling terms over every sample, is printed and not held
CHECKED = ('hypernet', 'pose_encoder', 'skinning', 'color', 'latent')


def group_of(path) -> str:
    """A leaf's group: the hypernet, its pose encoder, the skinning net,
    the colour net, the latents, the deviation, or the SMPL leaves."""
    top = path[0]
    if top == 'hypernet':
        return 'pose_encoder' if path[1] == 'pose_encoder' else 'hypernet'
    if top in ('smpl_params', 'betas'):
        return 'smpl'
    return top


def unflat(template, values: dict, path=()):
    """The tree of `template`'s structure with the leaves of `values`."""
    if isinstance(template, dict):
        return {k: unflat(v, values, path + (k,))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(unflat(v, values, path + (i,))
                              for i, v in enumerate(template))
    return values[path]


def host(t):
    return t.detach().to('cpu', copy=True)


class Setup(NamedTuple):
    ref_cfg: Any
    scene: Any
    pool: list             # [[Block]] a step batch a row
    order: list            # the pool's order for this seed
    params: dict           # the initial parameter tree (no grad)
    refine: bool
    per_block: bool
    n_rays: int            # rays a block


def prepare(r) -> Setup:
    """The scene, the pool, its order for the seed and the initial
    parameters (with the SMPL leaves where the configuration refines
    SMPL). On the card the fitted weights are kept in
    `inputs.FIT_CACHE`."""
    device = torch.device(r.device)
    cfg, tr = r.cfg, r.traffic
    ref_cfg = rconfig.model_config(cfg)
    scene = inputs.build_scene(
        cfg, ref_cfg, device, fit_steps=tr['fit_steps'],
        cache_dir=inputs.FIT_CACHE if device.type == 'cuda' else None)
    pool = train_inputs.make_pool(scene, cfg, tr, device)
    rng = np.random.RandomState(inputs.seed_words(r.seed, 8))
    order = [int(i) for i in rng.permutation(len(pool))]
    refine = bool(cfg['model'].get('train_smpl', False))
    params = tree_map(lambda t: t.detach().clone(), scene.params)
    if refine:
        params.update(train_inputs.smpl_leaves(scene, device))
    return Setup(ref_cfg, scene, pool, order, params, refine,
                 bool(cfg['training'].get('multi_frame_batch', False)),
                 tr['fg_rays'] + tr['bg_rays'])


def with_draws(step, draws) -> list:
    """The step's blocks with block b's draws."""
    u1, u2, u3, eik = draws
    return [blk._replace(u1=u1[b], u2=u2[b], u3=u3[b], points_eik=eik[b])
            for b, blk in enumerate(step)]


def compared_units(seed: int, pool: int, trace_steps: int) -> list:
    """The window's compared steps: its first, and one drawn from the
    seed after the traced ones (steps 1 .. trace_steps) within the first
    pass."""
    lo = trace_steps + 1
    rng = np.random.RandomState(inputs.seed_words(seed, 9))
    return [0, int(rng.randint(lo, max(pool, lo + 1)))]


def reference_step(s: Setup, cfg: dict, w, snap: dict, device,
                   floor: float = rtrain.IDIFF_DET_FLOOR):
    """(losses, grads {path: tensor}, params after the update {path:
    tensor}, the guard's counts, params before, Adam's sqrt(v_hat)
    {path: tensor}) of a compared step by the reference, from its
    snapshot: the parameters and Adam's state before the step, the pool
    step and its draws."""
    before = {p: t.to(device) for p, t in snap['params'].items()}
    tree = unflat(s.params, {p: t.clone().requires_grad_(True)
                             for p, t in before.items()})
    step = s.pool[snap['k']]
    draws = tuple(t.to(device) for t in snap['draws'])
    blocks = with_draws(step, draws)
    frames = [None if s.refine else s.scene.frames[blk.frame_idx]
              for blk in blocks]
    with torch.enable_grad():
        losses, grads, counts = rtrain.step_grads(
            tree, s.ref_cfg, w, blocks, frames, s.scene.model_dev,
            s.refine, floor)
    state = {p: (st[0], st[1].to(device), st[2].to(device))
             for p, st in snap['adam'].items()}
    denom = {}
    after = rtrain.adam_update(cfg, before, grads, state, denom)
    del tree
    return ({k: float(v) for k, v in losses.items()}, grads,
            {p: t.detach() for p, t in after.items()}, counts, before, denom)


def rel_gap(a: list, b: list) -> float:
    """|a - b| / |b| over the concatenated tensors (0 where both are 0)."""
    num = math.sqrt(sum(float(((x.float() - y.float()) ** 2).sum())
                        for x, y in zip(a, b)))
    den = math.sqrt(sum(float((y.float() ** 2).sum()) for y in b))
    if den == 0.0:
        return 0.0 if num == 0.0 else math.inf
    return num / den


# Adam moves each entry by its momentum over sqrt(v_hat): an entry whose
# gradient is round-off next to its group's moves a whole step (on a row
# that Adam first sees, +-0.49 lr whatever the gradient's size) in the
# direction the round-off picks, in the program and the reference alike.
# `change_gap` holds the entries whose sqrt(v_hat), by the reference, is
# at least HELD_DENOM of the group's RMS gradient of the step (its
# nonzero entries), and every entry the step gives no gradient (moved by
# the shared history alone, or not at all); `grad_gap` holds every
# entry's gradient.
HELD_DENOM = 1e-2


def held_entries(grads: list, denoms: list) -> list:
    """Per leaf, the bool mask of the entries `change_gap` holds (by the
    reference's gradients and sqrt(v_hat))."""
    nz = [g[g != 0] for g in grads]
    n = sum(int(x.numel()) for x in nz)
    if n == 0:
        return [torch.ones_like(d, dtype=torch.bool) for d in denoms]
    rms = math.sqrt(sum(float((x.float() ** 2).sum()) for x in nz) / n)
    return [(g == 0) | (d >= HELD_DENOM * rms)
            for g, d in zip(grads, denoms)]


def gaps(prog: dict, ref: dict, before: dict, labels: dict) -> dict:
    """The gaps of one compared step: `prog` and `ref` hold `loss`,
    `grads` and `after` ({path: tensor}), `ref` also `denom` (Adam's
    sqrt(v_hat)), where `change_gap` holds only the entries it
    determines (`HELD_DENOM`); `labels` the optimizer group of each path
    ('frozen' ones are not updated)."""
    device = before[next(iter(before))].device
    out = {'loss_gap': abs(prog['loss'] - ref['loss'])
           / max(abs(ref['loss']), 1e-30)}
    by_group = {}
    for path in before:
        by_group.setdefault(group_of(path), []).append(path)
    grad_gaps, change_gaps, left_out = {}, {}, {}
    for g, paths in by_group.items():
        grad_gaps[g] = rel_gap([prog['grads'][p].to(device) for p in paths],
                               [ref['grads'][p] for p in paths])
        upd = [p for p in paths if labels[p] != 'frozen']
        if upd:
            d_prog = [prog['after'][p].to(device) - before[p] for p in upd]
            d_ref = [ref['after'][p] - before[p] for p in upd]
            if 'denom' in ref:
                keep = held_entries([ref['grads'][p] for p in upd],
                                    [ref['denom'][p] for p in upd])
                # the share of the step's nonzero gradients left out
                left_out[g] = sum(int((~k).sum()) for k in keep) / max(
                    sum(int((ref['grads'][p] != 0).sum()) for p in upd), 1)
                d_prog = [d[k] for d, k in zip(d_prog, keep)]
                d_ref = [d[k] for d, k in zip(d_ref, keep)]
            change_gaps[g] = rel_gap(d_prog, d_ref)
    out['grad_gap'] = worst(v for g, v in grad_gaps.items() if g in CHECKED)
    if 'smpl' in grad_gaps:
        out['smpl_grad_gap'] = grad_gaps['smpl']
    out['change_gap'] = worst(v for g, v in change_gaps.items()
                              if g in CHECKED + ('smpl',))
    out['groups'] = {'grad': grad_gaps, 'change': change_gaps,
                     'left_out': left_out}
    return out


def worst(values) -> float:
    """The largest of `values`; NaN where there is none or one is NaN, so
    that the check fails."""
    values = list(values)
    if not values or any(math.isnan(v) for v in values):
        return math.nan
    return max(values)


def checks_of(steps_done: int, compared: list, limits: dict, nonfinite: int,
              guarded: float, refine: bool) -> list:
    """The checks: steps finished and compared, none of them with a loss
    or gradient that is not finite, each gap at its worst over the
    compared steps, and the share of corrected points the guard
    dropped."""
    names = ['loss_gap', 'grad_gap'] + (['smpl_grad_gap'] if refine
                                        else []) + ['change_gap']
    return [Check('steps_done', steps_done, 1, 'min'),
            Check('steps_compared', len(compared), 1, 'min'),
            Check('nonfinite', nonfinite, 0)] + \
        [Check(n, worst(c.get(n, math.nan) for c in compared), limits[n])
         for n in names] + \
        [Check('guarded_share', guarded, limits['guarded_share'])]


@contextlib.contextmanager
def counting(device):
    """The program's counters on for the calls inside, with no trace
    kept: NVTX ranges on the card (nothing records them), a CPU
    profiler elsewhere."""
    if device.type == 'cuda':
        with torch.autograd.profiler.emit_nvtx(record_shapes=False):
            yield
    else:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU]):
            yield


class TrainTracer:
    """torch.profiler (CPU and CUDA) over the traced steps, reduced on
    exit: the device trace's summary over the window from the first
    traced `train.step` span to the window span's end (`devtrace`), the
    spans' seconds and counts in it."""

    def __init__(self):
        self._prof = None
        self.summary, self.spans = None, {}

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix='.json')
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)['traceEvents']
        finally:
            os.remove(path)
        win = [e for e in events if e.get('name') == WINDOW
               and e.get('cat') == 'user_annotation' and e.get('ph') == 'X']
        if not win:
            raise RuntimeError('trace: the window span is missing')
        t0 = float(win[0]['ts'])
        t1 = t0 + float(win[0]['dur'])
        # the host's spans: a span's projection on the device's timeline
        # (`gpu_user_annotation`) has its name too
        spans = {n: [0, 0.0] for n in SPANS}
        first = t1
        for e in events:
            if e.get('ph') == 'X' and e.get('name') in spans and \
                    e.get('cat') == 'user_annotation' and \
                    t0 <= float(e['ts']) <= t1:
                spans[e['name']][0] += 1
                spans[e['name']][1] += float(e['dur']) * 1e-6
                if e['name'] == 'arah.train.step':
                    first = min(first, float(e['ts']))
        self.summary = summarize(
            events, first if spans['arah.train.step'][0] else t0, t1)
        self.spans = {n[len('arah.'):]: v for n, v in spans.items() if v[0]}
        self._prof = None
        return False


def plant(fault: str | None):
    """A planted fault of the program (the tests' and the control
    script's only): 'unguarded_singular' takes the guard away and makes
    every corrected point's Jacobian singular; 'wide_floor' widens the
    guard to every point. Returns the undo."""
    from arah_tpu_torch.render import renderer as P_renderer
    if fault not in ('unguarded_singular', 'wide_floor'):
        return lambda: None
    floor, jac = P_renderer.IDIFF_DET_FLOOR, P_renderer.skinning_jac
    if fault == 'wide_floor':
        P_renderer.IDIFF_DET_FLOOR = 1e30
    else:
        P_renderer.IDIFF_DET_FLOOR = -1.0
        P_renderer.skinning_jac = lambda *a, **k: jac(*a, **k) * 0.0

    def undo():
        P_renderer.IDIFF_DET_FLOOR = floor
        P_renderer.skinning_jac = jac
    return undo


class Program(NamedTuple):
    """The program's train step as the trainer builds it, on the pool."""
    step: Any              # step(state, batch, draws) -> (state, losses)
    batches: list          # the pool's steps as the program's TrainBatch
    params: dict           # its parameter tree (leaves that require grad)
    optimizer: Any
    labels: dict           # {path: optimizer group}
    by_path: dict          # {path: leaf}


def build_program(s: Setup, cfg: dict, device) -> Program:
    """The program's step over the initial parameters (`make_train_step`
    with the configuration's options, the optimizer of
    `make_optimizer`), and the pool's steps as its batches: each block's
    frame as the program prepares it, stacked over the blocks where the
    configuration gives each block a frame."""
    from arah_tpu_torch.config import loader as P_loader
    from arah_tpu_torch.core import smpl as P_smpl
    from arah_tpu_torch.model import prepare_frame as p_prepare_frame
    from arah_tpu_torch.parallel import train_step as P_step
    from arah_tpu_torch.train.optim import make_optimizer
    from arah_tpu_torch.utils.tree import tree_stack

    mcfg = P_loader.model_config_from_cfg(cfg)
    loss_w = P_loader.loss_weights_from_cfg(cfg)._replace(
        n_ray_loss=s.n_rays)
    params = P_step.trainable(tree_map(lambda t: t.clone(), s.params))
    optimizer, labels = make_optimizer(P_loader.optim_config_from_cfg(cfg),
                                       params)
    p_model = P_smpl.smpl_to_device(P_smpl.SmplModel(*s.scene.model),
                                    device)
    step = P_step.make_train_step(
        mcfg, loss_w, optimizer, smpl_model=p_model if s.refine else None,
        refine_smpl=s.refine, per_block_frame=s.per_block)
    with torch.no_grad():
        p_frames = {f: p_prepare_frame(p_model, s.scene.betas,
                                       s.scene.poses[f], s.scene.trans,
                                       device=device)
                    for f in sorted({b.frame_idx for st in s.pool
                                     for b in st})}

    def batch_of(blks):

        def st(name):
            return torch.stack([getattr(b, name) for b in blks])
        frames = [p_frames[b.frame_idx] for b in blks]
        idx = torch.tensor([b.frame_idx for b in blks], dtype=torch.int32,
                           device=device)
        return P_step.TrainBatch(
            cam_loc=st('cam_loc'), ray_dirs=st('ray_dirs'), near=st('near'),
            far=st('far'), rgb_gt=st('rgb_gt'), body_mask=st('body_mask'),
            points_uniform=st('points_uniform'),
            points_skinning=st('points_skinning'),
            points_inside=st('points_inside'),
            sampled_weights=st('sampled_weights'),
            rots_noise=st('rots_noise'), view_noise=st('view_noise'),
            rot_noise=st('rot_noise'), trans_noise=st('trans_noise'),
            uv=st('ray_dirs'),
            cam_idx=torch.zeros(len(blks), dtype=torch.int32, device=device),
            frame=tree_stack(frames, torch.stack) if s.per_block
            else frames[0],
            latent_idx=idx if s.per_block else blks[0].frame_idx)
    return Program(step, [batch_of(st) for st in s.pool], params, optimizer,
                   labels, dict(rtrain.leaves(params)))


def snapshot(prog: Program, k: int) -> dict:
    """The host copies before a compared step of pool step k: the
    parameters and Adam's state ({path: (step, m, v)})."""
    adam = {}
    for path, t in prog.by_path.items():
        st = prog.optimizer.adam.state.get(t)
        if st:
            adam[path] = (int(st['step']), host(st['exp_avg']),
                          host(st['exp_avg_sq']))
    return {'k': k, 'params': {p: host(t) for p, t in prog.by_path.items()},
            'adam': adam}


def outcome_of(prog: Program, loss) -> dict:
    """The host copies after a compared step: its loss, the gradient of
    every leaf (zeros where it has none) and the parameters after the
    update."""
    return {'loss': float(loss),
            'grads': {p: host(t.grad) if t.grad is not None
                      else torch.zeros_like(t, device='cpu')
                      for p, t in prog.by_path.items()},
            'after': {p: host(t) for p, t in prog.by_path.items()}}


def run(r) -> Outcome:
    from arah_tpu_torch.parallel import train_step as P_step
    from arah_tpu_torch.render import renderer as P_renderer
    from arah_tpu_torch.utils import trace as P_trace

    if not hasattr(P_renderer, 'IDIFF_DET_FLOOR') or \
            not hasattr(P_trace, 'count_idiff'):
        raise SystemExit('gpubench: this program has no determinant guard '
                         'in its implicit-diff correction '
                         '(render/renderer.py:IDIFF_DET_FLOOR) and no '
                         'counts of it: the train cells need both')
    device = torch.device(r.device)
    on_gpu = device.type == 'cuda'
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, tr = r.cfg, r.traffic
    s = prepare(r)
    t_inputs = time.perf_counter()
    n_blocks, R, P = tr['blocks'], s.n_rays, len(s.pool)
    prog = build_program(s, cfg, device)
    step_fn, batches, by_path = prog.step, prog.batches, prog.by_path
    leaves = P_step.grad_leaves(prog.params)
    state = P_step.TrainState(prog.params, prog.optimizer, 0)
    bad = torch.zeros((), dtype=torch.int32, device=device)
    undo = plant(r.fault)
    if r.fault == 'dropped_smpl_grad':
        for p, t in by_path.items():
            if group_of(p) == 'smpl':
                t.register_hook(torch.zeros_like)

    def call(j):
        nonlocal state, bad
        k = s.order[j % P]
        draws = train_inputs.step_draws(r.seed, j, n_blocks, R, s.ref_cfg,
                                        device)
        state, losses = step_fn(state, batches[k], P_step.TrainDraws(*draws))
        norms = torch._foreach_norm([t.grad for t in leaves
                                     if t.grad is not None])
        finite = torch.isfinite(losses['loss']) & torch.isfinite(
            torch.stack(norms).sum())
        bad = bad + (~finite).int()
        if on_gpu:
            torch.cuda.synchronize()
        return k, draws, losses

    for w in range(tr['warmup_steps']):
        call(-1 - w)
    if on_gpu:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    P_trace.take_counts()
    bad.zero_()
    setup_s = time.perf_counter() - r.t0
    print(f'setup: {setup_s:.1f} s, of which the inputs until '
          f'{t_inputs - r.t0:.1f} s (the fit '
          f'{"read back" if s.scene.fit_cached else "made"} in '
          f'{s.scene.fit_s:.1f} s, loss {s.scene.fit_loss:.4g}), the program '
          f'and its {tr["warmup_steps"]} warm-up steps '
          f'{time.perf_counter() - t_inputs:.1f} s', file=sys.stderr)

    trace_steps = tr['trace_steps'] if r.trace else 0
    compare_at = compared_units(r.seed, P, tr['trace_steps'])
    snaps, step_s = [], []
    tracer = stack = None
    traced_counts = {}
    aside_s = 0.0
    t_start = time.perf_counter()
    j = 0
    while True:
        if trace_steps and j == 1:
            stack = contextlib.ExitStack()
            tracer = stack.enter_context(TrainTracer())
            stack.enter_context(window())
        t0 = time.perf_counter()
        if j in compare_at:
            tc = time.perf_counter()
            snap = snapshot(prog, s.order[j % P])
            aside_s += time.perf_counter() - tc
            P_trace.take_counts()
            with counting(device):
                k, draws, losses = call(j)
            tc = time.perf_counter()
            counts = P_trace.take_counts()
            snap.update(
                draws=[host(t) for t in draws],
                prog=outcome_of(prog, losses['loss']),
                counts={n: counts.get(n, 0) for n in ('idiff.points',
                                                      'idiff.guarded')})
            snaps.append(snap)
            aside_s += time.perf_counter() - tc
        else:
            call(j)
        step_s.append(time.perf_counter() - t0)
        j += 1
        if stack is not None and j == 1 + trace_steps:
            stack.close()
            stack = None
            traced_counts = P_trace.take_counts()
            # the trace's export and reduction are no step's time
            aside_s += time.perf_counter() - t0 - step_s[-1]
        now = time.perf_counter()
        if now - t_start >= r.seconds + aside_s and j % P == 0 and (
                not trace_steps or tracer.summary is not None):
            break
    window_s = time.perf_counter() - t_start - aside_s
    peak = torch.cuda.max_memory_allocated() if on_gpu else 0
    nonfinite = int(bad)
    undo()
    steps = j
    print(f'window: {steps} steps in {window_s:.2f} s (the compared steps\' '
          f'host copies and the trace\'s export, {aside_s:.2f} s, left '
          f'out); steps '
          f'{np.median(step_s) * 1e3:.1f} ms median, '
          f'{np.percentile(step_s, 90) * 1e3:.1f} ms p90; each pass\'s '
          'steps (s): ' + ', '.join(
              f'{sum(step_s[i:i + P]):.2f}' for i in range(0, steps, P)),
          file=sys.stderr)

    labels = prog.labels
    del state, batches, prog, leaves, by_path, step_fn
    if on_gpu:
        torch.cuda.empty_cache()
    ref_w = rtrain.loss_weights(cfg, R)
    compared, points, guarded = [], 0, 0
    for snap in snaps:
        losses, grads, after, counts, before, denom = reference_step(
            s, cfg, ref_w, snap, device)
        g = gaps(snap['prog'], {'loss': losses['loss'], 'grads': grads,
                                'after': after, 'denom': denom}, before,
                 labels)
        points += snap['counts']['idiff.points']
        guarded += snap['counts']['idiff.guarded']
        print(f'compared step (pool {snap["k"]}): loss '
              f'{snap["prog"]["loss"]:.6g} / {losses["loss"]:.6g}; grad gaps '
              + ', '.join(
                  f'{n} {v:.3g}' for n, v in g['groups']['grad'].items())
              + '; change gaps ' + ', '.join(
                  f'{n} {v:.3g}' for n, v in g['groups']['change'].items())
              + ' (entries left out: ' + ', '.join(
                  f'{n} {v:.2g}' for n, v in g['groups']['left_out'].items())
              + ')'
              + f'; guard: program {snap["counts"]["idiff.guarded"]} of '
              f'{snap["counts"]["idiff.points"]}, reference '
              f'{counts["guarded"]} of {counts["points"]}', file=sys.stderr)
        compared.append(g)
        del grads, after, before, denom
        if on_gpu:
            torch.cuda.empty_cache()
    share = guarded / points if points else math.nan
    checks = checks_of(steps, compared, r.limits, nonfinite, share,
                       s.refine)
    e2e = {'render_rays_per_s': steps * n_blocks * R / window_s,
           'peak_mem_gib': peak / 2 ** 30, 'setup_s': setup_s}
    facts = {'kind': 'train'}
    if tracer is not None:
        spans = tracer.spans
        facts.update(trace=tracer.summary, counts=traced_counts,
                     spans=spans,
                     steps=spans.get('train.step', [trace_steps])[0])
    return Outcome(e2e, facts, checks, steps, nonfinite,
                   max(peak, setup_peak) if on_gpu else 0)
