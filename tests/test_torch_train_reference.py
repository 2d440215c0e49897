"""The port's train step against the benchmark's plain train reference
(`gpubench/reference/train.py`, plain torch, importing nothing of the
port), on the CPU at a small size: the train cells' configurations with
narrower networks, a 64 x 64 image, a few rays a block and random
weights from a fixed seed (the SIREN lowered through the box, no fit),
the VolSDF deviation raised to 0.05 m so that the samples' weights,
and with them the implicit-diff correction's gradient, are not zero.

One step of each: the plain step (ZJU-313: one block, no refinement)
and the refined step (H36M-S9: two blocks, a frame each, SMPL
refinement), after a first step that gives Adam its moments. Held:
every loss term, every leaf group's gradient, the SMPL leaves' on their
own, and the Adam update, by relative L2 gaps. On the CPU every kernel
of the port computes its plain version, which rounds as the kernel
does; the reference's solvers are the plain f32 loops. So the Broyden
searches of a few samples stop at another iterate on the two sides, and
with 16 rays a block a ray whose samples moved is 1/16 of the rendered
signal: at three seeds the rendered colour of one or two rays differed
by up to 4e-3, the loss terms by <= 7.2e-5, the gradients of the groups
that see the samples (skinning, colour, deviation, latents, SMPL) by
<= 1.2e-2 and their updates by <= 2.7e-2. The tolerances are 1e-3 for
the loss terms, 5e-2 for those groups' gradients and 0.1 for their
updates; the hypernet and its pose encoder, whose gradients reach them
through the generated SIREN of all samples, agree to <= 8e-7 and are
held to 1e-5 (updates 1e-4: p - lr u in f32 against parameters 1e4
times the hypernet's steps at lr 1e-6). The correction's gradient is
shown to count: with the guard widened to every point the skinning
net's gradient moves by 2.6 of itself, far past its tolerance.
"""
import json
import math
import os
import time

import pytest
import torch

torch.set_num_threads(4)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def small_run(workload: str, config: str, traffic: str):
    from gpubench import harness
    with open(os.path.join(ROOT, 'gpubench', 'configs', config)) as f:
        cfg = json.load(f)
    with open(os.path.join(ROOT, 'gpubench', 'traffic', traffic)) as f:
        tr = json.load(f)
    sc = cfg['scene']
    sc['n_verts'] = 1536
    sc['cameras']['focal'] *= 64 / max(sc['img_size'])
    sc['img_size'] = [64, 64]
    cfg['data']['train_end_frame'] = 6
    cfg['model']['decoder_kwargs']['hidden_features'] = 32
    cfg['model']['renderer_kwargs']['d_hidden'] = 32
    cfg['model']['skinning_decoder_kwargs']['d_hidden'] = 32
    tr.update(pool=2, fg_rays=12, bg_rays=4, fit_steps=0, warmup_steps=0,
              blocks=min(tr['blocks'], 2), trace_steps=0)
    return harness.Run(workload, cfg, tr, {}, 1234567890123, 0.0, False,
                       'cpu', time.perf_counter())


CASES = {'plain': ('zju313.train', 'arah_zju313.json', 'train_1x8192.json'),
         'refined': ('h36m_s9.train', 'arah_h36m_s9.json',
                     'train_4x2048_smpl.json')}


def one_step(r, wide_floor=False):
    """(the program's outcome, the reference's losses, grads and update,
    the parameters before, the optimizer's labels, the program's per-term
    losses) of one step of pool step 0."""
    from arah_tpu_torch.parallel.train_step import TrainDraws, TrainState
    from arah_tpu_torch.render import renderer as P_renderer
    from gpubench import train_inputs
    from gpubench.kinds import train
    from gpubench.reference import train as rtrain
    s = train.prepare(r)
    s.params['deviation']['variance'].fill_(0.05)
    prog = train.build_program(s, r.cfg, 'cpu')
    state = TrainState(prog.params, prog.optimizer, 0)
    # a first step, so that Adam's moments are those of a run: from zero
    # moments Adam's update is g / |g|, whose sign a gradient near 0
    # flips on round-off
    state, _ = prog.step(state, prog.batches[1], TrainDraws(
        *train_inputs.step_draws(r.seed, -1, r.traffic['blocks'], s.n_rays,
                                 s.ref_cfg, 'cpu')))
    snap = train.snapshot(prog, 0)
    draws = train_inputs.step_draws(r.seed, 0, r.traffic['blocks'],
                                    s.n_rays, s.ref_cfg, 'cpu')
    floor = P_renderer.IDIFF_DET_FLOOR
    if wide_floor:
        P_renderer.IDIFF_DET_FLOOR = 1e30
    try:
        _, losses = prog.step(state, prog.batches[0], TrainDraws(*draws))
    finally:
        P_renderer.IDIFF_DET_FLOOR = floor
    out = train.outcome_of(prog, losses['loss'])
    snap['draws'] = [t.clone() for t in draws]
    ref_losses, grads, after, counts, before, denom = train.reference_step(
        s, r.cfg, rtrain.loss_weights(r.cfg, s.n_rays), snap, 'cpu')
    return out, (ref_losses, grads, after, counts, denom), before, \
        prog.labels, \
        {k: float(v) for k, v in losses.items()}


@pytest.fixture(scope='module', params=sorted(CASES))
def step_pair(request):
    return request.param, one_step(small_run(*CASES[request.param]))


def test_every_loss_term_matches(step_pair):
    _, (out, ref, _, _, prog_losses) = step_pair
    ref_losses = ref[0]
    assert math.isfinite(out['loss']) and out['loss'] > 0
    for name, want in ref_losses.items():
        assert abs(prog_losses[name] - want) <= 1e-3 * max(abs(want), 1e-3),\
            (name, prog_losses[name], want)


def test_every_group_gradient_and_the_update_match(step_pair):
    from gpubench.kinds import train
    case, (out, ref, before, labels, _) = step_pair
    _, grads, after, counts, denom = ref
    g = train.gaps(out, {'loss': ref[0]['loss'], 'grads': grads,
                         'after': after, 'denom': denom}, before, labels)
    groups = g['groups']['grad']
    want = {'hypernet', 'pose_encoder', 'skinning', 'color', 'latent',
            'deviation'} | ({'smpl'} if case == 'refined' else set())
    assert set(groups) == want
    exact = ('hypernet', 'pose_encoder')
    for name, gap in groups.items():
        assert gap <= (1e-5 if name in exact else 5e-2), (name, gap)
    for name, gap in g['groups']['change'].items():
        assert gap <= (1e-4 if name in exact else 0.1), (name, gap)
    # the SMPL poses' gradients reach the loss
    if case == 'refined':
        assert float(grads[('smpl_params', 'pose_body')].abs().max()) > 0
    assert counts['points'] > 0


def test_the_correction_gradient_counts():
    """Widening the program's guard to every point drops the
    correction's gradient, and the skinning net's gradient moves."""
    from gpubench.kinds import train
    r = small_run(*CASES['plain'])
    out, ref, before, labels, _ = one_step(r)
    wide, _, _, _, _ = one_step(r, wide_floor=True)
    paths = [p for p in before if p[0] == 'skinning']
    assert train.rel_gap([wide['grads'][p] for p in paths],
                         [out['grads'][p] for p in paths]) > 0.5


def test_the_reference_guards_at_the_program_floor():
    from arah_tpu_torch.render import renderer
    from gpubench.reference import train as rtrain
    assert rtrain.IDIFF_DET_FLOOR == renderer.IDIFF_DET_FLOOR
