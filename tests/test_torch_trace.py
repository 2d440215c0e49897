"""The port's instrumentation (`arah_tpu_torch/utils/trace.py`) on the CPU,
on the flagship scene at 40 rays (`scene.build_scene(pretrain=False)`),
rendered by the evaluator in chunks of 16 (the last one padded), every
kernel computing its plain version, with `cano_view_dirs` on so that the
renderer's sync point is on the path and corr phase 1 cut to 2
iterations so that phase 2 runs.

With no profiler a span is the shared null context and nothing is
counted. Under a CPU `torch.profiler` the spans nest as the layers do
(`eval.image` > `eval.chunk` > `renderer.*` > `tracer.*`), the sync
spans are as many as the chunks and splits make, kernel B's counted
evaluations are the plain solve's `mask.sum() + iters.sum()`, and the
render's outputs are bit for bit those without the profiler. A profiled
training run writes the counts beside its trace.
"""
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

torch.set_num_threads(2)

N_RAYS, CHUNK = 40, 16
N_CHUNKS = -(-N_RAYS // CHUNK)


@pytest.fixture(scope='module')
def scene():
    from arah_tpu_torch.scene import build_scene, flagship_config
    cfg = flagship_config()
    # corr phase 1 cut to 2 iterations, so that phase 2 runs
    cfg = cfg._replace(cano_view_dirs=True, tracer=cfg.tracer._replace(
        corr_phase1_steps=2))
    params, fd, inp = build_scene(cfg, N_RAYS, device='cpu', pretrain=False)
    item = {'inputs.ray_dirs': inp.ray_dirs.numpy(),
            'inputs.body_bounds_intersections': torch.stack(
                [inp.near, inp.far], -1).numpy(),
            'image.cam_loc': inp.cam_loc.numpy()}
    return cfg, params, fd, inp, item


def render(scene):
    from arah_tpu_torch.eval.evaluator import render_frame_rays
    cfg, params, fd, _, item = scene
    return render_frame_rays(params, cfg, fd, item, params['latent'][0],
                             chunk=CHUNK)


@pytest.fixture(scope='module')
def profiled(scene):
    """(outputs, the profiler's `arah.` events, the counts taken) of one
    render under a CPU profiler."""
    from arah_tpu_torch.utils import trace
    trace.take_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = render(scene)
    events = [(e.name[len('arah.'):], e.time_range.start, e.time_range.end)
              for e in prof.events() if e.name.startswith('arah.')]
    return out, events, trace.take_counts()


def test_no_profiler_no_span_and_no_count(scene):
    from arah_tpu_torch.utils import trace
    trace.take_counts()
    assert not trace.recording()
    assert trace.span('eval.image') is trace._NULL
    assert trace.sync('eval.sync.h2d') is trace._NULL
    assert trace.corr_iters(8, 'cpu') is None
    out = render(scene)
    assert all(np.isfinite(a).all() for a in out[:3])
    assert trace._ACC == {} and trace._HOST == {}
    assert trace.take_counts() == {}


def test_spans_nest_by_layer(profiled):
    _, events, _ = profiled

    def within(inner, outer):
        return [e for e in events if e[0].startswith(inner)
                and not any(o[0].startswith(outer) and o[1] <= e[1]
                            and e[2] <= o[2] for o in events)]
    names = {e[0] for e in events}
    assert [e[0] for e in events].count('eval.image') == 1
    assert [e[0] for e in events].count('eval.chunk') == N_CHUNKS
    for want in ('eval.pad', 'renderer.render', 'renderer.generate',
                 'renderer.skin_dense', 'renderer.pose_feature',
                 'renderer.shade', 'renderer.color', 'renderer.composite',
                 'tracer.trace', 'tracer.pack', 'tracer.march.p1',
                 'tracer.march.p2', 'tracer.iso.init', 'tracer.iso.p1',
                 'tracer.iso.p2', 'tracer.sample', 'tracer.corr.init',
                 'tracer.corr.p1', 'tracer.corr.p2'):
        assert want in names, want
    assert within('eval.chunk', 'eval.image') == []
    assert within('renderer.', 'eval.chunk') == []
    assert within('tracer.', 'renderer.render') == []
    assert within('tracer.', 'tracer.trace') == []


def test_sync_spans_are_the_chunks_and_splits(profiled):
    """Each chunk: three input copies, four output copies and one resolve
    of each split (march, iso, corr); the image: its camera's copy. (The
    inverse affines' constant row is copied once a process, on the
    image's first use, by `core/linalg.py:device_const`.) The counts
    taken are the spans, name by name."""
    _, events, counts = profiled
    per_chunk = {'eval.sync.h2d': 3, 'eval.sync.d2h': 4,
                 'tracer.sync.resolve': 3}
    want = {k: v * N_CHUNKS for k, v in per_chunk.items()}
    want['eval.sync.h2d'] += 1
    got = {}
    for name, _, _ in events:
        if '.sync.' in name:
            got[name] = got.get(name, 0) + 1
    assert got == want
    assert {k: v for k, v in counts.items() if '.sync.' in k} == want


def test_corr_counts_are_the_plain_solves(scene):
    """B's phase-1 and phase-2 evaluations and phase 1's unmasked points,
    counted by the split solve under a profiler, against
    `corr_search_plain` on the same inputs: mask.sum() + iters.sum() of
    phase 1 over every point and of phase 2 over the first
    `corr_resolve_cap` points still active."""
    from arah_tpu_torch.nn.skinning import skinning_dense_params
    from arah_tpu_torch.ops.corr import corr_search_plain
    from arah_tpu_torch.render.ray_tracing import (_corr_solve_split,
                                                   corr_init)
    from arah_tpu_torch.render.renderer import make_skin_fn
    from arah_tpu_torch.utils import trace
    cfg, params, fd, inp, _ = scene
    tr = cfg.tracer
    g = torch.Generator().manual_seed(3)
    t = torch.rand((600, 1), generator=g)
    pts = (inp.cam_loc + (inp.near[:1] + t * (inp.far[:1] - inp.near[:1]))
           * inp.ray_dirs[torch.arange(600) % N_RAYS])
    mask = torch.rand((600,), generator=g) < 0.8
    with torch.no_grad():
        wts, bs = skinning_dense_params(params['skinning'], cfg.skinning)[:2]
        dense = (wts, bs, cfg.skinning.softmax_scale)
        x_bar, x0, T0 = corr_init(tr, fd.frame, fd.smpl, pts)
        trace.take_counts()
        with profile(activities=[ProfilerActivity.CPU]):
            _corr_solve_split(tr, make_skin_fn(params, cfg), fd.frame,
                              dense, x_bar, x0, T0, mask)
        counts = trace.take_counts()
        box = (fd.frame.bone_transforms.reshape(24, 16), fd.frame.coord_min,
               fd.frame.coord_max, fd.frame.center)
        it1 = torch.zeros((600,), dtype=torch.int32)
        act = corr_search_plain(x_bar, x0, T0.reshape(-1, 16), mask, wts, bs,
                                *box, max_steps=tr.corr_phase1_steps,
                                softmax_scale=dense[2], iters=it1)[3]
        idx = torch.nonzero(act).flatten()[:tr.corr_resolve_cap]
        it2 = torch.zeros((len(idx),), dtype=torch.int32)
        corr_search_plain(x_bar[idx], x0[idx], T0[idx].reshape(-1, 16),
                          torch.ones_like(idx, dtype=torch.bool), wts, bs,
                          *box, max_steps=tr.corr_max_steps,
                          softmax_scale=dense[2], iters=it2)
    assert 0 < len(idx) < int(mask.sum())
    assert counts['corr.p1'] == int(mask.sum()) + int(it1.sum())
    assert counts['corr.p2'] == len(idx) + int(it2.sum())
    assert counts['corr.p1.points'] == int(mask.sum())
    assert counts['corr.rows'] == 600 + len(idx)
    assert counts['corr.launches'] == 2


def test_iso_init_counts(scene, profiled):
    """The iso init's counts: the launch count `COUNTS['iso_init']`, which
    `reset_counts` zeroes and a CPU render (the plain version) leaves at
    0; and under a session one `iso.init` a solve of kernel F's path, as
    many as the `tracer.iso.init` spans, read and zeroed by
    `take_counts()`."""
    from arah_tpu_torch.utils import trace
    _, events, counts = profiled
    spans = [e for e in events if e[0] == 'tracer.iso.init']
    assert counts['iso.init'] == len(spans) >= N_CHUNKS
    assert 'iso.init' not in trace.take_counts()
    trace.COUNTS['iso_init'] += 3
    trace.reset_counts()
    assert trace.COUNTS['iso_init'] == 0
    render(scene)
    assert trace.COUNTS['iso_init'] == 0
    assert trace.take_counts() == {}


def test_outputs_bit_equal_with_and_without_profiler(scene, profiled):
    out = render(scene)
    assert out[3].any()
    for a, b in zip(out, profiled[0]):
        np.testing.assert_array_equal(a, b)


def test_profiled_training_writes_counters(tmp_path):
    """`cli.train --profile-dir` on the CPU (the fake fixture's 2 frames,
    6 epochs, so that steps 8-10 run): the trace and, beside it,
    `counters.json` with kernel B's evaluations of the three steps and
    the iso init's calls; no count is left behind."""
    from arah_tpu_torch.cli import train
    from arah_tpu_torch.data.fake_dataset import main as fake_main
    from arah_tpu_torch.utils import trace
    from test_torch_cli import tiny_config
    root = str(tmp_path / 'fake_zju')
    fake_main(['--root', root, '--frames', '2', '--views', '1,7',
               '--img-size', '64', '--verts', '256'])
    prof_dir = str(tmp_path / 'prof')
    cfg = tiny_config(tmp_path / 'cfg.yaml', root, str(tmp_path / 'out'),
                      max_epochs=6, checkpoint_every_n_epochs=6,
                      validate_every_n_epochs=10)
    train.main([cfg, '--device', 'cpu', '--profile-dir', prof_dir])
    assert os.path.exists(os.path.join(prof_dir, 'trace.json'))
    with open(os.path.join(prof_dir, 'counters.json')) as f:
        counts = json.load(f)
    assert counts['corr.p1'] >= counts['corr.p1.points'] > 0
    assert counts['corr.launches'] >= 3
    assert counts['iso.init'] >= 3
    assert trace.take_counts() == {}


@pytest.fixture(scope='module')
def train_profiled():
    """(the `arah.` events, the counts taken, the block count) of one
    refined train step (`scene.build_train_setup(refined=True)`: two
    blocks on two poses, SMPL refinement, a 16 x 16 patch a block) under
    a CPU profiler, after one step without it that leaves no count."""
    from arah_tpu_torch import scene as scene_mod
    from arah_tpu_torch.data.batch import draw_train_draws
    from arah_tpu_torch.utils import trace
    patch = scene_mod.PATCH
    scene_mod.PATCH = 16
    try:
        cfg = scene_mod.flagship_config()
        s = scene_mod.build_train_setup(cfg, n_rays=24, n_reg=16,
                                        pretrain=False, device='cpu',
                                        refined=True)
    finally:
        scene_mod.PATCH = patch
    n_blocks, R = s.batch.ray_dirs.shape[:2]

    def draws(seed):
        return draw_train_draws(np.random.RandomState(seed), cfg, n_blocks,
                                R, device='cpu')
    trace.take_counts()
    state, _ = s.step(s.state, s.batch, draws(1))
    unprofiled = trace.take_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s.step(state, s.batch, draws(2))
    events = [(e.name[len('arah.'):], e.time_range.start, e.time_range.end)
              for e in prof.events() if e.name.startswith('arah.')]
    return events, trace.take_counts(), unprofiled, n_blocks


def test_train_step_spans_nest_and_count(train_profiled):
    """One `train.step`; in it, before the blocks, one `train.frame` (the
    blocks' refined frames) and one `renderer.generate` (their
    hypernetwork pass); a `train.block` a block, each holding its render,
    its loss and its backward; after the blocks one more `train.backward`
    (the batched pass's) and one `train.optim` (Adam); no
    `train.allreduce` without a mesh."""
    events, _, _, n_blocks = train_profiled
    names = [e[0] for e in events]

    def inside(inner, outer):
        return [e for e in events if e[0] == inner
                and any(o[0] == outer and o[1] <= e[1] and e[2] <= o[2]
                        for o in events)]
    assert names.count('train.step') == 1
    assert names.count('train.optim') == 1
    assert 'train.allreduce' not in names
    for name in ('train.block', 'train.loss'):
        assert names.count(name) == n_blocks, name
    assert names.count('train.frame') == names.count('renderer.generate') \
        == 1
    assert names.count('train.backward') == n_blocks + 1
    for name in ('train.block', 'train.optim', 'train.frame',
                 'renderer.generate', 'train.backward'):
        assert len(inside(name, 'train.step')) == names.count(name), name
    for name in ('train.loss', 'renderer.render'):
        assert len(inside(name, 'train.block')) == names.count(name), name
    assert len(inside('train.backward', 'train.block')) == n_blocks
    assert not inside('train.frame', 'train.block')
    assert not inside('renderer.generate', 'train.block')
    blocks = [e for e in events if e[0] == 'train.block']
    first = min(e[1] for e in blocks)
    last = max(e[2] for e in blocks)
    for name in ('train.frame', 'renderer.generate'):
        assert [e for e in events if e[0] == name][0][2] <= first, name
    optim = [e for e in events if e[0] == 'train.optim'][0]
    batched = [e for e in events if e[0] == 'train.backward'
               and e[1] >= last]
    assert len(batched) == 1 and batched[0][2] <= optim[1]


def test_train_step_counts(train_profiled):
    """The train step's sync (the loss's read of the mask's maximum) is
    counted once a block, as its spans are; the implicit-diff correction
    counts its converged samples and those the guard dropped; without a
    profiler nothing is counted."""
    events, counts, unprofiled, n_blocks = train_profiled
    syncs = [e for e in events if e[0] == 'train.sync.boundary']
    assert counts['train.sync.boundary'] == len(syncs) == n_blocks
    assert counts['idiff.points'] > 0
    assert 0 <= counts['idiff.guarded'] <= counts['idiff.points']
    assert unprofiled == {}
