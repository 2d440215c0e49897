"""The train cells at a size the CPU holds: their configurations and
traffic with a 64 x 64 image, two step batches of two blocks (one for
ZJU-313) of 16 rays, no fit and one warm-up step, on the CPU, where
every kernel of the program computes its plain version. Each run
computes and prints every check; it is correct as it stands, and not
correct with each of the train cells' faults planted in the program (a
dropped SMPL gradient, the guard taken away from singular Jacobians, a
floor that drops every point); the control (the reference one precision
lower) is not correct either. A program without the determinant guard
is refused at once. The plain train reference imports neither JAX nor
the program, and the per-layer readers read a traced run's facts and
nothing from a program without the train step's spans and counts."""
import importlib.util
import os
import time

import pytest

from gpubench import harness
from gpubench.tests.tiny import HERE, cells, load
from gpubench.tests.test_gpubench_imports import top_level_imports

TRAIN = ['h36m_s9.train', 'zju313.train']
FAULTS = [('h36m_s9.train', 'dropped_smpl_grad'),
          ('h36m_s9.train', 'unguarded_singular'),
          ('zju313.train', 'wide_floor')]


def tiny_train(workload: str, seed: int = 3141592653589, fault=None):
    cell = cells()[workload]
    cfg = load(HERE, 'configs', cell['config'] + '.json')
    tr = load(HERE, 'traffic', cell['traffic'] + '.json')
    sc = cfg['scene']
    sc['cameras']['focal'] *= 64 / max(sc['img_size'])
    sc['img_size'] = [64, 64]
    tr.update(pool=2, fg_rays=12, bg_rays=4, fit_steps=0, warmup_steps=1,
              blocks=min(tr['blocks'], 2), trace_steps=0)
    return harness.Run(workload, cfg, tr,
                       load(HERE, 'limits', workload + '.json'), seed, 0.2,
                       False, 'cpu', time.perf_counter(), fault)


def run_tiny(workload, **kw):
    import torch
    from gpubench.kinds import train
    torch.set_num_threads(4)
    out = train.run(tiny_train(workload, **kw))
    return out, harness.verdict(out.checks)


def lines(out):
    return '\n'.join(harness.check_line(c) for c in out.checks)


@pytest.mark.parametrize('workload', TRAIN)
def test_tiny_train_run_is_correct(workload, capsys):
    out, ok = run_tiny(workload)
    assert ok, lines(out)
    names = [c.name for c in out.checks]
    assert names[:3] == ['steps_done', 'steps_compared', 'nonfinite']
    assert {'loss_gap', 'grad_gap', 'change_gap', 'guarded_share'} \
        <= set(names)
    assert ('smpl_grad_gap' in names) == (workload == 'h36m_s9.train')
    assert out.e2e['render_rays_per_s'] > 0
    err = capsys.readouterr().err
    assert err.count('compared step (pool') == 2


@pytest.mark.parametrize('workload,fault', FAULTS)
def test_a_planted_fault_is_not_correct(workload, fault):
    out, ok = run_tiny(workload, fault=fault)
    assert not ok, lines(out)
    failed = {c.name for c in out.checks if not c.ok}
    want = {'dropped_smpl_grad': 'smpl_grad_gap',
            'unguarded_singular': 'nonfinite',
            'wide_floor': 'guarded_share'}[fault]
    assert want in failed, lines(out)


def test_the_control_is_not_correct():
    import torch
    from gpubench.control_train import control_checks
    torch.set_num_threads(4)
    checks = control_checks(tiny_train('h36m_s9.train'))
    assert not harness.verdict(checks), '\n'.join(
        harness.check_line(c) for c in checks)


def test_a_program_without_the_guard_is_refused_at_once(monkeypatch):
    from arah_tpu_torch.render import renderer
    from gpubench.kinds import train
    monkeypatch.delattr(renderer, 'IDIFF_DET_FLOOR')
    t0 = time.perf_counter()
    with pytest.raises(SystemExit) as exc:
        train.run(tiny_train('zju313.train'))
    assert 'determinant guard' in str(exc.value)
    assert time.perf_counter() - t0 < 5.0


def test_the_train_reference_takes_nothing_of_the_program_or_jax():
    for name in ('train.py',):
        names = top_level_imports(os.path.join(HERE, 'reference', name))
        assert names <= {'gpubench', 'torch', 'math', 'typing',
                         '__future__'}, names


def reader(name):
    path = os.path.join(HERE, 'metrics', name + '.py')
    spec = importlib.util.spec_from_file_location('m', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_the_train_readers():
    from gpubench.devtrace import TraceSummary
    t = TraceSummary(2.0, 0.5, 300, {}, [], [])
    facts = {'kind': 'train', 'trace': t, 'steps': 3,
             'spans': {'train.step': [3, 1.5], 'train.backward': [6, 0.3],
                       'train.frame': [12, 0.06]},
             'counts': {'train.sync.boundary': 12, 'tracer.sync.resolve': 30,
                        'idiff.points': 10}}
    assert reader('device_idle_share.train')(facts) == 75.0
    assert reader('launches_per_step.train')(facts) == 100.0
    assert reader('backward_ms_per_step.train')(facts) == pytest.approx(100)
    assert reader('frame_ms_per_step.train')(facts) == pytest.approx(20)
    assert reader('host_syncs_per_step.train')(facts) == 14.0
    # a program without the train step's spans and counts: nothing
    bare = dict(facts, spans={}, counts={'tracer.sync.resolve': 30})
    for name in ('backward_ms_per_step.train', 'frame_ms_per_step.train',
                 'host_syncs_per_step.train'):
        assert reader(name)(bare) is None
    # a render cell's facts: nothing
    for name in ('device_idle_share.train', 'launches_per_step.train'):
        assert reader(name)({'kind': 'render', 'trace': t}) is None


def test_each_train_cell_has_its_files():
    bench = load(os.path.dirname(HERE), 'BENCHMARK.json')
    for w in TRAIN:
        cell = cells()[w]
        assert load(HERE, 'traffic', cell['traffic'] + '.json')['kind'] \
            == 'train'
        limits = load(HERE, 'limits', w + '.json')
        assert set(limits) == {'loss_gap', 'grad_gap', 'change_gap',
                               'guarded_share'} | (
            {'smpl_grad_gap'} if w == 'h36m_s9.train' else set())
    rr = [m for m in bench['end_to_end']
          if m['name'] == 'render_rays_per_s'][0]
    assert set(TRAIN) <= set(rr['workloads'])


def test_change_gap_holds_the_entries_adam_determines():
    """An entry whose gradient is round-off next to its group's, flipped
    in sign, moves a whole Adam step either way and is left out of
    `change_gap`; a real fault in the update (a tenth too large a step
    on every entry, or a move of an entry with no gradient) is not."""
    import torch
    from gpubench.kinds import train
    path = ('color', 'w')
    g = torch.linspace(0.5, 1.5, 100)
    g[7] = 1e-9
    before = {path: torch.zeros(100)}
    denom = g.abs() * 0.2436          # a row's first Adam step
    ref = {'loss': 1.0, 'grads': {path: g}, 'denom': {path: denom},
           'after': {path: -0.49 * torch.sign(g)}}
    flipped = ref['after'][path].clone()
    flipped[7] = -flipped[7]
    prog = {'loss': 1.0, 'grads': {path: g}, 'after': {path: flipped}}
    labels = {path: 'color'}
    out = train.gaps(prog, ref, before, labels)
    assert out['change_gap'] == 0.0
    assert out['groups']['left_out']['color'] == 0.01
    no_denom = {k: v for k, v in ref.items() if k != 'denom'}
    assert train.gaps(prog, no_denom, before, labels)['change_gap'] > 0.19
    prog['after'] = {path: ref['after'][path] * 1.1}
    assert abs(train.gaps(prog, ref, before, labels)['change_gap'] - 0.1) \
        < 1e-6
    # an entry the step gives no gradient stays held: moving it is seen
    g[3] = 0.0
    ref['denom'][path][3] = 0.0
    ref['after'][path][3] = 0.0
    prog['after'] = {path: ref['after'][path].clone()}
    prog['after'][path][3] = 0.49
    assert train.gaps(prog, ref, before, labels)['change_gap'] > 0.09
