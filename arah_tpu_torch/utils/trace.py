"""The port's instrumentation: spans on the profiler's clock, the kernels'
launch counts, and kernel B's work.

Spans. While a `torch.profiler` session records, `span(name)` is
`torch.profiler.record_function('arah.' + name)`, so that the span lands
in the session's trace beside the kernels, on its clock; otherwise it is
one shared null context, and a span costs one check (an unchecked
`record_function` costs ~10 us with no session). Names are
`<layer>.<what>`, the layer one of `eval`, `renderer`, `tracer`, placed
at the phases of the render path, never inside a solver's loop, or
`train`, placed at the train step's phases (`train.step`, `.block`,
`.frame`, `.loss`, `.backward`, `.optim`, `.allreduce`). A point
where the host waits for the device stream is a span of its own,
`<layer>.sync.<what>` (`sync`), around exactly one blocking operation,
and is counted under its name.

Launch counts. Each kernel wrapper adds one to `COUNTS[name]` per launch
and nowhere else, so that a run can show that its path went through the
kernels; a launch of an option's variant counts under the variant's
name. These count always; `reset_counts` zeroes them.

Work counts. While a session records, the tracer hands kernel B an
iteration buffer (`corr_iters`) and adds each solve's evaluations, one
at init and one an iteration of each unmasked point, to an int64
accumulator on the device, by phase (`count_corr`: `corr.p1`,
`corr.p2`, and phase 1's unmasked points `corr.p1.points`), with the
rows and launches of B (`corr.rows`, `corr.launches`) on the host; and
it counts the iso init's calls, one a solve of kernel F, on the host
(`iso.init`, `count`). The training render's implicit-diff correction
counts, on the device, its corrected points and those of them that its
determinant guard dropped (`idiff.points`, `idiff.guarded`;
`count_idiff`). `take_counts()` reads every work and sync count
with one sync and zeroes them. With no session no buffer or accumulator
exists and B is launched as it would be without this module.
"""
from __future__ import annotations

import contextlib

import torch

COUNTS = {'knn': 0, 'corr': 0, 'shade': 0, 'color_fwd': 0, 'march': 0,
          'iso': 0, 'skin_jac': 0, 'shade_bwd': 0, 'color_bwd': 0,
          'siren': 0, 'knn_rows': 0, 'corr_rows': 0, 'iso_init': 0,
          # the launches of the kernel variants that options select, each
          # counted under its own name only (C and H with bf16 residents;
          # B with want_jac and at a precision other than f32)
          'shade_resid': 0, 'shade_bwd_resid': 0, 'corr_jac': 0,
          'corr_split3': 0, 'corr_bf16': 0, 'corr_jac_split3': 0,
          'corr_jac_bf16': 0}

_NULL = contextlib.nullcontext()
_ACC: dict = {}          # name -> int64 device scalar (work counts)
_HOST: dict = {}         # name -> int (syncs, B's rows and launches)

recording = torch.autograd._profiler_enabled


def reset_counts():
    for k in COUNTS:
        COUNTS[k] = 0


def span(name: str):
    """The span `arah.<name>` while a profiler session records, else the
    shared null context."""
    if recording():
        return torch.profiler.record_function('arah.' + name)
    return _NULL


def sync(name: str):
    """`span(name)` around one operation that blocks the host on the
    device stream (`name` is `<layer>.sync.<what>`), counted under `name`
    while a session records."""
    if recording():
        _HOST[name] = _HOST.get(name, 0) + 1
        return torch.profiler.record_function('arah.' + name)
    return _NULL


def count(name: str):
    """Add one to the host count `name` while a session records."""
    if recording():
        _HOST[name] = _HOST.get(name, 0) + 1


def corr_iters(n: int, device):
    """Kernel B's (n,) int32 iteration buffer while a session records,
    else None."""
    if not recording():
        return None
    return torch.zeros((n,), dtype=torch.int32, device=device)


def _add(name: str, value: torch.Tensor):
    acc = _ACC.get(name)
    if acc is None:
        _ACC[name] = value.to(torch.int64)
    else:
        acc.add_(value)


def count_corr(phase: str, mask: torch.Tensor, iters):
    """Add one solve of kernel B (or its plain version) to phase `phase`
    ('p1' or 'p2'): its evaluations, mask.sum() + iters.sum(), on the
    device, and its rows and launch on the host. No-op where `iters` is
    None (no session recorded when the solve was launched)."""
    if iters is None:
        return
    points = mask.sum()
    _add('corr.' + phase, points + iters.sum())
    if phase == 'p1':
        _add('corr.p1.points', points)
    _HOST['corr.rows'] = _HOST.get('corr.rows', 0) + mask.shape[0]
    _HOST['corr.launches'] = _HOST.get('corr.launches', 0) + 1


def count_idiff(ok: torch.Tensor, valid=None):
    """Add one implicit-diff correction: its points (`valid()`, (N,)
    bool, or all N) to `idiff.points` and those of them whose Jacobian the
    determinant guard dropped (~ok) to `idiff.guarded`, on the device.
    No-op unless a session records; `valid` is called only then."""
    if not recording():
        return
    valid = torch.ones_like(ok) if valid is None else valid()
    _add('idiff.points', valid.sum())
    _add('idiff.guarded', (valid & ~ok).sum())


def take_counts(reset: bool = True) -> dict:
    """{name: int} of the work and sync counts since they were last
    taken (one sync reads the device's); zeroes them unless `reset` is
    False."""
    out = dict(_HOST)
    if _ACC:
        names = sorted(_ACC)
        vals = torch.stack([_ACC[k] for k in names]).tolist()
        out.update(zip(names, vals))
    if reset:
        _ACC.clear()
        _HOST.clear()
    return out
