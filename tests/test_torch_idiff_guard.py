"""The determinant guard of the training render's implicit-diff correction
(`render/renderer.py:_idiff_correct`, `IDIFF_DET_FLOOR`), on the CPU on
the flagship's skinning net (random weights): 64 canonical points with
well-conditioned metric Jacobians given as `jac` (the corr kernel's
route), two of them planted: one near-singular (det ~1e-9), one
singular (det 0).

Guarded, the planted points keep their values and take no correction
(their gradient is the identity's), and the outputs and the gradients
of the points and of the skinning net are finite; unguarded (the floor
below every |det|) the near-singular point's gradient is ~1e7 times
the others' and the singular one's is not finite. Every other point's
output and gradient is bit for bit the unguarded correction's. The
floor is on the metric Jacobian, so that the box's size does not move
it; and under a profiler the correction counts its points and the ones
the guard dropped (`idiff.points`, `idiff.guarded`).
"""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

torch.set_num_threads(2)

N = 64


@pytest.fixture(scope='module')
def scene():
    from arah_tpu_torch.scene import build_scene, flagship_config
    cfg = flagship_config()._replace(train_skinning_net=True)
    params, fd, _ = build_scene(cfg, 16, device='cpu', pretrain=False)
    gen = torch.Generator().manual_seed(5)
    p = (torch.rand((N, 3), generator=gen) - 0.5)
    jac = torch.eye(3) + 0.2 * torch.randn((N, 3, 3), generator=gen)
    # rank 2 plus 1e-9 along the third direction: det ~1e-9
    u, _, vt = torch.linalg.svd(jac[0])
    planted = jac.clone()
    planted[0] = u @ torch.diag(torch.tensor([1.3, 0.7, 1e-9])) @ vt
    planted[1] = torch.diag(torch.tensor([1.0, 1.0, 0.0]))
    return cfg, params, fd.frame, p, jac, planted


def correct(scene, jac, floor=None, frame=None, valid=None):
    """(output, the points' gradient, the skinning net's gradients) of
    sum(w * correction) with the guard at `floor` (the program's by
    default)."""
    from arah_tpu_torch.render import renderer
    cfg, params, frame0, p0, _, _ = scene
    skin = {'layers': [{k: v.detach().clone().requires_grad_(True)
                        for k, v in lyr.items()}
                       for lyr in params['skinning']['layers']]}
    prm = dict(params, skinning=skin)
    p = p0.clone().requires_grad_(True)
    old = renderer.IDIFF_DET_FLOOR
    if floor is not None:
        renderer.IDIFF_DET_FLOOR = floor
    try:
        out = renderer._idiff_correct(prm, cfg, frame or frame0, p, jac,
                                      valid=valid)
    finally:
        renderer.IDIFF_DET_FLOOR = old
    w = torch.linspace(-1.0, 1.0, 3 * N).reshape(N, 3)
    (out * w).sum().backward()
    leaves = [v.grad for lyr in skin['layers'] for v in lyr.values()]
    return out.detach(), p.grad, leaves


def test_a_planted_near_singular_point_stays_finite(scene):
    _, _, _, p0, _, planted = scene
    out, gp, leaves = correct(scene, planted)
    assert torch.isfinite(out).all() and torch.isfinite(gp).all()
    assert all(torch.isfinite(g).all() for g in leaves)
    assert torch.equal(out[:2], p0[:2])
    w = torch.linspace(-1.0, 1.0, 3 * N).reshape(N, 3)
    assert torch.equal(gp[:2], w[:2])
    # unguarded, the near-singular point's gradient explodes and the
    # singular one's is not finite
    _, gp_u, leaves_u = correct(scene, planted, floor=-1.0)
    assert float(gp_u[0].abs().max()) > 1e6 * float(gp[2:].abs().max())
    assert not torch.isfinite(gp_u[1]).all()
    assert not all(torch.isfinite(g).all() for g in leaves_u)


def test_every_other_point_is_the_unguarded_correction_bit_for_bit(scene):
    _, _, _, _, jac, planted = scene
    out, gp, _ = correct(scene, planted)
    out_u, gp_u, leaves_u = correct(scene, jac, floor=-1.0)
    assert torch.equal(out[2:], out_u[2:])
    assert torch.equal(gp[2:], gp_u[2:])
    # with no point under the floor the guard changes nothing at all
    out_g, gp_g, leaves_g = correct(scene, jac)
    assert torch.equal(out_g, out_u) and torch.equal(gp_g, gp_u)
    assert all(torch.equal(a, b) for a, b in zip(leaves_g, leaves_u))


def counts(scene, jac, frame=None, valid=None):
    from arah_tpu_torch.utils import trace
    trace.take_counts()
    with profile(activities=[ProfilerActivity.CPU]):
        correct(scene, jac, frame=frame, valid=valid)
    return trace.take_counts()


def test_the_guard_is_counted(scene):
    from arah_tpu_torch.utils import trace
    _, _, _, _, jac, planted = scene
    got = counts(scene, planted)
    assert (got['idiff.points'], got['idiff.guarded']) == (N, 2)
    valid = torch.ones(N, dtype=torch.bool)
    valid[0] = False
    valid[5] = False
    got = counts(scene, planted, valid=lambda: valid)
    assert (got['idiff.points'], got['idiff.guarded']) == (N - 2, 1)
    assert counts(scene, jac)['idiff.guarded'] == 0
    # no profiler, no count, and the mask of counted points is not made
    trace.take_counts()

    def unmade():
        raise AssertionError('valid() called with no profiler')
    correct(scene, planted, valid=unmade)
    assert trace.take_counts() == {}


def test_the_floor_is_on_the_metric_jacobian(scene):
    """det(J_metric) of 0.2 is kept and 0.05 dropped (floor 0.1),
    whatever the size of the frame's box."""
    from arah_tpu_torch.render.renderer import IDIFF_DET_FLOOR
    _, _, frame, _, jac, _ = scene
    assert IDIFF_DET_FLOOR == 0.1
    j = jac.clone()
    j[0] = torch.diag(torch.tensor([1.0, 1.0, 0.2]))
    j[1] = torch.diag(torch.tensor([1.0, 1.0, 0.05]))
    for scale in (0.25, 1.0, 4.0):
        box = frame._replace(coord_min=frame.coord_min * scale,
                             coord_max=frame.coord_max * scale)
        assert counts(scene, j, frame=box)['idiff.guarded'] == 1
