"""The perceptual patch loss of the port (`utils/lpips.py`) against the
JAX package's (`utils/lpips_jax.py`) on the CPU: the multi-scale DSSIM
proxy and its gradient, VGG LPIPS on a stand-in weight file that the test
writes (as `test_lpips.py` does; the real weights are not in the
repository), the metric's name and the loss switching to LPIPS when the
weights appear, the proxy's warning, and the train step with
`perceptual > 0` (tolerances of `test_torch_train_step.py`)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_lpips import _fabricate_weights
from test_renderer import small_config
from torch_port_util import check_step_vs_jax, jax_scene, jax_step, port_step

torch.set_num_threads(2)


@pytest.mark.parametrize('shape', [(2, 48, 48, 3), (1, 16, 16, 3),
                                   (1, 12, 20, 3)])
def test_msdssim_and_its_gradient_vs_jax(rng, shape):
    """Three scales at 48 (48, 24, 12), two at 16, one at 12 x 20."""
    from arah_tpu.utils.lpips_jax import msdssim as J
    from arah_tpu_torch.utils.lpips import msdssim as P
    a = rng.rand(*shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(*shape), 0, 1).astype(np.float32)
    jv, jg = jax.value_and_grad(lambda x: jnp.mean(J(x, jnp.asarray(b))))(
        jnp.asarray(a))
    x = torch.tensor(a, requires_grad=True)
    pv = torch.mean(P(x, torch.tensor(b)))
    pv.backward()
    assert abs(float(pv) - float(jv)) < 1e-5
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), atol=1e-5)
    np.testing.assert_allclose(P(torch.tensor(a), torch.tensor(b)).numpy(),
                               np.asarray(J(jnp.asarray(a), jnp.asarray(b))),
                               atol=1e-5)


def test_vgg_lpips_vs_jax(rng, tmp_path):
    """VGG LPIPS on a stand-in npz: distances and their gradient."""
    from arah_tpu.utils.lpips_jax import (load_lpips_params as Jload,
                                          lpips_distance as J)
    from arah_tpu_torch.utils.lpips import (load_lpips_params as Pload,
                                            lpips_distance as P)
    path = str(tmp_path / 'lpips_vgg.npz')
    np.savez(path, **_fabricate_weights(rng))
    jp, pp = Jload(path), Pload(path, device='cpu')
    a = rng.rand(2, 32, 32, 3).astype(np.float32)
    b = rng.rand(2, 32, 32, 3).astype(np.float32)
    jd = np.asarray(J(jp, jnp.asarray(a), jnp.asarray(b)))
    x = torch.tensor(a, requires_grad=True)
    pd = P(pp, x, torch.tensor(b))
    np.testing.assert_allclose(pd.detach().numpy(), jd, rtol=2e-4, atol=1e-5)
    assert (jd > 0).all()
    jg = jax.grad(lambda y: jnp.sum(J(jp, y, jnp.asarray(b))))(jnp.asarray(a))
    pd.sum().backward()
    jg = np.asarray(jg)
    assert np.abs(x.grad.numpy() - jg).max() < 1e-3 * np.abs(jg).max()
    np.testing.assert_allclose(P(pp, x, x).detach().numpy(), 0.0, atol=1e-7)


def test_metric_key_and_loss_switch_on_weights(rng, tmp_path, monkeypatch):
    """With the weights absent, the proxy under its own name; with a
    weight file at ARAH_LPIPS_WEIGHTS, 'lpips' and LPIPS as the loss,
    the same value as JAX's on the same patches."""
    from arah_tpu.utils import lpips_jax as J
    from arah_tpu_torch.utils import lpips as P
    monkeypatch.delenv('ARAH_LPIPS_WEIGHTS', raising=False)
    assert not P.lpips_available()
    assert P.metric_key() == J.metric_key() == 'lpips_proxy_msdssim'
    assert P.weights_path().endswith('arah_tpu_torch/utils/lpips_vgg.npz')
    a = rng.rand(1, 32, 32, 3).astype(np.float32)
    b = rng.rand(1, 32, 32, 3).astype(np.float32)
    proxy = float(P.make_perceptual_loss()(torch.tensor(a), torch.tensor(b)))
    path = str(tmp_path / 'w.npz')
    np.savez(path, **_fabricate_weights(rng))
    monkeypatch.setenv('ARAH_LPIPS_WEIGHTS', path)
    assert P.weights_path() == path and P.metric_key() == 'lpips'
    pv = float(P.make_perceptual_loss()(torch.tensor(a), torch.tensor(b)))
    jv = float(J.make_perceptual_loss()(jnp.asarray(a), jnp.asarray(b)))
    assert abs(pv - jv) <= 2e-4 * abs(jv) + 1e-5 and pv != proxy


def test_proxy_warning_is_jaxs_and_printed_once(monkeypatch, capsys):
    from arah_tpu.utils import lpips_jax as J
    from arah_tpu_torch.utils import lpips as P
    monkeypatch.setenv('ARAH_LPIPS_WEIGHTS', '/nonexistent/lpips_vgg.npz')
    monkeypatch.setattr(J, '_WARNED', False)
    monkeypatch.setattr(P, '_WARNED', False)
    J.make_perceptual_loss()
    jerr = capsys.readouterr().err
    P.make_perceptual_loss()
    P.make_perceptual_loss()
    perr = capsys.readouterr().err
    assert perr == jerr and perr.count('WARNING') == 1


def test_step_perceptual_patch_vs_jax():
    """Case (b): `LossWeights(perceptual=1.0, patch_size=16)`, one 16 x 16
    patch after the 48 loss rays, its mask labels 1, 100 (boundary) and 0,
    so that the RGB loss's boundary rule is on."""
    from arah_tpu.data.batch import synthetic_train_batch
    from arah_tpu.train.loss import LossWeights
    cfg = small_config(train_skinning=True)
    _, params, fd, _ = jax_scene(cfg, np.random.RandomState(0), n_rays=8)
    n_loss, ps = 48, 16
    R = n_loss + ps * ps
    batch = synthetic_train_batch(jax.random.PRNGKey(1), fd, n_blocks=1,
                                  n_rays=R, n_reg=64)
    label = np.ones((1, R), np.int32)
    label[0, n_loss + 20:n_loss + 60] = 100
    label[0, n_loss + 200:] = 0
    batch = batch._replace(body_mask=jnp.asarray(label))
    loss_w = LossWeights(n_ray_loss=n_loss, perceptual=1.0, patch_size=ps)
    key = jax.random.PRNGKey(2)
    jl, jg, jnew = jax_step(cfg, params, batch, loss_w, key, 1)
    pl, pp, before, labels = port_step(cfg, params, batch, loss_w, key, 1, R)
    check_step_vs_jax(jl, jg, jnew, pl, pp, before, labels)
    assert np.isfinite(float(pl['perceptual_loss']))
    assert float(pl['perceptual_loss']) > 0
