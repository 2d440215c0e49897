"""The port's sharded eval chunks (`render_frame_rays(mesh=...)` over two
gloo ranks on the CPU, `tests/torch_mp_worker.py`) against the JAX
package's mesh render (`render_frame_rays(mesh=make_mesh(2))` on two of
conftest's virtual CPU devices) of one eval item of the fake ZJU
fixture. The port's chunk is 255 rays, which it rounds to 254, a
multiple of the mesh (JAX's CLIs round an explicit chunk so before they
call it), over an odd ray count (1,681, a 41 x 41 box) that leaves the
last chunk padded.

Both ranks return the whole frame, bit for bit the same; each rank's
share of every chunk is bit-equal to a render of those rays alone on one
device; and the frame agrees with JAX's: the converged flags equal, the
colours and weights within 1e-4 (median 1e-6), the depths of converged
rays within 1e-4 of their magnitude (float roundoff of the same
solves)."""
import os

import jax
import numpy as np
import torch

from test_renderer import small_config
from test_torch_ddp import run_worker
from torch_port_util import port_cfg, port_params

torch.set_num_threads(2)

CHUNK = 255


def test_sharded_eval_vs_jax_mesh(tmp_path):
    from arah_tpu.data.fake_dataset import make_fake_zju_dataset
    from arah_tpu.data.human_video import ZJUMoCapDataset
    from arah_tpu.data.loader import frame_from_item
    from arah_tpu.eval.evaluator import render_frame_rays
    from arah_tpu.model import init_model_params
    from arah_tpu.parallel.mesh import make_mesh
    from arah_tpu_torch.data.loader import frame_from_item as pframe
    root = str(tmp_path / 'zju')
    misc, _ = make_fake_zju_dataset(root, n_frames=1, views=('1',),
                                    n_verts=256, img_size=128)
    ds = ZJUMoCapDataset(root, smpl_misc_dir=misc, subjects=('CoreView_313',),
                         mode='val', img_size=(41, 41), erode_mask=False,
                         seed=0)
    item = ds[0]
    n = len(item['inputs.ray_dirs'])
    assert n % 2 and n % (CHUNK - 1) and n > CHUNK, n
    cfg = small_config()
    params = init_model_params(jax.random.PRNGKey(0), cfg,
                               n_latent_frames=2)
    ref = render_frame_rays(params, cfg, frame_from_item(item), item,
                            params['latent'][0], chunk=CHUNK - CHUNK % 2,
                            mesh=make_mesh(2))
    pp = port_params(params)
    keys = ('inputs.ray_dirs', 'inputs.body_bounds_intersections',
            'image.cam_loc')
    case = {'cfg': port_cfg(cfg), 'params': pp,
            'fd': pframe(item, 'cpu'), 'latent': pp['latent'][0],
            'item': {k: np.asarray(item[k], np.float32) for k in keys},
            'chunk': CHUNK}
    out = run_worker('eval', case, tmp_path / 'run', nprocs=2)
    for a, b in zip(out[0]['full'], out[1]['full']):
        np.testing.assert_array_equal(a, b)
    rgb, w, d, conv = out[0]['full']
    for o in out:
        rows = o['rows']
        keep = rows < n
        for whole, alone in zip(o['full'], o['alone']):
            np.testing.assert_array_equal(alone[keep], whole[rows[keep]])
    jrgb, jw, jd, jconv = (np.asarray(a) for a in ref)
    assert rgb.shape == jrgb.shape == (n, 3)
    np.testing.assert_array_equal(conv, jconv)
    for a, b in ((rgb, jrgb), (w, jw)):
        diff = np.abs(a - b)
        assert diff.max() <= 1e-4 and np.median(diff) <= 1e-6, diff.max()
    c = jconv.astype(bool)
    assert c.any()
    np.testing.assert_allclose(d[c], jd[c], rtol=1e-4, atol=1e-6)
