"""Repeat `chip_smoke.py`'s holds of A-I on the CLI step's block (phase
9's FAKE-ZJU block and phase 10's H36M block, SMPL refinement on) over
fresh blocks, and count the failed checks of each. Every hold draws a
new block from the dataset, so the repeats sample the roundoff that a
single `chip_smoke.py` run meets once: a check that fails on a few of
the blocks is fragile, not a fault of a kernel.

    python3 chip_holds.py [REPEATS]     (default 6; one CUDA card)

It builds the kernels, fits phase 2's scene (the nets the fixtures'
configs start from), writes both fixtures in a temporary directory and
prints each hold's lines, then a JSON object {check: failures} as its
last line. Each timed kernel and plain version runs once."""
import collections
import json
import os
import sys
import tempfile
import time


def main():
    import torch
    if not torch.cuda.is_available():
        print('no CUDA device: chip_holds.py runs on the GPU only',
              file=sys.stderr)
        sys.exit(2)
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    import chip_smoke as cs
    from arah_tpu_torch.config.factory import get_dataset
    from arah_tpu_torch.config.loader import (default_config_path,
                                              load_config,
                                              model_config_from_cfg)
    from arah_tpu_torch.data.fake_dataset import (make_fake_h36m_dataset,
                                                  make_fake_zju_dataset)
    from arah_tpu_torch.ops import _build
    from arah_tpu_torch.scene import build_scene, flagship_config

    repeats = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.REPS = 1
    card = cs.card_line()
    print(f'card: {card}', flush=True)
    _build.load()
    scene, _, _ = build_scene(flagship_config(), cs.RAYS, seed=0)
    fails = collections.Counter()
    with tempfile.TemporaryDirectory(prefix='arah_holds_') as tmp:
        base = os.path.join(repo, 'configs', 'fake', 'FAKE-ZJU-flagship.yaml')
        pre = cs.write_pretrained(tmp, scene, model_config_from_cfg(
            load_config(base, default_config_path())))
        zju = os.path.join(tmp, 'zju')
        make_fake_zju_dataset(zju, n_frames=cs.CLI_FRAMES, views=('1', '7'),
                              img_size=1024)
        h36m = os.path.join(tmp, 'h36m')
        make_fake_h36m_dataset(h36m, n_frames=cs.CLI_FRAMES,
                               views=('1', '2'))
        # the configs of phase 9 and phase 10 (c)
        runs = [('cli', cs.cli_config(
            os.path.join(tmp, 'zju.yaml'), base, zju,
            os.path.join(tmp, 'out'), pre), False),
            ('cli h36m', cs.cli_config(
                os.path.join(tmp, 'h36m.yaml'), os.path.join(
                    repo, 'configs', 'arah-h36m', 'H36M_S9.yaml'), h36m,
                os.path.join(tmp, 'out_h36m'), pre, data_keys={
                    'train_views': "['1', '2']", 'val_views': "['1']",
                    'test_views': "['1']", 'num_fg_samples': 512,
                    'num_bg_samples': 512}), True)]
        for tag, path, refine in runs:
            cfg = load_config(path, default_config_path())
            ds = get_dataset('train', cfg)
            for r in range(repeats):
                cs.FAILURES.clear()
                t0 = time.perf_counter()
                cs.hold_cli_step(tag, cfg, ds, card, lambda: None,
                                 refine_smpl=refine)
                torch.cuda.empty_cache()
                fails.update(f'{tag}: {f}' for f in cs.FAILURES)
                print(f'==== {tag} block {r}: {len(cs.FAILURES)} failed, '
                      f'{time.perf_counter() - t0:.1f} s', flush=True)
    print(f'{2 * repeats} blocks [{card}]', flush=True)
    print(json.dumps(dict(fails)))


if __name__ == '__main__':
    main()
