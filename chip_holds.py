"""Repeat `chip_smoke.py`'s holds of A-I on the CLI step's block (phase
9's FAKE-ZJU block and phase 10's H36M block, SMPL refinement on) over
fresh blocks, and count the failed checks of each. Every hold draws a
new block from the dataset, so the repeats sample the roundoff that a
single `chip_smoke.py` run meets once: a check that fails on a few of
the blocks is fragile, not a fault of a kernel.

    python3 chip_holds.py [REPEATS]     (default 6; one CUDA card)
    python3 chip_holds.py --train-repeat [TREE]

It builds the kernels, fits phase 2's scene (the nets the fixtures'
configs start from), writes both fixtures in a temporary directory and
prints each hold's lines, then a JSON object {check: failures} as its
last line. Each timed kernel and plain version runs once.

`--train-repeat` instead runs phase 9's `cli.train` (the FAKE-ZJU
fixture and config, 2 epochs from phase 2's nets) twice with the same
seed, with the `arah_tpu_torch` of TREE (by default this checkout's; say
a `git archive` of an earlier commit), and prints the loader's seconds
an item (`chip_smoke.py:loader_times`, one thread), then for both runs
the sha256 of every batch the trainer hands the step, in order, the
median ms between two such hand-offs (the step's start to the next
one's, the prefetching loader's 4 threads and the step together) and
the sha256 of the final checkpoint's parameters, then a JSON object
{"batches": the index of the first batch that differs or null,
"checkpoints_equal": bool, "ms_per_step": [run a's, run b's]} as its
last line."""
import collections
import json
import os
import sys
import tempfile
import time


def train_repeat(cs, tree):
    """The `--train-repeat` mode (`cs`: chip_smoke, imported)."""
    import hashlib
    import numpy as np
    import torch
    sys.path.insert(0, os.path.abspath(tree))
    from arah_tpu_torch.cli import train as cli_train
    from arah_tpu_torch.config.factory import get_dataset
    from arah_tpu_torch.config.loader import (default_config_path,
                                              load_config,
                                              model_config_from_cfg)
    from arah_tpu_torch.data.fake_dataset import make_fake_zju_dataset
    from arah_tpu_torch.ops import _build
    from arah_tpu_torch.scene import build_scene, flagship_config
    from arah_tpu_torch.train import trainer
    from arah_tpu_torch.utils.tree import tree_map
    import arah_tpu_torch
    print(f'arah_tpu_torch from {os.path.dirname(arah_tpu_torch.__file__)}',
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    _build.load()
    scene, _, _ = build_scene(flagship_config(), cs.RAYS, seed=0)
    digests, starts = [], []
    real = trainer.batch_to_device

    def spy(batch, device='cuda'):
        starts[-1].append(time.perf_counter())
        h = hashlib.sha256()
        tree_map(lambda a: h.update(np.ascontiguousarray(a).tobytes()),
                 batch)
        digests[-1].append(h.hexdigest()[:16])
        return real(batch, device)
    trainer.batch_to_device = spy
    ckpts, gaps = [], []
    with tempfile.TemporaryDirectory(prefix='arah_repeat_') as tmp:
        repo = os.path.dirname(os.path.abspath(__file__))
        base = os.path.join(repo, 'configs', 'fake', 'FAKE-ZJU-flagship.yaml')
        pre = cs.write_pretrained(tmp, scene, model_config_from_cfg(
            load_config(base, default_config_path())))
        data = os.path.join(tmp, 'data')
        make_fake_zju_dataset(data, n_frames=cs.CLI_FRAMES,
                              views=('1', '7'), img_size=1024)
        for run in ('a', 'b'):
            out = os.path.join(tmp, f'out_{run}')
            path = cs.cli_config(os.path.join(tmp, f'{run}.yaml'), base,
                                 data, out, pre, max_epochs=2,
                                 checkpoint_every_n_epochs=1,
                                 validate_every_n_epochs=1)
            if run == 'a':
                ds = get_dataset('train', load_config(
                    path, default_config_path()))
                item_s, dec_ms, _ = cs.loader_times(ds)
                print(f'loader: {item_s:.3f} s/item median ({len(ds)} '
                      f'items, one thread), JPEG decode {dec_ms:.1f} ms '
                      f'[{card}]', flush=True)
                del ds
            digests.append([])
            starts.append([])
            t0 = time.perf_counter()
            cli_train.main([path])
            ck = os.path.join(out, 'checkpoints')
            with open(os.path.join(ck, 'LAST')) as f:
                step = int(f.read())
            blob = torch.load(os.path.join(ck, f'step_{step:08d}',
                                           'state.pt'), weights_only=False)
            ckpts.append(cs.tree_digest(blob['params']))
            gaps.append(float(np.median(np.diff(starts[-1]))) * 1e3)
            print(f'run {run}: {time.perf_counter() - t0:.1f} s, step '
                  f'{step}, {gaps[-1]:.1f} ms/step between step starts '
                  f'(median), batches {digests[-1]}, checkpoint '
                  f'{ckpts[-1][:16]} [{card}]', flush=True)
    trainer.batch_to_device = real
    first = next((i for i, (x, y) in enumerate(zip(*digests)) if x != y),
                 None)
    print(json.dumps({'batches': first,
                      'checkpoints_equal': ckpts[0] == ckpts[1],
                      'ms_per_step': gaps}))


def main():
    import torch
    if not torch.cuda.is_available():
        print('no CUDA device: chip_holds.py runs on the GPU only',
              file=sys.stderr)
        sys.exit(2)
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    import chip_smoke as cs
    if sys.argv[1:2] == ['--train-repeat']:
        return train_repeat(cs, sys.argv[2] if len(sys.argv) > 2 else repo)
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
