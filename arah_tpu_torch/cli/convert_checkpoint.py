"""Convert a trained reference (ARAH Lightning) checkpoint into the port's
checkpoint.

    python -m arah_tpu_torch.cli.convert_checkpoint --config CONFIG
        --torch-ckpt last.ckpt --out-dir OUT/checkpoints

The contract of the JAX package's `convert_checkpoint.py`: the config
(over `configs/default.yaml`) gives the model's shapes; the reference's
`state_dict` loses its `model.` prefix and goes through
`train/checkpoints.py:convert_model_state_dict`; the parameters alone are
saved as step 0 (`OUT/checkpoints/step_00000000/state.pt`, `LAST`). With
OUT the config's `training.out_dir`, `cli.validate` and `cli.test` restore
it as they restore a trained checkpoint (parameters only: their optimizer
state and step keep their initial values) and put it on their device.
The conversion is host work: it names no device. Pretrained MetaAvatar
and SNARF checkpoints are converted at train start by the factory
(`config/factory.py`), not here."""
from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--config', required=True)
    p.add_argument('--torch-ckpt', required=True)
    p.add_argument('--out-dir', required=True)
    args = p.parse_args(argv)

    from arah_tpu_torch.config.loader import (default_config_path,
                                              load_config,
                                              model_config_from_cfg)
    from arah_tpu_torch.train import checkpoints as ckpt_lib

    cfg = load_config(args.config, default_config_path())
    model_cfg = model_config_from_cfg(cfg)

    sd = ckpt_lib.load_torch_checkpoint(args.torch_ckpt)
    sd = ckpt_lib.strip_prefix(sd, 'model.')
    params = ckpt_lib.convert_model_state_dict(sd, model_cfg)

    os.makedirs(args.out_dir, exist_ok=True)
    path = ckpt_lib.save_checkpoint(args.out_dir, 0, {'params': params})
    print('wrote', path)


if __name__ == '__main__':
    main()
