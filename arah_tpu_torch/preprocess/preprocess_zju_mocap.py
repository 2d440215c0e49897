"""Raw ZJU-MoCap into the dataset layout `data/human_video.py:
ZJUMoCapDataset` reads.

    python -m arah_tpu_torch.preprocess.preprocess_zju_mocap
        --data-dir RAW --out-dir OUT [--seqname CoreView_313]
        [--smpl-misc body_models/misc] [--device cuda|cpu]

Port of the JAX package's `preprocess/preprocess_zju_mocap.py` (the
reference's `preprocess_datasets/preprocess_ZJU-MoCap.py`): the cameras
of `annots.npy` (T in mm -> m; CoreView_313 and 315 have cameras 1-19,
22 and 23, the others 1-23) into `cam_params.json`; per frame with
EasyMocap parameters (`new_params/{idx}.npy`), the npz record
(`preprocess/smpl_frames.py`, the translation refitted against
`new_vertices/{idx}.npy`) into `models/{idx:06d}.npz`, posed on
`--device`; each camera's JPEG and mask PNG copied to
`{cam}/{idx:06d}.jpg|png`. Writes under OUT/{seqname}."""
from __future__ import annotations

import argparse
import glob
import json
import os
import shutil

import numpy as np

ZJU_21 = ('CoreView_313', 'CoreView_315')


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--data-dir', required=True)
    p.add_argument('--out-dir', required=True)
    p.add_argument('--seqname', default='CoreView_313')
    p.add_argument('--smpl-misc', default='body_models/misc')
    p.add_argument('--device', default='cuda')
    args = p.parse_args(argv)

    from arah_tpu_torch.core.smpl import load_smpl_assets
    from arah_tpu_torch.parallel.distributed import pick_device
    from arah_tpu_torch.preprocess.smpl_frames import easymocap_record

    device = pick_device(args.device)
    seq = args.seqname
    data_dir = os.path.join(args.data_dir, seq)
    out_dir = os.path.join(args.out_dir, seq)
    os.makedirs(out_dir, exist_ok=True)

    model = load_smpl_assets(args.smpl_misc, 'neutral', device=device)
    annots = np.load(os.path.join(data_dir, 'annots.npy'),
                     allow_pickle=True).item()
    cams = annots['cams']

    if seq in ZJU_21:
        cam_names = [str(c) for c in list(range(1, 20)) + [22, 23]]
    else:
        cam_names = [str(c) for c in range(1, 24)]

    all_cam_params = {'all_cam_names': cam_names}
    smpl_out = os.path.join(out_dir, 'models')
    os.makedirs(smpl_out, exist_ok=True)

    for cam_idx, cam_name in enumerate(cam_names):
        K = np.asarray(cams['K'][cam_idx]).tolist()
        D = np.asarray(cams['D'][cam_idx]).tolist()
        R = np.asarray(cams['R'][cam_idx]).tolist()
        T = (np.asarray(cams['T'][cam_idx]).reshape(3, 1) / 1000.0).tolist()
        all_cam_params[cam_name] = {'K': K, 'D': D, 'R': R, 'T': T}

        cam_out = os.path.join(out_dir, cam_name)
        os.makedirs(cam_out, exist_ok=True)
        if seq in ZJU_21:
            img_dir = os.path.join(data_dir, f'Camera ({cam_name})')
            mask_dir = os.path.join(data_dir,
                                    f'mask_cihp/Camera ({cam_name})')
        else:
            img_dir = os.path.join(data_dir, f'Camera_B{cam_name}')
            mask_dir = os.path.join(data_dir, f'mask_cihp/Camera_B{cam_name}')

        for img_file in sorted(glob.glob(os.path.join(img_dir, '*.jpg'))):
            base = os.path.basename(img_file)
            idx = int(base.split('_')[4]) if seq in ZJU_21 \
                else int(base[:-4])
            smpl_file = os.path.join(data_dir, 'new_params', f'{idx}.npy')
            if not os.path.exists(smpl_file):
                continue
            if cam_idx == 0:
                rec = easymocap_record(
                    model, smpl_file, os.path.join(
                        data_dir, 'new_vertices', f'{idx}.npy'), device)
                np.savez(os.path.join(smpl_out, f'{idx:06d}.npz'), **rec)

            shutil.copy(img_file, os.path.join(cam_out, f'{idx:06d}.jpg'))
            mask_file = os.path.join(mask_dir, base[:-4] + '.png')
            if os.path.exists(mask_file):
                shutil.copy(mask_file,
                            os.path.join(cam_out, f'{idx:06d}.png'))

    with open(os.path.join(out_dir, 'cam_params.json'), 'w') as f:
        json.dump(all_cam_params, f)
    print('wrote', out_dir)


if __name__ == '__main__':
    main()
