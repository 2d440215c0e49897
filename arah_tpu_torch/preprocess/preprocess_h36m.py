"""Human3.6M (the Animatable-NeRF layout) into the dataset layout
`data/human_video.py:H36MDataset` reads.

    python -m arah_tpu_torch.preprocess.preprocess_h36m
        --data-dir RAW --out-dir OUT [--seqname S9]
        [--smpl-misc body_models/misc] [--device cuda|cpu]

Port of the JAX package's `preprocess/preprocess_h36m.py` (the
reference's `preprocess_datasets/preprocess_H36M.py`): as the ZJU
script, but the sequence lives under `{subject}/Posing/`, the camera
names come from `annots['ims']`, and every 5th frame is kept, up to the
subject's frame count of the Animatable-NeRF paper (`N_FRAMES`). Writes
under OUT/{seqname}/Posing."""
from __future__ import annotations

import argparse
import glob
import json
import os
import shutil

import numpy as np

N_FRAMES = {'S1': 199, 'S5': 327, 'S6': 233, 'S7': 500, 'S8': 337,
            'S9': 393, 'S11': 282}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--data-dir', required=True)
    p.add_argument('--out-dir', required=True)
    p.add_argument('--seqname', default='S9')
    p.add_argument('--smpl-misc', default='body_models/misc')
    p.add_argument('--device', default='cuda')
    args = p.parse_args(argv)

    from arah_tpu_torch.core.smpl import load_smpl_assets
    from arah_tpu_torch.parallel.distributed import pick_device
    from arah_tpu_torch.preprocess.smpl_frames import easymocap_record

    device = pick_device(args.device)
    seq = args.seqname
    data_dir = os.path.join(args.data_dir, seq, 'Posing')
    out_dir = os.path.join(args.out_dir, seq, 'Posing')
    os.makedirs(out_dir, exist_ok=True)

    model = load_smpl_assets(args.smpl_misc, 'neutral', device=device)
    annots = np.load(os.path.join(data_dir, 'annots.npy'),
                     allow_pickle=True).item()
    cams = annots['cams']
    cam_names = [im_path.split('/')[0]
                 for im_path in annots['ims'][0]['ims']]

    all_cam_params = {'all_cam_names': cam_names}
    smpl_out = os.path.join(out_dir, 'models')
    os.makedirs(smpl_out, exist_ok=True)

    for cam_idx, cam_name in enumerate(cam_names):
        all_cam_params[cam_name] = {
            'K': np.asarray(cams['K'][cam_idx]).tolist(),
            'D': np.asarray(cams['D'][cam_idx]).tolist(),
            'R': np.asarray(cams['R'][cam_idx]).tolist(),
            'T': (np.asarray(cams['T'][cam_idx]).reshape(3, 1)
                  / 1000.0).tolist()}
        cam_out = os.path.join(out_dir, cam_name)
        os.makedirs(cam_out, exist_ok=True)
        img_files = sorted(glob.glob(os.path.join(
            data_dir, cam_name, '*.jpg')))[:N_FRAMES[seq] * 5:5]
        for img_file in img_files:
            idx = int(os.path.basename(img_file)[:-4])
            smpl_file = os.path.join(data_dir, 'new_params', f'{idx}.npy')
            if not os.path.exists(smpl_file):
                continue
            if cam_idx == 0:
                rec = easymocap_record(
                    model, smpl_file, os.path.join(
                        data_dir, 'new_vertices', f'{idx}.npy'), device)
                np.savez(os.path.join(smpl_out, f'{idx:06d}.npz'), **rec)
            shutil.copy(img_file, os.path.join(cam_out, f'{idx:06d}.jpg'))
            mask_file = os.path.join(data_dir, 'mask_cihp', cam_name,
                                     os.path.basename(img_file)[:-4]
                                     + '.png')
            if os.path.exists(mask_file):
                shutil.copy(mask_file,
                            os.path.join(cam_out, f'{idx:06d}.png'))

    with open(os.path.join(out_dir, 'cam_params.json'), 'w') as f:
        json.dump(all_cam_params, f)
    print('wrote', out_dir)


if __name__ == '__main__':
    main()
