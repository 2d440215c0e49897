"""Extract the SMPL pickle models into the npz asset layout that
`core/smpl.py:load_smpl_assets` and the datasets load.

    python -m arah_tpu_torch.preprocess.extract_smpl_parameters
        [--smpl-dir body_models/smpl] [--out-dir body_models/misc]

Reads `{smpl_dir}/{male,female,neutral}/model.pkl` (the
registration-gated SMPL downloads; a missing gender is skipped) and
writes `{out_dir}/*.npz` and `kintree_table.npy`, keeping 10 shape
directions. Port of the JAX package's script (the reference's
`extract_smpl_parameters.py:1-24`): numpy and pickle only."""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--smpl-dir', default='body_models/smpl')
    p.add_argument('--out-dir', default='body_models/misc')
    args = p.parse_args(argv)

    genders = ['male', 'female', 'neutral']
    faces = {}
    v_templates, shapedirs, posedirs, J_regressors, weights = \
        {}, {}, {}, {}, {}
    kintree = None
    for g in genders:
        path = os.path.join(args.smpl_dir, g, 'model.pkl')
        if not os.path.exists(path):
            print(f'skip {g}: {path} not found')
            continue
        with open(path, 'rb') as f:
            d = pickle.load(f, encoding='latin1')
        v_templates[g] = np.asarray(d['v_template'], np.float32)
        shapedirs[g] = np.asarray(d['shapedirs'], np.float32)[..., :10]
        posedirs[g] = np.asarray(d['posedirs'], np.float32)
        Jr = d['J_regressor']
        J_regressors[g] = np.asarray(
            Jr.toarray() if hasattr(Jr, 'toarray') else Jr, np.float32)
        weights[g] = np.asarray(d['weights'], np.float32)
        faces['faces'] = np.asarray(d['f'], np.int64)
        kintree = np.asarray(d['kintree_table'], np.int64)

    os.makedirs(args.out_dir, exist_ok=True)
    np.savez(os.path.join(args.out_dir, 'faces.npz'), **faces)
    np.savez(os.path.join(args.out_dir, 'v_templates.npz'), **v_templates)
    np.savez(os.path.join(args.out_dir, 'shapedirs_all.npz'), **shapedirs)
    np.savez(os.path.join(args.out_dir, 'posedirs_all.npz'), **posedirs)
    np.savez(os.path.join(args.out_dir, 'J_regressors.npz'), **J_regressors)
    np.savez(os.path.join(args.out_dir, 'skinning_weights_all.npz'),
             **weights)
    np.save(os.path.join(args.out_dir, 'kintree_table.npy'), kintree)
    print('wrote', args.out_dir)


if __name__ == '__main__':
    main()
