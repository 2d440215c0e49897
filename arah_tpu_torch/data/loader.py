"""Dataset items -> training batches, with background prefetching. Port
of `arah_tpu/data/loader.py`, the numpy half of the data path (the
datasets that read images are `data/human_video.py`).

Per-view items are collated into a numpy `TrainBatch` (ray blocks
stacked on the leading dimension), the final bone transforms composed as
`bone_transforms @ inv(bone_transforms_02v)`, and a thread pool prepares
the next items while the card runs a step.

Concurrency contract, as in JAX: what runs in the prefetch workers is
numpy only. The one host-to-device copy, `batch_to_device`, runs on the
consumer thread (`Prefetcher(postprocess=...)`)."""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from queue import Queue
from typing import Sequence

import numpy as np
import torch

from arah_tpu_torch.data.batch import identity_noise_np
from arah_tpu_torch.model import FrameData
from arah_tpu_torch.parallel.train_step import TrainBatch
from arah_tpu_torch.render.ray_tracing import CanonicalFrame, SmplRef
from arah_tpu_torch.utils.tree import tree_map, tree_stack


def frame_from_item_np(item: dict) -> FrameData:
    """The frame-level (view-independent) state of one dataset item, as
    numpy float32 arrays (worker-thread safe)."""
    bt = np.asarray(item['image.bone_transforms'])
    bt02v = np.asarray(item['image.bone_transforms_02v'])
    bone_transforms = (bt @ np.linalg.inv(bt02v)).astype(np.float32)
    verts = np.asarray(item['image.smpl_vertices'])

    def f32(key, shape=None):
        a = np.asarray(item[key], np.float32)
        return a.reshape(shape) if shape is not None else a

    frame = CanonicalFrame(
        bone_transforms=bone_transforms,
        trans=f32('image.trans', (3,)),
        coord_min=f32('image.coord_min'),
        coord_max=f32('image.coord_max'),
        center=f32('image.center', (3,)))
    smpl = SmplRef(verts_posed=verts.astype(np.float32),
                   skinning_weights=f32('image.skinning_weights'))
    # the item's ray bounds already hold the dataset's box margin
    return FrameData(
        frame=frame, smpl=smpl,
        verts_cano=f32('image.minimal_shape'),
        rots=f32('image.rots', (1, 24, 9)),
        rots_full=f32('image.rots_full', (1, 24, 9)),
        Jtrs=f32('image.Jtrs', (1, 24, 3)),
        Jtrs_posed=f32('image.Jtrs_posed', (1, 24, 3)),
        bounds_min=verts.min(0).astype(np.float32),
        bounds_max=verts.max(0).astype(np.float32))


def _to_device(a, device):
    """One numpy leaf as a tensor on `device`, with JAX's default dtypes
    (64-bit floats and integers become 32-bit)."""
    a = np.asarray(a)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.int64:
        a = a.astype(np.int32)
    return torch.as_tensor(a).to(device)


def frame_from_item(item: dict, device='cuda') -> FrameData:
    """`frame_from_item_np`, moved to `device` (consumer-thread use)."""
    return batch_to_device(frame_from_item_np(item), device)


def batch_to_device(batch, device='cuda'):
    """One host-to-device copy of a numpy batch tree (a `TrainBatch`,
    a `FrameData`, ...). Call it from the consumer thread."""
    return tree_map(lambda a: _to_device(a, device), batch)


def collate_train_batch_np(items: Sequence[dict],
                           noise: dict | None = None,
                           per_block_frame: bool = False) -> TrainBatch:
    """Per-view items stacked into a numpy TrainBatch (worker-thread
    safe). per_block_frame=False: every item is a view of the SAME frame;
    the frame state comes from items[0]. per_block_frame=True: each item
    may be another frame; the frame leaves and latent_idx are stacked per
    block (for `make_train_step(per_block_frame=True)`)."""
    B = len(items)

    def stack(key):
        return np.stack([np.asarray(it[key]) for it in items])

    if per_block_frame:
        fd = tree_stack([frame_from_item_np(it) for it in items], np.stack)
        latent_idx = np.asarray(
            [int(it['inputs.data_idx']) for it in items], np.int32)
    else:
        fd = frame_from_item_np(items[0])
        latent_idx = np.int32(items[0]['inputs.data_idx'])
    bounds = stack('inputs.body_bounds_intersections')
    n = noise if noise is not None else identity_noise_np(B)
    mask_raw = np.stack(
        [np.asarray(it['inputs.mask_erode']).astype(np.int32)
         for it in items])
    return TrainBatch(
        cam_loc=stack('image.cam_loc'),
        ray_dirs=stack('inputs.ray_dirs'),
        near=bounds[..., 0], far=bounds[..., 1],
        rgb_gt=stack('inputs'), body_mask=mask_raw,
        points_uniform=stack('image.points_uniform'),
        points_skinning=stack('image.points_skinning'),
        points_inside=stack('image.points_inside')
        if 'image.points_inside' in items[0] else
        np.zeros((B, 1, 3), np.float32),
        sampled_weights=stack('image.sampled_weights'),
        rots_noise=np.asarray(n['rots_noise']),
        view_noise=np.asarray(n['view_noise']),
        rot_noise=np.asarray(n['rot_noise']),
        trans_noise=np.asarray(n['trans_noise']),
        uv=stack('inputs.uv'),
        cam_idx=np.array([int(it['inputs.cam_idx']) for it in items],
                         np.int32),
        frame=fd,
        latent_idx=latent_idx)


def collate_train_batch(items: Sequence[dict], noise: dict | None = None,
                        device='cuda') -> TrainBatch:
    """The numpy collate and the copy to `device` (main-thread use)."""
    return batch_to_device(collate_train_batch_np(items, noise), device)


class FrameBatchSampler:
    """Iterates frames; yields the item indices of all views of one
    frame (the reference's one frame a step).

    With `num_shards > 1` every process iterates the SAME frame order
    (shared seed) and trains on its own round-robin share of each frame's
    views, padded to equal size. `block_multiple` pads each step's view
    list (cycling through the views) to the next multiple of the local
    device count: the dataset draws fresh rays on every `__getitem__`, so
    a repeated view is an independent ray block."""

    def __init__(self, dataset, shuffle=True, seed=0, shard_id: int = 0,
                 num_shards: int = 1, block_multiple: int = 1):
        self.dataset = dataset
        self.shuffle = shuffle
        self.block_multiple = max(1, block_multiple)
        self.rng = np.random.RandomState(seed)
        by_frame = {}
        for i, rec in enumerate(dataset.data):
            by_frame.setdefault(rec['frame_idx'], []).append(i)
        if num_shards > 1:
            sharded = {}
            for f, idxs in by_frame.items():
                n_per = max(1, -(-len(idxs) // num_shards))
                sharded[f] = [idxs[(shard_id + k * num_shards) % len(idxs)]
                              for k in range(n_per)]
            by_frame = sharded
        self.frames = sorted(by_frame)
        self.by_frame = by_frame

    def __len__(self):
        return len(self.frames)

    def __iter__(self):
        order = list(self.frames)
        if self.shuffle:
            self.rng.shuffle(order)
        for f in order:
            idxs = self.by_frame[f]
            m = self.block_multiple
            if len(idxs) % m:
                n = -(-len(idxs) // m) * m
                idxs = [idxs[k % len(idxs)] for k in range(n)]
            yield idxs


class MultiFrameBatchSampler:
    """Independent (frame, view) draws a step, the per-block-frame
    mode's sampler: `batch_size` item indices a step from a shuffled
    epoch permutation of all items (wrapping within the epoch), so every
    item is visited about once an epoch. Several processes take
    rank-disjoint strided slices of the same shared-seed permutation and
    step the same count an epoch."""

    def __init__(self, dataset, batch_size: int, shuffle=True, seed=0,
                 shard_id: int = 0, num_shards: int = 1):
        self.dataset = dataset
        self.batch_size = max(1, batch_size)
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.shard_id = shard_id
        self.num_shards = max(1, num_shards)
        self.n_items = len(dataset.data)

    def __len__(self):
        local = len(range(self.shard_id, self.n_items, self.num_shards))
        return max(1, local // self.batch_size)

    def __iter__(self):
        order = np.arange(self.n_items)
        if self.shuffle:
            self.rng.shuffle(order)
        local = order[self.shard_id::self.num_shards]
        for s in range(len(self)):
            yield [int(local[(s * self.batch_size + k) % len(local)])
                   for k in range(self.batch_size)]


class Prefetcher:
    """Thread-pool prefetch of collated batches. `collate` runs on the
    pool's threads and must be numpy only; the optional `postprocess`
    (e.g. `batch_to_device`) runs on the consumer thread."""

    def __init__(self, dataset, sampler, collate, n_workers=4, depth=2,
                 postprocess=None):
        self.dataset = dataset
        self.sampler = sampler
        self.collate = collate
        self.postprocess = postprocess
        self.pool = ThreadPoolExecutor(n_workers)
        self.depth = depth

    def _make(self, idxs):
        # the items of one batch load serially; `depth` batches are in
        # flight (a pool task that maps on its own pool can deadlock)
        return self.collate([self.dataset[i] for i in idxs])

    def __iter__(self):
        pending = Queue()
        it = iter(self.sampler)
        done = threading.Event()

        def submit_all():
            for idxs in it:
                while pending.qsize() >= self.depth and not done.is_set():
                    done.wait(0.005)
                if done.is_set():
                    return
                pending.put(self.pool.submit(self._make, idxs))
            pending.put(None)

        t = threading.Thread(target=submit_all, daemon=True)
        t.start()
        try:
            while True:
                fut = pending.get()
                if fut is None:
                    break
                batch = fut.result()
                if self.postprocess is not None:
                    batch = self.postprocess(batch)
                yield batch
        finally:
            done.set()
            # no worker touches the dataset after the consumer stops:
            # queued work is cancelled, items in flight finish
            while not pending.empty():
                fut = pending.get_nowait()
                if fut is not None:
                    fut.cancel()
            t.join(timeout=5.0)

    def close(self):
        """Stop all workers; waits for items in flight. Safe to call more
        than once."""
        self.pool.shutdown(wait=True, cancel_futures=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
