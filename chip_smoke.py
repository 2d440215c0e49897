#!/usr/bin/env python3
"""Chip smoke run of arah_tpu_torch on one NVIDIA GPU (written for H100).

    python3 chip_smoke.py

1. Builds the CUDA kernels from `arah_tpu_torch/csrc/` (first use, into
   `.cache/torch_ext/`) and prints the build time and each kernel's
   registers, spills and shared memory as ptxas reports them (the kernels
   on `csrc/stream_mlp.cuh`, E, F, B/L and J, A/K's nearest-vertex
   body and the iso init, one symbol a launch shape, must all be there
   and none may spill).
2. Builds the flagship bench scene (`scene.build_scene(pretrain=True)`:
   SIREN and skinning net fitted to the capsule body) and prints the
   fit's time and its loss at a fresh batch against the random init's.
3. Holds each kernel against its plain PyTorch version on the card, at
   the shapes of the flagship eval (8192 rays; 8192 x 64 = 524,288
   points), and times both: E march and F iso at their phase-1 shapes
   (8192 rays, 16 iterations) and phase-2 shapes (the stragglers: E
   resumed for 34 iterations, F from scratch at 50 steps), the iso init
   (F's J_inv0, one launch a solve) beside F and on its own at the eval's
   phase-1 chunks of 16,384 and 32,768 rays and at phase 2, held row by
   row by condition number, bit-equal at every launch shape, and F from
   its J_inv0 held to F's floors (`check_iso_init`); A knn (its
   indices equal to the plain version's at every point; every launch
   shape of A/K's body, each with the plain version's indices, timed at
   524,288 points and strided subsets of them down to 256; the tie case
   of duplicated vertices at every size, launch shape and wrapper; the SM
   clock while A runs, for its lane-instructions a pair), B corr
   (its `active` set too; at phase 1, on phase 1's stragglers, through
   the straggler split and at the phase-2 shape; each with its per-point
   iteration counts against the plain solve's, at every launch shape
   with the same bits, and the tile waste of the tile design; the
   stragglers held by roots and by floors from a float64 witness; the
   256-wide launch shape on the fitted net zero-padded to 256 units, with
   the 128-wide net's bits), C shade
   (at both precisions, called twice: the same bits),
   D color_fwd (f32, and bf16 on bf16 and on f32 features, each called
   twice: the same bits; timed with its operands packed outside the timed
   region, the wrapper's time printed beside it).
4. Drives the port's main path: `render(training=False)` of the flagship
   scene for 3 frames of different poses, with the kernel launch counts
   set to 0 just before and read just after; traces one frame with
   torch.profiler (device time by kernel, the device's idle share);
   renders with the kernels and with the plain versions (splits off on
   both sides), in turns, and compares the two; and renders with the
   kernels with the splits on and off, in turns (the split A/B).
5. The tracer's unfused A/B path: holds J (siren) against its plain
   version at the 8,192 surface points and the 524,288 sample points of
   a flagship frame (every launch shape with the same bits there and at
   1,024 and 256 points), K (knn_rows) at the world points of both (and
   every launch shape there and at 1,024 and 256 of them), and L
   (corr_rows) against its plain version and against B on the frame's
   corr inputs; renders 3 frames with `ARAH_ENABLE_PALLAS=1` and the
   march, iso and corr-init kernel flags off (counted, so that J and K
   and not E, F or A run; one frame traced), compares that render with
   its switch-off twin (in turns, timed) and with the flagship render,
   and prints J's and K's launches over the 3 frames by batch size, with
   their device time; then runs the corr-variant bench
   (`utils/bench_corr.main`, 262,144 points), counted, for L, and holds L
   and B against the bench's
   plain solve on the bench's own inputs, L with its iteration counts and
   launch shapes (L's record comes from those inputs).
6. Drives the train step (`scene.build_train_setup`: the flagship step of
   the JAX bench, one block of 8192 rays and 1,024 regulariser points).
   A warm-up step captures the inputs and cotangents the step hands
   kernels G (skin_jac), H (shade_bwd: the shading at N points in bf16
   and the eikonal at 1,024 points in f32) and I (color_bwd, in bf16 and
   in f32); each is held against its plain version on them and timed,
   and G, H and I must each give the same bits on two calls. Then the main
   path of this phase: one step with the launch counts set to 0 just
   before and read just after, then timed steps; one profiled step; and
   one step with every kernel against one with every plain path (splits
   off on both sides) from the same state, batch and draws.
7. Drives the refined step, the H36M configs' SMPL refinement
   (`train_smpl: true`) with every other option of the step on as well
   (`scene.build_train_setup(..., refined=True)`): 2 blocks, each on its
   own pose of the bench body, of 8192 loss rays and one 48 x 48 patch
   of rays drawn as the dataset draws it (around a random body vertex,
   its rays kept whether or not they meet the box), SMPL and camera
   refinement, the perceptual loss on its DSSIM proxy. A warm-up step,
   whose first block hands A-F 10,496 rays and 671,744 samples and G, H
   and I 671,744 points: each kernel is held against its plain version
   there by step 3's and step 6's checks (A and every launch shape of
   its body; B at both phases, through the split and at 256 units; C on
   the shading and eikonal calls; D; E and F at both phases, F on every
   ray as the training path runs it) and G's time is printed; one step
   with the launch counts set to 0 just before and read just after (A-I
   each at twice the counts of step 6's one-block step); timed steps;
   one profiled step; one step with each patch re-centred on the top
   corner of its frame's box, so that many of its rays miss the box,
   whose loss and gradients must stay finite; and one step with every
   kernel against one with every plain path (splits off on both sides)
   from the same state, batch and draws, which also holds the
   refinement leaves' gradients.
8. The options, at flagship width on the bench scene, each against its
   default or its plain version: `shade_resid_bf16` (C and H with bf16
   residents against their plain versions at the step's inputs, C's SDF
   and features bit-equal to its f32-resident launch, C's normals and H's
   dx at least 10x nearer the plain version with the flag than without
   it; the step and an eval frame against the default; their times and
   peak memory), `shade_pack`
   (the eval frame and the step packed against dense; G, C, H, D and I
   against their plain versions at the K packed rows; both timed in
   turns), `idiff_kernel_jac` (B with its J against its plain version and
   its J against G's at phase 1 and phase 2 of an eval frame; B's time
   with and without J; the step against the default, with G not
   launched), `pallas_precision` 'split3' and 'bf16' (B against its plain
   version at the same precision at both phases, bf16 at cvg 5e-3, and
   at phase 1 against the plain f32 solve, to show that it follows its
   own precision; B with J at each precision against its plain version
   and timed beside its bound; an eval frame at each precision,
   counted, split3's held by the render gate), and `single_bvp` (the
   bench pose's
   generated SIREN with its FiLM folded into a plain SIREN: an eval
   frame against the hypernet frame by the render gate, E and F on it, a
   step on every kernel with C and H held against their plain versions
   without FiLM, and against its plain-path twin).
9. Drives the CLIs, the port's normal entry points, on the fake ZJU
   dataset (`run_clis`): writes the fixture with the port's writer (4
   frames, views 1 and 7, 1024 x 1024 JPEGs and PNG masks); writes a
   config that inherits `configs/fake/FAKE-ZJU-flagship.yaml` (2 epochs,
   a checkpoint and a validation each epoch, the phase-2 fitted SIREN and
   skinning net given as pretrained MetaAvatar and SNARF checkpoints, so
   that the avatar has a surface); runs `cli.train.main` in this process
   with the launch counts set to 0 just before and read just after (A-I
   each launched, no plain version called: every one is spied on),
   checks its files and that every logged loss is finite, and prints its
   checkpoint's sha256 (the run repeats: one seed, one digest); reruns it for
   a third epoch (it must print "resumed from step N"); runs it as a
   subprocess with `--exit-after 1 --epochs-per-run 50` (exit code 2);
   runs `cli.validate.main([... '--novel-view'])` counted (A-F launched,
   a finite psnr, ssim and perceptual metric in `metrics.json`); holds
   A-F against their plain versions on what `evaluate_frame` hands them
   on the validation's first frame and the trained checkpoint, its
   first chunk (the eval chunk, 32,768 rays, with the eval path's mask),
   as phase 7 does on a block, except that E's and F's flags and
   iteration counts are held to floors that the same plain solves in
   float64 set (`witness_floor`: at a trained checkpoint roundoff sets
   which grazing rays finish); prints the CLI layer's times (ms/step
   between step starts, the loader's seconds per item with its JPEG
   decode, validation seconds per frame on the checkpoint, peak memory);
   and holds A-I against their plain versions on what a warm-up step of
   the CLI's own batch (2 blocks x 1,024 rays) hands them, as phase 7
   does, then times and traces that step.
10. Drives the novel-pose test CLI and the H36M and People-Snapshot
   readers: (a) `cli.test.main` on phase 9's checkpoint, with the
   fixture's own SMPL sequence as the novel poses, its first 2 frames
   (`--end-frame 2`) at `--mesh-res 256`, counted (A-F launched, J 64
   times a frame, no plain version called);
   its PNGs and `vis.mp4` (the boxes parse, each sample decodes to the
   frame's PNGs as `write_jpeg` encodes them); the seconds a frame by
   part (render, grid, marching cubes, skinning, rasterizing, writing)
   and peak memory; a `--free-viewpoint 4 --end-frame 2` run, held to
   what ROADMAP's recorded fault predicts for one camera (every spiral
   matrix NaN, the rgb and posed normal PNGs blank, the canonical ones
   drawn). (b) `mesh_check`: J against its plain version on frame 0's
   grid, chunk by chunk (262,144 points, timed), and the meshes of the
   kernel's and the plain grid (every second sample an axis, 128^3: the
   checkpoint's mesh at 256^3 has tens of millions of faces, ~35 s of
   marching cubes each on the host): faces within 0.5%, the posed normal
   maps' foreground agreeing on >= 0.99 of the pixels. The trained
   checkpoint's SIREN crosses zero all through the grid (tens of
   millions of faces), so `mesh_check` also runs on a body-sized
   surface, phase 2's fitted SIREN at the bench pose under the bench
   camera, after one timed frame of its mesh path by part (grid,
   marching cubes, skinning, rasterizing). (c) The H36M fixture (2 views
   at 1002 x 1000, 4 frames) and a config inheriting
   `configs/arah-h36m/H36M_S9.yaml`: `cli.train` for one epoch, counted
   (A-I launched, no plain version called, the SMPL leaves moved, finite
   losses), `cli.validate
   --novel-view` (finite metrics), A-I against their plain versions on
   that CLI step's block (B's stragglers by `straggler_count_ok`), the
   ms/step and the loader's s/item with its 1002 x 1000 JPEG decode. (d)
   The People-Snapshot fixture with a distorted camera (camera_k -0.2,
   0.05) and a config inheriting
   `configs/arah-people-snapshot/male-3-casual.yaml`: `cli.train` for
   one epoch, counted, and the loader's s/item with its undistortion.

11. Drives data parallelism over torch.distributed (`run_ddp`): (a) the
   flagship step sharded over 2 gloo ranks that share the card (rank
   processes `python3 chip_smoke.py --rank ...`, which load the built
   kernels and neither build nor fit): phase 2's fitted parameters, a
   2-block batch (8,192 rays and 1,024 regulariser points a block) and 2
   steps' draws go to them through a file; each rank takes its block, 2
   steps, the first counted (A-I launched, no plain version called);
   rank 0's all-reduced gradient and mean losses against this process's
   2-block step from the same state, batch and draws (losses within
   1e-5, every leaf's cosine >= 0.9999); after 2 steps the ranks'
   parameters bit-equal; ms/step, the all-reduce's ms (gloo through the
   host, not NCCL's cost) and peak memory a rank. (b) One NCCL rank:
   `make_train_step(mesh=make_mesh())` at world size 1, bit-equal to
   mesh=None, and the NCCL all-reduce's time for the flat gradient
   buffer. (c) The flagship frame's 8,192 rays through
   `render_frame_rays(mesh=)` on 2 gloo ranks, counted (A-F): each
   rank's slice bit-equal to its rays rendered alone at the same size,
   the frame against this process's render (converged-flag agreement >
   0.98, rgb median |d| < 1e-2, depth median |d| < 1e-4). (d) The CLIs
   as 2 rank processes with the manual flags (`--device cuda:0
   --dist-backend gloo`) on phase 9's fixture: `cli.train` one epoch
   (each rank's A-I launched, no plain version; one checkpoint, one
   `META.json`, finite losses), `cli.validate --novel-view` (its
   `metrics.json` equal to one process's on the same checkpoint),
   `cli.test` on 2 frames at `--mesh-res 64` (every PNG, `vis.mp4`
   parsed).
12. Runs the real-data parity runbook on the card (`run_parity`, ~10 s):
   writes a raw ZJU-MoCap tree (`make_fake_raw_zju`: 4 frames, views 1
   and 7, 1024 x 1024, the bench body) and a raw H36M tree (10 frames, 2
   views, 1002 x 1000); runs `preprocess_zju_mocap` and `preprocess_h36m`
   with `--device cuda` and `--device cpu` (the same files, JSON and
   images byte-equal, npz fields within 1e-5; s/frame on each);
   `extract_smpl_parameters` on SMPL pickles of the fixture's body (the
   extracted model poses as the fixture's within 1e-5) and
   `preprocess_aist` on a 6-pose motion (`ODPDataset` loads 3 finite
   frames); builds a reference Lightning checkpoint at
   FAKE-ZJU-flagship's shapes (`reference_state_dict`) and runs
   `cli.convert_checkpoint` on it (the restored tree bit-equal to the
   in-process conversion); then `cli.validate --novel-view --device
   cuda` from that checkpoint on the preprocessed ZJU tree, counted (A-F
   launched, no plain version), its rgb PNG byte-equal to an in-process
   `evaluate_frame` and `save_image` of the same item; prints preprocess
   s/frame on cuda and cpu, convert s, validate s/frame and A-F's
   launches.

Prints the card (`nvidia-smi`), a `{"kernels": [...]}` line (A-I also
carry `launches_cli_train` and `launches_cli_h36m`, phase 9's and phase
10's train counts, and `launches_ddp`, each rank's in phase 11's counted
sharded step; A-F `launches_parity`, phase 12's validation from the
converted checkpoint; A-F and J `launches_cli_test`; J its grid time as
`grid_ms`, `grid_plain_ms`, `grid_bound_ms`), and as its last line
`{"ok": true, "device": {...}}`. Any failed check exits
non-zero before those lines. Without a CUDA device it exits non-zero.
"""
import contextlib
import json
import os
import subprocess
import sys
import time

PEAK_F32 = 67e12        # H100 SXM, f32 outside the tensor cores (flop/s)
PEAK_BF16 = 989e12      # H100 SXM, dense bf16 tensor cores (flop/s)
PEAK_BYTES = 3.35e12    # H100 SXM HBM3 (B/s)
RAYS = 8192             # rays per frame: N = 524,288 (ray, sample) points
FRAMES = 3              # main-path frames, each with its own pose
REPS = 5                # timed repeats of each kernel and plain version
STEPS = 4               # timed train steps after the counted one
BENCH_POINTS = 262144   # the corr-variant bench (L's path)

FAILURES = []
# the kernels of the flagship train step (A-I); J, K and L run elsewhere
TRAIN_KERNELS = ('knn', 'corr', 'shade', 'color_fwd', 'march', 'iso',
                 'skin_jac', 'shade_bwd', 'color_bwd', 'iso_init')
# J against its plain version, absolute: the JAX package's bound for the
# Pallas SIREN (tests/test_pallas.py:28)
J_TOL = 1e-5


def check(ok, msg):
    """Record a failed check; the run goes on to report the other phases
    and exits non-zero at the end, before the result lines."""
    if not ok:
        FAILURES.append(msg)
        print(f'FAILED: {msg}', flush=True)


def timed(fn, reps):
    """Device ms per call of fn (CUDA events around `reps` calls, after
    one warm-up call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def graph_ms(fn, reps):
    """Device ms per call of fn from a CUDA graph of `reps` calls (captured
    after one warm-up call) replayed between CUDA events: the launches
    back to back, without the host's time between them, which `timed`
    counts where a launch takes less time on the card than its host
    side."""
    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    g.replay()
    e.record()
    torch.cuda.synchronize()
    del g
    return s.elapsed_time(e) / reps


def sm_clock(fn, seconds=2.0):
    """Median SM clock (MHz) that nvidia-smi reads while fn runs over and
    over for `seconds`; None where nvidia-smi reads none."""
    import torch
    try:
        smi = subprocess.Popen(['nvidia-smi', '--query-gpu=clocks.sm',
                                '--format=csv,noheader,nounits', '-lms',
                                '100'], stdout=subprocess.PIPE, text=True)
    except OSError:
        return None
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    smi.terminate()
    out = smi.communicate()[0]
    mhz = sorted(float(v) for v in out.split() if v.replace('.', '').isdigit())
    return mhz[len(mhz) // 2] if mhz else None


def bound(nbytes, flops, peak):
    """(least ms, 'bytes' or 'operations') of work on the H100."""
    tb, to = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    return (tb, 'bytes') if tb >= to else (to, 'operations')


def q(a, p):
    import torch
    return float(torch.quantile(a.float().flatten()[:1 << 24], p))


def shape_line(kernel, shape, n):
    """The launch shape kernel E ('march'), F ('iso'), B/L ('corr') or J
    ('siren') takes for n rays: blocks, cluster size, rays a CTA, shared
    memory and CTAs an SM."""
    from arah_tpu_torch.ops.march import tile_shape
    d = tile_shape(kernel, shape, n)
    return (f'launch shape {shape}: {d["blocks"]} CTAs, cluster '
            f'{d["cluster"]}, R = {d["rays"]} ray slots, {d["smem"]} B '
            f'dynamic shared memory a CTA, {d["per_sm"]} CTAs an SM')


def shape_sweep(tag, kernel, n, launch, ref, card, shapes=(0, 1)):
    """A kernel of csrc/stream_mlp.cuh (E 'march', F 'iso', B/L 'corr',
    J 'siren') at each of its launch shapes on one input: launch(shape) ->
    outputs; each must give the bits of ref (the wrapper's launch), and
    its time is printed. A launch that fails fails the run."""
    import torch
    from arah_tpu_torch.ops.march import tile_shape
    times, same = [], True
    for sh in shapes:
        d = tile_shape(kernel, sh, n)
        try:
            out = launch(sh)
        except RuntimeError as e:
            check(False, f'{tag}: launch shape {sh} failed: {e}')
            continue
        same &= all(torch.equal(x, y) for x, y in zip(out, ref))
        times.append(f'{sh}: {d["rays"]} rays x {d["cluster"]} CTAs '
                     f'{timed(lambda: launch(sh), 3):.3f} ms')
    print(f'  {tag} at its launch shapes: ' + ', '.join(times)
          + f'; bit-equal {same} [{card}]', flush=True)
    check(same, f'{tag}: the launch shapes give different bits')


def f64(x):
    """x with every floating tensor in float64 (a tensor, or tuples,
    named tuples and lists of them)."""
    import torch
    if torch.is_tensor(x):
        return x.double() if x.is_floating_point() else x
    if isinstance(x, tuple):
        vals = [f64(v) for v in x]
        return type(x)(*vals) if hasattr(x, '_fields') else tuple(vals)
    if isinstance(x, list):
        return [f64(v) for v in x]
    return x


def straggler_count_ok(k, d):
    """B's straggler test: the kernel flips the valid flag of k points
    against the plain float32 solve, where the same plain solve in
    float64 (the witness) flips d. Each of the two roundoffs flips about
    d, so k is about 2 d; the counts are Poisson-like, so the test allows
    three standard deviations on top: k <= 2 d + 3 sqrt(k + 4 d)."""
    return k <= 2 * d + 3 * (k + 4 * d) ** 0.5


def agreement_floor(n, rate=0.01):
    """The usual floor of a kernel's per-ray agreement with its plain
    version on a flag or an iteration count, over n rays, as a count: k
    rays may differ where k <= rate n + 3 sqrt(rate n), a 1% rate plus
    three standard deviations of a Poisson count (the margin that
    `straggler_count_ok` takes). A bare 0.99 lets no ray differ below
    n = 100, where one ray a step off at a roundoff-set stopping step
    fails a correct kernel. Returns the floor (n - that count) / n."""
    if n <= 0:
        return 0.0
    m = rate * n
    return max(0.0, (n - m - 3 * m ** 0.5) / n)


def witness_floor(differ):
    """The floor of a kernel's agreement with its plain version on a flag,
    a count or a root, where the same plain solve in float64 (the witness)
    shows how far roundoff sets it: `differ` (bool, one a ray) marks the
    rays where the witness departs from the float32 plain version. The
    usual `agreement_floor`, or, where the witness departs on d of the n
    rays, 1 - 2 d / n if lower (E's and F's rule; B's stragglers take
    `straggler_count_ok`). Returns (floor, d)."""
    d, n = int(differ.sum()), differ.numel()
    # (n - 2 d) / n, one rounding as the agreement (n - k) / n has: at
    # k = 2 d the two are equal
    return max(0.0, min(agreement_floor(n), (n - 2 * d) / max(n, 1))), d


def iters_check(tag, it_k, it_p, held=None, why='', gate=True, it_w=None):
    """The kernel's per-ray iteration counts (iters_out) against the plain
    version's: equal on `agreement_floor` of the rays (a flip may
    differ), or of the rays `held` (a bool mask, for the reason `why`)
    where a solve's stopping step is set by roundoff; the share over all
    rays is printed beside it. With `gate` False the shares are printed
    only. With the float64 witness's counts `it_w` the floor is
    `witness_floor`'s."""
    same = it_k == it_p
    agree = float(same.double().mean()) if it_k.numel() else 1.0
    msg = (f'  {tag}: iterations executed {int(it_k.sum())} (kernel, per-ray '
           f'counts), needed {int(it_p.sum())} (plain); per-ray agreement '
           f'{agree:.6f}')
    if held is not None:
        agree = float(same[held].double().mean()) if bool(held.any()) else 1.0
        msg += (f' over all rays; {agree:.6f} over the {int(held.sum())} '
                f'rays {why}')
    floor = agreement_floor(int(it_k.numel() if held is None
                                else held.sum()))
    if it_w is not None:
        floor, d = witness_floor(
            (it_w != it_p) if held is None else (it_w != it_p)[held])
        msg += f'; the float64 witness\'s counts differ on {d} of those rays'
    print(msg + (f' (bound >= {floor:.6f})' if gate else ' (not bound)'),
          flush=True)
    check(agree >= floor or not gate, f'{tag}: per-ray iteration counts '
          'disagree with the plain version')


def waste_line(run, need):
    """The tile waste of a corr solve (`utils/bench_corr.py:tile_waste`)."""
    return (f'16-point tiles evaluate the MLP {run} times for {need} needed '
            f'evaluations ({run / max(need, 1):.3f}x)')


def launch_histograms(fn, specs, card):
    """The launches of kernel wrappers in fn() (the A/B frames): specs
    holds (tag, module, name, the argument whose rows are the batch,
    timing) of each wrapper, looked up by name in that module; the N of
    each launch in buckets, with the launches' device time in each bucket.
    Each launch's inputs are kept and the launch timed again on them
    afterwards, so the frames themselves carry no events: 'CUDA events'
    around 3 back-to-back calls after a warm-up (`timed`, which counts the
    host's time between launches), or 'graph replay' of 3 (`graph_ms`)."""
    import torch
    real, calls = {}, {}
    for tag, mod, name, _, _ in specs:
        real[tag], calls[tag] = getattr(mod, name), []

        def spy(*args, _tag=tag):
            calls[_tag].append(tuple(a.clone() if isinstance(
                a, torch.Tensor) else a for a in args))
            return real[_tag](*args)
        setattr(mod, name, spy)
    try:
        fn()
    finally:
        for tag, mod, name, _, _ in specs:
            setattr(mod, name, real[tag])
    edges = (256, 1024, 2048, 8192)
    names = [f'<= {e:,}' for e in edges] + [f'> {edges[-1]:,}']
    for tag, _, _, arg, how in specs:
        timer = graph_ms if how == 'graph replay' else timed
        count, ms = [0] * (len(edges) + 1), [0.0] * (len(edges) + 1)
        for args in calls[tag]:
            n = args[arg].shape[0]
            b = next((i for i, e in enumerate(edges) if n <= e), len(edges))
            count[b] += 1
            ms[b] += timer(lambda: real[tag](*args), 3)
        print(f'  {tag} launches by N over these frames ({len(calls[tag])}; '
              f'distinct N {sorted({c[arg].shape[0] for c in calls[tag]})},'
              f' timed by {how}): '
              + ', '.join(f'{nm}: {c} launches {t:.3f} ms'
                          for nm, c, t in zip(names, count, ms))
              + f'; total {sum(ms):.3f} ms [{card}]', flush=True)


def knn_sweep(tag, p, verts, card):
    """Kernels A and K (one body) at each launch shape on one input: each
    must give `nn_idx_plain`'s indices at every point; the times are
    printed. A launch that fails fails the run."""
    import torch
    from arah_tpu_torch.ops.knn import (SHAPES, knn_shape, launch_knn,
                                        nn_idx_plain)
    n, v = p.shape[0], verts.shape[0]
    ref = nn_idx_plain(p, verts)
    times, same = [], True
    for sh in range(len(SHAPES)):
        d = knn_shape(sh, n, v)
        try:
            ok = bool(torch.equal(launch_knn(p, verts, sh), ref))
        except RuntimeError as e:
            check(False, f'{tag}: launch shape {sh} failed: {e}')
            continue
        same &= ok
        times.append(f'{sh} {SHAPES[sh]} ({d["blocks"]} CTAs, '
                     f'{d["per_sm"]} an SM) '
                     f'{timed(lambda: launch_knn(p, verts, sh), 3):.4f} / '
                     f'{graph_ms(lambda: launch_knn(p, verts, sh), 10):.4f} '
                     'ms' + ('' if ok else ' DIFFERS'))
    print(f'  {tag} at its launch shapes ((threads, points a thread, vertex '
          f'groups, cluster): CUDA events / graph replay): '
          + ', '.join(times)
          + f'; indices equal at every point {same} [{card}]', flush=True)
    check(same, f'{tag}: a launch shape disagrees with nn_idx_plain')


def knn_ties(card):
    """The tie case of kernels A and K: vertices 0..299 repeated at the
    end of the body, every point within ~1e-3 of one of them, so the tie
    rule decides each point. At every size, every launch shape and both
    wrappers (each at the shape it picks) must give `nn_idx_plain`'s
    indices exactly, all of them below V - 300 (the first copy). V runs
    over the bench body's 6,946 vertices, 1,500, 20,000 (beyond the
    shared memory of a CTA of the one-CTA shapes) and 120,000 (beyond
    that of a cluster of 8) at fewer points."""
    import numpy as np
    import torch
    from arah_tpu_torch.ops.knn import (SHAPES, knn_shape, launch_knn,
                                        nn_idx, nn_idx_plain, nn_idx_rows)
    rng = np.random.RandomState(7)
    sizes = (256, 1000, 1024, 8191, 8192, 524288)
    cases = [(v, n) for v in (6946, 1500, 20000) for n in sizes] \
        + [(120000, n) for n in (256, 1000)]
    beyond = {sh: False for sh in range(len(SHAPES))}
    bad = []
    for v, n in cases:
        verts = (rng.randn(v, 3) * 0.3).astype(np.float32)
        verts[v - 300:] = verts[:300]
        pts = verts[rng.randint(0, 300, n)] \
            + rng.randn(n, 3).astype(np.float32) * 1e-3
        vt, pt = torch.from_numpy(verts).cuda(), torch.from_numpy(pts).cuda()
        ref = nn_idx_plain(pt, vt, chunk=2048)
        if int(ref.max()) >= v - 300:
            bad.append((v, n, 'plain took a later copy'))
        runs = [(f'shape {sh}', lambda sh=sh: launch_knn(pt, vt, sh))
                for sh in range(len(SHAPES))]
        runs += [('nn_idx', lambda: nn_idx(pt, vt)),
                 ('nn_idx_rows', lambda: nn_idx_rows(pt, vt))]
        for name, run in runs:
            try:
                ok = bool(torch.equal(run(), ref))
            except RuntimeError as e:
                ok = False
                name += f' ({e})'
            if not ok:
                bad.append((v, n, name))
        for sh, (nt, p, w, c) in enumerate(SHAPES):
            # a CTA's records (its shared memory less the merge rows) hold
            # less than its share of V: the share went through the chunks
            rec = (knn_shape(sh, n, v)['smem']
                   - (8 * nt * p if w * c > 1 else 0)) // 16
            beyond[sh] |= rec < -(-v // c)
    print(f'knn ties: {len(cases)} sizes (V x N) x {len(SHAPES)} launch '
          f'shapes and both wrappers: every index equal to nn_idx_plain\'s '
          f'{not bad}; a share of V beyond shared memory at shapes '
          f'{[sh for sh, b in beyond.items() if b]} [{card}]', flush=True)
    check(not bad, f'knn ties: kernels disagree with nn_idx_plain: {bad}')


# Ablations of A/K's body: copies of csrc/knn.cu with exact text
# replaced, each built beside the kernels into a library of its own.
# 'select' (a compare and two selects a pair instead of the chunk minimum
# and its rescan) and 'undoubled' (records (x, y, z, |v|^2) and a multiply
# by 2 a pair) keep the indices; the other four drop a part of the work
# behind a condition the compiler cannot fold (a.n < 0 never holds at a
# launch), so what that part costs is the time it saves.
_KNN_SCAN = 'for (int c = g * per; c < c1; ++c) {'
_KNN_NO_SCAN = [(_KNN_SCAN, 'for (int c = g * per; c < c1 && a.n < 0; ++c) {')]
_KNN_NO_MERGE = [('if constexpr (W * C == 1) {', 'if constexpr (true) {')]
KNN_ABLATIONS = {
    'select': [
        ('m[p] = fminf(m[p], knn_dist(px[p], py[p], pz[p], r));',
         '{ const float d = knn_dist(px[p], py[p], pz[p], r); '
         'if (d < best[p]) { best[p] = d; '
         'idx[p] = lo + s0 + c * KNN_CHUNK + k; } }')],
    'undoubled': [
        ('__fmul_rn(2.f, x[b]), __fmul_rn(2.f, y[b]), __fmul_rn(2.f, z[b]),',
         'x[b], y[b], z[b],'),
        ('return __fsub_rn(q.w, dot);',
         'return __fsub_rn(q.w, __fmul_rn(2.f, dot));')],
    'no rescan': [('if (bch[p] >= 0) {', 'if (bch[p] >= 0 && a.n < 0) {')],
    'no scan': _KNN_NO_SCAN,
    'staging only': _KNN_NO_SCAN + _KNN_NO_MERGE,
    'launch only': _KNN_NO_SCAN + _KNN_NO_MERGE + [
        ('knn_stage<S::NT>(sv, a.verts, lo, cnt);',
         'if (a.n < 0) knn_stage<S::NT>(sv, a.verts, lo, cnt);')],
}


def knn_ablation_source(subs):
    """csrc/knn.cu with each (old, new) of subs replaced; every old must
    appear exactly once."""
    from arah_tpu_torch.ops import _build
    with open(os.path.join(_build.CSRC, 'knn.cu')) as fh:
        text = fh.read()
    for old, new in subs:
        if text.count(old) != 1:
            raise ValueError(f'knn ablation: {old!r} appears '
                             f'{text.count(old)} times in csrc/knn.cu')
        text = text.replace(old, new)
    return text


def start_knn_ablations():
    """One nvcc a variant of KNN_ABLATIONS, all started together, each into
    `.cache/knn_ablation/<hash>/`: {name: (library path, process or None
    where a library of the same source is there)}."""
    import hashlib
    from arah_tpu_torch.ops import _build
    nvcc = _build._nvcc()
    out = {}
    for name, subs in KNN_ABLATIONS.items():
        src = knn_ablation_source(subs)
        h = hashlib.sha1((repr(_build.NVCC_FLAGS) + src).encode())
        d = os.path.join(os.path.dirname(_build.CACHE), 'knn_ablation',
                         h.hexdigest()[:16])
        lib = os.path.join(d, 'libknn.so')
        if os.path.exists(lib):
            out[name] = (lib, None)
            continue
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, 'knn.cu'), 'w') as fh:
            fh.write(src)
        out[name] = (lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, '-I', _build.CSRC, '-shared',
             os.path.join(d, 'knn.cu'), '-o', lib],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return out


def finish_knn_ablations(builds):
    """Wait for start_knn_ablations' builds: {name: loaded library}; a
    failed build fails the run."""
    import ctypes
    from arah_tpu_torch.ops import _build
    libs = {}
    for name, (path, proc) in builds.items():
        if proc is not None:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                check(False, f'knn ablation {name!r}: nvcc failed:\n{log}')
                continue
        lib = ctypes.CDLL(path)
        lib.arah_knn.argtypes = _build.load().arah_knn.argtypes
        libs[name] = lib
    return libs


def knn_ablation(libs, cases, card):
    """Times the full body (csrc/knn.cu through `launch_knn`) and each
    ablation of `libs` by graph replay on cases [(tag, points, verts,
    launch shape)]; 'select' and 'undoubled' must give `nn_idx_plain`'s
    indices."""
    import torch
    from arah_tpu_torch.ops import _build
    from arah_tpu_torch.ops.knn import launch_knn, nn_idx_plain
    for tag, p, verts, sh in cases:
        n, v = p.shape[0], verts.shape[0]
        ref = nn_idx_plain(p, verts)
        full = graph_ms(lambda: launch_knn(p, verts, sh), 10)
        parts = [f'full {full:.4f}']
        for name, lib in libs.items():
            out = torch.empty((n,), dtype=torch.int32, device=p.device)

            def run(lib=lib, out=out):
                _build.check(lib.arah_knn(
                    p.data_ptr(), n, verts.data_ptr(), v, sh,
                    out.data_ptr(), _build.stream_ptr(p)), 'knn ablation')
            ms = graph_ms(run, 10)
            note = ''
            if name in ('select', 'undoubled'):
                ok = bool(torch.equal(out, ref))
                check(ok, f'knn ablation {name!r} ({tag}) disagrees with '
                      'nn_idx_plain')
                note = ', indices equal' if ok else ', DIFFERS'
            parts.append(f'{name} {ms:.4f} ({ms - full:+.4f}{note})')
        print(f'  A/K ablations, {tag}, launch shape {sh} (graph replay, ms; '
              f'against the full body): {", ".join(parts)} [{card}]',
              flush=True)


def card_line():
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        r = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                            '--format=csv,noheader'], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return 'nvidia-smi unavailable'
    lines = r.stdout.strip().splitlines()
    return lines[0] if r.returncode == 0 and lines \
        else 'nvidia-smi unavailable'


def ptxas_check():
    """Print each kernel's registers, spills and shared memory as ptxas
    reported them in the build's log, and fail unless every kernel on
    csrc/stream_mlp.cuh (E, F, B/L, J), A/K's body and the iso init has one
    symbol a launch shape and none of them, nor any device function of
    their sources that was not inlined, spills."""
    from arah_tpu_torch.ops import _build
    log = os.path.join(os.path.dirname(_build.library_path()), 'build.log')
    if not os.path.exists(log):
        return
    from arah_tpu_torch.utils import ptxas
    ptx = ptxas.report(log)
    for name, r in ptx.items():
        print(f'  ptxas: {name}: '
              + (f'{r.get("registers")} registers, ' if r['entry']
                 else 'not inlined, ')
              + f'spill stores {r.get("spill_stores")} B, spill loads '
              f'{r.get("spill_loads")} B, stack {r.get("stack")} B'
              + (f', smem {r.get("smem", 0)} B' if r['entry'] else ''))
    from arah_tpu_torch.ops import (corr as ocorr, iso_init as oinit,
                                    knn as oknn, siren as osiren)
    # the kernels on csrc/stream_mlp.cuh, A/K's body and the iso init, one
    # symbol a launch shape
    for tag, names, want in (
            ('E/F', ('march_kernel<', 'iso_kernel<'), 4),
            ('B/L', ('corr_kernel<',),
             len(ocorr.SHAPES) + len(ocorr.VARIANTS)),
            ('J', ('siren_kernel<',), len(osiren.SHAPES)),
            ('A/K', ('knn_kernel<',), len(oknn.SHAPES)),
            ('iso init', ('iso_init_kernel<',), len(oinit.SHAPES))):
        # the entries, and every device function of their sources that was
        # not inlined (any of them may call it)
        ks, callees = ptxas.group(ptx, names)
        check(len(ks) == want
              and not any(map(ptxas.spills, [*ks.values(),
                                             *callees.values()])),
              f'kernels {tag} spill or are missing: {ks} {callees}')


def main():
    import torch
    if not torch.cuda.is_available():
        print('no CUDA device: chip_smoke.py runs on the GPU only',
              file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from arah_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def no_tf32():
        check(not torch.backends.cuda.matmul.allow_tf32
              and not torch.backends.cudnn.allow_tf32, 'TF32 got enabled')

    card = card_line()
    print(f'card: {card}', flush=True)
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'python {sys.version.split()[0]}', flush=True)

    t0 = time.perf_counter()
    ablations = start_knn_ablations()
    try:
        _build.load()
    finally:
        knn_libs = finish_knn_ablations(ablations)
    build_s = time.perf_counter() - t0
    built = _build.BUILD_SECONDS
    print(f'kernels: load {build_s:.1f} s (nvcc build '
          f'{"cached" if built is None else f"{built:.1f} s"}) '
          f'-> {_build.library_path()}', flush=True)
    ptxas_check()

    from arah_tpu_torch.core.embedder import positional_encoding
    from arah_tpu_torch.nn.layers import wn_weight
    from arah_tpu_torch.nn.skinning import skinning_dense_params
    from arah_tpu_torch.ops.color import (color_fwd_launch,
                                          color_fwd_operands,
                                          color_mlp_fused, color_mlp_plain)
    from arah_tpu_torch.ops.knn import nn_idx, nn_idx_plain
    from arah_tpu_torch.ops.shade import siren_shade, siren_shade_plain
    from arah_tpu_torch.render.ray_tracing import sample_z_vals, sphere_trace
    from arah_tpu_torch.render.renderer import (generate_sdf, make_sdf_fn,
                                                make_skin_fn)
    from arah_tpu_torch.scene import build_scene, flagship_config

    cfg = flagship_config()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, fd, inp = build_scene(cfg, RAYS, seed=0)
    torch.cuda.synchronize()
    fit_report(cfg, params, fd, time.perf_counter() - t0)
    frame = fd.frame
    dev = inp.ray_dirs.device
    gen = generate_sdf(params, cfg, inp.rots, inp.Jtrs, inp.geo_latent)
    wts, bs = skinning_dense_params(params['skinning'], cfg.skinning)
    skin_dense = (wts, bs, cfg.skinning.softmax_scale)

    records = {}
    no_tf32()
    records['march'] = check_march(cfg, fd, inp, gen, card)
    no_tf32()
    records['iso'] = check_iso(cfg, make_skin_fn(params, cfg), wts, bs, fd,
                               inp, gen, card)
    no_tf32()
    records['iso_init'] = check_iso_init(cfg, params, fd, gen, wts, bs, card)

    # ---- main-path inputs of A and B: the samples of one eval frame
    with torch.no_grad():
        cam = inp.cam_loc.expand(inp.ray_dirs.shape)
        surf = sphere_trace(cfg.tracer, make_sdf_fn(gen),
                            make_skin_fn(params, cfg), frame, fd.smpl, cam,
                            inp.ray_dirs, inp.near, inp.far, eval_mode=True,
                            sdf_gen=gen, skin_dense=skin_dense)
        z_vals, smask = sample_z_vals(cfg.tracer, ~surf.unconverged,
                                      surf.start_dis, inp.near, inp.far)
        pts = (cam[:, None, :] + z_vals[..., None]
               * inp.ray_dirs[:, None, :]).reshape(-1, 3).contiguous()
        flat_mask = smask.reshape(-1).contiguous()
    n_pts = pts.shape[0]
    verts = fd.smpl.verts_posed
    print(f'main-path inputs: {n_pts} points, {verts.shape[0]} verts, '
          f'{int(flat_mask.sum())} active samples, '
          f'{int((~surf.unconverged).sum())} surface rays', flush=True)

    # ---- A: knn, held by index equality at every point; then its launch
    # shapes at 524,288 points and strided subsets of them, and the ties
    no_tf32()
    idx_k = nn_idx(pts, verts)
    idx_p = nn_idx_plain(pts, verts)
    same = bool(torch.equal(idx_k, idx_p))
    d_k = torch.linalg.norm(pts - verts[idx_k.long()], dim=-1)
    d_p = torch.linalg.norm(pts - verts[idx_p.long()], dim=-1)
    print(f'A knn ({n_pts} samples of frame 0): indices equal at every '
          f'point {same} ({int((idx_k != idx_p).sum())} differ; max |d_kernel'
          f' - d_plain| {float((d_k - d_p).abs().max()):.3e})', flush=True)
    check(same, 'knn kernel disagrees with its plain version')
    for step in (1, 2, 4, 64, 128, 512, 2048):
        knn_sweep(f'A/K knn ({n_pts // step} samples of frame 0)',
                  pts[::step].contiguous(), verts, card)
    knn_ties(card)
    knn_ablation(knn_libs, [
        (f'{n_pts} samples of frame 0', pts, verts, 0),
        (f'{n_pts // 64} of them', pts[::64].contiguous(), verts, 1),
        (f'{n_pts // 512} of them', pts[::512].contiguous(), verts, 2)],
        card)
    nv = verts.shape[0]
    # 7 flops a pair: 3 products, 2 sums, the subtraction, the minimum
    records['knn'] = dict(
        max_abs_err=float((idx_k - idx_p).abs().max()),
        ms=timed(lambda: nn_idx(pts, verts), REPS),
        graph_ms=graph_ms(lambda: nn_idx(pts, verts), REPS),
        plain_ms=timed(lambda: nn_idx_plain(pts, verts), REPS),
        bound=bound(n_pts * 16 + nv * 12, n_pts * nv * 7.0, PEAK_F32),
        src='arah_tpu_torch/csrc/knn.cu',
        rep='arah_tpu/ops/pallas/knn_kernel.py:106')
    # the exact-rounding floor: lane-instructions a pair at the kernel's
    # own time (graph replay) and the SM clock read while it runs (132 SMs
    # x 128 lanes)
    mhz = sm_clock(lambda: nn_idx(pts, verts))
    ev, ms_a = records['knn']['ms'], records['knn']['graph_ms']
    lanes = None if mhz is None else \
        ms_a * 1e-3 * 132 * 128 * mhz * 1e6 / (n_pts * nv)
    print(f'  A: {ev:.4f} ms (CUDA events), {ms_a:.4f} ms (graph replay); '
          'SM clock while it runs '
          + ('not measured' if mhz is None else
             f'{mhz:.0f} MHz: {lanes:.2f} lane-instructions a pair')
          + f' [{card}]', flush=True)
    del idx_k, idx_p, d_k, d_p

    # ---- B: corr, at the main path's two phases
    no_tf32()
    records['corr'] = check_corr(cfg, frame, fd, pts, flat_mask, wts, bs,
                                 card)

    # ---- C: shade, random-init flagship gen, points uniform in [-1,1]^3
    g = torch.Generator(device='cpu').manual_seed(1)
    xs = (torch.rand((n_pts, 3), generator=g) * 2 - 1).to(dev)
    H = gen.weights[0].shape[0]
    shade_rec = {}
    for bf in (False, True):
        no_tf32()
        shade_rec[bf] = compare_shade(f'C shade bf16={bf}', gen, xs, bf)
    from arah_tpu_torch.ops.shade import pack_shade
    print(f'  C shared memory per block: '
          f'{_build.load().arah_shade_smem(pack_shade(gen, True)[1])} B '
          '(dynamic; ptxas reports static only)', flush=True)
    L = len(gen.weights)
    macs_c = 3 * H + (L - 2) * H * H + H
    flops_c = n_pts * (2 * macs_c + 2 * ((L - 2) * H * H + 3 * H)
                       + 30 * H * (L - 1))
    bf = cfg.bf16_shading
    records['shade'] = dict(
        max_abs_err=shade_rec[bf][0],
        ms=timed(lambda: siren_shade(gen, xs, bf16=bf), REPS),
        plain_ms=timed(lambda: siren_shade_plain(gen, xs, bf16=bf),
                       REPS),
        bound=bound(n_pts * (12 + 4 + H * (2 if bf else 4) + 12)
                    + 8 * sum(w.numel() for w in gen.weights), flops_c,
                    PEAK_BF16 if bf else PEAK_F32),
        src='arah_tpu_torch/csrc/shade.cu',
        rep='arah_tpu/ops/pallas/shade_kernel.py:113')

    # ---- D: color forward, features from C, random view dirs/normals.
    # bf16: the eval layout (C's bf16 features) and the training one (f32
    # features, here C's f32 ones); f32: C's f32 features. Each launch is
    # called twice (the same bits).
    cw = [wn_weight(l) for l in params['color']['layers']]
    cb = [l['b'] for l in params['color']['layers']]
    vd = torch.nn.functional.normalize(torch.randn((n_pts, 3), generator=g),
                                       dim=-1).to(dev)
    small = torch.cat([xs, positional_encoding(vd, cfg.color.multires_view),
                       shade_rec[cfg.bf16_shading][2]], dim=-1).contiguous()
    pose = params['latent'][0][None]
    skips = tuple(cfg.color.skips)
    color_rec = {}
    for bf, fbf in ((False, False), (True, True), (True, False)):
        no_tf32()
        feats = shade_rec[fbf][1]
        color_rec[bf, fbf] = compare_color_fwd(
            f'D color_fwd bf16={bf} feats {feats.dtype}', cw, cb, small,
            feats, pose, skips, bf)
    bf = cfg.bf16_shading
    feats = shade_rec[bf][1]
    ops_d = color_fwd_operands(cw, cb, small, feats, pose, skips, bf16=bf)
    print(f'  D shared memory per block: '
          f'{_build.load().arah_color_fwd_smem(ops_d[1])} B (dynamic, '
          f'bf16={bf})', flush=True)
    macs_d = sum(w.shape[0] * w.shape[1] for w in cw)
    # the kernel's time with its operands packed outside the timed region
    # (the kernels line); the wrapper's (pack and launch) beside it
    ms_wrap = timed(lambda: color_mlp_fused(cw, cb, small, feats, pose,
                                            skips, bf16=bf), REPS)
    records['color_fwd'] = dict(
        max_abs_err=color_rec[bf, bf],
        ms=timed(lambda: color_fwd_launch(*ops_d, small, feats), REPS),
        plain_ms=timed(lambda: color_mlp_plain(cw, cb, small, feats, pose,
                                               skips, bf16=bf), REPS),
        bound=bound(n_pts * (small.shape[1] * 4 + feats.shape[1]
                             * feats.element_size() + 12) + 4 * macs_d,
                    n_pts * 2.0 * macs_d, PEAK_BF16 if bf else PEAK_F32),
        src='arah_tpu_torch/csrc/color.cu',
        rep='arah_tpu/ops/pallas/color_kernel.py:214')
    print(f'  D: kernel {records["color_fwd"]["ms"]:.3f} ms (operands '
          f'packed outside), wrapper {ms_wrap:.3f} ms (pack and launch) '
          f'[{card}]', flush=True)
    del ops_d
    del xs, small, feats, shade_rec
    torch.cuda.empty_cache()

    launches, frames, flagship_out = run_render(cfg, params, fd, inp, card,
                                                gen, no_tf32)
    per = {name: 'over 3 frames' for name in launches}
    torch.cuda.empty_cache()
    # J and K count launches over the 3 A/B frames, L in the corr bench
    ab_records, ab_launches = run_ab(cfg, params, fd, frames, flagship_out,
                                     card, gen, skin_dense, no_tf32)
    records.update(ab_records)
    launches.update(ab_launches)
    per.update(siren='over 3 A/B frames', knn_rows='over 3 A/B frames',
               corr_rows='in the corr bench')
    # phase 11's eval frame: the flagship frame's rays as an eval item
    frame_item = {
        'inputs.ray_dirs': inp.ray_dirs.cpu().numpy(),
        'inputs.body_bounds_intersections': torch.stack(
            [inp.near, inp.far], -1).cpu().numpy(),
        'image.cam_loc': inp.cam_loc.reshape(3).cpu().numpy()}
    del inp, gen, frames, flagship_out
    torch.cuda.empty_cache()
    # G, H and I count launches per train step (the eval path runs none)
    train_records, train_launches = run_train(cfg, params, fd, card,
                                              no_tf32)
    records.update(train_records)
    for name in train_records:
        launches[name] = train_launches[name]
        per[name] = 'per train step'
    torch.cuda.empty_cache()
    refined_launches = run_refined(cfg, params, fd, card, no_tf32,
                                   train_launches)
    torch.cuda.empty_cache()
    # the options' variants count launches on their own option's run
    opt_records, opt_launches = run_options(cfg, params, fd, card, no_tf32)
    records.update(opt_records)
    launches.update(opt_launches)
    per.update(shade_resid='in the resid step',
               shade_bwd_resid='in the resid step',
               corr_jac='in the idiff_kernel_jac step',
               corr_split3='in the split3 eval frame',
               corr_bf16='in the bf16 eval frame')
    torch.cuda.empty_cache()
    import tempfile
    with tempfile.TemporaryDirectory(prefix='arah_cli_') as tmp:
        cli_launches, cli = run_clis(card, no_tf32, params, tmp)
        torch.cuda.empty_cache()
        test_launches, grid_rec = run_cli_test(card, no_tf32, cli)
        records['siren'].update(grid_rec)
        torch.cuda.empty_cache()
        # the mesh path on a body-sized surface: phase 2's fitted SIREN
        # at the bench pose with its latent (`scene.scene_inputs`), seen
        # by the bench camera
        mesh_check('bench scene', params, cfg, fd, bench_item(fd),
                   params['latent'][0], card, no_tf32, timed_frame=True)
        torch.cuda.empty_cache()
        h36m_launches = run_cli_h36m(card, no_tf32, tmp, cli['pre'])
        torch.cuda.empty_cache()
        run_cli_snapshot(card, no_tf32, tmp, cli['pre'])
        torch.cuda.empty_cache()
        ddp_launches = run_ddp(card, no_tf32, params, fd, frame_item, cli,
                               tmp)
        torch.cuda.empty_cache()
        parity_launches = run_parity(card, no_tf32, tmp)

    out = []
    for name, r in records.items():
        out.append({'name': name, 'route': 'cuda', 'source': r['src'],
                    'replaces': r['rep'], 'launches': launches[name],
                    'max_abs_err': r['max_abs_err'], 'ms': r['ms'],
                    'plain_ms': r['plain_ms'], 'bound_ms': r['bound'][0],
                    'bound_by': r['bound'][1], 'library_ms': None,
                    **{k: r[k] for k in ('phase2_ms', 'phase2_plain_ms',
                                         'phase2_bound_ms', 'graph_ms',
                                         'eager_ms', 'phase2_eager_ms')
                       if k in r},
                    **({'launches_refined_step': refined_launches[name],
                        'launches_cli_train': cli_launches[name],
                        'launches_cli_h36m': h36m_launches[name],
                        'launches_ddp': ddp_launches[name]}
                       if name in TRAIN_KERNELS else {}),
                    **({'launches_cli_test': test_launches[name]}
                       if name in CLI_TEST_KERNELS else {}),
                    **({'launches_parity': parity_launches[name]}
                       if name in CLI_KERNELS_EVAL else {}),
                    **{k: r[k] for k in ('grid_ms', 'grid_plain_ms',
                                         'grid_bound_ms', 'grid_max_abs_err')
                       if k in r}})
        print(f'{name}: {r["ms"]:.3f} ms kernel, {r["plain_ms"]:.3f} ms '
              f'plain, bound {r["bound"][0]:.4f} ms ({r["bound"][1]}), '
              f'launches {launches[name]} {per[name]} [{card}]')
    if FAILURES:
        print(f'{len(FAILURES)} check(s) failed: {FAILURES}', flush=True)
        sys.exit(1)
    print(f'library_ms: null for all {len(out)}: no single PyTorch call '
          'computes a nearest-vertex argmin, a Broyden solve (with or '
          'without its Jacobian), a SIREN (with or without its input '
          'gradient), a split-input MLP, a sphere-trace loop, a skinning '
          'Jacobian or the backward of a SIREN or of a split-input MLP')
    print(json.dumps({'kernels': out}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


def compare_shade(tag, gen, xs, bf):
    """Kernel C against `siren_shade_plain` at points xs (bf16 products
    when `bf`): median |d| of sdf < 3e-3, of features and normals < 5e-2;
    two calls give the same bits. Returns (max |d sdf|, the kernel's
    features, its normals)."""
    import torch
    from arah_tpu_torch.ops.shade import siren_shade, siren_shade_plain
    with torch.no_grad():
        ok_, fk, gk = siren_shade(gen, xs, bf16=bf)
        ok2, fk2, gk2 = siren_shade(gen, xs, bf16=bf)
        same = (torch.equal(ok_, ok2) and torch.equal(fk, fk2)
                and torch.equal(gk, gk2))
        del ok2, fk2, gk2
        op, fp, gp = siren_shade_plain(gen, xs, bf16=bf)
    ds = (ok_ - op).abs()
    df = (fk.float() - fp.float()).abs()
    dg = (gk - gp).abs()
    print(f'{tag} ({xs.shape[0]} points): median |d| sdf '
          f'{float(ds.median()):.3e} (bound 3e-3) feats '
          f'{float(df.median()):.3e} (5e-2) normals {float(dg.median()):.3e}'
          f' (5e-2); p99 {q(ds, .99):.3e} {q(df, .99):.3e} {q(dg, .99):.3e};'
          f' max {float(ds.max()):.3e} {float(df.max()):.3e} '
          f'{float(dg.max()):.3e}; two calls bit-equal {same}', flush=True)
    check(float(ds.median()) < 3e-3 and float(df.median()) < 5e-2
          and float(dg.median()) < 5e-2,
          f'{tag}: shade kernel disagrees with its plain version')
    check(same, f'{tag}: shade kernel: two calls differ')
    return float(ds.max()), fk, gk


def compare_color_fwd(tag, cw, cb, small, feats, pose, skips, bf):
    """Kernel D against `color_mlp_plain` on one input: in bf16 median
    |d rgb| < 1e-4 and p99.9 < 1e-2, in f32 max < 1e-4; two calls give
    the same bits. Returns max |d rgb|."""
    import torch
    from arah_tpu_torch.ops.color import color_mlp_fused, color_mlp_plain
    with torch.no_grad():
        rk_ = color_mlp_fused(cw, cb, small, feats, pose, skips, bf16=bf)
        same = torch.equal(rk_, color_mlp_fused(cw, cb, small, feats, pose,
                                                skips, bf16=bf))
        rp_ = color_mlp_plain(cw, cb, small, feats, pose, skips, bf16=bf)
    d = (rk_ - rp_).abs()
    msg = (f'{tag} ({small.shape[0]} points): max |d rgb| '
           f'{float(d.max()):.3e}, median {float(d.median()):.3e}, p99.9 '
           f'{q(d, .999):.3e}; two calls bit-equal {same}')
    if bf:
        print(msg + ' (bounds median 1e-4, p99.9 1e-2)', flush=True)
        check(float(d.median()) < 1e-4 and q(d, .999) < 1e-2,
              f'{tag}: color kernel disagrees with its plain version')
    else:
        print(msg + ' (bound max 1e-4)', flush=True)
        check(float(d.max()) < 1e-4,
              f'{tag}: color kernel disagrees with its plain version')
    check(same, f'{tag}: color kernel: two calls differ')
    return float(d.max())


def fit_report(cfg, params, fd, build_s):
    """The fit's time, and its loss at a fresh batch of 8,192 points
    against the random init's (the fit must have lowered it)."""
    import numpy as np
    import torch
    from arah_tpu_torch.data.synthetic import synthetic_smpl
    from arah_tpu_torch.model import init_model_params
    from arah_tpu_torch.scene import N_VERTS, scene_frame
    from arah_tpu_torch.utils.bench_scene import (capsule_segments_02v,
                                                  sample_points, scene_loss)
    dev = fd.verts_cano.device
    model = synthetic_smpl(n_verts=N_VERTS)
    betas = scene_frame(model, np.random.RandomState(0), dev)[1]
    seg = capsule_segments_02v(model, torch.as_tensor(betas, device=dev))
    x = sample_points(fd, 8192, torch.Generator(device=dev).manual_seed(7))
    init = init_model_params(torch.Generator().manual_seed(0), cfg,
                             n_latent_frames=4, device=dev)
    with torch.enable_grad():
        l_fit = float(scene_loss(params, cfg, fd, *seg, x).detach())
        l_init = float(scene_loss(init, cfg, fd, *seg, x).detach())
    print(f'scene: flagship, {RAYS} rays, seed 0; build_scene(pretrain=True) '
          f'{build_s:.1f} s with the fit (800 Adam steps of 8192 points); '
          f'loss at a fresh 8192-point batch: fitted {l_fit:.5f}, random '
          f'init {l_init:.5f}', flush=True)
    check(np.isfinite(l_fit) and l_fit < l_init,
          'the bench-scene fit did not lower the loss')


def corr_slots(tag, count, args, packed, steps, scale, out, plain_iters,
               card, gate=True):
    """Kernel B (`count` 'corr') or L ('corr_rows') on args (x_bar, x0,
    T0_16, mask, bones16, coord_min, coord_max, center) beside the
    wrapper's output `out` on them: the launch again, with each point's
    Broyden iteration count (iters_out), must give the same bits, its
    counts agree with the plain solve's (`iters_check`; printed only, not
    `gate`d, on stragglers), and every launch shape gives the same bits
    (`shape_sweep`). Returns the kernel's own MLP evaluations (one at init
    and one an iteration of each unmasked point) and its counts."""
    import torch
    from arah_tpu_torch.ops.corr import SHAPES, launch_corr, launch_shape
    x_bar, mask = args[0], args[3]
    n = x_bar.shape[0]

    def run(shape, iters=None):
        o = launch_corr(count, *args[:4], packed, *args[4:], steps, 1e-5,
                        scale, count == 'corr', shape=shape, iters=iters)
        return o if count == 'corr' else o[:3]
    it = torch.zeros((n,), dtype=torch.int32, device=x_bar.device)
    sh = launch_shape(n)
    same = all(torch.equal(a, b) for a, b in zip(out, run(sh, it)))
    print(f'  two calls bit-equal {same}; {shape_line("corr", sh, n)} '
          f'[{card}]', flush=True)
    check(same, f'{tag}: two calls of the corr kernel differ')
    iters_check(tag, it, plain_iters, gate=gate)
    shape_sweep(tag, 'corr', n, run, out, card, shapes=range(len(SHAPES)))
    return int(mask.sum()) + int(it.sum()), it


def check_corr(cfg, frame, fd, pts, flat_mask, wts, bs, card):
    """Kernel B against `corr_search_plain` on the main path's samples of
    one eval frame: phase 1 (every sample, corr_phase1_steps) with its
    `active` set, the straggler split's two launches, and phase 2's shape
    (the first corr_resolve_cap samples at corr_max_steps), each with its
    iteration counts and launch shapes (`corr_slots`); the tile waste of
    the tile design (`utils/bench_corr.py:tile_waste`). Its record: both
    phases' times, each bound from the kernel's own evaluations."""
    import torch
    from arah_tpu_torch.ops.corr import (corr_search, corr_search_plain,
                                         dense_skin_fn, launch_corr,
                                         launch_shape, pack_corr)
    from arah_tpu_torch.render.ray_tracing import _corr_solve_split, corr_init
    from arah_tpu_torch.solver.root_find import (CanonicalFrame,
                                                 search_canonical_corr)
    from arah_tpu_torch.utils.bench_corr import tile_waste
    from arah_tpu_torch.utils import trace
    n_pts, dev, scale = pts.shape[0], pts.device, cfg.skinning.softmax_scale
    with torch.no_grad():
        x_bar, x0, T0 = corr_init(cfg.tracer, frame, fd.smpl, pts)
    T0_16 = T0.reshape(n_pts, 16).contiguous()
    skin_fn = dense_skin_fn(wts, bs, scale)
    bones16 = frame.bone_transforms.reshape(24, 16).contiguous()
    box = (frame.coord_min, frame.coord_max, frame.center)
    cframe = CanonicalFrame(frame.bone_transforms, torch.zeros(3, device=dev),
                            *box)
    packed = pack_corr(wts, bs)
    macs = sum(w.shape[0] * w.shape[1] for w in wts)
    flops_eval = 2 * macs + 4 * sum(w.shape[0] for w in wts[:-1]) \
        + 2 * 24 * 16 + 250

    def phase(tag, args, steps, stragglers=False):
        """The kernel against the plain solve on args (x_bar, x0, T0_16,
        mask); returns (max |dx|, kernel ms, plain ms, bound, kernel and
        plain outputs). On `stragglers` (points still active after phase
        1, whose outcome at corr_max_steps roundoff sets: `corr_compare`)
        the iteration counts are printed, not held."""
        n = args[0].shape[0]
        kargs = (*args, wts, bs, bones16, *box)
        k = corr_search(*kargs, max_steps=steps)
        p = corr_search_plain(*kargs, max_steps=steps)
        flips = None
        if stragglers:
            # the witness: the same plain solve in float64
            d = torch.float64
            r64 = search_canonical_corr(
                dense_skin_fn([w.to(d) for w in wts], [b.to(d) for b in bs],
                              scale),
                CanonicalFrame(*(t.to(d) for t in cframe)), args[0].to(d),
                args[1].to(d), args[2].reshape(n, 4, 4).to(d),
                max_steps=steps, active_init=args[3])
            flips = int((r64.valid != p[2]).sum())
        err = corr_compare(tag, k[0], k[2], p[0], p[2], args[0], frame,
                           skin_fn, flips)
        res = search_canonical_corr(skin_fn, cframe, args[0], args[1],
                                    args[2].reshape(n, 4, 4),
                                    max_steps=steps, active_init=args[3])
        evals, it_k = corr_slots(tag, 'corr', (*args, bones16, *box),
                                 packed, steps, scale, k, res.iters, card,
                                 gate=not stragglers)
        if stragglers:
            def agree(a, b):
                return f'{float((a == b).float().mean()):.6f}'
            print(f'  {tag}: the plain solve in float64 against the float32 '
                  f'one: valid agreement {agree(r64.valid, p[2])}, '
                  f'iteration counts {agree(r64.iters, res.iters)}; against '
                  f'the kernel: valid {agree(r64.valid, k[2])}, iterations '
                  f'{agree(r64.iters, it_k)} [{card}]', flush=True)
        ms = timed(lambda: launch_corr('corr', *args, packed, bones16, *box,
                                       steps, 1e-5, scale, True), REPS)
        plain_ms = timed(lambda: corr_search_plain(*kargs, max_steps=steps),
                         2)
        # data-dependent work: the kernel's own MLP evaluations
        b = bound(n * (12 + 12 + 64 + 1 + 12 + 64 + 2) + 4 * (macs + 600),
                  evals * float(flops_eval), PEAK_F32)
        print(f'  B work: {evals} MLP evaluations by the kernel, '
              f'{int(args[3].sum()) + int(res.iters.sum())} by the plain '
              f'solve ({float(res.iters.float().mean()):.3f} iterations per '
              f'point, max {int(res.iters.max())}); '
              f'{waste_line(*tile_waste(res.iters, args[3]))}; kernel '
              f'{ms:.3f} ms (pack outside), plain {plain_ms:.3f} ms, bound '
              f'{b[0]:.4f} ms ({b[1]}) [{card}]', flush=True)
        return err, ms, plain_ms, b, k, p

    steps = cfg.tracer.corr_phase1_steps
    err, ms, plain_ms, b, k, p = phase(
        f'B corr phase 1 ({n_pts} points, {steps} steps)',
        (x_bar, x0, T0_16, flat_mask), steps)
    act_agree = float((k[3] == p[3]).float().mean())
    print(f'  active at {steps} steps: kernel {int(k[3].sum())} plain '
          f'{int(p[3].sum())}, agreement {act_agree:.6f} (bound >= 0.999)',
          flush=True)
    check(act_agree >= 0.999, 'B corr phase 1: the active set disagrees '
          'with the plain solve\'s')
    # phase 2 as the main path runs it: the first corr_resolve_cap points
    # still active after phase 1, from scratch at corr_max_steps
    cap, p2_steps = cfg.tracer.corr_resolve_cap, cfg.tracer.corr_max_steps
    strag = torch.nonzero(k[3]).flatten()[:cap]
    del k, p
    if strag.numel():
        phase(f'B corr phase 2 on the phase-1 stragglers ({strag.numel()} '
              f'points, {p2_steps} steps)',
              (x_bar[strag].contiguous(), x0[strag].contiguous(),
               T0_16[strag].contiguous(),
               torch.ones_like(strag, dtype=torch.bool)), p2_steps,
              stragglers=True)

    # The split and its write-back. Phase 1 cut to one iteration leaves
    # nearly every sample active, so the split re-solves the first
    # corr_resolve_cap of them at corr_max_steps and writes them back;
    # the kernel side must launch twice.
    tr1 = cfg.tracer._replace(corr_phase1_steps=1)
    c0 = trace.COUNTS['corr']
    with torch.no_grad():
        xk2, _, vk2, _, _ = _corr_solve_split(
            tr1, skin_fn, frame, (wts, bs, scale), x_bar, x0, T0, flat_mask)
        n_k = trace.COUNTS['corr'] - c0
        xp2, _, vp2, _, _ = _corr_solve_split(
            tr1._replace(use_pallas_corr=False), skin_fn, frame, None,
            x_bar, x0, T0, flat_mask)
    corr_compare(f'B corr split, phase 1 at 1 step, phase 2 on the first '
                 f'{cap} stragglers at {p2_steps} steps', xk2, vk2, xp2, vp2,
                 x_bar, frame, skin_fn)
    check(n_k == 2, f'corr split launched the kernel {n_k} times, not 2')
    del xk2, vk2, xp2, vp2

    sel = torch.nonzero(flat_mask).flatten()[:cap]
    args2 = (x_bar[sel].contiguous(), x0[sel].contiguous(),
             T0_16[sel].contiguous(), torch.ones_like(sel, dtype=torch.bool))
    _, ms2, plain2, b2, k2, _ = phase(
        f'B corr phase 2 shape ({sel.numel()} points, {p2_steps} steps)',
        args2, p2_steps)
    # a skinning MLP wider than 128 takes launch shape 2: the fitted net
    # zero-padded to 256 units computes the same function, every added
    # term an exact zero after the real ones, so B must give its bits
    wide_w, wide_b = [], []
    for i, (w, b_) in enumerate(zip(wts, bs)):
        o = w.shape[0] if i == len(wts) - 1 else 256
        wp = w.new_zeros((o, 3 if i == 0 else 256))
        wp[:w.shape[0], :w.shape[1]] = w
        bp = b_.new_zeros((o,))
        bp[:b_.shape[0]] = b_
        wide_w.append(wp)
        wide_b.append(bp)
    wkargs = (*args2, wide_w, wide_b, bones16, *box)
    c0 = trace.COUNTS['corr']
    kw = corr_search(*wkargs, max_steps=p2_steps)
    n_w = trace.COUNTS['corr'] - c0
    same = all(torch.equal(a, b_) for a, b_ in zip(kw, k2))
    wpack = pack_corr(wide_w, wide_b)
    sh_w = launch_shape(sel.numel(), 256)
    ms_w = timed(lambda: launch_corr('corr', *args2, wpack, bones16, *box,
                                     p2_steps, 1e-5, scale, True), REPS)
    print(f'B corr, the skinning MLP zero-padded to 256 units '
          f'({sel.numel()} points, {p2_steps} steps): '
          f'{shape_line("corr", sh_w, sel.numel())}; {n_w} launch, '
          f'bit-equal to the 128-wide net {same}; kernel {ms_w:.3f} ms '
          f'[{card}]', flush=True)
    check(same and n_w == 1 and sh_w == 2, 'B corr: the 256-wide launch '
          'shape changes the bits of a zero-padded skinning MLP')
    del kw, k2
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound=b,
                phase2_ms=ms2, phase2_plain_ms=plain2, phase2_bound_ms=b2[0],
                src='arah_tpu_torch/csrc/corr_rows.cu',
                rep='arah_tpu/ops/pallas/corr_kernel_t.py:291')


def march_compare(tag, out_k, out_p, gen, mscale, thresh, out_w=None):
    """Hold kernel E's march (out_k) against the plain one (out_p):
    unfinished and diverged agreement >= `agreement_floor` (with the
    float64 witness's march `out_w`, `witness_floor`'s floors), median
    |dt| < 1e-5 on rays both sides finished on a surface, and >= 0.9 of
    the rays that differ (a flag, or |dt| > 1e-4) and that the kernel
    finished on a surface hold it: plain |sdf| at the kernel's x_norm <
    2 x thresh. Returns the max |dt| on commonly finished rays."""
    import torch
    from arah_tpu_torch.nn.siren import siren_apply
    t_k, unf_k, div_k, xn_k = out_k[:4]
    t_p, unf_p, div_p, xn_p = out_p[:4]
    a_unf = float((unf_k == unf_p).double().mean())
    a_div = float((div_k == div_p).double().mean())
    f_unf = f_div = agreement_floor(unf_k.numel())
    wit = ''
    if out_w is not None:
        (f_unf, d_unf), (f_div, d_div) = (witness_floor(out_w[1] != unf_p),
                                          witness_floor(out_w[2] != div_p))
        wit = (f'; the float64 witness differs on {d_unf} unfinished and '
               f'{d_div} diverged flags')
    fin = ~unf_k & ~div_k & ~unf_p & ~div_p
    dt_all = (t_k - t_p).abs()
    dt = dt_all[fin]
    dx = torch.linalg.norm(xn_k - xn_p, dim=-1)[fin]
    med_t = float(dt.median()) if dt.numel() else 0.0
    max_t = float(dt.max()) if dt.numel() else 0.0
    med_x = float(dx.median()) if dx.numel() else 0.0
    max_x = float(dx.max()) if dx.numel() else 0.0
    differ = (unf_k != unf_p) | (div_k != div_p) | (fin & (dt_all > 1e-4))
    sel = differ & ~unf_k & ~div_k
    share = 1.0
    if bool(sel.any()):
        with torch.no_grad():
            sdf = siren_apply(gen, xn_k[sel])[:, 0] * mscale
        share = float((sdf.abs() < 2 * thresh).float().mean())
    print(f'{tag}: unfinished agreement {a_unf:.6f} (bound >= {f_unf:.6f}), '
          f'diverged agreement {a_div:.6f} (bound >= {f_div:.6f}); on '
          f'{int(fin.sum())} rays both '
          f'finished: |dt| median {med_t:.3e} (bound 1e-5) max {max_t:.3e}, '
          f'|dx_norm| median {med_x:.3e} max {max_x:.3e}; {int(differ.sum())}'
          f' rays differ, {int(sel.sum())} of them kernel-finished, share '
          f'on the surface {share:.4f} (bound >= 0.9); unfinished kernel '
          f'{int(unf_k.sum())} plain {int(unf_p.sum())}{wit}', flush=True)
    check(a_unf >= f_unf and a_div >= f_div and med_t < 1e-5
          and share >= 0.9,
          f'{tag}: march kernel disagrees with its plain version')
    return max_t


def check_march(cfg, fd, inp, gen, card, tag='E march ', witness=False):
    """Kernel E against `sphere_march_plain` at the main path's two
    shapes (iterations per ray too, from `iters_out`; two calls
    bit-equal) on the rays of `inp` (cam_loc, ray_dirs, near, far) in the
    frame and body of `fd` (frame, smpl); its record (times and bounds
    of both phases, each bound from the plain run's per-ray
    iterations). With `witness`, the plain march also runs in float64,
    and the flags' and counts' floors are `witness_floor`'s."""
    import torch
    from arah_tpu_torch.ops.march import (kernel_affine, launch_march,
                                          launch_shape, pack_trace,
                                          sphere_march, sphere_march_plain)
    tr = cfg.tracer
    frame, smpl = fd.frame, fd.smpl
    cam = inp.cam_loc.expand(inp.ray_dirs.shape).contiguous()
    p1, cap = tr.march_phase1_steps, tr.march_resolve_cap
    p2 = tr.sphere_tracing_iters - p1
    mscale = kernel_affine(frame)[2]
    packed = pack_trace(gen)
    nv = smpl.verts_posed.shape[0]
    macs = sum(w.numel() for w in gen.weights)
    flops_it = 2 * macs + 8 * nv + 2 * 24 * 16
    wbytes = 4 * sum(w.numel() + w.shape[0] for w in gen.weights)

    def run(fn, c, d, near, far, iters):
        return fn(c, d, near, far, smpl.verts_posed, smpl.skinning_weights,
                  frame, gen, n_iters=iters,
                  thresh=tr.root_finding_threshold, clamp_dist=tr.clamp_dist)

    def kernel_iters(c, d, near, far, iters):
        """The kernel's outputs at its main-path launch shape, with each
        ray's iteration count and the tie count."""
        it = torch.zeros((d.shape[0],), dtype=torch.int32, device=d.device)
        out = launch_march(c, d, near, far, smpl.verts_posed,
                           smpl.skinning_weights, frame, packed, iters,
                           tr.root_finding_threshold, tr.clamp_dist,
                           launch_shape(d.shape[0]), iters=it)
        return out[:5], it, int(out[5][1])

    def phase(tag, args, o):
        n = args[1].shape[0]
        k = run(sphere_march, *args)
        w = None
        if witness:
            w = sphere_march_plain(
                *f64(args[:4]), *f64((smpl.verts_posed, smpl.skinning_weights,
                                      frame, gen)), n_iters=args[4],
                thresh=tr.root_finding_threshold, clamp_dist=tr.clamp_dist)
        err = march_compare(tag, k, o, gen, mscale,
                            tr.root_finding_threshold, w)
        k2, it_k, ties = kernel_iters(*args)
        same = all(torch.equal(x, y) for x, y in zip(k, k2))
        print(f'  two calls bit-equal {same}; nearest-vertex ties '
              f're-scanned {ties}; {shape_line("march", launch_shape(n), n)}'
              f' [{card}]', flush=True)
        check(same, f'{tag}: two calls of the march kernel differ')
        iters_check(tag, it_k, o[5], it_w=None if w is None else w[5])
        shape_sweep(tag, 'march', n, lambda sh: launch_march(
            *args[:4], smpl.verts_posed, smpl.skinning_weights, frame,
            packed, args[4], tr.root_finding_threshold, tr.clamp_dist,
            sh)[:5], k, card)
        ms = timed(lambda: run(sphere_march, *args), REPS)
        plain_ms = timed(lambda: run(sphere_march_plain, *args), 2)
        # least work: each ray-iteration the plain run needed, at the
        # SIREN's multiply-adds, 8 flops per vertex of the scan and the
        # bone blend
        its = int(o[5].sum())
        b = bound(n * (12 + 12 + 4 + 4 + 4 + 1 + 1 + 12 + 64) + nv * 108
                  + wbytes, its * float(flops_it), PEAK_F32)
        print(f'  E work: {its} ray-iterations ({its / n:.3f} per ray, max '
              f'{int(o[5].max())}); {flops_it} flops each; kernel {ms:.3f} '
              f'ms, plain {plain_ms:.3f} ms, bound {b[0]:.4f} ms [{card}]',
              flush=True)
        return err, ms, plain_ms, b

    a1 = (cam, inp.ray_dirs, inp.near, inp.far, p1)
    o1 = run(sphere_march_plain, *a1)
    err, ms, plain_ms, b = phase(
        f'{tag}phase 1 ({cam.shape[0]} rays, {p1} iterations)', a1, o1)
    rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound=b,
               src='arah_tpu_torch/csrc/march.cu',
               rep='arah_tpu/ops/pallas/march_kernel.py:175')
    # phase 2: the first `cap` stragglers of the plain phase 1, resumed
    # from their depth with the remaining budget
    idx = torch.nonzero(o1[1]).flatten()[:cap]
    if idx.numel():
        a2 = (cam[idx], inp.ray_dirs[idx], o1[0][idx], inp.far[idx], p2)
        _, ms2, plain2, b2 = phase(
            f'{tag}phase 2 ({idx.numel()} stragglers of '
            f'{int(o1[1].sum())}, {p2} iterations)', a2,
            run(sphere_march_plain, *a2))
        rec.update(phase2_ms=ms2, phase2_plain_ms=plain2,
                   phase2_bound_ms=b2[0])
    else:
        print(f'{tag}phase 2: no stragglers after phase 1')
        rec.update(phase2_ms=None, phase2_plain_ms=None,
                   phase2_bound_ms=None)
    return rec


def iso_compare(tag, out_k, out_p, resid, out_w=None):
    """Hold kernel F's solve (out_k) against the plain one (out_p): valid
    agreement >= `agreement_floor`, median |dx_hat| < 1e-5 on commonly
    valid rays, and every kernel-valid ray a root of the plain residual
    (|g(u)| < 5e-5). With the float64 witness's solve `out_w`, the valid
    agreement's floor is `witness_floor`'s, and in place of the median:
    the share of commonly valid rays on the plain version's root
    (|dx_hat| <= 1e-4) at `witness_floor`'s floor from the witness's
    roots, and the median over those rays < 1e-5. resid(sel, u) -> |g(u)|
    of rays sel. Returns the max |dx_hat| on commonly valid rays."""
    import torch
    u_k, _, v_k, a_k = out_k[:4]
    u_p, _, v_p, a_p = out_p[:4]
    agree = float((v_k == v_p).double().mean())
    floor, wit = agreement_floor(v_k.numel()), ''
    if out_w is not None:
        floor, d = witness_floor(out_w[2] != v_p)
        bw = out_w[2] & v_p
        f_root, d_root = witness_floor(torch.linalg.norm(
            out_w[0][bw, :3] - u_p[bw, :3].double(), dim=-1) > 1e-4)
        wit = (f'; the float64 witness differs on {d} valid flags and, of '
               f'{int(bw.sum())} rays valid in both, lands {d_root} on '
               f'another root')
    both = v_k & v_p
    dx = torch.linalg.norm(u_k[:, :3] - u_p[:, :3], dim=-1)[both]
    dz = (u_k[:, 3] - u_p[:, 3]).abs()[both]
    med_x = float(dx.median()) if dx.numel() else 0.0
    max_x = float(dx.max()) if dx.numel() else 0.0
    med_z = float(dz.median()) if dz.numel() else 0.0
    held = med_x < 1e-5
    if out_w is not None:
        same = dx <= 1e-4
        a_root = float(same.double().mean()) if dx.numel() else 1.0
        med_s = float(dx[same].median()) if bool(same.any()) else 0.0
        held = a_root >= f_root and med_s < 1e-5
        wit += (f'; on the plain root {a_root:.6f} of the commonly valid '
                f'rays (bound >= {f_root:.6f}), their |dx_hat| median '
                f'{med_s:.3e} (bound 1e-5)')
    sel = torch.nonzero(v_k).flatten()
    r_max = float(resid(sel, u_k[sel]).max()) if sel.numel() else 0.0
    print(f'{tag}: valid agreement {agree:.6f} (bound >= {floor:.6f}); on '
          f'{int(both.sum())} commonly valid rays |dx_hat| median '
          f'{med_x:.3e}{"" if out_w is not None else " (bound 1e-5)"} max '
          f'{max_x:.3e}, |dz| median '
          f'{med_z:.3e}; max |g(u)| over kernel-valid rays {r_max:.3e} '
          f'(bound 5e-5); valid kernel {int(v_k.sum())} plain '
          f'{int(v_p.sum())}, active kernel {int(a_k.sum())} plain '
          f'{int(a_p.sum())}{wit}', flush=True)
    check(agree >= floor and held and r_max < 5e-5,
          f'{tag}: iso kernel disagrees with its plain version')
    return max_x


def iso_count_witness(tag, rays, wts, bs, frame, gen, steps, cvg, scale,
                      it_k, it_p, card):
    """Where the stopping step of F's phase-2 solves comes from. The plain
    solve runs twice more on the same rays, with the same code: in float64
    on the card and in float32 on the host's CPU; each run's |g| is kept
    at every evaluation. Prints each version's per-ray iteration agreement
    with the float32 card run (the plain version) and with the float64
    one; and over the rays where the kernel's count and the plain
    version's differ, the step where the float32 and float64 runs' |g|
    first part by more than 1%, how many run to the cap in both, and for
    the others the step where the earlier run stops (at |g| >= 1), its
    |g| there and the later run's |g| at the same step."""
    import torch
    from arah_tpu_torch.ops.iso import iso_residual
    from arah_tpu_torch.solver.broyden import broyden

    def solve(dtype, dev):
        def cast(t):
            return t.to(dev, dtype) if t.is_floating_point() else t.to(dev)
        r = [cast(t) for t in rays]
        g0 = iso_residual(r[0], r[1], [cast(w) for w in wts],
                          [cast(b) for b in bs],
                          type(frame)(*[cast(t) for t in frame]),
                          type(gen)(*[tuple(cast(t) for t in f)
                                      for f in gen]), scale)
        norms = []

        def g(u):
            out = g0(u)
            norms.append(torch.linalg.norm(out[0], dim=-1).double().cpu())
            return out
        res = broyden(g, r[2], r[3], r[4].reshape(-1, 4, 4),
                      max_steps=steps, cvg_thresh=cvg, active_init=r[5])
        return res.iters.cpu(), torch.stack(norms)

    dev = rays[1].device
    it32, g32 = solve(torch.float32, dev)
    it64, g64 = solve(torch.float64, dev)
    # the two solves may stop after different numbers of evaluations
    # (all rays done): pad the shorter record with NaN
    n_ev = max(g32.shape[0], g64.shape[0])
    g32, g64 = (torch.cat([g, torch.full((n_ev - g.shape[0],) + g.shape[1:],
                                         float('nan'), dtype=g.dtype)])
                for g in (g32, g64))
    itc = solve(torch.float32, torch.device('cpu'))[0]
    itk = it_k.cpu()

    def agree(a, b):
        return f'{float((a == b).float().mean()):.6f}'
    off = torch.nonzero(itk != it32).flatten()
    msg = ''

    def qs(x, f):
        return (f'{q(x, 0.5):{f}} ({q(x, 0.25):{f}}-{q(x, 0.75):{f}})'
                if x.numel() else 'none')
    if off.numel():
        stop = torch.minimum(it32[off], it64[off]).long()
        steps_ = torch.arange(g32.shape[0])[:, None]
        rel = (g32[:, off] - g64[:, off]).abs() / g64[:, off].abs()
        parted = (rel > 0.01) & (steps_ <= stop[None])
        first = torch.where(parted.any(0), parted.float().argmax(0),
                            stop).double()
        early = stop < steps
        sel, s = off[early], stop[early]
        f32_first = it32[sel] <= it64[sel]
        g_stop = torch.where(f32_first, g32[s, sel], g64[s, sel])
        g_other = torch.where(f32_first, g64[s, sel], g32[s, sel])
        msg = (f'; on the {off.numel()} rays where kernel and plain counts '
               f'differ, the float32 and float64 runs\' |g| part by > 1% '
               f'at step {qs(first, ".0f")} (median, quartiles); '
               f'{int((~early).sum())} of them run to the cap in both; the '
               f'other {sel.numel()} stop in the earlier run at step '
               f'{qs(s.double(), ".0f")}, with |g| {qs(g_stop, ".4g")} '
               f'there ({int((g_stop >= 1).sum())} diverged at >= 1, '
               f'{int((g_stop < cvg).sum())} converged), the later run at '
               f'that step with |g| {qs(g_other, ".4g")}')
    print(f'  {tag}: iteration-count witness: agreement with the plain '
          f'float32 card run: its own second run {agree(it_p.cpu(), it32)}, '
          f'kernel {agree(itk, it32)}, plain float64 '
          f'{agree(it64, it32)}, plain float32 on the CPU {agree(itc, it32)}'
          f'; with the plain float64 run: kernel {agree(itk, it64)}, plain '
          f'float32 on the CPU {agree(itc, it64)}{msg} [{card}]', flush=True)


def check_iso(cfg, skin_fn, wts, bs, fd, inp, gen, card, train=False,
              tag='F iso ', witness=False):
    """Kernel F against `iso_refine_plain` at the main path's two shapes,
    from the main path's march (kernel E with its split) of the rays of
    `inp` in the frame and body of `fd`, with the skinning net `skin_fn`
    and its collapsed layers (wts, bs); phase 1 on the rays the march
    left undiverged (the eval path's mask) or, `train`, on every ray (the
    training path's); its record. With `witness`, the plain solve also
    runs in float64, and the valid flags' and counts' floors are
    `witness_floor`'s."""
    import torch
    from arah_tpu_torch.core.body import unnormalize_canonical_points
    from arah_tpu_torch.ops.iso import (iso_refine, iso_refine_plain,
                                        iso_residual, launch_iso)
    from arah_tpu_torch.ops.march import launch_shape, pack_trace
    from arah_tpu_torch.render.ray_tracing import _march_split
    from arah_tpu_torch.ops.iso_init import iso_init, iso_init_plain
    from arah_tpu_torch.render.renderer import make_sdf_fn
    from arah_tpu_torch.solver.root_find import iso_init_inv_jacobian
    tr = cfg.tracer
    frame = fd.frame
    dirs = inp.ray_dirs
    dev = dirs.device
    cam = inp.cam_loc.expand(dirs.shape).contiguous()
    scale = cfg.skinning.softmax_scale
    sdf_fn = make_sdf_fn(gen)
    with torch.no_grad():
        c = _march_split(tr, sdf_fn, frame, fd.smpl, cam, dirs, inp.near,
                         inp.far, gen)
        x_hat = unnormalize_canonical_points(c.x_norm, frame.coord_min,
                                             frame.coord_max, frame.center)
        J0 = iso_init_inv_jacobian(sdf_fn, skin_fn, frame, dirs, x_hat)
        # the main path's init (the iso init kernel) on the same rays
        Jk = iso_init(x_hat.contiguous(), dirs.contiguous(), wts, bs, frame,
                      gen, scale)
        Jp = iso_init_plain(x_hat, dirs, wts, bs, frame, gen, scale)
        Jw = init_witness(x_hat, dirs, wts, bs, frame, gen, scale)
    u0 = torch.cat([x_hat, c.t[:, None]], dim=-1).contiguous()
    n_rays = dirs.shape[0]
    init_compare(f'{tag}init ({n_rays} rays)', Jk, Jp, Jw, card,
                 (('eager', J0.reshape(n_rays, 16)),))
    del Jk, Jp, Jw
    T0 = c.T_fwd.reshape(n_rays, 16).contiguous()
    J0 = J0.reshape(n_rays, 16).contiguous()
    mask = torch.ones_like(c.diverged) if train \
        else (~c.diverged).contiguous()

    def run(fn, rays, steps):
        return fn(*rays, wts, bs, frame, gen, max_steps=steps,
                  cvg_thresh=tr.root_finding_threshold, softmax_scale=scale)

    def resid_of(rays):
        def resid(sel, u):
            g = iso_residual(rays[0][sel], rays[1][sel], wts, bs, frame, gen,
                             scale)
            with torch.no_grad():
                return torch.linalg.norm(g(u)[0], dim=-1)
        return resid

    packed = pack_trace(gen, wts, bs)
    macs = sum(w.numel() for w in gen.weights) + sum(w.numel() for w in wts)
    flops_ev = 2 * macs + 2 * 24 * 16 + 200
    wbytes = 4 * sum(w.numel() + w.shape[0] for w in list(gen.weights)
                     + list(wts))

    def phase(tag, rays, steps, o):
        n = rays[1].shape[0]
        k = run(iso_refine, rays, steps)
        w = None
        if witness:
            w = iso_refine_plain(
                *f64(rays), *f64((wts, bs, frame, gen)), max_steps=steps,
                cvg_thresh=tr.root_finding_threshold, softmax_scale=scale)
        err = iso_compare(tag, k, o, resid_of(rays), w)
        it_k = torch.zeros((n,), dtype=torch.int32, device=dev)
        shape = launch_shape(n)
        k2 = launch_iso(*rays, frame, packed, steps,
                        tr.root_finding_threshold, scale, shape, iters=it_k)
        same = all(torch.equal(x, y) for x, y in zip(k, k2))
        print(f'  two calls bit-equal {same}; {shape_line("iso", shape, n)}'
              f' [{card}]', flush=True)
        check(same, f'{tag}: two calls of the iso kernel differ')
        check(bool((it_k[k2[3]] == steps).all()), f'{tag}: a ray still '
              f'active at exit ran fewer than {steps} iterations')
        held = None
        if steps > tr.iso_phase1_steps:
            # phase 2 re-solves rays that did not converge in phase 1; those
            # that diverge (|g| >= 1) stop at a step that roundoff sets, so
            # the counts are held on the rays both versions end converged
            # or still active at the cap
            held = (k2[2] & o[2]) | (k2[3] & o[3])
        iters_check(tag, it_k, o[4], held,
                    'both versions end converged or active at the cap',
                    it_w=None if w is None else w[4])
        if held is not None:
            iso_count_witness(tag, rays, wts, bs, frame, gen, steps,
                              tr.root_finding_threshold, scale, it_k, o[4],
                              card)
        shape_sweep(tag, 'iso', n, lambda sh: launch_iso(
            *rays, frame, packed, steps, tr.root_finding_threshold, scale,
            sh), k, card)
        ms = timed(lambda: run(iso_refine, rays, steps), REPS)
        plain_ms = timed(lambda: run(iso_refine_plain, rays, steps), 2)
        # least work: one residual evaluation per unmasked ray at init plus
        # one per Broyden iteration the plain run needed: SIREN and
        # skinning MLP multiply-adds, ~200 flops of softmax, blend and 4x4
        # algebra
        evals = int(rays[5].sum()) + int(o[4].sum())
        b = bound(n * (12 + 12 + 16 + 64 + 64 + 1 + 16 + 64 + 1 + 1)
                  + wbytes, evals * float(flops_ev), PEAK_F32)
        print(f'  F work: {evals} residual evaluations '
              f'({int(o[4].sum()) / n:.3f} iterations per ray, max '
              f'{int(o[4].max())}); {flops_ev} flops each; kernel {ms:.3f} '
              f'ms, plain {plain_ms:.3f} ms, bound {b[0]:.4f} ms [{card}]',
              flush=True)
        return err, ms, plain_ms, b

    p1, cap = tr.iso_phase1_steps, tr.iso_resolve_cap
    rays1 = (cam, dirs, u0, T0, J0, mask)
    o1 = run(iso_refine_plain, rays1, p1)
    err, ms, plain_ms, b = phase(f'{tag}phase 1 ({n_rays} rays, {p1} steps)',
                                 rays1, p1, o1)
    rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound=b,
               src='arah_tpu_torch/csrc/iso.cu',
               rep='arah_tpu/ops/pallas/iso_kernel.py:209')
    # phase 2: the first `cap` rays still active after the plain phase 1,
    # re-solved from scratch at iso_max_steps
    idx = torch.nonzero(o1[3]).flatten()[:cap]
    if idx.numel():
        rays2 = tuple(a[idx] for a in rays1[:5]) \
            + (torch.ones_like(idx, dtype=torch.bool),)
        steps = tr.iso_max_steps
        _, ms2, plain2, b2 = phase(
            f'{tag}phase 2 ({idx.numel()} stragglers of '
            f'{int(o1[3].sum())}, {steps} steps)', rays2, steps,
            run(iso_refine_plain, rays2, steps))
        rec.update(phase2_ms=ms2, phase2_plain_ms=plain2,
                   phase2_bound_ms=b2[0])
    else:
        print(f'{tag}phase 2: no stragglers after phase 1')
        rec.update(phase2_ms=None, phase2_plain_ms=None,
                   phase2_bound_ms=None)
    return rec


INIT_FACTOR = 10   # the init kernel's distance from the float64 witness,
                   # in units of its plain version's (`init_compare`)
INIT_RAYS = (16384, 32768)   # the main path's phase-1 chunks (the eval's)


def init_witness(x_hat, dirs, wts, bs, frame, gen, scale):
    """The iso init's plain version run in float64: `init_compare`'s
    witness."""
    from arah_tpu_torch.ops.iso_init import iso_init_plain
    return iso_init_plain(*f64((x_hat, dirs, wts, bs, frame, gen)), scale)


def init_compare(tag, k, p, w, card, others=()):
    """Hold the init kernel's J_inv0 (k, (N, 16)) against its plain
    version's (p) by their distance from the plain version run in float64
    (w, `init_witness`), row by row: e = max |x - w| / max |w|. Float32
    roundoff in the SIREN's chain, amplified where its gradient cancels and
    by the condition number of the 4x4 M = inv(w), sets how far any float32
    init lies from w, and the plain version shows how far on these rays:
    the kernel must be finite wherever w is, and its median e and its
    largest e / cond(M) must each be at most INIT_FACTOR times the plain
    version's. `others` ((name, J_inv0), ...) are printed beside, not held.
    Returns the kernel's largest e / cond(M)."""
    import torch
    fin = torch.isfinite(w).all(-1)
    wf = w[fin]
    cond = torch.linalg.cond(torch.linalg.inv(wf.reshape(-1, 4, 4)))
    stats, msg = {}, []
    for name, x in (('kernel', k), ('plain', p)) + tuple(others):
        e = (x[fin].double() - wf).abs().amax(-1) / wf.abs().amax(-1)
        e = torch.nan_to_num(e, nan=float('inf'))
        stats[name] = (float(e.median()), float((e / cond).max()))
        msg.append(f'{name} {stats[name][0]:.3e} / {stats[name][1]:.3e}')
    (km, kr), (pm, pr) = stats['kernel'], stats['plain']
    ok = (bool(torch.isfinite(k[fin]).all()) and km <= INIT_FACTOR * pm
          and kr <= INIT_FACTOR * pr)
    print(f'  {tag}: {int((~fin).sum())} rows of the witness not finite; '
          f'cond(M) median {q(cond, 0.5):.1f} p99 {q(cond, 0.99):.1f} max '
          f'{float(cond.max()):.3e}; distance from the float64 witness, '
          f'median e / largest e over cond(M): {", ".join(msg)} (bound '
          f'for the kernel: {INIT_FACTOR}x the plain version) [{card}]',
          flush=True)
    check(ok, f'{tag}: the init kernel lies farther from the float64 '
          'witness than its bound')
    return kr


def check_iso_init(cfg, params, fd, gen, wts, bs, card):
    """The iso init kernel (ops/iso_init.py) against its plain version at
    the main path's shapes: phase 1 at 16,384 and 32,768 rays (fresh rays
    of the bench mix in the frame of `fd`, marched by E with its split as
    `check_iso` builds them) and phase 2 at the first `iso_resolve_cap`
    rays still active after F's phase 1 of the 32,768; each held row by row
    by `init_compare` against the plain version's distance from their
    float64 witness (the eager forward-mode init it replaces,
    `solver/root_find.py:iso_init_inv_jacobian`, printed beside), called
    twice (bit-equal), at every launch
    shape (the same bits), and timed beside its bound, the plain version
    and the eager init. Then F from the kernel's J_inv0 against the plain
    solve from the eager J_inv0, at both phases, by `iso_compare`'s floors.
    Returns the record (the 32,768-ray phase 1's, phase 2's beside it)."""
    import numpy as np
    import torch
    from arah_tpu_torch.core.body import unnormalize_canonical_points
    from arah_tpu_torch.ops.iso import iso_refine, iso_refine_plain, \
        iso_residual
    from arah_tpu_torch.ops.iso_init import (SHAPES, init_shape, iso_init,
                                             iso_init_plain, launch_iso_init,
                                             launch_shape)
    from arah_tpu_torch.ops.march import pack_trace
    from arah_tpu_torch.render.ray_tracing import _march_split
    from arah_tpu_torch.render.renderer import make_sdf_fn, make_skin_fn
    from arah_tpu_torch.scene import scene_inputs
    from arah_tpu_torch.solver.root_find import iso_init_inv_jacobian
    tr = cfg.tracer
    frame = fd.frame
    scale = cfg.skinning.softmax_scale
    sdf_fn, skin_fn = make_sdf_fn(gen), make_skin_fn(params, cfg)
    packed = pack_trace(gen, wts, bs)
    H, L = gen.weights[0].shape[0], len(gen.weights)
    # a ray: the SIREN's hidden products forward and in reverse, the skinning
    # MLP four times (the primal and three tangents), as multiply-adds
    macs = 2 * (3 * H + (L - 2) * H * H) + 4 * sum(w.numel() for w in wts)
    wbytes = 4 * sum(w.numel() + w.shape[0]
                     for w in list(gen.weights) + list(wts))
    rng = np.random.RandomState(21)
    dev = fd.frame.bone_transforms.device
    rec = {}

    def one(tag, x_hat, dirs):
        n = dirs.shape[0]
        with torch.no_grad():
            k = iso_init(x_hat, dirs, wts, bs, frame, gen, scale,
                         packed=packed)
            p = iso_init_plain(x_hat, dirs, wts, bs, frame, gen, scale)
            e = iso_init_inv_jacobian(sdf_fn, skin_fn, frame, dirs,
                                      x_hat).reshape(n, 16)
            w = init_witness(x_hat, dirs, wts, bs, frame, gen, scale)
        worst = init_compare(tag, k, p, w, card, (('eager', e),))
        k2 = iso_init(x_hat, dirs, wts, bs, frame, gen, scale,
                      packed=packed)
        check(torch.equal(k, k2), f'{tag}: two calls differ')
        shape = launch_shape(n)
        for sh in range(len(SHAPES)):
            d = init_shape(sh, n, packed)
            ms_sh = timed(lambda: launch_iso_init(x_hat, dirs, frame, packed,
                                                  scale, sh), REPS)
            same = torch.equal(launch_iso_init(x_hat, dirs, frame, packed,
                                               scale, sh), k)
            taken = ' (taken)' if sh == shape else ''
            print(f'  {tag} launch shape {sh}{taken}: {d["blocks"]} blocks '
                  f'of {d["rays"]} rays, {d["smem"]} B dynamic shared '
                  f'memory, {d["per_sm"]} blocks an SM: {ms_sh:.4f} ms, the '
                  f'same bits {same} [{card}]', flush=True)
            check(same, f'{tag}: launch shape {sh} gives other bits')
        ms = timed(lambda: iso_init(x_hat, dirs, wts, bs, frame, gen, scale,
                                    packed=packed), REPS)
        plain_ms = timed(lambda: iso_init_plain(x_hat, dirs, wts, bs, frame,
                                                gen, scale), REPS)
        eager_ms = timed(lambda: iso_init_inv_jacobian(
            sdf_fn, skin_fn, frame, dirs, x_hat), 2)
        b = bound(n * (12 + 12 + 64) + wbytes, 2.0 * n * macs, PEAK_F32)
        print(f'  {tag}: two calls bit-equal {torch.equal(k, k2)}; kernel '
              f'{ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]}; {2 * macs} flops '
              f'a ray), plain {plain_ms:.3f} ms, the eager init it replaces '
              f'{eager_ms:.3f} ms [{card}]', flush=True)
        return k, dict(max_abs_err=float((k - p).abs().max()), ms=ms,
                       plain_ms=plain_ms, bound=b, eager_ms=eager_ms,
                       worst=worst)

    def resid_of(rays):
        def resid(sel, u):
            g = iso_residual(rays[0][sel], rays[1][sel], wts, bs, frame, gen,
                             scale)
            with torch.no_grad():
                return torch.linalg.norm(g(u)[0], dim=-1)
        return resid

    for n_rays in INIT_RAYS:
        inp = scene_inputs(params, fd, n_rays, rng, dev)
        dirs = inp.ray_dirs
        cam = inp.cam_loc.expand(dirs.shape).contiguous()
        with torch.no_grad():
            c = _march_split(tr, sdf_fn, frame, fd.smpl, cam, dirs, inp.near,
                             inp.far, gen)
            x_hat = unnormalize_canonical_points(
                c.x_norm, frame.coord_min, frame.coord_max, frame.center)
        tag = f'iso init phase 1 ({n_rays} rays)'
        k1, r1 = one(tag, x_hat, dirs)
        rec = r1
        # F from the kernel's J_inv0 against the plain solve from the
        # eager one, as the main path before this kernel ran it
        with torch.no_grad():
            e1 = iso_init_inv_jacobian(sdf_fn, skin_fn, frame, dirs,
                                       x_hat).reshape(n_rays, 16)
        u0 = torch.cat([x_hat, c.t[:, None]], dim=-1).contiguous()
        T0 = c.T_fwd.reshape(n_rays, 16).contiguous()
        mask = (~c.diverged).contiguous()
        p1 = tr.iso_phase1_steps

        def solve(fn, rays, J, steps):
            return fn(*rays[:4], J, rays[4], wts, bs, frame, gen,
                      max_steps=steps, cvg_thresh=tr.root_finding_threshold,
                      softmax_scale=scale)
        rays1 = (cam, dirs, u0, T0, mask)
        o1 = solve(iso_refine_plain, rays1, e1, p1)
        iso_compare(f'F from the init kernel, phase 1 ({n_rays} rays, {p1} '
                    'steps)', solve(iso_refine, rays1, k1, p1), o1,
                    resid_of((cam, dirs)))
        if n_rays != INIT_RAYS[-1]:
            continue
        idx = torch.nonzero(o1[3]).flatten()[:tr.iso_resolve_cap]
        if not idx.numel():
            print('iso init phase 2: no stragglers after phase 1',
                  flush=True)
            rec.update(phase2_ms=None, phase2_plain_ms=None,
                       phase2_bound_ms=None)
            continue
        x2, d2 = x_hat[idx].contiguous(), dirs[idx].contiguous()
        k2, r2 = one(f'iso init phase 2 ({idx.numel()} stragglers)', x2, d2)
        rec.update(phase2_ms=r2['ms'], phase2_plain_ms=r2['plain_ms'],
                   phase2_bound_ms=r2['bound'][0],
                   phase2_eager_ms=r2['eager_ms'])
        with torch.no_grad():
            e2 = iso_init_inv_jacobian(sdf_fn, skin_fn, frame, d2,
                                       x2).reshape(-1, 16)
        cam2 = cam[idx].contiguous()
        rays2 = (cam2, d2, u0[idx].contiguous(), T0[idx].contiguous(),
                 torch.ones_like(idx, dtype=torch.bool))
        steps = tr.iso_max_steps
        iso_compare(f'F from the init kernel, phase 2 ({idx.numel()} rays, '
                    f'{steps} steps)', solve(iso_refine, rays2, k2, steps),
                    solve(iso_refine_plain, rays2, e2, steps),
                    resid_of((cam2, d2)))
    rec.update(src='arah_tpu_torch/csrc/iso_init.cu',
               rep='arah_tpu/solver/root_find.py:134 (XLA; no Pallas '
                   'kernel)')
    return rec


def corr_compare(tag, xk, vk, xp, vp, x_bar, frame, skin_fn,
                 stragglers=None, cvg=1e-5, noise=0.0):
    """Hold a corr kernel's solve (xk, vk) against another (xp, vp):
    valid agreement >= 0.99, median |dx| < 1e-5 on commonly-valid points,
    and every flip (|dx| > 1e-4) a root on both sides (|fwd_skin(x) -
    x_bar| < 2 cvg: each solve's own |g| < cvg, its threshold,
    reassociated here). On stragglers (points still
    active after phase 1, whose outcome at 50 steps roundoff sets)
    `stragglers` is the number of points whose valid flag the same plain
    solve in float64 flips (the witness, d): then every kernel-valid point
    must be a root of the plain residual (< 2 cvg: the kernel's own |g| <
    cvg, reassociated), the kernel may leave at most d fewer points valid
    than the plain solve, and the k points whose flag the kernel flips
    must pass `straggler_count_ok(k, d)` (the kernel's roundoff and the
    witness's each flip about d). `noise` widens both residual bounds for
    a precision whose value at one point moves with the sums' order by
    more than f32's (B's split3 and bf16: an activation rounded to the
    other bf16 neighbour). A solve at
    a relaxed threshold (bf16, cvg 5e-3) stops further from where another
    would: its median bound is cvg / 10. Returns the max |dx| on
    commonly-valid points."""
    import torch
    from arah_tpu_torch.core.body import normalize_canonical_points
    from arah_tpu_torch.core.body import skinning as lbs

    def resid(x_hat, target):
        with torch.no_grad():
            xn = normalize_canonical_points(x_hat, frame.coord_min,
                                            frame.coord_max, frame.center)
            xb, _ = lbs(x_hat, skin_fn(xn), frame.bone_transforms)
        return torch.linalg.norm(xb - target, dim=-1)

    agree = float((vk == vp).double().mean())
    both = vk & vp
    dist = torch.linalg.norm(xk - xp, dim=-1)
    dx = dist[both]
    med = float(dx.median()) if dx.numel() else 0.0
    mx = float(dx.max()) if dx.numel() else 0.0
    p99 = float(torch.quantile(dx[:1 << 24], 0.99)) if dx.numel() else 0.0
    fi = torch.nonzero(both & (dist > 1e-4)).flatten()
    rk, rp = resid(xk[fi], x_bar[fi]), resid(xp[fi], x_bar[fi])
    flip_ok = bool(((rk < 2 * cvg + noise) & (rp < 2 * cvg + noise)).all())
    med_bound = max(1e-5, cvg / 10)
    r_max = float(torch.cat([rk, rp, rk.new_zeros(1)]).max())
    rv = resid(xk[vk], x_bar[vk])
    rv_max = float(rv.max()) if rv.numel() else 0.0
    nk, np_ = int(vk.sum()), int(vp.sum())
    if stragglers is None:
        agree_ok, bound_s, why, ok = agree >= 0.99, '>= 0.990000', '', True
    else:
        k, d = int((vk != vp).sum()), stragglers
        agree_ok = straggler_count_ok(k, d)
        bound_s = (f'flips k {k} <= 2 d + 3 sqrt(k + 4 d) = '
                   f'{2 * d + 3 * (k + 4 * d) ** 0.5:.2f}, d {d}')
        why = (f'; valid kernel bound >= plain - {d} (the float64 '
               f'witness flips {d}); plain residual over '
               f'kernel-valid points bound {2 * cvg + noise:g}')
        ok = rv_max < 2 * cvg + noise and nk >= np_ - d
    print(f'{tag}: valid agreement {agree:.6f} (bound {bound_s}), '
          f'median |dx| {med:.3e} (bound {med_bound:g}), p99 {p99:.3e}, max '
          f'{mx:.3e} on {int(both.sum())} commonly-valid points; '
          f'{fi.numel()} flips (>1e-4) with residual max {r_max:.3e} (bound '
          f'{2 * cvg + noise:g} both sides); valid kernel {nk} plain '
          f'{np_}; plain residual over kernel-valid points max '
          f'{rv_max:.3e}{why}',
          flush=True)
    ok = ok and agree_ok
    check(ok and med < med_bound and flip_ok,
          f'{tag}: corr kernel disagrees with its plain version')
    return mx


def run_render(cfg, params, fd, inp, card, gen, no_tf32):
    """The main path (counted) and the kernels-vs-plain render."""
    import numpy as np
    import torch
    from arah_tpu_torch.data.synthetic import synthetic_smpl
    from arah_tpu_torch.render.renderer import render
    from arah_tpu_torch.scene import N_VERTS, scene_frame, scene_inputs
    from arah_tpu_torch.utils import trace

    dev = inp.ray_dirs.device
    model = synthetic_smpl(n_verts=N_VERTS)
    rng = np.random.RandomState(100)
    frames = [inp] + [scene_inputs(params, scene_frame(model, rng, dev)[0],
                                   RAYS, rng, dev)
                      for _ in range(FRAMES - 1)]
    render(params, cfg, frames[0])              # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trace.reset_counts()
    t0 = time.perf_counter()
    outs = [render(params, cfg, f) for f in frames]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(trace.COUNTS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for i, o in enumerate(outs):
        rgb = o['rgb_values']
        check(bool(torch.isfinite(rgb).all())
              and bool(torch.isfinite(o['weights_sum']).all()),
              f'frame {i}: non-finite output')
        check(bool(((rgb >= 0) & (rgb <= 1)).all()), f'frame {i}: rgb '
              'outside [0, 1]')
        check(tuple(rgb.shape) == (RAYS, 3), f'frame {i}: rgb shape')
        nb = int(o['network_body_mask'].sum())
        check(nb > 0, f'frame {i}: empty network_body_mask')
        check(float(o['weights_sum'].max()) > 0.5, f'frame {i}: black frame')
        print(f'frame {i}: body rays {nb}, surface-converged '
              f'{int(o["surface_converged"].sum())}, valid samples '
              f'{int(o["n_samples_valid"])}, mean rgb '
              f'{float(rgb.mean()):.4f}, mean weights_sum '
              f'{float(o["weights_sum"].mean()):.4f}')
    eval_kernels = ('knn', 'corr', 'shade', 'color_fwd', 'march', 'iso',
                    'iso_init')
    check(all(launches[k] > 0 for k in eval_kernels),
          f'a kernel was not launched on the main path: {launches}')
    ms = wall / len(frames) * 1e3
    print(f'main path: {len(frames)} frames x {RAYS} rays: '
          f'{ms:.1f} ms/frame, {RAYS / (ms / 1e3):.0f} rays/s, peak '
          f'memory {peak:.2f} GiB, launches {launches} [{card}]',
          flush=True)

    profile_frame(lambda: render(params, cfg, frames[0]), ms, card)

    # kernels vs plain, splits off on both sides, rendered in turns (the
    # host's clock varies by ~100 ms between repeats of one frame)
    cfg_k = splits_off(cfg)
    cfg_p = plain_cfg(cfg_k)
    res, t = {}, {'k': [], 'p': []}
    for tag in ('p', 'k', 'k', 'p') * 2:
        no_tf32()
        torch.cuda.synchronize()
        s = time.perf_counter()
        res[tag] = render(params, cfg_k if tag == 'k' else cfg_p, inp)
        torch.cuda.synchronize()
        t[tag].append((time.perf_counter() - s) * 1e3)
    render_gate('render kernels vs plain (splits off)', res['k'], res['p'],
                gen)
    print(f'render splits off, one frame of {RAYS} rays, in turns '
          f'(plain, kernels, kernels, plain) x 2: kernels median '
          f'{float(np.median(t["k"])):.1f} ms {[round(v, 1) for v in t["k"]]}'
          f', plain median {float(np.median(t["p"])):.1f} ms '
          f'{[round(v, 1) for v in t["p"]]} [{card}]', flush=True)

    # the straggler splits, on (the flagship) against off, kernels on both
    # sides, one frame, in turns
    t = {'on': [], 'off': []}
    for tag in ('on', 'off', 'off', 'on') * 2:
        torch.cuda.synchronize()
        s = time.perf_counter()
        res[tag] = render(params, cfg if tag == 'on' else cfg_k, inp)
        torch.cuda.synchronize()
        t[tag].append((time.perf_counter() - s) * 1e3)
    same = float((res['on']['surface_converged']
                  == res['off']['surface_converged']).float().mean())
    print(f'split A/B, kernel render of one frame of {RAYS} rays, in turns '
          f'(on, off, off, on) x 2: splits on median '
          f'{float(np.median(t["on"])):.1f} ms '
          f'{[round(v, 1) for v in t["on"]]}, splits off median '
          f'{float(np.median(t["off"])):.1f} ms '
          f'{[round(v, 1) for v in t["off"]]}; surface agreement {same:.5f}'
          f' [{card}]', flush=True)
    profile_frame(lambda: render(params, cfg_k, inp),
                  float(np.median(t['off'])), card,
                  tag='one frame with the splits off')
    return launches, frames, outs[0]


def render_gate(tag, ok_, op, gen):
    """The render gate of PERF.md §2 between two renders of one frame:
    body-mask agreement > 0.98, rgb median |d| < 1e-2 and depth median
    |d| < 1e-4 on rays both sides keep, and > 0.9 of the rays that flip
    (mask, or depth by > 1e-3) on a valid root (|sdf| < 5e-3) on each
    side that found a surface."""
    import torch
    from arah_tpu_torch.nn.siren import siren_apply
    m_a, m_b = ok_['network_body_mask'], op['network_body_mask']
    both = m_a & m_b
    agree = float((m_a == m_b).float().mean())
    d_rgb = (ok_['rgb_values'] - op['rgb_values']).abs()[both].flatten()
    d_dep = (ok_['surface_depth'] - op['surface_depth']).abs()[both]
    rgb_med = float(d_rgb.median()) if d_rgb.numel() else 0.0
    dep_med = float(d_dep.median()) if d_dep.numel() else 0.0
    flipped = (m_a != m_b) | (both & ((ok_['surface_depth']
                                       - op['surface_depth']).abs() > 1e-3))
    fracs = []
    for o in (ok_, op):
        sel = flipped & o['surface_converged'] & o['network_body_mask']
        if bool(sel.any()):
            with torch.no_grad():
                r = siren_apply(gen, o['surface_points_norm'][sel])[:, 0]
            fracs.append(float((r.abs() < 5e-3).float().mean()))
    fvf = min(fracs) if fracs else 1.0
    print(f'{tag}: mask agreement {agree:.5f} (bound > 0.98), rgb median '
          f'{rgb_med:.3e} (< 1e-2), depth median {dep_med:.3e} (< 1e-4), '
          f'flipped rays {int(flipped.sum())}, flipped_valid_frac {fvf:.4f} '
          f'(> 0.9); surface rays {int(ok_["surface_converged"].sum())} '
          f'against {int(op["surface_converged"].sum())}', flush=True)
    check(agree > 0.98 and rgb_med < 1e-2 and dep_med < 1e-4 and fvf > 0.9,
          f'{tag}: the renders disagree')


def splits_off(cfg):
    """cfg with the straggler splits off (every solve in one pass)."""
    return cfg._replace(tracer=cfg.tracer._replace(
        corr_phase1_steps=0, march_phase1_steps=0, iso_phase1_steps=0))


def plain_cfg(cfg):
    """cfg with every kernel flag off: the plain torch paths (autograd
    for the training gradients, forward-mode tangents for the skinning
    Jacobian)."""
    return cfg._replace(
        use_pallas_shade=False, use_pallas_shade_grad=False,
        idiff_standalone_jac=False,
        color=cfg.color._replace(use_pallas=False),
        tracer=cfg.tracer._replace(use_pallas_knn=False,
                                   use_pallas_corr=False,
                                   use_pallas_march=False,
                                   use_pallas_iso=False))


def ab_cfg(cfg):
    """cfg with the march, iso and corr-init kernel flags off: the
    tracer's unfused loops, which reach J and K under the switch."""
    return cfg._replace(tracer=cfg.tracer._replace(
        use_pallas_march=False, use_pallas_iso=False, use_pallas_knn=False))


@contextlib.contextmanager
def pallas_switch(on=True):
    """`ARAH_ENABLE_PALLAS` set to 1 (or unset) inside, restored after."""
    old = os.environ.pop('ARAH_ENABLE_PALLAS', None)
    if on:
        os.environ['ARAH_ENABLE_PALLAS'] = '1'
    try:
        yield
    finally:
        os.environ.pop('ARAH_ENABLE_PALLAS', None)
        if old is not None:
            os.environ['ARAH_ENABLE_PALLAS'] = old


def run_ab(cfg, params, fd, frames, flagship_out, card, gen, skin_dense,
           no_tf32):
    """Step 5 of the module docstring. Returns (records of J, K and L,
    their launches: J and K over the 3 counted A/B frames, L in the
    counted corr bench)."""
    import numpy as np
    import torch
    from arah_tpu_torch.ops import fused
    from arah_tpu_torch.ops.corr import (corr_search, dense_skin_fn,
                                         launch_corr, pack_corr)
    from arah_tpu_torch.ops.corr_rows import (corr_search_rows,
                                              corr_search_rows_plain)
    from arah_tpu_torch.ops.knn import nn_idx_plain, nn_idx_rows
    from arah_tpu_torch.ops.siren import SHAPES as SIREN_SHAPES
    from arah_tpu_torch.ops.siren import (launch_siren, pack_siren_sdf,
                                          siren_sdf, siren_sdf_plain)
    from arah_tpu_torch.render.ray_tracing import corr_init, trace_and_sample
    from arah_tpu_torch.render.renderer import (make_sdf_fn, make_skin_fn,
                                                render)
    from arah_tpu_torch.utils import bench_corr
    from arah_tpu_torch.utils import trace

    # ---- the inputs J, K and L meet on frame 0 (flagship kernels)
    inp, frame, smpl = frames[0], fd.frame, fd.smpl
    cam = inp.cam_loc.expand(inp.ray_dirs.shape)
    with torch.no_grad():
        tr = trace_and_sample(cfg.tracer, make_sdf_fn(gen),
                              make_skin_fn(params, cfg), frame, smpl, cam,
                              inp.ray_dirs, inp.near, inp.far,
                              skin_dense=skin_dense, sdf_gen=gen)
    s = tr.samples
    xs = {RAYS: tr.surface.points_norm.contiguous(),
          s.points_norm.numel() // 3: s.points_norm.reshape(-1, 3)
          .contiguous()}
    ws = {RAYS: (cam + tr.surface.start_dis[:, None]
                 * inp.ray_dirs).contiguous(),
          s.z_vals.numel(): (cam[:, None, :] + s.z_vals[..., None]
                             * inp.ray_dirs[:, None, :]).reshape(-1, 3)
          .contiguous()}
    verts = smpl.verts_posed
    nv = verts.shape[0]
    macs_j = sum(w.numel() for w in gen.weights)
    recs = {}
    packed_j = pack_siren_sdf(gen)
    for n, x in xs.items():
        no_tf32()
        out = siren_sdf(gen, x, packed_j)
        d = (out - siren_sdf_plain(gen, x)).abs()
        shape_sweep(f'J siren ({n} points)', 'siren', n,
                    lambda sh: (launch_siren(x, packed_j, 1, sh),), (out,),
                    card, shapes=range(len(SIREN_SHAPES)))
        ms = timed(lambda: siren_sdf(gen, x, packed_j), REPS)
        plain_ms = timed(lambda: siren_sdf_plain(gen, x), REPS)
        b = bound(n * 16 + 4 * sum(w.numel() + w.shape[0]
                                   for w in gen.weights),
                  n * 2.0 * macs_j, PEAK_F32)
        print(f'J siren ({n} normalised points of frame 0): max |d| '
              f'{float(d.max()):.3e} (bound {J_TOL:g}), median '
              f'{float(d.median()):.3e}; kernel {ms:.3f} ms (pack outside), '
              f'plain {plain_ms:.3f} ms, bound {b[0]:.4f} ms ({b[1]}) '
              f'[{card}]', flush=True)
        check(float(d.max()) < J_TOL,
              f'siren kernel disagrees with its plain version at {n}')
        recs.setdefault('siren', dict(
            max_abs_err=float(d.max()), ms=ms, plain_ms=plain_ms, bound=b,
            src='arah_tpu_torch/csrc/siren.cu',
            rep='arah_tpu/ops/pallas/siren_kernel.py:54'))
    for n in (1024, 256):               # the plain loops' phase-2 batches
        x = xs[RAYS][:n].contiguous()
        shape_sweep(f'J siren ({n} points)', 'siren', n,
                    lambda sh: (launch_siren(x, packed_j, 1, sh),),
                    (siren_sdf(gen, x, packed_j),), card,
                    shapes=range(len(SIREN_SHAPES)))
    for n, p in ws.items():
        ik, ip = nn_idx_rows(p, verts), nn_idx_plain(p, verts)
        same = bool(torch.equal(ik, ip))
        ms = timed(lambda: nn_idx_rows(p, verts), REPS)
        gms = graph_ms(lambda: nn_idx_rows(p, verts), REPS)
        plain_ms = timed(lambda: nn_idx_plain(p, verts), REPS)
        b = bound(n * 16 + nv * 12, n * nv * 7.0, PEAK_F32)
        print(f'K knn_rows ({n} world points of frame 0, {nv} verts): '
              f'indices equal at every point {same} ({int((ik != ip).sum())}'
              f' differ); kernel {ms:.4f} ms by CUDA events around the '
              f'wrapper ({gms:.4f} ms by graph replay), plain '
              f'{plain_ms:.3f} ms, bound {b[0]:.4f} ms ({b[1]}) [{card}]',
              flush=True)
        check(same, f'knn_rows kernel disagrees with its plain version at '
              f'{n}')
        recs.setdefault('knn_rows', dict(
            max_abs_err=float((ik - ip).abs().max()), ms=ms, graph_ms=gms,
            plain_ms=plain_ms, bound=b, src='arah_tpu_torch/csrc/knn.cu',
            rep='arah_tpu/ops/pallas/knn_kernel.py:42'))
        knn_sweep(f'K knn_rows ({n} world points of frame 0)', p, verts,
                  card)
    for n in (1024, 256):               # the plain loops' phase-2 batches
        p = ws[RAYS][:n].contiguous()
        print(f'K knn_rows ({n} world points of frame 0): kernel '
              f'{timed(lambda: nn_idx_rows(p, verts), REPS):.4f} ms by CUDA '
              f'events around the wrapper '
              f'({graph_ms(lambda: nn_idx_rows(p, verts), REPS):.4f} ms by '
              f'graph replay) [{card}]', flush=True)
        knn_sweep(f'K knn_rows ({n} world points of frame 0)', p, verts,
                  card)

    # ---- L on the frame's corr inputs (single pass, corr_max_steps)
    no_tf32()
    wts, bs, scale = skin_dense
    wts_t = [w.t() for w in wts]
    pts = ws[s.z_vals.numel()]
    with torch.no_grad():
        x_bar, x0, T0 = corr_init(cfg.tracer, frame, smpl, pts)
    flat_mask = s.sample_mask.reshape(-1).contiguous()
    bones16 = frame.bone_transforms.reshape(24, 16).contiguous()
    largs = (x_bar, x0, T0.reshape(-1, 16).contiguous(), flat_mask, wts_t,
             bs, bones16, frame.coord_min, frame.coord_max, frame.center)
    steps = cfg.tracer.corr_max_steps
    lk = corr_search_rows(*largs, max_steps=steps, softmax_scale=scale)
    lp = corr_search_rows_plain(*largs, max_steps=steps, softmax_scale=scale)
    bk = corr_search(*largs[:4], wts, *largs[5:], max_steps=steps,
                     softmax_scale=scale)
    skin_fn = dense_skin_fn(wts, bs, scale)
    n_pts = pts.shape[0]
    corr_compare(f'L corr_rows vs plain ({n_pts} points of frame 0, {steps} '
                 f'steps)', lk[0], lk[2], lp[0], lp[2], x_bar, frame, skin_fn)
    corr_compare('L corr_rows vs B corr (same inputs)', lk[0], lk[2], bk[0],
                 bk[2], x_bar, frame, skin_fn)
    ms_l = timed(lambda: corr_search_rows(*largs, max_steps=steps,
                                          softmax_scale=scale), REPS)
    ms_b = timed(lambda: corr_search(*largs[:4], wts, *largs[5:],
                                     max_steps=steps, softmax_scale=scale),
                 REPS)
    print(f'  L on these inputs: kernel {ms_l:.3f} ms, B {ms_b:.3f} ms '
          f'[{card}]', flush=True)
    del lk, lp, bk, largs, x_bar, x0, T0, tr, s, xs, ws, pts

    # ---- the A/B render: 3 frames counted, one traced
    cfg_ab = ab_cfg(cfg)
    with pallas_switch():
        no_tf32()
        render(params, cfg_ab, frames[0])          # warm-up, not counted
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trace.reset_counts()
        t0 = time.perf_counter()
        outs = [render(params, cfg_ab, f) for f in frames]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(trace.COUNTS)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ms = wall / len(frames) * 1e3
        profile_frame(lambda: render(params, cfg_ab, frames[0]), ms, card,
                      tag='one A/B frame')
    for i, o in enumerate(outs):
        rgb = o['rgb_values']
        check(bool(torch.isfinite(rgb).all()) and tuple(rgb.shape)
              == (RAYS, 3) and bool(o['network_body_mask'].any()),
              f'A/B frame {i}: non-finite, misshapen or empty')
    with pallas_switch():
        no_tf32()
        launch_histograms(
            lambda: [render(params, cfg_ab, f) for f in frames],
            (('J', fused, 'siren_sdf', 1, 'CUDA events'),
             ('K', fused, 'nn_idx_rows', 0, 'graph replay')), card)
    print(f'A/B path (ARAH_ENABLE_PALLAS=1; use_pallas_march, _iso, _knn '
          f'off): {len(frames)} frames x {RAYS} rays: {ms:.1f} ms/frame, '
          f'{RAYS / (ms / 1e3):.0f} rays/s, peak memory {peak:.2f} GiB, '
          f'launches {launches} [{card}]', flush=True)
    check(all(launches[k] > 0 for k in ('siren', 'knn_rows', 'corr',
                                        'shade', 'color_fwd'))
          and all(launches[k] == 0 for k in ('march', 'iso', 'knn')),
          f'the A/B path launched the wrong kernels: {launches}')
    res, t = {}, {'on': [], 'off': []}
    for tag in ('on', 'off', 'off', 'on'):
        with pallas_switch(tag == 'on'):
            no_tf32()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[tag] = render(params, cfg_ab, frames[0])
            torch.cuda.synchronize()
            t[tag].append((time.perf_counter() - t0) * 1e3)
    print(f'A/B render of one frame, in turns (on, off, off, on): switch on '
          f'{[round(v, 1) for v in t["on"]]} ms, off '
          f'{[round(v, 1) for v in t["off"]]} ms [{card}]', flush=True)
    render_gate('A/B render vs its switch-off twin', res['on'], res['off'],
                gen)
    render_gate('A/B render vs the flagship render (E averages tied '
                'weights, the plain march takes the first vertex)',
                outs[0], flagship_out, gen)
    del outs, res
    torch.cuda.empty_cache()

    # ---- L on its path: the corr-variant bench, counted
    no_tf32()
    n_b, dev = BENCH_POINTS, inp.ray_dirs.device
    trace.reset_counts()
    bench = bench_corr.main(['--n', str(n_b), '--iters', '3'], device=dev)
    launches['corr_rows'] = trace.COUNTS['corr_rows']
    check(sorted(bench) == ['chunked', 'dense', 'pallas', 'pallas_t_f32'],
          f'bench_corr ran {sorted(bench)}')
    skin_b, fb, xb, xi, T0b, mb, wb, bb = bench_corr.make_problem(n_b, dev)
    # L's record, every number of it from the bench's own inputs
    err_b = corr_compare(f'L corr_rows vs plain (bench, {n_b} points)',
                         bench['pallas']['x_hat'], bench['pallas']['valid'],
                         bench['dense']['x_hat'], bench['dense']['valid'],
                         xb, fb, skin_b)
    corr_compare('B corr vs plain (bench)', bench['pallas_t_f32']['x_hat'],
                 bench['pallas_t_f32']['valid'], bench['dense']['x_hat'],
                 bench['dense']['valid'], xb, fb, skin_b)
    print(f'  bench corr solve: '
          f'{waste_line(*bench_corr.tile_waste(bench["dense"]["iters"], mb))}'
          f' [{card}]', flush=True)
    bargs = (xb, xi, T0b.reshape(n_b, 16).contiguous(), mb,
             [w.t() for w in wb], bb,
             fb.bone_transforms.reshape(24, 16).contiguous(), fb.coord_min,
             fb.coord_max, fb.center)
    # the kernel's own MLP evaluations (masked points take none: they
    # return x0 and T0); timed with its pack made outside
    packed_b = pack_corr(wb, bb)
    evals = float(corr_slots(
        f'L corr_rows (bench, {n_b} points)', 'corr_rows',
        bargs[:4] + bargs[6:], packed_b, 50, 20.0,
        corr_search_rows(*bargs), bench['dense']['iters'], card)[0])
    macs = sum(w.numel() for w in wb)
    flops_eval = 2 * macs + 4 * sum(w.shape[0] for w in wb[:-1]) \
        + 2 * 24 * 16 + 250
    recs['corr_rows'] = dict(
        max_abs_err=err_b,
        ms=timed(lambda: launch_corr('corr_rows', *bargs[:4], packed_b,
                                     *bargs[6:], 50, 1e-5, 20.0, False),
                 REPS),
        plain_ms=timed(lambda: corr_search_rows_plain(*bargs), 2),
        bound=bound(n_b * (12 + 12 + 64 + 1 + 12 + 64 + 1)
                    + 4 * (macs + 600), evals * flops_eval, PEAK_F32),
        src='arah_tpu_torch/csrc/corr_rows.cu',
        rep='arah_tpu/ops/pallas/corr_kernel.py:257')
    r = recs['corr_rows']
    print(f'L corr_rows on the bench problem ({n_b} points): kernel '
          f'{r["ms"]:.3f} ms, plain {r["plain_ms"]:.3f} ms, bound '
          f'{r["bound"][0]:.4f} ms ({r["bound"][1]}); {evals:.0f} MLP '
          f'evaluations by the kernel (the plain solve: '
          f'{float(bench["dense"]["iters"].float().mean()):.3f} iterations '
          f'per point) [{card}]', flush=True)
    return recs, {k: launches[k] for k in ('siren', 'knn_rows', 'corr_rows')}


def profile_frame(fn, ms_frame, card, tag='one frame'):
    """Device time by kernel over one call of fn (a frame or a step), and
    the share of it the device spent idle: of the traced call's wall
    time, and of the untraced time `ms_frame` (tracing slows the host);
    then the sum over kernels A and K (one name a launch shape). The
    device time is printed twice: over the kernels alone, and with the
    user-annotated device spans added, as this trace read it before it
    told the two apart."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: a CPU op's self device time repeats the
    # time of the kernels it launched, and a user annotation on the device
    # (the optimizer's step) spans its kernels and the gaps between them
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0]
    kernels = [e for e in dev if not getattr(e, 'is_user_annotation', False)]
    spans = sum(e.self_device_time_total for e in dev
                if e not in kernels) / 1e3
    if not kernels:
        print(f'profile of {tag}: the trace holds no device-side events '
              '(device time and idle share not measured)')
        return
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f'profile of {tag}: traced wall {wall_ms:.1f} ms, device '
          f'busy {busy:.1f} ms in {sum(e.count for e in kernels)} kernel '
          f'launches ({busy + spans:.1f} ms with the user-annotated spans, '
          f'{spans:.1f} ms), '
          f'idle share {1 - busy / wall_ms:.3f} of the traced '
          f'run, {1 - busy / ms_frame:.3f} of the untraced '
          f'{ms_frame:.1f} ms [{card}]')
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f'  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  '
              f'{e.key[:90]}')
    grp = [e for e in kernels if 'knn' in e.key]
    print(f'  {sum(e.self_device_time_total for e in grp) / 1e3:9.3f} ms  '
          f'{sum(e.count for e in grp):6d}x  kernels A and K (names holding '
          "'knn')")


@contextlib.contextmanager
def capture_train_kernels():
    """Record the arguments the train step hands kernels G, H and I (the
    wrappers still launch): {'skin_jac': [...], 'shade_bwd': [...],
    'color_bwd': [...]}, one args tuple per call."""
    from arah_tpu_torch.ops import color as ocolor
    from arah_tpu_torch.ops import shade_grad as oshade
    from arah_tpu_torch.render import renderer as rend
    calls = {'skin_jac': [], 'shade_bwd': [], 'color_bwd': []}
    patched = [(rend, 'skinning_jac', 'skin_jac'),
               (oshade, 'shade_bwd', 'shade_bwd'),
               (ocolor, 'color_bwd', 'color_bwd')]
    saved = [getattr(mod, attr) for mod, attr, _ in patched]
    for (mod, attr, name), real in zip(patched, saved):
        def spy(*args, _real=real, _name=name):
            calls[_name].append(args)
            return _real(*args)
        setattr(mod, attr, spy)
    try:
        yield calls
    finally:
        for (mod, attr, _), real in zip(patched, saved):
            setattr(mod, attr, real)


@contextlib.contextmanager
def capture_trace():
    """Record what a train step or an eval render hands kernels A-F (the
    calls still run): {'trace': `renderer.trace_and_sample`, inside which
    A, B, E and F run; 'shade': C's wrapper as `ops/shade_grad.py` (train)
    or `render/renderer.py` (eval) calls it; 'color_fwd': D's as
    `nn/color.py` calls it}, one (args, kwargs, result) a call, in call
    order."""
    from arah_tpu_torch.nn import color as ncolor
    from arah_tpu_torch.ops import shade_grad as oshade
    from arah_tpu_torch.render import renderer as rend
    seen = {'trace': [], 'shade': [], 'color_fwd': []}
    patched = [(rend, 'trace_and_sample', 'trace'),
               (oshade, 'siren_shade', 'shade'),
               (rend, 'siren_shade', 'shade'),
               (ncolor, 'color_mlp_fused', 'color_fwd')]
    saved = [getattr(mod, attr) for mod, attr, _ in patched]
    for (mod, attr, name), real in zip(patched, saved):
        def spy(*args, _real=real, _name=name, **kw):
            out = _real(*args, **kw)
            seen[_name].append((args, kw, out))
            return out
        setattr(mod, attr, spy)
    try:
        yield seen
    finally:
        for (mod, attr, _), real in zip(patched, saved):
            setattr(mod, attr, real)


def check_block_kernels(cfg, params, seen, card, no_tf32,
                        tag='refined', train=True, witness=False):
    """Kernels A-F held against their plain versions, by step 3's checks,
    on what a warm-up step's first block, or an eval render's first chunk
    (`train` False), handed them (`seen` of `capture_trace`; `tag` names
    the run, 'refined', 'cli' or 'cli validate'): A (and every launch
    shape of its body) and B at both phases on the block's samples, C on
    its first two shading calls, D on its colour call, E and F at both
    phases on its rays (F with the training path's mask, every ray, or
    the eval path's; with `witness`, their flags and counts held to a
    float64 witness's floors, `witness_floor`). `params`: the skinning
    net that B and F solve with (the step's collapsed layers)."""
    import torch
    from types import SimpleNamespace
    from arah_tpu_torch.nn.skinning import skinning_dense_params
    from arah_tpu_torch.ops.knn import nn_idx, nn_idx_plain
    from arah_tpu_torch.render.renderer import make_skin_fn
    args, kw, out = seen['trace'][0]
    # a refined frame and rays carry the step's graph: the checks take
    # them detached
    frame, smpl = (type(t)(*(a.detach() for a in t)) for t in args[3:5])
    cam, dirs, near, far = (a.detach() for a in args[5:9])
    gen = kw['sdf_gen']
    z, smask = out.samples.z_vals, out.samples.sample_mask
    pts = (cam[:, None, :] + z[..., None] * dirs[:, None, :]) \
        .reshape(-1, 3).contiguous()
    flat_mask = smask.reshape(-1).contiguous()
    n, verts = pts.shape[0], smpl.verts_posed
    where = "warm-up step's block" if train else "render's chunk"
    print(f'A-F on the {tag} {where} 0: {dirs.shape[0]} rays '
          f'({int((near >= far).sum())} of them outside the box), {n} '
          f'samples ({int(flat_mask.sum())} active)', flush=True)
    no_tf32()
    with torch.no_grad():
        idx_k, idx_p = nn_idx(pts, verts), nn_idx_plain(pts, verts)
    same = bool(torch.equal(idx_k, idx_p))
    print(f'A knn ({tag}, {n} samples): indices equal at every point '
          f'{same} ({int((idx_k != idx_p).sum())} differ)', flush=True)
    check(same, f'knn kernel disagrees with its plain version ({tag})')
    del idx_k, idx_p
    knn_sweep(f'A/K knn ({tag}, {n} samples)', pts, verts, card)
    with torch.no_grad():
        wts, bs = skinning_dense_params(params['skinning'], cfg.skinning)
    no_tf32()
    check_corr(cfg, frame, SimpleNamespace(smpl=smpl), pts, flat_mask, wts,
               bs, card)
    del pts, flat_mask
    for i, (a, k, _) in enumerate(seen['shade'][:2]):
        no_tf32()
        compare_shade(f'C shade ({tag}, call {i}, bf16={k["bf16"]})', a[0],
                      a[1], k['bf16'])
    a, k, _ = seen['color_fwd'][0]
    no_tf32()
    compare_color_fwd(f'D color_fwd ({tag}, bf16={k["bf16"]}, feats '
                      f'{a[3].dtype})', *a[:5], k['skips'], k['bf16'])
    fd = SimpleNamespace(frame=frame, smpl=smpl)
    inp = SimpleNamespace(cam_loc=cam, ray_dirs=dirs, near=near, far=far)
    no_tf32()
    check_march(cfg, fd, inp, gen, card, tag=f'E march ({tag}) ',
                witness=witness)
    no_tf32()
    check_iso(cfg, make_skin_fn(params, cfg), wts, bs, fd, inp, gen, card,
              train=train, tag=f'F iso ({tag}) ', witness=witness)


def off_box_step(s, state, draws, card):
    """One refined step on `s.batch` with each block's patch re-centred
    on the top corner of its frame's box, so that many of its rays miss
    the box, as a patch of the dataset's can at the body's edge: the loss
    and every gradient must stay finite, the perceptual loss > 0."""
    import numpy as np
    import torch
    from arah_tpu_torch.scene import append_patch
    from arah_tpu_torch.train.optim import tree_leaves_with_path
    from arah_tpu_torch.utils.tree import tree_map
    b_, B = s.batch, s.batch.ray_dirs.shape[0]
    n = s.loss_w.n_ray_loss
    base = b_._replace(**{k: getattr(b_, k)[:, :n] for k in (
        'ray_dirs', 'near', 'far', 'rgb_gt', 'body_mask', 'uv')})
    fds = [tree_map(lambda a, _b=b: a[_b], b_.frame) for b in range(B)]
    off = append_patch(base, np.random.RandomState(5), s.loss_w.patch_size,
                       fds, aims=b_.frame.bounds_max)
    miss = [int((off.near[b, n:] >= off.far[b, n:]).sum()) for b in range(B)]
    state, losses = s.step(state, off, draws)
    torch.cuda.synchronize()
    bad = [p for p, v in tree_leaves_with_path(s.params)
           if v.grad is not None and not bool(torch.isfinite(v.grad).all())]
    print(f'refined step with each patch on its box\'s corner ({miss} patch '
          f'rays outside the box): losses '
          f'{ {k: round(float(v), 6) for k, v in losses.items()} }; leaves '
          f'with a non-finite gradient {len(bad)} [{card}]', flush=True)
    check(all(m > 0 for m in miss), 'off-box step: no patch ray outside '
          'the box')
    check(all(bool(torch.isfinite(v)) for v in losses.values()) and not bad
          and float(losses['perceptual_loss']) > 0,
          f'off-box step: losses {losses}, non-finite gradients at {bad}')
    return state


def rel_stats(k, p):
    """(median, p99.9, max) of |k - p| over p's largest magnitude."""
    import torch
    d = (k.float() - p.float()).abs().flatten()
    s = max(float(p.abs().max()), 1e-30)
    return float(d.median()) / s, q(d, .999) / s, float(d.max()) / s


def check_skin_jac(args, card):
    """Kernel G against `skinning_jac_plain` on the step's own points:
    per point, |dJ| over the point's largest |J| must stay < 1e-3, and
    its median < 1e-5 (f32 on both sides, reassociation only)."""
    import torch
    from arah_tpu_torch.ops.skin_jac import skinning_jac, skinning_jac_plain
    from arah_tpu_torch.ops import _build
    from arah_tpu_torch.ops.skin_jac import pack_skin_jac
    x_hat, wts, bs = args[0], args[1], args[2]
    print(f'G shared memory per block: '
          f'{_build.load().arah_skin_jac_smem(pack_skin_jac(wts, bs)[1])} B '
          '(dynamic)', flush=True)
    jk, jp = skinning_jac(*args), skinning_jac_plain(*args)
    same = torch.equal(jk, skinning_jac(*args))
    d = (jk - jp).abs().amax(dim=(1, 2))
    rel = d / jp.abs().amax(dim=(1, 2)).clamp(min=1e-30)
    n = x_hat.shape[0]
    print(f'G skin_jac ({n} points, f32): per-point |dJ| / max|J| median '
          f'{float(rel.median()):.3e} (bound 1e-5) p99.9 {q(rel, .999):.3e}'
          f' max {float(rel.max()):.3e} (bound 1e-3); max |dJ| '
          f'{float(d.max()):.3e}; two calls bit-equal {same}', flush=True)
    check(float(rel.median()) < 1e-5 and float(rel.max()) < 1e-3,
          'skin_jac kernel disagrees with its plain version')
    check(same, 'skin_jac kernel: two calls differ')
    macs = sum(w.numel() for w in wts)
    # the primal and three tangents through the MLP, four bone blends,
    # ~400 flops of softmax tangents and LBS per point
    flops = n * (4 * 2.0 * macs + 4 * 2 * 24 * 16 + 400)
    nbytes = n * (12 + 36) + 4 * (macs + sum(b.numel() for b in bs)
                                  + 24 * 16 + 8)
    return dict(
        max_abs_err=float(d.max()),
        ms=timed(lambda: skinning_jac(*args), REPS),
        plain_ms=timed(lambda: skinning_jac_plain(*args), 2),
        bound=bound(nbytes, flops, PEAK_F32),
        src='arah_tpu_torch/csrc/skin_jac.cu',
        rep='arah_tpu/ops/pallas/corr_kernel_t.py:483')


def shade_bwd_work(gen, n, bf16):
    """(bytes, flops, peak) of kernel H at n points: per point the primal
    and reverse chains, the adjoint sweep and its weight-gradient term,
    the primal backward's weight-gradient term and hbar product (six
    hidden-layer products), ~20 flops of chain algebra per unit."""
    H, din = gen.weights[0].shape
    dout = gen.weights[-1].shape[0]
    nl = len(gen.weights) - 1
    macs = 6 * (nl - 1) * H * H + 5 * din * H + 3 * dout * H
    flops = n * (2.0 * macs + 20 * H * nl)
    leaves = sum(a.numel() for part in gen for a in part)
    nbytes = n * 4 * (din + dout + H + din + din) + 4 * 3 * leaves
    return nbytes, flops, PEAK_BF16 if bf16 else PEAK_F32


def check_shade_bwd(args, card, tol):
    """Kernel H against `shade_bwd_plain` on the step's own inputs and
    cotangents (`tol` for every summed leaf, relative to its largest
    magnitude; per-point dx median < 1e-4 and p99.9 < tol of max |dx|)."""
    import torch
    from arah_tpu_torch.ops.shade_grad import shade_bwd, shade_bwd_plain
    gen, x, bf16 = args[0], args[1], args[5]
    with torch.no_grad():
        dxk, gk = shade_bwd(*args)
        dxk2, gk2 = shade_bwd(*args)
        dxp, gp = shade_bwd_plain(*args)
    same = torch.equal(dxk, dxk2) and all(
        torch.equal(a, b) for lk, lk2 in zip(gk, gk2) for a, b in zip(lk, lk2))
    del dxk2, gk2
    med, p999, dmax = rel_stats(dxk, dxp)
    worst, where, per = 0.0, '', []
    for part, (lk, lp) in enumerate(zip(gk, gp)):
        rs = [rel_stats(a, b)[2] for a, b in zip(lk, lp)]
        per.append(f'{gk._fields[part]} '
                   + ' '.join(f'{r:.1e}' for r in rs))
        for i, r in enumerate(rs):
            if r >= worst:
                worst, where = r, f'{gk._fields[part]}[{i}]'
    n = x.shape[0]
    print(f'H shade_bwd ({n} points, bf16={bf16}): dx |d| / max|dx| median '
          f'{med:.3e} (bound 1e-4) p99.9 {p999:.3e} (bound {tol:g}) max '
          f'{dmax:.3e}; summed leaves: worst max |d| / max|leaf| {worst:.3e}'
          f' at {where} (bound {tol:g}); per leaf: {"; ".join(per)}',
          flush=True)
    print(f'  two calls: dx and every leaf bit-equal {same}', flush=True)
    check(med < 1e-4 and p999 < tol and worst < tol,
          f'shade_bwd kernel (bf16={bf16}) disagrees with its plain version')
    check(same, f'shade_bwd kernel (bf16={bf16}): two calls differ')
    with torch.no_grad():
        ms = timed(lambda: shade_bwd(*args), REPS)
        plain_ms = timed(lambda: shade_bwd_plain(*args), 2)
    nbytes, flops, peak = shade_bwd_work(gen, n, bf16)
    b = bound(nbytes, flops, peak)
    print(f'  kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b[0]:.4f} '
          f'ms ({b[1]}) [{card}]', flush=True)
    return dict(max_abs_err=float((dxk - dxp).abs().max()), ms=ms,
                plain_ms=plain_ms, bound=b,
                src='arah_tpu_torch/csrc/shade_bwd.cu',
                rep='arah_tpu/ops/pallas/shade_grad_kernel.py:175')


def check_color_bwd(args, card, tol):
    """Kernel I against `color_mlp_bwd_plain` on the step's own inputs and
    cotangent: every summed leaf (dW, db, dpose) within `tol` of its
    largest magnitude; per point dsmall and dfeats median < 1e-4 and
    p99.9 < tol of their largest magnitude, then point by point in
    `color_bwd_points`."""
    import torch
    from arah_tpu_torch.ops import _build
    from arah_tpu_torch.ops.color import _pack, color_bwd, color_mlp_bwd_plain
    # the step's call also hands I the forward's bf16 weight pack; the
    # check builds its own, as the wrapper does when it is not given one
    args = args[:9]
    weights, small, feats, pose, bf16 = args[0], args[2], args[3], args[4], \
        args[8]
    meta = _pack(weights, args[1], small.shape[1], feats.shape[1],
                 0 if pose is None else pose.shape[-1], args[6], args[7],
                 bf16, False)[1]
    print(f'I tile kernel shared memory per block: '
          f'{_build.load().arah_color_bwd_smem(meta)} B (dynamic)',
          flush=True)
    with torch.no_grad():
        k = color_bwd(*args)
        k2 = color_bwd(*args)
        p = color_mlp_bwd_plain(*args)
    def flat(r):                       # dW, db, dsmall, dfeats, dpose
        return [*r[0], *r[1], *(a for a in r[2:] if a is not None)]
    same = all(torch.equal(a, b) for a, b in zip(flat(k), flat(k2)))
    del k2
    stats = [rel_stats(a, b) for a, b in zip(k[2:4], p[2:4])]
    leaves = list(zip(k[0], p[0])) + list(zip(k[1], p[1]))
    if k[4] is not None:
        leaves.append((k[4], p[4]))
    rs = [rel_stats(a, b)[2] for a, b in leaves]
    worst = max(rs)
    L = len(weights)
    per = (f'dW {" ".join(f"{r:.1e}" for r in rs[:L])}; db '
           f'{" ".join(f"{r:.1e}" for r in rs[L:2 * L])}'
           + (f'; dpose {rs[-1]:.1e}' if k[4] is not None else ''))
    n = small.shape[0]
    print(f'I color_bwd ({n} points, bf16={bf16}): dsmall |d| / max median '
          f'{stats[0][0]:.3e} p99.9 {stats[0][1]:.3e} max {stats[0][2]:.3e},'
          f' dfeats median {stats[1][0]:.3e} p99.9 {stats[1][1]:.3e} max '
          f'{stats[1][2]:.3e} (bounds 1e-4, {tol:g}); summed leaves: worst '
          f'max |d| / max|leaf| {worst:.3e} (bound {tol:g}); per leaf: '
          f'{per}', flush=True)
    print(f'  two calls: dW, db, dsmall, dfeats and dpose bit-equal {same}',
          flush=True)
    check(all(s[0] < 1e-4 and s[1] < tol for s in stats) and worst < tol,
          f'color_bwd kernel (bf16={bf16}) disagrees with its plain version')
    check(same, f'color_bwd kernel (bf16={bf16}): two calls differ')
    with torch.no_grad():
        color_bwd_points(args, k, p, tol)
    with torch.no_grad():
        ms = timed(lambda: color_bwd(*args), REPS)
        plain_ms = timed(lambda: color_mlp_bwd_plain(*args), 2)
    # least work: the recomputed forward, delta W and the weight gradient
    # per point; the pose row's columns once per call
    S, F = small.shape[1], feats.shape[1]
    P = 0 if pose is None else pose.shape[-1]
    macs_pose = sum(w.shape[0] * P for l, w in enumerate(weights)
                    if l == 0 or l in args[6])
    macs_pt = sum(w.numel() for w in weights) - macs_pose
    flops = n * 6.0 * macs_pt + 6.0 * macs_pose
    nbytes = n * (2 * 4 * S + 2 * feats.element_size() * F + 12) \
        + 4 * 2 * sum(w.numel() for w in weights)
    b = bound(nbytes, flops, PEAK_BF16 if bf16 else PEAK_F32)
    print(f'  kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b[0]:.4f} '
          f'ms ({b[1]}) [{card}]', flush=True)
    return dict(max_abs_err=max(float((a - b).abs().max()) for a, b in
                                leaves + list(zip(k[2:4], p[2:4]))),
                ms=ms, plain_ms=plain_ms, bound=b,
                src='arah_tpu_torch/csrc/color.cu',
                rep='arah_tpu/ops/pallas/color_kernel.py:244')


def color_bwd_points(args, k, p, tol):
    """Kernel I point by point, where `check_color_bwd` bounds only the
    median and p99.9 of dsmall and dfeats. Per slice of CB_CHUNK points,
    `color_bwd_rows` gives the kernel's own recomputed activations and
    deltas, and:
    1. every layer recomputed in plain torch from the kernel's own rows
       of the layer before (its x input, or its delta and ReLU mask)
       matches the kernel's rows to 1e-4 of the layer's largest magnitude,
       and dsmall and dfeats from its deltas match to 1e-4: the chain of
       every point, with no difference carried from one layer to the
       next. Under bf16 the kernel's activation and delta rows are bf16
       values (its tensor-core sums, rounded); a row value on the other
       bf16 neighbour of the recomputed one agrees when the recomputed f32
       value lies within 1e-5 relative of the rounding boundary (the two
       f32 sums differ by reassociation only), and the run prints how
       many values were on the neighbour and how many of them agreed so;
       any other value is held beyond one bf16 step (2^-8 |v|);
    2. the slices' dsmall and dfeats equal those of the full call bit for
       bit (its chunk loop);
    3. against the plain chain run on its own (`k`, `p` at full N), each
       point is put in a class by where kernel and plain part: an
       activation's sign (a ReLU mask), else the bf16 rounding of an
       activation or delta, else nowhere. The points that part nowhere
       hold max |d| < 1e-4 of the largest magnitude, the points whose
       masks agree < `tol`."""
    import torch
    from arah_tpu_torch.ops.color import CB_CHUNK, _parts, color_bwd_rows
    weights, biases, small, feats, pose, g_rgb, skips, squeeze, bf16 = args
    r = (lambda t: t.bfloat16().float()) if bf16 else (lambda t: t)
    n, S = small.shape
    P = 0 if pose is None else pose.shape[-1]
    parts = _parts(weights, S, feats.shape[1], P, skips)
    pose_row = None if pose is None else pose.reshape(1, P).float()
    Wr = [r(w.float()) for w in weights]
    L = len(weights)

    def layer_z(l, x, src):
        z = biases[l].float()
        for name, st, wd in parts[l]:
            a = x if name == 'x' else (pose_row if name == 'pose'
                                       else src[name])
            z = z + r(a) @ Wr[l][:, st:st + wd].T
        return z

    def delta_last(z, g):
        if not squeeze:
            return g
        s = torch.sigmoid(z)
        return g * s * (1.0 - s)

    local = {}

    def hold(name, kv, tv):
        v = float((kv - tv).abs().max()) / max(float(tv.abs().max()), 1e-30)
        local[name] = max(local.get(name, 0.0), v)

    nb = [0, 0]            # row values on the other bf16 neighbour, agreed

    def hold_rows(name, kv, tv):
        """A row the kernel stores rounded under bf16: kv agrees where it
        is tv's rounding or where some value within 1e-5 relative of tv
        rounds to it; elsewhere its excess over one bf16 step (2^-8 |tv|)
        counts, the bound the activation rows had before the products
        moved to the tensor cores (the deltas, f32 rows then, are stored
        rounded since)."""
        if not bf16:
            return hold(name, kv, tv)
        off = kv != r(tv)
        ok = ~off | (r(tv * (1 - 1e-5)) == kv) | (r(tv * (1 + 1e-5)) == kv)
        nb[0] += int(off.sum())
        nb[1] += int((off & ok).sum())
        ex = ((kv - tv).abs() - 2.0 ** -8 * tv.abs()).clamp(min=0)
        v = float(torch.where(ok, 0.0, ex).max()) \
            / max(float(tv.abs().max()), 1e-30)
        local[name] = max(local.get(name, 0.0), v)

    mflip = torch.zeros(n, dtype=torch.bool, device=small.device)
    rflip = torch.zeros_like(mflip)
    same = True
    for c0 in range(0, n, CB_CHUNK):
        sl = slice(c0, min(n, c0 + CB_CHUNK))
        src = {'small': small[sl].float(), 'feats': feats[sl].float()}
        g = g_rgb[sl].float()
        (_, _, dsk, dfk, _), dk, xk = color_bwd_rows(
            weights, biases, small[sl], feats[sl], pose, g, skips, squeeze,
            bf16)
        same = same and torch.equal(dsk, k[2][sl]) \
            and torch.equal(dfk, k[3][sl])
        # 1. each layer from the kernel's own rows of the layer before
        for l in range(L - 1):
            hold_rows(f'x{l + 1}', xk[l + 1],
                      torch.relu(layer_z(l, xk[l], src)))
        hold_rows(f'delta{L - 1}', dk[L - 1],
                  delta_last(layer_z(L - 1, xk[L - 1], src), g))
        dsm, dfe = torch.zeros_like(dsk), torch.zeros_like(dfk)
        for l in range(L - 1, -1, -1):
            for name, st, wd in parts[l]:
                if name == 'pose':
                    continue
                da = r(dk[l]) @ Wr[l][:, st:st + wd]
                if name == 'x':
                    hold_rows(f'delta{l - 1}', dk[l - 1], da * (xk[l] > 0))
                elif name == 'small':
                    dsm += da
                else:
                    dfe += da
        hold('dsmall', dsk, dsm)
        hold('dfeats', dfk, dfe)
        # 3. where the plain chain run on its own parts from the kernel
        xp = [None]
        for l in range(L - 1):
            xp.append(torch.relu(layer_z(l, xp[l], src)))
            mflip[sl] |= ((xk[l + 1] > 0) != (xp[l + 1] > 0)).any(dim=1)
            if bf16:
                rflip[sl] |= (xk[l + 1] != r(xp[l + 1])).any(dim=1)
        dp = delta_last(layer_z(L - 1, xp[L - 1], src), g)
        for l in range(L - 1, -1, -1):
            if bf16:
                rflip[sl] |= (r(dk[l]) != r(dp)).any(dim=1)
            if l > 0:
                st, wd = next((st, wd) for name, st, wd in parts[l]
                              if name == 'x')
                dp = (r(dp) @ Wr[l][:, st:st + wd]) * (xp[l] > 0)
        del dk, xk, xp
    err = torch.maximum(
        (k[2] - p[2]).abs().amax(dim=1) / p[2].abs().max().clamp(min=1e-30),
        (k[3] - p[3]).abs().amax(dim=1) / p[3].abs().max().clamp(min=1e-30))
    exact = ~mflip & ~rflip
    agree = ~mflip

    def top(sel):
        return float(err[sel].max()) if bool(sel.any()) else 0.0
    worst = torch.argsort(err, descending=True)[:10]
    cls = ['mask' if bool(mflip[i]) else ('round' if bool(rflip[i])
                                          else 'none') for i in worst]
    print(f'  I per point: each layer from the kernel\'s own rows, worst '
          f'excess |d| / max {max(local.values()):.3e} (bound 1e-4; '
          + ', '.join(f'{a} {b:.1e}' for a, b in local.items())
          + f'; row values on the other bf16 neighbour {nb[0]}, agreed by '
          f'the 1e-5 rule {nb[1]}'
          + f'); slices bit-equal to the full call: {same}; points whose '
          f'ReLU masks part {int(mflip.sum())}, whose bf16 roundings only '
          f'part {int((rflip & ~mflip).sum())}, none {int(exact.sum())} of '
          f'{n}; max |d| / max over the points that part nowhere '
          f'{top(exact):.3e} (bound 1e-4), whose masks agree '
          f'{top(agree):.3e} (bound {tol:g}), whose masks part '
          f'{top(mflip):.3e}; the 10 worst points part at '
          f'{cls} with {[f"{float(err[i]):.1e}" for i in worst]}',
          flush=True)
    check(max(local.values()) < 1e-4 and same and top(exact) < 1e-4
          and top(agree) < tol,
          f'color_bwd kernel (bf16={bf16}): a point disagrees with its '
          f'plain chain')


def run_train(cfg, params, fd, card, no_tf32):
    """Step 5 of the module docstring. Returns (records of G, H and I,
    the counted step's launches)."""
    import numpy as np
    import torch
    from arah_tpu_torch.data.batch import draw_train_draws
    from arah_tpu_torch.parallel.train_step import trainable
    from arah_tpu_torch.scene import build_train_setup
    from arah_tpu_torch.utils import trace

    dev = fd.verts_cano.device
    s = build_train_setup(cfg, RAYS, scene=(params, fd))
    rng = np.random.RandomState(3)
    draws = [draw_train_draws(rng, cfg, 1, RAYS, dev)
             for _ in range(2 + STEPS)]
    n_reg = s.batch.points_uniform.shape[1]
    print(f'train setup: flagship, 1 block of {RAYS} rays, {n_reg} '
          f'regulariser points, {cfg.n_eik_points} eikonal points; '
          f'LossWeights(n_ray_loss={RAYS}), '
          f'OptimConfig(train_skinning_net=True)', flush=True)

    # ---- the warm-up step; G, H and I against their plain versions on
    # the inputs and cotangents it handed them
    no_tf32()
    with capture_train_kernels() as calls:
        state, losses = s.step(s.state, s.batch, draws[0])
    torch.cuda.synchronize()
    check(bool(torch.isfinite(losses['loss'])), 'warm-up step: loss not '
          'finite')
    # the kernels-vs-plain step starts here: after one update the
    # hypernet's zero-initialised last layers pass gradients to its pose
    # encoder, so every group moves
    p0 = trainable(s.params)
    first = {'skin_jac': 0, 'shade_bwd': 1, 'color_bwd': 2}
    print('  calls in the warm-up step (points): ' + ', '.join(
        f'{k} {[a[first[k]].shape[0] for a in v]}'
        for k, v in calls.items()), flush=True)
    records = {}
    no_tf32()
    records['skin_jac'] = check_skin_jac(calls['skin_jac'][0], card)
    shade_calls = sorted(calls['shade_bwd'], key=lambda a: -a[1].shape[0])
    no_tf32()
    records['shade_bwd'] = check_shade_bwd(shade_calls[0], card, 5e-3)
    for extra in shade_calls[1:]:
        no_tf32()
        check_shade_bwd(extra, card, 5e-3 if extra[5] else 1e-4)
    no_tf32()
    records['color_bwd'] = check_color_bwd(calls['color_bwd'][0], card,
                                           5e-3)
    # I's f32 launch (FMA products on the CUDA cores) on the same inputs
    no_tf32()
    check_color_bwd(calls['color_bwd'][0][:8] + (False,), card, 1e-4)
    del calls, shade_calls
    torch.cuda.empty_cache()

    # ---- the main path: one counted step, then timed steps
    no_tf32()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(1 + STEPS):
        if i == 0:
            trace.reset_counts()
        t0 = time.perf_counter()
        state, losses = s.step(state, s.batch, draws[1 + i])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            launches = dict(trace.COUNTS)
        check(bool(torch.isfinite(losses['loss'])),
              f'train step {i}: loss not finite')
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = float(np.median(times))
    print(f'train main path: {1 + STEPS} steps of 1 block x {RAYS} rays: '
          f'median {ms:.1f} ms/step {[round(v, 1) for v in times]}, '
          f'{RAYS / (ms / 1e3):.0f} rays/s, peak memory {peak:.2f} GiB; '
          f'loss {float(losses["loss"]):.5f}; launches in the counted step '
          f'{launches} [{card}]', flush=True)
    check(all(launches[k] > 0 for k in TRAIN_KERNELS),
          f'a kernel was not launched in the train step: {launches}')
    print(f'  solver launches per step (phase 1 + phase 2 when stragglers '
          f'exist): corr {launches["corr"]}, march {launches["march"]}, iso '
          f'{launches["iso"]}; shade_bwd {launches["shade_bwd"]} (shading + '
          f'eikonal)', flush=True)
    check(launches['shade_bwd'] == 2 and launches['shade'] == 2,
          'the step must run C and H twice (shading and eikonal)')
    profile_frame(lambda: s.step(state, s.batch, draws[1]), ms, card,
                  tag='one train step')
    batch, loss_w = s.batch, s.loss_w
    del state, s
    torch.cuda.empty_cache()
    compare_train_steps(cfg, p0, batch, loss_w, draws[0], card, no_tf32)
    return records, launches


def run_step(cfg, p0, batch, loss_w, draws, no_tf32, step_kw=None):
    """One train step of `cfg` (make_train_step's options `step_kw`) from
    parameters p0 (fresh trainable leaves and optimizer), counted and
    timed: {'losses', 'grads', 'launches', 'ms', 'peak' (GiB), 'moved'
    (path: the step changed the leaf), 'labels' (path: its optimizer
    group)}."""
    import torch
    from arah_tpu_torch.parallel.train_step import (TrainState,
                                                    make_train_step,
                                                    trainable)
    from arah_tpu_torch.train.optim import (OptimConfig, make_optimizer,
                                            tree_leaves_with_path)
    from arah_tpu_torch.utils import trace
    no_tf32()
    p = trainable(p0)
    opt, labels = make_optimizer(OptimConfig(train_skinning_net=True), p)
    step = make_train_step(cfg, loss_w, opt, **(step_kw or {}))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trace.reset_counts()
    t0 = time.perf_counter()
    _, losses = step(TrainState(p, opt, 0), batch, draws)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = dict(trace.COUNTS)
    leaves = dict(tree_leaves_with_path(p))
    moved = {k: bool((v.detach() != v0).any()) for (k, v), (_, v0) in
             zip(leaves.items(), tree_leaves_with_path(p0))}
    grads = {k: None if v.grad is None else v.grad.detach()
             for k, v in leaves.items()}
    del p, opt, step, leaves
    torch.cuda.empty_cache()
    return dict(losses={k: float(v) for k, v in losses.items()},
                grads=grads, launches=launches, ms=ms, peak=peak,
                moved=moved, labels=labels)


def hold_steps(tag, a, b, term_rel, cos_bound, card, atol=1e-12):
    """Two steps' results (`run_step`) held together: every loss term
    within term_rel of its magnitude (+ atol), and the gradient cosine of
    the median and of the least leaf with a gradient on both sides >=
    cos_bound; a's loss finite."""
    import numpy as np
    bad = [(t, v, b['losses'][t]) for t, v in a['losses'].items()
           if abs(v - b['losses'][t]) > term_rel * max(abs(v),
                                                       abs(b['losses'][t]))
           + atol]
    worst = max(abs(v - b['losses'][t]) / max(abs(v), abs(b['losses'][t]),
                                              1e-30)
                for t, v in a['losses'].items())
    cos = []
    for path, ga in a['grads'].items():
        gb = b['grads'][path]
        if ga is None or gb is None:
            continue
        na, nb = float(ga.norm()), float(gb.norm())
        if na > 0 and nb > 0:
            cos.append((float((ga * gb).sum()) / (na * nb), path))
    med = float(np.median([c for c, _ in cos])) if cos else 0.0
    lo = min(cos) if cos else (0.0, None)
    print(f'{tag}: loss terms ' + ', '.join(
        f'{t} {v:.6g} / {b["losses"][t]:.6g}' for t, v in a['losses'].items())
        + f'; worst relative |d| {worst:.3e} (bound {term_rel:g} + '
        f'{atol:g}); gradient cosine over {len(cos)} leaves: median '
        f'{med:.6f}, least {lo[0]:.6f} at {lo[1]} (bound >= {cos_bound}); '
        f'ms {a["ms"]:.1f} / {b["ms"]:.1f} [{card}]', flush=True)
    check(not bad and med >= cos_bound and lo[0] >= cos_bound,
          f'{tag}: the steps disagree {bad}')
    check(np.isfinite(a['losses']['loss']), f'{tag}: loss not finite')


def compare_train_steps(cfg, p0, batch, loss_w, draws, card, no_tf32,
                        step_kw=None, tag_step='train step'):
    """One step with every kernel against one with every plain path
    (splits off on both sides), from the same parameters `p0`, batch and
    draws; `step_kw` are make_train_step's options (the refined step's).
    `hold_steps` at every loss term within 1e-2 of its magnitude (+1e-6)
    and the median and the least per-leaf gradient cosine >= 0.99 (the
    bf16 rounding points differ: autograd of the plain forward rounds
    elsewhere, and Broyden may move a few samples to another root); the
    loss finite, every non-frozen group moved and no frozen leaf moved.
    Returns {tag: run_step's result} for the refined step's own
    checks."""
    import numpy as np
    res = {}
    for tag, c in (('kernels', splits_off(cfg)),
                   ('plain', plain_cfg(splits_off(cfg)))):
        res[tag] = r = run_step(c, p0, batch, loss_w, draws, no_tf32,
                                step_kw)
        print(f'{tag_step} with the {tag} (splits off): {r["ms"]:.1f} ms, '
              f'peak memory {r["peak"]:.2f} GiB, loss '
              f'{r["losses"]["loss"]:.6f} [{card}]', flush=True)
    hold_steps(f'{tag_step}, kernels against the plain paths',
               res['kernels'], res['plain'], 1e-2, 0.99, card, atol=1e-6)
    for tag, r in res.items():
        check(np.isfinite(r['losses']['loss']),
              f'{tag_step} ({tag}): loss not finite')
        groups = {}
        for path, label in r['labels'].items():
            groups.setdefault(label, []).append(r['moved'][path])
        still = [g for g, m in groups.items() if g != 'frozen' and not any(m)]
        moved = sorted(g for g, m in groups.items()
                       if g != 'frozen' and any(m))
        frozen_moved = sum(groups.get('frozen', []))
        print(f'  {tag}: groups moved {moved}, frozen leaves '
              f'{len(groups.get("frozen", []))} of which moved '
              f'{frozen_moved}', flush=True)
        check(not still and frozen_moved == 0,
              f'{tag_step} ({tag}): groups that did not move {still}, '
              f'frozen leaves that moved {frozen_moved}')
    return res


# the refinement leaves; JAX gives the last two no gradient: they reach
# the loss only through the tracer, which runs without gradients (and
# the 'latent' colour pose encoder reads no joint position)
REFINE_MOVED = (('smpl_params', 'root_orient'), ('smpl_params', 'pose_body'),
                ('smpl_params', 'pose_hand'), ('betas',), ('cam_rots',))
REFINE_STILL = (('smpl_params', 'trans'), ('cam_trans',))


def run_refined(cfg, params, fd, card, no_tf32, train_launches):
    """Step 7 of the module docstring. Returns the counted step's
    launches."""
    import numpy as np
    import torch
    from arah_tpu_torch.data.batch import draw_train_draws
    from arah_tpu_torch.parallel.train_step import trainable
    from arah_tpu_torch.scene import PATCH, build_train_setup
    from arah_tpu_torch.utils import trace

    dev = fd.verts_cano.device
    s = build_train_setup(cfg, RAYS, scene=(params, fd), refined=True)
    B, R = s.batch.ray_dirs.shape[:2]
    rng = np.random.RandomState(4)
    draws = [draw_train_draws(rng, cfg, B, R, dev) for _ in range(2 + STEPS)]
    labels = [{int(k): int(v) for k, v in zip(*s.batch.body_mask[b, RAYS:]
                                               .unique(return_counts=True))}
              for b in range(B)]
    miss = [int((s.batch.near[b, RAYS:] >= s.batch.far[b, RAYS:]).sum())
            for b in range(B)]
    print(f'refined setup: flagship, {B} blocks of {RAYS} loss rays and one '
          f'{PATCH}x{PATCH} patch ({R} rays, {R * 64:,} samples a block), '
          f'block b on pose b (latent rows {s.batch.latent_idx.tolist()}); '
          f'patch mask labels {labels}, patch rays outside the box {miss}; '
          f'refine_smpl and refine_cameras on; {s.loss_w}', flush=True)

    no_tf32()
    with capture_train_kernels() as calls, capture_trace() as seen:
        state, losses = s.step(s.state, s.batch, draws[0])  # warm-up
    torch.cuda.synchronize()
    check(bool(torch.isfinite(losses['loss'])), 'refined warm-up step: '
          'loss not finite')
    p0 = trainable(s.params)
    check_block_kernels(cfg, p0, seen, card, no_tf32)
    del seen
    torch.cuda.empty_cache()
    # G, H and I on the first block's inputs: 671,744 points, ten full
    # workspace chunks of H and I (65,536 points) and a part of one
    print(f'  G, H and I on the refined warm-up step\'s block 0 (timed, '
          f'{calls["skin_jac"][0][0].shape[0]} points):', flush=True)
    no_tf32()
    g = check_skin_jac(calls['skin_jac'][0], card)
    print(f'  kernel {g["ms"]:.3f} ms, plain {g["plain_ms"]:.3f} ms, bound '
          f'{g["bound"][0]:.4f} ms ({g["bound"][1]}) [{card}]', flush=True)
    no_tf32()
    check_shade_bwd(max(calls['shade_bwd'], key=lambda a: a[1].shape[0]),
                    card, 5e-3)
    no_tf32()
    check_color_bwd(calls['color_bwd'][0], card, 5e-3)
    del calls
    torch.cuda.empty_cache()

    no_tf32()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(1 + STEPS):
        if i == 0:
            trace.reset_counts()
        t0 = time.perf_counter()
        state, losses = s.step(state, s.batch, draws[1 + i])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            launches = dict(trace.COUNTS)
        check(bool(torch.isfinite(losses['loss'])),
              f'refined step {i}: loss not finite')
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = float(np.median(times))
    print(f'refined main path: {1 + STEPS} steps of {B} blocks x {R} rays: '
          f'median {ms:.1f} ms/step (min {min(times):.1f}, max '
          f'{max(times):.1f}; {[round(v, 1) for v in times]}), '
          f'{B * R / (ms / 1e3):.0f} rays/s, peak memory {peak:.2f} GiB; '
          f'losses { {k: round(float(v), 6) for k, v in losses.items()} } '
          f'[{card}]', flush=True)
    want = {k: B * train_launches[k] for k in TRAIN_KERNELS}
    got = {k: launches[k] for k in TRAIN_KERNELS}
    print(f'  launches in the counted refined step {got}; {B} x the '
          f'one-block step {want}', flush=True)
    check(got == want, f'refined step: launches {got}, expected {want}')
    check(float(losses['perceptual_loss']) > 0,
          'refined step: perceptual loss not > 0')
    profile_frame(lambda: s.step(state, s.batch, draws[1]), ms, card,
                  tag='one refined step')
    state = off_box_step(s, state, draws[2], card)
    batch, loss_w, opts = s.batch, s.loss_w, s.step_options
    del state, s
    torch.cuda.empty_cache()

    res = compare_train_steps(cfg, p0, batch, loss_w, draws[0], card,
                              no_tf32, step_kw=opts,
                              tag_step='refined step')
    for tag, r in res.items():
        v = r['losses']['perceptual_loss']
        check(np.isfinite(v) and v > 0,
              f'refined step ({tag}): perceptual loss {v}')

    def grad(tag, path):
        g = res[tag]['grads'][path]
        return torch.zeros(1, device=dev) if g is None else g
    for path in REFINE_MOVED + REFINE_STILL:
        gk, gp = grad('kernels', path), grad('plain', path)
        nk, npl = float(gk.norm()), float(gp.norm())
        cos = float((gk * gp).sum()) / (nk * npl) if nk and npl else 0.0
        print(f'  refinement leaf {".".join(path)}: |grad| kernels {nk:.4e}, '
              f'plain {npl:.4e}, cosine {cos:.6f}', flush=True)
        if path in REFINE_MOVED:
            check(nk > 0 and npl > 0 and cos >= 0.99,
                  f'refined step: leaf {path} gradient {nk} / {npl}, '
                  f'cosine {cos}')
        else:
            check(nk == 0 and npl == 0,
                  f'refined step: leaf {path} has a gradient ({nk} / '
                  f'{npl}); JAX gives it none')
    return launches



# ---- phase 8: the options (kernel variants and model variants)

def peak_mib(fn):
    """MiB of device memory that one call of fn allocates beyond what was
    allocated before it (its peak)."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def bound_mixed(nbytes, parts):
    """bound() of work whose operations run at several peaks: parts
    [(flops, peak)], their least times added."""
    tb = nbytes / PEAK_BYTES * 1e3
    to = sum(f / pk * 1e3 for f, pk in parts)
    return (tb, 'bytes') if tb >= to else (to, 'operations')


def frame_corr_inputs(cfg, params, fd, inp):
    """Kernel B's inputs on the samples of one eval frame (corr_init):
    (x_bar, x0, T0_16, mask)."""
    import torch
    from arah_tpu_torch.nn.skinning import skinning_dense_params
    from arah_tpu_torch.render.ray_tracing import (corr_init, sample_z_vals,
                                                   sphere_trace)
    from arah_tpu_torch.render.renderer import (generate_sdf, make_sdf_fn,
                                                make_skin_fn)
    with torch.no_grad():
        gen = generate_sdf(params, cfg, inp.rots, inp.Jtrs, inp.geo_latent)
        wts, bs = skinning_dense_params(params['skinning'], cfg.skinning)
        cam = inp.cam_loc.expand(inp.ray_dirs.shape)
        surf = sphere_trace(cfg.tracer, make_sdf_fn(gen),
                            make_skin_fn(params, cfg), fd.frame, fd.smpl,
                            cam, inp.ray_dirs, inp.near, inp.far,
                            eval_mode=True, sdf_gen=gen,
                            skin_dense=(wts, bs, cfg.skinning.softmax_scale))
        z, smask = sample_z_vals(cfg.tracer, ~surf.unconverged,
                                 surf.start_dis, inp.near, inp.far)
        pts = (cam[:, None, :] + z[..., None] * inp.ray_dirs[:, None, :]) \
            .reshape(-1, 3).contiguous()
        x_bar, x0, T0 = corr_init(cfg.tracer, fd.frame, fd.smpl, pts)
    return (x_bar, x0, T0.reshape(-1, 16).contiguous(),
            smask.reshape(-1).contiguous())


# corr_compare's residual noise of B's precisions, in units of cvg. At
# split3 an activation whose sum moves by one f32 ulp with the order of
# the sums can round its lo half (or its hi half) to the other bf16
# neighbour, a step of ~2^-17 of its size, so the kernel's function and
# the plain version's differ at one point by up to ~cvg: on an H100 the
# plain residual over kernel-valid phase-2 points read 2.044e-5 at
# split3 against 1.061e-5 at f32 (PERF.md §6, PR 12). At bf16 an
# activation that rounds to the other neighbour moves the weights through
# the x20 softmax: flipped points' residuals read up to 9.890e-3 at cvg
# 5e-3.
PREC_NOISE = {'f32': 0.0, 'split3': 1.0, 'bf16': 2.0}


def prec_signature(tag, precision, k, p, pf):
    """Kernel B at `precision` follows its plain version at that precision
    and not the f32 solve (pf, same steps and threshold), on the points
    valid in all three. At 'bf16' the roots' median |dx| to the plain
    bf16 solve stays at least 10x below their median |dx| to the plain
    f32 solve (`test_bf16_is_not_the_f32_solve` on the card). 'split3' is
    f32-exact to ~2^-21, so its roots stand ~1e-7 from the f32 solve's,
    the size of the kernel's own roundoff: the kernel's deviation from
    the f32 solve must point where the plain split3 solve's does (cosine
    over all coordinates >= 0.35; by chance ~1/sqrt(3N)), and its mean
    |dx| to the plain split3 solve must stay below that to the f32 solve.
    A stand-in on the CPU (the plain split3 solve with its hidden units
    permuted: the same function, other sums) reads cosine 0.92 and ratio
    0.49; the f32 body there reads 0.12 and 3.5."""
    import torch
    both = k[2] & p[2] & pf[2]
    dk = (k[0] - pf[0])[both].double()
    ds = (p[0] - pf[0])[both].double()
    gap_p = (k[0] - p[0])[both].norm(dim=-1)
    gap_f = dk.norm(dim=-1)
    cos = float((dk * ds).sum() / (dk.norm() * ds.norm()).clamp(min=1e-300))
    if precision == 'bf16':
        a, b = float(gap_p.median()), float(gap_f.median())
        ok, what = 10 * a < b, 'median, bound >= 10x nearer'
    else:
        a, b = float(gap_p.mean()), float(gap_f.mean())
        ok, what = a < b and cos >= 0.35, 'mean, bound nearer; cosine ' \
            'bound >= 0.35'
    print(f'  {tag}: on {int(both.sum())} points valid in the kernel and '
          f'both plain solves, |dx| to the plain {precision} solve '
          f'{a:.3e}, to the plain f32 solve {b:.3e} ({what}); cosine of the '
          f'deviations from the f32 solve, kernel and plain {precision}, '
          f'{cos:.4f}', flush=True)
    check(ok, f'{tag}: B does not follow its precision {precision}')


def check_corr_option(tag, cfg, frame, args, wts, bs, steps, precision,
                      want_jac, cvg, card, stragglers=False):
    """Kernel B with an option against its plain version with it on
    args (x_bar, x0, T0_16, mask): the roots by `corr_compare` (flips
    classified by the residual at `precision`; on `stragglers` with the
    float64 witness of the same plain solve), the active sets (>= 0.999,
    not on stragglers), and with `want_jac` J at the kernel's roots
    against the plain J and against kernel G's (median per-point relative
    |d| <= 1e-5, p99 <= 1e-3). Returns (kernel outputs, evaluations by
    the plain solve, max |d| of J, or of the roots without J)."""
    import torch
    from arah_tpu_torch.ops.corr import (corr_search, corr_search_plain,
                                         dense_skin_fn)
    from arah_tpu_torch.ops.skin_jac import skinning_jac, skinning_jac_plain
    from arah_tpu_torch.solver.root_find import (CanonicalFrame,
                                                 search_canonical_corr)
    scale = 20.0
    n = args[0].shape[0]
    bones16 = frame.bone_transforms.reshape(24, 16).contiguous()
    box = (frame.coord_min, frame.coord_max, frame.center)
    kargs = (*args, wts, bs, bones16, *box)
    kw = dict(max_steps=steps, cvg_thresh=cvg, softmax_scale=scale,
              precision=precision, want_jac=want_jac)
    with torch.no_grad():
        k = corr_search(*kargs, **kw)
        p = corr_search_plain(*kargs, **kw)
    skin_fn = dense_skin_fn(wts, bs, scale, precision)
    flips = None
    cframe = CanonicalFrame(frame.bone_transforms,
                            torch.zeros(3, device=args[0].device), *box)
    with torch.no_grad():
        res = search_canonical_corr(skin_fn, cframe, args[0], args[1],
                                    args[2].reshape(n, 4, 4),
                                    max_steps=steps, cvg_thresh=cvg,
                                    active_init=args[3])
        if stragglers:
            d = torch.float64
            r64 = search_canonical_corr(
                dense_skin_fn([w.to(d) for w in wts], [b.to(d) for b in bs],
                              scale, precision),
                CanonicalFrame(*(t.to(d) for t in cframe)), args[0].to(d),
                args[1].to(d), args[2].reshape(n, 4, 4).to(d),
                max_steps=steps, cvg_thresh=cvg, active_init=args[3])
            flips = int((r64.valid != p[2]).sum())
    err = corr_compare(tag, k[0], k[2], p[0], p[2], args[0], frame,
                       skin_fn, flips, cvg, PREC_NOISE[precision] * cvg)
    if precision != 'f32' and not stragglers:
        with torch.no_grad():
            pf = corr_search_plain(*kargs, **dict(kw, precision='f32',
                                                  want_jac=False))
        prec_signature(tag, precision, k, p, pf)
        del pf
    if not stragglers:
        agree = float((k[3] == p[3]).float().mean())
        print(f'  {tag}: active kernel {int(k[3].sum())} plain '
              f'{int(p[3].sum())}, agreement {agree:.6f} (bound >= 0.999)',
              flush=True)
        check(agree >= 0.999, f'{tag}: the active set disagrees')
    if want_jac:
        with torch.no_grad():
            base = corr_search(*kargs, **dict(kw, want_jac=False))
            same = all(torch.equal(a, b) for a, b in zip(k[:4], base))
            jp = skinning_jac_plain(k[0], wts, bs, cframe, scale, precision)
            jg = skinning_jac(k[0], wts, bs, cframe, scale) \
                if precision == 'f32' else None

        def rel(ref):
            d = (k[4] - ref).abs().amax(dim=(1, 2))
            return d / ref.abs().amax(dim=(1, 2)).clamp(min=1e-30)
        line = f'  {tag}: x, T, valid and active bit-equal to the launch ' \
               f'without J {same}'
        ok = same and bool(torch.isfinite(k[4]).all())
        for name, ref in (('its plain version', jp), ('kernel G', jg)):
            if ref is None:
                continue
            r = rel(ref)
            line += (f'; J against {name} at the kernel\'s roots: per-point '
                     f'relative |d| median {float(r.median()):.3e} (bound '
                     f'1e-5), p99 {q(r, .99):.3e} (1e-3), max '
                     f'{float(r.max()):.3e}')
            ok = ok and float(r.median()) <= 1e-5 and q(r, .99) <= 1e-3
        print(line + f' [{card}]', flush=True)
        check(ok, f'{tag}: J disagrees')
        err = float((k[4] - jp).abs().max())
    return k, int(args[3].sum()) + int(res.iters.sum()), err


def compare_shade_resid(tag, gen, x, bf):
    """Kernel C with bf16 residents at points x, against
    `siren_shade_plain` with the flag: each output's median |d| <= 1e-5
    and p99.9 <= 5e-3 of its largest magnitude (a bf16 product operand
    may round to the other neighbour, so the tail is held at p99.9: the
    features, bit-equal to the f32-resident launch, reach 9.7e-3 at their
    max); its SDF and features bit-equal to the launch with f32
    residents; its normals, the one output the flag moves (~1e-3 of their
    magnitude), at least 10x nearer the plain version with the flag than
    the one without it by median |d| (the mean is set by the points where
    a resident or a product operand rounds to the other bf16 neighbour: a
    resident of a reassociated sine does so far more often than an f32
    one, so the mean stands ~10x nearer only); two calls bit-equal.
    Returns (max |d| of the normals, their median relative |d|)."""
    import torch
    from arah_tpu_torch.ops.shade import siren_shade, siren_shade_plain
    with torch.no_grad():
        k = siren_shade(gen, x, bf16=bf, resid_bf16=True, feat_f32=True)
        k2 = siren_shade(gen, x, bf16=bf, resid_bf16=True, feat_f32=True)
        k0 = siren_shade(gen, x, bf16=bf, feat_f32=True)
        p = siren_shade_plain(gen, x, bf, True, True)
        p0 = siren_shade_plain(gen, x, bf, True, False)
    same2 = all(torch.equal(a, b) for a, b in zip(k, k2))
    same0 = torch.equal(k[0], k0[0]) and torch.equal(k[1], k0[1])
    st = [rel_stats(a, b) for a, b in zip(k, p)]
    ok = all(m <= 1e-5 and t <= 5e-3 for m, t, _ in st)
    near, far = (k[2] - p[2]).abs(), (k[2] - p0[2]).abs()
    print(f'{tag} ({x.shape[0]} points, bf16={bf}): sdf and features '
          f'bit-equal to the f32-resident launch {same0}; against the plain '
          f'version with the flag, relative |d| (median, p99.9, max; bounds '
          f'1e-5, 5e-3) sdf {st[0][0]:.2e} {st[0][1]:.2e} {st[0][2]:.2e}, '
          f'features {st[1][0]:.2e} {st[1][1]:.2e} {st[1][2]:.2e}, normals '
          f'{st[2][0]:.2e} {st[2][1]:.2e} {st[2][2]:.2e}; normals |d| to '
          f'the plain version with the flag (median, mean) '
          f'{float(near.median()):.3e} {float(near.mean()):.3e}, without it '
          f'{float(far.median()):.3e} {float(far.mean()):.3e} (bound: median'
          f' >= 10x nearer); two calls bit-equal {same2}', flush=True)
    check(same0 and same2 and ok
          and 10 * float(near.median()) < float(far.median()),
          f'{tag}: C with bf16 residents disagrees')
    return float((k[2] - p[2]).abs().max()), st[2][0]


def resid_nearer(tag, args, args0):
    """Kernel H with bf16 residents (args) against `shade_bwd_plain` with
    the flag and without it (args0): its dx at least 10x nearer the
    former by median |d| over the points whose dx is not zero (the step
    hands most points a zero cotangent; the flag moves dx by ~5e-4 of its
    magnitude; the mean, as C's, is set by residents that round to the
    other neighbour)."""
    import torch
    from arah_tpu_torch.ops.shade_grad import shade_bwd, shade_bwd_plain
    with torch.no_grad():
        dxk = shade_bwd(*args)[0]
        dxp, dx0 = shade_bwd_plain(*args)[0], shade_bwd_plain(*args0)[0]
        sel = (dxp != 0).any(dim=1) | (dx0 != 0).any(dim=1)
        near, far = (dxk - dxp)[sel].abs(), (dxk - dx0)[sel].abs()
    n = int(sel.sum())
    med = [float(d.median()) if n else 0.0 for d in (near, far)]
    print(f'{tag}: on the {n} of {dxk.shape[0]} points with a non-zero dx, '
          f'|d| to the plain version with the flag (median, mean) '
          f'{med[0]:.3e} {float(near.mean()) if n else 0.0:.3e}, without it '
          f'{med[1]:.3e} {float(far.mean()) if n else 0.0:.3e} (bound: '
          f'median >= 10x nearer)', flush=True)
    check(10 * med[0] < med[1], f'{tag}: H does not follow its flag')


def run_options(cfg, params, fd, card, no_tf32):
    """Phase 8 of the module docstring. Returns (records of the variants,
    their launches on their option's own run)."""
    import numpy as np
    import torch
    from arah_tpu_torch.data.batch import draw_train_draws
    from arah_tpu_torch.nn.siren import fold_film
    from arah_tpu_torch.nn.skinning import skinning_dense_params
    from arah_tpu_torch.ops.corr import corr_search_plain, launch_corr, \
        pack_corr
    from arah_tpu_torch.ops import _build
    from arah_tpu_torch.ops.shade import (pack_shade, siren_shade,
                                          siren_shade_plain)
    from arah_tpu_torch.ops.shade_grad import shade_bwd
    from arah_tpu_torch.parallel.train_step import trainable
    from arah_tpu_torch.render.renderer import (_detached, generate_sdf,
                                                make_skin_fn, render)
    from arah_tpu_torch.scene import build_train_setup, scene_inputs
    from arah_tpu_torch.utils import trace

    dev = fd.verts_cano.device
    records, launches = {}, {}
    s = build_train_setup(cfg, RAYS, scene=(params, fd))
    p0, batch, loss_w = trainable(s.params), s.batch, s.loss_w
    del s
    draws = draw_train_draws(np.random.RandomState(8), cfg, 1, RAYS, dev)
    inp = scene_inputs(params, fd, RAYS, np.random.RandomState(9), dev)
    with torch.no_grad():
        gen = generate_sdf(params, cfg, inp.rots, inp.Jtrs, inp.geo_latent)
        wts, bs = skinning_dense_params(params['skinning'], cfg.skinning)
    H, L = gen.weights[0].shape[0], len(gen.weights)
    print(f'phase 8, the options: flagship, {RAYS} rays, the bench scene '
          f'[{card}]', flush=True)
    with torch.no_grad():
        ref_frame = render(params, cfg, inp)
    base = run_step(cfg, p0, batch, loss_w, draws, no_tf32)

    # ---- shade_resid_bf16: C and H with bf16 residents
    cfg_r = cfg._replace(shade_resid_bf16=True)
    with capture_train_kernels() as calls, capture_trace() as seen:
        r_step = run_step(cfg_r, p0, batch, loss_w, draws, no_tf32)
    launches['shade_resid'] = r_step['launches']['shade_resid']
    launches['shade_bwd_resid'] = r_step['launches']['shade_bwd_resid']
    print(f'resid step launches: C {r_step["launches"]["shade_resid"]} with '
          f'bf16 residents + {r_step["launches"]["shade"]} without (the '
          f'eikonal), H {r_step["launches"]["shade_bwd_resid"]} + '
          f'{r_step["launches"]["shade_bwd"]}', flush=True)
    check(r_step['launches']['shade_resid'] == 1
          and r_step['launches']['shade_bwd_resid'] == 1,
          'resid step: C and H with bf16 residents must run once each')
    a, kw, _ = next(c for c in seen['shade'] if c[1].get('resid_bf16'))
    x_s = a[1]
    no_tf32()
    err_c, _ = compare_shade_resid('C shade resid (the step\'s shading '
                                   'points)', a[0], x_s, kw['bf16'])
    bf = kw['bf16']
    ms_c = timed(lambda: siren_shade(gen, x_s, bf16=bf, resid_bf16=True,
                                     feat_f32=True), REPS)
    ms_c0 = timed(lambda: siren_shade(gen, x_s, bf16=bf, feat_f32=True), REPS)
    plain_c = timed(lambda: siren_shade_plain(gen, x_s, bf, True, True), 2)
    mem_c = [peak_mib(lambda r=r: siren_shade(gen, x_s, bf16=bf,
                                              resid_bf16=r, feat_f32=True))
             for r in (False, True)]
    smem_c = [_build.load().arah_shade_smem(pack_shade(gen, bf, r)[1])
              for r in (False, True)]
    n_s = x_s.shape[0]
    macs_c = 3 * H + (L - 2) * H * H + H
    flops_c = n_s * (2 * macs_c + 2 * ((L - 2) * H * H + 3 * H)
                     + 30 * H * (L - 1))
    b_c = bound(n_s * (12 + 4 + H * 4 + 12)
                + 8 * sum(w.numel() for w in gen.weights), flops_c,
                PEAK_BF16 if bf else PEAK_F32)
    print(f'  C at {n_s} points: bf16 residents {ms_c:.3f} ms, f32 '
          f'residents {ms_c0:.3f} ms, plain {plain_c:.3f} ms; peak memory '
          f'of a call {mem_c[1]:.1f} / {mem_c[0]:.1f} MiB; shared memory a '
          f'block (dynamic) {smem_c[1]} / {smem_c[0]} B [{card}]',
          flush=True)
    records['shade_resid'] = dict(
        max_abs_err=err_c, ms=ms_c, plain_ms=plain_c, bound=b_c,
        src='arah_tpu_torch/csrc/shade.cu',
        rep='arah_tpu/ops/pallas/shade_kernel.py:78')
    h_args = max((c for c in calls['shade_bwd'] if c[6]),
                 key=lambda c: c[1].shape[0])
    no_tf32()
    records['shade_bwd_resid'] = dict(
        check_shade_bwd(h_args, card, 5e-3),
        rep='arah_tpu/ops/pallas/shade_grad_kernel.py:90')
    h0 = h_args[:6] + (False,)
    resid_nearer('H shade_bwd resid (the step\'s inputs)', h_args, h0)
    ms_h0 = timed(lambda: shade_bwd(*h0), REPS)
    mem_h = [peak_mib(lambda a=a: shade_bwd(*a)) for a in (h0, h_args)]
    nl = L - 1
    print(f'  H at {h_args[1].shape[0]} points: bf16 residents '
          f'{records["shade_bwd_resid"]["ms"]:.3f} ms, f32 residents '
          f'{ms_h0:.3f} ms; peak memory of a call {mem_h[1]:.1f} / '
          f'{mem_h[0]:.1f} MiB (its per-block residents: 6 / 8 B a point, '
          f'unit and layer, {nl} layers x {H} units) [{card}]', flush=True)
    del calls, seen
    hold_steps('resid step against the default step (same state, batch, '
               'draws)', r_step, base, 1e-2, 0.99, card)
    with torch.no_grad():
        out_r = render(params, cfg_r, inp)
    render_gate('eval frame with bf16 residents against the default',
                out_r, ref_frame, gen)
    del r_step, out_r
    torch.cuda.empty_cache()

    # ---- shade_pack: the shading stages on the first K valid samples
    cfg_p = cfg._replace(shade_pack=True)
    with torch.no_grad():
        out_p = render(params, cfg_p, inp)
    d_rgb = float((out_p['rgb_values'] - ref_frame['rgb_values']).abs()
                  .max())
    same_m = bool(torch.equal(out_p['network_body_mask'],
                              ref_frame['network_body_mask']))
    tel = {k: int(out_p[k]) for k in ('n_samples_valid', 'n_samples_dense',
                                      'n_samples_shaded',
                                      'n_samples_overflow')}
    print(f'packed eval frame: {tel}; rgb max |d| against the dense frame '
          f'{d_rgb:.3e} (bound 1e-5), body mask equal {same_m}', flush=True)
    check(tel['n_samples_overflow'] == 0 and d_rgb <= 1e-5 and same_m,
          'packed eval frame disagrees with the dense one')
    with capture_train_kernels() as calls, capture_trace() as seen:
        p_step = run_step(cfg_p, p0, batch, loss_w, draws, no_tf32)
    hold_steps('packed step against the dense step', p_step, base, 1e-5,
               0.999, card)
    K = tel['n_samples_shaded']
    print(f'  G, C, H, D and I at K = {K} rows (the packed step\'s inputs):',
          flush=True)
    no_tf32()
    g = check_skin_jac(calls['skin_jac'][0], card)
    print(f'  G at K: kernel {g["ms"]:.3f} ms, plain {g["plain_ms"]:.3f} ms',
          flush=True)
    a, kw, _ = max(seen['shade'], key=lambda c: c[0][1].shape[0])
    no_tf32()
    compare_shade(f'C shade (packed, K rows, bf16={kw["bf16"]})', a[0], a[1],
                  kw['bf16'])
    no_tf32()
    check_shade_bwd(max(calls['shade_bwd'], key=lambda c: c[1].shape[0]),
                    card, 5e-3)
    a, kw, _ = seen['color_fwd'][0]
    no_tf32()
    compare_color_fwd(f'D color_fwd (packed, K rows, bf16={kw["bf16"]})',
                      *a[:5], kw['skips'], kw['bf16'])
    no_tf32()
    check_color_bwd(calls['color_bwd'][0], card, 5e-3)
    del calls, seen
    t = {'dense': [], 'packed': []}
    for tag in ('dense', 'packed', 'packed', 'dense'):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            render(params, cfg_p if tag == 'packed' else cfg, inp)
        torch.cuda.synchronize()
        t[tag].append((time.perf_counter() - t0) * 1e3)
    st = {'dense': [], 'packed': []}
    for tag in ('dense', 'packed', 'packed', 'dense'):
        st[tag].append(run_step(cfg_p if tag == 'packed' else cfg, p0, batch,
                                loss_w, draws, no_tf32)['ms'])
    print(f'  pack A/B in turns (dense, packed, packed, dense): eval frame '
          f'dense {[round(v, 1) for v in t["dense"]]} packed '
          f'{[round(v, 1) for v in t["packed"]]} ms; step dense '
          f'{[round(v, 1) for v in st["dense"]]} packed '
          f'{[round(v, 1) for v in st["packed"]]} ms [{card}]', flush=True)
    for tag, c in (('dense', cfg), ('packed', cfg_p)):
        profile_frame(lambda c=c: run_step(c, p0, batch, loss_w, draws,
                                           no_tf32),
                      float(np.median(st[tag])), card,
                      tag=f'one {tag} step (shade_pack A/B)')
    del p_step, out_p
    torch.cuda.empty_cache()

    # ---- idiff_kernel_jac: J from B's own launch, at both phases
    frame = fd.frame
    args = frame_corr_inputs(cfg, params, fd, inp)
    n_pts = args[0].shape[0]
    p1, p2 = cfg.tracer.corr_phase1_steps, cfg.tracer.corr_max_steps
    no_tf32()
    k1, evals, err_j = check_corr_option(
        f'B corr jac, phase 1 ({n_pts} points, {p1} steps)', cfg, frame,
        args, wts, bs, p1, 'f32', True, 1e-5, card)
    cap = cfg.tracer.corr_resolve_cap
    strag = torch.nonzero(k1[3]).flatten()[:cap]
    del k1
    if strag.numel():
        a2 = tuple(x[strag].contiguous() for x in args[:3]) + (
            torch.ones_like(strag, dtype=torch.bool),)
        no_tf32()
        check_corr_option(f'B corr jac, phase 2 ({strag.numel()} '
                          f'stragglers, {p2} steps)', cfg, frame, a2, wts,
                          bs, p2, 'f32', True, 1e-5, card, stragglers=True)
    pk = pack_corr(wts, bs)
    bones16 = frame.bone_transforms.reshape(24, 16).contiguous()
    box = (frame.coord_min, frame.coord_max, frame.center)

    def launch(packed, jac, cvg=1e-5):
        return launch_corr('corr', *args, packed, bones16, *box, p1, cvg,
                           20.0, True, want_jac=jac)
    ms_j = timed(lambda: launch(pk, True), REPS)
    ms_f = timed(lambda: launch(pk, False), REPS)
    plain_j = timed(lambda: corr_search_plain(
        *args, wts, bs, bones16, *box, max_steps=p1, want_jac=True), 2)
    macs = sum(w.numel() for w in wts)
    f_eval = 2 * macs + 4 * sum(w.shape[0] for w in wts[:-1]) \
        + 2 * 24 * 16 + 250
    f_jac = 4 * 2.0 * macs + 4 * 2 * 24 * 16 + 400
    nbytes = n_pts * (12 + 12 + 64 + 1 + 12 + 64 + 2 + 36) + 4 * macs
    records['corr_jac'] = dict(
        max_abs_err=err_j, ms=ms_j, plain_ms=plain_j,
        bound=bound(nbytes, evals * float(f_eval) + n_pts * f_jac,
                    PEAK_F32),
        src='arah_tpu_torch/csrc/corr_rows.cu',
        rep='arah_tpu/ops/pallas/corr_kernel_t.py:263')
    print(f'  B phase 1 with J {ms_j:.3f} ms, without {ms_f:.3f} ms, plain '
          f'with J {plain_j:.3f} ms; bound with J '
          f'{records["corr_jac"]["bound"][0]:.4f} ms [{card}]', flush=True)
    cfg_j = cfg._replace(idiff_kernel_jac=True)
    j_step = run_step(cfg_j, p0, batch, loss_w, draws, no_tf32)
    launches['corr_jac'] = j_step['launches']['corr_jac']
    print(f'  idiff_kernel_jac step launches: corr_jac '
          f'{j_step["launches"]["corr_jac"]}, corr '
          f'{j_step["launches"]["corr"]}, skin_jac (G) '
          f'{j_step["launches"]["skin_jac"]} (bound 0)', flush=True)
    check(j_step['launches']['skin_jac'] == 0
          and j_step['launches']['corr_jac'] >= 1
          and j_step['launches']['corr'] == 0,
          'idiff_kernel_jac step: G ran, or B ran without J')
    hold_steps('idiff_kernel_jac step against the default step (J from G)',
               j_step, base, 1e-5, 0.99, card)
    del j_step

    # ---- pallas_precision split3 and bf16
    ms_prec = {}
    for prec, cvg in (('split3', 1e-5), ('bf16', 5e-3)):
        no_tf32()
        k1, evals, err_p = check_corr_option(
            f'B corr {prec}, phase 1 ({n_pts} points, {p1} steps, cvg '
            f'{cvg:g})', cfg, frame, args, wts, bs, p1, prec, False, cvg,
            card)
        strag = torch.nonzero(k1[3]).flatten()[:cap]
        del k1
        if strag.numel():
            a2 = tuple(x[strag].contiguous() for x in args[:3]) + (
                torch.ones_like(strag, dtype=torch.bool),)
            no_tf32()
            check_corr_option(f'B corr {prec}, phase 2 ({strag.numel()} '
                              f'stragglers, {p2} steps)', cfg, frame, a2,
                              wts, bs, p2, prec, False, cvg, card,
                              stragglers=True)
        # J through the same rounded products (the variant B runs under
        # idiff_kernel_jac at this precision), at phase 1
        no_tf32()
        check_corr_option(f'B corr jac at {prec}, phase 1 ({n_pts} points)',
                          cfg, frame, args, wts, bs, p1, prec, True, cvg,
                          card)
        pkp = pack_corr(wts, bs, prec)
        ms_prec[prec] = timed(lambda: launch(pkp, False, cvg), REPS)
        plain_p = timed(lambda: corr_search_plain(
            *args, wts, bs, bones16, *box, max_steps=p1, cvg_thresh=cvg,
            precision=prec), 2)
        m0 = wts[0].numel()
        n_bf = (3 if prec == 'split3' else 1) * 2.0 * (macs - m0)
        # B with J at this precision (the variant idiff_kernel_jac runs):
        # J's four chains take the precision's products after layer 0
        ms_jp = timed(lambda: launch(pkp, True, cvg), REPS)
        b_jp = bound_mixed(nbytes, [
            (evals * (f_eval - 2.0 * (macs - m0))
             + n_pts * (f_jac - 4 * 2.0 * (macs - m0)), PEAK_F32),
            ((evals + 4 * n_pts) * n_bf, PEAK_BF16)])
        print(f'  B phase 1 with J at {prec} (cvg {cvg:g}): {ms_jp:.3f} ms, '
              f'without J {ms_prec[prec]:.3f} ms; bound with J '
              f'{b_jp[0]:.4f} ms ({b_jp[1]}) [{card}]', flush=True)
        records[f'corr_{prec}'] = dict(
            max_abs_err=err_p, ms=ms_prec[prec], plain_ms=plain_p,
            bound=bound_mixed(n_pts * (12 + 12 + 64 + 1 + 12 + 64 + 2)
                              + 4 * macs,
                              [(evals * (f_eval - 2.0 * (macs - m0)),
                                PEAK_F32), (evals * n_bf, PEAK_BF16)]),
            src='arah_tpu_torch/csrc/corr_rows.cu',
            rep='arah_tpu/ops/pallas/corr_kernel_t.py:'
                + ('132' if prec == 'split3' else '144'))
        cfg_x = cfg._replace(tracer=cfg.tracer._replace(
            pallas_precision=prec, root_finding_threshold=cvg))
        trace.reset_counts()
        with torch.no_grad():
            out_x = render(params, cfg_x, inp)
        torch.cuda.synchronize()
        launches[f'corr_{prec}'] = trace.COUNTS[f'corr_{prec}']
        print(f'  eval frame at pallas_precision={prec} (cvg {cvg:g}): B '
              f'launches {launches[f"corr_{prec}"]}, valid samples '
              f'{int(out_x["n_samples_valid"])} (f32 frame '
              f'{int(ref_frame["n_samples_valid"])}), body rays '
              f'{int(out_x["network_body_mask"].sum())} [{card}]',
              flush=True)
        check(bool(torch.isfinite(out_x['rgb_values']).all())
              and bool(out_x['network_body_mask'].any())
              and launches[f'corr_{prec}'] >= 1,
              f'eval frame at precision {prec}')
        if prec == 'split3':
            render_gate('eval frame at split3 against f32', out_x,
                        ref_frame, gen)
        del out_x
    print(f'  B phase 1 ({n_pts} points): f32 {ms_f:.3f} ms, split3 '
          f'{ms_prec["split3"]:.3f} ms, bf16 (cvg 5e-3) {ms_prec["bf16"]:.3f}'
          f' ms [{card}]', flush=True)
    del args
    torch.cuda.empty_cache()

    # ---- single_bvp: the bench pose's generated SIREN, FiLM folded in
    params_b = dict(params, sdf_plain=fold_film(_detached(gen)))
    trace.reset_counts()
    with torch.no_grad():
        out_b = render(params_b, cfg, inp)
    torch.cuda.synchronize()
    lb = dict(trace.COUNTS)
    print(f'single_bvp eval frame: launches {lb}', flush=True)
    check(all(lb[k] > 0 for k in ('knn', 'corr', 'shade', 'color_fwd',
                                  'march', 'iso')),
          f'single_bvp frame: a kernel was not launched {lb}')
    render_gate('single_bvp frame against the hypernet frame', out_b,
                ref_frame, gen)
    del out_b
    gen_b = generate_sdf(params_b, cfg, inp.rots, inp.Jtrs, inp.geo_latent)
    no_tf32()
    check_march(cfg, fd, inp, gen_b, card, tag='E march (single_bvp, no '
                'FiLM) ')
    no_tf32()
    check_iso(cfg, make_skin_fn(params, cfg), wts, bs, fd, inp, gen_b, card,
              tag='F iso (single_bvp, no FiLM) ')
    pb = trainable(params_b)
    with capture_train_kernels() as calls, capture_trace() as seen:
        b_k = run_step(splits_off(cfg), pb, batch, loss_w, draws, no_tf32)
    print(f'single_bvp step launches: {b_k["launches"]}', flush=True)
    check(all(b_k['launches'][k] > 0 for k in TRAIN_KERNELS),
          f'single_bvp step: a kernel was not launched {b_k["launches"]}')
    a, kw, _ = max(seen['shade'], key=lambda c: c[0][1].shape[0])
    no_tf32()
    compare_shade(f'C shade (single_bvp, no FiLM, bf16={kw["bf16"]})', a[0],
                  a[1], kw['bf16'])
    no_tf32()
    check_shade_bwd(max(calls['shade_bwd'], key=lambda c: c[1].shape[0]),
                    card, 5e-3)
    del calls, seen
    b_p = run_step(plain_cfg(splits_off(cfg)), pb, batch, loss_w, draws,
                   no_tf32)
    hold_steps('single_bvp step, kernels against its plain-path twin', b_k,
               b_p, 1e-2, 0.99, card)
    return records, launches


# ---- phase 9: the CLIs on the fake ZJU dataset

CLI_FRAMES = 4          # fixture frames, views 1 and 7, 1024 x 1024
CLI_KERNELS_EVAL = ('knn', 'corr', 'shade', 'color_fwd', 'march', 'iso',
                    'iso_init')
# the plain versions of A-I (and the tracer's plain loops): none may run
# on the card's path
PLAIN_FNS = ('nn_idx_plain', 'corr_search_plain', 'siren_shade_plain',
             'color_mlp_plain', 'color_mlp_bwd_plain', 'sphere_march_plain',
             'iso_refine_plain', 'skinning_jac_plain', 'shade_bwd_plain',
             '_march_plain', 'search_iso_surface_depth', 'siren_sdf_plain',
             'iso_init_plain', 'iso_init_inv_jacobian')


@contextlib.contextmanager
def count_plain():
    """Count the calls of every plain version (PLAIN_FNS), wherever a
    module of the port holds one, while the block runs: {name: calls}."""
    calls = {n: 0 for n in PLAIN_FNS}
    saved = []
    for mod in [m for k, m in list(sys.modules.items())
                if k.startswith('arah_tpu_torch') and m is not None]:
        for name in PLAIN_FNS:
            real = getattr(mod, name, None)
            if real is None:
                continue

            def spy(*a, _real=real, _name=name, **k):
                calls[_name] += 1
                return _real(*a, **k)
            saved.append((mod, name, real))
            setattr(mod, name, spy)
    try:
        yield calls
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)


def cli_config(path, base, data, out, model=None, data_keys=None,
               **training):
    """A config that inherits `base` with the fixture's paths, the given
    `data_keys` and `model` keys (dicts of YAML values) and `training`
    keys."""
    lines = [f'inherit_from: {base}', 'data:', f'  path: {data}',
             f'  smpl_misc: {data}/body_models/misc'] + [
        f'  {k}: {v}' for k, v in (data_keys or {}).items()] + [
        'model:'] + [
        f'  {k}: {v}' for k, v in (model or {}).items()] + [
        'training:', f'  out_dir: {out}'] + [f'  {k}: {v}'
                                             for k, v in training.items()]
    with open(path, 'w') as f:
        f.write('\n'.join(lines) + '\n')
    return path


@contextlib.contextmanager
def time_steps():
    """The host-clock seconds between the starts of consecutive steps of
    the train steps `train/trainer.py` makes while the block runs (the
    loader's and the validation's waits included): a list."""
    from arah_tpu_torch.train import trainer
    gaps, real = [], trainer.make_train_step

    def spy(*a, **k):
        step, last = real(*a, **k), []

        def timed_step(*sa):
            now = time.perf_counter()
            if last:
                gaps.append(now - last[0])
            last[:] = [now]
            return step(*sa)
        return timed_step
    trainer.make_train_step = spy
    try:
        yield gaps
    finally:
        trainer.make_train_step = real


def run_cli(fn, argv):
    """fn(argv) in this process with its standard output captured (and
    printed, indented); returns the output."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    out = buf.getvalue()
    for line in out.splitlines():
        print(f'    | {line}')
    return out


def reference_state_dict(params):
    """A reference-layout (ARAH Lightning) `state_dict` under `model.`,
    built from a port parameter tree `params` (`model.init_model_params`
    at a config's shapes): each leaf under the reference's key, so that
    `train/checkpoints.py:convert_model_state_dict` gives `params` back
    (the converter's inverse; the last SIREN layer has no
    `hypo_params_init`, as in the reference, and converts to zeros). CPU
    tensors; imports no JAX (the CPU tests use it too)."""
    sd = {}

    def put(key, v, shape=None):
        v = v.detach().to('cpu', copy=True)
        sd['model.' + key] = v if shape is None else v.reshape(shape)

    def fc(prefix, block):
        for j, h in enumerate(block['hidden']):
            put(f'{prefix}net.{j}.net.0.weight', h['lin']['w'])
            put(f'{prefix}net.{j}.net.0.bias', h['lin']['b'])
            put(f'{prefix}net.{j}.net.1.weight', h['ln']['gamma'])
            put(f'{prefix}net.{j}.net.1.bias', h['ln']['beta'])
        n = len(block['hidden'])
        put(f'{prefix}net.{n}.weight', block['last']['w'])
        put(f'{prefix}net.{n}.bias', block['last']['b'])

    def pose_encoder(prefix, pe):
        put(f'{prefix}layer_0.weight', pe['layer_0']['w'])
        put(f'{prefix}layer_0.bias', pe['layer_0']['b'])
        for j, lyr in enumerate(pe['layers']):
            for k, fcn in (('0', 'fc1'), ('2', 'fc2')):
                put(f'{prefix}layers.{j}.{k}.weight', lyr[fcn]['w'])
                put(f'{prefix}layers.{j}.{k}.bias', lyr[fcn]['b'])

    def wn(prefix, layers):
        for l, lyr in enumerate(layers):
            if 'v' in lyr:
                put(f'{prefix}lin{l}.weight_v', lyr['v'])
                put(f'{prefix}lin{l}.weight_g', lyr['g'], (-1, 1))
            else:
                put(f'{prefix}lin{l}.weight', lyr['w'])
            put(f'{prefix}lin{l}.bias', lyr['b'])

    hn = params['hypernet']
    n = len(hn['hyper_layers'])
    for i, block in enumerate(hn['hyper_layers']):
        base = f'sdf_decoder.net.layers.{i}.' + (
            'hyper_linear.' if i < n - 1 else '')
        fc(base + 'hypo_params.', block)
        if i < n - 1:
            put(base + 'hypo_params_init', hn['hypo_init'][i], (1, -1))
    if 'mapping' in hn:
        net = 'sdf_decoder.net.mapping_network.network.'
        for idx, lin in zip((0, 2, 4), hn['mapping']['lins']):
            put(f'{net}{idx}.weight', lin['w'])
            put(f'{net}{idx}.bias', lin['b'])
        put(f'{net}6.weight', hn['mapping']['last']['w'])
        put(f'{net}6.bias', hn['mapping']['last']['b'])
    if 'pose_encoder' in hn:
        pose_encoder('sdf_decoder.pose_encoder.', hn['pose_encoder'])
    wn('skinning_model.skinning_decoder_fwd.', params['skinning']['layers'])
    wn('color_decoder.', params['color']['layers'])
    if 'pose_encoder' in params['color']:
        pose_encoder('color_decoder.pose_encoder.',
                     params['color']['pose_encoder'])
    put('deviation_decoder.variance', params['deviation']['variance'], ())
    if 'latent' in params:
        put('latent.weight', params['latent'])
    for k in ('cam_rots', 'cam_trans'):
        if k in params:
            put(k, params[k])
    return sd


def write_pretrained(tmp, scene, cfg):
    """The fitted scene's SIREN and skinning net as the reference's
    pretrained checkpoints (a MetaAvatar `decoder.net.net.<i>.0` state
    dict and a SNARF `skinning_decoder_fwd.lin<l>` one), which the
    config's `model.geometry_net` and `model.skinning_net2` load through
    `train/checkpoints.py`'s converters. Returns their model keys."""
    import torch
    from arah_tpu_torch.nn.hypernet import siren_layer_dims
    geo = {}
    for i, ((d_in, d_out), h) in enumerate(zip(
            siren_layer_dims(cfg.hypernet), scene['hypernet']['hypo_init'])):
        h = h.detach().cpu()
        geo[f'decoder.net.net.{i}.0.weight'] = h[:d_in * d_out].reshape(
            d_out, d_in)
        geo[f'decoder.net.net.{i}.0.bias'] = h[d_in * d_out:]
    skin = {}
    for l, lyr in enumerate(scene['skinning']['layers']):
        pre = f'skinning_decoder_fwd.lin{l}.'
        names = {'v': 'weight_v', 'g': 'weight_g', 'w': 'weight', 'b': 'bias'}
        for k, v in lyr.items():
            skin[pre + names[k]] = v.detach().cpu()
    paths = {'geometry_net': os.path.join(tmp, 'metaavatar.pt'),
             'skinning_net2': os.path.join(tmp, 'snarf.pt')}
    torch.save({'model': geo}, paths['geometry_net'])
    torch.save({'model': skin}, paths['skinning_net2'])
    return paths


def run_clis(card, no_tf32, scene, tmp):
    """Phase 9 of the module docstring: the fixture, `cli.train` (2
    epochs, a resumed third, a job-chained subprocess that must exit with
    code 2), `cli.validate --novel-view`, A-F against their plain
    versions on the validation render's first chunk and A-I at the CLI
    step's shapes, and the CLI layer's times. The model starts from
    `scene`'s fitted SIREN and skinning net (phase 2), given to the
    config as pretrained checkpoints, so that the avatar has a surface.
    Writes under the directory `tmp`. Returns ({kernel: launches in the
    2-epoch train run}, {'cfg': the config's path, 'pre': the pretrained
    checkpoints' model keys, 'data': the fixture's root})."""
    import numpy as np
    import torch
    from arah_tpu_torch.cli import train as cli_train
    from arah_tpu_torch.cli import validate as cli_validate
    from arah_tpu_torch.config.factory import (get_dataset,
                                               init_params_from_cfg)
    from arah_tpu_torch.config.loader import (default_config_path,
                                              load_config,
                                              model_config_from_cfg)
    from arah_tpu_torch.data.fake_dataset import make_fake_zju_dataset
    from arah_tpu_torch.eval.evaluator import evaluate_frame
    from arah_tpu_torch.parallel.train_step import TrainState
    from arah_tpu_torch.train import checkpoints as ckpt_lib
    from arah_tpu_torch.utils import trace

    repo = os.path.dirname(os.path.abspath(__file__))
    base = os.path.join(repo, 'configs', 'fake', 'FAKE-ZJU-flagship.yaml')
    img_size = 1024
    data = os.path.join(tmp, 'data')
    t0 = time.perf_counter()
    make_fake_zju_dataset(data, n_frames=CLI_FRAMES, views=('1', '7'),
                          img_size=img_size)
    print(f'phase 9: fake ZJU fixture ({CLI_FRAMES} frames, views 1 and '
          f'7, {img_size} x {img_size}, 1,024 vertices) written in '
          f'{time.perf_counter() - t0:.2f} s', flush=True)
    out = os.path.join(tmp, 'out')
    pre = write_pretrained(tmp, scene, model_config_from_cfg(
        load_config(base, default_config_path())))
    cfg_path = cli_config(os.path.join(tmp, 'cfg.yaml'), base, data, out,
                          pre, max_epochs=2, checkpoint_every_n_epochs=1,
                          validate_every_n_epochs=1)

    # ---- cli.train, 2 epochs, counted
    launches, ms = cli_train_counted('FAKE-ZJU', card, no_tf32, cfg_path)
    ck = os.path.join(out, 'checkpoints')
    for f in ('metrics.tsv', 'val_metrics.tsv', 'checkpoints/LAST',
              'checkpoints/META.json', 'checkpoints/BEST.json'):
        check(os.path.exists(os.path.join(out, f)),
              f'cli.train did not write {f}')
    with open(os.path.join(ck, 'META.json')) as f:
        meta = json.load(f)
    check(meta['epoch'] == 2, f'cli.train META.json {meta}')
    # the run repeats: its draws are a function of the seed (each batch's
    # generator, `Prefetcher(seed=...)`, and trainer.py:step_rng), so this
    # digest is the same run after run
    digest = tree_digest(torch.load(os.path.join(ckpt_lib.step_dir(
        ck, meta['step']), 'state.pt'), weights_only=False)['params'])
    print(f'phase 9 checkpoint after 2 epochs (step {meta["step"]}): '
          f'parameters sha256 {digest}', flush=True)

    # ---- the rerun resumes and trains one more epoch
    more = cli_config(os.path.join(tmp, 'more.yaml'), base, data, out,
                      pre, max_epochs=3, checkpoint_every_n_epochs=1)
    text = run_cli(cli_train.main, [more])
    check(f'resumed from step {meta["step"]} (epoch 2)' in text,
          'cli.train rerun did not resume')
    with open(os.path.join(ck, 'META.json')) as f:
        meta3 = json.load(f)
    check(meta3['epoch'] == 3 and meta3['step'] > meta['step'],
          f'cli.train rerun META.json {meta3}')

    # ---- job chaining in a subprocess: --exit-after gives code 2
    chain = cli_config(os.path.join(tmp, 'chain.yaml'), base, data,
                       os.path.join(tmp, 'out_chain'), pre,
                       max_epochs=50)
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, '-m', 'arah_tpu_torch.cli.train', chain,
         '--exit-after', '1', '--epochs-per-run', '50'],
        cwd=repo, capture_output=True, text=True, timeout=600)
    print(f'cli.train --exit-after 1 --epochs-per-run 50 (subprocess): '
          f'exit code {r.returncode} in {time.perf_counter() - t0:.1f} s; '
          f'{r.stdout.strip().splitlines()[-1:]}', flush=True)
    check(r.returncode == 2, f'cli.train --exit-after: exit code '
          f'{r.returncode}, not 2: {r.stderr[-2000:]}')

    # ---- cli.validate --novel-view, counted
    no_tf32()
    trace.reset_counts()
    with count_plain() as plain:
        run_cli(cli_validate.main, [cfg_path, '--novel-view'])
    torch.cuda.synchronize()
    vl = dict(trace.COUNTS)
    with open(os.path.join(out, 'val', 'metrics.json')) as f:
        mean = json.load(f)['mean']
    print(f'cli.validate --novel-view: {mean}; launches '
          f'{ {k: vl[k] for k in CLI_KERNELS_EVAL} }, plain calls '
          f'{plain} [{card}]', flush=True)
    check(all(vl[k] > 0 for k in CLI_KERNELS_EVAL),
          f'cli.validate: a kernel of A-F was not launched: {vl}')
    check(not any(plain.values()), f'cli.validate: plain versions ran: '
          f'{plain}')
    check(all(np.isfinite(mean[k]) for k in ('psnr', 'ssim'))
          and any(k.startswith('lpips') and np.isfinite(v)
                  for k, v in mean.items()),
          f'cli.validate: metrics not finite: {mean}')

    # ---- the CLI layer's times: loader s/item, validation s/frame
    cfg = load_config(cfg_path, default_config_path())
    model_cfg = model_config_from_cfg(cfg)
    ds = get_dataset('train', cfg)
    n_ray = ds.num_fg_samples + ds.num_bg_samples
    item_s, dec_ms, _ = loader_times(ds)
    # the validation's frames and trained parameters, as
    # `cli/validate.py` makes them (every frame's latent in range)
    val_ds = get_dataset('val', cfg, subsampling_rate=30)
    vparams = init_params_from_cfg(0, cfg, model_cfg, ds, mode='val',
                                   device='cuda')
    _, vstep = ckpt_lib.restore_checkpoint(
        os.path.join(out, 'checkpoints'), TrainState(vparams, None, 0))
    check(vstep == meta3['step'], f'validation restored step {vstep}')
    val_items = [val_ds[i] for i in range(len(val_ds))]

    def latent(item):
        return vparams['latent'][int(item['inputs.data_idx'])]

    # ---- A-F against their plain versions on what the validation
    # render's first chunk hands them (its own chunk of rays)
    no_tf32()
    with capture_trace() as seen:
        evaluate_frame(vparams, model_cfg, val_items[0],
                       latent(val_items[0]))
    torch.cuda.synchronize()
    check_block_kernels(model_cfg, vparams, seen, card, no_tf32,
                        tag='cli validate', train=False, witness=True)
    del seen
    torch.cuda.empty_cache()
    val_s = []     # each frame three times
    for item in val_items * 3:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaluate_frame(vparams, model_cfg, item, latent(item))
        torch.cuda.synchronize()
        val_s.append(time.perf_counter() - t0)
    v0 = val_ds[0]
    n_box = int(v0['inputs.image_mask'].sum())
    hw = f'{int(v0["inputs.img_height"])} x {int(v0["inputs.img_width"])}'
    print(f'CLI layer: ms/step median {np.median(ms):.1f} (min '
          f'{ms.min():.1f}, max {ms.max():.1f}; wall time between '
          f'step starts over {len(ms) + 1} steps of 2 blocks x '
          f'{n_ray} rays, loading and validation waits included); loader '
          f'{item_s:.3f} s/item median ({len(ds)} train items, one '
          f'thread), of which JPEG decode of a {img_size} x {img_size} '
          f'frame {dec_ms:.1f} ms; '
          f'validation {np.median(val_s):.3f} s/frame median (min '
          f'{min(val_s):.3f}, max {max(val_s):.3f}; {len(val_items)} '
          f'frames x 3 of {n_box} box rays at {hw}) [{card}]', flush=True)

    # ---- A-I against their plain versions at the CLI step's shapes,
    # and one traced step
    step, state, batch, draws = hold_cli_step('cli', cfg, ds, card, no_tf32)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        state, losses = step(state, batch, draws)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    print(f'CLI step alone (a fixed batch, no loader): '
          f'{[round(t, 1) for t in times]} ms [{card}]', flush=True)
    profile_frame(lambda: step(state, batch, draws),
                  float(np.median(times)), card,
                  tag='one CLI train step')
    return launches, {'cfg': cfg_path, 'pre': pre, 'data': data}


# ---- phase 10: the novel-pose test CLI, the H36M and People-Snapshot CLIs

CLI_TEST_KERNELS = CLI_KERNELS_EVAL + ('siren',)
MESH_RES = 256          # cli.test's default: 64 launches of J a frame
# cli.test's frames: the host meshes a trained checkpoint's tens of
# millions of faces at ~30-75 s a frame (PERF.md §5)
TEST_FRAMES = 2


def read_parts(text):
    """{part: [seconds a frame]} from `cli.test`'s '[i/n] rendered (part
    t s, ...)' lines."""
    import re
    parts = {}
    for m in re.finditer(r'\] rendered \((.*)\)', text):
        for kv in m.group(1).split(', '):
            k, v, _ = kv.split(' ')
            parts.setdefault(k, []).append(float(v))
    return parts


def check_video(vis, n_frames, tag):
    """vis.mp4's boxes parse and hold one sample a frame, each decoding to
    exactly read_jpeg(write_jpeg(the frame's four PNGs side by side))."""
    import numpy as np
    from arah_tpu_torch.cli.test import KINDS
    from arah_tpu_torch.eval.evaluator import read_video
    from arah_tpu_torch.utils.image import read_image, read_jpeg, write_jpeg
    pngs = [[os.path.join(vis, f'{k}_{i:06d}.png') for k in KINDS]
            for i in range(n_frames)]
    check(all(os.path.exists(f) for row in pngs for f in row),
          f'{tag}: a PNG is missing')
    samples, fps, wh = read_video(os.path.join(vis, 'vis.mp4'))
    same = len(samples) == n_frames
    for row, sample in zip(pngs, samples):
        frame = np.concatenate([read_image(f) for f in row], axis=1)
        same = same and np.array_equal(read_jpeg(sample),
                                       read_jpeg(write_jpeg(frame)))
    print(f'{tag}: vis.mp4 {len(samples)} Motion-JPEG samples at {fps} '
          f'frame/s, {wh[0]} x {wh[1]}, each read_jpeg(write_jpeg(the '
          f'PNGs)): {same}', flush=True)
    check(same, f'{tag}: vis.mp4 does not hold the frames')


def check_free_viewpoint(vis, dataset, n_frames, n_views):
    """What ROADMAP's recorded fault predicts for `--free-viewpoint` on
    the one-camera ODP dataset: every spiral matrix is NaN, so each
    frame's rgb and posed normal map are blank (all 0), while the
    canonical front and back maps, which take no camera, are not."""
    import numpy as np
    from arah_tpu_torch.cli.test import spiral_cameras
    from arah_tpu_torch.utils.image import read_image
    spiral = np.asarray(spiral_cameras(dataset, n_views))
    nan = bool(np.isnan(spiral[:, :3]).all())
    lit = {k: [int(read_image(os.path.join(vis, f'{k}_{i:06d}.png')).any(
        -1).sum()) for i in range(n_frames)]
        for k in ('rgb', 'normal', 'front', 'back')}
    print(f'cli.test --free-viewpoint {n_views} on {len(dataset.cam_names)} '
          f'camera: spiral matrices all NaN {nan} (the recorded fault); '
          f'non-zero pixels a frame {lit} (rgb and normal blank, front and '
          'back drawn)', flush=True)
    check(nan, 'cli.test --free-viewpoint: the one-camera spiral is not '
          'the NaN that the recorded fault predicts')
    check(not any(lit['rgb'] + lit['normal'])
          and all(lit['front'] + lit['back']),
          f'cli.test --free-viewpoint: frames not as predicted: {lit}')


def mesh_check(tag, params, model_cfg, fd, item, latent, card, no_tf32,
               timed_frame=False, stride=1):
    """J against its plain version chunk by chunk on the `MESH_RES` grid
    of `params`' SIREN at frame `fd` (bound `J_TOL`, a chunk timed), then
    marching cubes on both grids (every `stride`-th sample on each axis:
    2 for a trained checkpoint's tens of millions of faces): face counts
    within 0.5% and the posed normal maps' foreground (under `item`'s
    camera) agreeing on >= 0.99 of the pixels. With `timed_frame`, first
    one frame of the mesh path as `cli.test` runs it
    (`render_normal_maps`), by part. Returns J's grid record."""
    import numpy as np
    import torch
    from arah_tpu_torch import native
    from arah_tpu_torch.eval.mesh_vis import (posed_normal_map,
                                              render_normal_maps)
    from arah_tpu_torch.ops.siren import (pack_siren_sdf, siren_sdf,
                                          siren_sdf_plain)
    from arah_tpu_torch.render.renderer import generate_sdf
    from arah_tpu_torch.utils.meshing import CHUNK, grid_chunk
    if timed_frame:
        times = {}
        no_tf32()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_normal_maps(params, model_cfg, fd, item, latent,
                           resolution=MESH_RES, times=times)
        total_s = time.perf_counter() - t0
        print(f'{tag}: one frame of the mesh path at --mesh-res {MESH_RES}, '
              's by part: ' + ', '.join(f'{k} {v:.3f}'
                                       for k, v in times.items())
              + f'; total {total_s:.3f} s [{card}]', flush=True)
    with torch.no_grad():
        gen = generate_sdf(params, model_cfg, fd.rots, fd.Jtrs, latent)
        packed = pack_siren_sdf(gen)
        total = MESH_RES ** 3
        gk = np.empty(total, np.float32)
        gp = np.empty(total, np.float32)
        err = 0.0
        no_tf32()
        for i in range(0, total, CHUNK):
            pts = grid_chunk(MESH_RES, i, CHUNK, 'cuda')
            k, p = siren_sdf(gen, pts, packed), siren_sdf_plain(gen, pts)
            m = min(CHUNK, total - i)
            err = max(err, float((k[:m] - p[:m]).abs().max()))
            gk[i:i + m] = k[:m, 0].cpu().numpy()
            gp[i:i + m] = p[:m, 0].cpu().numpy()
        pts = grid_chunk(MESH_RES, total // 2, CHUNK, 'cuda')
        ms = timed(lambda: siren_sdf(gen, pts, packed), REPS)
        plain_ms = timed(lambda: siren_sdf_plain(gen, pts), REPS)
    macs = sum(w.numel() for w in gen.weights)
    b = bound(CHUNK * 16 + 4 * sum(w.numel() + w.shape[0]
                                   for w in gen.weights),
              CHUNK * 2.0 * macs, PEAK_F32)
    print(f'{tag}: J siren on the grid ({total:,} points, '
          f'{-(-total // CHUNK)} chunks of {CHUNK:,}): max |d| {err:.3e} '
          f'(bound {J_TOL:g}); a chunk {ms:.3f} ms (pack outside), plain '
          f'{plain_ms:.3f} ms, bound {b[0]:.4f} ms ({b[1]}) [{card}]',
          flush=True)
    check(err < J_TOL, f'{tag}: siren kernel disagrees with its plain '
          'version on the grid')
    sp = 2.0 / (MESH_RES - 1) * stride
    meshes = [native.marching_cubes(np.ascontiguousarray(
        g.reshape((MESH_RES,) * 3)[::stride, ::stride, ::stride]), 0.0,
        origin=[-1.0] * 3, spacing=[sp] * 3) for g in (gk, gp)]
    fk, fp = len(meshes[0][1]), len(meshes[1][1])
    fg = [posed_normal_map(params, model_cfg, fd, item, v, f).any(-1)
          for v, f in meshes]
    agree = float((fg[0] == fg[1]).mean())
    same_sign = float(((gk < 0) == (gp < 0)).mean())
    print(f'{tag}: meshes (every {stride} grid sample an axis): kernel '
          f'grid {fk} faces, plain grid {fp} (|d| '
          f'{abs(fk - fp) / max(fp, 1):.5f} of them, bound 0.005); grid '
          f'signs equal at {same_sign:.7f}, SDF < 0 at {(gp < 0).mean():.5f} '
          f'of the grid; posed normal maps\' foreground agreeing on '
          f'{agree:.6f} of the pixels (bound 0.99; {int(fg[1].sum())} '
          'foreground pixels)', flush=True)
    check(fp > 0 and abs(fk - fp) <= 0.005 * fp,
          f'{tag}: the kernel grid\'s mesh and the plain grid\'s differ in '
          'faces')
    check(fg[1].any() and agree >= 0.99,
          f'{tag}: the kernel mesh\'s normal map and the plain mesh\'s '
          'differ')
    return dict(grid_ms=ms, grid_plain_ms=plain_ms, grid_bound_ms=b[0],
                grid_max_abs_err=err)


def bench_item(fd, size=512):
    """The bench scene's camera (`scene.scene_inputs`: at (0, 0.3, -2.5),
    looking along +z, image y down), its focal length and principal point
    set so that frame `fd`'s posed body spans 0.8 of a size x size image
    at its centre, as the fields of a dataset item that
    `posed_normal_map` reads."""
    import numpy as np
    R = np.diag([-1.0, -1.0, 1.0]).astype(np.float32)
    T = (-R @ np.array([0.0, 0.3, -2.5])).astype(np.float32)
    pc = fd.smpl.verts_posed.detach().cpu().numpy() @ R.T + T
    uv = pc[:, :2] / pc[:, 2:]
    lo, hi = uv.min(0), uv.max(0)
    f = 0.8 * size / float((hi - lo).max())
    c = size / 2 - f * (lo + hi) / 2
    K = np.array([[f, 0, c[0]], [0, f, c[1]], [0, 0, 1]], np.float32)
    return {'image.K': K, 'image.R': R, 'image.T': T,
            'inputs.img_height': size, 'inputs.img_width': size}


def run_cli_test(card, no_tf32, cli):
    """Phase 10 (a) and (b): `cli.test` on phase 9's checkpoint with the
    fixture's own SMPL sequence as the novel poses, counted (A-F and J,
    J at 64 a frame, no plain version), its PNGs and vis.mp4, the time a
    frame by part, a free-viewpoint run held to the recorded NaN-camera
    fault; then `mesh_check` on frame 0. Returns ({kernel: launches},
    J's grid record)."""
    import numpy as np
    import torch
    from arah_tpu_torch.cli import test as cli_test
    from arah_tpu_torch.config.factory import (get_dataset,
                                               init_params_from_cfg)
    from arah_tpu_torch.config.loader import (default_config_path,
                                              load_config,
                                              model_config_from_cfg)
    from arah_tpu_torch.data.loader import frame_from_item
    from arah_tpu_torch.data.odp import ODPDataset
    from arah_tpu_torch.parallel.train_step import TrainState
    from arah_tpu_torch.train import checkpoints as ckpt_lib
    from arah_tpu_torch.utils.meshing import CHUNK
    from arah_tpu_torch.utils import trace

    cfg_path = cli['cfg']
    cfg = load_config(cfg_path, default_config_path())
    vis = os.path.join(cfg['training']['out_dir'], 'vis')
    argv = [cfg_path, '--pose-dir', 'models', '--end-frame',
            str(TEST_FRAMES), '--mesh-res', str(MESH_RES)]

    # ---- (a) cli.test, counted
    no_tf32()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trace.reset_counts()
    t0 = time.perf_counter()
    with count_plain() as plain:
        text = run_cli(cli_test.main, argv)
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0
    launches = dict(trace.COUNTS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    parts = read_parts(text)
    n = len(parts.get('render', []))
    per = MESH_RES ** 3 // CHUNK
    print(f'phase 10: cli.test ({n} frames, --mesh-res {MESH_RES}): '
          f'{test_s:.2f} s, launches '
          f'{ {k: launches[k] for k in CLI_TEST_KERNELS} }, plain calls '
          f'{plain}, peak memory {peak:.2f} GiB [{card}]', flush=True)
    check(n == TEST_FRAMES, f'cli.test rendered {n} frames')
    check(all(launches[k] > 0 for k in CLI_KERNELS_EVAL),
          f'cli.test: a kernel of A-F was not launched: {launches}')
    check(launches['siren'] == per * n,
          f'cli.test: J launched {launches["siren"]} times, not {per} a '
          'frame')
    check(not any(plain.values()), f'cli.test: plain versions ran: {plain}')
    check_video(vis, n, 'cli.test')
    tot = sum(np.median(v) for v in parts.values())
    print('cli.test s/frame by part (median of the frames; render holds '
          'the item, its rays and the scatter): ' + ', '.join(
              f'{k} {np.median(v):.3f}' for k, v in parts.items())
          + f'; total {tot:.3f} s/frame [{card}]', flush=True)

    # the ODP dataset as cli.test reads it (one camera, --test-views 1)
    odp = ODPDataset(cfg['data']['path'], pose_dir='models', cam_name='1',
                     smpl_misc_dir=cfg['data']['smpl_misc'],
                     subjects=tuple(cfg['data']['test_split']))
    t0 = time.perf_counter()
    text = run_cli(cli_test.main, argv[:-2] + ['--mesh-res', '64',
                                                '--free-viewpoint', '4',
                                                '--end-frame', '2'])
    fv = read_parts(text)
    print(f'cli.test --free-viewpoint 4 --end-frame 2: '
          f'{time.perf_counter() - t0:.2f} s', flush=True)
    check(len(fv.get('render', [])) == 2,
          'cli.test --free-viewpoint: not 2 frames rendered')
    check_video(vis, 2, 'cli.test --free-viewpoint 4')
    check_free_viewpoint(vis, odp, 2, 4)

    # ---- (b) J against its plain version on frame 0's grid
    model_cfg = model_config_from_cfg(cfg)
    params = init_params_from_cfg(0, cfg, model_cfg, get_dataset('train',
                                                                 cfg),
                                  mode='val', device='cuda')
    ckpt_lib.restore_checkpoint(
        os.path.join(cfg['training']['out_dir'], 'checkpoints'),
        TrainState(params, None, 0))
    item = odp[0]
    rec = mesh_check('phase 9 checkpoint, frame 0', params, model_cfg,
                     frame_from_item(item, 'cuda'), item,
                     params['latent'][-1], card, no_tf32, stride=2)
    return {k: launches[k] for k in CLI_TEST_KERNELS}, rec


def hold_cli_step(tag, cfg, ds, card, no_tf32, refine_smpl=False):
    """A-I against their plain versions on what a warm-up step of the
    CLI's own batch (frame 0's blocks of `ds`) hands them, as phase 7
    does; with `refine_smpl` the step refines the SMPL leaves as
    `cli.train` does under `train_smpl: true`. Returns (the step, its
    state after the warm-up, the batch, a second draw of its randoms)."""
    import numpy as np
    import torch
    from arah_tpu_torch.config.factory import init_params_from_cfg
    from arah_tpu_torch.config.loader import (loss_weights_from_cfg,
                                              model_config_from_cfg,
                                              optim_config_from_cfg)
    from arah_tpu_torch.core.smpl import load_smpl_assets
    from arah_tpu_torch.data.batch import draw_train_draws
    from arah_tpu_torch.data.loader import collate_train_batch
    from arah_tpu_torch.parallel.train_step import (TrainState,
                                                    make_train_step,
                                                    trainable)
    from arah_tpu_torch.train.optim import make_optimizer
    model_cfg = model_config_from_cfg(cfg)
    params = init_params_from_cfg(0, cfg, model_cfg, ds, device='cuda')
    tparams = trainable(params)
    optimizer, _ = make_optimizer(optim_config_from_cfg(cfg), tparams)
    kw = dict(smpl_model=load_smpl_assets(cfg['data']['smpl_misc'],
                                          device='cuda'),
              refine_smpl=True) if refine_smpl else {}
    step = make_train_step(model_cfg, loss_weights_from_cfg(cfg), optimizer,
                           **kw)
    idxs = [i for i, rec in enumerate(ds.data) if rec['frame_idx'] == 0]
    batch = collate_train_batch([ds[i] for i in idxs], device='cuda')
    B, R = batch.ray_dirs.shape[:2]
    rng = np.random.RandomState(9)
    draws = [draw_train_draws(rng, model_cfg, B, R, 'cuda')
             for _ in range(2)]
    print(f'A-I at the {tag} step\'s shapes: {B} blocks x {R} rays '
          f'({R * model_cfg.tracer.n_steps:,} samples a block), SMPL '
          f'refinement {"on" if refine_smpl else "off"}', flush=True)
    no_tf32()
    with capture_train_kernels() as calls, capture_trace() as seen:
        state, losses = step(TrainState(tparams, optimizer, 0), batch,
                             draws[0])
    torch.cuda.synchronize()
    check(bool(torch.isfinite(losses['loss'])),
          f'{tag} warm-up step: loss not finite')
    check_block_kernels(model_cfg, params, seen, card, no_tf32, tag=tag)
    del seen
    no_tf32()
    check_skin_jac(calls['skin_jac'][0], card)
    no_tf32()
    check_shade_bwd(max(calls['shade_bwd'], key=lambda a: a[1].shape[0]),
                    card, 5e-3)
    no_tf32()
    check_color_bwd(calls['color_bwd'][0], card, 5e-3)
    del calls
    torch.cuda.empty_cache()
    return step, state, batch, draws[1]


def cli_train_counted(tag, card, no_tf32, cfg_path):
    """cli.train on `cfg_path` with the launch counts set to 0 just before
    and every plain version spied on: A-I must launch, none may be
    called, every logged loss must be finite. Returns ({kernel:
    launches}, ms between step starts)."""
    import numpy as np
    import torch
    from arah_tpu_torch.cli import train as cli_train
    from arah_tpu_torch.config.loader import default_config_path, load_config
    from arah_tpu_torch.utils import trace
    training = load_config(cfg_path, default_config_path())['training']
    out = training['out_dir']
    no_tf32()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trace.reset_counts()
    t0 = time.perf_counter()
    with count_plain() as plain, time_steps() as step_s:
        run_cli(cli_train.main, [cfg_path])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(trace.COUNTS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'{tag}: cli.train ({training["max_epochs"]} epochs) '
          f'{train_s:.2f} s, launches '
          f'{ {k: launches[k] for k in TRAIN_KERNELS} }, plain calls '
          f'{plain}, peak memory {peak:.2f} GiB [{card}]', flush=True)
    check(all(launches[k] > 0 for k in TRAIN_KERNELS),
          f'{tag} cli.train: a kernel of A-I was not launched: {launches}')
    check(not any(plain.values()), f'{tag} cli.train: plain versions ran: '
          f'{plain}')
    with open(os.path.join(out, 'metrics.tsv')) as f:
        rows = [ln.rstrip('\n').split('\t') for ln in f]
    vals = [float(v) for r in rows if r[0] != 'step' for v in r]
    check(len(vals) > 0 and all(np.isfinite(vals)),
          f'{tag} cli.train: logged losses not finite: {rows}')
    return ({k: launches[k] for k in TRAIN_KERNELS},
            np.asarray(step_s) * 1e3)


def loader_times(ds, undistorted=False):
    """(median s/item over the dataset, median ms of one JPEG decode of its
    first image, median ms of undistorting that image and its mask), one
    thread."""
    import numpy as np
    from arah_tpu_torch.utils.image import read_image, undistort
    rec = ds.data[0]
    img, mask = read_image(rec['img_file']), read_image(rec['mask_file'],
                                                        gray=True)
    cam = ds.cameras[rec['cam_name']]
    K = np.asarray(cam['K'], np.float32)
    D = np.asarray(cam['D'], np.float32)
    dec, und, item = [], [], []
    for _ in range(3):
        t0 = time.perf_counter()
        read_image(rec['img_file'])
        dec.append(time.perf_counter() - t0)
        if undistorted:
            t0 = time.perf_counter()
            undistort(img, K, D)
            undistort(mask, K, D)
            und.append(time.perf_counter() - t0)
    for i in range(len(ds)):
        t0 = time.perf_counter()
        ds[i]
        item.append(time.perf_counter() - t0)
    return (float(np.median(item)), float(np.median(dec)) * 1e3,
            float(np.median(und)) * 1e3 if und else None)


def run_cli_h36m(card, no_tf32, tmp, pre):
    """Phase 10 (c): the H36M fixture (2 views at 1002 x 1000, 4 frames),
    a config inheriting configs/arah-h36m/H36M_S9.yaml (its networks and
    `train_smpl: true`), `cli.train` for one epoch counted (the SMPL
    leaves must move), `cli.validate --novel-view`, A-I against their
    plain versions on that CLI step's block, and the CLI layer's times.
    Returns {kernel: launches in the train run}."""
    import numpy as np
    import torch
    from arah_tpu_torch.cli import validate as cli_validate
    from arah_tpu_torch.config.factory import (
        get_dataset, smpl_refine_params_from_dataset)
    from arah_tpu_torch.config.loader import default_config_path, load_config
    from arah_tpu_torch.data.fake_dataset import make_fake_h36m_dataset
    from arah_tpu_torch.train import checkpoints as ckpt_lib
    from arah_tpu_torch.utils import trace

    repo = os.path.dirname(os.path.abspath(__file__))
    base = os.path.join(repo, 'configs', 'arah-h36m', 'H36M_S9.yaml')
    data = os.path.join(tmp, 'h36m')
    t0 = time.perf_counter()
    make_fake_h36m_dataset(data, n_frames=CLI_FRAMES, views=('1', '2'))
    print(f'phase 10: H36M fixture ({CLI_FRAMES} frames, views 1 and 2, '
          f'1002 x 1000) written in {time.perf_counter() - t0:.2f} s',
          flush=True)
    out = os.path.join(tmp, 'out_h36m')
    cfg_path = cli_config(
        os.path.join(tmp, 'h36m.yaml'), base, data, out, pre,
        data_keys={'train_views': "['1', '2']", 'val_views': "['1']",
                   'test_views': "['1']", 'num_fg_samples': 512,
                   'num_bg_samples': 512}, max_epochs=1)
    launches, ms = cli_train_counted('H36M', card, no_tf32, cfg_path)
    cfg = load_config(cfg_path, default_config_path())
    ds = get_dataset('train', cfg)
    blob = torch.load(os.path.join(ckpt_lib.step_dir(
        os.path.join(out, 'checkpoints'), ckpt_lib.latest_step(
            os.path.join(out, 'checkpoints'))), ckpt_lib.STATE_FILE),
        map_location='cpu', weights_only=False)
    init = smpl_refine_params_from_dataset(ds, 'cpu')
    moved = {k: not torch.equal(blob['params']['smpl_params'][k],
                                init['smpl_params'][k])
             for k in ('root_orient', 'pose_body', 'pose_hand')}
    print(f'H36M: SMPL leaves moved by the epoch: {moved}', flush=True)
    check(all(moved.values()), f'H36M cli.train: SMPL leaves still {moved}')

    no_tf32()
    trace.reset_counts()
    with count_plain() as plain:
        run_cli(cli_validate.main, [cfg_path, '--novel-view'])
    torch.cuda.synchronize()
    vl = dict(trace.COUNTS)
    with open(os.path.join(out, 'val', 'metrics.json')) as f:
        mean = json.load(f)['mean']
    print(f'H36M cli.validate --novel-view: {mean}; launches '
          f'{ {k: vl[k] for k in CLI_KERNELS_EVAL} }, plain calls {plain} '
          f'[{card}]', flush=True)
    check(all(vl[k] > 0 for k in CLI_KERNELS_EVAL) and not any(
        plain.values()), f'H36M cli.validate: launches {vl}, plain {plain}')
    check(all(np.isfinite(mean[k]) for k in ('psnr', 'ssim')),
          f'H36M cli.validate: metrics not finite: {mean}')

    item_s, dec_ms, _ = loader_times(ds)
    print(f'H36M CLI layer: ms/step median {np.median(ms):.1f} (min '
          f'{ms.min():.1f}, max {ms.max():.1f}; between step starts over '
          f'{len(ms) + 1} steps of 2 blocks x 1,024 rays); loader '
          f'{item_s:.3f} s/item median ({len(ds)} train items, one thread), '
          f'of which JPEG decode of a 1002 x 1000 frame {dec_ms:.1f} ms '
          f'[{card}]', flush=True)

    # ---- A-I against their plain versions on the CLI step's block
    hold_cli_step('cli h36m', cfg, ds, card, no_tf32, refine_smpl=True)
    return launches


def run_cli_snapshot(card, no_tf32, tmp, pre):
    """Phase 10 (d): the People-Snapshot fixture with a distorted camera
    (its `camera.pkl` rewritten with camera_k (-0.2, 0.05, 0, 0, 0), so
    that the loader undistorts every image and mask), a config inheriting
    configs/arah-people-snapshot/male-3-casual.yaml, `cli.train` for one
    epoch counted, and the loader's s/item with its undistortion."""
    import pickle
    import numpy as np
    from arah_tpu_torch.config.factory import get_dataset
    from arah_tpu_torch.config.loader import default_config_path, load_config
    from arah_tpu_torch.data.fake_dataset import make_fake_snapshot_dataset

    repo = os.path.dirname(os.path.abspath(__file__))
    base = os.path.join(repo, 'configs', 'arah-people-snapshot',
                        'male-3-casual.yaml')
    data = os.path.join(tmp, 'snapshot')
    make_fake_snapshot_dataset(data, subject='male-3-casual',
                               n_frames=CLI_FRAMES)
    path = os.path.join(data, 'male-3-casual', 'camera.pkl')
    with open(path, 'rb') as f:
        cam = pickle.load(f)
    cam['camera_k'] = np.array([-0.2, 0.05, 0.0, 0.0, 0.0])
    with open(path, 'wb') as f:
        pickle.dump(cam, f)
    out = os.path.join(tmp, 'out_snapshot')
    cfg_path = cli_config(os.path.join(tmp, 'snapshot.yaml'), base, data,
                          out, pre, data_keys={'num_fg_samples': 512,
                                               'num_bg_samples': 512},
                          max_epochs=1)
    launches, ms = cli_train_counted('People-Snapshot', card, no_tf32,
                                     cfg_path)
    ds = get_dataset('train', load_config(cfg_path, default_config_path()))
    item_s, dec_ms, und_ms = loader_times(ds, undistorted=True)
    print(f'People-Snapshot CLI layer ({CLI_FRAMES} frames, one view at 512 '
          f'x 512 read at {ds.img_size[0]} x {ds.img_size[1]}, camera_k '
          f'{ds.cameras["0"]["D"]}): ms/step median {np.median(ms):.1f}; '
          f'loader {item_s:.3f} s/item median, of which JPEG decode '
          f'{dec_ms:.1f} ms and undistorting the image and its mask '
          f'{und_ms:.1f} ms [{card}]', flush=True)


# ---- phase 11: data parallelism over torch.distributed

DDP_RANKS = 2           # gloo ranks sharing the one card
RANK_TIMEOUT = 300      # seconds a phase-11 rank process may run
DDP_STEPS = 2           # sharded steps a rank takes (the first counted)


def free_port():
    import socket
    with socket.socket() as sk:
        sk.bind(('127.0.0.1', 0))
        return sk.getsockname()[1]


def launch_ranks(tag, args_of_rank, tmp):
    """DDP_RANKS processes of `python3 chip_smoke.py --rank ...`
    (args_of_rank(rank, port) after '--rank'), started together on one
    fresh port; every one is killed after the first that fails or at
    RANK_TIMEOUT. Prints each rank's output, indented; a rank that fails
    fails the run. Returns [(exit code, output)] and the wall seconds."""
    port = free_port()
    logs = [os.path.join(tmp, f'{tag}_rank{r}.log') for r in range(DDP_RANKS)]
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = []
    for r, log in enumerate(logs):
        with open(log, 'w') as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), '--rank']
                + args_of_rank(r, port), cwd=here, stdout=f,
                stderr=subprocess.STDOUT))
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) \
                    or time.perf_counter() - t0 > RANK_TIMEOUT:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    wall = time.perf_counter() - t0
    res = []
    for r, (p, log) in enumerate(zip(procs, logs)):
        with open(log) as f:
            out = f.read()
        for line in out.splitlines()[-40:]:
            print(f'    [{tag} rank {r}] {line[:600]}')
        check(p.returncode == 0, f'{tag}: rank {r} exit code {p.returncode}')
        res.append((p.returncode, out))
    print(f'{tag}: {DDP_RANKS} ranks in {wall:.1f} s', flush=True)
    return res, wall


def rank_lines(out, key):
    """The JSON object a rank printed after `key` (None if none)."""
    for line in out.splitlines():
        if line.startswith(key):
            return json.loads(line[len(key):])
    return None


def rank_main(argv):
    """A phase-11 rank (`python3 chip_smoke.py --rank KIND ...`): 'step'
    and 'eval' CASE OUT RANK PORT run the sharded step and the sharded
    eval chunk; 'cli' MODULE ARGV... runs a CLI's main. Each loads the
    built kernels (no build, no fit), counts the launches from 0 and spies
    on every plain version."""
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from arah_tpu_torch.ops import _build
    from arah_tpu_torch.utils import trace
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not os.path.exists(_build.library_path()):
        raise SystemExit('phase 11 rank: the kernels are not built')
    _build.load()
    kind = argv[0]
    if kind == 'cli':
        import importlib
        module, cli_argv = argv[1], argv[2:]
        trace.reset_counts()
        try:
            with count_plain() as plain:
                importlib.import_module(module).main(cli_argv)
        finally:
            torch.cuda.synchronize()
            print('rank launches ' + json.dumps(
                {k: trace.COUNTS.get(k, 0)
                 for k in TRAIN_KERNELS + ('siren',)}))
            print('rank plain calls ' + json.dumps(plain), flush=True)
        return
    case, out, rank, port = argv[1], argv[2], int(argv[3]), int(argv[4])
    from arah_tpu_torch.parallel import distributed
    from arah_tpu_torch.parallel.mesh import make_mesh
    distributed.initialize(f'127.0.0.1:{port}', DDP_RANKS, rank,
                           backend='gloo', device='cuda:0')
    try:
        {'step': rank_step, 'eval': rank_eval}[kind](
            torch.load(case, map_location='cuda:0', weights_only=False),
            out, make_mesh())
    finally:
        distributed.shutdown()


def tree_digest(params):
    """sha256 of every leaf's bytes, in the tree's order."""
    import hashlib
    from arah_tpu_torch.train.optim import tree_leaves_with_path
    h = hashlib.sha256()
    for _, leaf in tree_leaves_with_path(params):
        h.update(leaf.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def rank_step(case, out, mesh):
    """DDP_STEPS sharded flagship steps on this rank's blocks of the
    case's global batch and draws, the first counted; then the all-reduce
    alone on the last step's gradients. Saves {'launches', 'plain',
    'losses', 'ms', 'allreduce_ms', 'peak', 'digest', 'grads' (rank 0,
    the first step's)}."""
    import torch
    from arah_tpu_torch.parallel.mesh import local_blocks
    from arah_tpu_torch.parallel.train_step import (TrainState,
                                                    allreduce_mean,
                                                    grad_leaves,
                                                    make_train_step,
                                                    trainable)
    from arah_tpu_torch.scene import flagship_config
    from arah_tpu_torch.train.optim import (OptimConfig, make_optimizer,
                                            tree_leaves_with_path)
    from arah_tpu_torch.utils import trace
    p = trainable(case['params'])
    opt, _ = make_optimizer(OptimConfig(train_skinning_net=True), p)
    step = make_train_step(flagship_config(), case['loss_w'], opt, mesh=mesh)
    batch = local_blocks(case['batch'], mesh.rank, mesh.size)
    state = TrainState(p, opt, 0)
    res = {'ms': []}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i, draws in enumerate(case['draws']):
        draws = local_blocks(draws, mesh.rank, mesh.size)
        if i == 0:
            trace.reset_counts()
        t0 = time.perf_counter()
        with count_plain() as plain:
            state, losses = step(state, batch, draws)
        torch.cuda.synchronize()
        res['ms'].append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            res['launches'] = {k: trace.COUNTS[k] for k in TRAIN_KERNELS}
            res['plain'] = dict(plain)
            res['losses'] = {k: float(v) for k, v in losses.items()}
            if mesh.rank == 0:
                res['grads'] = {path: leaf.grad.detach().cpu()
                                for path, leaf in tree_leaves_with_path(p)
                                if leaf.grad is not None}
    res['peak'] = torch.cuda.max_memory_allocated() / 2 ** 30
    res['digest'] = tree_digest(p)
    leaves = grad_leaves(p)
    res['allreduce_ms'] = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        allreduce_mean(leaves, {'loss': losses['loss']}, mesh)
        torch.cuda.synchronize()
        res['allreduce_ms'].append((time.perf_counter() - t0) * 1e3)
    res['numel'] = sum(leaf.numel() for leaf in leaves)
    torch.save(res, out)


def rank_eval(case, out, mesh):
    """The flagship frame's rays through `render_frame_rays(mesh=)`,
    counted; then this rank's rows of every chunk rendered alone, at the
    same size. Saves {'full', 'alone', 'rows', 'launches', 'plain',
    'ms'}."""
    import numpy as np
    import torch
    from arah_tpu_torch.eval.evaluator import (pick_eval_chunk,
                                               render_frame_rays)
    from arah_tpu_torch.scene import flagship_config
    from arah_tpu_torch.utils import trace
    cfg, item = flagship_config(), case['item']
    args = (case['params'], cfg, case['fd'])
    trace.reset_counts()
    with count_plain() as plain:
        full = render_frame_rays(*args, item, case['latent'], mesh=mesh)
    torch.cuda.synchronize()
    res = {'full': full, 'plain': dict(plain),
           'launches': {k: trace.COUNTS[k] for k in CLI_KERNELS_EVAL}}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render_frame_rays(*args, item, case['latent'], mesh=mesh)
    torch.cuda.synchronize()
    res['ms'] = (time.perf_counter() - t0) * 1e3
    n = len(item['inputs.ray_dirs'])
    chunk = pick_eval_chunk(n)
    chunk = max(chunk - chunk % mesh.size, mesh.size)
    k = chunk // mesh.size
    keys = ('inputs.ray_dirs', 'inputs.body_bounds_intersections')
    padded = {key: np.pad(item[key], ((0, -n % chunk), (0, 0)), mode='edge')
              for key in keys}
    rows, alone = [], []
    for i in range(0, n, chunk):
        r = np.arange(i + mesh.rank * k, i + (mesh.rank + 1) * k)
        part = dict(item, **{key: padded[key][r] for key in keys})
        alone.append(render_frame_rays(*args, part, case['latent'],
                                       chunk=k))
        rows.append(r)
    res['rows'] = np.concatenate(rows)
    res['alone'] = [np.concatenate(a) for a in zip(*alone)]
    torch.save(res, out)


def run_ddp(card, no_tf32, params, fd, frame_item, cli, tmp):
    """Phase 11 of the module docstring. Returns {kernel: [launches of
    rank 0, of rank 1]} of the sharded step."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from arah_tpu_torch.data.batch import (draw_train_draws,
                                           synthetic_train_batch)
    from arah_tpu_torch.eval.evaluator import render_frame_rays
    from arah_tpu_torch.parallel import distributed
    from arah_tpu_torch.parallel.mesh import make_mesh
    from arah_tpu_torch.parallel.train_step import (TrainState, grad_leaves,
                                                    make_train_step,
                                                    trainable)
    from arah_tpu_torch.scene import flagship_config
    from arah_tpu_torch.train.loss import LossWeights
    from arah_tpu_torch.train.optim import OptimConfig, make_optimizer
    from arah_tpu_torch.utils.tree import tree_map
    t_phase = time.perf_counter()
    cfg = flagship_config()
    dev = fd.verts_cano.device
    params = tree_map(lambda t: t.detach(), params)

    # ---- (a) the sharded flagship step, 2 gloo ranks on the one card
    rng = np.random.RandomState(11)
    batch = synthetic_train_batch(rng, fd, n_blocks=DDP_RANKS, n_rays=RAYS,
                                  n_reg=1024)
    loss_w = LossWeights(n_ray_loss=RAYS)
    draws = [draw_train_draws(rng, cfg, DDP_RANKS, RAYS, dev)
             for _ in range(DDP_STEPS)]
    case = os.path.join(tmp, 'ddp_step.pt')
    torch.save({'params': params, 'batch': batch, 'draws': draws,
                'loss_w': loss_w}, case)
    single = run_step(cfg, params, batch, loss_w, draws[0], no_tf32)
    print(f'phase 11 (a): the single-process step of {DDP_RANKS} blocks x '
          f'{RAYS} rays (+ 1,024 regulariser points a block): '
          f'{single["ms"]:.1f} ms, peak {single["peak"]:.2f} GiB [{card}]',
          flush=True)
    outs = [os.path.join(tmp, f'ddp_step_{r}.pt') for r in range(DDP_RANKS)]
    launch_ranks('sharded step', lambda r, port: [
        'step', case, outs[r], str(r), str(port)], tmp)
    ranks = [torch.load(o, weights_only=False) if os.path.exists(o) else None
             for o in outs]
    ddp_launches = {k: [None] * DDP_RANKS for k in TRAIN_KERNELS}
    if all(ranks):
        for r, res in enumerate(ranks):
            for k in TRAIN_KERNELS:
                ddp_launches[k][r] = res['launches'][k]
            print(f'  rank {r}: launches in its counted step '
                  f'{res["launches"]}, plain calls {res["plain"]}; ms/step '
                  f'{[round(v, 1) for v in res["ms"]]}; all-reduce of '
                  f'{res["numel"]} floats + the losses '
                  f'{[round(v, 1) for v in res["allreduce_ms"]]} ms (gloo '
                  f'through the host, 2 ranks on one card: not NCCL\'s '
                  f'cost); peak memory {res["peak"]:.2f} GiB [{card}]',
                  flush=True)
            check(all(res['launches'][k] > 0 for k in TRAIN_KERNELS),
                  f'sharded step rank {r}: a kernel of A-I was not '
                  f'launched: {res["launches"]}')
            check(not any(res['plain'].values()),
                  f'sharded step rank {r}: plain versions ran')
        same = len({res['digest'] for res in ranks}) == 1
        print(f'  the ranks\' parameters after {DDP_STEPS} steps bit-equal: '
              f'{same} ({ranks[0]["digest"][:16]}...)', flush=True)
        check(same, 'sharded step: the ranks\' parameters differ')
        r0 = dict(ranks[0], ms=ranks[0]['ms'][0], grads={
            k: v.to(dev) for k, v in ranks[0]['grads'].items()})
        hold_steps('  rank 0\'s mean losses and all-reduced gradient '
                   'against the single-process 2-block step', r0, single,
                   1e-5, 0.9999, card)
        # a leaf without a gradient in one process is reduced as zeros
        ref = {k: torch.zeros_like(g) if single['grads'][k] is None
               else single['grads'][k] for k, g in r0['grads'].items()}
        same = [torch.equal(g, ref[k]) for k, g in r0['grads'].items()]
        dmax = max(float((g - ref[k]).abs().max())
                   for k, g in r0['grads'].items())
        print(f'  bit-equal gradient leaves {sum(same)} of {len(same)}, max '
              f'|d| {dmax:.3e}; losses bit-equal '
              f'{r0["losses"] == single["losses"]}', flush=True)
    del single, ranks
    torch.cuda.empty_cache()

    # ---- (b) one NCCL rank: mesh of one against mesh=None
    def one_step(mesh):
        no_tf32()
        p = trainable(params)
        opt, _ = make_optimizer(OptimConfig(train_skinning_net=True), p)
        step = make_train_step(cfg, loss_w, opt, mesh=mesh)
        _, losses = step(TrainState(p, opt, 0), batch, draws[0])
        torch.cuda.synchronize()
        return tree_digest(p), {k: float(v) for k, v in losses.items()}
    distributed.initialize(f'127.0.0.1:{free_port()}', 1, 0,
                           backend='nccl', device='cuda:0')
    try:
        d_mesh, l_mesh = one_step(make_mesh())
        d_none, l_none = one_step(None)
        numel = sum(t.numel() for t in grad_leaves(params))
        flat = torch.zeros(numel + len(l_mesh), device=dev)
        ms_nccl = timed(lambda: dist.all_reduce(flat), REPS)
    finally:
        distributed.shutdown()
    print(f'phase 11 (b): one NCCL rank, make_mesh() against mesh=None: '
          f'parameters bit-equal {d_mesh == d_none}, losses equal '
          f'{l_mesh == l_none}; NCCL all-reduce of the flat buffer '
          f'({numel} floats + {len(l_mesh)} losses, world 1) {ms_nccl:.3f} '
          f'ms [{card}]', flush=True)
    check(d_mesh == d_none and l_mesh == l_none,
          'NCCL world-1 step differs from mesh=None')
    torch.cuda.empty_cache()

    # ---- (c) the sharded eval chunk on the flagship frame
    latent = params['latent'][0]
    case = os.path.join(tmp, 'ddp_eval.pt')
    torch.save({'params': params, 'fd': fd, 'item': frame_item,
                'latent': latent}, case)
    no_tf32()
    one = render_frame_rays(params, cfg, fd, frame_item, latent)
    outs = [os.path.join(tmp, f'ddp_eval_{r}.pt') for r in range(DDP_RANKS)]
    launch_ranks('sharded eval', lambda r, port: [
        'eval', case, outs[r], str(r), str(port)], tmp)
    ranks = [torch.load(o, weights_only=False) if os.path.exists(o) else None
             for o in outs]
    if all(ranks):
        n = len(frame_item['inputs.ray_dirs'])
        for r, res in enumerate(ranks):
            keep = res['rows'] < n
            eq = all(np.array_equal(a[keep], w[res['rows'][keep]])
                     for a, w in zip(res['alone'], res['full']))
            print(f'  rank {r}: launches {res["launches"]}, plain calls '
                  f'{res["plain"]}; {int(keep.sum())} rays of its own; its '
                  f'slice bit-equal to a render of those rays alone {eq}; '
                  f'{res["ms"]:.1f} ms a frame [{card}]', flush=True)
            check(eq, f'sharded eval rank {r}: slice differs from its rays '
                      'rendered alone')
            check(all(v > 0 for v in res['launches'].values())
                  and not any(res['plain'].values()),
                  f'sharded eval rank {r}: launches {res["launches"]}, '
                  f'plain {res["plain"]}')
        same = all(np.array_equal(a, b) for a, b in
                   zip(ranks[0]['full'], ranks[1]['full']))
        rgb, w, dep, conv = ranks[0]['full']
        c1 = one[3].astype(bool)
        both = conv & c1
        agree = float((conv == c1).mean())
        rgb_med = float(np.median(np.abs(rgb - one[0])[both])) \
            if both.any() else 0.0
        dep_med = float(np.median(np.abs(dep - one[2])[both])) \
            if both.any() else 0.0
        print(f'  whole frame: the ranks\' copies bit-equal {same}; against '
              f'the single-device render (the eval gate: converged-flag '
              f'agreement {agree:.5f} > 0.98, rgb median |d| {rgb_med:.3e} '
              f'< 1e-2 and depth median |d| {dep_med:.3e} < 1e-4 on the '
              f'{int(both.sum())} rays converged on both; straggler splits '
              f'differ per shard) [{card}]', flush=True)
        check(same and agree > 0.98 and rgb_med < 1e-2 and dep_med < 1e-4,
              'sharded eval: the frame disagrees')
    del one, ranks
    torch.cuda.empty_cache()

    # ---- (d) the CLIs as 2 gloo ranks on the card
    repo = os.path.dirname(os.path.abspath(__file__))
    base = os.path.join(repo, 'configs', 'fake', 'FAKE-ZJU-flagship.yaml')
    out = os.path.join(tmp, 'out_ddp')
    cfg_path = cli_config(os.path.join(tmp, 'ddp.yaml'), base, cli['data'],
                          out, cli['pre'], max_epochs=1,
                          checkpoint_every_n_epochs=1)

    def flags(r, port):
        return ['--coordinator', f'127.0.0.1:{port}', '--num-processes',
                str(DDP_RANKS), '--process-id', str(r), '--device', 'cuda:0',
                '--dist-backend', 'gloo']

    res, _ = launch_ranks('cli.train', lambda r, port: [
        'cli', 'arah_tpu_torch.cli.train', cfg_path] + flags(r, port), tmp)
    for r, (_, text) in enumerate(res):
        got = rank_lines(text, 'rank launches ') or {}
        plain = rank_lines(text, 'rank plain calls ') or {}
        check(all(got.get(k, 0) > 0 for k in TRAIN_KERNELS)
              and not any(plain.values()),
              f'cli.train rank {r}: launches {got}, plain {plain}')
    ck = os.path.join(out, 'checkpoints')
    files = sorted(os.listdir(ck)) if os.path.isdir(ck) else []
    meta = {}
    if os.path.exists(os.path.join(ck, 'META.json')):
        with open(os.path.join(ck, 'META.json')) as f:
            meta = json.load(f)
    rows = []
    if os.path.exists(os.path.join(out, 'metrics.tsv')):
        with open(os.path.join(out, 'metrics.tsv')) as f:
            rows = [ln.rstrip('\n').split('\t') for ln in f]
    vals = [float(v) for r_ in rows if r_[0] != 'step' for v in r_]
    print(f'  cli.train (2 ranks, 1 epoch): checkpoints {files}, META.json '
          f'{meta}, metrics.tsv {len(rows)} rows, losses finite '
          f'{bool(vals) and bool(np.all(np.isfinite(vals)))}', flush=True)
    check(meta.get('epoch') == 1 and 'LAST' in files
          and sum(f.startswith('step_') for f in files) == 1
          and sum(r_[0] == 'step' for r_ in rows) == 1 and vals
          and bool(np.all(np.isfinite(vals))),
          f'cli.train (2 ranks): files {files}, META {meta}, rows {rows}')

    from arah_tpu_torch.cli import validate as cli_validate
    metrics = os.path.join(out, 'val', 'metrics.json')
    run_cli(cli_validate.main, [cfg_path, '--novel-view'])
    with open(metrics) as f:
        one_m = json.load(f)
    os.remove(metrics)
    launch_ranks('cli.validate', lambda r, port: [
        'cli', 'arah_tpu_torch.cli.validate', cfg_path, '--novel-view']
        + flags(r, port), tmp)
    two_m = None
    if os.path.exists(metrics):
        with open(metrics) as f:
            two_m = json.load(f)
    n_val = len(two_m['per_frame']) if two_m else 0
    print(f'  cli.validate --novel-view (2 ranks): {n_val} frames, rows '
          f'equal to one process\'s {two_m == one_m} ({one_m["mean"]})',
          flush=True)
    check(two_m == one_m and len(one_m['per_frame']) > 0,
          'cli.validate (2 ranks): metrics.json differs from one process')

    vis = os.path.join(out, 'vis')
    launch_ranks('cli.test', lambda r, port: [
        'cli', 'arah_tpu_torch.cli.test', cfg_path, '--pose-dir', 'models',
        '--end-frame', '2', '--mesh-res', '64'] + flags(r, port), tmp)
    pngs = [f'{k}_{i:06d}.png' for k in ('rgb', 'normal', 'front', 'back')
            for i in range(2)]
    have = all(os.path.exists(os.path.join(vis, f)) for f in pngs)
    print(f'  cli.test (2 ranks, 2 frames, --mesh-res 64): every PNG '
          f'{have}', flush=True)
    check(have, 'cli.test (2 ranks): PNGs missing')
    if have:
        check_video(vis, 2, 'cli.test (2 ranks)')
    print(f'phase 11: {time.perf_counter() - t_phase:.1f} s [{card}]',
          flush=True)
    return ddp_launches


# ---- phase 12: the real-data parity runbook on the card

PARITY_FRAMES = 4       # raw ZJU frames, views 1 and 7, 1024 x 1024
PARITY_H36M_FRAMES = 2  # kept H36M frames (10 raw), 2 views, 1002 x 1000
PARITY_VERTS = 6890     # the bench body's n_verts (scene.N_VERTS)


def compare_trees(tag, a, b, tol=1e-5):
    """Two preprocessing outputs: the same files, `cam_params.json` and
    the images byte-equal, every npz field of the same dtype and shape
    and within `tol`. Returns the largest npz difference."""
    import numpy as np

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)
    fa, fb = files(a), files(b)
    check(fa == fb, f'{tag}: the file sets differ: '
          f'{sorted(set(fa) ^ set(fb))[:5]}')
    worst, n_npz = 0.0, 0
    for rel in sorted(set(fa) & set(fb)):
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if rel.endswith('.npz'):
            n_npz += 1
            za, zb = np.load(pa), np.load(pb)
            check(sorted(za) == sorted(zb), f'{tag}: {rel} fields')
            for k in set(za) & set(zb):
                same = za[k].dtype == zb[k].dtype \
                    and za[k].shape == zb[k].shape
                d = float(np.abs(za[k].astype(np.float64) - zb[k]).max()) \
                    if same and za[k].size else 0.0
                worst = max(worst, d)
                check(same and d <= tol, f'{tag}: {rel}:{k} differs by {d}')
        else:
            with open(pa, 'rb') as x, open(pb, 'rb') as y:
                check(x.read() == y.read(), f'{tag}: {rel} not byte-equal')
    print(f'  {tag}: {len(fa)} files the same, JSON and images byte-equal, '
          f'{n_npz} npz records within {worst:.3e} (bound {tol:g})',
          flush=True)
    return worst


def run_parity(card, no_tf32, tmp):
    """Phase 12 of the module docstring. Returns {kernel: launches of
    A-F in the validation from the converted checkpoint}."""
    import pickle
    import re
    import numpy as np
    import torch
    from arah_tpu_torch.cli import convert_checkpoint
    from arah_tpu_torch.cli import validate as cli_validate
    from arah_tpu_torch.config.factory import (get_dataset,
                                               init_params_from_cfg)
    from arah_tpu_torch.config.loader import (default_config_path,
                                              load_config,
                                              model_config_from_cfg)
    from arah_tpu_torch.core.smpl import lbs, load_smpl_assets
    from arah_tpu_torch.data.fake_dataset import (make_fake_raw_h36m,
                                                  make_fake_raw_zju)
    from arah_tpu_torch.data.odp import ODPDataset
    from arah_tpu_torch.eval.evaluator import evaluate_frame, save_image
    from arah_tpu_torch.parallel.train_step import TrainState
    from arah_tpu_torch.preprocess import (extract_smpl_parameters,
                                           preprocess_aist,
                                           preprocess_h36m,
                                           preprocess_zju_mocap)
    from arah_tpu_torch.train import checkpoints as ckpt_lib
    from arah_tpu_torch.train.optim import tree_leaves_with_path
    from arah_tpu_torch.utils import trace

    t_phase = time.perf_counter()
    root = os.path.join(tmp, 'parity')
    raw_zju, raw_h36m = os.path.join(root, 'raw_zju'), \
        os.path.join(root, 'raw_h36m')
    t0 = time.perf_counter()
    _, model = make_fake_raw_zju(raw_zju, n_frames=PARITY_FRAMES,
                                 views=('1', '7'), img_size=1024,
                                 n_verts=PARITY_VERTS)
    make_fake_raw_h36m(raw_h36m, n_frames=PARITY_H36M_FRAMES,
                       img_size=(1002, 1000), n_verts=PARITY_VERTS)
    print(f'phase 12: raw ZJU tree ({PARITY_FRAMES} frames, views 1 and 7, '
          f'1024 x 1024, the body of n_verts={PARITY_VERTS}: '
          f'{np.asarray(model.v_template).shape[0]} vertices) and raw H36M tree '
          f'({5 * PARITY_H36M_FRAMES} frames, 2 views, 1002 x 1000) written '
          f'in {time.perf_counter() - t0:.2f} s', flush=True)

    # ---- the preprocessing scripts on the card and on the host
    per_frame = {}
    outs = {}
    for name, mod, raw, seq, n in (
            ('ZJU', preprocess_zju_mocap, raw_zju, 'CoreView_313',
             PARITY_FRAMES),
            ('H36M', preprocess_h36m, raw_h36m, 'S9', PARITY_H36M_FRAMES)):
        for dev in ('cuda', 'cpu'):
            out = os.path.join(root, f'{name.lower()}_{dev}')
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_cli(mod.main, ['--data-dir', raw, '--out-dir', out,
                               '--seqname', seq, '--smpl-misc',
                               os.path.join(raw, 'body_models', 'misc'),
                               '--device', dev])
            torch.cuda.synchronize()
            per_frame[name, dev] = (time.perf_counter() - t0) / n
            outs[name, dev] = out
        compare_trees(f'{name} preprocessing, cuda against cpu',
                      outs[name, 'cuda'], outs[name, 'cpu'])
    zju_out = outs['ZJU', 'cuda']

    # ---- the SMPL pickles -> misc, then AIST++ retargeting onto it
    smpl_dir = os.path.join(root, 'smpl', 'neutral')
    os.makedirs(smpl_dir)
    nv = np.asarray(model.v_template).shape[0]
    with open(os.path.join(smpl_dir, 'model.pkl'), 'wb') as f:
        pickle.dump({
            'v_template': np.asarray(model.v_template, np.float64),
            'shapedirs': np.concatenate(
                [np.asarray(model.shapedirs, np.float64),
                 np.zeros((nv, 3, 290))], axis=-1),
            'posedirs': np.asarray(model.posedirs, np.float64
                                   ).T.reshape(nv, 3, 207),
            'J_regressor': np.asarray(model.J_regressor, np.float64),
            'weights': np.asarray(model.lbs_weights, np.float64),
            'f': np.asarray(model.faces, np.int64),
            'kintree_table': np.stack([np.asarray(model.parents),
                                       np.arange(24)]).astype(np.int64)}, f)
    misc = os.path.join(root, 'misc')
    run_cli(extract_smpl_parameters.main, ['--smpl-dir',
                                           os.path.dirname(smpl_dir),
                                           '--out-dir', misc])
    rng = np.random.RandomState(1)
    betas = torch.as_tensor(rng.randn(1, 10).astype(np.float32) * 0.2,
                            device='cuda')
    pose = torch.as_tensor(rng.randn(1, 72).astype(np.float32) * 0.2,
                           device='cuda')
    with torch.no_grad():
        d = float((lbs(load_smpl_assets(misc, 'neutral'), betas, pose).verts
                   - lbs(load_smpl_assets(os.path.join(
                       raw_zju, 'body_models', 'misc'), 'neutral'), betas,
                       pose).verts).abs().max())
    print(f'  extract_smpl_parameters: the extracted model poses as the '
          f'fixture\'s within {d:.3e} (bound 1e-5)', flush=True)
    check(d <= 1e-5, 'extract_smpl_parameters: the model differs')
    aist = os.path.join(root, 'aist')
    os.makedirs(aist)
    with open(os.path.join(aist, 'gBR_sBM_c01.pkl'), 'wb') as f:
        pickle.dump({'smpl_poses': (rng.randn(6, 72) * 0.1).astype(
            np.float32)}, f)
    odp_root = os.path.join(root, 'odp')
    run_cli(preprocess_aist.main, [
        '--data-dir', aist, '--seqname', 'gBR_sBM_c01', '--in-dataset',
        zju_out, '--subject', 'CoreView_313', '--out-dir', odp_root,
        '--view', '1', '--smpl-misc', misc, '--device', 'cuda'])
    odp = ODPDataset(odp_root, pose_dir='gBR_sBM_c01_view1', cam_name='1',
                     img_size=(256, 256), orig_img_size=(1024, 1024),
                     smpl_misc_dir=misc, subjects=('CoreView_313',))
    ok = len(odp) == 3 and all(
        np.isfinite(odp[i]['inputs.ray_dirs']).all()
        and np.isfinite(odp[i]['image.bone_transforms']).all()
        for i in range(len(odp)))
    print(f'  preprocess_aist: {len(odp)} retargeted frames of 6 poses, '
          f'loaded by ODPDataset, finite {ok}', flush=True)
    check(ok, 'preprocess_aist: ODPDataset does not load 3 finite frames')

    # ---- a reference Lightning checkpoint at the flagship's shapes
    repo = os.path.dirname(os.path.abspath(__file__))
    base = os.path.join(repo, 'configs', 'fake', 'FAKE-ZJU-flagship.yaml')
    out = os.path.join(root, 'out')
    cfg_path = os.path.join(root, 'cfg.yaml')
    with open(cfg_path, 'w') as f:
        f.write(f'inherit_from: {base}\ndata:\n  path: {zju_out}\n'
                f'  smpl_misc: {raw_zju}/body_models/misc\n'
                f'training:\n  out_dir: {out}\n')
    cfg = load_config(cfg_path, default_config_path())
    model_cfg = model_config_from_cfg(cfg)
    train_ds = get_dataset('train', cfg)
    src = init_params_from_cfg(5, cfg, model_cfg, train_ds, mode='val',
                               device='cuda')
    sd = reference_state_dict(src)
    del src
    ckpt = os.path.join(root, 'last.ckpt')
    torch.save({'state_dict': sd, 'epoch': 1}, ckpt)
    n_float = sum(v.numel() for v in sd.values())

    # ---- cli.convert_checkpoint, against the in-process conversion
    t0 = time.perf_counter()
    run_cli(convert_checkpoint.main, ['--config', cfg_path, '--torch-ckpt',
                                      ckpt, '--out-dir',
                                      os.path.join(out, 'checkpoints')])
    convert_s = time.perf_counter() - t0
    direct = ckpt_lib.convert_model_state_dict(
        ckpt_lib.strip_prefix(sd, 'model.'), model_cfg)
    del sd
    params = init_params_from_cfg(0, cfg, model_cfg, train_ds, mode='val',
                                  device='cuda')
    state, step = ckpt_lib.restore_checkpoint(
        os.path.join(out, 'checkpoints'), TrainState(params, None, 0))
    a = dict(tree_leaves_with_path(state.params))
    b = dict(tree_leaves_with_path(direct))
    same = step == 0 and sorted(a) == sorted(b) and all(
        torch.equal(a[k].cpu(), b[k]) for k in b)
    print(f'  cli.convert_checkpoint: {n_float} floats in {len(b)} leaves, '
          f'{convert_s:.2f} s; the restored step-0 tree bit-equal to the '
          f'in-process conversion {same}', flush=True)
    check(same, 'cli.convert_checkpoint: the restored tree differs from the '
          'in-process conversion')
    del direct, a, b

    # ---- cli.validate from the converted checkpoint, counted
    no_tf32()
    torch.cuda.synchronize()
    trace.reset_counts()
    t0 = time.perf_counter()
    with count_plain() as plain:
        text = run_cli(cli_validate.main, [cfg_path, '--novel-view',
                                           '--device', 'cuda'])
    torch.cuda.synchronize()
    val_s = time.perf_counter() - t0
    vl = {k: trace.COUNTS[k] for k in CLI_KERNELS_EVAL}
    frame_s = [float(x) for x in re.findall(r'\] .* \(([\d.]+) s\)', text)]
    check('loaded checkpoint step 0' in text,
          'cli.validate did not restore the converted checkpoint')
    check(all(v > 0 for v in vl.values()),
          f'cli.validate (converted): a kernel of A-F was not launched {vl}')
    check(not any(plain.values()), f'cli.validate (converted): plain '
          f'versions ran: {plain}')
    with open(os.path.join(out, 'val', 'metrics.json')) as f:
        mean = json.load(f)['mean']
    check(all(np.isfinite(v) for v in mean.values()),
          f'cli.validate (converted): metrics not finite {mean}')
    # the same item in this process with the restored parameters
    item = get_dataset('val', cfg, subsampling_rate=30)[0]
    d_idx = int(item['inputs.data_idx'])
    if d_idx >= state.params['latent'].shape[0]:
        d_idx = state.params['latent'].shape[0] - 1
    m = evaluate_frame(state.params, model_cfg, item,
                       state.params['latent'][d_idx])
    ref = os.path.join(root, 'rgb_inproc.png')
    save_image(ref, m['rgb_pred'])
    with open(ref, 'rb') as f, \
            open(os.path.join(out, 'val', 'rgb_000000.png'), 'rb') as g:
        png_same = f.read() == g.read()
    print(f'  cli.validate --novel-view from the converted checkpoint: '
          f'{len(frame_s)} frame(s), {val_s:.2f} s in all, '
          f'{np.mean(frame_s) if frame_s else float("nan"):.3f} s/frame; '
          f'launches {vl}, plain calls {plain}; metrics {mean}; rgb PNG '
          f'byte-equal to the in-process evaluate_frame {png_same}',
          flush=True)
    check(png_same, 'cli.validate (converted): the rgb PNG differs from '
          'the in-process render')
    print(f'phase 12: preprocess s/frame ZJU cuda '
          f'{per_frame["ZJU", "cuda"]:.3f} cpu {per_frame["ZJU", "cpu"]:.3f}'
          f', H36M cuda {per_frame["H36M", "cuda"]:.3f} cpu '
          f'{per_frame["H36M", "cpu"]:.3f}; convert {convert_s:.2f} s; '
          f'validate {np.mean(frame_s) if frame_s else float("nan"):.3f} '
          f's/frame; A-F launches {vl}; phase {time.perf_counter() - t_phase:.1f}'
          f' s (budget 90) [{card}]', flush=True)
    return vl


def phase12_probe():
    """`python3 chip_smoke.py --phase12`: phase 12 alone (the kernels'
    build, then `run_parity`); exits non-zero on a failed check. Prints
    no result lines."""
    import tempfile
    import torch
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from arah_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def no_tf32():
        check(not torch.backends.cuda.matmul.allow_tf32, 'TF32 got enabled')
    card = card_line()
    _build.load()
    with tempfile.TemporaryDirectory(prefix='arah_parity_') as tmp:
        run_parity(card, no_tf32, tmp)
    print(card)
    if FAILURES:
        print(f'{len(FAILURES)} check(s) failed: {FAILURES}', flush=True)
        sys.exit(1)


def phase11_probe():
    """`python3 chip_smoke.py --phase11`: phase 11 alone, the quick probe
    of the data-parallel path (the kernels' build, the fitted scene, phase
    9's fixture and pretrained nets, then `run_ddp`); exits non-zero on a
    failed check. Prints no result lines."""
    import tempfile
    import torch
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from arah_tpu_torch.config.loader import (default_config_path,
                                              load_config,
                                              model_config_from_cfg)
    from arah_tpu_torch.data.fake_dataset import make_fake_zju_dataset
    from arah_tpu_torch.ops import _build
    from arah_tpu_torch.scene import build_scene, flagship_config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def no_tf32():
        check(not torch.backends.cuda.matmul.allow_tf32, 'TF32 got enabled')
    card = card_line()
    t0 = time.perf_counter()
    _build.load()
    print(f'kernels loaded in {time.perf_counter() - t0:.1f} s', flush=True)
    params, fd, inp = build_scene(flagship_config(), RAYS, seed=0)
    frame_item = {
        'inputs.ray_dirs': inp.ray_dirs.cpu().numpy(),
        'inputs.body_bounds_intersections': torch.stack(
            [inp.near, inp.far], -1).cpu().numpy(),
        'image.cam_loc': inp.cam_loc.reshape(3).cpu().numpy()}
    repo = os.path.dirname(os.path.abspath(__file__))
    base = os.path.join(repo, 'configs', 'fake', 'FAKE-ZJU-flagship.yaml')
    with tempfile.TemporaryDirectory(prefix='arah_ddp_') as tmp:
        data = os.path.join(tmp, 'data')
        make_fake_zju_dataset(data, n_frames=CLI_FRAMES, views=('1', '7'),
                              img_size=1024)
        pre = write_pretrained(tmp, params, model_config_from_cfg(
            load_config(base, default_config_path())))
        run_ddp(card, no_tf32, params, fd, frame_item,
                {'data': data, 'pre': pre}, tmp)
    print(card)
    if FAILURES:
        print(f'{len(FAILURES)} check(s) failed: {FAILURES}', flush=True)
        sys.exit(1)


def iso_init_probe():
    """`python3 chip_smoke.py --iso-init`: the iso init kernel alone (the
    kernels' build and ptxas check, the fitted scene, F's check at phase 1
    and 2 with the init held beside it, then `check_iso_init`); exits
    non-zero on a failed check. Prints no result lines."""
    import torch
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from arah_tpu_torch.nn.skinning import skinning_dense_params
    from arah_tpu_torch.ops import _build
    from arah_tpu_torch.render.renderer import generate_sdf, make_skin_fn
    from arah_tpu_torch.scene import build_scene, flagship_config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f'card: {card}', flush=True)
    t0 = time.perf_counter()
    _build.load()
    print(f'kernels loaded in {time.perf_counter() - t0:.1f} s', flush=True)
    ptxas_check()
    cfg = flagship_config()
    params, fd, inp = build_scene(cfg, RAYS, seed=0)
    gen = generate_sdf(params, cfg, inp.rots, inp.Jtrs, inp.geo_latent)
    wts, bs = skinning_dense_params(params['skinning'], cfg.skinning)
    check_iso(cfg, make_skin_fn(params, cfg), wts, bs, fd, inp, gen, card)
    rec = check_iso_init(cfg, params, fd, gen, wts, bs, card)
    print(f'iso_init: {rec["ms"]:.4f} ms kernel at 32768 rays, '
          f'{rec["plain_ms"]:.3f} ms plain, bound {rec["bound"][0]:.4f} ms, '
          f'the eager init {rec["eager_ms"]:.3f} ms [{card}]', flush=True)
    print(card)
    if FAILURES:
        print(f'{len(FAILURES)} check(s) failed: {FAILURES}', flush=True)
        sys.exit(1)


if __name__ == '__main__':
    if sys.argv[1:2] == ['--rank']:
        rank_main(sys.argv[2:])
    elif sys.argv[1:2] == ['--phase11']:
        phase11_probe()
    elif sys.argv[1:2] == ['--phase12']:
        phase12_probe()
    elif sys.argv[1:2] == ['--iso-init']:
        iso_init_probe()
    else:
        main()
