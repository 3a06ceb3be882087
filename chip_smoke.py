"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Builds the port's native libraries from this checkout (into
build/raytracingtest_tpu_torch/, all at once), checks every hand-written
kernel against its plain PyTorch version on the card, then drives the
benchmark frame, the depth-10 `terrain` SVO seen by bench.py's camera at
1024x1024, forward two ways:

  * ray by ray, through `diff.render_diff_cuda` (kernels `esvo_trace` and
    `shade_fwd`), and
  * tile by tile, through `diff.render_diff_tile` with bench.py's budgets
    (kernels `tile_candidates` and `tile_walk`, three launches each a frame,
    and `shade_fwd`),

  * ray by ray through the brick trace, `diff.render_diff_brick` (kernels
    `brick_trace` and `shade_fwd`; bench.py's BENCH_PATH=brick), and
  * ray by ray through the stackless trace, `diff.render_diff` (kernels
    `esvo_stackless` and `shade_fwd`; bench.py's BENCH_PATH=plain),

and as a training step on all four traversals (`diff.loss_and_grads_cuda`,
`diff.loss_and_grads_tile`, `diff.loss_and_grads_brick`,
`diff.loss_and_grads`: the forward frame, then `shade_bwd` and the
sort-free `segment_sum`), and takes three `InverseRenderer.step_view` steps
on that view and three `InverseRenderer.step` steps on its flat batch of
rays (the brick step). `brick_trace` and `esvo_stackless` are held bitwise
against their plain versions (hits, hit_t bits, step counts and statistics)
on small cases and on the full frame, the brick trace in its forms (wide,
the main path's; first; wide without staged rows) and both in their probe
forms; the rays on which the frames part from `esvo_trace` go to a float64
referee; no call of their plain versions, and no launch of another form,
may happen on their paths. `[warps]` runs each form's probe on the frame
and prints where its warps spend their issues and cycles and when the last
warps end. The two traversal kernels of the first slices
keep their first forms beside them, `esvo_trace_serial` and
`tile_walk_serial` (one thread a ray, off the main path): each kernel is held bitwise against its plain version and its first
form, the walker on each of the frame's three launches and at every number
of lanes a ray, and each pair is timed in turns. `tile_candidates` (phase 1
of the tile trace) is held bitwise against `tile.candidates_plain` on each
of the frame's three calls and on small cases, and timed in turns against
it, beside its radix form (`tile_candidates_radix`, off the path; the
small cases hold it and the brickmap mode's two forms too); no call of the
plain version may happen on the tile frame's or the tile step's path. It runs the probe kernels
(`brick_dda16`, `rowread`, `take`, `loop_probe`, and the sorted form of the
segment sum) at the sizes of the probes they replace, `take` also at the
main path's size; `loop_probe` in its ranged form and its first form
(`loop_probe_serial`), both bitwise against the plain version also on inputs
outside [0, 1], timed in turns and alone, beside the issue and latency
floors at the SM clock read under load. `[wrapper]` times the parts of two
wrappers' launch paths on the host (`rowread_rows`; `take_1d` at the main
path's size, before and since the launcher `csrc/launch.cpp`) beside
`index_select`, and the host time of the main path's `shade_fwd` and
`tile_walk` calls; `[host]` counts the tile frame's and tile step's eager
ops on the host by group.

The serving renderers: `[frame-volumetric]` drives `VolumetricRenderer.render`
(k = 4; the brick route: kernels `brick_trace_multi` and `composite_fwd`) and
`diff.render_volumetric` (the stackless route: `esvo_stackless_multi` and
`composite_fwd`) on the same frame, holds both k-segment traces bitwise and
`composite_fwd` to 1e-6 against their plain versions (there and on small
cases in `[parity]`), counts the rays each trace stops at a bound and the
rays on which the two part (printing them, `[parting]`, and saving their
origins and directions as float32 bits to build/; the reference's two walks
part on the same rays when its arithmetic rounds as the port's does, F19),
checks slot 0 against `esvo_stackless`'s hit, and that a parameter which
requires a gradient gets one on the card. The brick trace has two forms:
a staged form (the walk of `brick_trace`'s wide form in collect mode, each
ray's k slots staged in its warp's shared memory and written out when the
warp's walks end, in blocks of 32; the main path's up to
`brick_cuda.STAGED_MAX_K`) and a first form (one thread a ray in blocks of
128, each segment written as found; the main path's above it). The
stackless trace has a patched form (the main path's: warps of 8 x 4 pixel
patches where the rays are an image, one 16-byte node row read where the
node changes) and its first form. The first forms off the main paths are
launched once in `[probes]` and timed in turns against them, the brick
trace's also at larger k in `[timing-k]`. Every form, and every probe
form, is held bitwise against the plain versions on the frame, on small
cases at k = 1, 4, 7 and at the k where the rule changes, on a ragged ray
count; `[warps]` reads every probe form on the frame.
`[stackless-forms]` holds the three stackless traces' patched forms
(`esvo_stackless`, `esvo_stackless_lod`, `esvo_stackless_multi`; the first
forms are their `_serial` entries) bitwise against their first forms and
plain versions on two ragged images at every block it sweeps, and on the
frame times, in turns and alone, and probes the two changes alone and
together: the first form on the rays taken in the patch order, the patched
form on the rays in their order and with the image's width.
`[brick-lod-forms]` holds the LOD brick trace's patched form (`brick_trace_lod`'s
main path: warps of 8 x 4 pixel patches, blocks of 64, 128 or 256) and its
first form (`brick_trace_lod_serial`) and both probe forms bitwise against
`brick.trace_brick_lod` on two ragged images, and on the frame against each
other at c0 and 8 c0 and against `brick_trace` at 0; it times them in turns
and alone at each block, beside `brick_trace` at 0, and reads both probe
forms' warps at c0 and 8 c0.
`[frame-lod]` renders the frame as `cli render --lod-coef` does at depth 10
(node attributes on the host, `brick_trace_lod`, `lod.shade_lod`) and through
`lod.render_lod` (`esvo_stackless_lod`) at four footprint coefficients: the
camera's pixel footprint c0, 8 c0, 0.4 and 0; both LOD kernels are held
bitwise against their plain versions at c0 and 8 c0 (and on small cases in
`[parity]`), against `brick_trace` and `esvo_stackless` at 0, and against
each other at 0.4. `[step-volumetric]` takes the volumetric L2 step on both
routes under `torch.autograd.grad` (kernels: the k-segment trace,
`composite_fwd`, `composite_bwd`, `segment_sum`), holds `composite_bwd` to
rtol 1e-5 against `composite_bwd_plain`, the per-leaf sums bitwise against
a serial scatter-add, and the gradients against builtin autograd of
`shade_cuda.composite_rows` on the card.
`[surface]` drives `SurfaceRenderer` on each of its routes (the tile route
through `render_progressive` with four samples, the brick route on a 1000²
pinhole and on an orthographic camera, `render.render_image` for a skybox off
the tile route), `render.render_attachment` and `render.render_bounce`, each
with the kernels it must launch and no other. `[cli]` runs the command line,
`raytracingtest_tpu_torch.cli.main`, in this process on the card: `render` of
the depth-10 tree (loaded from its npz under the JAX package's cache name) at
1024² on each branch (the default with four samples, `--skybox procedural`,
`--lod-coef` c0, `--attachments`, `--specular 0.5 --bounces 3`,
`--volumetric-k 4`, `--load`), each PNG decoded by this script's own reader and
equal pixel for pixel to the direct call's image, each branch launching its
route's kernels and no plain version; `fit` (four 1024² views, four steps, a
falling loss, a state file that reloads), `info`, `debug` (the probe's leaves
against `trace_multi_cuda`'s, the overlay against the direct call's pixels),
`render` of the three noise scenes built at depth 8, `fly` on both paths and a
scripted `probe`. `[fly]` streams the whole world at depth 10 and holds its
1024² tile frame against the monolithic one, `tile_candidates_mapped` (phase
1's radix form, the main path's, and its first form,
`tile_candidates_mapped_first`: `[cand-forms]` times both, in turns and
alone, on the streamed
frame's three calls, its main call unmapped and the first two-LOD frame's
six calls, and `[cand-warps]` reads both probe forms there),
`clipmap_trace` and `clipmap_trace_brick` (each in its wide form, the main
path's, and its first form, `clipmap_trace_serial` and
`clipmap_trace_brick_serial`) against their plain versions on that world, on
the first two-LOD frame of `cli fly`'s camera path and at its last pose,
probes both forms of both on that frame (`[warps]`, six and seven phases),
times each form alone and in turns, and times that path. `[build-device]` runs
bench.py's BENCH_BUILD=device, `octree_device.build_svo_device` of the
depth-10 tree on the card (kernels `svo_columns`, `svo_expand`,
`svo_compact`, `svo_leaves`, `svo_leaf_attrs`, `svo_level_pass`, over the
scene library `csrc/scene.cuh`),
twice, each build under `expect_launches`; holds its structure bit for bit
and its attributes to 1e-5 (albedo) and 2e-3 (normal) against the host
build, the brick frame over it against the host tree's hits bit for bit,
each kernel against its plain version at its largest call, the octant build
(`build_svo_device_split`) against the monolithic one, and the nine scenes
of the library (`scene_eval`) against the host's at 2^20 dyadic centres and
2^20 random points (parting bits counted, none allowed at the centres);
and builds the command line's three noise scenes on the card at depth 8,
held after `[cli]` against its host builds. The leaf test (`svo_leaves` and
`svo_leaf_attrs`) is held against its first form, `svo_leaves_serial`, on
every build of the phase, the nine scenes at depths 6 and 8 among them (at
depth 6 against the plain versions too), with where its probes' values come
from and the evaluations it makes. The expansion (`svo_columns` and
`svo_expand`) is held bit for bit against its first form,
`svo_expand_serial`, and its plain version on every expansion of the
depth-10 build, the nine scenes at depths 6 and 8 and the octant build,
with each level's evaluations and both forms' µs. The level pass
(`svo_level_pass`, phases C and D) is held bit for bit against the first
forms, `svo_level_up` with `svo_compact`'s count and place modes and
`svo_parent_ptr` over the assembled tree, on every level of the same builds
and of the depth-12 octant build; phases C and D are timed at level 9's
call in their forms and against their library pairs, and one build and one
octant are traced by phase (`build_phases.py`). `[sharded]` runs the sharded
renderer (`parallel/`) in a real NCCL world of one: the depth-12 terrain
built on the card octant by octant and split at level 2 (`split_svo`), traced
at 2048² through bench.py's camera by `make_sharded_trace` (kernel
`level_round`, mode "sharded", K10b) and `make_exchange_trace` (modes
"trunk" and "packets", K10c; no ray truncated) and trained one step by
`make_sharded_fit_step`; each round of each mode held bitwise against
`level_round_plain`, on the main path and in the queued form and the first
form (`level_round_serial`) alone, with each round's live rays, µs and
bound, the first form's probe on the first rounds, and both forms' loops
in turns; the round's queue (`level_queue`, in one pass) and its first form
(`level_queue_serial`) on every queued round of both traces against
`level_queue_plain` and the main path's queue, and alone on the sharded
trace's round 2 against `torch.nonzero`; each path against its plain rounds on a fixed
subset of 512² of its rays, the trace against `clipmap_trace` on the same
tables; then on the depth-10 frame `render_sharded` and the three sharded
train steps against the unsharded ones (bit for bit), and two
`InverseRenderer(n_devices=1)` steps.
One line per phase; any failure raises and the exit code is non-zero.
The last two lines are a JSON record of the kernels and the device. Without
a CUDA device it fails before printing any result.
"""

import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import struct
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

from raytracingtest_tpu_torch import _build, cli, diff, render, viz
from raytracingtest_tpu_torch.config import CameraConfig, RenderConfig
from raytracingtest_tpu_torch.io import checkpoint, hdr
from raytracingtest_tpu_torch.models import (
    InverseRenderer, StreamingRenderer, SurfaceRenderer, VolumetricRenderer)
from raytracingtest_tpu_torch.models import renderers
from raytracingtest_tpu_torch.ops import (
    brick, brick_cuda, brick_dda, camera, codecs, gather, lod, octree,
    octree_cuda, octree_device, rowread, shade_cuda, tile, tile_cuda, traverse,
    traverse_cuda)
from raytracingtest_tpu_torch.render import (
    make_gradient_skybox, sky_color, sky_texture)
from raytracingtest_tpu_torch.scenes import SCENES, Scene, get_scene
from raytracingtest_tpu_torch.parallel import level_sharded
from raytracingtest_tpu_torch.stream import clipmap

import build_phases

OUTPUTS = ("hit_leaf", "hit_parent", "hit_child", "iters")

# the tile frame's budgets: bench.py's BENCH_PATH=tile defaults
TILE_BUDGETS = dict(k_max=96, fb_tiles=96, fb_k=160, fb2_tiles=16, fb2_split=2)

# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory rate,
# and the float32 rate outside the tensor cores, which is the rate of these
# kernels' scalar float and integer work.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# Arithmetic and logic operations of one trip of each kernel's loop, counted
# from the source: one PUSH/ADVANCE/POP step of esvo_trace, one DDA step of
# tile_walk and brick_dda16, and the setup of one ray.
OPS_ESVO_STEP = 40
OPS_DDA_STEP = 32
OPS_RAY_SETUP = 40
# the set-up's two parts: the direction's (a component's clamp of |d| (its
# absolute value, two compares, a select), -1/|d|, the octant bit's compare
# and xor), which every walk of a ray shares, and the origin's, a walk's own
OPS_DIR_SETUP = 21
OPS_WALK_SETUP = OPS_RAY_SETUP - OPS_DIR_SETUP
# shading one hit ray forward, and its backward (which repeats the forward)
OPS_SHADE_FWD = 45
OPS_SHADE_BWD = 100
# phase 1 (tile_candidates): the occupancy test of a child slot (its parent
# from shared memory, the bit of the pyramid word), and the cull and key of
# an occupied child: unmorton 41, the cell's offset from the apex 12, four
# plane tests 28, the half-space 7, t_lb 15, the key 7
OPS_CAND_SLOT = 6
OPS_CAND_CHILD = 110

# compositing one valid segment (its row's normalisation and Lambert term,
# softplus, the opacity, the transmittance and the sum) and one ray (the sky,
# the light, the sky's term)
OPS_COMPOSITE_SLOT = 60
OPS_COMPOSITE_RAY = 25
# the volumetric renderers' segments a ray, and the composite's density scale
VOLUME_K = 4
DENSITY_SCALE = 64.0
# the backward of one valid slot: its forward again (OPS_COMPOSITE_SLOT) and
# the reverse (the albedo, normal and density cotangents and the carried
# transmittance's), counted from composite_bwd_kernel
OPS_COMPOSITE_BWD_SLOT = 130
# the LOD frames' footprint coefficients: the pixel footprint of bench.py's
# 1024-pixel camera (2 tan(fov / 2) / height, trace_lod_jax's docstring), the
# reference test's coarse setting (8 c0), its brick-parity setting and 0
LOD_C0 = 2.0 * np.tan(np.radians(25.0)) / 1024
LOD_COEFS = (("c0", LOD_C0), ("8c0", 8 * LOD_C0), ("0.4", 0.4), ("0", 0.0))

# calls of plain versions that the main path must not make, counted by
# count_plain_calls()
# the SVO builder's plain versions, each counted as a plain call
OCTREE_PLAIN = ("columns_plain", "expand_plain", "count_plain", "compact_plain",
                "leaves_plain",
                "leaf_attrs_plain", "leaves_serial_plain", "level_pass_plain",
                "level_up_plain", "parent_ptr_plain", "scene_eval_plain")
PLAIN_CALLS = {"candidates_plain": 0, "trace_brick": 0, "trace_stackless": 0,
               "trace_multi": 0, "trace_brick_multi": 0, "composite_plain": 0,
               "trace_lod": 0, "trace_brick_lod": 0, "composite_bwd_plain": 0,
               "trace_clipmap_rounds": 0, "remap_ids": 0, "level_round_plain": 0,
               **{name: 0 for name in OCTREE_PLAIN}}
# the launch counts of the kernels this checkout adds to the earlier ones'
MULTI_ZERO = dict(esvo_stackless_multi=0, brick_trace_multi=0,
                  esvo_stackless_lod=0, brick_trace_lod=0, clipmap_trace=0,
                  clipmap_trace_brick=0, level_round_sharded=0, level_round_trunk=0,
                  level_round_packets=0, level_queue=0)
# the compositing backward's, the LOD traces', the SVO builder's, the
# streamed world's and the level-sharded rounds' plain calls and launches that
# the training steps must not make
STEP_ZERO = dict(trace_lod=0, trace_brick_lod=0, composite_bwd_plain=0,
                 composite_bwd=0, trace_clipmap_rounds=0, remap_ids=0,
                 level_round_plain=0, **{name: 0 for name in OCTREE_PLAIN})
STAT = traverse.STAT_NAMES.index
# the brick and stackless traces' launch counts: the main path's wrapper,
# the brick trace's other forms' and the probe forms'
BRICK_COUNTS = (brick_cuda.launches, brick_cuda.form_launches,
                brick_cuda.probe_launches)
# the threads of brick_trace_multi's staged form's blocks
STAGED_BLOCK = brick_cuda.BLOCKS[("brick_trace_multi", "staged")]
# brick_trace.cu's kernels other than the staged k-segment forms, the
# stackless traces' patched forms and the probe forms, at their registers as
# ptxas gave them before the staged form (the stackless traces' first forms,
# esvo_stackless_kernel<false>, esvo_stackless_lod_kernel and
# esvo_stackless_multi_kernel, among them)
EARLIER_REGS = {
    "brick_trace_kernel<false, false, 256>": 59, "brick_trace_kernel<true, false, 256>": 63,
    "brick_trace_kernel<false, false, 128>": 56, "esvo_stackless_kernel<false>": 45,
    "brick_trace_lod_kernel": 64, "esvo_stackless_lod_kernel": 47,
    "brick_trace_multi_kernel<false>": 56, "esvo_stackless_multi_kernel": 47,
    "clipmap_trace_kernel<false>": 61, "clipmap_trace_kernel<true>": 64}
# the k-segment traces' kernels as torch.profiler names them: the brick
# trace's staged form (its main path's), its first form, and the stackless
# trace's patched form (its main path's) and first form
MULTI_KERNELS = {
    "brick_trace_multi": "brick_trace_multi_staged_kernel<false>",
    "brick_trace_multi_serial": "brick_trace_multi_kernel<false>",
    "esvo_stackless_multi": "esvo_stackless_multi_patched_kernel<false>",
    "esvo_stackless_multi_serial": "esvo_stackless_multi_kernel"}
# each form's kernel, as torch.profiler names it, and the main path's form
FORM_KERNELS = {
    ("brick_trace", "wide"): "brick_trace_kernel<true, false, 256>",
    ("brick_trace", "first"): "brick_trace_kernel<false, false, 128>",
    ("brick_trace", "unstaged"): "brick_trace_kernel<false, false, 256>",
    ("esvo_stackless", "patched"): "esvo_stackless_patched_kernel<false, false>",
    ("esvo_stackless", "first"): "esvo_stackless_kernel<false>",
}
# the LOD stackless trace's forms' kernels (esvo_stackless's forms), and
# the LOD brick trace's
LOD_KERNELS = {"patched": "esvo_stackless_patched_kernel<false, true>",
               "first": "esvo_stackless_lod_kernel"}
BRICK_LOD_KERNELS = {"patched": "brick_trace_lod_patched_kernel<false>",
                     "first": "brick_trace_lod_kernel"}
MAIN_FORM = {"brick_trace": "wide", "esvo_stackless": "patched"}
# the err key of a trace_forms entry
FORM_ERR = {"main": "", "first": "_serial", "unstaged": "_unstaged"}
# the stackless traces' patched form's blocks that [stackless-forms] sweeps
PATCH_BLOCKS = (64, 128, 256)


def say(*parts):
    print(*parts, flush=True)


def random_rays(n, seed, toward=(0.5, 0.5, 0.5), spread=0.35):
    """Rays from random points on a radius-2 shell aimed near `toward`."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    o = np.asarray(toward) + 2.0 * v
    target = np.asarray(toward) + rng.normal(0, spread, (n, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def bits(t):
    """A float32 tensor's bits, for bitwise comparison."""
    return t.contiguous().view(torch.int32)


def compare(kern, plain, what):
    """Exact equality of every trace output (hit_t bitwise); returns the
    largest absolute difference seen (0.0 when exact)."""
    err = float((kern.hit_t - plain.hit_t).abs().max()) if kern.hit_t.numel() else 0.0
    for name in OUTPUTS:
        a, b = getattr(kern, name), getattr(plain, name)
        if not torch.equal(a, b):
            bad = int((a != b).sum())
            raise AssertionError(f"{what}: {name} differs on {bad} rays")
    if not torch.equal(bits(kern.hit_t), bits(plain.hit_t)):
        raise AssertionError(f"{what}: hit_t differs bitwise (max abs {err})")
    return err


def compare_tensors(kern, plain, names, what):
    """Bitwise equality of tuples of tensors; returns the largest absolute
    difference among the float ones (0.0 when exact)."""
    err = 0.0
    for name, a, b in zip(names, kern, plain):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{what}: {name} has another shape or type")
        same = torch.equal(bits(a), bits(b)) if a.is_floating_point() else torch.equal(a, b)
        if not same:
            bad = int((a != b).sum())
            raise AssertionError(f"{what}: {name} differs on {bad} elements")
        if a.is_floating_point():
            finite = torch.isfinite(a) & torch.isfinite(b)
            if bool(finite.any()):
                err = max(err, float((a[finite] - b[finite]).abs().max()))
    return err


def cuda_ms(fn, reps, warmup):
    """Milliseconds of each of `reps` calls of fn() on the card, from CUDA
    events, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return np.asarray(times)


def in_turns(variants, rounds=3, reps=50):
    """name -> the milliseconds of rounds * reps calls of each of `variants`
    (name -> fn), every round timing each variant in turn: a host's mood
    lasts longer than one variant's 50 calls, and would favour one of them."""
    samples = {name: [] for name in variants}
    for _ in range(rounds):
        for name, fn in variants.items():
            samples[name].append(cuda_ms(fn, reps, 3))
    return {name: np.concatenate(v) for name, v in samples.items()}


def med_p80(times):
    return float(np.median(times)), float(np.percentile(times, 80))


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of bytes over the memory rate and operations over the float32 rate."""
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = n_ops / PEAK_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def reset_counts():
    for mod in (traverse_cuda, tile_cuda, brick_dda, rowread):
        mod.launches = 0
    traverse_cuda.serial_launches = tile_cuda.serial_launches = 0
    tile_cuda.candidates_launches = tile_cuda.candidates_block_launches = 0
    tile_cuda.candidates_mapped_launches = tile_cuda.candidates_mapped_first_launches = 0
    tile_cuda.candidates_radix_launches = tile_cuda.candidates_probe_launches = 0
    for name in PLAIN_CALLS:
        PLAIN_CALLS[name] = 0
    for counts in (gather.launches, shade_cuda.launches, octree_cuda.launches,
                   *BRICK_COUNTS):
        for name in counts:
            counts[name] = 0


def count_plain_calls():
    """From here on, count every call of ``tile.candidates_plain``,
    ``brick.trace_brick``, ``traverse.trace_stackless``, the k-segment and
    LOD traces' plain versions, ``shade_cuda.composite_plain`` and
    ``shade_cuda.composite_bwd_plain`` in PLAIN_CALLS (their callers look
    them up in their modules at each call)."""
    for mod, name, key in ((tile, "candidates_plain", "candidates_plain"),
                           (brick, "trace_brick", "trace_brick"),
                           (traverse, "trace_stackless", "trace_stackless"),
                           (traverse, "trace_multi", "trace_multi"),
                           (brick, "trace_brick_multi", "trace_brick_multi"),
                           (shade_cuda, "composite_plain", "composite_plain"),
                           (traverse, "trace_lod", "trace_lod"),
                           (brick, "trace_brick_lod", "trace_brick_lod"),
                           (shade_cuda, "composite_bwd_plain", "composite_bwd_plain"),
                           (clipmap, "trace_clipmap_rounds", "trace_clipmap_rounds"),
                           (tile, "remap_ids", "remap_ids"),
                           (level_sharded, "level_round_plain", "level_round_plain"),
                           *((octree_cuda, name, name) for name in OCTREE_PLAIN)):
        plain = getattr(mod, name)

        def counted(*args, _plain=plain, _key=key, **kw):
            PLAIN_CALLS[_key] += 1
            return _plain(*args, **kw)
        setattr(mod, name, counted)


def compare_stats(kern, plain, what):
    """A trace and its statistics ((TraceResult, stats) pairs) bitwise, as
    ``compare`` does; returns the largest absolute difference of hit_t."""
    err = compare(kern[0], plain[0], what)
    if not torch.equal(kern[1], plain[1]):
        bad = int((kern[1] != plain[1]).any(dim=1).sum())
        raise AssertionError(f"{what}: the statistics differ on {bad} rays")
    return err


MULTI_NAMES = ("hit_leaf", "t_in", "t_out", "count", "iters", "stats")


def multi_compare(kern, plain, what):
    """Two (MultiTraceResult, stats) pairs bitwise; returns the largest
    absolute difference of the t's (0.0 when exact)."""
    (a, sa), (b, sb) = kern, plain
    return compare_tensors((a.hit_leaf, a.t_in, a.t_out, a.count, a.iters, sa),
                           (b.hit_leaf, b.t_in, b.t_out, b.count, b.iters, sb),
                           MULTI_NAMES, what)


def segments_apart(a, b):
    """Rays on which two MultiTraceResults give other segments (leaf, count,
    or the bits of a t)."""
    return ((a.hit_leaf != b.hit_leaf).any(dim=1) | (a.count != b.count)
            | (bits(a.t_in) != bits(b.t_in)).any(dim=1)
            | (bits(a.t_out) != bits(b.t_out)).any(dim=1))


def volume_params(host, dev, seed):
    """The tree's parameters with random densities across softplus's bend
    and normals of random length, on `dev`."""
    rng = np.random.default_rng(seed)
    n = host.n_leaves
    as_dev = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    return (host.leaf_albedo.to(dev),
            as_dev(host.leaf_normal.numpy() * rng.uniform(0.5, 2.0, (n, 1))),
            as_dev(rng.uniform(-3.0, 2.0, n)))


def check_composite(seg, d, pset, light, what):
    """composite_fwd against composite_plain on the same segments; returns
    the largest absolute difference (limit 1e-6)."""
    got = shade_cuda._composite_kernel(seg.hit_leaf, seg.t_in, seg.t_out, d,
                                       *pset, light, 1.3, 0.08, DENSITY_SCALE)
    want = shade_cuda.composite_plain(seg.hit_leaf, seg.t_in, seg.t_out, d,
                                      *pset, light, 1.3, 0.08, DENSITY_SCALE)
    torch.cuda.synchronize()
    e = float((got - want).abs().max()) if got.numel() else 0.0
    if got.shape != want.shape or not e <= 1e-6:
        raise AssertionError(f"composite_fwd, {what}: max abs {e} against "
                             f"composite_plain")
    return e


def multi_forms(kname, tree, o, d, k, width=None):
    """form -> (MultiTraceResult, stats) of one k-segment trace on these
    rays: through the main path's wrapper ("main"), also in its first form,
    and every form the rule gives k in its probe form; the stackless trace's
    patched form also without `width` (the rays' image width, or None)."""
    if kname == "esvo_stackless_multi":
        out = {"main": brick_cuda._stackless_multi_kernel(tree, o, d, k, True, width),
               "first": brick_cuda._stackless_multi_kernel(tree, o, d, k, True,
                                                           form="first"),
               "first probe": brick_cuda.probe_stackless_multi_cuda(tree, o, d, k)[:2],
               "patched probe": brick_cuda.probe_stackless_multi_cuda(
                   tree, o, d, k, "patched", width)[:2]}
        if width is not None:
            out["patched, rays in order"] = brick_cuda._stackless_multi_kernel(
                tree, o, d, k, True)
        return out
    out = {"main": brick_cuda._brick_multi_kernel(tree, o, d, k, True),
           "first": brick_cuda._brick_multi_serial_kernel(tree, o, d, k, True)}
    for form in brick_cuda.FORMS[kname]:
        if form == "first" or k <= brick_cuda.STAGED_MAX_K:
            out[f"{form} probe"] = brick_cuda.probe_brick_multi_cuda(tree, o, d, k, form)[:2]
    return out


# the k at which the brick trace's staged form's block first passes 48 KB
# of shared memory (and opts in to more) and at which the main path turns
# to the first form (the last k of one and the first of the next)
MULTI_RULE_KS = (117, 118, 594, 595)
# the k at which [timing-k] times the brick trace's main path against its
# first form on the frame
MULTI_TIMING_KS = (16, 54, 118, 300, 594)
# the k-segment traces on the depth-10 frame at k = 4: the rays on which
# the two part where neither is cut (F19), and the rays each bound stops
MULTI_PARTING, MULTI_UNFINISHED = 15, {"brick_trace_multi": 0, "esvo_stackless_multi": 463}


def check_multi_forms(kname, tree, o, d, k, plain, err, what, width=None):
    """Every form of one k-segment trace bitwise against its plain version
    (a (MultiTraceResult, stats) pair); returns the main path's result."""
    forms = multi_forms(kname, tree, o, d, k, width)
    torch.cuda.synchronize()
    for form, got in forms.items():
        e = multi_compare(got, plain, f"{kname} {form}, {what}")
        if form == "main":
            err[kname] = max(err[kname], e)
        elif form == "first":
            err[kname + "_serial"] = max(err[kname + "_serial"], e)
    return forms["main"]


def multi_rule_parity(dev, err):
    """[parity] of the brick k-segment trace at the k where its staged
    form's block passes 48 KB of shared memory and where the main path
    turns to the first form, on 4,133 rays (a ragged last block and warp)
    of a depth-6 terrain: each form bitwise against the plain version, and
    the main path's wrapper through the form the rule names."""
    host = octree.build_svo(get_scene("terrain"), 6).svo
    bsvo = brick.make_brick_svo(host).to(dev)
    o, d = (torch.from_numpy(a).to(dev) for a in random_rays(4133, 61))
    found = []
    for k in MULTI_RULE_KS:
        staged = k <= brick_cuda.STAGED_MAX_K
        reset_counts()
        want = brick.trace_brick_multi(bsvo, o, d, k, True)
        seg = check_multi_forms("brick_trace_multi", bsvo, o, d, k, want, err,
                                f"terrain d6 N=4133 k={k}")
        # the main path launches the staged form up to STAGED_MAX_K, else
        # the first form
        got = (brick_cuda.launches["brick_trace_multi"],
               brick_cuda.form_launches["brick_trace_multi_serial"])
        if got != ((1, 1) if staged else (0, 2)):
            raise AssertionError(f"brick_trace_multi k={k}: launched (staged, first) "
                                 f"{got}; the rule gives the "
                                 f"{'staged' if staged else 'first'} form")
        found.append(f"k={k} {'staged' if staged else 'first'} form "
                     f"({int(seg[0].count.sum())} segments)")
    say("[parity] brick_trace_multi at the k where its staged form's block "
        "passes 48 KB of shared memory and where the main path turns to the "
        "first form (brick_cuda.STAGED_MAX_K), on 4,133 rays of terrain d6 "
        "(a ragged last block and warp): the main path's wrapper, the first "
        "form and the probe forms == the plain version bitwise; "
        + ", ".join(found))


def volumetric_parity(dev, cam, light, err):
    """[parity] of the k-segment traces (through their launchers, in every
    form and probe form) and the compositing against their plain versions
    on small trees: the empty tree, a depth-4 tree (a top tree of one
    level), camera rays, rays from a shell and rays from inside the cube,
    at k = 1, 4 and 7; then at the k where the brick trace's rule changes,
    on a ragged ray count."""
    empty = Scene("empty", lambda x, y, z: np.ones_like(np.asarray(x, np.float32)), 0.0)
    lines, n_cases = [], 0
    for name, depth in (("sphere", 5), ("terrain", 6), ("terrain", 7),
                        ("flat_ground", 6), ("empty", 5), ("sphere", 4)):
        host = octree.build_svo(empty if name == "empty" else get_scene(name), depth).svo
        svo_s, bsvo_s = host.to(dev), brick.make_brick_svo(host).to(dev)
        pset = volume_params(host, dev, depth) if host.n_leaves else None
        found = []
        for kind, o, d in ray_sets(dev, cam, 4096, depth + 100):
            for k in (1, VOLUME_K, 7):
                what = f"{name} d{depth} {kind} rays N={o.shape[0]} k={k}"
                ps = traverse.trace_multi(svo_s, o, d, k, True)
                pb = brick.trace_brick_multi(bsvo_s, o, d, k, True)
                ks = check_multi_forms("esvo_stackless_multi", svo_s, o, d, k, ps, err,
                                       what, cam.width if kind == "camera" else None)
                kb = check_multi_forms("brick_trace_multi", bsvo_s, o, d, k, pb, err, what)
                if pset is not None:
                    for seg in (ks[0], kb[0]):
                        err["composite_fwd"] = max(err["composite_fwd"], check_composite(
                            seg, d, pset, light, what))
                elif int((ks[0].count > 0).sum()) or int((kb[0].count > 0).sum()):
                    raise AssertionError(f"{what}: a segment in the empty tree")
                n_cases += 1
                apart = segments_apart(ks[0], kb[0]) & (ks[1][:, 4] == 0) & (kb[1][:, 4] == 0)
                found.append(f"{kind} k={k} {int(ks[0].count.sum())} segments, "
                             f"{int(apart.sum())} apart")
        lines.append(f"{name} d{depth}: " + ", ".join(found))
    say(f"[parity] esvo_stackless_multi and brick_trace_multi (through their "
        f"launchers, each also in its first form, the stackless trace's "
        f"patched form with the camera's width and without, and in every "
        f"probe form) == "
        f"traverse.trace_multi and brick.trace_brick_multi bitwise "
        f"(hit_leaf, t_in and t_out bits, count, iters, statistics) on {n_cases} "
        f"cases, and composite_fwd within 1e-6 of composite_plain on each "
        f"case's segments of both traces (random densities in [-3, 2), normals "
        f"of random length; max abs {err['composite_fwd']}): " + "; ".join(lines)
        + " (segments of the stackless trace; rays on which the two traces' "
        "segments part where neither is cut)")
    multi_rule_parity(dev, err)


def launch_counts():
    """Every kernel's launches since reset_counts(), by name, and the plain
    versions' calls."""
    return dict(esvo_trace=traverse_cuda.launches, tile_walk=tile_cuda.launches,
                tile_candidates=tile_cuda.candidates_launches,
                tile_candidates_block=tile_cuda.candidates_block_launches,
                tile_candidates_mapped=tile_cuda.candidates_mapped_launches,
                tile_candidates_mapped_first=tile_cuda.candidates_mapped_first_launches,
                tile_candidates_radix=tile_cuda.candidates_radix_launches,
                tile_candidates_probe=tile_cuda.candidates_probe_launches,
                esvo_trace_serial=traverse_cuda.serial_launches,
                tile_walk_serial=tile_cuda.serial_launches,
                brick_dda16=brick_dda.launches, rowread=rowread.launches,
                **gather.launches, **brick_cuda.launches,
                **brick_cuda.form_launches, **brick_cuda.probe_launches,
                **shade_cuda.launches, **octree_cuda.launches, **PLAIN_CALLS)


def expect_launches(what, fn, want, allow=()):
    """Run fn() from zeroed counts; fail unless it launched exactly the
    kernels of `want` (name -> count) and no other, nor called a plain
    version. `allow` names kernels that may launch any number of times
    (the tile route's backstop on residual rays). Returns (fn()'s result,
    the launches)."""
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    got = {k: v for k, v in launch_counts().items() if v}
    extra = {k: v for k, v in got.items() if k not in want and k not in allow}
    short = {k: v for k, v in want.items() if got.get(k, 0) != v}
    if extra or short:
        raise AssertionError(f"{what}: launched {got}, expected {want}"
                             + (f" and any of {allow}" if allow else ""))
    return out, got


PARTING_RAYS = os.path.join(_build.BUILD_DIR, "parting_rays.npy")


def dump_parting_rays(apart, o, d, seg_b, seg_s):
    """The rays on which the two k-segment traces part, for a run of the
    reference on the host: (ray index, origin bits (3), direction bits (3))
    int64 rows, float32 bit patterns, saved to PARTING_RAYS and printed with
    both traces' segments."""
    rays = torch.nonzero(apart)[:, 0]
    rows = torch.cat([rays[:, None], bits(o[rays]).long(), bits(d[rays]).long()],
                     dim=1).cpu().numpy()
    os.makedirs(os.path.dirname(PARTING_RAYS), exist_ok=True)
    np.save(PARTING_RAYS, rows)
    for row, i in zip(rows.tolist(), rays.tolist()):
        seg = lambda s: (s.hit_leaf[i].tolist(), int(s.count[i]),
                         [f"{v:.9g}" for v in s.t_in[i].tolist()],
                         [f"{v:.9g}" for v in s.t_out[i].tolist()])
        say(f"[parting] ray {row[0]} origin bits {row[1:4]} direction bits "
            f"{row[4:7]}: brick {seg(seg_b)}, stackless {seg(seg_s)}")


def serving(ctx, card):
    """[frame-volumetric] and [surface]: the serving renderers at full
    width on the depth-10 frame. Returns what the kernels line and the
    profile take from them."""
    dev, host_svo, svo, bsvo = ctx["dev"], ctx["host_svo"], ctx["svo"], ctx["bsvo"]
    o, d, light, params = ctx["o"], ctx["d"], ctx["light"], ctx["params"]
    res, bench_cam, routes = ctx["res"], ctx["bench_cam"], ctx["routes"]
    n_rays, k = o.shape[0], VOLUME_K
    view = CameraConfig(**bench_cam, width=res, height=res)
    rcfg = RenderConfig()
    out = {}

    # ---- the volumetric renderers: main path, both routes ------------------
    vmodel = VolumetricRenderer(host_svo, k=k, density_scale=DENSITY_SCALE,
                                device=dev)
    renderers._accel_of(vmodel)    # the model's brick table, built on first use
    vol_img, vol_brick_launches = expect_launches(
        "VolumetricRenderer.render (brick route)", lambda: vmodel.render(view, rcfg),
        dict(brick_trace_multi=1, composite_fwd=1))
    vol_flat, vol_flat_launches = expect_launches(
        "diff.render_volumetric (stackless route)", lambda: diff.render_volumetric(
            *params, svo, o, d, light, k=k, density_scale=DENSITY_SCALE, width=res),
        dict(esvo_stackless_multi=1, composite_fwd=1))
    for what, img_v in (("brick route", vol_img.reshape(-1, 3)), ("stackless route", vol_flat)):
        if img_v.shape != (n_rays, 3) or not bool(torch.isfinite(img_v).all()):
            raise AssertionError(f"volumetric {what}: bad image")
    # each kernel against its plain version on the same card and inputs
    kb = brick_cuda._brick_multi_kernel(bsvo, o, d, k, True)
    ks = brick_cuda._stackless_multi_kernel(svo, o, d, k, True, res)
    t0 = time.perf_counter()
    pb = brick.trace_brick_multi(bsvo, o, d, k, True)
    torch.cuda.synchronize()
    out["brick_multi_plain_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ps = traverse.trace_multi(svo, o, d, k, True)
    torch.cuda.synchronize()
    out["stackless_multi_plain_ms"] = (time.perf_counter() - t0) * 1e3
    err = ctx["err"]
    err["brick_trace_multi"] = max(err["brick_trace_multi"], multi_compare(
        kb, pb, "brick_trace_multi, terrain d10 frame"))
    err["esvo_stackless_multi"] = max(err["esvo_stackless_multi"], multi_compare(
        ks, ps, "esvo_stackless_multi, terrain d10 frame"))
    # the brick trace's first form on the frame, and every form's probe form
    # with its warps' counters
    err["brick_trace_multi_serial"] = max(err["brick_trace_multi_serial"], multi_compare(
        brick_cuda._brick_multi_serial_kernel(bsvo, o, d, k, True), pb,
        "brick_trace_multi_serial, terrain d10 frame"))
    err["esvo_stackless_multi_serial"] = max(err["esvo_stackless_multi_serial"], multi_compare(
        brick_cuda._stackless_multi_kernel(svo, o, d, k, True, form="first"), ps,
        "esvo_stackless_multi_serial, terrain d10 frame"))
    multi_compare(brick_cuda._stackless_multi_kernel(svo, o, d, k, True), ps,
                  "esvo_stackless_multi, rays in order, terrain d10 frame")
    probes = [("brick_trace_multi", form, pb, None, lambda form=form: brick_cuda.probe_brick_multi_cuda(
                  bsvo, o, d, k, form)) for form in brick_cuda.FORMS["brick_trace_multi"]]
    for form in brick_cuda.FORMS["esvo_stackless_multi"]:
        width = res if form == "patched" else None
        probes.append(("esvo_stackless_multi", form, ps, width,
                       lambda form=form, width=width: brick_cuda.probe_stackless_multi_cuda(
                           svo, o, d, k, form, width)))
    out["warps"] = {}
    for kname, form, plain_r, width, probe in probes:
        got = probe()
        torch.cuda.synchronize()
        multi_compare(got[:2], plain_r, f"{kname} {form} probe, terrain d10 frame")
        out["warps"][(kname, form)] = warps_line(kname, form, got[2],
                                                 plain_r[0].iters.cpu().numpy(), width)
    say("[warps] the k-segment traces' probe forms (k=4; seg: a segment's "
        "record, its write in the first forms and its stage in shared memory "
        "in the brick trace's staged form, whose warps' write-out is its ray "
        "phase) == the plain versions bitwise")
    for what, seg in (("brick segments", kb[0]), ("stackless segments", ks[0])):
        err["composite_fwd"] = max(err["composite_fwd"], check_composite(
            seg, d, params, light, f"terrain d10 frame, {what}"))
    pset = volume_params(host_svo, dev, 12)
    err["composite_fwd"] = max(err["composite_fwd"], check_composite(
        kb[0], d, pset, light, "terrain d10 frame, random densities"))
    want_img = shade_cuda.composite_plain(kb[0].hit_leaf, kb[0].t_in, kb[0].t_out,
                                          d, *params, light, 1.3, 0.08, DENSITY_SCALE)
    vol_err = float((vol_img.reshape(-1, 3) - want_img).abs().max())
    if vol_err > 1e-6:
        raise AssertionError(f"VolumetricRenderer image {vol_err} off the plain path")
    cut_b = kb[1][:, STAT("unfinished")] == 1
    cut_s = ks[1][:, STAT("unfinished")] == 1
    neither = ~cut_b & ~cut_s
    apart = segments_apart(kb[0], ks[0]) & neither
    single = routes["plain"]["res"]
    first_ok = neither & ~routes["plain"]["unfinished"]
    slot0 = (ks[0].hit_leaf[:, 0] != single.hit_leaf) | (
        (single.hit_leaf >= 0) & (bits(ks[0].t_in[:, 0]) != bits(single.hit_t)))
    n_slot0 = int((slot0 & first_ok).sum())
    # the two traces are different walks: like the single-hit brick and
    # stackless frames, they may part on a few rays that graze a corner
    # (counted and bounded here, as the frames' parting rays are)
    apart_leaf = apart & ((kb[0].hit_leaf != ks[0].hit_leaf).any(dim=1)
                          | (kb[0].count != ks[0].count))
    t_gap = torch.cat([(kb[0].t_in - ks[0].t_in)[apart],
                       (kb[0].t_out - ks[0].t_out)[apart]]).abs()
    out["apart"] = (int(apart.sum()), int(apart_leaf.sum()),
                    float(t_gap.max()) if t_gap.numel() else 0.0)
    dump_parting_rays(apart, o, d, kb[0], ks[0])
    if n_slot0 or int(apart.sum()) > MAX_DIFFER:
        raise AssertionError(f"k-segment traces: {int(apart.sum())} rays part "
                             f"between the two, slot 0 differs from "
                             f"esvo_stackless on {n_slot0}")
    cut = {"brick_trace_multi": int(cut_b.sum()), "esvo_stackless_multi": int(cut_s.sum())}
    if k == VOLUME_K and (int(apart.sum()) != MULTI_PARTING or cut != MULTI_UNFINISHED):
        raise AssertionError(f"k-segment traces on the frame: {int(apart.sum())} rays "
                             f"part and {cut} stop at a bound, where the plain "
                             f"versions gave {MULTI_PARTING} and {MULTI_UNFINISHED}")
    # on the card, a parameter that requires a gradient gets one: the image
    # through composite_fwd, its backward through composite_bwd and
    # segment_sum
    needs_grad = params[0].detach().clone().requires_grad_(True)
    grad, grad_launches = expect_launches(
        "render_volumetric with a parameter that requires a gradient, and its "
        "gradient", lambda: torch.autograd.grad(diff.render_volumetric(
            needs_grad, params[1], params[2], svo, o, d, light, k=k,
            density_scale=DENSITY_SCALE).sum(), needs_grad)[0],
        dict(esvo_stackless_multi=1, composite_fwd=1, composite_bwd=1, segment_sum=1))
    if (grad.shape != params[0].shape or not bool(torch.isfinite(grad).all())
            or not float(grad.abs().max()) > 0.0):
        raise AssertionError("render_volumetric on the card: no finite gradient")
    out["segments"] = dict(
        brick=(int(kb[0].count.sum()), int(kb[0].iters.sum())
               - int(kb[1][:, STAT("dda_steps")].sum()),
               int(kb[1][:, STAT("dda_steps")].sum())),
        stackless=(int(ks[0].count.sum()), int(ks[0].iters.sum())))
    out["multi"] = (kb, ks)
    out["launches"] = dict(brick_trace_multi=vol_brick_launches["brick_trace_multi"],
                           esvo_stackless_multi=vol_flat_launches["esvo_stackless_multi"],
                           composite_fwd=vol_brick_launches["composite_fwd"])
    t = {}
    t["vol_model"] = cuda_ms(lambda: vmodel.render(view, rcfg), 50, 3)
    t["vol_brick"] = cuda_ms(lambda: diff.render_volumetric_brick(
        *params, bsvo, o, d, light, k=k, density_scale=DENSITY_SCALE), 50, 3)
    t["vol_flat"] = cuda_ms(lambda: diff.render_volumetric(
        *params, svo, o, d, light, k=k, density_scale=DENSITY_SCALE, width=res), 50, 3)
    t.update(in_turns({
        "brick_trace_multi": lambda: brick_cuda.trace_brick_multi_cuda(bsvo, o, d, k),
        "brick_trace_multi_serial": lambda: brick_cuda.trace_brick_multi_cuda_serial(
            bsvo, o, d, k),
        "esvo_stackless_multi": lambda: brick_cuda.trace_multi_cuda(svo, o, d, k,
                                                                    width=res),
        "esvo_stackless_multi_serial": lambda: brick_cuda.trace_multi_cuda_serial(
            svo, o, d, k),
        "composite_fwd": lambda: shade_cuda.composite_fwd(
            kb[0].hit_leaf, kb[0].t_in, kb[0].t_out, d, *params, light, 1.3,
            0.08, DENSITY_SCALE)}))
    t["composite_plain"] = cuda_ms(lambda: shade_cuda.composite_plain(
        kb[0].hit_leaf, kb[0].t_in, kb[0].t_out, d, *params, light, 1.3, 0.08,
        DENSITY_SCALE), 10, 2)
    m = {name: med_p80(v) for name, v in t.items()}
    out["ms"] = m
    seg_line = lambda r, st: (
        f"{int(r.count.sum()) / n_rays:.3f} segments a ray ({int((r.count == k).sum())} "
        f"rays full, {int((r.count == 0).sum())} with none), {float(r.iters.double().mean()):.2f} "
        f"steps a ray (most {int(r.iters.max())}), {int(st[:, STAT('unfinished')].sum())} "
        f"rays stopped at the bound")
    say(f"[frame-volumetric] {res}x{res} depth 10, k={k}: "
        f"VolumetricRenderer.render (brick route) launched {vol_brick_launches}, "
        f"diff.render_volumetric (stackless route) {vol_flat_launches}, no "
        f"other kernel and no plain call; brick_trace_multi: "
        + seg_line(*kb) + f", {int(kb[1][:, STAT('rounds')].max())} rounds at most, "
        f"{int(kb[1][:, STAT('dda_max')].max())} DDA steps in one round at most "
        f"(cap {brick.dda_multi_steps(k)}); esvo_stackless_multi: " + seg_line(*ks)
        + f" (bound {traverse.multi_steps_for_depth(10, k)}); both on their main "
        f"paths (the brick trace's staged form in blocks of "
        f"{STAGED_BLOCK} threads, the stackless trace's patched form with the "
        f"image's width and without), and each one's "
        f"first form, == their plain "
        f"versions bitwise (hit_leaf, t bits, count, iters, statistics; plain "
        f"{out['brick_multi_plain_ms']:.1f} and {out['stackless_multi_plain_ms']:.1f} "
        f"ms, n=1); composite_fwd within 1e-6 of composite_plain (max abs "
        f"{err['composite_fwd']}); the image == the plain path within "
        f"{vol_err}; of the {int(neither.sum())} rays neither trace cut, "
        f"{out['apart'][0]} have other segments in the two ({out['apart'][1]} "
        f"with another leaf or count, the rest only t bits; the t's of those "
        f"rays part by up to {out['apart'][2]}), and slot 0 == "
        f"esvo_stackless's hit on all {int(first_ok.sum())} that esvo_stackless "
        f"finishes too; a parameter that requires a gradient gets a finite, "
        f"nonzero one (launches {grad_launches})")
    say(f"[frame-volumetric] {card}: VolumetricRenderer.render median "
        f"{m['vol_model'][0]:.4f} ms (p80 {m['vol_model'][1]:.4f}, n=50) = "
        f"{n_rays / m['vol_model'][0] / 1e3:.2f} Mrays/s (its camera's rays and "
        f"light made anew each call); on the same rays, "
        f"diff.render_volumetric_brick median {m['vol_brick'][0]:.4f} ms (p80 "
        f"{m['vol_brick'][1]:.4f}) = {n_rays / m['vol_brick'][0] / 1e3:.2f} "
        f"Mrays/s and diff.render_volumetric "
        f"median {m['vol_flat'][0]:.4f} ms (p80 {m['vol_flat'][1]:.4f}) = "
        f"{n_rays / m['vol_flat'][0] / 1e3:.2f} Mrays/s; in turns, three rounds "
        f"of 50: brick_trace_multi {m['brick_trace_multi'][0]:.4f} ms (p80 "
        f"{m['brick_trace_multi'][1]:.4f}; the first form "
        f"{m['brick_trace_multi_serial'][0]:.4f}, p80 "
        f"{m['brick_trace_multi_serial'][1]:.4f}), esvo_stackless_multi "
        f"{m['esvo_stackless_multi'][0]:.4f} ({m['esvo_stackless_multi'][1]:.4f}; the "
        f"first form {m['esvo_stackless_multi_serial'][0]:.4f}, p80 "
        f"{m['esvo_stackless_multi_serial'][1]:.4f}), "
        f"composite_fwd {m['composite_fwd'][0]:.4f} ({m['composite_fwd'][1]:.4f}); "
        f"composite_plain {m['composite_plain'][0]:.4f} (n=10)")
    # the brick trace's main path at larger k (where the staged form opts in
    # to more shared memory, and at the last k it takes): against its first
    # form on the frame, bitwise, then in turns
    by_k = {}
    for kk in MULTI_TIMING_KS:
        multi_compare(brick_cuda._brick_multi_kernel(bsvo, o, d, kk, True),
                      brick_cuda._brick_multi_serial_kernel(bsvo, o, d, kk, True),
                      f"brick_trace_multi k={kk}, terrain d10 frame, against its first form")
        tk = in_turns({
            "staged": lambda kk=kk: brick_cuda.trace_brick_multi_cuda(bsvo, o, d, kk),
            "first": lambda kk=kk: brick_cuda.trace_brick_multi_cuda_serial(bsvo, o, d, kk)},
            rounds=3, reps=10)
        by_k[kk] = {name: med_p80(v) for name, v in tk.items()}
        torch.cuda.empty_cache()
    out["ms_by_k"] = by_k
    say(f"[timing-k] {card}: brick_trace_multi's main path (the staged form, "
        f"blocks of {STAGED_BLOCK}) == its first form bitwise on "
        f"the frame, and in turns, three rounds of 10, median ms (p80): " + "; ".join(
            f"k={kk} {v['staged'][0]:.4f} ({v['staged'][1]:.4f}) against the first "
            f"form's {v['first'][0]:.4f} ({v['first'][1]:.4f})" for kk, v in by_k.items()))

    # ---- the surface renderer: each route, and render.py's image paths -----
    smodel = SurfaceRenderer(host_svo, device=dev)
    renderers._accel_of(smodel)
    tile_route = dict(tile_candidates=None, tile_walk=None, shade_fwd=None)
    sky_np = make_gradient_skybox()
    cases = [
        ("tile route, render_progressive samples=4", 4,
         lambda: smodel.render_progressive(view, RenderConfig(samples=4), seed=0),
         dict(shade_fwd=4), ("tile_candidates", "tile_walk", "esvo_trace")),
        ("brick route, 1000x1000 pinhole", 1,
         lambda: smodel.render(CameraConfig(**bench_cam, width=1000, height=1000), rcfg),
         dict(brick_trace=1, shade_fwd=1), ()),
        ("brick route, orthographic 1024x1024", 1,
         lambda: smodel.render(CameraConfig(position=(0.5, 0.9, -0.4),
                                            look_at=(0.5, 0.3, 0.5),
                                            ortho_height=1.2, width=res,
                                            height=res), rcfg),
         dict(brick_trace=1, shade_fwd=1), ()),
        ("render_image route, 1000x1000 pinhole with a skybox", 1,
         lambda: smodel.render(CameraConfig(**bench_cam, width=1000, height=1000),
                               rcfg, skybox=sky_np),
         dict(esvo_stackless=1), ()),
    ]
    lines, s_ms = [], {}
    for what, n_frames, fn, want, allow in cases:
        img_s, got = expect_launches(f"SurfaceRenderer, {what}", fn, want, allow)
        if "tile" in what and not (got.get("tile_walk") and got.get("tile_candidates")):
            raise AssertionError(f"{what}: launched {got}")
        if not bool(torch.isfinite(img_s).all()) or img_s.dim() != 3:
            raise AssertionError(f"SurfaceRenderer, {what}: bad image")
        s_ms[what] = med_p80(cuda_ms(fn, 10, 1))
        lines.append(f"{what}: launches {got}, median {s_ms[what][0]:.4f} ms "
                     f"(p80 {s_ms[what][1]:.4f}, n=10)")
    # one tile-route frame against the per-ray frame on the same camera, off
    # the rays the tile frame's referee judged
    one, _got = expect_launches("SurfaceRenderer tile route, one frame",
                                lambda: smodel.render(view, rcfg),
                                dict(shade_fwd=1), ("tile_candidates", "tile_walk", "esvo_trace"))
    keep = ~ctx["refereed_px"]
    tile_err = float((one.reshape(-1, 3)[keep] - ctx["img"][keep]).abs().max())
    if tile_err > 1e-6:
        raise AssertionError(f"the tile route's frame differs from the per-ray "
                             f"frame by {tile_err}")
    out["surface_ms"] = s_ms
    say(f"[surface] {card}: SurfaceRenderer at depth 10: " + "; ".join(lines)
        + f"; the tile route's frame == the per-ray frame within {tile_err} off "
        f"the {int((~keep).sum())} refereed rays")

    # render.py's image paths: attachments and bounces
    cam = camera.Camera(**bench_cam, width=res, height=res)
    t0 = time.perf_counter()
    words = tuple(w.to(dev) for w in codecs.build_attachments(host_svo))
    build_s = time.perf_counter() - t0
    att, got_att = expect_launches("render_attachment", lambda: render.render_attachment(
        svo, *words, o, d), dict(esvo_stackless=1))
    miss = single.hit_leaf < 0
    if (att.shape != (n_rays, 3) or not bool(torch.isfinite(att).all())
            or not torch.equal(att[miss], sky_color(d)[miss])):
        raise AssertionError("render_attachment: bad image, or a miss is not the sky")
    bounce = lambda spec, nb: render.render_bounce(
        bsvo, params[0], params[1], cam, specular=spec, bounces=nb, device=dev)
    live, got_b = expect_launches("render_bounce specular 0.5, 3 bounces",
                                  lambda: bounce(0.5, 3), dict(brick_trace=3))
    b1, b3 = bounce(0.0, 1), bounce(0.0, 3)
    base = render.render_image(svo, cam, device=dev).reshape(-1, 3)
    # render_image traces stacklessly and render_bounce through the bricks:
    # the rays on which the two traces part are left out
    same_hit = routes["brick"]["res"].hit_leaf == single.hit_leaf
    b1_flat = b1.reshape(-1, 3)
    if not torch.allclose(b1_flat[same_hit], base[same_hit], rtol=1e-5, atol=1e-6):
        raise AssertionError("render_bounce(specular=0, bounces=1) differs from "
                             "render_image")
    if not torch.equal(b3, b1):
        raise AssertionError("render_bounce: bounces=3 differs from bounces=1 at "
                             "specular 0")
    if not bool(torch.isfinite(live).all()) or not float((live - b1).abs().max()) > 1e-3:
        raise AssertionError("render_bounce at specular 0.5: no reflection")
    a_ms = med_p80(cuda_ms(lambda: render.render_attachment(svo, *words, o, d), 10, 1))
    b_ms = med_p80(cuda_ms(lambda: bounce(0.5, 3), 10, 1))
    say(f"[surface] {card}: render_attachment {res}x{res} (attachments of "
        f"{host_svo.n_nodes} nodes built on the host in {build_s:.2f} s): launches "
        f"{got_att}, misses == the sky, median {a_ms[0]:.4f} ms (p80 {a_ms[1]:.4f}, "
        f"n=10); render_bounce specular 0.5, 3 bounces: launches {got_b}, median "
        f"{b_ms[0]:.4f} ms (p80 {b_ms[1]:.4f}, n=10); at specular 0 one bounce == "
        f"render_image within rtol 1e-5 / atol 1e-6 on the "
        f"{int(same_hit.sum())} rays where the brick and stackless traces hit "
        f"alike, and 3 bounces == 1 bounce bitwise")
    return out


def read_png(path):
    """An 8-bit RGB PNG of unfiltered rows (filter type 0, as cli.py writes
    them) as an (H, W, 3) uint8 array: this script's own reader, independent
    of the writer in cli.py; any other form fails."""
    data = open(path, "rb").read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: not a PNG")
    pos, idat, header = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != struct.unpack(
                ">I", data[pos + 8 + n:pos + 12 + n])[0]:
            raise AssertionError(f"{path}: bad CRC in {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, bit_depth, color, _comp, _filt, interlace = header
    if (bit_depth, color, interlace) != (8, 2, 0):
        raise AssertionError(f"{path}: not 8-bit RGB, non-interlaced: {header}")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if raw[:, 0].any():
        raise AssertionError(f"{path}: filtered rows")
    return raw[:, 1:].reshape(h, w, 3)


def png_pixels(img):
    """The uint8 pixels of a float image as the command line writes them."""
    return (np.clip(img.detach().cpu().numpy(), 0, 1) * 255).astype(np.uint8)


TILE_KERNELS = ("tile_candidates", "tile_walk", "esvo_trace")


def fly_direct(path, dev, res, frames, hold):
    """cli fly's kept frames at its defaults, by direct calls: the model
    frame by frame (tile), or the stitched brick trace and shade_diff with
    the command's running average (brick); as the strip's uint8 pixels."""
    sr = StreamingRenderer(get_scene("terrain"), device=dev)
    light = torch.tensor([-0.5, -1.0, -0.3], device=dev)
    total, kept, acc, sample, last = frames + hold, [], None, 0, None
    for f, (pos, look) in enumerate(fly_poses(frames, hold)):
        sr.update(np.asarray(pos))
        cam = camera.Camera(position=pos, look_at=look, fov_y_deg=55.0, width=res,
                            height=res)
        if path == "tile":
            px, _un = sr.render(cam)
        else:
            if (pos, look) != last:
                acc, sample, last = None, 0, (pos, look)
            o, d = cam.rays(dev)
            clip = sr.clipmap
            trunk, roots, origins, sizes = clip.master_brick()
            leaf, *_ = clipmap.trace_clipmap_device_brick(
                trunk, tuple(clip.octree.root.position), clip.octree.root.size, roots,
                origins, sizes, clip.chunk_depth, sr.device_bricks, o, d)
            img = diff.shade_diff(leaf, d, sr.device_arena.leaf_albedo,
                                  sr.device_arena.leaf_normal, sr.device_arena.leaf_density,
                                  light, 1.3, 0.08).reshape(res, res, 3)
            acc = img if sample == 0 else acc + (img - acc) / (sample + 1)
            sample += 1
            px = acc
        if f % max(total // 8, 1) == 0 or f == total - 1:
            kept.append(png_pixels(px))
    return np.concatenate(kept, axis=1)


def cli_phase(ctx, card, served):
    """[cli]: `python -m raytracingtest_tpu_torch.cli`'s commands through
    cli.main, in this process, on the card: `render` at depth 10 and 1024²
    on each of its branches (every PNG equal, pixel for pixel, to the direct
    call's image; each branch launching its route's kernels and no other,
    and calling no plain version), `fit`, `info`, `debug`, and `render` of
    the three noise scenes built at depth 8. Returns the launches of the
    phase by kernel, and its lines' numbers."""
    dev, host_svo, svo, bsvo = ctx["dev"], ctx["host_svo"], ctx["svo"], ctx["bsvo"]
    o, d, res, bench_cam = ctx["o"], ctx["d"], ctx["res"], ctx["bench_cam"]
    depth = str(host_svo.depth)
    # the noise scenes' depth (the command line's default) and image size
    s_depth, s_res = 8, 512
    cdir = os.path.join(_build.BUILD_DIR, "cli")
    shutil.rmtree(cdir, ignore_errors=True)
    os.makedirs(cdir)
    # the depth-10 tree under the JAX package's cache name: the commands
    # load it instead of building it
    saved = os.path.join(cdir, f"svo_terrain_d{depth}.npz")
    shutil.copyfile(ctx["cache"], saved)
    loaded = {}
    load_or_build = cli._load_or_build

    def timed_load(*args, **kw):
        t0 = time.perf_counter()
        out = load_or_build(*args, **kw)
        loaded["s"] = time.perf_counter() - t0
        return out
    cli._load_or_build = timed_load
    total, rows = {}, []

    def command(what, argv, want, allow=()):
        """Run one command from zeroed counts: (stdout, stderr, launches,
        wall seconds, load or build seconds)."""
        out, err = io.StringIO(), io.StringIO()

        def run():
            try:
                with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                    cli.main(["--cache-dir", cdir, *argv])
            except BaseException as e:   # argparse's SystemExit too
                raise AssertionError(f"cli {what} ({argv}) failed: {e!r}; its "
                                     f"output: {out.getvalue()}{err.getvalue()}") from e
        loaded["s"] = None
        t0 = time.perf_counter()
        _none, got = expect_launches(f"cli {what}", run, want, allow)
        wall = time.perf_counter() - t0
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        rows.append(dict(what=what, wall_s=wall, load_s=loaded["s"], launches=got))
        return out.getvalue(), err.getvalue(), got, wall, loaded["s"]

    cam_args = ["--camera-position", "0.5", "0.85", "-0.6", "--look-at", "0.5",
                "0.4", "0.5", "--fov", "50"]
    frame = ["--scene", "terrain", "--depth", depth, "--width", str(res),
             "--height", str(res), *cam_args]
    view = CameraConfig(**bench_cam, width=res, height=res)
    cam = camera.Camera(**bench_cam, width=res, height=res)
    params = (svo.leaf_albedo, svo.leaf_normal, svo.leaf_density)
    smodel = SurfaceRenderer(host_svo, device=dev)
    node_alb, node_nrm = (t.to(dev) for t in lod.compute_node_attributes(host_svo))
    words = tuple(w.to(dev) for w in codecs.build_attachments(host_svo))
    direct = {
        "default": lambda: smodel.render_progressive(view, RenderConfig(samples=4)),
        "skybox": lambda: smodel.render_progressive(view, RenderConfig(),
                                                    skybox=hdr.make_sky_hdr()),
        "lod": lambda: lod.shade_lod(svo, node_alb, node_nrm,
                                     brick_cuda.trace_brick_lod_cuda(bsvo, o, d, LOD_C0,
                                                                     width=res),
                                     d),
        "attachments": lambda: render.render_attachment(svo, *words, o, d),
        "bounce": lambda: render.render_bounce(bsvo, params[0], params[1], cam,
                                               specular=0.5, bounces=3, device=dev),
        "volumetric": lambda: VolumetricRenderer(host_svo, k=4, device=dev).render(
            view, RenderConfig(volumetric_k=4)),
        "load": lambda: SurfaceRenderer(checkpoint.load_svo(saved, dev), device=dev
                                        ).render_progressive(view, RenderConfig()),
    }
    branches = [
        ("default", ["--samples", "4"], dict(shade_fwd=4), TILE_KERNELS),
        ("skybox", ["--skybox", "procedural"], dict(shade_fwd=1), TILE_KERNELS),
        ("lod", ["--lod-coef", repr(float(LOD_C0))], dict(brick_trace_lod=1), ()),
        ("attachments", ["--attachments"], dict(esvo_stackless=1), ()),
        ("bounce", ["--specular", "0.5", "--bounces", "3"], dict(brick_trace=3), ()),
        ("volumetric", ["--volumetric-k", "4"],
         dict(brick_trace_multi=1, composite_fwd=1), ()),
        ("load", ["--load", saved], dict(shade_fwd=1), TILE_KERNELS),
    ]
    rays_line = None
    for name, extra, want, allow in branches:
        png = os.path.join(cdir, f"render_{name}.png")
        argv = ["render", *frame, *extra, "--out", png]
        if name == "load":
            argv = ["render", "--width", str(res), "--height", str(res), *cam_args,
                    *extra, "--out", png]
        _out, err, got, wall, load_s = command(f"render {name}", argv, want, allow)
        if allow and not (got.get("tile_walk") and got.get("tile_candidates")):
            raise AssertionError(f"cli render {name}: launched {got}, not the tile route")
        with torch.no_grad():
            want_img = direct[name]()
        torch.cuda.synchronize()
        got_px, want_px = read_png(png), png_pixels(want_img.reshape(res, res, 3))
        if got_px.shape != (res, res, 3) or not np.array_equal(got_px, want_px):
            bad = int((got_px != want_px).any(-1).sum()) if got_px.shape == want_px.shape else -1
            raise AssertionError(f"cli render {name}: the PNG differs from the "
                                 f"direct call's pixels on {bad} pixels")
        if name == "default":
            rays_line = next(ln for ln in err.splitlines() if "Mrays/s" in ln)
        say(f"[cli] {card}: render {name} ({' '.join(extra)}), terrain depth {depth} "
            f"{res}x{res}, bench.py's camera: {wall:.2f} s of cli.main (load "
            f"{load_s:.2f} s), launches {got}, no plain call; the PNG (decoded by "
            f"this script) == the direct call's pixels")
    surface_ms = served["surface_ms"]["tile route, render_progressive samples=4"]
    say(f"[cli] {card}: render's default branch (4 samples) under RaysPerSecond: "
        f"{rays_line} (the first call builds the brick table and the pyramid on "
        f"the host inside the frame); [surface]'s render_progressive of the same "
        f"4 samples on a built model, median {surface_ms[0]:.4f} ms (p80 "
        f"{surface_ms[1]:.4f}) = {4 * res * res / surface_ms[0] / 1e3:.2f} Mrays/s")

    # fit: four posed 1024² views of the depth-10 tree, four tile steps
    fit_dir = os.path.join(cdir, "fit")
    _out, err, got, wall, load_s = command(
        "fit", ["fit", "--scene", "terrain", "--depth", depth, "--views", "4",
                "--view-resolution", str(res), "--steps", "4", "--out-dir", fit_dir],
        dict(shade_fwd=8, shade_bwd=4, segment_sum=4), TILE_KERNELS)
    if not (got.get("esvo_trace", 0) >= 4 and got.get("tile_walk")
            and got.get("tile_candidates")):
        raise AssertionError(f"cli fit: launched {got}: not the ESVO synthesis "
                             f"and the tile step")
    losses = {int(m.group(1)): float(m.group(2)) for m in
              re.finditer(r"step +(\d+)  loss ([0-9.e+-]+)", err)}
    if sorted(losses) != [0, 1, 2, 3] or not losses[3] < losses[0]:
        raise AssertionError(f"cli fit: losses {losses}, expected a fall from step 0 to 3")
    state = os.path.join(fit_dir, "fit_state.npz")
    template = torch.optim.Adam([torch.zeros_like(params[0])], lr=5e-2)
    fit_params, fit_opt, fit_step = checkpoint.load_train_state(state, template, dev)
    if (fit_step != 4 or fit_opt is not template or fit_params["albedo"].shape
            != params[0].shape or float(next(iter(template.state.values()))["step"]) != 4.0):
        raise AssertionError("cli fit: fit_state.npz does not reload")
    albedo_err = re.search(r"albedo error\| = ([0-9.]+)", err).group(1)
    warn = re.search(r"WARNING: (\d+) ray-steps", err)
    say(f"[cli] {card}: fit terrain depth {depth}, 4 views of {res}x{res}, 4 steps: "
        f"{wall:.2f} s (load {load_s:.2f} s), loss "
        + " -> ".join(f"{losses[i]:.4e}" for i in range(4))
        + f", final mean |albedo error| {albedo_err}, "
        f"{warn.group(1) if warn else 0} ray-steps on cap-limited hits, launches "
        f"{got}; fit_state.npz reloads through load_train_state with its Adam state "
        f"(step 4)")

    # info, and debug's probe and box overlay
    out, _err, got_i, wall_i, load_i = command(
        "info", ["info", "--scene", "terrain", "--depth", depth], {})
    if not out.startswith(f"scene=terrain depth={depth}\n") or (
            f"nodes={host_svo.n_nodes} leaves={host_svo.n_leaves}") not in out:
        raise AssertionError(f"cli info: {out!r}")
    ray = (0.5, 0.85, -0.6, 0.0, -0.45, 1.1)
    png = os.path.join(cdir, "debug.png")
    out, _err, got_d, wall_d, load_d = command(
        "debug", ["debug", "--scene", "terrain", "--depth", depth, "--level", "3",
                  "--ray", *map(str, ray), "--out", png],
        dict(esvo_stackless_multi=1, esvo_stackless=1))
    probe = brick_cuda.trace_multi_cuda(
        svo, torch.tensor([ray[:3]], device=dev), torch.tensor([ray[3:]], device=dev),
        k=32)
    count = int(probe.count[0])
    want_leaves = probe.hit_leaf[0, :count].tolist()
    got_leaves = [int(v) for v in re.findall(r"leaf +(\d+)", out)]
    if not count or got_leaves != want_leaves:
        raise AssertionError(f"cli debug: probe leaves {got_leaves}, "
                             f"trace_multi_cuda's {want_leaves}")
    dcam = camera.Camera(**bench_cam, width=512, height=512)
    overlay = render.render_image(svo, dcam, device=dev).cpu().numpy().copy()
    origins, size = viz.node_boxes(host_svo, 3)
    viz.draw_boxes(overlay, dcam, origins, size, max_boxes=4096)
    if not np.array_equal(read_png(png), (np.clip(overlay, 0, 1) * 255).astype(np.uint8)):
        raise AssertionError("cli debug: the overlay PNG differs from the direct call's")
    say(f"[cli] {card}: info depth {depth}: {wall_i:.2f} s (load {load_i:.2f} s), "
        f"launches {got_i or 'none'}")
    say(f"[cli] {card}: debug depth {depth} --level 3 --ray {ray} --out (512x512): "
        f"{wall_d:.2f} s (load {load_d:.2f} s), launches {got_d}, the probe's "
        f"{count} leaves == trace_multi_cuda's slots {want_leaves}, the overlay "
        f"({len(origins)} level-3 boxes) == the direct call's pixels")

    # the noise scenes, built at the command line's default depth
    small = camera.Camera(**bench_cam, width=s_res, height=s_res)
    sky_px = png_pixels(sky_color(small.rays(dev)[1]).reshape(s_res, s_res, 3))
    for scene in ("perlin", "terrain_ref", "simplex_ref"):
        png = os.path.join(cdir, f"{scene}.png")
        _out, err, got, wall, build_s = command(
            f"render {scene}", ["render", "--scene", scene, "--depth", str(s_depth),
                                "--width", str(s_res), "--height", str(s_res),
                                "--out", png],
            dict(shade_fwd=1), TILE_KERNELS)
        built = re.search(r"built \S+ depth=\d+: (\d+) nodes, (\d+) leaves", err)
        # a sky pixel: within one level of the gradient at the pixel's center
        # (the frame's rays are jittered)
        px = read_png(png)
        sky = np.all(np.abs(px.astype(np.int32) - sky_px) <= 1, axis=-1)
        if not built or not (0.001 < sky.mean() < 0.99):
            raise AssertionError(f"cli render {scene}: {err!r}, sky on "
                                 f"{sky.mean():.4f} of the image")
        say(f"[cli] {card}: render {scene} depth {s_depth} {s_res}x{s_res}: built "
            f"({built.group(1)} nodes, {built.group(2)} leaves) in {build_s:.2f} s, "
            f"{wall:.2f} s of cli.main, launches {got}, sky on {sky.mean():.4f} of "
            f"the pixels")
    # fly at its defaults on both paths, a few frames at res²; each strip
    # against the direct calls' frames
    fly_frames, fly_hold = 3, 2
    n_fly = fly_frames + fly_hold
    for path in ("tile", "brick"):
        out_dir = os.path.join(cdir, f"fly_{path}")
        # the default clipmap has two LODs: three phase-1 calls and three
        # walks each, a frame
        want = (dict(tile_candidates_mapped=6 * n_fly, tile_walk=6 * n_fly, shade_fwd=n_fly)
                if path == "tile" else dict(clipmap_trace_brick=n_fly, shade_fwd=n_fly))
        _out, err, got, wall, _load = command(
            f"fly --path {path}", ["fly", "--resolution", str(res), "--frames",
                                   str(fly_frames), "--hold-frames", str(fly_hold),
                                   "--path", path, "--out-dir", out_dir], want)
        strip = read_png(os.path.join(out_dir, "fly_strip.png"))
        direct_strip = fly_direct(path, dev, res, fly_frames, fly_hold)
        if strip.shape != direct_strip.shape or not np.array_equal(strip, direct_strip):
            raise AssertionError(f"cli fly --path {path}: the strip differs from the "
                                 f"direct calls' frames")
        lines = re.findall(r"update +([\d.]+) ms .*?render +([\d.]+) ms", err)
        say(f"[cli] {card}: fly --resolution {res} --path {path} at its defaults "
            f"({fly_frames} frames, {fly_hold} at rest): {wall:.2f} s of cli.main, "
            f"update / render ms a frame (host clock) "
            + ", ".join(f"{u} / {r}" for u, r in lines)
            + f", launches {got}, no plain call; the strip ({strip.shape[1] // res} "
            f"frames) == the direct calls' pixels")

    # probe, scripted, on the depth-10 tree
    png = os.path.join(cdir, "probe.png")
    script = (f"from 0.5 0.85 -0.6; to 0.5 0.4 1.1; insert 0.25 0.25 0.25 0.25; "
              f"render {png}; quit")
    out, _err, got_p, wall_p, load_p = command(
        "probe", ["probe", "--scene", "terrain", "--depth", depth, "--level", "3",
                  "--commands", script], dict(esvo_stackless_multi=3, esvo_stackless=1))
    ray_o, ray_t = np.array([0.5, 0.85, -0.6]), np.array([0.5, 0.4, 1.1])
    ray_d = (ray_t - ray_o) / np.linalg.norm(ray_t - ray_o)   # as the command's
    probe = brick_cuda.trace_multi_cuda(
        svo, torch.tensor(ray_o[None], dtype=torch.float32, device=dev),
        torch.tensor(ray_d[None], dtype=torch.float32, device=dev), k=32)
    count = int(probe.count[0])
    got_leaves = [int(v) for v in re.findall(r"leaf +(\d+)", out.split("ray [0.5, 0.85, -0.6] -> [0.5, 0.4, 1.1]")[-1])]
    if not count or got_leaves != probe.hit_leaf[0, :count].tolist():
        raise AssertionError(f"cli probe: leaves {got_leaves}, trace_multi_cuda's "
                             f"{probe.hit_leaf[0, :count].tolist()}")
    pcam = camera.Camera(**bench_cam, width=512, height=512)
    overlay = render.render_image(svo, pcam, device=dev).cpu().numpy().copy()
    viz.draw_boxes(overlay, pcam, *viz.node_boxes(host_svo, 3), max_boxes=4096)
    viz.draw_boxes(overlay, pcam, np.asarray([(0.25, 0.25, 0.25)], np.float32), 0.25,
                   color=(1.0, 1.0, 0.2))
    viz.draw_segment(overlay, pcam, np.asarray([0.5, 0.85, -0.6]), np.asarray([0.5, 0.4, 1.1]))
    if not np.array_equal(read_png(png), (np.clip(overlay, 0, 1) * 255).astype(np.uint8)):
        raise AssertionError("cli probe: the overlay PNG differs from the direct call's")
    say(f"[cli] {card}: probe terrain depth {depth}, scripted (from, to, insert, "
        f"render 512x512): {wall_p:.2f} s (load {load_p:.2f} s), launches {got_p}, "
        f"the last probe's {count} leaves == trace_multi_cuda's, the overlay == the "
        f"direct calls' pixels")
    cli._load_or_build = load_or_build
    return dict(launches=total, rows=rows, rays_line=rays_line)


# ---- the streamed world (K8, K10) ---------------------------------------------

# the whole world at the main path's resolution: chunks of 1/8 at depth 7, a
# ring of radius 4 around the centre, one LOD: one stitched master of depth
# 10 and top depth 7; and the fly configuration: the same chunks, radius 2,
# two LODs (LOD 1 at depth 9, top depth 6)
FLY_PARITY = dict(min_chunk_size=0.125, chunk_depth=7, radius=4, lods=1)
FLY_TIMING = dict(min_chunk_size=0.125, chunk_depth=7, radius=2, lods=2)
# cli fly's camera path: frames of motion, then frames at rest
FLY_FRAMES, FLY_HOLD = 16, 4
# the stitched traces' arenas: node rows, leaf rows (brick rows: half)
FLY_ARENA = (2_000_000, 4_000_000)
# the stitched traces' parity rays: bench.py's camera at 512²
FLY_PARITY_RES = 512
# operations of one round of the stitched trace besides its walks: the
# advanced origin, the two local origins and the box's exit t
OPS_CLIP_ROUND = 45
# the stitched traces' outputs; clipmap_trace_brick's main-path form; each
# stitched trace's main-path kernel as torch.profiler names it
CLIP_OUTPUTS = ("hit_leaf", "hit_t", "hit_chunk", "truncated")
CLIP_MAIN = brick_cuda.FORMS["clipmap_trace_brick"][0]
CLIP_KERNELS = {"clipmap_trace": "clipmap_trace_wide_kernel",
                "clipmap_trace_brick": "clipmap_trace_brick_kernel"}


def fly_poses(frames, hold):
    """cli fly's camera path: (position, look_at) a frame."""
    out = []
    for f in range(frames + hold):
        u = min(f, frames - 1) / max(frames - 1, 1)
        out.append(((0.18 + 0.55 * u, 0.72, 0.12 + 0.2 * u),
                    (0.5 + 0.3 * (u - 0.5), 0.3, 0.6)))
    return out


def arena_leaf_voxels(master, bricks):
    """(arena leaf rows, their (n, 3) voxel coordinates in the master's
    world grid): the stitched pyramid's finest cells in morton order are the
    brickmap's bricks, and a brick's set bits in hierarchical-morton order
    are its leaves, from its first leaf row on."""
    td = master.top_depth
    offs, _ = tile._pyr_layout(td)
    pyr = master.pyr.cpu().numpy().view(np.uint32)[offs[td]:]
    shifts = np.arange(32, dtype=np.uint32)
    cells = np.flatnonzero(((pyr[:, None] >> shifts) & 1).reshape(-1))
    rows = bricks[master.brickmap.cpu().numpy()[:cells.shape[0]]].view(np.uint32)
    occ = ((rows[:, :16, None] >> shifts) & 1).reshape(-1, 512).astype(np.int64)
    brick, bit = np.nonzero(occ)
    rank = np.cumsum(occ, axis=1)[brick, bit] - 1
    ids = rows[brick, 16].astype(np.int64) + rank
    axis = lambda a: ((((bit >> (6 + a)) & 1) << 2) | (((bit >> (3 + a)) & 1) << 1)
                      | ((bit >> a) & 1))
    vox = np.stack([c[brick] * 8 + axis(a)
                    for a, c in enumerate(tile.unmorton3(cells))], axis=1)
    return ids, vox


def voxel_keys(v):
    v = np.asarray(v, np.int64)
    return (v[:, 0] << 20) | (v[:, 1] << 10) | v[:, 2]


def fly_world(scene, dev, **kw):
    """A clipmap of `scene` with both arenas on the card."""
    arena = clipmap.Arena(*FLY_ARENA)
    barena = clipmap.BrickArena(FLY_ARENA[0], FLY_ARENA[1] // 2)
    clip = clipmap.Clipmap(scene, arena, brick_arena=barena, **kw)
    return clip, clipmap.DeviceArena(arena, dev), clipmap.DeviceBrickArena(barena, dev)


def stitched_args(clip, dev, brick_arena):
    """The stitched trace's tables from `clip` on `dev`: (trunk, origin,
    size, roots, origins, sizes) for the node or the brick arena."""
    trunk, roots, origins, sizes = clip.master_brick() if brick_arena else clip.master()
    return (trunk.to(dev), tuple(float(v) for v in clip.octree.root.position),
            float(clip.octree.root.size), roots.to(dev), origins.to(dev), sizes.to(dev))


@contextlib.contextmanager
def mapped_calls():
    """The arguments of every brickmap-mode call of tile_cuda.candidates
    made inside the block, in a list; the calls themselves go on."""
    calls, kernel = [], tile_cuda.candidates

    def recording(*args, **kw):
        if kw.get("brickmap") is not None:
            calls.append((args, kw))
        return kernel(*args, **kw)
    tile_cuda.candidates = recording
    try:
        yield calls
    finally:
        tile_cuda.candidates = kernel


def check_mapped(calls, names, err):
    """Each recorded brickmap-mode call again, in the radix form (the main
    path's) and in the first form, each held bitwise against
    candidates_plain followed by remap_ids; its row (name, args, T, K,
    valid candidates, bound)."""
    rows = []
    for (args, kw), cname in zip(calls, names, strict=True):
        got_c = tile_cuda.candidates(*args, **kw)
        got_first = tile_cuda.candidates(*args, **kw, form="first")
        plain = tile.candidates_plain(*args)
        plain = (plain[0], tile.remap_ids(plain[1], kw["brickmap"]), plain[2], plain[3])
        torch.cuda.synchronize()
        err["tile_candidates_mapped"] = max(err["tile_candidates_mapped"], compare_tensors(
            got_c, plain, CAND_NAMES, f"tile_candidates_mapped, {cname}"))
        err["tile_candidates_mapped_first"] = max(
            err["tile_candidates_mapped_first"], compare_tensors(
                got_first, plain, CAND_NAMES, f"tile_candidates_mapped_first, {cname}"))
        n_bytes, n_ops, _widths = candidate_work(args)
        valid = int((got_c[1] >= 0).sum())
        rows.append(dict(name=cname, args=args, kw=kw, T=args[2].shape[0], K=args[6],
                         top_depth=args[4], valid=valid,
                         bound=bound(n_bytes + valid * 4, n_ops)))
    return rows


# phase 1's forms that [cand-forms] holds, probes and times
CAND_VARIANTS = {"first": dict(form="first"), "radix": dict(form="radix")}
def cand_record(row):
    """A [cand-forms] row for the kernels line: each variant's ms in turns and
    µs alone, the probe's warps by phase, the bound and the valid candidates."""
    return dict(bound_ms=row["bound"][0], bound_by=row["bound"][1], valid=row["valid"],
                **{name: {k: v for k, v in r.items() if k != "turns"}
                   for name, r in row.items() if isinstance(r, dict)})


# the phase-1 probe's phases, as [cand-warps] names them (each level's
# expansion and selection summed over the levels)
CAND_PHASES = ("frustum", "expand", "select", "keep", "sort", "write")


def cand_warps(what, form, record, warps, T):
    """[cand-warps]: one phase-1 launch read from its probe form's record
    (tile_cuda.CAND_PROBE_FIELDS, a row a warp; `warps` warps a tile, or a
    warp's tiles packed) of T tiles: the kernel's span on the global timer
    and the share of it after 99% of warps ended, warp times, the slowest
    warp's group (its first tile, or a packed warp's index) and its cycles by
    phase, each phase's cycles a warp and share of warp cycles, each level's
    expansion cycles a warp, and the overflowing levels, their counting
    passes and the valid keys a tile. Returns the numbers."""
    r = record.cpu().numpy().astype(np.float64)
    rows = np.flatnonzero(r[:, tile_cuda.CAND_PROBE_FIELDS.index("ns_start")] > 0)
    f = {k: r[rows, i] for i, k in enumerate(tile_cuda.CAND_PROBE_FIELDS)}
    levels = range(1, tile_cuda.TOP_DEPTH_LIMIT + 1)
    f["expand"] = sum(f[f"expand_l{l}"] for l in levels)
    f["select"] = sum(f[f"select_l{l}"] for l in levels)
    cycles = f["end"] - f["start"]
    t0 = f["ns_start"].min()
    start, end = (f["ns_start"] - t0) / 1e3, (f["ns_end"] - t0) / 1e3
    dur = end - start
    span, t99 = float(end.max()), float(np.percentile(end, 99))
    slow = int(np.argmax(dur))
    lead = rows % warps == 0   # a group's counts, once: its first warp
    over, passes = f["over"][lead].sum(), f["passes"][lead].sum()
    phases = {ph: (float(f[ph].mean()), float(f[ph].sum() / cycles.sum()))
              for ph in CAND_PHASES}
    by_level = {l: float(f[f"expand_l{l}"].mean()) for l in levels
                if f[f"expand_l{l}"].any()}
    out = dict(span_us=span, t99_us=t99, tail_share=(span - t99) / span,
               warp_us_median=float(np.median(dur)),
               warp_us_p99=float(np.percentile(dur, 99)), warp_us_max=float(dur.max()),
               slowest_group=int(f["tile"][slow]),
               slowest_cycles={ph: float(f[ph][slow]) for ph in CAND_PHASES},
               slowest_levels={l: float(f[f"expand_l{l}"][slow]) for l in by_level},
               slowest_passes=float(f["passes"][slow]), slowest_valid=float(f["valid"][slow]),
               cycles_a_warp=float(cycles.mean()), phases=phases,
               expand_by_level=by_level, over_levels=float(over),
               groups_over=int((f["over"][lead] > 0).sum()), groups=int(lead.sum()),
               passes_an_overflow=float(passes / over) if over else 0.0,
               valid_a_tile=float(f["valid"][lead].sum() / T))
    say(f"[cand-warps] {what}, {form} ({len(rows)} warps): the kernel spans "
        f"{span:.2f} us, 99% of warps ended by {t99:.2f} "
        f"({out['tail_share']:.2f} of the span after it); warp time median "
        f"{out['warp_us_median']:.2f} us, p99 {out['warp_us_p99']:.2f}, max "
        f"{out['warp_us_max']:.2f} (group {out['slowest_group']}: "
        + ", ".join(f"{ph} {c:.0f}" for ph, c in out["slowest_cycles"].items())
        + " cycles, its levels' expansions "
        + ", ".join(f"l{l} {c:.0f}" for l, c in out["slowest_levels"].items())
        + f", {out['slowest_passes']:.0f} passes, {out['slowest_valid']:.0f} valid keys); "
        f"{out['cycles_a_warp']:.0f} cycles a warp: "
        + ", ".join(f"{ph} {c:.0f} ({sh:.3f})" for ph, (c, sh) in phases.items())
        + "; expansion a warp by level "
        + ", ".join(f"l{l} {c:.0f}" for l, c in by_level.items())
        + f"; {over:.0f} levels over their width in {out['groups_over']} of "
        f"{out['groups']} groups, {out['passes_an_overflow']:.1f} counting passes an "
        f"overflowing level, {out['valid_a_tile']:.2f} valid keys a tile over its levels")
    return out


def cand_forms(calls, names, variants, card, err):
    """Each recorded phase-1 call (arguments and keywords; the brickmap mode
    where they hold a brickmap) in each of `variants` (name -> keywords of
    tile_cuda.candidates: its form), and through each
    variant's probe form, held bitwise against candidates_plain (+
    remap_ids), with its [cand-warps] line; then the variants timed in turns
    through the wrapper and alone (CUDA graphs of 20 calls, the variants in
    turns), beside the call's bound. Returns name -> {variant -> numbers}."""
    rows = {}
    for (args, kw), cname in zip(calls, names, strict=True):
        brickmap = kw.get("brickmap")
        plain = tile.candidates_plain(*args)
        if brickmap is not None:
            plain = (plain[0], tile.remap_ids(plain[1], brickmap), plain[2], plain[3])
        warps = tile_cuda.candidate_warps(tile_cuda.level_widths(*args[4:7]))
        row = rows[cname] = {}
        what = f"{cname} T={args[2].shape[0]} K={args[6]}"
        for name, vkw in variants.items():
            got = tile_cuda.candidates(*args, **kw, **vkw)
            torch.cuda.synchronize()
            key = ("tile_candidates" + ("_mapped" if brickmap is not None else "")
                   + {("first", True): "_first", ("radix", False): "_radix"}.get(
                       (vkw["form"], brickmap is not None), ""))
            e = compare_tensors(got, plain, CAND_NAMES, f"{key} ({name}), {cname}")
            err[key] = max(err.get(key, 0.0), e)
            row[name] = {}
            probed, record = tile_cuda.probe_candidates(*args, brickmap=brickmap, **vkw)
            compare_tensors(probed, plain, CAND_NAMES, f"the {name} probe, {cname}")
            row[name]["warps"] = cand_warps(what, name, record, warps, args[2].shape[0])
            row[name]["probe_ms"] = float(np.median(cuda_ms(
                lambda v=vkw: tile_cuda.probe_candidates(*args, brickmap=brickmap, **v),
                5, 1)))
        fns = {name: (lambda v=vkw: tile_cuda.candidates(*args, **kw, **v))
               for name, vkw in variants.items()}
        turns = in_turns(fns, rounds=3, reps=20)
        alone = {name: [] for name in fns}
        for name in (*fns, *reversed(fns)):
            alone[name].append(graph_us(fns[name]))
        n_bytes, n_ops, _widths = candidate_work(args)
        valid = int((plain[1] >= 0).sum())
        b = bound(n_bytes + (valid * 4 if brickmap is not None else 0), n_ops)
        for name in fns:
            row[name].update(ms=med_p80(turns[name])[0], us_alone=float(np.median(alone[name])),
                             alone_in_turns=alone[name], turns=turns[name])
        say(f"[cand-forms] {card}: {what} "
            f"({'brickmap mode' if brickmap is not None else 'unmapped'}, {valid} valid "
            f"candidates, bound {b[0]:.5f} ms by {b[1]}): "
            + ", ".join(f"{name} {row[name]['ms']:.4f} ms in turns, "
                        f"{row[name]['us_alone']:.2f} us alone ("
                        + ", ".join(f"{u:.2f}" for u in row[name]["alone_in_turns"]) + ")"
                        for name in fns))
        row["bound"] = b
        row["valid"] = valid
    return rows


def live_bytes(clip, brick_arena):
    """Bytes of the node or the brick arena's rows in use in `clip`."""
    used = lambda free, cap: cap - sum(n for _, n in free)
    if brick_arena:
        ba = clip.brick_arena
        return (used(ba._free_top, ba.top_capacity) * 12
                + used(ba._free_bricks, ba.brick_capacity) * 68)
    return clip.arena.nodes_used * 16


def clip_work(live, args, counts, n_rays):
    """bound() of one stitched trace: bytes, the rays in and the results out,
    the tables and the `live` bytes of arena rows in use; operations, this
    run's steps, walks and rounds as trace_clipmap_rounds counted them, the
    direction's set-up once a ray (every ray walks the trunk at least once)
    and the origin's once a walk."""
    n_bytes = n_rays * (24 + 13) + live + nbytes(*args[3:]) + 4 * nbytes(args[0].masks)
    n_ops = (counts["steps"] * OPS_ESVO_STEP + counts["dda"] * OPS_DDA_STEP
             + n_rays * OPS_DIR_SETUP + counts["walks"] * OPS_WALK_SETUP
             + counts["rounds"] * OPS_CLIP_ROUND)
    return bound(n_bytes, n_ops)


def graph_us(fn, calls=20, reps=5):
    """Device microseconds of one fn() with no host time between launches:
    `calls` calls captured into one CUDA graph, the graph replayed between
    two CUDA events `reps` times; the median replay over `calls`."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) * 1e3 / calls)
    return float(np.median(times))


def traced_us(fn, runs, key):
    """torch.profiler's device microseconds a call of fn() in the kernels
    whose names hold `key` (all their instantiations), and their launches a
    call."""
    rows = [e for e in traced_kernels(fn, runs) if key in e.key]
    return sum(dev_us(e) for e in rows) / runs, sum(e.count for e in rows) / runs


def snapshot(tree):
    """A copy of an arena's SVO or BrickSVO on the card, which later syncs
    leave as it is."""
    return dataclasses.replace(tree, **{
        f.name: getattr(tree, f.name).clone() for f in dataclasses.fields(tree)
        if isinstance(getattr(tree, f.name), torch.Tensor)})


def clip_warps_line(kernel, form, record):
    """[warps] of a stitched trace's probe form (clipmap_trace's phases,
    brick_cuda.CLIP_NODE_PHASES; clipmap_trace_brick's, CLIP_PHASES): each
    phase's issues a warp, SIMT efficiency and share of warp cycles (the
    round phase's lanes are the rays' rounds), the rounds a ray and a warp's
    passes through the round loop, warp durations, and the kernel's span and
    the share of it after 99% of warps ended. Returns the numbers."""
    block = brick_cuda.BLOCKS[(kernel, form)]
    fields, names = ((brick_cuda.CLIP_NODE_PROBE_FIELDS, brick_cuda.CLIP_NODE_PHASES)
                     if kernel == "clipmap_trace"
                     else (brick_cuda.CLIP_PROBE_FIELDS, brick_cuda.CLIP_PHASES))
    r = record.cpu().numpy().astype(np.float64)
    f = {k: r[:, i] for i, k in enumerate(fields)}
    cycles = f["end"] - f["start"]
    phases = {}
    for ph in names:
        issues = f[f"{ph}_issues"].sum()
        if issues:
            phases[ph] = (issues / len(cycles), f[f"{ph}_lanes"].sum() / (32 * issues),
                          f[f"{ph}_cycles"].sum() / cycles.sum())
    t0 = f["ns_start"].min()
    start, end = (f["ns_start"] - t0) / 1e3, (f["ns_end"] - t0) / 1e3
    dur = end - start
    span, t99 = float(end.max()), float(np.percentile(end, 99))
    rays = max(f["rays"].sum(), 1.0)
    rounds = f["round_lanes"].sum() / rays
    say(f"[warps] {kernel} {form} ({len(cycles)} warps of {block}-thread blocks): "
        + "; ".join(f"{ph} {n:.1f} issues a warp, SIMT {e:.3f}, {c:.3f} of warp cycles"
                    for ph, (n, e, c) in phases.items() if ph != "round")
        + f"; {rounds:.3f} rounds a ray, {f['round_issues'].mean():.2f} passes through "
        f"the round loop a warp (its rays' most: {phases['round'][1]:.3f} of its lanes "
        f"a pass); warp time median {np.median(dur):.2f} us, p99 "
        f"{np.percentile(dur, 99):.1f}, max {dur.max():.1f}; the kernel spans "
        f"{span:.1f} us, 99% of warps ended by {t99:.1f} ({(span - t99) / span:.2f} of "
        "the span after it)")
    return dict(phases={ph: dict(issues_a_warp=n, simt=e, cycle_share=c)
                        for ph, (n, e, c) in phases.items()},
                rounds_a_ray=float(rounds), round_passes_a_warp=float(f["round_issues"].mean()),
                warp_us_median=float(np.median(dur)), warp_us_p99=float(np.percentile(dur, 99)),
                warp_us_max=float(dur.max()), span_us=span, t99_us=t99)


def fly_k10(fk, kname):
    """A stitched trace's numbers on the rays of the fly frame that [fly]
    checks (the CUDA graph's time alone; the tracer drops these kernels'
    launches), for its entry in the kernels line."""
    w = fk["fly_work"][kname]
    return dict(ms_fly_last_pose=med_p80(fk["kern_ms"][kname])[0],
                fly_check_frame=fk["check_frame"], plain_ms_fly_check=w["plain_ms"],
                bound_ms_fly_check=w["bound"][0], bound_by_fly_check=w["bound"][1],
                us_alone_fly_check=w["us_alone"])


def fly_phase(ctx, card):
    """[fly]: the streamed world on the card. The whole world at the main
    path's resolution (FLY_PARITY) streamed, stitched and traced at 1024²
    through bench.py's camera against the monolithic depth-10 tile frame;
    both stitched-trace kernels and the brickmap mode of phase 1 against
    their plain versions; then cli fly's camera path at 1024² in the fly
    configuration (FLY_TIMING), timed frame by frame; the first of its
    frames that holds both LODs has its six phase-1 calls and both
    stitched traces (two chunk sizes) held against their plain versions;
    the brick path's frame and the monolithic frame at its last pose.
    Returns the main path's launches and the kernels' numbers."""
    dev, host_svo, host_ts, ts = ctx["dev"], ctx["host_svo"], ctx["host_ts"], ctx["ts"]
    o_t, d_t, corners, grid = ctx["tile_rays"]
    err, res, bench_cam = ctx["err"], ctx["res"], ctx["bench_cam"]
    scene = get_scene("terrain")
    budgets = {k: TILE_BUDGETS[k] for k in ("k_max", "fb_tiles", "fb_k", "fb2_tiles")}

    # ---- the whole world, streamed ------------------------------------------
    t0 = time.perf_counter()
    clip, dev_a, dev_b = fly_world(scene, dev, **FLY_PARITY)
    st = clip.update((0.5, 0.5, 0.5))
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    spans = (dev_a.sync(), dev_b.sync())
    sync_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    masters = [m.to(dev) for m in clip.master_tile()]
    stitch_s = time.perf_counter() - t0
    if len(masters) != 1 or (masters[0].depth, masters[0].top_depth) != (10, 7):
        raise AssertionError(f"the parity world stitched {[(m.depth, m.top_depth) for m in masters]}")
    n_leaves = sum(c.n_leaves for c in clip.resident.values())
    arena_gb = (nbytes(*(getattr(dev_a, n) for n in dev_a.NAMES), dev_a.parent_ptr)
                + nbytes(*(getattr(dev_b, n) for n in dev_b.NAMES))) / 1e9
    say(f"[fly] {card}: the whole terrain world streamed at the main path's "
        f"resolution ({FLY_PARITY}): {st['added']} chunks built on the host in "
        f"{build_s:.2f} s ({clip.arena.nodes_used} node rows, {n_leaves} leaves, "
        f"{sum(c.n_bricks for c in clip.resident.values())} bricks), spans "
        f"{spans} copied to the card in {sync_s:.3f} s, stitched in {stitch_s:.3f} s: "
        f"one master of depth 10, top depth 7 ({int((masters[0].brickmap >= 0).sum())} "
        f"bricks in its brickmap); the arenas ({FLY_ARENA[0]} node rows, "
        f"{FLY_ARENA[1]} leaf rows, {FLY_ARENA[1] // 2} brick rows) hold "
        f"{arena_gb:.3f} GB on the card")

    # the streamed frame through bench.py's camera, its phase-1 calls kept
    with mapped_calls() as calls:
        (leaf, t_w, un), got = expect_launches(
            "the streamed tile frame", lambda: clipmap.trace_clipmap_tile(
                masters, dev_b, o_t, d_t, corners, **budgets),
            dict(tile_candidates_mapped=3, tile_walk=3))
    mono, mono_un = tile.trace_tile_fb(ts, o_t, d_t, corners, **TILE_BUDGETS)
    torch.cuda.synchronize()

    # the brickmap mode against its plain version on the frame's three calls
    mapped = check_mapped(calls, CAND_CALLS, err)
    say("[fly] tile_candidates_mapped (the brickmap mode's radix form, the main "
        "path's) and tile_candidates_mapped_first (its first form, the search form) == "
        "candidates_plain + remap_ids bitwise (codes, ids, t_codes, drop_t bits) on "
        "the streamed frame's three calls: " + ", ".join(
            f"{r['name']} T={r['T']} K={r['K']} ({r['valid']} valid candidates)"
            for r in mapped))
    # both forms through their probe forms ([cand-warps]) and timed, in turns
    # and alone, on the frame's calls, and on its main call unmapped (the same
    # pyramid; the brickmap mode reads one more word a candidate)
    cand_parity = cand_forms([(r["args"], r["kw"]) for r in mapped],
                             [f"parity {c}" for c in CAND_CALLS], CAND_VARIANTS, card, err)
    cand_parity |= cand_forms([(mapped[0]["args"], {})], ["parity main, unmapped"],
                              CAND_VARIANTS, card, err)
    main_c = mapped[0]

    # the streamed frame against the monolithic one: leaves through voxels
    mono_vox = leaf_voxels(host_ts)
    ids, vox = arena_leaf_voxels(masters[0], clip.brick_arena.bricks)
    order = np.argsort(voxel_keys(mono_vox))
    sorted_keys = voxel_keys(mono_vox)[order]
    pos = np.searchsorted(sorted_keys, voxel_keys(vox))
    if (ids.shape[0] != mono_vox.shape[0]
            or not np.array_equal(sorted_keys[np.minimum(pos, len(order) - 1)], voxel_keys(vox))):
        raise AssertionError(f"the streamed world holds {ids.shape[0]} leaves, the "
                             f"monolithic tree {mono_vox.shape[0]}, or other voxels")
    to_mono = np.full(FLY_ARENA[1], -1, np.int64)
    to_mono[ids] = order[pos]
    to_mono_t = torch.from_numpy(to_mono).to(dev)
    streamed = torch.where(leaf >= 0, to_mono_t[leaf.clamp(min=0).long()], -1)
    resolved = ~un & ~mono_un
    differ = resolved & (streamed != mono.hit_leaf)
    n_differ = int(differ.sum())
    if int(un.sum()) or n_differ > MAX_DIFFER:
        raise AssertionError(f"streamed frame: {int(un.sum())} residual rays, "
                             f"{n_differ} parting from the monolithic frame")
    o_f, d_f = o_t.reshape(-1, 3), d_t.reshape(-1, 3)
    verdict = referee(mono_vox, 10, o_f[differ].cpu().numpy(), d_f[differ].cpu().numpy(),
                      dict(streamed=streamed[differ].cpu().numpy(),
                           mono=mono.hit_leaf[differ].cpu().numpy()))
    if not verdict["streamed"].all():
        raise AssertionError(f"streamed frame: wrong on {int((~verdict['streamed']).sum())} "
                             f"of the {n_differ} rays where it parts from the monolithic frame")
    hit = resolved & ~differ & (mono.hit_leaf >= 0)
    t_apart = hit & (bits(t_w) != bits(mono.hit_t))
    t_max = float((t_w[hit] - mono.hit_t[hit]).abs().max()) if bool(hit.any()) else 0.0
    if int(t_apart.sum()) > MAX_DIFFER or t_max > HIT_T_ATOL:
        raise AssertionError(f"streamed frame: hit_t differs on {int(t_apart.sum())} "
                             f"rays, by up to {t_max}")
    mono_rows = mono.hit_leaf[hit].long()
    rows = leaf[hit].long()
    attr = max(float((dev_a.leaf_albedo[rows] - ctx["svo"].leaf_albedo[mono_rows]).abs().max()),
               float((dev_a.leaf_normal[rows] - ctx["svo"].leaf_normal[mono_rows]).abs().max()))
    if attr > 1e-6:
        raise AssertionError(f"streamed frame: albedo or normal rows differ by {attr}")
    say(f"[fly] {card}: the streamed {res}x{res} frame through bench.py's camera "
        f"(trace_clipmap_tile at bench.py's budgets; launches {got}, no plain call) "
        f"against the monolithic depth-10 tile frame: {int(hit.sum())} same hits, "
        f"{n_differ} rays part (the float64 referee: the streamed frame right on "
        f"all, the monolithic on {int(verdict['mono'].sum())}), hit_t bits apart on "
        f"{int(t_apart.sum())} hits (max abs {t_max}), albedo and normal rows "
        f"through the arena within {attr} of the tree's, 0 residual rays")

    # ---- the stitched traces against their plain versions --------------------
    pcam = camera.Camera(**bench_cam, width=FLY_PARITY_RES, height=FLY_PARITY_RES)
    po, pd = pcam.rays(dev)
    work, k10 = {}, {}
    for kname, brick_arena in (("clipmap_trace", False), ("clipmap_trace_brick", True)):
        args = stitched_args(clip, dev, brick_arena)
        tree = dev_b.tree(7) if brick_arena else dev_a.tree(7)
        for cap in (0, 3):
            n_max = clipmap.rounds_bound(args[0].depth, cap)
            got_k = brick_cuda.clipmap_kernel(*args, tree, po, pd, 7, n_max)
            counts = {}
            t0 = time.perf_counter()
            plain = clipmap.trace_clipmap_rounds(*args, tree, po, pd, n_max, counts)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            e = compare_tensors(got_k, plain, ("hit_leaf", "hit_t", "hit_chunk",
                                               "truncated"), f"{kname} cap {cap}")
            err[kname] = max(err[kname], e)
            # the first form, against the plain version and the main form
            first_k = brick_cuda.clipmap_kernel(*args, tree, po, pd, 7, n_max, form="first")
            err[kname + "_serial"] = max(err[kname + "_serial"], compare_tensors(
                first_k, plain, CLIP_OUTPUTS, f"{kname}'s first form cap {cap}"))
            compare_tensors(got_k, first_k, CLIP_OUTPUTS,
                            f"{kname} cap {cap} against its first form")
            if cap == 0:
                work[kname] = dict(
                    counts=counts, plain_ms=plain_s * 1e3, n_max=n_max,
                    hits=int((got_k[0] >= 0).sum()),
                    bound=clip_work(live_bytes(clip, brick_arena), args, counts,
                                    po.shape[0]),
                    leaf=got_k[0], ms=cuda_ms(lambda: brick_cuda.clipmap_kernel(
                        *args, tree, po, pd, 7, n_max), 20, 3))
                if bool(got_k[3].any()):
                    raise AssertionError(f"{kname}: rays truncated at the rounds' bound")
                work[kname]["ms_first"] = cuda_ms(lambda: brick_cuda.clipmap_kernel(
                    *args, tree, po, pd, 7, n_max, form="first"), 20, 3)
            else:
                k10[kname] = int(got_k[3].sum())
    # the node arena's stackless walks and the brick arena's brick walks
    # reach a voxel through other planes, and the stackless walk has its step
    # bound (F18): rays where they part go to the referee
    leaf_n, leaf_b = work["clipmap_trace"].pop("leaf"), work["clipmap_trace_brick"].pop("leaf")
    apart = leaf_n != leaf_b
    n_apart = int(apart.sum())
    as_mono = lambda lf: torch.where(lf >= 0, to_mono_t[lf.clamp(min=0).long()], -1)
    arenas_verdict = referee(mono_vox, 10, po[apart].cpu().numpy(), pd[apart].cpu().numpy(),
                             dict(node=as_mono(leaf_n[apart]).cpu().numpy(),
                                  brick=as_mono(leaf_b[apart]).cpu().numpy()))
    if n_apart > MAX_DIFFER or not arenas_verdict["brick"].all():
        raise AssertionError(f"the stitched traces through the two arenas part on "
                             f"{n_apart} rays; the referee finds the brick arena's wrong "
                             f"on {int((~arenas_verdict['brick']).sum())}")
    say(f"[fly] clipmap_trace and clipmap_trace_brick (each in its {CLIP_MAIN} form and "
        f"its first form) == trace_clipmap_rounds "
        f"bitwise (hit_leaf, hit_t bits, hit_chunk, truncated) on the "
        f"{po.shape[0]} rays of bench.py's camera at {FLY_PARITY_RES}², at the "
        f"rounds' bound ({work['clipmap_trace']['n_max']}; none truncated, "
        f"{work['clipmap_trace']['hits']} hits; the two arenas' traces part on "
        f"{n_apart} rays, on which the float64 referee finds the brick arena's "
        f"right on all and the node arena's on {int(arenas_verdict['node'].sum())}) "
        f"and capped at 3 rounds ({k10} rays truncated); the plain "
        f"versions took {work['clipmap_trace']['plain_ms']:.1f} and "
        f"{work['clipmap_trace_brick']['plain_ms']:.1f} ms, the kernels "
        f"{med_p80(work['clipmap_trace']['ms'])[0]:.4f} and "
        f"{med_p80(work['clipmap_trace_brick']['ms'])[0]:.4f} ms; work: "
        + ", ".join(f"{k}: {w['counts']}" for k, w in work.items()))

    # ---- the fly configuration along cli fly's camera path --------------------
    del clip, dev_a, dev_b, masters
    poses = fly_poses(FLY_FRAMES, FLY_HOLD)
    sr = StreamingRenderer(scene, node_capacity=FLY_ARENA[0], leaf_capacity=FLY_ARENA[1],
                           device=dev, **FLY_TIMING)
    frames, check = [], None
    reset_counts()
    for f, (pos, look) in enumerate(poses):
        t0 = time.perf_counter()
        st = sr.update(np.asarray(pos))
        upd = time.perf_counter() - t0
        fcam = camera.Camera(position=pos, look_at=look, fov_y_deg=55.0, width=res,
                             height=res)
        # the first frame that holds chunks of both LODs (F20: a move of the
        # fine ring drops the coarse one) keeps its phase-1 calls, its rays
        # and a copy of its stitched tables for the checks below
        both = check is None and len({c.size for c in sr.clipmap.resident.values()}) > 1
        with mapped_calls() if both else contextlib.nullcontext() as calls:
            t0 = time.perf_counter()
            _acc, un_n = sr.render(fcam, fetch=False)
            n_un = int(un_n)
            ren = time.perf_counter() - t0
        frames.append(dict(update_ms=upd * 1e3, render_ms=ren * 1e3, residual=n_un, **st))
        if both:
            check = dict(frame=f, calls=calls, rays=fcam.rays(dev), n_lods=len(sr._masters),
                         tables={
                             "clipmap_trace": (stitched_args(sr.clipmap, dev, False),
                                               snapshot(sr.device_arena.tree(7)),
                                               live_bytes(sr.clipmap, False)),
                             "clipmap_trace_brick": (stitched_args(sr.clipmap, dev, True),
                                                     snapshot(sr.device_bricks.tree(7)),
                                                     live_bytes(sr.clipmap, True))})
    if check is None:
        raise AssertionError("[fly]: no frame of the camera path held chunks of both LODs")
    fm = [(m.depth, m.top_depth) for m in sr.clipmap.master_tile()]
    # the brick path's frame and the node arena's stitched trace at the last pose
    lo, ld = fcam.rays(dev)
    clip = sr.clipmap
    bargs = stitched_args(clip, dev, True)
    nargs = stitched_args(clip, dev, False)
    light = ctx["light"]

    def brick_frame():
        leaf_b, *_ = clipmap.trace_clipmap_device_brick(*bargs, 7, sr.device_bricks,
                                                        lo, ld)
        return diff.shade_diff(leaf_b, ld, sr.device_arena.leaf_albedo,
                               sr.device_arena.leaf_normal, sr.device_arena.leaf_density,
                               light, 1.3, 0.08)

    def node_frame():
        leaf_n, *_ = clipmap.trace_clipmap_device(*nargs, 7, sr.device_arena, lo, ld)
        return leaf_n
    brick_frame(), node_frame()
    torch.cuda.synchronize()
    launches = {k: v for k, v in launch_counts().items() if v}
    for k in ("tile_candidates_mapped", "tile_walk", "clipmap_trace", "clipmap_trace_brick"):
        if not launches.get(k):
            raise AssertionError(f"[fly]'s main path launched no {k}: {launches}")
    if any(PLAIN_CALLS.values()):
        raise AssertionError(f"[fly]'s main path called plain versions: {PLAIN_CALLS}")
    off_path = {k: v for k, v in {**brick_cuda.form_launches,
                                  **brick_cuda.probe_launches}.items() if v}
    off_path |= {k: launches[k] for k in ("tile_candidates_mapped_first",
                                          "tile_candidates_radix", "tile_candidates_probe",
                                          "tile_candidates_block", "tile_candidates")
                 if launches.get(k)}
    if off_path:
        raise AssertionError(f"[fly]'s main path launched first or probe forms: {off_path}")

    # the kernels of that frame against their plain versions: its phase-1
    # calls (three a LOD, LOD 1 at top depth 6) and both stitched traces over
    # its two-LOD trunk on its rays
    fly_mapped = check_mapped(check["calls"], [f"LOD {i} {c}" for i in range(check["n_lods"])
                                               for c in CAND_CALLS], err)
    if not any(r["top_depth"] == 6 and r["valid"] for r in fly_mapped):
        raise AssertionError(f"[fly]: frame {check['frame']}'s top-depth-6 calls hold no "
                             f"candidate, so the check at that depth holds nothing")
    cand_fly = cand_forms(check["calls"], [r["name"] for r in fly_mapped], CAND_VARIANTS,
                          card, err)
    co, cd = check["rays"]
    fly_work = {}
    for kname, (args, tree, live) in check["tables"].items():
        n_max = clipmap.rounds_bound(args[0].depth)
        got_k = brick_cuda.clipmap_kernel(*args, tree, co, cd, 7, n_max)
        counts = {}
        t0 = time.perf_counter()
        plain = clipmap.trace_clipmap_rounds(*args, tree, co, cd, n_max, counts)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        err[kname] = max(err[kname], compare_tensors(
            got_k, plain, ("hit_leaf", "hit_t", "hit_chunk", "truncated"),
            f"{kname}, fly frame {check['frame']}'s rays"))
        # the first form and the forms' probes
        first_fn = lambda: brick_cuda.clipmap_kernel(*args, tree, co, cd, 7, n_max,
                                                     form="first")
        main_fn = lambda: brick_cuda.clipmap_kernel(*args, tree, co, cd, 7, n_max)
        err[kname + "_serial"] = max(err[kname + "_serial"], compare_tensors(
            first_fn(), plain, CLIP_OUTPUTS,
            f"{kname}'s first form, fly frame {check['frame']}"))
        node = kname == "clipmap_trace"
        warps = {}
        for form in ("first", CLIP_MAIN):
            probed, record = (brick_cuda.probe_clipmap if node else
                              brick_cuda.probe_clipmap_brick)(*args, tree, co, cd, 7,
                                                              n_max, form)
            compare_tensors(probed, got_k, CLIP_OUTPUTS,
                            f"{kname}'s {form} probe form, fly frame {check['frame']}")
            warps[form] = clip_warps_line(kname, form, record)
        # alone: CUDA graphs of 5 calls, the forms in turns
        alone = {}
        for form in ("first", CLIP_MAIN, CLIP_MAIN, "first"):
            alone.setdefault(form, []).append(
                graph_us(main_fn if form == CLIP_MAIN else first_fn, calls=5))
        extra = dict(us_alone_first_form=float(np.median(alone["first"])), warps=warps,
                     alone_in_turns=alone,
                     ms_turns=in_turns({CLIP_MAIN: main_fn, "first": first_fn},
                                       rounds=3, reps=10))
        fly_work[kname] = dict(**extra,
            counts=counts, plain_ms=plain_s * 1e3, n_max=n_max,
            hits=int((got_k[0] >= 0).sum()), truncated=int(got_k[3].sum()),
            bound=clip_work(live, args, counts, co.shape[0]),
            us_alone=float(np.median(extra["alone_in_turns"][CLIP_MAIN])),
            traced=traced_us(lambda: brick_cuda.clipmap_kernel(
                *args, tree, co, cd, 7, n_max), 5, CLIP_KERNELS[kname]))
    sizes = sorted(set(check["tables"]["clipmap_trace"][0][5].tolist()))
    if len(sizes) < 2:
        raise AssertionError(f"[fly]: frame {check['frame']}'s trunk holds chunks of sizes {sizes}")
    say(f"[fly] fly frame {check['frame']} (the first with chunks of both LODs) == its "
        f"plain versions bitwise: tile_candidates_mapped on its {len(fly_mapped)} phase-1 calls ("
        + ", ".join(f"{r['name']} top depth {r['top_depth']} T={r['T']} K={r['K']} "
                    f"({r['valid']} valid)" for r in fly_mapped)
        + f"), and clipmap_trace, clipmap_trace_brick against trace_clipmap_rounds "
        f"(hit_leaf, hit_t bits, hit_chunk, truncated) on its {co.shape[0]} rays over "
        f"the two-LOD trunk (depth {check['tables']['clipmap_trace'][0][0].depth}, "
        f"{len(check['tables']['clipmap_trace'][0][3])} chunks of sizes {sizes}): "
        + "; ".join(f"{k}: {w['hits']} hits, {w['truncated']} truncated at "
                    f"{w['n_max']} rounds, plain {w['plain_ms']:.1f} ms, kernel "
                    f"{w['us_alone']:.2f} us alone in a CUDA graph"
                    + f" (its first form {w['us_alone_first_form']:.2f}; alone in turns "
                    f"{w['alone_in_turns']}; in turns "
                    + ", ".join(f"{f} {med_p80(v)[0]:.4f} ms" for f, v in w["ms_turns"].items())
                    + ")"
                    + f" (traced "
                    f"{w['traced'][0]:.2f} us in {w['traced'][1]:.2f} launches), work "
                    f"{w['counts']}" for k, w in fly_work.items()))

    # timings at the last pose: the held frames, the brick path, the monolithic frame
    def tile_frame():
        return sr.render(fcam, fetch=False)[0]
    mono_cam = camera.Camera(position=poses[-1][0], look_at=poses[-1][1], fov_y_deg=55.0,
                             width=res, height=res)
    mo, md, mc, _g = tile.tile_rays(mono_cam, dev)
    params = (ctx["svo"].leaf_albedo, ctx["svo"].leaf_normal, ctx["svo"].leaf_density)
    t = in_turns({
        "streamed tile frame": tile_frame,
        "brick path frame": brick_frame,
        "monolithic tile frame": lambda: diff.render_diff_tile(
            *params, ts, mo, md, mc, light, **TILE_BUDGETS),
    }, rounds=3, reps=10)
    prof = {}
    for name, fn in (("streamed tile frame", tile_frame), ("brick path frame", brick_frame),
                     ("monolithic tile frame", lambda: diff.render_diff_tile(
                         *params, ts, mo, md, mc, light, **TILE_BUDGETS))):
        rows = traced_kernels(fn, 10)
        total = sum(dev_us(e) for e in rows) / 10
        prof[name] = dict(us=total, n=sum(e.count for e in rows) / 10,
                          by={e.key: dev_us(e) / 10 for e in rows},
                          n_by={e.key: e.count / 10 for e in rows})
    # each kernel alone at the last pose (the fly frame's mapped calls, the
    # 1024² stitched traces) and its plain version
    kern_ms, last_hits = {}, {}
    for kname, targs, ttree in (("clipmap_trace", nargs, sr.device_arena.tree(7)),
                                ("clipmap_trace_brick", bargs, sr.device_bricks.tree(7))):
        t_max = clipmap.rounds_bound(targs[0].depth)
        last_plain = clipmap.trace_clipmap_rounds(*targs, ttree, lo, ld, t_max)
        for form in (CLIP_MAIN, "first"):
            key = kname + ("_serial" if form == "first" else "")
            got_l = brick_cuda.clipmap_kernel(*targs, ttree, lo, ld, 7, t_max, form=form)
            err[key] = max(err[key], compare_tensors(
                got_l, last_plain, CLIP_OUTPUTS, f"{kname}'s {form} form at the last pose"))
        last_turns = in_turns({form: (lambda f=form, a=targs, tr=ttree, m=t_max:
                                      brick_cuda.clipmap_kernel(*a, tr, lo, ld, 7, m, form=f))
                               for form in (CLIP_MAIN, "first")}, rounds=3, reps=10)
        kern_ms[kname], kern_ms[kname + "_serial"] = last_turns[CLIP_MAIN], last_turns["first"]
        last_hits[kname] = int((last_plain[0] >= 0).sum())
        say(f"[fly] {card}: {kname} at the fly path's last pose ({lo.shape[0]} rays, "
            f"{last_hits[kname]} hits): its {CLIP_MAIN} form and its first form == "
            "trace_clipmap_rounds bitwise (hit_leaf, hit_t bits, hit_chunk, truncated); "
            "in turns " + ", ".join(f"{f} {med_p80(v)[0]:.4f} ms (p80 {med_p80(v)[1]:.4f})"
                                    for f, v in last_turns.items()))
    plain_ms = {}
    for kname in ("clipmap_trace", "clipmap_trace_brick"):
        plain_ms[kname] = work[kname]["plain_ms"]
        kern_ms[kname + " parity rays"] = work[kname]["ms"]
    kern_ms["tile_candidates_mapped"] = cand_parity["parity main"]["radix"]["turns"]
    plain_ms["tile_candidates_mapped"] = float(np.median(cuda_ms(
        lambda: tile.remap_ids(tile.candidates_plain(*main_c["args"])[1],
                               main_c["kw"]["brickmap"]), 3, 1)))
    held = [f["render_ms"] for f in frames[FLY_FRAMES:]]
    moving = [f["render_ms"] for f in frames[1:FLY_FRAMES]]
    say(f"[fly] {card}: cli fly's camera path at {res}x{res}, {FLY_TIMING} "
        f"(LOD depth and top depth {fm}), {FLY_FRAMES} frames of motion "
        f"and {FLY_HOLD} at rest: per frame update ms (host build, sync, stitch) "
        + ", ".join(f"{f['update_ms']:.1f}" for f in frames)
        + "; render ms (host clock, to the residual's read) "
        + ", ".join(f"{f['render_ms']:.2f}" for f in frames)
        + f"; chunks added {[f['added'] for f in frames]}, evicted "
        f"{[f['evicted'] for f in frames]}, residual {[f['residual'] for f in frames]}; "
        f"median render {np.median(held):.3f} ms at rest, {np.median(moving):.3f} ms "
        f"in motion (the first stitches the pyramids); launches over the path and "
        f"the two stitched frames {launches}")
    for name, v in t.items():
        p = prof[name]
        idle = "not measured" if p["us"] <= 0 else f"{1 - p['us'] / 1e3 / med_p80(v)[0]:.2f}"
        say(f"[fly] {card}: {name} at the last pose, in turns: median "
            f"{med_p80(v)[0]:.4f} ms (p80 {med_p80(v)[1]:.4f}), {p['us']:.1f} us of "
            f"kernels in {p['n']:.1f} launches a frame (idle {idle}): "
            + ", ".join(f"{k} {u:.1f}" for k, u in sorted(p["by"].items(), key=lambda x: -x[1])[:6]))
    return dict(launches=launches, frames=frames, t=t, prof=prof, kern_ms=kern_ms,
                last_pose_hits=last_hits["clipmap_trace_brick"],
                plain_ms=plain_ms, work=work, mapped=mapped, k10=k10,
                held_ms=float(np.median(held)), cand_parity=cand_parity,
                cand_fly=cand_fly, fly_mapped=fly_mapped, fly_work=fly_work,
                check_frame=check["frame"])


def compare_lod(kern, plain, what):
    """Two (TraceResult, stats) pairs of the LOD traces bitwise, hit_node
    too; returns the largest absolute difference of hit_t."""
    err = compare_stats(kern, plain, what)
    if not torch.equal(kern[0].hit_node, plain[0].hit_node):
        bad = int((kern[0].hit_node != plain[0].hit_node).sum())
        raise AssertionError(f"{what}: hit_node differs on {bad} rays")
    return err


def lod_ends(res, stats):
    """An LOD trace's rays in words: ending at a node, at a leaf, at no hit;
    cut at the bound; steps a ray."""
    node, leaf = res.hit_node >= 0, res.hit_leaf >= 0
    return dict(node=int(node.sum()), leaf=int(leaf.sum()),
                none=int((~node & ~leaf).sum()),
                cut=int(stats[:, STAT("unfinished")].sum()),
                steps=float(res.iters.double().mean()))


def lod_parity(dev, cam, err):
    """[parity] of the LOD traces (through their launchers) against their
    plain versions on small trees, bitwise (hit_leaf, hit_node, hit_t bits,
    hit_parent, hit_child, iters, statistics): every ray set at the
    camera's pixel footprint c0 and at 8 and 32 times it, the camera's rays
    also at 0.4 and at 0, where each must equal its trace without LOD."""
    empty = Scene("empty", lambda x, y, z: np.ones_like(np.asarray(x, np.float32)), 0.0)
    c0 = 2.0 * np.tan(np.radians(25.0)) / cam.height
    lines, n_cases = [], 0
    for name, depth in (("sphere", 5), ("terrain", 6), ("terrain", 7),
                        ("flat_ground", 6), ("empty", 5), ("sphere", 4)):
        host = octree.build_svo(empty if name == "empty" else get_scene(name), depth).svo
        svo_s, bsvo_s = host.to(dev), brick.make_brick_svo(host).to(dev)
        found = []
        for kind, o, d in ray_sets(dev, cam, 4096, depth + 200):
            coefs = (c0, 8 * c0, 32 * c0) + ((0.4, 0.0) if kind == "camera" else ())
            width = cam.width if kind == "camera" else None
            for coef in coefs:
                what = f"{name} d{depth} {kind} rays N={o.shape[0]} coef {coef:.6g}"
                ks = brick_cuda._stackless_lod_kernel(svo_s, o, d, coef, 0.0, True, width)
                kb = brick_cuda._brick_lod_kernel(bsvo_s, o, d, coef, 0.0, True, width)
                ps = traverse.trace_lod(svo_s, o, d, coef, 0.0, True)
                pb = brick.trace_brick_lod(bsvo_s, o, d, coef, 0.0, True)
                kf = brick_cuda._stackless_lod_kernel(svo_s, o, d, coef, 0.0, True,
                                                      form="first")
                kbf = brick_cuda._brick_lod_kernel(bsvo_s, o, d, coef, 0.0, True,
                                                   form="first")
                probes_b = [brick_cuda.probe_brick_lod_cuda(
                    bsvo_s, o, d, coef, form, width if form == "patched" else None)
                    for form in brick_cuda.FORMS["brick_trace_lod"]]
                torch.cuda.synchronize()
                err["esvo_stackless_lod"] = max(err["esvo_stackless_lod"], compare_lod(
                    ks, ps, f"esvo_stackless_lod, {what}"))
                err["esvo_stackless_lod_serial"] = max(
                    err["esvo_stackless_lod_serial"],
                    compare_lod(kf, ps, f"esvo_stackless_lod first form, {what}"))
                if width is not None:
                    compare_lod(brick_cuda._stackless_lod_kernel(svo_s, o, d, coef, 0.0, True),
                                ps, f"esvo_stackless_lod, rays in order, {what}")
                err["brick_trace_lod"] = max(err["brick_trace_lod"], compare_lod(
                    kb, pb, f"brick_trace_lod, {what}"))
                err["brick_trace_lod_serial"] = max(
                    err["brick_trace_lod_serial"],
                    compare_lod(kbf, pb, f"brick_trace_lod first form, {what}"))
                for form, probe in zip(brick_cuda.FORMS["brick_trace_lod"], probes_b):
                    compare_lod(probe[:2], pb, f"brick_trace_lod {form} probe, {what}")
                if width is not None:
                    compare_lod(brick_cuda._brick_lod_kernel(bsvo_s, o, d, coef, 0.0, True),
                                pb, f"brick_trace_lod, rays in order, {what}")
                if coef == 0.0:
                    compare_stats(ks, brick_cuda._stackless_kernel(svo_s, o, d, True),
                                  f"esvo_stackless_lod at 0 against esvo_stackless, {what}")
                    compare_stats(kb, brick_cuda._brick_kernel(bsvo_s, o, d, True),
                                  f"brick_trace_lod at 0 against brick_trace, {what}")
                    if bool((ks[0].hit_node >= 0).any() or (kb[0].hit_node >= 0).any()):
                        raise AssertionError(f"{what}: a node stop at coefficient 0")
                n_cases += 1
                if kind == "camera" and coef != 0.0:
                    found.append(f"{lod_ends(*ks)['node']}/{lod_ends(*kb)['node']}")
        lines.append(f"{name} d{depth}: " + ", ".join(found))
    say(f"[parity] esvo_stackless_lod (through its launcher in its patched "
        f"form, with the camera's width and without, and in its first form) "
        f"and brick_trace_lod (through its launcher in its patched form, with "
        f"the camera's width and without, in its first form, and both probe "
        f"forms) == traverse.trace_lod and brick.trace_brick_lod bitwise "
        f"(hit_leaf, hit_node, hit_t bits, hit_parent, hit_child, iters, "
        f"statistics) on {n_cases} cases (camera rays 128x128 at c0 = "
        f"{c0:.6g}, 8 c0, 32 c0, 0.4 and 0; 4,096 rays from a shell and from "
        f"inside the cube at c0, 8 c0 and 32 c0), and at 0 == esvo_stackless "
        f"and brick_trace with no node stop; the camera's rays stopped at a "
        f"node by the stackless/brick trace at c0, 8 c0, 32 c0, 0.4: "
        + "; ".join(lines))


def frame_lod(ctx, card):
    """[frame-lod]: the LOD render of `cli render --lod-coef` on the
    depth-10 frame at each of LOD_COEFS: the node attributes on the host,
    then the LOD brick trace and shade_lod (the command's sequence at this
    depth), and render_lod through the LOD stackless trace. Returns what the
    kernels line and the profile take from it."""
    dev, host_svo, svo, bsvo = ctx["dev"], ctx["host_svo"], ctx["svo"], ctx["bsvo"]
    o, d, routes, err, res = ctx["o"], ctx["d"], ctx["routes"], ctx["err"], ctx["res"]
    n_rays = o.shape[0]
    t0 = time.perf_counter()
    node_alb, node_nrm = lod.compute_node_attributes(host_svo)
    attr_s = time.perf_counter() - t0
    node_alb, node_nrm = node_alb.to(dev), node_nrm.to(dev)
    light = render.Light()
    c0 = LOD_C0
    frame = lambda coef: lod.shade_lod(
        svo, node_alb, node_nrm,
        brick_cuda.trace_brick_lod_cuda(bsvo, o, d, coef, width=res), d, light)
    frame_first = lambda coef: lod.shade_lod(
        svo, node_alb, node_nrm, brick_cuda.trace_brick_lod_cuda_serial(bsvo, o, d, coef),
        d, light)
    stackless = lambda coef: lod.render_lod(svo, node_alb, node_nrm, o, d, coef,
                                            light, width=res)[0]
    img, got_b = expect_launches("the LOD frame (brick route)", lambda: frame(c0),
                                 dict(brick_trace_lod=1))
    img_s, got_s = expect_launches("render_lod (stackless route)", lambda: stackless(c0),
                                   dict(esvo_stackless_lod=1))
    for what, im in (("brick route", img), ("render_lod", img_s)):
        if im.shape != (n_rays, 3) or not bool(torch.isfinite(im).all()):
            raise AssertionError(f"LOD frame, {what}: bad image")
    out = dict(attr_s=attr_s, launches=dict(brick_trace_lod=got_b["brick_trace_lod"],
                                            esvo_stackless_lod=got_s["esvo_stackless_lod"]),
               ends={}, plain_ms={}, node_alb=node_alb, node_nrm=node_nrm,
               light=light)
    lines = []
    for name, coef in LOD_COEFS:
        kb = brick_cuda._brick_lod_kernel(bsvo, o, d, coef, 0.0, True, res)
        ks = brick_cuda._stackless_lod_kernel(svo, o, d, coef, 0.0, True, res)
        torch.cuda.synchronize()
        if name in ("c0", "8c0"):
            t0 = time.perf_counter()
            pb = brick.trace_brick_lod(bsvo, o, d, coef, 0.0, True)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ps = traverse.trace_lod(svo, o, d, coef, 0.0, True)
            torch.cuda.synchronize()
            out["plain_ms"][name] = ((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3)
            err["brick_trace_lod"] = max(err["brick_trace_lod"], compare_lod(
                kb, pb, f"brick_trace_lod, terrain d10 frame, coef {name}"))
            err["brick_trace_lod_serial"] = max(
                err["brick_trace_lod_serial"], compare_lod(
                    brick_cuda._brick_lod_kernel(bsvo, o, d, coef, 0.0, True, form="first"),
                    pb, f"brick_trace_lod first form, terrain d10 frame, coef {name}"))
            err["esvo_stackless_lod"] = max(err["esvo_stackless_lod"], compare_lod(
                ks, ps, f"esvo_stackless_lod, terrain d10 frame, coef {name}"))
            err["esvo_stackless_lod_serial"] = max(
                err["esvo_stackless_lod_serial"], compare_lod(
                    brick_cuda._stackless_lod_kernel(svo, o, d, coef, 0.0, True,
                                                     form="first"),
                    ps, f"esvo_stackless_lod first form, terrain d10 frame, coef {name}"))
            compare_lod(brick_cuda._stackless_lod_kernel(svo, o, d, coef, 0.0, True), ps,
                        f"esvo_stackless_lod, rays in order, terrain d10 frame, coef {name}")
            check = ("== its plain version bitwise (each in its patched form, "
                     "esvo_stackless_lod's also without the width, and its first form)")
        elif name == "0":
            compare_stats(kb, (routes["brick"]["res"], routes["brick"]["stats"]),
                          "brick_trace_lod at 0 against brick_trace, terrain d10 frame")
            compare_stats(ks, (routes["plain"]["res"], routes["plain"]["stats"]),
                          "esvo_stackless_lod at 0 against esvo_stackless, terrain d10 frame")
            if bool((kb[0].hit_node >= 0).any() or (ks[0].hit_node >= 0).any()):
                raise AssertionError("the LOD traces stop at a node at coefficient 0")
            # the image without LOD: shade_lod of leaf hits is render.shade
            plain_img = render.shade(kb[0].hit_leaf, d, svo.leaf_albedo,
                                     svo.leaf_normal, light)
            if not torch.equal(lod.shade_lod(svo, node_alb, node_nrm, kb[0], d, light),
                               plain_img):
                raise AssertionError("shade_lod at coefficient 0 differs from render.shade")
            check = ("== brick_trace and esvo_stackless bitwise, no node stop, "
                     "the image == render.shade's")
        else:
            # the two traces walk the same top tree above the bricks; rays
            # on which they part are counted as F19's are (the reference's
            # two walks part on the same rays when they round alike)
            cut = ks[1][:, STAT("unfinished")] == 1
            apart = ~cut & ((kb[0].hit_node != ks[0].hit_node)
                            | (kb[0].hit_leaf != ks[0].hit_leaf)
                            | (bits(kb[0].hit_t) != bits(ks[0].hit_t)))
            out["apart"] = int(apart.sum())
            if out["apart"] > MAX_DIFFER:
                raise AssertionError(f"the LOD traces part on {out['apart']} rays at 0.4")
            check = (f"the two traces part on {out['apart']} of the "
                     f"{int((~cut).sum())} rays the stackless one finishes")
        out["ends"][name] = dict(brick=lod_ends(*kb), stackless=lod_ends(*ks))
        if name in ("c0", "8c0"):
            out[name] = (kb, ks)
        words = lambda e: (f"{e['node']} at a node, {e['leaf']} at a leaf, {e['none']} "
                           f"with no hit, {e['cut']} cut at the bound, "
                           f"{e['steps']:.2f} steps a ray")
        lines.append(f"coef {name} ({coef:.6g}): brick_trace_lod "
                     + words(out["ends"][name]["brick"]) + "; esvo_stackless_lod "
                     + words(out["ends"][name]["stackless"]) + f"; {check}")
    t = {"frame": cuda_ms(lambda: frame(c0), 50, 3),
         "render_lod": cuda_ms(lambda: stackless(c0), 50, 3),
         "frame_8c0": cuda_ms(lambda: frame(8 * c0), 50, 3)}
    t.update({f"{key} in turns": v for key, v in in_turns({
        "frame": lambda: frame(c0), "frame_first": lambda: frame_first(c0)}).items()})
    t.update(in_turns({
        "brick_trace_lod": lambda: brick_cuda.trace_brick_lod_cuda(bsvo, o, d, c0,
                                                                   width=res),
        "brick_trace_lod_serial": lambda: brick_cuda.trace_brick_lod_cuda_serial(
            bsvo, o, d, c0),
        "brick_trace_lod_serial_8c0": lambda: brick_cuda.trace_brick_lod_cuda_serial(
            bsvo, o, d, 8 * c0),
        "esvo_stackless_lod": lambda: brick_cuda.trace_lod_cuda(svo, o, d, c0, width=res),
        "brick_trace_lod_8c0": lambda: brick_cuda.trace_brick_lod_cuda(bsvo, o, d, 8 * c0,
                                                                       width=res),
        "esvo_stackless_lod_8c0": lambda: brick_cuda.trace_lod_cuda(svo, o, d, 8 * c0,
                                                                    width=res),
        "esvo_stackless_lod_serial": lambda: brick_cuda.trace_lod_cuda_serial(svo, o, d, c0),
        "esvo_stackless_lod_serial_8c0": lambda: brick_cuda.trace_lod_cuda_serial(
            svo, o, d, 8 * c0),
        "brick_trace": lambda: brick_cuda.trace_brick_cuda(bsvo, o, d),
        "esvo_stackless": lambda: brick_cuda.trace_stackless_cuda(svo, o, d, width=res)}))
    out["ms"] = m = {k: med_p80(v) for k, v in t.items()}
    say(f"[frame-lod] {res}x{res} depth 10, the default Light: node attributes "
        f"of {host_svo.n_nodes} nodes on the host in {attr_s:.2f} s; the frame "
        f"(brick_trace_lod, shade_lod) launched {got_b}, render_lod {got_s}, no "
        f"other kernel and no plain call; " + "; ".join(lines)
        + f" (plain versions at c0 {out['plain_ms']['c0'][0]:.1f} and "
        f"{out['plain_ms']['c0'][1]:.1f} ms, n=1)")
    say(f"[frame-lod] {card}: at c0 the frame (brick_trace_lod, shade_lod) "
        f"median {m['frame'][0]:.4f} ms (p80 {m['frame'][1]:.4f}, n=50) = "
        f"{n_rays / m['frame'][0] / 1e3:.2f} Mrays/s (in turns, three rounds of 50, "
        f"{m['frame in turns'][0]:.4f} against {m['frame_first in turns'][0]:.4f} with "
        f"brick_trace_lod's first form), render_lod median "
        f"{m['render_lod'][0]:.4f} ms (p80 {m['render_lod'][1]:.4f}); at 8 c0 the "
        f"frame {m['frame_8c0'][0]:.4f} ms (p80 {m['frame_8c0'][1]:.4f}); in turns, "
        f"three rounds of 50: brick_trace_lod {m['brick_trace_lod'][0]:.4f} ms "
        f"(p80 {m['brick_trace_lod'][1]:.4f}; at 8 c0 "
        f"{m['brick_trace_lod_8c0'][0]:.4f}; its first form "
        f"{m['brick_trace_lod_serial'][0]:.4f}, at 8 c0 "
        f"{m['brick_trace_lod_serial_8c0'][0]:.4f}) against brick_trace "
        f"{m['brick_trace'][0]:.4f}, esvo_stackless_lod "
        f"{m['esvo_stackless_lod'][0]:.4f} ({m['esvo_stackless_lod'][1]:.4f}; at "
        f"8 c0 {m['esvo_stackless_lod_8c0'][0]:.4f}; its first form "
        f"{m['esvo_stackless_lod_serial'][0]:.4f}, at 8 c0 "
        f"{m['esvo_stackless_lod_serial_8c0'][0]:.4f}) against esvo_stackless "
        f"{m['esvo_stackless'][0]:.4f}")
    return out


# the ragged images [stackless-forms] holds the patched forms on: neither
# side a multiple of its patch's
RAGGED_IMAGES = ((1023, 17), (333, 101))


def alone_us(fn, key):
    """us a launch of the kernel whose name holds `key`, from torch.profiler
    over 20 calls of fn() (80 if the tracer saw none); None if it never
    did."""
    for runs in (20, 80):
        mine = [e for e in traced_kernels(fn, runs) if key in e.key]
        n = sum(e.count for e in mine)
        if n:
            return sum(dev_us(e) for e in mine) / n
    return None


def unpermute(res, order, n):
    """A trace's outputs on rays taken in `order` (every ray once), put back
    at each ray's own index."""
    back = torch.empty(n, dtype=torch.int64, device=order.device)
    back[order] = torch.arange(n, device=order.device)
    fields = {f.name: getattr(res[0], f.name) for f in dataclasses.fields(res[0])}
    moved = {k: None if v is None else v[back] for k, v in fields.items()}
    return type(res[0])(**moved), res[1][back]


def stackless_forms(ctx, card):
    """[stackless-forms]: the stackless traces' patched form (warps of 8 x 4
    pixel patches, one 16-byte node row read where the node changes) against
    their first form. Parity on two ragged images (each form, the patched
    one at every block of PATCH_BLOCKS, with the image's width and without,
    and the probes) against the plain versions; then on the depth-10 frame
    the two changes alone and together, in turns and alone, with their
    warps: the first form, the first form on the rays taken in the patch
    order (patches alone), the patched form on the rays in their order (the
    row alone) and with the width (both) at each block; the LOD form at c0
    and 8 c0, and the k-segment form at k = 4. Returns each kernel's
    variants for the kernels line."""
    dev, svo, o, d, res = ctx["dev"], ctx["svo"], ctx["o"], ctx["d"], ctx["res"]
    err, bench_cam = ctx["err"], ctx["bench_cam"]
    n, k = o.shape[0], VOLUME_K
    host = octree.build_svo(get_scene("terrain"), 7).svo
    small = host.to(dev)
    found = []
    for w, h in RAGGED_IMAGES:
        o_r, d_r = camera.Camera(**bench_cam, width=w, height=h).rays(dev)
        what = f"terrain d7 {w}x{h}"
        plain = traverse.trace_stackless(small, o_r, d_r, True)
        got = [brick_cuda._stackless_kernel(small, o_r, d_r, True, w, block=b)
               for b in PATCH_BLOCKS]
        got += [brick_cuda._stackless_kernel(small, o_r, d_r, True),
                brick_cuda.probe_stackless_cuda(small, o_r, d_r, "patched", w)[:2]]
        first = brick_cuda._stackless_kernel(small, o_r, d_r, True, form="first")
        torch.cuda.synchronize()
        for g in got:
            err["esvo_stackless"] = max(err["esvo_stackless"], compare_stats(
                g, plain, f"esvo_stackless patched, {what}"))
        err["esvo_stackless_serial"] = max(err["esvo_stackless_serial"], compare_stats(
            first, plain, f"esvo_stackless first form, {what}"))
        c0 = 2.0 * np.tan(np.radians(25.0)) / h
        for coef in (c0, 8 * c0):
            pl = traverse.trace_lod(small, o_r, d_r, coef, 0.0, True)
            for b in PATCH_BLOCKS:
                err["esvo_stackless_lod"] = max(err["esvo_stackless_lod"], compare_lod(
                    brick_cuda._stackless_lod_kernel(small, o_r, d_r, coef, 0.0, True, w,
                                                     block=b),
                    pl, f"esvo_stackless_lod patched, {what}, coef {coef:.6g}"))
            err["esvo_stackless_lod_serial"] = max(
                err["esvo_stackless_lod_serial"], compare_lod(
                    brick_cuda._stackless_lod_kernel(small, o_r, d_r, coef, 0.0, True,
                                                     form="first"),
                    pl, f"esvo_stackless_lod first form, {what}, coef {coef:.6g}"))
        for kk in (1, k, 7):
            pm = traverse.trace_multi(small, o_r, d_r, kk, True)
            for b in PATCH_BLOCKS:
                err["esvo_stackless_multi"] = max(err["esvo_stackless_multi"], multi_compare(
                    brick_cuda._stackless_multi_kernel(small, o_r, d_r, kk, True, w,
                                                       block=b),
                    pm, f"esvo_stackless_multi patched, {what}, k={kk}"))
            multi_compare(brick_cuda.probe_stackless_multi_cuda(
                small, o_r, d_r, kk, "patched", w)[:2], pm,
                f"esvo_stackless_multi patched probe, {what}, k={kk}")
            err["esvo_stackless_multi_serial"] = max(
                err["esvo_stackless_multi_serial"], multi_compare(
                    brick_cuda._stackless_multi_kernel(small, o_r, d_r, kk, True,
                                                       form="first"),
                    pm, f"esvo_stackless_multi first form, {what}, k={kk}"))
        found.append(f"{w}x{h} ({brick_cuda.patch_threads(w * h, w) - w * h} idle "
                     f"lanes, {int((plain[0].hit_leaf >= 0).sum())} hits)")
    say(f"[parity] the stackless traces' patched forms (esvo_stackless, "
        f"esvo_stackless_lod at c0 and 8 c0, esvo_stackless_multi at k = 1, 4, "
        f"7) with the image's width at blocks of {PATCH_BLOCKS}, without it, "
        f"and their probe forms, and the first forms == the plain versions "
        f"bitwise on ragged images of terrain d7: " + ", ".join(found))

    # the frame: the two changes alone and together
    order = brick_cuda.patch_order(n, res).to(dev)
    if bool((order < 0).any()):
        raise AssertionError("the frame's patch order has idle lanes")
    op, dp = o[order].contiguous(), d[order].contiguous()
    c0 = LOD_C0
    traces = {
        "esvo_stackless": dict(
            kernel=FORM_KERNELS[("esvo_stackless", "patched")],
            first_kernel=FORM_KERNELS[("esvo_stackless", "first")],
            call=lambda oo, dd, **kw: brick_cuda._stackless_kernel(svo, oo, dd, True, **kw),
            probe=lambda oo, dd, form, width: brick_cuda.probe_stackless_cuda(
                svo, oo, dd, form, width),
            compare=compare_stats),
        "esvo_stackless_lod c0": dict(
            kernel=LOD_KERNELS["patched"], first_kernel=LOD_KERNELS["first"],
            call=lambda oo, dd, **kw: brick_cuda._stackless_lod_kernel(
                svo, oo, dd, c0, 0.0, True, **kw), compare=compare_lod),
        "esvo_stackless_lod 8c0": dict(
            kernel=LOD_KERNELS["patched"], first_kernel=LOD_KERNELS["first"],
            call=lambda oo, dd, **kw: brick_cuda._stackless_lod_kernel(
                svo, oo, dd, 8 * c0, 0.0, True, **kw), compare=compare_lod),
        "esvo_stackless_multi": dict(
            kernel=MULTI_KERNELS["esvo_stackless_multi"],
            first_kernel=MULTI_KERNELS["esvo_stackless_multi_serial"],
            call=lambda oo, dd, **kw: brick_cuda._stackless_multi_kernel(
                svo, oo, dd, k, True, **kw),
            probe=lambda oo, dd, form, width: brick_cuda.probe_stackless_multi_cuda(
                svo, oo, dd, k, form, width),
            compare=multi_compare)}
    out = {}
    for tname, t in traces.items():
        call, compare_fn = t["call"], t["compare"]
        variants = {
            "first": (lambda: call(o, d, form="first"), t["first_kernel"]),
            "first, rays in patch order": (lambda: call(op, dp, form="first"),
                                           t["first_kernel"]),
            "patched, rays in order": (lambda: call(o, d), t["kernel"]),
            **{f"patched, blocks of {b}": (lambda b=b: call(o, d, width=res, block=b),
                                           t["kernel"]) for b in PATCH_BLOCKS}}
        want = call(o, d, form="first")
        for name, (fn, _key) in variants.items():
            got = fn()
            if name == "first, rays in patch order":
                got = unpermute(got, order, n)
            compare_fn(got, want, f"{tname} {name}, terrain d10 frame, against the "
                                  f"first form")
        torch.cuda.synchronize()
        turns = in_turns({name: fn for name, (fn, _key) in variants.items()},
                         rounds=4, reps=30)
        rows = {name: dict(ms=med_p80(turns[name]), us_alone=alone_us(fn, key))
                for name, (fn, key) in variants.items()}
        if "probe" in t:
            iters = want[0].iters
            for name, oo, dd, form, width, it in (
                    ("first", o, d, "first", None, iters),
                    ("first, rays in patch order", op, dp, "first", None, iters[order]),
                    ("patched, rays in order", o, d, "patched", None, iters),
                    ("patched, blocks of 128", o, d, "patched", res, iters)):
                rec = t["probe"](oo, dd, form, width)
                torch.cuda.synchronize()
                rows[name]["warps"] = warps_line(f"{tname.split()[0]} ({name})", form,
                                                 rec[2], it.cpu().numpy(), width)
        out[tname] = rows
        main_name = f"patched, blocks of {brick_cuda.BLOCKS[('esvo_stackless', 'patched')]}"
        say(f"[timing] {card}: {tname} on the {res}x{res} depth-10 frame, every "
            f"variant == the first form bitwise; in turns (four rounds of 30) "
            f"median ms (p80), and us alone: " + "; ".join(
                f"{name} {r['ms'][0]:.4f} ({r['ms'][1]:.4f}), {us_or(r['us_alone'])} us"
                for name, r in rows.items())
            + f"; the main path's ({main_name}) against the first form "
            f"{rows[main_name]['ms'][0] / rows['first']['ms'][0]:.3f} in turns")
    say(f"[profile] {card}: the stackless traces' variants alone are in the "
        f"[timing] lines above (torch.profiler, 20 calls each)")
    return out


def brick_lod_forms(ctx, card):
    """[brick-lod-forms]: the LOD brick trace's patched form (warps of 8 x 4
    pixel patches, blocks of the caller's size, each thread's staged row in
    dynamic shared memory) against its first form (blocks of 256, the rays
    in their own order). Parity on two ragged images of terrain d7 (each
    form, the patched one at every block of PATCH_BLOCKS with the image's
    width and without, and both probe forms, at 0, c0 and 8 c0 of the
    image) against the plain version and at 0 against brick_trace; then on
    the depth-10 frame at c0, 8 c0 and 0 every variant bitwise against the
    first form (at 0 also against brick_trace's frame), timed in turns and
    alone: the first form, the first form on the rays taken in the patch
    order (patches alone), the patched form on the rays in their order and
    with the width at each block, and at 0 brick_trace beside them (alone:
    the two changes each alone at c0 only); both probe forms' warps at c0
    and 8 c0. Returns each coefficient's variants for the kernels line."""
    t_phase = time.perf_counter()
    dev, bsvo, o, d, res = ctx["dev"], ctx["bsvo"], ctx["o"], ctx["d"], ctx["res"]
    err, bench_cam, routes = ctx["err"], ctx["bench_cam"], ctx["routes"]
    n = o.shape[0]
    small = brick.make_brick_svo(octree.build_svo(get_scene("terrain"), 7).svo).to(dev)
    found = []
    for w, h in RAGGED_IMAGES:
        o_r, d_r = camera.Camera(**bench_cam, width=w, height=h).rays(dev)
        c0 = 2.0 * np.tan(np.radians(25.0)) / h
        stops = []
        for coef in (0.0, c0, 8 * c0):
            what = f"terrain d7 {w}x{h}, coef {coef:.6g}"
            plain = brick.trace_brick_lod(small, o_r, d_r, coef, 0.0, True)
            got = [brick_cuda._brick_lod_kernel(small, o_r, d_r, coef, 0.0, True, w,
                                                block=b) for b in PATCH_BLOCKS]
            got += [brick_cuda._brick_lod_kernel(small, o_r, d_r, coef, 0.0, True),
                    brick_cuda.probe_brick_lod_cuda(small, o_r, d_r, coef, "patched",
                                                    w)[:2]]
            first = [brick_cuda._brick_lod_kernel(small, o_r, d_r, coef, 0.0, True,
                                                  form="first"),
                     brick_cuda.probe_brick_lod_cuda(small, o_r, d_r, coef, "first")[:2]]
            torch.cuda.synchronize()
            for g in got:
                err["brick_trace_lod"] = max(err["brick_trace_lod"], compare_lod(
                    g, plain, f"brick_trace_lod patched, {what}"))
            for g in first:
                err["brick_trace_lod_serial"] = max(
                    err["brick_trace_lod_serial"],
                    compare_lod(g, plain, f"brick_trace_lod first form, {what}"))
            if coef == 0.0:
                compare_stats(got[0], brick_cuda._brick_kernel(small, o_r, d_r, True),
                              f"brick_trace_lod at 0 against brick_trace, {what}")
            stops.append(str(int((plain[0].hit_node >= 0).sum())))
        found.append(f"{w}x{h} ({brick_cuda.patch_threads(w * h, w) - w * h} idle "
                     f"lanes; rays stopped at a node at 0, c0, 8 c0: {'/'.join(stops)})")
    say(f"[parity] brick_trace_lod's patched form with the image's width at blocks "
        f"of {PATCH_BLOCKS} and without it, its first form and both probe forms == "
        f"brick.trace_brick_lod bitwise (hit_leaf, hit_node, hit_t bits, "
        f"hit_parent, hit_child, iters, statistics), and at 0 == brick_trace, on "
        f"ragged images of terrain d7 at 0, c0 and 8 c0 of each image: "
        + ", ".join(found))

    # the frame: the two forms, patches alone, the row order alone, blocks
    order = brick_cuda.patch_order(n, res).to(dev)
    if bool((order < 0).any()):
        raise AssertionError("the frame's patch order has idle lanes")
    op, dp = o[order].contiguous(), d[order].contiguous()
    main_block = brick_cuda.BLOCKS[("brick_trace_lod", "patched")]
    out = {}
    for cname, coef in (("c0", LOD_C0), ("8c0", 8 * LOD_C0), ("0", 0.0)):
        call = lambda oo, dd, coef=coef, **kw: brick_cuda._brick_lod_kernel(
            bsvo, oo, dd, coef, 0.0, True, **kw)
        variants = {
            "first": (lambda call=call: call(o, d, form="first"), BRICK_LOD_KERNELS["first"]),
            "first, rays in patch order": (lambda call=call: call(op, dp, form="first"),
                                           BRICK_LOD_KERNELS["first"]),
            "patched, rays in order": (lambda call=call: call(o, d),
                                       BRICK_LOD_KERNELS["patched"]),
            **{f"patched, blocks of {b}": (lambda b=b, call=call: call(o, d, width=res,
                                                                       block=b),
                                           BRICK_LOD_KERNELS["patched"])
               for b in PATCH_BLOCKS}}
        want = call(o, d, form="first")
        for name, (fn, _key) in variants.items():
            got = fn()
            if name == "first, rays in patch order":
                got = unpermute(got, order, n)
            compare_lod(got, want, f"brick_trace_lod {name}, terrain d10 frame, coef "
                                   f"{cname}, against the first form")
        if cname == "0":
            compare_stats(want, (routes["brick"]["res"], routes["brick"]["stats"]),
                          "brick_trace_lod's first form at 0 against brick_trace, "
                          "terrain d10 frame")
            variants["brick_trace"] = (lambda: brick_cuda._brick_kernel(bsvo, o, d, True),
                                       FORM_KERNELS[("brick_trace", "wide")])
        torch.cuda.synchronize()
        turns = in_turns({name: fn for name, (fn, _key) in variants.items()},
                         rounds=3, reps=30)
        one_change = ("first, rays in patch order", "patched, rays in order")
        rows = {name: dict(ms=med_p80(turns[name]),
                           us_alone=(alone_us(fn, key) if cname == "c0"
                                     or name not in one_change else None))
                for name, (fn, key) in variants.items()}
        if cname != "0":
            iters = want[0].iters
            for name, form, width, block in (
                    ("first", "first", None, None),
                    (f"patched, blocks of {main_block}", "patched", res, main_block)):
                rec = brick_cuda.probe_brick_lod_cuda(bsvo, o, d, coef, form, width, block)
                compare_lod(rec[:2], want, f"brick_trace_lod {form} probe, terrain d10 "
                                           f"frame, coef {cname}")
                rows[name]["warps"] = warps_line(f"brick_trace_lod ({name}, coef {cname})",
                                                 form, rec[2], iters.cpu().numpy(), width,
                                                 block)
        out[cname] = rows
        main_name = f"patched, blocks of {main_block}"
        say(f"[timing] {card}: brick_trace_lod at coef {cname} on the {res}x{res} "
            f"depth-10 frame, every variant == the first form bitwise"
            + (" and == brick_trace" if cname == "0" else "")
            + "; in turns (three rounds of 30) median ms (p80), and us alone: "
            + "; ".join(f"{name} {r['ms'][0]:.4f} ({r['ms'][1]:.4f}), "
                        f"{us_or(r['us_alone'])} us" for name, r in rows.items())
            + f"; the main path's ({main_name}) against the first form "
            f"{rows[main_name]['ms'][0] / rows['first']['ms'][0]:.3f} in turns")
    say(f"[brick-lod-forms] {card}: brick_trace_lod's forms on the {res}x{res} frame "
        f"(the [timing] and [warps] lines above): us alone, first form / patched at "
        f"blocks of {' / '.join(str(b) for b in PATCH_BLOCKS)}: " + "; ".join(
            f"coef {cname} {us_or(rows['first']['us_alone'])} / " + " / ".join(
                us_or(rows[f'patched, blocks of {b}']['us_alone']) for b in PATCH_BLOCKS)
            for cname, rows in out.items())
        + f"; brick_trace at 0 {us_or(out['0']['brick_trace']['us_alone'])} "
        f"(this phase {time.perf_counter() - t_phase:.1f} s of the host's clock)")
    return out


def builtin_volumetric_grads(seg, d, target, params, light):
    """The volumetric L2 loss's gradients by builtin autograd of
    ``composite_rows`` through plain indexing on the card: no kernel of the
    port and no custom backward."""
    n, k = seg.hit_leaf.shape
    valid, safe = shade_cuda.safe_leaf(seg.hit_leaf.reshape(-1), params[0].shape[0])
    sky = sky_color(d)

    def loss(a, nr, s):
        img = shade_cuda.composite_rows(
            a[safe].reshape(n, k, 3), nr[safe].reshape(n, k, 3), s[safe].reshape(n, k),
            valid.reshape(n, k), seg.t_in, seg.t_out, sky, light, 1.3, 0.08,
            DENSITY_SCALE)
        return torch.mean((img - target) ** 2)
    return diff._value_and_grads(loss, *params)[1]


def check_composite_bwd(seg, g, d, pset, light, what):
    """composite_bwd against composite_bwd_plain on the same segments (rtol
    1e-5, atol 1e-6, as shade_bwd; padded slots' rows zero); returns the
    kernel's rows and the largest absolute difference."""
    args = (seg.hit_leaf, seg.t_in, seg.t_out, d, *pset, light, 1.3, 0.08,
            DENSITY_SCALE)
    got = shade_cuda.composite_bwd(g, *args)
    want = shade_cuda.composite_bwd_plain(g, *args)
    torch.cuda.synchronize()
    e = float((got - want).abs().max()) if got.numel() else 0.0
    if got.shape != want.shape or not torch.allclose(got, want, rtol=1e-5, atol=1e-6):
        raise AssertionError(f"composite_bwd, {what}: max abs {e} against "
                             f"composite_bwd_plain")
    if bool(got[seg.hit_leaf.reshape(-1) < 0].any()):
        raise AssertionError(f"composite_bwd, {what}: a padded slot has a row")
    return got, e


def step_volumetric(ctx, card, served):
    """[step-volumetric]: the volumetric L2 step, target 0, on both routes
    at k = 4: loss and gradients of the three parameter tensors through
    composite_fwd, composite_bwd and segment_sum, each held against its
    plain version, the sums against the serial scatter-add and the
    gradients against builtin autograd on the card. Returns what the
    kernels line and the profile take from it."""
    dev, svo, bsvo, o, d = ctx["dev"], ctx["svo"], ctx["bsvo"], ctx["o"], ctx["d"]
    light, params, err, host_svo = ctx["light"], ctx["params"], ctx["err"], ctx["host_svo"]
    k, n_leaves = VOLUME_K, params[0].shape[0]
    target0 = torch.zeros_like(o)
    steps = {
        "stackless": lambda: diff._value_and_grads(
            lambda a, nr, s: diff.volumetric_l2_loss(a, nr, s, svo, o, d, light,
                                                     target0, k=k), *params),
        "brick": lambda: diff._value_and_grads(
            lambda a, nr, s: torch.mean((diff.render_volumetric_brick(
                a, nr, s, bsvo, o, d, light, k=k, density_scale=DENSITY_SCALE)
                - target0) ** 2), *params)}
    segs = {"brick": served["multi"][0][0], "stackless": served["multi"][1][0]}
    trace_of = {"brick": "brick_trace_multi", "stackless": "esvo_stackless_multi"}
    g_unit = torch.from_numpy(np.random.default_rng(13).random(
        (o.shape[0], 3), dtype=np.float32) - 0.5).to(dev)
    pset = volume_params(host_svo, dev, 14)
    out = dict(launches={}, ms={}, segs=segs, steps=steps)
    lines = []
    for route, fn in steps.items():
        (loss, grads), got = expect_launches(
            f"the volumetric step, {route} route", fn,
            {trace_of[route]: 1, "composite_fwd": 1, "composite_bwd": 1,
             "segment_sum": 1})
        out["launches"][route] = got
        seg = segs[route]
        e_unit = max(check_composite_bwd(seg, g_unit, d, p, light,
                                         f"{route} segments, {what}")[1]
                     for what, p in (("the scene", params), ("random densities", pset)))
        img = shade_cuda.composite_fwd(seg.hit_leaf, seg.t_in, seg.t_out, d, *params,
                                       light, 1.3, 0.08, DENSITY_SCALE)
        # the loss's cotangent as autograd forms it: 2 * img times 1 / numel
        cot, e_step = check_composite_bwd(seg, (2.0 * img) * (1.0 / img.numel()), d,
                                          params, light,
                                          f"{route} segments, the step's cotangent")
        err["composite_bwd"] = max(err["composite_bwd"], e_unit, e_step)
        sums, _e_sum, _e_sorted = check_segment_sum(
            f"the volumetric {route} step", cot, seg.hit_leaf.reshape(-1), n_leaves)
        step_rows = join7(grads)
        if not torch.allclose(sums, step_rows, rtol=1e-5,
                              atol=1e-6 * float(step_rows.abs().max())):
            raise AssertionError(f"the volumetric {route} step's gradients are not "
                                 f"segment_sum of composite_bwd's rows")
        want = builtin_volumetric_grads(seg, d, target0, params, light)
        scale = max(float(w.abs().max()) for w in want)
        worst, _scale = check_grads(grads, want, f"the volumetric {route} step",
                                    rtol=1e-5, atol=1e-5 * scale)
        if not scale > 0.0 or not bool(torch.isfinite(loss)):
            raise AssertionError(f"the volumetric {route} step: no gradient")
        lines.append(f"{route} route: launches {got}, loss {float(loss):.6f}; "
                     f"composite_bwd within rtol 1e-5 of composite_bwd_plain (max "
                     f"abs {e_unit:.3g} at a unit cotangent on the scene's and on "
                     f"random densities, {e_step:.3g} at the step's); the per-leaf "
                     f"sums == the serial scatter-add bitwise; the gradients == "
                     f"builtin autograd of composite_rows within rtol 1e-5, atol "
                     f"1e-5 x {scale:.3g} (max abs {worst:.3g})")
    t = {f"step_{route}": cuda_ms(fn, 50, 3) for route, fn in steps.items()}
    kb = segs["brick"]
    img = shade_cuda.composite_fwd(kb.hit_leaf, kb.t_in, kb.t_out, d, *params, light,
                                   1.3, 0.08, DENSITY_SCALE)
    bwd_args = ((2.0 * img) * (1.0 / img.numel()), kb.hit_leaf, kb.t_in, kb.t_out,
                d, *params, light, 1.3, 0.08, DENSITY_SCALE)
    t.update(in_turns({"composite_bwd": lambda: shade_cuda.composite_bwd(*bwd_args),
                       "composite_fwd": lambda: shade_cuda.composite_fwd(
                           *bwd_args[1:])}))
    t["composite_bwd_plain"] = cuda_ms(lambda: shade_cuda.composite_bwd_plain(*bwd_args),
                                       10, 2)
    out["ms"] = m = {name: med_p80(v) for name, v in t.items()}
    out["bwd_args"] = bwd_args
    vm = served["ms"]
    ratio = {"brick": m["step_brick"][0] / vm["vol_brick"][0],
             "stackless": m["step_stackless"][0] / vm["vol_flat"][0]}
    out["fwdbwd_over_fwd"] = ratio
    say(f"[step-volumetric] {ctx['res']}x{ctx['res']} depth 10, k={k}, density "
        f"scale {DENSITY_SCALE}, target 0: " + "; ".join(lines))
    say(f"[step-volumetric] {card}: fwd+bwd step median "
        f"{m['step_brick'][0]:.4f} ms (p80 {m['step_brick'][1]:.4f}, n=50) on the "
        f"brick route, fwdbwd_over_fwd {ratio['brick']:.3f} against "
        f"diff.render_volumetric_brick's {vm['vol_brick'][0]:.4f}; "
        f"{m['step_stackless'][0]:.4f} ms (p80 {m['step_stackless'][1]:.4f}) on the "
        f"stackless route, fwdbwd_over_fwd {ratio['stackless']:.3f} against "
        f"diff.render_volumetric's {vm['vol_flat'][0]:.4f}; in turns, three rounds "
        f"of 50: composite_bwd {m['composite_bwd'][0]:.4f} ms (p80 "
        f"{m['composite_bwd'][1]:.4f}), composite_fwd {m['composite_fwd'][0]:.4f}; "
        f"composite_bwd_plain {m['composite_bwd_plain'][0]:.4f} (n=10)")
    return out


def ray_sets(dev, cam, n, seed):
    """(name, o, d) on `dev`: a camera's rays, rays from a shell aimed near
    the centre, and rays from inside the cube in random directions."""
    rng = np.random.default_rng(seed)
    inside_d = rng.normal(size=(n, 3))
    inside_d /= np.linalg.norm(inside_d, axis=1, keepdims=True)
    as_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    return [("camera", *cam.rays(dev)),
            ("random", *(as_dev(a) for a in random_rays(n, seed))),
            ("inside", as_dev(rng.random((n, 3))), as_dev(inside_d))]


def route_line(res, stats):
    """A per-ray route's frame in words: hits, steps a ray and the rays
    that reach each bound."""
    dda = stats[:, STAT("dda_steps")].double()
    top = res.iters.double() - dda
    return (f"{int((res.hit_leaf >= 0).sum())} hits; {float(top.mean()):.2f} top "
            f"steps and {float(dda.mean()):.2f} DDA steps a ray (most "
            f"{int(res.iters.max())} steps, {int(stats[:, STAT('rounds')].max())} "
            f"rounds, {int(stats[:, STAT('dda_max')].max())} DDA steps in one "
            f"round); {int((stats[:, STAT('top_capped')] > 0).sum())} rays reach "
            f"a round's top-step cap, {int(stats[:, STAT('unfinished')].sum())} "
            f"stop unfinished at the route's bound")


def trace_forms(bsvo, svo, o, d, width=None):
    """(kernel, form) -> (TraceResult, stats) of brick_trace and
    esvo_stackless on these rays through the main path's wrapper ("main"),
    each also in its other forms, and every form in its probe form (form
    "... probe"); the stackless trace's patched form over an image `width`
    wide (None: the rays in their own order) and, with a width, also
    without it."""
    out = {
        ("brick_trace", "main"): brick_cuda._brick_kernel(bsvo, o, d, True),
        ("brick_trace", "first"): brick_cuda._brick_serial_kernel(bsvo, o, d, True),
        ("brick_trace", "unstaged"): brick_cuda._brick_unstaged_kernel(bsvo, o, d, True),
        ("esvo_stackless", "main"): brick_cuda._stackless_kernel(svo, o, d, True, width),
        ("esvo_stackless", "first"): brick_cuda._stackless_kernel(svo, o, d, True,
                                                                  form="first"),
        ("esvo_stackless", "first probe"): brick_cuda.probe_stackless_cuda(
            svo, o, d)[:2],
        ("esvo_stackless", "patched probe"): brick_cuda.probe_stackless_cuda(
            svo, o, d, "patched", width)[:2]}
    if width is not None:
        out[("esvo_stackless", "patched, rays in order")] = brick_cuda._stackless_kernel(
            svo, o, d, True)
    for form in brick_cuda.FORMS["brick_trace"]:
        out[("brick_trace", f"{form} probe")] = brick_cuda.probe_brick_cuda(
            bsvo, o, d, form)[:2]
    return out


def ptxas_report(log):
    """(kernel, registers, spill bytes stored, shared bytes) for each
    kernel of brick_trace.cu's (or tile_candidates.cu's, or the loop probe's
    of shade.cu) ptxas report, named as torch.profiler names them."""
    rows, name, stores = [], None, 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            # the mangled name: its length, the name, and a template's
            # arguments (Lb0E, Lb1E: false, true; Li256E: 256)
            m = re.search(r"\d+((?:brick_trace|esvo_stackless|clipmap_trace|level_round"
                          r"|level_queue|tile_candidates|loop_probe)\w*?_kernel)"
                          r"(?:I((?:L[ib]\d+E)+)E)?", line)
            name, stores = None, 0
            if m:
                args = [("true" if v == "1" else "false") if t == "b" else v
                        for t, v in re.findall(r"L([ib])(\d+)E", m.group(2) or "")]
                name = m.group(1) + (f"<{', '.join(args)}>" if args else "")
            continue
        spill = re.search(r"(\d+) bytes spill stores", line)
        if spill and name:
            stores = int(spill.group(1))
        used = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if used and name:
            rows.append((name, int(used.group(1)), stores, int(used.group(2) or 0)))
            name = None
    return rows


def warps_line(kernel, form, record, iters, width=None, block=None):
    """[warps]: one form's per-warp counters on the frame in words: each
    phase's issues a warp, SIMT efficiency (lanes active a issue over 32)
    and share of warp cycles; warp durations; each block's tail; the
    kernel's span and how much of it follows the end of 99 in 100 warps;
    the last warp to end, with its issues against its longest ray's steps.
    Returns the numbers. `kernel`: its name, or a label that starts with
    it; a patched form's launch over an image `width` wide walks its rays
    in brick_cuda.patch_order, in blocks of `block` (None: its BLOCKS)."""
    if block is None:
        block = brick_cuda.BLOCKS[(kernel.split()[0], form)]
    r = record.cpu().numpy().astype(np.float64)
    f = {k: r[:, i] for i, k in enumerate(brick_cuda.PROBE_FIELDS)}
    cycles = f["end"] - f["start"]
    phases = {}
    for ph in brick_cuda.PHASES:
        issues = f[f"{ph}_issues"].sum()
        if issues:
            phases[ph] = (issues / len(cycles), f[f"{ph}_lanes"].sum() / (32 * issues),
                          f[f"{ph}_cycles"].sum() / cycles.sum())
    t0 = f["ns_start"].min()
    start, end = (f["ns_start"] - t0) / 1e3, (f["ns_end"] - t0) / 1e3
    dur = end - start
    span, t99 = float(end.max()), float(np.percentile(end, 99))
    per_block = block // 32
    ends = end[: len(end) // per_block * per_block].reshape(-1, per_block)
    tail = ends.max(axis=1) - np.median(ends, axis=1)
    last = int(np.argmax(end))
    steps_total = f["step_issues"][last] + f["dda_issues"][last]
    longest = ""
    order = (brick_cuda.patch_order(len(iters), width).numpy() if form == "patched"
             else np.arange(len(cycles) * 32))
    lanes = order[last * 32:(last + 1) * 32]
    lanes = lanes[(lanes >= 0) & (lanes < len(iters))]
    if len(lanes):
        lane_steps = max(int(iters[lanes].max()), 1)
        longest = (f", {steps_total:.0f} step and DDA issues for its longest ray's "
                   f"{lane_steps} steps ({steps_total / lane_steps:.2f} issues a step)")
    say(f"[warps] {kernel} {form} ({len(cycles)} warps of {block}-thread "
        f"blocks): " + "; ".join(
            f"{ph} {n:.1f} issues a warp, SIMT {e:.3f}, {c:.3f} of warp cycles"
            for ph, (n, e, c) in phases.items())
        + f"; warp time median {np.median(dur):.2f} us, p99 {np.percentile(dur, 99):.1f}, "
        f"max {dur.max():.1f}; block tail (last warp's end - median warp's end) "
        f"median {np.median(tail):.2f} us, max {tail.max():.1f}; the kernel spans "
        f"{span:.1f} us, 99% of warps ended by {t99:.1f} ({(span - t99) / span:.2f} of "
        f"the span after it); the last warp {last} started at {start[last]:.1f} us "
        f"and ran {dur[last]:.1f}{longest}")
    return dict(phases={ph: dict(issues_a_warp=n, simt=e, cycle_share=c)
                        for ph, (n, e, c) in phases.items()},
                warp_us_median=float(np.median(dur)), warp_us_p99=float(np.percentile(dur, 99)),
                warp_us_max=float(dur.max()), block_tail_us_median=float(np.median(tail)),
                block_tail_us_max=float(tail.max()), span_us=span, t99_us=t99,
                last_warp_start_us=float(start[last]), last_warp_us=float(dur[last]))


def probe_idx(shape, rows, dev):
    """The probes' index pattern: (arange * 7919) mod rows, int32."""
    n = shape[0] * shape[1]
    idx = (torch.arange(n, dtype=torch.int64) * 7919) % rows
    return idx.to(torch.int32).reshape(shape).to(dev)


def gather_cases(dev):
    """(what, kernel call, plain call) for every shape of the S3 and S4
    gather probes (scratch/probe_kernel.py p2a-p2d, scratch/probe2.py
    gather_axis0)."""
    i32 = dict(dtype=torch.int32, device=dev)
    t1 = torch.arange(16384, **i32)
    i1 = probe_idx((8, 128), 16384, dev)
    t4 = torch.from_numpy(np.random.default_rng(4).normal(
        size=(4096, 1)).astype(np.float32)).to(dev)
    i4 = probe_idx((8, 128), 4096, dev)
    x = torch.arange(8 * 128, **i32).reshape(8, 128)
    lane = (x * 13) % 128
    cases = [
        ("take_1d int32 table[16384], idx (8,128)",
         lambda: gather.take_1d(t1, i1), lambda: t1[i1.long()]),
        ("take_1d float32 table[16384], idx (8,128)",
         lambda: gather.take_1d(t1.float(), i1), lambda: t1.float()[i1.long()]),
        ("take_onehot float32 table[4096,1], idx (8,128)",
         lambda: gather.take_onehot(t4, i4),
         lambda: gather.onehot_take_plain(t4, i4)),
        ("take_onehot against the gather table[idx]",
         lambda: gather.take_onehot(t4, i4),
         lambda: t4.reshape(-1)[i4.long()]),
        ("take_along_lane int32 x (8,128)",
         lambda: gather.take_along_lane(x, lane),
         lambda: torch.gather(x, 1, lane.long())),
    ]
    for rows, n_idx in ((16384, 8), (8, 8), (16, 16), (32, 32), (64, 64),
                        (256, 256), (1024, 1024)):
        table = torch.arange(rows * 128, **i32).reshape(rows, 128)
        idx = probe_idx((n_idx, 128), rows, dev)
        cases.append((f"take_along0 int32 table ({rows},128), idx ({n_idx},128)",
                      lambda t=table, i=idx: gather.take_along0(t, i),
                      lambda t=table, i=idx: torch.gather(t, 0, i.long())))
    tf = torch.from_numpy(np.random.default_rng(7).random(
        (256, 128), dtype=np.float32)).to(dev)
    idx = probe_idx((256, 128), 256, dev)
    cases.append(("take_along0 float32 table (256,128), idx (256,128)",
                  lambda: gather.take_along0(tf, idx),
                  lambda: torch.gather(tf, 0, idx.long())))
    return cases, (t1, i1), (t4, i4)


def check_grads(got, want, what, rtol=1e-5, atol=1e-7):
    """The three gradients within rtol/atol of the wanted ones; returns the
    largest absolute difference and the largest wanted magnitude."""
    worst = scale = 0.0
    for name, a, b in zip(("albedo", "normal", "density"), got, want):
        if a.shape != b.shape or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{what}: d_{name} has a bad shape or value")
        if not torch.allclose(a, b, rtol=rtol, atol=atol):
            raise AssertionError(
                f"{what}: d_{name} differs by up to {float((a - b).abs().max())}")
        worst = max(worst, float((a - b).abs().max()))
        scale = max(scale, float(b.abs().max()))
    return worst, scale


def builtin_grads(hit_leaf, d, target, params, light):
    """The L2 step's gradients by builtin autograd through plain indexing of
    the hit rays' rows alone: no kernel of the port, no custom backward, no
    running sum. A miss's pixel is the sky whatever the parameters are, so it
    adds a constant to the loss and nothing to a gradient."""
    hit = hit_leaf >= 0
    leaf, sky = hit_leaf[hit].long(), sky_color(d[hit])
    every = torch.ones_like(leaf, dtype=torch.bool)

    def loss(a, n, s):
        img = shade_cuda.shade_rows(a[leaf], n[leaf], s[leaf], every, sky,
                                    light, 1.3, 0.08)
        return torch.sum((img - target[hit]) ** 2) / target.numel()
    return diff._value_and_grads(loss, *params)[1]


def serial_scatter_add(hit_leaf, cot, n_leaves):
    """The float32 scatter-add of the hit rays' rows in ray order, one after
    another, on the host (numpy's unbuffered add.at)."""
    leaf = hit_leaf.cpu().numpy()
    hit = leaf >= 0
    out = np.zeros((n_leaves, 7), np.float32)
    np.add.at(out, np.minimum(leaf[hit], n_leaves - 1), cot.cpu().numpy()[hit])
    return out


def join7(grads):
    """(g_albedo, g_normal, g_density) as one (n_leaves, 7) tensor."""
    return torch.cat([grads[0], grads[1], grads[2][:, None]], dim=1)


def check_segment_sum(what, cot, hit_leaf, n_leaves):
    """The sort-free segment sum held bitwise, the sign of zero included,
    against the serial float32 scatter-add in ray order on the host, against
    the sorted form, and against itself over two runs. Returns the sums as
    one (n_leaves, 7) tensor, and the largest absolute difference from the
    serial sums of the sort-free and of the sorted form (0.0 when exact)."""
    sums = join7(shade_cuda.segment_sum(cot, hit_leaf, n_leaves))
    again = join7(shade_cuda.segment_sum(cot, hit_leaf, n_leaves))
    by_sort = join7(shade_cuda.segment_sum_sorted(
        cot, *shade_cuda.sort_by_leaf(hit_leaf, n_leaves), n_leaves))
    torch.cuda.synchronize()
    serial = torch.from_numpy(
        serial_scatter_add(hit_leaf, cot, n_leaves)).to(cot.device)
    e_new = compare_tensors((sums,), (serial,), ("sums",),
                            f"segment_sum, {what}, against the serial scatter-add")
    e_sorted = compare_tensors(
        (by_sort,), (serial,), ("sums",),
        f"segment_sum_sorted, {what}, against the serial scatter-add")
    compare_tensors((sums,), (by_sort,), ("sums",),
                    f"segment_sum, {what}, against the sorted form")
    compare_tensors((again,), (sums,), ("sums",), f"segment_sum, {what}, run twice")
    return sums, e_new, e_sorted


def check_bwd_forms(cot, args, what):
    """`cot` (shade_bwd's) bitwise against shade_bwd_serial on `args`;
    returns the first form's cot."""
    first = shade_cuda.shade_bwd_serial(*args)
    torch.cuda.synchronize()
    compare_tensors((cot,), (first,), ("cot",), f"{what}, against the first form")
    return first


# The tile frame's host work in groups: the functions of the tile trace and of
# the frame that hold its eager tensor ops, from the innermost out. An op
# counts for the innermost group that it runs in.
HOST_GROUPS = (
    ("phase 1 (tile._candidates)", tile, "_candidates"),
    ("walk launch, ray set-up, unresolved mask (tile._walk_tiles_chunk)", tile,
     "_walk_tiles_chunk"),
    ("tile selection (tile._unresolved_first)", tile, "_unresolved_first"),
    ("sub-tile split (tile._subtile_split)", tile, "_subtile_split"),
    ("sub-tile merge (tile._subtile_merge)", tile, "_subtile_merge"),
    ("the rest of the fallbacks: gathers, substitution (tile._trace_tile_fb)",
     tile, "_trace_tile_fb"),
    ("argument checks (tile.trace_tile_fb)", tile, "trace_tile_fb"),
    ("shading (diff.shade_diff)", diff, "shade_diff"),
    ("loss (diff.l2_loss_tile)", diff, "l2_loss_tile"),
)


def host_groups(fn):
    """One fn() on the host's clock, the functions of HOST_GROUPS wrapped in
    profiler ranges: group -> (top-level aten ops, their host us), where
    an op is top-level if no other aten op called it, and ops outside every
    group (autograd's backward, the residual count) count as "other"."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    saved = []
    for label, mod, name in HOST_GROUPS:
        orig = getattr(mod, name)

        def ranged(*args, _orig=orig, _label=label, **kw):
            with record_function(_label):
                return _orig(*args, **kw)
        saved.append((mod, name, orig))
        setattr(mod, name, ranged)
    try:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)
    labels = {label for label, _m, _n in HOST_GROUPS}
    out = {}
    for e in prof.events():
        if not e.name.startswith("aten::"):
            continue
        up = e.cpu_parent
        if up is not None and up.name.startswith("aten::"):
            continue
        while up is not None and up.name not in labels:
            up = up.cpu_parent
        group = up.name if up is not None else "other"
        ops, us = out.get(group, (0, 0.0))
        out[group] = (ops + 1, us + e.cpu_time_total)
    return out


def us_or(v):
    """A time in us for a line, or "not measured" where the tracer saw none."""
    return "not measured" if v is None else f"{v:.2f}"


def kernel_us(rows, *parts):
    """For each of `parts`, us a launch of the kernel whose name holds it,
    from a profile pass's rows; None where the tracer saw none."""
    return tuple(next((v for k, v in rows.items() if part in k), None)
                 for part in parts)


def host_us(fn, calls=3000):
    """Microseconds of the host's clock for one call of fn(), over `calls`
    calls issued back to back without waiting for the card."""
    for _ in range(200):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def rowread_rows_old_path(table, idx):
    """``rowread.rowread_rows`` as every wrapper's launch path stood before
    ``_launch.py``, kept here only to time the two paths side by side in one
    run: a check a tensor, the library looked up on every call, a device
    context around the call, a ``torch.cuda.Stream`` object built to read
    its handle."""
    def check(name, t, dtype, shape, device):
        if (t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape)
                or not t.is_contiguous()):
            raise ValueError(name)
    device = table.device
    if device.type != "cuda" or table.dim() != 2 or table.numel() == 0:
        raise ValueError("table")
    check("table", table, torch.int32, table.shape, device)
    rows, cols = table.shape
    n_idx = idx.numel()
    check("indices", idx, torch.int32, (n_idx,), device)

    from raytracingtest_tpu_torch._build import tile_lib

    lib = tile_lib()
    out = torch.empty((n_idx, cols), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        err = lib.rowread(
            table.data_ptr(), rows, cols, rowread.MODE_ROWS, None, 0,
            idx.data_ptr(), n_idx, out.data_ptr(), n_idx,
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rowread launch failed: cudaError {err}")
    return out


# ---- the loop probe's two forms and take's launch path (also run alone by
# gather_probe.py) ----------------------------------------------------------

# a step of the loop probe: its issue slots (multiply, add, floor or the
# ranged form's 0 or 1, subtract; --fmad=false keeps the first two apart) and
# the shortest dependent chain that keeps its bits (multiply, add, subtract),
# each link at the FP32 pipe's latency in cycles
LOOP_STEP_ISSUES = 4
LOOP_STEP_CHAIN = 3
FP32_LATENCY_CYCLES = 4
H100_SMS, FP32_LANES_AN_SM = 132, 128
# the timed cases: (trips, gather rows) of the float loop at 8 steps a trip,
# and "int", the integer loop's 256 trips over 16,384 rows
LOOP_TIMED = ((64, 0), (2048, 0), (64, 512), (2048, 512), "int")


def outside_unit(shape, seed):
    """float32 values that leave [0, 1]: negative, at and past 2**23, -0.0,
    NaN, +-inf, the largest and overflowing, tiny, just below 1 and around
    the ranged form's wrap, the rest over twelve decades of both signs."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 10.0 ** rng.uniform(-3, 9, shape)).astype(np.float32)
    special = np.array([-3.7, -0.0, 0.0, 2**23, 2**23 + 1, 2**24 + 3, 3.4e38, -3.4e38,
                        1e-40, -1e-10, np.nan, np.inf, -np.inf, 1.0, 0.5,
                        np.nextafter(np.float32(1), np.float32(0)), 0.4999995, 0.49999946,
                        -0.5, 12345.678], dtype=np.float32)
    x.reshape(-1)[:special.size] = special
    return x


def loop_inputs(dev):
    """The probes' inputs (the float loop's (512,128) x over [0, 1] and its
    (512,128) table; the integer loop's (8,128) indices and (16384,128)
    table) and ones that leave the ranged form's range: x outside [0, 1], a
    table of large, negative, infinite and NaN words, indices whose x + k
    wraps past 2**31 - 1 or lies below zero, and a table of large and
    negative int32 words whose sums wrap. All from numpy seeds."""
    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    rng = np.random.default_rng(8)
    with np.errstate(over="ignore"):
        far_table = outside_unit((512, 128), 4) * np.float32(1e6)
    idx = probe_idx((8, 128), 16384, dev)
    return dict(
        x=torch.linspace(0, 1, 512 * 128, device=dev).reshape(512, 128),
        table=on(rng.random((512, 128), dtype=np.float32)),
        out_x=on(outside_unit((512, 128), 2)), far_table=on(far_table),
        int_idx=idx,
        int_table=torch.arange(16384 * 128, dtype=torch.int32, device=dev).reshape(16384, 128),
        wrap_idx=torch.cat([2**31 - 1 - probe_idx((4, 128), 300, dev),
                            -probe_idx((4, 128), 2**31 - 1, dev) - 1]),
        words=on(np.random.default_rng(3).integers(-2**31, 2**31, (16384, 128))
                 .astype(np.int32)))


def loop_call(inp, case):
    """The arguments of one loop case for gather.loop_probe and its forms."""
    if case == "int":
        return (inp["int_idx"], inp["int_table"], 256, 0, 16384, gather.LOOP_INT)
    iters, rows = case
    return (inp["x"], inp["table"], iters, 8, rows, gather.LOOP_FLOAT)


def loop_parity(inp, err):
    """The ranged form (loop_probe) and the first form (loop_probe_serial)
    bitwise against loop_probe_plain on the probes' cases and on inputs that
    leave [0, 1]; returns the plain version's ms of each probe case (n=1)."""
    cases = [(str(c), loop_call(inp, c)) for c in LOOP_TIMED]
    x, out_x, table, far = inp["x"], inp["out_x"], inp["table"], inp["far_table"]
    cases += [
        ("x outside [0, 1], 64 trips", (out_x, table, 64, 8, 0, gather.LOOP_FLOAT)),
        ("x outside [0, 1], 64 trips, gather", (out_x, table, 64, 8, 512, gather.LOOP_FLOAT)),
        ("x and the table outside [0, 1], 64 trips, gather",
         (out_x, far, 64, 8, 512, gather.LOOP_FLOAT)),
        ("x outside [0, 1], 3 trips of 5 steps, gather of 4 rows",
         (out_x, far, 3, 5, 4, gather.LOOP_FLOAT)),
        ("x outside [0, 1], 1 trip of 1 step", (out_x, None, 1, 1, 0, gather.LOOP_FLOAT)),
        ("x in [0, 1], 7 trips of 13 steps", (x, None, 7, 13, 0, gather.LOOP_FLOAT)),
        ("the table outside [0, 1], gathers only", (x, far, 9, 0, 512, gather.LOOP_FLOAT)),
        ("int: x + k wrapping, words whose sums wrap",
         (inp["wrap_idx"], inp["words"], 256, 0, 16384, gather.LOOP_INT)),
        ("int: 13 trips, a modulus past the table's rows",
         (inp["wrap_idx"], inp["words"][:100], 13, 0, 300, gather.LOOP_INT)),
    ]
    plain_ms, nans = {}, {}
    for what, args in cases:
        got = gather.loop_probe(*args)
        first = gather.loop_probe_serial(*args)
        nans[what] = int(torch.isnan(got).sum()) if got.is_floating_point() else 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = gather.loop_probe_plain(*args)
        torch.cuda.synchronize()
        plain_ms[what] = (time.perf_counter() - t0) * 1e3
        err["loop_probe"] = max(err["loop_probe"], compare_tensors(
            (got,), (want,), ("x",), f"loop_probe, {what}"))
        err["loop_probe_serial"] = max(err["loop_probe_serial"], compare_tensors(
            (first,), (want,), ("x",), f"loop_probe_serial, {what}"))
    say(f"[parity] loop_probe (the ranged form) and loop_probe_serial (its first "
        f"form) == loop_probe_plain bitwise on {len(cases)} cases: float mode "
        f"(512,128) at 64 and 2048 trips of 8 steps without and with a 512-row "
        f"gather; integer mode (8,128) summing 256 gathered rows of a "
        f"(16384,128) table; x outside [0, 1] (negative, 2**23 and past, -0.0, "
        f"NaN, +-inf, overflowing, just below 1, around the wrap), a table of "
        f"large, negative, infinite and NaN words ({max(nans.values())} NaN "
        f"results at most), ragged "
        f"trips and steps; integer indices wrapping past 2**31 - 1 and below "
        f"zero, and sums that wrap")
    return {c: plain_ms[str(c)] for c in LOOP_TIMED}


def loop_variants(inp):
    """name -> a call of each form on each timed case."""
    out = {}
    for case in LOOP_TIMED:
        args = loop_call(inp, case)
        out[f"loop {case}"] = lambda a=args: gather.loop_probe(*a)
        out[f"loop_serial {case}"] = lambda a=args: gather.loop_probe_serial(*a)
    return out


def sm_clock_mhz(fn, calls):
    """(SM clock, its maximum) in MHz as nvidia-smi reads them while `calls`
    calls of fn() keep the card busy."""
    torch.cuda.synchronize()
    for _ in range(calls):
        fn()
    read = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout
    torch.cuda.synchronize()
    now, peak = (float(v) for v in read.split(","))
    return now, peak


def loop_floors(n, trips, elem, clock_mhz):
    """The float loop's least time without a gather: the issue floor (every
    step's LOOP_STEP_ISSUES instructions at FP32_LANES_AN_SM lanes a cycle on
    every SM) and the latency floor (every trip's steps, one after another,
    LOOP_STEP_CHAIN links of FP32_LATENCY_CYCLES each), in ms at `clock_mhz`;
    and which binds."""
    hz = clock_mhz * 1e6
    issue = n * trips * elem * LOOP_STEP_ISSUES / (H100_SMS * FP32_LANES_AN_SM * hz) * 1e3
    latency = trips * elem * LOOP_STEP_CHAIN * FP32_LATENCY_CYCLES / hz * 1e3
    return dict(issue_ms=issue, latency_ms=latency, bound_ms=max(issue, latency),
                binds="issue" if issue >= latency else "latency")


class CtypesKernel:
    """``_launch.Kernel``'s call as it stood before the launcher, kept here
    only to time both paths in one run: the ctypes function itself, the
    current device through ``torch.cuda.current_device``."""

    def __init__(self, cfn):
        self._fn = cfn
        self._raw_stream = torch._C._cuda_getCurrentRawStream
        self._current_device = torch.cuda.current_device

    def __call__(self, device, *args):
        index = device.index
        if index == self._current_device():
            err = self._fn(*args, self._raw_stream(index))
        else:
            with torch.cuda.device(index):
                err = self._fn(*args, self._raw_stream(index))
        if err != 0:
            raise RuntimeError(f"take launch failed: cudaError {err}")


OLD_TAKE = {}
OLD_LAUNCHES = {"take": 0}


def take_guards_old(table, idx):
    """The guards of ``gather._take_kernel`` before this form, 1-D mode."""
    if table.dtype not in (torch.float32, torch.int32) or table.numel() == 0:
        raise ValueError("table")
    if table.dim() != 1:
        raise ValueError("table")
    return table.shape[0], 1


def take_1d_old_path(table, idx):
    """``gather.take_1d`` as it stood before this form, kept here only to
    time both paths in one run: the guards, ``Kernel.check`` of the table
    against its own dtype and shape, ``torch.empty`` with the device, and the
    ctypes call through the earlier ``Kernel.__call__``."""
    if table.device.type == "cpu":
        raise ValueError("a CPU table")
    device = table.device
    if table.dtype not in (torch.float32, torch.int32) or table.numel() == 0:
        raise ValueError("table")
    gather._TAKE.check(device, (("table", table, table.dtype, table.shape),
                                ("indices", idx, torch.int32, idx.shape)))
    if table.dim() != 1:
        raise ValueError("table")
    rows, cols = table.shape[0], 1
    out = torch.empty(idx.shape, dtype=table.dtype, device=device)
    kernel = OLD_TAKE.get("kernel") or OLD_TAKE.setdefault(
        "kernel", CtypesKernel(_build.shade_lib().take))
    kernel(device, table.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.numel(),
           rows, cols, gather.TAKE_1D)
    OLD_LAUNCHES["take"] += 1
    return out


def host_parts(parts, calls=3000, rounds=3):
    """name -> the median over `rounds` of host_us(fn, calls), every round
    timing each part in turn (the host's mood lasts longer than one part)."""
    samples = {name: [] for name in parts}
    for _ in range(rounds):
        for name, fn in parts.items():
            samples[name].append(host_us(fn, calls))
    return {name: float(np.median(v)) for name, v in samples.items()}


def host_us_alone(fn, calls=200):
    """Median host us of one call of fn() issued to an idle card: for a
    wrapper whose kernel outlasts its launch, where calls back to back would
    wait on a full queue."""
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return float(np.median(times)) * 1e6


def take_parts(dev, table, idx):
    """take_1d's launch path on (table, idx), part by part, before and now,
    and index_select beside them: host us a call (host_parts)."""
    gather.take_1d(table, idx)
    take_1d_old_path(table, idx)
    kernel, old = gather._TAKE, OLD_TAKE["kernel"]
    specs = (("table", table, table.dtype, table.shape),
             ("indices", idx, torch.int32, idx.shape))
    out = torch.empty_like(idx, dtype=table.dtype)
    args = (table.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.numel(),
            table.shape[0], 1, gather.TAKE_1D)
    raw, flat = torch._C._cuda_getCurrentRawStream, idx.reshape(-1)

    def count():
        OLD_LAUNCHES["take"] += 1
    return host_parts({
        "an empty call": lambda: None,
        "guards (before)": lambda: take_guards_old(table, idx),
        "guards (now)": lambda: gather._take_guards(table, idx, gather.TAKE_1D),
        "Kernel.check": lambda: kernel.check(dev, specs),
        "torch.empty (before)": lambda: torch.empty(idx.shape, dtype=table.dtype, device=dev),
        "Tensor.new_empty": lambda: idx.new_empty(idx.shape, dtype=table.dtype),
        "torch.empty_like (now)": lambda: torch.empty_like(idx, dtype=table.dtype),
        "three data_ptr reads": lambda: (table.data_ptr(), idx.data_ptr(), out.data_ptr()),
        "current_device (before)": torch.cuda.current_device,
        "_cuda_getDevice (now)": torch._C._cuda_getDevice,
        "raw stream": lambda: raw(0),
        "ctypes call (before)": lambda: old._fn(*args, raw(0)),
        "launcher call (now)": lambda: kernel._fn(*args, raw(0)),
        "Kernel call (before)": lambda: old(dev, *args),
        "Kernel call (now)": lambda: kernel(dev, *args),
        "launches counter": count,
        "take_1d (before)": lambda: take_1d_old_path(table, idx),
        "take_1d (now)": lambda: gather.take_1d(table, idx),
        "index_select": lambda: torch.index_select(table, 0, flat),
    })


def dda_inputs(n, seed, dev):
    """Pre-staged brick-DDA state with the distributions of
    scratch/r4_pallas2.py::make_inputs, made with numpy from a seed."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    host = (
        (1.0 + rng.random((n, 3), dtype=f32) * f32(0.9)).astype(f32),   # bpos
        rng.random(n, dtype=f32),                                       # t_cur
        (rng.random(n) < 0.7).astype(np.int32),                         # walking
        rng.integers(0, 2 ** 31 - 1, (16, n), dtype=np.int64).astype(np.int32),
        (-1.0 - rng.random((n, 3), dtype=f32)).astype(f32),             # tc
        rng.random((n, 3), dtype=f32),                                  # tb
        (rng.integers(0, 2, (n, 3)) * 7).astype(np.int32),              # flip
        np.full(n, np.inf, f32),                                        # hit_t
    )
    return tuple(torch.from_numpy(a).to(dev) for a in host)


def walk_inputs(ts, o, d, corners, mode):
    """The walker's arguments for one of the frame's three walks over all of
    the given tiles: the main walk, the enlarged-K re-walk, or the 2x2
    sub-tile re-walk (64 rays a block)."""
    td, k, fb_k = ts.top_depth, TILE_BUDGETS["k_max"], TILE_BUDGETS["fb_k"]
    if mode == "main":
        caps, k_max = tile._default_caps(td, k), k
    elif mode == "enlarged-K":
        caps, k_max = tuple(min(fb_k, 8 ** l) for l in range(td + 1)), fb_k
    else:
        o, d, corners = tile._subtile_split(o, d, corners, 2)
        o, d = o.contiguous(), d.contiguous()
        caps, k_max = tile._fb2_caps(td, fb_k), fb_k
    codes, ids, t_codes, _drop = tile._candidates(
        ts.pyr, ts.cellmap, corners, o[0, 0], td, caps, k_max)
    return (ts.bsvo.bricks, o, d, codes, ids, t_codes, ts.depth, td)


WALK_NAMES = ("hit_leaf", "hit_t", "iters")
CAND_NAMES = ("codes", "ids", "t_codes", "drop_t")
CAND_CALLS = ("main", "enlarged-K", "sub-tile")
# the small cases' budgets that make levels overflow their widths
NARROW = ("narrow", "narrow top")


def check_candidates(args, what):
    """tile_candidates (at the rule's warps a tile and at each of them), the
    radix form unmapped and both forms in the brickmap mode (on a seeded
    permutation of the bricks) at each, and the first form,
    tile_candidates_block, each bitwise against candidates_plain (+
    remap_ids) on the card (codes, ids, t_codes and drop_t bits). Returns
    the largest float differences (0.0 when exact) by kernel name and the
    number of valid candidates."""
    td = args[4]
    brickmap = torch.randperm(8 ** td, generator=torch.Generator().manual_seed(td)).to(
        device=args[2].device, dtype=torch.int32)
    kern = tile_cuda.candidates(*args)
    runs = {(name, w): tile_cuda.candidates(*args, warps=w, form=form, **kw)
            for name, form, kw in (
                ("tile_candidates", "first", {}), ("tile_candidates_radix", "radix", {}),
                ("tile_candidates_mapped", "radix", dict(brickmap=brickmap)),
                ("tile_candidates_mapped_first", "first", dict(brickmap=brickmap)))
            for w in tile_cuda.CANDIDATE_WARPS}
    first = tile_cuda.candidates_block(*args)
    plain = tile.candidates_plain(*args)
    mapped = (plain[0], tile.remap_ids(plain[1], brickmap), plain[2], plain[3])
    torch.cuda.synchronize()
    errs = dict(tile_candidates=compare_tensors(kern, plain, CAND_NAMES, what),
                tile_candidates_block=compare_tensors(first, plain, CAND_NAMES,
                                                      f"{what}, first form"))
    for (name, w), got in runs.items():
        errs[name] = max(errs.get(name, 0.0), compare_tensors(
            got, mapped if "mapped" in name else plain, CAND_NAMES,
            f"{what}, {name}, {w} warps a tile"))
    return errs, int((kern[1] >= 0).sum())


def candidate_cases(dev, small_cam, inside_cam, horizon_cam):
    """(what, tile_candidates arguments) of the small cases: the tests'
    budgets (tiny, default, wide), bench.py's, the sub-tile pass's on 2x2
    sub-tile corners, the trainer's fb_k = 256, shallow trees whose lists are
    shorter than k_max, a camera inside the solid, the empty scene, and the
    cases of the selection: narrow intermediate levels that overflow in
    many tiles ("narrow"), a finest level that overflows ("narrow top"), and
    a camera on the horizon, whose upper tiles see nothing and whose lower
    ones overflow bench.py's budgets."""
    def budgets(td):
        return {
            "tiny": ((1, 2, 2, 2), 2), "default": (tile._default_caps(td, 48), 48),
            "wide": (tuple(min(160, 8 ** l) for l in range(td + 1)), 160),
            "bench": (tile._default_caps(td, 96), 96),
            "fb2": (tile._fb2_caps(td, 160), 160),
            "fb_k 256": (tuple(min(256, 8 ** l) for l in range(td + 1)), 256),
            "narrow": ((1, 8) + (3,) * (td - 1), 96),
            "narrow top": (tuple(min(64, 8 ** l) for l in range(td + 1)), 40)}
    empty = Scene("empty", lambda x, y, z: np.ones_like(np.asarray(x, np.float32)), 0.0)
    cases = []
    for name, depth, cam, which in (
            ("terrain", 6, small_cam, None), ("terrain", 7, small_cam, None),
            ("flat_ground", 6, small_cam, None), ("sphere", 5, small_cam, None),
            ("flat_ground", 4, small_cam, None),
            ("terrain", 6, inside_cam, ("default", "fb_k 256")),
            ("empty", 4, small_cam, ("default",)),
            ("terrain", 7, small_cam, NARROW),
            ("terrain", 7, horizon_cam, ("bench",) + NARROW)):
        scene = empty if name == "empty" else get_scene(name)
        ts = tile.make_tile_svo(octree.build_svo(scene, depth).svo).to(dev)
        o, d, corners, _grid = tile.tile_rays(cam, dev)
        sub = tile._subtile_split(o, d, corners, 2)[2].contiguous()
        where = ("inside the solid" if cam is inside_cam else
                 "on the horizon" if cam is horizon_cam else "bench camera")
        for b, (caps, k_max) in budgets(ts.top_depth).items():
            if (which is None and b not in NARROW) or (which and b in which):
                c = sub if b == "fb2" else corners
                cases.append((f"{name} d{depth} {where} {b}",
                              (ts.pyr, ts.cellmap, c, o[0, 0], ts.top_depth,
                               caps, k_max)))
    return cases


def candidate_work(args):
    """(bytes, operations) that phase 1 on these arguments needs, counted from
    this run's data: each tile's corners and the apex read once, one pyramid
    word for each kept cell of a level above the finest, one cellmap row for
    each valid candidate, the outputs written once; the occupancy test of
    every child slot of a kept cell, and the cull and key of every occupied
    child. The sort's comparisons are not counted: the function needs the
    smallest `width` keys of a level, which a selection finds without a full
    sort, so they are this implementation's cost, not the work's. A level's
    kept cells are the valid codes of the kernel stopped at that level."""
    pyr, cellmap, corners, apex, td, caps, k_max = args
    widths = tile_cuda.level_widths(td, caps, k_max)
    T = corners.shape[0]
    offs, _ = tile._pyr_layout(td)
    n_words = lambda l: tile._pyr_layout(l)[1]
    codes = torch.zeros((T, 1), dtype=torch.int32, device=corners.device)
    words = slots = occupied = 0
    for l in range(1, td + 1):
        if l > 1:
            codes = tile_cuda.candidates(
                pyr[:n_words(l - 1)], cellmap[:max(1, 8 ** (l - 1) // 32)],
                corners, apex, l - 1, caps, widths[l - 1])[0]
        valid = codes >= 0
        safe = torch.where(valid, codes, 0)
        word = pyr[(offs[l] + (safe >> 2)).long()]
        eight = (word >> ((safe & 3) << 3)) & 0xFF
        words += int(valid.sum())
        slots += 8 * int(valid.sum())
        occupied += int(torch.where(valid, tile._popcount32(eight), 0).sum())
    final = tile_cuda.candidates(*args)
    n_bytes = (nbytes(corners, apex) + words * 4 + int((final[1] >= 0).sum()) * 8
               + nbytes(*final))
    return n_bytes, slots * OPS_CAND_SLOT + occupied * OPS_CAND_CHILD, widths


def level_counts(args):
    """(T, top_depth) int64: for each tile and each level 1..top_depth, the
    valid (non-sentinel) keys phase 1 sees at that level before it keeps
    `width` of them, and the static widths. Counted by the plain version
    stopped at each level with room for every child of the kept cells
    there, so that nothing at that level is dropped."""
    pyr, cellmap, corners, apex, td, caps, k_max = args
    widths = tile_cuda.level_widths(td, caps, k_max)
    cols = [(tile.candidates_plain(pyr, cellmap, corners, apex, l, caps,
                                   8 * widths[l - 1])[0] >= 0).sum(dim=1)
            for l in range(1, td + 1)]
    return torch.stack(cols, dim=1), widths


def work_line(cname, args):
    """The [work] text of one phase-1 call: per level, the mean and the
    largest count of valid keys a tile, the width, and the tiles whose
    count is above the width."""
    counts, widths = level_counts(args)
    counts = counts.float()
    parts = [f"l{l} {float(counts[:, l - 1].mean()):.2f}/"
             f"{int(counts[:, l - 1].max())} of {widths[l]} "
             f"({int((counts[:, l - 1] > widths[l]).sum())} over)"
             for l in range(1, len(widths))]
    return (f"{cname} T={counts.shape[0]} K={args[6]}, "
            f"{int((counts[:, -1] == 0).sum())} tiles see nothing: "
            + ", ".join(parts))


def check_walk(args, what):
    """tile_walk at the rule's G and at every G, and its first form, each
    bitwise against the plain walk. Returns the largest float differences
    of the new and of the first form (0.0 when exact), the rule's G, and the
    hit count."""
    plain = tile.walk_plain(*args)
    first = tile_cuda._walk_serial_kernel(*args)
    kern = tile_cuda._walk_kernel(*args)
    every = [tile_cuda._walk_kernel(*args, lanes=g) for g in tile_cuda.LANES]
    torch.cuda.synchronize()
    e_new = compare_tensors(kern, plain, WALK_NAMES, what)
    e_first = compare_tensors(first, plain, WALK_NAMES, f"{what}, first form")
    for g, got in zip(tile_cuda.LANES, every):
        e_new = max(e_new, compare_tensors(got, plain, WALK_NAMES, f"{what}, G={g}"))
    T, P = args[1].shape[0], args[1].shape[1]
    g = tile_cuda.lanes_per_ray(T, P, tile_cuda.thread_slots(args[1].device))
    return e_new, e_first, g, int((kern[0] >= 0).sum())


def walk_shape(args):
    """(G, blocks, threads a block) of a tile_walk launch at the rule's G,
    as the C launcher computes them."""
    T, P = args[1].shape[0], args[1].shape[1]
    g = tile_cuda.lanes_per_ray(T, P, tile_cuda.thread_slots(args[1].device))
    per_block = min(P, 256 // g)
    return g, T * -(-P // per_block), per_block * g


def walk_bound(args, iters):
    """A walk launch's own bound: its rays' bytes (24 B in, 12 B out a ray),
    its lists (12 B a candidate slot) and its valid candidates' 17-word rows
    read once, against the DDA steps its rays took and their set-up."""
    o, d, codes, ids, t_codes = args[1], args[2], args[3], args[4], args[5]
    n_rays = o.shape[0] * o.shape[1]
    n_bytes = (nbytes(o, d, codes, ids, t_codes) + int((ids >= 0).sum()) * 68
               + n_rays * 12)
    return bound(n_bytes, int(iters.sum()) * OPS_DDA_STEP + n_rays * OPS_RAY_SETUP)

# The referee's tolerances, in units of t (a depth-10 voxel is 9.8e-4 wide):
# a chord shorter than GRAZE is a graze of a corner or an edge, which float32
# paths may count or not; more rays than MAX_DIFFER apart is a fault outright.
GRAZE = 1e-5
MAX_DIFFER = 64
# two walks to the same voxel may differ in hit_t by a few ULP (t is about 1)
HIT_T_ATOL = 1e-6


def leaf_voxels(ts):
    """Integer voxel coordinates (n_leaves, 3) of every leaf, in leaf order,
    read back from the tile SVO on the host: finest pyramid cells in morton
    order are the bricks, and a brick's set bits in hierarchical-morton order
    are its leaves."""
    td = ts.top_depth
    offs, _ = tile._pyr_layout(td)
    pyr = ts.pyr.cpu().numpy().view(np.uint32)[offs[td]:]
    shifts = np.arange(32, dtype=np.uint32)
    cells = np.flatnonzero(((pyr[:, None] >> shifts) & 1).reshape(-1))
    bricks = ts.bsvo.bricks.cpu().numpy().view(np.uint32)[:, :16]
    brick, bit = np.nonzero(((bricks[:, :, None] >> shifts) & 1).reshape(-1, 512))
    axis = lambda a: ((((bit >> (6 + a)) & 1) << 2) | (((bit >> (3 + a)) & 1) << 1)
                      | ((bit >> a) & 1))
    return np.stack([c[brick] * 8 + axis(a)
                     for a, c in enumerate(tile.unmorton3(cells))], axis=1)


def referee(voxels, depth, o, d, answers):
    """Judge hit leaves in float64 against every leaf voxel. For each ray
    (o, d float32 (n,3)) the truth is the first voxel the ray crosses with a
    chord longer than GRAZE. An answer (a leaf id, or -1 for a miss) is
    acceptable if it is that voxel, or a voxel the ray grazes (chord within
    GRAZE of zero, either side) no later than that voxel; a miss is
    acceptable when the ray crosses nothing. `answers`: dict name ->
    int array (n,). Returns dict name -> bool array (n,)."""
    size = 2.0 ** -depth
    lo = voxels * size
    verdict = {name: np.zeros(len(o), bool) for name in answers}
    for r in range(len(o)):
        with np.errstate(divide="ignore", invalid="ignore"):
            t1 = (lo - o[r].astype(np.float64)) / d[r].astype(np.float64)
            t2 = (lo + size - o[r].astype(np.float64)) / d[r].astype(np.float64)
        t_in = np.minimum(t1, t2).max(axis=1)
        t_out = np.maximum(t1, t2).min(axis=1)
        chord = t_out - t_in
        solid = (chord > GRAZE) & (t_out > 0)
        first = np.where(solid, t_in, np.inf).argmin() if solid.any() else -1
        limit = t_in[first] + GRAZE if first >= 0 else np.inf
        for name, ans in answers.items():
            a = int(ans[r])
            if a < 0:
                verdict[name][r] = first < 0
            else:
                verdict[name][r] = a == first or (
                    abs(chord[a]) <= GRAZE and t_in[a] <= limit)
    return verdict


BUILD_KERNELS = ("svo_columns", "svo_expand", "svo_compact", "svo_leaves", "svo_leaf_attrs",
                 "svo_level_pass")
# the first forms of phases C and D, which the level pass replaced on the
# build's path: launched in checks and timings only
BUILD_FIRST_FORMS = ("svo_level_up", "svo_parent_ptr")
# each builder entry's kernels as torch.profiler names them (svo_leaves:
# the neighbour table, the test and the needy list's evaluations); the leaf
# test's first form
BUILD_PROFILED = {"svo_columns": ("svo_columns_kernel",),
                  "svo_expand": ("svo_expand_columns_kernel", "svo_expand_kernel"),
                  "svo_compact": ("svo_compact_kernel", "svo_count_kernel"),
                  "svo_leaves": ("svo_leaf_neighbours_kernel", "svo_leaf_test_kernel",
                                 "svo_leaf_eval_kernel"),
                  "svo_leaf_attrs": ("svo_leaf_attrs_kernel",),
                  "svo_level_pass": ("svo_level_pass_kernel",),
                  "svo_level_up": ("svo_level_up_kernel",),
                  "svo_parent_ptr": ("svo_parent_ptr_kernel",),
                  "svo_leaves_serial": ("svo_leaves_kernel",),
                  "svo_expand_serial": ("svo_expand_kernel",)}
# operations of one `terrain` evaluation, counted from csrc/scene.cuh: a
# noise3 is 379 (eight corners of 41: 15 for the hash, 4 for the modulo, 14
# for the gradient's decode, 8 for its dot with the offset; three fades of
# 7, seven lerps of 3, 9 for the floors and conversions), fbm3 two noise3s
# and 7 more an octave, the height 5 more
OPS_TERRAIN_EVAL = 777
OPS_ALBEDO = 70          # the palette: three sinf and their scaling
OPS_EXPAND_CHILD = 12    # a child's coordinates, centre and keep test
# the column form's child: those and its py - h (the scene's `y -`); a
# column's evaluation is OPS_TERRAIN_EVAL
OPS_EXPAND_COLUMN_CHILD = OPS_EXPAND_CHILD + 1
OPS_COMPACT_ROW = 8      # ballot, popc, the warp prefix, the store address
OPS_LEVEL_UP_ROW = 6     # the two atomics' operands
# the level pass's survivor: the suffix OR's three steps (two shuffles, a
# compare, an OR), the next row's lane 0 (two shuffles, a compare, an OR),
# the head test (two shuffles, a compare, a ballot, a popc) and its ranks
# (two popcs, two adds, the store addresses)
OPS_LEVEL_PASS_ROW = 12 + 4 + 5 + 6
OPS_PARENT_ROW = 8       # the masks, popc and the stores' loop
# the leaf test's lookups of a solid candidate: the slot, three sibling and
# three table reads' addresses and compares; and a kept parent's six
# galloping searches (some 8 steps of a Morton compare, 12 operations each)
OPS_LEAF_LOOKUP = 40
OPS_LEAF_NEIGHBOURS = 6 * 8 * 12
BUILD_SCENES = ("perlin", "terrain_ref", "simplex_ref")
# the octant of build_svo_device_split(terrain, 10, 2) that [build-device]
# traces by phase: the one with the most nodes (build_phases.py finds it)
PHASE_OCTANT = (2, 1, 3)
BUILD_SCENE_DEPTH = 8


def build_launches(depth, chunks=None, heightfield=True):
    """The launches of a build_svo_device of `depth` levels in which no
    level is empty: a heightfield's column pass, an expansion and its
    compaction a level (more chunks add an expansion and a compaction
    each), one leaf test, its compaction, the leaves' attributes, and one
    level pass a level (phases C and D: no count, no compaction and no
    parent-pointer pass)."""
    extra = 0 if chunks is None else sum(c - 1 for c in chunks)
    return dict(svo_expand=depth + extra, svo_compact=depth + 1 + extra,
                svo_leaves=1, svo_leaf_attrs=1, svo_level_pass=depth,
                **({"svo_columns": depth} if heightfield else {}))


def record_calls():
    """Wrap octree_cuda's builder functions so that each keeps the arguments
    of its largest call (by rows) until restore(); returns (the record,
    restore). A call's record is (rows, args), with its keyword arguments
    as a third item where it has any (the level pass's)."""
    from raytracingtest_tpu_torch.ops import octree_cuda
    names = ("columns", "expand", "compact", "leaves", "leaf_attrs", "level_up")
    saved = {name: getattr(octree_cuda, name) for name in names}
    calls = {}

    def wrap(name, fn):
        def recorded(*args, **kw):
            # columns takes no tensor: its largest call is its finest level's
            rows = args[1] if name == "columns" else next(
                a.shape[0] for a in args if isinstance(a, torch.Tensor))
            # the level pass's bound stays n_leaves for a few levels: keep
            # the first of them, the finest, whose rows are all valid
            held = calls.get(name, (-1,))[0]
            if rows > held or (rows == held and name != "level_up"):
                calls[name] = (rows, args, kw) if kw else (rows, args)
            return fn(*args, **kw)
        return recorded

    for name, fn in saved.items():
        setattr(octree_cuda, name, wrap(name, fn))

    def restore():
        for name, fn in saved.items():
            setattr(octree_cuda, name, fn)
    return calls, restore


def bits_apart(a, b):
    """Float32 values of a and b whose bits differ."""
    return int((bits(a) != bits(b)).sum())


# the albedo's tolerance against the host (sinf on the card, numpy's sin
# there): an ULP of a value in [0.5, 1)
ALBEDO_ULP = 2.0 ** -24


def check_expansion(expand, ds, parents, level, hi, lo, cols, plain):
    """One expansion held bit for bit (records, keep flags, counts) against
    its first form on the card and, with `plain`, its plain version;
    `expand` is the wrapper (octree_cuda.expand). Its row: level, parents,
    the column table's side, and the scene evaluations made (its table's
    columns for a heightfield, one a child for a 3-D scene)."""
    from raytracingtest_tpu_torch.ops import octree_cuda as oc
    got = expand(ds, parents, level, hi, lo, cols)
    against = [("its first form", oc.expand_serial(ds, parents, level, hi, lo))]
    if plain:
        against.append(("its plain version",
                        oc.expand_plain(ds.scene, parents, level, hi, lo)))
    for what, want in against:
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"svo_expand parts from {what} ({ds.scene.name}, level "
                                 f"{level}, {parents.shape[0]} parents)")
    n = 8 * parents.shape[0]
    return dict(level=level, parents=parents.shape[0], children=n,
                side=None if cols is None else cols.side,
                evals=n if cols is None else cols.side ** 2)


@contextlib.contextmanager
def checked_expansions(log, plain=False):
    """Inside the block every expansion of a device build also runs
    check_expansion (its launches count too: no expect_launches inside);
    `log` gains each one's row."""
    from raytracingtest_tpu_torch.ops import octree_cuda as oc
    expand = oc.expand

    def checking(ds, parents, level, hi, lo, cols=None):
        log.append(check_expansion(expand, ds, parents, level, hi, lo, cols, plain))
        return expand(ds, parents, level, hi, lo, cols)
    oc.expand = checking
    try:
        yield log
    finally:
        oc.expand = expand


@contextlib.contextmanager
def first_form_expansions():
    """Inside the block the device build expands through the first form
    (svo_expand_serial, the scene at every child) and makes no column
    table."""
    from raytracingtest_tpu_torch.ops import octree_cuda as oc
    columns, expand = oc.columns, oc.expand
    oc.columns = lambda *a, **k: None
    oc.expand = lambda ds, parents, level, hi, lo, cols=None: oc.expand_serial(
        ds, parents, level, hi, lo)
    try:
        yield
    finally:
        oc.columns, oc.expand = columns, expand


def expansion_us(fn):
    """Device us of each expansion of one fn() (a build), in launch order:
    (the column pass's us, the expansion's us) a level."""
    levels, cols = [], 0.0
    for name, us in launches_of(fn):
        if "svo_column" in name:
            cols += us
        elif "svo_expand" in name:
            levels.append((cols, us))
            cols = 0.0
    return levels


def check_leaf_test(ds, rec, depth, par, parents, full, plain=False, leaves=None):
    """One leaf test held against its first form on the card (survivors,
    counts, and the dense pass's attributes at the leaves' rows, all bit
    for bit) and, with `plain`, against the plain versions (survivors and
    counts bit for bit, normals bit for bit, albedo within ALBEDO_ULP);
    `leaves` is the leaf test's wrapper (octree_cuda.leaves).
    Returns the leaf test's numbers: candidates, solid ones, leaves, the
    evaluations made (the counting form) and the reference's 6 solid + 6
    leaves, and the plain versions' ms."""
    from raytracingtest_tpu_torch.ops import octree_cuda as oc
    leaves = oc.leaves if leaves is None else leaves
    survive, counts, evals = leaves(ds, rec, depth, par, parents, full,
                                    count_evals=True)
    again = leaves(ds, rec, depth, par, parents, full)
    first = oc.leaves_serial(ds, rec, depth)
    if not (torch.equal(survive, first[0]) and torch.equal(counts, first[2])
            and torch.equal(again[0], survive) and torch.equal(again[1], counts)):
        raise AssertionError(f"svo_leaves parts from its first form (depth {depth}, "
                             f"{rec.shape[0]} candidates)")
    rows = torch.nonzero(survive).reshape(-1)
    leaf_rec = rec[rows].contiguous()
    dense = oc.leaf_attrs(ds, leaf_rec, depth)
    if not torch.equal(bits(dense), bits(first[1][rows])):
        raise AssertionError("svo_leaf_attrs parts from the first form's attributes")
    n_solid = int((rec[:, 3].contiguous().view(torch.float32) <= 0).sum())
    out = dict(rows=rec.shape[0], solid=n_solid, leaves=int(rows.numel()), evals=evals,
               ref_evals=6 * n_solid + 6 * int(rows.numel()), albedo_err=0.0,
               normals_apart=0, plain_ms=None, attrs_plain_ms=None)
    if plain:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = oc.leaves_plain(ds.scene, rec, depth, par, parents, full)
        torch.cuda.synchronize()
        out["plain_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        want_a = oc.leaf_attrs_plain(ds.scene, leaf_rec, depth)
        torch.cuda.synchronize()
        out["attrs_plain_ms"] = (time.perf_counter() - t0) * 1e3
        out["normals_apart"] = bits_apart(dense[:, 3:], want_a[:, 3:])
        out["albedo_err"] = (float((dense[:, :3] - want_a[:, :3]).abs().max())
                             if rows.numel() else 0.0)
        if not (torch.equal(survive, want[0]) and torch.equal(counts, want[1])):
            raise AssertionError("svo_leaves parts from its plain version")
        if out["normals_apart"] or out["albedo_err"] > ALBEDO_ULP:
            raise AssertionError(f"svo_leaf_attrs: {out['normals_apart']} normal values' "
                                 f"bits apart, albedo {out['albedo_err']} from the plain "
                                 "version")
    return out


@contextlib.contextmanager
def checked_leaf_tests(log, plain=False):
    """Inside the block every leaf test of a device build also runs
    check_leaf_test (its launches count too: no expect_launches inside);
    `log` gains each one's numbers."""
    from raytracingtest_tpu_torch.ops import octree_cuda as oc
    leaves = oc.leaves

    def checking(ds, rec, depth, par, parents, full, **kw):
        log.append(check_leaf_test(ds, rec, depth, par, parents, full, plain, leaves))
        return leaves(ds, rec, depth, par, parents, full, **kw)
    oc.leaves = checking
    try:
        yield log
    finally:
        oc.leaves = leaves


def check_level_pass(out, rows, code, n_par, n_rows=None, plain=False):
    """One level pass's outputs `out` (octree_cuda.level_up's) held bit for
    bit against the first forms on the card on the same inputs: svo_level_up,
    then svo_compact's count and place modes give the
    surviving parents' masks, first children and indices and their count,
    and each survivor's parent rank is its parent's place among those
    indices; with `plain`, against the plain version too. Returns its row:
    the bound, the valid rows, the surviving parents."""
    from raytracingtest_tpu_torch.ops import octree_cuda as oc
    m = rows.shape[0] if n_rows is None else int(n_rows[0])
    valid = rows[:m].contiguous()
    par, slot = code >> 3, code & 7
    rec, surv = oc.level_up_serial(valid, par, slot, n_par)
    base, n = octree_device._offsets(oc.count(surv))
    below, nodes = oc.compact(surv, base, n, rec)
    c = int(out.count[0])
    what = f"{rows.shape[0]} rows, {m} valid, {n_par} parent candidates"
    if not (c == n and torch.equal(out.masks[:c], nodes[:, 0])
            and torch.equal(out.first[:c], nodes[:, 1]) and torch.equal(out.below[:c], below)):
        raise AssertionError(f"svo_level_pass parts from svo_level_up + svo_compact ({what})")
    if out.ranks is not None:
        want = torch.searchsorted(below, par[valid.long()]).to(torch.int32)
        if not torch.equal(out.ranks[:m], want):
            raise AssertionError(f"svo_level_pass's parent ranks part from the first "
                                 f"forms' ({what})")
    if plain:
        ref = oc.level_pass_plain(rows, code, n_par, n_rows, out.ranks is not None)
        if not (torch.equal(ref.count, out.count) and torch.equal(ref.masks[:c], out.masks[:c])
                and torch.equal(ref.first[:c], out.first[:c])
                and torch.equal(ref.below[:c], out.below[:c])
                and (out.ranks is None or torch.equal(ref.ranks[:m], out.ranks[:m]))):
            raise AssertionError(f"svo_level_pass parts from its plain version ({what})")
    return dict(bound=rows.shape[0], rows=m, parents=c)


@contextlib.contextmanager
def checked_level_passes(log, plain=False):
    """Inside the block every level pass of a device build is held by
    check_level_pass against the first forms (its launches count too: no
    expect_launches inside), and every tree the build returns has the
    parent pointers that svo_parent_ptr (phase D's first form) derives from
    its masks and child bases; `log` gains a list of each build's passes,
    finest first."""
    from raytracingtest_tpu_torch.ops import octree_cuda as oc
    level_up, build = oc.level_up, octree_device.build_svo_device
    passes = []

    def checking(rows, code, n_par, n_rows=None, **kw):
        out = level_up(rows, code, n_par, n_rows, **kw)
        passes.append(check_level_pass(out, rows, code, n_par, n_rows, plain))
        return out

    def building(*a, **kw):
        svo = build(*a, **kw)
        if not torch.equal(svo.parent_ptr, oc.parent_ptr(svo.masks, svo.child_base)):
            raise AssertionError("the level passes' parent pointers part from "
                                 "svo_parent_ptr's")
        log.append(passes[:])
        passes.clear()
        return svo
    oc.level_up, octree_device.build_svo_device = checking, building
    try:
        yield log
    finally:
        oc.level_up, octree_device.build_svo_device = level_up, build


def build_parity(calls, ds, depth, svo):
    """Each builder kernel against its plain version on the inputs of its
    largest call of the depth-`depth` build (the first forms of phases C and
    D on the level pass's and on the built tree `svo`); returns (max abs err
    by kernel, normals apart, ms of the plain version by kernel)."""
    from raytracingtest_tpu_torch.ops import octree_cuda as oc
    err, plain_ms = {}, {}

    def timed_plain(fn, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def exact(name, got, want, what):
        for g, w in zip(got, want):
            if g.dtype != w.dtype or not torch.equal(g, w):
                raise AssertionError(f"{name}: kernel != plain on {what}")

    _, args = calls["columns"]
    got = oc.columns(*args)
    want, plain_ms["svo_columns"] = timed_plain(
        oc.columns_plain, ds.scene, args[1], (got.x0, got.z0, got.side), got.h.device)
    exact("svo_columns", (bits(got.h),), (bits(want.h),), "the column table's bits")
    err["svo_columns"] = 0.0
    _, args = calls["expand"]
    got = oc.expand(*args)
    want, plain_ms["svo_expand"] = timed_plain(oc.expand_plain, ds.scene, *args[1:5])
    exact("svo_expand", got, want, "records, keep flags and counts (f bits)")
    exact("svo_expand", got, oc.expand_serial(*args[:5]),
          "the first form's records, keep flags and counts")
    plain_ms["svo_expand_serial"] = plain_ms["svo_expand"]
    err["svo_expand"] = err["svo_expand_serial"] = 0.0
    _, args = calls["compact"]
    got = oc.compact(*args)
    want, plain_ms["svo_compact"] = timed_plain(oc.compact_plain, *args)
    exact("svo_compact", got, want, "rows and words")
    flags = calls["compact"][1][0]
    exact("svo_compact", (oc.count(flags),), (oc.count_plain(flags),),
          "the count mode's counts")
    err["svo_compact"] = 0.0
    _, args = calls["leaves"]
    first = check_leaf_test(ds, *args[1:], plain=True)
    plain_ms["svo_leaves"] = first["plain_ms"]
    plain_ms["svo_leaf_attrs"] = first["attrs_plain_ms"]
    plain_ms["svo_leaves_serial"] = first["plain_ms"] + first["attrs_plain_ms"]
    err["svo_leaves"] = 0.0
    err["svo_leaf_attrs"] = err["svo_leaves_serial"] = first["albedo_err"]
    normals_apart = first["normals_apart"]
    # the main path's attributes call: the dense pass over the leaves'
    # records that the build compacted
    _, args = calls["leaf_attrs"]
    got_a = oc.leaf_attrs(*args)
    want_a = oc.leaf_attrs_plain(ds.scene, *args[1:])
    if not (torch.equal(bits(got_a[:, 3:]), bits(want_a[:, 3:]))
            and float((got_a[:, :3] - want_a[:, :3]).abs().max()) <= ALBEDO_ULP):
        raise AssertionError("svo_leaf_attrs: the build's call parts from its plain version")
    _, args, kw = calls["level_up"]
    got = oc.level_up(*args, **kw)
    check_level_pass(got, *args)
    want, plain_ms["svo_level_pass"] = timed_plain(oc.level_pass_plain, *args,
                                                   ranks=kw["ranks"])
    c = int(got.count[0])
    exact("svo_level_pass", [t for t in (got.count, got.masks[:c], got.first[:c],
                                         got.below[:c], got.ranks) if t is not None],
          [t for t in (want.count, want.masks[:c], want.first[:c], want.below[:c],
                       want.ranks) if t is not None],
          "counts, masks, first children, parents and parent ranks")
    err["svo_level_pass"] = 0.0
    rows, code, n_par = args[:3]
    par, slot = code >> 3, code & 7
    got = oc.level_up_serial(rows, par, slot, n_par)
    want, plain_ms["svo_level_up"] = timed_plain(oc.level_up_plain, rows, par, slot, n_par)
    exact("svo_level_up", got, want, "masks, first children and survivors")
    err["svo_level_up"] = 0.0
    got = oc.parent_ptr(svo.masks, svo.child_base)
    want, plain_ms["svo_parent_ptr"] = timed_plain(oc.parent_ptr_plain, svo.masks,
                                                   svo.child_base)
    exact("svo_parent_ptr", (got,), (want,), "parent rows")
    err["svo_parent_ptr"] = 0.0
    torch.cuda.synchronize()
    return err, normals_apart, plain_ms, first


def build_bounds(calls, n_leaves, leaf, svo, level_parents):
    """(bound_ms, bound_by) of each builder kernel's largest call, from its
    inputs and outputs: bytes (each read once, each written once) and
    operations (OPS_TERRAIN_EVAL a scene evaluation); `level_parents` is the
    level pass's count of surviving parents at its call."""
    from raytracingtest_tpu_torch.ops import octree_cuda as oc
    out = {}
    _, (dsc, parents, _level, _hi, _lo, cols) = calls["expand"]
    n = 8 * parents.shape[0]
    evals = cols.side ** 2
    outputs = n * 17 + oc.n_blocks(n) * 4
    # the column pass: its table; the child pass: its parents, the table
    # and its outputs; the two as one function (the table inside it), and
    # the first form, the scene at every child (the reference's count)
    out["svo_columns"] = bound(evals * 4, evals * OPS_TERRAIN_EVAL)
    out["svo_expand"] = bound(nbytes(parents) + evals * 4 + outputs,
                              n * OPS_EXPAND_COLUMN_CHILD)
    out["svo_expand_function"] = bound(nbytes(parents) + outputs,
                                       evals * OPS_TERRAIN_EVAL + n * OPS_EXPAND_COLUMN_CHILD)
    out["svo_expand_serial"] = bound(nbytes(parents) + outputs,
                                     n * (OPS_TERRAIN_EVAL + OPS_EXPAND_CHILD))
    _, (flags, _base, total, src) = calls["compact"]
    w = 0 if src is None else src.shape[1]
    out["svo_compact"] = bound(nbytes(flags, _base) + total * (1 + 2 * w) * 4,
                               flags.shape[0] * OPS_COMPACT_ROW)
    # the leaf test: the candidates' records and parent rows and the kept
    # parents' records read once, each child record's f word once, the
    # neighbour table written and read, the flags and counts written; its
    # lookups, the parents' searches and the evaluations this run made. Its
    # first form, the reference's count: six evaluations a solid candidate
    # and six more a leaf (its normal), and the palette.
    _, (_dsc, rec, _depth, par, parents, full) = calls["leaves"]
    n, n_par, solid = rec.shape[0], parents.shape[0], leaf["solid"]
    out["svo_leaves"] = bound(
        nbytes(rec, par, parents) + full.shape[0] * 4 + 2 * n_par * 6 * 4 + n
        + oc.n_blocks(n) * 4,
        solid * OPS_LEAF_LOOKUP + n_par * OPS_LEAF_NEIGHBOURS
        + leaf["evals"] * OPS_TERRAIN_EVAL)
    out["svo_leaf_attrs"] = bound(n_leaves * (16 + 24),
                                  n_leaves * (6 * OPS_TERRAIN_EVAL + OPS_ALBEDO))
    out["svo_leaves_serial"] = bound(nbytes(rec) + n * 25 + oc.n_blocks(n) * 4,
                                     (6 * solid + 6 * n_leaves) * OPS_TERRAIN_EVAL
                                     + n_leaves * OPS_ALBEDO)
    # the level pass at its largest call (level 9's): each survivor's row
    # and code (parent * 8 + slot) read once, its parent rank written, and
    # each surviving parent's mask, first child and index written; the first
    # form, each survivor's row, parent and slot, every parent candidate's
    # two words and flag written (its fills), and the count and place passes
    # after it (svo_compact's bound on its flags)
    _, args, kw = calls["level_up"]
    rows, _code, n_par = args[:3]
    m = rows.shape[0]
    heads = level_parents
    out["svo_level_pass"] = bound(m * 8 + m * 4 * kw["ranks"] + heads * 12,
                                  m * OPS_LEVEL_PASS_ROW)
    out["svo_level_up"] = bound(m * 12 + n_par * 9, m * OPS_LEVEL_UP_ROW)
    out["level_up_first_form"] = bound(m * 12 + n_par * 9 + n_par + oc.n_blocks(n_par) * 8
                                       + heads * 12,
                                       m * OPS_LEVEL_UP_ROW + n_par * OPS_COMPACT_ROW)
    masks, cb = svo.masks, svo.child_base
    out["svo_parent_ptr"] = bound(nbytes(masks, cb) + nbytes(masks),
                                  masks.shape[0] * OPS_PARENT_ROW)
    return out, dict(solid=solid, leaves=n_leaves, evals=leaf["evals"],
                     ref_evals=leaf["ref_evals"])


def traced_kernels(fn, runs):
    """The CUDA kernels' rows of torch.profiler's key averages over `runs`
    calls of fn(), after five calls in a warm-up cycle whose events are
    discarded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        prof.step()
    # the cycle's own "ProfilerStep" span is mirrored onto the card's
    # timeline and is no kernel
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and not e.key.startswith("ProfilerStep")]


def dev_us(e):
    """A profiler row's own device microseconds."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def profile_build(fn):
    """us of device time by builder kernel (count mode under svo_compact)
    and in all, and the launches, in one call of fn(); None where the tracer
    saw no kernel."""
    rows = traced_kernels(fn, 1)
    total = sum(dev_us(e) for e in rows)
    if total <= 0.0:
        return None
    by = {k: 0.0 for k in BUILD_KERNELS}
    count = {k: 0 for k in BUILD_KERNELS}
    for e in rows:
        for k in BUILD_KERNELS:
            if any(name in e.key for name in BUILD_PROFILED[k]):
                by[k] += dev_us(e)
                count[k] += e.count
    return dict(us=by, launches=count, total_us=total,
                n_events=sum(e.count for e in rows))


def build_device(ctx, card):
    """[build-device]: bench.py's BENCH_BUILD=device, build_svo_device of
    depth-10 `terrain` on the card, twice, through its six kernels and no
    plain version; its structure against the host build's bit for bit, its
    attributes to 1e-5 / 2e-3, the brick frame over it against the host
    tree's hits; each kernel against its plain version; every level pass
    against the first forms of phases C and D (svo_level_up with svo_compact,
    svo_parent_ptr) on bench.py's build, the nine scenes and the octant
    build; the build traced by phase; the scene library against the host's
    scenes at 2^20 dyadic centres and 2^20 random points each; the octant
    build against the monolithic one; the command line's noise scenes built
    on the card at depth 8."""
    from raytracingtest_tpu_torch.ops import octree_cuda, octree_device
    dev, host_svo = ctx["dev"], ctx["host_svo"]
    depth = host_svo.depth
    scene = get_scene("terrain")
    want = build_launches(depth)

    def build(verbose=False, **kw):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            svo = octree_device.build_svo_device(scene, depth, verbose=verbose,
                                                 device=dev, **kw)
        return svo, out.getvalue()

    calls, restore = record_calls()
    t0 = time.perf_counter()
    (svo, log), got = expect_launches("build_svo_device terrain d10, first call",
                                      lambda: build(verbose=True), want)
    first_s = time.perf_counter() - t0
    restore()
    t0 = time.perf_counter()
    (svo2, log2), _ = expect_launches("build_svo_device terrain d10, second call",
                                      lambda: build(verbose=True), want)
    second_s = time.perf_counter() - t0
    levels = re.findall(r"level (\d+): (\d+) candidates \(([\d.]+)s\)", log2)
    say(f"[build-device] {card}: build_svo_device(terrain, {depth}) on the card: "
        f"first call {first_s:.4f} s, second call {second_s:.4f} s (each "
        f"under expect_launches: {got}, no plain call); second call's levels "
        "(candidates, s to their compaction's count): "
        + ", ".join(f"{l}: {n} ({s})" for l, n, s in levels))

    # the structure against the host-built tree, bit for bit
    host_pptr = torch.from_numpy(octree.compute_parent_ptr(
        host_svo.masks.numpy(), host_svo.child_base.numpy()))
    if svo.level_start != host_svo.level_start:
        raise AssertionError(f"level_start {svo.level_start} != the host's "
                             f"{host_svo.level_start}")
    for name, want_t in (("masks", host_svo.masks), ("child_base", host_svo.child_base),
                         ("leaf_base", host_svo.leaf_base), ("parent_ptr", host_pptr),
                         ("leaf_density", host_svo.leaf_density)):
        if not torch.equal(getattr(svo, name).cpu(), want_t):
            raise AssertionError(f"build_svo_device terrain d10: {name} differs "
                                 f"from the host build")
    for field in dataclasses.fields(svo):
        a, b = getattr(svo, field.name), getattr(svo2, field.name)
        if isinstance(a, torch.Tensor) and not torch.equal(
                bits(a) if a.is_floating_point() else a,
                bits(b) if b.is_floating_point() else b):
            raise AssertionError(f"two device builds of terrain d10 differ in "
                                 f"{field.name}")
    alb_err = float((svo.leaf_albedo.cpu() - host_svo.leaf_albedo).abs().max())
    nrm_err = float((svo.leaf_normal.cpu() - host_svo.leaf_normal).abs().max())
    alb_apart = bits_apart(svo.leaf_albedo.cpu(), host_svo.leaf_albedo)
    nrm_apart = bits_apart(svo.leaf_normal.cpu(), host_svo.leaf_normal)
    if alb_err > 1e-5 or nrm_err > 2e-3:
        raise AssertionError(f"device build attributes off: albedo {alb_err}, "
                             f"normal {nrm_err}")
    say(f"[build-device] terrain d{depth}: {svo.n_nodes} nodes, {svo.n_leaves} leaves; "
        "masks, child_base, leaf_base, parent_ptr, leaf_density and level_start "
        f"== the host build's bit for bit; albedo max abs {alb_err:.3g} "
        f"({alb_apart} of {svo.leaf_albedo.numel()} values' bits apart: sinf), "
        f"normal max abs {nrm_err:.3g} ({nrm_apart} values' bits apart); a "
        "second build == the first bit for bit")

    # the brick frame over the device-built tree
    bsvo_dev = brick.make_brick_svo(svo).to(dev)
    o, d = ctx["o"], ctx["d"]
    res_dev = brick_cuda.trace_brick_cuda(bsvo_dev, o, d)
    res_host = brick_cuda.trace_brick_cuda(ctx["bsvo"], o, d)
    torch.cuda.synchronize()
    if not (torch.equal(res_dev.hit_leaf, res_host.hit_leaf)
            and torch.equal(bits(res_dev.hit_t), bits(res_host.hit_t))):
        raise AssertionError("the brick frame over the device-built tree parts "
                             "from the host tree's")
    img_dev = diff.render_diff_brick(svo.leaf_albedo, svo.leaf_normal,
                                     svo.leaf_density, bsvo_dev, o, d, ctx["light"])
    img_host = diff.render_diff_brick(*ctx["params"], ctx["bsvo"], o, d, ctx["light"])
    img_err = float((img_dev - img_host).abs().max())
    if not bool(torch.isfinite(img_dev).all()) or img_err > 1e-4:
        raise AssertionError(f"the device-built tree's brick frame: max abs {img_err}")
    say(f"[build-device] the brick frame (render_diff_brick, {o.shape[0]} rays) over the "
        f"device-built tree: hit_leaf and hit_t == the host tree's bit for bit "
        f"({int((res_dev.hit_leaf >= 0).sum())} hits); image max abs {img_err:.3g} "
        "from the host tree's (the albedo's ULPs)")

    # every expansion of the build against its first form and its plain
    # version; each level's evaluations, and its expansion's us alone in
    # both forms (one build each, every launch traced)
    exp_log, pass_log = [], []
    with checked_expansions(exp_log, plain=True), \
            checked_level_passes(pass_log, plain=True):
        checked, _ = build()
    if not torch.equal(checked.masks, svo.masks):
        raise AssertionError("the checked build's masks differ")
    new_us = expansion_us(lambda: build())
    with first_form_expansions():
        first_svo, _ = build()
        first_us = expansion_us(lambda: build())
    if not torch.equal(first_svo.masks, svo.masks):
        raise AssertionError("the first form's build differs")
    if not len(new_us) == len(first_us) == len(exp_log):
        raise AssertionError(f"expansions traced: {len(new_us)}, {len(first_us)}, "
                             f"{len(exp_log)} made")
    expansion = [dict(row, columns_us=c, expand_us=e, first_form_us=f)
                 for row, (c, e), (_c, f) in zip(exp_log, new_us, first_us)]
    say(f"[build-device] {card}: svo_expand (the column pass svo_columns, then the "
        f"children) == its first form (svo_expand_serial) and its plain version bit for "
        f"bit on all {len(exp_log)} expansions of terrain d{depth}; a level: parents, "
        "column evaluations (the table's square) against the first form's one a child "
        "(8 n_p), us alone (column pass + children; first form): " + "; ".join(
            f"L{r['level']} {r['parents']}, {r['evals']} ({r['side']}²) against "
            f"{r['children']}, {r['columns_us']:.1f} + "
            f"{r['expand_us']:.1f}; {r['first_form_us']:.1f}" for r in expansion)
        + f"; a build {sum(r['columns_us'] + r['expand_us'] for r in expansion):.1f} us "
        f"against the first form's {sum(r['first_form_us'] for r in expansion):.1f}, "
        f"{sum(r['evals'] for r in expansion)} evaluations against "
        f"{sum(r['children'] for r in expansion)}")

    passes = pass_log[0]
    say(f"[build-device] svo_level_pass == the first forms (svo_level_up, then "
        f"svo_compact's count and place modes; svo_parent_ptr over the assembled tree) and "
        f"its plain version bit for bit on all {len(passes)} levels of terrain d{depth}; "
        "a level (finest first): its bound, valid rows, surviving parents: " + "; ".join(
            f"{r['bound']}, {r['rows']}, {r['parents']}" for r in passes))

    # each kernel against its plain version, at the main path's largest call
    ds = octree_cuda.device_scene(scene, dev)
    k_err, normals_apart, plain_ms, leaf = build_parity(calls, ds, depth, svo)
    ctx["err"].update(k_err)
    sizes = {k: v[0] for k, v in calls.items()}
    say(f"[build-device] the builder's kernels == their plain versions on the card, "
        f"on their largest call of the build (rows: {sizes}): bitwise but "
        f"svo_leaf_attrs' albedo (max abs {k_err['svo_leaf_attrs']:.3g}; "
        f"{normals_apart} normal values' bits apart); svo_leaves and "
        "svo_leaf_attrs == the leaf test's first form (svo_leaves_serial) bit for "
        "bit (flags, counts, attributes at the leaves' rows); plain ms: "
        + ", ".join(f"{k} {v:.1f}" for k, v in plain_ms.items()))

    # what the leaf test's design rests on, at the main path's call: where
    # each probe of a solid candidate finds its value, and the warps the
    # attributes would share with other candidates
    _, (_dsc, rec, _d, par, parents, full) = calls["leaves"]
    _src, kind = octree_cuda.leaf_probe_sources(rec, par, parents, depth)
    solid = rec[:, 3].contiguous().view(torch.float32) <= 0
    ks = kind[solid]
    by_kind = {name: int((ks == k).sum()) for name, k in (
        ("sibling", octree_cuda.SIBLING), ("cousin", octree_cuda.COUSIN),
        ("evaluate", octree_cuda.EVALUATE))}
    survive = octree_cuda.leaves(ds, rec, depth, par, parents, full)[0]
    lanes = torch.zeros(-(-rec.shape[0] // 32) * 32, dtype=torch.bool, device=dev)
    lanes[:rec.shape[0]] = survive.bool()
    leaf_warps = int(lanes.view(-1, 32).any(1).sum())
    leaf.update(probes=6 * leaf["solid"], by_kind=by_kind, warps=lanes.numel() // 32,
                leaf_warps=leaf_warps)
    del _src, kind, ks, lanes
    say(f"[build-device] the leaf test's data (terrain d{depth}): {leaf['rows']} finest "
        f"candidates, {leaf['solid']} solid, {leaf['leaves']} leaves; of the solid "
        f"candidates' {leaf['probes']} probes, {by_kind['sibling']} are a sibling's "
        f"centre, {by_kind['cousin']} the centre of a child of another kept parent, "
        f"{by_kind['evaluate']} covered by no kept parent; scene evaluations made "
        f"{leaf['evals']} (counting form) against the reference's 6 solid + 6 leaves = "
        f"{leaf['ref_evals']}; {leaf_warps} of {leaf['warps']} warps of 32 candidates "
        f"hold a leaf ({32 * leaf_warps} lanes for {leaf['leaves']} leaves in the first "
        "form's one pass)")

    # the leaf test on every scene of the library: at depth 6 against the
    # plain versions and the first form, at depth 8 against the first form;
    # the octant build's 64 leaf tests against the first form
    scene_checks, scene_expansions, scene_passes = {}, {}, {}
    for name in sorted(SCENES):
        for d_, with_plain in ((6, True), (BUILD_SCENE_DEPTH, False)):
            log, elog, plog = [], [], []
            with checked_leaf_tests(log, plain=with_plain), \
                    checked_expansions(elog, plain=True), \
                    checked_level_passes(plog, plain=with_plain):
                octree_device.build_svo_device(get_scene(name), d_, device=dev)
            scene_checks[(name, d_)] = log[0]
            scene_expansions[(name, d_)] = elog
            scene_passes[(name, d_)] = plog[0]
    say("[build-device] svo_leaves and svo_leaf_attrs on the nine scenes == the first "
        "form (and at depth 6 the plain versions; normals bitwise, albedo within "
        f"{ALBEDO_ULP:.3g}): evaluations made against the reference's: " + ", ".join(
            f"{n_} d{d_} {c['evals']}/{c['ref_evals']}"
            for (n_, d_), c in scene_checks.items()))
    say("[build-device] svo_expand on the nine scenes at depths 6 and "
        f"{BUILD_SCENE_DEPTH} == its first form and its plain version bit for bit on "
        "every expansion; expansions, scene evaluations against the first form's "
        "(one a child): " + ", ".join(
            f"{n_} d{d_} {len(e)}, {sum(r['evals'] for r in e)}/"
            f"{sum(r['children'] for r in e)}" for (n_, d_), e in scene_expansions.items()))
    say("[build-device] svo_level_pass on the nine scenes at depths 6 and "
        f"{BUILD_SCENE_DEPTH} == the first forms bit for bit on every level (and at depth 6 "
        "its plain version), the parent pointers == svo_parent_ptr's; passes, nodes: "
        + ", ".join(f"{n_} d{d_} {len(p_)}, {sum(r['parents'] for r in p_)}"
                    for (n_, d_), p_ in scene_passes.items()))

    # the kernels' times: each at its largest call, in turns; the library
    # call beside svo_compact (torch.nonzero of the same flags)
    oc = octree_cuda
    flags, _base, _total, src = calls["compact"][1]
    leaf_args = calls["leaves"][1]

    def phase_b(first_form):
        """The build's phase B: the leaf test, its compaction and the
        leaves' attributes (the first form: its one pass, and the
        compaction of its attributes)."""
        ds_, rec_, d_ = leaf_args[:3]
        if first_form:
            surv, attrs, counts = oc.leaves_serial(ds_, rec_, d_)
            base, tot = octree_device._offsets(counts)
            return oc.compact(surv, base, tot, attrs.view(torch.int32))
        surv, counts = oc.leaves(*leaf_args)
        base, tot = octree_device._offsets(counts)
        return oc.leaf_attrs(ds_, oc.compact(surv, base, tot, rec_)[1], d_)

    def library_compact():
        rows = torch.nonzero(flags).reshape(-1)
        return rows, torch.index_select(src, 0, rows)

    def library_gather():
        rows = torch.nonzero(flags).reshape(-1)
        return rows, src[rows]

    # phases C and D at level 9's call: the level pass; the first form with
    # its fills, count, scan and compaction; the library pairs, the first
    # form's plain body on the card (index_add_ for the masks,
    # scatter_reduce_ for the first children) and traverse.derive_parent_ptr
    lu_args, lu_kw = calls["level_up"][1:]
    rows_c, code_c, n_par_c = lu_args[:3]
    par_c, slot_c = code_c >> 3, code_c & 7

    def level_first_form():
        rec, surv = oc.level_up_serial(rows_c, par_c, slot_c, n_par_c)
        base, n = octree_device._offsets(oc.count(surv))
        return oc.compact(surv, base, n, rec)

    def level_library():
        r = rows_c.long()
        p = par_c[r].long()
        vm = torch.zeros(n_par_c, dtype=torch.int32, device=dev).index_add_(
            0, p, torch.ones_like(r, dtype=torch.int32) << slot_c[r])
        first = torch.full((n_par_c,), oc.BIG, dtype=torch.int32, device=dev).scatter_reduce_(
            0, p, torch.arange(r.shape[0], dtype=torch.int32, device=dev), "amin")
        return vm, first

    lib_vm, lib_first = level_library()
    if not torch.equal(torch.stack([lib_vm, lib_first], 1),
                       oc.level_up_serial(rows_c, par_c, slot_c, n_par_c)[0]):
        raise AssertionError("index_add_ + scatter_reduce_ part from svo_level_up")
    del lib_vm, lib_first
    level_parents = int(oc.level_up(*lu_args, **lu_kw).count[0])
    phase_cd = {
        "svo_level_pass": lambda: oc.level_up(*lu_args, **lu_kw),
        "level_up_first_form": level_first_form,
        "svo_level_up": lambda: oc.level_up_serial(rows_c, par_c, slot_c, n_par_c),
        "svo_parent_ptr": lambda: oc.parent_ptr(svo.masks, svo.child_base),
        "level_up_library": level_library,
        "parent_ptr_library": lambda: traverse.derive_parent_ptr(svo.masks, svo.child_base)}

    col_args, exp_args = calls["columns"][1], calls["expand"][1]
    turns = in_turns({
        "svo_columns": lambda: oc.columns(*col_args),
        "svo_expand": lambda: oc.expand(*exp_args),
        "svo_expand_function": lambda: oc.expand(*exp_args[:5], oc.columns(*col_args)),
        "svo_expand_serial": lambda: oc.expand_serial(*exp_args[:5]),
        "svo_compact": lambda: oc.compact(*calls["compact"][1]),
        "svo_compact_library": lambda: torch.nonzero(flags),
        "svo_compact_library_whole": library_compact,
        "svo_compact_library_gather": library_gather,
        "svo_leaves": lambda: oc.leaves(*leaf_args),
        "svo_leaf_attrs": lambda: oc.leaf_attrs(*calls["leaf_attrs"][1]),
        "svo_leaves_serial": lambda: oc.leaves_serial(*leaf_args[:3]),
        "phase_b": lambda: phase_b(False),
        "phase_b_first_form": lambda: phase_b(True),
        **phase_cd},
        rounds=3, reps=10)
    ms = {k: med_p80(v)[0] for k, v in turns.items()}
    got_rows, got_words = library_compact()
    want_rows, want_words = oc.compact(*calls["compact"][1])
    if not (torch.equal(got_rows.to(torch.int32), want_rows)
            and torch.equal(got_words, want_words)):
        raise AssertionError("torch.nonzero + index_select parts from svo_compact")
    leaf_kernels = [(k.replace("(anonymous namespace)::", "").replace("void ", "")
                     .split("(")[0], us)
                    for k, us in launches_of(lambda: oc.leaves(*leaf_args))
                    if "svo_leaf" in k]
    serial_rows = traced_kernels(lambda: oc.leaves_serial(*leaf_args[:3]), 3)
    serial_us = sum(dev_us(e) for e in serial_rows
                    if BUILD_PROFILED["svo_leaves_serial"][0] in e.key) / 3
    # phases C and D's variants alone: every kernel of a call, its device us
    # (torch.profiler over three calls), and its launches
    # (a variant whose kernels the tracer still lost is not measured: the
    # wrappers raise a launch's errors, and its time in turns stands)
    cd_us = {}
    for k, fn in phase_cd.items():
        row = path_profile(fn)
        if row is None:
            say(f"[build-device] the profiler saw no kernel of {k} in 3, 12 or 48 "
                "calls; not measured")
        cd_us[k] = dict(us=None if row is None else row["us"],
                        launches=None if row is None else row["n"])
    alone = lambda r: ("not measured" if r["us"] is None
                       else f"{r['us']:.1f} ({r['launches']:g})")
    say(f"[build-device] {card}: phases C and D at level 9's call ({rows_c.shape[0]} "
        f"survivors, {n_par_c} parent candidates, {level_parents} surviving parents), "
        "ms in turns, us alone (its kernels' device us in one call, launches): " + ", ".join(
            f"{k} {ms_:.4f}, {alone(cd_us[k])}"
            for k, ms_ in ((k, med_p80(turns[k])[0]) for k in phase_cd))
        + " (level_up_first_form: svo_level_up with its fills, svo_compact's count, "
        "torch.cumsum, the host read and the place pass; level_up_library: "
        "index_add_ and scatter_reduce_, the first form's function; parent_ptr_library: "
        f"traverse.derive_parent_ptr, over the {svo.n_nodes} nodes)")
    bounds, data = build_bounds(calls, svo.n_leaves, leaf, svo, level_parents)
    phases = {}
    for what, fn in (("build", lambda: octree_device.build_svo_device(scene, depth,
                                                                      device=dev)),
                     ("octant", lambda: octree_device.build_svo_device(
                         scene, depth, root_level=2, root_coord=PHASE_OCTANT,
                         device=dev))):
        split_ = build_phases.trace_build(fn)
        phases[what] = build_phases.phase_rows(split_)
        say(f"[build-device] {card}: one {what} traced by phase ("
            + ("terrain d10" if what == "build" else
               f"the octant {PHASE_OCTANT} of build_svo_device_split(terrain, 10, 2)")
            + "; build_phases.py): " + "; ".join(
                f"{p} {us:.1f} us in {n} launches, {cp} copies and sets, {sy} host syncs "
                "(" + ", ".join(f"{k} {u:.1f} ({c})" for k, u, c in named[:8]) + ")"
                for p, (us, n, cp, sy, named) in phases[what].items())
            + "; svo_level_pass each launch, finest level first: " + ", ".join(
                f"{u:.1f}" for u in build_phases.launches_named(split_, "svo_level_pass")))
    prof = profile_build(lambda: octree_device.build_svo_device(scene, depth, device=dev))
    if prof is None:
        say("[build-device] the profiler saw no kernel of the build; not measured")
        prof = dict(us={k: None for k in BUILD_KERNELS}, launches={}, total_us=None,
                    n_events=None)
    else:
        say(f"[build-device] {card}: one build traced: {prof['total_us']:.1f} us of "
            f"kernel time in {prof['n_events']} launches against the second call's "
            f"{second_s:.4f} s of wall (idle share "
            f"{1 - prof['total_us'] * 1e-6 / second_s:.4f}); "
            "the builder's kernels, us a build (launches): " + ", ".join(
                f"{k} {prof['us'][k]:.1f} ({prof['launches'][k]})" for k in BUILD_KERNELS)
            + f"; their sum {sum(prof['us'].values()):.1f} us")
    say(f"[build-device] {card}: each kernel at its largest call, ms in turns "
        "(bound ms, by; svo_expand_function is the column pass and the children, "
        "svo_expand the children alone): " + ", ".join(
            f"{k} {ms[k]:.4f} ({bounds[k][0]:.5f}, {bounds[k][1]})"
            for k in (*BUILD_KERNELS, *BUILD_FIRST_FORMS, "level_up_first_form",
                      "svo_expand_function", "svo_expand_serial", "svo_leaves_serial"))
        + f"; torch.nonzero of svo_compact's flags {ms['svo_compact_library']:.4f}, "
        f"with index_select of the kept rows' words (svo_compact's whole function, "
        f"== it bitwise) {ms['svo_compact_library_whole']:.4f}, with src[rows] in its "
        f"place {ms['svo_compact_library_gather']:.4f}; phase B (the leaf "
        f"test, its compaction, the attributes) {ms['phase_b']:.4f} against the first "
        f"form's {ms['phase_b_first_form']:.4f}; svo_leaves' kernels, us each: "
        + ", ".join(f"{k} {us:.1f}" for k, us in leaf_kernels)
        + f"; svo_leaves_serial {serial_us:.1f} us "
        f"alone; the leaf test's data: {data['solid']} solid candidates, "
        f"{data['leaves']} leaves, {data['evals']} evaluations against the "
        f"reference's {data['ref_evals']} ({OPS_TERRAIN_EVAL} operations a terrain "
        "evaluation)")

    # the scene library against the host's scenes
    rng = np.random.default_rng(14)
    n_pts = 1 << 20
    dyadic = (rng.integers(0, 1 << depth, (3, n_pts)).astype(np.float32)
              + np.float32(0.5)) * np.float32(2.0 ** -depth)
    rand = rng.random((3, n_pts), dtype=np.float32) * np.float32(1.2) - np.float32(0.1)
    apart = {}
    for name, sc in sorted(SCENES.items()):
        dsc = octree_cuda.device_scene(sc, dev)
        row = []
        for pts in (dyadic, rand):
            host_f = torch.from_numpy(np.asarray(sc(*pts), np.float32))
            xyz = [torch.from_numpy(np.ascontiguousarray(c)).to(dev) for c in pts]
            row.append(bits_apart(octree_cuda.scene_eval(dsc, *xyz).cpu(), host_f))
        apart[name] = tuple(row)
    say(f"[build-device] the scene library (scene_eval) against the host scenes, "
        f"float32 values whose bits part at {n_pts} dyadic centres (level {depth}) "
        f"and {n_pts} random points in [-0.1, 1.1)^3: " + ", ".join(
            f"{k} {a}/{b}" for k, (a, b) in apart.items()))
    if any(a for a, _ in apart.values()):
        raise AssertionError(f"scene values part at dyadic centres: {apart}")

    # the octant build against the monolithic one
    t0 = time.perf_counter()
    split, split_got = expect_launches(
        "build_svo_device_split terrain d10", lambda: octree_device.build_svo_device_split(
            scene, depth, split_level=2, device=dev), {}, allow=BUILD_KERNELS)
    split_s = time.perf_counter() - t0
    compare_tensors(
        [getattr(split, f) for f in ("masks", "child_base", "leaf_base", "parent_ptr",
                                     "leaf_albedo", "leaf_normal", "leaf_density")],
        [getattr(svo, f) for f in ("masks", "child_base", "leaf_base", "parent_ptr",
                                   "leaf_albedo", "leaf_normal", "leaf_density")],
        ("masks", "child_base", "leaf_base", "parent_ptr", "leaf_albedo",
         "leaf_normal", "leaf_density"), "the octant build against the monolithic one")
    if split.level_start != svo.level_start:
        raise AssertionError("the octant build's level_start differs")
    say(f"[build-device] build_svo_device_split(terrain, {depth}, split_level=2): "
        f"64 octants in {split_s:.3f} s ({split_got}), == the monolithic build bit "
        "for bit (every array)")
    split_log, split_exp, split_pass = [], [], []
    with checked_leaf_tests(split_log), checked_expansions(split_exp, plain=True), \
            checked_level_passes(split_pass):
        octree_device.build_svo_device_split(scene, depth, split_level=2, device=dev)
    say(f"[build-device] the octant build's {len(split_log)} leaf tests == their "
        f"first form bit for bit; {sum(c['evals'] for c in split_log)} evaluations "
        f"against the reference's {sum(c['ref_evals'] for c in split_log)}; its "
        f"{len(split_exp)} expansions == their first form and plain version bit for "
        f"bit, {sum(r['evals'] for r in split_exp)} column evaluations against "
        f"{sum(r['children'] for r in split_exp)} children; its "
        f"{sum(len(b) for b in split_pass)} level passes in {len(split_pass)} octant "
        "builds == the first forms bit for bit, each octant's parent pointers == "
        "svo_parent_ptr's")

    # the command line's noise scenes, built on the card at its default depth
    scene_builds = {}
    for name in BUILD_SCENES:
        t0 = time.perf_counter()
        built, _ = expect_launches(
            f"build_svo_device {name} d{BUILD_SCENE_DEPTH}",
            lambda n=name: octree_device.build_svo_device(get_scene(n), BUILD_SCENE_DEPTH,
                                                          device=dev),
            build_launches(BUILD_SCENE_DEPTH,
                           heightfield=name in octree_cuda.HEIGHTFIELDS))
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        octree_device.build_svo_device(get_scene(name), BUILD_SCENE_DEPTH, device=dev)
        torch.cuda.synchronize()
        scene_builds[name] = dict(svo=built, first_s=first,
                                  second_s=time.perf_counter() - t0)
    say(f"[build-device] {card}: the command line's noise scenes built on the card "
        f"at depth {BUILD_SCENE_DEPTH} (first call, second call): " + ", ".join(
            f"{k} {v['first_s']:.4f} / {v['second_s']:.4f} s ({v['svo'].n_nodes} nodes, "
            f"{v['svo'].n_leaves} leaves)" for k, v in scene_builds.items())
        + "; against [cli]'s host builds below")
    return dict(launches=got, first_s=first_s, second_s=second_s, ms=ms,
                plain_ms=plain_ms, bounds=bounds, prof=prof, scene_apart=apart,
                cd_us=cd_us, phases=phases, level_parents=level_parents,
                passes_checked=len(passes) + sum(len(b) for b in split_pass) + sum(
                    len(p_) for p_ in scene_passes.values()),
                scene_builds=scene_builds, levels=levels, split_s=split_s, leaf=leaf,
                serial_us=serial_us, scene_checks=scene_checks, leaf_kernels=leaf_kernels,
                split_checks=len(split_log), expansion=expansion,
                expansions_checked=len(exp_log) + len(split_exp) + sum(
                    len(e) for e in scene_expansions.values()),
                split_expansion=dict(evals=sum(r["evals"] for r in split_exp),
                                     children=sum(r["children"] for r in split_exp)))


def check_scene_builds(built, cdir):
    """The depth-8 noise scenes built on the card against [cli]'s host
    builds of them (its npz cache): structure bit for bit."""
    lines = []
    for name, row in built["scene_builds"].items():
        path = os.path.join(cdir, f"svo_{name}_d{BUILD_SCENE_DEPTH}.npz")
        host = checkpoint.load_svo(path, "cpu")
        svo = row["svo"]
        for f in ("masks", "child_base", "leaf_base"):
            if not torch.equal(getattr(svo, f).cpu(), getattr(host, f)):
                raise AssertionError(f"{name} d{BUILD_SCENE_DEPTH}: {f} of the "
                                     "device build differs from the host build")
        if svo.level_start != host.level_start:
            raise AssertionError(f"{name}: level_start differs")
        nrm = bits_apart(svo.leaf_normal.cpu(), host.leaf_normal)
        lines.append(f"{name} ({nrm} normal values' bits apart, max abs "
                     f"{float((svo.leaf_normal.cpu() - host.leaf_normal).abs().max()):.3g})")
    say(f"[build-device] depth-{BUILD_SCENE_DEPTH} device builds == [cli]'s host builds "
        "(masks, child_base, leaf_base, level_start bit for bit): " + ", ".join(lines))


def svo_ptxas(log):
    """(kernel, registers) of each kernel in ptxas's report of
    svo_build.cu."""
    return [(m.group(1), int(m.group(2))) for m in re.finditer(
        r"Compiling entry function '\w*?((?:svo_\w+?|scene_eval)_kernel)\w*'"
        r".*?Used (\d+) registers", log, re.S)]


# ---- [sharded]: the sharded renderer in a world of one -----------------------

# the level-sharded world: bench.py's terrain at depth 12 (BASELINE config 5's
# depth), built on the card octant by octant and split at level 2, traced
# through bench.py's camera at 2048²; its paths' parity with their plain
# versions runs on every SHARDED_STRIDE-th ray of every SHARDED_STRIDE-th row
SHARDED_DEPTH, SHARDED_SPLIT, SHARDED_RES, SHARDED_STRIDE = 12, 2, 2048, 4
# the TPU sites the level_round modes replace
LEVEL_REPLACES = {"sharded": "raytracingtest_tpu/parallel/level_sharded.py:327",
                  "trunk": "raytracingtest_tpu/parallel/level_sharded.py:481",
                  "packets": "raytracingtest_tpu/parallel/level_sharded.py:481"}
# the box exit and the carry of one round a ray (the six planes, the
# minimum, the advance)
OPS_LEVEL_EXIT = 20


@contextlib.contextmanager
def plain_rounds():
    """Inside the block the level-sharded loops take level_round's plain
    version on the card's tensors, and the sharded loop reads its end by a
    reduction (no queue: the plain rounds keep none)."""
    from raytracingtest_tpu_torch.parallel import level_sharded
    kernel, live = level_sharded.level_round, level_sharded._live

    def plain(mode, tb, *args, counts=None, **_queue):
        return level_sharded.level_round_plain(mode, tb, *args, counts=counts)
    level_sharded.level_round = plain
    level_sharded._live = lambda done, _t_off, _queue: (int((~done).sum()), None)
    try:
        yield
    finally:
        level_sharded.level_round = kernel
        level_sharded._live = live


@contextlib.contextmanager
def first_form_rounds():
    """Inside the block the level-sharded loops take level_round's first
    form (level_round_serial) on the card's tensors, and the sharded loop
    reads its end as the first form's loop did (no count pass)."""
    from raytracingtest_tpu_torch.parallel import level_sharded
    kernel = level_sharded.level_round

    def first(mode, tb, *args, counts=None, **_queue):
        return brick_cuda.level_round_serial_kernel(
            mode, tb.trunk, tb.arena, tb.owner, tb.root, tb.origin, tb.size, tb.rank,
            *args)
    live = level_sharded._live
    level_sharded.level_round = first
    # the sharded loop's end read as it was before the queue: a reduction
    level_sharded._live = lambda done, _t_off, _queue: (int((~done).sum()), None)
    try:
        yield
    finally:
        level_sharded.level_round = kernel
        level_sharded._live = live


@contextlib.contextmanager
def level_calls():
    """Every call of level_round made inside the block, (mode, tables,
    args, the queue's keywords: live, seg; a copy of its outputs; for a
    loop's queued round of "sharded" or "trunk", a copy of its queue's state
    before the call (queue_state) and of the queue the main path made for
    it (queue, count), else None) in a list; the calls themselves go on."""
    from raytracingtest_tpu_torch.parallel import level_sharded
    calls, kernel = [], level_sharded.level_round

    def recording(mode, tb, *args, **kw):
        q = kw.get("queue")
        queued = q is not None and mode != "packets" and q.out is not None
        before = queue_state(q) if queued else None
        res = kernel(mode, tb, *args, **kw)
        made = (q.prev.clone(), q.prev_count.clone()) if queued else None
        calls.append((mode, tb, args, {k: kw[k] for k in ("live", "seg") if k in kw},
                      tuple(t.clone() for t in res), (before, made) if queued else None))
        return res
    level_sharded.level_round = recording
    try:
        yield calls
    finally:
        level_sharded.level_round = kernel


def queue_state(q):
    """A copy of a loop's LevelQueue as a round finds it: its last round's
    queue, count and bound (None after a first round), new status words."""
    st = brick_cuda.LevelQueue()
    if q.prev is not None:
        st.prev, st.prev_count = q.prev.clone(), q.prev_count.clone()
    st.bound = q.bound
    return st


def check_queue(mode, args, state, made, err):
    """One round's queue ("sharded" or "trunk") in both forms, the one pass
    and level_queue_serial, over the round's state: each form's queue and
    count against level_queue_plain's and the main path's (`made`) bitwise,
    and the done rays' outputs against the first form's of the round (oct_id
    -1, t_next = t_off, no hit). Returns (entries, live)."""
    _o, _d, t_off, done = args
    prev = None if state.prev is None else state.prev[:int(state.prev_count)]
    want = level_sharded.level_queue_plain(mode, None, done, prev=prev)
    entries = torch.arange(done.shape[0], device=done.device) if prev is None else prev.long()
    gone = entries[done[entries]]
    names = (("oct_id", "hit", "leaf", "t_hit", "t_next") if mode == "sharded"
             else ("oct_id", "t_next"))
    first_form = {"oct_id": -1, "hit": 0, "leaf": -1, "t_hit": 0.0}
    for form in brick_cuda.FORMS["level_queue"]:
        # a copy of the state a form: the one pass moves its status words on
        st = brick_cuda.LevelQueue()
        st.prev, st.prev_count, st.bound = state.prev, state.prev_count, state.bound
        rq, out = brick_cuda.level_queue_kernel(mode, done, t_off, form=form, queue=st)
        count = brick_cuda.live_count(rq)
        if count != want.numel() or not torch.equal(rq.queue[:count].long(), want):
            raise AssertionError(f"level_queue {form}, {mode}: the queue parts from "
                                 "level_queue_plain")
        for name, t in zip(names, out):
            w = t_off[gone] if name == "t_next" else torch.full_like(t[gone], first_form[name])
            if not torch.equal(bits(t[gone]) if t.is_floating_point() else t[gone],
                               bits(w) if w.is_floating_point() else w):
                raise AssertionError(f"level_queue {form}, {mode}: a done ray's {name}")
    if made is not None:
        count = int(made[1])
        if count != want.numel() or not torch.equal(made[0][:count].long(), want):
            raise AssertionError(f"level_queue, {mode}: the main path's queue parts from "
                                 "level_queue_plain")
    err["level_queue"] = err["level_queue_serial"] = 0.0
    return int(entries.numel()), int(want.numel())


def counted_run(what, fn, kernels):
    """fn() from zeroed counts; fails unless it launched every kernel of
    `kernels` and no other, nor called a plain version. Returns (fn()'s
    result, the launches)."""
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    got = {k: v for k, v in launch_counts().items() if v}
    if set(got) != set(kernels):
        raise AssertionError(f"{what}: launched {got}, expected each of {kernels}")
    return out, got


def level_work(mode, tb, args, counts):
    """bound() of one level_round call: the tables the mode walks, read once
    at most (a node row's 16 B a step, at most each row once), the live
    rays' origins and directions (a valid packet's 32 B), each ray's done
    flag and t_off ("sharded", "trunk"), each output written once; this
    call's stackless steps and walks as the plain version counted them, and
    the box exit of a live ray."""
    trunk = nbytes(tb.trunk.masks, tb.trunk.child_base, tb.trunk.parent_ptr,
                   tb.trunk.leaf_base)
    arena = nbytes(tb.arena.masks, tb.arena.child_base, tb.arena.parent_ptr,
                   tb.arena.leaf_base)
    # the trunk mode reads no arena, the packets mode no trunk
    walked = (arena if mode != "trunk" else 0) + (trunk if mode != "packets" else 0)
    n = args[0].shape[0]
    if mode == "packets":
        live = int((args[0][:, 7:8].contiguous().view(torch.int32) != 0).sum())
        in_bytes = live * 32
    else:
        live = int((~args[3]).sum())
        in_bytes = n * 5 + live * 24
    out_bytes = {"sharded": 20, "trunk": 8, "packets": 8}[mode] * n
    n_bytes = (nbytes(tb.owner, tb.root, tb.origin) + min(counts["steps"] * 16, walked)
               + in_bytes + out_bytes)
    n_ops = (counts["steps"] * OPS_ESVO_STEP + live * OPS_DIR_SETUP
             + counts["walks"] * OPS_WALK_SETUP
             + (0 if mode == "packets" else live * OPS_LEVEL_EXIT))
    return bound(n_bytes, n_ops)


def launches_of(fn, attempts=5):
    """(kernel name, device us) of each launch of one fn() call in launch
    order, from torch.profiler's events. The tracer drops launches made
    while it starts, so it sees two calls, a spin kernel between them, and
    the second call's launches are kept. Now and then it loses a whole
    window, the spin kernel with it: that window is traced again, up to
    `attempts` windows, each retry said."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(20000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        spins = [k for k, e in enumerate(events) if "spin_kernel" in e.name]
        if spins:
            return [(e.name, e.time_range.elapsed_us()) for e in events[spins[-1] + 1:]]
        say(f"[trace] launches_of: the tracer dropped its marker ({len(events)} events "
            f"seen), window {attempt + 1} of {attempts}")
    raise AssertionError("launches_of: the tracer dropped its marker")


def path_profile(fn, key=None):
    """(device us a call in every kernel, launches a call; the same for the
    kernels whose names hold `key`) over three calls, from torch.profiler.
    Now and then the tracer loses a whole window: a pass in which it saw no
    kernel is repeated over 12 and then 48 calls, and None is returned where
    it still saw none."""
    for runs in (3, 12, 48):
        rows = traced_kernels(fn, runs)
        total = sum(dev_us(e) for e in rows) / runs
        if total > 0.0:
            break
    else:
        return None
    mine = [e for e in rows if key and key in e.key]
    return dict(us=total, n=sum(e.count for e in rows) / runs,
                key_us=sum(dev_us(e) for e in mine) / runs,
                key_n=sum(e.count for e in mine) / runs,
                by={e.key: dev_us(e) / runs for e in rows})


def sharded_phase(ctx, card):
    """[sharded]: the sharded renderer (parallel/) in a real NCCL world of
    one on the card. The depth-12 terrain, built on the card octant by
    octant (build_svo_device_split) and split at level 2 (split_svo, one
    arena), traced at 2048² through bench.py's camera by make_sharded_trace
    (K10b: level_round "sharded") and make_exchange_trace (cap_factor 1;
    K10c: level_round "trunk" and "packets"), and trained one step by
    make_sharded_fit_step (target 0). Each level_round mode is held bitwise
    against its plain version on the main path's first call of it (the
    whole batch), each path against the plain rounds on a fixed subset of
    its rays, the trace against clipmap_trace on the same tables and the
    exchange trace. Then the depth-10 frame at 1024²: render_sharded, the
    three sharded train steps against the unsharded ones (hits, loss and
    gradients bit for bit expected; F4's 1e-4 required), and two
    InverseRenderer(n_devices=1) steps. Returns the numbers for the kernels
    line."""
    import torch.distributed as dist

    from raytracingtest_tpu_torch.ops import octree_device
    from raytracingtest_tpu_torch.parallel import level_sharded
    from raytracingtest_tpu_torch.parallel import render_sharded as rs
    from raytracingtest_tpu_torch.parallel.mesh import make_mesh

    dev, err, bench_cam = ctx["dev"], ctx["err"], ctx["bench_cam"]
    mesh = make_mesh(1, dev)
    if dist.get_backend() != "nccl" or mesh.world != 1:
        raise AssertionError(f"the world is {dist.get_backend()} of {mesh.world}")
    out = dict(launches={}, ms={}, prof={}, calls={})

    # ---- the depth-12 world ----------------------------------------------------
    t0 = time.perf_counter()
    svo12 = octree_device.build_svo_device_split(
        get_scene("terrain"), SHARDED_DEPTH, split_level=SHARDED_SPLIT, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    leaf_log, pass_log = [], []
    with checked_leaf_tests(leaf_log), checked_level_passes(pass_log):
        octree_device.build_svo_device_split(
            get_scene("terrain"), SHARDED_DEPTH, split_level=SHARDED_SPLIT, device=dev)
    out["leaf_checks"] = dict(tests=len(leaf_log), evals=sum(c["evals"] for c in leaf_log),
                              ref_evals=sum(c["ref_evals"] for c in leaf_log))
    say(f"[sharded] the depth-{SHARDED_DEPTH} octant build's {len(leaf_log)} leaf tests "
        f"(svo_leaves, svo_leaf_attrs) == their first form bit for bit; "
        f"{out['leaf_checks']['evals']} evaluations against the reference's "
        f"{out['leaf_checks']['ref_evals']}; its {sum(len(b) for b in pass_log)} level "
        f"passes in {len(pass_log)} octant builds == the first forms (svo_level_up, "
        "svo_compact) bit for bit, each octant's parent pointers == svo_parent_ptr's")
    t0 = time.perf_counter()
    ls = level_sharded.split_svo(svo12, SHARDED_SPLIT, 1)
    split_s = time.perf_counter() - t0
    arena_b = sum(a.nbytes for a in (ls.arena_masks, ls.arena_child, ls.arena_leaf,
                                     ls.arena_albedo, ls.arena_normal, ls.arena_density))
    t0 = time.perf_counter()
    trace = level_sharded.make_sharded_trace(mesh, ls)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    tb = trace.tables
    exchange = level_sharded.make_exchange_trace(mesh, ls, max_rounds=256, cap_factor=1)
    fit = level_sharded.make_sharded_fit_step(mesh, ls)
    say(f"[sharded] {card}: a real NCCL world of one; terrain depth "
        f"{SHARDED_DEPTH}: {svo12.n_nodes} nodes, {svo12.n_leaves} leaves, built on "
        f"the card octant by octant in {build_s:.2f} s; split at level "
        f"{SHARDED_SPLIT} on the host in {split_s:.2f} s ({len(ls.octant_root)} "
        f"octants of sub-depth {ls.sub_depth}; trunk {ls.trunk_masks.shape[0]} rows; "
        f"the arena {ls.arena_masks.shape[1]} node rows, "
        f"{ls.arena_albedo.shape[1]} leaf rows, {arena_b / 1e9:.3f} GB), "
        f"moved to the card in {upload_s:.2f} s")
    del svo12

    cam = camera.Camera(**bench_cam, width=SHARDED_RES, height=SHARDED_RES)
    o, d = cam.rays(dev)
    n = o.shape[0]
    light = ctx["light"]
    target = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    arena_params = (tb.arena.leaf_albedo, tb.arena.leaf_normal, tb.arena.leaf_density)

    # the three paths, each launching only its kernels
    with level_calls() as calls:
        got_tr, launches = counted_run("make_sharded_trace", lambda: trace(o, d),
                                       {"level_round_sharded", "level_queue"})
        out["launches"]["sharded trace"], rounds_tr = launches, trace.stats["rounds"]
        got_ex, launches = counted_run("make_exchange_trace", lambda: exchange(o, d),
                                       {"level_round_trunk", "level_round_packets",
                                        "level_queue"})
        out["launches"]["exchange trace"], rounds_ex = launches, exchange.stats["rounds"]
        (loss, grads), launches = counted_run(
            "make_sharded_fit_step", lambda: fit(*arena_params, o, d, light, target),
            {"level_round_sharded", "level_queue", "shade_fwd", "shade_bwd",
             "segment_sum"})
        out["launches"]["sharded fit"], rounds_fit = launches, fit.stats["rounds"]
    if (out["launches"]["sharded trace"]["level_round_sharded"] != rounds_tr
            or out["launches"]["exchange trace"]["level_round_trunk"] != rounds_ex
            or out["launches"]["exchange trace"]["level_round_packets"] != rounds_ex
            or out["launches"]["sharded fit"]["level_round_sharded"] != rounds_fit):
        raise AssertionError(f"rounds {rounds_tr}, {rounds_ex}, {rounds_fit} against "
                             f"the launches {out['launches']}")
    leaf, t_hit, owner, trunc = got_tr
    x_leaf, x_t, x_owner, traced, x_trunc = got_ex
    n_hit, n_trunc, n_xtrunc = int((leaf >= 0).sum()), int(trunc.sum()), int(x_trunc.sum())
    if n_xtrunc or n_trunc or n_hit == 0:
        raise AssertionError(f"{n_hit} hits, {n_trunc} rays truncated by the sharded "
                             f"trace, {n_xtrunc} by the exchange trace")
    # the exchange trace is the sharded trace's answer at one rank
    if not (torch.equal(x_leaf, leaf) and torch.equal(bits(x_t), bits(t_hit))
            and torch.equal(x_owner, owner) and int(traced) > 0):
        raise AssertionError("the exchange trace differs from the sharded trace")
    if not (bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all()) for g in grads)
            and float(sum(g.abs().sum() for g in grads)) > 0):
        raise AssertionError(f"the sharded fit: loss {float(loss)}, grads not finite or 0")
    # the same tables through the streamed world's stitched trace: one
    # chunk an octant, the trunk at corner 0 and size 1
    n_oct = tb.root.shape[0]
    sizes = torch.full((n_oct,), tb.size, dtype=torch.float32, device=dev)
    n_max = level_sharded.rounds_bound(ls.trunk_depth)
    c_leaf, c_t, c_chunk, c_trunc = brick_cuda.clipmap_kernel(
        tb.trunk, (0.0, 0.0, 0.0), 1.0, tb.root, tb.origin, sizes, tb.arena, o, d,
        ls.sub_depth, n_max)
    torch.cuda.synchronize()
    if not (torch.equal(c_leaf, leaf) and torch.equal(bits(c_t), bits(t_hit))
            and torch.equal(c_trunc, trunc)):
        raise AssertionError(f"clipmap_trace parts from the sharded trace on "
                             f"{int((c_leaf != leaf).sum())} leaves")
    say(f"[sharded] the {SHARDED_RES}² rays of bench.py's camera: make_sharded_trace "
        f"{rounds_tr} rounds (launches {out['launches']['sharded trace']}), "
        f"make_exchange_trace {rounds_ex} rounds, cap_factor 1 (launches "
        f"{out['launches']['exchange trace']}, {int(traced)} packets walked), "
        f"make_sharded_fit_step {rounds_fit} rounds (launches "
        f"{out['launches']['sharded fit']}, loss {float(loss):.6f}): {n_hit} rays hit, "
        f"{n_trunc} truncated by the sharded trace and {n_xtrunc} by the exchange "
        f"trace; the two traces agree bit for bit, and clipmap_trace on the same "
        f"tables (one chunk an octant) gives their leaves and t bits")

    # every round of the three paths' loops: the queued form (the main
    # path's) and the first form against the plain version, bit for bit;
    # each round's live rays or valid packets, µs alone of both forms (the
    # queued form with its queue's passes), and bound
    names_of = {"sharded": ("oct_id", "hit", "leaf", "t_hit", "t_next"),
                "trunk": ("oct_id", "t_next"), "packets": ("replies",)}
    rounds_of = {"sharded": [], "trunk": [], "packets": []}
    # the sharded trace's and the exchange trace's rounds (the fit step's
    # repeat the trace's)
    for mode, tbl, args, kw, main_out, _queued in [c for c in calls if c[0] != "sharded"] + [
            c for c in calls if c[0] == "sharded"][:rounds_tr]:
        tables = (tbl.trunk, tbl.arena, tbl.owner, tbl.root, tbl.origin, tbl.size, tbl.rank)
        fn = (lambda m=mode, t=tables, a=args, k=kw:
              brick_cuda.level_round_kernel(m, *t, *a, **k))
        fn_first = (lambda m=mode, t=tables, a=args:
                    brick_cuda.level_round_serial_kernel(m, *t, *a))
        counts = {}
        t0 = time.perf_counter()
        plain = level_sharded.level_round_plain(mode, tbl, *args, counts=counts)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        r = len(rounds_of[mode])
        # the main path's own outputs (its loop's queue: the passes over the
        # last round's live rays, the outputs kept), then the form alone
        compare_tensors(main_out, plain, names_of[mode],
                        f"level_round {mode} on the main path, round {r + 1}")
        e1 = compare_tensors(fn(), plain, names_of[mode], f"level_round {mode}, round {r + 1}")
        e2 = compare_tensors(fn_first(), plain, names_of[mode],
                             f"level_round_serial {mode}, round {r + 1}")
        err[f"level_round_{mode}"] = max(err.get(f"level_round_{mode}", 0.0), e1)
        err["level_round_serial"] = max(err.get("level_round_serial", 0.0), e2)
        live = (int((args[0][:, 7:8].contiguous().view(torch.int32) != 0).sum())
                if mode == "packets" else int((~args[3]).sum()))
        row = dict(n=args[0].shape[0], live=live, counts=counts, plain_ms=plain_s * 1e3,
                   bound=level_work(mode, tbl, args, counts), us_alone=graph_us(fn),
                   us_alone_first_form=graph_us(fn_first))
        if r == 0:
            row.update(ms=cuda_ms(fn, 20, 3), ms_first_form=cuda_ms(fn_first, 20, 3))
        rounds_of[mode].append(row)
    for mode, rows in rounds_of.items():
        say(f"[sharded] level_round {mode}: every round's call == level_round_plain "
            f"bitwise ({', '.join(names_of[mode])}), the queued form and the first form "
            f"(level_round_serial); {card}, round by round (live "
            f"{'packets' if mode == 'packets' else 'rays'} of {rows[0]['n']}; walks, "
            "stackless steps; us alone in a CUDA graph, the queued form with its "
            "queue's passes against the first form; bound us): " + "; ".join(
                f"{i + 1}: {c['live']}, {c['counts']['walks']}, {c['counts']['steps']}; "
                f"{c['us_alone']:.1f} against {c['us_alone_first_form']:.1f}; "
                f"{c['bound'][0] * 1e3:.1f} ({c['bound'][1]})"
                for i, c in enumerate(rows)))
    out["calls"] = {mode: rows[0] for mode, rows in rounds_of.items()}
    out["rounds_of"] = rounds_of

    # the queue: every queued round of both traces in both forms against
    # level_queue_plain and the main path's; alone on the sharded trace's
    # second round (the first with done rays, over every ray) against its
    # first form and torch.nonzero
    queued = [c for c in calls if c[5] is not None]
    checked = [(c[0],) + check_queue(c[0], c[2], *c[5], err) for c in (
        [c for c in queued if c[0] == "sharded"][:rounds_tr - 1]
        + [c for c in queued if c[0] == "trunk"])]
    if {m for m, _e, _l in checked} != {"sharded", "trunk"}:
        raise AssertionError(f"the queue's checks saw the modes {checked}")
    _m, tbl2, args2, _kw, _o, _q = [c for c in calls if c[0] == "sharded"][1]
    done2, t_off2 = args2[3], args2[2]
    t0 = time.perf_counter()
    want2 = level_sharded.level_queue_plain("sharded", None, done2)
    torch.cuda.synchronize()
    queue_plain_ms = (time.perf_counter() - t0) * 1e3
    kept = brick_cuda.LevelQueue()  # the one pass's status words, as a loop keeps them
    q_fns = {"one_pass": lambda: brick_cuda.level_queue_kernel("sharded", done2, t_off2,
                                                               queue=kept),
             "first": lambda: brick_cuda.level_queue_kernel("sharded", done2, t_off2,
                                                            form="first"),
             "nonzero": lambda: torch.nonzero(~done2)}
    q_turns = in_turns(q_fns, rounds=3, reps=20)
    # alone: a CUDA graph of 20 calls, in turns; torch.nonzero syncs and
    # cannot be graphed: its kernel events in the tracer
    q_alone = {}
    for form in ("one_pass", "first", "first", "one_pass"):
        q_alone.setdefault(form, []).append(graph_us(q_fns[form]))
    nz_rows = traced_kernels(q_fns["nonzero"], 20)
    n2, live2 = done2.shape[0], int(want2.numel())
    # the flags read (once, or twice by the first form's two passes), t_off
    # and the five outputs of a done ray, a live ray's place
    moved = (n2 - live2) * 24 + live2 * 4
    out["queue"] = dict(
        n=n2, live=live2, ms=med_p80(q_turns["one_pass"])[0],
        ms_first_form=med_p80(q_turns["first"])[0],
        library_ms=med_p80(q_turns["nonzero"])[0], plain_ms=queue_plain_ms,
        us_alone=float(np.median(q_alone["one_pass"])),
        us_alone_first_form=float(np.median(q_alone["first"])),
        library_us_alone=sum(dev_us(e) for e in nz_rows) / 20,
        library_kernels={e.key[:70]: dev_us(e) / 20 for e in nz_rows},
        bound=bound(n2 + moved, n2 * OPS_COMPACT_ROW),
        bound_first_form=bound(2 * n2 + moved + 2 * nbytes(
            torch.empty(-(-n2 // brick_cuda.QBLOCK), dtype=torch.int32)), n2 * OPS_COMPACT_ROW),
        checked=[dict(mode=m, entries=e, live=lv) for m, e, lv in checked])
    q = out["queue"]
    say(f"[sharded] {card}: level_queue on every queued round of both traces ("
        + ", ".join(f"{m} {lv} of {e}" for m, e, lv in checked) + "): the one pass and "
        "its first form (count pass, torch.cumsum, place pass) == level_queue_plain and "
        "the main path's queue bitwise, the done rays' outputs the first form's; on the "
        f"sharded trace's round 2, {live2} live of {n2} rays: in turns one pass "
        f"{q['ms']:.4f} ms, first form {q['ms_first_form']:.4f}, torch.nonzero "
        f"{q['library_ms']:.4f}; alone {q['us_alone']:.1f} us against the first form's "
        f"{q['us_alone_first_form']:.1f} (CUDA graphs, in turns: {q_alone}) and "
        f"torch.nonzero's {q['library_us_alone']:.1f} (its kernel events: "
        f"{q['library_kernels']}); bound {q['bound'][0] * 1e3:.1f} us ({q['bound'][1]}), "
        f"the first form's {q['bound_first_form'][0] * 1e3:.1f}")

    # the first form with per-warp counters: the sharded trace's first three
    # rounds and the exchange's first packets round
    out["warps"] = {}
    probed = [c for c in calls if c[0] == "sharded"][:3] + [
        [c for c in calls if c[0] == "packets"][0]]
    for k, (mode, tbl, args, _kw, _o, _q) in enumerate(probed):
        res, record = brick_cuda.probe_level_round(
            mode, tbl.trunk, tbl.arena, tbl.owner, tbl.root, tbl.origin, tbl.size,
            tbl.rank, *args)
        compare_tensors(res, level_sharded.level_round_plain(mode, tbl, *args),
                        names_of[mode], f"level_round's probe form, {mode}")
        label = f"level_round {mode} round {k + 1 if mode == 'sharded' else 1}"
        out["warps"][label] = warps_line(label, "first", record, np.zeros(0))
    # each path against the plain rounds on the fixed subset of its rays
    sub = torch.arange(SHARDED_RES, device=dev)[::SHARDED_STRIDE]
    pick = (sub[:, None] * SHARDED_RES + sub[None, :]).reshape(-1)
    po, pd = o[pick].contiguous(), d[pick].contiguous()
    with plain_rounds():
        t0 = time.perf_counter()
        p_tr = trace(po, pd)
        torch.cuda.synchronize()
        out["ms"]["sharded trace plain"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        p_ex = exchange(po, pd)
        torch.cuda.synchronize()
        out["ms"]["exchange trace plain"] = (time.perf_counter() - t0) * 1e3
        p_fit = fit(*arena_params, po, pd, light, target[pick])
    k_fit = fit(*arena_params, po, pd, light, target[pick])
    compare_tensors(tuple(x[pick] for x in got_tr), p_tr,
                    ("leaf", "t", "owner", "truncated"), "make_sharded_trace, plain rounds")
    compare_tensors(tuple(x[pick] for x in (x_leaf, x_t, x_owner, x_trunc)),
                    (p_ex[0], p_ex[1], p_ex[2], p_ex[4]),
                    ("leaf", "t", "owner", "truncated"), "make_exchange_trace, plain rounds")
    compare_tensors((k_fit[0], *k_fit[1]), (p_fit[0], *p_fit[1]),
                    ("loss", "g_albedo", "g_normal", "g_density"),
                    "make_sharded_fit_step, plain rounds")
    say(f"[sharded] the paths on the fixed subset of {pick.numel()} rays (every "
        f"{SHARDED_STRIDE}th ray of every {SHARDED_STRIDE}th row): make_sharded_trace "
        f"and make_exchange_trace == their plain rounds (leaf, t bits, owner, "
        f"truncation), make_sharded_fit_step's loss and gradients == the plain "
        f"rounds' bit for bit")

    # timing: CUDA events a call, and the tracer's kernels
    paths = {"sharded trace": lambda: trace(o, d),
             "exchange trace": lambda: exchange(o, d),
             "sharded fit": lambda: fit(*arena_params, o, d, light, target)}
    rounds = {"sharded trace": rounds_tr, "exchange trace": rounds_ex,
              "sharded fit": rounds_fit}
    for name, fn in paths.items():
        out["ms"][name] = cuda_ms(fn, 5, 1)
        out["prof"][name] = path_profile(fn, "level_round_")
    idle = lambda p, ms: "not measured" if p is None else f"{1 - p['us'] / 1e3 / ms:.2f}"
    kus = lambda p, k: "not measured" if p is None else f"{p[k]:.1f}"
    say(f"[sharded] {card}: at {SHARDED_RES}² on the depth-{SHARDED_DEPTH} world, " + "; ".join(
        f"{name} {med_p80(out['ms'][name])[0]:.3f} ms (p80 "
        f"{med_p80(out['ms'][name])[1]:.3f}) in {rounds[name]} rounds, "
        f"{kus(out['prof'][name], 'us')} us of kernels in "
        f"{kus(out['prof'][name], 'n')} launches ({kus(out['prof'][name], 'key_us')} us "
        f"in level_round), idle {idle(out['prof'][name], med_p80(out['ms'][name])[0])}"
        for name in paths) + f"; the plain rounds on the {pick.numel()} subset rays: "
        f"sharded trace {out['ms']['sharded trace plain']:.1f} ms, exchange trace "
        f"{out['ms']['exchange trace plain']:.1f} ms")
    for name in paths:
        p = out["prof"][name]
        if p is not None:
            top = sorted(p["by"].items(), key=lambda kv: -kv[1])[:6]
            say(f"[sharded] {name}: the kernels by device us a call: " + ", ".join(
                f"{k[:60]} {v:.1f}" for k, v in top))
    # the loops with the queued form (the main path's) against the same loops
    # with the first form: wall ms in turns, and each launch's device us from
    # the tracer (level_round's rounds, the queue's passes)
    def first_formed(fn):
        def run():
            with first_form_rounds():
                return fn()
        return run

    def serial_queued(fn):
        # the queued rounds over the queue's first form (level_queue_serial)
        def run():
            one_pass = brick_cuda._queue_one_pass
            brick_cuda._queue_one_pass = brick_cuda._queue_serial
            try:
                return fn()
            finally:
                brick_cuda._queue_one_pass = one_pass
        return run

    is_queue = lambda k: "level_queue_" in k or "DeviceScan" in k
    out["forms"] = {}
    for name in ("sharded trace", "exchange trace"):
        fn = paths[name]
        forms = {"queued": fn, "serial queue": serial_queued(fn), "first": first_formed(fn)}
        for form in ("serial queue", "first"):
            if not all(torch.equal(bits(a) if a.is_floating_point() else a,
                                   bits(b) if b.is_floating_point() else b)
                       for a, b in zip(fn(), forms[form]())):
                raise AssertionError(f"{name}: the loop with {form} parts from the main path")
        wall = in_turns(forms, rounds=3, reps=3)
        ev = {form: launches_of(f) for form, f in forms.items()}
        rnd = {form: [us for k, us in e if "level_round_" in k] for form, e in ev.items()}
        queue_us = {form: sum(us for k, us in ev[form] if is_queue(k))
                    for form in ("queued", "serial queue")}
        queue_n = {form: sum(1 for k, _us in ev[form] if is_queue(k))
                   for form in ("queued", "serial queue")}
        # the queued form's rounds on the main path: each walk with the queue's
        # launches since the walk before
        per_round, acc = [], 0.0
        for k, us in ev["queued"]:
            if is_queue(k):
                acc += us
            elif "level_round_" in k:
                per_round.append((acc, us))
                acc = 0.0
        out["forms"][name] = dict(
            ms={k: med_p80(v)[0] for k, v in wall.items()}, rounds_us=rnd,
            queue_us=queue_us["queued"], queue_launches=queue_n["queued"],
            queue_us_first_form=queue_us["serial queue"],
            queue_launches_first_form=queue_n["serial queue"], per_round=per_round,
            all_us={form: sum(us for _, us in e) for form, e in ev.items()})
        f = out["forms"][name]
        say(f"[sharded] {card}: {name} in turns, the main path (level_queue's one pass) "
            f"{f['ms']['queued']:.3f} ms, with the queue's first form "
            f"{f['ms']['serial queue']:.3f}, level_round's first form {f['ms']['first']:.3f}; "
            f"the queue (traced): {queue_us['queued']:.1f} us in {queue_n['queued']} launches "
            f"against its first form's {queue_us['serial queue']:.1f} in "
            f"{queue_n['serial queue']} (level_queue and DeviceScan kernels); level_round's "
            f"launches, us each: {[round(x, 1) for x in rnd['queued']]} (sum "
            f"{sum(rnd['queued']):.1f}) against the first form's "
            f"{[round(x, 1) for x in rnd['first']]} (sum {sum(rnd['first']):.1f}); every "
            f"kernel {f['all_us']['queued']:.1f}, {f['all_us']['serial queue']:.1f} and "
            f"{f['all_us']['first']:.1f} us; the main path's rounds as (queue, walk) us: "
            f"{[(round(a, 1), round(b, 1)) for a, b in per_round]}")
    for mode, c in out["calls"].items():
        say(f"[bound] level_round {mode}, the first call ({c['n']} "
            f"{'packets' if mode == 'packets' else 'rays'}; {OPS_ESVO_STEP} operations "
            f"a stackless step, {OPS_DIR_SETUP} a live ray's direction and "
            f"{OPS_WALK_SETUP} a walk's set-up, {OPS_LEVEL_EXIT} a "
            f"ray's box exit): {c['counts']['steps']} steps, {c['counts']['walks']} "
            f"walks, bound {c['bound'][0]:.5f} ms ({c['bound'][1]}); "
            f"{med_p80(c['ms'])[0]:.4f} ms through the wrapper, {c['us_alone']:.2f} us "
            f"alone in a CUDA graph; plain {c['plain_ms']:.1f} ms")

    # ---- the depth-10 frame, world of one ------------------------------------------
    svo, bsvo, ts = ctx["svo"], ctx["bsvo"], ctx["ts"]
    o10, d10 = ctx["o"], ctx["d"]
    o_t, d_t, corners, _grid = ctx["tile_rays"]
    params = (svo.leaf_albedo, svo.leaf_normal, svo.leaf_density)
    img = diff.render_diff(*params, svo, o10, d10, light)
    tgt = (img * 0.5).contiguous()
    got_img, launches = counted_run(
        "render_sharded", lambda: rs.render_sharded(mesh, *params, svo, o10, d10, light),
        {"esvo_stackless", "shade_fwd"})
    if not torch.equal(bits(got_img), bits(img)):
        raise AssertionError("render_sharded differs from the unsharded frame")
    out["launches"]["render_sharded"] = launches

    def still(p):
        return torch.optim.SGD([p[k] for k in ("albedo", "normal", "density")], lr=0.0)

    def fresh():
        return {"albedo": svo.leaf_albedo.clone(), "normal": svo.leaf_normal.clone(),
                "density": svo.leaf_density.clone()}

    img_t, _res = diff.render_diff_tile(*params, ts, o_t, d_t, corners, light,
                                        **renderers.TILE_STEP_BUDGETS)
    tgt_t = (img_t * 0.5).contiguous()
    steps = {
        "make_train_step": (
            {"esvo_stackless", "shade_fwd", "shade_bwd", "segment_sum"},
            lambda p: rs.make_train_step(mesh)(p, still(p), svo, o10, d10, light, tgt),
            lambda: diff.loss_and_grads(*params, svo, o10, d10, light, tgt)),
        "make_train_step_brick": (
            {"brick_trace", "shade_fwd", "shade_bwd", "segment_sum"},
            lambda p: rs.make_train_step_brick(mesh)(p, still(p), bsvo, o10, d10, light, tgt),
            lambda: diff.loss_and_grads_brick(*params, bsvo, o10, d10, light, tgt)),
        "make_train_step_tile": (
            {"tile_candidates", "tile_walk", "shade_fwd", "shade_bwd", "segment_sum"},
            lambda p: rs.make_train_step_tile(mesh, **renderers.TILE_STEP_BUDGETS)(
                p, still(p), ts, o_t, d_t, corners, light, tgt_t),
            lambda: diff.loss_and_grads_tile(*params, ts, o_t, d_t, corners, light, tgt_t,
                                             **renderers.TILE_STEP_BUDGETS)),
    }
    def unsharded(one_fn, p):
        # the unsharded step with the same still optimizer's update, so the
        # two differ only by the all_reduce and the share's division
        out_one = one_fn()
        rs._apply(p, still(p), out_one[1])
        return out_one

    apart = {}
    for name, (kernels, sharded_fn, one_fn) in steps.items():
        p = fresh()
        res, launches = counted_run(name, lambda f=sharded_fn: f(p), kernels)
        out["launches"][name] = launches
        want = one_fn()
        want_loss = want[0][0] if isinstance(want[0], tuple) else want[0]
        got = (res[2], *(p[k].grad for k in ("albedo", "normal", "density")))
        exp = (want_loss, *want[1])
        diffs = [float((a - b).abs().max()) for a, b in zip(got, exp)]
        same = all(torch.equal(bits(a), bits(b)) for a, b in zip(got, exp))
        if max(diffs) > 1e-4:
            raise AssertionError(f"{name}: loss and gradients apart by {diffs}")
        apart[name] = (same, max(diffs))
        q = fresh()
        out["ms"][name] = in_turns({"sharded": lambda f=sharded_fn: f(p),
                                    "unsharded": lambda f=one_fn: unsharded(f, q)},
                                   rounds=2, reps=10)
        out["prof"][name] = {k: path_profile(fn) for k, fn in (
            ("sharded", lambda f=sharded_fn: f(p)),
            ("unsharded", lambda f=one_fn: unsharded(f, q)))}
    say(f"[sharded] {card}: the depth-10 frame at {int(round(o10.shape[0] ** 0.5))}², "
        f"world of one: "
        f"render_sharded == the unsharded frame bit for bit (launches "
        f"{out['launches']['render_sharded']}); " + "; ".join(
            f"{name} (launches {out['launches'][name]}) against the unsharded step: "
            f"loss and gradients {'bit for bit' if s else f'within {m}'}, "
            f"{med_p80(out['ms'][name]['sharded'])[0]:.4f} ms (p80 "
            f"{med_p80(out['ms'][name]['sharded'])[1]:.4f}) against "
            f"{med_p80(out['ms'][name]['unsharded'])[0]:.4f} ms (p80 "
            f"{med_p80(out['ms'][name]['unsharded'])[1]:.4f}) in turns (the same still "
            f"optimizer's update in both), kernels "
            f"{kus(out['prof'][name]['sharded'], 'us')} us in "
            f"{kus(out['prof'][name]['sharded'], 'n')} launches against "
            f"{kus(out['prof'][name]['unsharded'], 'us')} us in "
            f"{kus(out['prof'][name]['unsharded'], 'n')}"
            for name, (s, m) in apart.items()))

    # the trainer, sharded over the world of one
    model = InverseRenderer(ctx["host_svo"], optimize=("albedo",), n_devices=1, device=dev)
    if model.mesh is None or model.mesh.world != 1:
        raise AssertionError("InverseRenderer(n_devices=1) in a world is not sharded")
    mp, mstate = model.init_params(seed=0)
    res10 = int(round(o10.shape[0] ** 0.5))
    view = CameraConfig(**bench_cam, width=res10, height=res10)
    losses = []
    for _ in range(2):
        (mp, mstate, loss_v, resid), launches = counted_run(
            "InverseRenderer.step_view", lambda: model.step_view(
                mp, mstate, view, (-0.5, -1.0, -0.3), tgt),
            {"tile_candidates", "tile_walk", "shade_fwd", "shade_bwd", "segment_sum"})
        losses.append((float(loss_v), int(resid)))
    out["launches"]["InverseRenderer.step_view"] = launches
    if not losses[1][0] < losses[0][0]:
        raise AssertionError(f"InverseRenderer(n_devices=1): the loss does not fall: {losses}")
    say(f"[sharded] InverseRenderer(n_devices=1), two step_view steps on the {res10}² "
        f"view from random albedo: loss, residual {losses} (launches {launches})")
    dist.destroy_process_group()
    out.update(rounds=rounds, n_hit=n_hit)
    return out


def main():
    # ---- 1. device ------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    say(card)
    say(f"[device] {torch.cuda.get_device_name(0)} "
        f"(torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} visible)")

    # ---- 2. build: every library at once ----------------------------------
    t0 = time.perf_counter()
    secs = _build.build_all()
    say(f"[build] esvo_trace (nvcc sm_90a) {secs['esvo_trace']:.2f} s, "
        f"brick_trace (nvcc sm_90a) {secs['brick_trace']:.2f} s, "
        f"tile_walk (nvcc sm_90a) {secs['tile_walk']:.2f} s, "
        f"shade (nvcc sm_90a) {secs['shade']:.2f} s, "
        f"tile_candidates (nvcc sm_90a) {secs['tile_candidates']:.2f} s, "
        f"svo_build (nvcc sm_90a) {secs['svo_build']:.2f} s, "
        f"noise (g++) {secs['noise']:.2f} s, launch (g++, the launcher "
        f"extension) {secs['launch']:.2f} s, side by side in "
        f"{time.perf_counter() - t0:.2f} s, into {_build.BUILD_DIR}")
    ptxas = ptxas_report(_build.build_log("brick_trace"))
    if len(ptxas) != 49:
        raise AssertionError(f"ptxas reported {len(ptxas)} brick_trace.cu kernels, "
                             f"expected 49")
    moved = {name: regs for name, regs, _sp, _sm in ptxas
             if name in EARLIER_REGS and regs != EARLIER_REGS[name]}
    if moved or not set(EARLIER_REGS) <= {row[0] for row in ptxas}:
        raise AssertionError(f"brick_trace.cu's earlier kernels moved: {moved}, "
                             f"expected {EARLIER_REGS}")
    say("[build] brick_trace.cu, ptxas -v (kernel<staged rows, probe, block>, "
        "esvo_stackless_kernel<probe> (its first form), its patched form "
        "esvo_stackless_patched_kernel<probe, LOD> (LOD: esvo_stackless_lod's), "
        "brick_trace_multi's staged and first "
        "forms <probe>, esvo_stackless_multi's first form and its probe form, its "
        "patched form esvo_stackless_multi_patched_kernel<probe>, the two LOD "
        "kernels' first forms, brick_trace_lod's probe form brick_trace_lod_probe_kernel "
        "and its patched form brick_trace_lod_patched_kernel<probe> (its staged rows "
        "dynamic shared memory, 68 B a thread), the stitched traces' first forms clipmap_trace_kernel<brick arena>, "
        "the wide forms clipmap_trace_brick_kernel and clipmap_trace_wide_kernel and "
        "their probe forms clipmap_trace_brick_probe_kernel<wide> and "
        "clipmap_trace_probe_kernel<wide>, "
        "the level-sharded rounds' first form level_round_kernel<mode>, its "
        "probe form and its queued form <mode>, and the queue's kernels "
        "level_queue_*_kernel (the one pass level_queue_lookback_kernel<mode, over a queue>): "
        "registers, spill bytes, shared bytes; the staged form's "
        "slots are dynamic shared memory): "
        + "; ".join(f"{k} {r} regs, {sp} spilled, {sm} B shared" for k, r, sp, sm in ptxas)
        + f"; the main-path and first-form kernels other than the staged form "
        f"at their registers before ({len(EARLIER_REGS)} kernels)")
    say("[build] tile_candidates.cu, ptxas -v (the search form tile_candidates_kernel<warps, "
        "brickmap mode>, the radix form tile_candidates_radix_kernel<warps, brickmap "
        "mode, tiles a warp>, the probe form tile_candidates_probe_kernel<warps, brickmap "
        "mode, form, tiles a warp>, the first form tile_candidates_block_kernel): " + "; ".join(
            f"{k} {r} regs, {sp} spilled" for k, r, sp, _sm in ptxas_report(
                _build.build_log("tile_candidates"))))
    bwd_regs = re.search(r"composite_bwd_kernel.*?\n.*?Used (\d+) registers",
                         _build.build_log("shade"), re.S)
    say(f"[build] shade.cu, ptxas -v: composite_bwd_kernel "
        f"{bwd_regs.group(1) if bwd_regs else 'not found'} registers; " + "; ".join(
            f"{k} {r} registers, {sp} spilled"
            for k, r, sp, _sm in ptxas_report(_build.build_log("shade"))))
    svo_regs = svo_ptxas(_build.build_log("svo_build"))
    if len(svo_regs) != 15:
        raise AssertionError(f"ptxas reported {svo_regs} of svo_build.cu, "
                             "expected 15 kernels")
    say("[build] svo_build.cu, ptxas -v (registers): " + ", ".join(
        f"{k} {r}" for k, r in svo_regs))

    # ---- 3. kernels vs plain versions on the card ---------------------------
    count_plain_calls()
    err = dict(esvo_trace=0.0, esvo_trace_serial=0.0, tile_walk=0.0,
               tile_walk_serial=0.0, tile_candidates=0.0,
               tile_candidates_block=0.0, brick_dda16=0.0, rowread=0.0,
               take=0.0, loop_probe=0.0, loop_probe_serial=0.0, shade_fwd=0.0,
               shade_bwd=0.0,
               shade_bwd_serial=0.0, segment_sum=0.0, segment_sum_sorted=0.0,
               brick_trace=0.0, esvo_stackless=0.0, brick_trace_serial=0.0,
               brick_trace_unstaged=0.0, esvo_stackless_multi=0.0,
               esvo_stackless_serial=0.0, esvo_stackless_lod_serial=0.0,
               brick_trace_lod_serial=0.0,
               esvo_stackless_multi_serial=0.0,
               brick_trace_multi=0.0, brick_trace_multi_serial=0.0, composite_fwd=0.0,
               esvo_stackless_lod=0.0, brick_trace_lod=0.0, composite_bwd=0.0,
               tile_candidates_mapped=0.0, tile_candidates_mapped_first=0.0,
               tile_candidates_radix=0.0, clipmap_trace=0.0, clipmap_trace_brick=0.0,
               clipmap_trace_brick_serial=0.0, clipmap_trace_serial=0.0,
               svo_expand_serial=0.0,
               **{k: 0.0 for k in (*BUILD_KERNELS, *BUILD_FIRST_FORMS)})
    for name, depth in (("sphere", 5), ("terrain", 6)):
        svo = octree.build_svo(get_scene(name), depth).svo.to(dev)
        for n in (1000, 4096):
            o, d = (torch.from_numpy(a).to(dev)
                    for a in random_rays(n, seed=depth + n))
            kern = traverse_cuda._trace_kernel(svo, o, d)
            first = traverse_cuda._trace_serial_kernel(svo, o, d)
            plain = traverse.trace(svo, o, d)
            torch.cuda.synchronize()
            err["esvo_trace"] = max(err["esvo_trace"],
                                    compare(kern, plain, f"{name} d{depth} N={n}"))
            err["esvo_trace_serial"] = max(err["esvo_trace_serial"], compare(
                first, plain, f"first form, {name} d{depth} N={n}"))
            compare(kern, first, f"{name} d{depth} N={n}, against the first form")
            hits = int((kern.hit_leaf >= 0).sum())
            say(f"[parity] esvo_trace {name} depth {depth} N={n}: kernel == plain "
                f"== first form (hit ids, iters, hit_t bitwise), {hits} hits")

    bench_cam = dict(position=(0.5, 0.85, -0.6), look_at=(0.5, 0.4, 0.5),
                     fov_y_deg=50.0)
    small_cam = camera.Camera(**bench_cam, width=128, height=128)
    inside_cam = camera.Camera(position=(0.5, 0.05, 0.5), look_at=(0.5, 0.5, 0.5),
                               fov_y_deg=60.0, width=128, height=128)
    horizon_cam = camera.Camera(position=(0.5, 0.5, -0.3), look_at=(0.5, 0.5, 1.0),
                                fov_y_deg=50.0, width=128, height=128)
    cand_cases = candidate_cases(dev, small_cam, inside_cam, horizon_cam)
    cand_valid = []
    # tiles of the selection's cases in which an intermediate level, the
    # finest level overflows its width, and which see nothing at the finest
    selection = dict(intermediate=0, finest=0, nothing=0)
    for what, args in cand_cases:
        errs, n_valid = check_candidates(args, f"tile_candidates {what}")
        for name, e in errs.items():
            err[name] = max(err[name], e)
        cand_valid.append(n_valid)
        if "narrow" in what or "horizon" in what:
            counts, widths = level_counts(args)
            over = counts > torch.tensor(widths[1:], device=counts.device)
            selection["intermediate"] += int(over[:, :-1].any(dim=1).sum())
            selection["finest"] += int(over[:, -1].sum())
            selection["nothing"] += int((counts[:, -1] == 0).sum())
    if not all(selection.values()):
        raise AssertionError(f"the selection's cases lack a kind of tile: "
                             f"{selection}")
    say(f"[parity] tile_candidates (at the rule's warps a tile and at each of "
        f"{tile_cuda.CANDIDATE_WARPS}) == candidates_plain == "
        f"tile_candidates_block bitwise (codes, ids, t_codes and drop_t bits) "
        f"on {len(cand_cases)} small cases, among them tiles whose "
        f"intermediate levels overflow ({selection['intermediate']}), whose "
        f"finest level overflows ({selection['finest']}) and which see "
        f"nothing ({selection['nothing']}): "
        + ", ".join(f"{what} ({n})" for (what, _a), n in zip(cand_cases, cand_valid))
        + " (valid candidates in brackets)")
    for name, depth in (("terrain", 6), ("terrain", 7), ("flat_ground", 6)):
        ts = tile.make_tile_svo(octree.build_svo(get_scene(name), depth).svo).to(dev)
        o, d, corners, _grid = tile.tile_rays(small_cam, dev)
        for mode in ("main", "enlarged-K", "sub-tile"):
            args = walk_inputs(ts, o, d, corners, mode)
            e_new, e_first, g, hits = check_walk(args, f"tile_walk {name} d{depth} {mode}")
            err["tile_walk"] = max(err["tile_walk"], e_new)
            err["tile_walk_serial"] = max(err["tile_walk_serial"], e_first)
            say(f"[parity] tile_walk {name} d{depth} {mode}: kernel (G={g} by "
                f"the rule, and every G of {tile_cuda.LANES}) == plain == first "
                f"form (hit_leaf, iters, hit_t bitwise), T={args[1].shape[0]} "
                f"P={args[1].shape[1]} K={args[4].shape[1]}, {hits} hits")

    # the per-ray stackless traces, each kernel against its plain version:
    # small trees, the empty tree (one zero brick row) and a depth-4 tree
    # (a top tree of one level); camera rays, rays from a shell, rays from
    # inside the cube
    empty = Scene("empty", lambda x, y, z: np.ones_like(np.asarray(x, np.float32)), 0.0)
    dda_most, parity_lines, n_small = 0, [], 0
    for name, depth in (("sphere", 5), ("terrain", 6), ("terrain", 7),
                        ("flat_ground", 6), ("empty", 5), ("sphere", 4)):
        host = octree.build_svo(empty if name == "empty" else get_scene(name), depth).svo
        small_svo, small_bsvo = host.to(dev), brick.make_brick_svo(host).to(dev)
        found = []
        for kind, o, d in ray_sets(dev, small_cam, 4096, depth):
            what = f"{name} d{depth} {kind} rays N={o.shape[0]}"
            forms = trace_forms(small_bsvo, small_svo, o, d,
                                small_cam.width if kind == "camera" else None)
            plain = {"brick_trace": brick.trace_brick(small_bsvo, o, d, True),
                     "esvo_stackless": traverse.trace_stackless(small_svo, o, d, True)}
            torch.cuda.synchronize()
            for (kname, form), got in forms.items():
                e = compare_stats(got, plain[kname], f"{kname} {form}, {what}")
                if form in FORM_ERR:
                    err[kname + FORM_ERR[form]] = max(err[kname + FORM_ERR[form]], e)
            n_small += 1
            kb, ks = forms[("brick_trace", "main")], forms[("esvo_stackless", "main")]
            dda_most = max(dda_most, int(kb[1][:, STAT("dda_max")].max()))
            hits = int((kb[0].hit_leaf >= 0).sum())
            if name == "empty" and (hits or int((ks[0].hit_leaf >= 0).sum())):
                raise AssertionError(f"{what}: a hit in the empty tree")
            found.append(f"{kind} {hits} hits, "
                         f"{int((kb[0].hit_leaf != ks[0].hit_leaf).sum())} parting")
        parity_lines.append(f"{name} d{depth} (top depth {small_bsvo.top_depth}): "
                            + ", ".join(found))
    if dda_most > 22:
        raise AssertionError(f"a brick walk took {dda_most} DDA steps in one "
                             f"round; an 8^3 brick needs at most 22")
    volumetric_parity(dev, small_cam, torch.tensor([-0.5, -1.0, -0.3], device=dev),
                      err)
    lod_parity(dev, small_cam, err)
    say(f"[parity] brick_trace (through the main path's wrapper, and in its "
        f"forms {brick_cuda.FORMS['brick_trace']}) and esvo_stackless (in its forms "
        f"{brick_cuda.FORMS['esvo_stackless']}, the patched one with the camera's "
        f"width and without), and every "
        f"probe form == their plain versions (brick.trace_brick, "
        f"traverse.trace_stackless) bitwise (hit_leaf, hit_t bits, hit_parent, "
        f"hit_child, iters, and the statistics a ray), on {n_small} cases: "
        f"camera rays (128x128) and 4,096 rays from a shell and from inside "
        f"the cube: " + "; ".join(parity_lines) + f" (hits of brick_trace; rays "
        f"on which the two traces part in hit_leaf); at most {dda_most} DDA "
        f"steps in a round (the cap of {brick.DDA_ROUND_STEPS} never binds)")

    n_dda = 65536
    dda_args = dda_inputs(n_dda, 0, dev)
    kern = brick_dda._dda_kernel(*dda_args, 10, 16)
    plain = brick_dda.dda_steps(dda_args[0], dda_args[1], dda_args[2].bool(),
                                *dda_args[3:], depth=10, steps=16)
    torch.cuda.synchronize()
    err["brick_dda16"] = compare_tensors(
        kern, plain, ("hit_t", "hit_idx9", "t_cur"), "brick_dda16")
    say(f"[parity] brick_dda16 N={n_dda} depth 10, 16 steps: kernel == plain "
        f"(hit_t, hit_idx9, t_cur bitwise), "
        f"{int(torch.isfinite(kern[0]).sum())} hits")

    table = torch.arange(64 * 128, dtype=torch.int32, device=dev).reshape(64, 128)
    cursors = torch.from_numpy(np.random.default_rng(1).integers(
        9, 64, (8, 128)).astype(np.int32)).to(dev)
    rows8 = torch.arange(8, dtype=torch.int32, device=dev) * 3
    # rows that allow 16-byte loads (the probes' table), rows that do not
    # (130 words a row), and rows of 128 words that start 4 bytes off
    narrow = torch.arange(64 * 130, dtype=torch.int32, device=dev).reshape(64, 130)
    shifted = torch.arange(64 * 128 + 1, dtype=torch.int32,
                           device=dev)[1:].view(64, 128)
    cursors3 = cursors.reshape(4, 256)
    row_checks = [
        ("scalar", rowread.rowread_scalar(table, 17), table[17:18]),
        ("scalars", rowread.rowread_scalar(table, [17, 99, -3, 0, 63, 5, 5, 40]),
         table[[17, 63, 0, 0, 63, 5, 5, 40]]),
        ("min", rowread.rowread_min(table, cursors), table[cursors.min().long()][None]),
        ("min batch", rowread.rowread_min_batch(table, cursors3),
         table[cursors3.amin(dim=1).long()]),
        ("rows", rowread.rowread_rows(table, rows8), table[rows8.long()]),
    ]
    for what, other in (("130-word rows", narrow), ("rows 4 bytes off", shifted)):
        row_checks += [
            (f"rows, {what}", rowread.rowread_rows(other, rows8), other[rows8.long()]),
            (f"scalar, {what}", rowread.rowread_scalar(other, 17), other[17:18]),
            (f"min batch, {what}", rowread.rowread_min_batch(other, cursors3),
             other[cursors3.amin(dim=1).long()])]
    torch.cuda.synchronize()
    for mode, got, want in row_checks:
        err["rowread"] = max(err["rowread"], compare_tensors(
            (got,), (want,), (mode,), f"rowread {mode}"))
    say(f"[parity] rowread (64,128) int32: kernel == table[idx] in the scalar, "
        f"min-of-cursors and eight-rows modes and in their batch forms (eight "
        f"scalars a launch, four cursor blocks a launch), with 16-byte loads, "
        f"and with word loads on 130-word rows and on rows 4 bytes off "
        f"({len(row_checks)} checks)")

    cases, (take_table, take_idx), (hot_table, hot_idx) = gather_cases(dev)
    for what, kernel_call, plain_call in cases:
        got, want = kernel_call(), plain_call()
        torch.cuda.synchronize()
        err["take"] = max(err["take"], compare_tensors((got,), (want,), (what,), what))
    say(f"[parity] take: kernel == plain bitwise on {len(cases)} gathers (1-D "
        f"int32 and float32 of 16,384 rows; the one-hot product of 4,096 rows; "
        f"along rows for 8 to 16,384 rows; along lanes)")

    loop_inp = loop_inputs(dev)
    loop_x, loop_table = loop_inp["x"], loop_inp["table"]
    loop_plain_ms = loop_parity(loop_inp, err)

    # ---- 4. the depth-10 SVO -------------------------------------------------
    depth, res = 10, 1024
    cache = os.path.join(_build.BUILD_DIR, f"terrain_d{depth}.npz")
    t0 = time.perf_counter()
    if os.path.exists(cache):
        host_svo, how = checkpoint.load_svo(cache, "cpu"), "cached"
    else:
        host_svo, how = octree.build_svo(get_scene("terrain"), depth).svo, "built"
        checkpoint.save_svo(host_svo, cache)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_ts = tile.make_tile_svo(host_svo)
    say(f"[svo] terrain depth {depth}: {host_svo.n_nodes} nodes, "
        f"{host_svo.n_leaves} leaves, {how} on the host in {build_s:.2f} s; "
        f"{host_ts.bsvo.n_bricks} bricks and {host_ts.pyr.numel()} pyramid "
        f"words in {time.perf_counter() - t0:.2f} s")

    svo = host_svo.to(dev)
    ts = host_ts.to(dev)
    # the stackless trace climbs through parent pointers: derived once on the
    # card (a loaded SVO carries none), held against the host's
    pptr = traverse.derive_parent_ptr(svo.masks, svo.child_base)
    if not torch.equal(pptr.cpu(), torch.from_numpy(octree.compute_parent_ptr(
            host_svo.masks.numpy(), host_svo.child_base.numpy()))):
        raise AssertionError("derive_parent_ptr on the card differs from the host's")
    svo = dataclasses.replace(svo, parent_ptr=pptr)
    bsvo = ts.bsvo
    cam = camera.Camera(**bench_cam, width=res, height=res)
    o, d = cam.rays(dev)
    light = torch.tensor([-0.5, -1.0, -0.3], dtype=torch.float32, device=dev)
    params = (svo.leaf_albedo, svo.leaf_normal, svo.leaf_density)
    n_rays = o.shape[0]

    # ---- 4b. the same tree built on the card (bench.py's BENCH_BUILD=device) ---
    built = build_device(dict(dev=dev, host_svo=host_svo, bsvo=bsvo, o=o, d=d,
                              light=light, params=params, err=err), card)

    # ---- 5. main path, ray by ray ----------------------------------------------
    reset_counts()
    img = diff.render_diff_cuda(*params, svo, o, d, light)
    torch.cuda.synchronize()
    esvo_launches = traverse_cuda.launches
    if (esvo_launches != 1 or shade_cuda.launches["shade_fwd"] != 1
            or traverse_cuda.serial_launches):
        raise AssertionError("the frame did not launch the traversal and the "
                             "shading kernel once each")
    if img.shape != (n_rays, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"bad image: shape {tuple(img.shape)} or non-finite")

    # the frame against its plain version on the same card and inputs
    t0 = time.perf_counter()
    plain = traverse.trace(svo, o, d)
    torch.cuda.synchronize()
    esvo_plain_ms = (time.perf_counter() - t0) * 1e3
    kern = traverse_cuda.trace_cuda(svo, o, d)
    first = traverse_cuda.trace_cuda_serial(svo, o, d)
    err["esvo_trace"] = max(err["esvo_trace"],
                            compare(kern, plain, "terrain d10 frame"))
    err["esvo_trace_serial"] = max(err["esvo_trace_serial"], compare(
        first, plain, "terrain d10 frame, first form"))
    compare(kern, first, "terrain d10 frame, against the first form")
    img_plain = diff.shade_diff_plain(plain.hit_leaf, d, *params, light, 1.3, 0.08)
    img_err = float((img - img_plain).abs().max())
    if img_err > 1e-6:
        raise AssertionError(f"frame differs from the plain path by {img_err}")
    hits = int((kern.hit_leaf >= 0).sum())
    esvo_steps = int(kern.iters.sum())
    say(f"[frame] {res}x{res}: {esvo_launches} kernel launch(es) in the frame, "
        f"{hits} hits, {esvo_steps / n_rays:.2f} steps a ray, hits == plain "
        f"trace == esvo_trace_serial (bitwise: hit_leaf, hit_t, hit_parent, "
        f"hit_child, iters), image == plain path (max abs {img_err}), finite")

    # ---- 5c. main path ray by ray through the brick and stackless traces -----
    per_ray = kern
    voxels = leaf_voxels(host_ts)
    routes = {}
    for route, kname, render, kernel_call, plain_call in (
            ("brick", "brick_trace",
             lambda: diff.render_diff_brick(*params, bsvo, o, d, light),
             lambda: brick_cuda._brick_kernel(bsvo, o, d, True),
             lambda: brick.trace_brick(bsvo, o, d, True)),
            ("plain", "esvo_stackless",
             lambda: diff.render_diff(*params, svo, o, d, light, width=res),
             lambda: brick_cuda._stackless_kernel(svo, o, d, True, res),
             lambda: traverse.trace_stackless(svo, o, d, True))):
        reset_counts()
        img_r = render()
        torch.cuda.synchronize()
        launched = dict(brick_cuda.launches)
        want = dict(brick_trace=int(route == "brick"),
                    esvo_stackless=int(route == "plain"), **MULTI_ZERO)
        other_forms = {**brick_cuda.form_launches, **brick_cuda.probe_launches}
        if (launched != want or any(other_forms.values()) or traverse_cuda.launches
                or shade_cuda.launches["shade_fwd"] != 1
                or any(PLAIN_CALLS.values())):
            raise AssertionError(f"the {route} frame launched {launched} and "
                                 f"{other_forms}, esvo_trace "
                                 f"{traverse_cuda.launches} times, plain calls "
                                 f"{PLAIN_CALLS}; expected {want}")
        if img_r.shape != (n_rays, 3) or not bool(torch.isfinite(img_r).all()):
            raise AssertionError(f"bad {route} image: shape or non-finite")
        # the kernel against its plain version on the same card and inputs
        t0 = time.perf_counter()
        plain_r = plain_call()
        torch.cuda.synchronize()
        route_plain_ms = (time.perf_counter() - t0) * 1e3
        res_r, st_r = kernel_call()
        err[kname] = max(err[kname], compare_stats(
            (res_r, st_r), plain_r, f"{kname}, terrain d10 frame"))
        img_plain_r = diff.shade_diff_plain(plain_r[0].hit_leaf, d, *params,
                                            light, 1.3, 0.08)
        img_err_r = float((img_r - img_plain_r).abs().max())
        if img_err_r > 1e-6:
            raise AssertionError(f"{route} frame differs from its plain path by "
                                 f"{img_err_r}")
        # rays on which the route parts from esvo_trace, to the referee; a
        # ray that this route's bound stopped is counted, not excused
        unfinished = st_r[:, STAT("unfinished")] == 1
        differ = res_r.hit_leaf != per_ray.hit_leaf
        n_differ = int(differ.sum())
        if n_differ > MAX_DIFFER + int(unfinished.sum()):
            raise AssertionError(f"{route} frame: {n_differ} rays hit another "
                                 f"leaf than esvo_trace")
        verdict_r = referee(
            voxels, depth, o[differ].cpu().numpy(), d[differ].cpu().numpy(),
            dict(route=res_r.hit_leaf[differ].cpu().numpy(),
                 per_ray=per_ray.hit_leaf[differ].cpu().numpy()))
        cut_here = unfinished[differ].cpu().numpy()
        wrong = ~verdict_r["route"] & ~cut_here
        if wrong.any():
            raise AssertionError(f"{route} frame: wrong on {int(wrong.sum())} "
                                 f"finished rays of the {n_differ} where it parts "
                                 f"from esvo_trace")
        per_ray_cut = differ & (per_ray.iters >= traverse.max_iters_for_depth(depth))
        routes[route] = dict(res=res_r, stats=st_r, differ=differ,
                             unfinished=unfinished, plain_ms=route_plain_ms,
                             launches=launched[kname])
        say(f"[frame-{route}] {res}x{res} depth {depth}: {kname} (its "
            f"{MAIN_FORM[kname]} form) launched {launched[kname]} time(s) in the frame, shade_fwd once, no "
            f"other form and no plain call; " + route_line(res_r, st_r) + f"; kernel == plain version "
            f"on the card, bitwise (hit_leaf, hit_t, hit_parent, hit_child, "
            f"iters, statistics; the plain version {route_plain_ms:.1f} ms, n=1); "
            f"image == plain path (max abs {img_err_r}); parts from esvo_trace "
            f"on {n_differ} rays, where the float64 referee finds this route "
            f"right on {int(verdict_r['route'].sum())} and esvo_trace right on "
            f"{int(verdict_r['per_ray'].sum())}; of them {int(cut_here.sum())} "
            f"stopped unfinished at this route's bound (the referee finds "
            f"esvo_trace right on {int(verdict_r['per_ray'][cut_here].sum())} of "
            f"those) and {int(per_ray_cut.sum())} ran into esvo_trace's "
            f"{traverse.max_iters_for_depth(depth)}-step bound")
    both = ~routes["plain"]["unfinished"]
    apart = both & (routes["brick"]["res"].hit_leaf != routes["plain"]["res"].hit_leaf)
    say(f"[frame-brick] the brick and stackless frames part on {int(apart.sum())} "
        f"of the rays the stackless trace finishes (each refereed above where it "
        f"parts from esvo_trace), and the brick trace finishes all "
        f"{int((~both).sum())} that the stackless trace leaves: "
        f"{int((routes['brick']['res'].hit_leaf[~both] >= 0).sum())} of them hits")

    # ---- 5d. every form of the two traces on the frame, and their warps -------
    reference = {"brick_trace": (routes["brick"]["res"], routes["brick"]["stats"]),
                 "esvo_stackless": (routes["plain"]["res"], routes["plain"]["stats"])}
    for (kname, form), got in trace_forms(bsvo, svo, o, d, res).items():
        e = compare_stats(got, reference[kname], f"{kname} {form}, terrain d10 frame")
        if form in FORM_ERR:
            err[kname + FORM_ERR[form]] = max(err[kname + FORM_ERR[form]], e)
    torch.cuda.synchronize()
    say(f"[frame-forms] {res}x{res} depth {depth}: brick_trace in its forms "
        f"{brick_cuda.FORMS['brick_trace']}, esvo_stackless in its forms "
        f"{brick_cuda.FORMS['esvo_stackless']} (the patched one with the image's "
        f"width and without), and every probe form "
        f"== the plain versions bitwise (hit_leaf, hit_t, hit_parent, hit_child, "
        f"iters, statistics)")
    warp_counts = {}
    for kname in ("brick_trace", "esvo_stackless"):
        for form in brick_cuda.FORMS[kname]:
            width = res if form == "patched" else None
            probe = (brick_cuda.probe_brick_cuda(bsvo, o, d, form) if kname == "brick_trace"
                     else brick_cuda.probe_stackless_cuda(svo, o, d, form, width))
            torch.cuda.synchronize()
            compare_stats(probe[:2], reference[kname], f"{kname} {form} probe, frame")
            warp_counts[(kname, form)] = warps_line(kname, form, probe[2],
                                              reference[kname][0].iters.cpu().numpy(),
                                              width)
    say("[warps] the probe forms' results == the plain versions' bitwise; issue "
        "and lane counts are exact, cycle shares inside divergent code are "
        "approximate (another branch's lanes may run between a phase's two "
        "clock reads); times from the card's global timer")

    # ---- 5b. the shading kernels on that frame vs their plain versions ----------
    hit_leaf = kern.hit_leaf
    n_leaves = svo.n_leaves
    rng = np.random.default_rng(10)
    as_dev = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    density = rng.uniform(-0.2, 1.3, n_leaves)
    density[::7], density[3::7] = 1.0, 0.0     # ties of the clip
    perturbed = (
        params[0] * as_dev(rng.uniform(0.5, 1.0, (n_leaves, 1))),
        params[1] * as_dev(rng.uniform(0.5, 2.0, (n_leaves, 1))),
        as_dev(density))
    sky_tex = sky_texture(d, as_dev(make_gradient_skybox()
                                    * rng.uniform(0.5, 1.0, (64, 128, 3))))
    g_unit = as_dev(rng.uniform(-0.5, 0.5, (n_rays, 3)))
    fwd_bits = 0
    for what, pset, sky in (("the scene's parameters", params, None),
                            ("perturbed parameters", perturbed, None),
                            ("perturbed parameters, textured sky", perturbed,
                             sky_tex)):
        got = shade_cuda.shade_fwd(hit_leaf, d, *pset, light, 1.3, 0.08, sky)
        want = diff.shade_diff_plain(hit_leaf, d, *pset, light, 1.3, 0.08, sky)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        if got.shape != want.shape or not e <= 1e-6:
            raise AssertionError(f"shade_fwd, {what}: max abs {e} against the "
                                 f"plain version")
        err["shade_fwd"] = max(err["shade_fwd"], e)
        fwd_bits += int((bits(got) != bits(want)).any(dim=1).sum())
        got = shade_cuda.shade_bwd(g_unit, hit_leaf, d, *pset, light, 1.3, 0.08, sky)
        want = shade_cuda.shade_bwd_plain(g_unit, hit_leaf, d, *pset, light,
                                          1.3, 0.08, sky)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-6):
            raise AssertionError(f"shade_bwd, {what}: max abs {e} against "
                                 f"autograd through the plain version")
        if bool(got[hit_leaf < 0].any()):
            raise AssertionError("shade_bwd: a miss has a cotangent")
        err["shade_bwd"] = max(err["shade_bwd"], e)
        first = check_bwd_forms(got, (g_unit, hit_leaf, d, *pset, light, 1.3,
                                      0.08, sky), f"shade_bwd, {what}")
        err["shade_bwd_serial"] = max(err["shade_bwd_serial"], float(
            (first - want).abs().max()))
    # the cotangent 4 bytes off a 16-byte boundary: the word-by-word staging
    g_off = torch.empty(n_rays * 3 + 1, device=dev)[1:].view(n_rays, 3)
    g_off.copy_(g_unit)
    check_bwd_forms(shade_cuda.shade_bwd(g_off, hit_leaf, d, *perturbed, light,
                                         1.3, 0.08),
                    (g_unit, hit_leaf, d, *perturbed, light, 1.3, 0.08),
                    "shade_bwd, a cotangent 4 bytes off")
    say(f"[parity] shade_fwd on the {res}x{res} frame, three parameter sets: "
        f"max abs {err['shade_fwd']} against the plain version (limit 1e-6), "
        f"{fwd_bits} of {3 * n_rays} pixels differ in bits; shade_bwd with a "
        f"cotangent in [-0.5, 0.5): == shade_bwd_serial bitwise (also on a "
        f"cotangent 4 bytes off a 16-byte boundary), max abs "
        f"{err['shade_bwd']} against autograd "
        f"through the plain version (rtol 1e-5, atol 1e-6), rows of misses "
        f"zero")

    keys, order = shade_cuda.sort_by_leaf(hit_leaf, n_leaves)
    safe_leaf = torch.where(hit_leaf >= 0, hit_leaf, 0)
    seg_plain_err = 0.0
    for what, g in (("a unit cotangent", g_unit),
                    ("the step's cotangent", 2.0 * img / img.numel())):
        cot = shade_cuda.shade_bwd(g, hit_leaf, d, *perturbed, light, 1.3, 0.08)
        check_bwd_forms(cot, (g, hit_leaf, d, *perturbed, light, 1.3, 0.08),
                        f"shade_bwd, {what}")
        sums, e_new, e_sorted = check_segment_sum(what, cot, hit_leaf, n_leaves)
        err["segment_sum"] = max(err["segment_sum"], e_new)
        err["segment_sum_sorted"] = max(err["segment_sum_sorted"], e_sorted)
        plain_sums = diff._segment_reduce_cols(safe_leaf, cot, n_leaves)
        e = float((sums - plain_sums).abs().max())
        if not e <= 1e-4:
            raise AssertionError(f"segment_sum, {what}: {e} off the plain sort "
                                 f"+ running-sum form")
        seg_plain_err = max(seg_plain_err, e)
    seg_cot = cot
    say(f"[parity] segment_sum, {n_rays} rows into {n_leaves} leaves, two "
        f"cotangents: the sort-free kernels == serial float32 scatter-add in "
        f"ray order == the sorted form, bitwise with the sign of zero; two "
        f"runs bitwise equal; max abs {seg_plain_err} off the plain sort + "
        f"running-sum form (limit 1e-4)")

    # long runs, which take the block-a-leaf route: one leaf hit by 70,000
    # more rays (sorted in place in the ray list), a few hundred leaves with
    # 17 to 2,048 rays (sorted in shared memory), and every hit on one leaf.
    # The rows are random with -0.0 among them, the misses' rows too: a miss
    # adds nothing whatever its row holds.
    wild = rng.uniform(-0.5, 0.5, (n_rays, 7)).astype(np.float32)
    wild[rng.random((n_rays, 7)) < 0.2] = np.float32(-0.0)
    wild = torch.from_numpy(wild).to(dev)
    long_leaf = hit_leaf.clone()
    pick = torch.from_numpy(rng.permutation(n_rays)).to(dev)
    long_leaf[pick[:70000]] = 12345
    at = 70000
    for k, run in enumerate((17, 18, 31, 33, 100, 511, 512, 513, 1000, 2047,
                             2048, 2049, 4097) * 20):
        long_leaf[pick[at:at + run]] = 20000 + 7 * k
        at += run
    long_leaf[pick[at:at + 50000]] = n_leaves + 5          # clamps to the last
    longest = int(torch.bincount(long_leaf[long_leaf >= 0].long().clamp(
        max=n_leaves - 1)).max())
    if longest < 65536:
        raise AssertionError(f"the long-run case's longest run is {longest}")
    seg_case_ms = {}
    for what, leafs, leaves in (
            (f"one leaf hit by {longest} rays and 260 leaves given 17 to 4,097 "
             f"more",
             long_leaf, n_leaves),
            (f"one leaf in all, hit by {hits} rays", hit_leaf, 1)):
        _sums, e_new, e_sorted = check_segment_sum(what, wild, leafs, leaves)
        err["segment_sum"] = max(err["segment_sum"], e_new)
        err["segment_sum_sorted"] = max(err["segment_sum_sorted"], e_sorted)
        seg_case_ms[what] = (
            float(np.median(cuda_ms(lambda: shade_cuda.segment_sum(
                wild, leafs, leaves), 3, 1))),
            float(np.median(cuda_ms(lambda: shade_cuda.segment_sum_sorted(
                wild, *shade_cuda.sort_by_leaf(leafs, leaves), leaves), 3, 1))))
    say("[parity] segment_sum on long runs, random rows with -0.0 and with "
        "rows on the misses: == serial scatter-add == the sorted form, "
        "bitwise, two runs equal; " + "; ".join(
            f"{what}: {new:.4f} ms (the sorted form with its sort {old:.4f})"
            for what, (new, old) in seg_case_ms.items()) + " (medians of 3)")

    # ---- 6. main path, tile by tile ----------------------------------------------
    o_t, d_t, corners, grid = tile.tile_rays(cam, dev)
    reset_counts()
    img_t, residual = diff.render_diff_tile(*params, ts, o_t, d_t, corners,
                                            light, **TILE_BUDGETS)
    torch.cuda.synchronize()
    tile_launches = tile_cuda.launches
    cand_launches = tile_cuda.candidates_launches
    if tile_launches != 3 or cand_launches != 3:
        raise AssertionError(f"the tile frame launched the walker "
                             f"{tile_launches} times and tile_candidates "
                             f"{cand_launches} times, expected 3 each")
    if PLAIN_CALLS["candidates_plain"]:
        raise AssertionError(f"the tile frame called candidates_plain "
                             f"{PLAIN_CALLS['candidates_plain']} times")
    if (traverse_cuda.launches or brick_dda.launches or rowread.launches
            or tile_cuda.serial_launches or tile_cuda.candidates_block_launches
            or shade_cuda.launches["shade_fwd"] != 1):
        raise AssertionError("the tile frame launched a kernel it has no use "
                             "for, or not the shading kernel once")
    if img_t.shape != (n_rays, 3) or not bool(torch.isfinite(img_t).all()):
        raise AssertionError("bad tile image: shape or non-finite")
    n_residual = int(residual)

    # hits against the per-ray kernel on the same (tile-major) rays
    o_f, d_f = o_t.reshape(-1, 3), d_t.reshape(-1, 3)
    golden = traverse_cuda.trace_cuda(svo, o_f, d_f)
    res_fb, mask = tile.trace_tile_fb(ts, o_t, d_t, corners, **TILE_BUDGETS)
    if int(mask.sum()) != n_residual:
        raise AssertionError("residual count differs between two frames")
    # The two traversals are different algorithms and may part on a few
    # rays: a ray that only grazes a voxel's corner, and a ray on which the
    # per-ray ESVO walk runs into its step bound. Every ray on which they
    # part goes to a float64 referee; the tile frame must be right on each.
    ok = ~mask
    differ = ok & (res_fb.hit_leaf != golden.hit_leaf)
    n_differ = int(differ.sum())
    if n_differ > MAX_DIFFER:
        raise AssertionError(f"tile frame: {n_differ} resolved rays hit another "
                             f"leaf than the per-ray kernel")
    at_bound = differ & (golden.iters >= traverse.max_iters_for_depth(depth))
    verdict = referee(
        leaf_voxels(host_ts), depth, o_f[differ].cpu().numpy(),
        d_f[differ].cpu().numpy(),
        dict(tile=res_fb.hit_leaf[differ].cpu().numpy(),
             per_ray=golden.hit_leaf[differ].cpu().numpy()))
    if not verdict["tile"].all():
        raise AssertionError(
            f"tile frame: wrong on {int((~verdict['tile']).sum())} of the "
            f"{n_differ} rays where it parts from the per-ray kernel")
    same = ok & ~differ
    hit = same & (golden.hit_leaf >= 0)
    # hit_t is the largest of the plane crossings on the ray's way in; the
    # two walks cross other planes on the way to the same voxel, and a
    # rounded crossing may exceed a later one, so a few hits differ by ULPs
    t_off = hit & (bits(res_fb.hit_t) != bits(golden.hit_t))
    n_t_off = int(t_off.sum())
    t_off_max = float((res_fb.hit_t - golden.hit_t)[t_off].abs().max()) if n_t_off else 0.0
    if n_t_off > MAX_DIFFER or t_off_max > HIT_T_ATOL:
        raise AssertionError(f"tile frame: hit_t differs on {n_t_off} resolved "
                             f"hits of the same leaf, by up to {t_off_max}")
    # the exact trace: the tile frame's hits with every residual ray replaced
    # by the per-ray kernel's
    exact = tile.trace_tile_exact(ts, svo, o_t, d_t, corners, **TILE_BUDGETS)
    want_leaf = torch.where(mask, golden.hit_leaf, res_fb.hit_leaf)
    want_t = torch.where(mask, golden.hit_t, res_fb.hit_t)
    if not (torch.equal(exact.hit_leaf, want_leaf)
            and torch.equal(bits(exact.hit_t), bits(want_t))):
        raise AssertionError("trace_tile_exact is not the tile frame with its "
                             "residual rays re-traced")
    if not torch.equal(exact.hit_leaf[~differ], golden.hit_leaf[~differ]):
        raise AssertionError("trace_tile_exact differs from the per-ray kernel "
                             "beyond the refereed rays")
    keep = ~tile.untile_image(mask | differ, grid)
    img_tile_err = float((tile.untile_image(img_t, grid)[keep] - img[keep]).abs().max())
    if img_tile_err > 1e-6:
        raise AssertionError(f"tile image differs from the per-ray frame's by "
                             f"{img_tile_err}")

    # the frame's three phase-1 calls and three walks (main, enlarged-K,
    # sub-tile) with the very arguments the frame gives them: each call held
    # bitwise against candidates_plain, each walk against the plain walk and
    # the first form, at the rule's G and at every G
    walks, cands = [], []
    walk_kernel, cand_kernel = tile_cuda.tile_walk, tile_cuda.candidates
    tile_cuda.tile_walk = lambda *args: walks.append(args) or walk_kernel(*args)
    tile_cuda.candidates = lambda *args, **kw: cands.append(args) or cand_kernel(*args, **kw)
    try:
        tile.trace_tile_fb(ts, o_t, d_t, corners, **TILE_BUDGETS)
    finally:
        tile_cuda.tile_walk, tile_cuda.candidates = walk_kernel, cand_kernel
    if len(walks) != 3 or len(cands) != 3:
        raise AssertionError(f"the tile frame made {len(walks)} walks and "
                             f"{len(cands)} phase-1 calls, expected 3 each")
    cand_rows = {}
    for cname, args in zip(CAND_CALLS, cands):
        errs, n_valid = check_candidates(args, f"tile_candidates d10 frame, {cname}")
        for name, e in errs.items():
            err[name] = max(err[name], e)
        n_bytes, n_ops, widths = candidate_work(args)
        b = bound(n_bytes, n_ops)
        cand_rows[cname] = dict(
            T=args[2].shape[0], K=args[6], widths=widths,
            warps=tile_cuda.candidate_warps(widths),
            children_a_tile=8 * sum(widths[:-1]),
            widest_sort=max(8 * w for w in widths[:-1]),
            valid_a_tile=n_valid / args[2].shape[0], bytes=n_bytes, ops=n_ops,
            bound_ms=b[0], bound_by=b[1])
    say("[parity] tile_candidates d10 frame: kernel (at the rule's warps a "
        "tile and at each) == candidates_plain == tile_candidates_block bitwise "
        "(codes, ids, t_codes and drop_t bits) on the frame's three calls: "
        + "; ".join(f"{c} T={r['T']} K={r['K']} widths {r['widths']} "
                    f"({r['children_a_tile']} child slots a tile, widest level "
                    f"{r['widest_sort']}), {r['warps']} warps a tile by the "
                    f"rule, {r['valid_a_tile']:.2f} valid a tile"
                    for c, r in cand_rows.items()))
    say("[work] valid keys a tile at each level of the frame's phase-1 calls, "
        "mean/largest of the width kept there (tiles above the width): "
        + "; ".join(work_line(c, a) for c, a in zip(CAND_CALLS, cands)))
    WALKS = ("main", "enlarged-K", "sub-tile")
    walk_rows = {}
    for wname, args in zip(WALKS, walks):
        e_new, e_first, g, _hits = check_walk(args, f"tile_walk d10 frame, {wname}")
        err["tile_walk"] = max(err["tile_walk"], e_new)
        err["tile_walk_serial"] = max(err["tile_walk_serial"], e_first)
        iters_w = tile_cuda._walk_kernel(*args)[2]
        g, blocks, threads = walk_shape(args)
        b = walk_bound(args, iters_w)
        walk_rows[wname] = dict(
            T=args[1].shape[0], P=args[1].shape[1], K=args[4].shape[1], G=g,
            blocks=blocks, threads=threads, bound_ms=b[0], bound_by=b[1],
            dda_steps_a_ray=float(iters_w.float().mean()))
        say(f"[frame-tile] walk {wname}: T={args[1].shape[0]} P={args[1].shape[1]} "
            f"K={args[4].shape[1]}, G={g} lanes a ray, {blocks} blocks of "
            f"{threads} threads, {float(iters_w.float().mean()):.2f} DDA steps a "
            f"ray, bound {b[0]:.5f} ms ({b[1]}); kernel at every G == plain == "
            f"first form, bitwise")
    main_args = walks[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_w = tile.walk_plain(*main_args)
    torch.cuda.synchronize()
    walk_plain_ms = (time.perf_counter() - t0) * 1e3
    ids_main = main_args[4]
    dda_steps_main = int(plain_w[2].sum())
    say(f"[frame-tile] {res}x{res} in {o_t.shape[0]} tiles: {tile_launches} "
        f"walker launches in the frame, {n_residual} residual rays, "
        f"{int((res_fb.hit_leaf >= 0).sum())} hits; resolved hits == per-ray "
        f"kernel on all but {n_differ} rays, hit_t bitwise on all but "
        f"{n_t_off} of them (max abs {t_off_max}); on the {n_differ} the "
        f"float64 referee finds the tile frame right on "
        f"{int(verdict['tile'].sum())} and the per-ray kernel right on "
        f"{int(verdict['per_ray'].sum())} ({int(at_bound.sum())} of them ran "
        f"into its {traverse.max_iters_for_depth(depth)}-step bound); "
        f"trace_tile_exact == the tile frame with residual rays re-traced, and "
        f"== per-ray kernel off the refereed rays; image == per-ray frame off "
        f"them (max abs {img_tile_err}); main walk: "
        f"{int((ids_main >= 0).sum()) / ids_main.shape[0]:.1f} candidates a "
        f"tile, {dda_steps_main / n_rays:.2f} DDA steps a ray, kernel == plain")

    # ---- 7. the probe kernels at the probes' sizes --------------------------
    reset_counts()
    dda_out = brick_dda.brick_dda16(dda_args[0], dda_args[1], dda_args[2],
                                    *dda_args[3:], depth=10, steps=16)
    rowread.rowread_scalar(table, 17)
    rowread.rowread_min(table, cursors)
    rowread.rowread_rows(table, rows8)
    for _what, kernel_call, _plain in cases:
        kernel_call()
    loop_out = [gather.loop_probe(*loop_call(loop_inp, case)) for case in LOOP_TIMED]
    gather.loop_probe_serial(*loop_call(loop_inp, (2048, 0)))
    shade_cuda.segment_sum_sorted(seg_cot, keys, order, n_leaves)
    traverse_cuda.trace_cuda_serial(svo, o, d)
    tile_cuda.tile_walk_serial(*main_args)
    tile_cuda.candidates_block(*cands[0])
    # phase 1's other kernels, off every main path: the brickmap mode's first
    # form (on a seeded permutation of the bricks), the radix form unmapped,
    # and the probe form
    probe_brickmap = torch.randperm(
        8 ** cands[0][4], generator=torch.Generator().manual_seed(0)).to(
            device=dev, dtype=torch.int32)
    tile_cuda.candidates(*cands[0], brickmap=probe_brickmap, form="first")
    tile_cuda.candidates(*cands[0], form="radix")
    tile_cuda.probe_candidates(*cands[0], form="radix")
    shade_cuda.shade_bwd_serial(g_unit, hit_leaf, d, *params, light, 1.3, 0.08)
    brick_cuda.trace_brick_cuda_serial(bsvo, o, d)
    brick_cuda._brick_unstaged_kernel(bsvo, o, d)
    brick_cuda.trace_brick_multi_cuda_serial(bsvo, o, d, VOLUME_K)
    brick_cuda.trace_stackless_cuda_serial(svo, o, d)
    brick_cuda.trace_lod_cuda_serial(svo, o, d, LOD_C0)
    brick_cuda.trace_brick_lod_cuda_serial(bsvo, o, d, LOD_C0)
    brick_cuda.trace_multi_cuda_serial(svo, o, d, VOLUME_K)
    torch.cuda.synchronize()
    dda_launches, row_launches = brick_dda.launches, rowread.launches
    first_launches = dict(esvo_trace_serial=traverse_cuda.serial_launches,
                          tile_walk_serial=tile_cuda.serial_launches,
                          tile_candidates_block=tile_cuda.candidates_block_launches,
                          tile_candidates_mapped_first=tile_cuda.candidates_mapped_first_launches,
                          tile_candidates_radix=tile_cuda.candidates_radix_launches,
                          tile_candidates_probe=tile_cuda.candidates_probe_launches,
                          shade_bwd_serial=shade_cuda.launches["shade_bwd_serial"],
                          **brick_cuda.form_launches)
    take_launches = gather.launches["take"]
    loop_launches = gather.launches["loop_probe"]
    first_launches["loop_probe_serial"] = gather.launches["loop_probe_serial"]
    sorted_launches = shade_cuda.launches["segment_sum_sorted"]
    if (dda_launches != 1 or row_launches != 3 or take_launches != len(cases)
            or loop_launches != 5 or sorted_launches != 1
            or first_launches != dict(esvo_trace_serial=1, tile_walk_serial=1,
                                      tile_candidates_block=1,
                                      tile_candidates_mapped_first=1,
                                      tile_candidates_radix=1, tile_candidates_probe=1,
                                      shade_bwd_serial=1,
                                      brick_trace_serial=1, brick_trace_unstaged=1,
                                      brick_trace_multi_serial=1, level_round_serial=0,
                                      clipmap_trace_brick_serial=0, clipmap_trace_serial=0,
                                      level_queue_serial=0, esvo_stackless_serial=1,
                                      esvo_stackless_lod_serial=1,
                                      esvo_stackless_multi_serial=1,
                                      brick_trace_lod_serial=1, loop_probe_serial=1)
            or any(brick_cuda.launches.values())
            or traverse_cuda.launches or tile_cuda.launches
            or tile_cuda.candidates_launches or tile_cuda.candidates_mapped_launches
            or shade_cuda.launches["shade_bwd"]):
        raise AssertionError("the probes did not launch their kernels")
    if not all(bool(((x >= 0) & (x < 1.001)).all()) for x in loop_out[:-1]):
        raise AssertionError("loop_probe: a fraction left [0, 1)")
    if not bool(torch.isfinite(dda_out[2]).all()):
        raise AssertionError("brick_dda16: non-finite t_cur")
    # the DDA steps this data takes: walking rays, step by step
    bpos, t_cur, walking = dda_args[0], dda_args[1], dda_args[2].bool()
    rw, hit_t = dda_args[3], dda_args[7]
    word_of = lambda wsel: torch.gather(rw, 0, wsel.long()[None])[0]
    dda_walked = 0
    for _ in range(16):
        dda_walked += int(walking.sum())
        bpos, t_cur, hit_now, _exit, walking, _idx9 = brick_dda.dda_step(
            bpos, t_cur, walking, hit_t, dda_args[4], dda_args[5], dda_args[6],
            word_of, 10)
        hit_t = torch.where(hit_now, t_cur, hit_t)
    say(f"[probes] brick_dda16 N={n_dda}: {dda_launches} launch, "
        f"{dda_walked / n_dda:.2f} steps a ray; rowread: {row_launches} "
        f"launches (scalar, min, rows); take: {take_launches} launches; "
        f"loop_probe: {loop_launches} launches; segment_sum_sorted (the "
        f"sorted form, off the training path): {sorted_launches} launch; the "
        f"first forms and the unstaged wide form, off the main path: {first_launches}")

    # ---- 7b. the training step, on all four traversals -----------------------
    hit_tile = res_fb.hit_leaf
    d_flat = d_t.reshape(-1, 3)
    target_rand = torch.from_numpy(np.random.default_rng(11).random(
        (n_rays, 3), dtype=np.float32)).to(dev)
    touched = torch.bincount(hit_leaf[hit_leaf >= 0].long(), minlength=n_leaves) > 0
    grads_by_path = {}
    train_launches = {}
    for what, target in (("target 0", torch.zeros_like(target_rand)),
                         ("a seeded random target", target_rand)):
        steps = (
            ("per-ray", lambda: diff.loss_and_grads_cuda(
                *params, svo, o, d, light, target), hit_leaf, d, target),
            ("tile", lambda: diff.loss_and_grads_tile(
                *params, ts, o_t, d_t, corners, light,
                tile.tile_pixels(target, grid), **TILE_BUDGETS),
             hit_tile, d_flat, tile.tile_pixels(target, grid)),
            ("brick", lambda: diff.loss_and_grads_brick(
                *params, bsvo, o, d, light, target),
             routes["brick"]["res"].hit_leaf, d, target),
            ("plain", lambda: diff.loss_and_grads(
                *params, svo, o, d, light, target, width=res),
             routes["plain"]["res"].hit_leaf, d, target))
        for path, step, leafs, dirs, tgt in steps:
            reset_counts()
            out, grads = step()
            torch.cuda.synchronize()
            counts = dict(esvo_trace=traverse_cuda.launches,
                          tile_walk=tile_cuda.launches,
                          tile_candidates=tile_cuda.candidates_launches,
                          tile_candidates_block=tile_cuda.candidates_block_launches,
                          **brick_cuda.launches, **PLAIN_CALLS,
                          **shade_cuda.launches)
            others = [k for c in BRICK_COUNTS[1:] for k, v in c.items() if v]
            want = dict(esvo_trace=int(path == "per-ray"),
                        tile_walk=3 if path == "tile" else 0,
                        tile_candidates=3 if path == "tile" else 0,
                        tile_candidates_block=0,
                        brick_trace=int(path == "brick"),
                        esvo_stackless=int(path == "plain"),
                        candidates_plain=0, trace_brick=0, trace_stackless=0,
                        trace_multi=0, trace_brick_multi=0, composite_plain=0,
                        shade_fwd=1, shade_bwd=1, shade_bwd_serial=0,
                        segment_sum=1, segment_sum_sorted=0, composite_fwd=0,
                        **MULTI_ZERO, **STEP_ZERO)
            if counts != want or others:
                raise AssertionError(f"{path} step, {what}: launches {counts}, "
                                     f"expected {want}; other forms: {others}")
            train_launches[path] = counts
            loss, n_res = (out[0], int(out[1])) if path == "tile" else (out, 0)
            if not bool(torch.isfinite(loss)) or n_res != 0:
                raise AssertionError(f"{path} step, {what}: loss {float(loss)}, "
                                     f"{n_res} residual rays")
            # the same loss through the plain autograd path on the card
            loss_plain, grads_plain = diff._value_and_grads(
                lambda a, n, s: torch.mean((diff.shade_diff_plain(
                    leafs, dirs, a, n, s, light, 1.3, 0.08) - tgt) ** 2), *params)
            worst, scale = check_grads(grads, grads_plain, f"{path} step, {what}")
            # the tight check: builtin autograd over the hit rows. A leaf one
            # ray hits has a gradient some hundredth of the largest, so the
            # absolute tolerance is scaled to the run.
            tight_atol = 1e-6 * scale
            worst_tight, _ = check_grads(
                grads, builtin_grads(leafs, dirs, tgt, params, light),
                f"{path} step, {what}, against builtin autograd", atol=tight_atol)
            if not torch.allclose(loss, loss_plain, rtol=1e-5):
                raise AssertionError(f"{path} step, {what}: loss {float(loss)} "
                                     f"against plain {float(loss_plain)}")
            touched_p = torch.bincount(leafs[leafs >= 0].long(),
                                       minlength=n_leaves) > 0
            if path != "tile" and bool(join7(grads)[~touched_p].any()):
                raise AssertionError(f"{path} step, {what}: a leaf no ray hit "
                                     f"has a gradient")
            grads_by_path[(path, what)] = grads
            say(f"[train] {path} step, {what}: launches {counts}; loss "
                f"{float(loss):.6f}; gradients within rtol 1e-5 / atol "
                f"{tight_atol:.1e} (1e-6 of the largest gradient, {scale:.3e}) "
                f"of builtin autograd through plain indexing of the hit rows "
                f"(max abs {worst_tight:.3e}), and within rtol 1e-5 / atol 1e-7 "
                f"of the plain sort + running-sum backward on the card (max "
                f"abs {worst:.3e}); "
                + (f"{int(touched_p.sum())} of {n_leaves} leaves touched, the "
                   f"others exactly zero" if path != "tile" else
                   f"{n_res} residual rays"))
        # the two traversals give the same gradients, off the leaves of the
        # rays the referee judged (their rows differ by those rays' terms);
        # the rays of a leaf add in another order (row-major, tile-major)
        refereed = torch.cat([res_fb.hit_leaf[mask | differ],
                              golden.hit_leaf[mask | differ]])
        keep = torch.ones(n_leaves, dtype=torch.bool, device=dev)
        keep[refereed[refereed >= 0].long()] = False
        a = join7(grads_by_path[("per-ray", what)])[keep]
        b = join7(grads_by_path[("tile", what)])[keep]
        paths_err = float((a - b).abs().max())
        if not paths_err <= 1e-5 * float(a.abs().max()):
            raise AssertionError(f"{what}: the two traversals' gradients differ "
                                 f"by {paths_err}")
        say(f"[train] {what}: per-ray and tile gradients agree on the "
            f"{int(keep.sum())} leaves off the refereed rays (max abs "
            f"{paths_err:.3e}, limit 1e-5 of the largest gradient "
            f"{float(a.abs().max()):.3e})")
        # the brick and stackless steps against the per-ray step, off the
        # leaves of the rays where their frames part from esvo_trace (the
        # rays of a leaf add in the same order: all three are row-major)
        for path in ("brick", "plain"):
            parted = routes[path]["differ"]
            off = torch.cat([routes[path]["res"].hit_leaf[parted],
                             per_ray.hit_leaf[parted]])
            keep = torch.ones(n_leaves, dtype=torch.bool, device=dev)
            keep[off[off >= 0].long()] = False
            a = join7(grads_by_path[("per-ray", what)])[keep]
            b = join7(grads_by_path[(path, what)])[keep]
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: the {path} step's gradients differ "
                                     f"from the per-ray step's off the refereed "
                                     f"rays by {float((a - b).abs().max())}")
            say(f"[train] {what}: the {path} step's gradients == the per-ray "
                f"step's, bitwise, on the {int(keep.sum())} leaves off the "
                f"{int(parted.sum())} rays where the frames part")

    # three Adam steps on the view, from random albedo towards the scene's own
    model = InverseRenderer(host_svo, device=dev)
    train_params, opt_state = model.init_params(seed=0)
    view = CameraConfig(**bench_cam, width=res, height=res)
    frozen = train_params["normal"].clone()
    losses, residuals = [], []
    reset_counts()
    for _ in range(3):
        train_params, opt_state, loss, n_res = model.step_view(
            train_params, opt_state, view, (-0.5, -1.0, -0.3), img)
        losses.append(float(loss))
        residuals.append(int(n_res))
    torch.cuda.synchronize()
    # two walks and two phase-1 calls a step: the trainer's budgets have no
    # sub-tile pass
    if (tile_cuda.launches != 6 or tile_cuda.candidates_launches != 6
            or tile_cuda.candidates_block_launches
            or PLAIN_CALLS["candidates_plain"] or shade_cuda.launches != dict(
                shade_fwd=3, shade_bwd=3, shade_bwd_serial=0, segment_sum=3,
                segment_sum_sorted=0, composite_fwd=0, composite_bwd=0)):
        raise AssertionError("step_view did not take the tile step's kernels")
    # The trainer keeps the reference's budgets (k_max=96, fb_tiles=128,
    # fb_k=256, no sub-tile pass), which leave a few rays of this view
    # cap-limited where bench.py's budgets leave none. The step returns
    # their count; it must be the tile frame's own at those budgets, the same
    # every step, and under a ten-thousandth of the rays.
    _img, want_res = diff.render_diff_tile(
        *params, ts, o_t, d_t, corners, light, k_max=96, fb_tiles=128, fb_k=256)
    if residuals != [int(want_res)] * 3 or residuals[0] * 10000 > n_rays:
        raise AssertionError(f"step_view: residual rays {residuals}, the tile "
                             f"frame at the trainer's budgets has {int(want_res)}")
    if not (losses[0] > losses[1] > losses[2] > 0.0):
        raise AssertionError(f"step_view: the loss does not fall: {losses}")
    if not torch.equal(train_params["normal"], frozen):
        raise AssertionError("step_view changed a frozen parameter")
    say(f"[train] InverseRenderer.step_view, 3 Adam steps on the {res}x{res} "
        f"view from random albedo: loss {losses[0]:.6f} -> {losses[1]:.6f} -> "
        f"{losses[2]:.6f}, {residuals[0]} residual rays a step at the "
        f"trainer's budgets (the tile frame's own count there; 0 at bench.py's "
        f"budgets above), 6 walker and 6 tile_candidates launches, no launch "
        f"of a first form and no call of candidates_plain, frozen parameters "
        f"unchanged")

    # three Adam steps on the view's flat batch of rays: InverseRenderer.step,
    # the brick step on this tree, as the reference's trainer takes it
    flat_params, flat_state = model.init_params(seed=0)
    flat_losses = []
    reset_counts()
    for _ in range(3):
        flat_params, flat_state, loss = model.step(
            flat_params, flat_state, o, d, (-0.5, -1.0, -0.3), img)
        flat_losses.append(float(loss))
    torch.cuda.synchronize()
    flat_counts = dict(esvo_trace=traverse_cuda.launches, **brick_cuda.launches,
                       **PLAIN_CALLS, **shade_cuda.launches,
                       **brick_cuda.form_launches, **brick_cuda.probe_launches)
    want = dict(esvo_trace=0, brick_trace=3, esvo_stackless=0, candidates_plain=0,
                trace_brick=0, trace_stackless=0, trace_multi=0,
                trace_brick_multi=0, composite_plain=0, shade_fwd=3, shade_bwd=3,
                shade_bwd_serial=0, segment_sum=3, segment_sum_sorted=0,
                composite_fwd=0, brick_trace_serial=0, brick_trace_unstaged=0,
                esvo_stackless_probe=0, brick_trace_probe=0,
                brick_trace_multi_serial=0, esvo_stackless_multi_probe=0, brick_trace_multi_probe=0,
                level_round_serial=0, level_round_probe=0, clipmap_trace_brick_serial=0,
                clipmap_trace_brick_probe=0, clipmap_trace_serial=0, level_queue_serial=0,
                clipmap_trace_probe=0, esvo_stackless_serial=0, esvo_stackless_lod_serial=0,
                esvo_stackless_multi_serial=0, brick_trace_lod_serial=0,
                brick_trace_lod_probe=0, **MULTI_ZERO, **STEP_ZERO)
    if flat_counts != want:
        raise AssertionError(f"InverseRenderer.step launched {flat_counts}, "
                             f"expected {want}")
    if not (flat_losses[0] > flat_losses[1] > flat_losses[2] > 0.0):
        raise AssertionError(f"InverseRenderer.step: the loss does not fall: "
                             f"{flat_losses}")
    if not torch.equal(flat_params["normal"], frozen):
        raise AssertionError("InverseRenderer.step changed a frozen parameter")
    say(f"[train] InverseRenderer.step, 3 Adam steps on the {res}x{res} view's "
        f"flat batch of {n_rays} rays from random albedo: loss "
        f"{flat_losses[0]:.6f} -> {flat_losses[1]:.6f} -> {flat_losses[2]:.6f}, "
        f"through the brick step (launches {flat_counts}), frozen parameters "
        f"unchanged")

    # ---- 7c. the serving renderers: volumetric and surface -----------------
    served = serving(dict(
        dev=dev, host_svo=host_svo, svo=svo, bsvo=bsvo, o=o, d=d, light=light,
        params=params, res=res, bench_cam=bench_cam, routes=routes, err=err,
        img=img, refereed_px=tile.untile_image(mask | differ, grid)), card)
    # ---- 7d. the LOD frames, and the volumetric step ---------------------------
    slice_ctx = dict(dev=dev, host_svo=host_svo, svo=svo, bsvo=bsvo, o=o, d=d,
                     light=light, params=params, res=res, routes=routes, err=err)
    lodded = frame_lod(slice_ctx, card)
    stepped = step_volumetric(slice_ctx, card, served)
    patched = stackless_forms(dict(slice_ctx, bench_cam=bench_cam), card)
    brick_lodded = brick_lod_forms(dict(slice_ctx, bench_cam=bench_cam), card)
    # ---- 7e. the command line, on the same tree ---------------------------------
    clied = cli_phase(dict(dev=dev, host_svo=host_svo, svo=svo, bsvo=bsvo, o=o,
                           d=d, res=res, bench_cam=bench_cam, cache=cache),
                      card, served)
    check_scene_builds(built, os.path.join(_build.BUILD_DIR, "cli"))
    # ---- 7f. the streamed world ---------------------------------------------------
    flown = fly_phase(dict(dev=dev, host_svo=host_svo, host_ts=host_ts, ts=ts, svo=svo,
                           tile_rays=(o_t, d_t, corners, grid), err=err, res=res,
                           bench_cam=bench_cam, light=light), card)
    # ---- 7g. the sharded renderer, in a world of one ------------------------------
    shard = sharded_phase(dict(dev=dev, err=err, bench_cam=bench_cam, light=light,
                               svo=svo, bsvo=bsvo, ts=ts, o=o, d=d, host_svo=host_svo,
                               tile_rays=(o_t, d_t, corners, grid)), card)

    # ---- 8. timing: both frames within this one call -----------------------
    # 50 samples: the 80th percentile has 10 beyond it
    t = {}
    t["esvo"] = cuda_ms(lambda: traverse_cuda.trace_cuda(svo, o, d), 50, 3)
    t["frame"] = cuda_ms(lambda: diff.render_diff_cuda(*params, svo, o, d, light), 50, 3)
    t["tile_frame"] = cuda_ms(lambda: diff.render_diff_tile(
        *params, ts, o_t, d_t, corners, light, **TILE_BUDGETS), 50, 3)
    t["walk"] = cuda_ms(lambda: tile_cuda.tile_walk(*main_args), 50, 3)
    # phase 1: the frame's three calls, each at the rule's warps a tile, at
    # the other, in its first form and in its plain version, in turns (the
    # plain version takes tens of milliseconds a call)
    variants = {}
    for cname, args in zip(CAND_CALLS, cands):
        other = 9 - cand_rows[cname]["warps"]
        variants[f"phase1 {cname}"] = lambda a=args: tile_cuda.candidates(*a)
        variants[f"phase1 {cname} other"] = (
            lambda a=args, w=other: tile_cuda.candidates(*a, warps=w))
        variants[f"phase1 {cname} first"] = lambda a=args: tile_cuda.candidates_block(*a)
        variants[f"phase1 {cname} radix"] = (
            lambda a=args: tile_cuda.candidates(*a, form="radix"))
        variants[f"phase1 {cname} plain"] = lambda a=args: tile.candidates_plain(*a)
    t.update(in_turns(variants, rounds=3, reps=10))
    t["frame_again"] = cuda_ms(lambda: diff.render_diff_cuda(*params, svo, o, d, light), 50, 3)
    t["dda"] = cuda_ms(lambda: brick_dda.brick_dda16(
        dda_args[0], dda_args[1], dda_args[2], *dda_args[3:], depth=10, steps=16), 50, 3)
    t["dda_plain"] = cuda_ms(lambda: brick_dda.dda_steps(
        dda_args[0], dda_args[1], dda_args[2].bool(), *dda_args[3:], depth=10,
        steps=16), 5, 1)
    t["row"] = cuda_ms(lambda: rowread.rowread_rows(table, rows8), 50, 3)
    rows8_long = rows8.long()
    t["row_plain"] = cuda_ms(lambda: table[rows8_long], 50, 3)
    t["row_library"] = cuda_ms(lambda: torch.index_select(table, 0, rows8), 50, 3)
    t["row_scalar"] = cuda_ms(lambda: rowread.rowread_scalar(table, 17), 50, 3)
    t["row_min"] = cuda_ms(lambda: rowread.rowread_min(table, cursors), 50, 3)
    take_idx_flat = take_idx.reshape(-1)
    turns = in_turns({
        "nothing": lambda: None,
        "row_old_path": lambda: rowread_rows_old_path(table, rows8),
        "row": lambda: rowread.rowread_rows(table, rows8),
        "row_library": lambda: torch.index_select(table, 0, rows8),
        "take_old_path": lambda: take_1d_old_path(take_table, take_idx),
        "take": lambda: gather.take_1d(take_table, take_idx),
        "take_library": lambda: torch.index_select(take_table, 0, take_idx_flat)})
    t.update({f"{name}_turns": v for name, v in turns.items()})
    # take at the main path's size: the gather take_row makes in shade_fwd,
    # one leaf's value for each of the frame's rays (misses read leaf 0)
    big_table, big_idx = svo.leaf_density, safe_leaf
    got = gather.take_1d(big_table, big_idx)
    torch.cuda.synchronize()
    err["take"] = max(err["take"], compare_tensors(
        (got,), (big_table[big_idx.long()],), ("take_1d",), "take_1d, full size"))
    turns = in_turns({
        "take_full_old_path": lambda: take_1d_old_path(big_table, big_idx),
        "take_full": lambda: gather.take_1d(big_table, big_idx),
        "take_full_library": lambda: torch.index_select(big_table, 0, big_idx)})
    t.update({f"{name}_turns": v for name, v in turns.items()})
    # the two traversals' kernels against their first forms, in turns, and
    # the frame's three walks at every G
    turns = in_turns({
        "esvo": lambda: traverse_cuda.trace_cuda(svo, o, d),
        "esvo_first": lambda: traverse_cuda.trace_cuda_serial(svo, o, d)})
    t.update({f"{name}_turns": v for name, v in turns.items()})
    for wname, args in zip(WALKS, walks):
        variants = {"first": lambda a=args: tile_cuda._walk_serial_kernel(*a)}
        variants.update({f"G={g}": lambda a=args, g=g: tile_cuda._walk_kernel(*a, lanes=g)
                         for g in tile_cuda.LANES})
        for name, v in in_turns(variants, rounds=2, reps=30).items():
            t[f"walk {wname} {name}"] = v
    target0 = torch.zeros_like(target_rand)
    t["step"] = cuda_ms(lambda: diff.loss_and_grads_cuda(
        *params, svo, o, d, light, target0), 50, 3)
    t["step_tile"] = cuda_ms(lambda: diff.loss_and_grads_tile(
        *params, ts, o_t, d_t, corners, light, target0, **TILE_BUDGETS), 50, 3)
    t["frame_last"] = cuda_ms(lambda: diff.render_diff_cuda(*params, svo, o, d, light), 50, 3)
    t["tile_frame_last"] = cuda_ms(lambda: diff.render_diff_tile(
        *params, ts, o_t, d_t, corners, light, **TILE_BUDGETS), 20, 2)
    # bench.py's BENCH_PATH=brick and plain: each frame, and its step beside it
    route_calls = {
        "brick": (lambda: diff.render_diff_brick(*params, bsvo, o, d, light),
                  lambda: diff.loss_and_grads_brick(*params, bsvo, o, d, light,
                                                    target0)),
        "plain": (lambda: diff.render_diff(*params, svo, o, d, light, width=res),
                  lambda: diff.loss_and_grads(*params, svo, o, d, light, target0,
                                              width=res))}
    for route, (fwd, fwdbwd) in route_calls.items():
        t[f"{route}_frame"] = cuda_ms(fwd, 50, 3)
        t[f"{route}_step"] = cuda_ms(fwdbwd, 50, 3)
    # the per-ray traces in turns, the brick trace in each of its forms
    # through its own wrapper, and the plain versions
    turns = in_turns({
        "trace_esvo": lambda: traverse_cuda.trace_cuda(svo, o, d),
        "trace_brick": lambda: brick_cuda.trace_brick_cuda(bsvo, o, d),
        "trace_brick_first": lambda: brick_cuda.trace_brick_cuda_serial(bsvo, o, d),
        "trace_brick_unstaged": lambda: brick_cuda._brick_unstaged_kernel(bsvo, o, d),
        "trace_stackless": lambda: brick_cuda.trace_stackless_cuda(svo, o, d, width=res),
        "trace_stackless_first": lambda: brick_cuda.trace_stackless_cuda_serial(svo, o, d)},
        rounds=4)
    t.update({f"{name}_turns": v for name, v in turns.items()})
    t["brick_plain"] = cuda_ms(lambda: brick.trace_brick(bsvo, o, d), 2, 0)
    t["stackless_plain"] = cuda_ms(lambda: traverse.trace_stackless(svo, o, d), 2, 0)
    g_step = 2.0 * img / img.numel()
    shade_args = (hit_leaf, d, *params, light, 1.3, 0.08)
    t["shade_fwd"] = cuda_ms(lambda: shade_cuda.shade_fwd(*shade_args), 50, 3)
    t["shade_fwd_plain"] = cuda_ms(lambda: diff.shade_diff_plain(*shade_args), 20, 2)
    t["shade_bwd"] = cuda_ms(lambda: shade_cuda.shade_bwd(g_step, *shade_args), 50, 3)
    # shade_bwd against its first form, in turns
    turns = in_turns({
        "bwd": lambda: shade_cuda.shade_bwd(g_step, *shade_args),
        "bwd_first": lambda: shade_cuda.shade_bwd_serial(g_step, *shade_args)})
    t.update({f"{name}_turns": v for name, v in turns.items()})
    t["shade_bwd_plain"] = cuda_ms(lambda: shade_cuda.shade_bwd_plain(
        g_step, *shade_args), 20, 2)
    # the whole function each time, from (cot, hit_leaf) to the three
    # tensors: scratch, fills and, for the sorted form, its sort included
    t["segment_sum"] = cuda_ms(lambda: shade_cuda.segment_sum(
        seg_cot, hit_leaf, n_leaves), 50, 3)
    t["segment_sorted_whole"] = cuda_ms(lambda: shade_cuda.segment_sum_sorted(
        seg_cot, *shade_cuda.sort_by_leaf(hit_leaf, n_leaves), n_leaves), 50, 3)
    t["sort"] = cuda_ms(lambda: shade_cuda.sort_by_leaf(hit_leaf, n_leaves), 50, 3)
    t["segment_sorted"] = cuda_ms(lambda: shade_cuda.segment_sum_sorted(
        seg_cot, keys, order, n_leaves), 50, 3)
    t["segment_sum_again"] = cuda_ms(lambda: shade_cuda.segment_sum(
        seg_cot, hit_leaf, n_leaves), 50, 3)
    t["segment_plain"] = cuda_ms(lambda: diff._segment_reduce_cols(
        safe_leaf, seg_cot, n_leaves), 20, 2)
    # the library call on the work the kernel does: the hit rows alone
    was_hit = hit_leaf >= 0
    hit_long, hit_cot = hit_leaf[was_hit].long(), seg_cot[was_hit]
    t["segment_library"] = cuda_ms(lambda: torch.zeros(
        (n_leaves, 7), device=dev).index_add_(0, hit_long, hit_cot), 50, 3)
    take_idx_long = take_idx.long()
    t["take"] = cuda_ms(lambda: gather.take_1d(take_table, take_idx), 50, 3)
    t["take_plain"] = cuda_ms(lambda: take_table[take_idx_long], 50, 3)
    t["take_library"] = cuda_ms(lambda: torch.index_select(
        take_table, 0, take_idx_flat), 50, 3)
    t["take_onehot"] = cuda_ms(lambda: gather.take_onehot(hot_table, hot_idx), 50, 3)
    t["take_onehot_plain"] = cuda_ms(lambda: gather.onehot_take_plain(
        hot_table, hot_idx), 20, 2)
    # both forms of the loop probe in turns, three rounds of 20
    t.update(in_turns(loop_variants(loop_inp), rounds=3, reps=20))
    m = {k: med_p80(v) for k, v in t.items()}
    slope = {(form, rows): (m[f"{form} (2048, {rows})"][0]
                            - m[f"{form} (64, {rows})"][0]) / 1984 * 1e3
             for form in ("loop", "loop_serial") for rows in (0, 512)}
    say(f"[timing] {card}: per-ray frame median {m['frame'][0]:.4f} ms (p80 "
        f"{m['frame'][1]:.4f}, n=50; again after the tile frame "
        f"{m['frame_again'][0]:.4f}, p80 {m['frame_again'][1]:.4f}) = "
        f"{n_rays / m['frame'][0] / 1e3:.2f} Mrays/s; esvo_trace median "
        f"{m['esvo'][0]:.4f} ms (p80 {m['esvo'][1]:.4f}); plain trace "
        f"{esvo_plain_ms:.3f} ms (n=1)")
    say(f"[timing] {card}: tile frame median {m['tile_frame'][0]:.4f} ms (p80 "
        f"{m['tile_frame'][1]:.4f}, n=50) = "
        f"{n_rays / m['tile_frame'][0] / 1e3:.2f} Mrays/s at {res}x{res} depth "
        f"{depth}, {n_residual} residual rays; tile_walk (main walk) median "
        f"{m['walk'][0]:.4f} ms (p80 {m['walk'][1]:.4f}); plain walk "
        f"{walk_plain_ms:.3f} ms (n=1); phase 1 in turns (three rounds of 10): "
        + ", ".join(
            f"{c}: tile_candidates at {cand_rows[c]['warps']} warps a tile "
            f"{m[f'phase1 {c}'][0]:.4f} ms (p80 {m[f'phase1 {c}'][1]:.4f}), at "
            f"{9 - cand_rows[c]['warps']} {m[f'phase1 {c} other'][0]:.4f}, "
            f"tile_candidates_block {m[f'phase1 {c} first'][0]:.4f}, "
            f"the radix form (tile_candidates_radix, off the path) "
            f"{m[f'phase1 {c} radix'][0]:.4f}, "
            f"candidates_plain {m[f'phase1 {c} plain'][0]:.4f}" for c in CAND_CALLS))
    say(f"[timing] {card}: brick_dda16 N={n_dda} median {m['dda'][0]:.4f} ms "
        f"(p80 {m['dda'][1]:.4f}), plain {m['dda_plain'][0]:.4f} ms (n=5); "
        f"rowread rows {m['row'][0]:.4f} ms, scalar {m['row_scalar'][0]:.4f}, "
        f"min {m['row_min'][0]:.4f}, table[idx] {m['row_plain'][0]:.4f}, "
        f"index_select {m['row_library'][0]:.4f} (n=50 each); in turns, three "
        f"rounds of 50 each: two events around nothing "
        f"{m['nothing_turns'][0]:.4f}, rowread rows through the launch path as "
        f"it stood before {m['row_old_path_turns'][0]:.4f}, through the launcher "
        f"{m['row_turns'][0]:.4f}, index_select {m['row_library_turns'][0]:.4f}; "
        f"take_1d {m['take_turns'][0]:.4f} (through the launch path as it stood "
        f"before {m['take_old_path_turns'][0]:.4f}), its index_select "
        f"{m['take_library_turns'][0]:.4f}")

    say(f"[timing] {card}: per-ray fwd+bwd step median {m['step'][0]:.4f} ms "
        f"(p80 {m['step'][1]:.4f}, n=50) = "
        f"{n_rays / m['step'][0] / 1e3:.2f} Mrays/s, fwdbwd_over_fwd "
        f"{m['step'][0] / m['frame_last'][0]:.2f} (forward frame beside it "
        f"{m['frame_last'][0]:.4f} ms); tile fwd+bwd step median "
        f"{m['step_tile'][0]:.4f} ms (p80 {m['step_tile'][1]:.4f}, n=50) = "
        f"{n_rays / m['step_tile'][0] / 1e3:.2f} Mrays/s, fwdbwd_over_fwd "
        f"{m['step_tile'][0] / m['tile_frame_last'][0]:.2f} (forward frame "
        f"beside it {m['tile_frame_last'][0]:.4f} ms, n=20)")
    say(f"[timing] {card}: shade_fwd median {m['shade_fwd'][0]:.4f} ms (p80 "
        f"{m['shade_fwd'][1]:.4f}), plain {m['shade_fwd_plain'][0]:.4f}; "
        f"shade_bwd {m['shade_bwd'][0]:.4f} (p80 {m['shade_bwd'][1]:.4f}), "
        f"plain {m['shade_bwd_plain'][0]:.4f} (kernels n=50, plain n=20); in "
        f"turns, three rounds of 50: shade_bwd {m['bwd_turns'][0]:.4f}, "
        f"shade_bwd_serial {m['bwd_first_turns'][0]:.4f}")
    say(f"[timing] {card}: segment_sum, (cot, hit_leaf) to the three gradients, "
        f"scratch included: median {m['segment_sum'][0]:.4f} ms (p80 "
        f"{m['segment_sum'][1]:.4f}; again {m['segment_sum_again'][0]:.4f}); "
        f"the sorted form with its sort {m['segment_sorted_whole'][0]:.4f} (p80 "
        f"{m['segment_sorted_whole'][1]:.4f}): the stable sort of {n_rays} keys "
        f"{m['sort'][0]:.4f}, segment_sum_sorted after it "
        f"{m['segment_sorted'][0]:.4f}; index_add_ of the hit rows onto zeros "
        f"{m['segment_library'][0]:.4f} (n=50 each); plain sort + running "
        f"sums {m['segment_plain'][0]:.4f} (n=20)")
    say(f"[timing] {card}: take_1d (8,128) of 16,384 rows {m['take'][0]:.4f} "
        f"ms, table[idx] {m['take_plain'][0]:.4f}, index_select "
        f"{m['take_library'][0]:.4f} (n=50); take_onehot (8,128) of 4,096 rows "
        f"{m['take_onehot'][0]:.4f}, one_hot @ table "
        f"{m['take_onehot_plain'][0]:.4f} (n=20)")
    say(f"[timing] {card}: loop_probe (512,128), 8 steps a trip, in turns "
        f"(three rounds of 20), the ranged form against its first form "
        f"(loop_probe_serial): " + ", ".join(
            f"{c[0]} trips{' with a 512-row gather a trip' if c[1] else ''} "
            f"{m[f'loop {c}'][0]:.4f} ms against {m[f'loop_serial {c}'][0]:.4f}"
            for c in LOOP_TIMED[:4])
        + f"; slope {slope[('loop', 0)]:.4f} us a trip against "
        f"{slope[('loop_serial', 0)]:.4f}, with the gather "
        f"{slope[('loop', 512)]:.4f} against {slope[('loop_serial', 512)]:.4f}; "
        f"integer mode (8,128), 256 trips {m['loop int'][0]:.4f} against "
        f"{m['loop_serial int'][0]:.4f}; plain loop of 2048 trips "
        f"{loop_plain_ms[(2048, 0)]:.1f} ms, with the gather "
        f"{loop_plain_ms[(2048, 512)]:.1f}, integer {loop_plain_ms['int']:.1f} (n=1)")

    say(f"[timing] {card}: esvo_trace {m['esvo_turns'][0]:.4f} ms against its "
        f"first form {m['esvo_first_turns'][0]:.4f} (in turns, three rounds of "
        f"50); take_1d at the main path's size ({big_table.shape[0]} float32 "
        f"entries, {big_idx.shape[0]} int32 indices) {m['take_full_turns'][0]:.4f} "
        f"ms (through the launch path as it stood before "
        f"{m['take_full_old_path_turns'][0]:.4f}) against index_select "
        f"{m['take_full_library_turns'][0]:.4f} (in turns)")
    for route in route_calls:
        f, st = m[f"{route}_frame"], m[f"{route}_step"]
        say(f"[timing] {card}: BENCH_PATH={route}: fwd median {f[0]:.4f} ms (p80 "
            f"{f[1]:.4f}, n=50) = {n_rays / f[0] / 1e3:.2f} Mrays/s; fwdbwd median "
            f"{st[0]:.4f} ms (p80 {st[1]:.4f}, n=50) = "
            f"{n_rays / st[0] / 1e3:.2f} Mrays/s; fwdbwd_over_fwd "
            f"{st[0] / f[0]:.2f}")
    say(f"[timing] {card}: the per-ray traces in turns (four rounds of 50, "
        f"median and p80): esvo_trace {m['trace_esvo_turns'][0]:.4f} ms; "
        f"brick_trace through the main path's wrapper (wide form: blocks of 256, "
        f"staged rows) {m['trace_brick_turns'][0]:.4f} "
        f"({m['trace_brick_turns'][1]:.4f}), the wide form without staged rows "
        f"{m['trace_brick_unstaged_turns'][0]:.4f} "
        f"({m['trace_brick_unstaged_turns'][1]:.4f}), the first form (blocks of "
        f"128) {m['trace_brick_first_turns'][0]:.4f} "
        f"({m['trace_brick_first_turns'][1]:.4f}); esvo_stackless through the main "
        f"path's wrapper (the patched form, the image's width) "
        f"{m['trace_stackless_turns'][0]:.4f} ({m['trace_stackless_turns'][1]:.4f}), "
        f"its first form {m['trace_stackless_first_turns'][0]:.4f} "
        f"({m['trace_stackless_first_turns'][1]:.4f})"
        + f"; their plain versions brick.trace_brick {m['brick_plain'][0]:.1f} ms "
        f"and traverse.trace_stackless {m['stackless_plain'][0]:.1f} ms (n=2)")
    for wname in WALKS:
        row = walk_rows[wname]
        say(f"[lanes] {card}: walk {wname} (T={row['T']}, P={row['P']}, "
            f"K={row['K']}; the rule's G={row['G']}), ms in turns (two rounds of "
            f"30): first form {m[f'walk {wname} first'][0]:.4f}, " + ", ".join(
                f"G={g} {m[f'walk {wname} G={g}'][0]:.4f}" for g in tile_cuda.LANES))

    # ---- 8b. the launch path, part by part, on the host's clock -------------
    # Each part of one rowread_rows call alone, a few thousand calls back to
    # back without waiting for the card (its kernel is shorter than any of
    # them, so the queue never fills), beside the parts the path had before
    # _launch.py and before the launcher, and beside index_select, which does
    # the same in C++; three rounds, each part in turn, the median.
    kern = rowread._ROWREAD
    specs = (("table", table, torch.int32, (64, 128)),
             ("indices", rows8, torch.int32, (8,)))
    row_out = torch.empty((8, 128), dtype=torch.int32, device=dev)
    row_fn, raw_stream = kern._fn, torch._C._cuda_getCurrentRawStream
    row_ctypes = _build.tile_lib().rowread
    row_args = (table.data_ptr(), 64, 128, rowread.MODE_ROWS, None, 0,
                rows8.data_ptr(), 8, row_out.data_ptr(), 8)

    def device_context():
        with torch.cuda.device(dev):
            pass
    w = host_parts({
        "an empty call": lambda: None,
        "checks": lambda: kern.check(dev, specs),
        "library lookup (before)": _build.tile_lib,
        "torch.empty": lambda: torch.empty((8, 128), dtype=torch.int32, device=dev),
        "device context (before)": device_context,
        "current_device (before)": torch.cuda.current_device,
        "_cuda_getDevice (now)": torch._C._cuda_getDevice,
        "Stream object (before)": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "raw stream (now)": lambda: raw_stream(0),
        "bare ctypes call (before)": lambda: row_ctypes(*row_args, raw_stream(0)),
        "bare launcher call (now)": lambda: row_fn(*row_args, raw_stream(0)),
        "Kernel call (now)": lambda: kern(dev, *row_args),
        "rowread_rows (before)": lambda: rowread_rows_old_path(table, rows8),
        "rowread_rows (now)": lambda: rowread.rowread_rows(table, rows8),
        "index_select": lambda: torch.index_select(table, 0, rows8),
        "take_1d (8,128) of 16,384 rows (now)": lambda: gather.take_1d(take_table, take_idx),
    })
    say(f"[wrapper] {card}: rowread_rows, host us a call, 3000 calls each, not "
        f"waiting for the card, median of three rounds: "
        + ", ".join(f"{k} {v:.2f}" for k, v in w.items()))
    w_take = take_parts(dev, big_table, big_idx)
    say(f"[wrapper] {card}: take_1d at the main path's size ({big_table.shape[0]} "
        f"float32 entries, {big_idx.shape[0]} int32 indices), its parts before "
        f"and now, host us a call, 3000 calls each, median of three rounds: "
        + ", ".join(f"{k} {v:.2f}" for k, v in w_take.items()))
    w_main = {"shade_fwd": host_us_alone(lambda: shade_cuda.shade_fwd(*shade_args)),
              "tile_walk (the main walk)": host_us_alone(
                  lambda: tile_cuda.tile_walk(*main_args)),
              "rowread_rows": host_us_alone(lambda: rowread.rowread_rows(table, rows8))}
    say(f"[wrapper] {card}: wrappers on the main path, host us of one call issued "
        f"to an idle card (median of 200): " + ", ".join(
            f"{k} {v:.2f}" for k, v in w_main.items()))

    # profiler passes of 20 runs each: device time by kernel. Only the
    # kernels' own events are summed; an operator's row repeats the time of
    # the kernels it launched. The tracer drops the launches made while it
    # starts up, which can be all of a short pass: each pass is preceded by
    # a warm-up cycle whose events are discarded, and a pass in which no
    # kernel was seen all the same is repeated with more runs. If the tracer
    # still shows nothing the pass says so and gives no time (the times
    # taken with CUDA events above stand); that is a fault of the tracing,
    # not of a kernel, whose launch errors the wrappers raise.
    def profile_kernels(what, fn, unit, top, launches=None):
        """(us of kernel time a unit, us a launch by kernel, launches a
        unit) of `runs` units of fn(), and a line for each of the `top`
        largest kernels. A pass that sees no kernel, or fewer than nine in
        ten of the `launches` a unit that fn() makes, is repeated with
        more runs."""
        for runs in (20, 80, 320):
            rows = sorted(traced_kernels(fn, runs), key=dev_us, reverse=True)
            total_us = sum(dev_us(e) for e in rows) / runs
            seen = sum(e.count for e in rows) / runs
            if total_us > 0.0 and (launches is None or seen >= 0.9 * launches):
                break
        else:
            say(f"[profile] {what}: the profiler saw no kernel in 20, 80 or 320 "
                f"{unit}s; not measured here")
            return None, {}, None
        n_launches = sum(e.count for e in rows) / runs
        say(f"[profile] {what}, {runs} {unit}s: {total_us:.1f} us of kernel time a "
            f"{unit} in {n_launches:.1f} launches; the "
            f"{min(top, len(rows))} largest, us a {unit} (launches a {unit}):")
        for e in rows[:top]:
            say(f"[profile]   {dev_us(e) / runs:9.1f}  ({e.count / runs:6.1f})  {e.key[:90]}")
        # by kernel, us a launch: the tracer may still drop a few launches
        # of a short pass, which lowers a sum over the pass but not this
        return (total_us, {e.key: dev_us(e) / e.count for e in rows if e.count},
                n_launches)

    tile_us, tile_rows, tile_n = profile_kernels(
        "tile frame", lambda: diff.render_diff_tile(
            *params, ts, o_t, d_t, corners, light, **TILE_BUDGETS), "frame", 10)
    say("[profile] the tile frame's walks, us a launch: " + ", ".join(
        f"{k.split('(')[-2].split('::')[-1]} {v:.1f}" for k, v in tile_rows.items()
        if "tile_walk" in k))
    say("[profile] the tile frame's phase-1 calls, us a launch: " + ", ".join(
        f"{v:.1f}" for k, v in tile_rows.items() if "tile_candidates" in k))
    tile_step_us, _rows, tile_step_n = profile_kernels(
        "tile fwd+bwd step", lambda: diff.loss_and_grads_tile(
            *params, ts, o_t, d_t, corners, light, target0, **TILE_BUDGETS),
        "step", 10)
    step_us, step_rows, _n = profile_kernels(
        "per-ray fwd+bwd step", lambda: diff.loss_and_grads_cuda(
            *params, svo, o, d, light, target0), "step", 14)
    sorts = [k for k in step_rows if "sort" in k.lower() and "seg_" not in k]
    if sorts:
        raise AssertionError(f"the per-ray step launched a sort: {sorts}")
    # the sort-free segment sum's kernels alone (each is launched once a
    # call, so us a launch is us a call), and the sorted form's
    _, seg_rows, _n = profile_kernels(
        "segment_sum alone (the memset and its five kernels)",
        lambda: shade_cuda.segment_sum(seg_cot, hit_leaf, n_leaves), "call", 6)
    seg_kernel_us = {
        k.replace("(anonymous namespace)::", "").split("(")[0].strip(): round(v, 2)
        for k, v in seg_rows.items()}
    profile_kernels(
        "the sorted form alone (where, clamp, the radix sort, three fills, "
        "segment_sum_sorted)", lambda: shade_cuda.segment_sum_sorted(
            seg_cot, *shade_cuda.sort_by_leaf(hit_leaf, n_leaves), n_leaves),
        "call", 8)
    # the two forms of each traversal kernel side by side, one call of each a
    # round: us a launch of each, the frame's three walks one by one
    alone = {}
    for wname, args in zip(WALKS, walks):
        _, rows, _n = profile_kernels(
            f"walk {wname} alone: tile_walk at G={walk_rows[wname]['G']} and its "
            f"first form", lambda a=args: (tile_cuda._walk_kernel(*a),
                                            tile_cuda._walk_serial_kernel(*a)),
            "round", 2)
        alone[wname] = kernel_us(rows, "tile_walk_kernel", "tile_walk_serial_kernel")
    _, rows, _n = profile_kernels(
        "esvo_trace alone, and its first form", lambda: (
            traverse_cuda.trace_cuda(svo, o, d),
            traverse_cuda.trace_cuda_serial(svo, o, d)), "round", 2)
    alone["esvo"] = kernel_us(rows, "esvo_kernel<false>", "esvo_kernel<true>")
    _, rows, _n = profile_kernels(
        "brick_trace alone in its three forms, esvo_stackless in its two, and "
        "esvo_trace beside them",
        lambda: (brick_cuda.trace_brick_cuda(bsvo, o, d),
                 brick_cuda.trace_brick_cuda_serial(bsvo, o, d),
                 brick_cuda._brick_unstaged_kernel(bsvo, o, d),
                 brick_cuda.trace_stackless_cuda(svo, o, d, width=res),
                 brick_cuda.trace_stackless_cuda_serial(svo, o, d),
                 traverse_cuda.trace_cuda(svo, o, d)), "round", 6, launches=6)
    for key, name in FORM_KERNELS.items():
        alone[key] = kernel_us(rows, name)[0]
    for kname in ("brick_trace", "esvo_stackless"):
        alone[kname] = alone[(kname, MAIN_FORM[kname])]
    alone["esvo_beside"] = kernel_us(rows, "esvo_kernel<false>")[0]
    route_prof = {}
    for route, (fwd, fwdbwd) in route_calls.items():
        f_us, _rows, f_n = profile_kernels(f"{route} frame", fwd, "frame", 4)
        s_us, _rows, s_n = profile_kernels(f"{route} fwd+bwd step", fwdbwd, "step", 10)
        route_prof[route] = (f_us, f_n, s_us, s_n)
    _, rows, _n = profile_kernels(
        "take_1d at the main path's size alone, and index_select", lambda: (
            gather.take_1d(big_table, big_idx),
            torch.index_select(big_table, 0, big_idx)), "round", 2)
    # index_select of a 1-D table runs PyTorch's gather kernel
    alone["take"] = kernel_us(rows, "take_kernel", "gather")
    # phase 1's three calls alone: the rule's variant, the other, the first
    # form and the radix form (off the path), one call of each a round
    for cname, args in zip(CAND_CALLS, cands):
        warps = cand_rows[cname]["warps"]
        tiles = tile_cuda.tiles_a_warp("radix", warps)
        _, rows, _n = profile_kernels(
            f"tile_candidates {cname} alone at {warps} and {9 - warps} warps a "
            f"tile, tile_candidates_block and tile_candidates_radix",
            lambda a=args, w=warps: (
                tile_cuda.candidates(*a), tile_cuda.candidates(*a, warps=9 - w),
                tile_cuda.candidates_block(*a), tile_cuda.candidates(*a, form="radix")),
            "round", 4, launches=4)
        alone[f"phase1 {cname}"] = kernel_us(
            rows, f"tile_candidates_kernel<{warps}, false>",
            "tile_candidates_block_kernel", f"tile_candidates_kernel<{9 - warps}, false>",
            f"tile_candidates_radix_kernel<{warps}, false, {tiles}>")
    _, rows, _n = profile_kernels(
        "shade_bwd alone, and shade_bwd_serial", lambda: (
            shade_cuda.shade_bwd(g_step, *shade_args),
            shade_cuda.shade_bwd_serial(g_step, *shade_args)), "round", 2,
        launches=2)
    alone["shade_bwd"] = kernel_us(rows, "shade_bwd_kernel", "shade_bwd_serial_kernel")
    say(f"[profile] {card}: shade_bwd {us_or(alone['shade_bwd'][0])} us alone, "
        f"shade_bwd_serial {us_or(alone['shade_bwd'][1])} us; tile_candidates "
        f"alone at the rule's warps a tile, at the other, "
        f"tile_candidates_block, and the radix form, us: " + "; ".join(
            f"{c} " + ", ".join(us_or(x) for x in (
                alone[f"phase1 {c}"][0], alone[f"phase1 {c}"][2],
                alone[f"phase1 {c}"][1], alone[f"phase1 {c}"][3])) for c in CAND_CALLS))
    idle = lambda us, ms: "not measured" if us is None else f"{1 - us / 1e3 / ms:.2f}"
    count = lambda n: "not measured" if n is None else f"{n:.1f}"
    say(f"[profile] {card}: idle share of the card: tile frame {count(tile_n)} "
        f"launches a frame, idle {idle(tile_us, m['tile_frame'][0])} of its "
        f"median {m['tile_frame'][0]:.4f} ms; tile fwd+bwd step "
        f"{count(tile_step_n)} launches a step, idle "
        f"{idle(tile_step_us, m['step_tile'][0])} of its median "
        f"{m['step_tile'][0]:.4f} ms; per-ray fwd+bwd step idle "
        f"{idle(step_us, m['step'][0])} of its median {m['step'][0]:.4f} ms")
    say(f"[profile] {card}: us alone: " + "; ".join(
            f"{k} " + ", ".join(f"{form} form {us_or(alone[(k, form)])}"
                                for form in brick_cuda.FORMS[k])
            for k in ("brick_trace", "esvo_stackless"))
        + f"; esvo_trace beside them {us_or(alone['esvo_beside'])}; " + "; ".join(
            f"{route} frame {us_or(f_us)} us of kernels in {count(f_n)} launches, "
            f"idle {idle(f_us, m[f'{route}_frame'][0])} of its median "
            f"{m[f'{route}_frame'][0]:.4f} ms; {route} fwd+bwd step {us_or(s_us)} us "
            f"in {count(s_n)} launches, idle {idle(s_us, m[f'{route}_step'][0])} of "
            f"its median {m[f'{route}_step'][0]:.4f} ms"
            for route, (f_us, f_n, s_us, s_n) in route_prof.items()))

    # the volumetric frames: their kernels alone, and the card's idle share
    kb_seg = served["multi"][0][0]
    _, rows, _n = profile_kernels(
        "brick_trace_multi (in its staged and its first form), "
        "esvo_stackless_multi (in its patched and its first form) and "
        "composite_fwd alone",
        lambda: (brick_cuda.trace_brick_multi_cuda(bsvo, o, d, VOLUME_K),
                 brick_cuda.trace_brick_multi_cuda_serial(bsvo, o, d, VOLUME_K),
                 brick_cuda.trace_multi_cuda(svo, o, d, VOLUME_K, width=res),
                 brick_cuda.trace_multi_cuda_serial(svo, o, d, VOLUME_K),
                 shade_cuda.composite_fwd(kb_seg.hit_leaf, kb_seg.t_in,
                                          kb_seg.t_out, d, *params, light, 1.3,
                                          0.08, DENSITY_SCALE)),
        "round", 5, launches=5)
    for kname, kernel in MULTI_KERNELS.items():
        alone[kname] = kernel_us(rows, kernel)[0]
    alone["composite_fwd"] = kernel_us(rows, "composite_fwd_kernel")[0]
    vol_prof = {}
    for route, fn in (
            ("brick", lambda: diff.render_volumetric_brick(
                *params, bsvo, o, d, light, k=VOLUME_K, density_scale=DENSITY_SCALE)),
            ("stackless", lambda: diff.render_volumetric(
                *params, svo, o, d, light, k=VOLUME_K, density_scale=DENSITY_SCALE,
                width=res))):
        vol_prof[route] = profile_kernels(f"volumetric frame, {route} route", fn,
                                          "frame", 4)
    vm = served["ms"]
    say(f"[profile] {card}: us alone: brick_trace_multi "
        f"{us_or(alone['brick_trace_multi'])} (staged; the first form "
        f"{us_or(alone['brick_trace_multi_serial'])}), esvo_stackless_multi "
        f"{us_or(alone['esvo_stackless_multi'])} (patched; the first form "
        f"{us_or(alone['esvo_stackless_multi_serial'])}), composite_fwd "
        f"{us_or(alone['composite_fwd'])}; volumetric frames: " + "; ".join(
            f"{route} route {us_or(f_us)} us of kernels in {count(f_n)} launches, "
            f"idle {idle(f_us, vm['vol_brick' if route == 'brick' else 'vol_flat'][0])} "
            f"of its median" for route, (f_us, _r, f_n) in vol_prof.items()))

    # the LOD traces and composite_bwd alone; the LOD frame's and the
    # volumetric steps' kernel time, for the card's idle share
    _, rows, _n = profile_kernels(
        "esvo_stackless_lod and brick_trace_lod (each in its patched and its "
        "first form) at c0, and composite_bwd, alone",
        lambda: (brick_cuda.trace_lod_cuda(svo, o, d, LOD_C0, width=res),
                 brick_cuda.trace_lod_cuda_serial(svo, o, d, LOD_C0),
                 brick_cuda.trace_brick_lod_cuda(bsvo, o, d, LOD_C0, width=res),
                 brick_cuda.trace_brick_lod_cuda_serial(bsvo, o, d, LOD_C0),
                 shade_cuda.composite_bwd(*stepped["bwd_args"])), "round", 5,
        launches=5)
    alone["composite_bwd"] = kernel_us(rows, "composite_bwd_kernel")[0]
    for kname, kernels_of in (("esvo_stackless_lod", LOD_KERNELS),
                              ("brick_trace_lod", BRICK_LOD_KERNELS)):
        alone[kname] = kernel_us(rows, kernels_of["patched"])[0]
        alone[kname + "_serial"] = kernel_us(rows, kernels_of["first"])[0]
    _, rows, _n = profile_kernels(
        "esvo_stackless_lod and brick_trace_lod (each in its two forms) at 8 c0 alone",
        lambda: (brick_cuda.trace_lod_cuda(svo, o, d, 8 * LOD_C0, width=res),
                 brick_cuda.trace_lod_cuda_serial(svo, o, d, 8 * LOD_C0),
                 brick_cuda.trace_brick_lod_cuda(bsvo, o, d, 8 * LOD_C0, width=res),
                 brick_cuda.trace_brick_lod_cuda_serial(bsvo, o, d, 8 * LOD_C0)),
        "round", 4, launches=4)
    for kname, kernels_of in (("esvo_stackless_lod", LOD_KERNELS),
                              ("brick_trace_lod", BRICK_LOD_KERNELS)):
        alone[kname + " 8c0"] = kernel_us(rows, kernels_of["patched"])[0]
        alone[kname + "_serial 8c0"] = kernel_us(rows, kernels_of["first"])[0]
    slice_prof = {
        "LOD frame (brick_trace_lod, shade_lod) at c0": (profile_kernels(
            "the LOD frame at c0", lambda: lod.shade_lod(
                svo, lodded["node_alb"], lodded["node_nrm"],
                brick_cuda.trace_brick_lod_cuda(bsvo, o, d, LOD_C0, width=res), d,
                lodded["light"]), "frame", 8), lodded["ms"]["frame"][0])}
    for route, fn in stepped["steps"].items():
        slice_prof[f"volumetric step, {route} route"] = (profile_kernels(
            f"volumetric fwd+bwd step, {route} route", fn, "step", 10),
            stepped["ms"][f"step_{route}"][0])
    say(f"[profile] {card}: us alone: esvo_stackless_lod "
        f"{us_or(alone['esvo_stackless_lod'])} (at 8 c0 "
        f"{us_or(alone['esvo_stackless_lod 8c0'])}; the first form "
        f"{us_or(alone['esvo_stackless_lod_serial'])}, at 8 c0 "
        f"{us_or(alone['esvo_stackless_lod_serial 8c0'])}), brick_trace_lod "
        f"{us_or(alone['brick_trace_lod'])} (at 8 c0 "
        f"{us_or(alone['brick_trace_lod 8c0'])}; the first form "
        f"{us_or(alone['brick_trace_lod_serial'])}, at 8 c0 "
        f"{us_or(alone['brick_trace_lod_serial 8c0'])}), composite_bwd "
        f"{us_or(alone['composite_bwd'])}; " + "; ".join(
            f"{what} {us_or(p_us)} us of kernels in {count(p_n)} launches, idle "
            f"{idle(p_us, ms)} of its median {ms:.4f} ms"
            for what, ((p_us, _r, p_n), ms) in slice_prof.items()))

    # where the tile frame's and the tile step's host time goes, by group
    for what, fn in (
            ("tile frame", lambda: diff.render_diff_tile(
                *params, ts, o_t, d_t, corners, light, **TILE_BUDGETS)),
            ("tile fwd+bwd step", lambda: diff.loss_and_grads_tile(
                *params, ts, o_t, d_t, corners, light, target0, **TILE_BUDGETS))):
        groups = sorted(host_groups(fn).items(), key=lambda kv: -kv[1][1])
        say(f"[host] {card}: {what}, top-level aten ops and their host us by "
            f"group (one pass, CPU profiler): " + "; ".join(
                f"{g} {n} ops {us:.0f} us" for g, (n, us) in groups)
            + f"; in all {sum(n for n, _u in dict(groups).values())} ops "
            f"{sum(u for _n, u in dict(groups).values()):.0f} us")

    # the probe kernels without their wrappers: one call of each a round
    def probe_round():
        brick_dda.brick_dda16(dda_args[0], dda_args[1], dda_args[2],
                              *dda_args[3:], depth=10, steps=16)
        rowread.rowread_rows(table, rows8)
        gather.take_1d(take_table, take_idx)
        gather.loop_probe(loop_x, loop_table, 2048, 8, 0)
        torch.index_select(table, 0, rows8)
    _, probe_rows, _n = profile_kernels(
        "probe kernels alone (brick_dda16, rowread, take_1d, loop_probe at 2048 "
        "trips, and index_select beside them)", probe_round, "round", 5)
    # the loop probe's two forms alone on each timed case, one call of each a
    # round (the first form's kernel is loop_probe_kernel)
    for case in LOOP_TIMED:
        args = loop_call(loop_inp, case)
        _, rows, _n = profile_kernels(
            f"loop_probe {case}, the ranged form and its first form", lambda a=args: (
                gather.loop_probe(*a), gather.loop_probe_serial(*a)), "round", 2)
        alone[("loop", case)], alone[("loop_serial", case)] = kernel_us(
            rows, "loop_probe_ranged_kernel", "loop_probe_kernel")
    say(f"[profile] {card}: loop_probe (512,128), 8 steps a trip, us alone, the "
        f"ranged form against its first form: " + ", ".join(
            f"{c} {us_or(alone[('loop', c)])} against {us_or(alone[('loop_serial', c)])}"
            for c in LOOP_TIMED))
    # the same kernel in its one-hot mode, on its own so the two do not merge
    profile_kernels("take in its one-hot mode alone", lambda: gather.take_onehot(
        hot_table, hot_idx), "call", 1)

    # ---- 9. the record --------------------------------------------------------
    # bounds: every input read once and every output written once, against
    # the operations this run's data needed (steps actually taken)
    esvo_bound = bound(
        nbytes(o, d, svo.masks, svo.child_base, svo.leaf_base) + n_rays * 5 * 4,
        esvo_steps * OPS_ESVO_STEP + n_rays * OPS_RAY_SETUP)
    # the per-ray routes: rays and results, their tables read once, and the
    # top steps and DDA steps this frame's rays took
    b_res, b_st = routes["brick"]["res"], routes["brick"]["stats"]
    b_dda = int(b_st[:, STAT("dda_steps")].sum())
    b_top = int(b_res.iters.sum()) - b_dda
    brick_bound = bound(
        nbytes(o, d, bsvo.top_masks, bsvo.top_child, bsvo.top_parent, bsvo.bricks)
        + n_rays * 5 * 4,
        b_top * OPS_ESVO_STEP + b_dda * OPS_DDA_STEP + n_rays * OPS_RAY_SETUP)
    s_steps = int(routes["plain"]["res"].iters.sum())
    stackless_bound = bound(
        nbytes(o, d, svo.masks, svo.child_base, svo.parent_ptr, svo.leaf_base)
        + n_rays * 5 * 4, s_steps * OPS_ESVO_STEP + n_rays * OPS_RAY_SETUP)
    # take at full size reads each index once and at most each touched entry
    # once, and writes one value a ray
    take_full_bound = bound(nbytes(big_idx) + int(touched.sum()) * 4
                            + big_idx.numel() * 4, 0)
    us = us_or
    main_walk = walk_rows["main"]
    for wname in WALKS:
        walk_rows[wname].update(
            ms=m[f"walk {wname} G={walk_rows[wname]['G']}"][0],
            ms_first_form=m[f"walk {wname} first"][0],
            us_alone=alone[wname][0], us_alone_first_form=alone[wname][1])
    say(f"[bound] the frame's walks, each launch's own (its rays, lists and "
        f"rows at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s, its DDA steps at "
        f"{PEAK_OPS_PER_S / 1e12:.0f} TFLOP/s): " + "; ".join(
            f"{w} {r['bound_ms']:.5f} ms ({r['bound_by']}), tile_walk "
            f"{us(r['us_alone'])} us alone at G={r['G']}, first form "
            f"{us(r['us_alone_first_form'])} us" for w, r in walk_rows.items())
        + f"; esvo_trace {us(alone['esvo'][0])} us alone, first form "
        f"{us(alone['esvo'][1])} us, bound {esvo_bound[0]:.5f} ms; take_1d at "
        f"full size {us(alone['take'][0])} us alone, index_select "
        f"{us(alone['take'][1])} us, bound {take_full_bound[0]:.5f} ms")
    say(f"[bound] the per-ray routes (24 B of ray in and 20 B of results out a "
        f"ray and their tables once at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s; "
        f"{OPS_ESVO_STEP} operations a top step, {OPS_DDA_STEP} a DDA step and "
        f"{OPS_RAY_SETUP} a ray's set-up at {PEAK_OPS_PER_S / 1e12:.0f} TFLOP/s): "
        f"brick_trace {b_top} top steps and {b_dda} DDA steps, bound "
        f"{brick_bound[0]:.5f} ms ({brick_bound[1]}), {us(alone['brick_trace'])} "
        f"us alone (first form {us(alone[('brick_trace', 'first')])}, wide form "
        f"without staged rows {us(alone[('brick_trace', 'unstaged')])}); "
        f"esvo_stackless {s_steps} steps, "
        f"bound {stackless_bound[0]:.5f} ms ({stackless_bound[1]}), "
        f"{us(alone['esvo_stackless'])} us alone (first form "
        f"{us(alone[('esvo_stackless', 'first')])}); esvo_trace {esvo_steps} steps, "
        f"bound {esvo_bound[0]:.5f} ms")
    for cname in CAND_CALLS:
        new_us, first_us, other_us, radix_us = alone[f"phase1 {cname}"]
        cand_rows[cname].update(
            ms=m[f"phase1 {cname}"][0], plain_ms=m[f"phase1 {cname} plain"][0],
            ms_first_form=m[f"phase1 {cname} first"][0],
            ms_other_warps=m[f"phase1 {cname} other"][0], us_alone=new_us,
            us_alone_first_form=first_us, us_alone_other_warps=other_us,
            ms_radix=m[f"phase1 {cname} radix"][0], us_alone_radix=radix_us)
    say(f"[bound] tile_candidates, each of the frame's calls (its corners, a "
        f"pyramid word a kept cell, a cellmap row a valid candidate and its "
        f"outputs at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s; {OPS_CAND_SLOT} "
        f"operations a child slot and {OPS_CAND_CHILD} an occupied child at "
        f"{PEAK_OPS_PER_S / 1e12:.0f} TFLOP/s; the sort not counted): " + "; ".join(
            f"{c} {r['bound_ms']:.5f} ms ({r['bound_by']}; {r['bytes'] / 1e6:.3f} "
            f"MB, {r['ops'] / 1e6:.1f} M operations), {us(r['us_alone'])} us "
            f"alone at {r['warps']} warps a tile ({us(r['us_alone_other_warps'])} "
            f"at {9 - r['warps']}; the first form {us(r['us_alone_first_form'])}; "
            f"the radix form, off the path, {us(r['us_alone_radix'])}), "
            f"{r['ms']:.4f} ms in turns against the first form's "
            f"{r['ms_first_form']:.4f}, the radix form's {r['ms_radix']:.4f} and the "
            f"plain version's {r['plain_ms']:.4f}"
            for c, r in cand_rows.items()))
    dda_bound = bound(nbytes(*dda_args) + n_dda * 3 * 4, dda_walked * OPS_DDA_STEP)
    row_bound = bound(nbytes(rows8) + 2 * 8 * 128 * 4, 0)
    n_hits = int((hit_leaf >= 0).sum())
    # a parameter row is read only for a hit: count each touched leaf's
    # 28 B once, not the whole table
    row_bytes = int(touched.sum()) * 28 + nbytes(light)
    fwd_bound = bound(nbytes(hit_leaf, d) + n_rays * 12 + row_bytes,
                      n_hits * OPS_SHADE_FWD)
    bwd_bound = bound(nbytes(hit_leaf, d, g_step) + n_rays * 28 + row_bytes,
                      n_hits * OPS_SHADE_BWD)
    # segment_sum's bound reads the function, not an implementation: every
    # ray's hit_leaf once, each hit's 28 B cotangent row once, each output
    # once (28 B a leaf). The sorted form computes the same function, so the
    # same bound stands beside it; its keys and permutation do not count.
    seg_bound = bound(nbytes(hit_leaf) + n_hits * 28 + n_leaves * 28, n_hits * 7)
    say(f"[bound] {n_hits} hits on {int(touched.sum())} leaves: shade_fwd "
        f"{fwd_bound[0]:.4f} ms, shade_bwd {bwd_bound[0]:.4f}, segment_sum "
        f"{seg_bound[0]:.4f} ({(nbytes(hit_leaf) + n_hits * 28 + n_leaves * 28) / 1e6:.1f} "
        f"MB: hit_leaf, the hits' rows, every output) against "
        f"{m['segment_sum'][0]:.4f} for the sort-free form and "
        f"{m['segment_sorted_whole'][0]:.4f} for the sorted form with its sort")
    take_bound = bound(nbytes(take_table, take_idx) + take_idx.numel() * 4, 0)
    # the loop probe's floors at the SM clock that nvidia-smi reads while the
    # first form runs (the card idles at a lower one); the table's old bound,
    # its operations at 67 TFLOP/s, beside them
    clock_now, clock_max = sm_clock_mhz(
        lambda: gather.loop_probe_serial(*loop_call(loop_inp, (2048, 0))), 1000)
    floors = loop_floors(loop_x.numel(), 2048, 8, clock_now)
    loop_old_bound = bound(2 * nbytes(loop_x),
                           loop_x.numel() * 2048 * 8 * LOOP_STEP_ISSUES)
    say(f"[bound] {card}: loop_probe (512,128), 2048 trips of 8 steps without a "
        f"gather, at the SM clock read under load, {clock_now:.0f} MHz (its "
        f"maximum {clock_max:.0f}): the issue floor {floors['issue_ms']:.5f} ms "
        f"({LOOP_STEP_ISSUES} FP32 instructions a step, {H100_SMS} SMs of "
        f"{FP32_LANES_AN_SM} lanes a cycle), the latency floor "
        f"{floors['latency_ms']:.5f} ms ({LOOP_STEP_CHAIN} dependent FP32 "
        f"operations a step, {FP32_LATENCY_CYCLES} cycles each): the "
        f"{floors['binds']} floor binds; the ranged form "
        f"{us_or(alone[('loop', (2048, 0))])} us alone, its first form "
        f"{us_or(alone[('loop_serial', (2048, 0))])}; the same operations at "
        f"{PEAK_OPS_PER_S / 1e12:.0f} TFLOP/s {loop_old_bound[0]:.5f} ms")
    src = "raytracingtest_tpu_torch/csrc/"
    kernels = [
        dict(name="esvo_trace", route="cuda", source=src + "esvo_trace.cu",
             replaces="raytracingtest_tpu/ops/traverse_pallas.py:55",
             path="diff.render_diff_cuda", launches=esvo_launches,
             max_abs_err=err["esvo_trace"], ms=m["esvo_turns"][0],
             plain_ms=esvo_plain_ms, bound_ms=esvo_bound[0],
             bound_by=esvo_bound[1], library_ms=None,
             ms_first_form=m["esvo_first_turns"][0], us_alone=alone["esvo"][0],
             us_alone_first_form=alone["esvo"][1]),
        dict(name="esvo_trace_serial", route="cuda",
             source=src + "esvo_trace.cu",
             replaces="raytracingtest_tpu/ops/traverse_pallas.py:55",
             path="traverse_cuda.trace_cuda_serial (the first form, off the "
                  "main path)", launches=first_launches["esvo_trace_serial"],
             max_abs_err=err["esvo_trace_serial"], ms=m["esvo_first_turns"][0],
             plain_ms=esvo_plain_ms, bound_ms=esvo_bound[0],
             bound_by=esvo_bound[1], library_ms=None),
        dict(name="tile_walk", route="cuda", source=src + "tile_walk.cu",
             replaces="raytracingtest_tpu/ops/tile.py:432",
             path="diff.render_diff_tile", launches=tile_launches,
             max_abs_err=err["tile_walk"], ms=main_walk["ms"],
             plain_ms=walk_plain_ms, bound_ms=main_walk["bound_ms"],
             bound_by=main_walk["bound_by"], library_ms=None, walks=walk_rows),
        dict(name="tile_walk_serial", route="cuda", source=src + "tile_walk.cu",
             replaces="raytracingtest_tpu/ops/tile.py:432",
             path="tile_cuda.tile_walk_serial (the first form, off the main "
                  "path)", launches=first_launches["tile_walk_serial"],
             max_abs_err=err["tile_walk_serial"],
             ms=main_walk["ms_first_form"], plain_ms=walk_plain_ms,
             bound_ms=main_walk["bound_ms"], bound_by=main_walk["bound_by"],
             library_ms=None),
        dict(name="tile_candidates", route="cuda",
             source=src + "tile_candidates.cu",
             replaces="raytracingtest_tpu/ops/tile.py:288",
             path="diff.render_diff_tile / diff.loss_and_grads_tile",
             launches=cand_launches, max_abs_err=err["tile_candidates"],
             ms=cand_rows["main"]["ms"], plain_ms=cand_rows["main"]["plain_ms"],
             bound_ms=cand_rows["main"]["bound_ms"],
             bound_by=cand_rows["main"]["bound_by"], library_ms=None,
             us_alone=cand_rows["main"]["us_alone"],
             ms_first_form=cand_rows["main"]["ms_first_form"],
             us_alone_first_form=cand_rows["main"]["us_alone_first_form"],
             calls=cand_rows),
        dict(name="tile_candidates_block", route="cuda",
             source=src + "tile_candidates.cu",
             replaces="raytracingtest_tpu/ops/tile.py:288",
             path="tile_cuda.candidates_block (the first form, off the main "
                  "path)", launches=first_launches["tile_candidates_block"],
             max_abs_err=err["tile_candidates_block"],
             ms=cand_rows["main"]["ms_first_form"],
             plain_ms=cand_rows["main"]["plain_ms"],
             bound_ms=cand_rows["main"]["bound_ms"],
             bound_by=cand_rows["main"]["bound_by"], library_ms=None,
             us_alone=cand_rows["main"]["us_alone_first_form"]),
        dict(name="brick_dda16", route="cuda", source=src + "tile_walk.cu",
             replaces="scratch/r4_pallas2.py:115",
             path="brick_dda.brick_dda16", launches=dda_launches,
             max_abs_err=err["brick_dda16"], ms=m["dda"][0],
             plain_ms=m["dda_plain"][0], bound_ms=dda_bound[0],
             bound_by=dda_bound[1], library_ms=None),
        dict(name="rowread", route="cuda", source=src + "tile_walk.cu",
             replaces="scratch/r4_pallas.py:38",
             path="rowread.rowread_scalar/_min/_rows", launches=row_launches,
             max_abs_err=err["rowread"], ms=m["row"][0],
             plain_ms=m["row_plain"][0], bound_ms=row_bound[0],
             bound_by=row_bound[1], library_ms=m["row_library"][0]),
        dict(name="take", route="cuda", source=src + "shade.cu",
             replaces="scratch/probe_kernel.py:85",
             path="gather.take_1d/_onehot/_along0/_along_lane",
             launches=take_launches, max_abs_err=err["take"], ms=m["take"][0],
             plain_ms=m["take_plain"][0], bound_ms=take_bound[0],
             bound_by=take_bound[1], library_ms=m["take_library"][0],
             ms_full_size=m["take_full_turns"][0],
             library_ms_full_size=m["take_full_library_turns"][0],
             us_alone_full_size=alone["take"][0],
             library_us_alone_full_size=alone["take"][1],
             bound_ms_full_size=take_full_bound[0]),
        *(dict(name=kname, route="cuda", source=src + "shade.cu",
               replaces="scratch/probe2.py:80", path=path, launches=launches,
               max_abs_err=err[kname], ms=m[f"{form} (2048, 0)"][0],
               plain_ms=loop_plain_ms[(2048, 0)], bound_ms=floors["bound_ms"],
               bound_by="operations", library_ms=None,
               us_alone=alone[(form, (2048, 0))], floor_binds=floors["binds"],
               issue_floor_ms=floors["issue_ms"], latency_floor_ms=floors["latency_ms"],
               sm_clock_mhz=clock_now, bound_ms_at_67_tflops=loop_old_bound[0],
               **{f"ms {c}": m[f"{form} {c}"][0] for c in LOOP_TIMED},
               **{f"us_alone {c}": alone[(form, c)] for c in LOOP_TIMED})
          for kname, form, path, launches in (
              ("loop_probe", "loop", "gather.loop_probe (the ranged form)",
               loop_launches),
              ("loop_probe_serial", "loop_serial",
               "gather.loop_probe_serial (the first form, off every path)",
               first_launches["loop_probe_serial"]))),
        dict(name="shade_fwd", route="cuda", source=src + "shade.cu",
             replaces="raytracingtest_tpu/diff.py:35",
             path="diff.loss_and_grads_cuda",
             launches=train_launches["per-ray"]["shade_fwd"],
             max_abs_err=err["shade_fwd"], ms=m["shade_fwd"][0],
             plain_ms=m["shade_fwd_plain"][0], bound_ms=fwd_bound[0],
             bound_by=fwd_bound[1], library_ms=None),
        dict(name="shade_bwd", route="cuda", source=src + "shade.cu",
             replaces="raytracingtest_tpu/diff.py:132",
             path="diff.loss_and_grads_cuda",
             launches=train_launches["per-ray"]["shade_bwd"],
             max_abs_err=err["shade_bwd"], ms=m["bwd_turns"][0],
             plain_ms=m["shade_bwd_plain"][0], bound_ms=bwd_bound[0],
             bound_by=bwd_bound[1], library_ms=None,
             ms_first_form=m["bwd_first_turns"][0],
             us_alone=alone["shade_bwd"][0],
             us_alone_first_form=alone["shade_bwd"][1],
             us_in_step=kernel_us(step_rows, "shade_bwd_kernel")[0]),
        dict(name="shade_bwd_serial", route="cuda", source=src + "shade.cu",
             replaces="raytracingtest_tpu/diff.py:132",
             path="shade_cuda.shade_bwd_serial (the first form, off the "
                  "training path)", launches=first_launches["shade_bwd_serial"],
             max_abs_err=err["shade_bwd_serial"], ms=m["bwd_first_turns"][0],
             plain_ms=m["shade_bwd_plain"][0], bound_ms=bwd_bound[0],
             bound_by=bwd_bound[1], library_ms=None,
             us_alone=alone["shade_bwd"][1]),
        dict(name="segment_sum", route="cuda", source=src + "shade.cu",
             replaces="raytracingtest_tpu/diff.py:72",
             path="diff.loss_and_grads_cuda",
             launches=train_launches["per-ray"]["segment_sum"],
             max_abs_err=err["segment_sum"], ms=m["segment_sum"][0],
             plain_ms=m["segment_plain"][0], bound_ms=seg_bound[0],
             bound_by=seg_bound[1], library_ms=m["segment_library"][0],
             kernels_us=seg_kernel_us),
        dict(name="segment_sum_sorted", route="cuda", source=src + "shade.cu",
             replaces="raytracingtest_tpu/diff.py:72",
             path="shade_cuda.sort_by_leaf + segment_sum_sorted (the sorted "
                  "form, off the training path)",
             launches=sorted_launches, max_abs_err=err["segment_sum_sorted"],
             ms=m["segment_sorted_whole"][0], plain_ms=m["segment_plain"][0],
             bound_ms=seg_bound[0], bound_by=seg_bound[1],
             library_ms=m["segment_library"][0]),
    ]
    # the brick and stackless traces: the main path's line carries the other
    # forms' times and every form's warp counters; the brick trace's other
    # forms have lines of their own
    per_ray = dict(
        brick_trace=dict(replaces="raytracingtest_tpu/ops/brick.py:492",
                         path="diff.render_diff_brick / diff.loss_and_grads_brick / "
                              "InverseRenderer.step", route="brick", turns="trace_brick",
                         plain="brick_plain", bound=brick_bound),
        esvo_stackless=dict(replaces="raytracingtest_tpu/ops/traverse.py:530",
                            path="diff.render_diff / diff.loss_and_grads",
                            route="plain", turns="trace_stackless",
                            plain="stackless_plain", bound=stackless_bound))
    for kname, row in per_ray.items():
        common = dict(route="cuda", source=src + "brick_trace.cu",
                      replaces=row["replaces"], plain_ms=m[row["plain"]][0],
                      bound_ms=row["bound"][0], bound_by=row["bound"][1],
                      library_ms=None)
        kernels.append(dict(
            name=kname, **common, path=row["path"] + f" (the {MAIN_FORM[kname]} form)",
            launches=routes[row["route"]]["launches"], max_abs_err=err[kname],
            ms=m[f"{row['turns']}_turns"][0], us_alone=alone[kname],
            launches_train_step=train_launches[row["route"]][kname],
            **(dict(ms_first_form=m["trace_stackless_first_turns"][0],
                    us_alone_first_form=alone[(kname, "first")],
                    block=brick_cuda.BLOCKS[(kname, "patched")],
                    variants=patched[kname])
               if kname != "brick_trace" else dict(
                ms_first_form=m["trace_brick_first_turns"][0],
                us_alone_first_form=alone[(kname, "first")],
                ms_unstaged_form=m["trace_brick_unstaged_turns"][0],
                us_alone_unstaged_form=alone[(kname, "unstaged")])),
            warps={form: warp_counts[(kname, form)] for form in brick_cuda.FORMS[kname]}))
        if kname == "esvo_stackless":
            kernels.append(dict(
                name="esvo_stackless_serial", **common,
                path="brick_cuda.trace_stackless_cuda_serial (the first form, off "
                     "the main path)",
                launches=first_launches["esvo_stackless_serial"],
                max_abs_err=err["esvo_stackless_serial"],
                ms=m["trace_stackless_first_turns"][0], us_alone=alone[(kname, "first")]))
        if kname == "brick_trace":
            kernels += [dict(name=f"brick_trace_{suffix}", **common,
                             path=f"brick_cuda.{call} ({what}, off the main path)",
                             launches=first_launches[f"brick_trace_{suffix}"],
                             max_abs_err=err[f"brick_trace_{suffix}"],
                             ms=m[f"trace_brick_{form}_turns"][0],
                             us_alone=alone[(kname, form)])
                        for suffix, form, call, what in (
                            ("serial", "first", "trace_brick_cuda_serial", "the first form"),
                            ("unstaged", "unstaged", "_brick_unstaged_kernel",
                             "the wide form without staged rows"))]
    # the k-segment traces and the compositing: bounds from this run's
    # segments and steps; ids in, each segment's 12 B out (a padded slot
    # too), each touched leaf's 28 B row read once
    kb = served["multi"][0][0]
    n_seg_b, b_top_m, b_dda_m = served["segments"]["brick"]
    n_seg_s, s_steps_m = served["segments"]["stackless"]
    seg_out = n_rays * VOLUME_K * 12 + n_rays * 8
    multi_rows = dict(
        brick_trace_multi=dict(
            replaces="raytracingtest_tpu/ops/brick.py:574",
            path="VolumetricRenderer.render / diff.render_volumetric_brick",
            other="trace_brick_multi_cuda_serial",
            plain_ms=served["brick_multi_plain_ms"], bound=bound(
                nbytes(o, d, bsvo.top_masks, bsvo.top_child, bsvo.top_parent,
                       bsvo.bricks) + seg_out,
                b_top_m * OPS_ESVO_STEP + b_dda_m * OPS_DDA_STEP
                + n_rays * OPS_RAY_SETUP)),
        esvo_stackless_multi=dict(
            replaces="raytracingtest_tpu/ops/traverse.py:684",
            path="diff.render_volumetric",
            plain_ms=served["stackless_multi_plain_ms"], bound=bound(
                nbytes(o, d, svo.masks, svo.child_base, svo.parent_ptr,
                       svo.leaf_base) + seg_out,
                s_steps_m * OPS_ESVO_STEP + n_rays * OPS_RAY_SETUP)))
    seg_leaves = kb.hit_leaf[kb.hit_leaf >= 0].long()
    touched_v = int((torch.bincount(seg_leaves, minlength=n_leaves) > 0).sum())
    composite_bound = bound(
        nbytes(kb.hit_leaf, kb.t_in, kb.t_out, d, light) + touched_v * 28
        + n_rays * 12,
        int(seg_leaves.numel()) * OPS_COMPOSITE_SLOT + n_rays * OPS_COMPOSITE_RAY)
    say(f"[bound] the volumetric kernels, k={VOLUME_K} (rays, tables and (N, k) "
        f"segments at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s; {OPS_ESVO_STEP} "
        f"operations a top or stackless step, {OPS_DDA_STEP} a DDA step, "
        f"{OPS_COMPOSITE_SLOT} a valid slot at {PEAK_OPS_PER_S / 1e12:.0f} "
        f"TFLOP/s): brick_trace_multi {b_top_m} top and {b_dda_m} DDA steps, "
        f"bound {multi_rows['brick_trace_multi']['bound'][0]:.5f} ms "
        f"({multi_rows['brick_trace_multi']['bound'][1]}), "
        f"{us_or(alone['brick_trace_multi'])} us alone; esvo_stackless_multi "
        f"{s_steps_m} steps, bound {multi_rows['esvo_stackless_multi']['bound'][0]:.5f} "
        f"ms ({multi_rows['esvo_stackless_multi']['bound'][1]}), "
        f"{us_or(alone['esvo_stackless_multi'])} us alone (first form "
        f"{us_or(alone['esvo_stackless_multi_serial'])}); composite_fwd "
        f"{n_seg_b} segments on {touched_v} leaves, bound {composite_bound[0]:.5f} "
        f"ms ({composite_bound[1]}), {us_or(alone['composite_fwd'])} us alone")
    for kname, row in multi_rows.items():
        common = dict(route="cuda", source=src + "brick_trace.cu",
                      replaces=row["replaces"], plain_ms=row["plain_ms"],
                      bound_ms=row["bound"][0], bound_by=row["bound"][1],
                      library_ms=None)
        if kname == "esvo_stackless_multi":
            kernels += [
                dict(name=kname, **common, path=row["path"] + " (the patched form)",
                     launches=served["launches"][kname], max_abs_err=err[kname],
                     ms=vm[kname][0], us_alone=alone[kname], other_form="first",
                     ms_other_form=vm[kname + "_serial"][0],
                     us_alone_other_form=alone[kname + "_serial"],
                     block=brick_cuda.BLOCKS[(kname, "patched")],
                     variants=patched[kname],
                     warps={form: served["warps"][(kname, form)]
                            for form in brick_cuda.FORMS[kname]}),
                dict(name=kname + "_serial", **common,
                     path="brick_cuda.trace_multi_cuda_serial (the first form, off "
                          "the main path)",
                     launches=first_launches[kname + "_serial"],
                     max_abs_err=err[kname + "_serial"], ms=vm[kname + "_serial"][0],
                     us_alone=alone[kname + "_serial"])]
            continue
        kernels += [
            dict(name=kname, **common, path=row["path"] + " (the staged form)",
                 launches=served["launches"][kname], max_abs_err=err[kname],
                 ms=vm[kname][0], us_alone=alone[kname], other_form="first",
                 ms_other_form=vm[kname + "_serial"][0],
                 us_alone_other_form=alone[kname + "_serial"],
                 staged_block=STAGED_BLOCK,
                 ms_by_k={kk: dict(ms=v["staged"][0], ms_other_form=v["first"][0])
                          for kk, v in served["ms_by_k"].items()},
                 warps={form: served["warps"][(kname, form)]
                        for form in brick_cuda.FORMS[kname]}),
            dict(name=kname + "_serial", **common,
                 path=f"brick_cuda.{row['other']} (the first form, off the main path)",
                 launches=first_launches[kname + "_serial"],
                 max_abs_err=err[kname + "_serial"], ms=vm[kname + "_serial"][0],
                 us_alone=alone[kname + "_serial"])]
    kernels.append(dict(
        name="composite_fwd", route="cuda", source=src + "shade.cu",
        replaces="raytracingtest_tpu/diff.py:377",
        path="VolumetricRenderer.render / diff.render_volumetric[_brick]",
        launches=served["launches"]["composite_fwd"],
        max_abs_err=err["composite_fwd"], ms=vm["composite_fwd"][0],
        plain_ms=vm["composite_plain"][0], bound_ms=composite_bound[0],
        bound_by=composite_bound[1], library_ms=None,
        us_alone=alone["composite_fwd"]))
    # the LOD traces at c0 and 8 c0: rays, tables and six outputs a ray
    # once; the top and DDA steps each coefficient's rays took
    lod_steps, lod_bounds = {}, {}
    for cname in ("c0", "8c0"):
        lb, ls_ = lodded[cname]
        lb_dda = int(lb[1][:, STAT("dda_steps")].sum())
        lod_steps[cname] = (int(lb[0].iters.sum()) - lb_dda, lb_dda,
                            int(ls_[0].iters.sum()))
        lb_top, lb_dda, ls_steps = lod_steps[cname]
        lod_bounds[cname] = dict(
            brick_trace_lod=bound(
                nbytes(o, d, bsvo.top_masks, bsvo.top_child, bsvo.top_parent,
                       bsvo.bricks) + n_rays * 6 * 4,
                lb_top * OPS_ESVO_STEP + lb_dda * OPS_DDA_STEP + n_rays * OPS_RAY_SETUP),
            esvo_stackless_lod=bound(
                nbytes(o, d, svo.masks, svo.child_base, svo.parent_ptr, svo.leaf_base)
                + n_rays * 6 * 4, ls_steps * OPS_ESVO_STEP + n_rays * OPS_RAY_SETUP))
    lb_top, lb_dda, ls_steps = lod_steps["c0"]
    lod_rows = dict(
        brick_trace_lod=dict(
            replaces="raytracingtest_tpu/ops/brick.py:789",
            path="the LOD frame of cli render --lod-coef: trace_brick_lod_cuda, "
                 "lod.shade_lod (the patched form)", plain_ms=lodded["plain_ms"]["c0"][0],
            bound=lod_bounds["c0"]["brick_trace_lod"],
            bound_8c0=lod_bounds["8c0"]["brick_trace_lod"]),
        esvo_stackless_lod=dict(
            replaces="raytracingtest_tpu/ops/traverse.py:816",
            path="lod.render_lod", plain_ms=lodded["plain_ms"]["c0"][1],
            bound=lod_bounds["c0"]["esvo_stackless_lod"],
            bound_8c0=lod_bounds["8c0"]["esvo_stackless_lod"]))
    # composite_bwd on the brick route's step: the cotangent, segments and
    # rays in, each touched leaf's row once, a 28 B row a slot out
    bwd_bound = bound(
        nbytes(stepped["bwd_args"][0], kb.hit_leaf, kb.t_in, kb.t_out, d, light)
        + touched_v * 28 + kb.hit_leaf.numel() * 28,
        int(seg_leaves.numel()) * OPS_COMPOSITE_BWD_SLOT + n_rays * OPS_COMPOSITE_RAY)
    say(f"[bound] the LOD traces at c0 ({OPS_ESVO_STEP} operations a top or "
        f"stackless step, {OPS_DDA_STEP} a DDA step): brick_trace_lod {lb_top} top "
        f"and {lb_dda} DDA steps, bound {lod_rows['brick_trace_lod']['bound'][0]:.5f} "
        f"ms ({lod_rows['brick_trace_lod']['bound'][1]}), "
        f"{us_or(alone['brick_trace_lod'])} us alone; esvo_stackless_lod {ls_steps} "
        f"steps, bound {lod_rows['esvo_stackless_lod']['bound'][0]:.5f} ms "
        f"({lod_rows['esvo_stackless_lod']['bound'][1]}), "
        f"{us_or(alone['esvo_stackless_lod'])} us alone (first form "
        f"{us_or(alone['esvo_stackless_lod_serial'])}); at 8 c0 brick_trace_lod "
        f"{lod_steps['8c0'][0]} top and {lod_steps['8c0'][1]} DDA steps "
        f"({(lod_steps['8c0'][0] + lod_steps['8c0'][1]) / n_rays:.2f} a ray), bound "
        f"{lod_rows['brick_trace_lod']['bound_8c0'][0]:.5f} ms "
        f"({lod_rows['brick_trace_lod']['bound_8c0'][1]}), "
        f"{us_or(alone['brick_trace_lod 8c0'])} us alone (first form "
        f"{us_or(alone['brick_trace_lod_serial 8c0'])}), esvo_stackless_lod "
        f"{lod_steps['8c0'][2]} steps, bound "
        f"{lod_rows['esvo_stackless_lod']['bound_8c0'][0]:.5f} ms, "
        f"{us_or(alone['esvo_stackless_lod 8c0'])} us alone; composite_bwd "
        f"({OPS_COMPOSITE_BWD_SLOT} operations a valid slot) {n_seg_b} segments "
        f"on {touched_v} leaves, bound {bwd_bound[0]:.5f} ms ({bwd_bound[1]}), "
        f"{us_or(alone['composite_bwd'])} us alone")
    sm = stepped["ms"]
    lod_rows["esvo_stackless_lod_serial"] = dict(
        lod_rows["esvo_stackless_lod"],
        path="brick_cuda.trace_lod_cuda_serial (the first form, off the main path)")
    lod_rows["esvo_stackless_lod"]["path"] += " (the patched form)"
    lod_rows["brick_trace_lod_serial"] = dict(
        lod_rows["brick_trace_lod"],
        path="brick_cuda.trace_brick_lod_cuda_serial (the first form, off the main path)")
    for kname, row in lod_rows.items():
        kernels.append(dict(
            name=kname, route="cuda", source=src + "brick_trace.cu",
            replaces=row["replaces"], path=row["path"],
            launches=(first_launches[kname] if kname.endswith("_serial")
                      else lodded["launches"][kname]), max_abs_err=err[kname],
            ms=lodded["ms"][kname][0], plain_ms=row["plain_ms"],
            bound_ms=row["bound"][0], bound_by=row["bound"][1], library_ms=None,
            us_alone=alone[kname], coef=LOD_C0, ms_8c0=lodded["ms"][kname + "_8c0"][0],
            us_alone_8c0=alone[kname + " 8c0"], bound_ms_8c0=row["bound_8c0"][0],
            bound_by_8c0=row["bound_8c0"][1],
            **({} if kname != "esvo_stackless_lod" else dict(
                variants=patched["esvo_stackless_lod c0"],
                variants_8c0=patched["esvo_stackless_lod 8c0"])),
            **({} if kname != "brick_trace_lod" else dict(
                block=brick_cuda.BLOCKS[("brick_trace_lod", "patched")],
                variants=brick_lodded["c0"], variants_8c0=brick_lodded["8c0"],
                variants_0=brick_lodded["0"]))))
    kernels.append(dict(
        name="composite_bwd", route="cuda", source=src + "shade.cu",
        replaces="raytracingtest_tpu/diff.py:377",
        path="the volumetric step: diff.volumetric_l2_loss / "
             "diff.render_volumetric_brick under torch.autograd.grad",
        launches=stepped["launches"]["brick"]["composite_bwd"],
        max_abs_err=err["composite_bwd"], ms=sm["composite_bwd"][0],
        plain_ms=sm["composite_bwd_plain"][0], bound_ms=bwd_bound[0],
        bound_by=bwd_bound[1], library_ms=None, us_alone=alone["composite_bwd"],
        fwdbwd_over_fwd=stepped["fwdbwd_over_fwd"]))
    replaces = dict(svo_columns=57, svo_expand=57, svo_compact=80, svo_leaves=143,
                    svo_leaf_attrs=323, svo_level_pass=163, svo_level_up=163,
                    svo_parent_ptr=341, svo_leaves_serial=143, svo_expand_serial=57)
    bl = built["leaf"]
    bm, bb, ex = built["ms"], built["bounds"], built["expansion"]
    leaf_extra = dict(
        svo_expand=dict(
            function_ms_in_turns=bm["svo_expand_function"],
            function_bound_ms=bb["svo_expand_function"][0],
            function_bound_by=bb["svo_expand_function"][1],
            function_us_alone_a_build=sum(r["columns_us"] + r["expand_us"] for r in ex),
            first_form_ms_in_turns=bm["svo_expand_serial"],
            first_form_us_alone_a_build=sum(r["first_form_us"] for r in ex),
            evaluations=sum(r["evals"] for r in ex),
            evaluations_reference=sum(r["children"] for r in ex),
            expansions_checked=built["expansions_checked"],
            per_level=[{k: r[k] for k in ("level", "parents", "side", "evals",
                                           "columns_us", "expand_us", "first_form_us")}
                       for r in ex]),
        svo_leaves=dict(evaluations=bl["evals"], evaluations_reference=bl["ref_evals"],
                        probes=bl["probes"], probes_by_source=bl["by_kind"],
                        first_form_ms_in_turns=built["ms"]["svo_leaves_serial"],
                        phase_b_ms=built["ms"]["phase_b"],
                        phase_b_first_form_ms=built["ms"]["phase_b_first_form"],
                        kernels_us=dict(built["leaf_kernels"]),
                        bound_first_form_ms=built["bounds"]["svo_leaves_serial"][0]),
        svo_leaf_attrs=dict(leaf_warps_of_the_first_form=bl["leaf_warps"],
                            warps=bl["warps"]),
        svo_compact=dict(library_ms_indices_alone=built["ms"]["svo_compact_library"],
                         library_ms_with_gather=built["ms"]["svo_compact_library_gather"]),
        svo_level_pass=dict(
            also_replaces="raytracingtest_tpu/ops/octree_device.py:341",
            us_alone_at_level_9=built["cd_us"]["svo_level_pass"]["us"],
            surviving_parents_at_level_9=built["level_parents"],
            first_form_ms_in_turns=bm["level_up_first_form"],
            first_form_us_alone_at_level_9=built["cd_us"]["level_up_first_form"]["us"],
            first_form_launches_at_level_9=built["cd_us"]["level_up_first_form"]["launches"],
            first_form_bound_ms=bb["level_up_first_form"][0],
            library_us_alone=built["cd_us"]["level_up_library"]["us"],
            passes_checked=built["passes_checked"],
            phases={w: {p: dict(us=r[0], launches=r[1], copies=r[2], host_syncs=r[3])
                        for p, r in rows.items()} for w, rows in built["phases"].items()}),
        svo_level_up=dict(us_alone_at_level_9=built["cd_us"]["svo_level_up"]["us"]),
        svo_parent_ptr=dict(us_alone=built["cd_us"]["svo_parent_ptr"]["us"],
                            library_us_alone=built["cd_us"]["parent_ptr_library"]["us"]))
    first_forms = {
        "svo_leaves_serial": ("octree_cuda.leaves_serial (the leaf test's first form, off "
                              "the main path), at the build's leaf test", built["serial_us"]),
        "svo_expand_serial": ("octree_cuda.expand_serial (the expansion's first form, off "
                              "the main path), at the build's level 10",
                              sum(r["first_form_us"] for r in ex)),
        "svo_level_up": ("octree_cuda.level_up_serial (phase C's first form, off the main "
                         "path), at the build's level 9",
                         built["cd_us"]["svo_level_up"]["us"]),
        "svo_parent_ptr": ("octree_cuda.parent_ptr (phase D's first form, off the main "
                           "path), over the depth-10 tree",
                           built["cd_us"]["svo_parent_ptr"]["us"])}
    library = dict(svo_compact=built["ms"]["svo_compact_library_whole"],
                   svo_level_pass=built["ms"]["level_up_library"],
                   svo_level_up=built["ms"]["level_up_library"],
                   svo_parent_ptr=built["ms"]["parent_ptr_library"])
    for kname in (*BUILD_KERNELS, *first_forms):
        serial = kname in first_forms
        kernels.append(dict(
            name=kname, route="cuda", source=src + "svo_build.cu",
            replaces=f"raytracingtest_tpu/ops/octree_device.py:{replaces[kname]}",
            path=(first_forms[kname][0] if serial else
                  "octree_device.build_svo_device (bench.py's BENCH_BUILD=device), "
                  "terrain depth 10"),
            launches=0 if serial else built["launches"][kname], max_abs_err=err[kname],
            ms=built["ms"][kname], plain_ms=built["plain_ms"][kname],
            bound_ms=built["bounds"][kname][0], bound_by=built["bounds"][kname][1],
            library_ms=library.get(kname),
            us_alone_a_build=first_forms[kname][1] if serial else built["prof"]["us"][kname],
            **leaf_extra.get(kname, {})))
    fk = flown
    streamed = fk["prof"]["streamed tile frame"]
    brick_prof = fk["prof"]["brick path frame"]
    # the tracer's device us a frame in every instantiation named `key`,
    # and the launches of them it saw (it drops some: see [fly])
    alone_us = lambda p, key: sum(v for k, v in p["by"].items() if key in k)
    seen = lambda p, key: sum(v for k, v in p["n_by"].items() if key in k)
    for kname, source, line, path, ms, bnd, extra in (
            ("tile_candidates_mapped", "tile_candidates.cu", 579,
             "StreamingRenderer.render / cli fly --path tile: trace_clipmap_tile's "
             "three phase-1 calls a LOD",
             fk["kern_ms"]["tile_candidates_mapped"], fk["mapped"][0]["bound"],
             dict(shape=f"the streamed frame's main call, T={fk['mapped'][0]['T']} "
                        f"K={fk['mapped'][0]['K']}",
                  form="radix", first_form="tile_candidates_mapped_first",
                  probe="tile_cuda.probe_candidates",
                  us_alone=fk["cand_parity"]["parity main"]["radix"]["us_alone"],
                  ms_first_form=fk["cand_parity"]["parity main"]["first"]["ms"],
                  us_alone_first_form=fk["cand_parity"]["parity main"]["first"]["us_alone"],
                  us_traced_a_fly_frame=alone_us(streamed, "tile_candidates_radix_kernel"),
                  launches_traced_a_fly_frame=seen(streamed, "tile_candidates_radix_kernel"),
                  calls={name: cand_record(row) for name, row in
                         (fk["cand_parity"] | fk["cand_fly"]).items()},
                  fly_frame_calls=[dict(call=r["name"], top_depth=r["top_depth"], T=r["T"],
                                        K=r["K"], valid=r["valid"], bound_ms=r["bound"][0],
                                        bound_by=r["bound"][1])
                                   for r in fk["fly_mapped"]])),
            ("clipmap_trace", "brick_trace.cu", 879,
             "stream.clipmap.trace_clipmap_device (the node arena)",
             fk["kern_ms"]["clipmap_trace parity rays"], fk["work"]["clipmap_trace"]["bound"],
             dict(shape=f"{FLY_PARITY_RES}² rays, the whole world at depth 10",
                  **fly_k10(fk, "clipmap_trace"))),
            ("clipmap_trace_brick", "brick_trace.cu", 965,
             "cli fly --path brick: trace_clipmap_device_brick",
             fk["kern_ms"]["clipmap_trace_brick parity rays"],
             fk["work"]["clipmap_trace_brick"]["bound"],
             dict(shape=f"{FLY_PARITY_RES}² rays, the whole world at depth 10",
                  **fly_k10(fk, "clipmap_trace_brick"),
                  us_traced_a_fly_frame=alone_us(brick_prof, CLIP_KERNELS["clipmap_trace_brick"]),
                  launches_traced_a_fly_frame=seen(brick_prof,
                                                   CLIP_KERNELS["clipmap_trace_brick"])))):
        kernels.append(dict(
            name=kname, route="cuda", source=src + source,
            replaces=f"raytracingtest_tpu/stream/clipmap.py:{line}", path=path,
            launches=fk["launches"].get(kname, 0), max_abs_err=err[kname],
            ms=med_p80(ms)[0], plain_ms=fk["plain_ms"][kname], bound_ms=bnd[0],
            bound_by=bnd[1], library_ms=None, **extra))
    # phase 1's other kernels: the brickmap mode's first form, the probe form,
    # the radix form unmapped (on the tile frame's calls, off every path)
    pm = fk["cand_parity"]["parity main"]
    k8 = dict(route="cuda", source=src + "tile_candidates.cu",
              replaces="raytracingtest_tpu/stream/clipmap.py:579",
              plain_ms=fk["plain_ms"]["tile_candidates_mapped"], bound_ms=pm["bound"][0],
              bound_by=pm["bound"][1], library_ms=None,
              shape=f"the streamed frame's main call, T={fk['mapped'][0]['T']} "
                    f"K={fk['mapped'][0]['K']}")
    kernels.append(dict(
        name="tile_candidates_mapped_first",
        path="tile_cuda.candidates(brickmap=, form=\"first\") (the first form, the search "
             "form's kernel, off the main path)",
        launches=first_launches["tile_candidates_mapped_first"],
        max_abs_err=err["tile_candidates_mapped_first"], ms=pm["first"]["ms"],
        us_alone=pm["first"]["us_alone"], **k8))
    kernels.append(dict(
        name="tile_candidates_probe",
        path="tile_cuda.probe_candidates (either form with per-warp counters, for "
             "measurement only)",
        launches=first_launches["tile_candidates_probe"], max_abs_err=0.0,
        ms=pm["radix"]["probe_ms"], ms_first_form=pm["first"]["probe_ms"],
        warps={form: pm[form]["warps"] for form in ("radix", "first")}, **k8))
    tm = cand_rows["main"]
    kernels.append(dict(
        name="tile_candidates_radix", route="cuda", source=src + "tile_candidates.cu",
        replaces="raytracingtest_tpu/ops/tile.py:288",
        path="tile_cuda.candidates(form=\"radix\") (the radix form unmapped, measured on "
             "the tile frame's calls, off every path)",
        launches=first_launches["tile_candidates_radix"],
        max_abs_err=err["tile_candidates_radix"], ms=tm["ms_radix"],
        plain_ms=tm["plain_ms"], bound_ms=tm["bound_ms"], bound_by=tm["bound_by"],
        library_ms=None, us_alone=tm["us_alone_radix"],
        calls={c: dict(ms=r["ms_radix"], us_alone=r["us_alone_radix"])
               for c, r in cand_rows.items()}))
    by_name = {row["name"]: row for row in kernels}
    for kname in ("clipmap_trace", "clipmap_trace_brick"):
        fw, wk = fk["fly_work"][kname], fk["work"][kname]
        by_name[kname].update(
            form=CLIP_MAIN, first_form=kname + "_serial",
            probe="brick_cuda." + ("probe_clipmap" if kname == "clipmap_trace"
                                   else "probe_clipmap_brick"),
            us_alone_first_form_fly_check=fw["us_alone_first_form"],
            us_alone_in_turns_fly_check=fw["alone_in_turns"],
            ms_in_turns_fly_check={f: med_p80(v)[0] for f, v in fw["ms_turns"].items()},
            ms_last_pose_first_form=med_p80(fk["kern_ms"][kname + "_serial"])[0],
            warps_fly_check=fw["warps"])
        kernels.append(dict(
            name=kname + "_serial", route="cuda", source=src + "brick_trace.cu",
            replaces=by_name[kname]["replaces"],
            path="brick_cuda.clipmap_kernel(form=\"first\") (the first form, off the main "
                 "path)",
            launches=0, max_abs_err=err[kname + "_serial"],
            ms=med_p80(wk["ms_first"])[0], plain_ms=fk["plain_ms"][kname],
            bound_ms=wk["bound"][0], bound_by=wk["bound"][1], library_ms=None,
            shape=f"{FLY_PARITY_RES}² rays, the whole world at depth 10",
            us_alone_fly_check=fw["us_alone_first_form"],
            ms_last_pose=med_p80(fk["kern_ms"][kname + "_serial"])[0],
            warps_fly_check=fw["warps"]["first"]))
    per_round = lambda rows: [dict(live=r["live"], walks=r["counts"]["walks"],
                                   steps=r["counts"]["steps"], us_alone=r["us_alone"],
                                   us_alone_first_form=r["us_alone_first_form"],
                                   bound_ms=r["bound"][0], bound_by=r["bound"][1])
                              for r in rows]
    level_path = (f" on the depth-{SHARDED_DEPTH} terrain split at level {SHARDED_SPLIT}, "
                  f"{SHARDED_RES}² rays, a NCCL world of one")
    for mode, c_tr in (("sharded", "sharded trace"), ("trunk", "exchange trace"),
                       ("packets", "exchange trace")):
        kname, c = f"level_round_{mode}", shard["calls"][mode]
        forms = shard["forms"][c_tr]
        kernels.append(dict(
            name=kname, route="cuda", source=src + "brick_trace.cu",
            replaces=LEVEL_REPLACES[mode],
            path=(f"parallel.level_sharded.{'make_sharded_trace' if mode == 'sharded' else 'make_exchange_trace'}"
                  + level_path + " (the queued form)"),
            launches=shard["launches"][c_tr][kname], max_abs_err=err[kname],
            ms=med_p80(c["ms"])[0], plain_ms=c["plain_ms"], bound_ms=c["bound"][0],
            bound_by=c["bound"][1], library_ms=None, us_alone=c["us_alone"],
            shape=f"the path's first {mode} call, {c['n']} "
                  f"{'packets' if mode == 'packets' else 'rays'}",
            rounds=shard["rounds"][c_tr],
            launches_fit=shard["launches"]["sharded fit"].get(kname, 0),
            ms_first_form=med_p80(c["ms_first_form"])[0],
            us_alone_first_form=c["us_alone_first_form"],
            per_round=per_round(shard["rounds_of"][mode]),
            main_path_rounds_us=[dict(queue_passes=a, walk=b) for a, b in (
                forms["per_round"] if mode == "sharded"
                else forms["per_round"][0 if mode == "trunk" else 1::2])],
            first_form_rounds_us=(forms["rounds_us"]["first"] if mode == "sharded"
                                  else forms["rounds_us"]["first"][
                                      0 if mode == "trunk" else 1::2]),
            path_ms_in_turns=forms["ms"]))
    sharded_first = shard["calls"]["sharded"]
    kernels.append(dict(
        name="level_round_serial", route="cuda", source=src + "brick_trace.cu",
        replaces=LEVEL_REPLACES["sharded"],
        path="brick_cuda.level_round_serial_kernel (the first form, off the main path)"
             + level_path,
        launches=0, max_abs_err=err["level_round_serial"],
        ms=med_p80(sharded_first["ms_first_form"])[0], plain_ms=sharded_first["plain_ms"],
        bound_ms=sharded_first["bound"][0], bound_by=sharded_first["bound"][1],
        library_ms=None, us_alone=sharded_first["us_alone_first_form"],
        shape="the sharded trace's first call",
        by_mode={mode: dict(ms=med_p80(c["ms_first_form"])[0],
                            us_alone=c["us_alone_first_form"])
                 for mode, c in shard["calls"].items()},
        warps=shard["warps"]))
    q = shard["queue"]
    kernels.append(dict(
        name="level_queue", route="cuda", source=src + "brick_trace.cu",
        replaces=LEVEL_REPLACES["sharded"], form="one pass", first_form="level_queue_serial",
        path="the level-sharded loops' rounds (the queue of level_round's queued form: "
             "the one pass, and the packets' search)" + level_path,
        launches=shard["launches"]["sharded trace"]["level_queue"],
        max_abs_err=err["level_queue"], ms=q["ms"], plain_ms=q["plain_ms"],
        bound_ms=q["bound"][0], bound_by=q["bound"][1], library_ms=q["library_ms"],
        us_alone=q["us_alone"], library_us_alone=q["library_us_alone"],
        shape=f"the sharded trace's round 2: {q['live']} live of {q['n']} rays",
        launches_exchange=shard["launches"]["exchange trace"]["level_queue"],
        us_a_path={name: f["queue_us"] for name, f in shard["forms"].items()},
        launches_traced_a_path={name: f["queue_launches"]
                                for name, f in shard["forms"].items()},
        rounds_checked=q["checked"]))
    kernels.append(dict(
        name="level_queue_serial", route="cuda", source=src + "brick_trace.cu",
        replaces=LEVEL_REPLACES["sharded"],
        path="brick_cuda.level_queue_kernel(form=\"first\") (the queue's first form: count "
             "pass, torch.cumsum, place pass; off the main path)" + level_path,
        launches=0, max_abs_err=err["level_queue_serial"], ms=q["ms_first_form"],
        plain_ms=q["plain_ms"], bound_ms=q["bound_first_form"][0],
        bound_by=q["bound_first_form"][1], library_ms=q["library_ms"],
        us_alone=q["us_alone_first_form"],
        shape=f"the sharded trace's round 2: {q['live']} live of {q['n']} rays",
        us_a_path={name: f["queue_us_first_form"] for name, f in shard["forms"].items()},
        launches_traced_a_path={name: f["queue_launches_first_form"]
                                for name, f in shard["forms"].items()}))
    for row in kernels:
        row["launches_cli"] = clied["launches"].get(row["name"], 0)
    kernels[0]["launches_train_step"] = train_launches["per-ray"]["esvo_trace"]
    kernels[2]["launches_train_step"] = train_launches["tile"]["tile_walk"]
    kernels[4]["launches_train_step"] = train_launches["tile"]["tile_candidates"]
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
