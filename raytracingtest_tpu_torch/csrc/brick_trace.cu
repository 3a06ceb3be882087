// The per-ray stackless traces for Hopper, sm_90a: six traces that share
// one stackless step, the streamed world's stitched traces (clipmap_trace,
// clipmap_trace_brick) and the level-sharded rounds (level_round, and its
// queue level_queue), which walk from a per-ray root.
//
//   esvo_stackless  replaces raytracingtest_tpu/ops/traverse.py::_trace_core
//                   (:530, driven by trace_jax :639; its step _fast_step
//                   :327): the ESVO walk without a stack over the full tree.
//   brick_trace     replaces raytracingtest_tpu/ops/brick.py::
//                   _trace_brick_core (:492; its round _brick_round :347 and
//                   step _top_step :225, driven by trace_brick_jax :827):
//                   the same walk over the top tree, which parks a ray at
//                   each brick it enters and walks the brick with the exact
//                   voxel DDA (brick_dda.cuh, shared with tile_walk.cu).
//   esvo_stackless_multi  replaces traverse.py::_trace_multi_core (:684):
//                   the first k leaf segments (leaf, t_in, t_out) of each
//                   ray, the stackless walk in collect mode (a leaf entered
//                   is recorded and the ray walks on).
//   brick_trace_multi  replaces brick.py::_trace_brick_multi_core (:574):
//                   the same segments through the top tree and its bricks:
//                   the wide brick_trace's body, brick_ray, with the DDA in
//                   collect mode (each solid voxel recorded, its exit t the
//                   segment's end).
//   esvo_stackless_lod  replaces traverse.py::_trace_lod_core (:816, driven
//                   by trace_lod_jax :879; the lod branch of _fast_step
//                   :389-410): esvo_stackless with the footprint stop, the
//                   walk step in LOD mode (walk_step<false, true>).
//   brick_trace_lod  replaces brick.py::_trace_brick_core(lod=) (:492, driven
//                   by trace_brick_lod_jax :811; _top_step's lod branch
//                   :273-343): brick_trace's wide form with the footprint
//                   stop in the top walk, the brick level included.
//
// LOD mode: a child is small when the ray's footprint there, tc_max * coef
// + bias (a multiply, then an add: --fmad=false), is at least the child's
// size 2 * half, a power of two, so one rounding moves a ray between a node
// and a leaf; coef and bias arrive as float32, rounded once from the
// caller's number as jnp.float32 rounds it. Entering a small non-leaf child
// ends the ray at t_min with hit_node = that child's row (the stackless
// trace also records its parent and slot, as for a leaf); in the brick
// trace, entering a small brick ends it with hit_node = n_top + the brick's
// id, the row of the brick's node in the source SVO. A brick larger than
// the footprint is walked by the exact DDA. brick_trace_lod runs the wide
// form's body (staged brick rows), the brick trace's main-path form, which
// measured faster than the first form in every run (PERF.md).
//
// Semantics follow the plain PyTorch versions bit for bit
// (raytracingtest_tpu_torch/ops/traverse.py::fast_step, trace_stackless,
// trace_multi; ops/brick.py::trace_brick, _dda_round, trace_brick_multi,
// _dda_round_multi). The stackless step reads one node
// row, gets the parent's exit t from pos rounded up to the parent's grid
// (no stack), and climbs one level a POP through parent_ptr; `popped` keeps
// a ray that just climbed out of a child from entering it again. All in
// mirrored [1,2]^3 space.
//
// Bounds on each ray, as the plain versions keep them:
//   * esvo_stackless: max_iters_for_depth(depth) = 24 * depth + 48 steps.
//     The reference's loop checks this count for the batch and steps every
//     ray still walking, so it is the reference's bound on each ray.
//   * brick_trace: at most max_iters_for_depth(top_depth) top steps in a
//     round (a stretch that ends when the ray parks or finishes), at most
//     16 * depth + 64 rounds, at most 30 DDA steps a round (an 8^3 brick
//     needs 22). The reference counts its bounds for the batch and also ends
//     a round's top walk once few rays can still step (TOP_DRAIN): its
//     rounds are never longer for a ray, so every ray it finishes ends here
//     with the same bits, iters included.
//   * esvo_stackless_multi: max_iters_for_depth(depth) + 8k steps, each
//     ray's own in the reference too (its loop does not compact).
//   * the LOD kernels: the bounds of esvo_stackless and brick_trace.
//   * brick_trace_multi: brick_trace's bounds with 8k more top steps a round
//     and 8k more rounds, and 3 * 8 + 2 + k DDA steps a round (the
//     reference's, one step a trip); the same rule on TOP_DRAIN holds.
//
// What bounds them on this card: not bytes (24 B of ray in, 20 B of results
// out a ray, and the node rows and brick rows its steps read: under 100 MB
// for the depth-10 1024^2 frame, 0.03 ms at 3.35 TB/s) and not operations
// (40 a stackless step and 32 a DDA step: some 0.02 ms at 67 TFLOP/s), but
// instruction issue in divergent warps and the chains of a few straggler
// warps. The probe forms measured it on that frame (chip_smoke.py [warps]):
// a warp issues a loop for as long as its slowest lane runs it (SIMT
// efficiency 0.75 in the stackless step, 0.56 in the brick trace's top
// step and 0.35 in its DDA step), and the last fifth of the kernel's span
// runs its last hundredth of warps, warps of grazing rays that start
// mid-launch and run for 100-400 us while the rest of the card idles.
//
// The kernels, one thread a ray each; they compute the same bits:
//   * esvo_stackless has two forms. Its first form (esvo_stackless_kernel,
//     C entry esvo_stackless_serial): blocks of 128, rays in their own
//     order, the masks, child_base, parent_ptr and leaf_base arrays read
//     through the read-only path as the step needs them (a PUSH waits on
//     the parent's masks, then its child_base). Its patched form, the main
//     path's (esvo_stackless_patched_kernel): the same step in ROWS mode
//     over the tree's (n_nodes, 4) row table, a node's 16 bytes read as one
//     load only where the ray's node changes and kept in registers (an
//     ADVANCE loads nothing, a PUSH or a POP waits on one load), and, for
//     rays that are a row-major image, warps of 8 x 4 pixel patches
//     (patch_ray): neighbouring pixels' rays part later than a strip of one
//     image row does. On the depth-10 frame (PERF.md, chip_smoke.py's
//     [stackless-forms]) patches raise the step's SIMT efficiency from 0.75
//     to 0.83 and take about a tenth off the kernel; the row alone gains
//     little on this trace, and the stragglers' tail stays (a fifth of the
//     span after 99% of the warps).
//   * brick_trace_serial, the brick trace's first form: the same, each
//     round a top loop, a three-level descent and a DDA loop.
//   * brick_trace, its wide form (the main path's): the first form's rounds
//     in blocks of 256, and a ray that parks reads its brick row's 17 words
//     as independent loads into its own slice of shared memory, so that
//     each DDA step reads its word there instead of behind a dependent load.
//     brick_trace_unstaged is the wide form without the staged row, which
//     splits the gain between the two changes (chip_smoke.py [timing]).
//   * brick_trace_multi has two forms; they compute the same bits. Its
//     staged form (brick_trace_multi_staged_kernel, the main path's) runs
//     the wide brick_trace's body, brick_ray, in collect mode (a template
//     parameter, as LOD is). Each ray's k slots live in its warp's region
//     of dynamic shared memory, padded (-1, 0, 0) at set-up, beside its
//     parked brick row and the row's 16 prefix counts (a segment's leaf id
//     is then one shared word and a popcount, not a loop over the words
//     below its bit): 132 + 12k bytes a ray. When its 32 walks have ended,
//     a warp writes its rays' contiguous run of 32k words of each (N, k)
//     array, consecutive lanes on consecutive words (the ragged last warp
//     masked); count and iters a word a lane; the statistics staged over
//     the rows and written the same way. A warp's rays are contiguous, so
//     the write-out needs no block barrier (one after a block barrier
//     measured 0.5-2% slower). Blocks are of MULTI_BLOCK = 32 threads at
//     every k: a block's shared memory is held until its last warp ends,
//     so smaller blocks free it sooner, and from k = 8 on 32 threads
//     measured fastest (blocks of 128 within 1.2% at k = 4). Above 48 KB
//     the block opts in to more; where even 32 rays' slots pass SMEM_MAX
//     (k from 595) brick_cuda's rule takes the first form.
//   * esvo_stackless_multi's patched form (the main path's,
//     esvo_stackless_multi_patched_kernel): esvo_stackless's patched form in
//     collect mode, a segment's leaf id taken from the row in registers (the
//     record's load gone); there the patches and the row each gain.
//   * The first forms (brick_trace_multi_kernel, the staged form's check
//     and yardstick; esvo_stackless_multi_kernel, C entry
//     esvo_stackless_multi_serial): one thread a ray in blocks of 128, rows read as the steps
//     need them, each segment written to its (N, k) slot as it is found,
//     three 4-byte stores at a 4k-byte stride from a partly active warp,
//     and the empty slots padded at the end; the padding grows with k (at
//     k = 594 the brick first form measured 63 ms against the staged
//     form's 11). A staged form of the stackless trace (its slots (parent,
//     rank, t_in, t_out), the leaf id added at write-out) measured no
//     faster at k = 4 and was dropped: the record it takes off the walk
//     was 4% of the warps' cycles (PERF.md).
//     What bounds the k-segment traces on this card is what bounds the
//     single-hit ones, more so (their probe forms on the depth-10 frame at
//     k = 4, chip_smoke.py [warps]): the brick trace's top step issues at
//     SIMT efficiency 0.40 (0.56 in brick_trace: a ray walks on past its
//     first hit, so the lanes of a warp part further) and takes about half
//     of the first form's warp cycles; a segment's record runs at SIMT 0.08
//     (a few lanes at a time), 10% of the first form's warp cycles in the
//     brick trace (the leaf id's loop over the row) and 4% in the stackless
//     trace (its leaf id's load); the last 99th of warps runs 10-12% of the
//     span. Staging takes the record off the walk; it cannot mend the
//     divergence.
//   * clipmap_trace and clipmap_trace_brick, the stitched traces: one thread
//     a ray running its rounds (see their section below). Each has a wide
//     form on the main path and its first form (clipmap_trace_kernel<false>,
//     <true>) beside it: both wide forms make the direction's set-up once a
//     ray; clipmap_trace's scales the origin by the exact reciprocal of a
//     power-of-two size, clipmap_trace_brick's walks the chunk with the wide
//     brick trace's body.
//   * esvo_stackless_lod and brick_trace_lod: esvo_stackless's and the wide
//     brick_trace's bodies (stackless_ray, brick_ray) with the step in LOD
//     mode; the other kernels instantiate the same bodies without it, so
//     their code and registers are as before (chip_smoke.py's [build]).
//     esvo_stackless_lod has esvo_stackless's two forms: the first
//     (esvo_stackless_lod_kernel, C entry esvo_stackless_lod_serial) and
//     the patched one (esvo_stackless_patched_kernel<probe, true>), whose
//     walk reads the four arrays: in LOD mode the walk over the row table
//     measured slower than the patches alone (PERF.md). brick_trace_lod
//     has two forms of one body, brick_ray<staged rows, probe, LOD>: the
//     first (brick_trace_lod_kernel, C entry brick_trace_lod_serial; blocks
//     of 256, rays in their own order) and the patched one
//     (brick_trace_lod_patched_kernel<probe>): the rays in warps of 8 x 4
//     pixel patches, blocks of the caller's size, each thread's staged row
//     in dynamic shared memory, 68 bytes a thread. On the depth-10 frame
//     (PERF.md, chip_smoke.py's [brick-lod-forms]) the patches raise the top
//     step's SIMT efficiency from 0.57 to 0.68 and the DDA step's from 0.35
//     to 0.42, and take about a tenth off the kernel at the camera's pixel
//     footprint but little at 8 times it, where the warp that gathers one
//     patch's grazing rays, started mid-launch, sets the span.
//   * The probe forms (esvo_stackless_probe, brick_trace_probe,
//     brick_trace_lod_probe, the k-segment traces' esvo_stackless_multi_probe and
//     brick_trace_multi_probe, of either form, and the stitched traces'
//     clipmap_trace_brick_probe and clipmap_trace_probe_kernel over their
//     own seven and six phases) are a form with counters:
//     each warp writes PROBE_WORDS int64 words (the layout at Probe below),
//     the issues of each phase (a step, the descent, a DDA step, a ray's
//     set-up or write, a segment's record; in the staged form the warp's
//     write-out is the write), the lanes active at each issue, the
//     clock64() cycles inside each phase, and the warp's start and end on
//     clock64() and on the global timer. Issue and lane counts are exact;
//     cycles inside divergent code are approximate (another branch's lanes
//     may run between the two reads). Their results are the bits of the
//     form they instrument; their registers are not, so their times are not
//     the form's.
// Lane refill (each lane takes the block's next ray when its own ends) and,
// for the brick trace, warp-voted phases were built, held bitwise and
// measured slower at every setting; commit f90bb90 holds them and the
// sweep that measured them.
//
// Rounding: built with --fmad=false, so pos*t_coef - t_bias and
// half*t_coef + t_corner round in two steps, as the plain versions'
// separate tensor ops do; -1/|d| is an IEEE division. Brick rows are int32
// bit patterns of uint32 words.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "brick_dda.cuh"

namespace {

constexpr int S_MAX = 23;
constexpr int BLOCK = 128;
constexpr unsigned FULL = 0xffffffffu;
constexpr int ROW_WORDS = 17;        // a brick row: 16 occupancy words + first leaf id
// the collect mode's staged row: the row, then for each occupancy word w
// the first leaf id plus the set bits of the words below w
constexpr int PREFIX_ROW_WORDS = ROW_WORDS + 16;
constexpr int DDA_ROUND_STEPS = 30;  // the reference's DDA loop: 26 rounded up to 6s
constexpr int N_STATS = 5;           // rounds, DDA steps, capped rounds, DDA max, unfinished
constexpr int STEP_ON = 0, STEP_LEAF = 1, STEP_EXIT = 2;
constexpr int FORM_FIRST = 0, FORM_WIDE = 1, FORM_UNSTAGED = 2, FORM_STAGED = 3,
              FORM_PATCHED = 4;
constexpr int WIDE_BLOCK = 256;  // the wide form's block
// the stackless traces' patched form: a warp's 8 x 4 pixel patch, and the
// largest block it is compiled for
constexpr int PATCH_W = 8, PATCH_H = 4, PATCH_BLOCK_MAX = 256;
constexpr int MULTI_BLOCK = 32;  // the staged brick_trace_multi's block
// shared memory a block: above SMEM_STATIC only after opting in
// (cudaFuncSetAttribute); SMEM_MAX, the most an sm_90 block can have
constexpr int SMEM_STATIC = 48 * 1024, SMEM_MAX = 232448;

__device__ __forceinline__ int max_iters_for_depth(int depth) {
  return 24 * depth + 48;
}

// A ray's constants after mirroring (ops/traverse.py::ray_setup).
struct Ray {
  float t_coef[3], t_bias[3];
  float t_root;  // the root cube's exit t
  int om;        // octant mask
};

// A ray's walk registers (ops/traverse.py::walk_state).
struct Walk {
  float pos[3];  // mirrored lower corner of the current child
  int idx;       // mirrored child index bits
  int parent;    // current node row
  int scale;
  float t_min;
  bool popped;   // climbed on the last step: may not re-enter the child
};

// Mirroring, root-cube entry and the first child of a ray whose origin and
// direction are in registers, starting at node row `root`; returns whether
// the ray misses the root cube.
__device__ __forceinline__ bool setup_at(const float* __restrict__ o,
                                         const float* __restrict__ d, int root,
                                         Ray& r, Walk& w) {
  const float eps = 1.0f / 8388608.0f;  // 2^-S_MAX
  r.om = 7;
  for (int c = 0; c < 3; ++c) {
    const float oc = o[c] + 1.0f;
    float dc = d[c];
    if (fabsf(dc) < eps) dc = dc >= 0.0f ? eps : -eps;
    r.t_coef[c] = -1.0f / fabsf(dc);
    r.t_bias[c] = r.t_coef[c] * oc;
    if (dc > 0.0f) {
      r.om ^= 1 << c;
      r.t_bias[c] = 3.0f * r.t_coef[c] - r.t_bias[c];
    }
  }
  float t_min = fmaxf(fmaxf(2.0f * r.t_coef[0] - r.t_bias[0],
                            2.0f * r.t_coef[1] - r.t_bias[1]),
                      2.0f * r.t_coef[2] - r.t_bias[2]);
  r.t_root = fminf(fminf(r.t_coef[0] - r.t_bias[0], r.t_coef[1] - r.t_bias[1]),
                   r.t_coef[2] - r.t_bias[2]);
  t_min = fmaxf(t_min, 0.0f);
  w.idx = 0;
  for (int c = 0; c < 3; ++c) {
    const bool upper = 1.5f * r.t_coef[c] - r.t_bias[c] > t_min;
    w.pos[c] = upper ? 1.5f : 1.0f;
    if (upper) w.idx |= 1 << c;
  }
  w.parent = root;
  w.scale = S_MAX - 1;
  w.t_min = t_min;
  w.popped = false;
  return t_min >= r.t_root;
}

// setup_at for ray i of the arrays, from the root row.
__device__ __forceinline__ bool setup(const float* __restrict__ origin,
                                      const float* __restrict__ direction,
                                      int i, Ray& r, Walk& w) {
  return setup_at(origin + (size_t)3 * i, direction + (size_t)3 * i, 0, r, w);
}

// A leaf segment that a step in collect mode records: the parent row of the
// leaf child entered, the child's rank among the parent's leaf children,
// and the segment's entry and exit t.
struct Seg {
  int parent, rank;
  float t_in, t_out;
};

// Set in a collect-mode step's result when it recorded a segment; the low
// bits are STEP_ON or STEP_EXIT.
constexpr int STEP_COLLECTED = 4, STEP_WHAT = 3;
// An LOD-mode step's result when the ray enters a small non-leaf child.
constexpr int STEP_NODE = 3;

// The LOD kernels' footprint t * coef + bias and their extra output: the
// node row at which the footprint stopped each ray, -1 elsewhere; n_top, the
// top tree's rows (brick trace).
struct Lod {
  float coef, bias;
  int n_top;
  int* hit_node;
};

// What an LOD-mode step reports beside its result: the small child's row
// (STEP_NODE), and for a leaf child entered (STEP_LEAF), whether it is
// small too.
struct LodStep {
  int node;
  bool big;
};

// One stackless step (ops/traverse.py::fast_step). Returns STEP_LEAF when
// the ray enters a leaf child: the walk registers are left at that child
// (child_shift its unmirrored slot, leaf_rank its rank among the parent's
// leaf children); STEP_EXIT when it leaves the
// root cube; otherwise STEP_ON after a PUSH, a move to a sibling or a POP.
// COLLECT (fast_step's collect mode): entering a leaf child records the
// segment (the parent, the rank, t_min, min(t_max, tc_max)) in `seg` and
// sets STEP_COLLECTED, and the ray ADVANCEs in the same step. LOD
// (fast_step's LOD mode, not with COLLECT): entering a small non-leaf child
// returns STEP_NODE with its row in ls.node, the walk registers left as
// they were; entering a leaf child sets ls.big, whether it is small.
// ROWS (the stackless traces' patched form): the node's fields come from
// *row, the current parent's row of the (n_nodes, 4) table `rows` (masks,
// child_base, parent_ptr, leaf_base), kept in registers; the step reads the
// next row, one 16-byte load, only where the node changes (a PUSH or a POP),
// and the three arrays are not read. A recorded segment's `rank` is then the
// leaf id (the row's leaf_base plus the rank).
template <bool COLLECT, bool LOD = false, bool ROWS = false>
__device__ __forceinline__ int walk_step(
    const Ray& r, Walk& w, const int* __restrict__ masks,
    const int* __restrict__ child, const int* __restrict__ parent_ptr,
    int& child_shift, int& leaf_rank, Seg& seg, const Lod* lod = nullptr,
    LodStep* ls = nullptr, int4* row = nullptr,
    const int4* __restrict__ rows = nullptr) {
  static_assert(!(COLLECT && LOD), "the LOD walk has no collect mode");
  int desc;
  if constexpr (ROWS) {
    desc = row->x;
  } else {
    desc = __ldg(masks + w.parent);
  }
  const int vm = (desc >> 8) & 0xFF;
  const int lm = desc & 0xFF;
  const float scale_exp2 = __int_as_float((w.scale - S_MAX + 127) << 23);

  float tc[3];
  for (int c = 0; c < 3; ++c) tc[c] = w.pos[c] * r.t_coef[c] - r.t_bias[c];
  const float tc_max = fminf(fminf(tc[0], tc[1]), tc[2]);

  // the parent cube's exit t: pos rounded up to the parent's grid, the least
  // of its corner planes' t, clipped by the root's exit
  const int pshift = w.scale + 1;
  int psh[3];
  float parent_pos[3], tp[3];
  for (int c = 0; c < 3; ++c) {
    psh[c] = __float_as_int(w.pos[c]) >> pshift;
    parent_pos[c] = __int_as_float(psh[c] << pshift);
    tp[c] = parent_pos[c] * r.t_coef[c] - r.t_bias[c];
  }
  const float t_max = fminf(fminf(fminf(tp[0], tp[1]), tp[2]), r.t_root);

  child_shift = w.idx ^ r.om ^ 7;
  const bool child_valid = ((vm >> child_shift) & 1) != 0;
  const float tv_max = fminf(t_max, tc_max);
  const bool enter =
      child_valid && w.t_min <= t_max && !w.popped && w.t_min <= tv_max;
  const int below = (1 << child_shift) - 1;

  int collected = 0;
  if (enter && ((lm >> child_shift) & 1)) {  // a leaf child
    leaf_rank = __popc(vm & lm & below);
    if constexpr (COLLECT) {  // record the segment, then ADVANCE
      if constexpr (ROWS) {
        seg = Seg{w.parent, row->w + leaf_rank, w.t_min, tv_max};
      } else {
        seg = Seg{w.parent, leaf_rank, w.t_min, tv_max};
      }
      collected = STEP_COLLECTED;
    } else {  // hit, or park
      if constexpr (LOD) ls->big = tc_max * lod->coef + lod->bias >= scale_exp2;
      w.popped = false;
      return STEP_LEAF;
    }
  } else if (enter) {  // PUSH
    if constexpr (LOD) {  // or stop at a small child: its size is 2 * half
      if (tc_max * lod->coef + lod->bias >= scale_exp2) {
        if constexpr (ROWS) {
          ls->node = row->y + __popc(vm & ~lm & below);
        } else {
          ls->node = __ldg(child + w.parent) + __popc(vm & ~lm & below);
        }
        return STEP_NODE;
      }
    }
    const float half = scale_exp2 * 0.5f;
    if constexpr (ROWS) {
      w.parent = row->y + __popc(vm & ~lm & below);
      *row = __ldg(rows + w.parent);
    } else {
      w.parent = __ldg(child + w.parent) + __popc(vm & ~lm & below);
    }
    int idx = 0;
    for (int c = 0; c < 3; ++c) {
      if (half * r.t_coef[c] + tc[c] > w.t_min) {
        idx |= 1 << c;
        w.pos[c] = w.pos[c] + half;
      }
    }
    w.idx = idx;
    w.scale -= 1;
    w.popped = false;
    return STEP_ON;
  }

  // ADVANCE: to the sibling, or POP one level
  int step_mask = 0;
  for (int c = 0; c < 3; ++c) {
    if (tc[c] <= tc_max) step_mask |= 1 << c;
  }
  const int idx_adv = w.idx ^ step_mask;
  w.t_min = fmaxf(w.t_min, tc_max);
  if ((idx_adv & step_mask) == 0) {
    for (int c = 0; c < 3; ++c) {
      if ((step_mask >> c) & 1) w.pos[c] = w.pos[c] - scale_exp2;
    }
    w.idx = idx_adv;
    w.popped = false;
    return STEP_ON | collected;
  }
  if (w.scale + 1 >= S_MAX) {  // left the root cube
    w.popped = false;
    return STEP_EXIT | collected;
  }
  for (int c = 0; c < 3; ++c) w.pos[c] = parent_pos[c];
  w.idx = (psh[0] & 1) | ((psh[1] & 1) << 1) | ((psh[2] & 1) << 2);
  if constexpr (ROWS) {
    w.parent = row->z;
    *row = __ldg(rows + w.parent);
  } else {
    w.parent = __ldg(parent_ptr + w.parent);
  }
  w.scale += 1;
  w.popped = true;
  return STEP_ON | collected;
}

__device__ __forceinline__ int stackless_step(
    const Ray& r, Walk& w, const int* __restrict__ masks,
    const int* __restrict__ child, const int* __restrict__ parent_ptr,
    int& child_shift, int& leaf_rank) {
  Seg unused;
  return walk_step<false>(r, w, masks, child, parent_ptr, child_shift,
                          leaf_rank, unused);
}

__device__ __forceinline__ void write_stats(int* __restrict__ stats, int i,
                                            int rounds, int dda, int capped,
                                            int dda_max, bool unfinished) {
  if (stats == nullptr) return;
  int* s = stats + (size_t)N_STATS * i;
  s[0] = rounds;
  s[1] = dda;
  s[2] = capped;
  s[3] = dda_max;
  s[4] = unfinished ? 1 : 0;
}

// ---- the probe -------------------------------------------------------------
// A warp's record, PROBE_WORDS int64 words: its start and end clock64() (the
// SM's own counter, so compare only warps of one block), rays it wrote, then
// for each phase (a top or stackless step, the descent into a brick, a DDA
// step, a ray's set-up or write, a k-segment trace's record of a segment:
// its write, or its stage in shared memory) its issues, the lanes active
// summed over them, and the cycles inside it; then the SM's id, and the
// warp's start and end on the card's global timer (ns, one clock for all
// SMs).
constexpr int PH_STEP = 0, PH_DESCENT = 1, PH_DDA = 2, PH_RAY = 3, PH_SEG = 4,
              N_PHASES = 5;
constexpr int PROBE_WORDS = 21;
constexpr int PW_START = 0, PW_END = 1, PW_RAYS = 2, PW_PHASES = 3, PW_SM = 18,
              PW_NS_START = 19, PW_NS_END = 20;

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (long long)t;
}

// NPH phases; a record of 6 + 3 NPH words (PROBE_WORDS at N_PHASES, the
// layout above; the stitched trace's probe has CP_PHASES).
template <bool ON, int NPH = N_PHASES>
struct Probe {  // off: every call compiles to nothing
  __device__ __forceinline__ void begin() {}
  __device__ __forceinline__ long long enter(int) { return 0; }
  __device__ __forceinline__ void leave(int, long long) {}
  __device__ __forceinline__ void ray() {}
  __device__ __forceinline__ void finish(long long*) {}
};

__device__ __forceinline__ long long warp_sum(long long x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

template <int NPH>
struct Probe<true, NPH> {
  static constexpr int WORDS = PW_PHASES + 3 * NPH + 3;
  static constexpr int W_SM = PW_PHASES + 3 * NPH;
  static_assert(NPH != N_PHASES || (WORDS == PROBE_WORDS && W_SM == PW_SM &&
                                     W_SM + 2 == PW_NS_END),
                "the record's layout at N_PHASES");
  long long start, ns_start, rays, issues[NPH], lanes[NPH], cycles[NPH];

  __device__ __forceinline__ void begin() {
    ns_start = global_ns();
    start = clock64();
    rays = 0;
    for (int p = 0; p < NPH; ++p) issues[p] = lanes[p] = cycles[p] = 0;
  }
  // The lowest active lane counts the issue and the lanes with it, and
  // reads the clock; the others return -1.
  __device__ __forceinline__ long long enter(int p) {
    const unsigned m = __activemask();
    if ((int)(threadIdx.x & 31) != __ffs(m) - 1) return -1;
    issues[p] += 1;
    lanes[p] += __popc(m);
    return clock64();
  }
  __device__ __forceinline__ void leave(int p, long long t) {
    if (t >= 0) cycles[p] += clock64() - t;
  }
  __device__ __forceinline__ void ray() { rays += 1; }
  // All 32 lanes of the warp, after the walk: sum the lanes' counts, and
  // lane 0 writes the record.
  __device__ __forceinline__ void finish(long long* __restrict__ out) {
    __syncwarp();
    const long long end = clock64();
    const long long ns_end = global_ns();
    long long v[WORDS];
    v[PW_START] = start;
    v[PW_END] = end;
    v[PW_RAYS] = warp_sum(rays);
    for (int p = 0; p < NPH; ++p) {
      v[PW_PHASES + 3 * p] = warp_sum(issues[p]);
      v[PW_PHASES + 3 * p + 1] = warp_sum(lanes[p]);
      v[PW_PHASES + 3 * p + 2] = warp_sum(cycles[p]);
    }
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    v[W_SM] = sm;
    v[W_SM + 1] = ns_start;
    v[W_SM + 2] = ns_end;
    if ((threadIdx.x & 31) == 0) {
      const size_t warp = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
      for (int k = 0; k < WORDS; ++k) out[warp * WORDS + k] = v[k];
    }
  }
};

// The trace's inputs and outputs, as the C entry points take them.
struct Tree {
  const int* masks;       // masks (stackless) or top_masks (brick)
  const int* child;       // child_base or top_child
  const int* parent_ptr;  // parent_ptr or top_parent
  const int* leaf_base;   // stackless only
  const int* bricks;      // brick only: n_bricks rows of 17 words
  int depth, top_depth;
};
struct Rays {
  const float* origin;
  const float* direction;
  int n;
};
struct Out {
  int* hit_leaf;
  float* hit_t;
  int* hit_parent;
  int* hit_child;
  int* iters;
  int* stats;  // nullptr: no statistics
};

__device__ __forceinline__ void write_ray(const Out& out, int i, int leaf,
                                          float ht, int hp, int hc, int it) {
  out.hit_leaf[i] = leaf;
  out.hit_t[i] = ht;
  out.hit_parent[i] = hp;
  out.hit_child[i] = hc;
  out.iters[i] = it;
}

// The k-segment traces' outputs: (N, k) row-major segments, (N,) counts and
// steps, and optional statistics.
struct MultiOut {
  int* hit_leaf;
  float* t_in;
  float* t_out;
  int* count;
  int* iters;
  int* stats;  // nullptr: no statistics
  int k;
};

// Collect mode of the brick walk: a thread's k segment slots in its warp's
// shared memory (slot s of lane l at l * k + s of each array), padded
// (-1, 0, 0) before the walk, and the tallies the walk leaves for the
// warp's write-out.
struct Slots {
  int* id;     // the leaf; -1 empty
  float* t_in;
  float* t_out;
  int k;
  int count, iters;
  int stats[N_STATS];
};

// ---- esvo_stackless --------------------------------------------------------

// Ray i's stackless walk over the full tree, at most
// max_iters_for_depth(depth) steps; LOD: with the footprint stop, its node
// row written to lod.hit_node. ROWS: the walk over the node row table
// `rows` (walk_step's ROWS mode), the root's row read at set-up.
template <bool PROBE, bool LOD, bool ROWS = false>
__device__ __forceinline__ void stackless_ray(const Tree& tree,
                                              const Rays& rays, const Out& out,
                                              int i, Probe<PROBE>& probe,
                                              const Lod* lod,
                                              const int4* __restrict__ rows = nullptr) {
  long long t = probe.enter(PH_RAY);
  Ray r;
  Walk w;
  bool done = setup(rays.origin, rays.direction, i, r, w);
  int4 row;
  if constexpr (ROWS) row = __ldg(rows);
  probe.leave(PH_RAY, t);
  const int n_max = max_iters_for_depth(tree.depth);
  int hp = -1, hc = 0, leaf = -1, it = 0, node = -1;
  float ht = 0.0f;
  while (!done && it < n_max) {
    t = probe.enter(PH_STEP);
    ++it;
    int child_shift, leaf_rank;
    int what;
    if constexpr (LOD) {
      Seg unused;
      LodStep ls;
      what = walk_step<false, true, ROWS>(r, w, tree.masks, tree.child,
                                          tree.parent_ptr, child_shift,
                                          leaf_rank, unused, lod, &ls, &row,
                                          rows);
      if (what == STEP_NODE) {
        hp = w.parent;
        hc = child_shift;
        ht = w.t_min;
        node = ls.node;
      }
    } else if constexpr (ROWS) {
      Seg unused;
      what = walk_step<false, false, true>(r, w, nullptr, nullptr, nullptr,
                                           child_shift, leaf_rank, unused,
                                           nullptr, nullptr, &row, rows);
    } else {
      what = stackless_step(r, w, tree.masks, tree.child, tree.parent_ptr,
                            child_shift, leaf_rank);
    }
    if (what == STEP_LEAF) {
      hp = w.parent;
      hc = child_shift;
      ht = w.t_min;
      if constexpr (ROWS) {
        leaf = row.w + leaf_rank;
      } else {
        leaf = __ldg(tree.leaf_base + hp) + leaf_rank;
      }
    }
    done = what != STEP_ON;
    probe.leave(PH_STEP, t);
  }
  t = probe.enter(PH_RAY);
  write_ray(out, i, leaf, ht, hp, hc, it);
  if constexpr (LOD) lod->hit_node[i] = node;
  write_stats(out.stats, i, 0, 0, 0, 0, !done);
  probe.ray();
  probe.leave(PH_RAY, t);
}

// One thread a ray, the stackless walk over the full tree.
template <bool PROBE>
__global__ void __launch_bounds__(BLOCK)
esvo_stackless_kernel(Tree tree, Rays rays, Out out,
                      long long* __restrict__ probe_out) {
  Probe<PROBE> probe;
  probe.begin();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < rays.n) stackless_ray<PROBE, false>(tree, rays, out, i, probe, nullptr);
  probe.finish(probe_out);
}

// One thread a ray, the stackless walk with the footprint stop.
__global__ void __launch_bounds__(BLOCK)
esvo_stackless_lod_kernel(Tree tree, Rays rays, Out out, Lod lod) {
  Probe<false> probe;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < rays.n) stackless_ray<false, true>(tree, rays, out, i, probe, &lod);
}

// The patched form's thread order. Without an image (width 0), thread t
// walks ray t. For an image of `width` columns and n / width rows, rays in
// row-major order, warp p of the launch walks the p-th 8 x 4 pixel patch,
// patches in row-major order over the image (ceil(width / 8) a patch row),
// lane l its pixel (l % 8, l / 8); a lane past the right or bottom edge has
// no ray (-1). brick_cuda.patch_order is the same map.
__device__ __forceinline__ int patch_ray(int t, int n, int width) {
  if (width <= 0) return t < n ? t : -1;
  const int height = n / width;
  const int pw = (width + PATCH_W - 1) / PATCH_W;
  const int p = t >> 5, l = t & 31;
  const int x = (p % pw) * PATCH_W + (l % PATCH_W);
  const int y = (p / pw) * PATCH_H + l / PATCH_W;
  return (x < width && y < height) ? y * width + x : -1;
}

// The threads a patched launch runs: n, or every lane of the image's patches.
long long patch_threads(int n, int width) {
  if (width <= 0) return n;
  const long long pw = (width + PATCH_W - 1) / PATCH_W;
  const long long ph = (n / width + PATCH_H - 1) / PATCH_H;
  return pw * ph * 32;
}

// The patched form of esvo_stackless (LOD: of esvo_stackless_lod): one
// thread a ray in the patch order, the walk over the node row table; the
// LOD form's walk reads the tree's arrays as the first form's does (its
// walk over the row table measured slower than the patches alone, PERF.md).
// Compiled for blocks of up to PATCH_BLOCK_MAX threads; launched with the
// caller's block (brick_cuda.BLOCKS).
template <bool PROBE, bool LOD>
__global__ void __launch_bounds__(PATCH_BLOCK_MAX)
esvo_stackless_patched_kernel(const int4* __restrict__ rows, Tree tree,
                              Rays rays, int width, Out out, Lod lod,
                              long long* __restrict__ probe_out) {
  Probe<PROBE> probe;
  probe.begin();
  const int i = patch_ray(blockIdx.x * blockDim.x + threadIdx.x, rays.n, width);
  if (i >= 0) {
    stackless_ray<PROBE, LOD, !LOD>(tree, rays, out, i, probe, &lod, rows);
  }
  probe.finish(probe_out);
}

// ---- brick_trace -----------------------------------------------------------

// Ray i's rounds: a stackless walk over the top tree until the ray parks at
// a brick, then the brick's DDA; a DDA that leaves the brick sets `popped`,
// so the next round's walk steps past it. STAGE: the parked ray's brick row
// is read into `my_row`, its slice of shared memory, first (in collect mode
// with its 16 prefix counts beside it, PREFIX_ROW_WORDS words, so that a
// segment's leaf id is one word and one popcount). LOD: the top
// walk has the footprint stop, at nodes and at bricks, its node row written
// to lod.hit_node. COLLECT (brick_trace_multi): the DDA in collect mode,
// each solid voxel the ray stands in staged in col's slots as (leaf, t, the
// voxel's exit t) and the walk going on, with the k-segment bounds (8k more
// top steps a round and rounds, 26 + k DDA steps a round); the ray ends
// with k segments, and its tallies go to col, nothing to `out`.
template <bool STAGE, bool PROBE, bool LOD, bool COLLECT = false>
__device__ __forceinline__ void brick_ray(const Tree& tree, const Rays& rays,
                                          const Out& out, int i,
                                          Probe<PROBE>& probe,
                                          int* __restrict__ my_row,
                                          const Lod* lod,
                                          Slots* col = nullptr) {
  static_assert(!(COLLECT && LOD), "the LOD walk has no collect mode");
  long long t = probe.enter(PH_RAY);
  Ray r;
  Walk w;
  bool done = setup(rays.origin, rays.direction, i, r, w);
  probe.leave(PH_RAY, t);
  const int depth = tree.depth, top_depth = tree.top_depth;
  int n_top = max_iters_for_depth(top_depth);
  int n_rounds = 16 * depth + 64;
  if constexpr (COLLECT) {
    n_top += 8 * col->k;
    n_rounds += 8 * col->k;
  }
  const int vshift = S_MAX - depth;
  const float vsize = __int_as_float((127 - depth) << 23);      // 2^-depth
  const float bsize = __int_as_float((127 - top_depth) << 23);  // 2^-top_depth
  int flip[3];
  for (int c = 0; c < 3; ++c) flip[c] = ((r.om >> c) & 1) ? 0 : 7;

  int hp = -1, hc = 0, leaf = -1, it = 0, node = -1, count = 0;
  float ht = 0.0f;
  int rounds = 0, dda = 0, capped = 0, dda_max = 0;
  while (!done && rounds < n_rounds) {
    ++rounds;
    // the round's top walk, to a brick or the end of the ray
    int what = STEP_ON, child_shift = 0, leaf_rank = 0;
    LodStep ls;
    for (int top = 0; top < n_top && what == STEP_ON; ++top) {
      t = probe.enter(PH_STEP);
      ++it;
      if constexpr (LOD) {
        Seg unused;
        what = walk_step<false, true>(r, w, tree.masks, tree.child,
                                      tree.parent_ptr, child_shift, leaf_rank,
                                      unused, lod, &ls);
      } else {
        what = stackless_step(r, w, tree.masks, tree.child, tree.parent_ptr,
                              child_shift, leaf_rank);
      }
      probe.leave(PH_STEP, t);
    }
    if (what == STEP_EXIT) {
      done = true;
      break;
    }
    if (what == STEP_ON) {  // the round's step cap
      ++capped;
      continue;
    }
    if constexpr (LOD) {  // the footprint stops the ray at a node or a brick
      if (what == STEP_NODE || ls.big) {
        node = what == STEP_NODE
                   ? ls.node
                   : lod->n_top + __ldg(tree.child + w.parent) + leaf_rank;
        ht = w.t_min;
        done = true;
        break;
      }
    }
    // parked at brick top_child[parent] + leaf_rank: descend to the entry
    // voxel, then step through the brick
    t = probe.enter(PH_DESCENT);
    const int* row = tree.bricks +
                     (size_t)(__ldg(tree.child + w.parent) + leaf_rank) * ROW_WORDS;
    if constexpr (STAGE) {
      int v[ROW_WORDS];
      for (int k = 0; k < ROW_WORDS; ++k) v[k] = __ldg(row + k);
      for (int k = 0; k < ROW_WORDS; ++k) my_row[k] = v[k];
      if constexpr (COLLECT) {
        int first = v[16];
        for (int k = 0; k < 16; ++k) {
          my_row[ROW_WORDS + k] = first;
          first += __popc((uint32_t)v[k]);
        }
      }
    }
    auto word = [row, my_row](int k) -> int {
      if constexpr (STAGE) {
        return my_row[k];
      } else {
        return __ldg(row + k);
      }
    };
    float bpos[3] = {w.pos[0], w.pos[1], w.pos[2]};
    float t_cur = w.t_min;
    rtt_dda::descend(r.t_coef, r.t_bias, bsize, t_cur, bpos);
    probe.leave(PH_DESCENT, t);
    int steps = 0;
    if constexpr (COLLECT) {
      const int n_dda = 3 * 8 + 2 + col->k;
      while (steps < n_dda) {
        t = probe.enter(PH_DDA);
        ++steps;
        const float t_entry = t_cur;
        int idx9;
        bool solid;
        float t_exit;
        const int step = rtt_dda::dda_collect_step(
            bpos, t_cur, r.t_coef, r.t_bias, flip, vshift, vsize,
            [&word](int k) { return (uint32_t)word(k); }, idx9, solid, t_exit);
        probe.leave(PH_DDA, t);
        if (solid) {
          t = probe.enter(PH_SEG);
          const int wsel = idx9 >> 5;  // rtt_dda::leaf_of from the prefix
          col->id[count] = my_row[ROW_WORDS + wsel] +
                           __popc((uint32_t)word(wsel) & ((1u << (idx9 & 31)) - 1u));
          col->t_in[count] = t_entry;
          col->t_out[count] = t_exit;
          const bool full = ++count >= col->k;
          probe.leave(PH_SEG, t);
          if (full) {  // the ray ends here, without the step
            done = true;
            break;
          }
        }
        if (step == rtt_dda::DDA_EXIT) {
          w.popped = true;
          break;
        }
      }
    } else {
      for (; steps < DDA_ROUND_STEPS;) {
        t = probe.enter(PH_DDA);
        ++steps;
        int idx9;
        const int step = rtt_dda::dda_step(
            bpos, t_cur, r.t_coef, r.t_bias, flip, vshift, vsize, INFINITY,
            [&word](int k) { return (uint32_t)word(k); }, idx9);
        if (step == rtt_dda::DDA_HIT) {
          leaf = rtt_dda::leaf_of(word, idx9);
          hp = w.parent;
          hc = child_shift;
          ht = t_cur;
          done = true;
        }
        if (step == rtt_dda::DDA_EXIT) w.popped = true;
        probe.leave(PH_DDA, t);
        if (step != rtt_dda::DDA_STAY) break;
      }
    }
    w.t_min = t_cur;
    it += steps;
    dda += steps;
    dda_max = max(dda_max, steps);
  }
  if constexpr (COLLECT) {  // the warp's write-out writes the ray
    col->count = count;
    col->iters = it;
    col->stats[0] = rounds;
    col->stats[1] = dda;
    col->stats[2] = capped;
    col->stats[3] = dda_max;
    col->stats[4] = done ? 0 : 1;
    return;
  }
  t = probe.enter(PH_RAY);
  write_ray(out, i, leaf, ht, hp, hc, it);
  if constexpr (LOD) lod->hit_node[i] = node;
  write_stats(out.stats, i, rounds, dda, capped, dda_max, !done);
  probe.ray();
  probe.leave(PH_RAY, t);
}

// One thread a ray, brick_ray in blocks of B threads.
template <bool STAGE, bool PROBE, int B>
__global__ void __launch_bounds__(B)
brick_trace_kernel(Tree tree, Rays rays, Out out,
                   long long* __restrict__ probe_out) {
  __shared__ int staged[STAGE ? B * ROW_WORDS : 1];
  Probe<PROBE> probe;
  probe.begin();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < rays.n)
    brick_ray<STAGE, PROBE, false>(tree, rays, out, i, probe,
                                   staged + (STAGE ? threadIdx.x * ROW_WORDS : 0),
                                   nullptr);
  probe.finish(probe_out);
}

// The wide form with the footprint stop: brick_trace_lod's first form.
__global__ void __launch_bounds__(WIDE_BLOCK)
brick_trace_lod_kernel(Tree tree, Rays rays, Out out, Lod lod) {
  __shared__ int staged[WIDE_BLOCK * ROW_WORDS];
  Probe<false> probe;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < rays.n)
    brick_ray<true, false, true>(tree, rays, out, i, probe,
                                 staged + threadIdx.x * ROW_WORDS, &lod);
}

// The first form with the counters.
__global__ void __launch_bounds__(WIDE_BLOCK)
brick_trace_lod_probe_kernel(Tree tree, Rays rays, Out out, Lod lod,
                             long long* __restrict__ probe_out) {
  __shared__ int staged[WIDE_BLOCK * ROW_WORDS];
  Probe<true> probe;
  probe.begin();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < rays.n)
    brick_ray<true, true, true>(tree, rays, out, i, probe,
                                staged + threadIdx.x * ROW_WORDS, &lod);
  probe.finish(probe_out);
}

// brick_trace_lod's patched form, the main path's: the first form's body,
// one thread a ray in the patch order (patch_ray), a parked ray's brick row
// staged in the thread's 17 words of the block's dynamic shared memory
// (blockDim.x * ROW_WORDS words). Compiled for blocks of up to
// PATCH_BLOCK_MAX threads; launched with the caller's block
// (brick_cuda.BLOCKS).
template <bool PROBE>
__global__ void __launch_bounds__(PATCH_BLOCK_MAX)
brick_trace_lod_patched_kernel(Tree tree, Rays rays, int width, Out out,
                               Lod lod, long long* __restrict__ probe_out) {
  extern __shared__ int smem[];
  Probe<PROBE> probe;
  probe.begin();
  const int i = patch_ray(blockIdx.x * blockDim.x + threadIdx.x, rays.n, width);
  if (i >= 0)
    brick_ray<true, PROBE, true>(tree, rays, out, i, probe,
                                 smem + threadIdx.x * ROW_WORDS, &lod);
  probe.finish(probe_out);
}

// ---- the k-segment traces ---------------------------------------------------

__device__ __forceinline__ void write_segment(const MultiOut& out, int i,
                                              int slot, int leaf, float t_in,
                                              float t_out) {
  const size_t s = (size_t)i * out.k + slot;
  out.hit_leaf[s] = leaf;
  out.t_in[s] = t_in;
  out.t_out[s] = t_out;
}

// The ray's count and steps, and its empty slots padded (-1, 0, 0).
__device__ __forceinline__ void finish_multi(const MultiOut& out, int i,
                                             int count, int it) {
  for (int slot = count; slot < out.k; ++slot)
    write_segment(out, i, slot, -1, 0.0f, 0.0f);
  out.count[i] = count;
  out.iters[i] = it;
}

// esvo_stackless_multi, one thread a ray in blocks of 128: the stackless walk
// over the full tree in collect mode, at most max_iters_for_depth(depth) + 8k
// steps; it ends with k segments or when the ray leaves the root cube. Each
// segment is written to its (N, k) slot as it is found, its leaf id loaded
// first.
__global__ void __launch_bounds__(BLOCK)
esvo_stackless_multi_kernel(Tree tree, Rays rays, MultiOut out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rays.n) return;
  Ray r;
  Walk w;
  bool done = setup(rays.origin, rays.direction, i, r, w);
  const int n_max = max_iters_for_depth(tree.depth) + 8 * out.k;
  int count = 0, it = 0;
  while (!done && it < n_max) {
    ++it;
    int child_shift, leaf_rank;
    Seg seg;
    const int what = walk_step<true>(r, w, tree.masks, tree.child,
                                     tree.parent_ptr, child_shift, leaf_rank,
                                     seg);
    if (what & STEP_COLLECTED) {
      write_segment(out, i, count, __ldg(tree.leaf_base + seg.parent) + seg.rank,
                    seg.t_in, seg.t_out);
      done = ++count >= out.k;
    }
    done = done || (what & STEP_WHAT) == STEP_EXIT;
  }
  finish_multi(out, i, count, it);
  write_stats(out.stats, i, 0, 0, 0, 0, !done);
}

// Ray i of esvo_stackless_multi with the counters: the kernel above's body,
// each phase counted. (The kernel keeps its own copy of the body: through
// this function its code comes out with two registers' names exchanged.)
__device__ __forceinline__ void stackless_multi_ray(
    const Tree& tree, const Rays& rays, const MultiOut& out, int i,
    Probe<true>& probe) {
  long long t = probe.enter(PH_RAY);
  Ray r;
  Walk w;
  bool done = setup(rays.origin, rays.direction, i, r, w);
  probe.leave(PH_RAY, t);
  const int n_max = max_iters_for_depth(tree.depth) + 8 * out.k;
  int count = 0, it = 0;
  while (!done && it < n_max) {
    t = probe.enter(PH_STEP);
    ++it;
    int child_shift, leaf_rank;
    Seg seg;
    const int what = walk_step<true>(r, w, tree.masks, tree.child,
                                     tree.parent_ptr, child_shift, leaf_rank,
                                     seg);
    probe.leave(PH_STEP, t);
    if (what & STEP_COLLECTED) {
      t = probe.enter(PH_SEG);
      write_segment(out, i, count, __ldg(tree.leaf_base + seg.parent) + seg.rank,
                    seg.t_in, seg.t_out);
      done = ++count >= out.k;
      probe.leave(PH_SEG, t);
    }
    done = done || (what & STEP_WHAT) == STEP_EXIT;
  }
  t = probe.enter(PH_RAY);
  finish_multi(out, i, count, it);
  write_stats(out.stats, i, 0, 0, 0, 0, !done);
  probe.ray();
  probe.leave(PH_RAY, t);
}

// The same with the counters.
__global__ void __launch_bounds__(BLOCK)
esvo_stackless_multi_probe_kernel(Tree tree, Rays rays, MultiOut out,
                                  long long* __restrict__ probe_out) {
  Probe<true> probe;
  probe.begin();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < rays.n) stackless_multi_ray(tree, rays, out, i, probe);
  probe.finish(probe_out);
}

// Ray i of esvo_stackless_multi's patched form: the first form's walk over
// the node row table (walk_step's ROWS mode), a segment's leaf id taken
// from the row in registers; PROBE: with the counters.
template <bool PROBE>
__device__ __forceinline__ void stackless_multi_rows_ray(
    const int4* __restrict__ rows, const Rays& rays, int depth,
    const MultiOut& out, int i, Probe<PROBE>& probe) {
  long long t = probe.enter(PH_RAY);
  Ray r;
  Walk w;
  bool done = setup(rays.origin, rays.direction, i, r, w);
  int4 row = __ldg(rows);
  probe.leave(PH_RAY, t);
  const int n_max = max_iters_for_depth(depth) + 8 * out.k;
  int count = 0, it = 0;
  while (!done && it < n_max) {
    t = probe.enter(PH_STEP);
    ++it;
    int child_shift, leaf_rank;
    Seg seg;
    const int what = walk_step<true, false, true>(
        r, w, nullptr, nullptr, nullptr, child_shift, leaf_rank, seg, nullptr,
        nullptr, &row, rows);
    probe.leave(PH_STEP, t);
    if (what & STEP_COLLECTED) {
      t = probe.enter(PH_SEG);
      write_segment(out, i, count, seg.rank, seg.t_in, seg.t_out);
      done = ++count >= out.k;
      probe.leave(PH_SEG, t);
    }
    done = done || (what & STEP_WHAT) == STEP_EXIT;
  }
  t = probe.enter(PH_RAY);
  finish_multi(out, i, count, it);
  write_stats(out.stats, i, 0, 0, 0, 0, !done);
  probe.ray();
  probe.leave(PH_RAY, t);
}

// esvo_stackless_multi's patched form: one thread a ray in the patch order
// (patch_ray), the walk over the node row table; blocks as the caller asks,
// up to PATCH_BLOCK_MAX.
template <bool PROBE>
__global__ void __launch_bounds__(PATCH_BLOCK_MAX)
esvo_stackless_multi_patched_kernel(const int4* __restrict__ rows, Rays rays,
                                    int depth, int width, MultiOut out,
                                    long long* __restrict__ probe_out) {
  Probe<PROBE> probe;
  probe.begin();
  const int i = patch_ray(blockIdx.x * blockDim.x + threadIdx.x, rays.n, width);
  if (i >= 0) stackless_multi_rows_ray<PROBE>(rows, rays, depth, out, i, probe);
  probe.finish(probe_out);
}

// The first form of brick_trace_multi, one thread a ray: brick_trace's
// first form (rounds of a top walk, a descent and a brick DDA, rows read as
// the DDA needs them) with the DDA in collect mode. Each solid voxel the ray
// stands in is written to its (N, k) slot as (leaf, t, the voxel's exit t)
// and the walk goes on. Bounds on each ray: max_iters_for_depth(top_depth)
// + 8k top steps and 3 * 8 + 2 + k DDA steps a round, 16 * depth + 8k + 64
// rounds.
template <bool PROBE>
__device__ __forceinline__ void brick_multi_ray(
    const Tree& tree, const Rays& rays, const MultiOut& out, int i,
    Probe<PROBE>& probe) {
  long long t = probe.enter(PH_RAY);
  Ray r;
  Walk w;
  bool done = setup(rays.origin, rays.direction, i, r, w);
  probe.leave(PH_RAY, t);
  const int depth = tree.depth, top_depth = tree.top_depth, k = out.k;
  const int n_top = max_iters_for_depth(top_depth) + 8 * k;
  const int n_rounds = 16 * depth + 8 * k + 64;
  const int n_dda = 3 * 8 + 2 + k;
  const int vshift = S_MAX - depth;
  const float vsize = __int_as_float((127 - depth) << 23);      // 2^-depth
  const float bsize = __int_as_float((127 - top_depth) << 23);  // 2^-top_depth
  int flip[3];
  for (int c = 0; c < 3; ++c) flip[c] = ((r.om >> c) & 1) ? 0 : 7;

  int count = 0, it = 0, rounds = 0, dda = 0, capped = 0, dda_max = 0;
  while (!done && rounds < n_rounds) {
    ++rounds;
    int what = STEP_ON, child_shift = 0, leaf_rank = 0;
    for (int top = 0; top < n_top && what == STEP_ON; ++top) {
      t = probe.enter(PH_STEP);
      ++it;
      what = stackless_step(r, w, tree.masks, tree.child, tree.parent_ptr,
                            child_shift, leaf_rank);
      probe.leave(PH_STEP, t);
    }
    if (what == STEP_EXIT) {
      done = true;
      break;
    }
    if (what == STEP_ON) {  // the round's step cap
      ++capped;
      continue;
    }
    t = probe.enter(PH_DESCENT);
    const int* row = tree.bricks +
                     (size_t)(__ldg(tree.child + w.parent) + leaf_rank) * ROW_WORDS;
    auto word = [row](int kk) -> int { return __ldg(row + kk); };
    float bpos[3] = {w.pos[0], w.pos[1], w.pos[2]};
    float t_cur = w.t_min;
    rtt_dda::descend(r.t_coef, r.t_bias, bsize, t_cur, bpos);
    probe.leave(PH_DESCENT, t);
    int steps = 0;
    while (steps < n_dda) {
      t = probe.enter(PH_DDA);
      ++steps;
      const float t_entry = t_cur;
      int idx9;
      bool solid;
      float t_exit;
      const int step = rtt_dda::dda_collect_step(
          bpos, t_cur, r.t_coef, r.t_bias, flip, vshift, vsize,
          [&word](int kk) { return (uint32_t)word(kk); }, idx9, solid, t_exit);
      probe.leave(PH_DDA, t);
      if (solid) {
        t = probe.enter(PH_SEG);
        write_segment(out, i, count, rtt_dda::leaf_of(word, idx9), t_entry,
                      t_exit);
        const bool full = ++count >= k;
        probe.leave(PH_SEG, t);
        if (full) {  // the ray ends here, without the step
          done = true;
          break;
        }
      }
      if (step == rtt_dda::DDA_EXIT) {
        w.popped = true;
        break;
      }
    }
    w.t_min = t_cur;
    it += steps;
    dda += steps;
    dda_max = max(dda_max, steps);
  }
  t = probe.enter(PH_RAY);
  finish_multi(out, i, count, it);
  write_stats(out.stats, i, rounds, dda, capped, dda_max, !done);
  probe.ray();
  probe.leave(PH_RAY, t);
}

template <bool PROBE>
__global__ void __launch_bounds__(BLOCK)
brick_trace_multi_kernel(Tree tree, Rays rays, MultiOut out,
                                long long* __restrict__ probe_out) {
  Probe<PROBE> probe;
  probe.begin();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < rays.n) brick_multi_ray<PROBE>(tree, rays, out, i, probe);
  probe.finish(probe_out);
}

// The staged form's shared memory a ray, in 4-byte words: its parked brick
// row with its prefix counts (over which the statistics are staged for the
// write-out) and its k slots (leaf, t_in, t_out).
__host__ __device__ constexpr int brick_multi_words(int k) {
  return PREFIX_ROW_WORDS + 3 * k;
}

// The staged form's write-out by each warp, once its 32 walks have ended
// (the warp's rays are contiguous, so no block barrier is needed): the
// warp's rays [w0, w0 + nw) own one contiguous run of nw * k words of each
// (N, k) array, written by consecutive lanes to consecutive words; nw is
// below 32 in the ragged last warp and at most 0 in a warp past the last
// ray, which writes nothing. Count and iters a word a lane; the statistics
// staged over `spare` (the warp's shared memory, N_STATS words a lane) and
// written as one run of nw * N_STATS words.
template <bool PROBE>
__device__ __forceinline__ void write_warp(
    const MultiOut& out, const int* s_id, const float* s_tin,
    const float* s_tout, int* spare, const Slots& col, int n,
    Probe<PROBE>& probe) {
  const int lane = threadIdx.x & 31, k = out.k;
  const int w0 = blockIdx.x * blockDim.x + (threadIdx.x & ~31);
  const int nw = min(32, n - w0);
  __syncwarp();
  long long t = probe.enter(PH_RAY);
  const size_t base = (size_t)w0 * k;
  for (int j = lane; j < nw * k; j += 32) {
    out.hit_leaf[base + j] = s_id[j];
    out.t_in[base + j] = s_tin[j];
    out.t_out[base + j] = s_tout[j];
  }
  if (lane < nw) {
    out.count[w0 + lane] = col.count;
    out.iters[w0 + lane] = col.iters;
    probe.ray();
  }
  if (out.stats != nullptr) {
    __syncwarp();  // every slot is read: `spare` may overlap them
    for (int c = 0; c < N_STATS; ++c) spare[lane * N_STATS + c] = col.stats[c];
    __syncwarp();
    for (int j = lane; j < nw * N_STATS; j += 32)
      out.stats[(size_t)w0 * N_STATS + j] = spare[j];
  }
  probe.leave(PH_RAY, t);
}

// The staged form of brick_trace_multi: brick_ray in collect mode on the
// wide form's body (the parked ray's brick row and its prefix counts staged
// in the thread's slice of shared memory), each warp's region holding its
// 32 rays' rows, then their k slots (leaf, t_in, t_out), each 32k words (32
// * brick_multi_words(k) words a warp, dynamic), written out at the warp's
// end. Launched in blocks of MULTI_BLOCK threads (any multiple of 32 up to
// BLOCK gives the same bits; its launch bounds are BLOCK's, as measured).
template <bool PROBE>
__global__ void __launch_bounds__(BLOCK)
brick_trace_multi_staged_kernel(Tree tree, Rays rays, MultiOut out,
                                long long* __restrict__ probe_out) {
  extern __shared__ int smem[];
  const int tid = threadIdx.x, lane = tid & 31, k = out.k;
  int* region = smem + (tid >> 5) * 32 * brick_multi_words(k);
  int* rows = region;
  int* s_leaf = region + 32 * PREFIX_ROW_WORDS;
  float* s_tin = reinterpret_cast<float*>(s_leaf + 32 * k);
  float* s_tout = s_tin + 32 * k;
  Probe<PROBE> probe;
  probe.begin();
  Slots col{s_leaf + lane * k, s_tin + lane * k, s_tout + lane * k, k, 0, 0,
            {0, 0, 0, 0, 0}};
  for (int s = 0; s < k; ++s) {
    col.id[s] = -1;
    col.t_in[s] = 0.0f;
    col.t_out[s] = 0.0f;
  }
  const int i = blockIdx.x * blockDim.x + tid;
  if (i < rays.n)
    brick_ray<true, PROBE, false, true>(tree, rays, Out{}, i, probe,
                                        rows + lane * PREFIX_ROW_WORDS, nullptr,
                                        &col);
  write_warp(out, s_leaf, s_tin, s_tout, rows, col, rays.n, probe);
  probe.finish(probe_out);
}

// ---- the streamed world: clipmap_trace, clipmap_trace_brick -----------------
//
// The two-phase stitched traversal of a clipmap (raytracingtest_tpu/stream/
// clipmap.py::_trace_clipmap_jax :879 and _trace_clipmap_brick_jax :965), one
// thread a ray that runs the rounds itself. A round: o_cur = o + t_off * d;
// the trunk's stackless walk from (o_cur - org) / size finds the next chunk
// (a trunk leaf) or ends the ray; the chunk's walk from its root row in the
// arena, from (o_cur - c_org) / c_size, either hits (hit_t = t_off + t *
// c_size) or the ray moves past the chunk's box: t_off = t_off + t_exit +
// 1e-5. At most n_max rounds; a ray still walking after them is truncated.
// The reference runs the rounds for the batch, but a finished ray changes
// nothing in a later round, so a ray's own loop gives its bits. Each walk
// keeps its own bound (esvo_stackless's, or brick_trace's). Arithmetic is in
// the reference's order, each product rounded on its own (--fmad=false),
// divisions IEEE.

// The stackless walk of one ray over `tree` from row `root` (stackless_ray
// without its outputs): the hit's leaf row, or -1; its t in t_hit. `probe`
// (a Probe) sees each step as a step and the set-up as a ray's.
template <class P>
__device__ __forceinline__ int stackless_walk_probe(const Tree& tree,
                                                    const float o[3],
                                                    const float d[3], int root,
                                                    float& t_hit, P& probe) {
  Ray r;
  Walk w;
  long long t = probe.enter(PH_RAY);
  bool done = setup_at(o, d, root, r, w);
  probe.leave(PH_RAY, t);
  const int n_max = max_iters_for_depth(tree.depth);
  int leaf = -1, it = 0;
  float ht = 0.0f;
  while (!done && it < n_max) {
    t = probe.enter(PH_STEP);
    ++it;
    int child_shift, leaf_rank;
    const int what = stackless_step(r, w, tree.masks, tree.child,
                                    tree.parent_ptr, child_shift, leaf_rank);
    if (what == STEP_LEAF) {
      ht = w.t_min;
      leaf = __ldg(tree.leaf_base + w.parent) + leaf_rank;
    }
    done = what != STEP_ON;
    probe.leave(PH_STEP, t);
  }
  t_hit = ht;
  return leaf;
}

__device__ __forceinline__ int stackless_walk_from(const Tree& tree,
                                                   const float o[3],
                                                   const float d[3], int root,
                                                   float& t_hit) {
  Probe<false> probe;
  return stackless_walk_probe(tree, o, d, root, t_hit, probe);
}

// The brick trace of one ray over the top tree `tree` from top row `root`
// (brick_ray's first form, rows read as the DDA needs them, without its
// outputs): the hit's leaf, or -1; its t in t_hit.
__device__ __forceinline__ int brick_walk_from(const Tree& tree,
                                               const float o[3],
                                               const float d[3], int root,
                                               float& t_hit) {
  Ray r;
  Walk w;
  bool done = setup_at(o, d, root, r, w);
  const int depth = tree.depth, top_depth = tree.top_depth;
  const int n_top = max_iters_for_depth(top_depth);
  const int n_rounds = 16 * depth + 64;
  const int vshift = S_MAX - depth;
  const float vsize = __int_as_float((127 - depth) << 23);      // 2^-depth
  const float bsize = __int_as_float((127 - top_depth) << 23);  // 2^-top_depth
  int flip[3];
  for (int c = 0; c < 3; ++c) flip[c] = ((r.om >> c) & 1) ? 0 : 7;
  int leaf = -1, rounds = 0;
  float ht = 0.0f;
  while (!done && rounds < n_rounds) {
    ++rounds;
    int what = STEP_ON, child_shift = 0, leaf_rank = 0;
    for (int top = 0; top < n_top && what == STEP_ON; ++top)
      what = stackless_step(r, w, tree.masks, tree.child, tree.parent_ptr,
                            child_shift, leaf_rank);
    if (what == STEP_EXIT) break;
    if (what == STEP_ON) continue;  // the round's step cap
    const int* row = tree.bricks +
                     (size_t)(__ldg(tree.child + w.parent) + leaf_rank) * ROW_WORDS;
    auto word = [row](int k) -> int { return __ldg(row + k); };
    float bpos[3] = {w.pos[0], w.pos[1], w.pos[2]};
    float t_cur = w.t_min;
    rtt_dda::descend(r.t_coef, r.t_bias, bsize, t_cur, bpos);
    for (int steps = 0; steps < DDA_ROUND_STEPS;) {
      ++steps;
      int idx9;
      const int step = rtt_dda::dda_step(
          bpos, t_cur, r.t_coef, r.t_bias, flip, vshift, vsize, INFINITY,
          [&word](int k) { return (uint32_t)word(k); }, idx9);
      if (step == rtt_dda::DDA_HIT) {
        leaf = rtt_dda::leaf_of(word, idx9);
        ht = t_cur;
        done = true;
      }
      if (step == rtt_dda::DDA_EXIT) w.popped = true;
      if (step != rtt_dda::DDA_STAY) break;
    }
    w.t_min = t_cur;
  }
  t_hit = ht;
  return leaf;
}

// The clipmap's tables: each chunk's root row in the arena, its world
// corner (3 floats) and size; the trunk's world corner and size; the rounds'
// bound.
struct Clip {
  const int* roots;
  const float* origins;
  const float* sizes;
  float org[3];
  float size;
  int n_max;
};
struct ClipOut {
  int* hit_leaf;
  float* hit_t;
  int* hit_chunk;
  unsigned char* truncated;
};

// One thread a ray: the rounds. BRICK: the chunk's walk is the brick trace
// through the brick arena (chunks: its top tree and bricks), else the
// stackless walk through the node arena.
template <bool BRICK>
__global__ void __launch_bounds__(BLOCK)
clipmap_trace_kernel(Tree trunk, Tree chunks, Clip clip, Rays rays,
                     ClipOut out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rays.n) return;
  float o[3], d[3];
  for (int c = 0; c < 3; ++c) {
    o[c] = rays.origin[(size_t)3 * i + c];
    d[c] = rays.direction[(size_t)3 * i + c];
  }
  float t_off = 0.0f, hit_t = 0.0f;
  int hit_leaf = -1, hit_chunk = -1;
  bool done = false;
  for (int round = 0; round < clip.n_max && !done; ++round) {
    float o_cur[3], o_trunk[3];
    for (int c = 0; c < 3; ++c) {
      o_cur[c] = o[c] + t_off * d[c];
      o_trunk[c] = (o_cur[c] - clip.org[c]) / clip.size;
    }
    float t_unused;
    const int cid = stackless_walk_from(trunk, o_trunk, d, 0, t_unused);
    if (cid < 0) {  // the trunk misses: the ray ends
      done = true;
      break;
    }
    const float c_size = __ldg(clip.sizes + cid);
    float c_org[3], o_loc[3];
    for (int c = 0; c < 3; ++c) {
      c_org[c] = __ldg(clip.origins + (size_t)3 * cid + c);
      o_loc[c] = (o_cur[c] - c_org[c]) / c_size;
    }
    const int root = __ldg(clip.roots + cid);
    float t2;
    const int leaf = BRICK ? brick_walk_from(chunks, o_loc, d, root, t2)
                           : stackless_walk_from(chunks, o_loc, d, root, t2);
    if (leaf >= 0) {
      hit_leaf = leaf;
      hit_t = t_off + t2 * c_size;
      hit_chunk = cid;
      done = true;
      break;
    }
    // past the chunk's box: the least far-plane t over the axes
    float t_exit = INFINITY;
    for (int c = 0; c < 3; ++c) {
      const float sd = fabsf(d[c]) < 1e-12f ? 1e-12f : d[c];
      const float t0 = (c_org[c] - o_cur[c]) / sd;
      const float t1 = (c_org[c] + c_size - o_cur[c]) / sd;
      t_exit = fminf(t_exit, fmaxf(t0, t1));
    }
    t_off = t_off + fmaxf(t_exit, 0.0f) + 1e-5f;
  }
  out.hit_leaf[i] = hit_leaf;
  out.hit_t[i] = hit_t;
  out.hit_chunk[i] = hit_chunk;
  out.truncated[i] = done ? 0 : 1;
}

// ---- clipmap_trace_brick's wide form and the stitched trace's probe ----------
//
// clipmap_trace_kernel<true> is clipmap_trace_brick's first form (a thread
// a ray in blocks of 128; both walks set up from o and d each round; the
// chunk's brick rows read with __ldg as the DDA needs them). Its wide form,
// clipmap_trace_brick_kernel, the main path's, gives the same bits:
//   * the direction's constants (t_coef = -1/|d| and the octant mask) are
//     made once a ray: set-up takes them from d alone, and every walk of a
//     ray has the same d, so each round's two set-ups keep their bits
//     without their three divisions each (setup_dir; o_trunk's, o_loc's and
//     the box exit's divisions stay, as the reference takes them);
//   * the chunk's brick walk is the wide brick trace's (brick_ray<STAGE>):
//     blocks of WIDE_BLOCK, a parked ray's 17-word brick row read as
//     independent loads into its slice of shared memory before its DDA.
// The wide form and the probes share clip_brick_ray and clip_brick_walk;
// the first form's kernel keeps its own body (clipmap_trace_kernel,
// brick_walk_from), so that its code stays as it was. The direction's
// set-up (dir_setup, setup_dir) repeats setup_at's operations for the same
// reason: setup_at serves every other kernel here.
// clipmap_trace_brick_probe_kernel<WIDE> is either form with per-warp counters
// over CP_PHASES phases (the layout at Probe, NPH = CP_PHASES): a trunk
// step, a walk's set-up (two a round where the trunk finds a chunk), a
// chunk's top step, the descent into a brick, a DDA step, the box exit, and
// a round (entered once a round, so its lanes sum the rays' rounds and its
// issues count the warp's passes through the round loop).
constexpr int CP_TRUNK = 0, CP_SETUP = 1, CP_TOP = 2, CP_DESCENT = 3,
              CP_DDA = 4, CP_EXIT = 5, CP_ROUND = 6, CP_PHASES = 7;

// A ray's direction constants: what setup_at takes from d.
struct Dir {
  float t_coef[3];
  int om;
};

__device__ __forceinline__ void dir_setup(const float* __restrict__ d, Dir& dr) {
  const float eps = 1.0f / 8388608.0f;  // 2^-S_MAX
  dr.om = 7;
  for (int c = 0; c < 3; ++c) {
    float dc = d[c];
    if (fabsf(dc) < eps) dc = dc >= 0.0f ? eps : -eps;
    dr.t_coef[c] = -1.0f / fabsf(dc);
    if (dc > 0.0f) dr.om ^= 1 << c;
  }
}

// setup_at from the direction's constants: the same operations on the same
// values, the divisions done once a ray.
__device__ __forceinline__ bool setup_dir(const float* __restrict__ o,
                                          const Dir& dr, int root, Ray& r,
                                          Walk& w) {
  r.om = dr.om;
  for (int c = 0; c < 3; ++c) {
    const float oc = o[c] + 1.0f;
    r.t_coef[c] = dr.t_coef[c];
    r.t_bias[c] = r.t_coef[c] * oc;
    if (!((dr.om >> c) & 1)) r.t_bias[c] = 3.0f * r.t_coef[c] - r.t_bias[c];
  }
  float t_min = fmaxf(fmaxf(2.0f * r.t_coef[0] - r.t_bias[0],
                            2.0f * r.t_coef[1] - r.t_bias[1]),
                      2.0f * r.t_coef[2] - r.t_bias[2]);
  r.t_root = fminf(fminf(r.t_coef[0] - r.t_bias[0], r.t_coef[1] - r.t_bias[1]),
                   r.t_coef[2] - r.t_bias[2]);
  t_min = fmaxf(t_min, 0.0f);
  w.idx = 0;
  for (int c = 0; c < 3; ++c) {
    const bool upper = 1.5f * r.t_coef[c] - r.t_bias[c] > t_min;
    w.pos[c] = upper ? 1.5f : 1.0f;
    if (upper) w.idx |= 1 << c;
  }
  w.parent = root;
  w.scale = S_MAX - 1;
  w.t_min = t_min;
  w.popped = false;
  return t_min >= r.t_root;
}

// A walk's set-up in either form: WIDE from the ray's constants, else
// setup_at from d.
template <bool WIDE>
__device__ __forceinline__ bool clip_setup(const float* o, const float* d,
                                           const Dir& dr, int root, Ray& r,
                                           Walk& w) {
  if constexpr (WIDE) {
    return setup_dir(o, dr, root, r, w);
  } else {
    return setup_at(o, d, root, r, w);
  }
}

// brick_walk_from in either form, with the counters: WIDE stages the
// parked brick's row in my_row, its slice of shared memory.
template <bool WIDE, class P>
__device__ __forceinline__ int clip_brick_walk(const Tree& tree,
                                               const float o[3],
                                               const float d[3], const Dir& dr,
                                               int root, float& t_hit,
                                               int* __restrict__ my_row,
                                               P& probe) {
  Ray r;
  Walk w;
  long long t = probe.enter(CP_SETUP);
  bool done = clip_setup<WIDE>(o, d, dr, root, r, w);
  probe.leave(CP_SETUP, t);
  const int depth = tree.depth, top_depth = tree.top_depth;
  const int n_top = max_iters_for_depth(top_depth);
  const int n_rounds = 16 * depth + 64;
  const int vshift = S_MAX - depth;
  const float vsize = __int_as_float((127 - depth) << 23);      // 2^-depth
  const float bsize = __int_as_float((127 - top_depth) << 23);  // 2^-top_depth
  int flip[3];
  for (int c = 0; c < 3; ++c) flip[c] = ((r.om >> c) & 1) ? 0 : 7;
  int leaf = -1, rounds = 0;
  float ht = 0.0f;
  while (!done && rounds < n_rounds) {
    ++rounds;
    int what = STEP_ON, child_shift = 0, leaf_rank = 0;
    for (int top = 0; top < n_top && what == STEP_ON; ++top) {
      t = probe.enter(CP_TOP);
      what = stackless_step(r, w, tree.masks, tree.child, tree.parent_ptr,
                            child_shift, leaf_rank);
      probe.leave(CP_TOP, t);
    }
    if (what == STEP_EXIT) break;
    if (what == STEP_ON) continue;  // the round's step cap
    t = probe.enter(CP_DESCENT);
    const int* row = tree.bricks +
                     (size_t)(__ldg(tree.child + w.parent) + leaf_rank) * ROW_WORDS;
    if constexpr (WIDE) {
      int v[ROW_WORDS];
      for (int k = 0; k < ROW_WORDS; ++k) v[k] = __ldg(row + k);
      for (int k = 0; k < ROW_WORDS; ++k) my_row[k] = v[k];
    }
    auto word = [row, my_row](int k) -> int {
      if constexpr (WIDE) {
        return my_row[k];
      } else {
        return __ldg(row + k);
      }
    };
    float bpos[3] = {w.pos[0], w.pos[1], w.pos[2]};
    float t_cur = w.t_min;
    rtt_dda::descend(r.t_coef, r.t_bias, bsize, t_cur, bpos);
    probe.leave(CP_DESCENT, t);
    for (int steps = 0; steps < DDA_ROUND_STEPS;) {
      t = probe.enter(CP_DDA);
      ++steps;
      int idx9;
      const int step = rtt_dda::dda_step(
          bpos, t_cur, r.t_coef, r.t_bias, flip, vshift, vsize, INFINITY,
          [&word](int k) { return (uint32_t)word(k); }, idx9);
      if (step == rtt_dda::DDA_HIT) {
        leaf = rtt_dda::leaf_of(word, idx9);
        ht = t_cur;
        done = true;
      }
      if (step == rtt_dda::DDA_EXIT) w.popped = true;
      probe.leave(CP_DDA, t);
      if (step != rtt_dda::DDA_STAY) break;
    }
    w.t_min = t_cur;
  }
  t_hit = ht;
  return leaf;
}

// Ray i's rounds through the brick arena in either form (clipmap_trace_
// kernel<true>'s arithmetic), with the counters.
template <bool WIDE, class P>
__device__ __forceinline__ void clip_brick_ray(const Tree& trunk,
                                               const Tree& chunks,
                                               const Clip& clip,
                                               const Rays& rays,
                                               const ClipOut& out, int i,
                                               int* __restrict__ my_row,
                                               P& probe) {
  float o[3], d[3];
  for (int c = 0; c < 3; ++c) {
    o[c] = rays.origin[(size_t)3 * i + c];
    d[c] = rays.direction[(size_t)3 * i + c];
  }
  Dir dr;
  if constexpr (WIDE) dir_setup(d, dr);
  float t_off = 0.0f, hit_t = 0.0f;
  int hit_leaf = -1, hit_chunk = -1;
  bool done = false;
  for (int round = 0; round < clip.n_max && !done; ++round) {
    probe.leave(CP_ROUND, probe.enter(CP_ROUND));
    float o_cur[3], o_trunk[3];
    for (int c = 0; c < 3; ++c) {
      o_cur[c] = o[c] + t_off * d[c];
      o_trunk[c] = (o_cur[c] - clip.org[c]) / clip.size;
    }
    // the trunk's stackless walk (stackless_walk_from)
    Ray r;
    Walk w;
    long long t = probe.enter(CP_SETUP);
    bool walked = clip_setup<WIDE>(o_trunk, d, dr, 0, r, w);
    probe.leave(CP_SETUP, t);
    const int n_trunk = max_iters_for_depth(trunk.depth);
    int cid = -1;
    for (int it = 0; !walked && it < n_trunk;) {
      t = probe.enter(CP_TRUNK);
      ++it;
      int child_shift, leaf_rank;
      const int what = stackless_step(r, w, trunk.masks, trunk.child,
                                      trunk.parent_ptr, child_shift, leaf_rank);
      if (what == STEP_LEAF) cid = __ldg(trunk.leaf_base + w.parent) + leaf_rank;
      walked = what != STEP_ON;
      probe.leave(CP_TRUNK, t);
    }
    if (cid < 0) {  // the trunk misses: the ray ends
      done = true;
      break;
    }
    const float c_size = __ldg(clip.sizes + cid);
    float c_org[3], o_loc[3];
    for (int c = 0; c < 3; ++c) {
      c_org[c] = __ldg(clip.origins + (size_t)3 * cid + c);
      o_loc[c] = (o_cur[c] - c_org[c]) / c_size;
    }
    float t2;
    const int leaf = clip_brick_walk<WIDE>(chunks, o_loc, d, dr,
                                           __ldg(clip.roots + cid), t2, my_row,
                                           probe);
    if (leaf >= 0) {
      hit_leaf = leaf;
      hit_t = t_off + t2 * c_size;
      hit_chunk = cid;
      done = true;
      break;
    }
    // past the chunk's box: the least far-plane t over the axes
    t = probe.enter(CP_EXIT);
    float t_exit = INFINITY;
    for (int c = 0; c < 3; ++c) {
      const float sd = fabsf(d[c]) < 1e-12f ? 1e-12f : d[c];
      const float t0 = (c_org[c] - o_cur[c]) / sd;
      const float t1 = (c_org[c] + c_size - o_cur[c]) / sd;
      t_exit = fminf(t_exit, fmaxf(t0, t1));
    }
    t_off = t_off + fmaxf(t_exit, 0.0f) + 1e-5f;
    probe.leave(CP_EXIT, t);
  }
  out.hit_leaf[i] = hit_leaf;
  out.hit_t[i] = hit_t;
  out.hit_chunk[i] = hit_chunk;
  out.truncated[i] = done ? 0 : 1;
  probe.ray();
}

// clipmap_trace_brick's wide form: a thread a ray in blocks of WIDE_BLOCK.
__global__ void __launch_bounds__(WIDE_BLOCK)
clipmap_trace_brick_kernel(Tree trunk, Tree chunks, Clip clip, Rays rays,
                           ClipOut out) {
  __shared__ int staged[WIDE_BLOCK * ROW_WORDS];
  Probe<false, CP_PHASES> probe;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < rays.n)
    clip_brick_ray<true>(trunk, chunks, clip, rays, out, i,
                         staged + threadIdx.x * ROW_WORDS, probe);
}

// Either form with the counters: the wide form in its blocks, the first in
// blocks of BLOCK.
template <bool WIDE>
__global__ void __launch_bounds__(WIDE ? WIDE_BLOCK : BLOCK)
clipmap_trace_brick_probe_kernel(Tree trunk, Tree chunks, Clip clip, Rays rays,
                           ClipOut out, long long* __restrict__ probe_out) {
  __shared__ int staged[WIDE ? WIDE_BLOCK * ROW_WORDS : 1];
  Probe<true, CP_PHASES> probe;
  probe.begin();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < rays.n)
    clip_brick_ray<WIDE>(trunk, chunks, clip, rays, out, i,
                         staged + (WIDE ? threadIdx.x * ROW_WORDS : 0), probe);
  probe.finish(probe_out);
}

// ---- clipmap_trace's wide form and its probe ---------------------------------
//
// clipmap_trace_kernel<false> is clipmap_trace's first form (a thread a ray
// in blocks of 128; both walks set up from o and d each round; o_trunk and
// o_loc divided by the trunk's and the chunk's size). A round of it takes 18
// IEEE divisions against some 7.8 stackless steps on fly frame 0. Its wide
// form, clipmap_trace_wide_kernel, the main path's, gives the same bits:
//   * the direction's constants are made once a ray (dir_setup, setup_dir,
//     as clipmap_trace_brick's wide form makes them): each round's two
//     set-ups keep their bits without their three divisions each;
//   * o_trunk's and o_loc's divisions by a size that is a normal power of
//     two whose reciprocal is normal (pow2_reciprocal: the size's bits) are
//     products with that exact reciprocal: x / 2^k and x * 2^-k are the same
//     real number, each correctly rounded, so the same float, subnormal
//     results included. The trunk's size is tested once a ray, a chunk's
//     each round; another size is divided, as the first form does. The
//     chunk sizes are min_chunk_size * 2^lod (0.125 and 0.25 on the fly
//     path) and the trunk's the world's (1);
//   * the box exit's six divisions by sd stay: sd is the ray's direction,
//     whose reciprocal is not exact.
// The first form's kernel keeps its own body (clipmap_trace_kernel,
// stackless_walk_from), so that its code stays as it was.
// clipmap_trace_probe_kernel<WIDE> is either form with per-warp counters
// over CN_PHASES phases (the layout at Probe, NPH = CN_PHASES): a trunk step,
// a walk's set-up, the origin's scaling (o_cur and o_trunk, then o_loc), a
// chunk's stackless step, the box exit, and a round (entered once a round,
// as clipmap_trace_brick's probe enters it).
constexpr int CN_TRUNK = 0, CN_SETUP = 1, CN_SCALE = 2, CN_STEP = 3,
              CN_EXIT = 4, CN_ROUND = 5, CN_PHASES = 6;
// the wide form's block: 128 measured faster than 256 alone (235.1-235.8
// against 246.3-246.4 us on fly frame 0, PERF.md)
constexpr int CLIP_BLOCK = 128;

// Whether `size` is a normal power of two with a normal reciprocal, which
// it then returns in `inv`: biased exponent e in [1, 253], mantissa 0; the
// reciprocal's biased exponent is 254 - e.
__device__ __forceinline__ bool pow2_reciprocal(float size, float& inv) {
  const int bits = __float_as_int(size);
  const int e = (bits >> 23) & 0xff;
  inv = __int_as_float((254 - e) << 23);
  return (bits & 0x807fffff) == 0 && e >= 1 && e <= 253;
}

// (x - org) / size in either form: WIDE with the exact reciprocal where
// `exact` holds.
template <bool WIDE>
__device__ __forceinline__ float clip_scale(float x, float org, float size,
                                            bool exact, float inv) {
  if constexpr (WIDE) {
    if (exact) return (x - org) * inv;
  }
  return (x - org) / size;
}

// The stackless walk of either form from node row `root`, with the
// counters (stackless_walk_probe's arithmetic): the leaf, or -1; its t in
// t_hit.
template <bool WIDE, class P>
__device__ __forceinline__ int clip_node_walk(const Tree& tree, const float o[3],
                                              const float d[3], const Dir& dr,
                                              int root, int step_phase,
                                              float& t_hit, P& probe) {
  Ray r;
  Walk w;
  long long t = probe.enter(CN_SETUP);
  bool done = clip_setup<WIDE>(o, d, dr, root, r, w);
  probe.leave(CN_SETUP, t);
  const int n_max = max_iters_for_depth(tree.depth);
  int leaf = -1;
  float ht = 0.0f;
  for (int it = 0; !done && it < n_max;) {
    t = probe.enter(step_phase);
    ++it;
    int child_shift, leaf_rank;
    const int what = stackless_step(r, w, tree.masks, tree.child,
                                    tree.parent_ptr, child_shift, leaf_rank);
    if (what == STEP_LEAF) {
      ht = w.t_min;
      leaf = __ldg(tree.leaf_base + w.parent) + leaf_rank;
    }
    done = what != STEP_ON;
    probe.leave(step_phase, t);
  }
  t_hit = ht;
  return leaf;
}

// Ray i's rounds through the node arena in either form (clipmap_trace_
// kernel<false>'s arithmetic), with the counters.
template <bool WIDE, class P>
__device__ __forceinline__ void clip_node_ray(const Tree& trunk,
                                              const Tree& chunks,
                                              const Clip& clip, const Rays& rays,
                                              const ClipOut& out, int i,
                                              P& probe) {
  float o[3], d[3];
  for (int c = 0; c < 3; ++c) {
    o[c] = rays.origin[(size_t)3 * i + c];
    d[c] = rays.direction[(size_t)3 * i + c];
  }
  Dir dr;
  float inv_trunk = 0.0f;
  bool exact_trunk = false;
  if constexpr (WIDE) {
    dir_setup(d, dr);
    exact_trunk = pow2_reciprocal(clip.size, inv_trunk);
  }
  float t_off = 0.0f, hit_t = 0.0f;
  int hit_leaf = -1, hit_chunk = -1;
  bool done = false;
  for (int round = 0; round < clip.n_max && !done; ++round) {
    probe.leave(CN_ROUND, probe.enter(CN_ROUND));
    long long t = probe.enter(CN_SCALE);
    float o_cur[3], o_trunk[3];
    for (int c = 0; c < 3; ++c) {
      o_cur[c] = o[c] + t_off * d[c];
      o_trunk[c] = clip_scale<WIDE>(o_cur[c], clip.org[c], clip.size, exact_trunk,
                                    inv_trunk);
    }
    probe.leave(CN_SCALE, t);
    float t_unused;
    const int cid = clip_node_walk<WIDE>(trunk, o_trunk, d, dr, 0, CN_TRUNK,
                                         t_unused, probe);
    if (cid < 0) {  // the trunk misses: the ray ends
      done = true;
      break;
    }
    const float c_size = __ldg(clip.sizes + cid);
    float c_org[3], o_loc[3];
    t = probe.enter(CN_SCALE);
    float inv_chunk = 0.0f;
    bool exact_chunk = false;
    if constexpr (WIDE) exact_chunk = pow2_reciprocal(c_size, inv_chunk);
    for (int c = 0; c < 3; ++c) {
      c_org[c] = __ldg(clip.origins + (size_t)3 * cid + c);
      o_loc[c] = clip_scale<WIDE>(o_cur[c], c_org[c], c_size, exact_chunk, inv_chunk);
    }
    probe.leave(CN_SCALE, t);
    float t2;
    const int leaf = clip_node_walk<WIDE>(chunks, o_loc, d, dr,
                                          __ldg(clip.roots + cid), CN_STEP, t2,
                                          probe);
    if (leaf >= 0) {
      hit_leaf = leaf;
      hit_t = t_off + t2 * c_size;
      hit_chunk = cid;
      done = true;
      break;
    }
    // past the chunk's box: the least far-plane t over the axes
    t = probe.enter(CN_EXIT);
    float t_exit = INFINITY;
    for (int c = 0; c < 3; ++c) {
      const float sd = fabsf(d[c]) < 1e-12f ? 1e-12f : d[c];
      const float t0 = (c_org[c] - o_cur[c]) / sd;
      const float t1 = (c_org[c] + c_size - o_cur[c]) / sd;
      t_exit = fminf(t_exit, fmaxf(t0, t1));
    }
    t_off = t_off + fmaxf(t_exit, 0.0f) + 1e-5f;
    probe.leave(CN_EXIT, t);
  }
  out.hit_leaf[i] = hit_leaf;
  out.hit_t[i] = hit_t;
  out.hit_chunk[i] = hit_chunk;
  out.truncated[i] = done ? 0 : 1;
  probe.ray();
}

// clipmap_trace's wide form: a thread a ray in blocks of CLIP_BLOCK.
__global__ void __launch_bounds__(CLIP_BLOCK)
clipmap_trace_wide_kernel(Tree trunk, Tree chunks, Clip clip, Rays rays,
                          ClipOut out) {
  Probe<false, CN_PHASES> probe;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < rays.n) clip_node_ray<true>(trunk, chunks, clip, rays, out, i, probe);
}

// Either form with the counters: the wide form in blocks of CLIP_BLOCK, the
// first in blocks of BLOCK.
template <bool WIDE>
__global__ void __launch_bounds__(WIDE ? CLIP_BLOCK : BLOCK)
clipmap_trace_probe_kernel(Tree trunk, Tree chunks, Clip clip, Rays rays,
                           ClipOut out, long long* __restrict__ probe_out) {
  Probe<true, CN_PHASES> probe;
  probe.begin();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < rays.n) clip_node_ray<WIDE>(trunk, chunks, clip, rays, out, i, probe);
  probe.finish(probe_out);
}

// ---- the level-sharded renderer: level_round ---------------------------------
//
// One round of the level-sharded traces (raytracingtest_tpu/parallel/
// level_sharded.py): the trunk is the tree's top trunk_depth levels, each of
// whose leaves is an octant; every octant's subtree lives in one rank's
// arena, from its root row. One thread a ray, or a packet, in three modes:
//
//   LEVEL_SHARDED  replaces _phase_loop_local's round (:353-380; K10b): rays
//                  replicated on every rank. A ray not done: o_cur = o + t_off
//                  * d; the trunk's stackless walk from o_cur finds its
//                  octant or ends the ray; where this rank owns the octant,
//                  the arena's walk from the octant's root at (o_cur - org) /
//                  size. A ray of another rank's octant skips that walk (the
//                  reference walks it and masks the result out).
//   LEVEL_TRUNK    the trunk half of make_exchange_trace's round (:531-537
//                  and the advance :615-618; K10c): the rank's own rays.
//   LEVEL_PACKETS  the owner's half of that round (:576-588; K10c): the arena
//                  walk of each received packet (8 words: o_cur, d, the
//                  octant id and the valid flag as int32 bits) from its
//                  octant's root. An invalid packet is skipped.
//
// Outputs a ray (SHARDED, TRUNK): oct_id (-1: done, or the trunk missed) and
// t_next = t_off + t_exit + 1e-5, the advance past the octant's box (t_off
// where there is no octant); SHARDED also: hit (1 where this rank's arena
// stopped the ray), the arena leaf (-1 elsewhere) and t_hit = t_off + t *
// size (0 elsewhere). A packet's reply (PACKETS): (leaf as int32 bits, t *
// size), (-1, 0) for a miss or an invalid packet. The rounds' carry (the
// all_reduce of the hit flags, the exchange, the records) is the caller's.
// Each walk keeps esvo_stackless's bound; arithmetic is clipmap_trace's, in
// the reference's order, each product rounded on its own (--fmad=false).

constexpr int LEVEL_SHARDED = 0, LEVEL_TRUNK = 1, LEVEL_PACKETS = 2;
constexpr int PACKET_WORDS = 8, REPLY_WORDS = 2;

// The octant tables (each octant's owner rank, root row in its owner's
// arena, octree-space low corner (3 floats)), the octants' common size and
// this rank.
struct Octants {
  const int* owner;
  const int* root;
  const float* origin;
  float size;
  int rank;
};
struct LevelIO {
  const float* origin;     // (n, 3); PACKETS: the packets (n, 8)
  const float* direction;  // (n, 3)
  const float* t_off;      // (n,)
  const unsigned char* done;
  int n;
  int* oct_id;
  int* hit;
  int* leaf;               // PACKETS: the replies (n, 2) as floats
  float* t_hit;
  float* t_next;
};

// The arena walk from octant `oct`'s root of a ray at octree-space o_cur:
// the arena leaf, or -1; t * size of the hit in t_scaled.
template <class P>
__device__ __forceinline__ int octant_walk(const Tree& arena, const Octants& oc,
                                           int oct, const float o_cur[3],
                                           const float d[3], float& t_scaled,
                                           P& probe) {
  float o_loc[3];
  for (int c = 0; c < 3; ++c)
    o_loc[c] = (o_cur[c] - __ldg(oc.origin + (size_t)3 * oct + c)) / oc.size;
  float t2;
  const int leaf = stackless_walk_probe(arena, o_loc, d, __ldg(oc.root + oct),
                                       t2, probe);
  t_scaled = leaf >= 0 ? t2 * oc.size : 0.0f;
  return leaf;
}

// One round of ray (or packet) i in MODE. QUEUED: i came through the
// queue, so it is live (a ray not done, a valid packet) and its flag is not
// read again.
template <int MODE, bool QUEUED, class P>
__device__ __forceinline__ void level_ray(const Tree& trunk, const Tree& arena,
                                          const Octants& oc, const LevelIO& io,
                                          int i, P& probe) {
  if (MODE == LEVEL_PACKETS) {
    const float* p = io.origin + (size_t)PACKET_WORDS * i;
    int leaf = -1;
    float t = 0.0f;
    if (QUEUED || __float_as_int(p[7]) != 0) {
      const float o[3] = {p[0], p[1], p[2]}, d[3] = {p[3], p[4], p[5]};
      leaf = octant_walk(arena, oc, __float_as_int(p[6]), o, d, t, probe);
    }
    float* reply = reinterpret_cast<float*>(io.leaf) + (size_t)REPLY_WORDS * i;
    reply[0] = __int_as_float(leaf);
    reply[1] = t;
    probe.ray();
    return;
  }
  const float t_off = io.t_off[i];
  int oct = -1, leaf = -1;
  float t_hit = 0.0f, t_next = t_off;
  if (QUEUED || !io.done[i]) {
    float o_cur[3], d[3];
    for (int c = 0; c < 3; ++c) {
      d[c] = io.direction[(size_t)3 * i + c];
      o_cur[c] = io.origin[(size_t)3 * i + c] + t_off * d[c];
    }
    float t_unused;
    oct = stackless_walk_probe(trunk, o_cur, d, 0, t_unused, probe);
    if (oct >= 0) {
      // past the octant's box: the least far-plane t over the axes
      float t_exit = INFINITY;
      for (int c = 0; c < 3; ++c) {
        const float org = __ldg(oc.origin + (size_t)3 * oct + c);
        const float sd = fabsf(d[c]) < 1e-12f ? 1e-12f : d[c];
        const float t0 = (org - o_cur[c]) / sd;
        const float t1 = (org + oc.size - o_cur[c]) / sd;
        t_exit = fminf(t_exit, fmaxf(t0, t1));
      }
      t_next = t_off + fmaxf(t_exit, 0.0f) + 1e-5f;
      if (MODE == LEVEL_SHARDED && __ldg(oc.owner + oct) == oc.rank) {
        float t2;
        leaf = octant_walk(arena, oc, oct, o_cur, d, t2, probe);
        if (leaf >= 0) t_hit = t_off + t2;
      }
    }
  }
  io.oct_id[i] = oct;
  io.t_next[i] = t_next;
  if (MODE == LEVEL_SHARDED) {
    io.hit[i] = leaf >= 0 ? 1 : 0;
    io.leaf[i] = leaf;
    io.t_hit[i] = t_hit;
  }
  probe.ray();
}

// The first form: a thread for each of the n rays or packets, a done ray or
// an invalid packet skipped inside its warp.
template <int MODE>
__global__ void __launch_bounds__(BLOCK)
level_round_kernel(Tree trunk, Tree arena, Octants oc, LevelIO io) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= io.n) return;
  Probe<false> probe;
  level_ray<MODE, false>(trunk, arena, oc, io, i, probe);
}

// The first form with the counters (the probe layout above): steps are the
// trunk's and the arena's stackless steps, rays the rays or packets a warp
// handled, the ray phase the walks' set-ups.
template <int MODE>
__global__ void __launch_bounds__(BLOCK)
level_round_probe_kernel(Tree trunk, Tree arena, Octants oc, LevelIO io,
                         long long* __restrict__ probe_out) {
  Probe<true> probe;
  probe.begin();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < io.n) level_ray<MODE, false>(trunk, arena, oc, io, i, probe);
  probe.finish(probe_out);
}

// ---- level_round's queue ------------------------------------------------------
//
// The main path's form launches a thread for each live ray or valid packet
// only, so that a warp's lanes all walk. "sharded" and "trunk": a stable
// compaction of the rays not done, the live rays' indices in order, and a
// done ray's outputs written as the first form writes them (oct_id -1,
// t_next = t_off, no hit). In a loop the compaction runs over the previous
// round's queue instead of every ray (a done ray stays done, so the live
// rays are a subset of it), and the loop keeps the outputs from round to
// round: a ray's outputs are written as a done ray's once, in the round
// after it was done, and stay. So a round's queue costs in proportion to
// the rays it had live. The queue takes the done rays off the walk's warps;
// it does not shorten a round's longest walks, which set its span (the
// first form's probe, chip_smoke.py [sharded]).
//
// level_queue_lookback_kernel, the main path's, makes a round's queue in
// one pass: a single-pass scan with decoupled look-back (Merrill and
// Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
// NVIDIA 2016). Its bytes are the flags read once, the done rays' t_off and
// outputs and the live rays' places (PERF.md); its first form made it in
// five launches and read the flags twice. What bounds it at the loops'
// sizes is the done rays' outputs (five scattered words a ray, the same
// writes as the first form's place pass) and a block's chain of round trips
// to memory. A block
// of QBLOCK threads takes a tile of QTILE entries, its tile's index from a
// ticket (an atomic counter), not from blockIdx, so that a block looks back
// only at tiles whose blocks already run. Warp w of the tile holds entries
// w * 512 + k * 32 + lane (k < QITEMS). Over every ray the tile's flags come
// in as one 16-byte load a thread, staged in shared memory, and entry by
// entry a done ray's outputs go out; over a queue (OVER_QUEUE) its entries
// and then their flags come in, each a batch of loads in flight together.
// A warp counts its live rays with __ballot_sync and __popc, a ballot a k.
// The block's aggregate goes out in its tile's status word (a 64-bit word:
// the launch's epoch, a flag, aggregate or inclusive prefix, and the
// value); warp 0 looks back over the words of the tiles before it, one a
// lane, 32 at a time, summing aggregates down to the nearest inclusive
// prefix (a wider window, 8 words a lane, waits on more tiles: slower,
// PERF.md), and publishes its own inclusive prefix, while over a
// queue the other warps write their done rays' outputs; then each live ray
// goes to its place, the tile's exclusive prefix plus its warp's and its
// rank in the warp's ballots. The last tile writes the total to n_live on
// the device, which level_round_queued_kernel reads and the loop reads once
// on the host. The status words and the control word (the launch's epoch
// and the next ticket) belong to a loop and are zeroed once a loop: each
// launch tags its words with its epoch, so a word of an earlier launch
// reads as not yet published, and the block that takes the last ticket
// moves the epoch on and the ticket back to 0 for the next launch, in the
// same word.
// The queue is the same stable order as the first form's, so every round
// keeps its bits.
//
// The first form, level_queue_serial (kept as it was): the blocks' counts
// (level_queue_count_kernel), their exclusive scan and total (torch.cumsum
// outside), and the place pass (level_queue_place_kernel): each live ray's
// index at its rank (ballot and __popc within the warp, the block's warp
// prefix in shared memory, the block's offset), the done rays' outputs.
//
// "packets": the exchange lays each peer's packets at the start of that
// peer's segment of `seg` slots (make_exchange_trace's bucket), so the
// valid slots of a segment are a prefix; level_queue_packets_kernel finds each segment's count by a
// search of its flags (a block a segment, QBLOCK samples a step) and writes
// every slot's reply as an invalid packet's, (-1, 0), which the walk then
// overwrites for the valid ones. A loop's first round has no done ray and
// no queue: thread j takes ray j. level_round_queued_kernel: thread j takes
// the j-th live ray (or the j-th valid slot, counting segment by segment)
// and runs the first form's round on it, its outputs at the ray's own
// index; threads past the device-side count return at once (the grid is
// sized by a bound the host already holds).
constexpr int QBLOCK = 256;

struct LevelQueue {
  const int* queue;   // "sharded", "trunk": the live rays in order (null in
                      // a first round: every ray); "packets": the
                      // segments' valid counts
  const int* n_live;  // "sharded", "trunk": the count of live rays
  int n_seg, seg;     // "packets": the segments and their length
};

// The ray of the pass's entry j: ray j, or with a previous round's queue
// (`prev`, its length `*n_prev` on the device) that queue's j-th ray; -1
// past the end.
__device__ __forceinline__ int queue_entry(const int* __restrict__ prev,
                                           const int* __restrict__ n_prev,
                                           int n, int j) {
  if (prev == nullptr) return j < n ? j : -1;
  return j < __ldg(n_prev) ? __ldg(prev + j) : -1;
}

__global__ void __launch_bounds__(QBLOCK)
level_queue_count_kernel(const unsigned char* __restrict__ done, int n,
                         const int* __restrict__ prev,
                         const int* __restrict__ n_prev,
                         int* __restrict__ counts) {
  const int i = queue_entry(prev, n_prev, n, blockIdx.x * QBLOCK + threadIdx.x);
  const int total = __syncthreads_count(i >= 0 && !done[i]);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

template <int MODE>
__global__ void __launch_bounds__(QBLOCK)
level_queue_place_kernel(const unsigned char* __restrict__ done, int n,
                         const int* __restrict__ prev,
                         const int* __restrict__ n_prev,
                         const int* __restrict__ block_base,
                         int* __restrict__ queue, LevelIO io) {
  __shared__ int warp_total[QBLOCK / 32];
  const int i = queue_entry(prev, n_prev, n, blockIdx.x * QBLOCK + threadIdx.x);
  const bool live = i >= 0 && !done[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(FULL, live);
  if (lane == 0) warp_total[warp] = __popc(ballot);
  __syncthreads();
  if (i < 0) return;
  if (!live) {
    io.oct_id[i] = -1;
    io.t_next[i] = io.t_off[i];
    if (MODE == LEVEL_SHARDED) {
      io.hit[i] = 0;
      io.leaf[i] = -1;
      io.t_hit[i] = 0.0f;
    }
    return;
  }
  int pos = block_base[blockIdx.x] + __popc(ballot & ((1u << lane) - 1u));
  for (int w = 0; w < warp; ++w) pos += warp_total[w];
  queue[pos] = i;
}

__global__ void __launch_bounds__(QBLOCK)
level_queue_packets_kernel(const float* __restrict__ packets, int n, int n_seg,
                           int seg, float* __restrict__ replies,
                           int* __restrict__ seg_count) {
  const int i = blockIdx.x * QBLOCK + threadIdx.x;
  if (i < n) {
    replies[(size_t)REPLY_WORDS * i] = __int_as_float(-1);
    replies[(size_t)REPLY_WORDS * i + 1] = 0.0f;
  }
  if (blockIdx.x >= n_seg) return;
  // segment blockIdx.x: every slot below a is valid; slot b is not, or b is
  // the segment's end. The bounds are the same in every thread.
  const float* flags = packets + (size_t)PACKET_WORDS * blockIdx.x * seg + 7;
  int a = 0, b = seg;
  while (a < b) {
    const int step = (b - a + QBLOCK - 1) / QBLOCK;
    const int x = a + threadIdx.x * step;
    const bool valid = x < b && __float_as_int(flags[(size_t)PACKET_WORDS * x]) != 0;
    const int cnt = __syncthreads_count(valid);
    const int samples = (b - a + step - 1) / step;
    if (cnt == 0) {
      b = a;
    } else {
      const int next_b = cnt < samples ? a + cnt * step : b;
      a = a + (cnt - 1) * step + 1;
      b = next_b;
    }
  }
  if (threadIdx.x == 0) seg_count[blockIdx.x] = a;
}

// level_queue_lookback_kernel's tiles: QITEMS entries a thread, QTILE a
// block, QWARP a warp
constexpr int QITEMS = 16, QTILE = QBLOCK * QITEMS, QWARP = 32 * QITEMS;
// a tile's status word: (epoch << 2 | flag) << 32 | value, the epoch's low
// 30 bits; flag 0 (or an earlier epoch): not published yet
constexpr unsigned Q_AGGREGATE = 1, Q_PREFIX = 2, Q_EPOCH_MASK = 0x3fffffffu;

// A loop's status words: ctl, the launch's epoch (high 32 bits) and the
// next tile's ticket (low 32 bits), then a word a tile.
struct QueueStatus {
  unsigned long long* ctl;
  unsigned long long* words;
};

__device__ __forceinline__ void q_publish(unsigned long long* word, unsigned epoch,
                                          unsigned flag, int value) {
  *(volatile unsigned long long*)word =
      ((unsigned long long)((epoch << 2) | flag) << 32) | (unsigned)value;
}

// The flag of a tile's status word in this launch (0: not published yet),
// its value in `value`.
__device__ __forceinline__ unsigned q_read(const unsigned long long* word,
                                           unsigned epoch, int& value) {
  const unsigned long long s = *(const volatile unsigned long long*)word;
  value = (int)(unsigned)s;
  const unsigned hi = (unsigned)(s >> 32);
  return (hi >> 2) == epoch ? (hi & 3u) : 0u;
}

// A done ray's outputs, as the first form of the round writes them.
template <int MODE>
__device__ __forceinline__ void write_done(const LevelIO& io, int i, float t_off) {
  io.oct_id[i] = -1;
  io.t_next[i] = t_off;
  if (MODE == LEVEL_SHARDED) {
    io.hit[i] = 0;
    io.leaf[i] = -1;
    io.t_hit[i] = 0.0f;
  }
}

// The one pass (see the section's head): a block a tile of QTILE entries,
// every ray or (OVER_QUEUE) the last round's queue (its first *n_prev
// entries); the tiles' status words at qs; the live rays' indices at queue
// from the tile's exclusive prefix on, the total at n_live (the last tile),
// a done ray's outputs at io. A block's chain: its ticket (one atomic that
// also returns the epoch); over every ray, its flags (one 16-byte load a
// thread) and, entry by entry, a done ray's outputs and the ballots; over a
// queue, its entries and their flags (each a batch of loads in flight
// together) and the ballots; its aggregate out and warp 0's look-back, one
// word a lane, while over a queue the other warps write their done rays'
// outputs (their t_off a batch); then the places.
template <int MODE, bool OVER_QUEUE>
__global__ void __launch_bounds__(QBLOCK)
level_queue_lookback_kernel(const unsigned char* __restrict__ done, int n,
                            const int* __restrict__ prev,
                            const int* __restrict__ n_prev, QueueStatus qs,
                            int* __restrict__ queue, int* __restrict__ n_live,
                            LevelIO io) {
  __shared__ uint4 flags[OVER_QUEUE ? 1 : QBLOCK];  // the tile's flags, over every ray
  __shared__ int warp_first[QBLOCK / 32];
  __shared__ int tile_s;
  __shared__ unsigned epoch_s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    const unsigned long long got = atomicAdd(qs.ctl, 1ull);
    const unsigned ticket = (unsigned)got;
    // the last ticket: every other block holds its own; the epoch moves on
    // and the ticket returns to 0 for the next launch, in one atomic
    if (ticket == gridDim.x - 1) atomicAdd(qs.ctl, (1ull << 32) - gridDim.x);
    tile_s = (int)ticket;
    epoch_s = (unsigned)(got >> 32) & Q_EPOCH_MASK;
  }
  const int m = OVER_QUEUE ? __ldg(n_prev) : n;
  __syncthreads();
  const int tile = tile_s;
  const unsigned epoch = epoch_s;
  const long long first = (long long)tile * QTILE + warp * QWARP + lane;
  // entry k of this thread is first + 32 k
  unsigned ballot[QITEMS];
  int ray[QITEMS];
  unsigned gone = 0;  // bit k: entry k is a done ray (over a queue)
  int count = 0;
  if constexpr (!OVER_QUEUE) {
    const long long j = (long long)tile * QTILE + 16 * threadIdx.x;
    if (j + 16 <= n && (reinterpret_cast<size_t>(done) & 15) == 0) {
      flags[threadIdx.x] = __ldg(reinterpret_cast<const uint4*>(done + j));
    } else {
      unsigned char* mine = reinterpret_cast<unsigned char*>(flags) + 16 * threadIdx.x;
      for (int k = 0; k < 16; ++k) mine[k] = j + k < n ? done[j + k] : 1;
    }
    __syncthreads();
    const unsigned char* staged = reinterpret_cast<const unsigned char*>(flags);
#pragma unroll
    for (int k = 0; k < QITEMS; ++k) {
      const long long e = first + 32 * k;
      ray[k] = e < n ? (int)e : -1;
      const bool dead = ray[k] >= 0 && staged[warp * QWARP + k * 32 + lane] != 0;
      if (dead) write_done<MODE>(io, ray[k], io.t_off[ray[k]]);
      ballot[k] = __ballot_sync(FULL, ray[k] >= 0 && !dead);
      count += __popc(ballot[k]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < QITEMS; ++k) {
      const long long e = first + 32 * k;
      ray[k] = e < m ? __ldg(prev + e) : -1;
    }
#pragma unroll
    for (int k = 0; k < QITEMS; ++k)
      if (ray[k] >= 0 && __ldg(done + ray[k])) gone |= 1u << k;
#pragma unroll
    for (int k = 0; k < QITEMS; ++k) {
      ballot[k] = __ballot_sync(FULL, ray[k] >= 0 && !((gone >> k) & 1u));
      count += __popc(ballot[k]);
    }
  }
  if (lane == 0) warp_first[warp] = count;
  __syncthreads();
  if (warp == 0) {  // the tile's aggregate, the look-back, the warps' first places
    const int c = lane < QBLOCK / 32 ? warp_first[lane] : 0;
    int incl = c;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    const int aggregate = __shfl_sync(FULL, incl, 31);
    if (lane == 0)
      q_publish(qs.words + tile, epoch, tile == 0 ? Q_PREFIX : Q_AGGREGATE, aggregate);
    int exclusive = 0;
    for (int hi = tile - 1; tile > 0; hi -= 32) {
      // lane l reads tile hi - l's word, once it is published; a tile
      // before the first is an inclusive prefix of 0
      const int p = hi - lane;
      unsigned flag = Q_PREFIX;
      int value = 0;
      if (p >= 0) {
        do {
          flag = q_read(qs.words + p, epoch, value);
        } while (flag == 0);
      }
      // the nearest inclusive prefix and the aggregates after it
      const unsigned prefix = __ballot_sync(FULL, flag == Q_PREFIX);
      const int stop = prefix ? __ffs(prefix) - 1 : 31;
      int add = lane <= stop ? value : 0;
      for (int o = 16; o > 0; o >>= 1) add += __shfl_xor_sync(FULL, add, o);
      exclusive += add;
      if (prefix) break;
    }
    if (lane == 0 && tile > 0)
      q_publish(qs.words + tile, epoch, Q_PREFIX, exclusive + aggregate);
    if (lane < QBLOCK / 32) warp_first[lane] = exclusive + incl - c;
    if (lane == 0 && tile == (int)gridDim.x - 1) *n_live = exclusive + aggregate;
  }
  if constexpr (OVER_QUEUE) {  // the done rays' outputs: their t_off a batch
    if (gone) {
      float t_was[QITEMS];
#pragma unroll
      for (int k = 0; k < QITEMS; ++k)
        t_was[k] = (gone >> k) & 1u ? __ldg(io.t_off + ray[k]) : 0.0f;
#pragma unroll
      for (int k = 0; k < QITEMS; ++k)
        if ((gone >> k) & 1u) write_done<MODE>(io, ray[k], t_was[k]);
    }
  }
  __syncthreads();
  // each live ray at its place: the warp's first, the ballots of k before
  // it, its rank in its own
  int pos = warp_first[warp];
#pragma unroll
  for (int k = 0; k < QITEMS; ++k) {
    const unsigned b = ballot[k];
    if ((b >> lane) & 1u) queue[pos + __popc(b & ((1u << lane) - 1u))] = ray[k];
    pos += __popc(b);
  }
}

template <int MODE>
__global__ void __launch_bounds__(BLOCK)
level_round_queued_kernel(Tree trunk, Tree arena, Octants oc, LevelIO io,
                          LevelQueue q) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  int i;
  if (MODE == LEVEL_PACKETS) {
    int s = 0, base = 0;
    for (; s < q.n_seg; ++s) {
      const int c = __ldg(q.queue + s);
      if (j < base + c) break;
      base += c;
    }
    if (s == q.n_seg) return;
    i = s * q.seg + (j - base);
  } else if (q.queue == nullptr) {  // a first round: every ray live
    if (j >= io.n) return;
    i = j;
  } else {
    if (j >= __ldg(q.n_live)) return;
    i = __ldg(q.queue + j);
  }
  Probe<false> probe;
  level_ray<MODE, true>(trunk, arena, oc, io, i, probe);
}

int blocks_for(int n, int span) { return (int)((n + (long long)span - 1) / span); }

Out outputs(void* hit_leaf, void* hit_t, void* hit_parent, void* hit_child,
            void* iters, void* stats) {
  return Out{(int*)hit_leaf, (float*)hit_t, (int*)hit_parent,
             (int*)hit_child, (int*)iters, (int*)stats};
}

// One launch of esvo_stackless (probe: with the counters).
int launch_stackless(const void* masks, const void* child_base,
                     const void* parent_ptr, const void* leaf_base,
                     const void* origin, const void* direction, int n,
                     int depth, const Out& out, void* probe, void* stream) {
  if (n < 0 || depth < 1 || depth > S_MAX - 1) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const Tree tree{(const int*)masks, (const int*)child_base,
                    (const int*)parent_ptr, (const int*)leaf_base, nullptr,
                    depth, 0};
    const Rays rays{(const float*)origin, (const float*)direction, n};
    const cudaStream_t s = (cudaStream_t)stream;
    long long* p = (long long*)probe;
    if (p) {
      esvo_stackless_kernel<true><<<blocks_for(n, BLOCK), BLOCK, 0, s>>>(
          tree, rays, out, p);
    } else {
      esvo_stackless_kernel<false><<<blocks_for(n, BLOCK), BLOCK, 0, s>>>(
          tree, rays, out, p);
    }
  }
  return (int)cudaGetLastError();
}

// A patched launch's arguments: an image width that divides n (0: none),
// a block of whole warps up to PATCH_BLOCK_MAX, and a grid that int holds.
bool patched_ok(int n, int depth, int width, int block) {
  return n >= 0 && depth >= 1 && depth <= S_MAX - 1 && width >= 0 &&
         (width == 0 || n % width == 0) && block >= 32 &&
         block <= PATCH_BLOCK_MAX && block % 32 == 0 &&
         patch_threads(n, width) + block < (1LL << 31);
}

// One launch of the patched esvo_stackless (LOD: esvo_stackless_lod, which
// has no probe form) in blocks of `block` threads (probe: with the
// counters).
template <bool LOD>
int launch_stackless_patched(const void* rows, const Tree& tree,
                             const void* origin, const void* direction, int n,
                             int width, int block, const Out& out,
                             const Lod& lod, void* probe, void* stream) {
  if (!patched_ok(n, tree.depth, width, block)) return (int)cudaErrorInvalidValue;
  const long long threads = patch_threads(n, width);
  if (threads > 0) {
    const Rays rays{(const float*)origin, (const float*)direction, n};
    const int blocks = (int)((threads + block - 1) / block);
    const cudaStream_t s = (cudaStream_t)stream;
    const int4* r = (const int4*)rows;
    long long* p = (long long*)probe;
    if (p) {
      if constexpr (LOD) return (int)cudaErrorInvalidValue;
      else esvo_stackless_patched_kernel<true, false><<<blocks, block, 0, s>>>(
          r, tree, rays, width, out, lod, p);
    } else {
      esvo_stackless_patched_kernel<false, LOD><<<blocks, block, 0, s>>>(
          r, tree, rays, width, out, lod, p);
    }
  }
  return (int)cudaGetLastError();
}

template <bool STAGE, int B>
void brick_launch(const Tree& tree, const Rays& rays, const Out& out,
                  long long* p, cudaStream_t s) {
  const int blocks = blocks_for(rays.n, B);
  if (p) {
    brick_trace_kernel<STAGE, true, B><<<blocks, B, 0, s>>>(tree, rays, out, p);
  } else {
    brick_trace_kernel<STAGE, false, B><<<blocks, B, 0, s>>>(tree, rays, out, p);
  }
}

// One launch of brick_trace in `form` (probe: with the counters).
int launch_brick(int form, const void* top_masks, const void* top_child,
                 const void* top_parent, const void* bricks,
                 const void* origin, const void* direction, int n, int depth,
                 int top_depth, const Out& out, void* probe, void* stream) {
  if (n < 0 || top_depth < 1 || depth != top_depth + 3 || depth > S_MAX - 1 ||
      form < FORM_FIRST || form > FORM_UNSTAGED)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const Tree tree{(const int*)top_masks, (const int*)top_child,
                    (const int*)top_parent, nullptr, (const int*)bricks,
                    depth, top_depth};
    const Rays rays{(const float*)origin, (const float*)direction, n};
    const cudaStream_t s = (cudaStream_t)stream;
    long long* p = (long long*)probe;
    if (form == FORM_FIRST) {
      brick_launch<false, BLOCK>(tree, rays, out, p, s);
    } else if (form == FORM_WIDE) {
      brick_launch<true, WIDE_BLOCK>(tree, rays, out, p, s);
    } else {
      brick_launch<false, WIDE_BLOCK>(tree, rays, out, p, s);
    }
  }
  return (int)cudaGetLastError();
}

// One launch of the staged brick_trace_multi (probe: with the counters) in
// blocks of MULTI_BLOCK threads, brick_multi_words(k) words of dynamic
// shared memory a ray; a k whose block would pass SMEM_MAX is refused (the
// caller reads cudaGetLastError).
template <bool PROBE>
int launch_staged(const Tree& tree, const Rays& rays, const MultiOut& out,
                  long long* p, cudaStream_t s) {
  const auto kernel = brick_trace_multi_staged_kernel<PROBE>;
  const size_t bytes = (size_t)MULTI_BLOCK * brick_multi_words(out.k) * sizeof(int);
  if (bytes > SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (bytes > SMEM_STATIC) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<blocks_for(rays.n, MULTI_BLOCK), MULTI_BLOCK, bytes, s>>>(tree, rays, out, p);
  return (int)cudaSuccess;
}

MultiOut multi_outputs(void* hit_leaf, void* t_in, void* t_out, void* count,
                       void* iters, void* stats, int k) {
  return MultiOut{(int*)hit_leaf, (float*)t_in, (float*)t_out, (int*)count,
                  (int*)iters, (int*)stats, k};
}

// One launch of esvo_stackless_multi (probe: with the counters).
int launch_stackless_multi(const void* masks, const void* child_base,
                           const void* parent_ptr, const void* leaf_base,
                           const void* origin, const void* direction, int n,
                           int depth, const MultiOut& out, void* probe,
                           void* stream) {
  if (n < 0 || depth < 1 || depth > S_MAX - 1 || out.k < 1)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const Tree tree{(const int*)masks, (const int*)child_base,
                    (const int*)parent_ptr, (const int*)leaf_base, nullptr,
                    depth, 0};
    const Rays rays{(const float*)origin, (const float*)direction, n};
    const cudaStream_t s = (cudaStream_t)stream;
    if (probe) {
      esvo_stackless_multi_probe_kernel<<<blocks_for(n, BLOCK), BLOCK, 0, s>>>(
          tree, rays, out, (long long*)probe);
    } else {
      esvo_stackless_multi_kernel<<<blocks_for(n, BLOCK), BLOCK, 0, s>>>(
          tree, rays, out);
    }
  }
  return (int)cudaGetLastError();
}

// One launch of esvo_stackless_multi's patched form in blocks of `block`
// threads (probe: with the counters).
int launch_stackless_multi_patched(const void* rows, const void* origin,
                                   const void* direction, int n, int depth,
                                   int width, int block, const MultiOut& out,
                                   void* probe, void* stream) {
  if (!patched_ok(n, depth, width, block) || out.k < 1)
    return (int)cudaErrorInvalidValue;
  const long long threads = patch_threads(n, width);
  if (threads > 0) {
    const Rays rays{(const float*)origin, (const float*)direction, n};
    const int blocks = (int)((threads + block - 1) / block);
    const cudaStream_t s = (cudaStream_t)stream;
    const int4* r = (const int4*)rows;
    long long* p = (long long*)probe;
    if (p) {
      esvo_stackless_multi_patched_kernel<true><<<blocks, block, 0, s>>>(
          r, rays, depth, width, out, p);
    } else {
      esvo_stackless_multi_patched_kernel<false><<<blocks, block, 0, s>>>(
          r, rays, depth, width, out, p);
    }
  }
  return (int)cudaGetLastError();
}

// One launch of brick_trace_multi in `form` (FORM_FIRST or FORM_STAGED;
// probe: with the counters).
int launch_brick_multi(int form, const void* top_masks, const void* top_child,
                       const void* top_parent, const void* bricks,
                       const void* origin, const void* direction, int n,
                       int depth, int top_depth, const MultiOut& out,
                       void* probe, void* stream) {
  if (n < 0 || top_depth < 1 || depth != top_depth + 3 || depth > S_MAX - 1 ||
      out.k < 1 || (form != FORM_FIRST && form != FORM_STAGED))
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const Tree tree{(const int*)top_masks, (const int*)top_child,
                    (const int*)top_parent, nullptr, (const int*)bricks,
                    depth, top_depth};
    const Rays rays{(const float*)origin, (const float*)direction, n};
    const cudaStream_t s = (cudaStream_t)stream;
    long long* p = (long long*)probe;
    int e = 0;
    if (form == FORM_FIRST && p) {
      brick_trace_multi_kernel<true><<<blocks_for(n, BLOCK), BLOCK, 0, s>>>(
          tree, rays, out, p);
    } else if (form == FORM_FIRST) {
      brick_trace_multi_kernel<false><<<blocks_for(n, BLOCK), BLOCK, 0, s>>>(
          tree, rays, out, p);
    } else {
      e = p ? launch_staged<true>(tree, rays, out, p, s)
            : launch_staged<false>(tree, rays, out, p, s);
    }
    if (e != 0) return e;
  }
  return (int)cudaGetLastError();
}

// A brick tree's tables and depths, as the kernels take them.
Tree brick_tree(const void* top_masks, const void* top_child,
                const void* top_parent, const void* bricks, int depth,
                int top_depth) {
  return Tree{(const int*)top_masks, (const int*)top_child,
              (const int*)top_parent, nullptr, (const int*)bricks, depth,
              top_depth};
}

// brick_trace_lod's arguments: a ray count, a brick tree's depths (its
// bricks three levels deep) and its top rows.
bool brick_lod_ok(int n, const Tree& tree, const Lod& lod) {
  return n >= 0 && tree.top_depth >= 1 && tree.depth == tree.top_depth + 3 &&
         tree.depth <= S_MAX - 1 && lod.n_top >= 1;
}

// One launch of brick_trace_lod's first form in blocks of WIDE_BLOCK
// (probe: with the counters).
int launch_brick_lod_first(const Tree& tree, const Rays& rays, const Out& out,
                           const Lod& lod, void* probe, void* stream) {
  if (!brick_lod_ok(rays.n, tree, lod)) return (int)cudaErrorInvalidValue;
  if (rays.n > 0) {
    const int blocks = blocks_for(rays.n, WIDE_BLOCK);
    const cudaStream_t s = (cudaStream_t)stream;
    if (probe) {
      brick_trace_lod_probe_kernel<<<blocks, WIDE_BLOCK, 0, s>>>(
          tree, rays, out, lod, (long long*)probe);
    } else {
      brick_trace_lod_kernel<<<blocks, WIDE_BLOCK, 0, s>>>(tree, rays, out, lod);
    }
  }
  return (int)cudaGetLastError();
}

// One launch of brick_trace_lod's patched form in blocks of `block`
// threads, block * ROW_WORDS words of dynamic shared memory (probe: with
// the counters).
int launch_brick_lod_patched(const Tree& tree, const Rays& rays, int width,
                             int block, const Out& out, const Lod& lod,
                             void* probe, void* stream) {
  if (!brick_lod_ok(rays.n, tree, lod) ||
      !patched_ok(rays.n, tree.depth, width, block))
    return (int)cudaErrorInvalidValue;
  const long long threads = patch_threads(rays.n, width);
  if (threads > 0) {
    const int blocks = (int)((threads + block - 1) / block);
    const size_t bytes = (size_t)block * ROW_WORDS * sizeof(int);
    const cudaStream_t s = (cudaStream_t)stream;
    long long* p = (long long*)probe;
    if (p) {
      brick_trace_lod_patched_kernel<true><<<blocks, block, bytes, s>>>(
          tree, rays, width, out, lod, p);
    } else {
      brick_trace_lod_patched_kernel<false><<<blocks, block, bytes, s>>>(
          tree, rays, width, out, lod, p);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The patched form, the main path's: the node row table `rows` ((n_nodes,
// 4) int32: masks, child_base, parent_ptr, leaf_base), rays in the patch
// order of an image `width` columns wide (0: their own order), blocks of
// `block` threads.
extern "C" int esvo_stackless(const void* rows, const void* origin,
                              const void* direction, int n, int depth,
                              int width, int block, void* hit_leaf,
                              void* hit_t, void* hit_parent, void* hit_child,
                              void* iters, void* stats, void* stream) {
  return launch_stackless_patched<false>(
      rows, Tree{nullptr, nullptr, nullptr, nullptr, nullptr, depth, 0}, origin,
      direction, n, width, block,
      outputs(hit_leaf, hit_t, hit_parent, hit_child, iters, stats), Lod{},
      nullptr, stream);
}

// The first form: one thread a ray in blocks of 128, the three arrays read
// as the step needs them.
extern "C" int esvo_stackless_serial(const void* masks, const void* child_base,
                                     const void* parent_ptr,
                                     const void* leaf_base, const void* origin,
                                     const void* direction, int n, int depth,
                                     void* hit_leaf, void* hit_t,
                                     void* hit_parent, void* hit_child,
                                     void* iters, void* stats, void* stream) {
  return launch_stackless(masks, child_base, parent_ptr, leaf_base, origin,
                          direction, n, depth,
                          outputs(hit_leaf, hit_t, hit_parent, hit_child, iters, stats),
                          nullptr, stream);
}

// `form` (FORM_FIRST: the arrays, width 0; FORM_PATCHED: the row table,
// width and block) with the counters: `probe` holds PROBE_WORDS int64 words
// for each warp of the launch.
extern "C" int esvo_stackless_probe(int form, const void* rows,
                                    const void* masks, const void* child_base,
                                    const void* parent_ptr,
                                    const void* leaf_base, const void* origin,
                                    const void* direction, int n, int depth,
                                    int width, int block, void* hit_leaf,
                                    void* hit_t, void* hit_parent,
                                    void* hit_child, void* iters, void* stats,
                                    void* probe, void* stream) {
  const Out out = outputs(hit_leaf, hit_t, hit_parent, hit_child, iters, stats);
  if (probe == nullptr) return (int)cudaErrorInvalidValue;
  if (form == FORM_FIRST && width == 0)
    return launch_stackless(masks, child_base, parent_ptr, leaf_base, origin,
                            direction, n, depth, out, probe, stream);
  if (form == FORM_PATCHED)
    return launch_stackless_patched<false>(
        rows, Tree{nullptr, nullptr, nullptr, nullptr, nullptr, depth, 0},
        origin, direction, n, width, block, out, Lod{}, probe, stream);
  return (int)cudaErrorInvalidValue;
}

// The wide form, the main path's.
extern "C" int brick_trace(const void* top_masks, const void* top_child,
                           const void* top_parent, const void* bricks,
                           const void* origin, const void* direction, int n,
                           int depth, int top_depth, void* hit_leaf,
                           void* hit_t, void* hit_parent, void* hit_child,
                           void* iters, void* stats, void* stream) {
  return launch_brick(FORM_WIDE, top_masks, top_child, top_parent, bricks,
                      origin, direction, n, depth, top_depth,
                      outputs(hit_leaf, hit_t, hit_parent, hit_child, iters, stats),
                      nullptr, stream);
}

// The first form.
extern "C" int brick_trace_serial(const void* top_masks, const void* top_child,
                                  const void* top_parent, const void* bricks,
                                  const void* origin, const void* direction,
                                  int n, int depth, int top_depth,
                                  void* hit_leaf, void* hit_t, void* hit_parent,
                                  void* hit_child, void* iters, void* stats,
                                  void* stream) {
  return launch_brick(FORM_FIRST, top_masks, top_child, top_parent, bricks,
                      origin, direction, n, depth, top_depth,
                      outputs(hit_leaf, hit_t, hit_parent, hit_child, iters, stats),
                      nullptr, stream);
}

// The wide form without the staged row.
extern "C" int brick_trace_unstaged(const void* top_masks, const void* top_child,
                                    const void* top_parent, const void* bricks,
                                    const void* origin, const void* direction,
                                    int n, int depth, int top_depth,
                                    void* hit_leaf, void* hit_t, void* hit_parent,
                                    void* hit_child, void* iters, void* stats,
                                    void* stream) {
  return launch_brick(FORM_UNSTAGED, top_masks, top_child, top_parent, bricks, origin,
                      direction, n, depth, top_depth,
                      outputs(hit_leaf, hit_t, hit_parent, hit_child, iters, stats),
                      nullptr, stream);
}

// A form with the counters.
extern "C" int brick_trace_probe(int form, const void* top_masks,
                                 const void* top_child, const void* top_parent,
                                 const void* bricks, const void* origin,
                                 const void* direction, int n, int depth,
                                 int top_depth, void* hit_leaf, void* hit_t,
                                 void* hit_parent, void* hit_child, void* iters,
                                 void* stats, void* probe, void* stream) {
  if (probe == nullptr) return (int)cudaErrorInvalidValue;
  return launch_brick(form, top_masks, top_child, top_parent, bricks, origin,
                      direction, n, depth, top_depth,
                      outputs(hit_leaf, hit_t, hit_parent, hit_child, iters, stats),
                      probe, stream);
}

// esvo_stackless's patched form with the footprint stop coef, bias:
// hit_node (n,) beside its outputs. The rays in the patch order of an image
// `width` columns wide (0: their own order), blocks of `block` threads; the
// walk reads the four arrays, as the first form's does.
extern "C" int esvo_stackless_lod(const void* masks, const void* child_base,
                                  const void* parent_ptr, const void* leaf_base,
                                  const void* origin, const void* direction,
                                  int n, int depth, int width, int block,
                                  float coef, float bias, void* hit_leaf,
                                  void* hit_t, void* hit_parent,
                                  void* hit_child, void* iters, void* hit_node,
                                  void* stats, void* stream) {
  const Tree tree{(const int*)masks, (const int*)child_base,
                  (const int*)parent_ptr, (const int*)leaf_base, nullptr, depth, 0};
  return launch_stackless_patched<true>(
      nullptr, tree, origin, direction, n, width, block,
      outputs(hit_leaf, hit_t, hit_parent, hit_child, iters, stats),
      Lod{coef, bias, 0, (int*)hit_node}, nullptr, stream);
}

// The first form with the footprint stop.
extern "C" int esvo_stackless_lod_serial(
    const void* masks, const void* child_base, const void* parent_ptr,
    const void* leaf_base, const void* origin, const void* direction, int n,
    int depth, float coef, float bias, void* hit_leaf, void* hit_t,
    void* hit_parent, void* hit_child, void* iters, void* hit_node,
    void* stats, void* stream) {
  if (n < 0 || depth < 1 || depth > S_MAX - 1) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const Tree tree{(const int*)masks, (const int*)child_base,
                    (const int*)parent_ptr, (const int*)leaf_base, nullptr,
                    depth, 0};
    const Rays rays{(const float*)origin, (const float*)direction, n};
    esvo_stackless_lod_kernel<<<blocks_for(n, BLOCK), BLOCK, 0,
                                (cudaStream_t)stream>>>(
        tree, rays, outputs(hit_leaf, hit_t, hit_parent, hit_child, iters, stats),
        Lod{coef, bias, 0, (int*)hit_node});
  }
  return (int)cudaGetLastError();
}

// brick_trace_lod's patched form, the main path's: brick_trace's wide form
// with the footprint stop coef, bias, the rays in the patch order of an
// image `width` columns wide (0: their own order), blocks of `block`
// threads; hit_node (n,) beside its outputs, in the source SVO's rows
// (n_top: the top tree's rows).
extern "C" int brick_trace_lod(const void* top_masks, const void* top_child,
                               const void* top_parent, const void* bricks,
                               const void* origin, const void* direction,
                               int n, int depth, int top_depth, int n_top,
                               int width, int block, float coef, float bias,
                               void* hit_leaf, void* hit_t, void* hit_parent,
                               void* hit_child, void* iters, void* hit_node,
                               void* stats, void* stream) {
  return launch_brick_lod_patched(
      brick_tree(top_masks, top_child, top_parent, bricks, depth, top_depth),
      Rays{(const float*)origin, (const float*)direction, n}, width, block,
      outputs(hit_leaf, hit_t, hit_parent, hit_child, iters, stats),
      Lod{coef, bias, n_top, (int*)hit_node}, nullptr, stream);
}

// The first form: brick_trace's wide form with the footprint stop, one
// thread a ray in blocks of WIDE_BLOCK, the rays in their own order.
extern "C" int brick_trace_lod_serial(const void* top_masks, const void* top_child,
                                      const void* top_parent, const void* bricks,
                                      const void* origin, const void* direction,
                                      int n, int depth, int top_depth, int n_top,
                                      float coef, float bias, void* hit_leaf,
                                      void* hit_t, void* hit_parent,
                                      void* hit_child, void* iters,
                                      void* hit_node, void* stats, void* stream) {
  return launch_brick_lod_first(
      brick_tree(top_masks, top_child, top_parent, bricks, depth, top_depth),
      Rays{(const float*)origin, (const float*)direction, n},
      outputs(hit_leaf, hit_t, hit_parent, hit_child, iters, stats),
      Lod{coef, bias, n_top, (int*)hit_node}, nullptr, stream);
}

// `form` (FORM_FIRST, width 0 and block WIDE_BLOCK, or FORM_PATCHED) with
// the counters: `probe` holds PROBE_WORDS int64 words for each warp of the
// launch.
extern "C" int brick_trace_lod_probe(int form, const void* top_masks,
                                     const void* top_child,
                                     const void* top_parent, const void* bricks,
                                     const void* origin, const void* direction,
                                     int n, int depth, int top_depth, int n_top,
                                     int width, int block, float coef,
                                     float bias, void* hit_leaf, void* hit_t,
                                     void* hit_parent, void* hit_child,
                                     void* iters, void* hit_node, void* stats,
                                     void* probe, void* stream) {
  if (probe == nullptr) return (int)cudaErrorInvalidValue;
  const Tree tree = brick_tree(top_masks, top_child, top_parent, bricks, depth,
                               top_depth);
  const Rays rays{(const float*)origin, (const float*)direction, n};
  const Out out = outputs(hit_leaf, hit_t, hit_parent, hit_child, iters, stats);
  const Lod lod{coef, bias, n_top, (int*)hit_node};
  if (form == FORM_FIRST && width == 0 && block == WIDE_BLOCK)
    return launch_brick_lod_first(tree, rays, out, lod, probe, stream);
  if (form == FORM_PATCHED)
    return launch_brick_lod_patched(tree, rays, width, block, out, lod, probe,
                                    stream);
  return (int)cudaErrorInvalidValue;
}

// The first k leaf segments of each ray, the stackless walk over the full
// tree: (n, k) hit_leaf, t_in, t_out, (n,) count and iters, stats (n, 5) or
// null. The patched form, the main path's: the node row table, the rays in
// the patch order of an image `width` columns wide (0: their own order),
// blocks of `block` threads.
extern "C" int esvo_stackless_multi(const void* rows, const void* origin,
                                    const void* direction, int n, int depth,
                                    int width, int block, int k,
                                    void* hit_leaf, void* t_in, void* t_out,
                                    void* count, void* iters, void* stats,
                                    void* stream) {
  return launch_stackless_multi_patched(
      rows, origin, direction, n, depth, width, block,
      multi_outputs(hit_leaf, t_in, t_out, count, iters, stats, k), nullptr,
      stream);
}

// The first form: one thread a ray in blocks of 128 writing each segment as
// it is found (a staged form measured no faster, PERF.md).
extern "C" int esvo_stackless_multi_serial(
    const void* masks, const void* child_base, const void* parent_ptr,
    const void* leaf_base, const void* origin, const void* direction, int n,
    int depth, int k, void* hit_leaf, void* t_in, void* t_out, void* count,
    void* iters, void* stats, void* stream) {
  return launch_stackless_multi(
      masks, child_base, parent_ptr, leaf_base, origin, direction, n, depth,
      multi_outputs(hit_leaf, t_in, t_out, count, iters, stats, k), nullptr,
      stream);
}

// `form` (FORM_FIRST, width 0, or FORM_PATCHED) with the counters.
extern "C" int esvo_stackless_multi_probe(
    int form, const void* rows, const void* masks, const void* child_base,
    const void* parent_ptr, const void* leaf_base, const void* origin,
    const void* direction, int n, int depth, int width, int block, int k,
    void* hit_leaf, void* t_in, void* t_out, void* count, void* iters,
    void* stats, void* probe, void* stream) {
  const MultiOut out = multi_outputs(hit_leaf, t_in, t_out, count, iters, stats, k);
  if (probe == nullptr) return (int)cudaErrorInvalidValue;
  if (form == FORM_FIRST && width == 0)
    return launch_stackless_multi(masks, child_base, parent_ptr, leaf_base,
                                  origin, direction, n, depth, out, probe,
                                  stream);
  if (form == FORM_PATCHED)
    return launch_stackless_multi_patched(rows, origin, direction, n, depth,
                                          width, block, out, probe, stream);
  return (int)cudaErrorInvalidValue;
}

// The first k leaf segments of each ray through the top tree and its
// bricks. The staged form, the main path's, in blocks of MULTI_BLOCK threads;
// a k whose 32 rays' slots pass SMEM_MAX (k > 594) is refused.
extern "C" int brick_trace_multi(const void* top_masks, const void* top_child,
                                 const void* top_parent, const void* bricks,
                                 const void* origin, const void* direction,
                                 int n, int depth, int top_depth, int k,
                                 void* hit_leaf, void* t_in, void* t_out,
                                 void* count, void* iters, void* stats,
                                 void* stream) {
  return launch_brick_multi(
      FORM_STAGED, top_masks, top_child, top_parent, bricks, origin, direction,
      n, depth, top_depth,
      multi_outputs(hit_leaf, t_in, t_out, count, iters, stats, k), nullptr,
      stream);
}

// The first form: the same results, one thread a ray in blocks of 128.
extern "C" int brick_trace_multi_serial(
    const void* top_masks, const void* top_child, const void* top_parent,
    const void* bricks, const void* origin, const void* direction, int n,
    int depth, int top_depth, int k, void* hit_leaf, void* t_in, void* t_out,
    void* count, void* iters, void* stats, void* stream) {
  return launch_brick_multi(
      FORM_FIRST, top_masks, top_child, top_parent, bricks, origin, direction,
      n, depth, top_depth,
      multi_outputs(hit_leaf, t_in, t_out, count, iters, stats, k), nullptr,
      stream);
}

// A form with the counters.
extern "C" int brick_trace_multi_probe(
    int form, const void* top_masks, const void* top_child,
    const void* top_parent, const void* bricks, const void* origin,
    const void* direction, int n, int depth, int top_depth, int k,
    void* hit_leaf, void* t_in, void* t_out, void* count, void* iters,
    void* stats, void* probe, void* stream) {
  if (probe == nullptr) return (int)cudaErrorInvalidValue;
  return launch_brick_multi(
      form, top_masks, top_child, top_parent, bricks, origin, direction, n,
      depth, top_depth,
      multi_outputs(hit_leaf, t_in, t_out, count, iters, stats, k), probe,
      stream);
}

// The stitched trace of the streamed world (see clipmap_trace_kernel): the
// trunk (masks, child_base, parent_ptr, leaf_base; trunk_depth), the chunk
// tables (roots, origins (C, 3), sizes), the trunk's world corner and size,
// the node arena (masks, child_base, parent_ptr, leaf_base; chunk_depth)
// and n_max rounds; (n,) hit_leaf, hit_t, hit_chunk and truncated (bytes).
// `form`: FORM_WIDE (clipmap_trace_wide_kernel) or FORM_FIRST
// (clipmap_trace_kernel<false>); with `probe` (CN_PHASES' record, 6 + 3
// CN_PHASES int64 words a warp of the form's blocks) the form's probe
// kernel.
static int clipmap_node_launch(int form, const void* trunk_masks,
                               const void* trunk_child, const void* trunk_parent,
                               const void* trunk_leaf, const void* roots,
                               const void* origins, const void* sizes, float org_x,
                               float org_y, float org_z, float size,
                               const void* masks, const void* child_base,
                               const void* parent_ptr, const void* leaf_base,
                               const void* origin, const void* direction, int n,
                               int trunk_depth, int chunk_depth, int n_max,
                               void* hit_leaf, void* hit_t, void* hit_chunk,
                               void* truncated, void* probe, void* stream) {
  if (n < 0 || trunk_depth < 1 || trunk_depth > S_MAX - 1 || chunk_depth < 1 ||
      chunk_depth > S_MAX - 1 || n_max < 0 ||
      (form != FORM_FIRST && form != FORM_WIDE))
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const Tree trunk{(const int*)trunk_masks, (const int*)trunk_child,
                     (const int*)trunk_parent, (const int*)trunk_leaf, nullptr,
                     trunk_depth, 0};
    const Tree chunks{(const int*)masks, (const int*)child_base,
                      (const int*)parent_ptr, (const int*)leaf_base, nullptr,
                      chunk_depth, 0};
    const Clip clip{(const int*)roots, (const float*)origins, (const float*)sizes,
                    {org_x, org_y, org_z}, size, n_max};
    const Rays rays{(const float*)origin, (const float*)direction, n};
    const ClipOut out{(int*)hit_leaf, (float*)hit_t, (int*)hit_chunk,
                      (unsigned char*)truncated};
    const cudaStream_t st = (cudaStream_t)stream;
    long long* rec = (long long*)probe;
    if (form == FORM_WIDE && rec != nullptr)
      clipmap_trace_probe_kernel<true><<<blocks_for(n, CLIP_BLOCK), CLIP_BLOCK, 0, st>>>(
          trunk, chunks, clip, rays, out, rec);
    else if (form == FORM_WIDE)
      clipmap_trace_wide_kernel<<<blocks_for(n, CLIP_BLOCK), CLIP_BLOCK, 0, st>>>(
          trunk, chunks, clip, rays, out);
    else if (rec != nullptr)
      clipmap_trace_probe_kernel<false><<<blocks_for(n, BLOCK), BLOCK, 0, st>>>(
          trunk, chunks, clip, rays, out, rec);
    else
      clipmap_trace_kernel<false><<<blocks_for(n, BLOCK), BLOCK, 0, st>>>(
          trunk, chunks, clip, rays, out);
  }
  return (int)cudaGetLastError();
}

// The main path's form: the wide form in blocks of CLIP_BLOCK.
extern "C" int clipmap_trace(const void* trunk_masks, const void* trunk_child,
                             const void* trunk_parent, const void* trunk_leaf,
                             const void* roots, const void* origins,
                             const void* sizes, float org_x, float org_y,
                             float org_z, float size, const void* masks,
                             const void* child_base, const void* parent_ptr,
                             const void* leaf_base, const void* origin,
                             const void* direction, int n, int trunk_depth,
                             int chunk_depth, int n_max, void* hit_leaf,
                             void* hit_t, void* hit_chunk, void* truncated,
                             void* stream) {
  return clipmap_node_launch(FORM_WIDE, trunk_masks, trunk_child,
                             trunk_parent, trunk_leaf, roots, origins, sizes, org_x,
                             org_y, org_z, size, masks, child_base, parent_ptr,
                             leaf_base, origin, direction, n, trunk_depth,
                             chunk_depth, n_max, hit_leaf, hit_t, hit_chunk,
                             truncated, nullptr, stream);
}

// clipmap_trace's first form, the check and the yardstick.
extern "C" int clipmap_trace_serial(const void* trunk_masks, const void* trunk_child,
                                    const void* trunk_parent, const void* trunk_leaf,
                                    const void* roots, const void* origins,
                                    const void* sizes, float org_x, float org_y,
                                    float org_z, float size, const void* masks,
                                    const void* child_base, const void* parent_ptr,
                                    const void* leaf_base, const void* origin,
                                    const void* direction, int n, int trunk_depth,
                                    int chunk_depth, int n_max, void* hit_leaf,
                                    void* hit_t, void* hit_chunk, void* truncated,
                                    void* stream) {
  return clipmap_node_launch(FORM_FIRST, trunk_masks, trunk_child,
                             trunk_parent, trunk_leaf, roots, origins, sizes, org_x,
                             org_y, org_z, size, masks, child_base, parent_ptr,
                             leaf_base, origin, direction, n, trunk_depth,
                             chunk_depth, n_max, hit_leaf, hit_t, hit_chunk,
                             truncated, nullptr, stream);
}

// Either form (FORM_FIRST, FORM_WIDE) with the counters at `probe`.
extern "C" int clipmap_trace_probe(
    int form, const void* trunk_masks, const void* trunk_child,
    const void* trunk_parent, const void* trunk_leaf, const void* roots,
    const void* origins, const void* sizes, float org_x, float org_y, float org_z,
    float size, const void* masks, const void* child_base, const void* parent_ptr,
    const void* leaf_base, const void* origin, const void* direction, int n,
    int trunk_depth, int chunk_depth, int n_max, void* hit_leaf, void* hit_t,
    void* hit_chunk, void* truncated, void* probe, void* stream) {
  if (probe == nullptr) return (int)cudaErrorInvalidValue;
  return clipmap_node_launch(form, trunk_masks, trunk_child, trunk_parent,
                             trunk_leaf, roots, origins, sizes, org_x, org_y, org_z,
                             size, masks, child_base, parent_ptr, leaf_base, origin,
                             direction, n, trunk_depth, chunk_depth, n_max, hit_leaf,
                             hit_t, hit_chunk, truncated, probe, stream);
}

// The same with the chunk's walk through the brick arena (top_masks,
// top_child, top_parent, bricks; chunk_depth, top depth chunk_depth - 3), in
// `form`: FORM_WIDE (clipmap_trace_brick_kernel, the main path's) or
// FORM_FIRST (clipmap_trace_kernel<true>); with `probe` (CP_PHASES' record,
// 6 + 3 CP_PHASES int64 words a warp of the form's blocks) the form's probe
// kernel.
static int clipmap_brick_launch(int form, const void* trunk_masks,
                         const void* trunk_child, const void* trunk_parent,
                         const void* trunk_leaf, const void* roots,
                         const void* origins, const void* sizes, float org_x,
                         float org_y, float org_z, float size,
                         const void* top_masks, const void* top_child,
                         const void* top_parent, const void* bricks,
                         const void* origin, const void* direction, int n,
                         int trunk_depth, int chunk_depth, int n_max,
                         void* hit_leaf, void* hit_t, void* hit_chunk,
                         void* truncated, void* probe, void* stream) {
  if (n < 0 || trunk_depth < 1 || trunk_depth > S_MAX - 1 || chunk_depth < 4 ||
      chunk_depth > S_MAX - 1 || n_max < 0 ||
      (form != FORM_FIRST && form != FORM_WIDE))
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const Tree trunk{(const int*)trunk_masks, (const int*)trunk_child,
                     (const int*)trunk_parent, (const int*)trunk_leaf, nullptr,
                     trunk_depth, 0};
    const Tree chunks{(const int*)top_masks, (const int*)top_child,
                      (const int*)top_parent, nullptr, (const int*)bricks,
                      chunk_depth, chunk_depth - 3};
    const Clip clip{(const int*)roots, (const float*)origins, (const float*)sizes,
                    {org_x, org_y, org_z}, size, n_max};
    const Rays rays{(const float*)origin, (const float*)direction, n};
    const ClipOut out{(int*)hit_leaf, (float*)hit_t, (int*)hit_chunk,
                      (unsigned char*)truncated};
    const cudaStream_t st = (cudaStream_t)stream;
    long long* rec = (long long*)probe;
    if (form == FORM_WIDE && rec == nullptr)
      clipmap_trace_brick_kernel<<<blocks_for(n, WIDE_BLOCK), WIDE_BLOCK, 0, st>>>(
          trunk, chunks, clip, rays, out);
    else if (form == FORM_WIDE)
      clipmap_trace_brick_probe_kernel<true><<<blocks_for(n, WIDE_BLOCK), WIDE_BLOCK, 0,
                                         st>>>(trunk, chunks, clip, rays, out, rec);
    else if (rec == nullptr)
      clipmap_trace_kernel<true><<<blocks_for(n, BLOCK), BLOCK, 0, st>>>(
          trunk, chunks, clip, rays, out);
    else
      clipmap_trace_brick_probe_kernel<false><<<blocks_for(n, BLOCK), BLOCK, 0, st>>>(
          trunk, chunks, clip, rays, out, rec);
  }
  return (int)cudaGetLastError();
}

extern "C" int clipmap_trace_brick(
    const void* trunk_masks, const void* trunk_child, const void* trunk_parent,
    const void* trunk_leaf, const void* roots, const void* origins,
    const void* sizes, float org_x, float org_y, float org_z, float size,
    const void* top_masks, const void* top_child, const void* top_parent,
    const void* bricks, const void* origin, const void* direction, int n,
    int trunk_depth, int chunk_depth, int n_max, void* hit_leaf, void* hit_t,
    void* hit_chunk, void* truncated, void* stream) {
  return clipmap_brick_launch(FORM_WIDE, trunk_masks, trunk_child, trunk_parent, trunk_leaf,
                              roots, origins, sizes, org_x, org_y, org_z, size,
                              top_masks, top_child, top_parent, bricks, origin,
                              direction, n, trunk_depth, chunk_depth, n_max,
                              hit_leaf, hit_t, hit_chunk, truncated, nullptr, stream);
}

// clipmap_trace_brick's first form, the check and the yardstick.
extern "C" int clipmap_trace_brick_serial(
    const void* trunk_masks, const void* trunk_child, const void* trunk_parent,
    const void* trunk_leaf, const void* roots, const void* origins,
    const void* sizes, float org_x, float org_y, float org_z, float size,
    const void* top_masks, const void* top_child, const void* top_parent,
    const void* bricks, const void* origin, const void* direction, int n,
    int trunk_depth, int chunk_depth, int n_max, void* hit_leaf, void* hit_t,
    void* hit_chunk, void* truncated, void* stream) {
  return clipmap_brick_launch(FORM_FIRST, trunk_masks, trunk_child, trunk_parent, trunk_leaf,
                              roots, origins, sizes, org_x, org_y, org_z, size,
                              top_masks, top_child, top_parent, bricks, origin,
                              direction, n, trunk_depth, chunk_depth, n_max,
                              hit_leaf, hit_t, hit_chunk, truncated, nullptr, stream);
}

// Either form (FORM_FIRST, FORM_WIDE) with the counters at `probe`.
extern "C" int clipmap_trace_brick_probe(
    int form, const void* trunk_masks, const void* trunk_child, const void* trunk_parent,
    const void* trunk_leaf, const void* roots, const void* origins,
    const void* sizes, float org_x, float org_y, float org_z, float size,
    const void* top_masks, const void* top_child, const void* top_parent,
    const void* bricks, const void* origin, const void* direction, int n,
    int trunk_depth, int chunk_depth, int n_max, void* hit_leaf, void* hit_t,
    void* hit_chunk, void* truncated, void* probe, void* stream) {
  if (probe == nullptr) return (int)cudaErrorInvalidValue;
  return clipmap_brick_launch(form, trunk_masks, trunk_child, trunk_parent, trunk_leaf,
                              roots, origins, sizes, org_x, org_y, org_z, size,
                              top_masks, top_child, top_parent, bricks, origin,
                              direction, n, trunk_depth, chunk_depth, n_max,
                              hit_leaf, hit_t, hit_chunk, truncated, probe, stream);
}

// One round of the level-sharded traces (see level_round_kernel), `mode`
// LEVEL_SHARDED, LEVEL_TRUNK or LEVEL_PACKETS: the trunk (masks, child_base,
// parent_ptr, leaf_base; trunk_depth), this rank's arena (the same four;
// sub_depth), the octant tables (owner, root, origin (C, 3)), the octants'
// size and this rank; n rays (origin, direction (n, 3), t_off (n,), done
// (n,) bytes) or, in LEVEL_PACKETS, n packets at `origin` (n, 8); outputs
// (n,) oct_id, hit, leaf, t_hit, t_next (LEVEL_TRUNK: oct_id and t_next,
// the rest may be null) or, in LEVEL_PACKETS, the (n, 2) replies at `leaf`.
namespace {

// The three launches of level_round's first form, probe form and queued
// form share their arguments: the trees, the octant tables, the rays (or
// packets) and the outputs.
struct LevelArgs {
  Tree trunk, arena;
  Octants oc;
  LevelIO io;
};

bool level_args(int mode, const void* trunk_masks, const void* trunk_child,
                const void* trunk_parent, const void* trunk_leaf,
                int trunk_depth, const void* masks, const void* child_base,
                const void* parent_ptr, const void* leaf_base, int sub_depth,
                const void* oct_owner, const void* oct_root,
                const void* oct_origin, float size, int rank,
                const void* origin, const void* direction, const void* t_off,
                const void* done, int n, void* oct_id, void* hit, void* leaf,
                void* t_hit, void* t_next, LevelArgs& a) {
  if (n < 0 || mode < LEVEL_SHARDED || mode > LEVEL_PACKETS || trunk_depth < 1 ||
      trunk_depth > S_MAX - 1 || sub_depth < 1 || sub_depth > S_MAX - 1)
    return false;
  a.trunk = Tree{(const int*)trunk_masks, (const int*)trunk_child,
                 (const int*)trunk_parent, (const int*)trunk_leaf, nullptr,
                 trunk_depth, 0};
  a.arena = Tree{(const int*)masks, (const int*)child_base,
                 (const int*)parent_ptr, (const int*)leaf_base, nullptr,
                 sub_depth, 0};
  a.oc = Octants{(const int*)oct_owner, (const int*)oct_root,
                 (const float*)oct_origin, size, rank};
  a.io = LevelIO{(const float*)origin, (const float*)direction,
                 (const float*)t_off, (const unsigned char*)done, n,
                 (int*)oct_id, (int*)hit, (int*)leaf, (float*)t_hit,
                 (float*)t_next};
  return true;
}

}  // namespace

// The queued form (the main path's): `queue` and `n_live` are the live
// rays and their count ("sharded", "trunk"; both null in a first round,
// where no ray is done), or `queue` the n_seg segments' valid counts
// ("packets", segments of `seg` slots), as level_queue left them; `grid_n`
// threads, a bound on the live count the caller holds.
extern "C" int level_round(int mode, const void* trunk_masks,
                           const void* trunk_child, const void* trunk_parent,
                           const void* trunk_leaf, int trunk_depth,
                           const void* masks, const void* child_base,
                           const void* parent_ptr, const void* leaf_base,
                           int sub_depth, const void* oct_owner,
                           const void* oct_root, const void* oct_origin,
                           float size, int rank, const void* origin,
                           const void* direction, const void* t_off,
                           const void* done, int n, void* oct_id, void* hit,
                           void* leaf, void* t_hit, void* t_next,
                           const void* queue, const void* n_live, int n_seg,
                           int seg, int grid_n, void* stream) {
  LevelArgs a;
  if (!level_args(mode, trunk_masks, trunk_child, trunk_parent, trunk_leaf,
                  trunk_depth, masks, child_base, parent_ptr, leaf_base,
                  sub_depth, oct_owner, oct_root, oct_origin, size, rank,
                  origin, direction, t_off, done, n, oct_id, hit, leaf, t_hit,
                  t_next, a) ||
      grid_n < 0 || n_seg < 0 || seg < 0)
    return (int)cudaErrorInvalidValue;
  if (grid_n > 0) {
    const LevelQueue q{(const int*)queue, (const int*)n_live, n_seg, seg};
    const int blocks = blocks_for(grid_n, BLOCK);
    cudaStream_t st = (cudaStream_t)stream;
    if (mode == LEVEL_SHARDED)
      level_round_queued_kernel<LEVEL_SHARDED><<<blocks, BLOCK, 0, st>>>(
          a.trunk, a.arena, a.oc, a.io, q);
    else if (mode == LEVEL_TRUNK)
      level_round_queued_kernel<LEVEL_TRUNK><<<blocks, BLOCK, 0, st>>>(
          a.trunk, a.arena, a.oc, a.io, q);
    else
      level_round_queued_kernel<LEVEL_PACKETS><<<blocks, BLOCK, 0, st>>>(
          a.trunk, a.arena, a.oc, a.io, q);
  }
  return (int)cudaGetLastError();
}

// The first form, and with `probe` (PROBE_WORDS int64 words a warp of
// blocks of BLOCK threads) its probe form.
static int level_round_first(int mode, const void* trunk_masks,
                             const void* trunk_child, const void* trunk_parent,
                             const void* trunk_leaf, int trunk_depth,
                             const void* masks, const void* child_base,
                             const void* parent_ptr, const void* leaf_base,
                             int sub_depth, const void* oct_owner,
                             const void* oct_root, const void* oct_origin,
                             float size, int rank, const void* origin,
                             const void* direction, const void* t_off,
                             const void* done, int n, void* oct_id, void* hit,
                             void* leaf, void* t_hit, void* t_next,
                             void* probe, void* stream) {
  LevelArgs a;
  if (!level_args(mode, trunk_masks, trunk_child, trunk_parent, trunk_leaf,
                  trunk_depth, masks, child_base, parent_ptr, leaf_base,
                  sub_depth, oct_owner, oct_root, oct_origin, size, rank,
                  origin, direction, t_off, done, n, oct_id, hit, leaf, t_hit,
                  t_next, a))
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int blocks = blocks_for(n, BLOCK);
    cudaStream_t st = (cudaStream_t)stream;
    long long* p = (long long*)probe;
    if (p && mode == LEVEL_SHARDED)
      level_round_probe_kernel<LEVEL_SHARDED><<<blocks, BLOCK, 0, st>>>(
          a.trunk, a.arena, a.oc, a.io, p);
    else if (p && mode == LEVEL_TRUNK)
      level_round_probe_kernel<LEVEL_TRUNK><<<blocks, BLOCK, 0, st>>>(
          a.trunk, a.arena, a.oc, a.io, p);
    else if (p)
      level_round_probe_kernel<LEVEL_PACKETS><<<blocks, BLOCK, 0, st>>>(
          a.trunk, a.arena, a.oc, a.io, p);
    else if (mode == LEVEL_SHARDED)
      level_round_kernel<LEVEL_SHARDED><<<blocks, BLOCK, 0, st>>>(
          a.trunk, a.arena, a.oc, a.io);
    else if (mode == LEVEL_TRUNK)
      level_round_kernel<LEVEL_TRUNK><<<blocks, BLOCK, 0, st>>>(
          a.trunk, a.arena, a.oc, a.io);
    else
      level_round_kernel<LEVEL_PACKETS><<<blocks, BLOCK, 0, st>>>(
          a.trunk, a.arena, a.oc, a.io);
  }
  return (int)cudaGetLastError();
}

extern "C" int level_round_serial(int mode, const void* trunk_masks,
                                  const void* trunk_child,
                                  const void* trunk_parent,
                                  const void* trunk_leaf, int trunk_depth,
                                  const void* masks, const void* child_base,
                                  const void* parent_ptr, const void* leaf_base,
                                  int sub_depth, const void* oct_owner,
                                  const void* oct_root, const void* oct_origin,
                                  float size, int rank, const void* origin,
                                  const void* direction, const void* t_off,
                                  const void* done, int n, void* oct_id,
                                  void* hit, void* leaf, void* t_hit,
                                  void* t_next, void* stream) {
  return level_round_first(mode, trunk_masks, trunk_child, trunk_parent,
                           trunk_leaf, trunk_depth, masks, child_base,
                           parent_ptr, leaf_base, sub_depth, oct_owner,
                           oct_root, oct_origin, size, rank, origin, direction,
                           t_off, done, n, oct_id, hit, leaf, t_hit, t_next,
                           nullptr, stream);
}

extern "C" int level_round_probe(int mode, const void* trunk_masks,
                                 const void* trunk_child,
                                 const void* trunk_parent,
                                 const void* trunk_leaf, int trunk_depth,
                                 const void* masks, const void* child_base,
                                 const void* parent_ptr, const void* leaf_base,
                                 int sub_depth, const void* oct_owner,
                                 const void* oct_root, const void* oct_origin,
                                 float size, int rank, const void* origin,
                                 const void* direction, const void* t_off,
                                 const void* done, int n, void* oct_id,
                                 void* hit, void* leaf, void* t_hit,
                                 void* t_next, void* probe, void* stream) {
  if (probe == nullptr) return (int)cudaErrorInvalidValue;
  return level_round_first(mode, trunk_masks, trunk_child, trunk_parent,
                           trunk_leaf, trunk_depth, masks, child_base,
                           parent_ptr, leaf_base, sub_depth, oct_owner,
                           oct_root, oct_origin, size, rank, origin, direction,
                           t_off, done, n, oct_id, hit, leaf, t_hit, t_next,
                           probe, stream);
}

// level_round's queue for a round of `mode` over n rays or packets, the
// main path's. "sharded", "trunk": the one pass (level_queue_lookback_
// kernel) over every ray, or with `prev` over a previous round's queue (its
// length `n_prev` on the device, at most `grid_n`; grid_n is n without
// it): `status` the loop's status words (int64: the control word, then
// a word for each of the ceil(n / QTILE) tiles a round may have, zeroed
// once a loop), `queue` (ceil(entries / QTILE) * QTILE ints) the live rays
// in order, `n_live` (one int) their count, and the outputs of the rays
// found done (the first form's pointers: oct_id and t_next, and for
// "sharded" hit, leaf and t_hit). "packets": `leaf` is the (n, 2) replies,
// every one written as an invalid packet's, and `queue` the n_seg = n /
// seg segments' valid counts.
extern "C" int level_queue(int mode, int n, const void* done, const void* t_off,
                           const void* prev, const void* n_prev, int grid_n,
                           const void* packets, int seg, void* status,
                           void* queue, void* n_live, void* oct_id, void* hit,
                           void* leaf, void* t_hit, void* t_next, void* stream) {
  if (n < 0 || grid_n < 0 || mode < LEVEL_SHARDED || mode > LEVEL_PACKETS ||
      (mode == LEVEL_PACKETS && (seg < 1 || n % seg != 0)) ||
      (mode != LEVEL_PACKETS && status == nullptr) ||
      (prev == nullptr) != (n_prev == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0 || grid_n == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == LEVEL_PACKETS) {
    const int n_seg = n / seg, blocks = blocks_for(n, QBLOCK);
    level_queue_packets_kernel<<<blocks > n_seg ? blocks : n_seg, QBLOCK, 0, st>>>(
        (const float*)packets, n, n_seg, seg, (float*)leaf, (int*)queue);
    return (int)cudaGetLastError();
  }
  const int tiles = blocks_for(prev == nullptr ? n : grid_n, QTILE);
  const QueueStatus qs{(unsigned long long*)status, (unsigned long long*)status + 1};
  const LevelIO io{nullptr, nullptr, (const float*)t_off,
                   (const unsigned char*)done, n, (int*)oct_id, (int*)hit,
                   (int*)leaf, (float*)t_hit, (float*)t_next};
  const unsigned char* flags = (const unsigned char*)done;
  const int* entries = (const int*)prev;
  const int* n_entries = (const int*)n_prev;
  if (mode == LEVEL_SHARDED && prev == nullptr)
    level_queue_lookback_kernel<LEVEL_SHARDED, false><<<tiles, QBLOCK, 0, st>>>(
        flags, n, entries, n_entries, qs, (int*)queue, (int*)n_live, io);
  else if (mode == LEVEL_SHARDED)
    level_queue_lookback_kernel<LEVEL_SHARDED, true><<<tiles, QBLOCK, 0, st>>>(
        flags, n, entries, n_entries, qs, (int*)queue, (int*)n_live, io);
  else if (prev == nullptr)
    level_queue_lookback_kernel<LEVEL_TRUNK, false><<<tiles, QBLOCK, 0, st>>>(
        flags, n, entries, n_entries, qs, (int*)queue, (int*)n_live, io);
  else
    level_queue_lookback_kernel<LEVEL_TRUNK, true><<<tiles, QBLOCK, 0, st>>>(
        flags, n, entries, n_entries, qs, (int*)queue, (int*)n_live, io);
  return (int)cudaGetLastError();
}

// level_round's queue's first form ("sharded", "trunk"), over every ray, or
// with `prev` over a previous round's queue (its length `n_prev` on the
// device, at most `grid_n`; grid_n is n without it): with `counts`
// (ceil(grid_n / QBLOCK) ints), the count pass (each block's live rays);
// else the place pass from the counts' exclusive scan `block_base`:
// `queue` and the outputs of the rays found done (as level_queue's).
extern "C" int level_queue_serial(int mode, int n, const void* done,
                                  const void* t_off, const void* prev,
                                  const void* n_prev, int grid_n, void* counts,
                                  const void* block_base, void* queue, void* oct_id,
                                  void* hit, void* leaf, void* t_hit, void* t_next,
                                  void* stream) {
  if (n < 0 || grid_n < 0 || (mode != LEVEL_SHARDED && mode != LEVEL_TRUNK) ||
      (prev == nullptr) != (n_prev == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0 || grid_n == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = blocks_for(prev == nullptr ? n : grid_n, QBLOCK);
  if (counts != nullptr) {
    level_queue_count_kernel<<<blocks, QBLOCK, 0, st>>>(
        (const unsigned char*)done, n, (const int*)prev, (const int*)n_prev,
        (int*)counts);
  } else {
    const LevelIO io{nullptr, nullptr, (const float*)t_off,
                     (const unsigned char*)done, n, (int*)oct_id, (int*)hit,
                     (int*)leaf, (float*)t_hit, (float*)t_next};
    if (mode == LEVEL_SHARDED)
      level_queue_place_kernel<LEVEL_SHARDED><<<blocks, QBLOCK, 0, st>>>(
          (const unsigned char*)done, n, (const int*)prev, (const int*)n_prev,
          (const int*)block_base, (int*)queue, io);
    else
      level_queue_place_kernel<LEVEL_TRUNK><<<blocks, QBLOCK, 0, st>>>(
          (const unsigned char*)done, n, (const int*)prev, (const int*)n_prev,
          (const int*)block_base, (int*)queue, io);
  }
  return (int)cudaGetLastError();
}
