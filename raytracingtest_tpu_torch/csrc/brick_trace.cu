// The per-ray stackless traces for Hopper, sm_90a: two kernels that share
// one stackless step.
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
//
// Semantics follow the plain PyTorch versions bit for bit
// (raytracingtest_tpu_torch/ops/traverse.py::fast_step, trace_stackless;
// ops/brick.py::trace_brick, _dda_round). The stackless step reads one node
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
//
// What bounds them on this card: not bytes (24 B of ray in, 20 B of results
// out a ray, and the node rows and brick rows its steps read: under 100 MB
// for the depth-10 1024^2 frame, 0.03 ms at 3.35 TB/s) and not operations
// (40 a stackless step and 32 a DDA step: some 0.02 ms at 67 TFLOP/s), but
// each ray's chain of dependent steps, each behind a row read whose address
// the previous step computed, and the divergence of a warp's 32 rays, which
// take different branches and different numbers of steps. The design is the
// simple one: one thread a ray (blocks of 128), rows read through the
// read-only path as the step needs them (the node's masks every step, its
// child_base on a PUSH or a park, its parent on a POP; a brick's words as
// the DDA reads them), so the rows of the top of the tree and of the bricks
// that many rays enter stay in L1 and L2. Making it fast is later work.
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
constexpr int ROW_WORDS = 17;        // a brick row: 16 occupancy words + first leaf id
constexpr int DDA_ROUND_STEPS = 30;  // the reference's DDA loop: 26 rounded up to 6s
constexpr int N_STATS = 5;           // rounds, DDA steps, capped rounds, DDA max, unfinished
constexpr int STEP_ON = 0, STEP_LEAF = 1, STEP_EXIT = 2;

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

// Mirroring, root-cube entry and the root's first child; returns whether
// the ray misses the root cube.
__device__ __forceinline__ bool setup(const float* __restrict__ origin,
                                      const float* __restrict__ direction,
                                      int i, Ray& r, Walk& w) {
  const float eps = 1.0f / 8388608.0f;  // 2^-S_MAX
  r.om = 7;
  for (int c = 0; c < 3; ++c) {
    const float oc = origin[(size_t)3 * i + c] + 1.0f;
    float dc = direction[(size_t)3 * i + c];
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
  w.parent = 0;
  w.scale = S_MAX - 1;
  w.t_min = t_min;
  w.popped = false;
  return t_min >= r.t_root;
}

// One stackless step (ops/traverse.py::fast_step). Returns STEP_LEAF when
// the ray enters a leaf child: the walk registers are left at that child
// (child_shift its unmirrored slot, leaf_rank its rank among the parent's
// leaf children); STEP_EXIT when it leaves the
// root cube; otherwise STEP_ON after a PUSH, a move to a sibling or a POP.
__device__ __forceinline__ int stackless_step(
    const Ray& r, Walk& w, const int* __restrict__ masks,
    const int* __restrict__ child, const int* __restrict__ parent_ptr,
    int& child_shift, int& leaf_rank) {
  const int desc = __ldg(masks + w.parent);
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

  if (enter && ((lm >> child_shift) & 1)) {  // a leaf child: hit, or park
    leaf_rank = __popc(vm & lm & below);
    w.popped = false;
    return STEP_LEAF;
  }
  if (enter) {  // PUSH
    const float half = scale_exp2 * 0.5f;
    w.parent = __ldg(child + w.parent) + __popc(vm & ~lm & below);
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
    return STEP_ON;
  }
  if (w.scale + 1 >= S_MAX) {  // left the root cube
    w.popped = false;
    return STEP_EXIT;
  }
  for (int c = 0; c < 3; ++c) w.pos[c] = parent_pos[c];
  w.idx = (psh[0] & 1) | ((psh[1] & 1) << 1) | ((psh[2] & 1) << 2);
  w.parent = __ldg(parent_ptr + w.parent);
  w.scale += 1;
  w.popped = true;
  return STEP_ON;
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

// One thread a ray: the stackless walk over the full tree, at most
// max_iters_for_depth(depth) steps; the leaf row is resolved after the walk.
__global__ void __launch_bounds__(BLOCK)
esvo_stackless_kernel(const int* __restrict__ masks,
                      const int* __restrict__ child_base,
                      const int* __restrict__ parent_ptr,
                      const int* __restrict__ leaf_base,
                      const float* __restrict__ origin,
                      const float* __restrict__ direction, int n, int depth,
                      int* __restrict__ hit_leaf, float* __restrict__ hit_t,
                      int* __restrict__ hit_parent,
                      int* __restrict__ hit_child, int* __restrict__ iters,
                      int* __restrict__ stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray r;
  Walk w;
  bool done = setup(origin, direction, i, r, w);
  const int n_max = max_iters_for_depth(depth);
  int hp = -1, hc = 0, leaf = -1, it = 0;
  float ht = 0.0f;
  while (!done && it < n_max) {
    ++it;
    int child_shift, leaf_rank;
    const int what = stackless_step(r, w, masks, child_base, parent_ptr,
                                    child_shift, leaf_rank);
    if (what == STEP_LEAF) {
      hp = w.parent;
      hc = child_shift;
      ht = w.t_min;
      leaf = __ldg(leaf_base + hp) + leaf_rank;
    }
    done = what != STEP_ON;
  }
  hit_leaf[i] = leaf;
  hit_t[i] = ht;
  hit_parent[i] = hp;
  hit_child[i] = hc;
  iters[i] = it;
  write_stats(stats, i, 0, 0, 0, 0, !done);
}

// One thread a ray: rounds of a stackless walk over the top tree until the
// ray parks at a brick, then the brick's DDA; a DDA that leaves the brick
// sets `popped`, so the next round's walk steps past it.
__global__ void __launch_bounds__(BLOCK)
brick_trace_kernel(const int* __restrict__ top_masks,
                   const int* __restrict__ top_child,
                   const int* __restrict__ top_parent,
                   const int* __restrict__ bricks,
                   const float* __restrict__ origin,
                   const float* __restrict__ direction, int n, int depth,
                   int top_depth, int* __restrict__ hit_leaf,
                   float* __restrict__ hit_t, int* __restrict__ hit_parent,
                   int* __restrict__ hit_child, int* __restrict__ iters,
                   int* __restrict__ stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray r;
  Walk w;
  bool done = setup(origin, direction, i, r, w);
  const int n_top = max_iters_for_depth(top_depth);
  const int n_rounds = 16 * depth + 64;
  const int vshift = S_MAX - depth;
  const float vsize = __int_as_float((127 - depth) << 23);      // 2^-depth
  const float bsize = __int_as_float((127 - top_depth) << 23);  // 2^-top_depth
  int flip[3];
  for (int c = 0; c < 3; ++c) flip[c] = ((r.om >> c) & 1) ? 0 : 7;

  int hp = -1, hc = 0, leaf = -1, it = 0;
  float ht = 0.0f;
  int rounds = 0, dda = 0, capped = 0, dda_max = 0;
  while (!done && rounds < n_rounds) {
    ++rounds;
    // the round's top walk, to a brick or the end of the ray
    int what = STEP_ON, child_shift = 0, leaf_rank = 0;
    for (int top = 0; top < n_top && what == STEP_ON; ++top) {
      ++it;
      what = stackless_step(r, w, top_masks, top_child, top_parent,
                            child_shift, leaf_rank);
    }
    if (what == STEP_EXIT) {
      done = true;
      break;
    }
    if (what == STEP_ON) {  // the round's step cap
      ++capped;
      continue;
    }
    // parked at brick top_child[parent] + leaf_rank: descend to the entry
    // voxel, then step through the brick
    const int* row = bricks + (size_t)(__ldg(top_child + w.parent) + leaf_rank) * ROW_WORDS;
    auto word = [row](int k) { return __ldg(row + k); };
    float bpos[3] = {w.pos[0], w.pos[1], w.pos[2]};
    float t_cur = w.t_min;
    rtt_dda::descend(r.t_coef, r.t_bias, bsize, t_cur, bpos);
    int steps = 0;
    for (; steps < DDA_ROUND_STEPS;) {
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
      if (step != rtt_dda::DDA_STAY) break;
    }
    w.t_min = t_cur;
    it += steps;
    dda += steps;
    dda_max = max(dda_max, steps);
  }
  hit_leaf[i] = leaf;
  hit_t[i] = ht;
  hit_parent[i] = hp;
  hit_child[i] = hc;
  iters[i] = it;
  write_stats(stats, i, rounds, dda, capped, dda_max, !done);
}

int blocks_for(int n) { return (n + BLOCK - 1) / BLOCK; }

}  // namespace

extern "C" int esvo_stackless(const void* masks, const void* child_base,
                              const void* parent_ptr, const void* leaf_base,
                              const void* origin, const void* direction, int n,
                              int depth, void* hit_leaf, void* hit_t,
                              void* hit_parent, void* hit_child, void* iters,
                              void* stats, void* stream) {
  if (n < 0 || depth < 1 || depth > S_MAX - 1) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    esvo_stackless_kernel<<<blocks_for(n), BLOCK, 0, (cudaStream_t)stream>>>(
        (const int*)masks, (const int*)child_base, (const int*)parent_ptr,
        (const int*)leaf_base, (const float*)origin, (const float*)direction,
        n, depth, (int*)hit_leaf, (float*)hit_t, (int*)hit_parent,
        (int*)hit_child, (int*)iters, (int*)stats);
  }
  return (int)cudaGetLastError();
}

extern "C" int brick_trace(const void* top_masks, const void* top_child,
                           const void* top_parent, const void* bricks,
                           const void* origin, const void* direction, int n,
                           int depth, int top_depth, void* hit_leaf,
                           void* hit_t, void* hit_parent, void* hit_child,
                           void* iters, void* stats, void* stream) {
  if (n < 0 || top_depth < 1 || depth != top_depth + 3 || depth > S_MAX - 1)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    brick_trace_kernel<<<blocks_for(n), BLOCK, 0, (cudaStream_t)stream>>>(
        (const int*)top_masks, (const int*)top_child, (const int*)top_parent,
        (const int*)bricks, (const float*)origin, (const float*)direction, n,
        depth, top_depth, (int*)hit_leaf, (float*)hit_t, (int*)hit_parent,
        (int*)hit_child, (int*)iters, (int*)stats);
  }
  return (int)cudaGetLastError();
}
