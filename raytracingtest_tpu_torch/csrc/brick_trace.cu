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
// instruction issue in divergent warps and the chains of a few straggler
// warps. The probe forms measured it on that frame (chip_smoke.py [warps]):
// a warp issues a loop for as long as its slowest lane runs it (SIMT
// efficiency 0.75 in the stackless step, 0.56 in the brick trace's top
// step and 0.35 in its DDA step), and the last fifth of the kernel's span
// runs its last hundredth of warps, warps of grazing rays that start
// mid-launch and run for 100-400 us while the rest of the card idles.
//
// The kernels, one thread a ray each; they compute the same bits:
//   * esvo_stackless: blocks of 128, rows read through the read-only path
//     as the step needs them.
//   * brick_trace_serial, the brick trace's first form: the same, each
//     round a top loop, a three-level descent and a DDA loop.
//   * brick_trace, its wide form (the main path's): the first form's rounds
//     in blocks of 256, and a ray that parks reads its brick row's 17 words
//     as independent loads into its own slice of shared memory, so that
//     each DDA step reads its word there instead of behind a dependent load.
//     brick_trace_unstaged is the wide form without the staged row, which
//     splits the gain between the two changes (chip_smoke.py [timing]).
//   * The probe forms (esvo_stackless_probe, brick_trace_probe) are a form
//     with counters: each warp writes PROBE_WORDS int64 words (the layout
//     at Probe below), the issues of each phase (a step, the descent, a DDA
//     step, a ray's set-up or write), the lanes active at each issue, the
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
constexpr int DDA_ROUND_STEPS = 30;  // the reference's DDA loop: 26 rounded up to 6s
constexpr int N_STATS = 5;           // rounds, DDA steps, capped rounds, DDA max, unfinished
constexpr int STEP_ON = 0, STEP_LEAF = 1, STEP_EXIT = 2;
constexpr int FORM_FIRST = 0, FORM_WIDE = 1, FORM_UNSTAGED = 2;
constexpr int WIDE_BLOCK = 256;  // the wide form's block

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

// ---- the probe -------------------------------------------------------------
// A warp's record, PROBE_WORDS int64 words: its start and end clock64() (the
// SM's own counter, so compare only warps of one block), rays it wrote, then
// for each phase (a top or stackless step, the descent into a brick, a DDA
// step, a ray's set-up or write) its issues, the lanes active summed over
// them, and the cycles inside it; then the SM's id, and the warp's start and
// end on the card's global timer (ns, one clock for all SMs).
constexpr int PH_STEP = 0, PH_DESCENT = 1, PH_DDA = 2, PH_RAY = 3, N_PHASES = 4;
constexpr int PROBE_WORDS = 18;
constexpr int PW_START = 0, PW_END = 1, PW_RAYS = 2, PW_PHASES = 3, PW_SM = 15,
              PW_NS_START = 16, PW_NS_END = 17;

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (long long)t;
}

template <bool ON>
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

template <>
struct Probe<true> {
  long long start, ns_start, rays, issues[N_PHASES], lanes[N_PHASES],
      cycles[N_PHASES];

  __device__ __forceinline__ void begin() {
    ns_start = global_ns();
    start = clock64();
    rays = 0;
    for (int p = 0; p < N_PHASES; ++p) issues[p] = lanes[p] = cycles[p] = 0;
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
    long long v[PROBE_WORDS];
    v[PW_START] = start;
    v[PW_END] = end;
    v[PW_RAYS] = warp_sum(rays);
    for (int p = 0; p < N_PHASES; ++p) {
      v[PW_PHASES + 3 * p] = warp_sum(issues[p]);
      v[PW_PHASES + 3 * p + 1] = warp_sum(lanes[p]);
      v[PW_PHASES + 3 * p + 2] = warp_sum(cycles[p]);
    }
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    v[PW_SM] = sm;
    v[PW_NS_START] = ns_start;
    v[PW_NS_END] = ns_end;
    if ((threadIdx.x & 31) == 0) {
      const size_t warp = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
      for (int k = 0; k < PROBE_WORDS; ++k) out[warp * PROBE_WORDS + k] = v[k];
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

// ---- esvo_stackless --------------------------------------------------------

// One thread a ray, the stackless walk over the full tree, at most
// max_iters_for_depth(depth) steps.
template <bool PROBE>
__global__ void __launch_bounds__(BLOCK)
esvo_stackless_kernel(Tree tree, Rays rays, Out out,
                      long long* __restrict__ probe_out) {
  Probe<PROBE> probe;
  probe.begin();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < rays.n) {
    long long t = probe.enter(PH_RAY);
    Ray r;
    Walk w;
    bool done = setup(rays.origin, rays.direction, i, r, w);
    probe.leave(PH_RAY, t);
    const int n_max = max_iters_for_depth(tree.depth);
    int hp = -1, hc = 0, leaf = -1, it = 0;
    float ht = 0.0f;
    while (!done && it < n_max) {
      t = probe.enter(PH_STEP);
      ++it;
      int child_shift, leaf_rank;
      const int what = stackless_step(r, w, tree.masks, tree.child,
                                      tree.parent_ptr, child_shift, leaf_rank);
      if (what == STEP_LEAF) {
        hp = w.parent;
        hc = child_shift;
        ht = w.t_min;
        leaf = __ldg(tree.leaf_base + hp) + leaf_rank;
      }
      done = what != STEP_ON;
      probe.leave(PH_STEP, t);
    }
    t = probe.enter(PH_RAY);
    write_ray(out, i, leaf, ht, hp, hc, it);
    write_stats(out.stats, i, 0, 0, 0, 0, !done);
    probe.ray();
    probe.leave(PH_RAY, t);
  }
  probe.finish(probe_out);
}

// ---- brick_trace -----------------------------------------------------------

// One thread a ray, rounds of a stackless walk over the top tree until the
// ray parks at a brick, then the brick's DDA; a DDA that leaves the brick
// sets `popped`, so the next round's walk steps past it. STAGE: the parked
// ray's brick row is read into its slice of shared memory first; B: the
// block's threads.
template <bool STAGE, bool PROBE, int B>
__global__ void __launch_bounds__(B)
brick_trace_kernel(Tree tree, Rays rays, Out out,
                   long long* __restrict__ probe_out) {
  __shared__ int staged[STAGE ? B * ROW_WORDS : 1];
  int* const my_row = staged + (STAGE ? threadIdx.x * ROW_WORDS : 0);
  Probe<PROBE> probe;
  probe.begin();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < rays.n) {
    long long t = probe.enter(PH_RAY);
    Ray r;
    Walk w;
    bool done = setup(rays.origin, rays.direction, i, r, w);
    probe.leave(PH_RAY, t);
    const int depth = tree.depth, top_depth = tree.top_depth;
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
      // parked at brick top_child[parent] + leaf_rank: descend to the entry
      // voxel, then step through the brick
      t = probe.enter(PH_DESCENT);
      const int* row = tree.bricks +
                       (size_t)(__ldg(tree.child + w.parent) + leaf_rank) * ROW_WORDS;
      if constexpr (STAGE) {
        int v[ROW_WORDS];
        for (int k = 0; k < ROW_WORDS; ++k) v[k] = __ldg(row + k);
        for (int k = 0; k < ROW_WORDS; ++k) my_row[k] = v[k];
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
      w.t_min = t_cur;
      it += steps;
      dda += steps;
      dda_max = max(dda_max, steps);
    }
    t = probe.enter(PH_RAY);
    write_ray(out, i, leaf, ht, hp, hc, it);
    write_stats(out.stats, i, rounds, dda, capped, dda_max, !done);
    probe.ray();
    probe.leave(PH_RAY, t);
  }
  probe.finish(probe_out);
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

}  // namespace

extern "C" int esvo_stackless(const void* masks, const void* child_base,
                              const void* parent_ptr, const void* leaf_base,
                              const void* origin, const void* direction, int n,
                              int depth, void* hit_leaf, void* hit_t,
                              void* hit_parent, void* hit_child, void* iters,
                              void* stats, void* stream) {
  return launch_stackless(masks, child_base, parent_ptr, leaf_base, origin,
                          direction, n, depth,
                          outputs(hit_leaf, hit_t, hit_parent, hit_child, iters, stats),
                          nullptr, stream);
}

// With the counters: `probe` holds PROBE_WORDS int64 words for each warp of
// the launch.
extern "C" int esvo_stackless_probe(const void* masks, const void* child_base,
                                    const void* parent_ptr,
                                    const void* leaf_base, const void* origin,
                                    const void* direction, int n, int depth,
                                    void* hit_leaf, void* hit_t,
                                    void* hit_parent, void* hit_child,
                                    void* iters, void* stats, void* probe,
                                    void* stream) {
  if (probe == nullptr) return (int)cudaErrorInvalidValue;
  return launch_stackless(masks, child_base, parent_ptr, leaf_base, origin,
                          direction, n, depth,
                          outputs(hit_leaf, hit_t, hit_parent, hit_child, iters, stats),
                          probe, stream);
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
