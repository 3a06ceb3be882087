// Phase 1 of the tile trace for Hopper, sm_90a: each tile's frustum walks
// the occupancy pyramid once and keeps its brick candidates.
//
//   tile_candidates  replaces raytracingtest_tpu/ops/tile.py::_candidates
//                    (:288; with _frustum_planes :280), which the reference
//                    runs as one XLA program under jax.lax.map. For each tile,
//                    level by level: expand the 8 children of every kept cell
//                    from one pyramid word, cull them against the 4 frustum
//                    planes and the view half-space, take the Euclidean
//                    entry-t lower bound, pack the int32 key
//                    (q << 3l) | child (2^31 - 1 for a culled child), keep the
//                    width[l] smallest keys and lower drop_t by the next one.
//                    The finest level writes the tile's codes (ascending by
//                    key), brick ids (cellmap's prefix popcount), t lower
//                    bounds and drop_t.
//   tile_candidates_block  the first form of the same function: a block a
//                    tile that sorts each level's keys, padded with the
//                    sentinel, in full. Kept as the new form's check and
//                    yardstick; nothing on the main path launches it.
//
// Semantics follow the plain PyTorch version bit for bit
// (raytracingtest_tpu_torch/ops/tile.py::candidates_plain):
//   * every sum is taken in that version's left-to-right order, and the
//     build's --fmad=false keeps each product rounded on its own: the plane
//     normals a x b, the centre (c0 + c1 + c2 + c3) that is also the view
//     direction, the plane tests (p0*rx + p1*ry) + p2*rz, and the radii
//     (|p0| + |p1| + |p2|) * half. sign(0) counts as 1, as torch.where does it
//     there;
//   * t_lb is the correctly rounded float32 square root (__fsqrt_rn), which is
//     what the plain version's float64 sqrt rounded to float32 gives (F9);
//   * clamp(x, min=0) and clamp(x, max=2^30) are comparisons that let NaN
//     through, as torch.clamp does; the float -> int32 cast truncates toward
//     zero (and gives 0 for NaN here; the clamp to [0, qmax] that follows
//     makes that 0 on the CPU too);
//   * pyramid and cellmap words are uint32_t, the mask of the bits below s is
//     (1u << s) - 1u (F1). Keys stay int32 (F5).
// A child appears once in its tile's list, so every key but the sentinel is
// unique: any exact selection of the width[l] smallest valid keys gives the
// plain version's set, and any correct ascending sort its order.
//
// The widths come from the host (ops/tile_cuda.py::level_widths): width[0] = 1
// and width[l] = min(cap_l, 8 * width[l-1]), cap_l = min(caps[l], 8^l) but
// min(k_max, 8^l) at the finest level. The plain version sorts 8 * width[l-1]
// keys and lowers drop_t by the key of rank width[l] where that is not the
// sentinel: exactly where more than width[l] keys are valid.
//
// tile_candidates: a group of WARPS warps a tile (1, eight tiles a block, or
// 8, a block a tile; the wrapper picks by ops/tile_cuda.py::candidate_warps).
// Per level:
//   * compact: the group expands the children of the cells kept so far
//     (8 * kept slots, not 8 * width[l-1]), and each warp packs the valid
//     keys of 32 slots with __ballot_sync / __popc into the group's staging
//     array (its running count in a register for one warp, an atomicAdd a
//     warp and 32 slots in shared memory for eight). The count replaces the
//     padded width; the order of the keys is whatever the warps gave.
//   * select: with count <= width[l] every key is kept, unsorted. Above it,
//     a bitwise search finds the key of rank width[l] (the largest v with at
//     most width[l] keys below it; one counting pass over the staged keys a
//     bit, from the highest bit in which the smallest and the largest key
//     differ), drop_t takes its t, and the keys below it are kept.
//   * the finest level's row of min(count, width) <= k_max <= 256 keys is
//     sorted by one warp in registers (a bitonic network over 32 * E keys,
//     E = 1, 2, 4 or 8 a lane, __shfl_xor_sync across lanes) and written out,
//     padded to k_max.
// Shared memory a group: 8 * the widest width above the finest level
// (staging, at most 2,048 keys) plus the widest width (the kept cells, at
// most WIDTH_LIMIT) words. What bounds it on this card: a tile's chain of
// dependent steps (its levels, each an expansion, a compaction and, where a
// level overflows, some thirty counting passes), not bytes (a tile reads 48 B
// of corners and a word a kept cell, and writes 12 B a candidate) nor
// arithmetic. One warp a tile needs no block barrier at all; a block a tile
// (for few tiles with wide levels) spreads each level over 256 threads.
//
// tile_candidates_block, the first form: one block of 256 threads a tile.
// The previous level's kept codes stay in shared memory; each thread expands
// some of the 8 * width[l-1] children and writes their keys into a shared
// array padded with the sentinel to the next power of two (at most 2,048
// keys, 8 KB), which a bitonic network sorts in place. It is bound by the
// block's chain of barriers: a sort of n keys takes log2(n) (log2(n) + 1) / 2
// passes, each ended by __syncthreads, mostly over sentinels.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int LEVELS = 11;              // levels 0..10 (top_depth <= 10)
constexpr int WIDTH_LIMIT = 256;        // k_max and every level's width
constexpr int SORT_LIMIT = 8 * WIDTH_LIMIT;
constexpr int BLOCK = 256;
constexpr int SENTINEL = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;
// a group's words of shared memory besides its staging and kept arrays: two
// level counters, two counters of kept keys, and two rows of eight per-warp
// partial sums
constexpr int MISC = 4 + 2 * 8;

// What the host derives once a launch: the kept width and the first
// pyramid word of every level.
struct Plan {
  int width[LEVELS];
  int offs[LEVELS];
};

__device__ __forceinline__ uint32_t compact3_10(uint32_t x) {
  x &= 0x9249249u;
  x = (x | (x >> 2)) & 0x30C30C3u;
  x = (x | (x >> 4)) & 0x300F00Fu;
  x = (x | (x >> 8)) & 0x30000FFu;
  x = (x | (x >> 16)) & 0x3FFu;
  return x;
}

// torch.sign with sign(0) replaced by 1; NaN stays NaN
__device__ __forceinline__ float sign_or_one(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : (x == 0.0f ? 1.0f : x));
}

// A tile's four side planes, its view direction and the camera's apex.
struct Frustum {
  float pl[4][3], pa_sum[4];
  float fwd[3], fa_sum;
  float ox, oy, oz;
};

__device__ __forceinline__ void frustum_of(const float* __restrict__ corners,
                                           const float* __restrict__ apex,
                                           int tile, Frustum& f) {
  float c[4][3];
  const float* tc = corners + (size_t)tile * 12;
  for (int j = 0; j < 4; ++j)
    for (int a = 0; a < 3; ++a) c[j][a] = __ldg(tc + j * 3 + a);
  for (int a = 0; a < 3; ++a)
    f.fwd[a] = ((c[0][a] + c[1][a]) + c[2][a]) + c[3][a];
  for (int j = 0; j < 4; ++j) {
    const float* u = c[j];
    const float* v = c[(j + 1) & 3];
    const float n0 = u[1] * v[2] - u[2] * v[1];
    const float n1 = u[2] * v[0] - u[0] * v[2];
    const float n2 = u[0] * v[1] - u[1] * v[0];
    const float s =
        sign_or_one((n0 * f.fwd[0] + n1 * f.fwd[1]) + n2 * f.fwd[2]);
    f.pl[j][0] = n0 * s;
    f.pl[j][1] = n1 * s;
    f.pl[j][2] = n2 * s;
    f.pa_sum[j] =
        (fabsf(f.pl[j][0]) + fabsf(f.pl[j][1])) + fabsf(f.pl[j][2]);
  }
  f.fa_sum = (fabsf(f.fwd[0]) + fabsf(f.fwd[1])) + fabsf(f.fwd[2]);
  f.ox = __ldg(apex);
  f.oy = __ldg(apex + 1);
  f.oz = __ldg(apex + 2);
}

// What a level's keys are made of, for one tile.
struct Level {
  float half, cell, q_scale, t_scale, pr[4], fr;
  int code_bits, qmax;
  const int* words;
};

__device__ __forceinline__ Level level_of(const Frustum& f, const Plan& plan,
                                          const int* pyr, int l) {
  Level v;
  v.half = 1.0f / (float)(1 << (l + 1));
  v.cell = 1.0f / (float)(1 << l);
  v.code_bits = 3 * l;
  const int qbits = 30 - v.code_bits > 0 ? 30 - v.code_bits : 0;
  v.qmax = qbits ? (1 << qbits) - 2 : 0;
  v.q_scale = (float)(1 << qbits) / 4.0f;  // exact powers of two
  v.t_scale = 4.0f / (float)(1 << qbits);
  for (int j = 0; j < 4; ++j) v.pr[j] = f.pa_sum[j] * v.half;
  v.fr = f.fa_sum * v.half;
  v.words = pyr + plan.offs[l];
  return v;
}

// The key of child `oct` of the kept cell `parent` (a code of the level
// above), or SENTINEL where the child is empty or culled.
__device__ __forceinline__ int child_key(const Frustum& f, const Level& v,
                                         int parent, int oct) {
  const uint32_t word = (uint32_t)__ldg(v.words + (parent >> 2));
  if (!((word >> (((parent & 3) << 3) + oct)) & 1u)) return SENTINEL;
  const uint32_t child = (uint32_t)parent * 8u + (uint32_t)oct;
  const float rx = ((float)compact3_10(child) * v.cell + v.half) - f.ox;
  const float ry = ((float)compact3_10(child >> 1) * v.cell + v.half) - f.oy;
  const float rz = ((float)compact3_10(child >> 2) * v.cell + v.half) - f.oz;
  bool keep = true;
  for (int j = 0; j < 4; ++j) {
    const float pd = (f.pl[j][0] * rx + f.pl[j][1] * ry) + f.pl[j][2] * rz;
    keep = keep && (pd + v.pr[j] >= 0.0f);
  }
  const float fd = (f.fwd[0] * rx + f.fwd[1] * ry) + f.fwd[2] * rz;
  keep = keep && (fd + v.fr >= 0.0f);
  if (!keep) return SENTINEL;
  float ax = fabsf(rx) - v.half, ay = fabsf(ry) - v.half, az = fabsf(rz) - v.half;
  ax = ax < 0.0f ? 0.0f : ax;
  ay = ay < 0.0f ? 0.0f : ay;
  az = az < 0.0f ? 0.0f : az;
  const float t_lb = __fsqrt_rn((ax * ax + ay * ay) + az * az);
  float scaled = t_lb * v.q_scale;
  scaled = scaled > 1073741824.0f ? 1073741824.0f : scaled;
  int q = (int)scaled;
  q = q < 0 ? 0 : (q > v.qmax ? v.qmax : q);
  return (q << v.code_bits) | (int)child;
}

// One entry of a tile's output row from a finest-level key.
__device__ __forceinline__ void write_entry(
    int key, const Level& v, const int* __restrict__ cellmap, size_t at,
    int* __restrict__ codes_out, int* __restrict__ ids_out,
    float* __restrict__ t_out) {
  int code = -1, id = -1;
  float t = INFINITY;
  if (key != SENTINEL) {
    code = key & ((1 << v.code_bits) - 1);
    t = (float)(key >> v.code_bits) * v.t_scale;
    const int cm = (code >> 5) * 2;
    const uint32_t below = (1u << (code & 31)) - 1u;
    id = __ldg(cellmap + cm) + __popc((uint32_t)__ldg(cellmap + cm + 1) & below);
  }
  codes_out[at] = code;
  ids_out[at] = id;
  t_out[at] = t;
}

// ---- tile_candidates -------------------------------------------------------

// The group's barrier: a warp's own, or the block's.
template <int WARPS>
__device__ __forceinline__ void group_sync() {
  if (WARPS == 1) __syncwarp();
  else __syncthreads();
}

enum Reduce { SUM, MIN, MAX };

// The sum, least or largest over the group of each thread's `x`, in every
// thread. `partial` holds two rows of eight words; successive calls
// alternate rows, so a call's writes never meet the last call's reads.
template <int WARPS, Reduce R>
__device__ __forceinline__ unsigned group_reduce(unsigned x, int* partial,
                                                 int& row) {
  x = R == SUM ? __reduce_add_sync(FULL, x)
               : R == MIN ? __reduce_min_sync(FULL, x) : __reduce_max_sync(FULL, x);
  if (WARPS == 1) return x;
  int* p = partial + row * 8;
  row ^= 1;
  if ((threadIdx.x & 31) == 0) p[threadIdx.x >> 5] = (int)x;
  __syncthreads();
  x = (unsigned)p[0];
  for (int w = 1; w < WARPS; ++w) {
    const unsigned y = (unsigned)p[w];
    x = R == SUM ? x + y : R == MIN ? min(x, y) : max(x, y);
  }
  return x;
}

// Appends, for each warp and 32 values at a time, the values for which
// `take` holds to `out`: a running count in a register for one warp, an
// atomicAdd a warp on `*counter` (cleared beforehand) for a block. Every lane
// of a warp must call it the same number of times.
template <int WARPS>
__device__ __forceinline__ void append(bool take, int value, int* out,
                                       int& count, int* counter) {
  const unsigned mask = __ballot_sync(FULL, take);
  const int lane = threadIdx.x & 31;
  const int below = __popc(mask & ((1u << lane) - 1u));
  int base;
  if (WARPS == 1) {
    base = count;
    count += __popc(mask);
  } else {
    base = 0;
    if (lane == 0 && mask) base = atomicAdd(counter, __popc(mask));
    base = __shfl_sync(FULL, base, 0);
  }
  if (take) out[base + below] = value;
}

// Sorts one warp's 32 * E keys ascending, key lane * E + e in v[e] of lane
// `lane`: a bitonic network, across lanes by __shfl_xor_sync where the
// partner lies in another lane, inside the lane's registers where not.
template <int E>
__device__ __forceinline__ void warp_sort(int (&v)[E], int lane) {
  constexpr int N = 32 * E;
#pragma unroll
  for (int k = 2; k <= N; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= E) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int i = lane * E + e;
          const int other = __shfl_xor_sync(FULL, v[e], j / E);
          const bool lower = (i & j) == 0, up = (i & k) == 0;
          v[e] = lower == up ? min(v[e], other) : max(v[e], other);
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if (e & j) continue;
          const int i = lane * E + e;
          const int a = v[e], b = v[e | j];
          const bool up = (i & k) == 0;
          v[e] = up ? min(a, b) : max(a, b);
          v[e | j] = up ? max(a, b) : min(a, b);
        }
      }
    }
  }
}

// The finest level's row by one warp: the m keys of `keys` (unsorted, m <=
// 32 * E) sorted and written, padded to k_max.
template <int E>
__device__ __forceinline__ void write_row(
    const int* keys, int m, int k_max, const Level& v,
    const int* __restrict__ cellmap, size_t row, int* __restrict__ codes_out,
    int* __restrict__ ids_out, float* __restrict__ t_out) {
  const int lane = threadIdx.x & 31;
  int r[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = lane * E + e;
    r[e] = i < m ? keys[i] : SENTINEL;
  }
  warp_sort<E>(r, lane);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = lane * E + e;
    if (i < k_max) write_entry(r[e], v, cellmap, row + i, codes_out, ids_out, t_out);
  }
  for (int i = 32 * E + lane; i < k_max; i += 32)
    write_entry(SENTINEL, v, cellmap, row + i, codes_out, ids_out, t_out);
}

// stage_len: the group's staging words (8 * the widest width above the
// finest level); kept_len: its kept words (the widest width). At most 64
// registers a thread, so that an SM holds four blocks: the main call's 512
// blocks then all run at once, and a block held by one slow tile keeps no
// other tile waiting for its SM.
template <int WARPS>
__global__ void __launch_bounds__(BLOCK, 4)
tile_candidates_kernel(const int* __restrict__ pyr,
                       const int* __restrict__ cellmap,
                       const float* __restrict__ corners,
                       const float* __restrict__ apex, int T, int top_depth,
                       int k_max, Plan plan, int stage_len, int kept_len,
                       int* __restrict__ codes_out, int* __restrict__ ids_out,
                       float* __restrict__ t_out,
                       float* __restrict__ drop_out) {
  extern __shared__ int smem[];
  constexpr int GROUPS = BLOCK / 32 / WARPS;  // tiles a block
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) % WARPS;  // in the group
  const int group = (threadIdx.x >> 5) / WARPS;
  const int tile = blockIdx.x * GROUPS + group;
  if (tile >= T) return;  // a whole warp (WARPS == 1: no block barrier)
  int* stage = smem + group * (stage_len + kept_len + MISC);
  int* kept = stage + stage_len;
  int* counters = kept + kept_len;  // [0, 2) a level's, [2, 4) kept keys'
  int* partial = counters + 4;
  int row_sel = 0;

  Frustum f;
  frustum_of(corners, apex, tile, f);
  if (threadIdx.x % (32 * WARPS) == 0) {
    kept[0] = 0;  // level 0: the root
    counters[0] = counters[1] = counters[2] = counters[3] = 0;
  }
  int n_kept = 1;
  float drop = INFINITY;
  group_sync<WARPS>();

  for (int l = 1; l <= top_depth; ++l) {
    const Level v = level_of(f, plan, pyr, l);
    // compact: the valid keys of the kept cells' children into stage
    const int slots = 8 * n_kept;
    int count = 0;
    int* level_counter = counters + (l & 1);
    for (int base = warp * 32; base < slots; base += 32 * WARPS) {
      const int i = base + lane;
      const int key = i < slots ? child_key(f, v, kept[i >> 3], i & 7) : SENTINEL;
      append<WARPS>(key != SENTINEL, key, stage, count, level_counter);
    }
    group_sync<WARPS>();
    if (WARPS > 1) {
      count = *level_counter;
      // the other level counter was last read before this level's barrier
      if (threadIdx.x == 0) counters[(l + 1) & 1] = 0;
    }

    // select: the width[l] smallest keys, and drop_t from the next one
    const int w = plan.width[l];
    int kth = SENTINEL;  // keys below it are kept
    if (count > w) {
      unsigned lo = ~0u, hi = 0u;
      for (int i = warp * 32 + lane; i < count; i += 32 * WARPS) {
        lo = min(lo, (unsigned)stage[i]);
        hi = max(hi, (unsigned)stage[i]);
      }
      lo = group_reduce<WARPS, MIN>(lo, partial, row_sel);
      hi = group_reduce<WARPS, MAX>(hi, partial, row_sel);
      // every key shares lo's bits above the highest bit in which lo and
      // hi differ (count > w >= 1 keys, unique, so lo < hi)
      const int top = 31 - __clz((int)(lo ^ hi));
      unsigned prefix = lo & ~((2u << top) - 1u);
      for (int bit = top; bit >= 0; --bit) {
        const unsigned cand = prefix | (1u << bit);
        unsigned below = 0;
        for (int i = warp * 32 + lane; i < count; i += 32 * WARPS)
          below += (unsigned)stage[i] < cand;
        if (group_reduce<WARPS, SUM>(below, partial, row_sel) <= (unsigned)w)
          prefix = cand;
      }
      kth = (int)prefix;
      const float t_drop = (float)(kth >> v.code_bits) * v.t_scale;
      drop = t_drop < drop ? t_drop : drop;
    }

    if (l < top_depth) {
      // keep: the kept keys' codes, in any order
      const int code_mask = (1 << v.code_bits) - 1;
      if (count <= w) {
        for (int i = warp * 32 + lane; i < count; i += 32 * WARPS)
          kept[i] = stage[i] & code_mask;
      } else {
        int n = 0;
        for (int base = warp * 32; base < count; base += 32 * WARPS) {
          const int i = base + lane;
          const int key = i < count ? stage[i] : SENTINEL;
          append<WARPS>(key < kth, key & code_mask, kept, n,
                        counters + 2 + (l & 1));
        }
      }
      n_kept = count > w ? w : count;
      group_sync<WARPS>();
      if (WARPS > 1 && threadIdx.x == 0) counters[2 + ((l + 1) & 1)] = 0;
      continue;
    }

    // the finest level: the kept keys, sorted by the group's first warp
    const int m = count > w ? w : count;
    const int* keys = stage;
    if (count > w) {
      int n = 0;
      for (int base = warp * 32; base < count; base += 32 * WARPS) {
        const int i = base + lane;
        const int key = i < count ? stage[i] : SENTINEL;
        append<WARPS>(key < kth, key, kept, n, counters + 2 + (l & 1));
      }
      group_sync<WARPS>();
      keys = kept;
    }
    if (warp != 0) return;
    const size_t row = (size_t)tile * k_max;
    if (m <= 32)
      write_row<1>(keys, m, k_max, v, cellmap, row, codes_out, ids_out, t_out);
    else if (m <= 64)
      write_row<2>(keys, m, k_max, v, cellmap, row, codes_out, ids_out, t_out);
    else if (m <= 128)
      write_row<4>(keys, m, k_max, v, cellmap, row, codes_out, ids_out, t_out);
    else
      write_row<8>(keys, m, k_max, v, cellmap, row, codes_out, ids_out, t_out);
    if (lane == 0) drop_out[tile] = drop;
  }
}

// ---- tile_candidates_block, the first form ---------------------------------

// Sorts keys[0, n) ascending (n a power of two) with the block's threads: a
// bitonic network in which every comparator puts the smaller key at the lower
// index (the first pass of each merge compares i with i ^ (k - 1), the later
// ones i with i ^ j). Each pass gives every thread whole pairs: pair p's lower
// index has the mask's top bit clear.
__device__ void block_sort(int* keys, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int mask = k - 1; mask > 0; mask = mask == k - 1 ? k >> 2 : mask >> 1) {
      const int h = mask == k - 1 ? k >> 1 : mask;
      for (int p = threadIdx.x; p < n / 2; p += blockDim.x) {
        const int lo = ((p & ~(h - 1)) << 1) | (p & (h - 1));
        const int hi = lo ^ mask;
        const int a = keys[lo], b = keys[hi];
        if (b < a) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(BLOCK)
tile_candidates_block_kernel(const int* __restrict__ pyr,
                             const int* __restrict__ cellmap,
                             const float* __restrict__ corners,
                             const float* __restrict__ apex, int top_depth,
                             int k_max, Plan plan, int* __restrict__ codes_out,
                             int* __restrict__ ids_out,
                             float* __restrict__ t_out,
                             float* __restrict__ drop_out) {
  __shared__ int keys[SORT_LIMIT];
  __shared__ int prev[WIDTH_LIMIT];
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;

  // the tile's planes and view direction, in every thread's registers
  Frustum f;
  frustum_of(corners, apex, tile, f);

  if (tid == 0) prev[0] = 0;  // level 0: the root
  float drop = INFINITY;      // thread 0's
  __syncthreads();

  for (int l = 1; l <= top_depth; ++l) {
    const int n = 8 * plan.width[l - 1];
    int n2 = 8;
    while (n2 < n) n2 <<= 1;
    const Level v = level_of(f, plan, pyr, l);

    for (int i = tid; i < n2; i += BLOCK) {
      const int parent = i < n ? prev[i >> 3] : -1;
      keys[i] = parent >= 0 ? child_key(f, v, parent, i & 7) : SENTINEL;
    }
    __syncthreads();
    block_sort(keys, n2);

    const int w = plan.width[l];
    if (tid == 0 && w < n) {  // the level dropped keys[w, n)
      const int nxt = keys[w];
      if (nxt != SENTINEL) {
        const float t_drop = (float)(nxt >> v.code_bits) * v.t_scale;
        drop = t_drop < drop ? t_drop : drop;
      }
    }
    const int code_mask = (1 << v.code_bits) - 1;
    if (l < top_depth) {
      for (int i = tid; i < w; i += BLOCK)
        prev[i] = keys[i] == SENTINEL ? -1 : keys[i] & code_mask;
      __syncthreads();
      continue;
    }
    // the finest level: the tile's row, padded to k_max with (-1, -1, inf)
    const size_t row = (size_t)tile * k_max;
    for (int i = tid; i < k_max; i += BLOCK)
      write_entry(i < w ? keys[i] : SENTINEL, v, cellmap, row + i, codes_out,
                  ids_out, t_out);
  }
  if (tid == 0) drop_out[tile] = drop;
}

// The plan of a launch from the host's widths; false where they are out of
// range: top_depth + 1 ints, width[0] = 1 and
// 1 <= width[l] <= min(WIDTH_LIMIT, 8 * width[l-1]), width[top_depth] <= k_max.
bool make_plan(int T, int top_depth, const int* widths, int k_max, Plan& plan) {
  if (T < 0 || top_depth < 1 || top_depth >= LEVELS || k_max < 1 ||
      k_max > WIDTH_LIMIT || widths == nullptr || widths[0] != 1 ||
      widths[top_depth] > k_max)
    return false;
  plan = Plan{};
  plan.width[0] = 1;
  int words = 0;
  for (int l = 1; l <= top_depth; ++l) {
    if (widths[l] < 1 || widths[l] > WIDTH_LIMIT || widths[l] > 8 * widths[l - 1])
      return false;
    plan.width[l] = widths[l];
    plan.offs[l] = words;  // ops/tile.py::_pyr_layout
    const int level_words = (1 << (3 * l)) / 32;
    words += level_words > 1 ? level_words : 1;
  }
  return true;
}

template <int WARPS>
int launch_candidates(const void* pyr, const void* cellmap, const void* corners,
                      const void* apex, int T, int top_depth, int k_max,
                      const Plan& plan, void* codes, void* ids, void* t_codes,
                      void* drop_t, cudaStream_t stream) {
  int stage_len = 0, kept_len = 1;
  for (int l = 1; l <= top_depth; ++l) {
    stage_len = max(stage_len, 8 * plan.width[l - 1]);
    kept_len = max(kept_len, plan.width[l]);
  }
  constexpr int GROUPS = BLOCK / 32 / WARPS;
  const size_t bytes = (size_t)GROUPS * (stage_len + kept_len + MISC) * sizeof(int);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tile_candidates_kernel<WARPS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  tile_candidates_kernel<WARPS><<<(T + GROUPS - 1) / GROUPS, BLOCK, bytes, stream>>>(
      (const int*)pyr, (const int*)cellmap, (const float*)corners,
      (const float*)apex, T, top_depth, k_max, plan, stage_len, kept_len,
      (int*)codes, (int*)ids, (float*)t_codes, (float*)drop_t);
  return (int)cudaGetLastError();
}

}  // namespace

// widths: top_depth + 1 ints in host memory (make_plan). warps: the warps a
// tile, 1 or 8.
extern "C" int tile_candidates(const void* pyr, const void* cellmap,
                               const void* corners, const void* apex, int T,
                               int top_depth, const int* widths, int k_max,
                               int warps, void* codes, void* ids,
                               void* t_codes, void* drop_t, void* stream) {
  Plan plan;
  if (!make_plan(T, top_depth, widths, k_max, plan) || (warps != 1 && warps != 8))
    return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  return warps == 1
             ? launch_candidates<1>(pyr, cellmap, corners, apex, T, top_depth,
                                    k_max, plan, codes, ids, t_codes, drop_t, st)
             : launch_candidates<8>(pyr, cellmap, corners, apex, T, top_depth,
                                    k_max, plan, codes, ids, t_codes, drop_t, st);
}

extern "C" int tile_candidates_block(const void* pyr, const void* cellmap,
                                     const void* corners, const void* apex,
                                     int T, int top_depth, const int* widths,
                                     int k_max, void* codes, void* ids,
                                     void* t_codes, void* drop_t,
                                     void* stream) {
  Plan plan;
  if (!make_plan(T, top_depth, widths, k_max, plan))
    return (int)cudaErrorInvalidValue;
  if (T > 0) {
    tile_candidates_block_kernel<<<T, BLOCK, 0, (cudaStream_t)stream>>>(
        (const int*)pyr, (const int*)cellmap, (const float*)corners,
        (const float*)apex, top_depth, k_max, plan, (int*)codes, (int*)ids,
        (float*)t_codes, (float*)drop_t);
  }
  return (int)cudaGetLastError();
}
