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
//   tile_candidates_mapped  the same function in the brickmap mode, for the
//                    streamed world (raytracingtest_tpu/stream/clipmap.py::
//                    _trace_clipmap_tile :579 and _render_clipmap_tile :639,
//                    through ops/tile.py::_trace_tile_fb :1073 with
//                    brickmap=, the remap at :880-882 and :1102-1108): a
//                    stitched pyramid's morton rank indexes `brickmap`, whose
//                    entry is the brick's row in the arena. It runs the radix
//                    form (below); tile_candidates_radix is the radix form
//                    unmapped, off every path. tile_candidates_mapped_first is
//                    its first form, the search form (tile_candidates_kernel's
//                    bitwise search) in the brickmap mode: the
//                    mode is a template flag (MAPPED) and `brickmap` the
//                    kernel's last parameter, so the unmapped instantiation,
//                    tile_candidates, keeps its code.
//   tile_candidates_probe  either form, the search form or the radix form, in either
//                    mode, with a record of each warp's cycles by phase
//                    (CandProbe), for measurement only.
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
// tile_candidates, the search form: a group of WARPS warps a tile (1, eight
// tiles a block, or 8, a block a tile; the wrapper picks by
// ops/tile_cuda.py::candidate_warps).
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

// level_of without its divisions, for the radix form: every factor is a
// power of two, built from its exponent, so the bits are the same.
__device__ __forceinline__ Level level_exact(const Frustum& f, const Plan& plan,
                                             const int* pyr, int l) {
  Level v;
  v.half = __int_as_float((127 - (l + 1)) << 23);  // 2^-(l+1)
  v.cell = __int_as_float((127 - l) << 23);        // 2^-l
  v.code_bits = 3 * l;
  const int qbits = 30 - v.code_bits > 0 ? 30 - v.code_bits : 0;
  v.qmax = qbits ? (1 << qbits) - 2 : 0;
  v.q_scale = __int_as_float((127 + qbits - 2) << 23);  // 2^qbits / 4
  v.t_scale = __int_as_float((127 + 2 - qbits) << 23);  // 4 / 2^qbits
  for (int j = 0; j < 4; ++j) v.pr[j] = f.pa_sum[j] * v.half;
  v.fr = f.fa_sum * v.half;
  v.words = pyr + plan.offs[l];
  return v;
}

// The key of the occupied cell `child` of a level, or SENTINEL where the
// frustum culls it.
__device__ __forceinline__ int key_of(const Frustum& f, const Level& v,
                                      uint32_t child) {
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

// The key of child `oct` of the kept cell `parent` (a code of the level
// above), or SENTINEL where the child is empty or culled.
__device__ __forceinline__ int child_key(const Frustum& f, const Level& v,
                                         int parent, int oct) {
  const uint32_t word = (uint32_t)__ldg(v.words + (parent >> 2));
  if (!((word >> (((parent & 3) << 3) + oct)) & 1u)) return SENTINEL;
  return key_of(f, v, (uint32_t)parent * 8u + (uint32_t)oct);
}

// One entry of a tile's output row from a finest-level key. MAPPED (the
// brickmap mode): the brick id is brickmap[the morton rank], a row of a
// streaming arena's bricks.
template <bool MAPPED = false>
__device__ __forceinline__ void write_entry(
    int key, const Level& v, const int* __restrict__ cellmap, size_t at,
    int* __restrict__ codes_out, int* __restrict__ ids_out,
    float* __restrict__ t_out, const int* __restrict__ brickmap = nullptr) {
  int code = -1, id = -1;
  float t = INFINITY;
  if (key != SENTINEL) {
    code = key & ((1 << v.code_bits) - 1);
    t = (float)(key >> v.code_bits) * v.t_scale;
    const int cm = (code >> 5) * 2;
    const uint32_t below = (1u << (code & 31)) - 1u;
    id = __ldg(cellmap + cm) + __popc((uint32_t)__ldg(cellmap + cm + 1) & below);
    if constexpr (MAPPED) id = __ldg(brickmap + id);
  }
  codes_out[at] = code;
  ids_out[at] = id;
  t_out[at] = t;
}

// ---- the probe -------------------------------------------------------------
// A warp's record in the probe form, CW_WORDS int64 words
// (ops/tile_cuda.py's CAND_PROBE_FIELDS): its tile, its start and end
// clock64() (the SM's own counter), the SM's id, its start and end on the
// card's global timer (ns, one clock for all SMs); the cycles in the
// frustum, in each level's expansion and compaction (levels 1..10, from its
// first pyramid load to its count), in each level's selection, in the keeps,
// in the finest row's sort and in its write; the selection's counting
// passes, the levels that overflowed their width, and the valid keys summed
// over the levels. Lane 0 keeps the warp's record in shared memory and
// writes it at the warp's global index; a warp without a tile writes none.
constexpr int CW_TILE = 0, CW_START = 1, CW_END = 2, CW_SM = 3,
              CW_NS_START = 4, CW_NS_END = 5, CW_FRUSTUM = 6, CW_EXPAND = 7,
              CW_SELECT = CW_EXPAND + LEVELS - 1, CW_KEEP = CW_SELECT + LEVELS - 1,
              CW_SORT = CW_KEEP + 1, CW_WRITE = CW_SORT + 1, CW_PASSES = CW_WRITE + 1,
              CW_OVER = CW_PASSES + 1, CW_VALID = CW_OVER + 1, CW_WORDS = CW_VALID + 1;

template <bool ON>
struct CandProbe {  // off: every call compiles to nothing
  __device__ __forceinline__ void begin(int) {}
  __device__ __forceinline__ long long mark() { return 0; }
  __device__ __forceinline__ void time(int, long long) {}
  __device__ __forceinline__ void count(int, int) {}
  __device__ __forceinline__ void finish(long long*) {}
};

template <>
struct CandProbe<true> {
  long long* v;  // the warp's record, in shared memory; lane 0 keeps it

  static __device__ __forceinline__ long long global_ns() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return (long long)t;
  }
  __device__ __forceinline__ void begin(int tile) {
    __shared__ long long records[BLOCK / 32][CW_WORDS];
    v = records[threadIdx.x >> 5];
    if ((threadIdx.x & 31) == 0) {
      for (int i = 0; i < CW_WORDS; ++i) v[i] = 0;
      v[CW_TILE] = tile;
      v[CW_NS_START] = global_ns();
      v[CW_START] = clock64();
    }
  }
  __device__ __forceinline__ long long mark() { return clock64(); }
  __device__ __forceinline__ void time(int word, long long t) {
    if ((threadIdx.x & 31) == 0) v[word] += clock64() - t;
  }
  __device__ __forceinline__ void count(int word, int n) {
    if ((threadIdx.x & 31) == 0) v[word] += n;
  }
  __device__ __forceinline__ void finish(long long* __restrict__ out) {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) {
      v[CW_END] = clock64();
      v[CW_NS_END] = global_ns();
      unsigned sm;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
      v[CW_SM] = sm;
      long long* rec =
          out + ((size_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * CW_WORDS;
      for (int i = 0; i < CW_WORDS; ++i) rec[i] = v[i];
    }
  }
};

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
template <int E, bool MAPPED, bool PROBE>
__device__ __forceinline__ void write_row(
    const int* keys, int m, int k_max, const Level& v,
    const int* __restrict__ cellmap, size_t row, int* __restrict__ codes_out,
    int* __restrict__ ids_out, float* __restrict__ t_out,
    const int* __restrict__ brickmap, CandProbe<PROBE>& probe) {
  const int lane = threadIdx.x & 31;
  long long t = probe.mark();
  int r[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = lane * E + e;
    r[e] = i < m ? keys[i] : SENTINEL;
  }
  warp_sort<E>(r, lane);
  probe.time(CW_SORT, t);
  t = probe.mark();
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = lane * E + e;
    if (i < k_max)
      write_entry<MAPPED>(r[e], v, cellmap, row + i, codes_out, ids_out, t_out,
                          brickmap);
  }
  for (int i = 32 * E + lane; i < k_max; i += 32)
    write_entry<MAPPED>(SENTINEL, v, cellmap, row + i, codes_out, ids_out, t_out,
                        brickmap);
  probe.time(CW_WRITE, t);
}

// One tile of tile_candidates (the group's), the search form: a level's child
// slots expanded 32 at a time, a pyramid load and a ballot each, and the
// bitwise search. `smem` is the block's dynamic shared memory: for each
// group stage_len staging words (8 * the widest width above the finest
// level), kept_len kept words (the widest width) and MISC. MAPPED: the
// brickmap mode (write_entry). PROBE: the probe form, which writes each
// warp's record to `probe_out`.
template <int WARPS, bool MAPPED, bool PROBE>
__device__ __forceinline__ void select_tile(
    int* smem, const int* __restrict__ pyr, const int* __restrict__ cellmap,
    const float* __restrict__ corners, const float* __restrict__ apex, int T,
    int top_depth, int k_max, const Plan& plan, int stage_len, int kept_len,
    int* __restrict__ codes_out, int* __restrict__ ids_out,
    float* __restrict__ t_out, float* __restrict__ drop_out,
    const int* __restrict__ brickmap, long long* __restrict__ probe_out) {
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
  CandProbe<PROBE> probe;
  probe.begin(tile);
  long long t = probe.mark();

  Frustum f;
  frustum_of(corners, apex, tile, f);
  if (threadIdx.x % (32 * WARPS) == 0) {
    kept[0] = 0;  // level 0: the root
    counters[0] = counters[1] = counters[2] = counters[3] = 0;
  }
  int n_kept = 1;
  float drop = INFINITY;
  group_sync<WARPS>();
  probe.time(CW_FRUSTUM, t);

  for (int l = 1; l <= top_depth; ++l) {
    t = probe.mark();
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
    probe.time(CW_EXPAND + l - 1, t);
    probe.count(CW_VALID, count);

    // select: the width[l] smallest keys, and drop_t from the next one
    const int w = plan.width[l];
    int kth = SENTINEL;  // keys below it are kept
    if (count > w) {
      t = probe.mark();
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
      probe.time(CW_SELECT + l - 1, t);
      probe.count(CW_PASSES, top + 1);
      probe.count(CW_OVER, 1);
    }

    t = probe.mark();
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
      probe.time(CW_KEEP, t);
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
    probe.time(CW_KEEP, t);
    if (warp != 0) {
      probe.finish(probe_out);
      return;
    }
    const size_t row = (size_t)tile * k_max;
    if (m <= 32)
      write_row<1, MAPPED>(keys, m, k_max, v, cellmap, row, codes_out, ids_out,
                           t_out, brickmap, probe);
    else if (m <= 64)
      write_row<2, MAPPED>(keys, m, k_max, v, cellmap, row, codes_out, ids_out,
                           t_out, brickmap, probe);
    else if (m <= 128)
      write_row<4, MAPPED>(keys, m, k_max, v, cellmap, row, codes_out, ids_out,
                           t_out, brickmap, probe);
    else
      write_row<8, MAPPED>(keys, m, k_max, v, cellmap, row, codes_out, ids_out,
                           t_out, brickmap, probe);
    if (lane == 0) drop_out[tile] = drop;
  }
  probe.finish(probe_out);
}

// The search form: select_tile without the probe. At most 64 registers a thread,
// so that an SM holds four blocks: the main call's 512 blocks then all run at
// once, and a block held by one slow tile keeps no other tile waiting for its
// SM. `brickmap` is the last parameter, so that the unmapped instantiation
// keeps its code.
template <int WARPS, bool MAPPED>
__global__ void __launch_bounds__(BLOCK, 4)
tile_candidates_kernel(const int* __restrict__ pyr,
                       const int* __restrict__ cellmap,
                       const float* __restrict__ corners,
                       const float* __restrict__ apex, int T, int top_depth,
                       int k_max, Plan plan, int stage_len, int kept_len,
                       int* __restrict__ codes_out, int* __restrict__ ids_out,
                       float* __restrict__ t_out,
                       float* __restrict__ drop_out,
                       const int* __restrict__ brickmap) {
  extern __shared__ int smem[];
  select_tile<WARPS, MAPPED, false>(smem, pyr, cellmap, corners, apex, T,
                                    top_depth, k_max, plan, stage_len, kept_len,
                                    codes_out, ids_out, t_out, drop_out,
                                    brickmap, nullptr);
}

// ---- the radix form --------------------------------------------------------
// What the probe form showed the search form spend its time on (chip_smoke.py
// [cand-warps], on the streamed frames' calls): on the main call a few heavy
// tiles, whose levels overflow, set the span; the heaviest spends some 34,000
// cycles in 56 counting passes and 25,000 in expansions of up to 15 chunks of
// 32 slots, each behind a pyramid load, while the median warp ends in a third
// of the span. On the light calls (the fly frame's) every warp's chain of
// levels sets it: some 1,500-3,300 cycles a level, the first levels slowed by
// every tile reading the same pyramid words at once; and a block a tile (the
// fallback calls) pays its barriers on every level, even an empty one. The
// radix form, a block a tile (block_tile) or PACKED_TILES tiles a warp
// (packed_tiles), gives the same bits:
//   * the block copies the pyramid's first PREFIX_LEVELS levels (19 words)
//     into shared memory while it builds its frusta; a deeper level issues
//     the words of all its kept cells at once (cp.async into shared memory),
//     one round trip a level;
//   * a level with a few kept cells is expanded a lane a child slot; with
//     more, their occupied children are listed first (each kept cell's
//     popcount, a warp scan), and only they are culled and keyed;
//   * an overflowing level finds the key of rank width[l] by a radix select
//     (radix_kth): from the highest bit in which its least and largest keys
//     differ, one histogram of RADIX_BITS-bit digits a pass (shared-memory
//     atomics over the keys that share the digits found so far, one warp scan
//     over the bins), until the digit's bin holds one key or no bit is left:
//     one to four passes where the bitwise search took some thirty. Keys are
//     unique int32 values (F5), so this is the key the bitwise search finds;
//   * a level's constants come from exponents, not from level_of's divisions
//     (level_exact: the same powers of two);
//   * a block a tile runs its light levels (up to LIGHT_SLOTS child slots) on
//     its first warp alone, with one barrier a level, and writes its finest
//     row by rank (each key's place is the number of keys below it), a thread
//     an entry, where the search form has one warp sort and write up to 256
//     keys.
// drop_t, the kept set and the row keep their bits.
constexpr int FORM_SELECT = 0, FORM_RADIX = 1;
constexpr int RADIX_BITS = 8, RADIX_BINS = 1 << RADIX_BITS;
constexpr int PREFIX_LEVELS = 3;
// a block a tile runs a level on its first warp alone up to this many child
// slots
constexpr int LIGHT_SLOTS = 64;
// a radix group's words besides its rows: counters (two a level's keys, two
// its occupied children, two its kept keys, the found key) and two rows of
// sixteen per-warp partial minima and maxima
constexpr int RADIX_MISC = 8 + 2 * 16;

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// Histogram rows of a block a tile: three, for it clears the row after next
// in each pass and so needs one barrier a pass, and a fourth for its first
// warp's light levels.
constexpr int BLOCK_HIST_ROWS = 4;

// The words of dynamic shared memory a group (a block's tile, or a warp's
// TILES tiles) takes in `FORM`; the radix form's a multiple of four, so that
// every group's rows start 16-byte aligned.
template <int FORM, int WARPS, int TILES>
__host__ __device__ constexpr int group_words(int stage_len, int kept_len);

// The words of the pyramid's first min(top_depth, PREFIX_LEVELS) levels.
__host__ __device__ inline int prefix_words(int top_depth) {
  int words = 0;
  for (int l = 1; l <= top_depth && l <= PREFIX_LEVELS; ++l)
    words += l >= 2 ? (1 << (3 * l)) / 32 : 1;
  return words;
}

__device__ __forceinline__ void copy_async(int* dst, const int* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ int warp_inclusive_sum(int x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// The least and the largest over the group of each thread's lo and hi, in
// every thread; `partial` holds two rows of sixteen words, alternated as in
// group_reduce.
template <int WARPS>
__device__ __forceinline__ void group_minmax(unsigned& lo, unsigned& hi,
                                             int* partial, int& row) {
  lo = __reduce_min_sync(FULL, lo);
  hi = __reduce_max_sync(FULL, hi);
  if (WARPS == 1) return;
  int* p = partial + row * 16;
  row ^= 1;
  const int warp = (threadIdx.x >> 5) % WARPS;
  if ((threadIdx.x & 31) == 0) {
    p[warp] = (int)lo;
    p[8 + warp] = (int)hi;
  }
  __syncthreads();
  lo = (unsigned)p[0];
  hi = (unsigned)p[8];
  for (int w = 1; w < WARPS; ++w) {
    lo = min(lo, (unsigned)p[w]);
    hi = max(hi, (unsigned)p[8 + w]);
  }
}

// The key of rank w (0-based) among the count > w unique keys of `stage`
// (least lo < largest hi), by the group: the radix select above. `hist`: for
// a warp one row of RADIX_BINS words, clear on entry and left so; for a block
// three, row pass % 3 clear on entry and each pass clearing the row after
// next. `pass` counts the group's passes over its levels; `found` a word for
// a block's result.
template <int WARPS, bool PROBE>
__device__ __forceinline__ int radix_kth(const int* stage, int count, int w,
                                         unsigned lo, unsigned hi, int* hist,
                                         int& pass, int* found,
                                         CandProbe<PROBE>& probe) {
  const int lane = threadIdx.x & 31;
  const int gt = threadIdx.x % (32 * WARPS);  // the thread in the group
  // every key shares lo's bits above the highest bit in which lo and hi
  // differ; keys are below 2^30, so top <= 29
  const int top = 31 - __clz((int)(lo ^ hi));
  int hi_bit = top + 1;  // the digit: bits [shift, hi_bit)
  unsigned prefix = lo & ~((2u << top) - 1u);
  int r = w;  // the rank among the keys that share prefix's bits >= hi_bit
  for (;;) {
    const int shift = hi_bit > RADIX_BITS ? hi_bit - RADIX_BITS : 0;
    const unsigned digit = (1u << (hi_bit - shift)) - 1u;
    int* h = hist + (WARPS == 1 ? 0 : (pass % 3) * RADIX_BINS);
    for (int i = gt; i < count; i += 32 * WARPS) {
      const unsigned k = (unsigned)stage[i];
      if ((k >> hi_bit) == (prefix >> hi_bit)) atomicAdd(h + ((k >> shift) & digit), 1);
    }
    if (WARPS > 1) hist[((pass + 1) % 3) * RADIX_BINS + gt] = 0;
    group_sync<WARPS>();
    // every warp: the bin that holds rank r, eight bins a lane
    const int4 a = reinterpret_cast<const int4*>(h)[2 * lane];
    const int4 b = reinterpret_cast<const int4*>(h)[2 * lane + 1];
    const int c[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    int sum = 0;
#pragma unroll
    for (int e = 0; e < 8; ++e) sum += c[e];
    const int incl = warp_inclusive_sum(sum);
    const int src = __ffs(__ballot_sync(FULL, incl - sum <= r && r < incl)) - 1;
    int d = lane * 8, below = incl - sum, n = 0;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (n == 0) {
        if (r < below + c[e]) {
          d = lane * 8 + e;
          n = c[e];
        } else {
          below += c[e];
        }
      }
    }
    d = __shfl_sync(FULL, d, src);
    below = __shfl_sync(FULL, below, src);
    n = __shfl_sync(FULL, n, src);
    r -= below;
    prefix |= (unsigned)d << shift;
    ++pass;
    probe.count(CW_PASSES, 1);
    if (WARPS == 1) {  // clear the row for the next pass
      __syncwarp();
      reinterpret_cast<int4*>(h)[2 * lane] = make_int4(0, 0, 0, 0);
      reinterpret_cast<int4*>(h)[2 * lane + 1] = make_int4(0, 0, 0, 0);
      __syncwarp();
    }
    if (shift == 0) return (int)prefix;
    if (n == 1) {  // the one key that shares every digit found
      int key = -1;
      for (int i = gt; i < count; i += 32 * WARPS) {
        const unsigned k = (unsigned)stage[i];
        if ((k >> shift) == (prefix >> shift)) key = (int)k;
      }
      key = (int)__reduce_max_sync(FULL, (unsigned)(key + 1)) - 1;
      if (WARPS == 1) return key;
      if (key >= 0 && lane == 0) *found = key;
      __syncthreads();
      return *found;
    }
    hi_bit = shift;
  }
}

// The finest row by a block's threads (WARPS * 32 >= k_max): the key of
// `keys` at gt < m goes to its rank, the number of keys below it (the keys
// are unique); entries m..k_max-1 are padding.
template <bool MAPPED, bool PROBE>
__device__ __forceinline__ void write_ranked(
    const int* keys, int m, int k_max, const Level& v,
    const int* __restrict__ cellmap, size_t row, int* __restrict__ codes_out,
    int* __restrict__ ids_out, float* __restrict__ t_out,
    const int* __restrict__ brickmap, int gt, CandProbe<PROBE>& probe) {
  long long t = probe.mark();
  int key = SENTINEL, at = gt;
  if (gt < m) {
    key = keys[gt];
    int rank = 0;
    for (int j = 0; j < m; ++j) rank += keys[j] < key;
    at = rank;
  }
  probe.time(CW_SORT, t);
  t = probe.mark();
  if (gt < k_max)
    write_entry<MAPPED>(key, v, cellmap, row + at, codes_out, ids_out, t_out,
                        brickmap);
  probe.time(CW_WRITE, t);
}

// One tile of the radix form on a block of BLOCK threads. `smem`: the
// pyramid prefix (round4(prefix_words) words), then BLOCK_HIST_ROWS histogram
// rows, stage_len staging words, as many for the list of occupied children,
// kept_len kept codes, as many of the kept cells' pyramid words, and
// RADIX_MISC.
template <bool MAPPED, bool PROBE>
__device__ __forceinline__ void block_tile(
    int* smem, const int* __restrict__ pyr, const int* __restrict__ cellmap,
    const float* __restrict__ corners, const float* __restrict__ apex, int T,
    int top_depth, int k_max, const Plan& plan, int stage_len, int kept_len,
    int n_prefix, int* __restrict__ codes_out, int* __restrict__ ids_out,
    float* __restrict__ t_out, float* __restrict__ drop_out,
    const int* __restrict__ brickmap, long long* __restrict__ probe_out) {
  constexpr int WARPS = BLOCK / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gt = threadIdx.x;
  const int tile = blockIdx.x;
  int* prefix = smem;
  int* hist = smem + round4(n_prefix);
  int* stage = hist + BLOCK_HIST_ROWS * RADIX_BINS;
  int* list = stage + stage_len;
  int* kept = list + stage_len;
  int* words = kept + kept_len;
  int* counters = words + kept_len;  // [0,2) keys, [2,4) children, [4,6) kept, 6 found
  int* partial = counters + 8;
  CandProbe<PROBE> probe;
  probe.begin(tile);
  long long t = probe.mark();

  // the pyramid prefix in flight while the block builds its frustum
  for (int i = gt; i < n_prefix; i += BLOCK) copy_async(prefix + i, pyr + i);
  Frustum f;
  frustum_of(corners, apex, tile, f);
  for (int i = gt; i < BLOCK_HIST_ROWS * RADIX_BINS; i += BLOCK) hist[i] = 0;
  if (gt < 8) counters[gt] = 0;
  if (gt == 0) kept[0] = 0;  // level 0: the root
  copies_done();
  __syncthreads();
  probe.time(CW_FRUSTUM, t);

  int n_kept = 1, pass = 0, row_sel = 0;
  float drop = INFINITY;
  for (int l = 1; l <= top_depth; ++l) {
    t = probe.mark();
    const Level v = level_exact(f, plan, pyr, l);
    const bool cached = l <= PREFIX_LEVELS;
    const int* level_prefix = prefix + plan.offs[l];
    if (8 * n_kept <= LIGHT_SLOTS) {
      // a light level: the first warp alone, a lane a child slot, and one
      // barrier
      if (warp == 0) {
        if (!cached) {
          for (int p = lane; p < n_kept; p += 32)
            copy_async(words + p, v.words + (kept[p] >> 2));
          copies_done();
          __syncwarp();
        }
        int count = 0;
        unsigned lo = ~0u, hi = 0u;
        for (int b = 0; b < 8 * n_kept; b += 32) {
          const int i = b + lane;
          int key = SENTINEL;
          if (i < 8 * n_kept) {
            const int code = kept[i >> 3];
            const uint32_t word =
                (uint32_t)(cached ? level_prefix[code >> 2] : words[i >> 3]);
            if ((word >> (((code & 3) << 3) + (i & 7))) & 1u)
              key = key_of(f, v, (uint32_t)code * 8u + (uint32_t)(i & 7));
          }
          if (key != SENTINEL) {
            lo = min(lo, (unsigned)key);
            hi = max(hi, (unsigned)key);
          }
          append<1>(key != SENTINEL, key, stage, count, nullptr);
        }
        __syncwarp();
        probe.time(CW_EXPAND + l - 1, t);
        probe.count(CW_VALID, count);
        const int w = plan.width[l];
        int kth = SENTINEL;
        if (count > w) {
          t = probe.mark();
          int light_passes = 0;
          kth = radix_kth<1>(stage, count, w, __reduce_min_sync(FULL, lo),
                             __reduce_max_sync(FULL, hi), hist + 3 * RADIX_BINS,
                             light_passes, nullptr, probe);
          const float t_drop = (float)(kth >> v.code_bits) * v.t_scale;
          drop = t_drop < drop ? t_drop : drop;
          probe.time(CW_SELECT + l - 1, t);
          probe.count(CW_OVER, 1);
        }
        t = probe.mark();
        const int code_mask = l < top_depth ? (1 << v.code_bits) - 1 : -1;
        int n = 0;
        for (int b = 0; b < count; b += 32) {
          const int i = b + lane;
          const int key = i < count ? stage[i] : SENTINEL;
          append<1>(key < kth, key & code_mask, kept, n, nullptr);
        }
        if (lane < 6) counters[lane] = 0;  // the block's counters, idle here
        if (lane == 0) counters[7] = n;
        probe.time(CW_KEEP, t);
      }
      __syncthreads();
      n_kept = counters[7];
      if (l == top_depth) {
        write_ranked<MAPPED>(kept, n_kept, k_max, v, cellmap,
                             (size_t)tile * k_max, codes_out, ids_out, t_out,
                             brickmap, gt, probe);
        if (gt == 0) drop_out[tile] = drop;
      }
      continue;
    }
    if (!cached) {  // every kept cell's word in flight at once; a thread
                    // reads back only the words it asked for
      for (int p = gt; p < n_kept; p += BLOCK)
        copy_async(words + p, v.words + (kept[p] >> 2));
      copies_done();
    }
    // the kept cells' occupied children, listed (a warp's share of them at
    // an offset from an atomicAdd)
    for (int base = warp * 32; base < n_kept; base += BLOCK) {
      const int p = base + lane;
      int code = 0;
      uint32_t occ = 0u;
      if (p < n_kept) {
        code = kept[p];
        const uint32_t word =
            (uint32_t)(cached ? level_prefix[code >> 2] : words[p]);
        occ = (word >> ((code & 3) << 3)) & 0xFFu;
      }
      const int c = __popc(occ);
      const int incl = warp_inclusive_sum(c);
      const int total = __shfl_sync(FULL, incl, 31);
      int b = 0;
      if (lane == 31 && total) b = atomicAdd(counters + 2 + (l & 1), total);
      int at = __shfl_sync(FULL, b, 31) + incl - c;
      for (uint32_t m = occ; m; m &= m - 1u) list[at++] = code * 8 + (__ffs(m) - 1);
    }
    __syncthreads();
    const int n_occ = counters[2 + (l & 1)];
    // the other level's counters were last read before this level's barriers
    if (gt == 0) counters[2 + ((l + 1) & 1)] = 0;

    // cull and key the listed children, two chunks of 32 in flight a warp,
    // the valid keys compacted into stage
    int count = 0;
    unsigned lo = ~0u, hi = 0u;
    for (int base = warp * 64; base < n_occ; base += 64 * WARPS) {
      const int i0 = base + lane, i1 = i0 + 32;
      const int c0 = i0 < n_occ ? list[i0] : -1;
      const int c1 = i1 < n_occ ? list[i1] : -1;
      int k0 = key_of(f, v, (uint32_t)(c0 < 0 ? 0 : c0));
      int k1 = key_of(f, v, (uint32_t)(c1 < 0 ? 0 : c1));
      if (c0 < 0) k0 = SENTINEL;
      if (c1 < 0) k1 = SENTINEL;
      if (k0 != SENTINEL) {
        lo = min(lo, (unsigned)k0);
        hi = max(hi, (unsigned)k0);
      }
      if (k1 != SENTINEL) {
        lo = min(lo, (unsigned)k1);
        hi = max(hi, (unsigned)k1);
      }
      append<WARPS>(k0 != SENTINEL, k0, stage, count, counters + (l & 1));
      append<WARPS>(k1 != SENTINEL, k1, stage, count, counters + (l & 1));
    }
    __syncthreads();
    count = counters[l & 1];
    if (gt == 0) counters[(l + 1) & 1] = 0;
    probe.time(CW_EXPAND + l - 1, t);
    probe.count(CW_VALID, count);

    // select: the width[l] smallest keys, and drop_t from the next one
    const int w = plan.width[l];
    int kth = SENTINEL;  // keys below it are kept
    if (count > w) {
      t = probe.mark();
      group_minmax<WARPS>(lo, hi, partial, row_sel);
      kth = radix_kth<WARPS>(stage, count, w, lo, hi, hist, pass, counters + 6,
                             probe);
      const float t_drop = (float)(kth >> v.code_bits) * v.t_scale;
      drop = t_drop < drop ? t_drop : drop;
      probe.time(CW_SELECT + l - 1, t);
      probe.count(CW_OVER, 1);
    }

    t = probe.mark();
    if (l < top_depth) {
      // keep: the kept keys' codes, in any order
      const int code_mask = (1 << v.code_bits) - 1;
      if (count <= w) {
        for (int i = gt; i < count; i += BLOCK) kept[i] = stage[i] & code_mask;
      } else {
        int n = 0;
        for (int base = warp * 32; base < count; base += 32 * WARPS) {
          const int i = base + lane;
          const int key = i < count ? stage[i] : SENTINEL;
          append<WARPS>(key < kth, key & code_mask, kept, n, counters + 4 + (l & 1));
        }
      }
      n_kept = count > w ? w : count;
      __syncthreads();
      if (gt == 0) counters[4 + ((l + 1) & 1)] = 0;
      probe.time(CW_KEEP, t);
      continue;
    }

    // the finest level: the kept keys, then the row
    const int m = count > w ? w : count;
    const int* keys = stage;
    if (count > w) {
      int n = 0;
      for (int base = warp * 32; base < count; base += 32 * WARPS) {
        const int i = base + lane;
        const int key = i < count ? stage[i] : SENTINEL;
        append<WARPS>(key < kth, key, kept, n, counters + 4 + (l & 1));
      }
      __syncthreads();
      keys = kept;
    }
    probe.time(CW_KEEP, t);
    write_ranked<MAPPED>(keys, m, k_max, v, cellmap, (size_t)tile * k_max,
                         codes_out, ids_out, t_out, brickmap, gt, probe);
    if (gt == 0) drop_out[tile] = drop;
  }
  probe.finish(probe_out);
}

// ---- the packed form: several tiles a warp ----------------------------------
// One warp a tile leaves most lanes idle on a light level (the fly frame's
// tiles see a few children a level), and the launch is bound by the SMs'
// issue of those warps' instructions. The packed form gives a warp TILES
// tiles, tiles g, g + W, g + 2W, ... of the launch's W warps (so that
// neighbouring tiles, which are heavy together, land in other warps), and
// runs their levels as one stream: their kept cells, then their occupied
// children (tagged with the tile's slot in the warp's top two bits), culled
// and keyed 32 at a time with each lane's own tile's frustum from shared
// memory, compacted in place in slot order; each slot's keys are a segment of
// the stream, selected (radix_kth) where they overflow the width and kept.
constexpr int FRUSTUM_WORDS = 24;
struct alignas(16) PackedFrustum {
  Frustum f;
  float pad;
};
static_assert(sizeof(PackedFrustum) == FRUSTUM_WORDS * 4, "a frustum's words");
constexpr int TILES_LIMIT = 4;  // the tag's two bits
// the tiles a warp the radix form packs at one warp a tile: two were the
// fastest or within 4% of the fastest on every call of the streamed frames
// where one and four were measured (PERF.md)
constexpr int PACKED_TILES = 2;
// a packed warp's words besides its rows: each slot's kept count, the offset
// of its keys and its drop_t, for the finest row
constexpr int PACKED_MISC = 3 * TILES_LIMIT;

template <int TILES>
__host__ __device__ constexpr int packed_words(int stage_len, int kept_len) {
  return round4(TILES * FRUSTUM_WORDS + RADIX_BINS + TILES * stage_len +
                2 * TILES * kept_len + PACKED_MISC);
}

// The slot whose segment of the stream holds index i (off: each segment's
// first index, ascending, off[0] = 0).
template <int TILES>
__device__ __forceinline__ int slot_of(int i, const int (&off)[TILES]) {
  int j = 0;
#pragma unroll
  for (int k = 1; k < TILES; ++k) j += i >= off[k];
  return j;
}

// One warp's tiles of the packed form. `smem`: the block's pyramid prefix,
// then each warp's packed_words<TILES> words: its frusta, a histogram row,
// the stream (TILES * stage_len words: the children listed, then their keys
// compacted over them), the kept cells (TILES * kept_len), their pyramid
// words, and PACKED_MISC.
template <int TILES, bool MAPPED, bool PROBE>
__device__ __forceinline__ void packed_tiles(
    int* smem, const int* __restrict__ pyr, const int* __restrict__ cellmap,
    const float* __restrict__ corners, const float* __restrict__ apex, int T,
    int top_depth, int k_max, const Plan& plan, int stage_len, int kept_len,
    int n_prefix, int* __restrict__ codes_out, int* __restrict__ ids_out,
    float* __restrict__ t_out, float* __restrict__ drop_out,
    const int* __restrict__ brickmap, long long* __restrict__ probe_out) {
  static_assert(TILES >= 1 && TILES <= TILES_LIMIT, "two bits of slot");
  const int lane = threadIdx.x & 31;
  const int n_warps = (T + TILES - 1) / TILES;  // slot j of warp g: tile g + j n_warps
  const int g = blockIdx.x + gridDim.x * (threadIdx.x >> 5);
  int* prefix = smem;
  int* base = smem + round4(n_prefix) +
              (threadIdx.x >> 5) * packed_words<TILES>(stage_len, kept_len);
  PackedFrustum* frusta = reinterpret_cast<PackedFrustum*>(base);
  int* hist = base + TILES * FRUSTUM_WORDS;
  int* stage = hist + RADIX_BINS;
  int* kept = stage + TILES * stage_len;
  int* words = kept + TILES * kept_len;
  int* meta = words + TILES * kept_len;
  CandProbe<PROBE> probe;
  if (g < n_warps) probe.begin(g);
  long long t = probe.mark();

  // the block's pyramid prefix in flight while each warp builds its frusta,
  // a lane a slot
  for (int i = threadIdx.x; i < n_prefix; i += BLOCK) copy_async(prefix + i, pyr + i);
  const int tiles = g < n_warps ? min(TILES, (T - g + n_warps - 1) / n_warps) : 0;
  if (lane < tiles) {
    Frustum f;
    frustum_of(corners, apex, g + lane * n_warps, f);
    frusta[lane].f = f;
    kept[lane] = 0;  // the slot's level 0: its root
  }
  for (int i = lane; i < RADIX_BINS; i += 32) hist[i] = 0;
  copies_done();
  __syncthreads();
  if (g >= n_warps) return;  // after the block's one barrier
  probe.time(CW_FRUSTUM, t);

  int nk[TILES];  // each slot's kept cells
  float drop[TILES];
#pragma unroll
  for (int j = 0; j < TILES; ++j) {
    nk[j] = j < tiles ? 1 : 0;
    drop[j] = INFINITY;
  }
  int pass = 0;
  const Frustum f_own = frusta[0].f;  // one tile a warp: its frustum, in registers
  for (int l = 1; l <= top_depth; ++l) {
    t = probe.mark();
    const Level v = level_exact(f_own, plan, pyr, l);  // TILES > 1: pr, fr each lane's
    int off[TILES], np = 0;
#pragma unroll
    for (int j = 0; j < TILES; ++j) {
      off[j] = np;
      np += nk[j];
    }
    const bool cached = l <= PREFIX_LEVELS;
    const int* level_prefix = prefix + plan.offs[l];
    if (!cached) {  // every kept cell's word in flight at once
      for (int p = lane; p < np; p += 32) copy_async(words + p, v.words + (kept[p] >> 2));
      copies_done();
      __syncwarp();
    }
    // a few kept cells (8 np <= 32): a lane a child slot; more: their
    // occupied children listed first, tagged with their slot, in the stream
    // in slot order
    const bool by_slot = 8 * np <= 32;
    int n_occ = by_slot ? 8 * np : 0;
    for (int b = 0; !by_slot && b < np; b += 32) {
      const int p = b + lane;
      int code = 0;
      uint32_t occ = 0u;
      if (p < np) {
        code = kept[p];
        const uint32_t word =
            (uint32_t)(cached ? level_prefix[code >> 2] : words[p]);
        occ = (word >> ((code & 3) << 3)) & 0xFFu;
      }
      const int c = __popc(occ);
      const int incl = warp_inclusive_sum(c);
      int at = n_occ + incl - c;
      n_occ += __shfl_sync(FULL, incl, 31);
      const uint32_t tag = (uint32_t)slot_of<TILES>(p, off) << 30;
      for (uint32_t m = occ; m; m &= m - 1u)
        stage[at++] = (int)(((uint32_t)code * 8u + (uint32_t)(__ffs(m) - 1)) | tag);
    }
    __syncwarp();

    // cull and key them, 32 at a time, each lane with its slot's frustum;
    // the valid keys compacted into the stream (over the list: every lane
    // reads its child before any lane writes), slot order kept
    int cnt[TILES];
#pragma unroll
    for (int j = 0; j < TILES; ++j) cnt[j] = 0;
    int count = 0;
    for (int b = 0; b < n_occ; b += 32) {
      const int i = b + lane;
      bool has = i < n_occ;
      uint32_t child = 0u;
      int j = 0;
      if (by_slot) {
        if (has) {
          const int p = i >> 3, code = kept[p];
          const uint32_t word =
              (uint32_t)(cached ? level_prefix[code >> 2] : words[p]);
          has = (word >> (((code & 3) << 3) + (i & 7))) & 1u;
          child = (uint32_t)code * 8u + (uint32_t)(i & 7);
          j = slot_of<TILES>(p, off);
        }
      } else {
        const uint32_t e = has ? (uint32_t)stage[i] : 0u;
        __syncwarp();
        j = (int)(e >> 30);
        child = e & 0x3FFFFFFFu;
      }
      int key;
      if constexpr (TILES == 1) {
        key = key_of(f_own, v, child);
      } else {
        const Frustum f = frusta[j].f;
        Level lv = v;
#pragma unroll
        for (int a = 0; a < 4; ++a) lv.pr[a] = f.pa_sum[a] * v.half;
        lv.fr = f.fa_sum * v.half;
        key = key_of(f, lv, child);
      }
      const bool take = has && key != SENTINEL;
      const unsigned mask = __ballot_sync(FULL, take);
      if (take) stage[count + __popc(mask & ((1u << lane) - 1u))] = key;
      count += __popc(mask);
      if (TILES == 1) {
        cnt[0] = count;
      } else {
#pragma unroll
        for (int k = 0; k < TILES; ++k) cnt[k] += __popc(__ballot_sync(FULL, take && j == k));
      }
    }
    __syncwarp();
    probe.time(CW_EXPAND + l - 1, t);
    probe.count(CW_VALID, count);

    // select: each slot whose keys overflow the width, its width[l]
    // smallest, and drop_t from the next one
    const int w = plan.width[l];
    int soff[TILES], kth[TILES];
    {
      int s = 0;
#pragma unroll
      for (int j = 0; j < TILES; ++j) {
        soff[j] = s;
        s += cnt[j];
        kth[j] = SENTINEL;  // keys below it are kept
      }
    }
#pragma unroll
    for (int j = 0; j < TILES; ++j) {
      if (cnt[j] > w) {
        t = probe.mark();
        const int* seg = stage + soff[j];
        unsigned lo = ~0u, hi = 0u;
        for (int i = lane; i < cnt[j]; i += 32) {
          lo = min(lo, (unsigned)seg[i]);
          hi = max(hi, (unsigned)seg[i]);
        }
        lo = __reduce_min_sync(FULL, lo);
        hi = __reduce_max_sync(FULL, hi);
        kth[j] = radix_kth<1>(seg, cnt[j], w, lo, hi, hist, pass, nullptr, probe);
        const float t_drop = (float)(kth[j] >> v.code_bits) * v.t_scale;
        drop[j] = t_drop < drop[j] ? t_drop : drop[j];
        probe.time(CW_SELECT + l - 1, t);
        probe.count(CW_OVER, 1);
      }
    }

    // keep: the keys below their slot's kth, codes above the finest level,
    // in slot order
    t = probe.mark();
    const int code_mask = l < top_depth ? (1 << v.code_bits) - 1 : -1;
    int n_kept = 0;
    for (int b = 0; b < count; b += 32) {
      const int i = b + lane;
      const int key = i < count ? stage[i] : SENTINEL;
      const int j = slot_of<TILES>(i, soff);
      int below = kth[0];
#pragma unroll
      for (int k = 1; k < TILES; ++k) below = j == k ? kth[k] : below;
      const bool take = i < count && key < below;
      const unsigned mask = __ballot_sync(FULL, take);
      if (take) kept[n_kept + __popc(mask & ((1u << lane) - 1u))] = key & code_mask;
      n_kept += __popc(mask);
    }
#pragma unroll
    for (int j = 0; j < TILES; ++j) nk[j] = cnt[j] > w ? w : cnt[j];
    __syncwarp();
    probe.time(CW_KEEP, t);
  }

  // the finest level: each slot's row
  if (lane == 0) {
    int ko = 0;
#pragma unroll
    for (int j = 0; j < TILES; ++j) {
      meta[j] = nk[j];
      meta[TILES_LIMIT + j] = ko;
      meta[2 * TILES_LIMIT + j] = __float_as_int(drop[j]);
      ko += nk[j];
    }
  }
  __syncwarp();
  const Level v = level_exact(f_own, plan, pyr, top_depth);
#pragma unroll 1
  for (int j = 0; j < tiles; ++j) {
    const int tile = g + j * n_warps;
    const int m = meta[j];
    const int* keys = kept + meta[TILES_LIMIT + j];
    const size_t row = (size_t)tile * k_max;
    if (m <= 32)
      write_row<1, MAPPED>(keys, m, k_max, v, cellmap, row, codes_out, ids_out,
                           t_out, brickmap, probe);
    else if (m <= 64)
      write_row<2, MAPPED>(keys, m, k_max, v, cellmap, row, codes_out, ids_out,
                           t_out, brickmap, probe);
    else if (m <= 128)
      write_row<4, MAPPED>(keys, m, k_max, v, cellmap, row, codes_out, ids_out,
                           t_out, brickmap, probe);
    else
      write_row<8, MAPPED>(keys, m, k_max, v, cellmap, row, codes_out, ids_out,
                           t_out, brickmap, probe);
    if (lane == 0) drop_out[tile] = __int_as_float(meta[2 * TILES_LIMIT + j]);
  }
  probe.finish(probe_out);
}

template <int FORM, int WARPS, int TILES>
__host__ __device__ constexpr int group_words(int stage_len, int kept_len) {
  return FORM == FORM_SELECT ? stage_len + kept_len + MISC
         : WARPS == 1        ? packed_words<TILES>(stage_len, kept_len)
                             : round4(BLOCK_HIST_ROWS * RADIX_BINS + 2 * stage_len +
                                      2 * kept_len + RADIX_MISC);
}

// The radix form: a block a tile (block_tile) or TILES tiles a warp
// (packed_tiles) without the probe, at most 64 registers a thread as the
// search form.
template <int WARPS, bool MAPPED, int TILES>
__global__ void __launch_bounds__(BLOCK, 4)
tile_candidates_radix_kernel(const int* __restrict__ pyr,
                             const int* __restrict__ cellmap,
                             const float* __restrict__ corners,
                             const float* __restrict__ apex, int T,
                             int top_depth, int k_max, Plan plan, int stage_len,
                             int kept_len, int n_prefix,
                             int* __restrict__ codes_out,
                             int* __restrict__ ids_out,
                             float* __restrict__ t_out,
                             float* __restrict__ drop_out,
                             const int* __restrict__ brickmap) {
  extern __shared__ __align__(16) int radix_smem[];
  if constexpr (WARPS > 1)
    block_tile<MAPPED, false>(radix_smem, pyr, cellmap, corners, apex, T,
                              top_depth, k_max, plan, stage_len, kept_len,
                              n_prefix, codes_out, ids_out, t_out, drop_out,
                              brickmap, nullptr);
  else
    packed_tiles<TILES, MAPPED, false>(radix_smem, pyr, cellmap, corners, apex,
                                       T, top_depth, k_max, plan, stage_len,
                                       kept_len, n_prefix, codes_out, ids_out,
                                       t_out, drop_out, brickmap, nullptr);
}

// The probe form: either form (FORM) with each warp's record (CandProbe)
// written to `probe_out`, for measurement only.
template <int WARPS, bool MAPPED, int FORM, int TILES>
__global__ void __launch_bounds__(BLOCK, 4)
tile_candidates_probe_kernel(const int* __restrict__ pyr,
                             const int* __restrict__ cellmap,
                             const float* __restrict__ corners,
                             const float* __restrict__ apex, int T,
                             int top_depth, int k_max, Plan plan, int stage_len,
                             int kept_len, int n_prefix,
                             int* __restrict__ codes_out,
                             int* __restrict__ ids_out,
                             float* __restrict__ t_out,
                             float* __restrict__ drop_out,
                             const int* __restrict__ brickmap,
                             long long* __restrict__ probe_out) {
  extern __shared__ __align__(16) int probe_smem[];
  if constexpr (FORM == FORM_SELECT)
    select_tile<WARPS, MAPPED, true>(probe_smem, pyr, cellmap, corners, apex, T,
                                     top_depth, k_max, plan, stage_len, kept_len,
                                     codes_out, ids_out, t_out, drop_out,
                                     brickmap, probe_out);
  else if constexpr (WARPS > 1)
    block_tile<MAPPED, true>(probe_smem, pyr, cellmap, corners, apex, T,
                             top_depth, k_max, plan, stage_len, kept_len,
                             n_prefix, codes_out, ids_out, t_out, drop_out,
                             brickmap, probe_out);
  else
    packed_tiles<TILES, MAPPED, true>(probe_smem, pyr, cellmap, corners, apex, T,
                                      top_depth, k_max, plan, stage_len, kept_len,
                                      n_prefix, codes_out, ids_out, t_out,
                                      drop_out, brickmap, probe_out);
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

// A group's staging words (8 * the widest width above the finest level) and
// kept words (the widest width) for `plan`.
void group_lens(const Plan& plan, int top_depth, int& stage_len, int& kept_len) {
  stage_len = 0;
  kept_len = 1;
  for (int l = 1; l <= top_depth; ++l) {
    stage_len = max(stage_len, 8 * plan.width[l - 1]);
    kept_len = max(kept_len, plan.width[l]);
  }
}

// Launches `kernel` on `groups` groups of WARPS warps in blocks of BLOCK
// threads, with `block_words` words of dynamic shared memory a block and
// `words` more a group.
template <int WARPS, typename K, typename... A>
int launch_groups(K kernel, int words, int block_words, int groups,
                  cudaStream_t stream, A... args) {
  constexpr int GROUPS = BLOCK / 32 / WARPS;
  const size_t bytes = ((size_t)GROUPS * words + block_words) * sizeof(int);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(groups + GROUPS - 1) / GROUPS, BLOCK, bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

// One form's launch: the search form's kernel (FORM_SELECT), the radix form's (a block
// a tile, or TILES tiles a warp), or with a `probe` record either one's
// probe form.
template <int WARPS, bool MAPPED, int FORM, int TILES>
int launch_form(const void* pyr, const void* cellmap, const void* corners,
                const void* apex, int T, int top_depth, int k_max,
                const Plan& plan, void* codes, void* ids, void* t_codes,
                void* drop_t, const void* brickmap, void* probe,
                cudaStream_t stream) {
  int stage_len, kept_len;
  group_lens(plan, top_depth, stage_len, kept_len);
  const int words = group_words<FORM, WARPS, TILES>(stage_len, kept_len);
  const int n_prefix = FORM == FORM_RADIX ? prefix_words(top_depth) : 0;
  const int groups = (T + TILES - 1) / TILES;
  if constexpr (FORM == FORM_SELECT) {
    if (probe == nullptr)
      return launch_groups<WARPS>(
          tile_candidates_kernel<WARPS, MAPPED>, words, 0, T, stream,
          (const int*)pyr, (const int*)cellmap, (const float*)corners,
          (const float*)apex, T, top_depth, k_max, plan, stage_len, kept_len,
          (int*)codes, (int*)ids, (float*)t_codes, (float*)drop_t,
          (const int*)brickmap);
  } else {
    if (probe == nullptr)
      return launch_groups<WARPS>(
          tile_candidates_radix_kernel<WARPS, MAPPED, TILES>, words,
          round4(n_prefix), groups, stream, (const int*)pyr,
          (const int*)cellmap, (const float*)corners, (const float*)apex, T,
          top_depth, k_max, plan, stage_len, kept_len, n_prefix, (int*)codes,
          (int*)ids, (float*)t_codes, (float*)drop_t, (const int*)brickmap);
  }
  return launch_groups<WARPS>(
      tile_candidates_probe_kernel<WARPS, MAPPED, FORM, TILES>, words,
      round4(n_prefix), groups, stream, (const int*)pyr, (const int*)cellmap,
      (const float*)corners, (const float*)apex, T, top_depth, k_max, plan,
      stage_len, kept_len, n_prefix, (int*)codes, (int*)ids, (float*)t_codes,
      (float*)drop_t, (const int*)brickmap, (long long*)probe);
}

using Launch = int (*)(const void*, const void*, const void*, const void*, int,
                       int, int, const Plan&, void*, void*, void*, void*,
                       const void*, void*, cudaStream_t);
// the search form at one and at eight warps a tile
template <bool MAPPED>
constexpr Launch SELECT_LAUNCH[2] = {launch_form<1, MAPPED, FORM_SELECT, 1>,
                                     launch_form<8, MAPPED, FORM_SELECT, 1>};
// the radix form at one warp (PACKED_TILES tiles a warp) and at eight
template <bool MAPPED>
constexpr Launch RADIX_LAUNCH[2] = {launch_form<1, MAPPED, FORM_RADIX, PACKED_TILES>,
                                    launch_form<8, MAPPED, FORM_RADIX, 1>};

// The C entries' one body: `form` in the brickmap mode where `brickmap` is
// not null (`mapped`: it must be), `warps` warps a tile (1 or 8), through
// the probe form where `probe` is not null.
int candidates_entry(int form, bool mapped, const void* pyr,
                     const void* cellmap, const void* brickmap,
                     const void* corners, const void* apex, int T,
                     int top_depth, const int* widths, int k_max, int warps,
                     void* codes, void* ids, void* t_codes, void* drop_t,
                     void* probe, void* stream) {
  Plan plan;
  if (!make_plan(T, top_depth, widths, k_max, plan) || (warps != 1 && warps != 8) ||
      (form != FORM_SELECT && form != FORM_RADIX) || mapped != (brickmap != nullptr))
    return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaGetLastError();
  const Launch launch =
      form == FORM_SELECT
          ? (mapped ? SELECT_LAUNCH<true> : SELECT_LAUNCH<false>)[warps == 8]
          : (mapped ? RADIX_LAUNCH<true> : RADIX_LAUNCH<false>)[warps == 8];
  return launch(pyr, cellmap, corners, apex, T, top_depth, k_max, plan, codes,
                ids, t_codes, drop_t, brickmap, probe, (cudaStream_t)stream);
}

}  // namespace

// widths: top_depth + 1 ints in host memory (make_plan). warps: the warps a
// tile, 1 or 8. The search form, unmapped: the tile frame's main path.
extern "C" int tile_candidates(const void* pyr, const void* cellmap,
                               const void* corners, const void* apex, int T,
                               int top_depth, const int* widths, int k_max,
                               int warps, void* codes, void* ids,
                               void* t_codes, void* drop_t, void* stream) {
  return candidates_entry(FORM_SELECT, false, pyr, cellmap, nullptr, corners,
                          apex, T, top_depth, widths, k_max, warps, codes, ids,
                          t_codes, drop_t, nullptr, stream);
}

// The radix form, unmapped: off every path, measured beside the search form.
extern "C" int tile_candidates_radix(const void* pyr, const void* cellmap,
                                     const void* corners, const void* apex,
                                     int T, int top_depth, const int* widths,
                                     int k_max, int warps, void* codes,
                                     void* ids, void* t_codes, void* drop_t,
                                     void* stream) {
  return candidates_entry(FORM_RADIX, false, pyr, cellmap, nullptr, corners,
                          apex, T, top_depth, widths, k_max, warps, codes, ids,
                          t_codes, drop_t, nullptr, stream);
}

// The brickmap mode, the streamed world's phase 1, in the radix form: each
// brick id is brickmap[the morton rank], a row of a streaming arena's
// bricks (the reference's remap of _candidates' ids,
// stream/clipmap.py::_trace_clipmap_tile through ops/tile.py::_trace_tile
// :880-882 and _trace_tile_fb :1102-1108). `brickmap` holds at least as many
// ints as the pyramid has occupied cells.
extern "C" int tile_candidates_mapped(const void* pyr, const void* cellmap,
                                      const void* brickmap, const void* corners,
                                      const void* apex, int T, int top_depth,
                                      const int* widths, int k_max, int warps,
                                      void* codes, void* ids, void* t_codes,
                                      void* drop_t, void* stream) {
  return candidates_entry(FORM_RADIX, true, pyr, cellmap, brickmap, corners,
                          apex, T, top_depth, widths, k_max, warps, codes, ids,
                          t_codes, drop_t, nullptr, stream);
}

// The brickmap mode's first form: the search form in the brickmap mode, the
// streamed world's phase 1 before the radix form; checks and probe runs
// launch it, no main path does.
extern "C" int tile_candidates_mapped_first(
    const void* pyr, const void* cellmap, const void* brickmap,
    const void* corners, const void* apex, int T, int top_depth,
    const int* widths, int k_max, int warps, void* codes, void* ids,
    void* t_codes, void* drop_t, void* stream) {
  return candidates_entry(FORM_SELECT, true, pyr, cellmap, brickmap, corners,
                          apex, T, top_depth, widths, k_max, warps, codes, ids,
                          t_codes, drop_t, nullptr, stream);
}

// The probe form of `form` (FORM_SELECT, FORM_RADIX), in the brickmap mode
// where `brickmap` is not null: the outputs and, in `probe`, CW_WORDS int64
// words for each warp of the launch (blocks of 8 warps: ceil(T / 8) at one
// warp a tile in the search form, ceil(T / (8 * PACKED_TILES)) in the radix
// form, T at eight), zeroed by the caller.
extern "C" int tile_candidates_probe(int form, const void* pyr,
                                     const void* cellmap, const void* brickmap,
                                     const void* corners, const void* apex,
                                     int T, int top_depth, const int* widths,
                                     int k_max, int warps, void* codes,
                                     void* ids, void* t_codes, void* drop_t,
                                     void* probe, void* stream) {
  if (probe == nullptr) return (int)cudaErrorInvalidValue;
  return candidates_entry(form, brickmap != nullptr, pyr, cellmap, brickmap,
                          corners, apex, T, top_depth, widths, k_max, warps,
                          codes, ids, t_codes, drop_t, probe, stream);
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

