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
//                    (q << 3l) | child (2^31 - 1 for a culled child), sort,
//                    keep the first width[l] keys and lower drop_t by the next
//                    one. The finest level writes the tile's codes, brick ids
//                    (cellmap's prefix popcount), t lower bounds and drop_t.
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
// The sort: a child appears once in its tile's list, so every key but the
// sentinel is unique, and any correct ascending sort of the int32 keys gives
// the plain version's order; equal sentinels cannot be told apart.
//
// The widths come from the host (ops/tile_cuda.py::level_widths): width[0] = 1
// and width[l] = min(cap_l, 8 * width[l-1]), cap_l = min(caps[l], 8^l) but
// min(k_max, 8^l) at the finest level. A level drops keys, and lowers drop_t,
// exactly when width[l] < 8 * width[l-1].
//
// Design: one block a tile. The previous level's kept codes stay in shared
// memory; each thread expands some of the 8 * width[l-1] children and writes
// their keys into a shared array padded with the sentinel to the next power
// of two (at most 2,048 keys, 8 KB), which a bitonic network sorts in place.
// What bounds it on this card: neither bytes (a tile reads 48 B of corners
// and a word a kept cell, and writes 12 B a candidate) nor arithmetic (some
// hundred operations a child), but the block's chain of barriers: a sort of
// n keys takes log2(n) (log2(n) + 1) / 2 passes, each ended by
// __syncthreads, and a level cannot start before the last one is sorted.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int LEVELS = 11;              // levels 0..10 (top_depth <= 10)
constexpr int WIDTH_LIMIT = 256;        // k_max and every level's width
constexpr int SORT_LIMIT = 8 * WIDTH_LIMIT;
constexpr int BLOCK = 256;
constexpr int SENTINEL = 0x7fffffff;

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
tile_candidates_kernel(const int* __restrict__ pyr,
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
  float c[4][3];
  const float* tc = corners + (size_t)tile * 12;
  for (int j = 0; j < 4; ++j)
    for (int a = 0; a < 3; ++a) c[j][a] = __ldg(tc + j * 3 + a);
  float fwd[3];
  for (int a = 0; a < 3; ++a) fwd[a] = ((c[0][a] + c[1][a]) + c[2][a]) + c[3][a];
  float pl[4][3], pa_sum[4];
  for (int j = 0; j < 4; ++j) {
    const float* u = c[j];
    const float* v = c[(j + 1) & 3];
    const float n0 = u[1] * v[2] - u[2] * v[1];
    const float n1 = u[2] * v[0] - u[0] * v[2];
    const float n2 = u[0] * v[1] - u[1] * v[0];
    const float s = sign_or_one((n0 * fwd[0] + n1 * fwd[1]) + n2 * fwd[2]);
    pl[j][0] = n0 * s;
    pl[j][1] = n1 * s;
    pl[j][2] = n2 * s;
    pa_sum[j] = (fabsf(pl[j][0]) + fabsf(pl[j][1])) + fabsf(pl[j][2]);
  }
  const float fa_sum = (fabsf(fwd[0]) + fabsf(fwd[1])) + fabsf(fwd[2]);
  const float ox = __ldg(apex), oy = __ldg(apex + 1), oz = __ldg(apex + 2);

  if (tid == 0) prev[0] = 0;  // level 0: the root
  float drop = INFINITY;      // thread 0's
  __syncthreads();

  for (int l = 1; l <= top_depth; ++l) {
    const int n = 8 * plan.width[l - 1];
    int n2 = 8;
    while (n2 < n) n2 <<= 1;
    const float half = 1.0f / (float)(1 << (l + 1));
    const float cell = 1.0f / (float)(1 << l);
    const int code_bits = 3 * l;
    const int qbits = 30 - code_bits > 0 ? 30 - code_bits : 0;
    const int qmax = qbits ? (1 << qbits) - 2 : 0;
    const float q_scale = (float)(1 << qbits) / 4.0f;  // exact powers of two
    const float t_scale = 4.0f / (float)(1 << qbits);
    float pr[4];
    for (int j = 0; j < 4; ++j) pr[j] = pa_sum[j] * half;
    const float fr = fa_sum * half;
    const int* words = pyr + plan.offs[l];

    for (int i = tid; i < n2; i += BLOCK) {
      int key = SENTINEL;
      const int parent = i < n ? prev[i >> 3] : -1;
      if (parent >= 0) {
        const int oct = i & 7;
        const uint32_t word = (uint32_t)__ldg(words + (parent >> 2));
        if ((word >> (((parent & 3) << 3) + oct)) & 1u) {
          const uint32_t child = (uint32_t)parent * 8u + (uint32_t)oct;
          const float rx = ((float)compact3_10(child) * cell + half) - ox;
          const float ry = ((float)compact3_10(child >> 1) * cell + half) - oy;
          const float rz = ((float)compact3_10(child >> 2) * cell + half) - oz;
          bool keep = true;
          for (int j = 0; j < 4; ++j) {
            const float pd = (pl[j][0] * rx + pl[j][1] * ry) + pl[j][2] * rz;
            keep = keep && (pd + pr[j] >= 0.0f);
          }
          const float fd = (fwd[0] * rx + fwd[1] * ry) + fwd[2] * rz;
          keep = keep && (fd + fr >= 0.0f);
          if (keep) {
            float ax = fabsf(rx) - half, ay = fabsf(ry) - half, az = fabsf(rz) - half;
            ax = ax < 0.0f ? 0.0f : ax;
            ay = ay < 0.0f ? 0.0f : ay;
            az = az < 0.0f ? 0.0f : az;
            const float t_lb = __fsqrt_rn((ax * ax + ay * ay) + az * az);
            float scaled = t_lb * q_scale;
            scaled = scaled > 1073741824.0f ? 1073741824.0f : scaled;
            int q = (int)scaled;
            q = q < 0 ? 0 : (q > qmax ? qmax : q);
            key = (q << code_bits) | (int)child;
          }
        }
      }
      keys[i] = key;
    }
    __syncthreads();
    block_sort(keys, n2);

    const int w = plan.width[l];
    if (tid == 0 && w < n) {  // the level dropped keys[w, n)
      const int nxt = keys[w];
      if (nxt != SENTINEL) {
        const float t_drop = (float)(nxt >> code_bits) * t_scale;
        drop = t_drop < drop ? t_drop : drop;
      }
    }
    const int code_mask = (1 << code_bits) - 1;
    if (l < top_depth) {
      for (int i = tid; i < w; i += BLOCK)
        prev[i] = keys[i] == SENTINEL ? -1 : keys[i] & code_mask;
      __syncthreads();
      continue;
    }
    // the finest level: the tile's row, padded to k_max with (-1, -1, inf)
    const size_t row = (size_t)tile * k_max;
    for (int i = tid; i < k_max; i += BLOCK) {
      const int key = i < w ? keys[i] : SENTINEL;
      int code = -1, id = -1;
      float t = INFINITY;
      if (key != SENTINEL) {
        code = key & code_mask;
        t = (float)(key >> code_bits) * t_scale;
        const int cm = (code >> 5) * 2;
        const uint32_t below = (1u << (code & 31)) - 1u;
        id = __ldg(cellmap + cm) + __popc((uint32_t)__ldg(cellmap + cm + 1) & below);
      }
      codes_out[row + i] = code;
      ids_out[row + i] = id;
      t_out[row + i] = t;
    }
  }
  if (tid == 0) drop_out[tile] = drop;
}

}  // namespace

// widths: top_depth + 1 ints in host memory, width[0] = 1 and
// 1 <= width[l] <= min(WIDTH_LIMIT, 8 * width[l-1]), width[top_depth] <= k_max.
extern "C" int tile_candidates(const void* pyr, const void* cellmap,
                               const void* corners, const void* apex, int T,
                               int top_depth, const int* widths, int k_max,
                               void* codes, void* ids, void* t_codes,
                               void* drop_t, void* stream) {
  if (T < 0 || top_depth < 1 || top_depth >= LEVELS || k_max < 1 ||
      k_max > WIDTH_LIMIT || widths == nullptr || widths[0] != 1 ||
      widths[top_depth] > k_max)
    return (int)cudaErrorInvalidValue;
  Plan plan = {};
  plan.width[0] = 1;
  int words = 0;
  for (int l = 1; l <= top_depth; ++l) {
    if (widths[l] < 1 || widths[l] > WIDTH_LIMIT || widths[l] > 8 * widths[l - 1])
      return (int)cudaErrorInvalidValue;
    plan.width[l] = widths[l];
    plan.offs[l] = words;  // ops/tile.py::_pyr_layout
    const int level_words = (1 << (3 * l)) / 32;
    words += level_words > 1 ? level_words : 1;
  }
  if (T > 0) {
    tile_candidates_kernel<<<T, BLOCK, 0, (cudaStream_t)stream>>>(
        (const int*)pyr, (const int*)cellmap, (const float*)corners,
        (const float*)apex, top_depth, k_max, plan, (int*)codes, (int*)ids,
        (float*)t_codes, (float*)drop_t);
  }
  return (int)cudaGetLastError();
}
