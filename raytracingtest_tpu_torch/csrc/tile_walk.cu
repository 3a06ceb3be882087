// The tile walker and its two primitives for Hopper, sm_90a: three kernels
// that share one DDA step and one row read.
//
//   tile_walk    replaces what raytracingtest_tpu/ops/tile.py computes in
//                _walk_chunk_window (:432) and _resolve_hits (:691): every
//                ray walks its tile's t-ascending list of candidate bricks
//                with its own cursor, runs the exact 8^3 voxel DDA in each
//                brick it enters, and resolves its hit's leaf id.
//   brick_dda16  replaces scratch/r4_pallas2.py::pallas_version (:115, body
//                `kernel` :70): STEPS masked DDA steps over pre-staged
//                per-ray state. It is tile_walk's inner loop on its own.
//   rowread      replaces scratch/r4_pallas.py::dynrow, dynrow2, dynrow3 and
//                dynrow8 (:38-:103): one row of a resident int32 table at an
//                index learned at run time (a scalar argument; the minimum
//                of a block of cursors; one index per block), a batch of
//                such requests a launch. It is the read tile_walk stages its
//                candidates with.
//
// Semantics follow the plain PyTorch versions bit for bit
// (raytracingtest_tpu_torch/ops/tile.py::walk_plain,
// ops/brick_dda.py::dda_steps, ops/rowread.py). The reference's walker is a
// lockstep loop over chunks of tiles with a ring buffer of candidates; that
// is scheduling for a machine whose lanes cannot read memory on their own
// and none of it is here. One block per tile, one thread per ray, P threads:
// the block stages its tile's candidate list (ids, codes, t lower bounds,
// K <= 256) and those bricks' 16 occupancy words in shared memory (19 KB),
// then each thread walks the list alone. The loop is bounded by
// construction: K candidates, at most 3*7+1 steps a brick.
//
// What bounds it on this card: not bytes (24 B of rays in and 12 B out a
// ray, plus K*64 B of words a tile) and not FLOPs. It is a divergent
// per-thread loop: the 32 rays of a warp enter different bricks and take
// different numbers of steps, so a warp runs as long as its slowest ray, and
// every step is a short chain of dependent integer and float operations fed
// from shared memory. This first version is simple and right; staging only
// the candidates a tile's rays reach, and balancing rays across warps, are
// later work.
//
// Rounding: built with --fmad=false, so pos*t_coef - t_bias and
// half*t_coef + t_corner round in two steps, as the plain versions' separate
// tensor ops do; -1/|d| is an IEEE division. Occupancy words are uint32_t
// here (the port carries them as int32 bit patterns).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int S_MAX = 23;
constexpr int K_LIMIT = 256;   // candidates a block stages
constexpr int P_LIMIT = 256;   // rays (threads) a block holds
constexpr int ROW_WORDS = 17;  // a brick row: 16 occupancy words + first leaf id
constexpr int DDA_STAY = 0, DDA_HIT = 1, DDA_EXIT = 2;

__device__ __forceinline__ uint32_t compact3_10(uint32_t x) {
  x &= 0x9249249u;
  x = (x | (x >> 2)) & 0x30C30C3u;
  x = (x | (x >> 4)) & 0x300F00Fu;
  x = (x | (x >> 8)) & 0x30000FFu;
  x = (x | (x >> 16)) & 0x3FFu;
  return x;
}

__device__ __forceinline__ int spread3(int x) {
  return (x & 1) | ((x & 2) << 2) | ((x & 4) << 4);
}

// Word `c` of row `row` of a table with `stride` words a row: the one read
// that rowread serves and tile_walk stages with.
__device__ __forceinline__ int row_word(const int* __restrict__ table,
                                        int stride, int row, int c) {
  return __ldg(table + (size_t)row * stride + c);
}

// One step of the exact voxel DDA inside an 8^3 brick. bpos is the mirrored
// lower corner of the ray's current voxel; flip[c] is 0 on a mirrored axis,
// else 7; word_of(w) gives the brick's occupancy word w. An occupied voxel is
// a hit only while t_cur < hit_t, otherwise the ray steps on. Leaves idx9
// (the voxel's bit index in the brick) for the caller.
template <typename WordFn>
__device__ __forceinline__ int dda_step(float bpos[3], float& t_cur,
                                        const float t_coef[3],
                                        const float t_bias[3],
                                        const int flip[3], int vshift,
                                        float vsize, float hit_t,
                                        WordFn word_of, int& idx9) {
  int li[3];
  for (int c = 0; c < 3; ++c) li[c] = (__float_as_int(bpos[c]) >> vshift) & 7;
  idx9 = spread3(li[0] ^ flip[0]) | (spread3(li[1] ^ flip[1]) << 1) |
         (spread3(li[2] ^ flip[2]) << 2);
  const uint32_t w = word_of(idx9 >> 5);
  if (((w >> (idx9 & 31)) & 1u) && t_cur < hit_t) return DDA_HIT;

  float tc[3];
  for (int c = 0; c < 3; ++c) tc[c] = bpos[c] * t_coef[c] - t_bias[c];
  const float tc_max = fminf(fminf(tc[0], tc[1]), tc[2]);
  bool exit_b = false;
  for (int c = 0; c < 3; ++c) exit_b = exit_b || (tc[c] <= tc_max && li[c] == 0);
  t_cur = fmaxf(t_cur, tc_max);
  if (exit_b) return DDA_EXIT;
  for (int c = 0; c < 3; ++c) {
    if (tc[c] <= tc_max) bpos[c] = bpos[c] - vsize;
  }
  return DDA_STAY;
}

__global__ void __launch_bounds__(P_LIMIT)
tile_walk_kernel(const int* __restrict__ bricks, const float* __restrict__ o,
                 const float* __restrict__ d, const int* __restrict__ codes,
                 const int* __restrict__ ids,
                 const float* __restrict__ t_codes, int K, int depth,
                 int top_depth, int* __restrict__ hit_leaf,
                 float* __restrict__ hit_t_out, int* __restrict__ iters_out) {
  __shared__ int s_ids[K_LIMIT];
  __shared__ int s_codes[K_LIMIT];
  __shared__ float s_tlb[K_LIMIT];
  __shared__ uint32_t s_words[K_LIMIT * 16];

  const int tid = threadIdx.x;
  const size_t cbase = (size_t)blockIdx.x * K;
  for (int k = tid; k < K; k += blockDim.x) {
    s_ids[k] = ids[cbase + k];
    s_codes[k] = codes[cbase + k];
    s_tlb[k] = t_codes[cbase + k];
  }
  __syncthreads();
  for (int j = tid; j < K * 16; j += blockDim.x) {
    const int id = s_ids[j >> 4];
    s_words[j] = id >= 0 ? (uint32_t)row_word(bricks, ROW_WORDS, id, j & 15) : 0u;
  }
  __syncthreads();

  // ---- ray setup: mirroring and root-cube entry (ops/traverse.py::ray_setup)
  const size_t ray = (size_t)blockIdx.x * blockDim.x + tid;
  const float eps = 1.0f / 8388608.0f;  // 2^-S_MAX
  float t_coef[3], t_bias[3];
  int om = 7;
  for (int c = 0; c < 3; ++c) {
    const float oc = o[3 * ray + c] + 1.0f;
    float dc = d[3 * ray + c];
    if (fabsf(dc) < eps) dc = dc >= 0.0f ? eps : -eps;
    t_coef[c] = -1.0f / fabsf(dc);
    t_bias[c] = t_coef[c] * oc;
    if (dc > 0.0f) {
      om ^= 1 << c;
      t_bias[c] = 3.0f * t_coef[c] - t_bias[c];
    }
  }
  float t0 = fmaxf(fmaxf(2.0f * t_coef[0] - t_bias[0],
                         2.0f * t_coef[1] - t_bias[1]),
                   2.0f * t_coef[2] - t_bias[2]);
  const float t_max = fminf(fminf(t_coef[0] - t_bias[0], t_coef[1] - t_bias[1]),
                            t_coef[2] - t_bias[2]);
  t0 = fmaxf(t0, 0.0f);
  const bool miss0 = t0 >= t_max;  // never enters the root cube

  int flip[3];
  for (int c = 0; c < 3; ++c) flip[c] = ((om >> c) & 1) ? 0 : 7;
  const int vshift = S_MAX - depth;
  const float vsize = __int_as_float((127 - depth) << 23);      // 2^-depth
  const float bsize = __int_as_float((127 - top_depth) << 23);  // 2^-top_depth
  const int s = (1 << top_depth) - 1;

  int it = 0, hit_bid = -1, hit_idx9 = 0;
  float hit_t = INFINITY;
  int k = 0;
  while (!miss0 && k < K) {
    const int id = s_ids[k];
    if (id < 0 || s_tlb[k] >= hit_t) break;  // nothing later can beat the hit

    // box test against the candidate's mirrored corner
    const uint32_t code = (uint32_t)s_codes[k];
    float pos_b[3], t_hi[3], t_lo[3];
    for (int c = 0; c < 3; ++c) {
      const int cc = (int)compact3_10(code >> c);
      const int m = ((om >> c) & 1) ? cc : s - cc;
      pos_b[c] = 1.0f + (float)m * bsize;
      t_hi[c] = (pos_b[c] + bsize) * t_coef[c] - t_bias[c];
      t_lo[c] = pos_b[c] * t_coef[c] - t_bias[c];
    }
    const float t_in = fmaxf(fmaxf(fmaxf(t_hi[0], t_hi[1]), t_hi[2]), t0);
    const float t_out = fminf(fminf(t_lo[0], t_lo[1]), t_lo[2]);
    if (!(t_in < t_out && t_in < hit_t)) {
      ++k;
      continue;
    }

    // three-level plane descent to the entry voxel
    float bpos[3] = {pos_b[0], pos_b[1], pos_b[2]};
    float half = bsize;
    for (int l = 0; l < 3; ++l) {
      half *= 0.5f;
      for (int c = 0; c < 3; ++c) {
        const float t_center = half * t_coef[c] + (bpos[c] * t_coef[c] - t_bias[c]);
        if (t_center > t_in) bpos[c] = bpos[c] + half;
      }
    }

    // the exact DDA, to a hit or the brick's exit (at most 3*7+1 steps)
    float t_cur = t_in;
    const uint32_t* words = s_words + k * 16;
    auto word_of = [words](int w) { return words[w]; };
    for (int step = 0; step < 24; ++step) {
      ++it;
      int idx9;
      const int what = dda_step(bpos, t_cur, t_coef, t_bias, flip, vshift,
                                vsize, hit_t, word_of, idx9);
      if (what == DDA_HIT) {
        hit_bid = id;
        hit_idx9 = idx9;
        hit_t = t_cur;
      }
      if (what != DDA_STAY) break;
    }
    ++k;
  }

  // epilogue: leaf id = the brick's first leaf + set bits below the hit's bit
  int leaf = -1;
  if (hit_bid >= 0) {
    const int wsel = hit_idx9 >> 5;
    int below = 0;
    for (int w = 0; w < wsel; ++w)
      below += __popc((uint32_t)row_word(bricks, ROW_WORDS, hit_bid, w));
    const uint32_t word = (uint32_t)row_word(bricks, ROW_WORDS, hit_bid, wsel);
    below += __popc(word & ((1u << (hit_idx9 & 31)) - 1u));
    leaf = row_word(bricks, ROW_WORDS, hit_bid, 16) + below;
  }
  hit_leaf[ray] = leaf;
  hit_t_out[ray] = hit_bid >= 0 ? hit_t : 0.0f;
  iters_out[ray] = it;
}

// One thread per ray; the 16 word planes rw[w * n + i] put neighbouring
// threads on neighbouring addresses.
__global__ void __launch_bounds__(256)
brick_dda16_kernel(const float* __restrict__ bpos_in,
                   const float* __restrict__ t_cur_in,
                   const int* __restrict__ walking_in,
                   const int* __restrict__ rw, const float* __restrict__ tc_in,
                   const float* __restrict__ tb_in,
                   const int* __restrict__ flip_in,
                   const float* __restrict__ hit_t_in, int n, int depth,
                   int steps, float* __restrict__ hit_t_out,
                   int* __restrict__ hit_idx9_out,
                   float* __restrict__ t_cur_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float bpos[3], t_coef[3], t_bias[3];
  int flip[3];
  for (int c = 0; c < 3; ++c) {
    bpos[c] = bpos_in[3 * (size_t)i + c];
    t_coef[c] = tc_in[3 * (size_t)i + c];
    t_bias[c] = tb_in[3 * (size_t)i + c];
    flip[c] = flip_in[3 * (size_t)i + c];
  }
  float t_cur = t_cur_in[i];
  float hit_t = hit_t_in[i];
  bool walking = walking_in[i] != 0;
  int hit_idx9 = 0;
  const int vshift = S_MAX - depth;
  const float vsize = __int_as_float((127 - depth) << 23);  // 2^-depth
  auto word_of = [rw, n, i](int w) {
    return (uint32_t)__ldg(rw + (size_t)w * n + i);
  };
  for (int step = 0; step < steps && walking; ++step) {
    int idx9;
    const int what = dda_step(bpos, t_cur, t_coef, t_bias, flip, vshift, vsize,
                              hit_t, word_of, idx9);
    if (what == DDA_HIT) {
      hit_t = t_cur;
      hit_idx9 = idx9;
    }
    walking = what == DDA_STAY;
  }
  hit_t_out[i] = hit_t;
  hit_idx9_out[i] = hit_idx9;
  t_cur_out[i] = t_cur;
}

constexpr int MODE_SCALAR = 0, MODE_MIN = 1, MODE_ROWS = 2;
constexpr int ROWREAD_BLOCK = 128;
constexpr int ROW_SCALARS = 8;  // row indices one launch takes as arguments

struct RowScalars {
  int v[ROW_SCALARS];
};

// Four words of a row at once, for rows that start on 16 bytes.
__device__ __forceinline__ int4 row_quad(const int* __restrict__ table,
                                         int stride, int row, int q) {
  return __ldg((const int4*)(table + (size_t)row * stride) + q);
}

// One block an output row, and one launch a batch of requests. The block
// learns its row index (its entry of the launch's scalar arguments; the
// minimum of its own `per` cursors, reduced by warp shuffles and shared
// memory; or its own entry of idx), clips it to the table and copies the
// row, neighbouring threads on neighbouring words, 16 bytes a thread where
// `quads` says the rows allow it.
__global__ void __launch_bounds__(ROWREAD_BLOCK)
rowread_kernel(const int* __restrict__ table, int rows, int cols, int mode,
               RowScalars scalars, const int* __restrict__ idx, int per,
               int* __restrict__ out, int quads) {
  __shared__ int s_min[ROWREAD_BLOCK / 32];
  const int tid = threadIdx.x;
  int row;
  if (mode == MODE_SCALAR) {
    row = scalars.v[blockIdx.x];
  } else if (mode == MODE_ROWS) {
    row = idx[blockIdx.x];
  } else {
    const int* mine = idx + (size_t)blockIdx.x * per;
    int m = INT_MAX;
    for (int j = tid; j < per; j += blockDim.x) m = min(m, mine[j]);
    for (int off = 16; off > 0; off >>= 1)
      m = min(m, __shfl_xor_sync(0xFFFFFFFFu, m, off));
    if ((tid & 31) == 0) s_min[tid >> 5] = m;
    __syncthreads();
    row = s_min[0];
    for (int w = 1; w < ROWREAD_BLOCK / 32; ++w) row = min(row, s_min[w]);
  }
  row = max(0, min(row, rows - 1));
  if (quads) {
    int4* dst = (int4*)(out + (size_t)blockIdx.x * cols);
    for (int q = tid; q < cols / 4; q += blockDim.x)
      dst[q] = row_quad(table, cols, row, q);
  } else {
    for (int c = tid; c < cols; c += blockDim.x)
      out[(size_t)blockIdx.x * cols + c] = row_word(table, cols, row, c);
  }
}

}  // namespace

extern "C" int tile_walk(const void* bricks, const void* o, const void* d,
                         const void* codes, const void* ids,
                         const void* t_codes, int T, int P, int K, int depth,
                         int top_depth, void* hit_leaf, void* hit_t,
                         void* iters, void* stream) {
  if (P < 1 || P > P_LIMIT || K < 1 || K > K_LIMIT) return (int)cudaErrorInvalidValue;
  if (T > 0) {
    tile_walk_kernel<<<T, P, 0, (cudaStream_t)stream>>>(
        (const int*)bricks, (const float*)o, (const float*)d,
        (const int*)codes, (const int*)ids, (const float*)t_codes, K, depth,
        top_depth, (int*)hit_leaf, (float*)hit_t, (int*)iters);
  }
  return (int)cudaGetLastError();
}

extern "C" int brick_dda16(const void* bpos, const void* t_cur,
                           const void* walking, const void* rw, const void* tc,
                           const void* tb, const void* flip, const void* hit_t,
                           int n, int depth, int steps, void* hit_t_out,
                           void* hit_idx9_out, void* t_cur_out, void* stream) {
  if (n > 0) {
    const int blocks = (n + 255) / 256;
    brick_dda16_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
        (const float*)bpos, (const float*)t_cur, (const int*)walking,
        (const int*)rw, (const float*)tc, (const float*)tb, (const int*)flip,
        (const float*)hit_t, n, depth, steps, (float*)hit_t_out,
        (int*)hit_idx9_out, (float*)t_cur_out);
  }
  return (int)cudaGetLastError();
}

// `scalars`: n_scalars row indices in host memory (MODE_SCALAR, one a
// request). `idx`: n_idx indices on the card: n_out of them (MODE_ROWS), or
// n_idx / n_out cursors a request (MODE_MIN).
extern "C" int rowread(const void* table, int rows, int cols, int mode,
                       const int* scalars, int n_scalars, const void* idx,
                       int n_idx, void* out, int n_out, void* stream) {
  if (mode < MODE_SCALAR || mode > MODE_ROWS || rows < 1 || cols < 1)
    return (int)cudaErrorInvalidValue;
  RowScalars by_value = {};
  int per = 0;
  if (mode == MODE_SCALAR) {
    if (scalars == nullptr || n_scalars != n_out || n_out > ROW_SCALARS)
      return (int)cudaErrorInvalidValue;
    for (int k = 0; k < n_scalars; ++k) by_value.v[k] = scalars[k];
  } else {
    if (idx == nullptr || n_out < 0 || (n_out > 0 && n_idx % n_out != 0) ||
        (mode == MODE_ROWS && n_idx != n_out) || (n_out > 0 && n_idx < n_out))
      return (int)cudaErrorInvalidValue;
    per = n_out > 0 ? n_idx / n_out : 0;
  }
  const int quads = cols % 4 == 0 && (uintptr_t)table % 16 == 0 &&
                    (uintptr_t)out % 16 == 0;
  if (n_out > 0) {
    rowread_kernel<<<n_out, ROWREAD_BLOCK, 0, (cudaStream_t)stream>>>(
        (const int*)table, rows, cols, mode, by_value, (const int*)idx, per,
        (int*)out, quads);
  }
  return (int)cudaGetLastError();
}
