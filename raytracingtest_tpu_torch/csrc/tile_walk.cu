// The tile walker and its two primitives for Hopper, sm_90a: four kernels
// that share one DDA step and one row read.
//
//   tile_walk         replaces what raytracingtest_tpu/ops/tile.py computes in
//                     _walk_chunk_window (:432) and _resolve_hits (:691): every
//                     ray walks its tile's t-ascending list of candidate
//                     bricks, runs the exact 8^3 voxel DDA in each brick it
//                     enters, and resolves its hit's leaf id. G lanes a ray.
//   tile_walk_serial  the same function with one thread a ray, the walker's
//                     first form: the check of tile_walk and its yardstick on
//                     the card. Nothing on the main path launches it.
//   brick_dda16       replaces scratch/r4_pallas2.py::pallas_version (:115, body
//                     `kernel` :70): STEPS masked DDA steps over pre-staged
//                     per-ray state. It is the walkers' inner loop on its own.
//   rowread           replaces scratch/r4_pallas.py::dynrow, dynrow2, dynrow3 and
//                     dynrow8 (:38-:103): one row of a resident int32 table at
//                     an index learned at run time (a scalar argument; the
//                     minimum of a block of cursors; one index per block), a
//                     batch of such requests a launch. It is the read the
//                     walkers stage their candidates with.
//
// Semantics follow the plain PyTorch versions bit for bit
// (raytracingtest_tpu_torch/ops/tile.py::walk_plain,
// ops/brick_dda.py::dda_steps, ops/rowread.py). The reference's walker is a
// lockstep loop over chunks of tiles with a ring buffer of candidates; that
// is scheduling for a machine whose lanes cannot read memory on their own
// and none of it is here.
//
// What bounds a walk on this card: not bytes (24 B of rays in and 12 B out a
// ray, 80 B of staged list and row a candidate) and not FLOPs, but the chain
// of dependent steps one ray walks: up to K candidates in order, up to 3*7+1
// DDA steps in each, every step a short chain of integer and float
// operations fed from shared memory. One thread a ray (tile_walk_serial)
// hides that chain only when the card holds enough rays: the frame's main
// walk (4,096 tiles of 256 rays) fills it, but its two fallback walks (96
// tiles of 256 rays with K = 160; 64 sub-tiles of 64 rays) put 24,576 and
// 4,096 threads on 132 SMs, and each runs as long as its slowest ray's walk
// through up to 160 bricks: rays picked because they skim the terrain.
//
// tile_walk therefore gives each ray a group of G lanes of one warp (G a
// power of two, 1..32; the wrapper picks G from the launch's shape). The
// group takes the list in rounds of G: lane j walks candidate round*G + j
// with the hit carried in from earlier rounds as its bound H, which is what
// the serial walk's running hit is at the round's start or larger. What a
// lane computes for its candidate does not depend on the hits of the other
// lanes of its round, so every value is the serial walk's, bit for bit:
// the box test (t_in, t_out), the three-level plane descent, and the DDA to
// the first occupied voxel with t_cur < H (its t_cur and idx9, and the steps
// to it) or to the brick's exit. An exclusive prefix minimum over the round,
// by warp shuffles from H, then gives H_j, the serial walk's running hit on
// reaching candidate j, and the group rebuilds the serial result from it:
//   * the walk stops at the first j with id < 0 or t_codes[j] >= H_j;
//   * candidate j is entered iff t_in < t_out and t_in < H_j;
//   * its hit is a new hit iff t_hit < H_j (strict), and the last such j of
//     the round holds the hit (H falls at each);
//   * an entered candidate costs the steps to its hit if it is a new hit;
//     else the steps to its exit, because t_cur only grows inside a brick
//     and no later voxel of it can beat H_j. A lane that found a voxel below
//     H but not below H_j resumes its DDA there with bound H_j, as the
//     serial walk does, and walks on to the exit.
// The group sums the steps (iters) and starts the next round only if no
// lane stopped. With G = 1 this is the serial walk itself.
//
// Shared memory is sized by the launch's K (80 B a candidate: id, code, t
// lower bound and the brick's 17-word row). The block issues every staging
// load at once, ids and rows alike, sets up its rays while they land, and
// waits at one barrier. The epilogue counts the leaf id from the staged row.
// A block holds 256 / G rays (all of a tile's at G = 1) and a tile spans
// ceil(P / (256 / G)) blocks, each staging the tile's list from L2.
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

// A ray's walk set-up: mirroring and root-cube entry
// (ops/traverse.py::ray_setup).
struct WalkRay {
  float t_coef[3], t_bias[3];
  float t0;
  int om;
  bool miss0;  // never enters the root cube
};

__device__ __forceinline__ WalkRay walk_ray(const float* __restrict__ o,
                                            const float* __restrict__ d,
                                            size_t ray) {
  WalkRay r;
  const float eps = 1.0f / 8388608.0f;  // 2^-S_MAX
  r.om = 7;
  for (int c = 0; c < 3; ++c) {
    const float oc = o[3 * ray + c] + 1.0f;
    float dc = d[3 * ray + c];
    if (fabsf(dc) < eps) dc = dc >= 0.0f ? eps : -eps;
    r.t_coef[c] = -1.0f / fabsf(dc);
    r.t_bias[c] = r.t_coef[c] * oc;
    if (dc > 0.0f) {
      r.om ^= 1 << c;
      r.t_bias[c] = 3.0f * r.t_coef[c] - r.t_bias[c];
    }
  }
  const float t0 = fmaxf(fmaxf(2.0f * r.t_coef[0] - r.t_bias[0],
                               2.0f * r.t_coef[1] - r.t_bias[1]),
                         2.0f * r.t_coef[2] - r.t_bias[2]);
  const float t_max = fminf(fminf(r.t_coef[0] - r.t_bias[0],
                                  r.t_coef[1] - r.t_bias[1]),
                            r.t_coef[2] - r.t_bias[2]);
  r.t0 = fmaxf(t0, 0.0f);
  r.miss0 = r.t0 >= t_max;
  return r;
}

// The box test of a candidate (its morton code) against the ray: the
// brick's mirrored lower corner pos_b, the entry t_in and the exit t_out.
__device__ __forceinline__ void box_test(const WalkRay& r, uint32_t code,
                                         int s, float bsize, float pos_b[3],
                                         float& t_in, float& t_out) {
  float t_hi[3], t_lo[3];
  for (int c = 0; c < 3; ++c) {
    const int cc = (int)compact3_10(code >> c);
    const int m = ((r.om >> c) & 1) ? cc : s - cc;
    pos_b[c] = 1.0f + (float)m * bsize;
    t_hi[c] = (pos_b[c] + bsize) * r.t_coef[c] - r.t_bias[c];
    t_lo[c] = pos_b[c] * r.t_coef[c] - r.t_bias[c];
  }
  t_in = fmaxf(fmaxf(fmaxf(t_hi[0], t_hi[1]), t_hi[2]), r.t0);
  t_out = fminf(fminf(t_lo[0], t_lo[1]), t_lo[2]);
}

// The three-level plane descent from the brick's corner to the entry voxel.
__device__ __forceinline__ void descend(const WalkRay& r, float bsize,
                                        float t_in, float bpos[3]) {
  float half = bsize;
  for (int l = 0; l < 3; ++l) {
    half *= 0.5f;
    for (int c = 0; c < 3; ++c) {
      const float t_center =
          half * r.t_coef[c] + (bpos[c] * r.t_coef[c] - r.t_bias[c]);
      if (t_center > t_in) bpos[c] = bpos[c] + half;
    }
  }
}

// A hit's leaf id from its brick's row (word(w) is word w of the 17): the
// brick's first leaf plus the set bits below the hit's bit.
template <typename WordFn>
__device__ __forceinline__ int leaf_of(WordFn word, int idx9) {
  const int wsel = idx9 >> 5;
  int below = 0;
  for (int w = 0; w < wsel; ++w) below += __popc((uint32_t)word(w));
  below += __popc((uint32_t)word(wsel) & ((1u << (idx9 & 31)) - 1u));
  return word(16) + below;
}

// One ray's walk through a staged candidate list, one candidate after
// another: the serial walk. `words` holds each candidate's occupancy words,
// `stride` words a candidate. Leaves the running hit in hit_t, hit_k (the
// candidate that holds it, -1 for none) and hit_idx9; returns the DDA steps.
__device__ __forceinline__ int walk_serial(const WalkRay& r,
                                           const int* s_ids,
                                           const int* s_codes,
                                           const float* s_tlb,
                                           const uint32_t* words, int stride,
                                           int K, int depth, int top_depth,
                                           float& hit_t, int& hit_k,
                                           int& hit_idx9) {
  int flip[3];
  for (int c = 0; c < 3; ++c) flip[c] = ((r.om >> c) & 1) ? 0 : 7;
  const int vshift = S_MAX - depth;
  const float vsize = __int_as_float((127 - depth) << 23);      // 2^-depth
  const float bsize = __int_as_float((127 - top_depth) << 23);  // 2^-top_depth
  const int s = (1 << top_depth) - 1;

  int it = 0;
  for (int k = 0; !r.miss0 && k < K; ++k) {
    if (s_ids[k] < 0 || s_tlb[k] >= hit_t) break;  // nothing later can beat the hit

    float pos_b[3], t_in, t_out;
    box_test(r, (uint32_t)s_codes[k], s, bsize, pos_b, t_in, t_out);
    if (!(t_in < t_out && t_in < hit_t)) continue;
    float bpos[3] = {pos_b[0], pos_b[1], pos_b[2]};
    descend(r, bsize, t_in, bpos);

    // the exact DDA, to a hit or the brick's exit (at most 3*7+1 steps)
    float t_cur = t_in;
    const uint32_t* row = words + k * stride;
    auto word_of = [row](int w) { return row[w]; };
    for (int step = 0; step < 24; ++step) {
      ++it;
      int idx9;
      const int what = dda_step(bpos, t_cur, r.t_coef, r.t_bias, flip, vshift,
                                vsize, hit_t, word_of, idx9);
      if (what == DDA_HIT) {
        hit_k = k;
        hit_idx9 = idx9;
        hit_t = t_cur;
      }
      if (what != DDA_STAY) break;
    }
  }
  return it;
}

// The walker's first form, one thread a ray: the block stages its tile's
// candidate list (K <= 256) and those bricks' 16 occupancy words in fixed
// shared arrays (19 KB), then each thread walks the list alone and reads
// its hit's row again from global memory. Nothing on the main path launches
// it; it is the check of tile_walk_kernel and its yardstick.
__global__ void __launch_bounds__(P_LIMIT)
tile_walk_serial_kernel(const int* __restrict__ bricks,
                        const float* __restrict__ o,
                        const float* __restrict__ d,
                        const int* __restrict__ codes,
                        const int* __restrict__ ids,
                        const float* __restrict__ t_codes, int K, int depth,
                        int top_depth, int* __restrict__ hit_leaf,
                        float* __restrict__ hit_t_out,
                        int* __restrict__ iters_out) {
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

  const size_t ray = (size_t)blockIdx.x * blockDim.x + tid;
  const WalkRay r = walk_ray(o, d, ray);
  float hit_t = INFINITY;
  int hit_k = -1, hit_idx9 = 0;
  const int it = walk_serial(r, s_ids, s_codes, s_tlb, s_words, 16, K, depth,
                             top_depth, hit_t, hit_k, hit_idx9);
  const int hit_bid = hit_k >= 0 ? s_ids[hit_k] : -1;
  int leaf = -1;
  if (hit_bid >= 0)
    leaf = leaf_of([bricks, hit_bid](int w) {
      return row_word(bricks, ROW_WORDS, hit_bid, w); }, hit_idx9);
  hit_leaf[ray] = leaf;
  hit_t_out[ray] = hit_bid >= 0 ? hit_t : 0.0f;
  iters_out[ray] = it;
}

constexpr int WALK_BLOCK = 256;           // threads a block of tile_walk_kernel
constexpr int WALK_ROW = 3 + ROW_WORDS;   // staged words a candidate

// The G lanes of a group that `pred` holds for, as bits 0..G-1.
template <int G>
__device__ __forceinline__ unsigned group_ballot(unsigned gmask, int gshift,
                                                 bool pred) {
  return (__ballot_sync(gmask, pred) >> gshift) & (unsigned)((1ull << G) - 1);
}

// G lanes a ray (see the header). A block holds blockDim.x / G rays of one
// tile; a tile spans `chunks` blocks. Dynamic shared memory: K ids, K codes,
// K t lower bounds, K rows of 17 words.
template <int G>
__global__ void __launch_bounds__(WALK_BLOCK)
tile_walk_kernel(const int* __restrict__ bricks, const float* __restrict__ o,
                 const float* __restrict__ d, const int* __restrict__ codes,
                 const int* __restrict__ ids,
                 const float* __restrict__ t_codes, int P, int K, int chunks,
                 int depth, int top_depth, int* __restrict__ hit_leaf,
                 float* __restrict__ hit_t_out, int* __restrict__ iters_out) {
  extern __shared__ int smem[];
  int* s_ids = smem;
  int* s_codes = s_ids + K;
  float* s_tlb = reinterpret_cast<float*>(s_codes + K);
  uint32_t* s_rows = reinterpret_cast<uint32_t*>(s_tlb + K);

  const int tid = threadIdx.x;
  const int tile = blockIdx.x / chunks;
  const int p = (blockIdx.x - tile * chunks) * (blockDim.x / G) + tid / G;
  const int lane = tid & (G - 1);
  const bool live = p < P;

  // every staging load at once: a row's id is read from global memory
  // again, not from s_ids, so no load waits on a barrier or another load's
  // store; the rays' set-up runs while they land
  const size_t cbase = (size_t)tile * K;
  for (int k = tid; k < K; k += blockDim.x) {
    s_ids[k] = __ldg(ids + cbase + k);
    s_codes[k] = __ldg(codes + cbase + k);
    s_tlb[k] = __ldg(t_codes + cbase + k);
  }
  for (int j = tid; j < K * ROW_WORDS; j += blockDim.x) {
    const int k = j / ROW_WORDS;
    const int id = __ldg(ids + cbase + k);
    s_rows[j] = id >= 0
        ? (uint32_t)row_word(bricks, ROW_WORDS, id, j - k * ROW_WORDS) : 0u;
  }

  const size_t ray = (size_t)tile * P + (live ? p : 0);
  const WalkRay r = walk_ray(o, d, ray);
  __syncthreads();

  float H = INFINITY;  // the running hit's t
  int hit_k = -1, hit_idx9 = 0, it = 0;
  if constexpr (G == 1) {
    // one lane: the serial walk itself
    if (live)
      it = walk_serial(r, s_ids, s_codes, s_tlb, s_rows, ROW_WORDS, K, depth,
                       top_depth, H, hit_k, hit_idx9);
  } else {
    int flip[3];
    for (int c = 0; c < 3; ++c) flip[c] = ((r.om >> c) & 1) ? 0 : 7;
    const int vshift = S_MAX - depth;
    const float vsize = __int_as_float((127 - depth) << 23);      // 2^-depth
    const float bsize = __int_as_float((127 - top_depth) << 23);  // 2^-top_depth
    const int s = (1 << top_depth) - 1;
    const int gshift = (tid & 31) & ~(G - 1);  // the group's first lane in its warp
    const unsigned gmask = (unsigned)(((1ull << G) - 1) << gshift);
    // the same on every lane of a group, so a group's lanes take the same
    // rounds and every shuffle below has all of them
    bool walking = live && !r.miss0;
    for (int base = 0; walking; base += G) {
      // ---- this lane's candidate, with the round's carried hit H as bound
      const int k = base + lane;
      bool hard_stop = k >= K;
      float tlb = 0.0f, t_in = 0.0f, t_cur = 0.0f, v = INFINITY;
      float bpos[3] = {0.0f, 0.0f, 0.0f};
      bool box_ok = false, found = false;
      int steps = 0, idx9 = 0;
      if (!hard_stop) {
        hard_stop = s_ids[k] < 0;
        tlb = s_tlb[k];
      }
      if (!hard_stop && !(tlb >= H)) {  // else it stops the walk, H_j <= H
        float pos_b[3], t_out;
        box_test(r, (uint32_t)s_codes[k], s, bsize, pos_b, t_in, t_out);
        box_ok = t_in < t_out;
        if (box_ok && t_in < H) {
          for (int c = 0; c < 3; ++c) bpos[c] = pos_b[c];
          descend(r, bsize, t_in, bpos);
          t_cur = t_in;
          const uint32_t* words = s_rows + k * ROW_WORDS;
          auto word_of = [words](int w) { return words[w]; };
          for (int step = 0; step < 24; ++step) {
            ++steps;
            const int what = dda_step(bpos, t_cur, r.t_coef, r.t_bias, flip,
                                      vshift, vsize, H, word_of, idx9);
            if (what == DDA_HIT) {
              found = true;
              v = t_cur;
            }
            if (what != DDA_STAY) break;
          }
        }
      }

      // ---- H_j, the serial walk's running hit on reaching candidate j: an
      // exclusive prefix minimum of the lanes' hits, starting from H
      float incl = v;
      for (int off = 1; off < G; off <<= 1) {
        const float y = __shfl_up_sync(gmask, incl, off, G);
        if (lane >= off) incl = fminf(incl, y);
      }
      const float before = __shfl_up_sync(gmask, incl, 1, G);
      const float Hj = lane > 0 ? fminf(H, before) : H;
      const bool stop = hard_stop || tlb >= Hj;
      const unsigned stops = group_ballot<G>(gmask, gshift, stop);
      const int first_stop = stops ? __ffs(stops) - 1 : G;
      const bool enter = lane < first_stop && box_ok && t_in < Hj;
      const bool wins = enter && found && v < Hj;
      int cost = 0;
      if (enter) {
        cost = steps;
        if (found && !wins) {
          // the voxel that beat H does not beat H_j: from it the serial walk
          // steps on to the brick's exit (no later voxel can beat H_j)
          cost = steps - 1;
          const uint32_t* words = s_rows + k * ROW_WORDS;
          auto word_of = [words](int w) { return words[w]; };
          for (int step = steps - 1; step < 24; ++step) {
            ++cost;
            const int what = dda_step(bpos, t_cur, r.t_coef, r.t_bias, flip,
                                      vshift, vsize, Hj, word_of, idx9);
            if (what != DDA_STAY) break;
          }
        }
      }
      for (int off = G / 2; off > 0; off >>= 1)
        cost += __shfl_xor_sync(gmask, cost, off, G);
      it += cost;
      // the last new hit of the round is the hit
      const unsigned winners = group_ballot<G>(gmask, gshift, wins);
      if (winners) {
        const int w = 31 - __clz(winners);
        H = __shfl_sync(gmask, v, w, G);
        hit_idx9 = __shfl_sync(gmask, idx9, w, G);
        hit_k = base + w;
      }
      walking = first_stop == G;
    }
  }

  if (live && lane == 0) {
    int leaf = -1;
    if (hit_k >= 0) {
      const uint32_t* row = s_rows + hit_k * ROW_WORDS;
      leaf = leaf_of([row](int w) { return (int)row[w]; }, hit_idx9);
    }
    hit_leaf[ray] = leaf;
    hit_t_out[ray] = hit_k >= 0 ? H : 0.0f;
    iters_out[ray] = it;
  }
}

template <int G>
void launch_walk(const void* bricks, const void* o, const void* d,
                 const void* codes, const void* ids, const void* t_codes,
                 int T, int P, int K, int depth, int top_depth,
                 void* hit_leaf, void* hit_t, void* iters,
                 cudaStream_t stream) {
  const int per_block = P < WALK_BLOCK / G ? P : WALK_BLOCK / G;
  const int chunks = (P + per_block - 1) / per_block;
  const size_t smem = (size_t)K * WALK_ROW * sizeof(int);
  tile_walk_kernel<G><<<T * chunks, per_block * G, smem, stream>>>(
      (const int*)bricks, (const float*)o, (const float*)d,
      (const int*)codes, (const int*)ids, (const float*)t_codes, P, K,
      chunks, depth, top_depth, (int*)hit_leaf, (float*)hit_t, (int*)iters);
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

// `lanes`: G, a power of two from 1 to 32. Any P >= 1; a tile spans
// ceil(P / (256 / G)) blocks.
extern "C" int tile_walk(const void* bricks, const void* o, const void* d,
                         const void* codes, const void* ids,
                         const void* t_codes, int T, int P, int K, int depth,
                         int top_depth, int lanes, void* hit_leaf, void* hit_t,
                         void* iters, void* stream) {
  if (P < 1 || K < 1 || K > K_LIMIT || T < 0) return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
#define WALK_CASE(G)                                                      \
  case G:                                                                 \
    launch_walk<G>(bricks, o, d, codes, ids, t_codes, T, P, K, depth,     \
                   top_depth, hit_leaf, hit_t, iters, st);                \
    break;
  switch (lanes) {
    WALK_CASE(1) WALK_CASE(2) WALK_CASE(4) WALK_CASE(8) WALK_CASE(16)
    WALK_CASE(32)
    default: return (int)cudaErrorInvalidValue;
  }
#undef WALK_CASE
  return (int)cudaGetLastError();
}

extern "C" int tile_walk_serial(const void* bricks, const void* o,
                                const void* d, const void* codes,
                                const void* ids, const void* t_codes, int T,
                                int P, int K, int depth, int top_depth,
                                void* hit_leaf, void* hit_t, void* iters,
                                void* stream) {
  if (P < 1 || P > P_LIMIT || K < 1 || K > K_LIMIT) return (int)cudaErrorInvalidValue;
  if (T > 0) {
    tile_walk_serial_kernel<<<T, P, 0, (cudaStream_t)stream>>>(
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
