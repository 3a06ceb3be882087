// The exact 8^3 brick DDA: the device code that tile_walk.cu (the tile
// walker and brick_dda16) and brick_trace.cu (the per-ray brick traces)
// share, so that every brick walk in the port takes the same steps.
// dda_step stops at the first occupied voxel; dda_collect_step, for the
// k-segment trace, reports each occupied voxel and walks on.
//
// Semantics follow the plain versions bit for bit
// (raytracingtest_tpu_torch/ops/brick_dda.py::dda_step, the step of
// ops/brick.py::_dda_round_multi, and the descent in
// ops/brick.py::_parked_rays and ops/tile.py). Built with --fmad=false, so
// pos*t_coef - t_bias and half*t_coef + t_corner round in two steps, as
// their separate tensor operations do. Occupancy words are uint32_t here;
// the port carries them as int32 bit patterns.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rtt_dda {

constexpr int DDA_STAY = 0, DDA_HIT = 1, DDA_EXIT = 2;

__device__ __forceinline__ int spread3(int x) {
  return (x & 1) | ((x & 2) << 2) | ((x & 4) << 4);
}

// The voxel the ray stands in: its brick-local coordinates li and its bit
// index idx9 in the brick; returns whether it is occupied.
template <typename WordFn>
__device__ __forceinline__ bool dda_voxel(const float bpos[3],
                                          const int flip[3], int vshift,
                                          WordFn word_of, int li[3],
                                          int& idx9) {
  for (int c = 0; c < 3; ++c) li[c] = (__float_as_int(bpos[c]) >> vshift) & 7;
  idx9 = spread3(li[0] ^ flip[0]) | (spread3(li[1] ^ flip[1]) << 1) |
         (spread3(li[2] ^ flip[2]) << 2);
  const uint32_t w = word_of(idx9 >> 5);
  return ((w >> (idx9 & 31)) & 1u) != 0;
}

// The step out of the voxel: t_cur moves to the voxel's exit t (left in
// tc_max); DDA_EXIT when that leaves the brick, else the voxel moves on
// each axis whose plane is crossed.
__device__ __forceinline__ int dda_advance(float bpos[3], float& t_cur,
                                           const float t_coef[3],
                                           const float t_bias[3],
                                           const int li[3], float vsize,
                                           float& tc_max) {
  float tc[3];
  for (int c = 0; c < 3; ++c) tc[c] = bpos[c] * t_coef[c] - t_bias[c];
  tc_max = fminf(fminf(tc[0], tc[1]), tc[2]);
  bool exit_b = false;
  for (int c = 0; c < 3; ++c) exit_b = exit_b || (tc[c] <= tc_max && li[c] == 0);
  t_cur = fmaxf(t_cur, tc_max);
  if (exit_b) return DDA_EXIT;
  for (int c = 0; c < 3; ++c) {
    if (tc[c] <= tc_max) bpos[c] = bpos[c] - vsize;
  }
  return DDA_STAY;
}

// One step of the exact voxel DDA inside an 8^3 brick. bpos is the mirrored
// lower corner of the ray's current voxel; flip[c] is 0 on a mirrored axis,
// else 7; word_of(w) gives the brick's occupancy word w. An occupied voxel is
// a hit only while t_cur < hit_t (INFINITY: any occupied voxel), otherwise
// the ray steps on. Leaves idx9 (the voxel's bit index in the brick) for
// the caller.
template <typename WordFn>
__device__ __forceinline__ int dda_step(float bpos[3], float& t_cur,
                                        const float t_coef[3],
                                        const float t_bias[3],
                                        const int flip[3], int vshift,
                                        float vsize, float hit_t,
                                        WordFn word_of, int& idx9) {
  int li[3];
  if (dda_voxel(bpos, flip, vshift, word_of, li, idx9) && t_cur < hit_t)
    return DDA_HIT;
  float tc_max;
  return dda_advance(bpos, t_cur, t_coef, t_bias, li, vsize, tc_max);
}

// One step in collect mode (ops/brick.py::_dda_round_multi): `solid` says
// whether the voxel the ray stands in is occupied (idx9 its bit, t_exit its
// exit t), and the ray steps out of it either way.
template <typename WordFn>
__device__ __forceinline__ int dda_collect_step(float bpos[3], float& t_cur,
                                                const float t_coef[3],
                                                const float t_bias[3],
                                                const int flip[3], int vshift,
                                                float vsize, WordFn word_of,
                                                int& idx9, bool& solid,
                                                float& t_exit) {
  int li[3];
  solid = dda_voxel(bpos, flip, vshift, word_of, li, idx9);
  return dda_advance(bpos, t_cur, t_coef, t_bias, li, vsize, t_exit);
}

// The three-level plane descent from a brick's mirrored corner bpos (bsize
// wide) to the voxel the ray enters at t_in.
__device__ __forceinline__ void descend(const float t_coef[3],
                                        const float t_bias[3], float bsize,
                                        float t_in, float bpos[3]) {
  float half = bsize;
  for (int l = 0; l < 3; ++l) {
    half *= 0.5f;
    for (int c = 0; c < 3; ++c) {
      const float t_center =
          half * t_coef[c] + (bpos[c] * t_coef[c] - t_bias[c]);
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

}  // namespace rtt_dda
