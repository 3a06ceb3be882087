// Per-ray ESVO traversal (Laine & Karras) for Hopper, sm_90a.
//
// Replaces the TPU kernel raytracingtest_tpu/ops/traverse_pallas.py::_kernel
// (driven by _trace_pallas). Semantics follow the port's plain PyTorch
// version, raytracingtest_tpu_torch/ops/traverse.py::step, bit for bit: PUSH
// into the first valid child with a depth-deep (parent, t_max) stack, ADVANCE
// by corner-plane t, POP with the scale recovered from the float exponent of
// an XOR of positions, all in mirrored [1,2]^3 space.
//
// What bounds it on this card: not FLOPs. Each step makes a dependent gather
// into `masks` (and on PUSH into `child_base`), and the 32 rays of a warp take
// different numbers of steps and different PUSH/ADVANCE/POP branches, so warps
// wait on memory latency and on their slowest ray. This first version is
// simple and right: one thread per ray, 1-D blocks of 256, the tables read
// through the read-only path (__ldg), the stack in two local arrays. Making it
// fast (ray ordering, shared-memory top levels, a short stack) is later work.
//
// Rounding: built with --fmad=false, so pos*t_coef - t_bias and the other
// a*b+c forms round in two steps, as the plain version's separate tensor ops
// do; -1/|d| is an IEEE division. POP ORs the stepped axes' XOR bits, as the
// Pallas kernel does. Like it, and unlike the host tracer csrc/esvo.cpp, an
// unwritten stack slot reads as zeros, the slot index is clipped, and a POP
// whose scale leaves [S_MAX - depth, S_MAX) ends the ray.

#include <cuda_runtime.h>

namespace {

constexpr int S_MAX = 23;
constexpr int BLOCK = 256;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(BLOCK)
esvo_trace_kernel(const int* __restrict__ masks,
                  const int* __restrict__ child_base,
                  const int* __restrict__ leaf_base,
                  const float* __restrict__ origin,
                  const float* __restrict__ direction, int n, int depth,
                  int* __restrict__ hit_leaf, float* __restrict__ hit_t,
                  int* __restrict__ hit_parent, int* __restrict__ hit_child,
                  int* __restrict__ iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int s0 = S_MAX - depth;
  const int n_max = 24 * depth + 48;
  const float eps = 1.0f / 8388608.0f;  // 2^-S_MAX

  float o[3], t_coef[3], t_bias[3];
  int octant_mask = 7;
  for (int c = 0; c < 3; ++c) {
    o[c] = origin[3 * i + c] + 1.0f;
    float dc = direction[3 * i + c];
    if (fabsf(dc) < eps) dc = dc >= 0.0f ? eps : -eps;
    t_coef[c] = -1.0f / fabsf(dc);
    t_bias[c] = t_coef[c] * o[c];
    if (dc > 0.0f) {
      octant_mask ^= 1 << c;
      t_bias[c] = 3.0f * t_coef[c] - t_bias[c];
    }
  }

  float t_min = fmaxf(fmaxf(2.0f * t_coef[0] - t_bias[0],
                            2.0f * t_coef[1] - t_bias[1]),
                      2.0f * t_coef[2] - t_bias[2]);
  float t_max = fminf(fminf(t_coef[0] - t_bias[0], t_coef[1] - t_bias[1]),
                      t_coef[2] - t_bias[2]);
  t_min = fmaxf(t_min, 0.0f);
  bool done = t_min >= t_max;
  float h = t_max;

  int idx = 0;
  float pos[3] = {1.0f, 1.0f, 1.0f};
  for (int c = 0; c < 3; ++c) {
    if (1.5f * t_coef[c] - t_bias[c] > t_min) {
      idx ^= 1 << c;
      pos[c] = 1.5f;
    }
  }

  int parent = 0;
  int scale = S_MAX - 1;
  float scale_exp2 = 0.5f;
  int hp = -1, hc = 0;
  float ht = 0.0f;
  // an unwritten slot reads as node 0, t 0 (the plain version's zeros)
  int stack_node[S_MAX];
  float stack_tmax[S_MAX];
  for (int k = 0; k < S_MAX; ++k) {
    stack_node[k] = 0;
    stack_tmax[k] = 0.0f;
  }

  // one trip per step while the ray is active: `it` is the ray's step count
  int it = 0;
  while (!done && it < n_max) {
    ++it;
    const int desc = __ldg(masks + parent);
    const int vm = (desc >> 8) & 0xFF;
    const int lm = desc & 0xFF;

    float tc[3];
    for (int c = 0; c < 3; ++c) tc[c] = pos[c] * t_coef[c] - t_bias[c];
    const float tc_max = fminf(fminf(tc[0], tc[1]), tc[2]);

    const int child_shift = idx ^ octant_mask ^ 7;
    const bool child_valid = ((vm >> child_shift) & 1) != 0;
    const float tv_max = fminf(t_max, tc_max);
    const bool enter = child_valid && t_min <= t_max && t_min <= tv_max;

    if (enter && ((lm >> child_shift) & 1)) {  // leaf hit
      hp = parent;
      hc = child_shift;
      ht = t_min;
      done = true;
      break;
    }

    if (enter) {  // PUSH
      const float half = scale_exp2 * 0.5f;
      if (tc_max < h) {
        const int slot = clampi(scale - s0, 0, depth - 1);
        stack_node[slot] = parent;
        stack_tmax[slot] = t_max;
      }
      h = tc_max;
      const int below = (1 << child_shift) - 1;
      parent = __ldg(child_base + parent) + __popc(vm & ~lm & below);
      int idx_descend = 0;
      for (int c = 0; c < 3; ++c) {
        const float t_center = half * t_coef[c] + tc[c];
        if (t_center > t_min) {
          idx_descend ^= 1 << c;
          pos[c] = pos[c] + half;
        }
      }
      idx = idx_descend;
      scale -= 1;
      scale_exp2 = half;
      t_max = tv_max;
      continue;
    }

    // ADVANCE
    int step_mask = 0;
    for (int c = 0; c < 3; ++c) {
      if (tc[c] <= tc_max) {
        step_mask ^= 1 << c;
        pos[c] = pos[c] - scale_exp2;
      }
    }
    t_min = fmaxf(t_min, tc_max);
    idx ^= step_mask;
    if ((idx & step_mask) == 0) continue;

    // POP
    int differing = 1;  // |1 as in the plain version
    for (int c = 0; c < 3; ++c) {
      if (tc[c] <= tc_max) {
        differing |= __float_as_int(pos[c]) ^ __float_as_int(pos[c] + scale_exp2);
      }
    }
    const int new_scale =
        (__float_as_int(__int2float_rn(differing)) >> 23) - 127;
    if (new_scale >= S_MAX || new_scale < s0) {  // left the root
      done = true;
      break;
    }
    scale = new_scale;
    scale_exp2 = __int_as_float((new_scale - S_MAX + 127) << 23);
    const int slot = clampi(scale - s0, 0, depth - 1);
    parent = stack_node[slot];
    t_max = stack_tmax[slot];
    const int shift = clampi(scale, 0, 31);
    int sh[3];
    for (int c = 0; c < 3; ++c) {
      sh[c] = __float_as_int(pos[c]) >> shift;
      pos[c] = __int_as_float(sh[c] << shift);
    }
    idx = (sh[0] & 1) | ((sh[1] & 1) << 1) | ((sh[2] & 1) << 2);
    h = 0.0f;
  }

  // epilogue: leaf row = leaf_base[parent] + rank among the leaf children
  int leaf = -1;
  if (hp >= 0) {
    const int desc = __ldg(masks + hp);
    const int vm = (desc >> 8) & 0xFF;
    const int lm = desc & 0xFF;
    leaf = __ldg(leaf_base + hp) + __popc(vm & lm & ((1 << hc) - 1));
  }
  hit_leaf[i] = leaf;
  hit_t[i] = ht;
  hit_parent[i] = hp;
  hit_child[i] = hc;
  iters[i] = it;
}

}  // namespace

extern "C" int esvo_trace(const void* masks, const void* child_base,
                          const void* leaf_base, const void* origin,
                          const void* direction, int n, int depth,
                          void* hit_leaf, void* hit_t, void* hit_parent,
                          void* hit_child, void* iters, void* stream) {
  if (n > 0) {
    const int blocks = (n + BLOCK - 1) / BLOCK;
    esvo_trace_kernel<<<blocks, BLOCK, 0, (cudaStream_t)stream>>>(
        (const int*)masks, (const int*)child_base, (const int*)leaf_base,
        (const float*)origin, (const float*)direction, n, depth,
        (int*)hit_leaf, (float*)hit_t, (int*)hit_parent, (int*)hit_child,
        (int*)iters);
  }
  return (int)cudaGetLastError();
}
