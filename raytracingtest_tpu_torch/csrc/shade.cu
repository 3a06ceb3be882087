// Gathers, shading and its backward for Hopper, sm_90a: kernels that share
// one row load.
//
//   take          replaces the gather probes of scratch/probe_kernel.py
//                 (p2a_take_1d :85, p2b_take_2d_axis0 :106,
//                 p2c_take_along_lane :128, p2d_onehot :150) and
//                 scratch/probe2.py::gather_axis0 (:49): one 32-bit word per
//                 output element, fetched at an index learned at run time,
//                 from a 1-D table, along the rows of a 2-D table, or along
//                 the lanes of the element's own row. p2d's one-hot product
//                 is a mode of its own: the thread compares its index with
//                 every row, multiplies the row's word by the 0 or 1 and
//                 accumulates, as a row of one_hot(idx) @ table does; it
//                 reads the whole table where the gather reads one word.
//   loop_probe    replaces p1_kernel_loop (:58) and p2e_take_2d_big (:175) of
//                 scratch/probe_kernel.py and scratch/probe2.py::
//                 pallas_loop_slope (:80): a loop of `iters` trips inside one
//                 kernel, `elem` multiply-add-fract steps a trip, with or
//                 without a gather each trip (float mode), or a sum of
//                 gathered rows (integer mode). Its ranged form: floorf only
//                 where a step's input may lie outside [0, 1], and the
//                 integer mode's loads issued eight trips ahead (below).
//   loop_probe_serial  the first form of loop_probe, floorf in every step
//                 and one load a trip. Kept as the ranged form's check and
//                 yardstick; launched once in a probe run.
//   shade_fwd     replaces raytracingtest_tpu/diff.py::gather_voxel_params
//                 (:35) with shade_diff (:132): the ray's parameter row and
//                 Lambert shading over the sky, fused.
//   shade_bwd     replaces what XLA's autodiff makes of shade_diff: the seven
//                 cotangents of the ray's parameter row from the image
//                 cotangent. A block stages its 256 rays' image cotangents
//                 and sky inputs in shared memory, and writes their
//                 cotangent rows back from there, with 16-byte moves.
//   shade_bwd_serial  the first form of shade_bwd, every row moved by its
//                 ray's own thread in 4-byte words. Kept as the new form's
//                 check and yardstick; nothing on the training path calls it.
//   segment_sum   replaces _gather_bwd/_segment_reduce_cols (diff.py:72-122):
//                 per-leaf sums of the cotangent rows, the same bits in every
//                 run, without a sort of the rays and without float atomics.
//                 Five small kernels behind one entry point (below).
//   composite_fwd replaces raytracingtest_tpu/diff.py::_composite_segments
//                 (:377), forward: the emission-absorption compositing of a
//                 ray's first k leaf segments (from the k-segment traces of
//                 brick_trace.cu) over the procedural sky, each segment's
//                 parameter row gathered and shaded as in shade_fwd.
//   composite_bwd replaces what XLA's autodiff makes of _composite_segments
//                 (:377-403): the seven cotangents of each of the ray's k
//                 slots' parameter rows from its image cotangent, row
//                 i * k + j for slot j of ray i (the reference's reshape
//                 order); segment_sum then adds them onto the leaves.
//   segment_sum_sorted  the earlier form of the same sum, over rays that a
//                 stable sort outside the kernel has ordered by leaf id. Kept
//                 as a second, independent implementation to hold the new
//                 one against; nothing on the training path calls it.
//
// One thread an output element (take, loop_probe), a ray (shade_fwd,
// shade_bwd, shade_bwd_serial, composite_fwd) or a leaf (segment_sum). `take_row` is the row
// load they share: the row index clipped to the table, then one read through
// the read-only path.
//
// What bounds them on this card. take: the launch; its probes move 4 KB.
// loop_probe: each element's chain of dependent steps, which no other thread
// can shorten, and the issue slots of its instructions: at (512, 128) the
// card holds 65,536 threads, some 4 warps a scheduler, so a step's four
// instructions (multiply, add, floor, subtract; --fmad=false keeps the first
// two apart) cost a scheduler 16 issue cycles against a chain of about 12
// cycles in the ranged form. The first form's chain runs through floorf, an
// FRND, which neither runs at the FP32 pipe's latency nor at its rate.
// shade_fwd and shade_bwd: bytes. A ray reads 16 B and one 28 B
// parameter row scattered over three tensors and writes 12 B (forward) or
// reads 28 B + 12 B and writes 28 B (backward), against some 40 float
// operations; reading the three parameter tensors in place saves writing and
// re-reading a packed (n_leaves, 7) table every frame, and a miss reads no
// row. A thread's own 12 B and 28 B rows, moved as 4-byte words, leave a
// warp's every store touching the same 32-byte sectors up to seven times
// (shade_bwd_serial); shade_bwd moves a block's rows between device memory
// and shared memory as coalesced 16-byte vectors, each sector once, and the
// threads read and write them there. segment_sum: bytes, 28 B written for
// every leaf and a scattered 28 B row read for every hit, and launches,
// since its passes are short. composite_fwd: bytes, 12 B of segment a slot
// and a scattered 28 B row a valid slot in, 12 B out a ray, against some 70
// float operations a valid slot; a thread walks its ray's slots in order
// (the transmittance is a running product), so its design is shade_fwd's:
// rows read in place through take_row, none for a padded slot.
// composite_bwd: bytes too, the forward's reads and 28 B written a slot,
// against some 130 float operations a valid slot (the forward's again and
// its reverse). The reverse needs each slot's transmittance T_j, a prefix
// product, while it walks the slots from the back: a first pass computes
// the T_j (a slot's density row only) and parks each in its slot's own
// row, and the reverse pass reads it back before writing the row. The rows
// live in shared memory, the block's k * 28 B a ray in the output's order,
// and the block then writes them out as one contiguous run, each warp's
// stores on consecutive words: a thread's own rows, 28 B each at a stride
// of 28 k B, written straight to device memory cost eight times the sector
// writes and measured 550 us alone on the depth-10 frame (PERF.md). The
// block is 128 threads, or 64 or 32 where k * 28 B a ray would not fit, so
// k is at most COMPOSITE_BWD_MAX_K. It never divides by (1 - alpha) + 1e-9,
// which is 1e-9 where a long dense segment gives alpha == 1: the
// cotangent of T_j is carried from the back as a scalar, dT_j = dw_j
// alpha_j + dT_{j+1} f_j, the way the reference's autodiff carries it.
//
// segment_sum. The function: each leaf's rows are added one after another in
// ascending ray index, starting from +0; a miss (hit_leaf < 0) adds nothing;
// ids above n_leaves - 1 clamp to it; a leaf no ray hit is +0. That is a
// serial scatter-add in ray order, bit for bit. Order matters only inside a
// leaf, and integer atomics give the same integers in any order, so:
//   seg_count  a thread a ray: atomicAdd(&count[leaf], 1).
//   seg_base   a thread a leaf: a touched leaf reserves count[leaf] slots of
//              the ray list (one atomicAdd on a running total a block, after
//              a scan inside the block). Where a leaf's segment lies changes
//              no result.
//   seg_place  a thread a hit: rays[atomicAdd(&cursor[leaf], 1)] = ray. The
//              order inside a segment is whatever the hardware gave.
//   seg_sum    a thread a leaf, every leaf: no ray, seven zeros (so the
//              outputs need no zero-fill); up to SEG_SHORT rays, the thread
//              takes them in ascending ray index (repeated selection of the
//              next larger id: the runs are short and the segment is one or
//              two cache lines) and adds their rows from +0; a longer run is
//              appended to a list of long leaves.
//   seg_long   a block a long leaf: sorts the leaf's ray ids ascending (a
//              bitonic network whose comparators all put the smaller id
//              first, so it takes any length; in shared memory up to
//              SEG_STAGE ids, in place in the ray list above that), then
//              stages the rows in shared memory SEG_ROWS at a time and seven
//              threads, one a column, add them in order from +0.
// Taking the ids in ascending order erases the placement order, so every run
// gives the serial sum's bits. The integer scratch (count, cursor, ray list,
// long-leaf list; 13 MB for 2^20 rays into 1,062,524 leaves) comes from the
// wrapper; one memset clears the counts and the two counters. The
// cumulative-sum form of the reference exists because its machine has no
// cheap scatter; none of it is here.
//
// Rounding: built with --fmad=false; sums of three run (x + y) + z as the
// plain versions write them; sqrtf and / are IEEE. Ties in max, min and clip
// pass half the cotangent, as the reference's autodiff does.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;

// Element `c` of row `row` of a table with `rows` rows of `stride` elements,
// the row clipped to the table.
template <typename T>
__device__ __forceinline__ T take_row(const T* __restrict__ table, int rows,
                                      int stride, int row, int c) {
  row = max(0, min(row, rows - 1));
  return __ldg(table + (size_t)row * stride + c);
}

constexpr int TAKE_1D = 0, TAKE_ALONG0 = 1, TAKE_ALONG_LANE = 2,
              TAKE_ONEHOT = 3;

// out has n words in rows of `cols`. TAKE_1D: out[i] = table[idx[i]], table
// of `rows` words. TAKE_ALONG0: out[s,l] = table[idx[s,l], l], table
// (rows, cols). TAKE_ALONG_LANE: out[s,l] = table[s, idx[s,l]], table of
// out's shape. TAKE_ONEHOT: out[i] = sum over r of (r == idx[i]) * table[r],
// table of `rows` float32 words.
__global__ void __launch_bounds__(BLOCK)
take_kernel(const uint32_t* __restrict__ table, const int* __restrict__ idx,
            uint32_t* __restrict__ out, int n, int rows, int cols, int mode) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int j = idx[i];
  if (mode == TAKE_1D) {
    out[i] = take_row(table, rows, 1, j, 0);
  } else if (mode == TAKE_ALONG0) {
    out[i] = take_row(table, rows, cols, j, i % cols);
  } else if (mode == TAKE_ONEHOT) {
    const float* t = (const float*)table;
    const int hot = max(0, min(j, rows - 1));
    float acc = 0.0f;
    for (int r = 0; r < rows; ++r)
      acc = acc + (r == hot ? 1.0f : 0.0f) * __ldg(t + r);
    out[i] = __float_as_uint(acc);
  } else {
    out[i] = take_row(table + (size_t)(i / cols) * cols, cols, 1, j, 0);
  }
}

constexpr int LOOP_FLOAT = 0, LOOP_INT = 1;

// LOOP_FLOAT: x float32; a trip is `elem` times (x = x*1.000001 + 0.5;
// x -= floor(x)) and, when gather_rows > 0, x += table[bits(x) &
// (gather_rows-1), lane] * 1e-9. LOOP_INT: x int32; out is the sum over the
// trips k of table[(x + k) mod gather_rows, lane].
__global__ void __launch_bounds__(BLOCK)
loop_probe_kernel(const void* __restrict__ x, const void* __restrict__ table,
                  void* __restrict__ out, int n, int cols, int table_rows,
                  int iters, int elem, int gather_rows, int mode) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int lane = i % cols;
  if (mode == LOOP_FLOAT) {
    const float* t = (const float*)table;
    float v = ((const float*)x)[i];
    for (int k = 0; k < iters; ++k) {
      for (int e = 0; e < elem; ++e) {
        v = v * 1.000001f + 0.5f;
        v = v - floorf(v);
      }
      if (gather_rows > 0) {
        const int j = __float_as_int(v) & (gather_rows - 1);
        v = v + take_row(t, table_rows, cols, j, lane) * 1e-9f;
      }
    }
    ((float*)out)[i] = v;
  } else {
    const int* t = (const int*)table;
    const int base = ((const int*)x)[i];
    int acc = 0;
    for (int k = 0; k < iters; ++k) {
      int j = (base + k) % gather_rows;
      if (j < 0) j += gather_rows;
      acc += take_row(t, table_rows, cols, j, lane);
    }
    ((int*)out)[i] = acc;
  }
}

// The float step in two forms of the same bits. step_any takes any v: w =
// v*1.000001 + 0.5 (two roundings), less floorf(w); it leaves v in [0, 1] or
// NaN (a tiny negative w gives 1.0, an infinity NaN). step_unit takes v in
// [0, 1] or NaN: there w lies in [0.5, 1.500001], floor(w) is 1 exactly when
// w >= 1, and w - 1 is exact (Sterbenz), so the step is w less 0 or 1. w is a
// monotone function of v, and w >= 1 exactly when v >= LOOP_WRAP_AT, so the
// 0 or 1 comes from v (one FSET) beside the multiply: the step's chain is the
// multiply, the add and the subtract. A NaN compares false and stays NaN.
// tests/test_torch_gather.py checks both claims on every float32 in range.
constexpr float LOOP_WRAP_AT = 0x1.ffffdep-2f;  // 0.4999995f, 0x3effffef

__device__ __forceinline__ float step_any(float v) {
  v = v * 1.000001f + 0.5f;
  return v - floorf(v);
}

__device__ __forceinline__ float step_unit(float v) {
  float wrap;
  asm("set.ge.f32.f32 %0, %1, %2;" : "=f"(wrap) : "f"(v), "f"(LOOP_WRAP_AT));
  return (v * 1.000001f + 0.5f) - wrap;
}

template <int N>
__device__ __forceinline__ float steps_unit(float v) {
#pragma unroll
  for (int e = 0; e < N; ++e) v = step_unit(v);
  return v;
}

// `count` steps of step_unit: eight a trip of the loop, then the rest.
__device__ __forceinline__ float steps_unit(float v, long long count) {
  for (; count >= 8; count -= 8) v = steps_unit<8>(v);
  if (count & 4) v = steps_unit<4>(v);
  if (count & 2) v = steps_unit<2>(v);
  if (count & 1) v = step_unit(v);
  return v;
}

// (x + k) mod rows, x + k wrapping as the first form's int sum does.
__device__ __forceinline__ int loop_row(unsigned x, int k, int rows) {
  const int j = (int)(x + (unsigned)k) % rows;
  return j < 0 ? j + rows : j;
}

// loop_probe_kernel's function, bit for bit, in its ranged form. The float
// loop takes step_any where v may lie outside [0, 1] (the first step, and
// the first step after each gather: the table may hold anything) and
// step_unit everywhere else. The integer loop's rows do not depend on the
// sum: it issues eight trips' loads before it adds them (int32 words, added
// modulo 2^32 in any order, give the same sum), and it runs in blocks of one
// warp (launch_loop_probe). The float gather's row depends on v, so its load
// stays on the chain.
__global__ void __launch_bounds__(BLOCK)
loop_probe_ranged_kernel(const void* __restrict__ x,
                         const void* __restrict__ table, void* __restrict__ out,
                         int n, int cols, int table_rows, int iters, int elem,
                         int gather_rows, int mode) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int lane = i % cols;
  if (mode == LOOP_FLOAT) {
    const float* t = (const float*)table;
    float v = ((const float*)x)[i];
    if (gather_rows > 0) {
      for (int k = 0; k < iters; ++k) {
        if (elem > 0) v = steps_unit(step_any(v), elem - 1);
        const int j = __float_as_int(v) & (gather_rows - 1);
        v = v + take_row(t, table_rows, cols, j, lane) * 1e-9f;
      }
    } else if (iters > 0 && elem > 0) {
      v = steps_unit(step_any(v), (long long)iters * elem - 1);
    }
    ((float*)out)[i] = v;
  } else {
    const int* t = (const int*)table;
    const unsigned base = (unsigned)((const int*)x)[i];
    unsigned acc = 0;
    int k = 0;
    for (; k <= iters - 8; k += 8) {
      int row[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        row[u] = take_row(t, table_rows, cols, loop_row(base, k + u, gather_rows),
                          lane);
#pragma unroll
      for (int u = 0; u < 8; ++u) acc += (unsigned)row[u];
    }
    for (; k < iters; ++k)
      acc += (unsigned)take_row(t, table_rows, cols,
                                loop_row(base, k, gather_rows), lane);
    ((int*)out)[i] = (int)acc;
  }
}

__device__ __forceinline__ float sum3(float x, float y, float z) {
  return (x + y) + z;
}

// What the cotangent of max(x, y), min(x, y) passes to x: all of it where x
// wins, half at a tie, none where y wins.
__device__ __forceinline__ float pass_above(float x, float bound) {
  return x > bound ? 1.0f : (x == bound ? 0.5f : 0.0f);
}

__device__ __forceinline__ float pass_below(float x, float bound) {
  return x < bound ? 1.0f : (x == bound ? 0.5f : 0.0f);
}

// The forward's values for one hit ray, kept for both directions.
struct Shaded {
  float sky[3];
  float alb[3], nrm[3], den;
  float m[3];       // minus the normalised light direction
  float ss, r;      // |nrm|^2, sqrt(max(ss, 1e-12))
  float nn[3];      // nrm / r
  float dot, sh;    // nn . m; max(dot, 0) * intensity + ambient
  float alpha;      // clip(den, 0, 1)
};

// The procedural vertical gradient of render.sky_color for a ray whose
// direction has y component `dy`.
__device__ __forceinline__ void gradient_sky(float dy, float s[3]) {
  const float hor[3] = {0.71f, 0.82f, 0.95f};
  const float zen[3] = {0.22f, 0.42f, 0.80f};
  const float t = fminf(fmaxf(dy * 0.5f + 0.5f, 0.0f), 1.0f);
  for (int c = 0; c < 3; ++c) s[c] = hor[c] * (1.0f - t) + zen[c] * t;
}

// The sky of ray i: the texture's sample handed in, or the gradient.
__device__ __forceinline__ void sky_of(const float* __restrict__ d,
                                       const float* __restrict__ sky, int i,
                                       float s[3]) {
  if (sky != nullptr) {
    for (int c = 0; c < 3; ++c) s[c] = sky[(size_t)i * 3 + c];
    return;
  }
  gradient_sky(d[(size_t)i * 3 + 1], s);
}

// Minus the normalised light direction.
__device__ __forceinline__ void light_dir(const float* __restrict__ light,
                                          float m[3]) {
  const float l0 = light[0], l1 = light[1], l2 = light[2];
  const float len = sqrtf(sum3(l0 * l0, l1 * l1, l2 * l2));
  m[0] = -(l0 / len);
  m[1] = -(l1 / len);
  m[2] = -(l2 / len);
}

// v.m must hold light_dir's result.
__device__ __forceinline__ void shade_ray(
    int leaf, const float* __restrict__ albedo,
    const float* __restrict__ normal, const float* __restrict__ density,
    int n_leaves, float intensity, float ambient, Shaded& v) {
  for (int c = 0; c < 3; ++c) {
    v.alb[c] = take_row(albedo, n_leaves, 3, leaf, c);
    v.nrm[c] = take_row(normal, n_leaves, 3, leaf, c);
  }
  v.den = take_row(density, n_leaves, 1, leaf, 0);
  v.ss = sum3(v.nrm[0] * v.nrm[0], v.nrm[1] * v.nrm[1], v.nrm[2] * v.nrm[2]);
  v.r = sqrtf(fmaxf(v.ss, 1e-12f));
  for (int c = 0; c < 3; ++c) v.nn[c] = v.nrm[c] / v.r;
  v.dot = sum3(v.nn[0] * v.m[0], v.nn[1] * v.m[1], v.nn[2] * v.m[2]);
  v.sh = fmaxf(v.dot, 0.0f) * intensity + ambient;
  v.alpha = fminf(fmaxf(v.den, 0.0f), 1.0f);
}

__global__ void __launch_bounds__(BLOCK)
shade_fwd_kernel(const int* __restrict__ hit_leaf, const float* __restrict__ d,
                 const float* __restrict__ albedo,
                 const float* __restrict__ normal,
                 const float* __restrict__ density, int n_leaves,
                 const float* __restrict__ light, float intensity,
                 float ambient, const float* __restrict__ sky,
                 float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Shaded v;
  sky_of(d, sky, i, v.sky);
  const int leaf = hit_leaf[i];
  if (leaf < 0) {  // a miss reads no row: 0 * lit + (1 - 0) * sky
    for (int c = 0; c < 3; ++c) out[(size_t)i * 3 + c] = v.sky[c];
    return;
  }
  light_dir(light, v.m);
  shade_ray(leaf, albedo, normal, density, n_leaves, intensity, ambient, v);
  for (int c = 0; c < 3; ++c) {
    out[(size_t)i * 3 + c] =
        v.alpha * (v.alb[c] * v.sh) + (1.0f - v.alpha) * v.sky[c];
  }
}

// The normal's cotangent d_nrm (3) from that of sh = max(dot, 0) *
// intensity + ambient, dot = nn . m.
__device__ __forceinline__ void normal_cot(const Shaded& v, float d_sh,
                                           float intensity, float d_nrm[3]) {
  const float d_dot = d_sh * intensity * pass_above(v.dot, 0.0f);
  float d_nn[3];
  for (int c = 0; c < 3; ++c) d_nn[c] = d_dot * v.m[c];
  // nn = nrm / r, r = sqrt(max(ss, 1e-12)), ss = |nrm|^2: the normal's
  // cotangent comes out tangent to the normal
  const float d_r =
      -sum3(d_nn[0] * v.nn[0], d_nn[1] * v.nn[1], d_nn[2] * v.nn[2]) / v.r;
  const float d_ss = d_r / (2.0f * v.r) * pass_above(v.ss, 1e-12f);
  for (int c = 0; c < 3; ++c)
    d_nrm[c] = d_nn[c] / v.r + d_ss * (2.0f * v.nrm[c]);
}

// The cotangents of a hit ray's parameter row (albedo 3, normal 3, density
// 1) from its image cotangent gi.
__device__ __forceinline__ void bwd_row(const Shaded& v, const float gi[3],
                                        float intensity, float row[7]) {
  float d_lit[3];
  // out = alpha * lit + (1 - alpha) * sky, lit = alb * sh
  const float d_alpha =
      sum3(gi[0] * (v.alb[0] * v.sh), gi[1] * (v.alb[1] * v.sh),
           gi[2] * (v.alb[2] * v.sh)) -
      sum3(gi[0] * v.sky[0], gi[1] * v.sky[1], gi[2] * v.sky[2]);
  for (int c = 0; c < 3; ++c) {
    d_lit[c] = gi[c] * v.alpha;
    row[c] = d_lit[c] * v.sh;
  }
  // alpha = min(max(den, 0), 1)
  const float through_max = pass_above(v.den, 0.0f);
  const float through_min = pass_below(fmaxf(v.den, 0.0f), 1.0f);
  row[6] = d_alpha * through_min * through_max;
  const float d_sh =
      sum3(d_lit[0] * v.alb[0], d_lit[1] * v.alb[1], d_lit[2] * v.alb[2]);
  normal_cot(v, d_sh, intensity, row + 3);
}

// cot (n, 7): the cotangents of albedo (3), normal (3) and density of the
// ray's row; zero for a miss. The first form: a thread a ray, every word of
// its rows read or written on its own.
__global__ void __launch_bounds__(BLOCK)
shade_bwd_serial_kernel(const float* __restrict__ g,
                        const int* __restrict__ hit_leaf,
                        const float* __restrict__ d,
                        const float* __restrict__ albedo,
                        const float* __restrict__ normal,
                        const float* __restrict__ density, int n_leaves,
                        const float* __restrict__ light, float intensity,
                        float ambient, const float* __restrict__ sky,
                        float* __restrict__ cot, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float* row = cot + (size_t)i * 7;
  const int leaf = hit_leaf[i];
  if (leaf < 0) {
    for (int c = 0; c < 7; ++c) row[c] = 0.0f;
    return;
  }
  Shaded v;
  sky_of(d, sky, i, v.sky);
  light_dir(light, v.m);
  shade_ray(leaf, albedo, normal, density, n_leaves, intensity, ambient, v);
  float gi[3], out[7];
  for (int c = 0; c < 3; ++c) gi[c] = g[(size_t)i * 3 + c];
  bwd_row(v, gi, intensity, out);
  for (int c = 0; c < 7; ++c) row[c] = out[c];
}

// dst[0, count) = src[0, count), the block's threads side by side: 16-byte
// moves where both ends allow them (dst in shared memory is 16-byte
// aligned), words where not.
__device__ __forceinline__ void copy_rows(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int count, bool load) {
  const bool wide = ((reinterpret_cast<uintptr_t>(load ? src : dst) & 15) == 0);
  int done = 0;
  if (wide) {
    const int quads = count / 4;
    for (int q = threadIdx.x; q < quads; q += blockDim.x) {
      const float4 x = load ? __ldg(reinterpret_cast<const float4*>(src) + q)
                            : reinterpret_cast<const float4*>(src)[q];
      reinterpret_cast<float4*>(dst)[q] = x;
    }
    done = quads * 4;
  }
  for (int k = done + threadIdx.x; k < count; k += blockDim.x)
    dst[k] = load ? __ldg(src + k) : src[k];
}

// cot (n, 7) as shade_bwd_serial writes it, bit for bit. A block's 256 rays
// move through shared memory: their image cotangents and sky inputs (the
// texture's rows, or the directions for the gradient) come in as coalesced
// 16-byte loads, each thread shades its ray from there and leaves its seven
// cotangents (or zeros for a miss, which reads no parameter row) in the
// staged tile, and the tile goes out as coalesced 16-byte stores. Each hit
// ray's thread normalises the light, as the first form does: normalising it
// once a block, into shared memory, measured no faster on an H100.
__global__ void __launch_bounds__(BLOCK)
shade_bwd_kernel(const float* __restrict__ g, const int* __restrict__ hit_leaf,
                 const float* __restrict__ d, const float* __restrict__ albedo,
                 const float* __restrict__ normal,
                 const float* __restrict__ density, int n_leaves,
                 const float* __restrict__ light, float intensity,
                 float ambient, const float* __restrict__ sky,
                 float* __restrict__ cot, int n) {
  __shared__ __align__(16) float s_g[BLOCK * 3];
  __shared__ __align__(16) float s_sky[BLOCK * 3];
  __shared__ __align__(16) float s_cot[BLOCK * 7];
  const int first = blockIdx.x * BLOCK;
  const int rays = min(BLOCK, n - first);
  const int tid = threadIdx.x;
  copy_rows(s_g, g + (size_t)first * 3, rays * 3, true);
  copy_rows(s_sky, (sky != nullptr ? sky : d) + (size_t)first * 3, rays * 3,
            true);
  __syncthreads();
  if (tid < rays) {
    float* row = s_cot + tid * 7;
    const int leaf = hit_leaf[first + tid];
    if (leaf < 0) {
      for (int c = 0; c < 7; ++c) row[c] = 0.0f;
    } else {
      Shaded v;
      if (sky != nullptr) {
        for (int c = 0; c < 3; ++c) v.sky[c] = s_sky[tid * 3 + c];
      } else {
        gradient_sky(s_sky[tid * 3 + 1], v.sky);
      }
      light_dir(light, v.m);
      shade_ray(leaf, albedo, normal, density, n_leaves, intensity, ambient, v);
      float out[7];
      bwd_row(v, s_g + tid * 3, intensity, out);
      for (int c = 0; c < 7; ++c) row[c] = out[c];
    }
  }
  __syncthreads();
  copy_rows(cot + (size_t)first * 7, s_cot, rays * 7, false);
}

// keys (n,): leaf ids in ascending order, misses marked by a key outside
// [0, n_leaves); order (n,): the ray each sorted position came from. The
// outputs come zero-filled. The thread at the head of each leaf's run adds
// the run's rows one after another in that (= ray) order, from +0.
__global__ void __launch_bounds__(BLOCK)
segment_sum_sorted_kernel(const float* __restrict__ cot,
                          const int* __restrict__ keys,
                          const int64_t* __restrict__ order, int n,
                          int n_leaves, float* __restrict__ g_alb,
                          float* __restrict__ g_nrm,
                          float* __restrict__ g_den) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int key = keys[i];
  if (key < 0 || key >= n_leaves) return;
  if (i > 0 && keys[i - 1] == key) return;  // not the head of its run
  float s[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int j = i; j < n && keys[j] == key; ++j) {
    const float* row = cot + (size_t)order[j] * 7;
    for (int c = 0; c < 7; ++c) s[c] = s[c] + row[c];
  }
  for (int c = 0; c < 3; ++c) {
    g_alb[(size_t)key * 3 + c] = s[c];
    g_nrm[(size_t)key * 3 + c] = s[3 + c];
  }
  g_den[key] = s[6];
}

constexpr int SEG_SHORT = 16;    // the longest run a leaf's own thread takes
constexpr int SEG_BLOCK = 512;   // threads of a block that takes a long run
constexpr int SEG_STAGE = 2048;  // ray ids a block sorts in shared memory
constexpr int SEG_ROWS = 512;    // cotangent rows a block stages at a time
constexpr int SEG_GRID = 264;    // blocks of seg_long: two an SM

// The leaf ray i adds to: -1 for a miss, else its id clamped to the table.
__device__ __forceinline__ int seg_leaf(const int* __restrict__ hit_leaf, int i,
                                        int n_leaves) {
  const int leaf = hit_leaf[i];
  return leaf < 0 ? -1 : min(leaf, n_leaves - 1);
}

__device__ __forceinline__ void seg_write(int leaf, const float s[7],
                                          float* __restrict__ g_alb,
                                          float* __restrict__ g_nrm,
                                          float* __restrict__ g_den) {
  for (int c = 0; c < 3; ++c) {
    g_alb[(size_t)leaf * 3 + c] = s[c];
    g_nrm[(size_t)leaf * 3 + c] = s[3 + c];
  }
  g_den[leaf] = s[6];
}

__global__ void __launch_bounds__(BLOCK)
seg_count_kernel(const int* __restrict__ hit_leaf, int n, int n_leaves,
                 int* __restrict__ count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int leaf = seg_leaf(hit_leaf, i, n_leaves);
  if (leaf >= 0) atomicAdd(count + leaf, 1);
}

// cursor[leaf] = the first slot of the leaf's segment of the ray list. The
// block scans its leaves' counts and reserves their slots with one atomicAdd
// on the running total.
__global__ void __launch_bounds__(BLOCK)
seg_base_kernel(const int* __restrict__ count, int n_leaves,
                int* __restrict__ total, int* __restrict__ cursor) {
  __shared__ int s_warp[BLOCK / 32];
  __shared__ int s_base;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int leaf = blockIdx.x * blockDim.x + tid;
  const int c = leaf < n_leaves ? count[leaf] : 0;
  int incl = c;  // inclusive scan over the warp
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(0xFFFFFFFFu, incl, off);
    if (lane >= off) incl += up;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (tid == 0) {
    int sum = 0;
    for (int w = 0; w < BLOCK / 32; ++w) {
      const int t = s_warp[w];
      s_warp[w] = sum;
      sum += t;
    }
    s_base = sum > 0 ? atomicAdd(total, sum) : 0;
  }
  __syncthreads();
  if (c > 0) cursor[leaf] = s_base + s_warp[warp] + (incl - c);
}

// After this pass cursor[leaf] is the end of the leaf's segment.
__global__ void __launch_bounds__(BLOCK)
seg_place_kernel(const int* __restrict__ hit_leaf, int n, int n_leaves,
                 int* __restrict__ cursor, int* __restrict__ rays) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int leaf = seg_leaf(hit_leaf, i, n_leaves);
  if (leaf >= 0) rays[atomicAdd(cursor + leaf, 1)] = i;
}

__global__ void __launch_bounds__(BLOCK)
seg_sum_kernel(const float* __restrict__ cot, const int* __restrict__ count,
               const int* __restrict__ cursor, const int* __restrict__ rays,
               int n_leaves, int* __restrict__ n_long,
               int* __restrict__ long_leaves, float* __restrict__ g_alb,
               float* __restrict__ g_nrm, float* __restrict__ g_den) {
  const int leaf = blockIdx.x * blockDim.x + threadIdx.x;
  if (leaf >= n_leaves) return;
  const int c = count[leaf];
  if (c > SEG_SHORT) {  // seg_long writes this leaf
    long_leaves[atomicAdd(n_long, 1)] = leaf;
    return;
  }
  float s[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (c > 0) {
    const int* seg = rays + (cursor[leaf] - c);
    int prev = -1;
    for (int k = 0; k < c; ++k) {
      int next = INT_MAX;  // the smallest id above prev
      for (int j = 0; j < c; ++j) {
        const int r = seg[j];
        if (r > prev && r < next) next = r;
      }
      const float* row = cot + (size_t)next * 7;
      for (int col = 0; col < 7; ++col) s[col] = s[col] + row[col];
      prev = next;
    }
  }
  seg_write(leaf, s, g_alb, g_nrm, g_den);
}

// ids[0, c) ascending, by the threads of one block. A bitonic network in
// which every comparator puts the smaller id at the lower index: positions
// from c up to the next power of two count as +infinity, stay where they
// are, and are never touched, so c need not be a power of two. Each pass
// pairs every position with one other, so no two threads share an id.
__device__ void seg_sort(int* ids, int c) {
  for (int k = 2; k < 2 * c; k <<= 1) {
    for (int mask = k - 1; mask > 0; mask = mask == k - 1 ? k >> 2 : mask >> 1) {
      for (int i = threadIdx.x; i < c; i += blockDim.x) {
        const int l = i ^ mask;
        if (l > i && l < c) {
          const int a = ids[i], b = ids[l];
          if (b < a) {
            ids[i] = b;
            ids[l] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(SEG_BLOCK)
seg_long_kernel(const float* __restrict__ cot, const int* __restrict__ count,
                const int* __restrict__ cursor, int* rays,
                const int* __restrict__ n_long,
                const int* __restrict__ long_leaves, float* __restrict__ g_alb,
                float* __restrict__ g_nrm, float* __restrict__ g_den) {
  __shared__ int s_ids[SEG_STAGE];
  __shared__ float s_rows[SEG_ROWS * 7];
  const int tid = threadIdx.x;
  const int n = *n_long;
  for (int b = blockIdx.x; b < n; b += gridDim.x) {
    const int leaf = long_leaves[b];
    const int c = count[leaf];
    int* ids = rays + (cursor[leaf] - c);
    if (c <= SEG_STAGE) {
      for (int j = tid; j < c; j += blockDim.x) s_ids[j] = ids[j];
      ids = s_ids;
    }
    __syncthreads();
    seg_sort(ids, c);
    float acc = 0.0f;  // thread `tid` < 7 holds column `tid`
    for (int done = 0; done < c; done += SEG_ROWS) {
      const int m = min(SEG_ROWS, c - done);
      for (int j = tid; j < m * 7; j += blockDim.x)
        s_rows[j] = __ldg(cot + (size_t)ids[done + j / 7] * 7 + j % 7);
      __syncthreads();
      if (tid < 7)
        for (int j = 0; j < m; ++j) acc = acc + s_rows[j * 7 + tid];
      __syncthreads();
    }
    if (tid < 3) g_alb[(size_t)leaf * 3 + tid] = acc;
    else if (tid < 6) g_nrm[(size_t)leaf * 3 + (tid - 3)] = acc;
    else if (tid == 6) g_den[leaf] = acc;
  }
}

// ---- composite_fwd ---------------------------------------------------------
// softplus as jax.nn.softplus computes it, logaddexp(x, 0).
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// One thread a ray over its k segments, left to right: each valid segment's
// parameter row, its Lambert colour and its opacity
// alpha = 1 - exp(-softplus(density) * density_scale * max(t_out - t_in, 0));
// the radiance sums transmittance * alpha * colour, the transmittance a
// running product of (1 - alpha) + 1e-9, and adds the sky behind the last
// segment at t_before(k-1) * (1 - alpha(k-1)). A padded slot (leaf < 0) has
// alpha 0 and reads no row.
__global__ void __launch_bounds__(BLOCK)
composite_fwd_kernel(const int* __restrict__ hit_leaf,
                     const float* __restrict__ t_in,
                     const float* __restrict__ t_out,
                     const float* __restrict__ d,
                     const float* __restrict__ albedo,
                     const float* __restrict__ normal,
                     const float* __restrict__ density, int n_leaves,
                     const float* __restrict__ light, float intensity,
                     float ambient, float density_scale, int k,
                     float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Shaded v;
  gradient_sky(d[(size_t)i * 3 + 1], v.sky);
  light_dir(light, v.m);
  float acc[3] = {0.0f, 0.0f, 0.0f};
  float t_before = 1.0f, t_before_last = 1.0f, alpha = 0.0f;
  for (int c = 0; c < k; ++c) {
    const size_t s = (size_t)i * k + c;
    const int leaf = hit_leaf[s];
    alpha = 0.0f;
    if (leaf >= 0) {
      shade_ray(leaf, albedo, normal, density, n_leaves, intensity, ambient, v);
      const float seg_len = fmaxf(t_out[s] - t_in[s], 0.0f);
      const float sigma = softplus(v.den) * density_scale;
      alpha = 1.0f - expf(-sigma * seg_len);
      const float w = t_before * alpha;
      for (int j = 0; j < 3; ++j) acc[j] = acc[j] + w * (v.alb[j] * v.sh);
    }
    t_before_last = t_before;
    t_before = t_before * (1.0f - alpha + 1e-9f);
  }
  const float t_final = t_before_last * (1.0f - alpha);
  for (int j = 0; j < 3; ++j)
    out[(size_t)i * 3 + j] = acc[j] + t_final * v.sky[j];
}

// Ray i's two passes over its k slots; `rows` (k rows of 7) is its slice
// of the block's shared memory.
__device__ __forceinline__ void composite_bwd_ray(
    const float* __restrict__ g, const int* __restrict__ hit_leaf,
    const float* __restrict__ t_in, const float* __restrict__ t_out,
    const float* __restrict__ d, const float* __restrict__ albedo,
    const float* __restrict__ normal, const float* __restrict__ density,
    int n_leaves, const float* __restrict__ light, float intensity,
    float ambient, float density_scale, int k, int i, float* rows) {
  // forward: the transmittance in front of each slot
  float t_before = 1.0f;
  for (int c = 0; c < k; ++c) {
    const size_t s = (size_t)i * k + c;
    const int leaf = hit_leaf[s];
    float alpha = 0.0f;
    if (leaf >= 0) {
      const float den = take_row(density, n_leaves, 1, leaf, 0);
      const float seg_len = fmaxf(t_out[s] - t_in[s], 0.0f);
      alpha = 1.0f - expf(-(softplus(den) * density_scale) * seg_len);
    }
    rows[c * 7 + 6] = t_before;
    t_before = t_before * (1.0f - alpha + 1e-9f);
  }
  Shaded v;
  gradient_sky(d[(size_t)i * 3 + 1], v.sky);
  light_dir(light, v.m);
  const float gi[3] = {g[(size_t)i * 3], g[(size_t)i * 3 + 1],
                       g[(size_t)i * 3 + 2]};
  const float d_final = sum3(gi[0] * v.sky[0], gi[1] * v.sky[1], gi[2] * v.sky[2]);
  float d_t = 0.0f;  // the cotangent of T_{j+1}
  for (int c = k - 1; c >= 0; --c) {
    const size_t s = (size_t)i * k + c;
    const int leaf = hit_leaf[s];
    const float t_j = rows[c * 7 + 6];
    float row[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float alpha = 0.0f, d_w = 0.0f;
    if (leaf >= 0) {
      shade_ray(leaf, albedo, normal, density, n_leaves, intensity, ambient, v);
      const float seg_len = fmaxf(t_out[s] - t_in[s], 0.0f);
      const float sp = softplus(v.den);
      const float e = expf(-(sp * density_scale) * seg_len);
      alpha = 1.0f - e;
      const float w = t_j * alpha;
      float d_col[3];
      for (int j = 0; j < 3; ++j) {
        d_col[j] = gi[j] * w;
        row[j] = d_col[j] * v.sh;
      }
      d_w = sum3(gi[0] * (v.alb[0] * v.sh), gi[1] * (v.alb[1] * v.sh),
                 gi[2] * (v.alb[2] * v.sh));
      const float d_sh = sum3(d_col[0] * v.alb[0], d_col[1] * v.alb[1],
                              d_col[2] * v.alb[2]);
      normal_cot(v, d_sh, intensity, row + 3);
      const float d_behind = c == k - 1 ? d_final : d_t;
      const float d_alpha = d_w * t_j - d_behind * t_j;
      row[6] = d_alpha * e * seg_len * density_scale * expf(v.den - sp);
    }
    d_t = c == k - 1 ? d_w * alpha + d_final * (1.0f - alpha)
                     : d_w * alpha + d_t * (1.0f - alpha + 1e-9f);
    for (int j = 0; j < 7; ++j) rows[c * 7 + j] = row[j];
  }
}

constexpr int BWD_BLOCK = 128;               // composite_bwd's widest block
constexpr int SMEM_MAX = 227 * 1024;         // shared memory a block can have
constexpr int COMPOSITE_BWD_MAX_K = SMEM_MAX / (32 * 7 * 4);  // 259

// One thread a ray: the cotangent rows (albedo 3, normal 3, density 1) of
// its k slots from its image cotangent g, in two passes over the slots, in
// the block's shared memory; then the block's rows out in one run.
// Forward: each slot's opacity (its density row only) and transmittance
// T_j = T_{j-1} * ((1 - alpha_{j-1}) + 1e-9), T_0 = 1, parked in column 6
// of the slot's row. Reverse, from the last slot: the slot's row and
// shading again, dw = g . colour, and with dT the cotangent carried from
// behind (for the last slot, that of the sky's factor (1 - alpha) through
// dTf = g . sky):
//   d_alpha = dw * T_j - dT * T_j     (dT * T_j from f_j = (1 - alpha) + 1e-9,
//                                      or from 1 - alpha for the last slot)
//   dT     <- dw * alpha + dT * f_j   (dT * (1 - alpha) for the last slot)
// then alpha = (1 - exp(-x)) * valid, x = softplus(den) * scale * len:
// d_den = d_alpha * exp(-x) * len * scale * exp(den - softplus(den)), the
// derivative jax.nn.softplus's logaddexp gives. A padded slot (leaf < 0)
// has alpha 0, passes dT on times (1 + 1e-9) and gets a zero row.
__global__ void __launch_bounds__(BWD_BLOCK)
composite_bwd_kernel(const float* __restrict__ g,
                     const int* __restrict__ hit_leaf,
                     const float* __restrict__ t_in,
                     const float* __restrict__ t_out,
                     const float* __restrict__ d,
                     const float* __restrict__ albedo,
                     const float* __restrict__ normal,
                     const float* __restrict__ density, int n_leaves,
                     const float* __restrict__ light, float intensity,
                     float ambient, float density_scale, int k,
                     float* __restrict__ cot, int n) {
  extern __shared__ float s_rows[];  // blockDim.x * k rows of 7
  const int i0 = blockIdx.x * blockDim.x;
  const int i = i0 + threadIdx.x;
  if (i < n) composite_bwd_ray(g, hit_leaf, t_in, t_out, d, albedo, normal,
                               density, n_leaves, light, intensity, ambient,
                               density_scale, k, i,
                               s_rows + (size_t)threadIdx.x * k * 7);
  __syncthreads();
  const size_t words = (size_t)min((int)blockDim.x, n - i0) * k * 7;
  float* const out = cot + (size_t)i0 * k * 7;
  for (size_t w = threadIdx.x; w < words; w += blockDim.x) out[w] = s_rows[w];
}

inline int blocks_for(int n) { return (n + BLOCK - 1) / BLOCK; }

}  // namespace

extern "C" int take(const void* table, const void* idx, void* out, int n,
                    int rows, int cols, int mode, void* stream) {
  if (mode < TAKE_1D || mode > TAKE_ONEHOT || rows < 1 || cols < 1)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    take_kernel<<<blocks_for(n), BLOCK, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)table, (const int*)idx, (uint32_t*)out, n, rows, cols,
        mode);
  }
  return (int)cudaGetLastError();
}

static int launch_loop_probe(bool ranged, const void* x, const void* table,
                             void* out, int n, int cols, int table_rows,
                             int iters, int elem, int gather_rows, int mode,
                             void* stream) {
  if (mode < LOOP_FLOAT || mode > LOOP_INT || cols < 1 || iters < 0 ||
      elem < 0 || gather_rows < 0)
    return (int)cudaErrorInvalidValue;
  if ((gather_rows > 0 || mode == LOOP_INT) &&
      (table == nullptr || table_rows < 1 || gather_rows < 1))
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    // the ranged form's integer loop in blocks of one warp: the probe's 1,024
    // elements then spread over 32 SMs, not 4, and so do their scattered
    // loads (every lane of a warp reads another row)
    const int threads = ranged && mode == LOOP_INT ? 32 : BLOCK;
    auto kernel = ranged ? loop_probe_ranged_kernel : loop_probe_kernel;
    kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        x, table, out, n, cols, table_rows, iters, elem, gather_rows, mode);
  }
  return (int)cudaGetLastError();
}

extern "C" int loop_probe(const void* x, const void* table, void* out, int n,
                          int cols, int table_rows, int iters, int elem,
                          int gather_rows, int mode, void* stream) {
  return launch_loop_probe(true, x, table, out, n, cols, table_rows, iters,
                           elem, gather_rows, mode, stream);
}

extern "C" int loop_probe_serial(const void* x, const void* table, void* out,
                                 int n, int cols, int table_rows, int iters,
                                 int elem, int gather_rows, int mode,
                                 void* stream) {
  return launch_loop_probe(false, x, table, out, n, cols, table_rows, iters,
                           elem, gather_rows, mode, stream);
}

extern "C" int shade_fwd(const void* hit_leaf, const void* d,
                         const void* albedo, const void* normal,
                         const void* density, int n_leaves, const void* light,
                         float intensity, float ambient, const void* sky,
                         void* out, int n, void* stream) {
  if (n_leaves < 1) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    shade_fwd_kernel<<<blocks_for(n), BLOCK, 0, (cudaStream_t)stream>>>(
        (const int*)hit_leaf, (const float*)d, (const float*)albedo,
        (const float*)normal, (const float*)density, n_leaves,
        (const float*)light, intensity, ambient, (const float*)sky,
        (float*)out, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int shade_bwd(const void* g, const void* hit_leaf, const void* d,
                         const void* albedo, const void* normal,
                         const void* density, int n_leaves, const void* light,
                         float intensity, float ambient, const void* sky,
                         void* cot, int n, void* stream) {
  if (n_leaves < 1) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    shade_bwd_kernel<<<blocks_for(n), BLOCK, 0, (cudaStream_t)stream>>>(
        (const float*)g, (const int*)hit_leaf, (const float*)d,
        (const float*)albedo, (const float*)normal, (const float*)density,
        n_leaves, (const float*)light, intensity, ambient, (const float*)sky,
        (float*)cot, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int shade_bwd_serial(const void* g, const void* hit_leaf,
                                const void* d, const void* albedo,
                                const void* normal, const void* density,
                                int n_leaves, const void* light,
                                float intensity, float ambient,
                                const void* sky, void* cot, int n,
                                void* stream) {
  if (n_leaves < 1) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    shade_bwd_serial_kernel<<<blocks_for(n), BLOCK, 0, (cudaStream_t)stream>>>(
        (const float*)g, (const int*)hit_leaf, (const float*)d,
        (const float*)albedo, (const float*)normal, (const float*)density,
        n_leaves, (const float*)light, intensity, ambient, (const float*)sky,
        (float*)cot, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int segment_sum_sorted(const void* cot, const void* keys,
                                  const void* order, int n, int n_leaves,
                                  void* g_alb, void* g_nrm, void* g_den,
                                  void* stream) {
  if (n_leaves < 1) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    segment_sum_sorted_kernel<<<blocks_for(n), BLOCK, 0,
                                (cudaStream_t)stream>>>(
        (const float*)cot, (const int*)keys, (const int64_t*)order, n,
        n_leaves, (float*)g_alb, (float*)g_nrm, (float*)g_den);
  }
  return (int)cudaGetLastError();
}

// The int32 words of scratch segment_sum needs for n rays and n_leaves
// leaves: count, the two counters, cursor, the ray list, the long leaves.
// ops/shade_cuda.py::segment_scratch_words is the wrapper's copy.
static long long segment_sum_scratch(int n, int n_leaves) {
  return 2LL * n_leaves + 2 + n + n / (SEG_SHORT + 1) + 1;
}

extern "C" int segment_sum(const void* hit_leaf, const void* cot, int n,
                           int n_leaves, void* scratch, long long scratch_words,
                           void* g_alb, void* g_nrm, void* g_den,
                           void* stream) {
  if (n_leaves < 1 || n < 0 ||
      scratch_words < segment_sum_scratch(n, n_leaves))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int* count = (int*)scratch;      // n_leaves, cleared
  int* total = count + n_leaves;   // slots reserved so far, cleared
  int* n_long = total + 1;         // long leaves listed so far, cleared
  int* cursor = n_long + 1;        // n_leaves, written where count > 0
  int* rays = cursor + n_leaves;   // n, the first `total` written
  int* long_leaves = rays + n;     // n / (SEG_SHORT + 1) + 1
  const cudaError_t cleared =
      cudaMemsetAsync(count, 0, ((size_t)n_leaves + 2) * sizeof(int), st);
  if (cleared != cudaSuccess) return (int)cleared;
  const int* leaf = (const int*)hit_leaf;
  if (n > 0) {
    seg_count_kernel<<<blocks_for(n), BLOCK, 0, st>>>(leaf, n, n_leaves, count);
    seg_base_kernel<<<blocks_for(n_leaves), BLOCK, 0, st>>>(count, n_leaves,
                                                            total, cursor);
    seg_place_kernel<<<blocks_for(n), BLOCK, 0, st>>>(leaf, n, n_leaves, cursor,
                                                      rays);
  }
  seg_sum_kernel<<<blocks_for(n_leaves), BLOCK, 0, st>>>(
      (const float*)cot, count, cursor, rays, n_leaves, n_long, long_leaves,
      (float*)g_alb, (float*)g_nrm, (float*)g_den);
  if (n > SEG_SHORT) {
    seg_long_kernel<<<SEG_GRID, SEG_BLOCK, 0, st>>>(
        (const float*)cot, count, cursor, rays, n_long, long_leaves,
        (float*)g_alb, (float*)g_nrm, (float*)g_den);
  }
  return (int)cudaGetLastError();
}

// The radiance of n rays of k segments each: hit_leaf, t_in, t_out (n, k),
// d (n, 3), the parameter tensors of n_leaves >= 1 leaves, out (n, 3).
extern "C" int composite_fwd(const void* hit_leaf, const void* t_in,
                             const void* t_out, const void* d,
                             const void* albedo, const void* normal,
                             const void* density, int n_leaves,
                             const void* light, float intensity, float ambient,
                             float density_scale, int k, void* out, int n,
                             void* stream) {
  if (n_leaves < 1 || k < 1) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    composite_fwd_kernel<<<blocks_for(n), BLOCK, 0, (cudaStream_t)stream>>>(
        (const int*)hit_leaf, (const float*)t_in, (const float*)t_out,
        (const float*)d, (const float*)albedo, (const float*)normal,
        (const float*)density, n_leaves, (const float*)light, intensity,
        ambient, density_scale, k, (float*)out, n);
  }
  return (int)cudaGetLastError();
}

// The cotangent rows cot (n * k, 7) of n rays of k <= COMPOSITE_BWD_MAX_K
// segments each from the image cotangent g (n, 3); the other arguments as
// composite_fwd's.
extern "C" int composite_bwd(const void* g, const void* hit_leaf,
                             const void* t_in, const void* t_out,
                             const void* d, const void* albedo,
                             const void* normal, const void* density,
                             int n_leaves, const void* light, float intensity,
                             float ambient, float density_scale, int k,
                             void* cot, int n, void* stream) {
  if (n_leaves < 1 || k < 1 || k > COMPOSITE_BWD_MAX_K)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    int threads = BWD_BLOCK;  // the widest block whose rows fit
    while (threads > 32 && (size_t)threads * k * 7 * 4 > SMEM_MAX) threads /= 2;
    const int smem = threads * k * 7 * 4;
    if (smem > 48 * 1024) {
      const cudaError_t set = cudaFuncSetAttribute(
          composite_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (set != cudaSuccess) return (int)set;
    }
    composite_bwd_kernel<<<(n + threads - 1) / threads, threads, smem,
                           (cudaStream_t)stream>>>(
        (const float*)g, (const int*)hit_leaf, (const float*)t_in,
        (const float*)t_out, (const float*)d, (const float*)albedo,
        (const float*)normal, (const float*)density, n_leaves,
        (const float*)light, intensity, ambient, density_scale, k,
        (float*)cot, n);
  }
  return (int)cudaGetLastError();
}
