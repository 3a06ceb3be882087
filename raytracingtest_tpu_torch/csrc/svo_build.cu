// The SVO builder on the card for Hopper, sm_90a: K7, the XLA programs of
// raytracingtest_tpu/ops/octree_device.py, as five kernels over the scene
// library scene.cuh. ops/octree_device.py (build_svo_device) drives them
// level by level; ops/octree_cuda.py holds their wrappers and plain versions.
//
//   svo_expand     replaces _expand_eval (:57), phase A: a thread per child
//                  of a parent candidate. The child's coordinates in Morton
//                  child order (x fastest, parent-major), the scene at its
//                  centre, the Lipschitz keep test against the level's two
//                  float32 thresholds, the child's record (x, y, z, f bits)
//                  and keep flag, and the block's kept count.
//   svo_compact    replaces _compact (:80), _compact_merged (:94) and every
//                  jnp.flatnonzero of the assembly and of phase D: a stable
//                  compaction of the flagged rows, each kept row's index and
//                  `width` 32-bit words of its record written at its rank.
//                  The rank within a warp by ballot and __popc, then the
//                  block's warp prefix (shared memory), then the block's
//                  offset (an exclusive scan of the blocks' counts, made with
//                  torch.cumsum outside, as jnp.cumsum is in the reference).
//                  Order is the layout, so it must be stable. Its count mode
//                  writes the blocks' counts of flags no other kernel counted.
//   svo_leaves     replaces _leaf_test (:143) and _leaf_attrs (:323), phases B
//                  and D: a thread per finest candidate. Solid centre and an
//                  air neighbour among the six one voxel away; for a survivor
//                  also the palette albedo and the central-difference normal
//                  (h = 1e-3, six more scene calls), written at the
//                  candidate's row (zeros elsewhere) for svo_compact to
//                  gather; the block's survivor count.
//   svo_level_up   replaces _level_up (:163) and _first_child (:174), phase C:
//                  a thread per surviving child (svo_compact's rows). It ORs
//                  1 << slot into its parent's valid mask and takes the
//                  minimum of its rank for the parent's first child, and marks
//                  the parent surviving. Integer atomics give the same result
//                  in any order: a (parent, slot) bit appears once, and the
//                  minimum rank is the first child because candidates are
//                  parent-major.
//   svo_parent_ptr replaces derive_parent_ptr_device (:341): a thread per
//                  node; a node with non-leaf children writes its own row into
//                  the rows child_base .. child_base + popc(valid & ~leaf) - 1.
//                  Every non-root row has one parent and the root points at
//                  itself, so no scan is needed.
//   scene_eval     the scene library at given points: the check of scene.cuh
//                  against the host's scenes. No build launches it.
//
// One thread an element in blocks of 256. What bounds them on this card:
// svo_expand and svo_leaves the scene's arithmetic (some 780 operations a
// `terrain` evaluation, scene.cuh) against 16 B read and 17 B written a
// child (a parent record is read by its eight children through L1); the
// rest bytes: svo_compact reads a flag and writes (1 + width) words a kept
// row, svo_level_up reads three words and makes two integer atomics a
// survivor, svo_parent_ptr reads two words a node and writes one.
// The design keeps every candidate array on the card: only the block
// counts' total crosses to the host, once a compaction, to size its output.

#include <cuda_runtime.h>

#include <cstdint>

#include "scene.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr int WARPS = BLOCK / 32;

inline int blocks_for(long long n) { return (int)((n + BLOCK - 1) / BLOCK); }

__global__ void __launch_bounds__(BLOCK)
    svo_expand_kernel(const int4* __restrict__ parents, int n, float scale,
                      float thr_hi, float thr_lo, int scene_id,
                      scene::Tables tables, int4* __restrict__ rec,
                      unsigned char* __restrict__ keep, int* __restrict__ counts) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  int kept = 0;
  if (i < n) {
    const int4 p = parents[i >> 3];
    const int s = i & 7;
    const int cx = p.x * 2 + (s & 1);
    const int cy = p.y * 2 + ((s >> 1) & 1);
    const int cz = p.z * 2 + ((s >> 2) & 1);
    const float px = ((float)cx + 0.5f) * scale;
    const float py = ((float)cy + 0.5f) * scale;
    const float pz = ((float)cz + 0.5f) * scale;
    const float f = scene::eval(scene_id, px, py, pz, tables);
    kept = (f <= thr_hi) && (f >= thr_lo);
    rec[i] = make_int4(cx, cy, cz, __float_as_int(f));
    keep[i] = (unsigned char)kept;
  }
  const int total = __syncthreads_count(kept);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

__global__ void __launch_bounds__(BLOCK)
    svo_count_kernel(const unsigned char* __restrict__ flags, int n,
                     int* __restrict__ counts) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const int total = __syncthreads_count(i < n && flags[i] != 0);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

__global__ void __launch_bounds__(BLOCK)
    svo_compact_kernel(const unsigned char* __restrict__ flags, int n,
                       const int* __restrict__ block_base,
                       const int* __restrict__ src, int width,
                       int* __restrict__ rows, int* __restrict__ words) {
  __shared__ int warp_total[WARPS];
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const bool kept = i < n && flags[i] != 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, kept);
  if (lane == 0) warp_total[warp] = __popc(ballot);
  __syncthreads();
  if (!kept) return;
  int pos = block_base[blockIdx.x] + __popc(ballot & ((1u << lane) - 1u));
  for (int w = 0; w < warp; ++w) pos += warp_total[w];
  rows[pos] = i;
  for (int c = 0; c < width; ++c)
    words[(size_t)pos * width + c] = src[(size_t)i * width + c];
}

__global__ void __launch_bounds__(BLOCK)
    svo_leaves_kernel(const int4* __restrict__ rec, int n, float fin,
                      int scene_id, scene::Tables tables,
                      unsigned char* __restrict__ survive,
                      float* __restrict__ attrs, int* __restrict__ counts) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  int leaf = 0;
  if (i < n) {
    const int4 c = rec[i];
    const float px = ((float)c.x + 0.5f) * fin;
    const float py = ((float)c.y + 0.5f) * fin;
    const float pz = ((float)c.z + 0.5f) * fin;
    const bool solid = __int_as_float(c.w) <= 0.f;
    if (solid) {
      // the host's six probes, all evaluated as there
      bool air = scene::eval(scene_id, px + fin, py, pz, tables) > 0.f;
      air |= scene::eval(scene_id, px - fin, py, pz, tables) > 0.f;
      air |= scene::eval(scene_id, px, py + fin, pz, tables) > 0.f;
      air |= scene::eval(scene_id, px, py - fin, pz, tables) > 0.f;
      air |= scene::eval(scene_id, px, py, pz + fin, tables) > 0.f;
      air |= scene::eval(scene_id, px, py, pz - fin, tables) > 0.f;
      leaf = air;
    }
    float a[3] = {0.f, 0.f, 0.f}, nrm[3] = {0.f, 0.f, 0.f};
    if (leaf) {
      scene::default_albedo(px, py, pz, a);
      scene::sampler_normal(scene_id, px, py, pz, tables, nrm);
    }
    float* row = attrs + (size_t)i * 6;
    row[0] = a[0];
    row[1] = a[1];
    row[2] = a[2];
    row[3] = nrm[0];
    row[4] = nrm[1];
    row[5] = nrm[2];
    survive[i] = (unsigned char)leaf;
  }
  const int total = __syncthreads_count(leaf);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

__global__ void __launch_bounds__(BLOCK)
    svo_level_up_kernel(const int* __restrict__ rows, int m,
                        const int* __restrict__ par,
                        const int* __restrict__ slot, int* __restrict__ rec,
                        unsigned char* __restrict__ survive) {
  const int pos = blockIdx.x * BLOCK + threadIdx.x;
  if (pos >= m) return;
  const int c = rows[pos];
  const int p = par[c];
  atomicOr(rec + 2 * (size_t)p, 1 << slot[c]);
  atomicMin(rec + 2 * (size_t)p + 1, pos);
  survive[p] = 1;
}

__global__ void __launch_bounds__(BLOCK)
    svo_parent_ptr_kernel(const int* __restrict__ masks,
                          const int* __restrict__ child_base, int n,
                          int* __restrict__ pptr) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  if (i == 0) pptr[0] = 0;
  const int m = masks[i];
  const int non_leaf = ((m >> 8) & ~m) & 0xFF;
  if (non_leaf == 0) return;
  const int base = child_base[i], cnt = __popc(non_leaf);
  for (int j = 0; j < cnt; ++j) pptr[base + j] = i;
}

__global__ void __launch_bounds__(BLOCK)
    scene_eval_kernel(const float* __restrict__ x, const float* __restrict__ y,
                      const float* __restrict__ z, int n, int scene_id,
                      scene::Tables tables, float* __restrict__ out) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i < n) out[i] = scene::eval(scene_id, x[i], y[i], z[i], tables);
}

scene::Tables make_tables(const void* perm, const void* perm3d,
                          const void* lut_d, const void* lut_sb,
                          const void* grads) {
  return scene::Tables{(const long long*)perm, (const long long*)perm3d,
                       (const double*)lut_d, (const long long*)lut_sb,
                       (const double*)grads};
}

bool bad_scene(int scene_id) {
  return scene_id < 0 || scene_id >= scene::N_SCENES;
}

}  // namespace

// Every entry launches on `stream` and returns cudaGetLastError(); one with
// nothing to do (n == 0) launches nothing. Blocks of BLOCK threads: the
// blocks' counts of svo_expand, svo_leaves and svo_compact's count mode
// have ceil(n / BLOCK) entries, and svo_compact reads block_base at the same
// blocks.

extern "C" int svo_expand(const void* parents, int n_children, float scale,
                          float thr_hi, float thr_lo, int scene_id,
                          const void* perm, const void* perm3d,
                          const void* lut_d, const void* lut_sb,
                          const void* grads, void* rec, void* keep,
                          void* counts, void* stream) {
  if (n_children < 0 || bad_scene(scene_id)) return (int)cudaErrorInvalidValue;
  if (n_children == 0) return (int)cudaGetLastError();
  svo_expand_kernel<<<blocks_for(n_children), BLOCK, 0, (cudaStream_t)stream>>>(
      (const int4*)parents, n_children, scale, thr_hi, thr_lo, scene_id,
      make_tables(perm, perm3d, lut_d, lut_sb, grads), (int4*)rec,
      (unsigned char*)keep, (int*)counts);
  return (int)cudaGetLastError();
}

// counts != null: count mode (the blocks' counts of nonzero flags); else
// place mode (rows and words of the flagged rows at their ranks).
extern "C" int svo_compact(const void* flags, int n, const void* block_base,
                           const void* src, int width, void* rows, void* words,
                           void* counts, void* stream) {
  if (n < 0 || width < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  if (counts != nullptr) {
    svo_count_kernel<<<blocks_for(n), BLOCK, 0, st>>>(
        (const unsigned char*)flags, n, (int*)counts);
  } else {
    svo_compact_kernel<<<blocks_for(n), BLOCK, 0, st>>>(
        (const unsigned char*)flags, n, (const int*)block_base,
        (const int*)src, width, (int*)rows, (int*)words);
  }
  return (int)cudaGetLastError();
}

extern "C" int svo_leaves(const void* rec, int n, float fin, int scene_id,
                          const void* perm, const void* perm3d,
                          const void* lut_d, const void* lut_sb,
                          const void* grads, void* survive, void* attrs,
                          void* counts, void* stream) {
  if (n < 0 || bad_scene(scene_id)) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  svo_leaves_kernel<<<blocks_for(n), BLOCK, 0, (cudaStream_t)stream>>>(
      (const int4*)rec, n, fin, scene_id,
      make_tables(perm, perm3d, lut_d, lut_sb, grads),
      (unsigned char*)survive, (float*)attrs, (int*)counts);
  return (int)cudaGetLastError();
}

extern "C" int svo_level_up(const void* rows, int m, const void* par,
                            const void* slot, void* rec, void* survive,
                            void* stream) {
  if (m < 0) return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaGetLastError();
  svo_level_up_kernel<<<blocks_for(m), BLOCK, 0, (cudaStream_t)stream>>>(
      (const int*)rows, m, (const int*)par, (const int*)slot, (int*)rec,
      (unsigned char*)survive);
  return (int)cudaGetLastError();
}

extern "C" int svo_parent_ptr(const void* masks, const void* child_base, int n,
                              void* pptr, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  svo_parent_ptr_kernel<<<blocks_for(n), BLOCK, 0, (cudaStream_t)stream>>>(
      (const int*)masks, (const int*)child_base, n, (int*)pptr);
  return (int)cudaGetLastError();
}

extern "C" int scene_eval(const void* x, const void* y, const void* z, int n,
                          int scene_id, const void* perm, const void* perm3d,
                          const void* lut_d, const void* lut_sb,
                          const void* grads, void* out, void* stream) {
  if (n < 0 || bad_scene(scene_id)) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  scene_eval_kernel<<<blocks_for(n), BLOCK, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)y, (const float*)z, n, scene_id,
      make_tables(perm, perm3d, lut_d, lut_sb, grads), (float*)out);
  return (int)cudaGetLastError();
}
