// The SVO builder on the card for Hopper, sm_90a: K7, the XLA programs of
// raytracingtest_tpu/ops/octree_device.py, as five kernels over the scene
// library scene.cuh. ops/octree_device.py (build_svo_device) drives them
// level by level; ops/octree_cuda.py holds their wrappers and plain versions.
//
//   svo_columns and svo_expand replace _expand_eval (:57), phase A.
//                  svo_expand: a thread per child of a parent candidate. The
//                  child's coordinates in Morton child order (x fastest,
//                  parent-major), the scene at its centre, the Lipschitz
//                  keep test against the level's two float32 thresholds,
//                  the child's record (x, y, z, f bits) and keep flag, and
//                  the block's kept count. For a heightfield (f = y - h(x,
//                  z): flat_ground, simplex, terrain, perlin; scene.cuh) the
//                  scene is not evaluated a child: svo_columns first
//                  evaluates h once a child column of the level, into a
//                  dense table over the square of columns the build can
//                  reach there (the whole world's 2^level wide, an octant
//                  build's 2^(level - root_level) from its corner), and
//                  the child's f is py - h[column], the same float32
//                  operations on the same operands as scene::eval's, so the
//                  same bits. svo_columns evaluates every column of the
//                  square: a heightfield's surface crosses every column, so
//                  the parents cover all or most of it, and a form that
//                  evaluated only the parents' columns (flags set by each
//                  parent first) measured slower on every build tried
//                  (PERF.md). A 3-D scene is evaluated a child, by
//                  svo_expand_kernel.
//   svo_expand_serial  the expansion's first form: svo_expand_kernel for
//                  every scene, the scene evaluated at every child (the first
//                  kernel, its code kept); on no build's path.
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
//   svo_leaves     replaces _leaf_test (:143), phase B: a thread per finest
//                  candidate, the solid centres' air test without the scene
//                  wherever the expansion already evaluated it. At the finest
//                  level the probe px +- fin is bit for bit the centre of the
//                  face neighbour c +- 1 (fin = 2^-depth: both are exact
//                  float32 values), and svo_expand evaluated the scene there
//                  (the same scene::eval on the same float32 point: the same
//                  bits under --fmad=false) for every child of a kept parent,
//                  kept or not. So the test reads the last level's
//                  uncompacted records, in three launches. A thread a kept
//                  parent first finds its three + face neighbours among the
//                  kept parents, which are in Morton order (candidates are
//                  parent-major), by a galloping search from its own row,
//                  and is each one's - neighbour along the same axis
//                  (svo_leaf_neighbours_kernel: the table). Then a thread a
//                  finest candidate (svo_leaf_test_kernel): a probe that
//                  stays inside the candidate's parent is the sibling at
//                  slot s ^ bit; one that crosses into the next parent is
//                  that parent's child at slot s ^ bit, through the table.
//                  Only a probe that no kept parent covers (outside [0,1)^3,
//                  outside an octant build's octant, or under a pruned
//                  parent) is left to the scene: a solid candidate whose
//                  covered probes show no air and which has such a probe
//                  goes to a needy list, and svo_leaf_eval_kernel evaluates
//                  its uncovered probes until one shows air, flagging and
//                  counting it. The test kernel holds no scene code, so its
//                  registers stay few. The survivor flag and the block's
//                  survivor count, nothing else: the leaves' attributes are
//                  svo_leaf_attrs' dense pass. A counting form adds the
//                  evaluations it made to a 64-bit total.
//   svo_leaf_attrs replaces _leaf_attrs (:323), phase D: a thread per leaf,
//                  over the leaves' records as svo_compact packed them, so
//                  that every lane of a warp holds a leaf: the palette albedo
//                  and the central-difference normal (h = 1e-3, six scene
//                  calls), written at the leaf's row.
//   svo_leaves_serial  the leaf test's first form (phases B and D in one
//                  pass): a thread per finest candidate, the six probes of a
//                  solid centre all evaluated as the host does, and a leaf's
//                  albedo and normal written at the candidate's row (zeros
//                  elsewhere) for svo_compact to gather; the block's survivor
//                  count. The new form's yardstick, on no build's path.
//   svo_level_pass replaces _level_up (:163), _first_child (:174), phase
//                  C's level counts and jnp.flatnonzero (:255-300) and
//                  derive_parent_ptr_device (:341): phases C and D in one
//                  launch a level, over the survivors of the level below
//                  (`rows`, in order). Candidates are parent-major, so the
//                  survivors of one parent form one run of at most 8 in
//                  `rows`: a parent survives where a run begins (its head,
//                  par[rows[pos]] != par[rows[pos - 1]]), its valid mask is
//                  the OR of its run's slot bits, its first child's rank is
//                  the head's position, its row in the level's node list is
//                  the count of heads before it, and that count is also each
//                  survivor's parent rank (its parent pointer less the
//                  level's start). A candidate's parent and slot come in
//                  one word, parent * 8 + slot (its index among the
//                  expansion's children), one gather a survivor. A block
//                  takes a tile of LTILE survivors by a ticket; warp w
//                  holds LITEMS rows of 32 consecutive
//                  entries, and one more row's first 8 lanes, the entries a
//                  run that crosses the warp's end may reach. A run's OR is a
//                  segmented suffix OR within a row (shuffles 1, 2, 4: a run
//                  is at most 8) and the next row's lane 0 where the run
//                  crosses into it; heads by ballot and __popc, the block's
//                  warp prefix in shared memory, the tile's prefix by a
//                  decoupled look-back (level_queue_lookback_kernel's in
//                  brick_trace.cu: a status word a tile tagged with the
//                  launch's epoch, one word a lane; the words zeroed once a
//                  build). It writes only what survives: each parent's
//                  (mask, first) and index at its rank, each survivor's
//                  parent rank, and the level's count, left on the device,
//                  where the next level's pass reads it: nothing is zeroed
//                  or filled over the parent candidates, no atomic touches a
//                  parent, no count or place pass follows and the host reads
//                  the counts once a build. Threads past the count on the
//                  device (the grid comes from a bound the host holds)
//                  return.
//   svo_level_up   the first form of phase C's level-up (the first
//                  kernel, its code kept), on no build's path: a thread per
//                  surviving child (svo_compact's rows). It ORs 1 << slot
//                  into its parent's valid mask and takes the minimum of its
//                  rank for the parent's first child, and marks the parent
//                  surviving; svo_compact then counts and places the
//                  parents. Integer atomics give the same result in any
//                  order: a (parent, slot) bit appears once, and the minimum
//                  rank is the first child because candidates are
//                  parent-major.
//   svo_parent_ptr the first form of phase D (the first kernel), on no
//                  build's path: a thread per node; a node with non-leaf
//                  children writes its own row into the rows child_base ..
//                  child_base + popc(valid & ~leaf) - 1. Every non-root row
//                  has one parent and the root points at itself, so no scan
//                  is needed.
//   scene_eval     the scene library at given points: the check of scene.cuh
//                  against the host's scenes. No build launches it.
//
// One thread an element in blocks of 256. What bounds them on this card:
// svo_expand_serial, svo_leaf_attrs and svo_leaves_serial the scene's
// arithmetic (some 780 operations a `terrain` evaluation, scene.cuh; with
// --fmad=false every add and multiply takes its own issue slot) against
// 16 B read and 17 B written a child (a parent record is read by its eight
// children through L1); svo_expand over a heightfield's columns its 17 B
// written a child (at depth 10, 27.7 M children over at most 2^20 columns,
// each evaluated once); svo_leaves its reads of the uncompacted records and of the
// parents its searches visit, and the few evaluations left; the rest
// bytes: svo_compact reads a flag and writes (1 + width) words a kept
// row, svo_level_pass reads two words a survivor (its row, and its
// parent * 8 + slot gathered) and writes one a survivor and three a
// surviving parent, svo_level_up reads three words and makes two integer atomics a
// survivor, svo_parent_ptr reads two words a node and writes one.
// The design keeps every candidate array on the card: phases A and B bring
// the block counts' total to the host once a compaction, to size its
// output; phase C brings its levels' counts once a build.

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

// ---- svo_columns, svo_expand over a heightfield's columns ------------------

// h at each column (x0 + jx, z0 + jz) of the side x side square, row jz.
__global__ void __launch_bounds__(BLOCK)
    svo_columns_kernel(int x0, int z0, int side, float scale, int scene_id,
                       float* __restrict__ h) {
  const int j = blockIdx.x * BLOCK + threadIdx.x;
  if (j >= side * side) return;
  const int jx = j & (side - 1), jz = j / side;
  // the child centre's x and z, as svo_expand_kernel makes them
  const float px = ((float)(x0 + jx) + 0.5f) * scale;
  const float pz = ((float)(z0 + jz) + 0.5f) * scale;
  h[j] = scene::height(scene_id, px, pz);
}

// svo_expand_kernel over a heightfield's column table h: f = py - h, no
// scene code.
__global__ void __launch_bounds__(BLOCK)
    svo_expand_columns_kernel(const int4* __restrict__ parents, int n,
                              float scale, float thr_hi, float thr_lo,
                              const float* __restrict__ h, int x0, int z0,
                              int side, int4* __restrict__ rec,
                              unsigned char* __restrict__ keep,
                              int* __restrict__ counts) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  int kept = 0;
  if (i < n) {
    const int4 p = __ldg(parents + (i >> 3));
    const int s = i & 7;
    const int cx = p.x * 2 + (s & 1);
    const int cy = p.y * 2 + ((s >> 1) & 1);
    const int cz = p.z * 2 + ((s >> 2) & 1);
    const float py = ((float)cy + 0.5f) * scale;
    const float f = py - __ldg(h + (size_t)(cz - z0) * side + (cx - x0));
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

// ---- svo_leaves: the leaf test over the expansion's values ----------------

// Whether integer point a precedes b in Morton order (x in bit 0 of each
// triple, as the candidates are ordered): the axis whose highest differing
// bit is highest decides, z before y before x on a tie. Coordinates are
// non-negative.
__device__ __forceinline__ bool morton_less(int ax, int ay, int az, int bx,
                                            int by, int bz) {
  const unsigned dx = ax ^ bx, dy = ay ^ by, dz = az ^ bz;
  int axis = 2;
  unsigned m = dz;
  if (m < dy && m < (m ^ dy)) {
    axis = 1;
    m = dy;
  }
  if (m < dx && m < (m ^ dx)) axis = 0;
  return axis == 0 ? ax < bx : (axis == 1 ? ay < by : az < bz);
}

// The row of the kept parent at (qx, qy, qz) among the n_par kept parents
// (Morton order), or -1: a galloping search from row p, the parent whose
// face neighbour q is, forward when q follows it (a + neighbour), backward
// when it precedes it. A face neighbour is mostly a few rows away.
__device__ __forceinline__ int find_parent(const int4* __restrict__ parents,
                                           int n_par, int p, int qx, int qy,
                                           int qz, bool forward) {
  auto before = [&](int row) {  // parents[row] precedes q
    const int4 r = __ldg(parents + row);
    return morton_less(r.x, r.y, r.z, qx, qy, qz);
  };
  auto after = [&](int row) {  // q precedes parents[row]
    const int4 r = __ldg(parents + row);
    return morton_less(qx, qy, qz, r.x, r.y, r.z);
  };
  int lo, hi;
  if (forward) {  // parents[p] precedes q
    lo = p;
    hi = p + 1;
    for (int step = 1; hi < n_par && before(hi);) {
      lo = hi;
      step <<= 1;
      hi = p + step;
    }
    if (hi > n_par) hi = n_par;
    // parents[lo] precedes q; hi == n_par or q does not follow parents[hi]
    while (hi - lo > 1) {
      const int mid = lo + (hi - lo) / 2;
      if (before(mid)) lo = mid; else hi = mid;
    }
    return (hi < n_par && !after(hi)) ? hi : -1;
  }
  hi = p;  // q precedes parents[p]
  lo = p - 1;
  for (int step = 1; lo >= 0 && after(lo);) {
    hi = lo;
    step <<= 1;
    lo = p - step;
  }
  if (lo < -1) lo = -1;
  // q precedes parents[hi]; lo == -1 or parents[lo] does not follow q
  while (hi - lo > 1) {
    const int mid = lo + (hi - lo) / 2;
    if (after(mid)) hi = mid; else lo = mid;
  }
  return (lo >= 0 && !before(lo)) ? lo : -1;
}

// Each kept parent's six face neighbours among the kept parents (rows, -1
// for none: outside the world or pruned), in the probes' order (+x, -x, +y,
// -y, +z, -z), over a table set to -1 before: a thread searches its parent's
// three + neighbours, and a neighbour q found along axis a has this parent
// as its - neighbour along a, so the thread writes that entry of q's too
// (one writer: q's - neighbour is one parent). The needy list's count is
// zeroed for the test.
__global__ void __launch_bounds__(BLOCK)
    svo_leaf_neighbours_kernel(const int4* __restrict__ parents, int n_par,
                               int cells, int* __restrict__ table,
                               int* __restrict__ n_needy) {
  const int p = blockIdx.x * BLOCK + threadIdx.x;
  if (p == 0) *n_needy = 0;
  if (p >= n_par) return;
  const int4 pc = __ldg(parents + p);
  for (int a = 0; a < 3; ++a) {
    const int qa = (a == 0 ? pc.x : (a == 1 ? pc.y : pc.z)) + 1;
    if (qa >= cells) continue;
    const int q = find_parent(parents, n_par, p, pc.x + (a == 0), pc.y + (a == 1),
                              pc.z + (a == 2), true);
    if (q < 0) continue;
    table[(size_t)6 * p + 2 * a] = q;
    table[(size_t)6 * q + 2 * a + 1] = p;
  }
}

// The axes of candidate c (slot s, parent p) whose crossing probe no kept
// parent covers, or -1 when a probe that the records cover shows air.
__device__ __forceinline__ int uncovered_axes(int s, int p,
                                              const int4* __restrict__ full,
                                              const int* __restrict__ table) {
  const int4* kids = full + (size_t)8 * p;
  // a probe along axis a stays inside the parent on the side of c's low
  // bit, and crosses into the next parent on the other: three siblings
  bool air = false;
  for (int a = 0; a < 3; ++a)
    air |= __int_as_float(__ldg(&kids[s ^ (1 << a)].w)) > 0.f;
  int todo = 0;
  for (int a = 0; a < 3 && !air; ++a) {
    const int up = (s >> a) & 1;  // the crossing probe goes up
    const int q = __ldg(table + (size_t)6 * p + 2 * a + (up ? 0 : 1));
    if (q < 0)
      todo |= 1 << a;
    else
      air = __int_as_float(__ldg(&full[(size_t)8 * q + (s ^ (1 << a))].w)) > 0.f;
  }
  return air ? -1 : todo;
}

__global__ void __launch_bounds__(BLOCK)
    svo_leaf_test_kernel(const int4* __restrict__ rec, int n,
                         const int* __restrict__ par,
                         const int4* __restrict__ full,
                         const int* __restrict__ table,
                         unsigned char* __restrict__ survive,
                         int* __restrict__ counts, int* __restrict__ needy,
                         int* __restrict__ n_needy) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  int leaf = 0;
  bool need = false;
  if (i < n) {
    const int4 c = __ldg(rec + i);
    if (__int_as_float(c.w) <= 0.f) {
      const int s = (c.x & 1) | ((c.y & 1) << 1) | ((c.z & 1) << 2);
      const int todo = uncovered_axes(s, __ldg(par + i), full, table);
      leaf = todo < 0;
      need = todo > 0;
    }
    survive[i] = (unsigned char)leaf;
  }
  // a solid centre whose covered probes show no air but some probe is not
  // covered: to the needy list, a warp's at one atomic
  const unsigned ballot = __ballot_sync(0xffffffffu, need);
  if (ballot) {
    const int lane = threadIdx.x & 31;
    int base = 0;
    if (lane == __ffs(ballot) - 1) base = atomicAdd(n_needy, __popc(ballot));
    base = __shfl_sync(0xffffffffu, base, __ffs(ballot) - 1);
    if (need) needy[base + __popc(ballot & ((1u << lane) - 1u))] = i;
  }
  const int total = __syncthreads_count(leaf);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

// The needy candidates: the host's probes where nothing covers them, until
// one shows air; a new leaf is flagged and counted in its block. COUNT: the
// evaluations made are summed into *evals. A grid of EVAL_BLOCKS strides
// over the list.
constexpr int EVAL_BLOCKS = 1024;

template <bool COUNT>
__global__ void __launch_bounds__(BLOCK)
    svo_leaf_eval_kernel(const int4* __restrict__ rec,
                         const int* __restrict__ par,
                         const int4* __restrict__ full,
                         const int* __restrict__ table,
                         const int* __restrict__ needy,
                         const int* __restrict__ n_needy, float fin,
                         int scene_id, scene::Tables tables,
                         unsigned char* __restrict__ survive,
                         int* __restrict__ counts,
                         unsigned long long* __restrict__ evals) {
  const int m = *n_needy;
  int made = 0;
  for (int j = blockIdx.x * BLOCK + threadIdx.x; j < m; j += EVAL_BLOCKS * BLOCK) {
    const int i = needy[j];
    const int4 c = __ldg(rec + i);
    const int s = (c.x & 1) | ((c.y & 1) << 1) | ((c.z & 1) << 2);
    const int todo = uncovered_axes(s, __ldg(par + i), full, table);
    const float px = ((float)c.x + 0.5f) * fin;
    const float py = ((float)c.y + 0.5f) * fin;
    const float pz = ((float)c.z + 0.5f) * fin;
    bool air = false;
    for (int a = 0; a < 3 && !air; ++a) {
      if (!((todo >> a) & 1)) continue;
      const float sgn = ((s >> a) & 1) ? fin : -fin;
      ++made;
      air = scene::eval(scene_id, a == 0 ? px + sgn : px,
                        a == 1 ? py + sgn : py, a == 2 ? pz + sgn : pz,
                        tables) > 0.f;
    }
    if (air) {
      survive[i] = 1;
      atomicAdd(counts + i / BLOCK, 1);
    }
  }
  if (COUNT) {
    __shared__ int block_made;
    if (threadIdx.x == 0) block_made = 0;
    __syncthreads();
    if (made) atomicAdd(&block_made, made);
    __syncthreads();
    if (threadIdx.x == 0 && block_made)
      atomicAdd(evals, (unsigned long long)block_made);
  }
}

__global__ void __launch_bounds__(BLOCK)
    svo_leaf_attrs_kernel(const int4* __restrict__ leaf_rec, int m, float fin,
                          int scene_id, scene::Tables tables,
                          float* __restrict__ attrs) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= m) return;
  const int4 c = __ldg(leaf_rec + i);
  const float px = ((float)c.x + 0.5f) * fin;
  const float py = ((float)c.y + 0.5f) * fin;
  const float pz = ((float)c.z + 0.5f) * fin;
  float a[3], nrm[3];
  scene::default_albedo(px, py, pz, a);
  scene::sampler_normal(scene_id, px, py, pz, tables, nrm);
  float* row = attrs + (size_t)i * 6;
  row[0] = a[0];
  row[1] = a[1];
  row[2] = a[2];
  row[3] = nrm[0];
  row[4] = nrm[1];
  row[5] = nrm[2];
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

// ---- svo_level_pass: phases C and D, one pass a level ------------------------

// svo_level_pass_kernel's tiles: LITEMS rows of 32 entries a warp, LTILE a
// block
constexpr int LITEMS = 8, LWARP = 32 * LITEMS, LTILE = BLOCK * LITEMS;
// a run's length: a parent's children
constexpr int RUN = 8;
// a tile's status word: (epoch << 2 | flag) << 32 | value, the epoch's low
// 30 bits; flag 0 (or an earlier epoch): not published yet
constexpr unsigned L_AGGREGATE = 1, L_PREFIX = 2, L_EPOCH_MASK = 0x3fffffffu;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void l_publish(unsigned long long* word, unsigned epoch,
                                          unsigned flag, int value) {
  *(volatile unsigned long long*)word =
      ((unsigned long long)((epoch << 2) | flag) << 32) | (unsigned)value;
}

// The flag of a tile's status word in this launch (0: not published yet),
// its value in `value`.
__device__ __forceinline__ unsigned l_read(const unsigned long long* word,
                                           unsigned epoch, int& value) {
  const unsigned long long s = *(const volatile unsigned long long*)word;
  value = (int)(unsigned)s;
  const unsigned hi = (unsigned)(s >> 32);
  return (hi >> 2) == epoch ? (hi & 3u) : 0u;
}

// One level's pass (see the file's head): `rows` the level below's
// survivors, the first *m_dev of them (m_dev null: all m_bound) valid, in
// order; code every child candidate's parent * 8 + slot. ctl is the
// control word (the launch's epoch, high 32 bits, and the next ticket) and
// words a status word a tile. Writes masks[rank] = the valid mask,
// first[rank] = the first child's position in rows and below[rank] = the
// parent's candidate index for each surviving parent, ranks[pos] = each
// survivor's parent's rank (ranks null: not wanted), *count the surviving
// parents.
__global__ void __launch_bounds__(BLOCK)
    svo_level_pass_kernel(const int* __restrict__ rows, int m_bound,
                          const int* __restrict__ m_dev,
                          const int* __restrict__ code,
                          unsigned long long* __restrict__ ctl,
                          unsigned long long* __restrict__ words,
                          int* __restrict__ masks, int* __restrict__ first,
                          int* __restrict__ below,
                          int* __restrict__ ranks, int* __restrict__ count) {
  __shared__ int warp_first[WARPS];
  __shared__ int tile_s;
  __shared__ unsigned epoch_s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    const unsigned long long got = atomicAdd(ctl, 1ull);
    const unsigned ticket = (unsigned)got;
    // the last ticket: every other block holds its own; the epoch moves on
    // and the ticket returns to 0 for the next launch, in one atomic
    if (ticket == gridDim.x - 1) atomicAdd(ctl, (1ull << 32) - gridDim.x);
    tile_s = (int)ticket;
    epoch_s = (unsigned)(got >> 32) & L_EPOCH_MASK;
  }
  const int m = m_dev == nullptr ? m_bound : min(__ldg(m_dev), m_bound);
  __syncthreads();
  const int tile = tile_s;
  const unsigned epoch = epoch_s;
  if (m <= 0) {  // nothing survives below: no parent
    if (tile == 0 && threadIdx.x == 0) *count = 0;
    return;
  }
  if ((long long)tile * LTILE >= m) return;  // past the count on the device
  // row k of this warp: entries wbase + 32 k + lane; row LITEMS, its
  // first RUN lanes, belongs to the next warp (or tile) and is read only
  // for the run that may cross into it
  const int wbase = tile * LTILE + warp * LWARP;
  int p[LITEMS + 1];
  unsigned b[LITEMS + 1];
  {
    int r[LITEMS + 1];
#pragma unroll
    for (int k = 0; k <= LITEMS; ++k) {
      const int e = wbase + 32 * k + lane;
      r[k] = (k < LITEMS || lane < RUN) && e < m ? __ldg(rows + e) : -1;
    }
#pragma unroll
    for (int k = 0; k <= LITEMS; ++k) {
      const int c = r[k] >= 0 ? __ldg(code + r[k]) : -8;
      p[k] = c >> 3;
      b[k] = r[k] >= 0 ? 1u << (c & 7) : 0u;
    }
  }
  // the parent of the entry before the warp's first (lane 0 of a warp that
  // holds a valid entry)
  int p_before = -1;
  if (lane == 0 && wbase > 0 && wbase < m)
    p_before = __ldg(code + __ldg(rows + wbase - 1)) >> 3;
  // each entry's OR over the rest of its run within its row: a run is at
  // most RUN long, and an equal parent RUN / 2 lanes on lies in the same run
#pragma unroll
  for (int o = 1; o < RUN; o <<= 1) {
#pragma unroll
    for (int k = 0; k <= LITEMS; ++k) {
      const unsigned nb = __shfl_down_sync(FULL, b[k], o);
      const int np = __shfl_down_sync(FULL, p[k], o);
      if (lane + o < 32 && np == p[k]) b[k] |= nb;
    }
  }
  // heads: the warp's ballots; a run that reaches a row's end takes the
  // next row's lane 0, the OR of the run's rest
  unsigned head[LITEMS];
  int heads = 0;
#pragma unroll
  for (int k = 0; k < LITEMS; ++k) {
    const int next_p = __shfl_sync(FULL, p[k + 1], 0);
    const unsigned next_b = __shfl_sync(FULL, b[k + 1], 0);
    if (p[k] >= 0 && next_p == p[k]) b[k] |= next_b;
    const int up = __shfl_up_sync(FULL, p[k], 1);
    const int last = k > 0 ? __shfl_sync(FULL, p[k > 0 ? k - 1 : 0], 31) : p_before;
    head[k] = __ballot_sync(FULL, p[k] >= 0 && (lane > 0 ? up : last) != p[k]);
    heads += __popc(head[k]);
  }
  if (lane == 0) warp_first[warp] = heads;
  __syncthreads();
  if (warp == 0) {  // the tile's aggregate, the look-back, the warps' first ranks
    const int c = lane < WARPS ? warp_first[lane] : 0;
    int incl = c;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    const int aggregate = __shfl_sync(FULL, incl, 31);
    if (lane == 0)
      l_publish(words + tile, epoch, tile == 0 ? L_PREFIX : L_AGGREGATE, aggregate);
    int exclusive = 0;
    for (int hi = tile - 1; tile > 0; hi -= 32) {
      // lane l reads tile hi - l's word, once it is published; a tile
      // before the first is an inclusive prefix of 0
      const int q = hi - lane;
      unsigned flag = L_PREFIX;
      int value = 0;
      if (q >= 0) {
        do {
          flag = l_read(words + q, epoch, value);
        } while (flag == 0);
      }
      // the nearest inclusive prefix and the aggregates after it
      const unsigned prefix = __ballot_sync(FULL, flag == L_PREFIX);
      const int stop = prefix ? __ffs(prefix) - 1 : 31;
      int add = lane <= stop ? value : 0;
      for (int o = 16; o > 0; o >>= 1) add += __shfl_xor_sync(FULL, add, o);
      exclusive += add;
      if (prefix) break;
    }
    if (lane == 0 && tile > 0)
      l_publish(words + tile, epoch, L_PREFIX, exclusive + aggregate);
    if (lane < WARPS) warp_first[lane] = exclusive + incl - c;
    if (lane == 0 && tile == (m - 1) / LTILE) *count = exclusive + aggregate;
  }
  __syncthreads();
  // each head's parent at its rank, each survivor's parent rank
  int rank = warp_first[warp];
  const unsigned below_lane = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < LITEMS; ++k) {
    const int e = wbase + 32 * k + lane;
    const int mine = rank + __popc(head[k] & below_lane);
    const bool is_head = (head[k] >> lane) & 1u;
    if (is_head) {
      masks[mine] = (int)b[k];
      first[mine] = e;
      below[mine] = p[k];
    }
    if (ranks != nullptr && p[k] >= 0) ranks[e] = is_head ? mine : mine - 1;
    rank += __popc(head[k]);
  }
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
// blocks' counts of svo_expand, svo_leaves, svo_leaves_serial and
// svo_compact's count mode
// have ceil(n / BLOCK) entries, and svo_compact reads block_base at the same
// blocks.

// The heightfield's h at every column of the side x side square from (x0,
// z0) at the level whose cells are `scale` wide. side is a power of two from
// 2; scene_id a heightfield's.
extern "C" int svo_columns(int x0, int z0, int side, float scale,
                           int scene_id, void* h, void* stream) {
  const bool heightfield = scene_id == scene::FLAT_GROUND ||
                           scene_id == scene::SIMPLEX ||
                           scene_id == scene::TERRAIN || scene_id == scene::PERLIN;
  if (side < 2 || (side & (side - 1)) || side > 32768 || !heightfield)
    return (int)cudaErrorInvalidValue;
  svo_columns_kernel<<<blocks_for((long long)side * side), BLOCK, 0,
                       (cudaStream_t)stream>>>(x0, z0, side, scale, scene_id,
                                               (float*)h);
  return (int)cudaGetLastError();
}

// h: null for a 3-D scene (the scene evaluated a child, svo_expand_kernel),
// else svo_columns' table of the side x side square from (x0, z0), which
// covers every child's column.
extern "C" int svo_expand(const void* parents, int n_children, float scale,
                          float thr_hi, float thr_lo, int scene_id,
                          const void* perm, const void* perm3d,
                          const void* lut_d, const void* lut_sb,
                          const void* grads, const void* h, int x0, int z0,
                          int side, void* rec, void* keep, void* counts,
                          void* stream) {
  if (n_children < 0 || bad_scene(scene_id)) return (int)cudaErrorInvalidValue;
  if (n_children == 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  if (h == nullptr)
    svo_expand_kernel<<<blocks_for(n_children), BLOCK, 0, st>>>(
        (const int4*)parents, n_children, scale, thr_hi, thr_lo, scene_id,
        make_tables(perm, perm3d, lut_d, lut_sb, grads), (int4*)rec,
        (unsigned char*)keep, (int*)counts);
  else
    svo_expand_columns_kernel<<<blocks_for(n_children), BLOCK, 0, st>>>(
        (const int4*)parents, n_children, scale, thr_hi, thr_lo,
        (const float*)h, x0, z0, side, (int4*)rec, (unsigned char*)keep,
        (int*)counts);
  return (int)cudaGetLastError();
}

// The expansion's first form: the scene evaluated at every child.
extern "C" int svo_expand_serial(const void* parents, int n_children,
                                 float scale, float thr_hi, float thr_lo,
                                 int scene_id, const void* perm,
                                 const void* perm3d, const void* lut_d,
                                 const void* lut_sb, const void* grads,
                                 void* rec, void* keep, void* counts,
                                 void* stream) {
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

// rec: the n finest candidates; par: each one's parent row among the n_par
// kept parents `parents` (their records, Morton order); full: the last
// level's uncompacted child records, 8 a kept parent; cells = 2^depth;
// scratch: 6 n_par + n + 1 ints (the neighbour table, the needy list and
// its count). A memset and three launches: the neighbour table, the test
// over the records, the evaluations of the needy list. evals != null: the
// counting form.
extern "C" int svo_leaves(const void* rec, int n, const void* par,
                          const void* parents, int n_par, const void* full,
                          float fin, int cells, int scene_id, const void* perm,
                          const void* perm3d, const void* lut_d,
                          const void* lut_sb, const void* grads, void* survive,
                          void* counts, void* scratch, void* evals,
                          void* stream) {
  if (n < 0 || n_par < 1 || cells < 2 || bad_scene(scene_id))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const scene::Tables t = make_tables(perm, perm3d, lut_d, lut_sb, grads);
  const cudaStream_t st = (cudaStream_t)stream;
  int* table = (int*)scratch;
  int* needy = table + (size_t)6 * n_par;
  int* n_needy = needy + n;
  const cudaError_t e = cudaMemsetAsync(table, 0xFF, sizeof(int) * 6 * (size_t)n_par, st);
  if (e != cudaSuccess) return (int)e;
  svo_leaf_neighbours_kernel<<<blocks_for(n_par), BLOCK, 0, st>>>(
      (const int4*)parents, n_par, cells / 2, table, n_needy);
  svo_leaf_test_kernel<<<blocks_for(n), BLOCK, 0, st>>>(
      (const int4*)rec, n, (const int*)par, (const int4*)full, table,
      (unsigned char*)survive, (int*)counts, needy, n_needy);
  if (evals != nullptr)
    svo_leaf_eval_kernel<true><<<EVAL_BLOCKS, BLOCK, 0, st>>>(
        (const int4*)rec, (const int*)par, (const int4*)full, table, needy,
        n_needy, fin, scene_id, t, (unsigned char*)survive, (int*)counts,
        (unsigned long long*)evals);
  else
    svo_leaf_eval_kernel<false><<<EVAL_BLOCKS, BLOCK, 0, st>>>(
        (const int4*)rec, (const int*)par, (const int4*)full, table, needy,
        n_needy, fin, scene_id, t, (unsigned char*)survive, (int*)counts,
        nullptr);
  return (int)cudaGetLastError();
}

extern "C" int svo_leaf_attrs(const void* leaf_rec, int m, float fin,
                              int scene_id, const void* perm,
                              const void* perm3d, const void* lut_d,
                              const void* lut_sb, const void* grads,
                              void* attrs, void* stream) {
  if (m < 0 || bad_scene(scene_id)) return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaGetLastError();
  svo_leaf_attrs_kernel<<<blocks_for(m), BLOCK, 0, (cudaStream_t)stream>>>(
      (const int4*)leaf_rec, m, fin, scene_id,
      make_tables(perm, perm3d, lut_d, lut_sb, grads), (float*)attrs);
  return (int)cudaGetLastError();
}

extern "C" int svo_leaves_serial(const void* rec, int n, float fin, int scene_id,
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

// Phases C and D's pass at one level (svo_level_pass_kernel): rows (m
// ints, m the host's bound) the level below's survivors, the first *n_rows
// of them valid (n_rows null: all m); code the level below's candidates'
// parents * 8 + slots; status (int64) the control word and a word for each
// of the ceil(m / LTILE) tiles, zeroed once before a build's first pass.
// Outputs: masks, first and below (min(m, parent candidates) ints each) at
// the surviving parents' ranks, ranks (m ints, or null) at the valid rows,
// count (one int).
extern "C" int svo_level_pass(const void* rows, int m, const void* n_rows,
                              const void* code, void* status, void* masks,
                              void* first, void* below, void* ranks,
                              void* count, void* stream) {
  if (m < 0 || m > 0x7fffffff - 2 * LTILE || status == nullptr || count == nullptr)
    return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaGetLastError();
  unsigned long long* ctl = (unsigned long long*)status;
  svo_level_pass_kernel<<<(m + LTILE - 1) / LTILE, BLOCK, 0, (cudaStream_t)stream>>>(
      (const int*)rows, m, (const int*)n_rows, (const int*)code, ctl,
      ctl + 1, (int*)masks, (int*)first, (int*)below, (int*)ranks, (int*)count);
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
