// The scene library as device functions: the nine scenes of
// raytracingtest_tpu_torch/scenes.py, the hash noise (utils/noise.py and its
// native twin csrc/noise.cpp), Perlin's fbm3 (utils/perlin.py), OpenSimplex's
// evaluate (utils/opensimplex.py) and the position palette default_albedo
// (ops/octree.py), for the SVO builder on the card (svo_build.cu).
//
// Each function repeats the host path's float32 operations in their order,
// one IEEE operation for each numpy (or noise.cpp) operation, so that a
// build on the card keeps the host build's bits: built with --fmad=false (no
// contraction of a*b+c) and without fast math (sqrtf and '/' correctly
// rounded). Rules kept throughout:
//   * a Python float meeting a float32 array is rounded to float32 first
//     (numpy 2): every such literal is written (float)<double literal>;
//   * numpy's maximum/minimum return the second operand on a tie (+0 and
//     -0 included): vmax/vmin below;
//   * the `_ref` scenes run OpenSimplex in float64 with int64 lattice
//     indices, as the host does; their tables (the permutations of
//     OpenSimplex3D(7), the contribution chains, the gradients) come from the
//     host as device arrays (Tables).
// sinf in default_albedo is the one function that does not give numpy's
// bits (both are a few ULP from sin); the build's albedo is compared within
// 1e-5.

#pragma once

#include <cstdint>

namespace scene {

// Scene ids: the wrapper (ops/octree_cuda.py, SCENE_IDS) maps Scene.name to
// these.
enum : int {
  FLAT_GROUND = 0,
  SPHERE = 1,
  SIMPLEX = 2,
  ROTATED_CUBOID = 3,
  TERRAIN = 4,
  DENSE_CUBE = 5,
  PERLIN = 6,
  TERRAIN_REF = 7,
  SIMPLEX_REF = 8,
  N_SCENES = 9,
};

// OpenSimplex's tables (utils/opensimplex.py), for the `_ref` scenes.
struct Tables {
  const long long* perm;    // (256,)
  const long long* perm3d;  // (256,)
  const double* lut_d;      // (MAX_CHAIN, 3, 2048): _LUT_D_COLS
  const long long* lut_sb;  // (MAX_CHAIN, 3, 2048): _LUT_SB_COLS
  const double* grads;      // (72,): GRADIENTS_3D flattened
};

constexpr int OS_MAX_CHAIN = 9;
constexpr int OS_HASHES = 2048;

__device__ __forceinline__ float vmax(float a, float b) { return a > b ? a : b; }
__device__ __forceinline__ float vmin(float a, float b) { return a < b ? a : b; }

// ---- hash gradient noise: csrc/noise.cpp's order ---------------------------

__device__ __forceinline__ uint32_t hash3(int32_t ix, int32_t iy, int32_t iz,
                                          uint32_t seed) {
  uint32_t h = (uint32_t)ix * 0x8DA6B343u ^ (uint32_t)iy * 0xD8163841u ^
               (uint32_t)iz * 0xCB1AB31Fu ^ seed * 0x9E3779B9u;
  h ^= h >> 13;
  h *= 0x5BD1E995u;
  h ^= h >> 15;
  return h;
}

__device__ __forceinline__ float fade(float t) {
  return t * t * t * (t * (t * 6.f - 15.f) + 10.f);
}

// one corner's gradient dot offset; the 12 edge gradients decoded branch
// free (utils/noise.py's decode, the same values as noise.cpp's GRAD table)
__device__ __forceinline__ float corner(int32_t ix, int32_t iy, int32_t iz,
                                        int cx, int cy, int cz, float fx,
                                        float fy, float fz, uint32_t seed) {
  const int gi = (int)(hash3(ix + cx, iy + cy, iz + cz, seed) % 12u);
  const float s1 = 1.f - 2.f * (float)(gi & 1);
  const float s2 = 1.f - 2.f * (float)((gi >> 1) & 1);
  const float gx = gi < 8 ? s1 : 0.f;
  const float gy = gi < 4 ? s2 : (gi < 8 ? 0.f : s1);
  const float gz = gi < 4 ? 0.f : s2;
  return gx * (fx - (float)cx) + gy * (fy - (float)cy) + gz * (fz - (float)cz);
}

__device__ __noinline__ float noise3(float x, float y, float z, uint32_t seed) {
  const float xf = floorf(x), yf = floorf(y), zf = floorf(z);
  const float fx = x - xf, fy = y - yf, fz = z - zf;
  const int32_t ix = (int32_t)xf, iy = (int32_t)yf, iz = (int32_t)zf;
  const float u = fade(fx), v = fade(fy), w = fade(fz);

  const float n000 = corner(ix, iy, iz, 0, 0, 0, fx, fy, fz, seed);
  const float n100 = corner(ix, iy, iz, 1, 0, 0, fx, fy, fz, seed);
  const float n010 = corner(ix, iy, iz, 0, 1, 0, fx, fy, fz, seed);
  const float n110 = corner(ix, iy, iz, 1, 1, 0, fx, fy, fz, seed);
  const float n001 = corner(ix, iy, iz, 0, 0, 1, fx, fy, fz, seed);
  const float n101 = corner(ix, iy, iz, 1, 0, 1, fx, fy, fz, seed);
  const float n011 = corner(ix, iy, iz, 0, 1, 1, fx, fy, fz, seed);
  const float n111 = corner(ix, iy, iz, 1, 1, 1, fx, fy, fz, seed);

  const float nx00 = n000 + u * (n100 - n000);
  const float nx10 = n010 + u * (n110 - n010);
  const float nx01 = n001 + u * (n101 - n001);
  const float nx11 = n011 + u * (n111 - n011);
  const float nxy0 = nx00 + v * (nx10 - nx00);
  const float nxy1 = nx01 + v * (nx11 - nx01);
  return nxy0 + w * (nxy1 - nxy0);
}

// noise.cpp's rtt_fbm3: amp and freq cascade in float32 (the numpy path's
// float64 cascade gives the same values at gain 1/2, lacunarity 2)
__device__ __forceinline__ float fbm3(float x, float y, float z, uint32_t seed,
                                      int octaves) {
  float out = 0.f, amp = 1.f, freq = 1.f;
  for (int o = 0; o < octaves; ++o) {
    out += amp * noise3(x * freq, y * freq, z * freq, seed + (uint32_t)o);
    amp *= 0.5f;
    freq *= 2.0f;
  }
  return out;
}

// ---- classic Perlin noise: utils/perlin.py's order -------------------------

__device__ const int PERLIN_PERM[257] = {
    151, 160, 137, 91,  90,  15,  131, 13,  201, 95,  96,  53,  194, 233, 7,
    225, 140, 36,  103, 30,  69,  142, 8,   99,  37,  240, 21,  10,  23,  190,
    6,   148, 247, 120, 234, 75,  0,   26,  197, 62,  94,  252, 219, 203, 117,
    35,  11,  32,  57,  177, 33,  88,  237, 149, 56,  87,  174, 20,  125, 136,
    171, 168, 68,  175, 74,  165, 71,  134, 139, 48,  27,  166, 77,  146, 158,
    231, 83,  111, 229, 122, 60,  211, 133, 230, 220, 105, 92,  41,  55,  46,
    245, 40,  244, 102, 143, 54,  65,  25,  63,  161, 1,   216, 80,  73,  209,
    76,  132, 187, 208, 89,  18,  169, 200, 196, 135, 130, 116, 188, 159, 86,
    164, 100, 109, 198, 173, 186, 3,   64,  52,  217, 226, 250, 124, 123, 5,
    202, 38,  147, 118, 126, 255, 82,  85,  212, 207, 206, 59,  227, 47,  16,
    58,  17,  182, 189, 28,  42,  223, 183, 170, 213, 119, 248, 152, 2,   44,
    154, 163, 70,  221, 153, 101, 155, 167, 43,  172, 9,   129, 22,  39,  253,
    19,  98,  108, 110, 79,  113, 224, 232, 178, 185, 112, 104, 218, 246, 97,
    228, 251, 34,  242, 193, 238, 210, 144, 12,  191, 179, 162, 241, 81,  51,
    145, 235, 249, 14,  239, 107, 49,  192, 214, 31,  181, 199, 106, 157, 184,
    84,  204, 176, 115, 121, 50,  45,  127, 4,   150, 254, 138, 236, 205, 93,
    222, 114, 67,  29,  24,  72,  243, 141, 128, 195, 78,  66,  215, 61,  156,
    180, 151,
};

__device__ __forceinline__ float plerp(float t, float a, float b) {
  return a + t * (b - a);
}

__device__ __forceinline__ float pgrad3(int h, float x, float y, float z) {
  h &= 15;
  const float u = h < 8 ? x : y;
  const float v = h < 4 ? y : ((h == 12 || h == 14) ? x : z);
  return ((h & 1) == 0 ? u : -u) + ((h & 2) == 0 ? v : -v);
}

__device__ __noinline__ float perlin_noise3(float x, float y, float z) {
  const int* P = PERLIN_PERM;
  const float fx = floorf(x), fy = floorf(y), fz = floorf(z);
  const int X = (int)fx & 0xFF, Y = (int)fy & 0xFF, Z = (int)fz & 0xFF;
  x = x - fx;
  y = y - fy;
  z = z - fz;
  const float u = fade(x), v = fade(y), w = fade(z);
  const int A = (P[X] + Y) & 0xFF, B = (P[X + 1] + Y) & 0xFF;
  const int AA = (P[A] + Z) & 0xFF, BA = (P[B] + Z) & 0xFF;
  const int AB = (P[A + 1] + Z) & 0xFF, BB = (P[B + 1] + Z) & 0xFF;
  const float one = 1.f;
  const float n000 = pgrad3(P[AA], x, y, z);
  const float n100 = pgrad3(P[BA], x - one, y, z);
  const float n010 = pgrad3(P[AB], x, y - one, z);
  const float n110 = pgrad3(P[BB], x - one, y - one, z);
  const float n001 = pgrad3(P[AA + 1], x, y, z - one);
  const float n101 = pgrad3(P[BA + 1], x - one, y, z - one);
  const float n011 = pgrad3(P[AB + 1], x, y - one, z - one);
  const float n111 = pgrad3(P[BB + 1], x - one, y - one, z - one);
  return plerp(w, plerp(v, plerp(u, n000, n100), plerp(u, n010, n110)),
               plerp(v, plerp(u, n001, n101), plerp(u, n011, n111)));
}

__device__ __forceinline__ float perlin_fbm3(float x, float y, float z,
                                             int octaves) {
  float f = 0.f, wgt = 0.5f;
  for (int o = 0; o < octaves; ++o) {
    f = f + wgt * perlin_noise3(x, y, z);
    x = x * 2.f;
    y = y * 2.f;
    z = z * 2.f;
    wgt = wgt * 0.5f;
  }
  return f;
}

// ---- OpenSimplex 3D in float64: utils/opensimplex.py _evaluate's order -----

__device__ __noinline__ double opensimplex3(double x, double y, double z,
                                            const Tables t) {
  const double STRETCH_3D = -1.0 / 6.0, SQUISH_3D = 1.0 / 3.0;
  const double NORM_3D = 1.0 / 103.0;
  const double stretch = (x + y + z) * STRETCH_3D;
  const double xs = x + stretch, ys = y + stretch, zs = z + stretch;
  const long long xsb = (long long)floor(xs);
  const long long ysb = (long long)floor(ys);
  const long long zsb = (long long)floor(zs);
  const double squish = (double)(xsb + ysb + zsb) * SQUISH_3D;
  const double dx0 = x - ((double)xsb + squish);
  const double dy0 = y - ((double)ysb + squish);
  const double dz0 = z - ((double)zsb + squish);
  const double xins = xs - (double)xsb, yins = ys - (double)ysb,
               zins = zs - (double)zsb;
  const double insum = xins + yins + zins;
  // the operands are >= 0: floor is truncation
  const long long h = (long long)floor(yins - zins + 1.0) |
                      ((long long)floor(xins - yins + 1.0) << 1) |
                      ((long long)floor(xins - zins + 1.0) << 2) |
                      ((long long)floor(insum) << 3) |
                      ((long long)floor(insum + zins) << 5) |
                      ((long long)floor(insum + yins) << 7) |
                      ((long long)floor(insum + xins) << 9);

  double value = 0.0;
  for (int j = 0; j < OS_MAX_CHAIN; ++j) {
    const double* cd = t.lut_d + (size_t)j * 3 * OS_HASHES;
    const long long* csb = t.lut_sb + (size_t)j * 3 * OS_HASHES;
    const double dx = dx0 + cd[h];
    const double dy = dy0 + cd[OS_HASHES + h];
    const double dz = dz0 + cd[2 * OS_HASHES + h];
    const double attn = 2.0 - dx * dx - dy * dy - dz * dz;
    const long long px = (xsb + csb[h]) & 0xFF;
    const long long py = ysb + csb[OS_HASHES + h];
    const long long pz = zsb + csb[2 * OS_HASHES + h];
    const long long gi =
        t.perm3d[(t.perm[(t.perm[px] + py) & 0xFF] + pz) & 0xFF];
    const double part =
        t.grads[gi] * dx + t.grads[gi + 1] * dy + t.grads[gi + 2] * dz;
    double a2 = attn > 0.0 ? attn : 0.0;
    a2 = a2 * a2;
    value = value + a2 * a2 * part;
  }
  return value * NORM_3D;
}

// ---- the nine scenes: scenes.py's order ------------------------------------

__device__ __forceinline__ float sq(float v) { return v * v; }

__device__ __noinline__ float rotated_cuboid(float x, float y, float z) {
  x = x - 0.5f;
  y = y - 0.5f;
  z = z - 0.5f;
  // float32(cos 0.6), float32(sin 0.6): the host's float(np.cos(0.6)) met
  // with a float32 array
  const float c = 0x1.a69264p-1f, s = 0x1.2118d2p-1f;
  const float x1 = c * x + s * z;
  const float z1 = -s * x + c * z;
  const float y1 = c * y - s * z1;
  const float z2 = s * y + c * z1;
  const float qx = fabsf(x1) - (float)0.28;
  const float qy = fabsf(y1) - (float)0.16;
  const float qz = fabsf(z2) - (float)0.22;
  const float outside = sqrtf(sq(vmax(qx, 0.f)) + sq(vmax(qy, 0.f)) +
                              sq(vmax(qz, 0.f)));
  const float inside = vmin(vmax(qx, vmax(qy, qz)), 0.f);
  return outside + inside;
}

__device__ __noinline__ float terrain_ref(float x, float y, float z,
                                          const Tables t) {
  // y - 1.5 + 0.5 n(3p) + 0.15 n(24p) over [1,2]^3: the shift and the
  // scaling are float32, the noise and the sum float64
  const float xf = x + 1.f, yf = y + 1.f, zf = z + 1.f;
  const double n1 = opensimplex3((double)(xf * 3.f), (double)(yf * 3.f),
                                 (double)(zf * 3.f), t);
  const double n2 = opensimplex3((double)(xf * 24.f), (double)(yf * 24.f),
                                 (double)(zf * 24.f), t);
  return (float)((double)(yf - 1.5f) + 0.5 * n1 + 0.15 * n2);
}

__device__ __noinline__ float simplex_ref(float x, float y, float z,
                                          const Tables t) {
  const float xf = x + 1.f, yf = y + 1.f, zf = z + 1.f;
  return (float)opensimplex3((double)(xf * 6.f), (double)(yf * 6.f),
                             (double)(zf * 6.f), t);
}

// ---- the heightfields: f = y - h(x, z) ------------------------------------
// flat_ground, simplex, terrain and perlin are heightfields: their noise is
// taken at y = 0 (scenes.py), so h depends on the column (x, z) alone. Each
// height is its scene's float32 operations before the final `y -`, in their
// order, so y - height(id, x, z) is eval's value bit for bit; the builder
// (svo_build.cu) evaluates h once a column and forms y - h a child. The
// other ids are 3-D scenes (ops/octree_cuda.py's HEIGHTFIELDS names the
// four).

constexpr float NOISE_FREQ = 4.f, NOISE_AMP = (float)0.12,
                NOISE_BASE = (float)0.45, FLAT_HEIGHT = (float)0.30;

__device__ __forceinline__ float simplex_height(float x, float z) {
  return NOISE_BASE + NOISE_AMP * noise3(x * NOISE_FREQ, 0.f, z * NOISE_FREQ, 0u);
}

__device__ __forceinline__ float terrain_height(float x, float z) {
  return NOISE_BASE + NOISE_AMP * fbm3(x * NOISE_FREQ, 0.f, z * NOISE_FREQ, 0u, 2);
}

__device__ __forceinline__ float perlin_height(float x, float z) {
  return NOISE_BASE + NOISE_AMP * perlin_fbm3(x * NOISE_FREQ, 0.f, z * NOISE_FREQ, 2);
}

// h of heightfield `id` (FLAT_GROUND, SIMPLEX, TERRAIN or PERLIN) at column
// (x, z)
__device__ __forceinline__ float height(int id, float x, float z) {
  switch (id) {
    case FLAT_GROUND:
      return FLAT_HEIGHT;
    case SIMPLEX:
      return simplex_height(x, z);
    case TERRAIN:
      return terrain_height(x, z);
    default:  // PERLIN
      return perlin_height(x, z);
  }
}

// the density of scene `id` at (x, y, z); <= 0 is solid
__device__ __forceinline__ float eval(int id, float x, float y, float z,
                                      const Tables t) {
  switch (id) {
    case FLAT_GROUND:
      return y - FLAT_HEIGHT;
    case SPHERE:
      return sqrtf(sq(x - 0.5f) + sq(y - 0.5f) + sq(z - 0.5f)) - (float)0.30;
    case SIMPLEX:
      return y - simplex_height(x, z);
    case ROTATED_CUBOID:
      return rotated_cuboid(x, y, z);
    case TERRAIN:
      return y - terrain_height(x, z);
    case DENSE_CUBE: {
      const float ax = fabsf(x - 0.5f), ay = fabsf(y - 0.5f),
                  az = fabsf(z - 0.5f);
      return vmax(ax, vmax(ay, az)) - 0.25f;
    }
    case PERLIN:
      return y - perlin_height(x, z);
    case TERRAIN_REF:
      return terrain_ref(x, y, z, t);
    default:  // SIMPLEX_REF; the wrapper passes only ids below N_SCENES
      return simplex_ref(x, y, z, t);
  }
}

// ops/octree.py default_albedo: the position palette
__device__ __forceinline__ void default_albedo(float px, float py, float pz,
                                               float out[3]) {
  const float t = px * (float)3.1 + py * (float)5.3 + pz * (float)7.9;
  out[0] = 0.5f + 0.5f * sinf(6.f * t);
  out[1] = 0.5f + 0.5f * sinf(6.f * t + (float)2.094);
  out[2] = 0.5f + 0.5f * sinf(6.f * t + (float)4.188);
}

// ops/octree.py sampler_normal: the central difference (h = 1e-3) of the
// density, normalised
__device__ __forceinline__ void sampler_normal(int id, float px, float py,
                                               float pz, const Tables t,
                                               float out[3]) {
  const float h = (float)1e-3;
  const float fx = eval(id, px + h, py, pz, t) - eval(id, px - h, py, pz, t);
  const float fy = eval(id, px, py + h, pz, t) - eval(id, px, py - h, pz, t);
  const float fz = eval(id, px, py, pz + h, t) - eval(id, px, py, pz - h, t);
  const float norm = sqrtf(fx * fx + fy * fy + fz * fz);
  const float d = vmax(norm, (float)1e-12);
  out[0] = fx / d;
  out[1] = fy / d;
  out[2] = fz / d;
}

}  // namespace scene
