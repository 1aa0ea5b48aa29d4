// One tick of the pedestrian count planes, for agents/pedestrians.py
// (`step_pedestrians_plain` is the plain version; the JAX package runs
// the step as XLA ops, agents/pedestrians.py there).
//
// One thread per cell and world, in gather form: a cell recomputes the
// splits of its four upstream neighbours (the cell one step behind it
// along each heading) from their counts and hashed uniforms, sums what
// lands on it, keeps what stays, thins its walkers and rolls its spawn.
// No scratch plane and no second pass; outputs are written out of place.
//
// Per heading d, at a cell u whose neighbour ahead is c = u + delta_d:
//   keep / cross   k = floor(fma(n, p, r)), p = 0.8 where c is walkable
//                  or a held controlled road, else 0; k goes to c, as
//                  walkers if c is walkable, else as crossers;
//   rest           n - floor(n * p + r) (multiply, then add): into u's
//                  pool when u has a walkable neighbour, else stays;
//   redistribution the pool over u's walkable directions in order, each
//                  taking floor(m * (1 / cnt) + r) of what is left (the
//                  last takes all), where cnt counts the directions left;
//   crossing       crossers move on where c is walkable or roady, and
//                  stay crossers on a roady c.
// Then the walkers thin by floor(n * (1 / 550) + r) and a sidewalk cell
// spawns one walker when r < lam / n_side.  Every f32 rounding is
// spelled out (__fmaf_rn, __fmul_rn, __fadd_rn, __fdiv_rn) as the plain
// version rounds it, whatever the compiler's contraction flags.
#include "common.cuh"

namespace tsim {
namespace ped {

constexpr uint8_t SIDEWALK = 2, R1 = 9, R2 = 10, R3 = 11, INTERSECTION = 12,
                  TRAFFIC_LIGHT = 15, CONTROLLED_ROAD = 16,
                  BLOCK_ENTRANCE = 17;
constexpr float KEEP = 0.8f;
constexpr float P_DIE = 1.0f / 550.0f;  // f32(1 / PED_MEAN_LIFE_TICKS)
constexpr float UNIT = 1.0f / 16777216.0f;  // 2^-24

__device__ __forceinline__ bool walkable(uint8_t t) {
  return t == SIDEWALK || t == BLOCK_ENTRANCE || t == TRAFFIC_LIGHT;
}
__device__ __forceinline__ bool roady(uint8_t t) {
  return t == CONTROLLED_ROAD || t == R1 || t == R2 || t == R3 ||
         t == INTERSECTION;
}

__device__ __forceinline__ uint32_t hash32(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

// the uniform of seed s at flat cell i: hash32(i + s) >> 8, times 2^-24
__device__ __forceinline__ float unif(int i, uint32_t s) {
  return __fmul_rn(__uint2float_rn(hash32((uint32_t)i + s) >> 8), UNIT);
}

__device__ __forceinline__ int clamp_k(float v, int n) {
  return min(max((int)floorf(v), 0), n);
}
// floor(fma(n, p, r)) in [0, n]
__device__ __forceinline__ int sround_fma(int n, float p, float r) {
  return n == 0 ? 0 : clamp_k(__fmaf_rn(__int2float_rn(n), p, r), n);
}
// floor(n * p + r), rounded after the multiply and after the add
__device__ __forceinline__ int sround_mul(int n, float p, float r) {
  return n == 0 ? 0
                : clamp_k(__fadd_rn(__fmul_rn(__int2float_rn(n), p), r), n);
}

struct World {
  const int* walk;      // [4, HW]
  const int* cross;     // [4, HW]
  const uint8_t* cell;  // [HW]
  const uint8_t* stop;  // [HW]
  uint32_t seed[14];
  int H, W;
};

__device__ __forceinline__ uint8_t cell_at(const World& w, int y, int x) {
  return (y >= 0 && y < w.H && x >= 0 && x < w.W) ? w.cell[y * w.W + x]
                                                  : (uint8_t)0;
}
// ahead-of-cell flags of (y, x) in direction d: walkable, held
// controlled road (a crossing entry), roady; all false off the grid
__device__ __forceinline__ void ahead(const World& w, int y, int x, int d,
                                      bool& aw, bool& ac, bool& ar) {
  const int ny = y + dir_dy(d), nx = x + dir_dx(d);
  if (ny < 0 || ny >= w.H || nx < 0 || nx >= w.W) {
    aw = ac = ar = false;
    return;
  }
  const int j = ny * w.W + nx;
  const uint8_t t = w.cell[j];
  aw = walkable(t);
  ac = t == CONTROLLED_ROAD && w.stop[j] != 0;
  ar = roady(t);
}

// the redistribution's take in direction d of the pool at (y, x), flat i
__device__ int take_toward(const World& w, int y, int x, int i, int d) {
  bool aw[4], ac[4], ar;
  int n_alt = 0;
  for (int e = 0; e < 4; ++e) {
    ahead(w, y, x, e, aw[e], ac[e], ar);
    n_alt += aw[e];
  }
  if (n_alt == 0) return 0;
  const int HW = w.H * w.W;
  int m = 0;
  for (int e = 0; e < 4; ++e) {
    const int n = w.walk[e * HW + i];
    const float p = (aw[e] || ac[e]) ? KEEP : 0.0f;
    m += n - sround_mul(n, p, unif(i, w.seed[e]));
  }
  int rem = n_alt;
  for (int e = 0; e <= d; ++e) {
    int take = 0;
    if (aw[e]) {
      take = rem == 1 ? m
                      : sround_mul(m, __fdiv_rn(1.0f, __int2float_rn(rem)),
                                   unif(i, w.seed[4 + e]));
    }
    if (e == d) return take;
    m -= take;
    rem -= aw[e];
  }
  return 0;
}

__global__ void step_kernel(const int* __restrict__ walk,
                            const int* __restrict__ cross,
                            const uint8_t* __restrict__ cell,
                            const uint8_t* __restrict__ stop,
                            const long long* __restrict__ seeds,
                            const int* __restrict__ n_side,
                            int* __restrict__ walk_o,
                            int* __restrict__ cross_o,
                            uint8_t* __restrict__ block_o,
                            int* __restrict__ count_o, int H, int W,
                            int geo, float lam, int spawn) {
  const int HW = H * W;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (i >= HW) return;
  World w;
  w.walk = walk + (long)b * 4 * HW;
  w.cross = cross + (long)b * 4 * HW;
  w.cell = cell + (long)b * geo * HW;
  w.stop = stop + (long)b * HW;
  for (int k = 0; k < 14; ++k) w.seed[k] = (uint32_t)seeds[b * 14 + k];
  w.H = H;
  w.W = W;
  const int y = i / W, x = i - y * W;
  const uint8_t t = w.cell[i];
  const bool walk_c = walkable(t), road_c = roady(t);
  const bool centry_c = t == CONTROLLED_ROAD && w.stop[i] != 0;

  int nw[4], nc[4];
  bool aw[4], ac[4], ar[4];
  bool has_alt = false;
  for (int d = 0; d < 4; ++d) {
    ahead(w, y, x, d, aw[d], ac[d], ar[d]);
    has_alt = has_alt || aw[d];
  }
  for (int d = 0; d < 4; ++d) {
    // what stays: the rest where no walkable neighbour takes it, and
    // crossers facing neither a walkable nor a roady cell
    const int n = w.walk[d * HW + i];
    nw[d] = has_alt ? 0
                    : n - sround_mul(n, (aw[d] || ac[d]) ? KEEP : 0.0f,
                                     unif(i, w.seed[d]));
    const int c = w.cross[d * HW + i];
    nc[d] = (aw[d] || ar[d]) ? 0 : c;
    // what arrives from the upstream cell (y, x) - delta_d
    const int uy = y - dir_dy(d), ux = x - dir_dx(d);
    if (uy < 0 || uy >= H || ux < 0 || ux >= W) continue;
    const int j = uy * W + ux;
    const int nu = w.walk[d * HW + j];
    const int k = sround_fma(nu, (walk_c || centry_c) ? KEEP : 0.0f,
                             unif(j, w.seed[d]));
    if (walk_c) {
      nw[d] += k;
      nw[d] += take_toward(w, uy, ux, j, d);
    } else {
      nc[d] += k;
    }
    if (walk_c || road_c) {
      const int cu = w.cross[d * HW + j];
      if (road_c)
        nc[d] += cu;
      else
        nw[d] += cu;
    }
  }
  // lifetime thinning, then the spawn
  for (int d = 0; d < 4; ++d)
    nw[d] -= sround_mul(nw[d], P_DIE, unif(i, w.seed[8 + d]));
  if (spawn && t == SIDEWALK) {
    const float p_cell =
        __fdiv_rn(lam, __int2float_rn(max(n_side[b * geo], 1)));
    if (unif(i, w.seed[12]) < p_cell) {
      const int h = (int)__fmul_rn(unif(i, w.seed[13]), 4.0f);
      nw[h] += 1;
    }
  }
  int* wo = walk_o + (long)b * 4 * HW;
  int* co = cross_o + (long)b * 4 * HW;
  unsigned sw = 0, sc = 0;
  for (int d = 0; d < 4; ++d) {
    wo[d * HW + i] = nw[d];
    co[d * HW + i] = nc[d];
    sw += (unsigned)nw[d];
    sc += (unsigned)nc[d];
  }
  block_o[(long)b * HW + i] = (int)sc > 0;
  count_o[(long)b * HW + i] = (int)(sw + sc);
}

}  // namespace ped
}  // namespace tsim

// walk, cross int32 [B, 4, H, W]; cell u8 [H, W] (geo 0) or [B, H, W]
// (geo 1); stop bool [B, H, W]; seeds int64 [B, 14] (u32 values);
// n_side int32 [1] or [B]; outputs walk', cross' [B, 4, H, W], block
// bool [B, H, W], count int32 [B, H, W]
extern "C" int tsim_step_pedestrians(const int* walk, const int* cross,
                                     const uint8_t* cell,
                                     const uint8_t* stop,
                                     const long long* seeds,
                                     const int* n_side, int* walk_o,
                                     int* cross_o, uint8_t* block_o,
                                     int* count_o, int B, int H, int W,
                                     int geo, float lam, int spawn,
                                     void* stream) {
  using namespace tsim;
  const dim3 grid(blocks_for((long)H * W), B);
  ped::step_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      walk, cross, cell, stop, seeds, n_side, walk_o, cross_o, block_o,
      count_o, H, W, geo, lam, spawn);
  return (int)cudaGetLastError();
}
