// One tick of the pedestrian count planes, for agents/pedestrians.py
// (`step_pedestrians_plain` is the plain version; the JAX package runs
// the step as XLA ops, agents/pedestrians.py there).
//
// One block per 32 x 8 tile of a world, in two steps split by one block
// barrier:
//  1. every source cell, the tile's and the ring of cells one step
//     outside it, computes its own splits once: what it sends one step
//     along each heading (walkers, crossers) and, for a tile cell, what
//     stays.  The ring's cells are the upstream neighbours of the tile's
//     edge; each sends only along the heading into the tile.  Their
//     ahead-of-cell flags come from the cell types and the stop map over
//     the tile and a ring of two, staged in shared memory; their counts
//     from device memory, each cell's own eight.  What a cell sends is
//     stored in shared memory;
//  2. each tile cell sums what its four upstream neighbours sent it
//     along each heading, thins its walkers and rolls its spawn.
// A cell's count planes are read by the blocks whose tile or ring holds
// it; the cell types and the stop map with a ring of two; every output
// is written once.  A source cell hashes no uniform where a split does
// not depend on it (no walkers along a heading, or nothing ahead to keep
// heading into; no pool; no walkers to thin).
//
// Per heading d, at a source cell u whose neighbour ahead is c = u +
// delta_d:
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
// spawns one walker when r < lam / n_side, n_side the world's sidewalk
// count, computed once where the world's statics are built.  Every f32
// rounding is spelled out (__fmaf_rn, __fmul_rn, __fadd_rn, __fdiv_rn)
// as the plain version rounds it, whatever the compiler's contraction
// flags.
#include "common.cuh"

namespace tsim {
namespace ped {

constexpr uint8_t SIDEWALK = 2, R1 = 9, R2 = 10, R3 = 11, INTERSECTION = 12,
                  TRAFFIC_LIGHT = 15, CONTROLLED_ROAD = 16,
                  BLOCK_ENTRANCE = 17;
constexpr float KEEP = 0.8f;
constexpr float P_DIE = 1.0f / 550.0f;  // f32(1 / PED_MEAN_LIFE_TICKS)
constexpr float UNIT = 1.0f / 16777216.0f;  // 2^-24

// the tile, its ring of source cells, and the ring of two whose flags
// they read
constexpr int TX = 32, TY = 8;
constexpr int NT = TX * TY;                    // tile cells
constexpr int NR = 2 * (TX + TY);              // ring cells
constexpr int NTHREADS = (NT + NR + 31) / 32 * 32;
constexpr int SX = TX + 2, SY = TY + 2;        // the sources' region
constexpr int FX = TX + 4, FY = TY + 4;        // the flags' region

// a cell's flags: walkable, roady, a held controlled road (a crossing
// entry), a sidewalk; 0 off the grid
constexpr uint8_t F_WALK = 1, F_ROAD = 2, F_ENTRY = 4, F_SIDE = 8;

__device__ __forceinline__ uint8_t flags_of(uint8_t t, bool stop) {
  const bool walk = t == SIDEWALK || t == BLOCK_ENTRANCE ||
                    t == TRAFFIC_LIGHT;
  const bool road = t == CONTROLLED_ROAD || t == R1 || t == R2 || t == R3 ||
                    t == INTERSECTION;
  return (walk ? F_WALK : 0) | (road ? F_ROAD : 0) |
         (t == CONTROLLED_ROAD && stop ? F_ENTRY : 0) |
         (t == SIDEWALK ? F_SIDE : 0);
}

__device__ __forceinline__ uint32_t hash32(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

// the uniform of seed s at the world's flat cell i: hash32(i + s) >> 8,
// times 2^-24
__device__ __forceinline__ float unif(int i, uint32_t s) {
  return __fmul_rn(__uint2float_rn(hash32((uint32_t)i + s) >> 8), UNIT);
}

__device__ __forceinline__ int clamp_k(float v, int n) {
  return min(max((int)floorf(v), 0), n);
}
// floor(fma(n, p, r)) in [0, n]
__device__ __forceinline__ int sround_fma(int n, float p, float r) {
  return clamp_k(__fmaf_rn(__int2float_rn(n), p, r), n);
}
// floor(n * p + r), rounded after the multiply and after the add
__device__ __forceinline__ int sround_mul(int n, float p, float r) {
  return clamp_k(__fadd_rn(__fmul_rn(__int2float_rn(n), p), r), n);
}

// What source cell i (the world's flat index) sends along heading d, for every d up to
// `dlast` (walkers sw[d], crossers sc[d]), and what stays there (kw[d],
// kc[d]), from its counts n[4], c[4] and the flags a[4] of the cells
// ahead of it.  The splits of every heading feed the pool; the pool's
// takes run in heading order, so a heading's take needs the earlier ones.
__device__ __forceinline__ void source(int i, const int* n, const int* c,
                                       const uint8_t* a, const uint32_t* seed,
                                       int dlast, int* sw, int* sc, int* kw,
                                       int* kc) {
  bool aw[4];
  int n_alt = 0;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    aw[d] = a[d] & F_WALK;
    n_alt += aw[d];
  }
  int m = 0;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const bool moves = aw[d] || (a[d] & F_ENTRY);
    // p = 0 (nothing ahead to keep heading into) splits off nothing,
    // whatever the draw: floor(n * 0 + r) = 0 for r in [0, 1)
    int k = 0, rest = n[d];
    if (n[d] != 0 && moves) {
      const float r = unif(i, seed[d]);
      k = sround_fma(n[d], KEEP, r);
      rest = n[d] - sround_mul(n[d], KEEP, r);
    }
    sw[d] = aw[d] ? k : 0;
    sc[d] = aw[d] ? 0 : k;
    if (n_alt > 0) {
      m += rest;
      kw[d] = 0;
    } else {
      kw[d] = rest;
    }
    // crossing: on over a walkable (as walkers) or roady (as crossers)
    // cell ahead, else they stay
    const bool road = a[d] & F_ROAD;
    sw[d] += aw[d] ? c[d] : 0;
    sc[d] += road ? c[d] : 0;
    kc[d] = (aw[d] || road) ? 0 : c[d];
  }
  int rem = n_alt;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    if (d > dlast) break;
    if (aw[d]) {
      int take = m;
      if (rem != 1 && m != 0)
        take = sround_mul(m, __fdiv_rn(1.0f, __int2float_rn(rem)),
                          unif(i, seed[4 + d]));
      sw[d] += take;
      m -= take;
      rem -= 1;
    }
  }
}

// grid (ceil(W / TX), ceil(H / TY), B), NTHREADS threads: threads below
// NT own a tile cell, the next NR a ring cell.  `row0`: the world's row
// of the planes' first row (a window of a world split by rows; 0 for a
// whole world), which the uniforms hash; the planes' edges act as the
// world's
__global__ void __launch_bounds__(NTHREADS)
    step_kernel(const int* __restrict__ walk, const int* __restrict__ cross,
                const uint8_t* __restrict__ cell,
                const uint8_t* __restrict__ stop,
                const long long* __restrict__ seeds,
                const int* __restrict__ n_side, int* __restrict__ walk_o,
                int* __restrict__ cross_o, uint8_t* __restrict__ block_o,
                int* __restrict__ count_o, int H, int W, int geo, float lam,
                int spawn, int row0) {
  __shared__ uint8_t fl[FY][FX];
  __shared__ int out_w[4][SY][SX];
  __shared__ int out_c[4][SY][SX];
  __shared__ uint32_t seed[14];
  const int HW = H * W;
  const int b = blockIdx.z, tid = threadIdx.x;
  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;
  const int* wk = walk + (long)b * 4 * HW;
  const int* cr = cross + (long)b * 4 * HW;
  const uint8_t* ct = cell + (long)b * geo * HW;
  const uint8_t* sp = stop + (long)b * HW;

  // this thread's source cell (sy, sx) in the sources' region, and the
  // one heading a ring cell sends along (into the tile)
  int sy, sx, dlast = 3;
  if (tid < NT) {
    sy = 1 + tid / TX;
    sx = 1 + tid % TX;
  } else {
    const int r = tid - NT;
    if (r < TX) {
      sy = 0, sx = 1 + r, dlast = 0;              // below: sends +y (N)
    } else if (r < 2 * TX) {
      sy = TY + 1, sx = 1 + r - TX, dlast = 2;    // above: sends -y (S)
    } else if (r < 2 * TX + TY) {
      sy = 1 + r - 2 * TX, sx = 0, dlast = 1;     // left: sends +x (E)
    } else {
      sy = 1 + r - 2 * TX - TY, sx = TX + 1, dlast = 3;  // right: -x (W)
    }
  }
  const int gy = y0 - 1 + sy, gx = x0 - 1 + sx;
  const bool active = tid < NT + NR && gy >= 0 && gy < H && gx >= 0 && gx < W;
  const int i = gy * W + gx;
  const int gi = i + row0 * W;   // the cell's index in the world

  // the source cell's counts first (no shared memory needed)
  int n[4] = {0, 0, 0, 0}, c[4] = {0, 0, 0, 0};
  if (active) {
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      n[d] = wk[d * HW + i];
      c[d] = cr[d * HW + i];
    }
  }
  if (tid < 14) seed[tid] = (uint32_t)seeds[b * 14 + tid];
  for (int q = tid; q < FY * FX; q += NTHREADS) {
    const int fy = y0 - 2 + q / FX, fx = x0 - 2 + q % FX;
    uint8_t f = 0;
    if (fy >= 0 && fy < H && fx >= 0 && fx < W) {
      const int j = fy * W + fx;
      f = flags_of(ct[j], sp[j] != 0);
    }
    fl[q / FX][q % FX] = f;
  }
  __syncthreads();

  // 1. the source cell's splits
  int sw[4], sc[4], kw[4], kc[4];
  if (active) {
    uint8_t a[4];
#pragma unroll
    for (int d = 0; d < 4; ++d)
      a[d] = fl[sy + 1 + dir_dy(d)][sx + 1 + dir_dx(d)];
    source(gi, n, c, a, seed, dlast, sw, sc, kw, kc);
    if (tid < NT) {
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        out_w[d][sy][sx] = sw[d];
        out_c[d][sy][sx] = sc[d];
      }
    } else {
      // the one heading into the tile (a select, so that sw and sc stay
      // in registers)
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        if (d == dlast) {
          out_w[d][sy][sx] = sw[d];
          out_c[d][sy][sx] = sc[d];
        }
      }
    }
  }
  __syncthreads();
  if (tid >= NT || !active) return;

  // 2. what stays, plus what the upstream neighbour along each heading
  // sent; then the thinning and the spawn
  int nw[4], nc[4];
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    nw[d] = kw[d];
    nc[d] = kc[d];
    const int uy = gy - dir_dy(d), ux = gx - dir_dx(d);
    if (uy >= 0 && uy < H && ux >= 0 && ux < W) {
      nw[d] += out_w[d][sy - dir_dy(d)][sx - dir_dx(d)];
      nc[d] += out_c[d][sy - dir_dy(d)][sx - dir_dx(d)];
    }
  }
#pragma unroll
  for (int d = 0; d < 4; ++d)
    if (nw[d] != 0) nw[d] -= sround_mul(nw[d], P_DIE, unif(gi, seed[8 + d]));
  if (spawn && (fl[sy + 1][sx + 1] & F_SIDE)) {
    const float p_cell =
        __fdiv_rn(lam, __int2float_rn(max(n_side[b * geo], 1)));
    if (unif(gi, seed[12]) < p_cell) {
      const int h = (int)__fmul_rn(unif(gi, seed[13]), 4.0f);
#pragma unroll
      for (int d = 0; d < 4; ++d) nw[d] += d == h;
    }
  }
  int* wo = walk_o + (long)b * 4 * HW;
  int* co = cross_o + (long)b * 4 * HW;
  unsigned s_w = 0, s_c = 0;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    wo[d * HW + i] = nw[d];
    co[d * HW + i] = nc[d];
    s_w += (unsigned)nw[d];
    s_c += (unsigned)nc[d];
  }
  block_o[(long)b * HW + i] = (int)s_c > 0;
  count_o[(long)b * HW + i] = (int)(s_w + s_c);
}

}  // namespace ped
}  // namespace tsim

// walk, cross int32 [B, 4, H, W]; cell u8 [H, W] (geo 0) or [B, H, W]
// (geo 1); stop bool [B, H, W]; seeds int64 [B, 14] (u32 values);
// n_side int32 [1] or [B] (the sidewalk cells of each world); row0 the
// world's row of the planes' first row; outputs walk', cross' [B, 4, H,
// W], block bool [B, H, W], count int32 [B, H, W]
extern "C" int tsim_step_pedestrians(const int* walk, const int* cross,
                                     const uint8_t* cell,
                                     const uint8_t* stop,
                                     const long long* seeds,
                                     const int* n_side, int* walk_o,
                                     int* cross_o, uint8_t* block_o,
                                     int* count_o, int B, int H, int W,
                                     int geo, float lam, int spawn,
                                     int row0, void* stream) {
  using namespace tsim;
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  const dim3 grid((W + ped::TX - 1) / ped::TX, (H + ped::TY - 1) / ped::TY,
                  B);
  ped::step_kernel<<<grid, ped::NTHREADS, 0, (cudaStream_t)stream>>>(
      walk, cross, cell, stop, seeds, n_side, walk_o, cross_o, block_o,
      count_o, H, W, geo, lam, spawn, row0);
  return (int)cudaGetLastError();
}
