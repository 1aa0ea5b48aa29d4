// K3: per-direction overtake merge wavefronts, packed one byte per
// blocked direction into an int32 plane.
//
// Replaces pallas_engine.build_wavefront_pallas (wavefront_core): a
// min-plus stencil over the [4, H, W] direction stack, K_OVT relax
// steps, then an argmin over the four neighbours and a pack.  On the
// H100 the function is tiny (a select and a min per step, direction and
// neighbour; ~5 bytes a cell and world), so launches and device-memory
// round trips bound a kernel that runs it step by step.  Design: ONE
// launch a call, a block per (tile, world) (blockIdx.y is the world;
// the geometry `allowed` and `road` is one plane for every world, or
// one a world where the call passes geo_w = 1: config #4's batch of
// cities):
//  - the block stages its TH x 32 output tile plus a halo of
//    K_OVT + 1 cells of `allowed`, `road` and `hard` into one geometry
//    byte per cell in shared memory (the grid-edge fills of the padded
//    shifts outside the grid: road False, hard True, no legal flow), and
//    precomputes each cell's four can-move bits and its seed word;
//  - the K_OVT relax steps run in shared memory, the four directions'
//    values (all <= BIGW = 127) in the 16-bit lanes of two words a cell,
//    ping-pong between two arrays, with Hopper's DPX min-of-three and
//    add-min on both lanes at once (`__vimin3_u16x2`, `__viaddmin_u16x2`);
//  - the argmin and pack of the tile's cells, one int32 store each.
// The halo, derived: the pack reads its neighbours' final values (1
// cell out), each relax step reads one cell further (K_OVT), and a
// seed reads `hard` and `allowed` at its opposite neighbour, one cell
// further still.  That last cell is not needed: a source the region's
// outermost ring misses lies K_OVT + 1 cells from the tile, so after
// K_OVT steps it gives a neighbour of a tile cell K_OVT at the least
// and the tile cell nothing, while the pack takes a byte only where
// the cell's own value is at most K_OVT and a neighbour's is below it.
// So K_OVT + 1 cells of halo are exact and K_OVT are not (the CPU
// emulation in tests/test_torch_wavefront.py holds both).  Step i
// relaxes the region's cells at least i cells from its edge, which read
// only values the step before computed.  Nothing of a step goes to
// device memory, and no index is divided at run time.
#include "common.cuh"

namespace tsim {

constexpr int BIGW = 127;
constexpr uint32_t BIGW2 = 0x007F007Fu;  // BIGW in both 16-bit lanes
constexpr uint32_t ONE2 = 0x00010001u;
constexpr int WF_TW = 32;                 // the output tile's width
constexpr int WF_KMAX = 8;                // most relax steps the launch takes
constexpr int WF_HALO_MAX = WF_KMAX + 1;
constexpr int WF_RW_MAX = WF_TW + 2 * WF_HALO_MAX;
// the geometry byte: bits 0..3 legal flow, 4 road, 5 hard
constexpr uint32_t G_ROAD = 16u, G_HARD = 32u;

// one tile of TH x WF_TW output cells of world blockIdx.y; the region
// (tile and halo) holds each cell's values as two words of two 16-bit
// lanes (directions 0, 1 and 2, 3), relaxed with Hopper's DPX min-of-3
// and add-min
template <int TH>
__global__ void __launch_bounds__(THREADS)
    wf_tiled(const uint8_t* __restrict__ allowed,
             const uint8_t* __restrict__ road,
             const uint8_t* __restrict__ hard0, int* __restrict__ out0,
             int k_ovt, int H, int W, int tiles_x, int geo_w) {
  constexpr int RN_MAX = WF_RW_MAX * (TH + 2 * WF_HALO_MAX);
  __shared__ uint2 wv[2][RN_MAX];
  __shared__ uint8_t geo[RN_MAX];
  __shared__ uint8_t cm[RN_MAX];
  const int halo = k_ovt + 1;
  const int RW = WF_TW + 2 * halo, RH = TH + 2 * halo;
  const int tile_y = blockIdx.x / tiles_x;
  const int oy = tile_y * TH - halo;
  const int ox = (blockIdx.x - tile_y * tiles_x) * WF_TW - halo;
  const long HW = (long)H * W;
  const uint8_t* hard = hard0 + (long)blockIdx.y * HW;
  if (geo_w) {
    allowed += (long)blockIdx.y * HW;
    road += (long)blockIdx.y * HW;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int NWARP = THREADS / 32;
  // region offsets of the neighbours in directions N (+y), E, S, W
  const int off[4] = {RW, 1, -RW, -1};

  // stage the geometry bytes, with the grid-edge fills outside the grid
  for (int ry = warp; ry < RH; ry += NWARP) {
    const int y = oy + ry;
    for (int rx = lane; rx < RW; rx += 32) {
      const int x = ox + rx;
      uint32_t g = G_HARD;
      if (y >= 0 && y < H && x >= 0 && x < W) {
        const long c = (long)y * W + x;
        g = (allowed[c] & 15u) | (road[c] ? G_ROAD : 0u) |
            (hard[c] ? G_HARD : 0u);
      }
      geo[ry * RW + rx] = (uint8_t)g;
    }
  }
  __syncthreads();

  // can-move bits and seeds; a neighbour outside the region reads as no
  // move and no source (the region's outermost ring is never relaxed,
  // and what it misses never reaches a byte the pack takes)
  for (int ry = warp; ry < RH; ry += NWARP) {
    for (int rx = lane; rx < RW; rx += 32) {
      const int q = ry * RW + rx;
      const uint32_t g = geo[q];
      uint32_t can = 0u, seed = 15u;  // bit d: direction d has no source
      const bool road_free = (g & G_ROAD) && !(g & G_HARD);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int ny = ry + (m == 0 ? 1 : m == 2 ? -1 : 0);
        const int nx = rx + (m == 1 ? 1 : m == 3 ? -1 : 0);
        if (ny < 0 || ny >= RH || nx < 0 || nx >= RW) continue;
        const uint32_t gn = geo[q + off[m]];
        if ((((g >> m) & 1u) || (gn & G_ROAD)) && !(gn & G_HARD))
          can |= 1u << m;
        // a free road cell one step past a hard blocker along d, whose
        // flow there allows d: the blocker lies at opposite(d) = m
        const int d = (m + 2) & 3;
        if (road_free && (gn & G_HARD) && ((gn >> d) & 1u))
          seed &= ~(1u << d);
      }
      cm[q] = (uint8_t)can;
      wv[0][q] = make_uint2(((seed & 1u) ? BIGW : 0u) |
                                ((seed & 2u) ? (uint32_t)BIGW << 16 : 0u),
                            ((seed & 4u) ? BIGW : 0u) |
                                ((seed & 8u) ? (uint32_t)BIGW << 16 : 0u));
    }
  }
  __syncthreads();

  // the relax steps: step i over the cells at least i from the edge;
  // new = min(here, min over movable neighbours + 1)
  int src = 0;
  for (int i = 1; i <= k_ovt; ++i) {
    const uint2* a = wv[src];
    uint2* b = wv[src ^ 1];
    for (int ry = i + warp; ry < RH - i; ry += NWARP) {
      for (int rx = i + lane; rx < RW - i; rx += 32) {
        const int q = ry * RW + rx;
        const uint32_t can = cm[q];
        uint2 n[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const uint2 v = a[q + off[m]];
          const bool ok = (can >> m) & 1u;
          n[m] = make_uint2(ok ? v.x : BIGW2, ok ? v.y : BIGW2);
        }
        const uint2 h = a[q];
        const uint32_t lo = __vimin3_u16x2(__vimin3_u16x2(n[0].x, n[1].x,
                                                          n[2].x),
                                           n[3].x, n[3].x);
        const uint32_t hi = __vimin3_u16x2(__vimin3_u16x2(n[0].y, n[1].y,
                                                          n[2].y),
                                           n[3].y, n[3].y);
        b[q] = make_uint2(__viaddmin_u16x2(lo, ONE2, h.x),
                          __viaddmin_u16x2(hi, ONE2, h.y));
      }
    }
    src ^= 1;
    __syncthreads();
  }

  // argmin over the neighbours and the pack, one store per tile cell
  const uint2* f = wv[src];
  int* out = out0 + (long)blockIdx.y * HW;
  for (int ly = warp; ly < TH; ly += NWARP) {
    const int y = oy + halo + ly, x = ox + halo + lane;
    if (y >= H || x >= W) continue;
    const int q = (ly + halo) * RW + lane + halo;
    const uint2 here = f[q];
    const uint32_t can = cm[q], legal_w = geo[q] & 15u;
    uint2 nv[4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
      nv[m] = ((can >> m) & 1u) ? f[q + off[m]] : make_uint2(BIGW2, BIGW2);
    uint32_t word = 0;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const int sh = 16 * (d & 1);
      const int h = (int)((((d & 2) ? here.y : here.x) >> sh) & 0xFFu);
      int wbest = BIGW, warg = 7;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int v = (int)((((d & 2) ? nv[m].y : nv[m].x) >> sh) & 0xFFu);
        if (v < wbest) {
          wbest = v;
          warg = m;
        }
      }
      const bool wvalid = h <= k_ovt && wbest < h;
      const uint32_t contra = 1u - ((legal_w >> warg) & 1u);
      word |= (wvalid ? ((uint32_t)warg | (contra << 3)) : 7u) << (8 * d);
    }
    out[(long)y * W + x] = (int)word;
  }
}

template <int TH>
static cudaError_t wf_launch(const uint8_t* allowed, const uint8_t* road,
                             const uint8_t* hard, int* out, int k_ovt, int B,
                             int H, int W, int geo_w, cudaStream_t s) {
  const int tiles_x = (W + WF_TW - 1) / WF_TW;
  const long tiles = (long)tiles_x * ((H + TH - 1) / TH);
  wf_tiled<TH><<<dim3((unsigned)tiles, B), THREADS, 0, s>>>(
      allowed, road, hard, out, k_ovt, H, W, tiles_x, geo_w);
  return cudaGetLastError();
}

}  // namespace tsim

// one launch for B worlds: 32 x 32 tiles, or 32 x 16 where those would
// leave SMs idle (one world at 256^2); `allowed` and `road` are shared
// (geo_w = 0) or [B, H, W] (geo_w = 1)
extern "C" int tsim_build_wavefront(const uint8_t* allowed,
                                    const uint8_t* road, const uint8_t* hard,
                                    int* out, int k_ovt, int B, int H, int W,
                                    int geo_w, void* stream) {
  using namespace tsim;
  if (k_ovt < 0 || k_ovt > WF_KMAX || B > 65535 || (geo_w != 0 && geo_w != 1))
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  static int nsm = 0;
  if (nsm == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  const long tiles32 =
      (long)B * ((W + WF_TW - 1) / WF_TW) * ((H + 31) / 32);
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(tiles32 < nsm
                   ? wf_launch<16>(allowed, road, hard, out, k_ovt, B, H, W,
                                   geo_w, s)
                   : wf_launch<32>(allowed, road, hard, out, k_ovt, B, H, W,
                                   geo_w, s));
}
