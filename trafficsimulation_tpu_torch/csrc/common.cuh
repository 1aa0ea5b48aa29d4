// Shared definitions of the port's CUDA kernels (sm_90a).
//
// Packed vehicle planes use the JAX package's bit layout
// (trafficsimulation_tpu/ops/engine.py); they arrive as int32 buffers and
// are handled as uint32_t here, so every shift is logical.
//
// Directions: index m = 0 N (+y), 1 E (+x), 2 S (-y), 3 W (-x); the
// neighbour in direction m of (y, x) is (y + DY[m], x + DX[m]).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tsim {

constexpr int PA_KIND_SH = 1;
constexpr int PA_HEAD_SH = 3;
constexpr int PA_BASE_SH = 6;
constexpr int PA_CUR_SH = 10;
constexpr int PA_PARKED_SH = 14;
constexpr int PA_COL_SH = 15;
constexpr int PA_MAL_SH = 16;
constexpr int PA_STUCKF_SH = 17;
constexpr int PA_DEST_SH = 18;
constexpr int PB_STUCK_SH = 0;
constexpr int PB_STRAND_SH = 12;
constexpr int PB_CONTRA_SH = 24;
constexpr int PC_STEPS_SH = 20;
constexpr int PD_CFKEY_SH = 24;
constexpr int PD_CFMODE_SH = 26;
constexpr int PD_CFSTEPS_SH = 27;

constexpr uint32_t ND_NONE4 = 0x07070707u;
constexpr int KBIG = 1 << 19;
constexpr int KINF = 0x7FFFFFFF;
constexpr int THREADS = 256;

__device__ __forceinline__ int dir_dy(int m) {
  return m == 0 ? 1 : (m == 2 ? -1 : 0);
}
__device__ __forceinline__ int dir_dx(int m) {
  return m == 1 ? 1 : (m == 3 ? -1 : 0);
}
__device__ __forceinline__ int opposite(int m) { return (m + 2) & 3; }

// flat index of the neighbour in direction m, or -1 outside the grid
__device__ __forceinline__ int nbr(int y, int x, int m, int H, int W) {
  const int ny = y + dir_dy(m), nx = x + dir_dx(m);
  return (ny >= 0 && ny < H && nx >= 0 && nx < W) ? ny * W + nx : -1;
}

__device__ __forceinline__ uint32_t fld(uint32_t p, int sh, int bits) {
  return (p >> sh) & ((1u << bits) - 1u);
}
__device__ __forceinline__ bool bit(uint32_t p, int sh) {
  return (p >> sh) & 1u;
}

inline int blocks_for(long n) { return (int)((n + THREADS - 1) / THREADS); }

}  // namespace tsim
