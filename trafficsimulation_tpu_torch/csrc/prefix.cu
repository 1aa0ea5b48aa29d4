// K4: row- and column-inclusive prefix sums of an int32 plane.
//
// Replaces pallas_engine.prefix_planes_pallas (_prefix_kernel).  One
// launch of H + W blocks: block b < H scans row b, block H + x scans
// column x.  Each block walks its line in tiles of THREADS elements:
// a warp-shuffle inclusive scan per warp, a scan of the warp totals by
// warp 0, and a carry across tiles.  The sums wrap in 32 bits as the
// JAX int32 adds do.
#include "common.cuh"

namespace tsim {

__global__ void prefix_kernel(const int* __restrict__ occ,
                              int* __restrict__ outh,
                              int* __restrict__ outv, int H, int W) {
  __shared__ uint32_t warp_tot[THREADS / 32];
  const int b = blockIdx.x;
  const int* src;
  int* dst;
  int n;
  long stride;
  if (b < H) {
    src = occ + (long)b * W;
    dst = outh + (long)b * W;
    n = W;
    stride = 1;
  } else {
    src = occ + (b - H);
    dst = outv + (b - H);
    n = H;
    stride = W;
  }
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = THREADS / 32;
  uint32_t carry = 0;
  for (int base = 0; base < n; base += THREADS) {
    const int i = base + threadIdx.x;
    uint32_t v = (i < n) ? (uint32_t)src[i * stride] : 0u;
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t t = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += t;
    }
    if (lane == 31) warp_tot[wid] = v;
    __syncthreads();
    if (wid == 0) {
      uint32_t t = (lane < nw) ? warp_tot[lane] : 0u;
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t u = __shfl_up_sync(0xffffffffu, t, o);
        if (lane >= o) t += u;
      }
      if (lane < nw) warp_tot[lane] = t;
    }
    __syncthreads();
    v += carry + (wid > 0 ? warp_tot[wid - 1] : 0u);
    if (i < n) dst[i * stride] = (int)v;
    carry += warp_tot[nw - 1];
    __syncthreads();
  }
}

}  // namespace tsim

extern "C" int tsim_prefix_planes(const int* occ, int* outh, int* outv,
                                  int H, int W, void* stream) {
  tsim::prefix_kernel<<<H + W, tsim::THREADS, 0, (cudaStream_t)stream>>>(
      occ, outh, outv, H, W);
  return (int)cudaGetLastError();
}

extern "C" const char* tsim_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}
