// K4: row- and column-inclusive prefix sums of an int32 plane.
//
// Replaces pallas_engine.prefix_planes_pallas (_prefix_kernel).  The sums
// wrap in 32 bits as the JAX int32 adds do.  On the H100 it is bound by
// device-memory bytes (one plane in, two out: 12.6 MB at 1024^2) and, at
// one 256^2 plane, by the latency of its one launch.  One launch of
// (ceil(H / 8) + ceil(W / 8)) x B blocks of 256 threads for a batch of B
// planes [B, H, W] (blockIdx.y is the plane):
//
//   rows     block x < ceil(H / 8): one warp per row.  The warp loads
//            U vectors a lane before it adds anything (V = 4 ints a
//            vector when W % 4 == 0 and the buffers are 16-byte aligned,
//            else 1), so each load instruction is a contiguous 512- (or
//            128-) byte row segment and U of them are in flight; then per
//            vector a serial scan in the lane, a warp-shuffle scan of the
//            lane totals, and a carry along the row.
//   columns  the other blocks: a band of BAND = 8 contiguous columns split
//            into SEGS = 32 row segments, one thread per (segment,
//            column).  Each thread sums its segment down the rows, the
//            block scans the segment totals through shared memory, and
//            each thread walks its segment again from its offset, storing
//            as it goes.  A warp's load covers four segments' 32-byte row
//            pieces: whole sectors, where a column read with stride W
//            used one 4-byte word of each.  The second walk reads the
//            block's band again from L1/L2, not from device memory.
#include "common.cuh"

namespace tsim {

constexpr int ROWS_PER_BLOCK = THREADS / 32;
constexpr int BAND = 8;
constexpr int SEGS = THREADS / BAND;
constexpr int U = 4;

template <int V>
__device__ __forceinline__ void scan_row(const int* __restrict__ src,
                                         int* __restrict__ dst, int W,
                                         int lane) {
  uint32_t carry = 0;
  for (int base = 0; base < W; base += 32 * V * U) {
    uint32_t v[U][V];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int i = base + (j * 32 + lane) * V;
      if constexpr (V == 4) {
        const int4 q = i < W ? __ldg(reinterpret_cast<const int4*>(src + i))
                             : make_int4(0, 0, 0, 0);
        v[j][0] = q.x;
        v[j][1] = q.y;
        v[j][2] = q.z;
        v[j][3] = q.w;
      } else {
        v[j][0] = i < W ? (uint32_t)__ldg(src + i) : 0u;
      }
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
#pragma unroll
      for (int k = 1; k < V; ++k) v[j][k] += v[j][k - 1];
      const uint32_t t = v[j][V - 1];
      uint32_t inc = t;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t u = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += u;
      }
      const uint32_t off = carry + inc - t;
      carry += __shfl_sync(0xffffffffu, inc, 31);
      const int i = base + (j * 32 + lane) * V;
      if (i < W) {
        if constexpr (V == 4) {
          *reinterpret_cast<int4*>(dst + i) =
              make_int4((int)(v[j][0] + off), (int)(v[j][1] + off),
                        (int)(v[j][2] + off), (int)(v[j][3] + off));
        } else {
          dst[i] = (int)(v[j][0] + off);
        }
      }
    }
  }
}

template <int V>
__global__ void prefix_kernel(const int* __restrict__ occ,
                              int* __restrict__ outh,
                              int* __restrict__ outv, int H, int W) {
  __shared__ uint32_t tot[SEGS][BAND];
  const long plane = (long)blockIdx.y * H * W;
  occ += plane;
  const int row_blocks = (H + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  if ((int)blockIdx.x < row_blocks) {
    const int y = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
    if (y < H)
      scan_row<V>(occ + (long)y * W, outh + plane + (long)y * W, W,
                  threadIdx.x & 31);
    return;
  }
  outv += plane;
  const int cx = threadIdx.x % BAND, seg = threadIdx.x / BAND;
  const int x = (blockIdx.x - row_blocks) * BAND + cx;
  const int len = (H + SEGS - 1) / SEGS;
  const int r0 = min(H, seg * len), r1 = min(H, r0 + len);
  uint32_t s = 0;
  if (x < W) {
#pragma unroll 8
    for (int r = r0; r < r1; ++r) s += (uint32_t)__ldg(occ + (long)r * W + x);
  }
  tot[seg][cx] = s;
  __syncthreads();
  uint32_t run = 0;
  for (int q = 0; q < seg; ++q) run += tot[q][cx];
  if (x < W) {
#pragma unroll 8
    for (int r = r0; r < r1; ++r) {
      run += (uint32_t)__ldg(occ + (long)r * W + x);
      outv[(long)r * W + x] = (int)run;
    }
  }
}

}  // namespace tsim

extern "C" int tsim_prefix_planes(const int* occ, int* outh, int* outv,
                                  int B, int H, int W, void* stream) {
  using namespace tsim;
  const dim3 grid((H + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK +
                      (W + BAND - 1) / BAND,
                  B);
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = W % 4 == 0 && ((uintptr_t)occ | (uintptr_t)outh) % 16 == 0;
  if (vec)
    prefix_kernel<4><<<grid, THREADS, 0, s>>>(occ, outh, outv, H, W);
  else
    prefix_kernel<1><<<grid, THREADS, 0, s>>>(occ, outh, outv, H, W);
  return (int)cudaGetLastError();
}

extern "C" const char* tsim_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}
