// K3: per-direction overtake merge wavefronts, packed one byte per
// blocked direction into an int32 plane.
//
// Replaces pallas_engine.build_wavefront_pallas (wavefront_core).  A
// ping-pong stencil over the [4, H, W] direction stack: one seed launch,
// one min-plus relax launch per step (K_OVT of them), one argmin + pack
// launch, each for a whole batch of B worlds (blockIdx.y is the world).
// `allowed` and `road` are the shared geometry; `hard`, the output and
// the [2, B, 4, H, W] ping-pong scratch are per world.  Neighbour reads
// outside the grid see the fills of the padded shifts they replace:
// road False, hard True (so no move leaves the grid), wavefront value
// BIGW; they never reach another world's plane.
#include "common.cuh"

namespace tsim {

constexpr int BIGW = 127;

// move permission for direction m at (y, x): lands on road or is legal
// flow here, and the target is not a hard blocker
__device__ __forceinline__ bool can_mv(const uint8_t* allowed,
                                       const uint8_t* road,
                                       const uint8_t* hard, int c, int n,
                                       int m) {
  if (n < 0) return false;
  const bool legal = (allowed[c] >> m) & 1;
  return (legal || road[n]) && !hard[n];
}

__global__ void wf_seed(const uint8_t* __restrict__ allowed,
                        const uint8_t* __restrict__ road,
                        const uint8_t* __restrict__ hard0,
                        int* __restrict__ wv0, int H, int W) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int HW = H * W;
  if (c >= HW) return;
  const uint8_t* hard = hard0 + (long)blockIdx.y * HW;
  int* wv = wv0 + (long)blockIdx.y * 4 * HW;
  const int y = c / W, x = c % W;
  const bool road_free = road[c] && !hard[c];
  for (int d = 0; d < 4; ++d) {
    // a free road cell one step past a hard blocker along d
    const int n = nbr(y, x, opposite(d), H, W);
    const bool src = n >= 0 && hard[n] && ((allowed[n] >> d) & 1) &&
                     road_free;
    wv[(long)d * HW + c] = src ? 0 : BIGW;
  }
}

__global__ void wf_relax(const uint8_t* __restrict__ allowed,
                         const uint8_t* __restrict__ road,
                         const uint8_t* __restrict__ hard0,
                         const int* __restrict__ win0,
                         int* __restrict__ wout0, int H, int W) {
  const int HW = H * W;
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 4L * HW) return;
  const uint8_t* hard = hard0 + (long)blockIdx.y * HW;
  const int* win = win0 + (long)blockIdx.y * 4 * HW;
  int* wout = wout0 + (long)blockIdx.y * 4 * HW;
  const int d = (int)(i / HW), c = (int)(i % HW);
  const int y = c / W, x = c % W;
  const int* w = win + (long)d * HW;
  int nv = w[c];
  for (int m = 0; m < 4; ++m) {
    const int n = nbr(y, x, m, H, W);
    const int val = can_mv(allowed, road, hard, c, n, m) ? w[n] : BIGW;
    nv = min(nv, val + 1);
  }
  wout[i] = min(nv, BIGW);
}

__global__ void wf_pack(const uint8_t* __restrict__ allowed,
                        const uint8_t* __restrict__ road,
                        const uint8_t* __restrict__ hard0,
                        const int* __restrict__ wv0, int* __restrict__ out0,
                        int k_ovt, int H, int W) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int HW = H * W;
  if (c >= HW) return;
  const uint8_t* hard = hard0 + (long)blockIdx.y * HW;
  const int* wv = wv0 + (long)blockIdx.y * 4 * HW;
  int* out = out0 + (long)blockIdx.y * HW;
  const int y = c / W, x = c % W;
  const uint32_t legal_w = allowed[c] & 15u;
  uint32_t word = 0;
  for (int d = 0; d < 4; ++d) {
    const int* w = wv + (long)d * HW;
    const int here = w[c];
    int wbest = BIGW, warg = 7;
    for (int m = 0; m < 4; ++m) {
      const int n = nbr(y, x, m, H, W);
      const int val = can_mv(allowed, road, hard, c, n, m) ? w[n] : BIGW;
      if (val < wbest) {
        wbest = val;
        warg = m;
      }
    }
    const bool wvalid = here <= k_ovt && wbest < here;
    const uint32_t contra = 1u - ((legal_w >> warg) & 1u);
    const uint32_t byte = wvalid ? ((uint32_t)warg | (contra << 3)) : 7u;
    word |= byte << (8 * d);
  }
  out[c] = (int)word;
}

}  // namespace tsim

extern "C" int tsim_build_wavefront(const uint8_t* allowed,
                                    const uint8_t* road, const uint8_t* hard,
                                    int* out, int* scratch, int k_ovt, int B,
                                    int H, int W, void* stream) {
  using namespace tsim;
  cudaStream_t s = (cudaStream_t)stream;
  const long HW = (long)H * W;
  int* a = scratch;
  int* b = scratch + (long)B * 4 * HW;
  const dim3 grid1(blocks_for(HW), B), grid4(blocks_for(4 * HW), B);
  wf_seed<<<grid1, THREADS, 0, s>>>(allowed, road, hard, a, H, W);
  for (int k = 0; k < k_ovt; ++k) {
    wf_relax<<<grid4, THREADS, 0, s>>>(allowed, road, hard, a, b, H, W);
    int* t = a;
    a = b;
    b = t;
  }
  wf_pack<<<grid1, THREADS, 0, s>>>(allowed, road, hard, a, out, k_ovt, H,
                                    W);
  return (int)cudaGetLastError();
}
