// Rain clouds over n ticks, for agents/rain.step_rain_ticks: each
// cloud's move, its exit off the map, the cooldown that starts when the
// last cloud leaves, and a spawn into the first free slot.
//
// A world's clouds are a [9, R] table, a column per cloud: x, y, vx, vy,
// the exit bounds -rad, -rad, W + rad, H + rad, and rad.  spawn [9, n]
// holds the cloud tick t would place, want_cd[t] the cooldown at which it
// does (0, or -1 for a tick that draws no spawn).  The table after each
// tick and the active flags go to seen / seen_a; a tick reads the table
// the tick before wrote.  One thread per world walks the ticks in order:
// a world has a few clouds, so the kernel is bound by launch latency.
// Its float work is the adds x + vx, y + vy and compares, so the bits
// are those of the plain version (agents/rain.cloud_ticks_plain).
#include "common.cuh"

namespace tsim {

constexpr int CLOUD_ROWS = 9;

__global__ void rain_ticks_kernel(const float* __restrict__ clouds0,
                                  const uint8_t* __restrict__ active0,
                                  const int* __restrict__ cd0,
                                  const float* __restrict__ spawn,
                                  const int* __restrict__ want_cd,
                                  float* __restrict__ seen,
                                  uint8_t* __restrict__ seen_a,
                                  int* __restrict__ cd_out, int B, int n,
                                  int R, int cool) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* prev = clouds0 + (long)b * CLOUD_ROWS * R;
  const uint8_t* prev_a = active0 + (long)b * R;
  const float* sp = spawn + (long)b * CLOUD_ROWS * n;
  int cd = cd0[b];
  for (int t = 0; t < n; ++t) {
    float* cur = seen + ((long)b * n + t) * CLOUD_ROWS * R;
    uint8_t* cur_a = seen_a + ((long)b * n + t) * R;
    bool exited = false, left = false;
    for (int k = 0; k < R; ++k) {
      for (int r = 2; r < CLOUD_ROWS; ++r) cur[r * R + k] = prev[r * R + k];
      const float x = __fadd_rn(prev[k], prev[2 * R + k]);
      const float y = __fadd_rn(prev[R + k], prev[3 * R + k]);
      cur[k] = x;
      cur[R + k] = y;
      const bool out = x < cur[4 * R + k] || y < cur[5 * R + k] ||
                       x > cur[6 * R + k] || y > cur[7 * R + k];
      bool a = prev_a[k] != 0;
      if (a && out) {
        exited = true;
        a = false;
      }
      left = left || a;
      cur_a[k] = a;
    }
    cd = (exited && !left) ? cool : max(cd - 1, 0);
    if (cd == want_cd[(long)b * n + t]) {
      for (int k = 0; k < R; ++k) {
        if (!cur_a[k]) {
          cur_a[k] = 1;
          for (int r = 0; r < CLOUD_ROWS; ++r) cur[r * R + k] = sp[r * n + t];
          break;
        }
      }
    }
    prev = cur;
    prev_a = cur_a;
  }
  cd_out[b] = cd;
}

}  // namespace tsim

extern "C" int tsim_rain_ticks(const float* clouds0, const uint8_t* active0,
                               const int* cd0, const float* spawn,
                               const int* want_cd, float* seen,
                               uint8_t* seen_a, int* cd_out, int B, int n,
                               int R, int cool, void* stream) {
  using namespace tsim;
  tsim::rain_ticks_kernel<<<blocks_for(B), THREADS, 0,
                            (cudaStream_t)stream>>>(
      clouds0, active0, cd0, spawn, want_cd, seen, seen_a, cd_out, B, n, R,
      cool);
  return (int)cudaGetLastError();
}
