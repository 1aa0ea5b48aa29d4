// f32 scatter-add in update order, for the service FSM's block tanks.
//
// The JAX package adds the deliveries of a tick into the block tanks with
// `food.at[sb].add(give)` (ops/engine.py, `_post_move`); XLA on the CPU
// folds duplicate indices in update order starting from the stored
// value, ((food[t] + v_i0) + v_i1) + ..., and f32 addition is not
// associative.  An atomic scatter on the card adds in no fixed order, so
// this kernel folds instead: one thread per target t walks the n updates
// in order and adds those aimed at t.  R independent rows (food and
// waste, times the worlds of a batch) run in one launch, blockIdx.y
// being the row.  Indices outside [0, T) are dropped.  Bound by launch
// latency: a few hundred targets and updates per row.
#include "common.cuh"

namespace tsim {

__global__ void ordered_add_kernel(const float* __restrict__ base,
                                   const int64_t* __restrict__ idx,
                                   const float* __restrict__ vals,
                                   float* __restrict__ out, int T, int n) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const long r = blockIdx.y;
  const int64_t* ir = idx + r * n;
  const float* vr = vals + r * n;
  float acc = base[r * T + t];
  for (int i = 0; i < n; ++i)
    if (ir[i] == t) acc = __fadd_rn(acc, vr[i]);
  out[r * T + t] = acc;
}

}  // namespace tsim

extern "C" int tsim_ordered_add(const float* base, const int64_t* idx,
                                const float* vals, float* out, int R, int T,
                                int n, void* stream) {
  using namespace tsim;
  tsim::ordered_add_kernel<<<dim3(blocks_for(T), R), THREADS, 0,
                             (cudaStream_t)stream>>>(base, idx, vals, out, T,
                                                     n);
  return (int)cudaGetLastError();
}
