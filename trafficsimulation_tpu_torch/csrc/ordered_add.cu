// f32 scatter-add in update order, for the service FSM's block tanks.
//
// The JAX package adds the deliveries of a tick into the block tanks with
// `food.at[sb].add(give)` (ops/engine.py, `_post_move`); XLA on the CPU
// folds duplicate indices in update order starting from the stored
// value, ((food[t] + v_i0) + v_i1) + ..., and f32 addition is not
// associative.  An atomic scatter on the card adds in no fixed order, so
// this kernel folds instead.  R independent rows (food and waste, times
// the worlds of a batch) run in one launch, one block per row.  Indices
// outside [0, T) are dropped.
//
// Exactness: under round-to-nearest without flush-to-zero, acc + (+-0)
// is acc except (-0) + (+0) = +0, and -0 + y = +0 + y for every nonzero
// y; a sum of two nonzero values is never -0.  So the zero updates of a
// target change its result in one case only: no nonzero update reaches
// it, its base is -0 and some update is +0, and then the result is +0.
// The call site sends one update per destination slot, almost all of
// them +-0, onto a few hundred or thousand targets.
//
// Design, O(n + T) per row (the one before walked all n updates for
// each of the T targets):
//  1. an order-keeping compaction of the in-range nonzero updates (a
//     block-wide prefix sum of the keep flags), counting each target's
//     updates and marking the targets that a +0 update reaches;
//  2. an exclusive scan of the counts: the start of each target's run;
//  3. a stable placement of the compacted updates into the runs, 32 at a
//     time by one warp: equal targets ranked in update order with
//     __match_any_sync, each target's cursor advanced after a chunk;
//  4. one thread per target folds its run from base[t] with __fadd_rn,
//     then applies the zero rule.
// The work area lives in shared memory, or, for a row too large for it,
// in device memory that the caller passes (the same code either way).
// Bound by latency: a few thousand updates per row, a few scans.
#include "common.cuh"

namespace tsim {

constexpr int OA_THREADS = 1024, OA_ITEMS = 4, OA_WARPS = OA_THREADS / 32;
constexpr long OA_SMEM_MAX = 200 * 1024;

// bytes of one row's work area: run starts [T + 1], cursors [T], the
// compacted targets, values and the placed values [n] each, +0 marks [T]
__host__ __device__ inline long oa_work_bytes(int T, int n) {
  return ((4L * (2L * T + 1 + 3L * n) + T) + 15) / 16 * 16;
}

// exclusive prefix sum over the block of one value per thread (in
// thread order); *total is the block's sum
__device__ __forceinline__ int block_scan(int x, int* wsum, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = wsum[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    wsum[lane] = w;
  }
  __syncthreads();
  const int excl = (warp ? wsum[warp - 1] : 0) + incl - x;
  *total = wsum[OA_WARPS - 1];
  __syncthreads();
  return excl;
}

__global__ void __launch_bounds__(OA_THREADS)
    ordered_add_kernel(const float* __restrict__ base,
                       const int64_t* __restrict__ idx,
                       const float* __restrict__ vals,
                       float* __restrict__ out, int T, int n, char* gwork) {
  extern __shared__ __align__(16) char smem[];
  __shared__ int wsum[OA_WARPS];
  const long r = blockIdx.x;
  char* w = gwork ? gwork + r * oa_work_bytes(T, n) : smem;
  int* start = (int*)w;
  int* cur = start + (T + 1);
  int* ctgt = cur + T;
  float* cval = (float*)(ctgt + n);
  float* sval = cval + n;
  unsigned char* plus0 = (unsigned char*)(sval + n);
  const int64_t* ir = idx + r * n;
  const float* vr = vals + r * n;
  const int tid = threadIdx.x, lane = tid & 31;

  for (int t = tid; t <= T; t += OA_THREADS) start[t] = 0;
  for (int t = tid; t < T; t += OA_THREADS) plus0[t] = 0;
  __syncthreads();

  // 1: compaction, OA_ITEMS consecutive updates a thread
  int m = 0;
  for (int i0 = 0; i0 < n; i0 += OA_THREADS * OA_ITEMS) {
    int tg[OA_ITEMS];
    float v[OA_ITEMS];
    int cnt = 0;
#pragma unroll
    for (int q = 0; q < OA_ITEMS; ++q) {
      const int i = i0 + tid * OA_ITEMS + q;
      tg[q] = -1;
      v[q] = 0.0f;
      if (i < n) {
        const int64_t t = ir[i];
        if (t >= 0 && t < T) {
          v[q] = vr[i];
          const uint32_t bits = __float_as_uint(v[q]);
          if (bits & 0x7FFFFFFFu) {
            tg[q] = (int)t;
            ++cnt;
          } else if (bits == 0u) {
            plus0[t] = 1;
          }
        }
      }
    }
    int total;
    int j = m + block_scan(cnt, wsum, &total);
#pragma unroll
    for (int q = 0; q < OA_ITEMS; ++q)
      if (tg[q] >= 0) {
        ctgt[j] = tg[q];
        cval[j] = v[q];
        ++j;
        atomicAdd(&start[tg[q]], 1);
      }
    m += total;
  }
  __syncthreads();

  // 2: counts -> run starts (start[T] = m)
  int run = 0;
  for (int t0 = 0; t0 < T; t0 += OA_THREADS * OA_ITEMS) {
    int c[OA_ITEMS], sum = 0;
#pragma unroll
    for (int q = 0; q < OA_ITEMS; ++q) {
      const int t = t0 + tid * OA_ITEMS + q;
      c[q] = t < T ? start[t] : 0;
      sum += c[q];
    }
    int total;
    int at = run + block_scan(sum, wsum, &total);
#pragma unroll
    for (int q = 0; q < OA_ITEMS; ++q) {
      const int t = t0 + tid * OA_ITEMS + q;
      if (t < T) {
        start[t] = at;
        cur[t] = at;
      }
      at += c[q];
    }
    run += total;
  }
  if (tid == 0) start[T] = m;
  __syncthreads();

  // 3: stable placement by warp 0, 32 updates at a time
  if (tid < 32) {
    const unsigned lt = (1u << lane) - 1u;
    for (int j0 = 0; j0 < m; j0 += 32) {
      const int j = j0 + lane;
      const bool act = j < m;
      const unsigned act_mask = __ballot_sync(0xffffffffu, act);
      int t = 0, pos = 0;
      unsigned peers = 0;
      if (act) {
        t = ctgt[j];
        peers = __match_any_sync(act_mask, t);
        pos = cur[t] + __popc(peers & lt);
      }
      __syncwarp();
      if (act) {
        sval[pos] = cval[j];
        if (lane == 31 - __clz(peers)) cur[t] += __popc(peers);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // 4: one thread per target folds its run in update order
  const float* br = base + r * T;
  float* orow = out + r * T;
  for (int t = tid; t < T; t += OA_THREADS) {
    float acc = br[t];
    const int a = start[t], e = start[t + 1];
    for (int k = a; k < e; ++k) acc = __fadd_rn(acc, sval[k]);
    if (a == e && plus0[t] && __float_as_uint(acc) == 0x80000000u)
      acc = 0.0f;
    orow[t] = acc;
  }
}

}  // namespace tsim

// device-memory bytes a row's work area needs, 0 when it fits in shared
// memory (the caller then passes no work area)
extern "C" long tsim_ordered_add_work(int T, int n) {
  const long b = tsim::oa_work_bytes(T, n);
  return b <= tsim::OA_SMEM_MAX ? 0 : b;
}

extern "C" int tsim_ordered_add(const float* base, const int64_t* idx,
                                const float* vals, float* out, void* work,
                                int R, int T, int n, void* stream) {
  using namespace tsim;
  static bool attr_set = false;
  const long b = oa_work_bytes(T, n);
  const bool in_smem = b <= OA_SMEM_MAX;
  if (!in_smem && work == nullptr) return (int)cudaErrorInvalidValue;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        ordered_add_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)OA_SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  ordered_add_kernel<<<R, OA_THREADS, in_smem ? b : 0,
                       (cudaStream_t)stream>>>(
      base, idx, vals, out, T, n, in_smem ? nullptr : (char*)work);
  return (int)cudaGetLastError();
}
