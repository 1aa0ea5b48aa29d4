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
// Flush: XLA's CPU runtime adds with subnormals flushed to zero (FTZ and
// DAZ: a subnormal operand or result becomes a zero of its sign), and so
// does this kernel: it folds with add.rn.ftz.f32.  A target that no
// update reaches keeps its base bits; one that only +-0 or subnormal
// updates reach ends at its base flushed (the same add of -0).
//
// Exactness: call an update a zero update when it reads as +-0 under DAZ
// (a zero or a subnormal), nonzero otherwise.  Under round-to-nearest,
// acc + (+-0) is acc except (-0) + (+0) = +0, and -0 + y = +0 + y for
// every nonzero y.  So the zero updates change a fold in one place only:
// where it ends at -0 and a +0 update (+0 or a positive subnormal)
// comes after the target's last nonzero update, or anywhere when it has
// none, the result is +0.  Without a flush a sum of nonzero values is
// never -0; with one it is when a tiny negative result flushes
// (-1.5e-38 + 1.4e-38 -> -0), so the rule needs the order positions of
// the last nonzero and the last +0 update of each target.  The call site
// sends one update per destination slot, almost all of them +-0, onto a
// few hundred or thousand targets.
//
// Design, O(n + T) per row (the one before walked all n updates for
// each of the T targets):
//  1. an order-keeping compaction of the in-range nonzero updates (a
//     block-wide prefix sum of the keep flags), counting each target's
//     updates, keeping the order position of its last nonzero and of its
//     last +0 update (shared atomicMax, one per warp where a warp's
//     updates share a target), and
//     marking the targets that a zero update reaches;
//  2. an exclusive scan of the counts: the start of each target's run;
//  3. a stable placement of the compacted updates into the runs, 32 at a
//     time by one warp: equal targets ranked in update order with
//     __match_any_sync, each target's cursor advanced after a chunk;
//  4. one thread per target folds its run from base[t] with
//     add.rn.ftz.f32, then applies the zero rule.
// The work area lives in shared memory, or, for a row too large for it,
// in device memory that the caller passes (the same code either way).
// Bound by latency: a few thousand updates per row, a few scans.
#include "common.cuh"

namespace tsim {

constexpr int OA_THREADS = 1024, OA_ITEMS = 4, OA_WARPS = OA_THREADS / 32;
constexpr long OA_SMEM_MAX = 200 * 1024;

// bytes of one row's work area: run starts [T + 1], cursors, the last
// nonzero and the last +0 update's positions [T] each, the compacted
// targets, values and the placed values [n] each, zero-update marks [T]
__host__ __device__ inline long oa_work_bytes(int T, int n) {
  return ((4L * (4L * T + 1 + 3L * n) + T) + 15) / 16 * 16;
}

// a + b with subnormal operands and result flushed to zeros of their sign
__device__ __forceinline__ float add_ftz(float a, float b) {
  float r;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
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

// pos[t] = max(pos[t], i) for this lane's target t (t < 0: none).  Where
// the whole warp holds one target (the call site's runs of updates onto
// one block) lane 31, which holds the largest position, makes the one
// shared atomic; otherwise each lane makes its own.  Every lane of the
// warp calls it.
__device__ __forceinline__ void warp_last(int* pos, int t, int i) {
  if (__all_sync(0xffffffffu, t == __shfl_sync(0xffffffffu, t, 31))) {
    if ((threadIdx.x & 31) == 31 && t >= 0) atomicMax(&pos[t], i);
  } else if (t >= 0) {
    atomicMax(&pos[t], i);
  }
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
  int* last_nz = cur + T;
  int* last_p0 = last_nz + T;
  int* ctgt = last_p0 + T;
  float* cval = (float*)(ctgt + n);
  float* sval = cval + n;
  unsigned char* zmark = (unsigned char*)(sval + n);
  const int64_t* ir = idx + r * n;
  const float* vr = vals + r * n;
  const int tid = threadIdx.x, lane = tid & 31;

  for (int t = tid; t <= T; t += OA_THREADS) start[t] = 0;
  for (int t = tid; t < T; t += OA_THREADS) {
    last_nz[t] = -1;
    last_p0[t] = -1;
    zmark[t] = 0;
  }
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
      int tp0 = -1;           // the target of a +0 update
      tg[q] = -1;
      v[q] = 0.0f;
      if (i < n) {
        const int64_t t = ir[i];
        if (t >= 0 && t < T) {
          v[q] = vr[i];
          const uint32_t bits = __float_as_uint(v[q]);
          if (bits & 0x7F800000u) {
            tg[q] = (int)t;
            ++cnt;
          } else {
            zmark[t] = 1;
            if (!(bits >> 31)) tp0 = (int)t;
          }
        }
      }
      warp_last(last_nz, tg[q], i);
      warp_last(last_p0, tp0, i);
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
    for (int k = a; k < e; ++k) acc = add_ftz(acc, sval[k]);
    if (a == e && zmark[t]) acc = add_ftz(acc, -0.0f);
    if (__float_as_uint(acc) == 0x80000000u && last_p0[t] > last_nz[t])
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
