// K6: the destination-row select of a packed next-move stack.
//
// Replaces pallas_engine.select_rows_pallas (trafficsimulation_tpu/ops/
// pallas_engine.py).  nd[c] = byte (dest[c] & 3) of the word
// sdir4[dest[c] >> 2, c], and ND_NONE4's byte (7) where dest >> 2 falls
// outside [0, D4) -- a negative dest (the -1 of `hier_rows` for a cell
// outside the destination's window) included: the shift is arithmetic.
//
// The TPU kernel streams every word of the [D4, H, W] stack through VMEM
// with one compare-and-select per word, since Mosaic has no vector
// gather; at D4 = 108 and 1024^2 that is 453 MB per call.  Here a cell
// gathers the one word its dest names.  Bound on the H100: device-memory
// bytes, dest in and the result out (8 B a cell) and, since the memory
// moves whole 32-byte sectors, 32 B for every distinct sector the
// gathers touch: neighbouring cells whose dest names the same plane
// share one (the empty cells' row 0 under hierarchical routing), cells
// on different planes do not (~40 MB at 1024^2 on uniform rows, against
// 12.6 MB counted as 12 B a cell).  Design: four cells a thread, dest
// read and the result written 16 bytes at a time, the four gathers
// issued before any is used and loaded without allocating in L1 (no
// word is read twice); the cells before dest's first 16-byte boundary
// and after its last whole vector take one thread each in the same
// launch.  The output must lie at the same offset from a 16-byte
// boundary as dest (the wrapper allocates it so).
#include "common.cuh"

namespace tsim {

// one gathered word, through the read-only path without an L1 line
__device__ __forceinline__ uint32_t ld_gather(const int32_t* q) {
  uint32_t v;
  asm("ld.global.nc.L1::no_allocate.b32 %0, [%1];" : "=r"(v) : "l"(q));
  return v;
}

__device__ __forceinline__ int32_t nd_byte(uint32_t w, int d) {
  return (int32_t)((w >> ((d & 3) * 8)) & 0xFFu);
}

__device__ __forceinline__ uint32_t gather(const int32_t* sdir4, int D4,
                                           long HW, int d, long c) {
  const int hi = d >> 2;
  return (hi >= 0 && hi < D4) ? ld_gather(sdir4 + (long)hi * HW + c)
                              : ND_NONE4;
}

// thread i < nv: cells head + 4i .. head + 4i + 3; thread nv + k: the
// k-th edge cell (k < head: cell k, else one past the last vector)
__global__ void select_rows_kernel(const int32_t* __restrict__ sdir4,
                                   const int32_t* __restrict__ dest,
                                   int32_t* __restrict__ out, int D4,
                                   long HW, int head, long nv) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < nv) {
    const long c0 = head + 4 * i;
    const int4 d = __ldg(reinterpret_cast<const int4*>(dest + c0));
    const uint32_t w0 = gather(sdir4, D4, HW, d.x, c0);
    const uint32_t w1 = gather(sdir4, D4, HW, d.y, c0 + 1);
    const uint32_t w2 = gather(sdir4, D4, HW, d.z, c0 + 2);
    const uint32_t w3 = gather(sdir4, D4, HW, d.w, c0 + 3);
    *reinterpret_cast<int4*>(out + c0) =
        make_int4(nd_byte(w0, d.x), nd_byte(w1, d.y), nd_byte(w2, d.z),
                  nd_byte(w3, d.w));
    return;
  }
  const long k = i - nv;
  const long c = k < head ? k : head + 4 * nv + (k - head);
  if (c >= HW) return;
  const int d = __ldg(dest + c);
  out[c] = nd_byte(gather(sdir4, D4, HW, d, c), d);
}

}  // namespace tsim

extern "C" int tsim_select_rows(const int32_t* sdir4, const int32_t* dest,
                                int32_t* out, int D4, int HW, void* stream) {
  using namespace tsim;
  const uintptr_t a = (uintptr_t)dest;
  if ((a | (uintptr_t)out) & 3u || (a ^ (uintptr_t)out) & 15u)
    return (int)cudaErrorMisalignedAddress;
  if (HW <= 0) return (int)cudaGetLastError();
  const int lead = (int)(((16 - (a & 15u)) & 15u) / 4);
  const int head = lead < HW ? lead : HW;
  const long nv = (HW - head) / 4;
  const long n = nv + (HW - 4 * nv);   // vectors, then the edge cells
  tsim::select_rows_kernel<<<blocks_for(n), THREADS, 0,
                             (cudaStream_t)stream>>>(sdir4, dest, out, D4,
                                                     (long)HW, head, nv);
  return (int)cudaGetLastError();
}
