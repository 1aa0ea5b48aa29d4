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
// gather; at D4 = 108 and 1024^2 that is 453 MB per call.  Here each
// thread owns one cell and makes one gathered 4-byte load from the plane
// its dest names, so a call moves 12 B per cell (dest in, one word, nd
// out): 12.6 MB at 1024^2, 3.8 us at 3.35 TB/s.  The gathered loads of
// neighbouring threads hit different planes and do not coalesce; that,
// not arithmetic, is what bounds it on the card.
#include "common.cuh"

namespace tsim {

__global__ void select_rows_kernel(const int32_t* __restrict__ sdir4,
                                   const int32_t* __restrict__ dest,
                                   int32_t* __restrict__ out, int D4,
                                   long HW) {
  const long c = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= HW) return;
  const int d = __ldg(dest + c);
  const int hi = d >> 2;
  const uint32_t w = (hi >= 0 && hi < D4)
                         ? (uint32_t)__ldg(sdir4 + (long)hi * HW + c)
                         : ND_NONE4;
  out[c] = (int32_t)((w >> ((d & 3) * 8)) & 0xFFu);
}

}  // namespace tsim

extern "C" int tsim_select_rows(const int32_t* sdir4, const int32_t* dest,
                                int32_t* out, int D4, int HW, void* stream) {
  using namespace tsim;
  if (HW > 0)
    tsim::select_rows_kernel<<<blocks_for(HW), THREADS, 0,
                               (cudaStream_t)stream>>>(sdir4, dest, out, D4,
                                                       (long)HW);
  return (int)cudaGetLastError();
}
