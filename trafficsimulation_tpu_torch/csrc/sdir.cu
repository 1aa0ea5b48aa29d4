// K2: per-destination next-move bytes, four destinations packed per
// int32 word.
//
// Replaces pallas_engine.build_sdir_pallas (_sdir_kernel, _sdir_body).
// Per (destination d, cell c): key[m] = K0[d, m, c] + (pen[m] << 2);
// the min over m carries the argmin in its low 2 bits; the contra bit
// says the chosen move is not legal flow here; bit 4 + h says heading h
// may continue straight within 2 * TURN_PENALTY of the best; 7 when the
// best is unreachable (>= KBIG).  Rows past D decode to 7.
//
// Bound by device-memory bytes: K0 is read once, coalesced along W (one
// thread per cell), the packed stack written once.  Each thread walks a
// run of WORDS_PER_THREAD packed words with pen / legal in registers.
#include "common.cuh"

namespace tsim {

constexpr int WORDS_PER_THREAD = 8;

__global__ void sdir_kernel(const int* __restrict__ k0,
                            const int* __restrict__ pen4,
                            const int* __restrict__ legal4,
                            int* __restrict__ out, int D, int HW, int tp2) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= HW) return;
  const int D4 = (D + 3) / 4;
  const int g0 = blockIdx.y * WORDS_PER_THREAD;
  const int g1 = min(g0 + WORDS_PER_THREAD, D4);
  int pshift[4], hbit[4];
  uint32_t lp = 0;
  for (int m = 0; m < 4; ++m) {
    const bool legal = legal4[(long)m * HW + c] != 0;
    pshift[m] = pen4[(long)m * HW + c] << 2;
    hbit[m] = legal ? (1 << (4 + m)) : 0;
    lp |= (uint32_t)legal << m;
  }
  for (int g = g0; g < g1; ++g) {
    uint32_t word = 0;
    for (int k = 0; k < 4; ++k) {
      const int d = 4 * g + k;
      uint32_t enc = 7u;
      if (d < D) {
        int key[4];
        for (int m = 0; m < 4; ++m)
          key[m] = k0[((long)d * 4 + m) * HW + c] + pshift[m];
        const int bk = min(min(key[0], key[1]), min(key[2], key[3]));
        const int best = bk >> 2;
        const int mstar = bk & 3;
        const uint32_t contra = ((lp >> mstar) & 1u) ^ 1u;
        enc = (uint32_t)mstar | (contra << 3);
        const int bnd2 = (min(best + tp2, KBIG - 1) << 2) | 3;
        for (int h = 0; h < 4; ++h)
          if (key[h] <= bnd2) enc |= (uint32_t)hbit[h];
        if (best >= KBIG) enc = 7u;
      }
      word |= enc << (8 * k);
    }
    out[(long)g * HW + c] = (int)word;
  }
}

}  // namespace tsim

extern "C" int tsim_build_sdir(const int* k0, const int* pen4,
                               const int* legal4, int* out, int D, int HW,
                               int tp2, void* stream) {
  using namespace tsim;
  const int D4 = (D + 3) / 4;
  dim3 grid(blocks_for(HW), (D4 + WORDS_PER_THREAD - 1) / WORDS_PER_THREAD);
  sdir_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(k0, pen4, legal4,
                                                          out, D, HW, tp2);
  return (int)cudaGetLastError();
}
