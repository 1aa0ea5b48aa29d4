// K2 and K5: per-destination next-move bytes, four destinations packed
// per int32 word.
//
// Replaces pallas_engine.build_sdir_pallas (_sdir_kernel, _sdir_body).
// Per (destination d, cell c): key[m] = K0[d, m, c] + (pen[m] << 2);
// the min over m carries the argmin in its low 2 bits; the contra bit
// says the chosen move is not legal flow here; bit 4 + h says heading h
// may continue straight within 2 * TURN_PENALTY of the best; 7 when the
// best is unreachable (>= KBIG).  Rows past D decode to 7.
//
// K2 (one world) is bound by device-memory bytes: K0 is read once,
// coalesced along W (one thread per cell), the packed stack written once.
// Each thread walks a run of WORDS_PER_THREAD packed words with pen /
// legal in registers.
//
// K5 (replaces pallas_engine.build_sdir_pallas_batched,
// _sdir_kernel_batched) encodes the same stack for B worlds that share
// K0 and legal4 and differ in pen4b [B, 4, H, W].  Each thread loads a
// cell's four candidate keys of a destination row once and encodes that
// row for NB worlds whose pen << 2 it holds in registers (4 NB of them),
// so K0 is read from device memory once per launch for up to NB = 16
// worlds (gridDim.z covers larger batches in groups of NB).  With K0
// read once the batch's output bytes dominate; the integer work (about
// 25 operations per key and world) is the other limit.
#include "common.cuh"

namespace tsim {

constexpr int WORDS_PER_THREAD = 8;

// the encode of one destination row for one world (_sdir_body): key[m]
// = K0[d, m, c] + (pen[m] << 2); lp = the legal bits; hbit[h] = the
// straight bit of heading h where legal
__device__ __forceinline__ uint32_t sdir_enc(const int* k, const int* ps,
                                             uint32_t lp, const int* hbit,
                                             int tp2) {
  int key[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) key[m] = k[m] + ps[m];
  const int bk = min(min(key[0], key[1]), min(key[2], key[3]));
  const int best = bk >> 2;
  const int mstar = bk & 3;
  const uint32_t contra = ((lp >> mstar) & 1u) ^ 1u;
  uint32_t enc = (uint32_t)mstar | (contra << 3);
  const int bnd2 = (min(best + tp2, KBIG - 1) << 2) | 3;
#pragma unroll
  for (int h = 0; h < 4; ++h)
    if (key[h] <= bnd2) enc |= (uint32_t)hbit[h];
  return best >= KBIG ? 7u : enc;
}

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
        for (int m = 0; m < 4; ++m) key[m] = k0[((long)d * 4 + m) * HW + c];
        enc = sdir_enc(key, pshift, lp, hbit, tp2);
      }
      word |= enc << (8 * k);
    }
    out[(long)g * HW + c] = (int)word;
  }
}

// K5: worlds b0 .. b0 + NB - 1 of the batch (b0 = blockIdx.z * NB); out
// is [B, ceil(D/4), H, W]
template <int NB>
__global__ void sdir_batched_kernel(const int* __restrict__ k0,
                                    const int* __restrict__ pen4b,
                                    const int* __restrict__ legal4,
                                    int* __restrict__ out, int D, int HW,
                                    int tp2, int B) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= HW) return;
  const int D4 = (D + 3) / 4;
  const int g0 = blockIdx.y * WORDS_PER_THREAD;
  const int g1 = min(g0 + WORDS_PER_THREAD, D4);
  const int b0 = blockIdx.z * NB;
  const int nb = min(NB, B - b0);
  int hbit[4];
  uint32_t lp = 0;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const bool legal = legal4[(long)m * HW + c] != 0;
    hbit[m] = legal ? (1 << (4 + m)) : 0;
    lp |= (uint32_t)legal << m;
  }
  int pshift[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int m = 0; m < 4; ++m)
      pshift[j][m] =
          j < nb ? pen4b[((long)(b0 + j) * 4 + m) * HW + c] << 2 : 0;
  for (int g = g0; g < g1; ++g) {
    uint32_t word[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) word[j] = 0;
    for (int k = 0; k < 4; ++k) {
      const int d = 4 * g + k;
      if (d < D) {
        int key[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) key[m] = k0[((long)d * 4 + m) * HW + c];
#pragma unroll
        for (int j = 0; j < NB; ++j)
          word[j] |= sdir_enc(key, pshift[j], lp, hbit, tp2) << (8 * k);
      } else {
#pragma unroll
        for (int j = 0; j < NB; ++j) word[j] |= 7u << (8 * k);
      }
    }
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (j < nb) out[((long)(b0 + j) * D4 + g) * HW + c] = (int)word[j];
  }
}

template <int NB>
void launch_sdir_batched(const int* k0, const int* pen4b, const int* legal4,
                         int* out, int D, int HW, int tp2, int B,
                         cudaStream_t s) {
  const int D4 = (D + 3) / 4;
  const dim3 grid(blocks_for(HW),
                  (D4 + WORDS_PER_THREAD - 1) / WORDS_PER_THREAD,
                  (B + NB - 1) / NB);
  sdir_batched_kernel<NB><<<grid, THREADS, 0, s>>>(k0, pen4b, legal4, out, D,
                                                   HW, tp2, B);
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

extern "C" int tsim_build_sdir_batched(const int* k0, const int* pen4b,
                                       const int* legal4, int* out, int D,
                                       int HW, int tp2, int B,
                                       void* stream) {
  using namespace tsim;
  cudaStream_t s = (cudaStream_t)stream;
  // the smallest register group that holds the batch (16 at most)
  if (B <= 1)
    launch_sdir_batched<1>(k0, pen4b, legal4, out, D, HW, tp2, B, s);
  else if (B <= 2)
    launch_sdir_batched<2>(k0, pen4b, legal4, out, D, HW, tp2, B, s);
  else if (B <= 4)
    launch_sdir_batched<4>(k0, pen4b, legal4, out, D, HW, tp2, B, s);
  else if (B <= 8)
    launch_sdir_batched<8>(k0, pen4b, legal4, out, D, HW, tp2, B, s);
  else
    launch_sdir_batched<16>(k0, pen4b, legal4, out, D, HW, tp2, B, s);
  return (int)cudaGetLastError();
}
