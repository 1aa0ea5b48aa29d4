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
// K0 and legal4 and differ in pen4b [B, 4, H, W].  K0 leaves device
// memory once per launch for up to 16 worlds (gridDim.z covers larger
// batches in groups of 16); with it read once, K5's floor is the integer
// work (about 16 operations per key row, cell and world, 11 of them
// compares, mins, selects and byte ops that only the ALU pipe runs),
// with the bytes (K0 in, B packed stacks out) close behind.
// Design (sdir_batched_kernel):
//  - a block owns CW cells and a run of packed words; its threads are G
//    groups of CW, each group NB worlds (NB <= 4, so a thread keeps 16
//    pen << 2 values, not 64);
//  - the block stages each word's 16 key rows (4 destinations x 4 moves)
//    of its cells into a shared-memory ring with cp.async, S - 1 words
//    ahead of use, so the K0 stream runs under the integer work; all G
//    groups read the staged rows;
//  - per cell, hoisted out of the row loop: a byte table whose byte m is
//    m | contra(m) << 3 and the four straight bits where legal;
//  - per key row and world (sdir_enc_dpx): four adds, the min of four
//    (DPX vimin3, then min), the argmin and its contra bit in one
//    prmt.rc8 of the table, the straight bound with one DPX viaddmin,
//    four compares with a predicated or each into the straight bits,
//    the unreachable select; four bytes packed into a word with three
//    byte_perms.
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

// ---- K5 ---------------------------------------------------------------

constexpr int K5_THREADS = 256;
constexpr int K5_WORDS = 40;           // packed words a block walks, at most
constexpr int K5_ROWS = 16;            // key rows of one packed word
constexpr int K5_SMEM = 48 * 1024;     // the ring's bytes, at most
// ((KBIG - 1) << 2) | 3: the straight bound's cap
constexpr int K5_CAP = ((KBIG - 1) << 2) | 3;

// the byte of `tbl` that c[1:0] selects, in all four bytes
__device__ __forceinline__ uint32_t prmt_rc8(uint32_t tbl, uint32_t c) {
  uint32_t d;
  asm("prmt.b32.rc8 %0, %1, %2, %3;" : "=r"(d) : "r"(tbl), "r"(0u), "r"(c));
  return d;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// the encode of one key row for one world: kv the row's four K0 keys,
// ps the world's pen << 2, tbl the cell's byte table (byte m = m |
// contra(m) << 3), hb the straight bits where legal, tp4 = tp2 << 2.
// (best + tp2) << 2 | 3 = (bk | 3) + tp4, so the bound is one viaddmin;
// exact while bk + tp4 fits in an int32 (keys stay below 2^22).  Only
// byte 0 of the result counts.
__device__ __forceinline__ uint32_t sdir_enc_dpx(const int* kv, const int* ps,
                                                 uint32_t tbl,
                                                 const uint32_t* hb,
                                                 int tp4) {
  int key[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) key[m] = kv[m] + ps[m];
  const int bk = min(__vimin3_s32(key[0], key[1], key[2]), key[3]);
  uint32_t e = prmt_rc8(tbl, (uint32_t)bk);
  const int bnd = __viaddmin_s32(bk | 3, tp4, K5_CAP);
  // a compare and a predicated or per heading (in C++, nvcc selects the
  // bit and ors pairs: 2.5 ALU ops a heading instead of 2)
#pragma unroll
  for (int h = 0; h < 4; ++h)
    asm("{ .reg .pred p; setp.le.s32 p, %1, %2; @p or.b32 %0, %0, %3; }"
        : "+r"(e)
        : "r"(key[h]), "r"(bnd), "r"(hb[h]));
  return bk >= (KBIG << 2) ? 7u : e;
}

// byte 0 of e0 .. e3 packed into one word, e0 lowest
__device__ __forceinline__ uint32_t pack4(const uint32_t* e) {
  return __byte_perm(__byte_perm(e[0], e[1], 0x0040),
                     __byte_perm(e[2], e[3], 0x0040), 0x5410);
}

// K5: a block owns cells [blockIdx.x * CW, + CW), packed words [blockIdx.y
// * wpb, + wpb) and worlds [blockIdx.z * G * NB, + G * NB); thread group
// threadIdx.x / CW takes NB of those worlds.  out is [B, ceil(D/4), H, W].
template <int NB, int G>
__global__ void __launch_bounds__(K5_THREADS)
    sdir_batched_kernel(const int* __restrict__ k0,
                        const int* __restrict__ pen4b,
                        const int* __restrict__ legal4,
                        int* __restrict__ out, int D, int HW, int tp2, int B,
                        int wpb) {
  constexpr int CW = K5_THREADS / G;
  constexpr int S = K5_SMEM / (K5_ROWS * CW * 4) < 8
                        ? K5_SMEM / (K5_ROWS * CW * 4)
                        : 8;
  static_assert(S >= 2, "the ring needs two stages");
  __shared__ __align__(16) int ring[S][K5_ROWS][CW];
  const int tid = threadIdx.x, lc = tid % CW, grp = tid / CW;
  const int c0 = blockIdx.x * CW, c = c0 + lc;
  const int D4 = (D + 3) / 4;
  const int g0 = blockIdx.y * wpb;
  const int nw = min(g0 + wpb, D4) - g0;
  const int b0 = blockIdx.z * (G * NB) + grp * NB;
  // 16-byte copies where every row of K0 starts on a 16-byte boundary
  const bool vec = (HW & 3) == 0 && ((uintptr_t)k0 & 15) == 0;

  // word g0 + w's key rows of the block's cells into its ring slot; rows
  // past D and cells past HW are not loaded (never used)
  auto load = [&](int w) {
    const int g = g0 + w;
    for (int q = tid; q < K5_ROWS * CW / 4; q += K5_THREADS) {
      const int row = q / (CW / 4), col = (q % (CW / 4)) * 4;
      const int d = 4 * g + (row >> 2), cc = c0 + col;
      if (d >= D || cc >= HW) continue;
      int* dst = &ring[w % S][row][col];
      const int* src = k0 + ((long)d * 4 + (row & 3)) * HW + cc;
      if (vec && cc + 4 <= HW) {
        cp_async16(dst, src);
      } else {
        for (int e = 0; e < 4 && cc + e < HW; ++e) cp_async4(dst + e, src + e);
      }
    }
  };

  // per cell: the byte table, the straight bits where legal, the worlds'
  // pen << 2
  uint32_t tbl = 0, hb[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const bool legal = c < HW && legal4[(long)m * HW + c] != 0;
    tbl |= (uint32_t)(m | (legal ? 0 : 8)) << (8 * m);
    hb[m] = legal ? 1u << (4 + m) : 0u;
  }
  int ps[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int m = 0; m < 4; ++m)
      ps[j][m] = (c < HW && b0 + j < B)
                     ? pen4b[((long)(b0 + j) * 4 + m) * HW + c] << 2
                     : 0;
  const int tp4 = tp2 << 2;
  // the thread's first world's output at word g0, the stride between its
  // worlds' stacks, and how many of its worlds the batch holds
  int* op = out + ((long)b0 * D4 + g0) * HW + c;
  const long wstride = (long)D4 * HW;
  const int nbv = B - b0;

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nw) load(s);
    cp_async_commit();
  }
  for (int w = 0; w < nw; ++w) {
    cp_async_wait<S - 2>();
    __syncthreads();          // word w landed; slot (w - 1) % S is free
    if (w + S - 1 < nw) load(w + S - 1);
    cp_async_commit();
    const int g = g0 + w;
    uint32_t e[NB][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (4 * g + k < D) {
        int kv[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) kv[m] = ring[w % S][4 * k + m][lc];
#pragma unroll
        for (int j = 0; j < NB; ++j)
          e[j][k] = sdir_enc_dpx(kv, ps[j], tbl, hb, tp4);
      } else {
#pragma unroll
        for (int j = 0; j < NB; ++j) e[j][k] = 7u;
      }
    }
    if (c < HW) {
      int* o = op + (long)w * HW;
#pragma unroll
      for (int j = 0; j < NB; ++j, o += wstride)
        if (j < nbv) *o = (int)pack4(e[j]);
    }
  }
}

// the launch of K5's <NB, G> form: ceil(HW / CW) x (word runs) x (groups
// of G * NB worlds) blocks; the word runs split D4 evenly in runs of at most
// K5_WORDS
template <int NB, int G>
void launch_sdir_batched(const int* k0, const int* pen4b, const int* legal4,
                         int* out, int D, int HW, int tp2, int B,
                         cudaStream_t s) {
  constexpr int CW = K5_THREADS / G;
  const int D4 = (D + 3) / 4;
  const int runs = (D4 + K5_WORDS - 1) / K5_WORDS;
  const int wpb = (D4 + runs - 1) / runs;
  const dim3 grid((HW + CW - 1) / CW, (D4 + wpb - 1) / wpb,
                  (B + G * NB - 1) / (G * NB));
  sdir_batched_kernel<NB, G><<<grid, K5_THREADS, 0, s>>>(
      k0, pen4b, legal4, out, D, HW, tp2, B, wpb);
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
  if (D <= 0 || B <= 0 || HW <= 0) return 0;
  // worlds a thread, groups a block: the smallest that hold the batch
  // (16 worlds a block at most)
  if (B <= 1)
    launch_sdir_batched<1, 1>(k0, pen4b, legal4, out, D, HW, tp2, B, s);
  else if (B <= 2)
    launch_sdir_batched<2, 1>(k0, pen4b, legal4, out, D, HW, tp2, B, s);
  else if (B <= 4)
    launch_sdir_batched<4, 1>(k0, pen4b, legal4, out, D, HW, tp2, B, s);
  else if (B <= 8)
    launch_sdir_batched<4, 2>(k0, pen4b, legal4, out, D, HW, tp2, B, s);
  else
    launch_sdir_batched<4, 4>(k0, pen4b, legal4, out, D, HW, tp2, B, s);
  return (int)cudaGetLastError();
}
