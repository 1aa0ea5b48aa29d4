// K7: K1's decide + move over halo-tiled windows, one block per tile.
//
// Replaces pallas_engine.decide_move_tiled (its pallas_call over the
// [th + 2P, tw + 2P] windows, P = TILE_HALO = 16).  It computes what K1
// computes: the halo ring absorbs the window edge, whose reads see the
// same fills as the grid edge (decide_move.cuh), and one tick reaches at
// most 16 cells inward (1 for the decide phase, 3 per sub-round: a
// mover's key depends on its target's occupancy, and a cell's commit
// reads keys two cells away), so every interior cell is exact.
//
// Bound on the H100: the function's device-memory bytes, K1's (~80 B a
// cell); the windows re-read (th + 2P)(tw + 2P) / (th tw) of the grid.
// Like K1, a call stays far from that bound: each window is a chain of
// 2K + 2 dependent phases, each a scan of the window's cells between
// block barriers.  Design: a window is a small world, so K7 is K1's
// block-per-world form over the windows.  One ordinary launch of one
// block per tile; block t copies its window's 16 input planes, with
// JAX's pad fills outside the grid (what K1 reads at a grid edge), into
// device memory, then runs coop.cuh's phases over the window as world 0
// (`coop_phases` with `BlockOwn`: 32 x 8 tiles, state words, work
// lists, keys and pub bytes in shared memory, the vehicle working set in
// device memory) and `coop_finish` on the interior cells alone.  The row
// select reads the whole grid's packed stack at the cell's global
// coordinate (ND_NONE outside the grid), so no [D4, window] slab is
// copied.  A window must fit one block: at most MAX_CPT tiles and the
// block's shared memory (`hopper_engine.k7_plan`); a larger one fails,
// it never runs in another form.

#include "common.cuh"

namespace tsim {

#ifdef TSIM_K7_MARKS
// the phase timeline of tools/k1_phase_times.py --k7, as K1's
// (decide_move.cu): thread 0 of block 0 reads the global timer once its
// block has finished mark i's pass; k7_marks[42] is block 0's start,
// k7_marks[41] the last block's end
__device__ unsigned long long k7_marks[64];
__device__ __forceinline__ unsigned long long k7_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define K7_MARK(i)                                                   \
  do {                                                               \
    __syncthreads();                                                 \
    if (blockIdx.x == 0 && threadIdx.x == 0) k7_marks[i] = k7_now(); \
  } while (0)
#else
#define K7_MARK(i) \
  do {             \
  } while (0)
#endif

}  // namespace tsim

// the phases read the window planes this launch writes: plain loads
#define TSIM_COHERENT_LOADS
#define COOP_MARK(i, code) K7_MARK(i)
#include "coop.cuh"

namespace tsim {

// a window's input planes in device memory: 12 of 4 bytes, then 4 of 1
// byte (one word a cell together), then the working set (N_WORK planes)
enum { X_WND, X_PA, X_PB, X_PC, X_PD, X_PE, X_PL, X_DEST, X_RMAL, X_RSIDE,
       X_REROLL, X_RPRIO, N_WIN32 };
enum { X_STOP, X_RAIN, X_PED, X_INTER };
constexpr int WIN_WORDS = N_WIN32 + 1 + N_WORK;

// threads a block: a block runs alone on its SM (a window's shared
// memory, and 16 to 128 windows at the headline's tilings), and each
// phase is a scan of the window's cells whose steps wait on memory, so
// the block brings as many warps as an SM's registers hold (64 a thread)
constexpr int K7_THREADS = 1024;

// the select of a window: row `dest` of the whole grid's stack at the
// window cell's global coordinate, ND_NONE outside the grid (JAX pads
// the stack with ND_NONE4)
struct WindowSelect {
  const int* sdir4;
  int D4, H, W, oy, ox;
  __device__ __forceinline__ int operator()(const DMParams&, const Inputs&,
                                            int dest, int, int y,
                                            int x) const {
    const int gy = y + oy, gx = x + ox;
    if (gy < 0 || gy >= H || gx < 0 || gx >= W) return 7;
    return select_nd(sdir4, D4, H * W, dest, gy * W + gx);
  }
};

// One tick over the [th, tw] tiles of an H x W grid (`gp`), block t
// owning tile t's window of (th + 2P) x (tw + 2P) cells in `cpt` tiles
// of 32 x 8.  `area`: WIN_WORDS words a window cell.  Dynamic shared
// memory (`world_smem`): the state words and the work list, then the
// window's keys and pub bytes.
__global__ void __launch_bounds__(K7_THREADS)
    dm_tiled(DMParams gp, Inputs g, int* __restrict__ area, Outputs out,
             int th, int tw, int P, int ntx, int cpt) {
  extern __shared__ uint32_t st[];
  __shared__ TileOrigin org[MAX_CPT];
  __shared__ int nlist;
  const int t = blockIdx.x, tid = threadIdx.x;
  const int oy = (t / ntx) * th - P, ox = (t % ntx) * tw - P;
  const int wh = th + 2 * P, ww = tw + 2 * P, whw = wh * ww;
  const long n = whw;
  int* w32 = area + (long)t * WIN_WORDS * n;
  uint8_t* w8 = (uint8_t*)(w32 + N_WIN32 * n);
  K7_MARK(42);

  // the window, with the pad fills outside the grid: nothing present,
  // stop 1, no destination, draws that never fire (the grid's planes
  // through the read-only path: this launch never writes them)
  for (int c = tid; c < whw; c += K7_THREADS) {
    const int gy = c / ww + oy, gx = c % ww + ox;
    const bool in = gy >= 0 && gy < gp.H && gx >= 0 && gx < gp.W;
    const long q = in ? (long)gy * gp.W + gx : 0;
    w32[X_WND * n + c] = in ? __ldg(g.wnd + q) : (int)ND_NONE4;
    w32[X_PA * n + c] = in ? __ldg(g.pa + q) : 0;
    w32[X_PB * n + c] = in ? __ldg(g.pb + q) : 0;
    w32[X_PC * n + c] = in ? __ldg(g.pc + q) : 0;
    w32[X_PD * n + c] = in ? __ldg(g.pd + q) : 0;
    w32[X_PE * n + c] = in ? __ldg(g.pe + q) : 0;
    w32[X_PL * n + c] = __float_as_int(in ? __ldg(g.pl + q) : 0.0f);
    w32[X_DEST * n + c] = in ? __ldg(g.dest_id + q) : -1;
    w32[X_RMAL * n + c] = __float_as_int(in ? __ldg(g.r_mal + q) : 1.0f);
    w32[X_RSIDE * n + c] = __float_as_int(in ? __ldg(g.r_side + q) : 1.0f);
    w32[X_REROLL * n + c] = in ? __ldg(g.r_reroll + q) : 1;
    w32[X_RPRIO * n + c] = in ? __ldg(g.r_prio + q) : 0;
    w8[X_STOP * n + c] = in ? __ldg(g.stop + q) : 1;
    w8[X_RAIN * n + c] = in ? __ldg(g.rain + q) : 0;
    w8[X_PED * n + c] = in ? __ldg(g.ped + q) : 0;
    w8[X_INTER * n + c] = in ? __ldg(g.inter + q) : 0;
  }

  const Inputs w{nullptr,
                 w32 + X_WND * n,
                 w32 + X_PA * n,
                 w32 + X_PB * n,
                 w32 + X_PC * n,
                 w32 + X_PD * n,
                 w32 + X_PE * n,
                 reinterpret_cast<const float*>(w32 + X_PL * n),
                 w8 + X_STOP * n,
                 w8 + X_RAIN * n,
                 w8 + X_PED * n,
                 w8 + X_INTER * n,
                 w32 + X_DEST * n,
                 reinterpret_cast<const float*>(w32 + X_RMAL * n),
                 reinterpret_cast<const float*>(w32 + X_RSIDE * n),
                 w32 + X_REROLL * n,
                 w32 + X_RPRIO * n};
  DMParams p = gp;
  p.H = wh;
  p.W = ww;
  const WindowSelect sel{g.sdir4, gp.D4, gp.H, gp.W, oy, ox};
  int* list = (int*)(st + cpt * THREADS);
  int* key = list + cpt * THREADS;
  const BlockOwn own{w32 + (N_WIN32 + 1) * n, key, (uint8_t*)(key + whw)};
  world_tiles(p, cpt, org);
  // coop_phases begins with a block barrier: the window and `org` are
  // in place before its first phase
  coop_phases<WindowSelect, PlaneDraws, true, BlockOwn, K7_THREADS>(
      p, w, own, cpt, org, st, list, nlist, sel, PlaneDraws());
  __syncthreads();
  // the interior only: window cell c is grid cell gq, so the outputs
  // are addressed at offset gq - c
  for (int q = tid; q < cpt * THREADS; q += K7_THREADS) {
    int b, c, y, x;
    if (!slot_cell(p, org, q, b, c, y, x)) continue;
    if (y < P || y >= P + th || x < P || x >= P + tw) continue;
    const long gq = (long)(oy + y) * gp.W + (ox + x);
    out.flags[gq] =
        coop_finish(p, w, own.work(p, 0), c, y, x, st[q], out, gq - c, sel);
  }
#ifdef TSIM_K7_MARKS
  K7_MARK(40);
  if (threadIdx.x == 0) atomicMax(&k7_marks[41], k7_now());
#endif
}

// the window's tiles a block and dynamic shared memory; an error past
// one block's tiles (the shared memory the launch checks)
inline cudaError_t tiled_shape(int th, int tw, int P, int* cpt,
                               size_t* smem) {
  const int wh = th + 2 * P, ww = tw + 2 * P;
  *cpt = world_cpt(wh, ww);
  if (th < 1 || tw < 1 || *cpt > MAX_CPT) return cudaErrorInvalidValue;
  *smem = world_smem(*cpt, (long)wh * ww);
  return cudaSuccess;
}

// opts dm_tiled in to `smem` bytes of dynamic shared memory (once a
// device for the largest asked)
inline cudaError_t tiled_smem(size_t smem) {
  static size_t attr[8];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 8 && attr[dev] >= smem)) return e;
  e = cudaFuncSetAttribute(dm_tiled,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess && dev < 8) attr[dev] = smem;
  return e;
}

}  // namespace tsim

#ifdef TSIM_K7_MARKS
// copies the marks of the last call to `out` [64] and clears them
extern "C" int tsim_k7_marks(unsigned long long* out) {
  const size_t n = sizeof(tsim::k7_marks);
  cudaError_t e = cudaMemcpyFromSymbol(out, tsim::k7_marks, n);
  if (e != cudaSuccess) return (int)e;
  static const unsigned long long zero[64] = {};
  return (int)cudaMemcpyToSymbol(tsim::k7_marks, zero, n);
}
#endif

extern "C" int tsim_decide_tiled(
    const int* ip, const float* fp, const int* sdir4, int D4, const int* wnd,
    const int* pa, const int* pb, const int* pc, const int* pd, const int* pe,
    const float* pl, const uint8_t* stop, const uint8_t* rain,
    const uint8_t* ped, const uint8_t* inter, const int* dest_id,
    const float* r_mal, const float* r_side, const int* r_reroll,
    const int* r_prio, int* opa, int* opb, int* opc, int* opd, int* ope,
    float* opl, int* flags, int* area, int H, int W, int th, int tw, int P,
    void* stream) {
  using namespace tsim;
  int cpt = 0;
  size_t smem = 0;
  cudaError_t e = tiled_shape(th, tw, P, &cpt, &smem);
  if (e == cudaSuccess) e = tiled_smem(smem);
  if (e != cudaSuccess) return (int)e;
  const DMParams p = dm_params(ip, fp, H, W, D4);
  const Inputs in{sdir4, wnd, pa, pb, pc, pd, pe, pl, stop, rain, ped,
                  inter, dest_id, r_mal, r_side, r_reroll, r_prio};
  const Outputs out{opa, opb, opc, opd, ope, opl, flags};
  const int ntx = W / tw, T = (H / th) * ntx;
  dm_tiled<<<T, K7_THREADS, smem, (cudaStream_t)stream>>>(
      p, in, area, out, th, tw, P, ntx, cpt);
  return (int)cudaGetLastError();
}

// K7's plan for [th, tw] tiles with a halo of P on the current card:
// out = {tiles a block, dynamic shared memory bytes, static shared
// memory bytes, registers a thread, resident blocks an SM}
extern "C" int tsim_decide_tiled_plan(int th, int tw, int P, int* out) {
  using namespace tsim;
  int cpt = 0;
  size_t smem = 0;
  cudaError_t e = tiled_shape(th, tw, P, &cpt, &smem);
  if (e == cudaSuccess) e = tiled_smem(smem);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, dm_tiled);
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dm_tiled,
                                                      K7_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = cpt;
  out[1] = (int)smem;
  out[2] = (int)fa.sharedSizeBytes;
  out[3] = fa.numRegs;
  out[4] = per_sm;
  return 0;
}
