// K7: K1's decide + move over halo-tiled windows, one CTA per tile.
//
// Replaces pallas_engine.decide_move_tiled (its pallas_call over the
// [th + 2P, tw + 2P] windows, P = TILE_HALO = 16).  It computes what K1
// computes: the halo ring absorbs the window edge, whose reads see the
// same fills as the grid edge (decide_move.cuh), and one tick reaches at
// most 16 cells inward (1 for the decide phase, 3 per sub-round: a
// mover's key depends on its target's occupancy, and a cell's commit
// reads keys two cells away), so every interior cell is exact.
//
// Bound on the H100: device-memory bytes.  Each tile copies its window
// of the 16 input planes (the halo re-reads (th + 2P)(tw + 2P) / (th tw)
// of the grid) and runs the 2K + 2 phases over a [20, window] scratch
// in device memory; only the interior is written out.  Design (simple
// first): the CTA copies its window, with JAX's pad fills outside the
// grid, into its own window planes in device memory, then runs
// decide_move.cuh's phase bodies (decide, K x (intent, commit), finish)
// over the window's cells in a block-stride loop, with __syncthreads()
// between phases where K1 needs one launch per phase.  The destination
// row select reads the whole grid's packed stack at the cell's global
// coordinate (ND_NONE outside the grid), so no [D4, window] slab is
// copied.  The window planes and the scratch stay in device memory: the
// 20 int32 scratch planes of even a 48 x 64 window (245 KB) exceed the
// 227 KB of shared memory a block may use; moving the window on chip is
// later speed work.
#include "decide_move.cuh"

namespace tsim {

constexpr int TILED_THREADS = 512;
// a tile's window planes: 12 of 4 bytes (wnd, pa..pe, pl, dest_id,
// r_mal, r_side, r_reroll, r_prio), 4 of 1 byte (stop, rain, ped, inter)
enum { W_WND, W_PA, W_PB, W_PC, W_PD, W_PE, W_PL, W_DEST, W_RMAL, W_RSIDE,
       W_REROLL, W_RPRIO, N_WIN32 };
enum { W_STOP, W_RAIN, W_PED, W_INTER, N_WIN8 };

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

__global__ void __launch_bounds__(TILED_THREADS)
dm_tiled(DMParams gp, Inputs g, int* __restrict__ win32,
         uint8_t* __restrict__ win8, int* __restrict__ scratch,
         Outputs out, int th, int tw, int P, int ntx) {
  const int t = blockIdx.x;
  const int oy = (t / ntx) * th - P, ox = (t % ntx) * tw - P;
  const int wh = th + 2 * P, ww = tw + 2 * P, whw = wh * ww;
  const long n = whw;
  int* w32 = win32 + (long)t * N_WIN32 * n;
  uint8_t* w8 = win8 + (long)t * N_WIN8 * n;
  int* S = scratch + (long)t * N_SCRATCH * n;
  const int tid = threadIdx.x, nth = blockDim.x;

  // the window, with the pad fills outside the grid: nothing present,
  // stop 1, no destination, draws that never fire
  for (int c = tid; c < whw; c += nth) {
    const int gy = c / ww + oy, gx = c % ww + ox;
    const bool in = gy >= 0 && gy < gp.H && gx >= 0 && gx < gp.W;
    const long q = in ? (long)gy * gp.W + gx : 0;
    w32[W_WND * n + c] = in ? g.wnd[q] : (int)ND_NONE4;
    w32[W_PA * n + c] = in ? g.pa[q] : 0;
    w32[W_PB * n + c] = in ? g.pb[q] : 0;
    w32[W_PC * n + c] = in ? g.pc[q] : 0;
    w32[W_PD * n + c] = in ? g.pd[q] : 0;
    w32[W_PE * n + c] = in ? g.pe[q] : 0;
    w32[W_PL * n + c] = __float_as_int(in ? g.pl[q] : 0.0f);
    w32[W_DEST * n + c] = in ? g.dest_id[q] : -1;
    w32[W_RMAL * n + c] = __float_as_int(in ? g.r_mal[q] : 1.0f);
    w32[W_RSIDE * n + c] = __float_as_int(in ? g.r_side[q] : 1.0f);
    w32[W_REROLL * n + c] = in ? g.r_reroll[q] : 1;
    w32[W_RPRIO * n + c] = in ? g.r_prio[q] : 0;
    w8[W_STOP * n + c] = in ? g.stop[q] : 1;
    w8[W_RAIN * n + c] = in ? g.rain[q] : 0;
    w8[W_PED * n + c] = in ? g.ped[q] : 0;
    w8[W_INTER * n + c] = in ? g.inter[q] : 0;
  }
  __syncthreads();

  const Inputs w{nullptr,
                 w32 + W_WND * n,
                 w32 + W_PA * n,
                 w32 + W_PB * n,
                 w32 + W_PC * n,
                 w32 + W_PD * n,
                 w32 + W_PE * n,
                 reinterpret_cast<const float*>(w32 + W_PL * n),
                 w8 + W_STOP * n,
                 w8 + W_RAIN * n,
                 w8 + W_PED * n,
                 w8 + W_INTER * n,
                 w32 + W_DEST * n,
                 reinterpret_cast<const float*>(w32 + W_RMAL * n),
                 reinterpret_cast<const float*>(w32 + W_RSIDE * n),
                 w32 + W_REROLL * n,
                 w32 + W_RPRIO * n};
  DMParams p = gp;
  p.H = wh;
  p.W = ww;
  const WindowSelect sel{g.sdir4, gp.D4, gp.H, gp.W, oy, ox};

  for (int c = tid; c < whw; c += nth)
    dm_decide_cell(p, w, S, c, w.r_mal[c], w.r_side[c], w.r_reroll[c], sel);
  __syncthreads();
  int set = 0;
  for (int r = 0; r < p.max_speed; ++r) {
    for (int c = tid; c < whw; c += nth)
      dm_intent_cell(p, w, S, set, c, w.r_prio[c], sel);
    __syncthreads();
    for (int c = tid; c < whw; c += nth) dm_commit_cell(p, S, set, c);
    __syncthreads();
    set ^= 1;
  }
  // the interior only: window cell c is grid cell gq, so the outputs
  // are addressed at offset gq - c
  for (int i = tid; i < th * tw; i += nth) {
    const int iy = i / tw, ix = i % tw;
    const int c = (iy + P) * ww + ix + P;
    const long gq = (long)(oy + P + iy) * gp.W + (ox + P + ix);
    out.flags[gq] = dm_finish_cell(p, w, S, set, c, out, gq - c);
  }
}

}  // namespace tsim

extern "C" int tsim_decide_tiled(
    const int* ip, const float* fp, const int* sdir4, int D4, const int* wnd,
    const int* pa, const int* pb, const int* pc, const int* pd, const int* pe,
    const float* pl, const uint8_t* stop, const uint8_t* rain,
    const uint8_t* ped, const uint8_t* inter, const int* dest_id,
    const float* r_mal, const float* r_side, const int* r_reroll,
    const int* r_prio, int* opa, int* opb, int* opc, int* opd, int* ope,
    float* opl, int* flags, int* win32, uint8_t* win8, int* scratch, int H,
    int W, int th, int tw, int P, void* stream) {
  using namespace tsim;
  const DMParams p = dm_params(ip, fp, H, W, D4);
  const Inputs in{sdir4, wnd, pa, pb, pc, pd, pe, pl, stop, rain, ped,
                  inter, dest_id, r_mal, r_side, r_reroll, r_prio};
  const Outputs out{opa, opb, opc, opd, ope, opl, flags};
  const int ntx = W / tw, T = (H / th) * ntx;
  dm_tiled<<<T, TILED_THREADS, 0, (cudaStream_t)stream>>>(
      p, in, win32, win8, scratch, out, th, tw, P, ntx);
  return (int)cudaGetLastError();
}
