// K1: the per-tick vehicle decide + move on the packed planes.
//
// Replaces pallas_engine.decide_move_pallas (_kernel -> decide_move_core).
// One cooperative launch per call for a whole batch of B worlds (B = 1
// is the single-world tick): a persistent grid of the card's resident
// blocks runs the phases decide, K x (intent, commit), finish (K =
// VEHICLE_MAX_SPEED sub-rounds), separated by grid-wide barriers.  Every
// per-world plane (the packed stack, wavefronts, vehicle planes, masks,
// random planes, outputs and K1's working planes) advances by one
// world's size per world; the geometry (intersection, dest_id) is shared
// by the batch or, for a batch of different cities (config #4), one
// plane a world (`DMParams::geo`).  Every neighbour index comes from
// `nbr` on the world's own (y, x), so no read crosses into another world.
// A batch with more tiles than one resident grid holds (at most
// MAX_CPT tiles a block: the state words and work list take 8 bytes of
// shared memory a cell) runs as world groups inside the one launch: the
// grid walks group after group, each with its own 2K barriers, and no
// barrier between groups, since a group reads and writes only its own
// worlds' planes.
//
// K1-hier (`tsim_decide_move_hier`) is the same launch for one world
// under hierarchical routing, the row select `HierSelect` in place of
// `GridSelect`: it replaces the plain decide core with the hierarchical
// select (K6 twice per select) that the JAX package runs for such worlds
// (trafficsimulation_tpu/ops/engine.py, the ROUTING_HIER branch of
// step_engine; select_rows_pallas for the selects).
//
// On the H100 the function is bound by device-memory bytes (~80 B a
// cell), the phase chain by its dependent steps and each phase by the
// latency of its dependent loads.  Design:
//  - one launch: the 2K + 2 phase launches became 2K grid barriers
//    (the finish reads only the block's own cells, so it needs none);
//  - fixed ownership: block j owns tiles j, j + grid, ... (32 x 8 cells,
//    `cpt` tiles a block) in every phase, so what only a cell itself
//    reads stays in a state word per cell in the block's shared memory:
//    the decide aux word, the halt latch, moved, occupied, new on the
//    cell, "never a target" (stopped, pedestrians or occupied at the
//    start of the tick), vacated, the intent it last published and the
//    key it takes in this sub-round;
//  - compacted work: each phase first walks all of the block's cells,
//    listing in shared memory the cells with work left (vehicles for
//    decide; vehicles new on their cell for intent, the only ones whose
//    intent can change other than by a halt; keys and arrivals for
//    commit), which the block's threads then share;
//  - one working set, written only where a vehicle is: decide writes the
//    planes (and the steps left) of the cells that hold a vehicle, a
//    commit those of the cells a vehicle moves into.  A vehicle's planes
//    are read only while it stands on them, and a cell is written only
//    while it is empty, so no sub-round reads what another writes.  A
//    cell that a vehicle leaves is written nowhere: its final planes are
//    zero.  A cell empty all tick is written nowhere either: the finish
//    computes its planes from the inputs.  Neighbours see each other
//    through one byte per cell (`pub`: the published key's direction,
//    want and contraflow bits, and "occupied by an arrival") and read a
//    key word only where that byte says a key aims at them.
// Each skip leaves every output bit as the phase bodies of
// decide_move.cuh compute it, which K7 still runs.  The phases live in
// coop.cuh, which K9 (megakernel.cu) shares.
#include <cooperative_groups.h>

#include "decide_move.cuh"

namespace cg = cooperative_groups;

namespace tsim {

#ifdef TSIM_K1_MARKS
// the phase timeline of tools/k1_phase_times.py: thread 0 of block 0
// reads the global timer once its block has finished mark i's pass;
// k1_marks[41] is the last block's end
__device__ unsigned long long k1_marks[64];
__device__ __forceinline__ unsigned long long k1_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define K1_MARK(i)                                                   \
  do {                                                               \
    __syncthreads();                                                 \
    if (blockIdx.x == 0 && threadIdx.x == 0) k1_marks[i] = k1_now(); \
  } while (0)
#else
#define K1_MARK(i) \
  do {             \
  } while (0)
#endif

}  // namespace tsim

#define COOP_MARK(i, code) K1_MARK(i)
#include "coop.cuh"

namespace tsim {

// One tick of B worlds, `wpg` worlds a group; each block owns `cpt`
// tiles of a group.  Dynamic shared memory: the state words and the work
// list, cpt * THREADS each.
template <class Select>
__global__ void __launch_bounds__(THREADS)
    dm_coop(DMParams p, Inputs in0, Outputs out, int* S0, int B, int cpt,
            int wpg, Select sel) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ uint32_t st[];
  int* list = (int*)(st + cpt * THREADS);
  __shared__ TileOrigin org[MAX_CPT];
  __shared__ int nlist;
  const int tid = threadIdx.x, nslot = cpt * THREADS;
  const long hw = (long)p.H * p.W;
  for (int b0 = 0; b0 < B; b0 += wpg) {
    __syncthreads();          // the last group's finish read `org`
    coop_tiles(p, min(wpg, B - b0), cpt, org, b0);
    coop_move(p, in0, S0, B, cpt, org, st, list, nlist, sel, PlaneDraws(),
              grid);
    __syncthreads();

    for (int q = tid; q < nslot; q += THREADS) {
      int b, c, y, x;
      if (!slot_cell(p, org, q, b, c, y, x)) continue;
      const long o = (long)b * hw;
      out.flags[o + c] = coop_finish(p, world_inputs(in0, b, hw, p),
                                     Work(S0, B, b, p), c, y, x, st[q], out,
                                     o, sel);
    }
  }
#ifdef TSIM_K1_MARKS
  K1_MARK(40);
  if (threadIdx.x == 0) atomicMax(&k1_marks[41], k1_now());
#endif
}

// resident blocks of THREADS on the current card for `cpt` tiles a
// block (cached per device and cpt)
template <class Select>
cudaError_t coop_blocks(int cpt, int* nb) {
  static int cache[8][MAX_CPT + 1];
  static bool attr[8];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 8 && cache[dev][cpt] > 0) {
    *nb = cache[dev][cpt];
    return cudaSuccess;
  }
  if (dev >= 8 || !attr[dev]) {
    e = cudaFuncSetAttribute(dm_coop<Select>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)coop_smem(MAX_CPT));
    if (e != cudaSuccess) return e;
    if (dev < 8) attr[dev] = true;
  }
  int nsm = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, dm_coop<Select>, THREADS, coop_smem(cpt));
  if (e != cudaSuccess) return e;
  *nb = per_sm * nsm;
  if (dev < 8) cache[dev][cpt] = *nb;
  return cudaSuccess;
}

// K1's plan for B worlds of H x W on the current card: `cpt` tiles a
// block, `nb` resident blocks, `wpg` worlds a group.  One group where a
// resident grid holds every tile (the fewest tiles a block, a power of
// two, that does); else as few groups as the largest resident grid
// allows, of equal size, each on the fewest tiles a block that hold it.
template <class Select>
cudaError_t dm_plan(int B, int H, int W, int* cpt, int* nb, int* wpg) {
  const long per_world =
      (long)((W + TILE_W - 1) / TILE_W) * ((H + TILE_H - 1) / TILE_H);
  long best = 0;
  for (int c = 1; c <= MAX_CPT; c *= 2) {
    int n = 0;
    cudaError_t e = coop_blocks<Select>(c, &n);
    if (e != cudaSuccess) return e;
    if ((long)n * c >= (long)B * per_world) {
      *cpt = c;
      *nb = n;
      *wpg = B;
      return cudaSuccess;
    }
    best = (long)n * c > best ? (long)n * c : best;
  }
  const long fit = best / per_world;   // whole worlds in the largest grid
  if (fit < 1) return cudaErrorCooperativeLaunchTooLarge;
  const long groups = (B + fit - 1) / fit;
  *wpg = (int)((B + groups - 1) / groups);
  for (int c = 1; c <= MAX_CPT; c *= 2) {
    int n = 0;
    cudaError_t e = coop_blocks<Select>(c, &n);
    if (e != cudaSuccess) return e;
    if ((long)n * c >= (long)*wpg * per_world) {
      *cpt = c;
      *nb = n;
      return cudaSuccess;
    }
  }
  return cudaErrorCooperativeLaunchTooLarge;
}

// one cooperative launch for the tick of B worlds, selecting rows with
// `sel` (`dm_plan`'s tiles a block and world groups)
template <class Select>
int launch_dm(const DMParams& p, const Inputs& in, const Outputs& out,
              int* scratch, int B, cudaStream_t s, const Select& sel) {
  const long per_world =
      (long)((p.W + TILE_W - 1) / TILE_W) * ((p.H + TILE_H - 1) / TILE_H);
  if (B <= 0 || per_world == 0) return 0;
  int cpt = 0, nb = 0, wpg = 0;
  cudaError_t e = dm_plan<Select>(B, p.H, p.W, &cpt, &nb, &wpg);
  if (e != cudaSuccess) return (int)e;
  const long ntiles = (long)wpg * per_world;
  DMParams pp = p;
  Inputs ii = in;
  Outputs oo = out;
  Select ss = sel;
  const int grid = nb < ntiles ? nb : (int)ntiles;
  void* args[] = {&pp, &ii, &oo, &scratch, &B, &cpt, &wpg, &ss};
  e = cudaLaunchCooperativeKernel((const void*)dm_coop<Select>, dim3(grid),
                                  dim3(THREADS), args, coop_smem(cpt), s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace tsim

#ifdef TSIM_K1_MARKS
// copies the marks of the last call to `out` [64] and clears them
extern "C" int tsim_k1_marks(unsigned long long* out) {
  const size_t n = sizeof(tsim::k1_marks);
  cudaError_t e = cudaMemcpyFromSymbol(out, tsim::k1_marks, n);
  if (e != cudaSuccess) return (int)e;
  static const unsigned long long zero[64] = {};
  return (int)cudaMemcpyToSymbol(tsim::k1_marks, zero, n);
}
#endif

extern "C" int tsim_decide_move(
    const int* ip, const float* fp, const int* sdir4, int D4, const int* wnd,
    const int* pa, const int* pb, const int* pc, const int* pd, const int* pe,
    const float* pl, const uint8_t* stop, const uint8_t* rain,
    const uint8_t* ped, const uint8_t* inter, const int* dest_id,
    const float* r_mal, const float* r_side, const int* r_reroll,
    const int* r_prio, int* opa, int* opb, int* opc, int* opd, int* ope,
    float* opl, int* flags, int* scratch, int B, int H, int W, int geo,
    void* stream) {
  using namespace tsim;
  if (geo & ~1) return (int)cudaErrorInvalidValue;
  DMParams p = dm_params(ip, fp, H, W, D4);
  p.geo = geo;
  return launch_dm(p,
                   Inputs{sdir4, wnd, pa, pb, pc, pd, pe, pl, stop, rain,
                          ped, inter, dest_id, r_mal, r_side, r_reroll,
                          r_prio},
                   Outputs{opa, opb, opc, opd, ope, opl, flags}, scratch, B,
                   (cudaStream_t)stream, GridSelect());
}

// K1's plan for B worlds of H x W on the current card (`dm_plan`):
// out = {tiles a block, blocks of the grid, worlds a group, groups}
extern "C" int tsim_dm_plan(int B, int H, int W, int* out) {
  using namespace tsim;
  int cpt = 0, nb = 0, wpg = 0;
  cudaError_t e = dm_plan<GridSelect>(B, H, W, &cpt, &nb, &wpg);
  if (e != cudaSuccess) return (int)e;
  const long per_world =
      (long)((W + TILE_W - 1) / TILE_W) * ((H + TILE_H - 1) / TILE_H);
  const long ntiles = (long)wpg * per_world;
  out[0] = cpt;
  out[1] = nb < ntiles ? nb : (int)ntiles;
  out[2] = wpg;
  out[3] = (B + wpg - 1) / wpg;
  return 0;
}

// K1-hier: one world under hierarchical routing.  `sdir4` [D4, H, W] is
// the dense (hub and direct) stack, `local4` [LD4, H, W] the windowed
// stack, `hc` the 10 constants of HierConsts.
extern "C" int tsim_decide_move_hier(
    const int* ip, const float* fp, const int* hc, const int* local4,
    int LD4, const int* sdir4, int D4, const int* wnd, const int* pa,
    const int* pb, const int* pc, const int* pd, const int* pe,
    const float* pl, const uint8_t* stop, const uint8_t* rain,
    const uint8_t* ped, const uint8_t* inter, const int* dest_id,
    const float* r_mal, const float* r_side, const int* r_reroll,
    const int* r_prio, int* opa, int* opb, int* opc, int* opd, int* ope,
    float* opl, int* flags, int* scratch, int H, int W, void* stream) {
  using namespace tsim;
  const HierSelect sel{local4, LD4,
                       HierConsts{hc[0], hc[1], hc[2], hc[3], hc[4], hc[5],
                                  hc[6], hc[7], hc[8], hc[9]}};
  return launch_dm(dm_params(ip, fp, H, W, D4),
                   Inputs{sdir4, wnd, pa, pb, pc, pd, pe, pl, stop, rain,
                          ped, inter, dest_id, r_mal, r_side, r_reroll,
                          r_prio},
                   Outputs{opa, opb, opc, opd, ope, opl, flags}, scratch, 1,
                   (cudaStream_t)stream, sel);
}
