// K9: one routing segment (R ticks) of the headline path in one launch,
// for one world or a batch of B worlds.
//
// Replaces megakernel.run_segment_mega's pallas_call (_mega_kernel,
// trafficsimulation_tpu/ops/megakernel.py).  The TPU kernel walks
// grid=(R,) in order with every plane and the 40 MB packed stack in
// VMEM; `jax.vmap` of `run_chunk` (parallel/mesh.py `run_batch_shared`,
// the bench's config #4) puts a world axis on that grid.  Here one launch
// runs the R ticks of every world of the batch; on the H100 a tick is
// bound by its chain of dependent phases and the barriers between them,
// not by bytes (the planes and the stack sit in the 50 MB L2).  Design:
//  - every block works on ONE world wb, whose pointers it builds from the
//    batch's base pointers and each input's world stride (0 for a table
//    the batch shares, so a shared-geometry batch reads one copy); its
//    phases then read that world's Inputs directly (coop.cuh's
//    kOneWorld), as the single world always did;
//  - two forms, chosen by shape on the host (hopper_engine.k9_form):
//      cooperative  a persistent grid; world wb's tiles are dealt to its
//                   `bpw` blocks (block j of the world owns K1's 32 x 8
//                   tiles j, j + bpw, ..., `cpt` of them, so that dense
//                   and empty parts of a world spread over its blocks)
//                   and so are
//                   its light groups: block j takes the pseudo-groups
//                   [j (G + 1) / bpw, (j + 1) (G + 1) / bpw) with their
//                   queue runs, lights and stop runs (lights of no group
//                   spread over the pseudo-groups by index), which the
//                   host table `lown` lists contiguously
//                   (megakernel.light_owner_table), so each light stage
//                   is one loop over the block's items; grid
//                   barriers, shared by all worlds; a batch larger than
//                   one resident grid runs as world groups, one after
//                   another inside the launch; one world (B = 1) is this
//                   form's `kOne` instantiation;
//      worlds       B ordinary blocks, block b owns world b whole (K1's
//                   block-per-world form, `BlockOwn`: its keys and pub
//                   bytes in shared memory), the same stages with block
//                   barriers in place of grid barriers (config #4: 1024
//                   worlds of 64^2);
//  - per tick, 2K + 3 barriers (K = VEHICLE_MAX_SPEED sub-rounds):
//      lights   per block: queue counts (a thread per run; each run's
//               count wraps to int8 as the JAX kernel's `_i8(cnt * bq)`
//               does), the groups' controllers and phase
//               commits, the lights, the stop paint (a warp per run);
//               and the block's part of the first neediest-block
//               reduction, which reads only the tick's starting tanks
//      barrier
//      decide + move: K1's phases (coop.cuh: per-cell state words and
//               work lists in shared memory, one working set written
//               only where a vehicle stands, the `pub` byte), the random
//               draws hashed from the world's tick seeds
//               (engine.tick_randoms); 2K barriers
//      finish, service FSM and despawns on the block's own cells (the
//               neediest block from the tanks before the transfers), and
//               the block's part of the second reduction
//      barrier
//      spawns from the schedule (the neediest block after the
//               transfers), the block tanks, the tick's stats, and the
//               block's stop runs cleared for the next tick's paint
//      barrier
//    A group reads its neighbours' light rows (NEIGHBOR_* controllers)
//    from the last tick's buffers, which the light rows double-buffer,
//    so no group waits for another within a tick.  Stop runs of two
//    owners may share a cell: each clears its runs after the second
//    barrier and paints them after the third, so clears and paints never
//    meet.  The prologue copies the carried tanks to the block's cells
//    and zeroes the stop plane before one more barrier.
// The plane state lives in device memory: tick t reads the planes of
// tick t - 1 (the inputs for t = 0) and its finish writes plane set
// t & 1, which the post-move stages then update cell by cell.  Both
// reductions that are not integer sums are reproducible: the neediest
// block is a total order (value, then the lowest block id), and the
// stats rows are per-thread sums over the thread's cells in a fixed
// order, folded per block in a fixed tree and over a world's blocks in
// block order at the end.  The f32 duration sums are therefore in
// another order than the plain version's; every other stat is an
// integer.  The wrapper keeps the scratch per shape and batch; the
// kernel zeroes at entry what it needs zeroed (queue counts, the stop
// plane).
#include <cooperative_groups.h>

#include <cmath>

// the tick's planes and the stop plane are written by this launch
#define TSIM_COHERENT_LOADS
#include "decide_move.cuh"

namespace tsim {

enum {
  ST_DONE_I, ST_DONE_T, ST_DUR_I, ST_DUR_T, ST_STEPS_I, ST_STEPS_T,
  ST_DONE_SVC, ST_DUR_SVC, ST_STEPS_SVC, ST_NEW_MAL, ST_NEW_COL,
  ST_KILL_I, ST_KILL_T, ST_DROP_I, ST_DROP_T, N_STATS = 16
};
enum { LI_CUR, LI_PEND, LI_TRANS, LI_CLEAR, LI_FT, LI_FTT, LI_QT, LI_GAP,
       LI_LASTARR, N_LI };
enum { ALGO_DISABLED, ALGO_FIXED, ALGO_QUEUE, ALGO_PRESSURE,
       ALGO_NPRESSURE, ALGO_NGREEN };
// the kernel's instantiations: the cooperative form for one world and for
// a batch, and the block-per-world form
enum { K9_ONE, K9_COOP, K9_WORLDS };
constexpr int DEST_NONE = 16383;
constexpr int SVC_BLOCK_NONE = 16383;
constexpr int PD_TIMER_SH = 2, PD_BLOCK_SH = 10;
constexpr int BIG = 1 << 30;
constexpr int NWARP = THREADS / 32;
constexpr int AM_WORDS = 6;   // (value bits, block, dest) x (food, waste)

struct MegaParams {
  DMParams dm;
  int R, G, L, NQ, NS;
  int algo, green, qa_min, qa_gap, qa_max, trans_en, clear_en;
  int load_time, gradual, min_speed;
  int B;     // worlds of the batch
  int bpw;   // blocks a world (1 in the block-per-world form)
  int wpg;   // worlds a group (the cooperative form; B in the other)
  float dt, max_food, max_waste, frate, wrate;
};

// the inputs in the Python wrapper's order (hopper_engine._MEGA_IN)
enum {
  I_SDIR4, I_WND, I_INTER, I_DESTID, I_DESTK1, I_NEXIT, I_EXITC, I_BMASK,
  I_BOK, I_BBID, I_BSVCD, I_BNEEDS, I_BPROD, I_BINNER, I_BFCAP, I_BWCAP,
  I_QRUN,     // [NQ, 6]: orient, coord, a0, a1, group, bucket
  I_SRUN,     // [NS, 5]: orient, coord, a0, a1, light
  I_LGROUP, I_LAXIS, I_GVALID,
  I_NBRG,     // [G, 4]
  I_TICKS,    // [R, 8]: seeds x 4, tick, fallback dest, fdue, wdue
  I_ELAPSED,
  I_RAIN,     // [R, H, W]
  I_SPA,      // [R, H, W]
  I_SPE,      // [R, H, W]
  I_FORCE,
  I_P0,                  // start planes pa..pe
  I_PL0 = I_P0 + 5,
  I_TANK0,               // food, waste, food_rem, waste_rem
  I_LI0 = I_TANK0 + 4, I_LF0, I_LSTOP0,
  // the owners of the light stages, per pseudo-group g <= G + 1 (G + 1:
  // the runs that cover no cell, which no block takes): offsets qoff,
  // loff, soff [G + 3] each, then the queue runs, lights and stop runs
  // in group order [NQ], [L], [NS]
  I_LOWN,
  N_IN
};

// the batch's pointers: the inputs (world 0's, with each input's world
// stride in elements, 0 where the batch shares it), then the outputs and
// the scratch, every world's after the other (the wrapper's order of
// `_mega_launch`; each plane [B][H][W])
struct MegaArgs {
  const void* in[N_IN];
  long ws[N_IN];
  int* setp[2][5];  // plane sets written by even / odd ticks: pa..pe
  float* setl[2];   // and their pl plane
  uint8_t* stop;
  float* tank[4];   // food, waste, food_rem, waste_rem
  int* li[2];      // light rows [B][9][G] written by odd / even ticks
  float* lf[2];    // [B][2][G]
  uint8_t* lstop;  // [B][L]
  float* stats;    // [B][R][16]
  int* work;       // per world K1's working set [8][H][W] int32, then
                   // [H][W] pub bytes (rounded up to words)
  int* qcnt;       // [B][G * 5], zeroed at entry and after every read
  int* gflag;      // [B][G]: all_red | commit << 1 | commit phase << 2
  const uint8_t* ped;  // a zero plane, shared
  int* am;         // [2][B][bpw][AM_WORDS] neediest-block partials
  int* st_i;       // [B][R][bpw][16]
  float* st_f;     // [B][R][bpw][4]
};
constexpr int N_PTRS = N_IN + 30;

// world wb's pointers, as the block builds them (every stage reads its
// world through these, never through another copy of the inputs; the
// plane sets, which tick parity picks, are built each tick)
struct MegaWorld {
  const int* sdir4;
  const int* wnd;
  const uint8_t* inter;
  const int* destid;
  const int* destk1;
  const int* nexit;
  const int* exitc;
  const int* b_mask;
  const int* b_ok;
  const int* b_bid;
  const int* b_svcd;
  const int* b_needs;
  const int* b_prod;
  const float* b_inner;
  const float* b_fcap;
  const float* b_wcap;
  const int* qrun;
  const int* srun;
  const int* l_group;
  const int* l_axis;
  const int* gvalid;
  const int* nbrg;
  const int* ticks;
  const float* elapsed;
  const uint8_t* rain;
  const int* spa;
  const int* spe;
  const int* force;
  const int* p0[5];
  const float* pl0;
  const float* tank0[4];
  const int* li0;
  const float* lf0;
  const uint8_t* lstop0;
  const int* lown;
  uint8_t* stop;
  float* tank[4];
  int* li[2];
  float* lf[2];
  uint8_t* lstop;
  int* work;
  int* qcnt;
  int* gflag;
  int* am[2];
  int* st_i;
  float* st_f;
};

// the stage barriers of the launches since the count was last read
// (thread 0 of block 0 counts; tsim_mega_syncs)
__device__ int k9_syncs;

// the stage timeline of tools/k9_phase_times.py: thread 0 of block 0
// appends (stage code, global timer) once its block has finished a stage
// or passed a barrier (a code below 0 marks nothing); k9_end is the last
// block's end
#ifdef TSIM_K9_MARKS
constexpr int K9_MAX_MARKS = 512;
enum { K9_ENTRY, K9_PROLOGUE, K9_QUEUE, K9_GROUPS, K9_LIGHTS, K9_PAINT,
       K9_NEED, K9_DECIDE, K9_INTENT, K9_COMMIT, K9_FINISH_SERVICE,
       K9_SPAWN, K9_STATS, K9_BARRIER, K9_FOLD };
__device__ unsigned long long k9_times[K9_MAX_MARKS];
__device__ int k9_codes[K9_MAX_MARKS];
__device__ int k9_n;
__device__ unsigned long long k9_end;
__device__ __forceinline__ unsigned long long k9_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define K9_MARK(code)                                                 \
  do {                                                                \
    __syncthreads();                                                  \
    if ((code) >= 0 && blockIdx.x == 0 && threadIdx.x == 0 &&         \
        k9_n < K9_MAX_MARKS) {                                        \
      k9_codes[k9_n] = (code);                                        \
      k9_times[k9_n++] = k9_now();                                    \
    }                                                                 \
  } while (0)
#else
#define K9_MARK(code) \
  do {                \
  } while (0)
#endif
#define K9_COUNT()                                               \
  do {                                                           \
    if (blockIdx.x == 0 && threadIdx.x == 0) k9_syncs += 1;      \
    K9_MARK(K9_BARRIER);                                         \
  } while (0)
#define K9_SYNC(grid) \
  do {                \
    grid.sync();      \
    K9_COUNT();       \
  } while (0)
// the block-per-world form's barrier at the place of a grid barrier
#define K9_BSYNC()     \
  do {                 \
    __syncthreads();   \
    K9_COUNT();        \
  } while (0)

}  // namespace tsim

#define COOP_MARK(i, code) K9_MARK(code)
#define COOP_SYNC(grid) K9_SYNC(grid)
#include "coop.cuh"

namespace tsim {

template <class T>
__device__ __forceinline__ const T* win(const MegaArgs& A, int k, int wb) {
  return (const T*)A.in[k] + A.ws[k] * wb;
}

__device__ __forceinline__ MegaWorld mega_world(const MegaParams& P,
                                                const MegaArgs& A, int wb) {
  const long HW = (long)P.dm.H * P.dm.W, o = HW * wb;
  const long G = P.G, bpw = P.bpw;
  MegaWorld M;
  M.sdir4 = win<int>(A, I_SDIR4, wb);
  M.wnd = win<int>(A, I_WND, wb);
  M.inter = win<uint8_t>(A, I_INTER, wb);
  M.destid = win<int>(A, I_DESTID, wb);
  M.destk1 = win<int>(A, I_DESTK1, wb);
  M.nexit = win<int>(A, I_NEXIT, wb);
  M.exitc = win<int>(A, I_EXITC, wb);
  M.b_mask = win<int>(A, I_BMASK, wb);
  M.b_ok = win<int>(A, I_BOK, wb);
  M.b_bid = win<int>(A, I_BBID, wb);
  M.b_svcd = win<int>(A, I_BSVCD, wb);
  M.b_needs = win<int>(A, I_BNEEDS, wb);
  M.b_prod = win<int>(A, I_BPROD, wb);
  M.b_inner = win<float>(A, I_BINNER, wb);
  M.b_fcap = win<float>(A, I_BFCAP, wb);
  M.b_wcap = win<float>(A, I_BWCAP, wb);
  M.qrun = win<int>(A, I_QRUN, wb);
  M.srun = win<int>(A, I_SRUN, wb);
  M.l_group = win<int>(A, I_LGROUP, wb);
  M.l_axis = win<int>(A, I_LAXIS, wb);
  M.gvalid = win<int>(A, I_GVALID, wb);
  M.nbrg = win<int>(A, I_NBRG, wb);
  M.ticks = win<int>(A, I_TICKS, wb);
  M.elapsed = win<float>(A, I_ELAPSED, wb);
  M.rain = win<uint8_t>(A, I_RAIN, wb);
  M.spa = win<int>(A, I_SPA, wb);
  M.spe = win<int>(A, I_SPE, wb);
  M.force = win<int>(A, I_FORCE, wb);
#pragma unroll
  for (int k = 0; k < 5; ++k) M.p0[k] = win<int>(A, I_P0 + k, wb);
  M.pl0 = win<float>(A, I_PL0, wb);
#pragma unroll
  for (int k = 0; k < 4; ++k) M.tank0[k] = win<float>(A, I_TANK0 + k, wb);
  M.li0 = win<int>(A, I_LI0, wb);
  M.lf0 = win<float>(A, I_LF0, wb);
  M.lstop0 = win<uint8_t>(A, I_LSTOP0, wb);
  M.lown = win<int>(A, I_LOWN, wb);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    M.li[s] = A.li[s] + wb * N_LI * G;
    M.lf[s] = A.lf[s] + wb * 2 * G;
    M.am[s] = A.am + ((s * (long)P.B + wb) * bpw) * AM_WORDS;
  }
  M.stop = A.stop + o;
#pragma unroll
  for (int k = 0; k < 4; ++k) M.tank[k] = A.tank[k] + o;
  M.lstop = A.lstop + (long)wb * P.L;
  M.work = A.work + wb * (N_WORK * HW + (HW + 3) / 4);
  M.qcnt = A.qcnt + wb * G * 5;
  M.gflag = A.gflag + wb * G;
  M.st_i = A.st_i + (long)wb * P.R * bpw * N_STATS;
  M.st_f = A.st_f + (long)wb * P.R * bpw * 4;
  return M;
}


// the block-per-world form's ownership for coop_phases: BlockOwn with the
// barriers counted
struct MegaBlockOwn {
  int* S;
  int* key;
  uint8_t* pub;
  __device__ __forceinline__ Work work(const DMParams& p, int) const {
    return Work(S, key, pub, p);
  }
  __device__ __forceinline__ void sync() const { K9_BSYNC(); }
};

__device__ __forceinline__ uint32_t hash32(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

// engine.tick_randoms for cell c: the 24-bit uniform of seed i's hash
__device__ __forceinline__ float unit24(uint32_t seed, int c) {
  return (float)(hash32((uint32_t)c + seed) >> 8) * (1.0f / 16777216.0f);
}

// ---- the neediest block: a total order, so any fold order agrees ------

struct Best {
  float m;
  int bid, d;
};

__device__ __forceinline__ bool better(const Best& a, const Best& b) {
  return a.m > b.m ||
         (a.m == b.m && (a.bid < b.bid || (a.bid == b.bid && a.d < b.d)));
}

__device__ __forceinline__ Best best_init() { return {-INFINITY, BIG, BIG}; }

__device__ __forceinline__ Best warp_best(Best b) {
  for (int off = 16; off > 0; off >>= 1) {
    Best o{__shfl_down_sync(0xFFFFFFFFu, b.m, off),
           __shfl_down_sync(0xFFFFFFFFu, b.bid, off),
           __shfl_down_sync(0xFFFFFFFFu, b.d, off)};
    if (better(o, b)) b = o;
  }
  return b;
}

// the block's best of (f, w); valid in thread 0
__device__ void block_best(Best& f, Best& w, Best (*sh)[NWARP]) {
  f = warp_best(f);
  w = warp_best(w);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) {
    sh[0][warp] = f;
    sh[1][warp] = w;
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int k = 1; k < NWARP; ++k) {
      if (better(sh[0][k], f)) f = sh[0][k];
      if (better(sh[1][k], w)) w = sh[1][k];
    }
}

__device__ __forceinline__ void store_best(int* p, const Best& f,
                                           const Best& w) {
  p[0] = __float_as_int(f.m);
  p[1] = f.bid;
  p[2] = f.d;
  p[3] = __float_as_int(w.m);
  p[4] = w.bid;
  p[5] = w.d;
}

// the neediest food and waste blocks of the whole world, as the JAX
// `blk_argmax` resolves them (no value above -1: block 0 and `fallback`)
struct Need {
  float mf, mw;
  int bidf, df, bidw, dw;
};

// the world's need from the partials of its nb blocks (in block order)
__device__ Need reduce_need(const int* part, int nb, int fallback,
                            Best (*sh)[NWARP], Need* out) {
  Best f = best_init(), w = best_init();
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    const int* p = part + b * AM_WORDS;
    const Best pf{__int_as_float(p[0]), p[1], p[2]};
    const Best pw{__int_as_float(p[3]), p[4], p[5]};
    if (better(pf, f)) f = pf;
    if (better(pw, w)) w = pw;
  }
  block_best(f, w, sh);
  if (threadIdx.x == 0) {
    Need n;
    n.mf = fmaxf(f.m, -1.0f);
    n.mw = fmaxf(w.m, -1.0f);
    n.bidf = n.mf <= -1.0f ? 0 : f.bid;
    n.df = n.mf <= -1.0f ? fallback : f.d;
    n.bidw = n.mw <= -1.0f ? 0 : w.bid;
    n.dw = n.mw <= -1.0f ? fallback : w.d;
    *out = n;
  }
  __syncthreads();
  return *out;
}

// a block cell's candidates: shortage and surplus where the block counts
// (its tanks read only there)
__device__ __forceinline__ void need_cell(const MegaWorld& M, int c, Best& f,
                                          Best& w) {
  if (!M.b_ok[c]) return;
  const float food = M.tank[0][c], waste = M.tank[1][c];
  const bool bm = M.b_mask[c] != 0;
  const Best cf{(bm && M.b_needs[c]) ? M.b_fcap[c] - food : -1.0f,
                M.b_bid[c], M.b_svcd[c]};
  const Best cw{(bm && M.b_prod[c]) ? waste : -1.0f, M.b_bid[c],
                M.b_svcd[c]};
  if (better(cf, f)) f = cf;
  if (better(cw, w)) w = cw;
}


// K9's draws: engine.tick_randoms at cell c, hashed from the tick's seeds
struct HashDraws {
  uint32_t s0, s1, s2, s3;
  int min_speed, span;
  __device__ __forceinline__ float mal(const Inputs&, int c) const {
    return unit24(s0, c);
  }
  __device__ __forceinline__ float side(const Inputs&, int c) const {
    return unit24(s1, c);
  }
  __device__ __forceinline__ int reroll(const Inputs&, int c) const {
    return min_speed + min(span - 1, (int)(unit24(s2, c) * (float)span));
  }
  __device__ __forceinline__ int prio(const Inputs&, int c) const {
    return (int)hash32((uint32_t)c + s3);
  }
};

// ---- lights ------------------------------------------------------------

// group g's controller and phase commit: reads the light rows of the
// last tick (`li`, `lf`; its neighbours' too) and its queue counts
// (zeroed for the next tick), writes its rows of the next buffers
__device__ void group_step(const MegaParams& P, const MegaWorld& M, int g,
                           const int* li, const float* lf, int* lo,
                           float* lfo) {
  const int G = P.G;
  int v[N_LI];
  for (int k = 0; k < N_LI; ++k) v[k] = li[k * G + g];
  float nsp = lf[g], ewp = lf[G + g];
  const bool gvalid = M.gvalid[g] != 0;
  const bool active = gvalid && v[LI_PEND] == -1;
  int* q = M.qcnt + g * 5;
  const int ns_in = q[0], ns_out = q[1], ew_in = q[2], ew_out = q[3];
  const int n_inter = q[4];
  for (int k = 0; k < 5; ++k) q[k] = 0;
  const int pend0 = v[LI_PEND], cur = v[LI_CUR];
  // _apply_phase: register a request unless it matches current or pending
  auto request = [&](bool want, int phase) {
    if (want && phase != cur && pend0 == -1) v[LI_PEND] = phase;
  };
  switch (P.algo) {
    case ALGO_FIXED: {
      const int timer = active ? v[LI_FTT] + 1 : v[LI_FTT];
      v[LI_FTT] = timer;
      request(active && timer == 1, v[LI_FT]);
      if (active && timer >= P.green) {
        v[LI_FT] = 1 - v[LI_FT];
        v[LI_FTT] = 0;
      }
      break;
    }
    case ALGO_QUEUE: {
      const int timer = active ? v[LI_QT] + 1 : v[LI_QT];
      const bool cur_ns = cur == 0;
      const int cur_q = cur_ns ? ns_in : ew_in;
      const int opp_q = cur_ns ? ew_in : ns_in;
      const bool first = active && timer == 1;
      const bool grew = active && cur_q > v[LI_LASTARR];
      const int gap =
          (first || grew) ? 0 : (active ? v[LI_GAP] + 1 : v[LI_GAP]);
      const bool sw = active && timer >= P.qa_min &&
                      (gap >= P.qa_gap || timer >= P.qa_max ||
                       (opp_q > cur_q && cur_q == 0));
      if (first || grew) v[LI_LASTARR] = cur_q;
      v[LI_QT] = sw ? 0 : timer;
      v[LI_GAP] = gap;
      request(sw, 1 - cur);
      break;
    }
    case ALGO_PRESSURE:
    case ALGO_NPRESSURE: {
      float ns_p = (float)(ns_in - ns_out), ew_p = (float)(ew_in - ew_out);
      if (P.algo == ALGO_NPRESSURE)
        for (int d = 0; d < 4; ++d) {
          const int nb = M.nbrg[g * 4 + d];
          const bool ns = d == 0 || d == 2;
          const float val = nb >= 0 ? lf[(ns ? 0 : G) + nb] : 0.0f;
          if (ns)
            ns_p = ns_p - val;
          else
            ew_p = ew_p - val;
        }
      if (active) {
        nsp = ns_p;
        ewp = ew_p;
      }
      request(active, ns_p > ew_p ? 0 : 1);
      break;
    }
    case ALGO_NGREEN: {
      bool fns = false, few = false;
      for (int d = 0; d < 4; ++d) {
        const int nb = M.nbrg[g * 4 + d];
        if (nb < 0) continue;
        const int ph = li[LI_CUR * G + nb];
        if (d == 0 || d == 2)
          fns = fns || ph == 0;
        else
          few = few || ph == 1;
      }
      request(active, (fns && !few) ? 0
                      : (few && !fns) ? 1
                                      : (ns_in > ew_in ? 0 : 1));
      break;
    }
    default:
      break;
  }

  // phase commit with all-red transition and the clearance rule
  const bool has_pending = gvalid && v[LI_PEND] >= 0;
  bool in_tr = false;
  if (P.trans_en) {
    in_tr = has_pending && v[LI_TRANS] > 0;
    if (in_tr) v[LI_TRANS] -= 1;
  }
  const bool blocked = P.clear_en && has_pending && !in_tr && n_inter > 0;
  const bool all_red = in_tr || blocked;
  const bool commit = has_pending && !all_red;
  M.gflag[g] = (all_red ? 1 : 0) | (commit ? 2 : 0) |
               ((commit ? v[LI_PEND] : 0) << 2);
  if (commit) {
    v[LI_CUR] = v[LI_PEND];
    v[LI_PEND] = -1;
  }
  for (int k = 0; k < N_LI; ++k) lo[k * G + g] = v[k];
  lfo[g] = nsp;
  lfo[G + g] = ewp;
}

// light l's stop flag: all-red, commit and the first tick's host
// overrides, from its last flag in `lstop`
__device__ __forceinline__ void light_step(const MegaParams& P,
                                           const MegaWorld& M, int l,
                                           bool first_tick,
                                           const uint8_t* lstop) {
  int ls = lstop[l];
  const int g = M.l_group[l];
  if (g >= 0 && g < P.G) {
    const int f = M.gflag[g];
    const bool commit = f & 2;
    const int cph = f >> 2, axis = M.l_axis[l];
    if (f & 1) ls = 1;
    if (commit && axis >= 0) ls = axis == cph ? 0 : 1;
  }
  if (first_tick) {
    if (M.force[l] == 0) ls = 0;
    if (M.force[l] == 1) ls = 1;
  }
  M.lstop[l] = (uint8_t)ls;
}

// ---- post-move ---------------------------------------------------------

struct Acc {
  int n[N_STATS];
  float dur[3];  // ST_DUR_I, ST_DUR_T, ST_DUR_SVC
};

// service FSM at the vehicle's cell (the tanks' transfers), arrival stats
// and despawns
__device__ void service_cell(const MegaParams& P, const MegaWorld& M,
                             int* const* dp, float* dpl, int c,
                             float elapsed, const Need& need, Acc& acc) {
  uint32_t pa = (uint32_t)dp[0][c], pd = (uint32_t)dp[3][c];
  const uint32_t pc = (uint32_t)dp[2][c];
  float pl = dpl[c];
  const bool present = pa & 1u;
  const int kind = (int)fld(pa, PA_KIND_SH, 2);
  const int dest14 = (int)fld(pa, PA_DEST_SH, 14);
  const int destid = M.destid[c];
  const bool at_dest = present && destid >= 0 && dest14 == destid;
  const int phase0 = (int)(pd & 3u);
  const float dur = elapsed - (float)fld(pc, 0, 20) * P.dt;
  const int steps = (int)fld(pc, PC_STEPS_SH, 12);
  const bool done_i = at_dest && kind == 0, done_t = at_dest && kind == 1;
  const bool svc_done = at_dest && kind >= 2 && phase0 == 2 && M.exitc[c];
  if (done_i) {
    acc.n[ST_DONE_I] += 1;
    acc.n[ST_STEPS_I] += steps;
    acc.dur[0] += dur;
  }
  if (done_t) {
    acc.n[ST_DONE_T] += 1;
    acc.n[ST_STEPS_T] += steps;
    acc.dur[1] += dur;
  }
  if (svc_done) {
    acc.n[ST_DONE_SVC] += 1;
    acc.n[ST_STEPS_SVC] += steps;
    acc.dur[2] += dur;
  }

  const bool is_svc = at_dest && kind >= 2;
  const bool arrive = is_svc && phase0 == 0;
  const bool bm = M.b_mask[c] != 0;
  float food = M.tank[0][c], waste = M.tank[1][c];
  const float shortage = (bm && M.b_needs[c]) ? M.b_fcap[c] - food : -1.0f;
  const float surplus = (bm && M.b_prod[c]) ? waste : -1.0f;
  const float give =
      (arrive && kind == 2) ? fminf(pl, fmaxf(shortage, 0.0f)) : 0.0f;
  const float take = (arrive && kind == 3)
                         ? fminf(P.max_waste - pl, fmaxf(surplus, 0.0f))
                         : 0.0f;
  M.tank[0][c] = fminf(fmaxf(food + give, 0.0f), M.b_fcap[c]);
  M.tank[1][c] = fminf(fmaxf(waste - take, 0.0f), M.b_wcap[c]);
  pl = pl - give + take;
  bool parked = bit(pa, PA_PARKED_SH) || arrive;
  int phase = arrive ? 1 : phase0;
  int timer = arrive ? P.load_time : (int)fld(pd, PD_TIMER_SH, 8);
  const bool servicing = is_svc && phase == 1 && !arrive;
  if (servicing) timer -= 1;
  const bool finish = servicing && timer <= 0;
  const bool is_food = kind == 2;
  const bool more = is_food ? pl > 0.0f : pl < P.max_waste;
  const bool has_blk = is_food ? need.mf > 0.0f : need.mw > 0.0f;
  const bool go_again = finish && more && has_blk;
  const bool go_exit = finish && !go_again;
  int new_dest = go_again ? (is_food ? need.df : need.dw)
                          : (go_exit ? M.nexit[c] : dest14);
  new_dest = new_dest < 0 ? DEST_NONE : min(new_dest, DEST_NONE);
  const int new_sb = go_again ? (is_food ? need.bidf : need.bidw)
                              : (int)fld(pd, PD_BLOCK_SH, 14);
  phase = go_again ? 0 : (go_exit ? 2 : phase);
  parked = parked && !finish;
  if (is_svc) {
    pa = (pa & ~((1u << PA_PARKED_SH) | ((uint32_t)DEST_NONE << PA_DEST_SH))) |
         ((uint32_t)parked << PA_PARKED_SH) |
         ((uint32_t)clampi(new_dest, 0, DEST_NONE) << PA_DEST_SH);
    pd = (uint32_t)phase | ((uint32_t)clampi(timer, 0, 255) << PD_TIMER_SH) |
         ((uint32_t)new_sb << PD_BLOCK_SH);
  }
  // despawns (stuck despawn is off under the gate)
  const bool despawn =
      at_dest && (kind <= 1 || (kind >= 2 && phase == 2 && M.destk1[c]));
  if (despawn) {
    for (int k = 0; k < 5; ++k) dp[k][c] = 0;
    dpl[c] = 0.0f;
  } else {
    dp[0][c] = (int)pa;
    dp[3][c] = (int)pd;
    dpl[c] = pl;
  }
}

// a scheduled spawn at cell c (placed when the cell is free), then the
// cell's block tanks for the tick
__device__ void spawn_cell(const MegaParams& P, const MegaWorld& M,
                           int* const* dp, float* dpl, int c, long toff,
                           const int* tk, const Need& need, Acc& acc) {
  const int spe = M.spe[toff + c];
  if (spe >= 0) {
    const uint32_t spa = (uint32_t)M.spa[toff + c];
    const int kind_s = (int)fld(spa, PA_KIND_SH, 2);
    if (dp[0][c] & 1) {
      acc.n[kind_s == 0 ? ST_DROP_I : ST_DROP_T] += 1;
    } else {
      const bool s_food = kind_s == 2, is_svc_s = kind_s >= 2;
      int sdest = s_food ? need.df : need.dw;
      sdest = sdest < 0 ? DEST_NONE : min(sdest, DEST_NONE - 1);
      const int dest = is_svc_s ? sdest : (int)fld(spa, PA_DEST_SH, 14);
      dp[0][c] = (int)((spa & ~((uint32_t)DEST_NONE << PA_DEST_SH)) |
                       ((uint32_t)dest << PA_DEST_SH));
      dp[1][c] = 0;
      dp[2][c] = clampi(tk[4] + 1, 0, (1 << 20) - 1);
      dp[3][c] = (is_svc_s ? (s_food ? need.bidf : need.bidw)
                           : SVC_BLOCK_NONE)
                 << PD_BLOCK_SH;
      dp[4][c] = max(spe, 0);
      dpl[c] = s_food ? P.max_food : 0.0f;
    }
  }

  // block resources (agents/blocks.step_blocks on the planes; a cell
  // that holds no block's tank keeps its zeros)
  const bool bm = M.b_mask[c] != 0;
  if (!bm) return;
  const bool needs = bm && M.b_needs[c], prod = bm && M.b_prod[c];
  const float inner = M.b_inner[c];
  float food = M.tank[0][c], waste = M.tank[1][c];
  if (P.gradual) {
    float frem = M.tank[2][c] + (needs ? inner * P.frate : 0.0f);
    const float fwhole = floorf(frem);
    food = fmaxf(food - fwhole, 0.0f);
    M.tank[2][c] = frem - fwhole;
    float wrem = M.tank[3][c] + (prod ? inner * P.wrate : 0.0f);
    const float wwhole = floorf(wrem);
    waste = fminf(waste + wwhole, M.b_wcap[c]);
    M.tank[3][c] = wrem - wwhole;
  } else {
    if (needs && tk[6]) food = fmaxf(food - inner, 0.0f);
    if (prod && tk[7]) waste = fminf(waste + inner, M.b_wcap[c]);
  }
  M.tank[0][c] = food;
  M.tank[1][c] = waste;
}

// the block's sums of the tick's stats into its partial row (fixed order:
// warp tree, then warps in order)
__device__ void store_stats(const Acc& acc, int* pi, float* pf,
                            int (*shi)[NWARP], float (*shf)[NWARP]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  for (int k = 0; k < N_STATS; ++k) {
    int v = acc.n[k];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xFFFFFFFFu, v, off);
    if (lane == 0) shi[k][warp] = v;
  }
  for (int k = 0; k < 3; ++k) {
    float v = acc.dur[k];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xFFFFFFFFu, v, off);
    if (lane == 0) shf[k][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < N_STATS) {
    int s = 0;
    for (int k = 0; k < NWARP; ++k) s += shi[threadIdx.x][k];
    pi[threadIdx.x] = s;
  } else if (threadIdx.x < N_STATS + 3) {
    const int j = threadIdx.x - N_STATS;
    float s = 0.0f;
    for (int k = 0; k < NWARP; ++k) s += shf[j][k];
    pf[j] = s;
  }
}

// stats row value i (tick i / 16, column i % 16) of world w: its bpw
// blocks' partials in block order
__device__ __forceinline__ float fold_stat(const MegaParams& P,
                                           const MegaArgs& A, int w, int i) {
  const int t = i / N_STATS, k = i % N_STATS;
  const int fk = k == ST_DUR_I ? 0 : k == ST_DUR_T ? 1
               : k == ST_DUR_SVC ? 2 : -1;
  const long row = ((long)w * P.R + t) * P.bpw;
  if (fk >= 0) {
    float v = 0.0f;
    for (int b = 0; b < P.bpw; ++b) v += A.st_f[(row + b) * 4 + fk];
    return v;
  }
  int s = 0;
  for (int b = 0; b < P.bpw; ++b) s += A.st_i[(row + b) * N_STATS + k];
  return (float)s;
}

// the run rectangle q (orientation, coordinate, span [a0, a1)): its
// length inside the grid, and the flat index of its cell k
__device__ __forceinline__ int run_len(const int* q, int H, int W) {
  return q[0] == 0 ? 0 : min(q[3], q[0] == 1 ? H : W) - q[2];
}
__device__ __forceinline__ int run_cell(const int* q, int k, int W) {
  return q[0] == 1 ? (q[2] + k) * W + q[1] : q[1] * W + q[2] + k;
}

// the stop runs idx[i0 .. i1) (rows of `tab`), a warp per run and a
// lane per cell: the plane's cells set to v where `lstop` is null or the
// run's light (column 4) is stopped
__device__ __forceinline__ void fill_runs(uint8_t* plane, const int* tab,
                                          const int* idx, int i0, int i1,
                                          const uint8_t* lstop, int H, int W,
                                          uint8_t v) {
  const int lane = threadIdx.x & 31;
  for (int i = i0 + (int)(threadIdx.x >> 5); i < i1; i += NWARP) {
    const int* q = tab + idx[i] * 5;
    if (lstop != nullptr && (q[0] == 0 || !lstop[q[4]])) continue;
    const int n = run_len(q, H, W);
    for (int k = lane; k < n; k += 32) plane[run_cell(q, k, W)] = v;
  }
}

// The R ticks.  Block blockIdx.x works on world wb: in the cooperative
// forms world b0 + blockIdx.x / bpw of each world group b0 (K9_ONE: world
// 0 of one), as the world's block jw = blockIdx.x % bpw, owning its
// tiles jw, jw + bpw, ... and its pseudo-groups [sh_g[0], sh_g[1]); in the
// block-per-world form world blockIdx.x whole.  Dynamic shared memory:
// K1's state words and work list (and, in the block-per-world form, the
// world's keys and pub bytes).  The cooperative forms keep two blocks an
// SM (at most 128 registers: the B = 16 batch's grid of 256 blocks is
// resident at 16 tiles a block); the block-per-world form takes three
// (at most 85: 1024 worlds in 2.6 waves rather than 3.9, 0.32 ms faster
// a call at config #4 on the H100 despite its spills)
template <int kForm>
__global__ void __launch_bounds__(THREADS, kForm == K9_WORLDS ? 3 : 2)
    mega_kernel(const MegaParams P, const MegaArgs A, int cpt) {
  constexpr bool kOne = kForm == K9_ONE, kBlock = kForm == K9_WORLDS;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ uint32_t st[];
  int* list = (int*)(st + cpt * THREADS);
  __shared__ TileOrigin org[MAX_CPT];
  __shared__ int nlist;
  __shared__ Best sh_best[2][NWARP];
  __shared__ Need sh_need[2];
  __shared__ int sh_i[N_STATS][NWARP];
  __shared__ float sh_f[3][NWARP];
  __shared__ int sh_g[2];
  const int H = P.dm.H, W = P.dm.W, G = P.G;
  const int HW = H * W;
  const int tid = threadIdx.x, nslot = cpt * THREADS;
  // blocks a world, and this block's place among them
  const int bpw = kBlock ? 1 : kOne ? (int)gridDim.x : P.bpw;
  const int jw = kBlock ? 0 : kOne ? (int)blockIdx.x : blockIdx.x % bpw;
  const int tx = (W + TILE_W - 1) / TILE_W;
  const int per_world = tx * ((H + TILE_H - 1) / TILE_H);
  // the block's pseudo-groups of its world [sh_g[0], sh_g[1]) (G: the
  // lights of no group), kept in shared memory rather than registers
  if (tid == 0) {
    sh_g[0] = (int)((long)jw * (G + 1) / bpw);
    sh_g[1] = (int)((long)(jw + 1) * (G + 1) / bpw);
  }
  const int ngroups = kBlock || kOne ? 1 : (P.B + P.wpg - 1) / P.wpg;
  K9_MARK(K9_ENTRY);

  for (int gi = 0; gi < ngroups; ++gi) {
    const int wb = kOne ? 0
                 : kBlock ? (int)blockIdx.x
                          : gi * P.wpg + (int)blockIdx.x / bpw;
    const bool on = kOne || wb < P.B;
    const MegaWorld M = mega_world(P, A, kOne ? 0 : wb);
    // the block's tiles of its world (world 0 of the block's pointers)
    __syncthreads();          // the last group's finish read `org`
    if (tid < cpt) {
      const int k = jw + tid * bpw;
      org[tid] = TileOrigin{on && k < per_world ? 0 : -1,
                            (k / tx) * TILE_H, (k % tx) * TILE_W};
    }
    __syncthreads();
    int* const key = list + cpt * THREADS;   // the block-per-world form's
    const auto own = [&]() {
      if constexpr (kBlock)
        return MegaBlockOwn{M.work, key, (uint8_t*)(key + HW)};
      else
        return GridOwn{M.work, 1, grid};
    }();

    // the carried tanks to the block's cells, its groups' queue counts
    // zeroed, the stop plane zeroed
    if (on) {
      for (int q = tid; q < nslot; q += THREADS) {
        int b, c, y, x;
        if (!slot_cell(P.dm, org, q, b, c, y, x)) continue;
#pragma unroll
        for (int k = 0; k < 4; ++k) M.tank[k][c] = M.tank0[k][c];
      }
      for (int g = sh_g[0] + tid; g < min(sh_g[1], G); g += THREADS)
        for (int k = 0; k < 5; ++k) M.qcnt[g * 5 + k] = 0;
      for (int c = jw * THREADS + tid; c < HW; c += bpw * THREADS)
        M.stop[c] = 0;
    }
    K9_MARK(K9_PROLOGUE);
    if constexpr (kBlock) K9_BSYNC(); else K9_SYNC(grid);

    const int* qoff = M.lown;
    const int* loff = qoff + G + 3;
    const int* soff = loff + G + 3;
    const int* qidx = soff + G + 3;
    const int* lidx = qidx + P.NQ;
    const int* sidx = lidx + P.L;
    for (int t = 0; t < P.R; ++t) {
      const int* tk = M.ticks + t * 8;
      const long toff = (long)t * HW;
      const int s = t & 1;
      // the tick's inputs: the planes of tick t - 1 (the carried planes
      // at t = 0); no random planes (K9 hashes its draws); and the set
      // this tick writes
      const long o = (long)HW * wb;
      const int* pin[5];
      int* dp[5];
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        pin[k] = t == 0 ? M.p0[k] : A.setp[s ^ 1][k] + o;
        dp[k] = A.setp[s][k] + o;
      }
      const float* plin = t == 0 ? M.pl0 : A.setl[s ^ 1] + o;
      float* dpl = A.setl[s] + o;
      const Inputs in{M.sdir4, M.wnd, pin[0], pin[1], pin[2], pin[3],
                      pin[4], plin, M.stop, M.rain + toff, A.ped, M.inter,
                      M.destid, nullptr, nullptr, nullptr, nullptr};
      const Outputs out{dp[0], dp[1], dp[2], dp[3], dp[4], dpl, nullptr};

      if (on) {
        // lights, on the block's groups: queue counts, a thread per run
        // (runs are short: the headline's longest is 11 cells)
        for (int i = qoff[sh_g[0]] + tid; i < qoff[sh_g[1]]; i += THREADS) {
          const int* q = M.qrun + qidx[i] * 6;
          const int n = run_len(q, H, W);
          int cnt = 0;
          for (int k = 0; k < n; ++k) cnt += in.pa[run_cell(q, k, W)] & 1;
          const int w8 = ((cnt + 128) & 255) - 128;
          if (w8) atomicAdd(&M.qcnt[q[4] * 5 + q[5]], w8);
        }
      }
      __syncthreads();
      K9_MARK(K9_QUEUE);
      // the controllers and phase commits (tick t reads the light rows
      // of tick t - 1 and writes buffer (t + 1) & 1)
      if (on) {
        const int* li = t == 0 ? M.li0 : (s ? M.li[1] : M.li[0]);
        const float* lf = t == 0 ? M.lf0 : (s ? M.lf[1] : M.lf[0]);
        int* lo = s ? M.li[0] : M.li[1];
        float* lfo = s ? M.lf[0] : M.lf[1];
        for (int g = sh_g[0] + tid; g < min(sh_g[1], G); g += THREADS)
          group_step(P, M, g, li, lf, lo, lfo);
      }
      __syncthreads();
      K9_MARK(K9_GROUPS);
      // the lights, then the stopped lights' runs painted
      if (on)
        for (int i = loff[sh_g[0]] + tid; i < loff[sh_g[1]]; i += THREADS)
          light_step(P, M, lidx[i], t == 0, t == 0 ? M.lstop0 : M.lstop);
      __syncthreads();
      K9_MARK(K9_LIGHTS);
      if (on)
        fill_runs(M.stop, M.srun, sidx, soff[sh_g[0]], soff[sh_g[1]], M.lstop,
                  H, W, 1);
      K9_MARK(K9_PAINT);
      // the block's candidates for the neediest blocks before the
      // transfers
      if (on) {
        Best bf = best_init(), bw = best_init();
        for (int q = tid; q < nslot; q += THREADS) {
          int b, c, y, x;
          if (!slot_cell(P.dm, org, q, b, c, y, x)) continue;
          need_cell(M, c, bf, bw);
        }
        block_best(bf, bw, sh_best);
        if (tid == 0) store_best(M.am[0] + jw * AM_WORDS, bf, bw);
      }
      K9_MARK(K9_NEED);
      if constexpr (kBlock) K9_BSYNC(); else K9_SYNC(grid);

      // decide + move
      Need need1{};
      if (on) need1 = reduce_need(M.am[0], bpw, tk[5], sh_best, &sh_need[0]);
      const HashDraws dr{on ? (uint32_t)tk[0] : 0u, on ? (uint32_t)tk[1] : 0u,
                         on ? (uint32_t)tk[2] : 0u, on ? (uint32_t)tk[3] : 0u,
                         P.min_speed, P.dm.max_speed - P.min_speed + 1};
      coop_phases<GridSelect, HashDraws, true>(P.dm, in, own, cpt, org, st,
                                               list, nlist, GridSelect(), dr);
      __syncthreads();

      // finish, service FSM and despawns on the block's cells, against
      // the tanks before the transfers
      Acc acc;
      for (int k = 0; k < N_STATS; ++k) acc.n[k] = 0;
      for (int k = 0; k < 3; ++k) acc.dur[k] = 0.0f;
      if (on) {
        const float elapsed = M.elapsed[t];
        const Work work = own.work(P.dm, 0);
        Best bf = best_init(), bw = best_init();
        for (int q = tid; q < nslot; q += THREADS) {
          int b, c, y, x;
          if (!slot_cell(P.dm, org, q, b, c, y, x)) continue;
          const int flags =
              coop_finish(P.dm, in, work, c, y, x, st[q], out, 0, GridSelect());
          acc.n[ST_NEW_MAL] += flags & 1;
          acc.n[ST_NEW_COL] += (flags >> 1) & 1;
          // an empty cell that holds no block's tank: the service stage
          // leaves it as it is (its load +0, its tanks zero)
          if ((st[q] & C_PRESENT) || M.b_mask[c])
            service_cell(P, M, dp, dpl, c, elapsed, need1, acc);
          need_cell(M, c, bf, bw);
        }
        block_best(bf, bw, sh_best);
        if (tid == 0) store_best(M.am[1] + jw * AM_WORDS, bf, bw);
      }
      K9_MARK(K9_FINISH_SERVICE);
      if constexpr (kBlock) K9_BSYNC(); else K9_SYNC(grid);

      // spawns against the tanks after the transfers, block tanks,
      // stats; the block's stop runs cleared for the next tick's paint
      if (on) {
        const Need need2 =
            reduce_need(M.am[1], bpw, tk[5], sh_best, &sh_need[1]);
        for (int q = tid; q < nslot; q += THREADS) {
          int b, c, y, x;
          if (!slot_cell(P.dm, org, q, b, c, y, x)) continue;
          spawn_cell(P, M, dp, dpl, c, toff, tk, need2, acc);
        }
      }
      K9_MARK(K9_SPAWN);
      if (on) {
        const long prow = (long)t * bpw + jw;
        store_stats(acc, M.st_i + prow * N_STATS, M.st_f + prow * 4, sh_i,
                    sh_f);
        if (t + 1 < P.R)
          fill_runs(M.stop, M.srun, sidx, soff[sh_g[0]], soff[sh_g[1]],
                    nullptr, H, W, 0);
      }
      K9_MARK(K9_STATS);
      if constexpr (kBlock) K9_BSYNC(); else K9_SYNC(grid);
    }
  }

  // the stats rows: each world's block partials in block order
  if constexpr (kBlock) {
    for (int i = tid; i < P.R * N_STATS; i += THREADS)
      A.stats[(long)blockIdx.x * P.R * N_STATS + i] =
          fold_stat(P, A, blockIdx.x, i);
  } else {
    const int n = P.R * N_STATS;
    for (long i = (long)blockIdx.x * THREADS + tid; i < (long)P.B * n;
         i += (long)gridDim.x * THREADS)
      A.stats[i] = fold_stat(P, A, (int)(i / n), (int)(i % n));
  }
#ifdef TSIM_K9_MARKS
  K9_MARK(K9_FOLD);
  if (tid == 0) atomicMax(&k9_end, k9_now());
#endif
}

template <int kForm>
const void* mega_fn() {
  return (const void*)mega_kernel<kForm>;
}

// the largest dynamic shared memory each instantiation takes (the
// cooperative forms' at MAX_CPT tiles, the block-per-world form's at
// `smem`), set once per device and size
static cudaError_t mega_attr(int kForm, size_t smem) {
  static size_t done[3][8];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 8 && done[kForm][dev] >= smem)) return e;
  const void* fn = kForm == K9_ONE ? mega_fn<K9_ONE>()
                   : kForm == K9_COOP ? mega_fn<K9_COOP>()
                                      : mega_fn<K9_WORLDS>();
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess && dev < 8) done[kForm][dev] = smem;
  return e;
}

// the instantiation a launch of B worlds in form `form` (0 cooperative,
// 1 block per world) takes
static int mega_kind(int B, int form) {
  return form == 1 ? K9_WORLDS : (B == 1 ? K9_ONE : K9_COOP);
}

// The plan of a launch of B worlds of H x W on this card, in `form` (0
// cooperative, 1 block per world; -1: by shape, hopper_engine.k9_form's
// rule): out = {form, blocks, tiles a block, blocks a world, worlds a
// group, groups, dynamic shared memory bytes, static shared memory
// bytes, registers, resident blocks an SM}.  The cooperative form takes
// the fewest tiles a block (a power of two) whose resident grid holds
// every world's blocks; else as few world groups as the largest resident
// grid allows, of equal size, each on the fewest tiles a block that hold
// it.
static cudaError_t mega_plan(int B, int H, int W, int form, int* out) {
  const int tiles =
      ((W + TILE_W - 1) / TILE_W) * ((H + TILE_H - 1) / TILE_H);
  if (B < 1 || tiles < 1) return cudaErrorInvalidValue;
  int dev = 0, nsm = 0, smem_block = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_block,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  // each form's rule counts the static shared memory of the instantiation
  // it launches
  cudaFuncAttributes fa, fc;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, mega_fn<K9_WORLDS>());
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fc, mega_fn<K9_COOP>());
  if (e != cudaSuccess) return e;
  const long hw = (long)H * W;
  const long reserve = 1024;   // the shared memory CUDA keeps a block
  const long sm_smem = smem_block + reserve;
  const long wneed = (long)world_smem(tiles, hw) + fa.sharedSizeBytes;
  const bool fits = tiles <= MAX_CPT && wneed <= smem_block &&
                    sm_smem / (wneed + reserve) >= 2;
  if (form < 0) {
    bool coop = false;
    for (int c = 1; c <= MAX_CPT; c *= 2)
      coop = coop || (long)(tiles + c - 1) / c <=
                         (long)nsm * (sm_smem / ((long)coop_smem(c) +
                                                 (long)fc.sharedSizeBytes +
                                                 reserve));
    if (fits && B >= 2 * nsm)
      form = 1;
    else if (coop)
      form = 0;
    else
      return cudaErrorInvalidValue;
  }
  const int kind = mega_kind(B, form);
  const void* fn = kind == K9_ONE ? mega_fn<K9_ONE>()
                   : kind == K9_COOP ? mega_fn<K9_COOP>()
                                     : mega_fn<K9_WORLDS>();
  e = cudaFuncGetAttributes(&fa, fn);
  if (e != cudaSuccess) return e;
  out[0] = form;
  out[7] = (int)fa.sharedSizeBytes;
  out[8] = fa.numRegs;
  if (form == 1) {
    if (!fits && (tiles > MAX_CPT || wneed > smem_block))
      return cudaErrorInvalidValue;
    const size_t smem = world_smem(tiles, hw);
    int per_sm = 0;
    e = mega_attr(kind, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS,
                                                        smem);
    if (e != cudaSuccess) return e;
    out[1] = B;
    out[2] = tiles;
    out[3] = 1;
    out[4] = B;
    out[5] = 1;
    out[6] = (int)smem;
    out[9] = per_sm;
    return cudaSuccess;
  }
  e = mega_attr(kind, coop_smem(MAX_CPT));
  if (e != cudaSuccess) return e;
  int per_sm[8];
  long fit = 0;
  for (int i = 0, c = 1; c <= MAX_CPT; ++i, c *= 2) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[i], fn, THREADS,
                                                      coop_smem(c));
    if (e != cudaSuccess) return e;
    const long n = (long)per_sm[i] * nsm, bpw = (tiles + c - 1) / c;
    fit = n / bpw > fit ? n / bpw : fit;
  }
  if (fit < 1) return cudaErrorCooperativeLaunchTooLarge;
  const long groups = (B + fit - 1) / fit;
  const int wpg = (int)((B + groups - 1) / groups);
  for (int i = 0, c = 1; c <= MAX_CPT; ++i, c *= 2) {
    const long bpw = (tiles + c - 1) / c;
    if (bpw * wpg > (long)per_sm[i] * nsm) continue;
    out[1] = (int)(bpw * wpg);
    out[2] = c;
    out[3] = (int)bpw;
    out[4] = wpg;
    out[5] = (B + wpg - 1) / wpg;
    out[6] = (int)coop_smem(c);
    out[9] = per_sm[i];
    return cudaSuccess;
  }
  return cudaErrorCooperativeLaunchTooLarge;
}

}  // namespace tsim

// One launch of K9 for B worlds: `ptr` the N_PTRS pointers (the inputs,
// outputs and scratch in the wrapper's order), `ws` each input's world
// stride in elements (0: shared by the batch); `form` (0 cooperative, 1
// block per world), `grid` blocks, `cpt` tiles a block and `wpg` worlds a
// group as `tsim_mega_plan` gives them.
extern "C" int tsim_mega_segment(const int* ip, const float* fp,
                                 void* const* ptr, const long* ws, int nptr,
                                 int B, int form, int grid, int cpt, int wpg,
                                 void* stream) {
  using namespace tsim;
  if (nptr != N_PTRS || B < 1 || grid < 1 || cpt < 1 || cpt > MAX_CPT ||
      (form != 0 && form != 1))
    return (int)cudaErrorInvalidValue;
  MegaParams P;
  P.dm = dm_params(ip, fp, ip[16], ip[17], ip[18]);
  P.R = ip[19];
  P.G = ip[20];
  P.L = ip[21];
  P.NQ = ip[22];
  P.NS = ip[23];
  P.algo = ip[24];
  P.green = ip[25];
  P.qa_min = ip[26];
  P.qa_gap = ip[27];
  P.qa_max = ip[28];
  P.trans_en = ip[29];
  P.clear_en = ip[30];
  P.load_time = ip[31];
  P.gradual = ip[32];
  P.min_speed = ip[33];
  P.dt = fp[2];
  P.max_food = fp[3];
  P.max_waste = fp[4];
  P.frate = fp[5];
  P.wrate = fp[6];
  const int H = P.dm.H, W = P.dm.W;
  const int tiles =
      ((W + TILE_W - 1) / TILE_W) * ((H + TILE_H - 1) / TILE_H);
  P.B = B;
  if (form == 1) {
    if (cpt != tiles || grid != B) return (int)cudaErrorInvalidValue;
    P.bpw = 1;
    P.wpg = B;
  } else {
    P.bpw = (tiles + cpt - 1) / cpt;
    P.wpg = wpg;
    if (wpg < 1 || (long)grid != (long)P.bpw * wpg)
      return (int)cudaErrorInvalidValue;
  }

  MegaArgs A;
  int i = 0;
  for (int k = 0; k < N_IN; ++k) {
    A.in[k] = ptr[i++];
    A.ws[k] = ws[k];
  }
  for (int s = 0; s < 2; ++s) {
    for (int k = 0; k < 5; ++k) A.setp[s][k] = (int*)ptr[i++];
    A.setl[s] = (float*)ptr[i++];
  }
  A.stop = (uint8_t*)ptr[i++];
  for (int k = 0; k < 4; ++k) A.tank[k] = (float*)ptr[i++];
  A.li[0] = (int*)ptr[i++];
  A.li[1] = (int*)ptr[i++];
  A.lf[0] = (float*)ptr[i++];
  A.lf[1] = (float*)ptr[i++];
  A.lstop = (uint8_t*)ptr[i++];
  A.stats = (float*)ptr[i++];
  A.work = (int*)ptr[i++];
  A.qcnt = (int*)ptr[i++];
  A.gflag = (int*)ptr[i++];
  A.ped = (const uint8_t*)ptr[i++];
  A.am = (int*)ptr[i++];
  A.st_i = (int*)ptr[i++];
  A.st_f = (float*)ptr[i++];
  if (i != N_PTRS) return (int)cudaErrorInvalidValue;

  const int kind = mega_kind(B, form);
  cudaStream_t s = (cudaStream_t)stream;
  void* args[] = {(void*)&P, (void*)&A, (void*)&cpt};
  cudaError_t e;
  if (kind == K9_WORLDS) {
    const size_t smem = world_smem(cpt, (long)H * W);
    e = mega_attr(kind, smem);
    if (e == cudaSuccess)
      e = cudaLaunchKernel(mega_fn<K9_WORLDS>(), dim3(grid), dim3(THREADS),
                           args, smem, s);
  } else {
    e = mega_attr(kind, coop_smem(MAX_CPT));
    if (e == cudaSuccess)
      e = cudaLaunchCooperativeKernel(
          kind == K9_ONE ? mega_fn<K9_ONE>() : mega_fn<K9_COOP>(), dim3(grid),
          dim3(THREADS), args, coop_smem(cpt), s);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// K9's plan for B worlds of H x W on this card (tsim::mega_plan): form
// -1 chooses by shape
extern "C" int tsim_mega_plan(int B, int H, int W, int form, int* out) {
  return (int)tsim::mega_plan(B, H, W, form, out);
}

// the stage barriers K9's launches have passed since the last call (*n),
// counted by block 0; then zeroed
extern "C" int tsim_mega_syncs(int* n) {
  const int zero = 0;
  cudaError_t e = cudaMemcpyFromSymbol(n, tsim::k9_syncs, sizeof(int));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(tsim::k9_syncs, &zero, sizeof(int));
  return (int)e;
}

#ifdef TSIM_K9_MARKS
// the marks of the last call: n (return value, or -1 on an error), codes
// and times [K9_MAX_MARKS], the last block's end; then cleared
extern "C" int tsim_k9_marks(int* codes, unsigned long long* times,
                             unsigned long long* end) {
  using namespace tsim;
  int n = 0;
  const unsigned long long zero = 0;
  if (cudaMemcpyFromSymbol(&n, k9_n, sizeof(int)) != cudaSuccess ||
      cudaMemcpyFromSymbol(codes, k9_codes, sizeof(k9_codes)) !=
          cudaSuccess ||
      cudaMemcpyFromSymbol(times, k9_times, sizeof(k9_times)) !=
          cudaSuccess ||
      cudaMemcpyFromSymbol(end, k9_end, sizeof(zero)) != cudaSuccess ||
      cudaMemcpyToSymbol(k9_n, &zero, sizeof(int)) != cudaSuccess ||
      cudaMemcpyToSymbol(k9_end, &zero, sizeof(zero)) != cudaSuccess)
    return -1;
  return n;
}
#endif
