// K9: one routing segment (R ticks) of the headline path in one launch.
//
// Replaces megakernel.run_segment_mega's pallas_call (_mega_kernel,
// trafficsimulation_tpu/ops/megakernel.py).  The TPU kernel walks
// grid=(R,) in order with every plane and the 40 MB packed stack in
// VMEM.  Here one cooperative launch holds a persistent grid of resident
// blocks; on the H100 a tick is bound by its chain of dependent phases
// and the grid-wide barriers between them, not by bytes (the planes and
// the stack sit in the 50 MB L2).  Design:
//  - fixed owners: block j owns the 32 x 8 cell tiles j, j + grid, ...
//    (K1's `coop_tiles`) for every per-cell stage of every tick, and the
//    light groups j, j + grid, ... with their queue runs, lights and
//    stop runs (lights of no group spread over the pseudo-groups by
//    index), as the host table `lown` lists them
//    (megakernel.light_owner_table);
//  - per tick, 2K + 3 grid barriers (K = VEHICLE_MAX_SPEED sub-rounds):
//      lights   per block: queue counts (a warp per run, a lane per
//               cell; each run's count wraps to int8 as the JAX kernel's
//               `_i8(cnt * bq)` does), the groups' controllers and phase
//               commits, the lights, the stop paint (a warp per run);
//               and the block's part of the first neediest-block
//               reduction, which reads only the tick's starting tanks
//      barrier
//      decide + move: K1's cooperative phases (coop.cuh: per-cell state
//               words and work lists in shared memory, one working set
//               written only where a vehicle stands, the `pub` byte),
//               the random draws hashed from the tick's seeds
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
// order, folded per block in a fixed tree and over blocks in block order
// at the end.  The f32 duration sums are therefore in another order than
// the plain version's; every other stat is an integer.  The wrapper
// keeps the scratch per shape; the kernel zeroes at entry what it needs
// zeroed (queue counts, the stop plane).
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
  int load_time, gradual, min_speed, nbmax;
  float dt, max_food, max_waste, frate, wrate;
};

// pointers in the Python wrapper's order (hopper_engine._MEGA_IN, then
// the outputs and the scratch of `_mega_kernel`)
struct MegaArgs {
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
  const int* qrun;   // [NQ, 6]: orient, coord, a0, a1, group, bucket
  const int* srun;   // [NS, 5]: orient, coord, a0, a1, light
  const int* l_group;
  const int* l_axis;
  const int* gvalid;
  const int* nbrg;   // [G, 4]
  const int* ticks;  // [R, 8]: seeds x 4, tick, fallback dest, fdue, wdue
  const float* elapsed;
  const uint8_t* rain;  // [R, H, W]
  const int* spa;       // [R, H, W]
  const int* spe;       // [R, H, W]
  const int* force;
  const int* p0[5];  // start planes pa..pe
  const float* pl0;
  const float* tank0[4];  // food, waste, food_rem, waste_rem
  const int* li0;
  const float* lf0;
  const uint8_t* lstop0;
  // the owners of the light stages, per pseudo-group g <= G + 1 (G + 1:
  // the runs that cover no cell, which no block takes): offsets qoff,
  // loff, soff [G + 3] each, then the queue runs, lights and stop runs
  // in group order [NQ], [L], [NS]
  const int* lown;
  int* setp[2][5];  // plane sets written by even / odd ticks
  float* setl[2];
  uint8_t* stop;
  float* tank[4];
  int* li[2];       // light rows written by odd / even ticks
  float* lf[2];
  uint8_t* lstop;
  float* stats;  // [R, 16]
  int* work;     // K1's working set [8, H, W] int32, then [H, W] pub bytes
  int* qcnt;     // [G * 5], zeroed at entry and after every tick's read
  int* gflag;    // [G]: all_red | commit << 1 | commit phase << 2
  const uint8_t* ped;  // a zero plane
  int* am;       // [2, nbmax, AM_WORDS] neediest-block partials
  int* st_i;     // [R, nbmax, 16]
  float* st_f;   // [R, nbmax, 4]
};
constexpr int N_PTRS = 28 + 5 + 1 + 4 + 3 + 1 + 12 + 1 + 4 + 2 + 2 + 2 + 7;

// the grid barriers of the launches since the count was last read
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
#define K9_SYNC(grid)                                            \
  do {                                                           \
    grid.sync();                                                 \
    if (blockIdx.x == 0 && threadIdx.x == 0) k9_syncs += 1;      \
    K9_MARK(K9_BARRIER);                                         \
  } while (0)

}  // namespace tsim

#define COOP_MARK(i, code) K9_MARK(code)
#define COOP_SYNC(grid) K9_SYNC(grid)
#include "coop.cuh"

namespace tsim {

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

// the neediest food and waste blocks of the whole lattice, as the JAX
// `blk_argmax` resolves them (no value above -1: block 0 and `fallback`)
struct Need {
  float mf, mw;
  int bidf, df, bidw, dw;
};

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
__device__ __forceinline__ void need_cell(const MegaArgs& A, int c,
                                          float food, float waste, Best& f,
                                          Best& w) {
  if (!A.b_ok[c]) return;
  const bool bm = A.b_mask[c] != 0;
  const Best cf{(bm && A.b_needs[c]) ? A.b_fcap[c] - food : -1.0f,
                A.b_bid[c], A.b_svcd[c]};
  const Best cw{(bm && A.b_prod[c]) ? waste : -1.0f, A.b_bid[c],
                A.b_svcd[c]};
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
__device__ void group_step(const MegaParams& P, const MegaArgs& A, int g,
                           const int* li, const float* lf, int* lo,
                           float* lfo) {
  const int G = P.G;
  int v[N_LI];
  for (int k = 0; k < N_LI; ++k) v[k] = li[k * G + g];
  float nsp = lf[g], ewp = lf[G + g];
  const bool gvalid = A.gvalid[g] != 0;
  const bool active = gvalid && v[LI_PEND] == -1;
  int* q = A.qcnt + g * 5;
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
          const int nb = A.nbrg[g * 4 + d];
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
        const int nb = A.nbrg[g * 4 + d];
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
  A.gflag[g] = (all_red ? 1 : 0) | (commit ? 2 : 0) |
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
                                           const MegaArgs& A, int l,
                                           bool first_tick,
                                           const uint8_t* lstop) {
  int ls = lstop[l];
  const int g = A.l_group[l];
  if (g >= 0 && g < P.G) {
    const int f = A.gflag[g];
    const bool commit = f & 2;
    const int cph = f >> 2, axis = A.l_axis[l];
    if (f & 1) ls = 1;
    if (commit && axis >= 0) ls = axis == cph ? 0 : 1;
  }
  if (first_tick) {
    if (A.force[l] == 0) ls = 0;
    if (A.force[l] == 1) ls = 1;
  }
  A.lstop[l] = (uint8_t)ls;
}

// ---- post-move ---------------------------------------------------------

struct Acc {
  int n[N_STATS];
  float dur[3];  // ST_DUR_I, ST_DUR_T, ST_DUR_SVC
};

// service FSM at the vehicle's cell, arrival stats and despawns; returns
// the cell's post-transfer tank values through food / waste
__device__ void service_cell(const MegaParams& P, const MegaArgs& A,
                             int* const* dp, float* dpl, int c, float elapsed,
                             const Need& need, Acc& acc) {
  uint32_t pa = (uint32_t)dp[0][c], pd = (uint32_t)dp[3][c];
  const uint32_t pc = (uint32_t)dp[2][c];
  float pl = dpl[c];
  const bool present = pa & 1u;
  const int kind = (int)fld(pa, PA_KIND_SH, 2);
  const int dest14 = (int)fld(pa, PA_DEST_SH, 14);
  const int destid = A.destid[c];
  const bool at_dest = present && destid >= 0 && dest14 == destid;
  const int phase0 = (int)(pd & 3u);
  const float dur = elapsed - (float)fld(pc, 0, 20) * P.dt;
  const int steps = (int)fld(pc, PC_STEPS_SH, 12);
  const bool done_i = at_dest && kind == 0, done_t = at_dest && kind == 1;
  const bool svc_done = at_dest && kind >= 2 && phase0 == 2 && A.exitc[c];
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
  const bool bm = A.b_mask[c] != 0;
  float food = A.tank[0][c], waste = A.tank[1][c];
  const float shortage = (bm && A.b_needs[c]) ? A.b_fcap[c] - food : -1.0f;
  const float surplus = (bm && A.b_prod[c]) ? waste : -1.0f;
  const float give =
      (arrive && kind == 2) ? fminf(pl, fmaxf(shortage, 0.0f)) : 0.0f;
  const float take = (arrive && kind == 3)
                         ? fminf(P.max_waste - pl, fmaxf(surplus, 0.0f))
                         : 0.0f;
  A.tank[0][c] = fminf(fmaxf(food + give, 0.0f), A.b_fcap[c]);
  A.tank[1][c] = fminf(fmaxf(waste - take, 0.0f), A.b_wcap[c]);
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
                          : (go_exit ? A.nexit[c] : dest14);
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
      at_dest && (kind <= 1 || (kind >= 2 && phase == 2 && A.destk1[c]));
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
__device__ void spawn_cell(const MegaParams& P, const MegaArgs& A,
                           int* const* dp, float* dpl, int c, long toff,
                           const int* tk, const Need& need, Acc& acc) {
  const int spe = A.spe[toff + c];
  if (spe >= 0) {
    const uint32_t spa = (uint32_t)A.spa[toff + c];
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

  // block resources (agents/blocks.step_blocks on the planes)
  const bool bm = A.b_mask[c] != 0;
  const bool needs = bm && A.b_needs[c], prod = bm && A.b_prod[c];
  const float inner = A.b_inner[c];
  float food = A.tank[0][c], waste = A.tank[1][c];
  if (P.gradual) {
    float frem = A.tank[2][c] + (needs ? inner * P.frate : 0.0f);
    const float fwhole = floorf(frem);
    food = fmaxf(food - fwhole, 0.0f);
    A.tank[2][c] = frem - fwhole;
    float wrem = A.tank[3][c] + (prod ? inner * P.wrate : 0.0f);
    const float wwhole = floorf(wrem);
    waste = fminf(waste + wwhole, A.b_wcap[c]);
    A.tank[3][c] = wrem - wwhole;
  } else {
    if (needs && tk[6]) food = fmaxf(food - inner, 0.0f);
    if (prod && tk[7]) waste = fminf(waste + inner, A.b_wcap[c]);
  }
  A.tank[0][c] = food;
  A.tank[1][c] = waste;
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

// The R ticks; block j owns `cpt` tiles and the pseudo-groups j, j +
// grid, ...  Dynamic shared memory: K1's state words and work list.
__global__ void __launch_bounds__(THREADS)
    mega_kernel(const MegaParams P, const MegaArgs A, int cpt) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ uint32_t st[];
  int* list = (int*)(st + cpt * THREADS);
  __shared__ TileOrigin org[MAX_CPT];
  __shared__ int nlist;
  __shared__ Best sh_best[2][NWARP];
  __shared__ Need sh_need;
  __shared__ int sh_i[N_STATS][NWARP];
  __shared__ float sh_f[3][NWARP];
  const int H = P.dm.H, W = P.dm.W, G = P.G;
  const int HW = H * W;
  const int tid = threadIdx.x, nslot = cpt * THREADS;
  const int nb = gridDim.x;
  const int* qoff = A.lown;
  const int* loff = qoff + G + 3;
  const int* soff = loff + G + 3;
  const int* qidx = soff + G + 3;
  const int* lidx = qidx + P.NQ;
  const int* sidx = lidx + P.L;
  const Work work(A.work, 1, 0, P.dm);
  K9_MARK(K9_ENTRY);

  // the carried tanks to the block's cells, its groups' queue counts
  // zeroed, the stop plane zeroed
  coop_tiles(P.dm, 1, cpt, org);
  __syncthreads();
  for (int q = tid; q < nslot; q += THREADS) {
    int b, c, y, x;
    if (!slot_cell(P.dm, org, q, b, c, y, x)) continue;
    for (int k = 0; k < 4; ++k) A.tank[k][c] = A.tank0[k][c];
  }
  for (int g = blockIdx.x + tid * nb; g < G; g += THREADS * nb)
    for (int k = 0; k < 5; ++k) A.qcnt[g * 5 + k] = 0;
  for (int c = blockIdx.x * THREADS + tid; c < HW; c += nb * THREADS)
    A.stop[c] = 0;
  K9_MARK(K9_PROLOGUE);
  K9_SYNC(grid);

  for (int t = 0; t < P.R; ++t) {
    const int* tk = A.ticks + t * 8;
    const long toff = (long)t * HW;
    // the tick's inputs: the planes of tick t - 1 (the carried planes
    // at t = 0); no random planes (K9 hashes its draws)
    const int* const* pin = A.p0;
    const float* plin = A.pl0;
    if (t > 0) {
      pin = A.setp[(t - 1) & 1];
      plin = A.setl[(t - 1) & 1];
    }
    const Inputs in{A.sdir4, A.wnd, pin[0], pin[1], pin[2], pin[3], pin[4],
                    plin, A.stop, A.rain + toff, A.ped, A.inter, A.destid,
                    nullptr, nullptr, nullptr, nullptr};
    int* const* dp = A.setp[t & 1];
    float* dpl = A.setl[t & 1];
    const Outputs out{dp[0], dp[1], dp[2], dp[3], dp[4], dpl, nullptr};

    // lights, on the block's groups: queue counts, a warp per run and a
    // lane per cell
    for (int g = blockIdx.x; g <= G; g += nb)
      for (int i = qoff[g] + (tid >> 5); i < qoff[g + 1]; i += NWARP) {
        const int* q = A.qrun + qidx[i] * 6;
        const int n = run_len(q, H, W);
        if (n <= 0) continue;
        int cnt = 0;
        for (int k = tid & 31; k < n; k += 32)
          cnt += in.pa[run_cell(q, k, W)] & 1;
        cnt = __reduce_add_sync(0xFFFFFFFFu, cnt);
        const int w8 = ((cnt + 128) & 255) - 128;
        if ((tid & 31) == 0 && w8) atomicAdd(&A.qcnt[q[4] * 5 + q[5]], w8);
      }
    __syncthreads();
    K9_MARK(K9_QUEUE);
    // the controllers and phase commits (tick t reads the light rows of
    // tick t - 1 and writes buffer (t + 1) & 1)
    {
      const int* li = t == 0 ? A.li0 : A.li[t & 1];
      const float* lf = t == 0 ? A.lf0 : A.lf[t & 1];
      for (int g = blockIdx.x + tid * nb; g < G; g += THREADS * nb)
        group_step(P, A, g, li, lf, A.li[(t + 1) & 1], A.lf[(t + 1) & 1]);
    }
    __syncthreads();
    K9_MARK(K9_GROUPS);
    // the lights, then the stopped lights' runs painted
    for (int g = blockIdx.x; g <= G; g += nb)
      for (int i = loff[g] + tid; i < loff[g + 1]; i += THREADS)
        light_step(P, A, lidx[i], t == 0, t == 0 ? A.lstop0 : A.lstop);
    __syncthreads();
    K9_MARK(K9_LIGHTS);
    for (int g = blockIdx.x; g <= G; g += nb)
      fill_runs(A.stop, A.srun, sidx, soff[g], soff[g + 1], A.lstop, H, W, 1);
    K9_MARK(K9_PAINT);
    // the block's candidates for the neediest blocks before the transfers
    {
      Best bf = best_init(), bw = best_init();
      for (int q = tid; q < nslot; q += THREADS) {
        int b, c, y, x;
        if (!slot_cell(P.dm, org, q, b, c, y, x)) continue;
        need_cell(A, c, A.tank[0][c], A.tank[1][c], bf, bw);
      }
      block_best(bf, bw, sh_best);
      if (tid == 0) store_best(A.am + blockIdx.x * AM_WORDS, bf, bw);
    }
    K9_MARK(K9_NEED);
    K9_SYNC(grid);

    // decide + move
    const Need need1 = reduce_need(A.am, nb, tk[5], sh_best, &sh_need);
    const HashDraws dr{(uint32_t)tk[0], (uint32_t)tk[1], (uint32_t)tk[2],
                       (uint32_t)tk[3], P.min_speed,
                       P.dm.max_speed - P.min_speed + 1};
    coop_move<GridSelect, HashDraws, true>(P.dm, in, A.work, 1, cpt, org,
                                           st, list, nlist, GridSelect(), dr,
                                           grid);
    __syncthreads();

    // finish, service FSM and despawns on the block's cells, against the
    // tanks before the transfers
    Acc acc;
    for (int k = 0; k < N_STATS; ++k) acc.n[k] = 0;
    for (int k = 0; k < 3; ++k) acc.dur[k] = 0.0f;
    const float elapsed = A.elapsed[t];
    {
      Best bf = best_init(), bw = best_init();
      for (int q = tid; q < nslot; q += THREADS) {
        int b, c, y, x;
        if (!slot_cell(P.dm, org, q, b, c, y, x)) continue;
        const int flags =
            coop_finish(P.dm, in, work, c, y, x, st[q], out, 0, GridSelect());
        acc.n[ST_NEW_MAL] += flags & 1;
        acc.n[ST_NEW_COL] += (flags >> 1) & 1;
        service_cell(P, A, dp, dpl, c, elapsed, need1, acc);
        need_cell(A, c, A.tank[0][c], A.tank[1][c], bf, bw);
      }
      block_best(bf, bw, sh_best);
      if (tid == 0)
        store_best(A.am + (P.nbmax + blockIdx.x) * AM_WORDS, bf, bw);
    }
    K9_MARK(K9_FINISH_SERVICE);
    K9_SYNC(grid);

    // spawns against the tanks after the transfers, block tanks, stats;
    // the block's stop runs cleared for the next tick's paint
    const Need need2 =
        reduce_need(A.am + P.nbmax * AM_WORDS, nb, tk[5], sh_best, &sh_need);
    for (int q = tid; q < nslot; q += THREADS) {
      int b, c, y, x;
      if (!slot_cell(P.dm, org, q, b, c, y, x)) continue;
      spawn_cell(P, A, dp, dpl, c, toff, tk, need2, acc);
    }
    K9_MARK(K9_SPAWN);
    const long prow = (long)t * P.nbmax + blockIdx.x;
    store_stats(acc, A.st_i + prow * N_STATS, A.st_f + prow * 4, sh_i, sh_f);
    if (t + 1 < P.R)
      for (int g = blockIdx.x; g <= G; g += nb)
        fill_runs(A.stop, A.srun, sidx, soff[g], soff[g + 1], nullptr, H, W,
                  0);
    K9_MARK(K9_STATS);
    K9_SYNC(grid);
  }

  // the stats rows: block partials in block order
  if (blockIdx.x == 0)
    for (int i = tid; i < P.R * N_STATS; i += THREADS) {
      const int t = i / N_STATS, k = i % N_STATS;
      const int fk = k == ST_DUR_I ? 0 : k == ST_DUR_T ? 1
                   : k == ST_DUR_SVC ? 2 : -1;
      float v;
      if (fk >= 0) {
        v = 0.0f;
        for (int b = 0; b < nb; ++b)
          v += A.st_f[((long)t * P.nbmax + b) * 4 + fk];
      } else {
        int s = 0;
        for (int b = 0; b < nb; ++b)
          s += A.st_i[((long)t * P.nbmax + b) * N_STATS + k];
        v = (float)s;
      }
      A.stats[i] = v;
    }
#ifdef TSIM_K9_MARKS
  K9_MARK(K9_FOLD);
  if (tid == 0) atomicMax(&k9_end, k9_now());
#endif
}

// the largest dynamic shared memory the kernel takes, set once per
// device
static cudaError_t mega_attr() {
  static bool done[8];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 8 && done[dev])) return e;
  e = cudaFuncSetAttribute(mega_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)coop_smem(MAX_CPT));
  if (e == cudaSuccess && dev < 8) done[dev] = true;
  return e;
}

// the cooperative grid of an H x W world on this card: the fewest tiles
// a block (a power of two) whose resident grid holds every tile
static cudaError_t mega_grid(int H, int W, int* grid, int* cpt) {
  int dev = 0, nsm = 0;
  cudaError_t e = mega_attr();
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long ntiles =
      (long)((W + TILE_W - 1) / TILE_W) * ((H + TILE_H - 1) / TILE_H);
  for (int c = 1; c <= MAX_CPT; c *= 2) {
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mega_kernel, THREADS, coop_smem(c));
    if (e != cudaSuccess) return e;
    const long n = (long)per_sm * nsm;
    if (n * c < ntiles) continue;
    *grid = (int)(n < ntiles ? n : ntiles);
    *cpt = c;
    return cudaSuccess;
  }
  return cudaErrorCooperativeLaunchTooLarge;
}

}  // namespace tsim

extern "C" int tsim_mega_segment(const int* ip, const float* fp,
                                 void* const* ptr, int nptr, int grid,
                                 int cpt, void* stream) {
  using namespace tsim;
  if (nptr != N_PTRS || grid < 1 || cpt < 1 || cpt > MAX_CPT)
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
  P.nbmax = grid;
  P.dt = fp[2];
  P.max_food = fp[3];
  P.max_waste = fp[4];
  P.frate = fp[5];
  P.wrate = fp[6];

  int i = 0;
  auto I = [&]() { return (const int*)ptr[i++]; };
  auto F = [&]() { return (const float*)ptr[i++]; };
  auto U = [&]() { return (const uint8_t*)ptr[i++]; };
  MegaArgs A;
  A.sdir4 = I();
  A.wnd = I();
  A.inter = U();
  A.destid = I();
  A.destk1 = I();
  A.nexit = I();
  A.exitc = I();
  A.b_mask = I();
  A.b_ok = I();
  A.b_bid = I();
  A.b_svcd = I();
  A.b_needs = I();
  A.b_prod = I();
  A.b_inner = F();
  A.b_fcap = F();
  A.b_wcap = F();
  A.qrun = I();
  A.srun = I();
  A.l_group = I();
  A.l_axis = I();
  A.gvalid = I();
  A.nbrg = I();
  A.ticks = I();
  A.elapsed = F();
  A.rain = U();
  A.spa = I();
  A.spe = I();
  A.force = I();
  for (int k = 0; k < 5; ++k) A.p0[k] = I();
  A.pl0 = F();
  for (int k = 0; k < 4; ++k) A.tank0[k] = F();
  A.li0 = I();
  A.lf0 = F();
  A.lstop0 = U();
  A.lown = I();
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

  cudaError_t e = mega_attr();
  if (e != cudaSuccess) return (int)e;
  void* args[] = {(void*)&P, (void*)&A, (void*)&cpt};
  e = cudaLaunchCooperativeKernel((const void*)mega_kernel, dim3(grid),
                                  dim3(THREADS), args, coop_smem(cpt),
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the grid and the tiles a block (out[0], out[1]) the launch above takes
// for an H x W world on this card
extern "C" int tsim_mega_grid(int H, int W, int* out) {
  return (int)tsim::mega_grid(H, W, out, out + 1);
}

// the grid barriers K9's launches have passed since the last call
// (*n), counted by block 0; then zeroed
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

