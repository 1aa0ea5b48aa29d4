// The cooperative decide + move of one tick, shared by K1
// (decide_move.cu: one launch a tick) and K9 (megakernel.cu: R ticks in
// one launch).  See decide_move.cu for the design: a persistent grid of
// resident blocks that own fixed 32 x 8 tiles (`cpt` a block) in every
// phase, per-cell state words and per-phase work lists in the block's
// shared memory, one working set of vehicle planes written only where a
// vehicle stands, and one `pub` byte per cell through which neighbours
// see each other; 2K grid barriers a tick (decide, then K x (intent,
// commit); the finish reads only the block's own cells).
//
// The random draws of a cell come through a `Draws` functor: K1 reads
// the tick's random planes (`PlaneDraws`), K9 hashes them from the
// tick's seeds.  `COOP_MARK(i, code)` is the timeline hook of the
// including file (K1's mark index i, K9's stage code; empty unless that
// file defines it before including this header), `COOP_SYNC(grid)` its
// grid barrier (grid.sync() unless it defines another).
#pragma once

#include <cooperative_groups.h>

#include "decide_move.cuh"

#ifndef COOP_MARK
#define COOP_MARK(i, code) \
  do {                     \
  } while (0)
#endif
#ifndef COOP_SYNC
#define COOP_SYNC(grid) grid.sync()
#endif

namespace cg = cooperative_groups;

namespace tsim {

// K1's working planes per world: the vehicle planes, the steps left and
// the keys (int32), then, after every world's, one `pub` byte per cell
enum { W_PA, W_PB, W_PC, W_PD, W_PE, W_PL, W_STEPS, W_KEY, N_WORK };
// the pub byte: bits 0..1 the key's direction, 2 a key (else KINF), 3
// want, 4 contraflow (the intent's info word is bits 3..4), 5 occupied
// by a vehicle that arrived this tick
constexpr uint32_t PUB_KEY = 4u, PUB_WANT = 8u, PUB_CONTRA = 16u,
                   PUB_ARR = 32u, PUB_INTENT = 31u;

// the per-cell state word: the decide aux word in bits 0..16, then
constexpr uint32_t C_AUX = 0x1FFFFu;
constexpr uint32_t C_HALT = 1u << 17, C_MOVED = 1u << 18,
                   C_FRESH = 1u << 19, C_PRESENT = 1u << 20,
                   C_NEVER = 1u << 21;
// the pub byte the cell last wrote (bits 22..27)
constexpr int C_PUB = 22;
constexpr uint32_t C_PUB_MASK = 63u << C_PUB;
// a key won at this cell in this sub-round (bit 28), from direction m
// (bits 29..30); a vehicle left the cell (bit 31)
constexpr uint32_t C_PULL = 1u << 28;
constexpr int C_PULL_M = 29;
constexpr uint32_t C_VAC = 1u << 31;

constexpr int TILE_W = 32, TILE_H = THREADS / TILE_W;

// most tiles a block owns (2 x 4 bytes of shared memory per cell)
constexpr int MAX_CPT = 64;

// where a block's tile lies: world b (-1 past the last tile), origin
struct TileOrigin {
  int b, y0, x0;
};

// the block's cell q (tile q / THREADS, lane q % THREADS): world b, flat
// index c, (y, x); false past the grid's edge
__device__ __forceinline__ bool slot_cell(const DMParams& p,
                                          const TileOrigin* org, int q,
                                          int& b, int& c, int& y, int& x) {
  const TileOrigin o = org[q / THREADS];
  const int i = q % THREADS;
  b = o.b;
  y = o.y0 + i / TILE_W;
  x = o.x0 + i % TILE_W;
  c = y * p.W + x;
  return b >= 0 && y < p.H && x < p.W;
}

// world b's working planes, and its pub bytes
struct Work {
  int* S;
  uint8_t* pub;
  long hw;
  __device__ __forceinline__ Work(int* S0, int B, int b, const DMParams& p)
      : hw((long)p.H * p.W) {
    S = S0 + (long)b * N_WORK * hw;
    pub = (uint8_t*)(S0 + (long)B * N_WORK * hw) + (long)b * hw;
  }
  __device__ __forceinline__ int* plane(int k) const { return S + k * hw; }
};

// world b's view of the inputs the decide core reads (the geometry
// advances only where it is one plane a world, p.geo)
__device__ __forceinline__ Inputs world_inputs(Inputs in, int b, long hw,
                                               const DMParams& p) {
  const long o = (long)b * hw;
  in.sdir4 += o * p.D4;
  if (p.geo) {
    in.inter += o;
    in.dest_id += o;
  }
  in.wnd += o;
  in.pa += o;
  in.pb += o;
  in.pc += o;
  in.pd += o;
  in.pe += o;
  in.pl += o;
  in.stop += o;
  in.rain += o;
  in.ped += o;
  in.r_mal += o;
  in.r_side += o;
  in.r_reroll += o;
  in.r_prio += o;
  return in;
}

// the decide phase at a cell that holds a vehicle: its planes, and its
// state word
template <class Select, class Draws>
__device__ __forceinline__ uint32_t coop_decide(const DMParams& p,
                                                const Inputs& in,
                                                const Work& w, int c, int y,
                                                int x, const Select& sel,
                                                const Draws& dr) {
  const int pc = ld_tick(in.pc + c), pe = ld_tick(in.pe + c);
  const int pl = __float_as_int(ld_tick(in.pl + c));
  const Decided d = dm_decide_core<Select, DM_VEHICLE>(
      p, in, c, y, x, dr.mal(in, c), dr.side(in, c), dr.reroll(in, c), sel);
  w.plane(W_PA)[c] = (int)d.pa;
  w.plane(W_PB)[c] = (int)d.pb;
  w.plane(W_PC)[c] = pc;
  w.plane(W_PD)[c] = (int)d.pd;
  w.plane(W_PE)[c] = pe;
  w.plane(W_PL)[c] = pl;
  w.plane(W_STEPS)[c] = d.steps;
  return (uint32_t)d.aux | (d.halted ? C_HALT : 0u) | C_FRESH | C_PRESENT |
         C_NEVER;
}

// the intent of the vehicle at cell c whose state word is s
// (dm_intent_cell's rule): publishes its key and pub byte where they
// change
template <class Select, class Draws>
__device__ __forceinline__ uint32_t coop_intent(const DMParams& p,
                                                const Inputs& in,
                                                const Work& w, int c, int y,
                                                int x, uint32_t s,
                                                const Select& sel,
                                                const Draws& dr) {
  // every load that needs no other first, then the select, then the
  // target's
  const uint32_t pa = (uint32_t)w.plane(W_PA)[c];
  const uint32_t pb = (uint32_t)w.plane(W_PB)[c];
  const uint32_t pd = (uint32_t)w.plane(W_PD)[c];
  const int steps = w.plane(W_STEPS)[c];
  const int did = ld_tick(in.dest_id + c);
  const uint32_t wnd = (uint32_t)ld_tick(in.wnd + c);
  const uint32_t prio = ((uint32_t)dr.prio(in, c) >> 4) & 0x0FFFFFF8u;
  const int dest_c = (int)fld(pa, PA_DEST_SH, 14);
  const int nd = sel(p, in, dest_c, c, y, x);
  const int h1 = (int)fld(pa, PA_HEAD_SH, 3);
  const bool at_dest_c = did >= 0 && dest_c == did;
  const int csteps = (int)fld(pd, PD_CFSTEPS_SH, 5);
  const int climit = bit(pd, PD_CFMODE_SH) ? p.detour_steps : p.ovt_steps;
  const bool allow = fld(pb, PB_CONTRA_SH, 8) > 0 && csteps < climit;
  int dir;
  bool contra;
  resolve(nd, h1, true, allow, wnd, (int)fld(pd, PD_CFKEY_SH, 2), dir,
          contra);
  const bool can_dir = dir < 7 && (!contra || allow);
  const bool want = !(s & C_HALT) && steps > 0 && !at_dest_c;
  bool blocked_t = false;
  if (dir < 4) {
    const int t = nbr(y, x, dir, p.H, p.W);
    if (t >= 0) {
      const bool t_stop = ld_tick(in.stop + t);
      const bool t_ped = ld_tick(in.ped + t);
      const uint32_t t_pub = w.pub[t], t_pa = (uint32_t)ld_tick(in.pa + t);
      blocked_t = t_stop || (t_pub & PUB_ARR) || (t_pa & 1u) || t_ped;
    } else {
      blocked_t = true;
    }
  }
  // directions 4..6 (possible only from malformed bytes) pass `can_dir`
  // but, as in the reference, never send a key
  const bool can = want && can_dir && !blocked_t && dir < 4;
  const uint32_t old = (s & C_PUB_MASK) >> C_PUB;
  const uint32_t pub = (can ? PUB_KEY | (uint32_t)dir : 0u) |
                       (want ? PUB_WANT : 0u) | (contra ? PUB_CONTRA : 0u) |
                       (old & PUB_ARR);
  if (pub != old) {
    if (can) w.plane(W_KEY)[c] = (int)prio | dir;
    w.pub[c] = (uint8_t)pub;
    s = (s & ~C_PUB_MASK) | (pub << C_PUB);
  }
  return s & ~C_FRESH;
}

// the lowest key aimed at (y, x) (min_incoming), read through the pub
// bytes: a key word only where a neighbour's byte says it aims here
__device__ __forceinline__ int coop_min_incoming(const DMParams& p,
                                                 const Work& w, int y,
                                                 int x) {
  int n[4];
  uint32_t b[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    n[m] = nbr(y, x, opposite(m), p.H, p.W);
    b[m] = n[m] >= 0 ? w.pub[n[m]] : 0u;
  }
  int mk = KINF;
#pragma unroll
  for (int m = 0; m < 4; ++m)
    if ((b[m] & PUB_KEY) && (int)(b[m] & 3u) == m)
      mk = min(mk, w.plane(W_KEY)[n[m]]);
  return mk;
}

// the commit at a cell with a key or an incoming key (dm_commit_cell's
// rule): resolve its own key; a vehicle that won leaves the cell, a key
// won here moves its vehicle in
__device__ __forceinline__ uint32_t coop_commit(const DMParams& p,
                                                const Work& w, int c, int y,
                                                int x, uint32_t s) {
  const uint32_t pub = (s & C_PUB_MASK) >> C_PUB;
  bool won = false;
  if (pub & PUB_KEY) {
    const int kc = w.plane(W_KEY)[c];
    const int ty = y + dir_dy((int)(pub & 3u));
    const int tx = x + dir_dx((int)(pub & 3u));
    won = ty >= 0 && ty < p.H && tx >= 0 && tx < p.W &&
          coop_min_incoming(p, w, ty, tx) == kc;
  }
  if (s & C_PULL) {
    const int m = (int)((s >> C_PULL_M) & 3u);
    const int src = nbr(y, x, opposite(m), p.H, p.W);
    const uint32_t spa = (uint32_t)w.plane(W_PA)[src];
    const uint32_t spc = (uint32_t)w.plane(W_PC)[src];
    uint32_t spd = (uint32_t)w.plane(W_PD)[src];
    if (w.pub[src] & PUB_CONTRA)
      spd = (spd & CFS_CLR) |
            (min(fld(spd, PD_CFSTEPS_SH, 5) + 1u, 31u) << PD_CFSTEPS_SH);
    w.plane(W_PA)[c] =
        (int)((spa & HEAD_CLR) | ((uint32_t)(m + 1) << PA_HEAD_SH));
    w.plane(W_PB)[c] = w.plane(W_PB)[src];
    w.plane(W_PC)[c] =
        (int)((min(fld(spc, PC_STEPS_SH, 12) + 1u, 4095u) << PC_STEPS_SH) |
              (spc & ((1u << PC_STEPS_SH) - 1u)));
    w.plane(W_PD)[c] = (int)spd;
    w.plane(W_PE)[c] = w.plane(W_PE)[src];
    w.plane(W_PL)[c] = w.plane(W_PL)[src];
    w.plane(W_STEPS)[c] = w.plane(W_STEPS)[src] - 1;
    // an empty cell has published nothing: its byte becomes "arrived"
    w.pub[c] = (uint8_t)PUB_ARR;
    s = (s & ~(C_PUB_MASK | C_PULL | (3u << C_PULL_M))) | C_MOVED |
        C_PRESENT | C_FRESH | (PUB_ARR << C_PUB);
  } else if (won) {
    // the planes left behind are zero (no write: the finish knows);
    // the pub byte keeps what neighbours read in this sub-round
    if (pub & PUB_ARR) w.pub[c] = (uint8_t)(pub & PUB_INTENT);
    s = (s & ~(C_MOVED | C_PRESENT | (PUB_ARR << C_PUB))) | C_VAC;
  }
  // the info word's `want` without the win: halted from now on
  if ((pub & PUB_WANT) && !won) s |= C_HALT;
  return s;
}

// writes the cell's final planes at out.*[o + c] and returns its flags
// (dm_finish_cell's rule on the cell's last planes: those a vehicle
// stands on, zero where one left, the decide's where none ever stood;
// the start-of-tick move check only where it can reset the speed)
template <class Select>
__device__ __forceinline__ int coop_finish(const DMParams& p,
                                           const Inputs& in, const Work& w,
                                           int c, int y, int x, uint32_t s,
                                           const Outputs& out, long o,
                                           const Select& sel) {
  const bool moved = s & C_MOVED;
  const bool present = s & C_PRESENT;
  const int aux = (int)(s & C_AUX);
  uint32_t pa = 0, pb = 0;
  int pc = 0, pd = 0, pe = 0, pl = 0;
  // a vehicle that has not moved may lose its speed: the inputs of that
  // check with its planes
  const bool check = present && !moved;
  const bool stop_c = check && ld_tick(in.stop + c);
  const uint32_t wnd = check ? (uint32_t)ld_tick(in.wnd + c) : 0u;
  if (present) {
    pa = (uint32_t)w.plane(W_PA)[c];
    pb = (uint32_t)w.plane(W_PB)[c];
    pc = w.plane(W_PC)[c];
    pd = w.plane(W_PD)[c];
    pe = w.plane(W_PE)[c];
    pl = w.plane(W_PL)[c];
  } else if (!(s & C_VAC)) {
    const Decided d =
        dm_decide_core<Select, DM_EMPTY>(p, in, c, y, x, 0.0f, 0.0f, 0, sel);
    pa = d.pa;
    pb = d.pb;
    pc = ld_tick(in.pc + c);
    pd = (int)d.pd;
    pe = ld_tick(in.pe + c);
    pl = __float_as_int(ld_tick(in.pl + c));
  }
  if (check) {
    const int nd0 = aux & 0xFF, head1 = (aux >> 8) & 7;
    const bool ct_pos = (aux >> 11) & 1;
    const int wkey_dec = (aux >> 12) & 3;
    const bool at_dest0 = (aux >> 14) & 1;
    int dir0r;
    bool contra0r;
    resolve(nd0, head1, true, ct_pos, wnd, wkey_dec, dir0r, contra0r);
    bool tgt_blocked0 = false;
    if (dir0r < 4) {
      const int t = nbr(y, x, dir0r, p.H, p.W);
      if (t >= 0) {
        const bool t_stop = ld_tick(in.stop + t);
        const bool t_ped = ld_tick(in.ped + t);
        const uint32_t t_pa = (uint32_t)ld_tick(in.pa + t);
        tgt_blocked0 = t_stop || (t_pa & 1u) || t_ped;
      } else {
        tgt_blocked0 = true;
      }
    }
    const bool allow0 = fld(pb, PB_CONTRA_SH, 8) > 0;
    const bool fb0 = at_dest0 || dir0r == 7 || (contra0r && !allow0) ||
                     tgt_blocked0;
    if (fb0) pa &= ~(15u << PA_BASE_SH);
  }

  // stuck bookkeeping
  int stuck_v = (int)fld(pb, PB_STUCK_SH, 12);
  const bool stuck_inc = check && !stop_c;
  stuck_v = (present && moved) ? 0
                               : (stuck_inc ? min(stuck_v + 1, 4095) : stuck_v);
  bool stuckf = bit(pa, PA_STUCKF_SH);
  stuckf = !(present && moved) && (stuck_v > p.recompute_thresh || stuckf);
  pa = (pa & ~(1u << PA_STUCKF_SH)) | ((uint32_t)stuckf << PA_STUCKF_SH);
  pb = (pb & ~4095u) | (uint32_t)stuck_v;

  out.pa[o + c] = (int)pa;
  out.pb[o + c] = (int)pb;
  out.pc[o + c] = pc;
  out.pd[o + c] = pd;
  out.pe[o + c] = pe;
  out.pl[o + c] = __int_as_float(pl);
  return ((aux >> 15) & 1) | (((aux >> 16) & 1) << 1) | (moved ? 4 : 0);
}

// K1's draws: the tick's random planes of the world `in` points at
struct PlaneDraws {
  __device__ __forceinline__ float mal(const Inputs& in, int c) const {
    return ld_tick(in.r_mal + c);
  }
  __device__ __forceinline__ float side(const Inputs& in, int c) const {
    return ld_tick(in.r_side + c);
  }
  __device__ __forceinline__ int reroll(const Inputs& in, int c) const {
    return ld_tick(in.r_reroll + c);
  }
  __device__ __forceinline__ int prio(const Inputs& in, int c) const {
    return ld_tick(in.r_prio + c);
  }
};


// the tiles of block blockIdx.x: tile blockIdx.x + k * gridDim.x for
// k < cpt, in the B worlds b0 .. b0 + B - 1 of H x W (call with every
// thread, then sync)
__device__ __forceinline__ void coop_tiles(const DMParams& p, int B, int cpt,
                                           TileOrigin* org, int b0 = 0) {
  const int tx = (p.W + TILE_W - 1) / TILE_W;
  const int per_world = tx * ((p.H + TILE_H - 1) / TILE_H);
  if ((int)threadIdx.x < cpt) {
    const int tile = blockIdx.x + threadIdx.x * gridDim.x;
    const int b = tile / per_world, r = tile - b * per_world;
    org[threadIdx.x] = TileOrigin{tile < B * per_world ? b0 + b : -1,
                                  (r / tx) * TILE_H, (r % tx) * TILE_W};
  }
}

// shared memory of a block that owns cpt tiles: the state words and the
// work list
inline size_t coop_smem(int cpt) {
  return (size_t)cpt * THREADS * 2 * sizeof(uint32_t);
}

// The decide and the K sub-rounds of one tick of B worlds, by every
// thread of every block of the cooperative grid; the block's state words
// `st` (its cells' in tile order) are left for the caller's finish, which
// needs no grid barrier first.  `list` is the work list, `nlist` its
// length, both in shared memory.  With kOneWorld (B = 1) every phase
// reads `in0` itself: K9 builds its Inputs in the kernel, and a copy of
// that struct through `world_inputs` was compiled to read other memory.
template <class Select, class Draws, bool kOneWorld = false>
__device__ __forceinline__ void coop_move(const DMParams& p,
                                          const Inputs& in0, int* S0, int B,
                                          int cpt, const TileOrigin* org,
                                          uint32_t* st, int* list,
                                          int& nlist, const Select& sel,
                                          const Draws& dr,
                                          cg::grid_group& grid) {
  const int tid = threadIdx.x, nslot = cpt * THREADS;
  const long hw = (long)p.H * p.W;
  __syncthreads();
  if (tid == 0) nlist = 0;
  COOP_MARK(0, -1);
  __syncthreads();

  // decide: every cell's pub byte cleared and state word set, the
  // vehicles listed
  for (int q = tid; q < nslot; q += THREADS) {
    int b, c, y, x;
    st[q] = 0;
    if (!slot_cell(p, org, q, b, c, y, x)) continue;
    const long g = (long)b * hw + c;
    const uint32_t pa = (uint32_t)ld_tick(in0.pa + g);
    Work(S0, B, b, p).pub[c] = 0;
    if (pa & 1) {
      list[atomicAdd(&nlist, 1)] = q;
    } else {
      // an empty cell: halted when its parked bit is set
      const bool never = ld_tick(in0.stop + g) || ld_tick(in0.ped + g);
      st[q] = (bit(pa, PA_PARKED_SH) ? C_HALT : 0u) | (never ? C_NEVER : 0u);
    }
  }
  __syncthreads();
  COOP_MARK(1, -1);
  for (int j = tid; j < nlist; j += THREADS) {
    const int q = list[j];
    int b, c, y, x;
    slot_cell(p, org, q, b, c, y, x);
    if constexpr (kOneWorld)
      st[q] = coop_decide(p, in0, Work(S0, 1, 0, p), c, y, x, sel, dr);
    else
      st[q] = coop_decide(p, world_inputs(in0, b, hw, p),
                          Work(S0, B, b, p), c, y, x, sel, dr);
  }
  COOP_MARK(2, K9_DECIDE);
  COOP_SYNC(grid);
  COOP_MARK(3, -1);

  for (int r = 0; r < p.max_speed; ++r) {
    // intent: a vehicle new on its cell (decided or arrived since the
    // last intent) listed.  Any other vehicle did not move in the last
    // commit, so either it wanted to and is halted now (its key and want
    // withdrawn; its contraflow bit, of its planes and cell alone, stays)
    // or it did not want to, which nothing it reads has changed since.
    // An empty cell withdraws what it published.
    __syncthreads();
    if (tid == 0) nlist = 0;
    __syncthreads();
    for (int q = tid; q < nslot; q += THREADS) {
      const uint32_t s = st[q];
      int b, c, y, x;
      if (!slot_cell(p, org, q, b, c, y, x)) continue;
      const uint32_t pub = (s & C_PUB_MASK) >> C_PUB;
      uint32_t now = pub;
      if (s & C_FRESH)
        list[atomicAdd(&nlist, 1)] = q;
      else if (!(s & C_PRESENT))
        now = 0;
      else if (s & C_HALT)
        now = pub & (PUB_CONTRA | PUB_ARR);
      if (now != pub) {
        Work(S0, B, b, p).pub[c] = (uint8_t)now;
        st[q] = (s & ~C_PUB_MASK) | (now << C_PUB);
      }
    }
    __syncthreads();
    COOP_MARK(4 + 6 * r, -1);
    for (int j = tid; j < nlist; j += THREADS) {
      const int q = list[j];
      int b, c, y, x;
      slot_cell(p, org, q, b, c, y, x);
      if constexpr (kOneWorld)
        st[q] = coop_intent(p, in0, Work(S0, 1, 0, p), c, y, x, st[q], sel,
                            dr);
      else
        st[q] = coop_intent(p, world_inputs(in0, b, hw, p),
                            Work(S0, B, b, p), c, y, x, st[q], sel, dr);
    }
    COOP_MARK(5 + 6 * r, K9_INTENT);
    COOP_SYNC(grid);
    COOP_MARK(6 + 6 * r, -1);

    // commit: incoming keys found at every cell that can be a target (a
    // key aims only at a cell that is empty now and was at the start of
    // the tick, and neither stopped nor blocked by pedestrians); the
    // cells with a key or an incoming key listed
    if (tid == 0) nlist = 0;
    __syncthreads();
    for (int q = tid; q < nslot; q += THREADS) {
      uint32_t s = st[q];
      int b, c, y, x;
      if (!slot_cell(p, org, q, b, c, y, x)) continue;
      if (!(s & (C_PRESENT | C_NEVER))) {
        const int mk = coop_min_incoming(p, Work(S0, B, b, p), y, x);
        if (mk != KINF) s |= C_PULL | ((uint32_t)(mk & 3) << C_PULL_M);
      }
      if (s & (C_PULL | (PUB_KEY << C_PUB))) {
        list[atomicAdd(&nlist, 1)] = q;
        st[q] = s;
      } else if (s & (PUB_WANT << C_PUB)) {
        st[q] = s | C_HALT;   // wanted to move, published no key
      }
    }
    __syncthreads();
    COOP_MARK(7 + 6 * r, -1);
    for (int j = tid; j < nlist; j += THREADS) {
      const int q = list[j];
      int b, c, y, x;
      slot_cell(p, org, q, b, c, y, x);
      st[q] = coop_commit(p, Work(S0, B, b, p), c, y, x, st[q]);
    }
    COOP_MARK(8 + 6 * r, K9_COMMIT);
    // the next intent reads the neighbours' committed bytes; the finish
    // reads only the block's own cells
    if (r + 1 < p.max_speed) COOP_SYNC(grid);
    COOP_MARK(9 + 6 * r, -1);
  }

}

}  // namespace tsim
