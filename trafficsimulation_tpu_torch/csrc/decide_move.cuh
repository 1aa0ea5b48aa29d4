// The parameters, inputs, row selects and decide core of one tick's
// decide + move, shared by K1 (decide_move.cu), K7 (decide_tiled.cu) and
// K9 (megakernel.cu), which all run the phases of coop.cuh:
//
//   decide      start-of-tick faults, halts, speed, contraflow ladder
//               (`dm_decide_core`): a vehicle's planes, its halt latch
//               and an aux word
//   intent  x K publishes each mover's conflict key (priority | dir)
//   commit  x K every cell takes the lowest key aimed at it (reading
//               keys up to two cells away to know whether its own
//               vehicle won elsewhere) and pulls the winner's planes in
//   finish      base-speed reset, stuck bookkeeping, flags
//
// `in` points at one world's planes.  The random draws of a cell arrive
// as values (K1 and K7 read them from planes, K9 hashes them from the
// tick's seeds).  The destination row select is one indexed load: byte
// (dest & 3) of sdir4[dest >> 2], ND_NONE when dest >> 2 is past the
// stack; the phases take it as a functor (`GridSelect` on the whole
// grid, `HierSelect` under hierarchical routing, K7's window select in
// decide_tiled.cu).  Neighbour reads outside the grid see the fills of
// the padded shifts they replace: blocked (0xF) for the target byte,
// KINF for keys, false for arrivals and sideswipe neighbours, true for
// the start-of-tick blocked byte.
#pragma once

#include "common.cuh"

namespace tsim {

struct DMParams {
  int H, W, D4;
  int geo;  // 1: intersection and dest_id one plane a world, 0: shared
  int mal_active, side_active, rain_enabled, ovt_active, stuck_cf_enabled;
  int mal_duration, side_duration, rain_reduction;
  int stuck_cf_thresh, stuck_cf_thresh_inter;
  int detour_duration, ovt_duration, detour_steps, ovt_steps;
  int recompute_thresh, max_speed;
  float mal_chance, side_chance;
};

// the 16 int and 2 float parameters in the order of the Python side's
// `_dm_params`
inline DMParams dm_params(const int* ip, const float* fp, int H, int W,
                          int D4) {
  DMParams p;
  p.H = H;
  p.W = W;
  p.D4 = D4;
  p.geo = 0;
  p.mal_active = ip[0];
  p.side_active = ip[1];
  p.rain_enabled = ip[2];
  p.ovt_active = ip[3];
  p.stuck_cf_enabled = ip[4];
  p.mal_duration = ip[5];
  p.side_duration = ip[6];
  p.rain_reduction = ip[7];
  p.stuck_cf_thresh = ip[8];
  p.stuck_cf_thresh_inter = ip[9];
  p.detour_duration = ip[10];
  p.ovt_duration = ip[11];
  p.detour_steps = ip[12];
  p.ovt_steps = ip[13];
  p.recompute_thresh = ip[14];
  p.max_speed = ip[15];
  p.mal_chance = fp[0];
  p.side_chance = fp[1];
  return p;
}

constexpr uint32_t CF_CLEAR = ~(0xFFu << PD_CFKEY_SH);
constexpr uint32_t CLEAR_A = ~((15u << PA_BASE_SH) | (15u << PA_CUR_SH) |
                               (1u << PA_COL_SH) | (1u << PA_MAL_SH));
constexpr uint32_t HEAD_CLR = ~(7u << PA_HEAD_SH);
constexpr uint32_t CFS_CLR = ~(31u << PD_CFSTEPS_SH);

struct Inputs {
  const int* sdir4;
  const int* wnd;
  const int* pa;  // start-of-tick planes (never written)
  const int* pb;
  const int* pc;
  const int* pd;
  const int* pe;
  const float* pl;
  const uint8_t* stop;
  const uint8_t* rain;
  const uint8_t* ped;
  const uint8_t* inter;
  const int* dest_id;
  const float* r_mal;  // K1's random planes (K9 passes none)
  const float* r_side;
  const int* r_reroll;
  const int* r_prio;
};

struct Outputs {
  int* pa;
  int* pb;
  int* pc;
  int* pd;
  int* pe;
  float* pl;
  int* flags;
};

__device__ __forceinline__ int select_nd(const int* sdir4, int D4, int HW,
                                         int dest, int c) {
  const int hi = dest >> 2;
  const uint32_t w =
      (hi >= 0 && hi < D4) ? (uint32_t)sdir4[(long)hi * HW + c] : ND_NONE4;
  return (int)((w >> ((dest & 3) * 8)) & 0xFFu);
}

// the select of a whole grid: row `dest` of the stack at cell c
struct GridSelect {
  __device__ __forceinline__ int operator()(const DMParams& p,
                                            const Inputs& in, int dest,
                                            int c, int y, int x) const {
    return select_nd(in.sdir4, p.D4, p.H * p.W, dest, c);
  }
};

// The hierarchical routing constants, in the order of the Python side's
// `ops/hier.kernel_consts`.  floor(x / d) is (x * m) >> s for the
// divisions by LMAX and by the tile columns (m = 1 for a power of two);
// the host checks the multipliers exact over every rid, as
// `hier._magic_div` does, so the kernel divides nothing.
struct HierConsts {
  int ts_sh, lmax, lmax_m, lmax_sh, ntx, ntx_m, ntx_sh;
  int direct_base, nrx, nr;
};

// The select under hierarchical routing, `ops/hier.hier_select` at one
// cell: the windowed byte where the cell's tile lies in the destination's
// 3x3 tile window and the byte offers a move, else the dense row's (the
// region's hub for a tiled rid, its own row for a direct one).  `in.sdir4`
// and `p.D4` are the dense stack; a row past either stack reads ND_NONE.
// `row0` is the world's row of the planes' first row (a window of a world
// split by rows; 0 for a whole world): the cell's tile row is that of
// y + row0.  One gathered word from each stack.
struct HierSelect {
  const int* local4;
  int local_d4;
  HierConsts h;
  int row0;

  __device__ __forceinline__ int operator()(const DMParams& p,
                                            const Inputs& in, int dest,
                                            int c, int y, int x) const {
    const int HW = p.H * p.W;
    int loc = -1, r;
    if (dest < h.direct_base) {
      const int td = (dest * h.lmax_m) >> h.lmax_sh;
      const int l = dest - td * h.lmax;
      const int ty = (td * h.ntx_m) >> h.ntx_sh;
      const int tx = td - ty * h.ntx;
      const int dy = ty - ((y + row0) >> h.ts_sh), dx = tx - (x >> h.ts_sh);
      if (abs(dy) <= 1 && abs(dx) <= 1)
        loc = ((dy + 1) * 3 + (dx + 1)) * h.lmax + l;
      r = (ty >> 1) * h.nrx + (tx >> 1);
    } else {
      r = h.nr + (dest - h.direct_base);
    }
    const int nd_den = select_nd(in.sdir4, p.D4, HW, r, c);
    if (loc >= 0) {
      const int nd_loc = select_nd(local4, local_d4, HW, loc, c);
      if ((nd_loc & 7) != 7) return nd_loc;
    }
    return nd_den;
  }
};

// pallas_engine._resolve: direction (7 = none) and contraflow flag
__device__ __forceinline__ void resolve(int nd, int head1, bool use_allow,
                                        bool allow, uint32_t wnd, int wkey,
                                        int& dir, bool& contra) {
  const int h = max(head1 - 1, 0);
  const bool sok = (((nd >> (4 + h)) & 1) == 1) && head1 > 0;
  dir = sok ? h : (nd & 7);
  contra = !sok && (nd & 8);
  if (use_allow) {
    const int wi = (int)((wnd >> (wkey * 8)) & 0xFFu);
    const int wdir = wi & 7;
    const bool use_w = allow && wdir < 7;
    if (use_w) dir = wdir;
    contra = (use_w && (wi & 8)) || (!use_w && contra);
  }
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// what the decide phase computes for one cell: the new pa, pb, pd words,
// the steps this tick (0 for an empty cell), the halt latch and the aux
// word (nd0 | head1 << 8 | (ct > 0) << 11 | wkey << 12 | at_dest0 << 14 |
// new_mal << 15 | new_col << 16)
struct Decided {
  uint32_t pa, pb, pd;
  int steps;
  bool halted;
  int aux;
};

// how the decide phase reads its inputs (`ld_tick`): all up front at a
// cell that holds a vehicle (one round trip before the select), or only
// the cell's own pa, pb, pd words at an empty cell (every other value is
// used only where a vehicle stands, and its aux word's nd0 is then 7,
// read by no later phase; the random draws go unused too)
enum DecideMode { DM_VEHICLE, DM_EMPTY };

// A load of a tick input by the phases (coop.cuh): through the
// read-only data path, since no phase of K1's launch writes one.  A
// launch that wrote them in an earlier stage (K9: the last tick's planes
// and the painted stop plane; K7: its window planes) defines
// TSIM_COHERENT_LOADS before including this header, and its loads are
// plain: the read-only path is not coherent with the launch's own
// writes.
template <class T>
__device__ __forceinline__ T ld_tick(const T* q) {
#ifdef TSIM_COHERENT_LOADS
  return *q;
#else
  return __ldg(q);
#endif
}

// The decide phase at cell c = (y, x).
template <class Select, int kMode>
__device__ __forceinline__ Decided dm_decide_core(const DMParams& p,
                                                  const Inputs& in, int c,
                                                  int y, int x, float r_mal,
                                                  float r_side, int r_reroll,
                                                  const Select& sel) {
  constexpr bool kAhead = kMode == DM_VEHICLE;
  uint32_t pa = (uint32_t)ld_tick(in.pa + c);
  uint32_t pb = (uint32_t)ld_tick(in.pb + c);
  uint32_t pd = (uint32_t)ld_tick(in.pd + c);
  uint32_t nb_pa[4] = {0u, 0u, 0u, 0u};
  bool stop_c = false, rain_c = false, inter_c = false;
  int dest_c = -1;
  uint32_t wnd_c = 0u;
  if constexpr (kAhead) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int n = nbr(y, x, m, p.H, p.W);
      nb_pa[m] = n >= 0 ? (uint32_t)ld_tick(in.pa + n) : 0u;
    }
    stop_c = ld_tick(in.stop + c);
    rain_c = ld_tick(in.rain + c);
    inter_c = ld_tick(in.inter + c);
    dest_c = ld_tick(in.dest_id + c);
    wnd_c = (uint32_t)ld_tick(in.wnd + c);
  }
  const bool present = kMode != DM_EMPTY && (pa & 1u);
  const bool col0 = bit(pa, PA_COL_SH), mal0 = bit(pa, PA_MAL_SH);
  const bool parked = bit(pa, PA_PARKED_SH), stuckf = bit(pa, PA_STUCKF_SH);
  const int head1 = (int)fld(pa, PA_HEAD_SH, 3);
  const int cur0 = (int)fld(pa, PA_CUR_SH, 4);

  // stranded countdown
  const bool stranded0 = col0 || mal0;
  int st = (int)fld(pb, PB_STRAND_SH, 12);
  if (present && stranded0) st -= 1;
  const bool recovered = present && stranded0 && st <= 0;
  bool col = col0 && !recovered, mal = mal0 && !recovered;
  if (recovered) st = 0;
  bool still = present && (col || mal);

  bool new_mal = false;
  if (p.mal_active) {
    new_mal = present && !still && !parked && r_mal < p.mal_chance;
    mal = mal || new_mal;
    if (new_mal) st = p.mal_duration;
    still = still || new_mal;
  }
  bool new_col = false;
  if (p.side_active && present) {
    const int hk = max(head1 - 1, 0);
    const int opp1 = ((hk + 2) & 3) + 1;
    bool side_hit = false;
    for (int m = 0; m < 4; ++m) {
      const int n = nbr(y, x, m, p.H, p.W);
      if (n < 0) continue;
      const uint32_t q = nb_pa[m];
      const bool nb_mov = (q & 1u) && fld(q, PA_CUR_SH, 4) > 0 &&
                          !bit(q, PA_STUCKF_SH) && !bit(q, PA_PARKED_SH) &&
                          !bit(q, PA_COL_SH) && !bit(q, PA_MAL_SH);
      const int rel = (m - hk) & 3;
      side_hit = side_hit || (nb_mov && (int)fld(q, PA_HEAD_SH, 3) == opp1 &&
                              (rel == 1 || rel == 3));
    }
    const bool moving = present && cur0 > 0 && !stuckf && !parked && !still;
    new_col = moving && head1 > 0 && side_hit && r_side < p.side_chance;
    col = col || new_col;
    if (new_col) st = p.side_duration;
    still = still || new_col;
  }

  const bool halted =
      still || (present && stop_c) || parked;
  int base = (int)fld(pa, PA_BASE_SH, 4);
  if (present && base == 0) base = r_reroll;
  int speed = base;
  if (p.rain_enabled && present && rain_c)
    speed = max(1, speed - p.rain_reduction);
  if (halted) {
    speed = 0;
    base = 0;
  }

  const int dest14 = (int)fld(pa, PA_DEST_SH, 14);
  const int nd0 = present ? sel(p, in, dest14, c, y, x) : 7;
  int dir0;
  bool contra0;
  resolve(nd0, head1, false, false, 0u, 0, dir0, contra0);
  const bool at_dest0 = present && dest_c >= 0 && dest14 == dest_c;

  // contraflow ladder
  int ct = max((int)fld(pb, PB_CONTRA_SH, 8) - 1, 0);
  const uint32_t wnd = present ? wnd_c : 0u;
  const int wkey0 = (int)fld(pd, PD_CFKEY_SH, 2);
  const int wdir0 = (int)((wnd >> (wkey0 * 8)) & 7u);
  const bool merged = present && ct > 0 && !bit(pd, PD_CFMODE_SH) &&
                      wdir0 == 7 && dir0 < 7 && !contra0;
  if (merged) {
    ct = 0;
    pd &= CF_CLEAR;
  }
  const bool allow_pre = present && !halted && ct > 0;
  const bool blocked = present && !halted && !at_dest0 &&
                       (dir0 == 7 || (contra0 && !allow_pre));
  const bool overtake = p.ovt_active && blocked;
  const int stuck_v = (int)fld(pb, PB_STUCK_SH, 12);
  const int thresh =
      present && inter_c ? p.stuck_cf_thresh_inter : p.stuck_cf_thresh;
  const bool stuck_detour = p.stuck_cf_enabled && stuck_v >= thresh && present;
  const bool newly = present && !halted && (overtake || stuck_detour) &&
                     ct == 0;
  if (newly) ct = stuck_detour ? p.detour_duration : p.ovt_duration;
  const int key_new = head1 > 0 ? head1 - 1 : (dir0 < 4 ? dir0 : 0);
  if (newly)
    pd = (pd & CF_CLEAR) | ((uint32_t)key_new << PD_CFKEY_SH) |
         ((uint32_t)stuck_detour << PD_CFMODE_SH);
  const int wkey_dec = (int)fld(pd, PD_CFKEY_SH, 2);

  pa = (pa & CLEAR_A) | ((uint32_t)base << PA_BASE_SH) |
       ((uint32_t)(present ? speed : cur0) << PA_CUR_SH) |
       ((uint32_t)col << PA_COL_SH) | ((uint32_t)mal << PA_MAL_SH);
  pb = (uint32_t)clampi(stuck_v, 0, 4095) |
       ((uint32_t)clampi(st, 0, 4095) << PB_STRAND_SH) |
       ((uint32_t)clampi(ct, 0, 255) << PB_CONTRA_SH);
  return Decided{pa, pb, pd, present ? speed : 0, halted,
                 nd0 | (head1 << 8) | ((ct > 0) << 11) | (wkey_dec << 12) |
                     (at_dest0 << 14) | (new_mal << 15) | (new_col << 16)};
}

}  // namespace tsim
