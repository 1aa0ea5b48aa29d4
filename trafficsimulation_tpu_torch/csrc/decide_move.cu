// K1: the per-tick vehicle decide + move on the packed planes.
//
// Replaces pallas_engine.decide_move_pallas (_kernel -> decide_move_core).
// One thread per cell, in phases, with double-buffered planes in device
// memory: one launch per phase body of decide_move.cuh (decide, K x
// (intent, commit), finish), K = VEHICLE_MAX_SPEED sub-rounds, so 2K + 2
// launches for a whole batch of B worlds: blockIdx.y is the world.
// Every per-world plane (the packed stack, wavefronts, vehicle planes,
// masks, random planes, outputs and the [20, H, W] scratch) advances by
// one world's size per world; the geometry (intersection, dest_id) is
// shared.  B = 1 is the single-world tick.  Every neighbour index comes
// from `nbr` on the world's own (y, x), so no read crosses into another
// world.
//
// K1-hier (`tsim_decide_move_hier`) is the same launches for one world
// under hierarchical routing, the row select `HierSelect` in place of
// `GridSelect`: it replaces the plain decide core with the hierarchical
// select (K6 twice per select) that the JAX package runs for such worlds
// (trafficsimulation_tpu/ops/engine.py, the ROUTING_HIER branch of
// step_engine; select_rows_pallas for the selects).
#include "decide_move.cuh"

namespace tsim {

// world b's view of the batch: per-world planes advance by b planes;
// intersection and dest_id are shared
__device__ __forceinline__ Inputs world_inputs(Inputs in, int b, long hw,
                                               int D4) {
  const long o = (long)b * hw;
  in.sdir4 += o * D4;
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

template <class Select>
__global__ void dm_decide(DMParams p, Inputs in0, int* __restrict__ S0,
                          Select sel) {
  const int HW = p.H * p.W;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= HW) return;
  const Inputs in = world_inputs(in0, blockIdx.y, HW, p.D4);
  dm_decide_cell(p, in, S0 + (long)blockIdx.y * N_SCRATCH * HW, c,
                 in.r_mal[c], in.r_side[c], in.r_reroll[c], sel);
}

template <class Select>
__global__ void dm_intent(DMParams p, Inputs in0, int* __restrict__ S0,
                          int set, Select sel) {
  const int HW = p.H * p.W;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= HW) return;
  const Inputs in = world_inputs(in0, blockIdx.y, HW, p.D4);
  dm_intent_cell(p, in, S0 + (long)blockIdx.y * N_SCRATCH * HW, set, c,
                 in.r_prio[c], sel);
}

__global__ void dm_commit(DMParams p, int* __restrict__ S0, int set) {
  const int HW = p.H * p.W;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= HW) return;
  dm_commit_cell(p, S0 + (long)blockIdx.y * N_SCRATCH * HW, set, c);
}

__global__ void dm_finish(DMParams p, Inputs in0,
                          const int* __restrict__ S0, int set,
                          Outputs out) {
  const int HW = p.H * p.W;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= HW) return;
  const Inputs in = world_inputs(in0, blockIdx.y, HW, p.D4);
  const long o = (long)blockIdx.y * HW;
  out.flags[o + c] = dm_finish_cell(
      p, in, S0 + (long)blockIdx.y * N_SCRATCH * HW, set, c, out, o);
}

// the 2K + 2 phase launches of one tick for B worlds, selecting rows
// with `sel`
template <class Select>
int launch_dm(const DMParams& p, const Inputs& in, const Outputs& out,
           int* scratch, int B, cudaStream_t s, const Select& sel) {
  const dim3 grid(blocks_for((long)p.H * p.W), B);
  dm_decide<<<grid, THREADS, 0, s>>>(p, in, scratch, sel);
  int set = 0;
  for (int r = 0; r < p.max_speed; ++r) {
    dm_intent<<<grid, THREADS, 0, s>>>(p, in, scratch, set, sel);
    dm_commit<<<grid, THREADS, 0, s>>>(p, scratch, set);
    set ^= 1;
  }
  dm_finish<<<grid, THREADS, 0, s>>>(p, in, scratch, set, out);
  return (int)cudaGetLastError();
}

}  // namespace tsim

extern "C" int tsim_decide_move(
    const int* ip, const float* fp, const int* sdir4, int D4, const int* wnd,
    const int* pa, const int* pb, const int* pc, const int* pd, const int* pe,
    const float* pl, const uint8_t* stop, const uint8_t* rain,
    const uint8_t* ped, const uint8_t* inter, const int* dest_id,
    const float* r_mal, const float* r_side, const int* r_reroll,
    const int* r_prio, int* opa, int* opb, int* opc, int* opd, int* ope,
    float* opl, int* flags, int* scratch, int B, int H, int W,
    void* stream) {
  using namespace tsim;
  return launch_dm(dm_params(ip, fp, H, W, D4),
                Inputs{sdir4, wnd, pa, pb, pc, pd, pe, pl, stop, rain, ped,
                       inter, dest_id, r_mal, r_side, r_reroll, r_prio},
                Outputs{opa, opb, opc, opd, ope, opl, flags}, scratch, B,
                (cudaStream_t)stream, GridSelect());
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
                Inputs{sdir4, wnd, pa, pb, pc, pd, pe, pl, stop, rain, ped,
                       inter, dest_id, r_mal, r_side, r_reroll, r_prio},
                Outputs{opa, opb, opc, opd, ope, opl, flags}, scratch, 1,
                (cudaStream_t)stream, sel);
}
