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

__global__ void dm_decide(DMParams p, Inputs in0, int* __restrict__ S0) {
  const int HW = p.H * p.W;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= HW) return;
  const Inputs in = world_inputs(in0, blockIdx.y, HW, p.D4);
  dm_decide_cell(p, in, S0 + (long)blockIdx.y * N_SCRATCH * HW, c,
                 in.r_mal[c], in.r_side[c], in.r_reroll[c]);
}

__global__ void dm_intent(DMParams p, Inputs in0, int* __restrict__ S0,
                          int set) {
  const int HW = p.H * p.W;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= HW) return;
  const Inputs in = world_inputs(in0, blockIdx.y, HW, p.D4);
  dm_intent_cell(p, in, S0 + (long)blockIdx.y * N_SCRATCH * HW, set, c,
                 in.r_prio[c]);
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
  const DMParams p = dm_params(ip, fp, H, W, D4);
  Inputs in{sdir4, wnd, pa, pb, pc, pd, pe, pl, stop, rain, ped, inter,
            dest_id, r_mal, r_side, r_reroll, r_prio};
  Outputs out{opa, opb, opc, opd, ope, opl, flags};
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(blocks_for((long)H * W), B);
  dm_decide<<<grid, THREADS, 0, s>>>(p, in, scratch);
  int set = 0;
  for (int r = 0; r < p.max_speed; ++r) {
    dm_intent<<<grid, THREADS, 0, s>>>(p, in, scratch, set);
    dm_commit<<<grid, THREADS, 0, s>>>(p, scratch, set);
    set ^= 1;
  }
  dm_finish<<<grid, THREADS, 0, s>>>(p, in, scratch, set, out);
  return (int)cudaGetLastError();
}
