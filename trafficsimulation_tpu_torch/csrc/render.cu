// K8: the planar RGB framebuffer pass, [3, H, W] u8.
//
// Replaces pallas_render.render_pallas (its _kernel): palette lookup by
// cell type, the stop recolors of lights and controlled roads, rain mixed
// toward flat grey (0.5 * base + 0.5 * 128.0, then the int32 -> uint8
// truncation; every input is an integer 0..255, so the f32 values are
// exact), and the vehicle class overlay.  The class plane (0 none, 1..5
// vehicle classes) is built outside the kernel, as in JAX.
//
// Bound on the H100: device-memory bytes, 4 read and 3 written a pixel
// (7.3 MB at 1024^2, about 2.2 us at 3.35 TB/s).  Design: one thread per
// pixel; the 18-entry palette and the seven override colours come as
// one by-value kernel argument, which one thread per block copies into
// shared memory at constant offsets (a data-dependent index into the
// argument itself would make nvcc copy it to each thread's stack); each
// channel plane is written by consecutive threads at consecutive bytes.
#include <cstring>

#include "common.cuh"

namespace tsim {

constexpr int N_CELL_TYPES = 18;
// colours in the order of the wrapper's table: 18 palette entries, then
// light stop, controlled-road stop, vehicle, service vehicle, parked,
// malfunction, collision
constexpr int N_COLOURS = N_CELL_TYPES + 7;
constexpr int N_COLOUR_WORDS = (N_COLOURS * 3 + 3) / 4;
struct Colours {
  uint32_t w[N_COLOUR_WORDS];
};

__global__ void render_planes(const Colours colours,
                              const uint8_t* __restrict__ cell,
                              const uint8_t* __restrict__ stop,
                              const uint8_t* __restrict__ rain,
                              const uint8_t* __restrict__ vstate,
                              uint8_t* __restrict__ out, int HW,
                              int light_code, int ctrl_code) {
  __shared__ uint32_t table_w[N_COLOUR_WORDS];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < N_COLOUR_WORDS; ++i) table_w[i] = colours.w[i];
  }
  __syncthreads();
  const uint8_t* table = reinterpret_cast<const uint8_t*>(table_w);
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= HW) return;
  const int code = cell[c];
  const bool st = stop[c] != 0, rn = rain[c] != 0;
  const int vs = vstate[c];
  // the colour table index for each override, -1 for none
  int k = code < N_CELL_TYPES ? code : -1;   // codes past the palette: 0
  if (code == light_code && st) k = N_CELL_TYPES;
  if (code == ctrl_code && st) k = N_CELL_TYPES + 1;
  for (int ch = 0; ch < 3; ++ch) {
    float base = k >= 0 ? (float)table[k * 3 + ch] : 0.0f;
    if (rn) base = 0.5f * base + 0.5f * 128.0f;
    if (vs >= 1 && vs <= 5)
      base = (float)table[(N_CELL_TYPES + 1 + vs) * 3 + ch];
    out[(long)ch * HW + c] = (uint8_t)(int)base;
  }
}

}  // namespace tsim

// colours: N_COLOURS x 3 bytes (see above)
extern "C" int tsim_render_planes(const uint8_t* colours, const uint8_t* cell,
                                  const uint8_t* stop, const uint8_t* rain,
                                  const uint8_t* vstate, uint8_t* out, int HW,
                                  int light_code, int ctrl_code,
                                  void* stream) {
  using namespace tsim;
  cudaStream_t s = (cudaStream_t)stream;
  Colours table = {};
  memcpy(table.w, colours, N_COLOURS * 3);
  if (HW > 0)
    render_planes<<<blocks_for(HW), THREADS, 0, s>>>(
        table, cell, stop, rain, vstate, out, HW, light_code, ctrl_code);
  return (int)cudaGetLastError();
}
