// K8: the planar RGB framebuffer pass, [3, H, W] u8.
//
// Replaces pallas_render.render_pallas (its _kernel): palette lookup by
// cell type, the stop recolors of lights and controlled roads, rain mixed
// toward flat grey (0.5 * base + 0.5 * 128.0, then the int32 -> uint8
// truncation; every input is an integer 0..255, so the f32 value is
// exact and equals (base >> 1) + 64), and the vehicle class overlay.  The
// class plane (0 none, 1..5 vehicle classes) is built outside the kernel,
// as in JAX.
//
// Bound on the H100: device-memory bytes, 4 read and 3 written a pixel
// (7.3 MB at 1024^2, about 2.2 us at 3.35 TB/s).  Design: the vector path
// gives each thread 16 consecutive pixels: one 16-byte load from each of
// the four input planes and one 16-byte store into each of the three
// channel planes (4- or 1-byte stores where a channel plane does not
// start on a 16-byte boundary, a choice the whole launch shares); a
// scalar tail covers the last HW % 16 pixels.  The wrapper takes the
// scalar path (a pixel a thread) where an input or the output does not
// start on a 16-byte boundary.  Blocks of 64 threads spread a small frame
// over more SMs.  The 25 colours come as one by-value
// kernel argument, a packed RGB word each, which one thread per block
// copies into shared memory at constant offsets (a data-dependent index
// into the argument itself would make nvcc copy it to each thread's
// stack); a pixel reads one word for its base colour and one for its
// vehicle, and mixes rain on the packed word.
#include "common.cuh"

namespace tsim {

constexpr int N_CELL_TYPES = 18;
// colours in the order of the wrapper's table: 18 palette entries, then
// light stop, controlled-road stop, vehicle, service vehicle, parked,
// malfunction, collision; r | g << 8 | b << 16 each
constexpr int N_COLOURS = N_CELL_TYPES + 7;
// the vector path's block: 64 threads, so that a 256^2 frame (4,096
// threads of 16 pixels) spreads over 64 SMs
constexpr int VEC_THREADS = 64;
struct Colours {
  uint32_t rgb[N_COLOURS];
};

__device__ __forceinline__ void stage_colours(const Colours& colours,
                                              uint32_t* table) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < N_COLOURS; ++i) table[i] = colours.rgb[i];
  }
  __syncthreads();
}

// the packed RGB word of one pixel
__device__ __forceinline__ uint32_t pixel_rgb(const uint32_t* table,
                                              int code, bool st, bool rn,
                                              int vs, int light_code,
                                              int ctrl_code) {
  // the colour table index for each override, -1 for none
  int k = code < N_CELL_TYPES ? code : -1;   // codes past the palette: 0
  if (code == light_code && st) k = N_CELL_TYPES;
  if (code == ctrl_code && st) k = N_CELL_TYPES + 1;
  uint32_t rgb = k >= 0 ? table[k] : 0u;
  if (rn) rgb = ((rgb >> 1) & 0x7F7F7Fu) + 0x404040u;
  if (vs >= 1 && vs <= 5) rgb = table[N_CELL_TYPES + 1 + vs];
  return rgb;
}

__device__ __forceinline__ int byte_of(const uint4& v, int j) {
  const uint32_t w = j < 4 ? v.x : j < 8 ? v.y : j < 12 ? v.z : v.w;
  return (int)((w >> ((j & 3) * 8)) & 0xFFu);
}

// pixel c (a thread each)
__device__ __forceinline__ void render_pixel(
    const uint32_t* table, const uint8_t* cell, const uint8_t* stop,
    const uint8_t* rain, const uint8_t* vstate, uint8_t* out, long HW,
    long c, int light_code, int ctrl_code) {
  const uint32_t rgb = pixel_rgb(table, cell[c], stop[c] != 0, rain[c] != 0,
                                 vstate[c], light_code, ctrl_code);
  out[c] = (uint8_t)rgb;
  out[HW + c] = (uint8_t)(rgb >> 8);
  out[2 * HW + c] = (uint8_t)(rgb >> 16);
}

__global__ void render_scalar(const Colours colours,
                              const uint8_t* __restrict__ cell,
                              const uint8_t* __restrict__ stop,
                              const uint8_t* __restrict__ rain,
                              const uint8_t* __restrict__ vstate,
                              uint8_t* __restrict__ out, int HW,
                              int light_code, int ctrl_code) {
  __shared__ uint32_t table[N_COLOURS];
  stage_colours(colours, table);
  const long c = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c < HW)
    render_pixel(table, cell, stop, rain, vstate, out, HW, c, light_code,
                 ctrl_code);
}

// 16 pixels a thread; `store` is the width of the channel planes' stores
// (16, 4 or 1 bytes: the alignment of the plane at out + HW, shared by
// the launch); threads past the vector part render the HW % 16 tail
__global__ void render_vec(const Colours colours,
                           const uint4* __restrict__ cell,
                           const uint4* __restrict__ stop,
                           const uint4* __restrict__ rain,
                           const uint4* __restrict__ vstate,
                           uint8_t* __restrict__ out, int HW, int light_code,
                           int ctrl_code, int store) {
  __shared__ uint32_t table[N_COLOURS];
  stage_colours(colours, table);
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long n16 = HW / 16;
  if (i >= n16) {
    const long c = n16 * 16 + (i - n16);
    if (c < HW)
      render_pixel(table, (const uint8_t*)cell, (const uint8_t*)stop,
                   (const uint8_t*)rain, (const uint8_t*)vstate, out, HW, c,
                   light_code, ctrl_code);
    return;
  }
  const uint4 cv = cell[i], sv = stop[i], rv = rain[i], vv = vstate[i];
  uint32_t o[3][4] = {};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const uint32_t rgb =
        pixel_rgb(table, byte_of(cv, j), byte_of(sv, j) != 0,
                  byte_of(rv, j) != 0, byte_of(vv, j), light_code, ctrl_code);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      o[ch][j >> 2] |= ((rgb >> (8 * ch)) & 0xFFu) << (8 * (j & 3));
  }
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    uint8_t* dst = out + (long)ch * HW + i * 16;
    // plane 0 starts on the output's (16-byte) boundary; planes 1 and 2
    // on HW's
    const int w = ch == 0 ? 16 : store;
    if (w == 16) {
      *(uint4*)dst = make_uint4(o[ch][0], o[ch][1], o[ch][2], o[ch][3]);
    } else if (w == 4) {
#pragma unroll
      for (int k = 0; k < 4; ++k) ((uint32_t*)dst)[k] = o[ch][k];
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        dst[j] = (uint8_t)(o[ch][j >> 2] >> (8 * (j & 3)));
    }
  }
}

}  // namespace tsim

// colours: N_COLOURS packed RGB words (see above); vec: 1 for the vector
// path (every plane starts on a 16-byte boundary), 0 for the scalar one
extern "C" int tsim_render_planes(const uint32_t* colours,
                                  const uint8_t* cell, const uint8_t* stop,
                                  const uint8_t* rain, const uint8_t* vstate,
                                  uint8_t* out, int HW, int light_code,
                                  int ctrl_code, int vec, void* stream) {
  using namespace tsim;
  cudaStream_t s = (cudaStream_t)stream;
  Colours table;
  for (int i = 0; i < N_COLOURS; ++i) table.rgb[i] = colours[i];
  if (HW <= 0) return (int)cudaGetLastError();
  if (vec) {
    const int store = HW % 16 == 0 ? 16 : HW % 4 == 0 ? 4 : 1;
    const long threads = HW / 16 + HW % 16;
    render_vec<<<(int)((threads + VEC_THREADS - 1) / VEC_THREADS),
                 VEC_THREADS, 0, s>>>(
        table, (const uint4*)cell, (const uint4*)stop, (const uint4*)rain,
        (const uint4*)vstate, out, HW, light_code, ctrl_code, store);
  } else {
    render_scalar<<<blocks_for(HW), THREADS, 0, s>>>(
        table, cell, stop, rain, vstate, out, HW, light_code, ctrl_code);
  }
  return (int)cudaGetLastError();
}
