// int8 depthwise 3x3 (stride 1, zero pad 1) with a dequant epilogue, for
// Hopper, sm_90a.
//
// The JAX package computes this as an XLA op (multimodal_deepfake_detection_tpu/
// ops/quant.py::depthwise_conv2d_w8a8): quantize the input with the static
// scale s_in (per channel or scalar), an exact int32 depthwise over the int8
// codes and weights, then y * (s_dq * s_w). PyTorch has no int8 depthwise
// convolution on CUDA, so this kernel is the port's. It is a memory-bound
// stencil: at (256, 125, 125, 128) bf16 in and out it must read and write
// 1.02 GB each way, 0.61 ms at 3.35 TB/s. A block owns a tile of up to 8
// output rows by 64 output columns of one image, and 64 channels: it stages
// the tile and its one-pixel zero halo in shared memory as int8 codes
// (45 KB at most, so any width fits), quantized as they land
// (rintf(x / s_in[c]), clipped to +-127: one divide per input element), then
// each thread sums the 9 taps of 8 channels of one pixel in int32 (exact, so
// the order is free) and writes float(acc) * sc[c] in the output dtype.
//
// The C interface returns cudaGetLastError() after the launch; the caller
// owns every buffer and the stream.

#include "sm90_common.cuh"

namespace {

using namespace mdfd;

constexpr int CC = 64;  // channels per block
constexpr int THREADS = 256;
constexpr int ROWS = 8;  // output rows and columns per tile
constexpr int COLS = 64;

__host__ __device__ constexpr int smem_bytes(int rows, int cols) {
  return 9 * CC * 4 + 2 * CC * 4 + (rows + 2) * (cols + 2) * CC;
}

template <typename T, typename OutT>
__global__ void __launch_bounds__(THREADS)
dw_w8a8_kernel(const T* __restrict__ x, const float* __restrict__ s_in,
               const int8_t* __restrict__ w, const float* __restrict__ sc,
               OutT* __restrict__ out, int H, int W, int C, int rows_per_band,
               int cols_per_tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* taps_s = reinterpret_cast<int*>(smem);        // [9][CC]
  float* s_in_s = reinterpret_cast<float*>(taps_s + 9 * CC);  // [CC]
  float* sc_s = s_in_s + CC;                                   // [CC]
  int8_t* tile = reinterpret_cast<int8_t*>(sc_s + CC);         // [rows+2][cols+2][CC]

  const int bands = (H + rows_per_band - 1) / rows_per_band;
  const int tiles = (W + cols_per_tile - 1) / cols_per_tile;
  const int n = blockIdx.x / (bands * tiles);
  const int t = blockIdx.x - n * bands * tiles;
  const int h0 = (t / tiles) * rows_per_band;
  const int w0 = (t % tiles) * cols_per_tile;
  const int rows = min(rows_per_band, H - h0);
  const int cols = min(cols_per_tile, W - w0);
  const int c0 = blockIdx.y * CC;
  const int cn = min(CC, C - c0);  // C % 8 == 0
  const int vecs = cn / 8;
  const size_t image = static_cast<size_t>(n) * H * W * C;
  const int pitch = cols + 2;

  for (int i = threadIdx.x; i < 9 * cn; i += THREADS) {
    const int k = i / cn;
    const int c = i - k * cn;
    taps_s[k * CC + c] = w[static_cast<size_t>(c0 + c) * 9 + k];  // w is (C, 1, 3, 3)
  }
  for (int c = threadIdx.x; c < cn; c += THREADS) {
    s_in_s[c] = s_in[c0 + c];
    sc_s[c] = sc[c0 + c];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < (rows + 2) * pitch * vecs; i += THREADS) {
    const int v = i % vecs;
    const int p = i / vecs;
    const int col = p % pitch;
    const int r = p / pitch;
    const int hh = h0 - 1 + r;
    const int ww = w0 - 1 + col;
    uint2 packed = make_uint2(0u, 0u);
    if (hh >= 0 && hh < H && ww >= 0 && ww < W) {
      float f[8];
      load8(x + image + (static_cast<size_t>(hh) * W + ww) * C + c0 + v * 8, f);
      int8_t* q = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float s = rintf(__fdiv_rn(f[e], s_in_s[v * 8 + e]));
        q[e] = static_cast<int8_t>(static_cast<int>(fminf(fmaxf(s, -127.f), 127.f)));
      }
    }
    *reinterpret_cast<uint2*>(tile + (r * pitch + col) * CC + v * 8) = packed;
  }
  __syncthreads();

  const int v = threadIdx.x % 8;
  if (v >= vecs) return;
  for (int p = threadIdx.x / 8; p < rows * cols; p += THREADS / 8) {
    const int r = p / cols;
    const int col = p - r * cols;
    int acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const uint2 raw =
            *reinterpret_cast<const uint2*>(tile + ((r + dy) * pitch + col + dx) * CC + v * 8);
        const int8_t* q = reinterpret_cast<const int8_t*>(&raw);
        const int* t = taps_s + (dy * 3 + dx) * CC + v * 8;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] += static_cast<int>(q[e]) * t[e];
      }
    float o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = __fmul_rn(__int2float_rn(acc[e]), sc_s[v * 8 + e]);
    const size_t pixel =
        static_cast<size_t>(n) * H * W + static_cast<size_t>(h0 + r) * W + w0 + col;
    store8(out + pixel * C + c0 + v * 8, o);
  }
}

template <typename T, typename OutT>
int run(const T* x, const float* s_in, const int8_t* w, const float* sc, OutT* out, int N, int H,
        int W, int C, cudaStream_t stream) {
  const int rows = H < ROWS ? H : ROWS;
  const int cols = W < COLS ? W : COLS;
  const int smem = smem_bytes(rows, cols);
  cudaError_t err = cudaFuncSetAttribute(dw_w8a8_kernel<T, OutT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(N * ((H + rows - 1) / rows) * ((W + cols - 1) / cols), (C + CC - 1) / CC);
  dw_w8a8_kernel<T, OutT><<<grid, THREADS, smem, stream>>>(x, s_in, w, sc, out, H, W, C, rows,
                                                           cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: (N, H, W, C) contiguous, bf16 (x_fp32 == 0) or fp32; out: the same shape,
// bf16 (out_fp32 == 0) or fp32; s_in, sc: (C,) fp32; w: (C, 1, 3, 3) int8;
// every pointer 16-byte aligned, C % 8 == 0.
// Returns a cudaError_t code, 0 on success.
int mdfd_dw_w8a8(const void* x, const void* s_in, const void* w, const void* sc, void* out,
                 int N, int H, int W, int C, int x_fp32, int out_fp32, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* si = static_cast<const float*>(s_in);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* scf = static_cast<const float*>(sc);
  if (x_fp32) {
    const float* xf = static_cast<const float*>(x);
    if (out_fp32) return run(xf, si, wq, scf, static_cast<float*>(out), N, H, W, C, s);
    return run(xf, si, wq, scf, static_cast<bf16*>(out), N, H, W, C, s);
  }
  const bf16* xb = static_cast<const bf16*>(x);
  if (out_fp32) return run(xb, si, wq, scf, static_cast<float*>(out), N, H, W, C, s);
  return run(xb, si, wq, scf, static_cast<bf16*>(out), N, H, W, C, s);
}

const char* mdfd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
