// Xception stride-2 entry/exit block (K3) for Hopper, sm_90a.
//
// Replaces the TPU kernels multimodal_deepfake_detection_tpu/ops/pallas/
// sepconv_entry.py::entry_block_pallas (_entry_block_kernel) and
// sepconv_entry_striped.py::entry_block_striped_pallas (_striped_kernel),
// which compute one function:
//     out = maxpool3x3/s2(pair([ReLU] x)) + (conv1x1/s2(x) . skw + skb)
//     pair = dw3x3 -> pw(Cin->Cmid) + b0 -> ReLU -> dw3x3 -> pw(Cmid->Cout) + b1
// on dense NHWC activations (N, H, W, Cin) -> (N, (H+1)/2, (W+1)/2, Cout) in
// bf16 or fp32, at the TPU kernels' rounding points: x is rounded to bf16;
// each depthwise sums its fp32 products per column over dy, then
// (dx0 + dx1) + dx2, and is rounded to bf16; each pointwise accumulates in
// fp32 and adds its bias; mid = bf16(ReLU(...)) and outs = bf16(...); the
// pool's padding never wins; the skip reads the bf16 x at even rows and
// columns; the output is pooled + (skip + skb), stored in the I/O dtype.
//
// What bounds it on an H100: at 256 frames of 256^2 the four blocks are
// 192-400 GFLOP of bf16 tensor-core work each (0.19-0.40 ms at 989 TFLOP/s)
// against one read of x and one pooled write (0.04-0.23 ms at 3.35 TB/s).
// Every intermediate the TPU kernel keeps in VMEM is already rounded to bf16
// there. Four launches per block:
//   gather_even_kernel        x at even rows and columns -> bf16 skip operand
//   run_pair (2 launches)     sepconv_pair.cuh, K4's pair: each unit one GEMM
//                             whose producer warps compute its depthwise
//                             (K3's column-sum order, ReLU on x only for
//                             blocks that lead with one) into the A tile
//                             (dw_gemm.cuh): bias + ReLU -> mid; bias -> outs
//   gemm::gemm_kernel         the skip GEMM, whose epilogue adds the bias
//                             and the 3x3/s2 max of outs -> out, so pool,
//                             skip and add are one kernel.
// Neither depthwise result leaves the chip; mid and outs round-trip through
// device memory, about 5 GB at block 1 against the 0.77 GB bound. What
// holds the pair's launches above their bounds is their producers'
// neighbourhood loads and the consumer's per-tile MMA-epilogue chain
// (dw_gemm.cuh).
// Operand rows are padded to 32 elements, as K1's are (PW_ROW_ALIGN).
//
// The C interface returns cudaGetLastError() after each launch; the caller
// owns every buffer and the stream.

#include <algorithm>
#include <cmath>

#include "sepconv_pair.cuh"

namespace {

using namespace mdfd;

constexpr int GATHER_THREADS = 256;

// xs[(n, q, j), :C] = bf16(x[n, 2q, 2j, :C]), rows ld elements apart
template <typename T>
__global__ void __launch_bounds__(GATHER_THREADS)
gather_even_kernel(const T* __restrict__ x, bf16* __restrict__ xs, int N, int H, int W, int C,
                   int Hp, int Wp, int ld) {
  const int vecs = C / 8;
  const size_t total = static_cast<size_t>(N) * Hp * Wp * vecs;
  for (size_t i = static_cast<size_t>(blockIdx.x) * GATHER_THREADS + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * GATHER_THREADS) {
    const int v = static_cast<int>(i % vecs);
    const size_t m = i / vecs;
    const int j = static_cast<int>(m % Wp);
    const size_t t = m / Wp;
    const int q = static_cast<int>(t % Hp);
    const size_t n = t / Hp;
    float f[8];
    load8(x + ((n * H + 2 * q) * W + 2 * j) * C + v * 8, f);
    store8(xs + m * ld + v * 8, f);
  }
}

// The skip GEMM's epilogue: row m = (n, q, j) of the pooled output;
// out = max over outs[n, 2q-1 .. 2q+1, 2j-1 .. 2j+1] (inside the image) +
// (acc + skb), stored in T. `stage` takes the tile's maxima into shared
// memory first, 8 channels of one pixel per thread and task, so that
// neighbouring threads read neighbouring 16 bytes of each window pixel.
template <typename T>
struct PoolSkipEpilogue {
  const float* bias;
  const bf16* outs;  // (N, H, W, C) unit-1 output
  T* out;            // (N, Hp, Wp, C)
  int M, C, H, W, Hp, Wp;
  static constexpr bool kStaged = true;
  static constexpr int PITCH = gemm::BN + 8;  // staged row, bf16: rows 4 banks apart
  static_assert(gemm::BM * PITCH * 2 <= gemm::STAGES * gemm::STAGE_BYTES, "pooled tile");

  __device__ __forceinline__ void stage(int m0, int n0, int ctid, bf16* tile) const {
    constexpr int VECS = gemm::BN / 8;
    const int vecs = min(gemm::BN, C - n0) / 8;  // C % 8 == 0
    for (int t = ctid; t < gemm::BM * VECS; t += 256) {
      const int r = t / VECS;
      const int v = t - r * VECS;
      const int m = m0 + r;
      if (m >= M || v >= vecs) continue;
      const int img = m / (Hp * Wp);
      const int rem = m - img * Hp * Wp;
      const int q = rem / Wp;
      const int j = rem - q * Wp;
      const bf16* src = outs + static_cast<size_t>(img) * H * W * C + n0 + v * 8;
      float mx[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) mx[e] = -INFINITY;
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
          const int h = 2 * q + dy, w = 2 * j + dx;
          if (h < 0 || h >= H || w < 0 || w >= W) continue;
          float f[8];
          load8(src + (static_cast<size_t>(h) * W + w) * C, f);
#pragma unroll
          for (int e = 0; e < 8; ++e) mx[e] = fmaxf(mx[e], f[e]);
        }
      store8(tile + r * PITCH + v * 8, mx);  // maxima of bf16 values: exact in bf16
    }
  }

  __device__ __forceinline__ void operator()(const float* d, int row, int n0, int lane,
                                             const bf16* tile) const {
    const int m0 = row & ~(gemm::BM - 1);
#pragma unroll  // d[] is indexed by constants only, so it stays in registers
    for (int jn = 0; jn < gemm::BN / 8; ++jn) {
      const int n = n0 + jn * 8 + (lane & 3) * 2;  // C % 8 == 0: n < C implies n + 1 < C
      if (n >= C) continue;
      const float2 bv = *reinterpret_cast<const float2*>(bias + n);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = row + half * 8;
        if (m >= M) continue;
        const float2 p = load2(tile + (m - m0) * PITCH + (n - n0));
        const float s0 = d[4 * jn + 2 * half] + bv.x;
        const float s1 = d[4 * jn + 2 * half + 1] + bv.y;
        store2(out + static_cast<size_t>(m) * C + n, p.x + s0, p.y + s1);
      }
    }
  }
};

template <typename T>
int run_block(const T* x, const float* dw0, const bf16* pw0, const float* b0, const float* dw1,
              const bf16* pw1, const float* b1, const bf16* skw, const float* skb, T* out,
              bf16* mid, bf16* outs, bf16* xs, int N, int H, int W, int Cin, int Cmid, int Cout,
              int ldk0, int ldk1, bool leading_relu, cudaStream_t stream) {
  const int Hp = (H + 1) / 2, Wp = (W + 1) / 2;
  const int Mp = N * Hp * Wp;

  const size_t vecs = static_cast<size_t>(Mp) * (Cin / 8);  // grid-stride: 16 blocks per H100 SM
  const int gather_grid =
      static_cast<int>(std::min<size_t>((vecs + GATHER_THREADS - 1) / GATHER_THREADS, 132 * 16));
  gather_even_kernel<T><<<gather_grid, GATHER_THREADS, 0, stream>>>(x, xs, N, H, W, Cin, Hp, Wp,
                                                                    ldk0);
  if (const cudaError_t err = cudaGetLastError(); err != cudaSuccess)
    return static_cast<int>(err);

  if (int e = run_pair<Taps::kCols>(x, dw0, pw0, b0, dw1, pw1, b1, outs, mid, N, H, W, Cin, Cmid,
                                    Cout, ldk0, ldk1, leading_relu, stream))
    return e;
  return gemm::launch(xs, ldk0, skw, ldk0, Mp, Cout, Cin,
                      PoolSkipEpilogue<T>{skb, outs, out, Mp, Cout, H, W, Hp, Wp}, stream);
}

}  // namespace

extern "C" {

// x: (N, H, W, Cin) and out: (N, (H+1)/2, (W+1)/2, Cout), contiguous, bf16
// (fp32_io == 0) or fp32 (fp32_io == 1). dw0: (9, Cin) and dw1: (9, Cmid)
// fp32 taps; pw0: (Cmid, ldk0), pw1: (Cout, ldk1) and skw: (Cout, ldk0) bf16
// [out][in], columns past Cin / Cmid unread; b0: (Cmid,), b1, skb: (Cout,)
// fp32. Scratch, bf16: mid (N*H*W, Cmid), outs (N*H*W, Cout), xs (N*Hp*Wp,
// ldk0). Every pointer 16-byte aligned; Cin, Cmid, Cout, ldk0 >= Cin and
// ldk1 >= Cmid multiples of 8. Returns a cudaError_t code, 0 on success.
int mdfd_entry_block(const void* x, const void* dw0, const void* pw0, const void* b0,
                     const void* dw1, const void* pw1, const void* b1, const void* skw,
                     const void* skb, void* out, void* mid, void* outs, void* xs, int N, int H,
                     int W, int Cin, int Cmid, int Cout, int ldk0, int ldk1, int leading_relu,
                     int fp32_io, void* stream) {
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto h = [](const void* p) { return static_cast<const bf16*>(p); };
  const auto hm = [](void* p) { return static_cast<bf16*>(p); };
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fp32_io)
    return run_block(f(x), f(dw0), h(pw0), f(b0), f(dw1), h(pw1), f(b1), h(skw), f(skb),
                     static_cast<float*>(out), hm(mid), hm(outs), hm(xs), N, H, W, Cin, Cmid,
                     Cout, ldk0, ldk1, leading_relu != 0, s);
  return run_block(h(x), f(dw0), h(pw0), f(b0), f(dw1), h(pw1), f(b1), h(skw), f(skb),
                   static_cast<bf16*>(out), hm(mid), hm(outs), hm(xs), N, H, W, Cin, Cmid, Cout,
                   ldk0, ldk1, leading_relu != 0, s);
}

const char* mdfd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
