// Xception middle-flow residual block (K1) for Hopper, sm_90a.
//
// Replaces the TPU kernel multimodal_deepfake_detection_tpu/ops/pallas/
// sepconv_pos.py::middle_block_pos_pallas (_pos_kernel). One block is
// 3 reps of
//     ReLU -> round to bf16 -> depthwise 3x3 (zero pad 1, fp32 taps summed
//     dy-major) -> round to bf16 -> pointwise CxC (bf16 x bf16 -> fp32) + bias
//     -> (last rep: + block input in fp32) -> store in the I/O dtype,
// on NHWC activations (N, H, W, C) in bf16 or fp32. With bf16 taps it also
// replaces sepconv_block.py::middle_block_pallas_v2(precise=False)
// (_block_kernel_v2 with a bf16 accumulator): taps, products and running
// sums rounded to bf16. v1 (middle_block_pallas) and v2 with precise=True
// compute the fp32-tap function and run this kernel as it is.
//
// Each rep is two kernels:
//   dw3x3_relu_kernel (sm90_common.cuh, shared with K2) — memory-bound:
//     reads the rep input, writes the bf16 depthwise result (the GEMM's A
//     operand) to a scratch buffer; tiles of rows x columns x 64 channels
//     are staged in shared memory with their halo.
//   gemm::gemm_kernel (bf16_gemm.cuh, shared with K3) — tensor cores through
//     wgmma m64n256k16 (bf16 in, fp32 accumulate) on 128x256x64 tiles in
//     128-byte-swizzled shared memory, filled by TMA in a 4-stage mbarrier
//     pipeline; K1's epilogue adds the bias, the residual on the last rep,
//     and stores in the I/O dtype from registers.
// C need not be a multiple of the tile: TMA zero-fills the ragged K and N
// edges and the epilogue masks N. C must be a multiple of 8 so that every
// row starts on a 16-byte boundary. The GEMM's operands (the depthwise
// result and the pointwise weight) have rows of `ldk` >= C elements: on an
// H100, TMA loads rows that start on 64-byte boundaries about 1.4x as fast
// as C = 728's 1456-byte rows, every other one of which starts mid-sector.
//
// The C interface returns cudaGetLastError() after each launch; the caller
// owns every buffer and the stream.

#include "bf16_gemm.cuh"

namespace {

using namespace mdfd;

constexpr int EPI_J = 4;  // epilogue column groups whose loads go out together

// K1's GEMM epilogue: (acc + bias) (+ residual on the last rep), stored in
// the I/O dtype. The bias and residual loads of EPI_J column groups go out
// together, before any of their stores, so that their round trips overlap:
// issued one at a time between stores they cost more than the k-loop.
template <typename T>
struct ResidualEpilogue {
  const float* bias;
  const T* resid;  // nullptr but on the last rep
  T* out;
  int M, C;
  static constexpr bool kStaged = false;

  __device__ __forceinline__ void operator()(const float* d, int row, int n0, int lane,
                                             const bf16*) const {
#pragma unroll
    for (int j0 = 0; j0 < gemm::BN / 8; j0 += EPI_J) {
      float2 bv[EPI_J], rv[EPI_J][2];
#pragma unroll
      for (int jj = 0; jj < EPI_J; ++jj) {
        const int n = n0 + (j0 + jj) * 8 + (lane & 3) * 2;  // C % 8 == 0: n < C implies n + 1 < C
        bv[jj] = n < C ? *reinterpret_cast<const float2*>(bias + n) : make_float2(0.f, 0.f);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = row + half * 8;
          rv[jj][half] = resid != nullptr && n < C && m < M
                             ? load2(resid + static_cast<size_t>(m) * C + n)
                             : make_float2(0.f, 0.f);
        }
      }
#pragma unroll
      for (int jj = 0; jj < EPI_J; ++jj) {
        const int j = j0 + jj;
        const int n = n0 + j * 8 + (lane & 3) * 2;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = row + half * 8;
          if (n < C && m < M) {
            // (acc + bias) + residual: the plain version's order
            const float v0 = d[4 * j + 2 * half] + bv[jj].x;
            const float v1 = d[4 * j + 2 * half + 1] + bv[jj].y;
            store2(out + static_cast<size_t>(m) * C + n, v0 + rv[jj][half].x,
                   v1 + rv[jj][half].y);
          }
        }
      }
    }
  }
};

template <Taps ORDER, typename T>
int run_block(const T* x, const float* dw, const bf16* pw, const float* b, T* out, bf16* a,
              int N, int H, int W, int C, int ldk, int reps, cudaStream_t stream) {
  const int M = N * H * W;
  DwLaunch dw_launch;
  if (int e = dw3x3_setup<T, bf16, true, ORDER>(N, H, W, C, &dw_launch)) return e;
  for (int r = 0; r < reps; ++r) {
    const T* src = r == 0 ? x : out;
    dw3x3_relu_kernel<T, bf16, true, ORDER><<<dw_launch.grid, DW_THREADS, dw_launch.smem, stream>>>(
        src, dw + static_cast<size_t>(r) * 9 * C, a, H, W, C, ldk, dw_launch.rows_per_band,
        dw_launch.cols_per_tile);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const ResidualEpilogue<T> epi{b + static_cast<size_t>(r) * C, r + 1 == reps ? x : nullptr,
                                  out, M, C};
    if (int e = gemm::launch(a, ldk, pw + static_cast<size_t>(r) * C * ldk, ldk, M, C, C, epi,
                             stream))
      return e;
  }
  return 0;
}

}  // namespace

extern "C" {

// x, out: (N, H, W, C) contiguous, bf16 (fp32_io == 0) or fp32 (fp32_io == 1);
// dw: (reps, 9, C) fp32; pw: (reps, C, ldk) bf16 [out][in], columns past C
// unread; b: (reps, C) fp32; scratch: N*H*W*ldk bf16; every pointer 16-byte
// aligned, C % 8 == 0, ldk % 8 == 0, ldk >= C. bf16_taps: 0 sums fp32
// products of the fp32 taps, 1 rounds taps, products and sums to bf16.
// Returns a cudaError_t code, 0 on success.
int mdfd_middle_block(const void* x, const void* dw, const void* pw, const void* b, void* out,
                      void* scratch, int N, int H, int W, int C, int ldk, int reps, int fp32_io,
                      int bf16_taps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dwf = static_cast<const float*>(dw);
  const bf16* pwb = static_cast<const bf16*>(pw);
  const float* bf = static_cast<const float*>(b);
  bf16* a = static_cast<bf16*>(scratch);
  const auto run = [&](auto order) {
    constexpr Taps kOrder = decltype(order)::value;
    if (fp32_io)
      return run_block<kOrder>(static_cast<const float*>(x), dwf, pwb, bf, static_cast<float*>(out),
                               a, N, H, W, C, ldk, reps, s);
    return run_block<kOrder>(static_cast<const bf16*>(x), dwf, pwb, bf, static_cast<bf16*>(out), a,
                             N, H, W, C, ldk, reps, s);
  };
  if (bf16_taps) return run(std::integral_constant<Taps, Taps::kDyBf16>{});
  return run(std::integral_constant<Taps, Taps::kDy>{});
}

const char* mdfd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
