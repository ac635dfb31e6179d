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
// Each rep is two launches, each bound on its own:
//   dw3x3_relu_kernel (sm90_common.cuh, shared with K2 and K5) — reads the
//     rep input once and writes the bf16 depthwise result (the GEMM's A
//     operand) to a scratch buffer, 57 us of device memory at (256, 16,
//     16, 728); a block stages a whole 16 x 16 image's 64 channels, and each
//     thread slides its 3 x 3 window, taps in registers, along a run of
//     pixels.
//   gemm::persistent_kernel (bf16_gemm.cuh) — one CTA per SM walks 128 x 256
//     tiles (wgmma m64n256k16, bf16 in, fp32 accumulate, k-tiles of 64
//     summed in ascending order) through a 3-stage TMA ring that runs
//     across tiles; the epilogue writes (acc + bias) (+ residual on the last
//     rep, loaded by TMA under the k-loop) into a swizzled staging buffer
//     that TMA stores. A GEMM of one tile per CTA whose epilogue stored
//     4-byte pairs and loaded the residual from registers took 218 us a
//     launch at (256, 16, 16, 728), this one 147 (NVIDIA H100 80GB HBM3,
//     700 W; chip_variants.py k1). What bounds it there: the tile reads 48
//     KB from L2 per 64-deep k-tile (85 FLOP a byte), 906 MB a launch, so
//     ≈ 6.2 TB/s out of L2; sharing the weight tile across a cluster by
//     TMA multicast would halve it.
// The A operand's round trip through device memory between the two keeps
// the pair above the block's own bound; fusing the depthwise into the
// GEMM's producer is later work.
// C need not be a multiple of the tile: TMA zero-fills the ragged K and N
// edges and clips the stores at M and N. C must be a multiple of 8 so that
// every row starts on a 16-byte boundary. The GEMM's operands (the depthwise
// result and the pointwise weight) have rows of `ldk` >= C elements: on an
// H100, TMA loads rows that start on 64-byte boundaries about 1.4x as fast
// as C = 728's 1456-byte rows, every other one of which starts mid-sector.
//
// The C interface returns cudaGetLastError() after each launch; the caller
// owns every buffer and the stream.

#include "bf16_gemm.cuh"

namespace {

using namespace mdfd;

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
        dw_launch.cols_per_tile, dw_launch.chans);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const T* resid = r + 1 == reps ? x : nullptr;
    if (int e = gemm::launch_persistent(a, ldk, pw + static_cast<size_t>(r) * C * ldk, ldk,
                                        b + static_cast<size_t>(r) * C, out, resid, M, C, C,
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
