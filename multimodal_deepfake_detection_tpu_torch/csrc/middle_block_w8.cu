// Xception middle-flow residual block with an int8 pointwise (K2) for
// Hopper, sm_90a.
//
// Replaces the TPU kernel multimodal_deepfake_detection_tpu/ops/pallas/
// sepconv_pos.py::middle_block_pos_pallas_w8 (_pos_q_kernel). One block is
// 3 reps of
//     ReLU -> round to bf16 -> depthwise 3x3 (zero pad 1, fp32 taps already
//     divided by the pointwise input scale s_in, summed dy-major) ->
//     round half to even, clip to +-127, int8 -> pointwise CxC
//     (int8 x int8 -> int32) -> float * (s_dq * s_w) + bias
//     -> (last rep: + block input in fp32) -> store in the I/O dtype,
// on NHWC activations (N, H, W, C) in bf16 or fp32.
//
// Each rep is two launches, K1's (middle_block.cu) with int8 operands:
//   dw3x3_relu_kernel (sm90_common.cuh) — writes the int8 codes of the
//     depthwise result, the GEMM's A operand, to a scratch buffer;
//   gemm::persistent_kernel (bf16_gemm.cuh) with int8 operands — one CTA
//     per SM walks 128 x 256 tiles (wgmma m64n256k32 s8 -> s32, k-tiles of
//     128 summed exactly) through the 3-stage TMA ring that runs across
//     tiles; the epilogue writes float(acc) * (s_dq * s_w) + bias (+ the
//     residual on the last rep, loaded by TMA under the k-loop) into a
//     swizzled staging buffer that TMA stores.
// What bounds a block at 256 frames of 16x16x728 on an H100: the int8 GEMMs,
// 3 x 2 x 65,536 x 728^2 = 208.4 G operations at 1,979 TOPS, 0.105 ms;
// with the int8 operand through device memory between the two launches,
// 0.290 ms (chip_smoke.py's k2_halves line). There, on an NVIDIA H100 80GB
// HBM3 at 700 W, a block takes 0.72 ms against 1.00 for the one-tile GEMM
// with a register epilogue that this design replaced, its GEMM 91 us a
// launch (121 with the residual) against 197, and 60 without its epilogue
// (chip_variants.py): a third of the GEMM is the epilogue, which no MMA
// overlaps, since each consumer warpgroup stores its tile before it starts
// the next one's MMAs.
//
// C need not be a multiple of the tile: TMA zero-fills the ragged K and N
// edges and clips the stores at M and N. Both GEMM operands have rows of
// `ldk` bytes, a multiple of 64 >= C (TMA needs 16-byte global strides, and
// rows that start on 64-byte boundaries load faster); columns past C are
// never read. The epilogue rounds each product and sum on its own
// (__fmul_rn, __fadd_rn), in the plain version's order, so the block is
// bit-equal to it.
//
// The C interface returns cudaGetLastError() after each launch; the caller
// owns every buffer and the stream.

#include "bf16_gemm.cuh"

namespace {

using namespace mdfd;

template <typename T>
int run_block(const T* x, const float* taps, const int8_t* pw, const float* sc, const float* b,
              T* out, int8_t* a, int N, int H, int W, int C, int ldk, int reps,
              cudaStream_t stream) {
  const int M = N * H * W;
  DwLaunch dw_launch;
  if (int e = dw3x3_setup<T, int8_t>(N, H, W, C, &dw_launch)) return e;
  for (int r = 0; r < reps; ++r) {
    const T* src = r == 0 ? x : out;
    dw3x3_relu_kernel<T, int8_t><<<dw_launch.grid, DW_THREADS, dw_launch.smem, stream>>>(
        src, taps + static_cast<size_t>(r) * 9 * C, a, H, W, C, ldk, dw_launch.rows_per_band,
        dw_launch.cols_per_tile, dw_launch.chans);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const T* resid = r + 1 == reps ? x : nullptr;
    if (int e = gemm::launch_persistent(a, ldk, pw + static_cast<size_t>(r) * C * ldk, ldk,
                                        b + static_cast<size_t>(r) * C, out, resid, M, C, C,
                                        stream, sc + static_cast<size_t>(r) * C))
      return e;
  }
  return 0;
}

}  // namespace

extern "C" {

// x, out: (N, H, W, C) contiguous, bf16 (fp32_io == 0) or fp32 (fp32_io == 1);
// taps: (reps, 9, C) fp32, already divided by s_in; pw: (reps, C, ldk) int8
// [out][in], columns past C unread; sc: (reps, C) fp32 = s_dq * s_w;
// b: (reps, C) fp32; scratch: N*H*W*ldk int8; every pointer 16-byte aligned,
// C % 8 == 0, ldk % 16 == 0, ldk >= C.
// Returns a cudaError_t code, 0 on success.
int mdfd_middle_block_w8(const void* x, const void* taps, const void* pw, const void* sc,
                         const void* b, void* out, void* scratch, int N, int H, int W, int C,
                         int ldk, int reps, int fp32_io, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* tf = static_cast<const float*>(taps);
  const int8_t* pq = static_cast<const int8_t*>(pw);
  const float* scf = static_cast<const float*>(sc);
  const float* bf = static_cast<const float*>(b);
  int8_t* a = static_cast<int8_t*>(scratch);
  if (fp32_io)
    return run_block(static_cast<const float*>(x), tf, pq, scf, bf, static_cast<float*>(out), a,
                     N, H, W, C, ldk, reps, s);
  return run_block(static_cast<const bf16*>(x), tf, pq, scf, bf, static_cast<bf16*>(out), a, N,
                   H, W, C, ldk, reps, s);
}

const char* mdfd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
