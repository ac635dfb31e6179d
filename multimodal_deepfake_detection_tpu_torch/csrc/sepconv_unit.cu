// Xception separable unit (K5) for Hopper, sm_90a.
//
// Replaces the TPU kernel multimodal_deepfake_detection_tpu/ops/pallas/
// sepconv_unit.py::sepconv_unit_pallas (_unit_kernel):
//     out = [ReLU](pw(dw3x3([ReLU] x)) + b)
// on dense NHWC activations (N, H, W, Cin) -> (N, H, W, Cout) in bf16 or
// fp32, at the TPU kernel's rounding points: the (ReLU'd) input is rounded
// to bf16; the depthwise sums fp32 products dy-major and is rounded to
// bf16; the pointwise accumulates in fp32 and adds the bias; the trailing
// ReLU, if any, comes last; the output is stored in the I/O dtype.
//
// What bounds it on an H100: its targets are the exit sepconvs, conv3
// (1024 -> 1536) and conv4 (1536 -> 2048) at 8^2. At 256 frames those are
// 51.5 and 103 GFLOP of bf16 pointwise work (0.052 and 0.104 ms at 989
// TFLOP/s) against 84 and 117 MB of activations (0.025 and 0.035 ms at 3.35
// TB/s): bound by operations. The design is K1's two launches: the tiled
// depthwise of sm90_common.cuh writing the bf16 GEMM operand, and the
// persistent TMA/wgmma GEMM of bf16_gemm.cuh, whose epilogue writes
// acc + bias (-> ReLU) into a swizzled staging buffer that TMA stores in
// the I/O dtype. Operand rows are padded to 32 elements, as K1's are. On an
// NVIDIA H100 80GB HBM3 at 700 W the GEMM takes 83 us at conv3 and 153 at
// conv4 against 136 and 225 for the one-tile GEMM with a register epilogue
// that it replaced (chip_variants.py --against); without its epilogue 70
// and 139: its loads and MMAs, not the epilogue, set it.
//
// The C interface returns cudaGetLastError() after each launch; the caller
// owns every buffer and the stream.

#include "bf16_gemm.cuh"

namespace {

using namespace mdfd;

template <typename T, bool LEAD, bool TRAIL>
int run_unit(const void* x, const float* dw, const bf16* pw, const float* b, void* out, bf16* a,
             int N, int H, int W, int Cin, int Cout, int ldk, cudaStream_t stream) {
  const int M = N * H * W;
  if (int e = dw3x3_launch<T, bf16, LEAD, Taps::kDy>(static_cast<const T*>(x), dw, a, N, H, W,
                                                     Cin, ldk, stream))
    return e;
  return gemm::launch_persistent<bf16, T, TRAIL>(a, ldk, pw, ldk, b, static_cast<T*>(out),
                                                nullptr, M, Cout, Cin, stream);
}

template <typename T>
int run_io(const void* x, const float* dw, const bf16* pw, const float* b, void* out, bf16* a,
           int N, int H, int W, int Cin, int Cout, int ldk, bool lead, bool trail,
           cudaStream_t stream) {
  if (lead)
    return trail ? run_unit<T, true, true>(x, dw, pw, b, out, a, N, H, W, Cin, Cout, ldk, stream)
                 : run_unit<T, true, false>(x, dw, pw, b, out, a, N, H, W, Cin, Cout, ldk, stream);
  return trail ? run_unit<T, false, true>(x, dw, pw, b, out, a, N, H, W, Cin, Cout, ldk, stream)
               : run_unit<T, false, false>(x, dw, pw, b, out, a, N, H, W, Cin, Cout, ldk, stream);
}

}  // namespace

extern "C" {

// x: (N, H, W, Cin) and out: (N, H, W, Cout), contiguous, bf16 (fp32_io ==
// 0) or fp32 (fp32_io == 1). dw: (9, Cin) fp32 taps; pw: (Cout, ldk) bf16
// [out][in], columns past Cin unread; b: (Cout,) fp32. Scratch: a (N*H*W,
// ldk) bf16. Every pointer 16-byte aligned; Cin, Cout and ldk >= Cin
// multiples of 8. Returns a cudaError_t code, 0 on success.
int mdfd_sepconv_unit(const void* x, const void* dw, const void* pw, const void* b, void* out,
                      void* scratch, int N, int H, int W, int Cin, int Cout, int ldk,
                      int leading_relu, int trailing_relu, int fp32_io, void* stream) {
  const float* dwf = static_cast<const float*>(dw);
  const bf16* pwb = static_cast<const bf16*>(pw);
  const float* bf = static_cast<const float*>(b);
  bf16* a = static_cast<bf16*>(scratch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fp32_io)
    return run_io<float>(x, dwf, pwb, bf, out, a, N, H, W, Cin, Cout, ldk, leading_relu != 0,
                         trailing_relu != 0, s);
  return run_io<bf16>(x, dwf, pwb, bf, out, a, N, H, W, Cin, Cout, ldk, leading_relu != 0,
                      trailing_relu != 0, s);
}

const char* mdfd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
