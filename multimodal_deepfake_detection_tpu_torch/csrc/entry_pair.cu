// Xception separable pair (K4) for Hopper, sm_90a.
//
// Replaces three TPU kernels of multimodal_deepfake_detection_tpu/ops/pallas/
// that compute one function with three memory schemes:
//   sepconv_entry.py::entry_pair_pallas (_entry_kernel), whole image;
//   sepconv_stream.py::sepconv_pair_stream_pallas (_stream_kernel), stripes;
//   sepconv_stream2.py::sepconv_pair_stream2_pallas (_stream2_kernel), stripes
//   of a bordered layout:
//     out = pw1(dw3x3(ReLU(pw0(dw3x3([ReLU] x)) + b0))) + b1
// on dense NHWC activations (N, H, W, Cin) -> (N, H, W, Cout) in bf16 or
// fp32, at the TPU kernels' rounding points: x is rounded to bf16; each
// depthwise takes fp32 products and sums them dy-major (the stream kernels,
// stream2 without dx_roll) or per column over dy, then (dx0 + dx1) + dx2
// (entry_pair_pallas, stream2 with dx_roll), and is rounded to bf16; each
// pointwise accumulates in fp32 and adds its bias; mid = ReLU(pw0 + b0) is
// rounded to bf16 (entry_pair_pallas, stream2) or kept in fp32 and read
// unrounded by unit 1's depthwise (sepconv_pair_stream_pallas); the output
// is pw1 + b1 in the I/O dtype, not rounded to bf16 at fp32 I/O.
//
// What bounds it on an H100: at 256 frames of 256^2 the pairs of blocks 1
// and 2 are bound by one read of x and one write of out (0.46 and 0.23 ms
// at 3.35 TB/s), those of blocks 3 and 12 by 376 and 166 GFLOP of bf16
// pointwise work. The design (sepconv_pair.cuh) is two launches, one per
// unit, each a GEMM whose producer warps compute the unit's depthwise into
// the A tile (dw_gemm.cuh): neither depthwise result leaves the chip, and
// mid goes through device memory once each way, so block 1's pair moves
// 3.6 GB (1.07 ms) where the four launches of the first design moved 6.7
// GB. What holds each launch above those bounds is the producers'
// neighbourhood loads and the consumer's per-tile MMA-epilogue chain
// (dw_gemm.cuh, chip_variants.py). The TPU-only storage is not carried
// over: no bordered W2 columns, no channels padded to 128 lanes, no stripe
// heights that must divide H; any W.
//
// The C interface returns cudaGetLastError() after each launch; the caller
// owns every buffer and the stream.

#include "sepconv_pair.cuh"

namespace {

using namespace mdfd;

template <Taps ORDER, typename T>
int run(const T* x, const float* dw0, const bf16* pw0, const float* b0, const float* dw1,
        const bf16* pw1, const float* b1, T* out, void* mid, int N, int H, int W, int Cin,
        int Cmid, int Cout, int ldk0, int ldk1, bool leading_relu, bool mid_fp32,
        cudaStream_t stream) {
  if (mid_fp32)
    return run_pair<ORDER>(x, dw0, pw0, b0, dw1, pw1, b1, out, static_cast<float*>(mid), N, H, W,
                           Cin, Cmid, Cout, ldk0, ldk1, leading_relu, stream);
  return run_pair<ORDER>(x, dw0, pw0, b0, dw1, pw1, b1, out, static_cast<bf16*>(mid), N, H, W,
                         Cin, Cmid, Cout, ldk0, ldk1, leading_relu, stream);
}

template <typename T>
int run_io(const void* x, const float* dw0, const bf16* pw0, const float* b0, const float* dw1,
           const bf16* pw1, const float* b1, void* out, void* mid, int N, int H, int W, int Cin,
           int Cmid, int Cout, int ldk0, int ldk1, bool leading_relu, bool col_sums,
           bool mid_fp32, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (col_sums)
    return run<Taps::kCols>(xt, dw0, pw0, b0, dw1, pw1, b1, ot, mid, N, H, W, Cin, Cmid, Cout,
                            ldk0, ldk1, leading_relu, mid_fp32, stream);
  return run<Taps::kDy>(xt, dw0, pw0, b0, dw1, pw1, b1, ot, mid, N, H, W, Cin, Cmid, Cout, ldk0,
                        ldk1, leading_relu, mid_fp32, stream);
}

}  // namespace

extern "C" {

// x: (N, H, W, Cin) and out: (N, H, W, Cout), contiguous, bf16 (fp32_io ==
// 0) or fp32 (fp32_io == 1). dw0: (9, Cin) and dw1: (9, Cmid) fp32 taps;
// pw0: (Cmid, ldk0), pw1: (Cout, ldk1) bf16 [out][in], columns past Cin /
// Cmid unread; b0: (Cmid,), b1: (Cout,) fp32. Scratch: mid (N*H*W, Cmid)
// bf16 or, with mid_fp32, fp32. Every pointer 16-byte aligned; Cin, Cmid,
// Cout, ldk0 >= Cin and ldk1 >= Cmid multiples of 8. col_sums: K3's
// column-sum tap order, else dy-major. Returns a cudaError_t code, 0 on
// success.
int mdfd_entry_pair(const void* x, const void* dw0, const void* pw0, const void* b0,
                    const void* dw1, const void* pw1, const void* b1, void* out, void* mid, int N,
                    int H, int W, int Cin, int Cmid, int Cout, int ldk0, int ldk1,
                    int leading_relu, int col_sums, int mid_fp32, int fp32_io, void* stream) {
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto h = [](const void* p) { return static_cast<const bf16*>(p); };
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fp32_io)
    return run_io<float>(x, f(dw0), h(pw0), f(b0), f(dw1), h(pw1), f(b1), out, mid, N, H, W, Cin,
                         Cmid, Cout, ldk0, ldk1, leading_relu != 0, col_sums != 0, mid_fp32 != 0,
                         s);
  return run_io<bf16>(x, f(dw0), h(pw0), f(b0), f(dw1), h(pw1), f(b1), out, mid, N, H, W, Cin,
                      Cmid, Cout, ldk0, ldk1, leading_relu != 0, col_sums != 0, mid_fp32 != 0, s);
}

const char* mdfd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
