// The separable pair shared by K3 (entry_block.cu) and K4 (entry_pair.cu)
// for Hopper, sm_90a:
//     a0  = dw3x3([ReLU] bf16(x))                    -> bf16 (N*H*W, ldk0)
//     mid = ReLU(a0 @ pw0^T + b0)                    -> MidT (N*H*W, Cmid)
//     a1  = dw3x3(mid)                               -> bf16 (N*H*W, ldk1)
//     out = a1 @ pw1^T + b1                          -> OutT (N*H*W, Cout)
// in four launches: the banded depthwise of sm90_common.cuh in the tap order
// ORDER, and the TMA/wgmma GEMM of bf16_gemm.cuh with a bias (+ ReLU)
// epilogue. A bf16 mid is rounded once, by the epilogue; an fp32 mid is
// staged by unit 1's depthwise without rounding.
#pragma once

#include "bf16_gemm.cuh"

namespace mdfd {

template <Taps ORDER, typename T, typename MidT, typename OutT>
int run_pair(const T* x, const float* dw0, const bf16* pw0, const float* b0, const float* dw1,
             const bf16* pw1, const float* b1, OutT* out, bf16* a0, MidT* mid, bf16* a1, int N,
             int H, int W, int Cin, int Cmid, int Cout, int ldk0, int ldk1, bool leading_relu,
             cudaStream_t stream) {
  const int M = N * H * W;
  if (int e = leading_relu
                  ? dw3x3_launch<T, bf16, true, ORDER>(x, dw0, a0, N, H, W, Cin, ldk0, stream)
                  : dw3x3_launch<T, bf16, false, ORDER>(x, dw0, a0, N, H, W, Cin, ldk0, stream))
    return e;
  if (int e = gemm::launch(a0, ldk0, pw0, ldk0, M, Cmid, Cin,
                           gemm::BiasEpilogue<MidT, true>{b0, mid, M, Cmid}, stream))
    return e;
  if (int e = dw3x3_launch<MidT, bf16, false, ORDER, MidT>(mid, dw1, a1, N, H, W, Cmid, ldk1,
                                                            stream))
    return e;
  return gemm::launch(a1, ldk1, pw1, ldk1, M, Cout, Cmid,
                      gemm::BiasEpilogue<OutT, false>{b1, out, M, Cout}, stream);
}

}  // namespace mdfd
