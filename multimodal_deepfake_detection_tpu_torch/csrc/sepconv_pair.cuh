// The separable pair shared by K3 (entry_block.cu) and K4 (entry_pair.cu)
// for Hopper, sm_90a:
//     mid = ReLU(bf16(dw3x3([ReLU] bf16(x))) @ pw0^T + b0)   -> MidT (N*H*W, Cmid)
//     out = bf16(dw3x3(mid)) @ pw1^T + b1                     -> OutT (N*H*W, Cout)
// in two launches of dw_gemm.cuh's kernel, one per unit, each computing its
// depthwise in the GEMM's A-tile producers in the tap order ORDER, with a
// bias (+ ReLU) epilogue stored by TMA. Neither depthwise result reaches
// device memory; mid does, written once and read once (K4's fp32 mid
// unrounded, as the stream kernel keeps it). At 256 frames of 256^2 that
// leaves block 1's pair x, mid twice and out: 3.6 GB, 1.07 ms at 3.35 TB/s,
// where the four launches of the first design moved 6.7 GB. What bounds the
// launches now is the producers' neighbourhood loads and the consumer's
// per-tile MMA-epilogue chain (dw_gemm.cuh).
#pragma once

#include "dw_gemm.cuh"

namespace mdfd {

template <Taps ORDER, typename T, typename MidT, typename OutT>
int run_pair(const T* x, const float* dw0, const bf16* pw0, const float* b0, const float* dw1,
             const bf16* pw1, const float* b1, OutT* out, MidT* mid, int N, int H, int W, int Cin,
             int Cmid, int Cout, int ldk0, int ldk1, bool leading_relu, cudaStream_t stream) {
  const int M = N * H * W;
  if (int e = leading_relu ? dwg::launch<T, bf16, true, ORDER, MidT, true>(
                                 x, dw0, pw0, ldk0, b0, mid, M, H, W, Cin, Cmid, stream)
                           : dwg::launch<T, bf16, false, ORDER, MidT, true>(
                                 x, dw0, pw0, ldk0, b0, mid, M, H, W, Cin, Cmid, stream))
    return e;
  return dwg::launch<MidT, MidT, false, ORDER, OutT, false>(mid, dw1, pw1, ldk1, b1, out, M, H, W,
                                                           Cmid, Cout, stream);
}

}  // namespace mdfd
