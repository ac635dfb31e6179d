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
// What bounds it on an H100, at 256 frames of 16x16x728: the int8 GEMMs,
// 3 x 2 x 65,536 x 728^2 = 208.4 G operations at 1,979 TOPS, 0.105 ms; the
// block's input read and output written once are 190.8 MB, 0.057 ms. This
// is the simple form, two kernels per rep:
//   dw3x3_relu_kernel (sm90_common.cuh, K1's) — memory-bound: writes the
//     int8 codes of the depthwise result to a scratch buffer;
//   pw_gemm_s8_kernel — tensor cores through wgmma m64n256k32 (s8 x s8 ->
//     s32) on 128x256x128 tiles in 128-byte-swizzled shared memory, filled
//     by TMA in a 4-stage mbarrier pipeline; the epilogue converts the exact
//     int32 sums, applies the dequant scale and the bias, adds the residual
//     on the last rep and stores in the I/O dtype from registers.
// It moves about 0.95 GB per block (each rep reads its input, writes and
// reads back the int8 operand, writes its output). Fusing the depthwise into
// the GEMM's A-tile load is later work.
//
// C need not be a multiple of the tile: TMA zero-fills the ragged K and N
// edges and the epilogue masks N. Both GEMM operands have rows of `ldk`
// bytes, a multiple of 64 >= C (TMA needs 16-byte global strides, and rows
// that start on 64-byte boundaries load faster); columns past C are never
// read. The epilogue rounds each product and sum on its own (__fmul_rn,
// __fadd_rn), in the plain version's order. The int32 sum of C <= 1039
// products of +-127 stays below 2^24, so its conversion to fp32 is exact.
//
// The C interface returns cudaGetLastError() after each launch; the caller
// owns every buffer and the stream.

#include "sm90_common.cuh"

namespace {

using namespace mdfd;

constexpr int BM = 128;
constexpr int BN = 256;
constexpr int BK = 128;  // one 128-byte swizzle row of int8
constexpr int STAGES = 4;
constexpr int A_TILE = BM * BK;  // bytes per stage
constexpr int B_TILE = BN * BK;
constexpr int STAGE_BYTES = A_TILE + B_TILE;
constexpr int GEMM_THREADS = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int GEMM_SMEM = STAGES * STAGE_BYTES + 1024;  // + room to align to 1024
constexpr int EPI_J = 4;  // epilogue column groups whose loads go out together

// D[64 x 256] += A[64 x 32] * B[32 x 256]^T, int8 operands K-major in shared
// memory, int32 accumulators in the warpgroup's registers.
__device__ __forceinline__ void wgmma_m64n256k32_s8(int d[128], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));  // scale-d = 1: D += A * B
}

// out[M, C] = float(A[M, C] @ Bt[C, C]^T) * sc + bias (+ resid). A CTA is
// three warpgroups: one thread of the first issues TMA loads, the other two
// compute a 128 x 256 tile, 64 rows each. Both operands are K-major (A rows
// are pixels, Bt rows are output channels), staged 128 bytes K-wide in the
// canonical 128-byte-swizzled layout, 4 stages deep: a stage's "full"
// mbarrier completes when its bytes land, its "empty" one when both
// consumers are done with it. The pipeline is K1's (middle_block.cu).
template <typename T>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
pw_gemm_s8_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b, const float* __restrict__ sc,
                  const float* __restrict__ bias, const T* __restrict__ resid,
                  T* __restrict__ out, int M, int C) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[STAGES];
  __shared__ uint64_t empty[STAGES];
  // swizzled tiles need 1024-byte alignment
  int8_t* As = reinterpret_cast<int8_t*>(smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  int8_t* Bs = As + STAGES * A_TILE;

  const int tid = threadIdx.x;
  // N tiles vary fastest: the CTAs that share an A tile run together
  const int n_tiles = (C + BN - 1) / BN;
  const int m0 = (blockIdx.x / n_tiles) * BM;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int KT = (C + BK - 1) / BK;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {  // producer warpgroup: one thread streams the k-tiles
    if (tid == 0) {
      for (int kt = 0; kt < KT; ++kt) {
        const int stage = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[stage], ((kt / STAGES) - 1) & 1);
        mbar_expect_tx(&full[stage], STAGE_BYTES);
        tma_load(As + stage * A_TILE, &map_a, kt * BK, m0, &full[stage]);
        tma_load(Bs + stage * B_TILE, &map_b, kt * BK, n0, &full[stage]);
      }
    }
    return;
  }

  const int wg = (tid >> 7) - 1;  // consumer warpgroup: rows wg*64 .. wg*64+63 of the tile
  int d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0;

  for (int kt = 0; kt < KT; ++kt) {
    const int stage = kt % STAGES;
    mbar_wait(&full[stage], (kt / STAGES) & 1);
    const int8_t* as = As + stage * A_TILE + wg * 64 * BK;
    const int8_t* bs = Bs + stage * B_TILE;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < BK / 32; ++s)
      wgmma_m64n256k32_s8(d, make_desc(as + s * 32), make_desc(bs + s * 32));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // keep this k-tile's MMAs in flight; the previous k-tile's are done, so
    // its stage goes back to the producer
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    if (kt > 0 && (tid & 127) == 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

  // Accumulator layout (as K1's): warp w of the warpgroup holds rows
  // w*16 + lane/4 and +8; d[4j .. 4j+3] are columns 8j + 2*(lane%4) and the
  // next, upper then lower row. The scale, bias and residual loads of EPI_J
  // column groups go out together, before any of their stores.
  const int lane = tid & 31;
  const int row = m0 + wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int j0 = 0; j0 < BN / 8; j0 += EPI_J) {
    float2 sv[EPI_J], bv[EPI_J], rv[EPI_J][2];
#pragma unroll
    for (int jj = 0; jj < EPI_J; ++jj) {
      const int n = n0 + (j0 + jj) * 8 + (lane & 3) * 2;  // C % 8 == 0: n < C implies n + 1 < C
      sv[jj] = n < C ? *reinterpret_cast<const float2*>(sc + n) : make_float2(0.f, 0.f);
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
          // float(acc) * sc + bias (+ residual): the plain version's order
          float v0 = __fadd_rn(__fmul_rn(__int2float_rn(d[4 * j + 2 * half]), sv[jj].x), bv[jj].x);
          float v1 = __fadd_rn(__fmul_rn(__int2float_rn(d[4 * j + 2 * half + 1]), sv[jj].y), bv[jj].y);
          if (resid != nullptr) {
            v0 = __fadd_rn(v0, rv[jj][half].x);
            v1 = __fadd_rn(v1, rv[jj][half].y);
          }
          store2(out + static_cast<size_t>(m) * C + n, v0, v1);
        }
      }
    }
  }
}

template <typename T>
int run_block(const T* x, const float* taps, const int8_t* pw, const float* sc, const float* b,
              T* out, int8_t* a, int N, int H, int W, int C, int ldk, int reps,
              cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(pw_gemm_s8_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int M = N * H * W;
  const int gemm_grid = ((M + BM - 1) / BM) * ((C + BN - 1) / BN);
  CUtensorMap map_a;
  if (int e = make_map(&map_a, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a, M, C, ldk, BM)) return e;
  DwLaunch dw_launch;
  if (int e = dw3x3_setup<T, int8_t>(N, H, W, C, &dw_launch)) return e;
  for (int r = 0; r < reps; ++r) {
    const T* src = r == 0 ? x : out;
    dw3x3_relu_kernel<T, int8_t><<<dw_launch.grid, DW_THREADS, dw_launch.smem, stream>>>(
        src, taps + static_cast<size_t>(r) * 9 * C, a, H, W, C, ldk, dw_launch.rows_per_band,
        dw_launch.cols_per_tile, dw_launch.chans);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    CUtensorMap map_b;
    if (int e = make_map(&map_b, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                         pw + static_cast<size_t>(r) * C * ldk, C, C, ldk, BN))
      return e;
    pw_gemm_s8_kernel<T><<<gemm_grid, GEMM_THREADS, GEMM_SMEM, stream>>>(
        map_a, map_b, sc + static_cast<size_t>(r) * C, b + static_cast<size_t>(r) * C,
        r + 1 == reps ? x : nullptr, out, M, C);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
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
