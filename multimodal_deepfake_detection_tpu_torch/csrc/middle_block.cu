// Xception middle-flow residual block (K1) for Hopper, sm_90a.
//
// Replaces the TPU kernel multimodal_deepfake_detection_tpu/ops/pallas/
// sepconv_pos.py::middle_block_pos_pallas (_pos_kernel). One block is
// 3 reps of
//     ReLU -> round to bf16 -> depthwise 3x3 (zero pad 1, fp32 taps summed
//     dy-major) -> round to bf16 -> pointwise CxC (bf16 x bf16 -> fp32) + bias
//     -> (last rep: + block input in fp32) -> store in the I/O dtype,
// on NHWC activations (N, H, W, C) in bf16 or fp32.
//
// Each rep is two kernels:
//   dw3x3_relu_kernel (sm90_common.cuh, shared with K2) — memory-bound:
//     reads the rep input, writes the bf16 depthwise result (the GEMM's A
//     operand) to a scratch buffer; bands of rows x 64 channels are staged
//     in shared memory with their halo.
//   pw_gemm_kernel    — tensor cores through wgmma m64n256k16 (bf16 in, fp32
//     accumulate) on 128x256x64 tiles in 128-byte-swizzled shared memory,
//     filled by TMA in a 4-stage mbarrier pipeline; the epilogue adds the
//     bias, the residual on the last rep, and stores in the I/O dtype from
//     registers.
// C need not be a multiple of the tile: TMA zero-fills the ragged K and N
// edges and the epilogue masks N. C must be a multiple of 8 so that every
// row starts on a 16-byte boundary. The GEMM's operands (the depthwise
// result and the pointwise weight) have rows of `ldk` >= C elements: on an
// H100, TMA loads rows that start on 64-byte boundaries about 1.4x as fast
// as C = 728's 1456-byte rows, every other one of which starts mid-sector.
//
// The C interface returns cudaGetLastError() after each launch; the caller
// owns every buffer and the stream.

#include "sm90_common.cuh"

namespace {

using namespace mdfd;

// ---------------------------------------------------------------------------
// (b) out[M, C] = A[M, C] @ Bt[C, C]^T + bias (+ resid), bf16 operands, fp32
// accumulation, with Hopper's warpgroup MMA. A CTA is three warpgroups: one
// thread of the first issues TMA loads, the other two compute a 128 x 256
// tile, 64 rows each (wgmma m64n256k16). Both operands are K-major (A rows
// are pixels, Bt rows are output channels), staged 64 K-wide (128-byte rows)
// in the canonical 128-byte-swizzled layout, 4 stages deep: a stage's "full"
// mbarrier completes when its bytes land, its "empty" one when both
// consumers are done with it. The epilogue works from the accumulator
// registers.
// ---------------------------------------------------------------------------
constexpr int BM = 128;
constexpr int BN = 256;
constexpr int BK = 64;  // one 128-byte swizzle row of bf16
constexpr int STAGES = 4;
constexpr int A_TILE = BM * BK;  // elements per stage
constexpr int B_TILE = BN * BK;
constexpr int STAGE_BYTES = (A_TILE + B_TILE) * static_cast<int>(sizeof(bf16));
constexpr int GEMM_THREADS = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int GEMM_SMEM = STAGES * STAGE_BYTES + 1024;  // + room to align to 1024
constexpr int EPI_J = 4;  // epilogue column groups whose loads go out together

// D[64 x 256] += A[64 x 16] * B[16 x 256]^T, both operands K-major in shared
// memory, fp32 accumulators in the warpgroup's registers.
__device__ __forceinline__ void wgmma_m64n256k16(float d[128], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));  // scale-d = 1: D += A * B
}

template <typename T>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
pw_gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
               const float* __restrict__ bias, const T* __restrict__ resid,
               T* __restrict__ out, int M, int C) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[STAGES];
  __shared__ uint64_t empty[STAGES];
  // swizzled tiles need 1024-byte alignment
  bf16* As = reinterpret_cast<bf16*>(smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  bf16* Bs = As + STAGES * A_TILE;

  const int tid = threadIdx.x;
  // N tiles vary fastest: the CTAs that share an A tile run together, so A
  // comes from device memory once and Bt stays resident in L2
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
  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.f;

  for (int kt = 0; kt < KT; ++kt) {
    const int stage = kt % STAGES;
    mbar_wait(&full[stage], (kt / STAGES) & 1);
    const bf16* as = As + stage * A_TILE + wg * 64 * BK;
    const bf16* bs = Bs + stage * B_TILE;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < BK / 16; ++s) wgmma_m64n256k16(d, make_desc(as + s * 16), make_desc(bs + s * 16));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // keep this k-tile's MMAs in flight; the previous k-tile's are done, so
    // its stage goes back to the producer
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    if (kt > 0 && (tid & 127) == 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

  // Accumulator layout: warp w of the warpgroup holds rows w*16 + lane/4 and
  // +8; d[4j .. 4j+3] are columns 8j + 2*(lane%4) and the next, upper then
  // lower row. The bias and residual loads of EPI_J column groups go out
  // together, before any of their stores, so that their round trips overlap:
  // issued one at a time between stores they cost more than the k-loop.
  const int lane = tid & 31;
  const int row = m0 + wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);  // warpgroups are 128-aligned
#pragma unroll
  for (int j0 = 0; j0 < BN / 8; j0 += EPI_J) {
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

template <typename T>
int run_block(const T* x, const float* dw, const bf16* pw, const float* b, T* out, bf16* a,
              int N, int H, int W, int C, int ldk, int reps, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(pw_gemm_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int M = N * H * W;
  const int gemm_grid = ((M + BM - 1) / BM) * ((C + BN - 1) / BN);
  CUtensorMap map_a;
  if (int e = make_map(&map_a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a, M, C, ldk, BM)) return e;
  DwLaunch dw_launch;
  if (int e = dw3x3_setup<T, bf16>(N, H, W, C, &dw_launch)) return e;
  for (int r = 0; r < reps; ++r) {
    const T* src = r == 0 ? x : out;
    dw3x3_relu_kernel<T, bf16><<<dw_launch.grid, DW_THREADS, dw_launch.smem, stream>>>(
        src, dw + static_cast<size_t>(r) * 9 * C, a, H, W, C, ldk, dw_launch.rows_per_band);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    CUtensorMap map_b;
    if (int e = make_map(&map_b, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                         pw + static_cast<size_t>(r) * C * ldk, C, C, ldk, BN))
      return e;
    pw_gemm_kernel<T><<<gemm_grid, GEMM_THREADS, GEMM_SMEM, stream>>>(
        map_a, map_b, b + static_cast<size_t>(r) * C, r + 1 == reps ? x : nullptr, out, M, C);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

extern "C" {

// x, out: (N, H, W, C) contiguous, bf16 (fp32_io == 0) or fp32 (fp32_io == 1);
// dw: (reps, 9, C) fp32; pw: (reps, C, ldk) bf16 [out][in], columns past C
// unread; b: (reps, C) fp32; scratch: N*H*W*ldk bf16; every pointer 16-byte
// aligned, C % 8 == 0, ldk % 8 == 0, ldk >= C.
// Returns a cudaError_t code, 0 on success.
int mdfd_middle_block(const void* x, const void* dw, const void* pw, const void* b, void* out,
                      void* scratch, int N, int H, int W, int C, int ldk, int reps, int fp32_io,
                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dwf = static_cast<const float*>(dw);
  const bf16* pwb = static_cast<const bf16*>(pw);
  const float* bf = static_cast<const float*>(b);
  bf16* a = static_cast<bf16*>(scratch);
  if (fp32_io)
    return run_block(static_cast<const float*>(x), dwf, pwb, bf, static_cast<float*>(out), a, N,
                     H, W, C, ldk, reps, s);
  return run_block(static_cast<const bf16*>(x), dwf, pwb, bf, static_cast<bf16*>(out), a, N, H,
                   W, C, ldk, reps, s);
}

const char* mdfd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
