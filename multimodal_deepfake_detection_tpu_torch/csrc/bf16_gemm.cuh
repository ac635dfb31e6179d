// The pointwise GEMM of the hand-written kernels for Hopper, sm_90a:
//     out[M, N] = epilogue(A[M, K] @ Bt[N, K]^T)
// with Hopper's warpgroup MMA. A CTA is three warpgroups: one thread of the
// first issues TMA loads, the other two compute a 128 x 256 tile, 64 rows
// each. Both operands are K-major (A rows are pixels, Bt rows are output
// channels), staged one 128-byte swizzle row K-wide per k-tile in the
// canonical 128-byte-swizzled layout: a stage's "full" mbarrier completes
// when its bytes land, its "empty" one when both consumers are done with
// it. TMA zero-fills the ragged K and N edges. Two kernels:
//   - gemm_kernel (K3's skip GEMM, entry_block.cu): bf16 operands, fp32
//     accumulation (wgmma m64n256k16), one tile per CTA, 4 stages; the
//     epilogue is a functor that works from the accumulator registers and
//     masks M and N itself; one with kStaged first fills the freed stage
//     memory from device memory (`stage`), all consumer threads together,
//     and then reads it back beside the accumulators.
//   - persistent_kernel (K1, middle_block.cu; K2, middle_block_w8.cu; K5,
//     sepconv_unit.cu): bf16 operands with fp32 accumulation (k-tiles of 64,
//     wgmma m64n256k16) or int8 operands with exact int32 accumulation
//     (k-tiles of 128, wgmma m64n256k32 s8): the same 128-byte rows, stages,
//     descriptors and tile walk. One CTA per SM walks its tiles gridDim.x
//     apart, N tiles fastest (the N tiles of one A tile run together, so A
//     comes from L2); the stage ring runs across tiles, so the producer
//     loads the next tile's k-tiles while the consumers run this tile's
//     epilogue. Each consumer warpgroup writes ([float(acc) * scale] + bias
//     [-> ReLU] [+ the residual]) through its own swizzled staging buffer,
//     which TMA stores, clipped at M and N (store_tile); the residual arrives
//     by TMA in the same buffer while the k-loop runs.
// store_tile and the wgmma, descriptor and operand-map helpers also serve
// dw_gemm.cuh (K3's and K4's pair).
#pragma once

#include "sm90_common.cuh"

namespace mdfd {
namespace gemm {

constexpr int BM = 128;
constexpr int BN = 256;
constexpr int BK = 64;  // one 128-byte swizzle row of bf16
constexpr int STAGES = 4;
constexpr int A_TILE = BM * BK;  // bf16 elements per stage
constexpr int B_TILE = BN * BK;
// a stage's A and B tiles in bytes, for either operand type
constexpr int A_BYTES = BM * 128;
constexpr int B_BYTES = BN * 128;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int THREADS = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int SMEM = STAGES * STAGE_BYTES + 1024;  // + room to align to 1024

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

// persistent_kernel's operand types. A k-tile is one 128-byte swizzle row
// either way (64 bf16 or 128 int8 elements), and each of its four MMAs
// reads 32 bytes of K, so the stages, boxes and descriptors are shared.
template <typename E>
struct Operand;
template <>
struct Operand<bf16> {
  using Acc = float;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ void mma(float d[128], uint64_t a, uint64_t b) {
    wgmma_m64n256k16(d, a, b);
  }
};
template <>
struct Operand<int8_t> {
  using Acc = int;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  static __device__ __forceinline__ void mma(int d[128], uint64_t a, uint64_t b) {
    wgmma_m64n256k32_s8(d, a, b);
  }
};

// Accumulator layout handed to the epilogue: warp w of the warpgroup holds
// rows w*16 + lane/4 and +8 (`row` and `row + 8`); d[4j .. 4j+3] are columns
// n0 + 8j + 2*(lane%4) and the next, upper then lower row. The functor is
// called as epi(d, row, n0, lane, smem) and masks rows >= M and columns
// >= N; `smem` is the 1024-aligned stage memory, STAGES * STAGE_BYTES.
template <class Epi>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
            int N, int K, const Epi epi) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[STAGES];
  __shared__ uint64_t empty[STAGES];
  // swizzled tiles need 1024-byte alignment
  bf16* As = reinterpret_cast<bf16*>(smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  bf16* Bs = As + STAGES * A_TILE;

  const int tid = threadIdx.x;
  // N tiles vary fastest: the CTAs that share an A tile run together, so A
  // comes from device memory once and Bt stays resident in L2
  const int n_tiles = (N + BN - 1) / BN;
  const int m0 = (blockIdx.x / n_tiles) * BM;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int KT = (K + BK - 1) / BK;

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

  if constexpr (Epi::kStaged) {
    // both consumer warpgroups are done with the stages (the producer has
    // exited), then every consumer thread helps fill them
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    epi.stage(m0, n0, tid - 128, As);
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
  }
  const int lane = tid & 31;
  const int row = m0 + wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);  // warpgroups are 128-aligned
  epi(d, row, n0, lane, As);
}

// One consumer warpgroup's epilogue: acc + bias [-> ReLU] [+ residual] of
// fp32 accumulators, or float(acc) * scale + bias [+ residual] of int32
// ones (each product and sum rounded on its own, no FMA), of the 64 x 256
// tile at (m0, n0) -> OutT, through `staged` (STAGED bytes of 64-row boxes
// of 128-byte rows in the 128-byte swizzle) and TMA stores into map_out's
// (M, N), which clip at M and N; a tile at or past M stores nothing. A pass
// covers the columns `staged` holds (bf16 in 32 KB: all 256 at once; fp32:
// 128); before a pass overwrites `staged`, thread 0 waits until the stores
// of the last pass have read it. With RESID the pass's residual (map_res's
// same tile, the output's dtype) lies in `staged`, loaded by TMA on
// res_full: the caller issues the first pass's (load_boxes); the later
// passes' load here once `staged` is free. The residual is added last, in
// fp32: the plain versions' order. An int32 sum of C <= 1039 products of
// +-127 stays below 2^24, so its conversion is exact. `bar` names the
// warpgroup's barrier. The accumulator layout is wgmma's: warp w holds rows
// 16w + lane/4 and +8, d[4j .. 4j+3] columns 8j + 2*(lane%4) and the next,
// upper row then lower.
struct Residual {
  const CUtensorMap* map;
  uint64_t* full;  // one phase per pass
  unsigned uses;   // phases waited so far
};

constexpr int BOX_BYTES = 64 * 128;  // a staged box: 64 rows of 128 bytes

// The boxes of one pass of `staged` from map's rows m0.., columns c0..,
// completing on `full`; boxes at or past N are not loaded. One thread.
template <typename T, int STAGED>
__device__ __forceinline__ void load_boxes(const CUtensorMap* map, unsigned char* staged, int m0,
                                           int c0, int N, uint64_t* full) {
  constexpr int BOX_COLS = 128 / static_cast<int>(sizeof(T));
  constexpr int BOXES = STAGED / BOX_BYTES;
  int live = 0;
#pragma unroll
  for (int box = 0; box < BOXES; ++box) live += c0 + box * BOX_COLS < N;
  mbar_expect_tx(full, live * BOX_BYTES);
#pragma unroll
  for (int box = 0; box < BOXES; ++box)
    if (c0 + box * BOX_COLS < N) tma_load(staged + box * BOX_BYTES, map, c0 + box * BOX_COLS, m0, full);
}

template <typename OutT, bool RELU_OUT, int STAGED = 4 * BOX_BYTES, bool RESID = false,
          typename Acc>
__device__ __forceinline__ void store_tile(const Acc* d, const CUtensorMap* map_out,
                                           const float* __restrict__ bias,
                                           unsigned char* staged, int m0, int n0, int M, int N,
                                           int ctid, int bar = 1, Residual* res = nullptr,
                                           const float* __restrict__ scale = nullptr) {
  constexpr bool kInt = std::is_same_v<Acc, int>;
  constexpr int BOX_COLS = 128 / static_cast<int>(sizeof(OutT));  // columns per 128-byte row
  constexpr int PASS_COLS = STAGED / BOX_BYTES * BOX_COLS;
  constexpr int JP = PASS_COLS / 8;  // accumulator groups a pass
  static_assert(BN % PASS_COLS == 0, "a pass holds a whole number of boxes");
  if (m0 >= M) return;  // the warpgroup's rows all lie past M
  const int lane = ctid & 31;
  const int r = ((ctid >> 5) & 3) * 16 + (lane >> 2);  // upper row; lower is r + 8
#pragma unroll
  for (int pass = 0; pass < BN / PASS_COLS; ++pass) {
    if (ctid == 0) {
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      if constexpr (RESID) {
        if (pass > 0)
          load_boxes<OutT, STAGED>(res->map, staged, m0, n0 + pass * PASS_COLS, N, res->full);
      }
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(bar) : "memory");
    if constexpr (RESID) mbar_wait(res->full, res->uses++ & 1);
#pragma unroll
    for (int jj = 0; jj < JP; ++jj) {
      const int j = pass * JP + jj;
      const int col = jj * 8 + (lane & 3) * 2;  // within the pass
      const int n = n0 + pass * PASS_COLS + col;
      const float2 bv = n < N ? *reinterpret_cast<const float2*>(bias + n) : make_float2(0.f, 0.f);
      float2 sv;
      if constexpr (kInt)
        sv = n < N ? *reinterpret_cast<const float2*>(scale + n) : make_float2(0.f, 0.f);
      const int box = col / BOX_COLS;
      const int byte = (col % BOX_COLS) * static_cast<int>(sizeof(OutT));
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rr = r + half * 8;
        float v0, v1;
        if constexpr (kInt) {
          v0 = __fadd_rn(__fmul_rn(__int2float_rn(d[4 * j + 2 * half]), sv.x), bv.x);
          v1 = __fadd_rn(__fmul_rn(__int2float_rn(d[4 * j + 2 * half + 1]), sv.y), bv.y);
        } else {
          v0 = d[4 * j + 2 * half] + bv.x;
          v1 = d[4 * j + 2 * half + 1] + bv.y;
        }
        if (RELU_OUT) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        // chunk c of row rr sits at chunk c ^ (rr % 8)
        OutT* p = reinterpret_cast<OutT*>(staged + box * BOX_BYTES + rr * 128 +
                                          ((((byte >> 4) ^ (rr & 7)) << 4) | (byte & 15)));
        if constexpr (RESID) {  // read and overwritten by this thread alone
          const float2 rv = load2(p);
          v0 += rv.x;
          v1 += rv.y;
        }
        store2(p, v0, v1);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(bar) : "memory");
    if (ctid == 0) {
#pragma unroll
      for (int box = 0; box < STAGED / BOX_BYTES; ++box) {
        const int c0 = n0 + pass * PASS_COLS + box * BOX_COLS;
        if (c0 < N) tma_store(map_out, staged + box * BOX_BYTES, c0, m0);
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
}

// persistent_kernel's ring and staging: 3 stages of 48 KB and a 32 KB
// staging buffer per consumer warpgroup (bf16 stores a tile in one pass),
// 208 KB. Four stages leave room for 16 KB per warpgroup (two passes for
// bf16, and a residual load that waits on the first pass's store); at K1's
// shape that layout is no faster (chip_variants.py k1).
constexpr int P_STAGES = 3;
constexpr int P_STAGED = 32 * 1024;
constexpr int P_SMEM = P_STAGES * STAGE_BYTES + 2 * P_STAGED + 1024;  // + room to align

// out[M, N] = ([float(A @ Bt^T) * scale] + bias) [-> ReLU] [+ res] in T,
// persistent over the tiles; E is the operands' type (bf16 or int8), and
// `scale` (N,) fp32 is read for int8 alone. A residual rep (RESID): the
// consumer warpgroup's thread 0 issues the TMA load of its first pass's
// residual into `staged` once its last store has read it (only the thread
// that committed a bulk store can wait for it), with the MMAs of the tile's
// middle k-tile in flight: that store has drained by then, and the load
// lands before the epilogue.
template <typename E, typename T, bool RELU_OUT, bool RESID>
__global__ void __launch_bounds__(THREADS, 1)
persistent_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                  const __grid_constant__ CUtensorMap map_out,
                  const __grid_constant__ CUtensorMap map_res, const float* __restrict__ bias,
                  const float* __restrict__ scale, int M, int N, int K) {
  constexpr int K_TILE = 128 / static_cast<int>(sizeof(E));  // elements of a k-tile
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[P_STAGES];
  __shared__ uint64_t empty[P_STAGES];
  __shared__ uint64_t res_full[2];
  // swizzled tiles need 1024-byte alignment
  unsigned char* As = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* Bs = As + P_STAGES * A_BYTES;
  unsigned char* staged_all = Bs + P_STAGES * B_BYTES;

  const int tid = threadIdx.x;
  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = ((M + BM - 1) / BM) * n_tiles;
  const int KT = (K + K_TILE - 1) / K_TILE;
  const int mine = (tiles - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) /
                   static_cast<int>(gridDim.x);

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < P_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    mbar_init(&res_full[0], 1);
    mbar_init(&res_full[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {  // producer warpgroup: one thread streams the k-tiles of every tile
    if (tid == 0) {
      int step = 0;  // the CTA's k-tiles so far: stage step % P_STAGES
      for (int i = 0; i < mine; ++i) {
        const int tile = blockIdx.x + i * gridDim.x;
        const int m0 = (tile / n_tiles) * BM;
        const int n0 = (tile % n_tiles) * BN;
        for (int kt = 0; kt < KT; ++kt, ++step) {
          const int stage = step % P_STAGES;
          if (step >= P_STAGES) mbar_wait(&empty[stage], ((step / P_STAGES) - 1) & 1);
          mbar_expect_tx(&full[stage], STAGE_BYTES);
          tma_load(As + stage * A_BYTES, &map_a, kt * K_TILE, m0, &full[stage]);
          tma_load(Bs + stage * B_BYTES, &map_b, kt * K_TILE, n0, &full[stage]);
        }
      }
    }
    return;
  }

  const int wg = (tid >> 7) - 1;  // consumer warpgroup: rows wg*64 .. wg*64+63 of the tile
  const int ctid = tid & 127;
  unsigned char* staged = staged_all + wg * P_STAGED;
  Residual res{&map_res, &res_full[wg], 0};
  int step = 0;
  for (int i = 0; i < mine; ++i) {
    const int tile = blockIdx.x + i * gridDim.x;
    const int m0 = (tile / n_tiles) * BM + wg * 64;
    const int n0 = (tile % n_tiles) * BN;
    typename Operand<E>::Acc d[128];
#pragma unroll
    for (int q = 0; q < 128; ++q) d[q] = 0;
    for (int kt = 0; kt < KT; ++kt, ++step) {
      const int stage = step % P_STAGES;
      mbar_wait(&full[stage], (step / P_STAGES) & 1);
      const unsigned char* as = As + stage * A_BYTES + wg * 64 * 128;
      const unsigned char* bs = Bs + stage * B_BYTES;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int s = 0; s < 4; ++s)  // 32 bytes of K each
        Operand<E>::mma(d, make_desc(as + s * 32), make_desc(bs + s * 32));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if constexpr (RESID) {
        if (kt == KT / 2 && ctid == 0 && m0 < M) {
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
          load_boxes<T, P_STAGED>(&map_res, staged, m0, n0, N, &res_full[wg]);
        }
      }
      __syncwarp();
      // keep this k-tile's MMAs in flight; the previous k-tile's are done, so
      // its stage goes back to the producer
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (kt > 0 && ctid == 0) mbar_arrive(&empty[(step - 1) % P_STAGES]);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    if (ctid == 0) mbar_arrive(&empty[(step - 1) % P_STAGES]);
    store_tile<T, RELU_OUT, P_STAGED, RESID>(d, &map_out, bias, staged, m0, n0, M, N, ctid,
                                             1 + wg, &res, scale);
  }
  if (ctid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Tensor map of a GEMM operand: the first K columns of a row-major
// [rows][ld] bf16 or int8 matrix, in boxes of 128 bytes x box_rows rows.
template <typename E>
inline int operand_map(CUtensorMap* map, const E* base, int rows, int K, int ld, int box_rows) {
  return make_map(map, Operand<E>::kMap, sizeof(E), base, rows, K, ld, box_rows);
}

// out[M, N] = epi(A[M, :K] @ Bt[N, :K]^T) on `stream`; A rows `lda`, Bt rows
// `ldb` elements apart (multiples of 8). Returns a cudaError_t code.
template <class Epi>
int launch(const bf16* a, int lda, const bf16* bt, int ldb, int M, int N, int K, const Epi& epi,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(gemm_kernel<Epi>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map_a, map_b;
  if (int e = operand_map(&map_a, a, M, K, lda, BM)) return e;
  if (int e = operand_map(&map_b, bt, N, K, ldb, BN)) return e;
  const int grid = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  gemm_kernel<Epi><<<grid, THREADS, SMEM, stream>>>(map_a, map_b, N, K, epi);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
constexpr CUtensorMapDataType map_dtype() {
  return std::is_same_v<T, float> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// out[M, N] = [float(A[M, :K] @ Bt[N, :K]^T) * scale] + bias [-> ReLU]
// [+ res] in T (bf16 or fp32) on `stream`, through persistent_kernel:
// operands E (bf16; int8, which needs `scale`), A rows `lda`, Bt rows `ldb`
// elements apart (16-byte multiples); out and res (nullptr: none)
// contiguous (M, N), N % 8 == 0; bias and scale (N,) fp32. min(tiles, SMs)
// CTAs. Returns a cudaError_t code.
template <typename E, typename T, bool RELU_OUT = false>
int launch_persistent(const E* a, int lda, const E* bt, int ldb, const float* bias, T* out,
                      const T* res, int M, int N, int K, cudaStream_t stream,
                      const float* scale = nullptr) {
  const auto kernel = res != nullptr ? persistent_kernel<E, T, RELU_OUT, true>
                                     : persistent_kernel<E, T, RELU_OUT, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map_a, map_b, map_out, map_res;
  if (int e = operand_map(&map_a, a, M, K, lda, BM)) return e;
  if (int e = operand_map(&map_b, bt, N, K, ldb, BN)) return e;
  if (int e = make_map(&map_out, map_dtype<T>(), sizeof(T), out, M, N, N, 64)) return e;
  if (int e = make_map(&map_res, map_dtype<T>(), sizeof(T), res != nullptr ? res : out, M, N, N, 64))
    return e;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return static_cast<int>(err);
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  kernel<<<tiles < sms ? tiles : sms, THREADS, P_SMEM, stream>>>(map_a, map_b, map_out, map_res,
                                                                 bias, scale, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gemm
}  // namespace mdfd
