// The separable unit as one launch for Hopper, sm_90a: a pointwise GEMM
// whose A operand its producer warps compute from the unit's input,
//     out[m, :N] = [ReLU]( bf16( dw3x3_ORDER( [ReLU] TileT(in) )[m, :K] ) @ pw[:N, :K]^T + b )
// on a dense NHWC input in (images, H, W, K), row m = (image, h, w). K3 and
// K4 run both units of their pair through it (sepconv_pair.cuh), so the
// depthwise result never reaches device memory.
//
// A CTA is three warpgroups and stays resident, one per SM, walking its
// share of the 64-row M tiles gridDim.x apart:
//   - Warpgroups 0-1 produce the A operand, one 64-pixel x 64-channel
//     k-tile at a time, into swizzled slots. A thread computes 4 channels
//     of a run of 4 consecutive pixels: where one image row holds the run
//     (all but a few runs) it loads the 3 x 6 neighbourhood once, 18 plain
//     8- or 16-byte loads that L1 and L2 serve, and slides the 3 x 3 window
//     along it; otherwise it loads each pixel's 9 neighbours. Inputs are
//     ReLU'd if RELU and rounded to TileT once per load, as the tiled
//     depthwise kernel stages them; the k-tile's taps sit in registers; the
//     sums are dw3x3_sum's, that kernel's arithmetic, rounded to bf16 and
//     written straight into the slot in the 128-byte swizzle TMA would give
//     (make_desc). Channels at or past K and rows at or past M are written
//     as zeros: the weight tile is zero-filled past K, and NaN x 0 is NaN.
//     Each thread fences its writes for the async proxy (wgmma reads them)
//     and arrives on the slot's "full" barrier.
//   - Warpgroup 2 consumes: wgmma m64n256k16 over each k-tile, k-tiles
//     summed in ascending order. Its first thread loads the weight tiles
//     (B) by TMA: with one N tile and K <= 256 (blocks 1 and 2) each k-tile
//     once, to stay; otherwise through a ring of B_STAGES, refilled as soon
//     as the MMAs that read a stage are done. The epilogue adds the bias
//     (+ ReLU), converts to OutT and writes the tile into a swizzled staging
//     buffer, which TMA stores to device memory (clipping at M and N) while
//     the next tile's MMAs run; storing 4-byte pairs from the registers took
//     most of a tile's time.
// Past one 256-column N tile (blocks 3 and 12) the M tile's whole A block
// stays in KT slots while the consumer walks the N tiles, so the depthwise
// is computed once (K up to A_SLOTS * 64, recomputed per N tile beyond);
// otherwise the slots are a ring of 4. The consumer's 128 accumulators need
// 168 registers a thread, and ptxas gives every warpgroup the kernel's one
// count, so a fourth warpgroup does not fit.
//
// What bounds it on an H100 (chip_variants.py): the producers' neighbourhood
// loads, which 8 producer warps a SM cannot keep in flight enough of, and
// the consumer's serial MMA-epilogue chain per tile; their fp32 sums hide
// behind both. PERF.md has the readings.
#pragma once

#include "bf16_gemm.cuh"

namespace mdfd {
namespace dwg {

constexpr int BM = 64;
constexpr int BN = gemm::BN;
constexpr int BK = gemm::BK;
constexpr int A_SLOTS = 12;  // at most, 8 KB each: the A block of K <= 768 stays resident
constexpr int B_STAGES = 3;  // 32 KB each
constexpr int B_RESIDENT = 4;  // one N tile and K <= 256: every weight k-tile stays in place
constexpr int A_TILE = BM * BK;
constexpr int B_TILE = BN * BK;
constexpr int B_BYTES = B_TILE * static_cast<int>(sizeof(bf16));
constexpr int PRODUCERS = 256;            // warpgroups 0-1
constexpr int THREADS = PRODUCERS + 128;  // + the consumer warpgroup
constexpr int CH = 4;                     // channels per producer task
constexpr int GROUPS = BK / CH;           // 16 channel groups per k-tile
constexpr int RUN = BM * GROUPS / PRODUCERS;  // 4 consecutive pixels per thread

constexpr int OUT_BYTES = 4 * gemm::BOX_BYTES;  // the epilogue's staging buffer (gemm::store_tile)

// Dynamic shared memory of a launch with `slots` A slots and `b_slots`
// weight tiles (+ room to align)
constexpr int smem_bytes(int slots, int b_slots) {
  return (slots * A_TILE + b_slots * B_TILE) * static_cast<int>(sizeof(bf16)) + OUT_BYTES + 1024;
}

// 4 channels of the input as loaded (bf16 or fp32)
template <typename T>
using Raw4 = std::conditional_t<std::is_same_v<T, bf16>, uint2, float4>;

// The loaded channels as the tiled depthwise stages them: ReLU'd if RELU,
// rounded to bf16 if ROUND (fp32 input staged as bf16). Applied once per
// load, before the window reuses it.
template <bool RELU, bool ROUND>
__device__ __forceinline__ uint2 stage4(uint2 raw) {
  if (RELU) {  // two lanes per instruction; NaN -> 0 as in the tiled depthwise
    const __nv_bfloat162 zero = __float2bfloat162_rn(0.f);
    *reinterpret_cast<__nv_bfloat162*>(&raw.x) =
        __hmax2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x), zero);
    *reinterpret_cast<__nv_bfloat162*>(&raw.y) =
        __hmax2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y), zero);
  }
  return raw;
}
template <bool RELU, bool ROUND>
__device__ __forceinline__ float4 stage4(float4 raw) {
  float* v = reinterpret_cast<float*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (RELU) v[e] = v[e] > 0.f ? v[e] : 0.f;
    if (ROUND) v[e] = __bfloat162float(__float2bfloat16_rn(v[e]));
  }
  return raw;
}

template <typename T, typename TileT, bool RELU, Taps ORDER, typename OutT, bool RELU_OUT>
__global__ void __launch_bounds__(THREADS, 1)
dw_gemm_kernel(const __grid_constant__ CUtensorMap map_b, const __grid_constant__ CUtensorMap map_out,
               const T* __restrict__ x, const float* __restrict__ taps,
               const float* __restrict__ bias, int M, int H, int W, int K, int N, int slots,
               int b_slots) {
  static_assert(ORDER != Taps::kDyBf16, "the pair's tap orders are kDy and kCols");
  constexpr bool ROUND = std::is_same_v<TileT, bf16> && std::is_same_v<T, float>;
  using Raw = Raw4<T>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full_a[A_SLOTS];
  __shared__ uint64_t empty_a[A_SLOTS];
  __shared__ uint64_t full_b[B_RESIDENT > B_STAGES ? B_RESIDENT : B_STAGES];
  // swizzled tiles need 1024-byte alignment
  bf16* As = reinterpret_cast<bf16*>(smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  bf16* Bs = As + slots * A_TILE;
  unsigned char* staged = reinterpret_cast<unsigned char*>(Bs + b_slots * B_TILE);

  const int tid = threadIdx.x;
  const int n_tiles = (N + BN - 1) / BN;
  const int m_tiles = (M + BM - 1) / BM;
  const int KT = (K + BK - 1) / BK;
  // an item is an M tile whose A block serves every N tile (one N tile, or
  // the whole block in the slots), or one (M, N) tile whose A block is
  // recomputed
  const bool resident = n_tiles == 1 || KT <= slots;
  const int passes = resident ? n_tiles : 1;
  const int items = resident ? m_tiles : m_tiles * n_tiles;
  const int mine = (items - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) /
                   static_cast<int>(gridDim.x);
  const auto item_m0 = [&](int i) {
    const int item = blockIdx.x + i * gridDim.x;
    return (resident ? item : item / n_tiles) * BM;
  };
  const auto item_n0 = [&](int i, int pass) {
    const int item = blockIdx.x + i * gridDim.x;
    return (resident ? pass : item % n_tiles) * BN;
  };

  if (tid == 0) {
    for (int s = 0; s < slots; ++s) {
      mbar_init(&full_a[s], PRODUCERS);
      mbar_init(&empty_a[s], 1);
    }
    for (int s = 0; s < b_slots; ++s) mbar_init(&full_b[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < PRODUCERS) {
    const int g = tid % GROUPS;          // channels kt*BK + g*CH .. +CH-1
    const int r0 = (tid / GROUPS) * RUN;  // tile rows r0 .. r0+RUN-1
    const int chunk = g >> 1;             // the 16-byte chunk of the 128-byte A row
    const int HW = H * W;
    float t[9][CH];
    int a = 0;  // A k-tiles produced
    for (int i = 0; i < mine; ++i) {
      const int m = item_m0(i) + r0;  // the run's first pixel
      const int h = (m % HW) / W, w = m % W;
      // one image row holds the run: the 3 x (RUN + 2) neighbourhood serves it
      const bool in_row = w + RUN <= W && m + RUN <= M;
      for (int kt = 0; kt < KT; ++kt, ++a) {
        const int slot = a % slots;
        if (a >= slots) mbar_wait(&empty_a[slot], ((a / slots) - 1) & 1);
        const int c = kt * BK + g * CH;
        const bool live = c < K;  // K % 8 == 0: the whole group or none of it
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          const float4 tv = live ? *reinterpret_cast<const float4*>(taps + k * K + c)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
          t[k][0] = tv.x; t[k][1] = tv.y; t[k][2] = tv.z; t[k][3] = tv.w;
        }
        const auto tap = [&](int k, float tk[CH]) {
#pragma unroll
          for (int e = 0; e < CH; ++e) tk[e] = t[k][e];
        };
        bf16* as = As + slot * A_TILE;
        const auto store = [&](int r, const float acc[CH]) {
          uint2 packed;
          *reinterpret_cast<__nv_bfloat162*>(&packed.x) = __floats2bfloat162_rn(acc[0], acc[1]);
          *reinterpret_cast<__nv_bfloat162*>(&packed.y) = __floats2bfloat162_rn(acc[2], acc[3]);
          // the 128-byte swizzle: chunk j of row r sits at chunk j ^ (r % 8)
          *reinterpret_cast<uint2*>(as + r * BK + ((chunk ^ (r & 7)) << 3) + ((g & 1) << 2)) =
              packed;
        };
        if (in_row) {
          // the run's neighbourhood: rows h-1 .. h+1, columns w-1 .. w+RUN
          Raw raw[3][RUN + 2];
          const T* px = x + static_cast<size_t>(m) * K + c;
#pragma unroll
          for (int dy = 0; dy < 3; ++dy)
#pragma unroll
            for (int j = 0; j < RUN + 2; ++j) {
              const bool inside = live && h + dy - 1 >= 0 && h + dy - 1 < H && w + j - 1 >= 0 &&
                                  w + j - 1 < W;
              raw[dy][j] = inside ? stage4<RELU, ROUND>(*reinterpret_cast<const Raw*>(
                                        px + static_cast<ptrdiff_t>((dy - 1) * W + j - 1) * K))
                                  : Raw{};
            }
#pragma unroll
          for (int p = 0; p < RUN; ++p) {
            float acc[CH];
            dw3x3_sum<ORDER, CH>(
                [&](int k, float v[CH]) { unpack4(raw[k / 3][p + k % 3], v); }, tap,
                acc);
            store(r0 + p, acc);
          }
        } else {
          // a run that wraps to the next row or passes M: each pixel's own 9
          int mp = m, hp = h, wp = w;
#pragma unroll 1
          for (int p = 0; p < RUN; ++p) {
            Raw raw[9];
            const bool on = live && mp < M;
            const T* px = x + static_cast<size_t>(mp) * K + c;
#pragma unroll
            for (int k = 0; k < 9; ++k) {
              const int dy = k / 3 - 1, dx = k % 3 - 1;
              const bool inside = on && hp + dy >= 0 && hp + dy < H && wp + dx >= 0 && wp + dx < W;
              raw[k] = inside ? stage4<RELU, ROUND>(*reinterpret_cast<const Raw*>(
                                    px + static_cast<ptrdiff_t>(dy * W + dx) * K))
                              : Raw{};
            }
            float acc[CH];
            dw3x3_sum<ORDER, CH>([&](int k, float v[CH]) { unpack4(raw[k], v); },
                                 tap, acc);
            store(r0 + p, acc);
            ++mp;
            if (++wp == W) {
              wp = 0;
              if (++hp == H) hp = 0;
            }
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(&full_a[slot]);
      }
    }
    return;
  }

  // the consumer warpgroup; its thread 0 loads the weight tiles. With one
  // N tile and K <= B_RESIDENT * 64 every weight k-tile is loaded once and
  // stays (b_slots = KT); otherwise step s (the CTA's s-th k-tile MMA) reads
  // stage s % B_STAGES, refilled as soon as its MMAs are done.
  const int ctid = tid - PRODUCERS;
  const bool b_resident = n_tiles == 1 && KT <= B_RESIDENT;
  const int steps = mine * passes * KT;
  const auto load_b = [&](int s) {
    const int i = s / (passes * KT);
    const int pass = (s / KT) % passes;
    const int stage = b_resident ? s : s % B_STAGES;
    mbar_expect_tx(&full_b[stage], B_BYTES);
    tma_load(Bs + stage * B_TILE, &map_b, (s % KT) * BK, item_n0(i, pass), &full_b[stage]);
  };
  if (ctid == 0)
    for (int s = 0; s < b_slots && s < steps; ++s) load_b(s);
  int s = 0;
  for (int i = 0; i < mine; ++i) {
    const int m0 = item_m0(i);
    for (int pass = 0; pass < passes; ++pass) {
      const bool last = pass + 1 == passes;
      float d[128];
#pragma unroll
      for (int q = 0; q < 128; ++q) d[q] = 0.f;
      for (int kt = 0; kt < KT; ++kt, ++s) {
        const int a = i * KT + kt;
        mbar_wait(&full_a[a % slots], (a / slots) & 1);
        const int stage = b_resident ? kt : s % B_STAGES;
        mbar_wait(&full_b[stage], b_resident ? 0 : (s / B_STAGES) & 1);
        const bf16* as = As + (a % slots) * A_TILE;
        const bf16* bs = Bs + stage * B_TILE;
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int q = 0; q < BK / 16; ++q)
          gemm::wgmma_m64n256k16(d, make_desc(as + q * 16), make_desc(bs + q * 16));
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        // keep this k-tile's MMAs in flight; the previous one's are done, so
        // its B stage refills and, on the last pass, its A slot goes back
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (kt > 0 && ctid == 0) {
          if (!b_resident && s - 1 + B_STAGES < steps) load_b(s - 1 + B_STAGES);
          if (last) mbar_arrive(&empty_a[(a - 1) % slots]);
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      if (ctid == 0) {
        if (!b_resident && s - 1 + B_STAGES < steps) load_b(s - 1 + B_STAGES);
        if (last) mbar_arrive(&empty_a[(i * KT + KT - 1) % slots]);
      }
      gemm::store_tile<OutT, RELU_OUT>(d, &map_out, bias, staged, m0, item_n0(i, pass), M, N,
                                      ctid);
    }
  }
  if (ctid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// out[M, N] = [ReLU](bf16(dw3x3([ReLU] TileT(x))) @ pw[:N, :K]^T + b) on
// `stream`: x (M / (H*W), H, W, K) and out (M, N) contiguous, taps (9, K)
// and b (N,) fp32, pw rows ldb elements apart (a multiple of 8), K and N
// multiples of 8, M within int32. One CTA per SM, at most one per work
// item. Returns a cudaError_t code.
template <typename T, typename TileT, bool RELU, Taps ORDER, typename OutT, bool RELU_OUT>
int launch(const T* x, const float* taps, const bf16* pw, int ldb, const float* bias, OutT* out,
           int M, int H, int W, int K, int N, cudaStream_t stream) {
  const auto kernel = dw_gemm_kernel<T, TileT, RELU, ORDER, OutT, RELU_OUT>;
  // Past one N tile the A block stays resident in KT slots (the last N
  // tile's MMAs free them one by one for the next M tile); otherwise a ring
  // of 4. Fewer slots leave more of the SM's 256 KB to L1, which serves the
  // producers' neighbourhood loads.
  const int KT = (K + BK - 1) / BK;
  const int n_tiles = (N + BN - 1) / BN;
  const int slots = n_tiles > 1 && KT <= A_SLOTS ? (KT < 4 ? 4 : KT) : 4;
  const int b_slots = n_tiles == 1 && KT <= B_RESIDENT ? KT : B_STAGES;
  const int smem = smem_bytes(slots, b_slots);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes(A_SLOTS, B_STAGES));
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map_b, map_out;
  if (int e = gemm::operand_map(&map_b, pw, N, K, ldb, BN)) return e;
  constexpr bool kF32 = std::is_same_v<OutT, float>;
  if (int e = make_map(&map_out, kF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                       sizeof(OutT), out, M, N, N, BM))
    return e;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return static_cast<int>(err);
  const int m_tiles = (M + BM - 1) / BM;
  const int items = n_tiles == 1 || KT <= slots ? m_tiles : m_tiles * n_tiles;
  kernel<<<items < sms ? items : sms, THREADS, smem, stream>>>(map_b, map_out, x, taps, bias, M,
                                                               H, W, K, N, slots, b_slots);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dwg
}  // namespace mdfd
