// Pieces shared by the hand-written kernels (middle_block.cu, K1;
// middle_block_w8.cu, K2; entry_block.cu, K3; entry_pair.cu, K4;
// sepconv_unit.cu, K5) for Hopper, sm_90a:
//   - 8-wide loads of bf16 / fp32 activations;
//   - the depthwise 3x3's arithmetic in three tap orders (dw3x3_sum), and
//     the tiled [ReLU ->] depthwise kernel that writes the GEMM's A operand
//     with it (bf16 for K1 and K5, int8 codes for K2);
//   - mbarrier, TMA load and store, and wgmma shared-memory descriptor
//     helpers, and the 2-D tensor-map encoder.
#pragma once

#include <cuda.h>  // CUtensorMap and the tensor-map encoder's types
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace mdfd {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// 8-wide loads (16 bytes of bf16, 32 bytes of fp32)
// ---------------------------------------------------------------------------
__device__ __forceinline__ void load8(const bf16* p, float v[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// 8 values -> memory: fp32; bf16 (K1's GEMM operand); or round half to even,
// clip to +-127 and int8 (K2's GEMM operand, whose taps are already in
// quantized units)
__device__ __forceinline__ void store8(float* p, const float acc[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(acc[4], acc[5], acc[6], acc[7]);
}
__device__ __forceinline__ void store8(bf16* p, const float acc[8]) {
  uint4 packed;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
  for (int e = 0; e < 4; ++e) o[e] = __floats2bfloat162_rn(acc[2 * e], acc[2 * e + 1]);
  *reinterpret_cast<uint4*>(p) = packed;
}
__device__ __forceinline__ int8_t int8_code(float v) {
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(rintf(v), -127.f), 127.f)));
}
__device__ __forceinline__ void store8(int8_t* p, const float acc[8]) {
  uint2 packed;
  int8_t* o = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
  for (int e = 0; e < 8; ++e) o[e] = int8_code(acc[e]);
  *reinterpret_cast<uint2*>(p) = packed;
}

// 4 values -> memory: bf16, or int8 codes as store8 rounds them
__device__ __forceinline__ void store4(bf16* p, const float acc[4]) {
  uint2 packed;
  *reinterpret_cast<__nv_bfloat162*>(&packed.x) = __floats2bfloat162_rn(acc[0], acc[1]);
  *reinterpret_cast<__nv_bfloat162*>(&packed.y) = __floats2bfloat162_rn(acc[2], acc[3]);
  *reinterpret_cast<uint2*>(p) = packed;
}
__device__ __forceinline__ void store4(int8_t* p, const float acc[4]) {
  unsigned packed;
  int8_t* o = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
  for (int e = 0; e < 4; ++e) o[e] = int8_code(acc[e]);
  *reinterpret_cast<unsigned*>(p) = packed;
}

// 4 bf16 (8 bytes) or fp32 values -> fp32
__device__ __forceinline__ void unpack4(uint2 raw, float v[4]) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void unpack4(float4 raw, float v[4]) {
  v[0] = raw.x; v[1] = raw.y; v[2] = raw.z; v[3] = raw.w;
}

// ---------------------------------------------------------------------------
// The depthwise 3x3's arithmetic, one copy for every kernel that computes
// it: the sum of one output pixel over E channels. in(k, v) fills the E
// inputs under tap k = dy*3 + dx (ReLU'd and rounded as the caller stages
// them, zero outside the image); tap(k, t) the E taps. Products and sums
// are rounded separately (no FMA), in the order of the TPU kernel the
// caller stands in for, so the result is bit-equal to the plain versions:
//   Taps::kDy      fp32 products summed dy-major (K1, K2, K5; K4's stream
//                  kernels);
//   Taps::kCols    fp32 products summed per column over dy, then
//                  (dx0 + dx1) + dx2 (K3; K4's entry_pair_pallas);
//   Taps::kDyBf16  each product and each running sum rounded to bf16,
//                  dy-major (middle_block_pallas_v2 with precise=False);
//                  inputs and taps must be bf16 values.
// ---------------------------------------------------------------------------
enum class Taps { kDy, kCols, kDyBf16 };

template <Taps ORDER, int E, class In, class Tap>
__device__ __forceinline__ void dw3x3_sum(const In& in, const Tap& tap, float acc[E]) {
  if constexpr (ORDER == Taps::kCols) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      float col[E];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float v[E], t[E];
        in(dy * 3 + dx, v);
        tap(dy * 3 + dx, t);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float prod = __fmul_rn(v[e], t[e]);
          col[e] = dy == 0 ? prod : __fadd_rn(col[e], prod);
        }
      }
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = dx == 0 ? col[e] : __fadd_rn(acc[e], col[e]);
    }
  } else if constexpr (ORDER == Taps::kDyBf16) {
    bf16 hacc[E];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      float v[E], t[E];
      in(k, v);
      tap(k, t);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        // bf16 values convert back exactly; _rn: nvcc may not contract the
        // product and the sum into an FMA
        const bf16 prod = __hmul_rn(__float2bfloat16_rn(v[e]), __float2bfloat16_rn(t[e]));
        hacc[e] = k == 0 ? prod : __hadd_rn(hacc[e], prod);
      }
    }
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = __bfloat162float(hacc[e]);
  } else {
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      float v[E], t[E];
      in(k, v);
      tap(k, t);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float prod = __fmul_rn(v[e], t[e]);
        acc[e] = k == 0 ? prod : __fadd_rn(acc[e], prod);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// [ReLU ->] depthwise 3x3, operand out (bf16 for K1 and K5, int8 codes for
// K2). A block owns a tile of one image and a slab of `chans` channels (64;
// 128 where a whole image of 128 fits DW_SMEM_TARGET, as at 8 x 8): the
// whole image where it fits (16 x 16 does at 64), else up to 8 rows by up
// to 64 columns. It stages the tile plus its one-pixel zero halo in shared
// memory once (ReLU'd if RELU, rounded to bf16 as it lands; each thread
// keeps DW_STAGE 16-byte loads in flight; a pixel's live channels packed,
// so a narrower last slab reads without bank conflicts). A thread owns 4
// channels, holds their 9 taps in registers (rounded to bf16 for
// Taps::kDyBf16) and computes a run of up to DW_RUN consecutive pixels
// along w, sliding its 3 x 3 window: a run of r pixels reads 3(r + 2)
// staged 8-byte vectors from shared memory, not each pixel's 9 neighbours
// and 9 taps (432 bytes per 8 outputs). Threads map to (channel group,
// run) pairs, so a 24-channel slab keeps 6 of every 8 threads busy, and
// runs shorten until every thread has one. The sums are dw3x3_sum's.
//
// What bounds it on an H100: device memory (the input read once, the
// operand written once) sets 57 us at K1's shape; it takes 129 (NVIDIA
// H100 80GB HBM3, 700 W; chip_variants.py k1), and neither more staging
// loads in flight nor 128-thread blocks move that, while 4 blocks an SM
// (64 registers a thread) spill the taps and take 60 % longer. A block's staging
// and its sums do not overlap one another, only other blocks' phases.
// ---------------------------------------------------------------------------
constexpr int DW_CC = 64;  // channels per slab
constexpr int DW_THREADS = 256;
constexpr int DW_MIN_BLOCKS = 3;  // per SM
constexpr int DW_RUN = 8;         // pixels per run, at most
constexpr int DW_STAGE = 4;       // staging loads in flight per thread
// Tiles are sized to this so that several blocks share an SM (occupancy
// hides the staging loads); tiling along W makes any width fit, far inside
// the 227 KB a block may use.
constexpr int DW_SMEM_TARGET = 48 * 1024;

__host__ __device__ constexpr int dw_smem_bytes(int rows, int cols, int chans) {
  return (rows + 2) * (cols + 2) * chans * static_cast<int>(sizeof(bf16));
}

template <typename T, typename OutT, bool RELU = true, Taps ORDER = Taps::kDy>
__global__ void __launch_bounds__(DW_THREADS, DW_MIN_BLOCKS)
dw3x3_relu_kernel(const T* __restrict__ x, const float* __restrict__ taps,
                  OutT* __restrict__ a, int H, int W, int C, int ldk, int rows_per_band,
                  int cols_per_tile, int chans) {
  extern __shared__ __align__(16) unsigned char dw_smem[];
  bf16* tile = reinterpret_cast<bf16*>(dw_smem);  // [rows+2][cols+2][cc]

  const int bands = (H + rows_per_band - 1) / rows_per_band;
  const int tiles = (W + cols_per_tile - 1) / cols_per_tile;
  const int n = blockIdx.x / (bands * tiles);
  const int t = blockIdx.x - n * bands * tiles;
  const int h0 = (t / tiles) * rows_per_band;
  const int w0 = (t % tiles) * cols_per_tile;
  const int rows = min(rows_per_band, H - h0);
  const int cols = min(cols_per_tile, W - w0);
  const int c0 = blockIdx.y * chans;
  const int cc = min(chans, C - c0);  // live channels, C % 8 == 0
  const int vecs8 = cc / 8;
  const size_t image = static_cast<size_t>(n) * H * W * C;
  const int pitch = cols + 2;

  const int items = (rows + 2) * pitch * vecs8;  // 8-channel vectors to stage
  for (int i0 = threadIdx.x; i0 < items; i0 += DW_STAGE * DW_THREADS) {
    float f[DW_STAGE][8];
#pragma unroll
    for (int u = 0; u < DW_STAGE; ++u) {  // the loads first, all in flight
      const int i = i0 + u * DW_THREADS;
      const int p = i / vecs8;
      const int hh = h0 - 1 + p / pitch;
      const int ww = w0 - 1 + p % pitch;
#pragma unroll
      for (int e = 0; e < 8; ++e) f[u][e] = 0.f;
      if (i < items && hh >= 0 && hh < H && ww >= 0 && ww < W)
        load8(x + image + (static_cast<size_t>(hh) * W + ww) * C + c0 + (i % vecs8) * 8, f[u]);
    }
#pragma unroll
    for (int u = 0; u < DW_STAGE; ++u) {
      const int i = i0 + u * DW_THREADS;
      if (i >= items) break;
      if (RELU) {
#pragma unroll
        for (int e = 0; e < 8; ++e) f[u][e] = f[u][e] > 0.f ? f[u][e] : 0.f;
      }
      store8(tile + (i / vecs8) * cc + (i % vecs8) * 8, f[u]);  // rounded to bf16 here
    }
  }
  const int groups = cc / 4;
  const int g = threadIdx.x % groups;  // channels c0 + 4g .. +3
  float tv[9][4];                      // loaded while the barrier waits
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    unpack4(*reinterpret_cast<const float4*>(taps + k * C + c0 + g * 4), tv[k]);
    if (ORDER == Taps::kDyBf16) {  // rounded once, so their conversion back is exact
#pragma unroll
      for (int e = 0; e < 4; ++e) tv[k][e] = __bfloat162float(__float2bfloat16_rn(tv[k][e]));
    }
  }
  __syncthreads();

  const int slots = DW_THREADS / groups;  // runs in flight
  const int slot = threadIdx.x / groups;
  if (slot >= slots) return;
  // the longest run that still gives every slot one
  int run = DW_RUN;
  while (run > 1 && rows * ((cols + run - 1) / run) < slots) run >>= 1;
  const int runs_per_row = (cols + run - 1) / run;
  const auto tap = [&](int k, float tk[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) tk[e] = tv[k][e];
  };
  for (int q = slot; q < rows * runs_per_row; q += slots) {
    const int r = q / runs_per_row;
    const int wr = (q - r * runs_per_row) * run;  // the run's first column in the tile
    const int len = min(run, cols - wr);
    // staged pixel (r + dy, wr + j) is the run's neighbour (dy - 1, j - 1)
    const bf16* at = tile + (r * pitch + wr) * cc + g * 4;
    const auto staged = [&](int dy, int j) {
      return *reinterpret_cast<const uint2*>(at + (dy * pitch + j) * cc);
    };
    uint2 win[3][3];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      win[dy][0] = staged(dy, 0);
      win[dy][1] = staged(dy, 1);
    }
    OutT* o = a + (static_cast<size_t>(n) * H * W + static_cast<size_t>(h0 + r) * W + w0 + wr) *
                      ldk + c0 + g * 4;
#pragma unroll
    for (int p = 0; p < DW_RUN; ++p) {
      if (p >= len) break;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) win[dy][2] = staged(dy, p + 2);
      float acc[4];
      dw3x3_sum<ORDER, 4>([&](int k, float in[4]) { unpack4(win[k / 3][k % 3], in); }, tap, acc);
      store4(o + static_cast<size_t>(p) * ldk, acc);
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        win[dy][0] = win[dy][1];
        win[dy][1] = win[dy][2];
      }
    }
  }
}

// Launch geometry of dw3x3_relu_kernel for one (N, H, W, C): the whole
// image where it fits DW_SMEM_TARGET, else tiles of up to 8 rows by 64
// columns, the columns halved while the staged tile would outgrow it; two
// slabs of channels a block where the whole image holds them.
struct DwLaunch {
  dim3 grid;
  int smem;
  int rows_per_band;
  int cols_per_tile;
  int chans;
};

template <typename T, typename OutT, bool RELU = true, Taps ORDER = Taps::kDy>
int dw3x3_setup(int N, int H, int W, int C, DwLaunch* l) {
  int rows = H < 8 ? H : 8;
  int cols = W < 64 ? W : 64;
  while (cols > 8 && dw_smem_bytes(rows, cols, DW_CC) > DW_SMEM_TARGET) cols = (cols + 1) / 2;
  const bool whole = cols == W && dw_smem_bytes(H, W, DW_CC) <= DW_SMEM_TARGET;
  if (whole) rows = H;  // no halo rows read twice
  // a small image's thread gets a full run, and a block more than a few warps' work
  l->chans = whole && C > DW_CC && dw_smem_bytes(H, W, 2 * DW_CC) <= DW_SMEM_TARGET ? 2 * DW_CC
                                                                                     : DW_CC;
  l->rows_per_band = rows;
  l->cols_per_tile = cols;
  l->smem = dw_smem_bytes(rows, cols, l->chans);
  l->grid = dim3(N * ((H + rows - 1) / rows) * ((W + cols - 1) / cols),
                 (C + l->chans - 1) / l->chans);
  return static_cast<int>(cudaFuncSetAttribute(
      dw3x3_relu_kernel<T, OutT, RELU, ORDER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      l->smem));
}

// One depthwise launch on `stream` into a[(n, h, w), :C], rows ldk elements
// apart. Returns a cudaError_t code.
template <typename T, typename OutT, bool RELU, Taps ORDER>
int dw3x3_launch(const T* x, const float* taps, OutT* a, int N, int H, int W, int C, int ldk,
                 cudaStream_t stream) {
  DwLaunch l;
  if (int e = dw3x3_setup<T, OutT, RELU, ORDER>(N, H, W, C, &l)) return e;
  dw3x3_relu_kernel<T, OutT, RELU, ORDER><<<l.grid, DW_THREADS, l.smem, stream>>>(
      x, taps, a, H, W, C, ldk, l.rows_per_band, l.cols_per_tile, l.chans);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// mbarriers, TMA and wgmma descriptors
// ---------------------------------------------------------------------------
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Wait for the phase of parity `phase` to complete. A transfer that never
// lands traps (a launch failure the caller sees) instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned phase) {
  for (int spin = 0;; ++spin) {
    unsigned done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(phase)
        : "memory");
    if (done) return;
    if (spin > (1 << 22)) __trap();
  }
}
// 2-D tile load {inner, outer} -> shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int inner, int outer,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(inner), "r"(outer)
      : "memory");
}

// 2-D tile store shared memory -> {inner, outer} of the tensor, in the
// bulk group of the issuing thread (cp.async.bulk.commit_group closes it)
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int inner,
                                          int outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(inner), "r"(outer)
      : "memory");
}

// shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart; the tile base is 1024-byte aligned
__device__ __forceinline__ uint64_t make_desc(const void* p) {
  uint64_t desc = (static_cast<uint64_t>(smem_addr(p)) & 0x3FFFF) >> 4;
  desc |= static_cast<uint64_t>(16 >> 4) << 16;    // leading byte offset (unused here)
  desc |= static_cast<uint64_t>(1024 >> 4) << 32;  // stride byte offset
  desc |= static_cast<uint64_t>(1) << 62;          // 128-byte swizzle
  return desc;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// Tensor map of the first C columns of a row-major [rows][ldk] matrix of
// `elem_bytes`-byte elements, loaded in boxes of 128 bytes x box_rows rows
// with the 128-byte swizzle; out-of-bounds elements read as zero.
inline int make_map(CUtensorMap* map, CUtensorMapDataType dtype, int elem_bytes, const void* base,
                    int rows, int C, int ldk, int box_rows) {
  static EncodeTiled encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &status) !=
            cudaSuccess ||
        status != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<EncodeTiled>(fn);
  }();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ldk) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / elem_bytes),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = encode(map, dtype, 2, const_cast<void*>(base), dims, strides, box,
                            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// Epilogue I/O: two neighbouring channels of the residual and the output
// ---------------------------------------------------------------------------
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

}  // namespace mdfd
