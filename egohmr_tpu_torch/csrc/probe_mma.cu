// K3: the tensor-core matmul-rate probe, for Hopper (sm_90a).
//
// Replaces tools/probe_int8_mxu.py:build and its six Pallas bodies (k_bf16,
// k_bf16_bare, k_int8, k_int8_bare, k_int8_slice, k_int8_glue). Each of G
// independent chains runs R chained [M, 256] x [256, 256] products with the
// accumulator (or, for the glue variant, the activation) carried from one
// product to the next, then takes the max over the M rows: out [G, 1, 256].
//
//   0 bf16        acc += (x + bf16(i % 2)) @ w      bf16 in, f32 accumulate
//   1 bf16_bare   acc += x @ w
//   2 int8        acc += int8(x + int8(i % 2)) @ w  int8 in, int32 accumulate;
//                                                   the add wraps (127 + 1 = -128)
//   3 int8_bare   acc += x @ w
//   4 int8_slice  acc += x2[(i % 2) * M ... + M] @ w, x2 is [2M, 256]
//   5 int8_glue   per step and row: s = max(max|x| / 127, 1e-8),
//                 xq = int8(rint(x / s)), acc = xq @ w (int32),
//                 x = clip(f32(acc) * s * sw * 0.0625, -2, 2);  out = max_rows(x)
//
// What bounds it on an H100: operations. One product is 268.4 MFLOP against
// 0.2 MB of operands, so the least time is 0.271 us at the 989 TFLOP/s bf16
// peak and 0.136 us at the 1,979 TOPS int8 peak. That ratio is what the probe
// reads, so the design keeps everything else out of the R loop.
//
// The TPU body holds the whole [M, 256] accumulator (2 MB) on chip and walks
// the G grid steps one after another on one core. An SM has 256 KB of
// registers, and the card runs CTAs side by side on 132 SMs, so here a CTA
// owns 128 whole rows of one chain (whole rows: the glue variant's row scale
// needs all 256 columns of a row before the next step) and keeps that tile's
// accumulator in registers across all R steps: 8 warps, each 32 rows x 128
// columns, 128 registers of accumulator per thread. w (given transposed,
// [256, 256] as [n][k]) and the CTA's rows of x sit in shared memory for the
// whole launch, in rows padded so that fragment loads meet no bank conflict;
// the products are mma.sync m16n8k16 (bf16) and m16n8k32 (int8), the operand
// fragments plain 32-bit shared-memory loads. At the end a CTA reduces its rows
// to a [256] partial max; a second small kernel folds the M / 128 partials
// into out[g]. The grid is (M / 128, G) CTAs, one per SM at a time (shared
// memory): 512 at M = 2048, G = 32, which is 3.9 waves over 132 SMs.
// wgmma, TMA and a pipelined operand path are later work.
//
// The entry point returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int KD = 256;        // K, the products' depth
constexpr int ND = 256;        // N, their width
constexpr int TM = 128;        // rows of one chain per CTA
constexpr int THREADS = 256;   // 8 warps: 4 along rows x 2 along columns
constexpr int LD16 = KD + 8;   // bf16 elements per padded shared-memory row
constexpr int LD8 = KD + 16;   // int8 bytes per padded shared-memory row

typedef __nv_bfloat16 bf16;

constexpr size_t SMEM_BF16 =
    sizeof(bf16) * (TM + ND) * LD16 + sizeof(float) * 4 * ND;
constexpr size_t SMEM_INT8 = (size_t)(TM + ND) * LD8 + sizeof(int) * 4 * ND;
constexpr size_t SMEM_SLICE = (size_t)(2 * TM + ND) * LD8 + sizeof(int) * 4 * ND;
constexpr size_t SMEM_GLUE =
    (size_t)(TM + ND) * LD8 + sizeof(float) * (4 * ND + ND + 2 * TM);

// Per warp: tile rows wm*32 + [0, 32) and columns wn*128 + [0, 128).
// acc[mi][ni][r] holds row wm*32 + mi*16 + g (+8 for r >= 2) and column
// wn*128 + ni*8 + 2t + (r & 1), with g = lane / 4 and t = lane % 4 (the
// accumulator layout of both mma shapes).
struct Lane {
  int tid, wm, wn, g, t;
  __device__ Lane() {
    tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    wm = warp >> 1, wn = warp & 1, g = lane >> 2, t = lane & 3;
  }
};

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_int8(int* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __hadd2(*reinterpret_cast<__nv_bfloat162*>(&a),
                                   *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ float tmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ int tmax(int a, int b) { return max(a, b); }

// Copy `rows` rows of `row_bytes` bytes (a multiple of 16) from device memory
// into shared-memory rows of `ld_bytes` bytes.
__device__ __forceinline__ void stage_rows(unsigned char* dst, int ld_bytes,
                                           const unsigned char* src,
                                           int row_bytes, int rows) {
  const int per_row = row_bytes / 16;
  for (int i = threadIdx.x; i < rows * per_row; i += THREADS) {
    const int r = i / per_row, c = (i % per_row) * 16;
    *reinterpret_cast<uint4*>(dst + (size_t)r * ld_bytes + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * row_bytes + c);
  }
}

// acc += op(Xs) @ Ws^T over the whole depth, bf16: Xs [TM][LD16], Ws
// [ND][LD16] ([n][k]); `one` (bf16x2 of 1.0 or 0.0) is added to every operand
// element when PERTURB.
template <bool PERTURB>
__device__ __forceinline__ void product_bf16(float (&acc)[2][16][4],
                                             const bf16* Xs, const bf16* Ws,
                                             uint32_t one, const Lane& l) {
#pragma unroll 2
  for (int ks = 0; ks < KD; ks += 16) {
    uint32_t a[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const bf16* p = Xs + (l.wm * 32 + mi * 16 + l.g) * LD16 + ks + 2 * l.t;
      a[mi][0] = *reinterpret_cast<const uint32_t*>(p);
      a[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LD16);
      a[mi][2] = *reinterpret_cast<const uint32_t*>(p + 8);
      a[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LD16 + 8);
      if (PERTURB) {
#pragma unroll
        for (int r = 0; r < 4; ++r) a[mi][r] = add_bf16x2(a[mi][r], one);
      }
    }
#pragma unroll
    for (int ni = 0; ni < 16; ++ni) {
      const bf16* q = Ws + (l.wn * 128 + ni * 8 + l.g) * LD16 + ks + 2 * l.t;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(q);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(q + 8);
      mma_bf16(acc[0][ni], a[0], b0, b1);
      mma_bf16(acc[1][ni], a[1], b0, b1);
    }
  }
}

// The same for int8: Xs [TM][LD8], Ws [ND][LD8]; `one` (0x01010101 or 0) is
// added to every operand byte, wrapping, when PERTURB.
template <bool PERTURB>
__device__ __forceinline__ void product_int8(int (&acc)[2][16][4],
                                             const int8_t* Xs,
                                             const int8_t* Ws, uint32_t one,
                                             const Lane& l) {
#pragma unroll 2
  for (int ks = 0; ks < KD; ks += 32) {
    uint32_t a[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int8_t* p = Xs + (l.wm * 32 + mi * 16 + l.g) * LD8 + ks + 4 * l.t;
      a[mi][0] = *reinterpret_cast<const uint32_t*>(p);
      a[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LD8);
      a[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
      a[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LD8 + 16);
      if (PERTURB) {
#pragma unroll
        for (int r = 0; r < 4; ++r) a[mi][r] = __vadd4(a[mi][r], one);
      }
    }
#pragma unroll
    for (int ni = 0; ni < 16; ++ni) {
      const int8_t* q = Ws + (l.wn * 128 + ni * 8 + l.g) * LD8 + ks + 4 * l.t;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(q);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(q + 16);
      mma_int8(acc[0][ni], a[0], b0, b1);
      mma_int8(acc[1][ni], a[1], b0, b1);
    }
  }
}

// partial_row[c] = max over the CTA's TM rows of column c; red is [4][ND].
template <typename T>
__device__ __forceinline__ void store_colmax(const T (&v)[2][16][4], T* red,
                                             T* __restrict__ partial_row,
                                             const Lane& l) {
#pragma unroll
  for (int ni = 0; ni < 16; ++ni) {
    const int c = l.wn * 128 + ni * 8 + 2 * l.t;
    T m0 = tmax(tmax(v[0][ni][0], v[0][ni][2]), tmax(v[1][ni][0], v[1][ni][2]));
    T m1 = tmax(tmax(v[0][ni][1], v[0][ni][3]), tmax(v[1][ni][1], v[1][ni][3]));
    // reduce over the 8 lanes that share t (the warp's 32 rows)
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      m0 = tmax(m0, __shfl_xor_sync(0xffffffffu, m0, off));
      m1 = tmax(m1, __shfl_xor_sync(0xffffffffu, m1, off));
    }
    if (l.g == 0) {
      red[l.wm * ND + c] = m0;
      red[l.wm * ND + c + 1] = m1;
    }
  }
  __syncthreads();
  for (int c = l.tid; c < ND; c += THREADS)
    partial_row[c] = tmax(tmax(red[c], red[ND + c]),
                          tmax(red[2 * ND + c], red[3 * ND + c]));
}

template <typename T>
__device__ __forceinline__ void zero(T (&acc)[2][16][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 16; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;
}

// Variants 0 and 1. x [M, KD] bf16, wt [ND, KD] bf16, partial
// [G, M / TM, ND] f32; grid (M / TM, G).
template <bool PERTURB>
__global__ void __launch_bounds__(THREADS, 1) bf16_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ wt, int R,
    float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Xs = reinterpret_cast<bf16*>(smem);                  // [TM][LD16]
  bf16* Ws = Xs + TM * LD16;                                 // [ND][LD16]
  float* red = reinterpret_cast<float*>(Ws + ND * LD16);     // [4][ND]
  const Lane l;
  stage_rows(reinterpret_cast<unsigned char*>(Xs), LD16 * 2,
             reinterpret_cast<const unsigned char*>(x + (size_t)blockIdx.x * TM * KD),
             KD * 2, TM);
  stage_rows(reinterpret_cast<unsigned char*>(Ws), LD16 * 2,
             reinterpret_cast<const unsigned char*>(wt), KD * 2, ND);
  __syncthreads();

  float acc[2][16][4];
  zero(acc);
  for (int i = 0; i < R; ++i)
    product_bf16<PERTURB>(acc, Xs, Ws, (i & 1) ? 0x3F803F80u : 0u, l);
  store_colmax(acc, red,
               partial + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * ND, l);
}

// Variants 2, 3 and 4. x [M, KD] int8 (MODE 4: [2M, KD]), wt [ND, KD] int8,
// partial [G, M / TM, ND] int32.
template <int MODE>
__global__ void __launch_bounds__(THREADS, 1) int8_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ wt, int M, int R,
    int* __restrict__ partial) {
  constexpr int HALVES = MODE == 4 ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* Xs = reinterpret_cast<int8_t*>(smem);              // [HALVES][TM][LD8]
  int8_t* Ws = Xs + HALVES * TM * LD8;                       // [ND][LD8]
  int* red = reinterpret_cast<int*>(Ws + ND * LD8);          // [4][ND]
  const Lane l;
  for (int h = 0; h < HALVES; ++h)
    stage_rows(reinterpret_cast<unsigned char*>(Xs + h * TM * LD8), LD8,
               reinterpret_cast<const unsigned char*>(
                   x + ((size_t)h * M + (size_t)blockIdx.x * TM) * KD),
               KD, TM);
  stage_rows(reinterpret_cast<unsigned char*>(Ws), LD8,
             reinterpret_cast<const unsigned char*>(wt), KD, ND);
  __syncthreads();

  int acc[2][16][4];
  zero(acc);
  for (int i = 0; i < R; ++i) {
    const int8_t* Xi = MODE == 4 ? Xs + (i & 1) * TM * LD8 : Xs;
    product_int8<MODE == 2>(acc, Xi, Ws, (i & 1) ? 0x01010101u : 0u, l);
  }
  store_colmax(acc, red,
               partial + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * ND, l);
}

// Variant 5. x [M, KD] f32 (KD == ND: the result is the next operand), wt
// [ND, KD] int8, sw [ND] f32, partial [G, M / TM, ND] f32.
__global__ void __launch_bounds__(THREADS, 1) glue_kernel(
    const float* __restrict__ x, const int8_t* __restrict__ wt,
    const float* __restrict__ sw, int R, float* __restrict__ partial) {
  static_assert(KD == ND, "the glue variant feeds its result back");
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* Xq = reinterpret_cast<int8_t*>(smem);              // [TM][LD8]
  int8_t* Ws = Xq + TM * LD8;                                // [ND][LD8]
  float* red = reinterpret_cast<float*>(Ws + ND * LD8);      // [4][ND]
  float* sws = red + 4 * ND;                                 // [ND]
  float* rmax = sws + ND;                                    // [2][TM]
  const Lane l;
  stage_rows(reinterpret_cast<unsigned char*>(Ws), LD8,
             reinterpret_cast<const unsigned char*>(wt), KD, ND);
  for (int c = l.tid; c < ND; c += THREADS) sws[c] = sw[c];

  // the activation, in the accumulator's layout
  float xv[2][16][4];
  const float* xt = x + (size_t)blockIdx.x * TM * KD;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 16; ++ni) {
      const int row = l.wm * 32 + mi * 16 + l.g;
      const int col = l.wn * 128 + ni * 8 + 2 * l.t;
      const float2 lo = *reinterpret_cast<const float2*>(xt + (size_t)row * KD + col);
      const float2 hi = *reinterpret_cast<const float2*>(xt + (size_t)(row + 8) * KD + col);
      xv[mi][ni][0] = lo.x, xv[mi][ni][1] = lo.y;
      xv[mi][ni][2] = hi.x, xv[mi][ni][3] = hi.y;
    }

  for (int i = 0; i < R; ++i) {
    // per-row max |x|: over this thread's columns, the 4 lanes of a row, then
    // the two warps that share the row
    float s[2][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      float m0 = 0.f, m1 = 0.f;
#pragma unroll
      for (int ni = 0; ni < 16; ++ni) {
        m0 = fmaxf(m0, fmaxf(fabsf(xv[mi][ni][0]), fabsf(xv[mi][ni][1])));
        m1 = fmaxf(m1, fmaxf(fabsf(xv[mi][ni][2]), fabsf(xv[mi][ni][3])));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
      }
      if (l.t == 0) {
        const int row = l.wm * 32 + mi * 16 + l.g;
        rmax[l.wn * TM + row] = m0;
        rmax[l.wn * TM + row + 8] = m1;
      }
    }
    __syncthreads();  // also: every warp is done with the last step's Xq
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = l.wm * 32 + mi * 16 + l.g + 8 * h;
        s[mi][h] = fmaxf(fmaxf(rmax[row], rmax[TM + row]) / 127.0f, 1e-8f);
      }
    // quantise: round half to even, two int8 per 16-bit store
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 16; ++ni) {
        const int row = l.wm * 32 + mi * 16 + l.g;
        const int col = l.wn * 128 + ni * 8 + 2 * l.t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q0 = (int)rintf(xv[mi][ni][2 * h] / s[mi][h]);
          const int q1 = (int)rintf(xv[mi][ni][2 * h + 1] / s[mi][h]);
          *reinterpret_cast<uint16_t*>(Xq + (row + 8 * h) * LD8 + col) =
              (uint16_t)((q0 & 0xFF) | ((q1 & 0xFF) << 8));
        }
      }
    __syncthreads();  // Xq is whole; rmax may be overwritten after this

    int acc[2][16][4];
    zero(acc);
    product_int8<false>(acc, Xq, Ws, 0u, l);

    // dequantise, rescale, clip: the next step's activation
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 16; ++ni) {
        const float2 c = *reinterpret_cast<const float2*>(
            sws + l.wn * 128 + ni * 8 + 2 * l.t);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float deq = (float)acc[mi][ni][r] * s[mi][r >> 1] * ((r & 1) ? c.y : c.x);
          xv[mi][ni][r] = fminf(fmaxf(deq * 0.0625f, -2.0f), 2.0f);
        }
      }
  }
  __syncthreads();  // sws is staged when R == 0 too; red is free
  store_colmax(xv, red,
               partial + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * ND, l);
}

// out[g][c] = max over the tiles of partial[g][tile][c]; grid G, block ND.
template <typename T>
__global__ void __launch_bounds__(ND) fold_kernel(const T* __restrict__ partial,
                                                  int tiles, T* __restrict__ out) {
  const T* src = partial + (size_t)blockIdx.x * tiles * ND + threadIdx.x;
  T m = src[0];
  for (int i = 1; i < tiles; ++i) m = tmax(m, src[(size_t)i * ND]);
  out[(size_t)blockIdx.x * ND + threadIdx.x] = m;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

int k3_rows_per_cta() { return TM; }
int k3_depth() { return KD; }
int k3_width() { return ND; }
const char* k3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One probe launch: variant 0-5 as listed at the top. x is [M, 256] (variant
// 4: [2M, 256]) in the variant's operand type (bf16, int8, or f32 for variant
// 5), wt the [256, 256] weights transposed to [n][k] (bf16 or int8), sw the
// [256] f32 column scales (variant 5 only). partial [G, M / 128, 256] and out
// [G, 256] are f32 (variants 0, 1, 5) or int32. M must be a multiple of 128.
int k3_probe(int variant, const void* x, const void* wt, const void* sw, int M,
             int G, int R, void* partial, void* out, void* stream) {
  if (M < TM || M % TM != 0 || G < 1 || G > 65535 || R < 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(M / TM, G);
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaSuccess;
  switch (variant) {
    case 0:
      if ((e = allow_smem(bf16_kernel<true>, SMEM_BF16)) != cudaSuccess) return (int)e;
      bf16_kernel<true><<<grid, THREADS, SMEM_BF16, st>>>(
          (const bf16*)x, (const bf16*)wt, R, (float*)partial);
      break;
    case 1:
      if ((e = allow_smem(bf16_kernel<false>, SMEM_BF16)) != cudaSuccess) return (int)e;
      bf16_kernel<false><<<grid, THREADS, SMEM_BF16, st>>>(
          (const bf16*)x, (const bf16*)wt, R, (float*)partial);
      break;
    case 2:
      if ((e = allow_smem(int8_kernel<2>, SMEM_INT8)) != cudaSuccess) return (int)e;
      int8_kernel<2><<<grid, THREADS, SMEM_INT8, st>>>(
          (const int8_t*)x, (const int8_t*)wt, M, R, (int*)partial);
      break;
    case 3:
      if ((e = allow_smem(int8_kernel<3>, SMEM_INT8)) != cudaSuccess) return (int)e;
      int8_kernel<3><<<grid, THREADS, SMEM_INT8, st>>>(
          (const int8_t*)x, (const int8_t*)wt, M, R, (int*)partial);
      break;
    case 4:
      if ((e = allow_smem(int8_kernel<4>, SMEM_SLICE)) != cudaSuccess) return (int)e;
      int8_kernel<4><<<grid, THREADS, SMEM_SLICE, st>>>(
          (const int8_t*)x, (const int8_t*)wt, M, R, (int*)partial);
      break;
    case 5:
      if ((e = allow_smem(glue_kernel, SMEM_GLUE)) != cudaSuccess) return (int)e;
      glue_kernel<<<grid, THREADS, SMEM_GLUE, st>>>(
          (const float*)x, (const int8_t*)wt, (const float*)sw, R, (float*)partial);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (variant == 2 || variant == 3 || variant == 4)
    fold_kernel<int><<<G, ND, 0, st>>>((const int*)partial, M / TM, (int*)out);
  else
    fold_kernel<float><<<G, ND, 0, st>>>((const float*)partial, M / TM, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
