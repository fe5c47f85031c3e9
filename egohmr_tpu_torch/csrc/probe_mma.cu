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
// the G grid steps one after another on one core. Here a CTA owns 128 whole
// rows of one chain (whole rows: the glue variant's row scale needs all 256
// columns of a row) and the grid is (M / 128, G) CTAs side by side, one per
// SM at a time. Two warpgroups each own 64 rows x all 256 columns: an
// m64n256 accumulator of 128 registers a thread (f32 or s32), carried in
// registers across all R steps. Every product is `wgmma`:
// m64n256k16.f32.bf16.bf16, 16 k-steps a product, or m64n256k32.s32.s8.s8,
// 8 k-steps a product; no mma.sync and no library product.
//
// Operands. w arrives transposed, [n][k], which is the K-major layout that
// integer wgmma requires and bf16 wgmma takes. It is staged once per launch
// into shared memory in 128-byte-swizzled panels of [256 n][128 bytes of k]
// (the swizzle is applied while staging), and B is read from there by
// descriptor: the R loop reads nothing from device memory. The CTA's rows of
// x are staged the same way, in panels of [128 rows][128 bytes]. Where A
// comes from, per variant:
//   1 bf16_bare, 3 int8_bare   shared memory, by descriptor: the operand
//                              never changes, so no thread touches it
//   4 int8_slice               shared memory, by descriptor, alternating
//                              between the two staged halves of x2
//   0 bf16, 2 int8             registers: each k-step's fragment is fetched
//                              by ldmatrix (a k-step is 32 bytes of a row for
//                              both types, so one address scheme serves both)
//                              and perturbed on the way (bf16x2 add, or a
//                              wrapping bytewise add), two fragments in turn
//                              so the next is fetched while a product runs.
//                              Two staged bf16 copies of x (2 x 64 KB) and w
//                              (128 KB) would overflow the 227 KB a CTA has,
//                              so the perturbation happens in registers.
//   5 int8_glue                registers, made by the glue itself (below)
//
// The glue variant keeps the activation in registers, in the accumulator's
// layout: a thread holds rows g and g + 8 of its warp's 16 and, of each
// 32-wide k-block, columns {8j + 2t, 8j + 2t + 1 : j = 0..3} (g = lane / 4,
// t = lane % 4). A row's 256 values sit in one quad of lanes, so its max|x|
// is a 4-lane shuffle; no __syncthreads and no shared-memory round trip in
// the step. Each step quantises x straight into the 32 int8 A registers of
// the whole depth, lets x die, runs the 8 wgmma k-steps into a fresh s32
// accumulator and dequantises in place into the next x. The int8 A fragment
// wants k = 4t..4t+3 and 16 + 4t..16 + 4t + 3 of a k-block, not the columns
// the thread holds; the wrapper permutes w's k index within each 32-wide
// block once (probe_int8_mma.py:glue_k_order) so that the thread's columns,
// in fragment order, meet the rows of w they multiply. Integer sums are
// exact, so the result is the same bit for bit. The glue keeps the plain
// version's arithmetic in FMA-pipe instructions: x / s correctly rounded
// from the row's reciprocal (div_rn), round half to even and int -> float
// by adding 1.5 x 2^23 (q8, i2f), the dequantisation's products in the
// plain version's order. (IEEE division proper, with its slow-path branch
// per element, and the quarter-rate F2I and I2F made the step 5x slower.)
// With two warpgroups, one's glue runs on the CUDA cores while the other's
// wgmma is in flight.
//
// Read on an NVIDIA H100 80GB HBM3 at 700 W, per product at G = 32, M =
// 2048: bf16 0.29 us (93-94% of the bf16 peak), int8 0.14-0.15 us (91-100%
// of the int8 peak; the published peaks assume 1,830 MHz and the SMs run
// up to 1,980), the glue variant 0.45 us, set by the glue.
//
// At the end each warp reduces its rows to column maxima, a CTA folds its 8
// warps into a [256] partial max, and a second small kernel folds the
// M / 128 partials into out[g]; both are outside the probe's timed
// difference, which takes (t(R2) - t(R1)).
//
// The entry point returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int KD = 256;        // K, the products' depth
constexpr int ND = 256;        // N, their width
constexpr int TM = 128;        // rows of one chain per CTA
constexpr int THREADS = 256;   // two warpgroups of 64 rows
constexpr int WARPS = THREADS / 32;
constexpr int PANEL = 128;     // bytes of a row in one swizzled panel
constexpr int RED_BYTES = WARPS * ND * 4;

// ------------------------------------------------------------------ helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
}

// `rows` rows of `row_bytes` bytes (a multiple of 128) from device memory
// into panels of [rows][128 bytes], panel p holding bytes 128p .. 128p + 127
// of every row, the 16-byte chunk c of row r at chunk c ^ (r % 8): the
// 128-byte swizzle that wgmma descriptors and ldmatrix read without bank
// conflicts.
__device__ __forceinline__ void stage_swizzled(unsigned char* dst,
                                               const unsigned char* src,
                                               int rows, int row_bytes) {
  const int chunks = row_bytes / 16;
  for (int i = threadIdx.x; i < rows * chunks; i += THREADS) {
    const int r = i / chunks, c = i % chunks;
    const uint4 v = *reinterpret_cast<const uint4*>(src + (size_t)r * row_bytes + c * 16);
    *reinterpret_cast<uint4*>(dst + (size_t)(c / 8) * rows * PANEL + r * PANEL +
                              (((c % 8) ^ (r & 7)) << 4)) = v;
  }
}

// shared memory written by ordinary stores, made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {  // until at most N groups are in flight
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// wgmma reads its register operands after the instruction has left the
// warp: these keep a register allocated, and its later uses in place, until
// the wait that ends the read
__device__ __forceinline__ void keep(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }
__device__ __forceinline__ void keep(int& r) { asm volatile("" : "+r"(r)::"memory"); }
__device__ __forceinline__ void keep(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// The descriptor of a K-major operand in a 128-byte-swizzled panel: start
// address, leading offset 1 (unused when swizzled), 1024 bytes between
// 8-row groups, layout type 1 (128-byte swizzle); in units of 16 bytes. The
// k-step kk of a panel (32 bytes of each row) starts at + 2 kk.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// The 128 accumulator operands of an m64n256 wgmma. d[4j + r] holds row g
// (+8 for r >= 2) of the warp's 16 and column 8j + 2t + (r & 1).
#define K3_D8(C, i) C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), \
                    C(d[i + 4]), C(d[i + 5]), C(d[i + 6]), C(d[i + 7])
#define K3_D128(C) K3_D8(C, 0), K3_D8(C, 8), K3_D8(C, 16), K3_D8(C, 24),      \
                   K3_D8(C, 32), K3_D8(C, 40), K3_D8(C, 48), K3_D8(C, 56),    \
                   K3_D8(C, 64), K3_D8(C, 72), K3_D8(C, 80), K3_D8(C, 88),    \
                   K3_D8(C, 96), K3_D8(C, 104), K3_D8(C, 112), K3_D8(C, 120)
#define K3_RW_F(v) "+f"(v)
#define K3_RW_R(v) "+r"(v)
#define K3_W_R(v) "=r"(v)
#define K3_DREGS                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "  \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "  \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "  \
  "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "  \
  "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, "    \
  "%103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, "   \
  "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"

// d = (scale_d ? d : 0) + A @ B^T, asynchronously, the warpgroup's four
// warps together. With a descriptor A (64 x k-step) is read from shared
// memory; with registers it is the fragment of 16 rows per warp: a0 row g, a1
// row g + 8, a2 and a3 the same rows 16 bytes of k further, each register 4
// bytes of k at 4t. B is K-major (transpose flag 0).
#define K3_WGMMA(SHAPE, A, B, TAIL) \
  "{\n.reg .pred p;\nsetp.ne.b32 p, " TAIL ", 0;\nwgmma.mma_async.sync.aligned." SHAPE " " K3_DREGS ", " A ", " B ", p"
__device__ __forceinline__ void mma_bf16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(K3_WGMMA("m64n256k16.f32.bf16.bf16", "%128", "%129", "%130") ", 1, 1, 0, 0;\n}\n"
               : K3_D128(K3_RW_F)
               : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void mma_bf16(float (&d)[128], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(K3_WGMMA("m64n256k16.f32.bf16.bf16", "{%128, %129, %130, %131}", "%132",
                        "%133") ", 1, 1, 0;\n}\n"
               : K3_D128(K3_RW_F)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void mma_s8(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(K3_WGMMA("m64n256k32.s32.s8.s8", "%128", "%129", "%130") ";\n}\n"
               : K3_D128(K3_RW_R)
               : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void mma_s8(int (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(K3_WGMMA("m64n256k32.s32.s8.s8", "{%128, %129, %130, %131}", "%132",
                        "%133") ";\n}\n"
               : K3_D128(K3_RW_R)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d = A @ B^T: the first k-step of a fresh sum. d is written, not read, so
// whatever the registers held before (the glue's dead activation) may share
// them.
__device__ __forceinline__ void mma_s8_first(int (&d)[128], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(K3_WGMMA("m64n256k32.s32.s8.s8", "{%128, %129, %130, %131}", "%132",
                        "%133") ";\n}\n"
               : K3_D128(K3_W_R)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
}

__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __hadd2(*reinterpret_cast<__nv_bfloat162*>(&a),
                                   *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ float tmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ int tmax(int a, int b) { return max(a, b); }

// partial_row[c] = max over the CTA's TM rows of column c; red is [WARPS][ND]
template <typename T>
__device__ __forceinline__ void store_colmax(const T (&v)[128], T* red,
                                             T* __restrict__ partial_row) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    T m0 = tmax(v[4 * j], v[4 * j + 2]), m1 = tmax(v[4 * j + 1], v[4 * j + 3]);
    // over the 8 lanes that share t: the warp's 16 rows
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      m0 = tmax(m0, __shfl_xor_sync(0xffffffffu, m0, off));
      m1 = tmax(m1, __shfl_xor_sync(0xffffffffu, m1, off));
    }
    if (g == 0) {
      red[warp * ND + 8 * j + 2 * t] = m0;
      red[warp * ND + 8 * j + 2 * t + 1] = m1;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < ND; c += THREADS) {
    T m = red[c];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) m = tmax(m, red[w * ND + c]);
    partial_row[c] = m;
  }
}

// ------------------------------------------------------- variants 0 to 4

template <int MODE>
struct Pure {
  static constexpr bool BF16 = MODE < 2;
  static constexpr bool REG_A = MODE == 0 || MODE == 2;   // perturbed: A in registers
  static constexpr int HALVES = MODE == 4 ? 2 : 1;
  static constexpr int ROW_BYTES = BF16 ? KD * 2 : KD;
  static constexpr int KSTEPS = ROW_BYTES / 32;            // 32 bytes of k a step
  static constexpr int W_BYTES = ND * ROW_BYTES;
  static constexpr int X_BYTES = TM * ROW_BYTES;
  static constexpr int OFF_X = W_BYTES;
  static constexpr int OFF_RED = OFF_X + HALVES * X_BYTES;
  static constexpr size_t SMEM = OFF_RED + RED_BYTES + 1024;  // + alignment slack
  typedef typename std::conditional<BF16, float, int>::type Acc;
};

// the A fragment of k-step kk for this warp's 16 rows from the swizzled
// panels at xs: matrices (rows 0-7, bytes 0-15), (rows 8-15, bytes 0-15),
// (rows 0-7, bytes 16-31), (rows 8-15, bytes 16-31) of the k-step
__device__ __forceinline__ void load_a(uint32_t (&a)[4], uint32_t xs, int row0, int lane,
                                       int kk) {
  const int m = lane >> 3, r = lane & 7;
  const int row = row0 + (m & 1) * 8 + r, chunk = (kk % 4) * 2 + (m >> 1);
  ldmatrix_x4(xs + (kk / 4) * TM * PANEL + row * PANEL + ((chunk ^ r) << 4), a);
}

template <bool BF16>
__device__ __forceinline__ void perturb(uint32_t (&a)[4], uint32_t one) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = BF16 ? add_bf16x2(a[i], one) : __vadd4(a[i], one);
}

// x [M, KD] (MODE 4: [2M, KD]) bf16 or int8, wt [ND, KD] of the same type,
// partial [G, M / TM, ND] f32 or int32; grid (M / TM, G).
template <int MODE>
__global__ void __launch_bounds__(THREADS, 1) pure_kernel(
    const unsigned char* __restrict__ x, const unsigned char* __restrict__ wt, int M,
    int R, void* __restrict__ partial) {
  typedef Pure<MODE> P;
  typedef typename P::Acc Acc;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t sbase = smem_u32(smem);
  stage_swizzled(smem, wt, ND, P::ROW_BYTES);
  for (int h = 0; h < P::HALVES; ++h)
    stage_swizzled(smem + P::OFF_X + h * P::X_BYTES,
                   x + ((size_t)h * M + (size_t)blockIdx.x * TM) * P::ROW_BYTES, TM,
                   P::ROW_BYTES);
  fence_proxy_async();
  __syncthreads();

  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  const int row0 = wg * 64 + ((threadIdx.x >> 5) & 3) * 16;  // the warp's first row
  const uint32_t xs = sbase + P::OFF_X;
  auto b_desc = [&](int kk) {
    return sw128_desc(sbase + (kk / 4) * ND * PANEL) + 2 * (kk % 4);
  };
  Acc acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;

  if constexpr (P::REG_A) {
    // the perturbation of step i: bf16 1.0 or 0.0 in each half, or a byte
    // of 1 or 0 in each of the four
    auto one = [](int i) -> uint32_t {
      return (i & 1) ? (P::BF16 ? 0x3F803F80u : 0x01010101u) : 0u;
    };
    uint32_t a[2][4];
    if (R > 0) {
      load_a(a[0], xs, row0, lane, 0);
      perturb<P::BF16>(a[0], one(0));
    }
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int kk = 0; kk < P::KSTEPS; ++kk) {
        wgmma_fence();
        if constexpr (P::BF16) mma_bf16(acc, a[kk & 1], b_desc(kk));
        else mma_s8(acc, a[kk & 1], b_desc(kk));
        wgmma_commit();
        wgmma_wait<1>();  // k-step kk - 1 is done: its fragment is free
        uint32_t (&next)[4] = a[(kk + 1) & 1];
#pragma unroll
        for (int r = 0; r < 4; ++r) keep(next[r]);
        if (kk + 1 < P::KSTEPS) {
          load_a(next, xs, row0, lane, kk + 1);
          perturb<P::BF16>(next, one(i));
        } else if (i + 1 < R) {  // KSTEPS is even: the next product starts in a[0]
          load_a(next, xs, row0, lane, 0);
          perturb<P::BF16>(next, one(i + 1));
        }
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      keep(a[0][r]);
      keep(a[1][r]);
    }
  } else {
    const uint32_t xa = xs + wg * 64 * PANEL;  // the warpgroup's 64 rows
    for (int i = 0; i < R; ++i) {
      const uint32_t xh = xa + (P::HALVES == 2 ? (i & 1) * P::X_BYTES : 0);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < P::KSTEPS; ++kk) {
        const uint64_t da = sw128_desc(xh + (kk / 4) * TM * PANEL) + 2 * (kk % 4);
        if constexpr (P::BF16) mma_bf16(acc, da, b_desc(kk));
        else mma_s8(acc, da, b_desc(kk));
      }
      wgmma_commit();
      wgmma_wait<1>();  // one product in flight while the next is issued
    }
    wgmma_wait<0>();
  }
#pragma unroll
  for (int i = 0; i < 128; ++i) keep(acc[i]);
  store_colmax(acc, reinterpret_cast<Acc*>(smem + P::OFF_RED),
               reinterpret_cast<Acc*>(partial) +
                   ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * ND);
}

// -------------------------------------------------------------- variant 5

constexpr int GLUE_OFF_SW = ND * KD;               // after w's 64 KB
constexpr int GLUE_OFF_RED = GLUE_OFF_SW + ND * 4;
constexpr size_t SMEM_GLUE = GLUE_OFF_RED + RED_BYTES + 1024;

constexpr float RINT_MAGIC = 12582912.0f;  // 1.5 x 2^23
constexpr int RINT_MAGIC_BITS = 0x4B400000;

// a / b rounded to nearest even, from rb = 1 / b rounded to nearest
// (Markstein: q = a rb lies within an ulp of a / b, the residual a - q b is
// exact by FMA, and q + residual x rb rounds to a / b), for a quotient that
// neither overflows nor underflows: three FMA-pipe instructions in place of
// a division's reciprocal and its slow-path branch
__device__ __forceinline__ float div_rn(float a, float b, float rb) {
  const float q = __fmul_rn(a, rb);
  return __fmaf_rn(__fmaf_rn(-q, b, a), rb, q);
}

// int8(rint(v / s)) in the low byte: adding 1.5 x 2^23 rounds any |q| < 2^22
// to an integer, half to even, and leaves it in the float's low mantissa
// bits as two's complement (a full-rate add in place of a quarter-rate F2I)
__device__ __forceinline__ uint32_t q8(float v, float s, float rs) {
  return __float_as_uint(__fadd_rn(div_rn(v, s, rs), RINT_MAGIC));
}

__device__ __forceinline__ uint32_t quant4(float v0, float v1, float v2, float v3, float s,
                                           float rs) {
  return __byte_perm(__byte_perm(q8(v0, s, rs), q8(v1, s, rs), 0x0040),
                     __byte_perm(q8(v2, s, rs), q8(v3, s, rs), 0x0040), 0x5410);
}

// f32(i), exact for |i| < 2^22 (an int8 product of depth 256 is below
// 256 x 128 x 128 = 2^22): the same trick backwards, in place of an I2F
__device__ __forceinline__ float i2f(int i) {
  return __fsub_rn(__int_as_float(i + RINT_MAGIC_BITS), RINT_MAGIC);
}

// x [M, KD] f32 (KD == ND: the result is the next operand), wt [ND, KD]
// int8 with k permuted within each 32-wide block (glue_k_order), sw [ND]
// f32, partial [G, M / TM, ND] f32.
__global__ void __launch_bounds__(THREADS, 1) glue_kernel(
    const float* __restrict__ x, const unsigned char* __restrict__ wt,
    const float* __restrict__ sw, int R, float* __restrict__ partial) {
  static_assert(KD == ND, "the glue variant feeds its result back");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t sbase = smem_u32(smem);
  float* sws = reinterpret_cast<float*>(smem + GLUE_OFF_SW);
  stage_swizzled(smem, wt, ND, KD);
  // sw / 16: scaling by a power of two commutes with rounding, so
  // (f32(acc) s) (sw / 16) is the plain version's ((f32(acc) s) sw) / 16
  // bit for bit (no product here is near the subnormal range)
  for (int c = threadIdx.x; c < ND; c += THREADS) sws[c] = sw[c] * 0.0625f;
  fence_proxy_async();
  __syncthreads();

  const int lane = threadIdx.x & 31, t = lane & 3;
  const int row = blockIdx.x * TM + (threadIdx.x >> 7) * 64 +
                  ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);  // and row + 8
  // the activation, in the accumulator's layout
  float xv[128];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float2 lo = *reinterpret_cast<const float2*>(x + (size_t)row * KD + 8 * j + 2 * t);
    const float2 hi =
        *reinterpret_cast<const float2*>(x + (size_t)(row + 8) * KD + 8 * j + 2 * t);
    xv[4 * j] = lo.x, xv[4 * j + 1] = lo.y, xv[4 * j + 2] = hi.x, xv[4 * j + 3] = hi.y;
  }

  for (int i = 0; i < R; ++i) {
    // per-row max |x|: this thread's 64 columns, then the quad's 4 lanes
    float m0 = 0.f, m1 = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      m0 = fmaxf(m0, fmaxf(fabsf(xv[4 * j]), fabsf(xv[4 * j + 1])));
      m1 = fmaxf(m1, fmaxf(fabsf(xv[4 * j + 2]), fabsf(xv[4 * j + 3])));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
    }
    const float s0 = fmaxf(__fdiv_rn(m0, 127.0f), 1e-8f);
    const float s1 = fmaxf(__fdiv_rn(m1, 127.0f), 1e-8f);
    const float r0 = __frcp_rn(s0), r1 = __frcp_rn(s1);

    // quantise into the A fragments of all 8 k-steps: k-block kk holds the
    // groups j = 4kk .. 4kk + 3; register 0 (row g) takes groups 4kk and
    // 4kk + 1, register 2 groups 4kk + 2 and 4kk + 3, registers 1 and 3 the
    // same of row g + 8; w's k is permuted to match
    uint32_t a[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* p = xv + 16 * kk + 8 * h;  // groups 4kk + 2h, 4kk + 2h + 1
        a[kk][2 * h] = quant4(p[0], p[1], p[4], p[5], s0, r0);
        a[kk][2 * h + 1] = quant4(p[2], p[3], p[6], p[7], s1, r1);
      }
    }

    int acc[128];
    wgmma_fence();
    mma_s8_first(acc, a[0], sw128_desc(sbase));
#pragma unroll
    for (int kk = 1; kk < 8; ++kk)
      mma_s8(acc, a[kk], sw128_desc(sbase + (kk / 4) * ND * PANEL) + 2 * (kk % 4));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) keep(a[kk][r]);
#pragma unroll
    for (int c = 0; c < 128; ++c) keep(acc[c]);

    // dequantise, rescale, clip: the next step's activation
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float2 c = *reinterpret_cast<const float2*>(sws + 8 * j + 2 * t);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float deq = i2f(acc[4 * j + r]) * (r < 2 ? s0 : s1) * ((r & 1) ? c.y : c.x);
        xv[4 * j + r] = fminf(fmaxf(deq, -2.0f), 2.0f);
      }
    }
  }
  store_colmax(xv, reinterpret_cast<float*>(smem + GLUE_OFF_RED),
               partial + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * ND);
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
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int MODE>
cudaError_t launch_pure(dim3 grid, cudaStream_t st, const void* x, const void* wt, int M,
                        int R, void* partial) {
  const cudaError_t e = allow_smem(pure_kernel<MODE>, Pure<MODE>::SMEM);
  if (e != cudaSuccess) return e;
  pure_kernel<MODE><<<grid, THREADS, Pure<MODE>::SMEM, st>>>(
      (const unsigned char*)x, (const unsigned char*)wt, M, R, partial);
  return cudaGetLastError();
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
// 5), wt the [256, 256] weights transposed to [n][k] (bf16 or int8; variant
// 5: k permuted by glue_k_order), sw the [256] f32 column scales (variant 5
// only). partial [G, M / 128, 256] and out [G, 256] are f32 (variants 0, 1,
// 5) or int32. M must be a multiple of 128.
int k3_probe(int variant, const void* x, const void* wt, const void* sw, int M,
             int G, int R, void* partial, void* out, void* stream) {
  if (M < TM || M % TM != 0 || G < 1 || G > 65535 || R < 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(M / TM, G);
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaSuccess;
  switch (variant) {
    case 0: e = launch_pure<0>(grid, st, x, wt, M, R, partial); break;
    case 1: e = launch_pure<1>(grid, st, x, wt, M, R, partial); break;
    case 2: e = launch_pure<2>(grid, st, x, wt, M, R, partial); break;
    case 3: e = launch_pure<3>(grid, st, x, wt, M, R, partial); break;
    case 4: e = launch_pure<4>(grid, st, x, wt, M, R, partial); break;
    case 5:
      if ((e = allow_smem(glue_kernel, SMEM_GLUE)) != cudaSuccess) return (int)e;
      glue_kernel<<<grid, THREADS, SMEM_GLUE, st>>>(
          (const float*)x, (const unsigned char*)wt, (const float*)sw, R, (float*)partial);
      e = cudaGetLastError();
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  if (variant == 2 || variant == 3 || variant == 4)
    fold_kernel<int><<<G, ND, 0, st>>>((const int*)partial, M / TM, (int*)out);
  else
    fold_kernel<float><<<G, ND, 0, st>>>((const float*)partial, M / TM, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
