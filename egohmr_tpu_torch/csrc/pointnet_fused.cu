// K1: the fused ResnetPointnet scene encoder, for Hopper (sm_90a).
//
// Replaces egohmr_tpu/nn/pointnet_fused.py:_kernel (launched by
// _fused_pointnet_feature). For each scene cloud [P, 3] it computes fc_pos
// (3 -> 2H), block_0 (2H -> H, with shortcut), three pooled-context blocks
// and a max-pool after every stage. The result is the pooled pre-fc_c
// feature [B, H] in f32; fc_c stays a torch linear outside the kernel.
//
// Arithmetic, as in the JAX kernel: every matmul input is rounded to bf16
// and accumulates in f32; each stage's pool is taken from the f32 stage
// output, which is then stored as bf16 for the next stage.
//
// What bounds it on an H100: operations. 2.35 TFLOP per batch of 64 clouds at
// P = 20,000, H = 256 are 2.4 ms of the bf16 tensor cores; the bytes that
// must move (points in, feature out) are nothing. A stage needs the max over
// all of a cloud's points of the stage before it, and a cloud's activations
// (10 MB of bf16) fit no SM, so four dependent passes over the points
// remain: stages 0-2 write their [B, P, H] bf16 activations and stages 1-3
// read them, 3.9 GB at B = 64, about 1.2 ms of HBM time, which hides under
// the products. Stage 3 writes nothing: only its max is used.
//
// Design, one launch per stage, one persistent CTA per SM:
//   - A CTA walks a contiguous range of 128-point tiles. Two consumer
//     warpgroups own 64 points x all 256 channels each; a producer warp
//     feeds them through mbarriers.
//   - The stage's weights are prepared once per model by the wrapper as
//     [256 x 64] bf16 K-slices (32 KB, 128-byte swizzle), in the order the
//     tile consumes them. The producer streams them through a ring of four
//     slices in shared memory, one bulk asynchronous copy a slice
//     (cp.async.bulk + mbarrier), so copies are in flight while products
//     run. (Measured: with the copies left out the kernel is no faster; the
//     L2 does not hold it back.)
//   - The tile's activations [128][256] arrive by TMA (cp.async.bulk.tensor
//     through a tensor map), four boxes of [128][64] laid down with the
//     128-byte swizzle, while the previous tile finishes: the shortcut
//     product runs before the hidden one, which frees the activations a
//     third of a tile early. (A copy per row, 128 small copies a tile, held
//     the tile up by 3,000 clocks: the copy engine takes few large
//     requests, not many small ones.)
//   - Products are wgmma m64n256k16 (bf16 in, f32 accumulators, 128
//     registers a thread), B from the ring, A from registers: ldmatrix
//     fetches the activations so that ReLU is applied on the way, three
//     fragments rotating so that the next is fetched while two products are
//     with the tensor cores; and the hidden layer relu(net) never leaves
//     the registers, since the accumulator fragment of 16 columns has the
//     layout of the next product's A operand.
//   - Stage 0 computes fc_pos (K = 3) on the CUDA cores straight into A
//     fragments, twice per tile (with and without ReLU): bf16 products are
//     exact in f32.
//   - Bias and the bf16 rounding run in registers. The output leaves
//     through a small patch of shared memory per warp, so that the stores
//     are whole 128-byte lines (4-byte stores straight from the fragments
//     cost 6,500 clocks a tile in the load/store unit). The max over a
//     tile's points is reduced by a butterfly of shuffles, carried in
//     registers across a CTA's tiles of one cloud, and merged into [B, H]
//     by atomicMax on an order-preserving integer encoding: a max is exact
//     in any order, so the result is deterministic. A small kernel per
//     stage decodes it and computes the pooled-context rows
//     relu(pool) @ W0b + b0 and pool @ Wsb + b1 once per cloud.
//   What is left (clocks a tile of stages 1-2, of 17,500): the products run
//   at the tensor cores' rate while both warpgroups are in them (12,400),
//   but the hidden layer's conversion (1,500) and the epilogue (3,600) keep
//   no tensor core busy, and the two warpgroups reach them together.
//
// Every entry point returns cudaGetLastError() (0 on success).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int H = 256;  // hidden width (pointnet_hidden_dim)
constexpr int H2 = 2 * H;
constexpr int TP = 128;             // points per tile
constexpr int CONSUMER_WARPS = 8;   // two warpgroups, 16 points a warp
constexpr int THREADS = 384;        // consumers + the producer's warpgroup
constexpr int KS = 64;              // K width of a weight slice
constexpr int SLICE_BYTES = H * KS * 2;   // 32 KB
constexpr int RING = 4;                   // slices in flight
// a tile's activations in shared memory: H / 64 panels of [TP rows][64
// channels], 128-byte rows with the 128-byte swizzle, as TMA lays them down
constexpr int X_PANEL_BYTES = TP * KS * 2;        // 16 KB
constexpr int X_BYTES = (H / KS) * X_PANEL_BYTES; // 64 KB
constexpr int SLICES_STAGE0 = 20;  // W00 (K=512): 8, W0s: 8, W01: 4
constexpr int SLICES_STAGE = 12;   // W0a, Wsa, W1 (K=256): 4 each

// shared memory, from a 1024-byte aligned base
constexpr int OFF_RING = 0;
constexpr int OFF_X = OFF_RING + RING * SLICE_BYTES;
constexpr int OFF_WPOS = OFF_X + X_BYTES;   // float4 [2H]
constexpr int PATCH_LD_BYTES = 64 * 2 + 16;       // 64 channels of a row, padded
constexpr int PATCH_BYTES = 16 * PATCH_LD_BYTES;  // a warp's 16 rows
constexpr int OFF_PATCH = OFF_WPOS + H2 * 16;
constexpr int OFF_BAR = OFF_PATCH + CONSUMER_WARPS * PATCH_BYTES;
constexpr int NUM_BARS = 2 * RING + 2;
constexpr int SMEM_BYTES = OFF_BAR + NUM_BARS * 8 + 1024;  // + alignment slack

// ---------------------------------------------------------------- helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// spin until the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes (a multiple of 16) from device memory to shared memory; completion
// is reported to the mbarrier as transaction bytes
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// one box of a 2-D tensor map (x: channels, y: rows) from device memory to
// shared memory, swizzled as the map says
__device__ __forceinline__ void tensor_copy_2d(uint32_t dst, const CUtensorMap* map,
                                               int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ uint4 ld_shared_u128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ uint32_t relu_bf16x2(uint32_t v) {
  // zero each 16-bit half whose sign bit is set
  const uint32_t neg = (v >> 15) & 0x00010001u;
  return v & ~(neg * 0xFFFFu);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// an int whose order is the float's: max over floats = max over encodings
__device__ __forceinline__ int order_encode(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float order_decode(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
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
// warp: these
// keep a register allocated, and its later uses in place, until the wait
// that ends the read
__device__ __forceinline__ void keep(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}
__device__ __forceinline__ void keep(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// The shared-memory descriptor of a weight slice [H n][64 k] bf16, K-major
// with the 128-byte swizzle: start address, leading offset 1 (unused for a
// swizzled K-major operand), stride 1024 bytes between 8-row groups, layout
// type 1 (128-byte swizzle); all in units of 16 bytes. k-step kk of the
// slice starts 32 bytes further: + 2 kk.
__device__ __forceinline__ uint64_t slice_descriptor(uint32_t slot) {
  return static_cast<uint64_t>((slot & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// A warpgroup owns 64 tile rows, a warp rows 16 * warp + [0, 16), and all H
// channels. d[4 * j + r] holds row g (+8 for r >= 2) and channel
// 8 * j + 2 * t + (r & 1), with g = lane / 4 and t = lane % 4: the m64n256
// accumulator layout, j counting the 8-channel groups. Columns
// 16 * kk + [0, 16) of that fragment (d[8 * kk .. 8 * kk + 7]) sit where the
// A operand of k-step kk wants them.
//
// d = (accumulate ? d : 0) + A(64 x 16, registers) @ B(256 x 16, shared
// memory, K-major)^T, asynchronously: the warpgroup's four warps start it
// together.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint32_t a0,
                                                 uint32_t a1, uint32_t a2,
                                                 uint32_t a3, uint64_t desc_b,
                                                 bool accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63, "
      " %64, %65, %66, %67, %68, %69, %70, %71, "
      " %72, %73, %74, %75, %76, %77, %78, %79, "
      " %80, %81, %82, %83, %84, %85, %86, %87, "
      " %88, %89, %90, %91, %92, %93, %94, %95, "
      " %96, %97, %98, %99, %100, %101, %102, %103, "
      " %104, %105, %106, %107, %108, %109, %110, %111, "
      " %112, %113, %114, %115, %116, %117, %118, %119, "
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(accumulate ? 1 : 0));
}

// A fragment of k-step k0 (a multiple of 16) from the activations in
// shared memory (swizzled panels), with ReLU on the way if asked.
template <bool RELU>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], uint32_t xs, int warp,
                                       int lane, int k0) {
  // matrices (rows 0-7, k low), (rows 8-15, k low), (0-7, k high), (8-15, k high);
  // lane l addresses row l % 8 of matrix l / 8; a row's 16-byte chunk c sits
  // at chunk c ^ (row % 8)
  const int m = lane >> 3, r = lane & 7;
  const int row = warp * 16 + (m & 1) * 8 + r, chunk = (k0 % KS) / 8 + (m >> 1);
  ldmatrix_x4(xs + (k0 / KS) * X_PANEL_BYTES + row * (KS * 2) + ((chunk ^ r) << 4), a);
  if (RELU) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = relu_bf16x2(a[i]);
  }
}

// A fragment of k-step k0 of net0 = fc_pos(point), made on the CUDA cores:
// pa / pb are the points of rows g and g + 8, wpos[c] = (w0, w1, w2, bias).
template <bool RELU>
__device__ __forceinline__ void make_a(uint32_t (&a)[4], const float4* wpos,
                                       const float (&pa)[3],
                                       const float (&pb)[3], int k0, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float4 w0 = wpos[k0 + half * 8 + 2 * t];
    const float4 w1 = wpos[k0 + half * 8 + 2 * t + 1];
    float v[4] = {pa[0] * w0.x + pa[1] * w0.y + pa[2] * w0.z + w0.w,
                  pa[0] * w1.x + pa[1] * w1.y + pa[2] * w1.z + w1.w,
                  pb[0] * w0.x + pb[1] * w0.y + pb[2] * w0.z + w0.w,
                  pb[0] * w1.x + pb[1] * w1.y + pb[2] * w1.z + w1.w};
    if (RELU) {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = fmaxf(v[i], 0.f);
    }
    a[2 * half] = pack_bf16x2(v[0], v[1]);
    a[2 * half + 1] = pack_bf16x2(v[2], v[3]);
  }
}

// One stage over the CTA's range of tiles.
//   STAGE0: A comes from the points through fc_pos (K = 2H); otherwise from
//           the bf16 activations [B, P, H] behind xmap (K = H).
//   STORE:  write the stage's bf16 output xout [B, P, H].
// wsl: the stage's weight slices in the order consumed: W0 (or W00), then the
// shortcut, then W1 (or W01). hbias: the hidden layer's bias, one row
// (hbias_stride 0) or a row per cloud (rpool, stride H). obias: the
// output's, likewise (fc_1's bias, in stages 1-3 with the cloud's pooled
// shortcut row added). pool_enc [B, H]: order-encoded max.
template <bool STAGE0, bool STORE>
__global__ void __launch_bounds__(THREADS, 1) stage_kernel(
    const bf16* __restrict__ pts, const __grid_constant__ CUtensorMap xmap,
    const bf16* __restrict__ wsl, const float4* __restrict__ wpos,
    const float* __restrict__ hbias, int hbias_stride,
    const float* __restrict__ obias, int obias_stride,
    bf16* __restrict__ xout, int* __restrict__ pool_enc, int B, int P) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sbase = smem_u32(smem);
  const uint32_t ring = sbase + OFF_RING, xs = sbase + OFF_X;
  float4* wpos_s = reinterpret_cast<float4*>(smem + OFF_WPOS);
  const uint32_t bar_full = sbase + OFF_BAR;            // [RING]
  const uint32_t bar_empty = bar_full + RING * 8;       // [RING]
  const uint32_t bar_xfull = bar_empty + RING * 8;
  const uint32_t bar_xempty = bar_xfull + 8;

  constexpr int NK = (STAGE0 ? H2 : H) / KS;  // slices of W0 and of the shortcut
  constexpr int NSL = STAGE0 ? SLICES_STAGE0 : SLICES_STAGE;
  static_assert(NSL % RING == 0 && (NSL / RING) % 2 == 1,
                "slot and parity of a slice follow from its place in the tile");

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int i = 0; i < RING; ++i) {
      mbar_init(bar_full + 8 * i, 1);
      mbar_init(bar_empty + 8 * i, CONSUMER_WARPS);
    }
    mbar_init(bar_xfull, 1);
    mbar_init(bar_xempty, CONSUMER_WARPS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (STAGE0)
    for (int i = tid; i < H2; i += THREADS) wpos_s[i] = wpos[i];
  __syncthreads();

  const int tiles_per_cloud = (P + TP - 1) / TP;
  const long long n_tiles = static_cast<long long>(B) * tiles_per_cloud;
  const int t_begin = static_cast<int>(blockIdx.x * n_tiles / gridDim.x);
  const int t_end = static_cast<int>((blockIdx.x + 1) * n_tiles / gridDim.x);

  if (warp >= CONSUMER_WARPS) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp != CONSUMER_WARPS) return;
    for (int t = t_begin; t < t_end; ++t) {
      const int n = t - t_begin;  // the slices' parity flips with every tile
      if (!STAGE0) {
        const int b = t / tiles_per_cloud, p0 = (t % tiles_per_cloud) * TP;
        mbar_wait(bar_xempty, (n & 1) ^ 1);
        if (lane == 0) {
          // rows past the cloud's end are the next cloud's, or zeros past
          // the last: the epilogue leaves them out
          mbar_expect_tx(bar_xfull, X_BYTES);
#pragma unroll
          for (int c = 0; c < H / KS; ++c)
            tensor_copy_2d(xs + c * X_PANEL_BYTES, &xmap, c * KS, b * P + p0, bar_xfull);
        }
      }
      if (lane == 0) {
        for (int s = 0; s < NSL; ++s) {
          const int slot = s % RING;
          mbar_wait(bar_empty + 8 * slot, ((n + s / RING) & 1) ^ 1);
          mbar_expect_tx(bar_full + 8 * slot, SLICE_BYTES);
          bulk_copy(ring + slot * SLICE_BYTES,
                    reinterpret_cast<const unsigned char*>(wsl) +
                        static_cast<size_t>(s) * SLICE_BYTES,
                    SLICE_BYTES, bar_full + 8 * slot);
        }
      }
      __syncwarp();
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int g = lane >> 2, t4 = lane & 3;
  float acc[128];
  uint32_t hid[64];  // relu(net) as the A fragments of the W1 product
  // running max of the cloud's channels 8 * j + 2 * t4 + {0, 1} for the four
  // j this lane ends up with after the butterfly below: j = own_j + {0 .. 3}
  float run[8];
  const int own_j = 16 * (g & 1) + 8 * ((g >> 1) & 1) + 4 * (g >> 2);
  int cur_b = -1;
  // this warp's patch for the output: 16 rows x 64 channels, padded rows
  const uint32_t patch = sbase + OFF_PATCH + warp * PATCH_BYTES;

  auto flush = [&]() {
    if (cur_b < 0) return;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int* dst = pool_enc + static_cast<size_t>(cur_b) * H + 8 * (own_j + i) + 2 * t4;
      atomicMax(dst, order_encode(run[2 * i]));
      atomicMax(dst + 1, order_encode(run[2 * i + 1]));
    }
  };
  auto wait_slice = [&](int n, int s) {
    mbar_wait(bar_full + 8 * (s % RING), (n + s / RING) & 1);
  };
  auto release_slice = [&](int s) {  // after the wait that ended its products
    if (lane == 0) mbar_arrive(bar_empty + 8 * (s % RING));
  };
  auto slice_desc = [&](int s, int kk) {
    return slice_descriptor(ring + (s % RING) * SLICE_BYTES) + 2 * kk;
  };

  for (int t = t_begin; t < t_end; ++t) {
    const int n = t - t_begin;
    const int b = t / tiles_per_cloud, p0 = (t % tiles_per_cloud) * TP;
    if (b != cur_b) {
      flush();
      cur_b = b;
#pragma unroll
      for (int i = 0; i < 8; ++i) run[i] = -CUDART_INF_F;
    }
    const int row_a = p0 + warp * 16 + g, row_b = row_a + 8;

    float pa[3], pb[3];
    if (STAGE0) {
      const bf16* src = pts + static_cast<size_t>(b) * P * 3;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        pa[i] = __bfloat162float(src[static_cast<size_t>(min(row_a, P - 1)) * 3 + i]);
        pb[i] = __bfloat162float(src[static_cast<size_t>(min(row_b, P - 1)) * 3 + i]);
      }
    } else {
      mbar_wait(bar_xfull, n & 1);
    }

    // acc = op(x) @ W^T over slices S0 .. S0 + NK - 1, op = ReLU or the
    // identity, one wgmma a k-step. Three A
    // fragments rotate: while the tensor cores read two, the next is
    // fetched. `wait 1` after issuing k-step i says k-step i - 1 is done,
    // which frees its fragment and, at a slice's first k-step, the slice
    // before it.
    auto product_x = [&](auto relu, auto first_slice) {
      constexpr bool RELU = decltype(relu)::value;
      constexpr int S0 = decltype(first_slice)::value;
      constexpr int STEPS = NK * (KS / 16);
      uint32_t a[3][4];
      auto get_a = [&](uint32_t (&frag)[4], int i) {
        if (STAGE0) make_a<RELU>(frag, wpos_s, pa, pb, i * 16, t4);
        else load_a<RELU>(frag, xs, warp, lane, i * 16);
      };
      get_a(a[0], 0);
#pragma unroll
      for (int i = 0; i < STEPS; ++i) {
        const int s = S0 + i / (KS / 16), kk = i % (KS / 16);
        if (kk == 0) wait_slice(n, s);
        wgmma_fence();
        wgmma_m64n256k16(acc, a[i % 3][0], a[i % 3][1], a[i % 3][2], a[i % 3][3],
                         slice_desc(s, kk), i > 0);
        wgmma_commit();
        if (i + 1 < STEPS) get_a(a[(i + 1) % 3], i + 1);
        wgmma_wait<1>();
        if (i > 0) {
#pragma unroll
          for (int r = 0; r < 4; ++r) keep(a[(i - 1) % 3][r]);
          if (kk == 0) release_slice(s - 1);
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int r = 0; r < 4; ++r) keep(a[(STEPS - 1) % 3][r]);
#pragma unroll
      for (int i = 0; i < 128; ++i) keep(acc[i]);
      release_slice(S0 + NK - 1);
    };

    // net = relu(x) @ W0^T
    product_x(std::true_type{}, std::integral_constant<int, 0>{});

    // hid = bf16(relu(net + bias)), in A-fragment order; ReLU after the
    // rounding gives the same values as before it
    {
      const float* hb = hbias + static_cast<size_t>(b) * hbias_stride + 2 * t4;
      const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float2 bias = *reinterpret_cast<const float2*>(hb + 8 * j);
        __nv_bfloat162 lo = __hmax2(
            __floats2bfloat162_rn(acc[4 * j] + bias.x, acc[4 * j + 1] + bias.y), zero);
        __nv_bfloat162 hi = __hmax2(
            __floats2bfloat162_rn(acc[4 * j + 2] + bias.x, acc[4 * j + 3] + bias.y), zero);
        hid[2 * j] = *reinterpret_cast<uint32_t*>(&lo);
        hid[2 * j + 1] = *reinterpret_cast<uint32_t*>(&hi);
      }
    }

    // out = x @ Ws^T + hid @ W1^T; slice NK is the first of a new sum
    product_x(std::false_type{}, std::integral_constant<int, NK>{});
    if (!STAGE0) {  // the activations are read: the next tile's may land
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_xempty);
    }
#pragma unroll
    for (int s = 0; s < H / KS; ++s) {
      wait_slice(n, 2 * NK + s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS / 16; ++kk) {
        const int k4 = 4 * (s * (KS / 16) + kk);
        wgmma_m64n256k16(acc, hid[k4], hid[k4 + 1], hid[k4 + 2], hid[k4 + 3],
                         slice_desc(2 * NK + s, kk), true);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the slice before this one is done
      if (s > 0) release_slice(2 * NK + s - 1);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) keep(hid[i]);
#pragma unroll
    for (int i = 0; i < 128; ++i) keep(acc[i]);
    release_slice(NSL - 1);

    // Bias, then two things per 64-channel quarter. The bf16 output goes
    // through the warp's patch in shared memory, so that it leaves as whole
    // 128-byte lines, four rows a store. The max over the warp's valid rows
    // starts with each lane's two rows.
    {
      const float* ob = obias + static_cast<size_t>(b) * obias_stride + 2 * t4;
      const bool full = p0 + TP <= P;
      const bool ok_a = row_a < P, ok_b = row_b < P;
      float m[64];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = 8 * q + jj;
          const float2 bias = *reinterpret_cast<const float2*>(ob + 8 * j);
          const float v0 = acc[4 * j] + bias.x, v1 = acc[4 * j + 1] + bias.y;
          const float v2 = acc[4 * j + 2] + bias.x, v3 = acc[4 * j + 3] + bias.y;
          if (STORE) {
            const uint32_t at = patch + g * PATCH_LD_BYTES + (8 * jj + 2 * t4) * 2;
            st_shared_u32(at, pack_bf16x2(v0, v1));
            st_shared_u32(at + 8 * PATCH_LD_BYTES, pack_bf16x2(v2, v3));
          }
          if (full) {
            m[2 * j] = fmaxf(v0, v2);
            m[2 * j + 1] = fmaxf(v1, v3);
          } else {
            m[2 * j] = fmaxf(ok_a ? v0 : -CUDART_INF_F, ok_b ? v2 : -CUDART_INF_F);
            m[2 * j + 1] = fmaxf(ok_a ? v1 : -CUDART_INF_F, ok_b ? v3 : -CUDART_INF_F);
          }
        }
        if (STORE) {
          __syncwarp();
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = (lane >> 3) + 4 * i, chunk = lane & 7;
            const uint4 v = ld_shared_u128(patch + row * PATCH_LD_BYTES + chunk * 16);
            const int p = p0 + warp * 16 + row;
            if (p < P)
              *reinterpret_cast<uint4*>(xout + (static_cast<size_t>(b) * P + p) * H + 64 * q +
                                        8 * chunk) = v;
          }
          __syncwarp();
        }
      }
      // Max over the eight lanes that share t4, as a butterfly: each step a
      // lane gives away the half of its channel groups that its partner
      // keeps, so 56 shuffles do for 64 values, and the lane ends with the
      // groups own_j .. own_j + 3.
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const bool up = g & 1;
        const float give = up ? m[i] : m[i + 32], stay = up ? m[i + 32] : m[i];
        m[i] = fmaxf(stay, __shfl_xor_sync(0xffffffffu, give, 4));
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const bool up = (g >> 1) & 1;
        const float give = up ? m[i] : m[i + 16], stay = up ? m[i + 16] : m[i];
        m[i] = fmaxf(stay, __shfl_xor_sync(0xffffffffu, give, 8));
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const bool up = g >> 2;
        const float give = up ? m[i] : m[i + 8], stay = up ? m[i + 8] : m[i];
        run[i] = fmaxf(run[i], fmaxf(stay, __shfl_xor_sync(0xffffffffu, give, 16)));
      }
    }
  }
  flush();
}

// pool[b] = decoded max; with wctx given, also the next stage's
// pooled-context rows (matmul inputs rounded to bf16, f32 sums):
// rpool = relu(pool) @ W0b + b0, the hidden layer's bias of the cloud, and
// obias = b1 + pool @ Wsb, its output's. wctx is [2][H k][H h] bf16, the
// pooled halves of W0 and Ws transposed. One block per cloud, one thread per
// channel.
__global__ void __launch_bounds__(H) context_kernel(
    const int* __restrict__ pool_enc, const bf16* __restrict__ wctx,
    const float* __restrict__ b0, const float* __restrict__ b1,
    float* __restrict__ pool, float* __restrict__ rpool,
    float* __restrict__ obias) {
  __shared__ float relu_pool[H], pool_bf[H];
  const int b = blockIdx.x, h = threadIdx.x;
  const float m = order_decode(pool_enc[static_cast<size_t>(b) * H + h]);
  if (pool) pool[static_cast<size_t>(b) * H + h] = m;
  if (wctx == nullptr) return;  // the last stage needs no context
  pool_bf[h] = __bfloat162float(__float2bfloat16_rn(m));
  relu_pool[h] = __bfloat162float(__float2bfloat16_rn(fmaxf(m, 0.f)));
  __syncthreads();
  const bf16* w0b = wctx + h;
  const bf16* wsb = wctx + H * H + h;
  float r = 0.f, s = 0.f;
#pragma unroll 16  // the loads of 16 steps in flight; the sums stay in order
  for (int k = 0; k < H; ++k) {
    r += relu_pool[k] * __bfloat162float(w0b[k * H]);
    s += pool_bf[k] * __bfloat162float(wsb[k * H]);
  }
  rpool[static_cast<size_t>(b) * H + h] = r + b0[h];
  obias[static_cast<size_t>(b) * H + h] = b1[h] + s;
}

// cuTensorMapEncodeTiled, looked up through the runtime (no link against
// libcuda); null if the installed CUDA has none.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess || found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The map of the activations x [rows, H] bf16 for the producer's loads: a
// box is one panel of a tile, [TP rows][64 channels], laid down with the
// 128-byte swizzle; rows past the end read as zeros.
int activation_map(CUtensorMap* map, const void* x, long long rows) {
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {H, static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {H * sizeof(bf16)};
  const cuuint32_t box[2] = {KS, TP}, elem[2] = {1, 1};
  const CUresult r = encode_tiled()(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), dims, strides, box,
      elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <bool STAGE0, bool STORE>
int launch_stage(const void* pts, const void* xin, const void* wsl,
                 const void* wpos, const void* hbias, int hbias_stride,
                 const void* obias, int obias_stride, void* xout,
                 void* pool_enc, int B, int P, int n_sm, void* stream) {
  const auto kernel = stage_kernel<STAGE0, STORE>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n_tiles = static_cast<long long>(B) * ((P + TP - 1) / TP);
  if (n_tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(n_tiles < n_sm ? n_tiles : n_sm);
  CUtensorMap xmap = {};
  if (!STAGE0) {
    const int code = activation_map(&xmap, xin, static_cast<long long>(B) * P);
    if (code != 0) return code;
  }
  kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(pts), xmap,
      static_cast<const bf16*>(wsl), static_cast<const float4*>(wpos),
      static_cast<const float*>(hbias), hbias_stride,
      static_cast<const float*>(obias), obias_stride,
      static_cast<bf16*>(xout), static_cast<int*>(pool_enc), B, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int k1_tile_points() { return TP; }
int k1_hidden() { return H; }
int k1_slice_k() { return KS; }
const char* k1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Stage 0. pts [B, P, 3] bf16; wsl: 20 slices; wpos [2H] float4
// (w0, w1, w2, bias); b00, b01 [H] f32; xout [B, P, H] bf16; pool_enc [B, H]
// int32 holding the encoding of -inf.
int k1_stage0(const void* pts, const void* wsl, const void* wpos,
              const void* b00, const void* b01, void* xout, void* pool_enc,
              int B, int P, int n_sm, void* stream) {
  return launch_stage<true, true>(pts, nullptr, wsl, wpos, b00, 0, b01, 0,
                                  xout, pool_enc, B, P, n_sm, stream);
}

// Stages 1-3. xin [B, P, H] bf16; wsl: 12 slices; rpool, obias [B, H] f32
// from k1_context; xout [B, P, H] bf16, or null to write no activations
// (the last stage).
int k1_stage(const void* xin, const void* wsl, const void* rpool,
             const void* obias, void* xout, void* pool_enc, int B, int P,
             int n_sm, void* stream) {
  if (xout)
    return launch_stage<false, true>(nullptr, xin, wsl, nullptr, rpool, H, obias,
                                     H, xout, pool_enc, B, P, n_sm, stream);
  return launch_stage<false, false>(nullptr, xin, wsl, nullptr, rpool, H, obias,
                                    H, nullptr, pool_enc, B, P, n_sm, stream);
}

// pool_enc [B, H] -> pool [B, H] f32 (if given) and, with wctx, the next
// stage's rpool and obias (b0, b1: that block's fc_0 and fc_1 biases).
int k1_context(const void* pool_enc, const void* wctx, const void* b0,
               const void* b1, void* pool, void* rpool, void* obias, int B,
               void* stream) {
  context_kernel<<<B, H, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pool_enc), static_cast<const bf16*>(wctx),
      static_cast<const float*>(b0), static_cast<const float*>(b1),
      static_cast<float*>(pool), static_cast<float*>(rpool),
      static_cast<float*>(obias));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
