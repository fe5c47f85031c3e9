// Kernel K2: nearest body vertex for every scene point, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_nearest_kernel` of
// egohmr_tpu/collision/knn_pallas.py (launched by
// `nearest_vertex_idx_pallas`): for each point p of [B, P, 3] and the
// vertices v of its cloud [B, V, 3], the index of the vertex that minimises
// |v|^2 - 2 p.v (the squared distance without the per-point constant |p|^2),
// the lowest index on an exact tie. Only the index leaves the kernel; the
// caller recomputes the distance from the gathered vertex, so the kernel
// needs no backward.
//
// What bounds it on this card: operations, on the CUDA cores. A call reads
// 12 B per point and per vertex and writes 8 B per point (microseconds of
// HBM time) but evaluates B*P*V pairs. The contraction is over 3, so the
// tensor cores have nothing to multiply, and TF32 or bf16 products would
// move indices. The least a pair can cost is three FMAs.
//
// Design, around the dispatch cycles a pair costs:
//   - Three FMAs a pair. Vertices are staged in shared memory as
//     (-2x, -2y, -2z, |v|^2), the scaling by -2 being exact, so the distance
//     is one chain d = fma(pz, vz', fma(py, vy', fma(px, vx', w))).
//   - One min a pair. Over a block of kBlock consecutive vertices a thread
//     keeps only fminf of the distances. Once per block it compares the
//     block's min with its running best (strict <, blocks ascending), notes
//     the block, and keeps the second-best block min as a value. After the
//     scan the vertex inside the best block is found by recomputing that
//     block's distances, a warp a point, and taking the lowest index
//     whose distance equals the best bit for bit. No branch diverges in the
//     scan.
//   - Near-ties are decided in the plain version's arithmetic. The chain
//     rounds in another order than the plain version's
//     |v|^2 - 2 (px vx + py vy + pz vz). So where best and second-best block
//     min, or two distances inside the best block, lie within kTieTol of
//     each other (one point in thousands), the warp scans the point's
//     vertices again with that arithmetic (`plain_distance`) and takes the
//     least (distance, index). Everywhere else the margin is wider than
//     either rounding, so both pick the same vertex; exact ties go to the
//     lowest index on both routes.
//   - A thread owns PPT = 4 points, so one 16-byte shared-memory broadcast
//     serves four pairs. (Eight or sixteen points a thread were measured no
//     faster: the loads are not what holds the loop back. The min goes out at
//     half the FMA rate, so a pair costs five dispatch cycles, not four, and
//     the loop runs near 60% of the FMA peak at best.)
//   - V is split over blockIdx.z when B*P alone would leave the SMs empty
//     (the guided shapes: B*P = 65,536 or 16,384). Each split writes its
//     index and the plain-arithmetic distance of that vertex per point, and
//     `combine_kernel` takes the lexicographic min (smaller distance, then
//     lower split, which holds the lower indices).
//   - Raw vertices arrive by cp.async into a staging buffer while the
//     previous chunk is scanned; the CTA rewrites them as float4 once.
//   No tile of distances exists, V has no cap, ragged P and V are
//   bounds-checked (the tail of a chunk is padded with +inf distances).
//   The wrapper picks the split (collision/knn.py:launch_plan).
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int PPT = 4;        // points per thread
constexpr int kBlock = 32;    // vertices per min block: a warp rescans one, a lane a vertex
constexpr int kChunk = 1024;  // vertices per shared-memory chunk: 16 KB
// best and second-best block min closer than this, relative to |p|^2 + |best|
// (the size of the chain's intermediates), are a near-tie: 16 f32 epsilons,
// several times the rounding of either arithmetic
constexpr float kTieTol = 2e-6f;
#define kInf CUDART_INF_F

__device__ __forceinline__ float4 staged(float x, float y, float z) {
  // |v|^2 as the plain version sums it: (x*x + y*y) + z*z, unfused
  const float sq = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                             __fmul_rn(z, z));
  return make_float4(-2.0f * x, -2.0f * y, -2.0f * z, sq);
}

__device__ __forceinline__ float pair_distance(float px, float py, float pz,
                                               const float4& v) {
  return fmaf(pz, v.z, fmaf(py, v.y, fmaf(px, v.x, v.w)));
}

// the plain version's arithmetic on the staged vertex: -2 (px vx) is the
// rounded product scaled exactly, so this is fl(|v|^2 - 2 fl(p.v)) with the
// dot product summed x, y, z
__device__ __forceinline__ float plain_distance(float px, float py, float pz,
                                                const float4& v) {
  return __fadd_rn(v.w, fmaf(pz, v.z, fmaf(py, v.y, __fmul_rn(px, v.x))));
}

__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem));
}

// Grid (point blocks, B, splits). Split z scans vertices
// [z * split_len, min(V, (z + 1) * split_len)); split_len is a multiple of
// kBlock. With one split the index goes straight to `idx`; otherwise the
// split's best goes to part_d / part_i [splits][B * P].
__global__ void __launch_bounds__(kThreads)
nearest_vertex_kernel(const float* __restrict__ points,
                      const float* __restrict__ verts,
                      long long* __restrict__ idx, float* __restrict__ part_d,
                      int* __restrict__ part_i, int P, int V, int split_len) {
  __shared__ float raw[kChunk * 3];
  __shared__ float4 sv[kChunk];
  const int b = blockIdx.y;
  const int v_begin = blockIdx.z * split_len;
  const int v_end = min(V, v_begin + split_len);
  const float* vb = verts + static_cast<size_t>(b) * V * 3;
  const float* pb = points + static_cast<size_t>(b) * P * 3;

  float px[PPT], py[PPT], pz[PPT];
  float best[PPT], next[PPT];  // least and second-least block min so far
  int best_blk[PPT];           // first vertex of the block that holds the best
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    int p = (blockIdx.x * PPT + k) * kThreads + threadIdx.x;
    p = p < P ? p : P - 1;  // a thread past the end repeats the last point
    px[k] = pb[3 * p + 0];
    py[k] = pb[3 * p + 1];
    pz[k] = pb[3 * p + 2];
    best[k] = next[k] = kInf;
    best_blk[k] = v_begin;
  }

  auto fetch = [&](int base) {  // raw <- vertices [base, base + kChunk)
    const int n = 3 * min(kChunk, v_end - base);
    for (int i = threadIdx.x; i < n; i += kThreads)
      cp_async_4(raw + i, vb + 3 * static_cast<size_t>(base) + i);
    asm volatile("cp.async.commit_group;\n");
  };

  fetch(v_begin);
  for (int base = v_begin; base < v_end; base += kChunk) {
    const int n = min(kChunk, v_end - base);
    const int n_pad = (n + kBlock - 1) / kBlock * kBlock;
    asm volatile("cp.async.wait_all;\n");
    __syncthreads();  // raw has arrived; the previous chunk has been scanned
    for (int j = threadIdx.x; j < n_pad; j += kThreads)
      sv[j] = j < n ? staged(raw[3 * j], raw[3 * j + 1], raw[3 * j + 2])
                    : make_float4(0.f, 0.f, 0.f, kInf);
    __syncthreads();
    if (base + kChunk < v_end) fetch(base + kChunk);  // lands during the scan

    for (int j0 = 0; j0 < n_pad; j0 += kBlock) {
      float bmin[PPT];
#pragma unroll
      for (int j = 0; j < kBlock; ++j) {
        const float4 v = sv[j0 + j];
        float d[PPT];  // PPT independent chains, a step at a time
#pragma unroll
        for (int k = 0; k < PPT; ++k) d[k] = fmaf(px[k], v.x, v.w);
#pragma unroll
        for (int k = 0; k < PPT; ++k) d[k] = fmaf(py[k], v.y, d[k]);
#pragma unroll
        for (int k = 0; k < PPT; ++k) d[k] = fmaf(pz[k], v.z, d[k]);
#pragma unroll
        for (int k = 0; k < PPT; ++k) bmin[k] = j == 0 ? d[k] : fminf(bmin[k], d[k]);
      }
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        // strict: the first block wins a tie
        best_blk[k] = bmin[k] < best[k] ? base + j0 : best_blk[k];
        next[k] = fminf(next[k], fmaxf(best[k], bmin[k]));
        best[k] = fminf(best[k], bmin[k]);
      }
    }
  }

  // After the scan the warp works together, a point at a time: it recomputes
  // the distances of the point's best block, a lane a vertex. The lowest
  // vertex whose distance equals the best is the point's; another distance
  // within the tolerance marks a near-tie, as does the second-best block.
  const unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = (blockIdx.x * PPT + k) * kThreads + threadIdx.x;
    const float tol =
        kTieTol * (fmaf(px[k], px[k], fmaf(py[k], py[k], pz[k] * pz[k])) + fabsf(best[k]));
    int found = best_blk[k];
    bool near_tie = next[k] - best[k] <= tol;
#pragma unroll 8  // eight blocks' loads in flight at once
    for (int src = 0; src < 32; ++src) {
      const float sx = __shfl_sync(kAll, px[k], src), sy = __shfl_sync(kAll, py[k], src);
      const float sz = __shfl_sync(kAll, pz[k], src), sbest = __shfl_sync(kAll, best[k], src);
      const float stol = __shfl_sync(kAll, tol, src);
      const int j = __shfl_sync(kAll, best_blk[k], src) + lane;
      float d = kInf;
      if (j < v_end) {
        const float* v = vb + 3 * static_cast<size_t>(j);
        d = pair_distance(sx, sy, sz, staged(v[0], v[1], v[2]));
      }
      const unsigned eq = __ballot_sync(kAll, j < v_end && d == sbest);
      const unsigned nr = __ballot_sync(kAll, j < v_end && d != sbest && d - sbest <= stol);
      if (lane == src) {
        found = best_blk[k] + (eq ? __ffs(eq) - 1 : 0);
        near_tie = near_tie || nr != 0;
      }
    }

    // near-ties, rare: the warp scans the point's vertices in the plain
    // version's arithmetic, a lane every 32nd vertex, and takes the least
    // (distance, index)
    float d_plain = kInf;
    unsigned todo = __ballot_sync(kAll, near_tie && p < P);
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      const float sx = __shfl_sync(kAll, px[k], src), sy = __shfl_sync(kAll, py[k], src);
      const float sz = __shfl_sync(kAll, pz[k], src);
      float bd = kInf;
      int bj = v_end;
      for (int j = v_begin + lane; j < v_end; j += 32) {
        const float* v = vb + 3 * static_cast<size_t>(j);
        const float d = plain_distance(sx, sy, sz, staged(v[0], v[1], v[2]));
        if (d < bd) {  // strict, ascending: the lane's lowest index wins a tie
          bd = d;
          bj = j;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float od = __shfl_xor_sync(kAll, bd, off);
        const int oj = __shfl_xor_sync(kAll, bj, off);
        if (od < bd || (od == bd && oj < bj)) {
          bd = od;
          bj = oj;
        }
      }
      if (lane == src && bj < v_end) {
        found = bj;
        d_plain = bd;
      }
    }

    if (p >= P) continue;
    const size_t o = static_cast<size_t>(b) * P + p;
    if (gridDim.z == 1) {
      idx[o] = found;
    } else {
      if (d_plain == kInf) {
        const float* v = vb + 3 * static_cast<size_t>(found);
        d_plain = plain_distance(px[k], py[k], pz[k], staged(v[0], v[1], v[2]));
      }
      const size_t s = static_cast<size_t>(blockIdx.z) * gridDim.y * P + o;
      part_d[s] = d_plain;
      part_i[s] = found;
    }
  }
}

// idx[o] = the index of the lexicographically least (distance, split) over
// the splits' partial results.
__global__ void __launch_bounds__(256)
combine_kernel(const float* __restrict__ part_d, const int* __restrict__ part_i,
               long long* __restrict__ idx, int n, int splits) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n) return;
  float best = part_d[o];
  int found = part_i[o];
  for (int s = 1; s < splits; ++s) {
    const float d = part_d[static_cast<size_t>(s) * n + o];
    const int i = part_i[static_cast<size_t>(s) * n + o];
    const bool better = d < best;  // strict: the lower split wins a tie
    best = better ? d : best;
    found = better ? i : found;
  }
  idx[o] = found;
}

}  // namespace

extern "C" int k2_block_vertices() { return kBlock; }
extern "C" int k2_block_points() { return kThreads * PPT; }

// points [B, P, 3] f32, verts [B, V, 3] f32, idx [B, P] int64, all
// contiguous device pointers; split_len is a multiple of
// k2_block_vertices(); with more than one split, part_d (f32) and part_i
// (int32) hold [splits][B * P] each. Launches on `stream`, does not
// synchronise, returns cudaGetLastError() (0 on success; cudaErrorInvalidValue
// for a plan the kernel does not take).
extern "C" int k2_nearest_vertex(const void* points, const void* verts,
                                 void* idx, void* part_d, void* part_i, int B,
                                 int P, int V, int split_len, void* stream) {
  if (split_len < kBlock || split_len % kBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  const int splits = (V + split_len - 1) / split_len;
  if (splits > 65535 || (splits > 1 && (!part_d || !part_i)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((P + kThreads * PPT - 1) / (kThreads * PPT), B, splits);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  nearest_vertex_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(points), static_cast<const float*>(verts),
      static_cast<long long*>(idx), static_cast<float*>(part_d),
      static_cast<int*>(part_i), P, V, split_len);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const int n = B * P;
  combine_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part_d), static_cast<const int*>(part_i),
      static_cast<long long*>(idx), n, splits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* k2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
