// Kernel K2: nearest body vertex for every scene point, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_nearest_kernel` of
// egohmr_tpu/collision/knn_pallas.py (launched by
// `nearest_vertex_idx_pallas`): for each point p of [B, P, 3] and the
// vertices v of its cloud [B, V, 3], the index of the vertex that minimises
// |v|^2 - 2 p.v (the squared distance without the per-point constant |p|^2).
// Only the index leaves the kernel; the caller recomputes the distance from
// the gathered vertex, so the kernel needs no backward.
//
// What bounds it on this card: operations. A call reads 12 B per point and
// per vertex and writes 8 B per point (under 7 MB at B=64, P=1024, V=6890:
// two microseconds of HBM time) but evaluates B*P*V pairs, each three FMAs
// for the dot product, one for the distance and a compare-and-select on
// the CUDA cores. The contraction is over 3, so the tensor cores have
// nothing to multiply.
//
// Design. The TPU kernel holds a [512, V] distance tile in VMEM and reduces
// it; here no tile exists at all. Each thread owns kPointsPerThread points
// and keeps their running (best distance, best index) in registers. The CTA
// walks its cloud's vertices in chunks of kChunk through shared memory as
// (x, y, z, |v|^2) float4s, so every vertex is read from device memory once
// per CTA and every shared-memory read is a 16-byte broadcast that serves
// all the thread's points. No transposes, no padding of V with sentinel
// vertices, no padding of P: ragged P and V are bounds-checked.
//
// Ties go to the lowest index, as `argmin` does: each thread scans the
// vertices in ascending order by itself and replaces its best only on a
// strict `<`, and no partial results are combined across threads.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPointsPerThread = 2;
constexpr int kPointsPerBlock = kThreads * kPointsPerThread;
constexpr int kChunk = 2048;  // vertices per shared-memory chunk: 32 KB

__global__ void __launch_bounds__(kThreads)
nearest_vertex_kernel(const float* __restrict__ points,
                      const float* __restrict__ verts,
                      long long* __restrict__ idx, int P, int V) {
  __shared__ float4 sv[kChunk];
  const int b = blockIdx.y;
  const float* vb = verts + static_cast<size_t>(b) * V * 3;
  const float* pb = points + static_cast<size_t>(b) * P * 3;

  float px[kPointsPerThread], py[kPointsPerThread], pz[kPointsPerThread];
  float best[kPointsPerThread];
  int best_i[kPointsPerThread];
#pragma unroll
  for (int k = 0; k < kPointsPerThread; ++k) {
    int p = blockIdx.x * kPointsPerBlock + k * kThreads + threadIdx.x;
    p = p < P ? p : P - 1;  // a thread past the end repeats the last point
    px[k] = pb[3 * p + 0];
    py[k] = pb[3 * p + 1];
    pz[k] = pb[3 * p + 2];
    best[k] = __int_as_float(0x7f800000);  // +inf
    best_i[k] = 0;
  }

  for (int base = 0; base < V; base += kChunk) {
    const int n = min(kChunk, V - base);
    __syncthreads();  // the previous chunk has been read by every thread
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const float x = vb[3 * (base + j) + 0];
      const float y = vb[3 * (base + j) + 1];
      const float z = vb[3 * (base + j) + 2];
      // |v|^2 as the plain version sums it: (x*x + y*y) + z*z, unfused
      const float sq = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                                 __fmul_rn(z, z));
      sv[j] = make_float4(x, y, z, sq);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float4 v = sv[j];
#pragma unroll
      for (int k = 0; k < kPointsPerThread; ++k) {
        const float dot = fmaf(pz[k], v.z, fmaf(py[k], v.y, px[k] * v.x));
        const float d = fmaf(-2.0f, dot, v.w);
        if (d < best[k]) {  // strict: the lowest index wins a tie
          best[k] = d;
          best_i[k] = base + j;
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kPointsPerThread; ++k) {
    const int p = blockIdx.x * kPointsPerBlock + k * kThreads + threadIdx.x;
    if (p < P) idx[static_cast<size_t>(b) * P + p] = best_i[k];
  }
}

}  // namespace

// points [B, P, 3] f32, verts [B, V, 3] f32, idx [B, P] int64, all
// contiguous device pointers. Launches on `stream`, does not synchronise,
// returns cudaGetLastError() (0 on success).
extern "C" int k2_nearest_vertex(const void* points, const void* verts,
                                 void* idx, int B, int P, int V,
                                 void* stream) {
  dim3 grid((P + kPointsPerBlock - 1) / kPointsPerBlock, B);
  nearest_vertex_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const float*>(verts),
      static_cast<long long*>(idx), P, V);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* k2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
