// The GCN denoiser's graph-convolution epilogue for Hopper (sm_90a):
// everything `nn/gcn.py` does to a graph convolution after its two weight
// products, in one pass over the activations.
//
// Replaces no TPU kernel: on the JAX side XLA fuses the modulation, the
// adjacency mix, the bias, BatchNorm, ReLU and the residual add into the
// products' neighbours; eager PyTorch ran them as some thirty separate
// elementwise and layout kernels a convolution (`modulated_gconv_mix`,
// `batchnorm_eval`, `torch.relu`, the residual add), each a pass over
// [rows, channels] in bf16.
//
// For batch element n, joint j and channel d, with h0 = x @ W[0] and
// h1 = x @ W[1] (bf16, [N, 24, D], joints' rows `ld0` and `ld1` apart):
//   z = a[j][j] * (M[j][d] * h0[n][j][d])
//       + sum_k off[j][k] * (M[k][d] * h1[n][k][d]) + bias[d]
//   out[n][j][d] = relu(scale[d] * z + shift[d]) (+ residual[n][j][d])
// or, with bn_relu = 0, out = z. `off` is the symmetrised adjacency with
// its diagonal zeroed, `a[j][j]` its diagonal (`diag`). Every operation is
// in f32 from the bf16 inputs, the sum over k in order; the output is
// rounded to bf16 once, at the store
// (`nn/gconv_epilogue.py:gconv_epilogue_reference` states the same
// arithmetic in PyTorch).
//
// What bounds it on this card: bytes. A call reads h0, h1 and the residual
// and writes the output, 2 x 24 x D bytes each per batch element: at
// N = 128, D = 1024, 25.2 MB, 7.5 us at 3.35 TB/s. Its 24 multiply-adds an
// output of the adjacency mix come to 0.15 GFLOP there, 2.3 us at the CUDA
// cores' 67 TFLOP/s; the instructions around them (loads, conversions,
// the epilogue) about double that.
//
// Design:
//   - A thread owns 2 channels of one batch element, for all 24 joints:
//     a warp reads each joint's row as one 128-byte line, 32-bit loads,
//     and every load of the thread is issued before the first product.
//   - M[k] * h1[n][k] (exact in f32) of all 24 joints stays in the
//     thread's registers, so the adjacency mix reads nothing from memory
//     but the 24 x 24 matrix, which sits in shared memory and is read with
//     one address across the block (a broadcast, 16 bytes for 8 products).
//     An earlier design, a thread per (joint, 8 channels) summing the
//     joints' column from shared memory, took 25 us at N = 128: its
//     shared-memory reads, not its bytes, were the bound.
//   - No intermediate leaves the registers; the output is stored once.
//   - Launched on the caller's stream with no host synchronisation, so it
//     records into a captured CUDA graph.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// kJoints and kVec are `nn/gconv_epilogue.py`'s JOINTS and VEC
constexpr int kJoints = 24;
constexpr int kVec = 2;        // channels a thread owns: one bf16 pair
constexpr int kThreads = 64;   // a block: 128 channels of one batch element

__device__ __forceinline__ __nv_bfloat162 ld2(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 f2(__nv_bfloat162 v) { return __bfloat1622float2(v); }

__global__ void __launch_bounds__(kThreads)
gconv_epilogue_kernel(const __nv_bfloat16* __restrict__ h0, long long ld0,
                      const __nv_bfloat16* __restrict__ h1, long long ld1,
                      const __nv_bfloat16* __restrict__ residual,
                      const float* __restrict__ diag, const float* __restrict__ off,
                      const __nv_bfloat16* __restrict__ m,
                      const __nv_bfloat16* __restrict__ vec,
                      __nv_bfloat16* __restrict__ out, int D, int bn_relu) {
  __shared__ float4 adj[kJoints][kJoints / 4];  // off[j][k], four k to a read
  __shared__ float dg[kJoints];
  float* a = reinterpret_cast<float*>(adj);
  for (int i = threadIdx.x; i < kJoints * kJoints; i += kThreads) a[i] = off[i];
  if (threadIdx.x < kJoints) dg[threadIdx.x] = diag[threadIdx.x];

  const int c = (blockIdx.y * kThreads + threadIdx.x) * kVec;
  const bool live = c < D;
  const long long n = blockIdx.x;
  const __nv_bfloat16* p0 = h0 + n * kJoints * ld0 + c;
  const __nv_bfloat16* p1 = h1 + n * kJoints * ld1 + c;
  // the thread's inputs as loaded, bf16 pairs: 24 registers a tensor
  __nv_bfloat162 h1k[kJoints], x0[kJoints], mj[kJoints], res[kJoints];
  float2 bias = make_float2(0.0f, 0.0f), scale = bias, shift = bias;
  if (live) {
#pragma unroll
    for (int k = 0; k < kJoints; ++k) {
      mj[k] = ld2(m + k * D + c);
      h1k[k] = ld2(p1 + k * ld1);
      x0[k] = ld2(p0 + k * ld0);
    }
    if (residual) {
#pragma unroll
      for (int k = 0; k < kJoints; ++k) res[k] = ld2(residual + (n * kJoints + k) * D + c);
    }
    bias = f2(ld2(vec + c));
    if (bn_relu) {
      scale = f2(ld2(vec + D + c));
      shift = f2(ld2(vec + 2 * D + c));
    }
  }
  __syncthreads();
  if (!live) return;
  float2 y[kJoints];  // M[k] * h1[n][k], exact in f32
#pragma unroll
  for (int k = 0; k < kJoints; ++k) {
    const float2 mk = f2(mj[k]), hk = f2(h1k[k]);
    y[k] = make_float2(mk.x * hk.x, mk.y * hk.y);
  }

#pragma unroll
  for (int j = 0; j < kJoints; ++j) {
    const float d = dg[j];
    const float2 mx = f2(mj[j]), xx = f2(x0[j]);
    float ax = d * (mx.x * xx.x), ay = d * (mx.y * xx.y);
#pragma unroll
    for (int q = 0; q < kJoints / 4; ++q) {
      const float4 w = adj[j][q];
      ax = fmaf(w.x, y[4 * q].x, ax);
      ay = fmaf(w.x, y[4 * q].y, ay);
      ax = fmaf(w.y, y[4 * q + 1].x, ax);
      ay = fmaf(w.y, y[4 * q + 1].y, ay);
      ax = fmaf(w.z, y[4 * q + 2].x, ax);
      ay = fmaf(w.z, y[4 * q + 2].y, ay);
      ax = fmaf(w.w, y[4 * q + 3].x, ax);
      ay = fmaf(w.w, y[4 * q + 3].y, ay);
    }
    ax += bias.x;
    ay += bias.y;
    if (bn_relu) {
      ax = fmaf(scale.x, ax, shift.x);
      ay = fmaf(scale.y, ay, shift.y);
      ax = ax < 0.0f ? 0.0f : ax;  // a NaN stays NaN, as torch.relu keeps it
      ay = ay < 0.0f ? 0.0f : ay;
    }
    if (residual) {
      const float2 r = f2(res[j]);
      ax += r.x;
      ay += r.y;
    }
    *reinterpret_cast<__nv_bfloat162*>(out + (n * kJoints + j) * D + c) =
        __floats2bfloat162_rn(ax, ay);
  }
}

}  // namespace

// h0, h1 [N, 24, D] bf16 with unit channel stride, joints' rows ld0 and ld1
// elements apart, a batch element 24 rows on; residual (or null) and out
// [N, 24, D] bf16 contiguous; diag [24] and off [24, 24] f32; m [24, D]
// bf16; vec [1 or 3, D] bf16: the bias, then with bn_relu BatchNorm's scale
// and shift. D, ld0 and ld1 even, every pointer 4-byte aligned. Launches on
// `stream`, does not synchronise, returns cudaGetLastError() (0 on success;
// cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int gconv_epilogue(const void* h0, long long ld0, const void* h1, long long ld1,
                              const void* residual, const void* diag, const void* off,
                              const void* m, const void* vec, void* out, int N, int D,
                              int bn_relu, void* stream) {
  if (N < 1 || D < kVec || D % kVec || ld0 % kVec || ld1 % kVec)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(N, (D + kVec * kThreads - 1) / (kVec * kThreads));
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  gconv_epilogue_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(h0), ld0, static_cast<const __nv_bfloat16*>(h1), ld1,
      static_cast<const __nv_bfloat16*>(residual), static_cast<const float*>(diag),
      static_cast<const float*>(off), static_cast<const __nv_bfloat16*>(m),
      static_cast<const __nv_bfloat16*>(vec), static_cast<__nv_bfloat16*>(out), D, bn_relu);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gconv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
