// ResNet's glue after each convolution in bf16 inference, for Hopper
// (sm_90a): eval BatchNorm, the residual add and ReLU in one pass over the
// convolution's output.
//
// Replaces no TPU kernel: on the JAX side XLA fuses BatchNorm's scale and
// shift, the residual add and ReLU into the convolution's neighbours.
// Eager PyTorch ran them as separate bf16 passes over the whole activation
// (`nn/core.py:batchnorm_eval`: a broadcast multiply, a broadcast add; then
// `torch.relu`; at a block's end the downsample branch's own BatchNorm, the
// add and one more ReLU), and folded each BatchNorm's statistics anew on
// every call.
//
// For row r of the convolution's output a, NHWC viewed as [rows, C]
// (rows = N x H x W), and channel c:
//   z = sa[c] * a[r][c] + ta[c]
//   form 1 (identity residual x):           z = z + x[r][c]
//   form 2 (downsample branch b, its BN):   z = z + (sb[c] * b[r][c] + tb[c])
//   a[r][c] = relu(z), in place
// sa, ta (sb, tb) are BatchNorm's scale and shift folded and cast to bf16
// as `batchnorm_eval_fold` does. Every product and sum is f32 from the bf16
// inputs, each rounded as written (no fused multiply-add), and the output
// is rounded to bf16 once, at the store:
// `nn/resnet_epilogue.py:resnet_epilogue_reference` states the same
// arithmetic in PyTorch, and the kernel equals it bit for bit. Every pass of
// ResNet applies ReLU at its end (the stem, the inner convolutions and each
// block's output), so the kernel always does.
//
// What bounds it on this card: bytes. A pass reads a (and x or b) and
// writes a, 2 bytes an element each, with no reuse; its 2-5 operations an
// element are nothing beside them. ResNet-50's 49 passes at B = 64 read
// 1.94 GB and write 1.23 GB: 0.95 ms at 3.35 TB/s.
//
// Design:
//   - A thread owns 8 channels, one 16-byte load or store a tensor a row,
//     of every `step`-th row. Its channels' constants are loaded once and
//     stay in registers, as bf16 pairs (4 registers a vector), across a
//     loop over its rows.
//   - Each turn of the loop loads two rows of every input before the first
//     operation, so that a thread has two or four 16-byte loads in flight.
//   - The host sizes the grid to the card: `step` rows' worth of threads, at
//     most 2,048 a multiprocessor over all of them, so that every SM holds
//     a full complement of threads while there are rows for them.
//   - It writes in place: a thread reads each element it writes before it
//     writes it, and no thread reads another's. The convolution's output is
//     a temporary of the forward, so no second buffer is allocated.
//   - Launched on the caller's stream with no host synchronisation, so it
//     records into a captured CUDA graph.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kVec = 8;         // channels a thread owns (`nn/resnet_epilogue.py`'s VEC)
constexpr int kThreads = 256;   // a block
constexpr int kThreadsPerSM = 2048;

__device__ __forceinline__ float lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

__device__ __forceinline__ float affine(uint32_t s, uint32_t x, uint32_t t, bool upper) {
  return upper ? __fadd_rn(__fmul_rn(hi(s), hi(x)), hi(t))
               : __fadd_rn(__fmul_rn(lo(s), lo(x)), lo(t));
}

// one bf16 pair of the output from one 32-bit word of each input
template <int kForm>
__device__ __forceinline__ uint32_t pair(uint32_t a, uint32_t sa, uint32_t ta, uint32_t r,
                                         uint32_t sr, uint32_t tr) {
  float z0 = affine(sa, a, ta, false), z1 = affine(sa, a, ta, true);
  if (kForm == 1) {
    z0 = __fadd_rn(z0, lo(r));
    z1 = __fadd_rn(z1, hi(r));
  } else if (kForm == 2) {
    z0 = __fadd_rn(z0, affine(sr, r, tr, false));
    z1 = __fadd_rn(z1, affine(sr, r, tr, true));
  }
  z0 = z0 < 0.0f ? 0.0f : z0;  // a NaN stays NaN, as torch.relu keeps it
  z1 = z1 < 0.0f ? 0.0f : z1;
  const __nv_bfloat162 o = __floats2bfloat162_rn(z0, z1);
  return *reinterpret_cast<const uint32_t*>(&o);
}

template <int kForm>
__device__ __forceinline__ uint4 row(const uint4& a, const uint4& sa, const uint4& ta,
                                     const uint4& r, const uint4& sr, const uint4& tr) {
  return make_uint4(pair<kForm>(a.x, sa.x, ta.x, r.x, sr.x, tr.x),
                    pair<kForm>(a.y, sa.y, ta.y, r.y, sr.y, tr.y),
                    pair<kForm>(a.z, sa.z, ta.z, r.z, sr.z, tr.z),
                    pair<kForm>(a.w, sa.w, ta.w, r.w, sr.w, tr.w));
}

__device__ __forceinline__ uint4 ld(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// a, r [rows, C]; vec_a, vec_r [2, C]: scale, then shift
template <int kForm>
__global__ void __launch_bounds__(kThreads)
resnet_epilogue_kernel(__nv_bfloat16* a, const __nv_bfloat16* __restrict__ vec_a,
                       const __nv_bfloat16* __restrict__ r,
                       const __nv_bfloat16* __restrict__ vec_r, long long rows, int C,
                       long long step) {
  const int groups = C / kVec;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int c = static_cast<int>(t % groups) * kVec;
  long long i = t / groups;
  if (i >= step) return;
  const uint4 sa = ld(vec_a + c), ta = ld(vec_a + C + c);
  uint4 sr = make_uint4(0, 0, 0, 0), tr = sr;
  if (kForm == 2) {
    sr = ld(vec_r + c);
    tr = ld(vec_r + C + c);
  }
  for (; i < rows; i += 2 * step) {
    const long long p0 = i * C + c, p1 = (i + step) * C + c;
    const bool second = i + step < rows;
    uint4 a0 = ld(a + p0), a1 = a0, r0 = sr, r1 = sr;
    if (second) a1 = ld(a + p1);
    if (kForm != 0) {
      r0 = ld(r + p0);
      if (second) r1 = ld(r + p1);
    }
    *reinterpret_cast<uint4*>(a + p0) = row<kForm>(a0, sa, ta, r0, sr, tr);
    if (second) *reinterpret_cast<uint4*>(a + p1) = row<kForm>(a1, sa, ta, r1, sr, tr);
  }
}

}  // namespace

// a: [rows, C] bf16, rows C elements apart (NHWC), read and written; r:
// null (form 0) or [rows, C] bf16 (form 1: added as it is; form 2: through
// vec_r), not overlapping a; vec_a, vec_r (form 2 only): [2, C] bf16,
// BatchNorm's folded scale then shift. C a multiple of 8, every pointer
// 16-byte aligned. `sms`: the card's multiprocessors. Launches on `stream`, does not synchronise,
// returns cudaGetLastError() (0 on success; cudaErrorInvalidValue for a
// shape or form the kernel does not take, cudaErrorMisalignedAddress for a
// pointer it cannot read 16 bytes at a time).
extern "C" int resnet_epilogue(void* a, const void* vec_a, const void* r, const void* vec_r,
                               long long rows, int C, int form, int sms, void* stream) {
  if (rows < 1 || C < kVec || C % kVec || sms < 1 || form < 0 || form > 2
      || (form != 0 && !r) || (form == 2 && !vec_r))
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : {static_cast<const void*>(a), vec_a, r, vec_r})
    if (reinterpret_cast<uintptr_t>(p) % 16) return static_cast<int>(cudaErrorMisalignedAddress);
  const long long groups = C / kVec;
  // rows a turn of the grid covers: two rows a thread, at most a full card of threads
  long long step = (rows + 1) / 2;
  const long long most = static_cast<long long>(sms) * kThreadsPerSM / groups;
  if (step > most) step = most > 0 ? most : 1;
  const long long blocks = (groups * step + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  auto* pa = static_cast<__nv_bfloat16*>(a);
  const auto* va = static_cast<const __nv_bfloat16*>(vec_a);
  const auto* pr = static_cast<const __nv_bfloat16*>(r);
  const auto* vr = static_cast<const __nv_bfloat16*>(vec_r);
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (form == 0)
    resnet_epilogue_kernel<0><<<grid, kThreads, 0, s>>>(pa, va, pr, vr, rows, C, step);
  else if (form == 1)
    resnet_epilogue_kernel<1><<<grid, kThreads, 0, s>>>(pa, va, pr, vr, rows, C, step);
  else
    resnet_epilogue_kernel<2><<<grid, kThreads, 0, s>>>(pa, va, pr, vr, rows, C, step);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* resnet_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
