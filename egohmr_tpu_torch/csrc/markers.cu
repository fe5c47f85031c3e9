// Phase markers: one empty kernel per phase of a stage-2 request, named
// for it, so that the device's timeline in a profiler trace shows where
// each phase begins, inside a replayed CUDA graph too
// (utils/profiling.py:mark). The phases follow utils/profiling.py:PHASES,
// then the marks inside a phase, utils/profiling.py:STEP_MARKS, named apart.
#include <cuda_runtime.h>

extern "C" {

__global__ void egohmr_phase_image() {}
__global__ void egohmr_phase_scene() {}
__global__ void egohmr_phase_sampler() {}
__global__ void egohmr_phase_smpl() {}
__global__ void egohmr_phase_end() {}
__global__ void egohmr_step_guide() {}
__global__ void egohmr_step_guide_end() {}

// Queue phase `phase`'s marker on `stream`; returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for a phase out of range.
int egohmr_mark(int phase, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (phase) {
    case 0: egohmr_phase_image<<<1, 1, 0, s>>>(); break;
    case 1: egohmr_phase_scene<<<1, 1, 0, s>>>(); break;
    case 2: egohmr_phase_sampler<<<1, 1, 0, s>>>(); break;
    case 3: egohmr_phase_smpl<<<1, 1, 0, s>>>(); break;
    case 4: egohmr_phase_end<<<1, 1, 0, s>>>(); break;
    case 5: egohmr_step_guide<<<1, 1, 0, s>>>(); break;
    case 6: egohmr_step_guide_end<<<1, 1, 0, s>>>(); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* egohmr_mark_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
