// An empty kernel: the time of launching it back to back is the floor
// under any kernel's time on this card and its CUDA runtime. The matcher's
// and the SPD solve's bounds from bytes and operations lie far below one
// launch, so this floor is the yardstick their times are held against.
// Measurement only: nothing on the tracker's path calls it.

#include <cuda_runtime.h>

namespace {

__global__ void launch_floor_kernel() {}

}  // namespace

extern "C" {

// Launch on `stream`; returns the CUDA error code (0 = success).
int launch_floor(void* stream) {
    launch_floor_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
    return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
