// Pivot-free Gauss-Jordan solve of a small damped SPD system A x = b.
//
// Replaces the Pallas TPU kernel `spd_solve`
// (orb_slam2_ssd_semantic_tpu/ops/pallas_solve.py, body `_gj_kernel`):
// the reduced camera system of local BA, n = 6 * (window + anchors) <= 128,
// padded to 128 with identity on the padded diagonal. No pivoting: the
// system is SPD with relative diagonal damping, so every elimination pivot
// is a positive Schur-complement diagonal (the argument that makes Cholesky
// pivot-free).
//
// Design: one block of 1024 threads. The padded 128 x 128 f32 matrix
// (64 KB) lives in dynamic shared memory for the whole solve; the
// right-hand side beside it. Step k reads the pivot column and the scaled
// pivot row into shared buffers, then every thread applies the rank-1
// update a[i][j] -= a[i][k] * (a[k][j] / a[k][k]) to its 16 elements and
// writes the scaled row in place of row k — the same per-element
// arithmetic as the TPU kernel, without its roll-systolic form (which
// exists only because Mosaic lacks dynamic slices). The padded rows are
// decoupled identity rows, so the loop stops after the n real pivots.
//
// Bound on the card: latency — n sequential steps of ~3 barriers each on
// one SM; the work (n * 128^2 multiply-adds) and the bytes (64 KB in,
// 512 B out) are tiny for the card.

#include <cuda_runtime.h>

namespace {

constexpr int kPad = 128;
constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
spd_solve_kernel(const float* __restrict__ a_in, const float* __restrict__ b_in, int n,
                 float* __restrict__ x_out) {
    extern __shared__ float a[];  // kPad * kPad, row-major
    __shared__ float b[kPad];
    __shared__ float col[kPad];
    __shared__ float prow[kPad];
    __shared__ float pb;
    const int tid = threadIdx.x;
    for (int e = tid; e < kPad * kPad; e += kThreads) a[e] = a_in[e];
    if (tid < kPad) b[tid] = b_in[tid];
    __syncthreads();
    for (int k = 0; k < n; ++k) {
        if (tid < kPad) {
            const float inv_p = 1.0f / a[k * kPad + k];
            col[tid] = a[tid * kPad + k];
            prow[tid] = a[k * kPad + tid] * inv_p;
            if (tid == 0) pb = b[k] * inv_p;
        }
        __syncthreads();
        for (int e = tid; e < kPad * kPad; e += kThreads) {
            const int i = e / kPad, j = e % kPad;
            a[e] = (i == k) ? prow[j] : a[e] - col[i] * prow[j];
        }
        if (tid < kPad) b[tid] = (tid == k) ? pb : b[tid] - col[tid] * pb;
        __syncthreads();
    }
    if (tid < kPad) x_out[tid] = b[tid];
}

}  // namespace

extern "C" {

// a: (128, 128) padded matrix, b: (128,), n: real size; x: (128,) output.
// Launch on `stream`; returns the CUDA error code (0 = success).
int spd_solve(const void* a, const void* b, int n, void* x, void* stream) {
    const int smem = kPad * kPad * static_cast<int>(sizeof(float));
    cudaError_t err = cudaFuncSetAttribute(spd_solve_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    spd_solve_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), n, static_cast<float*>(x));
    return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
