// Fused windowed Hamming matcher with duplicate-target claim keys.
//
// Replaces the Pallas TPU kernel `fused_window_match`
// (orb_slam2_ssd_semantic_tpu/ops/pallas_match.py, body
// `_window_match_kernel`). Per query q, over all targets t:
//   d(q,t) = popcount(desc_q[q] ^ desc_t[t])   if |du|,|dv| <= r[q] and
//            both valid, else BIG (1024)
//   best[q] = min_t d, idx[q] = first argmin, second[q] = min over t != idx
//   (BIG when empty), and per target
//   key_min[t] = min over {q : idx[q] == t, best[q] <= max_dist} of
//                best[q] * 2^20 + q        (BIG * 2^20 when unclaimed).
//
// Design: one thread per query, 256 queries per block. Targets (descriptor
// words, positions, validity) are staged through shared memory in chunks
// of TCHUNK (41 KB at 1024, under the 48 KB static limit); every thread of
// a warp reads the same target word at once (a broadcast, no bank
// conflict). The running top-2 walks targets in ascending order: a new
// value replaces `best` only when strictly smaller, else may lower
// `second`, which reproduces "first argmin" and "min over columns other
// than idx", ties included. Masked pairs still compete with d = BIG, so an
// all-masked row gives idx = 0, second = BIG, as in the TPU kernel.
// The TPU kernel's output block revisited across its sequential grid
// becomes one atomicMin per claiming query on a global int32 array that
// the wrapper fills with BIG * 2^20 first; a min is order-free, so the
// result is deterministic.
//
// Bound on the card: operations — Q*T pairs of 8 XOR+popcount plus the
// window test, all on the integer/FP32 pipes; the bytes moved are a few
// hundred KB. This first version keeps one query per thread (8 blocks at
// Q = 2048: most of the card's 132 SMs idle).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1024;
constexpr int kQStride = 1 << 20;
constexpr int kBigKey = kBig * kQStride;
constexpr int kThreads = 256;
constexpr int kChunk = 1024;

__global__ void __launch_bounds__(kThreads)
window_match_kernel(const uint32_t* __restrict__ desc_q, const uint32_t* __restrict__ desc_t,
                    const float* __restrict__ centers, const float* __restrict__ uv_t,
                    const float* __restrict__ radius, const uint8_t* __restrict__ valid_q,
                    const uint8_t* __restrict__ valid_t, int n_q, int n_t, int max_dist,
                    int* __restrict__ best_out, int* __restrict__ second_out,
                    int* __restrict__ idx_out, int* __restrict__ key_min) {
    __shared__ uint32_t s_desc[8][kChunk];
    __shared__ float s_u[kChunk];
    __shared__ float s_v[kChunk];
    __shared__ uint8_t s_valid[kChunk];

    const int q = blockIdx.x * kThreads + threadIdx.x;
    const bool active = q < n_q;
    uint32_t dq[8];
    float cu = 0.f, cv = 0.f, r = -1.f;
    bool vq = false;
    if (active) {
#pragma unroll
        for (int w = 0; w < 8; ++w) dq[w] = desc_q[q * 8 + w];
        cu = centers[q * 2];
        cv = centers[q * 2 + 1];
        r = radius[q];
        vq = valid_q[q] != 0;
    }

    int best = 0x7fffffff, second = 0x7fffffff, idx = 0;
    for (int t0 = 0; t0 < n_t; t0 += kChunk) {
        const int n = min(kChunk, n_t - t0);
        __syncthreads();
        for (int i = threadIdx.x; i < n; i += kThreads) {
            const int t = t0 + i;
#pragma unroll
            for (int w = 0; w < 8; ++w) s_desc[w][i] = desc_t[t * 8 + w];
            s_u[i] = uv_t[t * 2];
            s_v[i] = uv_t[t * 2 + 1];
            s_valid[i] = valid_t[t];
        }
        __syncthreads();
        if (!active) continue;
        for (int i = 0; i < n; ++i) {
            const bool in = vq && s_valid[i] && fabsf(s_u[i] - cu) <= r && fabsf(s_v[i] - cv) <= r;
            int d = kBig;
            if (in) {
                d = 0;
#pragma unroll
                for (int w = 0; w < 8; ++w) d += __popc(dq[w] ^ s_desc[w][i]);
            }
            if (d < best) {
                second = best;
                best = d;
                idx = t0 + i;
            } else if (d < second) {
                second = d;
            }
        }
    }
    if (!active) return;
    best_out[q] = best;
    second_out[q] = min(second, kBig);
    idx_out[q] = idx;
    if (best <= max_dist) atomicMin(&key_min[idx], best * kQStride + q);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 = success).
int window_match(const void* desc_q, const void* desc_t, const void* centers, const void* uv_t,
                 const void* radius, const void* valid_q, const void* valid_t, int n_q, int n_t,
                 int max_dist, void* best, void* second, void* idx, void* key_min, void* stream) {
    const int blocks = (n_q + kThreads - 1) / kThreads;
    window_match_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(desc_q), static_cast<const uint32_t*>(desc_t),
        static_cast<const float*>(centers), static_cast<const float*>(uv_t),
        static_cast<const float*>(radius), static_cast<const uint8_t*>(valid_q),
        static_cast<const uint8_t*>(valid_t), n_q, n_t, max_dist, static_cast<int*>(best),
        static_cast<int*>(second), static_cast<int*>(idx), static_cast<int*>(key_min));
    return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
