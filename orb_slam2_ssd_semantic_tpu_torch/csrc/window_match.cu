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
// Bound on the card: operations in name (Q*T window tests, popcounts for
// the few per cent of pairs inside a window; a few hundred KB moved), in
// fact latency: the whole problem is a few microseconds of work for one
// SM, so what counts is how many SMs share it and how short each
// thread's serial walk is.
//
// Design: two kernels on one stream.
//  1. `window_match_partial_kernel`, a 2-D grid of query tiles x target
//     splits (128 queries x 64 targets at the tracker's shapes, one to
//     two blocks per SM; the wrapper picks the split). A block stages its split's targets in shared
//     memory once: the descriptor as two uint4, and (u, v) as one float2
//     whose u is NaN for an invalid target, so that "valid and inside the
//     window" is two compares on one 8-byte load (a compare with NaN is
//     false; an invalid query gets a NaN radius the same way). One thread
//     per query walks the split in groups of 32 targets: first the window
//     tests alone, branch-free, four targets to two 16-byte shared loads
//     that every lane of the warp reads at the same address (a
//     broadcast), into a 32-bit mask; then the Hamming distance of the
//     mask's set bits only, in ascending order. A pair in a hundred lies
//     inside a window, but some lane of a warp has one in most groups, so
//     a branch around the popcounts would be taken by nearly every warp;
//     the mask keeps the common path short and the rare one as long as
//     the busiest lane's few hits. The running top-2 starts at
//     (best, idx, second) = (BIG, first target of the split, BIG), which
//     is what masked pairs competing at BIG would leave behind, and takes
//     a new value as best only when strictly smaller, else as second when
//     smaller. The block writes (best | second << 16, idx) per query and
//     split to scratch; the first row of blocks also resets `key_min`.
//  2. `window_match_merge_kernel`, one thread per query, folds the splits
//     in ascending order with the same strict-less rule: a split's best
//     replaces the running best only when strictly smaller (then
//     second = min(old best, that split's second)), otherwise it may
//     lower second. That keeps the TPU kernel's tie rules: first argmin
//     is the lowest target index; second is the minimum over columns
//     other than idx (equal to best when two targets tie); an all-masked
//     row gives idx 0, best = second = BIG. It then writes the outputs
//     and makes the claim with one atomicMin per claiming query; a min is
//     order-free, so the result is deterministic. The TPU kernel carried
//     that minimum in an output block revisited by its sequential grid.
// A second kernel rather than "last block done merges": the counter that
// scheme needs would take a launch of its own to zero for every call.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1024;
constexpr int kQStride = 1 << 20;
constexpr int kBigKey = kBig * kQStride;
constexpr int kChunk = 128;    // targets staged in shared memory at a time
constexpr int kTile = 128;     // queries (threads) of a block
constexpr int kMergeThreads = 64;

__device__ __forceinline__ bool in_window(float u, float v, float cu, float cv, float r) {
    return fabsf(u - cu) <= r && fabsf(v - cv) <= r;
}

__global__ void __launch_bounds__(kTile)
window_match_partial_kernel(const uint4* __restrict__ desc_q, const uint4* __restrict__ desc_t,
                            const float2* __restrict__ centers, const float2* __restrict__ uv_t,
                            const float* __restrict__ radius, int radius_stride,
                            const uint8_t* __restrict__ valid_q,
                            const uint8_t* __restrict__ valid_t, int n_q, int n_t, int split_len,
                            int2* __restrict__ part, int* __restrict__ key_min) {
    __shared__ uint4 s_lo[kChunk];
    __shared__ uint4 s_hi[kChunk];
    __shared__ float4 s_pos[kChunk / 2];  // (u, v) of two targets each

    const int t_begin = blockIdx.y * split_len;
    const int t_end = min(n_t, t_begin + split_len);
    const int q = blockIdx.x * blockDim.x + threadIdx.x;
    const bool active = q < n_q;

    if (blockIdx.x == 0)
        for (int t = t_begin + threadIdx.x; t < t_end; t += blockDim.x) key_min[t] = kBigKey;

    uint4 q_lo = make_uint4(0, 0, 0, 0), q_hi = q_lo;
    float cu = 0.f, cv = 0.f, r = CUDART_NAN_F;
    if (active) {
        q_lo = desc_q[2 * q];
        q_hi = desc_q[2 * q + 1];
        const float2 c = centers[q];
        cu = c.x;
        cv = c.y;
        if (valid_q[q]) r = radius[static_cast<size_t>(q) * radius_stride];
    }

    int best = kBig, second = kBig, idx = t_begin;
    float2* const s_pos2 = reinterpret_cast<float2*>(s_pos);
    for (int t0 = t_begin; t0 < t_end; t0 += kChunk) {
        const int n = min(kChunk, t_end - t0);
        const int n32 = (n + 31) & ~31;  // the walk below goes by groups of 32
        __syncthreads();
        for (int i = threadIdx.x; i < n32; i += blockDim.x) {
            float2 p = make_float2(CUDART_NAN_F, CUDART_NAN_F);
            if (i < n) {
                const int t = t0 + i;
                s_lo[i] = desc_t[2 * t];
                s_hi[i] = desc_t[2 * t + 1];
                p = uv_t[t];
                if (!valid_t[t]) p.x = CUDART_NAN_F;
            }
            s_pos2[i] = p;
        }
        __syncthreads();
        for (int g = 0; g < n32; g += 32) {
            // Window tests of 32 targets, branch-free, into one bit each.
            uint32_t mask = 0;
#pragma unroll
            for (int k = 0; k < 32; k += 4) {
                const float4 pa = s_pos[(g + k) / 2];
                const float4 pb = s_pos[(g + k) / 2 + 1];
                mask |= static_cast<uint32_t>(in_window(pa.x, pa.y, cu, cv, r)) << k;
                mask |= static_cast<uint32_t>(in_window(pa.z, pa.w, cu, cv, r)) << (k + 1);
                mask |= static_cast<uint32_t>(in_window(pb.x, pb.y, cu, cv, r)) << (k + 2);
                mask |= static_cast<uint32_t>(in_window(pb.z, pb.w, cu, cv, r)) << (k + 3);
            }
            // Hamming distances of the few targets inside, in ascending order.
            while (mask != 0) {
                const int i = g + __ffs(mask) - 1;
                mask &= mask - 1;
                const uint4 lo = s_lo[i];
                const uint4 hi = s_hi[i];
                const int d = __popc(q_lo.x ^ lo.x) + __popc(q_lo.y ^ lo.y) +
                              __popc(q_lo.z ^ lo.z) + __popc(q_lo.w ^ lo.w) +
                              __popc(q_hi.x ^ hi.x) + __popc(q_hi.y ^ hi.y) +
                              __popc(q_hi.z ^ hi.z) + __popc(q_hi.w ^ hi.w);
                if (d < best) {
                    second = best;
                    best = d;
                    idx = t0 + i;
                } else if (d < second) {
                    second = d;
                }
            }
        }
    }
    if (active)
        part[static_cast<size_t>(blockIdx.y) * n_q + q] = make_int2(best | (second << 16), idx);
}

__global__ void __launch_bounds__(kMergeThreads)
window_match_merge_kernel(const int2* __restrict__ part, int n_q, int n_splits, int max_dist,
                          int* __restrict__ best_out, int* __restrict__ second_out,
                          int* __restrict__ idx_out, int* __restrict__ key_min) {
    const int q = blockIdx.x * blockDim.x + threadIdx.x;
    if (q >= n_q) return;
    const int2 first = part[q];
    int best = first.x & 0xffff, second = first.x >> 16, idx = first.y;
    // Every split is loaded whatever the running state is, so the loads of
    // several splits are in flight at once.
#pragma unroll 8
    for (int s = 1; s < n_splits; ++s) {
        const int2 p = part[static_cast<size_t>(s) * n_q + q];
        const int b = p.x & 0xffff;
        const bool wins = b < best;
        second = wins ? min(best, p.x >> 16) : min(second, b);
        idx = wins ? p.y : idx;
        best = min(best, b);
    }
    best_out[q] = best;
    second_out[q] = second;
    idx_out[q] = idx;
    if (best <= max_dist) atomicMin(&key_min[idx], best * kQStride + q);
}

}  // namespace

extern "C" {

// Launch both kernels on `stream`. `radius` holds one value
// (radius_stride 0) or one per query (their stride in elements). A block
// of the first kernel takes 128 queries and `split_len` targets; `part` is
// scratch of 2 * ceil(n_t / split_len) * n_q int32, 8-byte aligned.
// Descriptors must be 16-byte aligned, positions 8-byte aligned.
// Returns the CUDA error code (0 = success).
int window_match(const void* desc_q, const void* desc_t, const void* centers, const void* uv_t,
                 const void* radius, int radius_stride, const void* valid_q, const void* valid_t,
                 int n_q, int n_t, int max_dist, int split_len, void* part,
                 void* best, void* second, void* idx, void* key_min, void* stream) {
    if (n_q <= 0 || n_t <= 0 || split_len <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int n_splits = (n_t + split_len - 1) / split_len;
    if (n_splits > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    int2* const parts = static_cast<int2*>(part);
    const dim3 grid((n_q + kTile - 1) / kTile, n_splits);
    window_match_partial_kernel<<<grid, kTile, 0, s>>>(
        static_cast<const uint4*>(desc_q), static_cast<const uint4*>(desc_t),
        static_cast<const float2*>(centers), static_cast<const float2*>(uv_t),
        static_cast<const float*>(radius), radius_stride, static_cast<const uint8_t*>(valid_q),
        static_cast<const uint8_t*>(valid_t), n_q, n_t, split_len, parts,
        static_cast<int*>(key_min));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    window_match_merge_kernel<<<(n_q + kMergeThreads - 1) / kMergeThreads, kMergeThreads, 0, s>>>(
        parts, n_q, n_splits, max_dist, static_cast<int*>(best), static_cast<int*>(second),
        static_cast<int*>(idx), static_cast<int*>(key_min));
    return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
