// Batched eigensolver for small symmetric float32 matrices: cyclic Jacobi.
//
// Replaces no Pallas TPU kernel. The JAX package takes the null vector of
// the homography's DLT system from `jnp.linalg.eigh`
// (orb_slam2_ssd_semantic_tpu/ops/homography.py:34), which XLA compiles
// into the flow mask's program with nothing on the host. PyTorch's
// `torch.linalg.eigh` on the card (cuSOLVER) checks its `info` on the host
// after every call, a stream synchronisation that also keeps the mask out
// of a CUDA graph. This kernel computes the same function without either:
// M (B, n, n), n <= 16, its lower triangle read -> eigenvalues (B, n)
// ascending and eigenvectors (B, n, n) as columns, the layout of
// `torch.linalg.eigh`.
//
// Bound on the card: latency. The flow mask calls it twice a frame, on the
// (128, 9, 9) minimal-set systems and on one (9, 9) refit: a few hundred
// KB and about a million flops, nothing for the card. What costs time is
// the chain of dependent rotations of one matrix: sweeps x rounds x
// (rotation, row pass, column pass), each step a warp-wide shared-memory
// round trip.
//
// Design: one warp per matrix, four matrices a block, the matrix and its
// accumulated rotations V in shared memory (rows padded to 17 floats).
// Each sweep is m - 1 rounds of the circle method over m = n rounded up to
// even indices (index m - 1 stays, the others rotate; an odd n makes the
// last index a dummy whose pairs are skipped): the m / 2 pairs of a round
// are disjoint, so their rotations commute and run at once. In a round,
// lane k computes the rotation of pair k (Golub and Van Loan's symmetric
// Schur step: tau = (a_qq - a_pp) / 2 a_pq, t = sign(tau) / (|tau| +
// sqrt(1 + tau^2)), c = 1 / sqrt(1 + t^2), s = t c), then the warp applies
// all of them to the rows (A <- J^T A), then to the columns of A and V
// (A <- A J, V <- V J), and lane k sets its pair's 2 x 2 block to the exact
// result (a_pp - t a_pq, a_qq + t a_pq, zeros off the diagonal). Each
// element is written by one lane in a pass, so a pass needs no atomics,
// only a __syncwarp after it. Before each sweep the warp reduces the
// squared off-diagonal and total Frobenius norms with a butterfly, which
// leaves the same bits in every lane, so the stop is warp-uniform: it stops
// when the off-diagonal part is below 1e-8 of the norm, or after 16 sweeps.
// Then lane i ranks eigenvalue i among the diagonal (NaN above everything,
// ties by index) and writes it and column i of V to that rank.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxN = 16;
constexpr int kLd = kMaxN + 1;
constexpr int kWarps = 4;  // matrices a block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSweeps = 16;
// Stop when the squared off-diagonal norm is below this share of the
// squared norm (1e-8 of the norm, under f32's epsilon).
constexpr float kTol = 1e-16f;

struct WarpSmem {
    float a[kMaxN][kLd];
    float v[kMaxN][kLd];
    float c[kMaxN / 2];
    float s[kMaxN / 2];
};

// Pair k of round r of the circle method over m (even) indices, as p < q.
__device__ __forceinline__ void round_pair(int m, int r, int k, int& p, int& q) {
    int a = r, b = m - 1;
    if (k > 0) {
        a = (r + k) % (m - 1);
        b = (r - k + m - 1) % (m - 1);
    }
    p = min(a, b);
    q = max(a, b);
}

__global__ void __launch_bounds__(kThreads)
sym_eig_kernel(const float* __restrict__ a_in, int batch, int n, float* __restrict__ w_out,
               float* __restrict__ v_out) {
    __shared__ WarpSmem smem[kWarps];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int b = blockIdx.x * kWarps + warp;
    if (b >= batch) return;  // whole warps only
    WarpSmem& sm = smem[warp];
    const float* src = a_in + static_cast<size_t>(b) * n * n;

    for (int e = lane; e < n * n; e += 32) {
        const int i = e / n, j = e % n;
        sm.a[i][j] = i >= j ? src[i * n + j] : src[j * n + i];
        sm.v[i][j] = i == j ? 1.f : 0.f;
    }
    __syncwarp();

    const int m = n + (n & 1);
    const int half = m / 2;
    for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
        float off = 0.f, tot = 0.f;
        for (int e = lane; e < n * n; e += 32) {
            const int i = e / n, j = e % n;
            const float x = sm.a[i][j];
            tot = fmaf(x, x, tot);
            if (i != j) off = fmaf(x, x, off);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            off += __shfl_xor_sync(0xffffffffu, off, o);
            tot += __shfl_xor_sync(0xffffffffu, tot, o);
        }
        if (off <= kTol * tot) break;

        for (int r = 0; r < m - 1; ++r) {
            // The rotation of this lane's pair, and its 2 x 2 block after it.
            bool rotated = false;
            float dpp = 0.f, dqq = 0.f;
            int pp = 0, pq = 0;
            if (lane < half) {
                round_pair(m, r, lane, pp, pq);
                float c = 1.f, s = 0.f;
                if (pq < n) {
                    const float apq = sm.a[pp][pq];
                    if (apq != 0.f) {
                        const float app = sm.a[pp][pp], aqq = sm.a[pq][pq];
                        const float tau = (aqq - app) / (2.f * apq);
                        const float t = copysignf(1.f, tau) / (fabsf(tau) + hypotf(1.f, tau));
                        c = 1.f / sqrtf(fmaf(t, t, 1.f));
                        s = t * c;
                        dpp = app - t * apq;
                        dqq = aqq + t * apq;
                        rotated = true;
                    }
                }
                sm.c[lane] = c;
                sm.s[lane] = s;
            }
            __syncwarp();
            for (int e = lane; e < half * n; e += 32) {  // rows: A <- J^T A
                const int k = e / n, j = e % n;
                int p, q;
                round_pair(m, r, k, p, q);
                if (q < n) {
                    const float c = sm.c[k], s = sm.s[k];
                    const float x = sm.a[p][j], y = sm.a[q][j];
                    sm.a[p][j] = c * x - s * y;
                    sm.a[q][j] = s * x + c * y;
                }
            }
            __syncwarp();
            for (int e = lane; e < half * n; e += 32) {  // columns: A <- A J, V <- V J
                const int k = e / n, i = e % n;
                int p, q;
                round_pair(m, r, k, p, q);
                if (q < n) {
                    const float c = sm.c[k], s = sm.s[k];
                    const float x = sm.a[i][p], y = sm.a[i][q];
                    sm.a[i][p] = c * x - s * y;
                    sm.a[i][q] = s * x + c * y;
                    const float vx = sm.v[i][p], vy = sm.v[i][q];
                    sm.v[i][p] = c * vx - s * vy;
                    sm.v[i][q] = s * vx + c * vy;
                }
            }
            __syncwarp();
            if (rotated) {
                sm.a[pp][pp] = dpp;
                sm.a[pq][pq] = dqq;
                sm.a[pp][pq] = 0.f;
                sm.a[pq][pp] = 0.f;
            }
            __syncwarp();
        }
    }

    if (lane < n) {
        const float lam = sm.a[lane][lane];
        const float key = isnan(lam) ? INFINITY : lam;
        int rank = 0;
        for (int j = 0; j < n; ++j) {
            const float lj = sm.a[j][j];
            const float kj = isnan(lj) ? INFINITY : lj;
            rank += (kj < key) || (kj == key && j < lane);
        }
        w_out[static_cast<size_t>(b) * n + rank] = lam;
        float* vb = v_out + static_cast<size_t>(b) * n * n;
        for (int i = 0; i < n; ++i) vb[i * n + rank] = sm.v[i][lane];
    }
}

}  // namespace

extern "C" {

// a: (batch, n, n) float32, contiguous, symmetric (its lower triangle is
// read); w: (batch, n) and v: (batch, n, n) float32 outputs, 1 <= n <= 16,
// batch >= 1. Launch on `stream`; returns the CUDA error code (0 = success).
int sym_eig(const void* a, int batch, int n, void* w, void* v, void* stream) {
    if (n < 1 || n > kMaxN || batch < 1) return static_cast<int>(cudaErrorInvalidValue);
    const int blocks = (batch + kWarps - 1) / kWarps;
    sym_eig_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(a), batch, n, static_cast<float*>(w),
        static_cast<float*>(v));
    return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
