// Pivot-free Cholesky solve of a small damped SPD system A x = b.
//
// Replaces the Pallas TPU kernel `spd_solve`
// (orb_slam2_ssd_semantic_tpu/ops/pallas_solve.py, body `_gj_kernel`, a
// Gauss-Jordan elimination): the reduced camera system of local BA,
// n = 6 * (window + anchors) <= 128. No pivoting: the system is SPD with
// relative diagonal damping, so every pivot is a positive Schur-complement
// diagonal. A pivot that float32 rounding drives to zero or below gives
// NaN through rsqrtf and is not clamped: the caller sees it.
//
// Bound on the card: latency. The work (n^3 / 3 flops) and the bytes
// (64 KB in, 512 B out) are nothing for the card, and a factorisation is a
// chain of n dependent pivots on one SM. What costs time is the length of
// that chain (barriers, shared-memory round trips, the reciprocal square
// root) and the shared-memory traffic of the trailing update.
//
// Design: one block of 256 threads, two per matrix row. The lower triangle
// lives packed in static shared memory (33 KB; row i starts at i(i+1)/2,
// and since triangular numbers are a permutation modulo 32, the 32 rows of
// a warp fall on 32 different banks at any column). A = L L^T is factored
// right-looking in panels of kNb = 8 columns with two barriers a panel
// (a quarter of a barrier per column):
//   panel step: the first thread of every row at or below the panel reads
//     the 8 x 8 diagonal block (broadcast loads) and factors it in
//     registers, the same arithmetic in each, and carries its own row's 8
//     panel entries and the panel's right-hand side along as extra rows
//     of that small factorisation. So no thread waits for another inside
//     a panel, and the forward substitution y = L^-1 b costs no pass of
//     its own.
//   trailing update: a thread holds its row's 8 new L entries in registers
//     (the row's second thread fetches them from the first) and subtracts
//     their products with the L rows of the columns to its left, two
//     broadcast float4 loads per element from a compact copy of the
//     panel: 8 multiply-adds for 4 shared-memory instructions, four
//     elements in flight. The two threads of a row take alternate
//     columns; the second half owns the rows in reverse order, so that
//     each warp scheduler gets a long-row warp and a short-row warp.
// Then L^T x = y is solved by panels from the last to the first, one
// barrier a panel: the panel's rows publish their y, the first thread of
// every row up to the panel solves the 8 x 8 triangle itself and takes
// the panel's x out of its own y.
// Shared-memory loads are made unconditionally and ahead of their use
// (a value outside the system is replaced after the load, and the back
// substitution reads its L entries before the barrier it waits at), so
// that no branch or barrier sits between a load and the next one.
// The system is laid out by the kernel itself from A's row stride; n is
// not padded: a partial last panel is completed with identity in
// registers.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 128;
constexpr int kNb = 8;               // columns of a panel
constexpr int kHalves = 2;           // threads per matrix row
constexpr int kThreads = kMaxN * kHalves;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int tri(int i) { return i * (i + 1) / 2; }

__global__ void __launch_bounds__(kThreads)
spd_solve_kernel(const float* __restrict__ a_in, int lda, const float* __restrict__ b_in, int n,
                 float* __restrict__ x_out) {
    __shared__ float m[kMaxN * (kMaxN + 1) / 2];  // packed lower triangle; L in place
    __shared__ float4 lp[kMaxN][2];               // the current panel's L rows
    __shared__ float bs[kMaxN];                   // right-hand side, updated by panels
    __shared__ float ys[kMaxN];                   // y = L^-1 b
    __shared__ float inv_diag[kMaxN];             // 1 / L[k][k]
    __shared__ float yb[2][kNb];                  // back substitution: a panel's y

    const int tid = threadIdx.x;
    const int half = tid / kMaxN;
    const int row = (half & 1) ? kMaxN - 1 - tid % kMaxN : tid % kMaxN;
    const int row_base = tri(row);
    const int warp = tid / 32, lane = tid % 32;

#pragma unroll 4
    for (int i = warp; i < n; i += kWarps) {
        const float* src = a_in + static_cast<size_t>(i) * lda;
        float* dst = m + tri(i);
#pragma unroll
        for (int u = 0; u < kMaxN / 32; ++u) {
            const int j = lane + 32 * u;
            if (j <= i) dst[j] = src[j];
        }
    }
    if (tid < n) bs[tid] = b_in[tid];
    __syncthreads();

    for (int k0 = 0; k0 < n; k0 += kNb) {
        float mine[kNb];
#pragma unroll
        for (int p = 0; p < kNb; ++p) mine[p] = 0.f;
        if (half == 0 && row >= k0 && row < n) {
            float d[kNb][kNb], bp[kNb], yp[kNb];
#pragma unroll
            for (int r = 0; r < kNb; ++r) {
                const int gr = k0 + r;
                const int base = tri(gr) + k0;
                // Loads come first and unconditionally (gr < kMaxN is always
                // inside the arrays), the choice after: no branch waits on
                // a load.
#pragma unroll
                for (int c = 0; c <= r; ++c) {
                    const float v = m[base + c];
                    d[r][c] = gr < n ? v : (r == c ? 1.f : 0.f);
                }
                const float vb = bs[gr];
                bp[r] = gr < n ? vb : 0.f;
                const float vm = m[row_base + gr];
                mine[r] = gr <= row ? vm : 0.f;
            }
#pragma unroll
            for (int kk = 0; kk < kNb; ++kk) {
                const float inv = rsqrtf(d[kk][kk]);
#pragma unroll
                for (int r = kk + 1; r < kNb; ++r) d[r][kk] *= inv;
                mine[kk] *= inv;
                yp[kk] = bp[kk] * inv;
#pragma unroll
                for (int c = kk + 1; c < kNb; ++c) {
#pragma unroll
                    for (int r = c; r < kNb; ++r) d[r][c] = fmaf(-d[r][kk], d[c][kk], d[r][c]);
                    mine[c] = fmaf(-mine[kk], d[c][kk], mine[c]);
                    bp[c] = fmaf(-yp[kk], d[c][kk], bp[c]);
                }
                if (row == k0 + kk) {
                    inv_diag[row] = inv;
                    ys[row] = yp[kk];
                }
            }
            if (row >= k0 + kNb) {
                lp[row][0] = make_float4(mine[0], mine[1], mine[2], mine[3]);
                lp[row][1] = make_float4(mine[4], mine[5], mine[6], mine[7]);
                float bi = bs[row];
#pragma unroll
                for (int p = 0; p < kNb; ++p) bi = fmaf(-mine[p], yp[p], bi);
                bs[row] = bi;
            }
        }
        __syncthreads();
        // L goes back in place only now: above, the diagonal block and each
        // row's panel entries were still being read by other threads.
        if (half == 0 && row >= k0 && row < n) {
#pragma unroll
            for (int p = 0; p < kNb; ++p)
                if (k0 + p <= row) m[row_base + k0 + p] = mine[p];
        }
        // The other threads of a row take its L entries from the first one.
        if (half != 0 && row >= k0 + kNb && row < n) {
            const float4 a = lp[row][0];
            const float4 b = lp[row][1];
            mine[0] = a.x, mine[1] = a.y, mine[2] = a.z, mine[3] = a.w;
            mine[4] = b.x, mine[5] = b.y, mine[6] = b.z, mine[7] = b.w;
        }
        // Four columns at a time, so that four chains of multiply-adds are
        // in flight; the bound is the same for all rows of a warp and only
        // the store is conditional.
        const int j_end = min(row | 31, n - 1);
        for (int j = k0 + kNb + half; j <= j_end; j += 4 * kHalves) {
            float4 l0[4], l1[4];
            float acc[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int jj = min(j + u * kHalves, kMaxN - 1);
                l0[u] = lp[jj][0];
                l1[u] = lp[jj][1];
                acc[u] = m[row_base + jj];
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                acc[u] = fmaf(-mine[0], l0[u].x, acc[u]);
                acc[u] = fmaf(-mine[1], l0[u].y, acc[u]);
                acc[u] = fmaf(-mine[2], l0[u].z, acc[u]);
                acc[u] = fmaf(-mine[3], l0[u].w, acc[u]);
                acc[u] = fmaf(-mine[4], l1[u].x, acc[u]);
                acc[u] = fmaf(-mine[5], l1[u].y, acc[u]);
                acc[u] = fmaf(-mine[6], l1[u].z, acc[u]);
                acc[u] = fmaf(-mine[7], l1[u].w, acc[u]);
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int jj = j + u * kHalves;
                if (jj <= row && row < n) m[row_base + jj] = acc[u];
            }
        }
        __syncthreads();
    }

    const bool solver = half == 0 && row < n;
    float yt = solver ? ys[row] : 0.f;
    int parity = 0;
    for (int k0 = (n - 1) / kNb * kNb; k0 >= 0; k0 -= kNb, parity ^= 1) {
        if (solver && row >= k0 && row < k0 + kNb) yb[parity][row - k0] = yt;
        // The panel's triangle of L is read before the barrier: it does not
        // depend on the y that the barrier waits for.
        const bool work = solver && row < k0 + kNb;
        float lt[kNb][kNb], inv[kNb], below[kNb];
        if (work) {
#pragma unroll
            for (int c = 0; c < kNb; ++c) {
                const int gc = k0 + c;
                inv[c] = inv_diag[gc];
                const float vb = m[tri(gc) + row];  // L[gc][row], for rows above the panel
                below[c] = gc < n ? vb : 0.f;
#pragma unroll
                for (int r = 0; r < c; ++r) {
                    const float v = m[tri(gc) + k0 + r];
                    lt[c][r] = gc < n ? v : 0.f;
                }
            }
        }
        __syncthreads();
        if (!work) continue;
        float x[kNb];
#pragma unroll
        for (int r = kNb - 1; r >= 0; --r) {
            float acc = yb[parity][r];
#pragma unroll
            for (int c = kNb - 1; c > r; --c) acc = fmaf(-lt[c][r], x[c], acc);
            x[r] = k0 + r < n ? acc * inv[r] : 0.f;
        }
        if (row >= k0) {
            float v = 0.f;
#pragma unroll
            for (int r = 0; r < kNb; ++r)
                if (row == k0 + r) v = x[r];
            x_out[row] = v;
        } else {
#pragma unroll
            for (int r = 0; r < kNb; ++r) yt = fmaf(-below[r], x[r], yt);
        }
    }
}

}  // namespace

extern "C" {

// a: (n, n) float32 with row stride `lda` elements and unit column stride
// (only its lower triangle is read), b: (n,), x: (n,) output, 1 <= n <= 128.
// Launch on `stream`; returns the CUDA error code (0 = success).
int spd_solve(const void* a, int lda, const void* b, int n, void* x, void* stream) {
    if (n < 1 || n > kMaxN || lda < n) return static_cast<int>(cudaErrorInvalidValue);
    spd_solve_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(a), lda, static_cast<const float*>(b), n,
        static_cast<float*>(x));
    return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
