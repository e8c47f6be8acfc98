// Batched eigensolver for small symmetric float32 matrices: cyclic Jacobi
// in registers.
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
// the chain of dependent steps of one matrix: sweeps x rounds x (rotation,
// row pass, column pass). Tensor cores and TMA do not apply: a 9 x 9
// rotation is a few scalar FMAs per element, far under one `wgmma` tile,
// and the data is read once, a few hundred bytes a matrix. So the design
// takes every memory pass and every index computation off that chain.
//
// Design: a matrix takes 2n lanes of a warp, lane j holding column j of
// A in registers (a[i] = A[i][j]) and lane n + j column j of the
// accumulated rotations V; one 9 x 9 matrix a warp (lanes 0-8 and 9-17),
// 32 / 2n where n <= 8. The kernel is a template on n: each sweep is m - 1
// rounds of the circle method over m = n rounded up to even indices (pair
// k of round r is (r, m - 1) for k = 0, else ((r + k) mod (m - 1), (r - k)
// mod (m - 1)), ordered p < q; an odd n makes index m - 1 a dummy whose
// pairs are dropped), unrolled, so every round's pairs, and so every
// register index, are constants of the compiled code. The m / 2 pairs of a
// round are disjoint and rotate at once. In a round every lane of a
// matrix:
//   1. fetches a_pp, a_qq and a_pq of every pair with three `__shfl_sync`s
//      from the lanes holding columns p and q of A, and computes every
//      pair's rotation itself (the same bits in every lane): from d = a_qq
//      - a_pp and h = 2 a_pq, u = rsqrt(d^2 + h^2), w = (1 + |d| u) / 2,
//      c = sqrt(w), s = sign(d) h u / (2 c), t = s / c, all from two
//      reciprocal square roots (Golub and Van Loan's symmetric Schur step,
//      t = sign(d) h / (|d| + sqrt(d^2 + h^2)), in half-angle form: no
//      division and no hypot on the chain); a pair with |a_pq| <= 2^-64
//      (after the scaling below) is not rotated;
//   2. applies all of them to the rows of its own column, if it holds one
//      of A (A <- J^T A): register arithmetic;
//   3. applies its own pair's rotation to the columns (A <- A J, V <- V J),
//      taking its partner column, of A or of V, with one `__shfl_sync` an
//      element;
//   4. sets its pair's 2 x 2 block of A to the exact result (a_pp - t a_pq,
//      a_qq + t a_pq, zeros off the diagonal).
// No shared memory and no `__syncwarp` inside a round: the shuffles carry
// the data. Nothing in a round branches on a lane's data: which lane takes
// which rotation, and whether a pair rotates, are selects. The reciprocal
// square roots are the bare MUFU instruction (`rsqrt_ftz`), without the
// subnormal rescaling that `rsqrtf` puts around it on the chain, and V's
// columns have lanes of their own, so that a lane's column pass shuffles
// one column, not two. Each matrix is first scaled by a power of two
// (exact) so that its largest entry lies in [0.5, 1): nothing squared
// overflows, and the eigenvalues are scaled back exactly at the end. Before each sweep
// the matrix's squared off-diagonal and total norms are summed over its
// lanes and broadcast from its first lane, so every lane of a matrix takes
// the same decision: the matrix stops when the off-diagonal part is at
// most 1e-8 of the norm, or after 16 sweeps; a stopped matrix is left as
// it is while others of its warp sweep on, and the warp stops when all
// have. Then lane j ranks eigenvalue j among its matrix's diagonal (NaN
// above everything, ties by index) and writes it, and lane n + j column j
// of V, to that rank. `ops/cuda_eigh.py::eigh_jacobi_reference` is this
// algorithm in PyTorch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxN = 16;
constexpr int kWarps = 2;  // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSweeps = 16;
constexpr unsigned kFull = 0xffffffffu;
// Stop when the squared off-diagonal norm is at most this share of the
// squared norm (1e-8 of the norm, under f32's epsilon).
constexpr float kTol = 1e-16f;
// 2^-64: a pair whose scaled a_pq is no larger is not rotated (its square
// is under f32's smallest normal number, and its share of the norm far
// under kTol).
constexpr float kTiny = 5.42101086242752217e-20f;

template <int V>
struct Int {
    static constexpr int value = V;
};

// f(Int<I>{}), f(Int<I + 1>{}), ..., f(Int<E - 1>{}): a loop whose index is
// a constant of the compiled code.
template <int I, int E, class F>
__device__ __forceinline__ void static_for(F&& f) {
    if constexpr (I < E) {
        f(Int<I>{});
        static_for<I + 1, E>(f);
    }
}

// 1 / sqrt(x), flushing subnormal inputs and results to zero: the MUFU
// instruction alone, without `rsqrtf`'s rescaling of subnormal x (a
// rotated pair's d^2 + h^2 is at least 2^-126, and w at least 0.5).
__device__ __forceinline__ float rsqrt_ftz(float x) {
    float y;
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// Pair k of round r of the circle method over m (even) indices, as p < q.
__host__ __device__ constexpr int pair_a(int m, int r, int k) {
    return k == 0 ? r : (r + k) % (m - 1);
}
__host__ __device__ constexpr int pair_b(int m, int r, int k) {
    return k == 0 ? m - 1 : (r - k + m - 1) % (m - 1);
}
__host__ __device__ constexpr int pair_p(int m, int r, int k) {
    return pair_a(m, r, k) < pair_b(m, r, k) ? pair_a(m, r, k) : pair_b(m, r, k);
}
__host__ __device__ constexpr int pair_q(int m, int r, int k) {
    return pair_a(m, r, k) < pair_b(m, r, k) ? pair_b(m, r, k) : pair_a(m, r, k);
}

// The largest power of two no larger than n - 1 (the first step of a
// shuffle-down reduction over n lanes).
__host__ __device__ constexpr int top_step(int n) {
    int o = 1;
    while (2 * o < n) o *= 2;
    return o;
}

// The sum (max) of x over the N lanes of a matrix, in every lane of it:
// reduced onto the first lane `base`, then broadcast from there.
template <int N, bool kMax>
__device__ __forceinline__ float group_reduce(float x, int j, int base) {
    constexpr int kTop = top_step(N);
#pragma unroll
    for (int o = kTop; o > 0; o >>= 1) {
        const float y = __shfl_down_sync(kFull, x, o);
        x = j + o < N ? (kMax ? fmaxf(x, y) : x + y) : x;
    }
    return __shfl_sync(kFull, x, base);
}

// Round R of a sweep on this lane's column j, of A or (`is_v`) of V: its
// matrix's lanes start at `base`, those of its own matrix (A or V) at
// `own`; `run`: the matrix still sweeps.
template <int N, int R>
__device__ __forceinline__ void jacobi_round(float (&a)[N], int j, bool is_v, int base, int own,
                                             bool run) {
    constexpr int M = N + (N & 1);
    constexpr int kHalf = M / 2;
    float c[kHalf], s[kHalf], dp[kHalf], dq[kHalf];
    bool rot[kHalf];
    // 1. Every pair's rotation, from three entries shuffled from its lanes.
    static_for<0, kHalf>([&](auto K) {
        constexpr int k = decltype(K)::value;
        constexpr int p = pair_p(M, R, k), q = pair_q(M, R, k);
        c[k] = 1.f;
        s[k] = 0.f;
        dp[k] = dq[k] = 0.f;
        rot[k] = false;
        if constexpr (q < N) {
            const float app = __shfl_sync(kFull, a[p], base + p);
            const float aqq = __shfl_sync(kFull, a[q], base + q);
            const float apq = __shfl_sync(kFull, a[p], base + q);  // row p, column q
            rot[k] = run && !(fabsf(apq) <= kTiny);
            const float d = aqq - app, h = 2.f * apq;
            const float u = rsqrt_ftz(fmaf(d, d, h * h));
            const float w = fmaf(0.5f, fabsf(d) * u, 0.5f);
            const float rc = rsqrt_ftz(w);  // 1 / c
            const float sp = 0.5f * ((d >= 0.f ? h : -h) * u) * rc;
            const float t = sp * rc;
            c[k] = rot[k] ? w * rc : 1.f;
            s[k] = rot[k] ? sp : 0.f;
            dp[k] = fmaf(-t, apq, app);  // read only where rot[k]
            dq[k] = fmaf(t, apq, aqq);
        }
    });
    // 2. Rows: A <- J^T A, on this lane's column of A (V takes no row
    // rotation).
    static_for<0, kHalf>([&](auto K) {
        constexpr int k = decltype(K)::value;
        constexpr int p = pair_p(M, R, k), q = pair_q(M, R, k);
        if constexpr (q < N) {
            const float cr = is_v ? 1.f : c[k], sr = is_v ? 0.f : s[k];
            const float x = a[p], y = a[q];
            a[p] = cr * x - sr * y;
            a[q] = sr * x + cr * y;
        }
    });
    // 3. Columns: A <- A J, V <- V J. Lane p takes c col_p - s col_q, lane q
    // s col_p + c col_q, each from the partner lane of its own matrix; a
    // lane in no rotated pair keeps its column.
    float cm = 1.f, sm = 0.f;
    int partner = j;
    static_for<0, kHalf>([&](auto K) {
        constexpr int k = decltype(K)::value;
        constexpr int p = pair_p(M, R, k), q = pair_q(M, R, k);
        if constexpr (q < N) {
            const bool is_p = j == p, is_q = j == q;
            cm = is_p || is_q ? c[k] : cm;
            sm = is_p ? -s[k] : (is_q ? s[k] : sm);
            partner = is_p ? q : (is_q ? p : partner);
        }
    });
#pragma unroll
    for (int i = 0; i < N; ++i) {
        const float y = __shfl_sync(kFull, a[i], own + partner);
        a[i] = fmaf(sm, y, cm * a[i]);
    }
    // 4. Each rotated pair's 2 x 2 block of A set to its exact result.
    static_for<0, kHalf>([&](auto K) {
        constexpr int k = decltype(K)::value;
        constexpr int p = pair_p(M, R, k), q = pair_q(M, R, k);
        if constexpr (q < N) {
            const bool fix = rot[k] && !is_v;
            const bool fix_p = fix && j == p, fix_q = fix && j == q;
            a[p] = fix_p ? dp[k] : (fix_q ? 0.f : a[p]);
            a[q] = fix_q ? dq[k] : (fix_p ? 0.f : a[q]);
        }
    });
}

template <int N>
__global__ void __launch_bounds__(kThreads)
sym_eig_kernel(const float* __restrict__ a_in, int batch, float* __restrict__ w_out,
               float* __restrict__ v_out) {
    constexpr int M = N + (N & 1);
    constexpr int L = 2 * N;   // lanes a matrix: its columns of A, then of V
    constexpr int G = 32 / L;  // matrices a warp
    const int warp = blockIdx.x * kWarps + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (warp * G >= batch) return;  // whole warps only
    // Lanes past the warp's last whole group (lanes 18-31 at n = 9) shadow
    // the first matrix's lanes and write nothing.
    const int slot = lane / L;
    const int base = slot < G ? slot * L : 0;
    const int li = lane - slot * L;
    const bool is_v = li >= N;
    const int j = is_v ? li - N : li;  // this lane's column
    const int own = base + (is_v ? N : 0);
    const int b = warp * G + slot;
    const bool live = slot < G && b < batch;

    // Column j of A (scaled below), or of V = I.
    float a[N];
    const float* src = a_in + static_cast<size_t>(live ? b : 0) * N * N;
    float mx = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
        a[i] = is_v ? (i == j ? 1.f : 0.f)
                    : (live ? (i >= j ? src[i * N + j] : src[j * N + i]) : 0.f);
        mx = fmaxf(mx, is_v ? 0.f : fabsf(a[i]));
    }
    // A scaled by 2^-e, exactly: its largest entry in [0.5, 1).
    mx = group_reduce<L, true>(mx, li, base);
    int e = 0;
    if (mx > 0.f && isfinite(mx)) frexpf(mx, &e);
#pragma unroll
    for (int i = 0; i < N; ++i) a[i] = is_v ? a[i] : ldexpf(a[i], -e);

    bool run = live;
    for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
        float off = 0.f, tot = 0.f;
#pragma unroll
        for (int i = 0; i < N; ++i) {
            const float x = is_v ? 0.f : a[i];
            tot = fmaf(x, x, tot);
            off = i != j ? fmaf(x, x, off) : off;
        }
        off = group_reduce<L, false>(off, li, base);
        tot = group_reduce<L, false>(tot, li, base);
        run = run && !(off <= kTol * tot);
        if (!__any_sync(kFull, run)) break;
        static_for<0, M - 1>([&](auto R) {
            jacobi_round<N, decltype(R)::value>(a, j, is_v, base, own, run);
        });
    }

    // Eigenvalue j and its rank, in the lanes of A; the lanes of V take
    // the rank of their column's eigenvalue.
    float lam = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) lam = i == j ? a[i] : lam;
    lam = ldexpf(lam, e);
    const float key = isnan(lam) ? INFINITY : lam;
    int rank = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
        const float ki = __shfl_sync(kFull, key, base + i);
        rank += (ki < key) || (ki == key && i < j);
    }
    rank = __shfl_sync(kFull, rank, base + j);
    if (live && !is_v) w_out[static_cast<size_t>(b) * N + rank] = lam;
    if (live && is_v) {
        float* vb = v_out + static_cast<size_t>(b) * N * N;
#pragma unroll
        for (int i = 0; i < N; ++i) vb[i * N + rank] = a[i];
    }
}

template <int N>
int launch(const float* a, int batch, float* w, float* v, cudaStream_t stream) {
    constexpr int G = 32 / (2 * N);
    const int warps = (batch + G - 1) / G;
    const int blocks = (warps + kWarps - 1) / kWarps;
    sym_eig_kernel<N><<<blocks, kThreads, 0, stream>>>(a, batch, w, v);
    return static_cast<int>(cudaGetLastError());
}

template <int N>
int launch_n(int n, const float* a, int batch, float* w, float* v, cudaStream_t stream) {
    if constexpr (N > kMaxN) {
        return static_cast<int>(cudaErrorInvalidValue);
    } else {
        return n == N ? launch<N>(a, batch, w, v, stream)
                      : launch_n<N + 1>(n, a, batch, w, v, stream);
    }
}

}  // namespace

extern "C" {

// a: (batch, n, n) float32, contiguous, symmetric (its lower triangle is
// read); w: (batch, n) and v: (batch, n, n) float32 outputs, 1 <= n <= 16,
// batch >= 1. Launch on `stream`; returns the CUDA error code (0 = success).
int sym_eig(const void* a, int batch, int n, void* w, void* v, void* stream) {
    if (n < 1 || n > kMaxN || batch < 1) return static_cast<int>(cudaErrorInvalidValue);
    return launch_n<1>(n, static_cast<const float*>(a), batch, static_cast<float*>(w),
                       static_cast<float*>(v), static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
