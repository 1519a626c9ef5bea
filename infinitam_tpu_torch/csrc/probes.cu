// P1-P6 — the kernels of the TPU primitive probes (tools/probe2.py, probe6-13.py).
//
// Replaces: the 16 pl.pallas_call sites of those scripts (the registry
// `ops/kernels/probes.py::SITES` maps each to its kernel here). Each kernel
// computes what the probe's Pallas body computes, not how the TPU got there:
// no one-hot MXU taps, no [B, 8, 64] relayouts, no scalar prefetch, no VMEM
// residency. On the card a tap is a plain load and a row is a plain row.
//
// - P1 gather (probe2 kA/kB, probe6 kern): `take` (1-D) and
//   `take_along_axis` on axis 0 or 1 of a 2-D table, one thread an output
//   element, templated on the element's size (1, 2 or 4 bytes: int8, bf16,
//   f32 and int32). Bound by bytes: the index, the output and the table's
//   touched 32-byte sectors.
// - P2 row update (probe7 kernel, probe8 k1-k5, probe9 kernel, probe10 kern,
//   probe12 kern, probe13 sk): one CTA a listed step, as the TPU grid had
//   one step a block. Step i reads row src(i) and writes row dst(i), each
//   ptr[i] or i; in place (out == in) or into a fresh output, where only the
//   visited rows are written. Element k of the row:
//   out = gate ? (row + tap_k · tap_scale) · mul : row, with the tap at
//   dv = (3k + i) mod 128, du = 7·dv mod 128 of the step's 128×128 window:
//   none; img[wv·128 + dv, wu·128 + du] rounded to bf16 (round to nearest
//   even, as astype(bfloat16)); img[wu·128 + du, wv·128 + dv] in f32 (the
//   transposed window); or the window's sum. Gates: none, valid[i] > 0
//   (in place, a step with valid[i] ≤ 0 touches nothing; into a fresh
//   output it copies its row), ptr[i] ≥ 0 (a step with ptr[i] < 0 touches
//   nothing), and, for probe13's
//   int8 row +1, "first": a row listed by several steps is updated by the
//   first of them only, so it gains 1 once, as the TPU body (which reads the
//   input, not the output) gives. Precondition of the other gates: the
//   written rows are distinct (the probes' ptr are a permutation), else two
//   CTAs race on a row. Bound by bytes: the rows a step changes (or, into
//   a fresh output, copies), read and written once, and the window's
//   touched sectors.
// - P3 page gather-sum (probe9 kacc, probe13 rk): out[t, c] =
//   scale · Σ_{k<K} f32(pages[ids[t, k], sel(t, c)]), sel = c or
//   (17c + t) mod row_len, one CTA a tile, the ids in shared memory, the
//   sum in k order. Bound by bytes: the pages' touched sectors.
// - P4 scaled copy (probe11 ck, probe12 ck): out = x · mul, a CTA per
//   `rows_per_cta` rows (the probes' 64-, 768-, 96- and 6144-CTA
//   decompositions), 16-byte loads and stores. Bound by bytes.
// - P5 bf16 GEMM (probe11 mk): C = bf16(A · B), A [M, K], B [K, N] row-major,
//   f32 accumulation on the tensor cores through WMMA 16×16×16 fragments, a
//   128×128 CTA tile staged through shared memory 32 deep, 8 warps of 64×32.
//   Bound by operations (989.4 TFLOP/s dense bf16); this simple design has
//   no asynchronous copies and no wgmma, so it runs well below that.
// - P6 window column sums (probe13 wk): out[t, c] = Σ_{r<win_h} img[a_t + r,
//   b_t + c] for c < win_w and 0 up to out_w, one CTA a tile, the sum in r
//   order. Bound by bytes.
//
// Indices must lie in range (the probes' always do); no kernel checks them.
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

#define PROBE_THREADS 256
#define PROBE_ROW_THREADS 128
#define PROBE_WIN 128
#define PROBE_MAX_PAGES 256

// --- P1 gather ----------------------------------------------------------

// MODE 0: out[j] = tab[idx[j]]; 1: out[r, c] = tab[idx[r, c], c];
// 2: out[r, c] = tab[r, idx[r, c]] (idx_cols columns, tab_cols in the table)
template <typename T, int MODE>
__global__ void itpu_probe_gather_kernel(const T* __restrict__ tab, const int* __restrict__ idx, T* __restrict__ out,
                                         long long n, int tab_cols, int idx_cols) {
    const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= n) return;
    const long long i = idx[j];
    long long src = i;
    if (MODE == 1) src = i * tab_cols + j % idx_cols;
    if (MODE == 2) src = (j / idx_cols) * tab_cols + i;
    out[j] = tab[src];
}

template <typename T>
static void itpu_probe_gather_launch(const void* tab, const void* idx, void* out, long long n, int mode, int tab_cols,
                                     int idx_cols, cudaStream_t stream) {
    auto kernel = mode == 0 ? itpu_probe_gather_kernel<T, 0>
                : mode == 1 ? itpu_probe_gather_kernel<T, 1> : itpu_probe_gather_kernel<T, 2>;
    const unsigned int blocks = (unsigned int)((n + PROBE_THREADS - 1) / PROBE_THREADS);
    kernel<<<blocks, PROBE_THREADS, 0, stream>>>((const T*)tab, (const int*)idx, (T*)out, n, tab_cols, idx_cols);
}

ITPU_EXPORT int itpu_probe_gather(const void* tab, const void* idx, void* out, int n, int mode, int elem_bytes,
                                  int tab_cols, int idx_cols, void* stream) {
    if (mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
    if (n <= 0) return (int)cudaGetLastError();
    cudaStream_t s = (cudaStream_t)stream;
    switch (elem_bytes) {
        case 1: itpu_probe_gather_launch<uint8_t>(tab, idx, out, n, mode, tab_cols, idx_cols, s); break;
        case 2: itpu_probe_gather_launch<uint16_t>(tab, idx, out, n, mode, tab_cols, idx_cols, s); break;
        case 4: itpu_probe_gather_launch<uint32_t>(tab, idx, out, n, mode, tab_cols, idx_cols, s); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// --- P2 row update ------------------------------------------------------

enum { PROBE_TAP_NONE = 0, PROBE_TAP_BF16 = 1, PROBE_TAP_F32T = 2, PROBE_TAP_SUM = 3 };
enum { PROBE_GATE_NONE = 0, PROBE_GATE_VALID = 1, PROBE_GATE_PTR = 2, PROBE_GATE_FIRST = 3 };

// the sum of the step's 128×128 window img[wv·128 + a, wu·128 + b], the
// same value in every thread of the CTA
__device__ float itpu_probe_window_sum(const float* img, int img_w, int v0, int u0) {
    __shared__ float part[PROBE_ROW_THREADS / 32];
    float s = 0.f;
    for (int e = threadIdx.x; e < PROBE_WIN * PROBE_WIN; e += blockDim.x)
        s += img[(long long)(v0 + e / PROBE_WIN) * img_w + u0 + e % PROBE_WIN];
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = s;
    __syncthreads();
    float total = 0.f;
    for (int w = 0; w < PROBE_ROW_THREADS / 32; ++w) total += part[w];
    return total;
}

// T float: the affine body; T int8_t: row + 1 with int8 wrap-around (probe13 sk)
template <typename T, int TAP, int GATE>
__global__ void __launch_bounds__(PROBE_ROW_THREADS)
itpu_probe_rows_kernel(const T* in, T* out, int row_len, const int* __restrict__ ptr, int src_ptr, int dst_ptr,
                       const int* __restrict__ wv, const int* __restrict__ wu, const int* __restrict__ valid,
                       const float* __restrict__ img, int img_w, float tap_scale, float mul) {
    const int i = blockIdx.x;
    const int p = ptr[i];
    if (GATE == PROBE_GATE_PTR && p < 0) return;
    if (GATE == PROBE_GATE_FIRST) {
        int seen = 0;
        for (int j = threadIdx.x; j < i; j += blockDim.x) seen |= ptr[j] == p;
        if (__syncthreads_or(seen)) return;
    }
    const bool keep = GATE != PROBE_GATE_VALID || valid[i] > 0;
    if (!keep && in == out) return;  // in place, a row the gate keeps as it is needs no traffic
    const long long src = src_ptr ? p : i, dst = dst_ptr ? p : i;
    const T* row = in + src * row_len;
    T* o = out + dst * row_len;
    float wsum = 0.f;
    if (TAP == PROBE_TAP_SUM) wsum = itpu_probe_window_sum(img, img_w, wv[i] * PROBE_WIN, wu[i] * PROBE_WIN);
    for (int k = threadIdx.x; k < row_len; k += blockDim.x) {
        if constexpr (sizeof(T) == 1) {
            o[k] = (T)((int)row[k] + 1);
        } else {
            const float x = row[k];
            float y = x;
            if (keep) {
                if (TAP != PROBE_TAP_NONE) {
                    float tap = wsum;
                    const int dv = (3 * k + i) & (PROBE_WIN - 1), du = (7 * dv) & (PROBE_WIN - 1);
                    if (TAP == PROBE_TAP_BF16)
                        tap = __bfloat162float(__float2bfloat16_rn(
                            img[(long long)(wv[i] * PROBE_WIN + dv) * img_w + wu[i] * PROBE_WIN + du]));
                    if (TAP == PROBE_TAP_F32T)
                        tap = img[(long long)(wu[i] * PROBE_WIN + du) * img_w + wv[i] * PROBE_WIN + dv];
                    y = x + tap * tap_scale;
                }
                y = y * mul;
            }
            o[k] = y;
        }
    }
}

typedef void (*ItpuProbeRowsF32)(const float*, float*, int, const int*, int, int, const int*, const int*, const int*,
                                 const float*, int, float, float);

template <int TAP>
static ItpuProbeRowsF32 itpu_probe_rows_f32(int gate) {
    return gate == PROBE_GATE_NONE ? itpu_probe_rows_kernel<float, TAP, PROBE_GATE_NONE>
         : gate == PROBE_GATE_VALID ? itpu_probe_rows_kernel<float, TAP, PROBE_GATE_VALID>
         : gate == PROBE_GATE_PTR ? itpu_probe_rows_kernel<float, TAP, PROBE_GATE_PTR> : nullptr;
}

// elem_bytes 4: f32 rows, any tap, gate none, valid or ptr; elem_bytes 1:
// int8 rows +1, tap none, gate first
ITPU_EXPORT int itpu_probe_rows(const void* in, void* out, int row_len, int elem_bytes, const void* ptr, int n_steps,
                                int src_ptr, int dst_ptr, const void* wv, const void* wu, const void* valid,
                                const void* img, int img_w, int tap, int gate, float tap_scale, float mul,
                                void* stream) {
    if (n_steps <= 0) return (int)cudaGetLastError();
    cudaStream_t s = (cudaStream_t)stream;
    if (elem_bytes == 1) {
        if (tap != PROBE_TAP_NONE || gate != PROBE_GATE_FIRST) return (int)cudaErrorInvalidValue;
        itpu_probe_rows_kernel<int8_t, PROBE_TAP_NONE, PROBE_GATE_FIRST><<<n_steps, PROBE_ROW_THREADS, 0, s>>>(
            (const int8_t*)in, (int8_t*)out, row_len, (const int*)ptr, src_ptr, dst_ptr, (const int*)wv,
            (const int*)wu, (const int*)valid, (const float*)img, img_w, tap_scale, mul);
        return (int)cudaGetLastError();
    }
    if (elem_bytes != 4) return (int)cudaErrorInvalidValue;
    ItpuProbeRowsF32 kernel = tap == PROBE_TAP_NONE ? itpu_probe_rows_f32<PROBE_TAP_NONE>(gate)
                            : tap == PROBE_TAP_BF16 ? itpu_probe_rows_f32<PROBE_TAP_BF16>(gate)
                            : tap == PROBE_TAP_F32T ? itpu_probe_rows_f32<PROBE_TAP_F32T>(gate)
                            : tap == PROBE_TAP_SUM ? itpu_probe_rows_f32<PROBE_TAP_SUM>(gate) : nullptr;
    if (kernel == nullptr) return (int)cudaErrorInvalidValue;
    kernel<<<n_steps, PROBE_ROW_THREADS, 0, s>>>((const float*)in, (float*)out, row_len, (const int*)ptr, src_ptr,
                                                  dst_ptr, (const int*)wv, (const int*)wu, (const int*)valid,
                                                  (const float*)img, img_w, tap_scale, mul);
    return (int)cudaGetLastError();
}

// --- P3 page gather-sum -------------------------------------------------

template <typename T, bool HASHED>
__global__ void __launch_bounds__(PROBE_ROW_THREADS)
itpu_probe_page_sum_kernel(const T* __restrict__ pages, int row_len, const int* __restrict__ ids, int ids_stride,
                           int k_pages, float* __restrict__ out, int n_cols, float scale) {
    __shared__ int sid[PROBE_MAX_PAGES];
    const int t = blockIdx.x;
    for (int k = threadIdx.x; k < k_pages; k += blockDim.x) sid[k] = ids[(long long)t * ids_stride + k];
    __syncthreads();
    for (int c = threadIdx.x; c < n_cols; c += blockDim.x) {
        const int col = HASHED ? (17 * c + t) % row_len : c;
        float s = 0.f;
        for (int k = 0; k < k_pages; ++k) s += (float)pages[(long long)sid[k] * row_len + col];
        out[(long long)t * n_cols + c] = s * scale;
    }
}

ITPU_EXPORT int itpu_probe_page_sum(const void* pages, int row_len, int elem_bytes, const void* ids, int ids_stride,
                                    int k_pages, int n_tiles, void* out, int n_cols, int hashed, float scale,
                                    void* stream) {
    if (k_pages < 0 || k_pages > PROBE_MAX_PAGES) return (int)cudaErrorInvalidValue;
    if (n_tiles <= 0) return (int)cudaGetLastError();
    cudaStream_t s = (cudaStream_t)stream;
    if (elem_bytes == 4) {
        auto kernel = hashed ? itpu_probe_page_sum_kernel<float, true> : itpu_probe_page_sum_kernel<float, false>;
        kernel<<<n_tiles, PROBE_ROW_THREADS, 0, s>>>((const float*)pages, row_len, (const int*)ids, ids_stride,
                                                      k_pages, (float*)out, n_cols, scale);
    } else if (elem_bytes == 1) {
        auto kernel = hashed ? itpu_probe_page_sum_kernel<int8_t, true> : itpu_probe_page_sum_kernel<int8_t, false>;
        kernel<<<n_tiles, PROBE_ROW_THREADS, 0, s>>>((const int8_t*)pages, row_len, (const int*)ids, ids_stride,
                                                      k_pages, (float*)out, n_cols, scale);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// --- P4 scaled copy -----------------------------------------------------

__global__ void __launch_bounds__(PROBE_THREADS)
itpu_probe_scale_kernel(const float4* __restrict__ in, float4* __restrict__ out, int vec_per_cta, float mul) {
    const long long base = (long long)blockIdx.x * vec_per_cta;
    for (int j = threadIdx.x; j < vec_per_cta; j += blockDim.x) {
        float4 v = in[base + j];
        v.x = v.x * mul;
        v.y = v.y * mul;
        v.z = v.z * mul;
        v.w = v.w * mul;
        out[base + j] = v;
    }
}

// n_ctas CTAs of vec_per_cta float4 each (rows_per_cta · row_len / 4)
ITPU_EXPORT int itpu_probe_scale(const void* in, void* out, int n_ctas, int vec_per_cta, float mul, void* stream) {
    if (n_ctas <= 0) return (int)cudaGetLastError();
    itpu_probe_scale_kernel<<<n_ctas, PROBE_THREADS, 0, (cudaStream_t)stream>>>((const float4*)in, (float4*)out,
                                                                               vec_per_cta, mul);
    return (int)cudaGetLastError();
}

// --- P5 bf16 GEMM -------------------------------------------------------

#define GEMM_BM 128
#define GEMM_BN 128
#define GEMM_BK 32
#define GEMM_PAD 8  // bf16 a shared row, so that the WMMA loads do not meet on one bank
#define GEMM_THREADS 256

__global__ void __launch_bounds__(GEMM_THREADS)
itpu_probe_gemm_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ B,
                       __nv_bfloat16* __restrict__ C, int M, int N, int K) {
    using namespace nvcuda;
    __shared__ __align__(32) __nv_bfloat16 As[GEMM_BM][GEMM_BK + GEMM_PAD];
    __shared__ __align__(32) __nv_bfloat16 Bs[GEMM_BK][GEMM_BN + GEMM_PAD];
    __shared__ __align__(32) float Cs[GEMM_THREADS / 32][16 * 16];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = warp / 4, wn = warp % 4;  // a warp's 64×32 tile of the CTA's 128×128
    const int m0 = blockIdx.y * GEMM_BM, n0 = blockIdx.x * GEMM_BN;

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
    for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    for (int k0 = 0; k0 < K; k0 += GEMM_BK) {
        // 16 bytes (8 bf16) a thread and load: A's 128×32 tile, B's 32×128
        for (int e = threadIdx.x; e < GEMM_BM * GEMM_BK / 8; e += GEMM_THREADS) {
            const int r = e / (GEMM_BK / 8), c = (e % (GEMM_BK / 8)) * 8;
            *(uint4*)&As[r][c] = *(const uint4*)&A[(long long)(m0 + r) * K + k0 + c];
        }
        for (int e = threadIdx.x; e < GEMM_BK * GEMM_BN / 8; e += GEMM_THREADS) {
            const int r = e / (GEMM_BN / 8), c = (e % (GEMM_BN / 8)) * 8;
            *(uint4*)&Bs[r][c] = *(const uint4*)&B[(long long)(k0 + r) * N + n0 + c];
        }
        __syncthreads();
        for (int kk = 0; kk < GEMM_BK; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[4];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[2];
            for (int i = 0; i < 4; ++i) wmma::load_matrix_sync(af[i], &As[wm * 64 + i * 16][kk], GEMM_BK + GEMM_PAD);
            for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(bf[j], &Bs[kk][wn * 32 + j * 16], GEMM_BN + GEMM_PAD);
            for (int i = 0; i < 4; ++i)
                for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
        }
        __syncthreads();
    }
    // each 16×16 fragment through the warp's own shared tile, rounded to bf16
    for (int i = 0; i < 4; ++i) {
        for (int j = 0; j < 2; ++j) {
            wmma::store_matrix_sync(Cs[warp], acc[i][j], 16, wmma::mem_row_major);
            __syncwarp();
            for (int e = lane; e < 256; e += 32) {
                const int r = m0 + wm * 64 + i * 16 + e / 16, c = n0 + wn * 32 + j * 16 + e % 16;
                C[(long long)r * N + c] = __float2bfloat16_rn(Cs[warp][e]);
            }
            __syncwarp();
        }
    }
}

// M and N multiples of 128, K of 32
ITPU_EXPORT int itpu_probe_gemm(const void* a, const void* b, void* c, int m, int n, int k, void* stream) {
    if (m % GEMM_BM || n % GEMM_BN || k % GEMM_BK) return (int)cudaErrorInvalidValue;
    if (m <= 0 || n <= 0) return (int)cudaGetLastError();
    itpu_probe_gemm_kernel<<<dim3(n / GEMM_BN, m / GEMM_BM), GEMM_THREADS, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)a, (const __nv_bfloat16*)b, (__nv_bfloat16*)c, m, n, k);
    return (int)cudaGetLastError();
}

// --- P6 window column sums ----------------------------------------------

__global__ void __launch_bounds__(PROBE_ROW_THREADS)
itpu_probe_window_sums_kernel(const float* __restrict__ img, int img_w, const int* __restrict__ starts,
                              int starts_stride, int win_h, int win_w, float* __restrict__ out, int out_w) {
    const int t = blockIdx.x;
    const int a = starts[(long long)t * starts_stride], b = starts[(long long)t * starts_stride + 1];
    for (int c = threadIdx.x; c < out_w; c += blockDim.x) {
        float s = 0.f;
        if (c < win_w)
            for (int r = 0; r < win_h; ++r) s += img[(long long)(a + r) * img_w + b + c];
        out[(long long)t * out_w + c] = s;
    }
}

ITPU_EXPORT int itpu_probe_window_sums(const void* img, int img_w, const void* starts, int starts_stride,
                                       int n_tiles, int win_h, int win_w, void* out, int out_w, void* stream) {
    if (n_tiles <= 0) return (int)cudaGetLastError();
    itpu_probe_window_sums_kernel<<<n_tiles, PROBE_ROW_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)img, img_w, (const int*)starts, starts_stride, win_h, win_w, (float*)out, out_w);
    return (int)cudaGetLastError();
}
