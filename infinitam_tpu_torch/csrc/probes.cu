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
//   f32 and int32). The bound counts bytes (the index, the output and the
//   table's touched 32-byte sectors), but every tap is a sector request of
//   its own, and on a table the L2 holds the L2's sector rate sets the
//   time: the probes' 256 k taps move 8.4 MB of sectors, ~2 µs beside a
//   launch's ~1.2, where this design already sits. Measured against it and
//   dropped (PERF.md §6): 4, 8 or 16 outputs a thread with 16-byte index
//   loads over the grid the card holds at once (4 tied on probe 2's takes
//   and lost 0.1-0.5 µs on the small tables; 8 and 16 lost more), and one
//   thread an output with 32-bit index math, an L2 prefetch of a table no
//   larger than the indices and two outputs a thread past 32 MB (0.91-1.06×
//   this design's time where the L2 holds the table; past it 0.82× warm,
//   1.00× cold).
// - P2 row update (probe7 kernel, probe8 k1-k5, probe9 kernel, probe10 kern,
//   probe12 kern, probe13 sk): step i reads row src(i) and writes row dst(i),
//   each ptr[i] or i; in place (out == in) or into a fresh output, where only
//   the visited rows are written. Element k of the row:
//   out = gate ? (row + tap_k · tap_scale) · mul : row, with the tap at
//   dv = (3k + i) mod 128, du = 7·dv mod 128 of the step's 128×128 window:
//   none; img[wv·128 + dv, wu·128 + du] rounded to bf16 (round to nearest
//   even, as astype(bfloat16)); img[wu·128 + du, wv·128 + dv] in f32 (the
//   transposed window); or the window's sum. Gates: none, valid[i] > 0
//   (in place, a step with valid[i] ≤ 0 touches nothing; into a fresh
//   output it copies its row), ptr[i] ≥ 0 (a step with ptr[i] < 0 touches
//   nothing), and, for probe13's int8 row +1, "first": a row listed by
//   several steps is updated by the first of them only, so it gains 1 once,
//   as the TPU body (which reads the input, not the output) gives.
//   Precondition of the other gates: the written rows are distinct (the
//   probes' ptr are a permutation), else two steps race on a row. Bound by
//   bytes: the rows a step changes (or, into a fresh output, copies), read
//   and written once, and the window's touched sectors. A step waits on the
//   chain ptr → row → store, so a CTA of 8 warps takes a chunk of steps (the
//   grid is what the card holds at once) and loads the chunk's ptr (only
//   where a map or the gate reads it), valid, wv and wu at once into shared
//   memory; then a warp takes a live step: each lane holds 16-byte pieces of
//   the row (2 KB a warp) and the step's 4 distinct taps (element k and
//   k + 128 read one tap), loaded with the row through the read-only path,
//   and the warp loads its next step before it stores the current one. The
//   window sum is the whole CTA's, 16 16-byte loads in flight a thread,
//   summed in a fixed order. The "first" gate puts the chunk's rows in an
//   open-addressed table in shared memory and looks up every step up to the
//   chunk's end there (16-byte loads of ptr); a row's slot keeps the
//   earliest step that lists it. Rows not in 16-byte pieces go element by
//   element, a warp a step, in the same kernel. Measured against it and
//   dropped (PERF.md §6): a ring of bulk asynchronous row copies through
//   shared memory, as P4 streams: 3-13% slower on the copies and 1.7-1.8×
//   (2.1× warm) with taps, as a CTA walks its rows in order behind a
//   barrier each and each row's taps wait for its turn. The design it
//   replaced, one CTA a step with each thread's loads and stores in turn and
//   the "first" gate rescanning the steps before its own, stays for
//   comparisons (itpu_probe_rows_simple).
// - P3 page gather-sum (probe9 kacc, probe13 rk): out[t, c] =
//   scale · Σ_{k<K} f32(pages[ids[t, k], sel(t, c)]), sel = c or
//   (17c + t) mod row_len. The bound counts the pages' touched sectors once
//   (rk 5.03 MB), but every tile reads its own pages: at rk every sector of
//   its 48 int8 rows (the 128 hashed columns fall on every 4th byte), 29.5
//   MB of requests, at kacc 16 whole float rows a tile, 19.7 MB, which the
//   L2 serves from the 4 and 8 MB tables. So the L2 bounds it, and a thread
//   keeps many loads in flight: the grid is tiles × blocks of 128 columns,
//   the tile's page ids and row offsets in shared memory (a load's address
//   is one add). int8: a thread a column, 16 pages loaded before any is
//   added, summed exactly in an int (|Σ| ≤ 256 · 128) and converted once;
//   the CTA's four warps read the same 16 sectors of a page, which the L1
//   serves after the first. float: a thread a float4 of columns, 8 pages in
//   flight, summed in k order (plain's order); rows, views or column counts
//   off 16 bytes, and hashed float pages, a thread a column, element by
//   element. Measured against it and dropped (PERF.md §6): a warp a 512-byte
//   row in 16-byte pieces with packed 16-bit sums, the rows split among the
//   CTA's warps (slower at rk than the design it was to replace: unpacking
//   16 columns a piece costs more than the L1 saves by merging four warps'
//   requests), the tile's rows copied into shared memory by cp.async first,
//   an L2 prefetch of the tile's rows, and a column's pages split among two
//   or four threads. The design it replaced (a thread a column, a float sum,
//   the loads as the compiler unrolled them) stays for comparisons
//   (itpu_probe_page_sum_simple).
// - P4 scaled copy (probe11 ck, probe12 ck): out = x · mul, a CTA per
//   `rows_per_cta` rows (the probes' 64-, 96-, 768- and 6144-CTA
//   decompositions). Bound by bytes. In 64 or 96 CTAs on 132 SMs the
//   memory's rate needs ~30-40 KB in flight an SM (Little's law), far more
//   than a thread's one 16-byte load at a time gives, so a CTA streams its
//   block through a ring of 16 KB bulk asynchronous copies in 4 stages of
//   shared memory (cp.async.bulk, completion on an mbarrier a stage): up to
//   48 KB of loads in flight beside the stores, the threads scaling a landed
//   chunk in place. The design it replaced stays for comparisons
//   (itpu_probe_scale_simple).
// - P5 bf16 GEMM (probe11 mk): C = bf16(A · B), A [M, K], B [K, N] row-major,
//   f32 accumulation. Bound by operations (989.4 TFLOP/s dense bf16) at
//   2048³. wgmma m64n256k16 from shared memory on a 128×256 tile (one wave
//   of 128 CTAs at 2048³): two consumer warpgroups of 64 rows each, and a
//   producer warp whose TMA loads keep a 4-stage mbarrier ring of A's 128×64
//   and B's 64×256 tiles in flight (128-byte swizzle, as the wgmma
//   descriptors read it; B N-major through the transpose bit); the epilogue
//   rounds in registers and stores 16 bytes a thread through a swizzled
//   tile in the ring. TMA fills what lies past M, N or K with zeros, and the
//   stores past M or N are cut. The WMMA design it replaced stays for
//   comparisons (itpu_probe_gemm_wmma).
// - P6 window column sums (probe13 wk): out[t, c] = Σ_{r<win_h} img[a_t + r,
//   b_t + c] for c < win_w and 0 up to out_w, the sum in r order (plain's).
//   The bound counts the image's touched sectors once (1.51 MB); a window
//   row of 256 bytes at an arbitrary column spans 8-9 sectors, 21.8 MB of
//   requests for the 1,200 windows, which the L2 serves from the 1.57 MB
//   image. A warp takes 32 columns of a tile (two a 64-column tile, four a
//   CTA: no thread idles), a lane loads 16 rows before it adds them (the
//   probes' 64 × 64 windows compiled with every group unrolled), and the
//   tile's warps store its zero columns as float4. Measured against it and
//   dropped (PERF.md §6): aligned 16-byte pieces of each row summed piece by
//   piece and shifted into columns by shuffles (17 of 32 lanes busy; slower
//   warm and cold), and 32 or 64 rows in flight. The design it replaced (a
//   CTA a tile, half its threads storing zeros, the rows as the compiler
//   unrolled them) stays for comparisons (itpu_probe_window_sums_simple).
// - The L2's read rate, under P3 and P6 (on no path, not counted): a plain
//   read of an L2-resident float32 buffer, a thread 8 float4 loads in flight
//   over a grid-stride (the last group's predicated), each CTA's sum stored
//   (so no load is dead). Its time for as many bytes as a P3 or P6 site
//   requests is that site's L2 floor.
//
// Indices must lie in range (the probes' always do); no kernel checks them.
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached through the runtime
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

#define ROWS_THREADS 256  // 8 warps; a CTA takes at most this many steps
#define ROWS_WARPS (ROWS_THREADS / 32)
#define ROWS_VEC 4        // 16-byte pieces a lane holds of a step: a warp holds 2 KB of a row at a time
#define ROWS_HASH 512     // slots of the "first" gate's table (twice a CTA's steps)
#define ROWS_HASH_BITS 9
#define ROWS_EMPTY ((int)0x80000000)

// A CTA's chunk of steps s0 …: each step's ptr, wv, wu by its place in the
// chunk; the live steps (those a gate lets write) in step order with their
// kind (1 update, 2 copy unchanged) and window sum
struct ItpuRowsChunk {
    int ptr[ROWS_THREADS], wv[ROWS_THREADS], wu[ROWS_THREADS];
    int step[ROWS_THREADS], kind[ROWS_THREADS];
    float sum[ROWS_THREADS];
    int count[ROWS_WARPS];
    float part[ROWS_WARPS];
    int hkey[ROWS_HASH], hmin[ROWS_HASH];
};

// a live step as a warp needs it
struct ItpuRowsItem {
    long long src, dst;
    int i, kind, wv, wu;
    float sum;
};

template <int TAP>
__device__ __forceinline__ ItpuRowsItem itpu_rows_item(const ItpuRowsChunk& sh, int s0, int j, int src_ptr,
                                                       int dst_ptr) {
    const int place = sh.step[j], i = s0 + place, p = sh.ptr[place];
    ItpuRowsItem s = {src_ptr ? p : i, dst_ptr ? p : i, i, sh.kind[j], 0, 0, 0.f};
    if (TAP != PROBE_TAP_NONE) {
        s.wv = sh.wv[place];
        s.wu = sh.wu[place];
    }
    if (TAP == PROBE_TAP_SUM) s.sum = sh.sum[j];
    return s;
}

// the tap of element k of step s (k mod 128 decides it)
template <int TAP>
__device__ __forceinline__ float itpu_rows_tap(const float* __restrict__ img, int img_w, const ItpuRowsItem& s,
                                               int k) {
    const int dv = (3 * k + s.i) & (PROBE_WIN - 1), du = (7 * dv) & (PROBE_WIN - 1);
    if (TAP == PROBE_TAP_BF16)
        return __bfloat162float(__float2bfloat16_rn(
            __ldg(img + (long long)(s.wv * PROBE_WIN + dv) * img_w + s.wu * PROBE_WIN + du)));
    if (TAP == PROBE_TAP_F32T) return __ldg(img + (long long)(s.wu * PROBE_WIN + du) * img_w + s.wv * PROBE_WIN + dv);
    return s.sum;
}

template <int TAP>
__device__ __forceinline__ float itpu_rows_f32(float x, float tap, float tap_scale, float mul) {
    const float y = TAP == PROBE_TAP_NONE ? x : x + tap * tap_scale;
    return y * mul;
}

// 16 bytes of a row updated: 4 floats with their taps, or 16 int8 + 1 with
// wrap-around
template <typename T, int TAP>
__device__ __forceinline__ uint4 itpu_rows_update(uint4 w, const float (&tap)[4], float tap_scale, float mul) {
    if constexpr (sizeof(T) == 1) {
        return make_uint4(__vadd4(w.x, 0x01010101u), __vadd4(w.y, 0x01010101u), __vadd4(w.z, 0x01010101u),
                          __vadd4(w.w, 0x01010101u));
    } else {
        w.x = __float_as_uint(itpu_rows_f32<TAP>(__uint_as_float(w.x), tap[0], tap_scale, mul));
        w.y = __float_as_uint(itpu_rows_f32<TAP>(__uint_as_float(w.y), tap[1], tap_scale, mul));
        w.z = __float_as_uint(itpu_rows_f32<TAP>(__uint_as_float(w.z), tap[2], tap_scale, mul));
        w.w = __float_as_uint(itpu_rows_f32<TAP>(__uint_as_float(w.w), tap[3], tap_scale, mul));
        return w;
    }
}

// the sum of the 128×128 window img[v0 + a, u0 + b], the same value in every
// thread of the CTA and in every call: each thread sums its 16 pieces of 4
// in order, then the warps' shuffle tree, then the warps in order
__device__ float itpu_rows_window_sum(const float* __restrict__ img, int img_w, int v0, int u0, int vec_img,
                                      float* part) {
    const int t = threadIdx.x;
    float s = 0.f;
    if (vec_img) {  // piece t + 256·r: window row t / 32 + 8r, columns 4 (t mod 32) …
        const float4* p = reinterpret_cast<const float4*>(img + (long long)(v0 + (t >> 5)) * img_w + u0) + (t & 31);
        const long long rows8 = 2ll * img_w;  // 8 image rows in float4
        float4 x[16];
#pragma unroll
        for (int r = 0; r < 16; ++r) x[r] = __ldg(p + r * rows8);
#pragma unroll
        for (int r = 0; r < 16; ++r) s += (x[r].x + x[r].y) + (x[r].z + x[r].w);
    } else {
        for (int e = t; e < PROBE_WIN * PROBE_WIN; e += ROWS_THREADS)
            s += __ldg(img + (long long)(v0 + (e >> 7)) * img_w + u0 + (e & (PROBE_WIN - 1)));
    }
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if ((t & 31) == 0) part[t >> 5] = s;
    __syncthreads();
    float total = 0.f;
    for (int w = 0; w < ROWS_WARPS; ++w) total += part[w];
    __syncthreads();  // part is free again
    return total;
}

__device__ __forceinline__ int itpu_rows_hash(int v) {
    return (int)(((unsigned)v * 2654435761u) >> (32 - ROWS_HASH_BITS));
}

// The "first" gate: whether step s0 + t (t < n) lists its row before any
// other step. The chunk's rows go into an open-addressed table; every step
// up to the chunk's end is looked up there, and a row's slot keeps the
// earliest step that lists it.
__device__ int itpu_rows_first(ItpuRowsChunk& sh, const int* __restrict__ ptr, int s0, int n) {
    const int t = threadIdx.x;
    for (int s = t; s < ROWS_HASH; s += ROWS_THREADS) {
        sh.hkey[s] = ROWS_EMPTY;
        sh.hmin[s] = 0x7fffffff;
    }
    __syncthreads();
    int slot = 0;
    if (t < n) {
        const int v = sh.ptr[t];
        for (slot = itpu_rows_hash(v);; slot = (slot + 1) & (ROWS_HASH - 1)) {
            const int old = atomicCAS(&sh.hkey[slot], ROWS_EMPTY, v);
            if (old == ROWS_EMPTY || old == v) break;
        }
    }
    __syncthreads();
    auto look = [&](int j, int v) {
        for (int s = itpu_rows_hash(v);; s = (s + 1) & (ROWS_HASH - 1)) {
            const int key = sh.hkey[s];
            if (key == v) {
                atomicMin(&sh.hmin[s], j);
                return;
            }
            if (key == ROWS_EMPTY) return;
        }
    };
    const int end = s0 + n;
    const int to_boundary = (int)((16 - (uintptr_t)ptr % 16) % 16 / 4);
    const int head = end < to_boundary ? end : to_boundary;
    if (t < head) look(t, __ldg(ptr + t));
    for (int j = head + 4 * t; j < end; j += 4 * ROWS_THREADS) {
        if (j + 4 <= end) {
            const int4 q = __ldg(reinterpret_cast<const int4*>(ptr + j));
            look(j, q.x);
            look(j + 1, q.y);
            look(j + 2, q.z);
            look(j + 3, q.w);
        } else {
            for (int e = j; e < end; ++e) look(e, __ldg(ptr + e));
        }
    }
    __syncthreads();
    return t < n && sh.hmin[slot] == s0 + t;
}

// The chunk's steps into shared memory, their gates decided, the live ones
// listed in step order, and (the sum tap) each live step's window sum;
// returns the number of live steps. ptr is read only where a map or the
// gate reads it: with static maps a row's address waits on nothing.
template <int TAP, int GATE>
__device__ int itpu_rows_chunk(ItpuRowsChunk& sh, int s0, int n, const int* __restrict__ ptr, bool maps,
                               bool in_place, const int* __restrict__ wv, const int* __restrict__ wu,
                               const int* __restrict__ valid, const float* __restrict__ img, int img_w,
                               int vec_img) {
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    int kind = 0;
    if (t < n) {
        const int i = s0 + t;
        const int p = maps || GATE == PROBE_GATE_PTR || GATE == PROBE_GATE_FIRST ? __ldg(ptr + i) : i;
        sh.ptr[t] = p;
        if (TAP != PROBE_TAP_NONE) {
            sh.wv[t] = __ldg(wv + i);
            sh.wu[t] = __ldg(wu + i);
        }
        kind = 1;
        if (GATE == PROBE_GATE_PTR && p < 0) kind = 0;
        if (GATE == PROBE_GATE_VALID && __ldg(valid + i) <= 0) kind = in_place ? 0 : 2;
    }
    if (GATE == PROBE_GATE_FIRST) {
        __syncthreads();  // sh.ptr
        kind = itpu_rows_first(sh, ptr, s0, n);
    }
    const unsigned live = __ballot_sync(0xffffffffu, kind != 0);
    if (lane == 0) sh.count[warp] = __popc(live);
    __syncthreads();
    int at = __popc(live & ((1u << lane) - 1u)), n_live = 0;
    for (int w = 0; w < ROWS_WARPS; ++w) {
        if (w < warp) at += sh.count[w];
        n_live += sh.count[w];
    }
    if (kind != 0) {
        sh.step[at] = t;
        sh.kind[at] = kind;
    }
    __syncthreads();
    if (TAP == PROBE_TAP_SUM) {
        for (int j = 0; j < n_live; ++j) {
            if (sh.kind[j] != 1) continue;
            const int place = sh.step[j];
            const float s = itpu_rows_window_sum(img, img_w, sh.wv[place] * PROBE_WIN, sh.wu[place] * PROBE_WIN,
                                                 vec_img, sh.part);
            if (t == 0) sh.sum[j] = s;
        }
        __syncthreads();
    }
    return n_live;
}

// A live step element by element, a warp (rows not in 16-byte pieces)
template <typename T, int TAP>
__device__ __forceinline__ void itpu_rows_scalar(const T* in, T* out, int row_len, const ItpuRowsItem& s,
                                                 const float* __restrict__ img, int img_w, float tap_scale,
                                                 float mul) {
    const T* row = in + s.src * row_len;
    T* o = out + s.dst * row_len;
    for (int k = threadIdx.x & 31; k < row_len; k += 32) {
        const T x = row[k];
        T y = x;
        if (s.kind == 1) {
            if constexpr (sizeof(T) == 1) y = (T)((int)x + 1);
            else y = itpu_rows_f32<TAP>(x, itpu_rows_tap<TAP>(img, img_w, s, k), tap_scale, mul);
        }
        o[k] = y;
    }
}

// T float: the affine body; T int8_t: row + 1 with int8 wrap-around (probe13
// sk). vec_rows: in, out and the rows on 16-byte boundaries. A CTA takes
// steps [chunk·blockIdx.x, + chunk), a warp a live step at a time.
template <typename T, int TAP, int GATE>
__global__ void __launch_bounds__(ROWS_THREADS)
itpu_probe_rows_kernel(const void* in_rows, void* out_rows, int row_len, const int* __restrict__ ptr, int n_steps,
                       int chunk, int src_ptr, int dst_ptr, const int* __restrict__ wv, const int* __restrict__ wu,
                       const int* __restrict__ valid, const float* __restrict__ img, int img_w, float tap_scale,
                       float mul, int vec_rows, int vec_img) {
    __shared__ ItpuRowsChunk sh;
    const T* in = (const T*)in_rows;
    T* out = (T*)out_rows;
    const int s0 = blockIdx.x * chunk, n = min(chunk, n_steps - s0);
    const int n_live = itpu_rows_chunk<TAP, GATE>(sh, s0, n, ptr, src_ptr || dst_ptr, in == out, wv, wu, valid, img,
                                                     img_w, vec_img);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (!vec_rows) {
        for (int j = warp; j < n_live; j += ROWS_WARPS)
            itpu_rows_scalar<T, TAP>(in, out, row_len, itpu_rows_item<TAP>(sh, s0, j, src_ptr, dst_ptr), img, img_w,
                                     tap_scale, mul);
        return;
    }
    constexpr bool TAPS = sizeof(T) == 4 && (TAP == PROBE_TAP_BF16 || TAP == PROBE_TAP_F32T);
    const int row_vec = row_len * (int)sizeof(T) / 16, seg_vec = 32 * ROWS_VEC;
    const int n_seg = (row_vec + seg_vec - 1) / seg_vec;
    struct Held {
        uint4 v[ROWS_VEC];
        float tap[4];
    };
    // piece seg·seg_vec + 32c + lane of the row; the lane's taps are those
    // of elements 4·lane … 4·lane + 3 (every piece of a lane has the same k mod 128)
    auto load = [&](int j, int seg, Held& h) {
        const ItpuRowsItem s = itpu_rows_item<TAP>(sh, s0, j, src_ptr, dst_ptr);
        const uint4* row = reinterpret_cast<const uint4*>(in + s.src * row_len) + seg * seg_vec + lane;
        const int left = row_vec - seg * seg_vec - lane;
#pragma unroll
        for (int c = 0; c < ROWS_VEC; ++c)
            if (32 * c < left) h.v[c] = row[32 * c];
        if (TAPS && s.kind == 1) {
#pragma unroll
            for (int e = 0; e < 4; ++e) h.tap[e] = itpu_rows_tap<TAP>(img, img_w, s, 4 * lane + e);
        }
        if (TAP == PROBE_TAP_SUM) h.tap[0] = h.tap[1] = h.tap[2] = h.tap[3] = s.sum;
    };
    auto store = [&](int j, int seg, const Held& h) {
        const ItpuRowsItem s = itpu_rows_item<TAP>(sh, s0, j, src_ptr, dst_ptr);
        uint4* row = reinterpret_cast<uint4*>(out + s.dst * row_len) + seg * seg_vec + lane;
        const int left = row_vec - seg * seg_vec - lane;
#pragma unroll
        for (int c = 0; c < ROWS_VEC; ++c)
            if (32 * c < left)
                row[32 * c] = s.kind == 1 ? itpu_rows_update<T, TAP>(h.v[c], h.tap, tap_scale, mul) : h.v[c];
    };
    // the warp's live steps j = warp, warp + 8, …, each in n_seg pieces of
    // 2 KB; the next one's loads go out before the current one's stores
    Held a, b;
    int j = warp, seg = 0;
    if (j < n_live) load(j, seg, a);
    while (j < n_live) {
        int jn = j, sn = seg + 1;
        if (sn == n_seg) {
            sn = 0;
            jn += ROWS_WARPS;
        }
        if (jn < n_live) load(jn, sn, b);
        store(j, seg, a);
        a = b;
        j = jn;
        seg = sn;
    }
}

typedef void (*ItpuProbeRowsKernel)(const void*, void*, int, const int*, int, int, int, int, const int*, const int*,
                                    const int*, const float*, int, float, float, int, int);

template <int TAP>
static ItpuProbeRowsKernel itpu_probe_rows_f32(int gate) {
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
    ItpuProbeRowsKernel kernel = nullptr;
    if (elem_bytes == 1 && tap == PROBE_TAP_NONE && gate == PROBE_GATE_FIRST)
        kernel = itpu_probe_rows_kernel<int8_t, PROBE_TAP_NONE, PROBE_GATE_FIRST>;
    if (elem_bytes == 4)
        kernel = tap == PROBE_TAP_NONE ? itpu_probe_rows_f32<PROBE_TAP_NONE>(gate)
               : tap == PROBE_TAP_BF16 ? itpu_probe_rows_f32<PROBE_TAP_BF16>(gate)
               : tap == PROBE_TAP_F32T ? itpu_probe_rows_f32<PROBE_TAP_F32T>(gate)
               : tap == PROBE_TAP_SUM ? itpu_probe_rows_f32<PROBE_TAP_SUM>(gate) : nullptr;
    if (kernel == nullptr || (uintptr_t)ptr % 4) return (int)cudaErrorInvalidValue;
    if (n_steps <= 0) return (int)cudaGetLastError();
    const long long row_bytes = (long long)row_len * elem_bytes;
    const int vec_rows = (uintptr_t)in % 16 == 0 && (uintptr_t)out % 16 == 0 && row_bytes % 16 == 0;
    const int vec_img = img != nullptr && (uintptr_t)img % 16 == 0 && img_w % 4 == 0;
    // the steps over the CTAs the card holds at once, at most ROWS_THREADS a CTA
    int dev = 0, per_sm = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, ROWS_THREADS, 0);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    const int resident = per_sm * sms > 0 ? per_sm * sms : 1;
    int chunk = (n_steps + resident - 1) / resident;
    if (chunk > ROWS_THREADS) chunk = ROWS_THREADS;
    kernel<<<(n_steps + chunk - 1) / chunk, ROWS_THREADS, 0, (cudaStream_t)stream>>>(
        in, out, row_len, (const int*)ptr, n_steps, chunk, src_ptr, dst_ptr, (const int*)wv, (const int*)wu,
        (const int*)valid, (const float*)img, img_w, tap_scale, mul, vec_rows, vec_img);
    return (int)cudaGetLastError();
}

// The design the chunks replaced, kept for comparisons (on no path): one
// CTA of 128 threads a step, each thread's loads and stores in turn, the
// "first" gate rescanning the steps before its own.

// the sum of the step's 128×128 window img[wv·128 + a, wu·128 + b], the
// same value in every thread of the CTA
__device__ float itpu_probe_window_sum_simple(const float* img, int img_w, int v0, int u0) {
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

template <typename T, int TAP, int GATE>
__global__ void __launch_bounds__(PROBE_ROW_THREADS)
itpu_probe_rows_simple_kernel(const T* in, T* out, int row_len, const int* __restrict__ ptr, int src_ptr,
                              int dst_ptr, const int* __restrict__ wv, const int* __restrict__ wu,
                              const int* __restrict__ valid, const float* __restrict__ img, int img_w,
                              float tap_scale, float mul) {
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
    if (TAP == PROBE_TAP_SUM) wsum = itpu_probe_window_sum_simple(img, img_w, wv[i] * PROBE_WIN, wu[i] * PROBE_WIN);
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
static ItpuProbeRowsF32 itpu_probe_rows_simple_f32(int gate) {
    return gate == PROBE_GATE_NONE ? itpu_probe_rows_simple_kernel<float, TAP, PROBE_GATE_NONE>
         : gate == PROBE_GATE_VALID ? itpu_probe_rows_simple_kernel<float, TAP, PROBE_GATE_VALID>
         : gate == PROBE_GATE_PTR ? itpu_probe_rows_simple_kernel<float, TAP, PROBE_GATE_PTR> : nullptr;
}

ITPU_EXPORT int itpu_probe_rows_simple(const void* in, void* out, int row_len, int elem_bytes, const void* ptr,
                                       int n_steps, int src_ptr, int dst_ptr, const void* wv, const void* wu,
                                       const void* valid, const void* img, int img_w, int tap, int gate,
                                       float tap_scale, float mul, void* stream) {
    if (n_steps <= 0) return (int)cudaGetLastError();
    cudaStream_t s = (cudaStream_t)stream;
    if (elem_bytes == 1) {
        if (tap != PROBE_TAP_NONE || gate != PROBE_GATE_FIRST) return (int)cudaErrorInvalidValue;
        itpu_probe_rows_simple_kernel<int8_t, PROBE_TAP_NONE, PROBE_GATE_FIRST><<<n_steps, PROBE_ROW_THREADS, 0, s>>>(
            (const int8_t*)in, (int8_t*)out, row_len, (const int*)ptr, src_ptr, dst_ptr, (const int*)wv,
            (const int*)wu, (const int*)valid, (const float*)img, img_w, tap_scale, mul);
        return (int)cudaGetLastError();
    }
    if (elem_bytes != 4) return (int)cudaErrorInvalidValue;
    ItpuProbeRowsF32 kernel = tap == PROBE_TAP_NONE ? itpu_probe_rows_simple_f32<PROBE_TAP_NONE>(gate)
                            : tap == PROBE_TAP_BF16 ? itpu_probe_rows_simple_f32<PROBE_TAP_BF16>(gate)
                            : tap == PROBE_TAP_F32T ? itpu_probe_rows_simple_f32<PROBE_TAP_F32T>(gate)
                            : tap == PROBE_TAP_SUM ? itpu_probe_rows_simple_f32<PROBE_TAP_SUM>(gate) : nullptr;
    if (kernel == nullptr) return (int)cudaErrorInvalidValue;
    kernel<<<n_steps, PROBE_ROW_THREADS, 0, s>>>((const float*)in, (float*)out, row_len, (const int*)ptr, src_ptr,
                                                  dst_ptr, (const int*)wv, (const int*)wu, (const int*)valid,
                                                  (const float*)img, img_w, tap_scale, mul);
    return (int)cudaGetLastError();
}

// --- P3 page gather-sum -------------------------------------------------

#define PAGE_THREADS 128  // a CTA: one tile, 128 columns (float32 with 16-byte pieces: 512)
#define PAGE_LOADS_I8 16  // int8 pages a thread has in flight
#define PAGE_LOADS_F32 8  // float4 pieces of pages a thread has in flight

// The grid is tiles × column blocks. T int8_t: a thread a column, its pages
// loaded PAGE_LOADS_I8 at a time before any is added and summed exactly in
// an int (|Σ| ≤ 256 · 128), converted once and scaled; the CTA's four warps
// read the same 16 sectors of a page, which the L1 serves after the first.
// T float, vec: a thread a float4 of columns, PAGE_LOADS_F32 pages in
// flight, summed in k order. Float pages, rows or columns that are not whole
// 16-byte pieces (vec 0), and hashed float pages: a thread a column, element
// by element.
template <typename T, bool HASHED>
__global__ void __launch_bounds__(PAGE_THREADS)
itpu_probe_page_sum_kernel(const T* __restrict__ pages, int row_len, const int* __restrict__ ids, int ids_stride,
                           int k_pages, float* __restrict__ out, int n_cols, float scale, int vec) {
    __shared__ int sid[PROBE_MAX_PAGES];
    __shared__ long long row_at[PROBE_MAX_PAGES];  // sid[k] · row_len: a load's address is one add
    const int t = blockIdx.x, tid = threadIdx.x, c = blockIdx.y * PAGE_THREADS + tid;
    for (int k = tid; k < k_pages; k += PAGE_THREADS) {
        sid[k] = __ldg(ids + (long long)t * ids_stride + k);
        row_at[k] = (long long)sid[k] * row_len;
    }
    __syncthreads();
    if constexpr (sizeof(T) == 1) {
        if (c >= n_cols) return;
        const int8_t* p = pages + (HASHED ? (17 * c + t) % row_len : c);
        int s = 0, k = 0;
        for (; k + PAGE_LOADS_I8 <= k_pages; k += PAGE_LOADS_I8) {
            int x[PAGE_LOADS_I8];
#pragma unroll
            for (int j = 0; j < PAGE_LOADS_I8; ++j) x[j] = __ldg(p + row_at[k + j]);
#pragma unroll
            for (int j = 0; j < PAGE_LOADS_I8; ++j) s += x[j];
        }
        for (; k < k_pages; ++k) s += __ldg(p + row_at[k]);
        out[(long long)t * n_cols + c] = (float)s * scale;
        return;
    } else if (!HASHED) {
        if (vec) {
            if (4 * c >= n_cols) return;  // c: the thread's float4 of columns
            const float4* rows = reinterpret_cast<const float4*>(pages);
            const int row4 = row_len / 4;
            float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
            int k = 0;
            for (; k + PAGE_LOADS_F32 <= k_pages; k += PAGE_LOADS_F32) {
                float4 v[PAGE_LOADS_F32];
#pragma unroll
                for (int j = 0; j < PAGE_LOADS_F32; ++j) v[j] = __ldg(rows + (long long)sid[k + j] * row4 + c);
#pragma unroll
                for (int j = 0; j < PAGE_LOADS_F32; ++j) {
                    s.x += v[j].x;
                    s.y += v[j].y;
                    s.z += v[j].z;
                    s.w += v[j].w;
                }
            }
            for (; k < k_pages; ++k) {
                const float4 v = __ldg(rows + (long long)sid[k] * row4 + c);
                s.x += v.x;
                s.y += v.y;
                s.z += v.z;
                s.w += v.w;
            }
            reinterpret_cast<float4*>(out)[(long long)t * (n_cols / 4) + c] =
                make_float4(s.x * scale, s.y * scale, s.z * scale, s.w * scale);
            return;
        }
    }
    if (c >= n_cols) return;
    const T* p = pages + (HASHED ? (17 * c + t) % row_len : c);
    float s = 0.f;
    for (int k = 0; k < k_pages; ++k) s += (float)p[row_at[k]];
    out[(long long)t * n_cols + c] = s * scale;
}

ITPU_EXPORT int itpu_probe_page_sum(const void* pages, int row_len, int elem_bytes, const void* ids, int ids_stride,
                                    int k_pages, int n_tiles, void* out, int n_cols, int hashed, float scale,
                                    void* stream) {
    if (k_pages < 0 || k_pages > PROBE_MAX_PAGES) return (int)cudaErrorInvalidValue;
    if (n_tiles <= 0 || n_cols <= 0) return (int)cudaGetLastError();
    cudaStream_t s = (cudaStream_t)stream;
    if (elem_bytes == 4) {
        const int vec = !hashed && (uintptr_t)pages % 16 == 0 && (uintptr_t)out % 16 == 0 && row_len % 4 == 0 &&
                        n_cols % 4 == 0;
        const dim3 grid(n_tiles, (n_cols / (vec ? 4 : 1) + PAGE_THREADS - 1) / PAGE_THREADS);
        auto kernel = hashed ? itpu_probe_page_sum_kernel<float, true> : itpu_probe_page_sum_kernel<float, false>;
        kernel<<<grid, PAGE_THREADS, 0, s>>>((const float*)pages, row_len, (const int*)ids, ids_stride, k_pages,
                                             (float*)out, n_cols, scale, vec);
    } else if (elem_bytes == 1) {
        const dim3 grid(n_tiles, (n_cols + PAGE_THREADS - 1) / PAGE_THREADS);
        auto kernel = hashed ? itpu_probe_page_sum_kernel<int8_t, true> : itpu_probe_page_sum_kernel<int8_t, false>;
        kernel<<<grid, PAGE_THREADS, 0, s>>>((const int8_t*)pages, row_len, (const int*)ids, ids_stride, k_pages,
                                             (float*)out, n_cols, scale, 0);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// The design the one above replaced, kept for comparisons (on no path): a
// thread a column, walking the pages in k order, one element at a time.
template <typename T, bool HASHED>
__global__ void __launch_bounds__(PROBE_ROW_THREADS)
itpu_probe_page_sum_simple_kernel(const T* __restrict__ pages, int row_len, const int* __restrict__ ids,
                                  int ids_stride, int k_pages, float* __restrict__ out, int n_cols, float scale) {
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

ITPU_EXPORT int itpu_probe_page_sum_simple(const void* pages, int row_len, int elem_bytes, const void* ids,
                                           int ids_stride, int k_pages, int n_tiles, void* out, int n_cols,
                                           int hashed, float scale, void* stream) {
    if (k_pages < 0 || k_pages > PROBE_MAX_PAGES) return (int)cudaErrorInvalidValue;
    if (n_tiles <= 0) return (int)cudaGetLastError();
    cudaStream_t s = (cudaStream_t)stream;
    if (elem_bytes == 4) {
        auto kernel = hashed ? itpu_probe_page_sum_simple_kernel<float, true>
                             : itpu_probe_page_sum_simple_kernel<float, false>;
        kernel<<<n_tiles, PROBE_ROW_THREADS, 0, s>>>((const float*)pages, row_len, (const int*)ids, ids_stride,
                                                      k_pages, (float*)out, n_cols, scale);
    } else if (elem_bytes == 1) {
        auto kernel = hashed ? itpu_probe_page_sum_simple_kernel<int8_t, true>
                             : itpu_probe_page_sum_simple_kernel<int8_t, false>;
        kernel<<<n_tiles, PROBE_ROW_THREADS, 0, s>>>((const int8_t*)pages, row_len, (const int*)ids, ids_stride,
                                                      k_pages, (float*)out, n_cols, scale);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}


// --- Hopper's asynchronous copies and barriers (P4, P5) ------------------

__device__ __forceinline__ uint32_t itpu_smem(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void itpu_mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// the barriers' initialisation, seen by the asynchronous copies (then a
// __syncthreads makes it seen by the CTA's threads)
__device__ __forceinline__ void itpu_mbar_fence_init() {
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one arrival that also expects `bytes` more from asynchronous copies
__device__ __forceinline__ void itpu_mbar_expect(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void itpu_mbar_arrive(uint32_t bar) {
    asm volatile("{\n .reg .b64 state;\n mbarrier.arrive.shared::cta.b64 state, [%0];\n}" ::"r"(bar) : "memory");
}

// until the barrier's phase of this parity has completed; a fault that
// leaves a phase open traps after ~2^32 cycles (a few seconds) instead of
// holding the card
__device__ __forceinline__ void itpu_mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done = 0;
    long long start = 0;
    for (;;) {
        asm volatile(
            "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
        if (done) return;
        if (start == 0) start = clock64();
        else if (clock64() - start > (1ll << 32)) __trap();
    }
}

// a box of a 2-D tensor map at (c0 innermost, c1) into shared memory,
// completing its bytes on `bar`; out-of-bounds elements land as zeros
__device__ __forceinline__ void itpu_tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];"
        ::"r"(dst), "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1)
        : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// into shared memory, completing on `bar`
__device__ __forceinline__ void itpu_bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
                 ::"r"(dst), "l"((uint64_t)src), "r"(bytes), "r"(bar)
                 : "memory");
}

// `bytes` from shared into global memory, as a bulk group of its own
__device__ __forceinline__ void itpu_bulk_store(void* dst, uint32_t src, uint32_t bytes) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"((uint64_t)dst), "r"(src), "r"(bytes)
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// until at most N of this thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void itpu_bulk_wait_read() {
    asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

// cudaFuncSetAttribute for `bytes` of dynamic shared memory, once a device
static int itpu_allow_smem(const void* kernel, int bytes, unsigned long long* done) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess || (*done >> dev & 1)) return (int)e;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e == cudaSuccess) *done |= 1ull << dev;
    return (int)e;
}

// --- P4 scaled copy -----------------------------------------------------

// A CTA's block of vec_per_cta float4 goes through a ring of up to
// SCALE_STAGES stages of SCALE_CHUNK bytes (one stage of the whole block when
// it is smaller): one thread keeps a bulk load in flight for every stage
// that is not being scaled or stored, all threads scale a chunk that has
// landed, and one thread stores it back with a bulk copy.
#define SCALE_CHUNK 16384
#define SCALE_STAGES 4
#define SCALE_THREADS 256  // at most; 4 float4 a thread and chunk

// the ring of a block of vec float4: (float4 a stage, chunks, stages)
__host__ __device__ __forceinline__ void itpu_scale_ring(int vec, int& chunk, int& n_chunks, int& stages) {
    chunk = vec < SCALE_CHUNK / 16 ? vec : SCALE_CHUNK / 16;
    n_chunks = (vec + chunk - 1) / chunk;
    stages = n_chunks < SCALE_STAGES ? n_chunks : SCALE_STAGES;
}

__global__ void __launch_bounds__(SCALE_THREADS)
itpu_probe_scale_kernel(const float4* __restrict__ in, float4* __restrict__ out, int vec_per_cta, float mul) {
    extern __shared__ __align__(128) float4 scale_ring[];
    __shared__ __align__(8) uint64_t full[SCALE_STAGES];
    const long long base = (long long)blockIdx.x * vec_per_cta;
    int chunk, n_chunks, stages;
    itpu_scale_ring(vec_per_cta, chunk, n_chunks, stages);
    // chunk c: the block's float4 [c·chunk, min((c + 1)·chunk, vec_per_cta)), in stage c mod stages
    auto load = [&](int c) {
        const int n = min(chunk, vec_per_cta - c * chunk);
        const uint32_t bar = itpu_smem(&full[c % stages]);
        itpu_mbar_expect(bar, n * 16);
        itpu_bulk_load(itpu_smem(scale_ring + (c % stages) * chunk), in + base + (long long)c * chunk, n * 16, bar);
    };
    if (threadIdx.x == 0) {
        for (int s = 0; s < stages; ++s) itpu_mbar_init(itpu_smem(&full[s]), 1);
        itpu_mbar_fence_init();
        for (int c = 0; c < stages; ++c) load(c);
    }
    __syncthreads();
    for (int c = 0; c < n_chunks; ++c) {
        const int s = c % stages, n = min(chunk, vec_per_cta - c * chunk);
        float4* v = scale_ring + s * chunk;
        itpu_mbar_wait(itpu_smem(&full[s]), (c / stages) & 1);
        for (int j = threadIdx.x; j < n; j += blockDim.x) {
            float4 x = v[j];
            x.x = x.x * mul;
            x.y = x.y * mul;
            x.z = x.z * mul;
            x.w = x.w * mul;
            v[j] = x;
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // the scaled chunk, seen by the bulk store
        __syncthreads();
        if (threadIdx.x == 0) {
            itpu_bulk_store(out + base + (long long)c * chunk, itpu_smem(v), n * 16);
            // the stage of chunk c − 1 takes chunk c − 1 + stages once its store has read it
            if (c >= 1 && c - 1 + stages < n_chunks) {
                itpu_bulk_wait_read<1>();
                load(c - 1 + stages);
            }
        }
    }
    if (threadIdx.x == 0) itpu_bulk_wait_read<0>();  // shared memory stays until the stores have read it
}

// n_ctas CTAs of vec_per_cta float4 each (rows_per_cta · row_len / 4)
ITPU_EXPORT int itpu_probe_scale(const void* in, void* out, int n_ctas, int vec_per_cta, float mul, void* stream) {
    static unsigned long long sized = 0;
    if (n_ctas <= 0 || vec_per_cta <= 0) return (int)cudaGetLastError();
    int chunk, n_chunks, stages;
    itpu_scale_ring(vec_per_cta, chunk, n_chunks, stages);
    const int err = itpu_allow_smem((const void*)itpu_probe_scale_kernel, SCALE_STAGES * SCALE_CHUNK, &sized);
    if (err) return err;
    const int threads = ((chunk + 3) / 4 + 31) / 32 * 32;
    itpu_probe_scale_kernel<<<n_ctas, threads < SCALE_THREADS ? threads : SCALE_THREADS, stages * chunk * 16,
                              (cudaStream_t)stream>>>((const float4*)in, (float4*)out, vec_per_cta, mul);
    return (int)cudaGetLastError();
}

// The design the ring replaced, kept for comparisons (on no path): 256
// threads, one float4 load and its store at a time.
__global__ void __launch_bounds__(PROBE_THREADS)
itpu_probe_scale_simple_kernel(const float4* __restrict__ in, float4* __restrict__ out, int vec_per_cta, float mul) {
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

ITPU_EXPORT int itpu_probe_scale_simple(const void* in, void* out, int n_ctas, int vec_per_cta, float mul,
                                        void* stream) {
    if (n_ctas <= 0) return (int)cudaGetLastError();
    itpu_probe_scale_simple_kernel<<<n_ctas, PROBE_THREADS, 0, (cudaStream_t)stream>>>(
        (const float4*)in, (float4*)out, vec_per_cta, mul);
    return (int)cudaGetLastError();
}

// --- P5 bf16 GEMM -------------------------------------------------------

// A CTA computes a 128×256 tile of C. A producer warpgroup (one thread
// issues) keeps GEMM_STAGES stages of A's 128×64 and B's 64×256 tiles in
// flight by TMA; two consumer warpgroups, each 64 rows of the tile, run
// wgmma m64n256k16 on each stage that has landed and hand it back when
// their product of it has retired.
#define GEMM_BM 128
#define GEMM_BN 256
#define GEMM_BK 64
#define GEMM_STAGES 4
#define GEMM_A_BYTES (GEMM_BM * GEMM_BK * 2)  // 16 KB: 128 rows of 64 bf16 (128 bytes, one swizzle row)
#define GEMM_B_BYTES (GEMM_BK * GEMM_BN * 2)  // 32 KB: 4 boxes of 64 k-rows × 64 columns, 8 KB each
#define GEMM_STAGE_BYTES (GEMM_A_BYTES + GEMM_B_BYTES)
#define GEMM_SMEM (GEMM_STAGES * GEMM_STAGE_BYTES + 1024)  // + room to align the ring to 1,024 bytes
#define GEMM_THREADS 384
#define GEMM_B_LBO 8192  // B's descriptor: bytes from one 64-column box to the next (N)
#define GEMM_B_SBO 1024  // both descriptors: bytes from 8 rows (A: m, B: k) to the next 8

// a wgmma shared-memory descriptor with the 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units)
__device__ __forceinline__ uint64_t itpu_gemm_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 | (uint64_t)(sbo >> 4) << 32 | 1ull << 62;
}

#define ITPU_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
                   "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64×256 f32, the wgmma accumulator layout) += A (64×16, K-major) ·
// B (16×256, N-major: the transpose bit) from shared memory
__device__ __forceinline__ void itpu_wgmma_256(float (&d)[128], uint64_t desc_a, uint64_t desc_b) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 1;\n}"
        : ITPU_D8(0), ITPU_D8(8), ITPU_D8(16), ITPU_D8(24), ITPU_D8(32), ITPU_D8(40), ITPU_D8(48), ITPU_D8(56),
          ITPU_D8(64), ITPU_D8(72), ITPU_D8(80), ITPU_D8(88), ITPU_D8(96), ITPU_D8(104), ITPU_D8(112), ITPU_D8(120)
        : "l"(desc_a), "l"(desc_b), "r"(1));
}

// the accumulators, held in place across the asynchronous wgmma for the compiler
__device__ __forceinline__ void itpu_fence_acc(float (&d)[128]) {
#pragma unroll
    for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__global__ void __launch_bounds__(GEMM_THREADS, 1)
itpu_probe_gemm_kernel(__grid_constant__ const CUtensorMap map_a, __grid_constant__ const CUtensorMap map_b,
                       __nv_bfloat16* __restrict__ C, int M, int N, int K) {
    extern __shared__ uint8_t gemm_smem[];
    __shared__ __align__(8) uint64_t full[GEMM_STAGES], empty[GEMM_STAGES];
    const uint32_t raw = itpu_smem(gemm_smem), ring = (raw + 1023) & ~1023u;  // the 128-byte swizzle's alignment
    const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
    const int m0 = blockIdx.y * GEMM_BM, n0 = blockIdx.x * GEMM_BN, n_k = (K + GEMM_BK - 1) / GEMM_BK;
    if (threadIdx.x == 0) {
        for (int s = 0; s < GEMM_STAGES; ++s) {
            itpu_mbar_init(itpu_smem(&full[s]), 1);
            itpu_mbar_init(itpu_smem(&empty[s]), 2);  // one arrival a consumer warpgroup
        }
        itpu_mbar_fence_init();
    }
    __syncthreads();
    if (wg == 0) {  // the producer
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
        if (t == 0) {
            for (int kt = 0; kt < n_k; ++kt) {
                const int s = kt % GEMM_STAGES;
                if (kt >= GEMM_STAGES) itpu_mbar_wait(itpu_smem(&empty[s]), (kt / GEMM_STAGES - 1) & 1);
                const uint32_t a = ring + s * GEMM_STAGE_BYTES, b = a + GEMM_A_BYTES, bar = itpu_smem(&full[s]);
                itpu_mbar_expect(bar, GEMM_STAGE_BYTES);
                itpu_tma_load_2d(a, &map_a, bar, kt * GEMM_BK, m0);
                for (int c = 0; c < GEMM_BN / 64; ++c) itpu_tma_load_2d(b + c * 8192, &map_b, bar, n0 + 64 * c, kt * GEMM_BK);
            }
        }
    } else {  // a consumer: rows 64·(wg − 1) of the tile
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
        const int half = wg - 1;
        float d[128];
#pragma unroll
        for (int i = 0; i < 128; ++i) d[i] = 0.f;
        for (int kt = 0; kt < n_k; ++kt) {
            const int s = kt % GEMM_STAGES;
            itpu_mbar_wait(itpu_smem(&full[s]), (kt / GEMM_STAGES) & 1);
            const uint32_t a = ring + s * GEMM_STAGE_BYTES + half * 64 * 128, b = ring + s * GEMM_STAGE_BYTES + GEMM_A_BYTES;
            itpu_fence_acc(d);
            asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
            for (int kk = 0; kk < GEMM_BK / 16; ++kk)  // A: 32 bytes on in the swizzled row; B: 16 k-rows on
                itpu_wgmma_256(d, itpu_gemm_desc(a + 32 * kk, 16, GEMM_B_SBO),
                               itpu_gemm_desc(b + 16 * 128 * kk, GEMM_B_LBO, GEMM_B_SBO));
            asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
            asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // the stage before has retired
            itpu_fence_acc(d);
            if (kt > 0 && t == 0) itpu_mbar_arrive(itpu_smem(&empty[(kt - 1) % GEMM_STAGES]));
        }
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        itpu_fence_acc(d);
        // the epilogue: both consumers are done with the ring, which now holds
        // each one's 64×256 bf16 tile, 512-byte rows with their 16-byte
        // chunks swizzled (chunk ^ row mod 8) so that neither the stores nor
        // the loads of a warp meet on a bank; then 16-byte stores to C
        asm volatile("bar.sync 1, 256;" ::: "memory");
        uint8_t* tile = gemm_smem + (ring - raw) + half * 64 * 512;
        const int r = 16 * (t / 32) + (t % 32) / 4, q = t % 4;
#pragma unroll
        for (int j = 0; j < 32; ++j) {  // n8 block j: columns 8j + 2q, 8j + 2q + 1 of rows r and r + 8
            *(__nv_bfloat162*)(tile + r * 512 + ((j ^ (r & 7)) * 16) + q * 4) =
                __floats2bfloat162_rn(d[4 * j], d[4 * j + 1]);
            *(__nv_bfloat162*)(tile + (r + 8) * 512 + ((j ^ (r & 7)) * 16) + q * 4) =
                __floats2bfloat162_rn(d[4 * j + 2], d[4 * j + 3]);
        }
        asm volatile("bar.sync %0, 128;" ::"r"(2 + half) : "memory");
        for (int e = t; e < 64 * 32; e += 128) {
            const int row = e / 32, ch = e % 32, gr = m0 + 64 * half + row, gc = n0 + 8 * ch;
            if (gr < M && gc < N)
                *(uint4*)(C + (long long)gr * N + gc) = *(const uint4*)(tile + row * 512 + ((ch ^ (row & 7)) * 16));
        }
    }
}

typedef CUresult (*ItpuEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                    CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, reached through the runtime (the library is not
// linked against the driver); null where the driver lacks it
static ItpuEncodeTiled itpu_encode_tiled() {
    static ItpuEncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                                               &found);
#else
        const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (ItpuEncodeTiled)p;
    }
    return fn;
}

// the tensor map of a row-major bf16 [rows, cols] matrix in boxes of
// box_rows × 64 columns (128 bytes), with the 128-byte swizzle
static int itpu_bf16_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
    const ItpuEncodeTiled encode = itpu_encode_tiled();
    if (encode == nullptr) return (int)cudaErrorNotSupported;
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows}, strides[1] = {(cuuint64_t)cols * 2};
    const cuuint32_t box[2] = {64, (cuuint32_t)box_rows}, unit[2] = {1, 1};
    const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, (void*)base, dims, strides, box, unit,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// the maps of the last few operands: encoding one takes microseconds of
// host time, and a caller often passes the same operands again (a map
// depends only on the address, the shape and the box)
#define GEMM_MAP_CACHE 8

static int itpu_bf16_map_cached(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
    struct Entry {
        const void* base;
        int rows, cols, box_rows;
        CUtensorMap map;
    };
    static Entry cache[GEMM_MAP_CACHE] = {};
    static int next = 0;
    for (const Entry& e : cache)
        if (e.base == base && e.rows == rows && e.cols == cols && e.box_rows == box_rows) {
            *map = e.map;
            return 0;
        }
    const int err = itpu_bf16_map(map, base, rows, cols, box_rows);
    if (!err) {
        cache[next] = {base, rows, cols, box_rows, *map};
        next = (next + 1) % GEMM_MAP_CACHE;
    }
    return err;
}

// N and K multiples of 8 (the tensor maps' 16-byte rows), any M
ITPU_EXPORT int itpu_probe_gemm(const void* a, const void* b, void* c, int m, int n, int k, void* stream) {
    static unsigned long long sized = 0;
    if (m < 0 || n < 0 || k < 0 || n % 8 || k % 8) return (int)cudaErrorInvalidValue;
    if (m == 0 || n == 0) return (int)cudaGetLastError();
    CUtensorMap map_a = {}, map_b = {};  // K = 0: no stage is loaded and the maps are not read; the tile is zeros
    int err = k > 0 ? itpu_bf16_map_cached(&map_a, a, m, k, GEMM_BM) : 0;
    if (!err && k > 0) err = itpu_bf16_map_cached(&map_b, b, k, n, GEMM_BK);
    if (!err) err = itpu_allow_smem((const void*)itpu_probe_gemm_kernel, GEMM_SMEM, &sized);
    if (err) return err;
    itpu_probe_gemm_kernel<<<dim3((n + GEMM_BN - 1) / GEMM_BN, (m + GEMM_BM - 1) / GEMM_BM), GEMM_THREADS, GEMM_SMEM,
                             (cudaStream_t)stream>>>(map_a, map_b, (__nv_bfloat16*)c, m, n, k);
    return (int)cudaGetLastError();
}

// The design the wgmma ring replaced, kept for comparisons (on no path): WMMA 16×16×16
// fragments, a 128×128 tile staged through shared memory 32 deep by the
// threads' own loads, 8 warps of 64×32, no overlap of loads and products.
#define WMMA_BM 128
#define WMMA_BN 128
#define WMMA_BK 32
#define WMMA_PAD 8  // bf16 a shared row, so that the WMMA loads do not meet on one bank
#define WMMA_THREADS 256

__global__ void __launch_bounds__(WMMA_THREADS)
itpu_probe_gemm_wmma_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ B,
                            __nv_bfloat16* __restrict__ C, int M, int N, int K) {
    using namespace nvcuda;
    __shared__ __align__(32) __nv_bfloat16 As[WMMA_BM][WMMA_BK + WMMA_PAD];
    __shared__ __align__(32) __nv_bfloat16 Bs[WMMA_BK][WMMA_BN + WMMA_PAD];
    __shared__ __align__(32) float Cs[WMMA_THREADS / 32][16 * 16];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = warp / 4, wn = warp % 4;  // a warp's 64×32 tile of the CTA's 128×128
    const int m0 = blockIdx.y * WMMA_BM, n0 = blockIdx.x * WMMA_BN;

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
    for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    for (int k0 = 0; k0 < K; k0 += WMMA_BK) {
        // 16 bytes (8 bf16) a thread and load: A's 128×32 tile, B's 32×128
        for (int e = threadIdx.x; e < WMMA_BM * WMMA_BK / 8; e += WMMA_THREADS) {
            const int r = e / (WMMA_BK / 8), c = (e % (WMMA_BK / 8)) * 8;
            *(uint4*)&As[r][c] = *(const uint4*)&A[(long long)(m0 + r) * K + k0 + c];
        }
        for (int e = threadIdx.x; e < WMMA_BK * WMMA_BN / 8; e += WMMA_THREADS) {
            const int r = e / (WMMA_BN / 8), c = (e % (WMMA_BN / 8)) * 8;
            *(uint4*)&Bs[r][c] = *(const uint4*)&B[(long long)(k0 + r) * N + n0 + c];
        }
        __syncthreads();
        for (int kk = 0; kk < WMMA_BK; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[4];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[2];
            for (int i = 0; i < 4; ++i) wmma::load_matrix_sync(af[i], &As[wm * 64 + i * 16][kk], WMMA_BK + WMMA_PAD);
            for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(bf[j], &Bs[kk][wn * 32 + j * 16], WMMA_BN + WMMA_PAD);
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
ITPU_EXPORT int itpu_probe_gemm_wmma(const void* a, const void* b, void* c, int m, int n, int k, void* stream) {
    if (m % WMMA_BM || n % WMMA_BN || k % WMMA_BK) return (int)cudaErrorInvalidValue;
    if (m <= 0 || n <= 0) return (int)cudaGetLastError();
    itpu_probe_gemm_wmma_kernel<<<dim3(n / WMMA_BN, m / WMMA_BM), WMMA_THREADS, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)a, (const __nv_bfloat16*)b, (__nv_bfloat16*)c, m, n, k);
    return (int)cudaGetLastError();
}

// --- P6 window column sums ----------------------------------------------

#define WIN_THREADS 128  // 4 warps: two 64-column tiles a CTA
#define WIN_WARPS (WIN_THREADS / 32)
#define WIN_LOADS 16     // rows a lane loads before it adds them

// A warp takes 32 columns of a tile (item = warp of the grid: tile item /
// warps_per_tile, columns 32 · (item mod warps_per_tile) …), a lane a
// column, its rows summed in r order, WIN_LOADS of them loaded before any is
// added; then the tile's warps store its zero columns [win_w, out_w), in
// float4 where vec_out. ROWS and WPT > 0 are win_h and warps_per_tile known
// when compiled, 0 takes them at run time. The probes' 64 × 64 windows run
// <64, 2>: every group unrolled, so the compiler issues all 64 rows' loads
// before the first add (at run time they took ~1 µs more cold; PERF.md §6).
template <int ROWS, int WPT>
__global__ void __launch_bounds__(WIN_THREADS)
itpu_probe_window_sums_kernel(const float* __restrict__ img, int img_w, const int* __restrict__ starts,
                              int starts_stride, int n_tiles, int win_h, int win_w, float* __restrict__ out,
                              int out_w, int warps_per_tile, int vec_out) {
    const int wpt = WPT > 0 ? WPT : warps_per_tile, rows = ROWS > 0 ? ROWS : win_h;
    const int item = blockIdx.x * WIN_WARPS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
    const int t = item / wpt, g = item - t * wpt;
    if (t >= n_tiles) return;
    const int c = 32 * g + lane;
    float* o = out + (long long)t * out_w;
    const int a = __ldg(starts + (long long)t * starts_stride), b = __ldg(starts + (long long)t * starts_stride + 1);
    if (c < win_w) {
        const float* p = img + (long long)a * img_w + b + c;
        float s = 0.f;
        int r = 0;
        for (; r + WIN_LOADS <= rows; r += WIN_LOADS) {
            float x[WIN_LOADS];
#pragma unroll
            for (int j = 0; j < WIN_LOADS; ++j) x[j] = __ldg(p + (long long)(r + j) * img_w);
#pragma unroll
            for (int j = 0; j < WIN_LOADS; ++j) s += x[j];
        }
        for (; r < rows; ++r) s += __ldg(p + (long long)r * img_w);
        o[c] = s;
    }
    const int step = 32 * wpt;
    if (vec_out) {
        for (int q = win_w / 4 + c; q < out_w / 4; q += step)
            reinterpret_cast<float4*>(o)[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
        for (int z = win_w + c; z < out_w; z += step) o[z] = 0.f;
    }
}

ITPU_EXPORT int itpu_probe_window_sums(const void* img, int img_w, const void* starts, int starts_stride,
                                       int n_tiles, int win_h, int win_w, void* out, int out_w, void* stream) {
    if (win_w < 0 || win_w > out_w) return (int)cudaErrorInvalidValue;
    if (n_tiles <= 0) return (int)cudaGetLastError();
    const int warps_per_tile = win_w > 32 ? (win_w + 31) / 32 : 1;
    const long long warps = (long long)n_tiles * warps_per_tile;
    const int vec_out = (uintptr_t)out % 16 == 0 && out_w % 4 == 0 && win_w % 4 == 0;
    const unsigned int ctas = (unsigned int)((warps + WIN_WARPS - 1) / WIN_WARPS);
    auto kernel = win_h == 64 && warps_per_tile == 2 ? itpu_probe_window_sums_kernel<64, 2>
                                                     : itpu_probe_window_sums_kernel<0, 0>;
    kernel<<<ctas, WIN_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)img, img_w, (const int*)starts, starts_stride, n_tiles, win_h, win_w, (float*)out, out_w,
        warps_per_tile, vec_out);
    return (int)cudaGetLastError();
}

// The design the one above replaced, kept for comparisons (on no path): one
// CTA of 128 threads a tile, a thread a column (threads past win_w store
// the zeros), each row a load after the last one's add.
__global__ void __launch_bounds__(PROBE_ROW_THREADS)
itpu_probe_window_sums_simple_kernel(const float* __restrict__ img, int img_w, const int* __restrict__ starts,
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

ITPU_EXPORT int itpu_probe_window_sums_simple(const void* img, int img_w, const void* starts, int starts_stride,
                                              int n_tiles, int win_h, int win_w, void* out, int out_w,
                                              void* stream) {
    if (n_tiles <= 0) return (int)cudaGetLastError();
    itpu_probe_window_sums_simple_kernel<<<n_tiles, PROBE_ROW_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)img, img_w, (const int*)starts, starts_stride, win_h, win_w, (float*)out, out_w);
    return (int)cudaGetLastError();
}

// --- the L2's read rate -------------------------------------------------

#define L2_READ_THREADS 256
#define L2_READ_LOADS 8  // float4 loads a thread has in flight

// out[cta] = the sum of the float4 at i ≡ cta · L2_READ_THREADS + tid
// (mod gridDim.x · L2_READ_THREADS), read L2_READ_LOADS strides at a time,
// the loads past n predicated off (so a thread's last group is in flight too)
__global__ void __launch_bounds__(L2_READ_THREADS)
itpu_l2_read_kernel(const float4* __restrict__ buf, int n, float* __restrict__ out) {
    __shared__ float part[L2_READ_THREADS / 32];
    const long long stride = (long long)gridDim.x * L2_READ_THREADS;
    float s = 0.f;
    for (long long i = (long long)blockIdx.x * L2_READ_THREADS + threadIdx.x; i < n; i += L2_READ_LOADS * stride) {
        float4 v[L2_READ_LOADS];
#pragma unroll
        for (int j = 0; j < L2_READ_LOADS; ++j)
            v[j] = i + j * stride < n ? __ldg(buf + i + j * stride) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int j = 0; j < L2_READ_LOADS; ++j) s += (v[j].x + v[j].y) + (v[j].z + v[j].w);
    }
    for (int d = 16; d > 0; d >>= 1) s += __shfl_down_sync(0xffffffffu, s, d);
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
        float total = 0.f;
        for (int w = 0; w < L2_READ_THREADS / 32; ++w) total += part[w];
        out[blockIdx.x] = total;
    }
}

ITPU_EXPORT int itpu_l2_read(const void* buf, int n_vec4, int n_ctas, void* out, void* stream) {
    if (n_vec4 < 0 || n_ctas <= 0 || (uintptr_t)buf % 16) return (int)cudaErrorInvalidValue;
    itpu_l2_read_kernel<<<n_ctas, L2_READ_THREADS, 0, (cudaStream_t)stream>>>((const float4*)buf, n_vec4,
                                                                             (float*)out);
    return (int)cudaGetLastError();
}
