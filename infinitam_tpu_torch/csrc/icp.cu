// K1 — ICP residuals fused with the 6×6 normal-equation reduction.
//
// Replaces: the Pallas kernel infinitam_tpu/ops/pallas/icp_kernel.py
// (`residuals_tiles` → `_icp_kernel`), whose 6×6 reduction ran outside the
// kernel (ops/icp.py::reduce_gh). This kernel computes
// ops/icp.py::compute_residuals for each view pixel, reduces the 21
// upper-triangle terms of H = ΣAAᵀ, the 6 terms of ∇ = ΣbA, Σb² and the valid
// count, and writes what icp.gh_from_sums returns: H [6×6], ∇ [6], the energy
// f = √|Σb²|/N when N > min_valid (else the 1e5 sentinel), and N.
//
// What bounds it on the H100: bytes and launch latency. A call reads the
// view depth (1.2 MB at level 0) and taps the [H, W, 4] float32 point and
// normal maps (9.8 MB, both in L2); ~240 flops a pixel are far below the
// card's rate. At the coarse pyramid levels (19,200 / 4,800 / 1,200 pixels)
// a launch is mostly its own latency, and the tracker makes 30 calls a frame.
//
// What the design does about it:
// - One launch per Gauss-Newton iteration. Every CTA writes its 29 partial
//   sums; the last CTA to finish (a ticket from atomicAdd on a counter, after
//   __threadfence) sums the partials in fixed blockIdx order in double,
//   writes the result and resets the counter to 0 for the next launch. The
//   wrapper keeps one counter per device and stream: launches on one stream
//   run one after another, so no two running launches share a counter. No
//   float atomics: a run is bit-reproducible.
// - A grid sized to the card: at most 2 CTAs per SM (the wrapper passes
//   the count), each thread summing its pixels of a fixed grid-stride order
//   in registers before one warp-shuffle and CTA reduction, so the last CTA
//   sums at most a few hundred partials. At the coarse levels the grid is
//   ceil(pixels / 256) CTAs. At 112 registers a thread (ptxas) two CTAs of
//   256 fit an SM, so the capped grid is resident at once; 512-thread CTAs
//   forced to 64 registers spilled and ran slower.
// - The intrinsics and the poses' rows 0-2 are read in the kernel from the
//   caller's tensors, so the wrapper issues no device op besides the launch.
// The maps are read with float4 loads; the scattered taps stay in L2. The
// TPU kernel's one-hot MXU taps, bf16 plane splits and window-miss
// invalidation are not carried over.
//
// Lanes (the batched step): grid (n_ctas, B), blockIdx.y the lane. Each
// lane reads its own depth, weights, maps, intrinsics and poses (stride 0:
// shared), writes its own partials, ticket counter, 43 words and count, and sums
// its n_ctas partials in the same fixed order as a single-lane launch, so
// its result is bit-identical to that launch's. The count N goes to its own
// int32 word (not into the float buffer), so that no dtype view of the
// buffer is needed, which torch.vmap does not batch.
//
// Per-pixel weights (the weighted ICP tracker): with a weight map ω [h, w]
// at the view level's resolution, the kernel is the WITH_WEIGHTS variant of
// the same template and reduces the JAX package's weighted sums
// (ops/icp.py reduce_gh(weights=)), quirks included: H = Σ (ωA)(ωA)ᵀ (ω² on
// H), ∇ = Σ b·(ωA) (ω once), Σ (ωb)² for f, and N the unweighted count. A
// null weight pointer launches the unweighted instantiation, whose code is
// the kernel above unchanged. The weighted call reads h·w·4 more bytes, one
// float a pixel, coalesced like the depth.

#include "common.cuh"

#define ICP_THREADS 256
#define ICP_WARPS (ICP_THREADS / 32)
#define ICP_N_SUMS 29  // 21 upper-triangle H terms, 6 ∇ terms, Σb², count

__device__ __forceinline__ float4 itpu_tap(const float4* img, int hs, int ws, int ix, int iy) {
    ix = min(max(ix, 0), ws - 1);
    iy = min(max(iy, 0), hs - 1);
    return img[iy * ws + ix];
}

// Hole-aware bilinear tap of a [hs, ws, 4] map (ops/pixel.py
// bilinear_with_holes_vec): any corner with w < 0 invalidates the sample.
__device__ __forceinline__ bool itpu_bilinear_holes(const float4* img, int hs, int ws, float x, float y,
                                                    float4& out) {
    const float x0 = floorf(x), y0 = floorf(y);
    const float dx = x - x0, dy = y - y0;
    const int ix = (int)x0, iy = (int)y0;
    const float4 a = itpu_tap(img, hs, ws, ix, iy);
    const float4 b = itpu_tap(img, hs, ws, ix + 1, iy);
    const float4 c = itpu_tap(img, hs, ws, ix, iy + 1);
    const float4 d = itpu_tap(img, hs, ws, ix + 1, iy + 1);
    const float ex = 1.0f - dx, ey = 1.0f - dy;
    out.x = a.x * ex * ey + b.x * dx * ey + c.x * ex * dy + d.x * dx * dy;
    out.y = a.y * ex * ey + b.y * dx * ey + c.y * ex * dy + d.y * dx * dy;
    out.z = a.z * ex * ey + b.z * dx * ey + c.z * ex * dy + d.z * dx * dy;
    out.w = a.w * ex * ey + b.w * dx * ey + c.w * ex * dy + d.w * dx * dy;
    return a.w >= 0.0f && b.w >= 0.0f && c.w >= 0.0f && d.w >= 0.0f;
}

struct ItpuIcpCam {
    float vfx, vfy, vcx, vcy;  // view intrinsics at this level
    float sfx, sfy, scx, scy;  // scene (map) intrinsics
    float inv_pose[12];  // approx_inv_pose rows 0-2
    float scene_pose[12];  // scene_pose rows 0-2
};

// adds pixel i's 29 terms to s when the pixel is valid (weighted by
// weights[i] when WITH_WEIGHTS)
template <bool WITH_WEIGHTS>
__device__ __forceinline__ void itpu_icp_pixel(int i, const float* __restrict__ depth,
                                               const float* __restrict__ weights, int w, const float4* pts,
                                               const float4* nrm, int hs, int ws, const ItpuIcpCam& cam,
                                               float dist_thresh, float (&s)[ICP_N_SUMS]) {
    const int y = i / w, x = i - y * w;
    const float dep = depth[i];
    bool valid = dep > 1e-8f;
    const float d = valid ? dep : 1.0f;
    const float pcx = d * ((float)x - cam.vcx) / cam.vfx;
    const float pcy = d * ((float)y - cam.vcy) / cam.vfy;
    float px, py, pz, qx, qy, qz;
    itpu_transform(cam.inv_pose, pcx, pcy, d, px, py, pz);
    itpu_transform(cam.scene_pose, px, py, pz, qx, qy, qz);
    valid = valid && qz > 0.0f;
    const float zs = valid ? qz : 1.0f;
    const float u = cam.sfx * qx / zs + cam.scx;
    const float v = cam.sfy * qy / zs + cam.scy;
    valid = valid && u >= 0.0f && u <= (float)(ws - 2) && v >= 0.0f && v <= (float)(hs - 2);
    if (!valid) return;
    float4 tp;
    if (!itpu_bilinear_holes(pts, hs, ws, u, v, tp)) return;
    const float dx = tp.x - px, dy = tp.y - py, dz = tp.z - pz;
    if (!(dx * dx + dy * dy + dz * dz <= dist_thresh)) return;
    // the normals' own hole flag is not consulted (reference parity)
    float4 tn;
    itpu_bilinear_holes(nrm, hs, ws, u, v, tn);
    const float b = tn.x * dx + tn.y * dy + tn.z * dz;
    const float A[6] = {tn.y * pz - tn.z * py, tn.z * px - tn.x * pz, tn.x * py - tn.y * px, tn.x, tn.y, tn.z};
    if constexpr (WITH_WEIGHTS) {
        // reduce_gh(weights=): Af = A·ω, bf = b·ω, ∇ from the unweighted b
        const float om = weights[i];
        float wA[6];
#pragma unroll
        for (int r = 0; r < 6; ++r) wA[r] = A[r] * om;
        int k = 0;
#pragma unroll
        for (int r = 0; r < 6; ++r)
#pragma unroll
            for (int c = r; c < 6; ++c) s[k++] += wA[r] * wA[c];
#pragma unroll
        for (int r = 0; r < 6; ++r) s[21 + r] += b * wA[r];
        const float wb = b * om;
        s[27] += wb * wb;
    } else {
        int k = 0;
#pragma unroll
        for (int r = 0; r < 6; ++r)
#pragma unroll
            for (int c = r; c < 6; ++c) s[k++] += A[r] * A[c];
#pragma unroll
        for (int r = 0; r < 6; ++r) s[21 + r] += b * A[r];
        s[27] += b * b;
    }
    s[28] += 1.0f;
}

// partial: [gridDim.x, 29] scratch; counter: the stream's ticket counter (0
// between launches); out: H [6×6] row-major, ∇ [6], f; count: N;
// weights: [h, w], read only by the WITH_WEIGHTS variant
template <bool WITH_WEIGHTS>
__global__ void __launch_bounds__(ICP_THREADS)
itpu_icp_kernel(const float* __restrict__ depth, const float* __restrict__ weights, int h, int w,
                const float4* __restrict__ pts,
                const float4* __restrict__ nrm, int hs, int ws, const float* __restrict__ view_proj,
                const float* __restrict__ scene_proj, const float* __restrict__ inv_pose,
                const float* __restrict__ scene_pose, float dist_thresh, int min_valid, float* partial,
                unsigned int* counter, float* __restrict__ out, int* __restrict__ count, ItpuLanes ln) {
    // this CTA's lane: strides in elements, in itpu_icp_gh's order
    const long long lane_id = blockIdx.y;
    depth += lane_id * ln.s[0];
    if (WITH_WEIGHTS) weights += lane_id * ln.s[1];
    pts = reinterpret_cast<const float4*>(reinterpret_cast<const float*>(pts) + lane_id * ln.s[2]);
    nrm = reinterpret_cast<const float4*>(reinterpret_cast<const float*>(nrm) + lane_id * ln.s[3]);
    view_proj += lane_id * ln.s[4];
    scene_proj += lane_id * ln.s[5];
    inv_pose += lane_id * ln.s[6];
    scene_pose += lane_id * ln.s[7];
    partial += lane_id * gridDim.x * ICP_N_SUMS;
    counter += lane_id;
    out += lane_id * 43;
    count += lane_id;
    ItpuIcpCam cam;
    cam.vfx = view_proj[0], cam.vfy = view_proj[1], cam.vcx = view_proj[2], cam.vcy = view_proj[3];
    cam.sfx = scene_proj[0], cam.sfy = scene_proj[1], cam.scx = scene_proj[2], cam.scy = scene_proj[3];
#pragma unroll
    for (int k = 0; k < 12; ++k) {
        cam.inv_pose[k] = inv_pose[k];
        cam.scene_pose[k] = scene_pose[k];
    }
    float s[ICP_N_SUMS];
#pragma unroll
    for (int k = 0; k < ICP_N_SUMS; ++k) s[k] = 0.0f;
    const int n = h * w;
    for (int i = blockIdx.x * ICP_THREADS + threadIdx.x; i < n; i += gridDim.x * ICP_THREADS)
        itpu_icp_pixel<WITH_WEIGHTS>(i, depth, weights, w, pts, nrm, hs, ws, cam, dist_thresh, s);

    // this CTA's sums: warp shuffles, then one thread per sum over the warps
    __shared__ float sh[ICP_WARPS][ICP_N_SUMS];
    __shared__ bool is_last;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < ICP_N_SUMS; ++k) {
        float t = s[k];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) t += __shfl_down_sync(0xffffffffu, t, off);
        if (lane == 0) sh[warp][k] = t;
    }
    __syncthreads();
    if (threadIdx.x < ICP_N_SUMS) {
        float t = 0.0f;
        for (int wi = 0; wi < ICP_WARPS; ++wi) t += sh[wi][threadIdx.x];
        partial[blockIdx.x * ICP_N_SUMS + threadIdx.x] = t;
        __threadfence();  // the partial is visible device-wide before the ticket
    }
    __syncthreads();
    if (threadIdx.x == 0) is_last = atomicAdd(counter, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!is_last) return;

    // the last CTA: each warp sums its share of the 29 terms over the
    // partials in double, lanes striding over blockIdx, then a fixed tree
    __shared__ double tot[ICP_N_SUMS];
    for (int k = warp; k < ICP_N_SUMS; k += ICP_WARPS) {
        double t = 0.0;
        for (int b = lane; b < gridDim.x; b += 32) t += (double)__ldcg(partial + b * ICP_N_SUMS + k);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) t += __shfl_down_sync(0xffffffffu, t, off);
        if (lane == 0) tot[k] = t;
    }
    __syncthreads();
    const int k = threadIdx.x;
    if (k < 21) {
        int r = 0, base = 0;  // upper-triangle index k → (r, c)
        while (k >= base + 6 - r) base += 6 - r++;
        const int c = r + (k - base);
        out[r * 6 + c] = out[c * 6 + r] = (float)tot[k];
    } else if (k < 27) {
        out[36 + (k - 21)] = (float)tot[k];
    } else if (k == 27) {
        // gh_from_sums: f = √|Σb²| / N when N > min_valid, else 1e5
        const int n_valid = (int)tot[28];
        const float sum_f = (float)tot[27];
        out[42] = n_valid > min_valid ? sqrtf(fabsf(sum_f)) / (float)max(n_valid, 1) : 1e5f;
        *count = n_valid;
        *counter = 0u;  // ready for the next launch
    }
}

// weights: a [h, w] float32 map, or null for the unweighted kernel.
// n_lanes lanes; partial [n_lanes, n_ctas, 29], counter [n_lanes] (0
// between launches), out [n_lanes, 43], count [n_lanes]; strides: depth,
// weights, points, normals, view_proj, scene_proj, inv_pose, scene_pose
ITPU_EXPORT int itpu_icp_gh(const void* depth, const void* weights, int h, int w, const void* pts, const void* nrm,
                            int hs, int ws, const void* view_proj, const void* scene_proj, const void* inv_pose,
                            const void* scene_pose, float dist_thresh, int min_valid, int n_ctas, void* partial,
                            void* counter, void* out, void* count, int n_lanes, const long long* strides,
                            void* stream) {
    if (n_lanes <= 0) return (int)cudaGetLastError();
    auto kernel = weights ? itpu_icp_kernel<true> : itpu_icp_kernel<false>;
    kernel<<<dim3(n_ctas, n_lanes), ICP_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)depth, (const float*)weights, h, w, (const float4*)pts, (const float4*)nrm, hs, ws,
        (const float*)view_proj, (const float*)scene_proj, (const float*)inv_pose, (const float*)scene_pose,
        dist_thresh, min_valid, (float*)partial, (unsigned int*)counter, (float*)out, (int*)count,
        itpu_lanes(strides, 8));
    return (int)cudaGetLastError();
}
