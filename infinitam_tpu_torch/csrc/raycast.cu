// K3 — per-pixel raycast of the TSDF through the dense block grid.
//
// Replaces: the Pallas kernel infinitam_tpu/ops/pallas/raycast_kernel.py
// (`raycast_tiles` → `_raycast_kernel`). This kernel reproduces the JAX
// package's XLA oracle instead, ops/raycast.py::pixel_rays + raycast_rays
// over engine/hash_volume.py::make_grid_reader: the ray of each pixel from
// its depth range, block lookup through the dense cell → VBA-row grid, the
// full int16 sdf, an uninterpolated march that steps max(sdf·μ/voxel, 1)
// inside allocated blocks and to the current block's exit (clamped to
// [0.5, block]) through empty space, stopping at the first sdf ≤ 0 or when
// the ray passes its own len_end; then one secant step and two trilinear
// refinement steps.
//
// What bounds it on the H100: the march's dependent loads and instructions,
// not bytes. A march step is a voxel load whose address comes from a grid
// load, and ~40 instructions; a warp runs until its longest ray ends. The
// bytes are few (the ranges, the points out, the ≤ 3 MB grid and the voxels
// of the visible blocks, 12-25 MB a frame), but the rays take 11 steps on
// average at 5 mm and 40 at 1 cm, where the operations bound it.
//
// What the design does about it:
// - The ray is built in the kernel from (x, y), proj, inv_M and the pixel's
//   zmin / zmax, with pixel_rays' float32 ops in its order (camera
//   transforms by itpu_transform, each norm as the FMA chain
//   fma(z, z, fma(y, y, x·x)) and a correctly rounded root, as XLA rounds
//   jnp.linalg.norm on the CPU), so no precomputed 32-byte ray is written and
//   read back and the caller issues no ray ops.
// - The march keeps its current block's coordinates and VBA row in
//   registers and reads the grid only when the integer voxel enters another
//   block: a step of 1-4 voxels in an 8-voxel block is then one voxel load.
// - The trilinear refinement resolves the block of the (ix, iy, iz) corner
//   once (usually the march's cached block) and looks up a neighbour only
//   for corners across a block face; the 8 voxel loads then issue together.
// - A CTA of 128 threads covers a 16×8 pixel tile and each warp an 8×4
//   tile, so a warp's rays read the same blocks and end after similar step
//   counts (a warp runs until its longest ray ends).
// - Grid and voxels go through the read-only cache (__ldg). No occupancy
//   setting: at 42 registers a thread (ptxas) the card holds 16 CTAs per
//   SM, and the 2,400 CTAs of a 640×480 frame fill it 1.1 times.
// - Inside an allocated block the step is max(sdf·μ/voxel, 1), so the
//   three divisions of the distance to the block's exit run only in empty
//   space, where that distance is the step; p / 2ᵏ is computed as p · 2⁻ᵏ,
//   which rounds identically.
// - `enable`, a device bool or null (on): when it is false each thread
//   returns before its ray, so the approximate raycast decides on the card
//   whether to march (the output keeps what it held) and the launch count
//   does not depend on the data.
// Built with -fmad=false, so each ray and each step round like the plain
// version's separate ops (hit mask equal, points within 4e-6 voxel).
// The TPU kernel's page lists, one-hot MXU taps and 8-bit sdf are not
// carried over.

#include <climits>

#include "common.cuh"

#define RC_THREADS 128  // one 16×8 pixel tile, four warps of 8×4 pixels
#define RC_TILE_W 16
#define RC_TILE_H 8

struct ItpuGrid {
    const int* vox;
    const int* grid;
    int gx, gy, gz, ox, oy, oz;
    int shift;  // block edge S = 1 << shift voxels
};

// VBA row of block (bx, by, bz); −1 when unallocated or outside the grid
__device__ __forceinline__ int itpu_block_ptr(const ItpuGrid& g, int bx, int by, int bz) {
    const int cx = bx - g.ox, cy = by - g.oy, cz = bz - g.oz;
    if (cx < 0 || cx >= g.gx || cy < 0 || cy >= g.gy || cz < 0 || cz >= g.gz) return -1;
    return __ldg(g.grid + (cx * g.gy + cy) * g.gz + cz);
}

// sdf of voxel (lx, ly, lz) of the block at VBA row ptr; empty space (ptr < 0)
// reads 1, as make_grid_reader
__device__ __forceinline__ float itpu_sdf(const ItpuGrid& g, int ptr, int lx, int ly, int lz) {
    if (ptr < 0) return 1.0f;
    const int lin = lx + ((ly + (lz << g.shift)) << g.shift);
    return (float)(__ldg(g.vox + ((long long)ptr << (3 * g.shift)) + lin) >> 16) * ITPU_INV_SDF_SCALE;
}

// the block a ray is in, and its VBA row
struct ItpuBlockCache {
    int bx, by, bz, ptr;
};

__device__ __forceinline__ int itpu_cached_ptr(const ItpuGrid& g, ItpuBlockCache& c, int bx, int by, int bz) {
    if (bx != c.bx || by != c.by || bz != c.bz) {
        c.bx = bx;
        c.by = by;
        c.bz = bz;
        c.ptr = itpu_block_ptr(g, bx, by, bz);
    }
    return c.ptr;
}

// trilinear sdf over the 8 voxels around p (voxel_access.read_sdf_interpolated):
// the corner blocks are resolved first, a neighbour only across a block face
__device__ __forceinline__ float itpu_read_interpolated(const ItpuGrid& g, ItpuBlockCache& c, float px, float py,
                                                        float pz) {
    const float fx = floorf(px), fy = floorf(py), fz = floorf(pz);
    const float cx = px - fx, cy = py - fy, cz = pz - fz;
    const int ix = (int)fx, iy = (int)fy, iz = (int)fz;
    const int m = (1 << g.shift) - 1;
    const int bx = ix >> g.shift, by = iy >> g.shift, bz = iz >> g.shift;
    const int lx = ix & m, ly = iy & m, lz = iz & m;
    const bool ex = lx == m, ey = ly == m, ez = lz == m;  // the +1 corner lies in the next block
    const int lx1 = (lx + 1) & m, ly1 = (ly + 1) & m, lz1 = (lz + 1) & m;
    const int p000 = itpu_cached_ptr(g, c, bx, by, bz);
    const int p100 = ex ? itpu_block_ptr(g, bx + 1, by, bz) : p000;
    const int p010 = ey ? itpu_block_ptr(g, bx, by + 1, bz) : p000;
    const int p001 = ez ? itpu_block_ptr(g, bx, by, bz + 1) : p000;
    const int p110 = ex ? (ey ? itpu_block_ptr(g, bx + 1, by + 1, bz) : p100) : p010;
    const int p101 = ex ? (ez ? itpu_block_ptr(g, bx + 1, by, bz + 1) : p100) : p001;
    const int p011 = ey ? (ez ? itpu_block_ptr(g, bx, by + 1, bz + 1) : p010) : p001;
    const int p111 = ex ? (ey ? (ez ? itpu_block_ptr(g, bx + 1, by + 1, bz + 1) : p110) : p101) : p011;
    const float v000 = itpu_sdf(g, p000, lx, ly, lz);
    const float v100 = itpu_sdf(g, p100, lx1, ly, lz);
    const float v010 = itpu_sdf(g, p010, lx, ly1, lz);
    const float v110 = itpu_sdf(g, p110, lx1, ly1, lz);
    const float v001 = itpu_sdf(g, p001, lx, ly, lz1);
    const float v101 = itpu_sdf(g, p101, lx1, ly, lz1);
    const float v011 = itpu_sdf(g, p011, lx, ly1, lz1);
    const float v111 = itpu_sdf(g, p111, lx1, ly1, lz1);
    const float r00 = (1.0f - cx) * v000 + cx * v100;
    const float r10 = (1.0f - cx) * v010 + cx * v110;
    const float r01 = (1.0f - cx) * v001 + cx * v101;
    const float r11 = (1.0f - cx) * v011 + cx * v111;
    const float r0 = (1.0f - cy) * r00 + cy * r10;
    const float r1 = (1.0f - cy) * r01 + cy * r11;
    return (1.0f - cz) * r0 + cz * r1;
}

// camera point (dx·z, dy·z, z) → world voxel units (pixel_rays to_world_voxels)
__device__ __forceinline__ void itpu_to_world_voxels(const float* M, float dx, float dy, float z, float inv_voxel,
                                                     float& ox, float& oy, float& oz) {
    itpu_transform(M, dx * z, dy * z, z, ox, oy, oz);
    ox = ox * inv_voxel;
    oy = oy * inv_voxel;
    oz = oz * inv_voxel;
}

// √(x² + y² + z²) as pixel_rays' norm3 rounds it: explicit FMAs (which
// -fmad=false leaves alone) and sqrtf, correctly rounded without fast math
__device__ __forceinline__ float itpu_norm3(float x, float y, float z) {
    return sqrtf(__fmaf_rn(z, z, __fmaf_rn(y, y, x * x)));
}

// ray length to depth z in voxel units (pixel_rays length)
__device__ __forceinline__ float itpu_ray_length(float dx, float dy, float z, float inv_voxel) {
    return itpu_norm3(dx * z, dy * z, z) * inv_voxel;
}

// inv_M: camera→world [4, 4] row-major; proj: (fx, fy, cx, cy); zmin, zmax:
// [h, w]; out: [h, w, 4]
__global__ void itpu_raycast_kernel(ItpuGrid g, const float* __restrict__ inv_M, const float* __restrict__ proj,
                                    float inv_voxel, const float* __restrict__ zmin, const float* __restrict__ zmax,
                                    int h, int w, float step_scale, const bool* __restrict__ enable,
                                    float* __restrict__ out) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int x = blockIdx.x * RC_TILE_W + (warp & 1) * 8 + (lane & 7);
    const int y = blockIdx.y * RC_TILE_H + (warp >> 1) * 4 + (lane >> 3);
    if (x >= w || y >= h || (enable != nullptr && !*enable)) return;
    const int i = y * w + x;

    float M[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) M[k] = __ldg(inv_M + k);
    const float pdx = ((float)x - __ldg(proj + 2)) / __ldg(proj);
    const float pdy = ((float)y - __ldg(proj + 3)) / __ldg(proj + 1);
    const float z0 = zmin[i], z1 = zmax[i];
    float px, py, pz, qx, qy, qz;
    itpu_to_world_voxels(M, pdx, pdy, z0, inv_voxel, px, py, pz);
    itpu_to_world_voxels(M, pdx, pdy, z1, inv_voxel, qx, qy, qz);
    float dx = qx - px, dy = qy - py, dz = qz - pz;
    const float norm = fmaxf(itpu_norm3(dx, dy, dz), 1e-12f);
    dx = dx / norm;
    dy = dy / norm;
    dz = dz / norm;
    float total = itpu_ray_length(pdx, pdy, z0, inv_voxel);
    const float end = itpu_ray_length(pdx, pdy, z1, inv_voxel);

    const float S = (float)(1 << g.shift);
    const float inv_S = 1.0f / S;  // exact: p · 2⁻ᵏ rounds as p / 2ᵏ
    const int m = (1 << g.shift) - 1;
    const bool tx = fabsf(dx) < 1e-9f, ty = fabsf(dy) < 1e-9f, tz = fabsf(dz) < 1e-9f;
    const float sx = tx ? 1e-9f : dx, sy = ty ? 1e-9f : dy, sz = tz ? 1e-9f : dz;
    const float ux = dx > 0.0f ? 1.0f : 0.0f, uy = dy > 0.0f ? 1.0f : 0.0f, uz = dz > 0.0f ? 1.0f : 0.0f;
    ItpuBlockCache cache{INT_MIN, INT_MIN, INT_MIN, -1};
    float sdf = 1.0f;
    // every ray takes at least one step, as in the lock-step oracle; the loop
    // ends at a hit or when `total` passes len_end (each step is ≥ 0.5 voxel)
    while (true) {
        const int vx = (int)floorf(px + 0.5f), vy = (int)floorf(py + 0.5f), vz = (int)floorf(pz + 0.5f);
        const int ptr = itpu_cached_ptr(g, cache, vx >> g.shift, vy >> g.shift, vz >> g.shift);
        const bool found = ptr >= 0;
        const float s = itpu_sdf(g, ptr, vx & m, vy & m, vz & m);
        sdf = s;
        if (found && s <= 0.0f) break;
        float step;
        if (found) {
            step = fmaxf(s * step_scale, 1.0f);
        } else {  // to the block's exit: the divisions only where they are used
            const float ax = tx ? 1e9f : ((floorf(px * inv_S) + ux) * S - px) / sx;
            const float ay = ty ? 1e9f : ((floorf(py * inv_S) + uy) * S - py) / sy;
            const float az = tz ? 1e9f : ((floorf(pz * inv_S) + uz) * S - pz) / sz;
            const float t_exit = fminf(fminf(ax, ay), az);
            step = fminf(fmaxf(t_exit + 0.01f, 0.5f), S);
        }
        px = px + step * dx;
        py = py + step * dy;
        pz = pz + step * dz;
        total = total + step;
        if (!(total < end)) break;
    }
    float4 o;
    if (sdf <= 0.0f) {
        float rx = px + (sdf * step_scale) * dx, ry = py + (sdf * step_scale) * dy, rz = pz + (sdf * step_scale) * dz;
        const float r1 = itpu_read_interpolated(g, cache, rx, ry, rz) * step_scale;
        rx = rx + r1 * dx;
        ry = ry + r1 * dy;
        rz = rz + r1 * dz;
        const float r2 = itpu_read_interpolated(g, cache, rx, ry, rz) * step_scale;
        o = make_float4(rx + r2 * dx, ry + r2 * dy, rz + r2 * dz, 1.0f);
    } else {
        o = make_float4(px, py, pz, 0.0f);
    }
    reinterpret_cast<float4*>(out)[i] = o;
}

ITPU_EXPORT int itpu_raycast(const void* vox, const void* grid, int gx, int gy, int gz, int ox, int oy, int oz,
                             int block_shift, const void* inv_M, const void* proj, float inv_voxel, const void* zmin,
                             const void* zmax, int h, int w, float step_scale, const void* enable, void* out,
                             void* stream) {
    if (h > 0 && w > 0) {
        const ItpuGrid g{(const int*)vox, (const int*)grid, gx, gy, gz, ox, oy, oz, block_shift};
        const dim3 tiles((w + RC_TILE_W - 1) / RC_TILE_W, (h + RC_TILE_H - 1) / RC_TILE_H);
        itpu_raycast_kernel<<<tiles, RC_THREADS, 0, (cudaStream_t)stream>>>(
            g, (const float*)inv_M, (const float*)proj, inv_voxel, (const float*)zmin, (const float*)zmax, h, w,
            step_scale, (const bool*)enable, (float*)out);
    }
    return (int)cudaGetLastError();
}
