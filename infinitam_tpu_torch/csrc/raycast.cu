// K3 — per-pixel raycast of the TSDF, with three readers of the volume:
// K3 through the dense block grid, K3h through the hash table (a chain walk
// per block, `use_block_grid=False`) and K3d over the dense voxel array
// (engine/volume.py). The march, the ray construction and the refinement
// are one template over the reader; only the reader differs.
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
//
// K3h replaces the JAX package's XLA march over hash_volume.py
// make_hash_reader (hash_pipeline.py raycast_hash without the block grid):
// a block's VBA row comes from the reference hash
// ((x·73856093) ^ (y·19349669) ^ (z·83492791)) & mask in uint32 arithmetic
// and a walk of the bucket entry and at most MAX_PROBE − 1 = 3 excess links
// (next = n_buckets + offset − 1; offset 0 ends the chain), matching on the
// position and ptr ≥ 0, so swapped-out entries read as empty, as
// hash_volume.probe(include_swapped=False) does. It finds blocks outside any
// grid window. The cached block keeps the walk to block changes, and the
// refinement walks only for corners across a block face. Its extra bound:
// the 20 bytes (pos 12, ptr 4, offset 4) of each entry a walk touches.
//
// K3d replaces the XLA march over volume.py make_dense_reader
// (dense_pipeline.py raycast_dense): a float32 sdf at [z, y, x] after the
// offset; a voxel in the array is found (an empty one reads 1.0, so the
// step is max(μ/voxel, 1)), one outside reads (1.0, not found) and takes the
// DDA step to the exit of its 8-voxel virtual block; refinement corners
// beyond the array's faces read 1.0. No block is cached: a read is one
// bounds test and one load.

// Lanes (the batched step): the tiles × B grid, blockIdx.z the lane. Each
// lane marches its own volume (the reader's arrays moved on to the lane)
// from its own camera, ranges and enable flag into its own output; a stride
// of 0 shares an argument (the intrinsics). The lane's rays are those of a
// single-lane launch, step for step. The lane offsets are a compile-time
// switch (LANES), on for B > 1 only, so B = 1 runs the kernel as it was:
// offsetting the reader and the arrays in every launch took the B = 1
// kernel 3.8% (K3) and 3.8-8.9% (K3d) longer, in one run on the card with
// the kernel without lanes (tools/lane_kernel_probe.py).

#include <climits>

#include "common.cuh"

#define RC_THREADS 128  // one 16×8 pixel tile, four warps of 8×4 pixels
#define RC_TILE_W 16
#define RC_TILE_H 8
#define ITPU_MAX_PROBE 4  // hash_volume.MAX_PROBE: the bucket entry and 3 excess links

// the trilinear blend of voxel_access.read_sdf_interpolated, corner vXYZ at
// (x, y, z) offsets, in its order of ops
__device__ __forceinline__ float itpu_trilinear(float v000, float v100, float v010, float v110, float v001,
                                                float v101, float v011, float v111, float cx, float cy, float cz) {
    const float r00 = (1.0f - cx) * v000 + cx * v100;
    const float r10 = (1.0f - cx) * v010 + cx * v110;
    const float r01 = (1.0f - cx) * v001 + cx * v101;
    const float r11 = (1.0f - cx) * v011 + cx * v111;
    const float r0 = (1.0f - cy) * r00 + cy * r10;
    const float r1 = (1.0f - cy) * r01 + cy * r11;
    return (1.0f - cz) * r0 + cz * r1;
}

// the dense block grid: a block's VBA row is one load; −1 when unallocated
// or outside the grid
struct ItpuGridIndex {
    const int* grid;
    int gx, gy, gz, ox, oy, oz;

    // strides after the raycast's own six: vox (s[6]), then the grid
    __device__ __forceinline__ void to_lane(long long b, const ItpuLanes& ln) { grid += b * ln.s[7]; }

    __device__ __forceinline__ int ptr(int bx, int by, int bz) const {
        const int cx = bx - ox, cy = by - oy, cz = bz - oz;
        if (cx < 0 || cx >= gx || cy < 0 || cy >= gy || cz < 0 || cz >= gz) return -1;
        return __ldg(grid + (cx * gy + cy) * gz + cz);
    }
};

// the hash table: the block's VBA row by a walk of its chain (ops/hashing.py
// hash_index, hash_volume.probe with include_swapped=False); −1 when no
// resident entry matches
struct ItpuHashIndex {
    const int* entry_pos;  // [E, 3]
    const int* entry_ptr;  // [E]
    const int* entry_offset;  // [E]
    int n_buckets;
    unsigned mask;

    // strides after vox (s[6]): entry_pos, entry_ptr, entry_offset
    __device__ __forceinline__ void to_lane(long long b, const ItpuLanes& ln) {
        entry_pos += b * ln.s[7];
        entry_ptr += b * ln.s[8];
        entry_offset += b * ln.s[9];
    }

    __device__ __forceinline__ int ptr(int bx, int by, int bz) const {
        // uint32 products wrap as the reference's do (int32 would overflow)
        int cur = (int)((((unsigned)bx * 73856093u) ^ ((unsigned)by * 19349669u) ^ ((unsigned)bz * 83492791u)) & mask);
#pragma unroll
        for (int k = 0; k < ITPU_MAX_PROBE; ++k) {
            const int* pos = entry_pos + 3LL * cur;
            const int p = __ldg(entry_ptr + cur);
            if (p >= 0 && __ldg(pos) == bx && __ldg(pos + 1) == by && __ldg(pos + 2) == bz) return p;
            const int off = __ldg(entry_offset + cur);
            if (off < 1) return -1;
            cur = n_buckets + off - 1;
        }
        return -1;
    }
};

// the block a ray is in, and its VBA row
struct ItpuBlockCache {
    int bx, by, bz, ptr;
};

// a voxel-block volume (int32 words sdf << 16 | w << 8, blocks of S³ = 2^(3·shift)
// voxels at their VBA rows) read through `Index`: K3 with the grid, K3h with
// the hash
template <class Index>
struct ItpuBlockReader {
    Index index;
    const int* vox;
    int shift;  // block edge S = 1 << shift voxels
    using Cache = ItpuBlockCache;

    __device__ __forceinline__ void to_lane(long long b, const ItpuLanes& ln) {
        vox += b * ln.s[6];
        index.to_lane(b, ln);
    }

    __device__ __forceinline__ Cache fresh() const { return Cache{INT_MIN, INT_MIN, INT_MIN, -1}; }

    __device__ __forceinline__ int cached_ptr(Cache& c, int bx, int by, int bz) const {
        if (bx != c.bx || by != c.by || bz != c.bz) {
            c.bx = bx;
            c.by = by;
            c.bz = bz;
            c.ptr = index.ptr(bx, by, bz);
        }
        return c.ptr;
    }

    // sdf of voxel (lx, ly, lz) of the block at VBA row ptr; empty space
    // (ptr < 0) reads 1, as make_grid_reader and make_hash_reader
    __device__ __forceinline__ float sdf(int ptr, int lx, int ly, int lz) const {
        if (ptr < 0) return 1.0f;
        const int lin = lx + ((ly + (lz << shift)) << shift);
        return (float)(__ldg(vox + ((long long)ptr << (3 * shift)) + lin) >> 16) * ITPU_INV_SDF_SCALE;
    }

    // the march's read of integer voxel (vx, vy, vz): sdf, and found = the
    // block is resident
    __device__ __forceinline__ float read(Cache& c, int vx, int vy, int vz, bool& found) const {
        const int m = (1 << shift) - 1;
        const int ptr = cached_ptr(c, vx >> shift, vy >> shift, vz >> shift);
        found = ptr >= 0;
        return sdf(ptr, vx & m, vy & m, vz & m);
    }

    // trilinear sdf over the 8 voxels around p (voxel_access.read_sdf_interpolated):
    // the corner blocks are resolved first, a neighbour only across a block face
    __device__ __forceinline__ float interpolated(Cache& c, float px, float py, float pz) const {
        const float fx = floorf(px), fy = floorf(py), fz = floorf(pz);
        const float cx = px - fx, cy = py - fy, cz = pz - fz;
        const int ix = (int)fx, iy = (int)fy, iz = (int)fz;
        const int m = (1 << shift) - 1;
        const int bx = ix >> shift, by = iy >> shift, bz = iz >> shift;
        const int lx = ix & m, ly = iy & m, lz = iz & m;
        const bool ex = lx == m, ey = ly == m, ez = lz == m;  // the +1 corner lies in the next block
        const int lx1 = (lx + 1) & m, ly1 = (ly + 1) & m, lz1 = (lz + 1) & m;
        const int p000 = cached_ptr(c, bx, by, bz);
        const int p100 = ex ? index.ptr(bx + 1, by, bz) : p000;
        const int p010 = ey ? index.ptr(bx, by + 1, bz) : p000;
        const int p001 = ez ? index.ptr(bx, by, bz + 1) : p000;
        const int p110 = ex ? (ey ? index.ptr(bx + 1, by + 1, bz) : p100) : p010;
        const int p101 = ex ? (ez ? index.ptr(bx + 1, by, bz + 1) : p100) : p001;
        const int p011 = ey ? (ez ? index.ptr(bx, by + 1, bz + 1) : p010) : p001;
        const int p111 = ex ? (ey ? (ez ? index.ptr(bx + 1, by + 1, bz + 1) : p110) : p101) : p011;
        return itpu_trilinear(sdf(p000, lx, ly, lz), sdf(p100, lx1, ly, lz), sdf(p010, lx, ly1, lz),
                              sdf(p110, lx1, ly1, lz), sdf(p001, lx, ly, lz1), sdf(p101, lx1, ly, lz1),
                              sdf(p011, lx, ly1, lz1), sdf(p111, lx1, ly1, lz1), cx, cy, cz);
    }
};

// the dense voxel array (engine/volume.py): float32 sdf [Z, Y, X] at global
// voxel (x, y, z) − offset; a voxel inside the array is found, one outside
// reads (1.0, not found), as make_dense_reader
struct ItpuDenseReader {
    const float* sdf_zyx;
    int sx, sy, sz, ox, oy, oz;
    struct Cache {};

    __device__ __forceinline__ void to_lane(long long b, const ItpuLanes& ln) { sdf_zyx += b * ln.s[6]; }

    __device__ __forceinline__ Cache fresh() const { return Cache{}; }

    __device__ __forceinline__ float read(Cache&, int vx, int vy, int vz, bool& found) const {
        const int x = vx - ox, y = vy - oy, z = vz - oz;
        found = (unsigned)x < (unsigned)sx && (unsigned)y < (unsigned)sy && (unsigned)z < (unsigned)sz;
        return found ? __ldg(sdf_zyx + ((long long)z * sy + y) * sx + x) : 1.0f;
    }

    // trilinear sdf over the 8 voxels around p; corners outside read 1.0
    __device__ __forceinline__ float interpolated(Cache& c, float px, float py, float pz) const {
        const float fx = floorf(px), fy = floorf(py), fz = floorf(pz);
        const float cx = px - fx, cy = py - fy, cz = pz - fz;
        const int ix = (int)fx, iy = (int)fy, iz = (int)fz;
        bool f;
        return itpu_trilinear(read(c, ix, iy, iz, f), read(c, ix + 1, iy, iz, f), read(c, ix, iy + 1, iz, f),
                              read(c, ix + 1, iy + 1, iz, f), read(c, ix, iy, iz + 1, f),
                              read(c, ix + 1, iy, iz + 1, f), read(c, ix, iy + 1, iz + 1, f),
                              read(c, ix + 1, iy + 1, iz + 1, f), cx, cy, cz);
    }
};

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
// [h, w]; out: [h, w, 4]; empty space steps to the exit of its
// (1 << block_shift)-voxel block
template <class Reader, bool LANES>
__global__ void itpu_raycast_kernel(Reader rd, int block_shift, const float* __restrict__ inv_M,
                                    const float* __restrict__ proj, float inv_voxel, const float* __restrict__ zmin,
                                    const float* __restrict__ zmax, int h, int w, float step_scale,
                                    const bool* __restrict__ enable, float* __restrict__ out, ItpuLanes ln) {
    if constexpr (LANES) {  // this CTA's lane: strides in elements, inv_M, proj, zmin, zmax, enable, out, the reader's
        const long long lane_id = blockIdx.z;
        rd.to_lane(lane_id, ln);
        inv_M += lane_id * ln.s[0];
        proj += lane_id * ln.s[1];
        zmin += lane_id * ln.s[2];
        zmax += lane_id * ln.s[3];
        enable = itpu_lane(enable, lane_id, ln.s[4]);
        out += lane_id * ln.s[5];
    }
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

    const float S = (float)(1 << block_shift);
    const float inv_S = 1.0f / S;  // exact: p · 2⁻ᵏ rounds as p / 2ᵏ
    const bool tx = fabsf(dx) < 1e-9f, ty = fabsf(dy) < 1e-9f, tz = fabsf(dz) < 1e-9f;
    const float sx = tx ? 1e-9f : dx, sy = ty ? 1e-9f : dy, sz = tz ? 1e-9f : dz;
    const float ux = dx > 0.0f ? 1.0f : 0.0f, uy = dy > 0.0f ? 1.0f : 0.0f, uz = dz > 0.0f ? 1.0f : 0.0f;
    typename Reader::Cache cache = rd.fresh();
    float sdf = 1.0f;
    // every ray takes at least one step, as in the lock-step oracle; the loop
    // ends at a hit or when `total` passes len_end (each step is ≥ 0.5 voxel)
    while (true) {
        const int vx = (int)floorf(px + 0.5f), vy = (int)floorf(py + 0.5f), vz = (int)floorf(pz + 0.5f);
        bool found;
        const float s = rd.read(cache, vx, vy, vz, found);
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
        const float r1 = rd.interpolated(cache, rx, ry, rz) * step_scale;
        rx = rx + r1 * dx;
        ry = ry + r1 * dy;
        rz = rz + r1 * dz;
        const float r2 = rd.interpolated(cache, rx, ry, rz) * step_scale;
        o = make_float4(rx + r2 * dx, ry + r2 * dy, rz + r2 * dz, 1.0f);
    } else {
        o = make_float4(px, py, pz, 0.0f);
    }
    reinterpret_cast<float4*>(out)[i] = o;
}

template <class Reader>
static int itpu_raycast_launch(const Reader& rd, int block_shift, const void* inv_M, const void* proj,
                               float inv_voxel, const void* zmin, const void* zmax, int h, int w, float step_scale,
                               const void* enable, void* out, int n_lanes, const long long* strides, int n_strides,
                               void* stream) {
    if (h > 0 && w > 0 && n_lanes > 0) {
        const dim3 tiles((w + RC_TILE_W - 1) / RC_TILE_W, (h + RC_TILE_H - 1) / RC_TILE_H, n_lanes);
        auto kernel = n_lanes > 1 ? itpu_raycast_kernel<Reader, true> : itpu_raycast_kernel<Reader, false>;
        kernel<<<tiles, RC_THREADS, 0, (cudaStream_t)stream>>>(
            rd, block_shift, (const float*)inv_M, (const float*)proj, inv_voxel, (const float*)zmin,
            (const float*)zmax, h, w, step_scale, (const bool*)enable, (float*)out, itpu_lanes(strides, n_strides));
    }
    return (int)cudaGetLastError();
}

// Every entry point: n_lanes lanes, strides inv_M, proj, zmin, zmax, enable,
// out, then its reader's arrays.
//
// K3: through the block grid [gx, gy, gz] at block origin (ox, oy, oz);
// reader strides vox, grid
ITPU_EXPORT int itpu_raycast(const void* vox, const void* grid, int gx, int gy, int gz, int ox, int oy, int oz,
                             int block_shift, const void* inv_M, const void* proj, float inv_voxel, const void* zmin,
                             const void* zmax, int h, int w, float step_scale, const void* enable, void* out,
                             int n_lanes, const long long* strides, void* stream) {
    const ItpuBlockReader<ItpuGridIndex> rd{{(const int*)grid, gx, gy, gz, ox, oy, oz}, (const int*)vox, block_shift};
    return itpu_raycast_launch(rd, block_shift, inv_M, proj, inv_voxel, zmin, zmax, h, w, step_scale, enable, out,
                               n_lanes, strides, 8, stream);
}

// K3h: through the hash table (entry_pos [E, 3], entry_ptr, entry_offset
// [E]); reader strides vox, entry_pos, entry_ptr, entry_offset
ITPU_EXPORT int itpu_raycast_hash(const void* vox, const void* entry_pos, const void* entry_ptr,
                                  const void* entry_offset, int n_buckets, int hash_mask, int block_shift,
                                  const void* inv_M, const void* proj, float inv_voxel, const void* zmin,
                                  const void* zmax, int h, int w, float step_scale, const void* enable, void* out,
                                  int n_lanes, const long long* strides, void* stream) {
    const ItpuBlockReader<ItpuHashIndex> rd{
        {(const int*)entry_pos, (const int*)entry_ptr, (const int*)entry_offset, n_buckets, (unsigned)hash_mask},
        (const int*)vox, block_shift};
    return itpu_raycast_launch(rd, block_shift, inv_M, proj, inv_voxel, zmin, zmax, h, w, step_scale, enable, out,
                               n_lanes, strides, 10, stream);
}

// K3d: over the dense array sdf [sz, sy, sx] at voxel offset (ox, oy, oz);
// reader stride sdf
ITPU_EXPORT int itpu_raycast_dense(const void* sdf, int sx, int sy, int sz, int ox, int oy, int oz, int block_shift,
                                   const void* inv_M, const void* proj, float inv_voxel, const void* zmin,
                                   const void* zmax, int h, int w, float step_scale, const void* enable, void* out,
                                   int n_lanes, const long long* strides, void* stream) {
    const ItpuDenseReader rd{(const float*)sdf, sx, sy, sz, ox, oy, oz};
    return itpu_raycast_launch(rd, block_shift, inv_M, proj, inv_voxel, zmin, zmax, h, w, step_scale, enable, out,
                               n_lanes, strides, 7, stream);
}
