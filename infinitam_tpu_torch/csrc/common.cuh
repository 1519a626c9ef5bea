// Shared device helpers of the hand-written kernels (icp.cu, integrate.cu,
// raycast.cu). The library is built with -fmad=false, so every a*b+c below
// rounds twice, like the separate elementwise ops of the plain PyTorch
// versions the kernels are held to.
#pragma once

#include <cuda_runtime.h>

#define ITPU_EXPORT extern "C" __attribute__((visibility("default")))

// 1/32767 rounded to float, as the JAX package's `q * (1.0 / SDF_SCALE)`
#define ITPU_INV_SDF_SCALE ((float)(1.0 / 32767.0))

// floor division toward −inf (reference pointToVoxelBlockPos)
__device__ __forceinline__ int itpu_floor_div(int a, int b) {
    int q = a / b;
    return (a % b != 0 && a < 0) ? q - 1 : q;
}

// a·b + c rounded once to float32 through float64, where the float32 product
// is exact — the same ops as utils/se3.py apply_planes
__device__ __forceinline__ float itpu_fma(float a, float b, float c) {
    return (float)((double)a * (double)b + (double)c);
}

// M[0:3, 0:4] (row-major 12 floats) · (x, y, z, 1) as an FMA chain
// fma(m2, z, fma(m1, y, m0·x)) + t: the rounding of the JAX package's
// einsum on the CPU and of the plain versions (se3.apply_planes)
__device__ __forceinline__ void itpu_transform(const float* M, float x, float y, float z,
                                               float& ox, float& oy, float& oz) {
    ox = itpu_fma(M[2], z, itpu_fma(M[1], y, M[0] * x)) + M[3];
    oy = itpu_fma(M[6], z, itpu_fma(M[5], y, M[4] * x)) + M[7];
    oz = itpu_fma(M[10], z, itpu_fma(M[9], y, M[8] * x)) + M[11];
}

// Lanes: B independent problems in one launch (the port's torch.vmap
// batch). A kernel reads its lane from a grid index and moves each of its
// tensor arguments on by lane · stride elements; a stride of 0 shares one
// tensor among the lanes. The entry points take the strides as a host
// array, in the order each one documents, and pass them by value.
#define ITPU_MAX_LANE_ARGS 12

struct ItpuLanes {
    long long s[ITPU_MAX_LANE_ARGS];
};

static inline ItpuLanes itpu_lanes(const long long* strides, int n) {
    ItpuLanes l = {};
    for (int i = 0; i < n && i < ITPU_MAX_LANE_ARGS; ++i) l.s[i] = strides ? strides[i] : 0;
    return l;
}

// p moved on to lane b of a tensor argument with `stride` elements between lanes
template <class T>
__device__ __forceinline__ T* itpu_lane(T* p, long long b, long long stride) {
    return p ? p + b * stride : p;
}
