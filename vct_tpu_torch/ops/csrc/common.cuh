// Shared helpers for the port's CUDA kernels.
//
// The *_rn intrinsics round each operation on its own, as IEEE float32
// does.  nvcc contracts a * b + c into one fused multiply-add by default,
// which rounds once; kernels whose results must equal the plain PyTorch
// version bit for bit (raycast hit tests, prepass level selection) use
// these helpers for every multiply and add.
#pragma once

#include <cmath>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define VCT_EXPORT extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }

// world position -> texture coordinate, p / (ws/2) * 0.5 + 0.5 with an
// IEEE division (core/grid.py world_to_uvw)
__device__ __forceinline__ float world_to_uvw(float p, float half_ws) {
    return add_rn(mul_rn(div_rn(p, half_ws), 0.5f), 0.5f);
}

// launch status for the ctypes caller
static inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

// What the card makes of `kernel` launched with `threads` threads and `smem`
// dynamic shared bytes, for the caller's report: info[0:4] = registers,
// local (spill) bytes a thread, shared bytes a block (static + dynamic) and
// resident warps per SM
template <typename Kernel>
static inline int occupancy_info(Kernel kernel, int threads, int smem, int* info) {
    cudaFuncAttributes fa;
    int blocks = 0;
    cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    info[0] = fa.numRegs;
    info[1] = static_cast<int>(fa.localSizeBytes);
    info[2] = static_cast<int>(fa.sharedSizeBytes) + smem;
    info[3] = blocks * threads / 32;
    return 0;
}
