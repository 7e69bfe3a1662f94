// 2x2x2 mip reduction: replaces vct_tpu/ops/mip_pallas.py
// downsample2x_pallas (_mean_kernel, _maxalpha_kernel).
//
// What it computes: (D, D, D, C) float32 -> (D/2, D/2, D/2, C), each
// output the mean of its 8 children; with max_alpha the last channel takes
// the children's max instead (conservative occupancy for the shadow
// pyramid).  The corners are summed in the reference's order (x outer, z
// inner) and scaled by 0.125, so results equal core/grid.py downsample2x.
//
// What bounds it: memory.  Each output element reads 8 floats once and
// writes one; there is no reuse to exploit.  The TPU kernel expressed the
// pair sums as matmuls because its vector unit has no strided loads; here
// one thread computes one output ELEMENT (cell, channel), so neighbouring
// threads read neighbouring channels and every load is coalesced for any
// C (1 for the light volume, 4 for radiance, 208 for the fused fields).
// A grid-stride loop covers any size; indices are 64-bit because a
// 256^3 x 208 input exceeds 2^31 elements.
#include "common.cuh"

__global__ void mip_kernel(const float* __restrict__ src,
                           float* __restrict__ dst, int h, int c,
                           int max_alpha) {
    const long long total = static_cast<long long>(h) * h * h * c;
    const long long d = 2LL * h;
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
         i < total; i += stride) {
        const int ch = static_cast<int>(i % c);
        const long long cell = i / c;
        const long long z = cell % h;
        const long long y = (cell / h) % h;
        const long long x = cell / (static_cast<long long>(h) * h);
        float sum = 0.0f;
        float mx = -INFINITY;
#pragma unroll
        for (int ix = 0; ix < 2; ++ix) {
#pragma unroll
            for (int iy = 0; iy < 2; ++iy) {
#pragma unroll
                for (int iz = 0; iz < 2; ++iz) {
                    const float v = src[(((2 * x + ix) * d + (2 * y + iy)) * d
                                         + (2 * z + iz)) * c + ch];
                    sum = add_rn(sum, v);
                    mx = fmaxf(mx, v);
                }
            }
        }
        dst[i] = (max_alpha && ch == c - 1) ? mx : mul_rn(sum, 0.125f);
    }
}

VCT_EXPORT int vct_mip_downsample(const float* src, float* dst, int h, int c,
                                  int max_alpha, cudaStream_t stream) {
    const long long total = static_cast<long long>(h) * h * h * c;
    const int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    if (blocks > (1LL << 20)) blocks = 1LL << 20;
    if (blocks < 1) blocks = 1;
    mip_kernel<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
        src, dst, h, c, max_alpha);
    return launch_status();
}

VCT_EXPORT const char* vct_error_string(int status) {
    return cudaGetErrorString(static_cast<cudaError_t>(status));
}
