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

// The adjoint of downsample2x (the gradient of core/grid.py build_mips,
// which the JAX package differentiates: its Pallas mip has no VJP).
//
// What it computes: (D/2)^3 x C cotangents -> D^3 x C, each child 0.125 x
// its parent's cotangent in the mean channels.  With max_alpha the last
// channel's cotangent follows the pairwise maximum chain of the forward
// (m0 = a0, mk = max(m(k-1), ak), corners x outer, z inner): at each link
// the larger side takes the whole cotangent and a tie splits it in
// halves, as the derivative of torch.maximum and jnp.maximum does.  So a
// corner's weight is the product of its own link's share and the left
// shares of every later link, a power of two or 0, and 8 equal children
// get 1/128, 1/128, 1/64, ..., 1/2: occupancy alphas are mostly exact 0s
// and 1s, so ties are the common case.  The weights are exact, so the
// result equals downsample2x_bwd_plain bit for bit.
//
// What bounds it: memory: the input-sized cotangent is written once.  One
// thread per COTANGENT element (parent cell, channel), as the forward's
// one thread per output element: it reads its cotangent once and writes
// its 8 children, so neighbouring threads (neighbouring channels) write
// neighbouring addresses for each corner, and the 64-bit index
// arithmetic, which the card emulates, is paid once per 8 writes.  An
// alpha thread in max mode also reads its 8 children's saved alphas.
// 64-bit indices, as the forward, for 256^3 x 208 inputs.
__global__ void mip_bwd_kernel(const float* __restrict__ gout,
                               const float* __restrict__ alpha,
                               float* __restrict__ gin, int h, int c,
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
        // child k (x outer, z inner) is cell base + off[k] of the fine grid
        const long long base = ((2 * x) * d + 2 * y) * d + 2 * z;
        long long off[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            off[k] = ((k >> 2) * d + ((k >> 1) & 1)) * d + (k & 1);
        }
        const float g = gout[i];
        if (!(max_alpha && ch == c - 1)) {
            const float v = 0.125f * g;
#pragma unroll
            for (int k = 0; k < 8; ++k) gin[(base + off[k]) * c + ch] = v;
            continue;
        }
        float a[8], m[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) a[k] = alpha[base + off[k]];
        m[0] = a[0];
#pragma unroll
        for (int k = 1; k < 8; ++k) m[k] = fmaxf(m[k - 1], a[k]);
        // walking the chain down from its last link: corner k takes its
        // own link's share of what reaches link k, the earlier corners
        // what passes its left side
        float carry = 1.0f;
#pragma unroll
        for (int k = 7; k >= 1; --k) {
            const float right = a[k] > m[k - 1] ? 1.0f : (a[k] == m[k - 1] ? 0.5f : 0.0f);
            const float left = m[k - 1] > a[k] ? 1.0f : (m[k - 1] == a[k] ? 0.5f : 0.0f);
            gin[(base + off[k]) * c + ch] = (carry * right) * g;
            carry *= left;
        }
        gin[base * c + ch] = carry * g;
    }
}

VCT_EXPORT int vct_mip_downsample_bwd(const float* gout, const float* alpha,
                                      float* gin, int h, int c,
                                      int max_alpha, cudaStream_t stream) {
    const long long total = static_cast<long long>(h) * h * h * c;
    const int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    if (blocks > (1LL << 20)) blocks = 1LL << 20;
    if (blocks < 1) blocks = 1;
    mip_bwd_kernel<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
        gout, alpha, gin, h, c, max_alpha);
    return launch_status();
}

VCT_EXPORT const char* vct_error_string(int status) {
    return cudaGetErrorString(static_cast<cudaError_t>(status));
}
