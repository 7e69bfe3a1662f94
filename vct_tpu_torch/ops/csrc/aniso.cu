// One level of the anisotropic (6-direction) radiance pyramid: replaces
// the eager composites of core/aniso.py downsample_aniso_from_iso and
// downsample_aniso (vct_tpu/core/aniso.py, XLA in the JAX package).
//
// What it computes: level l -> level l+1 (h, h, h, 6, C) float32, from the
// isotropic level 0 (2h, 2h, 2h, C) or from a 6-direction level
// (2h, 2h, 2h, 6, C).  Direction s (order +x, -x, +y, -y, +z, -z) of a
// parent composites its 2x2x2 children front to back along s's axis:
// near = the child the travel direction enters first, and for each of the
// 4 perpendicular child pairs near + (1 - alpha_near) * far, each
// operation rounded on its own; the 4 pairs are summed in the plain
// loop's order ((p0, p1) = (0,0), (0,1), (1,0), (1,1), p0 the lower of the
// two perpendicular axes) and the sum scaled by 0.25.  From a 6-direction
// level, direction s reads the children's direction s; from level 0 every
// direction reads the same children.  So results equal the plain version
// bit for bit.
//
// What bounds it: memory.  Each output value reads 8 child values and 4
// child alphas and does 16 float operations.  One thread per output
// (cell, direction, group of W channels): neighbouring threads write
// neighbouring addresses, and from a 6-direction level read neighbouring
// addresses too; from level 0 the six directions of a cell read the same
// children, which the cache serves.  W = 4 (one 16-byte load a child) when
// C is a multiple of 4 and both pointers are 16-byte aligned, else 1.
// 64-bit indices, as the mip kernel.
#include "common.cuh"

template <int W>
struct Vec;
template <>
struct Vec<1> {
    float v[1];
    __device__ __forceinline__ void load(const float* p) { v[0] = *p; }
    __device__ __forceinline__ void store(float* p) const { *p = v[0]; }
};
template <>
struct Vec<4> {
    float v[4];
    __device__ __forceinline__ void load(const float* p) {
        const float4 q = *reinterpret_cast<const float4*>(p);
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    }
    __device__ __forceinline__ void store(float* p) const {
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    }
};

template <int W>
__global__ void aniso_pyramid_kernel(const float* __restrict__ src,
                                     float* __restrict__ dst, int h, int c,
                                     int src_dirs) {
    const int groups = c / W;
    const long long total = static_cast<long long>(h) * h * h * 6 * groups;
    const long long d = 2LL * h;
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
         i < total; i += stride) {
        const int g = static_cast<int>(i % groups);
        const int s = static_cast<int>((i / groups) % 6);
        const long long cell = i / (6LL * groups);
        const long long z = cell % h;
        const long long y = (cell / h) % h;
        const long long x = cell / (static_cast<long long>(h) * h);
        const int axis = s >> 1;
        const int near = s & 1;          // + directions enter at offset 0
        // a child's first float of this direction: cell k's row, then the
        // direction's C channels in a 6-direction level
        const long long row = static_cast<long long>(src_dirs) * c;
        const long long dir_off = src_dirs == 6 ? static_cast<long long>(s) * c : 0;
        Vec<W> acc;
#pragma unroll
        for (int k = 0; k < W; ++k) acc.v[k] = 0.0f;
#pragma unroll
        for (int p0 = 0; p0 < 2; ++p0) {
#pragma unroll
            for (int p1 = 0; p1 < 2; ++p1) {
                // child offsets: near or far on `axis`, (p0, p1) on the
                // other two in increasing axis order
                const int oy = axis == 0 ? p0 : p1;
                const int ox = axis == 0 ? 0 : p0, oz = axis == 2 ? 0 : p1;
                const int nx = axis == 0 ? near : ox;
                const int ny = axis == 1 ? near : oy;
                const int nz = axis == 2 ? near : oz;
                const int fx = axis == 0 ? 1 - near : ox;
                const int fy = axis == 1 ? 1 - near : oy;
                const int fz = axis == 2 ? 1 - near : oz;
                const long long kn = ((2 * x + nx) * d + (2 * y + ny)) * d + (2 * z + nz);
                const long long kf = ((2 * x + fx) * d + (2 * y + fy)) * d + (2 * z + fz);
                const float* pn = src + kn * row + dir_off;
                const float* pf = src + kf * row + dir_off;
                const float t = sub_rn(1.0f, pn[c - 1]);
                Vec<W> vn, vf;
                vn.load(pn + g * W);
                vf.load(pf + g * W);
#pragma unroll
                for (int k = 0; k < W; ++k) {
                    const float pair = add_rn(vn.v[k], mul_rn(t, vf.v[k]));
                    acc.v[k] = (p0 | p1) ? add_rn(acc.v[k], pair) : pair;
                }
            }
        }
#pragma unroll
        for (int k = 0; k < W; ++k) acc.v[k] = mul_rn(acc.v[k], 0.25f);
        acc.store(dst + (cell * 6 + s) * c + g * W);
    }
}

VCT_EXPORT int vct_aniso_downsample(const float* src, float* dst, int h,
                                    int c, int src_dirs, int vec4,
                                    cudaStream_t stream) {
    const int w = vec4 ? 4 : 1;
    const long long total = static_cast<long long>(h) * h * h * 6 * (c / w);
    const int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    if (blocks > (1LL << 20)) blocks = 1LL << 20;
    if (blocks < 1) blocks = 1;
    if (vec4)
        aniso_pyramid_kernel<4><<<static_cast<unsigned>(blocks), threads, 0,
                                  stream>>>(src, dst, h, c, src_dirs);
    else
        aniso_pyramid_kernel<1><<<static_cast<unsigned>(blocks), threads, 0,
                                  stream>>>(src, dst, h, c, src_dirs);
    return launch_status();
}
