// The exact per-pixel specular cone march: replaces
// vct_tpu/ops/specmarch_pallas.py spec_march_tiles (_spec_kernel,
// _spec_pallas), with the function of its oracle spec_march_ref.
//
// What it computes, per pixel, over its 256-pixel group's step table
// (ops/specmarch.py step_table): for each schedule step k, the point
// start + dist_k * refl is sampled trilinearly at the group's level for
// the step and, where the step's mip weight w is nonzero, at the next
// coarser level too, lerped s * (1 - w) + s1 * w; then the front-to-back
// composite: while 1 - T < max_alpha, color += T * rgb, occlusion +=
// T * alpha * attenuation_k, T *= 1 - alpha.  The hit mask is the starting
// T, so a miss never samples and writes 0.
//
// What bounds it: the trilinear gathers.  Up to 58 taps a pixel, each
// 8 corners of 4 bf16 channels (one 8-byte read-only load a corner), and
// the loads of a step depend on nothing but the step's constants, so a
// thread's taps are independent until the composite.  By the card's peaks
// the work is bound by its float operations (about 100 a tap) at well
// under a millisecond for a 1080p frame; the gathers' latency, not HBM
// bandwidth, decides the time.  The TPU kernel DMA'd one brick per (group,
// step group) and tapped it with two-hot weight matmuls and a log-depth
// cumulative product, because the TPU cannot gather; here one thread owns
// one pixel, gathers its corners from the level the table names, and
// composites in registers with a real break at the early-out (T only
// falls, so once the test fails it fails for every later step).  The
// group's step table sits in shared memory.  Every multiply and add
// rounds on its own (*_rn), in the plain version's order, so the kernel
// gives the plain version's result bit for bit.
#include "common.cuh"

namespace {

constexpr int kTile = 256;
constexpr int kMaxSteps = 128;    // ops/specmarch.py MAX_STEPS
constexpr int kMaxLevels = 16;    // ops/specmarch.py MAX_LEVELS

__device__ __forceinline__ float lerp_rn(float a, float b, float f, float omf) {
    return add_rn(mul_rn(a, omf), mul_rn(b, f));
}

// grid.trilinear_sample of one (d, d, d, 4) bf16 level: texel centers at
// (i + 0.5) / d, edge clamp; lerps along z, then y, then x
__device__ __forceinline__ float4 tap(const __nv_bfloat16* __restrict__ lvl, int d,
                                      const float* uvw) {
    int i0[3], i1[3];
    float f[3], omf[3];
    for (int ax = 0; ax < 3; ++ax) {
        const float t = sub_rn(mul_rn(uvw[ax], static_cast<float>(d)), 0.5f);
        const float fl = floorf(t);
        f[ax] = sub_rn(t, fl);
        omf[ax] = sub_rn(1.0f, f[ax]);
        const int i = static_cast<int>(fl);
        i0[ax] = min(max(i, 0), d - 1);
        i1[ax] = min(max(i + 1, 0), d - 1);
    }
    const uint2* cells = reinterpret_cast<const uint2*>(lvl);
    float v[4][8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        const long long x = (k & 4) ? i1[0] : i0[0];
        const long long y = (k & 2) ? i1[1] : i0[1];
        const long long z = (k & 1) ? i1[2] : i0[2];
        const uint2 raw = __ldg(cells + (x * d + y) * d + z);
        const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
        const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
        v[0][k] = lo.x;
        v[1][k] = lo.y;
        v[2][k] = hi.x;
        v[3][k] = hi.y;
    }
    float out[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const float* c = v[q];
        const float c00 = lerp_rn(c[0], c[1], f[2], omf[2]);
        const float c01 = lerp_rn(c[2], c[3], f[2], omf[2]);
        const float c10 = lerp_rn(c[4], c[5], f[2], omf[2]);
        const float c11 = lerp_rn(c[6], c[7], f[2], omf[2]);
        const float c0 = lerp_rn(c00, c01, f[1], omf[1]);
        const float c1 = lerp_rn(c10, c11, f[1], omf[1]);
        out[q] = lerp_rn(c0, c1, f[0], omf[0]);
    }
    return make_float4(out[0], out[1], out[2], out[3]);
}

__global__ void __launch_bounds__(kTile)
specmarch_kernel(const float4* __restrict__ start4, const float4* __restrict__ refl4,
                 const int* __restrict__ step_lv, const float* __restrict__ weights,
                 int nsteps, const __nv_bfloat16* __restrict__ pyramid, int d0, int nl,
                 float half_ws, float max_alpha, float4* __restrict__ out) {
    __shared__ int s_lv[kMaxSteps];
    __shared__ float s_w[kMaxSteps * 3];           // dist, mip weight, attenuation
    __shared__ long long s_off[kMaxLevels];        // level offsets, in cells
    const int tile = blockIdx.x;
    for (int i = threadIdx.x; i < nsteps; i += kTile)
        s_lv[i] = step_lv[static_cast<long long>(tile) * nsteps + i];
    for (int i = threadIdx.x; i < nsteps * 3; i += kTile)
        s_w[i] = weights[static_cast<long long>(tile) * nsteps * 3 + i];
    if (threadIdx.x == 0) {
        long long off = 0;
        for (int l = 0; l < nl; ++l) {
            s_off[l] = off;
            const long long d = d0 >> l;
            off += d * d * d;
        }
    }
    __syncthreads();

    const long long px = static_cast<long long>(tile) * kTile + threadIdx.x;
    const float4 s = start4[px];
    const float4 r = refl4[px];
    float t = s.w;
    float cr = 0.0f, cg = 0.0f, cb = 0.0f, occ = 0.0f;
    for (int k = 0; k < nsteps; ++k) {
        if (!(sub_rn(1.0f, t) < max_alpha)) break;     // early-out: T only falls
        const float dist = s_w[3 * k];
        const float w = s_w[3 * k + 1];
        const float att = s_w[3 * k + 2];
        const int lv = s_lv[k];
        const float uvw[3] = {world_to_uvw(add_rn(s.x, mul_rn(dist, r.x)), half_ws),
                              world_to_uvw(add_rn(s.y, mul_rn(dist, r.y)), half_ws),
                              world_to_uvw(add_rn(s.z, mul_rn(dist, r.z)), half_ws)};
        float4 smp = tap(pyramid + s_off[lv] * 4, d0 >> lv, uvw);
        if (w != 0.0f) {
            const int lv1 = min(lv + 1, nl - 1);
            const float4 s1 = tap(pyramid + s_off[lv1] * 4, d0 >> lv1, uvw);
            const float omw = sub_rn(1.0f, w);
            smp.x = lerp_rn(smp.x, s1.x, w, omw);
            smp.y = lerp_rn(smp.y, s1.y, w, omw);
            smp.z = lerp_rn(smp.z, s1.z, w, omw);
            smp.w = lerp_rn(smp.w, s1.w, w, omw);
        }
        cr = add_rn(cr, mul_rn(t, smp.x));
        cg = add_rn(cg, mul_rn(t, smp.y));
        cb = add_rn(cb, mul_rn(t, smp.z));
        occ = add_rn(occ, mul_rn(mul_rn(t, smp.w), att));
        t = mul_rn(t, sub_rn(1.0f, smp.w));
    }
    out[px] = make_float4(cr, cg, cb, occ);
}

}  // namespace

VCT_EXPORT int vct_specmarch(const float* start4, const float* refl4, int ntiles,
                             const int* step_lv, const float* weights, int nsteps,
                             const __nv_bfloat16* pyramid, int d0, int nl, float half_ws,
                             float max_alpha, float* out, cudaStream_t stream) {
    if (nsteps < 0 || nsteps > kMaxSteps || nl < 1 || nl > kMaxLevels)
        return static_cast<int>(cudaErrorInvalidValue);
    specmarch_kernel<<<ntiles, kTile, 0, stream>>>(
        reinterpret_cast<const float4*>(start4), reinterpret_cast<const float4*>(refl4),
        step_lv, weights, nsteps, pyramid, d0, nl, half_ws, max_alpha,
        reinterpret_cast<float4*>(out));
    return launch_status();
}
