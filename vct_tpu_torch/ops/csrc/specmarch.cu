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
// What bounds it: issuing instructions.  Up to 58 taps a pixel, each 8
// corners of 4 bf16 channels (one 8-byte read-only load a corner) that
// mostly hit L2 (a frame's taps touch about 3% of the pyramid), and about
// 100 separately rounded float operations a tap besides the corner
// addresses and the bf16 unpacks.  The TPU kernel DMA'd one brick per
// (group, step group) and tapped it with two-hot weight matmuls and a
// log-depth cumulative product, because the TPU cannot gather; here one
// thread owns one pixel, gathers its corners from the level the table
// names, and composites in registers with a real break at the early-out (T
// only falls, so once the test fails it fails for every later step).  The
// group's step table and the levels' first cells sit in shared memory.  A
// tap's corner addresses are 32-bit cell counts (the wrapper refuses
// pyramids of 2**31 cells): the per-axis offsets x * d * d and y * d once,
// then one add a corner, where 64-bit products a corner cost more
// registers and instruction slots.  At 48 registers 40 warps share an SM, and
// they hide the gathers' latency: buffering a tap's loads ahead in
// registers cost more warps than it hid.
// Every multiply and add rounds on its own (*_rn), in the plain version's
// order, so the kernel gives the plain version's result bit for bit.
#include "common.cuh"

namespace {

constexpr int kTile = 256;
constexpr int kMaxSteps = 128;    // ops/specmarch.py MAX_STEPS
constexpr int kMaxLevels = 16;    // ops/specmarch.py MAX_LEVELS
constexpr long long kMaxCells = 1LL << 31;   // ops/specmarch.py MAX_CELLS

__device__ __forceinline__ float lerp_rn(float a, float b, float f, float omf) {
    return add_rn(mul_rn(a, omf), mul_rn(b, f));
}

// bfloat16 -> float is exact: the bf16 is the float's upper half (the
// lower channel of a 32-bit pair sits in its low 16 bits)
__device__ __forceinline__ float lo_bf16(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf16(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

// grid.trilinear_sample of one (d, d, d, 4) bf16 level whose first cell is
// `base`: texel centres at (i + 0.5) / d, edge clamp; lerps along z, then
// y, then x
__device__ __forceinline__ float4 tap(const uint2* __restrict__ cells, unsigned base, int d,
                                      const float* uvw) {
    int i0[3], i1[3];
    float f[3], omf[3];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
        const float t = sub_rn(mul_rn(uvw[ax], static_cast<float>(d)), 0.5f);
        const float fl = floorf(t);
        f[ax] = sub_rn(t, fl);
        omf[ax] = sub_rn(1.0f, f[ax]);
        const int i = static_cast<int>(fl);
        i0[ax] = min(max(i, 0), d - 1);
        i1[ax] = min(max(i + 1, 0), d - 1);
    }
    const unsigned dd = static_cast<unsigned>(d) * static_cast<unsigned>(d);
    const unsigned x0 = base + i0[0] * dd, x1 = base + i1[0] * dd;
    const unsigned y0 = i0[1] * d, y1 = i1[1] * d;
    const unsigned xy[4] = {x0 + y0, x0 + y1, x1 + y0, x1 + y1};
    uint2 c[8];      // corner k at (x, y, z) = bits (4, 2, 1) of k
#pragma unroll
    for (int k = 0; k < 8; ++k) c[k] = __ldg(cells + (xy[k >> 1] + ((k & 1) ? i1[2] : i0[2])));
    float out[4];
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
        float v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            const unsigned w = ch < 2 ? c[k].x : c[k].y;
            v[k] = (ch & 1) ? hi_bf16(w) : lo_bf16(w);
        }
        const float c00 = lerp_rn(v[0], v[1], f[2], omf[2]);
        const float c01 = lerp_rn(v[2], v[3], f[2], omf[2]);
        const float c10 = lerp_rn(v[4], v[5], f[2], omf[2]);
        const float c11 = lerp_rn(v[6], v[7], f[2], omf[2]);
        const float c0 = lerp_rn(c00, c01, f[1], omf[1]);
        const float c1 = lerp_rn(c10, c11, f[1], omf[1]);
        out[ch] = lerp_rn(c0, c1, f[0], omf[0]);
    }
    return make_float4(out[0], out[1], out[2], out[3]);
}

__global__ void __launch_bounds__(kTile)
specmarch_kernel(const float4* __restrict__ start4, const float4* __restrict__ refl4,
                 const int* __restrict__ step_lv, const float* __restrict__ weights,
                 int nsteps, const uint2* __restrict__ cells, int d0, int nl,
                 float half_ws, float max_alpha, float4* __restrict__ out) {
    __shared__ int s_lv[kMaxSteps];
    __shared__ float s_w[kMaxSteps * 3];     // dist, mip weight, attenuation
    __shared__ unsigned s_off[kMaxLevels];   // first cell of each level
    const int tile = blockIdx.x;
    for (int i = threadIdx.x; i < nsteps; i += kTile)
        s_lv[i] = step_lv[static_cast<long long>(tile) * nsteps + i];
    for (int i = threadIdx.x; i < nsteps * 3; i += kTile)
        s_w[i] = weights[static_cast<long long>(tile) * nsteps * 3 + i];
    if (threadIdx.x < nl) {
        unsigned off = 0;
        for (int l = 0; l < static_cast<int>(threadIdx.x); ++l) {
            const unsigned d = static_cast<unsigned>(d0 >> l);
            off += d * d * d;
        }
        s_off[threadIdx.x] = off;
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
        float4 smp = tap(cells, s_off[lv], d0 >> lv, uvw);
        if (w != 0.0f) {                                // w is the group's: no divergence
            const int lv1 = min(lv + 1, nl - 1);
            const float4 s1 = tap(cells, s_off[lv1], d0 >> lv1, uvw);
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
    long long total = 0;
    for (int l = 0; l < nl; ++l) {
        const long long d = d0 >> l;
        total += d * d * d;
    }
    if (total >= kMaxCells) return static_cast<int>(cudaErrorInvalidValue);
    specmarch_kernel<<<ntiles, kTile, 0, stream>>>(
        reinterpret_cast<const float4*>(start4), reinterpret_cast<const float4*>(refl4),
        step_lv, weights, nsteps, reinterpret_cast<const uint2*>(pyramid), d0, nl, half_ws,
        max_alpha, reinterpret_cast<float4*>(out));
    return launch_status();
}

VCT_EXPORT int vct_specmarch_occupancy(int* info) {
    return occupancy_info(specmarch_kernel, kTile, 0, info);
}
