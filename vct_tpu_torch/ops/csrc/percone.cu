// The per-pixel cone march of the per-cone route (render/shading's
// "percone" providers): the upstream fragment shader's loop
// (VoxelConeTracing.fs:82-107) for every (ray, cone) of a call, and the
// diffuse gather's static-weight sum over the cones (fs:196-199).
//
// It replaces no Pallas kernel: the JAX package runs this march as XLA
// (vct_tpu/core/march.py), and the port ran it as eager PyTorch
// (core/march.py: one gather of every level a schedule touches, all 24
// channels of a 6-direction level, every corner through device memory,
// an exclusive cumulative product whose early-out is a mask).  Its plain
// twin is ops/percone.py gather_plain.
//
// What it computes, per (ray, cone): from start (already offset along the
// normal) along the unit axis d, for each step of the table while alpha <
// max_alpha (a real break: alpha only rises), the point start + dist * d,
// its uvw, the quadrilinear sample c (trilinear at level l0 and, where the
// table names a second level l1, lerped c * (1 - w) + c1 * w), then
// color += (1 - alpha) * c.rgb, occlusion += (1 - alpha) * c.a / divisor,
// alpha += (1 - alpha) * c.a.  A 6-direction level (d, d, d, 6, 4) is read
// for the three directions the cone faces (2a on the + side of axis a,
// 2a + 1 on the -) and blended d_a^2 * s_a in direction order; the other
// three carry weight exactly 0, so the sum equals the six-way blend's bit
// for bit.  The cones of a ray then sum, in cone order, w_k * (rgb_k,
// occlusion_k) into one float4.
//
// What bounds it: the instructions it runs and the L1/L2 gathers.  A sample
// reads 8 float4 corners at an isotropic level and 24 at a 6-direction
// one, one or two levels a step (about 40 float4 loads a sample at
// aniso128's schedules), and rounds some 500 multiplies and adds.  So
// one thread owns one (ray, cone) and keeps the whole march in registers:
// no corner, sample or partial sum goes through device memory.  A block is
// 32 neighbouring rays times K cones, one warp a cone (and 8 / K groups of
// 32 rays where K is small), so a warp's lanes are neighbouring pixels of
// one cone, whose corners coincide in L1; at K = 6 a 65,536-ray call gives
// 12,288 warps, where one thread a ray would leave ~15 warps an SM to
// hide the gathers.  The step table (distance, levels, lerp weights,
// occlusion divisor) and the levels' pointers ride in the launch's
// parameter space, the constant bank, read warp-uniformly: no copy, no
// host sync.  The cones' sum goes through shared memory once.  Texel
// offsets within a level are 32-bit (the wrapper refuses pyramids of
// 2**31 texels).  Every multiply, add and divide rounds on its own
// (*_rn), in the twin's order, so a sample equals the twin's and the
// reference's (vctbench/reference_oracle/march.py cone_trace) bit for bit.
#include "common.cuh"

namespace {

constexpr int kMaxCones = 8;       // ops/percone.py MAX_CONES
constexpr int kMaxSteps = 128;     // ops/percone.py MAX_STEPS
constexpr int kMaxLevels = 16;     // ops/percone.py MAX_LEVELS
constexpr int kBlockWarps = 8;     // warps a block at most
constexpr long long kMaxCells = 1LL << 31;

struct Step {
    float dist, w, omw, div;       // distance, upper level's weight, 1 - w, 1 + falloff * diameter
    int l0, l1;                    // levels; l1 == l0: no lerp
};

struct Params {
    const float4* level[kMaxLevels];
    int dim[kMaxLevels];
    int dirs[kMaxLevels];          // 1: isotropic (d, d, d, 4); 6: (d, d, d, 6, 4)
    Step step[kMaxSteps];
    float weight[kMaxCones];
    int nl, nsteps, k, groups;
    float half_ws, max_alpha;
};

__device__ __forceinline__ float lerp_rn(float a, float b, float f, float omf) {
    return add_rn(mul_rn(a, omf), mul_rn(b, f));
}

__device__ __forceinline__ float4 lerp4(float4 a, float4 b, float f, float omf) {
    return make_float4(lerp_rn(a.x, b.x, f, omf), lerp_rn(a.y, b.y, f, omf),
                       lerp_rn(a.z, b.z, f, omf), lerp_rn(a.w, b.w, f, omf));
}

__device__ __forceinline__ float4 scale4(float w, float4 a) {
    return make_float4(mul_rn(w, a.x), mul_rn(w, a.y), mul_rn(w, a.z), mul_rn(w, a.w));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
    return make_float4(add_rn(a.x, b.x), add_rn(a.y, b.y), add_rn(a.z, b.z), add_rn(a.w, b.w));
}

// One level's 8 corner cells (corner k at (x, y, z) = bits (4, 2, 1) of k)
// and fractions, as grid.trilinear_sample takes them: texel centres at
// (i + 0.5) / d, edge clamp.
struct Corners {
    unsigned cell[8];
    float f[3], omf[3];
};

__device__ __forceinline__ Corners corners(int d, const float* uvw) {
    Corners c;
    int i0[3], i1[3];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
        const float t = sub_rn(mul_rn(uvw[ax], static_cast<float>(d)), 0.5f);
        const float fl = floorf(t);
        c.f[ax] = sub_rn(t, fl);
        c.omf[ax] = sub_rn(1.0f, c.f[ax]);
        const int i = static_cast<int>(fl);
        i0[ax] = min(max(i, 0), d - 1);
        i1[ax] = min(max(i + 1, 0), d - 1);
    }
    const unsigned ud = static_cast<unsigned>(d);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        const unsigned x = (k & 4) ? i1[0] : i0[0];
        const unsigned y = (k & 2) ? i1[1] : i0[1];
        const unsigned z = (k & 1) ? i1[2] : i0[2];
        c.cell[k] = (x * ud + y) * ud + z;
    }
    return c;
}

// The trilinear sample of the float4 texels `level[cell * dirs + slot]`:
// lerps along z, then y, then x
__device__ __forceinline__ float4 trilinear(const float4* __restrict__ level, const Corners& c,
                                            unsigned dirs, unsigned slot) {
    float4 v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = __ldg(level + (c.cell[k] * dirs + slot));
    const float4 c00 = lerp4(v[0], v[1], c.f[2], c.omf[2]);
    const float4 c01 = lerp4(v[2], v[3], c.f[2], c.omf[2]);
    const float4 c10 = lerp4(v[4], v[5], c.f[2], c.omf[2]);
    const float4 c11 = lerp4(v[6], v[7], c.f[2], c.omf[2]);
    const float4 c0 = lerp4(c00, c01, c.f[1], c.omf[1]);
    const float4 c1 = lerp4(c10, c11, c.f[1], c.omf[1]);
    return lerp4(c0, c1, c.f[0], c.omf[0]);
}

// One level at uvw: isotropic, or the three facing directions blended in
// direction order
__device__ __forceinline__ float4 sample_level(const Params& p, int l, const float* uvw,
                                               const unsigned* face, const float* wface) {
    const Corners c = corners(p.dim[l], uvw);
    const float4* level = p.level[l];
    if (p.dirs[l] == 1) return trilinear(level, c, 1u, 0u);
    float4 acc = scale4(wface[0], trilinear(level, c, 6u, face[0]));
    acc = add4(acc, scale4(wface[1], trilinear(level, c, 6u, face[1])));
    return add4(acc, scale4(wface[2], trilinear(level, c, 6u, face[2])));
}

__global__ void __launch_bounds__(kBlockWarps * 32)
percone_kernel(const __grid_constant__ Params p, const float* __restrict__ start,
               const float* __restrict__ dirs, int n, float4* __restrict__ out,
               unsigned long long* __restrict__ walked) {
    extern __shared__ float4 s_cone[];           // [group][cone][lane]
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int cone = warp % p.k;
    const int group = warp / p.k;
    const long long ray = (static_cast<long long>(blockIdx.x) * p.groups + group) * 32 + lane;
    const bool valid = ray < n;

    float cr = 0.0f, cg = 0.0f, cb = 0.0f, occ = 0.0f;
    int ran = 0;
    if (valid) {
        const float s[3] = {start[3 * ray], start[3 * ray + 1], start[3 * ray + 2]};
        const long long di = 3 * (ray * p.k + cone);
        const float d[3] = {dirs[di], dirs[di + 1], dirs[di + 2]};
        unsigned face[3];
        float wface[3];
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) {
            face[ax] = 2 * ax + (d[ax] >= 0.0f ? 0 : 1);
            wface[ax] = mul_rn(d[ax], d[ax]);
        }
        float alpha = 0.0f;
        for (int k = 0; k < p.nsteps; ++k) {
            if (!(alpha < p.max_alpha)) break;     // fs:94: alpha only rises
            ++ran;
            const Step& st = p.step[k];
            float uvw[3];
#pragma unroll
            for (int ax = 0; ax < 3; ++ax)
                uvw[ax] = world_to_uvw(add_rn(s[ax], mul_rn(st.dist, d[ax])), p.half_ws);
            float4 c = sample_level(p, st.l0, uvw, face, wface);
            if (st.l1 != st.l0)                    // the step's: no divergence
                c = lerp4(c, sample_level(p, st.l1, uvw, face, wface), st.w, st.omw);
            const float keep = sub_rn(1.0f, alpha);
            cr = add_rn(cr, mul_rn(keep, c.x));
            cg = add_rn(cg, mul_rn(keep, c.y));
            cb = add_rn(cb, mul_rn(keep, c.z));
            const float ka = mul_rn(keep, c.w);
            occ = add_rn(occ, div_rn(ka, st.div));
            alpha = add_rn(alpha, ka);
        }
    }
    s_cone[(group * p.k + cone) * 32 + lane] = make_float4(cr, cg, cb, occ);
    if (walked != nullptr) {
        const unsigned steps = __reduce_add_sync(0xffffffffu, static_cast<unsigned>(ran));
        if (lane == 0 && steps != 0) atomicAdd(walked, static_cast<unsigned long long>(steps));
    }
    __syncthreads();
    if (cone == 0 && valid) {
        float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int c = 0; c < p.k; ++c)
            acc = add4(acc, scale4(p.weight[c], s_cone[(group * p.k + c) * 32 + lane]));
        out[ray] = acc;
    }
}

}  // namespace

VCT_EXPORT int vct_percone(const float* start, const float* dirs, int n, int k,
                           const long long* level_ptr, const int* level_shape, int nl,
                           const float* step_f, const int* step_i, int nsteps,
                           const float* weights, float half_ws, float max_alpha, float* out,
                           unsigned long long* walked, cudaStream_t stream) {
    if (n < 1 || k < 1 || k > kMaxCones || nl < 1 || nl > kMaxLevels || nsteps < 0 ||
        nsteps > kMaxSteps)
        return static_cast<int>(cudaErrorInvalidValue);
    Params p;
    long long cells = 0;
    for (int l = 0; l < nl; ++l) {
        p.level[l] = reinterpret_cast<const float4*>(level_ptr[l]);
        p.dim[l] = level_shape[2 * l];
        p.dirs[l] = level_shape[2 * l + 1];
        const long long d = p.dim[l];
        cells += d * d * d * p.dirs[l];
    }
    if (cells >= kMaxCells) return static_cast<int>(cudaErrorInvalidValue);
    for (int s = 0; s < nsteps; ++s) {
        p.step[s] = Step{step_f[4 * s], step_f[4 * s + 1], step_f[4 * s + 2],
                         step_f[4 * s + 3], step_i[2 * s], step_i[2 * s + 1]};
        if (p.step[s].l0 < 0 || p.step[s].l0 >= nl || p.step[s].l1 < 0 || p.step[s].l1 >= nl)
            return static_cast<int>(cudaErrorInvalidValue);
    }
    for (int c = 0; c < k; ++c) p.weight[c] = weights[c];
    p.nl = nl;
    p.nsteps = nsteps;
    p.k = k;
    p.groups = kBlockWarps / k > 0 ? kBlockWarps / k : 1;
    p.half_ws = half_ws;
    p.max_alpha = max_alpha;
    const int rays = 32 * p.groups;
    const int blocks = static_cast<int>((static_cast<long long>(n) + rays - 1) / rays);
    const int threads = rays * k;
    const size_t smem = sizeof(float4) * threads;
    percone_kernel<<<blocks, threads, smem, stream>>>(
        p, start, dirs, n, reinterpret_cast<float4*>(out), walked);
    return launch_status();
}

VCT_EXPORT int vct_percone_occupancy(int k, int* info) {
    const int groups = kBlockWarps / k > 0 ? kBlockWarps / k : 1;
    const int threads = 32 * groups * k;
    return occupancy_info(percone_kernel, threads, static_cast<int>(sizeof(float4)) * threads,
                          info);
}
