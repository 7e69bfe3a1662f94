// Direction-major dense cone march: replaces the XLA scan of
// vct_tpu/core/dense.py:134 directional_march_multi (three one-hot
// interpolation-matrix einsums a step, :87-117), which the TPU fuses into
// one program; the port had no compiler to fuse it and ran thousands of
// eager launches a march.
//
// What it computes, for every direction b and every output cell (x, y,
// z): the cone schedule front to back, each step one or two taps of a
// mip level at a constant world shift and, for a two-level step, their
// lerp by the plan's float32 weight; then the composite of
// vct_tpu_torch/ops/dense.py march_steps (opacity gain, keep = (1 - a)^sf
// as PyTorch's pow by a scalar evaluates it, the optical-depth correction,
// the loop-top early-out).  A tap is a separable shifted resample: x from
// the tap row's (i0, i1, w0, w1), then y, then z, each axis multiplying
// and adding in float32, the first two axes' results rounded to the
// compute dtype (bfloat16 or float32), the level read in its own dtype and
// rounded to the compute dtype as `.to(wd)` rounds it.  An anisotropic
// level (d, d, d, 6, C) resamples its six directions and blends them by
// the direction's static weights in core/aniso.py blend's order.  Every
// multiply and add is rounded on its own (the *_rn helpers), and a
// division by the per-step attenuation is a multiply by its float32
// reciprocal, as PyTorch's CUDA division by a Python scalar computes it,
// so the kernel can equal the plain version bit for bit.
//
// Output: float32 (nx, ny, nz, nb * 4), per direction (rgb, occlusion);
// or (nx, ny, nz, nb) transmittance.  The tap table holds, for each
// direction and tap, one row [x i0 | x i1 | y i0 | y i1 | z i0 | z i1] of
// lengths (nx, nx, ny, ny, nz, nz), and the weights in the same layout,
// so a brick's x rows (with halo) and full y and z rows fit one layout.
//
// What bounds it: operations.  A tap costs 21 float operations a channel
// (8 level reads, 4 + 2 + 1 lerps) and the pyramid it reads is tens of MB,
// so the bytes a march must move take well under a millisecond while the
// operations take milliseconds.  The design is the simple one: one thread
// an output cell and direction, its carry (t, rgb, occlusion) in
// registers across every step, z the fastest thread index so a warp's x
// and y taps are uniform and its z taps read neighbouring level cells
// (the level's reuse is left to L1 and L2).  In field mode a thread leaves
// its loop once 1 - t >= max_alpha, which is exact: nothing changes after
// it.  Offsets are 64-bit (multihost512's 512^3 x 4 levels exceed 2^31
// elements).
#include <type_traits>

#include "common.cuh"

constexpr int kMaxLevels = 16;
constexpr int kThreads = 128;

// per level: base pointer (in elements of the level dtype, channel 0 of
// the march's first channel), element strides of x, y, z, of the six
// directions (anisotropic levels) and of the channels; nd = 1 or 6
struct Levels {
    const void* ptr[kMaxLevels];
    long long sx[kMaxLevels], sy[kMaxLevels], sz[kMaxLevels];
    long long s6[kMaxLevels], sc[kMaxLevels];
    int nd[kMaxLevels];
};

template <bool BF>
__device__ __forceinline__ float to_compute(float v) {
    if constexpr (BF) return __bfloat162float(__float2bfloat16_rn(v));
    return v;
}

template <typename T>
__device__ __forceinline__ float load_level(const T* p) {
    if constexpr (std::is_same_v<T, float>) return __ldg(p);
    else return __bfloat162float(*p);
}

// the separable resample of one tap at this thread's cell, NC channels,
// blended over an anisotropic level's six directions
template <typename T, int NC, bool BF>
__device__ __forceinline__ void resample(const Levels& L, int lv,
                                         const int* __restrict__ ti,
                                         const float* __restrict__ tw,
                                         int x, int y, int z, int nx, int ny,
                                         int nz, const float* wd, float* s) {
    const int oy = 2 * nx, oz = 2 * nx + 2 * ny;
    const long long sx = L.sx[lv], sy = L.sy[lv], sz = L.sz[lv];
    const long long ox[2] = {ti[x] * sx, ti[nx + x] * sx};
    const float wx[2] = {tw[x], tw[nx + x]};
    const long long oyv[2] = {ti[oy + y] * sy, ti[oy + ny + y] * sy};
    const float wy[2] = {tw[oy + y], tw[oy + ny + y]};
    const long long ozv[2] = {ti[oz + z] * sz, ti[oz + nz + z] * sz};
    const float wz[2] = {tw[oz + z], tw[oz + nz + z]};
    const T* base = static_cast<const T*>(L.ptr[lv]);
    const int nd = L.nd[lv];
    for (int d = 0; d < nd; ++d) {
        const T* p = base + d * L.s6[lv];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            const T* pc = p + c * L.sc[lv];
            float o0[2][2];
#pragma unroll
            for (int jy = 0; jy < 2; ++jy) {
#pragma unroll
                for (int jz = 0; jz < 2; ++jz) {
                    const long long off = oyv[jy] + ozv[jz];
                    const float a = to_compute<BF>(load_level(pc + ox[0] + off));
                    const float b = to_compute<BF>(load_level(pc + ox[1] + off));
                    o0[jy][jz] = to_compute<BF>(
                        add_rn(mul_rn(a, wx[0]), mul_rn(b, wx[1])));
                }
            }
            float o1[2];
#pragma unroll
            for (int jz = 0; jz < 2; ++jz) {
                o1[jz] = to_compute<BF>(
                    add_rn(mul_rn(o0[0][jz], wy[0]), mul_rn(o0[1][jz], wy[1])));
            }
            const float r = add_rn(mul_rn(o1[0], wz[0]), mul_rn(o1[1], wz[1]));
            if (nd == 1) s[c] = r;
            else if (d == 0) s[c] = mul_rn(wd[0], r);
            else s[c] = add_rn(s[c], mul_rn(wd[d], r));
        }
    }
}

// keep = (1 - a)^sf as at::pow(Tensor, Scalar) evaluates it on the card:
// mode 0 sf == 1 (identity), 1 sqrt, 2 x * x, 3 x * x * x, 4 powf
__device__ __forceinline__ float keep_of(float x, int mode, float sf) {
    switch (mode) {
        case 0: return x;
        case 1: return __fsqrt_rn(x);
        case 2: return mul_rn(x, x);
        case 3: return mul_rn(mul_rn(x, x), x);
        default: return powf(x, sf);
    }
}

// step_i[k] = (first tap, its level, second tap or -1, its level);
// step_f[k] = (lerp weight w, 1 - w, float32 reciprocal of the
// attenuation)
template <typename T, int NC, bool BF, bool TRANS>
__global__ void __launch_bounds__(kThreads) dense_kernel(
    Levels L, const int* __restrict__ tidx, const float* __restrict__ tw,
    int ntaps, const int4* __restrict__ step_i,
    const float* __restrict__ step_f, int nsteps,
    const float* __restrict__ w6, int nx, int ny, int nz, int pow_mode,
    float sf, int use_gain, float gain, float max_alpha,
    float* __restrict__ out, int* __restrict__ walked) {
    const long long cells = static_cast<long long>(nx) * ny * nz;
    const long long cell = static_cast<long long>(blockIdx.x) * blockDim.x
                           + threadIdx.x;
    if (cell >= cells) return;
    const int b = blockIdx.y, nb = gridDim.y;
    const int z = static_cast<int>(cell % nz);
    const int y = static_cast<int>((cell / nz) % ny);
    const int x = static_cast<int>(cell / (static_cast<long long>(ny) * nz));
    const long long row = 2LL * (nx + ny + nz);
    const int* ti = tidx + static_cast<long long>(b) * ntaps * row;
    const float* tb = tw + static_cast<long long>(b) * ntaps * row;
    float wd[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) wd[k] = w6[b * 6 + k];

    float t = 1.0f, occ = 0.0f, col[3] = {0.0f, 0.0f, 0.0f};
    int k = 0;
    for (; k < nsteps; ++k) {
        // loop-top early-out (fs:94): once 1 - t >= max_alpha the carry
        // no longer changes
        if (!TRANS && !(sub_rn(1.0f, t) < max_alpha)) break;
        const int4 si = step_i[k];
        float s[NC];
        resample<T, NC, BF>(L, si.y, ti + si.x * row, tb + si.x * row, x, y,
                            z, nx, ny, nz, wd, s);
        if (si.z >= 0) {
            float s1[NC];
            resample<T, NC, BF>(L, si.w, ti + si.z * row, tb + si.z * row, x,
                                y, z, nx, ny, nz, wd, s1);
            const float w = step_f[3 * k], omw = step_f[3 * k + 1];
#pragma unroll
            for (int c = 0; c < NC; ++c)
                s[c] = add_rn(mul_rn(s[c], omw), mul_rn(s1[c], w));
        }
        float a = s[NC - 1];
        if (use_gain) a = fminf(mul_rn(a, gain), 1.0f);
        const float keep = keep_of(sub_rn(1.0f, a), pow_mode, sf);
        if constexpr (TRANS) {
            t = mul_rn(t, keep);
        } else {
            float rgb[3] = {s[0], s[1], s[2]};
            if (pow_mode != 0) {
                // optical-depth correction: one sample stands in for sf
                const float scale = a > 1e-6f
                    ? div_rn(sub_rn(1.0f, keep), fmaxf(a, 1e-6f)) : sf;
#pragma unroll
                for (int c = 0; c < 3; ++c) rgb[c] = mul_rn(rgb[c], scale);
                a = sub_rn(1.0f, keep);
            }
#pragma unroll
            for (int c = 0; c < 3; ++c) col[c] = add_rn(col[c], mul_rn(t, rgb[c]));
            occ = add_rn(occ, mul_rn(mul_rn(t, a), step_f[3 * k + 2]));
            t = mul_rn(t, keep);
        }
    }
    if (walked) walked[cell * nb + b] = k;
    if constexpr (TRANS) {
        out[cell * nb + b] = t;
    } else {
        float* o = out + (cell * nb + b) * 4;
        o[0] = col[0];
        o[1] = col[1];
        o[2] = col[2];
        o[3] = occ;
    }
}

template <typename T, int NC, bool BF, bool TRANS>
static void launch(const Levels& L, const int* tidx, const float* tw,
                   int ntaps, const int* step_i, const float* step_f,
                   int nsteps, const float* w6, int nb, int nx, int ny,
                   int nz, int pow_mode, float sf, int use_gain, float gain,
                   float max_alpha, float* out, int* walked,
                   cudaStream_t stream) {
    const long long cells = static_cast<long long>(nx) * ny * nz;
    const dim3 grid(static_cast<unsigned>((cells + kThreads - 1) / kThreads),
                    static_cast<unsigned>(nb));
    dense_kernel<T, NC, BF, TRANS><<<grid, kThreads, 0, stream>>>(
        L, tidx, tw, ntaps, reinterpret_cast<const int4*>(step_i), step_f,
        nsteps, w6, nx, ny, nz, pow_mode, sf, use_gain, gain, max_alpha, out,
        walked);
}

template <typename T>
static void dispatch(const Levels& L, int transmittance, int compute_bf16,
                     const int* tidx, const float* tw, int ntaps,
                     const int* step_i, const float* step_f, int nsteps,
                     const float* w6, int nb, int nx, int ny, int nz,
                     int pow_mode, float sf, int use_gain, float gain,
                     float max_alpha, float* out, int* walked,
                     cudaStream_t stream) {
#define VCT_DENSE_ARGS L, tidx, tw, ntaps, step_i, step_f, nsteps, w6, nb, \
    nx, ny, nz, pow_mode, sf, use_gain, gain, max_alpha, out, walked, stream
    if (transmittance) {
        if (compute_bf16) launch<T, 1, true, true>(VCT_DENSE_ARGS);
        else launch<T, 1, false, true>(VCT_DENSE_ARGS);
    } else {
        if (compute_bf16) launch<T, 4, true, false>(VCT_DENSE_ARGS);
        else launch<T, 4, false, false>(VCT_DENSE_ARGS);
    }
#undef VCT_DENSE_ARGS
}

// level_ptr (nl), level_stride (nl x 5: sx, sy, sz, s6, sc) and level_nd
// (nl) are host arrays; every other pointer is on the card.  The caller
// checks that every tap index lies inside its level.  walked, where not
// null, receives each (cell, direction)'s steps taken before its
// early-out (every step in transmittance mode): the work this run's data
// needed.
VCT_EXPORT int vct_dense_march(const long long* level_ptr,
                               const long long* level_stride,
                               const int* level_nd, int nl, int level_bf16,
                               int transmittance, int compute_bf16,
                               const int* tidx, const float* tw, int ntaps,
                               const int* step_i, const float* step_f,
                               int nsteps, const float* w6, int nb, int nx,
                               int ny, int nz, int pow_mode, float sf,
                               int use_gain, float gain, float max_alpha,
                               float* out, int* walked,
                               cudaStream_t stream) {
    if (nl < 1 || nl > kMaxLevels || nb < 1 || nb > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    Levels L;
    for (int i = 0; i < nl; ++i) {
        L.ptr[i] = reinterpret_cast<const void*>(level_ptr[i]);
        L.sx[i] = level_stride[5 * i];
        L.sy[i] = level_stride[5 * i + 1];
        L.sz[i] = level_stride[5 * i + 2];
        L.s6[i] = level_stride[5 * i + 3];
        L.sc[i] = level_stride[5 * i + 4];
        L.nd[i] = level_nd[i];
    }
    if (level_bf16)
        dispatch<__nv_bfloat16>(L, transmittance, compute_bf16, tidx, tw,
                                ntaps, step_i, step_f, nsteps, w6, nb, nx, ny,
                                nz, pow_mode, sf, use_gain, gain, max_alpha,
                                out, walked, stream);
    else
        dispatch<float>(L, transmittance, compute_bf16, tidx, tw, ntaps,
                        step_i, step_f, nsteps, w6, nb, nx, ny, nz, pow_mode,
                        sf, use_gain, gain, max_alpha, out, walked, stream);
    return launch_status();
}

// registers, spills, shared bytes and resident warps of the float32-level
// bfloat16-compute instance (the operating point's), field or
// transmittance
VCT_EXPORT int vct_dense_occupancy(int transmittance, int* info) {
    return transmittance
        ? occupancy_info(dense_kernel<float, 1, true, true>, kThreads, 0, info)
        : occupancy_info(dense_kernel<float, 4, true, false>, kThreads, 0, info);
}
