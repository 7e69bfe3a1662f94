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
// compute dtype (bfloat16 or float32).  An anisotropic level (d, d, d, 6,
// C) resamples its six directions and blends them by the direction's
// static weights in core/aniso.py blend's order.  Every multiply and add
// is rounded on its own (the *_rn helpers), and a division by the
// per-step attenuation is a multiply by its float32 reciprocal, as
// PyTorch's CUDA division by a Python scalar computes it, so the kernel
// can equal the plain version bit for bit.
//
// The packed copy.  The march reads its levels from a copy that
// dense_kernel_pack writes in one launch before it: every level a tap
// reads as contiguous, channel-last values of the compute dtype, (d, d,
// d, C) for an isotropic level, (d, d, d, 6C) for a 6-direction one
// (core/aniso.py packed's layout), alpha alone for a transmittance march.
// Rounding each value to the compute dtype once there gives the bits the
// plain version's `.to(wd)` gives, and each corner of a tap is then one
// voxel of nd * C contiguous values, read in loads as wide as the voxel
// allows up to 16 bytes (Chunks): an isotropic rgba corner is one 8-byte
// (bfloat16) or 16-byte (float32) load, a 6-direction one three or six
// 16-byte loads.  The wrapper (ops/dense.py pack_levels_cuda) skips the
// copy of a level already in that layout.
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
#include <cstring>
#include <type_traits>

#include "common.cuh"

constexpr int kMaxLevels = 16;
constexpr int kThreads = 128;
constexpr int kPackThreads = 256;

// per packed level: base pointer (elements of the compute dtype) and the
// element strides of x and y (z's is the voxel's nd * C values: the copy
// is contiguous); nd = 1 or 6
struct Levels {
    const void* ptr[kMaxLevels];
    long long sx[kMaxLevels], sy[kMaxLevels];
    int nd[kMaxLevels];
};

template <typename T>
constexpr bool kBF = std::is_same_v<T, __nv_bfloat16>;

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

// A voxel of V values of CT moves in kCount loads (or stores) of kBytes
// each: the widest power of two up to 16 bytes that divides the voxel, so
// each chunk of every voxel of a 16-byte-aligned copy is aligned to its
// width.
template <typename CT, int V>
struct Chunks {
    static constexpr int kVoxel = V * static_cast<int>(sizeof(CT));
    static constexpr int kBytes = kVoxel % 16 == 0 ? 16
                                : kVoxel % 8 == 0  ? 8
                                : kVoxel % 4 == 0  ? 4 : 2;
    static constexpr int kCount = kVoxel / kBytes;
    static constexpr int kValues = kBytes / static_cast<int>(sizeof(CT));
};

template <int B> struct Word;
template <> struct Word<16> { using type = uint4; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<4> { using type = unsigned int; };
template <> struct Word<2> { using type = unsigned short; };

// N values of CT at p, aligned to their N * sizeof(CT) bytes, as floats:
// one load
template <typename CT, int N>
__device__ __forceinline__ void load_values(const CT* p, float* v) {
    using W = typename Word<N * static_cast<int>(sizeof(CT))>::type;
    const W w = __ldg(reinterpret_cast<const W*>(p));
    CT c[N];
    memcpy(c, &w, sizeof(W));
#pragma unroll
    for (int i = 0; i < N; ++i) {
        if constexpr (kBF<CT>) v[i] = __bfloat162float(c[i]);
        else v[i] = c[i];
    }
}

// the separable resample of one tap at this thread's cell over a packed
// level of ND directions and NC channels, chunk by chunk of each corner's
// voxel, blended over a 6-direction level's directions
template <typename CT, int NC, int ND>
__device__ __forceinline__ void resample(const CT* __restrict__ base,
                                         long long sx, long long sy,
                                         const int* __restrict__ ti,
                                         const float* __restrict__ tw,
                                         int x, int y, int z, int nx, int ny,
                                         int nz, const float* wd, float* s) {
    constexpr bool BF = kBF<CT>;
    constexpr int V = ND * NC;
    using K = Chunks<CT, V>;
    const int oy = 2 * nx, oz = 2 * nx + 2 * ny;
    const long long ox[2] = {ti[x] * sx, ti[nx + x] * sx};
    const float wx[2] = {tw[x], tw[nx + x]};
    const long long oyv[2] = {ti[oy + y] * sy, ti[oy + ny + y] * sy};
    const float wy[2] = {tw[oy + y], tw[oy + ny + y]};
    const long long ozv[2] = {static_cast<long long>(ti[oz + z]) * V,
                              static_cast<long long>(ti[oz + nz + z]) * V};
    const float wz[2] = {tw[oz + z], tw[oz + nz + z]};
#pragma unroll
    for (int q = 0; q < K::kCount; ++q) {
        float o0[2][2][K::kValues];
#pragma unroll
        for (int jy = 0; jy < 2; ++jy) {
#pragma unroll
            for (int jz = 0; jz < 2; ++jz) {
                const CT* p = base + oyv[jy] + ozv[jz] + q * K::kValues;
                float a[K::kValues], b[K::kValues];
                load_values<CT, K::kValues>(p + ox[0], a);
                load_values<CT, K::kValues>(p + ox[1], b);
#pragma unroll
                for (int i = 0; i < K::kValues; ++i)
                    o0[jy][jz][i] = to_compute<BF>(
                        add_rn(mul_rn(a[i], wx[0]), mul_rn(b[i], wx[1])));
            }
        }
#pragma unroll
        for (int i = 0; i < K::kValues; ++i) {
            float o1[2];
#pragma unroll
            for (int jz = 0; jz < 2; ++jz) {
                o1[jz] = to_compute<BF>(add_rn(mul_rn(o0[0][jz][i], wy[0]),
                                               mul_rn(o0[1][jz][i], wy[1])));
            }
            const float r = add_rn(mul_rn(o1[0], wz[0]), mul_rn(o1[1], wz[1]));
            const int d = (q * K::kValues + i) / NC;
            const int c = (q * K::kValues + i) % NC;
            if constexpr (ND == 1) s[c] = r;
            else if (d == 0) s[c] = mul_rn(wd[0], r);
            else s[c] = add_rn(s[c], mul_rn(wd[d], r));
        }
    }
}

template <typename CT, int NC>
__device__ __forceinline__ void tap(const Levels& L, int lv,
                                    const int* __restrict__ ti,
                                    const float* __restrict__ tw, int x,
                                    int y, int z, int nx, int ny, int nz,
                                    const float* wd, float* s) {
    const CT* base = static_cast<const CT*>(L.ptr[lv]);
    if (L.nd[lv] == 1)
        resample<CT, NC, 1>(base, L.sx[lv], L.sy[lv], ti, tw, x, y, z, nx,
                            ny, nz, wd, s);
    else
        resample<CT, NC, 6>(base, L.sx[lv], L.sy[lv], ti, tw, x, y, z, nx,
                            ny, nz, wd, s);
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
template <typename CT, int NC, bool TRANS>
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
        tap<CT, NC>(L, si.y, ti + si.x * row, tb + si.x * row, x, y, z, nx,
                    ny, nz, wd, s);
        if (si.z >= 0) {
            float s1[NC];
            tap<CT, NC>(L, si.w, ti + si.z * row, tb + si.z * row, x, y, z,
                        nx, ny, nz, wd, s1);
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
        *reinterpret_cast<float4*>(out + (cell * nb + b) * 4) =
            make_float4(col[0], col[1], col[2], occ);
    }
}

// per level to pack: the source (elements of the level dtype, at the
// march's first channel of direction 0), its element strides of x, y, z,
// of the six directions and of the channels, its cells along x, y, z, nd,
// the destination (contiguous, nd * NC values a voxel, 16-byte aligned),
// and the first block of the launch that packs it
struct PackLevels {
    const void* src[kMaxLevels];
    void* dst[kMaxLevels];
    long long sx[kMaxLevels], sy[kMaxLevels], sz[kMaxLevels];
    long long s6[kMaxLevels], sc[kMaxLevels];
    int n[kMaxLevels][3];
    int nd[kMaxLevels];
    int block0[kMaxLevels + 1];
    int nl;
};

// one voxel's ND * NC values, each read in the level dtype and rounded to
// the compute dtype as `.to(wd)` rounds it, written in Chunks' stores
template <typename ST, typename CT, int NC, int ND>
__device__ __forceinline__ void pack_voxel(const ST* p, long long s6,
                                           long long sc, CT* out) {
    using K = Chunks<CT, ND * NC>;
    using W = typename Word<K::kBytes>::type;
#pragma unroll
    for (int q = 0; q < K::kCount; ++q) {
        CT c[K::kValues];
#pragma unroll
        for (int i = 0; i < K::kValues; ++i) {
            const int e = q * K::kValues + i;
            const float f = load_level(p + (e / NC) * s6 + (e % NC) * sc);
            if constexpr (kBF<CT>) c[i] = __float2bfloat16_rn(f);
            else c[i] = f;
        }
        W w;
        memcpy(&w, c, sizeof(W));
        reinterpret_cast<W*>(out)[q] = w;
    }
}

// the packed copy of every level of a march, one thread a voxel; a block
// finds its level among the launch's first blocks
template <typename ST, typename CT, int NC>
__global__ void __launch_bounds__(kPackThreads) dense_kernel_pack(
    PackLevels P) {
    int l = 0;
    while (l + 1 < P.nl && static_cast<int>(blockIdx.x) >= P.block0[l + 1])
        ++l;
    const unsigned v = static_cast<unsigned>(blockIdx.x - P.block0[l])
                       * kPackThreads + threadIdx.x;
    const unsigned n1 = P.n[l][1], n2 = P.n[l][2];
    if (v >= static_cast<unsigned>(P.n[l][0]) * n1 * n2) return;
    const unsigned z = v % n2, y = (v / n2) % n1, x = v / (n1 * n2);
    const ST* p = static_cast<const ST*>(P.src[l]) + x * P.sx[l]
                  + y * P.sy[l] + z * P.sz[l];
    CT* dst = static_cast<CT*>(P.dst[l]);
    if (P.nd[l] == 1)
        pack_voxel<ST, CT, NC, 1>(p, P.s6[l], P.sc[l],
                                  dst + static_cast<long long>(v) * NC);
    else
        pack_voxel<ST, CT, NC, 6>(p, P.s6[l], P.sc[l],
                                  dst + static_cast<long long>(v) * 6 * NC);
}

template <typename ST, typename CT>
static void launch_pack(const PackLevels& P, int nc, cudaStream_t stream) {
    const dim3 grid(static_cast<unsigned>(P.block0[P.nl]));
    if (nc == 1)
        dense_kernel_pack<ST, CT, 1><<<grid, kPackThreads, 0, stream>>>(P);
    else
        dense_kernel_pack<ST, CT, 4><<<grid, kPackThreads, 0, stream>>>(P);
}

// src_ptr (nl), src_stride (nl x 5: sx, sy, sz, s6, sc, in elements of the
// level dtype), shape (nl x 3), nd (nl) and dst_ptr (nl) are host arrays;
// nc = 1 (transmittance) or 4.  Each level has fewer than 2^31 voxels.
VCT_EXPORT int vct_dense_pack(const long long* src_ptr,
                              const long long* src_stride, const int* shape,
                              const int* nd, const long long* dst_ptr,
                              int nl, int nc, int level_bf16,
                              int compute_bf16, cudaStream_t stream) {
    if (nl < 1 || nl > kMaxLevels || (nc != 1 && nc != 4))
        return static_cast<int>(cudaErrorInvalidValue);
    PackLevels P;
    P.nl = nl;
    long long blocks = 0;
    for (int i = 0; i < nl; ++i) {
        P.src[i] = reinterpret_cast<const void*>(src_ptr[i]);
        P.dst[i] = reinterpret_cast<void*>(dst_ptr[i]);
        P.sx[i] = src_stride[5 * i];
        P.sy[i] = src_stride[5 * i + 1];
        P.sz[i] = src_stride[5 * i + 2];
        P.s6[i] = src_stride[5 * i + 3];
        P.sc[i] = src_stride[5 * i + 4];
        long long voxels = 1;
        for (int a = 0; a < 3; ++a) {
            P.n[i][a] = shape[3 * i + a];
            voxels *= shape[3 * i + a];
        }
        P.nd[i] = nd[i];
        if (voxels < 1 || voxels >= (1LL << 31) || (nd[i] != 1 && nd[i] != 6))
            return static_cast<int>(cudaErrorInvalidValue);
        P.block0[i] = static_cast<int>(blocks);
        blocks += (voxels + kPackThreads - 1) / kPackThreads;
    }
    if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
    P.block0[nl] = static_cast<int>(blocks);
    if (level_bf16) {
        if (compute_bf16) launch_pack<__nv_bfloat16, __nv_bfloat16>(P, nc, stream);
        else launch_pack<__nv_bfloat16, float>(P, nc, stream);
    } else {
        if (compute_bf16) launch_pack<float, __nv_bfloat16>(P, nc, stream);
        else launch_pack<float, float>(P, nc, stream);
    }
    return launch_status();
}

// ---- the tap table -------------------------------------------------------
//
// The march's tap table, written on the card (core/dense.py march_plan):
// for every direction b, tap j, axis and output cell i along it, the two
// nonzeros of the reference's interpolation-matrix row, in core/dense.py
// direction_taps' arithmetic, operation for operation: in float64 the
// shift s = (d * dist) / (ws / dl) and t = ((i + 0.5) * (dl / n) + s) -
// 0.5; i0 = floor(t), f = t - i0 rounded to float32; clamp-to-edge
// indices; w0 = 1 - f, w1 = f in float32, merged where both indices clamp
// to one cell; each weight rounded to the compute dtype.  The *_rn
// intrinsics keep nvcc from contracting a multiply and an add into one
// fused operation, so the table equals the host's bit for bit.

constexpr int kTapThreads = 256;
constexpr int kMaxTapDirs = 64;

// the directions, by value: no copy to the card before the launch
struct TapDirs {
    double d[kMaxTapDirs][3];
};

// one thread a (direction, tap, axis, cell) entry; rows of the output as
// the march reads them, (nb, ntaps, 6n): [x i0 | x i1 | y i0 | y i1 | z
// i0 | z i1], n cells an axis
template <bool BF>
__global__ void __launch_bounds__(kTapThreads) dense_kernel_taps(
    TapDirs D, const double* __restrict__ dist, const int* __restrict__ dl,
    int ntaps, int n, double world_size, int* __restrict__ idx,
    float* __restrict__ w) {
    const long long per = 3LL * ntaps * n;
    const long long e = static_cast<long long>(blockIdx.x) * blockDim.x
                        + threadIdx.x;
    if (e >= per) return;
    const int b = blockIdx.y;
    const int i = static_cast<int>(e % n);
    const int ax = static_cast<int>((e / n) % 3);
    const int j = static_cast<int>(e / (3LL * n));
    const int L = dl[j];
    const double ld = static_cast<double>(L);
    const double shift = __ddiv_rn(__dmul_rn(D.d[b][ax], dist[j]),
                                   __ddiv_rn(world_size, ld));
    const double t = __dadd_rn(
        __dadd_rn(__dmul_rn(__dadd_rn(static_cast<double>(i), 0.5),
                            __ddiv_rn(ld, static_cast<double>(n))),
                  shift),
        -0.5);
    const double fl = floor(t);
    const float f = __double2float_rn(__dadd_rn(t, -fl));
    const long long i0 = static_cast<long long>(fl);
    const int i0c = static_cast<int>(min(max(i0, 0LL),
                                         static_cast<long long>(L - 1)));
    const int i1 = static_cast<int>(min(max(i0 + 1, 0LL),
                                        static_cast<long long>(L - 1)));
    const float one_m = __fsub_rn(1.0f, f);
    const bool same = i0c == i1;
    const float w0 = to_compute<BF>(same ? __fadd_rn(one_m, f) : one_m);
    const float w1 = to_compute<BF>(same ? 0.0f : f);
    const long long row = (static_cast<long long>(b) * ntaps + j) * 6LL * n
                          + 2LL * ax * n;
    idx[row + i] = i0c;
    idx[row + n + i] = i1;
    w[row + i] = w0;
    w[row + n + i] = w1;
}

// dirs (nb x 3 float64) is a host array, at most kMaxTapDirs directions;
// dist (ntaps float64: each tap's distance along the cone) and dl (ntaps
// int32: the size of each tap's level) are on the card, as are idx
// (int32) and w (float32), each (nb, ntaps, 6n).
VCT_EXPORT int vct_dense_taps(const double* dirs, int nb, const double* dist,
                              const int* dl, int ntaps, int n,
                              double world_size, int compute_bf16, int* idx,
                              float* w, cudaStream_t stream) {
    const long long blocks = (3LL * ntaps * n + kTapThreads - 1) / kTapThreads;
    if (nb < 1 || nb > kMaxTapDirs || ntaps < 1 || n < 1
        || blocks >= (1LL << 31))
        return static_cast<int>(cudaErrorInvalidValue);
    TapDirs D;
    for (int b = 0; b < nb; ++b)
        for (int a = 0; a < 3; ++a) D.d[b][a] = dirs[3 * b + a];
    const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(nb));
    if (compute_bf16)
        dense_kernel_taps<true><<<grid, kTapThreads, 0, stream>>>(
            D, dist, dl, ntaps, n, world_size, idx, w);
    else
        dense_kernel_taps<false><<<grid, kTapThreads, 0, stream>>>(
            D, dist, dl, ntaps, n, world_size, idx, w);
    return launch_status();
}

template <typename CT, int NC, bool TRANS>
static void launch(const Levels& L, const int* tidx, const float* tw,
                   int ntaps, const int* step_i, const float* step_f,
                   int nsteps, const float* w6, int nb, int nx, int ny,
                   int nz, int pow_mode, float sf, int use_gain, float gain,
                   float max_alpha, float* out, int* walked,
                   cudaStream_t stream) {
    const long long cells = static_cast<long long>(nx) * ny * nz;
    const dim3 grid(static_cast<unsigned>((cells + kThreads - 1) / kThreads),
                    static_cast<unsigned>(nb));
    dense_kernel<CT, NC, TRANS><<<grid, kThreads, 0, stream>>>(
        L, tidx, tw, ntaps, reinterpret_cast<const int4*>(step_i), step_f,
        nsteps, w6, nx, ny, nz, pow_mode, sf, use_gain, gain, max_alpha, out,
        walked);
}

// level_ptr (nl), level_stride (nl x 2: sx, sy) and level_nd (nl) are
// host arrays describing the packed copies (ops/dense.py
// pack_levels_cuda): contiguous, channel-last, of the compute dtype,
// 16-byte aligned; a level no tap reads may be null.  Every other pointer
// is on the card.  The caller checks that every tap index lies inside its
// level.  walked, where not null, receives each (cell, direction)'s steps
// taken before its early-out (every step in transmittance mode): the work
// this run's data needed.
VCT_EXPORT int vct_dense_march(const long long* level_ptr,
                               const long long* level_stride,
                               const int* level_nd, int nl,
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
        L.sx[i] = level_stride[2 * i];
        L.sy[i] = level_stride[2 * i + 1];
        L.nd[i] = level_nd[i];
    }
#define VCT_DENSE_ARGS L, tidx, tw, ntaps, step_i, step_f, nsteps, w6, nb, \
    nx, ny, nz, pow_mode, sf, use_gain, gain, max_alpha, out, walked, stream
    if (transmittance) {
        if (compute_bf16) launch<__nv_bfloat16, 1, true>(VCT_DENSE_ARGS);
        else launch<float, 1, true>(VCT_DENSE_ARGS);
    } else {
        if (compute_bf16) launch<__nv_bfloat16, 4, false>(VCT_DENSE_ARGS);
        else launch<float, 4, false>(VCT_DENSE_ARGS);
    }
#undef VCT_DENSE_ARGS
    return launch_status();
}

// registers, spills, shared bytes and resident warps of the bfloat16-
// compute instance (the operating point's), field or transmittance
VCT_EXPORT int vct_dense_occupancy(int transmittance, int* info) {
    return transmittance
        ? occupancy_info(dense_kernel<__nv_bfloat16, 1, true>, kThreads, 0,
                         info)
        : occupancy_info(dense_kernel<__nv_bfloat16, 4, false>, kThreads, 0,
                         info);
}
