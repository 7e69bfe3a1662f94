// Per-tile shadow + basis-field taps with in-kernel cone weighting:
// replaces vct_tpu/ops/tap_pallas.py tap_tiles (_tap_kernel,
// _tap_pallas), with the semantics of its oracle tap_tiles_ref.
//
// What it computes, per pixel, at its tile's prepass-selected levels:
//   shadow   trilinear tap of the light-transmittance mip at
//            pos + geo * voxel * offset;
//   diffuse  sum_b dw[b] * trilinear(field[b*4 .. b*4+3]) at pos + n*voxel,
//            dw = sum_k cone_w[k] * normalize_b(relu(cone_k . basis_b)^8);
//   specular sum_b sw[b] * trilinear(field[4nb + b*4 ..]) with
//            sw = normalize_b(relu(refl . basis_b)^32), refl the eye ray
//            reflected about the unit bump normal (only when the field
//            carries the specular half, cfield = 8 nb).
// Output row: [shadow, diffuse rgba, specular rgba, 7 zeros].
//
// What bounds it: neither the field reads (each pixel reads 8 corner rows
// of up to 208 bf16 channels, mostly from L1/L2: the 256 pixels of a tile
// hit nearby cells) nor the arithmetic (about 4,000 instructions a pixel,
// 0.3 ms of issue on 132 SMs), but the latency of the dependent gathers,
// which only many resident warps hide.  So the design keeps a thread's
// live state small: one thread a pixel, one 256-thread block a 16x16 tile
// (the prepass's levels are per tile), and the per-pixel basis weights
// (26 diffuse, 26 specular) in dynamic shared memory laid out
// [basis][thread], so each thread reads its own column without bank
// conflicts.  Each cone's 26 sharpened values are computed once, summed,
// and folded into the weights with cone_w / sum; the sharpening powers
// are template constants (^8, ^32: 3 and 5 squarings).  The field taps
// then walk the basis two directions at a time: the 8 corners' 16-byte
// loads (8 bf16 channels each, through the read-only path) are issued
// together, and the trilinear weights, computed once a pixel, fold them
// as sum_k w_k v_k.  At most 80 registers and 53 KB of shared memory a
// block keep 3 blocks, 24 warps, on each SM.  The TPU kernel DMA'd one
// brick per tile and tapped it with two-hot matmuls because the TPU has
// no fast gather; here each thread gathers its own corners directly from
// the selected level (trilinear with edge clamp: tap_tiles_ref's
// semantics, which equals the brick tap whenever the brick covers the
// tile, as the prepass guarantees).  Tables stay bf16 with float32
// accumulation; sums are taken in another order than tap_plain's, within
// 1e-5 of it.
#include "common.cuh"

namespace {

constexpr int kTile = 256;
constexpr int kMinBlocks = 3;
constexpr int kMaxCones = 8;
constexpr int kOut = 16;
constexpr int kSquaringsDiffuse = 3;   // ^8
constexpr int kSquaringsSpecular = 5;  // ^32

__device__ __forceinline__ void norm3(float* v) {
    const float r = rsqrtf(fmaxf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2], 1e-24f));
    v[0] *= r;
    v[1] *= r;
    v[2] *= r;
}

// one basis direction from shared memory, by a load the compiler may not
// hoist out of the cone loop: kept in registers, the 26 float4s (104
// registers) spilled the diffuse-only kernel
__device__ __forceinline__ float4 basis_at(const float4* s_basis, int b) {
    float4 e;
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(e.x), "=f"(e.y), "=f"(e.z), "=f"(e.w)
                 : "r"(static_cast<unsigned>(__cvta_generic_to_shared(s_basis + b))));
    return e;
}

template <int SQ>
__device__ __forceinline__ float sharpen(float w) {
#pragma unroll
    for (int i = 0; i < SQ; ++i) w *= w;
    return w;
}

// offset, in cells, of level `lvl` of a mip chain d0, d0/2, ...
__device__ __forceinline__ long long level_offset(int d0, int lvl) {
    long long off = 0;
    for (int l = 0; l < lvl; ++l) {
        const long long d = d0 >> l;
        off += d * d * d;
    }
    return off;
}

// trilinear_sample's corner cells (order x, y, z: bits 4/2/1) and their
// weights at one level (texel centers at (i + 0.5) / d, edge clamp)
__device__ __forceinline__ void corners(const float* uvw, int d, long long* cell, float* w) {
    int i0[3], i1[3];
    float f[3];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
        const float t = uvw[ax] * static_cast<float>(d) - 0.5f;
        const float fl = floorf(t);
        f[ax] = t - fl;
        const int i = static_cast<int>(fl);
        i0[ax] = min(max(i, 0), d - 1);
        i1[ax] = min(max(i + 1, 0), d - 1);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        const long long x = (k & 4) ? i1[0] : i0[0];
        const long long y = (k & 2) ? i1[1] : i0[1];
        const long long z = (k & 1) ? i1[2] : i0[2];
        cell[k] = (x * d + y) * d + z;
        w[k] = ((k & 4) ? f[0] : 1.0f - f[0]) * ((k & 2) ? f[1] : 1.0f - f[1])
             * ((k & 1) ? f[2] : 1.0f - f[2]);
    }
}

// two basis directions (8 bf16 channels) at 16-byte column `col` of every
// corner row, trilinearly weighted: the 8 loads first, then the sums
__device__ __forceinline__ void tap8(const uint4* const* rows, int col, const float* w,
                                     float* t8) {
    uint4 raw[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) raw[k] = __ldg(rows[k] + col);
#pragma unroll
    for (int q = 0; q < 8; ++q) t8[q] = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        const unsigned int wd[4] = {raw[k].x, raw[k].y, raw[k].z, raw[k].w};
#pragma unroll
        for (int h = 0; h < 4; ++h) {
            // bf16 -> float: the 16 bits become a float's high half
            t8[2 * h] += w[k] * __uint_as_float(wd[h] << 16);
            t8[2 * h + 1] += w[k] * __uint_as_float(wd[h] & 0xffff0000u);
        }
    }
}

template <int NB, bool SPEC>
__global__ void __launch_bounds__(kTile, kMinBlocks)
tap_kernel(const float* __restrict__ gbuf, int gcols, const int* __restrict__ scal8,
           const float* __restrict__ bumpn, const float* __restrict__ campos,
           const __nv_bfloat16* __restrict__ light, int ld0,
           const __nv_bfloat16* __restrict__ field, int fd0,
           const float* __restrict__ consts, int ncones, float half_ws, float voxel,
           float voxel_off, float* __restrict__ out) {
    // consts: basis (NB x 3), cone directions (ncones x 3), cone weights
    __shared__ float4 s_basis[NB];
    __shared__ float s_cone[kMaxCones * 4];
    extern __shared__ float s_w[];     // [NB diffuse (+ NB specular)][kTile]
    for (int i = threadIdx.x; i < NB; i += kTile)
        s_basis[i] = make_float4(consts[3 * i], consts[3 * i + 1], consts[3 * i + 2], 0.0f);
    for (int i = threadIdx.x; i < ncones * 4; i += kTile) s_cone[i] = consts[NB * 3 + i];
    __syncthreads();

    const int tid = threadIdx.x;
    const int tile = blockIdx.x;
    const long long px = static_cast<long long>(tile) * kTile + tid;
    const float* g = gbuf + px * gcols;
    const int* sc = scal8 + tile * 8;
    float pos[3], nrm[3], tan[3], bit[3], ul[3], uf[3];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
        pos[ax] = g[ax];
        nrm[ax] = g[3 + ax];
        tan[ax] = g[9 + ax];
        bit[ax] = g[12 + ax];
        ul[ax] = world_to_uvw(g[ax] + g[6 + ax] * voxel_off, half_ws);
        uf[ax] = world_to_uvw(g[ax] + g[3 + ax] * voxel, half_ws);
    }

    // ---- shadow: light level sc[0] ----
    float shadow = 0.0f;
    {
        long long cell[8];
        float w[8];
        corners(ul, ld0 >> sc[0], cell, w);
        const __nv_bfloat16* lvl = light + level_offset(ld0, sc[0]);
        float v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = __bfloat162float(lvl[cell[k]]);
#pragma unroll
        for (int k = 0; k < 8; ++k) shadow += w[k] * v[k];
    }

    // ---- diffuse weights: each cone's sharpened basis values once ----
#pragma unroll 1
    for (int k = 0; k < ncones; ++k) {
        const float* cd = s_cone + 3 * k;
        float dv[3];
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) dv[ax] = tan[ax] * cd[0] + bit[ax] * cd[1] + nrm[ax] * cd[2];
        norm3(dv);
        float p[NB];
        float sum = 0.0f;
#pragma unroll
        for (int b = 0; b < NB; ++b) {
            const float4 e = basis_at(s_basis, b);
            p[b] = sharpen<kSquaringsDiffuse>(fmaxf(dv[0] * e.x + dv[1] * e.y + dv[2] * e.z, 0.0f));
            sum += p[b];
        }
        const float scale = s_cone[3 * ncones + k] / fmaxf(sum, 1e-8f);
#pragma unroll
        for (int b = 0; b < NB; ++b) {
            float* dst = s_w + b * kTile + tid;
            *dst = (k == 0 ? 0.0f : *dst) + scale * p[b];
        }
    }

    // ---- specular weights: reflection about the unit bump normal ----
    if (SPEC) {
        const float4 bn = reinterpret_cast<const float4*>(bumpn)[px];
        float sn[3] = {bn.x, bn.y, bn.z};
        float eye[3], refl[3];
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) eye[ax] = campos[ax] - pos[ax];
        norm3(sn);
        norm3(eye);
        const float ne = sn[0] * eye[0] + sn[1] * eye[1] + sn[2] * eye[2];
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) refl[ax] = 2.0f * ne * sn[ax] - eye[ax];
        norm3(refl);   // must be unit: ^32 of a longer vector overflows
        float p[NB];
        float sum = 0.0f;
#pragma unroll
        for (int b = 0; b < NB; ++b) {
            const float4 e = s_basis[b];
            p[b] = sharpen<kSquaringsSpecular>(
                fmaxf(refl[0] * e.x + refl[1] * e.y + refl[2] * e.z, 0.0f));
            sum += p[b];
        }
        const float inv = 1.0f / fmaxf(sum, 1e-8f);
#pragma unroll
        for (int b = 0; b < NB; ++b) s_w[(NB + b) * kTile + tid] = p[b] * inv;
    }

    // ---- field taps at level sc[4], two basis directions a step ----
    constexpr int kCols = (SPEC ? 8 : 4) * NB / 8;    // 16-byte columns a row
    float acc_d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float acc_s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    {
        long long cell[8];
        float w[8];
        corners(uf, fd0 >> sc[4], cell, w);
        const uint4* lvl = reinterpret_cast<const uint4*>(field) + level_offset(fd0, sc[4]) * kCols;
        const uint4* rows[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) rows[k] = lvl + cell[k] * kCols;
#pragma unroll 1
        for (int bp = 0; bp < NB / 2; ++bp) {
            float t8[8];
            tap8(rows, bp, w, t8);
            const float w0 = s_w[(2 * bp) * kTile + tid];
            const float w1 = s_w[(2 * bp + 1) * kTile + tid];
#pragma unroll
            for (int q = 0; q < 4; ++q) acc_d[q] += w0 * t8[q] + w1 * t8[4 + q];
            if (SPEC) {
                tap8(rows, NB / 2 + bp, w, t8);
                const float s0 = s_w[(NB + 2 * bp) * kTile + tid];
                const float s1 = s_w[(NB + 2 * bp + 1) * kTile + tid];
#pragma unroll
                for (int q = 0; q < 4; ++q) acc_s[q] += s0 * t8[q] + s1 * t8[4 + q];
            }
        }
    }

    float4* dst = reinterpret_cast<float4*>(out + px * kOut);
    dst[0] = make_float4(shadow, acc_d[0], acc_d[1], acc_d[2]);
    dst[1] = make_float4(acc_d[3], acc_s[0], acc_s[1], acc_s[2]);
    dst[2] = make_float4(acc_s[3], 0.0f, 0.0f, 0.0f);
    dst[3] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

using TapKernel = decltype(&tap_kernel<26, true>);

// the instance for (nb, cfield) and its dynamic shared bytes, or null
TapKernel pick(int nb, int cfield, int* smem) {
    const bool spec = cfield == 8 * nb;
    if (!spec && cfield != 4 * nb) return nullptr;
    *smem = (spec ? 2 : 1) * nb * kTile * static_cast<int>(sizeof(float));
    if (nb == 26) return spec ? tap_kernel<26, true> : tap_kernel<26, false>;
    if (nb == 6) return spec ? tap_kernel<6, true> : tap_kernel<6, false>;
    return nullptr;
}

// above 48 KB a kernel may use dynamic shared memory only after
// cudaFuncSetAttribute; the carveout asks for all of it, so that 3 blocks
// of 53 KB fit on an SM
cudaError_t allow_smem(TapKernel kernel, int smem) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   static_cast<int>(cudaSharedmemCarveoutMaxShared));
    return err;
}

}  // namespace

VCT_EXPORT int vct_tap(const float* gbuf, int ntiles, int gcols, const int* scal8,
                       const float* bumpn, const float* campos,
                       const __nv_bfloat16* light, int ld0,
                       const __nv_bfloat16* field, int fd0, int cfield,
                       const float* consts, int nb, int ncones, float half_ws,
                       float voxel, float voxel_off, float* out, cudaStream_t stream) {
    int smem = 0;
    const TapKernel kernel = pick(nb, cfield, &smem);
    if (kernel == nullptr || ncones > kMaxCones) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<ntiles, kTile, smem, stream>>>(gbuf, gcols, scal8, bumpn, campos, light, ld0, field,
                                            fd0, consts, ncones, half_ws, voxel, voxel_off, out);
    return launch_status();
}

// the kernel's report (common.cuh occupancy_info) for (nb, cfield)
VCT_EXPORT int vct_tap_occupancy(int nb, int cfield, int* info) {
    int smem = 0;
    const TapKernel kernel = pick(nb, cfield, &smem);
    if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    return occupancy_info(kernel, kTile, smem, info);
}
