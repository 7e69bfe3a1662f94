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
//            reflected about the unit bump normal.
// Output row: [shadow, diffuse rgba, specular rgba, 7 zeros].
//
// What bounds it: the field reads.  Each pixel reads 8 corner rows of
// 2 x 26 x 4 bf16 channels (~3.3 KB); the 256 pixels of a tile hit nearby
// cells, so most reads hit L1/L2 rather than HBM.  The TPU kernel DMA'd one
// brick per tile and tapped it with two-hot matmuls because the TPU has no
// fast gather; here each thread gathers its own corners directly from the
// selected level (trilinear with edge clamp: tap_tiles_ref's semantics,
// which equals the brick tap whenever the brick covers the tile, as the
// prepass guarantees), 4 channels per 8-byte load.  The 26 diffuse and 26
// specular weights live in registers and each basis direction is folded
// into 8 float32 accumulators as soon as it is sampled, so no thread ever
// holds the 208 channels.  Tables stay bf16 with float32 accumulation.
#include "common.cuh"

namespace {

constexpr int kTile = 256;
constexpr int kMaxCones = 8;
constexpr int kOut = 16;

struct Corners {
    long long row[8];          // corner cell index, order (x, y, z) bits 4/2/1
    float fx, fy, fz;
};

// trilinear_sample's corner cells and weights at one level (texel centers
// at (i + 0.5) / d, edge clamp)
__device__ __forceinline__ Corners corners(const float* uvw, int d) {
    int i0[3], i1[3];
    float f[3];
    for (int ax = 0; ax < 3; ++ax) {
        const float t = uvw[ax] * static_cast<float>(d) - 0.5f;
        const float fl = floorf(t);
        f[ax] = t - fl;
        const int i = static_cast<int>(fl);
        i0[ax] = min(max(i, 0), d - 1);
        i1[ax] = min(max(i + 1, 0), d - 1);
    }
    Corners c;
    for (int k = 0; k < 8; ++k) {
        const long long x = (k & 4) ? i1[0] : i0[0];
        const long long y = (k & 2) ? i1[1] : i0[1];
        const long long z = (k & 1) ? i1[2] : i0[2];
        c.row[k] = (x * d + y) * d + z;
    }
    c.fx = f[0];
    c.fy = f[1];
    c.fz = f[2];
    return c;
}

// lerp order of grid.trilinear_sample: z, then y, then x
__device__ __forceinline__ float trilerp(const float* v, const Corners& c) {
    const float c00 = v[0] * (1.0f - c.fz) + v[1] * c.fz;
    const float c01 = v[2] * (1.0f - c.fz) + v[3] * c.fz;
    const float c10 = v[4] * (1.0f - c.fz) + v[5] * c.fz;
    const float c11 = v[6] * (1.0f - c.fz) + v[7] * c.fz;
    const float c0 = c00 * (1.0f - c.fy) + c01 * c.fy;
    const float c1 = c10 * (1.0f - c.fy) + c11 * c.fy;
    return c0 * (1.0f - c.fx) + c1 * c.fx;
}

// 4 consecutive bf16 channels starting at ch of each corner row
__device__ __forceinline__ void tap4(const __nv_bfloat16* lvl, int cfield, int ch,
                                     const Corners& c, float* out4) {
    float v[4][8];
    for (int k = 0; k < 8; ++k) {
        const uint2 raw = *reinterpret_cast<const uint2*>(lvl + c.row[k] * cfield + ch);
        const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
        const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
        v[0][k] = lo.x;
        v[1][k] = lo.y;
        v[2][k] = hi.x;
        v[3][k] = hi.y;
    }
    for (int q = 0; q < 4; ++q) out4[q] = trilerp(v[q], c);
}

__device__ __forceinline__ void norm3(float* v) {
    const float r = rsqrtf(fmaxf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2], 1e-24f));
    v[0] *= r;
    v[1] *= r;
    v[2] *= r;
}

__device__ __forceinline__ float sharpen(float w, int squarings) {
    for (int i = 0; i < squarings; ++i) w *= w;
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

template <int NB>
__global__ void __launch_bounds__(kTile)
tap_kernel(const float* __restrict__ gbuf, int gcols, const int* __restrict__ scal8,
           const float* __restrict__ bumpn, const float* __restrict__ campos,
           const __nv_bfloat16* __restrict__ light, int ld0,
           const __nv_bfloat16* __restrict__ field, int fd0, int cfield,
           const float* __restrict__ consts, int ncones, int sq_diffuse,
           int sq_specular, float half_ws, float voxel, float voxel_off,
           float* __restrict__ out) {
    // consts: basis (NB x 3), cone directions (ncones x 3), cone weights
    __shared__ float s_basis[NB * 3];
    __shared__ float s_cone[kMaxCones * 4];
    for (int i = threadIdx.x; i < NB * 3; i += kTile) s_basis[i] = consts[i];
    for (int i = threadIdx.x; i < ncones * 4; i += kTile) s_cone[i] = consts[NB * 3 + i];
    __syncthreads();

    const int tile = blockIdx.x;
    const long long px = static_cast<long long>(tile) * kTile + threadIdx.x;
    const float* g = gbuf + px * gcols;
    const int* sc = scal8 + tile * 8;
    float pos[3], nrm[3], tan[3], bit[3], ul[3], uf[3];
    for (int ax = 0; ax < 3; ++ax) {
        pos[ax] = g[ax];
        nrm[ax] = g[3 + ax];
        tan[ax] = g[9 + ax];
        bit[ax] = g[12 + ax];
        ul[ax] = world_to_uvw(g[ax] + g[6 + ax] * voxel_off, half_ws);
        uf[ax] = world_to_uvw(g[ax] + g[3 + ax] * voxel, half_ws);
    }

    // ---- shadow: light level sc[0] ----
    float shadow;
    {
        const int d = ld0 >> sc[0];
        const __nv_bfloat16* lvl = light + level_offset(ld0, sc[0]);
        const Corners c = corners(ul, d);
        float v[8];
        for (int k = 0; k < 8; ++k) v[k] = __bfloat162float(lvl[c.row[k]]);
        shadow = trilerp(v, c);
    }

    // ---- diffuse weights: 6 cones x NB basis, folded by cone weight ----
    float dw[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) dw[b] = 0.0f;
    for (int k = 0; k < ncones; ++k) {
        const float* cd = s_cone + 3 * k;
        float dv[3];
        for (int ax = 0; ax < 3; ++ax) dv[ax] = tan[ax] * cd[0] + bit[ax] * cd[1] + nrm[ax] * cd[2];
        norm3(dv);
        float sum = 0.0f;
#pragma unroll
        for (int b = 0; b < NB; ++b) {
            const float* e = s_basis + 3 * b;
            sum += sharpen(fmaxf(dv[0] * e[0] + dv[1] * e[1] + dv[2] * e[2], 0.0f), sq_diffuse);
        }
        const float inv = 1.0f / fmaxf(sum, 1e-8f);
        const float cw = s_cone[3 * ncones + k];
#pragma unroll
        for (int b = 0; b < NB; ++b) {
            const float* e = s_basis + 3 * b;
            const float w = sharpen(fmaxf(dv[0] * e[0] + dv[1] * e[1] + dv[2] * e[2], 0.0f),
                                    sq_diffuse);
            dw[b] += cw * (w * inv);
        }
    }

    // ---- specular weights: reflection about the unit bump normal ----
    const bool has_spec = cfield > 4 * NB;
    float sw[NB];
    {
        float sn[3], eye[3], refl[3];
        for (int ax = 0; ax < 3; ++ax) {
            sn[ax] = bumpn[px * 4 + ax];
            eye[ax] = campos[ax] - pos[ax];
        }
        norm3(sn);
        norm3(eye);
        const float ne = sn[0] * eye[0] + sn[1] * eye[1] + sn[2] * eye[2];
        for (int ax = 0; ax < 3; ++ax) refl[ax] = 2.0f * ne * sn[ax] - eye[ax];
        norm3(refl);   // must be unit: ^32 of a longer vector overflows
        float sum = 0.0f;
#pragma unroll
        for (int b = 0; b < NB; ++b) {
            const float* e = s_basis + 3 * b;
            sw[b] = sharpen(fmaxf(refl[0] * e[0] + refl[1] * e[1] + refl[2] * e[2], 0.0f),
                            sq_specular);
            sum += sw[b];
        }
        const float inv = 1.0f / fmaxf(sum, 1e-8f);
#pragma unroll
        for (int b = 0; b < NB; ++b) sw[b] *= inv;
    }

    // ---- field taps at level sc[4], folded per basis direction ----
    float acc_d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float acc_s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    {
        const int d = fd0 >> sc[4];
        const __nv_bfloat16* lvl = field + level_offset(fd0, sc[4]) * cfield;
        const Corners c = corners(uf, d);
#pragma unroll
        for (int b = 0; b < NB; ++b) {
            float t4[4];
            tap4(lvl, cfield, 4 * b, c, t4);
            for (int q = 0; q < 4; ++q) acc_d[q] += dw[b] * t4[q];
            if (has_spec) {
                tap4(lvl, cfield, 4 * NB + 4 * b, c, t4);
                for (int q = 0; q < 4; ++q) acc_s[q] += sw[b] * t4[q];
            }
        }
    }

    float4* dst = reinterpret_cast<float4*>(out + px * kOut);
    dst[0] = make_float4(shadow, acc_d[0], acc_d[1], acc_d[2]);
    dst[1] = make_float4(acc_d[3], acc_s[0], acc_s[1], acc_s[2]);
    dst[2] = make_float4(acc_s[3], 0.0f, 0.0f, 0.0f);
    dst[3] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

}  // namespace

VCT_EXPORT int vct_tap(const float* gbuf, int ntiles, int gcols, const int* scal8,
                       const float* bumpn, const float* campos,
                       const __nv_bfloat16* light, int ld0,
                       const __nv_bfloat16* field, int fd0, int cfield,
                       const float* consts, int nb, int ncones, int sq_diffuse,
                       int sq_specular, float half_ws, float voxel, float voxel_off,
                       float* out, cudaStream_t stream) {
    if (ncones > kMaxCones || cfield % 4 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (nb == 26) {
        tap_kernel<26><<<ntiles, kTile, 0, stream>>>(
            gbuf, gcols, scal8, bumpn, campos, light, ld0, field, fd0, cfield, consts,
            ncones, sq_diffuse, sq_specular, half_ws, voxel, voxel_off, out);
    } else if (nb == 6) {
        tap_kernel<6><<<ntiles, kTile, 0, stream>>>(
            gbuf, gcols, scal8, bumpn, campos, light, ld0, field, fd0, cfield, consts,
            ncones, sq_diffuse, sq_specular, half_ws, voxel, voxel_off, out);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_status();
}
