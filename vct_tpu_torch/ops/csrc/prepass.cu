// Per-tile mip-level + brick-origin selection: replaces
// vct_tpu/ops/prepass_pallas.py prepass_tiles (_prepass_kernel,
// _one_tile) for untextured scenes (has_atlas=False; the per-material
// atlas half is not ported yet).
//
// What it computes: for each 256-pixel image tile, the uvw extent of its
// hit pixels' shadow-tap points (pos + geo * voxel * offset) and field-tap
// points (pos + n * voxel), then the finest light and field mip level
// whose brick covers that extent, with the brick origin -- the tap
// kernel's per-tile level (scal8 row: light level, light origin xyz,
// field level, field origin xyz).
//
// What bounds it: reading the G-buffer (128 B per pixel, 8 of 32 columns
// used); the selection itself is a few hundred flops per tile.  One block
// of 256 threads per tile: each thread maps its pixel to uvw, the block
// reduces min/max in shared memory (uvw first, then min/max, as the
// reference does -- the map is monotone but rounding is not), and one
// thread runs the coarse-to-fine level loop.
//
// The output must equal the plain version exactly, so every multiply and
// add rounds on its own (common.cuh) and the host passes the constants
// voxel*offset and world_size/2 already rounded to float32 once.
#include "common.cuh"

namespace {

constexpr int kTile = 256;
constexpr float kBig = 3e38f;
constexpr int kBrickL = 16, kLby = 32;             // light brick x / y extent
constexpr int kBrickF = 8, kFbz = 32;              // field brick x,y / z extent
constexpr int kAlign = 16;

__device__ __forceinline__ float cell(float u, int d) {
    return floorf(fminf(fmaxf(sub_rn(mul_rn(u, static_cast<float>(d)), 0.5f), 0.0f),
                        static_cast<float>(d - 1)));
}

__device__ __forceinline__ float clipf(float x, float lo, float hi) {
    return fminf(fmaxf(x, lo), hi);
}

// 16-aligned origin whose `extent` window covers lo (tap_pallas._aligned)
__device__ __forceinline__ float aligned(float lo, int d, int extent) {
    const float b = floorf(lo / kAlign) * kAlign;
    return clipf(b, 0.0f, static_cast<float>(max(d, extent) - extent));
}

// first-fit-finest level over levels d0 >> l, l < nlev; the coarsest
// level always fits.  light: x/y footprint <= 14 cells; field: x/y <= 6
// and z <= 15.  Writes level and origin xyz to dst[0..3].
__device__ void select_level(const float* umin, const float* umax, int d0,
                             int nlev, bool light, int* dst) {
    int level = nlev - 1;
    float org[3] = {0.0f, 0.0f, 0.0f};
    for (int li = nlev - 1; li >= 0; --li) {
        const int d = d0 >> li;
        float lo[3], hi[3];
        for (int ax = 0; ax < 3; ++ax) {
            lo[ax] = cell(umin[ax], d);
            hi[ax] = cell(umax[ax], d);
        }
        bool fits;
        if (li == nlev - 1) {
            fits = true;
        } else if (light) {
            fits = hi[0] - lo[0] <= kBrickL - 2 && hi[1] - lo[1] <= kBrickL - 2;
        } else {
            fits = hi[0] - lo[0] <= kBrickF - 2 && hi[1] - lo[1] <= kBrickF - 2
                && hi[2] - lo[2] <= kFbz - kAlign - 1;
        }
        if (!fits) continue;
        level = li;
        if (light) {
            org[0] = clipf(lo[0], 0.0f, static_cast<float>(d - kBrickL));
            org[1] = aligned(lo[1], d, kLby);
            org[2] = 0.0f;
        } else {
            org[0] = clipf(lo[0], 0.0f, static_cast<float>(d - kBrickF));
            org[1] = clipf(lo[1], 0.0f, static_cast<float>(d - kBrickF));
            org[2] = aligned(lo[2], d, kFbz);
        }
    }
    dst[0] = level;
    for (int ax = 0; ax < 3; ++ax) dst[1 + ax] = static_cast<int>(org[ax]);
}

__global__ void __launch_bounds__(kTile)
prepass_kernel(const float* __restrict__ gbuf, int gcols, int ld0, int nl,
               int fd0, int nf, float half_ws, float voxel, float voxel_off,
               int* __restrict__ scal8) {
    __shared__ float red[12][kTile];    // 0..5 min (light xyz, field xyz), 6..11 max
    const int tile = blockIdx.x;
    const float* g = gbuf + (static_cast<long long>(tile) * kTile + threadIdx.x) * gcols;
    const bool hit = g[19] > 0.5f;
    for (int ax = 0; ax < 3; ++ax) {
        const float pl = add_rn(g[ax], mul_rn(g[6 + ax], voxel_off));
        const float pf = add_rn(g[ax], mul_rn(g[3 + ax], voxel));
        const float ul = world_to_uvw(pl, half_ws);
        const float uf = world_to_uvw(pf, half_ws);
        red[ax][threadIdx.x] = hit ? ul : kBig;
        red[3 + ax][threadIdx.x] = hit ? uf : kBig;
        red[6 + ax][threadIdx.x] = hit ? ul : -kBig;
        red[9 + ax][threadIdx.x] = hit ? uf : -kBig;
    }
    const int any_hit = __syncthreads_or(hit);
    for (int half = kTile / 2; half > 0; half >>= 1) {
        if (threadIdx.x < half) {
            for (int q = 0; q < 6; ++q)
                red[q][threadIdx.x] = fminf(red[q][threadIdx.x], red[q][threadIdx.x + half]);
            for (int q = 6; q < 12; ++q)
                red[q][threadIdx.x] = fmaxf(red[q][threadIdx.x], red[q][threadIdx.x + half]);
        }
        __syncthreads();
    }
    if (threadIdx.x != 0) return;
    int* out = scal8 + tile * 8;
    if (!any_hit) {
        // no hit pixel: coarsest levels, zero origins
        for (int q = 0; q < 8; ++q) out[q] = 0;
        out[0] = nl - 1;
        out[4] = nf - 1;
        return;
    }
    const float lmin[3] = {red[0][0], red[1][0], red[2][0]};
    const float lmax[3] = {red[6][0], red[7][0], red[8][0]};
    const float fmin[3] = {red[3][0], red[4][0], red[5][0]};
    const float fmax[3] = {red[9][0], red[10][0], red[11][0]};
    select_level(lmin, lmax, ld0, nl, true, out);
    select_level(fmin, fmax, fd0, nf, false, out + 4);
}

}  // namespace

VCT_EXPORT int vct_prepass(const float* gbuf, int ntiles, int gcols, int ld0, int nl,
                           int fd0, int nf, float half_ws, float voxel, float voxel_off,
                           int* scal8, cudaStream_t stream) {
    prepass_kernel<<<ntiles, kTile, 0, stream>>>(gbuf, gcols, ld0, nl, fd0, nf, half_ws,
                                                 voxel, voxel_off, scal8);
    return launch_status();
}
