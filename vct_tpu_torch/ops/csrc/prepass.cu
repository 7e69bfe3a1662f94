// Per-tile brick selection: replaces vct_tpu/ops/prepass_pallas.py
// prepass_tiles (_prepass_kernel, _one_tile), both halves.
//
// What it computes, for each 256-pixel image tile:
//  * light/field half: the uvw extent of its hit pixels' shadow-tap points
//    (pos + geo * voxel * offset) and field-tap points (pos + n * voxel),
//    then the finest light and field mip level whose brick covers that
//    extent, with the brick origin -- the tap kernel's per-tile level
//    (scal8 row: light level, light origin xyz, field level, field origin
//    xyz);
//  * material half (scenes with a texture atlas, nm > 0): per material
//    present among the tile's hit pixels, the uv box of those pixels, the
//    finest atlas level whose texel footprint (+1 bump texel) fits 14
//    texels, and the 16-aligned texel bases bv/bu (clipped to +-2^22);
//    the present materials in ascending id order are the tile's slots
//    (mscal: count + slot 0, mlists: slots 1.. as 4 words each), and each
//    pixel's slot is the number of present materials with a smaller id.
//
// What bounds it: reading the G-buffer (128 B per pixel, 12 of 32 columns
// used); the selection itself is a few hundred flops per tile.  One block
// of 256 threads per tile: each thread maps its pixel to uvw, the block
// reduces min/max in shared memory (uvw first, then min/max, as the
// reference does -- the map is monotone but rounding is not), and one
// thread runs the coarse-to-fine level loop.  For the material half each
// warp reduces the uv box of every material it holds with shuffles (a warp
// skips a material none of its lanes hold, so a one-material tile costs
// one reduction per warp), then one thread per material merges the 8
// warps and runs the atlas level loop.  The TPU kernel did the same
// per-material reductions as lane-vector math and the slot compaction as
// small matmuls; here a thread per material counts its rank directly.
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
constexpr int kWarps = kTile / 32;
constexpr int kMaxMat = 64;                        // prepass.MAX_MATERIALS
constexpr int kNslot = 24, kNscal = 5, kNwords = 128;
constexpr float kThresh = 14.0f;
constexpr float kBclip = 4194304.0f;               // 2^22

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

// coarse-to-fine atlas level loop for one material's uv box
// (prepass_pallas._one_tile): writes level, bv, bu
__device__ void select_atlas(float umin, float umax, float qmin, float qmax, int res,
                             int nlev, int* dst) {
    float lvl = static_cast<float>(nlev - 1), bv = 0.0f, bu = 0.0f;
    for (int lv = nlev - 1; lv >= 0; --lv) {
        const float rl = static_cast<float>(max(res >> lv, 1));
        const float d = ldexpf(1.0f, -lv);
        const float base_u = floorf(sub_rn(mul_rn(umin, rl), 0.5f));
        const float hi_u = floorf(add_rn(sub_rn(mul_rn(umax, rl), 0.5f), d));
        const float base_v = floorf(sub_rn(sub_rn(mul_rn(qmin, rl), 0.5f), d));
        const float hi_v = floorf(sub_rn(mul_rn(qmax, rl), 0.5f));
        const bool fits = lv == nlev - 1
            || (sub_rn(hi_u, base_u) <= kThresh && sub_rn(hi_v, base_v) <= kThresh);
        if (!fits) continue;
        lvl = static_cast<float>(lv);
        bv = mul_rn(static_cast<float>(kAlign),
                    floorf(div_rn(clipf(base_v, -kBclip, kBclip), static_cast<float>(kAlign))));
        bu = mul_rn(static_cast<float>(kAlign),
                    floorf(div_rn(clipf(base_u, -kBclip, kBclip), static_cast<float>(kAlign))));
    }
    dst[0] = static_cast<int>(lvl);
    dst[1] = static_cast<int>(bv);
    dst[2] = static_cast<int>(bu);
}

__device__ __forceinline__ float warp_min(float x) {
    for (int o = 16; o > 0; o >>= 1) x = fminf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}

__device__ __forceinline__ float warp_max(float x) {
    for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}

__global__ void __launch_bounds__(kTile)
prepass_kernel(const float* __restrict__ gbuf, int gcols, int ld0, int nl,
               int fd0, int nf, float half_ws, float voxel, float voxel_off,
               int* __restrict__ scal8, int nm, int res, int nlev,
               int* __restrict__ mscal, int* __restrict__ mlists,
               int* __restrict__ mslots) {
    __shared__ float red[12][kTile];    // 0..5 min (light xyz, field xyz), 6..11 max
    __shared__ float box[kWarps][kMaxMat][4];      // per warp: umin umax qmin qmax
    __shared__ int held[kWarps][kMaxMat];
    __shared__ int entry[kMaxMat][4];              // present, level, bv, bu
    __shared__ int below[kMaxMat + 1];             // present materials with id < m
    const int tile = blockIdx.x;
    const long long pix = static_cast<long long>(tile) * kTile + threadIdx.x;
    const float* g = gbuf + pix * gcols;
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
    if (threadIdx.x == 0) {
        int* out = scal8 + tile * 8;
        if (!any_hit) {
            // no hit pixel: coarsest levels, zero origins
            for (int q = 0; q < 8; ++q) out[q] = 0;
            out[0] = nl - 1;
            out[4] = nf - 1;
        } else {
            const float lmin[3] = {red[0][0], red[1][0], red[2][0]};
            const float lmax[3] = {red[6][0], red[7][0], red[8][0]};
            const float fmin[3] = {red[3][0], red[4][0], red[5][0]};
            const float fmax[3] = {red[9][0], red[10][0], red[11][0]};
            select_level(lmin, lmax, ld0, nl, true, out);
            select_level(fmin, fmax, fd0, nf, false, out + 4);
        }
    }
    if (nm == 0) return;

    // ---- material half ----------------------------------------------
    const int mat = static_cast<int>(g[17]);
    const float u = g[15];
    const float q = sub_rn(1.0f, g[16]);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int m = 0; m < nm; ++m) {
        const bool mine = hit && mat == m;
        const unsigned ballot = __ballot_sync(0xffffffffu, mine);
        if (ballot == 0u) {
            if (lane == 0) held[warp][m] = 0;
            continue;
        }
        const float a = warp_min(mine ? u : kBig);
        const float b = warp_max(mine ? u : -kBig);
        const float c = warp_min(mine ? q : kBig);
        const float e = warp_max(mine ? q : -kBig);
        if (lane == 0) {
            held[warp][m] = 1;
            box[warp][m][0] = a;
            box[warp][m][1] = b;
            box[warp][m][2] = c;
            box[warp][m][3] = e;
        }
    }
    if (threadIdx.x < kNwords) mlists[tile * kNwords + threadIdx.x] = 0;
    __syncthreads();
    for (int m = threadIdx.x; m < nm; m += kTile) {
        float umin = kBig, umax = -kBig, qmin = kBig, qmax = -kBig;
        int present = 0;
        for (int w = 0; w < kWarps; ++w) {
            if (!held[w][m]) continue;
            present = 1;
            umin = fminf(umin, box[w][m][0]);
            umax = fmaxf(umax, box[w][m][1]);
            qmin = fminf(qmin, box[w][m][2]);
            qmax = fmaxf(qmax, box[w][m][3]);
        }
        entry[m][0] = present;
        if (present) select_atlas(umin, umax, qmin, qmax, res, nlev, &entry[m][1]);
    }
    __syncthreads();
    for (int m = threadIdx.x; m <= nm; m += kTile) {
        int cnt = 0;
        for (int k = 0; k < m; ++k) cnt += entry[k][0];
        below[m] = cnt;
    }
    __syncthreads();
    int* ms = mscal + tile * kNscal;
    if (threadIdx.x == 0) {
        ms[0] = min(below[nm], kNslot);
        if (below[nm] == 0)
            for (int k = 1; k < kNscal; ++k) ms[k] = 0;
    }
    for (int m = threadIdx.x; m < nm; m += kTile) {
        const int slot = below[m];
        if (!entry[m][0] || slot >= kNslot) continue;
        int* dst = slot == 0 ? ms + 1 : mlists + tile * kNwords + 4 * (slot - 1);
        dst[0] = m;
        dst[1] = entry[m][1];
        dst[2] = entry[m][2];
        dst[3] = entry[m][3];
    }
    const int rank = below[min(max(mat, 0), nm)];
    mslots[pix] = hit ? min(rank, kNslot - 1) : 0;
}

}  // namespace

VCT_EXPORT int vct_prepass(const float* gbuf, int ntiles, int gcols, int ld0, int nl,
                           int fd0, int nf, float half_ws, float voxel, float voxel_off,
                           int* scal8, int nm, int res, int nlev, int* mscal, int* mlists,
                           int* mslots, cudaStream_t stream) {
    prepass_kernel<<<ntiles, kTile, 0, stream>>>(gbuf, gcols, ld0, nl, fd0, nf, half_ws,
                                                 voxel, voxel_off, scal8, nm, res, nlev,
                                                 mscal, mlists, mslots);
    return launch_status();
}
