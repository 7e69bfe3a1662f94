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
// What bounds it: reading the G-buffer.  A pixel uses 13 of its row's 32
// columns (0-8, 15-17, 19): three of the row's four 32-byte sectors, but
// both of its 64-byte halves, and the card reads memory in 64-byte pieces
// (chip_smoke's G-buffer read probe: columns 15-16 cost as much as the
// whole row), so the floor is reading every row whole; the selection is
// a few hundred flops per tile.  Design: one block of 256 threads per
// tile, one barrier.  Each thread reads the used columns of its row up
// front (columns 0-7 and 16-19 as three 16-byte loads, 8 and 15 alone)
// and keeps what the material half needs in registers rather than
// reading it again.  It maps its pixel to uvw (the map before the
// min/max, as the reference does: the map is monotone but rounding is
// not); each warp reduces the 12 extents with shuffles and the uv box of
// each material its lanes hold (one pass per distinct material, not per
// id), and records those materials as a 64-bit mask and its hits as a
// ballot.  After the barrier, warp 0 selects the light level and warp 1
// the field level with one level per lane: the finest fitting level is
// the lowest set bit of the ballot, which is what the reference's
// coarse-to-fine loop keeps.  Each present material goes to one warp (id
// mod 8), whose lanes test one atlas level each the same way; its slot,
// and every pixel's, is a popcount of the merged mask below its id.  The
// TPU kernel did the per-material reductions as lane-vector math and the
// slot compaction as small matmuls.
//
// The output must equal the plain version exactly, so every multiply and
// add rounds on its own (common.cuh) and the host passes the constants
// voxel*offset and world_size/2 already rounded to float32 once; min and
// max are exact, so the order of the reductions cannot change a result.
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
constexpr int kQ = 12;      // extents: 0..5 min (light xyz, field xyz), 6..11 max
constexpr unsigned kAll = 0xffffffffu;

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

__device__ __forceinline__ float warp_min(float x) {
    for (int o = 16; o > 0; o >>= 1) x = fminf(x, __shfl_xor_sync(kAll, x, o));
    return x;
}

__device__ __forceinline__ float warp_max(float x) {
    for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kAll, x, o));
    return x;
}

__device__ __forceinline__ float4 load4(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
}

// present materials with an id below m (m in 0..64)
__device__ __forceinline__ int rank_below(unsigned long long mask, int m) {
    return __popcll(m >= 64 ? mask : mask & ((1ull << m) - 1ull));
}

// one warp, lane l testing level l: the light or field level and origin
// (the reference's first fit, finest first, over levels d0 >> l, l <
// nlev; the coarsest level always fits).  light: x/y footprint <= 14
// cells; field: x/y <= 6 and z <= 15.  umin/umax are the tile's extents.
__device__ void select_level(const float* umin, const float* umax, int d0, int nlev,
                             bool light, int lane, int* dst) {
    const int li = lane;
    bool fits = false;
    float org[3] = {0.0f, 0.0f, 0.0f};
    if (li < nlev) {
        const int d = d0 >> li;
        float lo[3], hi[3];
        for (int ax = 0; ax < 3; ++ax) {
            lo[ax] = cell(umin[ax], d);
            hi[ax] = cell(umax[ax], d);
        }
        if (li == nlev - 1) {
            fits = true;
        } else if (light) {
            fits = hi[0] - lo[0] <= kBrickL - 2 && hi[1] - lo[1] <= kBrickL - 2;
        } else {
            fits = hi[0] - lo[0] <= kBrickF - 2 && hi[1] - lo[1] <= kBrickF - 2
                && hi[2] - lo[2] <= kFbz - kAlign - 1;
        }
        if (light) {
            org[0] = clipf(lo[0], 0.0f, static_cast<float>(d - kBrickL));
            org[1] = aligned(lo[1], d, kLby);
        } else {
            org[0] = clipf(lo[0], 0.0f, static_cast<float>(d - kBrickF));
            org[1] = clipf(lo[1], 0.0f, static_cast<float>(d - kBrickF));
            org[2] = aligned(lo[2], d, kFbz);
        }
    }
    const unsigned ok = __ballot_sync(kAll, fits);
    if (li == __ffs(ok) - 1) {
        dst[0] = li;
        for (int ax = 0; ax < 3; ++ax) dst[1 + ax] = static_cast<int>(org[ax]);
    }
}

// one warp, lane l testing atlas level l for one material's uv box
// (prepass_pallas._one_tile's coarse-to-fine loop): the winning lane
// writes material, level, bv, bu to dst
__device__ void select_atlas(float umin, float umax, float qmin, float qmax, int m,
                             int res, int nlev, int lane, int* dst) {
    const int lv = lane;
    bool fits = false;
    float base_u = 0.0f, base_v = 0.0f;
    if (lv < nlev) {
        const float rl = static_cast<float>(max(res >> lv, 1));
        const float d = ldexpf(1.0f, -lv);
        base_u = floorf(sub_rn(mul_rn(umin, rl), 0.5f));
        const float hi_u = floorf(add_rn(sub_rn(mul_rn(umax, rl), 0.5f), d));
        base_v = floorf(sub_rn(sub_rn(mul_rn(qmin, rl), 0.5f), d));
        const float hi_v = floorf(sub_rn(mul_rn(qmax, rl), 0.5f));
        fits = lv == nlev - 1
            || (sub_rn(hi_u, base_u) <= kThresh && sub_rn(hi_v, base_v) <= kThresh);
    }
    const unsigned ok = __ballot_sync(kAll, fits);
    if (lv == __ffs(ok) - 1) {
        const float bv = mul_rn(static_cast<float>(kAlign),
                                floorf(div_rn(clipf(base_v, -kBclip, kBclip),
                                              static_cast<float>(kAlign))));
        const float bu = mul_rn(static_cast<float>(kAlign),
                                floorf(div_rn(clipf(base_u, -kBclip, kBclip),
                                              static_cast<float>(kAlign))));
        dst[0] = m;
        dst[1] = lv;
        dst[2] = static_cast<int>(bv);
        dst[3] = static_cast<int>(bu);
    }
}

__global__ void __launch_bounds__(kTile)
prepass_kernel(const float* __restrict__ gbuf, int gcols, int ld0, int nl,
               int fd0, int nf, float half_ws, float voxel, float voxel_off,
               int* __restrict__ scal8, int nm, int res, int nlev,
               int* __restrict__ mscal, int* __restrict__ mlists,
               int* __restrict__ mslots) {
    __shared__ float part[kWarps][kQ];             // per warp: the 12 extents
    __shared__ float box[kWarps][kMaxMat][4];      // per warp: umin umax qmin qmax
    __shared__ unsigned long long wmask[kWarps];   // per warp: materials held
    __shared__ unsigned whit[kWarps];              // per warp: its lanes' hit ballot
    const int tile = blockIdx.x;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const long long pix = static_cast<long long>(tile) * kTile + threadIdx.x;
    const float* g = gbuf + pix * gcols;

    // the used columns up front: pos 0-2, n 3-5, geo 6-8 | u 15 (only with
    // an atlas) | v 16, mat 17, hit 19
    const float4 c0 = load4(g), c4 = load4(g + 4), c16 = load4(g + 16);
    const float geo_z = __ldg(g + 8);
    const float u = nm > 0 ? __ldg(g + 15) : 0.0f;
    const bool hit = c16.w > 0.5f;
    const float pos[3] = {c0.x, c0.y, c0.z};
    const float nrm[3] = {c0.w, c4.x, c4.y};
    const float geo[3] = {c4.z, c4.w, geo_z};

    float ext[kQ];
    for (int ax = 0; ax < 3; ++ax) {
        const float ul = world_to_uvw(add_rn(pos[ax], mul_rn(geo[ax], voxel_off)), half_ws);
        const float uf = world_to_uvw(add_rn(pos[ax], mul_rn(nrm[ax], voxel)), half_ws);
        ext[ax] = hit ? ul : kBig;
        ext[3 + ax] = hit ? uf : kBig;
        ext[6 + ax] = hit ? ul : -kBig;
        ext[9 + ax] = hit ? uf : -kBig;
    }
#pragma unroll
    for (int q = 0; q < kQ; ++q) ext[q] = q < 6 ? warp_min(ext[q]) : warp_max(ext[q]);
    if (lane == 0)
        for (int q = 0; q < kQ; ++q) part[warp][q] = ext[q];

    // material half, per warp: the uv box of each material its lanes hold
    const int mat = static_cast<int>(c16.y);
    const float q = sub_rn(1.0f, c16.x);
    if (nm > 0) {
        const bool held = hit && mat >= 0 && mat < nm;
        unsigned long long mine_mask = 0;
        for (unsigned pending = __ballot_sync(kAll, held); pending != 0u;) {
            const int m = __shfl_sync(kAll, mat, __ffs(pending) - 1);
            const bool mine = held && mat == m;
            const float a = warp_min(mine ? u : kBig);
            const float b = warp_max(mine ? u : -kBig);
            const float c = warp_min(mine ? q : kBig);
            const float e = warp_max(mine ? q : -kBig);
            if (lane == 0) {
                box[warp][m][0] = a;
                box[warp][m][1] = b;
                box[warp][m][2] = c;
                box[warp][m][3] = e;
            }
            mine_mask |= 1ull << m;
            pending &= ~__ballot_sync(kAll, mine);
        }
        if (lane == 0) wmask[warp] = mine_mask;
    }
    // "any hit" from the warps' ballots, through shared memory: the same
    // kernel voting with __syncthreads_or(hit) instead gave the no-hit
    // levels for tiles whose few hits all lay in the last warps (PERF.md)
    const unsigned hits = __ballot_sync(kAll, hit);
    if (lane == 0) whit[warp] = hits;
    __syncthreads();
    bool any_hit = false;
    for (int w = 0; w < kWarps; ++w) any_hit = any_hit || whit[w] != 0u;

    // light level (warp 0) and field level (warp 1), a level per lane
    if (warp < 2) {
        const bool light = warp == 0;
        const int levels = light ? nl : nf;
        int* out = scal8 + tile * 8 + (light ? 0 : 4);
        if (!any_hit) {
            // no hit pixel: coarsest level, zero origin
            if (lane < 4) out[lane] = lane == 0 ? levels - 1 : 0;
        } else {
            const int at = light ? 0 : 3;
            float lo[3], hi[3];
            for (int ax = 0; ax < 3; ++ax) {
                lo[ax] = kBig;
                hi[ax] = -kBig;
                for (int w = 0; w < kWarps; ++w) {
                    lo[ax] = fminf(lo[ax], part[w][at + ax]);
                    hi[ax] = fmaxf(hi[ax], part[w][6 + at + ax]);
                }
            }
            select_level(lo, hi, light ? ld0 : fd0, levels, light, lane, out);
        }
    }
    if (nm == 0) return;

    // ---- material half: slots from the merged mask ---------------------
    unsigned long long mask = 0;
    for (int w = 0; w < kWarps; ++w) mask |= wmask[w];
    const int used = min(__popcll(mask), kNslot);
    int* ms = mscal + tile * kNscal;
    int* ml = mlists + static_cast<long long>(tile) * kNwords;
    if (threadIdx.x < kNscal && (threadIdx.x == 0 || used == 0))
        ms[threadIdx.x] = threadIdx.x == 0 ? used : 0;
    // words of empty slots are zero; occupied slots are written below
    if (threadIdx.x < kNwords && threadIdx.x / 4 + 1 >= used) ml[threadIdx.x] = 0;
    for (int m = warp; m < nm; m += kWarps) {
        const int slot = rank_below(mask, m);
        if (!(mask >> m & 1ull) || slot >= kNslot) continue;
        float umin = kBig, umax = -kBig, qmin = kBig, qmax = -kBig;
        for (int w = 0; w < kWarps; ++w) {
            if (!(wmask[w] >> m & 1ull)) continue;
            umin = fminf(umin, box[w][m][0]);
            umax = fmaxf(umax, box[w][m][1]);
            qmin = fminf(qmin, box[w][m][2]);
            qmax = fmaxf(qmax, box[w][m][3]);
        }
        select_atlas(umin, umax, qmin, qmax, m, res, nlev, lane,
                     slot == 0 ? ms + 1 : ml + 4 * (slot - 1));
    }
    const int rank = rank_below(mask, min(max(mat, 0), nm));
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

// the kernel's report (common.cuh occupancy_info)
VCT_EXPORT int vct_prepass_occupancy(int* info) {
    return occupancy_info(prepass_kernel, kTile, 0, info);
}
