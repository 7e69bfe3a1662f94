// Streamed, chunk-culled closest hit with a per-ray minimum distance:
// replaces vct_tpu/ops/raycast_pallas.py raycast_stream (_stream_kernel).
// The frame path runs it for the alpha-mask re-cast (render/fast.py
// alpha_resolve): rays that hit a masked texel continue past it.
//
// What it computes: for each 256-ray tile, the tile's list of 128-triangle
// chunks (select_chunks: the chunks whose bounding sphere touches the
// tile's direction cone, sorted front to back by the packed word
// (near << 16) | chunk id), and for each ray the first minimum of t over
// the listed triangles with t > tmin -- first in list order, and by
// triangle index within a chunk -- and its G-buffer row.  The ray hits
// when that t is below its miss sentinel (the scene box's exit distance
// * 1.001 + 1e-2, computed by the wrapper).
//
// What bounds it: arithmetic, hit tests of ~21 separately rounded
// operations, and which tests are needed depends on the data; the least
// work is the tests of the rows a ray's cone cannot exclude.  Testing
// every ray of a tile against every row of every listed chunk
// (247,791,616 tests on bench.py's 287k frame when every candidate is
// re-cast) left the parent kernel at 12% of that bound, and the frame's
// own re-cast input at the bench camera is all rays that cannot hit.  So:
//  * a ray is live only if tmin < miss (a candidate needs
//    tmin < t < best <= miss); a warp with no live ray writes its miss
//    rows and reads no chunk;
//  * each warp of 32 rays is its own group, with no block barrier: it
//    builds the direction cone of its live rays (raycast_common.cuh
//    group_cone<1>), and for each listed chunk every lane reads 4 of its
//    128 rows, tests them against the cone (keep_row, the same margin and
//    slack as the whole-table and binned kernels; first may_keep_row, its
//    necessary condition without square roots, so most rows skip them: the
//    cull, not the hit tests, is most of a warp's work), compacts the
//    survivors into the warp's shared stage in (list position, row) order
//    by ballot, and every lane tests its ray against the survivors only.
//    Culled rows fail the rounded hit test for every ray of the cone
//    (ops/raycast.py cull_rows states why) and survivors keep their order,
//    so the strict-'<' first minimum is unchanged; ops/raycast.py
//    stream_cull_plain and stream_walk_plain state the cull and this walk
//    in the same float order;
//  * a warp whose rays straddle a cell of alpha_resolve's direction sort
//    holds two clusters, and one cone over both keeps up to 100x the rows
//    (3,351 against a median of 26 on the 287k frame's stress input): when
//    the widest angle between neighbouring live rays exceeds 1 degree
//    (kSplitDot), the warp splits at that lane and walks its list
//    twice, once per part with that part's cone; the other part's lanes
//    take part in the cull and the casts but never update (tmin infinite),
//    so each ray's winner is still its own first minimum;
//  * the warp stops once the next chunk's near bound is at or beyond the
//    best t of every live ray of the part (near lower-bounds every t in the
//    chunk and a later chunk wins only on a strict '<', so testing a chunk
//    the stop would skip changes nothing); a check costs 5 shuffles beside
//    a chunk's 4 row loads and cull a lane, so the warp checks before every
//    chunk;
//  * the next chunk's rows are loaded while the warp tests the current
//    chunk's survivors, and the list words come 32 at a time, one a lane.
// The G-buffer rows leave through the warp's stage in whole 512-byte runs.
// `kept`, when given, receives each warp's count of kept rows over the
// chunks its parts tested.
//
// The TPU kernel DMA'd 8-chunk gangs through double-buffered VMEM with
// prefetched scalars, walked 8-row list groups and fetched attributes with
// a one-hot matmul; here a warp reads its tile's list and its chunks' rows
// through the read-only path (L2) and keeps the winner in registers.  The
// hit test and the G-buffer row are raycast_common.cuh's, in exact float32.
#include "raycast_common.cuh"

namespace {

using namespace raycast;

constexpr int kTile = 256;                 // rays a list row
constexpr int kChunk = 128;                // rows a chunk
constexpr int kSlices = kChunk / 32;       // a chunk's rows a lane
constexpr int kGroupsPerBlock = 4;         // warps a block, each its own group
constexpr int kThreads = 32 * kGroupsPerBlock;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kSplitDot = 0.9998477f;    // cos 1 deg (ops/raycast.py SPLIT_DOT)

// this lane's kSlices rows of `chunk`
__device__ __forceinline__ void load_chunk(const float* __restrict__ isect, int chunk, int lane,
                                           float (*rows)[12]) {
#pragma unroll
    for (int s = 0; s < kSlices; ++s)
        load_row(isect + (static_cast<long long>(chunk) * kChunk + s * 32 + lane) * kIsect,
                 rows[s]);
}

__global__ void __launch_bounds__(kThreads, 4)
stream_kernel(const float* __restrict__ dirs, const float* __restrict__ origin,
              const float* __restrict__ isect, const float* __restrict__ attrs,
              const int* __restrict__ lists, int ncol, const int* __restrict__ counts,
              const float* __restrict__ tmin, const float* __restrict__ miss,
              float* __restrict__ out, int* __restrict__ kept) {
    // per warp: a chunk's survivors, then its 32 G-buffer rows on their way out
    __shared__ float4 s_tri[kGroupsPerBlock][kChunk][3];
    __shared__ int s_id[kGroupsPerBlock][kChunk];
    const int lane = threadIdx.x % 32;
    const int w = threadIdx.x / 32;
    const long long group = static_cast<long long>(blockIdx.x) * kGroupsPerBlock + w;
    const long long r = group * 32 + lane;
    const long long tile = group / (kTile / 32);
    const float d0 = dirs[3 * r], d1 = dirs[3 * r + 1], d2 = dirs[3 * r + 2];
    const float tmn = tmin[r];
    const float miss_at = miss[r];
    const float dd = add_rn(add_rn(mul_rn(d0, d0), mul_rn(d1, d1)), mul_rn(d2, d2));
    const bool live = tmn < miss_at && dd > 0.0f;

    // the split: the lane after the widest angle between neighbouring live
    // rays, when that angle's cosine is below kSplitDot (32: no split)
    float dn[3] = {0.0f, 0.0f, 0.0f};
    if (live) {
        const float len = __fsqrt_rn(dd);
        dn[0] = div_rn(d0, len);
        dn[1] = div_rn(d1, len);
        dn[2] = div_rn(d2, len);
    }
    float next[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) next[i] = __shfl_down_sync(kFull, dn[i], 1);
    const bool next_live = __shfl_down_sync(kFull, static_cast<int>(live), 1) != 0;
    const float pair = lane < 31 && live && next_live ? dot3v(dn, next) : 2.0f;
    const float widest = warp_min(pair);
    const int split = widest < kSplitDot ? __ffs(__ballot_sync(kFull, pair == widest)) : 32;

    float best = miss_at;
    int win = -1;
    float bu = 0.0f, bv = 0.0f;
    int nkept = 0;
    const int* list = lists + tile * ncol;
    const int cnt = counts[tile];
    for (int part = 0; part < 2; ++part) {
        const bool member = (lane < split) == (part == 0);
        const bool walks = live && member;
        if (__ballot_sync(kFull, walks) == 0u) continue;
        const Cone cone = group_cone<1>(d0, d1, d2, walks, nullptr);
        // lanes of the other part never update
        const float t_from = member ? tmn : __int_as_float(0x7f800000);
        int words = lane < cnt ? list[lane] : 0;       // list positions 0-31
        int word = __shfl_sync(kFull, words, 0);
        float rows[kSlices][12];
        if (cnt > 0) load_chunk(isect, word & 0xFFFF, lane, rows);
        for (int k = 0; k < cnt; ++k) {
            const int chunk = word & 0xFFFF;
            if (k > 0) {
                const float near = static_cast<float>(static_cast<unsigned>(word) >> 16);
                if (near >= warp_max(walks ? best : -kBig)) break;
            }
            int n = 0;
#pragma unroll
            for (int s = 0; s < kSlices; ++s) {
                const bool keep = cone.wide
                    || (may_keep_row(cone, rows[s]) && keep_row(cone, rows[s]));
                n += compact<1>(keep, rows[s], chunk * kChunk + s * 32 + lane, s_tri[w] + n,
                                s_id[w] + n, nullptr);
            }
            nkept += n;
            if (k + 1 < cnt) {               // the next chunk's rows, in flight
                if ((k + 1) % 32 == 0) words = k + 1 + lane < cnt ? list[k + 1 + lane] : 0;
                word = __shfl_sync(kFull, words, (k + 1) % 32);
                load_chunk(isect, word & 0xFFFF, lane, rows);
            }
            cast_survivors<true>(d0, d1, d2, s_tri[w], s_id[w], n, &best, &win, &bu, &bv,
                                 t_from);
        }
    }
    if (kept != nullptr && lane == 0) kept[group] = nkept;
    __syncwarp();                            // the stage's survivors are read
    store_rows<1>(d0, d1, d2, origin, attrs, best, miss_at, win, bu, bv, &s_tri[w][0][0], 32,
                  out + group * 32 * kOut);
}

}  // namespace

VCT_EXPORT int vct_raycast_stream(const float* dirs, const float* origin, const float* isect,
                                  const float* attrs, const int* lists, int ncol,
                                  const int* counts, const float* tmin, const float* miss,
                                  int nrt, float* out, int* kept,
                                  cudaStream_t stream) {
    const int blocks = nrt * (kTile / kThreads);
    stream_kernel<<<blocks, kThreads, 0, stream>>>(dirs, origin, isect, attrs, lists, ncol,
                                                   counts, tmin, miss, out, kept);
    return launch_status();
}

VCT_EXPORT int vct_raycast_stream_occupancy(int* info) {
    return occupancy_info(stream_kernel, kThreads, 0, info);
}
