// Same-origin closest-hit raycast + G-buffer: replaces
// vct_tpu/ops/raycast_pallas.py raycast_gbuf24 (_kernel, finish as
// _finish_gbuf).
//
// What it computes: for N camera rays sharing one origin, Moller-Trumbore
// against every triangle of the origin-folded table (pack_tables: det =
// d.a, u*det = d.b, v*det = d.c, t*det = k), the first-min winner by
// triangle index, and the barycentric 32-column G-buffer row.
//
// What bounds it: testing every ray against every row made it arithmetic
// (N x T tests of 21 separately rounded operations).  But a 256-ray block
// is one 16x16 tile of the frame (tile order), whose directions fill a
// narrow cone, and a ray hits row (a, b, c, k) only if it lies in four
// half-spaces through the origin: with s = sign(k), s*d.a, s*d.b, s*d.c
// and s*d.(a - b - c) all >= 0.  So each block first builds its cone
// (axis: the normalised sum of its rays' unit directions; half-angle: the
// least dot product with the axis, less a slack above its rounding), then
// walks the table 256 rows at a time: each thread tests one row's four
// half-spaces against the cone with a margin (ops/raycast.py
// tile_cull_plain states it and the proof that a dropped row fails the
// rounded hit test for every ray of the block), the survivors are
// compacted into shared memory in ascending row order (warp ballot and
// prefix popcount), and every thread tests its ray against the survivors
// only.  Survivors keep their order and dropped rows never hit, so the
// strict-'<' first minimum is the one over the whole table.  On the atrium
// frame a block keeps about 6 of 1,122 rows; what is left is the G-buffer
// write (128 bytes a ray).  A block whose cone is wider than a half-space
// keeps every row.  The survivors' rows are 12 floats, three float4
// broadcasts from shared memory.  The TPU kernel fetched the winner's
// attributes with a one-hot matmul; here the thread keeps the winner's
// index and reads its 48-float row once at the end, and the block writes
// its 256 G-buffer rows through shared memory in whole 512-byte runs.
//
// The cone and the cull round every operation on their own, in the order
// of tile_cull_plain (the warp's xor-shuffle sums, then the eight warp
// totals pairwise), so the plain version predicts the kept rows exactly.
// The cone, the cull, the compaction and the rows' way out are
// raycast_common.cuh's, shared with the binned kernel; the hit test and the
// G-buffer row are shared with the streamed kernel too, in exact float32.
#include "raycast_common.cuh"

namespace {

using namespace raycast;

__global__ void __launch_bounds__(kBlock)
raycast_kernel(const float* __restrict__ dirs, const float* __restrict__ origin,
               const float* __restrict__ isect, const float* __restrict__ attrs,
               int n, int t, float* __restrict__ out) {
    __shared__ float4 s_tri[kBlock][3];    // survivors: a3 b3 c3 k, 2 unused
    __shared__ int s_id[kBlock];
    __shared__ float s_part[4][kWarps];
    __shared__ int s_cnt[kWarps];
    __shared__ float4 s_out[kBlock * kOut / 4];
    const int r = blockIdx.x * kBlock + threadIdx.x;
    const bool live = r < n;
    const float d0 = live ? dirs[3 * r + 0] : 0.0f;
    const float d1 = live ? dirs[3 * r + 1] : 0.0f;
    const float d2 = live ? dirs[3 * r + 2] : 0.0f;
    const Cone cone = group_cone(d0, d1, d2, true, s_part);

    float best = kBig;
    int win = -1;
    float bu = 0.0f, bv = 0.0f;
    for (int base = 0; base < t; base += kBlock) {
        // cull 256 rows, one a thread, then every ray against the
        // survivors, in row order
        const int j = base + threadIdx.x;
        float row[12];
        bool keep = false;
        if (j < t) {
            load_row(isect + static_cast<long long>(j) * kIsect, row);
            keep = cone.wide || keep_row(cone, row);
        }
        const int cnt = compact(keep, row, j, s_tri, s_id, s_cnt);
        cast_survivors(d0, d1, d2, s_tri, s_id, cnt, &best, &win, &bu, &bv);
    }
    store_rows(d0, d1, d2, origin, attrs, best, kBig, win, bu, bv, s_out,
               min(kBlock, n - static_cast<int>(blockIdx.x) * kBlock),
               out + static_cast<long long>(blockIdx.x) * kBlock * kOut);
}

}  // namespace

VCT_EXPORT int vct_raycast(const float* dirs, const float* origin, const float* isect,
                           const float* attrs, int n, int t, float* out,
                           cudaStream_t stream) {
    const int blocks = (n + kBlock - 1) / kBlock;
    raycast_kernel<<<blocks, kBlock, 0, stream>>>(dirs, origin, isect, attrs, n, t, out);
    return launch_status();
}

VCT_EXPORT int vct_raycast_occupancy(int* info) {
    return occupancy_info(raycast_kernel, kBlock, 0, info);
}
