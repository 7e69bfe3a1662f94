// Binned closest hit + G-buffer: replaces vct_tpu/ops/binrast_pallas.py
// raycast_binned (_binned_kernel, _process) and, fused, finish_binned.
//
// What it computes: for each 16x64-pixel strip (1024 same-origin rays in
// tile-major order), the walk bin_triangles laid out for it -- gseg gangs
// of 256 rows of the row table from the strip's segment, then gcol gangs
// from its column's segment -- and for each ray the first minimum of t
// over the walk with the origin-folded Moller-Trumbore test, then the
// winner's 32-column G-buffer row.  A row is a3 b3 c3 k and the triangle
// id in column 10; the id picks the winner's attribute row.  Replacing the
// best only on a strict '<', row by row in walk order, is exactly the TPU
// kernel's in-gang first argmin followed by its cross-gang strict '<'.
// Rows a gang reads past its segment are real triangles of the next bin
// (bin_triangles builds the table so), which only add candidates.
//
// What bounds it: testing every ray of a strip against every row of its
// walk made it arithmetic (1.25e9 tests of 21 separately rounded operations
// on bench.py's 287k-triangle frame).  But a strip is four 16x16 tiles,
// and a tile's rays fill a narrow cone: the whole-table kernel's cull
// (raycast.cu, raycast_common.cuh) carries over.  One 256-thread block per
// tile (rays 256*b ... 256*b + 255, tile b of strip b / 4), one ray a
// thread: the block builds its cone, then walks its strip's walk 256 rows
// at a time; each thread reads one row and tests its four half-spaces
// against the cone (ops/binrast.py walk_cull_plain is that predicate in
// the same float order), the survivors are compacted into shared memory in
// walk order, and every thread tests its ray against the survivors only.
// Dropped rows fail the rounded hit test for every ray of the tile and
// survivors keep their order, so the winner is still the first minimum in
// walk order.  On the 287k frame a tile keeps about 83 of its walk's 598
// rows (a column's rows serve every strip of the column, and a tile keeps
// 1% of them).  What is left is the G-buffer write (128 bytes a ray),
// which leaves through shared memory in whole 512-byte runs, and the
// walk's rows, three float4s each through the read-only path.  Rows at or
// past the table's end are dropped (det = 0 never hits); a tile wider than
// a half-space keeps every row.  `kept`, when given, receives each tile's
// count of surviving rows.
//
// The TPU kernel prefetched the per-strip offsets as scalars, double-
// buffered 128-aligned DMAs and fetched the winner's id and barycentrics
// with one-hot sums; here the block reads its strip's offsets, its rows
// come from L2 and it keeps the winner in registers.  The hit test and the
// G-buffer row are raycast_common.cuh's, in exact float32.
#include "raycast_common.cuh"

namespace {

using namespace raycast;

constexpr int kTilesPerStrip = 4;           // 1024-ray strips, 256-ray tiles
constexpr int kGang = 256;                  // table rows per gang

__global__ void __launch_bounds__(kBlock)
binned_kernel(const float* __restrict__ dirs, const float* __restrict__ origin,
              const int* __restrict__ scal, int ns, const float* __restrict__ table,
              int np_rows, const float* __restrict__ attrs, float* __restrict__ out,
              int* __restrict__ kept) {
    __shared__ float4 s_tri[kBlock][3];    // survivors: a3 b3 c3 k, id, 1 unused
    __shared__ int s_id[kBlock];
    __shared__ float s_part[4][kWarps];
    __shared__ int s_cnt[kWarps];
    __shared__ float4 s_out[kBlock * kOut / 4];
    const int tile = blockIdx.x;
    const int strip = tile / kTilesPerStrip;
    const long long r = static_cast<long long>(tile) * kBlock + threadIdx.x;
    const float d0 = dirs[3 * r], d1 = dirs[3 * r + 1], d2 = dirs[3 * r + 2];
    const Cone cone = group_cone(d0, d1, d2, true, s_part);

    const long long off = scal[strip];
    const int gseg = scal[ns + strip];
    const long long coff = scal[2 * ns + strip];
    const int total = gseg + scal[3 * ns + strip];
    float best = kBig;
    int win = -1;
    float bu = 0.0f, bv = 0.0f;
    int nkept = 0;
    for (int p = 0; p < total; ++p) {
        const long long j = (p < gseg ? off + static_cast<long long>(p) * kGang
                                      : coff + static_cast<long long>(p - gseg) * kGang)
                            + threadIdx.x;
        float row[12];
        bool keep = false;
        if (j < np_rows) {
            load_row(table + j * kIsect, row);
            keep = cone.wide || keep_row(cone, row);
        }
        const int cnt = compact(keep, row, keep ? __float2int_rn(row[10]) : 0, s_tri, s_id,
                                s_cnt);
        nkept += cnt;
        cast_survivors(d0, d1, d2, s_tri, s_id, cnt, &best, &win, &bu, &bv);
    }
    if (kept != nullptr && threadIdx.x == 0) kept[tile] = nkept;
    store_rows(d0, d1, d2, origin, attrs, best, kBig, win, bu, bv, s_out, kBlock,
               out + static_cast<long long>(tile) * kBlock * kOut);
}

}  // namespace

VCT_EXPORT int vct_binrast(const float* dirs, const float* origin, const int* scal, int ns,
                           const float* table, int np_rows, const float* attrs, float* out,
                           int* kept, cudaStream_t stream) {
    binned_kernel<<<ns * kTilesPerStrip, kBlock, 0, stream>>>(dirs, origin, scal, ns, table,
                                                              np_rows, attrs, out, kept);
    return launch_status();
}

VCT_EXPORT int vct_binrast_occupancy(int* info) {
    return occupancy_info(binned_kernel, kBlock, 0, info);
}
