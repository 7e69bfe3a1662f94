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
// * 1.001 + 1e-2, computed by the wrapper).  The block stops walking its
// list once the next chunk's near bound is at or beyond every ray's best
// t; near is a lower bound of every t in that chunk and a later chunk
// wins only on a strict '<', so the stop never changes a result.
//
// What bounds it: arithmetic, (rays x listed triangles) hit tests of ~20
// flops each; the tables are KBs and the lists one row per tile.  One
// block of 256 threads (one per ray) per list tile: the block stages each
// listed chunk's 128 triangle rows in shared memory (every thread then
// reads the same row: a broadcast), and a block max-reduction of the best
// t after each chunk decides the stop.  The winner's 48-float attribute
// row is read once at the end.  The TPU kernel DMA'd 8-chunk gangs
// through double-buffered VMEM and fetched attributes with a one-hot
// matmul; on the card the chunk rows come from L2 and the block's own
// loads.  The hit test and the G-buffer row are raycast_common.cuh's.
#include "raycast_common.cuh"

namespace {

using namespace raycast;

constexpr int kTile = 256;
constexpr int kChunk = 128;

__device__ __forceinline__ float block_max(float x, float* scratch) {
    for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = x;
    __syncthreads();
    float m = scratch[0];
#pragma unroll
    for (int w = 1; w < kTile / 32; ++w) m = fmaxf(m, scratch[w]);
    return m;
}

__global__ void __launch_bounds__(kTile)
stream_kernel(const float* __restrict__ dirs, const float* __restrict__ origin,
              const float* __restrict__ isect, const float* __restrict__ attrs,
              const int* __restrict__ lists, int ncol, const int* __restrict__ counts,
              const float* __restrict__ tmin, const float* __restrict__ miss,
              float* __restrict__ out) {
    __shared__ float tri[kChunk][10];
    __shared__ float scratch[kTile / 32];
    const int tile = blockIdx.x;
    const long long r = static_cast<long long>(tile) * kTile + threadIdx.x;
    const float d0 = dirs[3 * r], d1 = dirs[3 * r + 1], d2 = dirs[3 * r + 2];
    const float tmn = tmin[r];
    const float miss_at = miss[r];
    const int* list = lists + static_cast<long long>(tile) * ncol;
    const int cnt = counts[tile];

    float best = miss_at;
    int win = -1;
    float bu = 0.0f, bv = 0.0f;
    for (int k = 0; k < cnt; ++k) {
        const int chunk = list[k] & 0xFFFF;
        __syncthreads();
        if (threadIdx.x < kChunk) {
            const float* src = isect + (static_cast<long long>(chunk) * kChunk + threadIdx.x) * kIsect;
#pragma unroll
            for (int q = 0; q < 10; ++q) tri[threadIdx.x][q] = src[q];
        }
        __syncthreads();
        for (int jj = 0; jj < kChunk; ++jj) {
            float tval, u, v;
            if (hit_test(d0, d1, d2, tri[jj], &tval, &u, &v) && tval > tmn && tval < best) {
                best = tval;
                win = chunk * kChunk + jj;
                bu = u;
                bv = v;
            }
        }
        if (k + 1 < cnt) {
            const float near_next = static_cast<float>(static_cast<unsigned>(list[k + 1]) >> 16);
            if (near_next >= block_max(best, scratch)) break;
        }
    }
    finish_row(d0, d1, d2, origin, attrs, best, miss_at, win, bu, bv, out + r * kOut);
}

}  // namespace

VCT_EXPORT int vct_raycast_stream(const float* dirs, const float* origin, const float* isect,
                                  const float* attrs, const int* lists, int ncol,
                                  const int* counts, const float* tmin, const float* miss,
                                  int nrt, float* out, cudaStream_t stream) {
    stream_kernel<<<nrt, kTile, 0, stream>>>(dirs, origin, isect, attrs, lists, ncol, counts,
                                             tmin, miss, out);
    return launch_status();
}
