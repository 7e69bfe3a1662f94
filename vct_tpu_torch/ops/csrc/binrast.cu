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
// What bounds it: arithmetic, (rays x walk rows) hit tests of 21 flops
// each (the division runs only for hits); the table is read once per strip that walks it.  One block of 256
// threads per strip, four rays a thread (rays t, t+256, t+512, t+768 of the
// strip): the block stages each gang's rows (12 floats) in shared memory,
// and every thread reads the same row at once (a broadcast) and tests it
// against its four rays, so one shared load feeds four tests.  The TPU
// kernel prefetched the per-strip offsets as scalars, double-buffered
// 128-aligned DMAs and fetched the winner's id and barycentrics with
// one-hot sums; here the block reads its own offsets, loads each gang
// straight from global memory (L2) and keeps the winner in registers.
// The hit test and the G-buffer row are raycast_common.cuh's, in exact
// float32.
#include "raycast_common.cuh"

namespace {

using namespace raycast;

constexpr int kStripe = 1024;               // rays per strip
constexpr int kGang = 256;                  // table rows per gang
constexpr int kThreads = 256;
constexpr int kRays = kStripe / kThreads;   // rays per thread
constexpr int kRow = 12;                    // staged floats: a3 b3 c3 k id pad

__global__ void __launch_bounds__(kThreads)
binned_kernel(const float* __restrict__ dirs, const float* __restrict__ origin,
              const int* __restrict__ scal, int ns, const float* __restrict__ table,
              int np_rows, const float* __restrict__ attrs, float* __restrict__ out) {
    __shared__ __align__(16) float rows[kGang][kRow];
    const int strip = blockIdx.x;
    const int off = scal[strip];
    const int gseg = scal[ns + strip];
    const int coff = scal[2 * ns + strip];
    const int total = gseg + scal[3 * ns + strip];

    float d[kRays][3], best[kRays], bu[kRays], bv[kRays];
    int win[kRays];
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
        const long long r = static_cast<long long>(strip) * kStripe + k * kThreads + threadIdx.x;
        d[k][0] = dirs[3 * r];
        d[k][1] = dirs[3 * r + 1];
        d[k][2] = dirs[3 * r + 2];
        best[k] = kBig;
        win[k] = -1;
        bu[k] = bv[k] = 0.0f;
    }

    for (int p = 0; p < total; ++p) {
        const long long base = p < gseg ? off + static_cast<long long>(p) * kGang
                                        : coff + static_cast<long long>(p - gseg) * kGang;
        const long long row = base + threadIdx.x;
        __syncthreads();
        float4* dst = reinterpret_cast<float4*>(rows[threadIdx.x]);
        if (row < np_rows) {
            const float4* src = reinterpret_cast<const float4*>(table + row * kIsect);
            dst[0] = src[0];
            dst[1] = src[1];
            dst[2] = src[2];
        } else {                                    // det = 0: never a hit
            dst[0] = dst[1] = dst[2] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
        __syncthreads();
        for (int jj = 0; jj < kGang; ++jj) {
            const float* tri = rows[jj];
#pragma unroll
            for (int k = 0; k < kRays; ++k) {
                float tval, u, v;
                if (hit_test(d[k][0], d[k][1], d[k][2], tri, &tval, &u, &v) && tval < best[k]) {
                    best[k] = tval;
                    win[k] = __float2int_rn(tri[10]);
                    bu[k] = u;
                    bv[k] = v;
                }
            }
        }
    }

#pragma unroll
    for (int k = 0; k < kRays; ++k) {
        const long long r = static_cast<long long>(strip) * kStripe + k * kThreads + threadIdx.x;
        finish_row(d[k][0], d[k][1], d[k][2], origin, attrs, best[k], kBig, win[k], bu[k],
                   bv[k], out + r * kOut);
    }
}

}  // namespace

VCT_EXPORT int vct_binrast(const float* dirs, const float* origin, const int* scal, int ns,
                           const float* table, int np_rows, const float* attrs, float* out,
                           cudaStream_t stream) {
    binned_kernel<<<ns, kThreads, 0, stream>>>(dirs, origin, scal, ns, table, np_rows, attrs,
                                               out);
    return launch_status();
}
