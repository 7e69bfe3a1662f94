// Same-origin closest-hit raycast + G-buffer: replaces
// vct_tpu/ops/raycast_pallas.py raycast_gbuf24 (_kernel, finish as
// _finish_gbuf).
//
// What it computes: for N camera rays sharing one origin, Moller-Trumbore
// against every triangle of the origin-folded table (pack_tables: det =
// d.a, u*det = d.b, v*det = d.c, t*det = k), the first-min winner by
// triangle index, and the barycentric 32-column G-buffer row.
//
// What bounds it: arithmetic, N x T hit tests of ~20 flops each; the
// tables are KBs.  One thread per ray; the block stages the triangle rows
// through shared memory, 256 at a time, and every thread reads the same
// row at once (a broadcast, no bank conflicts).  The TPU kernel fetched
// the winner's attributes with a one-hot matmul; here the thread keeps the
// winner's index and reads its 48-float row once at the end.
//
// The winner is replaced only on a strict '<', scanning triangles in
// index order, which is the global first minimum -- the same winner as
// the TPU kernel's in-chunk argmin followed by its cross-chunk strict
// '<'.  The hit test and the G-buffer row are raycast_common.cuh's,
// shared with the streamed kernel, in exact float32.
#include "raycast_common.cuh"

namespace {

using namespace raycast;

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
raycast_kernel(const float* __restrict__ dirs, const float* __restrict__ origin,
               const float* __restrict__ isect, const float* __restrict__ attrs,
               int n, int t, float* __restrict__ out) {
    __shared__ float tri[kBlock][10];
    const int r = blockIdx.x * kBlock + threadIdx.x;
    const bool live = r < n;
    const float d0 = live ? dirs[3 * r + 0] : 0.0f;
    const float d1 = live ? dirs[3 * r + 1] : 0.0f;
    const float d2 = live ? dirs[3 * r + 2] : 0.0f;

    float best = kBig;
    int win = -1;
    float bu = 0.0f, bv = 0.0f;
    for (int base = 0; base < t; base += kBlock) {
        __syncthreads();
        const int j = base + threadIdx.x;
        if (j < t) {
#pragma unroll
            for (int q = 0; q < 10; ++q) tri[threadIdx.x][q] = isect[j * kIsect + q];
        }
        __syncthreads();
        const int cnt = min(kBlock, t - base);
        for (int jj = 0; jj < cnt; ++jj) {
            float tval, u, v;
            if (hit_test(d0, d1, d2, tri[jj], &tval, &u, &v) && tval < best) {
                best = tval;
                win = base + jj;
                bu = u;
                bv = v;
            }
        }
    }
    if (!live) return;
    finish_row(d0, d1, d2, origin, attrs, best, kBig, win, bu, bv,
               out + static_cast<long long>(r) * kOut);
}

}  // namespace

VCT_EXPORT int vct_raycast(const float* dirs, const float* origin, const float* isect,
                           const float* attrs, int n, int t, float* out,
                           cudaStream_t stream) {
    const int blocks = (n + kBlock - 1) / kBlock;
    raycast_kernel<<<blocks, kBlock, 0, stream>>>(dirs, origin, isect, attrs, n, t, out);
    return launch_status();
}
