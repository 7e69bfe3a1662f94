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
// The hit test and the G-buffer row are raycast_common.cuh's, shared with
// the streamed kernel, in exact float32.
#include "raycast_common.cuh"

namespace {

using namespace raycast;

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr float kCullMargin = 1e-4f;   // ops/raycast.py CULL_MARGIN
constexpr float kConeSlack = 4e-6f;    // CONE_SLACK
constexpr float kWideDot = 1e-4f;      // WIDE_DOT

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = add_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

// the eight warp totals, pairwise: (w0 + w4) + (w2 + w6), (w1 + w5) + (w3 + w7)
__device__ __forceinline__ float sum8(const float* w) {
    return add_rn(add_rn(add_rn(w[0], w[4]), add_rn(w[2], w[6])),
                  add_rn(add_rn(w[1], w[5]), add_rn(w[3], w[7])));
}

__device__ __forceinline__ float dot3v(const float* a, const float* b) {
    return add_rn(add_rn(mul_rn(a[0], b[0]), mul_rn(a[1], b[1])), mul_rn(a[2], b[2]));
}

// tile_cull_plain for one row against the block's cone
__device__ __forceinline__ bool keep_row(const float* axis, float sin_a, const float* row) {
    const float k = row[9];
    if (k == 0.0f) return false;
    const float s = k > 0.0f ? 1.0f : -1.0f;
    const float* a = row;
    const float* b = row + 3;
    const float* c = row + 6;
    float e[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) e[i] = sub_rn(sub_rn(a[i], b[i]), c[i]);
    const float na = __fsqrt_rn(dot3v(a, a));
    const float nb = __fsqrt_rn(dot3v(b, b));
    const float nc = __fsqrt_rn(dot3v(c, c));
    const float ne = __fsqrt_rn(dot3v(e, e));
    const float* n[4] = {a, b, c, e};
    const float nn[4] = {na, nb, nc, ne};
    const float scale[4] = {na, nb, nc, add_rn(add_rn(na, nb), nc)};
    bool keep = true;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float an = mul_rn(s, dot3v(axis, n[i]));
        keep = keep && add_rn(add_rn(an, mul_rn(sin_a, nn[i])),
                              mul_rn(kCullMargin, scale[i])) >= 0.0f;
    }
    return keep;
}

__global__ void __launch_bounds__(kBlock)
raycast_kernel(const float* __restrict__ dirs, const float* __restrict__ origin,
               const float* __restrict__ isect, const float* __restrict__ attrs,
               int n, int t, float* __restrict__ out) {
    __shared__ float4 s_tri[kBlock][3];    // survivors: a3 b3 c3 k, 2 unused
    __shared__ int s_id[kBlock];
    __shared__ float s_part[4][kWarps];
    __shared__ int s_cnt[kWarps];
    __shared__ float4 s_out[kBlock * kOut / 4];
    const int lane = threadIdx.x % 32;
    const int warp = threadIdx.x / 32;
    const int r = blockIdx.x * kBlock + threadIdx.x;
    const bool live = r < n;
    const float d0 = live ? dirs[3 * r + 0] : 0.0f;
    const float d1 = live ? dirs[3 * r + 1] : 0.0f;
    const float d2 = live ? dirs[3 * r + 2] : 0.0f;

    // ---- the block's cone (tile_cones) ----
    const float dd = add_rn(add_rn(mul_rn(d0, d0), mul_rn(d1, d1)), mul_rn(d2, d2));
    const bool aims = dd > 0.0f;
    float dn[3] = {0.0f, 0.0f, 0.0f};
    if (aims) {
        const float len = __fsqrt_rn(dd);
        dn[0] = div_rn(d0, len);
        dn[1] = div_rn(d1, len);
        dn[2] = div_rn(d2, len);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        const float w = warp_sum(dn[i]);
        if (lane == 0) s_part[i][warp] = w;
    }
    __syncthreads();
    float axis[3] = {sum8(s_part[0]), sum8(s_part[1]), sum8(s_part[2])};
    const float len = fmaxf(__fsqrt_rn(dot3v(axis, axis)), 1e-12f);
#pragma unroll
    for (int i = 0; i < 3; ++i) axis[i] = div_rn(axis[i], len);
    const float m = warp_min(aims ? dot3v(dn, axis) : kBig);
    if (lane == 0) s_part[3][warp] = m;
    __syncthreads();
    float min_dot = s_part[3][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) min_dot = fminf(min_dot, s_part[3][w]);
    const bool wide = min_dot <= kWideDot;
    const float cos_a = fminf(fmaxf(sub_rn(min_dot, kConeSlack), kWideDot), 1.0f);
    const float sin_a = __fsqrt_rn(fmaxf(sub_rn(1.0f, mul_rn(cos_a, cos_a)), 0.0f));

    float best = kBig;
    int win = -1;
    float bu = 0.0f, bv = 0.0f;
    for (int base = 0; base < t; base += kBlock) {
        // ---- cull 256 rows, one a thread ----
        const int j = base + threadIdx.x;
        float row[12];
        bool keep = false;
        if (j < t) {
            const float4* src = reinterpret_cast<const float4*>(isect + static_cast<long long>(j) * kIsect);
#pragma unroll
            for (int q = 0; q < 3; ++q) {
                const float4 v = __ldg(src + q);
                row[4 * q] = v.x;
                row[4 * q + 1] = v.y;
                row[4 * q + 2] = v.z;
                row[4 * q + 3] = v.w;
            }
            keep = wide || keep_row(axis, sin_a, row);
        }
        const unsigned ballot = __ballot_sync(0xffffffffu, keep);
        __syncthreads();                 // the previous batch's survivors are read
        if (lane == 0) s_cnt[warp] = __popc(ballot);
        __syncthreads();
        int before = 0, cnt = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
            before += w < warp ? s_cnt[w] : 0;
            cnt += s_cnt[w];
        }
        if (keep) {
            const int pos = before + __popc(ballot & ((1u << lane) - 1u));
#pragma unroll
            for (int q = 0; q < 3; ++q)
                s_tri[pos][q] = make_float4(row[4 * q], row[4 * q + 1], row[4 * q + 2],
                                            row[4 * q + 3]);
            s_id[pos] = j;
        }
        __syncthreads();

        // ---- every ray against the survivors, in row order ----
        for (int jj = 0; jj < cnt; ++jj) {
            float tr[12];
#pragma unroll
            for (int q = 0; q < 3; ++q) {
                const float4 v = s_tri[jj][q];
                tr[4 * q] = v.x;
                tr[4 * q + 1] = v.y;
                tr[4 * q + 2] = v.z;
                tr[4 * q + 3] = v.w;
            }
            float tval, u, v;
            if (hit_test(d0, d1, d2, tr, &tval, &u, &v) && tval < best) {
                best = tval;
                win = s_id[jj];
                bu = u;
                bv = v;
            }
        }
    }
    // the rows go out through shared memory, so that each warp's stores
    // cover whole 512-byte runs of the output
    finish_row(d0, d1, d2, origin, attrs, best, kBig, win, bu, bv,
               reinterpret_cast<float*>(s_out + threadIdx.x * (kOut / 4)));
    __syncthreads();
    const int rows = min(kBlock, n - static_cast<int>(blockIdx.x) * kBlock);
    float4* dst = reinterpret_cast<float4*>(out + static_cast<long long>(blockIdx.x) * kBlock * kOut);
    for (int f = threadIdx.x; f < rows * (kOut / 4); f += kBlock) dst[f] = s_out[f];
}

}  // namespace

VCT_EXPORT int vct_raycast(const float* dirs, const float* origin, const float* isect,
                           const float* attrs, int n, int t, float* out,
                           cudaStream_t stream) {
    const int blocks = (n + kBlock - 1) / kBlock;
    raycast_kernel<<<blocks, kBlock, 0, stream>>>(dirs, origin, isect, attrs, n, t, out);
    return launch_status();
}

// registers, local (spill) bytes a thread, shared bytes a block and
// resident warps per SM of the kernel, for the caller's report
VCT_EXPORT int vct_raycast_occupancy(int* info) {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, raycast_kernel);
    int blocks = 0;
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, raycast_kernel, kBlock, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    info[0] = fa.numRegs;
    info[1] = static_cast<int>(fa.localSizeBytes);
    info[2] = static_cast<int>(fa.sharedSizeBytes);
    info[3] = blocks * kBlock / 32;
    return 0;
}
