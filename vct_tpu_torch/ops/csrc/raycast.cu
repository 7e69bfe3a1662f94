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
// '<'.  Every multiply and add rounds on its own (common.cuh): the
// origin-folded products are ~100x larger than their differences, and a
// fused multiply-add flips `valid` on thin and grazing triangles.
#include "common.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kIsect = 16;     // isect row: a3 b3 c3 k, zero padded
constexpr int kAttr = 48;      // vn9 vt9 vb9 uv6 fn3 mat1 alb4 spec3 shin1
constexpr int kOut = 32;
constexpr float kEps = 1e-7f;
constexpr float kTminEps = 1e-4f;
constexpr float kBig = 3.0e38f;

__device__ __forceinline__ float dot3(float d0, float d1, float d2, const float* r) {
    return add_rn(add_rn(mul_rn(d0, r[0]), mul_rn(d1, r[1])), mul_rn(d2, r[2]));
}

// w0 * a[0] + u * a[k] + v * a[2k] for one component, left to right
__device__ __forceinline__ float interp(float w0, float u, float v, const float* a, int k) {
    return add_rn(add_rn(mul_rn(w0, a[0]), mul_rn(u, a[k])), mul_rn(v, a[2 * k]));
}

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
            const float* row = tri[jj];
            const float det = dot3(d0, d1, d2, row + 0);
            const float ud = dot3(d0, d1, d2, row + 3);
            const float vd = dot3(d0, d1, d2, row + 6);
            const float kk = row[9];
            const float s = det > 0.0f ? 1.0f : (det < 0.0f ? -1.0f : 0.0f);
            const float ad = fabsf(det);
            const float inv = div_rn(1.0f, fmaxf(ad, kEps));
            const float sinv = mul_rn(s, inv);
            const bool valid = ad > kEps && mul_rn(s, ud) >= 0.0f
                && mul_rn(s, vd) >= 0.0f
                && mul_rn(s, add_rn(ud, vd)) <= ad
                && mul_rn(s, kk) > mul_rn(kTminEps, ad);
            const float tval = mul_rn(kk, sinv);
            if (valid && tval < best) {
                best = tval;
                win = base + jj;
                bu = mul_rn(ud, sinv);
                bv = mul_rn(vd, sinv);
            }
        }
    }
    if (!live) return;

    // G-buffer row (raycast_pallas._finish_gbuf); a miss keeps u = v = 0
    // and an all-zero attribute row, as the one-hot fetch gives
    const bool hit = best < kBig;
    const float ts = hit ? best : 0.0f;
    float a[kAttr];
#pragma unroll
    for (int q = 0; q < kAttr; ++q) a[q] = hit ? attrs[win * kAttr + q] : 0.0f;
    const float u = bu, v = bv;
    const float w0 = sub_rn(sub_rn(1.0f, u), v);

    float o[kOut];
    float nrm[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        o[i] = add_rn(origin[i], mul_rn(ts, i == 0 ? d0 : (i == 1 ? d1 : d2)));
        nrm[i] = interp(w0, u, v, a + i, 3);           // vn
        o[6 + i] = a[33 + i];                           // face normal
        o[9 + i] = interp(w0, u, v, a + 9 + i, 3);      // tangent
        o[12 + i] = interp(w0, u, v, a + 18 + i, 3);    // bitangent
    }
    const float nn = add_rn(add_rn(mul_rn(nrm[0], nrm[0]), mul_rn(nrm[1], nrm[1])),
                            mul_rn(nrm[2], nrm[2]));
    const float rs = rsqrtf(fmaxf(nn, 1e-24f));
#pragma unroll
    for (int i = 0; i < 3; ++i) o[3 + i] = mul_rn(nrm[i], rs);
    o[15] = interp(w0, u, v, a + 27, 2);                // uv
    o[16] = interp(w0, u, v, a + 28, 2);
    o[17] = a[36];                                      // material id
    o[18] = ts;
    o[19] = hit ? 1.0f : 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) o[20 + i] = a[37 + i];  // albedo4 spec3 shin
#pragma unroll
    for (int i = 28; i < kOut; ++i) o[i] = 0.0f;
    float4* dst = reinterpret_cast<float4*>(out + static_cast<long long>(r) * kOut);
#pragma unroll
    for (int i = 0; i < kOut / 4; ++i)
        dst[i] = make_float4(o[4 * i], o[4 * i + 1], o[4 * i + 2], o[4 * i + 3]);
}

}  // namespace

VCT_EXPORT int vct_raycast(const float* dirs, const float* origin, const float* isect,
                           const float* attrs, int n, int t, float* out,
                           cudaStream_t stream) {
    const int blocks = (n + kBlock - 1) / kBlock;
    raycast_kernel<<<blocks, kBlock, 0, stream>>>(dirs, origin, isect, attrs, n, t, out);
    return launch_status();
}
