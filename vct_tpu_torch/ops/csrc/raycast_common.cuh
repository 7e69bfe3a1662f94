// Shared by the two raycast kernels (raycast.cu, raycast_stream.cu): the
// origin-folded Moller-Trumbore test and the G-buffer row of
// vct_tpu/ops/raycast_pallas.py (_kernel / _stream_kernel and
// _finish_gbuf), in exact float32: every multiply and add rounds on its
// own, because the origin-folded products are ~100x larger than their
// differences and a fused multiply-add flips `valid` on thin and grazing
// triangles.
#pragma once

#include "common.cuh"

namespace raycast {

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

// One triangle row (a3 b3 c3 k) against direction d: true and t, u, v
// when the ray hits it in front of the origin (t, u, v are not written
// otherwise).  The test needs no division, so the IEEE division, the
// costliest step, runs only for hits.
__device__ __forceinline__ bool hit_test(float d0, float d1, float d2, const float* row,
                                         float* t, float* u, float* v) {
    const float det = dot3(d0, d1, d2, row + 0);
    const float ud = dot3(d0, d1, d2, row + 3);
    const float vd = dot3(d0, d1, d2, row + 6);
    const float kk = row[9];
    const float s = det > 0.0f ? 1.0f : (det < 0.0f ? -1.0f : 0.0f);
    const float ad = fabsf(det);
    const bool valid = ad > kEps && mul_rn(s, ud) >= 0.0f
        && mul_rn(s, vd) >= 0.0f
        && mul_rn(s, add_rn(ud, vd)) <= ad
        && mul_rn(s, kk) > mul_rn(kTminEps, ad);
    if (!valid) return false;
    const float inv = div_rn(1.0f, fmaxf(ad, kEps));
    const float sinv = mul_rn(s, inv);
    *t = mul_rn(kk, sinv);
    *u = mul_rn(ud, sinv);
    *v = mul_rn(vd, sinv);
    return true;
}

// The 32-column G-buffer row (raycast_pallas._finish_gbuf) of a ray whose
// best candidate is `best` on triangle `win` at barycentrics (u, v); the
// ray hit when best < miss_at.  A miss keeps u = v = 0 and an all-zero
// attribute row, as the one-hot fetch gives.
__device__ __forceinline__ void finish_row(float d0, float d1, float d2,
                                           const float* __restrict__ origin,
                                           const float* __restrict__ attrs, float best,
                                           float miss_at, int win, float u, float v,
                                           float* __restrict__ out_row) {
    const bool hit = best < miss_at;
    const float ts = hit ? best : 0.0f;
    float a[kAttr];
#pragma unroll
    for (int q = 0; q < kAttr; ++q)
        a[q] = hit ? attrs[static_cast<long long>(win) * kAttr + q] : 0.0f;
    if (!hit) u = v = 0.0f;
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
    float4* dst = reinterpret_cast<float4*>(out_row);
#pragma unroll
    for (int i = 0; i < kOut / 4; ++i)
        dst[i] = make_float4(o[4 * i], o[4 * i + 1], o[4 * i + 2], o[4 * i + 3]);
}

}  // namespace raycast
