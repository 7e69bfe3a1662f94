// Shared by the raycast kernels (raycast.cu, binrast.cu, raycast_stream.cu):
// the origin-folded Moller-Trumbore test and the G-buffer row of
// vct_tpu/ops/raycast_pallas.py (_kernel / _stream_kernel and
// _finish_gbuf), in exact float32: every multiply and add rounds on its
// own, because the origin-folded products are ~100x larger than their
// differences and a fused multiply-add flips `valid` on thin and grazing
// triangles.  And the cone cull of all three (ops/raycast.py tile_cones
// and cull_rows state it in the same float order): a ray group's direction
// cone, the half-space test of one row against it, the ballot compaction
// of a batch's survivors, the hit tests against them and the G-buffer
// rows' way out through shared memory.  A group is W warps: the whole
// 256-thread block (W = kWarps, with block barriers) in the whole-table and
// binned kernels, one warp (W = 1, warp-synchronous) in the streamed one.
#pragma once

#include "common.cuh"

namespace raycast {

constexpr int kIsect = 16;     // isect row: a3 b3 c3 k, zero padded
constexpr int kAttr = 48;      // vn9 vt9 vb9 uv6 fn3 mat1 alb4 spec3 shin1
constexpr int kOut = 32;
constexpr float kEps = 1e-7f;
constexpr float kTminEps = 1e-4f;
constexpr float kBig = 3.0e38f;
constexpr int kBlock = 256;            // rays a block: one 16x16 tile
constexpr int kWarps = kBlock / 32;
constexpr float kCullMargin = 1e-4f;   // ops/raycast.py CULL_MARGIN
constexpr float kConeSlack = 4e-6f;    // CONE_SLACK
constexpr float kWideDot = 1e-4f;      // WIDE_DOT

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

// ---- the per-tile cone cull -------------------------------------------

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

// W warp totals, pairwise by halves as ops/raycast.py _halve: for eight,
// (w0 + w4) + (w2 + w6), (w1 + w5) + (w3 + w7)
template <int W>
__device__ __forceinline__ float halve_sum(const float* w) {
    float x[W];
#pragma unroll
    for (int i = 0; i < W; ++i) x[i] = w[i];
#pragma unroll
    for (int h = W / 2; h > 0; h /= 2)
#pragma unroll
        for (int i = 0; i < h; ++i) x[i] = add_rn(x[i], x[i + h]);
    return x[0];
}

// a group's barrier: its warp, or the block
template <int W>
__device__ __forceinline__ void group_sync() {
    if constexpr (W == 1) __syncwarp();
    else __syncthreads();
}

__device__ __forceinline__ float dot3v(const float* a, const float* b) {
    return add_rn(add_rn(mul_rn(a[0], b[0]), mul_rn(a[1], b[1])), mul_rn(a[2], b[2]));
}

// The direction cone of a group's 32 W rays (tile_cones with group = 32 W):
// axis, the sine of the half-angle and `wide` (no cone narrower than a
// half-space).  Rays of length 0 and rays that are not `live` do not widen
// it.  Every thread of the group calls it; with W > 1 the group is the
// block and s_part is __shared__ float[4][W] (unused with W = 1).
struct Cone {
    float axis[3];
    float sin_a;
    bool wide;
};

template <int W = kWarps>
__device__ __forceinline__ Cone group_cone(float d0, float d1, float d2, bool live,
                                           float (*s_part)[W]) {
    const int lane = threadIdx.x % 32;
    const int warp = threadIdx.x / 32 % W;
    const float dd = add_rn(add_rn(mul_rn(d0, d0), mul_rn(d1, d1)), mul_rn(d2, d2));
    const bool aims = live && dd > 0.0f;
    float dn[3] = {0.0f, 0.0f, 0.0f};
    if (aims) {
        const float len = __fsqrt_rn(dd);
        dn[0] = div_rn(d0, len);
        dn[1] = div_rn(d1, len);
        dn[2] = div_rn(d2, len);
    }
    Cone c;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        c.axis[i] = warp_sum(dn[i]);
        if constexpr (W > 1) {
            if (lane == 0) s_part[i][warp] = c.axis[i];
        }
    }
    if constexpr (W > 1) {
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 3; ++i) c.axis[i] = halve_sum<W>(s_part[i]);
    }
    const float len = fmaxf(__fsqrt_rn(dot3v(c.axis, c.axis)), 1e-12f);
#pragma unroll
    for (int i = 0; i < 3; ++i) c.axis[i] = div_rn(c.axis[i], len);
    float min_dot = warp_min(aims ? dot3v(dn, c.axis) : kBig);
    if constexpr (W > 1) {
        if (lane == 0) s_part[3][warp] = min_dot;
        __syncthreads();
        min_dot = s_part[3][0];
#pragma unroll
        for (int w = 1; w < W; ++w) min_dot = fminf(min_dot, s_part[3][w]);
    }
    c.wide = min_dot <= kWideDot;
    const float cos_a = fminf(fmaxf(sub_rn(min_dot, kConeSlack), kWideDot), 1.0f);
    c.sin_a = __fsqrt_rn(fmaxf(sub_rn(1.0f, mul_rn(cos_a, cos_a)), 0.0f));
    return c;
}

// cull_rows for one row (a3 b3 c3 k) against the block's cone: false when
// the cone misses one of the row's four half-spaces by the margin
__device__ __forceinline__ bool keep_row(const Cone& cone, const float* row) {
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
        const float an = mul_rn(s, dot3v(cone.axis, n[i]));
        keep = keep && add_rn(add_rn(an, mul_rn(cone.sin_a, nn[i])),
                              mul_rn(kCullMargin, scale[i])) >= 0.0f;
    }
    return keep;
}

// A necessary condition of keep_row without its four square roots: each
// norm |n| is replaced by an upper bound, the sum of |n_i| times 1.0001
// (the L1 norm is at least the L2 norm, and 1.0001 covers both roundings
// many times over).  With sin_a and kCullMargin >= 0, rounding to nearest
// is monotone in each replaced term, so every half-space sum is at least
// keep_row's: a row this drops, keep_row drops too, and a caller that asks
// keep_row only for the rows this keeps keeps exactly keep_row's rows.
// That needs keep_row's squared norms to be finite and their rounding
// relative: a row whose bounds sum above kNormBoundMax (so may overflow
// when squared; e's bound is at most that sum, up to rounding) or whose
// least bound lies below kNormBoundMin (its largest term's square may be
// subnormal and round up) is kept here, for keep_row alone to decide
// (ops/raycast.py may_keep_rows states this in plain PyTorch).  A row
// holding a NaN fails every half-space in both.
constexpr float kNormBoundMin = 1e-18f;
constexpr float kNormBoundMax = 1e18f;

__device__ __forceinline__ float norm_bound(const float* n) {
    return mul_rn(add_rn(add_rn(fabsf(n[0]), fabsf(n[1])), fabsf(n[2])), 1.0001f);
}

__device__ __forceinline__ bool may_keep_row(const Cone& cone, const float* row) {
    const float k = row[9];
    if (k == 0.0f) return false;
    const float s = k > 0.0f ? 1.0f : -1.0f;
    const float* a = row;
    const float* b = row + 3;
    const float* c = row + 6;
    float e[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) e[i] = sub_rn(sub_rn(a[i], b[i]), c[i]);
    const float ua = norm_bound(a);
    const float ub = norm_bound(b);
    const float uc = norm_bound(c);
    const float ue = norm_bound(e);
    const float sum = add_rn(add_rn(ua, ub), uc);
    if (!(sum <= kNormBoundMax && fminf(fminf(ua, ub), fminf(uc, ue)) >= kNormBoundMin))
        return true;
    const float* n[4] = {a, b, c, e};
    const float nn[4] = {ua, ub, uc, ue};
    const float scale[4] = {ua, ub, uc, sum};
    bool keep = true;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float an = mul_rn(s, dot3v(cone.axis, n[i]));
        keep = keep && add_rn(add_rn(an, mul_rn(cone.sin_a, nn[i])),
                              mul_rn(kCullMargin, scale[i])) >= 0.0f;
    }
    return keep;
}

// one row of the table (three float4s through the read-only path)
__device__ __forceinline__ void load_row(const float* __restrict__ src, float* row) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(src) + q);
        row[4 * q] = v.x;
        row[4 * q + 1] = v.y;
        row[4 * q + 2] = v.z;
        row[4 * q + 3] = v.w;
    }
}

// The survivors of one batch (a row a thread of the group, `keep` its
// verdict) written in thread order to s_tri (a3 b3 c3 k and two unused)
// and s_id, by warp ballot and prefix popcount; returns their count.
// Every thread of the group calls it; with W > 1, s_cnt is __shared__
// int[W].  A warp may call it again with s_tri and s_id advanced past the
// survivors it holds, to append a further batch.
template <int W = kWarps>
__device__ __forceinline__ int compact(bool keep, const float* row, int id,
                                       float4 (*s_tri)[3], int* s_id, int* s_cnt) {
    const int lane = threadIdx.x % 32;
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    int before = 0, cnt = __popc(ballot);
    group_sync<W>();                 // the previous batch's survivors are read
    if constexpr (W > 1) {
        const int warp = threadIdx.x / 32;
        if (lane == 0) s_cnt[warp] = cnt;
        __syncthreads();
        cnt = 0;
#pragma unroll
        for (int w = 0; w < W; ++w) {
            before += w < warp ? s_cnt[w] : 0;
            cnt += s_cnt[w];
        }
    }
    if (keep) {
        const int pos = before + __popc(ballot & ((1u << lane) - 1u));
#pragma unroll
        for (int q = 0; q < 3; ++q)
            s_tri[pos][q] = make_float4(row[4 * q], row[4 * q + 1], row[4 * q + 2],
                                        row[4 * q + 3]);
        s_id[pos] = id;
    }
    group_sync<W>();
    return cnt;
}

// The best hit so far against the batch's survivors, in their order; the
// best is replaced on a strict '<' only.  With kTmin, a hit must also lie
// beyond tmin (the streamed raycast's per-ray minimum distance).
template <bool kTmin = false>
__device__ __forceinline__ void cast_survivors(float d0, float d1, float d2,
                                               float4 (*s_tri)[3], const int* s_id,
                                               int cnt, float* best, int* win, float* bu,
                                               float* bv, float tmin = 0.0f) {
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
        if (hit_test(d0, d1, d2, tr, &tval, &u, &v) && (!kTmin || tval > tmin)
            && tval < *best) {
            *best = tval;
            *win = s_id[jj];
            *bu = u;
            *bv = v;
        }
    }
}

// The group's G-buffer rows (a ray hit when best < miss_at), finished into
// s_out (32 W * kOut floats) and copied out in whole 512-byte runs: `rows`
// rows from `dst`.  s_out must be free: nothing of the group reads it.
template <int W = kWarps>
__device__ __forceinline__ void store_rows(float d0, float d1, float d2,
                                           const float* __restrict__ origin,
                                           const float* __restrict__ attrs, float best,
                                           float miss_at, int win, float u, float v,
                                           float4* s_out, int rows,
                                           float* __restrict__ dst) {
    constexpr int kThreads = 32 * W;
    const int t = threadIdx.x % kThreads;
    finish_row(d0, d1, d2, origin, attrs, best, miss_at, win, u, v,
               reinterpret_cast<float*>(s_out + t * (kOut / 4)));
    group_sync<W>();
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int f = t; f < rows * (kOut / 4); f += kThreads) d4[f] = s_out[f];
}

}  // namespace raycast
