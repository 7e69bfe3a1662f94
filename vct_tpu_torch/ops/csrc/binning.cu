// The binning of the binned raycast: ops/binrast.py pack_rows and
// bin_triangles on CUDA tensors, equal bit for bit to their plain versions
// (pack_rows_plain, bin_triangles_plain) run on the same tensors.
//
// What it replaces: no Pallas kernel.  The JAX package leaves the binning
// to XLA (vct_tpu/ops/binrast_pallas.py:128-275, pack_rows and
// bin_triangles).  Run eagerly, the plain version is about 150 small
// launches a 1080p frame over 287,232 triangles and 2.09 M rays, and the
// card waits on the host through most of them.  Here it is nine kernels on
// the caller's stream, with the frame's two ray sums and the one sort of
// the slots left to PyTorch, and no read back to the host:
//
//   pack_kernel      one thread a triangle: the isect row (a, b, c, k and
//                    the id in column 10, raycast.pack_tables' order) and
//                    the attrs row, staged in shared memory and written out
//                    as float4s;
//   strip_kernel     one block a 1024-ray strip: z, u, v of each ray in the
//                    gnomonic frame, the strip's min and max of u and v,
//                    and its sums of u and v;
//   envelope_kernel  one block: pu, pv, the signs su, sv, the strip
//                    rectangles and the four monotone envelopes;
//   tri_kernel       one thread a triangle: the six candidates with the
//                    near-plane clip, the screen box, the four envelope
//                    searches (the envelopes in shared memory), nw, nh,
//                    area, the dense tier's slots, and the block's counts of
//                    medium and wide triangles;
//   scan_kernel      one block: each block's offsets, the tiers' totals and
//                    n_col_total;
//   rank_kernel      one thread a triangle: its rank in the stable order of
//                    bin_triangles_plain's argsort (medium, then column,
//                    then the rest, each by id) and, by it, the medium and
//                    column slots it fills, unused ones included;
//   (torch.sort)     the slot words below 2**19 triangles, the bins stably
//                    at or above, as the plain version sorts them;
//   bounds_kernel    one thread a sorted slot: the first slot of each bin;
//   pad_kernel       one block: the SEGAL-padded segment offsets and scal;
//   table_kernel     four threads a table row: the row's source slot (its
//                    bin by a binary search of the padded offsets) and the
//                    isect row it copies, one float4 a thread.
//
// The slot order.  bin_triangles_plain selects the medium tier's triangles
// as order[:nb_med] and the column tier's as order[start : start + nb_col]
// of one stable argsort of key3.  The rank of a triangle in that order
// follows from exclusive prefix counts of two flags, medium (4 < area <=
// 16) and wide (area > 16): with P_m0 and P_big those counts, the medium
// tier keeps the first nb_med medium triangles (is_m = P_m0 < nb_med), the
// rest overflow to the column tier, whose own prefix count is P_big +
// max(P_m0 - nb_med, 0), and which keeps its first nb_col (is_c).  Ranks:
// medium P_m; column count_m + P_c; the rest count_m + count_c + (id - P_m
// - P_c).  ops/binrast.py slot_order_plain states the same rule in plain
// PyTorch, and the CPU tests hold it to the argsort.  Every slot is
// written, its triangle id included where the slot is unused: the table's
// padding rows read those ids.
//
// Bit for bit.  Every multiply, add and divide rounds on its own
// (common.cuh's *_rn), square roots are IEEE (__fsqrt_rn), as PyTorch's
// eager kernels round them.  Two sums decide the frame's last bits, the
// ray sums f and ex, and stay PyTorch's (binrast.bin_triangles_cuda), so
// the frame, and with it every table, equals the plain version's on the
// same tensors.  pu = (max u - min u) / wp: PyTorch divides a device tensor
// by a host number as a multiply by the host's float reciprocal, and so
// does envelope_kernel.  Min and max are exact in any order (NaN propagates
// as in torch's reductions).  The strip means only set the signs su and
// sv; they are summed in double, each thread's four rays in order, then a
// warp's lanes by xor-shuffle, then the block's warps in order, so the
// signs agree with the plain version's float means unless the first and
// last strip column (row) have means within float rounding of each other.
// The envelope searches are torch.searchsorted's binary searches.
//
// What bounds it: bytes.  A frame at the operating point (287,232
// triangles, 1080p) reads 25 MB of rays and ~56 MB of triangle inputs,
// writes 73 MB of isect and attrs rows, moves ~60 MB through the sort of
// 1.82 M slot words and writes the 2.08 M-row table (133 MB) from rows
// gathered out of L2 (133 MB): ~0.15 ms at 3.35 TB/s.  The design keeps
// every pass a single sweep: rows leave through shared memory in whole
// float4 runs, the per-triangle state between the two triangle passes is
// one int4, and the table is written in 512-byte runs a warp.
#include "common.cuh"

namespace {

constexpr int kStripe = 1024;       // rays a strip (binrast.STRIPE)
constexpr int kKA = 4;              // dense tier slots a triangle
constexpr int kKB = 16;             // medium tier
constexpr int kKC = 32;             // column tier
constexpr int kSegal = 128;         // segment alignment in the table
constexpr int kGang = 256;          // table rows a gang
constexpr float kZeps = 1e-3f;      // near-plane distance
constexpr float kBig = 3.0e38f;     // raycast.BIG
constexpr int kSentinel = 0x7FFFFFFF;
constexpr int kTriBits = 19;        // slot word: bin << 19 | triangle
constexpr int kIsect = 16;
constexpr int kAttr = 48;
constexpr int kPackBlock = 128;
constexpr int kStripBlock = 256;
constexpr int kTriBlock = 256;      // binrast.BIN_TRI_BLOCK
constexpr int kOneBlock = 1024;     // the single-block kernels
constexpr int kTableBlock = 256;
constexpr int kHead = 12;           // frame: f3 ex3 ey3 su sv pad, then envelopes

__device__ __forceinline__ float min_nan(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float max_nan(float a, float b) { return (a > b || a != a) ? a : b; }
// torch.clamp_min: NaN stays NaN
__device__ __forceinline__ float clamp_min_nan(float x, float lo) {
    return x != x ? x : fmaxf(x, lo);
}

__device__ __forceinline__ float dot3_rn(float a0, float a1, float a2, const float* b) {
    return add_rn(add_rn(mul_rn(a0, b[0]), mul_rn(a1, b[1])), mul_rn(a2, b[2]));
}

// binrast._gnomonic_frame after its two sums: fr = f3 ex3 ey3
__device__ void gnomonic_frame(const float* fs, const float* xs, float* fr) {
    float f[3], ex[3];
    float n = clamp_min_nan(__fsqrt_rn(dot3_rn(fs[0], fs[1], fs[2], fs)), 1e-12f);
    for (int c = 0; c < 3; ++c) f[c] = div_rn(fs[c], n);
    const float d = dot3_rn(xs[0], xs[1], xs[2], f);
    for (int c = 0; c < 3; ++c) ex[c] = sub_rn(xs[c], mul_rn(d, f[c]));
    n = clamp_min_nan(__fsqrt_rn(dot3_rn(ex[0], ex[1], ex[2], ex)), 1e-12f);
    for (int c = 0; c < 3; ++c) ex[c] = div_rn(ex[c], n);
    for (int c = 0; c < 3; ++c) {
        fr[c] = f[c];
        fr[3 + c] = ex[c];
    }
    fr[6] = sub_rn(mul_rn(f[1], ex[2]), mul_rn(f[2], ex[1]));
    fr[7] = sub_rn(mul_rn(f[2], ex[0]), mul_rn(f[0], ex[2]));
    fr[8] = sub_rn(mul_rn(f[0], ex[1]), mul_rn(f[1], ex[0]));
}

// torch.searchsorted over a nondecreasing `seq` of n: entries below v
// (left) or at or below v (right)
__device__ __forceinline__ int lower_bound(const float* seq, int n, float v) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = lo + ((hi - lo) >> 1);
        if (!(seq[mid] >= v)) lo = mid + 1; else hi = mid;
    }
    return lo;
}

__device__ __forceinline__ int upper_bound(const float* seq, int n, float v) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = lo + ((hi - lo) >> 1);
        if (!(seq[mid] > v)) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// Exclusive prefix sums of a block's (a, b) pairs in thread order, and
// their totals.  Every thread of the block calls it.
__device__ int2 block_scan2(int2 v, int2* total) {
    __shared__ int2 s_warp[32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = (blockDim.x + 31) >> 5;
    int2 inc = v;
    for (int o = 1; o < 32; o <<= 1) {
        const int x = __shfl_up_sync(0xffffffffu, inc.x, o);
        const int y = __shfl_up_sync(0xffffffffu, inc.y, o);
        if (lane >= o) {
            inc.x += x;
            inc.y += y;
        }
    }
    if (lane == 31) s_warp[warp] = inc;
    __syncthreads();
    if (warp == 0) {
        int2 w = lane < nwarps ? s_warp[lane] : make_int2(0, 0);
        for (int o = 1; o < 32; o <<= 1) {
            const int x = __shfl_up_sync(0xffffffffu, w.x, o);
            const int y = __shfl_up_sync(0xffffffffu, w.y, o);
            if (lane >= o) {
                w.x += x;
                w.y += y;
            }
        }
        s_warp[lane] = w;
    }
    __syncthreads();
    const int2 off = warp > 0 ? s_warp[warp - 1] : make_int2(0, 0);
    *total = s_warp[nwarps - 1];
    __syncthreads();                      // s_warp is reused by the next call
    return make_int2(off.x + inc.x - v.x, off.y + inc.y - v.y);
}

// ---- pack ---------------------------------------------------------------

__global__ void __launch_bounds__(kPackBlock)
pack_kernel(const float* __restrict__ v0, const float* __restrict__ e1,
            const float* __restrict__ e2, const float* __restrict__ vn,
            const float* __restrict__ vt, const float* __restrict__ vb,
            const float* __restrict__ vuv, const float* __restrict__ fn,
            const int* __restrict__ mat, const float* __restrict__ origin,
            const float* __restrict__ albedo, const float* __restrict__ specular,
            const float* __restrict__ shininess, int t, float* __restrict__ isect,
            float* __restrict__ attrs) {
    __shared__ __align__(16) float s_isect[kPackBlock * kIsect];
    __shared__ __align__(16) float s_attrs[kPackBlock * kAttr];
    const int base = blockIdx.x * kPackBlock;
    const int i = base + threadIdx.x;
    if (i < t) {
        float p[3], a1[3], a2[3], tv[3];
        for (int c = 0; c < 3; ++c) {
            p[c] = v0[3LL * i + c];
            a1[c] = e1[3LL * i + c];
            a2[c] = e2[3LL * i + c];
            tv[c] = sub_rn(origin[c], p[c]);
        }
        float* r = s_isect + threadIdx.x * kIsect;
        // raycast.pack_tables: a = e2 x e1, b = e2 x tvec, c = tvec x e1
        r[0] = sub_rn(mul_rn(a2[1], a1[2]), mul_rn(a2[2], a1[1]));
        r[1] = sub_rn(mul_rn(a2[2], a1[0]), mul_rn(a2[0], a1[2]));
        r[2] = sub_rn(mul_rn(a2[0], a1[1]), mul_rn(a2[1], a1[0]));
        r[3] = sub_rn(mul_rn(a2[1], tv[2]), mul_rn(a2[2], tv[1]));
        r[4] = sub_rn(mul_rn(a2[2], tv[0]), mul_rn(a2[0], tv[2]));
        r[5] = sub_rn(mul_rn(a2[0], tv[1]), mul_rn(a2[1], tv[0]));
        r[6] = sub_rn(mul_rn(tv[1], a1[2]), mul_rn(tv[2], a1[1]));
        r[7] = sub_rn(mul_rn(tv[2], a1[0]), mul_rn(tv[0], a1[2]));
        r[8] = sub_rn(mul_rn(tv[0], a1[1]), mul_rn(tv[1], a1[0]));
        r[9] = dot3_rn(a2[0], a2[1], a2[2], r + 6);
        r[10] = static_cast<float>(i);
        for (int c = 11; c < kIsect; ++c) r[c] = 0.0f;

        float* q = s_attrs + threadIdx.x * kAttr;
        for (int c = 0; c < 9; ++c) {
            q[c] = vn[9LL * i + c];
            q[9 + c] = vt[9LL * i + c];
            q[18 + c] = vb[9LL * i + c];
        }
        for (int c = 0; c < 6; ++c) q[27 + c] = vuv[6LL * i + c];
        for (int c = 0; c < 3; ++c) q[33 + c] = fn[3LL * i + c];
        const int m = mat[i];
        q[36] = static_cast<float>(m);
        for (int c = 0; c < 4; ++c) q[37 + c] = albedo ? albedo[4LL * m + c] : 0.0f;
        for (int c = 0; c < 3; ++c) q[41 + c] = specular ? specular[3LL * m + c] : 0.0f;
        q[44] = shininess ? shininess[m] : 20.0f;
        for (int c = 45; c < kAttr; ++c) q[c] = 0.0f;
    }
    __syncthreads();
    const int rows = min(kPackBlock, t - base);
    const float4* si = reinterpret_cast<const float4*>(s_isect);
    float4* gi = reinterpret_cast<float4*>(isect) + static_cast<long long>(base) * (kIsect / 4);
    for (int k = threadIdx.x; k < rows * (kIsect / 4); k += kPackBlock) gi[k] = si[k];
    const float4* sa = reinterpret_cast<const float4*>(s_attrs);
    float4* ga = reinterpret_cast<float4*>(attrs) + static_cast<long long>(base) * (kAttr / 4);
    for (int k = threadIdx.x; k < rows * (kAttr / 4); k += kPackBlock) ga[k] = sa[k];
}

// ---- the strip frame ----------------------------------------------------

// smm (4, ns): each strip's min u, max u, min v, max v; ssum (2, ns): its
// sums of u and of v
__global__ void __launch_bounds__(kStripBlock)
strip_kernel(const float* __restrict__ dirs, const float* __restrict__ fsum,
             const float* __restrict__ xsum, int ns, float* __restrict__ smm,
             double* __restrict__ ssum) {
    constexpr int kW = kStripBlock / 32;
    __shared__ float s_fr[9];
    __shared__ float s_mm[4][kW];
    __shared__ double s_sum[2][kW];
    if (threadIdx.x == 0) gnomonic_frame(fsum, xsum, s_fr);
    __syncthreads();
    const int s = blockIdx.x;
    float umin = INFINITY, umax = -INFINITY, vmin = INFINITY, vmax = -INFINITY;
    double us = 0.0, vs = 0.0;
    for (int k = 0; k < kStripe / kStripBlock; ++k) {
        const long long r = static_cast<long long>(s) * kStripe + k * kStripBlock + threadIdx.x;
        const float d0 = dirs[3 * r], d1 = dirs[3 * r + 1], d2 = dirs[3 * r + 2];
        const float z = dot3_rn(d0, d1, d2, s_fr);
        const float u = div_rn(dot3_rn(d0, d1, d2, s_fr + 3), z);
        const float v = div_rn(dot3_rn(d0, d1, d2, s_fr + 6), z);
        umin = min_nan(umin, u);
        umax = max_nan(umax, u);
        vmin = min_nan(vmin, v);
        vmax = max_nan(vmax, v);
        us += static_cast<double>(u);
        vs += static_cast<double>(v);
    }
    for (int o = 16; o > 0; o >>= 1) {
        umin = min_nan(umin, __shfl_xor_sync(0xffffffffu, umin, o));
        umax = max_nan(umax, __shfl_xor_sync(0xffffffffu, umax, o));
        vmin = min_nan(vmin, __shfl_xor_sync(0xffffffffu, vmin, o));
        vmax = max_nan(vmax, __shfl_xor_sync(0xffffffffu, vmax, o));
        us += __shfl_xor_sync(0xffffffffu, us, o);
        vs += __shfl_xor_sync(0xffffffffu, vs, o);
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) {
        s_mm[0][warp] = umin;
        s_mm[1][warp] = umax;
        s_mm[2][warp] = vmin;
        s_mm[3][warp] = vmax;
        s_sum[0][warp] = us;
        s_sum[1][warp] = vs;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int w = 1; w < kW; ++w) {
            umin = min_nan(umin, s_mm[0][w]);
            umax = max_nan(umax, s_mm[1][w]);
            vmin = min_nan(vmin, s_mm[2][w]);
            vmax = max_nan(vmax, s_mm[3][w]);
            us += s_sum[0][w];
            vs += s_sum[1][w];
        }
        smm[s] = umin;
        smm[ns + s] = umax;
        smm[2 * ns + s] = vmin;
        smm[3 * ns + s] = vmax;
        ssum[s] = us;
        ssum[ns + s] = vs;
    }
}

// frame: f3 ex3 ey3 su sv 0, then col_hi[scols], col_lo[scols],
// row_hi[srows], row_lo[srows]
__global__ void __launch_bounds__(kOneBlock)
envelope_kernel(const float* __restrict__ fsum, const float* __restrict__ xsum,
                const float* __restrict__ smm, const double* __restrict__ ssum, int ns,
                int srows, int scols, int hp, int wp, float* __restrict__ frame) {
    constexpr int kW = kOneBlock / 32;
    __shared__ float s_mm[4][kW];
    __shared__ float s_par[4];               // pu, pv, su, sv
    if (threadIdx.x == 0) gnomonic_frame(fsum, xsum, frame);
    float umin = INFINITY, umax = -INFINITY, vmin = INFINITY, vmax = -INFINITY;
    for (int s = threadIdx.x; s < ns; s += kOneBlock) {
        umin = min_nan(umin, smm[s]);
        umax = max_nan(umax, smm[ns + s]);
        vmin = min_nan(vmin, smm[2 * ns + s]);
        vmax = max_nan(vmax, smm[3 * ns + s]);
    }
    for (int o = 16; o > 0; o >>= 1) {
        umin = min_nan(umin, __shfl_xor_sync(0xffffffffu, umin, o));
        umax = max_nan(umax, __shfl_xor_sync(0xffffffffu, umax, o));
        vmin = min_nan(vmin, __shfl_xor_sync(0xffffffffu, vmin, o));
        vmax = max_nan(vmax, __shfl_xor_sync(0xffffffffu, vmax, o));
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) {
        s_mm[0][warp] = umin;
        s_mm[1][warp] = umax;
        s_mm[2][warp] = vmin;
        s_mm[3][warp] = vmax;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int w = 1; w < kW; ++w) {
            umin = min_nan(umin, s_mm[0][w]);
            umax = max_nan(umax, s_mm[1][w]);
            vmin = min_nan(vmin, s_mm[2][w]);
            vmax = max_nan(vmax, s_mm[3][w]);
        }
        // (max - min) / wp as PyTorch divides by a host number
        s_par[0] = mul_rn(sub_rn(umax, umin), div_rn(1.0f, static_cast<float>(wp)));
        s_par[1] = mul_rn(sub_rn(vmax, vmin), div_rn(1.0f, static_cast<float>(hp)));
        s_par[2] = ssum[0] <= ssum[scols - 1] ? 1.0f : -1.0f;
        s_par[3] = ssum[ns] <= ssum[ns + (srows - 1) * scols] ? 1.0f : -1.0f;
        frame[9] = s_par[2];
        frame[10] = s_par[3];
        frame[11] = 0.0f;
    }
    __syncthreads();
    const float pu = s_par[0], pv = s_par[1];
    const bool fu = s_par[2] > 0.0f, fv = s_par[3] > 0.0f;
    float* col_hi = frame + kHead;
    float* col_lo = col_hi + scols;
    float* row_hi = col_lo + scols;
    float* row_lo = row_hi + srows;
    // the strips' rectangles (us = u * su: its min is -max u when su = -1),
    // reduced over each column and each row
    for (int j = threadIdx.x; j < scols; j += kOneBlock) {
        float hi = -INFINITY, lo = INFINITY;
        for (int i = 0; i < srows; ++i) {
            const int s = i * scols + j;
            hi = max_nan(hi, add_rn(fu ? smm[ns + s] : -smm[s], pu));
            lo = min_nan(lo, sub_rn(fu ? smm[s] : -smm[ns + s], pu));
        }
        col_hi[j] = hi;
        col_lo[j] = lo;
    }
    for (int i = threadIdx.x; i < srows; i += kOneBlock) {
        float hi = -INFINITY, lo = INFINITY;
        for (int j = 0; j < scols; ++j) {
            const int s = i * scols + j;
            hi = max_nan(hi, add_rn(fv ? smm[3 * ns + s] : -smm[2 * ns + s], pv));
            lo = min_nan(lo, sub_rn(fv ? smm[2 * ns + s] : -smm[3 * ns + s], pv));
        }
        row_hi[i] = hi;
        row_lo[i] = lo;
    }
    __syncthreads();
    // monotone: prefix max of the his, suffix min of the los
    if (threadIdx.x == 0) {
        for (int j = 1; j < scols; ++j) col_hi[j] = max_nan(col_hi[j - 1], col_hi[j]);
        for (int j = scols - 2; j >= 0; --j) col_lo[j] = min_nan(col_lo[j + 1], col_lo[j]);
    } else if (threadIdx.x == 32) {
        for (int i = 1; i < srows; ++i) row_hi[i] = max_nan(row_hi[i - 1], row_hi[i]);
        for (int i = srows - 2; i >= 0; --i) row_lo[i] = min_nan(row_lo[i + 1], row_lo[i]);
    }
}

// ---- triangles ----------------------------------------------------------

// One tier's `cap` slots of triangle `tri` from slot `base` (a multiple of
// 4): slot kk takes bin(kk) where `valid` and kk < `slots`, else the unused
// bin nbins.  Word slots (tris == nullptr) pack bin << 19 | tri, unused
// ones SENTINEL; otherwise keys get the bin and tris the triangle.
template <int Cap, bool Column>
__device__ __forceinline__ void emit(int* __restrict__ keys, int* __restrict__ tris,
                                     long long base, int tri, bool valid, int slots, int jmin,
                                     int jmax, int imin, int ns, int scols, int nbins) {
    const int ww = max(jmax - jmin + 1, 1);
    for (int k4 = 0; k4 < Cap; k4 += 4) {
        int key[4];
        for (int c = 0; c < 4; ++c) {
            const int kk = k4 + c;
            const bool ok = valid && kk < slots;
            const int bin = Column ? ns + jmin + kk : (imin + kk / ww) * scols + jmin + kk % ww;
            if (tris != nullptr)
                key[c] = ok ? bin : nbins;
            else
                key[c] = ok ? static_cast<int>((static_cast<unsigned>(bin) << kTriBits)
                                               | static_cast<unsigned>(tri))
                            : kSentinel;
        }
        reinterpret_cast<int4*>(keys + base)[k4 / 4] = make_int4(key[0], key[1], key[2], key[3]);
        if (tris != nullptr)
            reinterpret_cast<int4*>(tris + base)[k4 / 4] = make_int4(tri, tri, tri, tri);
    }
}

// info[i] = (jmin, jmax, imin, area); blk[b] = the block's (medium, wide)
// counts; the dense tier's slots 4i ... 4i + 3
__global__ void __launch_bounds__(kTriBlock)
tri_kernel(const float* __restrict__ v0, const float* __restrict__ e1,
           const float* __restrict__ e2, const float* __restrict__ origin,
           const float* __restrict__ frame, int t, int ns, int srows, int scols,
           int4* __restrict__ info, int2* __restrict__ blk, int* __restrict__ keys,
           int* __restrict__ tris) {
    extern __shared__ float s_fr[];
    const int nf = kHead + 2 * (scols + srows);
    for (int k = threadIdx.x; k < nf; k += kTriBlock) s_fr[k] = frame[k];
    __syncthreads();
    const float* f = s_fr;
    const float* ex = s_fr + 3;
    const float* ey = s_fr + 6;
    const float su = s_fr[9], sv = s_fr[10];
    const float* col_hi = s_fr + kHead;
    const float* col_lo = col_hi + scols;
    const float* row_hi = col_lo + scols;
    const float* row_lo = row_hi + srows;
    const int i = blockIdx.x * kTriBlock + threadIdx.x;
    int area = 0;
    if (i < t) {
        float vert[3][3], vz[3];
        bool front[3];
        for (int c = 0; c < 3; ++c) {
            const float p = v0[3LL * i + c], o = origin[c];
            vert[0][c] = sub_rn(p, o);
            vert[1][c] = sub_rn(add_rn(p, e1[3LL * i + c]), o);
            vert[2][c] = sub_rn(add_rn(p, e2[3LL * i + c]), o);
        }
        for (int k = 0; k < 3; ++k) {
            vz[k] = dot3_rn(vert[k][0], vert[k][1], vert[k][2], f);
            front[k] = vz[k] > kZeps;
        }
        const bool all_behind = !(front[0] || front[1] || front[2]);
        float ulo = kBig, uhi = -kBig, vlo = kBig, vhi = -kBig;
        // candidates: the 3 vertices (in front) and the 3 crossings of
        // z = ZEPS (where an edge straddles it), each as the plain version
        // computes it, then masked
        for (int k = 0; k < 6; ++k) {
            float cand[3];
            bool valid;
            if (k < 3) {
                for (int c = 0; c < 3; ++c) cand[c] = vert[k][c];
                valid = front[k];
            } else {
                const int a = k - 3, b = (a + 1) % 3;
                valid = front[a] != front[b];
                const float dz = sub_rn(vz[b], vz[a]);
                const float w = div_rn(sub_rn(kZeps, vz[a]), fabsf(dz) < 1e-20f ? 1e-20f : dz);
                for (int c = 0; c < 3; ++c)
                    cand[c] = add_rn(vert[a][c], mul_rn(w, sub_rn(vert[b][c], vert[a][c])));
            }
            const float cz = clamp_min_nan(dot3_rn(cand[0], cand[1], cand[2], f), kZeps);
            const float cu = mul_rn(div_rn(dot3_rn(cand[0], cand[1], cand[2], ex), cz), su);
            const float cv = mul_rn(div_rn(dot3_rn(cand[0], cand[1], cand[2], ey), cz), sv);
            ulo = min_nan(ulo, valid ? cu : kBig);
            uhi = max_nan(uhi, valid ? cu : -kBig);
            vlo = min_nan(vlo, valid ? cv : kBig);
            vhi = max_nan(vhi, valid ? cv : -kBig);
        }
        const int jmin = min(max(lower_bound(col_hi, scols, ulo), 0), scols - 1);
        const int jmax = upper_bound(col_lo, scols, uhi) - 1;
        const int imin = min(max(lower_bound(row_hi, srows, vlo), 0), srows - 1);
        const int imax = upper_bound(row_lo, srows, vhi) - 1;
        const int nw = max(jmax - jmin + 1, 0), nh = max(imax - imin + 1, 0);
        area = all_behind ? 0 : nw * nh;
        info[i] = make_int4(jmin, jmax, imin, area);
        emit<kKA, false>(keys, tris, static_cast<long long>(i) * kKA, i,
                         area >= 1 && area <= kKA, area, jmin, jmax, imin, ns, scols, ns + scols);
    }
    const int m0 = __syncthreads_count(area > kKA && area <= kKB);
    const int big = __syncthreads_count(area > kKB);
    if (threadIdx.x == 0) blk[blockIdx.x] = make_int2(m0, big);
}

// blkoff[b]: the (medium, wide) counts before block b; totals = count_m,
// count_c, start; n_col_total as a 0-d int64
__global__ void __launch_bounds__(kOneBlock)
scan_kernel(const int2* __restrict__ blk, int nblk, int t, int nb_med, int nb_col,
            int2* __restrict__ blkoff, int* __restrict__ totals,
            long long* __restrict__ n_col_total) {
    const int per = (nblk + kOneBlock - 1) / kOneBlock;
    const int b0 = min(threadIdx.x * per, nblk), b1 = min(b0 + per, nblk);
    int2 mine = make_int2(0, 0);
    for (int b = b0; b < b1; ++b) {
        mine.x += blk[b].x;
        mine.y += blk[b].y;
    }
    int2 all;
    int2 run = block_scan2(mine, &all);
    for (int b = b0; b < b1; ++b) {
        blkoff[b] = run;
        run.x += blk[b].x;
        run.y += blk[b].y;
    }
    if (threadIdx.x == 0) {
        const int count_m = min(all.x, nb_med);
        const int n_col = all.y + max(all.x - nb_med, 0);
        totals[0] = count_m;
        totals[1] = min(n_col, nb_col);
        totals[2] = min(count_m, t - nb_col);
        *n_col_total = n_col;
    }
}

// The medium and column tiers' slots: each triangle's rank in
// bin_triangles_plain's stable order picks the slots it fills
__global__ void __launch_bounds__(kTriBlock)
rank_kernel(const int4* __restrict__ info, const int2* __restrict__ blkoff,
            const int* __restrict__ totals, int t, int ns, int scols, int nb_med, int nb_col,
            int* __restrict__ keys, int* __restrict__ tris) {
    constexpr int kW = kTriBlock / 32;
    __shared__ int s_w[2][kW];
    const int i = blockIdx.x * kTriBlock + threadIdx.x;
    const int4 q = i < t ? info[i] : make_int4(0, 0, 0, 0);
    const int area = q.w;
    const bool m0 = area > kKA && area <= kKB, big = area > kKB;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned bm = __ballot_sync(0xffffffffu, m0), bb = __ballot_sync(0xffffffffu, big);
    const unsigned below = (1u << lane) - 1u;
    if (lane == 0) {
        s_w[0][warp] = __popc(bm);
        s_w[1][warp] = __popc(bb);
    }
    __syncthreads();
    if (i >= t) return;
    int pm0 = blkoff[blockIdx.x].x + __popc(bm & below);
    int pbig = blkoff[blockIdx.x].y + __popc(bb & below);
    for (int w = 0; w < warp; ++w) {
        pm0 += s_w[0][w];
        pbig += s_w[1][w];
    }
    const int count_m = totals[0], count_c = totals[1], start = totals[2];
    const bool is_m = m0 && pm0 < nb_med;
    const int pc0 = pbig + max(pm0 - nb_med, 0);
    const bool is_c = (big || (m0 && pm0 >= nb_med)) && pc0 < nb_col;
    const int pm = min(pm0, nb_med), pc = min(pc0, nb_col);
    const int rank = is_m ? pm : (is_c ? count_m + pc : count_m + count_c + (i - pm - pc));
    const int nbins = ns + scols;
    const long long base_m = static_cast<long long>(t) * kKA;
    if (rank < nb_med)
        emit<kKB, false>(keys, tris, base_m + static_cast<long long>(rank) * kKB, i, is_m, area,
                         q.x, q.y, q.z, ns, scols, nbins);
    if (rank >= start && rank < start + nb_col)
        emit<kKC, true>(keys, tris,
                        base_m + static_cast<long long>(nb_med) * kKB
                            + static_cast<long long>(rank - start) * kKC,
                        i, is_c, max(q.y - q.x + 1, 0), q.x, q.y, q.z, ns, scols, nbins);
}

// ---- segments and table -------------------------------------------------

__device__ __forceinline__ int bin_of(const int* sorted, long long k, bool words, int nbins) {
    const int w = sorted[k];
    if (!words) return w;
    return w == kSentinel ? nbins : (w >> kTriBits);
}

// bounds[b] (b = 0 ... nbins): the sorted slots in bins below b
__global__ void bounds_kernel(const int* __restrict__ sorted, long long n, int nbins, bool words,
                              int* __restrict__ bounds) {
    const long long k = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (k > n) return;
    const int prev = k == 0 ? -1 : bin_of(sorted, k - 1, words, nbins);
    const int cur = k == n ? nbins : bin_of(sorted, k, words, nbins);
    for (int b = prev + 1; b <= cur; ++b) bounds[b] = static_cast<int>(k);
}

// pad_off (nbins + 1): each bin's first table row (counts rounded up to
// SEGAL, summed); shift[b] = pad_off[b] - bounds[b]; scal (4, ns)
__global__ void __launch_bounds__(kOneBlock)
pad_kernel(const int* __restrict__ bounds, int nbins, int ns, int scols,
           int* __restrict__ pad_off, int* __restrict__ shift, int* __restrict__ scal) {
    const int per = (nbins + kOneBlock - 1) / kOneBlock;
    const int b0 = min(threadIdx.x * per, nbins), b1 = min(b0 + per, nbins);
    auto padded = [&](int b) {
        return (bounds[b + 1] - bounds[b] + kSegal - 1) / kSegal * kSegal;
    };
    int mine = 0;
    for (int b = b0; b < b1; ++b) mine += padded(b);
    int2 all;
    int run = block_scan2(make_int2(mine, 0), &all).x;
    for (int b = b0; b < b1; ++b) {
        pad_off[b] = run;
        shift[b] = run - bounds[b];
        run += padded(b);
    }
    if (threadIdx.x == 0) pad_off[nbins] = all.x;
    __syncthreads();
    for (int s = threadIdx.x; s < ns; s += kOneBlock) {
        const int col = ns + s % scols;
        scal[s] = pad_off[s];
        scal[ns + s] = (padded(s) + kGang - 1) / kGang;
        scal[2 * ns + s] = pad_off[col];
        scal[3 * ns + s] = (padded(col) + kGang - 1) / kGang;
    }
}

// table row r = isect[triangle of slot src], src = r - shift[b] clamped to
// the slots, b the last bin below nbins with pad_off[b] <= r (a padding row
// reads the next bin's slots, or unused ones)
__global__ void __launch_bounds__(kTableBlock)
table_kernel(const int* __restrict__ sorted, const long long* __restrict__ perm,
             const int* __restrict__ tris, long long slots_total,
             const int* __restrict__ pad_off, const int* __restrict__ shift, int nbins,
             const float4* __restrict__ isect, long long np_rows, float4* __restrict__ table) {
    const long long g = static_cast<long long>(blockIdx.x) * kTableBlock + threadIdx.x;
    const long long r = g >> 2;
    int tri = 0;
    if ((g & 3) == 0 && r < np_rows) {
        int lo = 0, hi = nbins;
        while (lo < hi) {
            const int mid = lo + ((hi - lo) >> 1);
            if (__ldg(pad_off + mid) <= r) lo = mid + 1; else hi = mid;
        }
        long long src = r - __ldg(shift + lo - 1);
        src = src < 0 ? 0 : (src > slots_total - 1 ? slots_total - 1 : src);
        if (perm != nullptr) {
            tri = tris[perm[src]];
        } else {
            const int w = sorted[src];
            tri = w == kSentinel ? 0 : (w & ((1 << kTriBits) - 1));
        }
    }
    tri = __shfl_sync(0xffffffffu, tri, threadIdx.x & 28);
    if (r < np_rows) table[g] = __ldg(isect + 4LL * tri + (g & 3));
}

}  // namespace

VCT_EXPORT int vct_bin_pack(const float* v0, const float* e1, const float* e2, const float* vn,
                            const float* vt, const float* vb, const float* vuv, const float* fn,
                            const int* mat, const float* origin, const float* albedo,
                            const float* specular, const float* shininess, int t, float* isect,
                            float* attrs, cudaStream_t stream) {
    pack_kernel<<<(t + kPackBlock - 1) / kPackBlock, kPackBlock, 0, stream>>>(
        v0, e1, e2, vn, vt, vb, vuv, fn, mat, origin, albedo, specular, shininess, t, isect,
        attrs);
    return launch_status();
}

// smm (4, ns) float, ssum (2, ns) double: scratch; frame: kHead + 2 *
// (scols + srows) floats
VCT_EXPORT int vct_bin_strips(const float* dirs, const float* fsum, const float* xsum, int ns,
                              int srows, int scols, int hp, int wp, float* smm, double* ssum,
                              float* frame, cudaStream_t stream) {
    strip_kernel<<<ns, kStripBlock, 0, stream>>>(dirs, fsum, xsum, ns, smm, ssum);
    int status = launch_status();
    if (status != 0) return status;
    envelope_kernel<<<1, kOneBlock, 0, stream>>>(fsum, xsum, smm, ssum, ns, srows, scols, hp, wp,
                                                 frame);
    return launch_status();
}

// info (t, 4), blk and blkoff (nblk, 2), totals (4): int32 scratch; keys
// (and tris where the slots sort stably, else null): the slots
VCT_EXPORT int vct_bin_tris(const float* v0, const float* e1, const float* e2,
                            const float* origin, const float* frame, int t, int ns, int srows,
                            int scols, int nb_med, int nb_col, int* info, int* blk, int* blkoff,
                            int* totals, long long* n_col_total, int* keys, int* tris,
                            cudaStream_t stream) {
    const int nblk = (t + kTriBlock - 1) / kTriBlock;
    const int smem = static_cast<int>(sizeof(float)) * (kHead + 2 * (scols + srows));
    tri_kernel<<<nblk, kTriBlock, smem, stream>>>(v0, e1, e2, origin, frame, t, ns, srows, scols,
                                                  reinterpret_cast<int4*>(info),
                                                  reinterpret_cast<int2*>(blk), keys, tris);
    int status = launch_status();
    if (status != 0) return status;
    scan_kernel<<<1, kOneBlock, 0, stream>>>(reinterpret_cast<const int2*>(blk), nblk, t, nb_med,
                                             nb_col, reinterpret_cast<int2*>(blkoff), totals,
                                             n_col_total);
    status = launch_status();
    if (status != 0) return status;
    rank_kernel<<<nblk, kTriBlock, 0, stream>>>(reinterpret_cast<const int4*>(info),
                                                reinterpret_cast<const int2*>(blkoff), totals, t,
                                                ns, scols, nb_med, nb_col, keys, tris);
    return launch_status();
}

// sorted: the sorted slot words (perm null) or the stably sorted bins with
// their permutation perm (int64) of the slots' triangles tris; bounds
// (nbins + 1), pad_off (nbins + 1), shift (nbins): int32 scratch
VCT_EXPORT int vct_bin_table(const int* sorted, const long long* perm, const int* tris,
                             long long slots_total, int nbins, int ns, int scols,
                             const float* isect, int* bounds, int* pad_off, int* shift,
                             int* scal, float* table, long long np_rows, cudaStream_t stream) {
    const bool words = perm == nullptr;
    const long long nb = (slots_total + 1 + kTableBlock - 1) / kTableBlock;
    bounds_kernel<<<static_cast<unsigned>(nb), kTableBlock, 0, stream>>>(sorted, slots_total,
                                                                          nbins, words, bounds);
    int status = launch_status();
    if (status != 0) return status;
    pad_kernel<<<1, kOneBlock, 0, stream>>>(bounds, nbins, ns, scols, pad_off, shift, scal);
    status = launch_status();
    if (status != 0) return status;
    const long long nt = (4 * np_rows + kTableBlock - 1) / kTableBlock;
    table_kernel<<<static_cast<unsigned>(nt), kTableBlock, 0, stream>>>(
        sorted, perm, tris, slots_total, pad_off, shift, nbins,
        reinterpret_cast<const float4*>(isect), np_rows, reinterpret_cast<float4*>(table));
    return launch_status();
}
