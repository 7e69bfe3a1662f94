// Per-pixel material fetch from the packed atlas mip pages: replaces
// vct_tpu/ops/material_pallas.py material_tiles (_material_kernel), with
// the function of its reference material_tiles_ref.
//
// What it computes: for pixel p of tile p/256, its slot's entry (slot 0
// from mscal, slots 1.. from the tile's mlists row: material, level, bv,
// bu), then three bilinear REPEAT-wrapped fetches of that material's
// level-l page -- the fused 8 channels [albedo rgba | specular rgb |
// height] at the pixel's uv, and the height channel one level-0 texel
// along +u and along -v (CalcBumpNormal's taps) -- into the 16-float row
// [albedo4, spec3, h0, hx, hy, 0 x 6].  Pixels of tiles with no material
// are zero.
//
// What bounds it: memory.  The G-buffer read, the slot and the 64-byte
// output row; the texels come from the caches, since a tile's pixels
// share a material and a small uv box.  Columns 15-16 lie in two 32-byte
// sectors of the 128-byte row but in both of its 64-byte halves, and the
// card reads memory in 64-byte pieces (chip_smoke's G-buffer read probe:
// those two columns cost as much as the whole row), so the floor is
// reading every row whole and writing the output.  Design: one block of
// 256 threads per tile.  Each thread loads its slot and uv while the
// block stages the tile's mscal row and the used 92 words of its mlists
// row in shared memory, so a pixel's chain of dependent loads is slot
// (with the entries beside it), then texels.  The main tap loads its 4
// corners as one 16-byte load of the 8 fused bf16 channels each; the +u
// and -v taps need only the height of theirs, and each of their corners
// whose texel (row and column modulo the level's width: the pages bake
// the wrap in, so one texel sits at two addresses) is a main corner's
// takes that corner's height instead of a load -- a runtime comparison,
// so it holds where rounding at |tu| near 2^24 moves a tap two texels.
// Of the 8 heights the bump taps need, only their new column (+u) and
// row (-v) are loaded, 2 bytes each.  The output row leaves as four
// 16-byte stores (staged through shared memory and written in full lines
// it measured no faster).  The TPU kernel DMA'd a 32x32-texel brick per
// tile and did the bilinear weights as two-hot matmuls on the MXU; the
// brick and its 16-aligned origins were for the DMA engine, and a
// cache-backed per-pixel gather needs neither.  Corner j0 + 1 <= R_l
// never needs a second wrap.
//
// Weights are float32 on the bf16 texels, as material_tiles_ref computes
// them (the TPU kernel rounds its weights to bf16), every multiply and add
// rounds on its own, and the lerps keep the plain version's order (across
// u, then v), so the kernel equals the plain version.
#include "common.cuh"

namespace {

constexpr int kTile = 256;
constexpr int kC = 8;               // fused channels
constexpr int kNscal = 5, kNwords = 128;
constexpr int kNslot = 24;
constexpr int kNent = kNscal + 4 * (kNslot - 1);   // staged words: count, 24 slots
constexpr int kOut = 16;

__device__ __forceinline__ void unpack8(uint4 w, float* v) {
    const unsigned parts[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        v[2 * i] = __uint_as_float(parts[i] << 16);
        v[2 * i + 1] = __uint_as_float(parts[i] & 0xffff0000u);
    }
}

__device__ __forceinline__ float lerp_rn(float a, float b, float f) {
    return add_rn(mul_rn(a, sub_rn(1.0f, f)), mul_rn(b, f));
}

__device__ __forceinline__ float bilerp(float t00, float t01, float t10, float t11, float fu,
                                        float fv) {
    return lerp_rn(lerp_rn(t00, t01, fu), lerp_rn(t10, t11, fu), fv);
}

// texel (row j, column i) of a level page with row stride v0 texels
__device__ __forceinline__ const __nv_bfloat16* texel(const __nv_bfloat16* page, int v0,
                                                      int j, int i) {
    return page + (static_cast<long long>(j) * v0 + i) * kC;
}

__device__ __forceinline__ uint4 load_texel(const __nv_bfloat16* page, int v0, int j, int i) {
    return __ldg(reinterpret_cast<const uint4*>(texel(page, v0, j, i)));
}

// the height channel (the 8th bf16) of a texel, as float
__device__ __forceinline__ float load_height(const __nv_bfloat16* page, int v0, int j, int i) {
    const unsigned short h =
        __ldg(reinterpret_cast<const unsigned short*>(texel(page, v0, j, i)) + kC - 1);
    return __uint_as_float(static_cast<unsigned>(h) << 16);
}

__global__ void __launch_bounds__(kTile)
material_kernel(const float* __restrict__ gbuf, int gcols,
                const int* __restrict__ slots, const int* __restrict__ mscal,
                const int* __restrict__ mlists, const __nv_bfloat16* __restrict__ pages,
                int num_materials, int rows_per_mat, int res, int v0, int nlev,
                float* __restrict__ out) {
    __shared__ int ent[kNent];                         // count, then slot s at 1 + 4s
    const int tile = blockIdx.x, t = threadIdx.x;
    const long long p = static_cast<long long>(tile) * kTile + t;
    const float* g = gbuf + p * gcols;
    const float u = __ldg(g + 15), v = __ldg(g + 16);
    // slots come from the prepass, 0..NSLOT-1
    const int s = min(max(__ldg(slots + p), 0), kNslot - 1);
    if (t < kNscal)
        ent[t] = __ldg(mscal + tile * kNscal + t);
    else if (t < kNent)
        ent[t] = __ldg(mlists + static_cast<long long>(tile) * kNwords + t - kNscal);
    __syncthreads();
    const int cnt = ent[0], mt = ent[1 + 4 * s], lvl = ent[2 + 4 * s];
    float o[kOut];
#pragma unroll
    for (int i = 0; i < kOut; ++i) o[i] = 0.0f;
    if (cnt > 0 && lvl >= 0 && lvl < nlev && mt >= 0 && mt < num_materials) {
        const int rli = max(res >> lvl, 1), wrap = rli - 1;
        const float rl = static_cast<float>(rli);
        const float d = ldexpf(1.0f, -lvl);
        const float tu = sub_rn(mul_rn(u, rl), 0.5f);
        const float tv = sub_rn(mul_rn(sub_rn(1.0f, v), rl), 0.5f);
        const __nv_bfloat16* page =
            pages + (static_cast<long long>(mt) * rows_per_mat + static_cast<long long>(lvl) * v0)
                        * v0 * kC;
        // main tap at (tu, tv), +u tap at (tu + d, tv), -v tap at (tu, tv - d)
        const float i0f = floorf(tu), j0f = floorf(tv);
        const float tux = add_rn(tu, d), tvy = sub_rn(tv, d);
        const float iuf = floorf(tux), jvf = floorf(tvy);
        const float fu = sub_rn(tu, i0f), fv = sub_rn(tv, j0f);
        const float fux = sub_rn(tux, iuf), fvy = sub_rn(tvy, jvf);
        const int i0 = static_cast<int>(i0f) & wrap, j0 = static_cast<int>(j0f) & wrap;
        const int iu = static_cast<int>(iuf) & wrap, jv = static_cast<int>(jvf) & wrap;
        float t00[kC], t01[kC], t10[kC], t11[kC];
        unpack8(load_texel(page, v0, j0, i0), t00);
        unpack8(load_texel(page, v0, j0, i0 + 1), t01);
        unpack8(load_texel(page, v0, j0 + 1, i0), t10);
        unpack8(load_texel(page, v0, j0 + 1, i0 + 1), t11);
        // the main corners' texels: columns c0, c1 and rows r0, r1 (mod rl),
        // and their heights
        const int c0 = i0, c1 = (i0 + 1) & wrap, r0 = j0, r1 = (j0 + 1) & wrap;
        const float h00 = t00[kC - 1], h01 = t01[kC - 1];
        const float h10 = t10[kC - 1], h11 = t11[kC - 1];
        // +u tap: rows j0, j0 + 1 as the main tap's; columns iu, iu + 1
        float hx[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int col = iu + (k & 1), key = col & wrap;
            hx[k] = key == c0 ? (k < 2 ? h00 : h10)
                  : key == c1 ? (k < 2 ? h01 : h11)
                  : load_height(page, v0, j0 + (k >> 1), col);
        }
        // -v tap: columns i0, i0 + 1 as the main tap's; rows jv, jv + 1
        float hy[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int row = jv + (k >> 1), key = row & wrap;
            hy[k] = key == r0 ? (k & 1 ? h01 : h00)
                  : key == r1 ? (k & 1 ? h11 : h10)
                  : load_height(page, v0, row, i0 + (k & 1));
        }
#pragma unroll
        for (int c = 0; c < kC; ++c) o[c] = bilerp(t00[c], t01[c], t10[c], t11[c], fu, fv);
        o[kC] = bilerp(hx[0], hx[1], hx[2], hx[3], fux, fv);
        o[kC + 1] = bilerp(hy[0], hy[1], hy[2], hy[3], fu, fvy);
    }
    float4* dst = reinterpret_cast<float4*>(out + p * kOut);
#pragma unroll
    for (int c = 0; c < kOut / 4; ++c)
        dst[c] = make_float4(o[4 * c], o[4 * c + 1], o[4 * c + 2], o[4 * c + 3]);
}

}  // namespace

VCT_EXPORT int vct_material(const float* gbuf, int n, int gcols, const int* slots,
                            const int* mscal, const int* mlists, const void* pages,
                            int num_materials, int rows_per_mat, int res, float* out,
                            cudaStream_t stream) {
    const int v0 = (res + 32 + 15) / 16 * 16;
    int nlev = 0;
    while ((1 << nlev) <= res) ++nlev;
    material_kernel<<<n / kTile, kTile, 0, stream>>>(
        gbuf, gcols, slots, mscal, mlists, static_cast<const __nv_bfloat16*>(pages),
        num_materials, rows_per_mat, res, v0, nlev, out);
    return launch_status();
}

// the kernel's report (common.cuh occupancy_info)
VCT_EXPORT int vct_material_occupancy(int* info) {
    return occupancy_info(material_kernel, kTile, 0, info);
}
