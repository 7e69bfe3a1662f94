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
// What bounds it: memory.  The G-buffer read (128 B a row, 3 columns
// used) and the 64 B output row per pixel; the texels come from the L2
// cache, since a tile's pixels share a material and a small uv box.  One
// thread per pixel: each of the 12 corners is one 16-byte load of the 8
// fused bf16 channels.  The TPU kernel DMA'd a 32x32-texel brick per tile
// and did the bilinear weights as two-hot matmuls on the MXU; the brick
// and its 16-aligned origins were for the DMA engine, and a cache-backed
// per-pixel gather needs neither.  The pages keep the JAX package's
// layout (wrap rows and columns baked in), so corner j0 + 1 <= R_l never
// needs a second wrap.
//
// Weights are float32 on the bf16 texels, as material_tiles_ref computes
// them (the TPU kernel rounds its weights to bf16), and every multiply and
// add rounds on its own, so the kernel equals the plain version.
#include "common.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kTile = 256;
constexpr int kC = 8;               // fused channels
constexpr int kNscal = 5, kNwords = 128;
constexpr int kOut = 16;

__device__ __forceinline__ void load8(const __nv_bfloat16* texel, float* v) {
    const uint4 w = *reinterpret_cast<const uint4*>(texel);
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

// bilinear fetch of all 8 channels at texel coordinates (tu, tv) of a
// level page (row stride v0 texels), REPEAT wrap over rl texels
__device__ void bilinear(const __nv_bfloat16* page, int v0, int rl, float tu, float tv,
                         float* out) {
    const float i0f = floorf(tu), j0f = floorf(tv);
    const float fu = sub_rn(tu, i0f), fv = sub_rn(tv, j0f);
    const int i0 = static_cast<int>(i0f) & (rl - 1);
    const int j0 = static_cast<int>(j0f) & (rl - 1);
    float t00[kC], t01[kC], t10[kC], t11[kC];
    load8(page + (static_cast<long long>(j0) * v0 + i0) * kC, t00);
    load8(page + (static_cast<long long>(j0) * v0 + i0 + 1) * kC, t01);
    load8(page + (static_cast<long long>(j0 + 1) * v0 + i0) * kC, t10);
    load8(page + (static_cast<long long>(j0 + 1) * v0 + i0 + 1) * kC, t11);
#pragma unroll
    for (int c = 0; c < kC; ++c)
        out[c] = lerp_rn(lerp_rn(t00[c], t01[c], fu), lerp_rn(t10[c], t11[c], fu), fv);
}

__global__ void __launch_bounds__(kBlock)
material_kernel(const float* __restrict__ gbuf, int n, int gcols,
                const int* __restrict__ slots, const int* __restrict__ mscal,
                const int* __restrict__ mlists, const __nv_bfloat16* __restrict__ pages,
                int num_materials, int rows_per_mat, int res, int v0, int nlev,
                float* __restrict__ out) {
    const int p = blockIdx.x * kBlock + threadIdx.x;
    if (p >= n) return;
    const int tile = p / kTile;
    const int cnt = mscal[tile * kNscal];
    const int s = slots[p];
    const int* e = s == 0 ? mscal + tile * kNscal + 1 : mlists + tile * kNwords + 4 * (s - 1);
    const int mt = e[0], lvl = e[1];
    float o[kOut];
#pragma unroll
    for (int i = 0; i < kOut; ++i) o[i] = 0.0f;
    if (cnt > 0 && lvl >= 0 && lvl < nlev && mt >= 0 && mt < num_materials) {
        const float* g = gbuf + static_cast<long long>(p) * gcols;
        const int rli = max(res >> lvl, 1);
        const float rl = static_cast<float>(rli);
        const float d = ldexpf(1.0f, -lvl);
        const float tu = sub_rn(mul_rn(g[15], rl), 0.5f);
        const float tv = sub_rn(mul_rn(sub_rn(1.0f, g[16]), rl), 0.5f);
        const __nv_bfloat16* page =
            pages + (static_cast<long long>(mt) * rows_per_mat + static_cast<long long>(lvl) * v0)
                        * v0 * kC;
        float tap[kC];
        bilinear(page, v0, rli, tu, tv, o);
        bilinear(page, v0, rli, add_rn(tu, d), tv, tap);
        o[kC] = tap[kC - 1];
        bilinear(page, v0, rli, tu, sub_rn(tv, d), tap);
        o[kC + 1] = tap[kC - 1];
    }
    float4* dst = reinterpret_cast<float4*>(out + static_cast<long long>(p) * kOut);
#pragma unroll
    for (int i = 0; i < kOut / 4; ++i)
        dst[i] = make_float4(o[4 * i], o[4 * i + 1], o[4 * i + 2], o[4 * i + 3]);
}

}  // namespace

VCT_EXPORT int vct_material(const float* gbuf, int n, int gcols, const int* slots,
                            const int* mscal, const int* mlists, const void* pages,
                            int num_materials, int rows_per_mat, int res, float* out,
                            cudaStream_t stream) {
    const int v0 = (res + 32 + 15) / 16 * 16;
    int nlev = 0;
    while ((1 << nlev) <= res) ++nlev;
    const int blocks = (n + kBlock - 1) / kBlock;
    material_kernel<<<blocks, kBlock, 0, stream>>>(
        gbuf, n, gcols, slots, mscal, mlists, static_cast<const __nv_bfloat16*>(pages),
        num_materials, rows_per_mat, res, v0, nlev, out);
    return launch_status();
}
