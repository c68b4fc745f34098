// The one-pass skinning forward, skin_fwd_kernel<kSides>: K3f (kSides = 1,
// csrc/skin.cu) and K2's pair mode (kSides = 2, csrc/v2v.cu) are one
// template. For every batch row b and vertex v of a side,
//   vph[k]  = sum_p pf[b,p] posedirs_t[p,k,v] + v_shaped_t[k,v],  vph[3] = 1
//   M[l]    = sum_j A[b,j,l] W_t[j,v]                     (l = i*4 + k)
//   vert[i] = M[4i+3] + sum_k M[4i+k] vph[k]
// K3f writes verts (B,3,V). The pair mode skins the orig side (pf0, A0) and
// the rec side (pf1, A1), writes sign(rec - orig) (B,3,V), on request the
// orig side's vp (B,3,V), and one sum of |rec - orig| a block.
//
// The design:
//   - A block holds 32 side-rows: 32 batch rows of one side (K3f), or 16
//     rows of both sides (the pair mode; 32 rows of both would need at
//     least 251 KB of shared memory with vph double-buffered, over the 227
//     KB a block may have). Grid: batch tiles x R vertex ranges (fwd_ranges); a block
//     loops over the 16-vertex tiles of its range.
//   - For the whole range, shared memory holds pf of the block's side-rows,
//     split once into TF32 big and small parts, and all 12 components of A,
//     [row][component][joint], so the blend reads A as float4 over 4 joints
//     and no A load goes to L2 inside the tile loop.
//   - Three warp groups of 4 warps. The copy group stages each tile's
//     posedirs slice by cp.async, double-buffered. The tensor-core group
//     computes vph (32 x 48) = pf (32 x 208) . pd (208 x 48) on mma.sync
//     m16n8k8 TF32 in 3xTF32, the feature axis padded to 208 by a zero row
//     and split between two pairs of warps, each writing its half. The
//     CUDA-core group stages W and v_shaped by cp.async, double-buffered,
//     blends M = A . W (a thread one side-row and 4 vertices, so one float4
//     of A serves 4 vertices), computes the vertices and stores them. vph
//     is double-buffered too: the copy group stages tile t + 2 while the
//     tensor-core group computes tile t + 1 and the CUDA-core group blends
//     tile t, the groups handing the buffers over by named barriers
//     (bar.arrive / bar.sync). A group of its own for the copies keeps the
//     cp.async issue, which stalls while earlier copies are in flight, off
//     the tensor-core warps. One tile's copies in flight at a time: two ran
//     slower on the H100, as did 64-row blocks with posedirs staged through
//     a ring of 32-feature chunks (PERF.md, PR 10).
//   - Stores: a thread writes its 4 vertices of a (row, coordinate) as one
//     16-byte store where V and the address allow it, else two of 8 bytes
//     (V even) or four of 4. In the pair mode the orig and rec lanes of a
//     (row, vertices) sit 16 lanes apart and swap their vertices by
//     shuffle; the orig lane writes the sign and vp. Each block writes its
//     |diff| sum (fixed order) and total_kernel sums the partials in index
//     order: no atomics, repeated runs are bit-identical.
// Ragged B and V are masked everywhere; there are no padded tables.
//
// bf16 tables (skin_fwd_kernel<kSides, bf16>, skin_common.cuh has the
// arithmetic): pf is rounded to bf16 and packed two features a word once,
// A rounded to bf16 as it is staged; the tensor-core group runs vph on
// mma.sync m16n8k16 in one pass, its two pairs of warps splitting the
// features at 112; the blend reads W as bf16 and widens it; the pair mode
// stores vp in bf16. The groups, barriers and buffers are the f32 kernel's.
//
// bf16 vertices (skin_fwd_kernel<1, T, bf16>, the JAX package's
// NEMO_TPU_SKIN_IO_BF16, for either table type): the f32 vertices are
// rounded to nearest even as they are stored (acc.astype(out_ref.dtype) in
// _fwd_kernel), 8, 4 or 2 bytes a store (store4); nothing else changes, so
// they are the f32-output kernel's vertices rounded.

#pragma once

#include <climits>

#include "skin_common.cuh"

namespace {

constexpr int kXG = 128;           // threads a warp group (4 warps)
constexpr int kXT = 3 * kXG;       // threads a block: three groups
constexpr int kXR = kFB;           // side-rows a block
constexpr int kXPH = kPP / 2;      // the features of each half of the MMA
// A rows: 12 components x 24 joints, stride 292 (4 mod 32) so the 8 rows a
// warp reads fall on distinct banks; the second 16 side-rows 16 floats
// further, so the two sides of a pair-mode warp do too
constexpr int kXSA = kL * kJ + 4;
__device__ __forceinline__ int a_row(int sr) { return sr * kXSA + (sr >> 4) * 16; }

// named barriers (0 is __syncthreads); each hands a buffer from one group
// to another, so 2 kXG threads take part, except kBarBlend
constexpr int kBarBlend = 1;    // the CUDA-core group alone (kXG)
constexpr int kBarFull = 2;     // 2, 3: vph buffer 0, 1 written
constexpr int kBarEmpty = 4;    // 4, 5: vph buffer 0, 1 read
constexpr int kBarPdFull = 6;   // 6, 7: posedirs buffer 0, 1 staged
constexpr int kBarPdEmpty = 8;  // 8, 9: posedirs buffer 0, 1 read

// shared memory, in floats
constexpr int kXOffPd = 0;                          // [2][kPP][kSD]
constexpr int kXOffPfb = kXOffPd + 2 * kPP * kSD;   // [kXR][kSF] TF32 big
constexpr int kXOffPfs = kXOffPfb + kXR * kSF;      // [kXR][kSF] TF32 small
constexpr int kXOffA = kXOffPfs + kXR * kSF;        // a_row(kXR)
constexpr int kXOffW = kXOffA + kXR * kXSA + 16;    // [2][kJ][kFV]
constexpr int kXOffVs = kXOffW + 2 * kJ * kFV;      // [2][3][kFV]
constexpr int kXOffVph = kXOffVs + 2 * 3 * kFV;     // [2 buffers][2 halves][kXR][kSX]
constexpr int kXOffRed = kXOffVph + 4 * kXR * kSX;  // [4]
constexpr int kXSmemFloats = kXOffRed + 4;
constexpr size_t kXSmemBytes = sizeof(float) * kXSmemFloats;
static_assert(kXOffPfb % 4 == 0 && kXOffA % 4 == 0 && kXOffW % 4 == 0 &&
                  kXOffVs % 4 == 0 && kXOffVph % 4 == 0 && kXOffRed % 4 == 0,
              "float4 views of shared memory need 16-byte offsets");
static_assert(kXSmemBytes <= 232448, "a block may have 227 KB");

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// vph (both 16-row m-tiles, 3 n-tiles from fn0) = pf . pd over the features
// [k_begin, k_end) on the tensor cores, pf already split (s_pfb, s_pfs),
// written to out (rows of kSX).
__device__ __forceinline__ void vph_mma_split(const uint32_t* s_pfb,
                                              const uint32_t* s_pfs,
                                              const float* s_pd, float* out,
                                              int fn0, int k_begin, int k_end,
                                              int gid, int tig) {
  float lo[2][3][4], hi[2][3][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 3; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) { lo[m][n][i] = 0.f; hi[m][n][i] = 0.f; }
#pragma unroll 2
  for (int k0 = k_begin; k0 < k_end; k0 += 8) {
    uint32_t ab[2][4], as[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int o = (16 * m + gid) * kSF + k0 + tig;
      ab[m][0] = s_pfb[o]; ab[m][1] = s_pfb[o + 8 * kSF];
      ab[m][2] = s_pfb[o + 4]; ab[m][3] = s_pfb[o + 8 * kSF + 4];
      as[m][0] = s_pfs[o]; as[m][1] = s_pfs[o + 8 * kSF];
      as[m][2] = s_pfs[o + 4]; as[m][3] = s_pfs[o + 8 * kSF + 4];
    }
#pragma unroll
    for (int n = 0; n < 3; ++n) {
      const int o = (k0 + tig) * kSD + 8 * (fn0 + n) + gid;
      uint32_t bb[2], bs[2];
      split_tf32(s_pd[o], bb[0], bs[0]);
      split_tf32(s_pd[o + 4 * kSD], bb[1], bs[1]);
#pragma unroll
      for (int m = 0; m < 2; ++m)
        mma_3xtf32(lo[m][n], hi[m][n], ab[m], as[m], bb, bs);
    }
  }
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 3; ++n) {
      float* o = out + (16 * m + gid) * kSX + 8 * (fn0 + n) + 2 * tig;
      *reinterpret_cast<float2*>(o) =
          make_float2(lo[m][n][0] + hi[m][n][0], lo[m][n][1] + hi[m][n][1]);
      *reinterpret_cast<float2*>(o + 8 * kSX) =
          make_float2(lo[m][n][2] + hi[m][n][2], lo[m][n][3] + hi[m][n][3]);
    }
}

// Store the first nv (<= 4) of x at dst: four elements at once (ow = 4),
// two (ow = 2) or one at a time; in f32 16-, 8- or 4-byte stores.
__device__ __forceinline__ void store4(float* dst, const float x[4], int nv,
                                       int ow) {
  if (nv >= 4 && ow == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
  } else if (ow >= 2) {
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      if (e + 1 < nv) *reinterpret_cast<float2*>(dst + e) = make_float2(x[e], x[e + 1]);
      else if (e < nv) dst[e] = x[e];
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < nv) dst[e] = x[e];
  }
}

// The same in bf16 (rounded to nearest even): 8-, 4- or 2-byte stores.
__device__ __forceinline__ void store4(bf16* dst, const float x[4], int nv,
                                       int ow) {
  if (nv >= 4 && ow == 4) {
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]));
  } else if (ow >= 2) {
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      if (e + 1 < nv) *reinterpret_cast<uint32_t*>(dst + e) = pack_bf16(x[e], x[e + 1]);
      else if (e < nv) dst[e] = __float2bfloat16_rn(x[e]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < nv) dst[e] = __float2bfloat16_rn(x[e]);
  }
}

// kSides 1: out = verts (in TO: f32, or bf16 rounded to nearest even).
// kSides 2: out = sign (TO = f32), vp_out = vp (or null; in the table type
// T), tot_part[bt * R + r] = the block's |diff| sum. ow: the store width
// (store4). Launched with kXT threads and kXSmemBytes of shared memory.
template <int kSides, typename T, typename TO = float>
__global__ void __launch_bounds__(kXT, 1)
skin_fwd_kernel(int B, int V, int R, int ow, const float* __restrict__ pf0,
                const float* __restrict__ A0, const float* __restrict__ pf1,
                const float* __restrict__ A1, const float* __restrict__ vsh,
                const T* __restrict__ pd, const T* __restrict__ W,
                TO* __restrict__ out, T* __restrict__ vp_out,
                float* __restrict__ tot_part) {
  constexpr int kRows = kXR / kSides;  // batch rows a block
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r = blockIdx.x, bt = blockIdx.y, b0 = bt * kRows;
  int t_begin, t_end;
  range_tiles(r, R, V, t_begin, t_end);
  const int n_t = t_end - t_begin;
  const int group = warp >> 2;  // 0 tensor cores, 1 CUDA cores, 2 copies

  uint32_t* s_pfb = reinterpret_cast<uint32_t*>(smem + kXOffPfb);
  uint32_t* s_pfs = reinterpret_cast<uint32_t*>(smem + kXOffPfs);
  float* s_A = smem + kXOffA;
  float* s_vph = smem + kXOffVph;
  const auto s_pd = [&](int buf) {
    return reinterpret_cast<T*>(smem + kXOffPd) + buf * kPP * kSD;
  };
  const auto s_w = [&](int buf) {
    return reinterpret_cast<T*>(smem + kXOffW) + buf * kJ * kFV;
  };
  const auto s_vs = [&](int buf) { return smem + kXOffVs + buf * 3 * kFV; };
  const auto vph = [&](int buf, int half) {
    return s_vph + (2 * buf + half) * kXR * kSX;
  };
  // the copy group stages posedirs, the CUDA-core group W and v_shaped
  const auto load = [&](int buf, int t) {
    const int gt = tid - group * kXG;
    if (group == 2) {
      if (V & 1) load_pd_slice<1>(s_pd(buf), t, V, pd, gt, kXG);
      else       load_pd_slice<2>(s_pd(buf), t, V, pd, gt, kXG);
    } else {
      if (V & 1) load_w_slice<1, kFV>(s_w(buf), s_vs(buf), t, V, vsh, W, gt, kXG);
      else       load_w_slice<2, kFV>(s_w(buf), s_vs(buf), t, V, vsh, W, gt, kXG);
    }
  };
  if (group == 1) {
    load(0, t_begin);
    cp_async_commit();
  }
  // pf of the side-rows (side-row sr: side sr / kRows, row sr % kRows),
  // split into TF32 parts (bf16 tables: rounded to bf16, two features a
  // word, in s_pfb); feature 207 is the zero row
  if constexpr (kIsBf16<T>) {
    stage_pf_bf16(s_pfb, kXR, B,
                  [&](int sr) { return sr < kRows ? pf0 : pf1; },
                  [&](int sr) { return b0 + sr % kRows; }, tid, kXT);
  } else {
    for (int e = tid; e < kXR * kPP; e += kXT) {
      const int sr = e / kPP, p = e % kPP, b = b0 + sr % kRows;
      const float* pf = sr < kRows ? pf0 : pf1;
      const float x = (b < B && p < kP) ? pf[(size_t)b * kP + p] : 0.f;
      split_tf32(x, s_pfb[sr * kSF + p], s_pfs[sr * kSF + p]);
    }
  }
  // A: s_A[a_row(sr) + l * kJ + j] = A[b, j, l] (bf16 tables: rounded)
  for (int e = tid; e < kXR * kJ * 3; e += kXT) {
    const int sr = e / (3 * kJ), c4 = e % (3 * kJ), j = c4 / 3, q = c4 % 3;
    const int b = b0 + sr % kRows;
    const float* A = sr < kRows ? A0 : A1;
    const float4 x = b < B ? __ldg(reinterpret_cast<const float4*>(
                                 A + (size_t)b * kGL) + c4)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    float* d = s_A + a_row(sr) + 4 * q * kJ + j;
    d[0] = rnd<T>(x.x); d[kJ] = rnd<T>(x.y); d[2 * kJ] = rnd<T>(x.z);
    d[3 * kJ] = rnd<T>(x.w);
  }
  __syncthreads();

  if (group == 2) {
    // the copy group: tile i's posedirs slice into buffer i & 1 once the
    // tensor-core group has read tile i - 2 from it
    for (int i = 0; i < n_t; ++i) {
      const int buf = i & 1;
      if (i >= 2) bar_sync(kBarPdEmpty + buf, 2 * kXG);
      load(buf, t_begin + i);
      cp_async_commit();
      cp_async_wait<0>();
      bar_arrive(kBarPdFull + buf, 2 * kXG);
    }
    return;
  }
  if (group == 0) {
    // the tensor-core group: warp -> one half of the feature axis, 3 of
    // the 6 n-tiles, both m-tiles
    const int kh = warp >> 1, fn0 = 3 * (warp & 1);
    for (int i = 0; i < n_t; ++i) {
      const int buf = i & 1;
      bar_sync(kBarPdFull + buf, 2 * kXG);
      if (i >= 2) bar_sync(kBarEmpty + buf, 2 * kXG);  // tile i - 2 blended
      if constexpr (kIsBf16<T>)
        vph_mma_bf16<2>(s_pfb, s_pd(buf), vph(buf, kh), 0, fn0,
                        kh * kPHalf<T>, kh ? kPP : kPHalf<T>, lane >> 2,
                        lane & 3);
      else
        vph_mma_split(s_pfb, s_pfs, s_pd(buf), vph(buf, kh), fn0, kh * kXPH,
                      (kh + 1) * kXPH, lane >> 2, lane & 3);
      if (i + 2 < n_t) bar_arrive(kBarPdEmpty + buf, 2 * kXG);
      bar_arrive(kBarFull + buf, 2 * kXG);
    }
    return;
  }

  // the CUDA-core group: a thread one side-row, 4 neighbouring vertices; in
  // the pair mode lanes 0-15 the orig side, 16-31 the rec side
  const int cw = warp - 4;
  constexpr int kSideLanes = 32 / kSides;
  const int side = lane / kSideLanes;
  const int row = cw * (8 / kSides) + (lane % kSideLanes) / 4;
  const int sr = side * kRows + row, vg = 4 * (lane & 3), b = b0 + row;
  const float* a = s_A + a_row(sr);
  float local = 0.f;
  for (int i = 0; i < n_t; ++i) {
    const int buf = i & 1, v = (t_begin + i) * kFV + vg;
    cp_async_wait<0>();
    bar_sync(kBarBlend, kXG);  // W, v_shaped of tile i in; buffer buf ^ 1 free
    if (i + 1 < n_t) load(buf ^ 1, t_begin + i + 1);
    cp_async_commit();

    // M = A . W, 4 vertices, while the tensor-core group computes vph
    float m[4][kL];
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int l = 0; l < kL; ++l) m[e][l] = 0.f;
    const T* w = s_w(buf) + vg;
#pragma unroll 2
    for (int j0 = 0; j0 < kJ; j0 += 4) {
      float4 wj[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) wj[jj] = ld4(w + (j0 + jj) * kFV);
#pragma unroll
      for (int l = 0; l < kL; ++l) {
        const float4 x = *reinterpret_cast<const float4*>(a + l * kJ + j0);
        m[0][l] += x.x * wj[0].x; m[1][l] += x.x * wj[0].y;
        m[2][l] += x.x * wj[0].z; m[3][l] += x.x * wj[0].w;
        m[0][l] += x.y * wj[1].x; m[1][l] += x.y * wj[1].y;
        m[2][l] += x.y * wj[1].z; m[3][l] += x.y * wj[1].w;
        m[0][l] += x.z * wj[2].x; m[1][l] += x.z * wj[2].y;
        m[2][l] += x.z * wj[2].z; m[3][l] += x.z * wj[2].w;
        m[0][l] += x.w * wj[3].x; m[1][l] += x.w * wj[3].y;
        m[2][l] += x.w * wj[3].z; m[3][l] += x.w * wj[3].w;
      }
    }

    // vp = the two halves of vph + v_shaped
    bar_sync(kBarFull + buf, 2 * kXG);
    float vp[3][4];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int o = sr * kSX + k * kFV + vg;
      const float4 h0 = *reinterpret_cast<const float4*>(vph(buf, 0) + o);
      const float4 h1 = *reinterpret_cast<const float4*>(vph(buf, 1) + o);
      const float4 s = *reinterpret_cast<const float4*>(s_vs(buf) + k * kFV + vg);
      vp[k][0] = h0.x + h1.x + s.x; vp[k][1] = h0.y + h1.y + s.y;
      vp[k][2] = h0.z + h1.z + s.z; vp[k][3] = h0.w + h1.w + s.w;
    }
    if (i + 2 < n_t) bar_arrive(kBarEmpty + buf, 2 * kXG);

    float vert[3][4];
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float o = m[e][4 * c + 3];
#pragma unroll
        for (int k = 0; k < 3; ++k) o += m[e][4 * c + k] * vp[k][e];
        vert[c][e] = o;
      }
    const int nv = b < B ? V - v : 0;
    if (kSides == 1) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        store4(out + ((size_t)b * 3 + c) * V + v, vert[c], nv, ow);
    } else {
      float sg[3][4];
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float other = __shfl_xor_sync(0xffffffffu, vert[c][e], 16);
          const float diff = side ? vert[c][e] - other : other - vert[c][e];
          if (side == 0 && e < nv) local += fabsf(diff);
          sg[c][e] = (float)(diff > 0.f) - (float)(diff < 0.f);
        }
      if (side == 0) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const size_t o = ((size_t)b * 3 + c) * V + v;
          store4(out + o, sg[c], nv, ow);
          if (vp_out) store4(vp_out + o, vp[c], nv, ow);
        }
      }
    }
  }
  if (kSides == 2) {
    // the block's |diff| sum: the rec lanes hold 0, fixed-order tree
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) local += __shfl_xor_sync(0xffffffffu, local, o);
    float* s_red = smem + kXOffRed;
    if (lane == 0) s_red[cw] = local;
    bar_sync(kBarBlend, kXG);
    if (tid == kXG)
      tot_part[(size_t)bt * R + r] = ((s_red[0] + s_red[1]) + s_red[2]) + s_red[3];
  }
}

// The forward kernel's vertex ranges R for n_bt batch tiles at one block an
// SM: of R = 1 .. min(4 SMs / n_bt, vertex tiles), the one that takes the
// fewest tile times, counting each wave of blocks as its largest range plus
// 2 tile times of set-up (staging pf and A); the smallest such R.
inline int fwd_ranges(int n_bt, int V) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int n_tiles = cdiv(V, kFV);
  int cap = 4 * sms / n_bt;
  cap = cap < 1 ? 1 : cap > n_tiles ? n_tiles : cap;
  int best = 1;
  long long best_cost = LLONG_MAX;
  for (int R = 1; R <= cap; ++R) {
    const long long cost =
        (long long)cdiv(n_bt * R, sms) * (cdiv(n_tiles, R) + 2);
    if (cost < best_cost) { best_cost = cost; best = R; }
  }
  return best;
}

// The widest store (4, 2 or 1 elements) that V and every output address
// allow: a (TO) and b (T, may be null).
template <typename TO, typename T>
inline int out_width(int V, const TO* a, const T* b) {
  const uintptr_t pa = reinterpret_cast<uintptr_t>(a);
  const uintptr_t pb = reinterpret_cast<uintptr_t>(b);
  for (int w = 4; w > 1; w /= 2)
    if (V % w == 0 && pa % (w * sizeof(TO)) == 0 &&
        pb % (w * sizeof(T)) == 0)
      return w;
  return 1;
}

// Batch tiles of the forward kernel at B rows.
template <int kSides>
inline int fwd_batch_tiles(int B) { return cdiv(B, kXR / kSides); }

template <int kSides, typename T, typename TO>
cudaError_t launch_skin_fwd(int B, int V, const float* pf0, const float* A0,
                            const float* pf1, const float* A1,
                            const float* vsh, const T* pd, const T* W,
                            TO* out, T* vp_out, float* tot_part,
                            cudaStream_t stream) {
  if (cudaError_t err = cudaFuncSetAttribute(
          skin_fwd_kernel<kSides, T, TO>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kXSmemBytes))
    return err;
  const int n_bt = fwd_batch_tiles<kSides>(B), R = fwd_ranges(n_bt, V);
  skin_fwd_kernel<kSides, T, TO><<<dim3(R, n_bt), kXT, kXSmemBytes, stream>>>(
      B, V, R, out_width(V, out, vp_out), pf0, A0, pf1, A1, vsh, pd, W, out,
      vp_out, tot_part);
  return cudaGetLastError();
}

// Registers, shared memory and local memory (spills) of skin_fwd_kernel
// <kSides, T, TO>: out[0..3] = registers, static and dynamic shared memory
// bytes, local bytes.
template <int kSides, typename T, typename TO = float>
int skin_fwd_attributes(int* out) {
  cudaFuncAttributes a;
  if (cudaError_t err =
          cudaFuncGetAttributes(&a, skin_fwd_kernel<kSides, T, TO>))
    return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)kXSmemBytes;
  out[3] = (int)a.localSizeBytes;
  return 0;
}

}  // namespace
