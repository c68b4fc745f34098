// Shared pieces of the skinning kernels (csrc/skin.cu, csrc/v2v.cu): the
// table sizes, the tile constants, and the building blocks of the one-pass
// gradient kernels (K2's fused mode, K3b); csrc/skin_fwd.cuh builds the
// one-pass forward kernel (K3f, K2's pair mode) from the same pieces.
//
// With vph = [vp; 1] the posed vertices, M = A . W the blended transforms
// and g (B,3,V) any f32 cotangent on the skinned vertices,
//   gvp[b,k,v]     = sum_i M[b,4i+k,v] g[b,i,v]
//   gpf[b,p]       = sum_v sum_k gvp[b,k,v] posedirs_t[p,k,v]
//   gA[b,j,i*4+k]  = sum_v g[b,i,v] vph[b,k,v] W_t[j,v]
//   gvsh[k,v]      = sum_b gvp[b,k,v]
// The TPU kernels accumulate gpf/gA along a sequential vertex grid. On
// Hopper, blocks run in parallel in no order, so a one-pass kernel gives
// each block a batch tile of kFB rows and a range of 16-vertex tiles: the
// block keeps gpf and gA in registers across its range, writes them (and
// its gvsh, summed over its rows) as partials, and range_reduce_kernel sums
// the partials in index order. No atomics: repeated runs are bit-identical.
//
// The posedirs contractions run on the tensor cores, mma.sync m16n8k8 TF32
// with the 3xTF32 split of csrc/tf32_mma.cuh, which also has the cp.async
// copies that stage the tiles.
//
// bf16 tables. Every kernel is a template on its table type T (posedirs_t
// and W_t): float, or bf16 (the JAX package's skin_tables_dtype, set by
// --skin_bf16). With bf16 tables a kernel computes the TPU kernel's bf16
// function (nemo_tpu/ops/lbs_pallas.py, cdt = bf16): pf and A are rounded to
// bf16 (round to nearest even) as they are staged; the posedirs
// contractions run on mma.sync m16n8k16 bf16 with f32 accumulation, in one
// pass, the feature axis padded to 208 (13 steps of 16); the blend M = A . W,
// the vertices, gvp and gA stay on the CUDA cores in f32 over the rounded
// operands (a product of two bf16 values is exact in f32, so that is the
// function of a bf16 x bf16 contraction with f32 accumulation); the backward
// rounds gm = g . [vp; 1] (gA's operand) and gvp (gpf's) to bf16, and gvsh
// sums the unrounded gvp. v_shaped_t, the cotangent and the outputs stay f32;
// the pair mode stores vp in bf16. A bf16 table row is 2V bytes: the tiles
// are staged by 4-byte cp.async where V is even and element by element (plain
// loads) where it is odd, into the first half of the f32 kernels' buffers.
// What bounds the kernels does not change: the SIMT part (the blend, gA),
// as in f32; the posedirs contractions' tensor-core time falls from three
// TF32 passes at 495 TFLOP/s to one bf16 pass at 989, and the table bytes
// halve (PERF.md has the times).

#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

namespace {

// true for the bf16 tables' instantiations
template <typename T>
constexpr bool kIsBf16 = std::is_same<T, bf16>::value;

constexpr int kP = 207;   // pose features (23 joints x 9)
constexpr int kJ = 24;    // joints
constexpr int kL = 12;    // 3x4 transform components
constexpr int kGL = kJ * kL;  // 288 gA entries a row

// the one-pass kernels (K2, K3b, and the forward kernel of skin_fwd.cuh)
constexpr int kFB = 32;          // batch rows a block
constexpr int kFV = 16;          // vertices a tile
constexpr int kFN = 3 * kFV;     // (k, v) columns a tile
constexpr int kPP = 208;         // pose features padded to the MMA depth
constexpr int kFT = 256;         // threads a block (8 warps)
// shared-memory row strides (floats), chosen so the MMA fragment loads hit
// 32 distinct banks: pd rows by k (stride = 24 mod 32), pf and gvp rows by
// m (stride = 20 mod 32)
constexpr int kSD = 56;
constexpr int kSF = 212;
constexpr int kSX = 52;
// W rows (18: the gA loop's 4 joint groups fall on distinct banks)
constexpr int kSW = 18;
// Where the feature axis is split between two halves of the warps: 104 in
// 3xTF32 (m16n8k8 steps), 112 with bf16 tables (m16n8k16 steps, 7 and 6).
// The bf16 tiles keep the strides above in elements: kSD bf16 (28 words)
// puts the forward's and gpf's fragment loads on distinct banks too.
template <typename T>
constexpr int kPHalf = kIsBf16<T> ? 112 : kPP / 2;

// ---------------------------------------------------------------------------
// bf16 helpers
// ---------------------------------------------------------------------------

// x as an operand the bf16 kernels round: to the nearest bf16, ties to even
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (kIsBf16<T>) return __bfloat162float(__float2bfloat16_rn(x));
  else return x;
}

// Two bf16 in one register as f32 (exact: a bf16 is the top half of an f32).
__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// Two (ld2) or four (ld4) neighbouring table elements as f32, from an 8- or
// 16-byte (f32) or 4- or 8-byte (bf16) boundary.
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const bf16* p) {
  return bf16x2_to_float2(*reinterpret_cast<const uint32_t*>(p));
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = bf16x2_to_float2(u.x), b = bf16x2_to_float2(u.y);
  return make_float4(a.x, a.y, b.x, b.y);
}

// Copy CW (1 or 2) table elements from global to shared memory; only the
// first n of them are read (n <= 0: none), the rest are zero-filled. f32:
// one cp.async of 4 or 8 bytes. bf16: a pair by one 4-byte cp.async (V even,
// so n is even too); a lone element (V odd: rows on 2-byte boundaries,
// below cp.async's 4) by a plain load and store, done before the barrier
// that hands the buffer over.
template <int CW>
__device__ __forceinline__ void copy_elems(float* dst, const float* src, int n) {
  cp_async<CW>(dst, src, n);
}
template <int CW>
__device__ __forceinline__ void copy_elems(bf16* dst, const bf16* src, int n) {
  if constexpr (CW == 2) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    const int bytes = n > 0 ? 2 * (n < 2 ? n : 2) : 0;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(bytes));
  } else {
    *dst = n > 0 ? src[0] : __ushort_as_bfloat16((unsigned short)0);
  }
}

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// total = sum of the tile partials, in a fixed order.
__global__ void __launch_bounds__(256)
total_kernel(int n, const float* __restrict__ partial, float* __restrict__ total) {
  __shared__ float s[256];
  const int t = threadIdx.x;
  float acc = 0.f;
  for (int i = t; i < n; i += 256) acc += partial[i];
  s[t] = acc;
  __syncthreads();
  for (int k = 128; k > 0; k >>= 1) {
    if (t < k) s[t] += s[t + k];
    __syncthreads();
  }
  if (t == 0) *total = s[0];
}

// The second pass of the one-pass kernels: gpf and gA summed over the R
// vertex ranges, gvsh over the n_bt batch tiles, each in index order.
__global__ void __launch_bounds__(256)
range_reduce_kernel(int n_gpf, int n_ga, int n_gvsh, int R, int n_bt,
                    const float* __restrict__ gpf_part,
                    const float* __restrict__ ga_part,
                    const float* __restrict__ gvsh_part,
                    float* __restrict__ gpf, float* __restrict__ gA,
                    float* __restrict__ gvsh) {
  int i = blockIdx.x * 256 + threadIdx.x;
  const float* src;
  float* dst;
  int n, stride;
  if (i < n_gpf) {
    src = gpf_part; dst = gpf; n = R; stride = n_gpf;
  } else if ((i -= n_gpf) < n_ga) {
    src = ga_part; dst = gA; n = R; stride = n_ga;
  } else if ((i -= n_ga) < n_gvsh) {
    src = gvsh_part; dst = gvsh; n = n_bt; stride = n_gvsh;
  } else {
    return;
  }
  float s = 0.f;
  for (int q = 0; q < n; ++q) s += src[(size_t)q * stride + i];
  dst[i] = s;
}

// The one-pass kernels' vertex ranges R for B rows: two even waves at one
// block an SM, and no more ranges than vertex tiles.
inline int fused_ranges(int B, int V) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int n_bt = cdiv(B, kFB);
  const int R = 2 * (sms / n_bt > 1 ? sms / n_bt : 1);
  return R < cdiv(V, kFV) ? R : cdiv(V, kFV);
}

// Floats of per-block partials of the one-pass kernels' gradients: gpf and
// gA a range, gvsh a batch tile.
inline long long grad_partial_floats(int B, int V, int R) {
  return (long long)R * B * (kP + kGL) + (long long)cdiv(B, kFB) * 3 * V;
}

// The vertex tiles [t_begin, t_end) of range r of R.
__device__ __forceinline__ void range_tiles(int r, int R, int V, int& t_begin,
                                            int& t_end) {
  const int n_tiles = cdiv(V, kFV);
  t_begin = (int)((long long)r * n_tiles / R);
  t_end = (int)((long long)(r + 1) * n_tiles / R);
}

// Queue the copies of vertex tile t's posedirs slice into s_pd [kPP][kSD],
// CW elements a copy (2 where V is even, so every row is 8-byte (f32) or
// 4-byte (bf16) aligned), by the nt threads from tid; rows past the 207
// features and vertices past V are zero-filled.
template <int CW, typename T>
__device__ __forceinline__ void load_pd_slice(T* s_pd, int t, int V,
                                              const T* __restrict__ pd,
                                              int tid, int nt) {
  constexpr int kCh = kFV / CW;  // copies a row of the tile
  const int v0 = t * kFV;
  const size_t V3 = 3 * (size_t)V;
  for (int e = tid; e < kPP * 3 * kCh; e += nt) {
    const int x = e % kCh * CW, pk = e / kCh, p = pk / 3, k = pk % 3;
    const int n = p < kP ? V - (v0 + x) : 0;
    copy_elems<CW>(s_pd + p * kSD + k * kFV + x,
                   n > 0 ? pd + (size_t)p * V3 + (size_t)k * V + v0 + x : pd, n);
  }
}

// The same for the W slice (into s_w, rows of kStride elements) and the
// v_shaped slice (f32, into s_vs [3][kFV]).
template <int CW, int kStride, typename T>
__device__ __forceinline__ void load_w_slice(T* s_w, float* s_vs, int t,
                                             int V,
                                             const float* __restrict__ vsh,
                                             const T* __restrict__ W,
                                             int tid, int nt) {
  constexpr int kCh = kFV / CW;
  const int v0 = t * kFV;
  for (int e = tid; e < kJ * kCh; e += nt) {
    const int x = e % kCh * CW, j = e / kCh, n = V - (v0 + x);
    copy_elems<CW>(s_w + j * kStride + x,
                   n > 0 ? W + (size_t)j * V + v0 + x : W, n);
  }
  for (int e = tid; e < 3 * kCh; e += nt) {
    const int x = e % kCh * CW, k = e / kCh, n = V - (v0 + x);
    cp_async<CW>(s_vs + k * kFV + x, n > 0 ? vsh + (size_t)k * V + v0 + x : vsh,
                 n);
  }
}

// Queue the copies of vertex tile t of the tables (posedirs into s_pd
// [kPP][kSD], W into s_w [kJ][kSW], v_shaped into s_vs [3][kFV]) by all
// kFT threads of the block.
template <int CW, typename T>
__device__ __forceinline__ void load_tile(T* s_pd, T* s_w, float* s_vs,
                                          int t, int V,
                                          const float* __restrict__ vsh,
                                          const T* __restrict__ pd,
                                          const T* __restrict__ W) {
  load_pd_slice<CW>(s_pd, t, V, pd, threadIdx.x, kFT);
  load_w_slice<CW, kSW>(s_w, s_vs, t, V, vsh, W, threadIdx.x, kFT);
}

// ---------------------------------------------------------------------------
// a vertex tile's work
// ---------------------------------------------------------------------------

// vph (16 rows from m-tile fm, 3 n-tiles from fn0) = pf . pd over the
// features [k_begin, k_end) on the tensor cores, written to out (rows of
// kSX); the cross terms and big . big in separate accumulators (shorter
// dependency chains), added at the end.
__device__ __forceinline__ void vph_mma(const float* s_pf, const float* s_pd,
                                        float* out, int fm, int fn0,
                                        int k_begin, int k_end, int gid,
                                        int tig) {
  float lo[3][4], hi[3][4];
#pragma unroll
  for (int n = 0; n < 3; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) { lo[n][i] = 0.f; hi[n][i] = 0.f; }
#pragma unroll 2
  for (int k0 = k_begin; k0 < k_end; k0 += 8) {
    const float* pa = s_pf + (16 * fm + gid) * kSF + k0 + tig;
    const float a[4] = {pa[0], pa[8 * kSF], pa[4], pa[8 * kSF + 4]};
#pragma unroll
    for (int n = 0; n < 3; ++n) {
      const int o = (k0 + tig) * kSD + 8 * (fn0 + n) + gid;
      uint32_t bb[2], bs[2];
      split_tf32(s_pd[o], bb[0], bs[0]);
      split_tf32(s_pd[o + 4 * kSD], bb[1], bs[1]);
      mma_3xtf32(lo[n], hi[n], a, bb, bs);
    }
  }
#pragma unroll
  for (int n = 0; n < 3; ++n) {
    float* o = out + (16 * fm + gid) * kSX + 8 * (fn0 + n) + 2 * tig;
    *reinterpret_cast<float2*>(o) =
        make_float2(lo[n][0] + hi[n][0], lo[n][1] + hi[n][1]);
    *reinterpret_cast<float2*>(o + 8 * kSX) =
        make_float2(lo[n][2] + hi[n][2], lo[n][3] + hi[n][3]);
  }
}

// The same with bf16 tables on mma.sync m16n8k16: vph (kM 16-row m-tiles
// from m0, 3 n-tiles from fn0) = pf . pd over [k_begin, k_end) (multiples
// of 16), one pass. s_pf2 holds pf rounded to bf16, two features a word
// ([row][kSF] words, features 2w and 2w + 1 in word w); the B fragment's
// feature pairs are packed from two 16-bit loads of the [kPP][kSD] tile.
template <int kM>
__device__ __forceinline__ void vph_mma_bf16(const uint32_t* s_pf2,
                                             const bf16* s_pd, float* out,
                                             int m0, int fn0, int k_begin,
                                             int k_end, int gid, int tig) {
  float acc[kM][3][4];
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int n = 0; n < 3; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;
#pragma unroll 2
  for (int k0 = k_begin; k0 < k_end; k0 += 16) {
    uint32_t a[kM][4];
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      const int o = (16 * (m0 + m) + gid) * kSF + k0 / 2 + tig;
      a[m][0] = s_pf2[o]; a[m][1] = s_pf2[o + 8 * kSF];
      a[m][2] = s_pf2[o + 4]; a[m][3] = s_pf2[o + 8 * kSF + 4];
    }
#pragma unroll
    for (int n = 0; n < 3; ++n) {
      const bf16* p = s_pd + (k0 + 2 * tig) * kSD + 8 * (fn0 + n) + gid;
      const uint32_t b[2] = {pack_bf16(p[0], p[kSD]),
                             pack_bf16(p[8 * kSD], p[9 * kSD])};
#pragma unroll
      for (int m = 0; m < kM; ++m) mma_bf16(acc[m][n], a[m], b);
    }
  }
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int n = 0; n < 3; ++n) {
      float* o = out + (16 * (m0 + m) + gid) * kSX + 8 * (fn0 + n) + 2 * tig;
      *reinterpret_cast<float2*>(o) = make_float2(acc[m][n][0], acc[m][n][1]);
      *reinterpret_cast<float2*>(o + 8 * kSX) =
          make_float2(acc[m][n][2], acc[m][n][3]);
    }
}

// Stage pf of nrows side-rows for the bf16 MMA: s_pf2[row * kSF + w] packs
// features 2w, 2w + 1 (feature 207 the zero pad), rounded to bf16; row's
// pose features from src(row), zero where b_of(row) >= B.
template <typename Src, typename Row>
__device__ __forceinline__ void stage_pf_bf16(uint32_t* s_pf2, int nrows,
                                              int B, Src src, Row b_of,
                                              int tid, int nt) {
  for (int e = tid; e < nrows * (kPP / 2); e += nt) {
    const int row = e / (kPP / 2), w = e % (kPP / 2), p = 2 * w;
    const int b = b_of(row);
    const float* pf = src(row) + (size_t)b * kP;
    const float x0 = b < B ? pf[p] : 0.f;
    const float x1 = b < B && p + 1 < kP ? pf[p + 1] : 0.f;
    s_pf2[row * kSF + w] = pack_bf16(x0, x1);
  }
}

// What each of a block's 256 threads holds of the gradients.
struct GradRoles {
  int gid, tig;         // the lane's MMA fragment coordinates
  int gm, gn0;          // gpf: m-tile (16 of the 32 rows), n-tiles gn0 + 4n
  int lh, ga_row, ga_j0;  // gA: components 6 lh..6 lh + 5, a row, 6 joints
  __device__ explicit GradRoles(int tid)
      : gid((tid & 31) >> 2), tig(tid & 3), gm((tid >> 5) & 1),
        gn0(tid >> 6), lh(tid >> 7), ga_row((tid & 127) >> 2),
        ga_j0((tid & 3) * 6) {}
};

// gA for one half of the 12 components (LH = 0: l 0..5, 1: l 6..11) of one
// row and 6 joints, over the tile's vertices two at a time; with bf16 tables
// gm = g . [vo; 1] is rounded to bf16 first.
template <int LH, typename T>
__device__ __forceinline__ void ga_tile(float acc[6][6], const float* s_g,
                                        const float* s_vo, const T* s_w,
                                        int row, int j0) {
#pragma unroll
  for (int v = 0; v < kFV; v += 2) {
    float2 g[3], vo[3], w[6];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      g[i] = *reinterpret_cast<const float2*>(s_g + row * kSX + i * kFV + v);
      vo[i] = *reinterpret_cast<const float2*>(s_vo + row * kSX + i * kFV + v);
    }
#pragma unroll
    for (int jj = 0; jj < 6; ++jj) w[jj] = ld2(s_w + (j0 + jj) * kSW + v);
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      const int l = 6 * LH + q, i = l / 4, k = l % 4;
      float2 G = k < 3 ? make_float2(g[i].x * vo[k % 3].x, g[i].y * vo[k % 3].y)
                       : g[i];
      if constexpr (kIsBf16<T>) G = make_float2(rnd<T>(G.x), rnd<T>(G.y));
#pragma unroll
      for (int jj = 0; jj < 6; ++jj) {
        acc[q][jj] += G.x * w[jj].x;
        acc[q][jj] += G.y * w[jj].y;
      }
    }
  }
}

// A tile's gradients from its gvp (s_gvp [kFB][kSX]), cotangent (s_g) and
// posed vertices (s_vo), both [kFB][kSX]:
//   gpf (32 x 208) += gvp (32 x 48) . pd^T (48 x 208) on the tensor cores
//   (bf16 tables: gvp rounded to bf16, m16n8k16, the (k, v) pairs of the B
//   fragment one 32-bit load);
//   gA += (g x [vo; 1]) . W^T (SIMT);
//   gvsh: the tile's gvp summed over the block's rows, in order, written to
//   the batch tile's partial.
template <typename T>
__device__ __forceinline__ void tile_grads(const GradRoles& q,
                                           float gpf_acc[7][4],
                                           float ga_acc[6][6],
                                           const float* s_gvp, const float* s_g,
                                           const float* s_vo, const T* s_pd,
                                           const T* s_w, int V, int v0,
                                           int bt, float* __restrict__ gvsh_part) {
  if constexpr (kIsBf16<T>) {
#pragma unroll
    for (int k0 = 0; k0 < kFN; k0 += 16) {
      const float* pa = s_gvp + (16 * q.gm + q.gid) * kSX + k0 + 2 * q.tig;
      const float2 x0 = *reinterpret_cast<const float2*>(pa);
      const float2 x1 = *reinterpret_cast<const float2*>(pa + 8 * kSX);
      const float2 x2 = *reinterpret_cast<const float2*>(pa + 8);
      const float2 x3 = *reinterpret_cast<const float2*>(pa + 8 * kSX + 8);
      const uint32_t a[4] = {pack_bf16(x0.x, x0.y), pack_bf16(x1.x, x1.y),
                             pack_bf16(x2.x, x2.y), pack_bf16(x3.x, x3.y)};
#pragma unroll
      for (int n = 0; n < 7; ++n) {
        const int nt = q.gn0 + 4 * n;
        if (nt < kPP / 8) {
          const T* pb = s_pd + (8 * nt + q.gid) * kSD + k0 + 2 * q.tig;
          const uint32_t b[2] = {*reinterpret_cast<const uint32_t*>(pb),
                                 *reinterpret_cast<const uint32_t*>(pb + 8)};
          mma_bf16(gpf_acc[n], a, b);
        }
      }
    }
  } else {
#pragma unroll
  for (int k0 = 0; k0 < kFN; k0 += 8) {
    const float* pa = s_gvp + (16 * q.gm + q.gid) * kSX + k0 + q.tig;
    const float a[4] = {pa[0], pa[8 * kSX], pa[4], pa[8 * kSX + 4]};
#pragma unroll
    for (int n = 0; n < 7; ++n) {
      const int nt = q.gn0 + 4 * n;
      if (nt < kPP / 8) {
        const int o = (8 * nt + q.gid) * kSD + k0 + q.tig;
        uint32_t bb[2], bs[2];
        split_tf32(s_pd[o], bb[0], bs[0]);
        split_tf32(s_pd[o + 4], bb[1], bs[1]);
        mma_3xtf32(gpf_acc[n], gpf_acc[n], a, bb, bs);
      }
    }
  }
  }
  if (q.lh == 0) ga_tile<0>(ga_acc, s_g, s_vo, s_w, q.ga_row, q.ga_j0);
  else           ga_tile<1>(ga_acc, s_g, s_vo, s_w, q.ga_row, q.ga_j0);
  const int tid = threadIdx.x;
  if (tid < kFN) {
    const int k = tid / kFV, v = v0 + tid % kFV;
    float s = 0.f;
    for (int row = 0; row < kFB; ++row) s += s_gvp[row * kSX + tid];
    if (v < V) gvsh_part[((size_t)bt * 3 + k) * V + v] = s;
  }
}

// The block's gpf and gA for range r: gpf_part [R][B][207], ga_part
// [R][B][288].
__device__ __forceinline__ void store_grad_parts(const GradRoles& q, int B,
                                                 int b0, int r,
                                                 const float gpf_acc[7][4],
                                                 const float ga_acc[6][6],
                                                 float* __restrict__ gpf_part,
                                                 float* __restrict__ ga_part) {
  float* gpf_r = gpf_part + (size_t)r * B * kP;
#pragma unroll
  for (int n = 0; n < 7; ++n) {
    const int nt = q.gn0 + 4 * n;
    if (nt >= kPP / 8) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int b = b0 + 16 * q.gm + q.gid + (i >> 1) * 8;
      const int p = 8 * nt + 2 * q.tig + (i & 1);
      if (b < B && p < kP) gpf_r[(size_t)b * kP + p] = gpf_acc[n][i];
    }
  }
  const int b = b0 + q.ga_row;
  if (b < B) {
    float* ga_r = ga_part + ((size_t)r * B + b) * kGL;
#pragma unroll
    for (int qq = 0; qq < 6; ++qq)
#pragma unroll
      for (int jj = 0; jj < 6; ++jj)
        ga_r[(q.ga_j0 + jj) * kL + 6 * q.lh + qq] = ga_acc[qq][jj];
  }
}

}  // namespace
