// The VPoser v2v-L1 prior (K2): the Hopper port of nemo_tpu/ops/lbs_pallas.py
// _v2v_fwdbwd_kernel / _v2v_fwdbwd_pallas (:625 / :709, the fused mode) and
// _v2v_fwd_kernel / _v2v_fwd_kernel_vp / _v2v_fwd_pallas (:560, the
// total-only and pair modes).
//
// For every (batch row b, vertex v), both pose sets are skinned,
//   vph[k]  = sum_p pf[b,p] posedirs_t[p,k,v] + v_shaped_t[k,v],  vph[3] = 1
//   M[l]    = sum_j A[b,j,l] W_t[j,v]                     (l = i*4 + k)
//   vert[i] = M[4i+3] + sum_k M[4i+k] vph[k]
// and total = sum |vert_rec - vert_orig|. With g = sign(rec - orig)
// (sign(0) = 0) the orig-side gradients are
//   gvp[b,k,v]    = sum_i M_o[4i+k] g_i
//   gpf[b,p]      = sum_v sum_k gvp[b,k,v] posedirs_t[p,k,v]
//   gA[b,j,4i+k]  = sum_v g_i vph_o[k] W_t[j,v]
//   gvsh[k,v]     = sum_b gvp[b,k,v]
// The modes: 0 total only (the undifferentiated call); 1 fused: the total
// and (gpf, gA, gvsh); 2 pair: writes sign (B,3,V) and, if asked, the
// orig-side posed vertices vp (B,3,V), and stops; the backward runs K3b
// (csrc/skin.cu) on them.
//
// What bounds it on the H100, at B=512, V=6890: 19.5 GFLOP in all, 13.1 of
// them in the two posedirs contractions (the forward vph of both sides and
// the backward gpf), 6.3 in the SIMT work (the blend M of both sides, the
// vertices, gA); about 18 MB of device bytes, mostly the 17 MB posedirs
// table, which stays in the 50 MB L2. So it is bound by operations: at the
// f32 rate of the CUDA cores (67 TFLOP/s) 0.29 ms, and with the posedirs
// contractions on the TF32 tensor cores (495 TFLOP/s, three products each,
// below) by the SIMT part, 0.09 ms.
//
// Modes 0 and 1: v2v_fused_kernel, one pass, as the TPU kernel does it.
//   - Grid: batch tiles of kFB = 32 rows x R vertex ranges. A block loops
//     over the 16-vertex tiles of its range, which takes the place of the
//     TPU kernel's sequential vertex grid. The ~175 KB of shared memory
//     allows one block an SM, so R = 2 * max(1, SMs / batch tiles): two
//     even waves (16 ranges of ~431 vertices at B=512, 8 of ~862 at B=960).
//   - Staging: each tile's posedirs slice (207 x 3 x 16), W slice and
//     v_shaped slice are copied into shared memory by cp.async (8 bytes a
//     copy where V is even), double-buffered against the previous tile's
//     compute. That one copy feeds both posedirs contractions. pf of both
//     sides stays in shared memory for the whole range.
//   - Tensor cores for the two posedirs contractions: mma.sync m16n8k8 TF32
//     with a 3xTF32 split, x = big + small, big = tf32(x), small =
//     tf32(x - big) (rounded to nearest, ties away, by masking the low 13
//     mantissa bits), and a.b = (a_s.b_b + a_b.b_s) + a_b.b_b accumulated in
//     f32. The dropped a_s.b_s term is below 2^-22 of each product, so the
//     contractions keep f32-level accuracy; this is the kernel's arithmetic,
//     not an option, and TF32 stays off everywhere else.
//       forward:  vph (64 rows = 32 orig + 32 rec, 48 = 3 x 16 columns)
//                 = pf (64 x 208) . pd (208 x 48), the feature axis padded
//                 to 208 with a zero row; the cross terms and big . big in
//                 two accumulators (shorter dependency chains);
//       backward: gpf (32 x 208) += gvp (32 x 48) . pd^T (48 x 208), the
//                 accumulators in registers across the whole range.
//     Shared-memory strides put each fragment load on 32 distinct banks.
//   - On-chip: the blend M (SIMT, A read as float4 through L1, two vertices
//     a thread), |rec - orig|, the sign and gvp; gA (32 x 288) accumulates
//     in registers across the range (SIMT). None of sign, vp or gvp reaches
//     device memory.
//   - Partials: each block writes its gpf (32 x 207) and gA (32 x 288) for
//     its range, its gvsh (3 x its vertices) summed over its 32 rows, and
//     its |diff| sum (17.5 MB of scratch at B=512 on 132 SMs). The second
//     pass sums them in a fixed order, with no atomics, so repeated runs
//     are bit-identical: v2v_reduce_kernel the gradients, total_kernel
//     (skin_common.cuh) the |diff| partials. Mode 0 runs the same kernel
//     with the gradient work off and the same total_kernel, so its total
//     equals mode 1's bit for bit.
//   - What holds it back: the SIMT blend, which reads A (72 KB a block,
//     more than L1 holds beside the shared memory) from L2; the forward and
//     backward mma.sync phases, which split their operands on the fly; the
//     wait for each tile's cp.async. wgmma with TMA-fed, pre-split operands
//     and the blend on the tensor cores are the next steps.
//   - Alignment: A is read as float4 and, where V is even, the tables are
//     copied 8 bytes at a time, so the caller passes A on 16-byte and the
//     tables on 8-byte boundaries (ops/lbs.py checks it).
// Mode 2: v2v_tile_kernel, a 32-row x 32-vertex tile per block on the CUDA
// cores: pf and a 16-feature slice of posedirs staged in shared memory,
// each thread keeping 4 rows x 2 sides x 3 coordinates of vph in registers.
// Ragged B and V are masked everywhere (no padded tables).

#include <cstdint>

#include "skin_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// mode 2: the pair mode's tile kernel
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kTV * kTY)
v2v_tile_kernel(int B, int V, const float* __restrict__ pf_o,
                const float* __restrict__ A_o, const float* __restrict__ pf_r,
                const float* __restrict__ A_r, const float* __restrict__ vsh,
                const float* __restrict__ pd, const float* __restrict__ W,
                float* __restrict__ partial, float* __restrict__ sign,
                float* __restrict__ vp) {
  __shared__ float s_pfo[kTB][kPK];
  __shared__ float s_pfr[kTB][kPK];
  __shared__ float s_pd[kPK][3][kTV];
  __shared__ float s_red[kTV * kTY];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTV + tx;
  const int v0 = blockIdx.x * kTV, b0 = blockIdx.y * kTB;
  const int v = v0 + tx;
  const size_t V3 = 3 * (size_t)V;

  float ao[kRB][3], ar[kRB][3];
#pragma unroll
  for (int r = 0; r < kRB; ++r)
#pragma unroll
    for (int k = 0; k < 3; ++k) { ao[r][k] = 0.f; ar[r][k] = 0.f; }

  for (int p0 = 0; p0 < kP; p0 += kPK) {
    for (int e = tid; e < kTB * kPK; e += kTV * kTY) {
      const int r = e / kPK, q = e % kPK, b = b0 + r, p = p0 + q;
      const bool ok = b < B && p < kP;
      s_pfo[r][q] = ok ? pf_o[(size_t)b * kP + p] : 0.f;
      s_pfr[r][q] = ok ? pf_r[(size_t)b * kP + p] : 0.f;
    }
    for (int e = tid; e < kPK * 3 * kTV; e += kTV * kTY) {
      const int x = e % kTV, k = (e / kTV) % 3, q = e / (3 * kTV);
      const int p = p0 + q, vv = v0 + x;
      s_pd[q][k][x] = (p < kP && vv < V) ? pd[(size_t)p * V3 + (size_t)k * V + vv] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kPK; ++q) {
      const float d0 = s_pd[q][0][tx], d1 = s_pd[q][1][tx], d2 = s_pd[q][2][tx];
#pragma unroll
      for (int r = 0; r < kRB; ++r) {
        const float fo = s_pfo[ty * kRB + r][q], fr = s_pfr[ty * kRB + r][q];
        ao[r][0] += fo * d0; ao[r][1] += fo * d1; ao[r][2] += fo * d2;
        ar[r][0] += fr * d0; ar[r][1] += fr * d1; ar[r][2] += fr * d2;
      }
    }
    __syncthreads();
  }

  float local = 0.f;
  if (v < V) {
    float w[kJ];
#pragma unroll
    for (int j = 0; j < kJ; ++j) w[j] = W[(size_t)j * V + v];
    const float vs[3] = {vsh[v], vsh[(size_t)V + v], vsh[2 * (size_t)V + v]};
#pragma unroll
    for (int r = 0; r < kRB; ++r) {
      const int b = b0 + ty * kRB + r;
      if (b >= B) continue;
      float Mo[kL], Mr[kL];
#pragma unroll
      for (int l = 0; l < kL; ++l) { Mo[l] = 0.f; Mr[l] = 0.f; }
      const float* ao_row = A_o + (size_t)b * kJ * kL;
      const float* ar_row = A_r + (size_t)b * kJ * kL;
#pragma unroll 4
      for (int j = 0; j < kJ; ++j) {
#pragma unroll
        for (int l = 0; l < kL; ++l) {
          Mo[l] += ao_row[j * kL + l] * w[j];
          Mr[l] += ar_row[j * kL + l] * w[j];
        }
      }
      float vo[3], vr[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) { vo[k] = ao[r][k] + vs[k]; vr[k] = ar[r][k] + vs[k]; }
      const size_t base = (size_t)b * V3 + v;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        float o = Mo[4 * i + 3];
        float q = Mr[4 * i + 3];
#pragma unroll
        for (int k = 0; k < 3; ++k) { o += Mo[4 * i + k] * vo[k]; q += Mr[4 * i + k] * vr[k]; }
        const float diff = q - o;
        local += fabsf(diff);
        sign[base + (size_t)i * V] = (float)(diff > 0.f) - (float)(diff < 0.f);
        if (vp) vp[base + (size_t)i * V] = vo[i];
      }
    }
  }

  s_red[tid] = local;
  __syncthreads();
  for (int s = kTV * kTY / 2; s > 0; s >>= 1) {
    if (tid < s) s_red[tid] += s_red[tid + s];
    __syncthreads();
  }
  if (tid == 0) partial[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = s_red[0];
}

int num_tile_partials(int B, int V) { return cdiv(V, kTV) * cdiv(B, kTB); }

// ---------------------------------------------------------------------------
// modes 0 and 1: the one-pass kernel
// ---------------------------------------------------------------------------

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
constexpr int kGL = kJ * kL;     // 288 gA entries a row

// shared memory, in floats
constexpr int kOffPd = 0;                             // [2][kPP][kSD]
constexpr int kOffPf = kOffPd + 2 * kPP * kSD;        // [2 * kFB][kSF]
constexpr int kOffW = kOffPf + 2 * kFB * kSF;         // [2][kJ][kSW]
constexpr int kOffVs = kOffW + 2 * kJ * kSW;          // [2][3][kFV]
constexpr int kOffVph = kOffVs + 2 * 3 * kFV;         // [2 * kFB][kSX]
constexpr int kOffGvp = kOffVph + 2 * kFB * kSX;      // [kFB][kSX]
constexpr int kOffG = kOffGvp + kFB * kSX;            // [kFB][kSX]
constexpr int kOffRed = kOffG + kFB * kSX;            // [kFT]
constexpr int kSmemFloats = kOffRed + kFT;
constexpr size_t kSmemBytes = sizeof(float) * kSmemFloats;

__device__ __forceinline__ uint32_t tf32_bits(float x) {
  // round to the nearest TF32 (10 mantissa bits), ties away from zero
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_bits(x);
  small = tf32_bits(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 3xTF32 with b already split: lo += a_s . b_b + a_b . b_s, hi += a_b . b_b
// (lo and hi may be the same accumulator).
__device__ __forceinline__ void mma_3xtf32(float lo[4], float hi[4],
                                           const float a[4],
                                           const uint32_t bb[2],
                                           const uint32_t bs[2]) {
  uint32_t ab[4], as[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], ab[i], as[i]);
  mma_tf32(lo, as, bb);
  mma_tf32(lo, ab, bs);
  mma_tf32(hi, ab, bb);
}

// Copy CW floats (CW = 1 or 2) from global to shared memory; only the first
// n of them are read (n <= 0: none), the rest are zero-filled.
template <int CW>
__device__ __forceinline__ void cp_async(float* dst, const float* src, int n) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = n > 0 ? 4 * (n < CW ? n : CW) : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(d), "l"(src), "n"(4 * CW), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Queue the copies of vertex tile t (posedirs, W, v_shaped) into buffer buf,
// CW floats a copy (2 where V is even, so every row is 8-byte aligned);
// rows past the 207 features and vertices past V are zero-filled.
template <int CW>
__device__ __forceinline__ void load_tile(float* smem, int buf, int t, int V,
                                          const float* __restrict__ vsh,
                                          const float* __restrict__ pd,
                                          const float* __restrict__ W) {
  constexpr int kCh = kFV / CW;  // copies a row of the tile
  const int v0 = t * kFV;
  const size_t V3 = 3 * (size_t)V;
  float* s_pd = smem + kOffPd + buf * kPP * kSD;
  for (int e = threadIdx.x; e < kPP * 3 * kCh; e += kFT) {
    const int x = e % kCh * CW, pk = e / kCh, p = pk / 3, k = pk % 3;
    const int n = p < kP ? V - (v0 + x) : 0;
    cp_async<CW>(s_pd + p * kSD + k * kFV + x,
                 n > 0 ? pd + (size_t)p * V3 + (size_t)k * V + v0 + x : pd, n);
  }
  float* s_w = smem + kOffW + buf * kJ * kSW;
  for (int e = threadIdx.x; e < kJ * kCh; e += kFT) {
    const int x = e % kCh * CW, j = e / kCh, n = V - (v0 + x);
    cp_async<CW>(s_w + j * kSW + x, n > 0 ? W + (size_t)j * V + v0 + x : W, n);
  }
  float* s_vs = smem + kOffVs + buf * 3 * kFV;
  for (int e = threadIdx.x; e < 3 * kCh; e += kFT) {
    const int x = e % kCh * CW, k = e / kCh, n = V - (v0 + x);
    cp_async<CW>(s_vs + k * kFV + x, n > 0 ? vsh + (size_t)k * V + v0 + x : vsh,
                 n);
  }
}

// gA for one half of the 12 components (LH = 0: l 0..5, 1: l 6..11) of one
// row and 6 joints, over the tile's vertices two at a time.
template <int LH>
__device__ __forceinline__ void ga_tile(float acc[6][6], const float* s_g,
                                        const float* s_vo, const float* s_w,
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
    for (int jj = 0; jj < 6; ++jj)
      w[jj] = *reinterpret_cast<const float2*>(s_w + (j0 + jj) * kSW + v);
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      const int l = 6 * LH + q, i = l / 4, k = l % 4;
      const float2 G = k < 3 ? make_float2(g[i].x * vo[k % 3].x, g[i].y * vo[k % 3].y)
                             : g[i];
#pragma unroll
      for (int jj = 0; jj < 6; ++jj) {
        acc[q][jj] += G.x * w[jj].x;
        acc[q][jj] += G.y * w[jj].y;
      }
    }
  }
}

__global__ void __launch_bounds__(kFT, 1)
v2v_fused_kernel(int B, int V, int R, const float* __restrict__ pf_o,
                 const float* __restrict__ A_o, const float* __restrict__ pf_r,
                 const float* __restrict__ A_r, const float* __restrict__ vsh,
                 const float* __restrict__ pd, const float* __restrict__ W,
                 int grad, float* __restrict__ tot_part,
                 float* __restrict__ gpf_part, float* __restrict__ ga_part,
                 float* __restrict__ gvsh_part) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int r = blockIdx.x, bt = blockIdx.y, b0 = bt * kFB;
  const int n_tiles = (V + kFV - 1) / kFV;
  const int t_begin = (int)((long long)r * n_tiles / R);
  const int t_end = (int)((long long)(r + 1) * n_tiles / R);

  float* s_pf = smem + kOffPf;
  float* s_vph = smem + kOffVph;
  float* s_gvp = smem + kOffGvp;
  float* s_g = smem + kOffG;

  const auto load = [&](int buf, int t) {
    if (V & 1) load_tile<1>(smem, buf, t, V, vsh, pd, W);
    else       load_tile<2>(smem, buf, t, V, vsh, pd, W);
  };
  load(0, t_begin);
  cp_async_commit();
  // pf of both sides for the whole range: rows 0..31 orig, 32..63 rec
  for (int e = tid; e < 2 * kFB * kPP; e += kFT) {
    const int row = e / kPP, p = e % kPP, b = b0 + row % kFB;
    const float* src = row < kFB ? pf_o : pf_r;
    s_pf[row * kSF + p] = (b < B && p < kP) ? src[(size_t)b * kP + p] : 0.f;
  }

  // forward MMA: warp -> m-tile (16 of the 64 rows), 3 of the 6 n-tiles
  const int fm = warp & 3, fn0 = (warp >> 2) * 3;
  // backward MMA: warp -> m-tile (16 of the 32 rows), n-tiles w/2 + 4t
  const int gm = warp & 1, gn0 = warp >> 1;
  float gpf_acc[7][4];
#pragma unroll
  for (int t = 0; t < 7; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) gpf_acc[t][i] = 0.f;
  // gA: warps 0-3 hold l 0..5, warps 4-7 l 6..11; a thread one row, 6 joints
  const int lh = tid >> 7, ga_row = (tid & 127) >> 2, ga_j0 = (tid & 3) * 6;
  float ga_acc[6][6];
#pragma unroll
  for (int q = 0; q < 6; ++q)
#pragma unroll
    for (int jj = 0; jj < 6; ++jj) ga_acc[q][jj] = 0.f;
  // blend: a thread one row, two neighbouring vertices
  const int sb = tid >> 3, sv = (tid & 7) * 2, b_s = b0 + sb;
  float local = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1, v0 = t * kFV;
    if (t + 1 < t_end) {
      load(buf ^ 1, t + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float* s_pd = smem + kOffPd + buf * kPP * kSD;
    const float* s_w = smem + kOffW + buf * kJ * kSW;
    const float* s_vs = smem + kOffVs + buf * 3 * kFV;

    // 1. vph (64 x 48) = pf (64 x 208) . pd (208 x 48) on the tensor cores,
    //    the cross terms and big . big in separate accumulators (shorter
    //    dependency chains), added at the end
    {
      float lo[3][4], hi[3][4];
#pragma unroll
      for (int n = 0; n < 3; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) { lo[n][i] = 0.f; hi[n][i] = 0.f; }
#pragma unroll 2
      for (int k0 = 0; k0 < kPP; k0 += 8) {
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
        float* out = s_vph + (16 * fm + gid) * kSX + 8 * (fn0 + n) + 2 * tig;
        *reinterpret_cast<float2*>(out) =
            make_float2(lo[n][0] + hi[n][0], lo[n][1] + hi[n][1]);
        *reinterpret_cast<float2*>(out + 8 * kSX) =
            make_float2(lo[n][2] + hi[n][2], lo[n][3] + hi[n][3]);
      }
    }
    __syncthreads();

    // 2. the blend, the vertices, |rec - orig|, the sign and gvp (SIMT)
    {
      float mo[2][kL], mr[2][kL];
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int l = 0; l < kL; ++l) { mo[e][l] = 0.f; mr[e][l] = 0.f; }
      if (b_s < B) {
        const float4* ao = reinterpret_cast<const float4*>(A_o + (size_t)b_s * kGL);
        const float4* ar = reinterpret_cast<const float4*>(A_r + (size_t)b_s * kGL);
#pragma unroll 4
        for (int j = 0; j < kJ; ++j) {
          const float2 w = *reinterpret_cast<const float2*>(s_w + j * kSW + sv);
          float a_o[kL], a_r[kL];
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            const float4 x = __ldg(ao + 3 * j + q), y = __ldg(ar + 3 * j + q);
            a_o[4 * q] = x.x; a_o[4 * q + 1] = x.y; a_o[4 * q + 2] = x.z; a_o[4 * q + 3] = x.w;
            a_r[4 * q] = y.x; a_r[4 * q + 1] = y.y; a_r[4 * q + 2] = y.z; a_r[4 * q + 3] = y.w;
          }
#pragma unroll
          for (int l = 0; l < kL; ++l) {
            mo[0][l] += a_o[l] * w.x; mo[1][l] += a_o[l] * w.y;
            mr[0][l] += a_r[l] * w.x; mr[1][l] += a_r[l] * w.y;
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int v = sv + e;
        const bool valid = b_s < B && v0 + v < V;
        float vo[3], vr[3], g[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float vs = s_vs[k * kFV + v];
          vo[k] = s_vph[sb * kSX + k * kFV + v] + vs;
          vr[k] = s_vph[(kFB + sb) * kSX + k * kFV + v] + vs;
        }
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          float o = mo[e][4 * i + 3];
          float q = mr[e][4 * i + 3];
#pragma unroll
          for (int k = 0; k < 3; ++k) { o += mo[e][4 * i + k] * vo[k]; q += mr[e][4 * i + k] * vr[k]; }
          const float diff = q - o;
          if (valid) local += fabsf(diff);
          g[i] = valid ? (float)(diff > 0.f) - (float)(diff < 0.f) : 0.f;
        }
        if (grad) {
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            s_g[sb * kSX + k * kFV + v] = g[k];
            s_gvp[sb * kSX + k * kFV + v] =
                mo[e][k] * g[0] + mo[e][4 + k] * g[1] + mo[e][8 + k] * g[2];
            s_vph[sb * kSX + k * kFV + v] = vo[k];
          }
        }
      }
    }
    __syncthreads();

    if (grad) {
      // 3. gpf (32 x 208) += gvp (32 x 48) . pd^T (48 x 208) on the tensor cores
#pragma unroll
      for (int k0 = 0; k0 < kFN; k0 += 8) {
        const float* pa = s_gvp + (16 * gm + gid) * kSX + k0 + tig;
        const float a[4] = {pa[0], pa[8 * kSX], pa[4], pa[8 * kSX + 4]};
#pragma unroll
        for (int n = 0; n < 7; ++n) {
          const int nt = gn0 + 4 * n;
          if (nt < kPP / 8) {
            const int o = (8 * nt + gid) * kSD + k0 + tig;
            uint32_t bb[2], bs[2];
            split_tf32(s_pd[o], bb[0], bs[0]);
            split_tf32(s_pd[o + 4], bb[1], bs[1]);
            mma_3xtf32(gpf_acc[n], gpf_acc[n], a, bb, bs);
          }
        }
      }
      // 4. gA += (g x [vph_o; 1]) . W^T over the tile (SIMT)
      if (lh == 0) ga_tile<0>(ga_acc, s_g, s_vph, s_w, ga_row, ga_j0);
      else         ga_tile<1>(ga_acc, s_g, s_vph, s_w, ga_row, ga_j0);
      // 5. gvsh: the tile's gvp summed over the block's rows, in order
      if (tid < kFN) {
        const int k = tid / kFV, v = v0 + tid % kFV;
        float s = 0.f;
        for (int row = 0; row < kFB; ++row) s += s_gvp[row * kSX + tid];
        if (v < V) gvsh_part[((size_t)bt * 3 + k) * V + v] = s;
      }
    }
    __syncthreads();
  }

  // the block's partials
  float* s_red = smem + kOffRed;
  s_red[tid] = local;
  __syncthreads();
  for (int s = kFT / 2; s > 0; s >>= 1) {
    if (tid < s) s_red[tid] += s_red[tid + s];
    __syncthreads();
  }
  if (tid == 0) tot_part[(size_t)bt * R + r] = s_red[0];
  if (!grad) return;
  float* gpf_r = gpf_part + (size_t)r * B * kP;
#pragma unroll
  for (int n = 0; n < 7; ++n) {
    const int nt = gn0 + 4 * n;
    if (nt >= kPP / 8) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int b = b0 + 16 * gm + gid + (i >> 1) * 8;
      const int p = 8 * nt + 2 * tig + (i & 1);
      if (b < B && p < kP) gpf_r[(size_t)b * kP + p] = gpf_acc[n][i];
    }
  }
  const int b = b0 + ga_row;
  if (b < B) {
    float* ga_r = ga_part + ((size_t)r * B + b) * kGL;
#pragma unroll
    for (int q = 0; q < 6; ++q)
#pragma unroll
      for (int jj = 0; jj < 6; ++jj)
        ga_r[(ga_j0 + jj) * kL + 6 * lh + q] = ga_acc[q][jj];
  }
}

// The second pass of mode 1: gpf and gA summed over the R ranges, gvsh over
// the batch tiles, each in index order (total_kernel sums the |diff|
// partials).
__global__ void __launch_bounds__(256)
v2v_reduce_kernel(int n_gpf, int n_ga, int n_gvsh, int R, int n_bt,
                  const float* __restrict__ gpf_part,
                  const float* __restrict__ ga_part,
                  const float* __restrict__ gvsh_part, float* __restrict__ gpf,
                  float* __restrict__ gA, float* __restrict__ gvsh) {
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

// The fused kernel's vertex ranges R for B rows: two even waves at one
// block an SM, and no more ranges than vertex tiles.
int fused_ranges(int B, int V) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int n_bt = cdiv(B, kFB);
  const int R = 2 * (sms / n_bt > 1 ? sms / n_bt : 1);
  return R < cdiv(V, kFV) ? R : cdiv(V, kFV);
}

}  // namespace

// Floats of scratch nemo_v2v_l1 needs for (B, V, mode): mode 0 the |diff|
// partials; mode 1 also the gpf, gA and gvsh partials; mode 2 the pair tile
// kernel's |diff| partials. -1 for a shape it refuses.
extern "C" int nemo_v2v_scratch_floats(int B, int V, int mode) {
  if (B <= 0 || V <= 0 || mode < 0 || mode > 2) return -1;
  if (mode == 2) return num_tile_partials(B, V);
  const long long R = fused_ranges(B, V), n_bt = cdiv(B, kFB);
  long long n = n_bt * R;
  if (mode == 1) n += R * B * (kP + kGL) + n_bt * 3LL * V;
  return n < (1LL << 31) ? (int)n : -1;
}

// Registers, shared memory and local memory (spills) of the fused kernel,
// as the CUDA runtime reports them: out[0..3] = registers, static and
// dynamic shared memory bytes, local bytes.
extern "C" int nemo_v2v_fused_attributes(int* out) {
  cudaFuncAttributes a;
  if (cudaError_t err = cudaFuncGetAttributes(&a, v2v_fused_kernel)) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)kSmemBytes;
  out[3] = (int)a.localSizeBytes;
  return 0;
}

// pf_* (B,207), A_* (B,24,12), vsh (3,V), pd (207,3,V), W (24,V), all f32
// contiguous on one device; scratch: nemo_v2v_scratch_floats(B, V, mode)
// floats; total: 1 float. mode 0: total only (sign, vp, gpf, gA, gvsh may
// be null). mode 1: also gpf (B,207), gA (B,24,12), gvsh (3,V). mode 2
// (pair): also sign (B,3,V) and, unless vp is null, vp (B,3,V).
extern "C" int nemo_v2v_l1(int B, int V, const float* pf_o, const float* A_o,
                           const float* pf_r, const float* A_r,
                           const float* vsh, const float* pd, const float* W,
                           int mode, float* scratch, float* sign, float* vp,
                           float* total, float* gpf, float* gA, float* gvsh,
                           cudaStream_t stream) {
  if (B <= 0 || V <= 0 || cdiv(B, kTB) > 65535 || mode < 0 || mode > 2 ||
      (mode == 2 && !sign) || (mode == 1 && (!gpf || !gA || !gvsh)))
    return (int)cudaErrorInvalidValue;
  if (mode == 2) {
    const dim3 tile_grid(cdiv(V, kTV), cdiv(B, kTB));
    v2v_tile_kernel<<<tile_grid, dim3(kTV, kTY), 0, stream>>>(
        B, V, pf_o, A_o, pf_r, A_r, vsh, pd, W, scratch, sign, vp);
    if (cudaError_t err = cudaGetLastError()) return (int)err;
    total_kernel<<<1, 256, 0, stream>>>(num_tile_partials(B, V), scratch,
                                        total);
    return (int)cudaGetLastError();
  }
  if (cudaError_t err = cudaFuncSetAttribute(
          v2v_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)kSmemBytes))
    return (int)err;
  const int R = fused_ranges(B, V), n_bt = cdiv(B, kFB);
  const int grad = mode == 1;
  float* tot_part = scratch;
  float* gpf_part = tot_part + (size_t)n_bt * R;
  float* ga_part = gpf_part + (size_t)R * B * kP;
  float* gvsh_part = ga_part + (size_t)R * B * kGL;
  v2v_fused_kernel<<<dim3(R, n_bt), kFT, kSmemBytes, stream>>>(
      B, V, R, pf_o, A_o, pf_r, A_r, vsh, pd, W, grad, tot_part,
      grad ? gpf_part : nullptr, grad ? ga_part : nullptr,
      grad ? gvsh_part : nullptr);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  total_kernel<<<1, 256, 0, stream>>>(n_bt * R, tot_part, total);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  if (!grad) return 0;
  const int n_gpf = B * kP, n_ga = B * kGL, n_gvsh = 3 * V;
  v2v_reduce_kernel<<<cdiv(n_gpf + n_ga + n_gvsh, 256), 256, 0, stream>>>(
      n_gpf, n_ga, n_gvsh, R, n_bt, gpf_part, ga_part, gvsh_part, gpf, gA,
      gvsh);
  return (int)cudaGetLastError();
}
