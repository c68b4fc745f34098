// The VPoser v2v-L1 prior (K2): the Hopper port of nemo_tpu/ops/lbs_pallas.py
// _v2v_fwdbwd_kernel / _v2v_fwdbwd_pallas (:625 / :709, the fused mode) and
// _v2v_fwd_kernel / _v2v_fwd_kernel_vp / _v2v_fwd_pallas (:505 / :553 /
// :560, its pallas_call at :594; the total-only and pair modes).
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
//     in 3xTF32 (skin_common.cuh has the split and its accuracy):
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
//     are bit-identical: range_reduce_kernel the gradients, total_kernel
//     the |diff| partials (both skin_common.cuh, with the split, the
//     cp.async staging, the range rule and a tile's gradient work, which
//     K3b's one-pass kernel in csrc/skin.cu shares). Mode 0 runs the same kernel
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
// Mode 2, the pair mode: skin_fwd_kernel<2> (csrc/skin_fwd.cuh, shared with
// K3f), one pass over 16-row batch tiles (both sides: 32 rows of the MMA) x
// vertex ranges, storing the sign and, if asked, vp.
//   - Work: B*V*(2*1839 + 9) FLOP (13.0 GFLOP at B=512, V=6890): 0.194 ms
//     at the f32 rate. With both sides' posedirs contractions on the TF32
//     tensor cores in 3xTF32 (8.76 GFLOP of products, three each: 0.053 ms)
//     the rest bounds it on the CUDA cores, 4.24 GFLOP: 0.063 ms if the two
//     overlap. Bytes: the sign and vp (84.7 MB at B=512) and the inputs,
//     ~105 MB: 0.031 ms.
//   - So: vph of both sides on mma.sync in one warp group while the other
//     blends the previous tile on the CUDA cores, A and the pre-split pf of
//     both sides held in shared memory for the block's range; the orig and
//     rec vertices meet by shuffle; each block writes its |diff| sum and
//     total_kernel adds them in index order. 16-row tiles read posedirs
//     from L2 twice as often as 32-row tiles would, but 32 rows of both
//     sides do not fit in a block's shared memory with vph double-buffered.
// Ragged B and V are masked everywhere (no padded tables).
//
// bf16 tables (_v2v_fwdbwd_kernel and _v2v_fwd_kernel with cdt = bf16; the
// C entry points with the _bf16 suffix): every mode is the same kernel at
// T = bf16 (skin_common.cuh has the arithmetic). The fused kernel stages pf
// of both sides rounded to bf16, two features a word, and A of both sides
// rounded to bf16 once for its range (36 KB, in the half of the posedirs
// buffers the bf16 tiles leave free; the blend reads it from there), runs
// the forward vph (64 x 48 over 13 steps of 16) and the backward
// gpf (gvp rounded to bf16) on mma.sync m16n8k16 in one pass each, widens W
// for the blend and rounds g . [vp; 1] for gA. The tiles keep the f32
// layout's strides in elements, in the first half of each buffer. The pair
// mode stores vp in bf16.

#include "skin_fwd.cuh"

namespace {

// ---------------------------------------------------------------------------
// modes 0 and 1: the one-pass kernel
// ---------------------------------------------------------------------------

// shared memory, in floats (the tile constants are skin_common.cuh's)
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
// bf16 tables: the two bf16 posedirs buffers fill the first half of theirs,
// and A of both sides, rounded to bf16 once, [2 * kFB][kGL], takes the rest
constexpr int kOffAb = kOffPd + kPP * kSD;
static_assert(2 * kFB * kGL * sizeof(bf16) <= sizeof(float) * kPP * kSD,
              "the rounded A does not fit beside the bf16 posedirs tiles");

template <typename T>
__global__ void __launch_bounds__(kFT, 1)
v2v_fused_kernel(int B, int V, int R, const float* __restrict__ pf_o,
                 const float* __restrict__ A_o, const float* __restrict__ pf_r,
                 const float* __restrict__ A_r, const float* __restrict__ vsh,
                 const T* __restrict__ pd, const T* __restrict__ W,
                 int grad, float* __restrict__ tot_part,
                 float* __restrict__ gpf_part, float* __restrict__ ga_part,
                 float* __restrict__ gvsh_part) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const GradRoles q(tid);
  const int r = blockIdx.x, bt = blockIdx.y, b0 = bt * kFB;
  int t_begin, t_end;
  range_tiles(r, R, V, t_begin, t_end);

  float* s_pf = smem + kOffPf;
  bf16* s_Ab = reinterpret_cast<bf16*>(smem + kOffAb);
  float* s_vph = smem + kOffVph;
  float* s_gvp = smem + kOffGvp;
  float* s_g = smem + kOffG;

  const auto pd_buf = [&](int buf) {
    return reinterpret_cast<T*>(smem + kOffPd) + buf * kPP * kSD;
  };
  const auto w_buf = [&](int buf) {
    return reinterpret_cast<T*>(smem + kOffW) + buf * kJ * kSW;
  };
  const auto load = [&](int buf, int t) {
    float* s_vs = smem + kOffVs + buf * 3 * kFV;
    if (V & 1) load_tile<1>(pd_buf(buf), w_buf(buf), s_vs, t, V, vsh, pd, W);
    else       load_tile<2>(pd_buf(buf), w_buf(buf), s_vs, t, V, vsh, pd, W);
  };
  load(0, t_begin);
  cp_async_commit();
  // pf of both sides for the whole range: rows 0..31 orig, 32..63 rec
  // (bf16 tables: rounded to bf16, two features a word; A of both sides
  // too, rounded once here instead of on every vertex tile)
  if constexpr (kIsBf16<T>) {
    stage_pf_bf16(reinterpret_cast<uint32_t*>(s_pf), 2 * kFB, B,
                  [&](int row) { return row < kFB ? pf_o : pf_r; },
                  [&](int row) { return b0 + row % kFB; }, tid, kFT);
    for (int e = tid; e < 2 * kFB * (kGL / 4); e += kFT) {
      const int row = e / (kGL / 4), c4 = e % (kGL / 4), b = b0 + row % kFB;
      const float4 x = b < B ? __ldg(reinterpret_cast<const float4*>(
          (row < kFB ? A_o : A_r) + (size_t)b * kGL) + c4)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      reinterpret_cast<uint2*>(s_Ab + row * kGL)[c4] =
          make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
    }
  } else {
    for (int e = tid; e < 2 * kFB * kPP; e += kFT) {
      const int row = e / kPP, p = e % kPP, b = b0 + row % kFB;
      const float* src = row < kFB ? pf_o : pf_r;
      s_pf[row * kSF + p] = (b < B && p < kP) ? src[(size_t)b * kP + p] : 0.f;
    }
  }

  // forward MMA: warp -> m-tile (16 of the 64 rows), 3 of the 6 n-tiles
  const int fm = warp & 3, fn0 = (warp >> 2) * 3;
  // gpf (backward MMA) and gA accumulate across the range: GradRoles
  float gpf_acc[7][4];
#pragma unroll
  for (int t = 0; t < 7; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) gpf_acc[t][i] = 0.f;
  float ga_acc[6][6];
#pragma unroll
  for (int l = 0; l < 6; ++l)
#pragma unroll
    for (int jj = 0; jj < 6; ++jj) ga_acc[l][jj] = 0.f;
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
    const T* s_pd = pd_buf(buf);
    const T* s_w = w_buf(buf);
    const float* s_vs = smem + kOffVs + buf * 3 * kFV;

    // 1. vph (64 x 48) = pf (64 x 208) . pd (208 x 48) on the tensor cores
    if constexpr (kIsBf16<T>)
      vph_mma_bf16<1>(reinterpret_cast<const uint32_t*>(s_pf), s_pd, s_vph, fm,
                      fn0, 0, kPP, q.gid, q.tig);
    else
      vph_mma(s_pf, s_pd, s_vph, fm, fn0, 0, kPP, q.gid, q.tig);
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
          const float2 w = ld2(s_w + j * kSW + sv);
          float a_o[kL], a_r[kL];
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            float4 x, y;
            if constexpr (kIsBf16<T>) {
              x = ld4(s_Ab + sb * kGL + kL * j + 4 * c);
              y = ld4(s_Ab + (kFB + sb) * kGL + kL * j + 4 * c);
            } else {
              x = __ldg(ao + 3 * j + c);
              y = __ldg(ar + 3 * j + c);
            }
            a_o[4 * c] = x.x; a_o[4 * c + 1] = x.y; a_o[4 * c + 2] = x.z; a_o[4 * c + 3] = x.w;
            a_r[4 * c] = y.x; a_r[4 * c + 1] = y.y; a_r[4 * c + 2] = y.z; a_r[4 * c + 3] = y.w;
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
          float x = mr[e][4 * i + 3];
#pragma unroll
          for (int k = 0; k < 3; ++k) { o += mo[e][4 * i + k] * vo[k]; x += mr[e][4 * i + k] * vr[k]; }
          const float diff = x - o;
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

    // 3-5. gpf, gA and the tile's gvsh (skin_common.cuh)
    if (grad)
      tile_grads(q, gpf_acc, ga_acc, s_gvp, s_g, s_vph, s_pd, s_w, V, v0, bt,
                 gvsh_part);
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
  if (grad) store_grad_parts(q, B, b0, r, gpf_acc, ga_acc, gpf_part, ga_part);
}

}  // namespace

// Floats of scratch nemo_v2v_l1 needs for (B, V, mode): mode 0 the |diff|
// partials; mode 1 also the gpf, gA and gvsh partials; mode 2 the forward
// kernel's |diff| partials. -1 for a shape it refuses.
extern "C" int nemo_v2v_scratch_floats(int B, int V, int mode) {
  if (B <= 0 || V <= 0 || mode < 0 || mode > 2) return -1;
  if (mode == 2) {
    const int n_bt = fwd_batch_tiles<2>(B);
    return n_bt * fwd_ranges(n_bt, V);
  }
  const long long R = fused_ranges(B, V), n_bt = cdiv(B, kFB);
  long long n = n_bt * R;
  if (mode == 1) n += grad_partial_floats(B, V, R);
  return n < (1LL << 31) ? (int)n : -1;
}

// Registers, shared memory and local memory (spills) of the pair mode's
// kernel, skin_fwd_kernel<2, T>, as the CUDA runtime reports them:
// out[0..3] = registers, static and dynamic shared memory bytes, local
// bytes.
extern "C" int nemo_v2v_pair_attributes(int* out) {
  return skin_fwd_attributes<2, float>(out);
}
extern "C" int nemo_v2v_pair_attributes_bf16(int* out) {
  return skin_fwd_attributes<2, bf16>(out);
}

namespace {

template <typename T>
int fused_attributes(int* out) {
  cudaFuncAttributes a;
  if (cudaError_t err = cudaFuncGetAttributes(&a, v2v_fused_kernel<T>))
    return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)kSmemBytes;
  out[3] = (int)a.localSizeBytes;
  return 0;
}

}  // namespace

// The same for the fused kernel (modes 0 and 1), f32 and bf16 tables.
extern "C" int nemo_v2v_fused_attributes(int* out) {
  return fused_attributes<float>(out);
}
extern "C" int nemo_v2v_fused_attributes_bf16(int* out) {
  return fused_attributes<bf16>(out);
}

namespace {

template <typename T>
int v2v_l1(int B, int V, const float* pf_o, const float* A_o,
           const float* pf_r, const float* A_r, const float* vsh, const T* pd,
           const T* W, int mode, float* scratch, float* sign, T* vp,
           float* total, float* gpf, float* gA, float* gvsh,
           cudaStream_t stream) {
  if (B <= 0 || V <= 0 || mode < 0 || mode > 2 ||
      cdiv(B, mode == 2 ? kFB / 2 : kFB) > 65535 ||
      (mode == 2 && !sign) || (mode == 1 && (!gpf || !gA || !gvsh)))
    return (int)cudaErrorInvalidValue;
  if (mode == 2) {
    if (cudaError_t err = launch_skin_fwd<2, T>(B, V, pf_o, A_o, pf_r, A_r,
                                                vsh, pd, W, sign, vp, scratch,
                                                stream))
      return (int)err;
    const int n_bt = fwd_batch_tiles<2>(B);
    total_kernel<<<1, 256, 0, stream>>>(n_bt * fwd_ranges(n_bt, V), scratch,
                                        total);
    return (int)cudaGetLastError();
  }
  if (cudaError_t err = cudaFuncSetAttribute(
          v2v_fused_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)kSmemBytes))
    return (int)err;
  const int R = fused_ranges(B, V), n_bt = cdiv(B, kFB);
  const int grad = mode == 1;
  float* tot_part = scratch;
  float* gpf_part = tot_part + (size_t)n_bt * R;
  float* ga_part = gpf_part + (size_t)R * B * kP;
  float* gvsh_part = ga_part + (size_t)R * B * kGL;
  v2v_fused_kernel<T><<<dim3(R, n_bt), kFT, kSmemBytes, stream>>>(
      B, V, R, pf_o, A_o, pf_r, A_r, vsh, pd, W, grad, tot_part,
      grad ? gpf_part : nullptr, grad ? ga_part : nullptr,
      grad ? gvsh_part : nullptr);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  total_kernel<<<1, 256, 0, stream>>>(n_bt * R, tot_part, total);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  if (!grad) return 0;
  const int n_gpf = B * kP, n_ga = B * kGL, n_gvsh = 3 * V;
  range_reduce_kernel<<<cdiv(n_gpf + n_ga + n_gvsh, 256), 256, 0, stream>>>(
      n_gpf, n_ga, n_gvsh, R, n_bt, gpf_part, ga_part, gvsh_part, gpf, gA,
      gvsh);
  return (int)cudaGetLastError();
}

}  // namespace

// pf_* (B,207), A_* (B,24,12) on 16-byte boundaries, vsh (3,V), pd
// (207,3,V), W (24,V) (on 8-byte boundaries where V is even), all f32
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
  return v2v_l1<float>(B, V, pf_o, A_o, pf_r, A_r, vsh, pd, W, mode, scratch,
                       sign, vp, total, gpf, gA, gvsh, stream);
}

// The same with bf16 tables: pd and W bf16 (on 4-byte boundaries where V
// is even), vp (B,3,V) bf16; everything else as nemo_v2v_l1.
extern "C" int nemo_v2v_l1_bf16(int B, int V, const float* pf_o,
                                const float* A_o, const float* pf_r,
                                const float* A_r, const float* vsh,
                                const bf16* pd, const bf16* W, int mode,
                                float* scratch, float* sign, bf16* vp,
                                float* total, float* gpf, float* gA,
                                float* gvsh, cudaStream_t stream) {
  return v2v_l1<bf16>(B, V, pf_o, A_o, pf_r, A_r, vsh, pd, W, mode, scratch,
                      sign, vp, total, gpf, gA, gvsh, stream);
}
