// Plain linear blend skinning and its VJP: the Hopper port of
// nemo_tpu/ops/lbs_pallas.py _fwd_kernel / _fwd_pallas (K3f, :69 / :129,
// its pallas_call at :155) and _bwd_kernel / _bwd_kernel_vp (K3b, called
// by _bwd_pallas).
//
// K3f: for every (batch row b, vertex v),
//   vph[k]  = sum_p pf[b,p] posedirs_t[p,k,v] + v_shaped_t[k,v],  vph[3] = 1
//   M[l]    = sum_j A[b,j,l] W_t[j,v]                     (l = i*4 + k)
//   vert[i] = M[4i+3] + sum_k M[4i+k] vph[k]
// written as verts_t (B,3,V). K3b: for any f32 cotangent g (B,3,V), the
// gradients gpf (B,207), gA (B,24,12) and gvsh (3,V) of skin_common.cuh,
// with vp either recomputed from pf (mode 1) or read from a stored (B,3,V)
// copy (mode 2).
//
// K3f: skin_fwd_kernel<1> (csrc/skin_fwd.cuh, shared with K2's pair mode),
// one pass over 32-row batch tiles x vertex ranges.
//   - Work: B*V*1839 FLOP (posing 2*621 + 3, blending 2*288, the vertices
//     2*9; 6.49 GFLOP at (512, 6890), 1.81 at (960, 1024)). At the f32 rate of the CUDA cores (67 TFLOP/s) it is
//     bound by operations (0.097 / 0.027 ms). With the posedirs contraction
//     (1242 FLOP a (b, v)) on the TF32 tensor cores in 3xTF32 (three
//     products at 495 TFLOP/s: 0.027 / 0.007 ms) the rest, the blend M = A . W
//     and the vertices, bounds it on the CUDA cores: 0.031 / 0.009 ms if the
//     two overlap. Device bytes (the tables, which stay in L2, and the
//     (B,3,V) output: 61 / 16 MB) take less. On the tensor cores the blend
//     would cost three times its products, so it stays on the CUDA cores.
//   - So: vph on mma.sync in 3xTF32 in one warp group, the blend on the
//     CUDA cores in the other, overlapped tile by tile through
//     double-buffered vph and named barriers; A (all 12 components) and
//     the pre-split pf in shared memory for the block's range; the tables'
//     slices staged by cp.async, double-buffered; the vertices stored 16
//     bytes a thread where V allows it (skin_fwd.cuh has the details).
//   - Alignment: A is read as float4, so the caller passes it on a 16-byte
//     boundary (ops/lbs.py checks it, and the tables' 8 bytes).
//
// K3b: skin_bwd_kernel, one pass, as the TPU kernel does it, with K2's
// one-pass design (csrc/v2v.cu) on one side.
//   - Work: 2*B*V*(621 + 216 + 9 + 621 + 297) FLOP with vp recomputed (12.4
//     GFLOP at B=512, V=6890), 621 MACs fewer per (b, v) with vp stored.
//     The backward blends only the rotation part of M (gvp reads it, gA
//     reads [vp; 1]), 9 of the 12 components. The two posedirs
//     contractions (mode 1's vp, and gpf) run on the tensor cores in
//     3xTF32, so with them at 495 TFLOP/s (three products each) and the
//     rest in f32 at 67 TFLOP/s the SIMT part bounds it: 0.055 ms at
//     (512, 6890) in either mode. Device bytes (g, vp, the 17 MB posedirs
//     table, which stays in the 50 MB L2) take less.
//   - Grid: batch tiles of kFB = 32 rows x R vertex ranges, R from
//     fused_ranges (skin_common.cuh). A block loops over the 16-vertex
//     tiles of its range, which takes the place of the TPU kernel's
//     sequential vertex grid.
//   - Staging: each tile's posedirs slice (207 x 3 x 16), W slice, v_shaped
//     slice, cotangent tile (32 x 3 x 16) and, in mode 2, vp tile are
//     copied into shared memory by cp.async, double-buffered against the
//     previous tile's compute. The tables go 8 bytes a copy where V is even
//     (the caller aligns them); g and vp 8 bytes where V is even and their
//     own address allows it, else 4, so any contiguous cotangent is taken.
//   - For the whole range, shared memory holds pf (mode 1) and the rotation
//     part of A for the block's rows, [row][component][joint], so the blend
//     reads A as float4 over 4 joints from shared memory, not from L2.
//     About 185 KB in all: one block an SM.
//   - Tensor cores (skin_common.cuh): mode 1's vp (32 x 48) = pf (32 x 208)
//     . pd (208 x 48), the feature axis split between the two halves of
//     the block's warps, each half writing its own partial product; and
//     gpf (32 x 208) += gvp (32 x 48) . pd^T, the accumulators in
//     registers across the range. Mode 2 skips the forward contraction.
//   - On the CUDA cores: the blend M = A . W of the rotation part (a
//     thread one row, two vertices), gvp = M^T g, gA (32 x 288) in
//     registers across the range, the tile's gvsh summed over the block's
//     rows. Neither gvp nor vp reaches device memory.
//   - Partials: each block writes its gpf and gA for its range and its
//     gvsh for its batch tile (17.5 MB of scratch at (512, 6890) on 132
//     SMs); range_reduce_kernel sums them in index order, with no atomics,
//     so repeated runs are bit-identical. Two launches a call.
//   - Alignment: A is read as float4, so the caller passes it on a 16-byte
//     boundary (ops/lbs.py checks it, and the tables' 8 bytes).
// Ragged B and V are masked everywhere: there are no padded tables, and
// outputs have exactly V columns.
//
// bf16 tables (_fwd_kernel, _bwd_kernel and _bwd_kernel_vp with cdt =
// bf16; the C entry points with the _bf16 suffix): K3f is skin_fwd_kernel
// <1, bf16>; K3b is skin_bwd_kernel<kMode, bf16> (skin_common.cuh has the
// arithmetic): pf rounded to bf16 two features a word and A rounded as they
// are staged, mode 1's vp (32 x 48, the features split at 112) and gpf (gvp
// rounded to bf16) on mma.sync m16n8k16 in one pass each, W widened for the
// blend, g . [vp; 1] rounded for gA. Mode 2 reads a stored bf16 vp: its
// tiles are staged by cp.async into the upper half of the vp buffers and
// widened to f32 beside the blend.
//
// bf16 meshes (the JAX package's NEMO_TPU_SKIN_IO_BF16; the entry points'
// mesh_bf16 = 1, either table type): K3f is skin_fwd_kernel<1,
// T, bf16>, which rounds the f32 vertices to bf16 as it stores them. K3b
// (mode 1) is skin_bwd_kernel<1, T, bf16>, which reads the bf16 cotangent
// itself, half the bytes of an f32 one: its tiles are staged by cp.async
// (4 bytes where V is even) into the first half of the cotangent buffers
// and widened to f32 into one more buffer beside the blend (exact: a bf16
// is the top half of an f32). So its gradients are the f32-cotangent
// kernel's on the widened cotangent, as _bwd_kernel's g.astype(f32). The
// stored-vp mode only ever takes K2's f32 sign and has no bf16 twin.

#include "skin_fwd.cuh"

namespace {

bool bad_shape(int B, int V) {
  return B <= 0 || V <= 0 || cdiv(B, kFB) > 65535;
}

// ---------------------------------------------------------------------------
// K3b: the one-pass backward kernel
// ---------------------------------------------------------------------------

constexpr int kSA = 9 * kJ;      // a row of A's rotation part, [c][j]
constexpr int kPH = kPP / 2;     // the features of each half of the warps

// shared memory, in floats
constexpr int kBOffPd = 0;                        // [2][kPP][kSD]
constexpr int kBOffPf = kBOffPd + 2 * kPP * kSD;  // [kFB][kSF] (mode 1)
constexpr int kBOffA = kBOffPf + kFB * kSF;       // [kFB][kSA]
constexpr int kBOffW = kBOffA + kFB * kSA;        // [2][kJ][kSW]
constexpr int kBOffVs = kBOffW + 2 * kJ * kSW;    // [2][3][kFV]
constexpr int kBOffG = kBOffVs + 2 * 3 * kFV;     // [2][kFB][kSX]
// mode 1: the two halves' partial vph, then vp in the first; mode 2: the
// double-buffered vp tiles
constexpr int kBOffX = kBOffG + 2 * kFB * kSX;    // [2][kFB][kSX]
constexpr int kBOffGvp = kBOffX + 2 * kFB * kSX;  // [kFB][kSX]
constexpr int kBSmemFloats = kBOffGvp + kFB * kSX;
// a bf16 cotangent (G = bf16): the widened tile after the rest, [kFB][kSX]
constexpr int kBOffGw = kBSmemFloats;
template <typename G>
constexpr size_t kBSmemBytes =
    sizeof(float) * (kBSmemFloats + (kIsBf16<G> ? kFB * kSX : 0));
static_assert(kBOffA % 4 == 0 && kBOffG % 4 == 0 && kBOffX % 4 == 0 &&
                  kBOffGw % 4 == 0,
              "float4 and float2 views of shared memory need 16-byte rows");
static_assert(kBSmemBytes<bf16> <= 232448, "a block may have 227 KB");

// Queue the copies of vertex tile v0 of rows b0 .. b0 + 31 of a (B,3,V)
// tensor (f32, or a bf16 vp) into dst [kFB][kSX] (coordinate k at k * kFV),
// CW elements a copy; rows past B and vertices past V are zero-filled.
template <int CW, typename E>
__device__ __forceinline__ void load_rows(E* dst, const E* __restrict__ src,
                                          int B, int V, int b0, int v0) {
  constexpr int kCh = kFV / CW;
  for (int e = threadIdx.x; e < kFB * 3 * kCh; e += kFT) {
    const int x = e % kCh * CW, rk = e / kCh, row = rk / 3, k = rk % 3;
    const int b = b0 + row;
    const int n = b < B ? V - (v0 + x) : 0;
    copy_elems<CW>(dst + row * kSX + k * kFV + x,
                   n > 0 ? src + ((size_t)b * 3 + k) * V + v0 + x : src, n);
  }
}

template <typename E>
__device__ __forceinline__ void load_rows_cw(int cw, E* dst,
                                             const E* __restrict__ src,
                                             int B, int V, int b0, int v0) {
  if (cw == 2) load_rows<2>(dst, src, B, V, b0, v0);
  else         load_rows<1>(dst, src, B, V, b0, v0);
}

// kMode 1: vp recomputed from pf; 2: vp read from vp_in (in the table type
// T). G: the cotangent's type (f32, or bf16 in mode 1). g_cw, vp_cw: the
// copy width (elements) of the cotangent and of vp_in.
template <int kMode, typename T, typename G = float>
__global__ void __launch_bounds__(kFT, 1)
skin_bwd_kernel(int B, int V, int R, int g_cw, int vp_cw,
                const float* __restrict__ pf, const float* __restrict__ A,
                const float* __restrict__ vsh, const T* __restrict__ pd,
                const T* __restrict__ W, const G* __restrict__ g,
                const T* __restrict__ vp_in,
                float* __restrict__ gpf_part, float* __restrict__ ga_part,
                float* __restrict__ gvsh_part) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const GradRoles q(tid);
  const int r = blockIdx.x, bt = blockIdx.y, b0 = bt * kFB;
  int t_begin, t_end;
  range_tiles(r, R, V, t_begin, t_end);

  float* s_pf = smem + kBOffPf;
  float* s_A = smem + kBOffA;
  float* s_x = smem + kBOffX;
  float* s_gvp = smem + kBOffGvp;
  // mode 2, bf16 tables: the staged bf16 vp tiles, [2][kFB][kSX] elements
  // in the upper half of s_x; the widened tile goes to the lower half
  T* s_vpt = reinterpret_cast<T*>(s_x + (kIsBf16<T> ? kFB * kSX : 0));

  const auto pd_buf = [&](int buf) {
    return reinterpret_cast<T*>(smem + kBOffPd) + buf * kPP * kSD;
  };
  const auto w_buf = [&](int buf) {
    return reinterpret_cast<T*>(smem + kBOffW) + buf * kJ * kSW;
  };
  // the staged cotangent tiles, [2][kFB][kSX] elements of G
  const auto g_buf = [&](int buf) {
    return reinterpret_cast<G*>(smem + kBOffG) + buf * kFB * kSX;
  };
  const auto load = [&](int buf, int t) {
    float* s_vs = smem + kBOffVs + buf * 3 * kFV;
    if (V & 1) load_tile<1>(pd_buf(buf), w_buf(buf), s_vs, t, V, vsh, pd, W);
    else       load_tile<2>(pd_buf(buf), w_buf(buf), s_vs, t, V, vsh, pd, W);
    load_rows_cw(g_cw, g_buf(buf), g, B, V, b0, t * kFV);
    if (kMode == 2)
      load_rows_cw(vp_cw, s_vpt + buf * kFB * kSX, vp_in, B, V, b0, t * kFV);
  };
  load(0, t_begin);
  cp_async_commit();
  // A's rotation part for the block's rows: s_A[row][3i + k][j] = A[b,j,4i+k]
  for (int e = tid; e < kFB * kJ * 3; e += kFT) {
    const int row = e / (3 * kJ), c4 = e % (3 * kJ), j = c4 / 3, i = c4 % 3;
    const int b = b0 + row;
    const float4 x = b < B ? __ldg(reinterpret_cast<const float4*>(
                                 A + (size_t)b * kGL) + c4)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    float* d = s_A + row * kSA + 3 * i * kJ + j;
    d[0] = rnd<T>(x.x); d[kJ] = rnd<T>(x.y); d[2 * kJ] = rnd<T>(x.z);
  }
  if constexpr (kMode == 1 && kIsBf16<T>) {
    stage_pf_bf16(reinterpret_cast<uint32_t*>(s_pf), kFB, B,
                  [&](int) { return pf; }, [&](int row) { return b0 + row; },
                  tid, kFT);
  } else if constexpr (kMode == 1) {
    for (int e = tid; e < kFB * kPP; e += kFT) {
      const int row = e / kPP, p = e % kPP, b = b0 + row;
      s_pf[row * kSF + p] = (b < B && p < kP) ? pf[(size_t)b * kP + p] : 0.f;
    }
  }

  // forward MMA (mode 1): warp -> m-tile (16 of the 32 rows), 3 of the 6
  // n-tiles, one half of the feature axis
  const int fm = warp & 1, fn0 = 3 * ((warp >> 1) & 1), kh = warp >> 2;
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
  const int sb = tid >> 3, sv = (tid & 7) * 2;

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
    const float* s_vs = smem + kBOffVs + buf * 3 * kFV;
    // the f32 cotangent tile: the staged one, or (bf16) the widened copy
    // step 2 writes
    float* s_g = kIsBf16<G> ? smem + kBOffGw
                            : reinterpret_cast<float*>(g_buf(buf));
    float* s_vo = kMode == 1 || kIsBf16<T> ? s_x : s_x + buf * kFB * kSX;

    // 1. mode 1: the two halves of vph (32 x 48) = pf (32 x 208) . pd
    //    (208 x 48) on the tensor cores
    if constexpr (kMode == 1 && kIsBf16<T>) {
      vph_mma_bf16<1>(reinterpret_cast<const uint32_t*>(s_pf), s_pd,
                      s_x + kh * kFB * kSX, fm, fn0, kh * kPHalf<T>,
                      kh ? kPP : kPHalf<T>, q.gid, q.tig);
      __syncthreads();
    } else if constexpr (kMode == 1) {
      vph_mma(s_pf, s_pd, s_x + kh * kFB * kSX, fm, fn0, kh * kPH,
              (kh + 1) * kPH, q.gid, q.tig);
      __syncthreads();
    }

    // 2. the blend of A's rotation part (SIMT), vp and gvp = M^T g
    {
      float m[2][9];
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int c = 0; c < 9; ++c) m[e][c] = 0.f;
      const float* a = s_A + sb * kSA;
#pragma unroll 2
      for (int j0 = 0; j0 < kJ; j0 += 4) {
        float2 w[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) w[jj] = ld2(s_w + (j0 + jj) * kSW + sv);
#pragma unroll
        for (int c = 0; c < 9; ++c) {
          const float4 x = *reinterpret_cast<const float4*>(a + c * kJ + j0);
          m[0][c] += x.x * w[0].x; m[1][c] += x.x * w[0].y;
          m[0][c] += x.y * w[1].x; m[1][c] += x.y * w[1].y;
          m[0][c] += x.z * w[2].x; m[1][c] += x.z * w[2].y;
          m[0][c] += x.w * w[3].x; m[1][c] += x.w * w[3].y;
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int o = sb * kSX + sv + e;
        float g0, g1, g2;
        if constexpr (kIsBf16<G>) {
          const G* sg = g_buf(buf);
          g0 = __bfloat162float(sg[o]);
          g1 = __bfloat162float(sg[o + kFV]);
          g2 = __bfloat162float(sg[o + 2 * kFV]);
          s_g[o] = g0; s_g[o + kFV] = g1; s_g[o + 2 * kFV] = g2;
        } else {
          g0 = s_g[o]; g1 = s_g[o + kFV]; g2 = s_g[o + 2 * kFV];
        }
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          s_gvp[o + k * kFV] = m[e][k] * g0 + m[e][3 + k] * g1 + m[e][6 + k] * g2;
          if constexpr (kMode == 1)
            s_x[o + k * kFV] = s_x[o + k * kFV] + s_x[kFB * kSX + o + k * kFV] +
                               s_vs[k * kFV + sv + e];
          else if constexpr (kIsBf16<T>)
            s_vo[o + k * kFV] =
                __bfloat162float(s_vpt[buf * kFB * kSX + o + k * kFV]);
        }
      }
    }
    __syncthreads();

    // 3-5. gpf, gA and the tile's gvsh (skin_common.cuh)
    tile_grads(q, gpf_acc, ga_acc, s_gvp, s_g, s_vo, s_pd, s_w, V, v0, bt,
               gvsh_part);
    __syncthreads();
  }

  store_grad_parts(q, B, b0, r, gpf_acc, ga_acc, gpf_part, ga_part);
}

// Copy width (elements) for a (B,3,V) operand: two where V is even and its
// address is aligned to two elements, else one.
template <typename E>
int copy_width(const E* p, int V) {
  return V % 2 == 0 && reinterpret_cast<uintptr_t>(p) % (2 * sizeof(E)) == 0
             ? 2 : 1;
}

template <int kMode, typename T, typename G>
cudaError_t launch_bwd(int B, int V, int R, const float* pf, const float* A,
                       const float* vsh, const T* pd, const T* W,
                       const G* g, const T* vp_in, float* gpf_part,
                       float* ga_part, float* gvsh_part, cudaStream_t stream) {
  constexpr size_t smem = kBSmemBytes<G>;
  if (cudaError_t err = cudaFuncSetAttribute(
          skin_bwd_kernel<kMode, T, G>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
    return err;
  skin_bwd_kernel<kMode, T, G><<<dim3(R, cdiv(B, kFB)), kFT, smem, stream>>>(
      B, V, R, copy_width(g, V), vp_in ? copy_width(vp_in, V) : 1, pf, A, vsh,
      pd, W, g, vp_in, gpf_part, ga_part, gvsh_part);
  return cudaGetLastError();
}

// mode 1 with G = bf16: the bf16-cotangent instantiation
template <typename T, typename G = float>
int bwd_attributes(int mode, int* out) {
  if (mode != 1 && (mode != 2 || kIsBf16<G>))
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t err =
      mode == 1 ? cudaFuncGetAttributes(&a, skin_bwd_kernel<1, T, G>)
                : cudaFuncGetAttributes(&a, skin_bwd_kernel<2, T>);
  if (err) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)kBSmemBytes<G>;
  out[3] = (int)a.localSizeBytes;
  return 0;
}

template <typename T, typename G>
int skin_bwd(int B, int V, const float* pf, const float* A, const float* vsh,
             const T* pd, const T* W, const G* g, const T* vp_in,
             float* scratch, float* gpf, float* gA, float* gvsh,
             cudaStream_t stream) {
  if (bad_shape(B, V)) return (int)cudaErrorInvalidValue;
  if (kIsBf16<G> && vp_in) return (int)cudaErrorInvalidValue;
  const int R = fused_ranges(B, V), n_bt = cdiv(B, kFB);
  float* gpf_part = scratch;
  float* ga_part = gpf_part + (size_t)R * B * kP;
  float* gvsh_part = ga_part + (size_t)R * B * kGL;
  cudaError_t err;
  if constexpr (kIsBf16<G>)
    err = launch_bwd<1, T, G>(B, V, R, pf, A, vsh, pd, W, g, nullptr,
                              gpf_part, ga_part, gvsh_part, stream);
  else
    err = vp_in ? launch_bwd<2, T, G>(B, V, R, pf, A, vsh, pd, W, g, vp_in,
                                      gpf_part, ga_part, gvsh_part, stream)
                : launch_bwd<1, T, G>(B, V, R, pf, A, vsh, pd, W, g, nullptr,
                                      gpf_part, ga_part, gvsh_part, stream);
  if (err) return (int)err;
  const int n_gpf = B * kP, n_ga = B * kGL, n_gvsh = 3 * V;
  range_reduce_kernel<<<cdiv(n_gpf + n_ga + n_gvsh, 256), 256, 0, stream>>>(
      n_gpf, n_ga, n_gvsh, R, n_bt, gpf_part, ga_part, gvsh_part, gpf, gA,
      gvsh);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int nemo_v2v_pair_attributes(int* out);       // csrc/v2v.cu
extern "C" int nemo_v2v_pair_attributes_bf16(int* out);  // csrc/v2v.cu

// mesh_bf16: the mesh (K3f's vertices, K3b's cotangent) in f32 (0) or
// bf16 (1), each entry point's instantiations picked by it as nemo_mlp_fwd's
// by arith; the _bf16 twins take bf16 tables.

namespace {

template <typename T>
int skin_fwd_mesh(int mesh_bf16, int B, int V, const float* pf,
                  const float* A, const float* vsh, const T* pd, const T* W,
                  void* verts, cudaStream_t stream) {
  if (bad_shape(B, V) || (mesh_bf16 != 0 && mesh_bf16 != 1))
    return (int)cudaErrorInvalidValue;
  return mesh_bf16
             ? (int)launch_skin_fwd<1, T>(B, V, pf, A, nullptr, nullptr, vsh,
                                          pd, W, static_cast<bf16*>(verts),
                                          nullptr, nullptr, stream)
             : (int)launch_skin_fwd<1, T>(B, V, pf, A, nullptr, nullptr, vsh,
                                          pd, W, static_cast<float*>(verts),
                                          nullptr, nullptr, stream);
}

template <typename T>
int skin_fwd_mesh_attributes(int sides, int mesh_bf16, int* out) {
  if (sides == 1 && mesh_bf16 == 0) return skin_fwd_attributes<1, T>(out);
  if (sides == 1 && mesh_bf16 == 1)
    return skin_fwd_attributes<1, T, bf16>(out);
  if (sides == 2 && mesh_bf16 == 0)
    return kIsBf16<T> ? nemo_v2v_pair_attributes_bf16(out)
                      : nemo_v2v_pair_attributes(out);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int skin_bwd_mesh(int mesh_bf16, int B, int V, const float* pf,
                  const float* A, const float* vsh, const T* pd, const T* W,
                  const void* g, const T* vp_in, float* scratch, float* gpf,
                  float* gA, float* gvsh, cudaStream_t stream) {
  if (mesh_bf16 == 1)
    return skin_bwd<T, bf16>(B, V, pf, A, vsh, pd, W,
                             static_cast<const bf16*>(g), vp_in, scratch, gpf,
                             gA, gvsh, stream);
  if (mesh_bf16 != 0) return (int)cudaErrorInvalidValue;
  return skin_bwd<T, float>(B, V, pf, A, vsh, pd, W,
                            static_cast<const float*>(g), vp_in, scratch, gpf,
                            gA, gvsh, stream);
}

// mode 1 or 2 of the f32-mesh kernel, mode 1 of the bf16-mesh one
template <typename T>
int skin_bwd_mesh_attributes(int mode, int mesh_bf16, int* out) {
  if (mesh_bf16 == 0) return bwd_attributes<T>(mode, out);
  if (mesh_bf16 == 1) return bwd_attributes<T, bf16>(mode, out);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// pf (B,207), A (B,24,12) on a 16-byte boundary, vsh (3,V), pd (207,3,V),
// W (24,V) (on 8-byte boundaries where V is even), all f32 contiguous on
// one device; output verts (B,3,V) in the mesh's type (bf16: the f32
// vertices rounded to nearest even).
extern "C" int nemo_skin_fwd(int mesh_bf16, int B, int V, const float* pf,
                             const float* A, const float* vsh,
                             const float* pd, const float* W, void* verts,
                             cudaStream_t stream) {
  return skin_fwd_mesh<float>(mesh_bf16, B, V, pf, A, vsh, pd, W, verts,
                              stream);
}

// The same with bf16 tables: pd and W bf16 (on 4-byte boundaries where V
// is even).
extern "C" int nemo_skin_fwd_bf16(int mesh_bf16, int B, int V,
                                  const float* pf, const float* A,
                                  const float* vsh, const bf16* pd,
                                  const bf16* W, void* verts,
                                  cudaStream_t stream) {
  return skin_fwd_mesh<bf16>(mesh_bf16, B, V, pf, A, vsh, pd, W, verts,
                             stream);
}

// Registers, shared memory and local memory (spills) of the forward kernel
// skin_fwd_kernel<sides, T> (1: K3f, 2: K2's pair mode, which writes no
// mesh), as the CUDA runtime reports them: out[0..3] = registers, static
// and dynamic shared memory bytes, local bytes. The _bf16 twin: T = bf16.
extern "C" int nemo_skin_fwd_attributes(int sides, int mesh_bf16, int* out) {
  return skin_fwd_mesh_attributes<float>(sides, mesh_bf16, out);
}
extern "C" int nemo_skin_fwd_attributes_bf16(int sides, int mesh_bf16,
                                             int* out) {
  return skin_fwd_mesh_attributes<bf16>(sides, mesh_bf16, out);
}

// Floats of scratch nemo_skin_bwd needs at (B, V): the per-block gpf, gA
// and gvsh partials. -1 for a shape it refuses.
extern "C" int nemo_skin_bwd_scratch_floats(int B, int V) {
  if (bad_shape(B, V)) return -1;
  const long long n = grad_partial_floats(B, V, fused_ranges(B, V));
  return n < (1LL << 31) ? (int)n : -1;
}

// Registers, shared memory and local memory (spills) of the one-pass
// backward kernel (mode 1: vp recomputed, 2: stored, f32 mesh only), as the
// CUDA runtime reports them: out[0..3] = registers, static and dynamic
// shared memory bytes, local bytes. The _bf16 twin: bf16 tables.
extern "C" int nemo_skin_bwd_attributes(int mode, int mesh_bf16, int* out) {
  return skin_bwd_mesh_attributes<float>(mode, mesh_bf16, out);
}
extern "C" int nemo_skin_bwd_attributes_bf16(int mode, int mesh_bf16,
                                             int* out) {
  return skin_bwd_mesh_attributes<bf16>(mode, mesh_bf16, out);
}

// Inputs as nemo_skin_fwd (A on a 16-byte boundary) plus the cotangent g
// (B,3,V) in the mesh's type (bf16: read in bf16, on a 4-byte boundary
// where V is even, else any). vp_in: the stored posed vertices (B,3,V), or
// null to recompute them (null with a bf16 mesh). scratch:
// nemo_skin_bwd_scratch_floats(B, V) floats. Outputs gpf (B,207), gA
// (B,24,12), gvsh (3,V).
extern "C" int nemo_skin_bwd(int mesh_bf16, int B, int V, const float* pf,
                             const float* A, const float* vsh,
                             const float* pd, const float* W, const void* g,
                             const float* vp_in, float* scratch, float* gpf,
                             float* gA, float* gvsh, cudaStream_t stream) {
  return skin_bwd_mesh<float>(mesh_bf16, B, V, pf, A, vsh, pd, W, g, vp_in,
                              scratch, gpf, gA, gvsh, stream);
}

// The same with bf16 tables: pd, W and a stored vp_in bf16 (pd and W on
// 4-byte boundaries where V is even).
extern "C" int nemo_skin_bwd_bf16(int mesh_bf16, int B, int V,
                                  const float* pf, const float* A,
                                  const float* vsh, const bf16* pd,
                                  const bf16* W, const void* g,
                                  const bf16* vp_in, float* scratch,
                                  float* gpf, float* gA, float* gvsh,
                                  cudaStream_t stream) {
  return skin_bwd_mesh<bf16>(mesh_bf16, B, V, pf, A, vsh, pd, W, g, vp_in,
                             scratch, gpf, gA, gvsh, stream);
}
