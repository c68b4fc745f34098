// Plain linear blend skinning and its VJP: the Hopper port of
// nemo_tpu/ops/lbs_pallas.py _fwd_kernel (K3f, called by _fwd_pallas) and
// _bwd_kernel / _bwd_kernel_vp (K3b, called by _bwd_pallas).
//
// K3f: for every (batch row b, vertex v),
//   vph[k]  = sum_p pf[b,p] posedirs_t[p,k,v] + v_shaped_t[k,v],  vph[3] = 1
//   M[l]    = sum_j A[b,j,l] W_t[j,v]                     (l = i*4 + k)
//   vert[i] = M[4i+3] + sum_k M[4i+k] vph[k]
// written as verts_t (B,3,V). K3b: for any f32 cotangent g (B,3,V), the
// gradients gpf (B,207), gA (B,24,12) and gvsh (3,V) of skin_common.cuh,
// with vp either recomputed from pf or read from a stored (B,3,V) copy.
//
// What bounds it on the H100: arithmetic on the CUDA cores in f32. K3f is
// 2*B*V*921 FLOP (1.81 GFLOP at B=960, V=1024), K3b 2*B*V*(621 + 216 + 9 +
// 621 + 297) with vp recomputed and 621 MACs fewer per (b, v) with vp
// stored: the backward blends only the rotation part of M (gvp reads it,
// gA reads [vp; 1]), 9 of the 12 components. The posedirs table (2.5 KB a vertex) sits in L2 at these sizes.
// The design is one side of v2v_tile_kernel (csrc/v2v.cu): a 32-row x
// 32-vertex tile per block, pf and a 16-feature slice of posedirs staged in
// shared memory, 4 rows x 3 coordinates of vph in registers a thread, the
// blend M from warp-uniform A loads and W coalesced along v, so the (B,V,12)
// blended transforms never reach memory. In the backward the same tile
// writes gvp (and vp, when it recomputes it) to scratch, and the
// second-pass kernels of skin_common.cuh reduce across tiles in a fixed
// order (no atomics, bit-stable). The ragged vertex edge is masked: there
// are no padded tables, and outputs have exactly V columns.

#include "skin_common.cuh"

namespace {

// kMode 0: forward, out = verts. 1: backward first pass recomputing vp,
// out = gvp and vp_out = vp. 2: backward first pass from a stored vp_in,
// out = gvp.
template <int kMode>
__global__ void __launch_bounds__(kTV * kTY)
skin_tile_kernel(int B, int V, const float* __restrict__ pf,
                 const float* __restrict__ A, const float* __restrict__ vsh,
                 const float* __restrict__ pd, const float* __restrict__ W,
                 const float* __restrict__ g, const float* __restrict__ vp_in,
                 float* __restrict__ out, float* __restrict__ vp_out) {
  __shared__ float s_pf[kTB][kPK];
  __shared__ float s_pd[kPK][3][kTV];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTV + tx;
  const int v0 = blockIdx.x * kTV, b0 = blockIdx.y * kTB;
  const int v = v0 + tx;
  const size_t V3 = 3 * (size_t)V;

  float a[kRB][3];
#pragma unroll
  for (int r = 0; r < kRB; ++r)
#pragma unroll
    for (int k = 0; k < 3; ++k) a[r][k] = 0.f;

  if (kMode != 2) {
    for (int p0 = 0; p0 < kP; p0 += kPK) {
      for (int e = tid; e < kTB * kPK; e += kTV * kTY) {
        const int r = e / kPK, q = e % kPK, b = b0 + r, p = p0 + q;
        s_pf[r][q] = (b < B && p < kP) ? pf[(size_t)b * kP + p] : 0.f;
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
          const float f = s_pf[ty * kRB + r][q];
          a[r][0] += f * d0; a[r][1] += f * d1; a[r][2] += f * d2;
        }
      }
      __syncthreads();
    }
  }

  if (v >= V) return;
  float w[kJ];
#pragma unroll
  for (int j = 0; j < kJ; ++j) w[j] = W[(size_t)j * V + v];
  float vs[3] = {0.f, 0.f, 0.f};
  if (kMode != 2) {
    vs[0] = vsh[v]; vs[1] = vsh[(size_t)V + v]; vs[2] = vsh[2 * (size_t)V + v];
  }
#pragma unroll
  for (int r = 0; r < kRB; ++r) {
    const int b = b0 + ty * kRB + r;
    if (b >= B) continue;
    float M[kL];
#pragma unroll
    for (int l = 0; l < kL; ++l) M[l] = 0.f;
    const float* a_row = A + (size_t)b * kJ * kL;
#pragma unroll 4
    for (int j = 0; j < kJ; ++j) {
#pragma unroll
      for (int l = 0; l < kL; ++l) {
        if (kMode != 0 && l % 4 == 3) continue;  // translation: unused
        M[l] += a_row[j * kL + l] * w[j];
      }
    }
    const size_t base = (size_t)b * V3 + v;
    float vo[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      vo[k] = kMode == 2 ? vp_in[base + (size_t)k * V] : a[r][k] + vs[k];
    if (kMode == 0) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        float o = M[4 * i + 3];
#pragma unroll
        for (int k = 0; k < 3; ++k) o += M[4 * i + k] * vo[k];
        out[base + (size_t)i * V] = o;
      }
    } else {
      const float g0 = g[base], g1 = g[base + V], g2 = g[base + 2 * (size_t)V];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        out[base + (size_t)k * V] = M[k] * g0 + M[4 + k] * g1 + M[8 + k] * g2;
        if (kMode == 1) vp_out[base + (size_t)k * V] = vo[k];
      }
    }
  }
}

bool bad_shape(int B, int V) {
  return B <= 0 || V <= 0 || cdiv(B, kTB) > 65535;
}

}  // namespace

// pf (B,207), A (B,24,12), vsh (3,V), pd (207,3,V), W (24,V), all f32
// contiguous on one device; output verts (B,3,V).
extern "C" int nemo_skin_fwd(int B, int V, const float* pf, const float* A,
                             const float* vsh, const float* pd, const float* W,
                             float* verts, cudaStream_t stream) {
  if (bad_shape(B, V)) return (int)cudaErrorInvalidValue;
  skin_tile_kernel<0><<<dim3(cdiv(V, kTV), cdiv(B, kTB)), dim3(kTV, kTY), 0,
                        stream>>>(B, V, pf, A, vsh, pd, W, nullptr, nullptr,
                                  verts, nullptr);
  return (int)cudaGetLastError();
}

// Inputs as nemo_skin_fwd plus the cotangent g (B,3,V). vp_in: the stored
// posed vertices (B,3,V), or null to recompute them into vp_scratch
// (B,3,V). gvp: scratch (B,3,V). Outputs gpf (B,207), gA (B,24,12),
// gvsh (3,V).
extern "C" int nemo_skin_bwd(int B, int V, const float* pf, const float* A,
                             const float* vsh, const float* pd, const float* W,
                             const float* g, const float* vp_in,
                             float* vp_scratch, float* gvp, float* gpf,
                             float* gA, float* gvsh, cudaStream_t stream) {
  if (bad_shape(B, V) || (!vp_in && !vp_scratch))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(cdiv(V, kTV), cdiv(B, kTB)), block(kTV, kTY);
  if (vp_in) {
    skin_tile_kernel<2><<<grid, block, 0, stream>>>(
        B, V, pf, A, vsh, pd, W, g, vp_in, gvp, nullptr);
  } else {
    skin_tile_kernel<1><<<grid, block, 0, stream>>>(
        B, V, pf, A, vsh, pd, W, g, nullptr, gvp, vp_scratch);
  }
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  return (int)launch_skin_grads(B, V, g, vp_in ? vp_in : vp_scratch, gvp, pd,
                                W, gpf, gA, gvsh, stream);
}
