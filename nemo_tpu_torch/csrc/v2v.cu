// The VPoser v2v-L1 prior in one kernel pass plus gradient reductions: the
// Hopper port of nemo_tpu/ops/lbs_pallas.py _v2v_fwdbwd_kernel (fused
// mode), and of _v2v_fwd_kernel / _v2v_fwd_kernel_vp (total-only and pair
// modes).
//
// For every (batch row b, vertex v), both pose sets are skinned,
//   vph[k]  = sum_p pf[b,p] posedirs_t[p,k,v] + v_shaped_t[k,v],  vph[3] = 1
//   M[l]    = sum_j A[b,j,l] W_t[j,v]                     (l = i*4 + k)
//   vert[i] = M[4i+3] + sum_k M[4i+k] vph[k]
// and total = sum |vert_rec - vert_orig|. The modes:
//   0 total only (the undifferentiated call);
//   1 fused: also the orig-side gradients under the raw cotangent
//     g = sign(rec - orig) (sign(0) = 0), by the second pass of
//     skin_common.cuh;
//   2 pair: writes sign (B,3,V) and, if asked, the orig-side posed vertices
//     vp (B,3,V), and stops; the backward runs K3b (csrc/skin.cu) on them.
//     The sign is stored as f32: {-1, 0, 1} is exact there, and K3b takes
//     any f32 cotangent, so one gradient code path serves both.
//
// What bounds it on the H100: arithmetic on the CUDA cores in f32,
// 2*B*V*2*(3*207 + 12*24 + 12) FLOP forward (13.0 GFLOP at B=512, V=6890)
// and 2*B*V*(12*24 + 9 + 3*207) for the gradients (6.5 GFLOP); the 17 MB
// posedirs table fits the 50 MB L2. The design keeps every contraction
// inside hand-written kernels:
//   1. v2v_tile_kernel: a 32-row x 32-vertex tile per block. pf and a
//      16-feature slice of posedirs are staged in shared memory, and each
//      thread keeps 4 rows x 2 sides x 3 coordinates of vph in registers, so
//      one posedirs load feeds 8 FMAs. Both sides share the table loads.
//      The blend M reads A with warp-uniform (broadcast) loads and W
//      coalesced along v. The |diff| partial of each block is reduced in
//      shared memory in a fixed order.
//   2. In fused mode the tile kernel writes sign, vph_o and gvp (B,3,V) to
//      scratch, and the second-pass kernels of skin_common.cuh reduce across
//      tiles. The TPU kernel keeps gvp on-chip and accumulates gpf/gA in its
//      sequential V grid; on Hopper, blocks run in parallel in no order, so
//      the port reduces in a second pass. Keeping gvp on-chip (no (B,3,V)
//      round trip) is later work.
// Every reduction runs in a fixed order with no atomics, so repeated runs
// are bit-identical. The ragged vertex edge is masked (no padded tables).

#include "skin_common.cuh"

namespace {

__global__ void __launch_bounds__(kTV * kTY)
v2v_tile_kernel(int B, int V, const float* __restrict__ pf_o,
                const float* __restrict__ A_o, const float* __restrict__ pf_r,
                const float* __restrict__ A_r, const float* __restrict__ vsh,
                const float* __restrict__ pd, const float* __restrict__ W,
                int mode, float* __restrict__ partial, float* __restrict__ sign,
                float* __restrict__ vp, float* __restrict__ gvp) {
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
      float vo[3], vr[3], g[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) { vo[k] = ao[r][k] + vs[k]; vr[k] = ar[r][k] + vs[k]; }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        float o = Mo[4 * i + 3];
        float q = Mr[4 * i + 3];
#pragma unroll
        for (int k = 0; k < 3; ++k) { o += Mo[4 * i + k] * vo[k]; q += Mr[4 * i + k] * vr[k]; }
        const float diff = q - o;
        local += fabsf(diff);
        g[i] = (float)(diff > 0.f) - (float)(diff < 0.f);
      }
      if (mode != 0) {
        const size_t base = (size_t)b * V3 + v;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          sign[base + (size_t)k * V] = g[k];
          if (vp) vp[base + (size_t)k * V] = vo[k];
          if (mode == 1)
            gvp[base + (size_t)k * V] = Mo[k] * g[0] + Mo[4 + k] * g[1] + Mo[8 + k] * g[2];
        }
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

}  // namespace

extern "C" int nemo_v2v_num_partials(int B, int V) {
  return cdiv(V, kTV) * cdiv(B, kTB);
}

// pf_* (B,207), A_* (B,24,12), vsh (3,V), pd (207,3,V), W (24,V), all f32
// contiguous on one device. partial: nemo_v2v_num_partials(B, V) floats;
// total: 1 float. mode 0: total only; sign, vp, gvp, gpf, gA, gvsh may be
// null. mode 1 (fused): sign, vp, gvp scratch (B,3,V) each and outputs
// gpf (B,207), gA (B,24,12), gvsh (3,V). mode 2 (pair): outputs sign
// (B,3,V) and, unless vp is null, vp (B,3,V); gvp, gpf, gA, gvsh unused.
extern "C" int nemo_v2v_l1(int B, int V, const float* pf_o, const float* A_o,
                           const float* pf_r, const float* A_r,
                           const float* vsh, const float* pd, const float* W,
                           int mode, float* partial, float* sign, float* vp,
                           float* gvp, float* total, float* gpf, float* gA,
                           float* gvsh, cudaStream_t stream) {
  if (B <= 0 || V <= 0 || cdiv(B, kTB) > 65535 || mode < 0 || mode > 2 ||
      (mode != 0 && !sign) || (mode == 1 && (!vp || !gvp)))
    return (int)cudaErrorInvalidValue;
  const dim3 tile_grid(cdiv(V, kTV), cdiv(B, kTB));
  v2v_tile_kernel<<<tile_grid, dim3(kTV, kTY), 0, stream>>>(
      B, V, pf_o, A_o, pf_r, A_r, vsh, pd, W, mode, partial, sign, vp, gvp);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  total_kernel<<<1, 256, 0, stream>>>(nemo_v2v_num_partials(B, V), partial, total);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  if (mode != 1) return 0;
  return (int)launch_skin_grads(B, V, sign, vp, gvp, pd, W, gpf, gA, gvsh,
                                stream);
}
