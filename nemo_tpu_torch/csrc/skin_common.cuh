// Shared pieces of the skinning kernels (csrc/skin.cu, csrc/v2v.cu): the
// table sizes and the second-pass reductions that turn a cotangent on the
// vertices into the gradients of the skinning inputs.
//
// With vph = [vp; 1] the posed vertices, M = A . W the blended transforms
// and g (B,3,V) any f32 cotangent on the skinned vertices,
//   gvp[b,k,v]     = sum_i M[b,4i+k,v] g[b,i,v]          (the first pass)
//   gpf[b,p]       = sum_v sum_k gvp[b,k,v] posedirs_t[p,k,v]
//   gA[b,j,i*4+k]  = sum_v g[b,i,v] vph[b,k,v] W_t[j,v]
//   gvsh[k,v]      = sum_b gvp[b,k,v]
// The TPU kernels accumulate gpf/gA along a sequential vertex grid. On
// Hopper, blocks run in parallel in no order, so the first pass writes gvp
// (and vp) to scratch and these kernels reduce across tiles. Every sum runs
// in a fixed order with no atomics, so repeated runs are bit-identical.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kP = 207;   // pose features (23 joints x 9)
constexpr int kJ = 24;    // joints
constexpr int kL = 12;    // 3x4 transform components
constexpr int kTV = 32;   // vertices per tile (one per lane)
constexpr int kTY = 8;    // warps per tile
constexpr int kRB = 4;    // batch rows per thread
constexpr int kTB = kTY * kRB;  // batch rows per tile
constexpr int kPK = 16;   // pose-feature slice staged per step

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

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

// gpf[b,p] = sum_c gvp[b,c] pd[p,c] over c < K = 3V: a 32 x 32 output tile
// per block, 32-wide K slices staged in shared memory, 4 outputs a thread.
constexpr int kGT = 32, kGK = 32;

__global__ void __launch_bounds__(kGT * 8)
gpf_kernel(int B, int K, const float* __restrict__ gvp,
           const float* __restrict__ pd, float* __restrict__ gpf) {
  __shared__ float s_a[kGT][kGK + 1];
  __shared__ float s_b[kGT][kGK + 1];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kGT + tx;
  const int p0 = blockIdx.x * kGT, b0 = blockIdx.y * kGT;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < K; k0 += kGK) {
    for (int e = tid; e < kGT * kGK; e += kGT * 8) {
      const int r = e / kGK, c = e % kGK, kk = k0 + c;
      s_a[r][c] = (b0 + r < B && kk < K) ? gvp[(size_t)(b0 + r) * K + kk] : 0.f;
      s_b[r][c] = (p0 + r < kP && kk < K) ? pd[(size_t)(p0 + r) * K + kk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kGK; ++c) {
      const float bv = s_b[tx][c];
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r] += s_a[ty * 4 + r][c] * bv;
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int b = b0 + ty * 4 + r, p = p0 + tx;
    if (b < B && p < kP) gpf[(size_t)b * kP + p] = acc[r];
  }
}

// gA[b,j,i*4+k] = sum_v g[b,i,v] vph[b,k,v] W[j,v] for any f32 cotangent g:
// one block per batch row, one thread per (j, l) output, vertex slices
// staged in shared memory.
constexpr int kVC = 64;

__global__ void __launch_bounds__(kJ * kL)
ga_kernel(int V, const float* __restrict__ g, const float* __restrict__ vp,
          const float* __restrict__ W, float* __restrict__ gA) {
  __shared__ float s_g[3][kVC + 1];
  __shared__ float s_v[3][kVC + 1];
  __shared__ float s_w[kJ][kVC + 1];
  const int b = blockIdx.x, t = threadIdx.x;
  const int j = t / kL, l = t % kL, i = l / 4, k = l % 4;
  const size_t base = (size_t)b * 3 * V;
  float acc = 0.f;
  for (int v0 = 0; v0 < V; v0 += kVC) {
    for (int e = t; e < 3 * kVC; e += kJ * kL) {
      const int c = e / kVC, x = e % kVC, vv = v0 + x;
      const bool ok = vv < V;
      s_g[c][x] = ok ? g[base + (size_t)c * V + vv] : 0.f;
      s_v[c][x] = ok ? vp[base + (size_t)c * V + vv] : 0.f;
    }
    for (int e = t; e < kJ * kVC; e += kJ * kL) {
      const int jj = e / kVC, x = e % kVC, vv = v0 + x;
      s_w[jj][x] = vv < V ? W[(size_t)jj * V + vv] : 0.f;
    }
    __syncthreads();
    for (int x = 0; x < kVC; ++x) {
      const float gm = k < 3 ? s_g[i][x] * s_v[k][x] : s_g[i][x];
      acc += gm * s_w[j][x];
    }
    __syncthreads();
  }
  gA[((size_t)b * kJ + j) * kL + l] = acc;
}

// gvsh[c] = sum_b gvp[b,c] for c < K = 3V, batch rows summed in order.
__global__ void __launch_bounds__(256)
gvsh_kernel(int B, int K, const float* __restrict__ gvp, float* __restrict__ gvsh) {
  const int c = blockIdx.x * 256 + threadIdx.x;
  if (c >= K) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += gvp[(size_t)b * K + c];
  gvsh[c] = s;
}

// The second pass: gpf, gA and gvsh from the scratch the first pass wrote.
inline cudaError_t launch_skin_grads(int B, int V, const float* g,
                                     const float* vp, const float* gvp,
                                     const float* pd, const float* W,
                                     float* gpf, float* gA, float* gvsh,
                                     cudaStream_t stream) {
  const int K = 3 * V;
  gpf_kernel<<<dim3(cdiv(kP, kGT), cdiv(B, kGT)), dim3(kGT, 8), 0, stream>>>(
      B, K, gvp, pd, gpf);
  if (cudaError_t err = cudaGetLastError()) return err;
  ga_kernel<<<B, kJ * kL, 0, stream>>>(V, g, vp, W, gA);
  if (cudaError_t err = cudaGetLastError()) return err;
  gvsh_kernel<<<cdiv(K, 256), 256, 0, stream>>>(B, K, gvp, gvsh);
  return cudaGetLastError();
}

}  // namespace
