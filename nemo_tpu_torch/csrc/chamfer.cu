// One-way nearest-neighbour search: the Hopper port of
// nemo_tpu/ops/chamfer.py (_chamfer_kernel / _nn_one_way_pallas, K4).
//
// For every point a[t, n] of frame t, over the candidate set b[t, :]:
//
//   d(n, m)   = (|a_n|^2 + |b_m|^2) - 2 (a_n . b_m)
//   |x|^2     = (x0 x0 + x1 x1) + x2 x2
//   a . b     = (a0 b0 + a1 b1) + a2 b2
//   dist[t,n] = min_m d(n, m),   idx[t, n] = the lowest m that attains it
//
// The running minimum takes a candidate only under a strict <, so the lowest
// index wins a tie, as the argmin of _nn_one_way_xla does. The (N, M)
// distance matrix never reaches memory, and the ragged edge of b is masked
// by the loop bound instead of JAX's 1e15 sentinel rows.
//
// Every product and sum is written with the _rn intrinsics in the order the
// plain PyTorch version (ops/chamfer.py, nn_one_way_plain) evaluates it:
// nvcc would otherwise contract a*b + c into an FMA, and a contracted
// distance flips the argmin at near-ties. So kernel and plain version agree
// bit for bit on the card, distances and indices.
//
// Design: one thread per query point, blockIdx.y over frames; a block stages
// the frame's candidates through shared memory kTile at a time as
// (x, y, z, |b|^2), so |b|^2 is computed once per candidate and block, and
// every thread of a warp reads the same candidate (a broadcast). What bounds
// it on the H100: f32 operations, 9 per (query, candidate) pair (3 products
// and 2 sums for the dot, the product by 2, one sum, one difference, one
// comparison), all in the inner loop. Several queries per thread and
// splitting M across warps with a lowest-index merge are left for later.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;  // query points a block
constexpr int kTile = 1024;    // candidates staged at a time (16 KB)

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

__global__ void __launch_bounds__(kThreads)
nn_one_way_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  int N, int M, float* __restrict__ dist,
                  int64_t* __restrict__ idx) {
  __shared__ float4 tile[kTile];
  const int t = blockIdx.y;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const bool live = n < N;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  if (live) {
    const float* p = a + ((size_t)t * N + n) * 3;
    a0 = p[0];
    a1 = p[1];
    a2 = p[2];
  }
  const float asq = sq_norm(a0, a1, a2);
  const float* bt = b + (size_t)t * M * 3;
  float best = __int_as_float(0x7f800000);  // +inf
  int best_m = 0;
  for (int m0 = 0; m0 < M; m0 += kTile) {
    const int cnt = min(kTile, M - m0);
    __syncthreads();  // the previous tile is no longer read
    for (int k = threadIdx.x; k < cnt; k += kThreads) {
      const float* p = bt + (size_t)(m0 + k) * 3;
      const float x = p[0], y = p[1], z = p[2];
      tile[k] = make_float4(x, y, z, sq_norm(x, y, z));
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < cnt; ++k) {
      const float4 c = tile[k];
      const float dot = __fadd_rn(__fadd_rn(__fmul_rn(a0, c.x),
                                            __fmul_rn(a1, c.y)),
                                  __fmul_rn(a2, c.z));
      const float d = __fsub_rn(__fadd_rn(asq, c.w), __fmul_rn(2.f, dot));
      if (d < best) {
        best = d;
        best_m = m0 + k;
      }
    }
  }
  if (live) {
    dist[(size_t)t * N + n] = best;
    idx[(size_t)t * N + n] = best_m;
  }
}

}  // namespace

// a (T, N, 3), b (T, M, 3) f32 contiguous -> dist (T, N) f32, idx (T, N)
// int64. One launch covers every frame.
extern "C" int nemo_chamfer_nn(const float* a, const float* b, int T, int N,
                               int M, float* dist, int64_t* idx,
                               cudaStream_t stream) {
  if (T <= 0 || N <= 0 || M <= 0 || T > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kThreads - 1) / kThreads, T);
  nn_one_way_kernel<<<grid, kThreads, 0, stream>>>(a, b, N, M, dist, idx);
  return (int)cudaGetLastError();
}
