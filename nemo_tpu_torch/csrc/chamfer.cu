// One-way nearest-neighbour search: the Hopper port of
// nemo_tpu/ops/chamfer.py (_chamfer_kernel / _nn_one_way_pallas, K4).
//
// For every point a[t, n] of frame t, over the candidate set b[t, :]:
//
//   d(n, m)   = (|a_n|^2 + |b_m|^2) - (2 a_n) . b_m
//   |x|^2     = (x0 x0 + x1 x1) + x2 x2
//   (2a) . b  = ((2a0) b0 + (2a1) b1) + (2a2) b2
//   dist[t,n] = min_m d(n, m),   idx[t, n] = the lowest m that attains it
//
// A NaN distance never wins; a query whose distances are all NaN or +inf
// gets +inf and index 0. Doubling the query first gives 2 (a . b) exactly
// unless a product is subnormal or overflows, and saves the product by 2 in
// the inner loop. Every product and sum is written with the _rn intrinsics
// in the order the plain PyTorch version (ops/chamfer.py, nn_one_way_plain)
// evaluates it: nvcc would otherwise contract a*b + c into an FMA, and a
// contracted distance flips the argmin at near-ties. So kernel and plain
// version agree bit for bit on the card, distances and indices.
//
// What bounds it on the H100: issued instructions. A (query, candidate)
// pair costs 3 products and 4 sums, none of which may become an FMA, and a
// minimum: 8 instructions, all on the CUDA cores. The design keeps every
// other instruction off the pair:
//
// - M split over the warps of a block. A block takes 32 Q queries of one
//   frame (each lane holds Q of them in registers, doubled, with |a|^2) and
//   `ranges` warps; warp w walks candidates [w R, (w + 1) R), R a multiple
//   of kGroup, in ascending order. The warp stages its range kStage
//   candidates at a time in its own slice of shared memory as (x, y, z,
//   |b|^2), so |b|^2 is computed once a candidate and block and no barrier
//   couples the warps; one float4 load (a broadcast) serves Q pairs.
// - Group minima. Over a group of kGroup candidates each query takes the
//   minimum with fminf (one instruction a pair, NaN dropped), and only then
//   compares it with its running best under a strict <, keeping the
//   group's first candidate: three instructions a group, not a compare and
//   two selects a pair. At the end of its range the warp reads the winning
//   group again and takes the first candidate whose distance equals the
//   best (the same bits: the same operations on the same values), its
//   distance and not fminf's result, so the lowest index wins a tie and -0
//   and +0 stay as the plain version has them.
// - An exact merge in a fixed order, without atomics: the warps' partials
//   (distance, index) meet in shared memory and each query folds them in
//   range order under a strict <, so the lowest index still wins a tie.
//   One launch a call, deterministic, no workspace.
//
// The host picks Q (4, 2 or 1) and the number of ranges (a power of two up
// to 16) from (T, N, M) so that both directions of the fit put enough warps
// on every SM (ops/chamfer.py, nn_split; ops/chamfer.py,
// nn_one_way_split_emulation repeats this arithmetic on the CPU). A
// tensor-core dot would change the rounding, and spatial culling would
// have to bound the expanded formula's cancellation: the contract is the
// exact brute-force argmin.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kGroup = 8;        // candidates a group minimum covers
constexpr int kStage = 128;      // candidates a warp stages at a time
constexpr int kMaxRanges = 16;   // warps a block

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// (x, y, z, |b|^2) of candidate m of a frame.
__device__ __forceinline__ float4 candidate(const float* __restrict__ bt,
                                            int m) {
  const float* p = bt + (size_t)m * 3;
  const float x = p[0], y = p[1], z = p[2];
  return make_float4(x, y, z, sq_norm(x, y, z));
}

// d(n, m) for a doubled query (a0, a1, a2) = 2 a_n with asq = |a_n|^2.
__device__ __forceinline__ float distance(float a0, float a1, float a2,
                                          float asq, float4 c) {
  const float dot2 = __fadd_rn(__fadd_rn(__fmul_rn(a0, c.x),
                                         __fmul_rn(a1, c.y)),
                               __fmul_rn(a2, c.z));
  return __fsub_rn(__fadd_rn(asq, c.w), dot2);
}

// Pads a group past the end of a range: its distance is +inf (NaN for a
// query with an infinite coordinate), so it is never a minimum.
__device__ __forceinline__ float4 pad() {
  return make_float4(0.f, 0.f, 0.f, __int_as_float(0x7f800000));
}

template <int Q>
__global__ void __launch_bounds__(32 * kMaxRanges, 2)
nn_one_way_split_kernel(const float* __restrict__ a,
                        const float* __restrict__ b, int N, int M, int range,
                        float* __restrict__ dist, int64_t* __restrict__ idx) {
  extern __shared__ float4 smem[];
  const int ranges = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.y;
  const int n0 = blockIdx.x * 32 * Q;
  const float inf = __int_as_float(0x7f800000);

  float a0[Q], a1[Q], a2[Q], asq[Q], best[Q];
  int group[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int n = n0 + q * 32 + lane;
    float x = 0.f, y = 0.f, z = 0.f;
    if (n < N) {
      const float* p = a + ((size_t)t * N + n) * 3;
      x = p[0];
      y = p[1];
      z = p[2];
    }
    asq[q] = sq_norm(x, y, z);
    a0[q] = __fmul_rn(2.f, x);
    a1[q] = __fmul_rn(2.f, y);
    a2[q] = __fmul_rn(2.f, z);
    best[q] = inf;
    group[q] = -1;
  }

  const float* bt = b + (size_t)t * M * 3;
  float4* tile = smem + warp * kStage;
  const int lo = min(warp * range, M), hi = min(lo + range, M);
  for (int s = lo; s < hi; s += kStage) {
    const int cnt = min(kStage, hi - s);
    const int groups = (cnt + kGroup - 1) / kGroup;
    __syncwarp();  // the previous stage is no longer read
    for (int k = lane; k < groups * kGroup; k += 32)
      tile[k] = k < cnt ? candidate(bt, s + k) : pad();
    __syncwarp();
    for (int g = 0; g < groups; ++g) {
      const float4* c = tile + g * kGroup;
      float gmin[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q)
        gmin[q] = distance(a0[q], a1[q], a2[q], asq[q], c[0]);
#pragma unroll
      for (int k = 1; k < kGroup; ++k) {
        const float4 ck = c[k];
#pragma unroll
        for (int q = 0; q < Q; ++q)
          gmin[q] = fminf(gmin[q], distance(a0[q], a1[q], a2[q], asq[q], ck));
      }
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        if (gmin[q] < best[q]) {
          best[q] = gmin[q];
          group[q] = s + g * kGroup;
        }
      }
    }
  }

  // The range's partial: the first candidate of the winning group whose
  // distance equals the group minimum, read again from device memory.
  float pd[Q];
  int pm[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    pd[q] = inf;
    pm[q] = 0;
    if (group[q] >= 0) {
      for (int m = group[q]; m < min(group[q] + kGroup, hi); ++m) {
        const float d = distance(a0[q], a1[q], a2[q], asq[q],
                                 candidate(bt, m));
        if (d == best[q]) {
          pd[q] = d;
          pm[q] = m;
          break;
        }
      }
    }
  }

  // Fold the ranges' partials in range order under a strict <.
  __syncthreads();  // every warp is done with its tile
  float* sd = reinterpret_cast<float*>(smem);     // [ranges][32 Q]
  int* sm = reinterpret_cast<int*>(sd + ranges * 32 * Q);
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    sd[warp * 32 * Q + q * 32 + lane] = pd[q];
    sm[warp * 32 * Q + q * 32 + lane] = pm[q];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < 32 * Q; j += blockDim.x) {
    const int n = n0 + j;
    if (n >= N) continue;
    float bd = inf;
    int bm = 0;
    for (int w = 0; w < ranges; ++w) {
      const float d = sd[w * 32 * Q + j];
      if (d < bd) {
        bd = d;
        bm = sm[w * 32 * Q + j];
      }
    }
    dist[(size_t)t * N + n] = bd;
    idx[(size_t)t * N + n] = bm;
  }
}

__global__ void __launch_bounds__(32 * kMaxRanges) chamfer_empty_kernel() {}

// The launch's shape, or false if the host's split is refused.
bool launch_shape(int T, int N, int M, int q, int ranges, dim3* grid,
                  int* threads, size_t* smem) {
  if (T <= 0 || N <= 0 || M <= 0 || T > 65535 || ranges < 1 ||
      ranges > kMaxRanges || (q != 1 && q != 2 && q != 4))
    return false;
  *grid = dim3((N + 32 * q - 1) / (32 * q), T);
  *threads = 32 * ranges;
  // a warp's stage of float4s, reused by the merge for 32 q (float, int)
  *smem = (size_t)ranges * kStage * sizeof(float4);
  return true;
}

}  // namespace

// a (T, N, 3), b (T, M, 3) f32 contiguous -> dist (T, N) f32, idx (T, N)
// int64. One launch covers every frame: blocks of 32 q queries (q = 1, 2
// or 4) and `ranges` warps (1 to 16), each warp a range of `range`
// candidates (a positive multiple of 8 with ranges * range >= M).
extern "C" int nemo_chamfer_nn(const float* a, const float* b, int T, int N,
                               int M, int q, int ranges, int range,
                               float* dist, int64_t* idx,
                               cudaStream_t stream) {
  dim3 grid;
  int threads;
  size_t smem;
  if (!launch_shape(T, N, M, q, ranges, &grid, &threads, &smem) ||
      range <= 0 || range % kGroup != 0 || (long long)range * ranges < M)
    return (int)cudaErrorInvalidValue;
  if (q == 4)
    nn_one_way_split_kernel<4><<<grid, threads, smem, stream>>>(
        a, b, N, M, range, dist, idx);
  else if (q == 2)
    nn_one_way_split_kernel<2><<<grid, threads, smem, stream>>>(
        a, b, N, M, range, dist, idx);
  else
    nn_one_way_split_kernel<1><<<grid, threads, smem, stream>>>(
        a, b, N, M, range, dist, idx);
  return (int)cudaGetLastError();
}

// An empty kernel on K4's grid, block and shared memory for the same split:
// the launch floor beside K4's device time.
extern "C" int nemo_chamfer_empty(int T, int N, int M, int q, int ranges,
                                  cudaStream_t stream) {
  dim3 grid;
  int threads;
  size_t smem;
  if (!launch_shape(T, N, M, q, ranges, &grid, &threads, &smem))
    return (int)cudaErrorInvalidValue;
  chamfer_empty_kernel<<<grid, threads, smem, stream>>>();
  return (int)cudaGetLastError();
}

// The q-query kernel's registers a thread, static and dynamic (at 16
// ranges) shared memory bytes and local (spill) bytes, into out[4].
extern "C" int nemo_chamfer_attributes(int q, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err;
  if (q == 4)
    err = cudaFuncGetAttributes(&attr, nn_one_way_split_kernel<4>);
  else if (q == 2)
    err = cudaFuncGetAttributes(&attr, nn_one_way_split_kernel<2>);
  else if (q == 1)
    err = cudaFuncGetAttributes(&attr, nn_one_way_split_kernel<1>);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = kMaxRanges * kStage * (int)sizeof(float4);
  out[3] = (int)attr.localSizeBytes;
  return 0;
}
