// The fused MotionNet MLP and its VJP: the Hopper port of
// nemo_tpu/ops/mlp_pallas.py _fwd_kernel (K6f, called by _mlp_fwd_impl) and
// _bwd_kernel (K6b, called by _mlp_vjp_bwd).
//
// K6f, for x (B,D), W1 (D,H), W2 and W3 (H,H), Wo (H,O) = [W_rot | W_lin]:
//   h1 = relu(x W1 + b1), h2 = relu(h1 W2 + b2), z = relu(h2 W3 + b3),
//   out = z Wo + bo,
// writing out, h1, h2 and z. K6b, for the cotangent gout (B,O):
//   gWo = z^T gout, gbo = colsum(gout), gz  = (gout Wo^T) * (z > 0),
//   gW3 = h2^T gz,  gb3 = colsum(gz),   gh2 = (gz W3^T) * (h2 > 0),
//   gW2 = h1^T gh2, gb2 = colsum(gh2),  gh1 = (gh2 W2^T) * (h1 > 0),
//   gW1 = x^T gh1,  gb1 = colsum(gh1),  gx  = gh1 W1^T.
// The ragged edges (B = 1, D = 105, H = 1000, O = 147 at the reference) are
// masked: nothing is padded in device memory.
//
// What bounds it: 2 B (D H + 2 H^2 + H O) f32 products forward and twice
// that backward (2.31 and 4.61 GFLOP at B = 512) against ~15.7 MB moved.
// Every product runs on the tensor cores, mma.sync m16n8k8 TF32 in 3xTF32
// (csrc/tf32_mma.cuh: three TF32 products a product, f32 accumulation), so
// the card's least time is 3x the flop at 495 TFLOP/s (0.014 ms forward and
// 0.028 backward at B = 512) while the bytes take 0.005: operations-bound at
// B = 512 and 960, bytes-bound (the 9 MB of weights) at B = 1. The JAX
// package pins "highest" precision, so one TF32 pass would not do.
//
// Why several launches. The TPU kernel is one launch each way because the
// weights and activations (17-20 MB at the reference) stay in VMEM for the
// whole call. A Hopper block has at most 227 KB of shared memory, and a
// layer needs the whole of the previous layer's output before it starts,
// which only a grid-wide barrier could give inside one launch. So each
// layer is a launch of one tiled GEMM routine, in stream order: 4 forward
// (one product each) and 4 backward (gW_l = act^T g_l and gact_l = g_l
// W_l^T both read only g_l, so one grid covers both products' tiles, and
// the block index picks the product), each followed by a reduction launch
// where a contraction was split (below). Intermediates (gz, gh2, gh1) go
// through scratch in device memory; at these sizes they stay in the 50 MB
// L2.
//
// The GEMM routine: a 128 x 64 output tile a block of 8 warps, each warp a
// 32 x 32 sub-tile of 2 x 4 m16n8 fragments. 32-deep slices of both
// operands are staged by cp.async in a ring of 3 in dynamic shared memory
// (82,944 B, two blocks an SM), so the copies of the next two slices fly
// while a slice is consumed; a fragment is split into big and small in
// registers as it is read. The products of each 16 of the contraction
// accumulate in fresh registers on the tensor cores, and those sums are
// added to the tile's in f32 on the CUDA cores: mma.sync's own
// accumulation drifts over a long contraction. One accumulator for the
// whole contraction ended an order of magnitude further from f64 than the
// plain version (cuBLAS, f32), and then a pre-activation near a ReLU's
// kink can fall on the other side in the kernel and in the plain version;
// with 16-deep sums the kernel is the closer of the two (5.4e-7 of a
// tensor's largest entry against 1.1e-6 at B = 960). Three operand layouts
// cover every product
// without a transposed copy: A (M,K) row-major or A stored (K,M) (act^T g
// contracts the batch straight from the row-major (B,H) activations, as
// _bwd_kernel's dot_general over axis 0 does), B (K,N) or B stored (N,K)
// (g W^T). Each slice is staged in the operand's own layout, so a copy
// follows its contiguous axis (16 bytes a copy where the rows are 16-byte
// aligned, else 4): rows of the slice along m or n are 36 floats (4 mod
// 32), rows along k are 136 or 72 (8 mod 32), and the (lane / 4, lane % 4)
// fragment reads of a warp hit 32 distinct banks either way. The epilogue
// fuses the bias add and the ReLU (forward) or the ReLU mask of the saved
// activation (backward). The bias gradient is a column sum, computed as
// one more output row of the gW product against a virtual row of ones in
// act^T, whose split is exact (big 1, small 0): it is set once in every
// stage of the ring and never copied. Other entries past the matrices'
// edges are left as they are (they reach only outputs that are not
// stored); contraction entries past the end are zero-filled by the copies.
// The copies have one call site and the loops that set up a
// tile stay rolled: the routine's machine code has to fit the SM's
// instruction cache.
//
// A launch with fewer tiles than two blocks an SM (the heads, gW1, gx,
// every B = 1 product) splits a product's contraction into S ranges of at
// least two slices, one block each a tile, written to scratch; a second
// launch sums the S partials in order s = 0..S-1 and applies the epilogue.
// No atomics: S depends on the shapes only, every sum runs in a fixed
// order, and repeated runs are bit-identical.
//
// Precision (_kdot's three policies, NEMO_TPU_NET_PRECISION in JAX; the
// routine is a template on Arith). kTf32x3 ("highest") is the above.
// kBf16x3 ("high") splits each operand value, as it is read from shared
// memory, into hi = bf16(x) and lo = bf16(x - hi) (csrc/bf16_mma.cuh), two
// k-neighbours a register, and runs three mma.sync m16n8k16 bf16 products
// a 16-deep step, lo.hi, hi.lo, hi.hi, into the step's fresh registers
// (lo.lo dropped, as _kdot drops it); kBf16 ("bf16") rounds both operands
// and runs one. The staging, the tiles, the split-K plan and the
// fixed-order sums are the f32 routine's; a k16 step is one kChain. At the
// bf16 peak (989 TFLOP/s) "high" bounds at 3 x its flop, "bf16" at 1 x.
// The bias gradients stay f32 column sums of the cotangent at these
// precisions: a ones row split into bf16 parts would sum bf16(g) (or its
// hi + lo, 16 bits), not g. So the gW product has no ones row there, and
// the launch that reads a layer's cotangent g gets cdiv(N, 256) more blocks,
// each summing 256 of g's columns over the batch, in order b = 0..B-1, in
// f32 (ColSum below).

#include <algorithm>
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

namespace {

// the products' arithmetic: "highest", "high", "bf16" (ops/mlp.py _ARITH)
enum Arith : int { kTf32x3 = 0, kBf16x3 = 1, kBf16 = 2 };

constexpr int kBM = 128;         // output rows a block
constexpr int kBN = 64;          // output columns a block
constexpr int kBK = 32;          // contraction slice staged a step
constexpr int kWM = 32;          // a warp's sub-tile: 2 x 4 m16n8 fragments
constexpr int kWN = 32;
constexpr int kWarpsN = kBN / kWN;
constexpr int kThreads = 32 * (kBM / kWM) * kWarpsN;
constexpr int kFM = kWM / 16;    // m16 fragments a warp
constexpr int kFN = kWN / 8;     // n8 fragments a warp
constexpr int kStages = 3;       // slices in the cp.async ring
constexpr int kChain = 16;       // contraction depth a tensor-core sum takes
// shared-memory row strides (floats): rows along m or n (kSK = 4 mod 32)
// and rows along k (kSM, kSN = 8 mod 32)
constexpr int kSK = kBK + 4;
constexpr int kSM = kBM + 8;
constexpr int kSN = kBN + 8;
constexpr int kAFloats = kBK * kSM > kBM * kSK ? kBK * kSM : kBM * kSK;
constexpr int kBFloats = kBK * kSN > kBN * kSK ? kBK * kSN : kBN * kSK;
constexpr int kStageFloats = kAFloats + kBFloats;  // A, then B
constexpr int kSmemBytes = kStages * kStageFloats * (int)sizeof(float);
constexpr int kBlocksPerSM = 2;  // by shared memory (2 x 82,944 B)
constexpr int kSMs = 132;        // H100 SXM
constexpr int kTargetBlocks = kBlocksPerSM * kSMs;  // one wave
constexpr int kMaxSplit = 16;
constexpr int kMinSplitSlices = 2;  // contraction slices a range at least

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// C (M,N) = epilogue(A . B). A is A[m*lda + k], or A[k*lda + m] when
// kAT; B is B[k*ldb + n], or B[n*ldb + k] when kBT. With gbias set the
// product has one more output row, M, against a virtual row of ones in A,
// written to gbias (N): the column sums of B.
struct Gemm {
  int M, N, K;
  const float* A;
  int lda;
  const float* B;
  int ldb;
  float* C;
  int ldc;
  const float* bias;  // added to every row (forward)
  int relu;           // forward: max(., 0) after the bias
  const float* mask;  // backward: times (mask[m*ldc + n] > 0), C's layout
  float* gbias;       // backward gW: the ones row's output
};

__host__ __device__ inline int out_rows(const Gemm& g) {
  return g.M + (g.gbias ? 1 : 0);
}

// The bias gradient of a backward launch at kBf16x3 and kBf16: out (cols)
// = the column sums of g (rows, cols) in f32, in row order; out null for
// none.
struct ColSum {
  const float* g;
  float* out;
  int rows, cols;
};

// A product as a launch runs it: its output tiles, and S contraction
// ranges of kps slices each, one block a (tile, range); with S > 1 the
// blocks write raw sums to partial (S, rows, N).
struct Product {
  Gemm g;
  int tiles_n, tiles;
  int S, kps;
  float* partial;
};

__device__ __forceinline__ float epilogue(const Gemm& g, int m, int n,
                                          float acc) {
  if (g.bias) acc += g.bias[n];
  if (g.relu && acc < 0.f) acc = 0.f;
  if (g.mask) acc *= g.mask[(size_t)m * g.ldc + n] > 0.f ? 1.f : 0.f;
  return acc;
}

__device__ __forceinline__ void store(const Gemm& g, int m, int n, float v) {
  if (m < g.M) g.C[(size_t)m * g.ldc + n] = v;
  else g.gbias[n] = v;
}

// Queue the copy of an R x C slice, row r and column c from
// src[(r0 + r) * ld + c0 + c], into dst[r * stride + c], CW floats a copy.
// One axis is the contraction, the other an edge of the matrix: past the
// contraction's end (r_end or c_end) the copies zero-fill, past the
// matrix's edge (kRowsEdge: rows, else columns) nothing is copied.
template <int CW, int R, int C, bool kRowsEdge>
__device__ __forceinline__ void copy_slice(float* dst, int stride,
                                           const float* src, int ld, int r0,
                                           int r_end, int c0, int c_end) {
  constexpr int kPerRow = C / CW;
#pragma unroll 1
  for (int e = threadIdx.x; e < R * kPerRow; e += kThreads) {
    const int r = e / kPerRow, c = e % kPerRow * CW;
    const int gr = r0 + r, gc = c0 + c;
    if (kRowsEdge ? gr >= r_end : gc >= c_end) continue;
    const int n = gr < r_end ? c_end - gc : 0;
    cp_async<CW>(dst + r * stride + c,
                 n > 0 ? src + (size_t)gr * ld + gc : src, n);
  }
}

// 16-byte copies need 16-byte aligned rows and, along an edge axis, a
// length that is a multiple of 4 (no copy straddles the edge).
__device__ __forceinline__ bool vec_ok(const float* p, int ld, int edge,
                                       bool edge_is_column) {
  return ld % 4 == 0 && ((uintptr_t)p & 15) == 0 &&
         (!edge_is_column || edge % 4 == 0);
}

// Column-sum block blk of cs: 256 columns, a thread each.
__device__ __forceinline__ void col_sum(const ColSum& cs, int blk) {
  const int n = blk * kThreads + threadIdx.x;
  if (n >= cs.cols) return;
  const float* g = cs.g + n;
  float acc = 0.f;
#pragma unroll 8
  for (int b = 0; b < cs.rows; ++b) acc += g[(size_t)b * cs.cols];
  cs.out[n] = acc;
}

// One (kBM x kBN) output tile over one contraction range: block blk of p,
// in the arithmetic kArith.
template <bool kAT, bool kBT, int kArith>
__device__ __forceinline__ void gemm_tile(const Product& p, int blk,
                                          float* smem) {
  const Gemm& g = p.g;
  const int tile = blk % p.tiles, s = blk / p.tiles;
  const int n0 = tile % p.tiles_n * kBN, m0 = tile / p.tiles_n * kBM;
  const int kb = s * p.kps * kBK;
  const int ke = min(g.K, kb + p.kps * kBK);
  const int n_slices = cdiv(ke - kb, kBK);
  const int rows = out_rows(g);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp / kWarpsN * kWM, wn = warp % kWarpsN * kWN;

  // the virtual ones row (gW's bias gradient) in every stage; the copies
  // never touch it. Other entries past M or N are not set: a product's row
  // m reads only A's row m and its column n only B's column n, and those
  // outputs are never stored.
  if (g.gbias && g.M >= m0 && g.M < m0 + kBM)
#pragma unroll 1
    for (int e = tid; e < kStages * kBK; e += kThreads) {
      const int m = g.M - m0, k = e % kBK;
      smem[e / kBK * kStageFloats + (kAT ? k * kSM + m : m * kSK + k)] = 1.f;
    }

  const bool vec_a = vec_ok(g.A, g.lda, g.M, kAT);
  const bool vec_b = vec_ok(g.B, g.ldb, g.N, !kBT);
  auto load = [&](int slice, int st) {
    float* a = smem + st * kStageFloats;
    float* b = a + kAFloats;
    const int k0 = kb + slice * kBK;
    if (kAT) {
      if (vec_a) copy_slice<4, kBK, kBM, false>(a, kSM, g.A, g.lda, k0, ke, m0, g.M);
      else       copy_slice<1, kBK, kBM, false>(a, kSM, g.A, g.lda, k0, ke, m0, g.M);
    } else {
      if (vec_a) copy_slice<4, kBM, kBK, true>(a, kSK, g.A, g.lda, m0, g.M, k0, ke);
      else       copy_slice<1, kBM, kBK, true>(a, kSK, g.A, g.lda, m0, g.M, k0, ke);
    }
    if (kBT) {
      if (vec_b) copy_slice<4, kBN, kBK, true>(b, kSK, g.B, g.ldb, n0, g.N, k0, ke);
      else       copy_slice<1, kBN, kBK, true>(b, kSK, g.B, g.ldb, n0, g.N, k0, ke);
    } else {
      if (vec_b) copy_slice<4, kBK, kBN, false>(b, kSN, g.B, g.ldb, k0, ke, n0, g.N);
      else       copy_slice<1, kBK, kBN, false>(b, kSN, g.B, g.ldb, k0, ke, n0, g.N);
    }
  };

  float acc[kFM][kFN][4];
#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  // the first kStages - 1 passes only queue copies; pass t >= 0 waits for
  // slice t, queues slice t + kStages - 1 into the stage slice t - 1 used,
  // and consumes slice t (one call site of the copies keeps the code small)
#pragma unroll 1
  for (int t = 1 - kStages; t < n_slices; ++t) {
    if (t >= 0) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // slice t landed; slice t - 1's stage is free
    }
    if (t + kStages - 1 < n_slices)
      load(t + kStages - 1, (t + kStages - 1) % kStages);
    cp_async_commit();
    if (t < 0) continue;
    const float* a = smem + t % kStages * kStageFloats;
    const float* b = a + kAFloats;
#pragma unroll
    for (int kf = 0; kf < kBK; kf += kChain) {
      float part[kFM][kFN][4];  // kChain deep on the tensor cores
#pragma unroll
      for (int i = 0; i < kFM; ++i)
#pragma unroll
        for (int j = 0; j < kFN; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) part[i][j][c] = 0.f;
      if constexpr (kArith == kTf32x3) {
#pragma unroll
        for (int kk = kf; kk < kf + kChain; kk += 8) {
          uint32_t ab[kFM][4], as[kFM][4], bb[kFN][2], bs[kFN][2];
#pragma unroll
          for (int i = 0; i < kFM; ++i) {
            const int m = wm + 16 * i + gid, k = kk + tig;
            const float v[4] = {
                kAT ? a[k * kSM + m] : a[m * kSK + k],
                kAT ? a[k * kSM + m + 8] : a[(m + 8) * kSK + k],
                kAT ? a[(k + 4) * kSM + m] : a[m * kSK + k + 4],
                kAT ? a[(k + 4) * kSM + m + 8] : a[(m + 8) * kSK + k + 4]};
#pragma unroll
            for (int c = 0; c < 4; ++c) split_tf32(v[c], ab[i][c], as[i][c]);
          }
#pragma unroll
          for (int j = 0; j < kFN; ++j) {
            const int n = wn + 8 * j + gid, k = kk + tig;
            split_tf32(kBT ? b[n * kSK + k] : b[k * kSN + n], bb[j][0],
                       bs[j][0]);
            split_tf32(kBT ? b[n * kSK + k + 4] : b[(k + 4) * kSN + n],
                       bb[j][1], bs[j][1]);
          }
#pragma unroll
          for (int i = 0; i < kFM; ++i)
#pragma unroll
            for (int j = 0; j < kFN; ++j)
              mma_3xtf32(part[i][j], part[i][j], ab[i], as[i], bb[j], bs[j]);
        }
      } else {
        // one m16n8k16 step over the chain: A's (row, k) and B's (k, n)
        // pairs split (or rounded) into packed bf16 as they are read
        const auto A = [&](int m, int k) {
          return kAT ? a[k * kSM + m] : a[m * kSK + k];
        };
        const auto Bv = [&](int k, int n) {
          return kBT ? b[n * kSK + k] : b[k * kSN + n];
        };
        uint32_t ah[kFM][4], al[kFM][4], bh[kFN][2], bl[kFN][2];
        const int k = kf + 2 * tig;
#pragma unroll
        for (int i = 0; i < kFM; ++i) {
          const int m = wm + 16 * i + gid;
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int mr = m + 8 * (r & 1), kr = k + 8 * (r >> 1);
            split_bf16x2(A(mr, kr), A(mr, kr + 1), ah[i][r], al[i][r]);
          }
        }
#pragma unroll
        for (int j = 0; j < kFN; ++j) {
          const int n = wn + 8 * j + gid;
#pragma unroll
          for (int r = 0; r < 2; ++r)
            split_bf16x2(Bv(k + 8 * r, n), Bv(k + 8 * r + 1, n), bh[j][r],
                         bl[j][r]);
        }
#pragma unroll
        for (int i = 0; i < kFM; ++i)
#pragma unroll
          for (int j = 0; j < kFN; ++j) {
            if constexpr (kArith == kBf16x3) {
              mma_bf16(part[i][j], al[i], bh[j]);
              mma_bf16(part[i][j], ah[i], bl[j]);
            }
            mma_bf16(part[i][j], ah[i], bh[j]);
          }
      }
#pragma unroll
      for (int i = 0; i < kFM; ++i)
#pragma unroll
        for (int j = 0; j < kFN; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][j][c] += part[i][j][c];
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int m = m0 + wm + 16 * i + gid + (c >> 1) * 8;
        const int n = n0 + wn + 8 * j + 2 * tig + (c & 1);
        if (m >= rows || n >= g.N) continue;
        if (p.partial)
          p.partial[((size_t)s * rows + m) * g.N + n] = acc[i][j][c];
        else
          store(g, m, n, epilogue(g, m, n, acc[i][j][c]));
      }
}

// One launch over the blocks of one product (the forward's layouts, kAT0
// == kAT1 and kBT0 == kBT1: p0 alone) or of two (the backward's gW and gact
// of a layer); of two, the product with the longer contraction ranges
// (second_first: p1) takes the first block indices, so its blocks start
// first. Each layout's tile routine is inlined once. The blocks past the
// products' are cs's column sums.
template <bool kAT0, bool kBT0, bool kAT1, bool kBT1, int kArith>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
mlp_gemm_kernel(Product p0, Product p1, int second_first, ColSum cs) {
  extern __shared__ __align__(16) float smem[];
  const int n0 = p0.tiles * p0.S, n1 = p1.tiles * p1.S;
  const int blk = blockIdx.x;
  if (blk >= n0 + n1) {
    col_sum(cs, blk - n0 - n1);
    return;
  }
  if constexpr (kAT0 == kAT1 && kBT0 == kBT1) {
    gemm_tile<kAT0, kBT0, kArith>(p0, blk, smem);
  } else {
    const bool in1 = second_first ? blk < n1 : blk >= n0;
    if (in1)
      gemm_tile<kAT1, kBT1, kArith>(p1, second_first ? blk : blk - n0, smem);
    else
      gemm_tile<kAT0, kBT0, kArith>(p0, second_first ? blk - n1 : blk, smem);
  }
}

// Output idx of a split product: its S partials summed in order s =
// 0..S-1, then the epilogue.
__device__ __forceinline__ void reduce_one(const Product& p, size_t idx) {
  const size_t total = (size_t)out_rows(p.g) * p.g.N;
  if (p.S <= 1 || idx >= total) return;
  float acc = p.partial[idx];
  for (int s = 1; s < p.S; ++s) acc += p.partial[s * total + idx];
  const int m = (int)(idx / p.g.N), n = (int)(idx % p.g.N);
  store(p.g, m, n, epilogue(p.g, m, n, acc));
}

// Every output of each split product of a launch, p0's first.
__global__ void __launch_bounds__(256)
mlp_splitk_reduce(Product p0, Product p1) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t t0 = p0.S > 1 ? (size_t)out_rows(p0.g) * p0.g.N : 0;
  if (idx < t0) reduce_one(p0, idx);
  else reduce_one(p1, idx - t0);
}

// The contraction ranges of a product with `tiles` output tiles launched
// beside `others` tiles of another product: one range when the launch has
// kTargetBlocks tiles, else as many as keep the launch within that many
// blocks, at most kMaxSplit and at least kMinSplitSlices slices a range.
void plan(int tiles, int others, int K, int& S, int& kps) {
  const int kt = cdiv(K, kBK);
  S = std::max(1, std::min({(kTargetBlocks - others) / tiles,
                            kt / kMinSplitSlices, kMaxSplit}));
  kps = cdiv(kt, S);
  S = cdiv(kt, kps);
}

Product product(const Gemm& g, int other_tiles) {
  Product p;
  p.g = g;
  p.tiles_n = cdiv(g.N, kBN);
  p.tiles = p.tiles_n * cdiv(out_rows(g), kBM);
  plan(p.tiles, other_tiles, g.K, p.S, p.kps);
  p.partial = nullptr;
  return p;
}

int tiles_of(const Gemm& g) { return cdiv(g.N, kBN) * cdiv(out_rows(g), kBM); }

size_t partial_floats(const Product& p) {
  return p.S > 1 ? (size_t)p.S * out_rows(p.g) * p.g.N : 0;
}

// Launch one product (n = 1) or a pair (n = 2) and cs's column sums (cs.out
// null: none), then the reduction where either product was split; partial
// holds both products' partials, p0's first.
template <bool kAT0, bool kBT0, bool kAT1, bool kBT1, int kArith>
cudaError_t run(Product p0, Product p1, int n, float* partial, ColSum cs,
                cudaStream_t stream) {
  auto kernel = mlp_gemm_kernel<kAT0, kBT0, kAT1, kBT1, kArith>;
  // the shared-memory limit, set once a device (a host call that costs
  // more than the launch)
  static bool raised[64];
  int dev = 0;
  if (cudaError_t err = cudaGetDevice(&dev)) return err;
  if (dev >= 64 || !raised[dev]) {
    if (cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes))
      return err;
    if (dev < 64) raised[dev] = true;
  }
  if (n < 2) p1.tiles = p1.S = 0;
  p0.partial = p0.S > 1 ? partial : nullptr;
  p1.partial = p1.S > 1 ? partial + partial_floats(p0) : nullptr;
  const int blocks = p0.tiles * p0.S + p1.tiles * p1.S +
                     (cs.out ? cdiv(cs.cols, kThreads) : 0);
  kernel<<<blocks, kThreads, kSmemBytes, stream>>>(p0, p1, p1.kps > p0.kps,
                                                   cs);
  if (cudaError_t err = cudaGetLastError()) return err;
  const size_t total = (p0.S > 1 ? (size_t)out_rows(p0.g) * p0.g.N : 0) +
                       (p1.S > 1 ? (size_t)out_rows(p1.g) * p1.g.N : 0);
  if (total > 0)
    mlp_splitk_reduce<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
        p0, p1);
  return cudaGetLastError();
}

Gemm gemm(int M, int N, int K, const float* A, int lda, const float* B,
          int ldb, float* C, int ldc) {
  return {M, N, K, A, lda, B, ldb, C, ldc, nullptr, 0, nullptr, nullptr};
}

bool bad_shape(int B, int D, int H, int O) {
  if (B <= 0 || D <= 0 || H <= 0 || O <= 0) return true;
  // a launch's blocks (two products of at most t x t tiles and kMaxSplit
  // ranges each) in one grid dimension
  const long long t = (std::max({B, D, H, O}) + 64LL) / 64;
  return 2 * kMaxSplit * t * t > INT_MAX;
}

// The forward's layers as (M, N, K) products: the batch against each weight.
struct Layer {
  int K_in, N;
};

void layers_of(int D, int H, int O, Layer out[4]) {
  out[0] = {D, H};
  out[1] = {H, H};
  out[2] = {H, H};
  out[3] = {H, O};
}

// The backward's pair of products for a layer (act (B,K_in), W (K_in,N)):
// gW = act^T g, with its ones row where gbias is set, and gact = g W^T.
void backward_pair(int B, const Layer& l, const float* act, const float* W,
                   const float* g, float* gW, float* gbias, float* gact,
                   const float* mask, Product& pw, Product& pa) {
  Gemm w = gemm(l.K_in, l.N, B, act, l.K_in, g, l.N, gW, l.N);
  w.gbias = gbias;
  Gemm a = gemm(B, l.K_in, l.N, g, l.N, W, l.N, gact, l.K_in);
  a.mask = mask;
  pw = product(w, tiles_of(a));
  pa = product(a, tiles_of(w));
}

template <int kArith>
cudaError_t mlp_fwd(int B, int D, int H, int O, const float* x,
                    const float* W1, const float* b1, const float* W2,
                    const float* b2, const float* W3, const float* b3,
                    const float* Wo, const float* bo, float* out, float* h1,
                    float* h2, float* z, float* scratch,
                    cudaStream_t stream) {
  const struct { const float *in, *W, *b; float* C; int relu; } io[] = {
      {x, W1, b1, h1, 1}, {h1, W2, b2, h2, 1}, {h2, W3, b3, z, 1},
      {z, Wo, bo, out, 0}};
  Layer ls[4];
  layers_of(D, H, O, ls);
  for (int i = 0; i < 4; ++i) {
    Gemm g = gemm(B, ls[i].N, ls[i].K_in, io[i].in, ls[i].K_in, io[i].W,
                  ls[i].N, io[i].C, ls[i].N);
    g.bias = io[i].b;
    g.relu = io[i].relu;
    const Product p = product(g, 0);
    if (cudaError_t err = run<false, false, false, false, kArith>(
            p, p, 1, scratch, ColSum{nullptr, nullptr, 0, 0}, stream))
      return err;
  }
  return cudaSuccess;
}

template <int kArith>
cudaError_t mlp_bwd(int B, int D, int H, int O, const float* gout,
                    const float* x, const float* h1, const float* h2,
                    const float* z, const float* W1, const float* W2,
                    const float* W3, const float* Wo, float* gx, float* gW1,
                    float* gb1, float* gW2, float* gb2, float* gW3,
                    float* gb3, float* gWo, float* gbo, float* scratch,
                    cudaStream_t stream) {
  float* ga = scratch;                    // gz, then gh1 (B,H)
  float* gb = scratch + (size_t)B * H;    // gh2 (B,H)
  float* partial = scratch + 2 * (size_t)B * H;
  // layer by layer from the output: the input activation act (B,K_in), its
  // weight W (K_in,N), the cotangent on the layer's output g (B,N), the
  // weight and bias gradients, the cotangent on act and the mask it takes
  // (act itself; none for x)
  const struct {
    const float *act, *W, *g;
    float *gW, *gbias, *gact;
    const float* mask;
  } io[] = {{z, Wo, gout, gWo, gbo, ga, z},
            {h2, W3, ga, gW3, gb3, gb, h2},
            {h1, W2, gb, gW2, gb2, ga, h1},
            {x, W1, ga, gW1, gb1, gx, nullptr}};
  Layer ls[4];
  layers_of(D, H, O, ls);
  for (int i = 0; i < 4; ++i) {
    const Layer& l = ls[3 - i];
    // 3xTF32: the bias gradient as gW's ones row; else g's column sums
    const bool ones_row = kArith == kTf32x3;
    Product pw, pa;
    backward_pair(B, l, io[i].act, io[i].W, io[i].g, io[i].gW,
                  ones_row ? io[i].gbias : nullptr, io[i].gact, io[i].mask,
                  pw, pa);
    const ColSum cs{io[i].g, ones_row ? nullptr : io[i].gbias, B, l.N};
    if (cudaError_t err = run<true, false, false, true, kArith>(
            pw, pa, 2, partial, cs, stream))
      return err;
  }
  return cudaSuccess;
}

template <int kArith>
int gemm_attributes(int pair, int* out) {
  cudaFuncAttributes a;
  cudaError_t err =
      pair ? cudaFuncGetAttributes(
                 &a, mlp_gemm_kernel<true, false, false, true, kArith>)
           : cudaFuncGetAttributes(
                 &a, mlp_gemm_kernel<false, false, false, false, kArith>);
  if (err) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = kSmemBytes;
  out[3] = (int)a.localSizeBytes;
  return 0;
}

}  // namespace

// Floats of device scratch nemo_mlp_fwd and nemo_mlp_bwd need at (B, D, H,
// O), at any arith: the backward's two (B,H) intermediates and the largest
// split-K partial buffer of any launch, with or without gW's ones row; -1
// for a shape the kernels refuse.
extern "C" int nemo_mlp_scratch_floats(int B, int D, int H, int O) {
  if (bad_shape(B, D, H, O)) return -1;
  Layer ls[4];
  layers_of(D, H, O, ls);
  size_t most = 0;
  for (const Layer& l : ls) {
    const Gemm f = gemm(B, l.N, l.K_in, nullptr, 0, nullptr, 0, nullptr, 0);
    most = std::max(most, partial_floats(product(f, 0)));
    float ones_row;  // a gbias pointer only marks gW's ones row here
    for (float* gbias : {&ones_row, (float*)nullptr}) {
      Product pw, pa;
      backward_pair(B, l, nullptr, nullptr, nullptr, nullptr, gbias, nullptr,
                    nullptr, pw, pa);
      most = std::max(most, partial_floats(pw) + partial_floats(pa));
    }
  }
  const size_t total = 2 * (size_t)B * H + most;
  return total > (size_t)INT_MAX ? -1 : (int)total;
}

// arith: 0 3xTF32 ("highest"), 1 bf16x3 ("high"), 2 bf16. x (B,D), W1
// (D,H), b1 (H), W2 and W3 (H,H), b2 and b3 (H), Wo (H,O), bo (O), all f32
// contiguous on one device; outputs out (B,O) and the saved activations
// h1, h2, z (B,H); scratch of nemo_mlp_scratch_floats.
extern "C" int nemo_mlp_fwd(int arith, int B, int D, int H, int O,
                            const float* x, const float* W1, const float* b1,
                            const float* W2, const float* b2, const float* W3,
                            const float* b3, const float* Wo, const float* bo,
                            float* out, float* h1, float* h2, float* z,
                            float* scratch, cudaStream_t stream) {
  if (bad_shape(B, D, H, O)) return (int)cudaErrorInvalidValue;
  switch (arith) {
    case kTf32x3:
      return (int)mlp_fwd<kTf32x3>(B, D, H, O, x, W1, b1, W2, b2, W3, b3, Wo,
                                   bo, out, h1, h2, z, scratch, stream);
    case kBf16x3:
      return (int)mlp_fwd<kBf16x3>(B, D, H, O, x, W1, b1, W2, b2, W3, b3, Wo,
                                   bo, out, h1, h2, z, scratch, stream);
    case kBf16:
      return (int)mlp_fwd<kBf16>(B, D, H, O, x, W1, b1, W2, b2, W3, b3, Wo,
                                 bo, out, h1, h2, z, scratch, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// arith as nemo_mlp_fwd's. The saved x, h1, h2, z and the weights as
// nemo_mlp_fwd takes them, the cotangent gout (B,O); outputs gx (B,D) and
// the gradients of W1, b1, W2, b2, W3, b3, Wo, bo in their shapes; scratch
// of nemo_mlp_scratch_floats.
extern "C" int nemo_mlp_bwd(int arith, int B, int D, int H, int O,
                            const float* gout, const float* x,
                            const float* h1, const float* h2, const float* z,
                            const float* W1, const float* W2, const float* W3,
                            const float* Wo, float* gx, float* gW1,
                            float* gb1, float* gW2, float* gb2, float* gW3,
                            float* gb3, float* gWo, float* gbo,
                            float* scratch, cudaStream_t stream) {
  if (bad_shape(B, D, H, O)) return (int)cudaErrorInvalidValue;
  switch (arith) {
    case kTf32x3:
      return (int)mlp_bwd<kTf32x3>(B, D, H, O, gout, x, h1, h2, z, W1, W2, W3,
                                   Wo, gx, gW1, gb1, gW2, gb2, gW3, gb3, gWo,
                                   gbo, scratch, stream);
    case kBf16x3:
      return (int)mlp_bwd<kBf16x3>(B, D, H, O, gout, x, h1, h2, z, W1, W2, W3,
                                   Wo, gx, gW1, gb1, gW2, gb2, gW3, gb3, gWo,
                                   gbo, scratch, stream);
    case kBf16:
      return (int)mlp_bwd<kBf16>(B, D, H, O, gout, x, h1, h2, z, W1, W2, W3,
                                 Wo, gx, gW1, gb1, gW2, gb2, gW3, gb3, gWo,
                                 gbo, scratch, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// out int[4]: the GEMM kernel's registers a thread, static and dynamic
// shared memory bytes and local (spill) bytes, for the forward's
// instantiation (pair = 0) or the backward's pair (pair = 1), at arith.
extern "C" int nemo_mlp_attributes(int pair, int arith, int* out) {
  switch (arith) {
    case kTf32x3: return gemm_attributes<kTf32x3>(pair, out);
    case kBf16x3: return gemm_attributes<kBf16x3>(pair, out);
    case kBf16: return gemm_attributes<kBf16>(pair, out);
  }
  return (int)cudaErrorInvalidValue;
}
