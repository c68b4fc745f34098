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
// Every product is f32 FMA on the CUDA cores (no TF32: the JAX package pins
// "highest" precision), and the ragged edges (B = 1, D = 105, H = 1000,
// O = 147 at the reference) are masked: nothing is padded.
//
// Why several launches. The TPU kernel is one launch each way because the
// weights and activations (17-20 MB at the reference) stay in VMEM for the
// whole call. A Hopper block has at most 227 KB of shared memory, and a
// layer needs the whole of the previous layer's output before it starts,
// which only a grid-wide barrier could give inside one launch. So each
// product is its own launch of one tiled GEMM routine, in stream order: 4
// forward and 8 backward, each followed by a reduction launch where its K
// range was split (below). Intermediates (gz, gh2, gh1) go through scratch
// in device memory; at these sizes they stay in the 50 MB L2.
//
// What bounds it: f32 operations, 2 B (D H + 2 H^2 + H O) forward and twice
// that backward (2.31 and 4.61 GFLOP at B = 512) against ~15.7 MB moved:
// operations-bound at B = 512 and 960, bytes-bound (the 9 MB of weights) at
// B = 1. The GEMM routine: a 64 x 64 output tile per block of 256 threads,
// 16-deep slices of both operands staged in shared memory (the next slice
// loaded into registers while the current one is consumed), a 4 x 4 register
// block a thread read with float4 loads. Three operand layouts cover every
// product without a transposed copy: A (M,K) row-major or A stored (K,M)
// (act^T g contracts the batch straight from the row-major (B,H)
// activations, as _bwd_kernel's dot_general over axis 0 does), B (K,N) or
// B stored (N,K) (g W^T). The epilogue fuses the bias add and the ReLU
// (forward) or the ReLU mask of the saved activation (backward). The bias
// gradient is a column sum, computed as one more output row of the gW
// product against a virtual row of ones in act^T.
//
// A product with fewer output tiles than the card has SMs (the heads, gW1,
// gx, every B = 1 product) splits its contraction into S ranges, one grid
// slice each, written to scratch; a second launch sums the S partials in
// order s = 0..S-1 and applies the epilogue. No atomics: S depends on the
// shapes only, every sum runs in a fixed order, and repeated runs are
// bit-identical.

#include <algorithm>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;         // output rows a block
constexpr int kBN = 64;         // output columns a block
constexpr int kBK = 16;         // contraction slice staged a step
constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int kPerThread = kBM * kBK / kThreads;  // staged loads a thread
constexpr int kSMs = 132;       // H100 SXM
constexpr int kMaxSplit = 16;
constexpr int kMinSplitTiles = 4;  // contraction slices a split at least

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

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

template <bool kAT>
__device__ __forceinline__ float load_a(const Gemm& g, int m, int k, int ke) {
  if (k >= ke) return 0.f;
  if (m < g.M)
    return kAT ? __ldg(g.A + (size_t)k * g.lda + m)
               : __ldg(g.A + (size_t)m * g.lda + k);
  return (g.gbias && m == g.M) ? 1.f : 0.f;
}

template <bool kBT>
__device__ __forceinline__ float load_b(const Gemm& g, int k, int n, int ke) {
  if (k >= ke || n >= g.N) return 0.f;
  return kBT ? __ldg(g.B + (size_t)n * g.ldb + k)
             : __ldg(g.B + (size_t)k * g.ldb + n);
}

// (row, column) in the staged slice of the i-th load of a thread: the
// fastest index follows the operand's contiguous axis, so a warp's loads
// are coalesced.
__device__ __forceinline__ void a_slot(bool kAT, int e, int& m, int& k) {
  if (kAT) { k = e / kBM; m = e % kBM; } else { m = e / kBK; k = e % kBK; }
}

__device__ __forceinline__ void b_slot(bool kBT, int e, int& k, int& n) {
  if (kBT) { n = e / kBK; k = e % kBK; } else { k = e / kBN; n = e % kBN; }
}

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

// One (64 x 64) output tile over the contraction range of split
// blockIdx.z (kps slices of kBK). partial == nullptr: the epilogue and the
// output; otherwise the raw sums into partial (S, rows, N).
template <bool kAT, bool kBT>
__global__ void __launch_bounds__(kThreads)
mlp_gemm_kernel(Gemm g, int kps, float* __restrict__ partial) {
  __shared__ __align__(16) float As[kBK][kBM + 4];
  __shared__ __align__(16) float Bs[kBK][kBN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int kb = blockIdx.z * kps * kBK;
  const int ke = min(g.K, kb + kps * kBK);
  const int rows = out_rows(g);

  float ra[kPerThread], rb[kPerThread];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      int m, k, n, kk;
      a_slot(kAT, tid + i * kThreads, m, k);
      b_slot(kBT, tid + i * kThreads, kk, n);
      ra[i] = load_a<kAT>(g, m0 + m, k0 + k, ke);
      rb[i] = load_b<kBT>(g, k0 + kk, n0 + n, ke);
    }
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  fetch(kb);
  for (int k0 = kb; k0 < ke; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      int m, k, n, kk;
      a_slot(kAT, tid + i * kThreads, m, k);
      b_slot(kBT, tid + i * kThreads, kk, n);
      As[k][m] = ra[i];
      Bs[kk][n] = rb[i];
    }
    __syncthreads();
    if (k0 + kBK < ke) fetch(k0 + kBK);  // in flight during the products
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= g.N) continue;
      if (partial)
        partial[((size_t)blockIdx.z * rows + m) * g.N + n] = acc[i][j];
      else
        store(g, m, n, epilogue(g, m, n, acc[i][j]));
    }
  }
}

// Sum the S partials of each output in order s = 0..S-1, then the epilogue.
__global__ void __launch_bounds__(256)
mlp_splitk_reduce(Gemm g, int S, const float* __restrict__ partial) {
  const size_t total = (size_t)out_rows(g) * g.N;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float acc = partial[idx];
  for (int s = 1; s < S; ++s) acc += partial[s * total + idx];
  const int m = (int)(idx / g.N), n = (int)(idx % g.N);
  store(g, m, n, epilogue(g, m, n, acc));
}

// How many contraction ranges S, of kps slices each: one when the output
// tiles fill the card, else enough to give about two blocks an SM, at
// least kMinSplitTiles slices a range.
struct Split {
  int S, kps;
};

Split plan(int rows, int N, int K) {
  const int tiles = cdiv(rows, kBM) * cdiv(N, kBN);
  const int kt = cdiv(K, kBK);
  int S = 1;
  if (tiles < kSMs) {
    S = cdiv(2 * kSMs, tiles);
    S = std::min({S, std::max(1, kt / kMinSplitTiles), kMaxSplit});
  }
  const int kps = cdiv(kt, S);
  return {cdiv(kt, kps), kps};
}

size_t partial_floats(int rows, int N, int K) {
  const Split p = plan(rows, N, K);
  return p.S > 1 ? (size_t)p.S * rows * N : 0;
}

template <bool kAT, bool kBT>
cudaError_t run(const Gemm& g, float* partial, cudaStream_t stream) {
  const int rows = out_rows(g);
  const Split p = plan(rows, g.N, g.K);
  const dim3 grid(cdiv(g.N, kBN), cdiv(rows, kBM), p.S);
  mlp_gemm_kernel<kAT, kBT><<<grid, kThreads, 0, stream>>>(
      g, p.kps, p.S > 1 ? partial : nullptr);
  if (cudaError_t err = cudaGetLastError()) return err;
  if (p.S > 1) {
    const size_t total = (size_t)rows * g.N;
    mlp_splitk_reduce<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
        g, p.S, partial);
  }
  return cudaGetLastError();
}

Gemm gemm(int M, int N, int K, const float* A, int lda, const float* B,
          int ldb, float* C, int ldc) {
  return {M, N, K, A, lda, B, ldb, C, ldc, nullptr, 0, nullptr, nullptr};
}

bool bad_shape(int B, int D, int H, int O) {
  return B <= 0 || D <= 0 || H <= 0 || O <= 0 || cdiv(B + 1, kBM) > 65535 ||
         cdiv(H + 1, kBM) > 65535;
}

}  // namespace

// Floats of device scratch nemo_mlp_fwd and nemo_mlp_bwd need at (B, D, H,
// O): the backward's two (B,H) intermediates and the largest split-K
// partial buffer of any product; -1 for a shape the kernels refuse.
extern "C" int nemo_mlp_scratch_floats(int B, int D, int H, int O) {
  if (bad_shape(B, D, H, O)) return -1;
  const int shapes[][3] = {
      {B, H, D}, {B, H, H}, {B, O, H},                    // forward
      {H + 1, O, B}, {B, H, O}, {H + 1, H, B}, {B, H, H},  // backward
      {D + 1, H, B}, {B, D, H}};
  size_t most = 0;
  for (const auto& s : shapes) {
    const size_t n = partial_floats(s[0], s[1], s[2]);
    if (n > most) most = n;
  }
  const size_t total = 2 * (size_t)B * H + most;
  return total > (size_t)INT_MAX ? -1 : (int)total;
}

// x (B,D), W1 (D,H), b1 (H), W2 and W3 (H,H), b2 and b3 (H), Wo (H,O),
// bo (O), all f32 contiguous on one device; outputs out (B,O) and the
// saved activations h1, h2, z (B,H); scratch of nemo_mlp_scratch_floats.
extern "C" int nemo_mlp_fwd(int B, int D, int H, int O, const float* x,
                            const float* W1, const float* b1, const float* W2,
                            const float* b2, const float* W3, const float* b3,
                            const float* Wo, const float* bo, float* out,
                            float* h1, float* h2, float* z, float* scratch,
                            cudaStream_t stream) {
  if (bad_shape(B, D, H, O)) return (int)cudaErrorInvalidValue;
  const struct { const float *in, *W, *b; int K, N; float* C; int relu; }
      layers[] = {{x, W1, b1, D, H, h1, 1}, {h1, W2, b2, H, H, h2, 1},
                  {h2, W3, b3, H, H, z, 1}, {z, Wo, bo, H, O, out, 0}};
  for (const auto& l : layers) {
    Gemm g = gemm(B, l.N, l.K, l.in, l.K, l.W, l.N, l.C, l.N);
    g.bias = l.b;
    g.relu = l.relu;
    if (cudaError_t err = run<false, false>(g, scratch, stream))
      return (int)err;
  }
  return (int)cudaSuccess;
}

// The saved x, h1, h2, z and the weights as nemo_mlp_fwd takes them, the
// cotangent gout (B,O); outputs gx (B,D) and the gradients of W1, b1, W2,
// b2, W3, b3, Wo, bo in their shapes; scratch of nemo_mlp_scratch_floats.
extern "C" int nemo_mlp_bwd(int B, int D, int H, int O, const float* gout,
                            const float* x, const float* h1, const float* h2,
                            const float* z, const float* W1, const float* W2,
                            const float* W3, const float* Wo, float* gx,
                            float* gW1, float* gb1, float* gW2, float* gb2,
                            float* gW3, float* gb3, float* gWo, float* gbo,
                            float* scratch, cudaStream_t stream) {
  if (bad_shape(B, D, H, O)) return (int)cudaErrorInvalidValue;
  float* ga = scratch;                    // gz, then gh1 (B,H)
  float* gb = scratch + (size_t)B * H;    // gh2 (B,H)
  float* partial = scratch + 2 * (size_t)B * H;
  // layer by layer from the output: (input activation act (B,K_in), its
  // weight W (K_in,N), the cotangent on the layer's output g (B,N), the
  // weight and bias gradients, the cotangent on act and the mask it takes
  // (act itself; none for x))
  const struct {
    const float *act, *W, *g;
    int K_in, N;
    float *gW, *gbias, *gact;
    const float* mask;
  } layers[] = {{z, Wo, gout, H, O, gWo, gbo, ga, z},
                {h2, W3, ga, H, H, gW3, gb3, gb, h2},
                {h1, W2, gb, H, H, gW2, gb2, ga, h1},
                {x, W1, ga, D, H, gW1, gb1, gx, nullptr}};
  for (const auto& l : layers) {
    Gemm w = gemm(l.K_in, l.N, B, l.act, l.K_in, l.g, l.N, l.gW, l.N);
    w.gbias = l.gbias;
    if (cudaError_t err = run<true, false>(w, partial, stream)) return (int)err;
    Gemm a = gemm(B, l.K_in, l.N, l.g, l.N, l.W, l.N, l.gact, l.K_in);
    a.mask = l.mask;
    if (cudaError_t err = run<false, true>(a, partial, stream)) return (int)err;
  }
  return (int)cudaSuccess;
}
