// GroupNorm followed by ReLU (K7), forward and backward, over an (R, C)
// float32 tensor in G groups of S = C / G neighbouring columns:
//
//   m    = sum_g(x) / S                     (the group's mean)
//   r    = 1 / sqrt(sum_g((x - m)^2) / S + eps)
//   xh   = (x - m) r
//   y    = relu(xh gamma + beta)
//
// Backward, with gz = gy where xh gamma + beta > 0 (else 0) and gg = gz gamma:
//
//   dx     = r ((gg - sum_g(gg) / S) - xh sum_g(gg xh) / S)
//   dgamma = sum over rows of gz xh,   dbeta = sum over rows of gz
//
// It replaces no TPU kernel: XLA fuses the JAX package's composition
// (nemo_tpu/models/humor.py:_group_norm and the ReLU after it) for the TPU.
// Eager PyTorch runs that composition (nemo_tpu_torch/models/humor.py
// _group_norm) as about 11 kernels forward and 20 backward, each a trip of
// the (R, C) tensor through device memory. HuMoR's encoder and conditional
// prior have four such layers each at C = 1024, G = 16, on every row of the
// fit's batch.
//
// What bounds it on the H100: bytes. A layer reads x and writes y forward
// (8 bytes a value), reads x and gy and writes dx backward (12), and does a
// few operations a byte. The design moves those bytes once:
//
// - One warp a row. Lane l holds the row's float4s l, l + 32, ... in
//   registers (C / 128 of them, C at most 1024), loaded and stored 16 bytes
//   a thread, neighbouring lanes on neighbouring addresses. The mean and
//   the centred squares (two passes over the registers, as the eager
//   composition takes them) and the outputs need no second read of x.
// - A group's sum in a fixed order: each lane's float4 summed left to
//   right, then a butterfly of shuffles over the q = S / 4 lanes that hold
//   the group (offsets q/2 down to 1), or, where a group spans q / 32 > 1
//   float4s of every lane, a butterfly over the warp and then the float4s'
//   sums in order. Every lane of a group ends with the same bits.
// - The forward saves the mean and 1 / sqrt(var + eps) of each (row,
//   group); the backward recomputes xh and the ReLU's mask from x and those,
//   so y is never read again.
// - Where gamma and beta need gradients (HuMoR training), the backward's
//   blocks take fixed runs of rows, each lane summing its columns' gz xh and
//   gz over the rows its warp takes, the block's warps summed in warp order
//   into one partial a block, and a second kernel sums the partials in block
//   order: no atomics, so a rerun gives the same bits.
//
// Every multiply-add is written as fmaf and every other product and sum
// apart, so nvcc contracts nothing: ops/_emulation.py, gn_relu_fwd_emulation
// and gn_relu_bwd_emulation, repeat this arithmetic on the CPU.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;  // warps (rows at a time) a block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxVec = 8;  // float4s a lane: C at most 128 * kMaxVec
constexpr int kMaxPartialBlocks = 256;
constexpr int kRowsPerPartialBlock = 64;

// Blocks of the backward that sums dgamma and dbeta, a function of R alone
// (ops/groupnorm.py wgrad_blocks): about kRowsPerPartialBlock rows each, at
// most kMaxPartialBlocks, each of ceil(R / blocks) rows but the last, and
// none empty.
int wgrad_blocks(int R) {
  if (R <= kRowsPerPartialBlock) return 1;
  int nb = (R + kRowsPerPartialBlock - 1) / kRowsPerPartialBlock;
  if (nb > kMaxPartialBlocks) nb = kMaxPartialBlocks;
  const int rpb = (R + nb - 1) / nb;
  return (R + rpb - 1) / rpb;
}

// The shapes the kernels take: C a multiple of 128 up to 128 * kMaxVec, G
// groups of S = C / G columns, S a multiple of 4, and q = S / 4 either a
// divisor of 32 or a multiple of it.
bool shape_ok(int R, int C, int G) {
  if (R < 0 || C <= 0 || G <= 0 || C % 128 != 0 || C > 128 * kMaxVec ||
      C % G != 0)
    return false;
  const int S = C / G;
  if (S % 4 != 0) return false;
  const int q = S / 4;
  return q <= 32 ? 32 % q == 0 : q % 32 == 0;
}

__device__ __forceinline__ float sum4(float4 a) {
  return ((a.x + a.y) + a.z) + a.w;
}

// s[k], the lane's partial for its float4 k, becomes the sum over the
// group that float4 belongs to, in the order the note above gives.
template <int NV>
__device__ __forceinline__ void group_sums(float (&s)[NV], int q) {
  const int seg = q < 32 ? q : 32;
#pragma unroll
  for (int k = 0; k < NV; ++k)
    for (int off = seg >> 1; off > 0; off >>= 1)
      s[k] += __shfl_xor_sync(0xffffffffu, s[k], off);
  if (q > 32) {
    const int kq = q >> 5;
    float run = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      run = (k % kq == 0) ? s[k] : run + s[k];
      s[k] = run;
    }
    float total = 0.f;
#pragma unroll
    for (int k = NV - 1; k >= 0; --k) {
      if ((k + 1) % kq == 0) total = s[k];
      s[k] = total;
    }
  }
}

__device__ __forceinline__ float relu(float z) { return z < 0.f ? 0.f : z; }

template <int NV>
__global__ void __launch_bounds__(kThreads)
    humor_gn_fwd_kernel(int R, int C, int G, const float* __restrict__ x,
                        const float* __restrict__ gamma,
                        const float* __restrict__ beta, float eps,
                        float* __restrict__ y, float* __restrict__ mean,
                        float* __restrict__ rstd) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= R) return;
  const int S = C / G, q = S / 4;
  const float fS = (float)S;
  const float4* xr = reinterpret_cast<const float4*>(x + (size_t)row * C);
  float4 v[NV];
  float s[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    v[k] = xr[lane + 32 * k];
    s[k] = sum4(v[k]);
  }
  group_sums<NV>(s, q);
  float m[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    m[k] = s[k] / fS;
    const float a = v[k].x - m[k], b = v[k].y - m[k], c = v[k].z - m[k],
                d = v[k].w - m[k];
    s[k] = fmaf(d, d, fmaf(c, c, fmaf(b, b, a * a)));
  }
  group_sums<NV>(s, q);
  const float4* g4 = reinterpret_cast<const float4*>(gamma);
  const float4* b4 = reinterpret_cast<const float4*>(beta);
  float4* yr = reinterpret_cast<float4*>(y + (size_t)row * C);
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c4 = lane + 32 * k;
    const float r = 1.0f / sqrtf(s[k] / fS + eps);
    const float4 g = g4[c4], b = b4[c4];
    float4 o;
    o.x = relu(fmaf((v[k].x - m[k]) * r, g.x, b.x));
    o.y = relu(fmaf((v[k].y - m[k]) * r, g.y, b.y));
    o.z = relu(fmaf((v[k].z - m[k]) * r, g.z, b.z));
    o.w = relu(fmaf((v[k].w - m[k]) * r, g.w, b.w));
    yr[c4] = o;
    if (c4 % q == 0) {
      mean[(size_t)row * G + c4 / q] = m[k];
      rstd[(size_t)row * G + c4 / q] = r;
    }
  }
}

// One row's backward: writes its dx and, with WG, adds its gz xh and gz to
// the lane's column accumulators ag and ab.
template <int NV, bool WG>
__device__ __forceinline__ void bwd_row(int row, int lane, int C, int G,
                                        const float* __restrict__ x,
                                        const float* __restrict__ gamma,
                                        const float* __restrict__ beta,
                                        const float* __restrict__ mean,
                                        const float* __restrict__ rstd,
                                        const float* __restrict__ gy,
                                        float* __restrict__ dx,
                                        float4 (&ag)[NV], float4 (&ab)[NV]) {
  const int S = C / G, q = S / 4;
  const float fS = (float)S;
  const float4* xr = reinterpret_cast<const float4*>(x + (size_t)row * C);
  const float4* gr = reinterpret_cast<const float4*>(gy + (size_t)row * C);
  const float4* g4 = reinterpret_cast<const float4*>(gamma);
  const float4* b4 = reinterpret_cast<const float4*>(beta);
  float4 xh[NV], gg[NV];
  float r[NV], s1[NV], s2[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c4 = lane + 32 * k;
    const size_t grp = (size_t)row * G + c4 / q;
    const float m = mean[grp];
    r[k] = rstd[grp];
    const float4 v = xr[c4], g = gr[c4], ga = g4[c4], be = b4[c4];
    xh[k].x = (v.x - m) * r[k];
    xh[k].y = (v.y - m) * r[k];
    xh[k].z = (v.z - m) * r[k];
    xh[k].w = (v.w - m) * r[k];
    float4 gz;
    gz.x = fmaf(xh[k].x, ga.x, be.x) > 0.f ? g.x : 0.f;
    gz.y = fmaf(xh[k].y, ga.y, be.y) > 0.f ? g.y : 0.f;
    gz.z = fmaf(xh[k].z, ga.z, be.z) > 0.f ? g.z : 0.f;
    gz.w = fmaf(xh[k].w, ga.w, be.w) > 0.f ? g.w : 0.f;
    if (WG) {
      ag[k].x = fmaf(gz.x, xh[k].x, ag[k].x);
      ag[k].y = fmaf(gz.y, xh[k].y, ag[k].y);
      ag[k].z = fmaf(gz.z, xh[k].z, ag[k].z);
      ag[k].w = fmaf(gz.w, xh[k].w, ag[k].w);
      ab[k].x += gz.x;
      ab[k].y += gz.y;
      ab[k].z += gz.z;
      ab[k].w += gz.w;
    }
    gg[k].x = gz.x * ga.x;
    gg[k].y = gz.y * ga.y;
    gg[k].z = gz.z * ga.z;
    gg[k].w = gz.w * ga.w;
    s1[k] = sum4(gg[k]);
    s2[k] = fmaf(gg[k].w, xh[k].w,
                 fmaf(gg[k].z, xh[k].z,
                      fmaf(gg[k].y, xh[k].y, gg[k].x * xh[k].x)));
  }
  group_sums<NV>(s1, q);
  group_sums<NV>(s2, q);
  float4* dr = reinterpret_cast<float4*>(dx + (size_t)row * C);
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const float m1 = s1[k] / fS, m2 = s2[k] / fS;
    float4 o;
    o.x = r[k] * fmaf(-xh[k].x, m2, gg[k].x - m1);
    o.y = r[k] * fmaf(-xh[k].y, m2, gg[k].y - m1);
    o.z = r[k] * fmaf(-xh[k].z, m2, gg[k].z - m1);
    o.w = r[k] * fmaf(-xh[k].w, m2, gg[k].w - m1);
    dr[lane + 32 * k] = o;
  }
}

// dx alone: one warp a row, as the forward.
template <int NV>
__global__ void __launch_bounds__(kThreads)
    humor_gn_bwd_kernel(int R, int C, int G, const float* __restrict__ x,
                        const float* __restrict__ gamma,
                        const float* __restrict__ beta,
                        const float* __restrict__ mean,
                        const float* __restrict__ rstd,
                        const float* __restrict__ gy, float* __restrict__ dx) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= R) return;
  float4 unused[NV];
  bwd_row<NV, false>(row, threadIdx.x & 31, C, G, x, gamma, beta, mean, rstd,
                     gy, dx, unused, unused);
}

// dx, and each block's partial of dgamma and dbeta: block b takes rows
// [b rpb, (b + 1) rpb), its warp w the rows b rpb + w, + kWarps, ...;
// part holds (blocks, C) partials of dgamma, then (blocks, C) of dbeta.
template <int NV>
__global__ void __launch_bounds__(kThreads)
    humor_gn_bwd_wgrad_kernel(int R, int C, int G, int rpb,
                              const float* __restrict__ x,
                              const float* __restrict__ gamma,
                              const float* __restrict__ beta,
                              const float* __restrict__ mean,
                              const float* __restrict__ rstd,
                              const float* __restrict__ gy,
                              float* __restrict__ dx,
                              float* __restrict__ part) {
  __shared__ float4 red[kWarps][32 * kMaxVec];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float4 ag[NV], ab[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    ag[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    ab[k] = ag[k];
  }
  const int lo = blockIdx.x * rpb;
  const int hi = min(R, lo + rpb);
  for (int row = lo + warp; row < hi; row += kWarps)
    bwd_row<NV, true>(row, lane, C, G, x, gamma, beta, mean, rstd, gy, dx,
                      ag, ab);
  // the block's warps in warp order, dgamma then dbeta
  const int C4 = C / 4;
  const size_t nb = gridDim.x;
  float4* out = reinterpret_cast<float4*>(part);
  for (int which = 0; which < 2; ++which) {
#pragma unroll
    for (int k = 0; k < NV; ++k) red[warp][lane + 32 * k] = which ? ab[k] : ag[k];
    __syncthreads();
    for (int c4 = threadIdx.x; c4 < C4; c4 += kThreads) {
      float4 a = red[0][c4];
      for (int w = 1; w < kWarps; ++w) {
        const float4 b = red[w][c4];
        a.x += b.x;
        a.y += b.y;
        a.z += b.z;
        a.w += b.w;
      }
      out[(which * nb + blockIdx.x) * C4 + c4] = a;
    }
    __syncthreads();
  }
}

// dgamma[c] and dbeta[c]: the blocks' partials summed in block order.
__global__ void humor_gn_wgrad_reduce_kernel(int C, int nb,
                                             const float* __restrict__ part,
                                             float* __restrict__ dgamma,
                                             float* __restrict__ dbeta) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= 2 * C) return;
  const int which = c / C, col = c % C;
  const float* p = part + (size_t)which * nb * C + col;
  float a = p[0];
  for (int b = 1; b < nb; ++b) a += p[(size_t)b * C];
  (which ? dbeta : dgamma)[col] = a;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int NV>
int launch_fwd(int R, int C, int G, const float* x, const float* gamma,
               const float* beta, float eps, float* y, float* mean,
               float* rstd, cudaStream_t stream) {
  humor_gn_fwd_kernel<NV><<<(R + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      R, C, G, x, gamma, beta, eps, y, mean, rstd);
  return (int)cudaGetLastError();
}

template <int NV>
int launch_bwd(int R, int C, int G, const float* x, const float* gamma,
               const float* beta, const float* mean, const float* rstd,
               const float* gy, float* dx, float* dgamma, float* dbeta,
               float* scratch, cudaStream_t stream) {
  if (dgamma == nullptr) {
    humor_gn_bwd_kernel<NV><<<(R + kWarps - 1) / kWarps, kThreads, 0,
                              stream>>>(R, C, G, x, gamma, beta, mean, rstd,
                                        gy, dx);
    return (int)cudaGetLastError();
  }
  const int nb = wgrad_blocks(R);
  const int rpb = (R + nb - 1) / nb;
  humor_gn_bwd_wgrad_kernel<NV><<<nb, kThreads, 0, stream>>>(
      R, C, G, rpb, x, gamma, beta, mean, rstd, gy, dx, scratch);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  humor_gn_wgrad_reduce_kernel<<<(2 * C + 255) / 256, 256, 0, stream>>>(
      C, nb, scratch, dgamma, dbeta);
  return (int)cudaGetLastError();
}

template <int NV>
int attributes(int backward, int wgrad, int* out) {
  cudaFuncAttributes a;
  cudaError_t err =
      !backward ? cudaFuncGetAttributes(&a, humor_gn_fwd_kernel<NV>)
      : wgrad   ? cudaFuncGetAttributes(&a, humor_gn_bwd_wgrad_kernel<NV>)
                : cudaFuncGetAttributes(&a, humor_gn_bwd_kernel<NV>);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = 0;
  out[3] = (int)a.localSizeBytes;
  return 0;
}

}  // namespace

// The instantiation for C / 128 float4s a lane, as a function pointer
// table: fn(NV) for NV = 1 .. kMaxVec.
template <template <int> class F>
auto by_vec(int C) -> decltype(&F<1>::run) {
  switch (C / 128) {
    case 1: return &F<1>::run;
    case 2: return &F<2>::run;
    case 3: return &F<3>::run;
    case 4: return &F<4>::run;
    case 5: return &F<5>::run;
    case 6: return &F<6>::run;
    case 7: return &F<7>::run;
    default: return &F<8>::run;
  }
}

template <int NV>
struct Fwd {
  static int run(int R, int C, int G, const float* x, const float* gamma,
                 const float* beta, float eps, float* y, float* mean,
                 float* rstd, cudaStream_t stream) {
    return launch_fwd<NV>(R, C, G, x, gamma, beta, eps, y, mean, rstd,
                          stream);
  }
};

template <int NV>
struct Bwd {
  static int run(int R, int C, int G, const float* x, const float* gamma,
                 const float* beta, const float* mean, const float* rstd,
                 const float* gy, float* dx, float* dgamma, float* dbeta,
                 float* scratch, cudaStream_t stream) {
    return launch_bwd<NV>(R, C, G, x, gamma, beta, mean, rstd, gy, dx,
                          dgamma, dbeta, scratch, stream);
  }
};

template <int NV>
struct Attr {
  static int run(int backward, int wgrad, int* out) {
    return attributes<NV>(backward, wgrad, out);
  }
};

// x (R, C), gamma and beta (C,), all float32, contiguous, 16-byte aligned;
// writes y (R, C), mean and rstd (R, G). R = 0 launches nothing.
extern "C" int nemo_gn_relu_fwd(int R, int C, int G, const float* x,
                                const float* gamma, const float* beta,
                                float eps, float* y, float* mean, float* rstd,
                                cudaStream_t stream) {
  if (!shape_ok(R, C, G) || !aligned16(x) || !aligned16(gamma) ||
      !aligned16(beta) || !aligned16(y))
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  return by_vec<Fwd>(C)(R, C, G, x, gamma, beta, eps, y, mean, rstd, stream);
}

// The forward's x, gamma, beta, mean and rstd, and gy (R, C); writes dx
// (R, C) and, where dgamma is not null, dgamma and dbeta (C,), through
// scratch of nemo_gn_relu_scratch_floats(R, C) floats.
extern "C" int nemo_gn_relu_bwd(int R, int C, int G, const float* x,
                                const float* gamma, const float* beta,
                                const float* mean, const float* rstd,
                                const float* gy, float* dx, float* dgamma,
                                float* dbeta, float* scratch,
                                cudaStream_t stream) {
  if (!shape_ok(R, C, G) || !aligned16(x) || !aligned16(gamma) ||
      !aligned16(beta) || !aligned16(gy) || !aligned16(dx) ||
      (dgamma != nullptr && (dbeta == nullptr || !aligned16(scratch))))
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  return by_vec<Bwd>(C)(R, C, G, x, gamma, beta, mean, rstd, gy, dx, dgamma,
                        dbeta, scratch, stream);
}

// Floats of scratch nemo_gn_relu_bwd needs for dgamma and dbeta at (R, C).
extern "C" int nemo_gn_relu_scratch_floats(int R, int C) {
  return 2 * wgrad_blocks(R) * C;
}

// The forward (backward = 0) or backward kernel's resources (wgrad: the one
// that sums dgamma and dbeta) at width C: out[0..3] = registers a thread,
// static shared memory bytes, dynamic shared memory bytes, local bytes.
extern "C" int nemo_gn_relu_attributes(int backward, int wgrad, int C,
                                       int* out) {
  if (!shape_ok(0, C, C / 4 > 0 ? C / 4 : 1)) return (int)cudaErrorInvalidValue;
  return by_vec<Attr>(C)(backward, wgrad, out);
}
