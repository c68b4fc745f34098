// Forward kinematics over a static kinematic tree: the Hopper port of
// nemo_tpu/ops/fk_pallas.py (_fk_fwd_kernel / _fk_bwd_kernel).
//
//   R_g[j] = R_g[p] R_l[j]          t_g[j] = R_g[p] t_l[j] + t_g[p]
//
// Backward (reverse accumulation, children before parents):
//   gR_g[p] += gR_g[j] R_l[j]^T + gt_g[j] (x) t_l[j]    gt_g[p] += gt_g[j]
//   gR_l[j]  = R_g[p]^T gR_g[j]                         gt_l[j] = R_g[p]^T gt_g[j]
//
// Design: one thread per batch element walks the whole tree in the static
// topological order, which the host passes by value (no device copy of the
// tree). On the H100 this is launch- and latency-bound at the fit's batch of
// 512 (4 warps' worth of threads): what it replaces is the plain PyTorch
// per-joint chain of about 50 small kernels per call, so one launch per
// direction is the whole gain. The backward's running accumulators live in
// a scratch buffer the caller allocates, laid out (J*12, B) so that
// neighbouring threads touch neighbouring addresses.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxJoints = 64;

struct Tree {
  int parents[kMaxJoints];
  int order[kMaxJoints];  // topological order without the root, J-1 entries
};

__global__ void fk_fwd_kernel(const float* __restrict__ R_l,
                              const float* __restrict__ t_l, int B, int J,
                              Tree tree, float* R_g, float* t_g) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* rl = R_l + (size_t)b * J * 9;
  const float* tl = t_l + (size_t)b * J * 3;
  float* rg = R_g + (size_t)b * J * 9;
  float* tg = t_g + (size_t)b * J * 3;
  for (int c = 0; c < 9; ++c) rg[c] = rl[c];
  for (int c = 0; c < 3; ++c) tg[c] = tl[c];
  for (int n = 0; n < J - 1; ++n) {
    const int j = tree.order[n];
    const int p = tree.parents[j];
    float Rp[9], Rl[9], tv[3], tp[3];
    for (int c = 0; c < 9; ++c) { Rp[c] = rg[p * 9 + c]; Rl[c] = rl[j * 9 + c]; }
    for (int c = 0; c < 3; ++c) { tv[c] = tl[j * 3 + c]; tp[c] = tg[p * 3 + c]; }
    for (int i = 0; i < 3; ++i) {
      for (int k = 0; k < 3; ++k)
        rg[j * 9 + 3 * i + k] = Rp[3 * i + 0] * Rl[0 + k] +
                                Rp[3 * i + 1] * Rl[3 + k] +
                                Rp[3 * i + 2] * Rl[6 + k];
      tg[j * 3 + i] = (Rp[3 * i] * tv[0] + Rp[3 * i + 1] * tv[1] +
                       Rp[3 * i + 2] * tv[2]) + tp[i];
    }
  }
}

__global__ void fk_bwd_kernel(const float* __restrict__ R_l,
                              const float* __restrict__ t_l,
                              const float* __restrict__ R_g,
                              const float* __restrict__ gR_g,
                              const float* __restrict__ gt_g, int B, int J,
                              Tree tree, float* acc, float* gR_l, float* gt_l) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t rb9 = (size_t)b * J * 9, rb3 = (size_t)b * J * 3;
  // acc[(j*12 + c) * B + b]: c < 9 rotation cotangent, c >= 9 translation
  for (int j = 0; j < J; ++j) {
    for (int c = 0; c < 9; ++c) acc[(size_t)(j * 12 + c) * B + b] = gR_g[rb9 + j * 9 + c];
    for (int c = 0; c < 3; ++c) acc[(size_t)(j * 12 + 9 + c) * B + b] = gt_g[rb3 + j * 3 + c];
  }
  for (int n = J - 2; n >= 0; --n) {
    const int j = tree.order[n];
    const int p = tree.parents[j];
    float gR[9], gt[3], Rl[9], tl[3], Rp[9];
    for (int c = 0; c < 9; ++c) {
      gR[c] = acc[(size_t)(j * 12 + c) * B + b];
      Rl[c] = R_l[rb9 + j * 9 + c];
      Rp[c] = R_g[rb9 + p * 9 + c];
    }
    for (int c = 0; c < 3; ++c) {
      gt[c] = acc[(size_t)(j * 12 + 9 + c) * B + b];
      tl[c] = t_l[rb3 + j * 3 + c];
    }
    for (int i = 0; i < 3; ++i)
      for (int k = 0; k < 3; ++k) {
        const float add = gR[3 * i + 0] * Rl[3 * k + 0] +
                          gR[3 * i + 1] * Rl[3 * k + 1] +
                          gR[3 * i + 2] * Rl[3 * k + 2] + gt[i] * tl[k];
        acc[(size_t)(p * 12 + 3 * i + k) * B + b] += add;
      }
    for (int i = 0; i < 3; ++i) acc[(size_t)(p * 12 + 9 + i) * B + b] += gt[i];
    for (int i = 0; i < 3; ++i) {
      for (int k = 0; k < 3; ++k)
        gR_l[rb9 + j * 9 + 3 * i + k] = Rp[0 + i] * gR[0 + k] +
                                        Rp[3 + i] * gR[3 + k] +
                                        Rp[6 + i] * gR[6 + k];
      gt_l[rb3 + j * 3 + i] = Rp[i] * gt[0] + Rp[3 + i] * gt[1] + Rp[6 + i] * gt[2];
    }
  }
  for (int c = 0; c < 9; ++c) gR_l[rb9 + c] = acc[(size_t)c * B + b];
  for (int c = 0; c < 3; ++c) gt_l[rb3 + c] = acc[(size_t)(9 + c) * B + b];
}

int make_tree(const int* parents, const int* order, int J, Tree* tree) {
  if (J < 1 || J > kMaxJoints) return (int)cudaErrorInvalidValue;
  for (int j = 0; j < J; ++j) tree->parents[j] = parents[j];
  for (int n = 0; n < J - 1; ++n) tree->order[n] = order[n];
  return 0;
}

constexpr int kThreads = 128;

}  // namespace

extern "C" int nemo_fk_fwd(const float* R_l, const float* t_l,
                           const int* parents, const int* order, int B, int J,
                           float* R_g, float* t_g, cudaStream_t stream) {
  Tree tree;
  if (int err = make_tree(parents, order, J, &tree)) return err;
  if (B <= 0) return (int)cudaErrorInvalidValue;
  fk_fwd_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      R_l, t_l, B, J, tree, R_g, t_g);
  return (int)cudaGetLastError();
}

extern "C" int nemo_fk_bwd(const float* R_l, const float* t_l, const float* R_g,
                           const float* gR_g, const float* gt_g,
                           const int* parents, const int* order, int B, int J,
                           float* acc, float* gR_l, float* gt_l,
                           cudaStream_t stream) {
  Tree tree;
  if (int err = make_tree(parents, order, J, &tree)) return err;
  if (B <= 0) return (int)cudaErrorInvalidValue;
  fk_bwd_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      R_l, t_l, R_g, gR_g, gt_g, B, J, tree, acc, gR_l, gt_l);
  return (int)cudaGetLastError();
}
