// Forward kinematics over a static kinematic tree (K1): the Hopper port of
// nemo_tpu/ops/fk_pallas.py, _fk_fwd_pallas (_fk_fwd_kernel) and
// _fk_bwd_pallas (_fk_bwd_kernel).
//
//   R_g[j] = R_g[p] R_l[j]          t_g[j] = R_g[p] t_l[j] + t_g[p]
//
// Backward (reverse accumulation, children before parents):
//   gR_g[p] += gR_g[j] R_l[j]^T + gt_g[j] (x) t_l[j]    gt_g[p] += gt_g[j]
//   gR_l[j]  = R_g[p]^T gR_g[j]                         gt_l[j] = R_g[p]^T gt_g[j]
//
// What bounds it on the H100. The work is tiny: at the fit's batch of 512
// the forward moves 1.2 MB and the backward 2.2 MB (0.4 and 0.7 us at 3.35
// TB/s), and both are a few MFLOP. What costs is the launch and the
// dependent chain: a joint needs its parent's global transform, so SMPL's
// 24 joints form 8 dependent levels below the root, and every step of the
// chain waits for the one before.
//
// The design does three things about that.
// - A block takes a tile of kTile consecutive batch elements (256 blocks
//   at B=512, more than the card's 132 SMs). In (B, J, ...) order the
//   tile's operands are contiguous, so the block copies them into shared
//   memory with coalesced 16-byte loads where the address allows (4-byte
//   loads otherwise), and stores its outputs the same way from shared
//   memory.
// - The tree is walked level by level, not joint by joint: the host groups
//   the joints by depth once per tree (ops/fk.py kinematic_tree) and passes
//   the levels by value. In a level the block's threads take (element,
//   joint, output component) items, each a 3-term dot product read from
//   shared memory; one barrier separates the levels. SMPL takes 8
//   dependent steps in place of 23, and no device-memory access sits
//   inside the walk.
// - The backward keeps its accumulators in shared memory. Deepest level
//   first, one step a level: the level's joints write their local
//   cotangents, and each joint of the level above folds its children's
//   contributions into its accumulator in one fixed order (its children in
//   reverse topological order, the order of fk_bwd_plain and of the TPU
//   kernel). No atomics: a rerun gives the same bits.
// Every multiply-add is an explicit fmaf in a fixed order (dot3 below), so
// the arithmetic is the one ops/fk.py's fk_fwd_emulation and
// fk_bwd_emulation repeat on the CPU.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxJoints = 64;
constexpr int kTile = 2;      // batch elements a block
constexpr int kThreads = 128;

// The tree as ops/fk.py packs it (kinematic_tree().packed):
//   J, levels, parent[J], order[J], level_start[levels + 1],
//   child_start[J + 1], child[J - 1].
// order lists the joints level by level, root first: level l is
// order[level_start[l] .. level_start[l + 1]). Joint p's children, in
// reverse topological order, are child[child_start[p] .. child_start[p+1]).
struct Tree {
  int J, levels;
  int parent[kMaxJoints];
  int order[kMaxJoints];
  int level_start[kMaxJoints + 1];
  int child_start[kMaxJoints + 1];
  int child[kMaxJoints];
};

// Unpacks and checks the host's tree: every index in range and every range
// in order, so that no thread can leave the block's shared memory.
int make_tree(const int* packed, int J, Tree* tree) {
  if (J < 1 || J > kMaxJoints || packed == nullptr || packed[0] != J)
    return (int)cudaErrorInvalidValue;
  const int L = packed[1];
  if (L < 1 || L > J) return (int)cudaErrorInvalidValue;
  tree->J = J;
  tree->levels = L;
  const int* p = packed + 2;
  for (int j = 0; j < J; ++j) tree->parent[j] = *p++;
  for (int n = 0; n < J; ++n) tree->order[n] = *p++;
  for (int l = 0; l <= L; ++l) tree->level_start[l] = *p++;
  for (int j = 0; j <= J; ++j) tree->child_start[j] = *p++;
  for (int n = 0; n < J - 1; ++n) tree->child[n] = *p++;
  bool ok = tree->level_start[0] == 0 && tree->level_start[1] == 1 &&
            tree->level_start[L] == J && tree->order[0] == 0 &&
            tree->child_start[0] == 0 && tree->child_start[J] == J - 1;
  for (int l = 0; l < L; ++l)
    ok = ok && tree->level_start[l] < tree->level_start[l + 1];
  for (int j = 0; j < J; ++j) {
    ok = ok && tree->order[j] >= (j > 0 ? 1 : 0) && tree->order[j] < J &&
         tree->child_start[j] <= tree->child_start[j + 1];
    if (j > 0) ok = ok && tree->parent[j] >= 0 && tree->parent[j] < J;
  }
  for (int n = 0; n < J - 1; ++n)
    ok = ok && tree->child[n] > 0 && tree->child[n] < J;
  return ok ? 0 : (int)cudaErrorInvalidValue;
}

__host__ __device__ constexpr int pad4(int n) { return (n + 3) & ~3; }

// Shared-memory floats of a block: the forward holds R_l, t_l, R_g, t_g;
// the backward R_l, t_l, R_g, the accumulators (gR_g, gt_g in place) and
// the outputs gR_l, gt_l. Each array starts on a 16-byte boundary.
__host__ __device__ constexpr int smem_floats(int J, bool backward) {
  return backward ? 4 * pad4(kTile * J * 9) + 3 * pad4(kTile * J * 3)
                  : 2 * pad4(kTile * J * 9) + 2 * pad4(kTile * J * 3);
}

__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return fmaf(a2, b2, fmaf(a1, b1, a0 * b0));
}

// n floats from src to dst by the whole block, neighbouring threads on
// neighbouring addresses: one side in device memory, the other in shared
// memory (always on a 16-byte boundary); 16 bytes a thread when the
// device-memory side lies on a 16-byte boundary too, else 4.
__device__ void block_copy(float* __restrict__ dst,
                           const float* __restrict__ src, int n) {
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) &
       15) == 0) {
    const int n4 = n >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < n4; i += blockDim.x) d4[i] = s4[i];
    for (int i = 4 * n4 + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

__global__ void __launch_bounds__(kThreads)
fk_fwd_kernel(const float* __restrict__ R_l, const float* __restrict__ t_l,
              int B, Tree tree, float* __restrict__ R_g,
              float* __restrict__ t_g) {
  extern __shared__ float4 smem4[];
  const int J = tree.J;
  const int b0 = blockIdx.x * kTile;
  const int ne = min(kTile, B - b0);
  float* rl = reinterpret_cast<float*>(smem4);
  float* tl = rl + pad4(kTile * J * 9);
  float* rg = tl + pad4(kTile * J * 3);
  float* tg = rg + pad4(kTile * J * 9);
  block_copy(rl, R_l + (size_t)b0 * J * 9, ne * J * 9);
  block_copy(tl, t_l + (size_t)b0 * J * 3, ne * J * 3);
  __syncthreads();
  for (int l = 0; l < tree.levels; ++l) {
    const int first = tree.level_start[l];
    const int w12 = 12 * (tree.level_start[l + 1] - first);
    for (int it = threadIdx.x; it < ne * w12; it += blockDim.x) {
      const int e = it / w12, r = it - e * w12;
      const int q = r / 12, c = r - 12 * q;
      const int j = tree.order[first + q], ej = e * J + j;
      if (l == 0) {   // the root: its local transform
        if (c < 9) rg[ej * 9 + c] = rl[ej * 9 + c];
        else tg[ej * 3 + c - 9] = tl[ej * 3 + c - 9];
        continue;
      }
      const int ep = e * J + tree.parent[j];
      const float* Rp = rg + ep * 9;
      if (c < 9) {
        const int i = c / 3, k = c - 3 * i;
        const float* Rl = rl + ej * 9;
        rg[ej * 9 + c] = dot3(Rp[3 * i], Rp[3 * i + 1], Rp[3 * i + 2], Rl[k],
                              Rl[3 + k], Rl[6 + k]);
      } else {
        const int i = c - 9;
        const float* tv = tl + ej * 3;
        tg[ej * 3 + i] = dot3(Rp[3 * i], Rp[3 * i + 1], Rp[3 * i + 2], tv[0],
                              tv[1], tv[2]) + tg[ep * 3 + i];
      }
    }
    __syncthreads();
  }
  block_copy(R_g + (size_t)b0 * J * 9, rg, ne * J * 9);
  block_copy(t_g + (size_t)b0 * J * 3, tg, ne * J * 3);
}

__global__ void __launch_bounds__(kThreads)
fk_bwd_kernel(const float* __restrict__ R_l, const float* __restrict__ t_l,
              const float* __restrict__ R_g, const float* __restrict__ gR_g,
              const float* __restrict__ gt_g, int B, Tree tree,
              float* __restrict__ gR_l, float* __restrict__ gt_l) {
  extern __shared__ float4 smem4[];
  const int J = tree.J;
  const int b0 = blockIdx.x * kTile;
  const int ne = min(kTile, B - b0);
  const int n9 = pad4(kTile * J * 9), n3 = pad4(kTile * J * 3);
  float* rl = reinterpret_cast<float*>(smem4);
  float* rg = rl + n9;
  float* ar = rg + n9;      // rotation accumulators, from gR_g
  float* grl = ar + n9;
  float* tl = grl + n9;
  float* at = tl + n3;      // translation accumulators, from gt_g
  float* gtl = at + n3;
  block_copy(rl, R_l + (size_t)b0 * J * 9, ne * J * 9);
  block_copy(rg, R_g + (size_t)b0 * J * 9, ne * J * 9);
  block_copy(ar, gR_g + (size_t)b0 * J * 9, ne * J * 9);
  block_copy(tl, t_l + (size_t)b0 * J * 3, ne * J * 3);
  block_copy(at, gt_g + (size_t)b0 * J * 3, ne * J * 3);
  __syncthreads();
  // Step l reads level l's accumulators, complete since step l + 1, writes
  // level l's outputs and folds level l into level l - 1's accumulators.
  for (int l = tree.levels - 1; l >= 0; --l) {
    const int first = tree.level_start[l];
    const int w12 = 12 * (tree.level_start[l + 1] - first);
    for (int it = threadIdx.x; it < ne * w12; it += blockDim.x) {
      const int e = it / w12, r = it - e * w12;
      const int q = r / 12, c = r - 12 * q;
      const int j = tree.order[first + q], ej = e * J + j;
      if (l == 0) {   // the root: its accumulators
        if (c < 9) grl[ej * 9 + c] = ar[ej * 9 + c];
        else gtl[ej * 3 + c - 9] = at[ej * 3 + c - 9];
        continue;
      }
      const float* Rp = rg + (e * J + tree.parent[j]) * 9;
      if (c < 9) {    // gR_l = R_p^T gR
        const int i = c / 3, k = c - 3 * i;
        const float* gR = ar + ej * 9;
        grl[ej * 9 + c] = dot3(Rp[i], Rp[3 + i], Rp[6 + i], gR[k], gR[3 + k],
                               gR[6 + k]);
      } else {        // gt_l = R_p^T gt
        const int i = c - 9;
        const float* gt = at + ej * 3;
        gtl[ej * 3 + i] = dot3(Rp[i], Rp[3 + i], Rp[6 + i], gt[0], gt[1],
                               gt[2]);
      }
    }
    if (l == 0) break;
    const int pfirst = tree.level_start[l - 1];
    const int pw12 = 12 * (first - pfirst);
    for (int it = threadIdx.x; it < ne * pw12; it += blockDim.x) {
      const int e = it / pw12, r = it - e * pw12;
      const int q = r / 12, c = r - 12 * q;
      const int p = tree.order[pfirst + q];
      const int s0 = tree.child_start[p], s1 = tree.child_start[p + 1];
      const int ep = e * J + p;
      if (c < 9) {    // gR_g[p] += gR_g[j] R_l[j]^T + gt_g[j] (x) t_l[j]
        const int i = c / 3, k = c - 3 * i;
        float acc = ar[ep * 9 + c];
        for (int s = s0; s < s1; ++s) {
          const int ec = e * J + tree.child[s];
          const float* gR = ar + ec * 9;
          const float* Rl = rl + ec * 9;
          acc = acc + fmaf(at[ec * 3 + i], tl[ec * 3 + k],
                           dot3(gR[3 * i], gR[3 * i + 1], gR[3 * i + 2],
                                Rl[3 * k], Rl[3 * k + 1], Rl[3 * k + 2]));
        }
        ar[ep * 9 + c] = acc;
      } else {        // gt_g[p] += gt_g[j]
        const int i = c - 9;
        float acc = at[ep * 3 + i];
        for (int s = s0; s < s1; ++s)
          acc = acc + at[(e * J + tree.child[s]) * 3 + i];
        at[ep * 3 + i] = acc;
      }
    }
    __syncthreads();
  }
  __syncthreads();  // the root's step ends at the break above
  block_copy(gR_l + (size_t)b0 * J * 9, grl, ne * J * 9);
  block_copy(gt_l + (size_t)b0 * J * 3, gtl, ne * J * 3);
}

// K1's grid with nothing to do: its device time is the launch floor.
__global__ void __launch_bounds__(kThreads) fk_empty_kernel() {}

int blocks(int B) { return (B + kTile - 1) / kTile; }

size_t smem_bytes(int J, bool backward) {
  return sizeof(float) * (size_t)smem_floats(J, backward);
}

}  // namespace

// R_l (B,J,3,3), t_l (B,J,3) f32 contiguous on the device (any float
// alignment); tree: the host's packed tree (ops/fk.py). Writes R_g, t_g.
extern "C" int nemo_fk_fwd(const float* R_l, const float* t_l,
                           const int* tree_packed, int B, int J, float* R_g,
                           float* t_g, cudaStream_t stream) {
  Tree tree;
  if (int err = make_tree(tree_packed, J, &tree)) return err;
  if (B <= 0) return (int)cudaErrorInvalidValue;
  fk_fwd_kernel<<<blocks(B), kThreads, smem_bytes(J, false), stream>>>(
      R_l, t_l, B, tree, R_g, t_g);
  return (int)cudaGetLastError();
}

// The same operands as nemo_fk_fwd, with R_g and the cotangents gR_g
// (B,J,3,3), gt_g (B,J,3); writes gR_l, gt_l. Needs no scratch.
extern "C" int nemo_fk_bwd(const float* R_l, const float* t_l, const float* R_g,
                           const float* gR_g, const float* gt_g,
                           const int* tree_packed, int B, int J, float* gR_l,
                           float* gt_l, cudaStream_t stream) {
  Tree tree;
  if (int err = make_tree(tree_packed, J, &tree)) return err;
  if (B <= 0) return (int)cudaErrorInvalidValue;
  fk_bwd_kernel<<<blocks(B), kThreads, smem_bytes(J, true), stream>>>(
      R_l, t_l, R_g, gR_g, gt_g, B, tree, gR_l, gt_l);
  return (int)cudaGetLastError();
}

// An empty kernel on K1's grid at (B, J): the launch floor beside K1's
// device time (scripts/torch_fk_times.py).
extern "C" int nemo_fk_empty(int B, int J, int backward, cudaStream_t stream) {
  if (B <= 0 || J < 1 || J > kMaxJoints) return (int)cudaErrorInvalidValue;
  fk_empty_kernel<<<blocks(B), kThreads, smem_bytes(J, backward != 0),
                    stream>>>();
  return (int)cudaGetLastError();
}

// The forward (backward = 0) or backward kernel's resources, as the CUDA
// runtime reports them: out[0..3] = registers a thread, static shared
// memory bytes, dynamic shared memory bytes at J joints, local bytes.
extern "C" int nemo_fk_attributes(int backward, int J, int* out) {
  if (J < 1 || J > kMaxJoints) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t err = backward ? cudaFuncGetAttributes(&a, fk_bwd_kernel)
                             : cudaFuncGetAttributes(&a, fk_fwd_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)smem_bytes(J, backward != 0);
  out[3] = (int)a.localSizeBytes;
  return 0;
}
