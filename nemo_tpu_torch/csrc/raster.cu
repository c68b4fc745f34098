// Tile rasterizer, kernels K5s and K5g: the Hopper port of
// nemo_tpu/ops/raster_pallas.py (_raster_stream_kernel, the stream mode,
// and _raster_kernel, the gather mode).
//
// One block per (th, tw) pixel tile of one panel, grid (T, N): a batch of N
// panels (the views of a frame, each with its own intrinsics and entries)
// is one launch. The two kernels differ only in where a tile's entries come
// from; the fold, the finalisation and the edge masking are
// raster_common.cuh's.
//
// - K5s (stream): the entries of tile t of panel n are rows
//   [starts[n*T+t], starts[n*T+t] + counts[n*T+t]) of the flat sorted entry
//   arrays attr (E, 9) and fid (E,). There is no capacity cap. The TPU
//   kernel DMAs 128-lane-padded rows in 8-face groups for Mosaic and the
//   VPU; here each chunk of kChunk entries is staged in shared memory by
//   one thread an entry and folded by every thread.
// - K5g (gather): entry k < counts[n*T+t] of the tile is face
//   tbl[(n*T+t)*K + k] of panel n, whose attributes are row n*F + face of
//   attr_face (N*F, 9). The counts are capped at K by the caller, so
//   entries past K are dropped exactly as the TPU kernel drops them. The
//   TPU version gathers the (T, K, 16) attributes in XLA before the
//   kernel; reading them through the index inside the kernel gives the same
//   entries without that table.
//
// Outputs z (N, H, W) (inf where empty), fid (N, H, W) int32 (-1 where
// empty) and bary (N, H, W, 3), written directly with the ragged right and
// bottom tiles masked.

#include "raster_common.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
raster_stream_kernel(int T, int H, int W, int th, int tw, int ntx,
                     const float* __restrict__ attr,
                     const int* __restrict__ efid,
                     const int* __restrict__ starts,
                     const int* __restrict__ counts, float* __restrict__ z,
                     int* __restrict__ fid, float* __restrict__ bary) {
  __shared__ Staged st;
  const int t = blockIdx.x, n = blockIdx.y;
  TileState ts;
  init_tile(ts, th, tw, t / ntx, t % ntx);
  const int start = starts[n * T + t], count = counts[n * T + t];
  for (int c = 0; c < count; c += kChunk) {
    const int m = min(kChunk, count - c);
    __syncthreads();  // the previous chunk is folded
    for (int i = threadIdx.x; i < m; i += kThreads) {
      const size_t e = (size_t)start + c + i;
      stage_entry(st, i, attr + e * kAttr, efid[e]);
    }
    __syncthreads();
    fold_staged(ts, st, m);
  }
  write_tile(ts, n, th * tw, H, W, z, fid, bary);
}

__global__ void __launch_bounds__(kThreads)
raster_gather_kernel(int T, int H, int W, int th, int tw, int ntx, int F,
                     int K, const float* __restrict__ attr_face,
                     const int* __restrict__ tbl,
                     const int* __restrict__ counts, float* __restrict__ z,
                     int* __restrict__ fid, float* __restrict__ bary) {
  __shared__ Staged st;
  const int t = blockIdx.x, n = blockIdx.y;
  TileState ts;
  init_tile(ts, th, tw, t / ntx, t % ntx);
  const int* row = tbl + ((size_t)n * T + t) * K;
  const int count = counts[n * T + t];
  for (int c = 0; c < count; c += kChunk) {
    const int m = min(kChunk, count - c);
    __syncthreads();
    for (int i = threadIdx.x; i < m; i += kThreads) {
      const int face = row[c + i];
      stage_entry(st, i, attr_face + ((size_t)n * F + face) * kAttr, face);
    }
    __syncthreads();
    fold_staged(ts, st, m);
  }
  write_tile(ts, n, th * tw, H, W, z, fid, bary);
}

}  // namespace

extern "C" int nemo_raster_stream(int N, int T, int H, int W, int th, int tw,
                                  int ntx, const float* attr, const int* efid,
                                  const int* starts, const int* counts,
                                  float* z, int* fid, float* bary,
                                  cudaStream_t stream) {
  if (int err = check_shapes(N, T, H, W, th, tw, ntx)) return err;
  raster_stream_kernel<<<dim3(T, N), kThreads, 0, stream>>>(
      T, H, W, th, tw, ntx, attr, efid, starts, counts, z, fid, bary);
  return (int)cudaGetLastError();
}

extern "C" int nemo_raster_gather(int N, int T, int H, int W, int th, int tw,
                                  int ntx, int F, int K,
                                  const float* attr_face, const int* tbl,
                                  const int* counts, float* z, int* fid,
                                  float* bary, cudaStream_t stream) {
  if (int err = check_shapes(N, T, H, W, th, tw, ntx)) return err;
  if (F <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  raster_gather_kernel<<<dim3(T, N), kThreads, 0, stream>>>(
      T, H, W, th, tw, ntx, F, K, attr_face, tbl, counts, z, fid, bary);
  return (int)cudaGetLastError();
}
