// Tile rasterizer, kernels K5s and K5g: the Hopper port of
// nemo_tpu/ops/raster_pallas.py (_raster_stream_kernel, the stream mode,
// and _raster_kernel, the gather mode).
//
// The TPU kernels fold each (th, tw) pixel tile's entries one after another
// on a sequential grid. A posed body covers a few dozen of a 1000 x 1900
// panel's 480 tiles, so one block a tile left most of the card idle while a
// few SMs folded the busiest tiles. Here the work is spread over the whole
// card, in four launches on the caller's stream, with no host
// synchronisation:
//
// 1. list (one block): from the tile counts, the busy tiles (count > 0) in
//    tile order, each tile's slot among them, a cumulative sum of
//    ceil(count / kChunk) and each item's tile: work item i is chunk
//    i - item_start[b] of busy tile b = item_busy[i]. The totals stay in
//    device memory.
// 2. clear (a grid over the busy tiles' pixels): the busy tiles' 64-bit
//    merge keys to 0. Keys are kept only for busy tiles.
// 3. fold (a persistent grid sized from the SM count): each block takes
//    the next work item from a counter in device memory, stages its up to
//    kChunk entries in shared memory, and each warp folds them into one
//    8 x 32 sub-tile at a time, skipping the entries that repeat an
//    earlier entry of their face in the tile (marked in their code) and
//    those the exact cull rules out, then merges each pixel it won with
//    one atomicMax (raster_common.cuh has the key, the code and the
//    cull).
// 4. finalise (a grid over every pixel of every panel, four pixels a
//    thread where the widths allow 16-byte stores): decode each key,
//    recompute the winner's q0, q1, q2 from its attributes, write z, fid
//    and bary, with inf, -1 and 0 where no entry covered the pixel (and
//    everywhere in a tile that holds no entry).
//
// The merge takes a maximum, which does not depend on the order the items
// arrive in: outputs equal the sequential fold's bit for bit on every run.
//
// The two kernels differ only in where a tile's entries come from:
// - K5s (stream): the entries of tile t of panel n are rows
//   [starts[n*T+t], starts[n*T+t] + counts[n*T+t]) of the flat sorted entry
//   arrays attr (E, 9) and fid (E,). There is no capacity cap.
// - K5g (gather): entry k < counts[n*T+t] of the tile is face
//   tbl[(n*T+t)*K + k] of panel n, whose attributes are row n*F + face of
//   attr_face (N*F, 9). The counts are capped at K by the caller, so
//   entries past K are dropped exactly as the TPU kernel drops them.
//
// What bounds it on the H100: f32 operations of the fold, about 30 per
// (entry, pixel) tested, where the dense fold tests every entry of a tile
// at all of its pixels and the cull skips the sub-tiles an entry provably
// misses; then the output writes (20 bytes a pixel). The fold is written
// without contraction, so each operation issues alone.

#include "raster_common.cuh"

namespace {

constexpr int kListThreads = 1024;
constexpr int kPixThreads = 256;

// Where the entries of one busy tile come from: entry pos of the tile as
// its attributes and its code (raster_common.cuh: the face id within the
// panel, or ~face for a repeated entry).
struct StreamSource {
  const float* attr;
  const int* codes;
  const int* starts;
  __device__ const float* attrs(int tile, int pos, int& code) const {
    const size_t e = (size_t)starts[tile] + pos;
    code = codes[e];
    return attr + e * kAttr;
  }
};

struct GatherSource {
  const float* attr_face;
  const int* tbl;
  int T, F, K;
  __device__ const float* attrs(int tile, int pos, int& code) const {
    code = tbl[(size_t)tile * K + pos];
    return attr_face + ((size_t)(tile / T) * F + code_face(code)) * kAttr;
  }
};

// The shapes every launch of a call shares.
struct Grid {
  int N, T, H, W, th, tw, ntx;
};

// meta: [0] busy tiles, [1] work items, [2] the next item to take.
__global__ void __launch_bounds__(kListThreads)
raster_list_kernel(int NT, const int* __restrict__ counts,
                   int* __restrict__ meta, int* __restrict__ busy_of_tile,
                   int* __restrict__ busy_tile, int* __restrict__ item_start,
                   int* __restrict__ item_busy) {
  __shared__ int warp_busy[kListThreads / 32], warp_items[kListThreads / 32];
  __shared__ int carry_busy, carry_items;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    carry_busy = 0;
    carry_items = 0;
  }
  for (int base = 0; base < NT; base += kListThreads) {
    const int t = base + threadIdx.x;
    const int c = t < NT ? counts[t] : 0;
    const int busy = c > 0 ? 1 : 0;
    const int items = (c + kChunk - 1) / kChunk;
    int sb = busy, si = items;  // inclusive scans within the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int ob = __shfl_up_sync(0xFFFFFFFFu, sb, d);
      const int oi = __shfl_up_sync(0xFFFFFFFFu, si, d);
      if (lane >= d) {
        sb += ob;
        si += oi;
      }
    }
    if (lane == 31) {
      warp_busy[warp] = sb;
      warp_items[warp] = si;
    }
    __syncthreads();
    if (warp == 0) {
      int wb = warp_busy[lane], wi = warp_items[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int ob = __shfl_up_sync(0xFFFFFFFFu, wb, d);
        const int oi = __shfl_up_sync(0xFFFFFFFFu, wi, d);
        if (lane >= d) {
          wb += ob;
          wi += oi;
        }
      }
      warp_busy[lane] = wb;  // inclusive over warps
      warp_items[lane] = wi;
    }
    __syncthreads();
    const int before_b = carry_busy + (warp ? warp_busy[warp - 1] : 0) +
                         sb - busy;
    const int before_i = carry_items + (warp ? warp_items[warp - 1] : 0) +
                         si - items;
    if (t < NT) {
      busy_of_tile[t] = busy ? before_b : -1;
      if (busy) {
        busy_tile[before_b] = t;
        item_start[before_b] = before_i;
        for (int k = 0; k < items; ++k) item_busy[before_i + k] = before_b;
      }
    }
    __syncthreads();  // every thread has read the carries
    if (threadIdx.x == 0) {
      carry_busy += warp_busy[kListThreads / 32 - 1];
      carry_items += warp_items[kListThreads / 32 - 1];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    meta[0] = carry_busy;
    meta[1] = carry_items;
    meta[2] = 0;
  }
}

__global__ void raster_clear_kernel(const int* __restrict__ meta, int npix,
                                    unsigned long long* __restrict__ keys) {
  const size_t n = (size_t)meta[0] * npix;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    keys[i] = 0ull;
}

template <class Source>
__global__ void __launch_bounds__(kThreads, 2)
raster_fold_kernel(Source src, Grid g, const int* __restrict__ counts,
                   int* __restrict__ meta, const int* __restrict__ busy_tile,
                   const int* __restrict__ item_start,
                   const int* __restrict__ item_busy,
                   unsigned long long* __restrict__ keys) {
  __shared__ Staged st;
  __shared__ int s_item, s_busy;
  const int n_items = meta[1];
  const int th = g.th, tw = g.tw, ntx = g.ntx;
  const int sub_cols = (tw + kSubCols - 1) / kSubCols;
  const int n_sub = ((th + kSubRows - 1) / kSubRows) * sub_cols;
  const int warp = threadIdx.x >> 5;
  for (;;) {
    if (threadIdx.x == 0) {  // the next item, when the block is free
      const int item = atomicAdd(meta + 2, 1);
      s_item = item;
      s_busy = item < n_items ? item_busy[item] : 0;
    }
    __syncthreads();
    const int item = s_item, b = s_busy;
    if (item >= n_items) break;
    const int tile = busy_tile[b];
    const int first = (item - item_start[b]) * kChunk;
    const int m = min(kChunk, counts[tile] - first);
    for (int i = threadIdx.x; i < m; i += kThreads) {
      int code;
      const float* a = src.attrs(tile, first + i, code);
      Face f = load_face(a);
      f.live = f.live && !repeated(code);
      stage_face(st, i, f);
    }
    __syncthreads();
    const int t = tile % g.T;
    const int X0 = (t % ntx) * tw, Y0 = (t / ntx) * th;
    for (int s = warp; s < n_sub; s += kWarps)
      fold_subtile(st, m, first, th, tw, X0, Y0, (s / sub_cols) * kSubRows,
                   (s % sub_cols) * kSubCols, keys + (size_t)b * th * tw);
    __syncthreads();  // the chunk is folded and s_item read
  }
}

// kVec pixels of a row a thread (4 where W and tw are multiples of 4: one
// 16-byte store of z, of fid and three of bary; else 1).
template <class Source, int kVec>
__global__ void __launch_bounds__(kPixThreads)
raster_finalise_kernel(Source src, Grid g,
                       const int* __restrict__ busy_of_tile,
                       const unsigned long long* __restrict__ keys,
                       float* __restrict__ z, int* __restrict__ fid,
                       float* __restrict__ bary) {
  const int H = g.H, W = g.W, th = g.th, tw = g.tw;
  const int per_row = W / kVec, total = g.N * H * per_row;
  for (int i = blockIdx.x * kPixThreads + threadIdx.x; i < total;
       i += gridDim.x * kPixThreads) {
    const int r = i / per_row, x = (i - r * per_row) * kVec;
    const int n = r / H, y = r - n * H;
    const int ty = y / th, tx = x / tw;
    const int tile = n * g.T + ty * g.ntx + tx;
    const int b = busy_of_tile[tile];
    unsigned long long key[kVec];
    if (b < 0) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) key[j] = 0ull;
    } else {
      const unsigned long long* kp =
          keys + (size_t)b * th * tw + (y - ty * th) * tw + (x - tx * tw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) key[j] = kp[j];
    }
    float zo[kVec], bo[3 * kVec];
    int fo[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      int code = 0;
      const float* a =
          key[j] ? src.attrs(tile, key_position(key[j]), code) : nullptr;
      pixel_out(key[j], a, code_face(code), (float)(x + j), (float)y, zo[j],
                fo[j], bo + 3 * j);
    }
    const size_t o = (size_t)r * W + x;
    if constexpr (kVec == 4) {
      *reinterpret_cast<float4*>(z + o) =
          make_float4(zo[0], zo[1], zo[2], zo[3]);
      *reinterpret_cast<int4*>(fid + o) =
          make_int4(fo[0], fo[1], fo[2], fo[3]);
      float4* bp = reinterpret_cast<float4*>(bary + 3 * o);
      bp[0] = make_float4(bo[0], bo[1], bo[2], bo[3]);
      bp[1] = make_float4(bo[4], bo[5], bo[6], bo[7]);
      bp[2] = make_float4(bo[8], bo[9], bo[10], bo[11]);
    } else {
      z[o] = zo[0];
      fid[o] = fo[0];
      bary[3 * o] = bo[0];
      bary[3 * o + 1] = bo[1];
      bary[3 * o + 2] = bo[2];
    }
  }
}

struct Launch {
  int sms = 0;
  int fold_blocks_per_sm = 0;
};

// The card's SM count and the fold's resident blocks an SM, read once (host
// queries; no device synchronisation).
template <class Source>
int launch_config(Launch& cfg) {
  if (cfg.sms == 0) {
    int dev;
    if (cudaError_t e = cudaGetDevice(&dev)) return (int)e;
    if (cudaError_t e = cudaDeviceGetAttribute(
            &cfg.sms, cudaDevAttrMultiProcessorCount, dev))
      return (int)e;
    if (cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &cfg.fold_blocks_per_sm, raster_fold_kernel<Source>, kThreads,
            0))
      return (int)e;
    if (cfg.fold_blocks_per_sm < 1) cfg.fold_blocks_per_sm = 1;
  }
  return 0;
}

template <class Source>
int raster_launch(const Source& src, const Grid& g, const int* counts,
                  int* ints, unsigned long long* keys, float* z, int* fid,
                  float* bary, cudaStream_t stream) {
  static Launch cfg;
  if (int err = launch_config<Source>(cfg)) return err;
  const int NT = g.N * g.T;
  int* meta = ints;
  int* busy_of_tile = ints + 4;
  int* busy_tile = busy_of_tile + NT;
  int* item_start = busy_tile + NT;
  int* item_busy = item_start + NT;
  raster_list_kernel<<<1, kListThreads, 0, stream>>>(
      NT, counts, meta, busy_of_tile, busy_tile, item_start, item_busy);
  raster_clear_kernel<<<4 * cfg.sms, kPixThreads, 0, stream>>>(
      meta, g.th * g.tw, keys);
  raster_fold_kernel<Source>
      <<<cfg.fold_blocks_per_sm * cfg.sms, kThreads, 0, stream>>>(
          src, g, counts, meta, busy_tile, item_start, item_busy, keys);
  const int groups = g.N * g.H * g.W / 4;
  const int blocks = groups / kPixThreads + 1 < 16 * cfg.sms
                         ? groups / kPixThreads + 1
                         : 16 * cfg.sms;
  if (g.W % 4 == 0 && g.tw % 4 == 0)
    raster_finalise_kernel<Source, 4><<<blocks, kPixThreads, 0, stream>>>(
        src, g, busy_of_tile, keys, z, fid, bary);
  else
    raster_finalise_kernel<Source, 1><<<blocks, kPixThreads, 0, stream>>>(
        src, g, busy_of_tile, keys, z, fid, bary);
  return (int)cudaGetLastError();
}

// Shapes both kernels accept; cudaErrorInvalidValue otherwise.
int check_shapes(const Grid& g) {
  if (g.N <= 0 || g.T <= 0 || g.H <= 0 || g.W <= 0 || g.th <= 0 ||
      g.tw <= 0 || g.ntx <= 0 || g.th * g.tw > kMaxTilePixels ||
      g.T % g.ntx != 0 || (g.T / g.ntx) * g.th < g.H || g.ntx * g.tw < g.W ||
      (long long)g.N * g.H * g.W > 0x7FFFFFFFll)
    return (int)cudaErrorInvalidValue;
  return 0;
}

int attributes(const void* fn, int* out) {
  cudaFuncAttributes a;
  if (cudaError_t e = cudaFuncGetAttributes(&a, fn)) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = a.maxDynamicSharedSizeBytes;
  out[3] = (int)a.localSizeBytes;
  return 0;
}

}  // namespace

// ints: 4 + 3 N T int32 of workspace and, after them, room for every work
// item's busy-tile slot (at most N T + entries / kChunk); keys: N T th tw
// uint64 (only the busy tiles' part is cleared and used).
extern "C" int nemo_raster_stream(int N, int T, int H, int W, int th, int tw,
                                  int ntx, const float* attr,
                                  const int* codes,
                                  const int* starts, const int* counts,
                                  int* ints, void* keys, float* z, int* fid,
                                  float* bary, cudaStream_t stream) {
  const Grid g{N, T, H, W, th, tw, ntx};
  if (int err = check_shapes(g)) return err;
  return raster_launch(StreamSource{attr, codes, starts}, g, counts, ints,
                       (unsigned long long*)keys, z, fid, bary, stream);
}

extern "C" int nemo_raster_gather(int N, int T, int H, int W, int th, int tw,
                                  int ntx, int F, int K,
                                  const float* attr_face, const int* tbl,
                                  const int* counts, int* ints, void* keys,
                                  float* z, int* fid, float* bary,
                                  cudaStream_t stream) {
  const Grid g{N, T, H, W, th, tw, ntx};
  if (int err = check_shapes(g)) return err;
  if (F <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  return raster_launch(GatherSource{attr_face, tbl, T, F, K}, g, counts,
                       ints, (unsigned long long*)keys, z, fid, bary, stream);
}

// which: 0 the stream fold, 1 the gather fold, 2 the stream finalise, 3
// the gather finalise, 4 the list kernel. out int[4]: registers a thread,
// static and dynamic shared memory bytes, local (spill) bytes.
extern "C" int nemo_raster_attributes(int which, int* out) {
  switch (which) {
    case 0:
      return attributes((const void*)raster_fold_kernel<StreamSource>, out);
    case 1:
      return attributes((const void*)raster_fold_kernel<GatherSource>, out);
    case 2:
      return attributes(
          (const void*)raster_finalise_kernel<StreamSource, 4>, out);
    case 3:
      return attributes(
          (const void*)raster_finalise_kernel<GatherSource, 4>, out);
    case 4:
      return attributes((const void*)raster_list_kernel, out);
  }
  return (int)cudaErrorInvalidValue;
}
