// The per-tile fold shared by the two rasterizer kernels (csrc/raster.cu):
// K5s reads each tile's entries from the flat sorted entry array, K5g from
// the (T, K) per-tile face table; everything else is here.
//
// A block owns one (th, tw) pixel tile of one panel; each thread owns up to
// kPix pixels of it and keeps, per pixel, the running inverse depth izb,
// the winning face id and the winner's (q0, q1, q2). Entries are staged in
// shared memory kChunk at a time, in their sorted order, and every thread
// folds them in that order:
//
//   area  = (x1 - x0)(y2 - y0) - (y1 - y0)(x2 - x0),  s = sign(area)
//   w0    = (x2 - x1)(Y - y1) - (y2 - y1)(X - x1)   (w1, w2 by rotation)
//   cover = w0 s >= 0 & w1 s >= 0 & w2 s >= 0 & |area| > 1e-8
//   q_k   = w_k (s / max(|area|, 1e-8)) (1 / z_k),  iz = q0 + q1 + q2
//   win   = iz > izb  (strict: the first of equal depths keeps the pixel)
//
// then z = 1 / max(izb, 1e-37) where hit (inf where empty), bary = q z.
// That is nemo_tpu/ops/raster_pallas.py's face-group math and fold
// (_raster_kernel, _raster_stream_kernel) operation for operation. Every
// product, sum and quotient is written with the _rn intrinsics in the order
// the plain PyTorch version (ops/raster.py) evaluates it: nvcc would
// otherwise contract a*b - c*d into an FMA, and a contracted edge function
// flips coverage at triangle edges. So kernel and plain version agree bit
// for bit, on the card and given the same entries.
//
// What bounds it on the H100: f32 operations, about 30 per (entry, pixel)
// (15 for the edge functions, 6 for coverage, 8 for the barycentrics and
// the inverse depth, 1 for the depth test), on the tiles that hold entries.
// A person covers a few dozen of a 1000 x 1900 panel's 480 tiles, so those
// few blocks do all the work while most SMs idle; splitting busy tiles is
// left for later.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;  // threads a block
constexpr int kPix = 8;        // pixels a thread: tiles of up to 4096 pixels
constexpr int kChunk = 256;    // entries staged in shared memory at a time
constexpr int kAttr = 9;       // x0 y0 x1 y1 x2 y2 1/z0 1/z1 1/z2

struct Staged {
  float x0[kChunk], y0[kChunk], x1[kChunk], y1[kChunk], x2[kChunk],
      y2[kChunk];
  float e0x[kChunk], e0y[kChunk], e1x[kChunk], e1y[kChunk], e2x[kChunk],
      e2y[kChunk];  // x2-x1, y2-y1, x0-x2, y0-y2, x1-x0, y1-y0
  float iz0[kChunk], iz1[kChunk], iz2[kChunk];
  float s[kChunk], inv_area[kChunk];
  int fid[kChunk];  // face id; -1 marks a face with |area| <= 1e-8
};

// Stage one entry (its 9 attributes and face id) into slot i.
__device__ __forceinline__ void stage_entry(Staged& st, int i,
                                            const float* __restrict__ a,
                                            int fid) {
  const float x0 = a[0], y0 = a[1], x1 = a[2], y1 = a[3], x2 = a[4],
              y2 = a[5];
  const float area =
      __fsub_rn(__fmul_rn(__fsub_rn(x1, x0), __fsub_rn(y2, y0)),
                __fmul_rn(__fsub_rn(y1, y0), __fsub_rn(x2, x0)));
  const float s = (area > 0.f) ? 1.f : ((area < 0.f) ? -1.f : 0.f);
  const float abs_area = fabsf(area);
  st.x0[i] = x0; st.y0[i] = y0; st.x1[i] = x1; st.y1[i] = y1;
  st.x2[i] = x2; st.y2[i] = y2;
  st.e0x[i] = __fsub_rn(x2, x1); st.e0y[i] = __fsub_rn(y2, y1);
  st.e1x[i] = __fsub_rn(x0, x2); st.e1y[i] = __fsub_rn(y0, y2);
  st.e2x[i] = __fsub_rn(x1, x0); st.e2y[i] = __fsub_rn(y1, y0);
  st.iz0[i] = a[6]; st.iz1[i] = a[7]; st.iz2[i] = a[8];
  st.s[i] = s;
  st.inv_area[i] = __fdiv_rn(s, fmaxf(abs_area, 1e-8f));
  st.fid[i] = (abs_area > 1e-8f) ? fid : -1;
}

struct TileState {
  float X[kPix], Y[kPix];
  float izb[kPix], q0[kPix], q1[kPix], q2[kPix];
  int fi[kPix];
};

// Pixel p of the tile is threadIdx.x + kThreads * i, row-major in (th, tw).
__device__ __forceinline__ void init_tile(TileState& ts, int th, int tw,
                                          int ty, int tx) {
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int p = threadIdx.x + kThreads * i;
    ts.X[i] = (float)(tx * tw + p % tw);
    ts.Y[i] = (float)(ty * th + p / tw);
    ts.izb[i] = 0.f;
    ts.q0[i] = 0.f; ts.q1[i] = 0.f; ts.q2[i] = 0.f;
    ts.fi[i] = -1;
  }
}

// Fold the n staged entries, in order, into this thread's pixels.
__device__ __forceinline__ void fold_staged(TileState& ts, const Staged& st,
                                            int n) {
  for (int k = 0; k < n; ++k) {
    const int fid = st.fid[k];
    if (fid < 0) continue;  // cover is false everywhere for this face
    const float x0 = st.x0[k], y0 = st.y0[k], x1 = st.x1[k], y1 = st.y1[k],
                x2 = st.x2[k], y2 = st.y2[k];
    const float e0x = st.e0x[k], e0y = st.e0y[k], e1x = st.e1x[k],
                e1y = st.e1y[k], e2x = st.e2x[k], e2y = st.e2y[k];
    const float iz0 = st.iz0[k], iz1 = st.iz1[k], iz2 = st.iz2[k];
    const float s = st.s[k], ia = st.inv_area[k];
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      const float X = ts.X[i], Y = ts.Y[i];
      const float w0 = __fsub_rn(__fmul_rn(e0x, __fsub_rn(Y, y1)),
                                 __fmul_rn(e0y, __fsub_rn(X, x1)));
      const float w1 = __fsub_rn(__fmul_rn(e1x, __fsub_rn(Y, y2)),
                                 __fmul_rn(e1y, __fsub_rn(X, x2)));
      const float w2 = __fsub_rn(__fmul_rn(e2x, __fsub_rn(Y, y0)),
                                 __fmul_rn(e2y, __fsub_rn(X, x0)));
      const bool cover = (__fmul_rn(w0, s) >= 0.f) &&
                         (__fmul_rn(w1, s) >= 0.f) &&
                         (__fmul_rn(w2, s) >= 0.f);
      const float q0 = __fmul_rn(__fmul_rn(w0, ia), iz0);
      const float q1 = __fmul_rn(__fmul_rn(w1, ia), iz1);
      const float q2 = __fmul_rn(__fmul_rn(w2, ia), iz2);
      const float iz = cover ? __fadd_rn(__fadd_rn(q0, q1), q2) : 0.f;
      if (iz > ts.izb[i]) {
        ts.izb[i] = iz;
        ts.fi[i] = fid;
        ts.q0[i] = q0; ts.q1[i] = q1; ts.q2[i] = q2;
      }
    }
  }
}

// Finalise and write this thread's pixels of panel n, masking the slots
// past the tile's th * tw pixels and the ragged right and bottom edges of
// the image.
__device__ __forceinline__ void write_tile(const TileState& ts, int n,
                                           int npix, int H, int W,
                                           float* __restrict__ z,
                                           int* __restrict__ fid,
                                           float* __restrict__ bary) {
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int x = (int)ts.X[i], y = (int)ts.Y[i];
    if (threadIdx.x + kThreads * i >= npix || x >= W || y >= H) continue;
    const bool hit = ts.izb[i] > 0.f;
    const float zw = __fdiv_rn(1.f, fmaxf(ts.izb[i], 1e-37f));
    const float m = hit ? zw : 0.f;
    const size_t o = ((size_t)n * H + y) * W + x;
    z[o] = hit ? zw : __int_as_float(0x7f800000);  // inf where empty
    fid[o] = ts.fi[i];
    bary[3 * o + 0] = __fmul_rn(ts.q0[i], m);
    bary[3 * o + 1] = __fmul_rn(ts.q1[i], m);
    bary[3 * o + 2] = __fmul_rn(ts.q2[i], m);
  }
}

// Shapes both kernels accept; cudaErrorInvalidValue otherwise.
inline int check_shapes(int N, int T, int H, int W, int th, int tw, int ntx) {
  if (N <= 0 || N > 65535 || T <= 0 || H <= 0 || W <= 0 || th <= 0 ||
      tw <= 0 || ntx <= 0 || th * tw > kThreads * kPix || T % ntx != 0 ||
      (T / ntx) * th < H || ntx * tw < W)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace
