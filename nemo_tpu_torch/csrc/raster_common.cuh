// The face math, the exact sub-tile cull and the per-pixel merge key
// shared by the two rasterizer kernels
// (csrc/raster.cu): K5s reads a tile's entries from the flat sorted entry
// array, K5g from the (T, K) per-tile table; everything else is here.
//
// For each pixel (X, Y) of a tile and each entry of the tile, in the
// tile's sorted order, the fold evaluates
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
// The sequential fold keeps, for each pixel, the first entry (in the
// tile's order) whose iz is the largest, among entries with iz > 0 (NaN
// never wins). That is the largest of the 64-bit keys
//
//   (bits(iz) << 32) | (0xFFFFFFFF - position of the entry in its tile)
//
// over the entries with iz > 0: for positive floats (+inf included) the
// bit pattern orders as the value does, and of two equal depths the
// smaller position gives the larger key. A maximum does not depend on the
// order its operands arrive in, so the tile's entries can be folded in
// chunks by any blocks in any order and merged with atomicMax: the result
// is the sequential fold's, bit for bit, on every run. The finalise pass
// decodes each pixel's winner and recomputes its q0, q1, q2 from the
// winning entry with the same operations (so the same bits).
//
// The cull. A warp owns a sub-tile of kSubRows x kSubCols pixels and skips
// an entry when one of its edge functions is provably negative (times s)
// at every pixel of the sub-tile, as the f32 evaluation computes it. The
// exact edge function s w(X, Y) is affine, so its largest value over the
// sub-tile's rectangle lies at a corner, picked by the signs of its two
// coefficients; it is evaluated there in double from the staged f32
// coefficients. The f32 evaluation of w at any pixel (three roundings of
// the products and differences) differs from the exact value by at most
// about 3u (|ex| |Y - py| + |ey| |X - px|), u = 2^-24, and the double
// evaluation by far less; the entry is skipped only when s w at that
// corner lies below -(2^-21 mag + 1e-30), mag the largest such magnitude
// over the rectangle (2^-21 = 8u covers both, 1e-30 underflow). So a
// skipped entry covers no pixel of the sub-tile in the f32 fold either,
// and skipping it changes nothing. Coefficients of 1e30 and over (where
// the f32 products could overflow), NaNs and infinities are never culled.
// A bounding-box test would not be exact: the f32 fold covers pixels
// outside a sliver's box through rounding, and keeps them.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;            // threads a fold block: 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kSubRows = 8;              // a sub-tile: 8 rows (a thread's
constexpr int kSubCols = 32;             // pixels) x 32 columns (the lanes)
constexpr int kChunk = 64;               // entries a work item
constexpr int kAttr = 9;                 // x0 y0 x1 y1 x2 y2 1/z0 1/z1 1/z2
constexpr int kMaxTilePixels = 4096;     // the largest tile the ops accept
constexpr double kCullRel = 1.0 / (1 << 21);
constexpr double kCullAbs = 1e-30;
constexpr double kCullMax = 1e30;

// One entry's attributes in the form the fold reads.
struct Face {
  float x0, y0, x1, y1, x2, y2;
  float e0x, e0y, e1x, e1y, e2x, e2y;  // x2-x1, y2-y1, x0-x2, y0-y2, x1-x0,
                                       // y1-y0
  float iz0, iz1, iz2, s, inv_area;
  bool live;                           // |area| > 1e-8: cover can be true
};

__device__ __forceinline__ Face load_face(const float* __restrict__ a) {
  Face f;
  f.x0 = a[0]; f.y0 = a[1]; f.x1 = a[2]; f.y1 = a[3]; f.x2 = a[4];
  f.y2 = a[5];
  const float area =
      __fsub_rn(__fmul_rn(__fsub_rn(f.x1, f.x0), __fsub_rn(f.y2, f.y0)),
                __fmul_rn(__fsub_rn(f.y1, f.y0), __fsub_rn(f.x2, f.x0)));
  f.s = (area > 0.f) ? 1.f : ((area < 0.f) ? -1.f : 0.f);
  const float abs_area = fabsf(area);
  f.e0x = __fsub_rn(f.x2, f.x1); f.e0y = __fsub_rn(f.y2, f.y1);
  f.e1x = __fsub_rn(f.x0, f.x2); f.e1y = __fsub_rn(f.y0, f.y2);
  f.e2x = __fsub_rn(f.x1, f.x0); f.e2y = __fsub_rn(f.y1, f.y0);
  f.iz0 = a[6]; f.iz1 = a[7]; f.iz2 = a[8];
  f.inv_area = __fdiv_rn(f.s, fmaxf(abs_area, 1e-8f));
  f.live = abs_area > 1e-8f;
  return f;
}

// Entries staged in shared memory, one array a field.
struct Staged {
  float x0[kChunk], y0[kChunk], x1[kChunk], y1[kChunk], x2[kChunk],
      y2[kChunk];
  float e0x[kChunk], e0y[kChunk], e1x[kChunk], e1y[kChunk], e2x[kChunk],
      e2y[kChunk];
  float iz0[kChunk], iz1[kChunk], iz2[kChunk];
  float s[kChunk], inv_area[kChunk];
  int live[kChunk];
};

__device__ __forceinline__ void stage_face(Staged& st, int i, const Face& f) {
  st.x0[i] = f.x0; st.y0[i] = f.y0; st.x1[i] = f.x1; st.y1[i] = f.y1;
  st.x2[i] = f.x2; st.y2[i] = f.y2;
  st.e0x[i] = f.e0x; st.e0y[i] = f.e0y; st.e1x[i] = f.e1x;
  st.e1y[i] = f.e1y; st.e2x[i] = f.e2x; st.e2y[i] = f.e2y;
  st.iz0[i] = f.iz0; st.iz1[i] = f.iz1; st.iz2[i] = f.iz2;
  st.s[i] = f.s; st.inv_area[i] = f.inv_area;
  st.live[i] = f.live;
}

__device__ __forceinline__ Face staged_face(const Staged& st, int k) {
  Face f;
  f.x0 = st.x0[k]; f.y0 = st.y0[k]; f.x1 = st.x1[k]; f.y1 = st.y1[k];
  f.x2 = st.x2[k]; f.y2 = st.y2[k];
  f.e0x = st.e0x[k]; f.e0y = st.e0y[k]; f.e1x = st.e1x[k];
  f.e1y = st.e1y[k]; f.e2x = st.e2x[k]; f.e2y = st.e2y[k];
  f.iz0 = st.iz0[k]; f.iz1 = st.iz1[k]; f.iz2 = st.iz2[k];
  f.s = st.s[k]; f.inv_area = st.inv_area[k];
  f.live = st.live[k] != 0;
  return f;
}

// The column terms ey (X - px) of the three edge functions: the same for
// every pixel of a column, so a thread computes them once an entry.
struct Cols {
  float a0, a1, a2;
};

__device__ __forceinline__ Cols face_cols(const Face& f, float X) {
  return {__fmul_rn(f.e0y, __fsub_rn(X, f.x1)),
          __fmul_rn(f.e1y, __fsub_rn(X, f.x2)),
          __fmul_rn(f.e2y, __fsub_rn(X, f.x0))};
}

// iz of the face at row Y (0 where not covered) and its q0, q1, q2.
__device__ __forceinline__ float face_pixel(const Face& f, const Cols& c,
                                            float Y, float& q0, float& q1,
                                            float& q2) {
  const float w0 = __fsub_rn(__fmul_rn(f.e0x, __fsub_rn(Y, f.y1)), c.a0);
  const float w1 = __fsub_rn(__fmul_rn(f.e1x, __fsub_rn(Y, f.y2)), c.a1);
  const float w2 = __fsub_rn(__fmul_rn(f.e2x, __fsub_rn(Y, f.y0)), c.a2);
  const bool cover = (__fmul_rn(w0, f.s) >= 0.f) &&
                     (__fmul_rn(w1, f.s) >= 0.f) &&
                     (__fmul_rn(w2, f.s) >= 0.f);
  q0 = __fmul_rn(__fmul_rn(w0, f.inv_area), f.iz0);
  q1 = __fmul_rn(__fmul_rn(w1, f.inv_area), f.iz1);
  q2 = __fmul_rn(__fmul_rn(w2, f.inv_area), f.iz2);
  return cover ? __fadd_rn(__fadd_rn(q0, q1), q2) : 0.f;
}

// True when s (ex (Y - py) - ey (X - px)) < 0 at every pixel of
// [Xa, Xb] x [Ya, Yb] as the f32 fold evaluates it (the note above).
__device__ __forceinline__ bool edge_outside(float ex, float ey, float px,
                                             float py, float s, double Xa,
                                             double Xb, double Ya,
                                             double Yb) {
  const double a = (double)s * (double)ex, c = (double)s * (double)ey;
  const double Y = a > 0.0 ? Yb : Ya, X = c > 0.0 ? Xa : Xb;
  const double wmax = __dsub_rn(__dmul_rn(a, __dsub_rn(Y, (double)py)),
                                __dmul_rn(c, __dsub_rn(X, (double)px)));
  const double mag = __dadd_rn(
      __dmul_rn(fabs((double)ex), fmax(fabs(__dsub_rn(Ya, (double)py)),
                                       fabs(__dsub_rn(Yb, (double)py)))),
      __dmul_rn(fabs((double)ey), fmax(fabs(__dsub_rn(Xa, (double)px)),
                                       fabs(__dsub_rn(Xb, (double)px)))));
  return mag < kCullMax && wmax < -__dadd_rn(__dmul_rn(kCullRel, mag),
                                             kCullAbs);
}

__device__ __forceinline__ bool face_outside(const Face& f, double Xa,
                                             double Xb, double Ya,
                                             double Yb) {
  return edge_outside(f.e0x, f.e0y, f.x1, f.y1, f.s, Xa, Xb, Ya, Yb) ||
         edge_outside(f.e1x, f.e1y, f.x2, f.y2, f.s, Xa, Xb, Ya, Yb) ||
         edge_outside(f.e2x, f.e2y, f.x0, f.y0, f.s, Xa, Xb, Ya, Yb);
}

// An entry's code is its face id within the panel, or ~face (negative)
// where the entry repeats an earlier entry of its face in its tile. The
// span scatter puts a slot of a face whose box spans fewer tiles than the
// span into the tile of an earlier slot (ops/raster.py's bin_entries
// clamps it there and marks it), and the sort keeps the earlier slot
// first. Such an entry has the same iz and q at every pixel as the earlier
// one and a later position, so it never wins: the fold skips it.
__device__ __forceinline__ bool repeated(int code) { return code < 0; }

__device__ __forceinline__ int code_face(int code) {
  return code < 0 ? ~code : code;
}

__device__ __forceinline__ unsigned long long merge_key(float iz, int pos) {
  return ((unsigned long long)__float_as_uint(iz) << 32) |
         (unsigned long long)(0xFFFFFFFFu - (unsigned)pos);
}

__device__ __forceinline__ int key_position(unsigned long long key) {
  return (int)(0xFFFFFFFFu - (unsigned)(key & 0xFFFFFFFFull));
}

__device__ __forceinline__ float key_depth(unsigned long long key) {
  return __uint_as_float((unsigned)(key >> 32));
}

// One warp folds the m staged entries (positions first .. first + m - 1
// in their tile) into its sub-tile: rows r0 .. r0 + 7 and columns c0 ..
// c0 + 31 of a th x tw tile whose top-left pixel is (X0, Y0), then merges
// each pixel it won into the tile's keys. Lane l owns column c0 + l.
__device__ __forceinline__ void fold_subtile(
    const Staged& st, int m, int first, int th, int tw, int X0, int Y0,
    int r0, int c0, unsigned long long* __restrict__ keys) {
  const int lane = threadIdx.x & 31;
  const float X = (float)(X0 + c0 + lane);
  const double Xa = X0 + c0, Xb = X0 + c0 + kSubCols - 1;
  const double Ya = Y0 + r0, Yb = Y0 + r0 + kSubRows - 1;
  float izb[kSubRows];
  int pos[kSubRows];
#pragma unroll
  for (int i = 0; i < kSubRows; ++i) {
    izb[i] = 0.f;
    pos[i] = 0;
  }
  for (int base = 0; base < m; base += 32) {
    const int k = base + lane;
    bool maybe = false;
    if (k < m && st.live[k]) {
      maybe = !face_outside(staged_face(st, k), Xa, Xb, Ya, Yb);
    }
    unsigned todo = __ballot_sync(0xFFFFFFFFu, maybe);
    while (todo) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      const Face f = staged_face(st, base + j);
      const Cols c = face_cols(f, X);
#pragma unroll
      for (int i = 0; i < kSubRows; ++i) {
        float q0, q1, q2;
        const float iz = face_pixel(f, c, (float)(Y0 + r0 + i), q0, q1, q2);
        if (iz > izb[i]) {
          izb[i] = iz;
          pos[i] = first + base + j;
        }
      }
    }
  }
  if (c0 + lane >= tw) return;
#pragma unroll
  for (int i = 0; i < kSubRows; ++i) {
    if (r0 + i < th && izb[i] > 0.f)
      atomicMax(keys + (r0 + i) * tw + c0 + lane, merge_key(izb[i], pos[i]));
  }
}

// A pixel's outputs from its key (0: no entry covered it) and, where it
// has one, the winning entry's attributes a and face id.
__device__ __forceinline__ void pixel_out(unsigned long long key,
                                          const float* __restrict__ a,
                                          int face, float X, float Y,
                                          float& z, int& fid, float* bary) {
  if (key == 0ull) {
    z = __int_as_float(0x7f800000);  // inf where empty
    fid = -1;
    bary[0] = bary[1] = bary[2] = 0.f;
    return;
  }
  const Face f = load_face(a);
  float q0, q1, q2;
  face_pixel(f, face_cols(f, X), Y, q0, q1, q2);
  const float zw = __fdiv_rn(1.f, fmaxf(key_depth(key), 1e-37f));
  z = zw;
  fid = face;
  bary[0] = __fmul_rn(q0, zw);
  bary[1] = __fmul_rn(q1, zw);
  bary[2] = __fmul_rn(q2, zw);
}

}  // namespace
