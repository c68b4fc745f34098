// The VPoser v2v-L1 prior (K2): the Hopper port of nemo_tpu/ops/lbs_pallas.py
// _v2v_fwdbwd_kernel / _v2v_fwdbwd_pallas (:625 / :709, the fused mode) and
// _v2v_fwd_kernel / _v2v_fwd_kernel_vp / _v2v_fwd_pallas (:505 / :553 /
// :560, its pallas_call at :594; the total-only and pair modes).
//
// For every (batch row b, vertex v), both pose sets are skinned,
//   vph[k]  = sum_p pf[b,p] posedirs_t[p,k,v] + v_shaped_t[k,v],  vph[3] = 1
//   M[l]    = sum_j A[b,j,l] W_t[j,v]                     (l = i*4 + k)
//   vert[i] = M[4i+3] + sum_k M[4i+k] vph[k]
// and total = sum |vert_rec - vert_orig|. With g = sign(rec - orig)
// (sign(0) = 0) the orig-side gradients are
//   gvp[b,k,v]    = sum_i M_o[4i+k] g_i
//   gpf[b,p]      = sum_v sum_k gvp[b,k,v] posedirs_t[p,k,v]
//   gA[b,j,4i+k]  = sum_v g_i vph_o[k] W_t[j,v]
//   gvsh[k,v]     = sum_b gvp[b,k,v]
// The modes: 0 total only (the undifferentiated call); 1 fused: the total
// and (gpf, gA, gvsh); 2 pair: writes sign (B,3,V) and, if asked, the
// orig-side posed vertices vp (B,3,V), and stops; the backward runs K3b
// (csrc/skin.cu) on them.
//
// What bounds it on the H100, at B=512, V=6890: 19.5 GFLOP in all, 13.1 of
// them in the two posedirs contractions (the forward vph of both sides and
// the backward gpf), 6.3 in the SIMT work (the blend M of both sides, the
// vertices, gA); about 18 MB of device bytes, mostly the 17 MB posedirs
// table, which stays in the 50 MB L2. So it is bound by operations: at the
// f32 rate of the CUDA cores (67 TFLOP/s) 0.29 ms, and with the posedirs
// contractions on the TF32 tensor cores (495 TFLOP/s, three products each,
// below) by the SIMT part, 0.09 ms.
//
// Modes 0 and 1 with f32 tables: v2v_fused_kernel_ws, one pass, warp-
// specialised.
//   - What bounds it at the fit's full batch (B = 28200, the benchmark
//     cell): 1.075e12 FLOP a launch, 7.24e11 of them the three posedirs
//     contractions, which run in 3xTF32 (2.17e12 tensor FLOP: 4.4 ms at the
//     495 TFLOP/s of wgmma) and 3.5e11 on the CUDA cores (the blend of both
//     sides, the vertices, gvp and gA: 5.3 ms at 67 TFLOP/s); posedirs (17
//     MB) stays in L2 and the rest of the bytes are a few hundred MB. A
//     block that runs one phase at a time on all its warps (the bf16
//     kernel below) idles the tensor pipe during the CUDA-core work and the
//     reverse, and re-reads A from L2 in every tile: 45.7 ms. At B = 512
//     the same per row, on 128 blocks. What bounds this kernel (33.7 ms at
//     B = 28200, 0.70 ms at B = 512 on an H100 SXM at 700 W; PERF.md has
//     the phases):
//     each part's removal saves about its own share, so it is bound by
//     what all warps share on an SM sub-partition, issue slots and shared
//     memory, with three warps each to hide their latencies; per tile, the
//     tensor cores' 16-row products split each posedirs value twice (for
//     vph and for gpf), and the gradient half (gpf, gA) costs as much as
//     the forward half with half its products.
//   - Grid: batch tiles of kWR = 16 rows (32 side-rows: 16 orig, 16 rec)
//     x R vertex ranges (ws_ranges: of R = 1 .. clamp(4 SMs / batch tiles,
//     2, vertex tiles), the fewest tile times with each wave counted as its
//     longest range plus 2); a block walks the 16-vertex tiles of its range.
//   - On chip for the whole range: pf of the 32 side-rows split once into
//     its TF32 big and small parts, in the tensor cores' fragment order
//     (one 16-byte load a lane for each part of an A operand), and all 12
//     components of A of both sides, [side-row][component][joint], so the
//     blend reads A as float4 over 4 joints and makes no load to L2.
//   - Three warp groups of 4 warps, handing tiles over by mbarriers:
//       copies: each tile's posedirs slice (208 x 48; row 207 the zero pad,
//         set once; columns XOR-swizzled by row so both contractions'
//         fragment loads hit 32 banks) into a ring of 2 slots, from the
//         caller's copy of the table with rows ldv floats apart, zero past
//         V (made once at set-up: SMPLModel.posedirs_pad, from
//         ops/lbs.py:padded_posedirs), so each row of the slice is one
//         aligned 64-byte segment copied 16 bytes at a time past L1
//         (8-byte copies through L1 cost 5-6 ms); the W and v_shaped slices
//         into a ring of 4 slots, two tiles ahead. cp.async.mbarrier.arrive
//         signals a slot full, so the copy warps never wait on their copies;
//       tensor cores (mma.sync m16n8k8 TF32 in 3xTF32): vph (32 x 48) = pf
//         (32 x 208) . pd (208 x 48), each warp one half of the features
//         and 3 of the 6 n-tiles into its half's partial; then, once the
//         CUDA cores hand over the tile's gvp, gpf (16 x 208) += gvp (16 x
//         48) . pd^T, each warp 6 or 7 of the 26 feature n-tiles, the
//         tile's product in accumulators of its own added to registers held
//         across the range (the tensor cores truncate as they accumulate:
//         hundreds of tiles in one accumulator drifted past 1e-4); then the
//         slot is free. Each k-step issues its products in rounds of
//         independent ones; the slice and gvp operands are split as loaded
//         (split_tf32, both parts rounded to the nearest TF32, as in K3b);
//       CUDA cores: the blend M = A . W (a thread one side-row and 4
//         vertices; orig and rec lanes 16 apart), then the vertices from the
//         two vph halves (h0 + h1) + v_shaped, |rec - orig| (the sides meet
//         by shuffle), the sign and gvp, handed to the tensor cores double-
//         buffered; g and vo go to a double buffer of their own for gA (16
//         x 288, a thread one row, 6 components and 6 joints, in registers
//         across the range), and the tile's gvsh is its gvp summed over the
//         16 rows in order.
//     So the tensor cores run vph of tile i + 1 while the CUDA cores finish
//     gA of tile i and blend tile i + 1, and gpf of tile i beside gA of i.
//   - Partials, as before: gpf (16 x 207) and gA (16 x 288) a block and
//     range, gvsh a batch tile, the |diff| sum a block; range_reduce_kernel
//     and total_kernel (skin_common.cuh) sum them in index order, no
//     atomics: repeated runs are bit-identical. Mode 0 runs the same kernel
//     with the gradient work off and the same total_kernel, so its total
//     equals mode 1's bit for bit.
//   - Not wgmma: its TF32 operands must be K-major in shared memory (or A in
//     registers), and the two posedirs contractions read the slice along
//     different axes (vph along the features, gpf along the vertices), so
//     the slice would be needed twice, split, beside A and pf in 227 KB;
//     and its 64-row tiles would need 64 side-rows of A and pf on chip.
//   - Resources: 384 threads, 168 registers, 213,488 bytes of dynamic
//     shared memory, one block an SM, no spills (nvcc for sm_90a).
//   - Alignment: A is read as float4 and, where V is even, W and v_shaped
//     are copied 8 bytes at a time, so the caller passes A on 16-byte and
//     the tables on 8-byte boundaries (ops/lbs.py checks it).
// Modes 0 and 1 with bf16 tables: v2v_fused_kernel<bf16>, the one-phase
// design (the warp-specialised kernel's slots and fragments are f32's):
//   - Grid: batch tiles of kFB = 32 rows x R vertex ranges (fused_ranges,
//     shared with K3b); a block loops over the 16-vertex tiles of its
//     range, all 8 warps one phase at a time: the tile's slices copied by
//     cp.async (double-buffered), vph (64 x 48) on mma.sync, the blend, the
//     vertices, the sign and gvp on the CUDA cores, then gpf on mma.sync
//     and gA (skin_common.cuh's tile_grads, which K3b shares), with the
//     same partials and second pass.
// Mode 2, the pair mode: skin_fwd_kernel<2> (csrc/skin_fwd.cuh, shared with
// K3f), one pass over 16-row batch tiles (both sides: 32 rows of the MMA) x
// vertex ranges, storing the sign and, if asked, vp.
//   - Work: B*V*(2*1839 + 9) FLOP (13.0 GFLOP at B=512, V=6890): 0.194 ms
//     at the f32 rate. With both sides' posedirs contractions on the TF32
//     tensor cores in 3xTF32 (8.76 GFLOP of products, three each: 0.053 ms)
//     the rest bounds it on the CUDA cores, 4.24 GFLOP: 0.063 ms if the two
//     overlap. Bytes: the sign and vp (84.7 MB at B=512) and the inputs,
//     ~105 MB: 0.031 ms.
//   - So: vph of both sides on mma.sync in one warp group while the other
//     blends the previous tile on the CUDA cores, A and the pre-split pf of
//     both sides held in shared memory for the block's range; the orig and
//     rec vertices meet by shuffle; each block writes its |diff| sum and
//     total_kernel adds them in index order. 16-row tiles read posedirs
//     from L2 twice as often as 32-row tiles would, but 32 rows of both
//     sides do not fit in a block's shared memory with vph double-buffered.
// Ragged B and V are masked everywhere; the only padded table is the
// fused f32 kernel's posedirs copy.
//
// bf16 tables (_v2v_fwdbwd_kernel and _v2v_fwd_kernel with cdt = bf16; the
// C entry points with the _bf16 suffix; skin_common.cuh has the
// arithmetic). The fused kernel stages pf of both sides rounded to bf16, two
// features a word, and A of both sides rounded to bf16 once for its range
// (36 KB, in the half of the posedirs buffers the bf16 tiles leave free; the
// blend reads it from there), runs the forward vph (64 x 48 over 13 steps of
// 16) and the backward gpf (gvp rounded to bf16) on mma.sync m16n8k16 in one
// pass each, widens W for the blend and rounds g . [vp; 1] for gA. The tiles
// keep the f32 layout's strides in elements, in the first half of each
// buffer. The pair mode is skin_fwd_kernel<2, bf16> and stores vp in bf16.

#include "skin_fwd.cuh"

namespace {

// ---------------------------------------------------------------------------
// modes 0 and 1, f32 tables: the warp-specialised kernel
// ---------------------------------------------------------------------------

constexpr int kWR = 16;            // batch rows a block
constexpr int kWSR = 2 * kWR;      // side-rows: 0..15 orig, 16..31 rec
constexpr int kWG = 128;           // threads a warp group
constexpr int kWT = 3 * kWG;       // threads a block
constexpr int kWPd = kPP * kFN;    // floats of a posedirs slot [208][48]
constexpr int kWSV = 56;           // vph rows (the tensor cores' float2
                                   // stores on distinct banks)
constexpr int kWSW = 20;           // W rows (float4 rows for the blend; gA's
                                   // 4 joint groups on distinct banks)
constexpr int kWHalf = 104;        // the feature where the vph halves meet

// shared memory, in floats
constexpr int kWOffPd = 0;                            // [2][kPP][kFN]
constexpr int kWOffW = kWOffPd + 2 * kWPd;            // [4][kJ][kWSW]
constexpr int kWOffVs = kWOffW + 4 * kJ * kWSW;       // [4][3][kFV]
constexpr int kWPfFloats = 2 * (kPP / 8) * 32 * 4;   // pf_at's range
constexpr int kWOffPfb = kWOffVs + 4 * 3 * kFV;       // pf_at: TF32 big
constexpr int kWOffPfs = kWOffPfb + kWPfFloats;       // pf_at: TF32 small
constexpr int kWOffA = kWOffPfs + kWPfFloats;         // a_row(kWSR)
constexpr int kWOffVph = kWOffA + kWSR * kXSA + 16;   // [2 halves][kWSR][kWSV]
constexpr int kWOffGvp = kWOffVph + 2 * kWSR * kWSV;  // [2][kWR][kSX]
constexpr int kWOffG = kWOffGvp + 2 * kWR * kSX;      // [2][kWR][kSX]
constexpr int kWOffVo = kWOffG + 2 * kWR * kSX;       // [2][kWR][kSX]
constexpr int kWOffRed = kWOffVo + 2 * kWR * kSX;     // [4]
constexpr int kWOffBar = kWOffRed + 4;                // room for 20 mbarriers
constexpr int kWSmemFloats = kWOffBar + 2 * 20;
constexpr size_t kWSmemBytes = sizeof(float) * kWSmemFloats;
static_assert(kWOffW % 4 == 0 && kWOffVs % 4 == 0 && kWOffPfb % 4 == 0 &&
                  kWOffA % 4 == 0 && kWOffVph % 4 == 0 && kWOffGvp % 4 == 0 &&
                  kWOffG % 4 == 0 && kWOffVo % 4 == 0 && kWOffBar % 2 == 0,
              "float4 views need 16-byte offsets, mbarriers 8-byte ones");
static_assert(kWSmemBytes <= 232448, "a block may have 227 KB");
static_assert(kXR == kWSR, "a_row lays out 32 side-rows");

// the mbarriers: the posedirs slices' 2 slots full (the copies landed) and
// empty (the tensor cores are done with the slot); the same for the W and
// v_shaped slices' 4 slots (read by the CUDA cores alone); vph full and
// empty; gvp's 2 buffers full and empty
constexpr int kBPdFull = 0, kBPdEmpty = 2, kBWFull = 4, kBWEmpty = 8,
              kBVphFull = 12, kBVphEmpty = 13, kBGvpFull = 14,
              kBGvpEmpty = 16, kBCount = 18;
constexpr int kWBarCC = 1;  // named barrier of the CUDA-core group alone

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}
// one arrival for the whole warp, once every lane's earlier accesses to
// shared memory are done (__syncwarp orders them before lane 0's release)
__device__ __forceinline__ void mbar_arrive_warp(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}
// the arrival once every cp.async this thread issued before it has landed
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}
// wait for the completion of the phase of the given parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// pf of side-row sr, feature p, in the tensor cores' fragment order: the 4
// values a lane gives one m16n8k8 A operand (rows gid, gid + 8 of m-tile
// sr / 16, columns tig, tig + 4 of k-step p / 8) side by side, so a lane
// reads them by one 16-byte load
__device__ __forceinline__ int pf_at(int sr, int p) {
  const int r = sr & 15, c = p & 7;
  const int lane = (r & 7) * 4 + (c & 3), idx = (r >> 3) + 2 * (c >> 2);
  return (((sr >> 4) * (kPP / 8) + (p >> 3)) * 32 + lane) * 4 + idx;
}

// a posedirs slot's element (row p, column k * kFV + v): columns XOR-ed with
// bits 1 and 2 of p moved to bits 3 and 2, so vph's fragment loads (rows by
// lane % 4, columns by lane / 4) and gpf's (rows by lane / 4, columns by
// lane % 4) each hit 32 banks though a row is 48 floats
__device__ __forceinline__ int pd_at(int p, int col) {
  return p * kFN + (col ^ (((p & 2) << 2) | (p & 4)));
}

// The copy group's share of a tile's posedirs slice: the 621 (feature, k)
// rows of 16 floats of the padded table, rows ldv floats apart (a multiple
// of 4, zero from V up to a multiple of 16), so each is one aligned 64-byte
// segment, copied 16 bytes at a time
// past L1. Copy j of thread ct is chunk e = ct + 128 j: row ct / 4 + 32 j,
// column 4 (ct % 4). Row 207, the zero pad, is set once.
__device__ __forceinline__ void ws_copy_pd(float* s_pd, int t, int ldv,
                                           const float* __restrict__ pd,
                                           int ct) {
  const int x = 4 * (ct & 3);
  const float* src = pd + (size_t)t * kFV + (size_t)(ct >> 2) * ldv + x;
  const unsigned d0 = smem_addr(s_pd);
#pragma unroll 4
  for (int pk = ct >> 2; pk < kP * 3; pk += kWG / 4) {
    const int p = pk / 3, k = pk - 3 * p;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d0 + 4 * pd_at(p, k * kFV + x)), "l"(src));
    src += (size_t)(kWG / 4) * ldv;
  }
}

// A tensor-core warp's vph: out (kWSR x 24 from column 24 nh, rows of
// kWSV) = pf . pd over the kWHalf features from k_lo, both 16-row m-tiles
// and the 3 n-tiles from 3 nh, pf already split (s_pfb, s_pfs, pf_at's
// order: one 16-byte load for each part of an A operand), the slot's
// elements split as loaded (split_tf32). The cross terms and big . big go to
// separate accumulators, added at the end, and each k-step issues its 18 products in
// three rounds of 6 independent ones (small . big, big . big, big . small),
// so no product waits on the one before it.
__device__ __forceinline__ void ws_vph(const uint4* s_pfb, const uint4* s_pfs,
                                       const float* s_pd, float* out, int nh,
                                       int k_lo, int gid, int tig) {
  float lo[2][3][4], hi[2][3][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 3; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) { lo[m][n][i] = 0.f; hi[m][n][i] = 0.f; }
#pragma unroll
  for (int ks = 0; ks < kWHalf / 8; ++ks) {
    const int k0 = k_lo + 8 * ks;
    uint32_t ab[2][4], as[2][4], bb[3][2], bs[3][2];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int o = (m * (kPP / 8) + k0 / 8) * 32 + 4 * gid + tig;
      const uint4 b = s_pfb[o], sm = s_pfs[o];
      ab[m][0] = b.x; ab[m][1] = b.y; ab[m][2] = b.z; ab[m][3] = b.w;
      as[m][0] = sm.x; as[m][1] = sm.y; as[m][2] = sm.z; as[m][3] = sm.w;
    }
#pragma unroll
    for (int n = 0; n < 3; ++n) {
      const int col = 8 * (3 * nh + n) + gid;
      split_tf32(s_pd[pd_at(k0 + tig, col)], bb[n][0], bs[n][0]);
      split_tf32(s_pd[pd_at(k0 + tig + 4, col)], bb[n][1], bs[n][1]);
    }
#pragma unroll
    for (int n = 0; n < 3; ++n)
#pragma unroll
      for (int m = 0; m < 2; ++m) mma_tf32(lo[m][n], as[m], bb[n]);
#pragma unroll
    for (int n = 0; n < 3; ++n)
#pragma unroll
      for (int m = 0; m < 2; ++m) mma_tf32(hi[m][n], ab[m], bb[n]);
#pragma unroll
    for (int n = 0; n < 3; ++n)
#pragma unroll
      for (int m = 0; m < 2; ++m) mma_tf32(lo[m][n], ab[m], bs[n]);
  }
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 3; ++n) {
      float* o = out + (16 * m + gid) * kWSV + 8 * (3 * nh + n) + 2 * tig;
      *reinterpret_cast<float2*>(o) =
          make_float2(lo[m][n][0] + hi[m][n][0], lo[m][n][1] + hi[m][n][1]);
      *reinterpret_cast<float2*>(o + 8 * kWSV) =
          make_float2(lo[m][n][2] + hi[m][n][2], lo[m][n][3] + hi[m][n][3]);
    }
}

// A tensor-core warp's share of gpf (16 x 208) += gvp (16 x 48) . pd^T
// (48 x 208): the NT feature n-tiles w, w + 4, ..., gvp split as loaded, the
// products in rounds of NT independent ones as in ws_vph. The tile's
// product is formed in accumulators of its own and added to acc: the
// tensor cores truncate as they accumulate, which over a range of hundreds
// of tiles in one accumulator drifted past 1e-4 of gpf's largest entry.
template <int NT>
__device__ __forceinline__ void ws_gpf_n(float acc[7][4], const float* s_gvp,
                                         const float* s_pd, int w, int gid,
                                         int tig) {
  float lo[NT][4], hi[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) { lo[n][c] = 0.f; hi[n][c] = 0.f; }
#pragma unroll 2
  for (int k0 = 0; k0 < kFN; k0 += 8) {
    const float* pa = s_gvp + gid * kSX + k0 + tig;
    const float a[4] = {pa[0], pa[8 * kSX], pa[4], pa[8 * kSX + 4]};
    uint32_t ab[4], as[4], bb[NT][2], bs[NT][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(a[i], ab[i], as[i]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int p = 8 * (w + 4 * n) + gid;
      split_tf32(s_pd[pd_at(p, k0 + tig)], bb[n][0], bs[n][0]);
      split_tf32(s_pd[pd_at(p, k0 + tig + 4)], bb[n][1], bs[n][1]);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_tf32(lo[n], as, bb[n]);
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_tf32(hi[n], ab, bb[n]);
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_tf32(lo[n], ab, bs[n]);
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] += lo[n][c] + hi[n][c];
}
// warps 0 and 1 hold 7 of the 26 n-tiles, warps 2 and 3 hold 6
__device__ __forceinline__ void ws_gpf(float acc[7][4], const float* s_gvp,
                                       const float* s_pd, int w, int gid,
                                       int tig) {
  if (w < 2) ws_gpf_n<7>(acc, s_gvp, s_pd, w, gid, tig);
  else       ws_gpf_n<6>(acc, s_gvp, s_pd, w, gid, tig);
}

// gA of one row for the components 6 LH .. 6 LH + 5 and 6 joints from j0,
// over the tile's vertices two at a time: acc[q][jj] += G[l] . W[j], G[4i +
// k] = g_i vo_k (k < 3), g_i (k = 3).
template <int LH>
__device__ __forceinline__ void ws_ga_half(float acc[6][6], const float* s_g,
                                           const float* s_vo, const float* s_w,
                                           int row, int j0) {
#pragma unroll
  for (int v = 0; v < kFV; v += 2) {
    float2 g[3], vo[3], w[6];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      g[i] = *reinterpret_cast<const float2*>(s_g + row * kSX + i * kFV + v);
      vo[i] = *reinterpret_cast<const float2*>(s_vo + row * kSX + i * kFV + v);
    }
#pragma unroll
    for (int jj = 0; jj < 6; ++jj)
      w[jj] = *reinterpret_cast<const float2*>(s_w + (j0 + jj) * kWSW + v);
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      const int l = 6 * LH + q, i = l / 4, k = l % 4;
      const float2 G = k < 3 ? make_float2(g[i].x * vo[k % 3].x,
                                           g[i].y * vo[k % 3].y)
                             : g[i];
#pragma unroll
      for (int jj = 0; jj < 6; ++jj) {
        acc[q][jj] += G.x * w[jj].x;
        acc[q][jj] += G.y * w[jj].y;
      }
    }
  }
}
__device__ __forceinline__ void ws_ga(float acc[6][6], const float* s_g,
                                      const float* s_vo, const float* s_w,
                                      int row, int lh, int j0) {
  if (lh) ws_ga_half<1>(acc, s_g, s_vo, s_w, row, j0);
  else    ws_ga_half<0>(acc, s_g, s_vo, s_w, row, j0);
}

// tot_part[bt * R + r]: the block's |diff| sum; with grad, gpf_part
// [R][B][207], ga_part [R][B][288] and gvsh_part [n_bt][3][V]. Launched
// with kWT threads and kWSmemBytes of shared memory.
__global__ void __launch_bounds__(kWT, 1)
v2v_fused_kernel_ws(int B, int V, int R, const float* __restrict__ pf_o,
                    const float* __restrict__ A_o,
                    const float* __restrict__ pf_r,
                    const float* __restrict__ A_r,
                    const float* __restrict__ vsh,
                    const float* __restrict__ pd, int ldv,
                    const float* __restrict__ W, int grad,
                    float* __restrict__ tot_part,
                    float* __restrict__ gpf_part,
                    float* __restrict__ ga_part,
                    float* __restrict__ gvsh_part) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r = blockIdx.x, bt = blockIdx.y, b0 = bt * kWR;
  int t_begin, t_end;
  range_tiles(r, R, V, t_begin, t_end);
  const int n_t = t_end - t_begin;
  const int group = warp >> 2;  // 0 tensor cores, 1 CUDA cores, 2 copies

  uint32_t* s_pfb = reinterpret_cast<uint32_t*>(smem + kWOffPfb);
  uint32_t* s_pfs = reinterpret_cast<uint32_t*>(smem + kWOffPfs);
  const uint4* s_pfb4 = reinterpret_cast<const uint4*>(s_pfb);
  const uint4* s_pfs4 = reinterpret_cast<const uint4*>(s_pfs);
  float* s_A = smem + kWOffA;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + kWOffBar);
  const auto s_pd = [&](int s) { return smem + kWOffPd + s * kWPd; };
  const auto s_w = [&](int s) { return smem + kWOffW + s * kJ * kWSW; };
  const auto s_vs = [&](int s) { return smem + kWOffVs + s * 3 * kFV; };
  const auto s_vph = [&](int h) { return smem + kWOffVph + h * kWSR * kWSV; };
  const auto s_gvp = [&](int b) { return smem + kWOffGvp + b * kWR * kSX; };
  const auto s_g = [&](int b) { return smem + kWOffG + b * kWR * kSX; };
  const auto s_vo = [&](int b) { return smem + kWOffVo + b * kWR * kSX; };

  // the slots' zero pad row
  for (int e = tid; e < 2 * kFN; e += kWT)
    s_pd(e / kFN)[kP * kFN + e % kFN] = 0.f;
  if (tid == 0) {
    // full: each copy thread's copies; the rest: one arrival a warp of the
    // reading group
    for (int b = 0; b < kBCount; ++b)
      mbar_init(bar + b, b < kBPdEmpty || (b >= kBWFull && b < kBWEmpty)
                             ? kWG : 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // pf of the side-rows split into TF32 parts (feature 207 the zero row)
  for (int e = tid; e < kWSR * kPP; e += kWT) {
    const int sr = e / kPP, p = e % kPP, b = b0 + sr % kWR;
    const float* pf = sr < kWR ? pf_o : pf_r;
    const float x = (b < B && p < kP) ? pf[(size_t)b * kP + p] : 0.f;
    split_tf32(x, s_pfb[pf_at(sr, p)], s_pfs[pf_at(sr, p)]);
  }
  // A: s_A[a_row(sr) + l * kJ + j] = A[b, j, l]
  for (int e = tid; e < kWSR * kJ * 3; e += kWT) {
    const int sr = e / (3 * kJ), c4 = e % (3 * kJ), j = c4 / 3, q = c4 % 3;
    const int b = b0 + sr % kWR;
    const float* A = sr < kWR ? A_o : A_r;
    const float4 x = b < B ? __ldg(reinterpret_cast<const float4*>(
                                 A + (size_t)b * kGL) + c4)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    float* d = s_A + a_row(sr) + 4 * q * kJ + j;
    d[0] = x.x; d[kJ] = x.y; d[2 * kJ] = x.z; d[3 * kJ] = x.w;
  }
  __syncthreads();

  if (group == 2) {
    // the copy group: tile i's posedirs slice into slot i & 1 once the
    // tensor cores are done with tile i - 2; tile i's W and v_shaped slices
    // into slot i & 3, two tiles ahead, once the CUDA cores are done with
    // tile i - 4
    const int ct = tid - 2 * kWG;
    const auto copy_w = [&](int i) {
      const int s = i & 3;
      if (i >= 4) mbar_wait(bar + kBWEmpty + s, ((i >> 2) - 1) & 1);
      const int t = t_begin + i;
      if (V & 1) load_w_slice<1, kWSW>(s_w(s), s_vs(s), t, V, vsh, W, ct, kWG);
      else       load_w_slice<2, kWSW>(s_w(s), s_vs(s), t, V, vsh, W, ct, kWG);
      mbar_arrive_copies(bar + kBWFull + s);
    };
    for (int i = 0; i < 2 && i < n_t; ++i) copy_w(i);
    for (int i = 0; i < n_t; ++i) {
      const int s = i & 1;
      if (i >= 2) mbar_wait(bar + kBPdEmpty + s, ((i >> 1) - 1) & 1);
      ws_copy_pd(s_pd(s), t_begin + i, ldv, pd, ct);
      mbar_arrive_copies(bar + kBPdFull + s);
      if (i + 2 < n_t) copy_w(i + 2);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  if (group == 0) {
    // the tensor-core group: vph of tile i (warp: half kh of the features,
    // the 3 n-tiles nh), then its gpf once the CUDA cores have its gvp
    const int gid = lane >> 2, tig = lane & 3, kh = warp >> 1, nh = warp & 1;
    float gpf_acc[7][4];
#pragma unroll
    for (int n = 0; n < 7; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) gpf_acc[n][c] = 0.f;
    for (int i = 0; i < n_t; ++i) {
      const int s = i & 1;
      mbar_wait(bar + kBPdFull + s, (i >> 1) & 1);
      if (i >= 1) mbar_wait(bar + kBVphEmpty, (i - 1) & 1);
      ws_vph(s_pfb4, s_pfs4, s_pd(s), s_vph(kh), nh, kh * kWHalf, gid, tig);
      mbar_arrive_warp(bar + kBVphFull);
      if (grad) {
        mbar_wait(bar + kBGvpFull + s, (i >> 1) & 1);
        ws_gpf(gpf_acc, s_gvp(s), s_pd(s), warp, gid, tig);
        mbar_arrive_warp(bar + kBGvpEmpty + s);
      }
      mbar_arrive_warp(bar + kBPdEmpty + s);
    }
    // the block's gpf partial
    if (grad) {
      float* gpf_r = gpf_part + (size_t)r * B * kP;
#pragma unroll
      for (int n = 0; n < 7; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int b = b0 + gid + (c >> 1) * 8;
          const int p = 8 * (warp + 4 * n) + 2 * tig + (c & 1);
          if (b < B && p < kP) gpf_r[(size_t)b * kP + p] = gpf_acc[n][c];
        }
    }
    return;
  }

  // the CUDA-core group: a thread one side-row and 4 neighbouring vertices
  // (lanes 0-15 the orig side, 16-31 the rec side, the same rows)
  const int cw = warp - 4, gt = tid - kWG;
  const int side = lane >> 4, row = cw * 4 + ((lane & 15) >> 2);
  const int sr = side * kWR + row, vg = 4 * (lane & 3), b = b0 + row;
  const float* a = s_A + a_row(sr);
  // gA: a thread one row, 6 components (lh), 6 joints
  const int ga_row = gt >> 3, lh = (gt >> 2) & 1, ga_j0 = (gt & 3) * 6;
  float ga_acc[6][6];
#pragma unroll
  for (int q = 0; q < 6; ++q)
#pragma unroll
    for (int jj = 0; jj < 6; ++jj) ga_acc[q][jj] = 0.f;
  float local = 0.f;
  for (int i = 0; i < n_t; ++i) {
    const int s = i & 3, gb = i & 1, v0 = (t_begin + i) * kFV;
    mbar_wait(bar + kBWFull + s, (i >> 2) & 1);

    // M = A . W, 4 vertices, while the tensor cores compute vph
    float m[4][kL];
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int l = 0; l < kL; ++l) m[e][l] = 0.f;
    const float* w = s_w(s) + vg;
#pragma unroll 2
    for (int j0 = 0; j0 < kJ; j0 += 4) {
      float4 wj[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        wj[jj] = *reinterpret_cast<const float4*>(w + (j0 + jj) * kWSW);
#pragma unroll
      for (int l = 0; l < kL; ++l) {
        const float4 x = *reinterpret_cast<const float4*>(a + l * kJ + j0);
        m[0][l] += x.x * wj[0].x; m[1][l] += x.x * wj[0].y;
        m[2][l] += x.x * wj[0].z; m[3][l] += x.x * wj[0].w;
        m[0][l] += x.y * wj[1].x; m[1][l] += x.y * wj[1].y;
        m[2][l] += x.y * wj[1].z; m[3][l] += x.y * wj[1].w;
        m[0][l] += x.z * wj[2].x; m[1][l] += x.z * wj[2].y;
        m[2][l] += x.z * wj[2].z; m[3][l] += x.z * wj[2].w;
        m[0][l] += x.w * wj[3].x; m[1][l] += x.w * wj[3].y;
        m[2][l] += x.w * wj[3].z; m[3][l] += x.w * wj[3].w;
      }
    }

    // vp = the two vph halves + v_shaped
    mbar_wait(bar + kBVphFull, i & 1);
    float vp[3][4];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int o = sr * kWSV + k * kFV + vg;
      const float4 h0 = *reinterpret_cast<const float4*>(s_vph(0) + o);
      const float4 h1 = *reinterpret_cast<const float4*>(s_vph(1) + o);
      const float4 vs =
          *reinterpret_cast<const float4*>(s_vs(s) + k * kFV + vg);
      vp[k][0] = (h0.x + h1.x) + vs.x; vp[k][1] = (h0.y + h1.y) + vs.y;
      vp[k][2] = (h0.z + h1.z) + vs.z; vp[k][3] = (h0.w + h1.w) + vs.w;
    }
    mbar_arrive_warp(bar + kBVphEmpty);

    // the vertices, |rec - orig| and the sign (0 past B and V)
    const int nv = b < B ? V - (v0 + vg) : 0;
    float g[3][4];
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float vert = m[e][4 * c + 3];
#pragma unroll
        for (int k = 0; k < 3; ++k) vert += m[e][4 * c + k] * vp[k][e];
        const float other = __shfl_xor_sync(0xffffffffu, vert, 16);
        const float diff = side ? vert - other : other - vert;
        const bool valid = e < nv;
        if (side == 0 && valid) local += fabsf(diff);
        g[c][e] = valid ? (float)(diff > 0.f) - (float)(diff < 0.f) : 0.f;
      }

    if (grad) {
      // gvp to the tensor cores (once they have read tile i - 2's), g and
      // vo to gA
      if (i >= 2) mbar_wait(bar + kBGvpEmpty + gb, ((i >> 1) - 1) & 1);
      if (side == 0) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          float gv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            gv[e] = m[e][k] * g[0][e] + m[e][4 + k] * g[1][e] +
                    m[e][8 + k] * g[2][e];
          const int o = row * kSX + k * kFV + vg;
          *reinterpret_cast<float4*>(s_gvp(gb) + o) =
              make_float4(gv[0], gv[1], gv[2], gv[3]);
          *reinterpret_cast<float4*>(s_g(gb) + o) =
              make_float4(g[k][0], g[k][1], g[k][2], g[k][3]);
          *reinterpret_cast<float4*>(s_vo(gb) + o) =
              make_float4(vp[k][0], vp[k][1], vp[k][2], vp[k][3]);
        }
      }
      bar_sync(kWBarCC, kWG);
      mbar_arrive_warp(bar + kBGvpFull + gb);
      // the tile's gvsh: its gvp summed over the block's rows, in order
      if (gt < kFN) {
        const int k = gt / kFV, v = v0 + gt % kFV;
        float sum = 0.f;
        for (int rr = 0; rr < kWR; ++rr) sum += s_gvp(gb)[rr * kSX + gt];
        if (v < V) gvsh_part[((size_t)bt * 3 + k) * V + v] = sum;
      }
      ws_ga(ga_acc, s_g(gb), s_vo(gb), s_w(s), ga_row, lh, ga_j0);
    }
    mbar_arrive_warp(bar + kBWEmpty + s);
  }

  // the block's |diff| sum (the rec lanes hold 0), in a fixed order, and
  // its gA partial
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    local += __shfl_xor_sync(0xffffffffu, local, o);
  float* s_red = smem + kWOffRed;
  if (lane == 0) s_red[cw] = local;
  bar_sync(kWBarCC, kWG);
  if (gt == 0)
    tot_part[(size_t)bt * R + r] =
        ((s_red[0] + s_red[1]) + s_red[2]) + s_red[3];
  const int bg = b0 + ga_row;
  if (grad && bg < B) {
    float* ga_r = ga_part + ((size_t)r * B + bg) * kGL;
#pragma unroll
    for (int q = 0; q < 6; ++q)
#pragma unroll
      for (int jj = 0; jj < 6; ++jj)
        ga_r[(ga_j0 + jj) * kL + 6 * lh + q] = ga_acc[q][jj];
  }
}

// K2's vertex ranges R for B rows at one block an SM: of R = 1 ..
// clamp(4 SMs / batch tiles, 2, vertex tiles), the one that takes the fewest
// tile times, counting each wave of blocks as its longest range plus 2 tile
// times of set-up; the smallest such R.
inline int ws_ranges(int B, int V) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int n_bt = cdiv(B, kWR), n_tiles = cdiv(V, kFV);
  int cap = 4 * sms / n_bt;
  cap = cap < 2 ? 2 : cap;
  cap = cap > n_tiles ? n_tiles : cap;
  int best = 1;
  long long best_cost = LLONG_MAX;
  for (int R = 1; R <= cap; ++R) {
    const long long cost =
        (long long)cdiv(n_bt * R, sms) * (cdiv(n_tiles, R) + 2);
    if (cost < best_cost) { best_cost = cost; best = R; }
  }
  return best;
}

// ---------------------------------------------------------------------------
// modes 0 and 1, bf16 tables: the one-phase kernel
// ---------------------------------------------------------------------------

// shared memory, in floats (the tile constants are skin_common.cuh's)
constexpr int kOffPd = 0;                             // [2][kPP][kSD]
constexpr int kOffPf = kOffPd + 2 * kPP * kSD;        // [2 * kFB][kSF]
constexpr int kOffW = kOffPf + 2 * kFB * kSF;         // [2][kJ][kSW]
constexpr int kOffVs = kOffW + 2 * kJ * kSW;          // [2][3][kFV]
constexpr int kOffVph = kOffVs + 2 * 3 * kFV;         // [2 * kFB][kSX]
constexpr int kOffGvp = kOffVph + 2 * kFB * kSX;      // [kFB][kSX]
constexpr int kOffG = kOffGvp + kFB * kSX;            // [kFB][kSX]
constexpr int kOffRed = kOffG + kFB * kSX;            // [kFT]
constexpr int kSmemFloats = kOffRed + kFT;
constexpr size_t kSmemBytes = sizeof(float) * kSmemFloats;
// the two bf16 posedirs buffers fill the first half of theirs, and A of
// both sides, rounded to bf16 once, [2 * kFB][kGL], takes the rest
constexpr int kOffAb = kOffPd + kPP * kSD;
static_assert(2 * kFB * kGL * sizeof(bf16) <= sizeof(float) * kPP * kSD,
              "the rounded A does not fit beside the bf16 posedirs tiles");

template <typename T>
__global__ void __launch_bounds__(kFT, 1)
v2v_fused_kernel(int B, int V, int R, const float* __restrict__ pf_o,
                 const float* __restrict__ A_o, const float* __restrict__ pf_r,
                 const float* __restrict__ A_r, const float* __restrict__ vsh,
                 const T* __restrict__ pd, const T* __restrict__ W,
                 int grad, float* __restrict__ tot_part,
                 float* __restrict__ gpf_part, float* __restrict__ ga_part,
                 float* __restrict__ gvsh_part) {
  static_assert(kIsBf16<T>, "f32 tables run v2v_fused_kernel_ws");
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const GradRoles q(tid);
  const int r = blockIdx.x, bt = blockIdx.y, b0 = bt * kFB;
  int t_begin, t_end;
  range_tiles(r, R, V, t_begin, t_end);

  float* s_pf = smem + kOffPf;
  bf16* s_Ab = reinterpret_cast<bf16*>(smem + kOffAb);
  float* s_vph = smem + kOffVph;
  float* s_gvp = smem + kOffGvp;
  float* s_g = smem + kOffG;

  const auto pd_buf = [&](int buf) {
    return reinterpret_cast<T*>(smem + kOffPd) + buf * kPP * kSD;
  };
  const auto w_buf = [&](int buf) {
    return reinterpret_cast<T*>(smem + kOffW) + buf * kJ * kSW;
  };
  const auto load = [&](int buf, int t) {
    float* s_vs = smem + kOffVs + buf * 3 * kFV;
    if (V & 1) load_tile<1>(pd_buf(buf), w_buf(buf), s_vs, t, V, vsh, pd, W);
    else       load_tile<2>(pd_buf(buf), w_buf(buf), s_vs, t, V, vsh, pd, W);
  };
  load(0, t_begin);
  cp_async_commit();
  // pf of both sides for the whole range, rows 0..31 orig, 32..63 rec,
  // rounded to bf16, two features a word; A of both sides too, rounded once
  // here instead of on every vertex tile
  stage_pf_bf16(reinterpret_cast<uint32_t*>(s_pf), 2 * kFB, B,
                [&](int row) { return row < kFB ? pf_o : pf_r; },
                [&](int row) { return b0 + row % kFB; }, tid, kFT);
  for (int e = tid; e < 2 * kFB * (kGL / 4); e += kFT) {
    const int row = e / (kGL / 4), c4 = e % (kGL / 4), b = b0 + row % kFB;
    const float4 x = b < B ? __ldg(reinterpret_cast<const float4*>(
        (row < kFB ? A_o : A_r) + (size_t)b * kGL) + c4)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    reinterpret_cast<uint2*>(s_Ab + row * kGL)[c4] =
        make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
  }

  // forward MMA: warp -> m-tile (16 of the 64 rows), 3 of the 6 n-tiles
  const int fm = warp & 3, fn0 = (warp >> 2) * 3;
  // gpf (backward MMA) and gA accumulate across the range: GradRoles
  float gpf_acc[7][4];
#pragma unroll
  for (int t = 0; t < 7; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) gpf_acc[t][i] = 0.f;
  float ga_acc[6][6];
#pragma unroll
  for (int l = 0; l < 6; ++l)
#pragma unroll
    for (int jj = 0; jj < 6; ++jj) ga_acc[l][jj] = 0.f;
  // blend: a thread one row, two neighbouring vertices
  const int sb = tid >> 3, sv = (tid & 7) * 2, b_s = b0 + sb;
  float local = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1, v0 = t * kFV;
    if (t + 1 < t_end) {
      load(buf ^ 1, t + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* s_pd = pd_buf(buf);
    const T* s_w = w_buf(buf);
    const float* s_vs = smem + kOffVs + buf * 3 * kFV;

    // 1. vph (64 x 48) = pf (64 x 208) . pd (208 x 48) on the tensor cores
    vph_mma_bf16<1>(reinterpret_cast<const uint32_t*>(s_pf), s_pd, s_vph, fm,
                    fn0, 0, kPP, q.gid, q.tig);
    __syncthreads();

    // 2. the blend, the vertices, |rec - orig|, the sign and gvp (SIMT)
    {
      float mo[2][kL], mr[2][kL];
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int l = 0; l < kL; ++l) { mo[e][l] = 0.f; mr[e][l] = 0.f; }
      if (b_s < B) {
#pragma unroll 4
        for (int j = 0; j < kJ; ++j) {
          const float2 w = ld2(s_w + j * kSW + sv);
          float a_o[kL], a_r[kL];
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float4 x = ld4(s_Ab + sb * kGL + kL * j + 4 * c);
            const float4 y = ld4(s_Ab + (kFB + sb) * kGL + kL * j + 4 * c);
            a_o[4 * c] = x.x; a_o[4 * c + 1] = x.y; a_o[4 * c + 2] = x.z; a_o[4 * c + 3] = x.w;
            a_r[4 * c] = y.x; a_r[4 * c + 1] = y.y; a_r[4 * c + 2] = y.z; a_r[4 * c + 3] = y.w;
          }
#pragma unroll
          for (int l = 0; l < kL; ++l) {
            mo[0][l] += a_o[l] * w.x; mo[1][l] += a_o[l] * w.y;
            mr[0][l] += a_r[l] * w.x; mr[1][l] += a_r[l] * w.y;
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int v = sv + e;
        const bool valid = b_s < B && v0 + v < V;
        float vo[3], vr[3], g[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float vs = s_vs[k * kFV + v];
          vo[k] = s_vph[sb * kSX + k * kFV + v] + vs;
          vr[k] = s_vph[(kFB + sb) * kSX + k * kFV + v] + vs;
        }
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          float o = mo[e][4 * i + 3];
          float x = mr[e][4 * i + 3];
#pragma unroll
          for (int k = 0; k < 3; ++k) { o += mo[e][4 * i + k] * vo[k]; x += mr[e][4 * i + k] * vr[k]; }
          const float diff = x - o;
          if (valid) local += fabsf(diff);
          g[i] = valid ? (float)(diff > 0.f) - (float)(diff < 0.f) : 0.f;
        }
        if (grad) {
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            s_g[sb * kSX + k * kFV + v] = g[k];
            s_gvp[sb * kSX + k * kFV + v] =
                mo[e][k] * g[0] + mo[e][4 + k] * g[1] + mo[e][8 + k] * g[2];
            s_vph[sb * kSX + k * kFV + v] = vo[k];
          }
        }
      }
    }
    __syncthreads();

    // 3-5. gpf, gA and the tile's gvsh (skin_common.cuh)
    if (grad)
      tile_grads(q, gpf_acc, ga_acc, s_gvp, s_g, s_vph, s_pd, s_w, V, v0, bt,
                 gvsh_part);
    __syncthreads();
  }

  // the block's partials
  float* s_red = smem + kOffRed;
  s_red[tid] = local;
  __syncthreads();
  for (int s = kFT / 2; s > 0; s >>= 1) {
    if (tid < s) s_red[tid] += s_red[tid + s];
    __syncthreads();
  }
  if (tid == 0) tot_part[(size_t)bt * R + r] = s_red[0];
  if (grad) store_grad_parts(q, B, b0, r, gpf_acc, ga_acc, gpf_part, ga_part);
}

}  // namespace

namespace {

// The fused mode's rows a batch tile and vertex ranges at (B, V): the
// warp-specialised kernel's with f32 tables, the one-phase kernel's (K3b's
// rule) with bf16 ones.
template <typename T>
void fused_grid(int B, int V, int& rows, int& R) {
  if constexpr (kIsBf16<T>) {
    rows = kFB;
    R = fused_ranges(B, V);
  } else {
    rows = kWR;
    R = ws_ranges(B, V);
  }
}

template <typename T>
int scratch_floats(int B, int V, int mode) {
  if (B <= 0 || V <= 0 || mode < 0 || mode > 2) return -1;
  if (mode == 2) {
    const int n_bt = fwd_batch_tiles<2>(B);
    return n_bt * fwd_ranges(n_bt, V);
  }
  int rows, R;
  fused_grid<T>(B, V, rows, R);
  const long long n_bt = cdiv(B, rows);
  long long n = n_bt * R;
  if (mode == 1) n += (long long)R * B * (kP + kGL) + n_bt * 3 * V;
  return n < (1LL << 31) ? (int)n : -1;
}

}  // namespace

// Floats of scratch nemo_v2v_l1 needs for (B, V, mode): mode 0 the |diff|
// partials; mode 1 also the gpf and gA partials a range and the gvsh
// partials a batch tile; mode 2 the forward kernel's |diff| partials. -1
// for a shape it refuses. The _bf16 twin: nemo_v2v_l1_bf16's.
extern "C" int nemo_v2v_scratch_floats(int B, int V, int mode) {
  return scratch_floats<float>(B, V, mode);
}
extern "C" int nemo_v2v_scratch_floats_bf16(int B, int V, int mode) {
  return scratch_floats<bf16>(B, V, mode);
}

// Registers, shared memory and local memory (spills) of the pair mode's
// kernel, skin_fwd_kernel<2, T>, as the CUDA runtime reports them:
// out[0..3] = registers, static and dynamic shared memory bytes, local
// bytes.
extern "C" int nemo_v2v_pair_attributes(int* out) {
  return skin_fwd_attributes<2, float>(out);
}
extern "C" int nemo_v2v_pair_attributes_bf16(int* out) {
  return skin_fwd_attributes<2, bf16>(out);
}

namespace {

template <typename Kernel>
int fused_attributes(Kernel kernel, size_t smem_bytes, int* out) {
  cudaFuncAttributes a;
  if (cudaError_t err = cudaFuncGetAttributes(&a, kernel)) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)smem_bytes;
  out[3] = (int)a.localSizeBytes;
  return 0;
}

}  // namespace

// The same for the fused mode's kernel (modes 0 and 1): with f32 tables
// v2v_fused_kernel_ws, with bf16 ones v2v_fused_kernel<bf16>.
extern "C" int nemo_v2v_fused_attributes(int* out) {
  return fused_attributes(v2v_fused_kernel_ws, kWSmemBytes, out);
}
extern "C" int nemo_v2v_fused_attributes_bf16(int* out) {
  return fused_attributes(v2v_fused_kernel<bf16>, kSmemBytes, out);
}

namespace {

template <typename T>
int v2v_l1(int B, int V, const float* pf_o, const float* A_o,
           const float* pf_r, const float* A_r, const float* vsh, const T* pd,
           const T* W, const float* pd_pad, int ldv, int mode,
           float* scratch, float* sign, T* vp, float* total, float* gpf,
           float* gA, float* gvsh, cudaStream_t stream) {
  if (B <= 0 || V <= 0 || mode < 0 || mode > 2 ||
      (mode == 2 && !sign) || (mode == 1 && (!gpf || !gA || !gvsh)))
    return (int)cudaErrorInvalidValue;
  if (!kIsBf16<T> && mode < 2 &&
      (!pd_pad || ldv % 4 != 0 || ldv < cdiv(V, kFV) * kFV))
    return (int)cudaErrorInvalidValue;
  if (mode == 2) {
    if (cdiv(B, kFB / 2) > 65535) return (int)cudaErrorInvalidValue;
    if (cudaError_t err = launch_skin_fwd<2, T>(B, V, pf_o, A_o, pf_r, A_r,
                                                vsh, pd, W, sign, vp, scratch,
                                                stream))
      return (int)err;
    const int n_bt = fwd_batch_tiles<2>(B);
    total_kernel<<<1, 256, 0, stream>>>(n_bt * fwd_ranges(n_bt, V), scratch,
                                        total);
    return (int)cudaGetLastError();
  }
  int rows, R;
  fused_grid<T>(B, V, rows, R);
  const int n_bt = cdiv(B, rows), grad = mode == 1;
  if (n_bt > 65535) return (int)cudaErrorInvalidValue;
  float* tot_part = scratch;
  float* gpf_part = grad ? tot_part + (size_t)n_bt * R : nullptr;
  float* ga_part = grad ? gpf_part + (size_t)R * B * kP : nullptr;
  float* gvsh_part = grad ? ga_part + (size_t)R * B * kGL : nullptr;
  if constexpr (kIsBf16<T>) {
    if (cudaError_t err = cudaFuncSetAttribute(
            v2v_fused_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)kSmemBytes))
      return (int)err;
    v2v_fused_kernel<T><<<dim3(R, n_bt), kFT, kSmemBytes, stream>>>(
        B, V, R, pf_o, A_o, pf_r, A_r, vsh, pd, W, grad, tot_part, gpf_part,
        ga_part, gvsh_part);
  } else {
    if (cudaError_t err = cudaFuncSetAttribute(
            v2v_fused_kernel_ws, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)kWSmemBytes))
      return (int)err;
    v2v_fused_kernel_ws<<<dim3(R, n_bt), kWT, kWSmemBytes, stream>>>(
        B, V, R, pf_o, A_o, pf_r, A_r, vsh, pd_pad, ldv, W, grad, tot_part,
        gpf_part, ga_part, gvsh_part);
  }
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  total_kernel<<<1, 256, 0, stream>>>(n_bt * R, tot_part, total);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  if (!grad) return 0;
  const int n_gpf = B * kP, n_ga = B * kGL, n_gvsh = 3 * V;
  range_reduce_kernel<<<cdiv(n_gpf + n_ga + n_gvsh, 256), 256, 0, stream>>>(
      n_gpf, n_ga, n_gvsh, R, n_bt, gpf_part, ga_part, gvsh_part, gpf, gA,
      gvsh);
  return (int)cudaGetLastError();
}

}  // namespace

// pf_* (B,207), A_* (B,24,12) on 16-byte boundaries, vsh (3,V), pd
// (207,3,V), W (24,V) (on 8-byte boundaries where V is even), all f32
// contiguous on one device; pd_pad (207,3,ldv), the table that modes 0 and 1
// read in place of pd (mode 2 may pass null): ldv a multiple of 4, at least
// V rounded up to a multiple of 16, zero past V, on a 16-byte boundary;
// scratch: nemo_v2v_scratch_floats(B, V, mode) floats; total: 1 float.
// mode 0: total only (sign, vp, gpf, gA, gvsh may be null). mode 1: also
// gpf (B,207), gA (B,24,12), gvsh (3,V). mode 2 (pair): also sign (B,3,V)
// and, unless vp is null, vp (B,3,V).
extern "C" int nemo_v2v_l1(int B, int V, const float* pf_o, const float* A_o,
                           const float* pf_r, const float* A_r,
                           const float* vsh, const float* pd, const float* W,
                           const float* pd_pad, int ldv, int mode,
                           float* scratch, float* sign, float* vp,
                           float* total, float* gpf, float* gA, float* gvsh,
                           cudaStream_t stream) {
  return v2v_l1<float>(B, V, pf_o, A_o, pf_r, A_r, vsh, pd, W, pd_pad, ldv,
                       mode, scratch, sign, vp, total, gpf, gA, gvsh, stream);
}

// The same with bf16 tables: pd and W bf16 (on 4-byte boundaries where V
// is even), vp (B,3,V) bf16, no padded table (every mode reads pd);
// everything else as nemo_v2v_l1.
extern "C" int nemo_v2v_l1_bf16(int B, int V, const float* pf_o,
                                const float* A_o, const float* pf_r,
                                const float* A_r, const float* vsh,
                                const bf16* pd, const bf16* W, int mode,
                                float* scratch, float* sign, bf16* vp,
                                float* total, float* gpf, float* gA,
                                float* gvsh, cudaStream_t stream) {
  return v2v_l1<bf16>(B, V, pf_o, A_o, pf_r, A_r, vsh, pd, W, nullptr, 0,
                      mode, scratch, sign, vp, total, gpf, gA, gvsh, stream);
}
