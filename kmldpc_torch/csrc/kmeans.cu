// Kernel K1: the whole blind k-means gain estimate, one warp per row.
//
// Replaces kmldpc_tpu/detect/kmeans_pallas.py::_kmeans_kernel (the Pallas
// TPU kernel launched by make_blind_estimator_pallas).  It computes what
// that kernel computes, per row of received symbols y [B, Nsym]:
//
//   init:  hhat = y[argmax |y|^2] / s_init          (first index on ties)
//   iters rounds of:
//     assignment of every y_j to the nearest s_m * hhat (strict <, so the
//       first minimum wins)
//     per-cluster counts and sums; centroid = sum / max(count, 1)
//     anchor: the max-|centroid| nonempty cluster (first on ties) divided
//       by its own point ("max"), or cluster 0 / s_0 ("first"); an empty
//       anchor keeps hhat
//   out:   the 4 candidates hhat * {1, j, -1, -j} as [B, 4] re/im planes.
//
// With early_exit set, a row stops once an iteration's assignment equals the
// previous one's.  That is bitwise the fixed loop: the update is a function
// of the assignment (an empty anchor keeps the gain the fixed point already
// holds), so every later iteration would reproduce the same gain and
// assignment (kmeans_pallas.py, the comment on early_exit).  On the TPU the
// whole tile had to settle; here each warp leaves on its own row's test.
//
// What bounds it on Hopper: FP32 arithmetic.  y is read once (8 * Nsym bytes
// a row); then each iteration evaluates Nsym * M distances of 6 unfused
// operations each.  No matrix product exists, so wgmma has nothing to do,
// and one pass over y leaves nothing for TMA to pipeline.  The design:
//
// * One warp per row, kWarps rows per block, and no __syncthreads at all:
//   a warp's row, assignments and sums never leave the warp.
// * The row sits in the warp's slice of shared memory (lane l owns symbols
//   l, l + 32, ...), and the lane assigns kTile of them at a time, centres
//   outer and symbols inner, so kTile compare chains run side by side.  The
//   loop over tiles stays rolled: a row held in registers needs the loop
//   unrolled over the whole row, and that code ran slower per symbol on the
//   H100 than this one.
// * Per-cluster counts and float64 sums, per lane first: for QPSK in
//   registers, for 16QAM in the lane's own column of a per-warp
//   shared-memory slab.  The warp then combines them by a fixed
//   reduce-scatter of shuffles that leaves lane l with the totals of one
//   cluster.  For 64QAM the slab has 16 columns (lanes l and l + 16 take
//   turns on column l % 16), summed column by column by the lane that owns
//   the cluster.  For 256QAM it has 4 columns, which 8 lanes each take in
//   turn (l, l + 4, ..., l + 28 on column l % 4): a slab of 16 columns
//   would be 87 KB a warp, and a warp's slice 100 KB, against the 227 KB a
//   block may use; at 4 columns a slice of 1,008 symbols takes 41 KB.  An
//   assignment there is a 16-bit label, since all 256 byte values name a
//   cluster.  Every order is fixed: the same bits on every launch, no
//   atomics.
// * The init's argmax and the anchor's argmax are warp shuffle reductions
//   (first index on ties); every lane then holds the same gain.
//
// Numerics.  Distances, centres and the gain update use __fmul_rn /
// __fadd_rn / __fsub_rn so the compiler cannot contract them into FMAs:
// each step rounds exactly like the plain PyTorch version
// (detect/kmeans.py), which evaluates them as separate float32 ops.
// Divisions are IEEE true divisions (the build does not use fast math).
// Sums are float64, rounded once to float32, as in the plain version.  The
// kernel adds in another order than the plain version's reduction, so the
// two are guaranteed to agree to rounding only.  They agree bitwise on every
// input tested: float64 holds such a sum exactly, in any order, while a
// row's nonzero components lie within 2^18 of one another in magnitude (53
// bits, less the 23 below a float32's leading bit and 12 of carries over up
// to 4096 terms; a row of 1,008 symbols at 256 points needs 10).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kWarps = 4;  // rows per block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
// Where the per-cluster float64 partials live, chosen by M (timed on the
// H100): M <= kRegPoints in registers, one fused op a cluster a symbol;
// M <= kLanePoints in the lane's own column of a shared-memory slab, one
// read-modify-write a symbol (faster than registers for M = 16, slower for
// M = 4); larger M in a slab of fewer columns, which lanes share, to fit
// the shared memory (slab_cols).  Centres stay in registers up to
// kLanePoints.
constexpr int kRegPoints = 4;
constexpr int kLanePoints = 16;
// symbols a lane assigns at once (6 ran faster than 4 and 12 on the H100)
constexpr int kTile = 6;
constexpr int kCentreChunk = 8;  // shared-memory centres read ahead at once (divides M)

// Columns of the partials' slab: one a lane up to kLanePoints; above, 16
// (lanes l and l + 16 share column l % 16), and 4 above 64 points (lanes
// l, l + 4, ..., l + 28 share column l % 4).
__host__ __device__ constexpr int slab_cols(int m) {
  return m <= kLanePoints ? 32 : m <= 64 ? 16 : 4;
}
// Row stride: 32 for a column a lane; else odd, so that the owners' column
// sums do not conflict.
__host__ __device__ constexpr int slab_stride(int m) {
  return m <= kLanePoints ? 32 : slab_cols(m) + 1;
}
__host__ __device__ constexpr bool has_slab(int m) { return m > kRegPoints; }
// Bytes of an assignment: a byte up to 255 points, whose 0xff means none;
// 16 bits above.
__host__ __device__ constexpr int label_bytes(int m) { return m < 256 ? 1 : 2; }
constexpr size_t kMaxSmem = 232448;         // 227 KB a block may use on sm_90

template <int M>
struct Points {
  float re[M];
  float im[M];
};

__device__ __forceinline__ float cmul_re(float ar, float ai, float br, float bi) {
  return __fsub_rn(__fmul_rn(ar, br), __fmul_rn(ai, bi));
}

__device__ __forceinline__ float cmul_im(float ar, float ai, float br, float bi) {
  return __fadd_rn(__fmul_rn(ar, bi), __fmul_rn(ai, br));
}

__device__ __forceinline__ float norm2(float a, float b) {
  return __fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b));
}

// (ar + j ai) / (sr + j si) written as (a * conj(s)) / |s|^2, rounding each
// step like the plain version.
__device__ __forceinline__ void cdiv(float ar, float ai, float sr, float si,
                                     float* qr, float* qi) {
  const float n = norm2(sr, si);
  *qr = __fadd_rn(__fmul_rn(ar, sr), __fmul_rn(ai, si)) / n;
  *qi = __fsub_rn(__fmul_rn(ai, sr), __fmul_rn(ar, si)) / n;
}

__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) & ~size_t{15}; }

__host__ __device__ constexpr int log2i(int x) { return x <= 1 ? 0 : 1 + log2i(x / 2); }

// Symbol slots a lane holds: ceil(nsym / 32) rounded up to whole tiles.
__host__ __device__ constexpr int row_slots(int nsym) {
  return ((nsym + 31) / 32 + kTile - 1) / kTile * kTile;
}

// One warp's slice of dynamic shared memory, byte offsets from its base,
// for a lane holding `slots` symbol slots (32 * slots >= nsym).
struct WarpSmem {
  size_t points;   // [M] float2: the constellation, for indices known at run time
  size_t assign;   // [32 * slots] labels (label_bytes(M) each): last assignment (all ones: none)
  size_t centres;  // [M] float2 (M > kLanePoints)
  size_t row;      // [2, 32 * slots] float: the row, zeros past nsym
  size_t slab;     // [M, slab_stride(M)] double re, double im, int count (M > kRegPoints)
  size_t total;
};

__host__ __device__ inline WarpSmem warp_smem(int m, int slots) {
  WarpSmem w{};
  size_t off = 0;
  w.points = off;
  off = align16(off + 2 * sizeof(float) * m);
  w.assign = off;
  off = align16(off + static_cast<size_t>(label_bytes(m)) * 32 * slots);
  w.centres = off;
  if (m > kLanePoints) off = align16(off + 2 * sizeof(float) * m);
  w.row = off;
  off = align16(off + 2 * sizeof(float) * 32 * slots);
  w.slab = off;
  if (has_slab(m)) off = align16(off + (2 * sizeof(double) + sizeof(int)) * m * slab_stride(m));
  w.total = off;
  return w;
}

// Warp argmax of (v, idx), greatest v and then smallest idx, carrying the
// winner's centroid and count; every lane ends with the same winner.  Lanes
// that differ only in bits below kLowBit must already hold equal values.
template <int kLowBit = 1>
__device__ __forceinline__ void warp_argmax(float* v, int* idx, float* cr, float* ci,
                                            float* cnt) {
#pragma unroll
  for (int off = 16; off >= kLowBit; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, *v, off);
    const int oi = __shfl_xor_sync(kFull, *idx, off);
    const float orr = __shfl_xor_sync(kFull, *cr, off);
    const float oii = __shfl_xor_sync(kFull, *ci, off);
    const float oc = __shfl_xor_sync(kFull, *cnt, off);
    if (ov > *v || (ov == *v && oi < *idx)) {
      *v = ov;
      *idx = oi;
      *cr = orr;
      *ci = oii;
      *cnt = oc;
    }
  }
}

// One reduce-scatter step per HALF = M/2, M/4, ..., 1: lanes that differ in
// bit 16 * 2 * HALF / M swap halves of their partials; the upper lane keeps
// clusters [HALF, 2 HALF) of what it holds, the lower lane [0, HALF).  The
// sums land in slots [0, HALF) and *c counts the clusters passed over.
template <int M, int HALF>
__device__ __forceinline__ void reduce_scatter(double (&pr)[M], double (&pi)[M], int (&pc)[M],
                                               int lane, int* c) {
  if constexpr (HALF >= 1) {
    constexpr int bit = 32 * HALF / M;
    const bool upper = (lane & bit) != 0;
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      const double send_r = upper ? pr[i] : pr[i + HALF];
      const double send_i = upper ? pi[i] : pi[i + HALF];
      const int send_c = upper ? pc[i] : pc[i + HALF];
      const double keep_r = upper ? pr[i + HALF] : pr[i];
      const double keep_i = upper ? pi[i + HALF] : pi[i];
      const int keep_c = upper ? pc[i + HALF] : pc[i];
      pr[i] = __dadd_rn(keep_r, __shfl_xor_sync(kFull, send_r, bit));
      pi[i] = __dadd_rn(keep_i, __shfl_xor_sync(kFull, send_i, bit));
      pc[i] = keep_c + __shfl_xor_sync(kFull, send_c, bit);
    }
    if (upper) *c += HALF;
    reduce_scatter<M, HALF / 2>(pr, pi, pc, lane, c);
  }
}

// Nearest centre of each of the tile's kTile symbols (strict <: first
// minimum).  Centres outer, symbols inner: the compare chains are
// independent, so the compiler interleaves them.  Centres come from
// registers (cr, ci) for M <= kLanePoints, else from shared memory
// (broadcast reads).
template <int M>
__device__ __forceinline__ void nearest(const float (&a)[kTile], const float (&b)[kTile],
                                        const float* cr, const float* ci,
                                        const float2* s_cent, int (&mbest)[kTile]) {
  float dbest[kTile];
  // centres m0 .. m0 + N - 1 against the tile; m0 = 0 starts the minimum
  auto block = [&](int m0, const float* c_r, const float* c_i, auto n) {
#pragma unroll
    for (int j = 0; j < decltype(n)::value; ++j) {
#pragma unroll
      for (int k = 0; k < kTile; ++k) {
        const float d = norm2(__fsub_rn(a[k], c_r[j]), __fsub_rn(b[k], c_i[j]));
        if ((m0 == 0 && j == 0) || d < dbest[k]) {
          dbest[k] = d;
          mbest[k] = m0 + j;
        }
      }
    }
  };
  if constexpr (M <= kLanePoints) {
    block(0, cr, ci, std::integral_constant<int, M>{});
  } else {
    // kCentreChunk centres at a time, read from shared memory before use so
    // that the loads are not on the compare chains' path
    constexpr int kChunk = kCentreChunk;
    const float4* s_c4 = reinterpret_cast<const float4*>(s_cent);
#pragma unroll 1
    for (int m0 = 0; m0 < M; m0 += kChunk) {
      float c_r[kChunk], c_i[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; j += 2) {
        const float4 c = s_c4[(m0 + j) / 2];
        c_r[j] = c.x;
        c_i[j] = c.y;
        c_r[j + 1] = c.z;
        c_i[j + 1] = c.w;
      }
      block(m0, c_r, c_i, std::integral_constant<int, kChunk>{});
    }
  }
}

// Adds the tile's symbols to their clusters' float64 partials.  fma(w, y, p)
// with w = 1 rounds like p + y, and with w = 0 leaves p as it is (p is never
// -0), so every cluster takes one fused op a symbol and no branch.
template <int M>
__device__ __forceinline__ void accumulate(const float (&a)[kTile], const float (&b)[kTile],
                                           const int (&hit)[kTile], double (&pr)[M],
                                           double (&pi)[M], int (&pc)[M]) {
#pragma unroll
  for (int k = 0; k < kTile; ++k) {
    const double da = a[k], db = b[k];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const bool h = hit[k] == m;
      const double w = h ? 1.0 : 0.0;
      pr[m] = __fma_rn(w, da, pr[m]);
      pi[m] = __fma_rn(w, db, pi[m]);
      pc[m] += h;
    }
  }
}

template <int M, bool kFirst>
__global__ void __launch_bounds__(kThreads)
kmeans_kernel(const float* __restrict__ yr_g, const float* __restrict__ yi_g,
              float* __restrict__ h4r, float* __restrict__ h4i, int batch, int nsym,
              int iters, int init_idx, int early_exit, int* __restrict__ rounds,
              Points<M> pts) {
  constexpr bool kSlab = M > kLanePoints;  // shared columns, centres in shared memory
  constexpr bool kLaneSlab = M > kRegPoints && !kSlab;
  constexpr int kStride = slab_stride(M);
  constexpr int kSlabCols = slab_cols(M);
  using Label = std::conditional_t<label_bytes(M) == 1, uint8_t, uint16_t>;
  constexpr int kNone = static_cast<Label>(~0u);  // no cluster (padding, or no assignment yet)
  extern __shared__ __align__(16) unsigned char smem[];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= batch) return;  // the whole warp leaves; no block barrier follows

  // slots past nsym hold zeros and count nowhere
  const int nk = row_slots(nsym);
  const WarpSmem lay = warp_smem(M, nk);
  unsigned char* base = smem + static_cast<size_t>(warp) * lay.total;
  float2* s_pts = reinterpret_cast<float2*>(base + lay.points);
  Label* s_assign = reinterpret_cast<Label*>(base + lay.assign);
  float2* s_cent = reinterpret_cast<float2*>(base + lay.centres);
  float* s_yr = reinterpret_cast<float*>(base + lay.row);
  float* s_yi = s_yr + 32 * nk;
  double* slab_r = reinterpret_cast<double*>(base + lay.slab);
  double* slab_i = slab_r + M * kStride;
  int* slab_n = reinterpret_cast<int*>(slab_i + M * kStride);

  const float* yr = yr_g + static_cast<size_t>(row) * nsym;
  const float* yi = yi_g + static_cast<size_t>(row) * nsym;
#pragma unroll
  for (int m = 0; m < M; ++m) {  // constant indices: pts stays in the parameter bank
    if ((m & 31) == lane) s_pts[m] = make_float2(pts.re[m], pts.im[m]);
  }

  // --- load the row once; argmax |y|^2, first index on ties ---
  float best = -1.0f;  // |y|^2 >= 0, so any symbol beats it
  int bidx = nsym;
  float bre = 0.0f, bim = 0.0f;
  for (int k = 0; k < nk; ++k) {
    const int s = lane + 32 * k;
    const bool valid = s < nsym;
    const float a = valid ? yr[s] : 0.0f;
    const float b = valid ? yi[s] : 0.0f;
    const float m2 = norm2(a, b);
    if (valid && m2 > best) {  // s increases with k, so strict > keeps the first
      best = m2;
      bidx = s;
      bre = a;
      bim = b;
    }
    s_yr[s] = a;
    s_yi[s] = b;
    s_assign[s] = kNone;  // no assignment yet
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(kFull, best, off);
    const int oi = __shfl_xor_sync(kFull, bidx, off);
    const float ore = __shfl_xor_sync(kFull, bre, off);
    const float oim = __shfl_xor_sync(kFull, bim, off);
    if (ob > best || (ob == best && oi < bidx)) {
      best = ob;
      bidx = oi;
      bre = ore;
      bim = oim;
    }
  }
  __syncwarp();
  float hr, hi;  // the same on every lane from here on
  const float2 s_init = s_pts[init_idx];
  cdiv(bre, bim, s_init.x, s_init.y, &hr, &hi);

  if constexpr (has_slab(M)) {
    for (int i = lane; i < M * kStride; i += 32) {
      slab_r[i] = 0.0;
      slab_i[i] = 0.0;
      slab_n[i] = 0;
    }
  }
  __syncwarp();

  int passes = 0;  // assignment passes run
  for (int it = 0; it < iters; ++it) {
    // --- centres s_m * hhat ---
    float cr[kSlab ? 1 : M], ci[kSlab ? 1 : M];
    if constexpr (kSlab) {
      for (int m = lane; m < M; m += 32) {
        const float2 p = s_pts[m];
        s_cent[m] = make_float2(cmul_re(hr, hi, p.x, p.y), cmul_im(hr, hi, p.x, p.y));
      }
      __syncwarp();
    } else {
#pragma unroll
      for (int m = 0; m < M; ++m) {
        cr[m] = cmul_re(hr, hi, pts.re[m], pts.im[m]);
        ci[m] = cmul_im(hr, hi, pts.re[m], pts.im[m]);
      }
    }

    // --- assignment, tile by tile, and the partials ---
    double pr[kSlab ? 1 : M], pi[kSlab ? 1 : M];
    int pc[kSlab ? 1 : M];
    if constexpr (!kSlab) {
#pragma unroll
      for (int m = 0; m < M; ++m) {
        pr[m] = 0.0;
        pi[m] = 0.0;
        pc[m] = 0;
      }
    }
    bool changed = false;
#pragma unroll 1
    for (int k0 = 0; k0 < nk; k0 += kTile) {
      float a[kTile], b[kTile];
      int mbest[kTile];
#pragma unroll
      for (int k = 0; k < kTile; ++k) {
        a[k] = s_yr[lane + 32 * (k0 + k)];
        b[k] = s_yi[lane + 32 * (k0 + k)];
      }
      nearest<M>(a, b, cr, ci, s_cent, mbest);
#pragma unroll
      for (int k = 0; k < kTile; ++k) {
        if (lane + 32 * (k0 + k) >= nsym) mbest[k] = kNone;  // padding: no cluster
      }
      if constexpr (kLaneSlab) {
        // this lane's column of the slab: one read-modify-write a symbol
#pragma unroll
        for (int k = 0; k < kTile; ++k) {
          if (mbest[k] != kNone) {
            const int at = mbest[k] * 32 + lane;
            slab_r[at] = __dadd_rn(slab_r[at], static_cast<double>(a[k]));
            slab_i[at] = __dadd_rn(slab_i[at], static_cast<double>(b[k]));
            slab_n[at] += 1;
          }
        }
      } else if constexpr (!kSlab) {
        accumulate<M>(a, b, mbest, pr, pi, pc);
      }
      if (kSlab || early_exit) {
#pragma unroll
        for (int k = 0; k < kTile; ++k) {
          const int s = lane + 32 * (k0 + k);
          changed |= s_assign[s] != mbest[k];
          s_assign[s] = static_cast<Label>(mbest[k]);
        }
      }
    }
    ++passes;
    // assignment unchanged on every lane: the update would change nothing
    if (early_exit && __all_sync(kFull, !changed)) break;

    // --- per-cluster totals: this lane's cluster(s), centroid, |centroid| ---
    float kv, kr, ki, kc;
    int kidx;
    if constexpr (!kSlab) {
      // reduce-scatter: each step hands half of the clusters to the partner
      // lane and keeps the other half, so lane l ends with cluster c's sum
      if constexpr (kLaneSlab) {
#pragma unroll
        for (int m = 0; m < M; ++m) {  // take this lane's column and clear it
          pr[m] = slab_r[m * 32 + lane];
          pi[m] = slab_i[m * 32 + lane];
          pc[m] = slab_n[m * 32 + lane];
          slab_r[m * 32 + lane] = 0.0;
          slab_i[m * 32 + lane] = 0.0;
          slab_n[m * 32 + lane] = 0;
        }
      }
      int c = 0;
      reduce_scatter<M, M / 2>(pr, pi, pc, lane, &c);
#pragma unroll
      for (int bit = 16 >> log2i(M); bit > 0; bit >>= 1) {
        pr[0] = __dadd_rn(pr[0], __shfl_xor_sync(kFull, pr[0], bit));
        pi[0] = __dadd_rn(pi[0], __shfl_xor_sync(kFull, pi[0], bit));
        pc[0] += __shfl_xor_sync(kFull, pc[0], bit);
      }
      kc = static_cast<float>(pc[0]);
      const float safe = fmaxf(kc, 1.0f);
      kr = __double2float_rn(pr[0]) / safe;
      ki = __double2float_rn(pi[0]) / safe;
      kv = kc > 0.0f ? norm2(kr, ki) : -1.0f;
      kidx = c;  // lane 0 holds cluster 0
    } else {
      __syncwarp();
      const int col = lane % kSlabCols;
#pragma unroll
      for (int turn = 0; turn < 32 / kSlabCols; ++turn) {
        if (lane / kSlabCols == turn) {
          for (int k = 0; k < nk; ++k) {
            const int s = lane + 32 * k;
            const int m = s_assign[s];
            if (m != kNone) {
              const int at = m * kStride + col;
              slab_r[at] = __dadd_rn(slab_r[at], static_cast<double>(s_yr[s]));
              slab_i[at] = __dadd_rn(slab_i[at], static_cast<double>(s_yi[s]));
              slab_n[at] += 1;
            }
          }
        }
        __syncwarp();
      }
      // lane l owns clusters l, l + 32, ... below M: it sums their columns
      // in order and clears them for the next iteration
      kv = -2.0f;
      kidx = M;
      kr = ki = kc = 0.0f;
#pragma unroll
      for (int j = 0; j < (M + 31) / 32; ++j) {
        const int m = lane + 32 * j;
        if (m >= M) break;
        double sr = 0.0, si = 0.0;
        int n = 0;
#pragma unroll 4
        for (int cc = 0; cc < kSlabCols; ++cc) {
          const int at = m * kStride + cc;
          sr = __dadd_rn(sr, slab_r[at]);
          si = __dadd_rn(si, slab_i[at]);
          n += slab_n[at];
          slab_r[at] = 0.0;
          slab_i[at] = 0.0;
          slab_n[at] = 0;
        }
        const float cnt = static_cast<float>(n);
        const float safe = fmaxf(cnt, 1.0f);
        const float cr_m = __double2float_rn(sr) / safe;
        const float ci_m = __double2float_rn(si) / safe;
        const float v = cnt > 0.0f ? norm2(cr_m, ci_m) : -1.0f;
        // m increases with j: strict > keeps the first; "first" wants cluster 0
        if (kFirst ? m == 0 : v > kv) {
          kv = v;
          kidx = m;
          kr = cr_m;
          ki = ci_m;
          kc = cnt;
        }
      }
      __syncwarp();
    }

    // --- anchor and re-projection ---
    if constexpr (kFirst) {
      kidx = 0;
      kr = __shfl_sync(kFull, kr, 0);
      ki = __shfl_sync(kFull, ki, 0);
      kc = __shfl_sync(kFull, kc, 0);
    } else {
      // after the reduce-scatter, lanes that differ below bit 32 / M hold
      // the same cluster's totals
      warp_argmax<kSlab ? 1 : 32 / M>(&kv, &kidx, &kr, &ki, &kc);
    }
    if (kc > 0.0f) {  // an empty anchor keeps hhat
      const float2 sk = s_pts[kidx];
      cdiv(kr, ki, sk.x, sk.y, &hr, &hi);
    }
  }

  if (lane < 4) {
    // hhat * {1, j, -1, -j}
    const float outr = lane == 0 ? hr : lane == 1 ? -hi : lane == 2 ? -hr : hi;
    const float outi = lane == 0 ? hi : lane == 1 ? hr : lane == 2 ? -hi : -hr;
    h4r[static_cast<size_t>(row) * 4 + lane] = outr;
    h4i[static_cast<size_t>(row) * 4 + lane] = outi;
  }
  if (rounds != nullptr && lane == 0) rounds[row] = passes;
}

struct Args {
  const float* yr;
  const float* yi;
  float* h4r;
  float* h4i;
  int batch, nsym;
  const float* pts_re;
  const float* pts_im;
  int iters, init_idx, early_exit;
  int* rounds;
  cudaStream_t stream;
};

// A block's dynamic shared memory for rows of nsym symbols, with the
// attribute that allows more than 48 KB set on the kernel.
template <int M, bool kFirst>
cudaError_t prepare(int nsym, size_t* smem) {
  *smem = warp_smem(M, row_slots(nsym)).total * kWarps;
  if (*smem > kMaxSmem) return cudaErrorInvalidValue;
  if (*smem <= 48 * 1024) return cudaSuccess;
  auto* kern = kmeans_kernel<M, kFirst>;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

template <int M, bool kFirst>
cudaError_t launch(const Args& a) {
  size_t smem = 0;
  const cudaError_t e = prepare<M, kFirst>(a.nsym, &smem);
  if (e != cudaSuccess) return e;
  auto* kern = kmeans_kernel<M, kFirst>;
  Points<M> pts;
  for (int m = 0; m < M; ++m) {
    pts.re[m] = a.pts_re[m];
    pts.im[m] = a.pts_im[m];
  }
  const int blocks = (a.batch + kWarps - 1) / kWarps;
  kern<<<blocks, kThreads, smem, a.stream>>>(a.yr, a.yi, a.h4r, a.h4i, a.batch, a.nsym,
                                             a.iters, a.init_idx, a.early_exit, a.rounds,
                                             pts);
  return cudaGetLastError();
}

template <int M>
cudaError_t launch_anchor(bool first, const Args& a) {
  return first ? launch<M, true>(a) : launch<M, false>(a);
}

template <int M, bool kFirst>
cudaError_t resident(int nsym, int* rows) {
  size_t smem = 0;
  const cudaError_t e = prepare<M, kFirst>(nsym, &smem);
  if (e != cudaSuccess) return e;
  int blocks = 0;
  auto* kern = kmeans_kernel<M, kFirst>;
  const cudaError_t o =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, kThreads, smem);
  *rows = blocks * kWarps;
  return o;
}

template <int M>
cudaError_t resident_anchor(bool first, int nsym, int* rows) {
  return first ? resident<M, true>(nsym, rows) : resident<M, false>(nsym, rows);
}

}  // namespace

// Rows of nsym symbols (one warp each) that one SM holds at once, by the
// CUDA runtime's occupancy calculator: what the kernel's registers and
// shared memory leave room for.  Returns a cudaError_t as kmldpc_kmeans does.
extern "C" int kmldpc_kmeans_rows_per_sm(int m, int anchor_first, int nsym, int* rows) {
  if (nsym <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool first = anchor_first != 0;
  switch (m) {
    case 4:
      return static_cast<int>(resident_anchor<4>(first, nsym, rows));
    case 16:
      return static_cast<int>(resident_anchor<16>(first, nsym, rows));
    case 64:
      return static_cast<int>(resident_anchor<64>(first, nsym, rows));
    case 256:
      return static_cast<int>(resident_anchor<256>(first, nsym, rows));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Plain C entry point, bound with ctypes.  Pointers are device pointers
// except pts_re / pts_im (host, M floats each); rounds (device, [B] int32)
// may be null, else it receives the assignment passes each row ran.  Returns
// the cudaError_t of the launch (0 on success); cudaErrorInvalidValue for an
// M the kernel is not instantiated for or a shape it does not take.
extern "C" int kmldpc_kmeans(const float* yr, const float* yi, float* h4r, float* h4i,
                             int batch, int nsym, const float* pts_re,
                             const float* pts_im, int m, int iters, int init_idx,
                             int anchor_first, int early_exit, int* rounds,
                             void* stream) {
  if (batch <= 0 || nsym <= 0 || iters < 0 || init_idx < 0 || init_idx >= m) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{yr, yi, h4r, h4i, batch, nsym, pts_re, pts_im, iters, init_idx,
               early_exit != 0 ? 1 : 0, rounds, static_cast<cudaStream_t>(stream)};
  const bool first = anchor_first != 0;
  switch (m) {
    case 4:
      return static_cast<int>(launch_anchor<4>(first, a));
    case 16:
      return static_cast<int>(launch_anchor<16>(first, a));
    case 64:
      return static_cast<int>(launch_anchor<64>(first, a));
    case 256:
      return static_cast<int>(launch_anchor<256>(first, a));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
