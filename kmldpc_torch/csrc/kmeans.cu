// Kernel K1: the whole blind k-means gain estimate, one thread block per row.
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
// What bounds it on Hopper: arithmetic, not bytes.  A row's y is read from
// device memory once (Nsym * 8 bytes), then every iteration evaluates
// Nsym * M distances (20 x 1152 x 4 for QPSK, 20 x 384 x 64 for 64QAM).
// The design keeps everything after the first read on chip: the row lives
// in shared memory, the M cluster centres are recomputed into shared memory
// each iteration (broadcast reads), each thread assigns a strided subset of
// the symbols, and the assignments stay in shared memory as bytes.  The
// grid is exactly B blocks, so every output row is written for any B and
// no padding is computed.
//
// Numerics.  Distances, centres and the gain update use __fmul_rn /
// __fadd_rn / __fsub_rn so the compiler cannot contract them into FMAs:
// each step rounds exactly like the plain PyTorch version
// (detect/kmeans.py), which evaluates them as separate float32 ops.
// Divisions are IEEE true divisions (the build does not use fast math).
// Per-cluster sums are deterministic: warp w owns clusters m = w, w+8, ...,
// its lanes scan the row in a fixed stride and combine with a fixed
// butterfly of shuffles, in float64, rounded once to float32 (the plain
// version also sums in float64).  No atomics: the same input gives the
// same bits on every launch.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

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

template <int M, bool kFirst>
__global__ void __launch_bounds__(kThreads)
kmeans_kernel(const float* __restrict__ yr_g, const float* __restrict__ yi_g,
              float* __restrict__ h4r, float* __restrict__ h4i, int nsym,
              int iters, int init_idx, Points<M> pts) {
  extern __shared__ float smem[];
  float* syr = smem;
  float* syi = smem + nsym;
  uint8_t* sassign = reinterpret_cast<uint8_t*>(smem + 2 * nsym);

  __shared__ float s_pr[M], s_pi[M];  // constellation
  // cluster centres s_m * hhat during the assignment, then the centroids
  __shared__ float s_cr[M], s_ci[M];
  __shared__ float s_cnt[M], s_cmag[M];
  __shared__ float s_wbest[kWarps];
  __shared__ int s_widx[kWarps];
  __shared__ float s_h[2];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row = blockIdx.x;
  const float* yr = yr_g + row * nsym;
  const float* yi = yi_g + row * nsym;

  for (int m = tid; m < M; m += kThreads) {
    s_pr[m] = pts.re[m];
    s_pi[m] = pts.im[m];
  }

  // --- load the row once; argmax |y|^2, first index on ties ---
  float best = -1.0f;  // |y|^2 >= 0, so any symbol beats it
  int bidx = nsym;
  for (int s = tid; s < nsym; s += kThreads) {
    const float a = yr[s];
    const float b = yi[s];
    syr[s] = a;
    syi[s] = b;
    const float m2 = norm2(a, b);
    if (m2 > best) {  // s increases, so strict > keeps the first
      best = m2;
      bidx = s;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(kFull, best, off);
    const int oi = __shfl_xor_sync(kFull, bidx, off);
    if (ob > best || (ob == best && oi < bidx)) {
      best = ob;
      bidx = oi;
    }
  }
  if (lane == 0) {
    s_wbest[warp] = best;
    s_widx[warp] = bidx;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kWarps; ++w) {
      if (s_wbest[w] > best || (s_wbest[w] == best && s_widx[w] < bidx)) {
        best = s_wbest[w];
        bidx = s_widx[w];
      }
    }
    // bidx == nsym only for nsym == 0, which the wrapper refuses
    float hr, hi;
    cdiv(syr[bidx], syi[bidx], s_pr[init_idx], s_pi[init_idx], &hr, &hi);
    s_h[0] = hr;
    s_h[1] = hi;
  }
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    const float hr = s_h[0];
    const float hi = s_h[1];
    for (int m = tid; m < M; m += kThreads) {
      s_cr[m] = cmul_re(hr, hi, s_pr[m], s_pi[m]);
      s_ci[m] = cmul_im(hr, hi, s_pr[m], s_pi[m]);
    }
    __syncthreads();

    // --- assignment: nearest centre, strict < keeps the first minimum ---
    for (int s = tid; s < nsym; s += kThreads) {
      const float a = syr[s];
      const float b = syi[s];
      float dbest = FLT_MAX;
      int mbest = 0;
      bool any = false;
#pragma unroll 4
      for (int m = 0; m < M; ++m) {
        const float d = norm2(__fsub_rn(a, s_cr[m]), __fsub_rn(b, s_ci[m]));
        if (!any || d < dbest) {
          dbest = d;
          mbest = m;
          any = true;
        }
      }
      sassign[s] = static_cast<uint8_t>(mbest);
    }
    __syncthreads();

    // --- per-cluster counts and sums, fixed order, float64 ---
    for (int m = warp; m < M; m += kWarps) {
      int cnt = 0;
      double sr = 0.0, si = 0.0;
      for (int s = lane; s < nsym; s += 32) {
        if (sassign[s] == m) {
          ++cnt;
          sr += static_cast<double>(syr[s]);
          si += static_cast<double>(syi[s]);
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        cnt += __shfl_xor_sync(kFull, cnt, off);
        sr += __shfl_xor_sync(kFull, sr, off);
        si += __shfl_xor_sync(kFull, si, off);
      }
      if (lane == 0) {
        // centroid (count-0 safe) and its modulus, -1 for an empty cluster
        const float c = static_cast<float>(cnt);
        const float safe = fmaxf(c, 1.0f);
        const float cr = __double2float_rn(sr) / safe;
        const float ci = __double2float_rn(si) / safe;
        s_cnt[m] = c;
        s_cr[m] = cr;
        s_ci[m] = ci;
        s_cmag[m] = c > 0.0f ? norm2(cr, ci) : -1.0f;
      }
    }
    __syncthreads();

    // --- anchor and re-projection ---
    if (tid == 0) {
      int k = 0;
      if (!kFirst) {
        float cbest = s_cmag[0];
        for (int m = 1; m < M; ++m) {
          if (s_cmag[m] > cbest) {  // strict >: first index on ties
            cbest = s_cmag[m];
            k = m;
          }
        }
      }
      if (s_cnt[k] > 0.0f) {  // an empty anchor keeps hhat
        float nr, ni;
        cdiv(s_cr[k], s_ci[k], s_pr[k], s_pi[k], &nr, &ni);
        s_h[0] = nr;
        s_h[1] = ni;
      }
    }
    __syncthreads();
  }

  if (tid == 0) {
    const float hr = s_h[0];
    const float hi = s_h[1];
    float* outr = h4r + row * 4;
    float* outi = h4i + row * 4;
    outr[0] = hr;  outi[0] = hi;   // hhat
    outr[1] = -hi; outi[1] = hr;   // j * hhat
    outr[2] = -hr; outi[2] = -hi;  // -hhat
    outr[3] = hi;  outi[3] = -hr;  // -j * hhat
  }
}

template <int M, bool kFirst>
cudaError_t launch(const float* yr, const float* yi, float* h4r, float* h4i,
                   int batch, int nsym, const float* pts_re,
                   const float* pts_im, int iters, int init_idx,
                   cudaStream_t stream) {
  Points<M> pts;
  for (int m = 0; m < M; ++m) {
    pts.re[m] = pts_re[m];
    pts.im[m] = pts_im[m];
  }
  const size_t smem = static_cast<size_t>(nsym) * (2 * sizeof(float) + 1);
  kmeans_kernel<M, kFirst><<<batch, kThreads, smem, stream>>>(
      yr, yi, h4r, h4i, nsym, iters, init_idx, pts);
  return cudaGetLastError();
}

template <int M>
cudaError_t launch_anchor(bool first, const float* yr, const float* yi,
                          float* h4r, float* h4i, int batch, int nsym,
                          const float* pts_re, const float* pts_im, int iters,
                          int init_idx, cudaStream_t stream) {
  return first ? launch<M, true>(yr, yi, h4r, h4i, batch, nsym, pts_re, pts_im,
                                 iters, init_idx, stream)
               : launch<M, false>(yr, yi, h4r, h4i, batch, nsym, pts_re,
                                  pts_im, iters, init_idx, stream);
}

}  // namespace

// Plain C entry point, bound with ctypes.  Pointers are device pointers
// except pts_re / pts_im (host, M floats each).  Returns the cudaError_t of
// the launch (0 on success); cudaErrorInvalidValue for an M the kernel is
// not instantiated for or a shape it does not take.
extern "C" int kmldpc_kmeans(const float* yr, const float* yi, float* h4r,
                             float* h4i, int batch, int nsym,
                             const float* pts_re, const float* pts_im, int m,
                             int iters, int init_idx, int anchor_first,
                             void* stream) {
  if (batch <= 0 || nsym <= 0 || iters < 0 || init_idx < 0 || init_idx >= m) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(nsym) * (2 * sizeof(float) + 1);
  if (smem > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool first = anchor_first != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 4:
      return launch_anchor<4>(first, yr, yi, h4r, h4i, batch, nsym, pts_re,
                              pts_im, iters, init_idx, s);
    case 16:
      return launch_anchor<16>(first, yr, yi, h4r, h4i, batch, nsym, pts_re,
                               pts_im, iters, init_idx, s);
    case 64:
      return launch_anchor<64>(first, yr, yi, h4r, h4i, batch, nsym, pts_re,
                               pts_im, iters, init_idx, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
