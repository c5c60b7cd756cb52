// Kernel K2: the flooding sum-product decode of a regular LDPC code, one
// thread block per codeword, each codeword for as many iterations as it
// needs.
//
// It replaces no Pallas kernel.  The JAX package decodes with XLA: its
// gathers are not expressible in Mosaic, so its decoder has no kernel.  The
// port's eager decoder (decoder/bp_em.py::_decode_cols_padded, K2's plain
// version) runs some thirty elementwise kernels an iteration, each
// streaming [dr, num_row, B] float32 arrays through device memory, and
// stops only when the whole batch has converged; the two-phase schedule
// re-decodes the slow words in tiles that still run the whole budget.  K2
// computes what that core computes with cn_rule "sumprod" and float32
// messages, iteration by iteration, per codeword of a batch:
//
//   variable nodes: post = llr + sum of the column's dc check messages,
//                   hard = post <= 0;
//   parity:         every row's dr hard bits XOR to 0 -> converged; the
//                   word stops with this iteration's hard decisions and
//                   the previous iteration's soft syndrome (1.0 after one);
//   check nodes:    v2c = post_edge - c2v; Gallager phi of
//                   max(|v2c|, phi_arg_min) (decoder/bp.py::phi, piecewise
//                   at 5.0); the sign product; each edge gets
//                   sign * min(phi(max(phi_sum - phi_own, smallest)), clip)
//                   and the row its soft syndrome
//                   0.5 * (1 + sign_prod * exp(-phi_sum)).
//
// A word that never converges runs iter_count iterations and keeps the last
// check pass's soft syndrome.
//
// What bounds it on Hopper: float32 instruction throughput.  Each
// edge-iteration takes two phi (a logf and a tanhf, or an expf and two
// log1pf) and a few adds, some hundred instructions, against one read of the
// LLRs and one write of the outputs a codeword; the messages never need
// device memory.  The design:
//
// * One block a codeword, grid = B: the scheduler starts a waiting word as
//   soon as any word of the wave converges, after 1 to iter_count
//   iterations, so no word waits on a slower one.
// * The codeword's working set lives in shared memory: c2v [dr * nr] in
//   slot-major order (slot s of row r at s * nr + r, so a warp's rows are
//   conflict-free), the posteriors and channel LLRs [nc] and the soft
//   syndrome [nr], 4 (E + 2 nc + nr) bytes: 50,688 for PEG2304 (four blocks
//   an SM), 177,408 for PEG8064 (one).
// * The graph's two index tables (perm_sm_c2r and row_col_sm of
//   decoder/bp.py, int32) are read from global memory through the
//   read-only path, coalesced, shared by every block.
// * An iteration is three passes split by block barriers: a thread a
//   column sums its checks; a thread a row gathers its posteriors, takes
//   their parity and leaves v2c in place of c2v; the block votes on
//   convergence (__syncthreads_or), and an unconverged word's rows run the
//   check update, keeping each edge's phi in its own slot between the two
//   sweeps of the row.  No host sync, no copy to the host.
// * Device memory sees the LLRs read once and cc_hat, converged, iters and
//   the soft syndrome written once, all batch-major.
//
// Numerics.  IEEE logf, tanhf, expf and log1pf (the build has no fast-math
// flag), the same functions PyTorch's CUDA kernels call, and the same clamps
// and clip.  The column and row sums add into four accumulators, slot k
// into accumulator k % 4, and combine them as ((a0 + a1) + a2) + a3: the
// order PyTorch's CUDA reduction takes over a short leading axis.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 384;  // 12 warps: PEG2304's 1152 rows, 3 a thread
constexpr int kMaxRowDegree = 32;  // a row's signs are one 32-bit mask
constexpr size_t kMaxSmem = 232448;  // 227 KB a block may use on sm_90

struct Clamps {
  float phi_arg_min;  // decoder/bp.py PHI_ARG_MIN
  float smallest;     // constants.SMALLEST_PROB, the floor of phi's exclusion
  float llr_clip;     // constants.LLR_CLIP, the ceiling of a check message
};

// Gallager's phi(x) = -log tanh(x / 2) as decoder/bp.py::phi spells it.
__device__ __forceinline__ float phi(float x) {
  if (x < 5.0f) return -logf(tanhf(x * 0.5f));
  const float e = expf(-x);
  return log1pf(e) - log1pf(-e);
}

// A float32 sum over a node's few slots in the order PyTorch's CUDA
// reduction takes: slot k into accumulator k % 4, then ((a0 + a1) + a2) + a3.
struct Sum4 {
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  __device__ __forceinline__ void add(int k, float x) {
    switch (k & 3) {
      case 0: a0 += x; break;
      case 1: a1 += x; break;
      case 2: a2 += x; break;
      default: a3 += x; break;
    }
  }
  __device__ __forceinline__ float total() const { return ((a0 + a1) + a2) + a3; }
};

size_t smem_bytes(int nc, int nr, int dr) {
  return sizeof(float) * (static_cast<size_t>(dr) * nr + 2 * static_cast<size_t>(nc) + nr);
}

__global__ void __launch_bounds__(kThreads)
bp_flood_kernel(const float* __restrict__ llr_g, const int* __restrict__ perm,
                const int* __restrict__ row_col, int8_t* __restrict__ cc_hat,
                uint8_t* __restrict__ converged, int* __restrict__ iters_out,
                float* __restrict__ ss_out, int nc, int nr, int dc, int dr, int punct,
                int iter_count, Clamps cl) {
  extern __shared__ __align__(16) float smem[];
  float* c2v = smem;            // [dr * nr], slot-major
  float* post = c2v + dr * nr;  // [nc]
  float* llr = post + nc;       // [nc]
  float* ss = llr + nc;         // [nr]
  const int tid = threadIdx.x;
  const int step = blockDim.x;
  const size_t word = blockIdx.x;

  const float* in = llr_g + word * (nc - punct);
  for (int j = tid; j < nc; j += step) llr[j] = j < punct ? 0.0f : in[j - punct];
  for (int e = tid; e < dr * nr; e += step) c2v[e] = 0.0f;
  for (int r = tid; r < nr; r += step) ss[r] = 1.0f;
  __syncthreads();

  int it = 0;
  bool done = false;
  while (it < iter_count) {
    // variable nodes: a thread a column
    for (int j = tid; j < nc; j += step) {
      Sum4 s;
      for (int k = 0; k < dc; ++k) s.add(k, c2v[__ldg(perm + k * nc + j)]);
      post[j] = llr[j] + s.total();
    }
    __syncthreads();
    ++it;
    // parity of the hard decisions, and v2c in place of c2v: a thread a row
    int odd = 0;
    for (int r = tid; r < nr; r += step) {
      int p = 0;
      for (int s = 0; s < dr; ++s) {
        const int e = s * nr + r;
        const float pe = post[__ldg(row_col + e)];
        p ^= pe <= 0.0f;
        c2v[e] = pe - c2v[e];
      }
      odd |= p;
    }
    if (!__syncthreads_or(odd)) {
      done = true;
      break;
    }
    // check nodes: phi of each v2c kept in its slot, then the exclusions
    for (int r = tid; r < nr; r += step) {
      Sum4 s;
      unsigned neg = 0;
      for (int k = 0; k < dr; ++k) {
        const int e = k * nr + r;
        const float v = c2v[e];
        neg |= static_cast<unsigned>(v < 0.0f) << k;
        const float ph = phi(fmaxf(fabsf(v), cl.phi_arg_min));
        s.add(k, ph);
        c2v[e] = ph;
      }
      const float phi_sum = s.total();
      const float sign_prod = (__popc(neg) & 1) ? -1.0f : 1.0f;
      for (int k = 0; k < dr; ++k) {
        const int e = k * nr + r;
        const float mag = fminf(phi(fmaxf(phi_sum - c2v[e], cl.smallest)), cl.llr_clip);
        c2v[e] = ((neg >> k) & 1u) ? -sign_prod * mag : sign_prod * mag;
      }
      // sign_prod * exp(...) is exact, so a contraction into an fma rounds alike
      ss[r] = 0.5f * (1.0f + sign_prod * expf(-phi_sum));
    }
    __syncthreads();
  }

  // the last iteration's hard decisions (none before the first iteration)
  int8_t* hard = cc_hat + word * nc;
  for (int j = tid; j < nc; j += step) hard[j] = it > 0 && post[j] <= 0.0f;
  float* out = ss_out + word * nr;
  for (int r = tid; r < nr; r += step) out[r] = ss[r];
  if (tid == 0) {
    converged[word] = done;
    iters_out[word] = it;
  }
}

cudaError_t prepare(int nc, int nr, int dc, int dr, int punct, size_t* smem) {
  if (nc <= 0 || nr <= 0 || dc <= 0 || dr <= 0 || dr > kMaxRowDegree || punct < 0 ||
      punct >= nc || static_cast<long long>(dc) * nc != static_cast<long long>(dr) * nr) {
    return cudaErrorInvalidValue;
  }
  *smem = smem_bytes(nc, nr, dr);
  if (*smem > kMaxSmem) return cudaErrorInvalidValue;
  if (*smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(bp_flood_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

}  // namespace

// Codewords of a (nc, nr, dc, dr) code that one SM holds at once, by the
// CUDA runtime's occupancy calculator: what the kernel's registers and
// shared memory leave room for.  Returns a cudaError_t as kmldpc_bp_flood
// does.
extern "C" int kmldpc_bp_flood_words_per_sm(int nc, int nr, int dc, int dr, int* words) {
  size_t smem = 0;
  const cudaError_t e = prepare(nc, nr, dc, dr, 0, &smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(words, bp_flood_kernel, kThreads, smem));
}

// Plain C entry point, bound with ctypes.  Device pointers: llr [B, nc -
// punct] float32 (the transmitted columns; the first punct columns take LLR
// 0), perm [dc * nc] and row_col [dr * nr] int32, and the outputs cc_hat [B,
// nc] int8, converged [B] (one byte, 0 or 1), iters [B] int32 and
// soft_syndrome [B, nr] float32.  Returns the cudaError_t of the launch (0
// on success); cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int kmldpc_bp_flood(const float* llr, const int* perm, const int* row_col,
                               int8_t* cc_hat, uint8_t* converged, int* iters,
                               float* soft_syndrome, int batch, int nc, int nr, int dc, int dr,
                               int punct, int iter_count, float phi_arg_min, float smallest,
                               float llr_clip, void* stream) {
  if (batch <= 0 || iter_count < 0) return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  const cudaError_t e = prepare(nc, nr, dc, dr, punct, &smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  bp_flood_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      llr, perm, row_col, cc_hat, converged, iters, soft_syndrome, nc, nr, dc, dr, punct,
      iter_count, Clamps{phi_arg_min, smallest, llr_clip});
  return static_cast<int>(cudaGetLastError());
}

// Kernel K3: the flooding sum-product decode of an irregular LDPC code (the
// 5G NR base graphs), one thread block per codeword, each codeword for as
// many iterations as it needs.
//
// It replaces no Pallas kernel, for K2's reason: the JAX package decodes
// with XLA.  Its plain version is the port's degree-class core
// (decoder/bp_em.py::_decode_cols_classes with cn_rule "sumprod" and float32
// messages), which runs a few elementwise kernels per degree class an
// iteration over [d * n, B] float32 arrays in device memory and stops only
// when the whole batch has converged, so the two-phase schedule re-decodes
// the slow words in tiles that run the whole budget.  K3 computes what that
// core computes, iteration by iteration, per codeword, with K2's rule,
// freezing and early stop (see K2's note above).  A codeword of the 5G code
// BG2, Z = 96 has 2,112 columns (the first 192 punctured: LLR 0), 1,152
// rows and 7,392 edges in 7 column and 5 row degree classes.
//
// What bounds it on Hopper: as K2, float32 instruction throughput, two phi
// an edge-iteration against one read of the LLRs and one write of the
// outputs a codeword.  The design is K2's, on the degree-class layout the
// plain core uses, so that each node adds its slots in the same order:
//
// * Columns and rows are sorted ascending by degree (decoder/bp.py's
//   class_tables).  A degree class (d, n) of rows owns the contiguous span
//   [off, off + d * n) of the row-flat c2v, slot s of its i-th row at
//   off + s * n + i (the plain core's reshape(d, n, B)); the column side
//   alike in the column-flat order that perm_cf_c2r maps onto it.
// * Shared memory holds c2v [E], the sorted posteriors and LLRs [nc] and
//   the soft syndrome [nr]: 4 (E + 2 nc + nr) bytes, 51,072 for BG2 Z = 96
//   (four codewords an SM), and the two sides' class descriptors.
// * A thread takes sorted columns tid, tid + 384, ...; the class of each
//   is found by walking the descriptors forward.  Where every class
//   boundary is a multiple of 32, as all of BG2 Z = 96's are, no warp
//   straddles two degrees and the walk and the slot loops are
//   warp-uniform.  Rows likewise.
// * The four index tables (perm_cf_c2r and row_col_cf [E], col_sort and
//   col_unsort [nc], row_unsort [nr], int32) are read through the
//   read-only path, shared by every block.  The LLRs come in through
//   col_sort (punctured columns take 0), hard decisions go out in the
//   original column order through col_unsort and the soft syndrome in the
//   original row order through row_unsort.

namespace {

constexpr int kMaxClasses = 16;  // degree classes a side may have

// One side's degree classes, ascending by degree: class c holds the sorted
// nodes [first[c], first[c + 1]) of degree deg[c], whose edge slots start at
// off[c] of the flat edge array.
struct Classes {
  int deg[kMaxClasses];
  int first[kMaxClasses + 1];
  int off[kMaxClasses];
};

// The class of sorted node j, walking forward from class c (j never falls).
__device__ __forceinline__ int class_of(const Classes& k, int j, int c) {
  while (j >= k.first[c + 1]) ++c;
  return c;
}

__global__ void __launch_bounds__(kThreads)
bp_classes_kernel(const float* __restrict__ llr_g, const int* __restrict__ perm,
                  const int* __restrict__ row_col, const int* __restrict__ col_sort,
                  const int* __restrict__ col_unsort, const int* __restrict__ row_unsort,
                  int8_t* __restrict__ cc_hat, uint8_t* __restrict__ converged,
                  int* __restrict__ iters_out, float* __restrict__ ss_out, int nc, int nr,
                  int ne, int punct, int iter_count, Classes cols_g, Classes rows_g,
                  Clamps cl) {
  extern __shared__ __align__(16) float smem[];
  __shared__ Classes cols, rows;
  float* c2v = smem;        // [ne], row-flat by class
  float* post = c2v + ne;   // [nc], degree-sorted
  float* llr = post + nc;   // [nc], degree-sorted
  float* ss = llr + nc;     // [nr], degree-sorted
  const int tid = threadIdx.x;
  const int step = blockDim.x;
  const size_t word = blockIdx.x;

  if (tid == 0) {
    cols = cols_g;
    rows = rows_g;
  }
  const float* in = llr_g + word * (nc - punct);
  for (int j = tid; j < nc; j += step) {
    const int col = __ldg(col_sort + j);
    llr[j] = col < punct ? 0.0f : in[col - punct];
  }
  for (int e = tid; e < ne; e += step) c2v[e] = 0.0f;
  for (int r = tid; r < nr; r += step) ss[r] = 1.0f;
  __syncthreads();

  int it = 0;
  bool done = false;
  while (it < iter_count) {
    // variable nodes: a thread a sorted column
    for (int j = tid, c = 0; j < nc; j += step) {
      c = class_of(cols, j, c);
      const int n = cols.first[c + 1] - cols.first[c];
      const int* p = perm + cols.off[c] + (j - cols.first[c]);
      Sum4 s;
      for (int k = 0; k < cols.deg[c]; ++k) s.add(k, c2v[__ldg(p + k * n)]);
      post[j] = llr[j] + s.total();
    }
    __syncthreads();
    ++it;
    // parity of the hard decisions, and v2c in place of c2v: a thread a row
    int odd = 0;
    for (int r = tid, c = 0; r < nr; r += step) {
      c = class_of(rows, r, c);
      const int n = rows.first[c + 1] - rows.first[c];
      const int e0 = rows.off[c] + (r - rows.first[c]);
      int p = 0;
      for (int s = 0; s < rows.deg[c]; ++s) {
        const int e = e0 + s * n;
        const float pe = post[__ldg(row_col + e)];
        p ^= pe <= 0.0f;
        c2v[e] = pe - c2v[e];
      }
      odd |= p;
    }
    if (!__syncthreads_or(odd)) {
      done = true;
      break;
    }
    // check nodes: phi of each v2c kept in its slot, then the exclusions
    for (int r = tid, c = 0; r < nr; r += step) {
      c = class_of(rows, r, c);
      const int d = rows.deg[c];
      const int n = rows.first[c + 1] - rows.first[c];
      const int e0 = rows.off[c] + (r - rows.first[c]);
      Sum4 s;
      unsigned neg = 0;
      for (int k = 0; k < d; ++k) {
        const int e = e0 + k * n;
        const float v = c2v[e];
        neg |= static_cast<unsigned>(v < 0.0f) << k;
        const float ph = phi(fmaxf(fabsf(v), cl.phi_arg_min));
        s.add(k, ph);
        c2v[e] = ph;
      }
      const float phi_sum = s.total();
      const float sign_prod = (__popc(neg) & 1) ? -1.0f : 1.0f;
      for (int k = 0; k < d; ++k) {
        const int e = e0 + k * n;
        const float mag = fminf(phi(fmaxf(phi_sum - c2v[e], cl.smallest)), cl.llr_clip);
        c2v[e] = ((neg >> k) & 1u) ? -sign_prod * mag : sign_prod * mag;
      }
      ss[r] = 0.5f * (1.0f + sign_prod * expf(-phi_sum));
    }
    __syncthreads();
  }

  // the last iteration's hard decisions (none before the first iteration)
  // and the soft syndrome, both in the graph's own node order
  int8_t* hard = cc_hat + word * nc;
  for (int i = tid; i < nc; i += step) hard[i] = it > 0 && post[__ldg(col_unsort + i)] <= 0.0f;
  float* out = ss_out + word * nr;
  for (int r = tid; r < nr; r += step) out[r] = ss[__ldg(row_unsort + r)];
  if (tid == 0) {
    converged[word] = done;
    iters_out[word] = it;
  }
}

// One side's descriptors from its classes' degrees and node counts (host
// arrays, ascending by degree); false for more classes than kMaxClasses, a
// class with no node, degrees not strictly ascending, or a degree above
// max_degree.  *nodes and *edges get the side's totals.
bool make_classes(const int* deg, const int* count, int n, int max_degree, Classes* k,
                  int* nodes, long long* edges) {
  if (n <= 0 || n > kMaxClasses) return false;
  k->first[0] = 0;
  long long e = 0;
  for (int c = 0; c < n; ++c) {
    if (count[c] <= 0 || deg[c] <= 0 || deg[c] > max_degree || (c && deg[c] <= deg[c - 1])) {
      return false;
    }
    k->deg[c] = deg[c];
    k->off[c] = static_cast<int>(e);
    k->first[c + 1] = k->first[c] + count[c];
    e += static_cast<long long>(deg[c]) * count[c];
  }
  *nodes = k->first[n];
  *edges = e;
  return true;
}

// Validates a code's classes and sets the kernel's dynamic shared memory;
// fills both sides' descriptors and the bytes a block takes.
cudaError_t prepare_classes(int nc, int nr, int punct, const int* col_deg,
                            const int* col_count, int n_col, const int* row_deg,
                            const int* row_count, int n_row, Classes* cols, Classes* rows,
                            int* ne, size_t* smem) {
  int c_nodes = 0, r_nodes = 0;
  long long c_edges = 0, r_edges = 0;
  if (!make_classes(col_deg, col_count, n_col, nr, cols, &c_nodes, &c_edges) ||
      !make_classes(row_deg, row_count, n_row, kMaxRowDegree, rows, &r_nodes, &r_edges) ||
      c_nodes != nc || r_nodes != nr || c_edges != r_edges || punct < 0 || punct >= nc ||
      c_edges > (1 << 24)) {
    return cudaErrorInvalidValue;
  }
  *ne = static_cast<int>(c_edges);
  *smem = sizeof(float) * (static_cast<size_t>(*ne) + 2 * static_cast<size_t>(nc) + nr);
  if (*smem + 2 * sizeof(Classes) > kMaxSmem) return cudaErrorInvalidValue;
  if (*smem + 2 * sizeof(Classes) <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(bp_classes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

}  // namespace

// Codewords of an irregular code that one SM holds at once, by the CUDA
// runtime's occupancy calculator, and the registers a thread of K3 takes;
// the classes as kmldpc_bp_flood_classes takes them.  Returns a cudaError_t.
extern "C" int kmldpc_bp_flood_classes_words_per_sm(int nc, int nr, const int* col_deg,
                                                    const int* col_count, int n_col,
                                                    const int* row_deg, const int* row_count,
                                                    int n_row, int* words, int* regs) {
  Classes cols{}, rows{};
  int ne = 0;
  size_t smem = 0;
  cudaError_t e = prepare_classes(nc, nr, 0, col_deg, col_count, n_col, row_deg, row_count,
                                  n_row, &cols, &rows, &ne, &smem);
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, bp_classes_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = attr.numRegs;
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(words, bp_classes_kernel, kThreads, smem));
}

// Plain C entry point of K3, bound with ctypes.  Device pointers: llr [B, nc
// - punct] float32 (the transmitted columns; the first punct columns take
// LLR 0), perm_cf_c2r and row_col_cf [E], col_sort and col_unsort [nc] and
// row_unsort [nr] int32, and the outputs as kmldpc_bp_flood's.  Host
// pointers: each side's class degrees (strictly ascending) and node counts,
// n_col and n_row classes.  Returns the cudaError_t of the launch (0 on
// success); cudaErrorInvalidValue for a code the kernel does not take.
extern "C" int kmldpc_bp_flood_classes(const float* llr, const int* perm, const int* row_col,
                                       const int* col_sort, const int* col_unsort,
                                       const int* row_unsort, int8_t* cc_hat,
                                       uint8_t* converged, int* iters, float* soft_syndrome,
                                       int batch, int nc, int nr, int punct, const int* col_deg,
                                       const int* col_count, int n_col, const int* row_deg,
                                       const int* row_count, int n_row, int iter_count,
                                       float phi_arg_min, float smallest, float llr_clip,
                                       void* stream) {
  if (batch <= 0 || iter_count < 0) return static_cast<int>(cudaErrorInvalidValue);
  Classes cols{}, rows{};  // classes past the code's stay zero, never read
  int ne = 0;
  size_t smem = 0;
  const cudaError_t e = prepare_classes(nc, nr, punct, col_deg, col_count, n_col, row_deg,
                                        row_count, n_row, &cols, &rows, &ne, &smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  bp_classes_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      llr, perm, row_col, col_sort, col_unsort, row_unsort, cc_hat, converged, iters,
      soft_syndrome, nc, nr, ne, punct, iter_count, cols, rows,
      Clamps{phi_arg_min, smallest, llr_clip});
  return static_cast<int>(cudaGetLastError());
}
