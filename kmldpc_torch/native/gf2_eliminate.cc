// Native GF(2) Gaussian elimination for LDPC systematization.
//
// Copy of kmldpc_tpu/native/gf2_eliminate.cc kept by the port.  Semantics are
// identical to kmldpc_torch/code/gf2.py (which replicates the reference's
// SystemMatrixH pivoting: binaryldpccodec.cc:346-492 forward,
// binary5gldpccodec.cc:240-391 reverse) — the Python module is the oracle,
// this is the fast path used at code-compile time.  Bit-packed rows
// (uint64), row-XOR elimination, column swaps tracked in a permutation.
//
// C ABI only; built with g++ and loaded via ctypes (gf2_native.py).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Packed {
  int rows, cols, words;
  std::vector<uint64_t> data;  // rows * words

  uint64_t* row(int r) { return data.data() + static_cast<size_t>(r) * words; }

  int get(int r, int c) const {
    const uint64_t w = data[static_cast<size_t>(r) * words + (c >> 6)];
    return static_cast<int>((w >> (c & 63)) & 1u);
  }

  void set(int r, int c, int v) {
    uint64_t& w = data[static_cast<size_t>(r) * words + (c >> 6)];
    const uint64_t m = 1ull << (c & 63);
    w = v ? (w | m) : (w & ~m);
  }
};

void pack(const uint8_t* h, int rows, int cols, Packed& p) {
  p.rows = rows;
  p.cols = cols;
  p.words = (cols + 63) / 64;
  p.data.assign(static_cast<size_t>(rows) * p.words, 0);
  for (int r = 0; r < rows; ++r) {
    const uint8_t* src = h + static_cast<size_t>(r) * cols;
    uint64_t* dst = p.row(r);
    for (int c = 0; c < cols; ++c) {
      if (src[c]) dst[c >> 6] |= 1ull << (c & 63);
    }
  }
}

void swap_rows(Packed& p, int r1, int r2) {
  if (r1 == r2) return;
  uint64_t* a = p.row(r1);
  uint64_t* b = p.row(r2);
  for (int w = 0; w < p.words; ++w) std::swap(a[w], b[w]);
}

void swap_cols(Packed& p, int c1, int c2) {
  if (c1 == c2) return;
  for (int r = 0; r < p.rows; ++r) {
    const int b1 = p.get(r, c1);
    const int b2 = p.get(r, c2);
    p.set(r, c1, b2);
    p.set(r, c2, b1);
  }
}

// XOR pivot row into every other row with a 1 in pivot_col.
void eliminate(Packed& p, int pivot_row, int pivot_col) {
  const uint64_t* pr = p.row(pivot_row);
  const int wc = pivot_col >> 6;
  const uint64_t mask = 1ull << (pivot_col & 63);
  for (int r = 0; r < p.rows; ++r) {
    if (r == pivot_row) continue;
    uint64_t* row = p.row(r);
    if (row[wc] & mask) {
      for (int w = 0; w < p.words; ++w) row[w] ^= pr[w];
    }
  }
}

}  // namespace

extern "C" {

// Returns the rank (# pivots).  enc_out: rows*cols uint8 (dense eliminated
// matrix); perm_out: cols int64 (tempP — new column j = original perm[j]).
int gf2_systematize(const uint8_t* h, int rows, int cols, int reverse,
                    uint8_t* enc_out, int64_t* perm_out) {
  Packed p;
  pack(h, rows, cols, p);
  for (int j = 0; j < cols; ++j) perm_out[j] = j;
  int rank = 0;

  if (!reverse) {
    // classic/forward (binaryldpccodec.cc:381-433): pivot i scans columns
    // jj = i..cols-1 for the first with a nonzero in rows i..rows-1, taking
    // the smallest such row.
    for (int i = 0; i < rows; ++i) {
      int jj = -1, ii = -1;
      for (int j = i; j < cols && jj < 0; ++j) {
        for (int r = i; r < rows; ++r) {
          if (p.get(r, j)) { jj = j; ii = r; break; }
        }
      }
      if (jj < 0) break;
      ++rank;
      swap_rows(p, i, ii);
      if (jj != i) {
        std::swap(perm_out[i], perm_out[jj]);
        swap_cols(p, i, jj);
      }
      eliminate(p, i, i);
    }
  } else {
    // 5G/reverse (binary5gldpccodec.cc:281-335): pivot i = rows-1..0 at
    // target column i + cols - rows, scanning columns downward and rows
    // downward from i (largest row index <= i wins).
    const int off = cols - rows;
    for (int i = rows - 1; i >= 0; --i) {
      const int target = i + off;
      int jj = -1, ii = -1;
      for (int j = target; j >= 0 && jj < 0; --j) {
        for (int r = i; r >= 0; --r) {
          if (p.get(r, j)) { jj = j; ii = r; break; }
        }
      }
      if (jj < 0) break;
      ++rank;
      swap_rows(p, i, ii);
      if (jj != target) {
        std::swap(perm_out[target], perm_out[jj]);
        swap_cols(p, target, jj);
      }
      eliminate(p, i, target);
    }
  }

  // unpack
  for (int r = 0; r < rows; ++r) {
    uint8_t* dst = enc_out + static_cast<size_t>(r) * cols;
    for (int c = 0; c < cols; ++c) dst[c] = static_cast<uint8_t>(p.get(r, c));
  }
  return rank;
}

}  // extern "C"
