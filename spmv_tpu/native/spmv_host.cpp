// libspmv_host — native host-side tier of spmv_tpu.
//
// The reference implements its loader and assembly hot paths in C++
// (reference spmv/read_petsc.cpp: per-value byte swaps + seeks;
// reference spmv/Matrix.cpp:226-318: ghost-row redistribution/renumbering).
// spmv_tpu keeps the device compute path in JAX and puts the host-side
// heavy lifting here: PETSc binary parsing (big-endian, mmap'd, swapped with
// a vectorizable loop) and CSR->padded-ELL packing. Exposed over a plain C
// ABI for ctypes (no pybind11 dependency).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC spmv_host.cpp -o libspmv_host.so
// (spmv_tpu.native.lib compiles lazily on first use and caches the .so
// under build/native/, keyed on source, flags and architecture).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>
#include <utility>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <malloc.h>
#include <climits>

namespace {

// This host's dominant "cost" for big fresh allocations is first-touch
// page-fault servicing (BENCH_NOTES "first-touch fault regime": 0.03-0.4
// GB/s on cold pages). Keep large blocks on the glibc heap and never trim,
// so scratch buffers (SpGEMM accumulators, from_coo key arrays, numpy
// temporaries — mallopt is process-wide) REUSE warm pages across calls.
struct MallocTuner {
  MallocTuner() {
    mallopt(M_MMAP_THRESHOLD, INT_MAX);
    mallopt(M_TRIM_THRESHOLD, INT_MAX);
  }
} g_malloc_tuner;

}  // namespace

namespace {

constexpr int32_t kMatClassId = 1211216;
constexpr int32_t kVecClassId = 1211214;

inline int32_t bswap32(int32_t v) {
  return __builtin_bswap32(static_cast<uint32_t>(v));
}
inline double bswap64d(double v) {
  uint64_t u;
  std::memcpy(&u, &v, 8);
  u = __builtin_bswap64(u);
  std::memcpy(&v, &u, 8);
  return v;
}

struct MappedFile {
  const uint8_t* data = nullptr;
  size_t size = 0;
  int fd = -1;
  bool ok() const { return data != nullptr; }
};

MappedFile map_file(const char* path) {
  MappedFile m;
  m.fd = open(path, O_RDONLY);
  if (m.fd < 0) return m;
  struct stat st;
  if (fstat(m.fd, &st) != 0) {
    close(m.fd);
    m.fd = -1;
    return m;
  }
  m.size = static_cast<size_t>(st.st_size);
  void* p = mmap(nullptr, m.size, PROT_READ, MAP_PRIVATE, m.fd, 0);
  if (p == MAP_FAILED) {
    close(m.fd);
    m.fd = -1;
    return m;
  }
  m.data = static_cast<const uint8_t*>(p);
  return m;
}

void unmap(MappedFile& m) {
  if (m.data) munmap(const_cast<uint8_t*>(reinterpret_cast<const uint8_t*>(m.data)), m.size);
  if (m.fd >= 0) close(m.fd);
  m.data = nullptr;
  m.fd = -1;
}

}  // namespace

extern "C" {

// Parse header: returns 0 on success; fills nrows/ncols/nnz.
// Error codes: -1 open/map failed, -2 bad magic, -3 truncated.
int spmv_petsc_matrix_header(const char* path, int64_t* nrows, int64_t* ncols,
                             int64_t* nnz) {
  MappedFile m = map_file(path);
  if (!m.ok()) return -1;
  int rc = 0;
  if (m.size < 16) {
    rc = -3;
  } else {
    const int32_t* h = reinterpret_cast<const int32_t*>(m.data);
    if (bswap32(h[0]) != kMatClassId) {
      rc = -2;
    } else {
      *nrows = bswap32(h[1]);
      *ncols = bswap32(h[2]);
      *nnz = bswap32(h[3]);
      size_t need = 16 + static_cast<size_t>(*nrows) * 4 +
                    static_cast<size_t>(*nnz) * 12;
      if (m.size < need) rc = -3;
    }
  }
  unmap(m);
  return rc;
}

// Read rows [row0, row1): fills rowptr (row1-row0+1, int64), colind (int32),
// values (double). colind/values must have capacity for the slice nnz, which
// the caller gets from a first call with colind == nullptr (returned via
// *slice_nnz). Returns 0 on success.
int spmv_petsc_matrix_read_slice(const char* path, int64_t row0, int64_t row1,
                                 int64_t* rowptr, int32_t* colind,
                                 double* values, int64_t* slice_nnz) {
  MappedFile m = map_file(path);
  if (!m.ok()) return -1;
  int rc = 0;
  do {
    if (m.size < 16) { rc = -3; break; }
    const int32_t* h = reinterpret_cast<const int32_t*>(m.data);
    if (bswap32(h[0]) != kMatClassId) { rc = -2; break; }
    const int64_t nrows = bswap32(h[1]);
    const int64_t nnz = bswap32(h[3]);
    if (row0 < 0 || row1 < row0 || row1 > nrows) { rc = -4; break; }
    const int32_t* row_nnz = h + 4;
    // prefix-sum to the slice's file offsets (reference read_petsc.cpp:109-124)
    int64_t lo = 0;
    for (int64_t r = 0; r < row0; ++r) lo += bswap32(row_nnz[r]);
    int64_t acc = lo;
    rowptr[0] = 0;
    for (int64_t r = row0; r < row1; ++r) {
      acc += bswap32(row_nnz[r]);
      rowptr[r - row0 + 1] = acc - lo;
    }
    const int64_t cnt = acc - lo;
    *slice_nnz = cnt;
    if (colind == nullptr) break;  // size query only
    size_t col_off = 16 + static_cast<size_t>(nrows) * 4;
    size_t val_off = col_off + static_cast<size_t>(nnz) * 4;
    if (m.size < val_off + static_cast<size_t>(nnz) * 8) { rc = -3; break; }
    const int32_t* cols =
        reinterpret_cast<const int32_t*>(m.data + col_off) + lo;
    const double* vals =
        reinterpret_cast<const double*>(m.data + val_off) + lo;
    for (int64_t i = 0; i < cnt; ++i) colind[i] = bswap32(cols[i]);
    for (int64_t i = 0; i < cnt; ++i) values[i] = bswap64d(vals[i]);
  } while (false);
  unmap(m);
  return rc;
}

int spmv_petsc_vector_header(const char* path, int64_t* n) {
  MappedFile m = map_file(path);
  if (!m.ok()) return -1;
  int rc = 0;
  if (m.size < 8) {
    rc = -3;
  } else {
    const int32_t* h = reinterpret_cast<const int32_t*>(m.data);
    if (bswap32(h[0]) != kVecClassId) rc = -2;
    else *n = bswap32(h[1]);
  }
  unmap(m);
  return rc;
}

int spmv_petsc_vector_read(const char* path, int64_t i0, int64_t i1,
                           double* out) {
  MappedFile m = map_file(path);
  if (!m.ok()) return -1;
  int rc = 0;
  do {
    if (m.size < 8) { rc = -3; break; }
    const int32_t* h = reinterpret_cast<const int32_t*>(m.data);
    if (bswap32(h[0]) != kVecClassId) { rc = -2; break; }
    const int64_t n = bswap32(h[1]);
    if (i0 < 0 || i1 < i0 || i1 > n) { rc = -4; break; }
    if (m.size < 8 + static_cast<size_t>(n) * 8) { rc = -3; break; }
    const double* vals = reinterpret_cast<const double*>(m.data + 8) + i0;
    for (int64_t i = 0; i < i1 - i0; ++i) out[i] = bswap64d(vals[i]);
  } while (false);
  unmap(m);
  return rc;
}

// ---------------------------------------------------------------------------
// CSR -> DIA assembly (the csr_to_dia hot path; replaces the numpy
// unique/searchsorted/bincount passes, which sort nnz-sized arrays).
// Two single-pass functions over the CSR arrays:
//   spmv_dia_scan  — distinct diagonal offsets WITHOUT sorting (small sorted
//                    insert table, <= max_track entries) + kept-entry count;
//   spmv_dia_pack  — accumulate values into the (ndiags, nrows_pad) planes
//                    via an offset->plane lookup table (duplicates sum,
//                    matching CSR semantics).
// ---------------------------------------------------------------------------

// Returns 0 on success, -4 if more than max_track distinct offsets exist.
// lower_only != 0 keeps only offsets <= 0 (symmetric lower-triangle storage,
// reference spmv/Matrix.cpp:337-349 semantics). offsets_out must have
// capacity max_track; filled ascending. *nnz_kept = number of kept entries.
int spmv_dia_scan(const int64_t* rowptr, const int32_t* colind, int64_t nrows,
                  int32_t lower_only, int64_t max_track, int64_t* offsets_out,
                  int64_t* ndiags_out, int64_t* nnz_kept) {
  int64_t nd = 0;
  int64_t kept = 0;
  for (int64_t r = 0; r < nrows; ++r) {
    const int64_t lo = rowptr[r], hi = rowptr[r + 1];
    for (int64_t i = lo; i < hi; ++i) {
      const int64_t off = static_cast<int64_t>(colind[i]) - r;
      if (lower_only && off > 0) continue;
      ++kept;
      // binary search in the (tiny, L1-resident) sorted table
      int64_t a = 0, b = nd;
      while (a < b) {
        const int64_t mid = (a + b) / 2;
        if (offsets_out[mid] < off) a = mid + 1;
        else b = mid;
      }
      if (a < nd && offsets_out[a] == off) continue;
      if (nd == max_track) return -4;
      std::memmove(offsets_out + a + 1, offsets_out + a,
                   static_cast<size_t>(nd - a) * sizeof(int64_t));
      offsets_out[a] = off;
      ++nd;
    }
  }
  *ndiags_out = nd;
  *nnz_kept = kept;
  return 0;
}

}  // extern "C" (template below needs C++ linkage)

namespace {

template <typename T>
int dia_pack_impl(const int64_t* rowptr, const int32_t* colind,
                  const T* values, int64_t nrows, int64_t nrows_pad,
                  int32_t lower_only, int32_t interleaved,
                  const int64_t* offsets, int64_t ndiags, T* data) {
  if (ndiags <= 0) return 0;
  const int64_t omin = offsets[0], omax = offsets[ndiags - 1];
  const int64_t range = omax - omin + 1;
  // offset -> plane lookup table when the band is narrow enough; binary
  // search fallback for extreme spreads (range can reach ~2*nrows)
  constexpr int64_t kLutCap = int64_t(1) << 24;
  int16_t* lut = nullptr;
  if (range <= kLutCap && ndiags <= 32766) {
    lut = new int16_t[range];
    std::memset(lut, 0xff, static_cast<size_t>(range) * sizeof(int16_t));
    for (int64_t d = 0; d < ndiags; ++d)
      lut[offsets[d] - omin] = static_cast<int16_t>(d);
  }
  int rc = 0;
  for (int64_t r = 0; r < nrows && rc == 0; ++r) {
    const int64_t lo = rowptr[r], hi = rowptr[r + 1];
    for (int64_t i = lo; i < hi; ++i) {
      const int64_t off = static_cast<int64_t>(colind[i]) - r;
      if (lower_only && off > 0) continue;
      int64_t d;
      if (lut != nullptr) {
        if (off < omin || off > omax || lut[off - omin] < 0) { rc = -5; break; }
        d = lut[off - omin];
      } else {
        int64_t a = 0, b = ndiags;
        while (a < b) {
          const int64_t mid = (a + b) / 2;
          if (offsets[mid] < off) a = mid + 1;
          else b = mid;
        }
        if (a >= ndiags || offsets[a] != off) { rc = -5; break; }
        d = a;
      }
      // interleaved: the DiaMatrix device layout (nrows_pad/128, ndiags*128)
      // written directly — skips the flat->interleaved numpy transpose pass
      const int64_t idx = interleaved
          ? ((r >> 7) * ndiags + d) * 128 + (r & 127)
          : d * nrows_pad + r;
      data[idx] += values[i];
    }
  }
  delete[] lut;
  return rc;
}

}  // namespace

extern "C" {

// data must be pre-zeroed (ndiags, nrows_pad) in the matching dtype.
// Returns 0 on success, -5 if an entry's offset is not in offsets[].
int spmv_dia_pack_f64(const int64_t* rowptr, const int32_t* colind,
                      const double* values, int64_t nrows, int64_t nrows_pad,
                      int32_t lower_only, int32_t interleaved,
                      const int64_t* offsets, int64_t ndiags, double* data) {
  return dia_pack_impl(rowptr, colind, values, nrows, nrows_pad, lower_only,
                       interleaved, offsets, ndiags, data);
}

int spmv_dia_pack_f32(const int64_t* rowptr, const int32_t* colind,
                      const float* values, int64_t nrows, int64_t nrows_pad,
                      int32_t lower_only, int32_t interleaved,
                      const int64_t* offsets, int64_t ndiags, float* data) {
  return dia_pack_impl(rowptr, colind, values, nrows, nrows_pad, lower_only,
                       interleaved, offsets, ndiags, data);
}

// Pack a CSR slice into padded ELL rectangles (row-major (nrows_pad, k)).
// Padded slots must be pre-zeroed by the caller (calloc'd numpy arrays).
int spmv_pack_ell(const int64_t* rowptr, const int32_t* colind,
                  const double* values, int64_t nrows, int64_t nrows_pad,
                  int64_t k, int32_t* ell_colind, double* ell_values) {
  (void)nrows_pad;
  for (int64_t r = 0; r < nrows; ++r) {
    const int64_t lo = rowptr[r], hi = rowptr[r + 1];
    if (hi - lo > k) return -4;
    int32_t* cr = ell_colind + r * k;
    double* vr = ell_values + r * k;
    for (int64_t i = lo; i < hi; ++i) {
      cr[i - lo] = colind[i];
      vr[i - lo] = values[i];
    }
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// CSR -> WELL assembly (formats/well.py _pack/_build_arrays hot path;
// replaces the numpy lexsort over nnz-sized (g, seg, lane) keys). Unpaired
// layout only (pair=True falls back to numpy). Per 128-row group, a small
// sorted block table (seg -> width = max per-row multiplicity) is built in
// one sweep and the arrays are written in a second sweep — no global sort.
// Must be BITWISE-identical to the numpy path (regression-tested):
//   slot = block_offset(g, seg) + rank, ranks in CSR element order;
//   pos fill = slot_segment*128 everywhere, real entries overwrite.
// ---------------------------------------------------------------------------

namespace {

struct WellBlock {
  int64_t seg;
  int64_t width;
  int64_t off;
};

// sorted insert-or-widen; returns false when cap exceeded
inline bool block_widen(std::vector<WellBlock>& blocks, int64_t seg,
                        int64_t need_width) {
  size_t a = 0, b = blocks.size();
  while (a < b) {
    const size_t mid = (a + b) / 2;
    if (blocks[mid].seg < seg) a = mid + 1;
    else b = mid;
  }
  if (a < blocks.size() && blocks[a].seg == seg) {
    if (blocks[a].width < need_width) blocks[a].width = need_width;
    return true;
  }
  blocks.insert(blocks.begin() + a, WellBlock{seg, need_width, 0});
  return true;
}

inline int64_t block_find(const std::vector<WellBlock>& blocks, int64_t seg) {
  size_t a = 0, b = blocks.size();
  while (a < b) {
    const size_t mid = (a + b) / 2;
    if (blocks[mid].seg < seg) a = mid + 1;
    else b = mid;
  }
  return static_cast<int64_t>(a);
}

// per-row rank bookkeeping: small vector of (seg, count)
struct RowSegs {
  std::vector<std::pair<int64_t, int64_t>> v;
  void clear() { v.clear(); }
  // returns rank (count before increment)
  int64_t bump(int64_t seg) {
    for (auto& p : v) {
      if (p.first == seg) return p.second++;
    }
    v.emplace_back(seg, 1);
    return 0;
  }
};

template <typename T, typename P>
int well_pack_impl(const int64_t* rowptr, const int32_t* colind,
                   const T* values, int64_t nrows, int64_t tile_groups,
                   int64_t gpad, int64_t k, int64_t /*wseg*/,
                   const int32_t* w0, T* values_out, P* pos_out) {
  const int64_t LANES = 128;
  std::vector<WellBlock> blocks;
  RowSegs rowsegs;
  for (int64_t g = 0; g < gpad; ++g) {
    const int64_t r0 = g * LANES;
    const int64_t r1 = std::min(nrows, r0 + LANES);
    if (r0 >= nrows) break;
    blocks.clear();
    // sweep 1: block widths
    for (int64_t r = r0; r < r1; ++r) {
      rowsegs.clear();
      const int64_t lo = rowptr[r], hi = rowptr[r + 1];
      for (int64_t i = lo; i < hi; ++i) {
        const int64_t seg = static_cast<int64_t>(colind[i]) >> 7;
        const int64_t rank = rowsegs.bump(seg);
        block_widen(blocks, seg, rank + 1);
      }
    }
    // slot offsets: exclusive cumsum in seg-ascending order
    int64_t acc = 0;
    for (auto& blk : blocks) {
      blk.off = acc;
      acc += blk.width;
    }
    if (acc > k) return -4;  // scan/pack disagreement (caller bug)
    const int64_t wbase = static_cast<int64_t>(w0[g / tile_groups]);
    // fill: every lane of every used slot carries the slot segment * 128
    for (const auto& blk : blocks) {
      const P fill = static_cast<P>((blk.seg - wbase) * LANES);
      for (int64_t s = blk.off; s < blk.off + blk.width; ++s) {
        P* prow = pos_out + (s * gpad + g) * LANES;
        for (int64_t j = 0; j < LANES; ++j) prow[j] = fill;
      }
    }
    // sweep 2: write entries (ranks re-derived in identical CSR order)
    for (int64_t r = r0; r < r1; ++r) {
      rowsegs.clear();
      const int64_t lane_out = r - r0;
      const int64_t lo = rowptr[r], hi = rowptr[r + 1];
      for (int64_t i = lo; i < hi; ++i) {
        const int64_t col = static_cast<int64_t>(colind[i]);
        const int64_t seg = col >> 7;
        const int64_t rank = rowsegs.bump(seg);
        const int64_t b = block_find(blocks, seg);
        const int64_t slot = blocks[b].off + rank;
        const int64_t idx = (slot * gpad + g) * LANES + lane_out;
        values_out[idx] = values[i];
        pos_out[idx] =
            static_cast<P>((seg - wbase) * LANES + (col & (LANES - 1)));
      }
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// Scan pass: K (max slots per group), per-tile window starts (w0, 8-aligned,
// caller-allocated (gpad/tile_groups,)), wseg (8-rounded max window width)
// and nseg_x (x segments incl. window overrun). Returns 0, or -6 when a
// row exceeds row_cap distinct segments (caller falls back to numpy).
int spmv_well_scan(const int64_t* rowptr, const int32_t* colind,
                   int64_t nrows, int64_t ncols, int64_t tile_groups,
                   int64_t gpad, int64_t row_cap, int64_t* k_out,
                   int64_t* wseg_out, int64_t* nseg_out, int32_t* w0_out) {
  const int64_t LANES = 128;
  const int64_t n_tiles = gpad / tile_groups;
  std::vector<WellBlock> blocks;
  RowSegs rowsegs;
  std::vector<int64_t> tmin(static_cast<size_t>(n_tiles), INT64_MAX);
  std::vector<int64_t> tmax(static_cast<size_t>(n_tiles), INT64_MIN);
  int64_t k = 1;
  for (int64_t g = 0; g * LANES < nrows && g < gpad; ++g) {
    const int64_t r0 = g * LANES;
    const int64_t r1 = std::min(nrows, r0 + LANES);
    blocks.clear();
    const int64_t t = g / tile_groups;
    for (int64_t r = r0; r < r1; ++r) {
      rowsegs.clear();
      const int64_t lo = rowptr[r], hi = rowptr[r + 1];
      for (int64_t i = lo; i < hi; ++i) {
        const int64_t seg = static_cast<int64_t>(colind[i]) >> 7;
        const int64_t rank = rowsegs.bump(seg);
        if (static_cast<int64_t>(rowsegs.v.size()) > row_cap) return -6;
        block_widen(blocks, seg, rank + 1);
        if (seg < tmin[t]) tmin[t] = seg;
        if (seg > tmax[t]) tmax[t] = seg;
      }
    }
    int64_t kg = 0;
    for (const auto& blk : blocks) kg += blk.width;
    if (kg > k) k = kg;
  }
  // windows: 8-aligned starts, shared rounded width (numpy-path semantics)
  int64_t wseg = 1;
  for (int64_t t = 0; t < n_tiles; ++t) {
    const int64_t w0t = tmin[t] == INT64_MAX ? 0 : (tmin[t] / 8) * 8;
    w0_out[t] = static_cast<int32_t>(w0t);
    if (tmax[t] != INT64_MIN && tmax[t] - w0t + 1 > wseg)
      wseg = tmax[t] - w0t + 1;
  }
  wseg = ((wseg + 7) / 8) * 8;
  int64_t nseg = (ncols + LANES - 1) / LANES;
  if (nseg < 1) nseg = 1;
  int64_t w0max = 0;
  for (int64_t t = 0; t < n_tiles; ++t)
    if (w0_out[t] > w0max) w0max = w0_out[t];
  if (n_tiles > 0 && w0max + wseg > nseg) nseg = w0max + wseg;
  if (n_tiles == 0 && wseg > nseg) nseg = wseg;
  *k_out = k;
  *wseg_out = wseg;
  *nseg_out = nseg;
  return 0;
}

int spmv_well_pack_f32_i16(const int64_t* rowptr, const int32_t* colind,
                           const float* values, int64_t nrows,
                           int64_t tile_groups, int64_t gpad, int64_t k,
                           int64_t wseg, const int32_t* w0, float* values_out,
                           int16_t* pos_out) {
  return well_pack_impl(rowptr, colind, values, nrows, tile_groups, gpad, k,
                        wseg, w0, values_out, pos_out);
}

int spmv_well_pack_f32_i32(const int64_t* rowptr, const int32_t* colind,
                           const float* values, int64_t nrows,
                           int64_t tile_groups, int64_t gpad, int64_t k,
                           int64_t wseg, const int32_t* w0, float* values_out,
                           int32_t* pos_out) {
  return well_pack_impl(rowptr, colind, values, nrows, tile_groups, gpad, k,
                        wseg, w0, values_out, pos_out);
}

int spmv_well_pack_f64_i16(const int64_t* rowptr, const int32_t* colind,
                           const double* values, int64_t nrows,
                           int64_t tile_groups, int64_t gpad, int64_t k,
                           int64_t wseg, const int32_t* w0, double* values_out,
                           int16_t* pos_out) {
  return well_pack_impl(rowptr, colind, values, nrows, tile_groups, gpad, k,
                        wseg, w0, values_out, pos_out);
}

int spmv_well_pack_f64_i32(const int64_t* rowptr, const int32_t* colind,
                           const double* values, int64_t nrows,
                           int64_t tile_groups, int64_t gpad, int64_t k,
                           int64_t wseg, const int32_t* w0, double* values_out,
                           int32_t* pos_out) {
  return well_pack_impl(rowptr, colind, values, nrows, tile_groups, gpad, k,
                        wseg, w0, values_out, pos_out);
}

}  // extern "C"

// ---- stencil generators (gen.py hot path) -----------------------------
//
// The numpy builders in gen.py are vectorized but materialize ~(5..7)n
// candidate/mask temporaries (8+ GB at 100M rows) and pay boolean-
// compression passes; these single-pass fills write rowptr/colind/values
// exactly once each (output-bandwidth-bound) with no temporaries.
// Semantics identical to gen.create_laplace_{2d,3d}: Dirichlet, diag 4/6,
// neighbors -1, ascending-offset column order (bitwise-regression-tested
// against the numpy path). Caller allocates rowptr (n+1), colind/values
// (nnz) with nnz = 5n - 2(nx+ny) resp. 7n - 2(nx*ny + nx*nz + ny*nz).

namespace {

template <typename T>
int laplace2d_impl(int64_t nx, int64_t ny, int64_t* rowptr, int32_t* colind,
                   T* values) {
  if (nx < 1 || ny < 1 || nx * ny > INT32_MAX) return -1;
  const T kOff = static_cast<T>(-1.0), kDiag = static_cast<T>(4.0);
  int64_t p = 0;
  rowptr[0] = 0;
  for (int64_t iy = 0; iy < ny; ++iy) {
    const bool up = iy > 0, dn = iy < ny - 1;
    for (int64_t ix = 0; ix < nx; ++ix) {
      const int64_t r = iy * nx + ix;
      if (up) { colind[p] = static_cast<int32_t>(r - nx); values[p++] = kOff; }
      if (ix > 0) { colind[p] = static_cast<int32_t>(r - 1); values[p++] = kOff; }
      colind[p] = static_cast<int32_t>(r); values[p++] = kDiag;
      if (ix < nx - 1) { colind[p] = static_cast<int32_t>(r + 1); values[p++] = kOff; }
      if (dn) { colind[p] = static_cast<int32_t>(r + nx); values[p++] = kOff; }
      rowptr[r + 1] = p;
    }
  }
  return 0;
}

template <typename T>
int laplace3d_impl(int64_t nx, int64_t ny, int64_t nz, int64_t* rowptr,
                   int32_t* colind, T* values) {
  if (nx < 1 || ny < 1 || nz < 1 || nx * ny * nz > INT32_MAX) return -1;
  const T kOff = static_cast<T>(-1.0), kDiag = static_cast<T>(6.0);
  const int64_t nxy = nx * ny;
  int64_t p = 0;
  rowptr[0] = 0;
  for (int64_t iz = 0; iz < nz; ++iz) {
    const bool zu = iz > 0, zd = iz < nz - 1;
    for (int64_t iy = 0; iy < ny; ++iy) {
      const bool yu = iy > 0, yd = iy < ny - 1;
      for (int64_t ix = 0; ix < nx; ++ix) {
        const int64_t r = (iz * ny + iy) * nx + ix;
        if (zu) { colind[p] = static_cast<int32_t>(r - nxy); values[p++] = kOff; }
        if (yu) { colind[p] = static_cast<int32_t>(r - nx); values[p++] = kOff; }
        if (ix > 0) { colind[p] = static_cast<int32_t>(r - 1); values[p++] = kOff; }
        colind[p] = static_cast<int32_t>(r); values[p++] = kDiag;
        if (ix < nx - 1) { colind[p] = static_cast<int32_t>(r + 1); values[p++] = kOff; }
        if (yd) { colind[p] = static_cast<int32_t>(r + nx); values[p++] = kOff; }
        if (zd) { colind[p] = static_cast<int32_t>(r + nxy); values[p++] = kOff; }
        rowptr[r + 1] = p;
      }
    }
  }
  return 0;
}

}  // namespace

extern "C" {

int spmv_laplace2d_f64(int64_t nx, int64_t ny, int64_t* rowptr,
                       int32_t* colind, double* values) {
  return laplace2d_impl(nx, ny, rowptr, colind, values);
}
int spmv_laplace2d_f32(int64_t nx, int64_t ny, int64_t* rowptr,
                       int32_t* colind, float* values) {
  return laplace2d_impl(nx, ny, rowptr, colind, values);
}
int spmv_laplace3d_f64(int64_t nx, int64_t ny, int64_t nz, int64_t* rowptr,
                       int32_t* colind, double* values) {
  return laplace3d_impl(nx, ny, nz, rowptr, colind, values);
}
int spmv_laplace3d_f32(int64_t nx, int64_t ny, int64_t nz, int64_t* rowptr,
                       int32_t* colind, float* values) {
  return laplace3d_impl(nx, ny, nz, rowptr, colind, values);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// RCM pipeline (spmv_tpu/reorder.py's native tier). The numpy realization is
// sort-bound at scale (global int64-key sorts over 2*nnz entries: 53 s at
// 10M rows / 56M nnz); the native pipeline replaces every global sort with
// counting passes + tiny per-row sorts, all O(nnz) with small constants.
// Semantics are BITWISE identical to the numpy path (regression-tested in
// tests/test_reorder.py): same classic-CM tie-breaking (min-degree start
// nodes with index ties, per-parent neighbor groups in ascending-degree
// order, adjacency order within equal degree), same reversal.

namespace {

// Counting sort of nodes by (degree, index) — stable, replaces argsort.
void sort_by_degree(const int64_t* deg, int64_t n, int64_t maxdeg,
                    int64_t* out) {
  std::vector<int64_t> cnt(static_cast<size_t>(maxdeg) + 2, 0);
  for (int64_t i = 0; i < n; ++i) ++cnt[static_cast<size_t>(deg[i]) + 1];
  for (size_t d = 1; d < cnt.size(); ++d) cnt[d] += cnt[d - 1];
  for (int64_t i = 0; i < n; ++i) out[cnt[static_cast<size_t>(deg[i])]++] = i;
}

}  // namespace

extern "C" {

// Symmetrize a CSR pattern: sym = pattern(A + A^T), sorted cols, deduped.
// sym_colind must have capacity 2*nnz; returns the actual symmetrized nnz
// (or -1 on bad input). sym_rowptr has n+1 entries.
int64_t spmv_rcm_symmetrize(const int64_t* rowptr, const int32_t* colind,
                            int64_t n, int64_t nnz, int64_t* sym_rowptr,
                            int32_t* sym_colind) {
  if (n < 0 || nnz < 0 || rowptr[n] != nnz) return -1;
  // degree count of the symmetrized multigraph (duplicates included)
  std::vector<int64_t> off(static_cast<size_t>(n) + 1, 0);
  for (int64_t i = 0; i < n; ++i) off[static_cast<size_t>(i) + 1] += rowptr[i + 1] - rowptr[i];
  for (int64_t p = 0; p < nnz; ++p) ++off[static_cast<size_t>(colind[p]) + 1];
  for (int64_t i = 0; i < n; ++i) off[static_cast<size_t>(i) + 1] += off[static_cast<size_t>(i)];
  // scatter both edge directions into the caller's 2*nnz buffer; the
  // transpose-direction write chases cur[colind[p]] (two dependent random
  // accesses), so prefetch both levels ahead of the loop position
  std::vector<int64_t> cur(off.begin(), off.end() - 1);
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t p = rowptr[i]; p < rowptr[i + 1]; ++p) {
      if (p + 32 < nnz)
        __builtin_prefetch(&cur[static_cast<size_t>(colind[p + 32])]);
      if (p + 16 < nnz)
        __builtin_prefetch(
            &sym_colind[cur[static_cast<size_t>(colind[p + 16])]], 1);
      const int32_t j = colind[p];
      sym_colind[cur[static_cast<size_t>(i)]++] = j;
      sym_colind[cur[static_cast<size_t>(j)]++] = static_cast<int32_t>(i);
    }
  }
  // per-row sort + dedup, compacting forward in place (the write head never
  // passes a row's scatter segment: previous rows only shrink)
  int64_t w = 0;
  sym_rowptr[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    int32_t* b = sym_colind + off[static_cast<size_t>(i)];
    int32_t* e = sym_colind + off[static_cast<size_t>(i) + 1];
    std::sort(b, e);
    int64_t m = 0;
    for (int32_t* q = b; q != e; ++q)
      if (m == 0 || *q != b[m - 1]) b[m++] = *q;
    std::memmove(sym_colind + w, b, static_cast<size_t>(m) * sizeof(int32_t));
    w += m;
    sym_rowptr[i + 1] = w;
  }
  return w;
}

// Classic Cuthill-McKee on a (symmetrized) pattern, REVERSED on output.
// order_out[i] = old index of new row i. Matches reorder.py's tie-breaking.
int spmv_rcm_order(const int64_t* rowptr, const int32_t* colind, int64_t n,
                   int64_t* order_out) {
  if (n < 0) return 1;
  if (n == 0) return 0;
  std::vector<int64_t> deg(static_cast<size_t>(n));
  int64_t maxdeg = 0;
  for (int64_t i = 0; i < n; ++i) {
    deg[static_cast<size_t>(i)] = rowptr[i + 1] - rowptr[i];
    maxdeg = std::max(maxdeg, deg[static_cast<size_t>(i)]);
  }
  std::vector<int64_t> starts(static_cast<size_t>(n));
  sort_by_degree(deg.data(), n, maxdeg, starts.data());
  std::vector<uint8_t> visited(static_cast<size_t>(n), 0);
  std::vector<int64_t> nbrbuf;
  int64_t head = 0, tail = 0, sptr = 0;
  while (tail < n) {
    while (visited[static_cast<size_t>(starts[static_cast<size_t>(sptr)])]) ++sptr;
    const int64_t s = starts[static_cast<size_t>(sptr)];
    visited[static_cast<size_t>(s)] = 1;
    order_out[tail++] = s;
    while (head < tail) {
      const int64_t u = order_out[head++];
      nbrbuf.clear();
      for (int64_t p = rowptr[u]; p < rowptr[u + 1]; ++p) {
        const int32_t v = colind[p];
        if (!visited[static_cast<size_t>(v)]) {
          visited[static_cast<size_t>(v)] = 1;
          nbrbuf.push_back(v);
        }
      }
      std::stable_sort(nbrbuf.begin(), nbrbuf.end(),
                       [&](int64_t a, int64_t b) {
                         return deg[static_cast<size_t>(a)] <
                                deg[static_cast<size_t>(b)];
                       });
      for (int64_t v : nbrbuf) order_out[tail++] = v;
    }
  }
  std::reverse(order_out, order_out + n);
  return 0;
}

}  // extern "C"

namespace {

// Simultaneous row+col permutation B[i,j] = A[order[i], order[j]], cols
// sorted per row — reorder.py permute_symmetric without the global argsort.
// Hot-loop notes: inv is int32 (halves the random-gather footprint), the
// per-row (col, val) pairs go through ONE hoisted buffer (a per-row
// std::vector allocation measured ~2x the whole kernel), and short rows
// take an insertion sort (sparse rows are ~5-10 entries).
template <typename T>
int permute_csr_impl(const int64_t* rowptr, const int32_t* colind,
                     const T* values, int64_t n, const int64_t* order,
                     int64_t* new_rowptr, int32_t* new_colind,
                     T* new_values) {
  if (n < 0) return 1;
  std::vector<int32_t> inv(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i)
    inv[static_cast<size_t>(order[i])] = static_cast<int32_t>(i);
  new_rowptr[0] = 0;
  struct Ent { int32_t c; T v; };
  std::vector<Ent> buf;
  for (int64_t i = 0; i < n; ++i) {
    // two-level prefetch: rowptr[order[i+16]] now so that at i+8 the
    // row's colind/values start can itself be prefetched
    if (i + 16 < n) __builtin_prefetch(&rowptr[order[i + 16]]);
    if (i + 8 < n) {
      const int64_t rb = rowptr[order[i + 8]];
      __builtin_prefetch(&colind[rb]);
      __builtin_prefetch(&values[rb]);
    }
    const int64_t r = order[i];
    const int64_t b = rowptr[r], cnt = rowptr[r + 1] - b;
    if (static_cast<int64_t>(buf.size()) < cnt)
      buf.resize(static_cast<size_t>(cnt));
    Ent* e = buf.data();
    for (int64_t k = 0; k < cnt; ++k)
      e[k] = Ent{inv[static_cast<size_t>(colind[b + k])], values[b + k]};
    if (cnt <= 24) {  // insertion sort: branch-cheap on short rows
      for (int64_t k = 1; k < cnt; ++k) {
        Ent x = e[k];
        int64_t j = k - 1;
        for (; j >= 0 && e[j].c > x.c; --j) e[j + 1] = e[j];
        e[j + 1] = x;
      }
    } else {
      std::sort(e, e + cnt, [](const Ent& x, const Ent& y) {
        return x.c < y.c;
      });
    }
    int32_t* oc = new_colind + new_rowptr[i];
    T* ov = new_values + new_rowptr[i];
    for (int64_t k = 0; k < cnt; ++k) { oc[k] = e[k].c; ov[k] = e[k].v; }
    new_rowptr[i + 1] = new_rowptr[i] + cnt;
  }
  return 0;
}

}  // namespace

extern "C" {

int spmv_permute_csr_f64(const int64_t* rowptr, const int32_t* colind,
                         const double* values, int64_t n,
                         const int64_t* order, int64_t* new_rowptr,
                         int32_t* new_colind, double* new_values) {
  return permute_csr_impl(rowptr, colind, values, n, order, new_rowptr,
                          new_colind, new_values);
}
int spmv_permute_csr_f32(const int64_t* rowptr, const int32_t* colind,
                         const float* values, int64_t n,
                         const int64_t* order, int64_t* new_rowptr,
                         int32_t* new_colind, float* new_values) {
  return permute_csr_impl(rowptr, colind, values, n, order, new_rowptr,
                          new_colind, new_values);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Host SpGEMM + AMG setup kernels. The numpy ESC SpGEMM (expand/lexsort/
// compress in formats/csr.csr_matmul) is global-sort-bound: AMG setup at 1M
// rows spent 48 s in it (82 s total). Gustavson with a dense accumulator is
// O(flops) with no sorts beyond tiny per-row ones.

extern "C" {

// C = A @ B, CSR inputs, f64 values. c_colind/c_vals must have capacity
// `cap` >= nnz(C); pass the ESC expansion bound sum_k |B row a_col[k]|
// (cheap to compute in numpy). Returns nnz(C), or -1 if cap was too small
// (c_rowptr then holds the exact per-row sizes up to the failing row).
// Output columns are sorted per row; values accumulate in first-seen
// order (ULP-level difference from the numpy coalesce is expected).
int64_t spmv_spgemm_f64(const int64_t* a_rowptr, const int32_t* a_colind,
                        const double* a_vals, int64_t a_rows,
                        const int64_t* b_rowptr, const int32_t* b_colind,
                        const double* b_vals, int64_t b_cols,
                        int64_t* c_rowptr, int32_t* c_colind, double* c_vals,
                        int64_t cap) {
  if (a_rows < 0 || b_cols < 0) return -1;
  std::vector<double> acc(static_cast<size_t>(b_cols), 0.0);
  std::vector<int64_t> mark(static_cast<size_t>(b_cols), -1);
  std::vector<int32_t> live;
  int64_t w = 0;
  c_rowptr[0] = 0;
  for (int64_t i = 0; i < a_rows; ++i) {
    live.clear();
    for (int64_t p = a_rowptr[i]; p < a_rowptr[i + 1]; ++p) {
      const int32_t k = a_colind[p];
      const double av = a_vals[p];
      for (int64_t q = b_rowptr[k]; q < b_rowptr[k + 1]; ++q) {
        const int32_t j = b_colind[q];
        if (mark[static_cast<size_t>(j)] != i) {
          mark[static_cast<size_t>(j)] = i;
          acc[static_cast<size_t>(j)] = av * b_vals[q];
          live.push_back(j);
        } else {
          acc[static_cast<size_t>(j)] += av * b_vals[q];
        }
      }
    }
    std::sort(live.begin(), live.end());
    if (w + static_cast<int64_t>(live.size()) > cap) return -1;
    for (int32_t j : live) {
      c_colind[w] = j;
      c_vals[w++] = acc[static_cast<size_t>(j)];
    }
    c_rowptr[i + 1] = w;
  }
  return w;
}

// argmax_j (w, prio[cols]) per row over COO edges (unsorted), last
// occurrence winning exact ties — the exact tie-breaking of the numpy
// lexsort formulation in solvers/amg._strongest_neighbor.
int spmv_strongest_neighbor(const int64_t* rows, const int64_t* cols,
                            const double* w, const double* prio,
                            int64_t nedges, int64_t n, int64_t* cand) {
  if (n < 0 || nedges < 0) return 1;
  std::vector<double> bw(static_cast<size_t>(n)),
      bp(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i) cand[i] = -1;
  for (int64_t e = 0; e < nedges; ++e) {
    const int64_t i = rows[e];
    const double we = w[e], pe = prio[static_cast<size_t>(cols[e])];
    if (cand[i] < 0 || we > bw[static_cast<size_t>(i)] ||
        (we == bw[static_cast<size_t>(i)] &&
         pe >= bp[static_cast<size_t>(i)])) {
      bw[static_cast<size_t>(i)] = we;
      bp[static_cast<size_t>(i)] = pe;
      cand[i] = cols[e];
    }
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// COO -> CSR assembly (formats/csr.CSRHost.from_coo's native tier). The
// numpy tier lexsorts the whole triplet set (O(nnz log nnz), the dominant
// cost of AMG setup / shard classification at scale); here: counting
// scatter by row + per-row stable sort + optional duplicate-sum, O(nnz).
// Stability trick: within a row, pack (col, seq) into one int64 key
// (col << 32 | seq) — a plain sort of the keys is then stable by col, and
// seq recovers the value. Duplicate sums accumulate in double in original
// occurrence order, matching numpy's bincount(weights) bitwise.

namespace {

template <typename T>
int64_t from_coo_impl(const int64_t* rows, const int64_t* cols,
                      const T* vals, int64_t nnz, int64_t nrows,
                      int64_t* rowptr, int32_t* out_cols, T* out_vals,
                      int32_t sum_dups) {
  std::vector<int64_t> cnt(static_cast<size_t>(nrows) + 1, 0);
  for (int64_t p = 0; p < nnz; ++p) {
    const int64_t r = rows[p];
    if (r < 0 || r >= nrows || cols[p] < 0) return -1;
    ++cnt[static_cast<size_t>(r) + 1];
  }
  for (int64_t i = 0; i < nrows; ++i)
    cnt[static_cast<size_t>(i) + 1] += cnt[static_cast<size_t>(i)];
  // scatter keys + values into row segments (input order within a row)
  std::vector<int64_t> keys(static_cast<size_t>(nnz));
  std::vector<T> sv(static_cast<size_t>(nnz));
  {
    std::vector<int64_t> cur(cnt.begin(), cnt.end() - 1);
    for (int64_t p = 0; p < nnz; ++p) {
      const int64_t r = rows[p];
      const int64_t pos = cur[static_cast<size_t>(r)]++;
      const int64_t seq = pos - cnt[static_cast<size_t>(r)];
      keys[static_cast<size_t>(pos)] =
          (cols[p] << 32) | (seq & 0xffffffffLL);
      sv[static_cast<size_t>(pos)] = vals[p];
    }
  }
  std::vector<T> rowbuf;
  int64_t w = 0;
  rowptr[0] = 0;
  for (int64_t i = 0; i < nrows; ++i) {
    const int64_t b = cnt[static_cast<size_t>(i)],
                  e = cnt[static_cast<size_t>(i) + 1];
    std::sort(keys.begin() + b, keys.begin() + e);
    if (static_cast<int64_t>(rowbuf.size()) < e - b)
      rowbuf.resize(static_cast<size_t>(e - b));
    for (int64_t p = b; p < e; ++p)
      rowbuf[static_cast<size_t>(p - b)] =
          sv[static_cast<size_t>(b) +
             (keys[static_cast<size_t>(p)] & 0xffffffffLL)];
    if (sum_dups) {
      int64_t p = b;
      while (p < e) {
        const int32_t c = static_cast<int32_t>(
            keys[static_cast<size_t>(p)] >> 32);
        double acc = 0.0;
        while (p < e && static_cast<int32_t>(
                            keys[static_cast<size_t>(p)] >> 32) == c)
          acc += static_cast<double>(rowbuf[static_cast<size_t>(p++ - b)]);
        out_cols[w] = c;
        out_vals[w++] = static_cast<T>(acc);
      }
    } else {
      for (int64_t p = b; p < e; ++p) {
        out_cols[w] = static_cast<int32_t>(
            keys[static_cast<size_t>(p)] >> 32);
        out_vals[w++] = rowbuf[static_cast<size_t>(p - b)];
      }
    }
    rowptr[i + 1] = w;
  }
  return w;
}

}  // namespace

extern "C" {

int64_t spmv_from_coo_f64(const int64_t* rows, const int64_t* cols,
                          const double* vals, int64_t nnz, int64_t nrows,
                          int64_t* rowptr, int32_t* out_cols,
                          double* out_vals, int32_t sum_dups) {
  return from_coo_impl(rows, cols, vals, nnz, nrows, rowptr, out_cols,
                       out_vals, sum_dups);
}
int64_t spmv_from_coo_f32(const int64_t* rows, const int64_t* cols,
                          const float* vals, int64_t nnz, int64_t nrows,
                          int64_t* rowptr, int32_t* out_cols,
                          float* out_vals, int32_t sum_dups) {
  return from_coo_impl(rows, cols, vals, nnz, nrows, rowptr, out_cols,
                       out_vals, sum_dups);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// One AMG pairwise-matching pass (solvers/amg._pairwise_pass native tier).
// The numpy tier materializes the symmetrized edge list (2*nnz int64 x3
// temporaries) and lexsorts for the strongest-neighbor argmax; here two
// filtered scans reproduce the exact concatenation order + last-occurrence
// tie-breaking, and the unique/relabel is a flag + prefix-sum pass.

namespace {

// strongest-neighbor update scans matching the numpy concatenated order:
// all (rows->cols) edges first, then all (cols->rows); >= keeps the LAST
// occurrence among exact (w, prio) ties, matching the stable lexsort.
inline void sn_update(int64_t i, int64_t j, double we, const double* prio,
                      double* bw, double* bp, int64_t* cand) {
  const double pe = prio[static_cast<size_t>(j)];
  if (cand[i] < 0 || we > bw[i] || (we == bw[i] && pe >= bp[i])) {
    bw[i] = we;
    bp[i] = pe;
    cand[i] = j;
  }
}

}  // namespace

extern "C" {

// Returns nc (number of aggregates) and fills agg_out (n, int64) with
// dense aggregate ids in [0, nc); -1 on bad input. `prio` is the host RNG
// permutation (kept in Python so the aggregate structure is seed-stable
// with the numpy tier).
int64_t spmv_pairwise_pass(const int64_t* rows, const int64_t* cols,
                           const double* vals, int64_t nnz, int64_t n,
                           const double* prio, int64_t* agg_out) {
  if (n < 0 || nnz < 0) return -1;
  std::vector<double> bw(static_cast<size_t>(n)), bp(static_cast<size_t>(n));
  std::vector<int64_t> cand(static_cast<size_t>(n), -1);
  for (int64_t e = 0; e < nnz; ++e) {
    if (rows[e] == cols[e]) continue;
    sn_update(rows[e], cols[e], std::abs(vals[e]), prio, bw.data(),
              bp.data(), cand.data());
  }
  for (int64_t e = 0; e < nnz; ++e) {
    if (rows[e] == cols[e]) continue;
    sn_update(cols[e], rows[e], std::abs(vals[e]), prio, bw.data(),
              bp.data(), cand.data());
  }
  // mutual strongest pairs merge; rep = min(i, mate) for matched nodes
  std::vector<int64_t> rep(static_cast<size_t>(n));
  std::vector<uint8_t> matched(static_cast<size_t>(n), 0);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t m = cand[static_cast<size_t>(i)] >= 0
                          ? cand[static_cast<size_t>(i)]
                          : i;
    const int64_t mm = cand[static_cast<size_t>(m)] >= 0
                           ? cand[static_cast<size_t>(m)]
                           : m;
    if (mm == i && m != i) {
      matched[static_cast<size_t>(i)] = 1;
      rep[static_cast<size_t>(i)] = std::min(i, m);
    } else {
      rep[static_cast<size_t>(i)] = i;
    }
  }
  // attach leftover singletons to their strongest MATCHED neighbor
  // (same two-scan order, edges filtered on a matched target)
  std::vector<int64_t> att(static_cast<size_t>(n), -1);
  std::fill(bw.begin(), bw.end(), 0.0);
  std::fill(bp.begin(), bp.end(), 0.0);
  for (int64_t e = 0; e < nnz; ++e) {
    if (rows[e] == cols[e]) continue;
    if (matched[static_cast<size_t>(cols[e])])
      sn_update(rows[e], cols[e], std::abs(vals[e]), prio, bw.data(),
                bp.data(), att.data());
  }
  for (int64_t e = 0; e < nnz; ++e) {
    if (rows[e] == cols[e]) continue;
    if (matched[static_cast<size_t>(rows[e])])
      sn_update(cols[e], rows[e], std::abs(vals[e]), prio, bw.data(),
                bp.data(), att.data());
  }
  for (int64_t i = 0; i < n; ++i)
    if (!matched[static_cast<size_t>(i)] && att[static_cast<size_t>(i)] >= 0)
      rep[static_cast<size_t>(i)] =
          rep[static_cast<size_t>(att[static_cast<size_t>(i)])];
  // dense relabel == np.unique(rep, return_inverse): sorted unique ids
  std::vector<int64_t> newid(static_cast<size_t>(n), -1);
  for (int64_t i = 0; i < n; ++i) newid[static_cast<size_t>(rep[i])] = 0;
  int64_t nc = 0;
  for (int64_t v = 0; v < n; ++v)
    if (newid[static_cast<size_t>(v)] == 0) newid[static_cast<size_t>(v)] = nc++;
  for (int64_t i = 0; i < n; ++i)
    agg_out[i] = newid[static_cast<size_t>(rep[i])];
  return nc;
}

}  // extern "C"
