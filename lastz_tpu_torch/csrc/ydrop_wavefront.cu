// K3 and K3b on Hopper: score-only one-sided y-drop of a batch of
// anchors, pruned against each column's own running best (a
// relaxation of the reference's y-drop: scores are never below it, so
// the results are not exact against LASTZ).  Returns per anchor the
// best score, its row and its column.
//
// ydrop_wavefront_kernel replaces
// lastz_tpu/ops/ydrop_pallas.py::_ydrop_wavefront_kernel (K3, launched
// by ydrop_extend_batch); ydrop_band_kernel replaces
// _ydrop_band_kernel (K3b, the row-sweep form of the same DP, which no
// pallas_call reaches).  Both compute what
// ops/ydrop_pallas.ydrop_wavefront_plain / ydrop_band_plain compute,
// value for value, including int32 wrap-around (wadd/wsub/wmul).
//
// Layout: one CTA per anchor, one thread per DP column (band threads,
// 512 at the default geometry).
//   K3 sweeps anti-diagonals: at step d thread l computes cell
//   (d-1-l, l+1) from its own C and D of step d-1 and its left
//   neighbour's C and I of steps d-1 and d-2.  The neighbour's values
//   pass through a double-buffered shared-memory row (one
//   __syncthreads() per step, max_rows + band - 1 steps); the vertical
//   code of the cell is codes1[d-1-l], read directly.
//   K3b sweeps rows: the insertion state is the decayed exclusive
//   prefix max of the row (a warp __shfl_up_sync scan plus a shared
//   scan of the warp totals), and the previous row's C reaches column
//   c+1 through shared memory (three __syncthreads() per row).
// Both end with three block max reductions that apply the kernels'
// tie rule (latest row at the maximum, then the largest column).
//
// What bounds it on an H100: neither bytes (4 kB of codes in and
// 512 B out per anchor) nor arithmetic (about 16 integer operations a
// cell), but the chain of barriers -- 1535 dependent steps per anchor
// for K3, 1024 rows of three barriers for K3b.  One CTA per anchor
// puts up to four anchors on an SM (512 threads each), and a batch of
// thousands of anchors fills all 132 SMs many times over, so the
// barrier latency of one CTA hides behind the others.  Both kernels
// also sweep the whole grid, though on anchors of a real pair only
// about half its cells stay above the y-drop (rows die some y_drop /
// gap_e rows past the diagonal).  Fewer barriers (a warp per anchor,
// several columns per thread) and stopping once the band dies are
// later work.

#include "common.cuh"

namespace {

using namespace lastz;

constexpr int NEG = -(1 << 30);      // NEG_INF_I32
constexpr int NEG_HALF = -(1 << 29);  // NEG_INF_I32 // 2

// Max of v over the block, returned to every thread.  s_red holds one
// slot per warp and may be reused by the next call.
__device__ __forceinline__ int block_max(int v, int* s_red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarp = blockDim.x >> 5;
  v = __reduce_max_sync(kFullMask, v);
  __syncthreads();  // every read of s_red by an earlier call is done
  if (lane == 0) s_red[warp] = v;
  __syncthreads();
  int m = s_red[0];
  for (int w = 1; w < nwarp; ++w) m = max(m, s_red[w]);
  return m;
}

// Exclusive prefix max over the block's threads, seeded with `ident`.
__device__ __forceinline__ int block_excl_max(int v, int ident, int* sw) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarp = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFullMask, x, o);
    if (lane >= o) x = max(x, y);
  }
  if (lane == 31) sw[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarp ? sw[lane] : ident;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFullMask, w, o);
      if (lane >= o) w = max(w, y);
    }
    if (lane < nwarp) sw[lane] = w;
  }
  __syncthreads();
  int ex = __shfl_up_sync(kFullMask, x, 1);
  if (lane == 0) ex = ident;
  const int pre = warp ? sw[warp - 1] : ident;
  return max(pre, ex);
}

// The substitution score of vertical code a against this column's
// plane: codes 0, 1, 2 pick their own row of the table, anything else
// row 3 (the kernels' nested selects).
__device__ __forceinline__ int pick(const int plane[4], int a) {
  return a == 0 ? plane[0] : a == 1 ? plane[1] : a == 2 ? plane[2]
                                                        : plane[3];
}

// C(r, 0): 0 at r == 0, else the vertical-gap boundary, y-drop masked
__device__ __forceinline__ int vcol0(int r, int gap_e, int gap_oe,
                                     int neg_y) {
  const int v = r == 0 ? 0 : wsub(wsub(0, gap_oe), wmul(r - 1, gap_e));
  return (v >= neg_y && r >= 0) ? v : NEG;
}

__device__ __forceinline__ void write_out(int* out, int best, int row,
                                          int col) {
  for (int i = threadIdx.x; i < 128; i += blockDim.x)
    out[i] = i == 0 ? best : i == 1 ? row : i == 2 ? col : 0;
}

__global__ void ydrop_wavefront_kernel(const int* __restrict__ codes1,
                                       const int* __restrict__ codes2,
                                       const int* __restrict__ sub4,
                                       const int* __restrict__ params,
                                       int* __restrict__ out, int band,
                                       int max_rows) {
  extern __shared__ int s_dyn[];  // C and I of the last step, 2 buffers
  __shared__ int s_red[32];
  int* s_c = s_dyn;
  int* s_i = s_dyn + 2 * band;

  const long long b = blockIdx.x;
  const int l = threadIdx.x;
  // only row 0 of params is read: the gaps and the y-drop are uniform
  const int gap_e = params[0], gap_oe = params[1], y_drop = params[2];
  const int neg_y = wsub(0, y_drop);
  const int* c1 = codes1 + b * max_rows;

  const int code2 = codes2[b * band + l];
  const bool col_valid = code2 >= 0;
  const int bcode = min(max(code2, 0), 3);
  int plane[4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
    plane[a] = col_valid ? sub4[a * 4 + bcode] : NEG_HALF;
  int c0row = wsub(wsub(0, gap_oe), wmul(l, gap_e));
  c0row = (c0row >= neg_y && col_valid) ? c0row : NEG;

  int c_m1 = NEG, d_m1 = NEG;  // this lane's C and D of step d-1
  int left_c_m2 = NEG;         // the left lane's C of step d-2
  int best = 0, d_of_best = 0;
  s_c[l] = NEG;
  s_i[l] = NEG;
  __syncthreads();

  for (int d = 1; d < max_rows + band; ++d) {
    const int* pc = s_c + ((d - 1) & 1) * band;
    const int* pi = s_i + ((d - 1) & 1) * band;
    int left_c, left_i, diag;
    if (l == 0) {
      left_c = vcol0(d, gap_e, gap_oe, neg_y);
      left_i = NEG;
      diag = vcol0(d - 1, gap_e, gap_oe, neg_y);
    } else {
      left_c = pc[l - 1];
      left_i = pi[l - 1];
      diag = left_c_m2;
    }
    const int r = d - 1 - l;
    const int a = (r >= 0 && r < max_rows) ? c1[r] : -1;
    const bool on_grid = a >= 0 && col_valid;

    const int sub_path = wadd(diag, pick(plane, a));
    const int d_cur = max(wsub(d_m1, gap_e), wsub(c_m1, gap_oe));
    const int i_cur = max(wsub(left_i, gap_e), wsub(left_c, gap_oe));
    int c_cur = max(max(sub_path, d_cur), i_cur);
    if (!(on_grid && c_cur >= wsub(best, y_drop))) c_cur = NEG;
    if (d == l) c_cur = c0row;  // the row-0 boundary
    if (c_cur >= best) {
      best = c_cur;
      d_of_best = d;
    }
    left_c_m2 = left_c;
    c_m1 = c_cur;
    d_m1 = d_cur;
    s_c[(d & 1) * band + l] = c_cur;
    s_i[(d & 1) * band + l] = i_cur;
    __syncthreads();
  }

  // latest row at the maximum, then the largest column; the row is
  // reported as r - 1 (kernel row r is DP row r + 1), clamped at 0
  const int r_of_best = wsub(d_of_best, l);
  const int top = block_max(best, s_red);
  const int end_row = block_max(best == top ? r_of_best : -1, s_red);
  const int end_col = block_max(
      (best == top && r_of_best == end_row) ? l + 1 : -1, s_red);
  write_out(out + b * 128, top, max(end_row - 1, 0), max(end_col, 0));
}

__global__ void ydrop_band_kernel(const int* __restrict__ codes1,
                                  const int* __restrict__ codes2,
                                  const int* __restrict__ sub4,
                                  const int* __restrict__ params,
                                  int* __restrict__ out, int band,
                                  int max_rows) {
  extern __shared__ int s_c[];  // the previous row's C
  __shared__ int s_scan[32];
  __shared__ int s_red[32];

  const long long b = blockIdx.x;
  const int c = threadIdx.x;
  const int gap_e = params[0], gap_oe = params[1], y_drop = params[2];
  const int neg_y = wsub(0, y_drop);
  const int* c1 = codes1 + b * max_rows;

  // DP column c consumes codes2[c - 1]; column 0 is the boundary
  const int code2 = c >= 1 ? codes2[b * band + c - 1] : -1;
  const bool col_valid = c >= 1 && code2 >= 0;
  const int bcode = min(max(code2, 0), 3);
  int plane[4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
    plane[a] = col_valid ? sub4[a * 4 + bcode] : NEG_HALF;

  int c_prev = c == 0 ? 0 : wsub(wsub(0, gap_oe), wmul(c - 1, gap_e));
  c_prev = c_prev >= neg_y ? c_prev : NEG;
  c_prev = (col_valid || c == 0) ? c_prev : NEG;
  int d_prev = NEG;
  const int decay = wmul(c, gap_e);
  int best = 0, row_of_best = 0;
  s_c[c] = c_prev;
  __syncthreads();

  for (int row = 0; row < max_rows; ++row) {
    const int a = c1[row];
    const int s = a >= 0 ? pick(plane, a) : NEG_HALF;
    const int c_shift = c == 0 ? NEG : s_c[c - 1];
    const int d_cur = max(wsub(d_prev, gap_e), wsub(c_prev, gap_oe));
    const int t = max(wadd(c_shift, s), d_cur);
    // I(c) = max over k < c of (t(k) - gapOE + k gapE) - c gapE + gapE,
    // with NEG inside the max: the Hillis-Steele pad of the kernel
    // reaches every column but the last of a power-of-two band
    const int g = wadd(wsub(t, gap_oe), decay);
    const int g_shift = block_excl_max(g, NEG, s_scan);
    const int i_cur = wadd(wsub(g_shift, decay), gap_e);
    int c_cur = max(t, i_cur);
    if (!(c_cur >= wsub(best, y_drop))) c_cur = NEG;
    if (!col_valid) c_cur = NEG;
    if (c_cur >= best) {
      best = c_cur;
      row_of_best = row;
    }
    c_prev = c_cur;
    d_prev = d_cur;
    // every read of s_c for this row precedes the barriers in the scan
    s_c[c] = c_cur;
    __syncthreads();
  }

  const int top = block_max(best, s_red);
  const int end_row = block_max(best == top ? row_of_best : -1, s_red);
  const int end_col = block_max(
      (best == top && row_of_best == end_row) ? c : -1, s_red);
  write_out(out + b * 128, top, max(end_row, 0), max(end_col, 0));
}

}  // namespace

// Launch K3 (ydrop_wavefront_launch) or K3b (ydrop_band_launch) for B
// anchors on `stream`: codes1 (B, max_rows), codes2 (B, band), sub4
// (4, 4), params (B, 4) and out (B, 128), all int32 and contiguous;
// band a multiple of 32, at most 1024.  Returns the cudaGetLastError()
// code of the launch.
extern "C" int ydrop_wavefront_launch(const int* codes1, const int* codes2,
                                      const int* sub4, const int* params,
                                      int* out, int B, int band,
                                      int max_rows, void* stream) {
  if (band % 32 != 0 || band < 32 || band > 1024 || max_rows < 1)
    return (int)cudaErrorInvalidValue;
  const size_t shm = (size_t)4 * band * sizeof(int);
  ydrop_wavefront_kernel<<<B, band, shm, (cudaStream_t)stream>>>(
      codes1, codes2, sub4, params, out, band, max_rows);
  return (int)cudaGetLastError();
}

extern "C" int ydrop_band_launch(const int* codes1, const int* codes2,
                                 const int* sub4, const int* params,
                                 int* out, int B, int band, int max_rows,
                                 void* stream) {
  if (band % 32 != 0 || band < 32 || band > 1024 || max_rows < 1)
    return (int)cudaErrorInvalidValue;
  const size_t shm = (size_t)band * sizeof(int);
  ydrop_band_kernel<<<B, band, shm, (cudaStream_t)stream>>>(
      codes1, codes2, sub4, params, out, band, max_rows);
  return (int)cudaGetLastError();
}
