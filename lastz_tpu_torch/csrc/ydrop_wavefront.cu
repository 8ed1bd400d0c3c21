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
// What bounds them on an H100: not bytes (4 kB of codes in and 512 B
// out per anchor) but integer operations, about 16 a DP cell, over the
// cells an anchor needs; and the chain of dependent steps each anchor
// is.
//
// K3 (ydrop_wavefront_kernel<S>): one warp per anchor, K3_WARPS
// anchors a CTA, no block barrier.  Lane j owns a strip of S = band/32
// consecutive columns and keeps each one's C of the row above, D and
// running best in registers (the row of each best in shared memory,
// written only when the best moves).  The rows are pipelined down the
// lanes: at step s lane j computes row s - j over its strip, left to
// right, carrying I along the strip exactly as the anti-diagonal
// recurrence does.  Lane j takes its left neighbour's C and I of the
// same row from lane j - 1 (__shfl_up_sync of what that lane computed a
// step before), and keeps the previous one as the diagonal input; lane
// 0 takes the column-0 boundary.  rows + 31 steps of S cells, one
// coalesced code load a step (32 lanes, 32 consecutive rows, one step
// ahead), substitution scores from a conflict-free shared table
// [code][column][lane].  S is a template parameter (1 to 32, every
// band the contract allows), so the strip never spills.  The state of
// row -1 is what the anti-diagonal sweep leaves there, quirks
// included: lane 0 never takes the row-0 boundary, and D holds l steps
// of NEG arithmetic.
//
// K3's early stop.  A sweep ends at the anchor's last on-grid row
// (codes1 holds -1 past the end: such rows compute NEG everywhere and
// move no best), or after the first row r for which stop_ok holds:
//   (a) r is on the grid (codes1[r] >= 0) and the prune removed every
//       cell of row r, so C(r, l) = NEG for every column;
//   (b) the column-0 boundary is dead from row r + 1 on
//       (vcol0(r + 1) == NEG; vcol0 does not grow when gap_e >= 0);
//   (c) the parameters keep every sum away from int32 wrap (can_stop).
// Then no later cell survives, for any codes1.  Let thr(l) = best(l) -
// y_drop >= -y_drop.  On a valid column every cell of row r was on the
// grid and pruned, so D(r, l) <= C_raw(r, l) < thr(l); an invalid
// column never survives and its D reaches no other column.  In row
// r + 1, left to right: the diagonal input is NEG (or the dead
// boundary) plus a score, at most NEG + 2^16; I comes from the NEG
// cells to the left and the dead boundary, at most NEG; D(r + 1, l) =
// max(D(r, l) - gap_e, NEG - gap_oe) < thr(l).  So every cell is
// pruned (or off the grid), no best moves, and the same holds for the
// row after.  D is never masked, which is why (a) asks for an on-grid
// row: there the prune bounds D; an off-grid row (codes1 -1 inside the
// anchor) leaves it free.  The rows other lanes compute past r, before
// the warp sees the test pass, change nothing for the same reason.
// ops/ydrop_pallas.ydrop_wavefront_rows computes where the test first
// holds, in plain PyTorch.
//
// K3b (ydrop_band_kernel, unchanged since its port): one CTA per
// anchor, one thread per DP column; it sweeps rows, the insertion state
// is the decayed exclusive prefix max of the row (a warp
// __shfl_up_sync scan plus a shared scan of the warp totals), and the
// previous row's C reaches column c+1 through shared memory (three
// __syncthreads() per row), over the whole grid.  It ends with three
// block max reductions that apply the kernels' tie rule (latest row at
// the maximum, then the largest column).

#include <climits>

#include <array>
#include <utility>

#include "common.cuh"

namespace {

using namespace lastz;

constexpr int NEG = -(1 << 30);      // NEG_INF_I32
constexpr int NEG_HALF = -(1 << 29);  // NEG_INF_I32 // 2
constexpr int K3_WARPS = 8;           // K3: anchors (warps) per CTA

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

// C(-1, l) = C(DP row 0, column l + 1): the row-0 boundary, y-drop masked
__device__ __forceinline__ int c0row_at(int l, int gap_e, int gap_oe,
                                        int neg_y, bool valid) {
  const int v = wsub(wsub(0, gap_oe), wmul(l, gap_e));
  return (v >= neg_y && valid) ? v : NEG;
}

// K3 at strip width S (band = 32 S): one warp per anchor, lane j owns
// DP columns j S + 1 .. j S + S (kernel lanes l = j S .. j S + S - 1)
// and at step s computes row r = s - j of them, left to right.
template <int S>
__global__ void __launch_bounds__(K3_WARPS * 32)
    ydrop_wavefront_kernel(const int* __restrict__ codes1,
                           const int* __restrict__ codes2,
                           const int* __restrict__ sub4,
                           const int* __restrict__ params,
                           int* __restrict__ out, int B, int max_rows) {
  constexpr int band = 32 * S;
  extern __shared__ int s_dyn[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * K3_WARPS + warp;
  if (b >= B) return;
  // this warp's substitution planes [4][S][32] and rows of best [S][32]:
  // a lane touches only its own slots, so no barrier is needed
  int* s_plane = s_dyn + warp * 5 * band;
  int* s_rob = s_plane + 4 * band;

  // only row 0 of params is read: the gaps and the y-drop are uniform
  const int gap_e = params[0], gap_oe = params[1], y_drop = params[2];
  const int neg_y = wsub(0, y_drop);
  const int* c1 = codes1 + b * max_rows;
  const int* c2 = codes2 + b * band;
  int smax = sub4[0], smin = sub4[0];
#pragma unroll
  for (int i = 1; i < 16; ++i) {
    smax = max(smax, sub4[i]);
    smin = min(smin, sub4[i]);
  }
  // the early stop's proof needs sums that never wrap (see stop_ok)
  const bool can_stop =
      gap_e >= 0 && gap_oe >= 0 && y_drop >= 0 && y_drop < (1 << 28) &&
      smax <= (1 << 16) && smin >= -(1 << 16) &&
      (long long)gap_oe + (long long)(max_rows + band) * gap_e < (1 << 28);

  // rows past the last on-grid one compute NEG and change no best
  int last = -1;
  for (int r = lane; r < max_rows; r += 32)
    if (__ldg(c1 + r) >= 0) last = r;
  const int rows_end = __reduce_max_sync(kFullMask, last) + 1;

  // the state of kernel row -1 (DP row 0), as the anti-diagonal sweep
  // leaves it: C is the row-0 boundary but at lane 0, which never takes
  // it; D is f^l(NEG), f(x) = max(x - gap_e, NEG - gap_oe), the l steps
  // of NEG states lane l runs before it reaches row -1
  int cprev[S], dd[S], best[S];
  unsigned vmask = 0;
  int dneg = NEG;
  for (int i = 0; i < lane * S; ++i)
    dneg = max(wsub(dneg, gap_e), wsub(NEG, gap_oe));
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int l = lane * S + k;
    const int code2 = __ldg(c2 + l);
    const bool valid = code2 >= 0;
    vmask |= (unsigned)valid << k;
    const int bcode = min(max(code2, 0), 3);
#pragma unroll
    for (int a = 0; a < 4; ++a)
      s_plane[(a * S + k) * 32 + lane] =
          valid ? __ldg(sub4 + a * 4 + bcode) : NEG_HALF;
    const int c0 = c0row_at(l, gap_e, gap_oe, neg_y, valid);
    cprev[k] = l == 0 ? NEG : c0;
    dd[k] = dneg;
    dneg = max(wsub(dneg, gap_e), wsub(NEG, gap_oe));
    // row -1's cell is tested against best like any other (d == l);
    // a column never improved keeps d_of_best = 0, so r_of_best = -l
    best[k] = 0;
    int rob = -l;
    if (l >= 1 && c0 >= 0) {
      best[k] = c0;
      rob = 0;
    }
    s_rob[k * 32 + lane] = rob;
  }
  // C(-1, j S - 1), the diagonal input of this lane's first row
  int diag_prev = NEG;
  if (lane > 0 && lane * S - 1 > 0)
    diag_prev = c0row_at(lane * S - 1, gap_e, gap_oe, neg_y,
                      __ldg(c2 + lane * S - 1) >= 0);

  int c_out = NEG, i_out = NEG;  // this lane's last column, last step
  int tok_out = 0;               // rows 0..r of lanes 0..j: stop_ok
  int a_next = lane == 0 && rows_end > 0 ? __ldg(c1) : -1;
  for (int s = 0; s < rows_end + 31; ++s) {
    const int r = s - lane;
    const int a = a_next;
    a_next = (r + 1 >= 0 && r + 1 < rows_end) ? __ldg(c1 + r + 1) : -1;
    // lane j - 1's row r: its last column's C and I, and its verdict
    const int cin = __shfl_up_sync(kFullMask, c_out, 1);
    const int iin = __shfl_up_sync(kFullMask, i_out, 1);
    const int tin = __shfl_up_sync(kFullMask, tok_out, 1);
    if (r >= 0 && r < rows_end) {
      int left_c, left_i, diag, tok;
      if (lane == 0) {
        left_c = vcol0(r + 1, gap_e, gap_oe, neg_y);
        left_i = NEG;
        diag = vcol0(r, gap_e, gap_oe, neg_y);
        tok = can_stop && left_c == NEG;
      } else {
        left_c = cin;
        left_i = iin;
        diag = diag_prev;
        tok = tin;
      }
      diag_prev = left_c;
      const bool row_on = a >= 0;
      const int* pl = s_plane + (a == 0 || a == 1 || a == 2 ? a : 3) * S * 32
                      + lane;
      bool any_keep = false;
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const int up = cprev[k];
        const int sub_path = wadd(diag, pl[k * 32]);
        const int d_cur = max(wsub(dd[k], gap_e), wsub(up, gap_oe));
        const int i_cur = max(wsub(left_i, gap_e), wsub(left_c, gap_oe));
        int c = max(max(sub_path, d_cur), i_cur);
        const bool keep = row_on && ((vmask >> k) & 1u) &&
                          c >= wsub(best[k], y_drop);
        c = keep ? c : NEG;
        any_keep |= keep;
        if (c >= best[k]) {
          best[k] = c;
          s_rob[k * 32 + lane] = r + 1;
        }
        diag = up;
        cprev[k] = c;
        dd[k] = d_cur;
        left_c = c;
        left_i = i_cur;
      }
      c_out = left_c;
      i_out = left_i;
      tok_out = tok && row_on && !any_keep;
    }
    // lane 31 has just finished row s - 31: stop once it passes the test
    if (__shfl_sync(kFullMask, tok_out, 31)) break;
  }

  // latest row at the maximum, then the largest column; the row is
  // reported as r - 1 (kernel row r is DP row r + 1), clamped at 0
  int m = best[0];
#pragma unroll
  for (int k = 1; k < S; ++k) m = max(m, best[k]);
  const int top = __reduce_max_sync(kFullMask, m);
  int er = INT_MIN;  // a column not at the maximum puts in -1
#pragma unroll
  for (int k = 0; k < S; ++k)
    er = max(er, best[k] == top ? s_rob[k * 32 + lane] : -1);
  const int end_row = __reduce_max_sync(kFullMask, er);
  int ec = -1;
#pragma unroll
  for (int k = 0; k < S; ++k)
    if (best[k] == top && s_rob[k * 32 + lane] == end_row)
      ec = lane * S + k + 1;
  const int end_col = __reduce_max_sync(kFullMask, ec);
  const int4 v = lane == 0 ? make_int4(top, max(end_row - 1, 0),
                                       max(end_col, 0), 0)
                           : make_int4(0, 0, 0, 0);
  reinterpret_cast<int4*>(out + b * 128)[lane] = v;
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

template <int S>
int launch_wavefront(const int* codes1, const int* codes2, const int* sub4,
                     const int* params, int* out, int B, int max_rows,
                     cudaStream_t stream) {
  const int shm = K3_WARPS * 5 * 32 * S * (int)sizeof(int);
  if (shm > 48 * 1024)
    cudaFuncSetAttribute(ydrop_wavefront_kernel<S>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, shm);
  ydrop_wavefront_kernel<S>
      <<<(B + K3_WARPS - 1) / K3_WARPS, K3_WARPS * 32, shm, stream>>>(
          codes1, codes2, sub4, params, out, B, max_rows);
  return (int)cudaGetLastError();
}

using WavefrontLaunch = int (*)(const int*, const int*, const int*,
                                const int*, int*, int, int, cudaStream_t);

// one instantiation for every strip width the contract allows, 1 to 32
template <int... I>
constexpr std::array<WavefrontLaunch, sizeof...(I)> wavefront_table(
    std::integer_sequence<int, I...>) {
  return {&launch_wavefront<I + 1>...};
}
constexpr auto kWavefront =
    wavefront_table(std::make_integer_sequence<int, 32>{});

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
  return kWavefront[band / 32 - 1](codes1, codes2, sub4, params, out, B,
                                   max_rows, (cudaStream_t)stream);
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
