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
// K3b (ydrop_band_kernel<S>): the row sweep, one warp per anchor,
// K3_WARPS anchors a CTA, no block barrier.  Lane j owns DP columns j S
// .. j S + S - 1 (column 0, the boundary, is lane 0's first) and keeps
// each one's C of the row above, D and running best in registers (the
// row of each best in shared memory, written only when the best moves).
// A row: the diagonal input of the strip's first column is lane j - 1's
// last C of the row above (__shfl_up_sync; NEG at lane 0, the pad of
// column 0); the insertion state I, the decayed exclusive prefix max of
// g = t - gap_oe + c gap_e with NEG inside the max, is a serial running
// max along the strip, a five-step __shfl_up_sync max-scan of the strip
// totals, and each column's exclusive max resolved against its lane's
// prefix.  Codes come 32 rows at a time, one coalesced load a warp (the
// next group's issued a group ahead), each row's broadcast with
// __shfl_sync; the substitution score of a row is one shared-memory
// load a column from a conflict-free table [plane][column][lane], five
// planes: codes 0, 1, 2, anything else, and NEG_HALF for an off-grid
// row (a table rather than 4 x S registers: the warp-uniform code picks
// a plane by address, with no select a column, and the registers stay
// for the strip's state).  The argmax ends in warp reductions with the
// kernels' tie rule (latest row at the maximum, then the largest
// column).  S is a template parameter (1 to 32).
//
// K3b's early stop.  Let thr(c) = best(c) - y_drop, best(c) >= 0 the
// column's running best, and C*(r, c) a cell's value before the prune
// (C(r, c) after it: C* where kept, NEG where pruned).  The sweep tests
// rows 31, 63, ... (the last row of each group of codes) and ends after
// the first tested row r for which
//   (a) the prune removed every cell of row r (C(r, c) = NEG for every
//       column; column 0 and invalid columns always are), and
//   (b) the parameters keep every sum from int32 wrap (band_can_stop:
//       K3's guard, and max_rows x max(sub4) < 2^28, so that every
//       score stays below 2^28).
// Then every cell of every later row is pruned, for any codes1, so no
// best and no row of a best moves (no tie either: a pruned cell is NEG,
// below every best).  Row r + 1 from row r, then induction; for a valid
// column c, C*(r + 1, c) = max(t, I) with
//   - the diagonal input C(r, c - 1) + s = NEG + s, s at most 2^16 (or
//     NEG_HALF), below -2^28 <= thr(c);
//   - D(r + 1, c) = max(D(r, c) - gap_e, NEG - gap_oe), and D(r, c) <=
//     t(r, c) <= C*(r, c) < thr(c);
//   - I(r + 1, c), the max over k < c of t(r + 1, k) - gap_oe - (c - 1 -
//     k) gap_e and of the scan's NEG pad.  t(r + 1, k) is a NEG-based
//     diagonal input or D(r + 1, k) <= max(D(r, k) - gap_e, NEG -
//     gap_oe); the NEG terms stay below thr(c), and D(r, k) - gap_e -
//     gap_oe - (c - 1 - k) gap_e <= t(r, k) - gap_oe - (c - 1 - k) gap_e
//     - gap_e <= I(r, c) - gap_e <= C*(r, c) - gap_e < thr(c), since row
//     r's I(r, c) took the same max over the same columns.
// So C*(r + 1, c) < thr(c): row r + 1 is pruned whole, with the same
// thresholds, and so is every row after it.  Unlike K3's, the test needs
// neither an on-grid row nor a dead column-0 boundary: D at column 0,
// at invalid columns and on off-grid rows is never masked, but what it
// could add to a later row through I it had already added to row r's I,
// one gap_e more, so C*(r, c) bounds it (and while it can reach a
// column's threshold, that column survives and (a) fails).  Nor is the
// last on-grid row an end: the rows past it still carry gaps and can
// move a best (at zero gap costs they do).  Without (b) the sweep runs
// every row.  (b) keeps each value above within int32: C <= max_rows x
// max(sub4) < 2^28, C >= NEG, D >= NEG - gap_oe, thr >= -2^28, and
// NEG + NEG_HALF and NEG - gap_oe - band gap_e stay above -2^31.  The
// test costs no operation a cell: it reads row r's C from the strip's
// registers once every 32 rows, and sweeps at most 31 rows past the
// first row where (a) holds (once (a) holds, it holds on every later
// row).  ops/ydrop_pallas.ydrop_band_rows counts the rows the kernel
// sweeps, in plain PyTorch.

#include <climits>

#include <array>
#include <utility>

#include "common.cuh"

namespace {

using namespace lastz;

constexpr int NEG = -(1 << 30);      // NEG_INF_I32
constexpr int NEG_HALF = -(1 << 29);  // NEG_INF_I32 // 2
constexpr int K3_WARPS = 8;           // K3: anchors (warps) per CTA

// K3's stop guard: no sum of the recurrence can wrap, whatever the
// scores of max_rows rows add up to (see stop_ok)
__device__ __forceinline__ bool gaps_stay_small(const int* sub4, int gap_e,
                                                int gap_oe, int y_drop,
                                                int band, int max_rows,
                                                int* smax_out) {
  int smax = sub4[0], smin = sub4[0];
#pragma unroll
  for (int i = 1; i < 16; ++i) {
    smax = max(smax, sub4[i]);
    smin = min(smin, sub4[i]);
  }
  *smax_out = smax;
  return gap_e >= 0 && gap_oe >= 0 && y_drop >= 0 && y_drop < (1 << 28) &&
         smax <= (1 << 16) && smin >= -(1 << 16) &&
         (long long)gap_oe + (long long)(max_rows + band) * gap_e <
             (1 << 28);
}

// C(r, 0): 0 at r == 0, else the vertical-gap boundary, y-drop masked
__device__ __forceinline__ int vcol0(int r, int gap_e, int gap_oe,
                                     int neg_y) {
  const int v = r == 0 ? 0 : wsub(wsub(0, gap_oe), wmul(r - 1, gap_e));
  return (v >= neg_y && r >= 0) ? v : NEG;
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
  // the early stop's proof needs sums that never wrap (see stop_ok)
  int smax;
  const bool can_stop = gaps_stay_small(sub4, gap_e, gap_oe, y_drop, band,
                                        max_rows, &smax);

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

// K3b at strip width S (band = 32 S): one warp per anchor, lane j owns
// DP columns j S .. j S + S - 1 and sweeps the rows over them.  Up to
// S = 16 two CTAs share an SM (at most 128 registers a thread).
template <int S>
__global__ void __launch_bounds__(K3_WARPS * 32, S <= 16 ? 2 : 1)
    ydrop_band_kernel(const int* __restrict__ codes1,
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
  // this warp's substitution planes [5][S][32] (codes 0, 1, 2, the rest,
  // an off-grid row) and rows of best [S][32]: a lane touches only its
  // own slots, so no barrier is needed
  int* s_plane = s_dyn + warp * 6 * band;
  int* s_rob = s_plane + 5 * band;

  // only row 0 of params is read: the gaps and the y-drop are uniform
  const int gap_e = params[0], gap_oe = params[1], y_drop = params[2];
  const int neg_y = wsub(0, y_drop);
  const int* c1 = codes1 + b * max_rows;
  const int* c2 = codes2 + b * band;
  // the early stop's proof needs sums that never wrap, scores included
  int smax;
  const bool can_stop =
      gaps_stay_small(sub4, gap_e, gap_oe, y_drop, band, max_rows, &smax) &&
      (long long)max_rows * max(smax, 0) < (1 << 28);

  // column state: C of the row above (first the row-0 boundary c_first),
  // D, the running best; g = t + goff[k] (goff = c gap_e - gap_oe), and
  // I = max(NEG, max of g to the left) - c gap_e + gap_e, which is that
  // max - goff[k] + (gap_e - gap_oe) in wrapping int32
  const int ge_goe = wsub(gap_e, gap_oe);
  int cprev[S], dprev[S], best[S], goff[S];
  unsigned vmask = 0;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int c = lane * S + k;
    const int code2 = c >= 1 ? __ldg(c2 + c - 1) : -1;
    const bool valid = c >= 1 && code2 >= 0;
    vmask |= (unsigned)valid << k;
    const int bcode = min(max(code2, 0), 3);
#pragma unroll
    for (int a = 0; a < 4; ++a)
      s_plane[(a * S + k) * 32 + lane] =
          valid ? __ldg(sub4 + a * 4 + bcode) : NEG_HALF;
    s_plane[(4 * S + k) * 32 + lane] = NEG_HALF;
    int v = c == 0 ? 0 : wsub(wsub(0, gap_oe), wmul(c - 1, gap_e));
    v = v >= neg_y ? v : NEG;
    cprev[k] = (valid || c == 0) ? v : NEG;
    dprev[k] = NEG;
    best[k] = 0;
    s_rob[k * 32 + lane] = 0;
    goff[k] = wsub(wmul(c, gap_e), gap_oe);
  }

  int next = lane < max_rows ? __ldg(c1 + lane) : -1;
  for (int r0 = 0; r0 < max_rows; r0 += 32) {
    const int grp = next;  // codes of rows r0 .. r0 + 31, one a lane
    next = r0 + 32 + lane < max_rows ? __ldg(c1 + r0 + 32 + lane) : -1;
    const int n = min(32, max_rows - r0);
    for (int i = 0; i < n; ++i) {
      const int r = r0 + i;
      const int a = __shfl_sync(kFullMask, grp, i);
      const int* pl = s_plane + (a < 0 ? 4 : a < 3 ? a : 3) * S * 32 + lane;
      // C(r - 1, j S - 1): lane j - 1's last column; column 0's pad NEG
      int cin = __shfl_up_sync(kFullMask, cprev[S - 1], 1);
      if (lane == 0) cin = NEG;
      // D and t, and g's running max along the strip (ex: to the left)
      int t[S], ex[S];
      int run = NEG;
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const int diag = k ? cprev[k - 1] : cin;
        const int d = max(wsub(dprev[k], gap_e), wsub(cprev[k], gap_oe));
        t[k] = max(wadd(diag, pl[k * 32]), d);
        dprev[k] = d;
        ex[k] = run;
        run = max(run, wadd(t[k], goff[k]));
      }
      // the strips' totals: inclusive max-scan over the lanes, identity
      // NEG, shifted in as each lane's exclusive prefix
      int x = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFullMask, x, o);
        if (lane >= o) x = max(x, y);
      }
      int pre = __shfl_up_sync(kFullMask, x, 1);
      if (lane == 0) pre = NEG;
#pragma unroll
      for (int k = 0; k < S; ++k) {
        int c = max(t[k], wadd(wsub(max(pre, ex[k]), goff[k]), ge_goe));
        const bool keep = ((vmask >> k) & 1u) && c >= wsub(best[k], y_drop);
        c = keep ? c : NEG;
        if (c >= best[k]) {
          best[k] = c;
          s_rob[k * 32 + lane] = r;
        }
        cprev[k] = c;
      }
    }
    // the stop test on the group's last row (r0 + 31): every cell pruned
    if (can_stop && n == 32) {
      int m = cprev[0];
#pragma unroll
      for (int k = 1; k < S; ++k) m = max(m, cprev[k]);
      if (!__any_sync(kFullMask, m != NEG)) break;
    }
  }

  // latest row at the maximum, then the largest column
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
    if (best[k] == top && s_rob[k * 32 + lane] == end_row) ec = lane * S + k;
  const int end_col = __reduce_max_sync(kFullMask, ec);
  const int4 v = lane == 0 ? make_int4(top, max(end_row, 0),
                                       max(end_col, 0), 0)
                           : make_int4(0, 0, 0, 0);
  reinterpret_cast<int4*>(out + b * 128)[lane] = v;
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

template <int S>
int launch_band(const int* codes1, const int* codes2, const int* sub4,
                const int* params, int* out, int B, int max_rows,
                cudaStream_t stream) {
  const int shm = K3_WARPS * 6 * 32 * S * (int)sizeof(int);
  if (shm > 48 * 1024)
    cudaFuncSetAttribute(ydrop_band_kernel<S>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, shm);
  ydrop_band_kernel<S>
      <<<(B + K3_WARPS - 1) / K3_WARPS, K3_WARPS * 32, shm, stream>>>(
          codes1, codes2, sub4, params, out, B, max_rows);
  return (int)cudaGetLastError();
}

using Launch = int (*)(const int*, const int*, const int*, const int*, int*,
                       int, int, cudaStream_t);

// one instantiation for every strip width the contract allows, 1 to 32
template <int... I>
constexpr std::array<Launch, sizeof...(I)> wavefront_table(
    std::integer_sequence<int, I...>) {
  return {&launch_wavefront<I + 1>...};
}
template <int... I>
constexpr std::array<Launch, sizeof...(I)> band_table(
    std::integer_sequence<int, I...>) {
  return {&launch_band<I + 1>...};
}
constexpr auto kWavefront =
    wavefront_table(std::make_integer_sequence<int, 32>{});
constexpr auto kBand = band_table(std::make_integer_sequence<int, 32>{});

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
  return kBand[band / 32 - 1](codes1, codes2, sub4, params, out, B,
                              max_rows, (cudaStream_t)stream);
}
