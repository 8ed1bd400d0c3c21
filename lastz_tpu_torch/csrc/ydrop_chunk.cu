// K1 on Hopper: the exact, resumable one-sided y-drop chunk with one
// traceback link byte per cell.
//
// Replaces lastz_tpu/ops/ydrop_pallas_exact.py::_kernel (launched by
// ydrop_chunk_pallas); computes what ops/ydrop_exact.ydrop_chunk_plain
// computes, state for state and link byte for link byte.
//
// What bounds it on an H100: latency.  A DP row depends on the one
// before it, and a chunk is up to 1024 rows of one lane, so a launch
// lasts as long as its slowest lane's chain of rows.  A row's work is
// small (about 20 integer operations and one link byte per band cell,
// a few hundred cells) and its bytes fewer still; its time is the
// length of its dependent chain.  With one warp per lane nothing hides
// that chain: each row costs a fixed part (three warp scans of six
// dependent shuffles, the row reductions, the scalar tail) plus, per
// tile, work that grows with the columns each thread holds.  So the
// design shortens the chain: no block barrier, and only the band's
// columns.  The earlier design swept the whole window with 16 warps
// and nine block barriers a row.  k1_bench.py times the two side by
// side; PERF.md has the numbers.
//
// The design:
//
// * One warp per DP lane and one lane per CTA: at the main path's 128
//   lanes one warp on each of 128 SMs.  Every scan is a __shfl_up_sync
//   warp scan and every row reduction a __reduce_*_sync, so the kernel
//   has no block barrier at all.  Four lanes per CTA (a warp on each
//   SM sub-partition) ran slower on an H100, since the warps share no
//   state and each has its own scheduler either way (PERF.md).
// * Only the live band.  A row touches the columns it can change:
//   [LYr, RYr), the prolongation [RYr, RYr + p) and the sentinel.  The
//   sweep over [LYr, RYr) runs in tiles of 32 x CPT consecutive columns
//   starting at LYr, thread t owning columns t*CPT .. t*CPT + CPT - 1 of
//   the tile.  Each tile runs the two-pass exact row of
//   docs/two_pass_exact_row.md in one go: the reset-free decayed chain
//   (exclusive prefix max), the running best (exclusive prefix max),
//   then the max-with-resets scan for the exact insertion values.  Each
//   scan's running value carries from one tile to the next in a
//   register, so a band of any width up to W works with fixed
//   registers.  CPT is 5 for bands up to 160 columns and 9 (tiles of
//   288) past that; both are odd, so the 32 threads' columns fall on 32
//   different shared-memory banks.  The wide tile is chosen on the main
//   path's launches, where 9 ran faster than 13; a synthetic band of
//   600 columns prefers 13, but no path runs it.  A single width costs
//   the narrow bands dear, and each width is a copy of the tile's code
//   (a lone warp stalls on every miss of the instruction cache), so
//   there are two.
// * No branch in the tile.  A lone warp's latencies hide only behind
//   its own independent instructions, so the tile's columns must
//   interleave; the loads are unconditional (clamped to the band) and
//   every choice is a select (pick(), a PTX selp the compiler cannot
//   turn back into a branch).
// * Row state in shared memory.  CC, DD and the window's b codes live
//   in the lane's shared memory.  The per-column values one pass hands
//   the next (csub, d, the insertion values, the gap and prune flags)
//   stay in registers instead: every scan's prefix for a tile depends
//   only on the tiles left of it, so a tile runs all its passes before
//   the next tile starts, and no pass needs a column of another tile.
//   A tile reads its columns' old CC and DD before it writes any; the
//   left neighbour's old CC comes by shuffle, and the tile's first
//   column gets the previous tile's last old CC from a carried
//   register, so the in-place write never feeds a read of the same
//   row.  __syncwarp orders one row's shared writes before the next
//   row's reads (their tiles start at another column).
// * One sweep for the reductions.  Each thread keeps (row max, its last
//   column), (boundary max, its last column), the first and last live
//   column; __reduce_*_sync at the row's end give rmax, kbest, bmax,
//   kb, firstl and npk (kbest and kb as the largest column whose value
//   equals the maximum, the plain version's tie rule).  Trimming to the
//   peak, the boundary ones are not taken at all.
// * Band-only link bytes.  Each link byte is stored from the register
//   of its column, only over [LYr, max(RYr + p, sentinel + 1)) clipped
//   to W.  Every other byte is the zero the buffer arrived with: the
//   wrapper hands the kernel a zeroed buffer (ops/ydrop_cuda.ydrop_chunk
//   allocates it with torch.zeros, and its tb_out contract says
//   zeroed).  tb == nullptr is the score-only mode and writes no byte.
// * The plain version sets every column outside a row's written range
//   to NEG.  A band-only row does not, so at the end of the chunk each
//   lane that ran a row writes NEG outside its last row's range; a lane
//   that ran no row keeps its re-anchored input.  Inside the range every
//   column was written by that row, and the next row reads only inside
//   it (its [LY, RY) lies in the last row's written range).
// * The scalar tail: (i_exit - thresh) // gapE by a double reciprocal
//   of gapE and one correction step (an integer division by a runtime
//   divisor is a long dependent chain), and the next row's code read a
//   row ahead.
//
// Signed overflow is undefined in CUDA; every sum that the JAX
// version computes in wrapping int32 goes through wadd/wsub/wmul, and
// a floor division goes through floordiv_pos (or floordiv).

#include "common.cuh"

namespace {

using namespace lastz;

constexpr int NARROW_CPT = 5;     // columns per thread of bands <= 160
constexpr int WIDE_CPT = 9;       // and of wider bands, in tiles of 288
constexpr int SMEM_LIMIT = 227 * 1024;
constexpr int SMEM_DEFAULT = 48 * 1024;

constexpr int NEG = -1932735283;
constexpr int SENT32 = -(1 << 30);
constexpr int ISENT = -2080000000;
constexpr int BIG = 1 << 30;

constexpr int C_FROM_C = 0;
constexpr int C_FROM_I = 1;
constexpr int C_FROM_D = 2;
constexpr int I_EXTEND = 4;
constexpr int D_EXTEND = 8;
constexpr int LINK_GAP_D = C_FROM_D | I_EXTEND | D_EXTEND;
constexpr int LINK_GAP_I = C_FROM_I | I_EXTEND | D_EXTEND;
constexpr int ST_WIDTH_OVERFLOW = 1;
constexpr int ST_TRUNCATED = 8;

// per-lane scalar slots (ops/ydrop_exact.SCALAR_KEYS order)
enum {
  S_LY, S_RY, S_ROW, S_BEST, S_END1, S_END2, S_BSCORE, S_BFLAG, S_TBP,
  S_ROWS_USED, S_MAXRY, S_STATUS, S_DONE, NS
};

// shared bytes of one lane: CC, DD and b codes (int), then the chunk's
// row codes (bytes)
__host__ __device__ constexpr int lane_smem_bytes(int W, int rows) {
  return 12 * W + ((rows + 3) & ~3);
}

// Exclusive warp prefix max of the threads' aggregates `v`, continuing
// from `carry` (the max over every earlier tile); advances `carry` past
// this tile.  __shfl_up_sync hands lanes below the offset their own
// value, which max leaves unchanged, so no lane test is needed.
__device__ __forceinline__ int warp_excl_max(int v, int& carry) {
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1)
    x = max(x, __shfl_up_sync(kFullMask, x, o));
  const int ex = __shfl_up_sync(kFullMask, x, 1);
  const int tot = __shfl_sync(kFullMask, x, 31);
  const int pre = (threadIdx.x & 31) ? max(carry, ex) : carry;
  carry = max(carry, tot);
  return pre;
}

// Exclusive warp scan of the max-with-resets operator
//   (s1,r1) x (s2,r2) = (r2 ? s2 : max(s1,s2), r1|r2)
// over the threads' aggregates (s, r), continuing from the running
// value `carry` of the earlier tiles; returns the s part and advances
// `carry` past this tile.  (A lane's own pair is the operator's fixed
// point, so lanes below the offset need no test either.)
__device__ __forceinline__ int warp_excl_reset(int s, int r, int& carry) {
  int xs = s, xr = r;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int ys = __shfl_up_sync(kFullMask, xs, o);
    const int yr = __shfl_up_sync(kFullMask, xr, o);
    xs = xr ? xs : max(ys, xs);
    xr = xr | yr;
  }
  const int es = __shfl_up_sync(kFullMask, xs, 1);
  const int er = __shfl_up_sync(kFullMask, xr, 1);
  const int ts = __shfl_sync(kFullMask, xs, 31);
  const int tr = __shfl_sync(kFullMask, xr, 31);
  const int pre = (threadIdx.x & 31) ? (er ? es : max(carry, es)) : carry;
  carry = tr ? ts : max(carry, ts);
  return pre;
}

// n // d for d > 0 through inv = 1.0 / d: for |n| < 2^31 the product is
// within 2^-20 of n / d, so one correction step makes the floor exact.
// A division by a runtime divisor is a long dependent chain; this is
// three.
__device__ __forceinline__ int floordiv_pos(int n, int d, double inv) {
  const int q = (int)floor((double)n * inv);
  const long long r = (long long)n - (long long)q * d;
  return q + (r >= d) - (r < 0);
}

// What every thread of a lane's warp holds alike for one row.
struct Row {
  const int* srow;  // the row's line of the score table
  int LYr, cend;    // live columns [max(LYr, 0), cend)
  int ci;           // the column whose reset-scan value gives i_exit
  int best;         // best score before the row
  int colN;         // the column at the sequence end: b_off + l == N
  int rowM;         // 1: the row is the last one (row == M)
  int gap_e, gap_oe, y_drop;
};

// What a row's sweep carries from tile to tile, and hands the row's end:
// the old CC of the column left of the tile, the three scans' running
// values, the reset scan's value at column ci (in its owner thread),
// and each thread's share of the row reductions.
struct Sweep {
  int car_cc, car1, car2, car3, iex;
  int rt, kt, bt, kbt, fl, npt;
  int ael, ab;  // 1: some cell is eligible / a boundary cell
};

// p ? a : b for p in {0, 1}, as one select.  Left to itself the
// compiler turns chains of ?: in the tile into branches, and a branch
// ends the stretch in which it can interleave independent columns.
__device__ __forceinline__ int pick(int p, int a, int b) {
#ifdef __CUDA_ARCH__
  int r;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.s32 q, %1, 0;\n\t"
      "selp.b32 %0, %2, %3, q;\n\t}"
      : "=r"(r)
      : "r"(p), "r"(a), "r"(b));
  return r;
#else
  return p ? a : b;
#endif
}

// One tile of 32 x CPT consecutive columns from `base`; thread t owns
// base + t*CPT .. base + t*CPT + CPT - 1.  Columns at or past cend (only
// in the band's last tile) count as pruned: they write nothing, enter
// no reduction, and the scan values they leave behind are read by no
// live column.  The body has no branch, so the compiler can interleave
// the columns' independent work: a lone warp has no other warp to hide
// its latencies behind.
template <int CPT, bool TRIM>
__device__ __forceinline__ void sweep_tile(int base, const Row& x, Sweep& a,
                                           int* s_cc, int* s_dd,
                                           const int* s_bc,
                                           unsigned char* tbrow) {
  const int wl = threadIdx.x & 31;
  const int cb = base + wl * CPT;
  const int lge0 = wmul(cb, x.gap_e);
  const int last = x.cend - 1;  // an in-band column: a safe address
  int cold[CPT], d[CPT], csub[CPT], eff[CPT], iff[CPT], es[CPT];
  int g[CPT], pr[CPT];  // 0 or 1: gap cell, pruned (or past cend)
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int lc = min(cb + c, last);
    cold[c] = s_cc[lc];
    d[c] = s_dd[lc];
    csub[c] = s_bc[lc];
  }
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int act = cb + c < x.cend;
    csub[c] = x.srow[csub[c]];  // the cell's score; csub below
    cold[c] = pick(act, cold[c], NEG);
    d[c] = pick(act, d[c], NEG);
  }
  // old CC of column l - 1: own register, the left thread's last, or
  // the previous tile's last (read before this tile wrote anything)
  const int left = __shfl_up_sync(kFullMask, cold[CPT - 1], 1);
  const int prev0 = wl ? left : a.car_cc;
  a.car_cc = __shfl_sync(kFullMask, cold[CPT - 1], 31);
  int tmax = ISENT;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int l = cb + c;
    const int lge = wadd(lge0, c * x.gap_e);
    const int prev = c ? cold[c - 1] : prev0;
    csub[c] = pick(l < x.cend && l > x.LYr, wadd(prev, csub[c]), NEG);
    eff[c] = pick(d[c] <= csub[c],
                  wadd(wsub(csub[c], x.gap_oe), wadd(lge, x.gap_e)), ISENT);
    tmax = max(tmax, eff[c]);
  }

  // pass 1: reset-free decayed chain -> gap / prune decisions
  int acc = warp_excl_max(tmax, a.car1);
  tmax = SENT32;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int lge = wadd(lge0, c * x.gap_e);
    const int sff = acc;
    acc = max(acc, eff[c]);
    iff[c] = max(wsub(sff, lge), NEG);
    g[c] = (d[c] > csub[c]) | (iff[c] > csub[c]);
    tmax = max(tmax, pick(g[c], SENT32, csub[c]));
  }
  acc = warp_excl_max(tmax, a.car2);
  int ts = ISENT, tr = 0;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int lge = wadd(lge0, c * x.gap_e);
    const int bb = max(x.best, acc);
    acc = max(acc, pick(g[c], SENT32, csub[c]));
    const int cand = max(max(csub[c], d[c]), iff[c]);
    pr[c] = (cb + c >= x.cend) | (cand < wsub(bb, x.y_drop));
    // pass 2 operands: a pruned cell resets the insertion chain
    const int comp = wadd(lge, x.gap_e);
    const int seed = pick(g[c], ISENT, wadd(wsub(csub[c], x.gap_oe), comp));
    es[c] = pick(pr[c], wadd(NEG, comp), seed);
    ts = pick(pr[c], es[c], max(ts, es[c]));
    tr |= pr[c];
  }

  // pass 2: one reset scan -> exact insertion values for the links
  acc = warp_excl_reset(ts, tr, a.car3);
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int l = cb + c;
    const int lge = wadd(lge0, c * x.gap_e);
    const int sexcl = (c == 0 && l == 0) ? NEG : acc;
    acc = pick(pr[c], es[c], max(acc, es[c]));
    a.iex = pick(l == x.ci, acc, a.iex);
    const int ivec = wsub(sexcl, lge);
    const int copen = wsub(csub[c], x.gap_oe);
    const int ddec = wsub(d[c], x.gap_e);
    const int idec = wsub(ivec, x.gap_e);
    const int lk_gap = pick(d[c] >= ivec, LINK_GAP_D, LINK_GAP_I);
    const int lk_sub = C_FROM_C | pick(copen > ddec, 0, D_EXTEND) |
                       pick(copen > idec, 0, I_EXTEND);
    const int lk = pick(pr[c], 0, pick(g[c], lk_gap, lk_sub));
    const int ccn = pick(pr[c], NEG, pick(g[c], max(d[c], ivec), csub[c]));
    const int ddn = pick(pr[c], NEG, pick(g[c], ddec, max(copen, ddec)));
    if (l < x.cend) {
      s_cc[l] = ccn;
      s_dd[l] = ddn;
    }
    if (l < x.cend && tbrow) tbrow[l] = (unsigned char)lk;
    const int live = pr[c] ^ 1;
    const int elig = live & (g[c] ^ 1);
    a.fl = min(a.fl, pick(live, l, BIG));
    a.npt = pick(live, l, a.npt);
    const int up = elig & (csub[c] >= a.rt);
    a.rt = pick(up, csub[c], a.rt);
    a.kt = pick(up, l, a.kt);
    a.ael |= elig;
    if (!TRIM) {
      const int atb = elig & (x.rowM | (l == x.colN));
      const int upb = atb & (csub[c] >= a.bt);
      a.bt = pick(upb, csub[c], a.bt);
      a.kbt = pick(upb, l, a.kbt);
      a.ab |= atb;
    }
  }
}

// The row's sweep over [c0, cend) in tiles of 32 x CPT columns; returns
// the reset scan's value at column ci (the last swept column).
template <int CPT, bool TRIM>
__device__ __forceinline__ int sweep_band(int c0, const Row& x, Sweep& a,
                                          int* s_cc, int* s_dd,
                                          const int* s_bc,
                                          unsigned char* tbrow) {
  constexpr int TILE = 32 * CPT;
  for (int base = c0; base < x.cend; base += TILE)
    sweep_tile<CPT, TRIM>(base, x, a, s_cc, s_dd, s_bc, tbrow);
  return __shfl_sync(kFullMask, a.iex, ((x.ci - c0) % TILE) / CPT);
}

// The band's sweep: one tile of 5 columns per thread (160 columns), or
// tiles of 9 (288).
template <bool TRIM>
__device__ __forceinline__ int sweep(int c0, int width, const Row& x,
                                     Sweep& a, int* s_cc, int* s_dd,
                                     const int* s_bc, unsigned char* tbrow) {
  return width <= 32 * NARROW_CPT
             ? sweep_band<NARROW_CPT, TRIM>(c0, x, a, s_cc, s_dd, s_bc, tbrow)
             : sweep_band<WIDE_CPT, TRIM>(c0, x, a, s_cc, s_dd, s_bc, tbrow);
}

template <bool TRIM>
__global__ void __launch_bounds__(32)
ydrop_chunk_kernel(const int* __restrict__ a_small,
                   const int* __restrict__ b_small,
                   const int* __restrict__ b_off_a,
                   const int* __restrict__ shift_a,
                   const int* __restrict__ M_a, const int* __restrict__ N_a,
                   int* __restrict__ CCg, int* __restrict__ DDg,
                   int* __restrict__ sc, const int* __restrict__ subsmall,
                   unsigned char* __restrict__ tb, long long tb_lane_stride,
                   int W, int rows, int gap_e, int gap_oe, int y_drop,
                   int tb_cap, int tail) {
  extern __shared__ int smem[];
  __shared__ int s_sub[256];

  const int wl = threadIdx.x;
  const int lane_id = blockIdx.x;
  for (int i = wl; i < 256; i += 32) s_sub[i] = subsmall[i];

  int* s_cc = smem;
  int* s_dd = s_cc + W;
  int* s_bc = s_dd + W;
  unsigned char* s_ar = reinterpret_cast<unsigned char*>(s_bc + W);

  int* scl = sc + (long long)lane_id * NS;
  int LY = scl[S_LY], RY = scl[S_RY], row = scl[S_ROW];
  int best = scl[S_BEST], end1 = scl[S_END1], end2 = scl[S_END2];
  int bscore = scl[S_BSCORE], bflag = scl[S_BFLAG], tbp = scl[S_TBP];
  int rows_used = scl[S_ROWS_USED], maxRY = scl[S_MAXRY];
  int status = scl[S_STATUS], done = scl[S_DONE];
  const int b_off = b_off_a[lane_id];
  const int M = M_a[lane_id];
  const int N = N_a[lane_id];
  const int sh = min(max(shift_a[lane_id], 0), W);

  int* ccl = CCg + (long long)lane_id * W;
  int* ddl = DDg + (long long)lane_id * W;
  const int* bl = b_small + (long long)lane_id * W;

  // window re-anchor: lane l takes old lane l + shift, NEG past the end
  for (int l = wl; l < W; l += 32) {
    const int src = l + sh;
    s_cc[l] = src < W ? ccl[src] : NEG;
    s_dd[l] = src < W ? ddl[src] : NEG;
    s_bc[l] = bl[l] & 15;
  }
  for (int i = wl; i < rows; i += 32)
    s_ar[i] = (unsigned char)(a_small[(long long)lane_id * rows + i] & 15);
  __syncwarp();  // the score table, window and row codes precede any row

  unsigned char* tbl = tb ? tb + (long long)lane_id * tb_lane_stride
                          : nullptr;
  const double inv_ge = gap_e > 0 ? 1.0 / gap_e : 0.0;
  int stopped = done;
  bool ran = false;
  int lo_w = 0, hi_w = 0;  // the last row's written range

  int acode = s_ar[0];
  for (int r = 0; r < rows; ++r) {
    if (stopped) break;
    // truncation check (gapped_extend.c:3621-3660): break BEFORE the row
    if (wadd(tbp, wadd(max(wsub(RY, LY), 0), tail)) >= tb_cap) {
      status |= ST_TRUNCATED;
      done = 1;
      break;
    }
    unsigned char* tbrow = tbl ? tbl + (long long)(r + 1) * W : nullptr;
    Row x;
    x.srow = s_sub + acode * 16;
    acode = s_ar[min(r + 1, rows - 1)];  // read a row ahead
    x.LYr = wsub(LY, b_off);
    const int RYr = wsub(RY, b_off);
    x.cend = min(RYr, W);
    x.ci = min(max(wsub(RYr, 1), 0), W - 1);
    x.best = best;
    x.colN = wsub(N, b_off);
    x.rowM = row == M;
    x.gap_e = gap_e;
    x.gap_oe = gap_oe;
    x.y_drop = y_drop;
    const int c0 = max(x.LYr, 0);
    Sweep a;
    a.car_cc = NEG;
    a.car1 = ISENT;
    a.car2 = SENT32;
    // reset scan: column c0 - 1 < LYr is a reset to NEG + c0 * gapE
    a.car3 = c0 > 0 ? wadd(NEG, wmul(c0, gap_e)) : ISENT;
    a.iex = ISENT;
    a.rt = SENT32;
    a.kt = -1;
    a.bt = SENT32;
    a.kbt = -1;
    a.fl = BIG;
    a.npt = -1;
    a.ael = 0;
    a.ab = 0;

    // the sweep over the band
    const int width = x.cend - c0;
    int i_exit_raw;
    if (width <= 0) {
      // no live column: ci lies left of LYr (a reset) or is inactive
      i_exit_raw = x.ci < x.LYr ? wadd(NEG, wmul(x.ci + 1, gap_e)) : ISENT;
    } else {
      i_exit_raw = sweep<TRIM>(c0, width, x, a, s_cc, s_dd, s_bc, tbrow);
    }

    // row reductions: the maxima, then the last column reaching each
    // (trimming to the peak, no cell is a boundary cell)
    const int rmax = __reduce_max_sync(kFullMask, a.rt);
    const int bmax = TRIM ? SENT32 : __reduce_max_sync(kFullMask, a.bt);
    const int firstl = __reduce_min_sync(kFullMask, a.fl);
    const int npk = __reduce_max_sync(kFullMask, a.npt);
    const bool anyel = __any_sync(kFullMask, a.ael);
    const bool anyb = TRIM ? false : __any_sync(kFullMask, a.ab);
    const int kbest = __reduce_max_sync(kFullMask, a.rt == rmax ? a.kt : -1);
    const int kb =
        TRIM ? -1 : __reduce_max_sync(kFullMask, a.bt == bmax ? a.kbt : -1);

    // best / end / boundary (the boundary update runs after best
    // within a cell, so it wins at or past the best column)
    const bool fires_best = anyel && rmax >= best;
    const bool fires_b = anyb && bmax >= bscore;
    const bool use_b = fires_b && (!fires_best || kb >= kbest);
    const bool use_best = fires_best && !use_b;
    if (use_b || use_best) end1 = row;
    if (use_b) {
      end2 = wadd(b_off, kb);
      bflag = 1;
    } else if (use_best) {
      end2 = wadd(b_off, kbest);
      bflag = 0;
    }
    if (fires_best) best = rmax;
    if (fires_b) bscore = bmax;

    // LY advance, RY shrink or prolongation (host ydrop.py:538-559)
    const int first_live = firstl != BIG ? firstl : RYr;
    const int LYn = wadd(b_off, first_live);
    const int np_col = wadd(b_off, npk);
    const bool dead = LYn >= RY;
    const int K = wsub(RY, LY);
    const int i_exit = wsub(i_exit_raw, wmul(RYr, gap_e));
    const bool shrink = RY > wadd(np_col, 1);
    const int thresh = wsub(best, y_drop);
    const int p_raw =
        gap_e > 0 ? wadd(floordiv_pos(wsub(i_exit, thresh), gap_e, inv_ge), 1)
        : gap_e ? wadd(floordiv(wsub(i_exit, thresh), gap_e), 1)
                : BIG;
    const int p_hi = max(wsub(wadd(N, 1), RY), 0);
    const int p = (shrink || i_exit < thresh) ? 0 : min(max(p_raw, 0), p_hi);
    const int RYs = shrink ? wadd(np_col, 1) : wadd(RY, p);
    const bool has_sent = RYs <= N;
    const int RYf = wadd(RYs, has_sent ? 1 : 0);
    const int sent_l = wsub(RYs, b_off);

    // the written range [lo, hi): the sweep's [c0, cend), then the
    // prolongation [RYr, RYr + p) and the sentinel (at RYr + p unless
    // the band shrank, when it is a pruned column the sweep wrote)
    const int lo = max(min(x.LYr, RYr), 0);
    const int hi = min(max(wadd(RYr, p), has_sent ? wadd(sent_l, 1) : 0), W);
    for (int l = max(RYr, 0) + wl; l < hi; l += 32) {
      const int pj = wsub(l, RYr);
      const bool prolong = pj < p && !(has_sent && l == sent_l);
      const int pro = wsub(i_exit, wmul(pj, gap_e));
      s_cc[l] = prolong ? pro : NEG;
      s_dd[l] = prolong ? wsub(pro, gap_oe) : NEG;
      if (tbrow) tbrow[l] = (unsigned char)(prolong ? C_FROM_I : 0);
    }
    __syncwarp();  // this row's shared writes precede the next row's reads

    const bool window_end = wsub(RYf, b_off) > W;
    const bool width_over = wsub(RYf, LYn) > W || wadd(K, p) > W;
    if (width_over && !dead) status |= ST_WIDTH_OVERFLOW;
    if (dead || row >= M || width_over) done = 1;
    stopped = done || window_end;
    ran = true;
    lo_w = lo;
    hi_w = hi;
    LY = LYn;
    RY = RYf;
    rows_used = row;
    row = wadd(row, 1);
    tbp = wadd(wadd(tbp, K), p);
    maxRY = max(maxRY, RYf);
  }

  // CC/DD out over the whole window: NEG outside the last row's range
  for (int l = wl; l < W; l += 32) {
    const bool outside = ran && (l < lo_w || l >= hi_w);
    ccl[l] = outside ? NEG : s_cc[l];
    ddl[l] = outside ? NEG : s_dd[l];
  }
  if (wl == 0) {
    scl[S_LY] = LY;
    scl[S_RY] = RY;
    scl[S_ROW] = row;
    scl[S_BEST] = best;
    scl[S_END1] = end1;
    scl[S_END2] = end2;
    scl[S_BSCORE] = bscore;
    scl[S_BFLAG] = bflag;
    scl[S_TBP] = tbp;
    scl[S_ROWS_USED] = rows_used;
    scl[S_MAXRY] = maxRY;
    scl[S_STATUS] = status;
    scl[S_DONE] = done;
  }
}

template <bool TRIM>
int launch(const int* a_small, const int* b_small, const int* b_off,
           const int* shift, const int* M, const int* N, int* CC, int* DD,
           int* sc, const int* subsmall, unsigned char* tb,
           long long tb_lane_stride, int B, int W, int rows, int gap_e,
           int gap_oe, int y_drop, int tb_cap, int tail,
           cudaStream_t stream) {
  const long long shm = lane_smem_bytes(W, rows);
  if (shm > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (shm > SMEM_DEFAULT) {
    const cudaError_t e = cudaFuncSetAttribute(
        ydrop_chunk_kernel<TRIM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
    if (e != cudaSuccess) return (int)e;
  }
  // one CTA of one warp per lane
  ydrop_chunk_kernel<TRIM><<<B, 32, (size_t)shm, stream>>>(
      a_small, b_small, b_off, shift, M, N, CC, DD, sc, subsmall, tb,
      tb_lane_stride, W, rows, gap_e, gap_oe, y_drop, tb_cap, tail);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch one chunk for B lanes on `stream`.  CC/DD (B, W) and sc
// (B, 13) are updated in place; tb (lane stride tb_lane_stride, row
// stride W) must arrive zeroed, since only the band's bytes are
// written, and may be null.  Returns the cudaGetLastError() code of
// the launch.
extern "C" int ydrop_chunk_launch(
    const int* a_small, const int* b_small, const int* b_off,
    const int* shift, const int* M, const int* N, int* CC, int* DD,
    int* sc, const int* subsmall, unsigned char* tb,
    long long tb_lane_stride, int B, int W, int rows, int gap_e,
    int gap_oe, int y_drop, int trim_to_peak, int tb_cap, int tail,
    void* stream) {
  if (B <= 0 || W <= 0 || W > 2048 || rows <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return trim_to_peak
             ? launch<true>(a_small, b_small, b_off, shift, M, N, CC, DD,
                            sc, subsmall, tb, tb_lane_stride, B, W, rows,
                            gap_e, gap_oe, y_drop, tb_cap, tail, st)
             : launch<false>(a_small, b_small, b_off, shift, M, N, CC, DD,
                             sc, subsmall, tb, tb_lane_stride, B, W, rows,
                             gap_e, gap_oe, y_drop, tb_cap, tail, st);
}
