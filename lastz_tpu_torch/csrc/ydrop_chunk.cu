// K1 on Hopper: the exact, resumable one-sided y-drop chunk with one
// traceback link byte per cell.
//
// Replaces lastz_tpu/ops/ydrop_pallas_exact.py::_kernel (launched by
// ydrop_chunk_pallas); computes what ops/ydrop_exact.ydrop_chunk_plain
// computes, state for state and link byte for link byte.
//
// A second entry point, ydrop_mega_launch, replaces the device
// while_loop of ydrop_mega_pallas (lastz_tpu/ops/ydrop_pallas_exact.py
// :434): each lane's CTA runs its chunks back to back through the same
// row body (run_chunk), gathering each chunk's codes itself, so a batch
// of lanes costs one launch and no host read between chunks, and a
// lane waits on no other lane between chunks.  It computes what
// ops/ydrop_exact.ydrop_mega_plain computes.
//
// What bounds it on an H100: latency.  A DP row depends on the one
// before it, and a lane runs thousands of rows in a launch (the main
// path's longest lane 5,600 to 6,800), so a launch lasts as long as its
// longest lane's chain of rows.  A row's work is small (about 20
// integer operations and one link byte per band cell, a few hundred
// cells) and its bytes fewer still; its time is the length of its
// dependent chain.  kernel_bench.py --census measured that chain on
// the main path (PERF.md): bands of 409 columns at the median, 572 at
// p90, 722 at most; with one warp a lane, in tiles of 288 columns, a
// row took about 2,900 cycles a tile, 64% of it the tile's own work
// (loads, score lookups, the passes' column arithmetic), 22% its three
// warp scans, and 3 to 4% each the row reductions, the scalar tail,
// the link stores and the prolongation.  So the design puts the SM's
// four sub-partitions on one lane's band.
//
// The design:
//
// * One lane per CTA, four warps (128 threads), at the main path's 128
//   lanes one CTA on each of 128 SMs, so each of an SM's four schedulers
//   issues for the same lane.  A row's band [c0, cend) is cut into
//   tiles of 32 x CPT consecutive columns, thread t of a tile owning
//   columns t*CPT .. t*CPT + CPT - 1, and the tiles are dealt to the
//   warps in rounds of four: tile 4k + w is warp w's in round k.  A band
//   of up to 160 columns is one tile of CPT 5 on warp 0 alone (no
//   exchange at all); a wider one takes the least CPT of 3, 5 and 9
//   whose four tiles cover it (384, 640 columns; past 640, tiles of 288
//   in rounds of 1152), so the main path's rows take one round, three
//   or four warps each holding 3 or 5 columns a thread.  The three CPTs
//   are odd, so a warp's 32 threads fall on 32 different shared-memory
//   banks.
// * Each tile runs the two-pass exact row of docs/two_pass_exact_row.md
//   in one go: the reset-free decayed chain (exclusive prefix max), the
//   running best (exclusive prefix max), then the max-with-resets scan
//   for the exact insertion values.  Each scan is associative, so a warp
//   scans its tile with __shfl_up_sync and the warps of a round combine
//   their tile totals through shared memory: every warp writes its
//   total, the round's warps meet at one named barrier (bar.sync 1,
//   32 x warps), and each warp folds the totals of the warps left of it
//   into its carry, and all of them into the next round's.  A barrier
//   was chosen over a flag chain (decoupled look-back): the main path's
//   rows have one round of three or four tiles of equal work, so the
//   warps reach the exchange together and a flag chain would serialise
//   the carries for nothing.
// * No branch in the tile.  A warp's latencies hide only behind its own
//   independent instructions, so the tile's columns must interleave; the
//   loads are unconditional (clamped to the band) and every choice is a
//   select (pick(), a PTX selp the compiler cannot turn back into a
//   branch).
// * Row state in shared memory.  CC, DD and the window's b codes live
//   in the lane's shared memory.  The per-column values one pass hands
//   the next (csub, d, the insertion values, the gap and prune flags)
//   stay in registers: every scan's prefix for a tile depends only on
//   the tiles left of it, so a tile runs all its passes before its warp
//   takes its next tile, and no pass needs a column of another tile.
//   The in-place writes stay sound across warps: a tile reads its
//   columns' old CC and DD, and the old CC of the column left of it,
//   before its round's first barrier, and writes its columns only after
//   the third, so no write of the round feeds a read of it.  A round's
//   first tile takes that left column's old CC from the round before,
//   whose last tile handed it over with its scan-1 total.  Columns of
//   later rounds lie right of every column written before.  Each row
//   ends with one block barrier, before the row reductions are read,
//   which also orders its tiles' writes before the next row's reads (at
//   other columns, on other warps).  The prolongation [RYr, RYr + p)
//   is not written to shared memory row by row: the next row computes
//   those columns' CC and DD as it loads them (Pro), from the three
//   scalars every thread holds, and the chunk's end writes the last
//   row's.
// * The row reductions.  Each thread keeps (row max, its last column),
//   (boundary max, its last column), the first and last live column;
//   each warp reduces them with __reduce_*_sync, writes them to shared
//   memory, and after the block barrier every thread combines the four
//   warps' entries: the row max is the largest, and its column the
//   largest column among the warps that reach it, so the highest column
//   reaching the row max wins across warps as within one (the plain
//   version's tie rule).  Trimming to the peak, the boundary ones are
//   not taken at all.  The reset scan's value at column ci, the band's
//   last, is written to shared memory by the thread that owns it.
//   Every thread then runs the scalar tail itself, so every warp holds
//   the lane's state and no other handoff is needed; the entries are
//   kept by row parity, so a warp that runs ahead into the next row
//   never overwrites an entry another warp has yet to read.
// * What the measurements showed (PERF.md): the main path's row fell
//   from about 4,600 to 3,100 cycles, and its breakdown is now scans
//   (with their exchanges) 40%, tile work 36%, row reductions 11%, the
//   tail 6%, the prolongation's link bytes 5% and the tiles' link bytes
//   2%.  Staging the link bytes through shared memory for 16-byte
//   stores was left out: their stores are 2% of a row.
// * Band-only link bytes.  Each link byte is stored from the register
//   of its column, only over [LYr, max(RYr + p, sentinel + 1)) clipped
//   to W.  Every other byte is the zero the buffer arrived with: the
//   wrapper hands the kernel a zeroed buffer (ops/ydrop_cuda.ydrop_chunk
//   allocates it with torch.zeros, and its tb_out contract says
//   zeroed).  tb == nullptr is the score-only mode and writes no byte.
// * The plain version sets every column outside a row's written range
//   to NEG.  A band-only row does not, so at the end of the chunk each
//   lane that ran a row writes NEG outside its last row's range (all
//   128 threads, after the row's last barrier); a lane that ran no row
//   keeps its re-anchored input.  Inside the range every column was
//   written by that row, and the next row reads only inside it (its
//   [LY, RY) lies in the last row's written range).
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

constexpr int WARPS = 4;               // warps of a lane's CTA
constexpr int THREADS = 32 * WARPS;
constexpr int CPT_S = 3;  // columns per thread of bands up to 4 x 96
constexpr int CPT_M = 5;  // up to 4 x 160
constexpr int CPT_L = 9;  // wider bands, in rounds of 4 x 288
constexpr int MAX_ROUNDS = 2;  // rounds of a band of up to 2048 columns
static_assert(MAX_ROUNDS * WARPS * 32 * CPT_L >= 2048, "rounds of W");
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

// Inclusive warp prefix max.  __shfl_up_sync hands lanes below the
// offset their own value, which max leaves unchanged, so no lane test
// is needed.
__device__ __forceinline__ int warp_incl_max(int x) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1)
    x = max(x, __shfl_up_sync(kFullMask, x, o));
  return x;
}

// Inclusive warp scan of the max-with-resets operator
//   (s1,r1) x (s2,r2) = (r2 ? s2 : max(s1,s2), r1|r2)
// (a lane's own pair is the operator's fixed point, so lanes below the
// offset need no test either).
__device__ __forceinline__ void warp_incl_reset(int& xs, int& xr) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int ys = __shfl_up_sync(kFullMask, xs, o);
    const int yr = __shfl_up_sync(kFullMask, xr, o);
    xs = xr ? xs : max(ys, xs);
    xr = xr | yr;
  }
}

// The barrier of a round's nw warps (warps 0 .. nw - 1).
__device__ __forceinline__ void round_sync(int nw) {
  asm volatile("bar.sync 1, %0;" ::"r"(nw * 32) : "memory");
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

// The bench's row profile (kernel_bench.py --census), kept only by the
// PROF instantiation of the mega kernel, whose C entry point exists only
// where the source is built with -DLASTZ_K1_PROFILE: clock64 reads of
// warp 0 at a row's phase boundaries, summed by phase, and each row's
// band width and cycles.  The production instantiation (PROF false)
// reads no clock.
enum { P_TILE, P_SCAN, P_STORE, P_RED, P_TAIL, P_PROL, NPHASE };

struct RowProf {
  long long t0, t;        // the row's first clock, the last mark
  long long ph[NPHASE];   // cycles of each phase over the lane's rows
  int* row_w;             // each row's band width (cend - c0)
  int* row_c;             // and its cycles
  int n, cap;             // rows recorded, room
};

template <bool PROF>
__device__ __forceinline__ void mark(RowProf& p, int phase) {
  if constexpr (PROF) {
    const long long u = clock64();
    p.ph[phase] += u - p.t;
    p.t = u;
  }
}

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

// The last row's prolongation, which no thread writes to shared
// memory before the chunk's end: its columns l >= from hold
// CC = iex - (l - from) * gapE and DD = CC - gapOE while l - from < p,
// and NEG past that (the sentinel).  from == W: none.
struct Pro {
  int from, p, iex;
};

// What every thread of a lane holds alike for one row.
struct Row {
  const int* srow;  // the row's line of the score table
  int LYr, cend;    // live columns [max(LYr, 0), cend)
  int ci;           // the column whose reset-scan value gives i_exit
  int best;         // best score before the row
  int colN;         // the column at the sequence end: b_off + l == N
  int rowM;         // 1: the row is the last one (row == M)
  int gap_e, gap_oe, y_drop;
  Pro q;            // the row before's prolongation
};

// The old CC and DD of column l: shared memory, or the row before's
// prolongation q at and past its first column.
__device__ __forceinline__ void old_cell(const int* s_cc, const int* s_dd,
                                         const Pro& q, int gap_e, int gap_oe,
                                         int l, int& cc, int& dd) {
  const int pj = wsub(l, q.from);
  const int pro = wsub(q.iex, wmul(pj, gap_e));
  const int in = pj < q.p;
  const int fresh = l >= q.from;
  cc = pick(fresh, pick(in, pro, NEG), s_cc[l]);
  dd = pick(fresh, pick(in, wsub(pro, gap_oe), NEG), s_dd[l]);
}

// What a row's sweep carries from round to round, and hands the row's
// end: the old CC of the column left of the round, the three scans'
// running values, and each thread's share of the row reductions.
struct Sweep {
  int car_cc, car1, car2, car3;
  int rt, kt, bt, kbt, fl, npt;
  int ael, ab;  // 1: some cell is eligible / a boundary cell
};


// What a lane's warps exchange in shared memory: each round's tile
// totals of the three scans (scan 1's with the old CC of the tile's
// last column), a slot per round and warp, so that a warp with no tile
// in a round (which meets none of its barriers) never finds its slots
// overwritten; and by row parity each warp's row reductions and the
// reset scan's value at column ci.
struct Xchg {
  int2 s1[MAX_ROUNDS][WARPS];
  int s2[MAX_ROUNDS][WARPS];
  int2 s3[MAX_ROUNDS][WARPS];
  int4 re[2][WARPS][2];  // (rmax, kbest, firstl, npk), (anyel, bmax, kb, anyb)
  int iex[2];
};

// The lane's shared memory: CC, DD and b codes (int), the chunk's row
// codes (bytes), the score table and the warps' exchange.
struct Smem {
  int* cc;
  int* dd;
  int* bc;
  unsigned char* ar;
  const int* sub;
  Xchg* xs;
};

__device__ __forceinline__ Smem carve(int* smem, const int* s_sub, Xchg* xs,
                                      int W) {
  Smem m;
  m.cc = smem;
  m.dd = m.cc + W;
  m.bc = m.dd + W;
  m.ar = reinterpret_cast<unsigned char*>(m.bc + W);
  m.sub = s_sub;
  m.xs = xs;
  return m;
}

// Warp w's tile of round k: 32 x CPT consecutive columns from `base`,
// thread t owning base + t*CPT .. base + t*CPT + CPT - 1, beside the
// tiles of the round's other nw - 1 warps.  Columns at or past cend
// (only in the band's last tile) count as pruned: they write nothing,
// enter no reduction, and the scan values they leave behind are read by
// no live column.  The body has no branch but the exchange's, so the
// compiler can interleave the columns' independent work.
template <int CPT, bool TRIM, bool PROF>
__device__ __forceinline__ void sweep_tile(int base, int k, int w, int nw,
                                           const Row& x, Sweep& a,
                                           const Smem& m, int par,
                                           unsigned char* tbrow,
                                           RowProf& pf) {
  Xchg& xs = *m.xs;
  const int wl = threadIdx.x & 31;
  const int cb = base + wl * CPT;
  const int lge0 = wmul(cb, x.gap_e);
  const int last = x.cend - 1;  // an in-band column: a safe address
  int cold[CPT], d[CPT], csub[CPT], eff[CPT], iff[CPT], es[CPT];
  int g[CPT], pr[CPT];  // 0 or 1: gap cell, pruned (or past cend)
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int lc = min(cb + c, last);
    old_cell(m.cc, m.dd, x.q, x.gap_e, x.gap_oe, lc, cold[c], d[c]);
    csub[c] = m.bc[lc];
  }
  // the old CC left of the tile: from the round before (warp 0), or the
  // last column of warp w - 1's tile, which it writes only after this
  // round's third barrier
  int left_tile = a.car_cc;
  if (w) {
    int dd_;
    old_cell(m.cc, m.dd, x.q, x.gap_e, x.gap_oe, base - 1, left_tile, dd_);
  }
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int act = cb + c < x.cend;
    csub[c] = x.srow[csub[c]];  // the cell's score; csub below
    cold[c] = pick(act, cold[c], NEG);
    d[c] = pick(act, d[c], NEG);
  }
  // old CC of column l - 1: own register, the left thread's last, or
  // the left tile's last
  const int left = __shfl_up_sync(kFullMask, cold[CPT - 1], 1);
  const int prev0 = wl ? left : left_tile;
  const int last_cc = __shfl_sync(kFullMask, cold[CPT - 1], 31);
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
  mark<PROF>(pf, P_TILE);

  // pass 1: reset-free decayed chain -> gap / prune decisions
  int acc;
  {
    const int inc = warp_incl_max(tmax);
    const int ex = __shfl_up_sync(kFullMask, inc, 1);
    int in = a.car1;
    if (nw > 1) {
      if (wl == 31) xs.s1[k][w] = make_int2(inc, last_cc);
      round_sync(nw);
      int tot = a.car1;
#pragma unroll
      for (int j = 0; j < WARPS; ++j) {
        if (j < nw) {
          const int2 t = xs.s1[k][j];
          if (j < w) in = max(in, t.x);
          tot = max(tot, t.x);
          if (j == nw - 1) a.car_cc = t.y;
        }
      }
      a.car1 = tot;
    } else {
      a.car1 = max(a.car1, __shfl_sync(kFullMask, inc, 31));
      a.car_cc = last_cc;
    }
    acc = wl ? max(in, ex) : in;
  }
  mark<PROF>(pf, P_SCAN);
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
  mark<PROF>(pf, P_TILE);
  {
    const int inc = warp_incl_max(tmax);
    const int ex = __shfl_up_sync(kFullMask, inc, 1);
    int in = a.car2;
    if (nw > 1) {
      if (wl == 31) xs.s2[k][w] = inc;
      round_sync(nw);
      int tot = a.car2;
#pragma unroll
      for (int j = 0; j < WARPS; ++j) {
        if (j < nw) {
          const int t = xs.s2[k][j];
          if (j < w) in = max(in, t);
          tot = max(tot, t);
        }
      }
      a.car2 = tot;
    } else {
      a.car2 = max(a.car2, __shfl_sync(kFullMask, inc, 31));
    }
    acc = wl ? max(in, ex) : in;
  }
  mark<PROF>(pf, P_SCAN);
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
  mark<PROF>(pf, P_TILE);

  // pass 2: one reset scan -> exact insertion values for the links
  {
    int ss = ts, sr = tr;
    warp_incl_reset(ss, sr);
    const int es1 = __shfl_up_sync(kFullMask, ss, 1);
    const int er1 = __shfl_up_sync(kFullMask, sr, 1);
    int in = a.car3;
    if (nw > 1) {
      if (wl == 31) xs.s3[k][w] = make_int2(ss, sr);
      round_sync(nw);
      int c3 = a.car3;
#pragma unroll
      for (int j = 0; j < WARPS; ++j) {
        if (j < nw) {
          const int2 t = xs.s3[k][j];
          if (j == w) in = c3;
          c3 = t.y ? t.x : max(c3, t.x);
        }
      }
      a.car3 = c3;
    } else {
      const int ts1 = __shfl_sync(kFullMask, ss, 31);
      const int tr1 = __shfl_sync(kFullMask, sr, 31);
      a.car3 = tr1 ? ts1 : max(a.car3, ts1);
    }
    acc = wl ? (er1 ? es1 : max(in, es1)) : in;
  }
  mark<PROF>(pf, P_SCAN);
  int lks[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int l = cb + c;
    const int lge = wadd(lge0, c * x.gap_e);
    const int sexcl = (c == 0 && l == 0) ? NEG : acc;
    acc = pick(pr[c], es[c], max(acc, es[c]));
    if (l == x.ci) xs.iex[par] = acc;
    const int ivec = wsub(sexcl, lge);
    const int copen = wsub(csub[c], x.gap_oe);
    const int ddec = wsub(d[c], x.gap_e);
    const int idec = wsub(ivec, x.gap_e);
    const int lk_gap = pick(d[c] >= ivec, LINK_GAP_D, LINK_GAP_I);
    const int lk_sub = C_FROM_C | pick(copen > ddec, 0, D_EXTEND) |
                       pick(copen > idec, 0, I_EXTEND);
    lks[c] = pick(pr[c], 0, pick(g[c], lk_gap, lk_sub));
    const int ccn = pick(pr[c], NEG, pick(g[c], max(d[c], ivec), csub[c]));
    const int ddn = pick(pr[c], NEG, pick(g[c], ddec, max(copen, ddec)));
    if (l < x.cend) {
      m.cc[l] = ccn;
      m.dd[l] = ddn;
    }
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
  mark<PROF>(pf, P_TILE);
  if (tbrow) {
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      if (cb + c < x.cend) tbrow[cb + c] = (unsigned char)lks[c];
  }
  mark<PROF>(pf, P_STORE);
}

// The band [c0, c0 + width) in tiles of 32 x CPT columns, dealt to the
// warps in rounds of four; a warp with no tile in a round has none in
// the later ones, and goes to the row's end.
template <int CPT, bool TRIM, bool PROF>
__device__ __forceinline__ void sweep_band(int c0, int width, const Row& x,
                                           Sweep& a, const Smem& m, int par,
                                           unsigned char* tbrow,
                                           RowProf& pf) {
  constexpr int TILE = 32 * CPT;
  const int T = (width + TILE - 1) / TILE;
  const int w = threadIdx.x >> 5;
  for (int k = 0; WARPS * k < T; ++k) {
    const int nw = min(WARPS, T - WARPS * k);
    if (w >= nw) break;
    sweep_tile<CPT, TRIM, PROF>(c0 + (WARPS * k + w) * TILE, k, w, nw, x, a,
                                m, par, tbrow, pf);
  }
}

// The band's sweep: one tile of CPT_M on warp 0 alone for bands up to
// 160 columns (no exchange at all), else tiles of the least CPT whose
// four tiles cover the band.
template <bool TRIM, bool PROF>
__device__ __forceinline__ void sweep(int c0, int width, const Row& x,
                                      Sweep& a, const Smem& m, int par,
                                      unsigned char* tbrow, RowProf& pf) {
  if (width <= 32 * CPT_M)
    sweep_band<CPT_M, TRIM, PROF>(c0, width, x, a, m, par, tbrow, pf);
  else if (width <= WARPS * 32 * CPT_S)
    sweep_band<CPT_S, TRIM, PROF>(c0, width, x, a, m, par, tbrow, pf);
  else if (width <= WARPS * 32 * CPT_M)
    sweep_band<CPT_M, TRIM, PROF>(c0, width, x, a, m, par, tbrow, pf);
  else
    sweep_band<CPT_L, TRIM, PROF>(c0, width, x, a, m, par, tbrow, pf);
}

// A lane's 13 scalars (ops/ydrop_exact.SCALAR_KEYS order).
struct Lane {
  int LY, RY, row, best, end1, end2, bscore, bflag, tbp, rows_used, maxRY,
      status, done;
};

__device__ __forceinline__ Lane load_lane(const int* p) {
  Lane s;
  s.LY = p[S_LY];
  s.RY = p[S_RY];
  s.row = p[S_ROW];
  s.best = p[S_BEST];
  s.end1 = p[S_END1];
  s.end2 = p[S_END2];
  s.bscore = p[S_BSCORE];
  s.bflag = p[S_BFLAG];
  s.tbp = p[S_TBP];
  s.rows_used = p[S_ROWS_USED];
  s.maxRY = p[S_MAXRY];
  s.status = p[S_STATUS];
  s.done = p[S_DONE];
  return s;
}

__device__ __forceinline__ void store_lane(int* p, const Lane& s) {
  p[S_LY] = s.LY;
  p[S_RY] = s.RY;
  p[S_ROW] = s.row;
  p[S_BEST] = s.best;
  p[S_END1] = s.end1;
  p[S_END2] = s.end2;
  p[S_BSCORE] = s.bscore;
  p[S_BFLAG] = s.bflag;
  p[S_TBP] = s.tbp;
  p[S_ROWS_USED] = s.rows_used;
  p[S_MAXRY] = s.maxRY;
  p[S_STATUS] = s.status;
  p[S_DONE] = s.done;
}

// One chunk of one lane, run by all of its CTA's threads alike: up to
// `rows` DP rows from the lane's state `s` over the window in shared
// memory (CC/DD already re-anchored to b_off, the window's b codes and
// the chunk's row codes loaded, and a block barrier since), the link
// bytes of local row r + 1 at tbl + (r + 1) * W (tbl == nullptr: none).
// On return, after a block barrier, CC/DD hold the plain version's
// whole-window values: NEG outside the last row's written range once a
// row ran.  The row body of both K1 entry points.
template <bool TRIM, bool PROF>
__device__ __forceinline__ void run_chunk(Lane& s, const Smem& m, int b_off,
                                          int M, int N, int W, int rows,
                                          unsigned char* tbl, int gap_e,
                                          int gap_oe, int y_drop, int tb_cap,
                                          int tail, RowProf& pf) {
  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int wl = tid & 31;
  const double inv_ge = gap_e > 0 ? 1.0 / gap_e : 0.0;
  int stopped = s.done;
  bool ran = false;
  int lo_w = 0, hi_w = 0;  // the last row's written range
  Pro q;                   // the last row's prolongation
  q.from = W;
  q.p = 0;
  q.iex = 0;

  int acode = m.ar[0];
  for (int r = 0; r < rows; ++r) {
    if (stopped) break;
    if constexpr (PROF) pf.t0 = pf.t = clock64();
    // truncation check (gapped_extend.c:3621-3660): break BEFORE the row
    if (wadd(s.tbp, wadd(max(wsub(s.RY, s.LY), 0), tail)) >= tb_cap) {
      s.status |= ST_TRUNCATED;
      s.done = 1;
      break;
    }
    const int par = r & 1;
    unsigned char* tbrow = tbl ? tbl + (long long)(r + 1) * W : nullptr;
    Row x;
    x.srow = m.sub + acode * 16;
    acode = m.ar[min(r + 1, rows - 1)];  // read a row ahead
    x.LYr = wsub(s.LY, b_off);
    const int RYr = wsub(s.RY, b_off);
    x.cend = min(RYr, W);
    x.ci = min(max(wsub(RYr, 1), 0), W - 1);
    x.best = s.best;
    x.colN = wsub(N, b_off);
    x.rowM = s.row == M;
    x.gap_e = gap_e;
    x.gap_oe = gap_oe;
    x.y_drop = y_drop;
    x.q = q;
    const int c0 = max(x.LYr, 0);
    Sweep a;
    a.car_cc = NEG;
    a.car1 = ISENT;
    a.car2 = SENT32;
    // reset scan: column c0 - 1 < LYr is a reset to NEG + c0 * gapE
    a.car3 = c0 > 0 ? wadd(NEG, wmul(c0, gap_e)) : ISENT;
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
    if (width > 0) sweep<TRIM, PROF>(c0, width, x, a, m, par, tbrow, pf);

    // row reductions: each warp's maxima, then the last column reaching
    // each (trimming to the peak, no cell is a boundary cell); then the
    // four warps' entries, combined by every thread
    {
      const int rm = __reduce_max_sync(kFullMask, a.rt);
      const int bm = TRIM ? SENT32 : __reduce_max_sync(kFullMask, a.bt);
      const int fl = __reduce_min_sync(kFullMask, a.fl);
      const int np = __reduce_max_sync(kFullMask, a.npt);
      const int ae = __any_sync(kFullMask, a.ael);
      const int ab = TRIM ? 0 : __any_sync(kFullMask, a.ab);
      const int kt = __reduce_max_sync(kFullMask, a.rt == rm ? a.kt : -1);
      const int kbt =
          TRIM ? -1 : __reduce_max_sync(kFullMask, a.bt == bm ? a.kbt : -1);
      if (wl == 0) {
        m.xs->re[par][w][0] = make_int4(rm, kt, fl, np);
        m.xs->re[par][w][1] = make_int4(ae, bm, kbt, ab);
      }
    }
    __syncthreads();  // every warp's entry, i_exit and tile precede reads
    int4 e0[WARPS], e1[WARPS];
#pragma unroll
    for (int j = 0; j < WARPS; ++j) {
      e0[j] = m.xs->re[par][j][0];
      e1[j] = m.xs->re[par][j][1];
    }
    int rmax = SENT32, bmax = SENT32, firstl = BIG, npk = -1;
    bool anyel = false, anyb = false;
#pragma unroll
    for (int j = 0; j < WARPS; ++j) {
      rmax = max(rmax, e0[j].x);
      firstl = min(firstl, e0[j].z);
      npk = max(npk, e0[j].w);
      anyel |= e1[j].x != 0;
      if (!TRIM) {
        bmax = max(bmax, e1[j].y);
        anyb |= e1[j].w != 0;
      }
    }
    int kbest = -1, kb = -1;
#pragma unroll
    for (int j = 0; j < WARPS; ++j) {
      kbest = max(kbest, e0[j].x == rmax ? e0[j].y : -1);
      if (!TRIM) kb = max(kb, e1[j].y == bmax ? e1[j].z : -1);
    }
    // no live column: ci lies left of LYr (a reset) or is inactive
    const int i_exit_raw =
        width > 0 ? m.xs->iex[par]
                  : (x.ci < x.LYr ? wadd(NEG, wmul(x.ci + 1, gap_e)) : ISENT);
    mark<PROF>(pf, P_RED);

    // best / end / boundary (the boundary update runs after best
    // within a cell, so it wins at or past the best column)
    const bool fires_best = anyel && rmax >= s.best;
    const bool fires_b = anyb && bmax >= s.bscore;
    const bool use_b = fires_b && (!fires_best || kb >= kbest);
    const bool use_best = fires_best && !use_b;
    if (use_b || use_best) s.end1 = s.row;
    if (use_b) {
      s.end2 = wadd(b_off, kb);
      s.bflag = 1;
    } else if (use_best) {
      s.end2 = wadd(b_off, kbest);
      s.bflag = 0;
    }
    if (fires_best) s.best = rmax;
    if (fires_b) s.bscore = bmax;

    // LY advance, RY shrink or prolongation (host ydrop.py:538-559)
    const int first_live = firstl != BIG ? firstl : RYr;
    const int LYn = wadd(b_off, first_live);
    const int np_col = wadd(b_off, npk);
    const bool dead = LYn >= s.RY;
    const int K = wsub(s.RY, s.LY);
    const int i_exit = wsub(i_exit_raw, wmul(RYr, gap_e));
    const bool shrink = s.RY > wadd(np_col, 1);
    const int thresh = wsub(s.best, y_drop);
    const int p_raw =
        gap_e > 0 ? wadd(floordiv_pos(wsub(i_exit, thresh), gap_e, inv_ge), 1)
        : gap_e ? wadd(floordiv(wsub(i_exit, thresh), gap_e), 1)
                : BIG;
    const int p_hi = max(wsub(wadd(N, 1), s.RY), 0);
    const int p = (shrink || i_exit < thresh) ? 0 : min(max(p_raw, 0), p_hi);
    const int RYs = shrink ? wadd(np_col, 1) : wadd(s.RY, p);
    const bool has_sent = RYs <= N;
    const int RYf = wadd(RYs, has_sent ? 1 : 0);
    const int sent_l = wsub(RYs, b_off);
    mark<PROF>(pf, P_TAIL);

    // the written range [lo, hi): the sweep's [c0, cend), then the
    // prolongation [RYr, RYr + p) and the sentinel (at RYr + p unless
    // the band shrank, when it is a pruned column the sweep wrote).  The
    // prolongation's CC and DD are not written here: the next row
    // computes them as it loads (Pro), so this row ends at its one
    // block barrier, and the chunk's end writes the last row's.  Its
    // link bytes go out now.
    const int lo = max(min(x.LYr, RYr), 0);
    const int hi = min(max(wadd(RYr, p), has_sent ? wadd(sent_l, 1) : 0), W);
    if (tbrow) {
      for (int l = max(RYr, 0) + tid; l < hi; l += THREADS)
        tbrow[l] = (unsigned char)(wsub(l, RYr) < p ? C_FROM_I : 0);
    }
    q.from = RYr;
    q.p = p;
    q.iex = i_exit;
    mark<PROF>(pf, P_PROL);
    if constexpr (PROF) {
      if (tid == 0 && pf.n < pf.cap) {
        pf.row_w[pf.n] = width;
        pf.row_c[pf.n] = (int)(pf.t - pf.t0);
      }
      pf.n++;
    }

    const bool window_end = wsub(RYf, b_off) > W;
    const bool width_over = wsub(RYf, LYn) > W || wadd(K, p) > W;
    if (width_over && !dead) s.status |= ST_WIDTH_OVERFLOW;
    if (dead || s.row >= M || width_over) s.done = 1;
    stopped = s.done || window_end;
    ran = true;
    lo_w = lo;
    hi_w = hi;
    s.LY = LYn;
    s.RY = RYf;
    s.rows_used = s.row;
    s.row = wadd(s.row, 1);
    s.tbp = wadd(wadd(s.tbp, K), p);
    s.maxRY = max(s.maxRY, RYf);
  }

  // the whole window: the last row's prolongation, and NEG outside its
  // written range (every read of the last row's tiles preceded its
  // block barrier, and none read past its RYr)
  if (ran) {
    for (int l = tid; l < W; l += THREADS) {
      int cc, dd;
      old_cell(m.cc, m.dd, q, gap_e, gap_oe, l, cc, dd);
      const bool out = l < lo_w || l >= hi_w;
      m.cc[l] = out ? NEG : cc;
      m.dd[l] = out ? NEG : dd;
    }
  }
  __syncthreads();
}

template <bool TRIM>
__global__ void __launch_bounds__(THREADS)
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
  __shared__ __align__(16) Xchg xs;

  const int tid = threadIdx.x;
  const int lane_id = blockIdx.x;
  for (int i = tid; i < 256; i += THREADS) s_sub[i] = subsmall[i];
  const Smem m = carve(smem, s_sub, &xs, W);

  int* scl = sc + (long long)lane_id * NS;
  Lane s = load_lane(scl);
  const int b_off = b_off_a[lane_id];
  const int sh = min(max(shift_a[lane_id], 0), W);

  int* ccl = CCg + (long long)lane_id * W;
  int* ddl = DDg + (long long)lane_id * W;
  const int* bl = b_small + (long long)lane_id * W;

  // window re-anchor: lane l takes old lane l + shift, NEG past the end
  for (int l = tid; l < W; l += THREADS) {
    const int src = l + sh;
    m.cc[l] = src < W ? ccl[src] : NEG;
    m.dd[l] = src < W ? ddl[src] : NEG;
    m.bc[l] = bl[l] & 15;
  }
  for (int i = tid; i < rows; i += THREADS)
    m.ar[i] = (unsigned char)(a_small[(long long)lane_id * rows + i] & 15);
  __syncthreads();  // the score table, window and row codes precede rows

  RowProf pf;
  run_chunk<TRIM, false>(s, m, b_off, M_a[lane_id], N_a[lane_id], W, rows,
                         tb ? tb + (long long)lane_id * tb_lane_stride
                            : nullptr,
                         gap_e, gap_oe, y_drop, tb_cap, tail, pf);

  for (int l = tid; l < W; l += THREADS) {
    ccl[l] = m.cc[l];
    ddl[l] = m.dd[l];
  }
  if (tid == 0) store_lane(scl, s);
}

// The mega launch (replaces ydrop_mega_pallas's device while_loop): a
// lane's CTA runs its chunks one after another until the lane is done
// or max_blocks chunks have run, as lastz_tpu's ydrop_mega does for
// each lane of its vmap.  Between chunks CC/DD stay in shared memory
// and are re-anchored there; the CTA gathers each chunk's row and
// window codes from the resident compact codes itself, with the index
// arithmetic of ops/ydrop_exact.gather_windows.  Chunk k of a lane
// writes its link bytes into block k of tb_all and its row_lo, row_hi
// and col0; blocks at or past the lane's nblk are left as they came
// (zero).
struct MegaLane {
  int a1, a2, low1, high1, low2, high2, rev;
};

template <bool TRIM, bool PROF>
__global__ void __launch_bounds__(THREADS)
ydrop_mega_kernel(const signed char* __restrict__ v1c, int L1,
                  const signed char* __restrict__ v2c, int L2,
                  const int* __restrict__ a1_a, const int* __restrict__ a2_a,
                  const int* __restrict__ low1_a,
                  const int* __restrict__ high1_a,
                  const int* __restrict__ low2_a,
                  const int* __restrict__ high2_a,
                  const unsigned char* __restrict__ rev_a,
                  const int* __restrict__ M_a, const int* __restrict__ N_a,
                  int* __restrict__ CCg, int* __restrict__ DDg,
                  int* __restrict__ sc, int* __restrict__ prev_off_a,
                  const int* __restrict__ subsmall,
                  unsigned char* __restrict__ tb_all, int max_blocks,
                  int* __restrict__ row_lo, int* __restrict__ row_hi,
                  int* __restrict__ col0, int* __restrict__ nblk_a, int W,
                  int rows, int gap_e, int gap_oe, int y_drop, int tb_cap,
                  int tail, long long* __restrict__ prof_ph,
                  int* __restrict__ prof_rows, int prof_cap) {
  extern __shared__ int smem[];
  __shared__ int s_sub[256];
  __shared__ __align__(16) Xchg xs;

  const int tid = threadIdx.x;
  const int lane_id = blockIdx.x;
  for (int i = tid; i < 256; i += THREADS) s_sub[i] = subsmall[i];
  const Smem m = carve(smem, s_sub, &xs, W);

  int* scl = sc + (long long)lane_id * NS;
  Lane s = load_lane(scl);
  MegaLane g;
  g.a1 = a1_a[lane_id];
  g.a2 = a2_a[lane_id];
  g.low1 = low1_a[lane_id];
  g.high1 = high1_a[lane_id];
  g.low2 = low2_a[lane_id];
  g.high2 = high2_a[lane_id];
  g.rev = rev_a[lane_id] != 0;
  const int M = M_a[lane_id];
  const int N = N_a[lane_id];
  int prev_off = prev_off_a[lane_id];

  int* ccl = CCg + (long long)lane_id * W;
  int* ddl = DDg + (long long)lane_id * W;
  for (int l = tid; l < W; l += THREADS) {
    m.cc[l] = ccl[l];
    m.dd[l] = ddl[l];
  }
  const long long blk = (long long)(rows + 1) * W;
  unsigned char* tbl =
      tb_all ? tb_all + (long long)lane_id * max_blocks * blk : nullptr;
  int* lo_out = row_lo + (long long)lane_id * max_blocks;
  int* hi_out = row_hi + (long long)lane_id * max_blocks;
  int* c0_out = col0 + (long long)lane_id * max_blocks;

  RowProf pf;
  if constexpr (PROF) {
    for (int i = 0; i < NPHASE; ++i) pf.ph[i] = 0;
    pf.row_w = prof_rows + (long long)lane_id * 2 * prof_cap;
    pf.row_c = pf.row_w + prof_cap;
    pf.n = 0;
    pf.cap = prof_cap;
  }
  int k = 0;
  for (; k < max_blocks && !s.done; ++k) {
    const int row_base = wsub(s.row, 1);
    const int b_off = s.LY;  // the lane is not done
    const int sh = min(max(wsub(b_off, prev_off), 0), W);
    __syncthreads();  // the last chunk's shared writes precede these reads
    // re-anchor in place, THREADS columns at a time: each step reads its
    // sources before any thread writes, and later steps read only
    // columns right of every column written so far
    if (sh) {
      for (int l0 = 0; l0 < W; l0 += THREADS) {
        const int l = l0 + tid;
        const int src = l + sh;
        const int cc = src < W ? m.cc[src] : NEG;
        const int dd = src < W ? m.dd[src] : NEG;
        __syncthreads();
        if (l < W) {
          m.cc[l] = cc;
          m.dd[l] = dd;
        }
        __syncthreads();
      }
    }
    // the window: column c = b_off + l reads v2[a2 + c], or going left
    // v2[a2 + 1 - c]; row r reads v1[a1 + 1 + row_base + r], or
    // v1[a1 - row_base - r]; out of range reads code 0
    for (int l = tid; l < W; l += THREADS) {
      const int c = wadd(b_off, l);
      const int i = g.rev ? wsub(wadd(g.a2, 1), c) : wadd(g.a2, c);
      const bool ok = g.rev ? (i >= g.low2 && c >= 1)
                            : (i < g.high2 && i >= g.low2);
      m.bc[l] = ok ? v2c[min(max(i, 0), L2 - 1)] & 15 : 0;
    }
    for (int r = tid; r < rows; r += THREADS) {
      const int i = g.rev ? wsub(wsub(g.a1, row_base), r)
                          : wadd(wadd(wadd(g.a1, 1), row_base), r);
      const bool ok = g.rev ? i >= g.low1 : (i < g.high1 && i >= g.low1);
      m.ar[r] = (unsigned char)(ok ? v1c[min(max(i, 0), L1 - 1)] & 15 : 0);
    }
    __syncthreads();  // the window and row codes precede the chunk's rows

    run_chunk<TRIM, PROF>(s, m, b_off, M, N, W, rows,
                          tbl ? tbl + k * blk : nullptr, gap_e, gap_oe,
                          y_drop, tb_cap, tail, pf);
    if (tid == 0) {
      lo_out[k] = wadd(row_base, 1);
      hi_out[k] = s.rows_used;
      c0_out[k] = b_off;
    }
    prev_off = b_off;
  }

  for (int l = tid; l < W; l += THREADS) {
    ccl[l] = m.cc[l];
    ddl[l] = m.dd[l];
  }
  if (tid == 0) {
    store_lane(scl, s);
    prev_off_a[lane_id] = prev_off;
    nblk_a[lane_id] = k;
    if constexpr (PROF) {
      long long* ph = prof_ph + (long long)lane_id * (NPHASE + 1);
      for (int i = 0; i < NPHASE; ++i) ph[i] = pf.ph[i];
      ph[NPHASE] = pf.n;
    }
  }
}

// Lets a kernel take `shm` bytes of dynamic shared memory.
template <typename Kernel>
int allow_smem(Kernel kernel, long long shm) {
  if (shm > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (shm > SMEM_DEFAULT)
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
  return 0;
}

template <bool TRIM>
int launch(const int* a_small, const int* b_small, const int* b_off,
           const int* shift, const int* M, const int* N, int* CC, int* DD,
           int* sc, const int* subsmall, unsigned char* tb,
           long long tb_lane_stride, int B, int W, int rows, int gap_e,
           int gap_oe, int y_drop, int tb_cap, int tail,
           cudaStream_t stream) {
  const long long shm = lane_smem_bytes(W, rows);
  const int e = allow_smem(ydrop_chunk_kernel<TRIM>, shm);
  if (e) return e;
  // one CTA of four warps per lane
  ydrop_chunk_kernel<TRIM><<<B, THREADS, (size_t)shm, stream>>>(
      a_small, b_small, b_off, shift, M, N, CC, DD, sc, subsmall, tb,
      tb_lane_stride, W, rows, gap_e, gap_oe, y_drop, tb_cap, tail);
  return (int)cudaGetLastError();
}

template <bool TRIM, bool PROF>
int launch_mega(const signed char* v1c, int L1, const signed char* v2c,
                int L2, const int* a1, const int* a2, const int* low1,
                const int* high1, const int* low2, const int* high2,
                const unsigned char* rev, const int* M, const int* N, int* CC,
                int* DD, int* sc, int* prev_off, const int* subsmall,
                unsigned char* tb_all, int max_blocks, int* row_lo,
                int* row_hi, int* col0, int* nblk, int B, int W, int rows,
                int gap_e, int gap_oe, int y_drop, int tb_cap, int tail,
                cudaStream_t stream, long long* prof_ph = nullptr,
                int* prof_rows = nullptr, int prof_cap = 0) {
  const long long shm = lane_smem_bytes(W, rows);
  const int e = allow_smem(ydrop_mega_kernel<TRIM, PROF>, shm);
  if (e) return e;
  ydrop_mega_kernel<TRIM, PROF><<<B, THREADS, (size_t)shm, stream>>>(
      v1c, L1, v2c, L2, a1, a2, low1, high1, low2, high2, rev, M, N, CC, DD,
      sc, prev_off, subsmall, tb_all, max_blocks, row_lo, row_hi, col0, nblk,
      W, rows, gap_e, gap_oe, y_drop, tb_cap, tail, prof_ph, prof_rows,
      prof_cap);
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

// Launch up to max_blocks chunks for each of B lanes on `stream`, the
// windows gathered from the int8 compact codes v1c (L1) and v2c (L2).
// CC/DD (B, W), sc (B, 13) and prev_off (B,) are updated in place;
// nblk (B,) gets each lane's chunk count and row_lo, row_hi, col0
// (B, max_blocks) its chunks' rows and window origins.  tb_all
// (B, max_blocks, rows + 1, W) must arrive zeroed, and may be null.
// Returns the cudaGetLastError() code of the launch.
extern "C" int ydrop_mega_launch(
    const signed char* v1c, int L1, const signed char* v2c, int L2,
    const int* a1, const int* a2, const int* low1, const int* high1,
    const int* low2, const int* high2, const unsigned char* rev,
    const int* M, const int* N, int* CC, int* DD, int* sc, int* prev_off,
    const int* subsmall, unsigned char* tb_all, int max_blocks, int* row_lo,
    int* row_hi, int* col0, int* nblk, int B, int W, int rows, int gap_e,
    int gap_oe, int y_drop, int trim_to_peak, int tb_cap, int tail,
    void* stream) {
  if (B <= 0 || W <= 0 || W > 2048 || rows <= 0 || max_blocks <= 0 ||
      L1 <= 0 || L2 <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return trim_to_peak
             ? launch_mega<true, false>(
                   v1c, L1, v2c, L2, a1, a2, low1, high1, low2, high2, rev, M,
                   N, CC, DD, sc, prev_off, subsmall, tb_all, max_blocks,
                   row_lo, row_hi, col0, nblk, B, W, rows, gap_e, gap_oe,
                   y_drop, tb_cap, tail, st)
             : launch_mega<false, false>(
                   v1c, L1, v2c, L2, a1, a2, low1, high1, low2, high2, rev, M,
                   N, CC, DD, sc, prev_off, subsmall, tb_all, max_blocks,
                   row_lo, row_hi, col0, nblk, B, W, rows, gap_e, gap_oe,
                   y_drop, tb_cap, tail, st);
}

#ifdef LASTZ_K1_PROFILE
// The mega launch with the row profile (kernel_bench.py --census builds
// this source with -DLASTZ_K1_PROFILE into a library of its own):
// ydrop_mega_launch's arguments, then prof_ph (B, NPHASE + 1) int64, each
// lane's cycles by phase (P_TILE, P_SCAN, P_STORE, P_RED, P_TAIL, P_PROL)
// and its rows, and prof_rows (B, 2, prof_cap) int32, each row's band
// width and cycles.
extern "C" int ydrop_mega_profile_launch(
    const signed char* v1c, int L1, const signed char* v2c, int L2,
    const int* a1, const int* a2, const int* low1, const int* high1,
    const int* low2, const int* high2, const unsigned char* rev,
    const int* M, const int* N, int* CC, int* DD, int* sc, int* prev_off,
    const int* subsmall, unsigned char* tb_all, int max_blocks, int* row_lo,
    int* row_hi, int* col0, int* nblk, int B, int W, int rows, int gap_e,
    int gap_oe, int y_drop, int trim_to_peak, int tb_cap, int tail,
    void* stream, long long* prof_ph, int* prof_rows, int prof_cap) {
  if (B <= 0 || W <= 0 || W > 2048 || rows <= 0 || max_blocks <= 0 ||
      L1 <= 0 || L2 <= 0 || prof_cap <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return trim_to_peak
             ? launch_mega<true, true>(
                   v1c, L1, v2c, L2, a1, a2, low1, high1, low2, high2, rev, M,
                   N, CC, DD, sc, prev_off, subsmall, tb_all, max_blocks,
                   row_lo, row_hi, col0, nblk, B, W, rows, gap_e, gap_oe,
                   y_drop, tb_cap, tail, st, prof_ph, prof_rows, prof_cap)
             : launch_mega<false, true>(
                   v1c, L1, v2c, L2, a1, a2, low1, high1, low2, high2, rev, M,
                   N, CC, DD, sc, prev_off, subsmall, tb_all, max_blocks,
                   row_lo, row_hi, col0, nblk, B, W, rows, gap_e, gap_oe,
                   y_drop, tb_cap, tail, st, prof_ph, prof_rows, prof_cap);
}
#endif
