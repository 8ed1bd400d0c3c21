// K1 on Hopper: the exact, resumable one-sided y-drop chunk with one
// traceback link byte per cell.
//
// Replaces lastz_tpu/ops/ydrop_pallas_exact.py::_kernel (launched by
// ydrop_chunk_pallas); computes what ops/ydrop_exact.ydrop_chunk_plain
// computes, state for state and link byte for link byte.
//
// Layout: one CTA per DP lane (anchor x direction), 512 threads, each
// owning CPT = ceil(W / 512) consecutive window columns in registers.
// The whole `rows` loop runs inside the CTA.  Each row is the two-pass
// exact row of docs/two_pass_exact_row.md: two exclusive prefix maxima
// (the reset-free decayed chain, then the running best), one reset
// scan for the exact insertion values, and two row reductions (row
// maxima, then the last column that reaches them).  Each scan is a
// thread-local pass over its columns, a __shfl_up_sync warp scan of
// the thread totals and a shared-memory scan of the 16 warp totals.
// The 16x16 compact score table and the chunk's row codes sit in
// shared memory, so a cell's score is subsmall[a_code][b_code].
//
// What bounds it on an H100: the row is a serial chain of barriers
// (nine per row), not bytes or arithmetic -- a 1536-column row is
// ~25 k integer ops and 1.5 kB of link bytes.  The design keeps every
// operand in registers or shared memory, touches device memory only
// for the link bytes, and stops a lane's CTA as soon as the lane
// stops (its remaining link rows stay zero from the wrapper's zeroed
// buffer).  With one CTA per lane and 128 lanes a launch fills 128 of
// the 132 SMs.
//
// Signed overflow is undefined in CUDA; every sum that the JAX
// version computes in wrapping int32 goes through wadd/wsub/wmul, and
// (i_exit - thresh) // gapE goes through floordiv.

#include "common.cuh"

namespace {

using namespace lastz;

constexpr int NT = 512;
constexpr int NWARP = NT / 32;

constexpr int NEG = -1932735283;
constexpr int SENT32 = -(1 << 30);
constexpr int ISENT = -2080000000;
constexpr int BIG = 1 << 30;

constexpr int C_FROM_C = 0;
constexpr int C_FROM_I = 1;
constexpr int C_FROM_D = 2;
constexpr int I_EXTEND = 4;
constexpr int D_EXTEND = 8;
constexpr int ST_WIDTH_OVERFLOW = 1;
constexpr int ST_TRUNCATED = 8;

// per-lane scalar slots (ops/ydrop_exact.SCALAR_KEYS order)
enum {
  S_LY, S_RY, S_ROW, S_BEST, S_END1, S_END2, S_BSCORE, S_BFLAG, S_TBP,
  S_ROWS_USED, S_MAXRY, S_STATUS, S_DONE, NS
};

// Exclusive prefix max over the block's threads of `v`, seeded with
// `ident`: the max of ident and v of every lower thread.
__device__ __forceinline__ int block_excl_max(int v, int ident, int* sw) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFullMask, x, o);
    if (lane >= o) x = max(x, y);
  }
  if (lane == 31) sw[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < NWARP ? sw[lane] : ident;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFullMask, w, o);
      if (lane >= o) w = max(w, y);
    }
    if (lane < NWARP) sw[lane] = w;
  }
  __syncthreads();
  int ex = __shfl_up_sync(kFullMask, x, 1);
  if (lane == 0) ex = ident;
  const int pre = warp ? sw[warp - 1] : ident;
  return max(pre, ex);
}

// Exclusive scan of the max-with-resets operator
//   (s1,r1) x (s2,r2) = (r2 ? s2 : max(s1,s2), r1|r2)
// over the threads' aggregates (s, r), seeded with (ident, false).
// Returns the s part (all a thread's own columns need).
__device__ __forceinline__ int block_excl_reset(int s, int r, int ident,
                                                int* sws, int* swr) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int xs = s, xr = r;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int ys = __shfl_up_sync(kFullMask, xs, o);
    const int yr = __shfl_up_sync(kFullMask, xr, o);
    if (lane >= o) {
      xs = xr ? xs : max(ys, xs);
      xr = xr | yr;
    }
  }
  if (lane == 31) {
    sws[warp] = xs;
    swr[warp] = xr;
  }
  __syncthreads();
  if (warp == 0) {
    int ws = lane < NWARP ? sws[lane] : ident;
    int wr = lane < NWARP ? swr[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int ys = __shfl_up_sync(kFullMask, ws, o);
      const int yr = __shfl_up_sync(kFullMask, wr, o);
      if (lane >= o) {
        ws = wr ? ws : max(ys, ws);
        wr = wr | yr;
      }
    }
    if (lane < NWARP) sws[lane] = ws;
  }
  __syncthreads();
  int es = __shfl_up_sync(kFullMask, xs, 1);
  int er = __shfl_up_sync(kFullMask, xr, 1);
  if (lane == 0) {
    es = ident;
    er = 0;
  }
  const int pre = warp ? sws[warp - 1] : ident;
  return er ? es : max(pre, es);
}

template <int CPT>
__global__ void __launch_bounds__(NT)
ydrop_chunk_kernel(const int* __restrict__ a_small,
                   const int* __restrict__ b_small,
                   const int* __restrict__ b_off_a,
                   const int* __restrict__ shift_a,
                   const int* __restrict__ M_a, const int* __restrict__ N_a,
                   int* __restrict__ CCg, int* __restrict__ DDg,
                   int* __restrict__ sc, const int* __restrict__ subsmall,
                   unsigned char* __restrict__ tb, long long tb_lane_stride,
                   int W, int rows, int gap_e, int gap_oe, int y_drop,
                   int trim_to_peak, int tb_cap, int tail) {
  extern __shared__ int s_arow[];  // the chunk's row codes
  __shared__ int s_sub[256];
  __shared__ int s_last[NT];
  __shared__ int s_scan[3][NWARP];
  __shared__ int s_scan_r[NWARP];
  __shared__ int s_redA[6][NWARP];
  __shared__ int s_redB[2][NWARP];
  __shared__ int s_iexit;

  const int lane_id = blockIdx.x;
  const int t = threadIdx.x;
  const int wl = t & 31;
  const int wp = t >> 5;

  for (int i = t; i < 256; i += NT) s_sub[i] = subsmall[i];
  for (int i = t; i < rows; i += NT)
    s_arow[i] = a_small[(long long)lane_id * rows + i] & 15;

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
  int CC[CPT], DD[CPT], bc[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int l = t * CPT + c;
    const int src = l + sh;
    const bool in = l < W && src < W;
    CC[c] = in ? ccl[src] : NEG;
    DD[c] = in ? ddl[src] : NEG;
    bc[c] = l < W ? (bl[l] & 15) : 0;
  }
  __syncthreads();  // every read of CCg/DDg precedes the in-place writes

  unsigned char* tbl = tb ? tb + (long long)lane_id * tb_lane_stride
                          : nullptr;
  int stopped = done;

  for (int r = 0; r < rows; ++r) {
    if (stopped) break;
    // truncation check (gapped_extend.c:3621-3660): break BEFORE the row
    if (wadd(tbp, wadd(max(wsub(RY, LY), 0), tail)) >= tb_cap) {
      status |= ST_TRUNCATED;
      done = 1;
      break;
    }
    s_last[t] = CC[CPT - 1];
    __syncthreads();
    const int left = t ? s_last[t - 1] : NEG;
    const int* srow = s_sub + s_arow[r] * 16;
    const int LYr = wsub(LY, b_off);
    const int RYr = wsub(RY, b_off);

    bool act[CPT];
    int d[CPT], csub[CPT], eff[CPT];
    int tmax = ISENT;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int l = t * CPT + c;
      act[c] = l >= LYr && l < RYr && l < W;
      d[c] = act[c] ? DD[c] : NEG;
      const int prevcc = c ? CC[c - 1] : left;
      csub[c] = (act[c] && l > LYr) ? wadd(prevcc, srow[bc[c]]) : NEG;
      eff[c] = (act[c] && d[c] <= csub[c])
                   ? wadd(wsub(csub[c], gap_oe), wmul(l + 1, gap_e))
                   : ISENT;
      tmax = max(tmax, eff[c]);
    }

    // pass 1: reset-free decayed chain -> gap / prune decisions
    int acc = block_excl_max(tmax, ISENT, s_scan[0]);
    int iff[CPT], cbest[CPT];
    bool gap[CPT];
    tmax = SENT32;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int l = t * CPT + c;
      const int sff = acc;
      acc = max(acc, eff[c]);
      iff[c] = max(wsub(sff, wmul(l, gap_e)), NEG);
      gap[c] = act[c] && (d[c] > csub[c] || iff[c] > csub[c]);
      cbest[c] = (act[c] && !gap[c]) ? csub[c] : SENT32;
      tmax = max(tmax, cbest[c]);
    }
    acc = block_excl_max(tmax, SENT32, s_scan[1]);
    bool pruned[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int bb = max(best, acc);
      acc = max(acc, cbest[c]);
      const int cand = max(max(csub[c], d[c]), iff[c]);
      pruned[c] = act[c] && cand < wsub(bb, y_drop);
    }

    // pass 2: one reset scan -> exact insertion values for the links
    int es[CPT];
    bool rs[CPT];
    int ts = ISENT, tr = 0;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int l = t * CPT + c;
      const int comp = wmul(l + 1, gap_e);
      rs[c] = pruned[c] || l < LYr;
      const bool seed = act[c] && !pruned[c] && !gap[c];
      es[c] = rs[c] ? wadd(NEG, comp)
                    : (seed ? wadd(wsub(csub[c], gap_oe), comp) : ISENT);
      ts = rs[c] ? es[c] : max(ts, es[c]);
      tr |= rs[c];
    }
    acc = block_excl_reset(ts, tr, ISENT, s_scan[2], s_scan_r);
    const int ci = min(max(wsub(RYr, 1), 0), W - 1);
    int ivec[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int l = t * CPT + c;
      const int sexcl = l == 0 ? NEG : acc;
      acc = rs[c] ? es[c] : max(acc, es[c]);
      if (l == ci) s_iexit = acc;
      ivec[c] = wsub(sexcl, wmul(l, gap_e));
    }

    // links, next C/D, and the per-row reduction operands
    int link[CPT], ccur[CPT], dnext[CPT], ce[CPT], cb[CPT];
    int rmax = SENT32, bmax = SENT32, anyel = 0, anyb = 0;
    int firstl = BIG, npk = -1;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int l = t * CPT + c;
      const bool deadc = pruned[c] || !act[c];
      const int copen = wsub(csub[c], gap_oe);
      const int ddec = wsub(d[c], gap_e);
      const int idec = wsub(ivec[c], gap_e);
      int lk;
      if (gap[c]) {
        lk = (d[c] >= ivec[c]) ? (C_FROM_D | I_EXTEND | D_EXTEND)
                               : (C_FROM_I | I_EXTEND | D_EXTEND);
      } else {
        lk = C_FROM_C | (copen > ddec ? 0 : D_EXTEND) |
             (copen > idec ? 0 : I_EXTEND);
      }
      link[c] = deadc ? 0 : lk;
      const int cval = gap[c] ? max(d[c], ivec[c]) : csub[c];
      ccur[c] = deadc ? NEG : cval;
      dnext[c] = deadc ? NEG : (gap[c] ? ddec : max(copen, ddec));
      const bool elig = act[c] && !pruned[c] && !gap[c];
      const bool atb = !trim_to_peak && elig &&
                       (row == M || wadd(b_off, l) == N);
      ce[c] = elig ? csub[c] : SENT32;
      cb[c] = atb ? csub[c] : SENT32;
      rmax = max(rmax, ce[c]);
      bmax = max(bmax, cb[c]);
      anyel |= elig;
      anyb |= atb;
      if (act[c] && !pruned[c]) {
        firstl = min(firstl, l);
        npk = max(npk, l);
      }
    }
    rmax = __reduce_max_sync(kFullMask, rmax);
    bmax = __reduce_max_sync(kFullMask, bmax);
    anyel = __reduce_max_sync(kFullMask, anyel);
    anyb = __reduce_max_sync(kFullMask, anyb);
    firstl = __reduce_min_sync(kFullMask, firstl);
    npk = __reduce_max_sync(kFullMask, npk);
    if (wl == 0) {
      s_redA[0][wp] = rmax;
      s_redA[1][wp] = bmax;
      s_redA[2][wp] = anyel;
      s_redA[3][wp] = anyb;
      s_redA[4][wp] = firstl;
      s_redA[5][wp] = npk;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < NWARP; ++w) {
      rmax = max(rmax, s_redA[0][w]);
      bmax = max(bmax, s_redA[1][w]);
      anyel = max(anyel, s_redA[2][w]);
      anyb = max(anyb, s_redA[3][w]);
      firstl = min(firstl, s_redA[4][w]);
      npk = max(npk, s_redA[5][w]);
    }
    const int i_exit_raw = s_iexit;

    // the last column reaching each maximum
    int kbest = -1, kb = -1;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int l = t * CPT + c;
      const bool elig = act[c] && !pruned[c] && !gap[c];
      if (elig && ce[c] == rmax) kbest = max(kbest, l);
      const bool atb = !trim_to_peak && elig &&
                       (row == M || wadd(b_off, l) == N);
      if (atb && cb[c] == bmax) kb = max(kb, l);
    }
    kbest = __reduce_max_sync(kFullMask, kbest);
    kb = __reduce_max_sync(kFullMask, kb);
    if (wl == 0) {
      s_redB[0][wp] = kbest;
      s_redB[1][wp] = kb;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < NWARP; ++w) {
      kbest = max(kbest, s_redB[0][w]);
      kb = max(kb, s_redB[1][w]);
    }

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
        gap_e ? wadd(floordiv(wsub(i_exit, thresh), gap_e), 1) : BIG;
    const int p_hi = max(wsub(wadd(N, 1), RY), 0);
    const int p = (shrink || i_exit < thresh) ? 0 : min(max(p_raw, 0), p_hi);
    const int RYs = shrink ? wadd(np_col, 1) : wadd(RY, p);
    const bool has_sent = RYs <= N;
    const int RYf = wadd(RYs, has_sent ? 1 : 0);
    const int sent_l = wsub(RYs, b_off);

#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int l = t * CPT + c;
      const int pj = wsub(l, RYr);
      const bool prolong = pj >= 0 && pj < p;
      const int pro = wsub(i_exit, wmul(pj, gap_e));
      int ccn = prolong ? pro : ccur[c];
      int ddn = prolong ? wsub(pro, gap_oe) : dnext[c];
      if (has_sent && l == sent_l) {
        ccn = NEG;
        ddn = NEG;
      }
      CC[c] = ccn;
      DD[c] = ddn;
      if (tbl && l < W)
        tbl[(long long)(r + 1) * W + l] =
            (unsigned char)(prolong ? C_FROM_I : link[c]);
    }

    const bool window_end = wsub(RYf, b_off) > W;
    const bool width_over = wsub(RYf, LYn) > W || wadd(K, p) > W;
    if (width_over && !dead) status |= ST_WIDTH_OVERFLOW;
    if (dead || row >= M || width_over) done = 1;
    stopped = done || window_end;
    LY = LYn;
    RY = RYf;
    rows_used = row;
    row = wadd(row, 1);
    tbp = wadd(wadd(tbp, K), p);
    maxRY = max(maxRY, RYf);
  }

#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int l = t * CPT + c;
    if (l < W) {
      ccl[l] = CC[c];
      ddl[l] = DD[c];
    }
  }
  if (t == 0) {
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

}  // namespace

// Launch one chunk for B lanes on `stream`.  CC/DD (B, W) and sc
// (B, 13) are updated in place; tb (lane stride tb_lane_stride, row
// stride W) must arrive zeroed and may be null.  Returns the
// cudaGetLastError() code of the launch.
extern "C" int ydrop_chunk_launch(
    const int* a_small, const int* b_small, const int* b_off,
    const int* shift, const int* M, const int* N, int* CC, int* DD,
    int* sc, const int* subsmall, unsigned char* tb,
    long long tb_lane_stride, int B, int W, int rows, int gap_e,
    int gap_oe, int y_drop, int trim_to_peak, int tb_cap, int tail,
    void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t shm = (size_t)rows * sizeof(int);
  const int cpt = (W + NT - 1) / NT;
#define LAUNCH(C)                                                        \
  ydrop_chunk_kernel<C><<<B, NT, shm, st>>>(                             \
      a_small, b_small, b_off, shift, M, N, CC, DD, sc, subsmall, tb,    \
      tb_lane_stride, W, rows, gap_e, gap_oe, y_drop, trim_to_peak,      \
      tb_cap, tail)
  switch (cpt) {
    case 1: LAUNCH(1); break;
    case 2: LAUNCH(2); break;
    case 3: LAUNCH(3); break;
    case 4: LAUNCH(4); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}
