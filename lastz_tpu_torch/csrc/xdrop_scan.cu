// K2 on Hopper: the gap-free x-drop extension of every seed hit, right
// from p and left from p-1 (reference xdrop_extend_seed_hit,
// seed_search.c:2528-2801).
//
// Replaces lastz_tpu/ops/xdrop_pallas.py's kernel (_make_kernel,
// launched by xdrop_scan_pallas); equals ops/hitgen._xdrop_all's final
// (consumed, best, kbest) for each side.
//
// A scan stops at the first cell where the running sum falls below
// max(runmax, 0) - x_drop (that cell counts in `consumed`) or after n
// cells; `best` moves only on a strictly greater sum, so the first index
// wins ties.  It reads the whole SEQ_PAD-padded int8 sequences in device
// memory, so it needs no windows, escapes or continuation waves.
//
// Bound on an H100: the int32 work of the cells the scans need (score
// lookup, add, running max, drop test, best), since the two sequences
// fit the 50 MB L2.  The walks are lopsided: almost every random hit
// dies within a few dozen cells, while a hit inside a conserved segment
// runs for thousands.  The first design ran one thread per (hit,
// direction) cell by cell, so a warp lasted as long as its longest walk
// and 31 threads waited on one; and each cell cost every thread a byte
// load from its own cache line.
//
// Design: two kernels behind one entry point, with no host read between
// them.  Stage 1 runs one thread per (hit, direction) over the first
// STAGE1_CELLS cells, reading 8 cells of each sequence with two aligned
// 8-byte loads; walks that end there (and n == 0 slots) write their
// result, the rest go into a device queue through one atomicAdd per
// warp.  Stage 2 is a persistent grid of warps that take queued walks
// GRAB at a time from a device counter and scan each from cell 0 in
// chunks of 32 x CPT cells, as the Pallas kernel scans 128-cell rows: a
// warp inclusive scan of the scores (wrapping uint32 adds are
// associative, so the sums equal the serial loop's bit for bit), a
// prefix max over it, the first failing drop test by ballot, and the
// first maximal sum up to it.  Its score table is held once per thread
// of a warp, so the warp's random lookups never share a bank.

#include <climits>

#include "common.cuh"

namespace {

constexpr int STAGE1_CELLS = 64;  // S: cells a stage-1 thread scans
constexpr int CPT = 8;            // stage-2 cells per thread per chunk
constexpr int CHUNK = 32 * CPT;
constexpr int GRAB = 4;           // queued walks a warp takes at once
constexpr int S1_THREADS = 256;
constexpr int S2_THREADS = 256;

static_assert(STAGE1_CELLS % 8 == 0, "stage 1 reads 8 cells at a time");
static_assert(CPT == 8, "a stage-2 thread reads its 8 cells at once");

struct Walk {
  int n;
  long long p1, p2, step;
};

__device__ __forceinline__ Walk walk_of(long long i, int H,
                                        const int* __restrict__ pos1,
                                        const int* __restrict__ pos2,
                                        const int* __restrict__ n_l,
                                        const int* __restrict__ n_r,
                                        long long pad) {
  const bool left = i >= H;
  const int h = (int)(left ? i - H : i);
  Walk w;
  w.n = left ? n_l[h] : n_r[h];
  w.step = left ? -1 : 1;
  w.p1 = pad + pos1[h] + (left ? -1 : 0);
  w.p2 = pad + pos2[h] + (left ? -1 : 0);
  return w;
}

__device__ __forceinline__ void put(int* __restrict__ out, long long i,
                                    int H, int consumed, int best,
                                    int kbest) {
  const bool left = i >= H;
  const long long h = left ? i - H : i;
  int* o = out + (left ? 0 : 3) * (long long)H;
  o[h] = consumed;
  o[H + h] = best;
  o[2LL * H + h] = best > 0 ? kbest : -1;
}

// the codes of cells j .. j + 7 of a walk whose cell j lies at s[a],
// cell j in the low byte of .x: two aligned 8-byte loads, realigned by
// funnel shifts.  Cells past a walk's n are read too (the callers mask
// them): they lie inside the SEQ_PAD margin around each sequence.
__device__ __forceinline__ uint2 codes8(const signed char* s, long long a,
                                        long long step) {
  const uintptr_t p = (uintptr_t)(s + (step > 0 ? a : a - 7));
  const uint2* w = reinterpret_cast<const uint2*>(p & ~(uintptr_t)7);
  const uint2 v0 = __ldg(w), v1 = __ldg(w + 1);
  const bool hi = p & 4;
  const unsigned w0 = hi ? v0.y : v0.x;
  const unsigned w1 = hi ? v1.x : v0.y;
  const unsigned w2 = hi ? v1.y : v1.x;
  const unsigned r = 8 * (unsigned)(p & 3);
  const unsigned lo4 = __funnelshift_r(w0, w1, r);
  const unsigned hi4 = __funnelshift_r(w1, w2, r);
  if (step > 0) return make_uint2(lo4, hi4);
  // going left, s[a - 7 .. a] holds cells j + 7 .. j
  return make_uint2(__byte_perm(hi4, 0, 0x0123), __byte_perm(lo4, 0, 0x0123));
}

// the score index of cell k of codes8's pair (a, b)
__device__ __forceinline__ int pair_index(uint2 a, uint2 b, int k, int K) {
  const int sh = 8 * (k & 3);
  const int c1 = (signed char)((k < 4 ? a.x : a.y) >> sh);
  const int c2 = (signed char)((k < 4 ? b.x : b.y) >> sh);
  return c1 * K + c2;
}

__global__ void __launch_bounds__(S1_THREADS) xdrop_stage1_kernel(
    const signed char* __restrict__ s1, const signed char* __restrict__ s2,
    const int* __restrict__ subflat, int K, const int* __restrict__ pos1,
    const int* __restrict__ pos2, const int* __restrict__ n_l,
    const int* __restrict__ n_r, int H, int x_drop, long long pad,
    int* __restrict__ out, int* __restrict__ queue,
    int* __restrict__ counters) {
  __shared__ int s_sub[256];
  for (int e = threadIdx.x; e < K * K; e += blockDim.x) s_sub[e] = subflat[e];
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  bool survive = false;
  if (i < 2LL * H) {
    const Walk w = walk_of(i, H, pos1, pos2, n_l, n_r, pad);
    int cum = 0, runmax = 0, best = 0, kbest = -1;
    int consumed = max(w.n, 0);
    bool stopped = false;
    const int lim = min(w.n, STAGE1_CELLS);
    for (int j0 = 0; j0 < lim && !stopped; j0 += 8) {
      const uint2 a = codes8(s1, w.p1 + w.step * j0, w.step);
      const uint2 b = codes8(s2, w.p2 + w.step * j0, w.step);
      int sc[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) sc[k] = s_sub[pair_index(a, b, k, K)];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int j = j0 + k;
        if (stopped || j >= lim) continue;
        cum = lastz::wadd(cum, sc[k]);
        runmax = max(runmax, cum);
        if (cum > best) {
          best = cum;
          kbest = j;
        }
        if (cum < lastz::wsub(max(runmax, 0), x_drop)) {
          consumed = j + 1;
          stopped = true;
        }
      }
    }
    survive = !stopped && w.n > STAGE1_CELLS;
    if (!survive) put(out, i, H, consumed, best, kbest);
  }
  // one atomicAdd per warp for its survivors' queue slots
  const unsigned lanes = __ballot_sync(lastz::kFullMask, survive);
  if (lanes) {
    const int me = threadIdx.x & 31;
    const int leader = __ffs(lanes) - 1;
    int base = 0;
    if (me == leader) base = atomicAdd(&counters[0], __popc(lanes));
    base = __shfl_sync(lastz::kFullMask, base, leader);
    if (survive)
      queue[base + __popc(lanes & ((1u << me) - 1u))] = (int)i;
  }
}

// The carried state of a stage-2 walk.
struct Scan {
  int cum = 0, runmax = 0, best = 0, kbest = -1, consumed = 0;
};

// cells j0 .. j0 + CHUNK - 1 of a walk, thread t holding [j0 + t * CPT,
// j0 + t * CPT + CPT); FULL: all of them lie before n.  Returns true
// when the walk stops in them.
template <bool FULL>
__device__ __forceinline__ bool scan_chunk(
    const signed char* __restrict__ s1, const signed char* __restrict__ s2,
    const int* s_rep, int K, const Walk& w, int x_drop, int j0, Scan& st) {
  const int t = threadIdx.x & 31;
  const int jb = j0 + t * CPT;
  const uint2 a = codes8(s1, w.p1 + w.step * jb, w.step);
  const uint2 b = codes8(s2, w.p2 + w.step * jb, w.step);
  int c[CPT];
  int sum = 0;
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int s = FULL || jb + k < w.n
        ? s_rep[pair_index(a, b, k, K) * 32 + t] : 0;
    sum = lastz::wadd(sum, s);
    c[k] = sum;
  }
  // exclusive warp scan of the thread sums, carried sum added
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(lastz::kFullMask, incl, off);
    if (t >= off) incl = lastz::wadd(incl, v);
  }
  const int base = lastz::wadd(st.cum, lastz::wsub(incl, sum));
  int tmax = INT_MIN;
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    c[k] = lastz::wadd(base, c[k]);
    tmax = max(tmax, c[k]);
  }
  // exclusive warp prefix max of the thread maxima, carried max added
  int pm = tmax;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(lastz::kFullMask, pm, off);
    if (t >= off) pm = max(pm, v);
  }
  const int before = __shfl_up_sync(lastz::kFullMask, pm, 1);
  // mk: the prefix max through cell k; first: the thread's first
  // failing drop test (cells past n are out of the test)
  int mk = t == 0 ? st.runmax : max(st.runmax, before);
  int first = CPT;
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    mk = max(mk, c[k]);
    if (first == CPT && (FULL || jb + k < w.n) &&
        c[k] < lastz::wsub(max(mk, 0), x_drop))
      first = k;
  }
  const unsigned bad = __ballot_sync(lastz::kFullMask, first < CPT);
  const int stop_t = bad ? __ffs(bad) - 1 : 32;
  // the first maximal sum over the cells up to the stop (or all)
  int tb = INT_MIN, tk = INT_MAX;
  const int last = t < stop_t ? CPT - 1 : t == stop_t ? first : -1;
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    if (k <= last && (FULL || jb + k < w.n) && c[k] > tb) {
      tb = c[k];
      tk = jb + k;
    }
  }
  const int wb = __reduce_max_sync(lastz::kFullMask, tb);
  const int wk = __reduce_min_sync(lastz::kFullMask, tb == wb ? tk : INT_MAX);
  if (wb > st.best) {
    st.best = wb;
    st.kbest = wk;
  }
  if (bad) {
    st.consumed = __shfl_sync(lastz::kFullMask, jb + first, stop_t) + 1;
    return true;
  }
  st.cum = __shfl_sync(lastz::kFullMask, c[CPT - 1], 31);
  st.runmax = __shfl_sync(lastz::kFullMask, mk, 31);
  return false;
}

__global__ void __launch_bounds__(S2_THREADS) xdrop_stage2_kernel(
    const signed char* __restrict__ s1, const signed char* __restrict__ s2,
    const int* __restrict__ subflat, int K, const int* __restrict__ pos1,
    const int* __restrict__ pos2, const int* __restrict__ n_l,
    const int* __restrict__ n_r, int H, int x_drop, long long pad,
    int* __restrict__ out, const int* __restrict__ queue,
    int* __restrict__ counters) {
  // the score table once for each of the 32 threads of a warp, entry e
  // of thread t at 32 e + t
  __shared__ int s_rep[256 * 32];
  for (int e = threadIdx.x; e < 256 * 32; e += blockDim.x)
    s_rep[e] = e / 32 < K * K ? subflat[e / 32] : 0;
  __syncthreads();
  const int t = threadIdx.x & 31;
  const int count = counters[0];
  while (true) {
    int q = 0;
    if (t == 0) q = atomicAdd(&counters[1], GRAB);
    q = __shfl_sync(lastz::kFullMask, q, 0);
    if (q >= count) break;
    for (int g = q; g < min(q + GRAB, count); ++g) {
      const int i = queue[g];
      const Walk w = walk_of(i, H, pos1, pos2, n_l, n_r, pad);
      Scan st;
      st.consumed = w.n;
      for (int j0 = 0; j0 < w.n; j0 += CHUNK) {
        if (j0 + CHUNK <= w.n
                ? scan_chunk<true>(s1, s2, s_rep, K, w, x_drop, j0, st)
                : scan_chunk<false>(s1, s2, s_rep, K, w, x_drop, j0, st))
          break;
      }
      if (t == 0) put(out, i, H, st.consumed, st.best, st.kbest);
    }
  }
}

// the persistent grid: as many stage-2 blocks as fit on the card at once
int stage2_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                  xdrop_stage2_kernel,
                                                  S2_THREADS, 0);
    blocks = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  return blocks;
}

}  // namespace

// out (6, H) int32: left consumed, best, kbest, then right.  queue is
// 2H int32 of scratch; counters (2,) int32 must arrive zeroed (queued
// walks, walks taken).  Both stages run on `stream`, with no host read
// between them.  Returns cudaGetLastError().
extern "C" int xdrop_scan_launch(const signed char* seq1p,
                                 const signed char* seq2p,
                                 const int* subflat, int K, const int* pos1,
                                 const int* pos2, const int* n_l,
                                 const int* n_r, int H, int x_drop,
                                 long long pad, int* out, int* queue,
                                 int* counters, void* stream) {
  if (H == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long nb = (2LL * H + S1_THREADS - 1) / S1_THREADS;
  xdrop_stage1_kernel<<<(unsigned)nb, S1_THREADS, 0, st>>>(
      seq1p, seq2p, subflat, K, pos1, pos2, n_l, n_r, H, x_drop, pad, out,
      queue, counters);
  const long long need = (2LL * H + S2_THREADS / 32 - 1) / (S2_THREADS / 32);
  const int blocks = (int)(need < stage2_blocks() ? need : stage2_blocks());
  xdrop_stage2_kernel<<<blocks, S2_THREADS, 0, st>>>(
      seq1p, seq2p, subflat, K, pos1, pos2, n_l, n_r, H, x_drop, pad, out,
      queue, counters);
  return (int)cudaGetLastError();
}
