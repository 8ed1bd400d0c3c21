// K2 on Hopper: the gap-free x-drop extension of every seed hit, right
// from p and left from p-1 (reference xdrop_extend_seed_hit,
// seed_search.c:2528-2801).
//
// Replaces lastz_tpu/ops/xdrop_pallas.py's kernel (_make_kernel,
// launched by xdrop_scan_pallas); equals ops/hitgen._xdrop_all's final
// (consumed, best, kbest) for each side.
//
// Layout: one thread per (hit, direction) walks its diagonal cell by
// cell over the whole SEQ_PAD-padded int8 sequences in device memory,
// with the K x K score table in shared memory.  A scan stops at the
// first cell where the running sum falls below max(runmax, 0) - x_drop
// (that cell counts in `consumed`) or after n cells; `best` moves only
// on a strictly greater sum, so the first index wins ties.  Reading
// whole sequences needs no windows, escapes or continuation waves.
//
// Bound on an H100: the dependent byte loads of the cell walk (two
// per cell, from L2 at best: the 4 Mbp target and query fit the 50 MB
// L2).  Almost every random hit dies within a few dozen cells, so the
// launch is many short, divergent walks; the design keeps no state
// but seven registers per walk and writes 12 bytes per direction.

#include "common.cuh"

namespace {

__global__ void xdrop_scan_kernel(const signed char* __restrict__ s1,
                                  const signed char* __restrict__ s2,
                                  const int* __restrict__ subflat, int K,
                                  const int* __restrict__ pos1,
                                  const int* __restrict__ pos2,
                                  const int* __restrict__ n_l,
                                  const int* __restrict__ n_r, int H,
                                  int x_drop, long long pad,
                                  int* __restrict__ out) {
  __shared__ int s_sub[256];
  for (int i = threadIdx.x; i < K * K; i += blockDim.x) s_sub[i] = subflat[i];
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2LL * H) return;
  const bool left = i >= H;
  const int h = (int)(left ? i - H : i);
  const int n = left ? n_l[h] : n_r[h];
  const long long step = left ? -1 : 1;
  const long long p1 = pad + pos1[h] + (left ? -1 : 0);
  const long long p2 = pad + pos2[h] + (left ? -1 : 0);
  int cum = 0, runmax = 0, best = 0, kbest = -1, consumed = 0;
  if (n > 0) {
    consumed = n;
    for (int j = 0; j < n; ++j) {
      const int c1 = s1[p1 + step * j];
      const int c2 = s2[p2 + step * j];
      cum = lastz::wadd(cum, s_sub[c1 * K + c2]);
      runmax = max(runmax, cum);
      if (cum > best) {
        best = cum;
        kbest = j;
      }
      if (cum < lastz::wsub(max(runmax, 0), x_drop)) {
        consumed = j + 1;
        break;
      }
    }
  }
  if (best <= 0) kbest = -1;
  int* o = out + (left ? 0 : 3) * (long long)H;
  o[h] = consumed;
  o[H + h] = best;
  o[2LL * H + h] = kbest;
}

}  // namespace

// out (6, H) int32: left consumed, best, kbest, then right.  Returns
// cudaGetLastError().
extern "C" int xdrop_scan_launch(const signed char* seq1p,
                                 const signed char* seq2p,
                                 const int* subflat, int K, const int* pos1,
                                 const int* pos2, const int* n_l,
                                 const int* n_r, int H, int x_drop,
                                 long long pad, int* out, void* stream) {
  const int nt = 256;
  const long long nb = (2LL * H + nt - 1) / nt;
  xdrop_scan_kernel<<<(unsigned)nb, nt, 0, (cudaStream_t)stream>>>(
      seq1p, seq2p, subflat, K, pos1, pos2, n_l, n_r, H, x_drop, pad, out);
  return (int)cudaGetLastError();
}
