// The seed stage's diagonal-hash chain walk: the drop protocol of the
// simple hit processor (process_for_simple_hit, seed_search.c:1056-1198)
// and of the recoverable one (process_for_recoverable_hit, :1221-1420)
// over one launch's hits, sorted by the 64K diagonal hash.
//
// Replaces lastz_tpu/ops/hitgen.py::_resolve_chains_dev (:345) and
// _resolve_chains_recover_dev (:408), JAX device while_loops that step
// every chain in lockstep, one chain position a step; computes what
// ops/hitgen._resolve_chains and _resolve_chains_recover compute.  As
// plain torch on the card that lockstep costs about six launches per
// chain position, after a fetch of the chain lengths to the host.
//
// Bound on an H100: the bytes are each hit's extent, start2, diag and
// live flag read once and its alive byte and de_before written once,
// about 18 bytes a hit (a 4M-hit launch: 75 MB, 22 us at 3.35 TB/s).
// But a chain is a serial dependence: a hit's verdict needs the state
// the hits before it on the same hash left, and the launch lasts as
// long as its longest chain.  So the floor is the longest chain's
// length times one dependent step (a compare and a select on the
// state); the loads of a step do not depend on the state.
//
// Design: one thread per chain, walking its chain from the head in
// sorted order, the state in registers.  A chain's hits are contiguous
// in the sorted arrays, so each thread streams its own run of them.
// Chains longer than cap + 1 stop there, as the lockstep loop does
// (such a launch is discarded by the caller).  Simple mode is the
// template's <false>: one state, the diagonal extent; recover mode
// carries the extension's true diagonal beside it and writes each
// chain's final pair.

#include "common.cuh"

namespace {

constexpr int HASH_INACTIVE = -1;
constexpr int THREADS = 128;

template <bool RECOVER>
__global__ void __launch_bounds__(THREADS)
    resolve_chains_kernel(const int* __restrict__ starts,
                          const int* __restrict__ lens, int nch,
                          const int* __restrict__ extent,
                          const int* __restrict__ start2,
                          const int* __restrict__ diag,
                          const unsigned char* __restrict__ live,
                          const int* __restrict__ de0,
                          const int* __restrict__ da0, int H, int cap,
                          unsigned char* __restrict__ alive,
                          int* __restrict__ de_before,
                          int* __restrict__ fin_de,
                          int* __restrict__ fin_da) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= nch) return;
  const int s = starts[c];
  const int n = min(lens[c], cap + 1);
  // the head's state; an empty chain (start H) keeps the last hit's
  const int head = min(s, H - 1);
  int cur = de0[head];
  int curd = RECOVER ? da0[head] : 0;
#pragma unroll 4
  for (int r = 0; r < n; ++r) {
    const int i = s + r;
    const int t = start2[i];
    const int e = extent[i];
    const bool lv = live[i] != 0;
    if (RECOVER) {
      const int dg = diag[i];
      const bool inactive = cur == HASH_INACTIVE;
      const int c0 = inactive ? 0 : cur;
      const int d0 = inactive ? dg : curd;
      const bool covered = !inactive && c0 > t;
      const bool ok = !(covered && d0 == dg);
      de_before[i] = (covered && d0 != dg) ? 0 : c0;
      alive[i] = ok;
      if (lv) {
        const bool upd = ok && e > c0;
        cur = upd ? e : c0;
        curd = upd ? dg : d0;
      }
    } else {
      const bool ok = cur <= t;
      de_before[i] = cur;
      alive[i] = ok;
      if (ok && lv) cur = max(cur, e);
    }
  }
  if (RECOVER) {
    fin_de[c] = cur;
    fin_da[c] = curd;
  }
}

}  // namespace

// alive (H bytes) and de_before (H) come in as 1 and 0, the values of
// the hits no chain walks; fin_de and fin_da (nch each) are written in
// recover mode only.  diag and da0 are read in recover mode only.
extern "C" int resolve_chains_launch(
    const int* starts, const int* lens, int nch, const int* extent,
    const int* start2, const int* diag, const unsigned char* live,
    const int* de0, const int* da0, int H, int recover, int cap,
    unsigned char* alive, int* de_before, int* fin_de, int* fin_da,
    void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int blocks = (nch + THREADS - 1) / THREADS;
  if (recover) {
    resolve_chains_kernel<true><<<blocks, THREADS, 0, st>>>(
        starts, lens, nch, extent, start2, diag, live, de0, da0, H, cap,
        alive, de_before, fin_de, fin_da);
  } else {
    resolve_chains_kernel<false><<<blocks, THREADS, 0, st>>>(
        starts, lens, nch, extent, start2, diag, live, de0, da0, H, cap,
        alive, de_before, fin_de, fin_da);
  }
  return (int)cudaGetLastError();
}
