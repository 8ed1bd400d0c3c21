// The seed stage's diagonal-hash chain walk: the drop protocol of the
// simple hit processor (process_for_simple_hit, seed_search.c:1056-1198)
// and of the recoverable one (process_for_recoverable_hit, :1221-1420)
// over one launch's hits, sorted by the 64K diagonal hash.
//
// Replaces lastz_tpu/ops/hitgen.py::_resolve_chains_dev (:345) and
// _resolve_chains_recover_dev (:408), JAX device while_loops that step
// every chain in lockstep, one chain position a step; computes what
// ops/hitgen._resolve_chains and _resolve_chains_recover compute.
//
// Bound on an H100: the bytes are each hit's extent, start2, diag and
// live flag read once and its alive byte and de_before written once,
// about 18 bytes a hit (a 4M-hit launch: 75 MB, 22 us at 3.35 TB/s).
// But a chain is a serial dependence: a hit's verdict needs the state
// the hits before it on the same hash left, and the launch lasts as
// long as its longest chain.  So the floor is the longest chain's
// length times one dependent step (a compare and a select on the
// state).  No load depends on the state, which is what the design
// uses.
//
// Design: one warp per 32 consecutive chains, whose hits are one
// contiguous run of the sorted arrays (chains are in sorted order, and
// chain c's hits run from starts[c] to starts[c + 1], or to H for the
// last chain that has any; on the main path a run is about 1,600
// hits).  The warp stages its run through shared memory in tiles of
// TILE hits: every field is read with coalesced loads, STAGE hits a
// lane issued before the first store; each lane walks the part of its
// own chain in the tile from shared memory, state in registers, the
// chains of a tile all at once; and the warp
// writes the tile's verdicts back with coalesced stores, each over
// the start2 word and live byte it has consumed.  Every slot of a
// chain's run is written, walked or not: a chain walks min(len, cap +
// 1) hits from its head (such a launch is discarded by the caller
// when len > cap), and the hits it does not walk (past cap + 1, or a
// whole chain of length 0, as chain_bounds makes the chain of the dead
// hits) get (alive, de_before) = (1, 0); so the outputs need no fill.
// The dead hits' chain is the last with hits and can hold a fifth of a
// launch: every warp writes a slice of its run, rather than its own
// warp tile by tile.  A step reads its hit from shared memory, which
// does not depend on the state, so a walk is a chain of compares and
// selects.  Simple mode is the template's <false>: one state, the
// diagonal extent; recover mode carries the extension's true diagonal
// beside it and writes each chain's final pair.
//
// Measured (kernel_bench.py, the first 4M-slot launch of the 4 Mbp main
// path, kernel alone, H100 at 700 W): about 0.05 ms against 0.15 for
// the first port's one thread per chain (with the fills its wrapper
// made), three times the byte bound.  What is left is mostly the
// staging: all warps load at once, then walk, then store, so the
// memory is idle while they walk.  Tried and dropped: one thread per
// chain with 16 hits loaded ahead in registers and a warp for each
// chain of more than 96 hits (0.200 ms a launch: a thread streaming its
// own chain makes every warp load and store touch 32 lines, so the
// load/store unit set the pace; 8 hits ahead, a threshold of 64 or
// 160, or no warp walk at all, no better than 0.169); tiles of 128,
// 256 or 512 hits (too few chains walk at once), 768 or 2048 (fewer
// warps fit); 4 warps or 1 a block; 4 or 8 hits read ahead of the walk
// in registers (no gain: the walk is not what bounds it); 8 or 32 hits
// a lane per staging round.

#include "common.cuh"

namespace {

using namespace lastz;

constexpr int HASH_INACTIVE = -1;
constexpr int THREADS = 64;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 1024;  // hits a warp stages at once
constexpr int STAGE = 16;   // hits a lane loads before it stores any
// shared memory a warp takes: start2 and extent words (and diag), a
// live byte; a walked hit's de_before and verdict replace its start2
// and live byte
__host__ __device__ constexpr int tile_bytes(bool recover) {
  return TILE * (recover ? 13 : 9);
}

// One hit of a chain: its verdict, its de_before, and the state after it.
template <bool RECOVER>
__device__ __forceinline__ bool step(int& cur, int& curd, int t, int e,
                                     int dg, bool lv, int& deb) {
  if (RECOVER) {
    const bool inactive = cur == HASH_INACTIVE;
    const int c0 = inactive ? 0 : cur;
    const int d0 = inactive ? dg : curd;
    const bool covered = !inactive && c0 > t;
    const bool ok = !(covered && d0 == dg);
    deb = (covered && d0 != dg) ? 0 : c0;
    if (lv) {
      const bool upd = ok && e > c0;
      cur = upd ? e : c0;
      curd = upd ? dg : d0;
    }
    return ok;
  }
  const bool ok = cur <= t;
  deb = cur;
  if (ok && lv) cur = max(cur, e);
  return ok;
}

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
  extern __shared__ int4 s_raw[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * THREADS + threadIdx.x;

  // this lane's chain: its run [s, end), the n hits it walks, and the
  // state at its head (an empty chain, start H, keeps the last hit's);
  // the run of the last chain with hits is written below when the
  // chain has length 0
  int s = H, end = 0, n = 0, cur = 0, curd = 0;
  if (c < nch) {
    s = starts[c];
    const int head = min(s, H - 1);
    cur = de0[head];
    curd = RECOVER ? da0[head] : 0;
    if (s < H) {
      end = c + 1 < nch ? starts[c + 1] : H;
      n = min(lens[c], cap + 1);
      if (end == H && n == 0) end = s;
    }
  }
  // the warp's run of hits
  const int lo = __reduce_min_sync(kFullMask, s);
  const int hi = __reduce_max_sync(kFullMask, end);

  unsigned char* base =
      reinterpret_cast<unsigned char*>(s_raw) + warp * tile_bytes(RECOVER);
  int* s_t = reinterpret_cast<int*>(base);  // then de_before
  int* s_e = s_t + TILE;
  int* s_dg = s_e + TILE;  // recover mode only
  unsigned char* s_lv = base + (RECOVER ? 12 : 8) * TILE;  // then 2 | ok
  for (int t0 = lo; t0 < hi; t0 += TILE) {
    const int m = min(TILE, hi - t0);
    // STAGE hits a lane, every load issued before the first store
    for (int k0 = lane; k0 < m; k0 += 32 * STAGE) {
      int t[STAGE], e[STAGE], dg[STAGE];
      unsigned char lv[STAGE];
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int i = t0 + k0 + 32 * u;
        const bool in = k0 + 32 * u < m;
        t[u] = in ? __ldg(start2 + i) : 0;
        e[u] = in ? __ldg(extent + i) : 0;
        dg[u] = (in && RECOVER) ? __ldg(diag + i) : 0;
        lv[u] = in ? __ldg(live + i) : 0;
      }
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int k = k0 + 32 * u;
        if (k < m) {
          s_t[k] = t[u];
          s_e[k] = e[u];
          if (RECOVER) s_dg[k] = dg[u];
          s_lv[k] = lv[u] != 0;
        }
      }
    }
    __syncwarp();
    // this lane's hits in the tile, in chain order
    const int a = max(s, t0) - t0;
    const int b = min(s + n, t0 + m) - t0;
    for (int k = a; k < b; ++k) {
      int deb;
      const bool ok = step<RECOVER>(cur, curd, s_t[k], s_e[k],
                                    RECOVER ? s_dg[k] : 0, s_lv[k] != 0,
                                    deb);
      s_t[k] = deb;
      s_lv[k] = 2 | ok;
    }
    __syncwarp();
    // a hit no chain walked (its byte still 0 or 1) gets (1, 0)
#pragma unroll 8
    for (int k = lane; k < m; k += 32) {
      const int v = s_lv[k];
      de_before[t0 + k] = v & 2 ? s_t[k] : 0;
      alive[t0 + k] = v & 2 ? v & 1 : 1;
    }
    __syncwarp();
  }
  if (RECOVER && c < nch) {
    fin_de[c] = cur;
    fin_da[c] = curd;
  }

  // the run of the last chain with hits, when that chain has length 0
  // (chain_bounds' chain of the dead hits, which runs to H): every warp
  // writes a slice of it, rather than its own warp tile by tile.  L
  // ends at the first chain that starts at H, found by a 32-way search
  int L = 0, R = nch;
  while (R > L) {
    const int st = (R - L + 31) / 32;
    const int pos = L + lane * st;
    const bool below = pos < R && __ldg(starts + pos) < H;
    const int cnt = __popc(__ballot_sync(kFullMask, below));
    const int nl = cnt ? L + (cnt - 1) * st + 1 : L;
    R = min(R, L + cnt * st);
    L = nl;
  }
  const int dead = (L > 0 && __ldg(lens + L - 1) == 0)
                       ? __ldg(starts + L - 1) : H;
  const int nw = gridDim.x * WARPS;
  const int slice = (H - dead + nw - 1) / nw;
  const int d0 = dead + (blockIdx.x * WARPS + warp) * slice;
  for (int i = d0 + lane; i < min(d0 + slice, H); i += 32) {
    alive[i] = 1;
    de_before[i] = 0;
  }
}

template <bool RECOVER, typename... Args>
int launch(int blocks, cudaStream_t st, Args... args) {
  constexpr int shm = WARPS * tile_bytes(RECOVER);
  static const cudaError_t set = cudaFuncSetAttribute(
      resolve_chains_kernel<RECOVER>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, shm);
  if (set != cudaSuccess) return (int)set;
  resolve_chains_kernel<RECOVER><<<blocks, THREADS, shm, st>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// Writes every one of the H alive bytes and de_before values, and in
// recover mode fin_de and fin_da (nch each); diag and da0 are read in
// recover mode only.  starts and lens come from chain_bounds: chains
// in sorted order, each nonempty one starting where the one before it
// ends, the first at 0, the empty ones (start H) after them.
extern "C" int resolve_chains_launch(
    const int* starts, const int* lens, int nch, const int* extent,
    const int* start2, const int* diag, const unsigned char* live,
    const int* de0, const int* da0, int H, int recover, int cap,
    unsigned char* alive, int* de_before, int* fin_de, int* fin_da,
    void* stream) {
  if (nch < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int blocks = (nch + THREADS - 1) / THREADS;
  return recover ? launch<true>(blocks, st, starts, lens, nch, extent,
                                start2, diag, live, de0, da0, H, cap,
                                alive, de_before, fin_de, fin_da)
                 : launch<false>(blocks, st, starts, lens, nch, extent,
                                 start2, diag, live, de0, da0, H, cap,
                                 alive, de_before, fin_de, fin_da);
}
