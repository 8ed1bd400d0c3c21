// The link-byte walk over a launch's retained traceback blocks.
//
// Replaces lastz_tpu/ops/ydrop_exact.py::traceback_mega_dev, a JAX
// device while_loop (not a Pallas kernel) that steps every lane in
// lockstep; computes what ops/ydrop_exact.traceback_mega_plain
// computes.  As plain torch on the card each step would be about ten
// launches, over thousands of steps per batch.
//
// Bound on an H100: each lane's walk is one dependent chain (link byte
// -> op -> next cell -> next link byte), thousands of steps long, and
// the launch lasts as long as its longest lane.  The bytes it needs
// are 2 a step (one link byte read, one op byte written), so the
// roofline is nothing; the floor of a serial walk is its longest lane's
// steps times the latency of one dependent step.  The first design read
// each step's link byte straight from the (B, K, R1, W) buffer, 1.6 GB
// on the main path: every step moved to a new W-byte row and paid a
// device-memory round trip (about 0.7 us a step on the card).
//
// Design: one warp per lane, one lane per CTA.  The walk moves up and
// to the left, each step lowering the row, the column or both by 1, and
// the clamped block coordinates (local, lane) never rise inside one
// retained block.  So from (local, lane) the next TILE_ROWS - 1 rows up
// and at least TILE_COLS - 16 columns left stay in one tile.  The warp
// copies that tile into shared memory with cp.async, 16 bytes a copy,
// every tile row starting on a 16-byte boundary and every copy in
// flight at once; then one thread walks it from shared memory.  While no
// clamp binds and the row is not 0, the cell's tile index moves with the
// walk, so a step is one shared-memory load and a few selects; other
// steps take the clamped coordinates.  The fast steps go UNROLL at a
// time between two tests of the bounds, so that no branch stands between
// one step's link byte and the next one's load.  A step that leaves the
// tile, or crosses into another block, ends the tile: the warp loads the
// next one at the new position.  The op bytes are staged in shared memory
// and written out by the warp after each tile.  The block index is
// recounted only when the row falls below the row_lo that selected it,
// not on every step.  A lane stops after `cap` steps, which is exactly
// where the lockstep JAX loop leaves it.

#include <cuda_pipeline.h>

#include <climits>

#include "common.cuh"

namespace {

constexpr int C_FROM_I = 1;
constexpr int C_FROM_D = 2;
constexpr int I_EXTEND = 4;
constexpr int D_EXTEND = 8;
constexpr int CID_BITS = 3;
constexpr int OP_S = 1;
constexpr int OP_I = 2;
constexpr int OP_D = 3;

// a tile: TILE_ROWS block rows ending at the walk's row, TILE_COLS
// bytes ending on the 16-byte boundary at or after its lane
constexpr int TILE_ROWS = 64;
constexpr int TILE_COLS = 80;
constexpr int VECS_PER_ROW = TILE_COLS / 16;
// op bytes staged before the warp writes them out
constexpr int OPS_STAGE = 256;
// fast steps taken between two tests of the walk's bounds
constexpr int UNROLL = 8;

static_assert(TILE_COLS % 16 == 0 && TILE_COLS > 16, "tile width");

struct Blocks {
  int blk, lo, c0;
  int thr;  // the block changes once row < thr
};

// blk = max(#{k < nb : row >= lo[k]} - 1, 0), as the lockstep loop
// counts it, and the largest such lo[k]: the count can change only when
// the row falls below it
__device__ __forceinline__ Blocks locate(const int* lo, const int* c0,
                                         int nb, int K, int row) {
  int cnt = 0, thr = INT_MIN;
  for (int k = 0; k < K; ++k) {
    if (k < nb && row >= lo[k]) {
      ++cnt;
      thr = max(thr, lo[k]);
    }
  }
  const int blk = max(cnt - 1, 0);
  return {blk, lo[blk], c0[blk], thr};
}

__global__ void __launch_bounds__(32) ydrop_traceback_kernel(
    const unsigned char* __restrict__ tb_all, const int* __restrict__ row_lo,
    const int* __restrict__ col0, const int* __restrict__ nblk,
    const int* __restrict__ end1, const int* __restrict__ end2,
    const unsigned char* __restrict__ want, unsigned char* __restrict__ ops,
    int* __restrict__ n_out, int* __restrict__ row_out,
    int* __restrict__ col_out, int K, int R1, int W, int cap) {
  __shared__ __align__(16) unsigned char tile[TILE_ROWS * TILE_COLS];
  __shared__ unsigned char staged[OPS_STAGE];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int* lo = row_lo + (long long)b * K;
  const int* c0 = col0 + (long long)b * K;
  const int nb = nblk[b];
  const unsigned char* tbb = tb_all + (long long)b * K * R1 * W;
  unsigned char* opsb = ops + (long long)b * cap;
  // 16-byte loads need 16-byte rows at 16-byte addresses
  const bool vec = (W % 16) == 0 && ((uintptr_t)tb_all % 16) == 0;
  int row = want[b] ? end1[b] : 0;
  int col = want[b] ? end2[b] : 0;
  int prev = 0;
  int n = 0;
  Blocks bk = locate(lo, c0, nb, K, row);
  // every thread keeps the walk's state; thread 0 advances it
  while ((row >= 1 || col > 0) && n < cap) {
    if (row < bk.thr) bk = locate(lo, c0, nb, K, row);
    const int local = min(max(row - (bk.lo - 1), 0), R1 - 1);
    const int lane = min(max(col - bk.c0, 0), W - 1);
    const int rs = local - TILE_ROWS + 1;
    const int cs = ((lane + 16) & ~15) - TILE_COLS;
    const unsigned char* blkp = tbb + (long long)bk.blk * R1 * W;
    for (int v = t; v < TILE_ROWS * VECS_PER_ROW; v += 32) {
      const int gr = rs + v / VECS_PER_ROW;
      const int gc = cs + 16 * (v % VECS_PER_ROW);
      if (gr < 0 || gc < 0) continue;  // never reached
      const unsigned char* src = blkp + (long long)gr * W + gc;
      if (vec)  // cp.async: no registers, every copy in flight at once
        __pipeline_memcpy_async(tile + 16 * v, src, 16);
      else
        for (int i = 0; i < 16 && gc + i < W; ++i) tile[16 * v + i] = src[i];
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncwarp();
    const int n0 = n;
    if (t == 0) {
      // Fast steps, while no clamp binds, the row is not 0 and the walk
      // stays in the tile and the block: then (local, lane) is (row -
      // (lo - 1), col - c0), so the cell's tile index moves with the
      // walk itself, and a step is one shared load and a few selects.
      const int base = (bk.lo - 1 + rs) * TILE_COLS + bk.c0 + cs;
      const int rmin = max(max(bk.lo - 1 + max(rs, 0), bk.thr), 1);
      const int cmin = bk.c0 + max(cs, 0);
      const int rmax = bk.lo - 1 + R1 - 1;
      const int cmax = bk.c0 + W - 1;
      int m = 0;
      while (true) {
        if (row <= rmax && col <= cmax) {
          int idx = row * TILE_COLS + col - base;
          int ext = prev == C_FROM_I ? I_EXTEND : prev == C_FROM_D ? D_EXTEND
                                                                  : 0;
          const int lim = min(cap - n, OPS_STAGE - m);
          auto step = [&](int k) {
            const int link = tile[idx];
            const int op = (link & ext) ? prev : (link & CID_BITS);
            staged[m + k] = (unsigned char)(op == C_FROM_I ? OP_I
                                            : op == C_FROM_D ? OP_D : OP_S);
            const int dr = op != C_FROM_I;
            const int dc = op != C_FROM_D;
            row -= dr;
            col -= dc;
            idx -= dr * TILE_COLS + dc;
            prev = op;
            ext = op == C_FROM_I ? I_EXTEND : op == C_FROM_D ? D_EXTEND : 0;
          };
          // UNROLL steps lower the row and the column by at most UNROLL,
          // so from UNROLL - 1 inside the bounds they need no test: the
          // next link byte's load waits on no branch
          int k = 0;
          for (; k + UNROLL <= lim && row - (UNROLL - 1) >= rmin &&
                 col - (UNROLL - 1) >= cmin;
               k += UNROLL) {
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) step(k + u);
          }
          for (; k < lim && row >= rmin && col >= cmin; ++k) step(k);
          m += k;
          n += k;
        }
        // one step by the clamped coordinates: at a clamp, along row 0,
        // or to find that the walk left the tile or the block, or ended
        if (!((row >= 1 || col > 0) && n < cap && row >= bk.thr &&
              m < OPS_STAGE))
          break;
        const int lc = min(max(row - (bk.lo - 1), 0), R1 - 1);
        const int ln = min(max(col - bk.c0, 0), W - 1);
        if (lc < rs || ln < cs) break;  // left the tile
        const int link = tile[(lc - rs) * TILE_COLS + (ln - cs)];
        int op = link & CID_BITS;
        if (prev == C_FROM_I && (link & I_EXTEND)) op = C_FROM_I;
        if (prev == C_FROM_D && (link & D_EXTEND)) op = C_FROM_D;
        if (row == 0) op = C_FROM_I;  // the row-0 insertion run
        staged[m++] = (unsigned char)(op == C_FROM_I ? OP_I
                                      : op == C_FROM_D ? OP_D : OP_S);
        if (op != C_FROM_I) row -= 1;
        if (op != C_FROM_D) col -= 1;
        prev = op;
        ++n;
      }
    }
    __syncwarp();
    row = __shfl_sync(lastz::kFullMask, row, 0);
    col = __shfl_sync(lastz::kFullMask, col, 0);
    prev = __shfl_sync(lastz::kFullMask, prev, 0);
    n = __shfl_sync(lastz::kFullMask, n, 0);
    for (int i = t; i < n - n0; i += 32) opsb[n0 + i] = staged[i];
    __syncwarp();
  }
  if (t == 0) {
    n_out[b] = n;
    row_out[b] = row;
    col_out[b] = col;
  }
}

}  // namespace

// ops (B, cap) must arrive zeroed.  Returns cudaGetLastError().
extern "C" int ydrop_traceback_launch(
    const unsigned char* tb_all, const int* row_lo, const int* col0,
    const int* nblk, const int* end1, const int* end2,
    const unsigned char* want, unsigned char* ops, int* n, int* row,
    int* col, int B, int K, int R1, int W, int cap, void* stream) {
  if (B == 0) return 0;
  ydrop_traceback_kernel<<<B, 32, 0, (cudaStream_t)stream>>>(
      tb_all, row_lo, col0, nblk, end1, end2, want, ops, n, row, col, K, R1,
      W, cap);
  return (int)cudaGetLastError();
}
