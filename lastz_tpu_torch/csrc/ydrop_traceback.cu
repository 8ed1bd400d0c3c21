// The link-byte walk over a launch's retained traceback blocks.
//
// Replaces lastz_tpu/ops/ydrop_exact.py::traceback_mega_dev, a JAX
// device while_loop (not a Pallas kernel) that steps every lane in
// lockstep; computes what ops/ydrop_exact.traceback_mega_plain
// computes.  As plain torch on the card each step would be about ten
// launches, over thousands of steps per batch.
//
// Layout: one thread per lane walks its own alignment end to start
// (the reference's gap-extension-preferring walk,
// gapped_extend.c:3845-3860), locating each row's block by counting
// the retained blocks whose first row it has reached.  Bound on an
// H100: the latency of one dependent byte load per step; lanes walk
// in parallel and nothing else is read.  A lane stops after `cap`
// steps, which is exactly where the lockstep JAX loop leaves it.

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

__global__ void ydrop_traceback_kernel(
    const unsigned char* __restrict__ tb_all, const int* __restrict__ row_lo,
    const int* __restrict__ col0, const int* __restrict__ nblk,
    const int* __restrict__ end1, const int* __restrict__ end2,
    const unsigned char* __restrict__ want, unsigned char* __restrict__ ops,
    int* __restrict__ n_out, int* __restrict__ row_out,
    int* __restrict__ col_out, int B, int K, int R1, int W, int cap) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int row = want[b] ? end1[b] : 0;
  int col = want[b] ? end2[b] : 0;
  const int* lo = row_lo + (long long)b * K;
  const int* c0 = col0 + (long long)b * K;
  const int nb = nblk[b];
  const unsigned char* tbb = tb_all + (long long)b * K * R1 * W;
  unsigned char* opsb = ops + (long long)b * cap;
  int prev = 0;
  int n = 0;
  while ((row >= 1 || col > 0) && n < cap) {
    int cnt = 0;
    for (int k = 0; k < K; ++k) cnt += (k < nb && row >= lo[k]) ? 1 : 0;
    const int blk = max(cnt - 1, 0);
    const int local = min(max(row - (lo[blk] - 1), 0), R1 - 1);
    const int lane = min(max(col - c0[blk], 0), W - 1);
    const int link = tbb[((long long)blk * R1 + local) * W + lane];
    int op = link & CID_BITS;
    if (prev == C_FROM_I && (link & I_EXTEND)) op = C_FROM_I;
    if (prev == C_FROM_D && (link & D_EXTEND)) op = C_FROM_D;
    if (row == 0) op = C_FROM_I;  // the row-0 insertion run
    opsb[n] = (unsigned char)(op == C_FROM_I ? OP_I
                              : op == C_FROM_D ? OP_D : OP_S);
    if (op != C_FROM_I) row -= 1;
    if (op != C_FROM_D) col -= 1;
    prev = op;
    ++n;
  }
  n_out[b] = n;
  row_out[b] = row;
  col_out[b] = col;
}

}  // namespace

// ops (B, cap) must arrive zeroed.  Returns cudaGetLastError().
extern "C" int ydrop_traceback_launch(
    const unsigned char* tb_all, const int* row_lo, const int* col0,
    const int* nblk, const int* end1, const int* end2,
    const unsigned char* want, unsigned char* ops, int* n, int* row,
    int* col, int B, int K, int R1, int W, int cap, void* stream) {
  const int nt = 128;
  ydrop_traceback_kernel<<<(B + nt - 1) / nt, nt, 0, (cudaStream_t)stream>>>(
      tb_all, row_lo, col0, nblk, end1, end2, want, ops, n, row, col, B, K,
      R1, W, cap);
  return (int)cudaGetLastError();
}
