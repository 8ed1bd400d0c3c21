"""The yardstick of the kernels' rooflines: peaks, and the operations
and bytes of a launch worked out from its inputs and outputs, which
every correct implementation gives alike. No counter the kernel keeps
is read. A later rewrite of a kernel is measured against the same work.

Peaks of one NVIDIA H100 SXM (80 GB HBM3) at its full 700 W:
- HBM: 3.35 TB/s, NVIDIA's data sheet.
- int32: no published figure. 132 SMs x 64 INT32 lanes (four
  sub-partitions of 16) x 1.98 GHz boost clock = 16.73 Tops/s, derived
  from the Hopper whitepaper's SM layout and the SXM part's clock.
A card set below 700 W runs slower; the run prints the card's limit.

Fixed costs a unit of work (the port's own accounting of its kernels):
- K1 (the y-drop mega launch, csrc/ydrop_chunk.cu): 20 int32
  operations a band cell, the cells of each row's live band. A row's
  band is the link bytes the launch writes for it, so a lane's cells
  are the growth of its link-byte offset `tbp` over the launch, an
  output that the traceback walk reads. Bytes: one code of the target
  a row, one of the query a column of each block's window, one link
  byte a band cell (when the launch keeps them), the lanes' CC and DD
  rows read and written, and the block bounds written.
- K2 (the x-drop scan, csrc/xdrop_scan.cu): 5 int32 operations a
  scanned cell, the cells each hit's two scans consume (an output).
  Bytes: a code of each sequence a cell, 16 bytes of hit in and 24 of
  result out.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
K1_OPS_PER_CELL = 20
K2_OPS_PER_CELL = 5


def ideal_s(ops: float, n_bytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(ops / INT32_OPS_PER_S, n_bytes / HBM_BYTES_PER_S)


def k1_work(cells: int, rows: int, blocks: int, lanes: int, width: int,
            max_blocks: int, links: bool = True) -> tuple[float, float]:
    """(operations, bytes) of one mega launch over `lanes` lanes of
    `width` columns that ran `blocks` chunks and `rows` rows in all;
    a launch without `links` writes no link bytes."""
    ops = K1_OPS_PER_CELL * cells
    n_bytes = (rows + blocks * width + (cells if links else 0)
               + 16 * lanes * width + 12 * lanes * max_blocks)
    return float(ops), float(n_bytes)


def k2_work(cells: int, hits: int) -> tuple[float, float]:
    """(operations, bytes) of one x-drop launch over `hits` hits whose
    scans consumed `cells` cells in all."""
    return float(K2_OPS_PER_CELL * cells), float(2 * cells + 40 * hits)
