// Native inner loops for the exact host engine.
//
// The y-drop DP row sweep (the reference's hottest loop,
// gapped_extend.c:3683-3775) and the x-drop diagonal scan
// (seed_search.c:2623-2700) are bit-exact ports of the semantics of
// lastz_tpu's Python engine (which is itself the correctness oracle for
// the Pallas TPU kernels).  Built as a plain-C-ABI shared library and
// loaded via ctypes; no pybind11 required.
//
// Build:  g++ -O3 -march=native -shared -fPIC ydrop_row.cpp -o libydrop.so

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstdio>
#include <immintrin.h>

extern "C" {

// result block written back to Python after each row
struct RowResult {
    int64_t LY;         // possibly advanced by pruning
    int64_t np_col;     // last non-pruned column
    int64_t i_val;      // running I value at loop exit
    int64_t best_score;
    int64_t end1, end2;
    int64_t end_is_boundary;
    int64_t boundary_score;
    int64_t dq;         // cells written (next write index)
    int64_t tbp;        // traceback bytes written (next write index)
};

// Compute one DP row, columns [LY, RY) clipped to col <= N.
//
//   CC, DD:    sweep arrays; reads at index (col - prev_LY), writes at
//              (col - LY_orig_adjusted) exactly like the reference's
//              dp/dq pointers.
//   MASK:      row-stamped mask array, read at (col - prev_LY)
//   tb:        traceback byte array, writes from tbp
//   sub_row:   int64[256] substitution scores for A[row]
//   B:         the horizontal sequence (uint8)
//   b_origin, b_step: B character for column c is B[b_origin + b_step*c]
//
// Semantics notes (all mirror the reference exactly):
//   - prune when cell is masked or c < best - ydrop; at the left edge
//     pruning advances LY, otherwise it writes -inf cells
//   - D preferred over I when both improve C
//   - best-score ties move the alignment end (>=)
//   - when trim_to_peak is false, boundary-reaching cells (row==M or
//     col==N) track a separate boundary score

void ydrop_row(
    int64_t* CC, int64_t* DD, int64_t* MASK,
    uint8_t* tb,
    const int64_t* sub_row,
    const uint8_t* B, int64_t b_origin, int64_t b_step,
    int64_t row, int64_t M, int64_t N,
    int64_t LY, int64_t RY, int64_t prev_LY,
    int64_t gap_e, int64_t gap_oe, int64_t y_drop,
    int64_t neg_inf,
    int64_t best_score, int64_t end1, int64_t end2,
    int64_t end_is_boundary, int64_t boundary_score,
    int64_t trim_to_peak, int64_t have_active,
    int64_t tbp,
    RowResult* out)
{
    int64_t shift = LY - prev_LY;
    int64_t col = LY;
    int64_t np_col = col;
    int64_t i_val = neg_inf;
    int64_t c = neg_inf;
    int64_t dp = shift;
    int64_t dq = 0;

    // Branch-minimized form of the reference's per-cell logic.  The
    // naive transcription branches per cell on masked / can-improve /
    // prune, all data-dependent on diverged sequence, and the
    // mispredicts dominate the sweep.  Here every cell runs the same
    // straight-line code with cmov-style selects.  Semantics are
    // byte-identical (link bytes, prune restarts, LY advance, tie
    // handling) — pinned by tests/test_ydrop_exact.py and the
    // device-path goldens.
    bool lead = true;            // still inside the leading prune run
    while (col < RY && col <= N) {
        int64_t d = DD[dp];
        bool masked = have_active && (MASK[dp] == row);
        // next cell's diagonal restart value; independent of this
        // cell, but must be read before CC[dq] is stored (dq can
        // equal dp when shift is 0)
        int64_t c_next = (col + 1 <= N)
            ? CC[dp] + sub_row[B[b_origin + b_step * (col + 1)]]
            : neg_inf;

        int64_t g = d >= i_val ? d : i_val;      // best gap source
        bool canC = (g > c);
        int64_t c_eff = canC ? g : c;            // cell value if kept
        bool pr = masked | (c_eff < best_score - y_drop);

        // can-improve outputs
        uint8_t link_c = d >= i_val ? (uint8_t)(2 | 4 | 8)
                                    : (uint8_t)(1 | 4 | 8);
        int64_t d2 = d - gap_e;
        // no-improve outputs
        int64_t c_open = c_eff - gap_oe;
        int64_t dd_n = c_open > d2 ? c_open : d2;
        uint8_t link_n = c_open > d2 ? (uint8_t)0 : (uint8_t)8;
        int64_t i2 = i_val - gap_e;
        int64_t iv_n = c_open > i2 ? c_open : i2;
        link_n |= c_open > i2 ? (uint8_t)0 : (uint8_t)4;

        // best / boundary bookkeeping (no-improve kept cells only)
        bool bu = !canC & !pr & (c_eff >= best_score);
        best_score = bu ? c_eff : best_score;
        end1 = bu ? row : end1;
        end2 = bu ? col : end2;
        end_is_boundary = bu ? 0 : end_is_boundary;
        if (__builtin_expect(!trim_to_peak && !canC && !pr
                             && (row == M || col == N)
                             && c_eff >= boundary_score, 0)) {
            boundary_score = c_eff; end1 = row; end2 = col;
            end_is_boundary = 1;
        }

        int64_t dd_out = canC ? d2 : dd_n;
        int64_t iv_out = canC ? i2 : iv_n;
        uint8_t link = canC ? link_c : link_n;

        i_val = pr ? neg_inf : iv_out;
        CC[dq] = pr ? neg_inf : c_eff;
        DD[dq] = pr ? neg_inf : dd_out;
        np_col = pr ? np_col : col;
        tb[tbp++] = pr ? (uint8_t)0 : link;
        lead = lead & pr;
        LY += lead ? 1 : 0;
        dq += lead ? 0 : 1;
        dp++;
        c = c_next;
        col++;
    }

    out->LY = LY;
    out->np_col = np_col;
    out->i_val = i_val;
    out->best_score = best_score;
    out->end1 = end1;
    out->end2 = end2;
    out->end_is_boundary = end_is_boundary;
    out->boundary_score = boundary_score;
    out->dq = dq;
    out->tbp = tbp;
}

// X-drop gap-free extension scan (one direction).
//
// Scores the run starting just outside the scanned range; returns the
// number of consumed elements, the best prefix score, and the index of
// the FIRST prefix achieving it (strict-improvement rule).
//
//   sv:   int64 scores of successive steps (already gathered)
//   n:    number of candidate steps
void xdrop_scan(
    const int64_t* sv, int64_t n, int64_t x_drop,
    int64_t* out_consumed, int64_t* out_best, int64_t* out_best_ix)
{
    int64_t run = 0, best = 0, best_ix = -1;
    int64_t k = 0;
    for (; k < n; k++) {
        if (run < best - x_drop) break;
        run += sv[k];
        if (run > best) { best = run; best_ix = k; }
    }
    *out_consumed = k;
    *out_best = best;
    *out_best_ix = best_ix;
}

// gather substitution scores for a diagonal run:
//   out[k] = sub[ s1[p1 + d1*k] ][ s2[p2 + d2*k] ]
void gather_diag_scores(
    const uint8_t* s1, const uint8_t* s2,
    const int64_t* sub,  // 256*256
    int64_t p1, int64_t p2, int64_t d1, int64_t d2, int64_t n,
    int64_t* out)
{
    for (int64_t k = 0; k < n; k++)
        out[k] = sub[((int64_t)s1[p1 + d1 * k]) * 256 + s2[p2 + d2 * k]];
}

// ---------------------------------------------------------------------------
// Vectorized x-drop scan core.
//
// The gap-free extension scan is a strictly serial recurrence
// (run += sub[a][b]; best = max; stop when run < best - x_drop) whose
// per-step cost is dominated by the dependent byte->byte->table load
// chain (~13 cycles/step measured).  Expressed as 16-wide int16
// blocks it becomes: pair-score via a 16-entry pshufb LUT, a prefix
// SUM scan (the running score), a prefix MAX scan (the running best),
// and a compare for the first x-drop violation — ~1 cycle/step.
//
// Exactness: the block math reproduces the scalar recurrence
// bit-for-bit (relative-to-best values are bounded by x_drop + 16*127
// so int16 never saturates; gated on x_drop <= 28000).  The LUT fast
// path is VALIDATED against the actual substitution matrix at call
// time — any score set where uppercase ACGT pairs aren't int8 or
// don't map via code = (c>>1)&3 (A0 C1 T2 G3) disables it — and any
// block containing a character outside uppercase ACGT (N, lowercase
// masked bytes, separators) reverts to the scalar loop for the
// scan's remainder.

struct SimdCtx {
    int valid;
    __m128i lut;          // int8 scores, index = code(a)*4 + code(b)
};

static void simd_ctx_init(SimdCtx* ctx, const int64_t* sub,
                          int64_t x_drop)
{
    ctx->valid = 0;
    if (x_drop < 0 || x_drop > 28000) return;
    // code = (c>>1)&3 maps A->0 C->1 T->2 G->3.  Only UPPERCASE
    // ACGT pairs ride the LUT (the in-block screen rejects any
    // other byte, including lowercase, which the production matrix
    // scores differently when softmasked input is penalized).
    static const uint8_t UP[4] = {'A', 'C', 'T', 'G'};
    int8_t lut[16];
    for (int ca = 0; ca < 4; ++ca) {
        for (int cb = 0; cb < 4; ++cb) {
            int64_t v = sub[(int64_t)UP[ca] * 256 + UP[cb]];
            if (v < -128 || v > 127) return;
            lut[ca * 4 + cb] = (int8_t)v;
        }
    }
    ctx->lut = _mm_loadu_si128((const __m128i*)lut);
    ctx->valid = 1;
}

// per-128-lane broadcast of word 7 (bytes 14,15)
static inline __m256i bcast_last_word(__m256i x)
{
    const __m256i sel = _mm256_set1_epi16(0x0F0E);
    return _mm256_shuffle_epi8(x, sel);
}

static inline __m256i scan_add16(__m256i x)
{
    x = _mm256_add_epi16(x, _mm256_slli_si256(x, 2));
    x = _mm256_add_epi16(x, _mm256_slli_si256(x, 4));
    x = _mm256_add_epi16(x, _mm256_slli_si256(x, 8));
    // carry the low lane's total into the high lane
    __m256i last = bcast_last_word(x);
    __m256i lo_all = _mm256_permute2x128_si256(last, last, 0x00);
    __m256i hi_only = _mm256_permute2x128_si256(
        _mm256_setzero_si256(), _mm256_set1_epi8(-1), 0x30);
    return _mm256_add_epi16(x, _mm256_and_si256(lo_all, hi_only));
}

// prefix max clamped at 0: RM[j] = max(0, P[0..j]).  The lane shifts
// inject zeros only into windows that overrun the lane start (j<7),
// and the cross-lane carry is the UNCLAMPED low-lane max, so a final
// max-with-zero is required for exactness at j=7,15 and for the
// carried value (missing it let RM-x_drop wrap int16 and produce
// false x-drop violations at lane boundaries).
static inline __m256i scan_max16_zeroseed(__m256i x)
{
    x = _mm256_max_epi16(x, _mm256_slli_si256(x, 2));
    x = _mm256_max_epi16(x, _mm256_slli_si256(x, 4));
    x = _mm256_max_epi16(x, _mm256_slli_si256(x, 8));
    __m256i last = bcast_last_word(x);
    __m256i lo_all = _mm256_permute2x128_si256(last, last, 0x00);
    __m256i hi_only = _mm256_permute2x128_si256(
        _mm256_setzero_si256(), _mm256_set1_epi8(-1), 0x30);
    x = _mm256_max_epi16(x, _mm256_and_si256(lo_all, hi_only));
    return _mm256_max_epi16(x, _mm256_setzero_si256());
}

static inline int16_t hmax16(__m256i x)
{
    __m128i a = _mm_max_epi16(_mm256_castsi256_si128(x),
                              _mm256_extracti128_si256(x, 1));
    a = _mm_max_epi16(a, _mm_srli_si128(a, 8));
    a = _mm_max_epi16(a, _mm_srli_si128(a, 4));
    a = _mm_max_epi16(a, _mm_srli_si128(a, 2));
    return (int16_t)_mm_extract_epi16(a, 0);
}

// One x-drop scan: k-th pair is (s1[p1 + step*k], s2[p2 + step*k]),
// at most n steps.  Scalar recurrence (exact contract, shared by
// xdrop_extend_seed_hit and the batch scan):
//   run += score; if (run > best) { best = run; kbest = k; }
//   if (run < best - x_drop) { consumed = k+1; stop; }
// kbest stays -1 unless best goes positive.
static void xdrop_scan_core(
    const uint8_t* s1, const uint8_t* s2, const int64_t* sub,
    const SimdCtx* ctx, int64_t p1, int64_t p2, int64_t n,
    int64_t step, int64_t x_drop,
    int64_t* out_consumed, int64_t* out_best, int64_t* out_kbest)
{
    int64_t run = 0, best = 0, kbest = -1;
    int64_t k = 0;

    if (ctx && ctx->valid) {
        const __m128i REV = _mm_set_epi8(0, 1, 2, 3, 4, 5, 6, 7,
                                         8, 9, 10, 11, 12, 13, 14, 15);
        const __m128i M3 = _mm_set1_epi8(3);
        const __m128i M12 = _mm_set1_epi8(12);
        // NUC[code] reconstructs the byte a code came from; equality
        // with the original byte IS the uppercase-ACGT screen
        const __m128i NUC = _mm_setr_epi8(
            'A', 'C', 'T', 'G', 'A', 'C', 'T', 'G',
            'A', 'C', 'T', 'G', 'A', 'C', 'T', 'G');
        const __m256i XD = _mm256_set1_epi16((int16_t)x_drop);
        const __m256i IDX = _mm256_setr_epi16(0, 1, 2, 3, 4, 5, 6, 7,
                                              8, 9, 10, 11, 12, 13,
                                              14, 15);
        while (k + 16 <= n) {
            __m128i a, b;
            if (step > 0) {
                a = _mm_loadu_si128((const __m128i*)(s1 + p1 + k));
                b = _mm_loadu_si128((const __m128i*)(s2 + p2 + k));
            } else {
                a = _mm_shuffle_epi8(_mm_loadu_si128(
                        (const __m128i*)(s1 + p1 - k - 15)), REV);
                b = _mm_shuffle_epi8(_mm_loadu_si128(
                        (const __m128i*)(s2 + p2 - k - 15)), REV);
            }
            __m128i ca2 = _mm_and_si128(_mm_srli_epi16(a, 1), M3);
            __m128i cb2 = _mm_and_si128(_mm_srli_epi16(b, 1), M3);
            __m128i ok = _mm_and_si128(
                _mm_cmpeq_epi8(_mm_shuffle_epi8(NUC, ca2), a),
                _mm_cmpeq_epi8(_mm_shuffle_epi8(NUC, cb2), b));
            if (_mm_movemask_epi8(ok) != 0xFFFF)
                break;  // irregular characters: finish scalar

            __m128i idx = _mm_or_si128(
                _mm_and_si128(_mm_slli_epi16(ca2, 2), M12), cb2);
            __m128i s8 = _mm_shuffle_epi8(ctx->lut, idx);
            __m256i s16 = _mm256_cvtepi8_epi16(s8);

            // P[j] = (run - best) + sum(scores[0..j])
            __m256i P = _mm256_add_epi16(
                scan_add16(s16),
                _mm256_set1_epi16((int16_t)(run - best)));
            // RM[j] = max(0, max P[0..j]) — running best, relative
            __m256i RM = scan_max16_zeroseed(P);
            // violation: P[j] < RM[j] - x_drop
            __m256i vio = _mm256_cmpgt_epi16(_mm256_sub_epi16(RM, XD),
                                             P);
            uint32_t vm = (uint32_t)_mm256_movemask_epi8(vio);
            int t = vm ? (int)(_tzcnt_u32(vm) >> 1) : 16;

            __m256i Pm = P;
            if (t < 16) {
                __m256i keep = _mm256_cmpgt_epi16(
                    _mm256_set1_epi16((int16_t)(t + 1)), IDX);
                Pm = _mm256_blendv_epi8(_mm256_set1_epi16(-32768),
                                        P, keep);
            }
            // best advances only when some prefix goes positive —
            // rare on junk hits, so gate the horizontal reduction
            uint32_t posm = (uint32_t)_mm256_movemask_epi8(
                _mm256_cmpgt_epi16(Pm, _mm256_setzero_si256()));
            int16_t bmax = 0;
            if (__builtin_expect(posm != 0, 0)) {
                bmax = hmax16(Pm);
                __m256i eq = _mm256_cmpeq_epi16(
                    Pm, _mm256_set1_epi16(bmax));
                uint32_t em = (uint32_t)_mm256_movemask_epi8(eq);
                kbest = k + (int64_t)(_tzcnt_u32(em) >> 1);
                best += bmax;
            }
            if (t < 16) {
                // run at the violating step (relative values are to
                // the OLD best)
                int16_t pbuf[16];
                _mm256_storeu_si256((__m256i*)pbuf, P);
                run = (best - (bmax > 0 ? bmax : 0)) + pbuf[t];
                *out_consumed = k + t + 1;
                *out_best = best;
                *out_kbest = kbest;
                return;
            }
            int16_t pbuf[16];
            _mm256_storeu_si256((__m256i*)pbuf, P);
            run = (best - (bmax > 0 ? bmax : 0)) + pbuf[15];
            k += 16;
        }
    }

    for (; k < n; ++k) {
        run += sub[((int64_t)s1[p1 + step * k]) * 256
                   + s2[p2 + step * k]];
        if (run > best) { best = run; kbest = k; }
        if (run < best - x_drop) {
            *out_consumed = k + 1;
            *out_best = best;
            *out_kbest = kbest;
            return;
        }
    }
    *out_consumed = n;
    *out_best = best;
    *out_kbest = kbest;
}

// Combined x-drop extension of a seed hit (both directions), exactly
// mirroring xdrop_extend_seed_hit (seed_search.c:2528): left scan from
// the right end of the hit down to `stop_left` (seq1 coordinate), right
// scan up to `stop_right`.  Returns components for the caller to apply
// entropy adjustment and thresholding.
static inline int64_t xdrop_extend_impl(
    const uint8_t* s1, const uint8_t* s2, const int64_t* sub,
    const SimdCtx* ctx,
    int64_t pos1, int64_t pos2,
    int64_t stop_left, int64_t stop_right, int64_t x_drop,
    int64_t* out_left_start, int64_t* out_left_score,
    int64_t* out_right_stop, int64_t* out_right_score,
    int64_t* out_right_block)
{
    // left scan (pre-decrement semantics: first pair read is at pos1-1)
    int64_t nl = pos1 - stop_left;
    int64_t cons, best, kb;
    xdrop_scan_core(s1, s2, sub, ctx, pos1 - 1, pos2 - 1,
                    nl > 0 ? nl : 0, -1, x_drop, &cons, &best, &kb);
    *out_left_start = (kb >= 0) ? pos1 - 1 - kb : pos1;
    *out_left_score = best;
    int64_t steps = cons;

    // right scan
    int64_t nr = stop_right - pos1;
    xdrop_scan_core(s1, s2, sub, ctx, pos1, pos2,
                    nr > 0 ? nr : 0, +1, x_drop, &cons, &best, &kb);
    *out_right_stop = (kb >= 0) ? pos1 + kb + 1 : pos1;
    *out_right_score = best;
    *out_right_block = pos1 + cons;
    return steps + cons;
}

void xdrop_extend(
    const uint8_t* s1, const uint8_t* s2, const int64_t* sub,
    int64_t pos1, int64_t pos2,            // hit END positions
    int64_t stop_left,                     // leftmost seq1 index allowed
    int64_t stop_right,                    // one-past rightmost seq1 index
    int64_t x_drop,
    int64_t* out_left_start,               // leftmost seq1 index included
    int64_t* out_left_score,
    int64_t* out_right_stop,               // one past rightmost included
    int64_t* out_right_score,
    int64_t* out_right_block)              // where the right scan stopped
{
    SimdCtx ctx;
    simd_ctx_init(&ctx, sub, x_drop);
    xdrop_extend_impl(s1, s2, sub, &ctx, pos1, pos2, stop_left,
                      stop_right, x_drop, out_left_start,
                      out_left_score, out_right_stop, out_right_score,
                      out_right_block);
}

// xdrop_extend of n hits in one call (the seed stage's array replay of
// bind rows, search/device_hits.py): hit i from its own stop_left[i]
// and stop_right[i]; out holds five rows of n: left_start, left_score,
// right_stop, right_score, right_block.
void xdrop_extend_many(
    const uint8_t* s1, const uint8_t* s2, const int64_t* sub,
    int64_t n, const int64_t* pos1, const int64_t* pos2,
    const int64_t* stop_left, const int64_t* stop_right,
    int64_t x_drop, int64_t* out)
{
    SimdCtx ctx;
    simd_ctx_init(&ctx, sub, x_drop);
    for (int64_t i = 0; i < n; ++i)
        xdrop_extend_impl(s1, s2, sub, &ctx, pos1[i], pos2[i],
                          stop_left[i], stop_right[i], x_drop,
                          out + i, out + n + i, out + 2 * n + i,
                          out + 3 * n + i, out + 4 * n + i);
}

// Narrow-state row step used by ydrop_sweep: int32 cell values and
// row stamps (scores are s32 by the same contract as the reference's
// `score` type), and the substitution scores for the row's span are
// pre-gathered into S so the cell loop carries no dependent
// byte->table load chain.  Semantically identical to ydrop_row —
// the int32 sentinel is deep enough (INT32_MIN/2) that every
// comparison orders the same way as the int64 path.
struct RowResult32 {
    int64_t LY, np_col;
    int32_t i_val, best_score;
    int64_t end1, end2;
    int64_t end_is_boundary;
    int32_t boundary_score;
    int64_t dq, tbp;
};

// the tight main loop, specialized on whether active-segment masking
// is live this row.  Kept cells set bit 4 (value 16) in their tb
// byte — ignored by the traceback walker, it lets np_col be
// recovered by a back-scan instead of a per-cell select.
static inline void row32_main(
    const int32_t* CCr,              // prev-row C at col   (index j)
    const int32_t* DDr,              // prev-row D at col   (index j)
    const int32_t* __restrict MKr,   // mask stamps at col  (index j)
    int32_t* CCw, int32_t* DDw,      // (alias CCr/DDr ranges, trailing)
    uint8_t* __restrict tbb,         // tb bytes at col     (index j)
    const int32_t* __restrict Sx,    // sub score at col+1  (index j)
    int64_t nB, int32_t row32, bool HAS_MASK,
    int32_t gap_e, int32_t gap_oe, int32_t y_drop, int32_t neg_inf,
    int32_t& c_io, int32_t& i_io, int32_t& best_io, int32_t& ycut_io,
    uint64_t& endrc_io,
    int64_t col0)
{
    int32_t c = c_io, i_val = i_io;
    int32_t best_score = best_io, yd_cut = ycut_io;
    uint64_t end_rc = endrc_io;
    const uint64_t row_hi = (uint64_t)(uint32_t)row32 << 32;
    for (int64_t j = 0; j < nB; ++j) {
        int32_t d = DDr[j];
        int32_t c_next = CCr[j] + Sx[j];
        bool masked = HAS_MASK && (MKr[j] == row32);

        int32_t g = d >= i_val ? d : i_val;
        bool canC = (g > c);
        int32_t c_eff = canC ? g : c;
        bool pr = masked | (c_eff < yd_cut);

        uint8_t link_c = d >= i_val ? (uint8_t)(16 | 2 | 4 | 8)
                                    : (uint8_t)(16 | 1 | 4 | 8);
        int32_t d2 = d - gap_e;
        int32_t c_open = c_eff - gap_oe;
        int32_t dd_n = c_open > d2 ? c_open : d2;
        uint8_t link_n = c_open > d2 ? (uint8_t)16 : (uint8_t)(16 | 8);
        int32_t i2 = i_val - gap_e;
        int32_t iv_n = c_open > i2 ? c_open : i2;
        link_n |= c_open > i2 ? (uint8_t)0 : (uint8_t)4;

        // best advances on ~1 cell per row (the running peak), so a
        // predicted-not-taken branch beats four unconditional cmovs
        if (__builtin_expect(!canC & !pr & (c_eff >= best_score), 0)) {
            best_score = c_eff;
            yd_cut = c_eff - y_drop;
            end_rc = row_hi | (uint64_t)(uint32_t)(int32_t)(col0 + j);
        }
        // boundary cells cannot occur here: the caller routes the
        // column-N cell and whole M-rows through the generic loop

        int32_t dd_out = canC ? d2 : dd_n;
        int32_t iv_out = canC ? i2 : iv_n;
        uint8_t link = canC ? link_c : link_n;

        i_val = pr ? neg_inf : iv_out;
        CCw[j] = pr ? neg_inf : c_eff;
        DDw[j] = pr ? neg_inf : dd_out;
        tbb[j] = pr ? (uint8_t)0 : link;
        c = c_next;
    }
    c_io = c; i_io = i_val; best_io = best_score; ycut_io = yd_cut;
    endrc_io = end_rc;
}

// ---------------------------------------------------------------------------
// 8-wide AVX2 row step (the no-masking specialization of row32_main).
//
// The only intra-row serial chain is the I state (horizontal gap).
// Two facts make it vectorizable without changing any output byte:
//
//  1. I's refresh value at column j is A[j] = (D[j] > Cdiag[j])
//     ? -inf : Cdiag[j] - gap_oe, which is INDEPENDENT of I: in the
//     one case where the scalar takes iv_out = i - gap_e despite
//     d <= c (namely i > c), i - gap_e > c - gap_oe anyway, so
//     folding the phantom refresh into a max() changes nothing.
//     Hence I obeys v[j+1] = max(v[j] - gap_e, A[j]) — a decayed
//     prefix max, computed 8 lanes at a time as
//     (prefix-max of A[k] + k*gap_e) - j*gap_e.
//  2. The true chain additionally RESETS v to -inf at pruned cells.
//     A cell can only be pruned while its I contribution is below
//     yd_cut, and any contribution crossing a reset point stays
//     below yd_cut forever after (it decays from a sub-cut value).
//     So the reset-free chain agrees with the true chain whenever
//     either is >= yd_cut — which makes every DECISION (prune, canC,
//     c_eff) computable from the reset-free pass.  The link bytes'
//     I-vs-reopen tie (c_open == i - gapE) could still be steered by
//     a phantom value, so a SECOND in-block pass re-scans the chain
//     with resets at the (now exactly known) pruned lanes; links and
//     the inter-block carry come from that exact chain, making the
//     whole row bit-exact with the scalar recurrence.
//
// best_score updates are rare (~1 cell/row): blocks whose candidate
// mask fires are re-run through the scalar row32_main from the
// block-entry state (with the exact carry), which also applies the
// yd_cut tightening mid-block exactly.
static inline void row32_main_avx(
    const int32_t* CCr, const int32_t* DDr, const int32_t* MKr,
    int32_t* CCw, int32_t* DDw, uint8_t* tbb, const int32_t* Sx,
    int64_t nB, int32_t row32,
    int32_t gap_e, int32_t gap_oe, int32_t y_drop, int32_t neg_inf,
    int32_t& c_io, int32_t& i_io, int32_t& best_io, int32_t& ycut_io,
    uint64_t& endrc_io, int64_t col0)
{
    // cell 0 reads the caller-seeded diagonal; run it scalar so the
    // vector blocks can take Cdiag[j] straight from CCr[j-1]+Sx[j-1]
    row32_main(CCr, DDr, MKr, CCw, DDw, tbb, Sx, 1, row32, false,
               gap_e, gap_oe, y_drop, neg_inf,
               c_io, i_io, best_io, ycut_io, endrc_io, col0);
    int64_t j = 1;

    const __m256i NI8 = _mm256_set1_epi32(neg_inf);
    const __m256i GE = _mm256_set1_epi32(gap_e);
    const __m256i GOE = _mm256_set1_epi32(gap_oe);
    const __m256i RAMP = _mm256_setr_epi32(0, gap_e, 2 * gap_e,
                                           3 * gap_e, 4 * gap_e,
                                           5 * gap_e, 6 * gap_e,
                                           7 * gap_e);
    const __m256i SH1 = _mm256_setr_epi32(0, 0, 1, 2, 3, 4, 5, 6);
    const __m256i C16 = _mm256_set1_epi32(16);
    const __m256i C29 = _mm256_set1_epi32(16 | 1 | 4 | 8);
    const __m256i C30 = _mm256_set1_epi32(16 | 2 | 4 | 8);
    const __m256i C4 = _mm256_set1_epi32(4);
    const __m256i C8 = _mm256_set1_epi32(8);
    const __m128i PACK = _mm_setr_epi8(0, 4, 8, 12, -1, -1, -1, -1,
                                       -1, -1, -1, -1, -1, -1, -1,
                                       -1);
    int32_t carry_i = i_io;
    // raw previous-row diagonal CCr_old[j-1], carried as a scalar:
    // loading CCr+j-1 would partially overlap the previous block's
    // store (store-to-load-forward failure); load the hazard-free
    // CCr[j..j+7] and shift the carried lane in
    int32_t diag_raw = c_io - Sx[0];

    while (j + 8 <= nB) {
        __m256i LDC = _mm256_loadu_si256((const __m256i*)(CCr + j));
        int32_t diag_next = CCr[j + 7];    // pre-store value
        __m256i csh = _mm256_blend_epi32(
            _mm256_permutevar8x32_epi32(LDC, SH1),
            _mm256_set1_epi32(diag_raw), 0x01);
        __m256i cd = _mm256_add_epi32(
            csh, _mm256_loadu_si256((const __m256i*)(Sx + j - 1)));
        __m256i d = _mm256_loadu_si256((const __m256i*)(DDr + j));
        // reset-free decayed prefix max of the refresh values; the
        // no-refresh sentinel sits BELOW any decayed chain value
        // (neg_inf - k*gap_e) so that for reset-free blocks this
        // chain — seeded with the exact carry — IS the exact chain
        const __m256i LOWS = _mm256_set1_epi32(neg_inf - (1 << 28));
        __m256i dgtcd = _mm256_cmpgt_epi32(d, cd);
        __m256i B = _mm256_add_epi32(
            _mm256_blendv_epi8(_mm256_sub_epi32(cd, GOE), LOWS,
                               dgtcd),
            RAMP);
        __m256i x = _mm256_max_epi32(
            B, _mm256_alignr_epi8(B, LOWS, 12));
        x = _mm256_max_epi32(x, _mm256_alignr_epi8(x, LOWS, 8));
        __m256i t3 = _mm256_shuffle_epi32(x, 0xFF);
        __m256i lo_all = _mm256_permute2x128_si256(t3, t3, 0x00);
        __m256i PM = _mm256_max_epi32(
            x, _mm256_blend_epi32(LOWS, lo_all, 0xF0));
        __m256i SH = _mm256_blend_epi32(
            _mm256_permutevar8x32_epi32(PM, SH1), LOWS, 0x01);
        __m256i Y = _mm256_max_epi32(
            SH, _mm256_set1_epi32(carry_i - gap_e));
        __m256i v = _mm256_add_epi32(_mm256_sub_epi32(Y, RAMP), GE);

        __m256i g = _mm256_max_epi32(d, v);
        __m256i canC = _mm256_cmpgt_epi32(g, cd);
        __m256i c_eff = _mm256_max_epi32(g, cd);
        __m256i pr = _mm256_cmpgt_epi32(
            _mm256_set1_epi32(ycut_io), c_eff);
        __m256i cand = _mm256_andnot_si256(
            canC, _mm256_andnot_si256(
                pr, _mm256_cmpgt_epi32(
                    c_eff, _mm256_set1_epi32(best_io - 1))));
        if (__builtin_expect(!_mm256_testz_si256(cand, cand), 0)) {
            // possible best update: replay the block scalar (exact
            // best/yd_cut/end bookkeeping), then resume
            int32_t c_entry = diag_raw + Sx[j - 1];
            row32_main(CCr + j, DDr + j, MKr + j, CCw + j, DDw + j,
                       tbb + j, Sx + j, 8, row32, false,
                       gap_e, gap_oe, y_drop, neg_inf,
                       c_entry, carry_i, best_io, ycut_io,
                       endrc_io, col0 + j);
            diag_raw = diag_next;
            j += 8;
            continue;
        }

        __m256i vx;
        if (_mm256_testz_si256(pr, pr)) {
            // no resets in this block: the reset-free chain (seeded
            // with the exact carry) is already exact
            vx = v;
            __m256i pm7v = _mm256_permutevar8x32_epi32(
                PM, _mm256_set1_epi32(7));
            int32_t pm7 = _mm_cvtsi128_si32(
                _mm256_castsi256_si128(pm7v));
            int32_t ci = carry_i - gap_e;
            carry_i = (pm7 > ci ? pm7 : ci) - 7 * gap_e;
        } else {
        // -- pass 2: exact chain with resets at the pruned lanes
        // (inclusive scan of (s2 if r2 else max(s1,s2), r1|r2) over
        // the compensated elements, log-shift by 1, 2 lanes per half
        // plus a cross-half combine)
        __m256i es = _mm256_blendv_epi8(
            B, _mm256_add_epi32(NI8, RAMP), pr);
        __m256i er = pr;
        {
            __m256i s_sh = _mm256_alignr_epi8(es, LOWS, 12);
            __m256i r_sh = _mm256_alignr_epi8(
                er, _mm256_setzero_si256(), 12);
            es = _mm256_blendv_epi8(
                _mm256_max_epi32(es, s_sh), es, er);
            er = _mm256_or_si256(er, r_sh);
            s_sh = _mm256_alignr_epi8(es, LOWS, 8);
            r_sh = _mm256_alignr_epi8(
                er, _mm256_setzero_si256(), 8);
            es = _mm256_blendv_epi8(
                _mm256_max_epi32(es, s_sh), es, er);
            er = _mm256_or_si256(er, r_sh);
            // cross-half combine: after the per-half rounds each
            // half's scan is complete, so every high lane combines
            // with the LOW HALF'S INCLUSIVE TOTAL (lane 3), not a
            // lane-shifted window
            __m256i t3s = _mm256_shuffle_epi32(es, 0xFF);
            __m256i lo3s = _mm256_permute2x128_si256(t3s, t3s, 0x00);
            __m256i t3r = _mm256_shuffle_epi32(er, 0xFF);
            __m256i lo3r = _mm256_permute2x128_si256(t3r, t3r, 0x00);
            __m256i cmb = _mm256_blendv_epi8(
                _mm256_max_epi32(es, lo3s), es, er);
            es = _mm256_blend_epi32(es, cmb, 0xF0);
            er = _mm256_blend_epi32(
                er, _mm256_or_si256(er, lo3r), 0xF0);
        }
        // fold in the exact carry wherever no reset was seen yet
        __m256i cstar = _mm256_set1_epi32(carry_i - gap_e);
        __m256i s_fin = _mm256_blendv_epi8(
            _mm256_max_epi32(es, cstar), es, er);
        // exclusive shift; lane 0 gets the carry
        __m256i SHx = _mm256_blend_epi32(
            _mm256_permutevar8x32_epi32(s_fin, SH1), cstar, 0x01);
        vx = _mm256_add_epi32(_mm256_sub_epi32(SHx, RAMP), GE);

        // exact carry for the next block: chain value entering lane 8
        __m256i s7v = _mm256_permutevar8x32_epi32(
            s_fin, _mm256_set1_epi32(7));
        carry_i = _mm_cvtsi128_si32(_mm256_castsi256_si128(s7v))
                  - 7 * gap_e;
        }

        __m256i i2 = _mm256_sub_epi32(vx, GE);
        __m256i c_open = _mm256_sub_epi32(c_eff, GOE);
        __m256i d2 = _mm256_sub_epi32(d, GE);
        __m256i dd = _mm256_blendv_epi8(
            _mm256_max_epi32(c_open, d2), d2, canC);
        // link bytes (from the exact chain)
        __m256i link_c = _mm256_blendv_epi8(
            C30, C29, _mm256_cmpgt_epi32(vx, d));  // v > d -> from I
        __m256i b8 = _mm256_andnot_si256(
            _mm256_cmpgt_epi32(c_open, d2), C8);
        __m256i b4 = _mm256_andnot_si256(
            _mm256_cmpgt_epi32(c_open, i2), C4);
        __m256i link_n = _mm256_or_si256(C16,
                                         _mm256_or_si256(b8, b4));
        __m256i link = _mm256_blendv_epi8(link_n, link_c, canC);
        link = _mm256_andnot_si256(pr, link);

        __m256i cc_out = _mm256_blendv_epi8(c_eff, NI8, pr);
        __m256i dd_out = _mm256_blendv_epi8(dd, NI8, pr);

        _mm256_storeu_si256((__m256i*)(CCw + j), cc_out);
        _mm256_storeu_si256((__m256i*)(DDw + j), dd_out);
        __m128i plo = _mm_shuffle_epi8(
            _mm256_castsi256_si128(link), PACK);
        __m128i phi = _mm_shuffle_epi8(
            _mm256_extracti128_si256(link, 1), PACK);
        uint32_t wlo = (uint32_t)_mm_cvtsi128_si32(plo);
        uint32_t whi = (uint32_t)_mm_cvtsi128_si32(phi);
        memcpy(tbb + j, &wlo, 4);
        memcpy(tbb + j + 4, &whi, 4);

        diag_raw = diag_next;
        j += 8;
    }

    if (j < nB) {
        int32_t c_entry = diag_raw + Sx[j - 1];
        row32_main(CCr + j, DDr + j, MKr + j, CCw + j, DDw + j,
                   tbb + j, Sx + j, nB - j, row32, false,
                   gap_e, gap_oe, y_drop, neg_inf,
                   c_entry, carry_i, best_io, ycut_io,
                   endrc_io, col0 + j);
        c_io = c_entry;
        i_io = carry_i;
    } else {
        c_io = diag_raw + Sx[nB - 1];
        i_io = carry_i;
    }
}

// finer per-phase cycle buckets inside ydrop_row32, filled only
// under LASTZ_TORCH_SWEEP_PROF=1; fetched via sweep_prof_phases()
static int sweep_prof_enabled();
static thread_local int64_t g_cy_phaseA = 0, g_cy_main = 0,
    g_cy_phaseC = 0, g_cy_npcol = 0;
static thread_local int64_t g_blk_total = 0, g_blk_reset = 0,
    g_blk_redo = 0, g_tail_cells = 0;

void sweep_prof_phases(int64_t* out8)
{
    out8[0] = g_cy_phaseA;
    out8[1] = g_cy_main;
    out8[2] = g_cy_phaseC;
    out8[3] = g_cy_npcol;
    out8[4] = g_blk_total;
    out8[5] = g_blk_reset;
    out8[6] = g_blk_redo;
    out8[7] = g_tail_cells;
}

#if defined(__AVX512F__) && defined(__AVX512BW__) && defined(__AVX512VL__)
// 16-wide AVX-512 row step: same two-pass scheme as row32_main_avx,
// but full-width lane shifts (valignd) and mask registers halve the
// serial chain per cell.
static inline void row32_main_avx512(
    const int32_t* CCr, const int32_t* DDr, const int32_t* MKr,
    int32_t* CCw, int32_t* DDw, uint8_t* tbb, const int32_t* Sx,
    int64_t nB, int32_t row32,
    int32_t gap_e, int32_t gap_oe, int32_t y_drop, int32_t neg_inf,
    int32_t& c_io, int32_t& i_io, int32_t& best_io, int32_t& ycut_io,
    uint64_t& endrc_io, int64_t col0)
{
    row32_main(CCr, DDr, MKr, CCw, DDw, tbb, Sx, 1, row32, false,
               gap_e, gap_oe, y_drop, neg_inf,
               c_io, i_io, best_io, ycut_io, endrc_io, col0);
    int64_t j = 1;

    const __m512i NI = _mm512_set1_epi32(neg_inf);
    const __m512i GE = _mm512_set1_epi32(gap_e);
    const __m512i GOE = _mm512_set1_epi32(gap_oe);
    const __m512i LOWS = _mm512_set1_epi32(neg_inf - (1 << 28));
    int32_t ramp[16];
    for (int t = 0; t < 16; ++t) ramp[t] = t * gap_e;
    const __m512i RAMP = _mm512_loadu_si512(ramp);
    const __m512i NIR = _mm512_add_epi32(NI, RAMP);
    const __m512i C16v = _mm512_set1_epi32(16);
    const __m512i C29v = _mm512_set1_epi32(16 | 1 | 4 | 8);
    const __m512i C30v = _mm512_set1_epi32(16 | 2 | 4 | 8);
    const __m512i C4v = _mm512_set1_epi32(4);
    const __m512i C8v = _mm512_set1_epi32(8);

    int32_t carry_i = i_io;
    // raw previous-row diagonal CCr_old[j-1], carried as a scalar:
    // loading CCr+j-1 directly would partially overlap the previous
    // block's 64-byte store (store-to-load-forward failure, ~20cy
    // per block); instead load the hazard-free CCr[j..j+15] and
    // shift the carried lane in with valignd
    int32_t diag_raw = c_io - Sx[0];

    while (j + 16 <= nB) {
        __m512i LDC = _mm512_loadu_si512(CCr + j);
        int32_t diag_next = CCr[j + 15];   // pre-store value
        __m512i cd = _mm512_add_epi32(
            _mm512_alignr_epi32(LDC, _mm512_set1_epi32(diag_raw),
                                15),
            _mm512_loadu_si512(Sx + j - 1));
        __m512i d = _mm512_loadu_si512(DDr + j);
        __mmask16 dgtcd = _mm512_cmpgt_epi32_mask(d, cd);
        __m512i B = _mm512_add_epi32(
            _mm512_mask_mov_epi32(_mm512_sub_epi32(cd, GOE), dgtcd,
                                  LOWS),
            RAMP);
        // reset-free decayed prefix max (LOWS no-refresh sentinel)
        __m512i x = _mm512_max_epi32(
            B, _mm512_alignr_epi32(B, LOWS, 15));
        x = _mm512_max_epi32(x, _mm512_alignr_epi32(x, LOWS, 14));
        x = _mm512_max_epi32(x, _mm512_alignr_epi32(x, LOWS, 12));
        __m512i PM = _mm512_max_epi32(
            x, _mm512_alignr_epi32(x, LOWS, 8));
        __m512i SH = _mm512_alignr_epi32(PM, LOWS, 15);
        __m512i Y = _mm512_max_epi32(
            SH, _mm512_set1_epi32(carry_i - gap_e));
        __m512i v = _mm512_add_epi32(_mm512_sub_epi32(Y, RAMP), GE);

        __m512i g = _mm512_max_epi32(d, v);
        __mmask16 canC = _mm512_cmpgt_epi32_mask(g, cd);
        __m512i c_eff = _mm512_max_epi32(g, cd);
        __mmask16 pr = _mm512_cmpgt_epi32_mask(
            _mm512_set1_epi32(ycut_io), c_eff);
        __mmask16 cand = (__mmask16)(
            ~((unsigned)canC | (unsigned)pr)
            & (unsigned)_mm512_cmpgt_epi32_mask(
                c_eff, _mm512_set1_epi32(best_io - 1)));
        ++g_blk_total;
        if (__builtin_expect(cand != 0, 0)) {
            ++g_blk_redo;
            int32_t c_entry = diag_raw + Sx[j - 1];
            row32_main(CCr + j, DDr + j, MKr + j, CCw + j, DDw + j,
                       tbb + j, Sx + j, 16, row32, false,
                       gap_e, gap_oe, y_drop, neg_inf,
                       c_entry, carry_i, best_io, ycut_io,
                       endrc_io, col0 + j);
            diag_raw = diag_next;
            j += 16;
            continue;
        }

        g_blk_reset += (pr != 0);
        __m512i vx;
        if (pr == 0) {
            vx = v;
            int32_t pm15 = _mm_extract_epi32(
                _mm512_extracti32x4_epi32(PM, 3), 3);
            int32_t ci = carry_i - gap_e;
            carry_i = (pm15 > ci ? pm15 : ci) - 15 * gap_e;
        } else {
            // exact chain: segmented scan with resets at pruned lanes
            __m512i es = _mm512_mask_mov_epi32(B, pr, NIR);
            __mmask16 er = pr;
#define ROW512_SEG_ROUND(SHIFT, IMM)                                 \
            {                                                        \
                __m512i s_sh = _mm512_alignr_epi32(es, LOWS, IMM);   \
                __mmask16 r_sh = (__mmask16)((unsigned)er << SHIFT); \
                es = _mm512_mask_mov_epi32(                          \
                    _mm512_max_epi32(es, s_sh), er, es);             \
                er = (__mmask16)((unsigned)er | (unsigned)r_sh);     \
            }
            ROW512_SEG_ROUND(1, 15)
            ROW512_SEG_ROUND(2, 14)
            ROW512_SEG_ROUND(4, 12)
            ROW512_SEG_ROUND(8, 8)
#undef ROW512_SEG_ROUND
            __m512i cstar = _mm512_set1_epi32(carry_i - gap_e);
            __m512i s_fin = _mm512_mask_mov_epi32(
                _mm512_max_epi32(es, cstar), er, es);
            __m512i SHx = _mm512_mask_mov_epi32(
                _mm512_alignr_epi32(s_fin, LOWS, 15), 0x0001, cstar);
            vx = _mm512_add_epi32(_mm512_sub_epi32(SHx, RAMP), GE);
            carry_i = _mm_extract_epi32(
                _mm512_extracti32x4_epi32(s_fin, 3), 3) - 15 * gap_e;
        }

        __m512i i2 = _mm512_sub_epi32(vx, GE);
        __m512i c_open = _mm512_sub_epi32(c_eff, GOE);
        __m512i d2 = _mm512_sub_epi32(d, GE);
        __m512i dd = _mm512_mask_mov_epi32(
            _mm512_max_epi32(c_open, d2), canC, d2);
        __m512i link_c = _mm512_mask_mov_epi32(
            C30v, _mm512_cmpgt_epi32_mask(vx, d), C29v);
        __m512i link_n = _mm512_or_epi32(
            C16v,
            _mm512_or_epi32(
                _mm512_maskz_mov_epi32(
                    (__mmask16)~(unsigned)_mm512_cmpgt_epi32_mask(
                        c_open, d2), C8v),
                _mm512_maskz_mov_epi32(
                    (__mmask16)~(unsigned)_mm512_cmpgt_epi32_mask(
                        c_open, i2), C4v)));
        __m512i link = _mm512_maskz_mov_epi32(
            (__mmask16)~(unsigned)pr,
            _mm512_mask_mov_epi32(link_n, canC, link_c));
        __m512i cc_out = _mm512_mask_mov_epi32(c_eff, pr, NI);
        __m512i dd_out = _mm512_mask_mov_epi32(dd, pr, NI);

        _mm512_storeu_si512(CCw + j, cc_out);
        _mm512_storeu_si512(DDw + j, dd_out);
        _mm_storeu_si128((__m128i*)(tbb + j),
                         _mm512_cvtepi32_epi8(link));
        diag_raw = diag_next;
        j += 16;
    }

    if (j < nB) {
        g_tail_cells += nB - j;
        int32_t c_entry = diag_raw + Sx[j - 1];
        row32_main(CCr + j, DDr + j, MKr + j, CCw + j, DDw + j,
                   tbb + j, Sx + j, nB - j, row32, false,
                   gap_e, gap_oe, y_drop, neg_inf,
                   c_entry, carry_i, best_io, ycut_io,
                   endrc_io, col0 + j);
        c_io = c_entry;
        i_io = carry_i;
    } else {
        c_io = diag_raw + Sx[nB - 1];
        i_io = carry_i;
    }
}
#endif  // AVX-512

// 0 = scalar only, 1 = AVX2 8-wide, 2 = AVX-512 16-wide (default
// when compiled in; LASTZ_TORCH_NO_AVX512_ROW drops to AVX2,
// LASTZ_TORCH_NO_AVX_ROW to scalar)
static int row_avx_enabled()
{
    static int v = -1;
    if (v < 0) {
        const char* e = getenv("LASTZ_TORCH_NO_AVX_ROW");
        if (e && e[0] && e[0] != '0')
            v = 0;
        else {
            const char* f = getenv("LASTZ_TORCH_NO_AVX512_ROW");
            v = (f && f[0] && f[0] != '0') ? 1 : 2;
        }
    }
    return v;
}

__attribute__((noinline))
static void ydrop_row32(
    int32_t* __restrict CC, int32_t* __restrict DD,
    const int32_t* __restrict MASK,
    uint8_t* __restrict tb,
    const int32_t* __restrict S,          // S[k]: sub score at col LY+k
    int64_t row, int64_t M, int64_t N,
    int64_t LY, int64_t RY, int64_t prev_LY,
    int32_t gap_e, int32_t gap_oe, int32_t y_drop, int32_t neg_inf,
    int32_t best_score, int64_t end1, int64_t end2,
    int64_t end_is_boundary, int32_t boundary_score,
    int64_t trim_to_peak, int64_t have_active,
    int64_t tbp,
    RowResult32* out)
{
    const int64_t LY0 = LY;
    const int rprof = sweep_prof_enabled();
    uint64_t rpt = rprof ? __builtin_ia32_rdtsc() : 0;
    int64_t col = LY;
    int64_t np_col = col;
    int32_t i_val = neg_inf;
    int32_t c = neg_inf;
    const int32_t row32 = (int32_t)row;
    int32_t yd_cut = best_score - y_drop;
    uint64_t end_rc = ((uint64_t)end_is_boundary << 63)
                      | ((uint64_t)(uint32_t)end1 << 32)
                      | (uint64_t)(uint32_t)end2;
    const int64_t last_col = (RY - 1 < N) ? RY - 1 : N;
    uint8_t* tbw = tb + tbp;

    // -- phase A: the leading prune run (advances LY; writes nothing
    // to the cell arrays)
    while (col <= last_col) {
        int32_t d = DD[col - prev_LY];
        bool masked = have_active && (MASK[col - prev_LY] == row32);
        int32_t g = d >= i_val ? d : i_val;
        int32_t c_eff = g > c ? g : c;
        if (!masked && c_eff >= yd_cut) break;    // first kept cell
        c = (col < N) ? CC[col - prev_LY] + S[col + 1 - LY0]
                      : neg_inf;
        *tbw++ = 0;
        ++col;
        ++LY;
    }

    if (rprof) {
        uint64_t t = __builtin_ia32_rdtsc();
        g_cy_phaseA += t - rpt; rpt = t;
    }
    // -- phase B: tight main loop; the final cell is handled
    // separately when it sits on column N (boundary semantics and
    // the c_next guard differ there)
    int64_t mainB_end = (last_col == N) ? last_col - 1 : last_col;
    int64_t nB = mainB_end - col + 1;
    const bool row_bdry = !trim_to_peak && row == M;
    if (nB > 0 && !row_bdry) {
        int64_t off_r = col - prev_LY;
        int64_t off_w = col - LY;
        if (have_active)
            row32_main(
                CC + off_r, DD + off_r, MASK + off_r,
                CC + off_w, DD + off_w, tbw,
                S + col + 1 - LY0, nB, row32, true,
                gap_e, gap_oe, y_drop, neg_inf,
                c, i_val, best_score, yd_cut, end_rc,
                col);
#if defined(__AVX512F__) && defined(__AVX512BW__) && defined(__AVX512VL__)
        else if (nB >= 32 && row_avx_enabled() == 2)
            row32_main_avx512(
                CC + off_r, DD + off_r, MASK + off_r,
                CC + off_w, DD + off_w, tbw,
                S + col + 1 - LY0, nB, row32,
                gap_e, gap_oe, y_drop, neg_inf,
                c, i_val, best_score, yd_cut, end_rc,
                col);
#endif
        else if (nB >= 16 && row_avx_enabled())
            row32_main_avx(
                CC + off_r, DD + off_r, MASK + off_r,
                CC + off_w, DD + off_w, tbw,
                S + col + 1 - LY0, nB, row32,
                gap_e, gap_oe, y_drop, neg_inf,
                c, i_val, best_score, yd_cut, end_rc,
                col);
        else
            row32_main(
                CC + off_r, DD + off_r, MASK + off_r,
                CC + off_w, DD + off_w, tbw,
                S + col + 1 - LY0, nB, row32, false,
                gap_e, gap_oe, y_drop, neg_inf,
                c, i_val, best_score, yd_cut, end_rc,
                col);
        tbw += nB;
        col += nB;
    }

    if (rprof) {
        uint64_t t = __builtin_ia32_rdtsc();
        g_cy_main += t - rpt; rpt = t;
    }
    // -- phase C: generic per-cell loop for whatever remains (the
    // column-N cell, or every kept cell of a boundary row)
    for (; col <= last_col; ++col) {
        int32_t d = DD[col - prev_LY];
        bool masked = have_active && (MASK[col - prev_LY] == row32);
        int32_t c_next = (col < N)
            ? CC[col - prev_LY] + S[col + 1 - LY0]
            : neg_inf;

        int32_t g = d >= i_val ? d : i_val;
        bool canC = (g > c);
        int32_t c_eff = canC ? g : c;
        bool pr = masked | (c_eff < yd_cut);

        uint8_t link_c = d >= i_val ? (uint8_t)(16 | 2 | 4 | 8)
                                    : (uint8_t)(16 | 1 | 4 | 8);
        int32_t d2 = d - gap_e;
        int32_t c_open = c_eff - gap_oe;
        int32_t dd_n = c_open > d2 ? c_open : d2;
        uint8_t link_n = c_open > d2 ? (uint8_t)16 : (uint8_t)(16 | 8);
        int32_t i2 = i_val - gap_e;
        int32_t iv_n = c_open > i2 ? c_open : i2;
        link_n |= c_open > i2 ? (uint8_t)0 : (uint8_t)4;

        bool bu = !canC & !pr & (c_eff >= best_score);
        best_score = bu ? c_eff : best_score;
        yd_cut = bu ? c_eff - y_drop : yd_cut;
        uint64_t rc = ((uint64_t)(uint32_t)row32 << 32)
                      | (uint64_t)(uint32_t)(int32_t)col;
        end_rc = bu ? rc : end_rc;
        if (__builtin_expect(!trim_to_peak && !canC && !pr
                             && (row == M || col == N)
                             && c_eff >= boundary_score, 0)) {
            boundary_score = c_eff;
            end_rc = rc | (1ULL << 63);
        }

        int32_t dd_out = canC ? d2 : dd_n;
        int32_t iv_out = canC ? i2 : iv_n;
        uint8_t link = canC ? link_c : link_n;

        i_val = pr ? neg_inf : iv_out;
        CC[col - LY] = pr ? neg_inf : c_eff;
        DD[col - LY] = pr ? neg_inf : dd_out;
        tbw[0] = pr ? (uint8_t)0 : link;
        ++tbw;
        c = c_next;
    }

    if (rprof) {
        uint64_t t = __builtin_ia32_rdtsc();
        g_cy_phaseC += t - rpt; rpt = t;
    }
    // np_col = rightmost kept cell (bit 4 marks kept tb bytes);
    // if nothing was kept it stays at the row's entry column
    {
        uint8_t* tb0 = tb + tbp;        // includes phase-A zeros
        int64_t cells = tbw - tb0;
        int64_t k = cells - 1;
        while (k >= 0 && !(tb0[k] & 16)) --k;
        np_col = (k >= 0) ? LY0 + k : LY0;
    }

    if (rprof)
        g_cy_npcol += __builtin_ia32_rdtsc() - rpt;
    out->LY = LY;
    out->np_col = np_col;
    out->i_val = i_val;
    out->best_score = best_score;
    out->end1 = (int64_t)((end_rc >> 32) & 0x7fffffffULL);
    out->end2 = (int64_t)(uint32_t)end_rc;
    out->end_is_boundary = (int64_t)(end_rc >> 63);
    out->boundary_score = boundary_score;
    out->dq = (col - LY > 0) ? col - LY : 0;
    out->tbp = tbw - tb;
}

// ---------------------------------------------------------------------------
// SIMD fill of a row's substitution-score strip SROW[k] =
// sub[a_char][B[LY+k]] — 16 query bytes per iteration through a
// per-row-char pshufb LUT, validated at sweep start and screened per
// block (any byte outside uppercase ACGT drops the remainder of the
// strip to the scalar loop, exactly like the x-drop fast path).
struct SGCtx {
    int valid;
    __m128i lut[4];          // indexed by (a_char >> 1) & 3
};

static void sgctx_init(SGCtx* g, const int64_t* sub)
{
    g->valid = 0;
    static const uint8_t UP[4] = {'A', 'C', 'T', 'G'};
    for (int ca = 0; ca < 4; ++ca) {
        int8_t lut[16];
        for (int cb = 0; cb < 4; ++cb) {
            int64_t v = sub[(int64_t)UP[ca] * 256 + UP[cb]];
            if (v < -128 || v > 127) return;
            for (int rep = 0; rep < 4; ++rep)
                lut[rep * 4 + cb] = (int8_t)v;
        }
        g->lut[(UP[ca] >> 1) & 3] = _mm_loadu_si128(
            (const __m128i*)lut);
    }
    g->valid = 1;
}

static inline int is_ucacgt(uint8_t c)
{
    return c == 'A' || c == 'C' || c == 'G' || c == 'T';
}

// fill SROW[0..cnt-1] from v2[b_origin + b_step*(LY..LY+cnt-1)]
static inline void srow_fill(
    int32_t* SROW, const uint8_t* v2, int64_t b_origin,
    int64_t b_step, int64_t LY, int64_t cnt,
    const int64_t* srow64, const SGCtx* g, uint8_t a_char)
{
    int64_t k = 0;
    if (g->valid && is_ucacgt(a_char)) {
        const __m128i CA = _mm_set1_epi8('A');
        const __m128i CCq = _mm_set1_epi8('C');
        const __m128i CG = _mm_set1_epi8('G');
        const __m128i CT = _mm_set1_epi8('T');
        const __m128i REV = _mm_set_epi8(0, 1, 2, 3, 4, 5, 6, 7, 8,
                                         9, 10, 11, 12, 13, 14, 15);
        const __m128i M3 = _mm_set1_epi8(3);
        const __m128i lut = g->lut[(a_char >> 1) & 3];
        const uint8_t* base = v2 + b_origin + b_step * LY;
        while (k + 16 <= cnt) {
            __m128i b;
            if (b_step > 0)
                b = _mm_loadu_si128((const __m128i*)(base + k));
            else
                b = _mm_shuffle_epi8(_mm_loadu_si128(
                        (const __m128i*)(base - k - 15)), REV);
            __m128i vb = _mm_or_si128(
                _mm_or_si128(_mm_cmpeq_epi8(b, CA),
                             _mm_cmpeq_epi8(b, CCq)),
                _mm_or_si128(_mm_cmpeq_epi8(b, CG),
                             _mm_cmpeq_epi8(b, CT)));
            if (_mm_movemask_epi8(vb) != 0xFFFF)
                break;  // irregular byte: scalar remainder
            __m128i code = _mm_and_si128(_mm_srli_epi16(b, 1), M3);
            __m128i s8 = _mm_shuffle_epi8(lut, code);
            __m256i lo = _mm256_cvtepi8_epi32(s8);
            __m256i hi = _mm256_cvtepi8_epi32(
                _mm_srli_si128(s8, 8));
            _mm256_storeu_si256((__m256i*)(SROW + k), lo);
            _mm256_storeu_si256((__m256i*)(SROW + k + 8), hi);
            k += 16;
        }
    }
    for (; k < cnt; ++k)
        SROW[k] = (int32_t)srow64[v2[b_origin + b_step * (LY + k)]];
}

// ---------------------------------------------------------------------------
// Whole-extension sweep: the entire ydrop_one_sided_align row loop
// (gapped_extend.c:3388-3860) in one native call, including L/R bound
// maintenance (update_LR_bounds, flattened by the Python caller into
// piecewise-linear records), active-segment masking
// (update_active_segs, flattened into per-alignment segment arrays)
// and the traceback walk.  Eliminates the per-row FFI + Python
// bookkeeping that dominates host-side gapped extension.
//
// LR bound records (one side): 4 int64 each — (from_row, to_row,
// base, slope); the bound value at row r in [from_row, to_row] is
// base + slope*(r - from_row).  Rows not covered by any record have
// no bound on that side.  Records are contiguous and ascending.
//
// Actives: alignments activate when row == act_row[i] (caller orders
// them exactly as the sweep's align_list walk).  Per alignment:
// seg_off/seg_cnt index into segs[], 4 int64 per segment in traversal
// order — (type, x, last_row, horz_end), precomputed in DP-local
// coordinates (type 0=diag, 1=horz, 2=vert).

struct SweepResult {
    int64_t score;
    int64_t end1, end2;
    int64_t truncated;       // tb budget hit (caller reports)
    int64_t n_ops;           // traceback ops written to ops_out
    int64_t tbp;             // traceback bytes consumed
    // cycle buckets, filled only under LASTZ_TORCH_SWEEP_PROF=1
    int64_t n_rows;
    int64_t cy_srow, cy_row, cy_other;
    int64_t overflow;        // int32 score headroom exhausted; result
                             // is invalid — caller redoes in int64
};

// Scores inside the sweep are int32 (see ydrop_sweep).  best_score is
// the monotone max over accepted cells and every live cell sits within
// [best - y_drop, best + max_sub] of it, so bailing once best crosses
// INT32_MAX/2 leaves ~1e9 of headroom before any arithmetic could
// wrap.  Reaching the bar needs a single extension worth >1e9 score
// (~12 Mbp of perfect match) — the caller then redoes that extension
// on the int64 per-row path.  Env override exists only so tests can
// force the path cheaply.
static int64_t sweep_overflow_bar()
{
    static int64_t v = -1;
    if (v < 0) {
        const char* e = getenv("LASTZ_TORCH_SWEEP_OVERFLOW_BAR");
        v = (e && e[0]) ? atoll(e) : (int64_t)(INT32_MAX / 2);
    }
    return v;
}

static int sweep_prof_enabled()
{
    static int v = -1;
    if (v < 0) {
        const char* e = getenv("LASTZ_TORCH_SWEEP_PROF");
        v = (e && e[0] && e[0] != '0') ? 1 : 0;
    }
    return v;
}

struct ActState {
    int64_t cur;             // current global seg index
    int64_t end;             // one past last seg index of this align
    int64_t x, last_row, type;
    int64_t filter;
};

static inline void build_active(
    ActState& a, const int64_t* segs, int32_t* MASK,
    int64_t prev_LY, int64_t row, int64_t LY, int64_t RY)
{
    const int64_t* s = segs + 4 * a.cur;
    a.type = s[0];
    a.x = s[1];
    a.last_row = s[2];
    if (a.type != 1) {
        if (LY <= a.x && a.x <= RY)
            MASK[a.x - prev_LY] = (int32_t)row;
    } else {
        int64_t horz_end = s[3];
        int64_t i_min = LY > a.x ? LY : a.x;
        int64_t i_max = RY < horz_end ? RY : horz_end;
        for (int64_t i = i_min; i <= i_max; i++)
            MASK[i - prev_LY] = (int32_t)row;
    }
}

void ydrop_sweep(
    const uint8_t* v1, const uint8_t* v2,
    const int64_t* sub,                       // 256*256
    int64_t a_origin, int64_t a_step,         // A[row] = v1[a_origin + a_step*row]
    int64_t b_origin, int64_t b_step,         // B[col] = v2[b_origin + b_step*col]
    int64_t M, int64_t N,
    int64_t gap_e, int64_t gap_oe, int64_t y_drop, int64_t y_drop_tail,
    int64_t neg_inf, int64_t trim_to_peak,
    const int64_t* lrec, int64_t n_lrec,
    const int64_t* rrec, int64_t n_rrec,
    const int64_t* act_row, const int64_t* seg_off, const int64_t* seg_cnt,
    int64_t n_acts, const int64_t* segs,
    uint8_t* tb, int64_t tb_cap,
    uint8_t* ops_out,
    SweepResult* out)
{
    // scratch (per-call; sized to the band, grown as needed).  Cell
    // values and row stamps are int32 (the reference's s32 `score`
    // contract; the Python caller routes absurdly long extensions to
    // the per-row int64 path), halving the loop's memory traffic.
    static thread_local int32_t* CC = nullptr;
    static thread_local int32_t* DD = nullptr;
    static thread_local int32_t* MASK = nullptr;
    static thread_local int32_t* SROW = nullptr;
    static thread_local int64_t cells_cap = 0;
    static thread_local int64_t* tb_row = nullptr;
    static thread_local int64_t tb_row_cap = 0;
    static thread_local ActState* active = nullptr;
    static thread_local int64_t active_cap = 0;

    // deep sentinel: every comparison orders the same way as the
    // caller's int64 neg_inf, and bounded per-row drift (<= band *
    // gap_e) cannot bring it near real cell values
    const int32_t NEG32 = INT32_MIN / 2;
    const int32_t ge32 = (int32_t)gap_e;
    const int32_t goe32 = (int32_t)gap_oe;
    const int32_t yd32 = (int32_t)y_drop;
    SGCtx sg;
    sgctx_init(&sg, sub);

    int64_t need0 = y_drop_tail + 1024;
    if (need0 > cells_cap) {
        int64_t nc = need0 * 2;
        CC = (int32_t*)realloc(CC, nc * 4);
        DD = (int32_t*)realloc(DD, nc * 4);
        MASK = (int32_t*)realloc(MASK, nc * 4);
        SROW = (int32_t*)realloc(SROW, (nc + 2) * 4);
        cells_cap = nc;
    }
    if (M + 2 > tb_row_cap) {
        tb_row = (int64_t*)realloc(tb_row, (M + 2) * 8);
        tb_row_cap = M + 2;
    }
    if (n_acts + 1 > active_cap) {
        active = (ActState*)realloc(active, (n_acts + 1) * sizeof(ActState));
        active_cap = n_acts + 1;
    }
    int64_t n_active = 0;
    int64_t act_idx = 0;
    int64_t l_idx = 0, r_idx = 0;

    // -- first row (gapped_extend.c:3583-3605).  The reference
    // refuses to start when the first row alone cannot fit the arena
    // (yDropTail > tbLen => suicide, gapped_extend.c:3565-3567); we
    // degrade to the truncation path instead of aborting, so the
    // row-0 loop needs the same cap guard the later rows have.
    int64_t truncated = 0;
    int64_t tbp = 0;
    tb[tbp++] = 0;
    CC[0] = 0;
    DD[0] = -goe32;
    int32_t c = -goe32;
    int32_t c_temp = 0;
    int64_t dq = 1;
    int64_t col = 1;
    while (col <= N && c_temp >= -yd32) {
        if (tbp + 1 >= tb_cap) { truncated = 1; break; }
        if (dq + 2 > cells_cap) {
            int64_t nc = cells_cap * 2;
            CC = (int32_t*)realloc(CC, nc * 4);
            DD = (int32_t*)realloc(DD, nc * 4);
            MASK = (int32_t*)realloc(MASK, nc * 4);
            SROW = (int32_t*)realloc(SROW, (nc + 2) * 4);
            cells_cap = nc;
        }
        CC[dq] = c_temp = c;
        DD[dq] = c - goe32;
        dq++;
        c -= ge32;
        tb[tbp++] = 1;                    // C_FROM_I
        col++;
    }
    // MASK is read via `== row` with row >= 1 strictly increasing per
    // call, so a single fill here (plus -1 fills on later growth)
    // keeps every stale stamp unmatchable.
    for (int64_t i = 0; i < cells_cap; i++) MASK[i] = -1;
    tb_row[0] = 0;

    int64_t LY = 0;
    int64_t RY = col;                     // one beyond feasible
    int64_t end1 = 0, end2 = 0;
    int32_t best_score = 0;
    int32_t boundary_score = NEG32;
    int64_t end_is_boundary = 0;

    const int prof = sweep_prof_enabled();
    const int64_t ovf_bar = sweep_overflow_bar();
    out->overflow = 0;
    out->n_rows = 0;
    out->cy_srow = out->cy_row = out->cy_other = 0;
    uint64_t t_mark = prof ? __builtin_ia32_rdtsc() : 0;

    int64_t row = 1;
    while (row <= M) {
        int64_t prev_LY = LY;

        // -- update_LR_bounds (flattened records)
        while (l_idx < n_lrec && row > lrec[4 * l_idx + 1]) l_idx++;
        bool l_act = l_idx < n_lrec && row >= lrec[4 * l_idx];
        if (l_act) {
            const int64_t* rec = lrec + 4 * l_idx;
            int64_t L = rec[2] + rec[3] * (row - rec[0]);
            if (L > LY) LY = L;
        }
        while (r_idx < n_rrec && row > rrec[4 * r_idx + 1]) r_idx++;
        bool r_act = r_idx < n_rrec && row >= rrec[4 * r_idx];
        int64_t R = 0;
        if (r_act) {
            const int64_t* rec = rrec + 4 * r_idx;
            R = rec[2] + rec[3] * (row - rec[0]);
            // _special_min
            if (R <= 0) RY = 0;
            else if (R < RY) RY = R;
        }

        // -- grow cells for this row's band
        {
            int64_t need = (RY - prev_LY) + y_drop_tail + 2 + (LY - prev_LY) + 2;
            if (need > cells_cap) {
                int64_t nc = need * 2;
                CC = (int32_t*)realloc(CC, nc * 4);
                DD = (int32_t*)realloc(DD, nc * 4);
                MASK = (int32_t*)realloc(MASK, nc * 4);
                SROW = (int32_t*)realloc(SROW, (nc + 2) * 4);
                for (int64_t i = cells_cap; i < nc; i++) MASK[i] = -1;
                cells_cap = nc;
            }
        }

        // -- update_active_segs
        for (int64_t ai = 0; ai < n_active; ai++) {
            ActState& a = active[ai];
            if (a.last_row >= row) {
                if (a.type == 0) a.x++;
                if (LY <= a.x && a.x <= RY)
                    MASK[a.x - prev_LY] = (int32_t)row;
            } else {
                if (a.cur + 1 < a.end) {
                    a.cur++;
                    build_active(a, segs, MASK, prev_LY, row, LY, RY);
                    if (a.type == 1) {
                        a.cur++;           // skip past the horizontal
                        if (a.cur < a.end) {
                            build_active(a, segs, MASK, prev_LY, row, LY, RY);
                        } else {
                            a.filter = 1;
                        }
                    }
                } else {
                    a.filter = 1;
                }
            }
        }
        while (act_idx < n_acts && act_row[act_idx] == row) {
            ActState& a = active[n_active++];
            a.cur = seg_off[act_idx];
            a.end = seg_off[act_idx] + seg_cnt[act_idx];
            a.filter = 0;
            build_active(a, segs, MASK, prev_LY, row, LY, RY);
            if (a.type == 1) {
                a.cur++;
                if (a.cur < a.end) {
                    build_active(a, segs, MASK, prev_LY, row, LY, RY);
                } else {
                    a.filter = 1;
                }
            }
            act_idx++;
        }
        // compact filtered actives
        {
            int64_t w = 0;
            for (int64_t ai = 0; ai < n_active; ai++)
                if (!active[ai].filter) active[w++] = active[ai];
            n_active = w;
        }

        if (RY < LY) RY = LY;
        int64_t tb_needed = RY - LY + y_drop_tail;
        if (tb_needed < 0) tb_needed = 0;
        if (tbp + tb_needed >= tb_cap) {
            truncated = 1;
            break;
        }
        tb_row[row] = tbp - LY;

        // -- the row itself: pre-gather the row's substitution scores
        // (simple independent loads, so the cell loop carries no
        // dependent byte->table chain), then the int32 row step
        const uint8_t a_char = v1[a_origin + a_step * row];
        if (prof) {
            uint64_t t = __builtin_ia32_rdtsc();
            out->cy_other += t - t_mark;
            t_mark = t;
        }
        {
            int64_t s_last = (RY < N ? RY : N);
            if (s_last >= LY)
                srow_fill(SROW, v2, b_origin, b_step, LY,
                          s_last - LY + 1,
                          sub + 256 * (int64_t)a_char, &sg, a_char);
        }
        if (prof) {
            uint64_t t = __builtin_ia32_rdtsc();
            out->cy_srow += t - t_mark;
            t_mark = t;
            out->n_rows++;
        }
        RowResult32 res;
        ydrop_row32(CC, DD, MASK, tb, SROW,
                    row, M, N, LY, RY, prev_LY,
                    ge32, goe32, yd32, NEG32,
                    best_score, end1, end2,
                    end_is_boundary, boundary_score,
                    trim_to_peak, n_active > 0, tbp, &res);
        if (prof) {
            uint64_t t = __builtin_ia32_rdtsc();
            out->cy_row += t - t_mark;
            t_mark = t;
        }
#ifdef YDROP_DEBUG
        if (row <= 4)
            fprintf(stderr,
                "row=%lld LY=%lld->%lld RY=%lld np=%lld best=%d "
                "ival=%d dq=%lld tbp=%lld->%lld\n",
                (long long)row, (long long)prev_LY, (long long)res.LY,
                (long long)RY, (long long)res.np_col,
                (int)res.best_score, (int)res.i_val,
                (long long)res.dq, (long long)tbp,
                (long long)res.tbp);
#endif
        LY = res.LY;
        int64_t np_col = res.np_col;
        int32_t i_val = res.i_val;
        best_score = res.best_score;
        if ((int64_t)best_score >= ovf_bar) {
            out->overflow = 1;
            out->score = 0;
            out->end1 = out->end2 = 0;
            out->truncated = 0;
            out->n_ops = 0;
            out->tbp = tbp;
            return;
        }
        end1 = res.end1; end2 = res.end2;
        end_is_boundary = res.end_is_boundary;
        boundary_score = res.boundary_score;
        dq = res.dq;
        tbp = res.tbp;

        if (LY >= RY) break;

        int64_t NN = (r_act && R > 0) ? R - 1 : N;
        if (RY > np_col + 1) {
            RY = np_col + 1;
        } else {
            while (i_val >= best_score - yd32 && RY <= NN) {
                if (dq + 2 > cells_cap) {
                    int64_t nc = cells_cap * 2;
                    CC = (int32_t*)realloc(CC, nc * 4);
                    DD = (int32_t*)realloc(DD, nc * 4);
                    MASK = (int32_t*)realloc(MASK, nc * 4);
                    SROW = (int32_t*)realloc(SROW, (nc + 2) * 4);
                    for (int64_t i = cells_cap; i < nc; i++) MASK[i] = -1;
                    cells_cap = nc;
                }
                if (tbp + 1 >= tb_cap) { truncated = 1; break; }
                CC[dq] = i_val;
                DD[dq] = i_val - goe32;
                dq++;
                i_val -= ge32;
                tb[tbp++] = 1;            // C_FROM_I
                RY++;
            }
            if (truncated) break;
        }
        if (RY <= NN) {
            if (dq + 2 > cells_cap) {
                int64_t nc = cells_cap * 2;
                CC = (int32_t*)realloc(CC, nc * 4);
                DD = (int32_t*)realloc(DD, nc * 4);
                MASK = (int32_t*)realloc(MASK, nc * 4);
                SROW = (int32_t*)realloc(SROW, (nc + 2) * 4);
                for (int64_t i = cells_cap; i < nc; i++) MASK[i] = -1;
                cells_cap = nc;
            }
            DD[dq] = NEG32;
            CC[dq] = NEG32;
            RY++;
        }
        row++;
    }

    // -- traceback (gapped_extend.c:3845-3860)
    {
        int64_t r = end1, cidx = end2;
        int64_t n_ops = 0;
        uint8_t prev_op = 0;
        while (r >= 1 || cidx > 0) {
            uint8_t link = tb[tb_row[r] + cidx];
            uint8_t op = link & 3;
            if (prev_op == 1 && (link & 4)) op = 1;
            if (prev_op == 2 && (link & 8)) op = 2;
            if (op == 1)      { cidx--;      ops_out[n_ops++] = 'I'; }
            else if (op == 2) { r--;         ops_out[n_ops++] = 'D'; }
            else              { r--; cidx--; ops_out[n_ops++] = 'S'; }
            prev_op = op;
        }
        out->n_ops = n_ops;
    }
    out->score = end_is_boundary ? boundary_score : best_score;
    out->end1 = end1;
    out->end2 = end2;
    out->truncated = truncated;
    // always report how far the sweep actually got (the caller's
    // lazy active-marshaling horizon check needs it; the prof-gated
    // n_rows counter above only runs under LASTZ_TORCH_SWEEP_PROF)
    out->n_rows = row;
    out->tbp = tbp;
}

// Single-core speed benchmark: run `rows` iterations of the row sweep
// over a fixed-width band, entirely in native code (no per-row FFI
// overhead).  This is the fair "reference C speed" baseline for the
// TPU kernel: it is the same inner loop the reference's
// ydrop_one_sided_align runs (gapped_extend.c:3683-3775).
int64_t ydrop_bench(
    int64_t* CC, int64_t* DD, int64_t* MASK, uint8_t* tb,
    const int64_t* sub_row, const uint8_t* B,
    int64_t rows, int64_t band,
    int64_t gap_e, int64_t gap_oe, int64_t y_drop, int64_t neg_inf)
{
    RowResult res;
    int64_t best = 0, end1 = 0, end2 = 0, bnd = 0, bscore = neg_inf;
    int64_t tbp = 0;
    for (int64_t r = 1; r <= rows; r++) {
        ydrop_row(CC, DD, MASK, tb, sub_row, B, 0, 1,
                  r, rows, band - 2, 0, band - 1, 0,
                  gap_e, gap_oe, y_drop, neg_inf,
                  best, end1, end2, bnd, bscore,
                  1, 0, tbp, &res);
        best = res.best_score;
        end1 = res.end1; end2 = res.end2;
        bnd = res.end_is_boundary; bscore = res.boundary_score;
        tbp = 0;  // reuse the traceback row
    }
    return best;
}

// ---------------------------------------------------------------------------
// Batched unblocked two-sided x-drop (ops/xdrop_batch.batch_xdrop_np
// semantics; reference xdrop_extend_seed_hit, seed_search.c:2528):
// one call per hit chunk replaces the numpy multi-pass scan.  The
// `consumed` count INCLUDES the element that triggered the x-drop
// stop; `kbest` is the FIRST offset attaining the (positive) best.

static inline void xdrop_scan_dir(
    const uint8_t* s1, const uint8_t* s2, const int64_t* sub,
    int64_t p1, int64_t p2, int64_t n, int64_t step, int64_t x_drop,
    int64_t* out_consumed, int64_t* out_best, int64_t* out_kbest)
{
    int64_t c = 0, m = 0, b = 0, kb = -1, cons = n;
    for (int64_t k = 0; k < n; ++k) {
        c += sub[((int64_t)s1[p1 + step * k]) * 256 + s2[p2 + step * k]];
        if (c > m) m = c;
        if (c > b) { b = c; kb = k; }
        if (c < m - x_drop) { cons = k + 1; break; }
    }
    *out_consumed = cons;
    *out_best = b;
    *out_kbest = kb;
}

// ---------------------------------------------------------------------------
// Whole-strand sequential hit sweep: the scalar engine's probe loop
// (SeedSearchEngine._probe + _process_simple/_process_recover;
// reference private_hit_search/find_table_matches,
// seed_search.c:464-810, processors :1056/:1221, x-drop :2528) in one
// native call.  The host replay of the seed stage is memory-bound
// numpy otherwise; this loop runs it at reference-C speed.  Survivors
// are written out with their valid-position index so the caller can
// dispatch reports in exactly the scalar order with search-limit
// granularity.

static double entropy_fn(const uint8_t* s, const uint8_t* t,
                         int64_t len)
{
    // dna_utilities.c:2882 / core/scoring.entropy: matched uppercase
    // ACGT composition, probabilities over the full length
    int64_t counts[4] = {0, 0, 0, 0};
    for (int64_t k = 0; k < len; ++k) {
        uint8_t a = s[k];
        if (a != t[k]) continue;
        switch (a) {
            case 'A': ++counts[0]; break;
            case 'C': ++counts[1]; break;
            case 'G': ++counts[2]; break;
            case 'T': ++counts[3]; break;
            default: break;
        }
    }
    int64_t total = counts[0] + counts[1] + counts[2] + counts[3];
    if (total < 20) return 1.0;
    double acc = 0.0;
    for (int c = 0; c < 4; ++c) {
        if (counts[c]) {
            double p = (double)counts[c] / (double)len;
            acc += p * log(p);
        }
    }
    return -acc / log(4.0);
}

// Whole position-table build (pos_table.c:118-470 equivalent): roll
// the seed window over the target, pack via the seed's bit map, and
// counting-sort positions by word straight into the CSR arrays.
// Two passes over the target + two passes over the word space replace
// the numpy window/pack/argsort/searchsorted chain.  Returns the
// entry count, or -1 on allocation failure (caller falls back).
int64_t build_postable(
    const uint8_t* seq, int64_t start, int64_t end,
    const int8_t* char2bits, int64_t L, int64_t bits_per,
    const int64_t* bm_src, const int64_t* bm_dst, int64_t n_bm,
    int64_t step, int64_t adj_start, int64_t num_words,
    int32_t* csr_start, uint32_t* out_pos)
{
    int32_t* next = (int32_t*)malloc(
        (size_t)(num_words + 1) * sizeof(int32_t));
    if (!next) return -1;
    const uint64_t keep = bits_per == 2
        ? ((L * 2 >= 64) ? ~0ULL : ((1ULL << (L * 2)) - 1))
        : ((L >= 64) ? ~0ULL : ((1ULL << L) - 1));

    for (int64_t pass = 0; pass < 2; ++pass) {
        if (pass == 0) {
            memset(csr_start, 0,
                   (size_t)(num_words + 1) * sizeof(int32_t));
        } else {
            // counts sit at slot w+1, so the inclusive prefix gives
            // csr_start[w] = number of entries with word < w
            int64_t acc = 0;
            for (int64_t w = 0; w <= num_words; ++w) {
                acc += csr_start[w];
                csr_start[w] = (int32_t)acc;
                next[w] = (int32_t)acc;
            }
        }
        uint64_t win = 0;
        int64_t run = 0;  // consecutive valid codes ending here
        for (int64_t p = start; p < end; ++p) {
            int8_t code = char2bits[seq[p]];
            if (code < 0) {
                run = 0;
                win = bits_per == 2 ? (win << 2) : (win << 1);
            } else {
                ++run;
                win = bits_per == 2 ? ((win << 2) | (uint64_t)code)
                                    : ((win << 1)
                                       | ((uint64_t)code & 1));
            }
            win &= keep;
            int64_t end_pos = p + 1;  // window ends AFTER base p
            if (run < L) continue;
            if (end_pos % step != 0) continue;
            uint64_t packed = 0;
            for (int64_t b = 0; b < n_bm; ++b)
                packed |= ((win >> bm_src[b]) & 1ULL) << bm_dst[b];
            if (pass == 0) {
                ++csr_start[packed + 1];
            } else {
                out_pos[next[packed]++] =
                    (uint32_t)((end_pos - adj_start) / step);
            }
        }
    }
    free(next);
    return csr_start[num_words];
}

// CSR word-start fill over sorted packed words: csr_start[w] = first
// slot whose word >= w (pos_table.c last/prev build equivalent).  One
// O(n + num_words) pass replaces a 4^W-probe searchsorted that costs
// tens of seconds on this host class.
void csr_fill(const uint32_t* sorted_words, int64_t n,
              int64_t num_words, int32_t* csr_start)
{
    int64_t idx = 0;
    for (int64_t w = 0; w < num_words; ++w) {
        while (idx < n && (int64_t)sorted_words[idx] < w) ++idx;
        csr_start[w] = (int32_t)idx;
    }
    csr_start[num_words] = (int32_t)n;
}

struct SweepCounters {
    int64_t n_out;       // survivors produced (may exceed out_cap)
    int64_t raw_hits;    // hits examined after positional filters
    int64_t dropped;     // diagonal-hash drops
    int64_t extensions;  // gap-free extensions run
    int64_t n_pos;       // valid query words scanned
    int64_t ext_cycles;  // rdtsc cycles spent in xdrop_extend
    int64_t ext_steps;   // total scan steps across extensions
};

void hit_sweep(
    const uint8_t* s1, const uint8_t* s2, int64_t len1, int64_t len2,
    const int64_t* sub, int64_t x_drop,
    int64_t start, int64_t end,            // query scan interval
    const int8_t* char2bits, int64_t bits_per,
    const int64_t* bm_src, const int64_t* bm_dst, int64_t n_bm,
    const int64_t* rm_src, int64_t n_rm,   // resolving-bit sources
    const int64_t* xors, int64_t nx,
    const int64_t* probe_budget,           // per-probe resolve budget
    const int32_t* csr_start, const uint32_t* csr_pos,
    const uint32_t* csr_resolve,           // packed entry resolve words
    const uint8_t* wbitmap,   // little-endian bit w: word w nonempty
    const uint8_t* alive,
    int64_t adj_start, int64_t step,
    int64_t* de, int64_t* da, int64_t seed_len,
    int64_t self_compare, int64_t same_strand, int64_t band_width,
    int64_t hit_mode,            // 0 = simple, 1 = recover
    int64_t no_extend,
    int64_t thresh, int64_t entropic, int64_t zero_thresh,
    int64_t* out_pos1, int64_t* out_pos2, int64_t* out_len,
    int64_t* out_score, int64_t* out_grp, int64_t out_cap,
    SweepCounters* res)
{
    const int64_t HMASK = 65535;
    enum { MAX_PROBES = 264 };   // 1 + flips + flip pairs; caller gates
    if (nx > MAX_PROBES) { res->n_out = -1; return; }
    const int64_t L = seed_len;
    const uint64_t keep = bits_per == 2
        ? ((L * 2 >= 64) ? ~0ULL : ((1ULL << (L * 2)) - 1))
        : ((L >= 64) ? ~0ULL : ((1ULL << L) - 1));
    int64_t n_out = 0, raw = 0, dropped = 0, exts = 0;
    uint64_t ext_cyc = 0;
    int64_t ext_steps = 0;
    const int ext_prof = sweep_prof_enabled();
    SimdCtx sctx;
    simd_ctx_init(&sctx, sub, x_drop);
    int64_t i = -1;  // valid-word ordinal (matches numpy valid_idx)
    uint64_t win = 0;
    int64_t run = 0;

    // The probe/extend path is a 5-stage software pipeline over query
    // positions.  csr_start (tens of MB), csr_pos and the random
    // s1[pos1] extension windows all live beyond the LLC; issuing
    // each object's prefetch one full position-tick (several hundred
    // cycles of unrelated work) before its use hides the miss
    // latency that otherwise lands inside the serial extension loop
    // (~950 cycles/extension unprefetched, ~250 pipelined).  State
    // mutation (diag hash, outputs) happens only in stage 4, which
    // executes strictly in position order, so results are identical
    // to the plain loop.
    struct PipeSlot {
        uint32_t wv[MAX_PROBES];
        int32_t lov[MAX_PROBES];
        int32_t hiv[MAX_PROBES];
        uint8_t occ[MAX_PROBES];
        uint32_t qres;        // query window's packed resolving bits
        int64_t pos2, iord;
        int valid;
    };
    PipeSlot slots[5];
    for (int k = 0; k < 5; ++k) slots[k].valid = 0;
    int64_t tick = 0;

    // stage 1: bitmap (prefetched last tick) screens empty buckets,
    // prefetch csr_start for the survivors
    auto stage1 = [&](PipeSlot& S) {
        for (int64_t xi = 0; xi < nx; ++xi) {
            uint32_t w = S.wv[xi];
            S.occ[xi] = (wbitmap[w >> 3] >> (w & 7)) & 1;
            if (S.occ[xi])
                __builtin_prefetch(&csr_start[w], 0, 1);
        }
    };
    // stage 2: load CSR ranges, prefetch the entry lines
    auto stage2 = [&](PipeSlot& S) {
        for (int64_t xi = 0; xi < nx; ++xi) {
            if (!S.occ[xi]) { S.lov[xi] = S.hiv[xi] = 0; continue; }
            S.lov[xi] = csr_start[S.wv[xi]];
            S.hiv[xi] = csr_start[S.wv[xi] + 1];
            if (S.hiv[xi] > S.lov[xi]) {
                __builtin_prefetch(&csr_pos[S.hiv[xi] - 1], 0, 1);
                if (csr_resolve)
                    __builtin_prefetch(&csr_resolve[S.hiv[xi] - 1],
                                       0, 1);
            }
        }
    };
    // stage 3: read entries, prefetch the target bytes their x-drop
    // extensions will read
    auto stage3 = [&](PipeSlot& S) {
        for (int64_t xi = 0; xi < nx; ++xi) {
            int64_t lo = S.lov[xi], hi = S.hiv[xi];
            int64_t k_stop = hi - 8 > lo ? hi - 8 : lo;
            for (int64_t e = hi - 1; e >= k_stop; --e) {
                int64_t p1 = adj_start + step * (int64_t)csr_pos[e];
                __builtin_prefetch(&s1[p1], 0, 1);
                __builtin_prefetch(&s1[p1 - 64], 0, 1);
                __builtin_prefetch(&s1[p1 + 63], 0, 1);
            }
        }
    };
    // stage 4: the original per-hit work, state-mutating, in order
    auto stage4 = [&](PipeSlot& S) {
        int64_t pos2 = S.pos2;
        int64_t iord = S.iord;
        for (int64_t xi = 0; xi < nx; ++xi) {
            int64_t lo = S.lov[xi], hi = S.hiv[xi];
            for (int64_t e = hi - 1; e >= lo; --e) {
                if (csr_resolve) {
                    // overweight seeds: demoted-bit verification
                    // within this probe's leftover transition budget
                    // (seed_search.c:878-980)
                    uint32_t x = csr_resolve[e] ^ S.qres;
                    if ((int64_t)__builtin_popcount(x)
                            > probe_budget[xi]) continue;
                }
                if (alive && !alive[e]) continue;
                int64_t pos1 = adj_start + step * (int64_t)csr_pos[e];
                if (self_compare) {
                    if (same_strand) {
                        if (pos1 >= pos2) continue;
                    } else {
                        int64_t p1 = pos1 - seed_len;
                        int64_t p2 = (len2 - 1) - (pos2 - seed_len);
                        if (p1 >= p2) continue;
                    }
                }
                if (same_strand && band_width > 0
                        && pos2 - pos1 > band_width) continue;
                ++raw;
                int64_t diag = pos1 - pos2;
                int64_t h = diag & HMASK;
                int unblocked = 0;
                if (hit_mode == 0) {
                    if (de[h] == -1) de[h] = 0;
                    if (de[h] > pos2 - seed_len) { ++dropped; continue; }
                } else {
                    if (de[h] == -1) { de[h] = 0; da[h] = diag; }
                    else if (de[h] > pos2 - seed_len) {
                        if (da[h] == diag) { ++dropped; continue; }
                        unblocked = 1;  // hash collision: recover
                    }
                }
                if (no_extend) {
                    de[h] = pos2;
                    if (n_out < out_cap) {
                        out_pos1[n_out] = pos1;
                        out_pos2[n_out] = pos2;
                        out_len[n_out] = seed_len;
                        out_score[n_out] = 0;
                        out_grp[n_out] = iord;
                    }
                    ++n_out;
                    continue;
                }
                ++exts;
                int64_t block2 = unblocked ? 0 : de[h];
                int64_t stop1 = block2 + diag > 0 ? block2 + diag : 0;
                int64_t stop1r = len1 < len2 + diag ? len1
                                                    : len2 + diag;
                int64_t lstart, lscore, rstop, rscore, rblock;
                uint64_t t0 = ext_prof ? __builtin_ia32_rdtsc() : 0;
                ext_steps += xdrop_extend_impl(
                    s1, s2, sub, &sctx, pos1, pos2, stop1, stop1r,
                    x_drop, &lstart, &lscore, &rstop,
                    &rscore, &rblock);
                if (ext_prof)
                    ext_cyc += __builtin_ia32_rdtsc() - t0;
                int64_t extent = rblock - diag;
                if (extent > de[h]) { de[h] = extent; da[h] = diag; }
                int64_t np1 = rstop;
                int64_t np2 = rstop - diag;
                int64_t nlen = rstop - lstart;
                int64_t sim = lscore + rscore;
                if (entropic && sim >= zero_thresh
                        && sim <= 3 * thresh) {
                    double q = entropy_fn(s1 + np1 - nlen,
                                          s2 + np2 - nlen, nlen);
                    sim = (int64_t)((double)sim * q);
                }
                if (sim < thresh) continue;
                if (n_out < out_cap) {
                    out_pos1[n_out] = np1;
                    out_pos2[n_out] = np2;
                    out_len[n_out] = nlen;
                    out_score[n_out] = sim;
                    out_grp[n_out] = iord;
                }
                ++n_out;
            }
        }
    };
    // one pipeline tick with no new fill (stages by slot age)
    auto drain_tick = [&]() {
        PipeSlot& s4 = slots[(tick + 1) % 5];
        if (s4.valid) { stage4(s4); s4.valid = 0; }
        PipeSlot& a1 = slots[(tick - 1 + 5) % 5];
        PipeSlot& a2 = slots[(tick - 2 + 5) % 5];
        PipeSlot& a3 = slots[(tick - 3 + 5) % 5];
        if (a1.valid) stage1(a1);
        if (a2.valid) stage2(a2);
        if (a3.valid) stage3(a3);
        ++tick;
    };

    for (int64_t p = start; p < end; ++p) {
        int8_t code = char2bits[s2[p]];
        if (code < 0) {
            run = 0;
            win = bits_per == 2 ? (win << 2) : (win << 1);
        } else {
            ++run;
            win = bits_per == 2 ? ((win << 2) | (uint64_t)code)
                                : ((win << 1) | ((uint64_t)code & 1));
        }
        win &= keep;
        if (run < L) continue;
        ++i;
        uint64_t base = 0;
        for (int64_t b = 0; b < n_bm; ++b)
            base |= ((win >> bm_src[b]) & 1ULL) << bm_dst[b];
        uint64_t qres = 0;
        for (int64_t b = 0; b < n_rm; ++b)
            qres |= ((win >> rm_src[b]) & 1ULL) << b;
        // stage 0: fill the new slot, prefetch its bitmap lines
        PipeSlot& NS = slots[tick % 5];
        NS.qres = (uint32_t)qres;
        NS.pos2 = p + 1;
        NS.iord = i;
        NS.valid = 1;
        for (int64_t xi = 0; xi < nx; ++xi) {
            NS.wv[xi] = (uint32_t)base ^ (uint32_t)xors[xi];
            __builtin_prefetch(&wbitmap[NS.wv[xi] >> 3], 0, 1);
        }
        // oldest slot's heavy work runs between the new slot's
        // prefetches and the younger slots' loads
        PipeSlot& s4 = slots[(tick + 1) % 5];
        if (s4.valid) { stage4(s4); s4.valid = 0; }
        PipeSlot& a1 = slots[(tick - 1 + 5) % 5];
        PipeSlot& a2 = slots[(tick - 2 + 5) % 5];
        PipeSlot& a3 = slots[(tick - 3 + 5) % 5];
        if (a1.valid) stage1(a1);
        if (a2.valid) stage2(a2);
        if (a3.valid) stage3(a3);
        ++tick;
    }
    for (int f = 0; f < 5; ++f) drain_tick();
    res->n_out = n_out;
    res->raw_hits = raw;
    res->dropped = dropped;
    res->extensions = exts;
    res->n_pos = i + 1;
    res->ext_cycles = (int64_t)ext_cyc;
    res->ext_steps = ext_steps;
}

void xdrop_scan_batch(
    const uint8_t* s1, const uint8_t* s2, const int64_t* sub,
    int64_t len1, int64_t len2, int64_t x_drop,
    const int64_t* pos1, const int64_t* pos2, int64_t H,
    int64_t* lc, int64_t* ls, int64_t* lstart,
    int64_t* rc, int64_t* rs, int64_t* rstop)
{
    for (int64_t i = 0; i < H; ++i) {
        int64_t p1 = pos1[i], p2 = pos2[i];
        int64_t diag = p1 - p2;
        int64_t c, b, k;
        // left: from pos1-1 down to stop1 = max(diag, 0)
        int64_t stop1 = diag > 0 ? diag : 0;
        xdrop_scan_dir(s1, s2, sub, p1 - 1, p2 - 1, p1 - stop1, -1,
                       x_drop, &c, &b, &k);
        lc[i] = c;
        ls[i] = b > 0 ? b : 0;
        lstart[i] = b > 0 ? p1 - 1 - k : p1;
        // right: from pos1 up to stop1r = min(len1, len2 + diag)
        int64_t stop1r = len1 < len2 + diag ? len1 : len2 + diag;
        int64_t nr = stop1r - p1 > 0 ? stop1r - p1 : 0;
        xdrop_scan_dir(s1, s2, sub, p1, p2, nr, +1, x_drop,
                       &c, &b, &k);
        rc[i] = c;
        rs[i] = b > 0 ? b : 0;
        rstop[i] = b > 0 ? p1 + k + 1 : p1;
    }
}

}  // extern "C"
