// K-d tree accelerated chain DP (reference chain.c:224,503,647,920).
//
// Finds, for each segment (processed in pos1-sorted order), the best
// scoring predecessor chain under the blastz connection penalty
// (chain_connect_penalty, lastz.c:3687): diagDiff*diagPen +
// numSubs*antiPen, with overlap (negative numSubs) charged at
// scale*sub[A][A] per base.  A 2-d tree over (diagonal, pos2) with
// branch-and-bound over subtree max chain scores makes the
// best-predecessor query ~O(log n) in practice.
//
// Tie-breaking: equal-scoring predecessors resolve to the SMALLEST
// index in the pos1-sorted order, matching the pure-numpy fallback in
// align/chain.py (np.argmax first-occurrence); the branch-and-bound
// prune is strict (>) so equal-value candidates are still explored.

#include <cstdint>
#include <cmath>
#include <algorithm>
#include <vector>

namespace {

struct KdNode {
    bool is_bucket;
    int64_t lo, hi;        // bucket: segment index range (inclusive)
    int64_t cut_val;       // internal: split value on this node's axis
    int64_t mid;           // internal: last perm index in lo subtree
    double max_chain;      // best chain score in this subtree so far
    KdNode *lo_son, *hi_son;
};

struct KdCtx {
    const int64_t *pos1, *pos2, *diag, *x_end, *y_end;
    const double *chain_score;
    const int64_t *perm;
    double diag_pen, anti_pen, sub_pen, best_possible;
    // query
    int64_t qx, qy, qdiag;
    double contrib;
    int64_t num;
};

constexpr int kBucketSize = 3;

KdNode* build(std::vector<KdNode>& pool, int64_t* perm,
              const int64_t* diag, const int64_t* pos2,
              int64_t lo, int64_t hi, int axis) {
    pool.push_back(KdNode());
    KdNode* node = &pool.back();
    // NOTE: pool must be pre-reserved; push_back must not reallocate.
    node->max_chain = -1.0;  // all chain scores are >= 0
    node->lo_son = node->hi_son = nullptr;
    if (hi - lo + 1 <= kBucketSize) {
        node->is_bucket = true;
        node->lo = lo;
        node->hi = hi;
        return node;
    }
    node->is_bucket = false;
    const int64_t* key = (axis == 0) ? diag : pos2;
    int64_t mid = lo + (hi - lo) / 2;
    std::nth_element(perm + lo, perm + mid, perm + hi + 1,
                     [key](int64_t a, int64_t b) { return key[a] < key[b]; });
    // invariant: lo subtree keys <= cut_val <= hi subtree keys
    // (equal keys may land on either side; the prune tests below only
    // rely on this weak ordering)
    node->cut_val = key[perm[mid]];
    node->mid = mid;
    node->lo = lo;
    node->hi = hi;
    node->lo_son = build(pool, perm, diag, pos2, lo, mid, 1 - axis);
    node->hi_son = build(pool, perm, diag, pos2, mid + 1, hi, 1 - axis);
    return node;
}

inline double connect_penalty(const KdCtx& c, int64_t j) {
    int64_t diag_diff = c.qdiag - c.diag[j];
    int64_t num_subs;
    if (diag_diff >= 0) {
        num_subs = c.qy - c.y_end[j] - 1;
    } else {
        num_subs = c.qx - c.x_end[j] - 1;
        diag_diff = -diag_diff;
    }
    double penalty = (double)diag_diff * c.diag_pen;
    if (num_subs >= 0)
        penalty += (double)num_subs * c.anti_pen;
    else
        penalty += (double)(-num_subs) * c.sub_pen;
    if (penalty > c.best_possible) penalty = c.best_possible;
    return penalty;
}

void best_predecessor(const KdNode* t, int axis, double lower_bound,
                      KdCtx& c) {
    // strict > prune so equal-value smaller-index candidates survive
    if (c.contrib > t->max_chain - lower_bound) return;
    if (t->is_bucket) {
        for (int64_t i = t->lo; i <= t->hi; ++i) {
            int64_t j = c.perm[i];
            if (c.pos1[j] >= c.qx || c.pos2[j] >= c.qy) continue;
            double cand = c.chain_score[j] - connect_penalty(c, j);
            if (cand > c.contrib ||
                (cand == c.contrib && c.num >= 0 && j < c.num)) {
                c.contrib = cand;
                c.num = j;
            }
        }
        return;
    }
    if (axis == 1) {  // cut by pos2: hi subtree only if qy can exceed it
        if (c.qy >= t->cut_val)
            best_predecessor(t->hi_son, 1 - axis, lower_bound, c);
        best_predecessor(t->lo_son, 1 - axis, lower_bound, c);
    } else {  // cut by diagonal: both sides, with penalty lower bounds
        // penalty >= |diagDiff| * diagPen always (the numSubs term is
        // never negative: overlap is charged at +scale*sub[A][A]/base),
        // so |qdiag - cut| * diagPen is a sound bound for the far side
        double diff = (double)(c.qdiag - t->cut_val);
        if (diff >= 0) {
            best_predecessor(t->hi_son, 1 - axis, lower_bound, c);
            best_predecessor(t->lo_son, 1 - axis,
                             std::max(lower_bound, diff * c.diag_pen), c);
        } else {
            best_predecessor(t->lo_son, 1 - axis, lower_bound, c);
            best_predecessor(t->hi_son, 1 - axis,
                             std::max(lower_bound, -diff * c.diag_pen), c);
        }
    }
}

void propagate(KdNode* t, double s, int64_t perm_ix) {
    while (t != nullptr) {
        if (s > t->max_chain) t->max_chain = s;
        if (t->is_bucket) return;
        t = (perm_ix <= t->mid) ? t->lo_son : t->hi_son;
    }
}

}  // namespace

extern "C" void chain_reduce(
    int64_t n,
    const int64_t* pos1, const int64_t* pos2, const int64_t* length,
    const double* score,
    double scale, double diag_pen, double anti_pen, double sub_pen,
    double best_possible,
    double* chain_score_out, int64_t* back_out) {
    if (n <= 0) return;

    std::vector<int64_t> diag(n), x_end(n), y_end(n), perm(n), inv(n);
    for (int64_t i = 0; i < n; ++i) {
        diag[i] = pos1[i] - pos2[i];
        x_end[i] = pos1[i] + length[i] - 1;
        y_end[i] = pos2[i] + length[i] - 1;
        perm[i] = i;
    }

    std::vector<KdNode> pool;
    pool.reserve(2 * (size_t)n + 8);
    KdNode* root = build(pool, perm.data(), diag.data(), pos2, 0, n - 1, 1);
    for (int64_t i = 0; i < n; ++i) inv[perm[i]] = i;

    KdCtx c;
    c.pos1 = pos1;
    c.pos2 = pos2;
    c.diag = diag.data();
    c.x_end = x_end.data();
    c.y_end = y_end.data();
    c.chain_score = chain_score_out;
    c.perm = perm.data();
    c.diag_pen = diag_pen;
    c.anti_pen = anti_pen;
    c.sub_pen = sub_pen;
    c.best_possible = best_possible;

    for (int64_t i = 0; i < n; ++i) {
        c.qx = pos1[i];
        c.qy = pos2[i];
        c.qdiag = diag[i];
        c.contrib = 0.0;
        c.num = -1;
        best_predecessor(root, 1, 0.0, c);
        chain_score_out[i] = score[i] * scale + c.contrib;
        back_out[i] = c.num;
        propagate(root, chain_score_out[i], inv[i]);
    }
}
