// Copy of native/align_driver.cc with one hook: while a unit is replayed
// (align_replay.cc), run_ext answers from the unit's table of the card's
// results and update_extra waits for a pass without a miss.
//
// Native per-read alignment driver: the full mm_align_skeleton region loop
// in C++ (reference align.c:423-761), exact port of the golden Python models
// in minimap2_chaindp_tpu/align.py + hits.py (split_reg/reg_set_coor).
//
// Covers EVERY preset/mode: the dual-affine extd2 path, sr ungapped fill,
// HPC anchor adjustment, Z-drop retest + inversion probe via ksw_ll,
// chain splitting, inversion rescue, AND the splice route (exts2
// donor/acceptor signal kernel with two-round strand selection,
// align.c:725-741) — see exts2_one/fix_bad_ends_splice below.  The Python
// generator (align.align_skeleton_gen) remains the golden model this port
// is differential-tested against byte-for-byte.
//
// Built as one translation unit with the extd2 kernel (textual include) so
// the row kernels inline; mm2tpu_fix_update_extra comes from
// align_epilogue.cc compiled into the same shared object.
#include "ksw2_extd2.cc"

#include <cmath>
#include <cstdio>
#include <cctype>
#include <atomic>
#include <cstdlib>
#include <ctime>

// Opt-in per-stage wall-time counters (MM2TPU_PROF=1), the analog of the
// reference's per-thread phase accumulators (main.c:110-116, map.c:938):
// 0 sketch, 1 collect, 2 chain, 3 finish (regions/chain_post/est_err/mapq),
// 4 align skeleton (extension DP, inside 3), 5 text emit.
static std::atomic<int64_t> g_prof_ns[8];
static int g_prof_enabled = -1;
static inline bool prof_on() {
    if (g_prof_enabled < 0) {
        const char* e = getenv("MM2TPU_PROF");
        g_prof_enabled = (e && *e == '1') ? 1 : 0;
    }
    return g_prof_enabled == 1;
}
struct ProfScope {
    int idx; bool on; int64_t t0;
    static int64_t now() {
        struct timespec ts;
        clock_gettime(CLOCK_MONOTONIC, &ts);
        return ts.tv_sec * 1000000000LL + ts.tv_nsec;
    }
    explicit ProfScope(int i) : idx(i), on(prof_on()) { if (on) t0 = now(); }
    ~ProfScope() { if (on) g_prof_ns[idx] += now() - t0; }
};
extern "C" void mm2tpu_prof_read(int64_t* out8) {
    for (int i = 0; i < 8; ++i) out8[i] = g_prof_ns[i].load();
}
extern "C" void mm2tpu_prof_reset() {
    for (int i = 0; i < 8; ++i) g_prof_ns[i] = 0;
}

// ASCII -> nt4 (seq_nt4_table, sketch.c:9-26): A=0 C=1 G=2 T/U=3 else 4.
static const uint8_t* nt4_table() {
    static uint8_t tab[256];
    static bool init = false;
    if (!init) {
        memset(tab, 4, sizeof(tab));
        const char* up = "ACGT";
        const char* lo = "acgt";
        for (int i = 0; i < 4; ++i) {
            tab[(uint8_t)up[i]] = (uint8_t)i;
            tab[(uint8_t)lo[i]] = (uint8_t)i;
        }
        tab[(uint8_t)'U'] = 3;
        tab[(uint8_t)'u'] = 3;
        init = true;
    }
    return tab;
}

// Per-read tie-break hash (reference map.c:345-347): wang_hash32 of
// X31(qname) ^ (wang(qlen_sum) + wang(seed)).
static inline uint32_t wang_hash32_nat(uint32_t key) {
    key += ~(key << 15);
    key ^= key >> 10;
    key += key << 3;
    key ^= key >> 6;
    key += ~(key << 11);
    key ^= key >> 16;
    return key;
}
static uint64_t qname_hash_nat(const char* qname, int64_t qname_len,
                               int64_t qlen_sum, uint32_t seed) {
    uint32_t h = 0;
    for (int64_t i = 0; i < qname_len; ++i)
        h = (h << 5) - h + (uint32_t)(uint8_t)qname[i];
    h ^= wang_hash32_nat((uint32_t)qlen_sum) + wang_hash32_nat(seed);
    return wang_hash32_nat(h);
}

extern "C" void mm2tpu_fix_update_extra(
    const uint8_t* qseq, const uint8_t* tseq, uint32_t* cigar,
    int64_t n_cigar, const int8_t* mat, int32_t q, int32_t e, int32_t rev,
    int64_t* coords, int64_t* out);
extern "C" void* mm2tpu_sketch_batch(const uint8_t* nt4, const int64_t* offs,
                                     int64_t n_seqs, int32_t w, int32_t k,
                                     const uint32_t* rids, int32_t is_hpc,
                                     int64_t* out_counts);
extern "C" void mm2tpu_sketch_take(void* handle, uint64_t* out);
extern "C" void* mm2tpu_collect_seeds_ava(
    const uint64_t* mv, int64_t n_mv, const uint64_t* keys, int64_t n_keys,
    const int64_t* starts, const uint64_t* values, int64_t max_occ,
    int64_t qlen_sum, int32_t skip_mode, const int64_t* name_rank,
    int64_t q_exact, int64_t q_ins, int32_t diag_flags,
    int64_t* out_sizes);
extern "C" void mm2tpu_collect_take(void* h, uint64_t* anchors,
                                    uint64_t* mini);
extern "C" int64_t mm2tpu_chain_dp(
    int64_t n, const uint64_t* ax, const uint64_t* ay, int64_t max_dist_x,
    int64_t max_dist_y, int64_t bw, int64_t max_skip, int32_t min_cnt,
    int32_t min_sc, int32_t is_cdna, int32_t n_segs, uint64_t* out_a,
    uint64_t* out_u, int64_t* out_n_v);

namespace {

constexpr uint64_t SEED_LONG_JOIN = 1ull << 40;
constexpr uint64_t SEED_IGNORE = 1ull << 41;
constexpr uint64_t SEED_TANDEM = 1ull << 42;
constexpr uint64_t SEED_SELF = 1ull << 43;
constexpr int64_t PARENT_UNSET = -1;
constexpr int64_t PARENT_TMP_PRI = -2;
constexpr int64_t F_SPLICE = 0x080, F_SR = 0x1000, F_FOR_ONLY = 0x100000,
                  F_REV_ONLY = 0x200000;
constexpr int64_t KSW_EZ_SPLICE_FOR_F = 0x100, KSW_EZ_SPLICE_REV_F = 0x200,
                  KSW_EZ_SPLICE_FLANK_F = 0x400;

inline int32_t lo32(uint64_t v) { return (int32_t)(uint32_t)v; }
inline int64_t span_of(uint64_t y) { return (int64_t)((y >> 32) & 0xFF); }

// region record exchanged with Python (28 int64 slots, see native.py)
constexpr int RF = 28;
enum { R_ID, R_CNT, R_RID, R_SCORE, R_QS, R_QE, R_RS, R_RE, R_PARENT,
       R_SUBSC, R_AS, R_MLEN, R_BLEN, R_NSUB, R_SCORE0, R_MAPQ, R_SPLIT,
       R_REV, R_INV, R_SAMPRI, R_PROPER, R_PETHRU, R_SEGSPLIT, R_SEGID,
       R_SPLITINV, R_HASH, R_DIVBITS, R_HASP };

struct NatReg {
    int64_t f[RF];
    int64_t dp_score = 0, dp_max = 0, dp_max2 = 0, n_ambi = 0,
            trans_strand = 0;
    std::vector<uint32_t> cigar;
    int64_t& operator[](int i) { return f[i]; }
    int64_t operator[](int i) const { return f[i]; }
};

struct Ctx {
    // index
    const uint8_t* S;
    const int64_t* seq_off;
    const int64_t* seq_len;
    int64_t n_seq;
    int32_t k;
    bool hpc;
    // options
    const int8_t* mat;
    int64_t flag, oa, ob, q, e, q2, e2, zdrop, zdrop_inv, end_bonus,
        min_cnt, min_chain_score, min_dp_max, max_gap, bw, min_ksw_len;
    int64_t noncan = 0, anchor_ext_len = 0, anchor_ext_shift = 0;
    // per-read
    uint64_t* A;       // anchors (n_a, 2) modified in place (seed flags)
    int64_t n_a;
    const uint8_t* qstr[2];  // fwd / revcomp nt4
    int64_t qlen;
    Work wk;
    bool bad = false;  // contract violation -> caller falls back
};

inline uint64_t AX(const Ctx& c, int64_t i) { return c.A[2 * i]; }
inline uint64_t AY(const Ctx& c, int64_t i) { return c.A[2 * i + 1]; }

inline const uint8_t* getseq(const Ctx& c, int64_t rid, int64_t st,
                             int64_t en, int64_t& len) {
    int64_t L = c.seq_len[rid];
    if (en > L) en = L;
    len = en - st;
    return c.S + c.seq_off[rid] + st;
}

// ---- ksw_ll (golden model ops/ksw2.py:ksw_ll; reference ksw2_ll_sse.c):
// local SW score + end coords with the striped-layout qe tie rule.
static int64_t ksw_ll(const uint8_t* qs, int64_t qlen, const uint8_t* ts,
                      int64_t tlen, const int8_t* mat, int64_t gapo,
                      int64_t gape, int64_t* qe_out, int64_t* te_out) {
    *qe_out = -1; *te_out = -1;
    if (qlen <= 0 || tlen <= 0) return 0;
    int64_t slen = (qlen + 7) / 8, q8 = slen * 8, gapoe = gapo + gape;
    std::vector<int64_t> Hp(q8, 0), E(q8, 0), h0(q8), h(q8), Hmax(q8, 0);
    int64_t gmax = 0, te = -1;
    for (int64_t i = 0; i < tlen; ++i) {
        const int8_t* mrow = mat + ts[i] * 5;
        for (int64_t j = 0; j < q8; ++j) {
            int64_t sc = j < qlen ? mrow[qs[j]] : 0;
            int64_t diag = (j ? Hp[j - 1] : 0) + sc;
            h0[j] = diag > E[j] ? diag : E[j];
        }
        // exact F: opening only from h0 (prefix-max formulation)
        int64_t fmax = INT64_MIN;
        for (int64_t j = 0; j < q8; ++j) {
            int64_t F = 0;
            if (j > 0) {
                F = fmax - (j - 1) * gape;
                if (F < 0) F = 0;
            }
            int64_t tv = h0[j] - gapoe + j * gape;
            if (tv > fmax) fmax = tv;
            int64_t hv = h0[j] > F ? h0[j] : F;
            if (hv < 0) hv = 0;
            h[j] = hv;
            int64_t ev = E[j] - gape;
            int64_t e2v = hv - gapoe;
            if (e2v > ev) ev = e2v;
            if (ev < 0) ev = 0;
            E[j] = ev;
        }
        int64_t imax = 0;
        for (int64_t j = 0; j < q8; ++j)
            if (h[j] > imax) imax = h[j];
        if (imax >= gmax) {
            gmax = imax; te = i;
            Hmax = h;
        }
        Hp = h;
    }
    int64_t best_stripe = -1, qe = -1;
    for (int64_t j = 0; j < q8; ++j) {
        if (Hmax[j] == gmax) {
            int64_t stripe = (j % slen) * 8 + j / slen;
            if (stripe > best_stripe) { best_stripe = stripe; qe = j; }
        }
    }
    *qe_out = qe; *te_out = te;
    return gmax;
}

// ---- mm_append_cigar (align.c:195-218)
static void append_cigar(NatReg& r, const uint32_t* cig, int64_t n) {
    if (n <= 0) return;
    r[R_HASP] = 1;
    auto& c = r.cigar;
    int64_t i = 0;
    if (!c.empty() && (c.back() & 0xF) == (cig[0] & 0xF)) {
        c.back() += (cig[0] >> 4) << 4;
        i = 1;
    }
    c.insert(c.end(), cig + i, cig + n);
}

// ---- cal_fuzzy_len + reg_set_coor (hit.c:8-38)
static void cal_fuzzy_len(const Ctx& c, NatReg& r) {
    r[R_MLEN] = r[R_BLEN] = 0;
    if (r[R_CNT] <= 0) return;
    int64_t as_ = r[R_AS];
    int64_t m = span_of(AY(c, as_)), b = m;
    for (int64_t i = as_ + 1; i < as_ + r[R_CNT]; ++i) {
        int64_t span = span_of(AY(c, i));
        int64_t tl = (int64_t)(uint32_t)AX(c, i) - (int64_t)(uint32_t)AX(c, i - 1);
        int64_t ql = (int64_t)(uint32_t)AY(c, i) - (int64_t)(uint32_t)AY(c, i - 1);
        b += tl > ql ? tl : ql;
        m += (tl > span && ql > span) ? span : (tl < ql ? tl : ql);
    }
    r[R_MLEN] = m; r[R_BLEN] = b;
}

static void reg_set_coor(const Ctx& c, NatReg& r) {
    int64_t k = r[R_AS];
    int64_t q_span = span_of(AY(c, k));
    r[R_REV] = (int64_t)(AX(c, k) >> 63);
    r[R_RID] = (int64_t)((AX(c, k) << 1) >> 33);
    int64_t rs = (int64_t)lo32(AX(c, k)) + 1 - q_span;
    r[R_RS] = rs > 0 ? rs : 0;
    r[R_RE] = (int64_t)lo32(AX(c, k + r[R_CNT] - 1)) + 1;
    int64_t y0 = lo32(AY(c, k)), y1 = lo32(AY(c, k + r[R_CNT] - 1));
    if (!r[R_REV]) {
        r[R_QS] = y0 + 1 - q_span;
        r[R_QE] = y1 + 1;
    } else {
        r[R_QS] = c.qlen - (y1 + 1);
        r[R_QE] = c.qlen - (y0 + 1 - q_span);
    }
    cal_fuzzy_len(c, r);
}

// ---- mm_split_reg (hit.c:90-107)
static bool split_reg(const Ctx& c, NatReg& r, int64_t n, NatReg& r2) {
    if (n <= 0 || n >= r[R_CNT]) return false;
    r2 = NatReg();
    memcpy(r2.f, r.f, sizeof(r.f));
    r2[R_ID] = -1;
    r2[R_SAMPRI] = 0;
    r2[R_HASP] = 0;
    r2[R_SPLITINV] = 0;
    r2[R_CNT] = r[R_CNT] - n;
    // f32 ratio and f32 product + the double .499 literal (hit.c:99)
    r2[R_SCORE] = (int64_t)((double)((float)r[R_SCORE]
                            * ((float)r2[R_CNT] / (float)r[R_CNT])) + .499);
    r2[R_AS] = r[R_AS] + n;
    if (r[R_PARENT] == r[R_ID]) r2[R_PARENT] = PARENT_TMP_PRI;
    reg_set_coor(c, r2);
    r[R_CNT] -= r2[R_CNT];
    r[R_SCORE] -= r2[R_SCORE];
    reg_set_coor(c, r);
    r[R_SPLIT] |= 1;
    r2[R_SPLIT] |= 2;
    return true;
}

// ---- adjust_minier (align.c:254-269)
static void adjust_minier(const Ctx& c, uint64_t ax, uint64_t ay,
                          int64_t& rr, int64_t& qq) {
    if (c.hpc) {
        const uint8_t* qseq = c.qstr[ax >> 63];
        int64_t q = lo32(ay);
        uint8_t ch = qseq[q];
        int64_t i = q - 1;
        while (i > 0 && qseq[i] == ch) --i;
        qq = i + 1;
        int64_t rid = (int64_t)((ax << 1) >> 33);
        int64_t x = lo32(ax);
        const uint8_t* S = c.S + c.seq_off[rid];
        uint8_t cr = S[x];
        i = x - 1;
        while (i >= 0 && S[i] == cr) --i;
        rr = x + 1 - (x - i);
    } else {
        rr = lo32(ax) - (c.k >> 1);
        qq = lo32(ay) - (c.k >> 1);
    }
}

// ---- mm_fix_bad_ends (align.c:317-351)
static void fix_bad_ends(const Ctx& c, const NatReg& r, int64_t bw,
                         int64_t min_match, int64_t& as_out,
                         int64_t& cnt_out) {
    int64_t as_ = r[R_AS], cnt = r[R_CNT];
    as_out = as_; cnt_out = cnt;
    if (cnt < 3) return;
    int64_t m, l;
    m = l = span_of(AY(c, as_));
    for (int64_t i = as_ + 1; i < as_ + cnt - 1; ++i) {
        int64_t q_span = span_of(AY(c, i));
        if (AY(c, i) & SEED_LONG_JOIN) break;
        int64_t lr = (int64_t)lo32(AX(c, i)) - lo32(AX(c, i - 1));
        int64_t lq = (int64_t)lo32(AY(c, i)) - lo32(AY(c, i - 1));
        int64_t mn = lr < lq ? lr : lq, mx = lr > lq ? lr : lq;
        if (mx - mn > (l >> 1)) as_out = i;
        l += mn;
        m += mn < q_span ? mn : q_span;
        if (l >= bw << 1 || (m >= min_match && m >= bw) || m >= r[R_MLEN] >> 1)
            break;
    }
    cnt_out = as_ + cnt - as_out;
    m = l = span_of(AY(c, as_ + cnt - 1));
    for (int64_t i = as_ + cnt - 2; i > as_out; --i) {
        int64_t q_span = span_of(AY(c, i + 1));
        if (AY(c, i + 1) & SEED_LONG_JOIN) break;
        int64_t lr = (int64_t)lo32(AX(c, i + 1)) - lo32(AX(c, i));
        int64_t lq = (int64_t)lo32(AY(c, i + 1)) - lo32(AY(c, i));
        int64_t mn = lr < lq ? lr : lq, mx = lr > lq ? lr : lq;
        if (mx - mn > (l >> 1)) cnt_out = i + 1 - as_out;
        l += mn;
        m += mn < q_span ? mn : q_span;
        if (l >= bw << 1 || (m >= min_match && m >= bw) || m >= r[R_MLEN] >> 1)
            break;
    }
}

// ---- max_stretch for sr (align.c:353-379)
static void max_stretch(const Ctx& c, const NatReg& r, int64_t& as_out,
                        int64_t& cnt_out) {
    int64_t as_ = r[R_AS], cnt = r[R_CNT];
    as_out = as_; cnt_out = cnt;
    if (cnt < 2) return;
    int64_t max_score = -1, max_i = -1, max_len = 0;
    int64_t score = span_of(AY(c, as_)), length = 1;
    int64_t i = as_ + 1;
    for (; i < as_ + cnt; ++i) {
        int64_t q_span = span_of(AY(c, i));
        int64_t lr = (int64_t)lo32(AX(c, i)) - lo32(AX(c, i - 1));
        int64_t lq = (int64_t)lo32(AY(c, i)) - lo32(AY(c, i - 1));
        if (lq == lr) {
            score += lq < q_span ? lq : q_span;
            ++length;
        } else {
            if (score > max_score) {
                max_score = score; max_len = length; max_i = i - length;
            }
            score = q_span; length = 1;
        }
    }
    if (score > max_score) {
        max_score = score; max_len = length; max_i = i - length;
    }
    as_out = max_i; cnt_out = max_len;
}

// ---- mm_filter_bad_seeds (align.c:271-315)
static void filter_bad_seeds(Ctx& c, int64_t as1, int64_t cnt1,
                             int64_t min_gap, int64_t diff_thres,
                             int64_t max_ext_len, int64_t max_ext_cnt) {
    std::vector<int64_t> K;  // gap positions (1-based within the chain)
    for (int64_t i = 1; i < cnt1; ++i) {
        int64_t gap = ((int64_t)(uint32_t)AY(c, as1 + i)
                       - (int64_t)(uint32_t)AY(c, as1 + i - 1))
                      - ((int64_t)(uint32_t)AX(c, as1 + i)
                         - (int64_t)(uint32_t)AX(c, as1 + i - 1));
        if (gap < -min_gap || gap > min_gap) K.push_back(i);
    }
    int64_t n = (int64_t)K.size();
    if (n <= 1) return;
    auto gap_at = [&](int64_t i) {
        return ((int64_t)(uint32_t)AY(c, as1 + i)
                - (int64_t)(uint32_t)AY(c, as1 + i - 1))
               - ((int64_t)(uint32_t)AX(c, as1 + i)
                  - (int64_t)(uint32_t)AX(c, as1 + i - 1));
    };
    int64_t maxv = 0, max_st = -1, max_en = -1;
    int64_t k = 0;
    while (true) {
        if (k == n || k >= max_en) {
            if (max_en > 0)
                for (int64_t i = K[max_st]; i < K[max_en]; ++i)
                    c.A[2 * (as1 + i) + 1] |= SEED_IGNORE;
            maxv = 0; max_st = max_en = -1;
            if (k == n) break;
        }
        int64_t i = K[k];
        int64_t gap = gap_at(i);
        int64_t n_ins = gap > 0 ? gap : 0;
        int64_t n_del = gap <= 0 ? -gap : 0;
        int64_t qs = (int64_t)lo32(AY(c, as1 + i - 1));
        int64_t rs = (int64_t)lo32(AX(c, as1 + i - 1));
        int64_t max_diff = 0, max_diff_l = -1;
        for (int64_t l = k + 1; l < n && l <= k + max_ext_cnt; ++l) {
            int64_t j = K[l];
            if ((int64_t)lo32(AY(c, as1 + j)) - qs > max_ext_len
                || (int64_t)lo32(AX(c, as1 + j)) - rs > max_ext_len)
                break;
            int64_t g = gap_at(j);
            if (g > 0) n_ins += g; else n_del += -g;
            int64_t d = n_ins + n_del - llabs(n_ins - n_del);
            if (max_diff < d) { max_diff = d; max_diff_l = l; }
        }
        if (max_diff > diff_thres && max_diff > maxv) {
            maxv = max_diff; max_st = k; max_en = max_diff_l;
        }
        ++k;
    }
}

// ---- mm_test_zdrop incl. inversion probe (align.c:46-88)
static int test_zdrop(Ctx& c, const uint8_t* qseq, const uint8_t* tseq,
                      const uint32_t* cig, int64_t n_cig) {
    int64_t out[5];
    zdrop_scan_one(qseq, tseq, cig, n_cig, c.mat, (int32_t)c.q, (int32_t)c.e,
                   out);
    int64_t max_zdrop = out[0];
    int64_t t_st = out[1], t_en = out[2], q_st = out[3], q_en = out[4];
    int64_t q_len = q_en - q_st, t_len = t_en - t_st;
    if (!(c.flag & (F_SPLICE | F_SR | F_FOR_ONLY | F_REV_ONLY))
        && max_zdrop > c.zdrop_inv && q_len < c.max_gap
        && t_len < c.max_gap) {
        std::vector<uint8_t> q2v(q_len);
        for (int64_t i = 0; i < q_len; ++i) {
            uint8_t b = qseq[q_en - 1 - i];
            q2v[i] = b >= 4 ? 4 : (uint8_t)(3 - b);
        }
        int64_t qe, te;
        int64_t score = ksw_ll(q2v.data(), q_len, tseq + t_st, t_len, c.mat,
                               c.q, c.e, &qe, &te);
        if (score >= c.min_chain_score * c.oa && score >= c.min_dp_max)
            return 2;
    }
    return max_zdrop > c.zdrop ? 1 : 0;
}

// the replay hook (align_replay.cc): set while a unit is replayed
struct Replay;
static thread_local Replay* g_replay = nullptr;
static bool replay_ext(Replay& rp, const uint8_t* qs, int64_t ql,
                       const uint8_t* ts, int64_t tl, int64_t w,
                       int64_t zdrop, int64_t end_bonus, int64_t flag,
                       EzOut& ez, std::vector<uint32_t>& cig);
static bool replay_missed(const Replay* rp);

// extension-job runner on the shared Work
static void run_ext(Ctx& c, const uint8_t* qs, int64_t ql, const uint8_t* ts,
                    int64_t tl, int64_t w, int64_t zdrop, int64_t end_bonus,
                    int64_t flag, EzOut& ez, std::vector<uint32_t>& cig) {
    if (g_replay && replay_ext(*g_replay, qs, ql, ts, tl, w, zdrop,
                               end_bonus, flag, ez, cig))
        return;
    cig.resize(ql + tl + 4);
    int64_t n_cig = 0;
    if (c.flag & F_SPLICE)  // mm_align_pair splice route (align.c:230-233)
        exts2_one(qs, ql, ts, tl, c.mat, (int)c.q, (int)c.e, (int)c.q2,
                  (int)c.noncan, (int)zdrop, (int)flag, c.wk, ez,
                  cig.data(), n_cig);
    else
        extd2_one(qs, ql, ts, tl, c.mat, (int)c.q, (int)c.e, (int)c.q2,
                  (int)c.e2, (int)w, (int)zdrop, (int)end_bonus, (int)flag,
                  c.wk, ez, cig.data(), n_cig);
    cig.resize(n_cig);
}

// ---- seed rescoring + splice end fixing (align.c:381-421)
static int64_t seed_ext_score(Ctx& c, uint64_t ax, uint64_t ay) {
    int64_t q_span = span_of(ay);
    int64_t ext_len = c.anchor_ext_len;
    int64_t rid = (int64_t)((ax << 1) >> 33);
    int64_t re = (int64_t)lo32(ax) + 1, rs = re - q_span;
    int64_t qe = (int64_t)lo32(ay) + 1, qs = qe - q_span;
    rs = rs - ext_len > 0 ? rs - ext_len : 0;
    qs = qs - ext_len > 0 ? qs - ext_len : 0;
    int64_t L = c.seq_len[rid];
    re = re + ext_len < L ? re + ext_len : L;
    int64_t qmax = c.qlen;
    qe = qe + ext_len < qmax ? qe + ext_len : qmax;
    int64_t tl;
    const uint8_t* ts = getseq(c, rid, rs, re, tl);
    const uint8_t* qp = c.qstr[ax >> 63] + qs;
    int64_t qeo, teo;
    return ksw_ll(qp, qe - qs, ts, tl, c.mat, c.q, c.e, &qeo, &teo);
}

static void fix_bad_ends_splice(Ctx& c, const NatReg& r, int64_t& as_out,
                                int64_t& cnt_out) {
    int64_t as1 = r[R_AS], cnt1 = r[R_CNT];
    as_out = as1; cnt_out = cnt1;
    if (r[R_CNT] < 3) return;
    double log_gap = log((double)((int64_t)lo32(AX(c, as1 + 1))
                                  - lo32(AX(c, as1))));
    if ((double)span_of(AY(c, as1)) < log_gap + c.anchor_ext_shift) {
        int64_t score = seed_ext_score(c, AX(c, as1), AY(c, as1));
        if ((double)score / c.mat[0] < log_gap + c.anchor_ext_shift) {
            ++as_out; --cnt_out;
        }
    }
    log_gap = log((double)((int64_t)lo32(AX(c, as1 + cnt1 - 1))
                           - lo32(AX(c, as1 + cnt1 - 2))));
    if ((double)span_of(AY(c, as1 + cnt1 - 1))
        < log_gap + c.anchor_ext_shift) {
        int64_t score = seed_ext_score(c, AX(c, as1 + cnt1 - 1),
                                       AY(c, as1 + cnt1 - 1));
        if ((double)score / c.mat[0] < log_gap + c.anchor_ext_shift)
            --cnt_out;
    }
}

// ---- mm_update_extra via the fused fix_cigar+scan (align_epilogue.cc)
static void update_extra(Ctx& c, NatReg& r, const uint8_t* qseq,
                         const uint8_t* tseq) {
    if (!r[R_HASP] || replay_missed(g_replay)) return;
    int64_t coords[4] = {r[R_QS], r[R_QE], r[R_RS], r[R_RE]};
    int64_t out[6] = {0, 0, 0, 0, 0, 0};
    mm2tpu_fix_update_extra(qseq, tseq, r.cigar.data(),
                            (int64_t)r.cigar.size(), c.mat, (int32_t)c.q,
                            (int32_t)c.e, (int32_t)r[R_REV], coords, out);
    if (!out[5]) { c.bad = true; return; }
    r.cigar.resize(out[0]);
    r[R_QS] = coords[0]; r[R_QE] = coords[1];
    r[R_RS] = coords[2]; r[R_RE] = coords[3];
    r[R_BLEN] = out[1]; r[R_MLEN] = out[2];
    r.n_ambi += out[3];
    r.dp_max = out[4];
}

// ---- mm_align1 (align.c:423-636).  Returns true when a split region r2
// was produced.
static bool align1(Ctx& c, NatReg& r, NatReg& r2, int64_t splice_flag = 0) {
    bool is_sr = c.flag & F_SR;
    bool is_splice = c.flag & F_SPLICE;
    bool made_r2 = false;
    if (r[R_CNT] == 0) return false;
    int64_t as0 = r[R_AS];
    int64_t rid = (int64_t)((AX(c, as0) << 1) >> 33);
    int64_t rev = (int64_t)(AX(c, as0) >> 63);
    int64_t bw = (int64_t)((double)c.bw * 1.5 + 1.0);
    int64_t dropped = 0;
    int64_t extra_flag = 0;
    if (is_splice) {  // splice strand flags (align.c:538-544)
        constexpr int64_t MF_SPLICE_FOR = 0x100, MF_SPLICE_REV = 0x200,
            MF_SPLICE_FLANK = 0x40000;
        if (splice_flag & MF_SPLICE_FOR)
            extra_flag |= rev ? KSW_EZ_SPLICE_REV_F : KSW_EZ_SPLICE_FOR_F;
        if (splice_flag & MF_SPLICE_REV)
            extra_flag |= rev ? KSW_EZ_SPLICE_FOR_F : KSW_EZ_SPLICE_REV_F;
        if (c.flag & MF_SPLICE_FLANK)
            extra_flag |= KSW_EZ_SPLICE_FLANK_F;
    }

    int64_t as1, cnt1, rs, qs, re, qe;
    if (is_sr && !c.hpc) {
        max_stretch(c, r, as1, cnt1);
        rs = (int64_t)lo32(AX(c, as1)) + 1 - span_of(AY(c, as1));
        qs = (int64_t)lo32(AY(c, as1)) + 1 - span_of(AY(c, as1));
        re = (int64_t)lo32(AX(c, as1 + cnt1 - 1)) + 1;
        qe = (int64_t)lo32(AY(c, as1 + cnt1 - 1)) + 1;
    } else {
        if (is_splice)
            fix_bad_ends_splice(c, r, as1, cnt1);
        else
            fix_bad_ends(c, r, c.bw, c.min_chain_score * 2, as1, cnt1);
        filter_bad_seeds(c, as1, cnt1, 10, 40, c.max_gap >> 1, 10);
        adjust_minier(c, AX(c, as1), AY(c, as1), rs, qs);
        adjust_minier(c, AX(c, as1 + cnt1 - 1), AY(c, as1 + cnt1 - 1), re, qe);
    }
    if (cnt1 <= 0) { c.bad = true; return false; }

    int64_t tlen_rid = c.seq_len[rid];
    int64_t rs0, qs0, re0, qe0;
    if (is_sr) {
        qs0 = 0; qe0 = c.qlen;
        int64_t l = qs;
        if (l * c.oa + c.end_bonus > c.q)
            l += (l * c.oa + c.end_bonus - c.q) / c.e;
        rs0 = rs - l > 0 ? rs - l : 0;
        l = c.qlen - qe;
        if (l * c.oa + c.end_bonus > c.q)
            l += (l * c.oa + c.end_bonus - c.q) / c.e;
        re0 = re + l < tlen_rid ? re + l : tlen_rid;
    } else {
        rs0 = (int64_t)lo32(AX(c, as0)) + 1 - span_of(AY(c, as0));
        qs0 = (int64_t)lo32(AY(c, as0)) + 1 - span_of(AY(c, as0));
        if (rs0 < 0) rs0 = 0;
        if (qs0 < 0) { c.bad = true; return false; }
        int64_t rs1 = 0, qs1 = 0;
        uint64_t hi32 = AX(c, as0) >> 32;
        // same-target-block bounds (anchors sorted by x)
        int64_t blk_lo = 0, blk_hi = c.n_a;
        {
            int64_t lo = 0, hi = c.n_a;
            while (lo < hi) {
                int64_t mid = (lo + hi) >> 1;
                if ((AX(c, mid) >> 32) < hi32) lo = mid + 1; else hi = mid;
            }
            blk_lo = lo;
            lo = 0; hi = c.n_a;
            while (lo < hi) {
                int64_t mid = (lo + hi) >> 1;
                if ((AX(c, mid) >> 32) <= hi32) lo = mid + 1; else hi = mid;
            }
            blk_hi = lo;
        }
        if (blk_lo < as0) {
            // (min_cnt+1)-th colinear predecessor from the end
            int64_t found = 0, h = -1;
            for (int64_t i = as0 - 1; i >= blk_lo; --i) {
                int64_t xs = (int64_t)lo32(AX(c, i)) + 1 - span_of(AY(c, i));
                int64_t ys = (int64_t)lo32(AY(c, i)) + 1 - span_of(AY(c, i));
                if (xs < rs0 && ys < qs0) {
                    ++found;
                    if (found == c.min_cnt + 1) { h = i; break; }
                }
            }
            if (h >= 0) {
                int64_t xs = (int64_t)lo32(AX(c, h)) + 1 - span_of(AY(c, h));
                int64_t ys = (int64_t)lo32(AY(c, h)) + 1 - span_of(AY(c, h));
                int64_t l = rs0 - xs > qs0 - ys ? rs0 - xs : qs0 - ys;
                rs1 = rs0 - l; qs1 = qs0 - l;
            }
        }
        if (qs > 0 && rs > 0) {
            int64_t l = qs < c.max_gap ? qs : c.max_gap;
            qs1 = qs1 > qs - l ? qs1 : qs - l;
            qs0 = qs0 < qs1 ? qs0 : qs1;
            if (l * c.oa > c.q) l += (l * c.oa - c.q) / c.e;
            l = l < c.max_gap ? l : c.max_gap;
            l = l < rs ? l : rs;
            rs1 = rs1 > rs - l ? rs1 : rs - l;
            rs0 = rs0 < rs1 ? rs0 : rs1;
        } else {
            rs0 = rs; qs0 = qs;
        }
        re0 = (int64_t)lo32(AX(c, as0 + r[R_CNT] - 1)) + 1;
        qe0 = (int64_t)lo32(AY(c, as0 + r[R_CNT] - 1)) + 1;
        int64_t re1 = tlen_rid, qe1 = c.qlen;
        int64_t i0f = as0 + r[R_CNT];
        if (i0f < blk_hi) {
            int64_t found = 0, h = -1;
            for (int64_t i = i0f; i < blk_hi; ++i) {
                int64_t xs = (int64_t)lo32(AX(c, i)) + 1;
                int64_t ys = (int64_t)lo32(AY(c, i)) + 1;
                if (xs > re0 && ys > qe0) {
                    if (found == c.min_cnt) { h = i; break; }
                    ++found;
                }
            }
            if (h >= 0) {
                int64_t xs = (int64_t)lo32(AX(c, h)) + 1;
                int64_t ys = (int64_t)lo32(AY(c, h)) + 1;
                int64_t l = xs - re0 > ys - qe0 ? xs - re0 : ys - qe0;
                re1 = re0 + l; qe1 = qe0 + l;
            }
        }
        if (qe < c.qlen && re < tlen_rid) {
            int64_t l = c.qlen - qe < c.max_gap ? c.qlen - qe : c.max_gap;
            qe1 = qe1 < qe + l ? qe1 : qe + l;
            qe0 = qe0 > qe1 ? qe0 : qe1;
            if (l * c.oa > c.q) l += (l * c.oa - c.q) / c.e;
            l = l < c.max_gap ? l : c.max_gap;
            l = l < tlen_rid - re ? l : tlen_rid - re;
            re1 = re1 < re + l ? re1 : re + l;
            re0 = re0 > re1 ? re0 : re1;
        } else {
            re0 = re; qe0 = qe;
        }
    }
    if (AY(c, as0) & SEED_SELF) {
        int64_t max_ext = llabs(r[R_QS] - r[R_RS]);
        if (r[R_RS] - rs0 > max_ext) rs0 = r[R_RS] - max_ext;
        if (r[R_QS] - qs0 > max_ext) qs0 = r[R_QS] - max_ext;
        max_ext = llabs(r[R_QE] - r[R_RE]);
        if (re0 - r[R_RE] > max_ext) re0 = r[R_RE] + max_ext;
        if (qe0 - r[R_QE] > max_ext) qe0 = r[R_QE] + max_ext;
    }
    if (re0 <= rs0) { c.bad = true; return false; }

    const uint8_t* qstrand = c.qstr[rev];

    // cut-point enumeration (the fill loop's ksw job boundaries)
    struct Cut { int64_t i, re, qe; bool lj; };
    std::vector<Cut> cuts;
    {
        int64_t rs_c = rs, qs_c = qs;
        int64_t i = is_sr ? cnt1 - 1 : 1;
        for (; i < cnt1; ++i) {
            uint64_t ay_i = AY(c, as1 + i);
            if ((ay_i & (SEED_IGNORE | SEED_TANDEM)) && i != cnt1 - 1)
                continue;
            int64_t re_c, qe_c;
            if (is_sr && !c.hpc) {
                re_c = (int64_t)lo32(AX(c, as1 + i)) + 1;
                qe_c = (int64_t)lo32(AY(c, as1 + i)) + 1;
            } else {
                adjust_minier(c, AX(c, as1 + i), ay_i, re_c, qe_c);
            }
            if (i == cnt1 - 1 || (ay_i & SEED_LONG_JOIN)
                || (qe_c - qs_c >= c.min_ksw_len
                    && re_c - rs_c >= c.min_ksw_len)) {
                cuts.push_back({i, re_c, qe_c,
                                (bool)(ay_i & SEED_LONG_JOIN)});
                rs_c = re_c; qs_c = qe_c;
            }
        }
    }

    EzOut ez;
    std::vector<uint32_t> cig;
    int64_t rs1, qs1, re1, qe1;
    bool has_left = qs > 0 && rs > 0;
    if (has_left) {  // left extension on reversed sequences
        std::vector<uint8_t> qb(qs - qs0), tb;
        for (int64_t j = 0; j < qs - qs0; ++j) qb[j] = qstrand[qs - 1 - j];
        int64_t tl;
        const uint8_t* tp = getseq(c, rid, rs0, rs, tl);
        tb.resize(tl);
        for (int64_t j = 0; j < tl; ++j) tb[j] = tp[tl - 1 - j];
        run_ext(c, qb.data(), (int64_t)qb.size(), tb.data(), tl, bw,
                r[R_SPLITINV] ? c.zdrop_inv : c.zdrop, c.end_bonus,
                extra_flag | KSW_EZ_EXTZ_ONLY | KSW_EZ_RIGHT
                | KSW_EZ_REV_CIGAR, ez, cig);
        if (!cig.empty()) {
            append_cigar(r, cig.data(), (int64_t)cig.size());
            r.dp_score += ez.max;
        }
        rs1 = rs - (ez.reach_end ? ez.mqe_t + 1 : ez.max_t + 1);
        qs1 = qs - (ez.reach_end ? qs - qs0 : ez.max_q + 1);
    } else {
        rs1 = rs; qs1 = qs;
    }
    re1 = rs; qe1 = qs;
    if (qs1 < 0 || rs1 < 0) { c.bad = true; return false; }

    for (auto& cut : cuts) {  // gap filling
        int64_t i = cut.i, rec = cut.re, qec = cut.qe;
        re1 = rec; qe1 = qec;
        int64_t bw1 = cut.lj
            ? (qec - qs > rec - rs ? qec - qs : rec - rs) : bw;
        const uint8_t* qseq = qstrand + qs;
        int64_t tl;
        const uint8_t* tseq = getseq(c, rid, rs, rec, tl);
        if (is_sr) {  // ungapped
            if (qec - qs != rec - rs) { c.bad = true; return false; }
            ez = EzOut{0, 0, -1, -1, KSW_NEG_INF, -1, KSW_NEG_INF, -1, 0,
                       0, 0};
            int64_t sc = 0;
            for (int64_t j = 0; j < qec - qs; ++j) {
                uint8_t cq = qseq[j], ct = tseq[j];
                if (cq >= 4 || ct >= 4) sc += c.e2;
                else sc += cq == ct ? c.oa : -c.ob;
            }
            ez.score = sc;
            cig.assign(1, (uint32_t)((qec - qs) << 4 | 0));
            ez.n_cigar = 1;
        } else {
            run_ext(c, qseq, qec - qs, tseq, tl, bw1, c.zdrop, -1,
                    extra_flag | KSW_EZ_APPROX_MAX, ez, cig);
        }
        int zcode = test_zdrop(c, qseq, tseq, cig.data(),
                               (int64_t)cig.size());
        if (zcode != 0) {  // exact second pass
            run_ext(c, qseq, qec - qs, tseq, tl, bw1,
                    zcode == 2 ? c.zdrop_inv : c.zdrop, -1, extra_flag,
                    ez, cig);
        }
        if (!cig.empty())
            append_cigar(r, cig.data(), (int64_t)cig.size());
        if (ez.zdropped) {
            int64_t j = i - 1;
            while (j >= 0) {
                if ((int64_t)lo32(AX(c, as1 + j)) <= rs + ez.max_t) break;
                --j;
            }
            dropped = 1;
            if (j < 0) j = 0;
            r[R_HASP] = 1;
            r.dp_score += ez.max;
            re1 = rs + (ez.max_t + 1);
            qe1 = qs + (ez.max_q + 1);
            if (cnt1 - (j + 1) >= c.min_cnt) {
                if (split_reg(c, r, as1 + j + 1 - r[R_AS], r2)) {
                    made_r2 = true;
                    if (zcode == 2) r2[R_SPLITINV] = 1;
                }
            }
            break;
        } else {
            r[R_HASP] = 1;
            r.dp_score += ez.score;
        }
        rs = rec; qs = qec;
    }

    if (!dropped && qe < qe0 && re < re0) {  // right extension
        const uint8_t* qseq = qstrand + qe;
        int64_t tl;
        const uint8_t* tseq = getseq(c, rid, re, re0, tl);
        run_ext(c, qseq, qe0 - qe, tseq, tl, bw, c.zdrop, c.end_bonus,
                extra_flag | KSW_EZ_EXTZ_ONLY, ez, cig);
        if (!cig.empty()) {
            append_cigar(r, cig.data(), (int64_t)cig.size());
            r.dp_score += ez.max;
        }
        re1 = re + (ez.reach_end ? ez.mqe_t + 1 : ez.max_t + 1);
        qe1 = qe + (ez.reach_end ? qe0 - qe : ez.max_q + 1);
    }
    if (qe1 > c.qlen) { c.bad = true; return made_r2; }

    r[R_RS] = rs1; r[R_RE] = re1;
    if (rev) { r[R_QS] = c.qlen - qe1; r[R_QE] = c.qlen - qs1; }
    else { r[R_QS] = qs1; r[R_QE] = qe1; }

    if (re1 - rs1 > re0 - rs0) { c.bad = true; return made_r2; }
    if (r[R_HASP]) {
        int64_t tl;
        const uint8_t* tseq = getseq(c, rid, rs1, re1, tl);
        update_extra(c, r, c.qstr[r[R_REV]] + qs1, tseq);
        if (r[R_REV] && r.trans_strand) r.trans_strand ^= 3;
    }
    return made_r2;
}

// ---- mm_align1_inv (align.c:638-693)
static bool align1_inv(Ctx& c, const NatReg& r1, const NatReg& r2,
                       NatReg& ri) {
    if (!(r1[R_SPLIT] & 1) || !(r2[R_SPLIT] & 2)) return false;
    if (r1[R_ID] != r1[R_PARENT] && r1[R_PARENT] != PARENT_TMP_PRI)
        return false;
    if (r2[R_ID] != r2[R_PARENT] && r2[R_PARENT] != PARENT_TMP_PRI)
        return false;
    if (r1[R_RID] != r2[R_RID] || r1[R_REV] != r2[R_REV]) return false;
    int64_t ql = r1[R_REV] ? r1[R_QS] - r2[R_QE] : r2[R_QS] - r1[R_QE];
    int64_t tl = r2[R_RS] - r1[R_RE];
    if (ql < c.min_chain_score || ql > c.max_gap) return false;
    if (tl < c.min_chain_score || tl > c.max_gap) return false;
    int64_t tlen;
    const uint8_t* tseq = getseq(c, r1[R_RID], r1[R_RE], r2[R_RS], tlen);
    const uint8_t* qseq;
    if (r1[R_REV]) qseq = c.qstr[0] + r2[R_QE];
    else qseq = c.qstr[1] + (c.qlen - r2[R_QS]);
    // ksw_ll on the reversed pair
    std::vector<uint8_t> qr(ql), tr(tlen);
    for (int64_t i = 0; i < ql; ++i) qr[i] = qseq[ql - 1 - i];
    for (int64_t i = 0; i < tlen; ++i) tr[i] = tseq[tlen - 1 - i];
    int64_t q_off, t_off;
    int64_t score = ksw_ll(qr.data(), ql, tr.data(), tlen, c.mat, c.q, c.e,
                           &q_off, &t_off);
    if (score < c.min_dp_max) return false;
    q_off = ql - (q_off + 1);
    t_off = tl - (t_off + 1);
    EzOut ez;
    std::vector<uint32_t> cig;
    run_ext(c, qseq + q_off, ql - q_off, tseq + t_off, tlen - t_off,
            (int64_t)((double)c.bw * 1.5), c.zdrop, -1, KSW_EZ_EXTZ_ONLY,
            ez, cig);
    if (cig.empty()) return false;
    ri = NatReg();
    for (int i = 0; i < RF; ++i) ri[i] = 0;
    append_cigar(ri, cig.data(), (int64_t)cig.size());
    ri.dp_score = ez.max;
    ri[R_ID] = -1;
    ri[R_PARENT] = PARENT_UNSET;
    ri[R_INV] = 1;
    ri[R_REV] = r1[R_REV] ? 0 : 1;
    ri[R_RID] = r1[R_RID];
    double div = -1.0;
    memcpy(&ri.f[R_DIVBITS], &div, 8);
    if (ri[R_REV] == 0) {
        ri[R_QS] = r2[R_QE] + q_off;
        ri[R_QE] = ri[R_QS] + ez.max_q + 1;
    } else {
        ri[R_QE] = r2[R_QS] - q_off;
        ri[R_QS] = ri[R_QE] - (ez.max_q + 1);
    }
    ri[R_RS] = r1[R_RE] + t_off;
    ri[R_RE] = ri[R_RS] + ez.max_t + 1;
    update_extra(c, ri, qseq + q_off, tseq + t_off);
    return true;
}

// ---- symmetric DUST masker (sdust.py golden model; reference sdust.c
// sdust_core + the mm_dust_minier minimizer filter, map.c:61-85).
namespace sdust_impl {
constexpr int WLEN = 3, WTOT = 1 << (2 * WLEN), WMSK = WTOT - 1;

struct PerfectIv { int64_t start, finish, r, l; };

struct SdState {
    std::vector<int> w;        // word deque (head..tail)
    int64_t head = 0;          // logical start of w
    std::vector<PerfectIv> P;  // by descending start, ascending finish
    std::vector<std::pair<int64_t, int64_t>> res;
    int64_t L = 0, rw = 0, rv = 0;
    int cw[WTOT] = {0}, cv[WTOT] = {0};
    int64_t wlen() const { return (int64_t)w.size() - head; }
    int wat(int64_t i) const { return w[head + i]; }
};

static void save_masked(SdState& st, int64_t start) {
    if (st.P.empty() || st.P.back().start >= start) return;
    int64_t ps = st.P.back().start, pf = st.P.back().finish;
    if (!st.res.empty() && ps <= st.res.back().second) {
        if (pf > st.res.back().second) st.res.back().second = pf;
    } else {
        st.res.emplace_back(ps, pf);
    }
    int64_t i = (int64_t)st.P.size() - 1;
    while (i >= 0 && st.P[i].start < start) --i;
    st.P.resize(i + 1);
}

static void shift_window(SdState& st, int t, int T, int W) {
    if (st.wlen() >= W - WLEN + 1) {
        int sdrop = st.wat(0);
        ++st.head;
        st.cw[sdrop] -= 1;
        st.rw -= st.cw[sdrop];
        if (st.L > st.wlen()) {
            st.L -= 1;
            st.cv[sdrop] -= 1;
            st.rv -= st.cv[sdrop];
        }
    }
    st.w.push_back(t);
    st.L += 1;
    st.rw += st.cw[t];
    st.cw[t] += 1;
    st.rv += st.cv[t];
    st.cv[t] += 1;
    if (st.cv[t] * 10 > 2 * T) {
        for (;;) {
            int sd = st.wat(st.wlen() - st.L);
            st.cv[sd] -= 1;
            st.rv -= st.cv[sd];
            st.L -= 1;
            if (sd == t) break;
        }
    }
    if (st.head > 4096) {  // compact the deque
        st.w.erase(st.w.begin(), st.w.begin() + st.head);
        st.head = 0;
    }
}

static void find_perfect(SdState& st, int T, int64_t start) {
    int c[WTOT];
    memcpy(c, st.cv, sizeof(c));
    int64_t r = st.rv;
    int64_t max_r = 0, max_l = 0;
    for (int64_t i = st.wlen() - st.L - 1; i >= 0; --i) {
        int t = st.wat(i);
        r += c[t];
        c[t] += 1;
        int64_t new_l = st.wlen() - i - 1;
        if (r * 10 > (int64_t)T * new_l) {
            size_t j = 0;
            while (j < st.P.size() && st.P[j].start >= i + start) {
                const PerfectIv& p = st.P[j];
                if (max_r == 0 || p.r * max_l > max_r * p.l) {
                    max_r = p.r; max_l = p.l;
                }
                ++j;
            }
            if (max_r == 0 || r * max_l >= max_r * new_l) {
                max_r = r; max_l = new_l;
                st.P.insert(st.P.begin() + j,
                            {i + start, st.wlen() + WLEN - 1 + start, r,
                             new_l});
            }
        }
    }
}

static void sdust_core(const uint8_t* b4, int64_t n, int T, int W,
                       std::vector<std::pair<int64_t, int64_t>>& out) {
    SdState st;
    int64_t l = 0;
    int t = 0;
    for (int64_t i = 0; i <= n; ++i) {
        int b = i < n ? b4[i] : 4;
        if (b < 4) {
            ++l;
            t = ((t << 2) | b) & WMSK;
            if (l >= WLEN) {
                int64_t start = (l - W > 0 ? l - W : 0) + (i + 1 - l);
                save_masked(st, start);
                shift_window(st, t, T, W);
                if (st.rw * 10 > st.L * (int64_t)T)
                    find_perfect(st, T, start);
            }
        } else {
            int64_t start = (l - W + 1 > 0 ? l - W + 1 : 0) + (i + 1 - l);
            while (!st.P.empty()) {
                save_masked(st, start);
                ++start;
            }
            l = 0; t = 0;
        }
    }
    out = std::move(st.res);
}

// drop minimizers overlapping low-complexity regions by more than half
// their span (map.c:61-85).  mv shrinks in place; returns the new count.
static int64_t dust_mask_mv(uint64_t* mv, int64_t n_mv, const uint8_t* b4,
                            int64_t qlen, int T) {
    std::vector<std::pair<int64_t, int64_t>> dregs;
    sdust_core(b4, qlen, T, 64, dregs);
    if (dregs.empty()) return n_mv;
    int64_t m = 0;
    for (int64_t i = 0; i < n_mv; ++i) {
        int64_t span = (int64_t)(mv[2 * i] & 0xFF);
        int64_t qpos = (int64_t)((mv[2 * i + 1] & 0xFFFFFFFFull) >> 1);
        int64_t s0 = qpos - (span - 1), e0 = s0 + span;
        int64_t ov = 0;
        for (auto& d : dregs) {
            int64_t lo = s0 > d.first ? s0 : d.first;
            int64_t hi = e0 < d.second ? e0 : d.second;
            if (hi > lo) ov += hi - lo;
        }
        if (ov <= (span >> 1)) {
            mv[2 * m] = mv[2 * i];
            mv[2 * m + 1] = mv[2 * i + 1];
            ++m;
        }
    }
    return m;
}
}  // namespace sdust_impl

// ======================= per-read map unit =========================
// Ports of the hit post-processing golden models (hits.py / esterr.py,
// reference hit.c / esterr.c) so one native call maps a whole read:
// sketch -> collect -> chain -> gen_regs -> chain_post -> est_err ->
// align skeleton -> mapq.

// hash64 without mask (hit.c:40-50)
static inline uint64_t hash64(uint64_t key) {
    key = ~key + (key << 21);
    key ^= key >> 24;
    key = (key + (key << 3)) + (key << 8);
    key ^= key >> 14;
    key = (key + (key << 2)) + (key << 4);
    key ^= key >> 28;
    key = key + (key << 31);
    return key;
}

// ---- mm_gen_regs (hit.c:52-88)
static std::vector<NatReg> gen_regs(const Ctx& c, uint64_t hash_,
                                    const uint64_t* u, int64_t n_u) {
    std::vector<NatReg> regs;
    if (n_u == 0) return regs;
    std::vector<uint64_t> zx(n_u), zy(n_u);
    int64_t k = 0;
    for (int64_t i = 0; i < n_u; ++i) {
        uint64_t h = (hash64((hash64(AX(c, k)) + hash64(AY(c, k)))
                             ^ hash_)) & 0xFFFFFFFFull;
        zx[i] = u[i] ^ h;
        zy[i] = ((uint64_t)k << 32) | (u[i] & 0xFFFFFFFFull);
        k += (int64_t)(u[i] & 0xFFFFFFFFull);
    }
    // stable argsort ascending then reversed == sort by (zx desc, idx desc)
    std::vector<int64_t> order(n_u);
    for (int64_t i = 0; i < n_u; ++i) order[i] = i;
    std::sort(order.begin(), order.end(), [&](int64_t a1, int64_t b1) {
        if (zx[a1] != zx[b1]) return zx[a1] > zx[b1];
        return a1 > b1;
    });
    regs.resize(n_u);
    for (int64_t i = 0; i < n_u; ++i) {
        int64_t j = order[i];
        NatReg& r = regs[i];
        for (int jj = 0; jj < RF; ++jj) r[jj] = 0;
        r[R_ID] = i;
        r[R_PARENT] = PARENT_UNSET;
        r[R_SCORE] = r[R_SCORE0] = (int64_t)(zx[j] >> 32);
        r[R_HASH] = (int64_t)(zx[j] & 0xFFFFFFFFull);
        r[R_CNT] = (int64_t)(zy[j] & 0xFFFFFFFFull);
        r[R_AS] = (int64_t)(zy[j] >> 32);
        double div = -1.0;
        memcpy(&r.f[R_DIVBITS], &div, 8);
        reg_set_coor(c, r);
    }
    return regs;
}

// ---- mm_set_parent (hit.c:109-165)
static void set_parent(std::vector<NatReg>& regs, double mask_level,
                       int64_t sub_diff) {
    int64_t n = (int64_t)regs.size();
    if (n <= 0) return;
    for (int64_t i = 0; i < n; ++i) regs[i][R_ID] = i;
    std::vector<int64_t> w;
    w.push_back(0);
    regs[0][R_PARENT] = 0;
    for (int64_t i = 1; i < n; ++i) {
        NatReg& ri = regs[i];
        int64_t si = ri[R_QS], ei = ri[R_QE];
        std::vector<uint64_t> cov;
        for (int64_t wj : w) {
            const NatReg& rp = regs[wj];
            int64_t sj = rp[R_QS], ej = rp[R_QE];
            if (ej <= si || sj >= ei) continue;
            int64_t s_ = sj > si ? sj : si, e_ = ej < ei ? ej : ei;
            cov.push_back(((uint64_t)s_ << 32) | (uint64_t)e_);
        }
        int64_t uncov_len = 0;
        bool placed = false;
        if (!cov.empty()) {
            std::sort(cov.begin(), cov.end());
            int64_t x = si;
            for (uint64_t cc : cov) {
                int64_t s_ = (int64_t)(cc >> 32), e_ = (int64_t)(cc & 0xFFFFFFFFull);
                if (s_ > x) uncov_len += s_ - x;
                if (e_ > x) x = e_;
            }
            if (ei > x) uncov_len += ei - x;
            for (int64_t wj : w) {
                NatReg& rp = regs[wj];
                int64_t sj = rp[R_QS], ej = rp[R_QE];
                if (ej <= si || sj >= ei) continue;
                int64_t min_l = (ej - sj) < (ei - si) ? ej - sj : ei - si;
                int64_t max_l = (ej - sj) > (ei - si) ? ej - sj : ei - si;
                int64_t ol;
                if (si < sj) ol = ei < sj ? 0 : (ei < ej ? ei - sj : ej - sj);
                else ol = ej < si ? 0 : (ej < ei ? ej - si : ei - si);
                // f32 divisions/subtract vs the C float (hit.c:147)
                if ((float)ol / min_l - (float)uncov_len / max_l
                    > (float)mask_level) {
                    int cnt_sub = 0;
                    ri[R_PARENT] = rp[R_PARENT];
                    if (ri[R_SCORE] > rp[R_SUBSC]) rp[R_SUBSC] = ri[R_SCORE];
                    if (ri[R_CNT] >= rp[R_CNT]) cnt_sub = 1;
                    if (rp[R_HASP] && ri[R_HASP]
                        && (rp[R_RID] != ri[R_RID] || rp[R_RS] != ri[R_RS]
                            || rp[R_RE] != ri[R_RE] || ol != min_l)) {
                        if (ri.dp_max > rp.dp_max2) rp.dp_max2 = ri.dp_max;
                        if (rp.dp_max - ri.dp_max <= sub_diff) cnt_sub = 1;
                    }
                    if (cnt_sub) rp[R_NSUB] += 1;
                    placed = true;
                    break;
                }
            }
        }
        if (!placed) {
            w.push_back(i);
            ri[R_PARENT] = i;
            ri[R_NSUB] = 0;
        }
    }
}

static int64_t set_sam_pri(std::vector<NatReg>& regs) {
    int64_t n_pri = 0;
    for (auto& r : regs) {
        if (r[R_ID] == r[R_PARENT]) {
            ++n_pri;
            r[R_SAMPRI] = n_pri == 1 ? 1 : 0;
        } else {
            r[R_SAMPRI] = 0;
        }
    }
    return n_pri;
}

// ---- mm_sync_regs (hit.c:206-228)
static void sync_regs(std::vector<NatReg>& regs) {
    if (regs.empty()) return;
    int64_t max_id = -1;
    for (auto& r : regs) if (r[R_ID] > max_id) max_id = r[R_ID];
    std::vector<int64_t> tmp(max_id + 1, -1);
    for (size_t i = 0; i < regs.size(); ++i)
        if (regs[i][R_ID] >= 0) tmp[regs[i][R_ID]] = (int64_t)i;
    for (size_t i = 0; i < regs.size(); ++i) {
        NatReg& r = regs[i];
        int64_t p = r[R_PARENT];
        r[R_ID] = (int64_t)i;
        if (p == PARENT_TMP_PRI) r[R_PARENT] = (int64_t)i;
        else if (p >= 0 && tmp[p] >= 0) r[R_PARENT] = tmp[p];
        else r[R_PARENT] = PARENT_UNSET;
    }
    set_sam_pri(regs);
}

// ---- mm_select_sub (hit.c:230-247)
static void select_sub(std::vector<NatReg>& regs, double pri_ratio,
                       int64_t min_diff, int64_t best_n) {
    if (pri_ratio <= 0.0 || regs.empty()) return;
    // the reference compacts IN PLACE (r[k++] = r[i], hit.c:234-240) and
    // reads r[p] from the same array, so after any drop slot p may hold an
    // already-compacted later region; the ratio test is a float32
    // multiply-compare (pri_ratio is a C float)
    float ratio = (float)pri_ratio;
    size_t n = regs.size(), k = 0;
    int64_t n_2nd = 0;
    for (size_t i = 0; i < n; ++i) {
        const NatReg& r = regs[i];
        int64_t p = r[R_PARENT];
        const NatReg& pr = regs[p];
        bool keep = false;
        if (p == (int64_t)i || r[R_INV]) {
            keep = true;
        } else if (((float)r[R_SCORE] >= (float)pr[R_SCORE] * ratio
                    || r[R_SCORE] + min_diff >= pr[R_SCORE])
                   && n_2nd < best_n) {
            if (!(r[R_QS] == pr[R_QS] && r[R_QE] == pr[R_QE]
                  && r[R_RID] == pr[R_RID] && r[R_RS] == pr[R_RS]
                  && r[R_RE] == pr[R_RE])) {
                keep = true;
                ++n_2nd;
            }
        }
        if (keep) {
            if (k != i) regs[k] = std::move(regs[i]);
            ++k;
        }
    }
    bool changed = k != n;
    regs.resize(k);
    if (changed) sync_regs(regs);
}

// ---- mm_filter_regs (hit.c:249-268)
static void filter_regs_nat(std::vector<NatReg>& regs, int64_t min_cnt,
                            int64_t min_chain_score, int64_t min_dp_max,
                            double max_clip_ratio, int64_t qlen) {
    std::vector<NatReg> out;
    for (auto& r : regs) {
        bool flt = false;
        if (!r[R_INV] && !r[R_SEGSPLIT] && r[R_CNT] < min_cnt) flt = true;
        if (r[R_HASP]) {
            if (r[R_MLEN] < min_chain_score) flt = true;
            else if (r.dp_max < min_dp_max) flt = true;
            else {
                // f32 product-compare: max_clip_ratio is a C float
                float clip = (float)qlen * (float)max_clip_ratio;
                if ((float)r[R_QS] > clip
                    && (float)(qlen - r[R_QE]) > clip)
                    flt = true;
            }
        }
        if (!flt) out.push_back(std::move(r));
    }
    regs = std::move(out);
}

// ---- squeeze_a (hit.c:270-288)
static int64_t squeeze_a_nat(const Ctx& c, std::vector<NatReg>& regs) {
    std::vector<int64_t> aux(regs.size());
    for (size_t i = 0; i < regs.size(); ++i) aux[i] = (int64_t)i;
    std::sort(aux.begin(), aux.end(), [&](int64_t a1, int64_t b1) {
        if (regs[a1][R_AS] != regs[b1][R_AS])
            return regs[a1][R_AS] < regs[b1][R_AS];
        return a1 < b1;
    });
    int64_t as_ = 0;
    for (int64_t i : aux) {
        NatReg& r = regs[i];
        if (r[R_AS] != as_) {
            memmove(c.A + 2 * as_, c.A + 2 * r[R_AS], r[R_CNT] * 16);
            r[R_AS] = as_;
        }
        as_ += r[R_CNT];
    }
    return as_;
}

// ---- mm_join_long (hit.c:290-345)
static void join_long(Ctx& c, std::vector<NatReg>& regs, int64_t max_join_long,
                      int64_t max_join_short, int64_t min_join_flank_sc,
                      int64_t min_cnt, int64_t min_chain_score,
                      int64_t min_dp_max, double max_clip_ratio) {
    if (regs.size() < 2) return;
    squeeze_a_nat(c, regs);
    std::vector<int64_t> aux;
    for (size_t i = 0; i < regs.size(); ++i)
        if (regs[i][R_PARENT] == (int64_t)i || regs[i][R_PARENT] < 0)
            aux.push_back((int64_t)i);
    std::sort(aux.begin(), aux.end(), [&](int64_t a1, int64_t b1) {
        if (regs[a1][R_AS] != regs[b1][R_AS])
            return regs[a1][R_AS] < regs[b1][R_AS];
        return a1 < b1;
    });
    int64_t n_drop = 0;
    for (int64_t ii = (int64_t)aux.size() - 1; ii > 0; --ii) {
        NatReg& r0 = regs[aux[ii - 1]];
        NatReg& r1 = regs[aux[ii]];
        if (r0[R_AS] + r0[R_CNT] != r1[R_AS]) continue;
        if (r0[R_RID] != r1[R_RID] || r0[R_REV] != r1[R_REV]) continue;
        uint64_t a0ex = AX(c, r0[R_AS] + r0[R_CNT] - 1);
        uint64_t a0ey = AY(c, r0[R_AS] + r0[R_CNT] - 1);
        uint64_t a1sx = AX(c, r1[R_AS]);
        uint64_t a1sy = AY(c, r1[R_AS]);
        if (a1sx <= a0ex || (int64_t)lo32(a1sy) <= (int64_t)lo32(a0ey))
            continue;
        int64_t gq = (int64_t)lo32(a1sy) - lo32(a0ey);
        int64_t gr = (int64_t)(a1sx - a0ex);
        int64_t max_gap = gq > gr ? gq : gr, min_gap = gq < gr ? gq : gr;
        if (max_gap > max_join_long || min_gap > max_join_short) continue;
        // f32 div and mul + the double .499 literal (hit.c:319)
        int64_t sc_thres = (int64_t)((double)((float)min_join_flank_sc
                                     / max_join_long * max_gap) + .499);
        if (r0[R_SCORE] < sc_thres || r1[R_SCORE] < sc_thres) continue;
        if (r0[R_RE] - r0[R_RS] < (max_gap >> 1)
            || r0[R_QE] - r0[R_QS] < (max_gap >> 1)) continue;
        if (r1[R_RE] - r1[R_RS] < (max_gap >> 1)
            || r1[R_QE] - r1[R_QS] < (max_gap >> 1)) continue;
        c.A[2 * r1[R_AS] + 1] |= SEED_LONG_JOIN;
        r0[R_CNT] += r1[R_CNT];
        r0[R_SCORE] += r1[R_SCORE];
        reg_set_coor(c, r0);
        r1[R_CNT] = 0;
        r1[R_PARENT] = r0[R_ID];
        ++n_drop;
    }
    if (n_drop > 0) {
        for (auto& r : regs) {
            // regs[parent] directly: ids equal indices here (hit.c:338)
            if (r[R_PARENT] >= 0 && r[R_ID] != r[R_PARENT]) {
                const NatReg& pr = regs[r[R_PARENT]];
                if (pr[R_PARENT] >= 0 && pr[R_PARENT] != r[R_PARENT])
                    r[R_PARENT] = pr[R_PARENT];
            }
        }
        filter_regs_nat(regs, min_cnt, min_chain_score, min_dp_max,
                        max_clip_ratio, c.qlen);
        sync_regs(regs);
    }
}

// ---- hit_sort_by_dp (hit.c:167-193)
static void hit_sort_by_dp(std::vector<NatReg>& regs) {
    if (regs.size() <= 1) return;
    std::vector<int64_t> keep;
    for (size_t i = 0; i < regs.size(); ++i)
        if (regs[i][R_INV] || regs[i][R_CNT] > 0) keep.push_back((int64_t)i);
    std::sort(keep.begin(), keep.end(), [&](int64_t a1, int64_t b1) {
        uint64_t ka = ((uint64_t)regs[a1].dp_max << 32)
                      | (uint64_t)regs[a1][R_HASH];
        uint64_t kb = ((uint64_t)regs[b1].dp_max << 32)
                      | (uint64_t)regs[b1][R_HASH];
        if (ka != kb) return ka > kb;
        return a1 > b1;
    });
    std::vector<NatReg> out;
    out.reserve(keep.size());
    for (int64_t i : keep) out.push_back(std::move(regs[i]));
    regs = std::move(out);
}

// ---- mm_est_err (esterr.c:16-64)
static void est_err_nat(Ctx& c, std::vector<NatReg>& regs,
                        const uint64_t* mini_pos, int64_t n_mini) {
    if (n_mini == 0) return;
    int64_t sum_k = 0;
    for (int64_t i = 0; i < n_mini; ++i)
        sum_k += (int64_t)((mini_pos[i] >> 32) & 0xFF);
    float avg_k = (float)((double)sum_k / n_mini);
    std::vector<int64_t> mp_lo(n_mini);
    for (int64_t i = 0; i < n_mini; ++i)
        mp_lo[i] = (int64_t)(mini_pos[i] & 0xFFFFFFFFull);
    auto qpos_of = [&](uint64_t ax, uint64_t ay) {
        int64_t x = lo32(ay);
        int64_t q_span = span_of(ay);
        if (ax >> 63) x = c.qlen - 1 - (x + 1 - q_span);
        return x;
    };
    for (auto& r : regs) {
        double div = -1.0;
        memcpy(&r.f[R_DIVBITS], &div, 8);
        if (r[R_CNT] == 0) continue;
        int64_t l_ref = c.seq_len[r[R_RID]];
        int64_t k0 = r[R_REV] ? r[R_AS] + r[R_CNT] - 1 : r[R_AS];
        int64_t x = qpos_of(AX(c, k0), AY(c, k0));
        int64_t st = (int64_t)(std::lower_bound(mp_lo.begin(), mp_lo.end(), x)
                               - mp_lo.begin());
        if (st >= n_mini || mp_lo[st] != x) continue;
        int64_t en = st, n_match = 1, k = 1;
        for (int64_t j = st + 1; j < n_mini && k < r[R_CNT]; ++j) {
            int64_t ki = r[R_REV] ? r[R_AS] + r[R_CNT] - 1 - k : r[R_AS] + k;
            int64_t xx = qpos_of(AX(c, ki), AY(c, ki));
            if (xx == mp_lo[j]) { ++k; en = j; ++n_match; }
        }
        int64_t n_tot = en - st + 1;
        if ((double)r[R_QS] > avg_k && (double)r[R_RS] > avg_k) ++n_tot;
        if ((double)(c.qlen - r[R_QS]) > avg_k
            && (double)(l_ref - r[R_RE]) > avg_k) ++n_tot;
        div = (double)(float)(logf((float)n_tot / (float)n_match) / avg_k);
        memcpy(&r.f[R_DIVBITS], &div, 8);
    }
}

// ---- mm_set_mapq (hit.c:437-481) incl. inversion mapq (hit.c:411-435)
static void set_mapq_nat(std::vector<NatReg>& regs, int64_t min_chain_sc,
                         int64_t match_sc, int64_t rep_len, bool is_sr) {
    // the whole chain is float32 in the reference (hit.c:437-481: every
    // operand is a C float, so each intermediate rounds to f32)
    const float q_coef = 40.0f;
    int64_t sum_sc = 0;
    for (auto& r : regs)
        if (r[R_PARENT] == r[R_ID]) sum_sc += r[R_SCORE];
    float uniq_ratio = (sum_sc + rep_len)
        ? (float)sum_sc / (sum_sc + rep_len) : 0.0f;
    for (size_t i = 0; i < regs.size(); ++i) {
        NatReg& r = regs[i];
        if (r[R_INV]) { r[R_MAPQ] = 0; continue; }
        if (r[R_PARENT] != r[R_ID]) { r[R_MAPQ] = 0; continue; }
        float pen_s1 = (r[R_SCORE] > 100 ? 1.0f : 0.01f * r[R_SCORE])
            * uniq_ratio;
        float pen_cm = r[R_CNT] > 10 ? 1.0f : 0.1f * r[R_CNT];
        if (pen_s1 < pen_cm) pen_cm = pen_s1;
        int64_t subsc = r[R_SUBSC] > min_chain_sc ? r[R_SUBSC] : min_chain_sc;
        int64_t mapq;
        if (r[R_HASP] && r.dp_max2 > 0 && r.dp_max > 0) {
            float identity = (float)r[R_MLEN] / r[R_BLEN];
            float x = (float)r.dp_max2 * subsc / r.dp_max / r[R_SCORE0];
            mapq = (int64_t)(int)(identity * pen_cm * q_coef
                                  * (1.0f - x * x)
                                  * logf((float)r.dp_max / match_sc));
            if (!is_sr) {
                int64_t mapq_alt = (int64_t)(int)(
                    6.02f * identity * identity * (r.dp_max - r.dp_max2)
                    / match_sc + .499f);
                if (mapq_alt < mapq) mapq = mapq_alt;
            }
        } else {
            float x = r[R_SCORE0]
                ? (float)subsc / r[R_SCORE0] : 0.0f;
            if (r[R_HASP]) {
                float identity = (float)r[R_MLEN] / r[R_BLEN];
                mapq = (int64_t)(int)(identity * pen_cm * q_coef
                                      * (1.0f - x)
                                      * logf((float)r.dp_max / match_sc));
            } else {
                mapq = (int64_t)(int)(pen_cm * q_coef * (1.0f - x)
                                      * logf((float)r[R_SCORE]));
            }
        }
        mapq -= (int64_t)(int)(4.343f * logf((float)(r[R_NSUB] + 1))
                               + .499f);
        if (mapq < 0) mapq = 0;
        r[R_MAPQ] = mapq < 60 ? mapq : 60;
        if (r[R_HASP] && r.dp_max > r.dp_max2 && r[R_MAPQ] == 0)
            r[R_MAPQ] = 1;
    }
    // inversion hits inherit min flanking mapq
    bool any_inv = false;
    for (auto& r : regs) if (r[R_INV]) { any_inv = true; break; }
    if (regs.size() >= 3 && any_inv) {
        std::vector<int64_t> aux;
        for (size_t i = 0; i < regs.size(); ++i)
            if (regs[i][R_PARENT] == (int64_t)i || regs[i][R_PARENT] < 0)
                aux.push_back((int64_t)i);
        std::sort(aux.begin(), aux.end(), [&](int64_t a1, int64_t b1) {
            if (regs[a1][R_AS] != regs[b1][R_AS])
                return regs[a1][R_AS] < regs[b1][R_AS];
            return a1 < b1;
        });
        for (size_t ii = 1; ii + 1 < aux.size(); ++ii) {
            NatReg& inv = regs[aux[ii]];
            if (inv[R_INV]) {
                int64_t m0 = regs[aux[ii - 1]][R_MAPQ];
                int64_t m1 = regs[aux[ii + 1]][R_MAPQ];
                inv[R_MAPQ] = m0 < m1 ? m0 : m1;
            }
        }
    }
}

// ---- SAM/PAF text emission (io/output.py, reference format.c) for the
// single-segment fast path.
struct TextOut {
    char* buf;
    int64_t cap, pos = 0;
    bool of = false;
    inline void ch(char c) {
        if (pos >= cap) { of = true; return; }
        buf[pos++] = c;
    }
    inline void mem(const char* s, int64_t n) {
        if (pos + n > cap) { of = true; return; }
        memcpy(buf + pos, s, n); pos += n;
    }
    inline void cstr(const char* s) { mem(s, (int64_t)strlen(s)); }
    inline void num(int64_t v) {
        char t[24]; int n = 0;
        if (v < 0) { ch('-'); v = -v; }
        do { t[n++] = (char)('0' + v % 10); v /= 10; } while (v);
        while (n) ch(t[--n]);
    }
};

static const char NT_UPPER[] = "ACGTN";
static const char NT_LOWER[] = "acgtn";

static const char* comp_table() {
    // C++11 magic static: thread-safe one-time init (the kt_for-style
    // worker pool calls the driver from several threads concurrently)
    struct Tbl {
        char t[256];
        Tbl() {
            const char* A = "ACGTURYSWKMBDHVN";
            const char* B = "TGCAAYRSWMKVHDBN";
            for (int i = 0; i < 256; ++i) t[i] = (char)i;
            for (int i = 0; A[i]; ++i) {
                t[(uint8_t)A[i]] = B[i];
                t[(uint8_t)tolower(A[i])] = (char)tolower(B[i]);
            }
        }
    };
    static const Tbl tbl;
    return tbl.t;
}

struct EmitCtx {
    const Ctx* c;
    const char* qname; int64_t qname_len;
    const char* seq;              // ASCII query, qlen
    const char* qual;             // or nullptr
    const char* comment; int64_t comment_len;
    const char* rg_id; int64_t rg_len;
    const char* rnames; const int64_t* rname_off;
    const uint8_t* qa;            // nt4 fwd query
};

static void emit_tags(TextOut& o, const EmitCtx& e, const NatReg& r) {
    char type_;
    if (r[R_ID] == r[R_PARENT]) type_ = r[R_INV] ? 'I' : 'P';
    else type_ = r[R_INV] ? 'i' : 'S';
    if (r[R_HASP]) {
        o.cstr("\tNM:i:"); o.num(r[R_BLEN] - r[R_MLEN] + r.n_ambi);
        o.cstr("\tms:i:"); o.num(r.dp_max);
        o.cstr("\tAS:i:"); o.num(r.dp_score);
        o.cstr("\tnn:i:"); o.num(r.n_ambi);
        if (r.trans_strand == 1 || r.trans_strand == 2) {
            o.cstr("\tts:A:");
            o.ch("?+-?"[r.trans_strand]);
        }
    }
    o.cstr("\ttp:A:"); o.ch(type_);
    o.cstr("\tcm:i:"); o.num(r[R_CNT]);
    o.cstr("\ts1:i:"); o.num(r[R_SCORE]);
    if (r[R_PARENT] == r[R_ID]) { o.cstr("\ts2:i:"); o.num(r[R_SUBSC]); }
    double div;
    memcpy(&div, &r.f[R_DIVBITS], 8);
    if (div >= 0.0 && div <= 1.0) {
        if (div == 0.0) o.cstr("\tdv:f:0");
        else {
            char t[32];
            snprintf(t, sizeof(t), "\tdv:f:%.4f", div);
            o.cstr(t);
        }
    }
    if (r[R_SPLIT]) { o.cstr("\tzd:i:"); o.num(r[R_SPLIT]); }
}

static void emit_cigar_ops(TextOut& o, const std::vector<uint32_t>& cig) {
    for (uint32_t cw : cig) {
        o.num(cw >> 4);
        o.ch("MIDNSH"[cw & 0xF]);
    }
}

// region-oriented query/target for cs/MD (io/output.py:_get_align_seqs)
static void align_seqs(const EmitCtx& e, const NatReg& r,
                       std::vector<uint8_t>& q, const uint8_t*& t,
                       int64_t& tlen) {
    const Ctx& c = *e.c;
    t = getseq(c, r[R_RID], r[R_RS], r[R_RE], tlen);
    int64_t n = r[R_QE] - r[R_QS];
    q.resize(n);
    if (!r[R_REV]) {
        memcpy(q.data(), e.qa + r[R_QS], n);
    } else {
        for (int64_t i = 0; i < n; ++i) {
            uint8_t b = e.qa[r[R_QE] - 1 - i];
            q[i] = b >= 4 ? 4 : (uint8_t)(3 - b);
        }
    }
}

static void emit_cs(TextOut& o, const EmitCtx& e, const NatReg& r,
                    bool long_form) {
    std::vector<uint8_t> q;
    const uint8_t* t; int64_t tl;
    align_seqs(e, r, q, t, tl);
    o.cstr("\tcs:Z:");
    int64_t qo = 0, to = 0;
    for (uint32_t cw : r.cigar) {
        int op = cw & 0xF;
        int64_t len = cw >> 4;
        if (op == 0) {
            int64_t l_tmp = 0, run_st = 0;
            for (int64_t j = 0; j < len; ++j) {
                if (q[qo + j] != t[to + j]) {
                    if (l_tmp > 0) {
                        if (long_form) {
                            o.ch('=');
                            for (int64_t m = run_st; m < j; ++m)
                                o.ch(NT_UPPER[q[qo + m]]);
                        } else { o.ch(':'); o.num(l_tmp); }
                        l_tmp = 0;
                    }
                    o.ch('*');
                    o.ch(NT_LOWER[t[to + j]]);
                    o.ch(NT_LOWER[q[qo + j]]);
                    run_st = j + 1;
                } else {
                    if (l_tmp == 0) run_st = j;
                    ++l_tmp;
                }
            }
            if (l_tmp > 0) {
                if (long_form) {
                    o.ch('=');
                    for (int64_t m = run_st; m < len; ++m)
                        o.ch(NT_UPPER[q[qo + m]]);
                } else { o.ch(':'); o.num(l_tmp); }
            }
            qo += len; to += len;
        } else if (op == 1) {
            o.ch('+');
            for (int64_t j = 0; j < len; ++j) o.ch(NT_LOWER[q[qo + j]]);
            qo += len;
        } else if (op == 2) {
            o.ch('-');
            for (int64_t j = 0; j < len; ++j) o.ch(NT_LOWER[t[to + j]]);
            to += len;
        } else {
            o.ch('~');
            o.ch(NT_LOWER[t[to]]); o.ch(NT_LOWER[t[to + 1]]);
            o.num(len);
            o.ch(NT_LOWER[t[to + len - 2]]); o.ch(NT_LOWER[t[to + len - 1]]);
            to += len;
        }
    }
}

static void emit_md(TextOut& o, const EmitCtx& e, const NatReg& r) {
    std::vector<uint8_t> q;
    const uint8_t* t; int64_t tl;
    align_seqs(e, r, q, t, tl);
    o.cstr("\tMD:Z:");
    int64_t l_md = 0, qo = 0, to = 0;
    for (uint32_t cw : r.cigar) {
        int op = cw & 0xF;
        int64_t len = cw >> 4;
        if (op == 0) {
            for (int64_t j = 0; j < len; ++j) {
                if (q[qo + j] != t[to + j]) {
                    o.num(l_md);
                    o.ch(NT_UPPER[t[to + j]]);
                    l_md = 0;
                } else ++l_md;
            }
            qo += len; to += len;
        } else if (op == 1) {
            qo += len;
        } else if (op == 2) {
            o.num(l_md);
            o.ch('^');
            for (int64_t j = 0; j < len; ++j) o.ch(NT_UPPER[t[to + j]]);
            l_md = 0;
            to += len;
        } else if (op == 3) {
            // intron: MD has no N concept — advance past the reference
            // span without emitting (a stale `to` corrupted every later
            // MD run on spliced alignments; io/output.py:_write_md same)
            to += len;
        }
    }
    if (l_md > 0) o.num(l_md);
}

static void emit_seq_oriented(TextOut& o, const EmitCtx& e, const char* s,
                              int64_t n, bool rev, bool comp) {
    if (!rev) { o.mem(s, n); return; }
    const char* tbl = comp_table();
    if (o.pos + n > o.cap) { o.of = true; return; }
    if (comp)
        for (int64_t i = 0; i < n; ++i) o.buf[o.pos + i] = tbl[(uint8_t)s[n - 1 - i]];
    else
        for (int64_t i = 0; i < n; ++i) o.buf[o.pos + i] = s[n - 1 - i];
    o.pos += n;
}

static void emit_rname(TextOut& o, const EmitCtx& e, int64_t rid) {
    o.mem(e.rnames + e.rname_off[rid],
          e.rname_off[rid + 1] - e.rname_off[rid]);
}

// one PAF row (io/output.py:write_paf)
static void emit_paf(TextOut& o, const EmitCtx& e, const NatReg& r,
                     int64_t flag) {
    const Ctx& c = *e.c;
    o.mem(e.qname, e.qname_len); o.ch('\t');
    o.num(c.qlen); o.ch('\t');
    o.num(r[R_QS]); o.ch('\t');
    o.num(r[R_QE]); o.ch('\t');
    o.ch("+-"[r[R_REV]]); o.ch('\t');
    emit_rname(o, e, r[R_RID]); o.ch('\t');
    o.num(c.seq_len[r[R_RID]]); o.ch('\t');
    o.num(r[R_RS]); o.ch('\t');
    o.num(r[R_RE]); o.ch('\t');
    o.num(r[R_MLEN]); o.ch('\t');
    o.num(r[R_BLEN]); o.ch('\t');
    o.num(r[R_MAPQ]);
    emit_tags(o, e, r);
    constexpr int64_t F_OUT_CG = 0x020, F_OUT_CS = 0x040, F_OUT_MD = 0x1000000,
        F_OUT_CS_LONG = 0x800, F_COPY_COMMENT = 0x2000000;
    if (r[R_HASP] && (flag & F_OUT_CG)) {
        o.cstr("\tcg:Z:");
        emit_cigar_ops(o, r.cigar);
    }
    if (r[R_HASP] && (flag & (F_OUT_CS | F_OUT_MD))) {
        if (flag & F_OUT_MD) emit_md(o, e, r);
        else emit_cs(o, e, r, flag & F_OUT_CS_LONG);
    }
    if ((flag & F_COPY_COMMENT) && e.comment_len) {
        o.ch('\t');
        o.mem(e.comment, e.comment_len);
    }
}

// one SAM record (io/output.py:write_sam).  n_seg == 1 has no mate
// fields; n_seg == 2 adds the pair flags, RNEXT/PNEXT/TLEN from the
// other segment's first sam_pri region (r_next; r_prev == r_next).
static void emit_sam_rec(TextOut& o, const EmitCtx& e,
                         const std::vector<NatReg>& regs, int64_t reg_idx,
                         const NatReg* r_next, int seg_idx, int n_seg,
                         int64_t oflag) {
    const Ctx& c = *e.c;
    constexpr int64_t F_SOFTCLIP = 0x80000, F_LONG_CIGAR = 0x10000,
        F_OUT_CS = 0x040, F_OUT_MD = 0x1000000, F_OUT_CS_LONG = 0x800,
        F_COPY_COMMENT = 0x2000000;
    const NatReg* r = (reg_idx >= 0 && reg_idx < (int64_t)regs.size())
        ? &regs[reg_idx] : nullptr;
    const NatReg* r_prev = r_next;
    int64_t qlen = c.qlen;
    o.mem(e.qname, e.qname_len);
    int64_t flag = n_seg > 1 ? 0x1 : 0x0;
    if (!r) flag |= 0x4;
    else {
        if ((*r)[R_REV]) flag |= 0x10;
        if ((*r)[R_PARENT] != (*r)[R_ID]) flag |= 0x100;
        else if (!(*r)[R_SAMPRI]) flag |= 0x800;
    }
    if (n_seg > 1) {
        if (r && (*r)[R_PROPER]) flag |= 0x2;
        if (seg_idx == 0) flag |= 0x40;
        else if (seg_idx == n_seg - 1) flag |= 0x80;
        if (!r_next) flag |= 0x8;
        else if ((*r_next)[R_REV]) flag |= 0x20;
    }
    o.ch('\t'); o.num(flag);
    bool cigar_in_tag = false;
    int64_t this_rid = -1, this_pos = -1, this_rev = 0;
    if (!r) {
        if (n_seg > 1 && r_prev) {
            this_rid = (*r_prev)[R_RID];
            this_pos = (*r_prev)[R_RS];
            o.ch('\t');
            emit_rname(o, e, this_rid);
            o.ch('\t'); o.num(this_pos + 1);
            o.cstr("\t0\t*");
        } else {
            o.cstr("\t*\t0\t0\t*");
        }
    } else {
        this_rid = (*r)[R_RID]; this_pos = (*r)[R_RS];
        this_rev = (*r)[R_REV];
        o.ch('\t');
        emit_rname(o, e, this_rid);
        o.ch('\t'); o.num(this_pos + 1);
        o.ch('\t'); o.num((*r)[R_MAPQ]);
        o.ch('\t');
        constexpr int64_t MAX_BAM_OPS = 65535;
        if ((oflag & F_LONG_CIGAR) && (*r)[R_HASP]
            && (int64_t)r->cigar.size() > MAX_BAM_OPS - 2) {
            int64_t nc = (int64_t)r->cigar.size();
            if ((*r)[R_QS] != 0) ++nc;
            if ((*r)[R_QE] != qlen) ++nc;
            if (nc > MAX_BAM_OPS) cigar_in_tag = true;
        }
        if (cigar_in_tag) {
            if (flag & 0x100) o.cstr("0S");
            else if (flag & 0x800) { o.num((*r)[R_RE] - (*r)[R_RS]); o.ch('S'); }
            else { o.num(qlen); o.ch('S'); }
        } else if (!(*r)[R_HASP]) {
            o.ch('*');
        } else {
            int64_t clip0 = (*r)[R_REV] ? qlen - (*r)[R_QE] : (*r)[R_QS];
            int64_t clip1 = (*r)[R_REV] ? (*r)[R_QS] : qlen - (*r)[R_QE];
            char cc = ((flag & 0x800) && !(oflag & F_SOFTCLIP)) ? 'H' : 'S';
            if (clip0) { o.num(clip0); o.ch(cc); }
            emit_cigar_ops(o, r->cigar);
            if (clip1) { o.num(clip1); o.ch(cc); }
        }
    }
    if (n_seg > 1) {  // mate fields + TLEN (format.c:381-418)
        int64_t tlen = 0;
        if (this_rid >= 0 && r_next) {
            if (this_rid == (*r_next)[R_RID]) {
                int64_t this_pos5 = (r && (*r)[R_REV]) ? (*r)[R_RE] - 1
                                                       : this_pos;
                int64_t next_pos5 = (*r_next)[R_REV] ? (*r_next)[R_RE] - 1
                                                     : (*r_next)[R_RS];
                tlen = next_pos5 - this_pos5;
                o.cstr("\t=\t");
            } else {
                o.ch('\t');
                emit_rname(o, e, (*r_next)[R_RID]);
                o.ch('\t');
            }
            o.num((*r_next)[R_RS] + 1); o.ch('\t');
        } else if (r_next) {
            o.ch('\t');
            emit_rname(o, e, (*r_next)[R_RID]);
            o.ch('\t'); o.num((*r_next)[R_RS] + 1); o.ch('\t');
        } else if (this_rid >= 0) {
            int64_t this_pos5 = this_rev ? (*r)[R_RE] - 1 : this_pos;
            tlen = this_pos - this_pos5;
            o.cstr("\t=\t"); o.num(this_pos + 1); o.ch('\t');
        } else {
            o.cstr("\t*\t0\t");
        }
        if (tlen > 0) ++tlen; else if (tlen < 0) --tlen;
        o.num(tlen); o.ch('\t');
    } else {
        o.cstr("\t*\t0\t0\t");
    }
    if (!r) {
        o.mem(e.seq, qlen);
        o.ch('\t');
        if (e.qual) o.mem(e.qual, qlen); else o.ch('*');
    } else {
        bool rev = (*r)[R_REV];
        if ((flag & 0x900) == 0 || (oflag & F_SOFTCLIP)) {
            emit_seq_oriented(o, e, e.seq, qlen, rev, true);
            o.ch('\t');
            if (e.qual) emit_seq_oriented(o, e, e.qual, qlen, rev, false);
            else o.ch('*');
        } else if (flag & 0x100) {
            o.cstr("*\t*");
        } else {
            int64_t qs = (*r)[R_QS], n = (*r)[R_QE] - qs;
            emit_seq_oriented(o, e, e.seq + qs, n, rev, true);
            o.ch('\t');
            if (e.qual) emit_seq_oriented(o, e, e.qual + qs, n, rev, false);
            else o.ch('*');
        }
    }
    if (e.rg_len) { o.cstr("\tRG:Z:"); o.mem(e.rg_id, e.rg_len); }
    if (r) {
        emit_tags(o, e, *r);
        if ((*r)[R_PARENT] == (*r)[R_ID] && (*r)[R_HASP]
            && regs.size() > 1) {
            int64_t sa_start = o.pos;
            bool any = false;
            o.cstr("\tSA:Z:");
            for (size_t qi = 0; qi < regs.size(); ++qi) {
                const NatReg& q = regs[qi];
                if (&q == r || q[R_PARENT] != q[R_ID] || !q[R_HASP])
                    continue;
                any = true;
                int64_t l_m, l_i, l_d;
                if (q[R_QE] - q[R_QS] < q[R_RE] - q[R_RS]) {
                    l_m = q[R_QE] - q[R_QS];
                    l_i = 0; l_d = (q[R_RE] - q[R_RS]) - l_m;
                } else {
                    l_m = q[R_RE] - q[R_RS];
                    l_i = (q[R_QE] - q[R_QS]) - l_m; l_d = 0;
                }
                int64_t clip5 = q[R_REV] ? qlen - q[R_QE] : q[R_QS];
                int64_t clip3 = q[R_REV] ? q[R_QS] : qlen - q[R_QE];
                emit_rname(o, e, q[R_RID]);
                o.ch(','); o.num(q[R_RS] + 1); o.ch(',');
                o.ch("+-"[q[R_REV]]); o.ch(',');
                if (clip5) { o.num(clip5); o.ch('S'); }
                if (l_m) { o.num(l_m); o.ch('M'); }
                if (l_i) { o.num(l_i); o.ch('I'); }
                if (l_d) { o.num(l_d); o.ch('D'); }
                if (clip3) { o.num(clip3); o.ch('S'); }
                o.ch(','); o.num(q[R_MAPQ]); o.ch(',');
                o.num(q[R_BLEN] - q[R_MLEN] + q.n_ambi);
                o.ch(';');
            }
            if (!any) o.pos = sa_start;
        }
        if ((*r)[R_HASP] && (oflag & (F_OUT_CS | F_OUT_MD))) {
            if (oflag & F_OUT_MD) emit_md(o, e, *r);
            else emit_cs(o, e, *r, oflag & F_OUT_CS_LONG);
        }
        if (cigar_in_tag) {
            int64_t clip0 = (*r)[R_REV] ? qlen - (*r)[R_QE] : (*r)[R_QS];
            int64_t clip1 = (*r)[R_REV] ? (*r)[R_QS] : qlen - (*r)[R_QE];
            int64_t cchar = ((flag & 0x800) && !(oflag & F_SOFTCLIP)) ? 5 : 4;
            o.cstr("\tCG:B:I");
            if (clip0) { o.ch(','); o.num(clip0 << 4 | cchar); }
            for (uint32_t cw : r->cigar) { o.ch(','); o.num((int64_t)cw); }
            if (clip1) { o.ch(','); o.num(clip1 << 4 | cchar); }
        }
    }
    if ((oflag & F_COPY_COMMENT) && e.comment_len) {
        o.ch('\t');
        o.mem(e.comment, e.comment_len);
    }
}

static inline void emit_sam(TextOut& o, const EmitCtx& e,
                            const std::vector<NatReg>& regs,
                            int64_t reg_idx, int64_t oflag) {
    emit_sam_rec(o, e, regs, reg_idx, nullptr, 0, 1, oflag);
}

static inline void emit_sam_pe(TextOut& o, const EmitCtx& e,
                               const std::vector<NatReg>& regs,
                               int64_t reg_idx, const NatReg* r_next,
                               int seg_idx, int64_t oflag) {
    emit_sam_rec(o, e, regs, reg_idx, r_next, seg_idx, 2, oflag);
}

// ======================= paired-end (2-segment) =====================
// Ports of pe.py (reference pe.c) + mm_seg_gen (hit.c:347-401).

// ---- mm_select_sub_multi (pe.c:6-43)
static void select_sub_multi(std::vector<NatReg>& regs, double pri_ratio,
                             double pri1, double pri2, int64_t max_gap_ref,
                             int64_t min_diff, int64_t best_n,
                             int64_t n_segs, const int64_t* qlens) {
    if (pri_ratio <= 0.0 || regs.empty()) return;
    int64_t max_dist = n_segs == 2
        ? qlens[0] + qlens[1] + max_gap_ref : 0;
    // in-place compaction with live r[r[i].parent] reads (pe.c:11-39) and
    // float32 ratio compares, like the reference
    float f_ratio = (float)pri_ratio, f1 = (float)pri1, f2 = (float)pri2;
    size_t n = regs.size(), k = 0;
    int64_t n_2nd = 0;
    for (size_t i = 0; i < n; ++i) {
        const NatReg& q = regs[i];
        const NatReg& p = regs[q[R_PARENT]];
        int to_keep = 0;
        if (q[R_PARENT] == (int64_t)i) to_keep = 1;
        else if (q[R_SCORE] + min_diff >= p[R_SCORE])
            to_keep = 1;
        else {
            if (p[R_REV] == q[R_REV] && p[R_RID] == q[R_RID]
                && q[R_RE] - p[R_RS] < max_dist
                && p[R_RE] - q[R_RS] < max_dist) {
                if ((float)q[R_SCORE] >= (float)p[R_SCORE] * f1)
                    to_keep = 1;
            } else {
                int is_par_both = n_segs == 2 && p[R_QS] < qlens[0]
                                  && p[R_QE] > qlens[0];
                int is_chi_both = n_segs == 2 && q[R_QS] < qlens[0]
                                  && q[R_QE] > qlens[0];
                if (is_chi_both || is_chi_both == is_par_both) {
                    if ((float)q[R_SCORE] >= (float)p[R_SCORE] * f_ratio)
                        to_keep = 1;
                } else {
                    if ((float)q[R_SCORE] >= (float)p[R_SCORE] * f2)
                        to_keep = 1;
                }
            }
        }
        if (to_keep && q[R_PARENT] != (int64_t)i) {
            ++n_2nd;
            if (n_2nd > best_n) to_keep = 0;
        }
        if (to_keep) {
            if (k != i) regs[k] = std::move(regs[i]);
            ++k;
        }
    }
    bool changed = k != n;
    regs.resize(k);
    if (changed) sync_regs(regs);
}

// ---- mm_seg_gen (hit.c:347-401): split joint chains into per-segment
// chains with segment-local query coordinates.
static void seg_gen(const Ctx& c, uint64_t hash_, int64_t n_segs,
                    const int64_t* qlens, const std::vector<NatReg>& regs0,
                    std::vector<std::vector<NatReg>>& seg_regs,
                    std::vector<std::vector<uint64_t>>& seg_a) {
    std::vector<int64_t> acc(n_segs, 0);
    for (int64_t s = 1; s < n_segs; ++s) acc[s] = acc[s - 1] + qlens[s - 1];
    int64_t qlen_sum = acc[n_segs - 1] + qlens[n_segs - 1];
    std::vector<std::vector<uint64_t>> seg_u(
        n_segs, std::vector<uint64_t>(regs0.size()));
    for (int64_t s = 0; s < n_segs; ++s)
        for (size_t i = 0; i < regs0.size(); ++i)
            seg_u[s][i] = (uint64_t)regs0[i][R_SCORE] << 32;
    seg_a.assign(n_segs, {});
    for (size_t i = 0; i < regs0.size(); ++i) {
        const NatReg& r = regs0[i];
        for (int64_t j = 0; j < r[R_CNT]; ++j) {
            uint64_t ay = AY(c, r[R_AS] + j);
            int64_t sid = (int64_t)((ay & (0xFFull << 48)) >> 48);
            seg_u[sid][i] += 1;
        }
    }
    for (size_t i = 0; i < regs0.size(); ++i) {
        const NatReg& r = regs0[i];
        for (int64_t j = 0; j < r[R_CNT]; ++j) {
            uint64_t ax = AX(c, r[R_AS] + j);
            uint64_t ay = AY(c, r[R_AS] + j);
            int64_t sid = (int64_t)((ay & (0xFFull << 48)) >> 48);
            if (ax >> 63)
                ay -= (uint64_t)(qlen_sum - (qlens[sid] + acc[sid]));
            else
                ay -= (uint64_t)acc[sid];
            seg_a[sid].push_back(ax);
            seg_a[sid].push_back(ay);
        }
    }
    seg_regs.assign(n_segs, {});
    for (int64_t s = 0; s < n_segs; ++s) {
        std::vector<uint64_t> u;
        for (size_t i = 0; i < regs0.size(); ++i)
            if (seg_u[s][i] & 0xFFFFFFFFull) u.push_back(seg_u[s][i]);
        Ctx cs;
        cs.A = seg_a[s].data();
        cs.n_a = (int64_t)seg_a[s].size() / 2;
        cs.qlen = qlens[s];
        cs.seq_len = c.seq_len;  // reg_set_coor only reads A/qlen
        seg_regs[s] = gen_regs(cs, hash_, u.data(), (int64_t)u.size());
        for (auto& r : seg_regs[s]) {
            r[R_SEGSPLIT] = 1;
            r[R_SEGID] = s;
        }
    }
}

// ---- mm_set_pe_thru (pe.c:45-63, incl. its re-re typo)
static void set_pe_thru(const int64_t* qlens,
                        std::vector<NatReg>* regss[2]) {
    int64_t n_pri[2] = {0, 0}, pri[2] = {-1, -1};
    for (int s = 0; s < 2; ++s)
        for (size_t i = 0; i < regss[s]->size(); ++i)
            if ((*regss[s])[i][R_ID] == (*regss[s])[i][R_PARENT]) {
                ++n_pri[s];
                pri[s] = (int64_t)i;
            }
    if (n_pri[0] == 1 && n_pri[1] == 1) {
        NatReg& p = (*regss[0])[pri[0]];
        NatReg& q = (*regss[1])[pri[1]];
        if (p[R_RID] == q[R_RID] && p[R_REV] == q[R_REV]
            && llabs(p[R_RS] - q[R_RS]) < 3
            && llabs(p[R_RE] - p[R_RE]) < 3
            && ((p[R_QS] == 0 && qlens[1] - q[R_QE] == 0)
                || (q[R_QS] == 0 && qlens[0] - p[R_QE] == 0))) {
            p[R_PETHRU] = q[R_PETHRU] = 1;
        }
    }
}

// ---- mm_pair (pe.c:76-177)
static void pair_pe(int64_t max_gap_ref, int64_t pe_bonus, int64_t sub_diff,
                    int64_t match_sc, const int64_t* qlens,
                    std::vector<NatReg>* regss[2]) {
    struct Ent { uint64_t key; int s; int64_t rev; NatReg* r; };
    std::vector<Ent> entries;
    int64_t dp_thres = 0;
    int segs = 0;
    for (int s = 0; s < 2; ++s) {
        int64_t maxv = 0;
        for (auto& r : *regss[s]) {
            uint64_t key = ((uint64_t)r[R_RID] << 32)
                           | ((uint64_t)r[R_RS] << 1)
                           | (uint64_t)(s ^ (int)r[R_REV]);
            entries.push_back({key, s, r[R_REV], &r});
            int64_t dm = r[R_HASP] ? r.dp_max : 0;
            if (dm > maxv) maxv = dm;
            segs |= 1 << s;
        }
        dp_thres += maxv;
    }
    if (segs != 3) return;  // pe.c:126 returns before set_pe_thru
    dp_thres = dp_thres - pe_bonus > 0 ? dp_thres - pe_bonus : 0;
    std::stable_sort(entries.begin(), entries.end(),
                     [](const Ent& a, const Ent& b) { return a.key < b.key; });
    int64_t maxsc = -1;
    int64_t max_idx[2] = {-1, -1};
    int64_t last[2] = {-1, -1};
    std::vector<int64_t> sc;
    for (size_t i = 0; i < entries.size(); ++i) {
        Ent& ei = entries[i];
        if (ei.key & 1) {
            if (last[ei.rev] < 0) continue;
            NatReg* r = ei.r;
            NatReg* q = entries[last[ei.rev]].r;
            if ((*r)[R_RID] != (*q)[R_RID]
                || (*r)[R_RS] - (*q)[R_RE] > max_gap_ref)
                continue;
            for (int64_t j = last[ei.rev]; j >= 0; --j) {
                Ent& ej = entries[j];
                if (ej.rev != ei.rev || ej.s == ei.s) continue;
                q = ej.r;
                if ((*r)[R_RID] != (*q)[R_RID]
                    || (*r)[R_RS] - (*q)[R_RE] > max_gap_ref)
                    break;
                if (r->dp_max + q->dp_max < dp_thres) continue;
                int64_t score = ((r->dp_max + q->dp_max) << 32)
                    | (((*r)[R_HASH] + (*q)[R_HASH]) & 0xFFFFFFFFll);
                if (score > maxsc) {
                    maxsc = score;
                    max_idx[ej.s] = j;
                    max_idx[ei.s] = (int64_t)i;
                }
                sc.push_back(score);
            }
        } else {
            last[ei.rev] = (int64_t)i;
        }
    }
    std::sort(sc.begin(), sc.end());
    if (!sc.empty() && maxsc > 0) {
        NatReg* r[2] = {entries[max_idx[0]].r, entries[max_idx[1]].r};
        (*r[0])[R_PROPER] = (*r[1])[R_PROPER] = 1;
        for (int s = 0; s < 2; ++s) {
            if ((*r[s])[R_ID] != (*r[s])[R_PARENT]) {  // lift to primary
                NatReg& p = (*regss[s])[(*r[s])[R_PARENT]];
                for (auto& x : *regss[s])
                    if (x[R_PARENT] == p[R_ID]) x[R_PARENT] = (*r[s])[R_ID];
                p[R_MAPQ] = 0;
            }
            if (!(*r[s])[R_SAMPRI]) {
                for (auto& x : *regss[s]) x[R_SAMPRI] = 0;
                (*r[s])[R_SAMPRI] = 1;
            }
        }
        int64_t mapq_pe = (*r[0])[R_MAPQ] > (*r[1])[R_MAPQ]
            ? (*r[0])[R_MAPQ] : (*r[1])[R_MAPQ];
        int64_t n_sub = 0;
        for (int64_t x : sc)
            if ((x >> 32) + sub_diff >= (maxsc >> 32)) ++n_sub;
        if (sc.size() > 1) {
            // all-float32 chain (pe.c:159)
            int64_t mapq_pe_alt = (int64_t)(int)(
                6.02f * ((maxsc >> 32) - (sc[sc.size() - 2] >> 32)) / match_sc
                - 4.343f * logf((float)n_sub));
            if (mapq_pe_alt < mapq_pe) mapq_pe = mapq_pe_alt;
        }
        for (int s = 0; s < 2; ++s)
            if ((*r[s])[R_MAPQ] < mapq_pe)
                (*r[s])[R_MAPQ] = (int64_t)(int)(.2f * (*r[s])[R_MAPQ]
                                                 + .8f * mapq_pe + .499f);
        if (sc.size() == 1) {
            for (int s = 0; s < 2; ++s)
                if ((*r[s])[R_MAPQ] < 2) (*r[s])[R_MAPQ] = 2;
        } else if ((maxsc >> 32) > (sc[sc.size() - 2] >> 32)) {
            for (int s = 0; s < 2; ++s)
                if ((*r[s])[R_MAPQ] < 1) (*r[s])[R_MAPQ] = 1;
        }
    }
    set_pe_thru(qlens, regss);
}

// the align_skeleton loop body shared by both entries
static int64_t skeleton_loop(Ctx& c, std::vector<NatReg>& regs,
                             int64_t min_cnt, int64_t min_chain_score,
                             int64_t min_dp_max, double max_clip_ratio) {
    constexpr int64_t MF_SPLICE_FOR = 0x100, MF_SPLICE_REV = 0x200;
    bool is_splice = c.flag & F_SPLICE;
    bool two_round = is_splice && (c.flag & MF_SPLICE_FOR)
                     && (c.flag & MF_SPLICE_REV);
    for (size_t i = 0; i < regs.size(); ++i) {
        NatReg r2;
        bool has_r2;
        if (two_round) {  // both-strand splice rounds (align.c:725-741)
            NatReg s0 = regs[i], s1 = regs[i];
            NatReg r20, r21;
            bool h0 = align1(c, s0, r20, MF_SPLICE_FOR);
            if (c.bad) return -1;
            bool h1 = align1(c, s1, r21, MF_SPLICE_REV);
            if (c.bad) return -1;
            int64_t trans, which;
            if (s0.dp_score > s1.dp_score) { which = 0; trans = 1; }
            else if (s0.dp_score < s1.dp_score) { which = 1; trans = 2; }
            else { trans = 3; which = (c.qlen + s0.dp_score) & 1; }
            if (which == 0) { regs[i] = std::move(s0); r2 = std::move(r20); has_r2 = h0; }
            else { regs[i] = std::move(s1); r2 = std::move(r21); has_r2 = h1; }
            regs[i].trans_strand = trans;
        } else {
            has_r2 = align1(c, regs[i], r2, c.flag);
            if (is_splice && regs[i][R_HASP])
                regs[i].trans_strand = (c.flag & MF_SPLICE_FOR) ? 1 : 2;
        }
        if (c.bad) return -1;
        if (has_r2 && r2[R_CNT] > 0)
            regs.insert(regs.begin() + i + 1, std::move(r2));
        if (i > 0 && regs[i][R_SPLITINV]) {
            NatReg ri;
            if (align1_inv(c, regs[i - 1], regs[i], ri)) {
                if (c.bad) return -1;
                regs.insert(regs.begin() + i + 1, std::move(ri));
                ++i;
            }
            if (c.bad) return -1;
        }
    }
    filter_regs_nat(regs, min_cnt, min_chain_score, min_dp_max,
                    max_clip_ratio, c.qlen);
    hit_sort_by_dp(regs);
    return 0;
}

}  // namespace

extern "C" {

// ---- test-only entry points: run the native epilogue ports on flat
// region rows (the same 15-int64 layout golden/hit_test.c uses, plus a
// stride-4 aux {dp_max, dp_max2, has_p, rev}) so they can be fuzzed
// directly against the reference oracle.
static void rows_to_regs(const int64_t* rows, const int64_t* auxs,
                         int64_t n, std::vector<NatReg>& regs)
{
    regs.resize(n);
    for (int64_t i = 0; i < n; ++i) {
        NatReg& r = regs[i];
        const int64_t* w = rows + 15 * i;
        const int64_t* x = auxs + 4 * i;
        r[R_ID] = w[0]; r[R_CNT] = w[1]; r[R_RID] = w[2];
        r[R_SCORE] = w[3]; r[R_QS] = w[4]; r[R_QE] = w[5];
        r[R_RS] = w[6]; r[R_RE] = w[7]; r[R_PARENT] = w[8];
        r[R_SUBSC] = w[9]; r[R_MLEN] = w[10]; r[R_BLEN] = w[11];
        r[R_NSUB] = w[12]; r[R_SCORE0] = w[13]; r[R_AS] = w[14];
        r[R_REV] = x[3];
        r[R_HASP] = x[2];
        r.dp_max = x[0];
        r.dp_max2 = x[1];
    }
}

extern "C" void mm2tpu_test_set_mapq(
    const int64_t* rows, const int64_t* auxs, int64_t n,
    int64_t min_chain_sc, int64_t match_sc, int64_t rep_len,
    int64_t is_sr, int64_t* out_mapq)
{
    std::vector<NatReg> regs;
    rows_to_regs(rows, auxs, n, regs);
    set_mapq_nat(regs, min_chain_sc, match_sc, rep_len, is_sr != 0);
    for (int64_t i = 0; i < n; ++i) out_mapq[i] = regs[i][R_MAPQ];
}

extern "C" int64_t mm2tpu_test_select_sub(
    const int64_t* rows, const int64_t* auxs, int64_t n,
    double pri_ratio, int64_t min_diff, int64_t best_n, int64_t* out_ids)
{
    std::vector<NatReg> regs;
    rows_to_regs(rows, auxs, n, regs);
    select_sub(regs, pri_ratio, min_diff, best_n);
    for (size_t i = 0; i < regs.size(); ++i) out_ids[i] = regs[i][R_ID];
    return (int64_t)regs.size();
}

extern "C" int64_t mm2tpu_test_select_sub_multi(
    const int64_t* rows, const int64_t* auxs, int64_t n,
    double pri_ratio, double pri1, double pri2, int64_t max_gap_ref,
    int64_t min_diff, int64_t best_n, int64_t n_segs,
    const int64_t* qlens, int64_t* out_ids)
{
    std::vector<NatReg> regs;
    rows_to_regs(rows, auxs, n, regs);
    select_sub_multi(regs, pri_ratio, pri1, pri2, max_gap_ref, min_diff,
                     best_n, n_segs, qlens);
    for (size_t i = 0; i < regs.size(); ++i) out_ids[i] = regs[i][R_ID];
    return (int64_t)regs.size();
}

// Standalone symmetric-DUST entry (the sdust CLI): writes up to max_out
// (start, end) pairs into out; returns the interval count.
int64_t mm2tpu_sdust(const uint8_t* b4, int64_t n, int32_t T, int32_t W,
                     int64_t* out, int64_t max_out)
{
    std::vector<std::pair<int64_t, int64_t>> res;
    sdust_impl::sdust_core(b4, n, T, W, res);
    int64_t m = (int64_t)res.size() < max_out ? (int64_t)res.size() : max_out;
    for (int64_t i = 0; i < m; ++i) {
        out[2 * i] = res[i].first;
        out[2 * i + 1] = res[i].second;
    }
    return (int64_t)res.size();
}

// Full align_skeleton region loop.  regs_io: nr_in x 28 int64 rows (layout
// above); a: (n_a, 2) uint64 anchors AFTER squeeze_a (seed flags are set in
// place).  Outputs: up to nr_cap rows in regs_out + extras (7 int64 per
// region: dp_score, dp_max, dp_max2, n_ambi, trans_strand, cig_off,
// n_cigar) + cigar words in cig_buf.  Returns the output region count,
// -1 on a contract violation (caller reruns the Python model), -2 when
// cig_cap or nr_cap is too small (caller retries bigger).
int64_t mm2tpu_align_skeleton(
    const uint8_t* qseq_fwd, int64_t qlen,
    uint64_t* a, int64_t n_a,
    const uint8_t* S, const int64_t* seq_off, const int64_t* seq_len,
    int64_t n_seq, int32_t k, int32_t hpc,
    const int8_t* mat, const int64_t* opt,
    const int64_t* regs_in, int64_t nr_in,
    int64_t* regs_out, int64_t* extras_out, int64_t nr_cap,
    uint32_t* cig_buf, int64_t cig_cap)
{
    Ctx c;
    c.S = S; c.seq_off = seq_off; c.seq_len = seq_len; c.n_seq = n_seq;
    c.k = k; c.hpc = hpc != 0;
    c.mat = mat;
    c.flag = opt[0]; c.oa = opt[1]; c.ob = opt[2]; c.q = opt[3];
    c.e = opt[4]; c.q2 = opt[5]; c.e2 = opt[6]; c.zdrop = opt[7];
    c.zdrop_inv = opt[8]; c.end_bonus = opt[9]; c.min_cnt = opt[10];
    c.min_chain_score = opt[11]; c.min_dp_max = opt[12];
    c.max_gap = opt[13]; c.bw = opt[14]; c.min_ksw_len = opt[15];
    c.A = a; c.n_a = n_a;
    c.qlen = qlen;
    std::vector<uint8_t> qrev(qlen);
    for (int64_t i = 0; i < qlen; ++i) {
        uint8_t b = qseq_fwd[qlen - 1 - i];
        qrev[i] = b < 4 ? (uint8_t)(3 - b) : 4;
    }
    c.qstr[0] = qseq_fwd;
    c.qstr[1] = qrev.data();

    std::vector<NatReg> regs(nr_in);
    for (int64_t i = 0; i < nr_in; ++i)
        memcpy(regs[i].f, regs_in + i * RF, RF * 8);

    for (size_t i = 0; i < regs.size(); ++i) {
        NatReg r2;
        bool has_r2 = align1(c, regs[i], r2);
        if (c.bad) return -1;
        if (has_r2 && r2[R_CNT] > 0)
            regs.insert(regs.begin() + i + 1, std::move(r2));
        if (i > 0 && regs[i][R_SPLITINV]) {
            NatReg ri;
            if (align1_inv(c, regs[i - 1], regs[i], ri)) {
                if (c.bad) return -1;
                regs.insert(regs.begin() + i + 1, std::move(ri));
                ++i;  // skip the inserted INV alignment
            }
            if (c.bad) return -1;
        }
    }

    int64_t n_out = (int64_t)regs.size();
    if (n_out > nr_cap) return -2;
    int64_t cpos = 0;
    for (int64_t i = 0; i < n_out; ++i) {
        memcpy(regs_out + i * RF, regs[i].f, RF * 8);
        int64_t* ex = extras_out + i * 7;
        ex[0] = regs[i].dp_score; ex[1] = regs[i].dp_max;
        ex[2] = regs[i].dp_max2; ex[3] = regs[i].n_ambi;
        ex[4] = regs[i].trans_strand;
        ex[5] = cpos; ex[6] = (int64_t)regs[i].cigar.size();
        if (cpos + ex[6] > cig_cap) return -2;
        memcpy(cig_buf + cpos, regs[i].cigar.data(), ex[6] * 4);
        cpos += ex[6];
    }
    return n_out;
}

// Whole-read mapping in one call (the host fast path): sketch -> seed
// collect -> chaining DP -> gen_regs -> chain_post (set_parent /
// select_sub / join_long) -> est_err -> align skeleton -> post select ->
// mapq.  Single-segment, non-splice, non-ava reads only (the Python
// pipeline keeps every other mode and is the golden model).
//
// opt layout (int64): 0 flag, 1 a, 2 b, 3 q, 4 e, 5 q2, 6 e2, 7 zdrop,
// 8 zdrop_inv, 9 end_bonus, 10 min_cnt, 11 min_chain_score,
// 12 min_dp_max, 13 max_gap, 14 bw, 15 min_ksw_len, 16 gap_qry,
// 17 gap_ref, 18 max_chain_skip, 19 mid_occ, 20 best_n,
// 21 max_join_long, 22 max_join_short, 23 min_join_flank_sc,
// 24 skip_mode, 25 do_align, 26 no_ljoin, 27 all_chains.
// optf (double): 0 mask_level, 1 pri_ratio, 2 max_clip_ratio.
// out_misc (int64): 0 rep_len.
// Returns region count, -1 contract fallback, -2 capacity.

// Post-chain half of the per-read map (the reference result_thread side,
// map.c:933-1015): Ctx setup from PRECOMPUTED chains, region generation,
// chain_post selection, est_err, base-level alignment waves and mapq.
// Shared by the all-native path (chains from mm2tpu_chain_dp) and the
// device-offload flow (chains computed on the TPU, models/device_flow.py,
// the fork's FPGA->result_thread handoff, fpga_chaindp.c:228).
// out_a: interleaved (x,y) compact chain anchors, mutated in place (seed
// flags, squeeze); u: score<<32|count per chain.
static int64_t finish_unit_core(
    const uint8_t* qseq_fwd, int64_t qlen, uint64_t qhash,
    const uint8_t* S, const int64_t* seq_off, const int64_t* seq_len,
    int64_t n_seq, int32_t k, int32_t hpc,
    const int8_t* mat, const int64_t* opt, const double* optf,
    int64_t rep_len, const uint64_t* mini, int64_t n_mini,
    std::vector<uint64_t>& out_a, int64_t n_v,
    const uint64_t* u, int64_t n_u,
    Ctx& c, std::vector<NatReg>& regs, std::vector<uint8_t>& qrev)
{
    c.S = S; c.seq_off = seq_off; c.seq_len = seq_len; c.n_seq = n_seq;
    c.k = k; c.hpc = hpc != 0;
    c.mat = mat;
    c.flag = opt[0]; c.oa = opt[1]; c.ob = opt[2]; c.q = opt[3];
    c.e = opt[4]; c.q2 = opt[5]; c.e2 = opt[6]; c.zdrop = opt[7];
    c.zdrop_inv = opt[8]; c.end_bonus = opt[9]; c.min_cnt = opt[10];
    c.min_chain_score = opt[11]; c.min_dp_max = opt[12];
    c.max_gap = opt[13]; c.bw = opt[14]; c.min_ksw_len = opt[15];
    c.noncan = opt[30]; c.anchor_ext_len = opt[31];
    c.anchor_ext_shift = opt[32];
    c.A = out_a.data(); c.n_a = n_v;
    c.qlen = qlen;
    qrev.resize(qlen);
    for (int64_t i = 0; i < qlen; ++i) {
        uint8_t b = qseq_fwd[qlen - 1 - i];
        qrev[i] = b < 4 ? (uint8_t)(3 - b) : 4;
    }
    c.qstr[0] = qseq_fwd;
    c.qstr[1] = qrev.data();

    bool is_sr = c.flag & F_SR;
    double mask_level = optf[0], pri_ratio = optf[1], max_clip = optf[2];
    int64_t sub_diff = 2 * c.oa + c.ob;

    regs = gen_regs(c, qhash, u, n_u);
    if (!opt[27]) {  // chain_post unless MM_F_ALL_CHAINS
        set_parent(regs, mask_level, sub_diff);
        select_sub(regs, pri_ratio, 2 * (int64_t)k, opt[20]);
        if (!opt[26])
            join_long(c, regs, opt[21], opt[22], opt[23], c.min_cnt,
                      c.min_chain_score, c.min_dp_max, max_clip);
    }
    if (!is_sr) est_err_nat(c, regs, mini, n_mini);
    if (opt[25] && !regs.empty()) {  // base-level alignment
        c.n_a = squeeze_a_nat(c, regs);
        ProfScope ps(4);
        if (skeleton_loop(c, regs, c.min_cnt, c.min_chain_score,
                          c.min_dp_max, max_clip) < 0)
            return -1;
        if (!opt[27]) {  // post-align select, skipped by MM_F_ALL_CHAINS
            set_parent(regs, mask_level, sub_diff);
            select_sub(regs, pri_ratio, 2 * (int64_t)k, opt[20]);
            set_sam_pri(regs);
        }
    }
    set_mapq_nat(regs, c.min_chain_score, c.oa, rep_len, is_sr);
    return (int64_t)regs.size();
}

static int64_t map_unit_core(
    const uint8_t* qseq_fwd, int64_t qlen, uint64_t qhash,
    const uint8_t* S, const int64_t* seq_off, const int64_t* seq_len,
    int64_t n_seq,
    const uint64_t* keys, int64_t n_keys, const int64_t* starts,
    const uint64_t* values,
    int32_t k, int32_t w, int32_t hpc,
    const int8_t* mat, const int64_t* opt, const double* optf,
    const int64_t* name_rank, int64_t q_exact, int64_t q_ins,
    int64_t* out_misc, Ctx& c, std::vector<NatReg>& regs,
    std::vector<uint64_t>& out_a, std::vector<uint8_t>& qrev)
{
    out_misc[0] = 0;
    if (qlen <= 0) return 0;
    // sketch
    int64_t offs2[2] = {0, qlen};
    uint32_t rid0 = 0;
    int64_t n_mv = 0;
    void* sh;
    {
        ProfScope ps(0);
        sh = mm2tpu_sketch_batch(qseq_fwd, offs2, 1, w, k, &rid0, hpc,
                                 &n_mv);
    }
    std::vector<uint64_t> mv(2 * (n_mv > 0 ? n_mv : 1));
    mm2tpu_sketch_take(sh, mv.data());
    if (n_mv == 0) return 0;
    if (opt[33] > 0)  // -T low-complexity minimizer masking
        n_mv = sdust_impl::dust_mask_mv(mv.data(), n_mv, qseq_fwd, qlen,
                                        (int)opt[33]);
    if (n_mv == 0) return 0;
    // seed-hit collection
    int64_t sizes[3] = {0, 0, 0};
    int32_t diag_flags = (int32_t)(opt[0] & 0x3);  // NO_DIAG | NO_DUAL
    void* ch;
    {
        ProfScope ps(1);
        ch = mm2tpu_collect_seeds_ava(
            mv.data(), n_mv, keys, n_keys, starts, values, opt[19], qlen,
            (int32_t)opt[24], name_rank, q_exact, q_ins, diag_flags, sizes);
    }
    int64_t n_anch = sizes[0], n_mini = sizes[1];
    std::vector<uint64_t> anch(2 * (n_anch > 0 ? n_anch : 1));
    std::vector<uint64_t> mini(n_mini > 0 ? n_mini : 1);
    mm2tpu_collect_take(ch, anch.data(), mini.data());
    int64_t rep_len = sizes[2];
    out_misc[0] = rep_len;
    if (n_anch == 0) return 0;
    // chaining DP
    std::vector<uint64_t> ax(n_anch), ay(n_anch);
    for (int64_t i = 0; i < n_anch; ++i) {
        ax[i] = anch[2 * i];
        ay[i] = anch[2 * i + 1];
    }
    out_a.resize(4 * n_anch);
    std::vector<uint64_t> out_u(2 * n_anch);
    int64_t n_v = 0;
    int64_t n_u;
    {
        ProfScope ps(2);
        n_u = mm2tpu_chain_dp(
            n_anch, ax.data(), ay.data(), opt[17] /*gap_ref = max_dist_x*/,
            opt[16] /*gap_qry = max_dist_y*/, opt[14], opt[18],
            (int32_t)opt[10], (int32_t)opt[11],
            (opt[0] & F_SPLICE) ? 1 : 0, 1,
            out_a.data(), out_u.data(), &n_v);
    }
    if (n_u <= 0) return 0;
    ProfScope ps(3);
    return finish_unit_core(qseq_fwd, qlen, qhash, S, seq_off, seq_len,
                            n_seq, k, hpc, mat, opt, optf, rep_len,
                            mini.data(), n_mini, out_a, n_v,
                            out_u.data(), n_u, c, regs, qrev);
}

int64_t mm2tpu_map_unit(
    const uint8_t* qseq_fwd, int64_t qlen, uint64_t qhash,
    const uint8_t* S, const int64_t* seq_off, const int64_t* seq_len,
    int64_t n_seq,
    const uint64_t* keys, int64_t n_keys, const int64_t* starts,
    const uint64_t* values,
    int32_t k, int32_t w, int32_t hpc,
    const int8_t* mat, const int64_t* opt, const double* optf,
    int64_t* regs_out, int64_t* extras_out, int64_t nr_cap,
    uint32_t* cig_buf, int64_t cig_cap, int64_t* out_misc,
    const int64_t* name_rank, int64_t q_exact, int64_t q_ins)
{
    Ctx c;
    std::vector<NatReg> regs;
    std::vector<uint64_t> out_a;
    std::vector<uint8_t> qrev;
    int64_t n_out = map_unit_core(qseq_fwd, qlen, qhash, S, seq_off, seq_len,
                                  n_seq, keys, n_keys, starts, values, k, w,
                                  hpc, mat, opt, optf, name_rank, q_exact,
                                  q_ins, out_misc, c, regs, out_a, qrev);
    if (n_out <= 0) return n_out;
    if (n_out > nr_cap) return -2;
    int64_t cpos = 0;
    for (int64_t i = 0; i < n_out; ++i) {
        memcpy(regs_out + i * RF, regs[i].f, RF * 8);
        int64_t* ex = extras_out + i * 7;
        ex[0] = regs[i].dp_score; ex[1] = regs[i].dp_max;
        ex[2] = regs[i].dp_max2; ex[3] = regs[i].n_ambi;
        ex[4] = regs[i].trans_strand;
        ex[5] = cpos; ex[6] = (int64_t)regs[i].cigar.size();
        if (cpos + ex[6] > cig_cap) return -2;
        memcpy(cig_buf + cpos, regs[i].cigar.data(), ex[6] * 4);
        cpos += ex[6];
    }
    return n_out;
}

// Shared single-segment text emission: SAM records (incl. the unmapped
// record on zero regions) or PAF rows from a finished region list.
// Returns the line count or -2 on text/line capacity overflow.
static int64_t emit_unit_text(
    Ctx& c, std::vector<NatReg>& regs, const uint8_t* qseq_fwd,
    const char* qname, int64_t qname_len,
    const char* seq_ascii, const char* qual,
    const char* comment, int64_t comment_len,
    const char* rg_id, int64_t rg_len,
    const char* rnames, const int64_t* rname_off,
    int32_t sam_mode,
    char* out_text, int64_t text_cap, int64_t* line_off, int64_t line_cap)
{
    EmitCtx e;
    e.c = &c;
    e.qname = qname; e.qname_len = qname_len;
    e.seq = seq_ascii; e.qual = qual;
    e.comment = comment; e.comment_len = comment_len;
    e.rg_id = rg_id; e.rg_len = rg_len;
    e.rnames = rnames; e.rname_off = rname_off;
    e.qa = qseq_fwd;
    constexpr int64_t F_NO_PRINT_2ND = 0x4000;
    TextOut o{out_text, text_cap};
    int64_t n_lines = 0;
    bool line_of = false;   // distinct from o.of: the caller must know
    auto start_line = [&]() {               // WHICH buffer to grow
        if (n_lines + 1 >= line_cap) { line_of = true; return; }
        line_off[n_lines++] = o.pos;
    };
    for (int64_t j = 0; j < (int64_t)regs.size(); ++j) {
        const NatReg& r = regs[j];
        if ((c.flag & F_NO_PRINT_2ND) && r[R_ID] != r[R_PARENT]) continue;
        start_line();
        if (sam_mode) emit_sam(o, e, regs, j, c.flag);
        else emit_paf(o, e, r, c.flag);
    }
    if (regs.empty() && sam_mode) {
        start_line();
        emit_sam(o, e, regs, -1, c.flag);
    }
    line_off[n_lines] = o.pos;
    if (line_of) return -3;   // line_off capacity
    if (o.of) return -2;       // text capacity
    return n_lines;
}

// Map one read and emit its SAM/PAF lines directly (single-segment fast
// path): text into out_text (cap text_cap) with per-line offsets in
// line_off (line k spans [line_off[k], line_off[k+1])); returns the line
// count, -1 contract fallback, -2 text capacity, -3 line_off capacity.  out_misc[0] =
// rep_len.  sam_mode != 0 -> SAM records (incl. the unmapped record on
// zero regions); else PAF rows.  rnames = concatenated target names with
// rname_off offsets (n_seq + 1).
int64_t mm2tpu_map_unit_text(
    const uint8_t* qseq_fwd, int64_t qlen, uint64_t qhash,
    const uint8_t* S, const int64_t* seq_off, const int64_t* seq_len,
    int64_t n_seq,
    const uint64_t* keys, int64_t n_keys, const int64_t* starts,
    const uint64_t* values,
    int32_t k, int32_t w, int32_t hpc,
    const int8_t* mat, const int64_t* opt, const double* optf,
    const char* qname, int64_t qname_len,
    const char* seq_ascii, const char* qual,
    const char* comment, int64_t comment_len,
    const char* rg_id, int64_t rg_len,
    const char* rnames, const int64_t* rname_off,
    int32_t sam_mode,
    char* out_text, int64_t text_cap, int64_t* line_off, int64_t line_cap,
    int64_t* out_misc,
    const int64_t* name_rank, int64_t q_exact, int64_t q_ins)
{
    Ctx c;
    std::vector<NatReg> regs;
    std::vector<uint64_t> out_a;
    std::vector<uint8_t> qrev;
    int64_t n_regs = map_unit_core(qseq_fwd, qlen, qhash, S, seq_off,
                                   seq_len, n_seq, keys, n_keys, starts,
                                   values, k, w, hpc, mat, opt, optf,
                                   name_rank, q_exact, q_ins,
                                   out_misc, c, regs, out_a, qrev);
    if (n_regs < 0) return n_regs;
    // core early-outs (no minimizers/anchors/chains) skip Ctx setup
    if (n_regs == 0) {
        c.qlen = qlen;
        c.seq_len = seq_len;
        c.S = S; c.seq_off = seq_off;
        c.flag = opt[0];
    }
    ProfScope ps(5);
    return emit_unit_text(c, regs, qseq_fwd, qname, qname_len, seq_ascii,
                          qual, comment, comment_len, rg_id, rg_len,
                          rnames, rname_off, sam_mode, out_text, text_cap,
                          line_off, line_cap);
}

// Per-read tie-break hash computed C-side for the batch path (reference
// map.c:345-347: __ac_X31_hash_string ^ (Wang(qlen)+Wang(seed)), then
// Wang).  Matches the Python constants.qname_hash for ASCII names (the
// batch caller falls back to the per-read path on any non-ASCII byte,
// where Python's code-point iteration and byte iteration could differ).
static inline uint32_t wang32(uint32_t key) {
    key += ~(key << 15); key ^= key >> 10; key += key << 3;
    key ^= key >> 6; key += ~(key << 11); key ^= key >> 16;
    return key;
}
static inline uint32_t batch_qname_hash(const char* s, int64_t len,
                                        int64_t qlen, int64_t seed) {
    uint32_t h = 0;
    for (int64_t i = 0; i < len; ++i)
        h = (h << 5) - h + (uint32_t)(uint8_t)s[i];
    h ^= wang32((uint32_t)qlen) + wang32((uint32_t)seed);
    return wang32(h);
}

// Batched single-segment mapping: the whole per-read loop runs here so the
// Python driver pays marshalling once per BATCH, not per read (measured:
// at 150 bp sr the per-read Python wrapper cost ~39 us/read of the 57 us
// total — the reference's worker_for loop shape, map.c:598-636, without
// the interpreter between reads).  Read i's name/seq/qual/comment live in
// blobs at [xxx_offs[i], xxx_offs[i+1]); qual_offs/com_offs may be null.
// Per-read gap bounds (compute_gap_bounds, map.c:357-366) are derived
// here from max_gap/max_gap_ref/max_frag_len on a local opt copy.
// Outputs: shared text buffer + line_off (global offsets);
// read_line_idx[i..i+1] brackets read i's lines; status[i] = line count
// or -1 (contract fallback: the caller remaps that read on the staged
// path).  Returns 0, or -2/-3 (text/line capacity: grow + rerun batch).
extern "C" int64_t mm2tpu_map_batch_text(
    int64_t n_reads,
    const char* seq_blob, const int64_t* seq_offs,
    const char* name_blob, const int64_t* name_offs,
    const char* qual_blob, const int64_t* qual_offs,
    const char* com_blob, const int64_t* com_offs,
    int64_t seed, int64_t max_gap_ref, int64_t max_frag_len,
    const uint8_t* S, const int64_t* seq_off, const int64_t* seq_len,
    int64_t n_seq,
    const uint64_t* keys, int64_t n_keys, const int64_t* starts,
    const uint64_t* values,
    int32_t k, int32_t w, int32_t hpc,
    const int8_t* mat, const int64_t* opt_in, const double* optf,
    const char* rg_id, int64_t rg_len,
    const char* rnames, const int64_t* rname_off,
    int32_t sam_mode,
    char* out_text, int64_t text_cap, int64_t* line_off, int64_t line_cap,
    int64_t* read_line_idx, int32_t* status)
{
    constexpr int OPTN = 34;
    int64_t opt[OPTN];
    memcpy(opt, opt_in, sizeof(opt));
    const bool is_sr = (opt[0] & 0x1000) != 0;   // MM_F_SR
    const uint8_t* tab = nt4_table();
    std::vector<uint8_t> qa;
    int64_t gpos = 0, glines = 0;
    int64_t misc[4];
    for (int64_t i = 0; i < n_reads; ++i) {
        read_line_idx[i] = glines;
        status[i] = -1;
        const char* seq = seq_blob + seq_offs[i];
        const int64_t qlen = seq_offs[i + 1] - seq_offs[i];
        const char* name = name_blob + name_offs[i];
        const int64_t nlen = name_offs[i + 1] - name_offs[i];
        if (qlen == 0) continue;                    // python-path parity
        bool ascii = true;
        for (int64_t j = 0; j < nlen && ascii; ++j)
            ascii = (uint8_t)name[j] < 0x80;
        if (!ascii) continue;                       // hash parity fallback
        qa.resize(qlen);
        for (int64_t j = 0; j < qlen; ++j)
            qa[j] = tab[(uint8_t)seq[j]];
        const uint32_t qhash = batch_qname_hash(name, nlen, qlen, seed);
        // compute_gap_bounds (map.c:357-366), single-segment unit
        const int64_t max_gap = opt[13];
        int64_t gq = is_sr ? (qlen > max_gap ? qlen : max_gap) : max_gap;
        int64_t gr = max_gap;
        if (max_gap_ref > 0) gr = max_gap_ref;
        else if (max_frag_len > 0) {
            gr = max_frag_len - qlen;
            if (gr < max_gap) gr = max_gap;
        }
        opt[16] = gq;
        opt[17] = gr;
        const char* qual = qual_offs
            ? (qual_offs[i + 1] > qual_offs[i] ? qual_blob + qual_offs[i]
                                               : nullptr)
            : nullptr;
        const char* com = nullptr;
        int64_t com_len = 0;
        if (com_offs && com_offs[i + 1] > com_offs[i]) {
            com = com_blob + com_offs[i];
            com_len = com_offs[i + 1] - com_offs[i];
        }
        int64_t nl = mm2tpu_map_unit_text(
            qa.data(), qlen, qhash, S, seq_off, seq_len, n_seq,
            keys, n_keys, starts, values, k, w, hpc, mat, opt, optf,
            name, nlen, seq, qual, com, com_len, rg_id, rg_len,
            rnames, rname_off, sam_mode,
            out_text + gpos, text_cap - gpos,
            line_off + glines, line_cap - glines,
            misc, nullptr, -1, 0);
        if (nl == -2 || nl == -3) return nl;        // grow + rerun batch
        if (nl < 0) continue;                        // per-read fallback
        // line offsets came back relative to this read's slice
        for (int64_t t = 0; t <= nl; ++t) line_off[glines + t] += gpos;
        gpos = line_off[glines + nl];
        glines += nl;
        status[i] = (int32_t)nl;
    }
    read_line_idx[n_reads] = glines;
    line_off[glines] = gpos;
    return 0;
}

extern "C" int64_t mm2tpu_map_frag_pe(
    const uint8_t*, int64_t, const uint8_t*, int64_t, int32_t, int32_t,
    uint64_t, const uint8_t*, const int64_t*, const int64_t*, int64_t,
    const uint64_t*, int64_t, const int64_t*, const uint64_t*,
    int32_t, int32_t, int32_t, const int8_t*, const int64_t*,
    const double*, const char*, int64_t, const char*, int64_t,
    const char*, int64_t, const char*, const char*, const char*, int64_t,
    const char*, const char*, const char*, int64_t, const char*, int64_t,
    const char*, const int64_t*, int32_t, char*, int64_t, int64_t*,
    int64_t, int64_t*);

// Batched paired-end mapping: the per-pair loop of mm2tpu_map_frag_pe run
// natively over blob-packed segments (same rationale and protocol as
// mm2tpu_map_batch_text; sr paired-end is the reference's headline
// Illumina workload).  flip0/flip1 are the pe_ori revcomp flags (pair-
// invariant); nt4 encode + revcomp + the joint qname hash (RAW name0,
// qlen_sum, seed — map.c:345-347) + SAM-mode pair-suffix stripping
// (mm_qname_len, bseq.h:31-36) all happen here.  status[i] = line count
// or -1 (fallback); returns 0 / -2 / -3.
extern "C" int64_t mm2tpu_map_batch_pe_text(
    int64_t n_pairs,
    const char* seq0_blob, const int64_t* seq0_offs,
    const char* seq1_blob, const int64_t* seq1_offs,
    const char* name0_blob, const int64_t* name0_offs,
    const char* name1_blob, const int64_t* name1_offs,
    const char* qual0_blob, const int64_t* qual0_offs,
    const char* qual1_blob, const int64_t* qual1_offs,
    const char* com0_blob, const int64_t* com0_offs,
    const char* com1_blob, const int64_t* com1_offs,
    int32_t flip0, int32_t flip1,
    int64_t seed, int64_t max_gap_ref, int64_t max_frag_len,
    const uint8_t* S, const int64_t* seq_off, const int64_t* seq_len,
    int64_t n_seq,
    const uint64_t* keys, int64_t n_keys, const int64_t* starts,
    const uint64_t* values,
    int32_t k, int32_t w, int32_t hpc,
    const int8_t* mat, const int64_t* opt_in, const double* optf,
    const char* rg_id, int64_t rg_len,
    const char* rnames, const int64_t* rname_off,
    int32_t sam_mode,
    char* out_text, int64_t text_cap, int64_t* line_off, int64_t line_cap,
    int64_t* pair_line_idx, int32_t* status)
{
    constexpr int OPTN = 34;
    int64_t opt[OPTN];
    memcpy(opt, opt_in, sizeof(opt));
    const bool is_sr = (opt[0] & 0x1000) != 0;
    const uint8_t* tab = nt4_table();
    std::vector<uint8_t> qa0, qa1;
    int64_t gpos = 0, glines = 0;
    int64_t misc[4];
    auto encode = [&](std::vector<uint8_t>& qa, const char* s, int64_t n,
                      bool flip) {
        qa.resize(n);
        if (!flip) {
            for (int64_t j = 0; j < n; ++j) qa[j] = tab[(uint8_t)s[j]];
        } else {
            for (int64_t j = 0; j < n; ++j) {
                uint8_t c = tab[(uint8_t)s[n - 1 - j]];
                qa[j] = c < 4 ? (uint8_t)(3 - c) : (uint8_t)4;
            }
        }
    };
    auto stripped = [&](const char* nm, int64_t len) -> int64_t {
        // mm_qname_len: drop a trailing "/<digit>" on names >= 3 chars
        if (len >= 3 && nm[len - 2] == '/'
                && nm[len - 1] >= '0' && nm[len - 1] <= '9')
            return len - 2;
        return len;
    };
    for (int64_t i = 0; i < n_pairs; ++i) {
        pair_line_idx[i] = glines;
        status[i] = -1;
        const char* s0 = seq0_blob + seq0_offs[i];
        const char* s1 = seq1_blob + seq1_offs[i];
        const int64_t q0 = seq0_offs[i + 1] - seq0_offs[i];
        const int64_t q1 = seq1_offs[i + 1] - seq1_offs[i];
        const char* n0 = name0_blob + name0_offs[i];
        const char* n1 = name1_blob + name1_offs[i];
        int64_t n0l = name0_offs[i + 1] - name0_offs[i];
        int64_t n1l = name1_offs[i + 1] - name1_offs[i];
        if (q0 == 0 || q1 == 0) continue;
        bool ascii = true;
        for (int64_t j = 0; j < n0l && ascii; ++j)
            ascii = (uint8_t)n0[j] < 0x80;
        // name1 too: the SAM pair-suffix strip below uses ASCII digit
        // tests, but Python's strip_pair_suffix accepts Unicode digits —
        // non-ASCII names take the per-pair path for strip/hash parity
        for (int64_t j = 0; j < n1l && ascii; ++j)
            ascii = (uint8_t)n1[j] < 0x80;
        if (!ascii) continue;
        const int64_t qlen_sum = q0 + q1;
        const uint32_t qhash = batch_qname_hash(n0, n0l, qlen_sum, seed);
        encode(qa0, s0, q0, flip0 != 0);
        encode(qa1, s1, q1, flip1 != 0);
        const int64_t max_gap = opt[13];
        opt[16] = is_sr ? (qlen_sum > max_gap ? qlen_sum : max_gap)
                        : max_gap;
        int64_t gr = max_gap;
        if (max_gap_ref > 0) gr = max_gap_ref;
        else if (max_frag_len > 0) {
            gr = max_frag_len - qlen_sum;
            if (gr < max_gap) gr = max_gap;
        }
        opt[17] = gr;
        if (sam_mode) { n0l = stripped(n0, n0l); n1l = stripped(n1, n1l); }
        auto blobq = [&](const char* b, const int64_t* o) -> const char* {
            return (o && o[i + 1] > o[i]) ? b + o[i] : nullptr;
        };
        const char* qual0 = blobq(qual0_blob, qual0_offs);
        const char* qual1 = blobq(qual1_blob, qual1_offs);
        const char* com0 = blobq(com0_blob, com0_offs);
        const char* com1 = blobq(com1_blob, com1_offs);
        const int64_t c0l = com0 ? com0_offs[i + 1] - com0_offs[i] : 0;
        const int64_t c1l = com1 ? com1_offs[i + 1] - com1_offs[i] : 0;
        int64_t nl = mm2tpu_map_frag_pe(
            qa0.data(), q0, qa1.data(), q1, flip0, flip1, qhash,
            S, seq_off, seq_len, n_seq, keys, n_keys, starts, values,
            k, w, hpc, mat, opt, optf,
            n0, n0l, n0, n0l, n1, n1l,
            s0, qual0, com0, c0l, s1, qual1, com1, c1l,
            rg_id, rg_len, rnames, rname_off, sam_mode,
            out_text + gpos, text_cap - gpos,
            line_off + glines, line_cap - glines, misc);
        if (nl == -2 || nl == -3) return nl;
        if (nl < 0) continue;
        for (int64_t t = 0; t <= nl; ++t) line_off[glines + t] += gpos;
        gpos = line_off[glines + nl];
        glines += nl;
        status[i] = (int32_t)nl;
    }
    pair_line_idx[n_pairs] = glines;
    line_off[glines] = gpos;
    return 0;
}

// Map one read FROM PRECOMPUTED CHAINS and emit its SAM/PAF lines: the
// device-offload text path (sketch/collect/chain already done — chains
// from the TPU flow, models/device_flow.py).  a = interleaved (x,y)
// compact chain anchors (n_v pairs), u = score<<32|count per chain (n_u),
// mini/n_mini = mini_pos entries, rep_len from seed collection.  Other
// params/returns as mm2tpu_map_unit_text.
int64_t mm2tpu_map_unit_text_chains(
    const uint8_t* qseq_fwd, int64_t qlen, uint64_t qhash,
    const uint8_t* S, const int64_t* seq_off, const int64_t* seq_len,
    int64_t n_seq,
    const uint64_t* a, int64_t n_v, const uint64_t* u, int64_t n_u,
    const uint64_t* mini, int64_t n_mini, int64_t rep_len,
    int32_t k, int32_t hpc,
    const int8_t* mat, const int64_t* opt, const double* optf,
    const char* qname, int64_t qname_len,
    const char* seq_ascii, const char* qual,
    const char* comment, int64_t comment_len,
    const char* rg_id, int64_t rg_len,
    const char* rnames, const int64_t* rname_off,
    int32_t sam_mode,
    char* out_text, int64_t text_cap, int64_t* line_off, int64_t line_cap,
    int64_t* out_misc)
{
    Ctx c;
    std::vector<NatReg> regs;
    std::vector<uint8_t> qrev;
    out_misc[0] = rep_len;
    int64_t n_regs = 0;
    if (qlen > 0 && n_u > 0 && n_v > 0) {
        std::vector<uint64_t> out_a(a, a + 2 * n_v);
        n_regs = finish_unit_core(qseq_fwd, qlen, qhash, S, seq_off,
                                  seq_len, n_seq, k, hpc, mat, opt, optf,
                                  rep_len, mini, n_mini, out_a, n_v, u,
                                  n_u, c, regs, qrev);
        if (n_regs < 0) return n_regs;
        // emit below reads c.A (CIGAR-less PAF fuzzy lengths, SA tags):
        // keep the buffer alive through emission
        if (n_regs == 0) {
            c.qlen = qlen; c.seq_len = seq_len;
            c.S = S; c.seq_off = seq_off; c.flag = opt[0];
        }
        return emit_unit_text(c, regs, qseq_fwd, qname, qname_len,
                              seq_ascii, qual, comment, comment_len,
                              rg_id, rg_len, rnames, rname_off, sam_mode,
                              out_text, text_cap, line_off, line_cap);
    }
    c.qlen = qlen;
    c.seq_len = seq_len;
    c.S = S; c.seq_off = seq_off;
    c.flag = opt[0];
    return emit_unit_text(c, regs, qseq_fwd, qname, qname_len, seq_ascii,
                          qual, comment, comment_len, rg_id, rg_len,
                          rnames, rname_off, sam_mode, out_text, text_cap,
                          line_off, line_cap);
}


// Map one 2-segment (paired-end) fragment and emit its SAM/PAF lines.
// qa0/qa1 are the MAPPING-orientation nt4 queries (already PE-flipped per
// pe_ori); flip0/flip1 say which segments were flipped so coordinates are
// restored to read orientation before emission.  seq/qual/comment are the
// ORIGINAL-orientation ASCII per segment; qname is pair-suffix-stripped
// (SAM) and names0/1 are the full per-segment names (PAF rows).
// opt adds: 28 pe_ori, 29 pe_bonus.  Returns the line count, -1 contract
// fallback, -2 capacity.
int64_t mm2tpu_map_frag_pe(
    const uint8_t* qa0, int64_t qlen0, const uint8_t* qa1, int64_t qlen1,
    int32_t flip0, int32_t flip1, uint64_t qhash,
    const uint8_t* S, const int64_t* seq_off, const int64_t* seq_len,
    int64_t n_seq,
    const uint64_t* keys, int64_t n_keys, const int64_t* starts,
    const uint64_t* values,
    int32_t k, int32_t w, int32_t hpc,
    const int8_t* mat, const int64_t* opt, const double* optf,
    const char* qname, int64_t qname_len,
    const char* name0, int64_t name0_len,
    const char* name1, int64_t name1_len,
    const char* seq0, const char* qual0,
    const char* com0, int64_t com0_len,
    const char* seq1, const char* qual1,
    const char* com1, int64_t com1_len,
    const char* rg_id, int64_t rg_len,
    const char* rnames, const int64_t* rname_off,
    int32_t sam_mode,
    char* out_text, int64_t text_cap, int64_t* line_off, int64_t line_cap,
    int64_t* out_misc)
{
    out_misc[0] = 0;
    int64_t qlens[2] = {qlen0, qlen1};
    int64_t qlen_sum = qlen0 + qlen1;
    bool do_align = opt[25];
    bool is_sr = opt[0] & F_SR;

    // joint sketch (collect_minimizers, map.c:87-99): both segments with
    // seg ids and running query-position offsets
    std::vector<uint8_t> nt4(qlen_sum);
    memcpy(nt4.data(), qa0, qlen0);
    memcpy(nt4.data() + qlen0, qa1, qlen1);
    int64_t offs3[3] = {0, qlen0, qlen_sum};
    uint32_t rids2[2] = {0, 1};
    int64_t counts[2] = {0, 0};
    int64_t n_mv = 0;
    std::vector<uint64_t> mv;
    if (qlen_sum > 0) {
        void* sh = mm2tpu_sketch_batch(nt4.data(), offs3, 2, w, k,
                                       rids2, hpc, counts);
        n_mv = counts[0] + counts[1];
        mv.resize(2 * (n_mv > 0 ? n_mv : 1));
        mm2tpu_sketch_take(sh, mv.data());
        for (int64_t i = counts[0]; i < n_mv; ++i)
            mv[2 * i + 1] += (uint64_t)(qlen0 << 1);
        if (opt[33] > 0) {
            // -T masking per segment with its own sequence.  The reference
            // masks AFTER the concat offset is added (map.c:94-96), so
            // segment 1's overlap test runs on shifted positions against
            // segment-local LCRs — replayed exactly (usually a no-op mask
            // for segment 1).
            int64_t m0 = sdust_impl::dust_mask_mv(
                mv.data(), counts[0], qa0, qlen0, (int)opt[33]);
            int64_t m1 = sdust_impl::dust_mask_mv(
                mv.data() + 2 * counts[0], counts[1], qa1, qlen1,
                (int)opt[33]);
            memmove(mv.data() + 2 * m0, mv.data() + 2 * counts[0],
                    2 * m1 * sizeof(uint64_t));
            counts[0] = m0;
            counts[1] = m1;
            n_mv = m0 + m1;
        }
    }
    std::vector<NatReg> empty0, empty1;
    std::vector<NatReg>* regss[2] = {&empty0, &empty1};
    std::vector<std::vector<NatReg>> seg_regs;
    std::vector<std::vector<uint64_t>> seg_a;
    std::vector<uint64_t> out_a;
    std::vector<uint64_t> mini;
    int64_t n_mini = 0, rep_len = 0;
    Ctx c0;
    std::vector<uint8_t> qrev0(qlen0), qrev1(qlen1);
    for (int64_t i = 0; i < qlen0; ++i) {
        uint8_t b = qa0[qlen0 - 1 - i];
        qrev0[i] = b < 4 ? (uint8_t)(3 - b) : 4;
    }
    for (int64_t i = 0; i < qlen1; ++i) {
        uint8_t b = qa1[qlen1 - 1 - i];
        qrev1[i] = b < 4 ? (uint8_t)(3 - b) : 4;
    }

    if (n_mv > 0) {
        int64_t sizes[3] = {0, 0, 0};
        void* ch = mm2tpu_collect_seeds_ava(
            mv.data(), n_mv, keys, n_keys, starts, values, opt[19],
            qlen_sum, (int32_t)opt[24], nullptr, -1, 0, 0, sizes);
        int64_t n_anch = sizes[0];
        n_mini = sizes[1];
        std::vector<uint64_t> anch(2 * (n_anch > 0 ? n_anch : 1));
        mini.resize(n_mini > 0 ? n_mini : 1);
        mm2tpu_collect_take(ch, anch.data(), mini.data());
        rep_len = sizes[2];
        out_misc[0] = rep_len;
        if (n_anch > 0) {
            std::vector<uint64_t> ax(n_anch), ay(n_anch);
            for (int64_t i = 0; i < n_anch; ++i) {
                ax[i] = anch[2 * i];
                ay[i] = anch[2 * i + 1];
            }
            out_a.resize(4 * n_anch);
            std::vector<uint64_t> out_u(2 * n_anch);
            int64_t n_v = 0;
            int64_t n_u = mm2tpu_chain_dp(
                n_anch, ax.data(), ay.data(), opt[17], opt[16], opt[14],
                opt[18], (int32_t)opt[10], (int32_t)opt[11],
                (opt[0] & F_SPLICE) ? 1 : 0, 2,
                out_a.data(), out_u.data(), &n_v);
            if (n_u > 0) {
                c0.S = S; c0.seq_off = seq_off; c0.seq_len = seq_len;
                c0.n_seq = n_seq;
                c0.k = k; c0.hpc = hpc != 0;
                c0.mat = mat;
                c0.flag = opt[0]; c0.oa = opt[1]; c0.ob = opt[2];
                c0.q = opt[3]; c0.e = opt[4]; c0.q2 = opt[5];
                c0.e2 = opt[6]; c0.zdrop = opt[7]; c0.zdrop_inv = opt[8];
                c0.end_bonus = opt[9]; c0.min_cnt = opt[10];
                c0.min_chain_score = opt[11]; c0.min_dp_max = opt[12];
                c0.max_gap = opt[13]; c0.bw = opt[14];
                c0.min_ksw_len = opt[15];
                c0.noncan = opt[30]; c0.anchor_ext_len = opt[31];
                c0.anchor_ext_shift = opt[32];
                c0.A = out_a.data(); c0.n_a = n_v;
                c0.qlen = qlen_sum;
                double mask_level = optf[0], pri_ratio = optf[1],
                       max_clip = optf[2];
                int64_t sub_diff = 2 * c0.oa + c0.ob;
                std::vector<NatReg> regs0 =
                    gen_regs(c0, qhash, out_u.data(), n_u);
                if (!opt[27]) {
                    set_parent(regs0, mask_level, sub_diff);
                    select_sub_multi(regs0, pri_ratio, 0.2, 0.7, opt[17],
                                     2 * (int64_t)k, opt[20], 2, qlens);
                    if (!opt[26])
                        join_long(c0, regs0, opt[21], opt[22], opt[23],
                                  c0.min_cnt, c0.min_chain_score,
                                  c0.min_dp_max, max_clip);
                }
                if (!is_sr) est_err_nat(c0, regs0, mini.data(), n_mini);
                seg_gen(c0, qhash, 2, qlens, regs0, seg_regs, seg_a);
                const uint8_t* qas[2] = {qa0, qa1};
                const uint8_t* qrs[2] = {qrev0.data(), qrev1.data()};
                for (int s = 0; s < 2; ++s) {
                    Ctx cs;
                    cs.S = S; cs.seq_off = seq_off; cs.seq_len = seq_len;
                    cs.n_seq = n_seq;
                    cs.k = k; cs.hpc = hpc != 0;
                    cs.mat = mat;
                    cs.flag = c0.flag; cs.oa = c0.oa; cs.ob = c0.ob;
                    cs.q = c0.q; cs.e = c0.e; cs.q2 = c0.q2; cs.e2 = c0.e2;
                    cs.zdrop = c0.zdrop; cs.zdrop_inv = c0.zdrop_inv;
                    cs.end_bonus = c0.end_bonus; cs.min_cnt = c0.min_cnt;
                    cs.min_chain_score = c0.min_chain_score;
                    cs.min_dp_max = c0.min_dp_max;
                    cs.max_gap = c0.max_gap; cs.bw = c0.bw;
                    cs.min_ksw_len = c0.min_ksw_len;
                    cs.noncan = c0.noncan;
                    cs.anchor_ext_len = c0.anchor_ext_len;
                    cs.anchor_ext_shift = c0.anchor_ext_shift;
                    cs.A = seg_a[s].data();
                    cs.n_a = (int64_t)seg_a[s].size() / 2;
                    cs.qlen = qlens[s];
                    cs.qstr[0] = qas[s];
                    cs.qstr[1] = qrs[s];
                    std::vector<NatReg>& rs_ = seg_regs[s];
                    set_parent(rs_, mask_level, sub_diff);
                    if (do_align) {
                        cs.n_a = squeeze_a_nat(cs, rs_);
                        if (skeleton_loop(cs, rs_, cs.min_cnt,
                                          cs.min_chain_score, cs.min_dp_max,
                                          max_clip) < 0)
                            return -1;
                        if (!opt[27]) {
                            set_parent(rs_, mask_level, sub_diff);
                            select_sub(rs_, pri_ratio, 2 * (int64_t)k,
                                       opt[20]);
                            set_sam_pri(rs_);
                        }
                    }
                    set_mapq_nat(rs_, cs.min_chain_score, cs.oa, rep_len,
                                 is_sr);
                    regss[s] = &rs_;
                }
                if (opt[28] >= 0 && do_align)
                    pair_pe(opt[17], opt[29], sub_diff, c0.oa, qlens, regss);
            }
        }
    }

    // restore read orientation for flipped segments (format_frag)
    int32_t flips[2] = {flip0, flip1};
    for (int s = 0; s < 2; ++s) {
        if (!flips[s]) continue;
        for (auto& r : *regss[s]) {
            int64_t qs = r[R_QS], qe = r[R_QE];
            r[R_QS] = qlens[s] - qe;
            r[R_QE] = qlens[s] - qs;
            r[R_REV] = 1 - r[R_REV];
        }
    }

    // emit text: per segment, original-orientation sequences
    // (the mapping-orientation nt4 must be re-derived for flipped segs so
    // cs/MD sees read-orientation bases)
    std::vector<uint8_t> qa_orig0, qa_orig1;
    const uint8_t* qa_o[2] = {qa0, qa1};
    if (flip0) {
        qa_orig0.resize(qlen0);
        for (int64_t i = 0; i < qlen0; ++i) {
            uint8_t b = qa0[qlen0 - 1 - i];
            qa_orig0[i] = b < 4 ? (uint8_t)(3 - b) : 4;
        }
        qa_o[0] = qa_orig0.data();
    }
    if (flip1) {
        qa_orig1.resize(qlen1);
        for (int64_t i = 0; i < qlen1; ++i) {
            uint8_t b = qa1[qlen1 - 1 - i];
            qa_orig1[i] = b < 4 ? (uint8_t)(3 - b) : 4;
        }
        qa_o[1] = qa_orig1.data();
    }

    constexpr int64_t F_NO_PRINT_2ND = 0x4000;
    int64_t oflag = opt[0];
    TextOut o{out_text, text_cap};
    int64_t n_lines = 0;
    bool line_of = false;   // distinct from o.of: the caller must know
    auto start_line = [&]() {               // WHICH buffer to grow
        if (n_lines + 1 >= line_cap) { line_of = true; return; }
        line_off[n_lines++] = o.pos;
    };
    const char* seqs[2] = {seq0, seq1};
    const char* quals[2] = {qual0, qual1};
    const char* coms[2] = {com0, com1};
    int64_t com_lens[2] = {com0_len, com1_len};
    const char* names[2] = {name0, name1};
    int64_t name_lens[2] = {name0_len, name1_len};
    for (int s = 0; s < 2; ++s) {
        Ctx ce;
        ce.S = S; ce.seq_off = seq_off; ce.seq_len = seq_len;
        ce.n_seq = n_seq;
        ce.qlen = qlens[s];
        ce.flag = oflag;
        EmitCtx e;
        e.c = &ce;
        e.qname = names[s];        // per-seg (stripped for SAM, full for PAF)
        e.qname_len = name_lens[s];
        (void)qname; (void)qname_len;
        e.seq = seqs[s]; e.qual = quals[s];
        e.comment = coms[s]; e.comment_len = com_lens[s];
        e.rg_id = rg_id; e.rg_len = rg_len;
        e.rnames = rnames; e.rname_off = rname_off;
        e.qa = qa_o[s];
        // the other segment's first sam_pri region
        const NatReg* r_next = nullptr;
        for (auto& rr : *regss[1 - s])
            if (rr[R_SAMPRI]) { r_next = &rr; break; }
        for (int64_t j = 0; j < (int64_t)regss[s]->size(); ++j) {
            const NatReg& r = (*regss[s])[j];
            if ((oflag & F_NO_PRINT_2ND) && r[R_ID] != r[R_PARENT])
                continue;
            start_line();
            if (sam_mode) emit_sam_pe(o, e, *regss[s], j, r_next, s, oflag);
            else emit_paf(o, e, r, oflag);
        }
        if (regss[s]->empty() && sam_mode) {
            start_line();
            emit_sam_pe(o, e, *regss[s], -1, r_next, s, oflag);
        }
    }
    line_off[n_lines] = o.pos;
    if (line_of) return -3;   // line_off capacity
    if (o.of) return -2;       // text capacity
    return n_lines;
}

}  // extern "C"
