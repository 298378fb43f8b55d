// The staged path's native finish: the back half of each unit (regions,
// chain_post, est_err, pe seg_gen, the align skeleton, mapq, pairing) run
// by the native driver's own code from the card's chains, with every
// extension job answered from a table that the card's ksw2 kernels fill
// (models/replay.py drives it).
//
// A batch holds its units. Each round makes one pass over the live units:
// every extension call (run_ext) looks its job up in the unit's table.
// A hit returns the card's result; a miss records the job and returns a
// placeholder (no CIGAR, not z-dropped, so no z-drop re-run follows), and
// the pass goes on, so one pass records the left extension, the fills and
// the right extension of every region of both mates: none of them depends
// on another's result. A pass with a miss is thrown away whatever its
// output; the caller runs the recorded jobs on the card and puts their
// results into the tables. A unit is finished by a pass with no miss; a
// z-drop re-run, a split region or an inversion rescue shows up as a miss
// of a later pass. A pass with no miss that breaks the driver's contract
// (its `bad` flag) declines the unit, which the caller then finishes with
// the Python generators. Each pass repeats the unit's non-extension work
// (microseconds), so the driver's control flow is the driver's.
//
// A table's key is the job itself (the query and target bases and w,
// zdrop, end_bonus, flag): the result is a function of the key, so a hit
// is exact whichever region or pass asks. Jobs with an empty side run in
// place (they do no DP).
#include "align_driver.cc"

#include <memory>
#include <string>
#include <unordered_map>

namespace {

constexpr int KEY_HEAD = 6;   // ql, tl, w, zdrop, end_bonus, flag
constexpr int OPT_N = 34;     // the driver's opt layout (native.py)

struct Replay {
    std::unordered_map<std::string, int64_t> slot;  // job key -> index
    std::vector<std::string> key;
    std::vector<char> have;
    std::vector<EzOut> ez;
    std::vector<std::vector<uint32_t>> cig;
    std::vector<int64_t> fresh;   // recorded in this pass
    bool missed = false;
};

static bool replay_ext(Replay& rp, const uint8_t* qs, int64_t ql,
                       const uint8_t* ts, int64_t tl, int64_t w,
                       int64_t zdrop, int64_t end_bonus, int64_t flag,
                       EzOut& ez, std::vector<uint32_t>& cig) {
    if (ql <= 0 || tl <= 0) return false;
    int64_t head[KEY_HEAD] = {ql, tl, w, zdrop, end_bonus, flag};
    std::string k(sizeof(head) + ql + tl, '\0');
    memcpy(&k[0], head, sizeof(head));
    memcpy(&k[sizeof(head)], qs, ql);
    memcpy(&k[sizeof(head) + ql], ts, tl);
    auto it = rp.slot.find(k);
    if (it != rp.slot.end() && rp.have[it->second]) {
        ez = rp.ez[it->second];
        cig = rp.cig[it->second];
        return true;
    }
    if (it == rp.slot.end()) {
        int64_t i = (int64_t)rp.key.size();
        rp.slot.emplace(k, i);
        rp.key.push_back(std::move(k));
        rp.have.push_back(0);
        rp.ez.emplace_back();
        rp.cig.emplace_back();
        rp.fresh.push_back(i);
    }
    rp.missed = true;
    ez = EzOut{0, 0, -1, -1, KSW_NEG_INF, -1, KSW_NEG_INF, -1, KSW_NEG_INF,
               0, 0};
    cig.clear();
    return true;
}

static bool replay_missed(const Replay* rp) { return rp && rp->missed; }

struct Unit {
    int64_t n_segs = 1, qlens[2] = {0, 0};
    std::vector<uint8_t> qa[2], qr[2];   // mapping orientation, revcomp
    uint64_t hash = 0;
    int64_t rep_len = 0, gap_ref = 0, n_v = 0, n_u = 0;
    std::vector<uint64_t> a, u, mini;
    Replay rp;
    int state = 0;                       // 0 live, 1 finished, -1 declined
    std::vector<NatReg> out[2];
};

struct Batch {
    const uint8_t* S;
    const int64_t* seq_off;
    const int64_t* seq_len;
    int64_t n_seq;
    int32_t k, hpc;
    int8_t mat[25];
    int64_t opt[OPT_N];
    double optf[3];
    std::vector<std::unique_ptr<Unit>> units;
    std::vector<std::pair<Unit*, int64_t>> pass_jobs;  // (unit, slot)
};

static void set_ctx(Ctx& c, const Batch& b, const int64_t* opt) {
    c.S = b.S; c.seq_off = b.seq_off; c.seq_len = b.seq_len;
    c.n_seq = b.n_seq; c.k = b.k; c.hpc = b.hpc != 0;
    c.mat = b.mat;
    c.flag = opt[0]; c.oa = opt[1]; c.ob = opt[2]; c.q = opt[3];
    c.e = opt[4]; c.q2 = opt[5]; c.e2 = opt[6]; c.zdrop = opt[7];
    c.zdrop_inv = opt[8]; c.end_bonus = opt[9]; c.min_cnt = opt[10];
    c.min_chain_score = opt[11]; c.min_dp_max = opt[12];
    c.max_gap = opt[13]; c.bw = opt[14]; c.min_ksw_len = opt[15];
    c.noncan = opt[30]; c.anchor_ext_len = opt[31];
    c.anchor_ext_shift = opt[32];
}

// one segment: finish_unit_core (models/pipeline.finish_unit_gen, n_segs 1)
static int64_t finish_one(const Batch& b, Unit& un) {
    if (un.qlens[0] <= 0 || un.n_u <= 0 || un.n_v <= 0) return 0;
    Ctx c;
    std::vector<uint8_t> qrev;
    std::vector<uint64_t> a(un.a);       // seed flags are set in place
    return finish_unit_core(un.qa[0].data(), un.qlens[0], un.hash, b.S,
                            b.seq_off, b.seq_len, b.n_seq, b.k, b.hpc,
                            b.mat, b.opt, b.optf, un.rep_len,
                            un.mini.data(), (int64_t)un.mini.size(), a,
                            un.n_v, un.u.data(), un.n_u, c, un.out[0], qrev);
}

// two segments: the back half of mm2tpu_map_frag_pe from the chains
// (models/pipeline.finish_unit_gen, n_segs 2)
static int64_t finish_pair(const Batch& b, Unit& un) {
    if (un.n_u <= 0 || un.n_v <= 0) return 0;
    int64_t opt[OPT_N];
    memcpy(opt, b.opt, sizeof(opt));
    opt[17] = un.gap_ref;
    const bool is_sr = opt[0] & F_SR, do_align = opt[25];
    const double mask_level = b.optf[0], pri_ratio = b.optf[1],
                 max_clip = b.optf[2];
    Ctx c0;
    set_ctx(c0, b, opt);
    std::vector<uint64_t> a(un.a);
    c0.A = a.data(); c0.n_a = un.n_v;
    c0.qlen = un.qlens[0] + un.qlens[1];
    int64_t sub_diff = 2 * c0.oa + c0.ob;
    std::vector<NatReg> regs0 = gen_regs(c0, un.hash, un.u.data(), un.n_u);
    if (!opt[27]) {
        set_parent(regs0, mask_level, sub_diff);
        select_sub_multi(regs0, pri_ratio, 0.2, 0.7, opt[17],
                         2 * (int64_t)b.k, opt[20], 2, un.qlens);
        if (!opt[26])
            join_long(c0, regs0, opt[21], opt[22], opt[23], c0.min_cnt,
                      c0.min_chain_score, c0.min_dp_max, max_clip);
    }
    if (!is_sr)
        est_err_nat(c0, regs0, un.mini.data(), (int64_t)un.mini.size());
    std::vector<std::vector<uint64_t>> seg_a;
    std::vector<std::vector<NatReg>> seg_regs;
    seg_gen(c0, un.hash, 2, un.qlens, regs0, seg_regs, seg_a);
    for (int s = 0; s < 2; ++s) {
        Ctx cs;
        set_ctx(cs, b, opt);
        cs.A = seg_a[s].data();
        cs.n_a = (int64_t)seg_a[s].size() / 2;
        cs.qlen = un.qlens[s];
        cs.qstr[0] = un.qa[s].data();
        cs.qstr[1] = un.qr[s].data();
        std::vector<NatReg>& rs_ = seg_regs[s];
        set_parent(rs_, mask_level, sub_diff);
        if (do_align) {
            cs.n_a = squeeze_a_nat(cs, rs_);
            if (skeleton_loop(cs, rs_, cs.min_cnt, cs.min_chain_score,
                              cs.min_dp_max, max_clip) < 0)
                return -1;
            if (!opt[27]) {
                set_parent(rs_, mask_level, sub_diff);
                select_sub(rs_, pri_ratio, 2 * (int64_t)b.k, opt[20]);
                set_sam_pri(rs_);
            }
        }
        set_mapq_nat(rs_, cs.min_chain_score, cs.oa, un.rep_len, is_sr);
    }
    std::vector<NatReg>* regss[2] = {&seg_regs[0], &seg_regs[1]};
    if (opt[28] >= 0 && do_align)
        pair_pe(opt[17], opt[29], sub_diff, c0.oa, un.qlens, regss);
    un.out[0] = std::move(seg_regs[0]);
    un.out[1] = std::move(seg_regs[1]);
    return 0;
}

static void pass_unit(Batch& b, Unit& un) {
    Replay& rp = un.rp;
    rp.missed = false;
    rp.fresh.clear();
    un.out[0].clear();
    un.out[1].clear();
    g_replay = &rp;
    int64_t rc = un.n_segs == 1 ? finish_one(b, un) : finish_pair(b, un);
    g_replay = nullptr;
    for (int64_t i : rp.fresh) b.pass_jobs.emplace_back(&un, i);
    if (rp.missed) return;
    un.state = rc < 0 ? -1 : 1;
    if (un.state < 0) {
        un.out[0].clear();
        un.out[1].clear();
    }
}

}  // namespace

extern "C" {

// A batch over an index (S, seq_off, seq_len: kept alive by the caller)
// and the driver's opt layout (native.py, 34 int64 + 3 double).
void* mm2tpu_replay_open(const uint8_t* S, const int64_t* seq_off,
                         const int64_t* seq_len, int64_t n_seq, int32_t k,
                         int32_t hpc, const int8_t* mat, const int64_t* opt,
                         const double* optf) {
    Batch* b = new Batch();
    b->S = S; b->seq_off = seq_off; b->seq_len = seq_len; b->n_seq = n_seq;
    b->k = k; b->hpc = hpc;
    memcpy(b->mat, mat, sizeof(b->mat));
    memcpy(b->opt, opt, sizeof(b->opt));
    memcpy(b->optf, optf, sizeof(b->optf));
    return b;
}

void mm2tpu_replay_close(void* h) { delete (Batch*)h; }

// Add a unit of 1 or 2 segments (nt4, mapping orientation) with its chains
// (a: n_v interleaved anchors, u: n_u chains), its mini_pos, rep_len and
// max_chain_gap_ref. Returns the unit's index.
int64_t mm2tpu_replay_add(void* h, int64_t n_segs, const uint8_t* qa0,
                          int64_t ql0, const uint8_t* qa1, int64_t ql1,
                          uint64_t hash, const uint64_t* a, int64_t n_v,
                          const uint64_t* u, int64_t n_u,
                          const uint64_t* mini, int64_t n_mini,
                          int64_t rep_len, int64_t gap_ref) {
    Batch& b = *(Batch*)h;
    auto un = std::make_unique<Unit>();
    un->n_segs = n_segs;
    const uint8_t* qa[2] = {qa0, qa1};
    int64_t ql[2] = {ql0, ql1};
    for (int64_t s = 0; s < n_segs; ++s) {
        un->qlens[s] = ql[s];
        un->qa[s].assign(qa[s], qa[s] + ql[s]);
        un->qr[s].resize(ql[s]);
        for (int64_t i = 0; i < ql[s]; ++i) {
            uint8_t x = qa[s][ql[s] - 1 - i];
            un->qr[s][i] = x < 4 ? (uint8_t)(3 - x) : 4;
        }
    }
    un->hash = hash;
    un->n_v = n_v;
    un->n_u = n_u;
    un->a.assign(a, a + 2 * n_v);
    un->u.assign(u, u + n_u);
    un->mini.assign(mini, mini + n_mini);
    un->rep_len = rep_len;
    un->gap_ref = gap_ref;
    b.units.push_back(std::move(un));
    return (int64_t)b.units.size() - 1;
}

// One pass over the live units. Returns the jobs recorded; *bases: their
// query plus target bases.
int64_t mm2tpu_replay_pass(void* h, int64_t* bases) {
    Batch& b = *(Batch*)h;
    b.pass_jobs.clear();
    for (auto& un : b.units)
        if (un->state == 0) pass_unit(b, *un);
    *bases = 0;
    for (auto& [un, i] : b.pass_jobs)
        *bases += (int64_t)un->rp.key[i].size()
            - KEY_HEAD * (int64_t)sizeof(int64_t);
    return (int64_t)b.pass_jobs.size();
}

// The last pass's jobs: bases (query then target per job) into seq_buf,
// rows {qoff, qlen, toff, tlen, w, zdrop, end_bonus, flag} into meta.
void mm2tpu_replay_jobs(void* h, uint8_t* seq_buf, int64_t* meta) {
    Batch& b = *(Batch*)h;
    int64_t pos = 0;
    for (size_t j = 0; j < b.pass_jobs.size(); ++j) {
        auto& [un, i] = b.pass_jobs[j];
        const std::string& k = un->rp.key[i];
        int64_t head[KEY_HEAD];
        memcpy(head, k.data(), sizeof(head));
        int64_t n = head[0] + head[1];
        memcpy(seq_buf + pos, k.data() + sizeof(head), n);
        int64_t* m = meta + 8 * j;
        m[0] = pos; m[1] = head[0]; m[2] = pos + head[0]; m[3] = head[1];
        m[4] = head[2]; m[5] = head[3]; m[6] = head[4]; m[7] = head[5];
        pos += n;
    }
}

// Results of the last pass's jobs, in order: ez rows {max, zdropped,
// max_q, max_t, mqe, mqe_t, mte, mte_q, score, reach_end, n_cigar}, job j's
// CIGAR at cig[cig_off[j]:cig_off[j] + n_cigar].
void mm2tpu_replay_put(void* h, const int64_t* ez_rows,
                       const int64_t* cig_off, const uint32_t* cig) {
    Batch& b = *(Batch*)h;
    for (size_t j = 0; j < b.pass_jobs.size(); ++j) {
        auto& [un, i] = b.pass_jobs[j];
        const int64_t* r = ez_rows + 11 * j;
        un->rp.ez[i] = EzOut{r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7],
                             r[8], r[9], r[10]};
        un->rp.cig[i].assign(cig + cig_off[j], cig + cig_off[j] + r[10]);
        un->rp.have[i] = 1;
    }
    b.pass_jobs.clear();
}

// Per unit {state (1 finished, -1 declined, 0 live), regions of segment 0,
// regions of segment 1, CIGAR words}.
void mm2tpu_replay_sizes(void* h, int64_t* out) {
    Batch& b = *(Batch*)h;
    for (size_t x = 0; x < b.units.size(); ++x) {
        Unit& un = *b.units[x];
        int64_t* o = out + 4 * x;
        o[0] = un.state;
        o[1] = (int64_t)un.out[0].size();
        o[2] = (int64_t)un.out[1].size();
        o[3] = 0;
        for (int s = 0; s < 2; ++s)
            for (auto& r : un.out[s]) o[3] += (int64_t)r.cigar.size();
    }
}

// The finished units' regions, unit by unit and segment by segment, in the
// layout of mm2tpu_align_skeleton (28 int64 rows, 7 int64 extras whose
// CIGAR offsets index the whole cig_buf).
void mm2tpu_replay_take(void* h, int64_t* regs_out, int64_t* extras_out,
                        uint32_t* cig_buf) {
    Batch& b = *(Batch*)h;
    int64_t n = 0, cpos = 0;
    for (auto& un : b.units) {
        for (int s = 0; s < 2; ++s) {
            for (auto& r : un->out[s]) {
                memcpy(regs_out + n * RF, r.f, RF * 8);
                int64_t* ex = extras_out + n * 7;
                ex[0] = r.dp_score; ex[1] = r.dp_max; ex[2] = r.dp_max2;
                ex[3] = r.n_ambi; ex[4] = r.trans_strand;
                ex[5] = cpos; ex[6] = (int64_t)r.cigar.size();
                memcpy(cig_buf + cpos, r.cigar.data(), ex[6] * 4);
                cpos += ex[6];
                ++n;
            }
        }
    }
}

}  // extern "C"
