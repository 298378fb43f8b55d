// Chaining-DP score pass (f, p and the max_skip divergence flag) for a
// padded batch of reads, hand-written for Hopper (sm_90a).
//
// Replaces minimap2_chaindp_tpu/ops/chain_pallas.py:_chain_kernel.
//
// Contract, per read r with n = nn[r, 0] anchors and each anchor i < n:
//   candidates j lie in [stw[r, i], i); the host's window start already
//   excludes every j with another x high word or dr > max_dist_x;
//   f[i] = max(cur, span_i) with cur the best valid score f[j] + sc(i, j),
//   p[i] = the LARGEST j reaching cur when cur > span_i, else -1;
//   padded anchors (i >= n) get f = 0, p = -1;
//   the read's flag is 1 when, for some i with cur > span_i, more than
//   max_skip valid candidates lie above p[i] in the window.  The flag is
//   broadcast over the 128 columns of its row, as the TPU kernel writes it.
//
// What bounds it on this card.  Anchor i needs f[j] of every j < i, so a
// read is one chain of dependent steps, and a launch of a few hundred to a
// few thousand reads (every launch of the port's paths) lasts as long as its
// longest read's chain on an SM it shares with other reads.  The first
// design (one warp a read, everything on that chain: the global loads of
// both anchors, validity, the gap cost with its int-to-float and exponent,
// a ballot and two popcounts a step, fifteen shuffles an anchor) took
// 615-670 ns an anchor alone on the card.  The staged form below takes
// 232-241 ns an anchor for the same read alone (2046 anchors, 2.2 tiles an
// anchor; NVIDIA H100 80GB HBM3, 700.00 W, utils/chain_sweep.py), which at
// 1.98 GHz is some 210 cycles a tile: the consumer warp's 35 instructions a
// tile and 30 more an anchor, nearly each waiting for the one before, and
// the producers' 100 instructions a tile with an exposed load in each, the
// two sides level.  In a launch of 726 such reads it takes 380-450 ns: six
// blocks of eight warps share an SM's four issue ports, and every warp waits
// its turn.  A launch with far more reads than the card holds at once is
// bound by instructions issued per candidate, not by a chain: there the
// staged form's division of labour costs more instructions than it hides
// latency, and the warp form wins.  No design with one chain a read comes
// near the bound of 34-55 integer operations a candidate pair on a path's
// launch: the chain of the longest read alone (2046 steps of, going by
// instruction latencies, some 60 cycles for an add, a maximum and a warp
// reduction: 0.06 ms) is half that bound.
//
// What the design does about it.
//   Two forms, chosen by the wrapper from the reads in the launch
//   (ops/chain_dp.py:chain_form): staged up to 16 reads an SM, warp beyond.
//   Staged form, a block of eight warps a read.  The window of anchor i is
//   cut into aligned tiles of 32 candidates (lane == j % 32).  A stage is a
//   run of up to 32 anchors and up to 64 of their tiles (slots); every warp
//   plans every stage itself from stw, so the plan is never communicated.
//   Seven producer warps fill the next stage's slots while the consumer warp
//   works on this one (two buffers, one block barrier a stage): each slot
//   gets the lanes' sc(i, j) without f[j] (or with it, where f[j] is final
//   already), the ballot of valid lanes and where the consumer finds f[j].
//   The consumer does only what depends on the anchor before: f[j] from a
//   register (the newest tile) or from a ring of the newest 256 values in
//   shared memory, an add, a running maximum that keeps the largest j, and
//   per anchor ONE warp reduction.  The best j and the count of valid
//   candidates above it leave the chain as an atomic maximum on a
//   shared-memory key that is read back when the stage ends, a lane an
//   anchor, together with the stores of f, p and the flag.  All loads of the
//   consumer are shared-memory loads issued one and two slots ahead.
//   Shared memory is 20.8 KB a block whatever max_n is (up to 65536), static,
//   so there is no opt-in to a larger limit that two launching threads could
//   set against each other, and no separate form for long rows.
//   Warp form, a warp a read, four reads a block: the first design with f
//   read back from the f row (L1) instead of a shared-memory row, and two
//   warp-reduce instructions an anchor in place of the shuffles.
//
// Built, measured on the card and removed while this design was made (all
// with utils/chain_sweep.py or chip_smoke.py, forms in turns in one run):
//   blocks of 2 and 4 warps a read (4 level with 8 on sparse windows, 8 ahead
//   by 1.2-1.6x on wide cdna windows; 2 slower than one warp a read); producers
//   taking slots round robin (3-12% behind runs of consecutive slots, which
//   fetch an anchor's row of the plan once, on synthetic batches); the
//   staged form forced to 32 registers (spills; level or slower) and, in the
//   cdna and many-segment modes, to 40 or 48 (4-12% slower); an order array that hands the blocks
//   the longest read first, made by torch.sort (0.04-0.07 ms, three launches)
//   or by a one-block counting-sort prelude: 15-20% ahead on synthetic
//   batches of uneven reads, level within 2% on the largest launch of each
//   of the port's three paths and 1-3% behind on the throughput shape, so it
//   went; the first design itself, kept under its own symbol for the
//   comparisons: 1.7x, 2.6x and 1.25x behind the staged form on those three
//   launches, 1.05-1.15x behind the warp form on the throughput shape.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kLanes = 128;      // row width of nn / w1 / exc / flag
constexpr int kTbl = 2048;       // exact c_lin domain (bw < kTbl)
constexpr int kNExc = 2;         // c_lin exception slots per read
constexpr int kNegInf = -0x40000000;
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kSingleSeg = 0, kManySegs = 1, kCdna = 2 };

struct Params {
  const int* xhi;
  const int* rpos;
  const int* qpos;
  const int* span;
  const int* sid;
  const int* stw;
  const int* nn;
  const float* w1;
  const int* exc;
  int* f;
  int* p;
  int* flag;
  int n_reads;
  int max_n;
  int max_dist_x;
  int max_dist_y;
  int bw;
  int max_skip;
  int use_exc;
};

// trunc(f32(dd) * w1) with no contraction, patched by the exact exceptions
__device__ __forceinline__ int c_lin_of(int dd, float w1, const int* exc_dd,
                                        const int* exc_v) {
  int c = __float2int_rz(__fmul_rn(__int2float_rn(dd), w1));
#pragma unroll
  for (int k = 0; k < kNExc; ++k)
    if (dd == exc_dd[k]) c = exc_v[k];
  return c;
}

// sc(i, j) without f[j] (chain_pallas.py:208-232); dd < kTbl wherever a
// linear term is used, so c_lin never leaves the table domain
template <int MODE>
__device__ __forceinline__ int pair_score(int dr, int dq, int dd, bool same,
                                          int qs, float w1, const int* exc_dd,
                                          const int* exc_v) {
  const int sc = min(min(dq, dr), qs);
  const int log_dd =
      (__float_as_int(fmaxf(__int2float_rn(dd), 1.0f)) >> 23) - 127;
  const int c_lin = dd < kTbl ? c_lin_of(dd, w1, exc_dd, exc_v) : 0;
  const int pen_same = c_lin + (log_dd >> 1);
  if (MODE == kSingleSeg) return sc - pen_same;
  const int pen_other = dd >= kTbl ? log_dd : min(c_lin, log_dd);
  if (MODE == kCdna) {
    if (!same && dr == 0) return sc + 1;
    if (dr > dq || !same) return sc - pen_other;
    return sc - pen_same;
  }
  if (same) return sc - pen_same;
  if (dr == 0) return sc + 1;
  return sc - pen_other;
}

// One read's arrays and constants, the same in every thread of its block.
struct Read {
  const int* xh;
  const int* rp;
  const int* qp;
  const int* sp;
  const int* sd;
  const int* st_row;
  int n;
  float w1;
  int exc_dd[kNExc], exc_v[kNExc];
};

constexpr int kRing = 256;  // newest f values kept in shared memory
constexpr int kWarps = 8;   // of a staged block: one consumer, seven producers
constexpr int kTiles = 64;  // slots a stage buffer holds

// A stage: a run of up to 32 consecutive anchors and up to kTiles of their
// slots.  A slot is one tile, the 32 candidates j = 32 b + lane of one
// anchor's window (aligned, so lane == j % 32 always); an anchor's tiles are
// taken in ascending b, its newest tile (the one that holds i - 1) last,
// and a window longer than a stage continues in the next one.  An anchor
// with an empty window takes one slot with no valid lane.  Every warp plans
// every stage itself from stw alone (the same arithmetic on the same data),
// so the plan costs no communication.  Lane l describes anchor a + l.
struct Stage {
  int a;        // first anchor
  int t0;       // slots of anchor a that earlier stages served
  int tiles;    // slots this stage fills
  int next_a, next_t0;
  int qs;       // lane's span
  int ri, qi;   // lane's rpos and qpos (loaded by the producers only)
  int pack;     // lane's window start, clamped to [0, i] (16 bits: max_n
                // <= 65536), and above it the slots this stage serves
  int before;   // slots of the stage that belong to earlier anchors
};

__device__ __forceinline__ Stage plan_stage(const Read& rd, int a, int t0,
                                            int lane, bool producer) {
  Stage S;
  S.a = a;
  S.t0 = t0;
  const int i = a + lane;
  const bool live = i < rd.n;
  const int st = live ? min(max(rd.st_row[i], 0), i) : i;
  S.qs = live ? rd.sp[i] : 0;
  S.ri = live && producer ? rd.rp[i] : 0;
  S.qi = live && producer ? rd.qp[i] : 0;
  const int all =
      !live ? 0 : (i > st ? ((i - 1) >> 5) - (st >> 5) + 1 : 1);
  const int rem = all - (lane == 0 ? t0 : 0);
  int incl = rem;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += up;
  }
  S.before = min(incl - rem, kTiles);
  S.pack = st | (min(incl, kTiles) - S.before) << 16;
  S.tiles = min(__shfl_sync(kFull, incl, 31), kTiles);
  const int done = __popc(__ballot_sync(kFull, incl <= kTiles));
  if (done == 32) {
    S.next_a = a + 32;
    S.next_t0 = 0;
  } else {
    const int before = __shfl_sync(kFull, S.before, done);
    S.next_a = a + done;
    S.next_t0 = (done == 0 ? t0 : 0) + kTiles - before;
  }
  return S;
}

// Shared memory by 32-bit address.  The consumer's loads are placed by hand
// (each one or two slots ahead of its use), so they are written as PTX with
// explicit addresses: the compiler then neither re-derives an array's base
// in the loop nor moves a load next to its use.  Compiled by a plain C++
// compiler (no nvcc) the address is the pointer itself.
#if defined(__CUDACC__)
typedef unsigned sptr;
__device__ __forceinline__ sptr to_shared(const void* p) {
  return static_cast<sptr>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ int lds(sptr a) {
  int v;
  asm volatile("ld.shared.s32 %0, [%1];" : "=r"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ int4 lds4(sptr a) {
  int4 v;
  asm volatile("ld.shared.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a));
  return v;
}
__device__ __forceinline__ void sts(sptr a, int v) {
  asm volatile("st.shared.s32 [%0], %1;" ::"r"(a), "r"(v));
}
__device__ __forceinline__ void red_max(sptr a, unsigned v) {
  asm volatile("red.shared.max.u32 [%0], %1;" ::"r"(a), "r"(v));
}
#else
typedef uintptr_t sptr;
inline sptr to_shared(const void* p) { return reinterpret_cast<sptr>(p); }
inline int lds(sptr a) { return *reinterpret_cast<volatile int*>(a); }
inline int4 lds4(sptr a) { return *reinterpret_cast<int4*>(a); }
inline void sts(sptr a, int v) { *reinterpret_cast<volatile int*>(a) = v; }
inline void red_max(sptr a, unsigned v) {
  atomicMax(reinterpret_cast<unsigned*>(a), v);
}
#endif

// What the consumer is told about a slot, the same for all lanes.
struct __align__(16) SlotMeta {
  unsigned vm;  // ballot of the valid lanes
  int f_at;     // where the lanes' f[j] start in `ring`, in bytes
  int j0;       // 32 b
  int newest;   // -1 for the anchor's newest (last) tile, else 0
};
constexpr int kRingZero = kRing * 4;  // f_at of the zeros behind the ring

// Producer: everything of a stage that does not depend on an f the consumer
// may still be working on.  Slot q of the stage is tile b of anchor i; lane
// writes sc(i, j) without f[j] for j = 32 b + lane, kNegInf where (i, j) is
// no valid pair.  Where the whole tile lies below `final_below` (the first
// anchor of the stage the consumer is on: f is final and visible there) the
// producer adds f[j] itself.  Each producer takes a run of consecutive
// slots, so what belongs to the anchor (its row of the plan, by shuffles)
// is fetched once per anchor and run, not once per slot.
template <int MODE>
__device__ __forceinline__ void produce(const Params& P, const Read& rd,
                                        const Stage& S, int final_below,
                                        const int* f_out, int* sc_buf,
                                        SlotMeta* meta_buf, int* qs_buf,
                                        int producer, int lane) {
  const unsigned mdy_x =
      static_cast<unsigned>(min(P.max_dist_y, P.max_dist_x));
  const int share = (S.tiles + kWarps - 2) / (kWarps - 1);
  int q = producer * share;
  const int q_end = min(q + share, S.tiles);
  if (q >= q_end) return;
  // the anchor whose slots cover q: the last lane with before <= q that
  // serves a slot here; the anchors after it follow lane by lane
  int la = 31 - __clz(__ballot_sync(
      kFull, S.before <= q && (S.pack >> 16) != 0));
  int until = 0;  // first slot past anchor la's
  int i = 0, st = 0, qs = 0, ri = 0, qi = 0, xi = 0, si = 0, b = 0, b_top = 0;
  for (; q < q_end; ++q, ++b) {
    if (q >= until) {
      if (until) ++la;
      const int pack = __shfl_sync(kFull, S.pack, la);
      const int before = __shfl_sync(kFull, S.before, la);
      qs = __shfl_sync(kFull, S.qs, la);
      ri = __shfl_sync(kFull, S.ri, la);
      qi = __shfl_sync(kFull, S.qi, la);
      until = before + (pack >> 16);
      st = pack & 0xffff;
      i = S.a + la;
      b = (st >> 5) + (q - before) + (la == 0 ? S.t0 : 0);
      b_top = i <= st ? b : (i - 1) >> 5;  // an empty window: one slot
      if (MODE != kSingleSeg) {
        xi = rd.xh[i];
        si = rd.sd[i];
      }
    }
    const int j = b * 32 + lane;
    const bool newest = b == b_top;
    const bool folded = !newest && b * 32 + 31 < final_below;
    bool valid = j >= st && j < i;
    int sc = kNegInf;
    if (valid) {
      const int dr = ri - rd.rp[j];
      const int dq = qi - rd.qp[j];
      const int dd = abs(dr - dq);
      bool same = true;
      if (MODE == kSingleSeg) {
        valid = dr != 0 && static_cast<unsigned>(dq - 1) < mdy_x &&
                dd <= P.bw;
      } else {
        same = rd.sd[j] == si;
        valid = rd.xh[j] == xi && dr <= P.max_dist_x;
        valid = valid && !((same && dr == 0) || dq <= 0);
        valid = valid && !((same && dq > P.max_dist_y) || dq > P.max_dist_x);
        valid = valid && !(same && dd > P.bw);
        if (MODE == kManySegs) valid = valid && !(same && dr > P.max_dist_y);
      }
      if (valid) {
        sc = pair_score<MODE>(dr, dq, dd, same, qs, rd.w1, rd.exc_dd,
                              rd.exc_v);
        if (folded) sc += f_out[j];
      }
    }
    sc_buf[q * 32 + lane] = sc;
    const unsigned ballot = __ballot_sync(kFull, valid);
    if (lane == 0) {
      SlotMeta M;
      M.vm = ballot;
      M.f_at = newest || folded ? kRingZero : ((b * 32) & (kRing - 1)) * 4;
      M.j0 = b * 32;
      M.newest = newest ? -1 : 0;
      meta_buf[q] = M;
      qs_buf[q] = qs;
    }
  }
}

// The consumer's registers: the running maximum of the anchor it is on
// (kept across a stage boundary when a window continues), the newest f of
// each lane's residue class and the read's flag as each lane saw it.
struct Consumer {
  int i;             // the anchor being scored
  int best, best_j;  // lane's best f[j] + sc and its j (the largest on ties)
  int cnt;           // valid candidates with j' <= best_j when it was taken
  int tot;           // valid candidates in the tiles served so far
  int f_new;         // f of the newest anchor j < i with j % 32 == lane
  int flag;
};

// Consumer: the part that depends on f, one pass over the stage's slots.
// Per slot: sc and the slot's words from shared memory (loaded one and two
// slots ahead), f[j] from the lane's register for the newest tile, from
// the ring for a recent older one (a zero where the producer added f
// already), an add and a compare-select.  Per anchor ONE warp reduction
// (the maximum, so f[i]) stands between one anchor and the next.  The best
// j and the count of valid candidates above it go, from the lanes that
// reached the maximum, into keys[anchor - a] by an atomic maximum (j in
// the high half: the largest j wins) that nobody waits for; p, the flag
// and the f row are written for the stage's anchors together, a lane an
// anchor, when the stage is done.  `ring` holds kRing values and 32 zeros
// behind them.
__device__ __forceinline__ void consume(const Params& P, const Stage& S,
                                        const int* sc_buf,
                                        const SlotMeta* meta_buf,
                                        const int* qs_buf, int* ring,
                                        unsigned* keys, int* f_out,
                                        int* p_out, Consumer& C, int lane) {
  const unsigned le_mask = (2u << lane) - 1u;  // lanes with j' <= j
  sptr sc_at = to_shared(sc_buf) + lane * 4;
  sptr meta_at = to_shared(meta_buf);
  sptr qs_at = to_shared(qs_buf);
  const sptr ring_at = to_shared(ring) + lane * 4;
  const sptr keys_at = to_shared(keys) - S.a * 4;
  int4 M1 = lds4(meta_at), M2 = lds4(meta_at + 16);
  int qs1 = lds(qs_at), qs2 = lds(qs_at + 4);
  int sc1 = lds(sc_at);
  int fr1 = lds(ring_at + M1.y);
#pragma unroll 1
  for (int q = 0; q < S.tiles; ++q) {
    // x: ballot, y: f_at, z: j0, w: newest
    const int4 M = M1;
    const int sc = sc1, fr = fr1, qs = qs1;
    M1 = M2;
    qs1 = qs2;
    M2 = lds4(meta_at + 32);
    qs2 = lds(qs_at + 8);
    sc1 = lds(sc_at + 128);
    fr1 = lds(ring_at + M1.y);
    meta_at += 16;
    qs_at += 4;
    sc_at += 128;
    const int s = sc + fr + (C.f_new & M.w);
    if (s >= C.best) {  // >=: tiles ascend, a lane keeps its largest j
      C.best_j = M.z + lane;
      C.cnt = C.tot + __popc(M.x & le_mask);
    }
    C.best = max(C.best, s);
    C.tot += __popc(M.x);
    if (M.w) {
      const int i = C.i;
      const int m = __reduce_max_sync(kFull, C.best);
      if (lane == (i & 31)) {
        C.f_new = max(m, qs);
        sts(ring_at + (i & (kRing - 32)) * 4, C.f_new);
      }
      if (C.best == m)
        red_max(keys_at + i * 4, static_cast<unsigned>(C.best_j) << 16 |
                                     static_cast<unsigned>(C.tot - C.cnt));
      // an older tile's f is read from the ring by other lanes: every j
      // it can hold was stored before the last anchor of the 32 before
      // the newest tile, so one warp barrier per 32 anchors orders them
      if ((i & 31) == 31) __syncwarp();
      C.i = i + 1;
      C.best = kNegInf;
      C.best_j = -1;
      C.cnt = 0;
      C.tot = 0;
    }
  }
  // the stage's anchors that ended here, a lane each
  __syncwarp();
  const int i = S.a + lane;
  const int fi = lds(to_shared(ring) + (i & (kRing - 1)) * 4);
  const unsigned key = static_cast<unsigned>(lds(keys_at + i * 4));
  if (i < C.i) {
    const bool have = fi > S.qs;
    f_out[i] = fi;
    p_out[i] = have ? static_cast<int>(key >> 16) : -1;
    if (have && static_cast<int>(key & 0xffffu) > P.max_skip) C.flag = 1;
  }
  sts(keys_at + i * 4, 0);
  __syncwarp();
}

// Registers decide how many blocks an SM holds: left alone the compiler
// takes 55-60 a thread, four blocks an SM, 528 reads at once on 132 SMs.  The
// single-segment kernel fits 40 without a spill, six blocks an SM, and a
// launch of some 700 reads gains from being resident at once; the other two
// modes spill at 40 and run slower even at 48, so they are left alone.
template <int MODE>
__global__ void __launch_bounds__(kWarps * 32, MODE == kSingleSeg ? 6 : 1)
    chain_staged_kernel(const Params P) {
  __shared__ int sc_buf[2][(kTiles + 2) * 32];
  __shared__ SlotMeta meta_buf[2][kTiles + 2];
  __shared__ int qs_buf[2][kTiles + 2];
  __shared__ int ring[kRing + 32];
  __shared__ unsigned keys[32];
  const int lane = threadIdx.x & 31;
  // Role 0 consumes, the others produce.  A warp's scheduler (one of the
  // SM's four) follows its index in the block, so the role turns with the
  // block: with warp 0 the consumer everywhere, every consumer of an SM
  // would share one scheduler.
  const int warp = threadIdx.x / 32;
  const int r = blockIdx.x;

  const size_t row = static_cast<size_t>(r) * P.max_n;
  const size_t meta = static_cast<size_t>(r) * kLanes;
  Read rd;
  rd.xh = P.xhi + row;
  rd.rp = P.rpos + row;
  rd.qp = P.qpos + row;
  rd.sp = P.span + row;
  rd.sd = P.sid + row;
  rd.st_row = P.stw + row;
  rd.n = max(min(P.nn[meta], P.max_n), 0);
  rd.w1 = P.w1[meta];
#pragma unroll
  for (int k = 0; k < kNExc; ++k) {
    rd.exc_dd[k] = P.use_exc ? P.exc[meta + 2 * k] : -1;
    rd.exc_v[k] = P.exc[meta + 2 * k + 1];
  }
  int* f_out = P.f + row;
  int* p_out = P.p + row;

  for (int i = rd.n + static_cast<int>(threadIdx.x); i < P.max_n;
       i += kWarps * 32) {
    f_out[i] = 0;
    p_out[i] = -1;
  }
  // the zeros behind the ring; every slot's words, so that the slots the
  // consumer loads ahead of the last one it uses always point into the
  // ring
  if (warp == 0) {
    ring[kRing + lane] = 0;
    keys[lane] = 0u;
  }
  for (int k = threadIdx.x; k < 2 * (kTiles + 2); k += kWarps * 32)
    meta_buf[0][k] = SlotMeta{0u, kRingZero, 0, 0};
  __syncthreads();  // before the producers write real slots over them

  Consumer C;
  C.i = 0;
  C.best = kNegInf;
  C.best_j = -1;
  C.cnt = C.tot = C.f_new = C.flag = 0;

  // stage k is consumed from buffer k % 2 while stage k + 1 is produced
  // into the other: one block barrier a stage
  Stage cur = plan_stage(rd, 0, 0, lane, warp > 0);
  if (warp > 0 && cur.a < rd.n)
    produce<MODE>(P, rd, cur, 0, f_out, sc_buf[0], meta_buf[0],
                         qs_buf[0], warp - 1, lane);
  __syncthreads();
  for (int k = 0; cur.a < rd.n; ++k) {
    const Stage nxt =
        plan_stage(rd, cur.next_a, cur.next_t0, lane, warp > 0);
    if (warp == 0)
      consume(P, cur, sc_buf[k & 1], meta_buf[k & 1], qs_buf[k & 1], ring,
              keys, f_out, p_out, C, lane);
    else if (nxt.a < rd.n)
      produce<MODE>(P, rd, nxt, cur.a, f_out, sc_buf[(k + 1) & 1],
                           meta_buf[(k + 1) & 1], qs_buf[(k + 1) & 1],
                           warp - 1, lane);
    __syncthreads();
    cur = nxt;
  }
  if (warp == 0) {
    const int flag = __ballot_sync(kFull, C.flag) != 0;
    for (int c = lane; c < kLanes; c += 32) P.flag[meta + c] = flag;
  }
}

// The warp form: one warp a read, everything on one chain.  The 32 lanes
// split the window, each taking every 32nd candidate in descending j, and
// keep a per-lane best (score, j) and the count of valid candidates scanned
// before it; one ballot per 32 candidates keeps the running count exact.
// Per anchor two warp reductions give the maximum and the largest j that
// reaches it.  f is read back from the f row this warp writes (it stays in
// L1), ordered by one warp barrier per anchor.
constexpr int kWarpReads = 4;  // reads (warps) of a block in the warp form

template <int MODE>
__global__ void __launch_bounds__(kWarpReads * 32)
    chain_warp_kernel(const Params P) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarpReads + (threadIdx.x >> 5);
  if (r >= P.n_reads) return;  // the whole warp leaves together
  const unsigned lanes_before = (1u << lane) - 1u;  // larger j, same step

  const size_t row = static_cast<size_t>(r) * P.max_n;
  const size_t meta = static_cast<size_t>(r) * kLanes;
  Read rd;
  rd.xh = P.xhi + row;
  rd.rp = P.rpos + row;
  rd.qp = P.qpos + row;
  rd.sp = P.span + row;
  rd.sd = P.sid + row;
  rd.st_row = P.stw + row;
  rd.n = max(min(P.nn[meta], P.max_n), 0);
  rd.w1 = P.w1[meta];
#pragma unroll
  for (int k = 0; k < kNExc; ++k) {
    rd.exc_dd[k] = P.use_exc ? P.exc[meta + 2 * k] : -1;
    rd.exc_v[k] = P.exc[meta + 2 * k + 1];
  }
  int* f_out = P.f + row;
  int* p_out = P.p + row;
  const unsigned mdy_x =
      static_cast<unsigned>(min(P.max_dist_y, P.max_dist_x));

  for (int i = rd.n + lane; i < P.max_n; i += 32) {
    f_out[i] = 0;
    p_out[i] = -1;
  }

  int flag = 0;
  for (int i = 0; i < rd.n; ++i) {
    const int ri = rd.rp[i];
    const int qi = rd.qp[i];
    const int qs = rd.sp[i];
    const int st = max(rd.st_row[i], 0);
    const int xi = MODE == kSingleSeg ? 0 : rd.xh[i];
    const int si = MODE == kSingleSeg ? 0 : rd.sd[i];
    int best = kNegInf, best_j = -1, snap = 0, tot = 0;
    // warp-uniform descending walk over [st, i), 32 candidates a step
    for (int base = i - 1; base >= st; base -= 32) {
      const int j = base - lane;
      bool valid = j >= st;
      int sc = 0;
      if (valid) {
        const int dr = ri - rd.rp[j];
        const int dq = qi - rd.qp[j];
        const int dd = abs(dr - dq);
        bool same = true;
        if (MODE == kSingleSeg) {
          valid = dr != 0 && static_cast<unsigned>(dq - 1) < mdy_x &&
                  dd <= P.bw;
        } else {
          same = rd.sd[j] == si;
          valid = rd.xh[j] == xi && dr <= P.max_dist_x;
          valid = valid && !((same && dr == 0) || dq <= 0);
          valid = valid && !((same && dq > P.max_dist_y) || dq > P.max_dist_x);
          valid = valid && !(same && dd > P.bw);
          if (MODE == kManySegs) valid = valid && !(same && dr > P.max_dist_y);
        }
        if (valid)
          sc = pair_score<MODE>(dr, dq, dd, same, qs, rd.w1, rd.exc_dd,
                                rd.exc_v) +
               f_out[j];
      }
      const unsigned ballot = __ballot_sync(kFull, valid);
      // strict >: a lane keeps its first-scanned (largest-j) best
      if (valid && sc > best) {
        best = sc;
        best_j = j;
        snap = tot + __popc(ballot & lanes_before);
      }
      tot += __popc(ballot);
    }
    const int m = __reduce_max_sync(kFull, best);
    const int bj = __reduce_max_sync(kFull, best == m ? best_j : -1);
    const bool have = m > qs;
    if (lane == 0) {
      f_out[i] = have ? m : qs;
      p_out[i] = have ? bj : -1;
    }
    if (have && best == m && best_j == bj && snap > P.max_skip) flag = 1;
    __syncwarp();
  }
  flag = __ballot_sync(kFull, flag) != 0;
  for (int c = lane; c < kLanes; c += 32) P.flag[meta + c] = flag;
}

// form: 0 staged (a block a read), 1 warp (a warp a read)
template <int MODE>
cudaError_t launch(const Params& P, int form, cudaStream_t stream) {
  if (form == 0)
    chain_staged_kernel<MODE><<<P.n_reads, kWarps * 32, 0, stream>>>(P);
  else if (form == 1)
    chain_warp_kernel<MODE>
        <<<(P.n_reads + kWarpReads - 1) / kWarpReads, kWarpReads * 32, 0,
           stream>>>(P);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

// Plain C entry bound with ctypes.  mode: 0 single-seg, 1 many_segs,
// 2 cdna; form: 0 staged, 1 warp.  Launches on `stream` and returns
// cudaGetLastError() (0 = ok).
extern "C" int mm2tpu_chain_dp(const int* xhi, const int* rpos,
                               const int* qpos, const int* span,
                               const int* sid, const int* stw, const int* nn,
                               const float* w1, const int* exc, int* f, int* p,
                               int* flag, int n_reads, int max_n,
                               int max_dist_x, int max_dist_y, int bw,
                               int max_skip, int mode, int use_exc,
                               int form, void* stream) {
  if (n_reads <= 0) return 0;
  const Params P{xhi,   rpos,      qpos,       span,       sid,
                 stw,   nn,        w1,         exc,        f,
                 p,     flag,      n_reads,    max_n,      max_dist_x,
                 max_dist_y, bw,   max_skip,   use_exc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (mode) {
    case kSingleSeg: e = launch<kSingleSeg>(P, form, s); break;
    case kManySegs: e = launch<kManySegs>(P, form, s); break;
    case kCdna: e = launch<kCdna>(P, form, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
