// ksw2 extension on the card, hand-written for Hopper (sm_90a): the
// anti-diagonal dual-affine DP (extd2 mode) and its splice mode (exts2),
// bit-exact with the reference's SSE build, plus the CIGAR backtrack walk.
//
// Replaces minimap2_chaindp_tpu/ops/ksw2_pallas.py:_ksw_kernel (:238, the
// forward pass: ksw_forward_smem_kernel, and ksw_forward_kernel with its
// rows in device memory) and :_fused_walk (:90, the walk: ksw_walk_kernel).
//
// Contract: the numpy models ops/ksw2.extd2 and ops/ksw2_splice.exts2.  Per
// job and anti-diagonal r the kernels keep the reference's difference rows
// u, v, x, y, x2, y2 as real int8 (every sum wraps as the SSE lanes do), the
// score row s, and the exact-score row H as int32.  Lanes are computed over
// the 16-aligned band [st, en], not the live [st0, en0], and read stale
// values outside it; scores s[] are written in 16-lane blocks from st0.  The
// H row's maximum breaks ties in the reference's order (en0 first, then the
// lane-of-4 columns of [st0, en1), then the scalar tail), written here as a
// scan key.  Each job's backtrack bytes go straight into the reference's
// flat layout (row stride n_col, ksw2_extd2_sse.c:98-100), row r before row
// r+1.  The walk replays ksw_backtrack (ksw2.h:119-151) over those bytes
// from the corner ksw2_pallas.py:127-137 picks, and writes one int8 step
// code per step and fin (i, j, k) into the ez row.
//
// What bounds them on this card: not bytes (one backtrack byte out per
// cell) and not arithmetic (55 integer operations a cell in extd2 mode and
// 47 in exts2 mode, as chip_smoke.py counts them for the bound: what the
// recurrence needs on int8 lanes, without the sign extensions that int8
// in int32 registers costs here), but chains of dependent steps.  Row r
// needs row r-1, so a forward job is qlen + tlen - 1 dependent rows of at
// most one band, and a launch waits for its longest job; a walk is one
// dependent read of p per step.  What counts is the latency of one step
// and how many independent jobs the 132 SMs hold at once.
//
// What the forward design does about it (ksw_forward_smem_kernel):
// - The rows live in shared memory, as a ring of `ring` lanes per job
//   (lane t in slot t & (ring - 1), 14 bytes a lane), sized by the job's
//   band and not by its target: an unbanded splice job over an 8 kb
//   intron with a 200-base query needs 256 lanes, not 8 k.  The ring
//   needs no clearing: a lane of u, y, y2, x, v, x2 is read only where
//   the previous row wrote it ([last_st, last_en]); elsewhere the value
//   the reference would find is the initial one, because st and en never
//   fall.  Only s is read from older rows, and the ring is wider than
//   [st, hi], so those slots are still the lane's own; lanes above every
//   s block so far read 0.
// - One barrier a row.  x, v and x2, which lane t + 1 reads shifted, are
//   double-buffered by row parity, so nobody waits between reading and
//   writing; the values every thread needs after the row (H at en0, st0
//   and en0 - 1, the approximate path's v[h0t] and u[h0t + 1]) are
//   published by their lanes into a small parity-buffered record before
//   that barrier instead of being read back from the rows after it.
// - A block per job, half a ring of threads, 64 to 512 (more threads cost
//   every row more than the passes they save), rings up to 16384 lanes
//   (224 KB of dynamic shared memory).  The row's maximum is two
//   warp-reduce instructions, one shared stage and two more; the scan key
//   carries the lane's offset from st0, so the winner needs no division,
//   and the offset is bounded by the band, not by the target: a job of any
//   target length whose ring fits takes this form.  A call is one
//   launch with the ring of its widest job: a narrow job's block takes
//   the same shared memory, which costs occupancy only where rings are
//   wide, and launches by ring size measured slower (every launch that
//   shares the longest job's SM slows it).  A warp per job with
//   __syncwarp() only, several jobs a block, was built and measured: ahead
//   on a synthetic short-read wave, behind the block form on the real
//   one (PERF.md section 6), so it is not kept.
// - Longest first: blocks take jobs through an order array sorted by rows,
//   so the longest chain of rows starts at once.
// What is left: a wide band is bound by the instruction issue of the one
// SM that runs its job (some 150 instructions a lane); spreading a job
// over a thread-block cluster, or packing lanes in a register, is later
// work.
// ksw_forward_kernel keeps the rows in device memory, one block per job,
// two barriers per 512-lane chunk: it serves jobs whose ring exceeds
// shared memory (the shorter sequence over 16352 bases), chosen by size.
// Its scan key keeps the lane t itself in the tail (2^28 + t), which holds
// targets of up to 2^31 - 2^28 lanes.
//
// ksw_splice_signal_kernel computes an exts2 wave's donor/acceptor signal
// (ops/ksw2_pack.py:donor_acceptor, ksw2_exts2_sse.c:112-131) from the
// targets already on the card, which the host once built job by job.  It
// replaces no TPU kernel.  Bound by bytes: a six-base stencil, three reads
// of the job's own target for each of 2 bytes written; a block per job,
// threads striding over the job's slot, the slack included.
//
// What the walk design does: a warp per job.  32 steps move at most 64
// rows down and 32 columns left, so the warp fetches that 64 x 32 window
// of p in one round of independent coalesced loads into shared memory,
// runs up to 32 steps of the state machine from there (every lane alike,
// lane k keeping step k's code), and writes the codes as one coalesced
// store.  Dependent round trips to device memory fall 32-fold.
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>
#include <mutex>

namespace {

constexpr int kNegInf = -0x40000000;  // KSW_NEG_INF
constexpr int kMaxThreads = 512;
constexpr int kLaneBytes = 14;    // shared-memory bytes per ring lane
constexpr int kSmemMax = 16384 * kLaneBytes;  // the widest ring: 224 KB
constexpr int kWalkWarps = 4;     // jobs per block in the walk
constexpr int kWalkRows = 64;     // window of p the walk fetches at once
constexpr int kWalkCols = 32;
constexpr int kMetaCols = 16;
constexpr int kEzCols = 24;
constexpr int kTailKey = 0x10000000;  // scan key of the scalar tail lanes
// the shared-memory forms' scan key: the place in the reference's scan
// order above the lane's offset t - st0 from the row's first live lane, so
// that the winner's lane needs no division.  The offset lies within the
// job's band, so within its ring of at most 16384 lanes, below 2^15
// whatever the target's length; places stay below 2^15 too (a row's
// lane-of-4 columns number fewer than its ring's lanes), so keys stay
// below 2^30
constexpr int kKeyLaneBits = 15;
constexpr int kKeyLaneMask = (1 << kKeyLaneBits) - 1;
constexpr int kTailOrder = kKeyLaneMask;  // after every lane-of-4 column

// meta columns (ops/ksw2_pack.py)
enum {
  M_QLEN, M_TLEN, M_W, M_ZDROP, M_RIGHT, M_APPROX, M_ADROP, M_EXTZ,
  M_SCONLY, M_ENDB, M_NCOL, M_TOFF, M_QOFF, M_OPOFF, M_LANES, M_SPLICE
};
// ops/ksw2_pack.py T_PAD: each job's target slot is tlen16 + kTPad bytes
constexpr int kTPad = 32;
constexpr int kSignalThreads = 256;
// ksw2.h's splice flags (meta[M_SPLICE])
constexpr int kSpliceFor = 0x100, kSpliceRev = 0x200, kSpliceFlank = 0x400;
// ez columns (ops/ksw2_pack.py C_*)
enum {
  C_MAX = 2, C_MAX_T, C_MAX_Q, C_MQE, C_MQE_T, C_MTE, C_MTE_Q, C_SCORE,
  C_ZDROP
};
constexpr int C_FIN_I = 20, C_FIN_J = 21, C_FIN_K = 22;

struct Scoring {
  int q, e, q2, e2, mat0, sc_mis, sc_n, long_thres, long_diff;
};

struct FwdParams {
  const uint8_t* tseq;
  const uint8_t* qrev;
  const int16_t* dac;
  const int* meta;
  const long long* poff;
  const int* order;  // the launch's jobs, longest first
  int8_t* state;     // device-memory form: 7 rows of t_total
  int* hrow;         // device-memory form: t_total
  uint8_t* p;
  int* ez;
  long long t_total;
  int n_jobs;
  int ring;  // shared-memory forms: lanes per job, a power of two
  Scoring sc;
};

struct WalkParams {
  const uint8_t* p;
  const long long* poff;
  const int* meta;
  int* ez;
  const int* order;
  int8_t* ops;
  int n_jobs;
};

// int8 wraparound of an int (sign-extend the low byte)
__device__ __forceinline__ int w8(int x) {
  return static_cast<int>(static_cast<int8_t>(x));
}

// live band of diagonal r (ksw2_extd2_sse.c:131-139; exts2 is unbanded)
template <bool SPLICE>
__device__ __forceinline__ void band(int r, int qlen, int tlen, int w,
                                     int& st0, int& en0) {
  st0 = max(0, r - qlen + 1);
  en0 = min(tlen - 1, r);
  if (!SPLICE) {
    st0 = max(st0, (r - w + 1) >> 1);
    en0 = min(en0, (r + w) >> 1);
  }
}

// first-column seed (ksw2_extd2_sse.c:141-155); the splice tail is 0
template <bool SPLICE>
__device__ __forceinline__ int f_seed(int r, const Scoring& sc) {
  if (r == 0) return -(sc.q + sc.e);
  if (r < sc.long_thres) return -sc.e;
  if (r == sc.long_thres) return sc.long_diff;
  return SPLICE ? 0 : -sc.e2;
}

__device__ __forceinline__ bool better(int h, int k, int bh, int bk) {
  return h > bh || (h == bh && k < bk);
}

// Warp reduction of (H, scan key): the largest H and, among equals, the
// smallest key, in every lane.
__device__ __forceinline__ void warp_best(int& h, int& k) {
  const int top = __reduce_max_sync(0xffffffffu, h);
  k = __reduce_min_sync(0xffffffffu, h == top ? k : INT_MAX);
  h = top;
}

// values a row's lanes publish for every thread of the job (see the
// header note); one record per row parity
enum { B_HEN0, B_HST0, B_HM1, B_V0, B_U1, B_COLS = 8 };

// The forward pass with its rows in shared memory, a block per job.
template <bool SPLICE>
__global__ void __launch_bounds__(kMaxThreads)
    ksw_forward_smem_kernel(const FwdParams P) {
  extern __shared__ __align__(16) unsigned char rows_raw[];
  __shared__ int red[2][kMaxThreads / 32][2];
  __shared__ int bcast[2][B_COLS];
  const int nthr = static_cast<int>(blockDim.x);
  const int tid = static_cast<int>(threadIdx.x);
  const int wid = tid >> 5;
  const int job = P.order[blockIdx.x];
  const int ring = P.ring, mask = ring - 1;
  const Scoring sc = P.sc;
  const int* m = P.meta + static_cast<size_t>(job) * kMetaCols;
  const int qlen = m[M_QLEN], tlen = m[M_TLEN], w = m[M_W];
  const int zdrop = m[M_ZDROP];
  const int ncol = m[M_NCOL];
  const bool with_cigar = ncol > 0;
  // the reference takes the right-aligned rules only with a CIGAR
  const bool right = with_cigar && m[M_RIGHT] != 0;
  const bool approx = m[M_APPROX] != 0;
  const bool adrop = m[M_ADROP] != 0;
  const size_t toff = static_cast<size_t>(m[M_TOFF]);
  int* H = reinterpret_cast<int*>(rows_raw);
  int8_t* xb = reinterpret_cast<int8_t*>(rows_raw) + 4 * ring;  // [2][ring]
  int8_t* vb = xb + 2 * ring;
  int8_t* x2b = vb + 2 * ring;
  int8_t* u = x2b + 2 * ring;
  int8_t* y = u + ring;
  int8_t* y2 = y + ring;
  int8_t* s = y2 + ring;
  const uint8_t* sf = P.tseq + toff;
  const uint8_t* qr = P.qrev + m[M_QOFF];
  const int16_t* dac = SPLICE ? P.dac + toff : nullptr;
  uint8_t* pj = P.p + (with_cigar ? P.poff[job] : 0);

  const int qe = sc.q + sc.e, qe2 = sc.q2 + sc.e2;
  const int x2_init = SPLICE ? -sc.q2 : -qe2;
  const int zdrop_e = SPLICE ? 0 : sc.e2;

  int mx = 0, mx_t = -1, mx_q = -1, mqe = kNegInf, mqe_t = -1;
  int mte = kNegInf, mte_q = -1, score = kNegInf, zdropped = 0;
  int last_st = -1, last_en = -1, H0 = 0, h0t = 0;
  int s_top = -1;  // highest lane any score block has reached
  int prev_en0 = -1, hen0_prev = kNegInf, hm1_prev = kNegInf;
  const int nrows = qlen + tlen - 1;
  for (int r = 0; r < nrows; ++r) {
    int st0, en0;
    band<SPLICE>(r, qlen, tlen, w, st0, en0);
    if (st0 > en0) {  // the band closed
      zdropped = 1;
      break;
    }
    const int st = st0 / 16 * 16;
    const int en = (en0 + 16) / 16 * 16 - 1;
    const int par = r & 1;
    int8_t* xc = xb + par * ring;
    int8_t* vc = vb + par * ring;
    int8_t* x2c = x2b + par * ring;
    const int8_t* xp = xb + (par ^ 1) * ring;
    const int8_t* vp = vb + (par ^ 1) * ring;
    const int8_t* x2p = x2b + (par ^ 1) * ring;
    int* bc = bcast[par];
    const bool inj = en >= r;
    const int fr = f_seed<SPLICE>(r, sc);
    const int s_end = st0 + 16 * ((en0 - st0) / 16 + 1);
    const int hi = max(en, s_end - 1);
    const int qbase = qlen - 1 - r;
    const int en1 = st0 + (en0 - st0) / 4 * 4;
    const int nr4 = (en1 - st0) >> 2;
    // H of the previous row at en0 - 1 (at en0 when en0 is 0): en0 rises
    // by 0 or 1 a row, so it is one of the two values kept from that row
    const int hold_en0 =
        en0 > 0 && en0 == prev_en0 ? hm1_prev : hen0_prev;
    int best_h = INT_MIN, best_k = INT_MAX;

    for (int c_hi = hi; c_hi >= st; c_hi -= nthr) {
      const int c_lo = max(st, c_hi - nthr + 1);
      const int t = c_lo + tid;
      const bool live = t <= c_hi;
      const bool in_band = live && t <= en;
      const bool in_s = live && t >= st0 && t < s_end;
      const int sl = t & mask;
      int z = 0;
      if (in_s) {
        const int sq = sf[t], stq = qr[qbase + t];
        z = (sq == 4 || stq == 4) ? sc.sc_n
                                  : (sq == stq ? sc.mat0 : sc.sc_mis);
        s[sl] = static_cast<int8_t>(z);
      } else if (in_band) {
        z = t <= s_top ? s[sl] : 0;  // stale score lane
      }
      if (in_band) {
        // a lane the previous row did not write was never written
        const bool fresh = t >= last_st && t <= last_en;
        int ut = fresh ? u[sl] : -qe;
        int yt = fresh ? y[sl] : -qe;
        int y2t = (!SPLICE && fresh) ? y2[sl] : x2_init;
        int xt1 = -qe, x2t1 = x2_init, vt1 = -qe;
        if (t == 0) {
          vt1 = fr;
        } else if (t - 1 >= last_st && t - 1 <= last_en) {
          const int ps = (t - 1) & mask;
          xt1 = xp[ps];
          x2t1 = x2p[ps];
          vt1 = vp[ps];
        }
        if (inj && t == r) {  // boundary injection (:141-149)
          ut = fr;
          yt = -qe;
          y2t = -qe2;
        }
        const int sig = SPLICE ? dac[t] : 0;
        const int a = w8(xt1 + vt1);
        const int b = w8(yt + ut);
        const int a2 = w8(x2t1 + vt1);
        int d = 0, a2c, b2 = 0, dn = 0;
        if (SPLICE) {
          dn = w8(sig);                 // donor, low byte
          a2c = w8(a2 + w8(sig >> 8));  // intron exit pays the acceptor
        } else {
          b2 = w8(y2t + ut);
          a2c = a2;
        }
        if (!with_cigar) {
          z = max(max(z, a), max(b, a2c));
          if (!SPLICE) z = max(z, b2);
        } else if (!right) {  // left-aligned: a later state wins if greater
          d = a > z ? 1 : 0;
          z = max(z, a);
          d = b > z ? 2 : d;
          z = max(z, b);
          d = a2c > z ? 3 : d;
          z = max(z, a2c);
          if (!SPLICE) {
            d = b2 > z ? 4 : d;
            z = max(z, b2);
          }
        } else {  // right-aligned: ties go to the later state
          d = z > a ? 0 : 1;
          z = max(z, a);
          d = z > b ? d : 2;
          z = max(z, b);
          d = z > a2c ? d : 3;
          z = max(z, a2c);
          if (!SPLICE) {
            d = z > b2 ? d : 4;
            z = max(z, b2);
          }
        }
        if (!SPLICE) z = min(z, sc.mat0);  // exts2 has no match clamp
        const int un = w8(z - vt1);
        const int vn = w8(z - ut);
        const int tmp = w8(z - sc.q);
        const int ax = w8(a - tmp);
        const int bx = w8(b - tmp);
        const int a2x = w8(a2 - w8(z - sc.q2));
        const int thr = right ? -1 : 0;  // >= 0 right, > 0 left
        const bool ca = ax > thr, cb = bx > thr;
        u[sl] = static_cast<int8_t>(un);
        vc[sl] = static_cast<int8_t>(vn);
        xc[sl] = static_cast<int8_t>(w8((ca ? ax : 0) - qe));
        y[sl] = static_cast<int8_t>(w8((cb ? bx : 0) - qe));
        d |= (ca ? 0x08 : 0) | (cb ? 0x10 : 0);
        if (SPLICE) {
          // intron state: opened from H (donor-scored) or kept open
          const bool ca2 = right ? a2x >= dn : a2x > dn;
          x2c[sl] = static_cast<int8_t>(w8((ca2 ? a2x : dn) - sc.q2));
          d |= ca2 ? 0x20 : 0;
        } else {
          const int b2x = w8(b2 - w8(z - sc.q2));
          const bool ca2 = a2x > thr, cb2 = b2x > thr;
          x2c[sl] = static_cast<int8_t>(w8((ca2 ? a2x : 0) - qe2));
          y2[sl] = static_cast<int8_t>(w8((cb2 ? b2x : 0) - qe2));
          d |= (ca2 ? 0x20 : 0) | (cb2 ? 0x40 : 0);
        }
        if (with_cigar)
          pj[static_cast<size_t>(r) * ncol + (t - st)] =
              static_cast<uint8_t>(d);
        if (approx) {
          if (t == h0t) bc[B_V0] = vn;
          if (t == h0t + 1) bc[B_U1] = un;
        } else if (t >= st0 && t <= en0) {
          int hn, key;
          if (t == en0) {
            hn = r == 0 ? vn - qe
                        : (en0 > 0 ? hold_en0 + un : hold_en0 + vn);
            key = t - st0;  // place 0: en0 comes first
            bc[B_HEN0] = hn;
          } else {
            hn = H[sl] + vn;
            const int off = t - st0;
            const int place =
                t < en1 ? 1 + (off & 3) * nr4 + (off >> 2) : kTailOrder;
            key = (place << kKeyLaneBits) | off;
          }
          H[sl] = hn;
          if (t == st0) bc[B_HST0] = hn;
          if (t == en0 - 1) bc[B_HM1] = hn;
          if (better(hn, key, best_h, best_k)) {
            best_h = hn;
            best_k = key;
          }
        }
      }
    }
    // ---- the row's one barrier, and the reduction of (H, scan key): max
    // H, ties to the first lane in the reference's scan order
    if (!approx) {
      warp_best(best_h, best_k);
      if ((tid & 31) == 0) {
        red[par][wid][0] = best_h;
        red[par][wid][1] = best_k;
      }
    }
    __syncthreads();
    if (!approx) {
      // every warp reduces the warps' winners once more
      const int src = (tid & 31) < nthr / 32 ? (tid & 31) : 0;
      best_h = red[par][src][0];
      best_k = red[par][src][1];
      warp_best(best_h, best_k);
      const int max_t = st0 + (best_k & kKeyLaneMask);
      const int hen0 = bc[B_HEN0];
      const int hst0 = bc[B_HST0];
      // H at en0 - 1 after this row: written now, or left from before
      const int hm1 = en0 - 1 >= st0
                          ? bc[B_HM1]
                          : (en0 == prev_en0 ? hm1_prev : hen0_prev);
      if (en0 == tlen - 1 && hen0 > mte) {
        mte = hen0;
        mte_q = r - en;
      }
      if (r - st0 == qlen - 1 && hst0 > mqe) {
        mqe = hst0;
        mqe_t = st0;
      }
      hen0_prev = hen0;
      hm1_prev = hm1;
      // ksw_apply_zdrop (ksw2.h:160-176)
      if (best_h > mx) {
        mx = best_h;
        mx_t = max_t;
        mx_q = r - max_t;
      } else if (max_t >= mx_t && r - max_t >= mx_q) {
        const int l = abs((max_t - mx_t) - ((r - max_t) - mx_q));
        if (zdrop >= 0 && mx - best_h > zdrop + l * zdrop_e) {
          zdropped = 1;
          break;
        }
      }
      if (r == nrows - 1 && en0 == tlen - 1) score = hen0;
    } else {
      // approximate max: the greedy H0 path (:359-375); h0t stays within
      // [st0 - 1, en0], so the lanes it reads were written in this row
      if (r > 0) {
        if (st0 <= h0t && h0t <= en0 && st0 <= h0t + 1 && h0t + 1 <= en0) {
          const int d0 = bc[B_V0], d1 = bc[B_U1];
          if (d0 > d1) {
            H0 += d0;
          } else {
            H0 += d1;
            ++h0t;
          }
        } else if (st0 <= h0t && h0t <= en0) {
          H0 += bc[B_V0];
        } else {
          ++h0t;
          H0 += bc[B_U1];
        }
      } else {
        H0 = bc[B_V0] - qe;
        h0t = 0;
      }
      if (adrop) {
        if (H0 > mx) {
          mx = H0;
          mx_t = h0t;
          mx_q = r - h0t;
        } else if (h0t >= mx_t && r - h0t >= mx_q) {
          const int l = abs((h0t - mx_t) - ((r - h0t) - mx_q));
          if (zdrop >= 0 && mx - H0 > zdrop + l * zdrop_e) {
            zdropped = 1;
            break;
          }
        }
      }
      if (r == nrows - 1 && en0 == tlen - 1) score = H0;
    }
    prev_en0 = en0;
    last_st = st;
    last_en = en;
    s_top = max(s_top, s_end - 1);
  }
  if (tid == 0) {
    int* ez = P.ez + static_cast<size_t>(job) * kEzCols;
    for (int c = 0; c < kEzCols; ++c) ez[c] = 0;
    ez[C_MAX] = mx;
    ez[C_MAX_T] = mx_t;
    ez[C_MAX_Q] = mx_q;
    ez[C_MQE] = mqe;
    ez[C_MQE_T] = mqe_t;
    ez[C_MTE] = mte;
    ez[C_MTE_Q] = mte_q;
    ez[C_SCORE] = score;
    ez[C_ZDROP] = zdropped;
  }
}

// The forward pass with its rows in device memory (jobs whose ring exceeds
// shared memory): one block per job, lanes in 512-lane chunks from the top
// of the band down, every old value read before a barrier and written
// after it.
template <bool SPLICE>
__global__ void __launch_bounds__(kMaxThreads)
    ksw_forward_kernel(const FwdParams P) {
  __shared__ int red_h[kMaxThreads / 32];
  __shared__ int red_k[kMaxThreads / 32];
  const int job = P.order[blockIdx.x];
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const Scoring sc = P.sc;
  const int* m = P.meta + static_cast<size_t>(job) * kMetaCols;
  const int qlen = m[M_QLEN], tlen = m[M_TLEN], w = m[M_W];
  const int zdrop = m[M_ZDROP];
  const int ncol = m[M_NCOL];
  const bool with_cigar = ncol > 0;
  // the reference takes the right-aligned rules only with a CIGAR
  const bool right = with_cigar && m[M_RIGHT] != 0;
  const bool approx = m[M_APPROX] != 0;
  const bool adrop = m[M_ADROP] != 0;
  const size_t toff = static_cast<size_t>(m[M_TOFF]);
  const size_t T = static_cast<size_t>(P.t_total);
  int8_t* u = P.state + toff;
  int8_t* v = P.state + T + toff;
  int8_t* x = P.state + 2 * T + toff;
  int8_t* y = P.state + 3 * T + toff;
  int8_t* x2 = P.state + 4 * T + toff;
  int8_t* y2 = P.state + 5 * T + toff;
  int8_t* s = P.state + 6 * T + toff;
  int* H = P.hrow + toff;
  const uint8_t* sf = P.tseq + toff;
  const uint8_t* qr = P.qrev + m[M_QOFF];
  const int16_t* dac = SPLICE ? P.dac + toff : nullptr;
  uint8_t* pj = P.p + (with_cigar ? P.poff[job] : 0);

  const int qe = sc.q + sc.e, qe2 = sc.q2 + sc.e2;
  const int x2_init = SPLICE ? -sc.q2 : -qe2;
  const int zdrop_e = SPLICE ? 0 : sc.e2;
  const int tsz = (tlen + 15) / 16 * 16 + 32;
  for (int t = tid; t < tsz; t += nthr) {
    u[t] = v[t] = x[t] = y[t] = static_cast<int8_t>(w8(-qe));
    x2[t] = y2[t] = static_cast<int8_t>(w8(x2_init));
    s[t] = 0;
    H[t] = kNegInf;
  }
  __syncthreads();

  int mx = 0, mx_t = -1, mx_q = -1, mqe = kNegInf, mqe_t = -1;
  int mte = kNegInf, mte_q = -1, score = kNegInf, zdropped = 0;
  int last_st = -1, last_en = -1, H0 = 0, h0t = 0;
  const int nrows = qlen + tlen - 1;
  for (int r = 0; r < nrows; ++r) {
    int st0, en0;
    band<SPLICE>(r, qlen, tlen, w, st0, en0);
    if (st0 > en0) {  // the band closed
      zdropped = 1;
      break;
    }
    const int st = st0 / 16 * 16;
    const int en = (en0 + 16) / 16 * 16 - 1;
    int x1, x21, v1;
    if (st > 0) {
      if (last_st <= st - 1 && st - 1 <= last_en) {
        x1 = x[st - 1];
        x21 = x2[st - 1];
        v1 = v[st - 1];
      } else {
        x1 = -qe;
        x21 = x2_init;
        v1 = -qe;
      }
    } else {
      x1 = -qe;
      x21 = x2_init;
      v1 = f_seed<SPLICE>(r, sc);
    }
    const bool inj = en >= r;
    const int fr = f_seed<SPLICE>(r, sc);
    const int s_end = st0 + 16 * ((en0 - st0) / 16 + 1);
    const int hi = max(en, s_end - 1);
    const int qbase = qlen - 1 - r;
    const int en1 = st0 + (en0 - st0) / 4 * 4;
    const int nr4 = (en1 - st0) >> 2;
    int best_h = INT_MIN, best_k = INT_MAX;

    for (int c_hi = hi; c_hi >= st; c_hi -= nthr) {
      const int c_lo = max(st, c_hi - nthr + 1);
      const int t = c_lo + tid;
      const bool live = t <= c_hi;
      const bool in_band = live && t <= en;
      const bool in_s = live && t >= st0 && t < s_end;
      // ---- read phase: every old value this lane needs
      int z = 0, ut = 0, yt = 0, y2t = 0, xt1 = 0, x2t1 = 0, vt1 = 0;
      int hold = 0, sig = 0;
      if (in_s) {
        const int sq = sf[t], stq = qr[qbase + t];
        z = (sq == 4 || stq == 4) ? sc.sc_n
                                  : (sq == stq ? sc.mat0 : sc.sc_mis);
      } else if (in_band) {
        z = s[t];  // stale score lane
      }
      if (in_band) {
        ut = u[t];
        yt = y[t];
        if (!SPLICE) y2t = y2[t];
        if (t == st) {
          xt1 = x1;
          x2t1 = x21;
          vt1 = v1;
        } else {
          xt1 = x[t - 1];
          x2t1 = x2[t - 1];
          vt1 = v[t - 1];
        }
        if (inj && t == r) {  // boundary injection (:141-149)
          ut = fr;
          yt = -qe;
          y2t = -qe2;
        }
        if (SPLICE) sig = dac[t];
        if (!approx) {
          if (t == en0 && r > 0) hold = en0 > 0 ? H[en0 - 1] : H[en0];
          else if (t >= st0 && t < en0) hold = H[t];
        }
      }
      __syncthreads();
      // ---- write phase
      if (in_s) s[t] = static_cast<int8_t>(z);
      if (in_band) {
        const int a = w8(xt1 + vt1);
        const int b = w8(yt + ut);
        const int a2 = w8(x2t1 + vt1);
        int d = 0, a2c, b2 = 0, dn = 0;
        if (SPLICE) {
          dn = w8(sig);                 // donor, low byte
          a2c = w8(a2 + w8(sig >> 8));  // intron exit pays the acceptor
        } else {
          b2 = w8(y2t + ut);
          a2c = a2;
        }
        if (!with_cigar) {
          z = max(max(z, a), max(b, a2c));
          if (!SPLICE) z = max(z, b2);
        } else if (!right) {  // left-aligned: a later state wins if greater
          d = a > z ? 1 : 0;
          z = max(z, a);
          d = b > z ? 2 : d;
          z = max(z, b);
          d = a2c > z ? 3 : d;
          z = max(z, a2c);
          if (!SPLICE) {
            d = b2 > z ? 4 : d;
            z = max(z, b2);
          }
        } else {  // right-aligned: ties go to the later state
          d = z > a ? 0 : 1;
          z = max(z, a);
          d = z > b ? d : 2;
          z = max(z, b);
          d = z > a2c ? d : 3;
          z = max(z, a2c);
          if (!SPLICE) {
            d = z > b2 ? d : 4;
            z = max(z, b2);
          }
        }
        if (!SPLICE) z = min(z, sc.mat0);  // exts2 has no match clamp
        const int un = w8(z - vt1);
        const int vn = w8(z - ut);
        const int tmp = w8(z - sc.q);
        const int ax = w8(a - tmp);
        const int bx = w8(b - tmp);
        const int a2x = w8(a2 - w8(z - sc.q2));
        const int thr = right ? -1 : 0;  // >= 0 right, > 0 left
        const bool ca = ax > thr, cb = bx > thr;
        u[t] = static_cast<int8_t>(un);
        v[t] = static_cast<int8_t>(vn);
        x[t] = static_cast<int8_t>(w8((ca ? ax : 0) - qe));
        y[t] = static_cast<int8_t>(w8((cb ? bx : 0) - qe));
        d |= (ca ? 0x08 : 0) | (cb ? 0x10 : 0);
        if (SPLICE) {
          // intron state: opened from H (donor-scored) or kept open
          const bool ca2 = right ? a2x >= dn : a2x > dn;
          x2[t] = static_cast<int8_t>(w8((ca2 ? a2x : dn) - sc.q2));
          d |= ca2 ? 0x20 : 0;
        } else {
          const int b2x = w8(b2 - w8(z - sc.q2));
          const bool ca2 = a2x > thr, cb2 = b2x > thr;
          x2[t] = static_cast<int8_t>(w8((ca2 ? a2x : 0) - qe2));
          y2[t] = static_cast<int8_t>(w8((cb2 ? b2x : 0) - qe2));
          d |= (ca2 ? 0x20 : 0) | (cb2 ? 0x40 : 0);
        }
        if (with_cigar)
          pj[static_cast<size_t>(r) * ncol + (t - st)] =
              static_cast<uint8_t>(d);
        if (!approx && t >= st0 && t <= en0) {
          int hn, key;
          if (t == en0) {
            hn = r == 0 ? vn - qe : (en0 > 0 ? hold + un : hold + vn);
            key = 0;
          } else {
            hn = hold + vn;
            const int off = t - st0;
            key = t < en1 ? 1 + (off & 3) * nr4 + (off >> 2) : kTailKey + t;
          }
          H[t] = hn;
          if (better(hn, key, best_h, best_k)) {
            best_h = hn;
            best_k = key;
          }
        }
      }
    }
    // ---- block reduction of (H, scan key): max H, ties to the first
    // lane in the reference's scan order
    if (!approx) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const int oh = __shfl_xor_sync(0xffffffffu, best_h, o);
        const int ok = __shfl_xor_sync(0xffffffffu, best_k, o);
        if (better(oh, ok, best_h, best_k)) {
          best_h = oh;
          best_k = ok;
        }
      }
      if ((tid & 31) == 0) {
        red_h[tid >> 5] = best_h;
        red_k[tid >> 5] = best_k;
      }
    }
    __syncthreads();  // also publishes this row's u, v and H to the block
    if (!approx) {
      best_h = red_h[0];
      best_k = red_k[0];
      for (int i = 1; i < nthr / 32; ++i)
        if (better(red_h[i], red_k[i], best_h, best_k)) {
          best_h = red_h[i];
          best_k = red_k[i];
        }
      const int max_t = best_k == 0 ? en0
                        : best_k >= kTailKey
                            ? best_k - kTailKey
                            : st0 + ((best_k - 1) % nr4) * 4 +
                                  (best_k - 1) / nr4;
      const int hen0 = H[en0];
      if (en0 == tlen - 1 && hen0 > mte) {
        mte = hen0;
        mte_q = r - en;
      }
      if (r - st0 == qlen - 1 && H[st0] > mqe) {
        mqe = H[st0];
        mqe_t = st0;
      }
      // ksw_apply_zdrop (ksw2.h:160-176)
      if (best_h > mx) {
        mx = best_h;
        mx_t = max_t;
        mx_q = r - max_t;
      } else if (max_t >= mx_t && r - max_t >= mx_q) {
        const int l = abs((max_t - mx_t) - ((r - max_t) - mx_q));
        if (zdrop >= 0 && mx - best_h > zdrop + l * zdrop_e) {
          zdropped = 1;
          break;
        }
      }
      if (r == nrows - 1 && en0 == tlen - 1) score = hen0;
    } else {
      // approximate max: the greedy H0 path (:359-375)
      if (r > 0) {
        if (st0 <= h0t && h0t <= en0 && st0 <= h0t + 1 && h0t + 1 <= en0) {
          const int d0 = v[h0t], d1 = u[h0t + 1];
          if (d0 > d1) {
            H0 += d0;
          } else {
            H0 += d1;
            ++h0t;
          }
        } else if (st0 <= h0t && h0t <= en0) {
          H0 += v[h0t];
        } else {
          ++h0t;
          H0 += u[h0t];
        }
      } else {
        H0 = v[0] - qe;
        h0t = 0;
      }
      if (adrop) {
        if (H0 > mx) {
          mx = H0;
          mx_t = h0t;
          mx_q = r - h0t;
        } else if (h0t >= mx_t && r - h0t >= mx_q) {
          const int l = abs((h0t - mx_t) - ((r - h0t) - mx_q));
          if (zdrop >= 0 && mx - H0 > zdrop + l * zdrop_e) {
            zdropped = 1;
            break;
          }
        }
      }
      if (r == nrows - 1 && en0 == tlen - 1) score = H0;
    }
    last_st = st;
    last_en = en;
  }
  if (tid == 0) {
    int* ez = P.ez + static_cast<size_t>(job) * kEzCols;
    for (int c = 0; c < kEzCols; ++c) ez[c] = 0;
    ez[C_MAX] = mx;
    ez[C_MAX_T] = mx_t;
    ez[C_MAX_Q] = mx_q;
    ez[C_MQE] = mqe;
    ez[C_MQE_T] = mqe_t;
    ez[C_MTE] = mte;
    ez[C_MTE_Q] = mte_q;
    ez[C_SCORE] = score;
    ez[C_ZDROP] = zdropped;
  }
}

// A warp per job: the ksw_backtrack state machine over the flat bytes, fed
// from a window of p in shared memory (see the header note).
template <bool SPLICE>
__global__ void __launch_bounds__(kWalkWarps * 32)
    ksw_walk_kernel(const WalkParams P) {
  __shared__ uint8_t tile[kWalkWarps][kWalkRows][kWalkCols];
  __shared__ int band_st[kWalkWarps][kWalkRows];  // aligned band per row
  __shared__ int band_en[kWalkWarps][kWalkRows];
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int wid = static_cast<int>(threadIdx.x >> 5);
  const int slot = static_cast<int>(blockIdx.x) * kWalkWarps + wid;
  if (slot >= P.n_jobs) return;
  const int job = P.order[slot];
  const int* m = P.meta + static_cast<size_t>(job) * kMetaCols;
  int* ez = P.ez + static_cast<size_t>(job) * kEzCols;
  const int qlen = m[M_QLEN], tlen = m[M_TLEN], w = m[M_W];
  const int ncol = m[M_NCOL];
  const bool zdropped = ez[C_ZDROP] != 0, extz = m[M_EXTZ] != 0;
  // walk start (ksw2_pallas.py:127-137): reach_end, full, or the max
  const bool reach_end =
      !SPLICE && extz && !zdropped && ez[C_MQE] + m[M_ENDB] > ez[C_MAX];
  const bool full = !zdropped && !extz;
  const bool walk = !m[M_SCONLY] &&
                    (reach_end || full ||
                     (ez[C_MAX_T] >= 0 && ez[C_MAX_Q] >= 0));
  int i = reach_end ? ez[C_MQE_T] : (full ? tlen - 1 : ez[C_MAX_T]);
  int j = (reach_end || full) ? qlen - 1 : ez[C_MAX_Q];
  __syncwarp();  // every lane has read ez before lane 0 writes fin
  if (!walk) {
    if (lane == 0) {
      ez[C_FIN_I] = -1;
      ez[C_FIN_J] = -1;
      ez[C_FIN_K] = 0;
    }
    return;
  }
  const uint8_t* pj = P.p + P.poff[job];
  int8_t* ops = P.ops + m[M_OPOFF];
  uint8_t(*tl)[kWalkCols] = tile[wid];
  int* wst = band_st[wid];
  int* wen = band_en[wid];
  int state = 0, k = 0;
  while (i >= 0 && j >= 0) {
    // fetch rows r0 .. r0 - 63, columns i0 - 31 .. i0.  Each lane works
    // out the aligned band of two rows (an empty one for a row that does
    // not exist); then lane l takes column i0 - 31 + l of every row, one
    // coalesced load a row, all of them in flight together.
    const int r0 = i + j, i0 = i;
    const int col = i0 - (kWalkCols - 1) + lane;
#pragma unroll
    for (int dr = lane; dr < kWalkRows; dr += 32) {
      const int r = r0 - dr;
      int st0 = 0, en0 = 0;
      if (r >= 0) band<SPLICE>(r, qlen, tlen, w, st0, en0);
      wst[dr] = r >= 0 ? st0 / 16 * 16 : 1;
      wen[dr] = r >= 0 ? (en0 + 16) / 16 * 16 - 1 : 0;
    }
    __syncwarp();
    {
      uint8_t got[kWalkRows];
#pragma unroll
      for (int dr = 0; dr < kWalkRows; ++dr) {
        const int st = wst[dr], en = wen[dr];
        got[dr] = (col >= st && col <= en)
                      ? __ldg(pj + static_cast<size_t>(r0 - dr) * ncol +
                              (col - st))
                      : static_cast<uint8_t>(0);
      }
#pragma unroll
      for (int dr = 0; dr < kWalkRows; ++dr) tl[dr][lane] = got[dr];
    }
    __syncwarp();
    // up to 32 steps from the window, every lane alike
    int code = 0, n = 0;
    while (n < 32 && i >= 0 && j >= 0) {
      const int dr = r0 - (i + j);
      const int st = wst[dr], en = wen[dr];
      // the window holds 0 wherever the band has no byte, so the read
      // waits for neither st nor en
      const int tmp = tl[dr][i - i0 + (kWalkCols - 1)];
      const int force = i < st ? 2 : (i > en ? 1 : -1);
      if (state == 0)
        state = tmp & 7;
      else if (!((tmp >> (state + 2)) & 1))
        state = 0;
      if (state == 0) state = tmp & 7;
      if (force >= 0) state = force;
      if (lane == n) code = state;
      ++n;
      const bool is_m = state == 0;
      const bool is_del = state == 1 || state == 3;
      if (is_m || is_del) --i;
      if (is_m || !is_del) --j;
    }
    if (lane < n) ops[k + lane] = static_cast<int8_t>(code);
    k += n;
    __syncwarp();  // the window is read before it is fetched again
  }
  if (lane == 0) {
    ez[C_FIN_I] = i;
    ez[C_FIN_J] = j;
    ez[C_FIN_K] = k;
  }
}

// The splice signal of job blockIdx.x over its slot [toff, toff + tlen16 +
// kTPad) of `dac`: donor (low byte) and acceptor (high byte) at each of its
// tlen16 positions, 0 in the slack.  Only the job's own bases are read: a
// donor at t < tlen - 4 reads s[t+1..t+3], an acceptor at 2 <= t < tlen
// reads s[t-2..t].
__global__ void __launch_bounds__(kSignalThreads)
    ksw_splice_signal_kernel(const uint8_t* __restrict__ tseq,
                             const int* __restrict__ meta,
                             int16_t* __restrict__ dac, int noncan) {
  const int* m = meta + static_cast<size_t>(blockIdx.x) * kMetaCols;
  const int tlen = m[M_TLEN], flag = m[M_SPLICE];
  const int tlen16 = (tlen + 15) / 16 * 16;
  const uint8_t* s = tseq + static_cast<size_t>(m[M_TOFF]);
  int16_t* out = dac + static_cast<size_t>(m[M_TOFF]);
  const bool fwd = flag & kSpliceFor, rev = flag & kSpliceRev;
  const int off = fwd || rev ? -noncan : 0;
  const int semi = flag & kSpliceFlank ? -noncan / 2 : 0;
  for (int t = threadIdx.x; t < tlen16 + kTPad; t += blockDim.x) {
    int donor = off, acceptor = off;
    if (t < tlen - 4) {  // GT (forward) or CT (reverse) at t + 1
      const int b1 = s[t + 1], b2 = s[t + 2], b3 = s[t + 3];
      if ((fwd && b1 == 2 && b2 == 3) || (rev && b1 == 1 && b2 == 3))
        donor = b3 == 0 || b3 == 2 ? 0 : semi;
    }
    if (t >= 2 && t < tlen) {  // AG (forward) or AC (reverse) ending at t
      const int b0 = s[t], b1 = s[t - 1], b2 = s[t - 2];
      if ((fwd && b1 == 0 && b0 == 2) || (rev && b1 == 0 && b0 == 1))
        acceptor = b2 == 1 || b2 == 3 ? 0 : semi;
    }
    out[t] = t < tlen16 ? static_cast<int16_t>(static_cast<uint16_t>(
                              (donor & 0xFF) | (acceptor & 0xFF) << 8))
                        : static_cast<int16_t>(0);
  }
}

// Opts the shared-memory kernel in to the most dynamic shared memory any of
// its launches asks for (kSmemMax), once per instantiation and device.  The
// attribute belongs to the kernel, not to the launch, and launches come
// from several host threads: set per launch to that launch's size, one
// thread could lower it between another's setting and its launch.
constexpr int kMaxDevices = 64;
cudaError_t allow_smem(void (*kern)(const FwdParams), int which) {
  static std::mutex mu;
  static bool done[2][kMaxDevices] = {};
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (done[which][dev]) return cudaSuccess;
  rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (rc == cudaSuccess) done[which][dev] = true;
  return rc;
}

}  // namespace

// Plain C entries bound with ctypes.  All launch on `stream` and return
// cudaGetLastError() (0 = ok).  `order` lists the launch's n_jobs job rows
// of meta, longest first; one block takes one job.  variant: 0 the rows in
// `ring` lanes of shared memory, 1 the rows in `state` and `hrow`.
// threads: the block size, a multiple of 32 up to 512.
extern "C" int mm2tpu_ksw_forward(
    const uint8_t* tseq, const uint8_t* qrev, const int16_t* dac,
    const int* meta, const long long* poff, const int* order, int8_t* state,
    int* hrow, uint8_t* p, int* ez, long long t_total, int n_jobs, int q,
    int e, int q2, int e2, int mat0, int sc_mis, int sc_n, int long_thres,
    int long_diff, int splice, int variant, int ring, int threads,
    void* stream) {
  if (n_jobs <= 0) return 0;
  if (variant < 0 || variant > 1 || threads < 32 || threads > kMaxThreads ||
      threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdParams P{tseq, qrev,  dac, meta, poff,    order,  state,
                    hrow, p,     ez,  t_total,       n_jobs, ring,
                    Scoring{q, e, q2, e2, mat0, sc_mis, sc_n, long_thres,
                            long_diff}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    if (splice)
      ksw_forward_kernel<true><<<n_jobs, threads, 0, s>>>(P);
    else
      ksw_forward_kernel<false><<<n_jobs, threads, 0, s>>>(P);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = static_cast<size_t>(ring) * kLaneBytes;
  if (ring < 32 || (ring & (ring - 1)) ||
      smem > static_cast<size_t>(kSmemMax))
    return static_cast<int>(cudaErrorInvalidValue);
  void (*kern)(const FwdParams) = splice ? ksw_forward_smem_kernel<true>
                                         : ksw_forward_smem_kernel<false>;
  const cudaError_t rc = allow_smem(kern, splice ? 1 : 0);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kern<<<n_jobs, threads, smem, s>>>(P);
  return static_cast<int>(cudaGetLastError());
}

// The splice signal of an exts2 wave's n_jobs jobs (meta rows 0..n_jobs-1)
// into `dac`, which holds every job's slot.
extern "C" int mm2tpu_ksw_splice_signal(const uint8_t* tseq, const int* meta,
                                        int16_t* dac, int n_jobs, int noncan,
                                        void* stream) {
  if (n_jobs <= 0) return 0;
  ksw_splice_signal_kernel<<<n_jobs, kSignalThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      tseq, meta, dac, noncan);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mm2tpu_ksw_walk(const uint8_t* p, const long long* poff,
                               const int* meta, const int* order, int* ez,
                               int8_t* ops, int n_jobs, int splice,
                               void* stream) {
  if (n_jobs <= 0) return 0;
  const WalkParams P{p, poff, meta, ez, order, ops, n_jobs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (n_jobs + kWalkWarps - 1) / kWalkWarps;
  if (splice)
    ksw_walk_kernel<true><<<blocks, kWalkWarps * 32, 0, s>>>(P);
  else
    ksw_walk_kernel<false><<<blocks, kWalkWarps * 32, 0, s>>>(P);
  return static_cast<int>(cudaGetLastError());
}
