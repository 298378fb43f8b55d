// ksw2 extension on the card, hand-written for Hopper (sm_90a): the
// anti-diagonal dual-affine DP (extd2 mode) and its splice mode (exts2),
// bit-exact with the reference's SSE build, plus the CIGAR backtrack walk.
//
// Replaces minimap2_chaindp_tpu/ops/ksw2_pallas.py:_ksw_kernel (forward
// pass, ksw_forward_kernel) and :_fused_walk (walk, ksw_walk_kernel).
//
// Contract: the numpy models ops/ksw2.extd2 and ops/ksw2_splice.exts2.  Per
// job and anti-diagonal r the kernel keeps the reference's difference rows
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
// What bounds it on this card: the serial dependence over anti-diagonals.
// Row r needs row r-1, so a job is (qlen + tlen - 1) dependent steps of at
// most one band (about w lanes for extd2, min(qlen, tlen) for splice); the
// per-row state is small and stays in L1/L2, so the forward pass is bound by
// the latency of a row (loads, one barrier per 512-lane chunk, one block
// reduction), not by bandwidth or arithmetic.
//
// What the design does about it: one thread block per job walks r in order
// and its threads take one lane each, in 512-lane chunks from the top of
// the band down.  Within a chunk every thread reads its old values (the
// shifted x, v, x2 at t-1 too) before a barrier and writes after it;
// chunks go downwards, so a lower chunk never reads a lane a higher one has
// written this row.  The H row's maximum is one block reduction of
// (H, scan key) per row; the scalar state (max, mqe, mte, z-drop, the
// approximate H0 path) is updated by every thread alike, so the exit on
// z-drop is uniform.  The walk is one thread per job.  Keeping the rows in
// shared memory and several jobs per block are left for later work.
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kNegInf = -0x40000000;  // KSW_NEG_INF
constexpr int kMaxThreads = 512;
constexpr int kMetaCols = 16;
constexpr int kEzCols = 24;
constexpr int kTailKey = 0x10000000;  // scan key of the scalar tail lanes

// meta columns (ops/ksw2_pack.py)
enum {
  M_QLEN, M_TLEN, M_W, M_ZDROP, M_RIGHT, M_APPROX, M_ADROP, M_EXTZ,
  M_SCONLY, M_ENDB, M_NCOL, M_TOFF, M_QOFF, M_OPOFF
};
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
  int8_t* state;  // 7 rows of t_total: u, v, x, y, x2, y2, s
  int* hrow;      // t_total
  uint8_t* p;
  int* ez;
  long long t_total;
  int n_jobs;
  Scoring sc;
};

struct WalkParams {
  const uint8_t* p;
  const long long* poff;
  const int* meta;
  int* ez;
  int8_t* ops;
  int n_jobs;
};

// int8 wraparound of an int (sign-extend the low byte)
__device__ __forceinline__ int w8(int x) { return ((x & 255) ^ 128) - 128; }

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

template <bool SPLICE>
__global__ void __launch_bounds__(kMaxThreads)
    ksw_forward_kernel(const FwdParams P) {
  __shared__ int red_h[kMaxThreads / 32];
  __shared__ int red_k[kMaxThreads / 32];
  const int job = blockIdx.x;
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

// one thread per job: the ksw_backtrack state machine over the flat bytes
template <bool SPLICE>
__global__ void ksw_walk_kernel(const WalkParams P) {
  const int job = blockIdx.x * blockDim.x + threadIdx.x;
  if (job >= P.n_jobs) return;
  const int* m = P.meta + static_cast<size_t>(job) * kMetaCols;
  int* ez = P.ez + static_cast<size_t>(job) * kEzCols;
  ez[C_FIN_I] = -1;
  ez[C_FIN_J] = -1;
  ez[C_FIN_K] = 0;
  if (m[M_SCONLY]) return;
  const int qlen = m[M_QLEN], tlen = m[M_TLEN], w = m[M_W];
  const int ncol = m[M_NCOL];
  const bool zdropped = ez[C_ZDROP] != 0, extz = m[M_EXTZ] != 0;
  // walk start (ksw2_pallas.py:127-137): reach_end, full, or the max
  const bool reach_end =
      !SPLICE && extz && !zdropped && ez[C_MQE] + m[M_ENDB] > ez[C_MAX];
  const bool full = !zdropped && !extz;
  if (!reach_end && !full && !(ez[C_MAX_T] >= 0 && ez[C_MAX_Q] >= 0))
    return;
  int i = reach_end ? ez[C_MQE_T] : (full ? tlen - 1 : ez[C_MAX_T]);
  int j = (reach_end || full) ? qlen - 1 : ez[C_MAX_Q];
  const uint8_t* pj = P.p + P.poff[job];
  int8_t* ops = P.ops + m[M_OPOFF];
  int state = 0, k = 0;
  while (i >= 0 && j >= 0) {
    const int r = i + j;
    int st0, en0;
    band<SPLICE>(r, qlen, tlen, w, st0, en0);
    const int st = st0 / 16 * 16;
    const int en = (en0 + 16) / 16 * 16 - 1;
    const int force = i < st ? 2 : (i > en ? 1 : -1);
    const int tmp =
        force >= 0 ? 0 : pj[static_cast<size_t>(r) * ncol + (i - st)];
    if (state == 0)
      state = tmp & 7;
    else if (!((tmp >> (state + 2)) & 1))
      state = 0;
    if (state == 0) state = tmp & 7;
    if (force >= 0) state = force;
    ops[k++] = static_cast<int8_t>(state);
    const bool is_m = state == 0;
    const bool is_del = state == 1 || state == 3;
    if (is_m || is_del) --i;
    if (is_m || !is_del) --j;
  }
  ez[C_FIN_I] = i;
  ez[C_FIN_J] = j;
  ez[C_FIN_K] = k;
}

}  // namespace

// Plain C entries bound with ctypes.  Both launch on `stream` and return
// cudaGetLastError() (0 = ok).  threads: the forward pass's block size, a
// multiple of 32 up to 512.
extern "C" int mm2tpu_ksw_forward(
    const uint8_t* tseq, const uint8_t* qrev, const int16_t* dac,
    const int* meta, const long long* poff, int8_t* state, int* hrow,
    uint8_t* p, int* ez, long long t_total, int n_jobs, int q, int e, int q2,
    int e2, int mat0, int sc_mis, int sc_n, int long_thres, int long_diff,
    int splice, int threads, void* stream) {
  if (n_jobs <= 0) return 0;
  if (threads < 32 || threads > kMaxThreads || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdParams P{tseq,  qrev, dac,     meta,   poff,
                    state, hrow, p,       ez,     t_total,
                    n_jobs,
                    Scoring{q, e, q2, e2, mat0, sc_mis, sc_n, long_thres,
                            long_diff}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splice)
    ksw_forward_kernel<true><<<n_jobs, threads, 0, s>>>(P);
  else
    ksw_forward_kernel<false><<<n_jobs, threads, 0, s>>>(P);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mm2tpu_ksw_walk(const uint8_t* p, const long long* poff,
                               const int* meta, int* ez, int8_t* ops,
                               int n_jobs, int splice, void* stream) {
  if (n_jobs <= 0) return 0;
  const WalkParams P{p, poff, meta, ez, ops, n_jobs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 128;
  const int blocks = (n_jobs + threads - 1) / threads;
  if (splice)
    ksw_walk_kernel<true><<<blocks, threads, 0, s>>>(P);
  else
    ksw_walk_kernel<false><<<blocks, threads, 0, s>>>(P);
  return static_cast<int>(cudaGetLastError());
}
