// extd2 forward sweep (ksw2 extd2: banded DP with two affine gap costs,
// difference form) for sm_90a.
//
// Replaces the Pallas TPU kernel pansvr_tpu/ops/extd2_pallas.py
// (_fwd_kernel, launched by extd2_batch_pallas). Same global window
// convention: window row k holds target column t = o_r + k with
// o_r = clamp(floor(floor((r - w + 1) / 2) / 16) * 16 - 16, 0, t_pad - W),
// so the direction bytes dmat[b, r, k] match the Pallas layout byte for
// byte (after its (G, r, k, lane) -> (b, r, k) transpose), including the
// reference kernel's stale out-of-band state at the 16-padded band edges.
//
// What bounds it: a problem is a chain of qlen + tlen - 1 dependent
// anti-diagonal steps, each a few dozen integer ops per band cell (about
// 30 in int32) plus per-problem scalar bookkeeping (band, window, the
// diagonal max and its first column, z-drop); per cell it writes at most
// one direction byte. Counted on chip_smoke.py's 2,048 seeded problems per
// class (band cells actually swept, every dmat byte written), the least
// time is 4.5 us at 48x64/W64 (15 MB of direction bytes at 3.35 TB/s:
// byte-bound; its 3.0 M cells need 1.4 us at two cells per packed 16x2
// instruction and the SM issue rate of 132 SMs x 128 lanes x 1.98 GHz)
// and 68 us at 176x256/W256 (226 MB; its 28.5 M cells need 13 us).
// Block barriers, scalar bookkeeping repeated in every
// warp and int32 state would make it issue-bound far above that; the
// design below removes the first two and halves the third. What is left
// is issue-bound on the cell arithmetic plus the warp-uniform
// bookkeeping of each diagonal (most of the loop at W = 64), and the
// contig class (256 problems, up to 1,279 diagonals) on the latency of
// that chain. Measured times and shares of the bound are in PERF.md.
//
// Design:
// - One warp per problem, four problems per block, no block barriers.
//   Lane l owns window rows l, l + 32, l + 64, ... (row "slots"), so each
//   slot's direction-byte store is one coalesced 32-byte line, and W = 192
//   works like any multiple of 32 (64 with packed state).
// - The left neighbour (row k - 1) is one __shfl_sync per register, with
//   lane 0 taking lane 31's value of the slot before (the wrap of row 0 to
//   row W - 1 is the Pallas roll). The slide by 16 rows is a __shfl_xor
//   by 16 with a carry from the next slot. The band-left boundary value
//   (column st - 1) is the neighbour the cell at st already received
//   (st - 1 always lies in the window when st > 0, by the window-coverage
//   rule W >= w + 48 or W >= t_pad that the wrapper enforces); only the
//   cases the recurrence resets (not stale_ok, st == 0) are written in,
//   through a per-register lane mask, with no divergent branch.
// - The band, window and z-drop scalars are warp-uniform and computed once
//   per problem (the reference's floor divisions by 2 and 16 are
//   arithmetic shifts); band and real-cell membership of a slot is one
//   unsigned compare; the diagonal max and its first column are two
//   __reduce_*_sync (max of H, then min column among the lanes holding it),
//   exactly the plain version's "max, then first column attaining it".
// - The codes are staged per warp in the Pallas layout (q reversed inside
//   zero padding, t padded to t_pad), so a slot's two code bytes are shared
//   loads at fixed offsets from one per-diagonal base.
// - State: where state_fits_int8(params) holds (both profiles in use) the
//   seven difference-form values u, v, x, y, x2, y2, s are packed signed
//   16-bit pairs, two window slots per register (slots 2i and 2i + 1), run
//   through the sm_90 16x2 integer instructions (VIADD.16x2, VIMNMX.S16x2)
//   and the DPX add-max (__viaddmax_s16x2, VIADDMNMX). They stay within a
//   few hundred, so no 16-bit lane wraps; the NEG_INF extract fill never
//   enters them (every extract of v/x/x2 is the neighbour shuffle above).
//   Other profiles take the int32 instance of the same template (P = 1).
//   H (the absolute score) is int32 in both, with wrapping adds as before.
// - The direction code is derived from the max chain itself: candidate c
//   beats the running max m strictly iff max(m, c) != m, and a gap flag is
//   set iff max(a' - q - e, -q - e) != -q - e, so no compare predicate
//   semantics enter (ties go to the earlier candidate, as in the reference).
// - The kernel writes every byte of its dmat: past a problem's last
//   diagonal, its z-drop or the diagonal where its band dies, it zeroes the
//   remaining rows with 16-byte stores, so the caller allocates with
//   torch.empty.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNegInf = -0x40000000;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;   // problems (warps) per block

struct Scoring {
  int match, mismatch;    // cell scores (mismatch < 0)
  int q, e, q2, e2;       // normalized gap open/extend costs (q + e <= q2 + e2)
  int w, zdrop;           // band half-width; z-drop (< 0 disables)
  int long_thres, long_diff;
};

// int32 adds that may meet NEG_INF wrap like the reference's int32 lanes
__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

__device__ __forceinline__ int leading_gap(int r, const Scoring& p) {
  if (r == 0) return -p.q - p.e;
  if (r < p.long_thres) return -p.e;
  if (r == p.long_thres) return p.long_diff;
  return -p.e2;
}

// Lane arithmetic on one state register: P = 1 holds one int32 value,
// P = 2 two signed 16-bit values (slot 2i in the low half, 2i + 1 high).
// On sm_90 the 16x2 adds, min/max and the DPX add-max are single
// instructions (VIADD.16x2, VIMNMX.S16x2, VIADDMNMX.S16x2).
template <int P> struct Lanes;

template <> struct Lanes<1> {
  __device__ static uint32_t splat(int v) { return static_cast<uint32_t>(v); }
  __device__ static uint32_t add(uint32_t a, uint32_t b) { return a + b; }
  __device__ static uint32_t neg(uint32_t a) { return 0u - a; }
  __device__ static uint32_t vmax(uint32_t a, uint32_t b) {
    return static_cast<uint32_t>(max(static_cast<int>(a), static_cast<int>(b)));
  }
  __device__ static uint32_t vmin(uint32_t a, uint32_t b) {
    return static_cast<uint32_t>(min(static_cast<int>(a), static_cast<int>(b)));
  }
  __device__ static uint32_t max3(uint32_t a, uint32_t b, uint32_t c) {
    return static_cast<uint32_t>(__vimax3_s32(static_cast<int>(a),
                                              static_cast<int>(b),
                                              static_cast<int>(c)));
  }
  // max(a + b, c)
  __device__ static uint32_t addmax(uint32_t a, uint32_t b, uint32_t c) {
    return static_cast<uint32_t>(__viaddmax_s32(static_cast<int>(a),
                                                static_cast<int>(b),
                                                static_cast<int>(c)));
  }
  // 1 where x != 0, else 0
  __device__ static uint32_t nz(uint32_t x) { return min(x, 1u); }
  __device__ static int get(uint32_t r, int) { return static_cast<int>(r); }
  __device__ static uint32_t halves(bool lo, bool) { return lo ? ~0u : 0u; }
  // two slots' code bytes as one lane value
  __device__ static uint32_t codes(uint32_t lo, uint32_t) { return lo; }
  // the cell-score step mismatch - match, as a multiplier of a 0/1 lane
  __device__ static uint32_t score_step(int d) { return static_cast<uint32_t>(d); }
  // lane 0's left neighbour: lane 31 of the slot before (prev = that
  // register as lane 0 received it from lane 31)
  __device__ static uint32_t join(uint32_t prev, uint32_t) { return prev; }
};

template <> struct Lanes<2> {
  __device__ static uint32_t splat(int v) {
    return (static_cast<uint32_t>(v) & 0xffffu) | (static_cast<uint32_t>(v) << 16);
  }
  __device__ static uint32_t add(uint32_t a, uint32_t b) { return __vadd2(a, b); }
  __device__ static uint32_t neg(uint32_t a) { return __vadd2(~a, 0x00010001u); }
  __device__ static uint32_t vmax(uint32_t a, uint32_t b) { return __vmaxs2(a, b); }
  __device__ static uint32_t vmin(uint32_t a, uint32_t b) { return __vmins2(a, b); }
  __device__ static uint32_t max3(uint32_t a, uint32_t b, uint32_t c) {
    return __vimax3_s16x2(a, b, c);
  }
  __device__ static uint32_t addmax(uint32_t a, uint32_t b, uint32_t c) {
    return __viaddmax_s16x2(a, b, c);
  }
  __device__ static uint32_t nz(uint32_t x) { return __vminu2(x, 0x00010001u); }
  __device__ static int get(uint32_t r, int h) {
    return h ? static_cast<int>(r) >> 16
             : static_cast<int>(static_cast<int16_t>(r & 0xffffu));
  }
  __device__ static uint32_t halves(bool lo, bool hi) {
    return (lo ? 0xffffu : 0u) | (hi ? 0xffff0000u : 0u);
  }
  __device__ static uint32_t codes(uint32_t lo, uint32_t hi) {
    return __byte_perm(lo, hi, 0x1410);    // lo.byte0, 0, hi.byte0, 0
  }
  // a 0/1 pair times this is (0 or d) in each half; d < 0 and
  // match + d = mismatch, so adding the packed match never carries
  __device__ static uint32_t score_step(int d) {
    return static_cast<uint32_t>(d) & 0xffffu;
  }
  // low half: high half of the previous register (slot 2i - 1); high
  // half: low half of this one (slot 2i), both as lane 31 held them
  __device__ static uint32_t join(uint32_t prev, uint32_t cur) {
    return __byte_perm(prev, cur, 0x5432);
  }
};

__device__ __forceinline__ uint32_t blend(uint32_t nw, uint32_t old, uint32_t m) {
  return (nw & m) | (old & ~m);
}

// Window slide by 16 rows of one register array: row k takes row k + 16,
// the last 16 rows take `fill` (a splat). Lanes < 16 read lane l + 16 of
// the same slot; lanes >= 16 read lane l - 16 of the next slot.
template <int P, int NR, typename T>
__device__ __forceinline__ void slide16(T (&a)[NR], T fill, bool upper) {
  T rot[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) rot[i] = __shfl_xor_sync(kFull, a[i], 16);
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    T nxt = i + 1 < NR ? rot[i + 1 < NR ? i + 1 : i] : fill;
    if constexpr (P == 2) nxt = __byte_perm(rot[i], nxt, 0x5432);
    a[i] = upper ? nxt : rot[i];
  }
}

// left neighbour (row k - 1, row 0 wrapping to row W - 1) of every row
template <int P, int NR>
__device__ __forceinline__ void left(const uint32_t (&a)[NR], uint32_t (&nb)[NR],
                                     int src, bool lane0) {
  uint32_t rot[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) rot[i] = __shfl_sync(kFull, a[i], src);
#pragma unroll
  for (int i = 0; i < NR; ++i)
    nb[i] = lane0 ? Lanes<P>::join(rot[(i + NR - 1) % NR], rot[i]) : rot[i];
}

// per register, the lanes of window row k (warp-uniform k in the window):
// all ones in the half holding it on the lane holding it, else 0
template <int P, int NR>
__device__ __forceinline__ void row_mask(uint32_t (&m)[NR], int k, int lane) {
  const bool mine = (k & 31) == lane;
  const int slot = k >> 5;
#pragma unroll
  for (int i = 0; i < NR; ++i)
    m[i] = mine ? Lanes<P>::halves(slot == P * i, slot == P * i + P - 1) : 0u;
}

// value of slot `slot` (warp-uniform) of this lane's registers
template <int R>
__device__ __forceinline__ int slot_value(const int (&H)[R], int slot) {
  int v = H[0];
#pragma unroll
  for (int j = 1; j < R; ++j) v = slot == j ? H[j] : v;
  return v;
}

// H[row k] floored at NEG_INF for every lane; NEG_INF off-window (the
// Pallas masked-max extract). Warp-uniform k.
template <int R>
__device__ __forceinline__ int pick(const int (&H)[R], int k) {
  const int v = __shfl_sync(kFull, slot_value<R>(H, k >> 5), k & 31);
  return (k >= 0 && k < 32 * R) ? max(v, kNegInf) : kNegInf;
}

template <int P, int NR>
__global__ void __launch_bounds__(32 * kWarps) extd2_fwd_kernel(
    const uint8_t* __restrict__ qc, const int* __restrict__ qlens,
    const uint8_t* __restrict__ tc, const int* __restrict__ tlens,
    int* __restrict__ out, uint8_t* __restrict__ dmat,
    int B, int Qmax, int Tmax, int t_pad, int n_diag_pad, Scoring p) {
  using L = Lanes<P>;
  constexpr int R = NR * P;        // row slots per lane
  constexpr int W = 32 * R;
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;

  // the Pallas kernel's code layout: q reversed at q_padl inside zeros
  // (q_full), t zero-padded to t_pad; row k of diagonal r reads
  // q_full[qstart + k] and t_full[o_r + k]
  const int q_padl = t_pad + 64;
  const int q_ext = q_padl + Qmax + W;
  const int stride = (q_ext + t_pad + 15) & ~15;
  uint8_t* s_q = smem + warp * stride;
  uint8_t* s_t = s_q + q_ext;
  for (int c = 4 * lane; c < stride; c += 128)
    *reinterpret_cast<uint32_t*>(s_q + c) = 0u;
  __syncwarp();
  for (int c = lane; c < Qmax; c += 32)
    s_q[q_padl + Qmax - 1 - c] = qc[(size_t)b * Qmax + c];
  for (int c = lane; c < Tmax; c += 32) s_t[c] = tc[(size_t)b * Tmax + c];
  __syncwarp();

  const int qlen = qlens[b];
  const int tlen = tlens[b];
  const int neg1 = -p.q - p.e, neg2 = -p.q2 - p.e2;
  const uint32_t NEG1 = L::splat(neg1), NEG2 = L::splat(neg2);
  const uint32_t ZERO = L::splat(0), MATCH = L::splat(p.match);
  const uint32_t NEGE = L::splat(-p.e), NEGE2 = L::splat(-p.e2);
  const uint32_t STEP = L::score_step(p.mismatch - p.match);
  uint32_t u[NR], v[NR], x[NR], y[NR], x2[NR], y2[NR], s[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    u[i] = v[i] = x[i] = y[i] = NEG1;
    x2[i] = y2[i] = NEG2;
    s[i] = ZERO;
  }
  int H[R];
#pragma unroll
  for (int j = 0; j < R; ++j) H[j] = kNegInf;

  const bool upper = lane >= 16;
  const bool lane0 = lane == 0;
  const int src_left = (lane + 31) & 31;
  int last_st = -1, last_en = -1;
  int ez_max = 0, ez_max_q = -1, ez_max_t = -1;
  int mqe = kNegInf, mqe_t = -1, mte = kNegInf, mte_q = -1;
  int score = kNegInf, zdropped = 0;
  const int tlen_pad16 = (tlen + 15) & ~15;
  const int n_end = min(qlen + tlen - 1, n_diag_pad);  // diagonals in range
  uint8_t* drow = dmat + (size_t)b * n_diag_pad * W + lane;
  // o_r = clamp(floor((r - w + 1) / 32) * 16 - 16, 0, t_pad - W) (the two
  // floor divisions of the reference as one arithmetic shift). The Pallas
  // kernel's first "slide" at r = 0 (o_prev = -1) moves identical init
  // values, so it is skipped.
  int o_prev = min(max(((1 - p.w) >> 5) * 16 - 16, 0), t_pad - W);
  int r_stop = n_end;            // first dmat row left to zero

  for (int r = 0; r < n_end; ++r, drow += W) {
    const int o_r = min(max(((r - p.w + 1) >> 5) * 16 - 16, 0), t_pad - W);
    if (o_r != o_prev) {        // the window moved 16 columns right
      slide16<P, NR>(u, NEG1, upper);
      slide16<P, NR>(v, NEG1, upper);
      slide16<P, NR>(x, NEG1, upper);
      slide16<P, NR>(y, NEG1, upper);
      slide16<P, NR>(x2, NEG2, upper);
      slide16<P, NR>(y2, NEG2, upper);
      slide16<P, NR>(s, ZERO, upper);
      slide16<1, R>(H, kNegInf, upper);
    }
    o_prev = o_r;

    const int st0 = max(max(0, r - qlen + 1), (r - p.w + 1) >> 1);
    const int en0 = min(min(tlen - 1, r), (r + p.w) >> 1);
    if (st0 > en0) {            // band died: z-drop, nothing else changes
      zdropped = 1;
      r_stop = r;
      break;
    }
    const int st = st0 & ~15;    // st0, en0 >= 0 here
    const int en = min(((en0 + 16) & ~15) - 1, tlen_pad16 - 1);
    const int ub = leading_gap(r, p);
    // slot j of this lane is target column idx = o_r + lane + 32 j; its
    // offsets from the band starts decide real (st0..en0) and band
    // (st..en) membership with one unsigned compare each
    const int kr = o_r + lane - st0, kb = o_r + lane - st;
    const unsigned n_real = en0 - st0, n_band = en - st;
    const uint8_t* qrow = s_q + min(max(q_padl + Qmax - 1 - r + o_r, 0), q_ext - W) + lane;
    const uint8_t* trow = s_t + o_r + lane;

    // cell scores of the real cells (the packed pair: one code byte per
    // half; x != 0 -> 1 per half; match + that * (mismatch - match))
    uint32_t m_real[NR], m_band[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      bool rl[P], bd[P];
#pragma unroll
      for (int h = 0; h < P; ++h) {
        rl[h] = static_cast<unsigned>(kr + 32 * (P * i + h)) <= n_real;
        bd[h] = static_cast<unsigned>(kb + 32 * (P * i + h)) <= n_band;
      }
      m_real[i] = L::halves(rl[0], rl[P - 1]);
      m_band[i] = L::halves(bd[0], bd[P - 1]);
      const int o0 = 32 * P * i, o1 = 32 * (P * i + P - 1);   // its slots
      const uint32_t qq = L::codes(qrow[o0], qrow[o1]);
      const uint32_t tt = L::codes(trow[o0], trow[o1]);
      s[i] = blend(L::nz(qq ^ tt) * STEP + MATCH, s[i], m_real[i]);
    }
    if (en >= r) {              // top boundary (query row 0) at t = r
      uint32_t m[NR];
      row_mask<P, NR>(m, r - o_r, lane);
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        u[i] = blend(L::splat(ub), u[i], m[i]);
        y[i] = blend(NEG1, y[i], m[i]);
        y2[i] = blend(NEG2, y2[i], m[i]);
      }
    }

    // left neighbours of the OLD diagonal; the band-left boundary cell
    // keeps its neighbour (column st - 1) only when that cell was in the
    // previous band (stale_ok) and st > 0
    uint32_t nx[NR], nv[NR], nx2[NR];
    left<P, NR>(x, nx, src_left, lane0);
    left<P, NR>(v, nv, src_left, lane0);
    left<P, NR>(x2, nx2, src_left, lane0);
    const bool keep = st > 0 && st - 1 >= last_st && st - 1 <= last_en;
    if (!keep && st - o_r >= 0) {    // st - o_r < W: st <= en0 < o_r + W
      uint32_t m[NR];
      row_mask<P, NR>(m, st - o_r, lane);
      const uint32_t vb = L::splat(st > 0 ? neg1 : ub);
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        nx[i] = blend(NEG1, nx[i], m[i]);
        nx2[i] = blend(NEG2, nx2[i], m[i]);
        nv[i] = blend(vb, nv[i], m[i]);
      }
    }
    const int H_prev_en0m1 = pick<R>(H, en0 - 1 - o_r);

    uint32_t un[NR], vn[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const uint32_t a = L::add(nx[i], nv[i]), bb = L::add(y[i], u[i]);
      const uint32_t a2 = L::add(nx2[i], nv[i]), b2 = L::add(y2[i], u[i]);
      const uint32_t m1 = L::vmax(s[i], a), m2 = L::vmax(m1, bb);
      const uint32_t m3 = L::vmax(m2, a2), m4 = L::vmax(m3, b2);
      // the last candidate strictly above the running max
      uint32_t d = L::max3(L::nz(m1 ^ s[i]), L::nz(m2 ^ m1) << 1,
                           L::nz(m3 ^ m2) * 3u);
      d = L::vmax(d, L::nz(m4 ^ m3) << 2);
      const uint32_t z = L::vmin(m4, MATCH);
      const uint32_t nzz = L::neg(z);
      un[i] = L::add(z, L::neg(nv[i]));
      vn[i] = L::add(z, L::neg(u[i]));
      const uint32_t nze = L::add(NEGE, nzz), nze2 = L::add(NEGE2, nzz);
      const uint32_t xn = L::addmax(a, nze, NEG1), yn = L::addmax(bb, nze, NEG1);
      const uint32_t x2n = L::addmax(a2, nze2, NEG2), y2n = L::addmax(b2, nze2, NEG2);
      d += L::nz(xn ^ NEG1) * 0x08u + L::nz(yn ^ NEG1) * 0x10u +
           L::nz(x2n ^ NEG2) * 0x20u + L::nz(y2n ^ NEG2) * 0x40u;
      const uint32_t m = m_band[i];
      u[i] = blend(un[i], u[i], m);
      v[i] = blend(vn[i], v[i], m);
      x[i] = blend(xn, x[i], m);
      y[i] = blend(yn, y[i], m);
      x2[i] = blend(x2n, x2[i], m);
      y2[i] = blend(y2n, y2[i], m);
      d &= m;
#pragma unroll
      for (int h = 0; h < P; ++h)
        drow[32 * (P * i + h)] = static_cast<uint8_t>(d >> (16 * h));
    }

    // H: the other real cells (t < en0) add their new v; the band end
    // t = en0 takes the OLD H[en0 - 1] plus its new u (its own old H plus
    // its new v when en0 == 0; v - q - e at r = 0)
    const unsigned n_mid = r == 0 ? 0u : n_real;     // [st0, en0)
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (static_cast<unsigned>(kr + 32 * j) < n_mid)
        H[j] = wadd(H[j], L::get(vn[j / P], j % P));
    const int k_en0 = en0 - o_r;     // in the window (see the header)
    const int se = k_en0 >> 5;
    int un_e = L::get(un[0], 0), vn_e = L::get(vn[0], 0);
#pragma unroll
    for (int j = 1; j < R; ++j) {
      un_e = se == j ? L::get(un[j / P], j % P) : un_e;
      vn_e = se == j ? L::get(vn[j / P], j % P) : vn_e;
    }
    const int H_e = r == 0 ? wsub(vn_e, p.q + p.e)
                  : en0 > 0 ? wadd(H_prev_en0m1, un_e)
                            : wadd(max(slot_value<R>(H, se), kNegInf), vn_e);
    const bool owner = (k_en0 & 31) == lane;
#pragma unroll
    for (int j = 0; j < R; ++j) H[j] = owner && se == j ? H_e : H[j];

    // lane max over its real cells (NEG_INF elsewhere) and the first
    // column attaining it, every cell counted as the plain version does;
    // then the diagonal max and the first column attaining it
    int hm = 0, hi = 0;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int hv = static_cast<unsigned>(kr + 32 * j) <= n_real ? H[j] : kNegInf;
      if (j == 0 || hv > hm) { hm = hv; hi = o_r + lane + 32 * j; }
    }
    const int seg_max = __reduce_max_sync(kFull, hm);
    const int first_t = __reduce_min_sync(kFull, hm == seg_max ? hi : 0x7fffffff);
    const int H_en0 = max(__shfl_sync(kFull, H_e, k_en0 & 31), kNegInf);
    const int max_t = H_en0 == seg_max ? en0 : first_t;
    const int max_H = seg_max;

    if (en0 == tlen - 1 && H_en0 > mte) { mte = H_en0; mte_q = r - en; }
    if (r - st0 == qlen - 1) {
      const int H_st0 = pick<R>(H, st0 - o_r);
      if (H_st0 > mqe) { mqe = H_st0; mqe_t = st0; }
    }
    bool dropped_now = false;
    if (max_H > ez_max) {
      ez_max = max_H; ez_max_t = max_t; ez_max_q = r - max_t;
    } else if (max_t >= ez_max_t && r - max_t >= ez_max_q) {
      const int l = abs((max_t - ez_max_t) - ((r - max_t) - ez_max_q));
      dropped_now = p.zdrop >= 0 && ez_max - max_H > p.zdrop + l * p.e2;
    }
    // the score's cell t = tlen - 1 is en0 here
    if (!dropped_now && r == qlen + tlen - 2 && en0 == tlen - 1) score = H_en0;
    last_st = st;
    last_en = en;
    if (dropped_now) {
      zdropped = 1;
      r_stop = r + 1;
      break;
    }
  }

  // zero the rows the sweep did not reach (16-byte stores; W % 32 == 0
  // and n_diag_pad % 16 == 0 keep every row 16-byte aligned)
  uint4* z16 = reinterpret_cast<uint4*>(dmat + ((size_t)b * n_diag_pad + r_stop) * W);
  const int n16 = (n_diag_pad - r_stop) * (W / 16);
  for (int c = lane; c < n16; c += 32) z16[c] = make_uint4(0, 0, 0, 0);

  if (lane == 0) {
    out[b] = score;
    out[B + b] = mqe;
    out[2 * B + b] = mqe_t;
    out[3 * B + b] = mte;
    out[4 * B + b] = mte_q;
    out[5 * B + b] = ez_max;
    out[6 * B + b] = ez_max_q;
    out[7 * B + b] = ez_max_t;
    out[8 * B + b] = zdropped;
  }
}

template <int P, int NR>
int launch(const void* qc, const void* qlens, const void* tc, const void* tlens,
           void* out, void* dmat, int B, int Qmax, int Tmax, int t_pad,
           int n_diag_pad, const Scoring& p, cudaStream_t stream) {
  constexpr int W = 32 * P * NR;
  const int q_ext = t_pad + 64 + Qmax + W;
  const size_t smem = (size_t)kWarps * ((q_ext + t_pad + 15) & ~15);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        extd2_fwd_kernel<P, NR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  extd2_fwd_kernel<P, NR><<<(B + kWarps - 1) / kWarps, 32 * kWarps, smem, stream>>>(
      static_cast<const uint8_t*>(qc), static_cast<const int*>(qlens),
      static_cast<const uint8_t*>(tc), static_cast<const int*>(tlens),
      static_cast<int*>(out), static_cast<uint8_t*>(dmat), B, Qmax, Tmax,
      t_pad, n_diag_pad, p);
  return (int)cudaGetLastError();
}

}  // namespace

// out: (9, B) int32 rows score, mqe, mqe_t, mte, mte_q, max, max_q, max_t,
// zdropped. dmat: (B, n_diag_pad, W) uint8, every byte written here.
// state16 != 0 (the profile passes state_fits_int8): packed 16-bit state,
// needs W % 64 == 0, 64 <= W <= 256; else int32 state, W % 32 == 0,
// 32 <= W <= 256. Returns a cudaError_t (cudaErrorInvalidValue for a W
// outside these).
extern "C" int pansvr_extd2_fwd(
    const void* qc, const void* qlens, const void* tc, const void* tlens,
    void* out, void* dmat, int B, int Qmax, int Tmax, int W, int t_pad,
    int n_diag_pad, int match, int mismatch, int q, int e, int q2, int e2,
    int w, int zdrop, int long_thres, int long_diff, int state16,
    void* stream) {
  if (B <= 0) return 0;
  const Scoring p{match, mismatch, q, e, q2, e2, w, zdrop, long_thres, long_diff};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PANSVR_FWD(P, NR)                                                     \
  return launch<P, NR>(qc, qlens, tc, tlens, out, dmat, B, Qmax, Tmax, t_pad, \
                       n_diag_pad, p, st)
  if (state16) {
    switch (W) {
      case 64: PANSVR_FWD(2, 1);
      case 128: PANSVR_FWD(2, 2);
      case 192: PANSVR_FWD(2, 3);
      case 256: PANSVR_FWD(2, 4);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (W) {
    case 32: PANSVR_FWD(1, 1);
    case 64: PANSVR_FWD(1, 2);
    case 96: PANSVR_FWD(1, 3);
    case 128: PANSVR_FWD(1, 4);
    case 160: PANSVR_FWD(1, 5);
    case 192: PANSVR_FWD(1, 6);
    case 224: PANSVR_FWD(1, 7);
    case 256: PANSVR_FWD(1, 8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PANSVR_FWD
}

extern "C" const char* pansvr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
