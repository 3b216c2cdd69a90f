// fc_aln's per-batch front, chain and collect, and the DP chunk's fill
// and packing, for sm_90a.
//
// Replaces no Pallas kernel: the JAX package runs these steps as XLA
// programs (pansvr_tpu/ops/seeding.py seed_reads_flat and
// merge_expand_device3, ops/chain.py chain_batch and chain_extract_batch,
// ops/collect.py select_and_paths, align/engine.py _unpack_codes and the
// fill of _device_dp_pallas_meta). The port ran them as chains of ATen
// ops (ops/seeding.py, ops/chain.py, ops/collect.py,
// align/programs.py), which stay as the plain versions, the
// specification these kernels match bit for bit. On a card an ATen op
// kind the first time it runs loads the libtorch CUDA module that holds
// its kernel, up to 100 MiB of host memory for the rest of the process
// (H100, torch 2.11); with these kernels a batch launches no libtorch
// kernel that the engine build (the index's derivation on the card) has
// not loaded already.
//
// What bounds them: a few MB a batch of dependent, data-driven reads
// (binary searches of the 537 MB probe table, unitig words, per-row
// sorts and the chain's sparse DP over at most 32 seeds), so latency
// and not bandwidth or arithmetic; the card is idle 95% of fc_aln's
// stream, so they pace nothing. Design: one thread an item (a read row,
// a (row, seed) probe, a flat lane, a chain or a path node) with the
// row's lanes in local memory, and a one-block scan between the stages
// that lay rows out on the flat lane axes (hits over rows, chains over
// reads, path nodes over chains). No shared state between threads but
// the scan, so a host build (PANSVR_HOST: g++ -x c++) runs each kernel
// as a loop over its threads, which the CPU tests hold to the plain
// versions.
//
// Every entry point takes a table of pointers, a table of ints and the
// stream; the layouts are the ones ops/front_cuda.py writes. Arithmetic
// follows the plain versions' int64 (torch) semantics where they differ
// from int32: shifts of unsigned 32-bit words held in int64, arithmetic
// right shifts of signed values, truncation to int32 on output.

#include <stdint.h>

typedef int64_t i64;
typedef uint64_t u64;
typedef int32_t i32;
typedef uint32_t u32;
typedef uint8_t u8;

#ifdef PANSVR_HOST
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
typedef void* cudaStream_t;
static int g_tid;
#define TID g_tid
template <class K, class... A>
static int launch(int n, cudaStream_t, K k, A... a) {
  for (g_tid = 0; g_tid < n; ++g_tid) k(n, a...);
  return 0;
}
static int scan(int n, const i32* in, i32* out, cudaStream_t) {
  i32 run = 0;
  for (int i = 0; i < n; ++i) {
    run += in[i];
    out[i] = run;
  }
  return 0;
}
static inline int ctz32(u32 x) { return __builtin_ctz(x); }
static inline int clz32(u32 x) { return __builtin_clz(x); }
#else
#include <cuda_runtime.h>
#define TID (int)(blockIdx.x * blockDim.x + threadIdx.x)
template <class K, class... A>
static int launch(int n, cudaStream_t s, K k, A... a) {
  if (n <= 0) return 0;
  k<<<(n + 127) / 128, 128, 0, s>>>(n, a...);
  return (int)cudaGetLastError();
}
constexpr int SCAN_T = 1024;
// inclusive prefix sum of n int32 (in place allowed): one block, each
// thread a contiguous chunk
__global__ void k_scan(int n, const i32* in, i32* out) {
  __shared__ i32 sh[SCAN_T];
  const int t = threadIdx.x;
  const int chunk = (n + SCAN_T - 1) / SCAN_T;
  const int lo = min(n, t * chunk), hi = min(n, lo + chunk);
  i32 s = 0;
  for (int i = lo; i < hi; ++i) s += in[i];
  sh[t] = s;
  __syncthreads();
  for (int off = 1; off < SCAN_T; off <<= 1) {
    const i32 v = t >= off ? sh[t - off] : 0;
    __syncthreads();
    sh[t] += v;
    __syncthreads();
  }
  i32 run = sh[t] - s;
  for (int i = lo; i < hi; ++i) {
    run += in[i];
    out[i] = run;
  }
}
static int scan(int n, const i32* in, i32* out, cudaStream_t s) {
  if (n <= 0) return 0;
  k_scan<<<1, SCAN_T, 0, s>>>(n, in, out);
  return (int)cudaGetLastError();
}
__device__ __forceinline__ int ctz32(u32 x) { return __ffs(x) - 1; }
__device__ __forceinline__ int clz32(u32 x) { return __clz(x); }
#endif

#define HD __host__ __device__ __forceinline__

namespace {

constexpr int SEED_STEP = 5;
constexpr int UNI_POS_N_MAX = 32;
constexpr int POS_N_MAX = 500;
constexpr int POS_N_MAX_LEVEL2 = 8000;
constexpr int RANDOM_NUM = 500;
constexpr int WAITING_LEN = 3;
constexpr i32 FLAT_OVERFLOW = 1 << 20;
constexpr i32 BUDGET_OVERFLOW = 1 << 21;
constexpr i64 M32 = 0xFFFFFFFFLL;
constexpr i64 I32MAX = 0x7FFFFFFF;
constexpr int MAXM = 320;    // MEM lanes a row (M of the 1600 read class)
constexpr int MAXK = 32;     // chain width (ancestor masks)
constexpr int N_HIT = 6;
constexpr int CHAIN_WINDOW = 80;

HD i64 imin(i64 a, i64 b) { return a < b ? a : b; }
HD i64 imax(i64 a, i64 b) { return a > b ? a : b; }
HD i64 iclamp(i64 x, i64 lo, i64 hi) { return imin(imax(x, lo), hi); }

// the number of a[0..n) that are <= x (a nondecreasing): searchsorted right
template <class T>
HD int upper_bound(const T* a, int n, i64 x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((i64)a[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// 32-bit window (hi << sh) | (lo >> (32 - sh)) of u32 values held in i64
HD i64 win32(i64 hi, i64 lo, int sh) {
  return ((hi << sh) | (sh == 0 ? 0 : lo >> (32 - sh))) & M32;
}

// ---------------------------------------------------------------------------
// seeding front (ops/seeding.py seed_reads_flat, merge_expand_device3)
// ---------------------------------------------------------------------------

struct Front {
  // inputs
  const i32* words; const i32* lens; const u8* mask; const u8* is_str2;
  const i64* ent_key; const i32* ent_run; const i32* ent_pack;
  const i32* uni; const i32* posp; const i32* pos;
  // outputs (Bc rows: R compacted, else B)
  i32* es_rb; i32* es_re; i32* es_fb; i32* es_fe; i32* es_cov; i32* es_sid;
  u8* es_valid; i32* stats3; i32* rid; u8* is_str_c; u8* codes;
  // scratch
  i32* left; i32* cnt; u8* found; i32* rank; i32* hcum; i32* take;
  i32* cum_take; i32* lane; u8* used; i32* row3;
  // shapes
  int B, Wr, S0, M, S, NE, NF, R, n_k, n_pad_w, n_uni, n_pos, sk, fl, L;
  int pad;  // zero words before the unitig words
  int Bc;  // chain rows: R when compacted, else B
};

// lane fields of Front.lane, NF each
enum { LN_OK, LN_ROW, LN_SEED, LN_RIGHT, LN_UID, LN_RP, LN_UO, LN_LEN,
       LN_PN, LN_FIELDS };

HD int src_row(const Front& f, int r) {
  if (!f.R) return r;
  const i32 b = f.rid[r];
  return b < f.B ? b : f.B - 1;
}

HD bool slot_ok(const Front& f, int r) { return !f.R || f.rid[r] < f.B; }

HD i64 read_word(const Front& f, int b, i64 w) {
  return (i64)(u32)f.words[(i64)b * f.Wr + iclamp(w, 0, f.Wr - 1)];
}

__global__ void k_probe(int n, Front f) {
  const int t = TID;
  if (t >= n) return;
  const int b = t / f.S0, s = t % f.S0;
  const i64 o = (i64)s * SEED_STEP;
  auto swin = [&](i64 p) {
    const i64 w = p >> 4;
    return win32(read_word(f, b, w), read_word(f, b, w + 1),
                 (int)((p & 15) * 2));
  };
  const i64 qb = swin(o) >> (32 - 2 * f.fl);
  const i64 qr = swin(o + f.fl) >> (32 - 2 * (f.sk - f.fl));
  const i64 qkey = (qb << 32) | qr;
  int lo = 0, hi = f.n_k;          // lower bound of qkey
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (f.ent_key[mid] < qkey) lo = mid + 1; else hi = mid;
  }
  const int lc = (int)iclamp(lo, 0, imax(f.n_k - 1, 0));
  const bool exists = lo < f.n_k && f.ent_key[lc] == qkey;
  const i64 count = exists ? (i64)f.ent_run[lc] : 0;
  const bool seed_ok = o < (i64)f.lens[b] - f.sk + 1 && f.mask[t];
  f.left[t] = lo;
  f.cnt[t] = (i32)count;
  f.found[t] = seed_ok && exists && count > 0 && count <= UNI_POS_N_MAX;
}

// act rows (any hit) into rank, to be scanned
__global__ void k_act(int n, Front f) {
  const int b = TID;
  if (b >= n) return;
  i32 a = 0;
  for (int s = 0; s < f.S0; ++s) a |= f.found[(i64)b * f.S0 + s];
  f.rank[b] = a;
}

// rid[r]: the act row of rank r (B past the act rows), by a search of the
// act rows' inclusive count; is_str of the compacted row
__global__ void k_rid(int n, Front f) {
  const int r = TID;
  if (r >= n) return;
  int lo = 0, hi = f.B;            // first row whose count reaches r + 1
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (f.rank[mid] < r + 1) lo = mid + 1; else hi = mid;
  }
  f.rid[r] = lo;
  f.is_str_c[r] = lo < f.B ? f.is_str2[lo] : 0;
}

__global__ void k_layout(int n, Front f) {
  const int r = TID;
  if (r >= n) return;
  const int src = src_row(f, r);
  const bool ok = slot_ok(f, r);
  i32 acc = 0;
  for (int s = 0; s < f.S0; ++s) {
    const i64 k = (i64)src * f.S0 + s;
    acc += (ok && f.found[k]) ? f.cnt[k] : 0;
    f.hcum[(i64)r * f.S0 + s] = acc;
  }
  f.take[r] = acc <= f.M ? acc : 0;
}

HD i64 hits_before(const Front& f, int r, int s) {
  return s ? f.hcum[(i64)r * f.S0 + s - 1] : 0;
}

__global__ void k_lanes(int n, Front f) {
  const int lf = TID;
  if (lf >= n) return;
  i32* ln = f.lane;
  const i64 NF = f.NF;
  const i64 total = f.cum_take[f.Bc - 1];
  if (lf >= total) {
    ln[LN_OK * NF + lf] = 0;
    return;
  }
  const int r = (int)imin(upper_bound(f.cum_take, f.Bc, lf), f.Bc - 1);
  const i64 p = lf - (f.cum_take[r] - f.take[r]);
  const int s = (int)imin(upper_bound(f.hcum + (i64)r * f.S0, f.S0, p),
                          f.S0 - 1);
  const i64 h = p - hits_before(f, r, s);
  const i64 o2 = (i64)s * SEED_STEP;
  const int src = src_row(f, r);
  const i64 entry = iclamp((i64)f.left[(i64)src * f.S0 + s] + h, 0,
                           imax(f.n_k - 1, 0));
  const i32* rec = f.ent_pack + 4 * entry;
  const i64 off = rec[0], uid = rec[1], off_l = rec[2], r3 = rec[3];
  const i64 off_r = r3 & 2047, pos_n = r3 >> 11;
  const i64 max_left = imin(off_l, o2);
  const i64 max_right = imin(off_r, (i64)f.lens[src] - o2 - f.sk);
  auto word = [&](i64 j) {
    return (i64)(u32)f.uni[iclamp(j + f.pad, 0, f.n_pad_w - 1)];
  };
  // left extension, 16 bases a compare
  const i64 woff = off >> 4, w0 = o2 >> 4;
  const int sh_l = (int)((off & 15) * 2), shs = (int)((o2 & 15) * 2);
  i64 left_m = 0;
  bool still = true;
  for (int st = 0; st < f.NE; ++st) {
    const i64 wu = win32(word(woff - (st + 1)), word(woff - st), sh_l);
    const i64 rr = win32(read_word(f, src, w0 - (st + 1)),
                         read_word(f, src, w0 - st), shs);
    const i64 x = rr ^ wu;
    const i64 m = x == 0 ? 16 : ctz32((u32)x) >> 1;
    const i64 tk = still ? imin(m, max_left - left_m) : 0;
    left_m += imax(tk, 0);
    still = still && m >= 16 && left_m < max_left;
  }
  left_m = imin(left_m, max_left);
  // right extension
  const i64 p0 = off + f.sk, w0r = p0 >> 4, pr = o2 + f.sk, wr0 = pr >> 4;
  const int sh_r = (int)((p0 & 15) * 2), shr = (int)((pr & 15) * 2);
  i64 right_m = 0;
  still = true;
  for (int st = 0; st < f.NE; ++st) {
    const i64 wu = win32(word(w0r + st), word(w0r + st + 1), sh_r);
    const i64 rr = win32(read_word(f, src, wr0 + st),
                         read_word(f, src, wr0 + st + 1), shr);
    const i64 x = rr ^ wu;
    const i64 m = x == 0 ? 16 : clz32((u32)x) >> 1;
    const i64 tk = still ? imin(m, max_right - right_m) : 0;
    right_m += imax(tk, 0);
    still = still && m >= 16 && right_m < max_right;
  }
  right_m = imin(right_m, max_right);
  ln[LN_OK * NF + lf] = 1;
  ln[LN_ROW * NF + lf] = r;
  ln[LN_SEED * NF + lf] = s;
  ln[LN_RIGHT * NF + lf] = (i32)right_m;
  ln[LN_UID * NF + lf] = (i32)uid;
  ln[LN_RP * NF + lf] = (i32)(o2 - left_m);
  ln[LN_UO * NF + lf] = (i32)(off_l - left_m);
  ln[LN_LEN * NF + lf] = (i32)(f.sk + left_m + right_m);
  ln[LN_PN * NF + lf] = (i32)pos_n;
}

// the sequential MEM-coverage skip of each row
__global__ void k_cover(int n, Front f) {
  const int r = TID;
  if (r >= n) return;
  const int src = src_row(f, r);
  const bool ok = slot_ok(f, r);
  const i64 NF = f.NF;
  const i64 nfe = imin(f.cum_take[f.Bc - 1], NF);
  const i64 tk = f.take[r];
  const i64 rs = f.cum_take[r] - tk;
  i64 msr = 0;
  for (int s = 0; s < f.S0; ++s) {
    const i64 st = hits_before(f, r, s);
    const i64 e = f.hcum[(i64)r * f.S0 + s] - st;
    const bool fnd = ok && f.found[(i64)src * f.S0 + s];
    i64 ps = -1;
    if (fnd && tk > 0)
      for (i64 h = 0; h < e; ++h) {
        const i64 lf = rs + st + h;
        if (lf < nfe) ps = imax(ps, f.lane[LN_RIGHT * NF + lf]);
      }
    const i64 o = (i64)s * SEED_STEP;
    const bool use = o + f.sk - 1 > msr && fnd;
    if (use) msr = o + f.sk + imax(ps + 1, 1) - 1;
    f.used[(i64)r * f.S0 + s] = use;
  }
}

// the row's (M) MEMs back from the flat lanes, then merge_expand_device3:
// sort by (uid, read_pos), merge adjacent-linked runs, expand each run to
// its reference occurrences, S slots. MAXM: the local arrays' length, the
// smallest instance that holds M (local memory is reserved per resident
// thread)
template <int MAXM_>
__global__ void k_merge(int n, Front f) {
  const int r = TID;
  if (r >= n) return;
  const i64 NF = f.NF;
  const int M = f.M, S = f.S;
  const i64 tk = f.take[r];
  const i64 rs = f.cum_take[r] - tk;
  const i64 hits = f.hcum[(i64)r * f.S0 + f.S0 - 1];
  const i32* ln = f.lane;
  // lane m's attributes; pk = rp | len << 12 | valid << 24 (clamped)
  i32 uid[MAXM_], rp[MAXM_], uo[MAXM_], pn[MAXM_], pk[MAXM_];
  unsigned short ord[MAXM_];
  // the sort key (uid or INT32_MAX when invalid, read_pos), as the plain
  // version's (key << 32) + (read_pos + 2^31) orders it
  auto before = [&](int a, int b) {        // key[a] > key[b]
    const i64 ka = (pk[a] >> 24) ? uid[a] : I32MAX;
    const i64 kb = (pk[b] >> 24) ? uid[b] : I32MAX;
    return ka > kb || (ka == kb && rp[a] > rp[b]);
  };
  for (int m = 0; m < M; ++m) {
    const i64 sf = iclamp(rs + m, 0, NF - 1);
    const bool v = m < tk && ln[LN_OK * NF + sf] &&
        f.used[(i64)ln[LN_ROW * NF + sf] * f.S0 + ln[LN_SEED * NF + sf]];
    const i64 p = v ? ln[LN_RP * NF + sf] : 0;
    const i64 l = v ? ln[LN_LEN * NF + sf] : 0;
    uid[m] = v ? ln[LN_UID * NF + sf] : 0;
    rp[m] = (i32)p;
    uo[m] = v ? ln[LN_UO * NF + sf] : 0;
    pn[m] = (i32)imin(v ? ln[LN_PN * NF + sf] : 0, 16383);
    pk[m] = (i32)(iclamp(p, 0, 4095) | iclamp(l, 0, 4095) << 12 |
                  (i64)v << 24);
    int j = m;                             // stable insertion
    while (j > 0 && before(ord[j - 1], m)) {
      ord[j] = ord[j - 1];
      --j;
    }
    ord[j] = (unsigned short)m;
  }
  // in sorted order (through ord): linked[j] joins lane j to lane j - 1;
  // csum the covered lengths
  u8 linked[MAXM_];
  i32 csum[MAXM_];
  i64 acc = 0;
  for (int j = 0; j < M; ++j) {
    const int a = ord[j];
    const bool v = (pk[a] >> 24) != 0;
    const i64 lnj = (pk[a] >> 12) & 4095;
    bool lk = false;
    i64 diff = 0;
    if (j) {
      const int b = ord[j - 1];
      const bool vb = (pk[b] >> 24) != 0;
      const i64 uida = v ? uid[a] : 0, uidb = vb ? uid[b] : 0;
      diff = (i64)rp[a] - rp[b] - ((pk[b] >> 12) & 4095);
      const i64 drift = ((i64)uo[a] - uo[b]) - ((i64)rp[a] - rp[b]);
      lk = uida == uidb && uo[a] > uo[b] && v && vb &&
           diff <= WAITING_LEN && drift == 0;
    }
    linked[j] = lk;
    acc += v ? ((lk && diff <= 0) ? diff + lnj : lnj) : 0;
    csum[j] = (i32)acc;
  }
  // runs (a valid unlinked lane and the lanes linked after it), in order:
  // first and last sorted lane, and the occurrence count's running sum up
  // to the first run past POS_N_MAX_LEVEL2
  unsigned short r_first[MAXM_], r_last[MAXM_];
  i32 cum[MAXM_];
  int n_runs = 0;
  acc = 0;
  bool aborted = false;
  for (int j = 0; j < M; ++j) {
    if (linked[j] || !(pk[ord[j]] >> 24)) continue;
    int last = j;
    while (last + 1 < M && linked[last + 1]) ++last;
    const i64 mp = pn[ord[j]];
    aborted = aborted || mp > POS_N_MAX_LEVEL2;
    acc += aborted ? 0 : (mp > POS_N_MAX ? RANDOM_NUM : mp);
    r_first[n_runs] = (unsigned short)j;
    r_last[n_runs] = (unsigned short)last;
    cum[n_runs++] = (i32)acc;
  }
  const i64 total = acc;
  const i64 row = (i64)r * S;
  for (int slot = 0; slot < S; ++slot) {
    const i64 o = row + slot;
    if (slot >= total) {
      f.es_rb[o] = f.es_re[o] = f.es_fb[o] = f.es_fe[o] = 0;
      f.es_cov[o] = f.es_sid[o] = 0;
      f.es_valid[o] = 0;
      continue;
    }
    const int q = upper_bound(cum, n_runs, slot);
    const int j = r_first[q], last = r_last[q];
    const int a = ord[j], l = ord[last];
    const i64 lnj = (pk[a] >> 12) & 4095;
    i64 len1 = lnj, len2 = lnj;
    if (last != j) {
      const i64 ln_l = (pk[l] >> 12) & 4095;
      len1 = (pk[l] & 4095) + ln_l - rp[a];
      len2 = (i64)uo[l] + ln_l - uo[a];
    }
    const i64 r_pn = pn[a];
    const i64 occ_q = cum[q] - (q ? cum[q - 1] : 0);
    const i64 within = slot - (cum[q] - occ_q);
    const u64 h = (((u64)slot * 0x9E3779B9ULL) & M32) ^
                  ((((u64)(u32)uid[a]) * 2654435761ULL) & M32);
    const i64 pick = r_pn > POS_N_MAX ? (i64)(h % (u64)imax(r_pn, 1))
                                      : within;
    const i64 base = f.posp[iclamp(uid[a], 0, imax(f.n_uni - 1, 0))];
    const i64 oi = iclamp(base + pick, 0, f.n_pos - 1);
    const i64 ref_begin = (i64)f.pos[oi] + uo[a];
    const i64 read_begin = (i64)rp[a] & 4095;
    f.es_rb[o] = (i32)read_begin;
    f.es_re[o] = (i32)(read_begin + (len1 & 4095) - 1);
    f.es_fb[o] = (i32)ref_begin;
    f.es_fe[o] = (i32)(ref_begin + (len2 & 4095) - 1);
    f.es_cov[o] = (i32)((i64)csum[last] - (j ? csum[j - 1] : 0));
    f.es_sid[o] = q;
    f.es_valid[o] = 1;
  }
  f.row3[3 * r] = (i32)(imax(hits - M, 0) +
                        (f.cum_take[r] <= NF ? 0 : FLAT_OVERFLOW));
  f.row3[3 * r + 1] = (i32)imax(total - S, 0);
  f.row3[3 * r + 2] = (i32)imin(total, S);
}

// stats3 (3, B) [overflow, dropped, seed count] in the batch's row space
__global__ void k_stats(int n, Front f) {
  const int b = TID;
  if (b >= n) return;
  i32 v[3] = {0, 0, 0};
  int slot = b;
  if (f.R) {
    const i32 act = f.rank[b] - (b ? f.rank[b - 1] : 0);
    slot = act ? f.rank[b] - 1 : f.R;
    if (act && slot >= f.R) v[0] = BUDGET_OVERFLOW;
  }
  if (slot < f.Bc)
    for (int k = 0; k < 3; ++k) v[k] += f.row3[3 * slot + k];
  for (int k = 0; k < 3; ++k) f.stats3[(i64)k * f.B + b] = v[k];
}

// the DP's flat read codes (B, L) from the packed words
__global__ void k_codes(int n, Front f) {
  const int t = TID;
  if (t >= n) return;
  const int b = t / f.L, j = t % f.L;
  const u32 w = (u32)f.words[(i64)b * f.Wr + (j >> 4)];
  f.codes[t] = (u8)((w >> ((15 - (j & 15)) * 2)) & 3);
}

// ---------------------------------------------------------------------------
// chain (ops/chain.py chain_batch + chain_extract_batch), one row a thread
// ---------------------------------------------------------------------------

struct Chain {
  const i32* rb; const i32* re; const i32* fb; const i32* fe;
  const i32* cov; const i32* sid; const u8* valid; const u8* is_str;
  int ld, K;
  // sorted seeds and pre (R, K), hits (3, R, 6): idx, score, final
  i32* s_rb; i32* s_re; i32* s_fb; i32* s_fe; i32* pre; i32* hits;
  int R;
};

HD int popc32(u64 x) {
  int c = 0;
  for (x &= M32; x; x &= x - 1) ++c;
  return c;
}

__global__ void k_chain(int n, Chain c) {
  const int r = TID;
  if (r >= n) return;
  const int K = c.K;
  const i64 in0 = (i64)r * c.ld;
  // stable sort by (ref_end, ref_begin), invalid seeds last
  int ord[MAXK];
  for (int k = 0; k < K; ++k) {
    const i64 kk = c.valid[in0 + k] ? c.fe[in0 + k] : I32MAX;
    const i64 kb = c.fb[in0 + k];
    int j = k;
    while (j > 0) {
      const int p = ord[j - 1];
      const i64 pk = c.valid[in0 + p] ? c.fe[in0 + p] : I32MAX;
      if (pk < kk || (pk == kk && c.fb[in0 + p] <= kb)) break;
      ord[j] = p;
      --j;
    }
    ord[j] = k;
  }
  i32 rb[MAXK], re[MAXK], fb[MAXK], fe[MAXK], cv[MAXK], sd[MAXK];
  bool val[MAXK];
  for (int k = 0; k < K; ++k) {
    const i64 o = in0 + ord[k];
    rb[k] = c.rb[o]; re[k] = c.re[o]; fb[k] = c.fb[o]; fe[k] = c.fe[o];
    cv[k] = c.cov[o]; sd[k] = c.sid[o]; val[k] = c.valid[o];
  }
  const bool str = c.is_str[r];
  const i64 max_ref = str ? 400 : 50, max_read = str ? 400 : 50;
  const i64 max_step = str ? 80 : 40, max_gap = str ? 20 : 50;
  const int weff = K < CHAIN_WINDOW ? K : CHAIN_WINDOW;
  // the j-scan from i breaks at its first non-skipped valid successor
  // past max_ref: ob[i] is that offset
  int ob[MAXK];
  for (int i = 0; i < K; ++i) {
    ob[i] = 1 << 20;
    for (int o = 1; o <= weff && i + o < K; ++o) {
      const int j = i + o;
      const bool skip = sd[j] == sd[i] || fe[j] == fe[i];
      if (!skip && (i64)fb[j] - fe[i] > max_ref && val[j]) {
        ob[i] = o;
        break;
      }
    }
  }
  i32 dist[MAXK], pre[MAXK];
  for (int j = 0; j < K; ++j) {
    i32 best_lex = -0x7F000000, best_val = 0;
    int bo = 0;
    bool any = false;
    for (int o = 1; o <= weff; ++o) {
      const int i = j - o;
      if (i < 0) break;
      const i32 dis_ref = fb[j] - fe[i], dis_read = rb[j] - re[i];
      const bool skip = sd[j] == sd[i] || fe[j] == fe[i];
      const i32 gap = dis_read - dis_ref < 0 ? dis_ref - dis_read
                                             : dis_read - dis_ref;
      const bool has_w = dis_read == dis_ref ||
          (dis_read > 0 && dis_ref > 0) ||
          (dis_read >= -5 && dis_read <= 0 && dis_ref >= -5);
      const bool cond = val[i] && val[j] && !skip && o < ob[i] &&
          o <= max_step - 1 && dis_read <= max_read && gap <= max_gap &&
          has_w;
      if (!cond) continue;
      const i32 pen = gap == 0 ? 0 : (gap >> 3) + 3;
      const i32 w = dis_read == dis_ref
          ? cv[j] - (1 - dis_read > 0 ? 1 - dis_read : 0)
          : (dis_read > 0 && dis_ref > 0 ? cv[j]
             : cv[j] + (dis_read < dis_ref ? dis_read : dis_ref));
      const i32 value = dist[i] + (w - pen);
      const i32 cl = value < -(1 << 21) ? -(1 << 21)
                     : (value > (1 << 21) ? (1 << 21) : value);
      const i32 lex = cl * 256 + (CHAIN_WINDOW - o);
      if (!any || lex > best_lex) {
        best_lex = lex;
        best_val = value;
        bo = o - 1;
      }
      any = true;
    }
    dist[j] = any ? (best_val > 0 ? best_val : 0) : (val[j] ? cv[j] : 0);
    pre[j] = any && best_val >= 0 ? j - (bo + 1) : -1;
  }
  const i64 out0 = (i64)r * K;
  for (int k = 0; k < K; ++k) {
    c.s_rb[out0 + k] = rb[k]; c.s_re[out0 + k] = re[k];
    c.s_fb[out0 + k] = fb[k]; c.s_fe[out0 + k] = fe[k];
    c.pre[out0 + k] = pre[k];
  }
  // extraction: ancestor masks and roots (pre points to an earlier seed)
  u64 anc[MAXK];
  int root[MAXK];
  for (int k = 0; k < K; ++k) {
    anc[k] = (1ULL << k) | (pre[k] >= 0 ? anc[pre[k]] : 0);
    root[k] = pre[k] >= 0 ? root[pre[k]] : k;
  }
  i64 used = 0;
  int n_out = 0;
  i32* hi = c.hits + (i64)r * N_HIT;
  i32* hs = hi + (i64)c.R * N_HIT;
  i32* hf = hs + (i64)c.R * N_HIT;
  for (int s = 0; s < N_HIT; ++s) {
    hi[s] = -1;
    hs[s] = 0;
    hf[s] = 0;
  }
  for (int it = 0; it < K; ++it) {
    i64 best_key = -1;
    int best = 0;
    for (int k = 0; k < K; ++k) {
      const bool el = val[k] && dist[k] > 0 && !((used >> k) & 1);
      const i64 key = el ? (i64)dist[k] * 64 + k : -1;
      if (key > best_key) {
        best_key = key;
        best = k;
      }
    }
    if (best_key < 0) break;                       // ~any_left: stop
    const u64 path = anc[best];
    const int fin = root[best];
    const int u_cnt = popc32(path & (u64)used), total = popc32(path);
    i64 used_n = used | (i64)path;
    if (best - fin > ((total + 5) << 1))
      used_n |= (((1LL << best) - 1) & ~((1LL << fin) - 1)) & M32;
    used = used_n;
    if (!(u_cnt >= total - u_cnt)) {
      hi[n_out] = best;
      hs[n_out] = dist[best];
      hf[n_out] = fin;
      if (++n_out >= N_HIT) break;
    }
  }
}

// the host collect's chain tensors (programs.chain_pack)
struct Pack {
  const i32* s_rb; const i32* s_re; const i32* s_fb; const i32* s_fe;
  const i32* pre; const i32* hits;
  i32* p32; int16_t* p16; int8_t* p8; int8_t* hits8; int16_t* hscore;
  int R, K;
};

__global__ void k_pack(int n, Pack p) {
  const int r = TID;
  if (r >= n) return;
  const i64 RK = (i64)p.R * p.K, R6 = (i64)p.R * N_HIT;
  for (int k = 0; k < p.K; ++k) {
    const i64 o = (i64)r * p.K + k;
    p.p32[o] = p.s_fb[o];
    p.p16[o] = (int16_t)p.s_rb[o];
    p.p16[RK + o] = (int16_t)p.s_re[o];
    p.p16[2 * RK + o] = (int16_t)(p.s_fe[o] - p.s_fb[o]);
    p.p8[o] = (int8_t)p.pre[o];
  }
  for (int s = 0; s < N_HIT; ++s) {
    const i64 o = (i64)r * N_HIT + s;
    p.hits8[o] = (int8_t)p.hits[o];
    p.hits8[R6 + o] = (int8_t)p.hits[2 * R6 + o];
    p.hscore[o] = (int16_t)p.hits[R6 + o];
  }
}

// ---------------------------------------------------------------------------
// device collect (ops/collect.py select_and_paths)
// ---------------------------------------------------------------------------

constexpr int MIN_CHAIN_SCORE = 20;
constexpr int MAX_CHAIN_SCORE_DIFF = 30;
constexpr int MIN_CHAIN_SCORE_LOOP = 30;

struct Collect {
  const i32* rb; const i32* re; const i32* fb; const i32* fe; const i32* pre;
  const i32* hits; const u8* active; const i32* rid;   // rid null: R = B2
  // outputs
  i32* meta; i32* path_a; i32* path_b; int16_t* path_dfe; i32* scal;
  i32* over;
  // scratch: per read n_sel (scanned into cum_read), ok, 12 sorted
  // candidates x (cs, hi, fin, dir); per chain lane plen (scanned into
  // cum_nodes), row, head node
  i32* n_sel; i32* cum_read; u8* read_ok; i32* cand;
  i32* plen; i32* cum_nodes; i32* c_row; i32* c_hi;
  int R, K, n_pad, NC, NP;
};

// the chain row of batch row x: its compacted slot (R: none)
HD int chain_row(const Collect& c, int x) {
  if (!c.rid) return x;
  int lo = 0, hi = c.R;        // rid ascends over its used slots
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (c.rid[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo < c.R && c.rid[lo] == x ? lo : c.R;
}

__global__ void k_select(int n, Collect c) {
  const int i = TID;
  if (i >= n) return;
  const i64 R6 = (i64)c.R * N_HIT;
  i64 cs[12], hi[12], fin[12];
  bool present[12];
  for (int d = 0; d < 2; ++d) {
    const int row = chain_row(c, i + d * c.n_pad);
    bool pre_ok = true;
    for (int s = 0; s < N_HIT; ++s) {
      const int j = d * N_HIT + s;
      const i64 o = (i64)row * N_HIT + s;
      hi[j] = row < c.R ? c.hits[o] : -1;
      cs[j] = row < c.R ? c.hits[R6 + o] : 0;
      fin[j] = row < c.R ? c.hits[2 * R6 + o] : 0;
      pre_ok = pre_ok && hi[j] >= 0;
      present[j] = pre_ok;
    }
  }
  i64 run_max = 0;
  bool broken[2] = {false, false}, keep[12], any_keep = false;
  for (int j = 0; j < 12; ++j) {
    const int d = j / N_HIT;
    const bool p = present[j] && !broken[d];
    if (p) run_max = imax(run_max, cs[j]);
    const bool brk = cs[j] + MAX_CHAIN_SCORE_DIFF < run_max ||
                     cs[j] < MIN_CHAIN_SCORE_LOOP;
    keep[j] = p && !brk;
    any_keep = any_keep || keep[j];
    if (p && brk) broken[d] = true;
  }
  i64 key[12];
  int ord[12];
  for (int j = 0; j < 12; ++j) {
    key[j] = keep[j] ? (((8191 - iclamp(cs[j], 0, 8191)) << 11) |
                        (iclamp(hi[j], 0, 127) << 4) | j) : I32MAX;
    int t = j;
    while (t > 0 && key[ord[t - 1]] > key[j]) {
      ord[t] = ord[t - 1];
      --t;
    }
    ord[t] = j;
  }
  const bool ok = c.active[i] && run_max >= MIN_CHAIN_SCORE && any_keep;
  int ns = 0;
  i32* cd = c.cand + (i64)i * 48;
  for (int t = 0; t < 12; ++t) {
    const int j = ord[t];
    ns += key[j] != I32MAX && ok && cs[j] + MAX_CHAIN_SCORE_DIFF >= run_max;
    cd[t] = (i32)cs[j];
    cd[12 + t] = (i32)hi[j];
    cd[24 + t] = (i32)fin[j];
    cd[36 + t] = j / N_HIT;
  }
  c.n_sel[i] = ns;
  c.read_ok[i] = ok;
}

HD int chain_read(const Collect& c, int ch) {
  return (int)imin(upper_bound(c.cum_read, c.n_pad, ch), c.n_pad - 1);
}

HD int node_at(const Collect& c, int row, int node) {
  return (int)iclamp(node, 0, c.K - 1) + row * c.K;
}

// a chain lane: its read and candidate, its row and the length of its path
__global__ void k_chains(int n, Collect c) {
  const int ch = TID;
  if (ch >= n) return;
  const i64 total = c.cum_read[c.n_pad - 1];
  const int rd = chain_read(c, ch);
  const i64 slot = ch - (c.cum_read[rd] - c.n_sel[rd]);
  const bool ok = ch < imin(total, c.NC) && slot >= 0 && slot < c.n_sel[rd];
  int len = 0, row = 0, node = -1;
  if (ok) {
    const i32* cd = c.cand + (i64)rd * 48;
    const int dir = cd[36 + slot];
    node = cd[12 + slot];
    if (c.rid) {
      row = chain_row(c, rd + dir * c.n_pad);
      row = (int)iclamp(row, 0, c.R - 1);
    } else {
      row = rd + dir * c.n_pad;
    }
    for (int k = 0, nd = node; k < c.K && nd >= 0; ++k) {
      ++len;
      nd = c.pre[node_at(c, row, nd)];
    }
  }
  c.plen[ch] = len;
  c.c_row[ch] = row;
  c.c_hi[ch] = node;
}

__global__ void k_paths(int n, Collect c) {
  const int p = TID;
  if (p >= n) return;
  const i64 total = c.cum_nodes[c.NC - 1];
  i64 a = 0, b = 0, dd = 0;
  if (p < imin(total, c.NP)) {
    const int ch = (int)imin(upper_bound(c.cum_nodes, c.NC, p), c.NC - 1);
    const i64 step = p - (c.cum_nodes[ch] - c.plen[ch]);
    if (step >= 0 && step < c.plen[ch]) {
      const int row = c.c_row[ch];
      int nd = c.c_hi[ch];
      for (i64 t = 0; t < step; ++t) nd = c.pre[node_at(c, row, nd)];
      const int o = node_at(c, row, nd);
      a = (i64)c.rb[o] | ((i64)c.re[o] << 16);
      b = c.fb[o];
      dd = (i64)c.fe[o] - c.fb[o];
    }
  }
  c.path_a[p] = (i32)a;
  c.path_b[p] = (i32)b;
  c.path_dfe[p] = (int16_t)dd;
}

// a read's chains spill NC, or a chain of it spills NP (host path)
HD bool read_over(const Collect& c, int i) {
  const i64 cr = c.cum_read[i], off = cr - c.n_sel[i];
  if (c.read_ok[i] && cr > c.NC) return true;
  const i64 last = imin(imin(cr, c.NC), c.cum_read[c.n_pad - 1]) - 1;
  return last >= off && last >= 0 && c.cum_nodes[last] > c.NP;
}

// threads < n_pad: over of a read; threads < NC: a chain lane's meta
__global__ void k_meta(int n, Collect c) {
  const int t = TID;
  if (t >= n) return;
  if (t < c.n_pad) c.over[t] = read_over(c, t);
  if (t >= c.NC) return;
  const i64 total = c.cum_read[c.n_pad - 1];
  const int rd = chain_read(c, t);
  const i64 slot = t - (c.cum_read[rd] - c.n_sel[rd]);
  const bool ok = t < imin(total, c.NC) && slot >= 0 && slot < c.n_sel[rd];
  i32* m = c.meta + 3 * (i64)t;
  if (!ok) {
    m[0] = -1;
    m[1] = m[2] = 0;
  } else {
    const i32* cd = c.cand + (i64)rd * 48;
    const i64 cs = cd[slot], fin = cd[24 + slot], dir = cd[36 + slot];
    const int o = node_at(c, c.c_row[t], (int)fin);
    const i64 pl = iclamp(c.plen[t], 0, 255);
    m[0] = (i32)(rd | (dir << 15) | (pl << 16) |
                 ((i64)read_over(c, rd) << 24));
    m[1] = (i32)((u32)(cs & 0xFFFF) | ((u32)c.rb[o] << 16));
    m[2] = c.fb[o];
  }
  if (t == 0) {
    const i64 tn = c.cum_nodes[c.NC - 1];
    c.scal[0] = (i32)imin(total, c.NC);
    c.scal[1] = (i32)total;
    c.scal[2] = (i32)imin(tn, c.NP);
    c.scal[3] = (i32)tn;
  }
}

// ---------------------------------------------------------------------------
// a DP chunk's fill (programs.dp_fill_meta) and its packed results
// ---------------------------------------------------------------------------

struct Dp {
  const u8* codes; const i32* ref_words; const i32* meta;
  u8* qc; u8* tc; i32* ql; i32* tl;
  const i32* out9; i32* i0; i32* j0; const i32* fin; i32* packed;
  int B, cq, ct, n_codes, n_words, tru_len, ld_meta;
};

__global__ void k_fill(int n, Dp d) {
  const int t = TID;
  if (t >= n) return;
  const int cw = d.cq + d.ct;
  const int b = t / cw, j = t % cw;
  const i64 qbase = d.meta[b], qa = d.meta[d.ld_meta + b];
  const i64 refst = d.meta[2 * d.ld_meta + b];
  const i64 tlen = d.meta[3 * d.ld_meta + b];
  const bool rev = d.meta[4 * d.ld_meta + b] != 0;
  if (j == 0) {
    d.ql[b] = (i32)qa;
    d.tl[b] = (i32)tlen;
  }
  if (j < d.cq) {
    const i64 qi = qbase + (rev ? qa - 1 - j : j);
    d.qc[(i64)b * d.cq + j] =
        j < qa ? d.codes[iclamp(qi, 0, d.n_codes - 1)] : 0;
    return;
  }
  const int jt = j - d.cq;
  const i64 tpos = refst + (rev ? tlen - 1 - jt : jt);
  const bool tok = jt < tlen && tpos < d.tru_len;
  const i64 w = (i64)(u32)d.ref_words[iclamp(tpos >> 4, 0, d.n_words - 1)];
  d.tc[(i64)b * d.ct + jt] =
      tok ? (u8)((w >> ((15 - (tpos & 15)) * 2)) & 3) : 0;
}

// the traceback's start: the end cell, or the max cell after a z-drop
__global__ void k_start(int n, Dp d) {
  const int b = TID;
  if (b >= n) return;
  const bool zd = d.out9[8 * d.B + b] > 0;
  const i32 mq = d.out9[6 * d.B + b], mt = d.out9[7 * d.B + b];
  d.i0[b] = !zd ? d.tl[b] - 1 : (mt >= 0 ? mt : -1);
  d.j0[b] = !zd ? d.ql[b] - 1 : (mq >= 0 ? mq : -1);
}

// packed (8, B): score, mqe, max, max_q, max_t, zdropped, i_fin, j_fin
__global__ void k_dp_pack(int n, Dp d) {
  const int b = TID;
  if (b >= n) return;
  const int rows[5] = {0, 1, 5, 6, 7};
  for (int k = 0; k < 5; ++k) d.packed[k * d.B + b] = d.out9[rows[k] * d.B + b];
  d.packed[5 * d.B + b] = d.out9[8 * d.B + b] > 0;
  d.packed[6 * d.B + b] = d.fin[b];
  d.packed[7 * d.B + b] = d.fin[d.B + b];
}

#define TRY(x) do { const int e_ = (x); if (e_) return e_; } while (0)

}  // namespace

// front scratch, in int32 words, of shapes I (front's int table)
static i64 front_scratch_words(const int* I, i64 off[10]) {
  const i64 B = I[0], S0 = I[2], NF = I[6], R = I[7];
  const i64 Bc = R ? R : B;
  const i64 n[10] = {B * S0, B * S0, (B * S0 + 3) / 4, B, Bc * S0, Bc, Bc,
                     NF * LN_FIELDS, (Bc * S0 + 3) / 4, 3 * Bc};
  i64 acc = 0;
  for (int k = 0; k < 10; ++k) {
    off[k] = acc;
    acc += n[k];
  }
  return acc;
}

extern "C" long long pansvr_front_scratch(const int* I) {
  i64 off[10];
  return front_scratch_words(I, off);
}

// P: words, lens2, mask2, is_str2, ent_key, ent_run, ent_pack, uni_words_pad,
//    uni_posp, uni_pos, es_rb, es_re, es_fb, es_fe, es_cov, es_sid,
//    es_valid, stats3, rid, is_str_c, codes, scratch
// I: B, Wr, S0, M, S, NE, NF, R (0 uncompacted), n_k, n_pad_w, n_uni,
//    n_pos, sk, fl, L, pad (uni_words_pad's leading zero words)
extern "C" int pansvr_front(void** P, const int* I, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Front f;
  f.words = (const i32*)P[0]; f.lens = (const i32*)P[1];
  f.mask = (const u8*)P[2]; f.is_str2 = (const u8*)P[3];
  f.ent_key = (const i64*)P[4]; f.ent_run = (const i32*)P[5];
  f.ent_pack = (const i32*)P[6]; f.uni = (const i32*)P[7];
  f.posp = (const i32*)P[8]; f.pos = (const i32*)P[9];
  f.es_rb = (i32*)P[10]; f.es_re = (i32*)P[11]; f.es_fb = (i32*)P[12];
  f.es_fe = (i32*)P[13]; f.es_cov = (i32*)P[14]; f.es_sid = (i32*)P[15];
  f.es_valid = (u8*)P[16]; f.stats3 = (i32*)P[17]; f.rid = (i32*)P[18];
  f.is_str_c = (u8*)P[19]; f.codes = (u8*)P[20];
  f.B = I[0]; f.Wr = I[1]; f.S0 = I[2]; f.M = I[3]; f.S = I[4];
  f.NE = I[5]; f.NF = I[6]; f.R = I[7]; f.n_k = I[8]; f.n_pad_w = I[9];
  f.n_uni = I[10]; f.n_pos = I[11]; f.sk = I[12]; f.fl = I[13]; f.L = I[14];
  f.pad = I[15];
  f.Bc = f.R ? f.R : f.B;
  if (f.M > MAXM || f.B < 1 || f.NF < 1) return -1;
  i64 off[10];
  front_scratch_words(I, off);
  i32* sc = (i32*)P[21];
  f.left = sc + off[0]; f.cnt = sc + off[1]; f.found = (u8*)(sc + off[2]);
  f.rank = sc + off[3]; f.hcum = sc + off[4]; f.take = sc + off[5];
  f.cum_take = sc + off[6]; f.lane = sc + off[7];
  f.used = (u8*)(sc + off[8]); f.row3 = sc + off[9];
  TRY(launch(f.B * f.S0, st, k_probe, f));
  if (f.R) {
    TRY(launch(f.B, st, k_act, f));
    TRY(scan(f.B, f.rank, f.rank, st));
    TRY(launch(f.R, st, k_rid, f));
  }
  TRY(launch(f.Bc, st, k_layout, f));
  TRY(scan(f.Bc, f.take, f.cum_take, st));
  TRY(launch(f.NF, st, k_lanes, f));
  TRY(launch(f.Bc, st, k_cover, f));
  if (f.M <= 32) TRY(launch(f.Bc, st, k_merge<32>, f));
  else if (f.M <= 64) TRY(launch(f.Bc, st, k_merge<64>, f));
  else if (f.M <= 128) TRY(launch(f.Bc, st, k_merge<128>, f));
  else TRY(launch(f.Bc, st, k_merge<MAXM>, f));
  TRY(launch(f.B, st, k_stats, f));
  TRY(launch(f.B * f.L, st, k_codes, f));
  return 0;
}

// P: rb, re, fb, fe, cov, sid, valid (R rows of stride ld, K used), is_str,
//    s_rb, s_re, s_fb, s_fe, pre (R, K), hits (3, R, 6); with pack: p32,
//    p16, p8, hits8, hscore
// I: R, ld, K, pack
extern "C" int pansvr_chain(void** P, const int* I, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Chain c;
  c.rb = (const i32*)P[0]; c.re = (const i32*)P[1]; c.fb = (const i32*)P[2];
  c.fe = (const i32*)P[3]; c.cov = (const i32*)P[4];
  c.sid = (const i32*)P[5]; c.valid = (const u8*)P[6];
  c.is_str = (const u8*)P[7];
  c.s_rb = (i32*)P[8]; c.s_re = (i32*)P[9]; c.s_fb = (i32*)P[10];
  c.s_fe = (i32*)P[11]; c.pre = (i32*)P[12]; c.hits = (i32*)P[13];
  c.R = I[0]; c.ld = I[1]; c.K = I[2];
  if (c.K < 1 || c.K > MAXK) return -1;
  TRY(launch(c.R, st, k_chain, c));
  if (I[3]) {
    Pack p;
    p.s_rb = c.s_rb; p.s_re = c.s_re; p.s_fb = c.s_fb; p.s_fe = c.s_fe;
    p.pre = c.pre; p.hits = c.hits;
    p.p32 = (i32*)P[14]; p.p16 = (int16_t*)P[15]; p.p8 = (int8_t*)P[16];
    p.hits8 = (int8_t*)P[17]; p.hscore = (int16_t*)P[18];
    p.R = c.R; p.K = c.K;
    TRY(launch(c.R, st, k_pack, p));
  }
  return 0;
}

// collect scratch, int32 words
extern "C" long long pansvr_collect_scratch(const int* I) {
  const i64 n_pad = I[2], NC = I[3];
  return n_pad * (2 + 48) + (n_pad + 3) / 4 + NC * 4;
}

// P: s_rb, s_re, s_fb, s_fe, pre (R, K), hits (3, R, 6), active (n_pad),
//    rid (R; null uncompacted), meta (NC, 3), path_a, path_b, path_dfe
//    (NP), scal (4), over (n_pad), scratch
// I: R, K, n_pad, NC, NP
extern "C" int pansvr_collect(void** P, const int* I, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Collect c;
  c.rb = (const i32*)P[0]; c.re = (const i32*)P[1]; c.fb = (const i32*)P[2];
  c.fe = (const i32*)P[3]; c.pre = (const i32*)P[4];
  c.hits = (const i32*)P[5]; c.active = (const u8*)P[6];
  c.rid = (const i32*)P[7];
  c.meta = (i32*)P[8]; c.path_a = (i32*)P[9]; c.path_b = (i32*)P[10];
  c.path_dfe = (int16_t*)P[11]; c.scal = (i32*)P[12]; c.over = (i32*)P[13];
  c.R = I[0]; c.K = I[1]; c.n_pad = I[2]; c.NC = I[3]; c.NP = I[4];
  if (c.n_pad < 1 || c.NC < 1 || c.NP < 1 || c.K < 1) return -1;
  i32* sc = (i32*)P[14];
  c.n_sel = sc; sc += c.n_pad;
  c.cum_read = sc; sc += c.n_pad;
  c.cand = sc; sc += (i64)c.n_pad * 48;
  c.plen = sc; sc += c.NC;
  c.cum_nodes = sc; sc += c.NC;
  c.c_row = sc; sc += c.NC;
  c.c_hi = sc; sc += c.NC;
  c.read_ok = (u8*)sc;
  TRY(launch(c.n_pad, st, k_select, c));
  TRY(scan(c.n_pad, c.n_sel, c.cum_read, st));
  TRY(launch(c.NC, st, k_chains, c));
  TRY(scan(c.NC, c.plen, c.cum_nodes, st));
  TRY(launch(c.NP, st, k_paths, c));
  TRY(launch(c.n_pad > c.NC ? c.n_pad : c.NC, st, k_meta, c));
  return 0;
}

// P: codes, ref_words, meta (5, ld_meta), qc (B, cq), tc (B, ct), ql, tl
// I: B, cq, ct, n_codes, n_words, tru_len, ld_meta
extern "C" int pansvr_dp_fill(void** P, const int* I, void* stream) {
  Dp d = {};
  d.codes = (const u8*)P[0]; d.ref_words = (const i32*)P[1];
  d.meta = (const i32*)P[2]; d.qc = (u8*)P[3]; d.tc = (u8*)P[4];
  d.ql = (i32*)P[5]; d.tl = (i32*)P[6];
  d.B = I[0]; d.cq = I[1]; d.ct = I[2]; d.n_codes = I[3]; d.n_words = I[4];
  d.tru_len = I[5]; d.ld_meta = I[6];
  return launch(d.B * (d.cq + d.ct), (cudaStream_t)stream, k_fill, d);
}

// P: out9 (9, B) of the forward kernel, ql, tl, i0, j0 (B)
// I: B
extern "C" int pansvr_dp_start(void** P, const int* I, void* stream) {
  Dp d = {};
  d.out9 = (const i32*)P[0]; d.ql = (i32*)P[1]; d.tl = (i32*)P[2];
  d.i0 = (i32*)P[3]; d.j0 = (i32*)P[4]; d.B = I[0];
  return launch(d.B, (cudaStream_t)stream, k_start, d);
}

// P: out9 (9, B), fin (2, B), packed (8, B)
// I: B
extern "C" int pansvr_dp_pack(void** P, const int* I, void* stream) {
  Dp d = {};
  d.out9 = (const i32*)P[0]; d.fin = (const i32*)P[1];
  d.packed = (i32*)P[2]; d.B = I[0];
  return launch(d.B, (cudaStream_t)stream, k_dp_pack, d);
}
