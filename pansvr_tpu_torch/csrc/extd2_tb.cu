// extd2 traceback (ksw_backtrack over the direction bytes of
// extd2_fwd.cu) for sm_90a.
//
// Replaces the Pallas TPU kernel pansvr_tpu/ops/extd2_pallas.py
// (_tb_kernel, launched by traceback_batch_pallas). Per problem the walk
// starts at (i0, j0) (i = target, j = query; dead problems carry -1/-1),
// steps back one anti-diagonal r = i + j at a time, reads the direction
// byte of the cell it stands on (window row i - o_r of diagonal r),
// forces D/I outside the 16-padded band, and follows the continuation
// bits (tmp >> (state + 2)). It emits one op per diagonal in walk order
// (descending r): 0 = M, 1 = I, 2 = D, 3 = no op at that diagonal (an M
// step skips a diagonal), plus the final (i, j).
//
// What bounds it: the walk is serial and each step's byte address
// depends on the step before, so a problem costs its steps times the time
// of one step and a launch at least its longest walk; the bytes are a few
// percent of that. Read from device memory, a step waits a whole load
// (the first port, one thread per problem, ran at 0.1-1.8% of its bytes
// bound). Out of shared memory a step is bounded by its few dozen
// instructions, which one warp issues in order; with several problems an
// SM scheduler, the issue slots bound it. Design:
// - One warp per problem, TB_WARPS warps a block, so a 128-problem
//   launch spreads over 32 SMs. Problem b runs in block b % blocks, warp
//   b / blocks: neighbours of the engine's size-sorted chunks (walks of
//   like length) land on different SMs.
// - A problem's TB_D consecutive diagonals are one contiguous TB_D x W
//   byte range of dmat. The warp stages them into shared memory (lane d
//   one row, 16 bytes a cp.async) double-buffered, as the Pallas kernel's
//   two DMA slots: the chunk below is in flight while this one is
//   walked. The first chunk starts at the problem's own top diagonal.
// - The band is folded into the staged bytes. Band edges and window
//   origins are multiples of 16, so each 16-byte piece of a row is
//   wholly in the band (copied from dmat) or wholly left or right of it
//   (a store of 2s or 1s: the forced I or D, whose byte has no
//   continuation bit). Within a chunk o_r takes at most two values 16
//   apart, so row r lands at column 16 + o_r - o_base of a (W + 48)-byte
//   shared row, 2s to its left and 1s to its right: cell (r, i) sits at
//   column i + 16 - o_base, clamped to the row. A step does no band
//   arithmetic: its state is the cell's own (byte & 7) unless the old
//   state's continuation bit is set in the byte.
// - A step loads its three successors (M, I, D) before it decodes its
//   own cell, which the step before loaded; its move selects one.
// - Every lane runs the walk (a broadcast read, no divergence); lane d
//   keeps the state of diagonal top - d, so each chunk's ops leave in one
//   coalesced 32-byte store. Rows outside the walked chunks get 3s in
//   16-byte stores; fin is written once.
// Contract (as the forward kernel's outputs give it): the window covers
// the band (check_window), tl <= Tmax, and a live start lies in its
// problem (i0 < tl, j0 < ql).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TB_D = 32;         // diagonals per staged chunk: one per lane
constexpr int TB_WARPS = 4;      // problems (warps) per block
constexpr int MAX_SMEM = 232448; // shared memory a block can use (227 KB)
// tables indexed by a step's state (0..7): the op it emits, 2 bits each
// (0 M, 1 I, 2 D), and whether i (DI) or j (DJ) steps back
constexpr unsigned OP_OF = 0 | 2u << 2 | 1u << 4 | 2u << 6 | 1u << 8 |
                           1u << 10 | 1u << 12 | 1u << 14;
constexpr unsigned DI_OF = 0x0B;  // M, D (states 0, 1, 3)
constexpr unsigned DJ_OF = 0xF5;  // M, I (states 0, 2, 4..7)

__host__ __device__ constexpr int row_stride(int W) { return W + 48; }

__device__ __forceinline__ int window_origin(int r, int w, int omax) {
  return min(max((((r - w + 1) >> 1) & ~15) - 16, 0), omax);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// a 16-byte cp.async where p holds; nothing (no read) where it does not
__device__ __forceinline__ void cp_async16_if(bool p, void* smem,
                                              const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n"
      " @q cp.async.cg.shared.global [%0], [%1], 16;\n}\n" ::"r"(s),
      "l"(gmem), "r"(static_cast<int>(p)));
}

// wait until at most N of this thread's groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage chunk c (diagonals c*TB_D .. min(c*TB_D + TB_D - 1, rtop)) of one
// problem into buf and commit its copies as one group (an empty group
// for c < 0). Lane d takes diagonal R = top - d to shared row d: 2s at
// columns [0, 16 + o_R - o_base), the window's W bytes after them (dmat
// where in the band, 2s left of it, 1s right of it), 1s to the end; the
// copies and stores are predicated, so no lane branches apart.
__device__ __forceinline__ void stage_chunk(uint8_t* buf, const uint8_t* dm_b,
                                            int c, int rtop, int W, int w,
                                            int omax, int qlen, int tlen,
                                            int lane) {
  if (c >= 0) {
    const int S = row_stride(W);
    const int top = c * TB_D + TB_D - 1;
    const int R = top - lane;
    const int o = window_origin(R, w, omax);
    const int col = 16 + o - window_origin(c * TB_D, w, omax);  // 16 or 32
    // the band of diagonal R in window columns (>> and & floor)
    const int h = (R - w + 1) >> 1;
    const int st = (max(max(0, R - qlen + 1), h) & ~15) - o;
    const int en = min(((min(min(tlen - 1, R), (R + w) >> 1) + 16) & ~15) - 1,
                       ((tlen + 15) & ~15) - 1) - o;
    const uint4 two = make_uint4(0x02020202u, 0x02020202u, 0x02020202u,
                                 0x02020202u);
    const uint4 one = make_uint4(0x01010101u, 0x01010101u, 0x01010101u,
                                 0x01010101u);
    if (R <= rtop) {
      uint8_t* row = buf + lane * S;
      *reinterpret_cast<uint4*>(row) = two;
      *reinterpret_cast<uint4*>(row + (col == 32 ? 16 : W + 16)) =
          col == 32 ? two : one;
      *reinterpret_cast<uint4*>(row + W + 32) = one;
      const uint8_t* src = dm_b + (size_t)R * W;
      for (int k = 0; k < W; k += 16) {
        const bool band = k >= st && k <= en;
        if (!band) *reinterpret_cast<uint4*>(row + col + k) = k < st ? two : one;
        cp_async16_if(band, row + col + k, src + k);
      }
    }
  }
  cp_async_commit();
}

// ops bytes [lo, hi) of one problem = 3 (lo, hi multiples of 16)
__device__ __forceinline__ void fill_three(int8_t* op_b, int lo, int hi,
                                           int lane) {
  const uint4 three = make_uint4(0x03030303u, 0x03030303u, 0x03030303u,
                                 0x03030303u);
  for (int k = lo / 16 + lane; k < hi / 16; k += 32)
    reinterpret_cast<uint4*>(op_b)[k] = three;
}

__global__ void extd2_tb_kernel(
    const uint8_t* __restrict__ dmat, const int* __restrict__ qlens,
    const int* __restrict__ tlens, const int* __restrict__ i0s,
    const int* __restrict__ j0s, int8_t* __restrict__ ops,
    int* __restrict__ fin, int B, int W, int n_diag_pad, int t_pad, int w) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x + gridDim.x * warp;
  if (b >= B) return;  // whole warps only; no block barrier follows
  const int S = row_stride(W);
  // two buffers of TB_D + 2 rows: a step reads its successors' cells
  // up to two rows below the chunk (never used there, read in bounds)
  uint8_t* buf0 = smem + (size_t)warp * 2 * (TB_D + 2) * S;
  uint8_t* buf1 = buf0 + (TB_D + 2) * S;
  const uint8_t* dm_b = dmat + (size_t)b * n_diag_pad * W;
  int8_t* op_b = ops + (size_t)b * n_diag_pad;

  const int qlen = qlens[b], tlen = tlens[b];
  const int omax = t_pad - W;
  int i = i0s[b], j = j0s[b], state = 0, cont = 0;
  int r = i + j;
  bool alive = i >= 0 && j >= 0 && r < n_diag_pad;
  // chunks c_top .. c are walked; the rest of the row is 3
  int c = alive ? r / TB_D : -1;
  fill_three(op_b, 0, max(n_diag_pad - (c + 1) * TB_D, 0), lane);
  if (alive) {
    stage_chunk(buf0, dm_b, c, r, W, w, omax, qlen, tlen, lane);
    stage_chunk(buf1, dm_b, c - 1, n_diag_pad - 1, W, w, omax, qlen, tlen,
                lane);
    uint8_t* cur = buf0;
    uint8_t* nxt = buf1;
    for (;; --c) {
      const int base = c * TB_D;
      const int top = base + TB_D - 1;
      const int col0 = 16 - window_origin(base, w, omax);
      auto cell = [&](int row, int ii) {  // shared index of (top - row, ii)
        return row * S + min(max(ii + col0, 0), S - 1);
      };
      int mine = -1;  // state of diagonal top - lane, -1 = no op there
      cp_async_wait<1>();  // chunk c landed (c - 1 may be in flight)
      __syncwarp();
      // each step loads its successors I (r - 1, i), D (r - 1, i - 1) and
      // M (r - 2, i - 1); the step after takes the one its move lands on
      // (here, the first step's own cell)
      int pI = cur[cell(top - r, i)], pD = pI, pM = pI;
      bool isM = false, isD = false;
      while (((i | j) >= 0) && r >= base) {
        const int ro = (top - r + 1) * S;
        const int c1 = min(max(i - 1 + col0, 0), S - 1);
        const int qI = cur[ro + min(max(i + col0, 0), S - 1)];
        const int qD = cur[ro + c1];
        const int qM = cur[ro + S + c1];
        const int e = isM ? pM : (isD ? pD : pI);
        const int st4 = (e & cont) ? state : (e & 7);
        if (lane == top - r) mine = st4;
        const int di = (DI_OF >> st4) & 1, dj = (DJ_OF >> st4) & 1;
        isM = st4 == 0;
        isD = di;
        i -= di;
        j -= dj;
        r = i + j;
        state = st4;
        cont = (4 << st4) & 0xF8;  // bit st4 + 2 (none for state 0)
        pI = qI;
        pD = qD;
        pM = qM;
      }
      const int row = top - lane;
      if (row < n_diag_pad)
        op_b[n_diag_pad - 1 - row] =
            static_cast<int8_t>(mine < 0 ? 3 : (OP_OF >> (2 * mine)) & 3);
      alive = (i | j) >= 0;
      if (!alive || c == 0) break;
      __syncwarp();  // every lane is done reading cur before it refills
      stage_chunk(cur, dm_b, c - 2, n_diag_pad - 1, W, w, omax, qlen, tlen,
                  lane);
      uint8_t* t = cur;
      cur = nxt;
      nxt = t;
    }
    fill_three(op_b, n_diag_pad - c * TB_D, n_diag_pad, lane);
    cp_async_wait<0>();  // no copy outlives the warp
  }
  if (lane == 0) {
    fin[b] = i;
    fin[B + b] = j;
  }
}

}  // namespace

// ops: (B, n_diag_pad) int8 in walk order; fin: (2, B) int32 final i, j.
// Shared memory: 2 * (TB_D + 2) * (W + 48) bytes a warp (ops/extd2_cuda.py
// tb_plan mirrors this).
extern "C" int pansvr_extd2_tb(
    const void* dmat, const void* qlens, const void* tlens, const void* i0s,
    const void* j0s, void* ops, void* fin, int B, int W, int n_diag_pad,
    int t_pad, int w, void* stream) {
  if (B <= 0) return 0;
  if (W % 16 || n_diag_pad % 16 || t_pad < W)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)TB_WARPS * 2 * (TB_D + 2) * row_stride(W);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  static size_t smem_allowed = 48 * 1024;  // one card per process
  if (smem > smem_allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        extd2_tb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_allowed = smem;
  }
  const int blocks = (B + TB_WARPS - 1) / TB_WARPS;
  extd2_tb_kernel<<<blocks, TB_WARPS * 32, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(dmat), static_cast<const int*>(qlens),
      static_cast<const int*>(tlens), static_cast<const int*>(i0s),
      static_cast<const int*>(j0s), static_cast<int8_t*>(ops),
      static_cast<int*>(fin), B, W, n_diag_pad, t_pad, w);
  return (int)cudaGetLastError();
}
