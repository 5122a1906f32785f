// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV kernels.
//
// Replaces the three Pallas TPU kernels of horovod_tpu/ops/flash_attention.py:
//   flash_fwd_kernel     <- _fwd_kernel      (launched by _fwd_call, pallas_call at :165)
//   flash_bwd_dq_kernel  <- _bwd_dq_kernel   (launched by _bwd_call, pallas_call at :333)
//   flash_bwd_dkv_kernel <- _bwd_dkv_kernel  (launched by _bwd_call, pallas_call at :354)
//
// Semantics are the reference's: layout (B, S, H, D) at the interface, read
// through arbitrary (batch, seq, head) strides with unit stride on D, so the
// q/k/v slices of a fused qkv projection need no copy; the causal mask is
// global, q_pos = q_offset + i >= k_pos = kv_offset + j; masked scores are
// -1e30; a row that sees no key gets O = 0 and lse = -1e30.  Any sequence
// length works (ragged tiles are masked), head_dim is 32, 64 or 128.
//
// What bounds them on an H100.  At the flagship training shape
// (B=8, S=512, H=8, D=64) each kernel moves 17-25 MB and does 2-4 GFLOP of
// causal work: far below the ~295 FLOP/byte ridge, so the floor is the
// bytes (5-8 us at 3.35 TB/s).  At long context (S=8192) the work grows as
// S^2 and the kernels become tensor-core bound (137 GFLOP forward).
//
// What the design does about it.  The TPU kernels carried m, l and the
// accumulator in VMEM scratch across a sequential grid axis; blocks on a GPU
// run in no order, so each block owns one 64-row tile and walks the other
// sequence axis in an inner loop:
//   * forward and dQ: one block per (64-query tile, b*h), looping over key
//     tiles up to the causal diagonal (dead tiles are never loaded);
//   * dK/dV: one block per (64-key tile, b*h), looping over query tiles from
//     the diagonal on -- the reference's two-kernel split, so no atomics.
// Four warps per block, each owning 16 rows.  Every product (Q K^T, P V,
// dO V^T, dS K, P^T dO, dS^T Q) runs on the tensor cores as
// mma.sync.m16n8k16 with bf16 inputs and fp32 accumulation; the score tile,
// the running max/sum and the output accumulator stay in registers and
// never touch device memory, which is what keeps the memory traffic at one
// read of each input per tile.  P and dS are rounded to bf16 before their
// products (the reference keeps them fp32); the tolerance this costs is
// stated beside the tests.  Fragments come from padded shared memory with
// ldmatrix (.trans where the product wants the tile transposed); the
// streamed tiles are double buffered with cp.async, so the copy of the
// next tile overlaps the products on this one; causal forward and dQ
// blocks start the longest query tiles first.  Between the products the
// kernels are bound by instruction issue, not by the tensor cores, so the
// per-element work is kept to a multiply-add and one ex2 on the
// special-function unit (scores in log2 units), and only tiles on the
// causal diagonal or the ragged edge evaluate the mask.  wgmma, TMA and
// warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kThreads = 128;  // four warps
constexpr int kRows = 64;      // rows a block owns (16 per warp)

}  // namespace

// Mirrored by ctypes.Structure FlashParams in ops/flash_attention.py: keep
// the field order and types identical.
struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (B, H, Sq) fp32, contiguous
  const float* delta;  // (B, H, Sq) fp32, contiguous
  void* out;           // O (fwd) or dQ (bwd), (B, Sq, H, D) contiguous
  float* lse_out;      // (B, H, Sq) fp32 (fwd)
  void* dk;            // (B, Sk, H, D) contiguous
  void* dv;            // (B, Sk, H, D) contiguous
  long long q_stride[3];  // batch, seq, head (elements)
  long long k_stride[3];
  long long v_stride[3];
  long long do_stride[3];
  int B, H, Sq, Sk, D;
  int causal;
  int q_offset, kv_offset;
  float scale;
};

namespace {

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 2^x on the special-function unit; 2^(-huge) and 2^(-inf) are +0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of
// row (l & 7) of matrix (l >> 3) and receives, of each matrix, the elements
// an mma fragment wants: row l/4, columns 2(l%4), 2(l%4)+1 (transposed with
// .trans).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Asynchronous global -> shared copies (cp.async); `bytes` 0 zero-fills.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Fragments of mma.m16n8k16 (PTX ISA, "Matrix fragments for mma.m16n8k16"):
// lane = 4 * g + t.  A (16x16, row major): rows g, g+8; cols 2t, 2t+1, +8.
// B (16x8): k rows 2t, 2t+1, +8; n col g.  C (16x8): rows g, g+8; cols 2t,2t+1.
// With ldmatrix each lane instead supplies one row address: `Lane` holds
// the row/column offsets of that address for the three shapes below.
struct Lane {
  int g, t;        // fragment coordinates
  int a_row, a_col;  // A tile, and B stored [k][n] (transposed load)
  int b_row, b_col;  // B stored [n][k]
  __device__ Lane(int lane)
      : g(lane >> 2), t(lane & 3),
        a_row((lane & 7) + ((lane >> 3) & 1) * 8), a_col((lane >> 4) * 8),
        b_row((lane & 7) + (lane >> 4) * 8), b_col(((lane >> 3) & 1) * 8) {}
};

// A = M[r0 .. r0+16)[c0 .. c0+16), M row major with leading dim ld.
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* M, int ld,
                                       int r0, int c0, const Lane& ln) {
  ldsm_x4(a, M + (r0 + ln.a_row) * ld + c0 + ln.a_col);
}

// B fragments of two n tiles (n0, n0 + 8) where B[k][n] = M[n][k]: M
// stores B transposed (K for Q K^T).  b[0..1] is tile n0, b[2..3] n0 + 8.
__device__ __forceinline__ void frag_b_nk(uint32_t (&b)[4], const bf16* M,
                                          int ld, int n0, int k0, const Lane& ln) {
  ldsm_x4(b, M + (n0 + ln.b_row) * ld + k0 + ln.b_col);
}

// The same for B[k][n] = M[k][n]: M stores B as is (V for P V).
__device__ __forceinline__ void frag_b_kn(uint32_t (&b)[4], const bf16* M,
                                          int ld, int k0, int n0, const Lane& ln) {
  ldsm_x4_trans(b, M + (k0 + ln.a_row) * ld + n0 + ln.a_col);
}

__device__ __forceinline__ void mma_pair(float (&d0)[4], float (&d1)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[4]) {
  const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
  mma16816(d0, a, b0);
  mma16816(d1, a, b1);
}

// A fragment for columns [16 kk, 16 kk + 16) of a 16 x (8 NT) fp32
// accumulator held as C fragments: the register reuse of FlashAttention-2.
template <int NT>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c)[NT][4],
                                         int kk) {
  a[0] = pack_f32(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_f32(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_f32(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_f32(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// Start copying rows [row0, row0 + R) of one (b, h) slice into shared
// memory [R][LD]; rows at or past `valid` are zero-filled.
template <int D, int LD>
__device__ __forceinline__ void load_tile(bf16* sm, const bf16* base,
                                          long long seq_stride, int row0,
                                          int valid, int R) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < R * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    const bool in = row0 + r < valid;
    cp_async16(sm + r * LD + c, in ? base + (row0 + r) * seq_stride + c : base,
               in ? 16 : 0);
  }
}

// S = A_rows(16 x D) . B_rows(BN x D)^T for one warp: s[NT][4].
template <int D, int LD, int NT>
__device__ __forceinline__ void qk_tile(float (&s)[NT][4], const bf16* sA,
                                        int a_row0, const bf16* sB,
                                        const Lane& ln) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    frag_a(a, sA, LD, a_row0, kk * 16, ln);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t b[4];
      frag_b_nk(b, sB, LD, n * 8, kk * 16, ln);
      mma_pair(s[n], s[n + 1], a, b);
    }
  }
}

// acc(16 x D) += P(16 x BN, registers) . M(BN x D, shared).
template <int D, int LD, int NT>
__device__ __forceinline__ void pv_tile(float (&acc)[D / 8][4],
                                        const float (&p)[NT][4], const bf16* sM,
                                        const Lane& ln) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    uint32_t a[4];
    acc_to_a<NT>(a, p, kk);
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      uint32_t b[4];
      frag_b_kn(b, sM, LD, kk * 16, n * 8, ln);
      mma_pair(acc[n], acc[n + 1], a, b);
    }
  }
}

// Store a warp's 16 x D fp32 accumulator (scaled per row) as bf16 rows of a
// contiguous (B, S, H, D) tensor slice.
template <int D>
__device__ __forceinline__ void store_rows(bf16* base, long long seq_stride,
                                           const float (&acc)[D / 8][4],
                                           int row_a, int row_b, int valid,
                                           float scale_a, float scale_b, int t) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (row_a < valid)
      *reinterpret_cast<uint32_t*>(base + row_a * seq_stride + c) =
          pack_f32(acc[n][0] * scale_a, acc[n][1] * scale_a);
    if (row_b < valid)
      *reinterpret_cast<uint32_t*>(base + row_b * seq_stride + c) =
          pack_f32(acc[n][2] * scale_b, acc[n][3] * scale_b);
  }
}

// Number of key tiles of width BN a query tile ending at local row q_last
// needs: all of them unless causal, else up to the diagonal.
__device__ __forceinline__ int live_key_tiles(const FlashParams& p, int q_last,
                                              int BN) {
  const int nk = (p.Sk + BN - 1) / BN;
  if (!p.causal) return nk;
  const long long reach =
      static_cast<long long>(p.q_offset) + q_last - p.kv_offset;
  if (reach < 0) return 0;
  const long long live = reach / BN + 1;
  return live < nk ? static_cast<int>(live) : nk;
}

// The streamed tiles of a kernel (K/V, or Q/dO) are double buffered: the
// copy of tile j + 1 is in flight while tile j is computed on.  Each
// iteration: start the next copy, wait for the current tile, barrier,
// compute, barrier (so the next iteration may overwrite this buffer).
template <int N>
__device__ __forceinline__ void wait_tile(bool more) {
  if (more)
    cp_async_wait<N>();
  else
    cp_async_wait<0>();
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Forward: O = softmax(Q K^T * scale) V and lse, online over key tiles.
// ---------------------------------------------------------------------------

template <int D, int BN>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const FlashParams p) {
  constexpr int LD = D + 8;  // padded rows: ldmatrix rows hit distinct banks
  constexpr int NT = BN / 8;
  constexpr int DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sKV = sQ + kRows * LD;  // [2 buffers][K tile, V tile]

  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int warp = threadIdx.x / 32;
  const Lane ln(threadIdx.x % 32);
  const int g = ln.g, t = ln.t;
  // Causal work grows with the query tile: start the longest blocks first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const bf16* Q = static_cast<const bf16*>(p.q) + b * p.q_stride[0] + h * p.q_stride[2];
  const bf16* K = static_cast<const bf16*>(p.k) + b * p.k_stride[0] + h * p.k_stride[2];
  const bf16* V = static_cast<const bf16*>(p.v) + b * p.v_stride[0] + h * p.v_stride[2];

  const int q_last = min(q0 + kRows, p.Sq) - 1;
  const int nk = live_key_tiles(p, q_last, BN);
  auto load_kv = [&](int j) {
    bf16* dst = sKV + (j & 1) * 2 * BN * LD;
    load_tile<D, LD>(dst, K, p.k_stride[1], j * BN, p.Sk, BN);
    load_tile<D, LD>(dst + BN * LD, V, p.v_stride[1], j * BN, p.Sk, BN);
  };
  load_tile<D, LD>(sQ, Q, p.q_stride[1], q0, p.Sq, kRows);
  if (nk > 0) load_kv(0);
  cp_async_commit();

  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const float scale_log2 = p.scale * kLog2e;
  float m[2] = {kNegInf, kNegInf};  // running max, log2 units
  float l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BN;
    const bool more = j + 1 < nk;
    if (more) {
      load_kv(j + 1);
      cp_async_commit();
    }
    wait_tile<1>(more);
    const bf16* sK = sKV + (j & 1) * 2 * BN * LD;
    const bf16* sV = sK + BN * LD;

    float s[NT][4];
    qk_tile<D, LD, NT>(s, sQ, warp * 16, sK, ln);

    // Scores in log2 units; only tiles on the causal diagonal or the ragged
    // key edge need the per-element mask.
    float mx[2] = {kNegInf, kNegInf};
    const bool edge = k0 + BN > p.Sk ||
                      (p.causal && static_cast<long long>(p.kv_offset) + k0 +
                                           BN - 1 >
                                       static_cast<long long>(p.q_offset) + q0);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float x = s[n][e] * scale_log2;
        if (edge) {
          const int key = k0 + n * 8 + 2 * t + (e & 1);
          bool ok = key < p.Sk;
          if (p.causal)
            ok = ok && (static_cast<long long>(p.q_offset) + rows[r] >=
                        static_cast<long long>(p.kv_offset) + key);
          x = ok ? x : kNegInf;
        }
        s[n][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    // While a row has seen only masked keys its max stays -1e30; exponents
    // are then taken against 0, so masked scores still give 2^(-1e30) = 0.
    float m_use[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], mx[r]);
      m_use[r] = m_new <= kNegInf / 2 ? 0.f : m_new;
      alpha[r] = ex2(m[r] - m_use[r]);
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = ex2(s[n][e] - m_use[e >> 1]);
        s[n][e] = pe;
        sum[e >> 1] += pe;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    pv_tile<D, LD, NT>(acc, s, sV, ln);
    __syncthreads();  // this buffer is refilled two iterations on
  }
  cp_async_wait<0>();

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  bf16* O = static_cast<bf16*>(p.out) +
            (static_cast<long long>(b) * p.Sq * p.H + h) * D;
  const long long o_seq = static_cast<long long>(p.H) * D;
  store_rows<D>(O, o_seq, acc, rows[0], rows[1], p.Sq, inv[0], inv[1], t);
  if (t == 0) {
    float* lse = p.lse_out + (static_cast<long long>(b) * p.H + h) * p.Sq;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (rows[r] < p.Sq)
        lse[rows[r]] =
            l[r] <= 0.f ? kNegInf : (m[r] + __log2f(fmaxf(l[r], 1e-30f))) * kLn2;
  }
}

// ---------------------------------------------------------------------------
// dQ = sum_k dS K, dS = P * (dO V^T - delta) * scale, P from the saved lse.
// ---------------------------------------------------------------------------

template <int D, int BN>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const FlashParams p) {
  constexpr int LD = D + 8;
  constexpr int NT = BN / 8;
  constexpr int DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + kRows * LD;
  bf16* sKV = sdO + kRows * LD;  // [2 buffers][K tile, V tile]

  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int warp = threadIdx.x / 32;
  const Lane ln(threadIdx.x % 32);
  const int g = ln.g, t = ln.t;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const bf16* Q = static_cast<const bf16*>(p.q) + b * p.q_stride[0] + h * p.q_stride[2];
  const bf16* K = static_cast<const bf16*>(p.k) + b * p.k_stride[0] + h * p.k_stride[2];
  const bf16* V = static_cast<const bf16*>(p.v) + b * p.v_stride[0] + h * p.v_stride[2];
  const bf16* dO = static_cast<const bf16*>(p.dout) + b * p.do_stride[0] + h * p.do_stride[2];
  const long long row_base = (static_cast<long long>(b) * p.H + h) * p.Sq;

  const int q_last = min(q0 + kRows, p.Sq) - 1;
  const int nk = live_key_tiles(p, q_last, BN);
  auto load_kv = [&](int j) {
    bf16* dst = sKV + (j & 1) * 2 * BN * LD;
    load_tile<D, LD>(dst, K, p.k_stride[1], j * BN, p.Sk, BN);
    load_tile<D, LD>(dst + BN * LD, V, p.v_stride[1], j * BN, p.Sk, BN);
  };
  load_tile<D, LD>(sQ, Q, p.q_stride[1], q0, p.Sq, kRows);
  load_tile<D, LD>(sdO, dO, p.do_stride[1], q0, p.Sq, kRows);
  if (nk > 0) load_kv(0);
  cp_async_commit();

  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  // P = 2^(S scale log2e - lse log2e); a row that saw no key (lse -1e30)
  // or lies past Sq gets lse2 = +inf, so its P is 2^-inf = 0.
  const float scale_log2 = p.scale * kLog2e;
  float lse2[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = rows[r] < p.Sq;
    const float ls = in ? p.lse[row_base + rows[r]] : kNegInf;
    lse2[r] = ls > kNegInf / 2 ? ls * kLog2e : __int_as_float(0x7f800000);
    delta[r] = in ? p.delta[row_base + rows[r]] : 0.f;
  }
  float dq[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BN;
    const bool more = j + 1 < nk;
    if (more) {
      load_kv(j + 1);
      cp_async_commit();
    }
    wait_tile<1>(more);
    const bf16* sK = sKV + (j & 1) * 2 * BN * LD;
    const bf16* sV = sK + BN * LD;

    float s[NT][4];
    qk_tile<D, LD, NT>(s, sQ, warp * 16, sK, ln);
    float dp[NT][4];
    qk_tile<D, LD, NT>(dp, sdO, warp * 16, sV, ln);
    const bool edge = k0 + BN > p.Sk ||
                      (p.causal && static_cast<long long>(p.kv_offset) + k0 +
                                           BN - 1 >
                                       static_cast<long long>(p.q_offset) + q0);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float pe = ex2(s[n][e] * scale_log2 - lse2[r]);
        if (edge) {
          const int key = k0 + n * 8 + 2 * t + (e & 1);
          bool ok = key < p.Sk;
          if (p.causal)
            ok = ok && (static_cast<long long>(p.q_offset) + rows[r] >=
                        static_cast<long long>(p.kv_offset) + key);
          pe = ok ? pe : 0.f;
        }
        s[n][e] = pe * (dp[n][e] - delta[r]) * p.scale;  // dS
      }
    pv_tile<D, LD, NT>(dq, s, sK, ln);
    __syncthreads();
  }
  cp_async_wait<0>();

  bf16* dQ = static_cast<bf16*>(p.out) +
             (static_cast<long long>(b) * p.Sq * p.H + h) * D;
  store_rows<D>(dQ, static_cast<long long>(p.H) * D, dq, rows[0], rows[1],
                p.Sq, 1.f, 1.f, t);
}

// ---------------------------------------------------------------------------
// dV = sum_q P^T dO, dK = sum_q dS^T Q, one block per key tile.  Works on the
// transposed score tile S^T = K Q^T so every product is row-major in shared
// memory and the key rows stay in the warp's registers.
// ---------------------------------------------------------------------------

template <int D, int BN>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const FlashParams p) {
  constexpr int LD = D + 8;
  constexpr int NT = BN / 8;
  constexpr int DT = D / 8;
  // One streamed stage: Q tile, dO tile, lse row, delta row.
  constexpr int kStage = 2 * BN * LD + 2 * BN * 2;  // in bf16 units
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kRows * LD;
  bf16* sStages = sV + kRows * LD;

  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int warp = threadIdx.x / 32;
  const Lane ln(threadIdx.x % 32);
  const int g = ln.g, t = ln.t;
  const int k0 = blockIdx.x * kRows;
  const bf16* Q = static_cast<const bf16*>(p.q) + b * p.q_stride[0] + h * p.q_stride[2];
  const bf16* K = static_cast<const bf16*>(p.k) + b * p.k_stride[0] + h * p.k_stride[2];
  const bf16* V = static_cast<const bf16*>(p.v) + b * p.v_stride[0] + h * p.v_stride[2];
  const bf16* dO = static_cast<const bf16*>(p.dout) + b * p.do_stride[0] + h * p.do_stride[2];
  const long long row_base = (static_cast<long long>(b) * p.H + h) * p.Sq;

  // First query tile that reaches this key tile's first key.
  int i0 = 0;
  if (p.causal) {
    const long long lag =
        static_cast<long long>(p.kv_offset) + k0 - p.q_offset;
    if (lag > 0) i0 = static_cast<int>(lag / BN);
  }
  const int nq = (p.Sq + BN - 1) / BN;
  auto load_q = [&](int i) {
    bf16* st = sStages + (i & 1) * kStage;
    const int q0 = i * BN;
    load_tile<D, LD>(st, Q, p.q_stride[1], q0, p.Sq, BN);
    load_tile<D, LD>(st + BN * LD, dO, p.do_stride[1], q0, p.Sq, BN);
    float* rows = reinterpret_cast<float*>(st + 2 * BN * LD);  // lse, delta
    for (int idx = threadIdx.x; idx < 2 * BN; idx += kThreads) {
      const int r = idx % BN;
      const bool in = q0 + r < p.Sq;
      const float* src = (idx < BN ? p.lse : p.delta) + row_base + (in ? q0 + r : 0);
      cp_async4(rows + idx, src, in ? 4 : 0);
    }
  };
  load_tile<D, LD>(sK, K, p.k_stride[1], k0, p.Sk, kRows);
  load_tile<D, LD>(sV, V, p.v_stride[1], k0, p.Sk, kRows);
  if (i0 < nq) load_q(i0);
  cp_async_commit();

  const int keys[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  const float scale_log2 = p.scale * kLog2e;
  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int i = i0; i < nq; ++i) {
    const int q0 = i * BN;
    const bool more = i + 1 < nq;
    if (more) {
      load_q(i + 1);
      cp_async_commit();
    }
    wait_tile<1>(more);
    const bf16* sQ = sStages + (i & 1) * kStage;
    const bf16* sdO = sQ + BN * LD;
    const float* sLse = reinterpret_cast<const float*>(sdO + BN * LD);
    const float* sDelta = sLse + BN;

    float st[NT][4];
    qk_tile<D, LD, NT>(st, sK, warp * 16, sQ, ln);  // S^T = K Q^T
    // Per column (query) of this thread: lse in log2 units, +inf for a
    // query that saw no key or lies past Sq (its P is then 0).
    float lse2[NT][2];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = n * 8 + 2 * t + c;
        const float ls = sLse[col];
        lse2[n][c] = q0 + col < p.Sq && ls > kNegInf / 2
                         ? ls * kLog2e
                         : __int_as_float(0x7f800000);
      }
    // Key rows past Sk hold zeros and are never stored, so only the causal
    // diagonal needs the per-element mask.
    const bool edge = p.causal && static_cast<long long>(p.kv_offset) + k0 +
                                          kRows - 1 >
                                      static_cast<long long>(p.q_offset) + q0;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pe = ex2(st[n][e] * scale_log2 - lse2[n][e & 1]);
        if (edge) {
          const int col = n * 8 + 2 * t + (e & 1);
          pe = static_cast<long long>(p.q_offset) + q0 + col >=
                       static_cast<long long>(p.kv_offset) + keys[e >> 1]
                   ? pe
                   : 0.f;
        }
        st[n][e] = pe;  // P^T
      }
    pv_tile<D, LD, NT>(dv, st, sdO, ln);  // dV += P^T dO

    float dpt[NT][4];
    qk_tile<D, LD, NT>(dpt, sV, warp * 16, sdO, ln);  // dP^T = V dO^T
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1);
        st[n][e] = st[n][e] * (dpt[n][e] - sDelta[col]) * p.scale;  // dS^T
      }
    pv_tile<D, LD, NT>(dk, st, sQ, ln);  // dK += dS^T Q
    __syncthreads();
  }
  cp_async_wait<0>();

  const long long seq = static_cast<long long>(p.H) * D;
  const long long off = (static_cast<long long>(b) * p.Sk * p.H + h) * D;
  store_rows<D>(static_cast<bf16*>(p.dk) + off, seq, dk, keys[0], keys[1],
                p.Sk, 1.f, 1.f, t);
  store_rows<D>(static_cast<bf16*>(p.dv) + off, seq, dv, keys[0], keys[1],
                p.Sk, 1.f, 1.f, t);
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
                   const FlashParams& p) {
  // Above 48 KB a block's dynamic shared memory must be opted into.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

constexpr int kBn(int D, bool dkv) { return (dkv && D == 128) ? 32 : 64; }

constexpr size_t tile_bytes(int rows, int D) {
  return static_cast<size_t>(rows) * (D + 8) * sizeof(bf16);
}

template <int D>
cudaError_t fwd(const FlashParams& p, cudaStream_t s) {
  constexpr int BN = kBn(D, false);
  dim3 grid((p.Sq + kRows - 1) / kRows, p.B * p.H);
  return launch(flash_fwd_kernel<D, BN>, grid,
                tile_bytes(kRows, D) + 4 * tile_bytes(BN, D), s, p);
}

template <int D>
cudaError_t bwd_dq(const FlashParams& p, cudaStream_t s) {
  constexpr int BN = kBn(D, false);
  dim3 grid((p.Sq + kRows - 1) / kRows, p.B * p.H);
  return launch(flash_bwd_dq_kernel<D, BN>, grid,
                2 * tile_bytes(kRows, D) + 4 * tile_bytes(BN, D), s, p);
}

template <int D>
cudaError_t bwd_dkv(const FlashParams& p, cudaStream_t s) {
  constexpr int BN = kBn(D, true);
  dim3 grid((p.Sk + kRows - 1) / kRows, p.B * p.H);
  return launch(flash_bwd_dkv_kernel<D, BN>, grid,
                2 * tile_bytes(kRows, D) +
                    2 * (2 * tile_bytes(BN, D) + 2 * BN * sizeof(float)),
                s, p);
}

}  // namespace

// C interface, loaded with ctypes.  Each returns the cudaError_t of the
// launch (0 on success); an unsupported head_dim returns
// cudaErrorInvalidValue without launching.
extern "C" {

int hvd_flash_fwd(const FlashParams* p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p->D) {
    case 32: return fwd<32>(*p, s);
    case 64: return fwd<64>(*p, s);
    case 128: return fwd<128>(*p, s);
  }
  return cudaErrorInvalidValue;
}

int hvd_flash_bwd_dq(const FlashParams* p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p->D) {
    case 32: return bwd_dq<32>(*p, s);
    case 64: return bwd_dq<64>(*p, s);
    case 128: return bwd_dq<128>(*p, s);
  }
  return cudaErrorInvalidValue;
}

int hvd_flash_bwd_dkv(const FlashParams* p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p->D) {
    case 32: return bwd_dkv<32>(*p, s);
    case 64: return bwd_dkv<64>(*p, s);
    case 128: return bwd_dkv<128>(*p, s);
  }
  return cudaErrorInvalidValue;
}

const char* hvd_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
