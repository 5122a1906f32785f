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
// Common to all three.  The TPU kernels carried m, l and the accumulator in
// VMEM scratch across a sequential grid axis; blocks on a GPU run in no
// order, so each block owns a tile of rows and walks the other sequence
// axis in an inner loop: forward and dQ over key tiles up to the causal
// diagonal (dead tiles are never loaded), dK/dV over query tiles from the
// diagonal on -- the reference's two-kernel split, so no atomics.  The
// score tile, the running max/sum and the accumulators stay in registers
// and never touch device memory, which keeps the memory traffic at one read
// of each input per tile.  Scores are in log2 units, so a softmax element
// costs one multiply-add and one ex2 on the special-function unit, and only
// tiles on the causal diagonal or the ragged edge evaluate the mask.  P and
// dS are rounded to bf16 before their products (the reference keeps them
// fp32); the tolerance this costs is stated beside the tests.
//
// All three are warp-specialised, on wgmma and TMA.  A block of four warps
// that each issue mma.sync on their own 16 rows cannot reach the tensor
// cores' rate on Hopper, re-reads every streamed tile from shared memory
// once per warp, and spends the computing threads' registers and issue
// slots on its loads.  So a block here is three warpgroups.  One
// producer warpgroup gives its registers up (setmaxnreg.dec) and one of its
// threads issues every copy as TMA (cp.async.bulk.tensor) into a ring of
// shared-memory stages, each stage with a "full" mbarrier that the copy
// completes and an "empty" one that the consumers release.  Two consumer
// warpgroups take the registers (setmaxnreg.inc) and own 64 rows each, so
// every streamed tile serves 128 rows.  Each product is a warpgroup-wide
// wgmma.mma_async with fp32 accumulation: its shared operands are read
// through descriptors of the 128-byte swizzle TMA wrote them with (64-byte
// at head_dim 32; a 128-column row is two 64-column boxes), K-major for the
// score products and MN-major (transposed) for the products over rows; P and
// dS come from the score accumulator's registers as the A operand.
//   * forward: 128 query rows a block, 128-key K/V stages (3 stages, 2 at
//     head_dim 128); S = Q K^T, then O += P V.
//   * dQ: 128 query rows a block, their Q and dO tiles loaded once;
//     3 stages of [K, V], 64 keys a stage (for registers: S and dP are both
//     live); S = Q K^T and dP = dO V^T, then dQ += dS K with K as the
//     MN-major operand.  Each consumer thread reads the lse of its two rows
//     with plain loads and computes their delta = rowsum(dO o O) in fp32
//     from O and dO in device memory (a quad of threads splits a row's
//     columns) before its first tile, overlapping the Q/dO copy; it uses
//     delta in its own dS and writes it for the dK/dV launch that follows,
//     so the backward needs no separate delta pass.
//   * dK/dV: 128 keys a block, loaded once; 64-query Q/dO stages (32 at
//     head_dim 128, for registers), each carrying its lse and delta rows
//     (1-D TMA boxes); S^T = K Q^T and dP^T = V dO^T, then dV += P^T dO and
//     dK += dS^T Q.
// TMA zero-fills rows past Sq/Sk, so the ragged edge needs no load masks,
// only the score mask, which is a branch of its own so that other tiles do
// not issue it.  Within a warpgroup the products and the softmax still run
// one after the other, and both consumers wait on the same stage, so they
// run in step: per 128-key forward tile a consumer thread issues 64 ex2
// (512 special-function-unit cycles for the warpgroup) besides 512
// tensor-core cycles of products, and the SM alternates between the two
// instead of overlapping them.  That, not the copies, is what bounds the
// kernels at long context (PERF.md); staggering the consumers (ping-pong)
// and pipelining within a warpgroup are the next steps.  The forward and
// dQ start their longest causal tiles first.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

}  // namespace

// Mirrored by ctypes.Structure FlashParams in ops/flash_attention.py: keep
// the field order and types identical.  New fields go at the end, so that
// an earlier build of this file still reads its own prefix.
struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (B, H, Sq) fp32, contiguous
  const float* delta;  // (B, H, Sq) fp32, contiguous (dK/dV)
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
  const void* o;          // the forward's O (dQ reads it for delta)
  long long o_stride[3];
  float* delta_out;       // (B, H, Sq) fp32, written by dQ
};

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

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

// wgmma's fp32 accumulators are laid out per warp as mma.m16n8's C
// fragments: lane = 4 g + t holds, of each 8-column block n, rows g and
// g + 8, columns 8 n + 2 t and 8 n + 2 t + 1.  A bf16 A fragment of a
// 16-deep product holds the same rows and columns 2t, 2t+1, 2t+8, 2t+9.
// acc_to_a makes the A fragment for columns [16 kk, 16 kk + 16) of a
// 16 x (8 NT) accumulator: the register reuse of FlashAttention-2.
template <int NT>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c)[NT][4],
                                         int kk) {
  a[0] = pack_f32(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_f32(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_f32(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_f32(c[2 * kk + 1][2], c[2 * kk + 1][3]);
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

// Only key tiles on the causal diagonal or the ragged key edge need the
// per-element mask; it is a branch of its own, so the other tiles do not
// issue it predicated off.  Scores of keys a row may not see become -inf:
// one compare an element against the last key each of this thread's rows
// may see.  sc is a warpgroup's score tile over keys [k0, k0 + 8 NT) for
// rows from qc on; rows are this thread's two.
template <int NT>
__device__ __forceinline__ void mask_scores(float (&sc)[NT][4], const FlashParams& p,
                                            int k0, int qc, const int (&rows)[2],
                                            int t) {
  const bool edge =
      k0 + 8 * NT > p.Sk ||
      (p.causal && static_cast<long long>(p.kv_offset) + k0 + 8 * NT - 1 >
                       static_cast<long long>(p.q_offset) + qc);
  if (!edge) return;
  int kmax[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    long long lim = p.Sk - 1;
    if (p.causal)
      lim = min(lim, static_cast<long long>(p.q_offset) + rows[r] - p.kv_offset);
    kmax[r] = static_cast<int>(max(lim, -1ll));
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sc[n][e] = k0 + n * 8 + 2 * t + (e & 1) <= kmax[e >> 1] ? sc[n][e] : neg_inf();
}

// delta = rowsum(dO o O) in fp32 for this thread's two rows, read from
// device memory: each thread of a quad sums every fourth 8-column chunk of
// a row (16-byte loads; the wrapper passes 16-byte aligned rows) and the
// quad adds its sums by shuffles.  A row past Sq gets 0.
template <int D>
__device__ __forceinline__ void row_delta(float (&delta)[2], const FlashParams& p,
                                          int b, int h, const int (&rows)[2], int t) {
  const bf16* O = static_cast<const bf16*>(p.o) + b * p.o_stride[0] + h * p.o_stride[2];
  const bf16* dO =
      static_cast<const bf16*>(p.dout) + b * p.do_stride[0] + h * p.do_stride[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = 0.f;
    if (rows[r] < p.Sq) {
#pragma unroll
      for (int i = 0; i < D / 32; ++i) {
        const int col = (4 * i + t) * 8;
        const uint4 ov =
            *reinterpret_cast<const uint4*>(O + rows[r] * p.o_stride[1] + col);
        const uint4 dv =
            *reinterpret_cast<const uint4*>(dO + rows[r] * p.do_stride[1] + col);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 x = __bfloat1622float2(o2[e]), y = __bfloat1622float2(d2[e]);
          sum = fmaf(x.x, y.x, fmaf(x.y, y.y, sum));
        }
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    delta[r] = sum;
  }
}

// ---------------------------------------------------------------------------
// Hopper primitives: mbarriers, TMA, wgmma, register reallocation
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count));
}

// Arrive once, and expect `bytes` of TMA transactions in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Spin until the phase of the given parity has completed.  A fresh barrier
// is in phase 0, so waiting on parity 1 passes at once.  A wait that lasts
// seconds can only be a fault (a copy that never lands): trap, so the
// launch fails with an error instead of hanging the process.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  if (mbar_try_wait(addr, parity)) return;
  const uint64_t start = global_ns();
  while (!mbar_try_wait(addr, parity))
    if (global_ns() - start > 20000000000ull) __trap();
}

// One TMA box of a rank-4 map, at coordinates (c0, c1, c2, c3), into shared
// memory; its bytes complete on `bar`.  Elements outside the tensor are 0.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// The same for a rank-1 map.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0)
      : "memory");
}

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// wgmma runs asynchronously: fence before a product whose registers other
// instructions wrote, commit the products issued, wait for all of them.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving an access to an accumulator, or the end of
// an A fragment's life, across the wgmma that owns it.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e])::"memory");
}

template <int N>
__device__ __forceinline__ void pin(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[n][e])::"memory");
}

// wgmma shared-memory matrix descriptor: start address, leading byte offset
// (not read by the swizzled layouts used here; 16 bytes), stride byte
// offset between 8-row groups, and the swizzle (1: 128 bytes, 2: 64 bytes).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t sbo,
                                              uint32_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(swizzle) << 62);
}

// The products: wgmma.mma_async m64nNk16, bf16 in, fp32 accumulators laid
// out per warp as mma.m16n8's C fragments (d[n] is columns 8n..8n+7 of the
// warp's 16 rows), so a score accumulator converts to the A fragments of
// the next product with acc_to_a.

// D(64 x 128) (+)= A(64 x 16, shared) . B(128 x 16, shared)^T, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[16][4], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D(64 x 64) (+)= A(64 x 16, shared) . B(64 x 16, shared)^T, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D(64 x 32) (+)= A(64 x 16, shared) . B(32 x 16, shared)^T, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[4][4], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D(64 x 64) += A(64 x 16, registers) . B(16 x 64, shared, MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D(64 x 32) += A(64 x 16, registers) . B(16 x 32, shared, MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[4][4], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// A tile of R rows x D bf16 columns as TMA writes it: NCH column chunks, each
// one TMA box of [R rows][CW columns], rows ROWB bytes apart, swizzled within
// each 8-row group (128-byte swizzle; 64-byte at head_dim 32, whose rows are
// 64 bytes).  The descriptors address it as a wgmma operand.
template <int D>
struct Tile {
  static constexpr int CW = D == 32 ? 32 : 64;
  static constexpr int ROWB = 2 * CW;
  static constexpr int NCH = D / CW;
  static constexpr int KPC = CW / 16;  // k-steps of 16 columns per chunk
  static constexpr uint32_t SWIZZLE = D == 32 ? 2 : 1;
  static constexpr __host__ __device__ uint32_t bytes(int rows) {
    return static_cast<uint32_t>(rows) * D * 2;
  }
  // K-major operand of a product over the columns: rows [r0, r0 + 64) (an
  // A operand) or [0, rows) (B), columns [16 kk, 16 kk + 16).
  static __device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows,
                                                    int r0, int kk) {
    return smem_desc(tile + (kk / KPC) * rows * ROWB + r0 * ROWB + (kk % KPC) * 32,
                     8 * ROWB, SWIZZLE);
  }
  // MN-major (transposed) B operand of a product over the rows: rows
  // [16 kk, 16 kk + 16), the columns of chunk ch.
  static __device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int rows,
                                                     int kk, int ch) {
    return smem_desc(tile + ch * rows * ROWB + kk * 16 * ROWB, 8 * ROWB, SWIZZLE);
  }
};

constexpr int kConsumers = 2;                      // consumer warpgroups
constexpr int kWsThreads = 128 * (1 + kConsumers);  // and one producer
constexpr int kWgRows = 64;                        // rows a consumer owns
constexpr int kWsRows = kConsumers * kWgRows;      // rows a block owns
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kFwdBn = 128;  // keys per forward stage
// Keys per dQ stage.  At 128, S and dP would each take a 64-register
// accumulator a thread besides dQ's, and ptxas spills and serialises the
// wgmmas (C7512) at head_dim 32 and 64; 64 keys keep every accumulator at
// 32 registers or fewer (PERF.md).
constexpr int kDqBn = 64;
constexpr int kDqStages = 3;
constexpr int kDkvStages = 3;

__host__ __device__ constexpr int fwd_stages(int D) { return D == 128 ? 2 : 3; }
__host__ __device__ constexpr int dkv_bq(int D) { return D == 128 ? 32 : 64; }
// A dK/dV stage's lse (and delta) rows come in one 1-D TMA box.  A box must
// start 16-byte aligned, so it starts at the row rounded down to 4 floats
// and is 4 floats longer; each array is padded to 128 bytes in shared memory.
__host__ __device__ constexpr int stat_box(int bq) { return bq + 4; }
__host__ __device__ constexpr int stat_pad(int bq) { return (stat_box(bq) + 31) / 32 * 32; }

// The warpgroup of this thread, broadcast from lane 0 so that the compiler
// sees the producer/consumer branch as warp-uniform: setmaxnreg and wgmma
// are .aligned instructions.
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
}

// Swizzled tiles want 1024-byte alignment; each launch adds the slack.
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
}

// The TMA maps of a launch, passed in kernel parameter space.
struct FwdMaps {
  CUtensorMap q, k, v;
};
struct DqMaps {
  CUtensorMap q, k, v, dout;
};
struct DkvMaps {
  CUtensorMap q, k, v, dout, lse, delta;
};

// ---------------------------------------------------------------------------
// Forward: O = softmax(Q K^T * scale) V and lse, online over key tiles.
// ---------------------------------------------------------------------------

template <int D, int BN>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_fwd_kernel(const __grid_constant__ FwdMaps maps, const FlashParams p) {
  using T = Tile<D>;
  constexpr int S = fwd_stages(D);
  constexpr int NT = BN / 8;
  constexpr int DT = D / 8;
  typedef float Chunk[T::CW / 8][4];  // the accumulator columns of one chunk
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = aligned_smem(smem_raw);      // kWsRows x D
  unsigned char* sKV = sQ + T::bytes(kWsRows);     // S stages of [K, V] tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sKV + S * 2 * T::bytes(BN));
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + S;

  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  // Causal work grows with the query tile: start the longest blocks first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kWsRows;
  const int nk = live_key_tiles(p, min(q0 + kWsRows, p.Sq) - 1, BN);
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warpgroup() == 0) {  // producer
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 0 && nk > 0) {
      mbar_expect_tx(q_full, T::bytes(kWsRows));
      for (int ch = 0; ch < T::NCH; ++ch)
        tma_load(sQ + ch * kWsRows * T::ROWB, &maps.q, q_full, ch * T::CW, q0, h, b);
      for (int j = 0; j < nk; ++j) {
        const int s = j % S;
        mbar_wait(&empty[s], ((j / S) & 1) ^ 1);
        unsigned char* sK = sKV + s * 2 * T::bytes(BN);
        mbar_expect_tx(&full[s], 2 * T::bytes(BN));
        for (int ch = 0; ch < T::NCH; ++ch) {
          tma_load(sK + ch * BN * T::ROWB, &maps.k, &full[s], ch * T::CW, j * BN, h,
                   b);
          tma_load(sK + T::bytes(BN) + ch * BN * T::ROWB, &maps.v, &full[s],
                   ch * T::CW, j * BN, h, b);
        }
      }
    }
    return;
  }

  regs_inc<kConsumerRegs>();
  const int c = warpgroup() - 1;  // consumer warpgroup
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int qc = q0 + c * kWgRows;  // this warpgroup's first row
  // Key tiles this warpgroup needs: the block's are for its last row.
  const int nk_c =
      qc < p.Sq ? live_key_tiles(p, min(qc + kWgRows, p.Sq) - 1, BN) : 0;
  const int rows[2] = {qc + warp * 16 + g, qc + warp * 16 + g + 8};
  const float scale_log2 = p.scale * kLog2e;
  float m[2] = {kNegInf, kNegInf};  // running max, log2 units
  float l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const uint32_t q_tile = smem_addr(sQ);
  if (nk > 0) mbar_wait(q_full, 0);
  for (int j = 0; j < nk; ++j) {
    const int s = j % S;
    mbar_wait(&full[s], (j / S) & 1);
    if (j < nk_c) {
      const int k0 = j * BN;
      const uint32_t k_tile = smem_addr(sKV + s * 2 * T::bytes(BN));
      const uint32_t v_tile = k_tile + T::bytes(BN);

      float sc[NT][4];  // S = Q K^T
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(sc, T::kmajor(q_tile, kWsRows, c * kWgRows, kk),
                 T::kmajor(k_tile, BN, 0, kk), kk);
      wgmma_commit();
      wgmma_wait_all();
      pin(sc);
      mask_scores(sc, p, k0, qc, rows, t);
      // Row max over four independent chains, then across the quad.
      float mx4[4] = {neg_inf(), neg_inf(), neg_inf(), neg_inf()};
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mx4[(e >> 1) * 2 + (n & 1)] = fmaxf(mx4[(e >> 1) * 2 + (n & 1)], sc[n][e]);
      float mx[2] = {fmaxf(mx4[0], mx4[1]), fmaxf(mx4[2], mx4[3])};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      // In log2 units, P = 2^(S scale log2e - m): one FFMA and one ex2 an
      // element.  While a row has seen only masked keys its max stays
      // -1e30 and exponents are taken against 0, so masked scores give
      // 2^-inf = 0.
      float neg_m[2], alpha[2], sum4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], mx[r] * scale_log2);
        const float m_use = m_new <= kNegInf / 2 ? 0.f : m_new;
        alpha[r] = ex2(m[r] - m_use);
        neg_m[r] = -m_use;
        m[r] = m_new;
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = ex2(fmaf(sc[n][e], scale_log2, neg_m[e >> 1]));
          sc[n][e] = pe;
          sum4[(e >> 1) * 2 + (n & 1)] += pe;
        }
      float sum[2] = {sum4[0] + sum4[1], sum4[2] + sum4[3]};
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

      uint32_t pa[BN / 16][4];  // P as bf16 A fragments
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) acc_to_a<NT>(pa[kk], sc, kk);
      pin(acc);
      wgmma_fence();  // O += P V
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int ch = 0; ch < T::NCH; ++ch)
          wgmma_rs(*reinterpret_cast<Chunk*>(&acc[ch * T::CW / 8]), pa[kk],
                   T::mnmajor(v_tile, BN, kk, ch));
      wgmma_commit();
      wgmma_wait_all();
      pin(acc);
      pin(pa);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this stage may be refilled
  }

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
// dQ = sum_k dS K, dS = P * (dO V^T - delta) * scale, P from the saved lse;
// delta = rowsum(dO o O) computed here and written for dK/dV.
// ---------------------------------------------------------------------------

template <int D, int BN>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ DqMaps maps, const FlashParams p) {
  using T = Tile<D>;
  constexpr int S = kDqStages;
  constexpr int NT = BN / 8;
  constexpr int DT = D / 8;
  typedef float Chunk[T::CW / 8][4];
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = aligned_smem(smem_raw);      // kWsRows x D
  unsigned char* sdO = sQ + T::bytes(kWsRows);     // kWsRows x D
  unsigned char* sKV = sdO + T::bytes(kWsRows);    // S stages of [K, V] tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sKV + S * 2 * T::bytes(BN));
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + S;

  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kWsRows;
  const int nk = live_key_tiles(p, min(q0 + kWsRows, p.Sq) - 1, BN);
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warpgroup() == 0) {  // producer
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 0 && nk > 0) {
      mbar_expect_tx(q_full, 2 * T::bytes(kWsRows));
      for (int ch = 0; ch < T::NCH; ++ch) {
        tma_load(sQ + ch * kWsRows * T::ROWB, &maps.q, q_full, ch * T::CW, q0, h, b);
        tma_load(sdO + ch * kWsRows * T::ROWB, &maps.dout, q_full, ch * T::CW, q0, h,
                 b);
      }
      for (int j = 0; j < nk; ++j) {
        const int s = j % S;
        mbar_wait(&empty[s], ((j / S) & 1) ^ 1);
        unsigned char* sK = sKV + s * 2 * T::bytes(BN);
        mbar_expect_tx(&full[s], 2 * T::bytes(BN));
        for (int ch = 0; ch < T::NCH; ++ch) {
          tma_load(sK + ch * BN * T::ROWB, &maps.k, &full[s], ch * T::CW, j * BN, h,
                   b);
          tma_load(sK + T::bytes(BN) + ch * BN * T::ROWB, &maps.v, &full[s],
                   ch * T::CW, j * BN, h, b);
        }
      }
    }
    return;
  }

  regs_inc<kConsumerRegs>();
  const int c = warpgroup() - 1;  // consumer warpgroup
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int qc = q0 + c * kWgRows;  // this warpgroup's first row
  const int nk_c =
      qc < p.Sq ? live_key_tiles(p, min(qc + kWgRows, p.Sq) - 1, BN) : 0;
  const int rows[2] = {qc + warp * 16 + g, qc + warp * 16 + g + 8};
  const long long row_base = (static_cast<long long>(b) * p.H + h) * p.Sq;

  // Row statistics, while the Q/dO copy is in flight: -lse in log2 units,
  // -inf for a row that saw no key or lies past Sq (its P is then 0), and
  // delta * scale.  Every row below Sq gets its delta written, also when
  // the block has no live key tile: dK/dV reads it.
  float delta[2];
  row_delta<D>(delta, p, b, h, rows, t);
  float neg_lse2[2], delta_s[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = rows[r] < p.Sq;
    const float ls = in ? p.lse[row_base + rows[r]] : kNegInf;
    neg_lse2[r] = ls > kNegInf / 2 ? -ls * kLog2e : neg_inf();
    delta_s[r] = delta[r] * p.scale;
    if (t == 0 && in) p.delta_out[row_base + rows[r]] = delta[r];
  }
  const float scale_log2 = p.scale * kLog2e;
  float dq[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  const uint32_t q_tile = smem_addr(sQ), do_tile = smem_addr(sdO);
  if (nk > 0) mbar_wait(q_full, 0);
  for (int j = 0; j < nk; ++j) {
    const int s = j % S;
    mbar_wait(&full[s], (j / S) & 1);
    if (j < nk_c) {
      const int k0 = j * BN;
      const uint32_t k_tile = smem_addr(sKV + s * 2 * T::bytes(BN));
      const uint32_t v_tile = k_tile + T::bytes(BN);

      float sc[NT][4], dp[NT][4];  // S = Q K^T, dP = dO V^T
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(sc, T::kmajor(q_tile, kWsRows, c * kWgRows, kk),
                 T::kmajor(k_tile, BN, 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(dp, T::kmajor(do_tile, kWsRows, c * kWgRows, kk),
                 T::kmajor(v_tile, BN, 0, kk), kk);
      wgmma_commit();
      wgmma_wait_all();
      pin(sc);
      pin(dp);

      mask_scores(sc, p, k0, qc, rows, t);
      // dS = P (dP - delta) scale, P = 2^(S scale log2e - lse log2e).
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[n][e] = ex2(fmaf(sc[n][e], scale_log2, neg_lse2[e >> 1])) *
                     fmaf(dp[n][e], p.scale, -delta_s[e >> 1]);
      uint32_t da[BN / 16][4];  // dS as bf16 A fragments
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) acc_to_a<NT>(da[kk], sc, kk);

      pin(dq);
      wgmma_fence();  // dQ += dS K
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int ch = 0; ch < T::NCH; ++ch)
          wgmma_rs(*reinterpret_cast<Chunk*>(&dq[ch * T::CW / 8]), da[kk],
                   T::mnmajor(k_tile, BN, kk, ch));
      wgmma_commit();
      wgmma_wait_all();
      pin(dq);
      pin(da);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this stage may be refilled
  }

  bf16* dQ = static_cast<bf16*>(p.out) +
             (static_cast<long long>(b) * p.Sq * p.H + h) * D;
  store_rows<D>(dQ, static_cast<long long>(p.H) * D, dq, rows[0], rows[1], p.Sq,
                1.f, 1.f, t);
}

// ---------------------------------------------------------------------------
// dV = sum_q P^T dO, dK = sum_q dS^T Q, one block per 128 keys.  Works on
// the transposed score tile S^T = K Q^T, so the key rows stay in each
// consumer's registers and P^T, dS^T are the A operands of dV and dK.
// ---------------------------------------------------------------------------

template <int D, int BQ>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ DkvMaps maps, const FlashParams p) {
  using T = Tile<D>;
  constexpr int S = kDkvStages;
  constexpr int NT = BQ / 8;
  constexpr int DT = D / 8;
  typedef float Chunk[T::CW / 8][4];
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sK = aligned_smem(smem_raw);   // kWsRows keys x D
  unsigned char* sV = sK + T::bytes(kWsRows);
  unsigned char* sQdO = sV + T::bytes(kWsRows);  // S stages of [Q, dO] tiles
  // S stages of [lse, delta] boxes.
  float* sRows = reinterpret_cast<float*>(sQdO + S * 2 * T::bytes(BQ));
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sRows + S * 2 * stat_pad(BQ));
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + S;

  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int k0 = blockIdx.x * kWsRows;
  const int row_base = (b * p.H + h) * p.Sq;  // of lse and delta
  // First query tile that reaches this block's first key.
  int i0 = 0;
  if (p.causal) {
    const long long lag =
        static_cast<long long>(p.kv_offset) + k0 - p.q_offset;
    if (lag > 0) i0 = static_cast<int>(lag / BQ);
  }
  const int nq = (p.Sq + BQ - 1) / BQ;
  const int n_it = nq > i0 ? nq - i0 : 0;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warpgroup() == 0) {  // producer
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 0 && n_it > 0) {
      mbar_expect_tx(kv_full, 2 * T::bytes(kWsRows));
      for (int ch = 0; ch < T::NCH; ++ch) {
        tma_load(sK + ch * kWsRows * T::ROWB, &maps.k, kv_full, ch * T::CW, k0, h, b);
        tma_load(sV + ch * kWsRows * T::ROWB, &maps.v, kv_full, ch * T::CW, k0, h, b);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % S;
        const int q0 = (i0 + it) * BQ;
        mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
        unsigned char* sQ = sQdO + s * 2 * T::bytes(BQ);
        float* rows = sRows + s * 2 * stat_pad(BQ);
        mbar_expect_tx(&full[s],
                       2 * T::bytes(BQ) + 2 * stat_box(BQ) * sizeof(float));
        for (int ch = 0; ch < T::NCH; ++ch) {
          tma_load(sQ + ch * BQ * T::ROWB, &maps.q, &full[s], ch * T::CW, q0, h, b);
          tma_load(sQ + T::bytes(BQ) + ch * BQ * T::ROWB, &maps.dout, &full[s],
                   ch * T::CW, q0, h, b);
        }
        tma_load(rows, &maps.lse, &full[s], (row_base + q0) & ~3);
        tma_load(rows + stat_pad(BQ), &maps.delta, &full[s], (row_base + q0) & ~3);
      }
    }
    return;
  }

  regs_inc<kConsumerRegs>();
  const int c = warpgroup() - 1;
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int kc = k0 + c * kWgRows;  // this warpgroup's first key
  const int keys[2] = {kc + warp * 16 + g, kc + warp * 16 + g + 8};
  const float scale_log2 = p.scale * kLog2e;
  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const uint32_t k_tile = smem_addr(sK), v_tile = smem_addr(sV);
  if (n_it > 0) mbar_wait(kv_full, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % S;
    const int q0 = (i0 + it) * BQ;
    mbar_wait(&full[s], (it / S) & 1);
    // Skip the tile when this warpgroup has no key, or no query of the
    // tile reaches its first key.
    const bool live =
        kc < p.Sk &&
        !(p.causal && static_cast<long long>(p.q_offset) + q0 + BQ - 1 <
                          static_cast<long long>(p.kv_offset) + kc);
    if (live) {
      const uint32_t q_tile = smem_addr(sQdO + s * 2 * T::bytes(BQ));
      const uint32_t do_tile = q_tile + T::bytes(BQ);
      const float* sLse = sRows + s * 2 * stat_pad(BQ) + ((row_base + q0) & 3);
      const float* sDelta = sLse + stat_pad(BQ);

      float st[NT][4], dpt[NT][4];  // S^T = K Q^T, dP^T = V dO^T
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(st, T::kmajor(k_tile, kWsRows, c * kWgRows, kk),
                 T::kmajor(q_tile, BQ, 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(dpt, T::kmajor(v_tile, kWsRows, c * kWgRows, kk),
                 T::kmajor(do_tile, BQ, 0, kk), kk);
      wgmma_commit();
      wgmma_wait_all();
      pin(st);
      pin(dpt);

      // Per column (query) of this thread: -lse in log2 units, -inf for a
      // query that saw no key or lies past Sq (its P is then 0); and
      // delta * scale.
      float neg_lse2[NT][2], delta_s[NT][2];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n * 8 + 2 * t + e;
          const float ls = sLse[col];
          neg_lse2[n][e] =
              q0 + col < p.Sq && ls > kNegInf / 2 ? -ls * kLog2e : neg_inf();
          delta_s[n][e] = sDelta[col] * p.scale;
        }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)  // P^T = 2^(S^T scale log2e - lse log2e)
          st[n][e] = ex2(fmaf(st[n][e], scale_log2, neg_lse2[n][e & 1]));
      // Key rows past Sk hold zeros and are never stored, so only the
      // causal diagonal needs the per-element mask, in a branch of its own.
      const bool edge = p.causal && static_cast<long long>(p.kv_offset) + kc +
                                            kWgRows - 1 >
                                        static_cast<long long>(p.q_offset) + q0;
      if (edge) {
        int cmin[2];  // the first column (query) that sees each key row
#pragma unroll
        for (int r = 0; r < 2; ++r)
          cmin[r] = static_cast<int>(
              min(max(static_cast<long long>(p.kv_offset) + keys[r] - p.q_offset - q0,
                      0ll),
                  static_cast<long long>(BQ)));
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            st[n][e] = n * 8 + 2 * t + (e & 1) >= cmin[e >> 1] ? st[n][e] : 0.f;
      }
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];  // P^T, dS^T as A fragments
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) acc_to_a<NT>(pa[kk], st, kk);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)  // dS^T = P^T (dP^T - delta) scale
          st[n][e] *= fmaf(dpt[n][e], p.scale, -delta_s[n][e & 1]);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) acc_to_a<NT>(da[kk], st, kk);

      pin(dv);
      pin(dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)  // dV += P^T dO
#pragma unroll
        for (int ch = 0; ch < T::NCH; ++ch)
          wgmma_rs(*reinterpret_cast<Chunk*>(&dv[ch * T::CW / 8]), pa[kk],
                   T::mnmajor(do_tile, BQ, kk, ch));
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)  // dK += dS^T Q
#pragma unroll
        for (int ch = 0; ch < T::NCH; ++ch)
          wgmma_rs(*reinterpret_cast<Chunk*>(&dk[ch * T::CW / 8]), da[kk],
                   T::mnmajor(q_tile, BQ, kk, ch));
      wgmma_commit();
      wgmma_wait_all();
      pin(dv);
      pin(dk);
      pin(pa);
      pin(da);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

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

// Opt `kernel` into `smem` bytes of dynamic shared memory (above 48 KB a
// block's must be).  Each launcher calls it before it encodes its TMA maps:
// as a runtime call it makes the device's primary context current in the
// calling thread, which cuTensorMapEncodeTiled, a driver call, needs.  A
// thread that has made no runtime call yet has no current context: the
// autograd engine's device thread, when the backward on a side stream
// starts with dQ, was one (the encode failed with "invalid argument").
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// cuTensorMapEncodeTiled, a driver function, fetched through the runtime so
// the library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                                    cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

cudaError_t encode(CUtensorMap* map, CUtensorMapDataType type, cuuint32_t rank,
                   const void* base, const cuuint64_t* dims,
                   const cuuint64_t* strides, const cuuint32_t* box,
                   CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, type, rank, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// A (B, seq, H, D) bf16 operand read through its (batch, seq, head) strides:
// a rank-4 map over (D, seq, H, B) whose boxes are [rows][CW columns].
template <int D>
cudaError_t operand_map(CUtensorMap* map, const void* base,
                        const long long (&stride)[3], const FlashParams& p, int seq,
                        int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(p.H), static_cast<cuuint64_t>(p.B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(stride[1]) * 2,
                                 static_cast<cuuint64_t>(stride[2]) * 2,
                                 static_cast<cuuint64_t>(stride[0]) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(Tile<D>::CW),
                             static_cast<cuuint32_t>(rows), 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, box,
                D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
}

// A (B, H, Sq) fp32 row statistic as a rank-1 map whose boxes are `rows`
// values.
cudaError_t rows_map(CUtensorMap* map, const float* base, const FlashParams& p,
                     int rows) {
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(p.B) * p.H * p.Sq};
  const cuuint64_t strides[1] = {sizeof(float)};  // not read at rank 1
  const cuuint32_t box[1] = {static_cast<cuuint32_t>(rows)};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, base, dims, strides, box,
                CU_TENSOR_MAP_SWIZZLE_NONE);
}

constexpr size_t barrier_bytes(int stages) {
  return (1 + 2 * stages) * sizeof(uint64_t);
}

template <int D>
cudaError_t fwd(const FlashParams& p, cudaStream_t s) {
  using T = Tile<D>;
  constexpr int S = fwd_stages(D);
  constexpr size_t smem =
      1024 + T::bytes(kWsRows) + S * 2 * T::bytes(kFwdBn) + barrier_bytes(S);
  const auto kernel = flash_fwd_kernel<D, kFwdBn>;
  FwdMaps maps;
  cudaError_t err;
  if ((err = set_smem(kernel, smem)) ||
      (err = operand_map<D>(&maps.q, p.q, p.q_stride, p, p.Sq, kWsRows)) ||
      (err = operand_map<D>(&maps.k, p.k, p.k_stride, p, p.Sk, kFwdBn)) ||
      (err = operand_map<D>(&maps.v, p.v, p.v_stride, p, p.Sk, kFwdBn)))
    return err;
  kernel<<<dim3((p.Sq + kWsRows - 1) / kWsRows, p.B * p.H), kWsThreads, smem, s>>>(
      maps, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dq(const FlashParams& p, cudaStream_t s) {
  using T = Tile<D>;
  constexpr size_t smem = 1024 + 2 * T::bytes(kWsRows) +
                          kDqStages * 2 * T::bytes(kDqBn) + barrier_bytes(kDqStages);
  const auto kernel = flash_bwd_dq_kernel<D, kDqBn>;
  DqMaps maps;
  cudaError_t err;
  if ((err = set_smem(kernel, smem)) ||
      (err = operand_map<D>(&maps.q, p.q, p.q_stride, p, p.Sq, kWsRows)) ||
      (err = operand_map<D>(&maps.dout, p.dout, p.do_stride, p, p.Sq, kWsRows)) ||
      (err = operand_map<D>(&maps.k, p.k, p.k_stride, p, p.Sk, kDqBn)) ||
      (err = operand_map<D>(&maps.v, p.v, p.v_stride, p, p.Sk, kDqBn)))
    return err;
  kernel<<<dim3((p.Sq + kWsRows - 1) / kWsRows, p.B * p.H), kWsThreads, smem, s>>>(
      maps, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dkv(const FlashParams& p, cudaStream_t s) {
  using T = Tile<D>;
  constexpr int BQ = dkv_bq(D);
  constexpr size_t smem =
      1024 + 2 * T::bytes(kWsRows) +
      kDkvStages * (2 * T::bytes(BQ) + 2 * stat_pad(BQ) * sizeof(float)) +
      barrier_bytes(kDkvStages);
  const auto kernel = flash_bwd_dkv_kernel<D, BQ>;
  // The lse/delta maps address rows by a 32-bit coordinate.
  if (static_cast<long long>(p.B) * p.H * p.Sq >= (1ll << 31))
    return cudaErrorInvalidValue;
  DkvMaps maps;
  cudaError_t err;
  if ((err = set_smem(kernel, smem)) ||
      (err = operand_map<D>(&maps.q, p.q, p.q_stride, p, p.Sq, BQ)) ||
      (err = operand_map<D>(&maps.dout, p.dout, p.do_stride, p, p.Sq, BQ)) ||
      (err = operand_map<D>(&maps.k, p.k, p.k_stride, p, p.Sk, kWsRows)) ||
      (err = operand_map<D>(&maps.v, p.v, p.v_stride, p, p.Sk, kWsRows)) ||
      (err = rows_map(&maps.lse, p.lse, p, stat_box(BQ))) ||
      (err = rows_map(&maps.delta, p.delta, p, stat_box(BQ))))
    return err;
  kernel<<<dim3((p.Sk + kWsRows - 1) / kWsRows, p.B * p.H), kWsThreads, smem, s>>>(
      maps, p);
  return cudaGetLastError();
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
