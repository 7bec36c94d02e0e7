// Flash-attention forward for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel paddle_tpu/ops/flash_attention.py `_flash_fwd`
// (pallas_call at :310, kernel body `_fwd_kernel` at :191), and computes
// everything it computes:
//   o   = softmax(q·kᵀ/√d + key_bias, masked) · v     [b, h, sq, d], input dtype
//   lse = logsumexp of the same masked scores          [b, h, sq], f32
// with the causal mask aligned bottom-right (query i sees key j when
// i + (sk − sq) ≥ j), an optional additive f32 key bias [b, sk], optional
// query/key segment ids [b, sq] / [b, sk] (pairs whose ids differ are
// masked), masked probabilities zeroed explicitly, and `l` clamped to
// 1e-30, so a fully masked row gives o = 0 and lse ≈ −1e30, never NaN.
// Scores and softmax are f32; the probabilities are rounded to the value
// dtype before the P·V product, as the TPU kernel does (:224-226), and
// the row sum is taken over the unrounded ones (:220).
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense):
//   - at the GPT-base training shape, [8, 12, 1024, 64] bf16 causal (about
//     50.4 M visible query-key pairs), two products of 64 per pair are
//     about 12.9 GFLOP (0.013 ms) against 50 MB of q, k, v, o and lse
//     (0.015 ms): it sits at the ridge, where only the tensor cores and one
//     read of each tile could reach the bound;
//   - at the served prefill, [8, 12, 128, 64] bf16 causal, it must move
//     6.3 MB (1.9 µs) for about 0.2 GFLOP: 192 blocks of one or two key
//     tiles each, so it is bound by the latency of a block's loads.
//
// Both routes keep one design: one thread block owns one (batch·head,
// 64-row query tile), heavier causal tiles first, and loops over 64-key
// tiles, which replaces the TPU kernel's sequential grid axis and its
// VMEM scratch. The running max, the running sum and the f32 accumulator
// stay in registers for the whole loop, so q is read once and o written
// once. Causal key tiles wholly above the diagonal are never loaded.
// Ragged edges (sq or sk not a multiple of 64) are masked in the kernel,
// so no padded copies are made, and q, k, v are read through their
// strides, so the head split of the fused qkv projection needs no copy.
//
// Two routes. The Python wrapper chooses one by dtype and head dim (its
// ROUTES table is the one place the rule lives, shared with the backward)
// and passes it as flash_fwd's first argument; flash_fwd launches what it
// is told:
//
// bf16 at head dims 64 and 128: the tensor cores (`tc` below,
// `flash_fwd_wgmma`). One warpgroup (128 threads) a block.
//   - Loads: the q tile arrives once by TMA and stays resident; k and v
//     tiles stream through a ring of two mbarrier-guarded stages, so the
//     next tiles load while the current ones are multiplied. Thread 0
//     refills the previous tile's stage while S = Q·Kᵀ runs, with
//     predicated TMA instructions rather than a branch (a branch while a
//     product is in flight makes ptxas wait for it). All tiles come from
//     4-D tensor maps {D, s, H, B} over the operands' own strides (the
//     wrapper copies an operand whose base or strides are not multiples of
//     16 bytes), one 64 x 64 box a 64-column sub-tile, with the 128-byte
//     swizzle that the wgmma descriptors read directly; rows past sq or sk
//     arrive as zeros and never read the next head.
//   - Products: S = Q·Kᵀ is `wgmma` m64n64k16 with both operands K-major
//     from shared memory; O = O·α + P·V is m64nDk16 with A from registers:
//     the f32 accumulator of P, rounded to bf16 pairs in place, is already
//     the A operand's layout, so P never touches shared memory. B is the V
//     tile read MN-major with the transpose flag. The operands are pinned
//     around each fence so that ptxas need not serialise the products (the
//     build's `-Xptxas -v` output names any product it serialises).
//   - Softmax in registers in the log2 domain: exponentials by the SFU's
//     ex2 with flush to zero; on a tile without masks scale·log2e is
//     folded into the exponentials' FMA, so the raw products are never
//     scaled on their own. The row max reduces across the four lanes that
//     share an accumulator row; the row sum is kept per lane, from the f32
//     probabilities before they are packed to bf16, and reduced across the
//     four lanes once, at the end.
//   - Masks, chosen once a tile, outside the unrolled loop over the 32
//     scores: a tile whose pairs are all visible (no bias, no segment ids,
//     inside both edges, wholly below the causal diagonal) takes the plain
//     formula; a diagonal, edge, bias or segment tile takes the CUDA-core
//     route's conditions in its order (the key bias added; segment ids,
//     causal and the key edge masked; a score at or below NEG_INF / 2
//     gives P = 0). A branch inside that loop serialised the exponentials
//     of the backward kernels, which then took most of each tile's time.
//     A masked score is NEG_INF·log2e, and its probability is written as
//     0, so a row that has seen no visible key gets 0, not exp2(0) = 1.
//   - Epilogue: one reciprocal of l a row, not an IEEE division an
//     element; o staged as bf16 rows in the idle tiles and written out in
//     16-byte chunks, whole rows at a time. Both measured faster (PERF.md,
//     Findings).
//   - Shared memory, dynamic: 41 KB at head dim 64, 81 KB at 128. At head
//     dim 64 ptxas is held to 128 registers a thread, so four blocks share
//     an SM, which measured faster than three stages at three blocks an SM
//     (PERF.md, Findings); the build's `-Xptxas -v` lines, which chip_smoke.py
//     prints, give the registers and spills of both head dims.
//
// f32 (every head dim), and bf16 at head dim 32: the CUDA cores
// (`flash_fwd_kernel`). One block of 256 threads; tiles are widened to
// f32 in shared memory and both products run as f32 FMAs. f32 stays off
// the tensor cores on purpose: wgmma on f32 operands is TF32 (about three
// decimal digits), and the f32 kernel is held to 1e-5 of the plain f32
// forward. Head dim 32 would need the 64-byte swizzle and descriptors of
// its own, and no model of the repo uses it. The f32 tiles take 67 KB of
// dynamic shared memory at head dim 64.
//
// Build (plain C interface, loaded with ctypes by ops/_build.py; the
// tensor maps are encoded through cudaGetDriverEntryPoint, so nothing
// links against the driver library):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libflash_fwd.so flash_fwd.cu

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 64;   // query rows per block
constexpr int BLOCK_N = 64;   // keys per inner-loop tile
constexpr int THREADS = 256;  // 16 x 16 threads; each owns 4 rows x 4 score columns
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;   // [B, sk] or null
  const int* seg_q;    // [B, sq] or null (then seg_k is null too)
  const int* seg_k;    // [B, sk]
  void* o;             // [B, H, sq, D] contiguous
  float* lse;          // [B, H, sq] contiguous
  int B, H, sq, sk;
  long long q_sb, q_sh, q_ss;   // element strides; the last dim is contiguous
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  float scale;
  int causal;
};

// ---- the CUDA-core route: f32, and bf16 at head dim 32 --------------------

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

template <int D>
constexpr size_t smem_bytes() {
  // q, k, v tiles [64][D+1] f32, the probability tile [64][65] f32, the
  // key bias [64] f32 and key segment ids [64] int32
  return sizeof(float) * (3 * 64 * (D + 1) + 64 * (BLOCK_N + 1) + BLOCK_N) +
         sizeof(int) * BLOCK_N;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const Params p) {
  constexpr int LD = D + 1;         // odd row stride: no bank conflicts
  constexpr int LDP = BLOCK_N + 1;
  constexpr int DC = D / 16;        // accumulator columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + BLOCK_M * LD;
  float* v_s = k_s + BLOCK_N * LD;
  float* p_s = v_s + BLOCK_N * LD;
  float* bias_s = p_s + BLOCK_M * LDP;
  int* segk_s = reinterpret_cast<int*>(bias_s + BLOCK_N);

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  // heavier (later) causal tiles first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BLOCK_M;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int offset = p.sk - p.sq;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;

  for (int idx = tid; idx < BLOCK_M * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    const int qi = q0 + r;
    q_s[r * LD + c] = qi < p.sq ? to_f32<T>(qg[qi * p.q_ss + c]) : 0.f;
  }

  float m[4], l[4], acc[4][DC];
  int segq[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
    const int qi = q0 + ty + 16 * i;
    segq[i] = (p.seg_q != nullptr && qi < p.sq) ? p.seg_q[b * p.sq + qi] : 0;
  }

  // keys [0, kv_end) can be visible to some row of this tile
  int kv_end = p.sk;
  if (p.causal) {
    const int last_row = min(q0 + BLOCK_M, p.sq) - 1;
    kv_end = max(0, min(p.sk, last_row + offset + 1));
  }

  for (int k0 = 0; k0 < kv_end; k0 += BLOCK_N) {
    __syncthreads();  // the previous tile is consumed (and q_s is written)
    for (int idx = tid; idx < BLOCK_N * D; idx += THREADS) {
      const int r = idx / D, c = idx % D;
      const int kj = k0 + r;
      const bool in = kj < p.sk;
      k_s[r * LD + c] = in ? to_f32<T>(kg[kj * p.k_ss + c]) : 0.f;
      v_s[r * LD + c] = in ? to_f32<T>(vg[kj * p.v_ss + c]) : 0.f;
    }
    if (tid < BLOCK_N) {
      const int kj = k0 + tid;
      bias_s[tid] = (p.bias != nullptr && kj < p.sk) ? p.bias[b * p.sk + kj] : 0.f;
      segk_s[tid] = (p.seg_k != nullptr && kj < p.sk) ? p.seg_k[b * p.sk + kj] : 0;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kj = k0 + c;
        float x = s[i][j] * p.scale;
        if (p.bias != nullptr) x += bias_s[c];
        if (p.seg_q != nullptr && segq[i] != segk_s[c]) x = NEG_INF;
        if (p.causal && qi + offset < kj) x = NEG_INF;
        if (kj >= p.sk) x = NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      // the 16 threads sharing a row are one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // masked scores contribute 0, not exp(0) = 1 on an all-masked tile
        const float pv = s[i][j] <= 0.5f * NEG_INF ? 0.f : expf(s[i][j] - m_new);
        rs += pv;
        p_s[(ty + 16 * i) * LDP + tx + 16 * j] = to_f32<T>(from_f32<T>(pv));
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < BLOCK_N; ++c) {
      float pv[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int j = 0; j < DC; ++j) vv[j] = v_s[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  T* og = static_cast<T*>(p.o) + static_cast<long long>(bh) * p.sq * D;
  float* lg = p.lse + static_cast<long long>(bh) * p.sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= p.sq) continue;
    const float ll = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DC; ++j)
      og[static_cast<long long>(qi) * D + tx + 16 * j] = from_f32<T>(acc[i][j] / ll);
    if (tx == 0) lg[qi] = m[i] + logf(ll);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, (p.sq + BLOCK_M - 1) / BLOCK_M);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---- the tensor-core route: bf16 at head dims 64 and 128 -------------------

namespace tc {

constexpr int ROWS = 64;              // rows of every tile, queries and keys
constexpr int THREADS = 128;          // one warpgroup a block
constexpr uint32_t SUB = ROWS * 128;  // a [64][64] bf16 sub-tile: 128-byte rows, 8 KB
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// a masked score in log2 units, and the running max of a row that has
// seen no visible key: lse = (m + log2 l)·ln2 is then about NEG_INF, as
// on the CUDA-core route
constexpr float NEG_INF2 = NEG_INF * LOG2E;

template <int D>
struct Cfg {
  static constexpr int SUBS = D / 64;           // 64-column sub-tiles of a [64][D] tile
  static constexpr uint32_t TILE = SUBS * SUB;  // one [64][D] bf16 tile
  static constexpr int STAGES = 2;             // ring depth of the k, v pairs
  static constexpr int ACC = D / 2;             // f32 registers of the [64][D] accumulator
  // 1 KB to align the tiles (128-byte swizzle), the resident q tile, the
  // ring, one mbarrier for q and one a stage; the epilogue stages o, [64]
  // rows of D bf16 and 16 bytes, in the tiles
  static constexpr size_t SMEM = 1024 + (1 + 2 * STAGES) * TILE + 8 * (1 + STAGES);
};

struct TcParams {
  CUtensorMap q, k, v;   // 4-D maps {D, s, H, B} over q, k and v
  const float* bias;     // [B, sk] or null
  const int* seg_q;      // [B, sq] or null (then seg_k is null too)
  const int* seg_k;      // [B, sk]
  __nv_bfloat16* o;      // [B, H, sq, D] contiguous
  float* lse;            // [B, H, sq] contiguous
  int H, sq, sk;
  float scale;
  int causal;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// where `on`: arrive once and expect `bytes` more from the copies that
// signal `bar`. Predicated, not branched: a branch while a product is in
// flight makes ptxas wait for it.
__device__ __forceinline__ void mbar_expect(bool on, uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n}\n" ::"r"(bar),
      "r"(bytes), "r"(static_cast<int>(on))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// where `on`: rows [row, row + 64) of head (b, h) of `map` into the tile
// at `dst`, one TMA box a 64-column sub-tile, counted on `bar`. The map's
// 128-byte swizzle is the layout the wgmma descriptors below read; rows
// past the tensor's edge arrive as zeros.
template <int D>
__device__ __forceinline__ void tma_tile(bool on, uint32_t dst, const CUtensorMap& map,
                                         uint32_t bar, int row, int h, int b) {
#pragma unroll
  for (int c = 0; c < Cfg<D>::SUBS; ++c)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %7, 0;\n"
        "@p cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3, %4, %5}], [%6];\n}\n" ::"r"(dst + c * SUB),
        "l"(reinterpret_cast<uint64_t>(&map)), "r"(64 * c), "r"(row), "r"(h), "r"(b), "r"(bar),
        "r"(static_cast<int>(on))
        : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile (layout type
// 1): start address, leading and stride byte offsets, in 16-byte units
__device__ __forceinline__ uint64_t sdesc(uint32_t addr, uint32_t lead, uint32_t stride) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(lead >> 4) << 16 |
         static_cast<uint64_t>(stride >> 4) << 32 | 1ull << 62;
}

// a [64][D] tile as a K-major operand (its rows are M or N, its D columns
// the reduction) at reduction step kk, columns [16kk, 16kk + 16): sub-tile
// kk / 4, 32 bytes a step within its 128-byte rows; 8-row groups 1 KB apart
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
  return sdesc(tile + (kk / 4) * SUB + (kk % 4) * 32, 16, 1024);
}

// the same tile as an MN-major B operand (its rows the reduction, its D
// columns N, the transpose flag) at reduction step kk, rows [16kk, 16kk +
// 16): 8-row groups 1 KB apart, 64-column sub-tiles SUB bytes apart
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  return sdesc(tile + kk * 2048, SUB, 1024);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keep the compiler from moving the writes or reads of a wgmma operand
// (an accumulator, or an A operand in registers) across a wgmma fence or
// wait; otherwise ptxas serialises the products around the move
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// 2^x by the SFU alone, results below 2^-126 flushed to 0 (exp2f adds
// range handling around the same instruction); P that small is 0 in any
// sum here
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even, as astype does
  return *reinterpret_cast<uint32_t*>(&v);
}

// The wgmma shapes the kernel uses, each accumulating into `d` in the
// m64nN f32 layout: warp w of the warpgroup holds rows 16w + lane/4 (+8),
// d[4c .. 4c + 3] the columns 8c + 2(lane % 4) (+1) of those two rows.
// D[64 x 64] = A·B (acc 0) or D += A·B (acc 1), A and B K-major bf16
// tiles in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// D[64 x 64] += A·B, A from registers (four bf16 pairs a thread, the
// layout of a converted accumulator), B an MN-major tile in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x 128] += A·B, as above
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// S = Q·Kᵀ over head dim D from the resident q tile and a streamed k
// tile; the first step overwrites S, so S needs no zeroing (zeroing it
// between products would make ptxas serialise them)
template <int D>
__device__ __forceinline__ void scores(float (&s)[32], uint32_t q, uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_ss(s, kmajor(q, kk), kmajor(k, kk), kk > 0);
}

// O += P·V, P the 16 bf16 pairs of a converted [64][64] accumulator, V a
// [64][D] tile read MN-major: four reduction steps of 16 keys
template <int N>
__device__ __forceinline__ void accumulate(float (&o)[N], const uint32_t (&p)[16], uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(o, p + 4 * kk, mnmajor(v, kk));
}

// The block's q tile and its ring of (k, v) stages: thread 0 initialises
// the barriers, then issues the q tile and the first STAGES key tiles;
// `issue` refills a stage where `on`
template <int D>
struct Ring {
  uint32_t base, bars;
  __device__ __forceinline__ uint32_t q() const { return base; }
  __device__ __forceinline__ uint32_t stage(int s, int i) const {
    return base + (1 + 2 * s + i) * Cfg<D>::TILE;
  }
  __device__ __forceinline__ uint32_t bar(int s) const { return bars + 8 * (1 + s); }
  __device__ __forceinline__ void issue(bool on, const CUtensorMap& k, const CUtensorMap& v,
                                        int s, int row, int h, int b) const {
    mbar_expect(on, bar(s), 2 * Cfg<D>::TILE);
    tma_tile<D>(on, stage(s, 0), k, bar(s), row, h, b);
    tma_tile<D>(on, stage(s, 1), v, bar(s), row, h, b);
  }
  __device__ __forceinline__ void wait(int it) const {
    mbar_wait(bar(it % Cfg<D>::STAGES), (it / Cfg<D>::STAGES) & 1);
  }
};

template <int D>
__device__ __forceinline__ Ring<D> start_ring(uint8_t* smem, int n_tiles, const TcParams& p,
                                              int q0, int h, int b) {
  Ring<D> ring;
  ring.base = (smem_u32(smem) + 1023) & ~1023u;
  ring.bars = ring.base + (1 + 2 * Cfg<D>::STAGES) * Cfg<D>::TILE;
  if (threadIdx.x == 0) {
    mbar_init(ring.bars, 1);
    for (int s = 0; s < Cfg<D>::STAGES; ++s) mbar_init(ring.bar(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0 && n_tiles > 0) {
    mbar_expect(true, ring.bars, Cfg<D>::TILE);
    tma_tile<D>(true, ring.q(), p.q, ring.bars, q0, h, b);
    for (int s = 0; s < Cfg<D>::STAGES && s < n_tiles; ++s)
      ring.issue(true, p.k, p.v, s, s * ROWS, h, b);
  }
  if (n_tiles > 0) mbar_wait(ring.bars, 0);
  return ring;
}

// one block per (b·h, 64-row query tile)
template <int D>
__global__ void __launch_bounds__(THREADS, D == 64 ? 4 : 1) flash_fwd_wgmma(const __grid_constant__ TcParams p) {
  extern __shared__ uint8_t tc_smem[];
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  // heavier (later) causal tiles first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS;
  const int lane = threadIdx.x % 32;
  const int r0 = 16 * (threadIdx.x / 32) + lane / 4;  // rows r0 and r0 + 8 of S and O
  const int c0 = 2 * (lane % 4);                      // columns c0 + 8j (+1)
  const int offset = p.sk - p.sq;
  // keys [0, kv_end) can be visible to some row of this tile; the tiles
  // wholly above the causal diagonal are never loaded
  int kv_end = p.sk;
  if (p.causal) kv_end = max(0, min(p.sk, min(q0 + ROWS, p.sq) + offset));
  const int n_tiles = (kv_end + ROWS - 1) / ROWS;

  const Ring<D> ring = start_ring<D>(tc_smem, n_tiles, p, q0, h, b);

  int segq[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + r0 + 8 * i;
    segq[i] = (p.seg_q != nullptr && qi < p.sq) ? p.seg_q[b * p.sq + qi] : 0;
  }
  const bool plain = p.bias == nullptr && p.seg_q == nullptr;
  const float scale_log2 = p.scale * LOG2E;
  // running max (log2 units) and this lane's share of the running sum of
  // rows r0 and r0 + 8
  float m[2] = {NEG_INF2, NEG_INF2}, l[2] = {0.f, 0.f};
  float o[Cfg<D>::ACC];
#pragma unroll
  for (int j = 0; j < Cfg<D>::ACC; ++j) o[j] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * ROWS;
    const uint32_t k_t = ring.stage(it % Cfg<D>::STAGES, 0);
    const uint32_t v_t = ring.stage(it % Cfg<D>::STAGES, 1);
    // a tile every pair of which is visible skips the masks
    const bool inside = plain && k0 + ROWS <= p.sk && q0 + ROWS <= p.sq &&
                        (!p.causal || q0 + offset >= k0 + ROWS - 1);
    float bias[16];
    int segk[16];
    if (!inside) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int kj = k0 + c0 + 8 * (j / 2) + j % 2;
        const bool in = kj < p.sk;
        bias[j] = (p.bias != nullptr && in) ? p.bias[b * p.sk + kj] : 0.f;
        segk[j] = (p.seg_k != nullptr && in) ? p.seg_k[b * p.sk + kj] : 0;
      }
    }
    ring.wait(it);
    float s[32];
    pin(o);
    wg_fence();
    scores<D>(s, ring.q(), k_t);
    wg_commit();
    // while S is computed: the previous tile's stage is free (every warp
    // passed the barrier at the end of its tile), so thread 0 refills it
    ring.issue(threadIdx.x == 0 && it > 0 && it - 1 + Cfg<D>::STAGES < n_tiles, p.k, p.v,
               (it + Cfg<D>::STAGES - 1) % Cfg<D>::STAGES, k0 + (Cfg<D>::STAGES - 1) * ROWS, h, b);
    wg_wait<0>();
    pin(s);
    // An inside tile keeps its raw products, scaled to log2 units inside
    // the exponentials' FMA; any other tile turns them into masked scores
    // in log2 units. The branches stay outside the loops: inside them
    // they serialise the exponentials.
    float unit = scale_log2;
    if (!inside) {
      unit = 1.f;
      // the CUDA-core route's conditions in its order: the key bias added,
      // then segment ids, causal and the key edge masked
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int i = (j / 2) % 2, c = 2 * (j / 4) + j % 2;
        const int qi = q0 + r0 + 8 * i, kj = k0 + c0 + 8 * (j / 4) + j % 2;
        const float x = s[j] * p.scale + bias[c];
        const bool masked = (p.seg_q != nullptr && segq[i] != segk[c]) ||
                            (p.causal && qi + offset < kj) || kj >= p.sk;
        s[j] = masked ? NEG_INF2 : x * LOG2E;
      }
    }
    // the new running max of each row (log2 units): this lane's 16 scores
    // of it, then the four lanes that share the row
    float mx[2] = {s[0], s[2]};
#pragma unroll
    for (int j = 0; j < 32; ++j) mx[(j / 2) % 2] = fmaxf(mx[(j / 2) % 2], s[j]);
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i] * unit);
      alpha[i] = exp2_ftz(m[i] - m_new);  // 1 while the row has seen no visible key
      m[i] = m_new;
    }
    // P in f32. Masked probabilities are exactly 0 (`_zero_masked` :139):
    // on a row that has seen no visible key the max is NEG_INF2 too, and
    // exp2(s − m) would be 1.
    if (inside) {
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] = exp2_ftz(fmaf(s[j], scale_log2, -m[(j / 2) % 2]));
    } else {
#pragma unroll
      for (int j = 0; j < 32; ++j)
        s[j] = s[j] <= 0.5f * NEG_INF2 ? 0.f : exp2_ftz(s[j] - m[(j / 2) % 2]);
    }
    // the row sum from the unrounded P (:220)
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] *= alpha[i];
#pragma unroll
    for (int j = 0; j < 32; ++j) l[(j / 2) % 2] += s[j];
#pragma unroll
    for (int j = 0; j < Cfg<D>::ACC; ++j) o[j] *= alpha[(j / 2) % 2];
    // P rounded to v's dtype for P·V (:225), as the A operand
    uint32_t pp[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) pp[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
    pin(pp);
    pin(o);
    wg_fence();
    accumulate(o, pp, v_t);  // O += P·V, V read MN-major
    wg_commit();
    wg_wait<0>();
    pin(o);
    __syncthreads();  // every warp is done with this stage
  }

  // o = acc / l, staged through the (now idle) tiles as [64][D] bf16 rows
  // padded by 16 bytes, so the fragment writes miss no bank twice; then
  // written out in 16-byte chunks, whole rows at a time. Rows past sq are
  // not written.
  constexpr int LD = D * 2 + 16;  // bytes a staged row
  static_assert(ROWS * LD <= (1 + 2 * Cfg<D>::STAGES) * Cfg<D>::TILE, "o fits the tiles");
  uint8_t* stage = tc_smem + (ring.base - smem_u32(tc_smem));
  const long long rows = static_cast<long long>(bh) * p.sq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float ll = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / ll;
    const int r = r0 + 8 * i;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<uint32_t*>(stage + r * LD + (8 * c + c0) * 2) =
          pack_bf16(o[4 * c + 2 * i] * inv, o[4 * c + 2 * i + 1] * inv);
    if (lane % 4 == 0 && q0 + r < p.sq) p.lse[rows + q0 + r] = (m[i] + log2f(ll)) * LN2;
  }
  __syncthreads();
  constexpr int CHUNKS = D / 8;  // 16-byte chunks a row
#pragma unroll
  for (int n = threadIdx.x; n < ROWS * CHUNKS; n += THREADS) {
    const int r = n / CHUNKS, c = n % CHUNKS;
    if (q0 + r < p.sq)
      *reinterpret_cast<uint4*>(p.o + (rows + q0 + r) * D + 8 * c) =
          *reinterpret_cast<const uint4*>(stage + r * LD + 16 * c);
  }
}

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// (no -lcuda at link time)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// the 4-D map {D, rows, H, B} of a bf16 [B, H, rows, D] tensor with element
// strides sb, sh, ss (the last dim contiguous): 64 x 64 boxes, 128-byte
// swizzle, zeros past the edges. The wrapper has checked that the base and
// the strides are multiples of 16 bytes, as TMA requires.
bool encode(CUtensorMap* map, const void* ptr, int D, int rows, int H, int B, long long ss,
            long long sh, long long sb) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2, static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, ROWS, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  TcParams t = {};
  // with no key every block loads nothing (kv_end is 0) and writes o = 0,
  // lse ≈ NEG_INF; a map cannot be encoded over 0 rows, and none is read
  if (p.sk > 0 && (!encode(&t.q, p.q, D, p.sq, p.H, p.B, p.q_ss, p.q_sh, p.q_sb) ||
                   !encode(&t.k, p.k, D, p.sk, p.H, p.B, p.k_ss, p.k_sh, p.k_sb) ||
                   !encode(&t.v, p.v, D, p.sk, p.H, p.B, p.v_ss, p.v_sh, p.v_sb)))
    return cudaErrorInvalidValue;
  t.bias = p.bias;
  t.seg_q = p.seg_q;
  t.seg_k = p.seg_k;
  t.o = static_cast<__nv_bfloat16*>(p.o);
  t.lse = p.lse;
  t.H = p.H;
  t.sq = p.sq;
  t.sk = p.sk;
  t.scale = p.scale;
  t.causal = p.causal;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Cfg<D>::SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, (p.sq + ROWS - 1) / ROWS);
  flash_fwd_wgmma<D><<<grid, THREADS, Cfg<D>::SMEM, stream>>>(t);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// route: the kernel to launch, as the wrapper chose it: 0 = float32 on the
// CUDA cores, 1 = bfloat16 on the CUDA cores (head dim 32), 2 = bfloat16 on
// the tensor cores (head dims 64, 128). Returns cudaGetLastError() after
// the launch (0 on success), or cudaErrorInvalidValue for a route and head
// dim the kernels were not built for. Launches on `stream`; does not
// synchronise.
extern "C" int flash_fwd(int route, int head_dim,
                         const void* q, const void* k, const void* v,
                         const void* bias, const void* seg_q, const void* seg_k,
                         void* o, void* lse,
                         int B, int H, int sq, int sk,
                         long long q_sb, long long q_sh, long long q_ss,
                         long long k_sb, long long k_sh, long long k_ss,
                         long long v_sb, long long v_sh, long long v_ss,
                         float scale, int causal, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = static_cast<const float*>(bias);
  p.seg_q = static_cast<const int*>(seg_q);
  p.seg_k = static_cast<const int*>(seg_k);
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.B = B;
  p.H = H;
  p.sq = sq;
  p.sk = sk;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.scale = scale;
  p.causal = causal;
  if (B * H == 0 || sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (route) {
    case 0:  // f32 on the CUDA cores
      switch (head_dim) {
        case 32: return launch<float, 32>(p, s);
        case 64: return launch<float, 64>(p, s);
        case 128: return launch<float, 128>(p, s);
      }
      break;
    case 1:  // bf16 on the CUDA cores
      if (head_dim == 32) return launch<__nv_bfloat16, 32>(p, s);
      break;
    case 2:  // bf16 on the tensor cores
      if (head_dim == 64) return tc::launch<64>(p, s);
      if (head_dim == 128) return tc::launch<128>(p, s);
      break;
  }
  return cudaErrorInvalidValue;
}
