// Flash-attention backward for Hopper (sm_90a), written by hand: two
// passes, as in the TPU package, with no atomics.
//
// Replaces the two TPU kernels of paddle_tpu/ops/flash_attention.py
// `_flash_bwd` (:424):
//   - the dQ pass, pallas_call at :503, kernel body `_dq_kernel` (:342):
//       dQ = Σ_k dS·K
//   - the dK/dV pass, pallas_call at :550, body `_dkv_kernel` (:379):
//       dV = Σ_q Pᵀ·dO,   dK = Σ_q dSᵀ·Q
// where, recomputed tile by tile from the forward's saved logsumexp,
//   P  = exp(q·kᵀ·scale + key_bias − lse)   (masked pairs 0)
//   dP = dO·Vᵀ
//   dS = P ∘ (dP − δ) · scale,   δ = rowsum(O ∘ dO)   (given, f32)
// with the forward's masks exactly (flash_fwd.cu's conditions, in its
// order: causal aligned bottom-right, f32 key bias, query/key segment
// ids), and the TPU
// kernels' rounding points: P is rounded to dO's dtype before dV (:407),
// dS to k's dtype before dQ (:371) and to q's dtype before dK (:415); every
// product accumulates in f32. Outputs are in the input dtype.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense), at
// the GPT-base training shape [8, 12, 1024, 64] bf16 causal (about 50.4 M
// visible query-key pairs):
//   - the dQ pass does three products per visible pair (q·k, dO·v, dS·k):
//     about 19 GFLOP, 0.020 ms, against 64 MB of q, k, v, dO, lse, δ and
//     dQ (0.019 ms);
//   - the dK/dV pass does four (q·k, dO·v, Pᵀ·dO, dSᵀ·q): about 26 GFLOP,
//     0.026 ms, against 76 MB (0.023 ms);
// so both sit at the ridge, where only the tensor cores and one read of
// each tile could reach the bound.
//
// Both passes keep the TPU kernels' split: one thread block owns one
// (batch·head, 64-row tile) and loops over the other side's 64-row tiles,
// which replaces the TPU kernels' sequential grid axis and their VMEM
// scratch. The f32 accumulators (dQ; or dK and dV) stay in registers for
// the whole loop and are written once, so no block writes what another
// block writes, the result is the same from run to run, and no atomics or
// second reduction are needed. The dQ pass visits key tiles up to the
// last one its rows can see (`_kj_clamp` :155), heavier causal tiles
// first; the dK/dV pass starts at the first query tile that can see its
// keys, ⌊max(0, k0 − (sk − sq))/64⌋ (`_qi_clamp` :173). Nothing is padded:
// rows past sq and keys past sk are masked in the kernel, never summed and
// never written, and rows that see no key get dq = 0.
//
// Two routes. The Python wrapper chooses one by dtype and head dim (its
// BWD_ROUTES table is the one place the rule lives) and passes it as the
// entry points' first argument; run() launches what it is told:
//
// bf16 at head dims 64 and 128: the tensor cores (`tc` below). One
// warpgroup (128 threads) a block, 64-row tiles on both sides: a 64-row
// block keeps the f32 accumulators (dK and dV: 2·D/2 registers a thread;
// dQ: D/2) beside the two 64 x 64 score tiles in registers, and 1,536
// blocks at the training shape fill 132 SMs at two (dK/dV) or three (dQ)
// blocks an SM.
//   - Loads: the block's resident pair (k and v in the dK/dV pass, q and
//     dO in the dQ pass) and the streamed pair (q and dO; k and v) arrive
//     by TMA, one 64 x 64 box a 64-column sub-tile, from 4-D tensor maps
//     {D, s, H, B} over the operands' own strides (the fused qkv
//     projection's head views and dO's transposed view need no copy; the
//     wrapper copies an operand whose base or strides are not multiples of
//     16 bytes). The streamed pair runs through a ring of mbarrier-guarded
//     stages (3 at head dim 64, 2 at 128), so the next tiles load while
//     the current ones are multiplied; rows past an edge arrive as zeros.
//     The maps use the 128-byte swizzle, which the wgmma descriptors read
//     directly. The dK/dV pass's lse and δ of the next query tile are
//     fetched, one value a thread, while the current tile is multiplied,
//     and read from shared memory.
//   - Products: `wgmma` m64n64k16 for the scores (S or Sᵀ, dP or dPᵀ: both
//     operands K-major from shared memory), and m64nDk16 for the sums with
//     A from registers: the f32 accumulator of P or dS, rounded to bf16
//     pairs in place, is already the A operand's layout, so P and dS never
//     touch shared memory (and the rounding points above are where the
//     conversion happens). B is a ring tile (dO or q in the dK/dV pass, k
//     in the dQ pass) read MN-major with the transpose flag, so one
//     swizzled copy of each tile serves both of its products. dV += Pᵀ·dO
//     runs while dSᵀ is formed. The operands are pinned around each fence
//     so that ptxas need not serialise the products (the build's
//     `-Xptxas -v` output names any product it serialises).
//   - Masks: a tile whose pairs are all visible (no bias, no segment ids,
//     inside both edges, below the causal diagonal) takes P = exp2(s·scale·
//     log2e − lse·log2e) with no mask arithmetic; the diagonal, edge, bias
//     and segment tiles take masked_score's conditions. The choice is made
//     once a tile, outside the unrolled loop over the 32 scores: a branch
//     inside it serialised the exponentials, which then took most of each
//     tile's time. The exponentials are the SFU's ex2 with flush to zero.
//   - Shared memory, dynamic: 66 KB at head dim 64, 98 KB at 128 (both
//     passes). Registers a thread (`-Xptxas -v`, which chip_smoke.py's
//     build phase prints): dQ 158 and dK/dV 202 at head dim 64, no
//     spills (three and two blocks an SM); dQ 194 and dK/dV 255 at 128,
//     where dK/dV spills 156 bytes.
//   - Head dim 32 stays on the CUDA cores: its 64-byte rows would need the
//     64-byte swizzle and descriptors of their own, and no model of the
//     repo uses it.
//
// f32 (every head dim), and bf16 at head dim 32: the CUDA cores. One block
// of 256 threads; tiles are widened to f32 in shared memory and every
// product runs as f32 FMAs. f32 stays off the tensor cores on purpose:
// wgmma on f32 operands is TF32 (about 3 decimal digits), and the f32
// kernels are held to 1e-4 of the plain f32 backward. Shared memory: 83 KB
// (dQ) and 101 KB (dK/dV) at head dim 64, 149 KB and 166 KB at 128.
//
// Build (plain C interface, loaded with ctypes by ops/_build.py; the
// tensor maps are encoded through cudaGetDriverEntryPoint, so nothing
// links against the driver library):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libflash_bwd.so flash_bwd.cu

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

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

// x rounded to T and widened back: the TPU kernels' `.astype(dtype)`
// before a product whose operands they keep in the input dtype
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

// The score of query row qi against key kj, with flash_fwd.cu's masks in
// its order (`_block_scores` :84, shared by the three TPU kernels):
// dot·scale plus the key bias where there is one, then NEG_INF where the
// segment ids differ, where the bottom-right causal mask hides the key
// (qi + (sk − sq) < kj) and for a key past sk. The dK/dV pass also masks
// query rows past sq, which it sums over (`row_outside`); the forward and
// dQ passes never write such rows.
__device__ __forceinline__ float masked_score(float dot, float scale,
                                              const float* bias, int c,
                                              bool seg_differs, bool causal,
                                              int qi, int kj, int offset, int sk,
                                              bool row_outside) {
  float x = dot * scale;
  if (bias != nullptr) x += bias[c];
  if (seg_differs) x = NEG_INF;
  if (causal && qi + offset < kj) x = NEG_INF;
  if (kj >= sk || row_outside) x = NEG_INF;
  return x;
}

// exp(x − ref) with masked scores giving 0 (`_zero_masked` :139): where
// every score of a row is NEG_INF, ref is about NEG_INF too and
// exp(x − ref) would be exp(0) = 1, not 0.
__device__ __forceinline__ float masked_exp(float x, float ref) {
  return x <= 0.5f * NEG_INF ? 0.f : expf(x - ref);
}

// ---- the CUDA-core route: f32, and bf16 at head dim 32 --------------------

constexpr int BLOCK = 64;     // rows of a tile, on both sides
constexpr int THREADS = 256;  // 16 x 16 threads; each owns 4 x 4 of a 64 x 64 tile
constexpr int LDT = BLOCK + 1;  // row stride of the 64 x 64 score tiles

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;   // [B, sk] or null
  const int* seg_q;    // [B, sq] or null (then seg_k is null too)
  const int* seg_k;    // [B, sk]
  const void* dout;    // dO, strided like q
  const float* lse;    // [B, H, sq] contiguous
  const float* delta;  // [B, H, sq] contiguous
  void* dq;            // [B, H, sq, D] contiguous (dQ pass)
  void* dk;            // [B, H, sk, D] contiguous (dK/dV pass)
  void* dv;            // [B, H, sk, D] contiguous (dK/dV pass)
  int B, H, sq, sk;
  long long q_sb, q_sh, q_ss;   // element strides; the last dim is contiguous
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;   // dO's
  float scale;
  int causal;
};

// rows [r0, r0 + 64) of a [rows, D] matrix at `g` (row stride `ss`) into
// the f32 tile `dst` [64][D + 1]; rows at or past `rows` read as 0
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* g, long long ss,
                                          int r0, int rows) {
  for (int idx = threadIdx.x; idx < BLOCK * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    dst[r * (D + 1) + c] = r0 + r < rows ? to_f32<T>(g[(r0 + r) * ss + c]) : 0.f;
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // q, dO, k, v tiles [64][D+1] f32, the dS tile [64][65] f32, the key
  // bias [64] f32 and key segment ids [64] int32
  return sizeof(float) * (4 * BLOCK * (D + 1) + BLOCK * LDT + BLOCK) +
         sizeof(int) * BLOCK;
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // k, v, q, dO tiles [64][D+1] f32, the Pᵀ and dSᵀ tiles [64][65] f32,
  // lse and δ [64] f32 and query segment ids [64] int32
  return sizeof(float) * (4 * BLOCK * (D + 1) + 2 * BLOCK * LDT + 2 * BLOCK) +
         sizeof(int) * BLOCK;
}

// ---- dQ pass: one block per (b·h, 64-row query tile) ----------------------

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const Params p) {
  constexpr int LD = D + 1;   // odd row stride: no bank conflicts
  constexpr int DC = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + BLOCK * LD;
  float* k_s = do_s + BLOCK * LD;
  float* v_s = k_s + BLOCK * LD;
  float* ds_s = v_s + BLOCK * LD;
  float* bias_s = ds_s + BLOCK * LDT;
  int* segk_s = reinterpret_cast<int*>(bias_s + BLOCK);

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  // heavier (later) causal tiles first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BLOCK;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int offset = p.sk - p.sq;

  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  load_tile<T, D>(q_s, static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh,
                  p.q_ss, q0, p.sq);
  load_tile<T, D>(do_s, static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh,
                  p.o_ss, q0, p.sq);

  const float* lse_g = p.lse + static_cast<long long>(bh) * p.sq;
  const float* delta_g = p.delta + static_cast<long long>(bh) * p.sq;
  float lse[4], delta[4], acc[4][DC];
  int segq[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    const bool in = qi < p.sq;
    lse[i] = in ? lse_g[qi] : 0.f;
    delta[i] = in ? delta_g[qi] : 0.f;
    segq[i] = (p.seg_q != nullptr && in) ? p.seg_q[b * p.sq + qi] : 0;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  // keys [0, kv_end) can be visible to some row of this tile
  int kv_end = p.sk;
  if (p.causal) {
    const int last_row = min(q0 + BLOCK, p.sq) - 1;
    kv_end = max(0, min(p.sk, last_row + offset + 1));
  }

  for (int k0 = 0; k0 < kv_end; k0 += BLOCK) {
    __syncthreads();  // the previous tile is consumed (and q_s, do_s are written)
    load_tile<T, D>(k_s, kg, p.k_ss, k0, p.sk);
    load_tile<T, D>(v_s, vg, p.v_ss, k0, p.sk);
    if (tid < BLOCK) {
      const int kj = k0 + tid;
      bias_s[tid] = (p.bias != nullptr && kj < p.sk) ? p.bias[b * p.sk + kj] : 0.f;
      segk_s[tid] = (p.seg_k != nullptr && kj < p.sk) ? p.seg_k[b * p.sk + kj] : 0;
    }
    __syncthreads();

    // S = q·kᵀ and dP = dO·vᵀ for rows ty + 16i, keys tx + 16j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = q_s[(ty + 16 * i) * LD + d];
        gv[i] = do_s[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = k_s[(tx + 16 * j) * LD + d];
        vv[j] = v_s[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float x = masked_score(
            s[i][j], p.scale, p.bias != nullptr ? bias_s : nullptr, c,
            p.seg_q != nullptr && segq[i] != segk_s[c], p.causal, qi, k0 + c,
            offset, p.sk, false);
        const float pv = masked_exp(x, lse[i]);
        // dS rounded to k's dtype for the dS·K product (:371)
        ds_s[(ty + 16 * i) * LDT + c] = round_to<T>(pv * (dp[i][j] - delta[i]) * p.scale);
      }
    }
    __syncthreads();

    // dQ += dS·K
#pragma unroll 8
    for (int c = 0; c < BLOCK; ++c) {
      float dsv[4], kk[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = ds_s[(ty + 16 * i) * LDT + c];
#pragma unroll
      for (int j = 0; j < DC; ++j) kk[j] = k_s[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(dsv[i], kk[j], acc[i][j]);
    }
  }

  T* dqg = static_cast<T*>(p.dq) + static_cast<long long>(bh) * p.sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= p.sq) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      dqg[static_cast<long long>(qi) * D + tx + 16 * j] = from_f32<T>(acc[i][j]);
  }
}

// ---- dK/dV pass: one block per (b·h, 64-row key tile) ---------------------

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const Params p) {
  constexpr int LD = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + BLOCK * LD;
  float* q_s = v_s + BLOCK * LD;
  float* do_s = q_s + BLOCK * LD;
  float* pt_s = do_s + BLOCK * LD;    // Pᵀ [key][query], rounded to dO's dtype
  float* dst_s = pt_s + BLOCK * LDT;  // dSᵀ [key][query], rounded to q's dtype
  float* lse_s = dst_s + BLOCK * LDT;
  float* delta_s = lse_s + BLOCK;
  int* segq_s = reinterpret_cast<int*>(delta_s + BLOCK);

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  // earlier key tiles see more causal queries: they come first
  const int k0 = blockIdx.y * BLOCK;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int offset = p.sk - p.sq;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* og = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;
  load_tile<T, D>(k_s, static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh,
                  p.k_ss, k0, p.sk);
  load_tile<T, D>(v_s, static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh,
                  p.v_ss, k0, p.sk);
  const float* lse_g = p.lse + static_cast<long long>(bh) * p.sq;
  const float* delta_g = p.delta + static_cast<long long>(bh) * p.sq;

  float bias[4], acc_k[4][DC], acc_v[4][DC];
  int segk[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty + 16 * i;
    const bool in = kj < p.sk;
    bias[i] = (p.bias != nullptr && in) ? p.bias[b * p.sk + kj] : 0.f;
    segk[i] = (p.seg_k != nullptr && in) ? p.seg_k[b * p.sk + kj] : 0;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;
  }

  // the first query row that can see key k0 is k0 − offset
  int q_begin = 0;
  if (p.causal) q_begin = (max(0, k0 - offset) / BLOCK) * BLOCK;

  for (int q0 = q_begin; q0 < p.sq; q0 += BLOCK) {
    __syncthreads();  // the previous tile is consumed (and k_s, v_s are written)
    load_tile<T, D>(q_s, qg, p.q_ss, q0, p.sq);
    load_tile<T, D>(do_s, og, p.o_ss, q0, p.sq);
    if (tid < BLOCK) {
      const int qi = q0 + tid;
      const bool in = qi < p.sq;
      lse_s[tid] = in ? lse_g[qi] : 0.f;
      delta_s[tid] = in ? delta_g[qi] : 0.f;
      segq_s[tid] = (p.seg_q != nullptr && in) ? p.seg_q[b * p.sq + qi] : 0;
    }
    __syncthreads();

    // Sᵀ = k·qᵀ and dPᵀ = v·dOᵀ for keys ty + 16i, query rows tx + 16j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[4], gv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = k_s[(ty + 16 * i) * LD + d];
        vv[i] = v_s[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = q_s[(tx + 16 * j) * LD + d];
        gv[j] = do_s[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[j], kv[i], s[i][j]);
          dp[i][j] = fmaf(gv[j], vv[i], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kj = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
        // bias[i] is a register, 0 without a bias: adding it costs no load
        const float x = masked_score(
            s[i][j], p.scale, bias, i,
            p.seg_q != nullptr && segq_s[r] != segk[i], p.causal, q0 + r, kj,
            offset, p.sk, q0 + r >= p.sq);
        const float pv = masked_exp(x, lse_s[r]);
        // P rounded to dO's dtype for Pᵀ·dO (:407); dS from the unrounded
        // P, rounded to q's dtype for dSᵀ·Q (:415)
        pt_s[(ty + 16 * i) * LDT + r] = round_to<T>(pv);
        dst_s[(ty + 16 * i) * LDT + r] =
            round_to<T>(pv * (dp[i][j] - delta_s[r]) * p.scale);
      }
    }
    __syncthreads();

    // dV += Pᵀ·dO, dK += dSᵀ·Q
#pragma unroll 4
    for (int r = 0; r < BLOCK; ++r) {
      float pv[4], dsv[4], gg[DC], qq[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = pt_s[(ty + 16 * i) * LDT + r];
        dsv[i] = dst_s[(ty + 16 * i) * LDT + r];
      }
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        gg[j] = do_s[r * LD + tx + 16 * j];
        qq[j] = q_s[r * LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          acc_v[i][j] = fmaf(pv[i], gg[j], acc_v[i][j]);
          acc_k[i][j] = fmaf(dsv[i], qq[j], acc_k[i][j]);
        }
    }
  }

  T* dkg = static_cast<T*>(p.dk) + static_cast<long long>(bh) * p.sk * D;
  T* dvg = static_cast<T*>(p.dv) + static_cast<long long>(bh) * p.sk * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= p.sk) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const long long at = static_cast<long long>(kj) * D + tx + 16 * j;
      dkg[at] = from_f32<T>(acc_k[i][j]);
      dvg[at] = from_f32<T>(acc_v[i][j]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, bool dq_pass, cudaStream_t stream) {
  const size_t smem = dq_pass ? dq_smem_bytes<D>() : dkv_smem_bytes<D>();
  void (*kernel)(const Params) =
      dq_pass ? &flash_bwd_dq_kernel<T, D> : &flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int rows = dq_pass ? p.sq : p.sk;
  const dim3 grid(p.B * p.H, (rows + BLOCK - 1) / BLOCK);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---- the tensor-core route: bf16 at head dims 64 and 128 -------------------

namespace tc {

constexpr int ROWS = 64;              // rows of every tile, on both sides
constexpr int THREADS = 128;          // one warpgroup a block
constexpr uint32_t SUB = ROWS * 128;  // a [64][64] bf16 sub-tile: 128-byte rows, 8 KB
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int SUBS = D / 64;           // 64-column sub-tiles of a [64][D] tile
  static constexpr uint32_t TILE = SUBS * SUB;  // one [64][D] bf16 tile
  static constexpr int STAGES = D == 64 ? 3 : 2;  // ring depth of the streamed pair
  static constexpr int ACC = D / 2;             // f32 registers of a [64][D] accumulator
  // 1 KB to align the tiles (128-byte swizzle), the two resident tiles,
  // the ring, one mbarrier for the resident pair and one a stage (64
  // bytes), and the dK/dV pass's lse and δ of two query tiles
  static constexpr size_t SMEM = 1024 + (2 + 2 * STAGES) * TILE + 64 + 4 * ROWS * sizeof(float);
};

struct TcParams {
  CUtensorMap q, k, v, o;  // 4-D maps {D, s, H, B} over q, k, v and dO
  const float* bias;       // [B, sk] or null
  const int* seg_q;        // [B, sq] or null (then seg_k is null too)
  const int* seg_k;        // [B, sk]
  const float* lse;        // [B, H, sq] contiguous
  const float* delta;      // [B, H, sq] contiguous
  __nv_bfloat16* out0;     // dQ (dQ pass) or dK, [B, H, s, D] contiguous
  __nv_bfloat16* out1;     // dV
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

// arrive once and expect `bytes` more from the copies that signal `bar`
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
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

// rows [row, row + 64) of head (b, h) of `map` into the tile at `dst`, one
// TMA box a 64-column sub-tile, counted on `bar`. The map's 128-byte
// swizzle is the layout the wgmma descriptors below read; rows past the
// tensor's edge arrive as zeros.
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap& map, uint32_t bar,
                                         int row, int h, int b) {
#pragma unroll
  for (int c = 0; c < Cfg<D>::SUBS; ++c)
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst + c * SUB),
        "l"(reinterpret_cast<uint64_t>(&map)), "r"(64 * c), "r"(row), "r"(h), "r"(b), "r"(bar)
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

// The three wgmma shapes the passes use, each accumulating into `d` in the
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

// S = A·Bᵀ over head dim D from two resident or streamed [64][D] tiles;
// the first step overwrites S, so S needs no zeroing (zeroing it between
// products would make ptxas serialise them)
template <int D>
__device__ __forceinline__ void scores(float (&s)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_ss(s, kmajor(a, kk), kmajor(b, kk), kk > 0);
}

// D += A·T, A the 16 bf16 pairs of a converted [64][64] accumulator, T a
// [64][D] tile read MN-major: four reduction steps of 16
template <int N>
__device__ __forceinline__ void accumulate(float (&d)[N], const uint32_t (&a)[16], uint32_t t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(d, a + 4 * kk, mnmajor(t, kk));
}

// The block's barriers and ring: thread 0 initialises the barriers, then
// issues the resident pair (k, v or q, dO) and the first STAGES streamed
// pairs; `issue` refills a stage
template <int D>
struct Ring {
  uint32_t base, bars;
  __device__ __forceinline__ uint32_t resident(int i) const { return base + i * Cfg<D>::TILE; }
  __device__ __forceinline__ uint32_t stage(int s, int i) const {
    return base + (2 + 2 * s + i) * Cfg<D>::TILE;
  }
  __device__ __forceinline__ uint32_t bar(int s) const { return bars + 8 * (1 + s); }
  __device__ __forceinline__ void issue(const CUtensorMap& m0, const CUtensorMap& m1, int s,
                                        int row, int h, int b) const {
    mbar_expect(bar(s), 2 * Cfg<D>::TILE);
    tma_tile<D>(stage(s, 0), m0, bar(s), row, h, b);
    tma_tile<D>(stage(s, 1), m1, bar(s), row, h, b);
  }
  __device__ __forceinline__ void wait(int it) const {
    mbar_wait(bar(it % Cfg<D>::STAGES), (it / Cfg<D>::STAGES) & 1);
  }
};

template <int D>
__device__ __forceinline__ Ring<D> start_ring(uint8_t* smem, int n_tiles, const CUtensorMap& r0,
                                              const CUtensorMap& r1, int row, const CUtensorMap& m0,
                                              const CUtensorMap& m1, int first, int h, int b) {
  Ring<D> ring;
  ring.base = (smem_u32(smem) + 1023) & ~1023u;
  ring.bars = ring.base + (2 + 2 * Cfg<D>::STAGES) * Cfg<D>::TILE;
  if (threadIdx.x == 0) {
    mbar_init(ring.bars, 1);
    for (int s = 0; s < Cfg<D>::STAGES; ++s) mbar_init(ring.bar(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0 && n_tiles > 0) {
    mbar_expect(ring.bars, 2 * Cfg<D>::TILE);
    tma_tile<D>(ring.resident(0), r0, ring.bars, row, h, b);
    tma_tile<D>(ring.resident(1), r1, ring.bars, row, h, b);
    for (int s = 0; s < Cfg<D>::STAGES && s < n_tiles; ++s)
      ring.issue(m0, m1, s, first + s * ROWS, h, b);
  }
  if (n_tiles > 0) mbar_wait(ring.bars, 0);
  return ring;
}

// ---- dQ pass: one block per (b·h, 64-row query tile) ----------------------

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_wgmma(const __grid_constant__ TcParams p) {
  extern __shared__ uint8_t tc_smem[];
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  // heavier (later) causal tiles first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS;
  const int lane = threadIdx.x % 32;
  const int r0 = 16 * (threadIdx.x / 32) + lane / 4;  // rows r0 and r0 + 8 of each accumulator
  const int c0 = 2 * (lane % 4);                      // columns c0 + 8j (+1)
  const int offset = p.sk - p.sq;
  // keys [0, kv_end) can be visible to some row of this tile (`_kj_clamp` :155)
  int kv_end = p.sk;
  if (p.causal) kv_end = max(0, min(p.sk, min(q0 + ROWS, p.sq) + offset));
  const int n_tiles = (kv_end + ROWS - 1) / ROWS;

  const Ring<D> ring = start_ring<D>(tc_smem, n_tiles, p.q, p.o, q0, p.k, p.v, 0, h, b);
  const uint32_t q_t = ring.resident(0), o_t = ring.resident(1);

  float lse[2], delta[2];
  int segq[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + r0 + 8 * i;
    const bool in = qi < p.sq;
    lse[i] = in ? p.lse[static_cast<long long>(bh) * p.sq + qi] : 0.f;
    delta[i] = in ? p.delta[static_cast<long long>(bh) * p.sq + qi] : 0.f;
    segq[i] = (p.seg_q != nullptr && in) ? p.seg_q[b * p.sq + qi] : 0;
  }
  const bool plain = p.bias == nullptr && p.seg_q == nullptr;
  const float scale_log2 = p.scale * LOG2E;
  float dq[Cfg<D>::ACC];
#pragma unroll
  for (int j = 0; j < Cfg<D>::ACC; ++j) dq[j] = 0.f;

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
    // S = q·kᵀ and dP = dO·vᵀ, two commit groups
    float s[32], dp[32];
    pin(dq);
    wg_fence();
    scores<D>(s, q_t, k_t);
    wg_commit();
    scores<D>(dp, o_t, v_t);
    wg_commit();
    wg_wait<1>();
    pin(s);
    // P, with the masks of masked_score in its order. The branch stays
    // outside the loops: inside them it serialises the 32 exponentials.
    if (inside) {
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] = exp2_ftz(fmaf(s[j], scale_log2, -lse[(j / 2) % 2] * LOG2E));
    } else {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int i = (j / 2) % 2, c = 2 * (j / 4) + j % 2;
        const int qi = q0 + r0 + 8 * i, kj = k0 + c0 + 8 * (j / 4) + j % 2;
        const float x = s[j] * p.scale + bias[c];
        const bool masked = (p.seg_q != nullptr && segq[i] != segk[c]) ||
                            (p.causal && qi + offset < kj) || kj >= p.sk || qi >= p.sq;
        s[j] = masked || x <= 0.5f * NEG_INF ? 0.f : exp2_ftz((x - lse[i]) * LOG2E);
      }
    }
    wg_wait<0>();
    pin(dp);
    // dS rounded to k's dtype for dS·K (:371), as the A operand
    uint32_t ds[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = (i % 2);  // pairs 2i, 2i + 1 share row r0 + 8r
      ds[i] = pack_bf16(s[2 * i] * (dp[2 * i] - delta[r]) * p.scale,
                        s[2 * i + 1] * (dp[2 * i + 1] - delta[r]) * p.scale);
    }
    pin(ds);
    wg_fence();
    accumulate(dq, ds, k_t);  // dQ += dS·K, K read MN-major
    wg_commit();
    wg_wait<0>();
    pin(dq);
    __syncthreads();  // every warp is done with this stage
    if (threadIdx.x == 0 && it + Cfg<D>::STAGES < n_tiles)
      ring.issue(p.k, p.v, it % Cfg<D>::STAGES, k0 + Cfg<D>::STAGES * ROWS, h, b);
  }

  const long long rows = static_cast<long long>(bh) * p.sq;
#pragma unroll
  for (int c = 0; c < D / 8; ++c)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = q0 + r0 + 8 * i;
      if (qi < p.sq)
        *reinterpret_cast<uint32_t*>(p.out0 + (rows + qi) * D + 8 * c + c0) =
            pack_bf16(dq[4 * c + 2 * i], dq[4 * c + 2 * i + 1]);
    }
}

// ---- dK/dV pass: one block per (b·h, 64-row key tile) ---------------------

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_wgmma(const __grid_constant__ TcParams p) {
  extern __shared__ uint8_t tc_smem[];
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  // earlier key tiles see more causal queries: they come first
  const int k0 = blockIdx.y * ROWS;
  const int lane = threadIdx.x % 32;
  const int r0 = 16 * (threadIdx.x / 32) + lane / 4;  // key rows r0 and r0 + 8 of Sᵀ, dK, dV
  const int c0 = 2 * (lane % 4);                      // query columns c0 + 8j (+1) of Sᵀ
  const int offset = p.sk - p.sq;
  // the first query tile that can see key k0 (`_qi_clamp` :173)
  const int q_begin = p.causal ? (max(0, k0 - offset) / ROWS) * ROWS : 0;
  const int n_tiles = max(0, (p.sq - q_begin + ROWS - 1) / ROWS);

  const Ring<D> ring = start_ring<D>(tc_smem, n_tiles, p.k, p.v, k0, p.q, p.o, q_begin, h, b);
  const uint32_t k_t = ring.resident(0), v_t = ring.resident(1);

  float bias[2];
  int segk[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kj = k0 + r0 + 8 * i;
    const bool in = kj < p.sk;
    bias[i] = (p.bias != nullptr && in) ? p.bias[b * p.sk + kj] : 0.f;
    segk[i] = (p.seg_k != nullptr && in) ? p.seg_k[b * p.sk + kj] : 0;
  }
  const bool plain = p.bias == nullptr && p.seg_q == nullptr;
  const float scale_log2 = p.scale * LOG2E;
  // lse and δ of a query tile, [2 buffers][lse, δ][64]: thread t fetches
  // row t % 64 of lse (t < 64) or of δ for the next tile while this one is
  // multiplied, and each thread reads its 16 columns from shared memory
  float* side = reinterpret_cast<float*>(tc_smem + (ring.bars - smem_u32(tc_smem)) + 64);
  const float* rows_g = p.lse + static_cast<long long>(bh) * p.sq;
  if (threadIdx.x >= ROWS) rows_g = p.delta + static_cast<long long>(bh) * p.sq;
  const int my_row = threadIdx.x % ROWS;
  auto fetch = [&](int it) {
    const int qi = q_begin + it * ROWS + my_row;
    return qi < p.sq ? rows_g[qi] : 0.f;  // 0 past sq, masked there
  };
  if (n_tiles > 0) side[threadIdx.x] = fetch(0);
  __syncthreads();
  float dk[Cfg<D>::ACC], dv[Cfg<D>::ACC];
#pragma unroll
  for (int j = 0; j < Cfg<D>::ACC; ++j) dk[j] = dv[j] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = q_begin + it * ROWS;
    const uint32_t q_t = ring.stage(it % Cfg<D>::STAGES, 0);
    const uint32_t o_t = ring.stage(it % Cfg<D>::STAGES, 1);
    const bool inside = plain && k0 + ROWS <= p.sk && q0 + ROWS <= p.sq &&
                        (!p.causal || q0 + offset >= k0 + ROWS - 1);
    const float next = it + 1 < n_tiles ? fetch(it + 1) : 0.f;
    // lse and δ of this thread's 16 query columns
    const float2* lse_s = reinterpret_cast<const float2*>(side + (it % 2) * 2 * ROWS);
    const float2* delta_s = lse_s + ROWS / 2;
    float lse[16], delta[16];
    int segq[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l = lse_s[c0 / 2 + 4 * j], d = delta_s[c0 / 2 + 4 * j];
      lse[2 * j] = l.x;
      lse[2 * j + 1] = l.y;
      delta[2 * j] = d.x;
      delta[2 * j + 1] = d.y;
    }
    if (!inside && p.seg_q != nullptr) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int qi = q0 + c0 + 8 * (j / 2) + j % 2;
        segq[j] = qi < p.sq ? p.seg_q[b * p.sq + qi] : 0;
      }
    }
    ring.wait(it);
    // Sᵀ = k·qᵀ and dPᵀ = v·dOᵀ, two commit groups
    float st[32], dpt[32];
    pin(dk);
    pin(dv);
    wg_fence();
    scores<D>(st, k_t, q_t);
    wg_commit();
    scores<D>(dpt, v_t, o_t);
    wg_commit();
    wg_wait<1>();
    pin(st);
    // Pᵀ, with the masks of masked_score in its order; query rows past sq
    // are masked too, since this pass sums over them. The branch stays
    // outside the loops: inside them it serialises the 32 exponentials.
    if (inside) {
#pragma unroll
      for (int j = 0; j < 32; ++j)
        st[j] = exp2_ftz(fmaf(st[j], scale_log2, -lse[2 * (j / 4) + j % 2] * LOG2E));
    } else {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int i = (j / 2) % 2, c = 2 * (j / 4) + j % 2;
        const int kj = k0 + r0 + 8 * i, qi = q0 + c0 + 8 * (j / 4) + j % 2;
        const float x = st[j] * p.scale + bias[i];
        const bool masked = (p.seg_q != nullptr && segq[c] != segk[i]) ||
                            (p.causal && qi + offset < kj) || kj >= p.sk || qi >= p.sq;
        st[j] = masked || x <= 0.5f * NEG_INF ? 0.f : exp2_ftz((x - lse[c]) * LOG2E);
      }
    }
    // Pᵀ rounded to dO's dtype for Pᵀ·dO (:407), as the A operand
    uint32_t pt[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) pt[i] = pack_bf16(st[2 * i], st[2 * i + 1]);
    pin(pt);
    wg_fence();
    accumulate(dv, pt, o_t);  // dV += Pᵀ·dO, dO read MN-major
    wg_commit();
    wg_wait<1>();  // dPᵀ is done; dV may still run
    pin(dpt);
    // dSᵀ from the unrounded P, rounded to q's dtype for dSᵀ·Q (:415)
    uint32_t dst[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int c = 2 * (i / 2);  // pairs 2i, 2i + 1 are query columns c, c + 1
      dst[i] = pack_bf16(st[2 * i] * (dpt[2 * i] - delta[c]) * p.scale,
                         st[2 * i + 1] * (dpt[2 * i + 1] - delta[c + 1]) * p.scale);
    }
    pin(dst);
    wg_fence();
    accumulate(dk, dst, q_t);  // dK += dSᵀ·Q, Q read MN-major
    wg_commit();
    wg_wait<0>();
    pin(dk);
    pin(dv);
    if (it + 1 < n_tiles) side[((it + 1) % 2) * 2 * ROWS + threadIdx.x] = next;
    __syncthreads();  // every warp is done with this stage (and the side buffer is written)
    if (threadIdx.x == 0 && it + Cfg<D>::STAGES < n_tiles)
      ring.issue(p.q, p.o, it % Cfg<D>::STAGES, q0 + Cfg<D>::STAGES * ROWS, h, b);
  }

  const long long rows = static_cast<long long>(bh) * p.sk;
#pragma unroll
  for (int c = 0; c < D / 8; ++c)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kj = k0 + r0 + 8 * i;
      if (kj < p.sk) {
        const long long at = (rows + kj) * D + 8 * c + c0;
        *reinterpret_cast<uint32_t*>(p.out0 + at) = pack_bf16(dk[4 * c + 2 * i], dk[4 * c + 2 * i + 1]);
        *reinterpret_cast<uint32_t*>(p.out1 + at) = pack_bf16(dv[4 * c + 2 * i], dv[4 * c + 2 * i + 1]);
      }
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
cudaError_t launch(const Params& p, bool dq_pass, cudaStream_t stream) {
  const int rows = dq_pass ? p.sq : p.sk;
  if ((dq_pass ? p.sk : p.sq) == 0) {  // nothing to sum over: the grads are 0
    const size_t bytes = static_cast<size_t>(p.B) * p.H * rows * D * sizeof(__nv_bfloat16);
    cudaError_t err = cudaMemsetAsync(dq_pass ? p.dq : p.dk, 0, bytes, stream);
    if (err == cudaSuccess && !dq_pass) err = cudaMemsetAsync(p.dv, 0, bytes, stream);
    return err;
  }
  TcParams t;
  if (!encode(&t.q, p.q, D, p.sq, p.H, p.B, p.q_ss, p.q_sh, p.q_sb) ||
      !encode(&t.k, p.k, D, p.sk, p.H, p.B, p.k_ss, p.k_sh, p.k_sb) ||
      !encode(&t.v, p.v, D, p.sk, p.H, p.B, p.v_ss, p.v_sh, p.v_sb) ||
      !encode(&t.o, p.dout, D, p.sq, p.H, p.B, p.o_ss, p.o_sh, p.o_sb))
    return cudaErrorInvalidValue;
  t.bias = p.bias;
  t.seg_q = p.seg_q;
  t.seg_k = p.seg_k;
  t.lse = p.lse;
  t.delta = p.delta;
  t.out0 = static_cast<__nv_bfloat16*>(dq_pass ? p.dq : p.dk);
  t.out1 = static_cast<__nv_bfloat16*>(p.dv);
  t.H = p.H;
  t.sq = p.sq;
  t.sk = p.sk;
  t.scale = p.scale;
  t.causal = p.causal;
  void (*kernel)(const TcParams) = dq_pass ? &flash_bwd_dq_wgmma<D> : &flash_bwd_dkv_wgmma<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(Cfg<D>::SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, (rows + ROWS - 1) / ROWS);
  kernel<<<grid, THREADS, Cfg<D>::SMEM, stream>>>(t);
  return cudaGetLastError();
}

}  // namespace tc

int run(int route, int head_dim, bool dq_pass, const void* q, const void* k,
        const void* v, const void* bias, const void* seg_q, const void* seg_k,
        const void* dout, const void* lse, const void* delta, void* dq, void* dk,
        void* dv, int B, int H, int sq, int sk,
        long long q_sb, long long q_sh, long long q_ss,
        long long k_sb, long long k_sh, long long k_ss,
        long long v_sb, long long v_sh, long long v_ss,
        long long o_sb, long long o_sh, long long o_ss,
        float scale, int causal, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = static_cast<const float*>(bias);
  p.seg_q = static_cast<const int*>(seg_q);
  p.seg_k = static_cast<const int*>(seg_k);
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.B = B;
  p.H = H;
  p.sq = sq;
  p.sk = sk;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.scale = scale;
  p.causal = causal;
  if (B * H == 0 || (dq_pass ? sq : sk) == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (route) {
    case 0:  // f32 on the CUDA cores
      switch (head_dim) {
        case 32: return launch<float, 32>(p, dq_pass, s);
        case 64: return launch<float, 64>(p, dq_pass, s);
        case 128: return launch<float, 128>(p, dq_pass, s);
      }
      break;
    case 1:  // bf16 on the CUDA cores
      if (head_dim == 32) return launch<__nv_bfloat16, 32>(p, dq_pass, s);
      break;
    case 2:  // bf16 on the tensor cores
      if (head_dim == 64) return tc::launch<64>(p, dq_pass, s);
      if (head_dim == 128) return tc::launch<128>(p, dq_pass, s);
      break;
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// route: the kernels to launch, as the wrapper chose them: 0 = float32 on
// the CUDA cores, 1 = bfloat16 on the CUDA cores, 2 = bfloat16 on the
// tensor cores (q, k, v, dO and the outputs in that dtype alike). Each
// returns cudaGetLastError() after its launch (0 on success), or
// cudaErrorInvalidValue for a route and head dim the kernels were not
// built for. Launches on `stream`; does not synchronise.
extern "C" int flash_bwd_dq(int route, int head_dim,
                            const void* q, const void* k, const void* v,
                            const void* bias, const void* seg_q, const void* seg_k,
                            const void* dout, const void* lse, const void* delta,
                            void* dq,
                            int B, int H, int sq, int sk,
                            long long q_sb, long long q_sh, long long q_ss,
                            long long k_sb, long long k_sh, long long k_ss,
                            long long v_sb, long long v_sh, long long v_ss,
                            long long o_sb, long long o_sh, long long o_ss,
                            float scale, int causal, void* stream) {
  return run(route, head_dim, true, q, k, v, bias, seg_q, seg_k, dout, lse, delta,
             dq, nullptr, nullptr, B, H, sq, sk, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
             v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, scale, causal, stream);
}

extern "C" int flash_bwd_dkv(int route, int head_dim,
                             const void* q, const void* k, const void* v,
                             const void* bias, const void* seg_q, const void* seg_k,
                             const void* dout, const void* lse, const void* delta,
                             void* dk, void* dv,
                             int B, int H, int sq, int sk,
                             long long q_sb, long long q_sh, long long q_ss,
                             long long k_sb, long long k_sh, long long k_ss,
                             long long v_sb, long long v_sh, long long v_ss,
                             long long o_sb, long long o_sh, long long o_ss,
                             float scale, int causal, void* stream) {
  return run(route, head_dim, false, q, k, v, bias, seg_q, seg_k, dout, lse, delta,
             nullptr, dk, dv, B, H, sq, sk, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
             v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, scale, causal, stream);
}
