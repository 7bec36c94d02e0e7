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
// What this design does about it. Like flash_fwd.cu, it is the simple,
// exact first version. One thread block of 256 threads owns one
// (batch·head, 64-row tile) and loops over the other side's 64-row tiles,
// which replaces the TPU kernels' sequential grid axis and their VMEM
// scratch: the f32 accumulators (dQ; or dK and dV) stay in registers for
// the whole loop and are written once, so no block writes what another
// block writes, the result is the same from run to run, and no atomics
// or second reduction are needed.
//   - dQ pass: block (bh, query tile) loads q and dO once, then per key
//     tile forms S and dP (two 64×64×D products), dS, and adds dS·K. Key
//     tiles wholly above the causal diagonal are never visited (the TPU
//     kernel's `_kj_clamp` :155 skips their DMA).
//   - dK/dV pass: block (bh, key tile) loads k and v once, then per query
//     tile forms Sᵀ and dPᵀ, Pᵀ and dSᵀ, and adds Pᵀ·dO and dSᵀ·Q. It
//     starts at the first query tile that can see its keys,
//     ⌊max(0, k0 − (sk − sq))/64⌋ (`_qi_clamp` :173).
// Nothing is padded: rows past sq and keys past sk are masked in the
// kernel, never read into a sum and never written. q, k, v and dO are read
// through their strides (the head views of the fused qkv projection need
// no copy). Tiles are widened to f32 in shared memory and every product
// runs as f32 FMAs on the CUDA cores, which caps both passes far below the
// tensor-core peak; tensor-core products (mma/wgmma), TMA loads and a
// pipelined schedule are the next step. Shared memory, dynamic: 83 KB
// (dQ) and 101 KB (dK/dV) at head dim 64, 149 KB and 166 KB at 128.
//
// Build (plain C interface, loaded with ctypes by ops/_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libflash_bwd.so flash_bwd.cu

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

template <typename T>
cudaError_t launch_dtype(const Params& p, int head_dim, bool dq_pass,
                         cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch<T, 32>(p, dq_pass, stream);
    case 64: return launch<T, 64>(p, dq_pass, stream);
    case 128: return launch<T, 128>(p, dq_pass, stream);
    default: return cudaErrorInvalidValue;
  }
}

int run(int dtype, int head_dim, bool dq_pass, const void* q, const void* k,
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
  switch (dtype) {
    case 0: return launch_dtype<float>(p, head_dim, dq_pass, s);
    case 1: return launch_dtype<__nv_bfloat16>(p, head_dim, dq_pass, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO and the outputs alike).
// Each returns cudaGetLastError() after its launch (0 on success), or
// cudaErrorInvalidValue for a dtype or head dim the kernels were not built
// for. Launches on `stream`; does not synchronise.
extern "C" int flash_bwd_dq(int dtype, int head_dim,
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
  return run(dtype, head_dim, true, q, k, v, bias, seg_q, seg_k, dout, lse, delta,
             dq, nullptr, nullptr, B, H, sq, sk, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
             v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, scale, causal, stream);
}

extern "C" int flash_bwd_dkv(int dtype, int head_dim,
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
  return run(dtype, head_dim, false, q, k, v, bias, seg_q, seg_k, dout, lse, delta,
             nullptr, dk, dv, B, H, sq, sk, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
             v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, scale, causal, stream);
}
