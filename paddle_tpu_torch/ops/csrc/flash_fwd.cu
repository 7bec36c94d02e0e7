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
// dtype before the P·V product, as the TPU kernel does (:224-226).
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense):
//   - at the GPT decode slice's prefill, [8, 12, 128, 64] bf16 causal, it
//     must move q, k, v and o: 4 × 1.57 MB ≈ 6.3 MB, about 1.9 µs, against
//     about 0.2 GFLOP (0.2 µs), so it is bound by memory;
//   - at [1, 12, 4096, 64] bf16 causal it must do about 25.8 GFLOP, about
//     26 µs, against 25 MB of traffic (7.5 µs), so it is bound by compute.
//
// What this design does about it. One thread block of 256 threads owns
// one (batch·head, 64-row query tile) and loops over 64-key tiles, which
// replaces the TPU kernel's sequential grid axis and its VMEM scratch:
// running max, running sum and the f32 accumulator stay in registers for
// the whole loop, so q is read once and o written once. Causal key tiles
// wholly above the diagonal are never visited, so neither their loads
// nor their math happen. Ragged edges (sq or sk not a multiple of 64)
// are masked in the kernel itself, so no padded copies are made, and q,
// k, v are read through their strides, so the head split of the caller
// needs no copy. Tiles are widened to f32 in shared memory and the two
// products run as f32 FMAs on the CUDA cores. That keeps the first
// version simple and exact to f32 rounding, and it caps the kernel far
// below the tensor-core peak at long sequences. The f32 tiles take 67 KB
// of dynamic shared memory at head dim 64, and 80 registers a thread
// (128 at head dim 128) allow three blocks per SM, so at the prefill
// shape (192 blocks) the kernel is bound by latency, not by either
// roof. Tensor-core products (mma/wgmma), TMA loads and a pipelined,
// warp-specialised schedule are the next step.
//
// Build (plain C interface, loaded with ctypes by ops/_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libflash_fwd.so flash_fwd.cu

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

template <typename T>
cudaError_t launch_dtype(const Params& p, int head_dim, cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue for a dtype or head dim
// the kernel was not built for. Launches on `stream`; does not synchronise.
extern "C" int flash_fwd(int dtype, int head_dim,
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
  switch (dtype) {
    case 0: return launch_dtype<float>(p, head_dim, s);
    case 1: return launch_dtype<__nv_bfloat16>(p, head_dim, s);
    default: return cudaErrorInvalidValue;
  }
}
