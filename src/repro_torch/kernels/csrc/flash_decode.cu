// Flash-decode attention for Hopper (sm_90a): one query token per request
// against a long KV cache, dense per-slot stripes or a paged block pool.
//
// Replaces the Pallas TPU kernels of the JAX package:
//   * decode_kernel<T, false, PARTIAL>  <- src/repro/kernels/flash_decode.py
//     ::flash_decode (_decode_kernel over _decode_body), both output modes;
//   * decode_kernel<T, true, false>     <- src/repro/kernels/flash_decode.py
//     ::flash_decode_paged (_decode_kernel_paged over _decode_body).
//
// Bound on this card: device-memory bytes.  Each request reads only its
// visible K/V, (length + 1) * Hkv * D * 2 * sizeof(T) bytes, plus q and the
// output; the arithmetic is 4 * Hq * D flops per visible position, far below
// the ridge point.  So the design reads every visible K/V element exactly
// once per KV head (one block per (b, hkv) covers all G = Hq / Hkv query
// heads of that KV head, as the TPU grid cell does), and never touches a
// tile past the request's length (the TPU index map's past-the-end clamp
// becomes the loop bound).
//
// Semantics (identical to the TPU kernel):
//   * lengths are inclusive: position t is visible iff t <= length;
//   * a negative length visits nothing: the normalized output is 0 and the
//     partial is the merge identity (o = 0, m = -1e30, l = 0);
//   * online softmax in f32 with m initialised to -1e30 (not -inf), scale
//     applied to the f32 dot product;
//   * p is rounded to V's dtype before the PV product while l sums the
//     unrounded p, as the Pallas body does (p.astype(v.dtype));
//   * paged: logical tile kb lives at pool rows tables[b, kb] * block_size;
//     table slots past the request's length are never read.
//
// Simple first: the sequential Pallas grid axis over KV blocks becomes an
// in-block loop.  Each tile is staged in shared memory with 16-byte loads,
// all of a thread's loads for the tile in flight together; inside the tile
// a thread computes whole (head, position) dot products and whole
// (head, column) PV sums.  The next tile is not prefetched
// (no cp.async / TMA double buffering) and there is no split over the KV
// axis, so a small batch launches only B * Hkv blocks and each block pays
// one memory latency per tile.  A split-KV redesign is the way to the
// bound.
//
// Plain C interface for ctypes; each entry returns cudaGetLastError() right
// after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int STATIC_SMEM_LIMIT = 48 * 1024;
constexpr int UNROLL = 4;   // 16-byte loads in flight per thread per tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Params {
  const void* q;          // (B, Hkv, G, D) contiguous
  const void* k;          // dense: (B, Hkv, S, D) rows contiguous; paged: (Hkv, pool_tokens, D)
  const void* v;
  const int* lengths;     // (B,)
  const int* tables;      // paged: (B, nk)
  void* out;              // (B, Hkv, G, D): T, or f32 in partial mode
  float* out_m;           // partial: (B, Hkv, G)
  float* out_l;
  int Hkv, G, D;
  int S;                  // dense: cache positions per (b, h)
  int tile;               // positions per KV tile (paged: block_size)
  int nk;                 // tiles per request (paged: table width)
  long long stride_kb, stride_kh, stride_vb, stride_vh;   // dense, elements
  long long pool_tokens;  // paged: num_blocks * block_size
  float scale;
};

// shared-memory floats for one block; rows padded to D + 1 so that threads
// reading the same column of different rows hit different banks
__host__ __device__ inline long long smem_floats(int G, int D, int tile) {
  const long long DP = D + 1;
  return G * DP + 2LL * tile * DP + (long long)G * tile + (long long)G * D +
         3LL * G;
}

// Stage rows [0, n) of a K tile and a V tile (n * D contiguous elements
// each, 16-byte aligned, D a multiple of 16 / sizeof(T)) into shared memory
// as f32.  Each thread issues up to UNROLL 16-byte loads of K and of V
// before it converts and stores any, so a tile costs about one memory
// latency instead of one per element.
template <typename T>
__device__ __forceinline__ void stage_tile(const T* __restrict__ kt,
                                           const T* __restrict__ vt,
                                           float* k_s, float* v_s, int n,
                                           int D, int DP, int tid) {
  constexpr int VEC = 16 / sizeof(T);
  const int nvec = n * D / VEC;
  const uint4* k4 = reinterpret_cast<const uint4*>(kt);
  const uint4* v4 = reinterpret_cast<const uint4*>(vt);
  for (int base = 0; base < nvec; base += THREADS * UNROLL) {
    uint4 kr[UNROLL], vr[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int c = base + u * THREADS + tid;
      if (c < nvec) {
        kr[u] = __ldg(k4 + c);
        vr[u] = __ldg(v4 + c);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int c = base + u * THREADS + tid;
      if (c < nvec) {
        const int e = c * VEC, r = e / D, col = e - r * D;
        const T* ke = reinterpret_cast<const T*>(&kr[u]);
        const T* ve = reinterpret_cast<const T*>(&vr[u]);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          k_s[r * DP + col + j] = to_f(ke[j]);
          v_s[r * DP + col + j] = to_f(ve[j]);
        }
      }
    }
  }
}

template <typename T, bool PAGED, bool PARTIAL>
__global__ void __launch_bounds__(THREADS) decode_kernel(Params p) {
  extern __shared__ float smem[];
  const int G = p.G, D = p.D, TILE = p.tile, DP = D + 1;
  float* q_s = smem;               // G x DP
  float* k_s = q_s + G * DP;       // TILE x DP
  float* v_s = k_s + TILE * DP;    // TILE x DP
  float* p_s = v_s + TILE * DP;    // G x TILE: scores, then probabilities
  float* acc = p_s + G * TILE;     // G x D
  float* m_s = acc + G * D;        // G
  float* l_s = m_s + G;            // G
  float* a_s = l_s + G;            // G: this tile's rescale factor

  const int b = blockIdx.x / p.Hkv;
  const int h = blockIdx.x - b * p.Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = p.lengths[b];
  const long long row0 = ((long long)b * p.Hkv + h) * G;   // first (b, h, g) row

  const T* qg = static_cast<const T*>(p.q) + row0 * D;
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D;
    q_s[g * DP + (i - g * D)] = to_f(qg[i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = NEG;
    l_s[g] = 0.f;
  }
  // the past-the-end clamp: tiles after the one holding `len` are never read
  const int last = len < 0 ? -1 : min(len / TILE, p.nk - 1);
  __syncthreads();

  for (int kb = 0; kb <= last; ++kb) {
    const T* kt;
    const T* vt;
    int n;  // visible positions in this tile
    if (PAGED) {
      const long long blk = p.tables[(long long)b * p.nk + kb];
      const long long r = (long long)h * p.pool_tokens + blk * TILE;
      kt = static_cast<const T*>(p.k) + r * D;
      vt = static_cast<const T*>(p.v) + r * D;
      n = min(TILE, len + 1 - kb * TILE);
    } else {
      const long long r = (long long)kb * TILE * D;
      kt = static_cast<const T*>(p.k) + b * p.stride_kb + h * p.stride_kh + r;
      vt = static_cast<const T*>(p.v) + b * p.stride_vb + h * p.stride_vh + r;
      n = min(min(TILE, len + 1 - kb * TILE), p.S - kb * TILE);
    }
    stage_tile(kt, vt, k_s, v_s, n, D, DP, tid);
    __syncthreads();

    // scores: one (g, t) dot product per thread
    for (int i = tid; i < G * n; i += THREADS) {
      const int g = i / n, t = i - g * n;
      const float* qr = q_s + g * DP;
      const float* kr = k_s + t * DP;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      p_s[g * TILE + t] = s * p.scale;
    }
    __syncthreads();

    // online softmax: one warp per query head
    for (int g = warp; g < G; g += WARPS) {
      float* pr = p_s + g * TILE;
      float mx = NEG;
      for (int t = lane; t < n; t += 32) mx = fmaxf(mx, pr[t]);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[g];
      const float l_prev = l_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < n; t += 32) {
        const float e = expf(pr[t] - m_new);
        sum += e;
        pr[t] = to_f(from_f<T>(e));   // PV takes p in V's dtype
      }
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        m_s[g] = m_new;
        l_s[g] = l_prev * alpha + sum;
      }
    }
    __syncthreads();

    // rescale the accumulator and add this tile's P V
    for (int i = tid; i < G * D; i += THREADS) {
      const int g = i / D, d = i - g * D;
      const float* pr = p_s + g * TILE;
      float a = acc[i] * a_s[g];
      for (int t = 0; t < n; ++t) a = fmaf(pr[t], v_s[t * DP + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  if (PARTIAL) {
    float* o = static_cast<float*>(p.out) + row0 * D;
    for (int i = tid; i < G * D; i += THREADS) o[i] = acc[i];
    for (int g = tid; g < G; g += THREADS) {
      p.out_m[row0 + g] = m_s[g];
      p.out_l[row0 + g] = l_s[g];
    }
  } else {
    T* o = static_cast<T*>(p.out) + row0 * D;
    for (int i = tid; i < G * D; i += THREADS) {
      const float l = l_s[i / D];
      o[i] = from_f<T>(l > 0.f ? acc[i] / fmaxf(l, 1e-30f) : 0.f);
    }
  }
}

template <typename T, bool PAGED, bool PARTIAL>
int launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(p.G, p.D, p.tile);
  auto kernel = decode_kernel<T, PAGED, PARTIAL>;
  if (smem > STATIC_SMEM_LIMIT) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (B * p.Hkv > 0) kernel<<<B * p.Hkv, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16
int flash_decode_dense(const void* q, const void* k, const void* v,
                       const int* lengths, void* out, float* out_m,
                       float* out_l, int B, int Hkv, int G, int S, int D,
                       int tile, long long stride_kb, long long stride_kh,
                       long long stride_vb, long long stride_vh, float scale,
                       int dtype, int partial, void* stream) {
  Params p{};
  p.q = q; p.k = k; p.v = v; p.lengths = lengths; p.tables = nullptr;
  p.out = out; p.out_m = out_m; p.out_l = out_l;
  p.Hkv = Hkv; p.G = G; p.D = D; p.S = S; p.tile = tile;
  p.nk = (S + tile - 1) / tile;
  p.stride_kb = stride_kb; p.stride_kh = stride_kh;
  p.stride_vb = stride_vb; p.stride_vh = stride_vh;
  p.pool_tokens = 0; p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return partial ? launch<float, false, true>(p, B, s)
                   : launch<float, false, false>(p, B, s);
  if (dtype == 1)
    return partial ? launch<__nv_bfloat16, false, true>(p, B, s)
                   : launch<__nv_bfloat16, false, false>(p, B, s);
  return (int)cudaErrorInvalidValue;
}

int flash_decode_paged(const void* q, const void* k_pool, const void* v_pool,
                       const int* lengths, const int* tables, void* out,
                       int B, int Hkv, int G, long long pool_tokens,
                       int block_size, int nk, int D, float scale, int dtype,
                       void* stream) {
  Params p{};
  p.q = q; p.k = k_pool; p.v = v_pool; p.lengths = lengths; p.tables = tables;
  p.out = out; p.out_m = nullptr; p.out_l = nullptr;
  p.Hkv = Hkv; p.G = G; p.D = D; p.S = 0; p.tile = block_size; p.nk = nk;
  p.stride_kb = p.stride_kh = p.stride_vb = p.stride_vh = 0;
  p.pool_tokens = pool_tokens; p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, true, false>(p, B, s);
  if (dtype == 1) return launch<__nv_bfloat16, true, false>(p, B, s);
  return (int)cudaErrorInvalidValue;
}

long long flash_decode_smem_bytes(int G, int D, int tile) {
  return (long long)sizeof(float) * smem_floats(G, D, tile);
}

const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
