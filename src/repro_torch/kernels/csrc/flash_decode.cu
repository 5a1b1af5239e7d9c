// Flash-decode attention for Hopper (sm_90a): one query token per request
// against a long KV cache, dense per-slot stripes or a paged block pool.
//
// Replaces the Pallas TPU kernels of the JAX package:
//   * decode_split_kernel<T, true> + decode_combine_kernel<T, PARTIAL>
//                                <- src/repro/kernels/flash_decode.py
//     ::flash_decode (_decode_kernel over _decode_body), both output modes;
//   * decode_split_kernel<T, false> + decode_combine_kernel<T, false>
//                                <- src/repro/kernels/flash_decode.py
//     ::flash_decode_paged (_decode_kernel_paged over _decode_body).
//
// Bound on this card: device-memory bytes.  Each request reads only its
// visible K/V, (length + 1) * Hkv * D * 2 * sizeof(T) bytes, plus q and the
// output; the arithmetic is 4 * Hq * D flops per visible position (about
// 12 flops per byte at G = 12), far below the ridge point.  A block covers
// all G = Hq / Hkv query heads of one KV head, as the TPU grid cell does,
// so every visible K/V element is read once, and no tile past the
// request's length is touched (the TPU index map's past-the-end clamp
// becomes the loop bound).  What a byte-bound kernel lacks at a serving
// batch is blocks and loads in flight, so both layouts run one design,
// split-KV flash decoding, and differ only in how a tile is found:
//
//   * decode_split_kernel runs one block per (b, hkv, split), each over
//     `pages_per_split` consecutive tiles of `tile` positions, so a batch
//     of 6 fills the card with ~400 blocks (the wrapper picks the split
//     from B, Hkv, the cache or table width and the SM count, never from
//     `lengths`: no host sync).  Dense: tile kb of (b, h) starts at
//     k + b * stride_kb + h * stride_kh + kb * tile * D, its rows
//     contiguous, the last tile ragged when tile does not divide S.
//     Paged: logical page kb is pool block tables[b, kb], whose entry is
//     loaded one page ahead so that no iteration waits on it.  Tiles
//     stream through a 3-stage cp.async ring in T (no f32 staging): the
//     copies of the next two tiles are in flight while one is computed.
//     Inside a tile, a group of lanes owns one head (the lanes cover the
//     positions, so a head's max and sum are shuffles, and any G tiles
//     over the warps); in P V a thread owns a column pair of every HG-th
//     head and carries up to 8 heads through the tile in registers, so
//     each V element read from shared memory feeds 8 independent FMA
//     chains.  Two barriers per tile separate the scores from the P V
//     sums.  Each split writes an f32 partial (o, m, l) to a workspace.
//   * decode_combine_kernel merges the live splits of each (b, hkv, head)
//     with the online-LSE rule of core/merge.py (one block per head: the
//     split weights in shared memory, then one column per thread): m is
//     the largest m_s, o and l the sums of o_s and l_s weighted by
//     exp(m_s - m).  It writes the normalized output o / l in T, or, in
//     partial mode, the merged f32 (o, m, l).
//
// Semantics (identical to the TPU kernel):
//   * lengths are inclusive: position t is visible iff t <= length;
//   * a negative length visits nothing: the normalized output is 0 and the
//     partial is exactly the merge identity (o = 0, m = -1e30, l = 0);
//   * online softmax in f32 with m initialised to -1e30 (not -inf), scale
//     applied to the f32 dot product;
//   * p is rounded to V's dtype before the PV product while l sums the
//     unrounded p, as the Pallas body does (p.astype(v.dtype));
//   * paged: table slots past the request's length are never read.  A
//     split that starts past the length exits at once and writes nothing,
//     and the combine kernel reads only splits s with s * pages_per_split
//     <= the last live tile, so it never reads an unwritten partial.
//
// Plain C interface for ctypes; each entry returns cudaGetLastError() right
// after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int STATIC_SMEM_LIMIT = 48 * 1024;
constexpr int STAGES = 3;   // tiles in the split kernel's cp.async ring
constexpr int SPLIT_THREADS = 256;
constexpr int PV_HEADS = 8;  // heads a thread carries through a tile's P V
constexpr int COMBINE_THREADS = 128;

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

struct SplitParams {
  const void* q;          // (B, Hkv, G, D) contiguous
  const void* k;          // dense: (B, Hkv, S, D) rows contiguous;
  const void* v;          // paged: (Hkv, pool_tokens, D)
  const int* lengths;     // (B,)
  const int* tables;      // paged: (B, nk)
  void* out;              // (B, Hkv, G, D): T, or f32 in partial mode
  float* out_m;           // partial: (B, Hkv, G)
  float* out_l;
  float* part_o;          // (B, Hkv, n_split, G, D)
  float* part_m;          // (B, Hkv, n_split, G)
  float* part_l;
  int Hkv, G, D;
  int tile;               // positions per tile (paged: block_size)
  int nk;                 // tiles per request (paged: table width)
  int S;                  // dense: cache positions per (b, h)
  int pps, n_split;       // tiles per split, splits per (b, hkv)
  int lanes;              // lanes per head: pow2 >= min(tile, 32)
  long long stride_kb, stride_kh, stride_vb, stride_vh;   // dense, elements
  long long pool_tokens;  // paged: num_blocks * block_size
  float scale;
};

// the last tile holding a visible position of a request of length `len`
// (-1: none)
__device__ __forceinline__ int last_tile(const SplitParams& p, int len) {
  return len < 0 ? -1 : min(len / p.tile, p.nk - 1);
}

// K/V ring rows are padded by 16 bytes: a group of 8 lanes reading one
// 16-byte column of 8 consecutive rows hits 8 distinct 4-bank groups
template <typename T>
__host__ __device__ inline int ring_pitch(int D) {
  return D + 16 / (int)sizeof(T);
}

// bytes of shared memory of one split block: the K/V ring in T, then f32
// q (G x D), accumulator (G x D), probabilities (G x tile), m, l and the
// tile's rescale factor (G each)
template <typename T>
__host__ __device__ inline long long split_smem_bytes(int G, int D, int tile) {
  return (long long)sizeof(T) * STAGES * 2 * tile * ring_pitch<T>(D) +
         4LL * (2LL * G * D + (long long)G * tile + 3LL * G);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// f32 dot product of a q row (f32, 16-byte aligned) with a K row in T; four
// partial sums keep four FMA chains in flight
template <typename T>
__device__ __forceinline__ float dot_row(const float* q, const T* k, int D) {
  constexpr int VEC = 16 / sizeof(T);
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int d = 0; d < D; d += VEC) {
    const uint4 raw = *reinterpret_cast<const uint4*>(k + d);
    const T* kv = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; j += 4) {
      const float4 x = *reinterpret_cast<const float4*>(q + d + j);
      s[0] = fmaf(x.x, to_f(kv[j]), s[0]);
      s[1] = fmaf(x.y, to_f(kv[j + 1]), s[1]);
      s[2] = fmaf(x.z, to_f(kv[j + 2]), s[2]);
      s[3] = fmaf(x.w, to_f(kv[j + 3]), s[3]);
    }
  }
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// two adjacent elements of a row in T, as f32
__device__ __forceinline__ float2 ld2(const float* x) {
  return *reinterpret_cast<const float2*>(x);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x));
}

// Block = (b, hkv, split): the online softmax over tiles
// [split * pps, min((split + 1) * pps, last + 1)) for all G heads, written
// as an f32 partial.  DENSE: tiles of the (b, h) stripe; else logical
// pages of the pool through the block table.
template <typename T, bool DENSE>
__global__ void __launch_bounds__(SPLIT_THREADS)
    decode_split_kernel(SplitParams p) {
  constexpr int SW = SPLIT_THREADS / 32;   // warps
  extern __shared__ float4 smem4[];
  const int G = p.G, D = p.D, BS = p.tile, DP = ring_pitch<T>(D);
  T* ring = reinterpret_cast<T*>(smem4);                 // STAGES x {K, V}
  float* q_s = reinterpret_cast<float*>(ring + STAGES * 2 * BS * DP);
  float* acc = q_s + G * D;        // G x D
  float* p_s = acc + G * D;        // G x BS: probabilities in V's dtype
  float* m_s = p_s + G * BS;       // G
  float* l_s = m_s + G;            // G
  float* a_s = l_s + G;            // G: this tile's rescale factor

  const int split = blockIdx.x % p.n_split;
  const int bh = blockIdx.x / p.n_split;
  const int b = bh / p.Hkv, h = bh - b * p.Hkv;
  const int len = p.lengths[b];
  // the past-the-end clamp: tiles after the one holding `len` are never read
  const int last = last_tile(p, len);
  const int kb0 = split * p.pps;
  if (kb0 > last) return;                  // the combine never reads it
  const int kb1 = min(kb0 + p.pps, last + 1);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // visible positions of tile kb (the dense stripe's last tile is ragged)
  auto rows = [&](int kb) {
    const int n = min(BS, len + 1 - kb * BS);
    return DENSE ? min(n, p.S - kb * BS) : n;
  };

  constexpr int VEC = 16 / sizeof(T);
  const int row_vecs = D / VEC;
  const T* kg = static_cast<const T*>(p.k);
  const T* vg = static_cast<const T*>(p.v);
  if (DENSE) {
    kg += b * p.stride_kb + h * p.stride_kh;
    vg += b * p.stride_vb + h * p.stride_vh;
  }
  const int* tab = DENSE ? nullptr : p.tables + (long long)b * p.nk;
  // issue the copy of tile kb's visible rows (paged: pool block blk) into
  // ring slot `slot`
  auto issue = [&](int kb, long long blk, int slot) {
    const long long r0 =
        DENSE ? (long long)kb * BS : (long long)h * p.pool_tokens + blk * BS;
    const int n = rows(kb);
    T* ks = ring + slot * 2 * BS * DP;
    T* vs = ks + BS * DP;
    for (int c = tid; c < n * row_vecs; c += SPLIT_THREADS) {
      const int r = c / row_vecs, col = (c - r * row_vecs) * VEC;
      cp_async16(ks + r * DP + col, kg + (r0 + r) * D + col);
      cp_async16(vs + r * DP + col, vg + (r0 + r) * D + col);
    }
  };
  // the page table entry of tile kb (dense: unused)
  auto entry = [&](int kb) { return DENSE ? 0 : tab[kb]; };
  // the first STAGES - 1 tiles in flight before anything else
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (kb0 + s < kb1) issue(kb0 + s, entry(kb0 + s), s);
    cp_async_commit();
  }
  // paged: the table entry of the tile to issue next, loaded one tile
  // ahead so that no iteration waits on it
  int blk_next = kb0 + STAGES - 1 < kb1 ? entry(kb0 + STAGES - 1) : 0;

  const long long row0 = ((long long)b * p.Hkv + h) * G;  // first (b, h, g)
  const T* qg = static_cast<const T*>(p.q) + row0 * D;
  for (int i = tid; i < G * D; i += SPLIT_THREADS) {
    q_s[i] = to_f(qg[i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += SPLIT_THREADS) {
    m_s[g] = NEG;
    l_s[g] = 0.f;
  }

  // scores: LN lanes per head (lanes over positions), HPW heads per warp
  const int LN = p.lanes, HPW = 32 / LN;
  const int hsub = lane / LN, tl = lane - hsub * LN;
  // P V: a thread owns the column pair 2 c, 2 c + 1 of the heads
  // hg, hg + HG, ...; heads go through registers PV_HEADS at a time
  const int CP = D / 2, HG = SPLIT_THREADS / CP;
  const int hg = tid / CP, c2 = 2 * (tid - hg * CP);
  for (int kb = kb0; kb < kb1; ++kb) {
    const int j = kb - kb0;
    cp_async_wait<STAGES - 2>();   // tile kb has landed (this thread's part)
    __syncthreads();               // ... everyone's; slot (j - 1) is free
    if (kb + STAGES - 1 < kb1)
      issue(kb + STAGES - 1, blk_next, (j + STAGES - 1) % STAGES);
    cp_async_commit();
    if (kb + STAGES < kb1) blk_next = entry(kb + STAGES);

    const T* ks = ring + (j % STAGES) * 2 * BS * DP;
    const T* vs = ks + BS * DP;
    const int n = rows(kb);        // visible positions

    for (int g0 = warp * HPW; g0 < G; g0 += SW * HPW) {
      const int g = g0 + hsub;
      const bool own = g < G;
      float* pr = p_s + g * BS;
      float mx = NEG;
      if (own) {
        for (int t = tl; t < n; t += LN) {
          const float x = dot_row(q_s + g * D, ks + t * DP, D) * p.scale;
          pr[t] = x;
          mx = fmaxf(mx, x);
        }
      }
      for (int o = LN / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = own ? m_s[g] : NEG;
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      if (own) {
        for (int t = tl; t < n; t += LN) {
          const float e = expf(pr[t] - m_new);
          sum += e;
          pr[t] = to_f(from_f<T>(e));   // PV takes p in V's dtype
        }
      }
      for (int o = LN / 2; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (own && tl == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        m_s[g] = m_new;
        l_s[g] = l_s[g] * alpha + sum;
      }
    }
    __syncthreads();

    // rescale the accumulator and add this tile's P V
    if (hg < HG) {
      for (int h0 = hg; h0 < G; h0 += HG * PV_HEADS) {
        float2 a[PV_HEADS];
#pragma unroll
        for (int k = 0; k < PV_HEADS; ++k) {
          const int g = h0 + k * HG;
          if (g < G) {
            a[k] = ld2(acc + g * D + c2);
            a[k].x *= a_s[g];
            a[k].y *= a_s[g];
          }
        }
#pragma unroll 4
        for (int t = 0; t < n; ++t) {
          const float2 v = ld2(vs + t * DP + c2);
#pragma unroll
          for (int k = 0; k < PV_HEADS; ++k) {
            const int g = h0 + k * HG;
            if (g < G) {
              const float pk = p_s[g * BS + t];
              a[k].x = fmaf(pk, v.x, a[k].x);
              a[k].y = fmaf(pk, v.y, a[k].y);
            }
          }
        }
#pragma unroll
        for (int k = 0; k < PV_HEADS; ++k) {
          const int g = h0 + k * HG;
          if (g < G) *reinterpret_cast<float2*>(acc + g * D + c2) = a[k];
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  const long long prow = (bh * (long long)p.n_split + split) * G;
  float* o = p.part_o + prow * D;
  for (int i = tid; i < G * D; i += SPLIT_THREADS) o[i] = acc[i];
  for (int g = tid; g < G; g += SPLIT_THREADS) {
    p.part_m[prow + g] = m_s[g];
    p.part_l[prow + g] = l_s[g];
  }
}

// max or sum over the block (COMBINE_THREADS threads); red holds one
// float per warp
template <bool MAX>
__device__ __forceinline__ float block_reduce(float x, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = MAX ? fmaxf(x, y) : x + y;
  }
  __syncthreads();                       // red is free
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = red[0];
  for (int w = 1; w < COMBINE_THREADS / 32; ++w)
    x = MAX ? fmaxf(x, red[w]) : x + red[w];
  return x;
}

// Block = (b, hkv, g): merge the live splits' partials of one head with
// the algebra of core/merge.py (the global max, each split's weight
// exp(m_s - max), then the weighted sums).  Normalized: o / l in T, 0
// where l = 0.  PARTIAL: the merged f32 (o, m, l).  A request with a
// negative length has no live split and gets exactly 0, or exactly
// (0, -1e30, 0).
template <typename T, bool PARTIAL>
__global__ void __launch_bounds__(COMBINE_THREADS)
    decode_combine_kernel(SplitParams p) {
  extern __shared__ float w_s[];         // n_split weights
  __shared__ float red[COMBINE_THREADS / 32];
  const int G = p.G, D = p.D, tid = threadIdx.x;
  const int bh = blockIdx.x / G, g = blockIdx.x - bh * G, b = bh / p.Hkv;
  const int last = last_tile(p, p.lengths[b]);
  const int live = last < 0 ? 0 : last / p.pps + 1;
  const long long r0 = (long long)bh * p.n_split * G + g;   // split 0's row
  float mx = NEG;
  for (int s = tid; s < live; s += COMBINE_THREADS) {
    w_s[s] = p.part_m[r0 + (long long)s * G];
    mx = fmaxf(mx, w_s[s]);
  }
  mx = block_reduce<true>(mx, red);
  float l = 0.f;
  for (int s = tid; s < live; s += COMBINE_THREADS) {
    w_s[s] = expf(w_s[s] - mx);
    l = fmaf(p.part_l[r0 + (long long)s * G], w_s[s], l);
  }
  l = block_reduce<false>(l, red);       // its barriers publish w_s too
  const float* po = p.part_o + r0 * D;
  const long long orow = (long long)bh * G + g;
  for (int d = tid; d < D; d += COMBINE_THREADS) {
    float o = 0.f;
#pragma unroll 4
    for (int s = 0; s < live; ++s)
      o = fmaf(po[(long long)s * G * D + d], w_s[s], o);
    if (PARTIAL)
      static_cast<float*>(p.out)[orow * D + d] = o;
    else
      static_cast<T*>(p.out)[orow * D + d] =
          from_f<T>(l > 0.f ? o / fmaxf(l, 1e-30f) : 0.f);
  }
  if (PARTIAL && tid == 0) {
    p.out_m[orow] = mx;
    p.out_l[orow] = l;
  }
}

template <typename T, bool DENSE, bool PARTIAL>
int launch_split(const SplitParams& p, int B, cudaStream_t stream) {
  const size_t smem = (size_t)split_smem_bytes<T>(p.G, p.D, p.tile);
  auto split = decode_split_kernel<T, DENSE>;
  if (smem > STATIC_SMEM_LIMIT) {
    cudaError_t e = cudaFuncSetAttribute(
        split, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long heads = (long long)B * p.Hkv;
  if (heads == 0) return (int)cudaGetLastError();
  split<<<(unsigned)(heads * p.n_split), SPLIT_THREADS, smem, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t wsmem = sizeof(float) * p.n_split;
  auto combine = decode_combine_kernel<T, PARTIAL>;
  if (wsmem > STATIC_SMEM_LIMIT) {
    e = cudaFuncSetAttribute(combine,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)wsmem);
    if (e != cudaSuccess) return (int)e;
  }
  combine<<<(unsigned)(heads * p.G), COMBINE_THREADS, wsmem, stream>>>(p);
  return (int)cudaGetLastError();
}

// what both entries refuse: a split plan that misses a tile, or a head dim
// the P V layout cannot cover
bool split_ok(int nk, int D, int pps, int n_split) {
  return pps > 0 && n_split * pps >= nk && D <= 2 * SPLIT_THREADS &&
         D % 2 == 0;
}

int lanes_for(int tile) {
  int lanes = 1;
  while (lanes < 32 && lanes < tile) lanes *= 2;
  return lanes;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  part_o / part_m / part_l: the f32
// workspace, (B, Hkv, n_split, G[, D]).  partial: out is f32 (B, Hkv, G, D)
// and out_m / out_l (B, Hkv, G) are written; else out is in T.
int flash_decode_dense(const void* q, const void* k, const void* v,
                       const int* lengths, void* out, float* out_m,
                       float* out_l, float* part_o, float* part_m,
                       float* part_l, int B, int Hkv, int G, int S, int D,
                       int tile, long long stride_kb, long long stride_kh,
                       long long stride_vb, long long stride_vh,
                       int pages_per_split, int n_split, float scale,
                       int dtype, int partial, void* stream) {
  const int nk = tile > 0 ? (S + tile - 1) / tile : 0;
  if (tile <= 0 || !split_ok(nk, D, pages_per_split, n_split))
    return (int)cudaErrorInvalidValue;
  SplitParams p{};
  p.q = q; p.k = k; p.v = v; p.lengths = lengths; p.tables = nullptr;
  p.out = out; p.out_m = out_m; p.out_l = out_l;
  p.part_o = part_o; p.part_m = part_m; p.part_l = part_l;
  p.Hkv = Hkv; p.G = G; p.D = D; p.tile = tile; p.nk = nk; p.S = S;
  p.pps = pages_per_split; p.n_split = n_split; p.lanes = lanes_for(tile);
  p.stride_kb = stride_kb; p.stride_kh = stride_kh;
  p.stride_vb = stride_vb; p.stride_vh = stride_vh;
  p.pool_tokens = 0; p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return partial ? launch_split<float, true, true>(p, B, s)
                   : launch_split<float, true, false>(p, B, s);
  if (dtype == 1)
    return partial ? launch_split<__nv_bfloat16, true, true>(p, B, s)
                   : launch_split<__nv_bfloat16, true, false>(p, B, s);
  return (int)cudaErrorInvalidValue;
}

// part_o / part_m / part_l: the f32 workspace, (B, Hkv, n_split, G[, D])
int flash_decode_paged(const void* q, const void* k_pool, const void* v_pool,
                       const int* lengths, const int* tables, void* out,
                       float* part_o, float* part_m, float* part_l, int B,
                       int Hkv, int G, long long pool_tokens, int block_size,
                       int nk, int D, int pages_per_split, int n_split,
                       float scale, int dtype, void* stream) {
  if (!split_ok(nk, D, pages_per_split, n_split))
    return (int)cudaErrorInvalidValue;
  SplitParams p{};
  p.q = q; p.k = k_pool; p.v = v_pool; p.lengths = lengths; p.tables = tables;
  p.out = out; p.part_o = part_o; p.part_m = part_m; p.part_l = part_l;
  p.Hkv = Hkv; p.G = G; p.D = D; p.tile = block_size; p.nk = nk;
  p.pps = pages_per_split; p.n_split = n_split;
  p.lanes = lanes_for(block_size);
  p.pool_tokens = pool_tokens; p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_split<float, false, false>(p, B, s);
  if (dtype == 1) return launch_split<__nv_bfloat16, false, false>(p, B, s);
  return (int)cudaErrorInvalidValue;
}

long long flash_decode_split_smem_bytes(int G, int D, int tile, int dtype) {
  return dtype == 0 ? split_smem_bytes<float>(G, D, tile)
                    : split_smem_bytes<__nv_bfloat16>(G, D, tile);
}

const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
