// Document-masked causal flash attention for Hopper (sm_90a): the three
// training kernels, walking host-built visit tables (rect lists or flat
// work queues).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/doc_attention.py:
//   * fwd_wgmma_kernel<FLAT, BK, D> <- ::flash_fwd in bf16 at block_q,
//     block_k and D each 64 or 128, fwd_mma_kernel<FLAT, KT> <- ::flash_fwd
//     in bf16 at every other shape, and
//     fwd_kernel<float, FLAT>   <- ::flash_fwd in f32 (_fwd_kernel /
//     _fwd_kernel_flat over _fwd_init, _fwd_visit, _fwd_finalize);
//   * dq_mma_kernel<FLAT, KT>   <- ::flash_bwd_dq in bf16, and
//     dq_kernel<float, FLAT>    <- ::flash_bwd_dq in f32 (_dq_kernel /
//     _dq_kernel_flat over _dq_visit);
//   * dkv_mma_kernel<FLAT, QC> (+ dkv_sum_kernel) <- ::flash_bwd_dkv in
//     bf16, and dkv_kernel<float, FLAT> <- ::flash_bwd_dkv in f32
//     (_dkv_kernel / _dkv_kernel_flat over _dkv_visit).
//
// Bound on this card: operations.  Each visited (q block, kv block) pair
// costs 2 * bq * bk * D flops per matrix product and head: 2 products in
// the forward, 3 in dQ, 4 in dK/dV, against about (bq + 2 bk) * D * 2
// bytes of input, far above the ridge point, so the tensor cores set the
// bound that chip_smoke.py reports.
//   * fwd_wgmma_kernel (bf16) runs both products as wgmma (Hopper's full
//     tensor-core rate) on K and V tiles that one producer thread brings
//     by TMA into a 2-stage mbarrier ring, for two (block_q 128) or one
//     consumer warpgroups of 64 q rows, and masks only the tiles that need
//     it; its design is described above the kernel.  The wrapper
//     (kernels/doc_attention.py::fwd_kernel_for) picks it by shape alone.
//   * fwd_mma_kernel (bf16, the shapes fwd_wgmma_kernel does not take)
//     runs both products on the tensor cores
//     (mma.sync m16n8k16, bf16 in, f32 accumulate).  bq / 16 warps each
//     own 16 q rows: the Q tile is copied once with cp.async and held in
//     registers as A fragments (ldmatrix); K and V stream in KT-key bf16
//     sub-tiles (64, or 32 where block_k demands) through a 2-stage
//     cp.async ring, the next sub-tile of the walk in flight while one is
//     computed, rows padded by 16 bytes so that ldmatrix (.trans for V) is
//     free of bank conflicts.  The walk's next table step is loaded one
//     visit ahead.  S, the online softmax (row max and sum over the 4
//     threads of a quad, on unscaled scores with the scale folded into
//     the exponent, exp as ex2.approx) and O stay in the accumulator
//     registers;
//     P becomes the A fragment of P V in registers.  Two barriers per
//     sub-tile.  It takes D % 16 == 0 (D <= 128) and a positive scale;
//     the wrapper refuses other bf16 inputs.
//   * dq_mma_kernel (bf16) runs its three products on the tensor cores on
//     the forward's streaming design, with dO held beside Q and dS as the
//     A fragment of dS K in registers; its design is described above the
//     kernel.  It takes D % 16 == 0 (D <= 128), any scale.
//   * dkv_mma_kernel (bf16) runs all four dK/dV products on the tensor
//     cores with the CTA's keys as the M dimension, so P^T and dS^T feed
//     the dV and dK products from registers; its design is described
//     above the kernel.
//   * fwd_kernel, dq_kernel and dkv_kernel (f32 only: the parity
//     references on the card) run scalar f32 FMA (no mma, wgmma or TMA),
//     so the f32 CUDA-core rate is their practical ceiling.  They keep the
//     whole working set of a visit in shared memory and registers: the
//     owned tile (q, or q and dO, staged once per CTA) as f32, 32-key
//     sub-tiles of K and V, and per-thread 8x2 (scores) and 8x8
//     (accumulator) register micro-tiles read with 16-byte shared loads.
//
// Ordering.  A Pallas grid walks the visits of a row in order and carries
// the accumulator in VMEM; a GPU grid has no order.  So one CTA owns one
// output block row and loops over that row's visits itself:
//   * rect: visits kv_idx[b, row, t] for t < kv_nvis[b, row];
//   * flat: queue row i starts at starts[b, i] (a FIRST step); the CTA
//     computes on VALID steps and stops after the LAST step, so it never
//     reads another row's steps or the pad tail.  CTAs are numbered row
//     ordinal outermost, so the queue's LPT order is the launch order.
// An empty row (a sentinel step, or nvis 0) still writes: o = 0 and
// lse = -inf forward, zeros backward.
//
// Semantics (identical to the TPU kernels):
//   * visible iff same doc, q_pos >= kv_pos, and both docs >= 0;
//   * forward: online softmax in f32 with m initialised to -1e30; masked
//     scores are -1e30; p is rounded to V's dtype before PV while l sums
//     the unrounded p; o = acc / l (0 where l = 0), lse = m + log(l)
//     (-inf where l = 0).  The TPU kernel updates m once per 128-key block;
//     these once per 32- or 64-key sub-tile (the same softmax, rescaled in
//     other steps);
//   * dQ: P = exp(S - lse_safe) with lse_safe = 0 where lse is -inf,
//     dS = P (dO.V^T - delta) scale, rounded to K's dtype before dS.K
//     (dq_mma_kernel rounds there and nowhere else);
//   * dK/dV: the same P and dS; dV += P^T dO and dK += dS^T Q summed over
//     the GQA group in f32.  f32 (dkv_kernel): nothing rounded, and a
//     128-key KV row is split over CTAs by 32-key sub-tile, all walking
//     the same visits, so a CTA's dK and dV accumulators fit in registers
//     with no atomics.  bf16 (dkv_mma_kernel): P^T and dS^T keep f32
//     accuracy as the mma operands of dV and dK, each a hi + lo pair of
//     bf16 fragments (two mma.sync per product), so, like the reference,
//     it rounds neither; the sums stay f32.
//
// Plain C interface for ctypes; each entry returns cudaGetLastError() right
// after its launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

namespace {

constexpr float NEG = -1e30f;
constexpr int THREADS = 256;   // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int KT = 32;         // keys per sub-tile (block_k is a multiple)
constexpr int PP = KT + 1;     // pitch of a (rows x KT) score tile
constexpr int MAXI = 8;        // rows per thread: block_q / 16 <= 8
constexpr int UNROLL = 4;      // 16-byte loads in flight per thread
constexpr int STATIC_SMEM_LIMIT = 48 * 1024;
constexpr int FLAG_LAST = 2, FLAG_VALID = 4;

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

// round through T and back: the reference's x.astype(T) before a product
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

struct Params {
  const void* q;          // (B, Hq, Tq, D)
  const void* k;          // (B, Hkv, Tk, D)
  const void* v;
  const void* dout;       // (B, Hq, Tq, D), backward only
  const int* q_doc;       // (B, Tq)
  const int* q_pos;
  const int* kv_doc;      // (B, Tk)
  const int* kv_pos;
  const int* t0;          // rect: idx (B, R, W); flat: row (B, W)
  const int* t1;          // rect: nvis (B, R);   flat: col (B, W)
  const int* t2;          // flat: flags (B, W)
  const int* starts;      // flat: (B, R) queue position of each run
  const float* lse;       // (B, Hq, Tq), backward only
  const float* delta;
  void* out0;             // fwd: o; dq: dq; dkv: dk
  void* out1;             // fwd: lse (f32); dkv: dv
  float* ws;              // bf16 dkv with slices > 1: f32 (2, slices, B, Hkv, Tk, D)
  int B, Hq, Hkv, G, Tq, Tk, D, bq, bk, R, W;
  int parts, slices;      // bf16 dkv: key parts per block row, group slices
  int key_tile;           // bf16 dq: keys per sub-tile asked for (32, 64)
  float scale;
};

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

__device__ __forceinline__ void fma4(float a, float4 b, float4& c) {
  c.x = fmaf(a, b.x, c.x);
  c.y = fmaf(a, b.y, c.y);
  c.z = fmaf(a, b.z, c.z);
  c.w = fmaf(a, b.w, c.w);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ bool visible(int qd, int qp, int kd, int kp) {
  return qd == kd && qp >= kp && qd >= 0 && kd >= 0;
}

// sum / max over the 16 threads of one half-warp (the tx of one ty)
__device__ __forceinline__ float half_warp_max(float x) {
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Stage `nrows` rows of D contiguous elements (16-byte aligned) into shared
// memory as f32 with row pitch DP.  Each thread issues up to UNROLL 16-byte
// loads before it converts and stores any.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, float* dst,
                                      int nrows, int D, int DP, int tid) {
  constexpr int VEC = 16 / sizeof(T);
  const int nvec = nrows * D / VEC;
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  for (int base = 0; base < nvec; base += THREADS * UNROLL) {
    uint4 r[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int c = base + u * THREADS + tid;
      if (c < nvec) r[u] = __ldg(s4 + c);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int c = base + u * THREADS + tid;
      if (c < nvec) {
        const int e = c * VEC, row = e / D, col = e - row * D;
        const T* x = reinterpret_cast<const T*>(&r[u]);
        float* d = dst + row * DP + col;
#pragma unroll
        for (int j = 0; j < VEC; j += 4)
          *reinterpret_cast<float4*>(d + j) = make_float4(
              to_f(x[j]), to_f(x[j + 1]), to_f(x[j + 2]), to_f(x[j + 3]));
      }
    }
  }
}

// CTA -> (row ordinal i, rest): row ordinal outermost
__device__ __forceinline__ int cta_row(int per_row, int* rest) {
  const int i = blockIdx.x / per_row;
  *rest = blockIdx.x - i * per_row;
  return i;
}

// First queue position and output row of row ordinal i; false when the
// queue holds no run for it.
template <bool FLAT>
__device__ __forceinline__ bool walk_begin(const Params& p, int b, int i,
                                           int* s0, int* row) {
  if (!FLAT) {
    *s0 = 0;
    *row = i;
    return true;
  }
  *s0 = p.starts[b * p.R + i];
  if (*s0 < 0) return false;
  *row = p.t0[(long long)b * p.W + *s0];
  return true;
}

// Visit t of the row's walk: returns false when the walk is over; else
// sets *col and *flags (VALID: compute; LAST: stop after this one).
template <bool FLAT>
__device__ __forceinline__ bool walk_step(const Params& p, int b, int row,
                                          int s0, int t, int* col,
                                          int* flags) {
  if (FLAT) {
    const int s = s0 + t;
    if (s >= p.W) return false;
    const long long o = (long long)b * p.W + s;
    *flags = p.t2[o];
    *col = p.t1[o];
    return true;
  }
  const long long r = (long long)b * p.R + row;
  if (t >= p.t1[r]) return false;
  *col = p.t0[r * p.W + t];
  *flags = FLAG_VALID;
  return true;
}

// Scores of one 32-key sub-tile: acc[i][j] = a[row(i)] . b[key(j)] for the
// rows ty + 16 i of `a` (pitch DP) and the keys tx + 16 j of `b`.
__device__ __forceinline__ void tile_scores(const float* a, const float* b,
                                            int NI, int ND4, int DP, int ty,
                                            int tx, float (&acc)[MAXI][2]) {
#pragma unroll
  for (int i = 0; i < MAXI; ++i) acc[i][0] = acc[i][1] = 0.f;
  const float* b0 = b + tx * DP;
  const float* b1 = b + (tx + 16) * DP;
  for (int d4 = 0; d4 < ND4; ++d4) {
    const float4 k0 = ld4(b0 + 4 * d4), k1 = ld4(b1 + 4 * d4);
#pragma unroll
    for (int i = 0; i < MAXI; ++i) {
      if (i < NI) {
        const float4 x = ld4(a + (ty + 16 * i) * DP + 4 * d4);
        acc[i][0] = dot4(x, k0, acc[i][0]);
        acc[i][1] = dot4(x, k1, acc[i][1]);
      }
    }
  }
}

// acc[i][j] (row ty + 16 i, columns 4 (tx + 16 j) .. + 3) += w[row][c] *
// m[c][cols] over the KT columns c of w (pitch PP) and rows of m (pitch DP).
__device__ __forceinline__ void tile_accum(const float* w, const float* m,
                                           int NI, int ND4, int DP, int ty,
                                           int tx, float4 (&acc)[MAXI][2]) {
  const bool has0 = tx < ND4, has1 = tx + 16 < ND4;
  for (int c = 0; c < KT; ++c) {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 m0 = has0 ? ld4(m + c * DP + 4 * tx) : z;
    const float4 m1 = has1 ? ld4(m + c * DP + 4 * (tx + 16)) : z;
#pragma unroll
    for (int i = 0; i < MAXI; ++i) {
      if (i < NI) {
        const float x = w[(ty + 16 * i) * PP + c];
        fma4(x, m0, acc[i][0]);
        fma4(x, m1, acc[i][1]);
      }
    }
  }
}

// ------------------------------------------------------------------------
// forward: CTA = (q-block row, b, hq).  Replaces flash_fwd
// (doc_attention.py:634, _fwd_kernel / _fwd_kernel_flat).  Bound:
// operations, 2 products of 2 * bq * bk * D flops per visit and head.
// ------------------------------------------------------------------------
template <typename T, bool FLAT>
__global__ void __launch_bounds__(THREADS, 1) fwd_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D = p.D, DP = D + 4, BQ = p.bq, BK = p.bk;
  const int NI = BQ / 16, ND4 = D / 4;
  float* q_s = smem;                    // BQ x DP
  float* k_s = q_s + BQ * DP;           // KT x DP
  float* v_s = k_s + KT * DP;           // KT x DP
  float* p_s = v_s + KT * DP;           // BQ x PP
  int* qd_s = reinterpret_cast<int*>(p_s + BQ * PP);   // BQ
  int* qp_s = qd_s + BQ;
  int* kd_s = qp_s + BQ;                // KT
  int* kp_s = kd_s + KT;

  int rest;
  const int i_row = cta_row(p.B * p.Hq, &rest);
  const int b = rest / p.Hq, h = rest - b * p.Hq, hkv = h / p.G;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  int s0, row;
  if (!walk_begin<FLAT>(p, b, i_row, &s0, &row)) return;

  const long long q0 = ((long long)b * p.Hq + h) * p.Tq + (long long)row * BQ;
  stage<T>(static_cast<const T*>(p.q) + q0 * D, q_s, BQ, D, DP, tid);
  for (int r = tid; r < BQ; r += THREADS) {
    qd_s[r] = p.q_doc[(long long)b * p.Tq + row * BQ + r];
    qp_s[r] = p.q_pos[(long long)b * p.Tq + row * BQ + r];
  }
  float m[MAXI], l[MAXI];
  float4 acc[MAXI][2];
#pragma unroll
  for (int i = 0; i < MAXI; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
    acc[i][0] = acc[i][1] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const long long kv0 = ((long long)b * p.Hkv + hkv) * p.Tk;
  const T* kg = static_cast<const T*>(p.k);
  const T* vg = static_cast<const T*>(p.v);
  __syncthreads();

  int col, flags;
  for (int t = 0; walk_step<FLAT>(p, b, row, s0, t, &col, &flags); ++t) {
    if (flags & FLAG_VALID) {
      for (int kt = 0; kt < BK; kt += KT) {
        const long long key0 = (long long)col * BK + kt;
        stage<T>(kg + (kv0 + key0) * D, k_s, KT, D, DP, tid);
        stage<T>(vg + (kv0 + key0) * D, v_s, KT, D, DP, tid);
        if (tid < KT) {
          kd_s[tid] = p.kv_doc[(long long)b * p.Tk + key0 + tid];
          kp_s[tid] = p.kv_pos[(long long)b * p.Tk + key0 + tid];
        }
        __syncthreads();

        float s[MAXI][2];
        tile_scores(q_s, k_s, NI, ND4, DP, ty, tx, s);
        const int kd0 = kd_s[tx], kp0 = kp_s[tx];
        const int kd1 = kd_s[tx + 16], kp1 = kp_s[tx + 16];
#pragma unroll
        for (int i = 0; i < MAXI; ++i) {
          if (i < NI) {
            const int r = ty + 16 * i;
            const int qd = qd_s[r], qp = qp_s[r];
            const bool v0 = visible(qd, qp, kd0, kp0);
            const bool v1 = visible(qd, qp, kd1, kp1);
            const float x0 = v0 ? s[i][0] * p.scale : NEG;
            const float x1 = v1 ? s[i][1] * p.scale : NEG;
            const float m_new = fmaxf(m[i], half_warp_max(fmaxf(x0, x1)));
            const float alpha = expf(m[i] - m_new);
            const float p0 = v0 ? expf(x0 - m_new) : 0.f;
            const float p1 = v1 ? expf(x1 - m_new) : 0.f;
            l[i] = l[i] * alpha + half_warp_sum(p0 + p1);
            m[i] = m_new;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              acc[i][j].x *= alpha;
              acc[i][j].y *= alpha;
              acc[i][j].z *= alpha;
              acc[i][j].w *= alpha;
            }
            p_s[r * PP + tx] = round_to<T>(p0);       // PV takes p in V's dtype
            p_s[r * PP + tx + 16] = round_to<T>(p1);
          }
        }
        __syncthreads();
        tile_accum(p_s, v_s, NI, ND4, DP, ty, tx, acc);
        __syncthreads();
      }
    }
    if (flags & FLAG_LAST) break;
  }

  T* o = static_cast<T*>(p.out0) + q0 * D;
  float* lse = static_cast<float*>(p.out1) +
               ((long long)b * p.Hq + h) * p.Tq + (long long)row * BQ;
#pragma unroll
  for (int i = 0; i < MAXI; ++i) {
    if (i < NI) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int d4 = tx + 16 * j;
        if (d4 < ND4) {
          T* dst = o + (long long)r * D + 4 * d4;
          // acc / l, as the reference divides
          const float4 a = acc[i][j];
          const bool any = l[i] > 0.f;
          const float lc = fmaxf(l[i], 1e-30f);
          dst[0] = from_f<T>(any ? a.x / lc : 0.f);
          dst[1] = from_f<T>(any ? a.y / lc : 0.f);
          dst[2] = from_f<T>(any ? a.z / lc : 0.f);
          dst[3] = from_f<T>(any ? a.w / lc : 0.f);
        }
      }
      if (tx == 0)
        lse[r] = l[i] > 0.f ? m[i] + logf(fmaxf(l[i], 1e-30f)) : -INFINITY;
    }
  }
}

// ------------------------------------------------------------------------
// bf16 forward on the tensor cores: CTA = (q-block row, b, hq), as
// fwd_kernel, with bq / 16 warps of 16 q rows each.  Replaces flash_fwd
// (doc_attention.py:634) for bf16.  Bound: operations; S = Q K^T and
// O += P V run as mma.sync m16n8k16 (bf16 in, f32 accumulate).
// ------------------------------------------------------------------------
constexpr int MMA_MAX_D = 128;
// bf16 rows in shared memory are padded by 8 elements (16 bytes): the 8
// row addresses of one ldmatrix phase then fall in 8 distinct 4-bank
// groups for every D % 16 == 0
__host__ __device__ inline int mma_pitch(int D) { return D + 8; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&x);
}
// (x0, x1) as a hi + lo pair of packed bf16: hi = bf16(x), lo = bf16(x -
// hi), so hi + lo carries x to about 2^-16 relative
__device__ __forceinline__ void pack_bf16_split(float x0, float x1,
                                                unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// 2^x (ex2.approx: 2 ulp; 2^-inf is +0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// max / sum over the 4 threads of a quad (the threads of one fragment row)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The walk as a stream of KT-key sub-tiles.  The cursor holds the step
// after the current one already loaded (n*), so moving to the next visit
// never waits on the tables: the load of a step is issued one visit ahead.
struct Cursor {
  int t = -1, kt = 0, col = 0, flags = 0;
  int ncol = 0, nflags = 0, nvis = 0;
  bool nend = false;
};

// load walk step t of the row into the cursor's n* fields
template <bool FLAT>
__device__ __forceinline__ void load_step(const Params& p, int b, int row,
                                          int s0, int t, Cursor& c) {
  if (FLAT) {
    c.nend = s0 + t >= p.W;
    if (!c.nend) {
      const long long o = (long long)b * p.W + s0 + t;
      c.nflags = p.t2[o];
      c.ncol = p.t1[o];
    }
  } else {
    c.nend = t >= c.nvis;
    if (!c.nend) {
      c.ncol = p.t0[((long long)b * p.R + row) * p.W + t];
      c.nflags = FLAG_VALID;
    }
  }
}

template <bool FLAT>
__device__ __forceinline__ Cursor walk_start(const Params& p, int b, int row,
                                             int s0) {
  Cursor c;
  if (!FLAT) c.nvis = p.t1[(long long)b * p.R + row];
  load_step<FLAT>(p, b, row, s0, 0, c);
  return c;
}

// advance to the next unit of a VALID visit (units kt = 0, step, ...
// below limit); false once the walk is over (a LAST step done, or no step
// left), and from then on
template <bool FLAT>
__device__ __forceinline__ bool advance_by(const Params& p, int b, int row,
                                           int s0, Cursor& c, int step,
                                           int limit) {
  if (c.t >= 0 && (c.flags & FLAG_VALID) && c.kt + step < limit) {
    c.kt += step;
    return true;
  }
  while (!(c.t >= 0 && (c.flags & FLAG_LAST))) {
    if (c.nend) {
      c.flags = FLAG_LAST;
      return false;
    }
    ++c.t;
    c.col = c.ncol;
    c.flags = c.nflags;
    load_step<FLAT>(p, b, row, s0, c.t + 1, c);
    if (c.flags & FLAG_VALID) {
      c.kt = 0;
      return true;
    }
  }
  return false;
}

// the forward's walk: KT-key sub-tiles of each visit's block_k keys
template <bool FLAT, int KT>
__device__ __forceinline__ bool advance(const Params& p, int b, int row,
                                        int s0, Cursor& c) {
  return advance_by<FLAT>(p, b, row, s0, c, KT, p.bk);
}

// bytes of shared memory of one fwd_mma_kernel CTA: the q tile, a 2-stage
// ring of K and V sub-tiles (bf16, padded rows) and their doc / pos
__host__ __device__ inline long long mma_smem_bytes(int bq, int D, int KT) {
  const long long row = 2LL * mma_pitch(D);
  return bq * row + 2 * (2 * KT * row + 2LL * KT * 4);
}

// copy `rows` bf16 rows of D (16-byte aligned) into a padded tile
__device__ __forceinline__ void cp_async_rows(__nv_bfloat16* dst,
                                              const __nv_bfloat16* src,
                                              int rows, int D, int tid,
                                              int nthreads) {
  const int vecs = D / 8, DP = mma_pitch(D);   // 16-byte chunks per row
  for (int i = tid; i < rows * vecs; i += nthreads) {
    const int r = i / vecs, col = (i - r * vecs) * 8;
    cp_async16(dst + r * DP + col, src + (long long)r * D + col);
  }
}

// copy sub-tile (c.col, c.kt) of K and V (kv0: the head's first key) and
// its keys' doc / pos into ring slot `slot`: the ring holds 2 x {K, V}
// (KT x pitch each), `meta` 2 x {doc, pos} (KT words each)
template <int KT>
__device__ __forceinline__ void copy_kv(const Params& p, int b,
                                        long long kv0, __nv_bfloat16* ring,
                                        int* meta, const Cursor& c, int slot,
                                        int tid, int nthreads) {
  using bf16 = __nv_bfloat16;
  const int D = p.D, DP = mma_pitch(D), vecs = D / 8;
  const bf16* kg = static_cast<const bf16*>(p.k);
  const bf16* vg = static_cast<const bf16*>(p.v);
  const long long key0 = (long long)c.col * p.bk + c.kt;
  bf16* ks = ring + slot * 2 * KT * DP;
  bf16* vs = ks + KT * DP;
  for (int i = tid; i < KT * vecs; i += nthreads) {
    const int r = i / vecs, col = (i - r * vecs) * 8;
    cp_async16(ks + r * DP + col, kg + (kv0 + key0 + r) * D + col);
    cp_async16(vs + r * DP + col, vg + (kv0 + key0 + r) * D + col);
  }
  int* ms = meta + slot * 2 * KT;
  const long long t0 = (long long)b * p.Tk + key0;
  for (int i = tid; i < 2 * KT; i += nthreads)
    cp_async4(ms + i, (i < KT ? p.kv_doc + t0 + i : p.kv_pos + t0 + i - KT));
}

// this warp's 16 rows of a (rows x D) bf16 tile (pitch DP) as the A
// fragments of NK 16-wide k-steps
__device__ __forceinline__ void load_a(unsigned (&f)[MMA_MAX_D / 16][4],
                                       const __nv_bfloat16* tile, int NK,
                                       int DP, int warp, int lane) {
#pragma unroll
  for (int kk = 0; kk < MMA_MAX_D / 16; ++kk)
    if (kk < NK)
      ldsm_x4(f[kk], tile + (warp * 16 + (lane & 15)) * DP + kk * 16 +
                         (lane >> 4) * 8);
}

// c = A B^T over D: A this warp's 16 rows (fragments a), B the KT rows of
// `bt` (pitch DP); n-tiles j, j + 1 of B's rows per ldmatrix.x4
template <int KT>
__device__ __forceinline__ void mma_abt(float (&c)[KT / 8][4],
                                        const unsigned (&a)[MMA_MAX_D / 16][4],
                                        const __nv_bfloat16* bt, int NK,
                                        int DP, int lane) {
#pragma unroll
  for (int j = 0; j < KT / 8; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < MMA_MAX_D / 16; ++kk) {
    if (kk < NK) {
#pragma unroll
      for (int j = 0; j < KT / 8; j += 2) {
        unsigned f[4];
        ldsm_x4(f, bt + (8 * j + (lane & 7) + (lane >> 4) * 8) * DP +
                       kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(c[j], a[kk], f[0], f[1]);
        mma_bf16(c[j + 1], a[kk], f[2], f[3]);
      }
    }
  }
}

// c += A B over KT: A as bf16 fragments of 16-key chunks (a), B the
// (KT x D) tile `bm` (pitch DP) by ldmatrix.trans; n-tiles n, n + 1 of D
template <int KT>
__device__ __forceinline__ void mma_ab(float (&c)[MMA_MAX_D / 8][4],
                                       const unsigned (&a)[KT / 16][4],
                                       const __nv_bfloat16* bm, int ND,
                                       int DP, int lane) {
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk) {
#pragma unroll
    for (int n = 0; n < MMA_MAX_D / 8; n += 2) {
      if (n < ND) {
        unsigned f[4];
        ldsm_x4_t(f, bm + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                              DP + 8 * n + (lane >> 4) * 8);
        mma_bf16(c[n], a[kk], f[0], f[1]);
        mma_bf16(c[n + 1], a[kk], f[2], f[3]);
      }
    }
  }
}

template <bool FLAT, int KT>
__global__ void __launch_bounds__(256, 1) fwd_mma_kernel(Params p) {
  using bf16 = __nv_bfloat16;
  constexpr int NT = KT / 8;                 // 8-key n-tiles of S
  constexpr int MAXK = MMA_MAX_D / 16;       // 16-wide k-steps of Q K^T
  constexpr int MAXN = MMA_MAX_D / 8;        // 8-wide n-tiles of O
  extern __shared__ float4 smem4[];
  const int D = p.D, DP = mma_pitch(D), BQ = p.bq;
  const int NK = D / 16, ND = D / 8;
  bf16* q_s = reinterpret_cast<bf16*>(smem4);          // BQ x DP
  bf16* ring = q_s + BQ * DP;                          // 2 x {K, V}: KT x DP
  int* meta = reinterpret_cast<int*>(ring + 4 * KT * DP);   // 2 x {doc, pos}

  int rest;
  const int i_row = cta_row(p.B * p.Hq, &rest);
  const int b = rest / p.Hq, h = rest - b * p.Hq, hkv = h / p.G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = BQ * 2;
  int s0, row;
  if (!walk_begin<FLAT>(p, b, i_row, &s0, &row)) return;

  const long long q0 = ((long long)b * p.Hq + h) * p.Tq + (long long)row * BQ;
  const long long kv0 = ((long long)b * p.Hkv + hkv) * p.Tk;

  // this thread's two q rows (fragment rows g and g + 8 of its warp)
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  const long long tok = (long long)b * p.Tq + (long long)row * BQ;
  const int qd0 = p.q_doc[tok + r0], qp0 = p.q_pos[tok + r0];
  const int qd1 = p.q_doc[tok + r1], qp1 = p.q_pos[tok + r1];

  Cursor cur = walk_start<FLAT>(p, b, row, s0);
  bool have = advance<FLAT, KT>(p, b, row, s0, cur);
  float o[MAXN][4];
#pragma unroll
  for (int n = 0; n < MAXN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // m: row max of the unscaled scores; l: this thread's share of the sum
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;
  const float c2 = p.scale * 1.4426950408889634f;   // scale * log2(e)

  if (have) {
    cp_async_rows(q_s, static_cast<const bf16*>(p.q) + q0 * D, BQ, D, tid,
                  nthreads);
    copy_kv<KT>(p, b, kv0, ring, meta, cur, 0, tid, nthreads);
    cp_async_commit();
  }
  unsigned qf[MAXK][4];          // this warp's Q rows as A fragments
  bool first = true;
  int slot = 0;
  while (have) {
    Cursor nxt = cur;
    const bool more = advance<FLAT, KT>(p, b, row, s0, nxt);
    // slot ^ 1 was freed by the last barrier
    if (more)
      copy_kv<KT>(p, b, kv0, ring, meta, nxt, slot ^ 1, tid, nthreads);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (first) {
      load_a(qf, q_s, NK, DP, warp, lane);
      first = false;
    }
    const bf16* ks = ring + slot * 2 * KT * DP;
    const bf16* vs = ks + KT * DP;
    const int* kd_s = meta + slot * 2 * KT;
    const int* kp_s = kd_s + KT;

    float s[NT][4];                // S = Q K^T
    mma_abt<KT>(s, qf, ks, NK, DP, lane);

    // mask, online softmax in f32 (rows r0: s[.][0..1], r1: s[.][2..3]) on
    // unscaled scores: scale > 0 commutes with the max, and folds with
    // log2(e) into one FFMA before ex2.  A masked score is -inf: its p is
    // exactly 0 and, as m never drops below NEG, it moves no max, which is
    // what the reference's NEG score does.
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int key = 8 * j + 2 * tq;
      const int2 kd = *reinterpret_cast<const int2*>(kd_s + key);
      const int2 kp = *reinterpret_cast<const int2*>(kp_s + key);
      s[j][0] = visible(qd0, qp0, kd.x, kp.x) ? s[j][0] : -INFINITY;
      s[j][1] = visible(qd0, qp0, kd.y, kp.y) ? s[j][1] : -INFINITY;
      s[j][2] = visible(qd1, qp1, kd.x, kp.x) ? s[j][2] : -INFINITY;
      s[j][3] = visible(qd1, qp1, kd.y, kp.y) ? s[j][3] : -INFINITY;
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float a0 = ex2((m0 - mn0) * c2), a1 = ex2((m1 - mn1) * c2);
    m0 = mn0;
    m1 = mn1;
    const float mc0 = mn0 * c2, mc1 = mn1 * c2;
    float sum0 = 0.f, sum1 = 0.f;
    unsigned pf[NT / 2][4];        // P as A fragments, in V's dtype
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float p0 = ex2(fmaf(s[j][0], c2, -mc0));
      const float p1 = ex2(fmaf(s[j][1], c2, -mc0));
      const float p2 = ex2(fmaf(s[j][2], c2, -mc1));
      const float p3 = ex2(fmaf(s[j][3], c2, -mc1));
      sum0 += p0 + p1;
      sum1 += p2 + p3;
      pf[j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
      pf[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
#pragma unroll
    for (int n = 0; n < MAXN; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
    }

    mma_ab<KT>(o, pf, vs, ND, DP, lane);   // O += P V
    __syncthreads();               // the slot is free for the next copy
    cur = nxt;
    have = more;
    slot ^= 1;
  }
  cp_async_wait<0>();

  // epilogue: o = acc / l (0 where l = 0), lse = m + log l (-inf there)
  const float lt0 = quad_sum(l0), lt1 = quad_sum(l1);
  bf16* og = static_cast<bf16*>(p.out0) + q0 * D;
#pragma unroll
  for (int n = 0; n < MAXN; ++n) {
    if (n < ND) {
      const int c = 8 * n + 2 * tq;
      const float d0 = fmaxf(lt0, 1e-30f), d1 = fmaxf(lt1, 1e-30f);
      *reinterpret_cast<__nv_bfloat162*>(og + (long long)r0 * D + c) =
          lt0 > 0.f ? __floats2bfloat162_rn(o[n][0] / d0, o[n][1] / d0)
                    : __floats2bfloat162_rn(0.f, 0.f);
      *reinterpret_cast<__nv_bfloat162*>(og + (long long)r1 * D + c) =
          lt1 > 0.f ? __floats2bfloat162_rn(o[n][2] / d1, o[n][3] / d1)
                    : __floats2bfloat162_rn(0.f, 0.f);
    }
  }
  if (tq == 0) {
    float* lse = static_cast<float*>(p.out1) +
                 ((long long)b * p.Hq + h) * p.Tq + (long long)row * BQ;
    lse[r0] = lt0 > 0.f ? m0 * p.scale + logf(lt0) : -INFINITY;
    lse[r1] = lt1 > 0.f ? m1 * p.scale + logf(lt1) : -INFINITY;
  }
}

// ------------------------------------------------------------------------
// bf16 forward on Hopper's own path: fwd_wgmma_kernel<FLAT, BK, D>.
// Replaces flash_fwd (src/repro/kernels/doc_attention.py:634) for bf16 at
// block_q in {64, 128}, block_k in {64, 128} and D in {64, 128}; every
// other bf16 shape (block_q 16-48, 80-112; block_k 32, 96; D 16-48,
// 80-112) keeps fwd_mma_kernel.  Bound: operations, 4 bq bk D flops per
// visit and head (at the main path's 8192-token wlb_llm row, 24/2 heads of
// 128: 0.3564 ms at 989 TFLOP/s).
//
// Design.  CTA = (q-block row, b, hq), numbered row ordinal outermost as
// the other kernels, walking the same rect lists or flat queue.  Threads:
// bq / 64 consumer warpgroups, each owning 64 q rows, then one producer
// warpgroup of which one thread works; setmaxnreg gives the producer 40
// registers and the consumers 232.  The producer issues TMA loads: the Q
// tile once, then per VALID visit the K and V tiles (block_k x D, 128-byte
// swizzle, D / 64 boxes of 64 columns) and the visit's kv doc and pos words
// (two bulk copies) into a 2-stage ring, each stage with a full barrier for
// K (with doc and pos) and one for V, and an empty barrier that the
// consumer warps release; no __syncthreads() after the set-up.  A stage
// word tells the consumers whether it holds a tile or ends the walk, so
// they never read the tables.  Each consumer warpgroup runs S = Q K^T as
// wgmma m64n{BK}k16 with Q and K from shared memory, the online softmax
// on S in registers (the same arithmetic as fwd_mma_kernel), then O += P V
// as wgmma m64n{D}k16 with P (rounded to bf16) from registers and V read
// through the descriptor's transpose (MN-major), O and m, l in registers
// until the one write at the end.  Masking only where needed: a warp whose
// 16 rows share one document (>= 0) skips the per-element test on a tile
// whose every key is of that document at or before the rows' smallest
// position, decided from the doc and pos words the tile brought (read
// while S runs); elsewhere it masks as fwd_mma_kernel does.  A warp
// rescales O only when the running max moved for one of its rows; with
// the early read, 0.75 instead of 0.81 ms at the main path's shape on an
// H100.  The wrapper builds the three tensor maps on the host at each
// launch and passes them as __grid_constant__ parameters; the kernel
// allocates nothing.  Issuing one visit's P V beside the next visit's S
// (in each warpgroup, or with the two warpgroups taking turns on named
// barriers) measured slower there (0.88-0.97 ms, against 0.81 ms for
// this design before the two refinements above): the two
// warpgroups left to themselves already overlap one's softmax with the
// other's products, and ptxas serialises wgmma whose operands are live
// across the extra overlap.
// ------------------------------------------------------------------------
constexpr int WG_THREADS = 128;
constexpr int WG_STAGES = 2;
constexpr int WG_BOX = 64;             // columns of one 128-byte TMA box

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
// one arrival that also expects `bytes` of asynchronous copies
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const unsigned a = smem_addr(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}
// TMA: the box at (column c0, row c1) of a 2-D tensor map into `dst`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}
// a bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// wgmma descriptor of a 128-byte-swizzled tile at `p` (1024-byte atoms of
// 8 rows of 128 bytes): lbo, sbo in bytes
__device__ __forceinline__ uint64_t wg_desc(const void* p, int lbo, int sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving reads or writes of an accumulator across
// the asynchronous products that own it
template <int N>
__device__ __forceinline__ void wg_hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, f32) = (scale_d ? d : 0) + A B^T: A and B K-major in
// shared memory (descriptors a, b)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64, f32) += A B: A bf16 fragments in registers, B MN-major in
// shared memory (descriptor b, read transposed)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const unsigned (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128, f32) = (scale_d ? d : 0) + A B^T: A and B K-major in
// shared memory (descriptors a, b)
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 128, f32) += A B: A bf16 fragments in registers, B MN-major in
// shared memory (descriptor b, read transposed)
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const unsigned (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// bytes of shared memory of one fwd_wgmma_kernel CTA: 1024 of alignment
// slack, the Q tile, the ring's K and V tiles, their doc / pos words, the
// stage words and the barriers
__host__ __device__ inline long long wgmma_smem_bytes(int bq, int bk, int D) {
  return 1024 + 2LL * bq * D + WG_STAGES * (4LL * bk * D + 8LL * bk) +
         16 + 8 * (1 + 3 * WG_STAGES);
}

template <bool FLAT, int BK, int D>
__global__ void __launch_bounds__(3 * WG_THREADS, 1)
    fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const Params p) {
  constexpr int NS = BK / 8;             // 8-key column groups of S
  constexpr int NO = D / 8;              // 8-wide column groups of O
  constexpr int BOXES = D / WG_BOX;      // 128-byte boxes of a row
  constexpr int TILE = BK * D * 2;       // bytes of a K or V tile
  extern __shared__ unsigned char smem_raw[];
  // TMA's 128-byte swizzle repeats every 1024 bytes: align the tiles so
  unsigned char* base =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int BQ = p.bq, NWG = BQ / 64;
  unsigned char* q_s = base;                       // BOXES x (BQ x 128 B)
  unsigned char* ring = q_s + BQ * D * 2;          // stage: K, V tiles
  int* meta = reinterpret_cast<int*>(ring + 2 * WG_STAGES * TILE);
  int* info = meta + 2 * WG_STAGES * BK;           // stage: 1 tile, 0 end
  uint64_t* bars = reinterpret_cast<uint64_t*>(info + 4);
  uint64_t* full_q = bars;
  uint64_t* full_k = bars + 1;                     // K, doc, pos arrived
  uint64_t* full_v = full_k + WG_STAGES;           // V arrived
  uint64_t* empty = full_v + WG_STAGES;            // the consumers are done

  int rest;
  const int i_row = cta_row(p.B * p.Hq, &rest);
  const int b = rest / p.Hq, h = rest - b * p.Hq, hkv = h / p.G;
  int s0, row;
  if (!walk_begin<FLAT>(p, b, i_row, &s0, &row)) return;
  const int tid = threadIdx.x, wg = tid / WG_THREADS;
  if (tid == 0) {
    mbar_init(full_q, 1);
    for (int st = 0; st < WG_STAGES; ++st) {
      mbar_init(full_k + st, 1);
      mbar_init(full_v + st, 1);
      mbar_init(empty + st, 4 * NWG);              // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {
    // ---- producer: one thread walks the row and issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == NWG * WG_THREADS) {
      const int qrow = (b * p.Hq + h) * p.Tq + row * BQ;
      const int krow = (b * p.Hkv + hkv) * p.Tk;
      const int* kd_g = p.kv_doc + (long long)b * p.Tk;
      const int* kp_g = p.kv_pos + (long long)b * p.Tk;
      Cursor cur = walk_start<FLAT>(p, b, row, s0);
      int st = 0, ph = 0;
      bool q_sent = false;
      while (advance_by<FLAT>(p, b, row, s0, cur, BK, BK)) {
        if (!q_sent) {   // only a row with a visit loads its Q tile
          mbar_expect_tx(full_q, BQ * D * 2);
          for (int x = 0; x < BOXES; ++x)
            tma_load(q_s + x * BQ * 128, &tm_q, full_q, WG_BOX * x, qrow);
          q_sent = true;
        }
        mbar_wait(empty + st, ph ^ 1);
        info[st] = 1;
        const int key0 = cur.col * BK;
        unsigned char* ks = ring + 2 * st * TILE;
        int* ms = meta + 2 * st * BK;
        mbar_expect_tx(full_k + st, TILE + 8 * BK);
        for (int x = 0; x < BOXES; ++x)
          tma_load(ks + x * BK * 128, &tm_k, full_k + st, WG_BOX * x,
                   krow + key0);
        bulk_load(ms, kd_g + key0, 4 * BK, full_k + st);
        bulk_load(ms + BK, kp_g + key0, 4 * BK, full_k + st);
        mbar_expect_tx(full_v + st, TILE);
        for (int x = 0; x < BOXES; ++x)
          tma_load(ks + TILE + x * BK * 128, &tm_v, full_v + st, WG_BOX * x,
                   krow + key0);
        if (++st == WG_STAGES) {
          st = 0;
          ph ^= 1;
        }
      }
      mbar_wait(empty + st, ph ^ 1);   // the walk is over: say so
      info[st] = 0;
      mbar_arrive(full_k + st);
    }
  } else {
    // ---- consumers: warpgroup wg owns q rows 64 wg .. 64 wg + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;
    // this thread's two q rows (accumulator rows g and g + 8 of its warp)
    const int r0 = wg * 64 + (warp & 3) * 16 + g, r1 = r0 + 8;
    const long long tok = (long long)b * p.Tq + (long long)row * BQ;
    const int qd0 = p.q_doc[tok + r0], qp0 = p.q_pos[tok + r0];
    const int qd1 = p.q_doc[tok + r1], qp1 = p.q_pos[tok + r1];
    // the warp's 16 rows: one document (>= 0)?  their smallest position
    const int dlo = __reduce_min_sync(0xffffffffu, min(qd0, qd1));
    const int dhi = __reduce_max_sync(0xffffffffu, max(qd0, qd1));
    const int qmin = __reduce_min_sync(0xffffffffu, min(qp0, qp1));
    const bool one_doc = dlo == dhi && dlo >= 0;

    float o[D / 2], s[BK / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    // m: row max of the unscaled scores; l: this thread's share of the sum
    float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;
    const float c2 = p.scale * 1.4426950408889634f;   // scale * log2(e)
    const unsigned char* qa = q_s + wg * 64 * 128;   // this warpgroup's rows
    int st = 0, ph = 0;
    bool q_ready = false;
    for (;;) {
      mbar_wait(full_k + st, ph);
      if (info[st] == 0) break;
      if (!q_ready) {
        mbar_wait(full_q, 0);
        q_ready = true;
      }
      const unsigned char* ks = ring + 2 * st * TILE;
      const int* kd_s = meta + 2 * st * BK;
      const int* kp_s = kd_s + BK;

      // S = Q K^T: D / 16 steps of 16 columns, 4 to a 128-byte box
      wg_hold(s);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int x = kk / 4, off = (kk % 4) * 32;
        wgmma_ss(s, wg_desc(qa + x * BQ * 128 + off, 16, 1024),
                 wg_desc(ks + x * BK * 128 + off, 16, 1024), kk > 0);
      }
      wg_commit();

      // the warp's tile is interior when every key is of the rows' one
      // document at or before their smallest position (read while S runs)
      bool ok = one_doc;
      if (ok) {
#pragma unroll
        for (int k = lane; k < BK; k += 32)
          ok = ok && kd_s[k] == dlo && kp_s[k] <= qmin;
      }
      const bool interior = __all_sync(0xffffffffu, ok);
      wg_wait_all();
      wg_hold(s);

      // mask where needed, online softmax in f32 (rows r0: s[4j + 0..1],
      // r1: s[4j + 2..3]; key 8 j + 2 tq + 0..1) on unscaled scores, as in
      // fwd_mma_kernel: a masked score is -inf, m never drops below NEG
      float mx0 = NEG, mx1 = NEG;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        if (!interior) {
          const int key = 8 * j + 2 * tq;
          const int2 kd = *reinterpret_cast<const int2*>(kd_s + key);
          const int2 kp = *reinterpret_cast<const int2*>(kp_s + key);
          s[4 * j] = visible(qd0, qp0, kd.x, kp.x) ? s[4 * j] : -INFINITY;
          s[4 * j + 1] =
              visible(qd0, qp0, kd.y, kp.y) ? s[4 * j + 1] : -INFINITY;
          s[4 * j + 2] =
              visible(qd1, qp1, kd.x, kp.x) ? s[4 * j + 2] : -INFINITY;
          s[4 * j + 3] =
              visible(qd1, qp1, kd.y, kp.y) ? s[4 * j + 3] : -INFINITY;
        }
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      const float a0 = ex2((m0 - mn0) * c2), a1 = ex2((m1 - mn1) * c2);
      m0 = mn0;
      m1 = mn1;
      const float mc0 = mn0 * c2, mc1 = mn1 * c2;
      float sum0 = 0.f, sum1 = 0.f;
      unsigned pf[BK / 16][4];       // P as A fragments, in V's dtype
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float p0 = ex2(fmaf(s[4 * j], c2, -mc0));
        const float p1 = ex2(fmaf(s[4 * j + 1], c2, -mc0));
        const float p2 = ex2(fmaf(s[4 * j + 2], c2, -mc1));
        const float p3 = ex2(fmaf(s[4 * j + 3], c2, -mc1));
        sum0 += p0 + p1;
        sum1 += p2 + p3;
        pf[j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
        pf[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
      l0 = l0 * a0 + sum0;
      l1 = l1 * a1 + sum1;
      // a max that moved for none of the warp's rows leaves O as it is
      if (!__all_sync(0xffffffffu, a0 == 1.f && a1 == 1.f)) {
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          o[4 * n] *= a0;
          o[4 * n + 1] *= a0;
          o[4 * n + 2] *= a1;
          o[4 * n + 3] *= a1;
        }
      }

      // O += P V: BK / 16 steps of 16 keys (2048 bytes of V each); N = D
      // spans the D / 64 boxes of V, BK x 128 bytes apart
      mbar_wait(full_v + st, ph);
      wg_hold(o);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs(o, pf[kk], wg_desc(ks + TILE + kk * 2048, BK * 128, 1024));
      wg_commit();
      wg_wait_all();
      wg_hold(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + st);   // the stage is free
      if (++st == WG_STAGES) {
        st = 0;
        ph ^= 1;
      }
    }

    // epilogue: o = acc / l (0 where l = 0), lse = m + log l (-inf there)
    const float lt0 = quad_sum(l0), lt1 = quad_sum(l1);
    const long long q0 =
        ((long long)b * p.Hq + h) * p.Tq + (long long)row * BQ;
    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.out0) + q0 * D;
    const float d0 = fmaxf(lt0, 1e-30f), d1 = fmaxf(lt1, 1e-30f);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = 8 * n + 2 * tq;
      *reinterpret_cast<__nv_bfloat162*>(og + (long long)r0 * D + c) =
          lt0 > 0.f ? __floats2bfloat162_rn(o[4 * n] / d0, o[4 * n + 1] / d0)
                    : __floats2bfloat162_rn(0.f, 0.f);
      *reinterpret_cast<__nv_bfloat162*>(og + (long long)r1 * D + c) =
          lt1 > 0.f
              ? __floats2bfloat162_rn(o[4 * n + 2] / d1, o[4 * n + 3] / d1)
              : __floats2bfloat162_rn(0.f, 0.f);
    }
    if (tq == 0) {
      float* lse = static_cast<float*>(p.out1) + q0;
      lse[r0] = lt0 > 0.f ? m0 * p.scale + logf(lt0) : -INFINITY;
      lse[r1] = lt1 > 0.f ? m1 * p.scale + logf(lt1) : -INFINITY;
    }
  }
}

// ------------------------------------------------------------------------
// bf16 dQ on the tensor cores: CTA = (q-block row, b, hq), as
// fwd_mma_kernel, with bq / 16 warps of 16 q rows each.  Replaces
// flash_bwd_dq (doc_attention.py:802, _dq_kernel / _dq_kernel_flat over
// _dq_visit) for bf16.  Bound: operations; S = Q K^T, dP = dO V^T and
// dQ += dS K run as mma.sync m16n8k16 (bf16 in, f32 accumulate).
//
// The forward's streaming design with a second held operand: the Q and
// dO tiles are copied once and held in registers as A fragments, each
// thread keeps its two rows' lse_safe log2(e) and delta, and K, V and
// their keys' doc and pos stream in KT-key sub-tiles through the
// forward's 2-stage cp.async ring (copy_kv), the walk's next table step
// loaded one visit ahead.  Per sub-tile, P = 2^(S scale log2(e) -
// lse_safe log2(e)) where visible (else 0), and dS = P (dP - delta) scale
// is packed to bf16 as the A fragment of dS K in registers: it never
// goes through shared memory.  K's B fragments for dS K come from the
// same ring slot by ldmatrix.trans.  dQ stays f32 in registers for the
// whole walk and is written once in bf16; a row with no visit writes
// zeros.  There is no online max, so any scale works.
//
// Rounding: exactly where the reference rounds.  Q, K, dO and V enter the
// products as bf16, which the reference casts to f32 exactly, and dS is
// rounded to K's dtype before dS K, as the reference does.
// ------------------------------------------------------------------------

// bytes of shared memory of one dq_mma_kernel CTA: the forward's, plus
// the dO tile
__host__ __device__ inline long long dq_mma_smem_bytes(int bq, int D,
                                                       int KT) {
  return mma_smem_bytes(bq, D, KT) + bq * 2LL * mma_pitch(D);
}

template <bool FLAT, int KT>
__global__ void __launch_bounds__(256, 1) dq_mma_kernel(Params p) {
  using bf16 = __nv_bfloat16;
  constexpr int NT = KT / 8;                 // 8-key n-tiles of S and dP
  constexpr int MAXK = MMA_MAX_D / 16;       // 16-wide k-steps of Q K^T
  constexpr int MAXN = MMA_MAX_D / 8;        // 8-wide n-tiles of dQ
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ float4 smem4[];
  const int D = p.D, DP = mma_pitch(D), BQ = p.bq;
  const int NK = D / 16, ND = D / 8;
  bf16* q_s = reinterpret_cast<bf16*>(smem4);          // BQ x DP
  bf16* do_s = q_s + BQ * DP;                          // BQ x DP
  bf16* ring = do_s + BQ * DP;                         // 2 x {K, V}: KT x DP
  int* meta = reinterpret_cast<int*>(ring + 4 * KT * DP);   // 2 x {doc, pos}

  int rest;
  const int i_row = cta_row(p.B * p.Hq, &rest);
  const int b = rest / p.Hq, h = rest - b * p.Hq, hkv = h / p.G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = BQ * 2;
  int s0, row;
  if (!walk_begin<FLAT>(p, b, i_row, &s0, &row)) return;

  const long long q0 = ((long long)b * p.Hq + h) * p.Tq + (long long)row * BQ;
  const long long kv0 = ((long long)b * p.Hkv + hkv) * p.Tk;

  // this thread's two q rows (fragment rows g and g + 8 of its warp): doc,
  // pos, lse_safe log2(e) (lse_safe = 0 where lse is -inf) and delta
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  const long long tok = (long long)b * p.Tq + (long long)row * BQ;
  const int qd0 = p.q_doc[tok + r0], qp0 = p.q_pos[tok + r0];
  const int qd1 = p.q_doc[tok + r1], qp1 = p.q_pos[tok + r1];
  const float x0 = p.lse[q0 + r0], x1 = p.lse[q0 + r1];
  const float l0 = isfinite(x0) ? x0 * LOG2E : 0.f;
  const float l1 = isfinite(x1) ? x1 * LOG2E : 0.f;
  const float dl0 = p.delta[q0 + r0], dl1 = p.delta[q0 + r1];

  Cursor cur = walk_start<FLAT>(p, b, row, s0);
  bool have = advance<FLAT, KT>(p, b, row, s0, cur);
  float dq[MAXN][4];
#pragma unroll
  for (int n = 0; n < MAXN; ++n)
    dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  const float c2 = p.scale * LOG2E;          // scale * log2(e)

  if (have) {
    cp_async_rows(q_s, static_cast<const bf16*>(p.q) + q0 * D, BQ, D, tid,
                  nthreads);
    cp_async_rows(do_s, static_cast<const bf16*>(p.dout) + q0 * D, BQ, D,
                  tid, nthreads);
    copy_kv<KT>(p, b, kv0, ring, meta, cur, 0, tid, nthreads);
    cp_async_commit();
  }
  unsigned qf[MAXK][4], of[MAXK][4];   // this warp's Q and dO rows
  bool first = true;
  int slot = 0;
  while (have) {
    Cursor nxt = cur;
    const bool more = advance<FLAT, KT>(p, b, row, s0, nxt);
    // slot ^ 1 was freed by the last barrier
    if (more)
      copy_kv<KT>(p, b, kv0, ring, meta, nxt, slot ^ 1, tid, nthreads);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (first) {
      load_a(qf, q_s, NK, DP, warp, lane);
      load_a(of, do_s, NK, DP, warp, lane);
      first = false;
    }
    const bf16* ks = ring + slot * 2 * KT * DP;
    const bf16* vs = ks + KT * DP;
    const int* kd_s = meta + slot * 2 * KT;
    const int* kp_s = kd_s + KT;

    float s[NT][4], dp[NT][4];
    mma_abt<KT>(s, qf, ks, NK, DP, lane);    // S = Q K^T
    mma_abt<KT>(dp, of, vs, NK, DP, lane);   // dP = dO V^T

    // P where visible, dS = P (dP - delta) scale as bf16 A fragments
    // (rows r0: [.][0..1], r1: [.][2..3]; keys 8 j + 2 tq, + 1)
    unsigned df[NT / 2][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int key = 8 * j + 2 * tq;
      const int2 kd = *reinterpret_cast<const int2*>(kd_s + key);
      const int2 kp = *reinterpret_cast<const int2*>(kp_s + key);
      const float p0 =
          visible(qd0, qp0, kd.x, kp.x) ? ex2(fmaf(s[j][0], c2, -l0)) : 0.f;
      const float p1 =
          visible(qd0, qp0, kd.y, kp.y) ? ex2(fmaf(s[j][1], c2, -l0)) : 0.f;
      const float p2 =
          visible(qd1, qp1, kd.x, kp.x) ? ex2(fmaf(s[j][2], c2, -l1)) : 0.f;
      const float p3 =
          visible(qd1, qp1, kd.y, kp.y) ? ex2(fmaf(s[j][3], c2, -l1)) : 0.f;
      df[j / 2][(j & 1) * 2] = pack_bf16(p0 * (dp[j][0] - dl0) * p.scale,
                                         p1 * (dp[j][1] - dl0) * p.scale);
      df[j / 2][(j & 1) * 2 + 1] =
          pack_bf16(p2 * (dp[j][2] - dl1) * p.scale,
                    p3 * (dp[j][3] - dl1) * p.scale);
    }
    mma_ab<KT>(dq, df, ks, ND, DP, lane);    // dQ += dS K
    __syncthreads();               // the slot is free for the next copy
    cur = nxt;
    have = more;
    slot ^= 1;
  }
  cp_async_wait<0>();

  // rows r0, r1 of the q block, columns 8 n + 2 tq, + 1 (zeros for a row
  // with no visit)
  bf16* dqg = static_cast<bf16*>(p.out0) + q0 * D;
#pragma unroll
  for (int n = 0; n < MAXN; ++n) {
    if (n < ND) {
      const int c = 8 * n + 2 * tq;
      *reinterpret_cast<__nv_bfloat162*>(dqg + (long long)r0 * D + c) =
          __floats2bfloat162_rn(dq[n][0], dq[n][1]);
      *reinterpret_cast<__nv_bfloat162*>(dqg + (long long)r1 * D + c) =
          __floats2bfloat162_rn(dq[n][2], dq[n][3]);
    }
  }
}

// Per-row backward inputs of one q tile into shared memory: doc, pos,
// lse_safe (0 where lse is -inf) and delta.
__device__ __forceinline__ void stage_rows(const Params& p, int b, int h,
                                           int qblk, int BQ, int tid,
                                           int* qd_s, int* qp_s,
                                           float* lse_s, float* dl_s) {
  const long long tok = (long long)b * p.Tq + (long long)qblk * BQ;
  const long long hr = ((long long)b * p.Hq + h) * p.Tq + (long long)qblk * BQ;
  for (int r = tid; r < BQ; r += THREADS) {
    qd_s[r] = p.q_doc[tok + r];
    qp_s[r] = p.q_pos[tok + r];
    const float x = p.lse[hr + r];
    lse_s[r] = isfinite(x) ? x : 0.f;
    dl_s[r] = p.delta[hr + r];
  }
}

// P and dS of one (q tile x 32-key sub-tile) pair, in registers: rows
// ty + 16 i of q_s/do_s, keys tx + 16 j of k_s/v_s (key metadata in
// kd/kp).  dS = P (dO.V^T - delta) scale.
__device__ __forceinline__ void tile_p_ds(
    const float* q_s, const float* do_s, const float* k_s, const float* v_s,
    const int* qd_s, const int* qp_s, const float* lse_s, const float* dl_s,
    const int (&kd)[2], const int (&kp)[2], float scale, int NI, int ND4,
    int DP, int ty, int tx, float (&pr)[MAXI][2], float (&ds)[MAXI][2]) {
  tile_scores(q_s, k_s, NI, ND4, DP, ty, tx, pr);
  tile_scores(do_s, v_s, NI, ND4, DP, ty, tx, ds);
#pragma unroll
  for (int i = 0; i < MAXI; ++i) {
    if (i < NI) {
      const int r = ty + 16 * i;
      const int qd = qd_s[r], qp = qp_s[r];
      const float ls = lse_s[r], dl = dl_s[r];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float x = pr[i][j] * scale;
        const float pp = visible(qd, qp, kd[j], kp[j]) ? expf(x - ls) : 0.f;
        pr[i][j] = pp;
        ds[i][j] = pp * (ds[i][j] - dl) * scale;
      }
    }
  }
}

// ------------------------------------------------------------------------
// dQ: CTA = (q-block row, b, hq), the forward's tables.  Replaces
// flash_bwd_dq (doc_attention.py:802, _dq_kernel / _dq_kernel_flat).
// Bound: operations, 3 products per visit and head (S, dP, dS.K).
// ------------------------------------------------------------------------
template <typename T, bool FLAT>
__global__ void __launch_bounds__(THREADS, 1) dq_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D = p.D, DP = D + 4, BQ = p.bq, BK = p.bk;
  const int NI = BQ / 16, ND4 = D / 4;
  float* q_s = smem;                    // BQ x DP
  float* do_s = q_s + BQ * DP;          // BQ x DP
  float* k_s = do_s + BQ * DP;          // KT x DP
  float* v_s = k_s + KT * DP;           // KT x DP
  float* ds_s = v_s + KT * DP;          // BQ x PP
  float* lse_s = ds_s + BQ * PP;        // BQ
  float* dl_s = lse_s + BQ;             // BQ
  int* qd_s = reinterpret_cast<int*>(dl_s + BQ);       // BQ
  int* qp_s = qd_s + BQ;
  int* kd_s = qp_s + BQ;                // KT
  int* kp_s = kd_s + KT;

  int rest;
  const int i_row = cta_row(p.B * p.Hq, &rest);
  const int b = rest / p.Hq, h = rest - b * p.Hq, hkv = h / p.G;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  int s0, row;
  if (!walk_begin<FLAT>(p, b, i_row, &s0, &row)) return;

  const long long q0 = ((long long)b * p.Hq + h) * p.Tq + (long long)row * BQ;
  stage<T>(static_cast<const T*>(p.q) + q0 * D, q_s, BQ, D, DP, tid);
  stage<T>(static_cast<const T*>(p.dout) + q0 * D, do_s, BQ, D, DP, tid);
  stage_rows(p, b, h, row, BQ, tid, qd_s, qp_s, lse_s, dl_s);
  float4 acc[MAXI][2];
#pragma unroll
  for (int i = 0; i < MAXI; ++i)
    acc[i][0] = acc[i][1] = make_float4(0.f, 0.f, 0.f, 0.f);
  const long long kv0 = ((long long)b * p.Hkv + hkv) * p.Tk;
  const T* kg = static_cast<const T*>(p.k);
  const T* vg = static_cast<const T*>(p.v);
  __syncthreads();

  int col, flags;
  for (int t = 0; walk_step<FLAT>(p, b, row, s0, t, &col, &flags); ++t) {
    if (flags & FLAG_VALID) {
      for (int kt = 0; kt < BK; kt += KT) {
        const long long key0 = (long long)col * BK + kt;
        stage<T>(kg + (kv0 + key0) * D, k_s, KT, D, DP, tid);
        stage<T>(vg + (kv0 + key0) * D, v_s, KT, D, DP, tid);
        if (tid < KT) {
          kd_s[tid] = p.kv_doc[(long long)b * p.Tk + key0 + tid];
          kp_s[tid] = p.kv_pos[(long long)b * p.Tk + key0 + tid];
        }
        __syncthreads();
        const int kd[2] = {kd_s[tx], kd_s[tx + 16]};
        const int kp[2] = {kp_s[tx], kp_s[tx + 16]};
        float pr[MAXI][2], ds[MAXI][2];
        tile_p_ds(q_s, do_s, k_s, v_s, qd_s, qp_s, lse_s, dl_s, kd, kp,
                  p.scale, NI, ND4, DP, ty, tx, pr, ds);
#pragma unroll
        for (int i = 0; i < MAXI; ++i) {
          if (i < NI) {
            const int r = ty + 16 * i;
            ds_s[r * PP + tx] = round_to<T>(ds[i][0]);   // dS in K's dtype
            ds_s[r * PP + tx + 16] = round_to<T>(ds[i][1]);
          }
        }
        __syncthreads();
        tile_accum(ds_s, k_s, NI, ND4, DP, ty, tx, acc);
        __syncthreads();
      }
    }
    if (flags & FLAG_LAST) break;
  }

  T* dq = static_cast<T*>(p.out0) + q0 * D;
#pragma unroll
  for (int i = 0; i < MAXI; ++i) {
    if (i < NI) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int d4 = tx + 16 * j;
        if (d4 < ND4) {
          T* dst = dq + (long long)r * D + 4 * d4;
          dst[0] = from_f<T>(acc[i][j].x);
          dst[1] = from_f<T>(acc[i][j].y);
          dst[2] = from_f<T>(acc[i][j].z);
          dst[3] = from_f<T>(acc[i][j].w);
        }
      }
    }
  }
}

// ------------------------------------------------------------------------
// dK, dV: CTA = (kv-block row, b, hkv, 32-key sub-tile), reverse tables.
// Replaces flash_bwd_dkv (doc_attention.py:967, _dkv_kernel /
// _dkv_kernel_flat).  Bound: operations, 4 products per visit and head
// (S, dP, P^T dO, dS^T Q); q and dO are re-staged per head of the group.
// ------------------------------------------------------------------------
template <typename T, bool FLAT>
__global__ void __launch_bounds__(THREADS, 1) dkv_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D = p.D, DP = D + 4, BQ = p.bq, BK = p.bk;
  const int NI = BQ / 16, ND4 = D / 4, NSUB = BK / KT;
  float* q_s = smem;                    // BQ x DP
  float* do_s = q_s + BQ * DP;          // BQ x DP
  float* k_s = do_s + BQ * DP;          // KT x DP
  float* v_s = k_s + KT * DP;           // KT x DP
  float* p_s = v_s + KT * DP;           // BQ x PP
  float* ds_s = p_s + BQ * PP;          // BQ x PP
  float* lse_s = ds_s + BQ * PP;        // BQ
  float* dl_s = lse_s + BQ;             // BQ
  int* qd_s = reinterpret_cast<int*>(dl_s + BQ);       // BQ
  int* qp_s = qd_s + BQ;

  int rest;
  const int i_row = cta_row(p.B * p.Hkv * NSUB, &rest);
  const int b = rest / (p.Hkv * NSUB);
  rest -= b * p.Hkv * NSUB;
  const int hkv = rest / NSUB, sub = rest - hkv * NSUB;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  int s0, row;
  if (!walk_begin<FLAT>(p, b, i_row, &s0, &row)) return;

  // this CTA's keys: [key0, key0 + KT) of kv block `row`
  const long long key0 = (long long)row * BK + (long long)sub * KT;
  const long long k0 = ((long long)b * p.Hkv + hkv) * p.Tk + key0;
  stage<T>(static_cast<const T*>(p.k) + k0 * D, k_s, KT, D, DP, tid);
  stage<T>(static_cast<const T*>(p.v) + k0 * D, v_s, KT, D, DP, tid);
  const int kd[2] = {p.kv_doc[(long long)b * p.Tk + key0 + tx],
                     p.kv_doc[(long long)b * p.Tk + key0 + tx + 16]};
  const int kp[2] = {p.kv_pos[(long long)b * p.Tk + key0 + tx],
                     p.kv_pos[(long long)b * p.Tk + key0 + tx + 16]};
  // accumulators: keys ty + 16 i (i < 2), columns 4 (tx + 16 j) .. + 3
  float4 dk[2][2], dv[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    dk[i][0] = dk[i][1] = dv[i][0] = dv[i][1] = make_float4(0.f, 0.f, 0.f, 0.f);
  const bool has0 = tx < ND4, has1 = tx + 16 < ND4;
  const T* qg = static_cast<const T*>(p.q);
  const T* dog = static_cast<const T*>(p.dout);

  int col, flags;
  for (int t = 0; walk_step<FLAT>(p, b, row, s0, t, &col, &flags); ++t) {
    if (flags & FLAG_VALID) {
      for (int g = 0; g < p.G; ++g) {
        const int h = hkv * p.G + g;
        const long long q0 =
            ((long long)b * p.Hq + h) * p.Tq + (long long)col * BQ;
        __syncthreads();   // the previous pass is done with the tiles
        stage<T>(qg + q0 * D, q_s, BQ, D, DP, tid);
        stage<T>(dog + q0 * D, do_s, BQ, D, DP, tid);
        stage_rows(p, b, h, col, BQ, tid, qd_s, qp_s, lse_s, dl_s);
        __syncthreads();
        float pr[MAXI][2], ds[MAXI][2];
        tile_p_ds(q_s, do_s, k_s, v_s, qd_s, qp_s, lse_s, dl_s, kd, kp,
                  p.scale, NI, ND4, DP, ty, tx, pr, ds);
#pragma unroll
        for (int i = 0; i < MAXI; ++i) {
          if (i < NI) {
            const int r = ty + 16 * i;
            p_s[r * PP + tx] = pr[i][0];
            p_s[r * PP + tx + 16] = pr[i][1];
            ds_s[r * PP + tx] = ds[i][0];
            ds_s[r * PP + tx + 16] = ds[i][1];
          }
        }
        __syncthreads();
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int r = 0; r < BQ; ++r) {
          const float4 o0 = has0 ? ld4(do_s + r * DP + 4 * tx) : z;
          const float4 o1 = has1 ? ld4(do_s + r * DP + 4 * (tx + 16)) : z;
          const float4 x0 = has0 ? ld4(q_s + r * DP + 4 * tx) : z;
          const float4 x1 = has1 ? ld4(q_s + r * DP + 4 * (tx + 16)) : z;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float pk = p_s[r * PP + ty + 16 * i];
            const float dsk = ds_s[r * PP + ty + 16 * i];
            fma4(pk, o0, dv[i][0]);
            fma4(pk, o1, dv[i][1]);
            fma4(dsk, x0, dk[i][0]);
            fma4(dsk, x1, dk[i][1]);
          }
        }
      }
    }
    if (flags & FLAG_LAST) break;
  }

  T* dkg = static_cast<T*>(p.out0) + k0 * D;
  T* dvg = static_cast<T*>(p.out1) + k0 * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int d4 = tx + 16 * j;
      if (d4 < ND4) {
        T* a = dkg + (long long)r * D + 4 * d4;
        T* c = dvg + (long long)r * D + 4 * d4;
        a[0] = from_f<T>(dk[i][j].x);
        a[1] = from_f<T>(dk[i][j].y);
        a[2] = from_f<T>(dk[i][j].z);
        a[3] = from_f<T>(dk[i][j].w);
        c[0] = from_f<T>(dv[i][j].x);
        c[1] = from_f<T>(dv[i][j].y);
        c[2] = from_f<T>(dv[i][j].z);
        c[3] = from_f<T>(dv[i][j].w);
      }
    }
  }
}

// ------------------------------------------------------------------------
// bf16 dK, dV on the tensor cores: CTA = (kv-block row, b, hkv, group
// slice, key part), reverse tables.  Replaces flash_bwd_dkv
// (doc_attention.py:967) for bf16.  Bound: operations; S^T = K Q^T,
// dP^T = V dO^T, dV += P^T dO and dK += dS^T Q run as mma.sync m16n8k16
// (bf16 in, f32 accumulate).
//
// A warp owns 16 keys (the M dimension of all four products), so P^T and
// dS^T come out in accumulator layout and become the A fragments of the
// dV and dK products in registers, as P does in fwd_mma_kernel; Q and dO
// are B operands (ldmatrix for S^T / dP^T, ldmatrix.trans for dK / dV).
// K and V of the CTA's keys are copied once.  The walk is a stream of
// units, (visit, head of the slice, QC-row chunk of the q block), whose Q,
// dO and per-row doc, pos, lse and delta flow through a DKV_STAGES-deep
// cp.async ring, the next unit in flight while one is computed; one
// barrier per unit.  dK and dV stay in f32 registers for the whole walk
// and are written once: in bf16 when the group is one slice, else as f32
// slice partial that dkv_sum_kernel adds up in slice order (no atomics).
// A block row splits into `parts` key ranges and the group into `slices`
// so that a row with many more visits than the mean does not set the
// kernel's time alone; the wrapper picks both from shapes only.  CTAs
// are numbered row ordinal outermost, so the flat queue's LPT order is
// the launch order.
//
// Rounding: none beyond the reference's.  P^T and dS^T enter the dV and
// dK products as a hi + lo pair of bf16 A fragments (hi = bf16(x), lo =
// bf16(x - hi)), two mma.sync into one f32 accumulator; dO and Q are bf16
// inputs and exact as B operands, so each product matches the reference's
// f32 one to about 2^-16 relative.  The S^T and dP^T products are as in
// the forward.
// ------------------------------------------------------------------------
constexpr int DKV_STAGES = 2;

// bf16 elements of one ring stage: Q and dO (QC x pitch), then the rows'
// doc, pos, lse and delta (4 x QC words)
__host__ __device__ inline int dkv_stage_elems(int D, int QC) {
  return 2 * QC * mma_pitch(D) + 8 * QC;
}

// bytes of shared memory of one dkv_mma_kernel CTA: K and V of its keys,
// then the ring
__host__ __device__ inline long long dkv_mma_smem_bytes(int keys, int D,
                                                        int QC) {
  return 2LL * (2LL * keys * mma_pitch(D) +
                (long long)DKV_STAGES * dkv_stage_elems(D, QC));
}

template <bool FLAT, int QC>
__global__ void __launch_bounds__(256, 1) dkv_mma_kernel(Params p) {
  using bf16 = __nv_bfloat16;
  constexpr int NT = QC / 8;                 // 8-query n-tiles of S^T
  constexpr int KC = QC / 16;                // 16-query k-chunks of dK, dV
  constexpr int MAXK = MMA_MAX_D / 16;       // 16-wide k-steps of K Q^T
  constexpr int MAXN = MMA_MAX_D / 8;        // 8-wide n-tiles of dK, dV
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ float4 smem4[];
  const int D = p.D, DP = mma_pitch(D), NK = D / 16, ND = D / 8;
  const int KEYS = p.bk / p.parts, nthreads = 2 * KEYS;
  const int SE = dkv_stage_elems(D, QC);
  bf16* k_s = reinterpret_cast<bf16*>(smem4);          // KEYS x DP
  bf16* v_s = k_s + KEYS * DP;                         // KEYS x DP
  bf16* ring = v_s + KEYS * DP;                        // DKV_STAGES x SE

  int rest;
  const int i_row = cta_row(p.B * p.Hkv * p.slices * p.parts, &rest);
  const int part = rest % p.parts;
  rest /= p.parts;
  const int slice = rest % p.slices;
  rest /= p.slices;
  const int hkv = rest % p.Hkv, b = rest / p.Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int s0, row;
  if (!walk_begin<FLAT>(p, b, i_row, &s0, &row)) return;

  // this slice's heads g0 .. g0 + ng - 1; units per visit: head x chunk
  const int gps = (p.G + p.slices - 1) / p.slices;
  const int g0 = slice * gps, ng = max(0, min(p.G, g0 + gps) - g0);
  const int CH = p.bq / QC, n_units = ng * CH;
  // this CTA's keys: [key0, key0 + KEYS) of kv block `row`
  const long long key0 = (long long)row * p.bk + (long long)part * KEYS;
  const long long k0 = ((long long)b * p.Hkv + hkv) * p.Tk + key0;
  // this thread's two keys (fragment rows g and g + 8 of its warp)
  const int g = lane >> 2, tq = lane & 3;
  const long long kt = (long long)b * p.Tk + key0 + warp * 16 + g;
  const int kd0 = p.kv_doc[kt], kp0 = p.kv_pos[kt];
  const int kd1 = p.kv_doc[kt + 8], kp1 = p.kv_pos[kt + 8];

  const bf16* qg = static_cast<const bf16*>(p.q);
  const bf16* dog = static_cast<const bf16*>(p.dout);
  const int vecs = D / 8;                    // 16-byte chunks per row
  // copy unit c.kt (head g0 + kt / CH, chunk kt % CH) of visit c.col into
  // ring slot `slot`
  auto issue = [&](const Cursor& c, int slot) {
    const int h = hkv * p.G + g0 + c.kt / CH;
    const long long r0 = (long long)c.col * p.bq + (c.kt % CH) * QC;
    const long long hr = ((long long)b * p.Hq + h) * p.Tq + r0;
    const long long tok = (long long)b * p.Tq + r0;
    bf16* qs = ring + slot * SE;
    bf16* os = qs + QC * DP;
    int* ms = reinterpret_cast<int*>(os + QC * DP);
    for (int i = tid; i < QC * vecs; i += nthreads) {
      const int r = i / vecs, col = (i - r * vecs) * 8;
      cp_async16(qs + r * DP + col, qg + (hr + r) * D + col);
      cp_async16(os + r * DP + col, dog + (hr + r) * D + col);
    }
    for (int i = tid; i < 4 * QC; i += nthreads) {
      const int a = i / QC, r = i - a * QC;
      const void* src = a == 0 ? static_cast<const void*>(p.q_doc + tok + r)
                        : a == 1 ? static_cast<const void*>(p.q_pos + tok + r)
                        : a == 2 ? static_cast<const void*>(p.lse + hr + r)
                                 : static_cast<const void*>(p.delta + hr + r);
      cp_async4(ms + i, src);
    }
  };

  float dk[MAXN][4], dv[MAXN][4];
#pragma unroll
  for (int n = 0; n < MAXN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  Cursor ahead = walk_start<FLAT>(p, b, row, s0);
  int issued = 0;
  if (n_units > 0) {
    // K and V of the CTA's keys join the first unit's commit group
    const bf16* kg = static_cast<const bf16*>(p.k);
    const bf16* vg = static_cast<const bf16*>(p.v);
    for (int i = tid; i < KEYS * vecs; i += nthreads) {
      const int r = i / vecs, col = (i - r * vecs) * 8;
      cp_async16(k_s + r * DP + col, kg + (k0 + r) * D + col);
      cp_async16(v_s + r * DP + col, vg + (k0 + r) * D + col);
    }
#pragma unroll
    for (int s = 0; s < DKV_STAGES - 1; ++s) {
      if (advance_by<FLAT>(p, b, row, s0, ahead, 1, n_units)) {
        issue(ahead, s);
        ++issued;
      }
      cp_async_commit();
    }
  }
  const float c2 = p.scale * LOG2E;          // scale * log2(e)
  const bf16* kw = k_s + warp * 16 * DP;     // this warp's keys
  const bf16* vw = v_s + warp * 16 * DP;
  for (int j = 0; j < issued; ++j) {
    cp_async_wait<DKV_STAGES - 2>();   // unit j has landed (this thread's part)
    __syncthreads();                   // ... everyone's; slot j - 1 is free
    if (advance_by<FLAT>(p, b, row, s0, ahead, 1, n_units)) {
      issue(ahead, (j + DKV_STAGES - 1) % DKV_STAGES);
      ++issued;
    }
    cp_async_commit();
    const bf16* qs = ring + (j % DKV_STAGES) * SE;
    const bf16* os = qs + QC * DP;
    const int* qd_s = reinterpret_cast<const int*>(os + QC * DP);
    const int* qp_s = qd_s + QC;
    const float* ls_s = reinterpret_cast<const float*>(qp_s + QC);
    const float* dl_s = ls_s + QC;

    // S^T = K Q^T and dP^T = V dO^T: n-tiles i, i + 1 of queries per
    // ldmatrix.x4
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < MAXK; ++kk) {
      if (kk < NK) {
        unsigned kf[4], vf[4];
        const int a_off = (lane & 15) * DP + kk * 16 + (lane >> 4) * 8;
        ldsm_x4(kf, kw + a_off);
        ldsm_x4(vf, vw + a_off);
#pragma unroll
        for (int i = 0; i < NT; i += 2) {
          unsigned qf[4], of[4];
          const int b_off = (8 * i + (lane & 7) + (lane >> 4) * 8) * DP +
                            kk * 16 + ((lane >> 3) & 1) * 8;
          ldsm_x4(qf, qs + b_off);
          ldsm_x4(of, os + b_off);
          mma_bf16(s[i], kf, qf[0], qf[1]);
          mma_bf16(s[i + 1], kf, qf[2], qf[3]);
          mma_bf16(dp[i], vf, of[0], of[1]);
          mma_bf16(dp[i + 1], vf, of[2], of[3]);
        }
      }
    }

    // P = exp(S scale - lse_safe) where visible, dS = P (dP - delta) scale
    // (keys g: [.][0..1], g + 8: [.][2..3]; queries 8 i + 2 tq, + 1), as
    // hi + lo pairs of bf16 A fragments of the dV and dK products
    unsigned pf[KC][4], pl[KC][4], df[KC][4], dl_f[KC][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int qr = 8 * i + 2 * tq;
      const int2 qd = *reinterpret_cast<const int2*>(qd_s + qr);
      const int2 qp = *reinterpret_cast<const int2*>(qp_s + qr);
      const float2 ls = *reinterpret_cast<const float2*>(ls_s + qr);
      const float2 dl = *reinterpret_cast<const float2*>(dl_s + qr);
      const float l0 = isfinite(ls.x) ? ls.x * LOG2E : 0.f;
      const float l1 = isfinite(ls.y) ? ls.y * LOG2E : 0.f;
      const float p0 =
          visible(qd.x, qp.x, kd0, kp0) ? ex2(fmaf(s[i][0], c2, -l0)) : 0.f;
      const float p1 =
          visible(qd.y, qp.y, kd0, kp0) ? ex2(fmaf(s[i][1], c2, -l1)) : 0.f;
      const float p2 =
          visible(qd.x, qp.x, kd1, kp1) ? ex2(fmaf(s[i][2], c2, -l0)) : 0.f;
      const float p3 =
          visible(qd.y, qp.y, kd1, kp1) ? ex2(fmaf(s[i][3], c2, -l1)) : 0.f;
      const int f = i / 2, e = (i & 1) * 2;
      pack_bf16_split(p0, p1, pf[f][e], pl[f][e]);
      pack_bf16_split(p2, p3, pf[f][e + 1], pl[f][e + 1]);
      pack_bf16_split(p0 * (dp[i][0] - dl.x) * p.scale,
                      p1 * (dp[i][1] - dl.y) * p.scale, df[f][e],
                      dl_f[f][e]);
      pack_bf16_split(p2 * (dp[i][2] - dl.x) * p.scale,
                      p3 * (dp[i][3] - dl.y) * p.scale, df[f][e + 1],
                      dl_f[f][e + 1]);
    }

    // dV += P^T dO, dK += dS^T Q: dO^T and Q^T fragments by
    // ldmatrix.trans, n-tiles n, n + 1 of D
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int n = 0; n < MAXN; n += 2) {
        if (n < ND) {
          unsigned of[4], qf[4];
          const int t_off =
              (16 * kc + (lane & 7) + ((lane >> 3) & 1) * 8) * DP + 8 * n +
              (lane >> 4) * 8;
          ldsm_x4_t(of, os + t_off);
          ldsm_x4_t(qf, qs + t_off);
          mma_bf16(dv[n], pf[kc], of[0], of[1]);
          mma_bf16(dv[n], pl[kc], of[0], of[1]);
          mma_bf16(dv[n + 1], pf[kc], of[2], of[3]);
          mma_bf16(dv[n + 1], pl[kc], of[2], of[3]);
          mma_bf16(dk[n], df[kc], qf[0], qf[1]);
          mma_bf16(dk[n], dl_f[kc], qf[0], qf[1]);
          mma_bf16(dk[n + 1], df[kc], qf[2], qf[3]);
          mma_bf16(dk[n + 1], dl_f[kc], qf[2], qf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // rows k0 + warp * 16 + g and + 8 of (B, Hkv, Tk, D), columns 8 n + 2 tq
  const long long r0 = k0 + warp * 16 + g;
  if (p.slices == 1) {
    bf16* dkg = static_cast<bf16*>(p.out0);
    bf16* dvg = static_cast<bf16*>(p.out1);
#pragma unroll
    for (int n = 0; n < MAXN; ++n) {
      if (n < ND) {
        const long long o0 = r0 * D + 8 * n + 2 * tq, o1 = o0 + 8LL * D;
        *reinterpret_cast<__nv_bfloat162*>(dkg + o0) =
            __floats2bfloat162_rn(dk[n][0], dk[n][1]);
        *reinterpret_cast<__nv_bfloat162*>(dkg + o1) =
            __floats2bfloat162_rn(dk[n][2], dk[n][3]);
        *reinterpret_cast<__nv_bfloat162*>(dvg + o0) =
            __floats2bfloat162_rn(dv[n][0], dv[n][1]);
        *reinterpret_cast<__nv_bfloat162*>(dvg + o1) =
            __floats2bfloat162_rn(dv[n][2], dv[n][3]);
      }
    }
  } else {
    const long long N = (long long)p.B * p.Hkv * p.Tk * D;
    float* wk = p.ws + slice * N;
    float* wv = p.ws + (p.slices + slice) * N;
#pragma unroll
    for (int n = 0; n < MAXN; ++n) {
      if (n < ND) {
        const long long o0 = r0 * D + 8 * n + 2 * tq, o1 = o0 + 8LL * D;
        *reinterpret_cast<float2*>(wk + o0) = make_float2(dk[n][0], dk[n][1]);
        *reinterpret_cast<float2*>(wk + o1) = make_float2(dk[n][2], dk[n][3]);
        *reinterpret_cast<float2*>(wv + o0) = make_float2(dv[n][0], dv[n][1]);
        *reinterpret_cast<float2*>(wv + o1) = make_float2(dv[n][2], dv[n][3]);
      }
    }
  }
}

// dK, dV in bf16 from the f32 slice partials of dkv_mma_kernel: the
// slices summed in order, four elements per thread
__global__ void __launch_bounds__(256)
    dkv_sum_kernel(const float* ws, __nv_bfloat16* dk, __nv_bfloat16* dv,
                   long long n4, int slices) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < 2 * n4; i += stride) {
    const int which = i >= n4 ? 1 : 0;       // 0: dK, 1: dV
    const long long e = i - which * n4;
    const float4* src =
        reinterpret_cast<const float4*>(ws) + which * slices * n4 + e;
    float4 a = src[0];
    for (int s = 1; s < slices; ++s) {
      const float4 x = src[s * n4];
      a.x += x.x;
      a.y += x.y;
      a.z += x.z;
      a.w += x.w;
    }
    __nv_bfloat162* dst =
        reinterpret_cast<__nv_bfloat162*>(which ? dv : dk) + 2 * e;
    dst[0] = __floats2bfloat162_rn(a.x, a.y);
    dst[1] = __floats2bfloat162_rn(a.z, a.w);
  }
}

template <typename K>
int launch(K kernel, const Params& p, long long blocks, int threads,
           size_t smem, cudaStream_t stream) {
  if (smem > STATIC_SMEM_LIMIT) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (blocks > 0) kernel<<<(unsigned)blocks, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, const int* q_doc, const int* q_pos,
                   const int* kv_doc, const int* kv_pos, const int* t0,
                   const int* t1, const int* t2, const int* starts,
                   const float* lse, const float* delta, void* out0,
                   void* out1, int B, int Hq, int Hkv, int Tq, int Tk, int D,
                   int bq, int bk, int rows, int width, float scale) {
  Params p{};
  p.q = q; p.k = k; p.v = v; p.dout = dout;
  p.q_doc = q_doc; p.q_pos = q_pos; p.kv_doc = kv_doc; p.kv_pos = kv_pos;
  p.t0 = t0; p.t1 = t1; p.t2 = t2; p.starts = starts;
  p.lse = lse; p.delta = delta; p.out0 = out0; p.out1 = out1;
  p.B = B; p.Hq = Hq; p.Hkv = Hkv; p.G = Hkv > 0 ? Hq / Hkv : 0;
  p.Tq = Tq; p.Tk = Tk; p.D = D; p.bq = bq; p.bk = bk;
  p.R = rows; p.W = width; p.scale = scale;
  p.parts = 1; p.slices = 1; p.ws = nullptr; p.key_tile = 32;
  return p;
}

using Kernel = void (*)(Params);

// keys per sub-tile of the bf16 forward (64 where block_k allows, else
// 32) and of the bf16 dQ (p.key_tile where block_k allows, else 32)
int fwd_key_tile(const Params& p) { return p.bk % 64 == 0 ? 64 : 32; }
int dq_key_tile(const Params& p) {
  return p.key_tile == 64 && p.bk % 64 == 0 ? 64 : 32;
}
// q rows per unit of the bf16 dK, dV: 32 where block_q allows, else 16
int dkv_rows(const Params& p) { return p.bq % 32 == 0 ? 32 : 16; }

// shared-memory bytes of the CTA that dispatch() launches for (kind,
// dtype): kind 0 = fwd, 1 = dq, 2 = dkv, 3 = fwd on wgmma (bf16 only);
// dtype 0 = f32 (the scalar kernels), 1 = bf16 (the tensor-core kernels)
long long smem_bytes(const Params& p, int kind, int dtype) {
  if (dtype == 1) {
    if (kind == 3) return wgmma_smem_bytes(p.bq, p.bk, p.D);
    if (kind == 0) return mma_smem_bytes(p.bq, p.D, fwd_key_tile(p));
    if (kind == 1) return dq_mma_smem_bytes(p.bq, p.D, dq_key_tile(p));
    return dkv_mma_smem_bytes(p.bk / std::max(p.parts, 1), p.D, dkv_rows(p));
  }
  const long long DP = p.D + 4, bq = p.bq;
  long long floats, ints;
  if (kind == 0) {
    floats = bq * DP + 2LL * KT * DP + bq * PP;
    ints = 2LL * bq + 2LL * KT;
  } else if (kind == 1) {
    floats = 2LL * bq * DP + 2LL * KT * DP + bq * PP + 2LL * bq;
    ints = 2LL * bq + 2LL * KT;
  } else {
    floats = 2LL * bq * DP + 2LL * KT * DP + 2LL * bq * PP + 2LL * bq;
    ints = 2LL * bq;
  }
  return 4 * (floats + ints);
}

// the bf16 forward
int launch_fwd_mma(const Params& p, long long blocks, int flat,
                   cudaStream_t s) {
  if (p.D % 16 || p.D > MMA_MAX_D || !(p.scale > 0.f))
    return (int)cudaErrorInvalidValue;
  const bool k64 = fwd_key_tile(p) == 64;
  Kernel k = k64 ? (flat ? fwd_mma_kernel<true, 64> : fwd_mma_kernel<false, 64>)
                 : (flat ? fwd_mma_kernel<true, 32> : fwd_mma_kernel<false, 32>);
  return launch(k, p, blocks, 2 * p.bq, (size_t)smem_bytes(p, 0, 1), s);
}

// the shapes fwd_wgmma_kernel takes (the wrapper's rule picks it for them)
bool wgmma_shape_ok(int bq, int bk, int D) {
  return (bq == 64 || bq == 128) && (bk == 64 || bk == 128) &&
         (D == 64 || D == 128);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (libcuda), found through the runtime's entry-point
// query, so the library links no -lcuda
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q{};
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// a (rows x D) bf16 matrix as boxes of (box_rows x 64), 128-byte swizzle
bool tile_map(CUtensorMap* map, const void* base, long long rows, int D,
              int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t box[2] = {(cuuint32_t)WG_BOX, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(base), dims, strides, box, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* x) {
  return (reinterpret_cast<uintptr_t>(x) & 15) == 0;
}

using WgmmaKernel = void (*)(CUtensorMap, CUtensorMap, CUtensorMap, Params);

template <bool FLAT>
WgmmaKernel wgmma_kernel(int bk, int D) {
  if (bk == 64)
    return D == 64 ? fwd_wgmma_kernel<FLAT, 64, 64>
                   : fwd_wgmma_kernel<FLAT, 64, 128>;
  return D == 64 ? fwd_wgmma_kernel<FLAT, 128, 64>
                 : fwd_wgmma_kernel<FLAT, 128, 128>;
}

// the bf16 forward on wgmma: the tensor maps of q, k and v built here,
// at each launch
int launch_fwd_wgmma(const Params& p, long long blocks, int flat,
                     cudaStream_t s) {
  if (!wgmma_shape_ok(p.bq, p.bk, p.D) || !(p.scale > 0.f) ||
      !aligned16(p.q) || !aligned16(p.k) || !aligned16(p.v) ||
      !aligned16(p.kv_doc) || !aligned16(p.kv_pos))
    return (int)cudaErrorInvalidValue;
  if (blocks == 0) return (int)cudaGetLastError();
  // TMA coordinates are 32-bit
  if ((long long)p.B * p.Hq * p.Tq > INT_MAX ||
      (long long)p.B * p.Hkv * p.Tk > INT_MAX)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  if (!tile_map(&mq, p.q, (long long)p.B * p.Hq * p.Tq, p.D, p.bq) ||
      !tile_map(&mk, p.k, (long long)p.B * p.Hkv * p.Tk, p.D, p.bk) ||
      !tile_map(&mv, p.v, (long long)p.B * p.Hkv * p.Tk, p.D, p.bk))
    return (int)cudaErrorInvalidValue;
  const WgmmaKernel k =
      flat ? wgmma_kernel<true>(p.bk, p.D) : wgmma_kernel<false>(p.bk, p.D);
  const int smem = (int)wgmma_smem_bytes(p.bq, p.bk, p.D);
  const cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  k<<<(unsigned)blocks, WG_THREADS * (p.bq / 64 + 1), smem, s>>>(mq, mk, mv,
                                                                  p);
  return (int)cudaGetLastError();
}

// the bf16 dQ
int launch_dq_mma(const Params& p, long long blocks, int flat,
                  cudaStream_t s) {
  if (p.D % 16 || p.D > MMA_MAX_D) return (int)cudaErrorInvalidValue;
  const bool k64 = dq_key_tile(p) == 64;
  Kernel k = k64 ? (flat ? dq_mma_kernel<true, 64> : dq_mma_kernel<false, 64>)
                 : (flat ? dq_mma_kernel<true, 32> : dq_mma_kernel<false, 32>);
  return launch(k, p, blocks, 2 * p.bq, (size_t)smem_bytes(p, 1, 1), s);
}

// the bf16 dK, dV; then, with more than one group slice, the slice sum
int launch_dkv_mma(const Params& p, int flat, cudaStream_t s) {
  if (p.D % 16 || p.D > MMA_MAX_D || p.parts <= 0 ||
      p.bk % (16 * p.parts) || p.slices <= 0 ||
      (p.slices > 1 && p.ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const int keys = p.bk / p.parts;
  const bool q32 = dkv_rows(p) == 32;
  Kernel k = q32 ? (flat ? dkv_mma_kernel<true, 32> : dkv_mma_kernel<false, 32>)
                 : (flat ? dkv_mma_kernel<true, 16> : dkv_mma_kernel<false, 16>);
  const long long blocks = (long long)p.R * p.B * p.Hkv * p.slices * p.parts;
  const int e = launch(k, p, blocks, 2 * keys, (size_t)smem_bytes(p, 2, 1), s);
  if (e != 0 || p.slices == 1) return e;
  const long long n4 = (long long)p.B * p.Hkv * p.Tk * p.D / 4;
  const long long grid = std::min<long long>((2 * n4 + 255) / 256, 132 * 8);
  if (grid > 0)
    dkv_sum_kernel<<<(unsigned)grid, 256, 0, s>>>(
        p.ws, static_cast<__nv_bfloat16*>(p.out0),
        static_cast<__nv_bfloat16*>(p.out1), n4, p.slices);
  return (int)cudaGetLastError();
}

// bf16: fwd_wgmma_kernel (kind 3) or fwd_mma_kernel, dq_mma_kernel,
// dkv_mma_kernel; f32: fwd_kernel, dq_kernel, dkv_kernel (the scalar
// parity references)
int dispatch(const Params& p, int kind, long long blocks, int flat, int dtype,
             cudaStream_t s) {
  if (dtype == 1) {
    if (kind == 3) return launch_fwd_wgmma(p, blocks, flat, s);
    if (kind == 0) return launch_fwd_mma(p, blocks, flat, s);
    if (kind == 1) return launch_dq_mma(p, blocks, flat, s);
    if (kind == 2) return launch_dkv_mma(p, flat, s);
    return (int)cudaErrorInvalidValue;
  }
  Kernel k = nullptr;
  if (kind == 0 && dtype == 0)
    k = flat ? fwd_kernel<float, true> : fwd_kernel<float, false>;
  else if (kind == 1 && dtype == 0)
    k = flat ? dq_kernel<float, true> : dq_kernel<float, false>;
  else if (kind == 2 && dtype == 0)
    k = flat ? dkv_kernel<float, true> : dkv_kernel<float, false>;
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  return launch(k, p, blocks, THREADS, (size_t)smem_bytes(p, kind, dtype), s);
}

bool shapes_ok(int Hq, int Hkv, int D, int bq, int bk) {
  return Hkv > 0 && Hq % Hkv == 0 && D > 0 && D <= 128 && D % 4 == 0 &&
         bq >= 16 && bq <= 16 * MAXI && bq % 16 == 0 && bk >= KT &&
         bk <= 128 && bk % KT == 0;
}

}  // namespace

#define DOC_ATTN_ARGS                                                        \
  const void *q, const void *k, const void *v, const void *dout,             \
      const int *q_doc, const int *q_pos, const int *kv_doc,                 \
      const int *kv_pos, const int *t0, const int *t1, const int *t2,        \
      const int *starts, const float *lse, const float *delta, void *out0,   \
      void *out1, int B, int Hq, int Hkv, int Tq, int Tk, int D, int bq,     \
      int bk, int rows, int width, int flat, float scale, int dtype,         \
      void *stream

#define DOC_ATTN_PARAMS                                                      \
  make_params(q, k, v, dout, q_doc, q_pos, kv_doc, kv_pos, t0, t1, t2,       \
              starts, lse, delta, out0, out1, B, Hq, Hkv, Tq, Tk, D, bq, bk, \
              rows, width, scale)

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; flat: 0 = rect tables, 1 = work queue;
// kind: 3 runs fwd_wgmma_kernel (bf16 at the shapes wgmma_shape_ok takes;
// others are refused), 0 the dtype's other forward
int doc_attn_fwd(DOC_ATTN_ARGS, int kind) {
  if (!shapes_ok(Hq, Hkv, D, bq, bk) || (kind != 0 && kind != 3) ||
      (kind == 3 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Params p = DOC_ATTN_PARAMS;
  return dispatch(p, kind, (long long)rows * B * Hq, flat, dtype,
                  static_cast<cudaStream_t>(stream));
}

// key_tile: the bf16 kernel's keys per sub-tile (32, or 64 where block_k
// allows); the f32 kernel ignores it
int doc_attn_dq(DOC_ATTN_ARGS, int key_tile) {
  if (!shapes_ok(Hq, Hkv, D, bq, bk)) return (int)cudaErrorInvalidValue;
  Params p = DOC_ATTN_PARAMS;
  p.key_tile = key_tile;
  return dispatch(p, 1, (long long)rows * B * Hq, flat, dtype,
                         static_cast<cudaStream_t>(stream));
}

// parts, slices, ws: the bf16 kernel's key parts per block row, group
// slices and f32 slice workspace (2, slices, B, Hkv, Tk, D); the f32
// kernel ignores them
int doc_attn_dkv(DOC_ATTN_ARGS, int parts, int slices, float* ws) {
  if (!shapes_ok(Hq, Hkv, D, bq, bk)) return (int)cudaErrorInvalidValue;
  Params p = DOC_ATTN_PARAMS;
  p.parts = parts;
  p.slices = slices;
  p.ws = ws;
  return dispatch(p, 2, (long long)rows * B * Hkv * (bk / KT), flat,
                          dtype, static_cast<cudaStream_t>(stream));
}

// shared-memory bytes of the CTA that the entry of `kind` launches for
// these arguments (kind 3: the forward on wgmma; parts: dK/dV's key
// parts; key_tile: dQ's sub-tile)
long long doc_attn_smem_bytes(int kind, int dtype, int bq, int bk, int D,
                              int parts, int key_tile) {
  Params p{};
  p.bq = bq; p.bk = bk; p.D = D; p.parts = parts; p.key_tile = key_tile;
  return smem_bytes(p, kind, dtype);
}

const char* doc_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
