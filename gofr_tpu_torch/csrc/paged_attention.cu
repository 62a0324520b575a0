// Paged decode attention for Hopper (sm_90a) over bf16 or int8 page pools.
//
// Replaces: gofr_tpu/ops/paged_attention.py::_paged_kernel, the Pallas TPU
// kernel behind paged_decode_attention (quantized=False, reached from
// llama.decode_step_paged) and paged_decode_attention_q (quantized=True,
// reached from llama.decode_step_paged_q).
//
// Computes, for one query token per sequence b and each query head h of kv
// head hk = h / G:
//   out[b,h,:] = softmax_j(q[b,h,:] . K_b[j,hk,:] * scale) V_b[j,hk,:],
// j < seq_lens[b], where token j of sequence b lives in pool page
// block_tables[b, j / page] at offset j % page. seq_len 0 gives 0. In the
// int8 pools a token row holds int8 values and one f32 absmax scale per
// (page, kv head, offset): K_b[j] = kq * ks, V_b[j] = vq * vs.
//
// Bound on the H100: every K and V byte of the live tokens is read once and
// used for 2*G FLOPs (G = 4 at Llama-3-8B), about one FLOP per byte (two
// for int8), far below the ~295 FLOPs per byte where the tensor cores
// become the limit: both kernels are bound by HBM bandwidth (3.35 TB/s).
// bf16 moves 2*seq*Hkv*Dh*2 bytes per sequence and layer; int8 moves
// 2*seq*Hkv*(Dh + 4), about half. At the main path's decode batch (B=8,
// H=32, Hkv=8, Dh=128, 2851 tokens) that is 11.7 MB, 0.0035 ms, for bf16
// and 6.02 MB, 0.0018 ms, for int8.
//
// Design: one block per (kv head, sequence) serves that kv head's G query
// heads together, so each K/V byte crosses HBM once per step rather than G
// times. Eight warps split the sequence's pages round-robin; inside a warp
// each half-warp takes every other token of the page and each of its 16
// lanes holds Dh/16 contiguous elements, so a token row is one coalesced
// load per lane: 16 bytes of bf16, or 8 bytes of int8 (4 at Dh 64) that
// widen to f32 in registers with sign extension; the pools are never
// widened in memory. A stretch of 16 tokens' K and V scales is one
// coalesced read by the warp (lanes 0-15 the K scales, 16-31 the V
// scales), handed to the half-warps by shuffles. The K scale folds into
// the score (s = (q.kq) * ks * scale) and the V scale into the probability
// before the PV accumulation (acc += (p * vs) * vq), so the dequantized
// rows never exist. Scores are reduced across the 16 lanes by shuffles,
// the online softmax (running max, denominator, accumulator) is kept in
// f32 registers per half-warp, and the partial states are merged across
// the two halves by shuffles and across the warps through shared memory at
// the end. Pages at or past ceil(seq_len/page) are never read; page ids
// are clamped into the pool as the reference's gather clamps.
//
// What holds both back (later work): at batch 8 the grid has only
// Hkv * B = 64 blocks for 132 SMs, so split-K across blocks (for long
// sequences at small batch) is the first fix; then cp.async staging of
// the next page while the current one is reduced.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NW = 8;            // warps per block
constexpr int THREADS = NW * 32;
constexpr int LANES = 16;        // lanes per token row (a half-warp)
constexpr int TOK = 8;           // tokens per half-warp per stretch
constexpr int STRETCH = 2 * TOK; // tokens per warp per stretch

// Dh/16 bf16 at p -> f32 (bf16 is the high half of an f32)
template <int VEC>
__device__ __forceinline__ void load_row(const uint16_t* p, float (&x)[VEC]) {
  static_assert(VEC == 8 || VEC == 4, "16 lanes cover Dh = 128 or 64");
  if constexpr (VEC == 8) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    const uint32_t w[2] = {r.x, r.y};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// Dh/16 int8 at p -> f32. Each byte is taken as a signed char before the
// conversion, so negative values sign-extend (a raw byte permute would not).
template <int VEC>
__device__ __forceinline__ void load_row(const int8_t* p, float (&x)[VEC]) {
  static_assert(VEC == 8 || VEC == 4, "16 lanes cover Dh = 128 or 64");
  uint32_t w[VEC / 4];
  if constexpr (VEC == 8) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    w[0] = r.x;
    w[1] = r.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int i = 0; i < VEC / 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int8_t b = static_cast<int8_t>(static_cast<uint8_t>(w[i] >> (8 * j)));
      x[4 * i + j] = __int2float_rn(static_cast<int>(b));
    }
  }
}

// KV = uint16_t: bf16 pools, the scale pointers unused; KV = int8_t: int8
// pools with f32 scales [n_pool, Hkv, page, 1].
template <int DH, int G, typename KV>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const uint16_t* __restrict__ q, const KV* __restrict__ k_pool,
                    const KV* __restrict__ v_pool, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, const int* __restrict__ tables,
                    const int* __restrict__ seq_lens, __nv_bfloat16* __restrict__ out, int H,
                    int Hkv, int page, int n_pool, int max_pages, float scale_log2) {
  constexpr bool QUANT = std::is_same<KV, int8_t>::value;
  constexpr int VEC = DH / LANES;
  __shared__ float sm_m[NW][G];
  __shared__ float sm_l[NW][G];
  __shared__ float sm_acc[NW][G][DH];

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int half = lane >> 4, sub = lane & 15;
  const int seq = max(seq_lens[b], 0);
  const int n_pages = min((seq + page - 1) / page, max_pages);

  float qv[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load_row<VEC>(q + ((long)b * H + hk * G + g) * DH + sub * VEC, qv[g]);
#pragma unroll
    for (int e = 0; e < VEC; ++e) qv[g][e] *= scale_log2;
  }

  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }

  for (int p = warp; p < n_pages; p += NW) {
    int pid = tables[(long)b * max_pages + p];
    pid = min(max(pid, 0), n_pool - 1);
    const long row0 = ((long)pid * Hkv + hk) * page;  // token 0 of this page and kv head
    const KV* kp = k_pool + row0 * DH + sub * VEC;
    const KV* vp = v_pool + row0 * DH + sub * VEC;
    const int base = p * page;
    for (int t0 = 0; t0 < page; t0 += STRETCH) {
      // the stretch's scales: lane l < 16 holds token t0+l's K scale, lane
      // 16+l its V scale (one coalesced read of each), shuffled to the
      // half-warp that owns the token
      float ks[TOK], vs[TOK];
      if constexpr (QUANT) {
        const int t = t0 + sub;
        const float sc = t < page ? (half == 0 ? k_scale : v_scale)[row0 + t] : 0.f;
#pragma unroll
        for (int i = 0; i < TOK; ++i) {
          ks[i] = __shfl_sync(0xffffffffu, sc, 2 * i + half);
          vs[i] = __shfl_sync(0xffffffffu, sc, LANES + 2 * i + half);
        }
      }
      float s[TOK][G];
      bool ok[TOK];
#pragma unroll
      for (int i = 0; i < TOK; ++i) {
        const int tok = t0 + 2 * i + half;
        ok[i] = tok < page && base + tok < seq;
        float kx[VEC];
        if (ok[i]) {
          load_row<VEC>(kp + (long)tok * DH, kx);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) kx[e] = 0.f;
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) d = fmaf(qv[g][e], kx[e], d);
          s[i][g] = d;
        }
      }
      // full dot products: sum over the 16 lanes of each half-warp
#pragma unroll
      for (int i = 0; i < TOK; ++i) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
#pragma unroll
          for (int off = LANES / 2; off > 0; off >>= 1)
            s[i][g] += __shfl_xor_sync(0xffffffffu, s[i][g], off);
          if constexpr (QUANT) s[i][g] *= ks[i];
        }
      }
      float base_m[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float mc = -INFINITY;
#pragma unroll
        for (int i = 0; i < TOK; ++i) mc = ok[i] ? fmaxf(mc, s[i][g]) : mc;
        const float m_new = fmaxf(m[g], mc);
        base_m[g] = (m_new == -INFINITY) ? 0.f : m_new;
        const float corr = exp2f(m[g] - base_m[g]);
        m[g] = m_new;
        l[g] *= corr;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] *= corr;
      }
#pragma unroll
      for (int i = 0; i < TOK; ++i) {
        if (!ok[i]) continue;
        const int tok = t0 + 2 * i + half;
        float vx[VEC];
        load_row<VEC>(vp + (long)tok * DH, vx);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pr = exp2f(s[i][g] - base_m[g]);
          l[g] += pr;
          float pv = pr;
          if constexpr (QUANT) pv *= vs[i];
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(pv, vx[e], acc[g][e]);
        }
      }
    }
  }

  // merge the two half-warps (same Dh slice, disjoint tokens)
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m[g], 16);
    const float l_o = __shfl_xor_sync(0xffffffffu, l[g], 16);
    const float mm = fmaxf(m[g], m_o);
    const float bm = (mm == -INFINITY) ? 0.f : mm;
    const float c_self = exp2f(m[g] - bm), c_other = exp2f(m_o - bm);
    l[g] = l[g] * c_self + l_o * c_other;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float a_o = __shfl_xor_sync(0xffffffffu, acc[g][e], 16);
      acc[g][e] = acc[g][e] * c_self + a_o * c_other;
    }
    m[g] = mm;
  }
  if (half == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (sub == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) sm_acc[warp][g][sub * VEC + e] = acc[g][e];
    }
  }
  __syncthreads();

  // merge the warps and write out[b, hk*G + g, :]
  for (int i = threadIdx.x; i < G * DH; i += THREADS) {
    const int g = i / DH, d = i % DH;
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) mm = fmaxf(mm, sm_m[w][g]);
    const float bm = (mm == -INFINITY) ? 0.f : mm;
    float lt = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = exp2f(sm_m[w][g] - bm);
      lt += sm_l[w][g] * c;
      o += sm_acc[w][g][d] * c;
    }
    out[((long)b * H + hk * G + g) * DH + d] = __float2bfloat16_rn(lt > 0.f ? o / lt : 0.f);
  }
}

template <int DH, typename KV>
cudaError_t launch_dh(int G, dim3 grid, cudaStream_t st, const uint16_t* q, const KV* kp,
                      const KV* vp, const float* ks, const float* vs, const int* tab,
                      const int* lens, __nv_bfloat16* out, int H, int Hkv, int page, int n_pool,
                      int max_pages, float sl2) {
#define GOFR_PAGED_CASE(GV)                                                                   \
  case GV:                                                                                    \
    paged_decode_kernel<DH, GV, KV><<<grid, THREADS, 0, st>>>(q, kp, vp, ks, vs, tab, lens,   \
                                                              out, H, Hkv, page, n_pool,      \
                                                              max_pages, sl2);                \
    break;
  switch (G) {
    GOFR_PAGED_CASE(1)
    GOFR_PAGED_CASE(2)
    GOFR_PAGED_CASE(4)
    GOFR_PAGED_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef GOFR_PAGED_CASE
  return cudaGetLastError();
}

template <typename KV>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
           const void* v_scale, const void* block_tables, const void* seq_lens, void* out,
           int B, int H, int Hkv, int Dh, int page, int n_pool_pages, int max_pages,
           float scale, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || page <= 0 || n_pool_pages <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(Hkv, B);
  const float sl2 = scale * 1.4426950408889634f;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const uint16_t*>(q);
  const auto* kp = static_cast<const KV*>(k_pool);
  const auto* vp = static_cast<const KV*>(v_pool);
  const auto* ks = static_cast<const float*>(k_scale);
  const auto* vs = static_cast<const float*>(v_scale);
  const auto* tab = static_cast<const int*>(block_tables);
  const auto* lens = static_cast<const int*>(seq_lens);
  auto* op = static_cast<__nv_bfloat16*>(out);
  const int G = H / Hkv;
  switch (Dh) {
    case 64:
      return (int)launch_dh<64, KV>(G, grid, st, qp, kp, vp, ks, vs, tab, lens, op, H, Hkv,
                                    page, n_pool_pages, max_pages, sl2);
    case 128:
      return (int)launch_dh<128, KV>(G, grid, st, qp, kp, vp, ks, vs, tab, lens, op, H, Hkv,
                                     page, n_pool_pages, max_pages, sl2);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int gofr_paged_decode_bf16(const void* q, const void* k_pool, const void* v_pool,
                                      const void* block_tables, const void* seq_lens,
                                      void* out, int B, int H, int Hkv, int Dh, int page,
                                      int n_pool_pages, int max_pages, float scale,
                                      void* stream) {
  return launch<uint16_t>(q, k_pool, v_pool, nullptr, nullptr, block_tables, seq_lens, out, B,
                          H, Hkv, Dh, page, n_pool_pages, max_pages, scale, stream);
}

extern "C" int gofr_paged_decode_int8(const void* q, const void* k_pool, const void* v_pool,
                                      const void* k_scale, const void* v_scale,
                                      const void* block_tables, const void* seq_lens,
                                      void* out, int B, int H, int Hkv, int Dh, int page,
                                      int n_pool_pages, int max_pages, float scale,
                                      void* stream) {
  if (k_scale == nullptr || v_scale == nullptr) return (int)cudaErrorInvalidValue;
  return launch<int8_t>(q, k_pool, v_pool, k_scale, v_scale, block_tables, seq_lens, out, B,
                        H, Hkv, Dh, page, n_pool_pages, max_pages, scale, stream);
}
