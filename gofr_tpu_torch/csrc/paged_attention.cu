// Paged decode attention for Hopper (sm_90a) over bf16 page pools.
//
// Replaces: gofr_tpu/ops/paged_attention.py::_paged_kernel with
// quantized=False (the Pallas TPU kernel behind paged_decode_attention,
// reached from llama.decode_step_paged).
//
// Computes, for one query token per sequence b and each query head h of kv
// head hk = h / G:
//   out[b,h,:] = softmax_j(q[b,h,:] . K_b[j,hk,:] * scale) V_b[j,hk,:],
// j < seq_lens[b], where token j of sequence b lives in pool page
// block_tables[b, j / page] at offset j % page. seq_len 0 gives 0.
//
// Bound on the H100: every K and V byte of the live tokens is read once and
// used for 2*G FLOPs (G = 4 at Llama-3-8B), about one FLOP per byte, far
// below the ~295 FLOPs per byte where the tensor cores become the limit:
// the kernel is bound by HBM bandwidth (3.35 TB/s), 2*seq*Hkv*Dh*2 bytes per
// sequence and layer.
//
// Design: one block per (kv head, sequence) serves that kv head's G query
// heads together, so each K/V byte crosses HBM once per step rather than G
// times. Eight warps split the sequence's pages round-robin; inside a warp
// each half-warp takes every other token of the page and each of its 16
// lanes holds Dh/16 contiguous elements, so a token row is one coalesced
// 16-byte load per lane. Scores are reduced across the 16 lanes by
// shuffles, the online softmax (running max, denominator, accumulator) is
// kept in f32 registers per half-warp, and the partial states are merged
// across the two halves by shuffles and across the warps through shared
// memory at the end. Pages at or past ceil(seq_len/page) are never read;
// page ids are clamped into the pool as the reference's gather clamps.
// Split-K across blocks (for long sequences at small batch) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NW = 8;            // warps per block
constexpr int THREADS = NW * 32;
constexpr int LANES = 16;        // lanes per token row (a half-warp)
constexpr int TOK = 8;           // tokens per half-warp per chunk

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

template <int DH, int G>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k_pool,
                    const uint16_t* __restrict__ v_pool, const int* __restrict__ tables,
                    const int* __restrict__ seq_lens, __nv_bfloat16* __restrict__ out, int H,
                    int Hkv, int page, int n_pool, int max_pages, float scale_log2) {
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

  const long page_elems = (long)page * DH;
  for (int p = warp; p < n_pages; p += NW) {
    int pid = tables[(long)b * max_pages + p];
    pid = min(max(pid, 0), n_pool - 1);
    const uint16_t* kp = k_pool + ((long)pid * Hkv + hk) * page_elems + sub * VEC;
    const uint16_t* vp = v_pool + ((long)pid * Hkv + hk) * page_elems + sub * VEC;
    const int base = p * page;
    for (int t0 = 0; t0 < page; t0 += 2 * TOK) {
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
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(pr, vx[e], acc[g][e]);
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

template <int DH>
cudaError_t launch_dh(int G, dim3 grid, cudaStream_t st, const uint16_t* q,
                      const uint16_t* kp, const uint16_t* vp, const int* tab, const int* lens,
                      __nv_bfloat16* out, int H, int Hkv, int page, int n_pool, int max_pages,
                      float sl2) {
#define GOFR_PAGED_CASE(GV)                                                                \
  case GV:                                                                                 \
    paged_decode_kernel<DH, GV><<<grid, THREADS, 0, st>>>(q, kp, vp, tab, lens, out, H,    \
                                                          Hkv, page, n_pool, max_pages,    \
                                                          sl2);                            \
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

}  // namespace

extern "C" int gofr_paged_decode_bf16(const void* q, const void* k_pool, const void* v_pool,
                                      const void* block_tables, const void* seq_lens,
                                      void* out, int B, int H, int Hkv, int Dh, int page,
                                      int n_pool_pages, int max_pages, float scale,
                                      void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || page <= 0 || n_pool_pages <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(Hkv, B);
  const float sl2 = scale * 1.4426950408889634f;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const uint16_t*>(q);
  const auto* kp = static_cast<const uint16_t*>(k_pool);
  const auto* vp = static_cast<const uint16_t*>(v_pool);
  const auto* tab = static_cast<const int*>(block_tables);
  const auto* lens = static_cast<const int*>(seq_lens);
  auto* op = static_cast<__nv_bfloat16*>(out);
  const int G = H / Hkv;
  switch (Dh) {
    case 64:
      return (int)launch_dh<64>(G, grid, st, qp, kp, vp, tab, lens, op, H, Hkv, page,
                                n_pool_pages, max_pages, sl2);
    case 128:
      return (int)launch_dh<128>(G, grid, st, qp, kp, vp, tab, lens, op, H, Hkv, page,
                                 n_pool_pages, max_pages, sl2);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
