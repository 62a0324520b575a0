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
// Design: split across blocks in one launch (flash-decoding). The grid is
// (Hkv, B, n_splits); split s of row b covers pages [s*pps, (s+1)*pps) of
// its table (pps pages, a fixed token span the host picks from the page
// size), and a block whose span lies past the row's live pages exits at
// once, so no host read of seq_lens is needed. One block serves its kv
// head's G query heads together, so each K/V byte crosses HBM once per
// step rather than G times. The span's page ids are read once into shared
// memory (clamped into the pool, as the reference's gather clamps). Eight
// warps split the span's tokens; a token row is read as 16-byte loads, one
// per lane: 16 lanes cover a Dh=128 bf16 row, 8 lanes an int8 row (16
// values each), so a warp reads 2 (bf16) or 4 (int8) tokens per
// instruction. A stretch's K rows, V rows and scales are all issued before
// its math. Scores are reduced across a row's lanes by shuffles; the K
// scale folds into the score (s = (q.kq) * ks * scale) and the V scale into
// the probability (acc += (p * vs) * vq), so no dequantized row ever
// exists. Each lane keeps an f32 online softmax (running max, denominator,
// accumulator); the states merge across a warp's rows by shuffles and
// across warps through shared memory. A row with one live span writes out
// directly. Otherwise each live block writes its f32 partial (m, l,
// acc[G][Dh]) to scratch, and the last block to arrive for (b, hk) (a
// __threadfence, then atomicAdd on a per-(b, hk) counter) merges the
// partials in split order, so the result is the same bit for bit whichever
// block comes last, writes out and resets the counter to 0 for the next
// launch.
//
// Span: 256 tokens (ops/paged_attention.py SPLIT_TOKENS), chosen on the
// card against 128 and 512 (PERF.md). At the main path's batch that is
// 16 live (row, span) pairs per kv head, 128 blocks for 132 SMs.
//
// What still holds it back (PERF.md): it runs at 5-10x its HBM bound,
// bound by latency, not bandwidth. Each block waits on a chain of
// dependent round trips (row length and page ids, then its K/V stretches,
// then the partial write, fence and atomic, then the last block's read of
// the partials) and moves only ~128 KB (bf16) or ~68 KB (int8); the next
// stretch is not staged while the current one is reduced, and the launch
// itself is a fixed few microseconds of the time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NW = 8;              // warps per block
constexpr int THREADS = NW * 32;
constexpr int MAX_PPS = THREADS;   // pages per split: one page id per thread

template <int DH, int G, typename KV>
struct Cfg {
  static constexpr bool QUANT = std::is_same<KV, int8_t>::value;
  static constexpr int VEC = 16 / (int)sizeof(KV);   // elements per lane (one 16-byte load)
  static constexpr int LANES = DH / VEC;             // lanes per token row
  static constexpr int ROWS = 32 / LANES;            // tokens per warp instruction
  static constexpr int U = G <= 4 ? 4 : 2;           // token groups per stretch
  static_assert(LANES >= 4 && LANES <= 32, "Dh 64 or 128");
};

// 16 bytes of bf16 -> 8 f32 (bf16 is the high half of an f32)
__device__ __forceinline__ void widen(const uint4& r, float (&x)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 16 bytes of int8 -> 16 f32. Each byte is taken as a signed char before
// the conversion, so negative values sign-extend.
__device__ __forceinline__ void widen(const uint4& r, float (&x)[16]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      x[4 * i + j] = __int2float_rn((int)static_cast<int8_t>(static_cast<uint8_t>(w[i] >> (8 * j))));
  }
}

__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// KV = uint16_t: bf16 pools, the scale pointers unused; KV = int8_t: int8
// pools with f32 scales [n_pool, Hkv, page, 1]. part: [B, Hkv, n_splits,
// G, 2] (m, l) followed by [B, Hkv, n_splits, G, DH] (acc), f32; counters:
// [B * Hkv] int32, 0 between launches.
// One block an SM: the bf16 build then takes ~150 registers a thread, and
// at the 256-token span ran faster than its 128-register, two-block build.
template <int DH, int G, typename KV>
__global__ void __launch_bounds__(THREADS, 1)
paged_decode_kernel(const uint16_t* __restrict__ q, const KV* __restrict__ k_pool,
                    const KV* __restrict__ v_pool, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, const int* __restrict__ tables,
                    const int* __restrict__ seq_lens, __nv_bfloat16* __restrict__ out,
                    float* __restrict__ part, int* __restrict__ counters, int H, int Hkv,
                    int page, int n_pool, int max_pages, int pps, float scale_log2) {
  using C = Cfg<DH, G, KV>;
  constexpr int VEC = C::VEC, LANES = C::LANES, ROWS = C::ROWS, U = C::U;
  __shared__ float sm_m[NW][G];
  __shared__ float sm_l[NW][G];
  __shared__ float sm_acc[NW][G][DH];
  __shared__ int sm_pid[MAX_PPS];
  __shared__ int sm_last;

  const int hk = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int n_splits = gridDim.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = lane / LANES, sub = lane % LANES;
  const int p0 = split * pps;

  // the row's length, the span's page ids and q go out together (none
  // depends on another), before the block knows whether its span is live
  const int seq = max(seq_lens[b], 0);
  int pid = 0;
  if (threadIdx.x < min(pps, max_pages - p0)) pid = tables[(long)b * max_pages + p0 + threadIdx.x];
  float qv[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const uint16_t* qp = q + ((long)b * H + hk * G + g) * DH + sub * VEC;
#pragma unroll
    for (int h8 = 0; h8 < VEC / 8; ++h8) {
      float x[8];
      widen(ldg16(qp + 8 * h8), x);
#pragma unroll
      for (int e = 0; e < 8; ++e) qv[g][8 * h8 + e] = x[e] * scale_log2;
    }
  }

  const int n_pages = min((seq + page - 1) / page, max_pages);
  const int n_live = (n_pages + pps - 1) / pps;
  if (split >= max(n_live, 1)) return;  // past the row's live pages (split 0 always runs)
  const int np = min(pps, n_pages - p0);  // <= 0 only when seq_len is 0
  if (threadIdx.x < np) sm_pid[threadIdx.x] = min(max(pid, 0), n_pool - 1);
  __syncthreads();
  const int n_tok = max(0, min(np * page, seq - p0 * page));

  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }

  // token group gi holds tokens gi*ROWS .. gi*ROWS + ROWS-1 of the span; a
  // warp takes groups warp, warp + NW, ...; U of them per stretch
  const int n_groups = (n_tok + ROWS - 1) / ROWS;
  for (int gi0 = warp; gi0 < n_groups; gi0 += NW * U) {
    uint4 kr[U], vr[U];
    float ks[U], vs[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int lt = (gi0 + u * NW) * ROWS + slot;
      ok[u] = lt < n_tok;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      ks[u] = vs[u] = 0.f;
      if (ok[u]) {
        const int pg = lt / page;
        const long row = ((long)sm_pid[pg] * Hkv + hk) * page + (lt - pg * page);
        kr[u] = ldg16(k_pool + row * DH + sub * VEC);
        vr[u] = ldg16(v_pool + row * DH + sub * VEC);
        if constexpr (C::QUANT) {
          ks[u] = __ldg(k_scale + row);
          vs[u] = __ldg(v_scale + row);
        }
      }
    }
    // scores, reduced over the row's lanes
    float s[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kx[VEC];
      widen(kr[u], kx);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) d = fmaf(qv[g][e], kx[e], d);
#pragma unroll
        for (int off = LANES / 2; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
        if constexpr (C::QUANT) d *= ks[u];
        s[u][g] = d;
      }
    }
    float base_m[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mc = -INFINITY;
#pragma unroll
      for (int u = 0; u < U; ++u) mc = ok[u] ? fmaxf(mc, s[u][g]) : mc;
      const float m_new = fmaxf(m[g], mc);
      base_m[g] = (m_new == -INFINITY) ? 0.f : m_new;
      const float corr = exp2f(m[g] - base_m[g]);
      m[g] = m_new;
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][e] *= corr;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!ok[u]) continue;
      float vx[VEC];
      widen(vr[u], vx);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pr = exp2f(s[u][g] - base_m[g]);
        l[g] += pr;
        float pv = pr;
        if constexpr (C::QUANT) pv *= vs[u];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(pv, vx[e], acc[g][e]);
      }
    }
  }

  // merge the warp's row slots (same Dh slice, disjoint tokens)
#pragma unroll
  for (int off = LANES; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mm = fmaxf(m[g], m_o);
      const float bm = (mm == -INFINITY) ? 0.f : mm;
      const float c_self = exp2f(m[g] - bm), c_other = exp2f(m_o - bm);
      l[g] = l[g] * c_self + l_o * c_other;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float a_o = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * c_self + a_o * c_other;
      }
      m[g] = mm;
    }
  }
  if (slot == 0) {
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

  // merge the warps: this block's (m, l, acc) for each (g, d)
  const long row_pair = (long)b * Hkv + hk;
  const long ml_base = row_pair * n_splits * G * 2;   // (m, l) of split 0, g 0
  const long acc_base = (long)gridDim.y * Hkv * n_splits * G * 2 + row_pair * n_splits * G * DH;
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
    if (n_live <= 1) {
      out[((long)b * H + hk * G + g) * DH + d] = __float2bfloat16_rn(lt > 0.f ? o / lt : 0.f);
    } else {
      part[acc_base + ((long)split * G + g) * DH + d] = o;
      if (d == 0) {
        part[ml_base + ((long)split * G + g) * 2] = mm;
        part[ml_base + ((long)split * G + g) * 2 + 1] = lt;
      }
    }
  }
  if (n_live <= 1) return;

  // the last block of (b, hk) to arrive merges the partials in split order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) sm_last = atomicAdd(&counters[row_pair], 1) == n_live - 1;
  __syncthreads();
  if (!sm_last) return;
  __threadfence();
  for (int i = threadIdx.x; i < G * DH; i += THREADS) {
    const int g = i / DH, d = i % DH;
    float mm = -INFINITY;
    for (int s = 0; s < n_live; ++s) mm = fmaxf(mm, __ldcg(part + ml_base + ((long)s * G + g) * 2));
    const float bm = (mm == -INFINITY) ? 0.f : mm;
    float lt = 0.f, o = 0.f;
    for (int s = 0; s < n_live; ++s) {
      const float c = exp2f(__ldcg(part + ml_base + ((long)s * G + g) * 2) - bm);
      lt += __ldcg(part + ml_base + ((long)s * G + g) * 2 + 1) * c;
      o += __ldcg(part + acc_base + ((long)s * G + g) * DH + d) * c;
    }
    out[((long)b * H + hk * G + g) * DH + d] = __float2bfloat16_rn(lt > 0.f ? o / lt : 0.f);
  }
  if (threadIdx.x == 0) counters[row_pair] = 0;  // every block of (b, hk) has arrived
}

template <int DH, typename KV>
cudaError_t launch_dh(int G, dim3 grid, cudaStream_t st, const uint16_t* q, const KV* kp,
                      const KV* vp, const float* ks, const float* vs, const int* tab,
                      const int* lens, __nv_bfloat16* out, float* part, int* counters, int H,
                      int Hkv, int page, int n_pool, int max_pages, int pps, float sl2) {
#define GOFR_PAGED_CASE(GV)                                                                  \
  case GV:                                                                                   \
    paged_decode_kernel<DH, GV, KV><<<grid, THREADS, 0, st>>>(                               \
        q, kp, vp, ks, vs, tab, lens, out, part, counters, H, Hkv, page, n_pool, max_pages, \
        pps, sl2);                                                                           \
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
           void* part, void* counters, int B, int H, int Hkv, int Dh, int page,
           int n_pool_pages, int max_pages, int pps, float scale, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || page <= 0 || n_pool_pages <= 0 || max_pages < 0 ||
      pps <= 0 || pps > MAX_PPS || part == nullptr || counters == nullptr || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int n_splits = max(1, (max_pages + pps - 1) / pps);
  if (n_splits > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(Hkv, B, n_splits);
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
  auto* pp = static_cast<float*>(part);
  auto* cp = static_cast<int*>(counters);
  const int G = H / Hkv;
  switch (Dh) {
    case 64:
      return (int)launch_dh<64, KV>(G, grid, st, qp, kp, vp, ks, vs, tab, lens, op, pp, cp, H,
                                    Hkv, page, n_pool_pages, max_pages, pps, sl2);
    case 128:
      return (int)launch_dh<128, KV>(G, grid, st, qp, kp, vp, ks, vs, tab, lens, op, pp, cp, H,
                                     Hkv, page, n_pool_pages, max_pages, pps, sl2);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int gofr_paged_decode_bf16(const void* q, const void* k_pool, const void* v_pool,
                                      const void* block_tables, const void* seq_lens,
                                      void* out, void* part, void* counters, int B, int H,
                                      int Hkv, int Dh, int page, int n_pool_pages,
                                      int max_pages, int pps, float scale, void* stream) {
  return launch<uint16_t>(q, k_pool, v_pool, nullptr, nullptr, block_tables, seq_lens, out,
                          part, counters, B, H, Hkv, Dh, page, n_pool_pages, max_pages, pps,
                          scale, stream);
}

extern "C" int gofr_paged_decode_int8(const void* q, const void* k_pool, const void* v_pool,
                                      const void* k_scale, const void* v_scale,
                                      const void* block_tables, const void* seq_lens,
                                      void* out, void* part, void* counters, int B, int H,
                                      int Hkv, int Dh, int page, int n_pool_pages,
                                      int max_pages, int pps, float scale, void* stream) {
  if (k_scale == nullptr || v_scale == nullptr) return (int)cudaErrorInvalidValue;
  return launch<int8_t>(q, k_pool, v_pool, k_scale, v_scale, block_tables, seq_lens, out, part,
                        counters, B, H, Hkv, Dh, page, n_pool_pages, max_pages, pps, scale,
                        stream);
}
