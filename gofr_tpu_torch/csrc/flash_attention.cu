// Flash-prefill attention for Hopper (sm_90a): bf16 in, f32 online softmax,
// bf16 out.
//
// Replaces: gofr_tpu/ops/flash_attention.py::_flash_kernel (the Pallas TPU
// kernel behind flash_attention, reached from llama prefill).
//
// Computes, per batch row b and query head h (GQA: kv head h / (H/Hkv), no
// repeated K/V):
//   out[b,i,h,:] = softmax_j(q[b,i,h,:] . k[b,j,hk,:] * scale) v[b,j,hk,:]
// over keys j < kv_len[b] (and j <= i when causal). A row with no valid key
// gives 0 (denominator guard), whatever order the tiles are visited in.
//
// Bound on the H100: at a prefill bucket of S tokens the work is about
// 4*H*S^2*D/2 FLOPs against (3 inputs + 1 output) * S*H*D*2 bytes, i.e. some
// S/4 FLOPs per byte: for every bucket the engine uses (32 and up) it is
// bound by tensor-core operations (989 TFLOP/s dense bf16), not by HBM.
//
// Design: one block per (64-row query tile, head, batch row); four warps,
// each owning 16 query rows. The block walks 64-key tiles of K and V up to
// min(kv_len, causal limit) and stages each tile in shared memory (rows past
// kv_len are zero-filled). QK^T and PV run on the tensor cores through
// mma.sync m16n8k16 (bf16 in, f32 accumulate); the running max, denominator
// and output accumulator stay in f32 registers, and P never leaves the
// registers: the S accumulator fragments are re-packed as the A operand of
// the PV product. The query tile sits in registers for the whole walk.
// Queries past Sq and keys past Sk are masked at the edges, so any bucket
// size works (the TPU kernel needed multiples of its 128 block). wgmma, TMA
// and a producer/consumer pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // query rows per block (4 warps x 16)
constexpr int BK = 64;       // keys per tile
constexpr int THREADS = 128;
constexpr int PAD = 8;       // bf16 padding per shared-memory row (no bank conflicts)

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], uint32_t a0, uint32_t a1,
                                               uint32_t a2, uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                 const uint16_t* __restrict__ v, const int* __restrict__ kv_len_arr,
                 uint16_t* __restrict__ out, int Sq, int Sk, int H, int Hkv,
                 float scale_log2, int causal) {
  constexpr int LD = D + PAD;
  constexpr int KSTEPS = D / 16;     // k-steps over the head dim (QK^T)
  constexpr int NT_D = D / 8;        // n-tiles over the head dim (PV)
  constexpr int NT_K = BK / 8;       // n-tiles over the keys (QK^T)
  constexpr int VEC = 8;             // bf16 per 16-byte load
  constexpr int ROW_VECS = D / VEC;
  constexpr int TILE_VECS = BK * ROW_VECS;
  static_assert(BQ == BK, "the Q tile is staged through the K buffer");

  __shared__ __align__(16) uint16_t Ks[BK * LD];
  __shared__ __align__(16) uint16_t Vs[BK * LD];

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;
  const int kv_len = min(max(kv_len_arr[b], 0), Sk);

  const long q_stride = (long)H * D;     // between consecutive positions
  const long kv_stride = (long)Hkv * D;
  const uint16_t* qb = q + ((long)b * Sq * H + h) * D;
  const uint16_t* kb = k + ((long)b * Sk * Hkv + hk) * D;
  const uint16_t* vb = v + ((long)b * Sk * Hkv + hk) * D;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // Q tile -> shared (through the K buffer) -> A fragments in registers
  for (int i = tid; i < TILE_VECS; i += THREADS) {
    const int r = i / ROW_VECS, c = (i % ROW_VECS) * VEC;
    uint4 val = zero;
    if (q0 + r < Sq) val = *reinterpret_cast<const uint4*>(qb + (long)(q0 + r) * q_stride + c);
    *reinterpret_cast<uint4*>(&Ks[r * LD + c]) = val;
  }
  __syncthreads();
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = ld_u32(&Ks[(wr + g) * LD + c]);
    qf[kk][1] = ld_u32(&Ks[(wr + g + 8) * LD + c]);
    qf[kk][2] = ld_u32(&Ks[(wr + g) * LD + c + 8]);
    qf[kk][3] = ld_u32(&Ks[(wr + g + 8) * LD + c + 8]);
  }
  __syncthreads();

  float o[NT_D][4];
#pragma unroll
  for (int n = 0; n < NT_D; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max (log2 domain), rows g and g+8
  float l[2] = {0.f, 0.f};              // this thread's share of the denominator
  const int qi[2] = {q0 + wr + g, q0 + wr + g + 8};

  int kv_end = kv_len;
  if (causal) kv_end = min(kv_end, q0 + BQ);
  const int n_tiles = (kv_end + BK - 1) / BK;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    for (int i = tid; i < TILE_VECS; i += THREADS) {
      const int r = i / ROW_VECS, c = (i % ROW_VECS) * VEC;
      uint4 kv = zero, vv = zero;
      if (k0 + r < kv_len) {
        kv = *reinterpret_cast<const uint4*>(kb + (long)(k0 + r) * kv_stride + c);
        vv = *reinterpret_cast<const uint4*>(vb + (long)(k0 + r) * kv_stride + c);
      }
      *reinterpret_cast<uint4*>(&Ks[r * LD + c]) = kv;
      *reinterpret_cast<uint4*>(&Vs[r * LD + c]) = vv;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[NT_K][4];
#pragma unroll
    for (int j = 0; j < NT_K; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const uint16_t* krow = &Ks[(j * 8 + g) * LD + 2 * t];
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        mma_bf16_16816(s[j], qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3],
                       ld_u32(krow + kk * 16), ld_u32(krow + kk * 16 + 8));
      }
    }

    // scale, mask, and the tile's row max
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT_K; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e >> 1;
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        const bool ok = key < kv_len && (!causal || key <= qi[row]);
        s[j][e] = ok ? s[j][e] * scale_log2 : -INFINITY;
        mt[row] = fmaxf(mt[row], s[j][e]);
      }
    }
    float base[2];
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      mt[row] = fmaxf(mt[row], __shfl_xor_sync(0xffffffffu, mt[row], 1));
      mt[row] = fmaxf(mt[row], __shfl_xor_sync(0xffffffffu, mt[row], 2));
      const float m_new = fmaxf(m[row], mt[row]);
      // a row with nothing valid yet keeps a finite base: exp2(-inf) = 0,
      // never inf - inf
      base[row] = (m_new == -INFINITY) ? 0.f : m_new;
      const float corr = exp2f(m[row] - base[row]);
      m[row] = m_new;
      l[row] *= corr;
#pragma unroll
      for (int n = 0; n < NT_D; ++n) {
        o[n][2 * row] *= corr;
        o[n][2 * row + 1] *= corr;
      }
    }
#pragma unroll
    for (int j = 0; j < NT_K; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e >> 1;
        s[j][e] = exp2f(s[j][e] - base[row]);  // masked entries: exp2(-inf) = 0
        l[row] += s[j][e];
      }
    }

    // O += P V: the S fragments of two adjacent key n-tiles are the A
    // operand of one k16 step
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a0 = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int r0 = kk * 16 + 2 * t;
#pragma unroll
      for (int n = 0; n < NT_D; ++n) {
        const int c = n * 8 + g;
        const uint32_t b0 = (uint32_t)Vs[r0 * LD + c] | ((uint32_t)Vs[(r0 + 1) * LD + c] << 16);
        const uint32_t b1 =
            (uint32_t)Vs[(r0 + 8) * LD + c] | ((uint32_t)Vs[(r0 + 9) * LD + c] << 16);
        mma_bf16_16816(o[n], a0, a1, a2, a3, b0, b1);
      }
    }
    __syncthreads();  // every warp is done with this tile before it is overwritten
  }

  // epilogue: full denominators, guard, bf16 store
  float inv[2];
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    float lt = l[row];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    inv[row] = lt > 0.f ? 1.f / lt : 0.f;
  }
  uint16_t* ob = out + ((long)b * Sq * H + h) * D;
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    if (qi[row] >= Sq) continue;
    uint16_t* orow = ob + (long)qi[row] * q_stride;
#pragma unroll
    for (int n = 0; n < NT_D; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
          pack_bf16x2(o[n][2 * row] * inv[row], o[n][2 * row + 1] * inv[row]);
    }
  }
}

}  // namespace

extern "C" int gofr_flash_attention_bf16(const void* q, const void* k, const void* v,
                                         const void* kv_len, void* out, int B, int Sq,
                                         int Sk, int H, int Hkv, int D, float scale,
                                         int causal, void* stream) {
  if (B <= 0 || Sq <= 0) return (int)cudaSuccess;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const uint16_t*>(q);
  const auto* kp = static_cast<const uint16_t*>(k);
  const auto* vp = static_cast<const uint16_t*>(v);
  const auto* lp = static_cast<const int*>(kv_len);
  auto* op = static_cast<uint16_t*>(out);
  switch (D) {
    case 64:
      flash_fwd_kernel<64><<<grid, THREADS, 0, st>>>(qp, kp, vp, lp, op, Sq, Sk, H, Hkv,
                                                     scale_log2, causal);
      break;
    case 128:
      flash_fwd_kernel<128><<<grid, THREADS, 0, st>>>(qp, kp, vp, lp, op, Sq, Sk, H, Hkv,
                                                      scale_log2, causal);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
