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
// Design (one block per 128-row query tile, head and batch row; 288 threads):
// - Roles. Warps 0-7 are two consumer warpgroups, each owning 64 query
//   rows; warp 8 is the producer, one lane of which issues every copy. The
//   two consumer warpgroups share each K/V tile, so a tile crosses HBM once
//   per 128 query rows, and while one runs its softmax the other's
//   products keep the tensor cores busy. No setmaxnreg: a consumer thread
//   needs about 150 registers, under the 224 that 288 threads may hold.
// - Copies. TMA (cp.async.bulk.tensor, 4-D maps over [B, S, heads, D] with
//   128-byte swizzle; a D=128 row arrives as two 64-column boxes) into
//   dynamic shared memory: the Q tile once, then K and V through a ring of
//   STAGES slots guarded by a full and an empty mbarrier each. Rows past S
//   arrive as zeros. The maps are encoded on the host for each call and
//   passed as __grid_constant__ parameters; cuTensorMapEncodeTiled comes
//   through cudaGetDriverEntryPoint, so nothing links against libcuda.
// - Products. S = Q K^T is wgmma m64n64k16 with both operands in shared
//   memory, K-major. O += P V is wgmma m64n64k16 with P in registers (the S
//   accumulator fragments re-packed as bf16 pairs) and V from shared memory
//   with the B-transpose flag (V's rows are N-major), one instruction per
//   64 output columns. The warpgroup index and tile counts are broadcast
//   by a shuffle so ptxas sees them uniform and does not serialize wgmma.
// - Softmax. Running max, denominator and O stay in f32 registers; exp2 is
//   the hardware's ex2.approx. Only tiles that cross the diagonal or kv_len
//   are masked (masked keys inside S are real data, not TMA zero-fill, so
//   kv_len still needs its mask). A warpgroup skips the products of tiles
//   wholly above its diagonal.
// - Order. blockIdx.z walks query tiles from the last (heaviest under the
//   causal mask) to the first, and is the slowest grid dimension, so every
//   head's heaviest tiles start in the first wave and the launch ends on
//   light ones.
// - Edges. Any Sq/Sk (query rows past Sq are zero-filled by TMA and never
//   stored), any B, causal 0 or 1, D 64 or 128.
//
// What still holds it back (PERF.md): each warpgroup waits for its QK^T
// product before its softmax and for PV before releasing the slot. FA3's
// overlap inside a warpgroup (QK^T of the next tile and PV of this one
// issued together, the two warpgroups taking turns on named barriers)
// measured no faster here with 3 stages and slower with 2, and failed one
// launch in one run, so it was left out. 64-key tiles on 64-wide products
// keep the per-tile synchronisation a large share; 128-key tiles need more
// registers than 288 threads leave without setmaxnreg. One block runs per
// SM (registers), and the output is stored from registers in 4-byte
// pieces.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NWG = 2;             // consumer warpgroups, 64 query rows each
constexpr int BQ = 64 * NWG;       // query rows per block
constexpr int BK = 64;             // keys per K/V tile: one m64n64 S product
constexpr int STAGES = 2;          // K/V ring depth
constexpr int CONSUMERS = 128 * NWG;
constexpr int THREADS = CONSUMERS + 32;  // plus one producer warp
constexpr int BOX = 64 * 128;      // bytes of one 64-row x 64-column bf16 box

// ------------------------------------------------------------ PTX helpers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed. A phase that never
// completes (a lost copy or arrival) traps after about 2^34 cycles (~9 s),
// so the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > (1ll << 34)) {
      __trap();
    }
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle. K-major operands: SBO
// is the 1024-byte stride between 8-row groups (LBO unused); MN-major: SBO
// the stride between 8-row groups along K, LBO between 64-column blocks.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

#define GOFR_ACC32_STR                                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define GOFR_ACC32_OPS(d)                                                                    \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),       \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// D[64x64] (+)= A[64x16] B[16x64], A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " GOFR_ACC32_STR
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : GOFR_ACC32_OPS(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64x64] += A[64x16] B[16x64], A from registers, B from shared memory
// MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " GOFR_ACC32_STR
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : GOFR_ACC32_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x by the hardware's approximation (2 ulp; flushes denormals to 0, and
// exp2(-inf) = 0), one instruction against exp2f's range handling
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ----------------------------------------------------------------- kernel
// Accumulator layout of m64nN (per warpgroup thread: warp w, lane = 4g + t):
// element 4j + 2r + c sits at row 16w + g + 8r, column 8j + 2t + c.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ kv_len_arr,
                 uint16_t* __restrict__ out, int Sq, int Sk, int H, int Hkv, float scale_log2,
                 int causal) {
  constexpr int HALVES = D / 64;              // 64-column boxes per row
  constexpr int TILE = HALVES * BK * 128;     // bytes of one K or V tile
  constexpr int QTILE = HALVES * BOX;         // bytes of one warpgroup's Q rows
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * STAGES + 1];  // full[], empty[], q

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms: 1 KB aligned
  const uint32_t sQ = base;
  const uint32_t sK = sQ + NWG * QTILE;
  const uint32_t sV = sK + STAGES * TILE;
  const uint32_t bar0 = smem_u32(bars);
  auto full = [&](int s) { return bar0 + 8u * s; };
  auto empty = [&](int s) { return bar0 + 8u * (STAGES + s); };
  const uint32_t qbar = bar0 + 8u * (2 * STAGES);

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // heaviest query tile first
  const int hk = h / (H / Hkv);
  const int kv_len = min(max(kv_len_arr[b], 0), Sk);
  const int kv_end = causal ? min(kv_len, q0 + BQ) : kv_len;
  const int n_tiles = (kv_end + BK - 1) / BK;
  const int n_qwg = min(NWG, (Sq - q0 + 63) / 64);  // warpgroups with a query row below Sq
  const int tid = threadIdx.x;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS / 32);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---------------- producer: one lane issues every copy
    if (tid == CONSUMERS) {
      mbar_expect_tx(qbar, n_qwg * QTILE);
      for (int w = 0; w < n_qwg; ++w) {
#pragma unroll
        for (int c = 0; c < HALVES; ++c)
          tma_load_4d(sQ + w * QTILE + c * BOX, &tm_q, qbar, c * 64, h, q0 + 64 * w, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES, use = i / STAGES;
        if (use > 0) mbar_wait(empty(s), (use - 1) & 1);
        mbar_expect_tx(full(s), 2 * TILE);
#pragma unroll
        for (int c = 0; c < HALVES; ++c) {
          tma_load_4d(sK + s * TILE + c * BK * 128, &tm_k, full(s), c * 64, hk, i * BK, b);
          tma_load_4d(sV + s * TILE + c * BK * 128, &tm_v, full(s), c * 64, hk, i * BK, b);
        }
      }
    }
    return;
  }

  // ---------------- consumers: warpgroup wg owns rows row0 .. row0 + 63
  // warpgroup index and tile counts broadcast from lane 0, so the compiler
  // knows them uniform and keeps the wgmma pipeline unserialized
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + 64 * wg;
  const int rows[2] = {row0 + 16 * warp + g, row0 + 16 * warp + g + 8};
  // keys this warpgroup needs; none if all its rows lie past Sq
  const int wg_end = row0 >= Sq ? 0 : (causal ? min(kv_len, row0 + 64) : kv_len);
  const uint32_t qa = sQ + wg * QTILE;

  constexpr int NS = BK / 2;   // S accumulator registers a thread
  constexpr int KS = BK / 16;  // k16 steps of the PV product
  float o[HALVES][32];
#pragma unroll
  for (int c = 0; c < HALVES; ++c) {
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  }
  float m[2] = {-INFINITY, -INFINITY};  // running max (log2 domain), rows g and g+8
  float l[2] = {0.f, 0.f};              // this thread's share of the denominator
  float sc[NS];
#pragma unroll
  for (int e = 0; e < NS; ++e) sc[e] = 0.f;
  uint32_t pa[KS][4];  // P of the tile, the A fragments of the PV product
  float corr[2];

  // S = Q K^T of tile i over D in k16 steps (32 bytes each inside a box)
  auto issue_qk = [&](int i) {
    const uint32_t ks = sK + (i % STAGES) * TILE;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t da = sw128_desc(qa + (kk / 4) * BOX + (kk % 4) * 32, 0, 1024);
      const uint64_t db = sw128_desc(ks + (kk / 4) * BK * 128 + (kk % 4) * 32, 0, 1024);
      wgmma_ss(sc, da, db, kk > 0);
    }
  };
  // O += P V of tile i: V's rows (keys) are K, its columns N; 16 keys = 2 KB
  auto issue_pv = [&](int i) {
    const uint32_t vs = sV + (i % STAGES) * TILE;
#pragma unroll
    for (int c = 0; c < HALVES; ++c) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        wgmma_rs_tb(o[c], pa[kk], sw128_desc(vs + c * BK * 128 + kk * 2048, BK * 128, 1024));
    }
  };
  // scale and mask S of tile i (only tiles across the diagonal or kv_len),
  // update the running max and denominator, P -> pa, corr = the factor O
  // owes for the new max
  auto softmax = [&](int i) {
    const int k0 = i * BK;
    const bool masked = k0 + BK > kv_len || (causal && k0 + BK - 1 > row0);
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float x = sc[4 * j + e] * scale_log2;
        if (masked) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          if (key >= kv_len || (causal && key > rows[r])) x = -INFINITY;
        }
        sc[4 * j + e] = x;
        mt[r] = fmaxf(mt[r], x);
      }
    }
    float base_m[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float m_new = fmaxf(m[r], mt[r]);
      // a row with nothing valid yet keeps a finite base: exp2(-inf) = 0,
      // never inf - inf
      base_m[r] = (m_new == -INFINITY) ? 0.f : m_new;
      corr[r] = fast_exp2(m[r] - base_m[r]);
      m[r] = m_new;
      l[r] *= corr[r];
    }
    // P = exp2(S - max) as the A fragments of the PV product: key columns
    // 16kk .. 16kk+15 are accumulator blocks j = 2kk, 2kk+1
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      float p[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int j = 2 * kk + (e >> 2), r = (e >> 1) & 1;
        p[e] = fast_exp2(sc[4 * j + (e & 3)] - base_m[r]);  // masked: exp2(-inf) = 0
        l[r] += p[e];
      }
      pa[kk][0] = pack_bf16x2(p[0], p[1]);
      pa[kk][1] = pack_bf16x2(p[2], p[3]);
      pa[kk][2] = pack_bf16x2(p[4], p[5]);
      pa[kk][3] = pack_bf16x2(p[6], p[7]);
    }
  };
  auto rescale_o = [&]() {
#pragma unroll
    for (int c = 0; c < HALVES; ++c) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[c][4 * j] *= corr[0];
        o[c][4 * j + 1] *= corr[0];
        o[c][4 * j + 2] *= corr[1];
        o[c][4 * j + 3] *= corr[1];
      }
    }
  };

  // tiles this warpgroup computes: a prefix of the block's n_tiles; while
  // one warpgroup runs its softmax the other's products keep the tensor
  // cores busy
  const int nt = __shfl_sync(0xffffffffu, (wg_end + BK - 1) / BK, 0);
  mbar_wait(qbar, 0);
  for (int i = 0; i < nt; ++i) {
    mbar_wait(full(i % STAGES), (i / STAGES) & 1);
    __syncwarp();
    fence_regs(sc);
    wgmma_fence();
    issue_qk(i);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sc);
    softmax(i);
    rescale_o();
#pragma unroll
    for (int c = 0; c < HALVES; ++c) fence_regs(o[c]);
    fence_regs(pa);
    wgmma_fence();
    issue_pv(i);
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int c = 0; c < HALVES; ++c) fence_regs(o[c]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(i % STAGES));  // this warp is done with tile i
  }
  // tiles wholly above this warpgroup's diagonal: release them unread
  for (int i = nt; i < n_tiles; ++i) {
    mbar_wait(full(i % STAGES), (i / STAGES) & 1);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(i % STAGES));
  }

  // epilogue: full denominators, guard, bf16 store of the rows below Sq
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    inv[r] = lt > 0.f ? 1.f / lt : 0.f;
  }
  const long q_stride = (long)H * D;
  uint16_t* ob = out + ((long)b * Sq * H + h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= Sq) continue;
    uint16_t* orow = ob + (long)rows[r] * q_stride;
#pragma unroll
    for (int c = 0; c < HALVES; ++c) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + c * 64 + 8 * j + 2 * t) =
            pack_bf16x2(o[c][4 * j + 2 * r] * inv[r], o[c][4 * j + 2 * r + 1] * inv[r]);
    }
  }
}

// ------------------------------------------------------------------ host
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 4-D map over a contiguous bf16 [B, S, heads, D] tensor; one box is 64
// columns of `rows` consecutive positions of one head of one batch row.
bool encode_map(CUtensorMap* map, const void* ptr, int B, int S, int heads, int D, int rows) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, const int* kv_len,
                     uint16_t* out, int B, int Sq, int Sk, int H, int Hkv, float scale_log2,
                     int causal, cudaStream_t st) {
  constexpr int HALVES = D / 64;
  constexpr int SMEM = NWG * HALVES * BOX + 2 * STAGES * HALVES * BK * 128 + 1024;
  static bool attr_set = false;  // once per instantiation
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  CUtensorMap tq, tk, tv;
  if (!encode_map(&tq, q, B, Sq, H, D, 64) || !encode_map(&tk, k, B, Sk, Hkv, D, BK) ||
      !encode_map(&tv, v, B, Sk, Hkv, D, BK))
    return cudaErrorInvalidValue;
  const dim3 grid(H, B, (Sq + BQ - 1) / BQ);
  flash_fwd_kernel<D><<<grid, THREADS, SMEM, st>>>(tq, tk, tv, kv_len, out, Sq, Sk, H, Hkv,
                                                   scale_log2, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gofr_flash_attention_bf16(const void* q, const void* k, const void* v,
                                         const void* kv_len, void* out, int B, int Sq,
                                         int Sk, int H, int Hkv, int D, float scale,
                                         int causal, void* stream) {
  if (B <= 0 || Sq <= 0) return (int)cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || B > 65535 || (Sq + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  auto* op = static_cast<uint16_t*>(out);
  if (Sk <= 0)  // no key at all: every row is 0 (a tensor map needs a non-empty S)
    return (int)cudaMemsetAsync(out, 0, (size_t)B * Sq * H * D * 2, st);
  const float scale_log2 = scale * 1.4426950408889634f;
  const auto* lp = static_cast<const int*>(kv_len);
  switch (D) {
    case 64:
      return (int)launch_d<64>(q, k, v, lp, op, B, Sq, Sk, H, Hkv, scale_log2, causal, st);
    case 128:
      return (int)launch_d<128>(q, k, v, lp, op, B, Sq, Sk, H, Hkv, scale_log2, causal, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
