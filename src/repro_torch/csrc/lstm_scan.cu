// Fused persistent-scan LSTM recurrence on Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernels of repro/kernels/cell_scan.py in their
// LSTM instance (repro/kernels/lstm_scan.py, heads = 1):
//   K3  _fwd_kernel via _pallas_fwd  -> lstm_fwd_kernel
//   K4  _bwd_kernel via _pallas_bwd  -> lstm_bwd_kernel
// Forward: gates_t = gx_t + drop(h_{t-1}) @ U, then the pointwise update,
// for all T steps in one launch, saving hs, gates and the c sequence.
// Backward: reverse time; dgates into dgx, compact BP into dh_{t-1},
// compact WG into dU (f32), dh0/dc0; frozen (ragged) steps pass their
// cotangents straight through with zero dgates.
// RH dropout modes: 0 off, 1 structured (a (T|1, k) table of kept unit
// ids; compact gathers, the paper's (1-p) FLOPs), 2 dense ((T|1, B, H)
// mask). A one-row table is the FIXED time pattern.
//
// What bounds it on the H100: the recurrence is serial in T, and one
// step's product is tiny (B=20 rows x k=325 x 2600 columns, ~34 MFLOP),
// far below what one launch per step could fill. The Pallas kernel keeps
// U resident on its one core and the carry in scratch; on Hopper U
// (6.8 MB at H=650) does not fit one SM's 227 KB, so latency per step
// (memory round trips and the grid-wide barrier), not FLOPs or HBM bytes,
// bounds it. Design: one persistent cooperative launch (grid <= one CTA
// per SM, all co-resident) in which each CTA owns a slice of J hidden units
// j and computes their four gate columns {j, H+j, 2H+j, 3H+j} for all B
// rows. Those columns of U stay in shared memory when they fit (H=650:
// 52 KB), else they are read through the 50 MB L2; the compact h_{t-1} is
// staged in shared memory with many loads in flight; the cell state of the
// owned units never leaves shared memory; one grid.sync() per step
// publishes h_t. The backward keeps the same ownership: after one
// grid.sync() per step all dgates are visible, each CTA streams them
// through shared memory in column chunks (cp.async, rows padded off the
// same bank) and computes dh_{t-1} and dU only for its own kept rows j, so
// dU needs no atomics; its rows of U and dU stay in shared memory when
// they fit. Kept rows go in groups of four: WG holds a group's four rows of
// a column in registers, BP a (row, four units) tile, both with 16-byte
// shared loads. Cross-CTA data is read through L2 only (__ldcg,
// cp.async.cg); the forward issues each batch of staging loads with no
// branch between them, so they are in flight together. With one CTA of 8
// warps per SM there is little else to hide latency behind.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;   // threads per CTA
constexpr int RB = 32;    // batch rows per register chunk (forward)
constexpr int LD = 16;    // global loads in flight per thread when staging
constexpr size_t SMEM_MAX = 227 * 1024;

struct ScanArgs {
  int T, B, H;
  int mode;        // 0 off, 1 structured, 2 dense
  int k;           // kept units per ids row (structured)
  int ids_rows;    // 1 (FIXED) or T
  int mask_rows;   // 1 (FIXED) or T
  int ragged;
  int J;           // hidden units per CTA
  float scale;
  float forget_bias;
  int ch;          // dgates columns per backward chunk (multiple of 4)
};

__device__ __forceinline__ float sigm(float x) { return 1.f / (1.f + expf(-x)); }

__host__ __device__ inline size_t al4(size_t n) { return (n + 3) & ~size_t(3); }

// 16-byte global -> shared copy through L2 only (.cg): the source may have
// been written by another SM before the last grid barrier.
__device__ __forceinline__ void cp_async16(float* smem_dst, const float* gmem_src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem_src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// RES: the CTA's U columns (H x 4J) stay resident in shared memory.
template <bool RES>
__global__ void __launch_bounds__(NT)
lstm_fwd_kernel(const float* __restrict__ gx, const float* __restrict__ U,
                const float* __restrict__ h0, const float* __restrict__ c0,
                const int* __restrict__ ids, const float* __restrict__ mask,
                const int* __restrict__ lens, float* hs, float* gates,
                float* cs, ScanArgs p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  const int T = p.T, B = p.B, H = p.H, G = 4 * H, J = p.J;
  const int j0 = blockIdx.x * J;
  const int Jc = min(J, H - j0);
  const int KC = p.mode == 1 ? p.k : H;
  const int C4 = 4 * J;
  const int S = NT / C4;
  float* Us = smem;                       // RES: H x C4 own columns of U
  float* hsm = Us + (RES ? (size_t)H * C4 : 0);  // B x KC compact h_{t-1}
  float* part = hsm + (size_t)B * KC;     // S x RB x C4 partial sums
  float* cst = part + (size_t)S * RB * C4;  // B x J cell-state carry
  int* uid = reinterpret_cast<int*>(cst + (size_t)B * J);  // KC unit ids
  const int tid = threadIdx.x;

  for (int e = tid; e < B * J; e += NT) {
    const int b = e / J, jj = e % J;
    if (jj < Jc) cst[e] = c0[(size_t)b * H + j0 + jj];
  }
  if (RES) {
    for (int e = tid; e < H * C4; e += NT) {
      const int row = e / C4, cc = e % C4, q = cc % J;
      Us[e] = q < Jc ? U[(size_t)row * G + (cc / J) * H + j0 + q] : 0.f;
    }
  }

  const int c = tid % C4, s = tid / C4;
  const int g = c / J, jj = c % J;
  const bool worker = s < S && jj < Jc;
  const int ucol = g * H + j0 + jj;

  for (int t = 0; t < T; ++t) {
    const int row_i = p.ids_rows == 1 ? 0 : t;
    const int row_m = p.mask_rows == 1 ? 0 : t;
    const float* hprev = t == 0 ? h0 : hs + (size_t)(t - 1) * B * H;
    if (p.mode == 1)
      for (int kk = tid; kk < KC; kk += NT) uid[kk] = ids[(size_t)row_i * p.k + kk];
    __syncthreads();
    // LD loads in flight per thread (the loads are L2 round trips): all of a
    // batch are issued unconditionally, with no branch between them
    for (int e0 = tid; e0 < B * KC; e0 += LD * NT) {
      float v[LD];
#pragma unroll
      for (int u = 0; u < LD; ++u) {
        const int e = min(e0 + u * NT, B * KC - 1);
        const int b = e / KC, kk = e - b * KC;
        v[u] = __ldcg(hprev + (size_t)b * H + (p.mode == 1 ? uid[kk] : kk));
      }
      if (p.mode == 2) {
        float m[LD];
#pragma unroll
        for (int u = 0; u < LD; ++u) {
          const int e = min(e0 + u * NT, B * KC - 1);
          const int b = e / KC, kk = e - b * KC;
          m[u] = mask[((size_t)row_m * B + b) * H + kk];
        }
#pragma unroll
        for (int u = 0; u < LD; ++u) v[u] *= m[u] * p.scale;
      }
#pragma unroll
      for (int u = 0; u < LD; ++u)
        if (e0 + u * NT < B * KC) hsm[e0 + u * NT] = v[u];
    }
    __syncthreads();

    for (int b0 = 0; b0 < B; b0 += RB) {
      float acc[RB];
#pragma unroll
      for (int bb = 0; bb < RB; ++bb) acc[bb] = 0.f;
      if (worker) {
#pragma unroll 4
        for (int kk = s; kk < KC; kk += S) {
          const int urow = p.mode == 1 ? uid[kk] : kk;
          const float u = RES ? Us[(size_t)urow * C4 + c] : __ldg(U + (size_t)urow * G + ucol);
          const float* hcol = hsm + kk;
#pragma unroll
          for (int bb = 0; bb < RB; ++bb)
            if (b0 + bb < B) acc[bb] = fmaf(hcol[(size_t)(b0 + bb) * KC], u, acc[bb]);
        }
      }
      if (s < S) {
#pragma unroll
        for (int bb = 0; bb < RB; ++bb) part[((size_t)s * RB + bb) * C4 + c] = acc[bb];
      }
      __syncthreads();
      for (int e = tid; e < RB * J; e += NT) {
        const int bb = e / J, q = e % J, b = b0 + bb;
        if (b >= B || q >= Jc) continue;
        const int j = j0 + q;
        const size_t gofs = ((size_t)t * B + b) * G + j;
        float sum[4] = {0.f, 0.f, 0.f, 0.f};   // four independent chains
        for (int s2 = 0; s2 < S; ++s2) {
          const float* pr = part + ((size_t)s2 * RB + bb) * C4 + q;
#pragma unroll
          for (int g2 = 0; g2 < 4; ++g2) sum[g2] += pr[g2 * J];
        }
        float gv[4];
#pragma unroll
        for (int g2 = 0; g2 < 4; ++g2) {
          if (p.mode == 1) sum[g2] *= p.scale;
          gv[g2] = gx[gofs + (size_t)g2 * H] + sum[g2];
        }
        const float ig = sigm(gv[0]);
        const float fg = sigm(gv[1] + p.forget_bias);
        const float gg = tanhf(gv[2]);
        const float og = sigm(gv[3]);
        const float c_prev = cst[b * J + q];
        float c_new = fg * c_prev + ig * gg;
        float h_new = og * tanhf(c_new);
        if (p.ragged && t >= lens[b]) {       // frozen row: carry t-1 through
          h_new = __ldcg(hprev + (size_t)b * H + j);
          c_new = c_prev;
        }
        cst[b * J + q] = c_new;
        const size_t hofs = ((size_t)t * B + b) * H + j;
        hs[hofs] = h_new;
        cs[hofs] = c_new;
#pragma unroll
        for (int g2 = 0; g2 < 4; ++g2) gates[gofs + (size_t)g2 * H] = gv[g2];
      }
      __syncthreads();
    }
    __threadfence();
    grid.sync();
  }
}

// RES: the CTA's rows of U and of dU (J x 4H each) stay in shared memory.
template <bool RES>
__global__ void __launch_bounds__(NT)
lstm_bwd_kernel(const float* __restrict__ dy, const float* __restrict__ dcT,
                const float* __restrict__ gates, const float* __restrict__ cs,
                const float* __restrict__ c0, const float* __restrict__ hs,
                const float* __restrict__ h0, const float* __restrict__ U,
                const int* __restrict__ ids, const float* __restrict__ mask,
                const int* __restrict__ lens, float* dgx, float* dU,
                float* dh0, float* dc0, ScanArgs p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  const int T = p.T, B = p.B, H = p.H, G = 4 * H, J = p.J;
  const int j0 = blockIdx.x * J;
  const int Jc = min(J, H - j0);
  const int BJ = B * J;
  const int CH = p.ch;
  const int CHP = CH + 4;               // padded row stride: rows in other banks
  const int JK = (J + 3) / 4 * 4;       // kept own units, padded to float4
  // 16-byte aligned regions first (cp.async targets)
  float* dgs = smem;                    // B x CHP dgates chunk
  float* Ur = dgs + (size_t)B * CHP;    // RES: J x G own rows of U
  float* dUr = Ur + (RES ? (size_t)J * G : 0);  // RES: J x G own rows of dU
  float* us = dUr + (RES ? (size_t)J * G : 0);  // !RES: JK x CH rows of U (kept)
  float* dhc = us + (RES ? 0 : (size_t)JK * CH);  // B x J: dL/dh carry of own units
  float* dcc = dhc + BJ;                // B x J: dL/dc carry
  float* hp = dcc + BJ;                 // B x J: h_{r-1} of own units (masked)
  float* hpk = smem + al4(hp + BJ - smem);  // B x JK: hp of the kept own units, compact
  float* red = hpk + (size_t)B * JK;    // 4 NT partial dh sums
  int* flag = reinterpret_cast<int*>(red + 4 * NT);  // J
  int* kl = flag + J;                   // J: local ids of kept own units
  int* nkl_s = kl + J;                  // 1
  const int tid = threadIdx.x;

  for (int e = tid; e < Jc * G; e += NT) {
    if (RES) {
      Ur[e] = U[(size_t)j0 * G + e];
      dUr[e] = 0.f;
    } else {
      dU[(size_t)j0 * G + e] = 0.f;
    }
  }
  for (int e = tid; e < BJ; e += NT) {
    const int b = e / J, q = e % J;
    dhc[e] = 0.f;
    dcc[e] = q < Jc ? dcT[(size_t)b * H + j0 + q] : 0.f;
  }

  for (int r = T - 1; r >= 0; --r) {
    const int row_i = p.ids_rows == 1 ? 0 : r;
    const int row_m = p.mask_rows == 1 ? 0 : r;
    // kept own units at this step
    for (int q = tid; q < J; q += NT) flag[q] = p.mode == 1 ? 0 : (q < Jc);
    __syncthreads();
    if (p.mode == 1) {
      for (int kk = tid; kk < p.k; kk += NT) {
        const int u = ids[(size_t)row_i * p.k + kk];
        if (u >= j0 && u < j0 + Jc) flag[u - j0] = 1;
      }
    }
    __syncthreads();
    if (tid == 0) {
      int n = 0;
      for (int q = 0; q < Jc; ++q)
        if (flag[q]) kl[n++] = q;
      *nkl_s = n;
    }
    // phase 1: dgates of own units (pointwise reverse), written to dgx
    for (int e = tid; e < BJ; e += NT) {
      const int b = e / J, q = e % J;
      if (q >= Jc) continue;
      const int j = j0 + q;
      const size_t hofs = ((size_t)r * B + b) * H + j;
      const size_t gofs = ((size_t)r * B + b) * G + j;
      const float dh = dy[hofs] + dhc[e];
      const float dc_in = dcc[e];
      const bool act = !p.ragged || r < lens[b];
      const float dh_c = act ? dh : 0.f;
      const float dc_c = act ? dc_in : 0.f;
      const float ig = sigm(gates[gofs]);
      const float fg = sigm(gates[gofs + H] + p.forget_bias);
      const float gg = tanhf(gates[gofs + 2 * (size_t)H]);
      const float og = sigm(gates[gofs + 3 * (size_t)H]);
      const float cc = cs[hofs];
      const float c_prev = r > 0 ? cs[hofs - (size_t)B * H] : c0[(size_t)b * H + j];
      const float tc = tanhf(cc);
      const float do_ = dh_c * tc;
      const float dc = dc_c + dh_c * og * (1.f - tc * tc);
      dgx[gofs] = dc * gg * ig * (1.f - ig);
      dgx[gofs + H] = dc * c_prev * fg * (1.f - fg);
      dgx[gofs + 2 * (size_t)H] = dc * ig * (1.f - gg * gg);
      dgx[gofs + 3 * (size_t)H] = do_ * og * (1.f - og);
      dcc[e] = dc * fg + (act ? 0.f : dc_in);
      dhc[e] = act ? 0.f : dh;         // pass-through; BP is added below
      float h = r > 0 ? hs[hofs - (size_t)B * H] : h0[(size_t)b * H + j];
      if (p.mode == 2) h *= mask[((size_t)row_m * B + b) * H + j] * p.scale;
      hp[e] = h;
    }
    __threadfence();
    grid.sync();

    // phase 2: dh_{r-1} and dU for the kept own rows j, over dgates chunks.
    // Kept rows go in groups of 4: WG keeps a group's 4 rows of a column in
    // registers (hp of the group as one 16-byte load), BP computes a tile
    // (row b, 4 kept units) over a K-split of the chunk with 16-byte loads.
    const int nkl = *nkl_s;
    const int ngr = (nkl + 3) / 4;                 // groups of kept units
    const int tiles = B * ngr;
    const int KS = tiles == 0 ? 1 : NT / tiles;
    const int tile = tiles == 0 ? 0 : tid % tiles, ks = tiles == 0 ? NT : tid / tiles;
    const int tb = tiles == 0 ? 0 : tile / ngr, tgr = tiles == 0 ? 0 : tile % ngr;
    const float sc = p.mode == 1 ? p.scale : 1.f;
    for (int e = tid; e < B * JK; e += NT) {
      const int b = e / JK, qi = e % JK;
      hpk[e] = qi < nkl ? hp[b * J + kl[qi]] : 0.f;
    }
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int ch0 = 0; ch0 < G; ch0 += CH) {
      const int cw = min(CH, G - ch0);   // G and CH are multiples of 4
      const int n4 = CH / 4;
      // stage the chunk with asynchronous 16-byte copies, all in flight
      for (int e = tid; e < B * n4; e += NT) {
        const int b = e / n4, c4 = (e % n4) * 4;
        float* dst = dgs + (size_t)b * CHP + c4;
        if (c4 < cw) {
          cp_async16(dst, dgx + ((size_t)r * B + b) * G + ch0 + c4);
        } else {
          dst[0] = dst[1] = dst[2] = dst[3] = 0.f;
        }
      }
      if (!RES) {
        for (int e = tid; e < JK * n4; e += NT) {
          const int q = e / n4, c4 = (e % n4) * 4;
          float* dst = us + (size_t)q * CH + c4;
          if (c4 < cw && q < nkl) {
            cp_async16(dst, U + (size_t)(j0 + kl[q]) * G + ch0 + c4);
          } else {
            dst[0] = dst[1] = dst[2] = dst[3] = 0.f;
          }
        }
      }
      cp_async_wait_all();
      __syncthreads();
      // WG: (group, column) per thread, the group's 4 rows in registers
      const float4* hp4 = reinterpret_cast<const float4*>(hpk);
      for (int e = tid; e < ngr * cw; e += NT) {
        const int gr = e / cw, c = e % cw;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 4
        for (int b = 0; b < B; ++b) {
          const float g = dgs[b * CHP + c];
          const float4 h = hp4[b * (JK / 4) + gr];
          a0 = fmaf(h.x, g, a0);
          a1 = fmaf(h.y, g, a1);
          a2 = fmaf(h.z, g, a2);
          a3 = fmaf(h.w, g, a3);
        }
        const float av[4] = {a0, a1, a2, a3};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = gr * 4 + i;
          if (qi < nkl) {
            const int jl = kl[qi];
            float* drow = RES ? dUr + (size_t)jl * G : dU + (size_t)(j0 + jl) * G;
            drow[ch0 + c] += av[i] * sc;
          }
        }
      }
      // BP: tile (row tb, kept units 4 tgr .. 4 tgr + 3) over K-split ks
      if (ks < KS) {
        const float4* dg4 = reinterpret_cast<const float4*>(dgs + (size_t)tb * CHP);
        const float4* u4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = min(tgr * 4 + i, nkl - 1);
          u4[i] = reinterpret_cast<const float4*>(
              RES ? Ur + (size_t)kl[qi] * G + ch0 : us + (size_t)qi * CH);
        }
        for (int c4 = ks; c4 < cw / 4; c4 += KS) {
          const float4 g = dg4[c4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 w = u4[i][c4];
            acc[i] += g.x * w.x + g.y * w.y + g.z * w.z + g.w * w.w;
          }
        }
      }
      __syncthreads();
    }
    if (tiles > 0) {
      if (ks < KS)
#pragma unroll
        for (int i = 0; i < 4; ++i) red[((size_t)ks * tiles + tile) * 4 + i] = acc[i];
      __syncthreads();
      for (int o = tid; o < B * nkl; o += NT) {
        const int b = o / nkl, qi = o % nkl, jl = kl[qi];
        const int tl = b * ngr + qi / 4;
        float v = 0.f;
        for (int k2 = 0; k2 < KS; ++k2) v += red[((size_t)k2 * tiles + tl) * 4 + qi % 4];
        if (p.mode == 2) v *= mask[((size_t)row_m * B + b) * H + j0 + jl] * p.scale;
        dhc[b * J + jl] += v * sc;
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < BJ; e += NT) {
    const int b = e / J, q = e % J;
    if (q >= Jc) continue;
    dh0[(size_t)b * H + j0 + q] = dhc[e];
    dc0[(size_t)b * H + j0 + q] = dcc[e];
  }
  if (RES)
    for (int e = tid; e < Jc * G; e += NT) dU[(size_t)j0 * G + e] = dUr[e];
}

size_t fwd_smem(const ScanArgs& p, bool res) {
  const int KC = p.mode == 1 ? p.k : p.H;
  const int C4 = 4 * p.J;
  const int S = NT / C4;
  return sizeof(float) * ((res ? (size_t)p.H * C4 : 0) + (size_t)p.B * KC +
                          (size_t)S * RB * C4 + (size_t)p.B * p.J) +
         sizeof(int) * (size_t)KC;
}

size_t bwd_smem(const ScanArgs& p, bool res) {
  const size_t JK = ((size_t)p.J + 3) / 4 * 4;
  return sizeof(float) * ((size_t)p.B * (p.ch + 4) + (res ? 2 * (size_t)p.J * 4 * p.H
                                                    : JK * p.ch) +
                          al4(3 * (size_t)p.B * p.J) + (size_t)p.B * JK + 4 * NT) +
         sizeof(int) * (2 * (size_t)p.J + 1);
}

// Fills p.J and the grid size; returns a CUDA error code (0 = launchable).
int plan_launch(ScanArgs* p, const void* kernel, size_t smem, int* grid) {
  int dev = 0, sms = 0, coop = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, smem);
  if (err != cudaSuccess) return (int)err;
  *grid = (p->H + p->J - 1) / p->J;
  if (per_sm * sms < *grid) return (int)cudaErrorCooperativeLaunchTooLarge;
  return 0;
}

int units_per_cta(int H) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return (H + sms - 1) / sms;
}

}  // namespace

// gx (T, B, 4H) with the bias folded in; U (H, 4H); h0, c0 (B, H);
// ids (ids_rows, k) int32 unit ids (mode 1); mask (mask_rows, B, H) (mode 2);
// lens (B,) int32 when ragged. Outputs hs, cs (T, B, H) and gates (T, B, 4H).
extern "C" int lstm_scan_fwd_f32(const float* gx, const float* U, const float* h0,
                                 const float* c0, const int* ids, const float* mask,
                                 const int* lens, float* hs, float* gates, float* cs,
                                 int T, int B, int H, int mode, int k, int ids_rows,
                                 int mask_rows, int ragged, float scale,
                                 float forget_bias, void* stream) {
  cudaGetLastError();
  if (T <= 0 || B <= 0) return 0;
  ScanArgs p{T, B, H, mode, k, ids_rows, mask_rows, ragged, units_per_cta(H), scale,
             forget_bias, 0};
  if (4 * p.J > NT) return (int)cudaErrorInvalidValue;
  // U resident in shared memory when it fits, else read through L2.
  const bool res = fwd_smem(p, true) <= SMEM_MAX;
  const void* kernel = res ? (const void*)lstm_fwd_kernel<true>
                           : (const void*)lstm_fwd_kernel<false>;
  const size_t smem = fwd_smem(p, res);
  int grid = 0;
  int code = plan_launch(&p, kernel, smem, &grid);
  if (code) return code;
  void* args[] = {&gx, &U, &h0, &c0, &ids, &mask, &lens, &hs, &gates, &cs, &p};
  cudaError_t err = cudaLaunchCooperativeKernel(kernel, dim3(grid),
                                                dim3(NT), args, smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// dy (T, B, H): dL/dhs with dL/dh_T already added at T-1; dcT (B, H);
// gates/cs/hs from the forward; outputs dgx (T, B, 4H), dU (H, 4H) (f32,
// zeroed by the kernel), dh0, dc0 (B, H).
extern "C" int lstm_scan_bwd_f32(const float* dy, const float* dcT, const float* gates,
                                 const float* cs, const float* c0, const float* hs,
                                 const float* h0, const float* U, const int* ids,
                                 const float* mask, const int* lens, float* dgx,
                                 float* dU, float* dh0, float* dc0, int T, int B, int H,
                                 int mode, int k, int ids_rows, int mask_rows, int ragged,
                                 float scale, float forget_bias, void* stream) {
  cudaGetLastError();
  if (T <= 0 || B <= 0) return 0;
  ScanArgs p{T, B, H, mode, k, ids_rows, mask_rows, ragged, units_per_cta(H), scale,
             forget_bias, 0};
  if (4 * p.J > NT || B * ((p.J + 3) / 4) > NT) return (int)cudaErrorInvalidValue;
  // Prefer U and dU rows resident in shared memory, then wide dgates chunks.
  bool res = false;
  for (int pick = 0; pick < 4; ++pick) {
    res = pick < 2;
    p.ch = pick % 2 == 0 ? 1024 : 256;
    if (bwd_smem(p, res) <= SMEM_MAX) break;
  }
  const void* kernel = res ? (const void*)lstm_bwd_kernel<true>
                           : (const void*)lstm_bwd_kernel<false>;
  const size_t smem = bwd_smem(p, res);
  int grid = 0;
  int code = plan_launch(&p, kernel, smem, &grid);
  if (code) return code;
  void* args[] = {&dy, &dcT, &gates, &cs, &c0, &hs, &h0, &U, &ids, &mask, &lens,
                  &dgx, &dU, &dh0, &dc0, &p};
  cudaError_t err = cudaLaunchCooperativeKernel(kernel, dim3(grid),
                                                dim3(NT), args, smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
