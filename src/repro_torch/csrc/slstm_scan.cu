// Fused persistent-scan sLSTM recurrence on Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernels of repro/kernels/cell_scan.py in their
// sLSTM instance (repro/kernels/slstm_scan.py, SLSTM_CELL), K6:
//   _fwd_kernel via _pallas_fwd  -> slstm_fwd_kernel
//   _bwd_kernel via _pallas_bwd  -> slstm_bwd_kernel
// Forward: gates_t = xg_t + drop(h_{t-1}) @ R per head (R block-diagonal,
// (NH, dh, 4dh), gate order i, f, z, o), then the exponential-gating update
// with the (c, n, m) cell / normalizer / stabilizer carries, for all T steps
// in one launch, saving hs, gates and the c, n, m sequences.
// Backward: reverse time; dgates into dgx, compact BP into dh_{t-1}, compact
// WG into dR (f32, kept rows only), dh0/dc0/dn0/dm0; frozen (ragged) steps
// give exactly zero dgates and pass their cotangents straight through.
// RH dropout over dh, shared across heads: 0 off, 1 structured (a (T|1, k)
// table of kept unit ids; compact gathers, the paper's (1-p) FLOPs),
// 2 dense ((T|1, B, 1|NH, dh) mask). A one-row table is FIXED.
//
// Numerics: built without fast math, so expf, log1pf and the divisions are
// IEEE. The fresh-start stabilizer m0 = -1e30 stays finite: lf + m - m_new
// is then about -1e30 and expf gives exactly 0. log-sigmoid is the stable
// two-branch min(x, 0) - log1p(exp(-|x|)). The backward re-evaluates the
// stabilizer's branch (lf + m_prev >= gi, ties to forget) from the gates and
// m values that the forward stored.
//
// What bounds it on the H100: the recurrence is serial in T, and one step's
// product is tiny (xlstm-1.3b: B=2 rows x k=384 kept units x 2048 columns
// per head, 4 heads, ~12.6 MFLOP), so latency per step (L2 round trips and
// the grid-wide barrier), not FLOPs or HBM bytes, bounds it. R is 16.8 MB
// at NH=4, dh=512, which fits no SM. Design, as K3/K4 (csrc/lstm_scan.cu)
// with a head axis: one persistent cooperative launch in which each CTA
// owns J units of ONE head and computes their four gate columns
// {u, dh+u, 2dh+u, 3dh+u}; those columns of its head's R (dh x 4J, 128 KB
// at J=16) stay in shared memory when they fit, else they are read through
// L2. Each step stages only its own head's compact h_{t-1} (B x k), the
// carries of the owned units never leave shared memory, and one grid.sync()
// per step publishes h_t (heads are independent, so one barrier per head is
// possible; not done here). The backward keeps the ownership: after one
// grid.sync() per step each CTA streams its own head's dgates (B x 4dh)
// through shared memory in column chunks (cp.async) beside the R rows of its
// kept units (through L2: R rows and dR rows together would not fit), and
// computes dh_{t-1} and dR only for its own kept rows, so dR needs no
// atomics; its dR rows stay in shared memory when they fit.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;   // threads per CTA
constexpr int RB = 8;     // batch rows per register chunk (forward)
constexpr int LD = 16;    // global loads in flight per thread when staging
constexpr size_t SMEM_MAX = 227 * 1024;
constexpr float EPS = 1e-6f;   // normalizer floor

struct ScanArgs {
  int T, B, NH, D;   // D = dh, units per head
  int mode;          // 0 off, 1 structured, 2 dense
  int k;             // kept units per ids row (structured)
  int ids_rows;      // 1 (FIXED) or T
  int mask_rows;     // 1 (FIXED) or T
  int mask_heads;    // 1 (shared across heads) or NH
  int ragged;
  int J;             // units per CTA (all of one head)
  int cph;           // CTAs per head
  float scale;
  int ch;            // dgates columns per backward chunk (multiple of 4)
};

__device__ __forceinline__ float sigm(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float log_sigm(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

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

__device__ __forceinline__ size_t mask_at(const ScanArgs& p, int row, int b, int hd, int u) {
  return (((size_t)row * p.B + b) * p.mask_heads + (p.mask_heads == 1 ? 0 : hd)) * p.D + u;
}

// RES: the CTA's R columns (D x 4J) stay resident in shared memory.
template <bool RES>
__global__ void __launch_bounds__(NT)
slstm_fwd_kernel(const float* __restrict__ gx, const float* __restrict__ R,
                 const float* __restrict__ h0, const float* __restrict__ c0,
                 const float* __restrict__ n0, const float* __restrict__ m0,
                 const int* __restrict__ ids, const float* __restrict__ mask,
                 const int* __restrict__ lens, float* hs, float* gates, float* cs,
                 float* ns, float* ms, ScanArgs p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  const int T = p.T, B = p.B, NH = p.NH, D = p.D, G = 4 * D, J = p.J;
  const int hd = blockIdx.x / p.cph;
  const int j0 = (blockIdx.x % p.cph) * J;
  const int Jc = min(J, D - j0);
  const int KC = p.mode == 1 ? p.k : D;
  const int C4 = 4 * J;
  const int S = NT / C4;
  const float* Rh = R + (size_t)hd * D * G;
  float* Rs = smem;                                 // RES: D x C4 own columns of R
  float* hsm = Rs + (RES ? (size_t)D * C4 : 0);     // B x KC compact h_{t-1}
  float* part = hsm + (size_t)B * KC;               // S x RB x C4 partial sums
  float* hc = part + (size_t)S * RB * C4;           // B x J carries: h, c, n, m
  float* cc = hc + (size_t)B * J;
  float* nc = cc + (size_t)B * J;
  float* mc = nc + (size_t)B * J;
  int* uid = reinterpret_cast<int*>(mc + (size_t)B * J);  // KC unit ids
  const int tid = threadIdx.x;

  for (int e = tid; e < B * J; e += NT) {
    const int b = e / J, q = e % J;
    if (q >= Jc) continue;
    const size_t o = ((size_t)b * NH + hd) * D + j0 + q;
    hc[e] = h0[o];
    cc[e] = c0[o];
    nc[e] = n0[o];
    mc[e] = m0[o];
  }
  if (RES) {
    for (int e = tid; e < D * C4; e += NT) {
      const int row = e / C4, col = e % C4, q = col % J;
      Rs[e] = q < Jc ? Rh[(size_t)row * G + (col / J) * D + j0 + q] : 0.f;
    }
  }

  const int c = tid % C4, s = tid / C4;
  const int g = c / J, jj = c % J;
  const bool worker = s < S && jj < Jc;
  const int rcol = g * D + j0 + jj;
  const size_t step_h = (size_t)B * NH * D;

  for (int t = 0; t < T; ++t) {
    const int row_i = p.ids_rows == 1 ? 0 : t;
    const int row_m = p.mask_rows == 1 ? 0 : t;
    const float* hprev = t == 0 ? h0 : hs + (size_t)(t - 1) * step_h;
    if (p.mode == 1)
      for (int kk = tid; kk < KC; kk += NT) uid[kk] = ids[(size_t)row_i * p.k + kk];
    __syncthreads();
    // this head's compact h_{t-1}; LD loads in flight per thread, issued
    // with no branch between them
    for (int e0 = tid; e0 < B * KC; e0 += LD * NT) {
      float v[LD];
#pragma unroll
      for (int u = 0; u < LD; ++u) {
        const int e = min(e0 + u * NT, B * KC - 1);
        const int b = e / KC, kk = e - b * KC;
        v[u] = __ldcg(hprev + ((size_t)b * NH + hd) * D + (p.mode == 1 ? uid[kk] : kk));
      }
      if (p.mode == 2) {
        float m[LD];
#pragma unroll
        for (int u = 0; u < LD; ++u) {
          const int e = min(e0 + u * NT, B * KC - 1);
          const int b = e / KC, kk = e - b * KC;
          m[u] = mask[mask_at(p, row_m, b, hd, kk)];
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
          const float r = RES ? Rs[(size_t)urow * C4 + c] : __ldg(Rh + (size_t)urow * G + rcol);
          const float* hcol = hsm + kk;
#pragma unroll
          for (int bb = 0; bb < RB; ++bb)
            if (b0 + bb < B) acc[bb] = fmaf(hcol[(size_t)(b0 + bb) * KC], r, acc[bb]);
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
        const size_t row = ((size_t)t * B + b) * NH + hd;
        const size_t gofs = row * G + j0 + q;
        const size_t hofs = row * D + j0 + q;
        float sum[4] = {0.f, 0.f, 0.f, 0.f};
        for (int s2 = 0; s2 < S; ++s2) {
          const float* pr = part + ((size_t)s2 * RB + bb) * C4 + q;
#pragma unroll
          for (int g2 = 0; g2 < 4; ++g2) sum[g2] += pr[g2 * J];
        }
        float gv[4];
#pragma unroll
        for (int g2 = 0; g2 < 4; ++g2) {
          if (p.mode == 1) sum[g2] *= p.scale;
          gv[g2] = gx[gofs + (size_t)g2 * D] + sum[g2];
        }
        const int o = b * J + q;
        const float c_prev = cc[o], n_prev = nc[o], m_prev = mc[o];
        float h_new, c_new, n_new, m_new;
        if (p.ragged && t >= lens[b]) {       // frozen row: carry t-1 through
          h_new = hc[o];
          c_new = c_prev;
          n_new = n_prev;
          m_new = m_prev;
        } else {
          const float lfm = log_sigm(gv[1]) + m_prev;
          m_new = fmaxf(lfm, gv[0]);          // stabilizer
          const float ig = expf(gv[0] - m_new);
          const float fg = expf(lfm - m_new);
          const float z = tanhf(gv[2]);
          const float og = sigm(gv[3]);
          c_new = fg * c_prev + ig * z;
          n_new = fg * n_prev + ig;
          h_new = og * (c_new / fmaxf(n_new, EPS));
        }
        hc[o] = h_new;
        cc[o] = c_new;
        nc[o] = n_new;
        mc[o] = m_new;
        hs[hofs] = h_new;
        cs[hofs] = c_new;
        ns[hofs] = n_new;
        ms[hofs] = m_new;
#pragma unroll
        for (int g2 = 0; g2 < 4; ++g2) gates[gofs + (size_t)g2 * D] = gv[g2];
      }
      __syncthreads();
    }
    __threadfence();
    grid.sync();
  }
}

// DRES: the CTA's rows of dR (J x 4dh) stay in shared memory; R rows are
// always staged through L2 chunk by chunk.
template <bool DRES>
__global__ void __launch_bounds__(NT)
slstm_bwd_kernel(const float* __restrict__ dy, const float* __restrict__ dcT,
                 const float* __restrict__ dnT, const float* __restrict__ dmT,
                 const float* __restrict__ gates, const float* __restrict__ cs,
                 const float* __restrict__ ns, const float* __restrict__ ms,
                 const float* __restrict__ c0, const float* __restrict__ n0,
                 const float* __restrict__ m0, const float* __restrict__ hs,
                 const float* __restrict__ h0, const float* __restrict__ R,
                 const int* __restrict__ ids, const float* __restrict__ mask,
                 const int* __restrict__ lens, float* dgx, float* dR, float* dh0,
                 float* dc0, float* dn0, float* dm0, ScanArgs p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  const int T = p.T, B = p.B, NH = p.NH, D = p.D, G = 4 * D, J = p.J;
  const int hd = blockIdx.x / p.cph;
  const int j0 = (blockIdx.x % p.cph) * J;
  const int Jc = min(J, D - j0);
  const int BJ = B * J;
  const int CH = p.ch;
  const int CHP = CH + 4;               // padded row stride: rows in other banks
  const int JK = (J + 3) / 4 * 4;       // kept own units, padded to float4
  const float* Rh = R + (size_t)hd * D * G;
  float* dRh = dR + (size_t)hd * D * G;
  const size_t step_h = (size_t)B * NH * D;
  // 16-byte aligned regions first (cp.async targets)
  float* dgs = smem;                    // B x CHP dgates chunk
  float* dRr = dgs + (size_t)B * CHP;   // DRES: J x G own rows of dR
  float* us = dRr + (DRES ? (size_t)J * G : 0);  // JK x CH rows of R (kept)
  float* dhc = us + (size_t)JK * CH;    // B x J carries: dL/dh, dc, dn, dm
  float* dcc = dhc + BJ;
  float* dnc = dcc + BJ;
  float* dmc = dnc + BJ;
  float* hp = dmc + BJ;                 // B x J: h_{r-1} of own units (masked)
  float* hpk = smem + al4(hp + BJ - smem);  // B x JK: hp of the kept own units
  float* red = hpk + (size_t)B * JK;    // 4 NT partial dh sums
  int* flag = reinterpret_cast<int*>(red + 4 * NT);  // J
  int* kl = flag + J;                   // J: local ids of kept own units
  int* nkl_s = kl + J;                  // 1
  const int tid = threadIdx.x;

  for (int e = tid; e < Jc * G; e += NT) {
    if (DRES) dRr[e] = 0.f;
    else dRh[(size_t)j0 * G + e] = 0.f;
  }
  for (int e = tid; e < BJ; e += NT) {
    const int b = e / J, q = e % J;
    const size_t o = ((size_t)b * NH + hd) * D + j0 + q;
    dhc[e] = 0.f;
    dcc[e] = q < Jc ? dcT[o] : 0.f;
    dnc[e] = q < Jc ? dnT[o] : 0.f;
    dmc[e] = q < Jc ? dmT[o] : 0.f;
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
      const size_t row = ((size_t)r * B + b) * NH + hd;
      const size_t hofs = row * D + j;
      const size_t gofs = row * G + j;
      const size_t o0 = ((size_t)b * NH + hd) * D + j;
      const float dh = dy[hofs] + dhc[e];
      if (!p.ragged || r < lens[b]) {
        const float gi = gates[gofs], gf = gates[gofs + D];
        const float gz = gates[gofs + 2 * (size_t)D], go = gates[gofs + 3 * (size_t)D];
        const float cn = cs[hofs], nn = ns[hofs], mn = ms[hofs];
        const float c_prev = r > 0 ? cs[hofs - step_h] : c0[o0];
        const float n_prev = r > 0 ? ns[hofs - step_h] : n0[o0];
        const float m_prev = r > 0 ? ms[hofs - step_h] : m0[o0];
        const float lfm = log_sigm(gf) + m_prev;
        const float ig = expf(gi - mn);
        const float fg = expf(lfm - mn);
        const float z = tanhf(gz);
        const float og = sigm(go);
        const float inv = 1.f / fmaxf(nn, EPS);
        const float do_ = dh * cn * inv;
        const float dc_t = dcc[e] + dh * og * inv;
        const float dn_t = dnc[e] - (nn > EPS ? dh * og * cn * inv * inv : 0.f);
        const float df = dc_t * c_prev + dn_t * n_prev;
        const float di = dc_t * z + dn_t;
        const float dz = dc_t * ig;
        const float dm_t = dmc[e] - di * ig - df * fg;
        const bool sel = lfm >= gi;           // ties to the forget branch
        const float dgi = di * ig + (sel ? 0.f : dm_t);
        const float dlf = df * fg + (sel ? dm_t : 0.f);
        dgx[gofs] = dgi;
        dgx[gofs + D] = dlf * sigm(-gf);
        dgx[gofs + 2 * (size_t)D] = dz * (1.f - z * z);
        dgx[gofs + 3 * (size_t)D] = do_ * og * (1.f - og);
        dcc[e] = dc_t * fg;
        dnc[e] = dn_t * fg;
        dmc[e] = dlf;
        dhc[e] = 0.f;                   // BP is added below
      } else {                          // frozen: zero dgates, pass through
#pragma unroll
        for (int g2 = 0; g2 < 4; ++g2) dgx[gofs + (size_t)g2 * D] = 0.f;
        dhc[e] = dh;
      }
      float h = r > 0 ? hs[hofs - step_h] : h0[o0];
      if (p.mode == 2) h *= mask[mask_at(p, row_m, b, hd, j)] * p.scale;
      hp[e] = h;
    }
    __threadfence();
    grid.sync();

    // phase 2: dh_{r-1} and dR for the kept own rows j, over chunks of this
    // head's dgates. Kept rows go in groups of 4: WG keeps a group's 4 rows
    // of a column in registers, BP computes a tile (row b, 4 kept units)
    // over a K-split of the chunk with 16-byte loads.
    const int nkl = *nkl_s;
    const int ngr = (nkl + 3) / 4;
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
      for (int e = tid; e < B * n4; e += NT) {
        const int b = e / n4, c4 = (e % n4) * 4;
        float* dst = dgs + (size_t)b * CHP + c4;
        if (c4 < cw) {
          cp_async16(dst, dgx + (((size_t)r * B + b) * NH + hd) * G + ch0 + c4);
        } else {
          dst[0] = dst[1] = dst[2] = dst[3] = 0.f;
        }
      }
      for (int e = tid; e < JK * n4; e += NT) {
        const int q = e / n4, c4 = (e % n4) * 4;
        float* dst = us + (size_t)q * CH + c4;
        if (c4 < cw && q < nkl) {
          cp_async16(dst, Rh + (size_t)(j0 + kl[q]) * G + ch0 + c4);
        } else {
          dst[0] = dst[1] = dst[2] = dst[3] = 0.f;
        }
      }
      cp_async_wait_all();
      __syncthreads();
      // WG: (group, column) per thread, the group's 4 rows in registers
      const float4* hp4 = reinterpret_cast<const float4*>(hpk);
      for (int e = tid; e < ngr * cw; e += NT) {
        const int gr = e / cw, col = e % cw;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 4
        for (int b = 0; b < B; ++b) {
          const float gv = dgs[b * CHP + col];
          const float4 h = hp4[b * (JK / 4) + gr];
          a0 = fmaf(h.x, gv, a0);
          a1 = fmaf(h.y, gv, a1);
          a2 = fmaf(h.z, gv, a2);
          a3 = fmaf(h.w, gv, a3);
        }
        const float av[4] = {a0, a1, a2, a3};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = gr * 4 + i;
          if (qi < nkl) {
            const int jl = kl[qi];
            float* drow = DRES ? dRr + (size_t)jl * G : dRh + (size_t)(j0 + jl) * G;
            drow[ch0 + col] += av[i] * sc;
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
          u4[i] = reinterpret_cast<const float4*>(us + (size_t)qi * CH);
        }
        for (int c4 = ks; c4 < cw / 4; c4 += KS) {
          const float4 gv = dg4[c4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 w = u4[i][c4];
            acc[i] += gv.x * w.x + gv.y * w.y + gv.z * w.z + gv.w * w.w;
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
        if (p.mode == 2) v *= mask[mask_at(p, row_m, b, hd, j0 + jl)] * p.scale;
        dhc[b * J + jl] += v * sc;
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < BJ; e += NT) {
    const int b = e / J, q = e % J;
    if (q >= Jc) continue;
    const size_t o = ((size_t)b * NH + hd) * D + j0 + q;
    dh0[o] = dhc[e];
    dc0[o] = dcc[e];
    dn0[o] = dnc[e];
    dm0[o] = dmc[e];
  }
  if (DRES)
    for (int e = tid; e < Jc * G; e += NT) dRh[(size_t)j0 * G + e] = dRr[e];
}

size_t fwd_smem(const ScanArgs& p, bool res) {
  const int KC = p.mode == 1 ? p.k : p.D;
  const int C4 = 4 * p.J;
  const int S = NT / C4;
  return sizeof(float) * ((res ? (size_t)p.D * C4 : 0) + (size_t)p.B * KC +
                          (size_t)S * RB * C4 + 4 * (size_t)p.B * p.J) +
         sizeof(int) * (size_t)KC;
}

size_t bwd_smem(const ScanArgs& p, bool dres) {
  const size_t JK = ((size_t)p.J + 3) / 4 * 4;
  return sizeof(float) * ((size_t)p.B * (p.ch + 4) + (dres ? (size_t)p.J * 4 * p.D : 0) +
                          JK * p.ch + al4(5 * (size_t)p.B * p.J) + (size_t)p.B * JK +
                          4 * NT) +
         sizeof(int) * (2 * (size_t)p.J + 1);
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// Sets the kernel's shared memory and checks that the grid of p->NH x
// p->cph CTAs is co-resident; returns a CUDA error code (0 = launchable).
int check_launch(const ScanArgs& p, const void* kernel, size_t smem) {
  int dev = 0, coop = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm * sm_count() < p.NH * p.cph) return (int)cudaErrorCooperativeLaunchTooLarge;
  return 0;
}

// The fewest units per CTA, J >= ceil(NH dh / SMs), for which one CTA per
// (head, slice of J units) fits on the card, one CTA per SM.
void set_units(ScanArgs* p) {
  const int sms = sm_count();
  p->J = (p->NH * p->D + sms - 1) / sms;
  for (;;) {
    p->cph = (p->D + p->J - 1) / p->J;
    if (p->NH * p->cph <= sms || p->J >= p->D) break;
    ++p->J;
  }
}

}  // namespace

// xg (T, B, NH, 4dh) with the bias folded in; R (NH, dh, 4dh); h0, c0, n0,
// m0 (B, NH, dh); ids (ids_rows, k) int32 unit ids (mode 1); mask
// (mask_rows, B, mask_heads, dh) (mode 2); lens (B,) int32 when ragged.
// Outputs hs, cs, ns, ms (T, B, NH, dh) and gates (T, B, NH, 4dh).
extern "C" int slstm_scan_fwd_f32(const float* gx, const float* R, const float* h0,
                                  const float* c0, const float* n0, const float* m0,
                                  const int* ids, const float* mask, const int* lens,
                                  float* hs, float* gates, float* cs, float* ns, float* ms,
                                  int T, int B, int NH, int D, int mode, int k, int ids_rows,
                                  int mask_rows, int mask_heads, int ragged, float scale,
                                  void* stream) {
  cudaGetLastError();
  if (T <= 0 || B <= 0) return 0;
  ScanArgs p{T, B, NH, D, mode, k, ids_rows, mask_rows, mask_heads, ragged, 0, 0, scale, 0};
  set_units(&p);
  if (4 * p.J > NT) return (int)cudaErrorInvalidValue;
  // R columns resident in shared memory when they fit, else read through L2.
  const bool res = fwd_smem(p, true) <= SMEM_MAX;
  const void* kernel = res ? (const void*)slstm_fwd_kernel<true>
                           : (const void*)slstm_fwd_kernel<false>;
  const size_t smem = fwd_smem(p, res);
  int code = check_launch(p, kernel, smem);
  if (code) return code;
  void* args[] = {&gx, &R, &h0, &c0, &n0, &m0, &ids, &mask, &lens,
                  &hs, &gates, &cs, &ns, &ms, &p};
  cudaError_t err = cudaLaunchCooperativeKernel(kernel, dim3(NH * p.cph), dim3(NT), args,
                                                smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// dy (T, B, NH, dh): dL/dhs with dL/dh_T already added at T-1; dcT, dnT, dmT
// (B, NH, dh); gates, cs, ns, ms, hs from the forward. Outputs dgx
// (T, B, NH, 4dh), dR (NH, dh, 4dh) (f32, zeroed by the kernel), dh0, dc0,
// dn0, dm0 (B, NH, dh).
extern "C" int slstm_scan_bwd_f32(const float* dy, const float* dcT, const float* dnT,
                                  const float* dmT, const float* gates, const float* cs,
                                  const float* ns, const float* ms, const float* c0,
                                  const float* n0, const float* m0, const float* hs,
                                  const float* h0, const float* R, const int* ids,
                                  const float* mask, const int* lens, float* dgx, float* dR,
                                  float* dh0, float* dc0, float* dn0, float* dm0, int T,
                                  int B, int NH, int D, int mode, int k, int ids_rows,
                                  int mask_rows, int mask_heads, int ragged, float scale,
                                  void* stream) {
  cudaGetLastError();
  if (T <= 0 || B <= 0) return 0;
  ScanArgs p{T, B, NH, D, mode, k, ids_rows, mask_rows, mask_heads, ragged, 0, 0, scale, 0};
  set_units(&p);
  if (B * ((p.J + 3) / 4) > NT) return (int)cudaErrorInvalidValue;
  // Prefer dR rows resident in shared memory, then wide dgates chunks.
  bool dres = false;
  bool fits = false;
  for (int pick = 0; pick < 6 && !fits; ++pick) {
    dres = pick < 3;
    p.ch = 1024 >> (pick % 3);
    fits = bwd_smem(p, dres) <= SMEM_MAX;
  }
  if (!fits) return (int)cudaErrorInvalidValue;
  const void* kernel = dres ? (const void*)slstm_bwd_kernel<true>
                            : (const void*)slstm_bwd_kernel<false>;
  const size_t smem = bwd_smem(p, dres);
  int code = check_launch(p, kernel, smem);
  if (code) return code;
  void* args[] = {&dy, &dcT, &dnT, &dmT, &gates, &cs, &ns, &ms, &c0, &n0, &m0, &hs, &h0,
                  &R, &ids, &mask, &lens, &dgx, &dR, &dh0, &dc0, &dn0, &dm0, &p};
  cudaError_t err = cudaLaunchCooperativeKernel(kernel, dim3(NH * p.cph), dim3(NT), args,
                                                smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
