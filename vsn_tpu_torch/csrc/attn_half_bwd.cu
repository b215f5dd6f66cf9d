// K1b: the Swin attention half-block, backward.
//
//   out = lam * x + gf[s] * proj(window_attention(qkv(LN(x))))
//   given do_res = dL/dout, returns dx, dLN1 (w, b), dWqkv, dbqkv,
//   dbias [H, N, N], dWproj, dbproj; the branch sees do = gb[s] * do_res.
//
// Replaces vsn_tpu/ops/swin_block_kernels.py _attn_half_bwd_arrays (Pallas
// kernel _attn_bwd_kernel, attention chain in _heads_attention_bwd). The TPU
// kernel recomputes the forward inside one VMEM program per window and adds
// its weight gradients into output blocks carried across a sequential grid.
// Here the same recompute-then-VJP runs as nine launches on the caller's
// stream, and every carried accumulator is a reduction (common.cuh):
//
//   1. y = LN1(x) (rounded to the activation type T) and row statistics;
//   2. qkv = y @ Wqkv^T + bqkv, recomputed (GEMM);
//   3. dao = round(gb * do_res) @ Wproj (GEMM with a row-gain prologue);
//   4. attention backward, one block per (window, head), below; it also
//      recomputes the attention output ao, which dWproj needs. Where d > 32
//      or the window's Q, K, V and dO do not fit in shared memory whole
//      (ViT), the caller takes the key-tiled form instead: two launches,
//      phase A over query tiles and phase B over key tiles (further below);
//   5. dWproj = do^T @ ao (split-K weight-gradient GEMM), 6. dbproj = sum do;
//   7. dWqkv = dqkv^T @ y (split-K), 8. dy = dqkv @ Wqkv (GEMM, f32 out);
//   9. LN1 backward + residual: dx = T(lam * do_res + LN_bwd(dy)), dLN1.
//
// The residual modes (_attn_bwd_kernel :369-442):
//
//   in-band LayerScale (gamma, pre-norm): launch 3's prologue reads do =
//   (gb * do_res) * gamma (common.cuh LS_PRO); launches 5 and 6 take dWproj
//   and dbproj unscaled (M and s), and a tenth launch, after them on the
//   stream, forms dgamma = rowsum(Wproj * M) + bproj * s and only then
//   scales dWproj and dbproj by gamma (common.cuh layerscale_grads_kernel);
//   post-norm: the LayerNorm sits on the branch, so do must pass LN1's
//   backward before dao, and dao needs ao before the attention backward
//   could recompute it: the caller passes K1f's own ao of the call (kept
//   from the forward) in the ao argument. Launch 1 is skipped (qkv reads
//   raw x, y is x); after launch 2, a GEMM recomputes the f32 branch
//   proj(ao) + bproj (into the dy buffer) and the post-norm row kernel
//   turns it into dbranch with LN1's gradients (and dgamma); launches 3, 5
//   and 6 take dbranch for do (the attention backward writes its own ao
//   into the unused y buffer, and dWproj reads the forward's); launch 8
//   forms dx = T(lam * do_res + dqkv @ Wqkv) in its epilogue
//   (EPI_ADD_RESID), with no LN backward.
//
// What bounds it here: the attention backward's FMA arithmetic (8 N^2 d per
// window and head) and, at stage 1, the bytes of the [rows, 3C] qkv and dqkv
// round trips. What the design does: the attention block keeps Q, K, V and
// dO of its head in shared memory as f32 (4 x N x 33 floats, 133 KB at
// N = 252) and never the [N, N] matrices: one row buffer per warp.
//
// The attention backward works in the p-basis of _heads_attention_bwd
// (swin_block_kernels.py:292-336), exact at saturated logits:
//
//   p = exp(s - max(rowmax, 0)) / (rowsum + 1e-30),  dp = dO V^T
//   ds = p * dp - rowsum(p * dp) * p
//   dq = scale * ds K,  dk = scale * ds^T Q,  dv = p^T dO,  dbias += ds
//
// in two phases. Phase A takes query rows (one per warp at a time): scores,
// shift, row sum, ao, dp, ds and dq; it adds ds into dbias (f32 atomics; the
// TPU's dbias accumulator sums over every window of every sample) and keeps
// the row's shift, 1/sum and rowsum(p * dp). Phase B takes key rows and
// recomputes the same p and ds column by column from those row statistics,
// for dk and dv, so no [N, N] matrix is stored and no dk/dv sum needs
// atomics. Both phases form s, p and ds with the same round-to-nearest
// operations (no contraction into FMA), so phase B's p and ds equal phase
// A's bit for bit. Rounding follows the TPU kernel: p and ds are rounded to
// T as product operands, dbias and the bias gradients take them unrounded.

#include "common.cuh"

namespace {

constexpr int kBwdWarps = 16;

// The masked, biased, scaled score of one (query, key) pair; phases A and B
// call this with the same operands and get the same bits.
__device__ __forceinline__ float score(float dot, float scale, bool masked,
                                       bool has_mask, const float* bias_at) {
  float s = __fmul_rn(dot, scale);
  if (has_mask) s = __fadd_rn(s, masked ? kNegInf : 0.f);
  if (bias_at) s = __fadd_rn(s, *bias_at);
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kBwdWarps * 32) window_attention_bwd_kernel(
    const T* __restrict__ qkv, const T* __restrict__ dao,
    const float* __restrict__ bias, const float* __restrict__ bias_t,
    const int* __restrict__ ids, int ids_rows, T* __restrict__ ao,
    T* __restrict__ dqkv, float* __restrict__ dbias, float* __restrict__ dbqkv,
    int n, int c, int heads, float scale) {
  extern __shared__ float smem[];
  const int d = c / heads, dp1 = d + 1;
  float* qs = smem;                  // [n][d + 1]   (padded: no bank conflicts)
  float* ks = qs + n * dp1;          // [n][d + 1]
  float* vs = ks + n * dp1;          // [n][d + 1]
  float* dos = vs + n * dp1;         // [n][d + 1]   dO of the head
  float* shift_s = dos + n * dp1;    // [n]  max(rowmax, 0)
  float* rinv_s = shift_s + n;       // [n]  1 / (rowsum + 1e-30)
  float* s1_s = rinv_s + n;          // [n]  rowsum(p * dp)
  float* bufs = s1_s + n;            // [warps][2][n]
  int* ids_s = reinterpret_cast<int*>(bufs + 2 * kBwdWarps * n);  // [n]

  const long long bw = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long base = bw * n;
  const int c3 = 3 * c;
  const bool has_mask = ids != nullptr;

  for (int e = tid; e < n * d; e += blockDim.x) {
    const int j = e / d, cc = e % d;
    const T* row = qkv + (base + j) * c3 + h * d + cc;
    qs[j * dp1 + cc] = to_f32(row[0]);
    ks[j * dp1 + cc] = to_f32(row[c]);
    vs[j * dp1 + cc] = to_f32(row[2 * c]);
    dos[j * dp1 + cc] = to_f32(dao[(base + j) * c + h * d + cc]);
  }
  if (has_mask) {
    const int* id_row = ids + (bw % ids_rows) * n;
    for (int j = tid; j < n; j += blockDim.x) ids_s[j] = id_row[j];
  }
  __syncthreads();

  float* u = bufs + warp * 2 * n;  // phase A: exp row, then p; phase B: p column
  float* w = u + n;                // phase A: p * dp, then ds; phase B: ds column
  const float* bias_h = bias ? bias + (long long)h * n * n : nullptr;
  const float* bias_th = bias_t ? bias_t + (long long)h * n * n : nullptr;
  float dq_sum = 0.f, dk_sum = 0.f, dv_sum = 0.f;

  // Phase A: query rows.
  for (int i = warp; i < n; i += kBwdWarps) {
    const float* qi = qs + i * dp1;
    const float* doi = dos + i * dp1;
    const int id_i = has_mask ? ids_s[i] : 0;
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      const float* kr = ks + j * dp1;
      float dot = 0.f;
      for (int cc = 0; cc < d; ++cc) dot = fmaf(qi[cc], kr[cc], dot);
      const float s = score(dot, scale, has_mask && ids_s[j] != id_i, has_mask,
                            bias_h ? bias_h + (long long)i * n + j : nullptr);
      u[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(warp_max(mx), 0.f);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(__fsub_rn(u[j], mx));
      sum += e;
      u[j] = e;
    }
    const float r = 1.f / (warp_sum(sum) + 1e-30f);
    __syncwarp();
    if (lane < d) {  // ao, as K1f forms it: (round(u) @ v) * r
      float o = 0.f;
      for (int j = 0; j < n; ++j) o = fmaf(round_to<T>(u[j]), vs[j * dp1 + lane], o);
      ao[(base + i) * c + h * d + lane] = from_f32<T>(o * r);
    }
    __syncwarp();
    float s1 = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float* vr = vs + j * dp1;
      float dot = 0.f;
      for (int cc = 0; cc < d; ++cc) dot = fmaf(doi[cc], vr[cc], dot);
      const float p = __fmul_rn(u[j], r);
      const float pw = __fmul_rn(p, dot);
      s1 += pw;
      u[j] = p;
      w[j] = pw;
    }
    s1 = warp_sum(s1);
    for (int j = lane; j < n; j += 32) {
      const float ds = __fsub_rn(w[j], __fmul_rn(s1, u[j]));
      if (dbias) atomicAdd(&dbias[(long long)h * n * n + (long long)i * n + j], ds);
      w[j] = round_to<T>(ds);
    }
    __syncwarp();
    if (lane < d) {
      float a = 0.f;
      for (int j = 0; j < n; ++j) a = fmaf(w[j], ks[j * dp1 + lane], a);
      const float dq = a * scale;
      dqkv[(base + i) * c3 + h * d + lane] = from_f32<T>(dq);
      dq_sum += dq;
    }
    if (lane == 0) {
      shift_s[i] = mx;
      rinv_s[i] = r;
      s1_s[i] = s1;
    }
    __syncwarp();
  }
  __syncthreads();

  // Phase B: key rows, from the row statistics of phase A.
  for (int j = warp; j < n; j += kBwdWarps) {
    const float* kj = ks + j * dp1;
    const float* vj = vs + j * dp1;
    const int id_j = has_mask ? ids_s[j] : 0;
    for (int i = lane; i < n; i += 32) {
      const float* qi = qs + i * dp1;
      const float* doi = dos + i * dp1;
      float dot = 0.f;
      for (int cc = 0; cc < d; ++cc) dot = fmaf(qi[cc], kj[cc], dot);
      const float s = score(dot, scale, has_mask && id_j != ids_s[i], has_mask,
                            bias_th ? bias_th + (long long)j * n + i : nullptr);
      const float p = __fmul_rn(expf(__fsub_rn(s, shift_s[i])), rinv_s[i]);
      float dp = 0.f;
      for (int cc = 0; cc < d; ++cc) dp = fmaf(doi[cc], vj[cc], dp);
      const float ds = __fsub_rn(__fmul_rn(p, dp), __fmul_rn(s1_s[i], p));
      u[i] = round_to<T>(p);
      w[i] = round_to<T>(ds);
    }
    __syncwarp();
    if (lane < d) {
      float av = 0.f, ak = 0.f;
      for (int i = 0; i < n; ++i) {
        av = fmaf(u[i], dos[i * dp1 + lane], av);
        ak = fmaf(w[i], qs[i * dp1 + lane], ak);
      }
      const float dk = ak * scale;
      dqkv[(base + j) * c3 + c + h * d + lane] = from_f32<T>(dk);
      dqkv[(base + j) * c3 + 2 * c + h * d + lane] = from_f32<T>(av);
      dk_sum += dk;
      dv_sum += av;
    }
    __syncwarp();
  }

  if (lane < d) {  // dbqkv: column sums of the unrounded dq, dk, dv
    atomicAdd(&dbqkv[h * d + lane], dq_sum);
    atomicAdd(&dbqkv[c + h * d + lane], dk_sum);
    atomicAdd(&dbqkv[2 * c + h * d + lane], dv_sum);
  }
}

size_t attention_bwd_smem_bytes(int n, int d) {
  return sizeof(float) * ((size_t)4 * n * (d + 1) + 3 * (size_t)n +
                          2 * (size_t)kBwdWarps * n) +
         sizeof(int) * (size_t)n;
}

// ---------------------------------------------------------------------------
// The key-tiled attention backward: launch 4 for a head dim above 32 or a
// window whose Q, K, V and dO do not fit in shared memory whole (ViT: N =
// 811, d = 64, 843 KB as f32), as two launches.
//
// Phase A, one block per (window, head, tile of kTileQ query rows), streams
// K and V through shared memory in tiles of kTileK keys, three times; each
// warp takes kTileQ / kTiledWarps query rows and keeps their statistics
// and sums in registers:
//   1. the row shift m = max(rowmax, 0) and sum l, online (l is rescaled by
//      exp(m_old - m_new) when the max grows), then 1 / (l + 1e-30);
//   2. p = exp(s - m) / l, dp = dO v^T, s1 = rowsum(p * dp), and ao = (sum
//      round(exp(s - m)) v) / l, as K1f forms it (dWproj needs ao);
//   3. ds = p * dp - s1 * p, dbias += ds (f32 atomics), dq = scale ds K.
// It writes (m, 1 / l, s1) of every row to ``stats`` [BW, H, N, 3].
// s1 is summed over the keys as the rowsum of the [N, N] product p * dp, in
// the order the whole-window body sums it (keys j = lane, lane + 32, ...
// per lane, then across the warp), not as dO . o.
//
// Phase B, one block per (window, head, tile of kTileK key rows), streams Q
// and dO (and the rows' statistics) in tiles of kTileQ query rows; each warp
// takes kTileK / kTiledWarps key rows and recomputes p and ds of its key
// rows against every query row from the statistics, for dk = scale ds^T Q
// and dv = p^T dO, so no dk or dv sum needs atomics. Both phases form s, p
// and ds with ``score`` and the same round-to-nearest operations, and every
// dot product as one FMA chain over the channels in order, so phase B's p
// and ds equal phase A's bit for bit.
// ---------------------------------------------------------------------------

constexpr int kTileQ = 64;
constexpr int kTileK = 64;
constexpr int kTiledWarps = 8;
constexpr int kRowsPerWarp = kTileQ / kTiledWarps;
constexpr int kKeysPerWarp = kTileK / kTiledWarps;
constexpr int kKeysPerLane = kTileK / 32;
constexpr int kQueriesPerLane = kTileQ / 32;

template <typename T, int CH>
__global__ void __launch_bounds__(kTiledWarps * 32) attention_bwd_rows_kernel(
    const T* __restrict__ qkv, const T* __restrict__ dao,
    const float* __restrict__ bias, const int* __restrict__ ids, int ids_rows,
    T* __restrict__ ao, T* __restrict__ dqkv, float* __restrict__ dbias,
    float* __restrict__ dbqkv, float* __restrict__ stats, int n, int c, int heads,
    float scale) {
  extern __shared__ float smem[];
  const int d = c / heads, dp1 = d + 1;
  float* qs = smem;                  // [kTileQ][d]      queries of the block
  float* dos = qs + kTileQ * d;      // [kTileQ][d]      their dO
  float* ks = dos + kTileQ * d;      // [kTileK][d + 1]  (padded: no bank conflicts)
  float* vs = ks + kTileK * dp1;     // [kTileK][d + 1]
  float* bufs = vs + kTileK * dp1;   // [warps][2][kTileK]
  int* idq = reinterpret_cast<int*>(bufs + 2 * kTiledWarps * kTileK);  // [kTileQ]
  int* idk = idq + kTileQ;                                              // [kTileK]

  const int qtiles = (n + kTileQ - 1) / kTileQ;
  const int q0 = (blockIdx.x % qtiles) * kTileQ;
  const int h = (blockIdx.x / qtiles) % heads;
  const long long bw = blockIdx.x / qtiles / heads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long base = bw * n;
  const int c3 = 3 * c;
  const bool has_mask = ids != nullptr;
  const int* id_row = has_mask ? ids + (bw % ids_rows) * n : nullptr;
  const float* bias_h = bias ? bias + (long long)h * n * n : nullptr;

  for (int e = tid; e < kTileQ * d; e += blockDim.x) {
    const int i = q0 + e / d, cc = e % d;
    qs[e] = i < n ? to_f32(qkv[(base + i) * c3 + h * d + cc]) : 0.f;
    dos[e] = i < n ? to_f32(dao[(base + i) * c + h * d + cc]) : 0.f;
  }
  if (has_mask)
    for (int i = tid; i < kTileQ; i += blockDim.x) idq[i] = q0 + i < n ? id_row[q0 + i] : 0;

  float* u = bufs + warp * 2 * kTileK;  // pass 2: round(e); pass 3: round(ds)
  float shift[kRowsPerWarp], rinv[kRowsPerWarp], s1[kRowsPerWarp];
  float acc[kRowsPerWarp][CH];  // pass 2: ao; pass 3: dq
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    shift[r] = 0.f;  // max(rowmax, 0): the running max starts at 0
    rinv[r] = 0.f;   // pass 1: the running sum
    s1[r] = 0.f;     // per-lane partial sums until the end of pass 2
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) acc[r][ch] = 0.f;
  }

  for (int pass = 1; pass <= 3; ++pass) {
    for (int k0 = 0; k0 < n; k0 += kTileK) {
      const int nk = min(kTileK, n - k0);
      __syncthreads();  // every warp is done with the last tile (and qs, dos are staged)
      for (int e = tid; e < kTileK * d; e += blockDim.x) {
        const int j = e / d, cc = e % d;
        const T* row = qkv + (base + k0 + j) * c3 + h * d + cc;
        ks[j * dp1 + cc] = j < nk ? to_f32(row[c]) : 0.f;
        if (pass > 1) vs[j * dp1 + cc] = j < nk ? to_f32(row[2 * c]) : 0.f;
      }
      if (has_mask)
        for (int j = tid; j < nk; j += blockDim.x) idk[j] = id_row[k0 + j];
      __syncthreads();

#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int il = warp + r * kTiledWarps;
        const int i = q0 + il;
        if (i >= n) continue;  // the same for the whole warp
        const float* qi = qs + il * d;
        const float* doi = dos + il * d;
        const int id_i = has_mask ? idq[il] : 0;
        float s[kKeysPerLane];
        float tmax = -INFINITY;
#pragma unroll
        for (int t = 0; t < kKeysPerLane; ++t) {
          const int j = lane + 32 * t;
          const float* kr = ks + j * dp1;
          float dot = 0.f;
          for (int cc = 0; cc < d; ++cc) dot = fmaf(qi[cc], kr[cc], dot);
          s[t] = score(dot, scale, has_mask && j < nk && idk[j] != id_i, has_mask,
                       bias_h && j < nk ? bias_h + (long long)i * n + k0 + j : nullptr);
          if (j < nk) tmax = fmaxf(tmax, s[t]);
        }
        if (pass == 1) {  // online shift and sum
          const float mn = fmaxf(shift[r], warp_max(tmax));
          float part = 0.f;
#pragma unroll
          for (int t = 0; t < kKeysPerLane; ++t)
            if (lane + 32 * t < nk) part += expf(__fsub_rn(s[t], mn));
          rinv[r] = rinv[r] * expf(shift[r] - mn) + warp_sum(part);
          shift[r] = mn;
          continue;
        }
        float* w = u + kTileK;
#pragma unroll
        for (int t = 0; t < kKeysPerLane; ++t) {
          const int j = lane + 32 * t;
          float ev = 0.f, dsv = 0.f;
          if (j < nk) {
            const float* vr = vs + j * dp1;
            float dp = 0.f;
            for (int cc = 0; cc < d; ++cc) dp = fmaf(doi[cc], vr[cc], dp);
            ev = expf(__fsub_rn(s[t], shift[r]));
            const float p = __fmul_rn(ev, rinv[r]);
            const float pw = __fmul_rn(p, dp);
            if (pass == 2) {
              s1[r] += pw;
            } else {
              dsv = __fsub_rn(pw, __fmul_rn(s1[r], p));
              if (dbias)
                atomicAdd(&dbias[(long long)h * n * n + (long long)i * n + k0 + j], dsv);
            }
          }
          u[j] = round_to<T>(ev);
          w[j] = round_to<T>(dsv);
        }
        __syncwarp();
        const float* src = pass == 2 ? u : w;          // round(e) or round(ds)
        const float* rows = pass == 2 ? vs : ks;       // times v or k
        for (int j = 0; j < nk; ++j) {
          const float a = src[j];
#pragma unroll
          for (int ch = 0; ch < CH; ++ch)
            if (lane + 32 * ch < d)
              acc[r][ch] = fmaf(a, rows[j * dp1 + lane + 32 * ch], acc[r][ch]);
        }
        __syncwarp();
      }
    }
    if (pass == 1) {
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) rinv[r] = 1.f / (rinv[r] + 1e-30f);
    } else if (pass == 2) {  // ao, as K1f forms it; s1 across the warp
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int i = q0 + warp + r * kTiledWarps;
        s1[r] = warp_sum(s1[r]);
#pragma unroll
        for (int ch = 0; ch < CH; ++ch) {
          const int cc = lane + 32 * ch;
          if (i < n && cc < d)
            ao[(base + i) * c + h * d + cc] = from_f32<T>(acc[r][ch] * rinv[r]);
          acc[r][ch] = 0.f;
        }
      }
    }
  }

  float dq_sum[CH];
#pragma unroll
  for (int ch = 0; ch < CH; ++ch) dq_sum[ch] = 0.f;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = q0 + warp + r * kTiledWarps;
    if (i >= n) continue;
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) {
      const int cc = lane + 32 * ch;
      if (cc >= d) continue;
      const float dq = acc[r][ch] * scale;
      dqkv[(base + i) * c3 + h * d + cc] = from_f32<T>(dq);
      dq_sum[ch] += dq;
    }
    if (lane == 0) {
      float* st = stats + ((bw * heads + h) * (long long)n + i) * 3;
      st[0] = shift[r];
      st[1] = rinv[r];
      st[2] = s1[r];
    }
  }
#pragma unroll
  for (int ch = 0; ch < CH; ++ch)  // dbqkv: column sums of the unrounded dq
    if (lane + 32 * ch < d) atomicAdd(&dbqkv[h * d + lane + 32 * ch], dq_sum[ch]);
}

template <typename T, int CH>
__global__ void __launch_bounds__(kTiledWarps * 32) attention_bwd_keys_kernel(
    const T* __restrict__ qkv, const T* __restrict__ dao,
    const float* __restrict__ bias_t, const int* __restrict__ ids, int ids_rows,
    const float* __restrict__ stats, T* __restrict__ dqkv, float* __restrict__ dbqkv,
    int n, int c, int heads, float scale) {
  extern __shared__ float smem[];
  const int d = c / heads, dp1 = d + 1;
  float* kst = smem;                 // [kTileK][d]      keys of the block
  float* vst = kst + kTileK * d;     // [kTileK][d]      their values
  float* qs = vst + kTileK * d;      // [kTileQ][d + 1]  (padded: no bank conflicts)
  float* dos = qs + kTileQ * dp1;    // [kTileQ][d + 1]
  float* st_s = dos + kTileQ * dp1;  // [kTileQ][3]      shift, 1 / sum, s1
  float* bufs = st_s + 3 * kTileQ;   // [warps][2][kTileQ]
  int* idk = reinterpret_cast<int*>(bufs + 2 * kTiledWarps * kTileQ);  // [kTileK]
  int* idq = idk + kTileK;                                              // [kTileQ]

  const int ktiles = (n + kTileK - 1) / kTileK;
  const int k0 = (blockIdx.x % ktiles) * kTileK;
  const int h = (blockIdx.x / ktiles) % heads;
  const long long bw = blockIdx.x / ktiles / heads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long base = bw * n;
  const int c3 = 3 * c;
  const bool has_mask = ids != nullptr;
  const int* id_row = has_mask ? ids + (bw % ids_rows) * n : nullptr;
  const float* bias_th = bias_t ? bias_t + (long long)h * n * n : nullptr;
  const float* stats_h = stats + (bw * heads + h) * (long long)n * 3;

  for (int e = tid; e < kTileK * d; e += blockDim.x) {
    const int j = k0 + e / d, cc = e % d;
    const T* row = qkv + (base + j) * c3 + h * d + cc;
    kst[e] = j < n ? to_f32(row[c]) : 0.f;
    vst[e] = j < n ? to_f32(row[2 * c]) : 0.f;
  }
  if (has_mask)
    for (int j = tid; j < kTileK; j += blockDim.x) idk[j] = k0 + j < n ? id_row[k0 + j] : 0;

  float* u = bufs + warp * 2 * kTileQ;  // round(p) of one key row
  float* w = u + kTileQ;                // round(ds)
  float dk[kKeysPerWarp][CH], dv[kKeysPerWarp][CH];
#pragma unroll
  for (int r = 0; r < kKeysPerWarp; ++r)
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) dk[r][ch] = dv[r][ch] = 0.f;

  for (int q0 = 0; q0 < n; q0 += kTileQ) {
    const int nq = min(kTileQ, n - q0);
    __syncthreads();  // every warp is done with the last tile (and kst, vst are staged)
    for (int e = tid; e < kTileQ * d; e += blockDim.x) {
      const int i = e / d, cc = e % d;
      qs[i * dp1 + cc] = i < nq ? to_f32(qkv[(base + q0 + i) * c3 + h * d + cc]) : 0.f;
      dos[i * dp1 + cc] = i < nq ? to_f32(dao[(base + q0 + i) * c + h * d + cc]) : 0.f;
    }
    for (int e = tid; e < 3 * nq; e += blockDim.x) st_s[e] = stats_h[q0 * 3 + e];
    if (has_mask)
      for (int i = tid; i < nq; i += blockDim.x) idq[i] = id_row[q0 + i];
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kKeysPerWarp; ++r) {
      const int jl = warp + r * kTiledWarps;
      const int j = k0 + jl;
      if (j >= n) continue;  // the same for the whole warp
      const float* kj = kst + jl * d;
      const float* vj = vst + jl * d;
      const int id_j = has_mask ? idk[jl] : 0;
#pragma unroll
      for (int t = 0; t < kQueriesPerLane; ++t) {
        const int il = lane + 32 * t;
        float pv = 0.f, dsv = 0.f;
        if (il < nq) {
          const float* qi = qs + il * dp1;
          const float* doi = dos + il * dp1;
          float dot = 0.f;
          for (int cc = 0; cc < d; ++cc) dot = fmaf(qi[cc], kj[cc], dot);
          const float s = score(dot, scale, has_mask && id_j != idq[il], has_mask,
                                bias_th ? bias_th + (long long)j * n + q0 + il : nullptr);
          const float* st = st_s + il * 3;
          const float p = __fmul_rn(expf(__fsub_rn(s, st[0])), st[1]);
          float dp = 0.f;
          for (int cc = 0; cc < d; ++cc) dp = fmaf(doi[cc], vj[cc], dp);
          pv = p;
          dsv = __fsub_rn(__fmul_rn(p, dp), __fmul_rn(st[2], p));
        }
        u[il] = round_to<T>(pv);
        w[il] = round_to<T>(dsv);
      }
      __syncwarp();
      for (int i = 0; i < nq; ++i) {
        const float a = u[i], b = w[i];
#pragma unroll
        for (int ch = 0; ch < CH; ++ch) {
          const int cc = lane + 32 * ch;
          if (cc < d) {
            dv[r][ch] = fmaf(a, dos[i * dp1 + cc], dv[r][ch]);
            dk[r][ch] = fmaf(b, qs[i * dp1 + cc], dk[r][ch]);
          }
        }
      }
      __syncwarp();
    }
  }

  float dk_sum[CH], dv_sum[CH];
#pragma unroll
  for (int ch = 0; ch < CH; ++ch) dk_sum[ch] = dv_sum[ch] = 0.f;
#pragma unroll
  for (int r = 0; r < kKeysPerWarp; ++r) {
    const int j = k0 + warp + r * kTiledWarps;
    if (j >= n) continue;
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) {
      const int cc = lane + 32 * ch;
      if (cc >= d) continue;
      const float dkv = dk[r][ch] * scale;
      dqkv[(base + j) * c3 + c + h * d + cc] = from_f32<T>(dkv);
      dqkv[(base + j) * c3 + 2 * c + h * d + cc] = from_f32<T>(dv[r][ch]);
      dk_sum[ch] += dkv;
      dv_sum[ch] += dv[r][ch];
    }
  }
#pragma unroll
  for (int ch = 0; ch < CH; ++ch) {  // dbqkv: column sums of the unrounded dk, dv
    const int cc = lane + 32 * ch;
    if (cc < d) {
      atomicAdd(&dbqkv[c + h * d + cc], dk_sum[ch]);
      atomicAdd(&dbqkv[2 * c + h * d + cc], dv_sum[ch]);
    }
  }
}

size_t attention_bwd_rows_smem_bytes(int d) {
  return sizeof(float) * (2 * (size_t)kTileQ * d + 2 * (size_t)kTileK * (d + 1) +
                          2 * (size_t)kTiledWarps * kTileK) +
         sizeof(int) * (size_t)(kTileQ + kTileK);
}

size_t attention_bwd_keys_smem_bytes(int d) {
  return sizeof(float) * (2 * (size_t)kTileK * d + 2 * (size_t)kTileQ * (d + 1) +
                          3 * (size_t)kTileQ + 2 * (size_t)kTiledWarps * kTileQ) +
         sizeof(int) * (size_t)(kTileQ + kTileK);
}

template <typename T, int CH>
cudaError_t launch_attention_bwd_tiled_ch(const T* qkv, const T* dao, const float* bias,
                                          const float* bias_t, const int* ids,
                                          int ids_rows, T* ao, T* dqkv, float* dbias,
                                          float* dbqkv, float* stats, long long bw,
                                          int n, int c, int heads, float scale,
                                          cudaStream_t stream) {
  const int d = c / heads;
  auto rows_kernel = attention_bwd_rows_kernel<T, CH>;
  auto keys_kernel = attention_bwd_keys_kernel<T, CH>;
  const size_t rows_smem = attention_bwd_rows_smem_bytes(d);
  const size_t keys_smem = attention_bwd_keys_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rows_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(keys_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)keys_smem);
  if (err != cudaSuccess) return err;
  const long long qblocks = bw * heads * ((n + kTileQ - 1) / kTileQ);
  rows_kernel<<<(unsigned)qblocks, kTiledWarps * 32, rows_smem, stream>>>(
      qkv, dao, bias, ids, ids_rows, ao, dqkv, dbias, dbqkv, stats, n, c, heads, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long kblocks = bw * heads * ((n + kTileK - 1) / kTileK);
  keys_kernel<<<(unsigned)kblocks, kTiledWarps * 32, keys_smem, stream>>>(
      qkv, dao, bias_t, ids, ids_rows, stats, dqkv, dbqkv, n, c, heads, scale);
  return cudaGetLastError();
}

// Head dims up to 32 * CH, CH in {1, 2, 4}: d <= 128.
template <typename T>
cudaError_t launch_attention_bwd_tiled(const T* qkv, const T* dao, const float* bias,
                                       const float* bias_t, const int* ids, int ids_rows,
                                       T* ao, T* dqkv, float* dbias, float* dbqkv,
                                       float* stats, long long bw, int n, int c,
                                       int heads, float scale, cudaStream_t stream) {
  const int d = c / heads;
  if (d <= 32)
    return launch_attention_bwd_tiled_ch<T, 1>(qkv, dao, bias, bias_t, ids, ids_rows, ao,
                                               dqkv, dbias, dbqkv, stats, bw, n, c, heads,
                                               scale, stream);
  if (d <= 64)
    return launch_attention_bwd_tiled_ch<T, 2>(qkv, dao, bias, bias_t, ids, ids_rows, ao,
                                               dqkv, dbias, dbqkv, stats, bw, n, c, heads,
                                               scale, stream);
  if (d <= 128)
    return launch_attention_bwd_tiled_ch<T, 4>(qkv, dao, bias, bias_t, ids, ids_rows, ao,
                                               dqkv, dbias, dbqkv, stats, bw, n, c, heads,
                                               scale, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t attention_bwd_launch(int tiled, const T* qkv, const T* dao, const float* bias,
                                 const float* bias_t, const int* ids, int ids_rows, T* ao,
                                 T* dqkv, float* dbias, float* dqkv_b, float* row_stats,
                                 long long bw, int n, int c, int heads, float scale,
                                 cudaStream_t stream) {
  if (tiled)
    return launch_attention_bwd_tiled<T>(qkv, dao, bias, bias_t, ids, ids_rows, ao, dqkv,
                                         dbias, dqkv_b, row_stats, bw, n, c, heads, scale,
                                         stream);
  const size_t smem = attention_bwd_smem_bytes(n, c / heads);
  cudaError_t err = cudaFuncSetAttribute(window_attention_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  window_attention_bwd_kernel<T><<<(unsigned)(bw * heads), kBwdWarps * 32, smem, stream>>>(
      qkv, dao, bias, bias_t, ids, ids_rows, ao, dqkv, dbias, dqkv_b, n, c, heads, scale);
  return cudaGetLastError();
}

template <typename T>
int attn_half_bwd(int tiled, const T* x, const float* ln_w, const float* ln_b, const float* qkv_w,
                  const float* qkv_b, const float* bias, const float* bias_t,
                  const int* ids, int ids_rows, const float* proj_w, const float* proj_b,
                  const float* gamma, int post_norm, const float* gb,
                  const T* dout, T* y, float* stats, T* qkv, T* dao, T* ao, T* dqkv,
                  float* dy, T* dx, float* dln_w, float* dln_b, float* dqkv_w,
                  float* dqkv_b, float* dbias, float* dproj_w, float* dproj_b,
                  float* dgamma, float* row_stats, long long bw, int n, int c, int heads,
                  long long rows_per_sample, float scale, float lam,
                  cudaStream_t stream) {
  const long long rows = bw * n;
  cudaError_t err = cudaSuccess;
  const T* yin = x;  // post-norm: qkv reads raw x
  if (!post_norm) {
    err = launch_ln_rows<T>(x, ln_w, ln_b, y, stats, rows, c, stream);
    if (err != cudaSuccess) return (int)err;
    yin = y;
  }

  GemmParams<T> g_qkv = {};
  g_qkv.a = yin;
  g_qkv.w = qkv_w;
  g_qkv.bias = qkv_b;
  g_qkv.out = qkv;
  g_qkv.m = rows;
  g_qkv.n = 3 * c;
  g_qkv.k = c;
  err = launch_gemm<T, EPI_BIAS>(g_qkv, stream);
  if (err != cudaSuccess) return (int)err;

  if (post_norm) {  // ao: K1f's, from the caller
    GemmParams<T> g_br = {};  // the f32 branch proj(ao) + bproj, in dy
    g_br.a = ao;
    g_br.w = proj_w;
    g_br.bias = proj_b;
    g_br.out32 = dy;
    g_br.m = rows;
    g_br.n = c;
    g_br.k = c;
    err = launch_gemm<T, EPI_F32>(g_br, stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_postnorm_bwd<T>(dy, dout, gb, rows_per_sample, ln_w, ln_b, gamma, dln_w,
                                 dln_b, dgamma, rows, c, stream);
    if (err != cudaSuccess) return (int)err;

    GemmParams<T, float> g_dao = {};  // dao[m, i] = sum_o dbranch[m, o] Wproj[o, i]
    g_dao.a = dy;
    g_dao.w = proj_w;
    g_dao.out = dao;
    g_dao.m = rows;
    g_dao.n = c;
    g_dao.k = c;
    err = launch_gemm<T, EPI_BIAS, true>(g_dao, stream);
    if (err != cudaSuccess) return (int)err;
    err = attention_bwd_launch<T>(tiled, qkv, dao, bias, bias_t, ids, ids_rows, y, dqkv,
                                  dbias, dqkv_b, row_stats, bw, n, c, heads, scale, stream);
    if (err != cudaSuccess) return (int)err;

    WgradParams<T, float> w_proj = {};  // dWproj[o, i] = sum_m dbranch[m, o] ao[m, i]
    w_proj.a = dy;
    w_proj.b = ao;
    w_proj.out = dproj_w;
    w_proj.m = rows;
    w_proj.n1 = c;
    w_proj.n2 = c;
    err = launch_wgrad(w_proj, stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_colsum<float>(dy, nullptr, 1, dproj_b, rows, c, stream);
    if (err != cudaSuccess) return (int)err;
  } else {
    GemmParams<T> g_dao = {};  // dao[m, i] = sum_o do[m, o] Wproj[o, i]
    g_dao.a = dout;
    g_dao.a_gain = gb;
    g_dao.rows_per_sample = rows_per_sample;
    g_dao.w = proj_w;
    g_dao.gamma = gamma;
    g_dao.out = dao;
    g_dao.m = rows;
    g_dao.n = c;
    g_dao.k = c;
    err = gamma ? launch_gemm<T, EPI_BIAS, true, LS_PRO>(g_dao, stream)
                : launch_gemm<T, EPI_BIAS, true>(g_dao, stream);
    if (err != cudaSuccess) return (int)err;
    err = attention_bwd_launch<T>(tiled, qkv, dao, bias, bias_t, ids, ids_rows, ao, dqkv,
                                  dbias, dqkv_b, row_stats, bw, n, c, heads, scale, stream);
    if (err != cudaSuccess) return (int)err;

    WgradParams<T, T> w_proj = {};  // dWproj[o, i] = sum_m do[m, o] ao[m, i]
    w_proj.a = dout;
    w_proj.a_gain = gb;
    w_proj.rows_per_sample = rows_per_sample;
    w_proj.b = ao;
    w_proj.out = dproj_w;
    w_proj.m = rows;
    w_proj.n1 = c;
    w_proj.n2 = c;
    err = launch_wgrad(w_proj, stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_colsum<T>(dout, gb, rows_per_sample, dproj_b, rows, c, stream);
    if (err != cudaSuccess) return (int)err;
    if (gamma) {
      err = launch_layerscale_grads<float>(proj_w, proj_b, gamma, dproj_w, dproj_b, dgamma,
                                           c, c, stream);
      if (err != cudaSuccess) return (int)err;
    }
  }

  WgradParams<T, T> w_qkv = {};  // dWqkv[o, i] = sum_m dqkv[m, o] y[m, i]
  w_qkv.a = dqkv;
  w_qkv.b = yin;
  w_qkv.out = dqkv_w;
  w_qkv.m = rows;
  w_qkv.n1 = 3 * c;
  w_qkv.n2 = c;
  err = launch_wgrad(w_qkv, stream);
  if (err != cudaSuccess) return (int)err;

  GemmParams<T> g_dy = {};  // dy[m, i] = sum_o dqkv[m, o] Wqkv[o, i]
  g_dy.a = dqkv;
  g_dy.w = qkv_w;
  g_dy.out32 = dy;
  g_dy.m = rows;
  g_dy.n = c;
  g_dy.k = 3 * c;
  if (post_norm) {  // dx = T(lam * do_res + dy): no LN backward
    g_dy.resid = dout;
    g_dy.lam = lam;
    g_dy.out = dx;
    return (int)launch_gemm<T, EPI_ADD_RESID, true>(g_dy, stream);
  }
  err = launch_gemm<T, EPI_F32, true>(g_dy, stream);
  if (err != cudaSuccess) return (int)err;

  return (int)launch_ln_bwd<T>(x, stats, ln_w, dy, dout, lam, dx, dln_w, dln_b, rows, c,
                               stream);
}

}  // namespace

// Returns cudaGetLastError() of the first launch that failed, else 0.
// is_bf16 selects bf16 activations (else f32); parameters and their
// gradients are f32. bias/bias_t (the bias and its [H, N^T, N] transpose)
// and ids may be null; dbias is then not written. The f32 gradient outputs
// (dln_w .. dproj_b, dbias, dgamma) must be zeroed by the caller: the
// kernels add into them. y, stats, qkv, dao, ao, dqkv and dy are scratch,
// but for ao under post_norm: the input K1f's attention output [BW*N, C]
// of this call (vsn_attn_half_fwd's ao_buf), read only.
// tiled selects the key-tiled attention backward (phases A and B, head dims
// up to 128, any N; row_stats [BW, H, N, 3] f32 scratch) over the
// whole-window one (head dims up to 32, row_stats unused and may be null);
// the caller chooses by shape. gamma [C] (in-band LayerScale, with dgamma)
// may be null; post_norm selects the post-norm backward (stats unused).
extern "C" int vsn_attn_half_bwd(
    int tiled, int is_bf16, const void* x, const float* ln_w, const float* ln_b,
    const float* qkv_w, const float* qkv_b, const float* bias, const float* bias_t,
    const int* ids, int ids_rows, const float* proj_w, const float* proj_b,
    const float* gamma, int post_norm, const float* gb, const void* dout, void* y,
    float* stats, void* qkv, void* dao, void* ao, void* dqkv, float* dy, void* dx,
    float* dln_w, float* dln_b, float* dqkv_w, float* dqkv_b, float* dbias,
    float* dproj_w, float* dproj_b, float* dgamma, float* row_stats, long long bw, int n,
    int c, int heads, long long rows_per_sample, float scale, float lam, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using B = __nv_bfloat16;
    return attn_half_bwd<B>(
        tiled, static_cast<const B*>(x), ln_w, ln_b, qkv_w, qkv_b, bias, bias_t, ids, ids_rows,
        proj_w, proj_b, gamma, post_norm, gb, static_cast<const B*>(dout),
        static_cast<B*>(y), stats, static_cast<B*>(qkv), static_cast<B*>(dao),
        static_cast<B*>(ao), static_cast<B*>(dqkv), dy, static_cast<B*>(dx), dln_w, dln_b,
        dqkv_w, dqkv_b, dbias, dproj_w, dproj_b, dgamma, row_stats, bw, n, c, heads,
        rows_per_sample, scale, lam, s);
  }
  return attn_half_bwd<float>(
      tiled, static_cast<const float*>(x), ln_w, ln_b, qkv_w, qkv_b, bias, bias_t, ids, ids_rows,
      proj_w, proj_b, gamma, post_norm, gb, static_cast<const float*>(dout),
      static_cast<float*>(y), stats, static_cast<float*>(qkv), static_cast<float*>(dao),
      static_cast<float*>(ao), static_cast<float*>(dqkv), dy, static_cast<float*>(dx), dln_w,
      dln_b, dqkv_w, dqkv_b, dbias, dproj_w, dproj_b, dgamma, row_stats, bw, n, c, heads,
      rows_per_sample, scale, lam, s);
}
