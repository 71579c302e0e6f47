// K10c on Hopper: int8 x int8 -> int32 direct convolution forward, dequantized
// in an f32 epilogue with the fused §II-G chain, by the reference's legacy
// whole-plane strategy.
//
// Replaces the Pallas kernel repro/kernels/conv2d_q8.py:_conv2d_q8_whole_plane
// (_kernel_q8_whole).  Same function as K3 (csrc/conv2d_q8.cu): xp, the padded
// int8 plane (N,HP,WP,C) that the wrapper makes with pad_input, and the int8
// weights, which the wrapper lays out as words of 4 input channels of one
// output channel, (R, S, C/4, K) -> out (N,P,Q,K) f32 =
//   relu?(((f32(acc) * deq) * scale + shift) + bias + residual),
// acc the exact int32 sum and deq = x_scale * w_scale[k] (one f32 multiply).
// Built with nvcc for sm_90a and bound through the plain C function at the
// bottom (ctypes; see repro_torch/kernels/_build.py).
//
// The strategy is K10a's (csrc/conv2d_direct_whole.cu): the grid is the
// reference's (N, K_b, P_b), one block computes one output block (an image,
// k_blk channels, rb_p rows by the full row Q) over all of C, the plane stays
// in L2 and each pass stages the padded rows it reads in slices of 32
// channels, double buffered by cp.async, with no bounds test in any load
// (the C tail of a slice is zero-filled).  The reference's int8 blocking grows
// rb_p to its budget, up to the whole plane, so a block makes as many passes
// of rows_pass rows as its pixels need.
// The SIMT route:
//   * Products: __dp4a, four int8 products summed into int32 per instruction.
//     int32 sums are associative and R*S*C*127^2 < 2^31 (checked by the
//     wrapper), so the accumulator equals K3's whatever the order.
//   * Epilogue: K3's exactly: __int2float_rn, then __fmul_rn by deq, then
//     non-contracting scale, shift, bias, residual, relu.  So the output
//     equals K3's, and the plain version's, bit for bit: the reference's
//     contract between its tiled and whole-plane kernels.
//
// Two routes, chosen in the wrapper (kernels/conv2d_q8.route_whole):
//
// conv2d_q8_whole_kernel_mma, for C a multiple of 16 (every ResNet-50 int8
// conv): the products on the tensor cores by K3's mma.sync.m16n8k32 s8
// (q8_mma.cuh).  The grid is the reference's (P_b x row slices, K_b, N): a
// block takes a slice of rows of one reference block (conv2d_q8.whole_split
// decides whether the grid is cut: by rows here, and by k_blk, which the
// wrapper halves before the launch; each pixel's and channel's int32 sum
// stays whole in one block, so a cut changes no bit) in passes of at most 128
// output pixels (whole rows, or a segment of a row longer than that), each
// over all of C.
// A ring stage is one 32-channel slice of a pass: the window of the padded
// plane the pass reads (its band; pixel rows padded to 12 words of 4
// channels) and the slice's (R, S, 8 words, BN) weights (rows padded by 8
// words), all by 16-byte cp.async into a ring of 2 to 8 stages (as many as
// the plan fits, two blocks an SM where they fit) that runs across passes,
// so the next pass's first slices are in flight while a pass's epilogue
// stores.  A tap's A fragments are read from the band at the tap's offset
// (4 channels of one pixel a word: the "row" operand); B from the staged
// words as laid out (4 channels of one output channel a word: the "col"
// operand).  8 warps of 32 pixels x BN/2 channels in m16n8 int32
// accumulators; a warp whose pixels all lie past the pass skips the
// products.  The epilogue is K3's (q8_mma.cuh).
//
// conv2d_q8_whole_kernel, C a multiple of 8 off the mma rule: __dp4a on the
// SIMT cores, as described below.
// Offsets into xp, out and residual are 64-bit.
#include <cstdint>

#include <cuda_runtime.h>

#include "q8_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 32;          // input channels per staged slice
constexpr int kWords = kBK / 4;  // 32-bit words of 4 channels per pixel and slice
constexpr int kTN = 8;           // output channels per thread

struct Q8WholeArgs {
  const int8_t* xp;       // padded plane (N, HP, WP, C)
  const int* wt;          // (R, S, C/4, K) words of 4 input channels
  const float* x_scale;   // one f32
  const float* w_scale;   // (K,)
  const float* scale;     // may be null
  const float* shift;     // may be null
  const float* bias;      // may be null
  const float* residual;  // may be null, else (N,P,Q,K)
  float* out;
  int n, hp, wp, c, k, r, s, stride, p, q;
  int rb_p, k_blk, rows_pass, relu;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int BN, int TM>
__global__ void __launch_bounds__(kThreads)
conv2d_q8_whole_kernel(const Q8WholeArgs a) {
  constexpr int kTX = BN / kTN;
  constexpr int kTY = kThreads / kTX;
  extern __shared__ __align__(16) int smem_words[];
  const int band_words = ((a.rows_pass - 1) * a.stride + a.r) * a.wp * kWords;
  const int w_words = a.r * a.s * kWords * BN;
  int* band[2] = {smem_words, smem_words + band_words + w_words};
  int* wts[2] = {smem_words + band_words, smem_words + 2 * band_words + w_words};

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int nn = blockIdx.z;
  const int k0 = blockIdx.y * a.k_blk;
  const int p_begin = blockIdx.x * a.rb_p;
  const int p_end = min(p_begin + a.rb_p, a.p);
  const int slices = (a.c + kBK - 1) / kBK;
  const int cw = a.c / 4;  // words per weight row
  const int taps = a.r * a.s;
  const int w_chunks = taps * kWords * (BN / 4);
  const int8_t* xn = a.xp + static_cast<int64_t>(nn) * a.hp * a.wp * a.c;

  for (int pp0 = p_begin; pp0 < p_end; pp0 += a.rows_pass) {
    const int rows = min(a.rows_pass, p_end - pp0);
    const int pixels = rows * a.q;
    const int band_chunks = ((rows - 1) * a.stride + a.r) * a.wp * (kBK / 8);
    const int8_t* xrow = xn + static_cast<int64_t>(pp0) * a.stride * a.wp * a.c;

    int off[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = ty + i * kTY;
      const int pl = m / a.q;
      const int qq = m - pl * a.q;
      off[i] = m < pixels ? (pl * a.stride * a.wp + qq * a.stride) * kWords : 0;
    }

    auto fetch = [&](int slice, int buf) {
      const int c0 = slice * kBK;
      for (int idx = tid; idx < band_chunks; idx += kThreads) {  // 8 channels each
        const int ch = c0 + (idx & 3) * 8;
        const bool ok = ch < a.c;
        const int8_t* src = ok ? xrow + static_cast<int64_t>(idx >> 2) * a.c + ch : a.xp;
        cp_async8(band[buf] + idx * 2, src, ok ? 8 : 0);
      }
      for (int idx = tid; idx < w_chunks; idx += kThreads) {  // 4 output channels each
        const int kk = (idx % (BN / 4)) * 4;
        const int row = idx / (BN / 4);  // tap * kWords + word
        const int tap = row / kWords;
        const int word = c0 / 4 + row % kWords;
        const bool ok = kk < a.k_blk && word < cw;
        const int* src = ok ? a.wt + static_cast<int64_t>(tap * cw + word) * a.k + k0 + kk : a.wt;
        cp_async16(wts[buf] + row * BN + kk, src, ok ? 16 : 0);
      }
    };

    int acc[TM][kTN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0;

    fetch(0, 0);
    cp_async_commit();
    for (int t = 0; t < slices; ++t) {
      const int buf = t & 1;
      if (t + 1 < slices) {
        fetch(t + 1, buf ^ 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int* B = band[buf];
      const int* W = wts[buf] + tx * kTN;
      for (int rr = 0; rr < a.r; ++rr) {
        for (int ss = 0; ss < a.s; ++ss) {
          const int toff = (rr * a.wp + ss) * kWords;
          const int* Wt = W + (rr * a.s + ss) * kWords * BN;
#pragma unroll
          for (int kw = 0; kw < kWords; ++kw) {
            int av[TM];
#pragma unroll
            for (int i = 0; i < TM; ++i) av[i] = B[off[i] + toff + kw];
            const int4 b0 = *reinterpret_cast<const int4*>(Wt + kw * BN);
            const int4 b1 = *reinterpret_cast<const int4*>(Wt + kw * BN + 4);
            const int bv[kTN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
              for (int j = 0; j < kTN; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
          }
        }
      }
      __syncthreads();
    }

    // Dequantize, then the fused epilogue (reference order: scale, shift,
    // bias, residual, relu), rounding exactly as K3 does.
    if (tx * kTN >= a.k_blk) continue;
    const int kk0 = k0 + tx * kTN;
    const float xs = *a.x_scale;
    float dq[kTN], sc[kTN], sh[kTN], bi[kTN];
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      dq[j] = __fmul_rn(xs, a.w_scale[kk0 + j]);
      sc[j] = a.scale ? a.scale[kk0 + j] : 1.f;
      sh[j] = a.shift ? a.shift[kk0 + j] : 0.f;
      bi[j] = a.bias ? a.bias[kk0 + j] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = ty + i * kTY;
      if (m >= pixels) continue;
      const int pl = m / a.q;
      const int qq = m - pl * a.q;
      const int64_t off_o = ((static_cast<int64_t>(nn) * a.p + pp0 + pl) * a.q + qq) * a.k + kk0;
#pragma unroll
      for (int g = 0; g < kTN / 4; ++g) {
        float res[4] = {0.f, 0.f, 0.f, 0.f};
        if (a.residual) {
          const float4 rv = *reinterpret_cast<const float4*>(a.residual + off_o + g * 4);
          res[0] = rv.x;
          res[1] = rv.y;
          res[2] = rv.z;
          res[3] = rv.w;
        }
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = g * 4 + u;
          float y = __int2float_rn(acc[i][j]);
          y = __fmul_rn(y, dq[j]);
          if (a.scale) y = __fmul_rn(y, sc[j]);
          if (a.shift) y = __fadd_rn(y, sh[j]);
          if (a.bias) y = __fadd_rn(y, bi[j]);
          if (a.residual) y = __fadd_rn(y, res[u]);
          if (a.relu) y = fmaxf(y, 0.f);
          v[u] = y;
        }
        *reinterpret_cast<float4*>(a.out + off_o + g * 4) = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

template <int BN, int TM>
int launch(const Q8WholeArgs& a, int smem, cudaStream_t stream) {
  static int granted = 0;
  if (smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(conv2d_q8_whole_kernel<BN, TM>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    granted = smem;
  }
  const dim3 grid((a.p + a.rb_p - 1) / a.rb_p, a.k / a.k_blk, a.n);
  conv2d_q8_whole_kernel<BN, TM><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_tm(const Q8WholeArgs& a, int tm, int smem, cudaStream_t stream) {
  switch (tm) {
    case 4: return launch<BN, 4>(a, smem, stream);
    case 8: return launch<BN, 8>(a, smem, stream);
    case 12: return launch<BN, 12>(a, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- the mma route: mma.sync s8 on the tensor cores -------------------------

namespace q8 {

constexpr int kMmaThreads = 256;   // 4 x 2 warps
constexpr int kPassPixels = 128;   // output pixels of a pass at most: 4 warps x 32
constexpr int kPW = kWords + 4;    // words of a staged band pixel: conflict-free fragments
constexpr int kWPad = 8;           // words past each staged weight row

// Rows [p_begin, p_end) of one reference block, rows_cta rows a block, in
// passes of rows_pass rows by a segment of `cols` output columns (the full
// row Q when Q <= 128), each over all of C.  A pass's band is the window of
// padded input rows and columns it reads; band_rows x band_cols bound it.
// STAGES ring stages, one (pass, 32-channel slice) each.
template <int BN, int STAGES>
__global__ void __launch_bounds__(kMmaThreads, 2)
conv2d_q8_whole_kernel_mma(const Q8WholeArgs a, int rows_cta, int cols, int band_rows,
                           int band_cols) {
  constexpr int WN = 2, MT = 2, NT = BN / WN / 8;
  constexpr int kBS = BN + kWPad;
  extern __shared__ __align__(16) uint32_t ring[];
  const int taps = a.r * a.s;
  const int band_words = band_rows * band_cols * kPW;
  const int stage_words = band_words + taps * kWords * kBS;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int wm0 = (warp / WN) * 32, wn0 = (warp % WN) * (BN / WN);
  const int nn = blockIdx.z;
  const int k0 = blockIdx.y * a.k_blk;
  const int cuts = (a.rb_p + rows_cta - 1) / rows_cta;
  const int pb = blockIdx.x / cuts;
  const int p_begin = pb * a.rb_p + (blockIdx.x % cuts) * rows_cta;
  const int p_end = min(min(pb * a.rb_p + a.rb_p, p_begin + rows_cta), a.p);
  if (p_begin >= p_end) return;
  const int slices = (a.c + kBK - 1) / kBK;
  const int cw = a.c / 4;  // words per weight row
  const int col_passes = (a.q + cols - 1) / cols;
  const int steps = (p_end - p_begin + a.rows_pass - 1) / a.rows_pass * col_passes * slices;
  const int8_t* xn = a.xp + static_cast<int64_t>(nn) * a.hp * a.wp * a.c;

  // The pass of step t (slices innermost): its first row, first column,
  // rows, columns and band width.
  struct Pass {
    int prow, q0, rows, pc, bw;
  };
  auto pass_of = [&](int t) {
    const int ps = t / slices;
    Pass v;
    v.prow = p_begin + ps / col_passes * a.rows_pass;
    v.q0 = ps % col_passes * cols;
    v.rows = min(a.rows_pass, p_end - v.prow);
    v.pc = min(cols, a.q - v.q0);
    v.bw = (v.pc - 1) * a.stride + a.s;
    return v;
  };

  auto load = [&](int t) {
    const Pass v = pass_of(t);
    const int c0 = t % slices * kBK;
    uint32_t* band = ring + t % STAGES * stage_words;
    uint32_t* wts = band + band_words;
    // band pixel j*bw + col is plane row prow*stride + j, column q0*stride + col
    const int8_t* xwin =
        xn + (static_cast<int64_t>(v.prow) * a.stride * a.wp + v.q0 * a.stride) * a.c;
    const int band_chunks = ((v.rows - 1) * a.stride + a.r) * v.bw * 2;  // 16 channels each
    for (int idx = tid; idx < band_chunks; idx += kMmaThreads) {
      const int pix = idx / 2, half = idx % 2;
      const bool ok = c0 + half * 16 < a.c;
      cp_async16(band + pix * kPW + half * 4,
                 ok ? xwin + (static_cast<int64_t>(pix / v.bw) * a.wp + pix % v.bw) * a.c + c0 +
                          half * 16
                    : a.xp,
                 ok ? 16 : 0);
    }
    const int w_chunks = taps * kWords * (BN / 4);  // 4 output channels each
    for (int idx = tid; idx < w_chunks; idx += kMmaThreads) {
      const int kk = idx % (BN / 4) * 4;
      const int row = idx / (BN / 4);  // tap * kWords + word
      const int word = c0 / 4 + row % kWords;
      const bool ok = kk < a.k_blk && word < cw;
      cp_async16(wts + row * kBS + kk,
                 ok ? a.wt + static_cast<int64_t>(row / kWords * cw + word) * a.k + k0 + kk : a.wt,
                 ok ? 16 : 0);
    }
  };

  const float xs = *a.x_scale;
  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][j][u] = 0;

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < steps) load(t);
    cp_async_commit();
  }
  Pass v{};
  int px = 0;
  int boff[MT][2];  // this thread's fragment rows as band offsets of tap (0, 0)
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<STAGES - 2>();  // step t has landed
    __syncthreads();              // and every warp is done with step t - 1
    if (t + STAGES - 1 < steps) load(t + STAGES - 1);
    cp_async_commit();
    const int sc = t % slices;
    if (sc == 0) {
      v = pass_of(t);
      px = v.rows * v.pc;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = wm0 + i * 16 + g + 8 * h;
          boff[i][h] = m < px ? ((m / v.pc) * a.stride * v.bw + (m % v.pc) * a.stride) * kPW : 0;
        }
    }
    const bool active = wm0 < px;  // the same for a whole warp
    if (active) {
      const uint32_t* band = ring + t % STAGES * stage_words;
      const uint32_t* wts = band + band_words + wn0 + g;
      for (int tap = 0; tap < taps; ++tap) {
        const uint32_t* at = band + ((tap / a.s) * v.bw + tap % a.s) * kPW + tig;
        const uint32_t* bt = wts + (tap * kWords + tig) * kBS;
        uint32_t af[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          af[i][0] = at[boff[i][0]];
          af[i][1] = at[boff[i][1]];
          af[i][2] = at[boff[i][0] + 4];
          af[i][3] = at[boff[i][1] + 4];
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint32_t bf[2] = {bt[j * 8], bt[4 * kBS + j * 8]};
#pragma unroll
          for (int i = 0; i < MT; ++i) mma_s8(acc[i][j], af[i], bf);
        }
      }
    }
    if (sc != slices - 1 || !active) continue;

    // The pass's last slice: dequantize, the fused epilogue, one store; each
    // (pixel, k..k+1) pair is one aligned float2 (k_blk % 8 == 0).
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = wn0 + j * 8 + 2 * tig;
      if (col >= a.k_blk) continue;
      const int kk = k0 + col;
      float dq[2], scl[2], sh[2], bi[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        dq[u] = __fmul_rn(xs, a.w_scale[kk + u]);
        scl[u] = a.scale ? a.scale[kk + u] : 1.f;
        sh[u] = a.shift ? a.shift[kk + u] : 0.f;
        bi[u] = a.bias ? a.bias[kk + u] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = wm0 + i * 16 + g + 8 * h;
          if (m >= px) continue;
          const int64_t off =
              ((static_cast<int64_t>(nn) * a.p + v.prow + m / v.pc) * a.q + v.q0 + m % v.pc) *
                  a.k +
              kk;
          const float2 res = a.residual ? *reinterpret_cast<const float2*>(a.residual + off)
                                        : make_float2(0.f, 0.f);
          *reinterpret_cast<float2*>(a.out + off) =
              make_float2(dequant_epilogue(a, acc[i][j][2 * h], dq[0], scl[0], sh[0], bi[0], res.x),
                          dequant_epilogue(a, acc[i][j][2 * h + 1], dq[1], scl[1], sh[1], bi[1],
                                           res.y));
        }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[i][j][u] = 0;
  }
  cp_async_wait<0>();
}

template <int BN, int STAGES>
int launch(const Q8WholeArgs& a, int rows_cta, int cols, int band_rows, int band_cols, int smem,
           cudaStream_t stream) {
  auto kernel = conv2d_q8_whole_kernel_mma<BN, STAGES>;
  // per call: the attribute belongs to the current device
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cuts = (a.rb_p + rows_cta - 1) / rows_cta;
  const dim3 grid((a.p + a.rb_p - 1) / a.rb_p * cuts, a.k / a.k_blk, a.n);
  kernel<<<grid, kMmaThreads, smem, stream>>>(a, rows_cta, cols, band_rows, band_cols);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_stages(const Q8WholeArgs& a, int rows_cta, int cols, int band_rows, int band_cols,
                  int stages, int smem, cudaStream_t stream) {
  switch (stages) {
    case 2: return launch<BN, 2>(a, rows_cta, cols, band_rows, band_cols, smem, stream);
    case 3: return launch<BN, 3>(a, rows_cta, cols, band_rows, band_cols, smem, stream);
    case 4: return launch<BN, 4>(a, rows_cta, cols, band_rows, band_cols, smem, stream);
    case 6: return launch<BN, 6>(a, rows_cta, cols, band_rows, band_cols, smem, stream);
    case 8: return launch<BN, 8>(a, rows_cta, cols, band_rows, band_cols, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace q8

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Launches K10c on `stream` without synchronising and returns
// cudaGetLastError(): nonzero means the launch was refused or an earlier
// fault is pending.  The caller pads the plane (pad_input), lays the weights
// out as (R, S, C/4, K) words, checks shapes, dtypes, contiguity, alignment
// and the int32 overflow bound, and plans bn, tm, rows_pass and the shared
// memory (kernels/conv2d_direct.whole_plan).
extern "C" int repro_conv2d_q8_whole(const int8_t* xp, const int* wt, const float* x_scale,
                                     const float* w_scale, const float* scale,
                                     const float* shift, const float* bias,
                                     const float* residual, float* out, int n, int hp, int wp,
                                     int c, int k, int r, int s, int stride, int p, int q,
                                     int rb_p, int k_blk, int rows_pass, int bn, int tm,
                                     int smem, int relu, void* stream) {
  Q8WholeArgs a;
  a.xp = xp;
  a.wt = wt;
  a.x_scale = x_scale;
  a.w_scale = w_scale;
  a.scale = scale;
  a.shift = shift;
  a.bias = bias;
  a.residual = residual;
  a.out = out;
  a.n = n;
  a.hp = hp;
  a.wp = wp;
  a.c = c;
  a.k = k;
  a.r = r;
  a.s = s;
  a.stride = stride;
  a.p = p;
  a.q = q;
  a.rb_p = rb_p;
  a.k_blk = k_blk;
  a.rows_pass = rows_pass;
  a.relu = relu;
  if (n <= 0 || p <= 0 || q <= 0 || c % 8 || k_blk % kTN || k_blk > bn || k % k_blk ||
      rb_p <= 0 || rows_pass <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 32: return launch_tm<32>(a, tm, smem, st);
    case 64: return launch_tm<64>(a, tm, smem, st);
    case 128: return launch_tm<128>(a, tm, smem, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The mma route (mma.sync s8 on the tensor cores), with the arguments of
// repro_conv2d_q8_whole but: `rows_cta`, the rows of a reference block one
// block takes (rb_p itself uncut; kernels/conv2d_q8.whole_rows_cta); a
// pass of `rows_pass` rows by `cols` output columns (Q itself when Q <= 128;
// at most 128 pixels); `band_rows` x `band_cols`, the padded input window a
// pass's band may take; `bn`, 32, 64 or 128 output channels a block holds
// (k_blk rounded up); `stages`, the ring's stages (2, 3, 4, 6 or 8);
// `smem`, the dynamic shared memory of the ring
// (kernels/conv2d_q8.whole_mma_plan).  C must be a multiple of 16, k_blk
// of 8, and xp, wt, out and residual 16-byte aligned.  Returns
// cudaErrorInvalidValue for arguments off that rule, else cudaGetLastError().
extern "C" int repro_conv2d_q8_whole_mma(const int8_t* xp, const int* wt, const float* x_scale,
                                         const float* w_scale, const float* scale,
                                         const float* shift, const float* bias,
                                         const float* residual, float* out, int n, int hp,
                                         int wp, int c, int k, int r, int s, int stride, int p,
                                         int q, int rb_p, int k_blk, int rows_cta, int rows_pass,
                                         int cols, int band_rows, int band_cols, int bn,
                                         int stages, int smem, int relu, void* stream) {
  Q8WholeArgs a;
  a.xp = xp;
  a.wt = wt;
  a.x_scale = x_scale;
  a.w_scale = w_scale;
  a.scale = scale;
  a.shift = shift;
  a.bias = bias;
  a.residual = residual;
  a.out = out;
  a.n = n;
  a.hp = hp;
  a.wp = wp;
  a.c = c;
  a.k = k;
  a.r = r;
  a.s = s;
  a.stride = stride;
  a.p = p;
  a.q = q;
  a.rb_p = rb_p;
  a.k_blk = k_blk;
  a.rows_pass = rows_pass;
  a.relu = relu;
  if (n <= 0 || p <= 0 || q <= 0 || c <= 0 || c % 16 || k_blk <= 0 || k_blk % 8 || k_blk > bn ||
      k % k_blk || rb_p <= 0 || rows_cta <= 0 || rows_cta > rb_p || rows_pass <= 0 ||
      cols <= 0 || cols > q || rows_pass * cols > q8::kPassPixels ||
      (rows_pass - 1) * stride + r > band_rows || (cols - 1) * stride + s > band_cols ||
      !aligned16(xp) || !aligned16(wt) || !aligned16(out) || (residual && !aligned16(residual)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 32:
      return q8::launch_stages<32>(a, rows_cta, cols, band_rows, band_cols, stages, smem, st);
    case 64:
      return q8::launch_stages<64>(a, rows_cta, cols, band_rows, band_cols, stages, smem, st);
    case 128:
      return q8::launch_stages<128>(a, rows_cta, cols, band_rows, band_cols, stages, smem, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
