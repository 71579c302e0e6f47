// K10a on Hopper: direct convolution forward with the fused §II-G epilogue,
// by the reference's legacy whole-plane strategy.
//
// Replaces the Pallas kernel repro/kernels/conv2d_direct.py:_conv2d_whole_plane
// (_kernel_whole).  Same function as K1 (csrc/conv2d_direct.cu): xp, the
// padded plane (N,HP,WP,C) that the wrapper makes with pad_input, w (R,S,C,K)
// -> out (N,P,Q,K), f32 accumulation, then scale, shift, bias, residual, relu
// in that order.  Built with nvcc for sm_90a and bound through the plain C
// functions at the bottom (ctypes; see repro_torch/kernels/_build.py).
//
// The strategy, in Hopper terms, shared by both routes:
//   * The reference's output block is an image, k_blk output channels and
//     rb_p rows by the full row Q, and its pixels' sums run over all of C in
//     one block.  No C split across blocks.
//   * "Resident" means resident in L2: the padded plane of one image at
//     ResNet-50's lane-aligned layers is at most 3.4 MB against 50 MB of L2,
//     far above a block's 227 KB of shared memory.  So a block stages the
//     band of padded input rows a pass of its output rows reads, slice by
//     slice of C, with the matching weight slice.  The wrapper's padding
//     covers the halo and the ceil-div tail: no bounds test in any load.
//   * The epilogue uses non-contracting multiplies and adds, so its rounding
//     follows the reference's order exactly.
//
// Two routes, chosen in the wrapper (kernels/conv2d_direct.route_whole):
//
// conv2d_direct_whole_kernel_mma, for C and K multiples of 4 and 16-byte
// aligned x and w: the products on the tensor cores by the 3xTF32 split of
// conv_tf32.cuh (each (32-channel slice, tap) stage summed in a zeroed run
// accumulator that then joins the block's f32 sums).  The grid is the
// reference's (P_b x row slices, K_b, N): a block takes a slice of rows of
// one reference block (conv2d_direct.whole_split decides whether a block is
// cut into slices; each pixel's sum stays in one block in the same order, so
// the cut changes no bit), in passes of at most 128 output pixels (whole
// rows, or a segment of a row longer than that), each over all of C.  A pass
// stages the window of the padded plane it reads (its band) in 32-channel
// slices into a ring of 2 (pixel rows padded to 36 floats) and the 32 x BN
// weight slice of each tap into a ring of 3, all by cp.async; each output
// pixel's A row is read from the band at (row*stride + r, q*stride + s).
// 8 warps of 32 pixels x BN/2 channels, one block an SM; a warp whose
// pixels all lie past the pass skips the products.
//
// conv2d_direct_whole_kernel, every other shape: f32 FMA on the SIMT cores.
// The grid is the reference's (P_b, K_b, N); each pass stages its band by
// the full padded width in slices of 8 channels with the matching (R, S, 8,
// BN) weight slice, double buffered by cp.async, and each thread keeps a
// TM-pixel x 8-channel register tile.  When the block's rb_p x Q pixels
// exceed the threads' tiles (a q8-sized rb_p), the block makes several
// passes of rows_pass rows.  Rows of the last block past P (rb_p need not
// divide P) are computed from the padded plane's slack and not stored.
// Offsets into xp, out and residual are 64-bit.
#include <cstdint>

#include <cuda_runtime.h>

#include "conv_tf32.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 8;  // input channels per staged slice
constexpr int kTN = 8;  // output channels per thread

struct WholeArgs {
  const float* xp;        // padded plane (N, HP, WP, C)
  const float* w;         // (R, S, C, K)
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

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int BN, int TM>
__global__ void __launch_bounds__(kThreads)
conv2d_direct_whole_kernel(const WholeArgs a) {
  constexpr int kTX = BN / kTN;       // threads along K
  constexpr int kTY = kThreads / kTX; // threads along pixels
  extern __shared__ __align__(16) float smem[];
  const int band_floats = ((a.rows_pass - 1) * a.stride + a.r) * a.wp * kBK;
  const int w_floats = a.r * a.s * kBK * BN;
  float* band[2] = {smem, smem + band_floats + w_floats};
  float* wts[2] = {smem + band_floats, smem + 2 * band_floats + w_floats};

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int nn = blockIdx.z;
  const int k0 = blockIdx.y * a.k_blk;
  const int p_begin = blockIdx.x * a.rb_p;
  const int p_end = min(p_begin + a.rb_p, a.p);
  const int slices = a.c / kBK;
  const int taps = a.r * a.s;
  const int w_chunks = taps * kBK * (BN / 4);
  const float* xn = a.xp + static_cast<int64_t>(nn) * a.hp * a.wp * a.c;

  for (int pp0 = p_begin; pp0 < p_end; pp0 += a.rows_pass) {
    const int rows = min(a.rows_pass, p_end - pp0);
    const int pixels = rows * a.q;
    const int band_chunks = ((rows - 1) * a.stride + a.r) * a.wp * (kBK / 4);
    // the pass's first padded row; band pixel j*WP + col is plane row
    // pp0*stride + j, column col, whose channels lie C floats apart
    const float* xrow = xn + static_cast<int64_t>(pp0) * a.stride * a.wp * a.c;

    int off[TM];  // this thread's output pixels, as band offsets of tap (0, 0)
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = ty + i * kTY;
      const int pl = m / a.q;
      const int qq = m - pl * a.q;
      off[i] = m < pixels ? (pl * a.stride * a.wp + qq * a.stride) * kBK : 0;
    }

    auto fetch = [&](int slice, int buf) {
      const int c0 = slice * kBK;
      for (int idx = tid; idx < band_chunks; idx += kThreads)
        cp_async16(band[buf] + idx * 4, xrow + static_cast<int64_t>(idx >> 1) * a.c + c0 + (idx & 1) * 4,
                   16);
      for (int idx = tid; idx < w_chunks; idx += kThreads) {
        const int kk = (idx % (BN / 4)) * 4;
        const int row = idx / (BN / 4);  // tap * kBK + channel
        const int tap = row / kBK;
        const bool ok = kk < a.k_blk;
        const float* src =
            ok ? a.w + static_cast<int64_t>(tap * a.c + c0 + row % kBK) * a.k + k0 + kk : a.w;
        cp_async16(wts[buf] + row * BN + kk, src, ok ? 16 : 0);
      }
    };

    float acc[TM][kTN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

    fetch(0, 0);
    cp_async_commit();
    for (int t = 0; t < slices; ++t) {
      const int buf = t & 1;
      if (t + 1 < slices) {
        fetch(t + 1, buf ^ 1);
        cp_async_commit();
        cp_async_wait<1>();  // slice t has landed
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* B = band[buf];
      const float* W = wts[buf] + tx * kTN;
      for (int rr = 0; rr < a.r; ++rr) {
        for (int ss = 0; ss < a.s; ++ss) {
          const int toff = (rr * a.wp + ss) * kBK;
          const float* Wt = W + (rr * a.s + ss) * kBK * BN;
#pragma unroll
          for (int kc = 0; kc < kBK; ++kc) {
            float af[TM];
#pragma unroll
            for (int i = 0; i < TM; ++i) af[i] = B[off[i] + toff + kc];
            const float4 b0 = *reinterpret_cast<const float4*>(Wt + kc * BN);
            const float4 b1 = *reinterpret_cast<const float4*>(Wt + kc * BN + 4);
            const float bf[kTN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
              for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(af[i], bf[j], acc[i][j]);
          }
        }
      }
      __syncthreads();  // every thread is done with buf before it refills
    }

    // Fused epilogue (reference order: scale, shift, bias, residual, relu).
    if (tx * kTN >= a.k_blk) continue;
    const int kk0 = k0 + tx * kTN;
    float sc[kTN], sh[kTN], bi[kTN];
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
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
          float y = acc[i][j];
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
int launch(const WholeArgs& a, int smem, cudaStream_t stream) {
  static int granted = 0;  // dynamic shared memory this instance may take
  if (smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(conv2d_direct_whole_kernel<BN, TM>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    granted = smem;
  }
  const dim3 grid((a.p + a.rb_p - 1) / a.rb_p, a.k / a.k_blk, a.n);
  conv2d_direct_whole_kernel<BN, TM><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_tm(const WholeArgs& a, int tm, int smem, cudaStream_t stream) {
  switch (tm) {
    case 4: return launch<BN, 4>(a, smem, stream);
    case 8: return launch<BN, 8>(a, smem, stream);
    case 12: return launch<BN, 12>(a, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}


// ---- the mma route: 3xTF32 on the tensor cores ------------------------------

namespace tc {

constexpr int kMmaThreads = 256;       // 4 x 2 warps
constexpr int kPassPixels = 128;       // output pixels of a pass at most: 4 warps x 32
constexpr int kPS = kStageK + 4;       // floats of a staged band pixel: conflict-free fragments
constexpr int kBPad = 8;               // floats past each staged weight row
constexpr int kWStages = 3;            // weight ring: one (slice, tap) each
constexpr int kBandStages = 2;         // band ring: one 32-channel slice each

// Rows [p_begin, p_end) of one reference block, rows_cta rows a block, in
// passes of rows_pass rows by a segment of `cols` output columns (the full
// row Q when Q <= 128), each over all of C.  A pass's band is the window of
// padded input rows and columns it reads; band_rows x band_cols bound it.
template <int BN>
__global__ void __launch_bounds__(kMmaThreads, 1)
conv2d_direct_whole_kernel_mma(const WholeArgs a, int rows_cta, int rows_pass, int cols,
                               int band_rows, int band_cols) {
  constexpr int WN = 2, MT = 2, NT = BN / WN / 8;
  constexpr int kBS = BN + kBPad;
  constexpr int kWFloats = kStageK * kBS;
  extern __shared__ __align__(16) float smem[];
  const int band_floats = band_rows * band_cols * kPS;
  float* wring = smem;
  float* bring = smem + kWStages * kWFloats;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int wm0 = (warp / WN) * 32, wn0 = (warp % WN) * (BN / WN);
  const int nn = blockIdx.z;
  const int k0 = blockIdx.y * a.k_blk;
  const int slices = (a.rb_p + rows_cta - 1) / rows_cta;
  const int pb = blockIdx.x / slices;
  const int p_begin = pb * a.rb_p + (blockIdx.x % slices) * rows_cta;
  const int p_end = min(min(pb * a.rb_p + a.rb_p, p_begin + rows_cta), a.p);
  if (p_begin >= p_end) return;
  const int taps = a.r * a.s;
  const int steps = (a.c + kStageK - 1) / kStageK * taps;  // (slice, tap), taps innermost
  // a band buffer is refilled only after its slice's last tap: prefetch
  // distance 2, or 1 for a 1x1 filter
  const int ahead = taps >= 2 ? 2 : 1;
  const float* xn = a.xp + static_cast<int64_t>(nn) * a.hp * a.wp * a.c;
  const int b_col = (tid % (BN / 4)) * 4;
  const bool b_ok = b_col < a.k_blk;

  for (int prow = p_begin; prow < p_end; prow += rows_pass)
    for (int q0 = 0; q0 < a.q; q0 += cols) {
      const int rows = min(rows_pass, p_end - prow);
      const int pc = min(cols, a.q - q0);
      const int px = rows * pc;
      const int bw = (pc - 1) * a.stride + a.s;  // band columns of this pass
      const int band_chunks = ((rows - 1) * a.stride + a.r) * bw * (kStageK / 4);
      // band pixel j*bw + col is plane row prow*stride + j, column q0*stride + col
      const float* xwin =
          xn + (static_cast<int64_t>(prow) * a.stride * a.wp + q0 * a.stride) * a.c;
      const bool active = wm0 < px;  // the same for a whole warp

      int boff[MT][2];  // this thread's fragment rows as band offsets of tap (0, 0)
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = wm0 + i * 16 + g + 8 * h;
          boff[i][h] = m < px ? ((m / pc) * a.stride * bw + (m % pc) * a.stride) * kPS : 0;
        }

      auto load = [&](int t) {
        const int sc = t / taps, tap = t - sc * taps;
        const int c0 = sc * kStageK;
        if (tap == 0) {
          float* band = bring + (sc % kBandStages) * band_floats;
          for (int idx = tid; idx < band_chunks; idx += kMmaThreads) {
            const int pix = idx / (kStageK / 4), cg = (idx % (kStageK / 4)) * 4;
            const bool ok = c0 + cg < a.c;
            cp_async16(band + pix * kPS + cg,
                       ok ? xwin + (static_cast<int64_t>(pix / bw) * a.wp + pix % bw) * a.c + c0 +
                                cg
                          : a.xp,
                       ok ? 16 : 0);
          }
        }
        float* wt = wring + (t % kWStages) * kWFloats;
        for (int row = tid / (BN / 4); row < kStageK; row += kMmaThreads / (BN / 4)) {
          const bool ok = b_ok && c0 + row < a.c;
          cp_async16(wt + row * kBS + b_col,
                     ok ? a.w + (static_cast<int64_t>(tap) * a.c + c0 + row) * a.k + k0 + b_col
                        : a.w,
                     ok ? 16 : 0);
        }
      };

      float acc[MT][NT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

      for (int t = 0; t < ahead; ++t) {
        if (t < steps) load(t);
        cp_async_commit();
      }
      for (int t = 0; t < steps; ++t) {
        if (ahead == 2)
          cp_async_wait<1>();  // step t has landed
        else
          cp_async_wait<0>();
        __syncthreads();       // and every warp is done with step t - 1
        if (t + ahead < steps) load(t + ahead);
        cp_async_commit();
        if (active) {
          const int sc = t / taps, tap = t - sc * taps;
          const float* band = bring + (sc % kBandStages) * band_floats +
                              ((tap / a.s) * bw + tap % a.s) * kPS;
          const float* arow[MT][2];
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) arow[i][h] = band + boff[i][h];
          stage_products<MT, NT>(acc, arow, wring + (t % kWStages) * kWFloats + wn0 + g, kBS);
        }
      }
      cp_async_wait<0>();
      __syncthreads();  // every warp is done with the rings before the next pass

      // each (pixel, k..k+1) pair is one aligned float2: k_blk % 8 == 0
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = wn0 + j * 8 + 2 * tig;
        if (!active || col >= a.k_blk) continue;
        const int kk = k0 + col;
        float sc[2], sh[2], bi[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          sc[u] = a.scale ? a.scale[kk + u] : 1.f;
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
                ((static_cast<int64_t>(nn) * a.p + prow + m / pc) * a.q + q0 + m % pc) * a.k + kk;
            const float2 res = a.residual ? *reinterpret_cast<const float2*>(a.residual + off)
                                          : make_float2(0.f, 0.f);
            *reinterpret_cast<float2*>(a.out + off) =
                make_float2(epilogue(a, acc[i][j][2 * h], sc[0], sh[0], bi[0], res.x),
                            epilogue(a, acc[i][j][2 * h + 1], sc[1], sh[1], bi[1], res.y));
          }
      }
    }
}

template <int BN>
int launch(const WholeArgs& a, int rows_cta, int rows_pass, int cols, int band_rows,
           int band_cols, int smem, cudaStream_t stream) {
  auto kernel = conv2d_direct_whole_kernel_mma<BN>;
  // per call: the attribute belongs to the current device
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int slices = (a.rb_p + rows_cta - 1) / rows_cta;
  const dim3 grid((a.p + a.rb_p - 1) / a.rb_p * slices, a.k / a.k_blk, a.n);
  kernel<<<grid, kMmaThreads, smem, stream>>>(a, rows_cta, rows_pass, cols, band_rows, band_cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }
}  // namespace

// Launches K10a on `stream` without synchronising and returns
// cudaGetLastError(): nonzero means the launch was refused or an earlier
// fault is pending.  The caller pads the plane (pad_input), checks shapes,
// dtypes, contiguity and 16-byte alignment, and plans bn, tm, rows_pass and
// the shared memory (kernels/conv2d_direct.whole_plan).
extern "C" int repro_conv2d_direct_whole_f32(const float* xp, const float* w, const float* scale,
                                             const float* shift, const float* bias,
                                             const float* residual, float* out, int n, int hp,
                                             int wp, int c, int k, int r, int s, int stride, int p,
                                             int q, int rb_p, int k_blk, int rows_pass, int bn,
                                             int tm, int smem, int relu, void* stream) {
  WholeArgs a;
  a.xp = xp;
  a.w = w;
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
  if (n <= 0 || p <= 0 || q <= 0 || c % kBK || k_blk % kTN || k_blk > bn || k % k_blk ||
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

// The mma route (3xTF32 on the tensor cores), with the arguments of
// repro_conv2d_direct_whole_f32 but: `rows_cta`, the rows of a reference
// block one block takes (rb_p itself unsplit; kernels/conv2d_direct.whole_split);
// a pass of `rows_pass` rows by `cols` output columns (Q itself when Q <=
// 128; at most 128 pixels); `band_rows` x `band_cols`, the padded input
// window a pass's band may take; `bn`, 32, 64 or 128 output channels a block
// holds (k_blk rounded up); `smem`, the dynamic shared memory of the two
// rings (kernels/conv2d_direct.whole_mma_plan).  C must be a multiple of 4,
// k_blk of 8, and xp, w, out and residual 16-byte aligned.  Returns
// cudaErrorInvalidValue for arguments off that rule, else cudaGetLastError().
extern "C" int repro_conv2d_direct_whole_mma(const float* xp, const float* w, const float* scale,
                                             const float* shift, const float* bias,
                                             const float* residual, float* out, int n, int hp,
                                             int wp, int c, int k, int r, int s, int stride, int p,
                                             int q, int rb_p, int k_blk, int rows_cta,
                                             int rows_pass, int cols, int band_rows,
                                             int band_cols, int bn, int smem, int relu,
                                             void* stream) {
  WholeArgs a;
  a.xp = xp;
  a.w = w;
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
  if (n <= 0 || p <= 0 || q <= 0 || c <= 0 || c % 4 || k_blk <= 0 || k_blk % 8 || k_blk > bn ||
      k % k_blk || rb_p <= 0 || rows_cta <= 0 || rows_cta > rb_p || rows_pass <= 0 || cols <= 0 ||
      cols > q || rows_pass * cols > tc::kPassPixels ||
      (rows_pass - 1) * stride + r > band_rows || (cols - 1) * stride + s > band_cols ||
      !aligned16(xp) || !aligned16(w) || !aligned16(out) || (residual && !aligned16(residual)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 32: return tc::launch<32>(a, rows_cta, rows_pass, cols, band_rows, band_cols, smem, st);
    case 64: return tc::launch<64>(a, rows_cta, rows_pass, cols, band_rows, band_cols, smem, st);
    case 128: return tc::launch<128>(a, rows_cta, rows_pass, cols, band_rows, band_cols, smem, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
