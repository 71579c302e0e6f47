// K4 on Hopper: replay of a §II-H kernel-stream schedule.
//
// Replaces the Pallas kernel repro/kernels/conv2d_streams.py:conv2d_streams
// (_kernel, pallas_call at :104).  Same function: x (N,H,W,C) NHWC,
// w (R,S,C,K) RSCK, an optional bias (K) and the five int32 streams of a
// dryrun schedule (flags, n, k-block, row-block, c-block; one entry per
// step) -> out (N,P,Q,K) f32.  A step adds the (r, s) products of one
// c_blk slice of C into the rb_p x Q x k_blk output tile it names;
// FLAG_INIT zeroes the tile's accumulator, FLAG_EPILOGUE adds the bias,
// clamps at 0 under FLAG_RELU, and writes the tile.  Built with nvcc for
// sm_90a and bound through the plain C function at the bottom (ctypes; see
// repro_torch/kernels/_build.py).
//
// The kernel reads the streams from device memory and obeys the flag of
// every step it executes; it does not recompute either from its grid
// position.  What it takes from the host besides the streams is the index
// of each run's first step (its FLAG_INIT step), so that CTA groups can
// start in parallel: the TPU's grid walks the schedule in order on one
// core, and 132 SMs cannot.
//   * A run (the steps from FLAG_INIT to FLAG_EPILOGUE of one tile, C
//     innermost, contiguous) is owned by a fixed set of CTAs that split the
//     tile into BM-pixel x BN-channel sub-tiles; each replays the whole run,
//     so its accumulator stays in registers across the C-blocks and the
//     tile is written once, at the epilogue step (the TPU keeps it in the
//     output VMEM block).  A 56x56 tile of 8 rows is 448 pixels x 128
//     channels: 4 x 2 CTAs of 128 x 64.
//   * CTAs are numbered in schedule order (run j holds CTAs j*subs ..
//     j*subs + subs - 1), so the dryrun's loop order decides which tiles
//     are in flight together and share input planes and weight blocks in
//     the 50 MB L2.
//   * The inner product is K1's: SIMT f32 FMA on a TM x TN register tile
//     per thread, from a double-buffered shared-memory slice of one (r, s)
//     and 8 channels of the step's c-block.  The walk over (step, r, s,
//     8 channels) is one pipeline: while one slice is multiplied, the next
//     one (the next step's, read from the streams, at a step boundary: the
//     §II-E prefetch property) is loaded into registers.  Masks make the
//     zero halo of `padding`, the P tail of a row block that rb_p does not
//     divide, and ragged c_blk / k_blk edges; there is no padded copy.
//   * What bounds it: the same FLOPs as K1, above the f32 ridge at
//     ResNet-50's shapes, so the SIMT f32 FMA rate (67 TFLOP/s).
// Offsets into x and out are 64-bit.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 8;  // input channels per pipeline stage
constexpr int kFlagInit = 1;
constexpr int kFlagEpilogue = 2;
constexpr int kFlagRelu = 4;

struct StreamArgs {
  const float* x;
  const float* w;
  const float* bias;  // may be null
  const int* flags;   // the five streams, `steps` entries each
  const int* n_ids;
  const int* kb_ids;
  const int* pb_ids;
  const int* cb_ids;
  const int* run_start;  // first step of every run, in schedule order
  float* out;
  int steps;
  int n, h, wd, c, k, r, s, stride, pad, p, q;
  int rb_p, k_blk, c_blk;
  int m_sub, k_sub;  // sub-tiles per run along pixels and channels
  int vec4;          // K % 4 == 0, k_blk % 4 == 0 and out 16-byte aligned
};

// Where the replay stands: step i (flag f, c-block offset cbase), and the
// (r, s, 8-channel) slice of that step.
struct Cursor {
  int i, f, cbase, rr, ss, c0;
  bool first;  // first slice of step i
};

template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
conv2d_streams_kernel(const StreamArgs a) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "one register tile per thread");
  static_assert(TM % 4 == 0 && TN % 4 == 0, "register tiles are float4 groups");
  constexpr int kAPer = BM * kBK / kThreads;                    // input values staged per thread
  constexpr int kBVals = BN * kBK;                              // weight values per stage
  constexpr int kBPer = (kBVals + kThreads - 1) / kThreads;     // per thread (some idle if BN < 32)
  constexpr int kTX = BN / TN;                                  // threads along K
  constexpr int kMGroup = BM * 4 / TM;  // row distance between a thread's float4 groups
  constexpr int kNGroup = BN * 4 / TN;
  static_assert(kAPer >= 1, "BM too small");
  __shared__ __align__(16) float As[2][kBK][BM + 4];
  __shared__ __align__(16) float Bs[2][kBK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int subs = a.m_sub * a.k_sub;
  const int run = blockIdx.x / subs;
  const int sub = blockIdx.x % subs;
  const int m0 = (sub / a.k_sub) * BM;  // first pixel of this sub-tile in the tile
  const int kt0 = (sub % a.k_sub) * BN;  // first channel of this sub-tile in the k-block

  // The run's output tile, as its first step names it in the streams.
  const int first = a.run_start[run];
  const int nn = a.n_ids[first];
  const int p0 = a.pb_ids[first] * a.rb_p;
  const int rows = min(a.rb_p, a.p - p0);
  const int tile_m = rows * a.q;
  if (m0 >= tile_m) return;  // past the last pixel of a tail tile
  const int k_base = a.kb_ids[first] * a.k_blk + kt0;
  const int k_lim = a.k_blk - kt0;  // this sub-tile's channels are j < k_lim

  const int a_kc = tid % kBK;  // this thread stages channel a_kc of its pixels
  int a_ih0[kAPer], a_iw0[kAPer];
#pragma unroll
  for (int i = 0; i < kAPer; ++i) {
    const int m = m0 + tid / kBK + i * (kThreads / kBK);
    if (m < tile_m) {
      a_ih0[i] = (p0 + m / a.q) * a.stride - a.pad;
      a_iw0[i] = (m % a.q) * a.stride - a.pad;
    } else {  // past the tile: every load of it is masked to zero
      a_ih0[i] = INT_MIN / 2;
      a_iw0[i] = INT_MIN / 2;
    }
  }
  const float* x_img = a.x + static_cast<int64_t>(nn) * a.h * a.wd * a.c;

  float a_reg[kAPer];
  float b_reg[kBPer];

  auto load = [&](const Cursor& t) {
    const int cl = t.c0 + a_kc;  // channel within the c-block
#pragma unroll
    for (int i = 0; i < kAPer; ++i) {
      const int ih = a_ih0[i] + t.rr;
      const int iw = a_iw0[i] + t.ss;
      const bool ok = cl < a.c_blk && static_cast<unsigned>(ih) < static_cast<unsigned>(a.h) &&
                      static_cast<unsigned>(iw) < static_cast<unsigned>(a.wd);
      a_reg[i] = ok ? __ldg(x_img + (static_cast<int64_t>(ih) * a.wd + iw) * a.c + t.cbase + cl)
                    : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kBPer; ++j) {
      const int idx = tid + j * kThreads;
      const int cc = t.c0 + idx / BN;
      const int kk = idx % BN;
      b_reg[j] = (idx < kBVals && cc < a.c_blk && kk < k_lim)
                     ? __ldg(a.w + (static_cast<int64_t>(t.rr * a.s + t.ss) * a.c + t.cbase + cc) *
                                       a.k +
                             k_base + kk)
                     : 0.f;
    }
  };

  auto stage = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kAPer; ++i) As[buf][a_kc][tid / kBK + i * (kThreads / kBK)] = a_reg[i];
#pragma unroll
    for (int j = 0; j < kBPer; ++j) {
      const int idx = tid + j * kThreads;
      if (idx < kBVals) Bs[buf][idx / BN][idx % BN] = b_reg[j];
    }
  };

  // The next slice of the run: 8 channels on, then s, then r, then the
  // next step of the streams.  False after the last slice of the run's
  // FLAG_EPILOGUE step (or of the schedule's last step).
  auto advance = [&](Cursor& t) -> bool {
    t.first = false;
    t.c0 += kBK;
    if (t.c0 < a.c_blk) return true;
    t.c0 = 0;
    if (++t.ss < a.s) return true;
    t.ss = 0;
    if (++t.rr < a.r) return true;
    t.rr = 0;
    if ((t.f & kFlagEpilogue) || t.i + 1 >= a.steps) return false;
    ++t.i;
    t.f = a.flags[t.i];
    t.cbase = a.cb_ids[t.i] * a.c_blk;
    t.first = true;
    return true;
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  Cursor cur{first, a.flags[first], a.cb_ids[first] * a.c_blk, 0, 0, 0, true};
  load(cur);
  stage(0);
  __syncthreads();

  for (int buf = 0;; buf ^= 1) {
    Cursor nxt = cur;
    const bool more = advance(nxt);
    if (more) load(nxt);
    if (cur.first && (cur.f & kFlagInit)) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    }
#pragma unroll
    for (int kc = 0; kc < kBK; ++kc) {
      float af[TM], bf[TN];
#pragma unroll
      for (int g = 0; g < TM / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(&As[buf][kc][g * kMGroup + ty * 4]);
        af[g * 4 + 0] = v.x;
        af[g * 4 + 1] = v.y;
        af[g * 4 + 2] = v.z;
        af[g * 4 + 3] = v.w;
      }
#pragma unroll
      for (int g = 0; g < TN / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(&Bs[buf][kc][g * kNGroup + tx * 4]);
        bf[g * 4 + 0] = v.x;
        bf[g * 4 + 1] = v.y;
        bf[g * 4 + 2] = v.z;
        bf[g * 4 + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(af[i], bf[j], acc[i][j]);
    }
    if (more) stage(buf ^ 1);
    __syncthreads();
    if (!more) break;
    cur = nxt;
  }

  // `cur` is the run's last step: the epilogue fires only on its flag.
  if (!(cur.f & kFlagEpilogue)) return;
  const bool relu = (cur.f & kFlagRelu) != 0;
  float bi[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int jj = (j / 4) * kNGroup + tx * 4 + (j % 4);
    bi[j] = (jj < k_lim && a.bias) ? a.bias[k_base + jj] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + (i / 4) * kMGroup + ty * 4 + (i % 4);
    if (m >= tile_m) continue;
    const int64_t row =
        (static_cast<int64_t>(nn) * a.p + p0 + m / a.q) * a.q + m % a.q;
#pragma unroll
    for (int g = 0; g < TN / 4; ++g) {
      const int jj = g * kNGroup + tx * 4;
      if (jj >= k_lim) continue;
      const int64_t off = row * a.k + k_base + jj;
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float y = __fadd_rn(acc[i][g * 4 + u], bi[g * 4 + u]);
        v[u] = relu ? fmaxf(y, 0.f) : y;
      }
      if (a.vec4) {
        *reinterpret_cast<float4*>(a.out + off) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (jj + u < k_lim) a.out[off + u] = v[u];
      }
    }
  }
}

template <int BM, int BN, int TM, int TN>
int launch(StreamArgs a, int runs, cudaStream_t stream) {
  const int tile_m = a.rb_p * a.q;
  a.m_sub = (tile_m + BM - 1) / BM;
  a.k_sub = (a.k_blk + BN - 1) / BN;
  const int64_t blocks = static_cast<int64_t>(runs) * a.m_sub * a.k_sub;
  if (blocks <= 0 || blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  conv2d_streams_kernel<BM, BN, TM, TN>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

}  // namespace

// Launches K4 on `stream` without synchronising and returns
// cudaGetLastError(): nonzero means the launch was refused or an earlier
// fault is pending.  `streams` holds the five streams back to back (flags,
// n, k-block, row-block, c-block; `steps` entries each), `run_start` the
// first step of each of the `runs` runs.  `tile` picks the CTA tile
// (BM x BN pixels x channels; kernels/conv2d_streams.py:TILES).  The caller
// checks shapes, dtypes, contiguity and that every stream entry is in
// range and every run is well formed.
extern "C" int repro_conv2d_streams_f32(const float* x, const float* w, const float* bias,
                                        const int* streams, int steps, const int* run_start,
                                        int runs, float* out, int n, int h, int wd, int c, int k,
                                        int r, int s, int stride, int pad, int rb_p, int k_blk,
                                        int c_blk, int tile, void* stream) {
  StreamArgs a;
  a.x = x;
  a.w = w;
  a.bias = bias;
  a.flags = streams;
  a.n_ids = streams + steps;
  a.kb_ids = streams + 2 * static_cast<int64_t>(steps);
  a.pb_ids = streams + 3 * static_cast<int64_t>(steps);
  a.cb_ids = streams + 4 * static_cast<int64_t>(steps);
  a.run_start = run_start;
  a.out = out;
  a.steps = steps;
  a.n = n;
  a.h = h;
  a.wd = wd;
  a.c = c;
  a.k = k;
  a.r = r;
  a.s = s;
  a.stride = stride;
  a.pad = pad;
  a.p = (h + 2 * pad - r) / stride + 1;
  a.q = (wd + 2 * pad - s) / stride + 1;
  a.rb_p = rb_p;
  a.k_blk = k_blk;
  a.c_blk = c_blk;
  a.vec4 = (k % 4 == 0) && (k_blk % 4 == 0) && aligned16(out);
  if (steps <= 0 || runs <= 0 || a.p <= 0 || a.q <= 0 || rb_p <= 0 || k_blk <= 0 || c_blk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 0:
      return launch<128, 128, 8, 8>(a, runs, st);
    case 1:
      return launch<128, 64, 8, 4>(a, runs, st);
    case 2:
      return launch<64, 64, 4, 4>(a, runs, st);
    case 3:
      return launch<128, 32, 4, 4>(a, runs, st);
    case 4:
      return launch<256, 16, 4, 4>(a, runs, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
