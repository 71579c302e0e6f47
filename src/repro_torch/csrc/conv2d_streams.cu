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
//
// Two routes share that contract, chosen in the wrapper
// (kernels/conv2d_streams.route):
//
// conv2d_streams_kernel_mma, for C, K, c_blk and k_blk multiples of 4 and
// 16-byte aligned x and w: K1's mma route's products (conv_tf32.cuh), the
// f32 products on the tensor cores by the 3xTF32 split, each stage summed in
// a zeroed run accumulator (at most 12 products a tensor-core run) that then
// joins the run's f32 sums, which stay in registers across the run's
// c-blocks.  A stage is one (r, s) and 32 channels of the step's c_blk slice
// (16 or 8 where c_blk is that small, so a stage holds no idle channels;
// C innermost, then s, then r, then the next step), copied by 16-byte
// cp.async into a ring of 3 or 4 stages; the ring runs across step
// boundaries: the load cursor reads the next step's flag and c-block from
// the streams while the current step's last stages are multiplied (the
// §II-E prefetch property).  Zero-fill makes the padding halo, the P tail
// of a row block and ragged c_blk / k_blk edges; pixel rows are padded to
// 36 floats and weight rows by 8, so fragment loads are conflict-free.  The
// CTA sub-tiles are K1's mma tiles (128x128, 128x64, 64x128, 64x64;
// kernels/conv2d_streams.mma_tile_config).  There is no split of the
// reduction: a run's sums follow the schedule's c order alone, so shuffled
// runs give the same bits as runs in order.  Bound: 3 TF32 products per f32
// one at 494.7 TFLOP/s, or the bytes.
//
// conv2d_streams_kernel, every other shape: the SIMT design above.
// Offsets into x and out are 64-bit.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "conv_tf32.cuh"

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

// ---- the mma route: 3xTF32 on the tensor cores ------------------------------

namespace tc {

constexpr int kBPad = 8;  // floats past each staged weight row

// A BM x BN sub-tile of WM x WN warps, stages of KS input channels (32, or
// 16 or 8 for a c_blk that small), STAGES ring stages, MINB blocks an SM.
template <int BM, int BN, int WM, int WN, int KS, int STAGES, int MINB>
struct Cfg {
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int kWTM = BM / WM, kWTN = BN / WN;  // a warp's tile
  static constexpr int MT = kWTM / 16, NT = kWTN / 8;   // its m16n8 tiles
  static constexpr int kAS = KS + 4;  // floats of a staged pixel row: conflict-free fragments
  static constexpr int kBS = BN + kBPad;
  static constexpr int kStageFloats = BM * kAS + KS * kBS;
  static constexpr int kSmem = STAGES * kStageFloats * 4;
  static constexpr int kARows = kThreads / (KS / 4);  // pixel rows apart a thread's copies lie
  static constexpr int kACopies = (BM + kARows - 1) / kARows;  // x copies a thread makes a stage
  static constexpr int kBRows = kThreads / (BN / 4);
  static constexpr int kBCopies = (KS + kBRows - 1) / kBRows;  // w copies
  static_assert(kWTM % 16 == 0 && kWTN % 8 == 0, "m16n8 tiles");
  static_assert(kThreads % (KS / 4) == 0 && kThreads % (BN / 4) == 0,
                "a fixed 4-channel group per thread");
};

// A stage of the replay: step i (flag f, c-block offset cbase), its (r, s)
// and the 32-channel offset c0 within the c-block; `first` for the step's
// first stage.
struct Stage {
  int i, f, cbase, rr, ss, c0;
  bool first;
};

template <int BM, int BN, int WM, int WN, int KS, int STAGES, int MINB>
__global__ void __launch_bounds__(WM * WN * 32, MINB)
conv2d_streams_kernel_mma(const StreamArgs a) {
  using G = Cfg<BM, BN, WM, WN, KS, STAGES, MINB>;
  constexpr int MT = G::MT, NT = G::NT;
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int wm0 = (warp / WN) * G::kWTM, wn0 = (warp % WN) * G::kWTN;
  const int subs = a.m_sub * a.k_sub;
  const int run = blockIdx.x / subs;
  const int sub = blockIdx.x % subs;
  const int m0 = (sub / a.k_sub) * BM;   // first pixel of this sub-tile in the tile
  const int kt0 = (sub % a.k_sub) * BN;  // first channel of this sub-tile in the k-block

  // The run's output tile, as its first step names it in the streams.
  const int first = a.run_start[run];
  const int nn = a.n_ids[first];
  const int p0 = a.pb_ids[first] * a.rb_p;
  const int tile_m = min(a.rb_p, a.p - p0) * a.q;
  if (m0 >= tile_m) return;  // past the last pixel of a tail tile
  const int k_base = a.kb_ids[first] * a.k_blk + kt0;
  const int k_lim = a.k_blk - kt0;  // this sub-tile's channels are j < k_lim

  // this thread copies channels a_cg*4 .. +3 of the stage's pixel rows
  // tid / (KS/4) + i * kARows, and output channels b_col .. +3 of its
  // weight rows tid / (BN/4) + j * kBRows (those below BM and KS)
  const int a_cg = tid % (KS / 4);
  int a_ih0[G::kACopies], a_iw0[G::kACopies];
#pragma unroll
  for (int i = 0; i < G::kACopies; ++i) {
    const int m = m0 + tid / (KS / 4) + i * G::kARows;
    if (m < tile_m) {
      a_ih0[i] = (p0 + m / a.q) * a.stride - a.pad;
      a_iw0[i] = (m % a.q) * a.stride - a.pad;
    } else {  // past the tile: every copy of it is zero-filled
      a_ih0[i] = INT_MIN / 2;
      a_iw0[i] = INT_MIN / 2;
    }
  }
  const float* x_img = a.x + static_cast<int64_t>(nn) * a.h * a.wd * a.c;
  const int b_col = (tid % (BN / 4)) * 4;
  const bool b_ok = b_col < k_lim;

  auto load = [&](int buf, const Stage& t) {
    float* as = smem + buf * G::kStageFloats;
    float* bs = as + BM * G::kAS;
    const int cl = t.c0 + a_cg * 4;  // channel within the c-block
#pragma unroll
    for (int i = 0; i < G::kACopies; ++i) {
      const int row = tid / (KS / 4) + i * G::kARows;
      if (BM % G::kARows && row >= BM) break;
      const int ih = a_ih0[i] + t.rr;
      const int iw = a_iw0[i] + t.ss;
      const bool ok = cl < a.c_blk && static_cast<unsigned>(ih) < static_cast<unsigned>(a.h) &&
                      static_cast<unsigned>(iw) < static_cast<unsigned>(a.wd);
      cp_async16(as + row * G::kAS + a_cg * 4,
                 ok ? x_img + (static_cast<int64_t>(ih) * a.wd + iw) * a.c + t.cbase + cl : a.x,
                 ok ? 16 : 0);
    }
#pragma unroll
    for (int j = 0; j < G::kBCopies; ++j) {
      const int row = tid / (BN / 4) + j * G::kBRows;
      if (KS % G::kBRows && row >= KS) break;
      const bool ok = b_ok && t.c0 + row < a.c_blk;
      cp_async16(bs + row * G::kBS + b_col,
                 ok ? a.w +
                          (static_cast<int64_t>(t.rr * a.s + t.ss) * a.c + t.cbase + t.c0 + row) *
                              a.k +
                          k_base + b_col
                    : a.w,
                 ok ? 16 : 0);
    }
  };

  // The next stage of the run: KS channels on, then s, then r, then the
  // next step of the streams.  False after the last stage of the run's
  // FLAG_EPILOGUE step (or of the schedule's last step).
  auto advance = [&](Stage& t) -> bool {
    t.first = false;
    t.c0 += KS;
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

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  const Stage start{first, a.flags[first], a.cb_ids[first] * a.c_blk, 0, 0, 0, true};
  Stage ld = start;  // the next stage to load, while `more`
  bool more = true;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (more) {
      load(st, ld);
      more = advance(ld);
    }
    cp_async_commit();
  }
  Stage cur = start;
  for (int t = 0;; ++t) {
    cp_async_wait<STAGES - 2>();  // stage t has landed
    __syncthreads();              // and every warp is done with stage t - 1
    if (more) {
      load((t + STAGES - 1) % STAGES, ld);
      more = advance(ld);
    }
    cp_async_commit();
    if (cur.first && (cur.f & kFlagInit)) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
    }
    const float* as = smem + (t % STAGES) * G::kStageFloats;
    const float* arow[MT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) arow[i][h] = as + (wm0 + i * 16 + g + 8 * h) * G::kAS;
    stage_products<MT, NT, KS>(acc, arow, as + BM * G::kAS + wn0 + g, G::kBS);
    Stage nxt = cur;
    if (!advance(nxt)) break;
    cur = nxt;
  }
  cp_async_wait<0>();

  // `cur` is the run's last step: the epilogue fires only on its flag; each
  // (pixel, k..k+1) pair is one aligned float2 (K, k_blk % 4 == 0).
  if (!(cur.f & kFlagEpilogue)) return;
  const bool relu = (cur.f & kFlagRelu) != 0;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = wn0 + j * 8 + 2 * tig;
    if (col >= k_lim) continue;
    const float b0 = a.bias ? a.bias[k_base + col] : 0.f;
    const float b1 = a.bias ? a.bias[k_base + col + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm0 + i * 16 + g + 8 * h;
        if (m >= tile_m) continue;
        const int64_t row = (static_cast<int64_t>(nn) * a.p + p0 + m / a.q) * a.q + m % a.q;
        float y0 = __fadd_rn(acc[i][j][2 * h], b0);
        float y1 = __fadd_rn(acc[i][j][2 * h + 1], b1);
        if (relu) {
          y0 = fmaxf(y0, 0.f);
          y1 = fmaxf(y1, 0.f);
        }
        *reinterpret_cast<float2*>(a.out + row * a.k + k_base + col) = make_float2(y0, y1);
      }
  }
}

template <int BM, int BN, int WM, int WN, int KS, int STAGES, int MINB>
int launch(StreamArgs a, int runs, cudaStream_t stream) {
  using G = Cfg<BM, BN, WM, WN, KS, STAGES, MINB>;
  auto kernel = conv2d_streams_kernel_mma<BM, BN, WM, WN, KS, STAGES, MINB>;
  // per call: the attribute belongs to the current device
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  a.m_sub = (a.rb_p * a.q + BM - 1) / BM;
  a.k_sub = (a.k_blk + BN - 1) / BN;
  const int64_t blocks = static_cast<int64_t>(runs) * a.m_sub * a.k_sub;
  if (blocks <= 0 || blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned>(blocks), G::kThreads, G::kSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int KS>
int launch_tile(const StreamArgs& a, int runs, int tile, cudaStream_t stream) {
  switch (tile) {
    case 0: return launch<128, 128, 4, 2, KS, 4, 1>(a, runs, stream);
    case 1: return launch<128, 64, 4, 2, KS, 3, 2>(a, runs, stream);
    case 2: return launch<64, 128, 2, 4, KS, 3, 2>(a, runs, stream);
    case 3: return launch<64, 64, 2, 2, KS, 3, 3>(a, runs, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tc

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

// The mma route (3xTF32 on the tensor cores), with the arguments of
// repro_conv2d_streams_f32 but `tile`: 0 = 128x128, 1 = 128x64, 2 = 64x128,
// 3 = 64x64 pixels x output channels (kernels/conv2d_streams.MMA_TILES,
// chosen by mma_tile_config), and `stage_c`, the input channels of a stage:
// 32, 16 or 8 (kernels/conv2d_streams.mma_stage_c).  C, K, c_blk and k_blk
// must be multiples of 4 and x, w and out 16-byte aligned
// (kernels/conv2d_streams.route).  Returns cudaErrorInvalidValue for
// arguments off that rule, else cudaGetLastError().
extern "C" int repro_conv2d_streams_mma(const float* x, const float* w, const float* bias,
                                        const int* streams, int steps, const int* run_start,
                                        int runs, float* out, int n, int h, int wd, int c, int k,
                                        int r, int s, int stride, int pad, int rb_p, int k_blk,
                                        int c_blk, int tile, int stage_c, void* stream) {
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
  a.vec4 = 1;
  if (steps <= 0 || runs <= 0 || a.p <= 0 || a.q <= 0 || rb_p <= 0 || k_blk <= 0 ||
      c_blk <= 0 || c % 4 || k % 4 || c_blk % 4 || k_blk % 4 || !aligned16(x) || !aligned16(w) ||
      !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (stage_c) {
    case 32: return tc::launch_tile<32>(a, runs, tile, st);
    case 16: return tc::launch_tile<16>(a, runs, tile, st);
    case 8: return tc::launch_tile<8>(a, runs, tile, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
