"""K9: grouped matmul for MoE expert dispatch, kernel streams (paper
§II-H) applied to the experts.

Replaces ``repro/kernels/moe_gmm.py:moe_gmm`` (the Pallas ``_kernel``,
``pallas_call`` at :61), with the same contract (:37-66): tokens (T, D)
grouped by expert into groups whose starts are aligned to tiles of ``bm``
rows, weights (E, D, F) stacked per expert, and a stream ``tile_eid``
(⌈T/bm⌉,) int32 naming the expert of each M-tile, which picks the weight
block that tile multiplies (w_off = f(expert) of the paper's Fig. 1).  The
output (T, F) has the tokens' dtype; the sums are f32.

Two extensions that the reference never feeds:

* ``tile_eid[i] < 0`` marks an empty tile: its rows come out zero and the
  kernel reads no weight for it.  A caller can size the grid by an upper
  bound known on the host and mark the unused tail, so no device value is
  read on the host.
* T, D and F need not be multiples of the blocks: the kernel masks its
  tails (the reference asserts divisibility only because a Pallas block
  must divide its array).  A last tile may be ragged.

Three functions live here besides the wrapper:

* ``route_dryrun``: the reference's routing dryrun (:69-94), bit for bit.
* ``moe_gmm_plain``: the kernel's function in plain PyTorch, one f32
  ``@`` per run of equal ids, cast at the end.  The CPU tests and the CPU
  path run it; ``chip_smoke.py`` holds the kernel against it.
* ``pick_bm``: the tile height for a row count known on the host.

``moe_gmm`` takes the plain version for a CPU tensor and launches a CUDA
C++ kernel of ``csrc/moe_gmm.cu`` (sm_90a) for a CUDA tensor, one per route
(``route``, by dtype, tile height, shape and alignment): ``"wgmma"``, the
prefill route, for bf16 with bm a multiple of 64, D and F multiples of 8
and tokens and weights 16-byte aligned, a Hopper kernel on the bf16 tensor
cores (TMA loads into a shared-memory ring, the weights read through a 3-D
tensor map with the tile's expert as its third coordinate, ``wgmma`` on two
consumer warpgroups); ``"stream"``, the decode route, for bf16 with bm a
multiple of 16 below 64 (decode's 16) under the same shape and alignment
rule, a weight stream: a persistent block per SM walks a work list of
(used tile, column box, D chunk) built on the card from ``tile_eid``
(``stream_work`` is its plan in Python), one producer thread keeps a ring
of TMA loads of 512-byte weight rows in flight, and a second pass sums the
D chunks in a fixed order; ``"mma"`` for the rest: f32 and ragged or
unaligned bf16.  There is no fallback between the CPU and the card, nor
between the routes: a launch that fails raises.  ``launches`` counts the
launches of every route, ``launches_wgmma`` and ``launches_stream`` those
of their routes.

What bounds it on an H100: in decode a tile holds a few rows, so the
weights of the experts that have rows, read once, bound it (bytes); in
prefill each expert has hundreds of rows and the bf16 products bound it
(tensor cores).  The "stream" and "mma" kernels' bf16 products run
``mma.sync`` m16n8k16 on the tensor cores; the "mma" kernel's f32 instance
runs true f32 products on the SIMT cores, with no TF32.

Its gradient, K9'.  The reference's Pallas kernel has no ``custom_vjp``:
its training step differentiates the einsum dispatch (``ref.moe_gmm``)
with XLA's autodiff.  On the CPU autograd differentiates the plain version.
On the card, where tokens or weights require grad under grad mode,
``moe_gmm`` runs the forward kernel inside ``_MoeGmm``, a
``torch.autograd.Function`` that saves tokens, weights and tile_eid and
whose backward is ``moe_gmm_bwd`` (``csrc/moe_gmm_bwd.cu``): dtokens[r] =
dout[r] @ W[e(r)]ᵀ (zero on tiles outside [0, E)) and dweights[e] = the
sum over e's tiles of tokensᵀ @ dout (zero for an expert with no tile),
f32 sums, no atomics, the same bits on every call; the weights are read as
they lie (no transposed copy) and ``tile_eid`` is read on the card.
``route_bwd`` picks one of three routes by dtype, tile height, shape and
alignment: ``"wgmma"`` for bf16 under the forward's prefill rule (bm a
multiple of 64, D and F multiples of 8, every operand 16-byte aligned, at
most ``BWD_MAX_TILES`` tiles and ``BWD_MAX_EXPERTS`` experts), a TMA +
``wgmma`` dtokens kernel on the forward's skeleton (the weights read
K-major through a 3-D tensor map) and a persistent dweights kernel whose
blocks walk a work list of (expert, D box, F box) items built on the card
(``bwd_work`` is its plan in Python) and store each item by TMA while the
next one's products run; ``"mma"`` for the other bf16 calls, two tiled
kernels on the "mma" skeleton (``mma.sync`` m16n8k16); ``"simt"`` for f32.
``moe_gmm_bwd_plain`` is the same backward in plain f32 PyTorch; the tests
and ``chip_smoke.py`` hold the kernels against it.  ``launches_bwd``
counts the backward's calls, ``launches_bwd_mma`` and
``launches_bwd_wgmma`` those on their routes.  Bound: the larger of 4 *
rows * D * F operations on the tensor cores (rows: those of tiles in [0,
E)) and the bytes (the used experts' weights read, every expert's
dweights written): bytes at the MoE layers' widths.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# Launches of the CUDA kernels since the last reset (set it to 0 to reset):
# every route, and the wgmma and stream routes' alone.
launches = 0
launches_wgmma = 0
launches_stream = 0
# the backward's calls, and those on its mma and wgmma routes
launches_bwd = 0
launches_bwd_mma = 0
launches_bwd_wgmma = 0
_fn = None
_fn_wgmma = None
_fn_stream = None
_fn_bwd = None
_fn_bwd_wgmma = None

BLOCK_ROWS = (128, 64, 16)   # the kernel's block heights; bm is a multiple
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The stream route (csrc/moe_gmm.cu, namespace st): an item is STREAM_BN
# columns of one used tile over a chunk of D, read in stages of STREAM_BK
# rows; a block lists at most STREAM_MAX_TILES tiles of the id stream; D is
# cut into at most STREAM_MAX_SPLITS chunks, fewer where their f32 partials
# (splits, T, F) would pass STREAM_PART_BYTES.
STREAM_BN = 256
STREAM_BK = 64
STREAM_MAX_TILES = 2048
STREAM_MAX_SPLITS = 8
STREAM_PART_BYTES = 64 << 20
# The backward's wgmma route (csrc/moe_gmm_bwd.cu, namespace wg): a
# dweights item is BWD_BM rows of D by BWD_BN columns of F of one expert;
# a block lists at most BWD_MAX_TILES tiles and BWD_MAX_EXPERTS experts.
BWD_BM = 128
BWD_BN = 256
BWD_MAX_TILES = 1024
BWD_MAX_EXPERTS = 64


def route_dryrun(expert_of_token, num_experts: int, capacity: int, bm: int):
    """The routing dryrun: gather indices and the ``tile_eid`` stream.

    expert_of_token: (T,) integer ids in [0, E).  Returns (gather_idx
    (E*cap,) int32, tile_eid (E*cap//bm,) int32, keep (E*cap,) bool), with
    gather_idx[i] the source token of grouped row i (group g holds rows
    [g*cap, (g+1)*cap), in token order) and keep false on the rows no token
    filled; tokens past an expert's capacity are dropped.  Equal to the
    reference's bit for bit: the only duplicate writes go to the sentinel
    row E*cap, which is cut off."""
    if capacity % bm:
        raise ValueError(f"capacity {capacity} is not a multiple of bm {bm}")
    eid = expert_of_token.long()
    t = eid.shape[0]
    experts = torch.arange(num_experts, device=eid.device)
    onehot = (eid[:, None] == experts[None, :]).int()              # (T, E)
    pos = ((onehot.cumsum(dim=0) - 1) * onehot).sum(dim=1)
    dest = torch.where(pos < capacity, eid * capacity + pos,
                       num_experts * capacity)
    gather_idx = torch.zeros((num_experts * capacity + 1,), dtype=torch.int32,
                             device=eid.device)
    gather_idx.index_put_((dest,), torch.arange(
        1, t + 1, dtype=torch.int32, device=eid.device))
    gather_idx = gather_idx[:-1]
    keep = gather_idx > 0
    gather_idx = (gather_idx - 1).clamp_min(0)
    tile_eid = experts.to(torch.int32).repeat_interleave(capacity // bm)
    return gather_idx, tile_eid, keep


def pick_bm(rows: int, experts: int) -> int:
    """Rows per tile for about ``rows`` rows over ``experts`` experts: 16
    when each expert has a few (decode: the kernel then streams each
    touched expert's weights once), else 64 or 128 (prefill)."""
    per = -(-rows // max(experts, 1))
    return 16 if per <= 16 else 64 if per <= 64 else 128


def _check(tokens, weights, tile_eid, bm: int):
    if tokens.dim() != 2 or weights.dim() != 3 \
            or weights.shape[1] != tokens.shape[1]:
        raise ValueError(f"tokens must be (T, D) and weights (E, D, F); got "
                         f"{tuple(tokens.shape)} and {tuple(weights.shape)}")
    if bm < 1:
        raise ValueError(f"bm must be positive, got {bm}")
    tiles = -(-tokens.shape[0] // bm)
    if tuple(tile_eid.shape) != (tiles,):
        raise ValueError(f"tile_eid must be ({tiles},) for {tokens.shape[0]} "
                         f"rows in tiles of {bm}, got {tuple(tile_eid.shape)}")
    if tile_eid.dtype != torch.int32:
        raise ValueError(f"tile_eid must be int32, got {tile_eid.dtype}")


def moe_gmm_plain(tokens, weights, tile_eid, *, bm: int):
    """The kernel's function in plain PyTorch: for each run of tiles with
    one id, the run's rows @ that expert's (D, F) weight in f32, cast to
    the tokens' dtype; rows of a negative id are zero.  Reads ``tile_eid``
    on the host."""
    _check(tokens, weights, tile_eid, bm)
    t = tokens.shape[0]
    e, _, f = weights.shape
    ids = tile_eid.tolist()
    if any(i >= e for i in ids):
        raise ValueError(f"tile_eid holds an id >= E = {e}: {ids}")
    out = torch.zeros((t, f), dtype=tokens.dtype, device=tokens.device)
    i0 = 0
    while i0 < len(ids):
        i1 = i0 + 1
        while i1 < len(ids) and ids[i1] == ids[i0]:
            i1 += 1
        if ids[i0] >= 0:
            r0, r1 = i0 * bm, min(i1 * bm, t)
            out[r0:r1] = (tokens[r0:r1].float()
                          @ weights[ids[i0]].float()).to(tokens.dtype)
        i0 = i1
    return out


def route(tokens, weights, bm: int) -> str:
    """Which kernel a CUDA call of ``moe_gmm(tokens, weights, tile_eid,
    bm=bm)`` launches, by dtype, tile height, shape and alignment alone:
    "wgmma" for bf16 tokens and weights with bm a multiple of 64, D and F
    positive multiples of 8 and both 16-byte aligned (TMA's row strides and
    bases); "stream" under the same rule for bm 16, 32 or 48 (decode's 16)
    with at most ``STREAM_MAX_TILES`` tiles; else "mma" (f32, ragged D or
    F, unaligned operands).  A dispatch by shape, not a fallback: each
    route raises on failure."""
    d, f = weights.shape[1], weights.shape[2]
    if (tokens.dtype == weights.dtype == torch.bfloat16 and bm % 64 == 0
            and d > 0 and d % 8 == 0 and f % 8 == 0
            and tokens.data_ptr() % 16 == 0
            and weights.data_ptr() % 16 == 0):
        return "wgmma"
    if (tokens.dtype == weights.dtype == torch.bfloat16
            and bm in (16, 32, 48) and d > 0 and d % 8 == 0 and f % 8 == 0
            and -(-tokens.shape[0] // bm) <= STREAM_MAX_TILES
            and tokens.data_ptr() % 16 == 0
            and weights.data_ptr() % 16 == 0):
        return "stream"
    return "mma"


def stream_max_splits(t: int, f: int) -> int:
    """The most D chunks the stream route may cut (T, F) into: its f32
    partials (splits, T, F) stay within ``STREAM_PART_BYTES``."""
    return max(1, min(STREAM_MAX_SPLITS, STREAM_PART_BYTES // (t * f * 4)))


def stream_splits(n_used: int, n_col: int, k_steps: int, grid: int,
                  s_max: int, bm: int) -> tuple[int, int]:
    """(splits, chunk): how the stream route cuts D, which its kernel
    derives on the card from the used tiles' count (``plan`` in
    ``csrc/moe_gmm.cu``, namespace st).  Each of the n_used x n_col (used
    tile, column box) pairs takes ``splits`` chunks of ``chunk`` stages of
    ``STREAM_BK`` rows (the last may hold fewer); the items go round
    ``grid`` blocks.  The split is the one whose rounds move the fewest
    bytes: each round the largest item's weights, plus, when D is split,
    an item's f32 partial written and read back; the fewest splits on a
    tie, and never two splits with the same chunk."""
    best, best_cost = (1, k_steps), None
    for s in range(1, min(s_max, k_steps) + 1):
        chunk = -(-k_steps // s)
        if -(-k_steps // chunk) != s:
            continue
        rounds = -(-(n_used * n_col * s) // grid)
        cost = rounds * (chunk * STREAM_BK * STREAM_BN * 2
                         + (bm * STREAM_BN * 8 if s > 1 else 0))
        if best_cost is None or cost < best_cost:
            best, best_cost = (s, chunk), cost
    return best


def stream_work(tile_eid, *, e: int, d: int, f: int, bm: int, grid: int,
                s_max: int) -> list[list[tuple]]:
    """The stream route's work list as each of ``grid`` blocks walks it:
    item w = block + i * grid of the (used tile, column box, D chunk)
    triples, the used tile outermost, each as (tile, first column, last
    column + 1, D chunk, first row of D, last row + 1).  A tile whose id
    lies outside [0, E) has no item.  ``tile_eid`` is a list of ints."""
    used = [i for i, eid in enumerate(tile_eid) if 0 <= eid < e]
    n_col = -(-f // STREAM_BN)
    k_steps = -(-d // STREAM_BK)
    splits, chunk = stream_splits(len(used), n_col, k_steps, grid, s_max, bm)
    items = len(used) * n_col * splits
    work = []
    for block in range(grid):
        mine = []
        for w in range(block, items, grid):
            j = w % splits
            col = w // splits % n_col
            u = w // splits // n_col
            mine.append((used[u], col * STREAM_BN,
                         min((col + 1) * STREAM_BN, f), j,
                         j * chunk * STREAM_BK,
                         min((j + 1) * chunk, k_steps) * STREAM_BK))
        work.append(mine)
    return work


def _kernel_fn_wgmma():
    global _fn_wgmma
    if _fn_wgmma is None:
        fn = _build.load("moe_gmm").repro_moe_gmm_wgmma
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn_wgmma = fn
    return _fn_wgmma


def _kernel_fn_stream():
    global _fn_stream
    if _fn_stream is None:
        fn = _build.load("moe_gmm").repro_moe_gmm_stream
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn_stream = fn
    return _fn_stream


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _build.load("moe_gmm").repro_moe_gmm
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check_cuda(tokens, weights, tile_eid, bm: int):
    """What the CUDA kernels of both directions take: tokens on a CUDA
    device, f32 or bf16, weights of their dtype, every operand on that
    device and contiguous, bm a multiple of 16."""
    if tokens.device.type != "cuda":
        raise ValueError(f"moe_gmm runs on cpu or cuda, not {tokens.device}")
    if tokens.dtype not in _DTYPES:
        raise ValueError(f"tokens must be float32 or bfloat16, got "
                         f"{tokens.dtype}")
    if bm % BLOCK_ROWS[-1]:
        raise ValueError(f"the kernel takes bm a multiple of "
                         f"{BLOCK_ROWS[-1]}, got {bm}")
    for name, t in (("weights", weights), ("tile_eid", tile_eid)):
        if t.device != tokens.device:
            raise ValueError(f"{name} on {t.device}, tokens on "
                             f"{tokens.device}")
    if weights.dtype != tokens.dtype:
        raise ValueError(f"weights are {weights.dtype}, tokens "
                         f"{tokens.dtype}")
    for name, t in (("tokens", tokens), ("weights", weights),
                    ("tile_eid", tile_eid)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


class _MoeGmm(torch.autograd.Function):
    """K9 forward with K9' as its gradient: the forward saves tokens,
    weights and tile_eid (the weights are the param itself, no copy), and
    the backward launches ``moe_gmm_bwd``.  Under ``cfg.remat`` the forward
    that ``torch.utils.checkpoint`` runs again saves them again."""

    @staticmethod
    def forward(ctx, tokens, weights, tile_eid, bm):
        ctx.save_for_backward(tokens, weights, tile_eid)
        ctx.bm = bm
        return _launch_forward(tokens, weights, tile_eid, bm)

    @staticmethod
    def backward(ctx, dout):
        tokens, weights, tile_eid = ctx.saved_tensors
        dtok, dw = moe_gmm_bwd(tokens, weights, tile_eid, dout.contiguous(),
                               bm=ctx.bm)
        return dtok, dw, None, None


def moe_gmm(tokens, weights, tile_eid, *, bm: int = 128):
    """tokens (T, D), weights (E, D, F), tile_eid (⌈T/bm⌉,) int32 -> (T, F)
    in the tokens' dtype.  A CPU tensor takes ``moe_gmm_plain`` (autograd
    differentiates it); a CUDA tensor launches the sm_90a kernel of its
    ``route`` on the current stream or raises.  On the card an id outside
    [0, E) gives zero rows (the kernel cannot raise), and bm must be a
    multiple of 16; with grad enabled and tokens or weights requiring grad,
    the output's gradient is K9' (``moe_gmm_bwd``)."""
    _check(tokens, weights, tile_eid, bm)
    if tokens.device.type == "cpu":
        return moe_gmm_plain(tokens, weights, tile_eid, bm=bm)
    _check_cuda(tokens, weights, tile_eid, bm)
    if torch.is_grad_enabled() and (tokens.requires_grad
                                    or weights.requires_grad):
        return _MoeGmm.apply(tokens, weights, tile_eid, bm)
    return _launch_forward(tokens, weights, tile_eid, bm)


def _launch_forward(tokens, weights, tile_eid, bm: int):
    """The forward kernel of ``route`` on the tokens' device and current
    stream; the checks are the caller's."""
    global launches, launches_wgmma, launches_stream
    t, d = tokens.shape
    e, _, f = weights.shape
    out = torch.empty((t, f), dtype=tokens.dtype, device=tokens.device)
    if out.numel() == 0:
        return out
    path = route(tokens, weights, bm)
    with torch.cuda.device(tokens.device):
        stream = torch.cuda.current_stream(tokens.device).cuda_stream
        args = (tokens.data_ptr(), weights.data_ptr(), tile_eid.data_ptr(),
                out.data_ptr(), t, d, f, e, bm)
        if path == "wgmma":
            fn = _kernel_fn_wgmma()
            launches += 1
            launches_wgmma += 1
            err = fn(*args, stream)
        elif path == "stream":
            s_max = stream_max_splits(t, f)
            part = torch.empty((s_max, t, f), dtype=torch.float32,
                               device=tokens.device) if s_max > 1 else None
            fn = _kernel_fn_stream()
            launches += 1
            launches_stream += 1
            err = fn(*args[:4], None if part is None else part.data_ptr(),
                     *args[4:], s_max, stream)
        else:
            fn = _kernel_fn()
            launches += 1
            err = fn(*args, _DTYPES[tokens.dtype], stream)
    if err != 0:
        raise RuntimeError(f"moe_gmm kernel launch failed ({path} route): "
                           f"CUDA error {err} "
                           f"(tokens {tuple(tokens.shape)}, weights "
                           f"{tuple(weights.shape)}, bm {bm}, "
                           f"{tokens.dtype})")
    return out


def moe_gmm_bwd_plain(tokens, weights, tile_eid, dout, *, bm: int):
    """K9' in plain PyTorch: (dtokens (T, D), dweights (E, D, F)) of
    ``moe_gmm`` given dout (T, F), in f32 and each rounded once to its
    operand's dtype.  For each run of tiles with one id in [0, E): its rows'
    dout @ that expert's weightᵀ, and the run's tokensᵀ @ dout added into
    the expert's dweights in run order; rows of a negative id get zero, an
    expert with no row a zero dweights.  Reads ``tile_eid`` on the host."""
    _check(tokens, weights, tile_eid, bm)
    t = tokens.shape[0]
    e, d, f = weights.shape
    if tuple(dout.shape) != (t, f):
        raise ValueError(f"dout must be ({t}, {f}), got {tuple(dout.shape)}")
    ids = tile_eid.tolist()
    if any(i >= e for i in ids):
        raise ValueError(f"tile_eid holds an id >= E = {e}: {ids}")
    dtok = torch.zeros((t, d), dtype=torch.float32, device=tokens.device)
    dw = torch.zeros((e, d, f), dtype=torch.float32, device=tokens.device)
    i0 = 0
    while i0 < len(ids):
        i1 = i0 + 1
        while i1 < len(ids) and ids[i1] == ids[i0]:
            i1 += 1
        if ids[i0] >= 0:
            r0, r1 = i0 * bm, min(i1 * bm, t)
            g = dout[r0:r1].float()
            dtok[r0:r1] = g @ weights[ids[i0]].float().T
            dw[ids[i0]] += tokens[r0:r1].float().T @ g
        i0 = i1
    return dtok.to(tokens.dtype), dw.to(weights.dtype)


def route_bwd(tokens, weights, bm: int, dout=None) -> str:
    """Which kernels a CUDA call of ``moe_gmm_bwd(tokens, weights,
    tile_eid, dout, bm=bm)`` launches, by dtype, tile height, shape and
    alignment alone: "wgmma" for bf16 tokens and weights with bm a positive
    multiple of 64, D and F positive multiples of 8, tokens, weights and
    (where given) dout 16-byte aligned, at most ``BWD_MAX_TILES`` tiles and
    ``BWD_MAX_EXPERTS`` experts (the forward's prefill rule, so every
    training call at the cut); "mma" for the other bf16 calls (bm 16,
    ragged D or F, unaligned views: ``mma.sync`` m16n8k16, per-element
    staging where cp.async cannot go); "simt" (true f32 products) for f32.
    A dispatch, not a fallback: each route raises on failure."""
    if tokens.dtype not in _DTYPES:
        raise ValueError(f"the backward takes float32 or bfloat16, got "
                         f"{tokens.dtype}")
    if tokens.dtype == torch.float32:
        return "simt"
    e, d, f = weights.shape
    if (weights.dtype == torch.bfloat16 and bm > 0 and bm % 64 == 0
            and d > 0 and d % 8 == 0 and f > 0 and f % 8 == 0
            and -(-tokens.shape[0] // bm) <= BWD_MAX_TILES
            and e <= BWD_MAX_EXPERTS
            and all(t.data_ptr() % 16 == 0 for t in (tokens, weights, dout)
                    if t is not None)):
        return "wgmma"
    return "mma"


def bwd_work(tile_eid, *, e: int, d: int, f: int,
             grid: int) -> list[list[tuple]]:
    """The wgmma route's dweights work list as each of ``grid`` persistent
    blocks walks it (``moe_gmm_bwd_dw_kernel_wgmma``): item w = block + i *
    grid of the E x ⌈D/BWD_BM⌉ x ⌈F/BWD_BN⌉ (expert, D box, F box) items,
    expert-major and F fastest, each as (expert, first row of D, last + 1,
    first column of F, last + 1, the expert's tiles in id-stream order).
    An expert with no tile keeps its items, with no tiles: they load
    nothing and store zeros.  A tile whose id lies outside [0, E) is in no
    item.  ``tile_eid`` is a list of ints."""
    tiles = [[i for i, eid in enumerate(tile_eid) if eid == x]
             for x in range(e)]
    n_d, n_f = -(-d // BWD_BM), -(-f // BWD_BN)
    items = e * n_d * n_f
    work = []
    for block in range(grid):
        mine = []
        for w in range(block, items, grid):
            x, rem = divmod(w, n_d * n_f)
            d0, f0 = rem // n_f * BWD_BM, rem % n_f * BWD_BN
            mine.append((x, d0, min(d0 + BWD_BM, d), f0,
                         min(f0 + BWD_BN, f), tuple(tiles[x])))
        work.append(mine)
    return work


def _kernel_fn_bwd():
    global _fn_bwd
    if _fn_bwd is None:
        fn = _build.load("moe_gmm_bwd").repro_moe_gmm_bwd
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn_bwd = fn
    return _fn_bwd


def _kernel_fn_bwd_wgmma():
    global _fn_bwd_wgmma
    if _fn_bwd_wgmma is None:
        fn = _build.load("moe_gmm_bwd").repro_moe_gmm_bwd_wgmma
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn_bwd_wgmma = fn
    return _fn_bwd_wgmma


def moe_gmm_bwd(tokens, weights, tile_eid, dout, *, bm: int = 128):
    """K9' on the card: tokens (T, D), weights (E, D, F), tile_eid
    (⌈T/bm⌉,) int32 and dout (T, F), contiguous -> (dtokens (T, D) in the
    tokens' dtype, dweights (E, D, F) in the weights'), launched on the
    current stream (the dtokens kernel, then the dweights kernel, of
    ``route_bwd``), or raises.  A CPU tensor takes ``moe_gmm_bwd_plain``."""
    global launches_bwd, launches_bwd_mma, launches_bwd_wgmma
    _check(tokens, weights, tile_eid, bm)
    if tokens.device.type == "cpu":
        return moe_gmm_bwd_plain(tokens, weights, tile_eid, dout, bm=bm)
    _check_cuda(tokens, weights, tile_eid, bm)
    t, d = tokens.shape
    e, _, f = weights.shape
    if tuple(dout.shape) != (t, f) or dout.dtype != tokens.dtype \
            or dout.device != tokens.device or not dout.is_contiguous():
        raise ValueError(f"dout must be a contiguous ({t}, {f}) "
                         f"{tokens.dtype} tensor on {tokens.device}, got "
                         f"{tuple(dout.shape)} {dout.dtype} on {dout.device}")
    dtok = torch.empty((t, d), dtype=tokens.dtype, device=tokens.device)
    dw = torch.empty_like(weights)
    if t == 0 or d == 0 or f == 0:
        return dtok.zero_(), dw.zero_()
    path = route_bwd(tokens, weights, bm, dout)
    args = (tokens.data_ptr(), weights.data_ptr(), tile_eid.data_ptr(),
            dout.data_ptr(), dtok.data_ptr(), dw.data_ptr(), t, d, f, e, bm)
    with torch.cuda.device(tokens.device):
        stream = torch.cuda.current_stream(tokens.device).cuda_stream
        if path == "wgmma":
            fn = _kernel_fn_bwd_wgmma()
            launches_bwd += 1
            launches_bwd_wgmma += 1
            err = fn(*args, stream)
        else:
            fn = _kernel_fn_bwd()
            launches_bwd += 1
            launches_bwd_mma += int(path == "mma")
            err = fn(*args, _DTYPES[tokens.dtype], stream)
    if err != 0:
        raise RuntimeError(f"moe_gmm_bwd kernel launch failed ({path} "
                           f"route): CUDA error {err} (tokens "
                           f"{tuple(tokens.shape)}, weights "
                           f"{tuple(weights.shape)}, bm {bm}, "
                           f"{tokens.dtype})")
    return dtok, dw
