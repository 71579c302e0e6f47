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
_fn = None
_fn_wgmma = None
_fn_stream = None

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


def moe_gmm(tokens, weights, tile_eid, *, bm: int = 128):
    """tokens (T, D), weights (E, D, F), tile_eid (⌈T/bm⌉,) int32 -> (T, F)
    in the tokens' dtype.  A CPU tensor takes ``moe_gmm_plain``; a CUDA
    tensor launches the sm_90a kernel of its ``route`` on the current
    stream or raises.  On the card an id outside [0, E) gives zero rows (the
    kernel cannot raise), and bm must be a multiple of 16."""
    global launches, launches_wgmma, launches_stream
    _check(tokens, weights, tile_eid, bm)
    if tokens.device.type == "cpu":
        return moe_gmm_plain(tokens, weights, tile_eid, bm=bm)
    if tokens.device.type != "cuda":
        raise ValueError(f"moe_gmm runs on cpu or cuda, not {tokens.device}")
    _build.no_grad_inputs("moe_gmm (K9)", tokens, weights)
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
