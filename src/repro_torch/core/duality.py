"""Backward-by-duality (paper §II-I), the port's counterpart of
``repro/core/duality.py``: the data-gradient convolution rewritten as a
*forward* convolution over a transformed weight tensor, so the forward
kernel K1 serves both passes.

Scenario "stride1" (stride == 1):  W'[r',s',k,c] = W[R-1-r', S-1-s', c, k]
                                   dI = conv(dO, W', pad = R-1-pad)
Scenario "1x1"   (R == S == 1):    dI[:, ::stride, ::stride] = conv(dO, W^T)
Generic (stride > 1 and R,S > 1), two interchangeable plans:

  "phase"  (default)  stride² phase sub-convolutions over the undilated dO:
           input row y belongs to phase (y+pad) mod stride, and only the
           filter taps r ≡ (y+pad) (mod stride) touch it, so each of dI's
           stride×stride subgrids is a stride-1 forward conv of dO with a
           flipped, KC-transposed sub-filter (2x2, 2x1, 1x2 or 1x1 for a
           3x3 stride-2 conv), padding 0.
  "dilate" (A/B baseline, ``REPRO_BWD_DUALITY=dilate``): dilate dO by
           stride, then scenario "stride1" over a plane that is ~stride²
           zeros.

Plain torch on NHWC tensors.  The phase plan is a pure function of the conv
geometry (``phase_plan``), so ``dual_conv_signatures`` enumerates the
forward-conv shapes the backward pass launches.
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.nn.functional as F

VALID_MODES = ("phase", "dilate")


def resolve_mode(mode: str | None) -> str:
    """Generic-scenario plan: an explicit ``mode`` wins, else the
    ``REPRO_BWD_DUALITY`` environment variable, else "phase"."""
    if mode is None:
        mode = os.environ.get("REPRO_BWD_DUALITY", "phase")
    if mode not in VALID_MODES:
        raise ValueError(f"backward-data plan {mode!r}; valid: "
                         f"{', '.join(VALID_MODES)}")
    return mode


def transform_weights(w):
    """W (R,S,C,K) -> W' (R,S,K,C): KC-transpose + RS-flip, contiguous (the
    kernels take contiguous operands only)."""
    return torch.flip(w, dims=(0, 1)).permute(0, 1, 3, 2).contiguous()


def dilate(x, stride: int):
    """Insert stride-1 zeros between the spatial elements of x (N,P,Q,K)."""
    if stride == 1:
        return x
    n, p, q, k = x.shape
    out = x.new_zeros((n, (p - 1) * stride + 1, (q - 1) * stride + 1, k))
    out[:, ::stride, ::stride, :] = x
    return out


def _pad_hw(x, top, bottom, left, right):
    """Zero-pad the H and W axes of an NHWC tensor (``F.pad`` takes its
    pads last dimension first)."""
    return F.pad(x, (0, 0, left, right, top, bottom))


# -- the phase decomposition --------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PhaseAxis:
    """One spatial axis of one phase sub-convolution.

    ``res`` is the dI residue class this phase fills (y ≡ res mod stride);
    ``phi = (res + pad) mod stride`` selects the filter taps (r ≡ phi);
    ``taps`` how many such taps exist (0: this phase carries zero
    gradient); ``lo``/``hi`` the explicit dO padding of the stride-1 dual
    conv; ``off`` the first dual-output row of the phase; ``count`` how many
    dI rows the phase owns.
    """
    res: int
    phi: int
    taps: int
    lo: int
    hi: int
    off: int
    count: int


def _phase_axis(res: int, *, f: int, stride: int, padding: int, in_dim: int,
                out_dim: int) -> PhaseAxis:
    phi = (res + padding) % stride
    taps = len(range(phi, f, stride))
    count = max(-(-(in_dim - res) // stride), 0)
    off = (res + padding - phi) // stride
    lo = taps - 1
    hi = max(off + count - out_dim, 0)
    return PhaseAxis(res=res, phi=phi, taps=taps, lo=lo, hi=hi, off=off,
                     count=count)


def phase_plan(*, r: int, s: int, stride: int, padding: int,
               input_hw: tuple[int, int],
               out_hw: tuple[int, int]) -> list[tuple[PhaseAxis, PhaseAxis]]:
    """The stride² phase sub-convolutions of the generic backward-data plan,
    as (row-axis, col-axis) pairs, one per dI subgrid in row-major residue
    order.  Phases with zero filter taps (possible when stride > R) are
    included with ``taps == 0``."""
    h, w = input_hw
    p, q = out_hw
    plans = []
    for ry in range(stride):
        ax_y = _phase_axis(ry, f=r, stride=stride, padding=padding,
                           in_dim=h, out_dim=p)
        for rx in range(stride):
            ax_x = _phase_axis(rx, f=s, stride=stride, padding=padding,
                               in_dim=w, out_dim=q)
            plans.append((ax_y, ax_x))
    return plans


def phase_bwd_data(do, w, *, stride: int, padding: int,
                   input_hw: tuple[int, int], conv_fn):
    """dI via the stride² phase sub-convolutions (no dilated dO anywhere).

    ``conv_fn(x, w, stride, padding)`` runs a forward conv: the caller
    injects ``core.conv.conv2d_fwd``, so every sub-conv goes through K1."""
    r, s, c, k = w.shape
    n, p, q, _ = do.shape
    h, wdt = input_hw
    st = stride
    ph, pw = -(-h // st), -(-wdt // st)        # interleave grid (ceil-div)
    rows = []
    for ax_y, ax_x in phase_plan(r=r, s=s, stride=st, padding=padding,
                                 input_hw=(h, wdt), out_hw=(p, q)):
        if ax_y.taps == 0 or ax_x.taps == 0:
            yp = do.new_zeros((n, ph, pw, c))
        else:
            sub = transform_weights(w[ax_y.phi::st, ax_x.phi::st])
            dop = _pad_hw(do, ax_y.lo, ax_y.hi, ax_x.lo, ax_x.hi)
            y = conv_fn(dop, sub, 1, 0)
            yp = y[:, ax_y.off:ax_y.off + ax_y.count,
                   ax_x.off:ax_x.off + ax_x.count, :]
            yp = _pad_hw(yp, 0, ph - ax_y.count, 0, pw - ax_x.count)
        rows.append(yp)
    # interleave the stride×stride subgrids back into the (h, w) plane
    a = torch.stack(rows).reshape(st, st, n, ph, pw, c)
    a = a.permute(2, 3, 0, 4, 1, 5)            # (n, ph, st_y, pw, st_x, c)
    return a.reshape(n, ph * st, pw * st, c)[:, :h, :wdt, :]


def dual_conv_signatures(*, r: int, s: int, c: int, k: int, stride: int,
                         padding: int, input_hw: tuple[int, int],
                         mode: str | None = None,
                         unique: bool = True) -> list[dict]:
    """The forward-conv signatures the backward-data pass launches for this
    layer: h/w are the (pre-padded) dO plane each sub-conv sees, C/K are
    swapped by the duality transform.  ``unique=False`` keeps duplicate
    phase signatures: phases with identical geometry are still separate
    launches."""
    h, wdt = input_hw
    p = (h + 2 * padding - r) // stride + 1
    q = (wdt + 2 * padding - s) // stride + 1
    if stride == 1:
        return [dict(h=p, w=q, c=k, k=c, r=r, s=s, stride=1,
                     padding=r - 1 - padding)]
    if r == 1 and s == 1:
        return [dict(h=p, w=q, c=k, k=c, r=1, s=1, stride=1, padding=0)]
    if resolve_mode(mode) == "dilate":
        pd = (p - 1) * stride + 1
        qd = (q - 1) * stride + 1
        top = r - 1 - padding
        left = s - 1 - padding
        bottom = max(h + padding - (p - 1) * stride - 1, 0)
        right = max(wdt + padding - (q - 1) * stride - 1, 0)
        return [dict(h=pd + top + bottom, w=qd + left + right, c=k, k=c,
                     r=r, s=s, stride=1, padding=0)]
    sigs, seen = [], set()
    for ax_y, ax_x in phase_plan(r=r, s=s, stride=stride, padding=padding,
                                 input_hw=(h, wdt), out_hw=(p, q)):
        if ax_y.taps == 0 or ax_x.taps == 0:
            continue
        sig = dict(h=p + ax_y.lo + ax_y.hi, w=q + ax_x.lo + ax_x.hi,
                   c=k, k=c, r=ax_y.taps, s=ax_x.taps, stride=1, padding=0)
        key = tuple(sorted(sig.items()))
        if not unique or key not in seen:
            seen.add(key)
            sigs.append(sig)
    return sigs


# -- plan selection -----------------------------------------------------------

def bwd_data_plan(*, r: int, s: int, stride: int, padding: int,
                  input_hw: tuple[int, int], mode: str | None = None):
    """(scenario, forward-conv parameters) implementing dI = dual forward.
    scenario ∈ {"stride1", "1x1", "phase", "dilate"}; the generic case
    picks "phase" or "dilate" per ``mode`` / ``REPRO_BWD_DUALITY``."""
    if stride == 1:
        return ("stride1", dict(stride=1, padding=r - 1 - padding))
    if r == 1 and s == 1:
        return ("1x1", dict(stride=1, padding=0))
    if resolve_mode(mode) == "dilate":
        return ("dilate", dict(stride=1, padding=0))
    return ("phase", dict(stride=1, padding=0, n_phases=stride * stride))


def prepare_bwd_data(do, w, *, stride: int, padding: int,
                     input_hw: tuple[int, int], mode: str | None = None):
    """Transform (dO, W) so a *single* plain forward conv yields dI.

    Returns (do', w', fwd_kwargs, post) where post(y) -> dI.  Only the
    single-conv scenarios land here; the multi-conv "phase" plan runs in
    ``phase_bwd_data``."""
    r, s, c, k = w.shape
    h, wdt = input_hw
    scenario, kw = bwd_data_plan(r=r, s=s, stride=stride, padding=padding,
                                 input_hw=input_hw, mode=mode)
    if scenario == "phase":
        raise ValueError("the phase plan is multi-conv: use phase_bwd_data")
    wt = transform_weights(w)

    def fit(y):
        """Zero-pad or crop y to the exact (h, wdt) input plane: rows beyond
        the receptive field carry zero gradient."""
        y = _pad_hw(y, 0, max(h - y.shape[1], 0), 0, max(wdt - y.shape[2], 0))
        return y[:, :h, :wdt, :]

    if scenario == "stride1":
        return do, wt, kw, fit
    if scenario == "1x1":
        p, q = do.shape[1], do.shape[2]

        def post(y):
            out = y.new_zeros((y.shape[0], h, wdt, c))
            out[:, :(p - 1) * stride + 1:stride,
                :(q - 1) * stride + 1:stride, :] = y
            return out
        return do, wt, kw, post
    # Dilate (A/B baseline): dilate dO, then it is the stride-1 dual.  When
    # the forward conv floored ((h + 2p - r) % stride != 0) the dual needs
    # asymmetric padding: pre-pad explicitly and run the conv pad-free.
    p, q = do.shape[1], do.shape[2]
    top = r - 1 - padding
    left = s - 1 - padding
    if top < 0 or left < 0:
        raise ValueError(f"padding {padding} > filter - 1 is not supported")
    bottom = max(h + padding - (p - 1) * stride - 1, 0)
    right = max(wdt + padding - (q - 1) * stride - 1, 0)
    dod = _pad_hw(dilate(do, stride), top, bottom, left, right)
    return dod, wt, dict(stride=1, padding=0), fit
