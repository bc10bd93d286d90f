"""Radix-select per-bar medians: the ``medians="select"`` engine.

Counterpart of ``finmlkit_tpu/ops/segment_select.py``. Each round finds the
next 8-bit digit of every bar's upper-middle value at once, on the
order-preserving bit patterns of the amounts:

1. broadcast every bar's prefix found so far to its trades with the
   segmented last-fill ``fill_last`` (kernel F in its zero-before mode; it
   replaces the TPU kernel ``_fill_last_planes``, L1);
2. a trade is active when its bits above the digit equal its bar's prefix;
3. per-(bar, digit) counts by one ``index_add_`` of the active mask (an
   inactive trade adds 0 to its own bin: no dump slots);
4. ``torch.cumsum`` over the 256 digits, exact in int32, picks the digit
   that holds the target rank.

After four rounds (8, 8, 8 and 7 bits of the 31) the prefix is the bit
pattern of the ``c // 2``-th smallest amount of the bar (numpy's upper
middle). The lower middle comes from one more fill: the count and the
largest of the values strictly below it decide, exactly under ties.

Precondition: the amounts are nonnegative. Nonnegative float32 values have
the sign bit clear, so their raw bits order as they do. The default sort
engine (``bar/fused.py``) has no such precondition. Empty bars get garbage
brackets; callers mask them on the trade count.

The TPU workarounds do not cross: its dump slots (inactive trades scattered
over 2^20 spread bins to dodge XLA's serial scatter), the triangular-matmul
cumsum and the padding to ``(rows, 128)`` planes.
"""
import torch

from .prefix_scan import fast_cumsum, fill_last
from .segment import bar_ids_from_close_indices

__all__ = ["segment_median_pair_select"]

_BITS = 8                      # digit width of a round
_NB = 1 << _BITS               # digits per round
SHIFTS = (23, 15, 7, 0)        # each round's low bit: 8, 8, 8 and 7 bits of 31


def segment_median_pair_select(amounts_f32: torch.Tensor, ci: torch.Tensor, *,
                               fill=fill_last, cumsum=fast_cumsum):
    """Per-bar ``np.median`` brackets ``(med_a, med_b)`` (float32) by radix
    selection; ``fill`` (kernel F by default) broadcasts per-bar values to
    the trades and ``cumsum`` (kernel S) gives the bar ids."""
    if amounts_f32.dtype != torch.float32 or amounts_f32.dim() != 1:
        raise TypeError("amounts_f32 must be a 1-D float32 tensor")
    dev = amounts_f32.device
    n, nb = amounts_f32.shape[0], ci.shape[0] - 1
    u = amounts_f32.view(torch.int32) & 0x7FFFFFFF   # nonnegative order key
    bar, valid = bar_ids_from_close_indices(ci, n, cumsum=cumsum)
    c = (ci[1:] - ci[:-1]).to(torch.int32)
    k = c >> 1                                       # upper-middle rank
    k_lo = (c - 1).clamp(min=0) >> 1

    # every non-empty bar marks its open position (empty bars share theirs
    # with the next bar and never need a prefix); the others write slot n
    open_raw = ci[:-1] + 1
    src = (open_raw >= 0) & (open_raw < n) & (c > 0)
    open_pos = torch.where(src, open_raw, n)
    marks = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    marks[open_pos] = True
    marks = marks[:n]

    def bar_fill(per_bar):
        scat = torch.zeros(n + 1, dtype=torch.int32, device=dev)
        scat[open_pos] = torch.where(src, per_bar, 0)
        return fill(scat[:n], marks)

    prefix = torch.zeros(nb, dtype=torch.int32, device=dev)
    flat_base = bar * _NB
    prev_shift = 31
    for r, shift in enumerate(SHIFTS):
        active = valid if r == 0 else valid & ((u >> prev_shift) == bar_fill(prefix))
        width = prev_shift - shift
        digit = (u >> shift) & ((1 << width) - 1)
        hist = torch.zeros(nb * _NB, dtype=torch.int32, device=dev)
        hist.index_add_(0, flat_base + digit, active.to(torch.int32))
        cum = torch.cumsum(hist.view(nb, _NB), 1, dtype=torch.int32)
        bsel = (cum <= k[:, None]).sum(1, dtype=torch.int32).clamp(max=_NB - 1)
        cum_excl = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], 1)
        k = k - torch.gather(cum_excl, 1, bsel[:, None].long())[:, 0]
        prefix = (prefix << width) | bsel
        prev_shift = shift
    med_b = prefix.view(torch.float32)

    # lower middle: count and largest of the values strictly below med_b
    less = valid & (u < bar_fill(prefix))
    cnt_less = torch.zeros(nb, dtype=torch.int32, device=dev)
    cnt_less.index_add_(0, bar, less.to(torch.int32))
    max_less = torch.full((nb,), -1, dtype=torch.int32, device=dev)
    max_less.scatter_reduce_(0, bar, torch.where(less, u, -1), "amax")
    med_a = torch.where((cnt_less == k_lo + 1) & (max_less >= 0),
                        max_less.view(torch.float32), med_b)
    return med_a, med_b
