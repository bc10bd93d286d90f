"""Triple-Barrier Method labeling (AFML ch. 3).

Counterpart of ``finmlkit_tpu/label/tbm.py``, with the same semantics (see its
module docstring). The JAX package vmaps a chunked ``while_loop`` over events;
here the chunks run for all events at once as ``(events, chunk)`` tensors,
and a Python loop advances the events that have not touched a barrier yet,
until none is left.
"""
import torch

__all__ = ["triple_barrier"]

_CHUNK = 256
_I64MAX = 2**63 - 1


def triple_barrier(timestamps, close, event_idxs, targets,
                   horizontal_barriers, vertical_barrier,
                   min_close_time_sec=0.0, side=None, min_ret=0.0,
                   chunk: int = _CHUNK):
    """Label events with the Triple-Barrier Method.

    ``timestamps`` int64 ns and ``close`` float64 are per bar (or trade);
    ``event_idxs`` int64 and ``targets`` float64 per event, all on one device.
    Returns ``(labels int8, touch_idxs int64, rets float64,
    max_rb_ratios float64)``.
    """
    if vertical_barrier <= 0:
        raise ValueError("The vertical barrier must be greater than zero.")
    if min_ret < 0:
        raise ValueError("The minimum return must be non-negative.")
    if len(timestamps) != len(close):
        raise ValueError("The lengths of timestamps and close must match.")
    if len(event_idxs) != len(targets):
        raise ValueError("The lengths of event_idxs and targets must match.")
    if len(event_idxs) == 0:
        raise ValueError("The event_idxs array must not be empty.")
    is_meta = side is not None
    if is_meta and len(event_idxs) != len(side):
        raise ValueError("The length of event_idxs must match the length of side.")

    f64 = torch.float64
    dev = close.device
    ts = timestamps.to(torch.int64).contiguous()
    log_close = torch.log(close.to(f64))
    ev = event_idxs.to(torch.int64)
    tgt = targets.to(f64)
    side_m = (torch.ones_like(tgt) if side is None else side.to(f64))
    bottom_mult, top_mult = float(horizontal_barriers[0]), float(horizontal_barriers[1])
    min_close_ns = float(min_close_time_sec) * 1e9
    n = ts.shape[0]

    # vertical barrier: last timestamp <= t0 + vb (an infinite barrier
    # saturates to the int64 maximum, as XLA's conversion does)
    t0 = ts[ev]
    t1_target = t0.to(f64) + float(vertical_barrier) * 1e9
    finite = torch.isfinite(t1_target)
    t1_int = torch.where(finite, t1_target, torch.zeros_like(t1_target)).to(torch.int64)
    t1_int = torch.where(finite, t1_int, torch.full_like(t1_int, _I64MAX))
    t1 = torch.searchsorted(ts, t1_int, right=True) - 1

    upper = tgt * top_mult
    lower = -tgt * bottom_mult
    upper_valid = torch.isfinite(upper) & (upper != 0.0)
    lower_valid = torch.isfinite(lower) & (lower != 0.0)
    base = log_close[ev]

    pos = ev + 1
    done = t1 <= ev
    touch = t1.clone()
    mu = torch.zeros_like(tgt)
    ml = torch.zeros_like(tgt)
    offs = torch.arange(chunk, dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=f64, device=dev)
    while True:
        run = ~done & (pos <= t1)
        if not bool(run.any()):
            break
        j = pos[:, None] + offs
        jc = j.clamp(max=n - 1)
        dur = (ts[jc] - t0[:, None]).to(f64)
        active = (j <= t1[:, None]) & (dur >= min_close_ns)
        ret = (log_close[jc] - base[:, None]) * side_m[:, None]
        hit = active & ((ret >= upper[:, None]) | (ret <= lower[:, None]))
        any_hit = hit.any(1)
        ft = hit.to(torch.int8).argmax(1)  # first hit offset
        upto = torch.where(any_hit[:, None], offs[None, :] <= ft[:, None],
                           torch.ones_like(hit))
        consider = active & upto
        urbr = torch.where(consider & (ret > 0.0) & upper_valid[:, None],
                           ret / upper[:, None], zero)
        lrbr = torch.where(consider & (ret < 0.0) & lower_valid[:, None],
                           ret / lower[:, None], zero)
        mu = torch.where(run, torch.maximum(mu, urbr.max(1).values), mu)
        ml = torch.where(run, torch.maximum(ml, lrbr.max(1).values), ml)
        touch = torch.where(run & any_hit, pos + ft, touch)
        done = done | (run & any_hit)
        pos = torch.where(run, pos + chunk, pos)

    # the last processed path point is the touch itself; a vertical barrier
    # inside min_close_time leaves the return at 0 (reference tbm.py:108-116)
    touch_active = (ts[touch] - t0).to(f64) >= min_close_ns
    ret = torch.where(touch_active & (t1 > ev),
                      (log_close[touch] - base) * side_m, zero)
    if is_meta:
        label = (ret >= min_ret).to(torch.int8)
    else:
        sgn = torch.sign(ret)
        label = torch.where(sgn == 0, torch.ones_like(sgn), sgn).to(torch.int8)

    nan = torch.full_like(ret, float("nan"))
    vertical = touch == t1
    pos_ratio = torch.where(upper_valid, mu / (1.0 + ml), nan)
    neg_ratio = torch.where(lower_valid, ml / (1.0 + mu), nan)
    rbr = torch.where(ret > 0.0, pos_ratio, neg_ratio)
    max_rbr = torch.where(vertical, torch.clamp(rbr, max=1.0), torch.ones_like(rbr))

    skipped = t1 <= ev
    label = torch.where(skipped, torch.zeros_like(label), label)
    ret = torch.where(skipped, nan, ret)
    max_rbr = torch.where(skipped, nan, max_rbr)
    touch = torch.where(skipped, ev, touch)
    return label, touch, ret, max_rbr
