"""The volume profile of finmlkit_tpu_torch (``feature/kernels/volume.py``, the
plain path of kernel G on the CPU) against the JAX package's
``finmlkit_tpu.feature.kernels.volume`` on XLA:CPU.

POC, HVA and LVA (integer levels) are exact; ``pct`` is within 1e-6 of the
JAX package's float32 (the port returns float64, ROADMAP R5). The JAX
package builds the developing grid and its cumulative sum in float32, so the
developing profile is held to it exactly on integer volumes whose sums stay
below 2^24, where float32 sums are exact, and to a float64 sequential
emulation on general volumes. ``_kernel_model`` walks kernel G's scheme as one
block of 256 threads would (each window trimmed to its level span, its partial
sums, its tree, its in-place bucketing one chunk of bins at a time, its clip
column, its pair volumes and its walk reading zeros past the span) and is held
to the plain version bit for bit, also on adversarial profiles.

The JAX functions compile once per shape and static argument, so the built
cases share one length, one window and one ``max_levels``.
"""
import numpy as np
import pandas as pd
import pytest
import torch

from finmlkit_tpu.bar import TimeBarKit, TradesData
from finmlkit_tpu.feature.kernels import volume as jv
from finmlkit_tpu_torch.feature.kernels import volume as pv
from finmlkit_tpu_torch.testing import (PROFILE_CASES, PROFILE_EXTRA_CASES, PROFILE_ROW_CASES,
                                       PROFILE_TS, PROFILE_WINDOW, assert_close, assert_exact,
                                       profile_case, profile_rows_case)
from tests.conftest import generate_trades

KEYS = ("timestamp", "low_level", "n_levels", "buy_volumes", "sell_volumes")


@pytest.fixture(scope="module")
def fp():
    """Footprints of the JAX TimeBarKit on the suite's small trades (the
    ``trades_small`` fixture's stream), 10-second bars at a 0.01 tick."""
    ts, px, amt, side = generate_trades(n=5000, seed=1)
    td = TradesData(ts, px, amt.astype(np.float32), np.arange(len(ts), dtype=np.int64),
                    timestamp_unit="ns", preprocess=True)
    kit = TimeBarKit(td, pd.Timedelta(seconds=10))
    bars = kit.build_ohlcv()
    return bars, kit.build_footprints(price_tick_size=0.01)


def _arrays(f):
    return {"timestamp": np.array(f.bar_timestamps), "low_level": np.array(f.low_level),
            "n_levels": np.array(f.n_levels), "buy_volumes": np.array(f.buy_volumes),
            "sell_volumes": np.array(f.sell_volumes)}


def _hold(got, want, what):
    """Port (tensors) against JAX (arrays): levels exact, pct within 1e-6."""
    for i, name in enumerate(("poc", "hva", "lva")):
        assert_exact(got[i], np.asarray(want[i]), f"{what} {name}")
    if len(want) > 3:
        assert_close(got[3], np.asarray(want[3]), rtol=0.0, atol=1e-6, what=f"{what} pct")


@pytest.mark.parametrize("va_pct", [68.34, 50.0])
@pytest.mark.parametrize("n_bins", [None, 9, 27])
@pytest.mark.parametrize("window", [120, 600, 1800])
def test_rolling_matches_jax(fp, window, n_bins, va_pct):
    _, f = fp
    a = _arrays(f)
    args = [a[k] for k in KEYS]
    want = jv.volume_profile_rolling(*args, window, n_bins=n_bins, va_pct=va_pct)
    got = pv.volume_profile_rolling(*args, window, n_bins=n_bins, va_pct=va_pct,
                                    device="cpu")
    _hold(got, want, f"window {window} bins {n_bins} va {va_pct}")
    assert got[3].dtype == torch.float64
    if window < 1800:      # 750 s of trades: the 1800 s window never fills
        assert int((got[0] != 0).sum()) > 10


# --- built cases (testing.profile_case): 40 one-minute bars, a 5-minute window

BAR_TS, WINDOW = PROFILE_TS, PROFILE_WINDOW
N_BARS = len(BAR_TS)


@pytest.mark.parametrize("n_bins", [None, 9, 27])
@pytest.mark.parametrize("name", PROFILE_CASES)
def test_built_cases_match_jax(name, n_bins):
    low, nl, buy, sell, m = profile_case(name)
    args = (BAR_TS, low, nl, buy, sell, WINDOW)
    want = jv.volume_profile_rolling(*args, n_bins=n_bins, max_levels=m)
    got = pv.volume_profile_rolling(*args, n_bins=n_bins, max_levels=m, device="cpu")
    _hold(got, want, f"{name} bins {n_bins}")
    if name == "tied_maxima" and n_bins is None:
        assert int(got[0][-1]) == 1001      # the first of the two peaks
    if name == "clip":
        lo_w = np.array([low[max(i - 5, 0):i + 1].min() for i in range(N_BARS)])
        hi_w = np.array([(low + nl)[max(i - 5, 0):i + 1].max() for i in range(N_BARS)])
        assert (hi_w - lo_w > m).any()     # the case reaches the clip


def test_default_max_levels_is_the_widest_window(fp):
    """``max_levels`` by the device's window extrema equals the JAX package's
    scipy filters (``volume.py:219-229``)."""
    _, f = fp
    a = _arrays(f)
    for window in (120, 600):
        ts, low, nlev, buy, sell = pv._footprint_tensors(*(a[k] for k in KEYS), "cpu")
        _, _, m = pv._rolling_sizes(ts, low, nlev, buy.shape[1], window * 10**9, None)
        start = np.searchsorted(a["timestamp"], a["timestamp"] - window * 10**9)
        w = int((np.arange(len(start)) - start + 1).max())
        lo, hi = a["low_level"], a["low_level"] + a["n_levels"]
        span = max(int(hi[i:i + w].max() - lo[i:i + w].min())
                   for i in range(len(lo) - w + 1))
        assert m == max(span, a["buy_volumes"].shape[1])


# --- kernel G's scheme, modelled on the CPU ---------------------------------

THREADS = 256


def _wrap(v):
    return int((v + 2**31) % 2**32 - 2**31)


def _block_sum(vals):
    """Kernel G's block sum: partial t adds levels t, t + 256, ... in order,
    then a fixed tree halves the 256 partials."""
    part = np.zeros(THREADS)
    for k, v in enumerate(vals):
        part[k % THREADS] = part[k % THREADS] + v
    s = THREADS
    while s > 1:
        s //= 2
        part[:s] = part[:s] + part[s:2 * s]
    return part[0]


def _first_max(vals):
    """The block argmax: the first of equal maxima, NaN the largest."""
    best, ib = None, None
    for k, v in enumerate(vals):
        if ib is None or (np.isnan(v) and not np.isnan(best)) or \
                (not np.isnan(v) and not np.isnan(best) and v > best):
            best, ib = v, k
    return ib, best


def _model_walk(up, down, n_up_m, cum, thr):
    """Kernel G's ``walk`` in one thread: the steps taken up and down over the
    pair volumes ``up`` (then zeros up to ``n_up_m``, then -1) and ``down``
    (then -1). Its fast loops (both sides stored; the down side ended; the up
    side reading zeros against a down pair of at least zero) and, for anything
    else, one step of the plain walk."""
    nu, nd = len(up), len(down)
    a = b = 0
    general = False
    while cum < thr:
        if not general and a < nu and b < nd:
            while True:
                u, d = up[a], down[b]
                if not (u > d or u < d or (u == d and u != -1.0)):
                    general = True
                    break
                cum = cum + (u if u > d else d if u < d else u + d)
                a, b = a + (not u < d), b + (not u > d)
                if not (cum < thr and a < nu and b < nd):
                    break
        elif not general and a < nu:
            while True:
                if not up[a] > -1.0:
                    general = True
                    break
                cum, a = cum + up[a], a + 1
                if not (cum < thr and a < nu):
                    break
        elif not general and a < n_up_m and b < nd:
            while True:
                d = down[b]
                if d > 0.0:
                    cum, b = cum + d, b + 1
                elif d == 0.0:
                    cum, a, b = cum + (0.0 + d), a + 1, b + 1
                else:
                    general = True
                    break
                if not (cum < thr and a < n_up_m and b < nd):
                    break
        else:
            cu = up[a] if a < nu else (0.0 if a < n_up_m else -1.0)
            cd = down[b] if b < nd else -1.0
            go_up, go_down, both = cu > cd, cu < cd, cu == cd and cu != -1.0
            if not (go_up or go_down or both):
                break
            if go_up and b >= nd and a >= nu:   # zeros to the end
                a = n_up_m
                break
            cum = cum + (cu if go_up else cd if go_down else cu + cd)
            a += go_up or both
            b += go_down or both
            general = False
    return a, b


def _model_profile(g, lo, n_bins, va_frac, m=None):
    """Kernel G's ``profile`` on a grid trimmed to its span (numpy float64 of
    S levels, modified in place; levels S to m - 1 are zeros): the bins that
    can hold volume formed in place a chunk of 256 at a time, the sums and the
    POC over the span, the pair volumes of both sides formed in place, then the
    one-thread walk over them, reading zeros up to m and -1 past it."""
    S = len(g)
    m = S if m is None else m
    binned = bool(n_bins)
    if binned:
        pos = [k for k in range(S) if g[k] > 0]
        has = bool(pos)
        kmin, kmax = (pos[0], pos[-1]) if has else (0, -1)
        mn = _wrap(lo + kmin) if has else 2**31 - 1
        mx = _wrap(lo + kmax) if has else -2**31
        rng = _wrap(mx - mn)
        bw = max(1, rng // n_bins)
        bw = _wrap(bw + 1) if bw % 2 == 0 else bw
        n_full = max(_wrap(rng + bw - 1) // bw, 1)
        nb = (kmax - kmin) // bw + 1 if has else 1
        for cb in range(0, nb, THREADS):          # one chunk of bins: read all, then write
            sums = []
            for b in range(cb, min(cb + THREADS, nb)):
                s = 0.0
                if has:
                    for k in range(kmin + b * bw, min(kmin + b * bw + bw, S)):
                        if g[k] > 0:
                            s = s + g[k]
                sums.append(s)
            g[cb:cb + len(sums)] = sums
        S = nb

    def label(k):
        if not binned:
            return _wrap(lo + k)
        edges = _wrap(mn + _wrap(k * bw))
        return _wrap(edges + (bw - 1) // 2) if k < n_full else (mx if k == n_full else edges)

    total = _block_sum(g[:S])
    p, best = _first_max(g[:S])
    if S < m and best < 0:                       # every level below S negative
        p = S
    poc = label(p)
    above = _block_sum([g[k] if label(k) > poc else 0.0 for k in range(S)])
    n_up = (S - p) // 2 if p + 1 < S else 0
    n_down, n_up_m = (p + 1) // 2, (m - p) // 2
    cum = g[p] if p < S else 0.0
    up = [g[x] + (g[x + 1] if x + 1 < S else 0.0) for x in range(p + 1, p + 1 + 2 * n_up, 2)]
    down = [g[x] + (g[x - 1] if x >= 1 else 0.0) for x in range(p - 1, p - 1 - 2 * n_down, -2)]
    a, b = _model_walk(up, down, n_up_m, cum, total * va_frac)
    hv = min(p + 2 * a, m - 1) if a else p
    lv = max(p - 2 * b, 0) if b else p
    pct = above / total if total > 0 and above > 0 else 0.0
    return poc, label(hv), label(lv), pct


def _model_row(row, lo, n_bins, va_frac):
    """Kernel G's rows mode on one row: trimmed one past its last nonzero."""
    nz = np.flatnonzero(row != 0)
    span = int(nz[-1]) + 1 if nz.size else 1
    return _model_profile(np.array(row[:span], np.float64), lo, n_bins, va_frac, len(row))


def _kernel_model(ts, low, nl, buy, sell, window, n_bins, va_pct, m):
    """Kernel G's rolling mode on the CPU: each bar's window spans
    ``max_j(low_j + n_levels_j) - min_j low_j`` levels (within [1, m]); its
    grid of that many levels is filled bar by bar (a column past m - 1 lands on
    m - 1 in column order), then ``_model_profile``."""
    n, width = buy.shape
    window_ns = int(window * 1e9)
    start = np.searchsorted(ts, ts - window_ns)
    first = np.searchsorted(ts, ts[0] + window_ns)
    nlc = np.clip(np.asarray(nl, np.int64), 0, width)
    out = [np.zeros(n, np.int32) for _ in range(3)] + [np.zeros(n)]
    for i in range(first, n):
        s = start[i]
        lo = int(low[s:i + 1].min())
        span = min(max(int((low[s:i + 1].astype(np.int64) + nlc[s:i + 1]).max()) - lo, 1), m)
        g = np.zeros(span)
        for j in range(s, i + 1):
            off = int(low[j]) - lo
            for c in range(nlc[j]):
                v = np.float64(buy[j, c]) + np.float64(sell[j, c])
                col = off + c if off + c < m - 1 else m - 1
                g[col] = g[col] + v
        for o, v in zip(out, _model_profile(g, lo, n_bins, va_pct / 100.0, m)):
            o[i] = v
    return out


@pytest.mark.parametrize("n_bins", [None, 9, 27])
@pytest.mark.parametrize("name", ["random", "gaps", "no_volume", "clip", "fp"])
def test_kernel_model_matches_plain(fp, name, n_bins):
    if name == "fp":
        a = _arrays(fp[1])
        ts, low, nl, buy, sell = (a[k] for k in KEYS)
        window, m = 120, None
    else:
        (low, nl, buy, sell, m), ts, window = profile_case(name), BAR_TS, WINDOW
    got = pv.volume_profile_rolling(ts, low, nl, buy, sell, window, n_bins=n_bins,
                                    max_levels=m, device="cpu")
    if m is None:
        t = pv._footprint_tensors(ts, low, nl, buy, sell, "cpu")
        m = pv._rolling_sizes(t[0], t[1], t[2], buy.shape[1], window * 10**9, None)[2]
    want = _kernel_model(ts, low, nl, buy, sell, window, n_bins, 68.34, m)
    for g, w, what in zip(got, want, ("poc", "hva", "lva", "pct")):
        assert_exact(g, w, f"{name} {what}")


def test_rows_model_matches_plain_past_one_chunk():
    """Rows of 700 levels (three chunks of bins) with one bin per level and
    wider bins: the in-place bucketing's chunks."""
    r = np.random.default_rng(5)
    grid = np.where(r.random((6, 700)) < 0.3, r.integers(1, 100, (6, 700)), 0).astype(float)
    grid[0] = 0.0                                    # no volume at all
    grid[1, :650] = 0.0                              # volume only in the last chunk
    for n_bins in (None, 3, 600, 700):
        got = pv._profile_rows(torch.from_numpy(grid.copy()), 5000, n_bins, 0.6834)
        for row in range(grid.shape[0]):
            want = _model_row(grid[row], 5000, n_bins, 0.6834)
            for g, w in zip(got, want):
                assert_exact(g[row:row + 1], np.asarray([w], g.numpy().dtype),
                             f"row {row} bins {n_bins}")


# --- the span-trimmed scheme on adversarial profiles ------------------------

SPAN_CASES = [("rows", k) for k in PROFILE_ROW_CASES] \
    + [("rolling", k) for k in PROFILE_CASES + PROFILE_EXTRA_CASES]


@pytest.mark.parametrize("va_pct", [68.34, 99.999, 100.0])
@pytest.mark.parametrize("n_bins", [None, 9, 27])
@pytest.mark.parametrize("mode,name", SPAN_CASES, ids=[f"{a}-{b}" for a, b in SPAN_CASES])
def test_span_model_matches_plain(mode, name, n_bins, va_pct):
    """The span-trimmed scheme (``_model_profile``: sums over each profile's
    span, pairs formed in place, the walk reading zeros past the span up to
    ``max_levels``) equals the plain version bit for bit on profiles with pair
    ties, equal running minima, NaN levels, walks to either end and into the
    zeros past the span (va_pct 100 and 99.999), no volume, one level, the clip
    column and ``max_levels`` above every span."""
    if mode == "rows":
        grid, lo = profile_rows_case(name)
        got = pv._profile_rows(torch.from_numpy(grid.copy()), lo, n_bins, va_pct / 100.0)
        for row in range(grid.shape[0]):
            want = _model_row(grid[row], lo, n_bins, va_pct / 100.0)
            for g, w, what in zip(got, want, ("poc", "hva", "lva", "pct")):
                assert_exact(g[row:row + 1], np.asarray([w], g.numpy().dtype),
                             f"{name} row {row} {what}")
        if name == "zero_tail" and n_bins is None and va_pct == 100.0:
            assert int((got[1] == lo + grid.shape[1] - 1).sum()) >= 3   # HVA at the grid's end
        return
    low, nl, buy, sell, m = profile_case(name)
    got = pv.volume_profile_rolling(BAR_TS, low, nl, buy, sell, WINDOW, n_bins=n_bins,
                                    va_pct=va_pct, max_levels=m, device="cpu")
    want = _kernel_model(BAR_TS, low, nl, buy, sell, WINDOW, n_bins, va_pct, m)
    for g, w, what in zip(got, want, ("poc", "hva", "lva", "pct")):
        assert_exact(g, w, f"{name} {what}")


# --- the developing profile and VolumePro ---------------------------------

def _integer_volumes(a, seed=3):
    """The footprints with integer volumes, so that float32 sums stay exact."""
    r = np.random.default_rng(seed)
    mask = np.arange(a["buy_volumes"].shape[1])[None, :] < a["n_levels"][:, None]
    out = dict(a)
    for k in ("buy_volumes", "sell_volumes"):
        out[k] = np.where(mask, r.integers(0, 500, a[k].shape), 0).astype(np.float32)
    return out


@pytest.mark.parametrize("n_bins", [None, 27])
def test_developing_matches_jax_on_integer_volumes(fp, n_bins):
    a = _integer_volumes(_arrays(fp[1]))
    ts = a["timestamp"]
    args = [a[k] for k in KEYS]
    for s, e in ((ts[3], ts[60]), (ts[0] - 1, ts[-1] + 1), (ts[10], ts[10]), (ts[20], ts[5])):
        want = jv.volume_profile_developing(*args, int(s), int(e), n_bins=n_bins)
        got = pv.volume_profile_developing(*args, int(s), int(e), n_bins=n_bins,
                                           device="cpu")
        assert_exact(got[0], np.asarray(want[0]), "developing timestamps")
        _hold(got[1:], want[1:], f"developing [{s}, {e}] bins {n_bins}")


def _seq_developing(a, s, e, va_pct=68.34):
    """Float64 sequential emulation of the developing profile (no bins)."""
    lo, nl = a["low_level"][s:e].astype(np.int64), a["n_levels"][s:e]
    g_lo, g_hi = lo.min(), (lo + nl).max() - 1
    grid = np.zeros(g_hi - g_lo + 1)
    out = []
    for j in range(s, e):
        o = int(a["low_level"][j]) - g_lo
        n = int(a["n_levels"][j])
        grid[o:o + n] += (a["buy_volumes"][j, :n].astype(np.float64)
                          + a["sell_volumes"][j, :n])
        out.append(_model_row(grid, int(g_lo), None, va_pct / 100.0)[:3])
    return [np.array(v, np.int32) for v in zip(*out)]


def test_developing_matches_float64_emulation(fp):
    a = _arrays(fp[1])
    ts = a["timestamp"]
    got = pv.volume_profile_developing(*(a[k] for k in KEYS), int(ts[2]), int(ts[-3]),
                                       device="cpu")
    want = _seq_developing(a, 2, len(ts) - 2)
    for g, w, what in zip(got[1:], want, ("poc", "hva", "lva")):
        assert_exact(g, w, f"developing {what}")


@pytest.mark.parametrize("n_bins", [27, None])
def test_volumepro_compute_matches_jax(fp, n_bins):
    bars, f = fp
    a = _arrays(f)
    for window in (120, 600):
        vp_j = jv.VolumePro(pd.Timedelta(seconds=window), n_bins=n_bins)
        vp_p = pv.VolumePro(window, n_bins=n_bins)
        want = vp_j.compute(bars, f)
        got = vp_p.compute(a, f.price_tick, device="cpu")
        for i in range(3):
            assert_exact(got[i], want[i], f"compute {window} {i}")
        assert_close(got[3], want[3], rtol=0.0, atol=1e-6, what="compute pct")
        assert bool(torch.isnan(got[0][:3]).all())     # the warm-up is NaN


def test_volumepro_compute_range_matches_jax(fp):
    bars, f = fp
    a = _arrays(f)
    ts = a["timestamp"]
    vp_j, vp_p = jv.VolumePro(pd.Timedelta(seconds=120)), pv.VolumePro(120.0)
    for s, e in ((ts[30], ts[60]), (ts[5], ts[-1])):
        want = vp_j.compute_range(bars, f, pd.Timestamp(int(s)), pd.Timestamp(int(e)))
        got = vp_p.compute_range(a, f.price_tick, int(s), int(e), device="cpu")
        assert_exact(got[0], np.asarray(want[0]), "range timestamps")
        for i in range(1, 4):
            assert_exact(got[i], want[i], f"range output {i}")
        assert_close(got[4], want[4], rtol=0.0, atol=1e-6, what="range pct")


def test_volumepro_takes_a_timedelta_and_resets():
    import datetime
    vp = pv.VolumePro(datetime.timedelta(minutes=5))
    assert vp.window_size_sec == 300.0 and vp.n_bins == 27 and vp.va_pct == 68.34
    vp.reset_parameters(window_size_sec=60.0, n_bins=9, va_pct=70.0)
    assert (vp.window_size_sec, vp.n_bins, vp.va_pct) == (60.0, 9, 70.0)


def test_profile_rejects_mismatched_footprints():
    low, nl, buy, sell, _ = profile_case("random")
    with pytest.raises(ValueError, match="one value a bar"):
        pv.volume_profile_rolling(BAR_TS, low[:-1], nl, buy, sell, WINDOW, device="cpu")
