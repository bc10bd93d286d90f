"""Comparisons that the parity tests and ``chip_smoke.py`` share.

Each raises ``AssertionError`` with the largest deviation when the two sides
differ beyond what the comparison allows.
"""
import numpy as np
import torch

__all__ = ["to_numpy", "assert_exact", "assert_close", "assert_window_close",
           "adversarial_trades", "tile_closes", "TILE_CLOSES", "zeros_and_twos",
           "cusum_recurrence", "CUSUM_BAD", "cusum_bad_inputs", "PROFILE_CASES",
           "PROFILE_TS", "PROFILE_WINDOW", "profile_case", "PROFILE_EXTRA_CASES",
           "PROFILE_ROW_CASES", "profile_rows_case", "CSW_FILTER_CASES", "csw_filter_case"]


def to_numpy(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_exact(got, want, what: str = "") -> None:
    """Equal values of equal dtype; floats compare by bits, except that any
    NaN equals any NaN (the sign of a 0/0 NaN depends on the device)."""
    g, w = to_numpy(got), to_numpy(want)
    if g.shape != w.shape or g.dtype != w.dtype:
        raise AssertionError(f"{what}: {g.dtype}{g.shape} vs {w.dtype}{w.shape}")
    if g.dtype.kind == "f":
        nan_g, nan_w = np.isnan(g), np.isnan(w)
        if not np.array_equal(nan_g, nan_w):
            raise AssertionError(f"{what}: NaN at different positions")
        ib = {2: np.int16, 4: np.int32, 8: np.int64}[g.dtype.itemsize]
        g, w = g[~nan_g].view(ib), w[~nan_w].view(ib)
    bad = np.flatnonzero(g != w)
    if bad.size:
        i = bad[0]
        raise AssertionError(f"{what}: {bad.size} of {g.size} differ, first at "
                             f"{i}: {g.reshape(-1)[i]!r} vs {w.reshape(-1)[i]!r}")


def assert_close(got, want, rtol: float, atol: float = 0.0, what: str = "") -> float:
    """|got - want| <= atol + rtol * |want|, NaN where both are NaN.
    Returns the largest absolute deviation."""
    g = to_numpy(got).astype(np.float64)
    w = to_numpy(want).astype(np.float64)
    if g.shape != w.shape:
        raise AssertionError(f"{what}: shape {g.shape} vs {w.shape}")
    nan_g, nan_w = np.isnan(g), np.isnan(w)
    if not np.array_equal(nan_g, nan_w):
        raise AssertionError(f"{what}: NaN at different positions")
    d = np.abs(g[~nan_g] - w[~nan_w])
    lim = atol + rtol * np.abs(w[~nan_w])
    if np.any(d > lim):
        i = int(np.argmax(d - lim))
        raise AssertionError(f"{what}: |diff| {d[i]!r} above {lim[i]!r} "
                             f"(rtol {rtol}, atol {atol})")
    return float(d.max()) if d.size else 0.0


def assert_window_close(got, want, scale: float, rtol: float, what: str = "") -> float:
    """Values that are differences of two prefix sums of magnitude up to
    ``scale`` (window sums, returns as differences of log prices): their
    rounding error scales with the prefix, so the bound is
    ``rtol * (|want| + scale)``."""
    return assert_close(got, want, rtol=rtol, atol=rtol * float(scale), what=what)


def adversarial_trades(n: int, seed: int, first: int = -1, long_bar: int = 0,
                       mean_bar: int = 600):
    """Quantized trades and close indices that hit the bar kernel's edge
    cases: side-0 trades, units above 2^31, tied amounts, empty bars
    (repeated close indices), single-trade bars, the open anchor ``first``
    (-1, or a trade index when earlier trades lie outside every bar), one bar
    of ``long_bar`` trades, and trailing trades after the last bar.

    Returns numpy ``(ticks int32, units int64, sides int8, amounts float32,
    ci int64)``.
    """
    g = np.random.default_rng(seed)
    ticks = (1_070_000 + np.cumsum(g.integers(-3, 4, n))).astype(np.int32)
    units = g.integers(1, 10**7, n).astype(np.int64)
    units[::7] = g.integers(2**31, 2**40, len(units[::7]))
    units[::11] = units[3]
    sides = g.choice(np.array([-1, 0, 1], np.int8), n, p=[0.45, 0.1, 0.45])
    amounts = (units.astype(np.float64) * 1e-8).astype(np.float32)
    ci = [first]
    pos = first
    if long_bar:
        pos += long_bar
        ci.append(pos)
    end = n - 1 - min(5, n // 4)
    while pos < end:
        u = g.random()
        if u < 0.1:
            pos += 1            # single-trade bar
        elif u > 0.95:
            pass                # empty bar
        else:
            pos += int(g.geometric(1.0 / mean_bar))
        pos = min(pos, end)
        ci.append(pos)
    return ticks, units, sides, amounts, np.asarray(ci, np.int64)


TILE_CLOSES = ("edges", "mid_span", "empty_run", "single_edges", "anchor_inside")


def tile_closes(name: str, n: int, tile: int) -> np.ndarray:
    """Close indices over ``n`` trades (n >= 4 * tile, tile >= 32) that put the bars
    where a kernel cutting the stream into tiles of ``tile`` trades meets
    its edges (``TILE_CLOSES`` names them):

    - ``edges``: a bar opens at every tile start (one start twice: an empty
      bar), trades after the last bar;
    - ``mid_span``: a bar opens mid-tile and spans three tiles and more;
    - ``empty_run``: 10,000 empty bars inside one tile;
    - ``single_edges``: single-trade bars at trade 0 and at the last and
      first trades around two tile edges;
    - ``anchor_inside``: ``ci[0]`` inside a tile, earlier trades in no bar.
    """
    if name == "edges":
        e = list(range(tile - 1, n - 10, tile))
        ci = [-1] + e + e[2:3] + [n - 10]
    elif name == "mid_span":
        a = tile // 2 + 3
        ci = [-1, tile // 4, a, a + 3 * tile + tile // 8, n - 7]
    elif name == "empty_run":
        ci = [-1, tile // 16, tile + tile // 8] + [tile + tile // 4] * 10_000 + [
            tile + tile // 2, n - 1]
    elif name == "single_edges":
        ci = [-1, 0, tile - 2, tile - 1, tile, 3 * tile - 2, 3 * tile - 1, 3 * tile,
              n - 3]
    elif name == "anchor_inside":
        ci = [tile + 7, tile + tile // 2, 2 * tile + 1, 3 * tile + tile // 2, n - 2]
    else:
        raise KeyError(name)
    return np.asarray(sorted(ci), np.int64)


def zeros_and_twos(repeats: int):
    """(amounts float32, ci int64) of five bars of 0.0, 2.0 (bits 0x40000000)
    and the next float up, ``repeats`` times over. At the hist engine's last
    shift a bar's base is 2^30 from its zeros (median 2.0000002) or from its
    2.0 (median 0.0), so the bucket of those trades is +-2^30."""
    up = np.nextafter(np.float32(2.0), np.float32(3.0))
    bars = [[0.0, 2.0, up, up, up], [0.0, 0.0, 0.0, 2.0], [2.0, 0.0, 0.0],
            [2.0, 2.0, 0.0, 0.0, up, 0.0], [up, 2.0]]
    amounts = np.concatenate([np.asarray(b, np.float32) for b in bars] * repeats)
    ci = np.concatenate([[-1], np.cumsum([len(b) for b in bars] * repeats) - 1])
    return torch.from_numpy(amounts), torch.from_numpy(ci.astype(np.int64))


def cusum_recurrence(rets, lam, can_close, start: int, max_bars=None) -> np.ndarray:
    """The CUSUM bars' close indices by the reference's exact host loop
    (``finmlkit_tpu/native/seg_stats.cpp:159-176``), transcribed to numpy
    float64 line for line: from trade ``start + 1`` on, both sums add the
    return and clamp at 0 by a compare that keeps a NaN; a trade that may
    close closes where ``s+ >= lam`` (s+ resets) or else ``s- <= -lam`` (s-
    resets). The oracle of the port's CUSUM scans on any input."""
    r, lm = to_numpy(rets).astype(np.float64), to_numpy(lam).astype(np.float64)
    cc = to_numpy(can_close).astype(bool)
    cap = len(r) if max_bars is None else max_bars
    sp = sn = np.float64(0.0)
    out = []
    with np.errstate(invalid="ignore"):
        for i in range(start + 1, len(r)):
            if len(out) >= cap:
                break
            sp, sn = sp + r[i], sn + r[i]
            if sp < 0.0:
                sp = np.float64(0.0)
            if sn > 0.0:
                sn = np.float64(0.0)
            if not cc[i]:
                continue
            if sp >= lm[i]:
                out.append(i)
                sp = np.float64(0.0)
            elif sn <= -lm[i]:
                out.append(i)
                sn = np.float64(0.0)
    return np.asarray(out, np.int64)


CUSUM_BAD = ("nan", "nan_tile_last", "nan_tile_first", "nan_segment_last", "inf", "-inf",
             "zero_price_block", "zero_price", "nan_lam", "nan_and_inf_lam")


def cusum_bad_inputs(name: str, n: int = 20_000, at: int = 5000, seed: int = 7):
    """``(rets, lam, can_close, timestamps)``, numpy, of a CUSUM scan from
    trade 1 (start 0) with one bad input near trade ``at``: returns and
    thresholds on a grid of 2^-30 (every sum exact, a close every 60 trades
    or so), one trade in ten the first of a same-timestamp pair (it may not
    close), and by ``name`` (``CUSUM_BAD``): a NaN return at ``at``, at the
    last or first trade of a tile of kernel E (2048 trades counted from trade
    1) or at the last of a segment (256); +inf or -inf at ``at``, which may
    close; a zero price, -inf then +inf, inside one same-timestamp block of
    three trades or at two trades that may close; NaN thresholds on the 300
    trades from ``at``, or NaN and +inf in turn."""
    rng = np.random.default_rng(seed)
    rets = rng.integers(-1000, 1001, n) * 2.0 ** -30
    rets[0] = 0.0
    lam = rng.integers(4_000, 8_000, n) * 2.0 ** -30
    ts = np.cumsum(rng.random(n) >= 0.1).astype(np.int64)
    edge = 1 + 2048 * (at // 2048 + 1)       # a tile's first trade after at
    if name in ("nan", "nan_tile_last", "nan_tile_first", "nan_segment_last"):
        rets[{"nan": at, "nan_tile_last": edge - 1, "nan_tile_first": edge,
              "nan_segment_last": edge + 255}[name]] = np.nan
    elif name in ("inf", "-inf"):
        rets[at] = float(name)
        ts[at + 1:] += 1                      # trade at may close
    elif name in ("zero_price_block", "zero_price"):
        rets[at], rets[at + 1] = -np.inf, np.inf   # log(0) - log(p), log(p') - log(0)
        if name == "zero_price_block":        # one timestamp for at .. at + 2
            ts[at + 1:] -= ts[at + 1] - ts[at]
            ts[at + 2:] -= ts[at + 2] - ts[at + 1]
            ts[at + 3:] += 1
        else:                                 # at and at + 1 may close
            ts[at + 1:] += 1
            ts[at + 2:] += 1
    elif name == "nan_lam":
        lam[at:at + 300] = np.nan
    elif name == "nan_and_inf_lam":
        lam[at:at + 300:2] = np.nan
        lam[at + 1:at + 300:2] = np.inf
    else:
        raise KeyError(name)
    return rets, lam, np.append(ts[:-1] != ts[1:], True), ts


PROFILE_CASES = ("random", "tied_maxima", "equal_pairs", "gaps", "no_volume", "one_level",
                 "clip")
PROFILE_EXTRA_CASES = ("wide", "nan")   # max_levels above every span; a NaN volume
_PROFILE_BARS, _PROFILE_L = 40, 16
PROFILE_TS = 1_704_067_200 * 10**9 + np.arange(_PROFILE_BARS, dtype=np.int64) * 60 * 10**9
PROFILE_WINDOW = 300      # seconds: windows of six one-minute bars


def _profile_bars(profile, lows=None, nl=None):
    prof = np.asarray(profile, np.float32)
    n, width = _PROFILE_BARS, _PROFILE_L
    buy = np.zeros((n, width), np.float32)
    sell = np.zeros((n, width), np.float32)
    buy[:, :len(prof)] = np.floor(prof / 2)
    sell[:, :len(prof)] = prof - np.floor(prof / 2)
    low = np.full(n, 1000, np.int32) if lows is None else np.asarray(lows, np.int32)
    n_lev = np.full(n, len(prof), np.int32) if nl is None else np.asarray(nl, np.int32)
    return low, n_lev, buy, sell


def profile_case(name: str):
    """Footprints of 40 one-minute bars (``PROFILE_TS``) of 16 levels with
    integer float32 volumes that reach the volume profile's edge cases
    (``PROFILE_CASES``): random; two equal peaks (the first is the POC); a
    profile symmetric about its POC (both sides move at once); zero-volume
    levels inside the range; 12 empty bars (one level, no volume: some
    windows hold no volume); one-level bars; windows wider than the grid
    (``max_levels`` 12: the clip column); of ``PROFILE_EXTRA_CASES``, the
    random bars with ``max_levels`` 200, above every window's span, or with a
    NaN volume in bar 20. Returns ``(low_level int32, n_levels int32, buy
    float32 (40, 16), sell, max_levels)``."""
    if name == "wide":
        low, nl, buy, sell, _ = profile_case("random")
        return low, nl, buy, sell, 200
    if name == "nan":
        low, nl, buy, sell, m = profile_case("random")
        buy = buy.copy()
        buy[20, min(3, int(nl[20]) - 1)] = np.nan
        return low, nl, buy, sell, m
    r = np.random.default_rng(PROFILE_CASES.index(name))
    n = _PROFILE_BARS
    if name in ("random", "no_volume", "clip"):
        low = (1000 + np.cumsum(r.integers(-3, 4, n))).astype(np.int32)
        nl = r.integers(1, _PROFILE_L + 1, n).astype(np.int32)
        buy = r.integers(0, 50, (n, _PROFILE_L)).astype(np.float32)
        sell = r.integers(0, 50, (n, _PROFILE_L)).astype(np.float32)
        if name == "no_volume":
            buy[10:22] = sell[10:22] = 0.0
            nl[10:22] = 1
        if name == "clip":
            low = (1000 + 7 * np.arange(n) % 40).astype(np.int32)
        return low, nl, buy, sell, 12 if name == "clip" else 64
    if name == "tied_maxima":
        return (*_profile_bars([1, 6, 2, 0, 3, 6, 1, 1]), 64)
    if name == "equal_pairs":
        return (*_profile_bars([1, 1, 2, 2, 9, 2, 2, 1, 1]), 64)
    if name == "gaps":
        low = np.where(np.arange(n) % 3 == 0, 1000, 1004)
        return (*_profile_bars([5, 0, 0, 0, 2, 0, 0, 7, 0, 0, 1, 4], lows=low), 64)
    if name == "one_level":
        low = 1000 + np.cumsum(r.integers(-2, 3, n))
        return (*_profile_bars([3], lows=low, nl=np.ones(n)), 64)
    raise KeyError(name)


PROFILE_ROW_CASES = ("pair_ties", "equal_minima", "small_integers", "nan", "reach_ends",
                     "zero_tail", "all_zero", "one_level", "negative")


def _padded(rows, m):
    out = np.zeros((len(rows), m))
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


def profile_rows_case(name: str):
    """``(grid float64 (rows, M), lo)`` of developing-profile rows that reach
    the value-area walk's edge cases (``PROFILE_ROW_CASES``): pairs tied at
    every step and at zero pairs; equal running minima of the two sides' pairs
    with unequal raw pairs; values 0-3 everywhere with labels that wrap past
    int32; a NaN level above, below and at the POC; volume at both ends; walks
    into the zeros past the span (three rows whose sum in the walk's order
    ends below their total); no volume (+0.0 and -0.0); one level; every level
    below the span negative."""
    r = np.random.default_rng(len(name))
    if name == "pair_ties":          # both sides tie at every step, at zero pairs too
        return _padded([[1] * 6 + [9] + [1] * 6, [0, 0, 2, 2, 0, 0, 9, 0, 0, 2, 2, 0, 0],
                        [3, 3, 3, 3, 3, 3, 3, 3]], 24), 1000
    if name == "equal_minima":       # equal running minima, unequal raw pairs
        return _padded([[3, 3, 2, 1, 2, 2, 20, 1, 2, 2, 3, 1, 1],
                        [1, 0, 2, 3, 3, 2, 0, 1, 1, 2, 30, 2, 2, 1, 1, 1, 1, 0, 5, 1, 1]], 40), -7
    if name == "small_integers":     # values 0-3: ties and zero pairs everywhere
        rows = [r.integers(0, 4, r.integers(1, 48)) for _ in range(24)]
        return _padded(rows, 48), 2**31 - 30          # labels wrap past int32
    if name == "nan":                # a NaN level above, below and at the POC
        rows = [[1, 2, 3, 9, 4, np.nan, 2, 1], [1, np.nan, 3, 9, 4, 2, 2, 1],
                [1, 2, np.nan, 3, 1], [np.nan, 0, 0, 1]]
        return _padded(rows, 16), 50
    if name == "reach_ends":         # volume at both ends of the grid
        return _padded([r.integers(1, 9, 20), np.r_[5, np.zeros(18), 5],
                        np.r_[9, r.integers(0, 3, 19)], np.r_[r.integers(0, 3, 19), 9]], 20), 0
    if name == "zero_tail":          # the walk may run into the zeros past the span; the
        # last three rows sum, in the walk's order, to below their total, so at
        # va_pct 100 their walks run to the grid's end
        return _padded([[1, 2, 1, 3, 2, 1, 2, 9, 4, 1], [9, 1, 1], [1, 1, 1, 1, 1, 1, 1, 9],
                        [0, 0, 0, 5, 0, 1], [1.5, 1.8, 0.1], [1.3, 0.3, 1.0, 1.9, 0.1, 2.6],
                        [0.1, 0.2, 3.0, 2.6]], 64), 100
    if name == "all_zero":           # no volume, +0.0 and -0.0
        return np.vstack([np.zeros(12), np.full(12, -0.0), _padded([[-0.0, 0.0, -0.0]], 12)[0]]), 3
    if name == "one_level":          # one level of volume, at either end or inside
        return _padded([[7], [0, 0, 0, 7], np.r_[np.zeros(15), 7]], 16), 10
    if name == "negative":           # every level below the span negative: the POC is past it
        return _padded([[-1, -2, -3, -1], [-2], [-1, -0.0, -4]], 10), 0
    raise KeyError(name)


# Series for kernel W's filter (csrc/csw.cu): log prices y, a sigma for each t
# (given, not derived, so it can sit at the edges) and the window w.
CSW_FILTER_CASES = ("walk", "tie_subnormal", "tie_normal", "flat", "nonfinite",
                    "subnormal", "sigma_edge", "sigma_huge", "huge_dyn", "w3")


def _walk_sigma(y, w):
    """Sigma as the CSW test computes it (the std of the changes over the
    window), in numpy."""
    n = len(y)
    d2 = np.r_[0.0, np.diff(y) ** 2]
    cum = np.cumsum(d2)
    idx = np.arange(n)
    t_loc = np.minimum(idx, w)
    return np.sqrt((cum - cum[np.clip(idx - t_loc, 0, n - 1)]) / np.maximum(t_loc - 1, 1))


def _tie(y, sigma, t, sig, d_small, d_large, sign, d_4=None):
    """At t: lags 9 and 36 (sqrt 3 and 6, denominators exactly 2x apart) with
    quotients d_small / (3 sig) > d_large / (6 sig) that round to the same
    double, so the larger lag, with the smaller quotient, must win; with
    ``d_4``, lag 4 (kernel W's lane of lag 36, so that 36 is not its lane's
    best lag) ties too; every other lag's dyn 0."""
    y[t - 60:t + 1] = y[t]
    sigma[t] = sig
    y[t - 9] = y[t] - sign * d_small
    y[t - 36] = y[t] - sign * d_large
    if d_4 is not None:
        y[t - 4] = y[t] - sign * d_4


def csw_filter_case(name: str):
    """``(y, sigma, w)``, float64 numpy arrays and an int: adversarial series
    for kernel W's filter, each named for what it holds."""
    r = np.random.default_rng(CSW_FILTER_CASES.index(name) + 31)
    if name == "walk":
        y = np.log(100.0) + np.cumsum(r.normal(0.0, 1e-3, 300))
        return y, _walk_sigma(y, 100), 100
    if name == "tie_subnormal":      # quotients near 5 * 2^-1074: ties on the subnormal grid
        y, sigma = np.zeros(160), np.ones(160)
        sig = 2.0 ** 1000
        d_small, d_large = 15.6 * 2.0 ** -74, 28.8 * 2.0 ** -74   # 5.2 and 4.8 x 2^-1074
        d_4 = 10.2 * 2.0 ** -74                                      # 5.1 x 2^-1074
        for t, sign in ((70, 1.0), (150, -1.0)):   # up, then down
            _tie(y, sigma, t, sig, d_small, d_large, sign, d_4)
        return y, sigma, 64
    if name == "tie_normal":         # two adjacent numerators over one denominator round equal
        y, sigma = np.zeros(160), np.ones(160)
        for t, sign in ((70, 1.0), (150, -1.0)):
            sig = 1.7 / 3.0 * (1.0 + r.random() * 0.01)
            den = 3.0 * sig
            while True:
                a = 1.8 + 0.2 * r.random()
                lo = np.nextafter(a, 0.0)
                if a / den == lo / den:
                    break
            _tie(y, sigma, t, sig, a, 2.0 * lo, sign)
        return y, sigma, 64
    if name == "flat":               # a tick grid with flat runs: ties at 0, sigma 0
        steps = r.choice([-1, 0, 0, 0, 1], 300).astype(np.float64)
        steps[100:190] = 0.0
        y = np.log(100.0 + 0.5 * np.cumsum(steps))
        return y, _walk_sigma(y, 60), 60
    if name == "nonfinite":          # NaN, +inf and -inf among the prices; sigma finite
        y = np.log(100.0) + np.cumsum(r.normal(0.0, 1e-3, 260))
        sigma = np.full(260, 1e-3)
        y[60], y[120], y[180] = np.nan, np.inf, -np.inf
        return y, sigma, 50
    if name == "subnormal":          # dyn on the subnormal grid; quotients at and near 0
        y = r.integers(-5, 6, 200) * 5e-324
        sigma = np.where(np.arange(200) % 3 == 0, 1e-10, 1.0)
        return y, sigma, 40
    if name == "sigma_edge":         # the first admissible lag mid-window, at the rounding edge
        y = np.log(100.0) + np.cumsum(r.normal(0.0, 1e-3, 200))
        k = r.integers(2, 60, 200)
        sigma = 1e-16 / np.sqrt(k.astype(np.float64))
        for j in range(200):
            for _ in range(int(r.integers(-3, 4)) % 7):
                sigma[j] = np.nextafter(sigma[j], np.inf if j % 2 else 0.0)
        return y, sigma, 60
    if name == "sigma_huge":         # finite huge, overflowing, infinite, NaN, zero and tiny sigma
        y = np.log(100.0) + np.cumsum(r.normal(0.0, 1e-3, 200))
        vals = np.array([1e300, 1e307, np.finfo(np.float64).max, np.inf, np.nan, 0.0, -0.0,
                         1e-300, 5e-324, 2.0 ** 1020])
        return y, vals[np.arange(200) % len(vals)], 50
    if name == "huge_dyn":           # quotients that overflow, products p that overflow
        y = r.choice([-1.0, 1.0], 120) * 10.0 ** r.uniform(290, 308, 120)
        sigma = np.where(np.arange(120) % 2 == 0, 1e-10, 1.0)
        return y, sigma, 40
    if name == "w3":                 # the smallest window: one lag
        y = np.log(100.0) + np.cumsum(r.normal(0.0, 1e-3, 100))
        return y, _walk_sigma(y, 3), 3
    raise KeyError(name)
