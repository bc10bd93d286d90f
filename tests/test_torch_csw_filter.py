"""Kernel W's filter (``csrc/csw.cu``), modelled in Python, against the plain
statistic ``_sup_stat_plain`` of ``finmlkit_tpu_torch``.

The model runs the kernel's scheme lane by lane for one warp a t: the first
admissible lag by the kernel's binary search, pass 1 (p = dyn * isq[k] and
each lane's largest and smallest p), the exact step at each lane's best lag
of a side and its quotient rounded down, L, T = pred(L), the lanes' upper
bounds U, and pass 2's lag test, with the
directed roundings computed exactly (``fractions.Fraction``, rounded down or
up through ``math.nextafter``); the exact quotients are Python's float
division, which rounds to nearest as ``__ddiv_rn`` does. On the adversarial
series of ``testing.csw_filter_case`` (ties of distinct quotients on the
subnormal grid and in the normal range at the lags 9 and 36, whose
denominators are exactly 2x apart; flat runs; NaN, +inf and -inf prices;
subnormal differences; sigma at the 1e-16 edge and huge, infinite, NaN and
zero; quotients and products that overflow; w = 3; every t < w) the model
never drops a lag that wins or ties, and its outputs equal the plain
version's bit for bit. Without the one-ulp step from L to T (a mutation) a
lag that ties would be dropped: the model then fails on the subnormal ties.
"""
import math
import sys
from fractions import Fraction

import numpy as np
import pytest
import torch

from finmlkit_tpu_torch.feature.kernels import structural_break as sb
from finmlkit_tpu_torch.testing import CSW_FILTER_CASES, assert_exact, csw_filter_case

DBL_MAX = sys.float_info.max
INF = math.inf


def _round(x: Fraction, down: bool) -> float:
    """x rounded down (or up) to a double."""
    try:
        f = float(x)                 # to nearest
    except OverflowError:
        return (DBL_MAX if down else INF) if x > 0 else (-INF if down else -DBL_MAX)
    if down and Fraction(f) > x:
        f = math.nextafter(f, -INF)
    elif not down and Fraction(f) < x:
        f = math.nextafter(f, INF)
    return f


def _mul(a: float, b: float, down: bool) -> float:
    if not (math.isfinite(a) and math.isfinite(b)):
        return a * b                 # exact: an infinity, or NaN
    return _round(Fraction(a) * Fraction(b), down)


def _div(a: float, b: float, down: bool) -> float:
    if not (math.isfinite(a) and math.isfinite(b)):
        return a / b
    return _round(Fraction(a) / Fraction(b), down)


class _Best:
    def __init__(self):
        self.v, self.k, self.nan = -INF, -1, False

    def offer(self, v, k):
        if v != v:
            self.nan = True
        elif v > self.v or (v == self.v and k > self.k):
            self.v, self.k = v, k


def _first_admissible(sig, sqrt_k, kmax):
    """The kernel's search; the lag test is monotone in k, so it must find
    the first admissible lag that a scan finds."""
    adm = lambda k: sig * sqrt_k[k] > 1e-16   # noqa: E731
    scan = next((k for k in range(2, kmax + 1) if adm(k)), kmax + 1)
    if kmax < 2 or not adm(kmax):
        found = kmax + 1
    elif adm(2):
        found = 2
    else:
        lo, hi = 3, kmax
        while lo < hi:
            mid = lo + (hi - lo) // 2
            if adm(mid):
                hi = mid
            else:
                lo = mid + 1
        found = lo
    assert found == scan, (sig, kmax, found, scan)
    return found


def _model_t(y, sig, t, w, sqrt_k, isq, ulp_step):
    """Kernel W's scheme at one t. Returns the two sides' ``_Best`` (None: both
    (-1e-6, 0)) and the set of lags it dropped without a quotient."""
    kmax = min(t, w) - 1
    k0 = _first_admissible(sig, sqrt_k, kmax)
    if k0 > kmax:
        return None, set()
    yt, lags = y[t], range(k0, kmax + 1)
    bu, bd = _Best(), _Best()
    bad = not (sig * sqrt_k[kmax] <= DBL_MAX)
    pu, pd, ku, kd = [0.0] * 32, [0.0] * 32, [-1] * 32, [-1] * 32
    if not bad:                               # pass 1
        for k in lags:
            p = (yt - y[t - k]) * isq[k]
            bad |= not abs(p) <= DBL_MAX
            lane = (k - k0) % 32
            if p > pu[lane]:
                pu[lane], ku[lane] = p, k
            if p < pd[lane]:
                pd[lane], kd[lane] = p, k
    if bad:                                   # the exact path, in rounds of 32
        for base in range(k0, kmax + 1, 32):
            nan = False
            for k in range(base, min(base + 32, kmax + 1)):
                dyn = yt - y[t - k]
                s = abs(dyn) / (sig * sqrt_k[k])
                nan |= dyn != dyn
                bu.offer(s if (dyn > 0 or dyn != dyn) else 0.0, k)
                bd.offer(s if (dyn < 0 or dyn != dyn) else 0.0, k)
            if nan:
                return None, set()
        return (bu, bd), set()

    def low(k):                               # RD of k's exact quotient
        return _div(abs(yt - y[t - k]), sig * sqrt_k[k], down=True)
    lu = max((low(k) for k in ku if k >= 0), default=-INF)
    ld = max((low(k) for k in kd if k >= 0), default=-INF)
    tu = math.nextafter(lu, -INF) if ulp_step else lu
    td = math.nextafter(ld, -INF) if ulp_step else ld
    best, dropped = set(), set()  # each lane's best lags: the exact step now, offered above T
    for ks, b, th in ((ku, bu, tu), (kd, bd, td)):
        for k in ks:
            if k >= 0:
                s = abs(yt - y[t - k]) / (sig * sqrt_k[k])
                if s > th:
                    b.offer(s, k)
                else:
                    dropped.add(k)
                best.add(k)
    cc = _mul(_div(2.0 ** -100, sig, down=False), 1.0 + 2.0 ** -44, down=False)
    again = [(ku[i] >= 0 and not _mul(pu[i], cc, down=False) < tu)
             or (kd[i] >= 0 and not _mul(-pd[i], cc, down=False) < td) for i in range(32)]
    for k in lags:                            # pass 2
        if k in best:
            continue
        if not again[(k - k0) % 32]:
            dropped.add(k)
            continue
        dyn = yt - y[t - k]
        denom = sig * sqrt_k[k]
        th = tu if dyn > 0 else td
        if dyn != 0 and not abs(dyn) < _mul(th, denom, down=True):
            (bu if dyn > 0 else bd).offer(abs(dyn) / denom, k)
        else:
            dropped.add(k)
    bu.offer(0.0, kmax)
    bd.offer(0.0, kmax)
    return (bu, bd), dropped


def _winners(y, sig, t, w, sqrt_k, side):
    """The lags of one side whose rounded quotient is the side's largest, if
    that is above 0."""
    kmax = min(t, w) - 1
    s = {}
    for k in range(2, kmax + 1):
        denom = sig * sqrt_k[k]
        dyn = y[t] - y[t - k]
        if denom > 1e-16 and dyn * side > 0:
            s[k] = abs(dyn) / denom
    best = max(s.values(), default=0.0)
    return {k for k, v in s.items() if v == best} if best > 0 else set()


def _model(y, sigma, w, ulp_step=True):
    """Kernel W's outputs ``(up, down, cu, cd)`` by the model, and the
    (t, lag) pairs it dropped that win or tie."""
    sqrt_k, crit, isq = (x.numpy().tolist() for x in sb._all_tables(w, "cpu"))
    y, sigma = y.tolist(), sigma.tolist()
    out = np.empty((4, len(y)))
    lost = []
    for t in range(len(y)):
        sides, dropped = _model_t(y, sigma[t], t, w, sqrt_k, isq, ulp_step)
        for i, b in enumerate(sides if sides is not None else (_Best(), _Best())):
            has = not b.nan and math.isfinite(b.v) and b.v > -1e-6
            out[i, t] = b.v if has else -1e-6
            out[i + 2, t] = crit[b.k] if has and b.k > 0 else 0.0
        for side in (1, -1):
            lost += [(t, k) for k in _winners(y, sigma[t], t, w, sqrt_k, side) & dropped]
    return out, lost


def _plain(y, sigma, w):
    sqrt_k, crit = sb._tables(w, "cpu")
    return sb._sup_stat_plain(torch.from_numpy(y), torch.from_numpy(sigma), w, sqrt_k, crit)


@pytest.mark.parametrize("case", CSW_FILTER_CASES)
def test_filter_drops_no_winner(case):
    """Every lag whose rounded quotient wins or ties on its side reaches the
    exact quotient."""
    _, lost = _model(*csw_filter_case(case))
    assert not lost, f"{case}: dropped winning or tying lags (t, k) {lost[:5]}"


@pytest.mark.parametrize("case", CSW_FILTER_CASES)
def test_model_matches_plain(case):
    """The model's up, down and critical values equal the plain version's bit
    for bit."""
    y, sigma, w = csw_filter_case(case)
    got, _ = _model(y, sigma, w)
    for i, want in enumerate(_plain(y, sigma, w)):
        assert_exact(got[i], want, f"{case} output {i}")


def test_ties_are_met():
    """The tie series hold what they are named for: at t = 70 (up) and 150
    (down), the lags 9 and 36 have distinct exact quotients that round to the
    same double, the larger lag the smaller quotient, and the plain version
    picks lag 36."""
    for case in ("tie_subnormal", "tie_normal"):
        y, sigma, w = csw_filter_case(case)
        crit = sb._tables(w, "cpu")[1]
        out = _plain(y, sigma, w)
        for t, side in ((70, 0), (150, 1)):
            d9, d36 = abs(y[t] - y[t - 9]), abs(y[t] - y[t - 36])
            q9 = Fraction(d9) / Fraction(sigma[t] * 3.0)
            q36 = Fraction(d36) / Fraction(sigma[t] * 6.0)
            assert q9 > q36 and float(q9) == float(q36), (case, t)
            assert float(out[side + 2][t]) == float(crit[36]), (case, t)


def test_without_the_ulp_step_fails():
    """The mutation T = L (no step to pred(L)) drops the tying lag 36 on the
    subnormal grid, where L = RD(q_9) is the rounded maximum itself and lag 36
    is not its lane's best lag (lag 4 is): the model's output then differs
    from the plain version's."""
    failed = []
    for case in CSW_FILTER_CASES:
        y, sigma, w = csw_filter_case(case)
        got, lost = _model(y, sigma, w, ulp_step=False)
        want = np.stack([x.numpy() for x in _plain(y, sigma, w)])
        if lost or not np.array_equal(got, want):
            failed.append(case)
    assert "tie_subnormal" in failed, failed


@pytest.mark.parametrize("w", [3, 64, 1000, 5000])
def test_isq_table_within_its_bound(w):
    """isq[k] = 2^100 / sqrt_k[k] within 2^-46 of its exact value (the slack
    that U's factor 1 + 2^-44 covers), for every k >= 1."""
    sqrt_k, _, isq = sb._all_tables(w, "cpu")
    for s, q in zip(sqrt_k.tolist()[1:], isq.tolist()[1:]):
        exact = Fraction(2) ** 100 / Fraction(s)
        assert abs(Fraction(q) - exact) <= exact * Fraction(1, 2 ** 46), (w, s, q)


def test_tables_are_cached():
    """A second call with the same window and device copies nothing: the same
    tensors come back, with the filter table kept beside them."""
    a, b = sb._tables(777, "cpu"), sb._tables(777, torch.device("cpu"))
    assert a[0] is b[0] and a[1] is b[1]
    tables = sb._all_tables(777, "cpu")
    assert tables[0] is a[0] and tables[1] is a[1]
    assert torch.equal(tables[2][1:], torch.ldexp(1.0 / a[0][1:], torch.tensor(100)))
