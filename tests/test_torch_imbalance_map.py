"""Kernel E's map path for imbalance bars at a fixed threshold on integer
weights, modelled on the CPU (``ops/event_scan.py _map_scan_model``): the
tiles' maps of the in-bar states, their two-level exclusive scan and the walk
of each tile from its entry state, against the plain scan close for close at
tiles of 1 to 1000 trades, and against the JAX package on XLA:CPU. Also the
path's dispatch (``_map_states``), the reference's closes on non-finite
weights, which the kernel's close test (``stat >= theta``) follows, and the
CUSUM bars on a NaN or zero price (fault R10 pinned).

With integer weights every in-bar sum before a close is exact, so the closes
of every layout must equal the plain scan's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finmlkit_tpu.bar import indexers as jidx
from finmlkit_tpu_torch.bar import indexers
from finmlkit_tpu_torch.ops import event_scan as es
from finmlkit_tpu_torch.testing import assert_exact, cusum_recurrence
from tests.conftest import generate_trades

# (n, theta, weights): trade 0 only opens, so every case starts at trade 1
CASES = {
    "sides_theta30": (20_000, 30.0, "sides"),
    "theta_30_5": (6_000, 30.5, "sides"),   # K = 30
    "theta_1": (3_000, 1.0, "ints"),        # K = 0: every nonzero weight closes
    "theta_0_5": (3_000, 0.5, "ints"),
    "zeros": (6_000, 9.0, "zeros"),         # 40% of the weights 0
    "big": (6_000, 12.0, "big"),            # |w| up to 2^60, clamped
    "short": (300, 6.0, "ints"),            # below one tile of 1000
    "states_cap": (8_000, 63.5, "ints"),    # 127 states, the most
}
TILES = (1, 7, 64, 1000)
_PLAIN = {}


def _weights(kind, n, seed=4):
    rng = np.random.default_rng(seed)
    if kind == "sides":
        return np.where(rng.random(n) < 0.5, 1.0, -1.0)
    w = rng.integers(-3, 4, n).astype(np.float64)
    if kind == "zeros":
        w[rng.random(n) < 0.4] = 0.0
    if kind == "big":
        w[::97] = 2.0 ** 60
        w[::89] = -1e15
    return w


def _plain(case, max_bars):
    key = (case, max_bars)
    if key not in _PLAIN:
        n, theta, kind = CASES[case]
        w = torch.from_numpy(_weights(kind, n))
        _PLAIN[key] = es.info_scan_plain(w, 1.0, theta, 0.0, 0.0, max_bars, False)
    return _PLAIN[key]


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("case", list(CASES))
def test_map_model_matches_plain(case, tile):
    n, theta, kind = CASES[case]
    w = torch.from_numpy(_weights(kind, n))
    want = _plain(case, n)
    got, stats = es._map_scan_model(n, 1, n, tile, x=w, e_t=1.0, e_r=theta, group=3)
    assert_exact(got, want, f"{case} tile={tile}")
    assert len(want) >= 3
    assert stats["states"] == 2 * es._map_k(1.0, theta) + 1
    assert stats["tiles"] == -(-(n - 1) // tile)
    assert stats["groups"] == -(-stats["tiles"] // 3)


@pytest.mark.parametrize("case", list(CASES))
def test_map_model_max_bars(case):
    n, theta, kind = CASES[case]
    w = torch.from_numpy(_weights(kind, n))
    got, _ = es._map_scan_model(n, 1, 2, 64, x=w, e_t=1.0, e_r=theta)
    assert_exact(got, _plain(case, 2), case)
    assert_exact(got, _plain(case, n)[:2], case)


@pytest.fixture(scope="module")
def trades():
    return generate_trades(n=6000, seed=11)


@pytest.mark.parametrize("theta", [17.0, 30.5])
def test_map_model_matches_jax(trades, theta):
    """Tick imbalance: the map path's closes are the JAX indexer's."""
    ts, _, _, side = trades
    _, want = jidx.imbalance_bar_indexer(jnp.asarray(ts), jnp.asarray(side),
                                         threshold=theta)
    n = len(side)
    got, _ = es._map_scan_model(n, 1, n, 128, x=torch.from_numpy(side.astype(np.float64)),
                                e_t=1.0, e_r=theta, group=4)
    assert_exact(got, np.asarray(want)[1:], f"theta={theta}")
    assert len(got) > 5


def _w(values):
    return torch.tensor(values, dtype=torch.float64)


# (weights, e_t, e_r, alpha_t, alpha_r, integral, K or None)
DISPATCH = {
    "tick_known": (_w([1, -1, 1]), 1.0, 30.0, 0.0, 0.0, True, 29),
    "integers_read": (_w([3, -2, 0, 7]), 1.0, 30.0, 0.0, 0.0, False, 29),
    "float_weights": (_w([1.5, -1, 1]), 1.0, 30.0, 0.0, 0.0, False, None),
    "nan_weight": (_w([1, float("nan")]), 1.0, 30.0, 0.0, 0.0, False, None),
    "inf_weight": (_w([1, float("inf")]), 1.0, 30.0, 0.0, 0.0, False, None),
    "large_integers_read": (_w([1e15, -3]), 1.0, 30.0, 0.0, 0.0, False, 29),
    "alpha_ticks": (_w([1, -1]), 1000.0, 0.03, 0.05, 0.0, True, None),
    "alpha_rate": (_w([1, -1]), 1.0, 30.0, 0.0, 0.05, True, None),
    "theta_at_cap": (_w([1, -1]), 1.0, 64.0, 0.0, 0.0, True, 63),
    "theta_above_cap": (_w([1, -1]), 1.0, 64.5, 0.0, 0.0, True, None),
    "theta_fraction": (_w([1, -1]), 2.0, 0.25, 0.0, 0.0, True, 0),
    "theta_zero": (_w([1, -1]), 1.0, 0.0, 0.0, 0.0, True, None),
    "theta_inf": (_w([1, -1]), 1.0, float("inf"), 0.0, 0.0, True, None),
    "theta_nan": (_w([1, -1]), 1.0, float("nan"), 0.0, 0.0, True, None),
}


@pytest.mark.parametrize("case", list(DISPATCH))
def test_map_states(case):
    """The map path takes fixed thresholds of at most 127 states on finite
    integer weights; every other input takes the walk."""
    w, e_t, e_r, a_t, a_r, integral, want = DISPATCH[case]
    assert es._map_states(w, e_t, e_r, a_t, a_r, integral) == want


@pytest.mark.parametrize("weighted", [False, True], ids=["tick", "volume"])
def test_indexer_tells_the_scan_what_it_knows(weighted, monkeypatch):
    """Tick imbalance tells kernel E's entry that its int8 sides are integers,
    known without a read; weighted imbalance leaves the scan to check. Any
    other scan, such as the plain one, is called without the keyword."""
    seen = []

    def scan(w, *args, **kw):
        seen.append(kw.get("integral", False))
        return es.info_scan_plain(w, *args)

    monkeypatch.setattr(indexers, "info_scan", scan)
    n = 500
    side = torch.from_numpy(np.where(np.random.default_rng(2).random(n) < 0.5, 1, -1)
                            .astype(np.int8))
    weights = torch.ones(n) if weighted else None
    _, ci = indexers.imbalance_bar_indexer(torch.arange(n), side, weights, threshold=5.0,
                                           scan=scan)
    assert seen and set(seen) == {not weighted}
    _, plain = indexers.imbalance_bar_indexer(torch.arange(n), side, weights,
                                              threshold=5.0, scan=es.info_scan_plain)
    assert_exact(ci, plain)
    assert len(ci) > 5


@pytest.mark.parametrize("run_mode", [False, True], ids=["imbalance", "run"])
@pytest.mark.parametrize("bad", ["nan", "inf", "-inf"])
def test_nonfinite_weight_matches_jax(trades, bad, run_mode):
    """Volume weights with a NaN or infinite weight at trade 1000: the JAX
    indexer, the port's plain path and kernel E's chunked walk (modelled)
    give the same closes. An imbalance sum that is NaN never closes; an
    infinite weight closes and, at alpha 0, makes theta NaN, so no bar
    closes after it; a run bar's NaN weight adds to neither side."""
    ts, _, amt, side = (a[:3000] for a in trades)
    w = amt.astype(np.float64)
    w[1000] = float(bad)
    jf = jidx.run_bar_indexer if run_mode else jidx.imbalance_bar_indexer
    pf = indexers.run_bar_indexer if run_mode else indexers.imbalance_bar_indexer
    _, want = jf(jnp.asarray(ts), jnp.asarray(side), jnp.asarray(w), threshold=1.5)
    _, got = pf(torch.from_numpy(ts), torch.from_numpy(side), torch.from_numpy(w),
                threshold=1.5)
    want = np.asarray(want)
    assert_exact(got, want, "plain path")
    signed = torch.from_numpy(side.astype(np.float64) * w)
    model, _ = es._chunked_scan_model(es._RUN if run_mode else es._IMBALANCE, len(w), 1,
                                      len(w), 3, x=signed, e_t=1.0, e_r=1.5)
    assert_exact(model, want[1:], "kernel E's chunked walk")
    stops = bad != "nan" or not run_mode
    assert len(want) > 5 and (want[-1] <= 1000) == stops
    if bad != "nan":
        assert want[-1] == 1000


def _cusum_bad_price(trades, bad):
    """(ts, prices, sigma) of the trades with a NaN or zero price at trade
    1000: two NaN log returns, or -inf then +inf."""
    ts, px, _, _ = trades
    px = px.copy()
    px[1000] = np.nan if bad == "nan" else 0.0
    return ts, px, np.full(len(px), 2e-4)


def _cusum_recurrence_closes(ts, px, sigma):
    """The closes of the reference's exact host loop (``testing.
    cusum_recurrence``) on the port's scan inputs, and the host tier's own
    (``cusum_bar_indexer_host``) where its library builds, else None."""
    rets, lam, cc, fv, _ = indexers.cusum_scan_inputs(
        torch.from_numpy(ts), torch.from_numpy(px), torch.from_numpy(sigma), 1e-9, 3.0)
    host = jidx.cusum_bar_indexer_host(ts, px, sigma, 1e-9, 3.0)
    return (np.concatenate([[fv], cusum_recurrence(rets, lam, cc, fv)]),
            None if host is None else host[1])


@pytest.mark.parametrize("bad", ["nan", "zero"])
def test_cusum_nonfinite_return_matches_jax(trades, bad):
    """A NaN or zero price (a NaN or infinite log return) in the CUSUM bars.
    A NaN: both of the reference's tiers carry it and close no bar after it,
    so the JAX indexer is the oracle. A zero price: the tiers disagree (R10),
    and the port follows the exact host loop's IEEE recurrence, closing at
    the infinite returns and after them; the oracle is that recurrence (and
    the host tier itself where it builds)."""
    ts, px, sigma = _cusum_bad_price(trades, bad)
    _, got, _ = indexers.cusum_bar_indexer(torch.from_numpy(ts), torch.from_numpy(px),
                                           torch.from_numpy(sigma), 1e-9, 3.0)
    want, host = _cusum_recurrence_closes(ts, px, sigma)
    if host is not None:
        assert_exact(want, host, f"{bad}: the recurrence against the host tier")
    if bad == "nan":
        _, jax_ci, _ = jidx.cusum_bar_indexer(jnp.asarray(ts), jnp.asarray(px),
                                              jnp.asarray(sigma), 1e-9, 3.0)
        assert_exact(want, np.asarray(jax_ci), "nan: the recurrence against JAX")
        want = np.asarray(jax_ci)
    assert_exact(got, want, bad)
    if bad == "nan":
        assert len(want) > 50 and want[-1] < 1000
    else:
        assert len(want) > 100 and want[-1] > 5000 and 1000 in want


def test_cusum_jax_device_form_stops_after_infinite_return(trades):
    """R10 pinned: on a zero price the JAX package's device form
    (``finmlkit_tpu/bar/indexers.py:509-597``) cancels inf - inf in its
    chunk prefix and closes no bar after trade 1000, where the package's own
    host tier and the port close on."""
    ts, px, sigma = _cusum_bad_price(trades, "zero")
    _, jax_ci, _ = jidx.cusum_bar_indexer(jnp.asarray(ts), jnp.asarray(px),
                                          jnp.asarray(sigma), 1e-9, 3.0)
    jax_ci = np.asarray(jax_ci)
    want, _ = _cusum_recurrence_closes(ts, px, sigma)
    assert jax_ci[-1] <= 1000 and want[-1] > 5000
    k = int(np.searchsorted(want, 1000))
    assert_exact(jax_ci[:k], want[:k], "the closes before the zero price")
