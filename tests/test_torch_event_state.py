"""Entry and exit states of kernel E's scans on the CPU.

The plain scans (``ops/event_scan.py *_scan_plain``) from an entry state are
held to the JAX scans with the same seed state (``_volume_boundaries``
``base_init``/``pos_init``, ``_cusum_boundaries`` ``sp_init``/``sn_init``,
``_info_bar_boundaries`` ``state_init``), closes and exit states, on finite
data (dyadic CUSUM returns: the JAX scan and the plain one take their prefix
sums in other orders, which may round the exit state otherwise); the CPU
models of the kernel (``_chunked_scan_model``,
``_map_scan_model``) to the plain scans from the same states; and a stream
scanned in two parts, the second from the first's exit state, to one scan of
the whole, at a tile edge, a chunk edge, a close and elsewhere (data whose
sums are exact, so the cut cannot move a rounding).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from finmlkit_tpu.bar import indexers as jidx  # noqa: E402
from finmlkit_tpu_torch.ops import event_scan as es  # noqa: E402
from finmlkit_tpu_torch.testing import same_state  # noqa: E402

N = 20_000
MB = N


def _data(seed=5):
    g = np.random.default_rng(seed)
    units = g.integers(1, 200, N).astype(np.int64)
    rets = g.integers(-200, 201, N) * 2.0 ** -20   # dyadic: the prefix sums are exact
    lam = 2e-3 * (0.5 + g.random(N))
    cc = g.random(N) < 0.9
    w_imb = g.integers(-6, 11, N) / 8.0        # a drift: the bars keep closing
    w_run = g.integers(-8, 9, N) / 8.0
    return dict(units=units, rets=rets, lam=lam, cc=cc, w_imb=w_imb, w_run=w_run)


D = _data()
T = {k: torch.from_numpy(v) for k, v in D.items()}


# --- the plain scans from an entry state against the JAX scans ------------------

@pytest.mark.parametrize("carry", [0, 1, 2_499, 4_999, 12_345])
def test_volume_plain_matches_jax_from_state(carry):
    thr = 5_000
    got, end = es.volume_scan_plain(T["units"], thr, MB, state=carry, first_closes=True,
                                    exit_state=True)
    c = jnp.cumsum(jnp.asarray(D["units"]))
    out, k, base = jidx._volume_boundaries(c, float(thr), MB, base_init=-float(carry),
                                           pos_init=-1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(out)[:int(k)])
    assert end == int(c[-1]) - int(base)


@pytest.mark.parametrize("state", [(0.0, 0.0), (1.5e-3, -1e-4), (0.0, -2.9e-3),
                                   (4e-3, -4e-3)])
@pytest.mark.parametrize("start", [-1, 99])
def test_cusum_plain_matches_jax_from_state(state, start):
    got, end = es.cusum_scan_plain(T["rets"], T["lam"], T["cc"], start, MB, state=state,
                                   exit_state=True)
    out, k, sp, sn = jidx._cusum_boundaries(
        jnp.asarray(D["rets"]), jnp.asarray(D["lam"]), jnp.asarray(D["cc"]),
        jnp.int64(start), MB, jidx._CUSUM_CHUNK, sp_init=state[0], sn_init=state[1])
    np.testing.assert_array_equal(got.numpy(), np.asarray(out)[:int(k)])
    assert len(got) > 20
    assert same_state(end, (float(sp), float(sn)))


INFO_STATES = [(0.0, 0.0, 40.0, 0.25, 0), (9.5, 0.0, 40.0, 0.25, -17),
               (-3.25, 2.0, 30.0, 0.5, -1234), (0.0, 0.0, 80.0, 0.125, -1)]


@pytest.mark.parametrize("state", INFO_STATES)
@pytest.mark.parametrize("run_mode", [False, True], ids=["imbalance", "run"])
def test_info_plain_matches_jax_from_state(state, run_mode):
    w = D["w_run" if run_mode else "w_imb"]
    if not run_mode:
        state = (state[0], 0.0) + state[2:]   # cs: unused by imbalance bars
    args = (state[2], state[3], 0.05, 0.05)
    got, end = es.info_scan_plain(torch.from_numpy(w), *args, MB, run_mode, state=state,
                                  first_closes=True, exit_state=True)
    out, k, st = jidx._info_bar_boundaries(jnp.asarray(w), *args, MB, jidx._IMB_CHUNK,
                                           run_mode, state_init=state)
    np.testing.assert_array_equal(got.numpy(), np.asarray(out)[:int(k)])
    assert len(got) > 20
    # the in-bar sums and the open exactly; XLA contracts the EMA updates
    # into fused multiply-adds, so E[T] and E[rate] may round an ulp apart
    assert same_state(end[:2] + end[4:], (float(st[0]), float(st[1]), int(st[4])))
    np.testing.assert_allclose(end[2:4], [float(st[2]), float(st[3])], rtol=4e-16, atol=0)


# --- the CPU models of kernel E from an entry state -----------------------------

def _mode_case(mode, g):
    """(launch keywords, start, plain(entry, first) -> (closes, exit)) of a mode on
    exact data."""
    if mode == "volume":
        u = T["units"]
        return dict(units=u, thr=5000), (lambda st, first: es.volume_scan_plain(
            u, 5000, MB, state=st[0], first_closes=first, exit_state=True))
    if mode == "cusum":
        r = torch.from_numpy(g.integers(-64, 65, N) * 2.0 ** -20)
        lam = torch.full((N,), 2.0 ** -11, dtype=torch.float64)
        cc = T["cc"]
        return dict(x=r, lam=lam, can_close=cc), (lambda st, first: es.cusum_scan_plain(
            r, lam, cc, -1 if first else 0, MB, state=st, exit_state=True))
    run = mode == "run"
    w = T["w_run" if run else "w_imb"]
    kw = dict(x=w, e_t=40.0, e_r=0.75 if run else 0.25, alpha_t=0.05, alpha_r=0.05)
    return kw, (lambda st, first: es.info_scan_plain(
        w, kw["e_t"], kw["e_r"], 0.05, 0.05, MB, run, state=st, first_closes=first,
        exit_state=True))


MODES = {"cusum": es._CUSUM, "imbalance": es._IMBALANCE, "run": es._RUN,
         "volume": es._VOLUME}
ENTRIES = {"cusum": [(0.0, 0.0), (2.0 ** -12, -2.0 ** -13),
                     (float(np.nextafter(2.0 ** -11, 0)), 0.0)],
           "volume": [(0,), (4_999,), (77,)],
           "imbalance": [(0.0, 0.0, 40.0, 0.25, 0), (9.75, 0.0, 40.0, 0.25, -500)],
           "run": [(0.0, 0.0, 40.0, 0.75, 0), (29.5, 12.0, 40.0, 0.75, -3)]}
CASES = [(m, i) for m, es_ in ENTRIES.items() for i in range(len(es_))]


@pytest.mark.parametrize("chunks", [1, 3, 7])
@pytest.mark.parametrize("mode,entry", CASES)
def test_chunked_model_matches_plain_from_state(mode, entry, chunks):
    g = np.random.default_rng(9)
    kw, plain = _mode_case(mode, g)
    st = ENTRIES[mode][entry]
    want, want_end = plain(st, True)
    got, _, end = es._chunked_scan_model(MODES[mode], N, 0, MB, chunks, entry=st,
                                         exit_state=True, **kw)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert same_state(end, want_end)


@pytest.mark.parametrize("cb", [-29.0, -3.0, 0.0, 17.0, 29.0])
def test_map_model_matches_plain_from_state(cb):
    g = np.random.default_rng(4)
    w = torch.from_numpy(np.where(g.random(N) < 0.5, 1.0, -1.0))
    st = (cb, 0.0, 1.0, 30.0, -99)
    want, want_end = es.info_scan_plain(w, 1.0, 30.0, 0.0, 0.0, MB, False, state=st,
                                        first_closes=True, exit_state=True)
    got, _, end = es._map_scan_model(N, 0, MB, 512, x=w, e_t=1.0, e_r=30.0, entry=st,
                                     exit_state=True)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert same_state(end, want_end)
    assert es._map_states(w, 1.0, 30.0, 0.0, 0.0, True, cb) == 29
    assert es._map_states(w, 1.0, 30.0, 0.0, 0.0, True, 30.0) is None   # not a state


# --- split streams -----------------------------------------------------------------

def _split(mode, k, via):
    """Scan [0, N) whole and as [0, k) then [k, N) from the exit state, by the
    plain scan (``via="plain"``) or the chunked model; returns both."""
    kw, _ = _mode_case(mode, np.random.default_rng(9))
    info = mode in ("imbalance", "run")

    def scan(lo, hi, st, first):
        if via == "plain":
            sub = {key: (v[lo:hi] if torch.is_tensor(v) else v) for key, v in kw.items()}
            if mode == "volume":
                return es.volume_scan_plain(sub["units"], 5000, MB, state=st[0],
                                            first_closes=first, exit_state=True)
            if mode == "cusum":
                return es.cusum_scan_plain(sub["x"], sub["lam"], sub["can_close"],
                                           -1 if first else 0, MB, state=st,
                                           exit_state=True)
            return es.info_scan_plain(sub["x"], sub["e_t"], sub["e_r"], 0.05, 0.05, MB,
                                      mode == "run", state=st, first_closes=first,
                                      exit_state=True)
        sub = {key: (v[lo:hi] if torch.is_tensor(v) else v) for key, v in kw.items()}
        got, _, end = es._chunked_scan_model(MODES[mode], hi - lo, 0 if first else 1, MB, 3,
                                             entry=st,
                                             exit_state=True, **sub)
        return got, (end[0] if mode == "volume" else end)

    init = {"cusum": (0.0, 0.0), "volume": (0,)}.get(
        mode, (0.0, 0.0, kw.get("e_t"), kw.get("e_r"), 0))
    whole, w_end = scan(0, N, init, False)
    a, mid = scan(0, k, init, False)
    mid = mid if mode != "volume" else (mid,)
    if info:
        mid = mid[:4] + (mid[4] - k,)
    b, end = scan(k, N, mid, True)
    if info:
        end = end[:4] + (end[4] + k,)
    return (whole, w_end), (torch.cat([a, b + k]), end), len(whole)


def _cut(mode, where):
    if where == "close":
        (whole, _), _, _ = _split(mode, 5001, "plain")
        return int(whole[len(whole) // 2]) + 1
    return {"tile": 1 + 2048 * 3, "chunk": 1 + 2048 * 4, "mid": 9_999}[where]


@pytest.mark.parametrize("via", ["plain", "model"])
@pytest.mark.parametrize("where", ["tile", "chunk", "close", "mid"])
@pytest.mark.parametrize("mode", ["cusum", "imbalance", "run", "volume"])
def test_split_stream_equals_whole(mode, where, via):
    k = _cut(mode, where)
    (whole, w_end), (split, s_end), count = _split(mode, k, via)
    np.testing.assert_array_equal(split.numpy(), whole.numpy())
    assert same_state(s_end, w_end), (s_end, w_end)
    assert count > 20


@pytest.mark.parametrize("k", [1, 512, 2048 + 1, 7_777])
def test_map_split_stream_equals_whole(k):
    g = np.random.default_rng(8)
    w = torch.from_numpy(np.where(g.random(N) < 0.5, 1.0, -1.0))
    whole, _, w_end = es._map_scan_model(N, 1, MB, 512, x=w, e_t=1.0, e_r=30.0,
                                         exit_state=True)
    a, _, mid = es._map_scan_model(k, 1, MB, 512, x=w[:k], e_t=1.0, e_r=30.0,
                                   exit_state=True)
    b, _, end = es._map_scan_model(N - k, 0, MB, 512, x=w[k:], e_t=1.0, e_r=30.0,
                                   entry=mid[:4] + (mid[4] - k,), exit_state=True)
    np.testing.assert_array_equal(torch.cat([a, b + k]).numpy(), whole.numpy())
    assert same_state(end[:4] + (end[4] + k,), w_end)
