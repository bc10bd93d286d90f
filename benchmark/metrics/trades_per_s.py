"""The month's trades times the passes completed in the window, over the
window's seconds (host clock): all the work and all the time."""


def read(run):
    return run.n_trades * run.passes / run.window_s
