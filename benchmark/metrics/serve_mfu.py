"""The whole request path's share of the card's peaks: each request's
least time (the larger of n*I*d*2 operations over the f32 peak and its
inputs and outputs over the bandwidth, ``costs.request_least_s``)
summed over the traced window, over the window's time."""


def read(ctx):
    w = ctx["trace"]["window_s"]
    return None if w <= 0 else ctx["request_least_s"] / w * 100
