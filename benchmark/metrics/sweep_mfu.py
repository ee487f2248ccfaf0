"""The whole sweep's share of the card's peaks: the least time of the
traced window's periods (K1, K3, the MF and Θ steps and the tests,
``costs.sweep_period_least_s``: each the larger of its operations over
the f32 peak and its bytes over the bandwidth) over the window's time.
The work is bound by bytes in K3 and by operations in K1."""


def read(ctx):
    w = ctx["trace"]["window_s"]
    return None if w <= 0 or ctx["least_s"] <= 0 else ctx["least_s"] / w * 100
