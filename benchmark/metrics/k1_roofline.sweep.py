"""K1 (``transfer_rows_kernel``, ``models/transfer.py``'s refresh) as a
share of its least time: every refresh of the traced window over both
tables (``costs.k1_flops``, ``costs.k1_bytes``) against the device time
of the kernels of that name."""

import costs
import harness

KERNELS = ("transfer_rows_kernel",)


def read(ctx):
    t = harness.ops_matching(ctx["trace"], KERNELS)
    if t <= 0:
        return None
    c = ctx["config"]
    rows = c["n_users"] + c["n_items"]
    args = (rows, c["latent_dim"], c["conv1_channels"], c["conv2_channels"],
            c["fc_hidden"])
    least = costs.least_s(costs.k1_flops(*args),
                          costs.k1_bytes(*args, c["snapshot_dtype"]))
    return ctx["refreshes"] * least / t * 100
