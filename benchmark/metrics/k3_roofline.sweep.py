"""K3 (``decay_adam_kernel``, ``train/optim.py``'s row-sparse table Adam)
as a share of its least time: each inner step decays both tables and
both bias columns, p, mu and nu read once and written once
(``costs.k3_bytes``), against the device time of the kernels of that
name."""

import costs
import harness

KERNELS = ("decay_adam_kernel",)


def read(ctx):
    t = harness.ops_matching(ctx["trace"], KERNELS)
    if t <= 0:
        return None
    c = ctx["config"]
    el = costs.k3_elements(c["n_users"], c["n_items"], c["latent_dim"])
    least = costs.least_s(costs.k3_flops(el), costs.k3_bytes(el))
    return ctx["inner_steps"] * least / t * 100
