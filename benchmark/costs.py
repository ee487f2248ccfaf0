"""Operations and bytes of the work the benchmark's cells drive, and the
peaks of the card they are held to.

The peaks are those of one NVIDIA H100 SXM (the data sheet's dense rates):
67 TFLOP/s in f32 outside the tensor cores (the port runs its f32 products
with TF32 off), 989 TFLOP/s in bf16 and 3.35 TB/s of HBM3. A least time is
the larger of the operations over the operations peak and the bytes over
the bandwidth; every input byte is counted read once and every output byte
written once, whatever a kernel reads again, so a share of it cannot pass
100% unless the time leaves work out.

Everything here is arithmetic on shapes: it runs on any host.
"""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

F32 = 4
BF16 = 2
INT32 = 4

SNAPSHOT_BYTES = {"float32": F32, "bfloat16": BF16}


def least_s(flops: float, nbytes: float,
            peak_flops: float = PEAK_F32_FLOPS) -> float:
    """The least time of ``flops`` operations moving ``nbytes`` bytes."""
    return max(flops / peak_flops, nbytes / PEAK_HBM_BYTES)


# ------------------------------------------------------------- the model
def tower_flops(d: int, c1: int, c2: int, h: int) -> int:
    """Operations of one ``conv_com`` tower on one row: the multiply-adds
    of the two channel mixes (3 -> C1 -> C2 over d) and the two FCs
    (C2*d -> H -> d), two operations each."""
    return 2 * (3 * c1 + c1 * c2) * d + 2 * (c2 * d * h + h * d)


def theta_params(d: int, c1: int, c2: int, h: int) -> int:
    """Parameters of both ``conv_com`` towers."""
    one = (c1 * 3 + c1) + (c2 * c1 + c2) + (c2 * d * h + h) + (h * d + d)
    return 2 * one


def k1_flops(rows: int, d: int, c1: int, c2: int, h: int) -> int:
    """K1 (``transfer_rows_kernel``) over ``rows`` table rows."""
    return rows * tower_flops(d, c1, c2, h)


def k1_bytes(rows: int, d: int, c1: int, c2: int, h: int,
             snapshot: str) -> int:
    """K1 reads each row's two snapshots and Θ's tower once and writes the
    f32 row."""
    return (rows * d * (2 * SNAPSHOT_BYTES[snapshot] + F32)
            + theta_params(d, c1, c2, h) // 2 * F32)


def k3_elements(n_users: int, n_items: int, d: int) -> int:
    """Elements K3 (``decay_adam_kernel``) decays in one launch: both
    tables and both bias columns."""
    return (n_users + n_items) * (d + 1)


def k3_bytes(elements: int) -> int:
    """Each decayed leaf's p, mu and nu (f32) read once and written once."""
    return elements * 3 * F32 * 2


def k3_flops(elements: int) -> int:
    """The decay's arithmetic: two moment updates, the corrected step and
    the parameter update, about eight operations an element."""
    return 8 * elements


# ------------------------------------------------------------- the sweep
def sweep_counts(cfg: dict, set_t_rows: int, set_tt_rows: int,
                 n_pad_t: int, n_pad_tt: int) -> dict:
    """Per period of the SML driver: optimizer steps, refreshes and the
    examples the window counts (every inner row times ``mf_epochs`` and
    outer row times ``tr_epochs``, times ``multi_num``)."""
    multi = cfg["multi_num"]
    mb, tb = cfg["mf_batch_size"], cfg["tr_batch_size"]
    inner = -(-set_t_rows // mb)
    outer = -(-set_tt_rows // tb)
    return {
        "inner_steps": multi * cfg["mf_epochs"] * inner,
        "outer_steps": multi * cfg["tr_epochs"] * outer,
        # a refresh after each phase's inner epochs and after each outer
        # epoch, and the period's final one
        "refreshes": multi * (1 + cfg["tr_epochs"]) + 1,
        "examples": multi * (cfg["mf_epochs"] * set_t_rows
                             + cfg["tr_epochs"] * set_tt_rows),
        "inner_slots": n_pad_t // mb, "outer_slots": n_pad_tt // tb,
    }


def inner_step_flops(cfg: dict) -> int:
    """One MF step through the frozen Θ: the towers forward on the user,
    positive and negative rows (3B) and back to those rows only (about the
    forward again)."""
    return 2 * 3 * cfg["mf_batch_size"] * tower_flops(
        cfg["latent_dim"], cfg["conv1_channels"], cfg["conv2_channels"],
        cfg["fc_hidden"])


def outer_step_flops(cfg: dict) -> int:
    """One Θ step: the towers forward on 3B snapshot rows, and backward
    to Θ's weights and between its layers (about twice the forward)."""
    return 3 * 3 * cfg["tr_batch_size"] * tower_flops(
        cfg["latent_dim"], cfg["conv1_channels"], cfg["conv2_channels"],
        cfg["fc_hidden"])


def outer_step_bytes(cfg: dict) -> int:
    """Θ's Adam step: each parameter, its gradient and two moments read,
    and the parameter and moments written."""
    return 7 * F32 * theta_params(cfg["latent_dim"], cfg["conv1_channels"],
                                  cfg["conv2_channels"], cfg["fc_hidden"])


def test_flops(rows: int, candidates: int, d: int) -> int:
    """A leave-one-out test: each row's candidates scored by a d-wide dot."""
    return 2 * rows * candidates * d


def test_bytes(rows: int, candidates: int, d: int, n_items: int) -> int:
    """The test's rows, their users' rows and the item rows they name
    (at most the whole item table), each read once."""
    return (rows * candidates * INT32 + rows * d * F32
            + min(n_items, rows * candidates) * d * F32)


def sweep_period_least_s(cfg: dict, counts: dict, test_rows: int,
                         candidates: int) -> float:
    """The least time of one period's counted work: K1 over both tables at
    every refresh, K3 at every inner step, the MF and Θ steps, and the
    test."""
    d, c1, c2, h = (cfg["latent_dim"], cfg["conv1_channels"],
                    cfg["conv2_channels"], cfg["fc_hidden"])
    rows = cfg["n_users"] + cfg["n_items"]
    k1 = least_s(k1_flops(rows, d, c1, c2, h),
                 k1_bytes(rows, d, c1, c2, h, cfg["snapshot_dtype"]))
    el = k3_elements(cfg["n_users"], cfg["n_items"], d)
    k3 = least_s(k3_flops(el), k3_bytes(el))
    inner = least_s(inner_step_flops(cfg), 0)
    outer = least_s(outer_step_flops(cfg), outer_step_bytes(cfg))
    test = least_s(test_flops(test_rows, candidates, d),
                   test_bytes(test_rows, candidates, d, cfg["n_items"]))
    return (counts["refreshes"] * k1 + counts["inner_steps"] * (k3 + inner)
            + counts["outer_steps"] * outer + test)


# ------------------------------------------------------------- serving
def score_flops(users: int, n_items: int, d: int) -> int:
    """The scoring GEMM of a request: ``(n, d) x (d, I)``."""
    return 2 * users * n_items * d


def score_bytes(users: int, n_items: int, d: int) -> int:
    """The GEMM's inputs (the users' rows, the item table) and its output
    (the n x I scores)."""
    return (users + n_items) * d * F32 + users * n_items * F32


def request_least_s(users: int, n_items: int, d: int, k: int) -> float:
    """A top-K request's least time: its operations against its inputs
    (the users' rows and the item table) and outputs (k ids and scores a
    user)."""
    return least_s(score_flops(users, n_items, d),
                   (users + n_items) * d * F32 + users * k * (F32 + 8))
