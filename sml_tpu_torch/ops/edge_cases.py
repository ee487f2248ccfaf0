"""Edge-case inputs of the eval kernels, written into a batch in place.

``chip_smoke.py``'s K2, P2 and P3 phases and ``scripts/sanitize.py``'s
targets take the same rows: masks with no bit, every item, one 16-byte
chunk, the last chunk, half the catalog; ids outside both tables.
"""

from __future__ import annotations

import torch

from sml_tpu_torch.ops.eval_kernel import build_packed_mask


def k2_edge_rows(masks: torch.Tensor, n_items: int) -> None:
    """Rows 0-4 of a batch of packed masks, in place: no bit set; every
    item below ``n_items`` (the 512-id warp list fills ~40 times over at
    the Yelp item count); all 128 bits of one 16-byte chunk; the items of
    the last chunk; every other item (half the catalog)."""
    dev = masks.device
    full = build_packed_mask(torch.arange(n_items, device=dev)[None],
                             n_items)[0]
    half = build_packed_mask(torch.arange(0, n_items, 2, device=dev)[None],
                             n_items)[0]
    masks[0] = 0
    masks[1] = full
    masks[2] = 0
    masks[2, 40:44] = -1
    masks[3] = 0
    masks[3, -4:] = full[-4:]
    masks[4] = half


def p2_out_of_range(g: torch.Generator, users: torch.Tensor,
                    cand: torch.Tensor, n_users: int, n_items: int) -> None:
    """Ids outside both tables, in place: candidate ids -1, -I, I, I+5,
    -I-1 and +-2^40 in 4,096 slots drawn from the CPU generator ``g``,
    user ids -1, -U, U, U+7, -U-1 and +-2^40 on every third row."""
    dev = cand.device
    bad_c = torch.tensor([-1, -n_items, n_items, n_items + 5, -n_items - 1,
                          2 ** 40, -2 ** 40], device=dev)
    bad_u = torch.tensor([-1, -n_users, n_users, n_users + 7, -n_users - 1,
                          2 ** 40, -2 ** 40], device=dev)
    at = torch.randint(0, cand.numel(), (4096,), generator=g).to(dev)
    n_at = cand.shape[1]
    cand[at // n_at, at % n_at] = bad_c[torch.arange(4096, device=dev)
                                        % len(bad_c)]
    users[::3] = bad_u[torch.arange(len(users[::3]), device=dev)
                       % len(bad_u)]


def p3_edge_rows(maskm: torch.Tensor, tgt: torch.Tensor, n_items: int,
                 ipad: int) -> None:
    """Rows 0-3 of int8 masks and their targets, in place: no entry set;
    every item below ``n_items``, the target among them; the 16 entries of
    one 16-byte chunk, the target among them; the last chunk (pad items,
    whose table rows are zero)."""
    maskm[0] = 0
    maskm[1] = 0
    maskm[1, :n_items] = 1
    maskm[2] = 0
    maskm[2, 8192:8208] = 1
    tgt[2] = 8200
    maskm[3] = 0
    maskm[3, ipad - 16:] = 1
