"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips where there is no CUDA card, so on a
CPU-only host they count as skipped. On a GPU host run them without the
JAX conftest (this file imports no JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: K1 1e-4 (f32 sums over C2*d and H terms in another order),
at every width up to ``MAX_D``;
K2, every P1 instantiation and K2 against P1's ``<f32, 64, ij>`` exact on
integer-valued tables; P1 on N(0,1) tables at most
``K2_RANDOM_FLIPS_PER_16K`` rank flips per 16,384 rows (a negative within
rounding of the target's score; the sums run in another order); K3
bit-equal to its plain version (every operation explicitly rounded), ``p``
held to rtol 1e-6; P2 exact on integer tables and within 1e-4 on N(0,1)
ones (bf16 products are exact in f32, only the order of the sums differs),
on int64 strided and int32 ids, out-of-range ids and odd B and C;
P3 exact on integer tables; two and four ranks sharing the card over
gloo within 1e-4 of one rank; a captured SML phase replayed against the
same phases run call by call within 1e-5 (the same kernels on the same
inputs: bit equality expected), the generators at one position, eval hits
within 1; K3 reading each replay's bias corrections and K1 into ``out=``
bit-equal to their plain versions and fresh outputs. The edge-case rows:
no bit set, every item set, one 16-byte chunk of the mask, its last chunk
(K2, P3); no bit, one bit, one full 4096-item mask block, every item (P1).
P1 also at widths that are not multiples of 16 (zero-padded, exact).
The one-program run: steps under CUDA-graph IF nodes, taken and skipped,
bit-equal to the same steps run eagerly; eager epochs that skip the
Philox offsets of the slots they do not run, equal to replayed ones;
one capture a program for a sweep of periods of different row counts,
bit-equal to the unfused sweep; branch C's phase-0 epoch programs
bit-equal to the eager phase 0, while copies of Θ made with gradients on
are held across their captures (fault 15); a fused program replayed inside a trace after an
earlier trace, and after two (fault 8's reproducer). A fused phase
captured on a one-rank NCCL mesh, bit-equal to its calls on the same
mesh; SPMF's graphed epochs equal to its eager ones. Faults 9 and 10: a
program freed by the garbage collector inside another capture, and an IF
body stream that was the capture stream; the programs' memory when a
program is released right after its replay, when IF bodies reuse each
other's blocks and under pinned fills of queued replays. The programs
on the state's own buffers: a capture replayed after an eager phase that
refreshed the tables in them, and after a state handed in with new tables
(copied in); ``release_programs`` leaving the state readable. Two
simulated hosts (``run_world(hosts=2)``): the transport by the cards the
ranks hold (gloo for two hosts on one card, NCCL for a card each), and
an NCCL all-reduce and all-gather over the 'data' axis across the hosts
captured in one graph, bit-equal to eager (two cards or more).
"""

import json
import os

import numpy as np
import pytest
import torch

from sml_tpu_torch.config import SMLConfig, TransferConfig
from sml_tpu_torch.models.transfer import init_transfer
from sml_tpu_torch.ops import adam_kernel as AK
from sml_tpu_torch.ops import eval_kernel as E
from sml_tpu_torch.ops import probe_kernels as PK
from sml_tpu_torch.ops import transfer_kernel as TK
from sml_tpu_torch.scripts.program_stress import ragged_dataset

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# widths up to MAX_D (each of the kernel's row tiles: 64 rows to d=128, 32
# to 256, 16 to 512; odd and unaligned widths take scalar loads), C2 beyond
# what fits when all C2*d inputs sit in shared memory, H in several passes
# of 512; H % 4 != 0 (cp.async weight copies: 4-byte for fc1_w, 4- or
# 16-byte for fc2_w); 100: bulk-copied weight rows past d in the last
# column block
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,c2,h,n", [
    (16, 5, 512, 77), (64, 5, 512, 1000), (10, 5, 512, 300),
    (80, 5, 512, 1000), (128, 5, 512, 700), (256, 5, 512, 300),
    (512, 5, 512, 100), (64, 7, 512, 500), (64, 16, 1024, 300),
    (32, 5, 2048, 200), (33, 3, 102, 129), (48, 5, 98, 150),
    (100, 5, 1024, 200)])
def test_transfer_kernel_matches_plain(card, d, c2, h, n, dtype):
    th = init_transfer(torch.Generator().manual_seed(1),
                       TransferConfig(latent_dim=d, conv2_channels=c2,
                                      fc_hidden=h), device=card)
    g = torch.Generator().manual_seed(2)
    last = torch.randn(n, d, generator=g).to(card, dtype)
    hat = torch.randn(n, d, generator=g).to(card, dtype)
    last[:5] = 0
    before = TK.transfer_rows_cuda.launches
    got = TK.fused_table_transfer(th.user, last, hat)
    assert TK.transfer_rows_cuda.launches == before + 1
    want = TK.transfer_rows_plain(th.user, last, hat)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("d,c1,limit", [(TK.MAX_D + 1, 10, "MAX_D"),
                                        (64, TK.MAX_C1 + 1, "MAX_C1")])
def test_transfer_kernel_refuses_past_its_limits(card, d, c1, limit):
    th = init_transfer(torch.Generator().manual_seed(1),
                       TransferConfig(latent_dim=d, conv1_channels=c1,
                                      fc_hidden=64), device=card)
    rows = torch.ones(8, d, device=card)
    before = TK.transfer_rows_cuda.launches
    with pytest.raises(ValueError, match=limit):
        TK.fused_table_transfer(th.user, rows, rows)
    assert TK.transfer_rows_cuda.launches == before


def test_transfer_kernel_rejects_a_tower_off_the_card(card):
    th = init_transfer(torch.Generator().manual_seed(1),
                       TransferConfig(latent_dim=16), device="cpu")
    rows = torch.zeros(8, 16, device=card)
    before = TK.transfer_rows_cuda.launches
    with pytest.raises(ValueError, match="parameters"):
        TK.transfer_rows_cuda(th.user, rows, rows)
    assert TK.transfer_rows_cuda.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,n_items,d", [(37, 300, 16), (1024, 9000, 64)])
def test_masked_rank_kernel_exact_on_integer_tables(card, rows, n_items, d,
                                                    dtype):
    g = torch.Generator().manual_seed(3)
    ipad = E.pad_items(n_items)
    ue = torch.randint(-2, 3, (rows, d), generator=g).float()
    it = torch.zeros(ipad, d)
    it[:n_items] = torch.randint(-2, 3, (n_items, d), generator=g).float()
    ss = torch.randint(-5, 6, (rows, 1), generator=g).float()
    neg = torch.argsort(torch.rand(rows, n_items, generator=g), dim=1)[:, :99]
    mask = E.build_packed_mask(neg.to(card), n_items)
    assert torch.equal(mask.cpu(), E.build_packed_mask(neg, n_items))
    before = E.masked_rank_cuda.launches
    got = E.masked_rank(ue.to(card, dtype), it.to(card, dtype), ss.to(card),
                        mask)
    assert E.masked_rank_cuda.launches == before + 1
    want = E.masked_rank_plain(ue.to(dtype), it.to(dtype).T, ss, mask.cpu())
    assert torch.equal(got.cpu(), want)


def _edge_rows(mask, n_items):
    """Rows 0-3 of ``mask`` (packed words) become: no bit set, every item
    below ``n_items``, all 128 bits of one 16-byte chunk (4 words), and
    the items of the last chunk."""
    full = E.build_packed_mask(torch.arange(n_items)[None], n_items)
    mask[0] = 0
    mask[1] = full[0]
    mask[2] = 0
    mask[2, 8:12] = -1
    mask[3] = 0
    mask[3, -4:] = full[0, -4:]
    return mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 64, 10])     # 10: rows of 40 or 20 bytes
def test_masked_rank_kernel_edge_rows_exact(card, d, dtype):
    g = torch.Generator().manual_seed(10)
    rows, n_items = 1021, 9000                   # not a multiple of 8
    ipad = E.pad_items(n_items)
    ue = torch.randint(-2, 3, (rows, d), generator=g).float()
    it = torch.zeros(ipad, d)
    it[:n_items] = torch.randint(-2, 3, (n_items, d), generator=g).float()
    ss = torch.randint(-5, 6, (rows, 1), generator=g).float()
    neg = torch.argsort(torch.rand(rows, n_items, generator=g), dim=1)[:, :999]
    mask = _edge_rows(E.build_packed_mask(neg, n_items), n_items)
    want = E.masked_rank_plain(ue.to(dtype), it.to(dtype).T, ss, mask)
    assert want[0] == 0 and want[1] > 0
    got = E.masked_rank_cuda(ue.to(card, dtype), it.to(card, dtype),
                             ss.to(card), mask.to(card))
    assert torch.equal(got.cpu(), want)


def test_masked_rank_gather_equals_the_dense_template(card):
    g = torch.Generator().manual_seed(11)
    rows, n_items, d = 1000, 20000, 64
    ipad = E.pad_items(n_items)
    ue = torch.randint(-2, 3, (rows, d), generator=g).float().to(card)
    it = torch.zeros(ipad, d, device=card)
    it[:n_items] = torch.randint(-2, 3, (n_items, d), generator=g).float()
    ss = torch.randint(-6, 7, (rows, 1), generator=g).float().to(card)
    neg = torch.argsort(torch.rand(rows, n_items, generator=g), dim=1)[:, :999]
    mask = _edge_rows(E.build_packed_mask(neg.to(card), n_items), n_items)
    old = E.masked_rank_variant_cuda(ue, it.T.contiguous(), ss, mask, 64,
                                     "ij")
    assert torch.equal(E.masked_rank_cuda(ue, it, ss, mask), old)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows_per_block", E.VARIANT_ROWS_PER_BLOCK)
@pytest.mark.parametrize("order", E.VARIANT_ORDERS)
def test_masked_rank_variants_exact_on_integer_tables(card, order,
                                                      rows_per_block, dtype):
    g = torch.Generator().manual_seed(7)
    rows, n_items, d = 1021, 9000, 64            # not a multiple of RB
    ipad = E.pad_items(n_items)
    ue = torch.randint(-1, 2, (rows, d), generator=g).float()
    it = torch.randint(-1, 2, (d, ipad), generator=g).float()
    ss = torch.randint(-4, 5, (rows, 1), generator=g).float()
    neg = torch.argsort(torch.rand(rows, n_items, generator=g), dim=1)[:, :999]
    mask = E.build_packed_mask(neg, n_items)
    full = E.build_packed_mask(torch.arange(n_items)[None], n_items)[0]
    mask[0] = 0                                  # no bit set
    mask[1] = 0                                  # one bit
    mask[1, 5] = 1 << 17
    mask[2] = 0                                  # one full mask block
    mask[2, 128:256] = -1
    mask[3] = full                               # every item
    mask[-1] = full                              # the last, partial tile
    mask = mask.to(card)
    before = E.masked_rank_variant_cuda.launches
    got = E.masked_rank_variant(ue.to(card, dtype), it.to(card, dtype),
                                ss.to(card), mask, rows_per_block, order)
    assert E.masked_rank_variant_cuda.launches == before + 1
    want = E.masked_rank_plain(ue, it, ss, mask.cpu())
    assert want[0] == 0 and want[2] > 0 and want[3] > 0
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows_per_block", E.VARIANT_ROWS_PER_BLOCK)
def test_masked_rank_variants_on_random_tables(card, rows_per_block, dtype):
    g = torch.Generator(device=card).manual_seed(13)
    rows, n_items, d = 16384, 20000, 64
    ipad = E.pad_items(n_items)
    ue = torch.randn(rows, d, generator=g, device=card).to(dtype)
    it = torch.zeros(d, ipad, device=card, dtype=dtype)
    it[:, :n_items] = torch.randn(d, n_items, generator=g, device=card)
    cand = torch.topk(torch.rand(rows, n_items, generator=g, device=card),
                      1000, dim=1).indices
    ss = (ue.float() * it.float()[:, cand[:, 0]].T).sum(1, keepdim=True)
    mask = E.build_packed_mask(cand[:, 1:], n_items)
    got = E.masked_rank_variant_cuda(ue, it, ss, mask, rows_per_block, "ij")
    want = E.masked_rank_plain(ue, it, ss, mask)
    assert int(want.sum()) > 0
    assert int((got != want).sum()) <= 1         # K2_RANDOM_FLIPS_PER_16K


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows_per_block", E.VARIANT_ROWS_PER_BLOCK)
@pytest.mark.parametrize("d", [24, 40])
def test_masked_rank_variants_pad_narrow_widths(card, d, rows_per_block,
                                                dtype):
    g = torch.Generator().manual_seed(16)
    rows, n_items = 1021, 9000
    ipad = E.pad_items(n_items)
    ue = torch.randint(-1, 2, (rows, d), generator=g).float()
    it = torch.randint(-1, 2, (d, ipad), generator=g).float()
    ss = torch.randint(-4, 5, (rows, 1), generator=g).float()
    neg = torch.argsort(torch.rand(rows, n_items, generator=g), dim=1)[:, :999]
    mask = E.build_packed_mask(neg, n_items)
    before = E.masked_rank_variant_cuda.launches
    got = E.masked_rank_variant(ue.to(card, dtype), it.to(card, dtype),
                                ss.to(card), mask.to(card), rows_per_block,
                                "ij")
    assert E.masked_rank_variant_cuda.launches == before + 1
    want = E.masked_rank_plain(ue, it, ss, mask)
    assert int(want.sum()) > 0
    assert torch.equal(got.cpu(), want)


def test_masked_rank_variant_refuses_too_wide_a_tile(card):
    # f32 at 128 rows per block: d = 152 pads to 160 > 144
    assert E.variant_max_d("f32", 128) == 144
    ue = torch.zeros(64, 152, device=card)
    it = torch.zeros(152, 4096, device=card)
    ss = torch.zeros(64, 1, device=card)
    mask = torch.zeros(64, 128, dtype=torch.int32, device=card)
    before = E.masked_rank_variant_cuda.launches
    with pytest.raises(ValueError, match="shared memory"):
        E.masked_rank_variant_cuda(ue, it, ss, mask, 128, "ij")
    assert E.masked_rank_variant_cuda.launches == before
    E.masked_rank_variant_cuda(ue, it, ss, mask, 64, "ij")   # 160 <= 176
    assert E.masked_rank_variant_cuda.launches == before + 1


def _p2_tables(g, n_users, n_items, kind):
    if kind == "int":
        return (torch.randint(-1, 2, (n_users, 64), generator=g).bfloat16(),
                torch.randint(-1, 2, (n_items, 64), generator=g).bfloat16())
    return (torch.randn(n_users, 64, generator=g).bfloat16(),
            torch.randn(n_items, 64, generator=g).bfloat16())


def _p2_on_card(card, ue_t, users, cand, tab):
    """The kernel's scores on ``users`` and ``cand`` as given (on the card:
    one launch, by the counter) and the plain version's, both on the
    CPU."""
    before = PK.candidate_scores_cuda.launches
    got = PK.candidate_scores(ue_t.to(card), users, cand, tab.to(card))
    assert PK.candidate_scores_cuda.launches == before + 1
    return got.cpu(), PK.candidate_scores_plain(ue_t, users.cpu(),
                                                cand.cpu(), tab)


@pytest.mark.parametrize("ids", ["int64_strided", "int32"])
@pytest.mark.parametrize("kind", ["int", "randn"])
def test_candidate_scores_kernel_matches_plain(card, kind, ids):
    """The probe's call (int64 ``r[:, 0]``, ``r[:, 1:]`` of one rows
    array) and contiguous int32 ids."""
    g = torch.Generator().manual_seed(8)
    rows, n_cand, n_users, n_items = 777, 1001, 3000, 5000
    ue_t, tab = _p2_tables(g, n_users, n_items, kind)
    r = torch.cat([torch.randint(0, n_users, (rows, 1), generator=g),
                   torch.randint(0, n_items, (rows, n_cand), generator=g)],
                  1).to(card)
    users, cand = r[:, 0], r[:, 1:]
    if ids == "int32":
        users, cand = users.int(), cand.int().contiguous()
    else:
        assert cand.stride() == (n_cand + 1, 1) and users.stride() == (
            n_cand + 1,)
    got, want = _p2_on_card(card, ue_t, users, cand, tab)
    if kind == "int":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_candidate_scores_kernel_out_of_range_ids(card):
    """Ids outside both tables, as the JAX scorer takes them: NaN in the
    plain version's places (and only there), every other score equal."""
    g = torch.Generator().manual_seed(10)
    rows, n_cand, n_users, n_items = 1024, 1001, 3000, 5000
    ue_t, tab = _p2_tables(g, n_users, n_items, "int")
    users = torch.randint(0, n_users, (rows,), generator=g)
    cand = torch.randint(0, n_items, (rows, n_cand), generator=g)
    bad_c = torch.tensor([-1, -n_items, n_items, n_items + 5, -n_items - 1,
                          2 ** 40, -2 ** 40])
    bad_u = torch.tensor([-1, -n_users, n_users, n_users + 7, -n_users - 1,
                          2 ** 40, -2 ** 40])
    at = torch.randint(0, rows * n_cand, (4096,), generator=g)
    cand.view(-1)[at] = bad_c[torch.arange(4096) % len(bad_c)]
    users[::3] = bad_u[torch.arange(len(users[::3])) % len(bad_u)]
    got, want = _p2_on_card(card, ue_t, users.to(card), cand.to(card), tab)
    nan = want.isnan()
    assert 0 < int(nan.sum()) < 4096
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(got[~nan], want[~nan])


@pytest.mark.parametrize("C", [1, 17, 4096])
@pytest.mark.parametrize("B", [1, 3, 1025])
def test_candidate_scores_kernel_odd_shapes(card, B, C):
    """Row counts and slates that fill no whole wave, item or 16-byte run
    of ``out``; integer tables, exact."""
    g = torch.Generator().manual_seed(B * 10_000 + C)
    ue_t, tab = _p2_tables(g, 700, 900, "int")
    users = torch.randint(0, 700, (B,), generator=g)
    cand = torch.randint(0, 900, (B, C), generator=g)
    got, want = _p2_on_card(card, ue_t, users.to(card), cand.to(card), tab)
    assert torch.equal(got, want)


def test_candidate_scores_kernel_refuses_what_it_cannot_take(card):
    g = torch.Generator().manual_seed(12)
    ue_t, tab = (t.to(card) for t in _p2_tables(g, 50, 60, "int"))
    users = torch.zeros(4, dtype=torch.int64, device=card)
    cand = torch.zeros(4, 3, dtype=torch.int64, device=card)
    before = PK.candidate_scores_cuda.launches
    with pytest.raises(ValueError, match="DIM=64"):
        PK.candidate_scores_cuda(ue_t[:, :32].contiguous(), users, cand,
                                 tab[:, :32].contiguous())
    with pytest.raises(ValueError, match="bfloat16"):
        PK.candidate_scores_cuda(ue_t.float(), users, cand, tab.float())
    with pytest.raises(ValueError, match="int32 or int64"):
        PK.candidate_scores_cuda(ue_t, users, cand.short(), tab)
    assert PK.candidate_scores_cuda.launches == before


def test_dense_mask_rank_kernel_exact_on_integer_tables(card):
    g = torch.Generator().manual_seed(9)
    rows, n_items, ipad = 600, 9000, 10240
    tab = torch.zeros(ipad, 64, dtype=torch.bfloat16)
    tab[:n_items] = torch.randint(-1, 2, (n_items, 64), generator=g)
    ue = torch.randint(-1, 2, (rows, 64), generator=g).float()
    cand = torch.argsort(torch.rand(rows, n_items, generator=g), dim=1)[:, :1001]
    maskm = torch.zeros(rows, ipad, dtype=torch.int8)
    maskm.scatter_(1, cand, 1)
    tgt = cand[:, 0]
    before = PK.dense_mask_rank_cuda.launches
    got = PK.dense_mask_rank(tab.to(card), ue.to(card), tgt.to(card),
                             maskm.to(card))
    assert PK.dense_mask_rank_cuda.launches == before + 1
    want = PK.dense_mask_rank_plain(tab, ue, tgt, maskm)
    assert torch.equal(got.cpu(), want)


# 9008: mask rows of 563 chunks, which the 8 warps split unevenly
@pytest.mark.parametrize("n_items,ipad", [(20000, 20480), (9000, 9008)])
def test_dense_mask_rank_kernel_edge_rows_exact(card, n_items, ipad):
    g = torch.Generator().manual_seed(12)
    rows = 1021                                  # not a multiple of 8
    tab = torch.zeros(ipad, 64, dtype=torch.bfloat16)
    tab[:n_items] = torch.randint(-1, 2, (n_items, 64), generator=g)
    ue = torch.randint(-1, 2, (rows, 64), generator=g).bfloat16()
    cand = torch.argsort(torch.rand(rows, n_items, generator=g), dim=1)[:, :1001]
    maskm = torch.zeros(rows, ipad, dtype=torch.int8)
    maskm.scatter_(1, cand, 1)
    tgt = cand[:, 0].clone()
    maskm[0] = 0                                 # no entry set
    maskm[1, :n_items] = 1                       # every item, the target too
    maskm[2] = 0                                 # one 16-byte chunk
    maskm[2, 4096:4112] = 1
    tgt[2] = 4100
    maskm[3] = 0                                 # the last chunk
    maskm[3, ipad - 16:] = 1
    want = PK.dense_mask_rank_plain(tab, ue, tgt, maskm)
    assert want[0] == 0 and 0 < want[1] < n_items
    got = PK.dense_mask_rank_cuda(tab.to(card), ue.to(card), tgt.to(card),
                                  maskm.to(card))
    assert torch.equal(got.cpu(), want)


def test_engine_serving_path_on_card(card):
    from sml_tpu_torch.train.engine import SMLEngine

    cfg = SMLConfig(latent_dim=16, eval_scoring="masked", eval_batch_size=64,
                    transfer=TransferConfig(latent_dim=16))
    g = torch.Generator().manual_seed(4)
    n_users, n_items = 500, 5000
    users = torch.randint(0, n_users, (200, 1), generator=g)
    cand = torch.argsort(torch.rand(200, n_items, generator=g), dim=1)[:, :51]
    rows = torch.cat([users, cand], dim=1).numpy()
    results = []
    for device in (card, "cpu"):
        k1, k2 = TK.transfer_rows_cuda.launches, E.masked_rank_cuda.launches
        eng = SMLEngine(cfg, n_users, n_items, device=device)
        state = eng.refresh(eng.snapshot_last(eng.init_state()))
        metrics = eng.evaluate(state.mf, eng.make_eval_set(rows,
                                                           build_mask=True))
        results.append((state, metrics,
                        (TK.transfer_rows_cuda.launches - k1,
                         E.masked_rank_cuda.launches - k2)))
    (gs, gm, g_launches), (cs, cm, c_launches) = results
    # one refresh = 2 K1 launches; 256 padded eval rows / 64 = 4 K2 launches
    assert g_launches == (2, 4) and c_launches == (0, 0)
    torch.testing.assert_close(gs.mf.user_emb.cpu(), cs.mf.user_emb,
                               rtol=1e-4, atol=1e-4)
    for k in cfg.topk:
        assert abs(gm[k]["recall"] - cm[k]["recall"]) * 200 <= 1 + 1e-6


@pytest.mark.parametrize("shape,offset", [((1001, 64), 0), ((777, 1), 0),
                                          ((4099,), 1), ((5,), 0)])
def test_decay_adam_kernel_matches_plain(card, shape, offset):
    from sml_tpu_torch.train.optim import (ADAM_B1, ADAM_B2, ADAM_EPS,
                                           bias_corrections)
    g = torch.Generator().manual_seed(5)
    n = int(np.prod(shape))
    bufs = [torch.randn(n + 1, generator=g) for _ in range(3)]
    bufs[1] *= 1e-2
    bufs[2] = bufs[2].abs() * 1e-4
    # offset 1: a view 4 bytes past an aligned buffer (the scalar path)
    got = [b.to(card)[offset:offset + n].view(shape) for b in bufs]
    plain = [t.clone() for t in got]
    bc1, bc2 = bias_corrections(7)
    kw = dict(lr=0.01, b1=ADAM_B1, b2=ADAM_B2, eps=ADAM_EPS)
    before = AK.decay_adam_cuda.launches
    AK.fused_decay_adam(*got, bc1, bc2, **kw)
    assert AK.decay_adam_cuda.launches == before + 1
    AK.decay_adam_plain(*plain, bc1, bc2, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[1], plain[1]) and torch.equal(got[2], plain[2])
    torch.testing.assert_close(got[0], plain[0], rtol=1e-6, atol=0)
    assert int((got[0] != plain[0]).sum()) == 0


def test_decay_adam_multi_one_launch_for_four_leaves(card):
    from sml_tpu_torch.train.optim import (ADAM_B1, ADAM_B2, ADAM_EPS,
                                           bias_corrections)
    g = torch.Generator().manual_seed(14)
    # (300, 64) and (200, 1) whole; an odd length; a view 4 bytes past an
    # aligned buffer (every unit of that leaf on the scalar path)
    shapes = [((300, 64), 0), ((200, 1), 0), ((1001,), 0), ((77, 3), 1)]
    leaves = []
    for shape, offset in shapes:
        n = int(np.prod(shape))
        bufs = [torch.randn(n + 1, generator=g) for _ in range(3)]
        bufs[1] *= 1e-2
        bufs[2] = bufs[2].abs() * 1e-4
        leaves.append(tuple(b.to(card)[offset:offset + n].view(shape)
                            for b in bufs))
    plain = [tuple(t.clone() for t in leaf) for leaf in leaves]
    bc1, bc2 = bias_corrections(7)
    kw = dict(lr=0.01, b1=ADAM_B1, b2=ADAM_B2, eps=ADAM_EPS)
    before = AK.decay_adam_cuda.launches
    AK.fused_decay_adam_multi(leaves, bc1, bc2, **kw)
    assert AK.decay_adam_cuda.launches == before + 1
    for leaf in plain:
        AK.decay_adam_plain(*leaf, bc1, bc2, **kw)
    torch.cuda.synchronize()
    for got, want in zip(leaves, plain):
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_fast_inner_step_launches_k3_once(card):
    from sml_tpu_torch.train.engine import SMLEngine

    cfg = SMLConfig(latent_dim=16, mf_batch_size=64, replay_mode=True,
                    fast_table_adam=True,
                    transfer=TransferConfig(latent_dim=16))
    eng = SMLEngine(cfg, 500, 300, device=card)
    assert eng.cfg.fast_table_adam
    rng = np.random.default_rng(15)
    rows = np.stack([rng.integers(0, 500, 64), rng.integers(0, 300, 64),
                     rng.integers(0, 300, 64)], axis=1).astype(np.int64)
    state = eng.snapshot_last(eng.init_state())
    before = AK.decay_adam_cuda.launches
    state, losses = eng.inner_epoch(state, *eng.prep_inner(rows))
    torch.cuda.synchronize()
    assert state.mf_opt.count == 1
    assert AK.decay_adam_cuda.launches == before + 1
    assert torch.isfinite(losses).all()


def test_decay_adam_kernel_rejects_what_it_cannot_take(card):
    p = torch.zeros(8, device=card)
    kw = dict(lr=0.01, b1=0.9, b2=0.999, eps=1e-8)
    before = AK.decay_adam_cuda.launches
    with pytest.raises(ValueError, match="distinct"):
        AK.decay_adam_cuda([(p, p, torch.zeros(8, device=card))], 0.1, 0.01,
                           **kw)
    with pytest.raises(ValueError, match="float32"):
        AK.decay_adam_cuda([(p.double(), p.double().clone(),
                             p.double().clone())], 0.1, 0.01, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        AK.decay_adam_cuda([(p, p.clone(), p.clone()),
                            tuple(torch.zeros(8) for _ in range(3))],
                           0.1, 0.01, **kw)
    with pytest.raises(ValueError, match="at most 8"):
        AK.decay_adam_cuda([tuple(torch.zeros(8, device=card)
                                  for _ in range(3)) for _ in range(9)],
                           0.1, 0.01, **kw)
    assert AK.decay_adam_cuda.launches == before


def test_pair_hash_on_card_matches_numpy(card):
    from sml_tpu_torch.ops import sampling as S
    rng = np.random.default_rng(6)
    u = rng.integers(0, 2**32, 100_000, dtype=np.uint64)
    i = rng.integers(0, 2**32, 100_000, dtype=np.uint64)
    u[:2], i[:2] = 2**32 - 1, 0
    want = S._hash_pair_np(u, i).astype(np.int64)
    got = S._hash_pair_torch(torch.from_numpy(u.astype(np.int64)).to(card),
                             torch.from_numpy(i.astype(np.int64)).to(card))
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    inter = np.stack([u[:5000] % 1000, i[:5000] % 300], 1).astype(np.int64)
    idx = S.build_period_index(inter, 300, device=card)
    assert S.is_positive(idx, torch.from_numpy(inter[:, 0]).to(card),
                         torch.from_numpy(inter[:, 1]).to(card)).all()


def _run_sml_cli(tmp_path, capsys, latent):
    from sml_tpu_torch import cli
    d = str(tmp_path)
    assert cli.main(["synth", "--out", f"{d}/synth", "--users", "300",
                     "--items", "150", "--periods", "6", "--interactions",
                     "600", "--first-test", "3", "--neg-num", "49"]) == 0
    capsys.readouterr()
    counts = (AK.decay_adam_cuda.launches, TK.transfer_rows_cuda.launches,
              E.masked_rank_cuda.launches)
    assert cli.main(["--device", "cuda", "sml", "--data-root", d,
                     "--data-name", "synth", "--num-periods", "6",
                     "--online-train-start", "2", "--online-test-start",
                     "4", "--multi-num", "2", "--latent", str(latent),
                     "--mf-sample", "alone", "--eval-scoring", "masked",
                     "--saddle-retries", "0"]) == 0
    out = capsys.readouterr().out
    summary = json.loads(out[out.index("{"):])
    assert 0.0 <= summary["test_recall@5"] <= 1.0
    after = (AK.decay_adam_cuda.launches, TK.transfer_rows_cuda.launches,
             E.masked_rank_cuda.launches)
    return counts, after


def test_sml_cli_on_card(card, tmp_path, capsys):
    counts, after = _run_sml_cli(tmp_path, capsys, 16)
    # 420 users + items: the auto rule keeps the dense path (no K3);
    # refreshes (K1) and masked tests (K2) run on the card
    assert after[0] == counts[0]
    assert after[1] > counts[1] and after[2] > counts[2]


@pytest.mark.parametrize("latent", [80, 128])
def test_sml_cli_wide_latent_on_card(card, tmp_path, capsys, latent):
    counts, after = _run_sml_cli(tmp_path, capsys, latent)
    # every refresh went through K1: two launches each, none refused
    k1 = after[1] - counts[1]
    assert k1 > 0 and k1 % 2 == 0


@pytest.mark.parametrize("latent", [80, 128])
def test_refresh_at_wide_latent_on_card(card, latent):
    from sml_tpu_torch.train.engine import SMLEngine
    cfg = SMLConfig(latent_dim=latent,
                    transfer=TransferConfig(latent_dim=latent))
    states = []
    for device in (card, "cpu"):
        before = TK.transfer_rows_cuda.launches
        eng = SMLEngine(cfg, 700, 300, device=device)
        states.append(eng.refresh(eng.snapshot_last(eng.init_state())))
        assert TK.transfer_rows_cuda.launches - before == (
            2 if device is card else 0)
    torch.testing.assert_close(states[0].mf.user_emb.cpu(),
                               states[1].mf.user_emb, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(states[0].mf.item_emb.cpu(),
                               states[1].mf.item_emb, rtol=1e-4, atol=1e-4)


KINDS = ("conv_com", "conv2ch", "conv_com_root", "mlp_delta", "linear",
         "gru", "gated")


@pytest.mark.parametrize("kind", KINDS)
def test_transfer_kind_refresh_and_outer_step_on_card(card, kind):
    """Each kind's refresh and one replay-mode outer step on the card
    against the CPU; only conv_com reaches K1."""
    from sml_tpu_torch.train.engine import SMLEngine
    d = 32
    cfg = SMLConfig(latent_dim=d, replay_mode=True, tr_batch_size=64,
                    transfer=TransferConfig(latent_dim=d, fc_hidden=128,
                                            kind=kind))
    g = torch.Generator().manual_seed(6)
    last_u, last_i = torch.randn(600, d, generator=g), \
        torch.randn(400, d, generator=g)
    rows = torch.stack([torch.randint(0, 600, (64,), generator=g),
                        torch.randint(0, 400, (64,), generator=g),
                        torch.randint(0, 400, (64,), generator=g)],
                       1).numpy()
    runs = []
    for device in (card, "cpu"):
        eng = SMLEngine(cfg, 600, 400, device=device)
        state = eng.init_state()
        state = state._replace(last_user=last_u.to(device),
                               last_item=last_i.to(device))
        before = TK.transfer_rows_cuda.launches
        state = eng.refresh(state)
        k1 = TK.transfer_rows_cuda.launches - before
        state, loss = eng.outer_epoch(state, *eng.prep_outer(rows))
        runs.append((state, float(loss[0]), k1))
    (gs, gl, gk1), (cs, cl, ck1) = runs
    assert gk1 == (2 if kind == "conv_com" else 0) and ck1 == 0
    torch.testing.assert_close(gs.mf.user_emb.cpu(), cs.mf.user_emb,
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(gs.mf.item_emb.cpu(), cs.mf.item_emb,
                               rtol=1e-4, atol=1e-4)
    assert gl == pytest.approx(cl, rel=1e-5)
    from sml_tpu_torch.models.transfer import theta_leaves
    tg, tc = theta_leaves(gs.theta), theta_leaves(cs.theta)
    for name in tg:
        torch.testing.assert_close(tg[name].detach().cpu(),
                                   tc[name].detach(), rtol=1e-4, atol=1e-4)


def test_attributed_evaluation_on_card_equals_cpu(card):
    """Integer tables: every score is exact, so the card's attributed
    record (K2 ranks) equals the CPU's."""
    from sml_tpu_torch.models.mf import MFParams
    from sml_tpu_torch.train.engine import SMLEngine
    n_users, n_items, d = 500, 3000, 16
    g = torch.Generator().manual_seed(8)
    ue = torch.randint(-3, 4, (n_users, d), generator=g).float()
    ie = torch.randint(-3, 4, (n_items, d), generator=g).float()
    users = torch.randint(0, n_users, (300, 1), generator=g)
    cand = torch.argsort(torch.rand(300, n_items, generator=g), dim=1)[:, :51]
    rows = torch.cat([users, cand], dim=1).numpy()
    new_u = np.arange(0, n_users, 7)
    new_i = np.arange(0, n_items, 5)
    cfg = SMLConfig(latent_dim=d, eval_scoring="masked", eval_batch_size=64)
    recs = []
    for device in (card, "cpu"):
        eng = SMLEngine(cfg, n_users, n_items, device=device)
        mf = MFParams(ue.to(device), ie.to(device),
                      torch.zeros(n_users, 1, device=device),
                      torch.zeros(n_items, 1, device=device))
        before = E.masked_rank_cuda.launches
        recs.append(eng.evaluate_attributed(
            mf, eng.make_eval_set(rows, build_mask=True),
            *eng.new_entity_masks(new_u, new_i)))
        if device is card:
            # 300 rows padded to 320: five batches of 64
            assert E.masked_rank_cuda.launches - before == 5
    assert recs[0] == recs[1]


def test_profiled_period_on_card_traces_kernels(card, tmp_path, capsys):
    from sml_tpu_torch import cli
    d = str(tmp_path)
    assert cli.main(["synth", "--out", f"{d}/synth", "--users", "300",
                     "--items", "150", "--periods", "6", "--interactions",
                     "600", "--first-test", "3", "--neg-num", "49"]) == 0
    prof = tmp_path / "prof"
    assert cli.main(["sml", "--data-root", d, "--data-name", "synth",
                     "--num-periods", "6", "--online-train-start", "2",
                     "--online-test-start", "4", "--multi-num", "1",
                     "--latent", "16", "--mf-sample", "alone",
                     "--saddle-retries", "0", "--attributed-eval",
                     "--profile-dir", str(prof)]) == 0
    capsys.readouterr()
    traces = list(prof.iterdir())
    assert len(traces) == 1
    with open(traces[0]) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert kernels
    # the refresh's K1 launches are among the traced kernels
    assert any("transfer_rows" in e["name"] for e in kernels)
    spans = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    # "auto" fuses on the card: the warm-up period is one period_step
    # (its phase the engine's first, run eagerly), then the final refresh
    assert {"refresh", "period_step"} <= spans


@pytest.mark.parametrize("n", [2, 4])
def test_ranks_sharing_the_card_match_one_rank(card, n):
    """``dryrun_multichip`` with every rank on cuda:0 over gloo (mesh (1, 2)
    or (2, 2)): one full step in 'alone', replay and 'all' mode within
    1e-4 of one rank on the card, sharded serving equal to dense; every
    rank launches K1 twice per refresh and K3 once per fast step, as many
    as every other rank (the dry run's test scores by gathering, as the
    JAX dry run's does: its 32 items hold each row's target among the 999
    negatives, which the masked modes would rank against itself; the
    smoke's parallel phase drives K2 on a mesh)."""
    from sml_tpu_torch.parallel.dryrun import dryrun_multichip
    report = dryrun_multichip(n, device="cuda", timeout_s=300)
    for mode in ("alone", "replay", "all"):
        assert max(report[mode]["max_delta"].values()) < 1e-4
        per_rank = report[mode]["launches"]
        assert len(per_rank) == n
        for launches in per_rank:
            assert launches["transfer_rows_kernel"] == 4
            assert launches["masked_rank_gather_kernel"] == 0
            assert launches["decay_adam_kernel"] > 0
            assert launches == per_rank[0]
    assert report["serving"] <= 1e-5


def _fused_engine(card, **kw):
    """A small engine on the card whose phase draws negatives (so the
    generator matters), takes row-sparse Adam steps (K3 by pointer),
    refreshes through K1 and evaluates with K2 inside the phase."""
    from sml_tpu_torch.train.engine import SMLEngine
    base = dict(latent_dim=16, mf_batch_size=64, tr_batch_size=32,
                eval_batch_size=64, mf_epochs=2, tr_epochs=2, multi_num=4,
                mf_sample="alone", fast_table_adam=True,
                eval_scoring="masked", eval_during_inner=True,
                eval_during_outer=True,
                transfer=TransferConfig(latent_dim=16, fc_hidden=64))
    base.update(kw)
    return SMLEngine(SMLConfig(**base), 500, 300, device=card)


def _fused_inputs(eng):
    rng = np.random.default_rng(21)
    pairs = np.unique(np.stack([rng.integers(0, 500, 900),
                                rng.integers(0, 300, 900)], 1), axis=0)
    users = rng.permutation(500)[:100]
    cand = np.stack([rng.permutation(300)[:21] for _ in users])
    val = np.concatenate([users[:, None], cand], 1)
    return (eng.prep_inner(pairs), eng.prep_outer(pairs[:300]),
            eng.make_eval_set(val, build_mask=True))


def _eager_phase(eng, state, prep_t, prep_tt, val):
    """The driver's unfused phase, call by call."""
    sums = []
    for _ in range(eng.cfg.mf_epochs):
        state, il = eng.inner_epoch(state, *prep_t)
        sums.append(eng.evaluate_deferred(state.mf, val)[0])
    state = eng.refresh(eng.snapshot_hat(state))
    for _ in range(eng.cfg.tr_epochs):
        state, ol = eng.outer_epoch(state, *prep_tt)
        state = eng.refresh(state)
        sums.append(eng.evaluate_deferred(state.mf, val)[0])
    return state, il, ol, sums


def test_captured_phase_replays_match_eager_phases(card):
    """``period_step`` (the engine's first phase eagerly on the capture
    stream, then one capture and replays) against the same phases run
    call by call from a copy of the state: tables, Θ, moments, losses,
    eval sums and the generator's position."""
    from sml_tpu_torch.models.transfer import theta_leaves
    from sml_tpu_torch.train.engine import copy_state
    n = 4
    fused, plain = _fused_engine(card), _fused_engine(card)
    prep_t, prep_tt, val = _fused_inputs(fused)
    state = fused.snapshot_last(fused.init_state())
    ref = copy_state(state)
    state, evals, (ils, ols), _ = fused.period_step(state, prep_t, prep_tt,
                                                    n, val)
    assert [fused.graph_stats[k] for k in ("warmups", "captures",
                                           "replays")] == [1, 1, n - 1]
    hits = []
    for _ in range(n):
        ref, il, ol, sums = _eager_phase(plain, ref, prep_t, prep_tt, val)
        hits.append(sums)
    torch.cuda.synchronize()
    tol = dict(rtol=1e-5, atol=1e-5)
    for f in ("user_emb", "item_emb", "user_bias", "item_bias"):
        torch.testing.assert_close(getattr(state.mf, f), getattr(ref.mf, f),
                                   **tol)
    for f in ("hat_user", "hat_item"):
        torch.testing.assert_close(getattr(state, f), getattr(ref, f), **tol)
    tg, tr = theta_leaves(state.theta), theta_leaves(ref.theta)
    for k in tg:
        torch.testing.assert_close(tg[k].detach(), tr[k].detach(), **tol)
    for opt in ("mf_opt", "tr_opt"):
        a, b = getattr(state, opt), getattr(ref, opt)
        assert a.count == b.count
        for part in ("mu", "nu"):
            for k, t in getattr(a, part).items():
                torch.testing.assert_close(t, getattr(b, part)[k], **tol)
    torch.testing.assert_close(ils[-1], il, **tol)
    torch.testing.assert_close(ols[-1], ol, **tol)
    assert torch.equal(state.gen.get_state(), ref.gen.get_state())
    got = fused.resolve_stacked_evals([(evals, 100)])[0]
    want = [sums for phase in hits for sums in phase]
    assert len(got) == len(want) == n * 4
    for (_, _, m), sums in zip(got, want):
        for k in fused.cfg.topk:
            assert abs(m[k]["recall"] * 100 - float(sums[k][0])) <= 1


def test_replays_count_their_launches(card):
    """A capture adds no launch; every replay adds the captured ones, so
    the counts equal those of the same phases run eagerly."""
    n = 3
    counted = (AK.decay_adam_cuda, TK.transfer_rows_cuda, E.masked_rank_cuda)
    totals = []
    for fuse in (True, False):
        eng = _fused_engine(card)
        prep_t, prep_tt, val = _fused_inputs(eng)
        state = eng.snapshot_last(eng.init_state())
        before = [w.launches for w in counted]
        if fuse:
            eng.period_step(state, prep_t, prep_tt, n, val)
            assert eng.graph_stats["replays"] == n - 1
        else:
            for _ in range(n):
                state = _eager_phase(eng, state, prep_t, prep_tt, val)[0]
        torch.cuda.synchronize()
        totals.append([w.launches - b for w, b in zip(counted, before)])
    steps = -(-prep_t[0].n_real // 64) * 2
    # K3 one per fast step; K1 2 per refresh (3 per phase); K2 2 batches
    # per eval (4 per phase)
    assert totals[0] == totals[1] == [n * steps, n * 6, n * 4 * 2]


def test_decay_adam_reads_bias_corrections_when_it_runs(card):
    """K3 reads bc1/bc2 through pointers when it runs: one launch captured
    in a CUDA graph, replayed after each refill of its BiasTable, takes the
    steps the plain version takes with each step's floats, bit for bit;
    floats go the same way."""
    from sml_tpu_torch.train.optim import (ADAM_B1, ADAM_B2, ADAM_EPS,
                                           BiasTable, bias_corrections)
    g = torch.Generator().manual_seed(23)
    leaves = [tuple(torch.randn(n, generator=g).abs().to(card) * s
                    for s in (1.0, 1e-2, 1e-4)) for n in (1001, 64, 7)]
    want = [tuple(t.clone() for t in leaf) for leaf in leaves]
    table = BiasTable(1, card)
    table.fill(10)
    kw = dict(lr=0.01, b1=ADAM_B1, b2=ADAM_B2, eps=ADAM_EPS)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        AK.decay_adam_cuda(leaves, *table.at(11, ADAM_B1, ADAM_B2), **kw)
    for count in (11, 12, 13):
        table.fill(count - 1)
        graph.replay()
        for leaf in want:
            AK.decay_adam_plain(*leaf, *bias_corrections(count), **kw)
    before = AK.decay_adam_cuda.launches
    AK.fused_decay_adam_multi(leaves, *bias_corrections(14), **kw)
    for leaf in want:
        AK.decay_adam_plain(*leaf, *bias_corrections(14), **kw)
    torch.cuda.synchronize()
    assert AK.decay_adam_cuda.launches == before + 1
    for got, exp in zip(leaves, want):
        assert all(torch.equal(a, b) for a, b in zip(got, exp))
    with pytest.raises(ValueError, match="one f32 value"):
        AK.decay_adam_cuda(leaves, table.buf[0], 0.5, **kw)


def test_transfer_kernel_writes_into_out(card):
    th = init_transfer(torch.Generator().manual_seed(24),
                       TransferConfig(latent_dim=64), device=card)
    g = torch.Generator().manual_seed(25)
    last = torch.randn(3000, 64, generator=g).to(card)
    hat = torch.randn(3000, 64, generator=g).to(card)
    out = torch.full((3000, 64), float("nan"), device=card)
    before = TK.transfer_rows_cuda.launches
    got = TK.fused_table_transfer(th.user, last, hat, out=out)
    assert got is out and TK.transfer_rows_cuda.launches == before + 1
    assert torch.equal(out, TK.fused_table_transfer(th.user, last, hat))
    with pytest.raises(ValueError, match="overlap"):
        TK.fused_table_transfer(th.user, last, hat, out=last)
    with pytest.raises(ValueError, match="contiguous"):
        TK.fused_table_transfer(th.user, last, hat, out=out.t())


def test_if_node_step_with_autograd_taken_and_skipped(card):
    """Four step slots under ``graphs.step_if`` captured once (each step a
    backward through a small tower, an update in place and a draw from the
    registered generator), replayed with 4 and with 2 slots taken, against
    the same steps run eagerly (which skip a skipped slot's offset):
    parameters, losses and the generator's offset equal, skipped slots'
    losses 0."""
    from sml_tpu_torch.train import graphs

    g = torch.Generator().manual_seed(31)
    w0 = torch.randn(16, 8, generator=g).to(card)
    x = torch.randn(4, 32, 16, generator=g).to(card)

    scratch = torch.Generator(device=card)
    torch.rand(32, 8, generator=scratch, device=card)
    per_step = scratch.get_offset()

    def steps(w, losses, slots, gen):
        losses.zero_()
        for b in range(4):
            with graphs.step_if(slots, b) as run:
                if not run:
                    # eagerly, skip the offsets a replay reserves here
                    gen.set_offset(gen.get_offset() + per_step)
                    continue
                noise = torch.rand(32, 8, generator=gen, device=card)
                wv = w.detach().requires_grad_()
                with torch.enable_grad():
                    loss = ((torch.tanh(x[b] @ wv) - noise) ** 2).mean()
                    (grad,) = torch.autograd.grad(loss, [wv])
                with torch.no_grad():
                    w.sub_(0.1 * grad / (grad.abs().max() + 1e-6))
                losses[b] = loss.detach()

    site = graphs.GraphSite(card)
    w, losses = w0.clone(), torch.zeros(4, device=card)
    slots = graphs.SlotTable(4, card)
    own = torch.Generator(device=card)
    slots.fill(4)
    gen = torch.Generator(device=card).manual_seed(5)
    graphs.run_on(site.stream(), lambda: steps(w, losses, slots, gen))
    call = graphs.CapturedCall(lambda: steps(w, losses, slots, own),
                               site.stream(), generators=(own,))
    ref_w, ref_l = w0.clone(), torch.zeros(4, device=card)
    ref_slots = graphs.SlotTable(4, card)
    ref_gen = torch.Generator(device=card).manual_seed(5)
    ref_slots.fill(4)
    steps(ref_w, ref_l, ref_slots, ref_gen)
    for taken in (4, 2, 4):
        w.copy_(ref_w)
        slots.fill(taken)
        call.replay(sources=(gen,))
        ref_slots.fill(taken)
        steps(ref_w, ref_l, ref_slots, ref_gen)
        torch.cuda.synchronize()
        assert torch.equal(w, ref_w) and torch.equal(losses, ref_l)
        assert (losses[taken:] == 0).all() and (losses[:taken] > 0).all()
    assert gen.get_offset() == ref_gen.get_offset() == 16 * per_step


def _tiny_mf(card, n_u=300, n_i=200, d=16):
    from sml_tpu_torch.models.mf import init_mf
    return init_mf(torch.Generator().manual_seed(3), n_u, n_i, d,
                   device=card)


def test_generator_skip_ahead_matches_replays(card):
    """Plain MF epochs with fewer real batches than slots (the rows padded
    to a larger bound), three through a ``PlainEpochProgram`` (the warm-up,
    a capture, replays) and three called eagerly: tables, moments, the
    generator's offset and the next draw equal, so an eager epoch skips as
    far as a replay advances."""
    from sml_tpu_torch.ops.batching import pad_rows
    from sml_tpu_torch.ops.sampling import build_period_index
    from sml_tpu_torch.train import graphs
    from sml_tpu_torch.train.optim import adam_init
    from sml_tpu_torch.train.steps import (PlainEpochProgram,
                                           make_plain_mf_epoch)
    rng = np.random.default_rng(8)
    rows = np.stack([rng.integers(0, 300, 700), rng.integers(0, 200, 700)],
                    1)
    padded = pad_rows(rows, 64, pad_to=1500, device=card)
    index = build_period_index(rows, 200, min_rows=1500, device=card)
    assert padded.rows.shape[0] // 64 > -(-700 // 64)
    for fast in (None, 0.01):
        epoch = make_plain_mf_epoch(64, 1e-3, 1e-3, 0.01, fast_lr=fast)
        runs = []
        for programmed in (True, False):
            mf = _tiny_mf(card)
            opt = adam_init(mf._asdict())
            gen = torch.Generator(device=card).manual_seed(9)
            site = graphs.GraphSite(card)
            prog = PlainEpochProgram(epoch, site, mf, opt, padded, index, 64)
            for _ in range(3):
                if programmed:
                    mf, opt, _ = prog.run(mf, opt, padded, gen, index)
                else:
                    mf, opt, _ = epoch(mf, opt, padded.rows, padded.mask,
                                       padded.n_real, gen, index)
            torch.cuda.synchronize()
            runs.append((mf, opt, gen, dict(site.stats)))
        (pm, po, pg, ps), (em, eo, eg, _) = runs
        assert [ps[k] for k in ("warmups", "captures", "replays")] == \
            [1, 1, 2]
        assert po.count == eo.count == 3 * -(-700 // 64)
        assert all(torch.equal(a, b) for a, b in zip(pm, em))
        for part in ("mu", "nu"):
            for k, t in getattr(po, part).items():
                assert torch.equal(t, getattr(eo, part)[k]), (part, k)
        assert pg.get_offset() == eg.get_offset()
        assert torch.equal(torch.rand(5, generator=pg, device=card),
                           torch.rand(5, generator=eg, device=card))


@pytest.mark.parametrize("extra", [
    {}, dict(eval_during_inner=True, eval_during_outer=True, log_norms=True,
             saddle_retries=1, saddle_mode="legacy", saddle_frac=0.0,
             saddle_check_phase=1)])
def test_one_capture_serves_a_ragged_sweep(card, tmp_path, extra):
    """A sweep on periods of different row counts with the default "auto"
    (fused on the card) against the same sweep unfused: three programs
    (the phase program and branch C's inner and outer epoch programs), a
    capture each and one warm-up for the whole sweep (the saddle retry too),
    tables, snapshots, Θ, moments, counts and the generator bit-equal, and
    K1/K2/K3 launches equal but for the phase the fused guard adds.""" 
    from sml_tpu_torch.models.transfer import theta_leaves
    from sml_tpu_torch.train.driver import SMLDriver
    spec = ragged_dataset(tmp_path)
    counted = (AK.decay_adam_cuda, TK.transfer_rows_cuda, E.masked_rank_cuda)
    runs = []
    for fuse in (dict(), dict(fuse_phases=False, fuse_period=False)):
        cfg = SMLConfig(multi_num=3, mf_epochs=2, tr_epochs=2,
                        mf_batch_size=64, tr_batch_size=32,
                        eval_batch_size=64, latent_dim=16,
                        mf_sample="alone", fast_table_adam=True,
                        eval_scoring="masked", prefetch_periods=False,
                        transfer=TransferConfig(latent_dim=16, fc_hidden=64),
                        **extra, **fuse)
        before = [w.launches for w in counted]
        drv = SMLDriver(cfg, spec, device=card)
        report = drv.run()
        torch.cuda.synchronize()
        runs.append((drv.final_state, dict(drv.engine.graph_stats), report,
                     [w.launches - b for w, b in zip(counted, before)]))
        drv.close()
    (fs, stats, frep, fl), (us, _, urep, ul) = runs
    assert [stats[k] for k in ("programs", "captures", "warmups")] == \
        [3, 3, 1], stats
    # the fused guard runs every phase of the stalled attempt: period 0's
    # phase 2 beyond the unfused guard's check phase 1 (K3 2 epochs x 7
    # steps of train/1, K1 2 per refresh x 3, K2 2 eval batches x 4 evals)
    extra_phase = [14, 6, 8] if extra else [0, 0, 0]
    assert [f - u for f, u in zip(fl, ul)] == extra_phase and min(ul) > 0
    assert frep.saddle_retries_used == urep.saddle_retries_used
    for a, b in zip(fs.mf, us.mf):
        assert torch.equal(a, b)
    for f in ("last_user", "last_item", "hat_user", "hat_item"):
        assert torch.equal(getattr(fs, f), getattr(us, f))
    ta, tb = theta_leaves(fs.theta), theta_leaves(us.theta)
    assert all(torch.equal(ta[k], tb[k]) for k in ta)
    for opt in ("mf_opt", "tr_opt"):
        a, b = getattr(fs, opt), getattr(us, opt)
        assert a.count == b.count
        for part in ("mu", "nu"):
            for k, t in getattr(a, part).items():
                assert torch.equal(t, getattr(b, part)[k]), (opt, part, k)
    assert torch.equal(fs.gen.get_state(), us.gen.get_state())
    assert frep.per_period == urep.per_period


def test_phase0_epoch_programs_replay_the_eager_phase0(card, tmp_path):
    """Branch C's phase 0 through its epoch programs: the ragged sweep of
    three periods (branch A, then two branch C) with the default "auto"
    (phase 0's epochs captured and replayed) against ``fuse_period=False``
    (phase 0 eager, the other phases replayed): every period's tables,
    snapshots, Θ, moments, counts and generator and each phase-0 epoch's
    losses bit-equal, though every period's end keeps a copy of Θ made
    with gradients on (the copies' graphs into Θ alive across the epoch
    programs' captures); one capture per epoch program, replayed for every
    phase-0 epoch; K3 and K1 launches as ``scale_sweep.sweep_launches``
    derives them; a replay inside a trace (period 2 traced) recorded as
    the span ``epoch_launch``."""
    from sml_tpu_torch.data.formats import row_count
    from sml_tpu_torch.scripts.scale_sweep import sweep_launches
    from sml_tpu_torch.train.driver import SMLDriver
    from sml_tpu_torch.train.engine import _state_tensors
    from sml_tpu_torch.utils import profiling
    spec = ragged_dataset(tmp_path)
    counted = {"decay_adam_kernel": AK.decay_adam_cuda,
               "transfer_rows_kernel": TK.transfer_rows_cuda}
    runs = {}
    for name, fuse in (("program", {}), ("eager", dict(fuse_period=False))):
        cfg = SMLConfig(multi_num=3, mf_epochs=2, tr_epochs=1,
                        mf_batch_size=64, tr_batch_size=32,
                        eval_batch_size=64, latent_dim=16,
                        mf_sample="alone", fast_table_adam=True,
                        eval_scoring="masked", prefetch_periods=False,
                        saddle_retries=0,
                        profile_dir=str(tmp_path / f"trace_{name}"),
                        profile_period=2,
                        transfer=TransferConfig(latent_dim=16, fc_hidden=64),
                        **fuse)
        drv = SMLDriver(cfg, spec, device=card)
        eng, losses, states = drv.engine, [], []
        for kind in ("inner", "outer"):
            orig = getattr(eng, f"{kind}_epoch")

            def recorded(*a, _orig=orig, **k):
                st, lo = _orig(*a, **k)
                losses.append((k.get("program", False), lo))
                return st, lo
            setattr(eng, f"{kind}_epoch", recorded)

        def on_period_end(state, pass_id, d_time, driver):
            # not detached: the copies of Θ's leaves track gradients, and
            # the graphs into Θ they hold stay alive across period 1's
            # captures of the epoch programs (fault 15)
            states.append(([t.clone() for t in _state_tensors(state)],
                           state.mf_opt.count, state.tr_opt.count,
                           state.gen.get_state()))
        before = {k: w.launches for k, w in counted.items()}
        profiling.reset()
        drv.run(on_period_end=on_period_end)
        torch.cuda.synchronize()
        runs[name] = dict(
            states=states, losses=losses, stats=dict(eng.graph_stats),
            spans=profiling.summary(), cfg=eng.cfg,
            launches={k: w.launches - before[k] for k, w in counted.items()})
        profiling.reset()
        drv.close()
    got, want = runs["program"], runs["eager"]
    assert len(got["states"]) == len(want["states"]) == 3
    for (ga, *gb), (wa, *wb) in zip(got["states"], want["states"]):
        assert all(torch.equal(a, b) for a, b in zip(ga, wa))
        assert gb[:2] == wb[:2] and torch.equal(gb[2], wb[2])
    epochs = 2 * (2 + 1)                 # two branch C periods
    assert [p for p, _ in got["losses"]] == [True] * epochs
    assert [p for p, _ in want["losses"]] == [False] * epochs
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(got["losses"],
                                                           want["losses"]))
    stats = got["stats"]
    assert [stats[k] for k in ("programs", "captures", "warmups",
                               "program_phase0_epochs")] == [3, 3, 1, epochs]
    # period 0's copies of Θ's 16 leaves (conv_com) tracked gradients
    assert sum(t.grad_fn is not None for t in got["states"][0][0]) == 16
    # the phase program: period 0's first phase its warm-up, then a replay
    # for each other fused phase (3 + 2 + 2); and a replay each epoch
    assert stats["replays"] == 7 - 1 + epochs
    assert want["stats"]["program_phase0_epochs"] == 0
    derived = sweep_launches(spec, got["cfg"],
                             lambda kind, t: row_count(spec.path, kind, t),
                             True)
    for k in counted:
        assert got["launches"][k] == want["launches"][k] == derived[k], k
    # period 2 traced: its phase 0's three epochs replayed inside the
    # trace, its two other phases through the phase program
    assert got["spans"]["epoch_launch"]["count"] == 3
    assert got["spans"]["graph_launch"]["count"] == 2
    assert "epoch_launch" not in want["spans"]


def test_pool_draws_cover_the_pool_and_reserve_their_offset(card):
    """On the card the sampler's device-bounded draw (one 32-bit value
    below 2**32 - 1, modulo the pool size) covers every pool slot about
    evenly, and reserves the Philox offset ``draw_offset`` gives, the one
    ``randint(0, pool_size)`` reserves."""
    from sml_tpu_torch.ops.sampling import (PeriodIndex, draw_offset,
                                            pool_draws)
    for n in (1, 37, 300):
        index = PeriodIndex(torch.zeros(4096, dtype=torch.int64, device=card),
                            torch.tensor(n, device=card), None, None, None)
        gen = torch.Generator(card).manual_seed(2)
        start = gen.get_offset()
        draws = pool_draws(index, (1024, 16), gen)
        assert gen.get_offset() - start == draw_offset(1024, 16, card) > 0
        counts = torch.bincount(draws.flatten(), minlength=n).cpu()
        assert counts.shape[0] == n and int(counts.min()) > 0
        assert float(counts.max()) < 1.5 * 16384 / n + 20
        ref = torch.Generator(card).manual_seed(2)
        torch.randint(0, n, (1024, 16), device=card, generator=ref)
        assert ref.get_offset() == gen.get_offset()


def test_fused_replays_traced_after_an_earlier_trace(card, tmp_path):
    """A fused program captured after an earlier trace ended, then
    replayed inside a trace (what ``sml --profile-dir`` does for a later
    period): the process lives on (``utils/profiling.cupti_settings``) and
    the trace holds the replays' K1 kernels."""
    from sml_tpu_torch.utils.profiling import maybe_trace
    with maybe_trace(str(tmp_path / "first"), card):
        torch.randn(64, 64, device=card).sum().item()
    eng = _fused_engine(card)
    prep_t, prep_tt, val = _fused_inputs(eng)
    state = eng.snapshot_last(eng.init_state())
    state = eng.period_step(state, prep_t, prep_tt, 3, val)[0]
    assert [eng.graph_stats[k] for k in ("warmups", "captures",
                                         "replays")] == [1, 1, 2]
    with maybe_trace(str(tmp_path / "second"), card) as path:
        state = eng.period_step(state, prep_t, prep_tt, 2, val)[0]
    assert eng.graph_stats["replays"] == 4
    with open(path) as fh:
        trace = json.load(fh)
    k1 = [e for e in trace["traceEvents"]
          if "transfer_rows_kernel" in e.get("name", "")]
    assert len(k1) == 2 * 6


def test_traced_replay_after_two_traces(card, tmp_path):
    """Fault 8's reproducer: two traced blocks with work on the card (an
    eval set made and an attributed evaluation, as ``chip_smoke.py``'s
    ``split_eval``), then a program with IF nodes captured and replayed
    untraced, then replayed inside a third trace entered while those
    replays may still run. The process lives on, every trace holds its
    kernels (K2 in the second, the replays' K1 in the third)."""
    from sml_tpu_torch.utils.profiling import maybe_trace
    eng = _fused_engine(card)
    prep_t, prep_tt, val = _fused_inputs(eng)
    state = eng.snapshot_last(eng.init_state())
    masks = eng.new_entity_masks(np.arange(0, 500, 7), np.arange(0, 300, 5))
    rows = val.rows.cpu().numpy()[:100]
    paths = []
    with maybe_trace(str(tmp_path / "first"), card) as path:
        padded = eng.make_eval_set(rows + 0, build_mask=True)
        paths.append(path)
    with maybe_trace(str(tmp_path / "second"), card) as path:
        eng.evaluate_attributed(state.mf, padded, *masks)
        paths.append(path)
    state = eng.period_step(state, prep_t, prep_tt, 3, val)[0]
    assert [eng.graph_stats[k] for k in ("warmups", "captures",
                                         "replays")] == [1, 1, 2]
    with maybe_trace(str(tmp_path / "third"), card) as path:
        state = eng.period_step(state, prep_t, prep_tt, 2, val)[0]
        paths.append(path)
    assert eng.graph_stats["replays"] == 4

    def kernels(p, name):
        with open(p) as fh:
            return sum(1 for e in json.load(fh)["traceEvents"]
                       if e.get("cat") == "kernel" and name in e["name"])
    assert kernels(paths[1], "masked_rank_gather_kernel") > 0
    assert kernels(paths[2], "transfer_rows_kernel") == 2 * 6


def test_captured_phase_on_an_nccl_mesh_of_one_rank(card):
    """A world of one rank in this process, its mesh groups over NCCL: the
    state born row-sharded on a (1, 1) mesh, three fused phases
    (``phase_step``: the warm-up, a capture, a replay) against the same
    phases call by call on the same mesh, from one state and generator
    seed: tables, snapshots, Θ, moments, counts, the generator and the
    losses bit-equal, one capture."""
    import socket

    import torch.distributed as dist

    from sml_tpu_torch.models.transfer import theta_leaves
    from sml_tpu_torch.parallel import collective
    from sml_tpu_torch.parallel.multihost import init_distributed
    from sml_tpu_torch.parallel.sharding import make_mesh
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    saved = dict(collective.WORLD)
    init_distributed(f"127.0.0.1:{port}", 1, 0, device="cuda")
    try:
        mesh = make_mesh(1, 1)
        assert mesh.transport == "nccl"
        runs = []
        for fused in (True, False):
            eng = _fused_engine(card, eval_during_inner=False,
                                eval_during_outer=False)
            state = eng.init_state_sharded(mesh)
            assert eng.fused_program_warm() and eng.capture_refusal() is None
            prep_t, prep_tt, _ = _fused_inputs(eng)
            losses = []
            for _ in range(3):
                state = eng.snapshot_last(state)
                if fused:
                    state, il, ol = eng.phase_step(state, prep_t, prep_tt)
                else:
                    for _ in range(eng.cfg.mf_epochs):
                        state, il = eng.inner_epoch(state, *prep_t)
                    state = eng.refresh(eng.snapshot_hat(state))
                    for _ in range(eng.cfg.tr_epochs):
                        state, ol = eng.outer_epoch(state, *prep_tt)
                        state = eng.refresh(state)
                losses.append((il.clone(), ol.clone()))
            torch.cuda.synchronize()
            runs.append((state, losses, dict(eng.graph_stats)))
    finally:
        dist.destroy_process_group()
        collective.WORLD.clear()
        collective.WORLD.update(saved)
    (fs, fl, stats), (us, ul, _) = runs
    assert [stats[k] for k in ("programs", "warmups", "captures",
                               "replays")] == [1, 1, 1, 2]
    for a, b in zip(fs.mf, us.mf):
        assert torch.equal(a, b)
    for f in ("last_user", "last_item", "hat_user", "hat_item"):
        assert torch.equal(getattr(fs, f), getattr(us, f))
    ta, tb = theta_leaves(fs.theta), theta_leaves(us.theta)
    assert all(torch.equal(ta[k], tb[k]) for k in ta)
    for opt in ("mf_opt", "tr_opt"):
        a, b = getattr(fs, opt), getattr(us, opt)
        assert a.count == b.count
        for part in ("mu", "nu"):
            for k, t in getattr(a, part).items():
                assert torch.equal(t, getattr(b, part)[k]), (opt, part, k)
    assert torch.equal(fs.gen.get_state(), us.gen.get_state())
    for (fi, fo), (ui, uo) in zip(fl, ul):
        assert torch.equal(fi, ui) and torch.equal(fo, uo)


def test_mesh_program_captures_split_step_slots(card):
    """A world of one rank in this process, its mesh groups over NCCL: the
    phase program's step slots are split at their two cuts, so its
    capture holds three IF nodes per step slot (one without a mesh)."""
    import socket

    import torch.distributed as dist

    from sml_tpu_torch.parallel import collective
    from sml_tpu_torch.parallel.multihost import init_distributed
    from sml_tpu_torch.parallel.sharding import make_mesh
    from sml_tpu_torch.train import graphs
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    saved = dict(collective.WORLD)
    init_distributed(f"127.0.0.1:{port}", 1, 0, device="cuda")
    stats = []
    try:
        mesh = make_mesh(1, 1)
        for on_mesh in (True, False):
            eng = _fused_engine(card, eval_during_inner=False,
                                eval_during_outer=False)
            state = (eng.init_state_sharded(mesh) if on_mesh
                     else eng.init_state())
            prep_t, prep_tt, _ = _fused_inputs(eng)
            for _ in range(2):
                state, _, _ = eng.phase_step(eng.snapshot_last(state),
                                             prep_t, prep_tt)
            torch.cuda.synchronize()
            stats.append(dict(eng.graph_stats))
            eng.release_programs()
    finally:
        graphs.release_all()
        dist.destroy_process_group()
        collective.WORLD.clear()
        collective.WORLD.update(saved)
    for st, per_slot in zip(stats, (3, 1)):
        assert st["captures"] == 1 and st["step_slots"] > 0, st
        assert st["if_nodes"] == per_slot * st["step_slots"], st


def test_graphed_spmf_matches_eager(card, tmp_path, monkeypatch):
    """SPMF over three periods through its epoch program (one warm-up, one
    capture, replays) against its epochs called eagerly: tables, moments,
    the generator and the recalls equal."""
    from sml_tpu_torch.config import BaselineConfig
    from sml_tpu_torch.train import baselines
    spec = ragged_dataset(tmp_path)

    class Eager:
        def __init__(self, epoch, *_):
            self.epoch = epoch

        def run_taken(self, mf, opt, inputs, index, taken, gen):
            return self.epoch(mf, opt, *inputs, taken, gen, index)
    cfg = BaselineConfig(method="spmf", epochs=2, batch_size=64,
                         latent_dim=16, pool_size=300,
                         start_period=spec.online_test_start)
    runs = []
    for eager in (False, True):
        if eager:
            monkeypatch.setattr(baselines, "EpochProgram", Eager)
        drv = baselines.BaselineDriver(cfg, spec, device=card)
        drv.run()
        torch.cuda.synchronize()
        runs.append(drv)
    g, e = runs
    assert [g.graph_stats[k] for k in ("programs", "warmups",
                                       "captures")] == [1, 1, 1]
    assert g.graph_stats["replays"] >= 2
    assert all(torch.equal(a, b) for a, b in zip(g.mf, e.mf))
    assert g.opt.count == e.opt.count
    for part in ("mu", "nu"):
        for k, t in getattr(g.opt, part).items():
            assert torch.equal(t, getattr(e.opt, part)[k]), (part, k)
    assert torch.equal(g.gen.get_state(), e.gen.get_state())
    assert g.recall == e.recall


def test_spmf_draw_cdf_is_the_same_every_run(card):
    """SPMF's draw distribution over a pool-long vector: the same bits on
    every call, the CPU's in-order scan (``torch.cumsum`` of such a vector
    on the card varies from run to run)."""
    from sml_tpu_torch.train.baselines import draw_cdf
    p = torch.rand(300_000, generator=torch.Generator(card).manual_seed(1),
                   device=card)
    p = p / p.sum()
    first = draw_cdf(p)
    assert first.device == p.device
    assert all(torch.equal(first, draw_cdf(p)) for _ in range(5))
    assert torch.equal(first.cpu(), torch.cumsum(p.cpu(), 0))


def _slot_program(site, n=256, slots=4, inside=None):
    """A program of ``slots`` step slots, each an IF node whose body
    allocates its temporaries (from the IF bodies' pool) and adds ``(b +
    1) * x @ x`` into ``acc``; ``inside(b)`` runs in slot b's body (fault
    9's reproducers: the fused programs at their simplest)."""
    from sml_tpu_torch.train import graphs

    class Prog(graphs.Program):
        def __init__(self):
            super().__init__(site)
            dev = site.device
            g = torch.Generator().manual_seed(n + slots)
            self.x = (torch.randn(n, n, generator=g) / n ** 0.5).to(dev)
            self.acc = torch.zeros(n, n, device=dev)
            self.slots = graphs.SlotTable(slots, dev)

        def body(self, gen):
            self.acc.zero_()
            for b in range(slots):
                with graphs.step_if(self.slots, b) as run:
                    if run:
                        y = self.x @ self.x
                        self.acc.add_(y * float(b + 1))
                        if inside is not None:
                            inside(b)

        def run(self, taken, gen):
            self.slots.fill(taken)
            self.launch(gen)
            return self.acc

        def want(self, taken):
            return (self.x @ self.x) * float(taken * (taken + 1) // 2)
    return Prog()


def test_if_body_stream_differs_from_the_capture_stream(card):
    """Fault 10: the IF bodies' stream came from PyTorch's pool of 32
    streams, so once the process had made 31 more streams it was the
    capture stream itself and ``sml_if_begin`` failed. The capture takes
    a body stream that is not its own."""
    from sml_tpu_torch.train import graphs
    site = graphs.GraphSite(card)
    gen = torch.Generator(device=card)
    prog = _slot_program(site)
    prog.run(4, gen)                      # the warm-up makes site.stream()
    for _ in range(31):
        torch.cuda.Stream(card)
    for taken in (4, 2, 3):
        out = prog.run(taken, gen).clone()
        torch.cuda.synchronize()
        torch.testing.assert_close(out, prog.want(taken))
    assert site.stats["captures"] == 1
    prog.release()


def test_a_program_collected_during_another_capture(card):
    """Fault 9 (ROADMAP §3): a captured program that only the garbage
    collector can free (a reference cycle, as a program and its engine
    make) is collected inside another program's capture. Its
    graph destroyed and its pools given back there, that capture's end
    died of a segmentation fault. Now they are set aside until the
    capture ends: it and its replays go on right, and then the first
    program's graph and IF bodies' pool are freed."""
    import gc

    from sml_tpu_torch.train import graphs
    site = graphs.GraphSite(card)
    gen = torch.Generator(device=card)
    first = _slot_program(site)
    for _ in range(2):
        first.run(3, gen)                 # warm-up, capture and a replay
    torch.cuda.synchronize()
    first_capture = first.call.capture
    assert first_capture.opened == 4      # an IF node per slot
    first.cycle = first
    gc.disable()
    try:
        del first
        collected = []
        second = _slot_program(site, inside=lambda b: collected.append(
            (gc.collect(), len(graphs._DEFERRED))))
        out = second.run(4, gen).clone()  # captured: the site is warm
    finally:
        gc.enable()
    torch.cuda.synchronize()
    assert site.stats["captures"] == 2
    # collected in the first IF body, set aside until the capture ended
    assert collected[0][0] > 0 and collected[0][1] == 1
    assert not graphs._DEFERRED and first_capture.opened == 0
    torch.testing.assert_close(out, second.want(4))
    for taken in (1, 4):
        out = second.run(taken, gen).clone()
        torch.cuda.synchronize()
        torch.testing.assert_close(out, second.want(taken))
    second.release()


def test_release_right_after_a_replay(card):
    """Fault 9, hypothesis "release without a wait": a program released
    while its replay still runs (its graph reset, its pools given back),
    the cache emptied and the freed memory taken and written at once:
    the replay's result is right."""
    from sml_tpu_torch.train import graphs
    site = graphs.GraphSite(card)
    gen = torch.Generator(device=card)
    prog = _slot_program(site, n=4096, slots=8)
    want = prog.want(8)
    prog.run(8, gen)
    prog.run(8, gen)
    torch.cuda.synchronize()
    out = prog.run(8, gen)                # in flight: ~20 ms of products
    prog.release()
    torch.cuda.empty_cache()
    junk = [torch.full((4096, 4096), float("nan"), device=card)
            for _ in range(8)]
    torch.cuda.synchronize()
    torch.testing.assert_close(out, want)
    del junk


def test_if_bodies_reusing_a_block_stay_ordered(card):
    """Fault 9, hypothesis "pool blocks reused across slots": each slot's
    body allocates a 64 MB temporary, which the next slot's body takes
    again (the block freed when the body's tensor dies); the graph orders
    the IF nodes, so every slot reads its own values, replay after
    replay."""
    from sml_tpu_torch.train import graphs
    site = graphs.GraphSite(card)
    slots, n = 6, 1 << 24
    table = graphs.SlotTable(slots, card)
    sums = torch.zeros(slots, device=card)

    def body():
        sums.zero_()
        for b in range(slots):
            with graphs.step_if(table, b) as run:
                if run:
                    t = torch.full((n,), 2.0 ** b, device=card)
                    sums[b] = t.sum()
                    del t
    table.fill(slots)
    graphs.run_on(site.stream(), body)
    call = graphs.CapturedCall(body, site.stream())
    for taken in (6, 3, 6, 1) * 5:
        table.fill(taken)
        call.replay()
        got = sums.clone()
        torch.cuda.synchronize()
        want = torch.tensor([2.0 ** b * n if b < taken else 0.0
                             for b in range(slots)], device=card)
        assert torch.equal(got, want), (taken, got)
    call.release()


def test_pinned_fills_between_queued_replays(card):
    """Fault 9, hypothesis "pinned temporaries": 200 runs queued without
    a wait, each filling the slot table and the bias table from a pinned
    temporary the host drops at once; every replay reads its own run's
    values."""
    from sml_tpu_torch.train import graphs
    from sml_tpu_torch.train.optim import BiasTable, bias_corrections
    site = graphs.GraphSite(card)
    table = graphs.SlotTable(4, card)
    bias = BiasTable(4, card)
    seen = torch.zeros(4, 2, device=card)
    taken_seen = torch.zeros(4, device=card)

    def body():
        seen.copy_(bias.buf)
        taken_seen.copy_(table.dev.float())
    table.fill(4)
    bias.fill(0)
    graphs.run_on(site.stream(), body)
    call = graphs.CapturedCall(body, site.stream())
    hist, hist_taken = [], []
    for k in range(200):
        table.fill(k % 5)
        bias.fill(k)
        call.replay()
        hist.append(seen.clone())
        hist_taken.append(taken_seen.clone())
    torch.cuda.synchronize()
    for k in range(200):
        want = torch.tensor([bias_corrections(k + 1 + b) for b in range(4)],
                            device=card)
        assert torch.equal(hist[k], want), k
        assert hist_taken[k].tolist() == [float(b < k % 5)
                                          for b in range(4)], k
    call.release()


def _state_leaves(state) -> dict:
    """The state's tensors by name, without the generator's state."""
    from sml_tpu_torch.scripts.program_stress import state_tensors
    return {k: t for k, t in state_tensors(state).items() if k != "gen"}


def _state_values(state) -> dict:
    return {k: t.detach().clone() for k, t in _state_leaves(state).items()}


def _assert_same_values(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in got:
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   msg=k)


def test_capture_on_the_adopted_slot_after_an_eager_refresh(card):
    """A period captured on the state's own buffers (``SMLEngine.adopt``),
    then branch C's eager phase 0 writing into them (its refreshes into
    the tables), then a state handed in with tables refreshed into new
    buffers (copied into the slot): the replays run on the slot and the
    whole equals the same phases run call by call on another engine."""
    from sml_tpu_torch.models.mf import with_tables
    from sml_tpu_torch.models.transfer import apply_tables
    from sml_tpu_torch.train.engine import copy_state
    kw = dict(eval_during_inner=False, eval_during_outer=False)
    fused, plain = _fused_engine(card, **kw), _fused_engine(card, **kw)
    prep_t, prep_tt, val = _fused_inputs(fused)
    state = fused.adopt(fused.init_state())
    ptrs = {k: t.data_ptr() for k, t in _state_leaves(state).items()}
    ref = copy_state(state)
    state = fused.period_step(fused.snapshot_last(state), prep_t, prep_tt,
                              3)[0]
    ref = plain.snapshot_last(ref)
    for _ in range(3):
        ref = _eager_phase(plain, ref, prep_t, prep_tt, val)[0]
    # the period's final refresh, the next period's snapshot and its
    # eager phase 0, all into the slot
    state = fused.snapshot_last(fused.refresh(state))
    state = _eager_phase(fused, state, prep_t, prep_tt, val)[0]
    ref = plain.snapshot_last(plain.refresh(ref))
    ref = _eager_phase(plain, ref, prep_t, prep_tt, val)[0]
    assert {k: t.data_ptr() for k, t in _state_leaves(state).items()} == ptrs
    # the same refresh into new tables: copied into the slot, then replays
    new = apply_tables(state.theta, fused.cfg.transfer, state.last_user,
                       state.hat_user, state.last_item, state.hat_item)
    moved = state._replace(mf=with_tables(state.mf, *new))
    state = fused.period_step(moved, prep_t, prep_tt, 2)[0]
    for _ in range(2):
        ref = _eager_phase(plain, ref, prep_t, prep_tt, val)[0]
    torch.cuda.synchronize()
    assert {k: t.data_ptr() for k, t in _state_leaves(state).items()} == ptrs
    assert [fused.graph_stats[k] for k in ("programs", "warmups", "captures",
                                           "replays")] == [1, 1, 1, 4]
    assert fused.slot_copies["tables"] == sum(
        t.numel() * t.element_size() for t in new)
    assert all(fused.slot_copies[g] == 0
               for g in ("snapshots", "theta", "moments"))
    _assert_same_values(_state_values(state), _state_values(ref))
    assert torch.equal(state.gen.get_state(), ref.gen.get_state())


def test_release_programs_leaves_the_state_readable(card):
    """After ``release_programs`` (and ``graphs.release_all``) the state
    that the freed graphs ran on holds its values while the card reuses
    the freed memory, and the next program adopts it and runs on it."""
    from sml_tpu_torch.train import graphs
    from sml_tpu_torch.train.engine import copy_state
    kw = dict(eval_during_inner=False, eval_during_outer=False)
    eng, plain = _fused_engine(card, **kw), _fused_engine(card, **kw)
    prep_t, prep_tt, val = _fused_inputs(eng)
    state = eng.snapshot_last(eng.init_state())
    ref = copy_state(state)
    state = eng.period_step(state, prep_t, prep_tt, 3)[0]
    torch.cuda.synchronize()
    values = _state_values(state)
    eng.release_programs()
    graphs.release_all()
    assert eng._slot is None and not eng._programs
    junk = [torch.full((1 << 20,), float("nan"), device=card)
            for _ in range(16)]
    torch.cuda.synchronize()
    _assert_same_values(_state_values(state), values)
    del junk
    state = eng.period_step(state, prep_t, prep_tt, 2)[0]
    for _ in range(5):
        ref = _eager_phase(plain, ref, prep_t, prep_tt, val)[0]
    torch.cuda.synchronize()
    assert eng.graph_stats["captures"] == 2
    _assert_same_values(_state_values(state), _state_values(ref))


def test_two_hosts_capture_nccl_collectives_over_data(card):
    """Two simulated hosts (``run_world(hosts=2)``), a card a rank: the
    global mesh's 'data' axis crosses the hosts over NCCL, and an
    all-reduce and an all-gather over it, captured in one CUDA graph,
    replay bit-equal to their eager run, which equals the exact values.
    Needs two cards (a (2, 1) mesh; (2, 2) with four)."""
    from sml_tpu_torch.parallel.dryrun import run_world
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two cards: one simulated host a card")
    n = 4 if cards >= 4 else 2
    ranks = run_world("torch_parallel_workers:data_axis_capture", n,
                      "cuda", timeout_s=300, hosts=2)
    for r, res in enumerate(ranks):
        assert res["shape"] == (2, n // 2)
        assert res["ranks_data"] == [r % (n // 2), r % (n // 2) + n // 2]
        assert res["backend"] == res["transport_data"] == "nccl"
        assert len(set(res["cards"])) == n
        assert res["hosts"][0] != res["hosts"][-1]
        assert res["eager_exact"] and res["replay_equal"], res


def test_the_transport_rule_follows_the_cards_the_ranks_hold(card,
                                                             monkeypatch):
    """Two simulated hosts that both see the first card share it: gloo.
    With two cards or more each host sees its own and the world takes
    NCCL."""
    from sml_tpu_torch.parallel.dryrun import run_world
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    first = visible.split(",")[0] if visible else "0"
    with monkeypatch.context() as m:
        m.setenv("CUDA_VISIBLE_DEVICES", first)
        shared = run_world("torch_parallel_workers:host_layout", 2, "cuda",
                           timeout_s=300, hosts=2)
    for res in shared:
        assert res["cards"][0] == res["cards"][1] is not None
        assert res["backend"] == res["transport_data"] == "gloo"
        assert res["hosts"][0] != res["hosts"][1]
    if torch.cuda.device_count() < 2:
        return
    own = run_world("torch_parallel_workers:host_layout", 2, "cuda",
                    timeout_s=300, hosts=2)
    for res in own:
        assert len(set(res["cards"])) == 2
        assert res["backend"] == res["transport_data"] == "nccl"


def test_mesh_lookup_gradient_is_the_same_every_run(card):
    """The collective lookup's gradient (the dense table path under a
    mesh) adds a repeated id's rows in a fixed order: bit-equal over
    repeats on heavily repeated ids (~1,024 rows an id), within 1e-3 of
    the f64 sum (f32 sums of ~1,024 N(0,1) terms); before, its atomic
    scatter-add made an eager and a replayed step differ."""
    from sml_tpu_torch.parallel.collective import lookup_rows, owned_rows
    g = torch.Generator().manual_seed(5)
    table = torch.randn(64, 32, generator=g).to(card)
    idx = torch.randint(0, 64, (65536,), generator=g).to(card)
    w = torch.randn(65536, 32, generator=g).to(card)
    grads = []
    for _ in range(5):
        t = table.clone().requires_grad_()
        rows, safe, in_range = owned_rows(t, idx, None, torch.float32)
        out = lookup_rows(t, rows, safe, in_range)
        (grad,) = torch.autograd.grad(torch.sum(out * w), [t])
        grads.append(grad)
    for grad in grads[1:]:
        assert torch.equal(grad, grads[0])
    want = torch.zeros(64, 32, dtype=torch.float64).index_add_(
        0, idx.cpu(), w.cpu().double())
    assert (grads[0].cpu().double() - want).abs().max() < 1e-3
