"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips where there is no CUDA card, so on a
CPU-only host they count as skipped. On a GPU host run them without the
JAX conftest (this file imports no JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: K1 1e-4 (f32 sums over C2*d and H terms in another order);
K2 exact on integer-valued tables.
"""

import pytest
import torch

from sml_tpu_torch.config import SMLConfig, TransferConfig
from sml_tpu_torch.models.transfer import init_transfer
from sml_tpu_torch.ops import eval_kernel as E
from sml_tpu_torch.ops import transfer_kernel as TK

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,n", [(16, 77), (64, 1000)])
def test_transfer_kernel_matches_plain(card, d, n, dtype):
    th = init_transfer(torch.Generator().manual_seed(1),
                       TransferConfig(latent_dim=d), device=card)
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
    it = torch.zeros(d, ipad)
    it[:, :n_items] = torch.randint(-2, 3, (d, n_items), generator=g).float()
    ss = torch.randint(-5, 6, (rows, 1), generator=g).float()
    neg = torch.argsort(torch.rand(rows, n_items, generator=g), dim=1)[:, :99]
    mask = E.build_packed_mask(neg.to(card), n_items)
    assert torch.equal(mask.cpu(), E.build_packed_mask(neg, n_items))
    before = E.masked_rank_cuda.launches
    got = E.masked_rank(ue.to(card, dtype), it.to(card, dtype), ss.to(card),
                        mask)
    assert E.masked_rank_cuda.launches == before + 1
    want = E.masked_rank_plain(ue.to(dtype), it.to(dtype), ss, mask.cpu())
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
