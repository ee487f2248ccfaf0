"""Typed configuration, field for field the same as ``sml_tpu/config.py``.

The port keeps its own copy (it imports nothing of ``sml_tpu``) with the
same class names, field names and defaults, so a configuration means the
same thing in both packages.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence


@dataclass(frozen=True)
class DataSpec:
    """On-disk dataset contract (``data/formats.py``):

    * ``<root>/<name>/information.npy`` — ``[n_interactions, n_users, n_items]``
    * ``<root>/<name>/train/<p>.npy`` — ``(N_p, 2)`` ``[user, item]`` rows
    * ``<root>/<name>/test/<p>.npy`` — ``(M_p, 2 + neg_num)`` rows
      ``[user, pos_item, neg_1..neg_k]``
    """

    root: str
    name: str
    num_periods: int
    online_train_start: int
    online_test_start: int
    eval_neg_num: int = 999

    @property
    def path(self) -> str:
        return f"{self.root.rstrip('/')}/{self.name}"


# Crossover of the row-sparse dense-Adam path (``SMLConfig.fast_table_adam``
# left at None): at this many combined table rows it beat the dense-gradient
# path on the JAX package's TPU v5e. The port keeps the same rule so that one
# config means one path in both packages; its crossover on the H100 is
# measured by ``chip_smoke.py`` and recorded in PERF.md, not applied here.
FAST_TABLE_ADAM_AUTO_ROWS = 1_000_000

# the fast path's duplicate collapse grows with the (2*batch) gathered rows;
# above this batch size the auto rule stays on the dense path
FAST_TABLE_ADAM_MAX_BATCH = 2048


def resolve_fast_table_adam(flag: Optional[bool], n_rows: int,
                            batch_size: int = 0) -> bool:
    """``flag`` when set, else the auto rule above."""
    if flag is not None:
        return flag
    return (n_rows >= FAST_TABLE_ADAM_AUTO_ROWS
            and batch_size <= FAST_TABLE_ADAM_MAX_BATCH)


@dataclass(frozen=True)
class TransferConfig:
    """Transfer network Θ. ``conv_com`` (the paper architecture) stacks
    ``[x_t, x_hat, x_com]`` per row, mixes 3 -> ``conv1_channels`` ->
    ``conv2_channels`` with GELU(x·σ(1.702x)), flattens channel-major and
    runs FC(conv2_channels·d -> fc_hidden) -> FC(fc_hidden -> d); separate
    user and item towers."""

    latent_dim: int = 64
    conv1_channels: int = 10
    conv2_channels: int = 5
    fc_hidden: int = 512
    # 'conv_com' | 'conv2ch' | 'conv_com_root' | 'mlp_delta' | 'linear'
    # | 'gru' | 'gated' (models/transfer.py)
    kind: str = "conv_com"


@dataclass(frozen=True)
class SMLConfig:
    """Hyper-parameters of the alternating SML loop (reference Yelp
    defaults)."""

    multi_num: int = 10

    # inner (MF) training
    mf_lr: float = 0.01
    mf_epochs: int = 1
    mf_l2: float = 1e-6
    mf_batch_size: int = 1024
    latent_dim: int = 64
    mf_sample: str = "all"
    mf_epochs_when_tr_stopped: int = 2

    # outer (transfer) training
    tr_lr: float = 0.001
    tr_l2: float = 1e-4
    tr_epochs: int = 1
    tr_batch_size: int = 256
    tr_sample_type: str = "alone"
    tr_stop: bool = False
    load_w_hat: bool = False

    transfer: TransferConfig = field(default_factory=TransferConfig)

    use_bce: bool = True
    replay_mode: bool = False
    prefetch_periods: bool = True
    # row-sparse table Adam (kernel K3 on the card); None: the auto rule
    # of resolve_fast_table_adam
    fast_table_adam: Optional[bool] = None
    uniform_shapes: bool = True
    # content-keyed reuse of uploaded eval sets (SMLEngine.make_eval_set)
    upload_dedup: bool = True
    # the fused phase and period programs (SMLEngine.phase_step /
    # period_step): each phase the unfused path's calls on fixed buffers,
    # on the card one CUDA graph per run, captured once and replayed; the
    # same numbers, draws and records as the unfused path, under a mesh
    # too. fuse_phases=False turns every fused route off. fuse_period:
    # True fuses whole periods (on the CPU the phase function runs
    # eagerly: its plain version; it raises on a card shared by a mesh's
    # ranks, whose gloo collectives are not captured:
    # SMLEngine.capture_refusal);
    # False fuses phases one by one (when fuse_phases and no in-training
    # evals; unfused on a card under a mesh of ranks sharing it); "auto"
    # (default) fuses on a CUDA engine with no mesh or an NCCL mesh (a
    # card per rank) and runs the eager per-phase path on the CPU and on
    # a card shared by the mesh's ranks (SMLEngine.fused_program_warm). No
    # marker file: in JAX "auto" waited for a first XLA compile of
    # minutes; a capture costs about one eager phase.
    fuse_phases: bool = True
    fuse_period: bool | str = "auto"
    refresh_after_outer_epoch: bool = True
    eval_during_inner: bool = False
    eval_during_outer: bool = False

    # evaluation
    topk: Sequence[int] = (5, 10, 20)
    eval_batch_size: int = 1024
    # candidate-scoring mode (eval/evaluator.py SCORING_MODES)
    eval_scoring: str = "auto"
    # item-count bound for auto-building candidate masks
    eval_mask_max_items: int = 262_144
    attributed_eval: bool = False

    neg_tries: int = 16
    pass_num: int = 1
    multipass_stop_stage: Optional[int] = None
    profile_dir: Optional[str] = None
    profile_period: int = 0
    log_norms: bool = False

    seed: int = 2000
    theta_seed: Optional[int] = None

    theta_warmstart_steps: int = 0
    theta_warmstart_rows: int = 4096
    theta_warmstart_lr: float = 1e-3

    saddle_retries: int = 0
    saddle_mode: str = "auto"
    saddle_tau: float = 0.23
    saddle_escalate_warmstart: bool = False
    saddle_warmstart_steps: int = 400
    saddle_check_phase: int = 3
    saddle_frac: float = 0.88
    saddle_final_frac: float = 0.78

    # numerics
    dtype: str = "float32"
    # storage dtype of the last/hat snapshots ("float32" | "bfloat16");
    # all math runs in f32, rows are upcast at the refresh boundary
    snapshot_dtype: str = "float32"
    emb_init_scale: float = 1.0

    def replace(self, **kw) -> "SMLConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class PretrainConfig:
    """Pretraining of the base MF model (reference
    ``model/baseline.py:161-223``): BCE + per-side L2, Adam, early stopping
    on recall@20 measured every ``eval_every`` epochs."""

    lr: float = 0.01
    l2_user: float = 1e-5
    l2_item: float = 1e-5
    batch_size: int = 256
    max_epochs: int = 200
    eval_every: int = 2
    patience: int = 50              # eval rounds without a new best
    seed: int = 2000
    latent_dim: int = 64
    neg_tries: int = 16
    emb_init_scale: float = 1.0
    eval_scoring: str = "gather"


@dataclass(frozen=True)
class BaselineConfig:
    """Full-retrain / fine-tune / SPMF baselines
    (``model/baseline.py:102-556``)."""

    method: str = "full"            # 'full' | 'fine' | 'spmf'
    lr: float = 0.01
    l2_user: float = 1e-5
    l2_item: float = 1e-5
    epochs: int = 20
    batch_size: int = 256
    neg_num: int = 1
    pool_size: int = 0              # reservoir size (spmf only)
    # 0: warm by reservoir update (yelp), 1: fill with the latest (news)
    pool_init_type: int = 0
    start_period: int = 30          # yelp 30, adressa 48
    early_stop: bool = False        # the reference breaks only when pool_init_type == 1
    topk: Sequence[int] = (5, 10, 20)
    eval_batch_size: int = 1024
    latent_dim: int = 64
    seed: int = 2000
    neg_tries: int = 16
    emb_init_scale: float = 1.0
    eval_scoring: str = "gather"


def yelp_data(root: str) -> DataSpec:
    """Yelp: 40 periods, online-train from 10, online-test 30-39."""
    return DataSpec(root=root, name="yelp", num_periods=40,
                    online_train_start=10, online_test_start=30)


def adressa_data(root: str) -> DataSpec:
    """Adressa ("news"): 63 periods, online-train from 21, online-test
    48-62."""
    return DataSpec(root=root, name="news", num_periods=63,
                    online_train_start=21, online_test_start=48)


def yelp_sml() -> SMLConfig:
    """README yelp command: ``--MF_epochs=1 --TR_epochs=1 --multi_num=10``."""
    return SMLConfig(multi_num=10, mf_epochs=1, tr_epochs=1)


def adressa_sml() -> SMLConfig:
    """README adressa command: ``--MF_epochs=2 --TR_epochs=2 --multi_num=7``."""
    return SMLConfig(multi_num=7, mf_epochs=2, tr_epochs=2)
