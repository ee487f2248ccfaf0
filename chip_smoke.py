#!/usr/bin/env python3
"""Drive the port's paths once on one NVIDIA GPU: serving, the training
sweep, the eval-design probes, the pretrainer, the baselines, every
transfer kind, ingest into an attributed, profiled ``sml`` run, the
engine at production scale, the Adressa and Yelp-scale protocol scripts,
and the parallel layer (two ranks sharing the card, and the multi-process
CLI).

Run from the repository root, on a host with one CUDA card:

    python3 chip_smoke.py

Phases, one JSON line each:

1. env      torch/CUDA versions, the card, its power limit.
2. build    nvcc builds ``sml_tpu_torch/csrc/*.cu`` (timed).
2b. sanitize  ``python -m sml_tpu_torch.scripts.sanitize --all`` in
            subprocesses: ptxas's registers and spills of every kernel
            with and without ``-lineinfo`` (equal); the guard-page fence
            proved (an over-run and an under-run of K3's C entry must die
            of an illegal address), then every kernel target (K1, K2, K3,
            P1, P2, P3 on their edge cases, each call repeated and held
            bit-equal, then to its plain version) under the fence at the
            tail and at the head of every allocation. An error, a failed
            run or a fence that misses its probe fails the phase.
            compute-sanitizer is not run here (``--tools none``): on the
            H100 machine it refuses the device, as ``PERF.md`` records;
            ``sanitize.py --all`` runs its tools where it does. The
            phase's line says so (``compute_sanitizer``).
3. K1       ``transfer_rows_kernel`` against its plain PyTorch version at
            the Yelp refresh shape (100,000 user + 20,000 item rows, d=64,
            C1=10, C2=5, H=512), f32 and bf16 snapshots, and on a grid of
            widths, channel counts and hidden sizes (``K1_GRID``); times
            eager and by CUDA-graph replay, a products-only ``torch.matmul``
            yardstick, bound, the build's registers and blocks per SM, and
            times with bounds at d = 128 and 256.
4. K2       ``masked_rank_gather_kernel`` against its plain version at
            B=1024, I=20,000, d=64, 999 distinct negatives per row: exact
            on integer-valued f32 and bf16 tables, and equal there to the
            dense design (P1's ``<f32, 64, ij>``); near-exact on random
            ones; exact on a ``EDGE_ROWS``-row batch of edge-case masks (no
            bit, every item, one 16-byte chunk, the last chunk, every
            other item: ``ops.edge_cases.k2_edge_rows``). Times of
            f32, bf16, an empty mask, the dense design and a
            ``torch.matmul`` yardstick, each eager and by CUDA-graph
            replay; the build's registers and blocks per SM; bound.
5. slice    ``SMLEngine(device="cuda")`` with masked scoring: snapshot,
            refresh (K1), a 16,384-row leave-one-out test (K2, one launch
            per 1024-row batch), then
            ``recommend`` top-20 for 4 batches of 1024 users. The launch
            counters are zeroed just before and read just after; the same
            slice runs on the CPU through the plain versions and the two
            are held together.
6. K3       ``decay_adam_kernel``, one launch over the four Yelp MF leaves
            ((100,000, 64), (20,000, 64), (100,000, 1), (20,000, 1)) as
            ``sparse_dense_adam_update`` makes it (the bias corrections
            read on the card from a ``BiasTable``, as the optimizer's
            steps pass them), against its plain version at step 7 (the
            host's floats): ``mu``/``nu`` bit-equal, ``p`` within rtol
            1e-6 (and counted where not bit-equal); times per 4-leaf step
            by eager launches and by CUDA-graph replay, bound, and a fused
            ``torch.optim.Adam`` yardstick timed both ways.
7. crossover one inner step at the Yelp shape with ``fast_table_adam`` on
            (K3) and off (dense gradients), for the auto rule's crossover.
8. train-lockstep  one replay-mode SML phase at full Yelp width on the
            card and on the CPU: snapshot -> inner epoch (8 steps at
            B=1024) -> snapshot -> refresh -> outer epoch (16 steps at
            B=256) -> refresh. K3 launches 8 (one per fast step), K1
            launches 4; tables and Θ
            within 1e-4 of the CPU run, per-batch losses within rtol 1e-5.
9. train-sweep  ``SMLDriver`` (what ``python -m sml_tpu_torch sml`` runs)
            on a seeded synthetic dataset written to a temporary
            directory: 100,000 users, 20,000 items, 4 periods (one
            warm-up, two test periods) of different row counts
            (``SWEEP_TRAIN_ROWS`` train and ``SWEEP_TEST_ROWS`` test rows:
            every period's inner and outer epochs take another number of
            steps), ``yelp_sml()`` with ``fast_table_adam`` and masked
            scoring at ``SWEEP_MULTI_NUM`` phases a period (the preset's
            10 cut to 3), pinned to the unfused path (``fuse_phases=False,
            fuse_period=False``: its epochs are wrapped and timed, which a
            CUDA-graph replay never enters, so its step times stay
            comparable with the earlier runs). Launch counts must equal
            those derived from the data (K3: one per fast step, 132; K1
            42; K2 32: one per eval batch); losses finite, metrics in
            [0, 1].
            The data carry no signal, so training drives the loss to the
            BCE saddle (2 ln 2) and the item rows together (scores tie,
            and the strictly-greater rank then counts every target a
            hit), as the JAX package does on such data; the line prints
            the last outer loss, the item table's spread and each test
            record.
            With two test periods the summary's test side is empty (the
            reference averages test periods [N3:-1]) and reads 0.
9b. fused-sweep  the same dataset, seed and configuration with the
            default ``fuse_period="auto"``, which fuses on the card: each
            period's phases through ``SMLEngine.period_step`` (branch C's
            phase 0 epoch by epoch, each epoch a replay of an epoch
            program of its own, the test between them), the run's first
            phase eagerly on the capture stream, then one CUDA graph for
            the whole sweep, replayed in every period whatever its step
            counts (the steps past a period's real batches are IF nodes
            the card skips). It prints the programs, captures, replays and
            warm-ups (three programs, a capture each and one warm-up for
            the sweep, a replay for every other fused phase and every
            phase-0 epoch), each period's inner and outer step counts
            (all different), both sweeps' period and
            sweep walls, the max differences of the final tables,
            snapshots, Θ and Adam moments against the unfused sweep
            (within ``FUSED_ATOL``; bit equality expected), whether the
            step counts and the generators' positions are equal, each
            fused phase's losses against the unfused epochs' (rtol
            ``LOSS_RTOL``), the tests' hit differences (at most
            ``SLICE_HIT_TOL``) and the K1/K2/K3 launches, replays counted,
            against those derived from the data, and per
            ``period_step`` call its wall, warm-up and capture seconds
            and from them the wall ms per replay.
9c. fused-evals  period 0 of the same sweep (branch A) with evals of
            the val set after every inner and outer epoch, ``log_norms``
            and ``saddle_retries=1``, unfused and then fused: K2, the eval
            sums and the seven norms inside the captured phase, the
            guard's stalled attempt (the data drive the loss to the
            saddle, so the guard stalls); the retry's new buffers and
            generator are copied into the same program and replayed (one
            capture for both attempts). The fused run is held to the
            unfused one:
            the retries used, every ``inner_eval``/``outer_eval``/
            ``phase``/``saddle_retry`` record (kinds, order, epochs and
            phases equal; eval metrics within ``SLICE_HIT_TOL`` hits,
            losses and norms within ``LOSS_RTOL``), the final state within
            ``FUSED_ATOL`` and the generators' positions; each run's K1,
            K2 and K3 launches against those derived from the phases it
            ran (the fused guard runs the stalled attempt's every phase),
            and each ``period_step`` call's launches against its warm-up
            and replays.
9d. mesh-fused  the fused programs under a mesh: a world of one rank
            in this process, its mesh groups over NCCL (the card its
            own), on the sweep dataset's first ``MESH_PERIODS`` periods
            with ``log_norms`` and ``MESH_MULTI_NUM`` phases a period (cut
            for time): the state born row-sharded on a (1, 1)
            mesh, the sweep unfused, then with the default ``"auto"``,
            which captures the program with its collectives in the
            structure a mesh of several cards captures
            (``scripts/multicard_check.py`` runs those): each step slot
            split at its collectives into three IF nodes, the
            collectives (local on one rank) between them. The fused run
            against the unfused
            one: state within ``FUSED_ATOL`` (bit equality expected),
            counts and generators equal, every phase and test record
            within ``LOSS_RTOL``, launches equal to each other and to
            those derived from the data; three programs (the phase program
            and phase 0's epoch programs), a capture each and one warm-up,
            a replay for every other fused phase and every phase-0 epoch,
            three IF nodes per step slot (printed, with the captures'
            seconds). Then
            the graphs are released and the process group destroyed.
10. P1      every instantiation of the dense ``masked_rank_kernel`` that
            the eval-design probe ``eval_kernel_probe`` runs (rows per
            block 64 or 128, grid order ij or ji, f32 on the CUDA cores or
            bf16 on the tensor cores) at the probe's shape (16,384 rows x
            20,480 items, d=64, 999 negatives), each exact against K2's
            plain version on integer tables and within
            ``K2_RANDOM_FLIPS_PER_16K`` flips on N(0,1) ones; eager times,
            CUDA-graph times of v0 and v1_bf16, the f32 and bf16 bounds and
            dense floors, f32 ``torch.matmul`` and bf16 ``torch.mm`` (f32
            out) yardsticks, the build's registers and blocks per SM, the
            SM clock and power nvidia-smi samples under v0 and v1_bf16. Then
            the probe itself
            (``python -m sml_tpu_torch.scripts.eval_kernel_probe``) with
            its launches counted.
11. P3      ``dense_mask_rank_kernel`` against its plain version on 16
            batches of 1024 rows, I_pad=20,480, 1,001 distinct candidates
            per row, the target included: exact on integer tables and on
            an ``EDGE_ROWS``-row batch of edge-case masks, at most
            ``K2_RANDOM_FLIPS_PER_16K`` flips on random ones; times of the
            kernel, an empty mask and a matmul of the scores as yardstick,
            each eager and by CUDA-graph replay; the build's registers and
            blocks per SM; bound.
12. P2      ``candidate_scores_kernel`` (the probe's whole scorer: user
            gather, candidate gather, scores) against its plain version on
            16 batches of B=1024, C=1001, U=100,000, I=20,000, d=64, bf16,
            on the probe's int64 strided ids: exact on integer tables,
            within 1e-4 on N(0,1) ones, bit-equal on the same ids as
            contiguous int32; exact on a batch with ids outside both
            tables (NaN where the plain version has NaN) and on every pair
            of ``P2_ODD_B`` rows and ``P2_ODD_C`` candidates. Eager and
            graph times of the scorer (one launch of the kernel) as the
            probe calls it and on contiguous int32 ids
            (``scripts/scorer_timing.py``), the device kernels one scorer
            call launches by ``torch.profiler`` (checked: one), a one-row
            call (every id 0) and from it the L2 gather rate, the gather floor at the best L2 rate of the
            K2 and P3 phases beside the bound (int64 and int32 ids), the
            library route (user gather, bf16 ``torch.mm`` of all scores,
            ``torch.gather``: three calls) eager and by graph, the build's
            registers and blocks per SM.
13. eval-probes  ``python -m sml_tpu_torch.scripts.eval_variants`` at its
            defaults (16,384 rows, 100,000 users, 20,000 items, 1,000
            candidates) for ``PROBE_ROUNDS`` rounds: every variant runs,
            and P2's and P3's launches equal 16 per evaluation.
14. pretrain ``pretrain_mf`` on a seeded ``generate_synthetic_dataset`` at
            the Yelp widths (``PRE_PERIODS`` periods of ``PRE_ROWS``
            interactions, the test from period ``PRE_TEST``): recall@20
            above random (20/1,000) by ``PRE_RECALL_Z`` standard errors of
            its measurement on ``PRE_ROWS`` rows; no K3 launch (the auto rule
            keeps 120,000 table rows on the dense path); its epochs run
            through one epoch program (the warm-up, one capture, replays;
            the counts and the wall printed). Then ``PRE_GRAPH_EPOCHS``
            dense and forced ``fast_lr`` plain epochs from the best tables
            through an epoch program and eagerly from one generator seed:
            tables, moments and generators equal, the program one warm-up,
            one capture and replays; eager step ms and the last (a replay
            alone) epoch's step ms; K3 launches one per fast step on both
            routes.
15. baselines ``BaselineDriver`` full, fine and spmf over the two periods
            after the pretrain period, from the pretrained tables: two
            attributed ``baseline_test`` records each (the dataset ships
            new-entity ids), metrics in [0, 1], full retrain above random
            by ``BASE_RECALL_Z`` standard errors; each method through one
            epoch program (spmf's: its pool and draw distribution as
            buffers, ``round(N/B)`` of its step slots taken), one warm-up
            and one capture each, their counts printed, and the ms of
            spmf's draw distribution scanned on the host before each epoch
            (``baselines.draw_cdf``, timed alone). Then each method
            over ``BASE_GRAPH_EPOCHS`` epochs a period, through the program
            and with the epochs called eagerly: tables, moments, recalls
            and generators equal, one capture for the run, both walls.
16. transfer-kinds  each of the seven transfer kinds at the Yelp widths
            (H = 1024 for conv_com_root, 512 otherwise, as the ``sml``
            CLI sets it): one full-table refresh of 100,000 + 20,000 rows
            and one replay-mode outer (Θ) step at B=256 on the card and on
            the CPU; refresh within ``KINDS_TOL``, Θ after the step within
            ``KINDS_TOL``, the loss within ``LOSS_RTOL``; K1 launches 2 per
            refresh for conv_com and 0 for the others; the refresh's wall
            ms on the card.
17. ingest-sweep  a seeded raw CSV log (header, non-dense 64-bit ids,
            100,000 users and 20,000 items, rows out of time order,
            ``INGEST_PERIOD_EVENTS`` per period of a 4-period time split)
            through ``python -m sml_tpu_torch ingest`` (timed; the test
            file's contract checked: 999 distinct negatives per row, none
            in the user's history), then the ``sml`` CLI on its output
            (one warm-up and one test period, conv_com_root,
            ``--attributed-eval``, masked scoring; the table Adam by the
            CLI's own row-count rule, which keeps 120,000 rows on dense
            gradients), twice: untraced, then with ``--profile-dir``. Each
            run's K2, K3 and K1 launches equal those derived from the data
            and the CLI's config (K3 and K1 none here: the train sweep
            drives them), each ``test`` record is followed by its
            ``test_attribution`` record, the ``_of_test`` buckets sum to
            recall@20 within 1e-5; one trace holds the engine calls'
            spans. From the trace: the device's busy ms in the traced
            period (union of kernel intervals) over that period's traced
            and untraced wall, the five kernels with the most time and the
            wall ms of each span; then ``make_eval_set`` of the test file
            and an attributed evaluation of it, each called directly under
            the profiler, with the engine's own spans inside
            ``make_eval_set`` (the id check, hash, padding and upload,
            mask).
17b. scale  the JAX package's one-chip production shape (5,000,000
            users x 1,000,000 items, d=64, bf16 snapshots, two phases, a
            4,096 x 1,001 test: ``SCALE_ARGS``) through the core of
            ``python -m sml_tpu_torch.scripts.scale_engine_run``, the
            launch counters zeroed just before and read just after: the
            auto rule must resolve the row-sparse Adam (6M rows), K3
            launch once per inner step and K1 twice per refresh, K2 never
            (1M items > the 262,144-item mask cap: the gather path);
            losses finite; the final tables within ``K1_TOL`` of K1's
            plain version on the snapshots on each side's first and last
            ``SCALE_SAMPLE`` rows and as many at random; the card's ranks
            of ``SCALE_RECOUNT`` test rows on the final tables within the
            f32 rounding bounds of an f64 recount on the CPU (the
            untrained refresh pulls the rows within a few units of the
            last place of each other, so most ranks there are rounding:
            the line counts them), and the hits of the same rows on the
            run's first tables (drawn again from the seed) equal on the
            card and the CPU; top-``SCALE_K`` serving of ``SCALE_SERVE``
            users (ms a batch, peak), ``SCALE_CHECK`` of them equal to a CPU
            top-K but at ties (``PAR_TIE``); the inner step at 6M rows
            with the row-sparse path and with dense gradients. Then K2 at
            the cap: an engine of ``CAP_USERS`` x ``CAP_ITEMS`` with
            masked scoring evaluates ``CAP_ROWS`` rows (its launches
            counted), its hits and ranks equal to the gather path's on
            integer-valued tables. Then past 2^31 elements: K3 on one
            ``EDGE_TABLE_ROWS`` x 64 f32 table and K1 on as many bf16
            rows, each against its plain version on ``EDGE_WINDOW`` rows
            at the start, on both sides of element 2^31 and at the end
            (K3 ``mu``/``nu`` bit-equal, ``p`` rtol ``K3_RTOL``; K1
            ``K1_TOL``), with their ms and bounds. Peak memory and
            seconds of each part. Then top-``SCALE_K`` over
            ``SERVE5M_ITEMS`` items on the card for one batch of
            ``SCALE_SERVE`` users (N(0,1) tables), f32 and bf16 inputs:
            ms a batch, the peak, and ``SCALE_CHECK`` users' ids equal to
            a CPU top-K (its inputs rounded the same way) but at ties.
            Last, ``SMLDriver`` at the one-card shape (5M x 1M, bf16
            snapshots: ``SCALE_SWEEP_ARGS``, a cut depth of
            ``python -m sml_tpu_torch.scripts.scale_sweep``, through its
            functions): a synthetic dataset of 3 periods of 100,000
            interactions (tests of 999 negatives in periods 1 and 2), the
            sweep eager (no program) and then fused by ``"auto"``, each
            from the seed: every leaf's digest (per block of rows, an f64
            sum and a ``blake2b`` of the bytes) equal, the test hits and
            the losses equal, one capture for the fused program, K1 and
            K3 launches as derived from the configuration, the data and
            the guard's retries (``scale_sweep.sweep_launches``),
            the fused peak no more than ``scale_sweep.PEAK_RATIO`` x the
            eager one, and no byte of Θ or the moments copied into the
            programs' state slot (``SMLEngine.slot_copies``) in any
            period.
17c. protocols  the port's protocol scripts
            (``scripts/adressa_run.py``, ``scripts/yelp_scale_sweep.py``)
            through their phase functions at the protocols' full widths
            and a cut depth (``PROTO_ADRESSA_CUT``, ``PROTO_YELP_CUT``):
            gen and pretrain, then the sweep with ``--fuse-period on``
            (one phase program for the run, and phase 0's inner and
            outer epoch programs) and ``off`` (the eager path, no
            program), each with its jsonl records: records and
            ``results.json`` entries equal but for clocks, final state
            (tables, snapshots, Θ, moments, counts, generator) bit-equal,
            three programs and a capture each for the fused run and none
            for the eager one, and in both runs the K1 and K2
            launches the configuration implies (K1 two per refresh; K2 one
            per batch of every in-training eval and test: Yelp-scale only,
            whose 21,000 items take packed masks; K3 none, the auto rule
            keeps these tables on dense gradients). Then the baselines:
            Adressa's three for ``PROTO_BASE_PERIODS`` test period with
            ``pool_init_type=1`` (the early stop), Yelp-scale's fine.
            Seconds and peak memory of each run.
18. parallel  four worlds spawned with a timeout each
            (``parallel.dryrun.run_world``): R=1; two ranks sharing the
            card over gloo on a (1, 2) mesh (tables row-sharded, the
            refresh on 50,000 + 10,000-row blocks); two on (2, 1) (data
            parallel); two simulated hosts (``run_world(hosts=2)``) on
            their global mesh, (2, 1), both seeing the one card, so gloo
            by the transport rule (on two cards or more: a card a host,
            NCCL, two phases fused against a one-rank reference of two
            phases; (2, 2) on four), each rank's host and each axis's
            transport printed. Each runs the train-lockstep phase's replay phase
            (8 inner steps at B=1024 with ``fast_table_adam``, 16 outer
            steps at B=256), then the 16,384-row masked test (999 distinct
            negatives) and top-20 serving of 4 x 1024 users. Each two-rank
            world is held to R=1: tables and Θ within ``TRAIN_ATOL``,
            losses within ``LOSS_RTOL``, hit counts within
            ``SLICE_HIT_TOL``, served id sets equal except where R=1's
            scores tie (``PAR_TIE``), served scores within
            ``PAR_SCORE_ATOL`` of dense serving on the world's own tables;
            launches per rank equal those derived (K1 4: 2 per refresh;
            K3 8: 1 per fast step; K2 16 / 8: one per eval batch of the
            rank's block of the test); each world's wall time and each
            axis's transport printed. Each rank of a two-rank world first
            runs all-reduce, all-gather and broadcast on CUDA tensors over
            gloo and checks their values (the port hands gloo its CUDA
            tensors as they are; gloo stages them through pinned host
            memory inside itself). On those ranks the driver's fusion
            rule keeps ``"auto"`` unfused and ``fuse_period=True`` raises,
            naming gloo and the way out (``fuse_period=False``); on R=1
            ``"auto"`` fuses. Then
            ``python -m sml_tpu_torch
            --coordinator ... sml`` and ``rank --shard`` as two processes
            on the card against one process, started together
            (``PAR_CLI_DATA``; ``scripts/multicard_check.py``'s
            ``cli_against_one_process``: tables, each test's hits, the
            served rows).
18b. fused-trace  last, since its ~1M kernel events make the script's
            largest trace, in this process after every other phase that
            traces (``utils/profiling.maybe_trace`` waits for the card
            before its profiler starts: a trace that started over work
            still running crashed the later traced replay of a program
            with IF nodes; ROADMAP §3, fault 8): a fused run of the
            sweep's first two periods
            with period 1 traced (phase 0's epochs captured and replayed
            as epoch programs, the test between them, then nine replays of
            the program period 0 captured): the device's busy
            share over the traced and
            the untraced period's wall, the kernels' busy ms inside the
            ``period_step`` span per replay against the untraced wall ms
            per replay (the busy share inside a replay), top kernels,
            spans. The K1, K2 and K3 kernels the card ran from inside
            period 1's ``period_step`` span (each belongs to the graph
            launch with its correlation id) must equal the launches the
            wrappers' counts give that call, and both the per-phase
            launches derived from the data times the replays.
19. the card's name and power limit as nvidia-smi prints them, the
   ``kernels`` line (launches from each kernel's own path: the train
   sweep, the fused sweep, both fused-evals runs, both mesh-fused runs,
   the scale run and the engine at the mask cap, both runs of each
   protocol sweep, and the parallel
   phase's ranks for K1-K3, the probes for P1-P3),
   and last ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no
result line. Without a CUDA device it exits 1 before doing anything. Bounds
use the H100 SXM data sheet: 67 TFLOP/s f32 outside the tensor cores, 989
TFLOP/s bf16 in them (for bf16 inputs) and 3.35 TB/s HBM.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

# outside a checkout this import fails before anything is printed
from sml_tpu_torch.ops.edge_cases import (k2_edge_rows, p2_out_of_range,
                                          p3_edge_rows)
from sml_tpu_torch.scripts.scorer_timing import cuda_ms, graph_ms

PEAK_F32_FLOPS = 67e12       # H100 SXM, f32 without tensor cores
PEAK_BF16_FLOPS = 989e12     # H100 SXM, bf16 tensor cores, dense
PEAK_HBM_BYTES = 3.35e12     # H100 SXM HBM3

N_USERS, N_ITEMS, DIM = 100_000, 20_000, 64
C1, C2, HIDDEN = 10, 5, 512
EVAL_ROWS, EVAL_BATCH, NEG = 16_384, 1024, 999
SERVE_BATCHES, SERVE_K = 4, 20
SEED = 2000

# kernel vs plain tolerances on the card
# K1: f32 sums over K = C2*d = 320 and H = 512 terms in another order
K1_TOL = 1e-4
# K1 also at every row tile (64 rows to d=128, 32 to 256, 16 to 512), odd
# and narrow widths, C2 past what fits when all C2*d inputs sit in shared
# memory, H in passes of 512 and H % 4 != 0 (the cp.async weight copies),
# on K1_GRID_ROWS user rows; timed at the K1_WIDE widths
K1_GRID = ((10, 5, 512), (80, 5, 512), (128, 5, 512), (256, 5, 512),
           (512, 5, 512), (64, 7, 512), (64, 16, 1024), (33, 3, 102),
           (48, 5, 98), (100, 5, 1024))
K1_GRID_ROWS = 4096
K1_WIDE = (128, 256)
# K2 on random tables: ranks move only where a negative's score lies
# within f32 reduction-order rounding (~1e-6) of the target score
K2_RANDOM_FLIPS_PER_16K = 1
# K2 and P3 edge-case batches: a row count that is not a multiple of 8
EDGE_ROWS = 1021
# slice, card vs CPU: hit counts per K may move by the rank flips above
SLICE_HIT_TOL = 4
# K3: mu/nu bit-equal; p within this relative tolerance (expected exact)
K3_RTOL = 1e-6
K3_STEP = 7
# train-lockstep, card vs CPU: Adam normalises each step, so gradient
# rounding (sums in another order) moves a table element by at most
# ~lr * (rounding / eps) per step; tables and Θ within this absolute
# tolerance, per-batch losses within LOSS_RTOL
TRAIN_ATOL = 1e-4
LOSS_RTOL = 1e-5
# fused sweep against the unfused one: the same kernels on the same inputs
# (bit equality expected); tables, snapshots, Θ and moments within this
FUSED_ATOL = 1e-5
INNER_ROWS, OUTER_ROWS = 8192, 4096
# the sweep's periods differ in their train and test row counts, so its
# epochs take other step counts each period (one captured program serves
# them all: its tail steps are skipped on the card)
SWEEP_PERIODS, SWEEP_MULTI_NUM = 4, 3
SWEEP_TRAIN_ROWS = (65_536, 57_344, 49_400, 61_440)
SWEEP_TEST_ROWS = (16_384, 12_800, 14_848, 11_264)
# mesh-fused: the sweep's first periods (a warm-up and a test period) on
# a (1, 1) mesh over NCCL, unfused and fused, at a cut depth of phases
MESH_PERIODS, MESH_MULTI_NUM = 2, 2
# eval-design probes: P1 at its probe's shape; the probe mains' repeats
PROBE_ROWS, PROBE_ITEMS = 16_384, 20_480
PROBE_TRIALS, PROBE_ROUNDS = 3, 3
# P2 on N(0,1) tables: bf16 products are exact in f32, only the order of
# the 64 sums differs (scores ~N(0, 64))
P2_RANDOM_ATOL = 1e-4
# P2 on odd shapes (no whole wave, item of 32 candidates or 16-byte run of
# out), every pair of these row counts and slates, integer tables, exact
P2_ODD_B, P2_ODD_C = (1, 3, 1025), (1, 17, 4096)
# pretrain and baselines: a synthetic dataset with signal at the Yelp
# widths; the 999-negative test rows of the last PRE_PERIODS - PRE_TEST
# periods are the slow part of writing it (numpy, on the host)
PRE_PERIODS, PRE_TEST, PRE_ROWS = 30, 27, 20_000
PRE_EPOCHS, PRE_BATCH, PRE_INIT_SCALE = 8, 1024, 0.1
BASE_EPOCHS, BASE_POOL = 1, 100_000
# epochs per run where a graphed plain MF epoch is held to the eager one:
# the program's warm-up, its capture (and first replay), then replays
PRE_GRAPH_EPOCHS, BASE_GRAPH_EPOCHS = 3, 2
# recall@20 on PRE_ROWS test rows must clear random (20/1,000) by this
# many standard errors of such a measurement: pretraining by a clear
# margin, the full retrain (one epoch from the pretrained tables) at all
RANDOM_RECALL20 = 20 / (1 + NEG)
PRE_RECALL_Z, BASE_RECALL_Z = 5.0, 3.0
# transfer-kinds: every kind's refresh and one outer step at B=256 on the
# card against the CPU (the conv_com refresh is K1 against its plain
# version, the others plain operations on both)
TRANSFER_KINDS = ("conv_com", "conv2ch", "conv_com_root", "mlp_delta",
                  "linear", "gru", "gated")
KINDS_TOL, KINDS_OUTER_ROWS = 1e-4, 256
# ingest-sweep: a raw log whose 4-period time split holds these events
# per period (the last period is the test file: 16,384 x 1,001 int64,
# 131 MB); the sml CLI's flags besides the dataset's
INGEST_PERIOD_EVENTS = (100_000, 100_000, 100_000, 16_384)
INGEST_PERIOD_SECONDS = 1_000_000
INGEST_MULTI_NUM = 1
INGEST_SML_ARGS = ["--multi-num", str(INGEST_MULTI_NUM), "--mf-sample",
                   "alone", "--transfer-type", "conv_com_root",
                   "--eval-scoring", "masked", "--saddle-retries", "0",
                   "--attributed-eval"]
# scale: the JAX package's one-chip production shape (its
# benchmarks_scale_r5.json "scale_5m_chip_bf16snap_r5"), the scale
# script's other flags at their defaults; rows sampled, recounted, served
# and checked, and the replay rows of the fast-vs-dense inner step
SCALE_ARGS = ["--users", "5000000", "--items", "1000000",
              "--snapshot-dtype", "bfloat16"]
SCALE_SAMPLE, SCALE_RECOUNT = 4096, 256
SCALE_SERVE, SCALE_K, SCALE_CHECK = 1024, 100, 8
SCALE_CROSS_ROWS = 8192
# the driver at the one-card production shape, cut to 3 periods of
# 100,000 interactions (period 0 trains, periods 1 and 2 test) and 2
# phases a period, eager against fused
SCALE_SWEEP_ARGS = SCALE_ARGS + ["--periods", "3", "--inter", "100000",
                                 "--first-test", "1", "--multi-num", "2"]
# top-SCALE_K serving over SERVE5M_ITEMS items on the card: one batch of
# SCALE_SERVE users on N(0,1) tables (rows well apart), f32 and bf16
# inputs, SCALE_CHECK users held to a CPU top-K but at ties (PAR_TIE)
SERVE5M_USERS, SERVE5M_ITEMS = 1_000_000, 5_000_000
# K2 at the engine's mask cap (SMLConfig.eval_mask_max_items): an engine
# of CAP_USERS x CAP_ITEMS with masked scoring, its ranks on CAP_ROWS rows
# (distinct candidates) against the gather path's on integer-valued
# tables (every score exact in f32)
CAP_USERS, CAP_ITEMS, CAP_ROWS = 1_000_000, 262_144, 4096
# the 2^31-element edge: one table of EDGE_TABLE_ROWS x DIM f32 elements
# (2,181,038,080) for K3 and as many bf16 rows for K1, each held to its
# plain version on EDGE_WINDOW rows at the start, on both sides of element
# 2^31 and at the end
EDGE_TABLE_ROWS, EDGE_WINDOW = 34_078_720, 4096
# protocols: the two protocol scripts' phase functions at their
# protocols' full widths and a cut depth: Adressa (12,000 x 8,000, 8,000
# interactions a period, d=64, 999 negatives, multi_num=7, two epochs)
# over 7 periods, training from 2, testing 5-6, and each baseline for one
# test period; Yelp-scale (31,000 x 21,000, 30,000 a period, multi_num=10,
# in-training evals) over 5 periods, training from 2, testing 4
PROTO_ADRESSA_CUT = dict(n_periods=7, train_start=2, test_start=5)
PROTO_YELP_CUT = dict(n_periods=5, train_start=2, test_start=4)
PROTO_BASE_PERIODS = 1
# parallel: four worlds of the replay phase, a test and serving at the
# Yelp shape; name, ranks, (data, model) mesh (None: one rank alone;
# "global": the hosts' layout, make_global_mesh), simulated hosts. Two
# ranks share the one card over gloo; R2_hosts runs them as two simulated
# hosts (run_world(hosts=2)), which both see the one card: gloo, unfused,
# at (2, 1). On two cards or more (par_worlds) each host has its own
# (two a host on four: (2, 2)), NCCL, and its step trains PAR_FUSED_PHASES
# phases fused (a warm-up, then a capture), held to R1_fused_ref, one
# rank training as many phases unfused.
PAR_WORLDS = (("R1", 1, None, 1), ("R2_model", 2, (1, 2), 1),
              ("R2_data", 2, (2, 1), 1), ("R2_hosts", 2, "global", 2))
PAR_FUSED_PHASES = 2
PAR_TIMEOUT_S = 300
# served scores against dense serving on the same tables; a served id may
# differ from R=1's only where R=1's scores tie within PAR_TIE
PAR_SCORE_ATOL, PAR_TIE = 1e-5, 1e-4
# the multi-process CLI runs' synthetic dataset (the sml flags, the users
# that rank --shard serves and the limits are multicard_check's)
PAR_CLI_DATA = dict(n_users=2000, n_items=1000, n_periods=6,
                    interactions_per_period=4000, first_test_period=2,
                    neg_num=99, seed=SEED)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_F32_FLOPS):
    t_ops = flops / peak * 1e3
    t_mem = nbytes / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes")


def build_usage(log: str, *name_parts: str, threads: int = 256,
                dyn_smem: int = 0) -> dict:
    """Registers, spill bytes and static shared memory that ptxas reported
    for the one kernel whose mangled name holds every string of
    ``name_parts``, and the blocks of ``threads`` threads that one H100 SM
    holds at that use (plus ``dyn_smem`` bytes of dynamic shared memory
    per block): registers are handed out per warp in units of 256 of the
    SM's 65,536, at most 2,048 threads, and 228 KB of shared memory less 1
    KB per block."""
    import re
    entries = log.split("Compiling entry function '")[1:]
    hits = [e for e in entries
            if all(p in e.split("'")[0] for p in name_parts)]
    check(len(hits) == 1, f"ptxas reported {len(hits)} kernels named like "
                          f"{name_parts}")
    text = hits[0]
    regs = int(re.search(r"Used (\d+) registers", text).group(1))
    smem = re.search(r"(\d+) bytes smem", text)
    smem = int(smem.group(1)) if smem else 0
    spill = int(re.search(r"(\d+) bytes spill stores", text).group(1))
    warp_regs = -(-regs * 32 // 256) * 256
    blocks = min(65536 // warp_regs // (threads // 32), 2048 // threads,
                 233472 // (smem + dyn_smem + 1024))
    return {"registers": regs, "spill_store_bytes": spill,
            "smem_bytes": smem, "dynamic_smem_bytes": dyn_smem,
            "blocks_per_sm": blocks}


def clocks_under_load(torch, fn, calls: int) -> list:
    """nvidia-smi's samples of the SM clock (MHz) and power draw (W), every
    100 ms, from half a second before ``calls`` calls of ``fn`` until they
    have run; the sampler is stopped before returning."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        time.sleep(0.5)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=30)
    return [line.strip() for line in out.splitlines() if line.strip()]


def set_bits(words) -> int:
    """Number of set bits in a tensor of packed int32 mask words."""
    return sum(int(((words >> k) & 1).sum()) for k in range(32))


def phase_env(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi_line})
    return smi_line


def phase_sanitize():
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "sml_tpu_torch.scripts.sanitize", "--all",
         "--tools", "none"],
        capture_output=True, text=True, timeout=900)
    lines = [json.loads(ln) for ln in run.stdout.splitlines()
             if ln.startswith("{")]
    bad = [ln for ln in lines
           if ln.get("status") not in ("clean", "caught")]
    check(run.returncode == 0 and lines and "sanitize" in lines[-1],
          f"sanitize --all exited {run.returncode}: {bad} "
          f"{run.stderr[-2000:]}")
    checks = lines[:-1]
    by = {}
    for ln in checks:
        by.setdefault(ln["check"], {})[
            f"{ln.get('target', '-')}/{ln.get('mode', '-')}"] = (
                ln["status"], ln.get("seconds"))
    for name in ("k1", "k2", "k3", "p1", "p2", "p3"):
        for mode in ("tail", "head"):
            check(by["fence"][f"{name}/{mode}"][0] == "clean",
                  f"{name} under the {mode} fence: "
                  f"{by['fence'][f'{name}/{mode}']}")
    probes = by["fence-probe"]
    check(len(probes) == 2 and all(v[0] == "caught"
                                   for v in probes.values()),
          f"fence probes {probes}")
    emit({"phase": "sanitize", "seconds": time.perf_counter() - t0,
          "status": lines[-1]["status"],
          "lineinfo": [ln for ln in checks if ln["check"] == "lineinfo"],
          "fence": by["fence"], "fence_probe": probes,
          "compute_sanitizer": "not run: no memcheck, racecheck, synccheck "
          "or initcheck result in this phase (sanitize.py --all runs them "
          "where the tool supports the card)"})


def phase_build():
    from sml_tpu_torch import _build
    cached = _build.library_path().exists()
    t0 = time.perf_counter()
    _build.load_library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(_build.library_path().name),
          "reused_cached_build": cached})


def k1_flops(n: int, d: int, c2: int = C2, h: int = HIDDEN) -> float:
    """Operations of K1 on n rows: the multiply-adds of the conv mixes and
    the two FCs, 2 operations each."""
    return n * (2 * (3 * C1 + C1 * c2) * d + 2 * (c2 * d * h + h * d))


def k1_inputs(torch, d: int, c2: int, h: int, sizes, seed: int):
    """Θ at (d, C2, H) on the card and (tower, last, hat) per side, f32,
    8 zero-norm rows each (the x_com guard)."""
    from sml_tpu_torch.config import TransferConfig
    from sml_tpu_torch.models.transfer import init_transfer
    cfg = TransferConfig(latent_dim=d, conv1_channels=C1, conv2_channels=c2,
                         fc_hidden=h)
    theta = init_transfer(torch.Generator().manual_seed(seed), cfg,
                          device="cuda")
    g = torch.Generator().manual_seed(seed + 11)
    sides = []
    for tower, n in zip((theta.user, theta.item), sizes):
        last = torch.randn(n, d, generator=g)
        hat = last + 0.1 * torch.randn(n, d, generator=g)
        last[:8] = 0.0
        sides.append((tower, last.cuda(), hat.cuda()))
    return theta, sides


def k1_error(torch, tk, sides, dtype):
    """K1 against its plain version on the same rows: (max abs error,
    largest |output|)."""
    err = scale = 0.0
    for tower, last, hat in sides:
        got = tk.transfer_rows_cuda(tower, last.to(dtype), hat.to(dtype))
        want = tk.transfer_rows_plain(tower, last.to(dtype), hat.to(dtype))
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), "K1 output not finite")
        err = max(err, (got - want).abs().max().item())
        scale = max(scale, want.abs().max().item())
    return err, scale


def flat_activations(torch, tower, last, hat):
    """The (N, C2*d) input of fc1, as the plain version makes it."""
    from sml_tpu_torch.models.transfer import build_x_com, gelu_sig
    stack = torch.stack([last, hat, build_x_com(last, hat)], dim=1)
    h1 = gelu_sig(torch.einsum("ck,nkj->ncj", tower.conv1_w, stack)
                  + tower.conv1_b[None, :, None])
    h2 = gelu_sig(torch.einsum("ec,ncj->nej", tower.conv2_w, h1)
                  + tower.conv2_b[None, :, None])
    return h2.reshape(last.shape[0], -1).detach()


def phase_k1(torch):
    from sml_tpu_torch import _build
    from sml_tpu_torch.ops import transfer_kernel as tk

    theta, sides = k1_inputs(torch, DIM, C2, HIDDEN, (N_USERS, N_ITEMS),
                             SEED)
    out = {"phase": "K1", "rows": N_USERS + N_ITEMS, "tolerance": K1_TOL}
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        err, scale = k1_error(torch, tk, sides, dtype)
        name = "f32" if dtype == torch.float32 else "bf16"
        out[f"max_abs_err_{name}"] = err
        out[f"max_rel_err_{name}"] = err / scale
        check(err <= K1_TOL * max(1.0, scale),
              f"K1 {name} max abs err {err} over {K1_TOL}")
        worst = max(worst, err)
    # the fused phase refreshes into the MF tables themselves (out=)
    for tower, last, hat in sides:
        buf = torch.full_like(last, float("nan"))
        check(tk.transfer_rows_cuda(tower, last, hat, out=buf) is buf
              and torch.equal(buf, tk.transfer_rows_cuda(tower, last, hat)),
              "K1 into out= differs from K1 into a new tensor")
    out["out_equal"] = True

    def kernel():
        for tower, last, hat in sides:
            tk.transfer_rows_cuda(tower, last, hat)

    def plain():
        for tower, last, hat in sides:
            tk.transfer_rows_plain(tower, last, hat)

    # yardstick: the two products alone (f32, no TF32) on precomputed flat
    # activations; no single PyTorch call computes the tower
    flats = [(flat_activations(torch, tw, la, ha), tw.fc1_w.detach(),
              tw.fc2_w.detach()) for tw, la, ha in sides]

    def library():
        for flat, w1, w2 in flats:
            torch.matmul(torch.matmul(flat, w1), w2)

    out["ms"] = cuda_ms(kernel, 20)
    out["graph_ms"] = graph_ms(kernel, 20)
    out["plain_ms"] = cuda_ms(plain, 5)
    out["library_ms"] = cuda_ms(library, 20)
    out["library_graph_ms"] = graph_ms(library, 20)
    out["library"] = "products only: torch.matmul of fc1 then fc2 on flat"
    del flats
    n = N_USERS + N_ITEMS
    weights = sum(p.numel() for p in theta.parameters()) * 4
    nbytes = 3 * n * DIM * 4 + weights
    out["bound_ms"], out["bound_by"] = bound_ms(k1_flops(n, DIM), nbytes)
    out["flops"], out["bytes"] = k1_flops(n, DIM), nbytes
    lib = _build.load_library()
    out["build"] = build_usage(_build.build_log(), "transfer_rows_kernelIf",
                               "Li64ELi16ELi3E",
                               dyn_smem=lib.sml_transfer_smem_bytes(DIM))

    # every row tile and width the kernel takes, against the plain version
    grid = {}
    for d, c2, h in K1_GRID:
        _, small = k1_inputs(torch, d, c2, h, (K1_GRID_ROWS, K1_GRID_ROWS // 4),
                             SEED + d + c2)
        for dtype in (torch.float32, torch.bfloat16):
            err, scale = k1_error(torch, tk, small, dtype)
            key = f"d{d}_c2_{c2}_h{h}_{str(dtype).split('.')[-1]}"
            grid[key] = err
            check(err <= K1_TOL * max(1.0, scale),
                  f"K1 {key} max abs err {err} over {K1_TOL}")
    out["grid_max_abs_err"] = grid
    # times and bounds at wider tables, the Yelp row counts
    out["wide"] = {}
    for d in K1_WIDE:
        th, wide = k1_inputs(torch, d, C2, HIDDEN, (N_USERS, N_ITEMS), SEED)
        wbytes = 3 * n * d * 4 + sum(p.numel() for p in th.parameters()) * 4
        b, by = bound_ms(k1_flops(n, d), wbytes)
        out["wide"][d] = {
            "ms": cuda_ms(lambda: [tk.transfer_rows_cuda(*s)
                                          for s in wide], 10),
            "bound_ms": b, "bound_by": by,
            "smem_bytes": lib.sml_transfer_smem_bytes(d)}
        del wide
    emit(out)
    return {"max_abs_err": worst,
            **{k: out[k] for k in ("ms", "graph_ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms",
                                   "library_graph_ms")}}


def distinct_eval_rows(torch, n_rows: int, n_users: int, n_items: int,
                       seed: int, neg: int = NEG):
    """(n_rows, 2 + neg) int64 rows ``[user, pos, neg negatives]`` with
    distinct candidates per row, made on the card from a seed."""
    import numpy as np
    g = torch.Generator(device="cuda").manual_seed(seed)
    users = torch.randint(0, n_users, (n_rows, 1), generator=g,
                          device="cuda")
    parts = []
    for s in range(0, n_rows, 2048):
        r = min(2048, n_rows - s)
        keys = torch.rand(r, n_items, generator=g, device="cuda")
        parts.append(torch.topk(keys, 1 + neg, dim=1).indices)
    rows = torch.cat([users, torch.cat(parts)], dim=1)
    return np.ascontiguousarray(rows.cpu().numpy().astype(np.int64))


def phase_k2(torch):
    from sml_tpu_torch import _build
    from sml_tpu_torch.ops import eval_kernel as ek

    ipad = ek.pad_items(N_ITEMS)
    rows = torch.from_numpy(distinct_eval_rows(
        torch, EVAL_ROWS, N_USERS, N_ITEMS, SEED + 21)).cuda()
    masks = ek.build_packed_mask(rows[:, 2:], N_ITEMS)
    check(set_bits(masks) == EVAL_ROWS * NEG,
          "the packed masks do not hold one bit per distinct negative")
    g = torch.Generator().manual_seed(SEED + 22)
    out = {"phase": "K2", "B": EVAL_BATCH, "items": N_ITEMS, "I_pad": ipad,
           "d": DIM}

    # integer-valued tables: every score is exact, so ranks must be equal;
    # K2 takes the row-major (I_pad, d) table, the plain version and the
    # dense design (P1's template) the transposed one
    ue_i = torch.randint(-2, 3, (EVAL_ROWS, DIM), generator=g).float().cuda()
    it_i = torch.randint(-2, 3, (ipad, DIM), generator=g).float().cuda()
    it_i_t = it_i.T.contiguous()
    ss_i = torch.randint(-6, 7, (EVAL_ROWS, 1), generator=g).float().cuda()
    # random tables, the target score as the evaluator computes it
    ue_r = torch.randn(EVAL_ROWS, DIM, generator=g).cuda()
    it_r = torch.randn(ipad, DIM, generator=g).cuda()
    it_r[N_ITEMS:] = 0.0
    it_r_t = it_r.T.contiguous()
    ss_r = (ue_r * it_r[rows[:, 1]]).sum(dim=1, keepdim=True)

    mismatch = {"int_f32": 0, "int_bf16": 0, "random_f32": 0,
                "int_f32_vs_dense_design": 0}
    max_diff = 0
    for s in range(0, EVAL_ROWS, EVAL_BATCH):
        sl = slice(s, s + EVAL_BATCH)
        for name, ue, it, ss in (
                ("int_f32", ue_i, it_i, ss_i),
                ("int_bf16", ue_i.bfloat16(), it_i.bfloat16(), ss_i),
                ("random_f32", ue_r, it_r, ss_r)):
            got = ek.masked_rank_cuda(ue[sl], it, ss[sl], masks[sl])
            want = ek.masked_rank_plain(ue[sl], it.T, ss[sl], masks[sl])
            mismatch[name] += int((got != want).sum())
            max_diff = max(max_diff, int((got - want).abs().max()))
            if name == "int_f32":
                old = ek.masked_rank_variant_cuda(ue[sl], it_i_t, ss[sl],
                                                  masks[sl], 64, "ij")
                mismatch["int_f32_vs_dense_design"] += int((got != old).sum())
    # edge-case rows, exact on integer tables
    edge = masks[:EDGE_ROWS].clone()
    k2_edge_rows(edge, N_ITEMS)
    edge_mismatch = {}
    for name, ue, it in (("f32", ue_i, it_i),
                         ("bf16", ue_i.bfloat16(), it_i.bfloat16())):
        want = ek.masked_rank_plain(ue[:EDGE_ROWS], it.T, ss_i[:EDGE_ROWS],
                                    edge)
        check(int(want[0]) == 0 and int(want[1]) > 0,
              f"K2 edge rows: plain ranks {want[:4].tolist()}")
        got = ek.masked_rank_cuda(ue[:EDGE_ROWS], it, ss_i[:EDGE_ROWS], edge)
        edge_mismatch[name] = int((got != want).sum())
    torch.cuda.synchronize()
    out["rows_compared"] = EVAL_ROWS
    out["rank_mismatch"] = mismatch
    out["edge_rows"] = EDGE_ROWS
    out["edge_rank_mismatch"] = edge_mismatch
    out["max_abs_rank_diff"] = max_diff
    check(all(mismatch[k] == 0 for k in mismatch if k != "random_f32"),
          f"K2 ranks differ on integer tables: {mismatch}")
    check(not any(edge_mismatch.values()),
          f"K2 ranks differ on the edge-case rows: {edge_mismatch}")
    check(mismatch["random_f32"] <= K2_RANDOM_FLIPS_PER_16K,
          f"K2 random-table flips {mismatch['random_f32']} over "
          f"{K2_RANDOM_FLIPS_PER_16K} per {EVAL_ROWS} rows")

    # time one launch per eval batch, cycling through the 16 batches
    batches = [(ue_r[s:s + EVAL_BATCH], ss_r[s:s + EVAL_BATCH],
                masks[s:s + EVAL_BATCH])
               for s in range(0, EVAL_ROWS, EVAL_BATCH)]
    nb = len(batches)
    it_b = it_r.bfloat16()
    batches_b = [(ue.bfloat16(), ss, m) for ue, ss, m in batches]

    def per_batch(fn, iters, parts=batches, timer=cuda_ms):
        return timer(lambda: [fn(*b) for b in parts], iters) / nb

    def k2(ue, ss, m):
        return ek.masked_rank_cuda(ue, it_r, ss, m)

    def k2_bf16(ue, ss, m):
        return ek.masked_rank_cuda(ue, it_b, ss, m)

    def dense(ue, ss, m):
        return ek.masked_rank_variant_cuda(ue, it_r_t, ss, m, 64, "ij")

    def library(ue, ss, m):
        return torch.matmul(ue, it_r_t)

    zero = torch.zeros_like(masks[:EVAL_BATCH])

    def empty(ue, ss, m):
        return k2(ue, ss, zero)

    # each by eager launches (cuda_ms, the host's launch gaps included, as
    # every kernel is timed and as the path pays) and by CUDA-graph replay
    # (the device alone)
    for key, fn, parts in (
            ("", k2, batches), ("bf16_", k2_bf16, batches_b),
            ("empty_mask_", empty, batches),
            ("dense_design_", dense, batches),
            ("library_", library, batches)):
        out[f"{key}ms"] = per_batch(fn, 10, parts)
        out[f"{key}graph_ms"] = per_batch(fn, 20, parts, graph_ms)
    out["plain_ms"] = per_batch(
        lambda ue, ss, m: ek.masked_rank_plain(ue, it_r_t, ss, m), 3)
    log = _build.build_log()
    out["build"] = {
        "f32": build_usage(log, "masked_rank_gather_kernelIf",
                           "VecScorerIfLi2E"),
        "bf16": build_usage(log, "masked_rank_gather_kernelI13__nv_bfloat16",
                            "VecScorer", "Li1E")}
    # per call, the mean over the timed batches: the function scores only
    # the set mask bits, and reads ue, the item table, the mask and sstar
    # and writes rank once each
    flops = 2 * DIM * set_bits(masks) / nb
    nbytes = (EVAL_BATCH * DIM + DIM * ipad) * 4 + EVAL_BATCH * ipad // 8 \
        + 2 * EVAL_BATCH * 4
    out["bound_ms"], out["bound_by"] = bound_ms(flops, nbytes)
    out["flops"], out["bytes"] = flops, nbytes
    # the floor of the dense design, which scores every column, and
    # the bytes a gather design moves from L2: one table row per set bit
    out["dense_design_flops"] = 2 * EVAL_BATCH * DIM * ipad
    out["dense_design_bound_ms"] = bound_ms(out["dense_design_flops"],
                                            nbytes)[0]
    out["l2_gather_bytes_f32"] = set_bits(masks) / nb * DIM * 4
    # the rate at which the candidates' rows arrived, over the device time
    # the kernel takes beyond an empty mask's
    out["l2_gather_tb_s"] = out["l2_gather_bytes_f32"] / (
        out["graph_ms"] - out["empty_mask_graph_ms"]) * 1e-9
    emit(out)
    return {"max_abs_err": max_diff, "ms": out["ms"],
            "plain_ms": out["plain_ms"],
            "bound_ms": out["bound_ms"], "bound_by": out["bound_by"],
            "library_ms": out["library_ms"]}, out["l2_gather_tb_s"]


def run_slice(torch, device: str, pretrained, hat_tables, test_rows,
              serve_users):
    """The serving path as a user drives it, on ``device``."""
    from sml_tpu_torch.config import SMLConfig, yelp_sml
    from sml_tpu_torch.eval.full_ranking import recommend
    from sml_tpu_torch.models.mf import with_tables
    from sml_tpu_torch.train.engine import SMLEngine

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    cfg: SMLConfig = yelp_sml().replace(eval_scoring="masked",
                                        eval_batch_size=EVAL_BATCH)
    engine = SMLEngine(cfg, N_USERS, N_ITEMS, device=device)
    state = engine.init_state(pretrained_mf=pretrained)
    state = engine.snapshot_last(state)
    # Ŵ_t: the tables after the period's inner training
    state = state._replace(mf=with_tables(
        state.mf, hat_tables[0].to(device), hat_tables[1].to(device)))
    state = engine.snapshot_hat(state)
    sync()
    times = {}
    t0 = time.perf_counter()
    state = engine.refresh(state)
    sync()
    times["refresh_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ev = engine.make_eval_set(test_rows, build_mask=True)
    sync()
    times["eval_set_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sums, n = engine.evaluate_deferred(state.mf, ev)
    hits = {k: (float(h), float(nd)) for k, (h, nd) in sums.items()}
    times["evaluate_s"] = time.perf_counter() - t0
    metrics = engine.resolve_evals([(sums, n)])[0]
    served = []
    t0 = time.perf_counter()
    for users in serve_users:
        scores, items = recommend(state.mf, users, SERVE_K)
        served.append((scores.cpu(), items.cpu()))
    times["recommend_s"] = time.perf_counter() - t0
    return state, ev, hits, metrics, served, times


def phase_slice(torch):
    from sml_tpu_torch.models.mf import MFParams
    from sml_tpu_torch.ops import eval_kernel as ek
    from sml_tpu_torch.ops import transfer_kernel as tk

    g = torch.Generator().manual_seed(SEED + 31)
    pretrained = MFParams(torch.randn(N_USERS, DIM, generator=g),
                          torch.randn(N_ITEMS, DIM, generator=g),
                          torch.zeros(N_USERS, 1), torch.zeros(N_ITEMS, 1))
    hat_tables = (pretrained.user_emb
                  + 0.1 * torch.randn(N_USERS, DIM, generator=g),
                  pretrained.item_emb
                  + 0.1 * torch.randn(N_ITEMS, DIM, generator=g))
    test_rows = distinct_eval_rows(torch, EVAL_ROWS, N_USERS, N_ITEMS,
                                   SEED + 32)
    serve_users = [torch.randint(0, N_USERS, (EVAL_BATCH,), generator=g)
                   for _ in range(SERVE_BATCHES)]

    tk.transfer_rows_cuda.launches = 0
    ek.masked_rank_cuda.launches = 0
    state, ev, hits, metrics, served, times = run_slice(
        torch, "cuda", pretrained, hat_tables, test_rows, serve_users)
    launches = {"transfer_rows_kernel": tk.transfer_rows_cuda.launches,
                "masked_rank_gather_kernel": ek.masked_rank_cuda.launches}
    n_batches = ev.rows.shape[0] // EVAL_BATCH
    check(launches["transfer_rows_kernel"] == 2,
          f"K1 launched {launches['transfer_rows_kernel']} times in one "
          "refresh, expected 2")
    check(launches["masked_rank_gather_kernel"] == n_batches,
          f"K2 launched {launches['masked_rank_gather_kernel']} times for "
          f"{n_batches} eval batches")

    cpu_state, _, cpu_hits, cpu_metrics, cpu_served, cpu_times = run_slice(
        torch, "cpu", pretrained, hat_tables, test_rows, serve_users)
    tab_err = max(
        (state.mf.user_emb.cpu() - cpu_state.mf.user_emb).abs().max().item(),
        (state.mf.item_emb.cpu() - cpu_state.mf.item_emb).abs().max().item())
    hit_diff = {k: abs(hits[k][0] - cpu_hits[k][0]) for k in hits}
    score_err = max((a[0] - b[0]).abs().max().item()
                    for a, b in zip(served, cpu_served))
    ids_equal = sum(int((a[1] == b[1]).sum())
                    for a, b in zip(served, cpu_served))
    ids_total = sum(a[1].numel() for a in served)
    for m in metrics.values():
        check(all(0.0 <= v <= 1.0 for v in m.values()),
              f"metric out of range: {metrics}")
    check(tab_err <= K1_TOL, f"refreshed tables differ from the CPU run by "
                             f"{tab_err}")
    check(all(v <= SLICE_HIT_TOL for v in hit_diff.values()),
          f"hit counts differ from the CPU run: {hit_diff}")
    check(score_err <= 1e-3, f"served scores differ from the CPU run by "
                             f"{score_err}")
    check(ids_equal >= 0.999 * ids_total,
          f"served ids equal for only {ids_equal}/{ids_total}")
    emit({"phase": "slice", "users": N_USERS, "items": N_ITEMS,
          "eval_rows": EVAL_ROWS, "eval_batches": n_batches,
          "metrics": {str(k): v for k, v in metrics.items()},
          "cpu_metrics": {str(k): v for k, v in cpu_metrics.items()},
          "hit_diff_vs_cpu": {str(k): v for k, v in hit_diff.items()},
          "table_max_abs_err_vs_cpu": tab_err,
          "served_score_max_abs_err_vs_cpu": score_err,
          "served_ids_equal": f"{ids_equal}/{ids_total}",
          "launches": launches, "wall_s": times, "cpu_wall_s": cpu_times})
    return launches


def yelp_leaves(torch, seed: int):
    """Seeded f32 (p, mu, nu) for the four MF leaves at the Yelp shape,
    on the card."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for shape in ((N_USERS, DIM), (N_ITEMS, DIM), (N_USERS, 1),
                  (N_ITEMS, 1)):
        out.append(tuple(t.cuda() for t in (
            torch.randn(shape, generator=g),
            torch.randn(shape, generator=g) * 1e-2,
            torch.rand(shape, generator=g) * 1e-4)))
    return out


def phase_k3(torch):
    from sml_tpu_torch import _build
    from sml_tpu_torch.config import yelp_sml
    from sml_tpu_torch.ops import adam_kernel as ak
    from sml_tpu_torch.train.optim import (ADAM_B1, ADAM_B2, ADAM_EPS,
                                           BiasTable, bias_corrections)

    lr = yelp_sml().mf_lr
    bc1, bc2 = bias_corrections(K3_STEP)
    # the kernel reads bc1/bc2 on the card, from a BiasTable as the
    # optimizer's steps do; the plain version takes the host's floats
    table = BiasTable(1, "cuda")
    table.fill(K3_STEP - 1)
    bc_dev = table.at(K3_STEP, ADAM_B1, ADAM_B2)
    kw = dict(lr=lr, b1=ADAM_B1, b2=ADAM_B2, eps=ADAM_EPS)
    leaves = yelp_leaves(torch, SEED + 41)
    n = sum(p.numel() for p, _, _ in leaves)
    # one launch over the four leaves, as sparse_dense_adam_update makes it
    got = [tuple(t.clone() for t in leaf) for leaf in leaves]
    want = [tuple(t.clone() for t in leaf) for leaf in leaves]
    before = ak.decay_adam_cuda.launches
    ak.decay_adam_cuda(got, *bc_dev, **kw)
    check(ak.decay_adam_cuda.launches == before + 1,
          "K3 took more than one launch for the four leaves")
    for leaf in want:
        ak.decay_adam_plain(*leaf, bc1, bc2, **kw)
    torch.cuda.synchronize()
    p_not_equal = 0
    err = 0.0
    for g, w in zip(got, want):
        check(torch.equal(g[1], w[1]) and torch.equal(g[2], w[2]),
              "K3 mu/nu differ from the plain version")
        check(bool(torch.isfinite(g[0]).all()), "K3 p not finite")
        check(torch.allclose(g[0], w[0], rtol=K3_RTOL, atol=0.0),
              "K3 p outside rtol 1e-6 of the plain version")
        p_not_equal += int((g[0] != w[0]).sum())
        err = max(err, (g[0] - w[0]).abs().max().item())
    del got, want

    def kernel():
        ak.decay_adam_cuda(leaves, *bc_dev, **kw)

    def plain():
        for p, mu, nu in leaves:
            ak.decay_adam_plain(p, mu, nu, bc1, bc2, **kw)

    def library(capturable):
        params = [torch.nn.Parameter(p.clone()) for p, _, _ in leaves]
        for q in params:
            q.grad = torch.zeros_like(q)
        return torch.optim.Adam(params, lr=lr, fused=True,
                                capturable=capturable)

    out = {"phase": "K3", "elements": n, "step": K3_STEP,
           "mu_nu_bit_equal": True, "p_not_bit_equal": p_not_equal,
           "max_abs_err": err}
    # each by eager launches (cuda_ms, the host's launch gaps included) and
    # by CUDA-graph replay (the device alone); capture needs a capturable
    # optimizer, whose step count lives on the card
    out["ms"] = cuda_ms(kernel, 50)
    out["graph_ms"] = graph_ms(kernel, 100)
    out["plain_ms"] = cuda_ms(plain, 20)
    out["library_ms"] = cuda_ms(library(False).step, 50)
    out["library_graph_ms"] = graph_ms(library(True).step, 100)
    out["build"] = build_usage(_build.build_log(), "decay_adam_kernel")
    # read and write p, mu, nu once each; 8 operations per element
    flops, nbytes = 8 * n, 24 * n
    out["bound_ms"], out["bound_by"] = bound_ms(flops, nbytes)
    out["flops"], out["bytes"] = flops, nbytes
    emit(out)
    return {k: out[k] for k in ("max_abs_err", "ms", "graph_ms", "plain_ms",
                                "bound_ms", "bound_by", "library_ms",
                                "library_graph_ms")}


def seeded_rows(n: int, seed: int):
    """(n, 3) int64 ``[user, item, negative item]`` triples from a seed."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, N_USERS, n), rng.integers(0, N_ITEMS, n),
                     rng.integers(0, N_ITEMS, n)], axis=1).astype(np.int64)


def random_tables(torch, seed: int):
    from sml_tpu_torch.models.mf import MFParams
    g = torch.Generator().manual_seed(seed)
    return MFParams(torch.randn(N_USERS, DIM, generator=g),
                    torch.randn(N_ITEMS, DIM, generator=g),
                    torch.randn(N_USERS, 1, generator=g),
                    torch.randn(N_ITEMS, 1, generator=g))


def crossover(torch, base_cfg, n_users: int, n_items: int, rows,
              pretrained) -> dict:
    """One inner epoch of replay ``rows`` with the row-sparse path (K3) and
    with dense gradients from the tables ``pretrained`` (after a warm-up
    epoch each), in the order fast, dense, dense, fast: ms per step by
    CUDA events and by the host's clock."""
    from sml_tpu_torch.train.engine import SMLEngine

    steps = -(-rows.shape[0] // base_cfg.mf_batch_size)
    out = {"rows": n_users + n_items, "batch": base_cfg.mf_batch_size}
    for fast in (True, False, False, True):
        cfg = base_cfg.replace(replay_mode=True, fast_table_adam=fast)
        eng = SMLEngine(cfg, n_users, n_items, device="cuda")
        state = eng.snapshot_last(eng.init_state(pretrained_mf=pretrained))
        padded, index = eng.prep_inner(rows)
        state, _ = eng.inner_epoch(state, padded, index)      # warm-up
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        state, _ = eng.inner_epoch(state, padded, index)
        stop.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
        name = "fast" if fast else "dense"
        out.setdefault(f"{name}_step_ms", []).append(
            start.elapsed_time(stop) / steps)
        out.setdefault(f"{name}_step_wall_ms", []).append(wall)
        del state, eng, padded, index
        torch.cuda.empty_cache()
    return out


def phase_crossover(torch):
    """One inner step at the Yelp shape with the row-sparse path (K3) and
    with dense gradients; replay rows, so both run the same steps."""
    from sml_tpu_torch.config import yelp_sml

    emit({"phase": "crossover",
          "auto_rule": "fast iff rows >= 1,000,000 and batch <= 2048",
          **crossover(torch, yelp_sml(), N_USERS, N_ITEMS,
                      seeded_rows(INNER_ROWS, SEED + 51),
                      random_tables(torch, SEED + 52))})


def kernel_counts(ak, tk, ek):
    return {"decay_adam_kernel": ak.decay_adam_cuda.launches,
            "transfer_rows_kernel": tk.transfer_rows_cuda.launches,
            "masked_rank_gather_kernel": ek.masked_rank_cuda.launches}


def zero_counts(ak, tk, ek):
    ak.decay_adam_cuda.launches = 0
    tk.transfer_rows_cuda.launches = 0
    ek.masked_rank_cuda.launches = 0


def run_lockstep(torch, device: str, pretrained, inner_rows, outer_rows):
    """One replay-mode SML phase as the engine's user drives it."""
    from sml_tpu_torch.config import yelp_sml
    from sml_tpu_torch.train.engine import SMLEngine

    cfg = yelp_sml().replace(replay_mode=True, fast_table_adam=True)
    eng = SMLEngine(cfg, N_USERS, N_ITEMS, device=device)
    state = eng.snapshot_last(eng.init_state(pretrained_mf=pretrained))
    state, il = eng.inner_epoch(state, *eng.prep_inner(inner_rows))
    state = eng.refresh(eng.snapshot_hat(state))
    state, ol = eng.outer_epoch(state, *eng.prep_outer(outer_rows))
    state = eng.refresh(state)
    if device == "cuda":
        torch.cuda.synchronize()
    return state, il.cpu(), ol.cpu()


def phase_train_lockstep(torch):
    from sml_tpu_torch.models.transfer import theta_leaves
    from sml_tpu_torch.ops import adam_kernel as ak
    from sml_tpu_torch.ops import eval_kernel as ek
    from sml_tpu_torch.ops import transfer_kernel as tk

    pretrained = random_tables(torch, SEED + 61)
    inner_rows = seeded_rows(INNER_ROWS, SEED + 62)
    outer_rows = seeded_rows(OUTER_ROWS, SEED + 63)
    zero_counts(ak, tk, ek)
    t0 = time.perf_counter()
    gs, gil, gol = run_lockstep(torch, "cuda", pretrained, inner_rows,
                                outer_rows)
    card_s = time.perf_counter() - t0
    launches = kernel_counts(ak, tk, ek)
    inner_steps = -(-INNER_ROWS // 1024)
    check(launches["decay_adam_kernel"] == inner_steps,
          f"K3 launched {launches['decay_adam_kernel']} times in "
          f"{inner_steps} fast inner steps, expected {inner_steps}")
    check(launches["transfer_rows_kernel"] == 4,
          f"K1 launched {launches['transfer_rows_kernel']} times in two "
          "refreshes, expected 4")
    t0 = time.perf_counter()
    cs, cil, col = run_lockstep(torch, "cpu", pretrained, inner_rows,
                                outer_rows)
    cpu_s = time.perf_counter() - t0
    errs = {f"mf/{f}": (getattr(gs.mf, f).cpu() - getattr(cs.mf, f))
            .abs().max().item() for f in gs.mf._fields}
    tl_g, tl_c = theta_leaves(gs.theta), theta_leaves(cs.theta)
    errs["theta"] = max((tl_g[k].detach().cpu() - tl_c[k].detach())
                        .abs().max().item() for k in tl_g)
    for name, (a, b) in {"inner": (gil, cil), "outer": (gol, col)}.items():
        check(bool(torch.isfinite(a).all()), f"{name} losses not finite")
        check(torch.allclose(a, b, rtol=LOSS_RTOL, atol=0.0),
              f"{name} losses differ from the CPU run beyond rtol "
              f"{LOSS_RTOL}: {(a - b).abs().max().item()}")
    check(max(errs.values()) <= TRAIN_ATOL,
          f"tables/Θ differ from the CPU run beyond {TRAIN_ATOL}: {errs}")
    emit({"phase": "train-lockstep", "users": N_USERS, "items": N_ITEMS,
          "inner_steps": inner_steps, "outer_steps": -(-OUTER_ROWS // 256),
          "launches": launches, "max_abs_err_vs_cpu": errs,
          "inner_loss_max_rel_err": ((gil - cil).abs() / cil.abs())
          .max().item(),
          "outer_loss_max_rel_err": ((gol - col).abs() / col.abs())
          .max().item(),
          "card_wall_s": card_s, "cpu_wall_s": cpu_s})
    return launches


def write_sweep_dataset(torch, root: str) -> None:
    """The train-sweep dataset, in the reference layout: ids as int32,
    made on the card from a seed; period ``p`` holds
    ``SWEEP_TRAIN_ROWS[p]`` train and ``SWEEP_TEST_ROWS[p]`` test rows."""
    import numpy as np
    path = os.path.join(root, "synth")
    os.makedirs(os.path.join(path, "train"))
    os.makedirs(os.path.join(path, "test"))
    np.save(os.path.join(path, "information.npy"),
            np.array([sum(SWEEP_TRAIN_ROWS), N_USERS, N_ITEMS],
                     dtype=np.int64))
    g = torch.Generator(device="cuda").manual_seed(SEED + 71)
    for p in range(SWEEP_PERIODS):
        n = SWEEP_TRAIN_ROWS[p]
        train = torch.stack([
            torch.randint(0, N_USERS, (n,), generator=g, device="cuda"),
            torch.randint(0, N_ITEMS, (n,), generator=g, device="cuda")],
            dim=1)
        np.save(os.path.join(path, "train", f"{p}.npy"),
                train.to(torch.int32).cpu().numpy())
        test = distinct_eval_rows(torch, SWEEP_TEST_ROWS[p], N_USERS,
                                  N_ITEMS, SEED + 72 + p)
        np.save(os.path.join(path, "test", f"{p}.npy"),
                test.astype(np.int32))


def expected_sweep_launches(spec, cfg, feeder_rows, eval_batches) -> dict:
    """K3, K1 and K2 launches the sweep must make, from the data
    (``scale_sweep.sweep_launches``): ``feeder_rows(kind, period)`` gives
    a period file's row count, ``eval_batches(rows)`` the batches of its
    padded eval set."""
    from sml_tpu_torch.config import resolve_fast_table_adam
    from sml_tpu_torch.scripts.scale_sweep import sweep_launches
    fast = resolve_fast_table_adam(cfg.fast_table_adam, N_USERS + N_ITEMS,
                                   cfg.mf_batch_size)
    return sweep_launches(spec, cfg, feeder_rows, fast, eval_batches)


def sweep_cfg(**kw):
    """The train sweep's configuration (``yelp_sml()``, K3 on, masked
    scoring, ``SWEEP_MULTI_NUM`` phases a period); ``kw`` sets the
    fused-program switches."""
    from sml_tpu_torch.config import yelp_sml
    base = dict(fast_table_adam=True, eval_scoring="masked",
                multi_num=SWEEP_MULTI_NUM)
    base.update(kw)
    return yelp_sml().replace(**base)


def sweep_driver(torch, root: str, cfg, log_name: str,
                 num_periods: int = SWEEP_PERIODS):
    """An ``SMLDriver`` on the first ``num_periods`` periods of the sweep
    dataset with a jsonl logger, and the launches derived from the data
    for ``cfg``."""
    from sml_tpu_torch.config import DataSpec
    from sml_tpu_torch.data.formats import row_count
    from sml_tpu_torch.ops.batching import bucket_rows
    from sml_tpu_torch.train.driver import SMLDriver
    from sml_tpu_torch.utils.logging import MetricsLogger

    spec = DataSpec(root=root, name="synth", num_periods=num_periods,
                    online_train_start=0, online_test_start=2)
    logger = MetricsLogger(os.path.join(root, log_name))
    driver = SMLDriver(cfg, spec, logger=logger, device="cuda")
    bound = driver.engine.shape_targets.get("eval", 0)
    want = expected_sweep_launches(
        spec, cfg, lambda kind, p: row_count(spec.path, kind, p),
        lambda n: max(bucket_rows(n, cfg.eval_batch_size),
                      bucket_rows(bound, cfg.eval_batch_size))
        // cfg.eval_batch_size)
    return driver, logger, want


def sweep_tests(path: str) -> list:
    with open(path) as fh:
        return [{k: r[k] for k in ("period", "n_test", "recall@5",
                                   "recall@20")}
                for r in map(json.loads, fh) if r["kind"] == "test"]


def phase_train_sweep(torch, root: str, data_s: float):
    """The sweep on the unfused path (pinned: its epochs are wrapped and
    timed, which a replay never enters), so its numbers stay comparable
    with the earlier runs. Returns its launches and what the fused sweep
    is held to."""
    from sml_tpu_torch.ops import adam_kernel as ak
    from sml_tpu_torch.ops import eval_kernel as ek
    from sml_tpu_torch.ops import transfer_kernel as tk

    cfg = sweep_cfg(fuse_phases=False, fuse_period=False)
    driver, logger, want = sweep_driver(torch, root, cfg, "metrics.jsonl")
    eng = driver.engine
    step_ms = {"inner": [], "outer": []}
    losses = []

    def timed(kind, fn, batch):
        def run(state, padded, index, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, lo = fn(state, padded, index, **kw)
            torch.cuda.synchronize()
            steps = -(-padded.n_real // batch)
            step_ms[kind].append((time.perf_counter() - t) * 1e3 / steps)
            losses.append(lo[:steps])
            return state, lo
        return run

    eng.inner_epoch = timed("inner", eng.inner_epoch, cfg.mf_batch_size)
    eng.outer_epoch = timed("outer", eng.outer_epoch, cfg.tr_batch_size)
    state = eng.init_state(pretrained_mf=random_tables(torch, SEED + 81))
    zero_counts(ak, tk, ek)
    t0 = time.perf_counter()
    report = driver.run(state)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    launches = kernel_counts(ak, tk, ek)
    driver.close()
    logger.close()
    check(launches == want, f"sweep launches {launches}, derived from "
                            f"the data {want}")
    check(all(bool(torch.isfinite(lo).all()) for lo in losses),
          "a training loss is not finite")
    summary = report.summary()
    metrics = {k: v for k, v in summary.items() if k != "total_seconds"}
    check(bool(metrics) and all(0.0 <= v <= 1.0 for v in metrics.values()),
          f"summary metrics out of [0, 1]: {summary}")
    tests = sweep_tests(os.path.join(root, "metrics.jsonl"))
    check(len(tests) == 2 and all(0.0 <= t["recall@20"] <= 1.0
                                  for t in tests),
          f"expected two test records in [0, 1]: {tests}")
    item_spread = driver.final_state.mf.item_emb.std(dim=0).mean()
    emit({"phase": "train-sweep", "users": N_USERS, "items": N_ITEMS,
          "periods": SWEEP_PERIODS, "train_rows": SWEEP_TRAIN_ROWS,
          "test_rows": SWEEP_TEST_ROWS, "fused": False, "data_s": data_s,
          "sweep_s": sweep_s, "period_s": report.period_seconds,
          "inner_epochs": len(step_ms["inner"]),
          "outer_epochs": len(step_ms["outer"]),
          "inner_step_ms": sum(step_ms["inner"]) / len(step_ms["inner"]),
          "outer_step_ms": sum(step_ms["outer"]) / len(step_ms["outer"]),
          "launches": launches, "derived_launches": want,
          "last_outer_loss": float(losses[-1].mean()),
          "bce_saddle": 2 * math.log(2.0),
          "final_item_spread": float(item_spread),
          "tests": tests, "summary": summary})
    # the epochs in call order: per period, per phase, inner then outer
    # (mf_epochs = tr_epochs = 1)
    per_period = 2 * cfg.multi_num
    epochs = [losses[i:i + per_period]
              for i in range(0, len(losses), per_period)]
    ref = {"state": driver.final_state, "epochs": epochs, "tests": tests,
           "sweep_s": sweep_s, "period_s": report.period_seconds}
    return launches, ref


def state_errors(torch, a, b) -> dict:
    """Max absolute differences of two states' tables, snapshots, Θ and
    Adam moments, and whether their generators stand at one position."""
    from sml_tpu_torch.models.transfer import theta_leaves

    def err(x, y):
        return (x.detach().float() - y.detach().float()).abs().max().item()
    out = {"tables": max(err(x, y) for x, y in zip(a.mf, b.mf)),
           "snapshots": max(err(getattr(a, f), getattr(b, f))
                            for f in ("last_user", "last_item", "hat_user",
                                      "hat_item"))}
    ta, tb = theta_leaves(a.theta), theta_leaves(b.theta)
    out["theta"] = max(err(ta[k], tb[k]) for k in ta)
    out["moments"] = max(err(getattr(oa, part)[k], getattr(ob, part)[k])
                         for oa, ob in ((a.mf_opt, b.mf_opt),
                                        (a.tr_opt, b.tr_opt))
                         for part in ("mu", "nu")
                         for k in getattr(oa, part))
    out["counts_equal"] = ((a.mf_opt.count, a.tr_opt.count)
                           == (b.mf_opt.count, b.tr_opt.count))
    out["generator_equal"] = bool(torch.equal(a.gen.get_state(),
                                              b.gen.get_state()))
    return out


def phase_fused_sweep(torch, root: str, ref: dict):
    """The train sweep's dataset, seed and configuration with the default
    ``fuse_period="auto"``, which fuses on the card: each period's phases
    are ``SMLEngine.period_step`` (the run's first phase eagerly on the
    capture stream, then one CUDA graph for the whole sweep, replayed in
    every period whatever its step counts). Held to the unfused sweep:
    final tables, Θ and Adam moments, the generator's position, every fused
    phase's losses, the tests' hits and the launches (replays counted)
    derived from the data."""
    from sml_tpu_torch.ops import adam_kernel as ak
    from sml_tpu_torch.ops import eval_kernel as ek
    from sml_tpu_torch.ops import transfer_kernel as tk

    cfg = sweep_cfg()
    check(cfg.fuse_period == "auto" and cfg.fuse_phases,
          f"the fused sweep must run the default switches: {cfg}")
    driver, logger, want = sweep_driver(torch, root, cfg, "fused.jsonl")
    eng = driver.engine
    check(eng.fused_program_warm(), "'auto' does not fuse on the card")
    stacks, calls = [], []
    period_step = eng.period_step

    def recorded(state, prep_t, prep_tt, n_phases, *a, **k):
        before = dict(eng.graph_stats)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = period_step(state, prep_t, prep_tt, n_phases, *a, **k)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        stacks.append((out[2], n_phases, prep_t[0].n_real,
                       prep_tt[0].n_real))
        d = {k: eng.graph_stats[k] - before[k] for k in before}
        # what is left of the call besides its warm-up and capture is its
        # replays (and the copies of their losses into the stacks)
        calls.append({"wall_s": wall, **d, "replay_ms": 1e3 * (
            wall - d["warmup_s"] - d["capture_s"]) / max(d["replays"], 1)})
        return out

    eng.period_step = recorded
    state = eng.init_state(pretrained_mf=random_tables(torch, SEED + 81))
    zero_counts(ak, tk, ek)
    t0 = time.perf_counter()
    report = driver.run(state)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    launches = kernel_counts(ak, tk, ek)
    stats = dict(eng.graph_stats)
    driver.close()
    logger.close()
    check(launches == want, f"fused sweep launches {launches}, derived "
                            f"from the data {want}")
    fused_phases = sum(n for _, n, _, _ in stacks)
    check(len(stacks) == SWEEP_PERIODS - 1
          and fused_phases == (SWEEP_PERIODS - 1) * cfg.multi_num - 2,
          f"expected one period_step per period (branch C's phase 0 "
          f"unfused): {[n for _, n, _, _ in stacks]}")
    # the two branch-C periods run phase 0's epochs through an inner and
    # an outer epoch program, captured once each and replayed every epoch
    phase0 = 2 * (cfg.mf_epochs + cfg.tr_epochs)
    check(stats["programs"] == 3 and stats["captures"] == 3
          and stats["warmups"] == 1
          and stats["program_phase0_epochs"] == phase0
          and stats["replays"] == fused_phases - 1 + phase0,
          f"programs/captures/replays: {stats} for {fused_phases} fused "
          f"phases and {phase0} phase-0 epochs (three programs, one "
          f"capture each, expected)")
    step_counts = [(-(-n_t // cfg.mf_batch_size),
                    -(-n_tt // cfg.tr_batch_size))
                   for _, _, n_t, n_tt in stacks]
    check(all(len({c[i] for c in step_counts}) == len(step_counts)
              for i in (0, 1)),
          f"the fused periods must differ in both epochs' step counts: "
          f"{step_counts}")
    # each fused phase's last inner and outer losses against the unfused
    # sweep's epochs of the same period and phase
    loss_rel = 0.0
    for period, ((ils, ols), n, n_t, n_tt) in enumerate(stacks):
        first = cfg.multi_num - n
        for p in range(n):
            for kind, stack, n_real, batch in (
                    (0, ils, n_t, cfg.mf_batch_size),
                    (1, ols, n_tt, cfg.tr_batch_size)):
                steps = -(-n_real // batch)
                got = stack[p, :steps]
                exp = ref["epochs"][period][2 * (first + p) + kind]
                check(bool(torch.isfinite(got).all()),
                      "a fused training loss is not finite")
                loss_rel = max(loss_rel, ((got - exp).abs()
                                          / exp.abs()).max().item())
    errs = state_errors(torch, driver.final_state, ref["state"])
    check(max(errs[k] for k in ("tables", "snapshots", "theta",
                                "moments")) <= FUSED_ATOL
          and errs["counts_equal"],
          f"fused sweep state differs from the unfused one: {errs}")
    check(loss_rel <= LOSS_RTOL,
          f"fused losses differ from the unfused ones: rel {loss_rel}")
    tests = sweep_tests(os.path.join(root, "fused.jsonl"))
    hit_diff = [max(abs(t[k] - u[k]) * t["n_test"]
                    for k in ("recall@5", "recall@20"))
                for t, u in zip(tests, ref["tests"])]
    check(len(tests) == len(ref["tests"])
          and max(hit_diff, default=0) <= SLICE_HIT_TOL
          and [t["period"] for t in tests]
          == [u["period"] for u in ref["tests"]],
          f"fused tests {tests} against unfused {ref['tests']}")

    emit({"phase": "fused-sweep", "users": N_USERS, "items": N_ITEMS,
          "periods": SWEEP_PERIODS, "fused": True, "graphs": stats,
          "fused_phases": fused_phases,
          "inner_outer_steps_per_period": step_counts,
          "sweep_s": sweep_s, "unfused_sweep_s": ref["sweep_s"],
          "period_s": report.period_seconds,
          "unfused_period_s": ref["period_s"],
          "period_step_calls": calls,
          "max_abs_err_vs_unfused": errs,
          "loss_max_rel_err_vs_unfused": loss_rel,
          "test_hit_diff": hit_diff, "tests": tests,
          "launches": launches, "derived_launches": want})
    return launches, report.period_seconds[1], calls[1]


def eval_and_phase_records(path: str) -> list:
    """The in-training eval, phase and saddle-retry records of a metrics
    log, without their wall-clock fields."""
    kinds = ("inner_eval", "outer_eval", "phase", "saddle_retry")
    with open(path) as fh:
        return [{k: v for k, v in r.items() if k not in ("ts", "seconds")}
                for r in map(json.loads, fh) if r["kind"] in kinds]


def record_differences(got: list, want: list, n_val: int) -> dict:
    """Two record lists of one shape (kinds, keys, epochs and phases in one
    order): the largest eval-metric difference in hits of ``n_val`` rows
    and the largest relative difference of the other numbers."""
    check(len(got) == len(want)
          and all(g.keys() == w.keys() and all(
              g[k] == w[k] for k in g if isinstance(g[k], (str, bool))
              or k in ("epoch", "phase", "d_time", "attempt"))
              for g, w in zip(got, want)),
          f"fused records differ in kind, order or keys from the unfused "
          f"ones: {len(got)} against {len(want)} records")
    hits = rel = 0.0
    for g, w in zip(got, want):
        for k, v in g.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            if g["kind"].endswith("_eval"):
                hits = max(hits, abs(v - w[k]) * n_val)
            else:
                rel = max(rel, abs(v - w[k]) / max(abs(w[k]), 1e-30))
    return {"eval_hits": hits, "rel": rel}


def phase_fused_evals(torch, root: str):
    """Period 0 of the sweep (branch A) with in-training evals after every
    inner and outer epoch, ``log_norms`` and one saddle retry, unfused and
    then fused: K2 and the eval sums, the seven norms and the stalled
    attempt run inside the captured phase, and the retry's new buffers and
    generator are copied into the program and replayed (one capture for
    both attempts). Held to the unfused run: final state, the generator,
    every eval, phase and retry record, and both runs' launches derived
    from the phases each ran (the fused guard runs a stalled attempt's
    every phase, then keeps the records of those the unfused guard ran)."""
    from sml_tpu_torch.ops import adam_kernel as ak
    from sml_tpu_torch.ops import eval_kernel as ek
    from sml_tpu_torch.ops import transfer_kernel as tk

    extra = dict(eval_during_inner=True, eval_during_outer=True,
                 log_norms=True, saddle_retries=1)
    runs = {}
    for name, fuse in (("unfused", dict(fuse_phases=False,
                                        fuse_period=False)),
                       ("fused", {})):
        cfg = sweep_cfg(**extra, **fuse)
        log_name = f"evals_{name}.jsonl"
        driver, logger, want = sweep_driver(torch, root, cfg, log_name)
        eng = driver.engine
        calls = []
        if name == "fused":
            check(eng.fused_program_warm(), "'auto' does not fuse on the "
                                            "card")
            period_step = eng.period_step

            def counted(*a, _step=period_step, _eng=eng, **k):
                before = (kernel_counts(ak, tk, ek), dict(_eng.graph_stats))
                out = _step(*a, **k)
                calls.append({"launches": {
                    n: c - before[0][n]
                    for n, c in kernel_counts(ak, tk, ek).items()},
                    **{s: _eng.graph_stats[s] - before[1][s]
                       for s in ("warmups", "captures", "replays")}})
                return out
            eng.period_step = counted
        state = eng.init_state(pretrained_mf=random_tables(torch, SEED + 81))
        zero_counts(ak, tk, ek)
        t0 = time.perf_counter()
        report = driver.run(state, max_periods=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[name] = {
            "cfg": cfg, "state": driver.final_state, "wall_s": wall,
            "launches": kernel_counts(ak, tk, ek), "calls": calls,
            "retries": report.saddle_retries_used,
            "graphs": dict(eng.graph_stats),
            "records": eval_and_phase_records(os.path.join(root, log_name)),
            "eval_bound": eng.shape_targets.get("eval", 0)}
        driver.close()
        logger.close()
    unf, fus = runs["unfused"], runs["fused"]
    cfg = fus["cfg"]
    check(unf["retries"] == fus["retries"] >= 1,
          f"the guard must stall once on both paths: retries "
          f"{unf['retries']} unfused, {fus['retries']} fused")
    n_val = SWEEP_TEST_ROWS[1]      # period 0's val set is test/1
    diff = record_differences(fus["records"], unf["records"], n_val)
    check(diff["eval_hits"] <= SLICE_HIT_TOL and diff["rel"] <= LOSS_RTOL,
          f"fused eval/phase records differ from the unfused ones: {diff}")
    errs = state_errors(torch, fus["state"], unf["state"])
    check(max(errs[k] for k in ("tables", "snapshots", "theta",
                                "moments")) <= FUSED_ATOL
          and errs["counts_equal"] and errs["generator_equal"],
          f"fused state differs from the unfused one: {errs}")
    # launches per phase: K3 one per fast step, K1 two per refresh (after
    # the inner block and each outer epoch), K2 one per eval batch (an
    # eval after each inner and each outer epoch); two K1 at the period's
    # end
    from sml_tpu_torch.data.formats import row_count
    from sml_tpu_torch.ops.batching import bucket_rows
    mf_rows = row_count(os.path.join(root, "synth"),
                        "test" if cfg.mf_sample == "all" else "train", 0)
    steps = -(-mf_rows // cfg.mf_batch_size) * cfg.mf_epochs
    eval_batches = max(bucket_rows(n, cfg.eval_batch_size)
                       for n in (n_val, fus["eval_bound"])) \
        // cfg.eval_batch_size
    per_phase = {"decay_adam_kernel": steps,
                 "transfer_rows_kernel": 2 * (1 + cfg.tr_epochs),
                 "masked_rank_gather_kernel":
                     eval_batches * (cfg.mf_epochs + cfg.tr_epochs)}

    def derived(phases):
        out = {k: v * phases for k, v in per_phase.items()}
        out["transfer_rows_kernel"] += 2
        return out
    unf_phases = sum(r["kind"] == "phase" for r in unf["records"])
    fus_phases = cfg.multi_num * (fus["retries"] + 1)
    check(unf["launches"] == derived(unf_phases),
          f"unfused launches {unf['launches']}, derived for {unf_phases} "
          f"phases {derived(unf_phases)}")
    check(fus["launches"] == derived(fus_phases),
          f"fused launches {fus['launches']}, derived for {fus_phases} "
          f"phases {derived(fus_phases)}")
    # every fused phase ran in a period_step call: the stalled attempt's
    # (warm-up, capture, replays) and the retry's (replays only)
    calls = fus["calls"]
    check(len(calls) == fus["retries"] + 1
          and [c["captures"] for c in calls] == [1] + [0] * (len(calls) - 1)
          and fus["graphs"]["programs"] == 1
          and sum(c["warmups"] + c["replays"] for c in calls) == fus_phases
          and all(c["launches"] == {k: v * (c["warmups"] + c["replays"])
                                    for k, v in per_phase.items()}
                  for c in calls),
          f"period_step calls {calls} against {per_phase} per phase")
    emit({"phase": "fused-evals", "period": 0, "config": extra,
          "retries": fus["retries"], "unfused_phases": unf_phases,
          "fused_phases": fus_phases, "graphs": fus["graphs"],
          "period_step_calls": calls, "records": len(fus["records"]),
          "record_kinds": sorted({r["kind"] for r in fus["records"]}),
          "max_eval_hit_diff": diff["eval_hits"],
          "max_phase_rel_diff": diff["rel"],
          "max_abs_err_vs_unfused": errs,
          "launches": fus["launches"], "unfused_launches": unf["launches"],
          "per_phase_launches": per_phase,
          "wall_s": fus["wall_s"], "unfused_wall_s": unf["wall_s"]})
    return {k: unf["launches"][k] + fus["launches"][k]
            for k in per_phase}


def record_kinds(path: str, kinds) -> list:
    """The records of ``kinds`` of a jsonl log, without their wall-clock
    fields."""
    with open(path) as fh:
        return [{k: v for k, v in r.items()
                 if k not in ("ts", "seconds", "total_seconds")}
                for r in map(json.loads, fh) if r["kind"] in kinds]


def phase_mesh_fused(torch, root: str) -> dict:
    """The fused programs under a mesh: a world of one rank in this
    process (its mesh groups over NCCL, the card its own), the sweep
    dataset's first ``MESH_PERIODS`` periods at the Yelp widths with
    ``log_norms`` and ``MESH_MULTI_NUM`` phases a period, on a (1, 1) mesh
    unfused, then with the default ``"auto"``, which captures the program
    with its step slots split at their collectives (three IF nodes a
    slot, the collectives, local on one rank, between them). Held to the
    unfused run: state, counts, generators, every phase and test record,
    launches; three programs (the phase program and phase 0's epoch
    programs), a capture each and one warm-up, a replay for every
    phase-0 epoch and for every other fused phase. The graphs are
    released and the process group is
    destroyed after, so that the parallel phase's worlds start clean.
    Returns the launches of both runs."""
    import socket

    import torch.distributed as dist

    from sml_tpu_torch.ops import adam_kernel as ak
    from sml_tpu_torch.ops import eval_kernel as ek
    from sml_tpu_torch.ops import transfer_kernel as tk
    from sml_tpu_torch.parallel import collective
    from sml_tpu_torch.parallel.multihost import init_distributed
    from sml_tpu_torch.parallel.sharding import make_mesh
    from sml_tpu_torch.train import graphs
    from sml_tpu_torch.train.driver import fusion_route

    t_phase = time.perf_counter()
    saved = dict(collective.WORLD)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    init_distributed(f"127.0.0.1:{port}", 1, 0, device="cuda")
    runs, total = {}, {}
    try:
        mesh = make_mesh(1, 1)
        for name, kw in (("unfused", dict(fuse_phases=False,
                                          fuse_period=False)),
                         ("fused", {})):
            cfg = sweep_cfg(log_norms=True, multi_num=MESH_MULTI_NUM, **kw)
            log = f"mesh_{name}.jsonl"
            driver, logger, want = sweep_driver(torch, root, cfg, log,
                                                MESH_PERIODS + 1)
            eng = driver.engine
            state = eng.init_state_sharded(
                mesh, pretrained_mf=random_tables(torch, SEED + 81))
            fused = fusion_route(driver.cfg, eng)
            zero_counts(ak, tk, ek)
            t0 = time.perf_counter()
            report = driver.run(state)
            torch.cuda.synchronize()
            runs[name] = {"wall_s": time.perf_counter() - t0, "cfg": cfg,
                          "period_s": report.period_seconds,
                          "fused": fused, "graphs": dict(eng.graph_stats),
                          "launches": kernel_counts(ak, tk, ek),
                          "derived_launches": want,
                          "state": driver.final_state,
                          "records": record_kinds(os.path.join(root, log),
                                                  ("phase", "test"))}
            driver.close()
            logger.close()
        transport = {a: collective.transport(mesh.group(a))
                     for a in ("data", "model")}
        backend = mesh.transport
    finally:
        graphs.release_all()
        dist.destroy_process_group()
        collective.WORLD.clear()
        collective.WORLD.update(saved)
    u, f = runs["unfused"], runs["fused"]
    if_nodes_per_slot = f["graphs"]["if_nodes"] / max(
        f["graphs"]["step_slots"], 1)
    errs = state_errors(torch, f["state"], u["state"])
    # branch A fuses its period whole, branch C all but its phase 0
    fused_phases = (MESH_MULTI_NUM
                    + (MESH_PERIODS - 1) * (MESH_MULTI_NUM - 1))
    check(backend == "nccl" and not u["fused"] and f["fused"],
          f"the mesh runs over {backend}; fused routes {u['fused']}, "
          f"{f['fused']}")
    check(max(errs[k] for k in ("tables", "snapshots", "theta",
                                "moments")) <= FUSED_ATOL
          and errs["counts_equal"] and errs["generator_equal"],
          f"the fused sweep on the mesh differs from the unfused one: "
          f"{errs}")
    diff = record_differences(f["records"], u["records"], 1)
    check(diff["rel"] <= LOSS_RTOL
          and sum(r["kind"] == "test" for r in u["records"])
          == MESH_PERIODS - 1,
          f"the fused sweep's phase and test records on the mesh differ "
          f"from the unfused one's: {diff}")
    check(f["launches"] == u["launches"] == u["derived_launches"],
          f"mesh launches: fused {f['launches']}, unfused "
          f"{u['launches']}, derived {u['derived_launches']}")
    # and phase 0's epochs of the branch-C periods, each an epoch program
    phase0 = (MESH_PERIODS - 1) * (f["cfg"].mf_epochs + f["cfg"].tr_epochs)
    check([f["graphs"][k] for k in ("programs", "captures", "warmups",
                                    "replays", "program_phase0_epochs")]
          == [3, 3, 1, fused_phases - 1 + phase0, phase0],
          f"mesh programs/captures/warm-ups/replays/phase-0 epochs: "
          f"{f['graphs']} for {fused_phases} fused phases and {phase0} "
          f"phase-0 epochs")
    check(if_nodes_per_slot == 3,
          f"the mesh's step slots are not split at their two cuts: "
          f"{if_nodes_per_slot} IF nodes per slot ({f['graphs']})")
    for k in f["launches"]:
        total[k] = f["launches"][k] + u["launches"][k]
    emit({"phase": "mesh-fused", "users": N_USERS, "items": N_ITEMS,
          "periods": MESH_PERIODS, "mesh": mesh.shape, "backend": backend,
          "transport": transport, "graphs": f["graphs"],
          "fused_phases": fused_phases,
          "if_nodes_per_slot": if_nodes_per_slot,
          "capture_s": f["graphs"]["capture_s"], "sweep_s": f["wall_s"],
          "unfused_sweep_s": u["wall_s"], "period_s": f["period_s"],
          "unfused_period_s": u["period_s"],
          "max_abs_err_vs_unfused": errs,
          "records": len(f["records"]),
          "records_equal": f["records"] == u["records"],
          "record_rel_err": diff["rel"], "launches": f["launches"],
          "derived_launches": u["derived_launches"],
          "phase_s": time.perf_counter() - t_phase})
    return total


def phase_fused_trace(torch, root: str, untraced_s: float,
                      untraced_call: dict):
    """One traced fused period: a fused run of the sweep's first two
    periods with period 1 traced (branch C: phase 0's epoch programs
    captured and replayed, the test between them, then nine replays of
    the program period 0 captured). Its ~1.3M kernel
    events are the script's largest trace, so it runs last, after every
    other phase that profiles."""
    import re

    from sml_tpu_torch.ops import adam_kernel as ak
    from sml_tpu_torch.ops import eval_kernel as ek
    from sml_tpu_torch.ops import transfer_kernel as tk

    t_phase = time.perf_counter()
    prof = os.path.join(root, "fused_profile")
    cfg = sweep_cfg(profile_dir=prof, profile_period=1)
    driver, logger, _ = sweep_driver(torch, root, cfg, "fused_traced.jsonl")
    eng = driver.engine
    period_step, calls = eng.period_step, []

    def counted(*a, **k):
        before = (kernel_counts(ak, tk, ek), eng.graph_stats["replays"])
        out = period_step(*a, **k)
        calls.append({"replays": eng.graph_stats["replays"] - before[1],
                      "launches": {n: c - before[0][n] for n, c in
                                   kernel_counts(ak, tk, ek).items()}})
        return out
    eng.period_step = counted
    driver.run(eng.init_state(pretrained_mf=random_tables(torch, SEED + 81)),
               max_periods=2)
    driver.close()
    logger.close()
    traces = [f for f in os.listdir(prof) if f.endswith(".json")]
    check(len(traces) == 1, f"expected one trace, found {traces}")
    trace_bytes = os.path.getsize(os.path.join(prof, traces[0]))
    t0 = time.perf_counter()
    tr = read_trace(os.path.join(prof, traces[0]), busy_in=("period_step",),
                    count_in=("period_step",))
    read_s = time.perf_counter() - t0
    # the launches the wrappers' counts claim for period 1's replays
    # against the kernels the card ran from inside its period_step span,
    # and both against those derived per phase
    call = calls[1]
    in_span = tr.pop("span_kernels")["period_step"]
    traced = {k: sum(c for name, c in in_span.items()
                     if re.search(rf"\b{k}\b", name))
              for k in call["launches"]}
    from sml_tpu_torch.data.formats import row_count
    mf_rows = row_count(os.path.join(root, "synth"),
                        "test" if cfg.mf_sample == "all" else "train", 1)
    per_phase = {"decay_adam_kernel":
                     -(-mf_rows // cfg.mf_batch_size) * cfg.mf_epochs,
                 "transfer_rows_kernel": 2 * (1 + cfg.tr_epochs),
                 "masked_rank_gather_kernel": 0}
    check(traced == call["launches"]
          == {k: v * call["replays"] for k, v in per_phase.items()},
          f"period 1's period_step: kernels traced inside the span "
          f"{traced}, launches counted {call['launches']}, derived "
          f"{per_phase} per phase x {call['replays']} replays")
    os.remove(os.path.join(prof, traces[0]))
    with open(os.path.join(root, "fused_traced.jsonl")) as fh:
        traced_s = next(r["seconds"] for r in map(json.loads, fh)
                        if r["kind"] == "period" and r["d_time"] == 1)
    # the period_step span holds the capture (no kernel runs) and the
    # replays: its busy ms per replay against the untraced run's wall ms
    # per replay is the card's busy share inside a replay
    replays = untraced_call["replays"]
    check(replays > 0, f"period 1 replayed nothing: {untraced_call}")
    replay_busy_ms = tr["span_busy_ms"].get("period_step", 0.0) / replays
    check(tr["kernel_events"] > 0 and "period_step" in tr["spans"],
          f"the traced fused period holds no kernel or no period_step "
          f"span: {tr['spans']}")
    emit({"phase": "fused-trace", "period": 1, "wall_ms": traced_s * 1e3,
          "untraced_wall_ms": untraced_s * 1e3, "replays": call["replays"],
          "traced_launches_in_replays": traced,
          "counted_launches_in_replays": call["launches"],
          "replay_device_ms": replay_busy_ms,
          "untraced_replay_wall_ms": untraced_call["replay_ms"],
          "device_busy_share_in_replays":
              replay_busy_ms / untraced_call["replay_ms"],
          "device_busy_share": tr["busy_ms"] / (traced_s * 1e3),
          "device_busy_share_of_untraced": tr["busy_ms"] / (untraced_s * 1e3),
          "trace_bytes": trace_bytes, "read_s": read_s, **tr,
          "phase_s": time.perf_counter() - t_phase})


def quiet_main(main, argv):
    """Run a probe's ``main(argv)`` with its JSON document captured (this
    script's stdout carries one JSON line per phase)."""
    import contextlib
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        return main(argv)


def phase_p1(torch):
    from sml_tpu_torch import _build
    from sml_tpu_torch.ops import eval_kernel as ek
    from sml_tpu_torch.scripts import eval_kernel_probe as probe

    ue, items_t, sstar, maskp = probe.probe_inputs(
        PROBE_ROWS, PROBE_ITEMS, DIM, NEG, torch.device("cuda"))
    ipad = ek.pad_items(PROBE_ITEMS)
    # N(0,1) tables, the target's score as the plain version computes it:
    # ranks move only where a negative lies within rounding of it. The
    # probe draws negatives with replacement, so each row's target is moved
    # off its mask bits (a target among its own negatives would tie itself)
    g = torch.Generator(device="cuda").manual_seed(SEED + 111)
    ue_r = torch.randn(PROBE_ROWS, DIM, generator=g, device="cuda")
    it_r = torch.randn(DIM, ipad, generator=g, device="cuda")
    pos = torch.randint(0, PROBE_ITEMS, (PROBE_ROWS,), generator=g,
                        device="cuda")
    rows_b = torch.arange(PROBE_ROWS, device="cuda")
    for _ in range(64):
        word = maskp[rows_b, pos // ek.I_BLK * ek.LANES + pos % ek.LANES]
        hit = ((word >> (pos % ek.I_BLK // ek.LANES)) & 1) != 0
        if not bool(hit.any()):
            break
        pos = torch.where(hit, (pos + 1) % PROBE_ITEMS, pos)
    check(not bool(hit.any()), "P1: no target off the mask")
    inputs = {"f32": (ue, items_t, ue_r, it_r),
              "bf16": (ue.bfloat16(), items_t.bfloat16(), ue_r.bfloat16(),
                       it_r.bfloat16())}
    want = ek.masked_rank_plain(ue, items_t, sstar, maskp)
    ss_r, want_r = {}, {}
    for dt, (_, _, u, it) in inputs.items():
        ss_r[dt] = (u.float() * it.float()[:, pos].T).sum(1, keepdim=True)
        want_r[dt] = ek.masked_rank_plain(u, it, ss_r[dt], maskp)

    def kernel(spec, random=False):
        u, it, ur, itr = inputs[spec["in_dtype"]]
        rb = probe.ROWS_PER_BLOCK[spec["rblk"]]
        if random:
            return lambda: ek.masked_rank_variant_cuda(
                ur, itr, ss_r[spec["in_dtype"]], maskp, rb, spec["order"])
        return lambda: ek.masked_rank_variant_cuda(u, it, sstar, maskp, rb,
                                                   spec["order"])

    mismatch, flips, variants_ms = {}, {}, {}
    for name, spec in probe.VARIANTS.items():
        got = kernel(spec)()
        got_r = kernel(spec, random=True)()
        torch.cuda.synchronize()
        mismatch[name] = int((got != want).sum())
        flips[name] = int((got_r != want_r[spec["in_dtype"]]).sum())
        variants_ms[name] = cuda_ms(kernel(spec), 10)
    check(not any(mismatch.values()),
          f"P1 ranks differ from the plain version: {mismatch}")
    check(all(v <= K2_RANDOM_FLIPS_PER_16K for v in flips.values()),
          f"P1 random-table flips {flips} over {K2_RANDOM_FLIPS_PER_16K} per "
          f"{PROBE_ROWS} rows")
    ue_b, it_b = inputs["bf16"][:2]
    out = {"phase": "P1", "rows": PROBE_ROWS, "I_pad": ipad, "d": DIM,
           "rank_mismatch": mismatch, "random_flips": flips,
           "variants_ms": variants_ms, "ms": variants_ms["v0"],
           "graph_ms": graph_ms(kernel(probe.VARIANTS["v0"]), 20),
           "bf16_ms": variants_ms["v1_bf16"],
           "bf16_graph_ms": graph_ms(kernel(probe.VARIANTS["v1_bf16"]),
                                     20),
           "plain_ms": cuda_ms(
               lambda: ek.masked_rank_plain(ue, items_t, sstar, maskp), 2),
           # ~1 s each of v0 and of v1_bf16: the clock the card keeps under
           # them, against the 1.98 GHz boost the f32 and bf16 peaks assume
           "clocks_under_load": {
               name: clocks_under_load(torch, kernel(probe.VARIANTS[name]),
                                       calls)
               for name, calls in (("v0", 1000), ("v1_bf16", 4000))}}
    # yardsticks: the scores alone, f32 (no TF32) and bf16 with f32 out
    for key, fn in (
            ("library_", lambda: torch.matmul(ue, items_t)),
            ("bf16_library_",
             lambda: torch.mm(ue_b, it_b, out_dtype=torch.float32))):
        out[f"{key}ms"] = cuda_ms(fn, 10)
        out[f"{key}graph_ms"] = graph_ms(fn, 20)
    log = _build.build_log()
    out["build"] = {
        f"{dt}_{rb}_{order}": build_usage(
            log, "masked_rank_kernelI" + ("f" if dt == "f32"
                                          else "13__nv_bfloat16"),
            f"Li{rb}E", f"Lb{int(order == 'ji')}E",
            dyn_smem=ek.variant_smem_bytes(dt, rb, DIM))
        for dt in ("f32", "bf16") for rb in ek.VARIANT_ROWS_PER_BLOCK
        for order in ek.VARIANT_ORDERS}
    # the function needs the scores of the set mask bits only; it reads ue,
    # the item table, the mask and sstar and writes rank once each
    flops = 2 * DIM * set_bits(maskp)
    rest = PROBE_ROWS * ipad // 8 + 2 * PROBE_ROWS * 4
    out["bound_ms"], out["bound_by"] = bound_ms(
        flops, (PROBE_ROWS * DIM + DIM * ipad) * 4 + rest)
    out["bf16_bound_ms"], out["bf16_bound_by"] = bound_ms(
        flops, (PROBE_ROWS * DIM + DIM * ipad) * 2 + rest, PEAK_BF16_FLOPS)
    # the floors of the dense design, which scores every column
    dense_flops = 2 * PROBE_ROWS * DIM * ipad
    out["dense_design_bound_ms"] = bound_ms(dense_flops, 0)[0]
    out["bf16_dense_design_bound_ms"] = bound_ms(dense_flops, 0,
                                                 PEAK_BF16_FLOPS)[0]
    out["flops"] = flops

    # the probe's own path, its launches counted
    ek.masked_rank_variant_cuda.launches = 0
    res = quiet_main(probe.main, ["--device", "cuda", "--trials",
                                  str(PROBE_TRIALS)])
    launches = ek.masked_rank_variant_cuda.launches
    want_launches = len(probe.VARIANTS) * (1 + PROBE_TRIALS)
    check(launches == want_launches,
          f"P1 launched {launches} times in the probe, expected "
          f"{want_launches}")
    check(all(v.get("exact_vs_v0") for v in res["variants"].values()),
          f"eval_kernel_probe variants not exact: {res['variants']}")
    out["probe_best_ms"] = {n: v["best_ms"]
                            for n, v in res["variants"].items()}
    out["launches"] = launches
    emit(out)
    return {"max_abs_err": 0, "launches": launches,
            **{k: out[k] for k in ("ms", "graph_ms", "bf16_ms",
                                   "bf16_graph_ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms",
                                   "bf16_library_ms", "variants_ms")}}


def probe_eval_rows(torch):
    """16,384 eval rows ``[user, pos, 1,000 negatives]``: 1,001 distinct
    candidates per row, the probes' shape."""
    return torch.from_numpy(distinct_eval_rows(
        torch, EVAL_ROWS, N_USERS, N_ITEMS, SEED + 91, neg=1000)).cuda()


def int_or_randn(torch, g, shape, kind):
    if kind == "int":
        return torch.randint(-1, 2, shape, generator=g).bfloat16().cuda()
    return torch.randn(shape, generator=g).bfloat16().cuda()


def p2_bytes(torch, users, cand) -> int:
    """Bytes one P2 call must move: the ids read once at their dtype's
    width, each distinct user and table row once, the scores written
    once."""
    rows_read = int(torch.unique(users).numel()) + int(
        torch.unique(cand).numel())
    return users.numel() * users.element_size() \
        + cand.numel() * cand.element_size() + rows_read * DIM * 2 \
        + cand.numel() * 4


def p2_mismatch(torch, pk, ue_t, users, cand, tab) -> int:
    """Scores of P2's kernel that differ from its plain version's, NaN
    included (NaN equals NaN here)."""
    got = pk.candidate_scores_cuda(ue_t, users, cand, tab)
    want = pk.candidate_scores_plain(ue_t, users, cand, tab)
    nan = want.isnan()
    return int((got.isnan() != nan).sum()) + int(
        (got[~nan] != want[~nan]).sum())


def phase_p2(torch, rows, l2_rates):
    from sml_tpu_torch import _build
    from sml_tpu_torch.ops import probe_kernels as pk
    from sml_tpu_torch.scripts import scorer_timing

    g = torch.Generator().manual_seed(SEED + 92)
    tables = {kind: (int_or_randn(torch, g, (N_USERS, DIM), kind),
                     int_or_randn(torch, g, (N_ITEMS, DIM), kind))
              for kind in ("int", "randn")}
    # the probe's call: int64 strided views of the rows; and the same ids
    # as contiguous int32 tensors
    probe = [(rows[s:s + EVAL_BATCH, 0], rows[s:s + EVAL_BATCH, 1:])
             for s in range(0, EVAL_ROWS, EVAL_BATCH)]
    int32 = [(u.int(), c.int().contiguous()) for u, c in probe]
    nb, n_cand = len(probe), probe[0][1].shape[1]
    err = {"int": 0.0, "randn": 0.0}
    int32_mismatch = 0
    for kind, (ue_t, tab) in tables.items():
        for (u, c), (u32, c32) in zip(probe, int32):
            got = pk.candidate_scores_cuda(ue_t, u, c, tab)
            want = pk.candidate_scores_plain(ue_t, u, c, tab)
            err[kind] = max(err[kind], (got - want).abs().max().item())
            int32_mismatch += int(
                (pk.candidate_scores_cuda(ue_t, u32, c32, tab) != got).sum())
    # ids outside both tables, and odd shapes, on the integer tables
    ue_i, tab_i = tables["int"]
    oor = rows[:EVAL_BATCH].clone()
    p2_out_of_range(g, oor[:, 0], oor[:, 1:], N_USERS, N_ITEMS)
    oor_mismatch = p2_mismatch(torch, pk, ue_i, oor[:, 0], oor[:, 1:],
                               tab_i)
    odd_mismatch = {}
    for b in P2_ODD_B:
        for c in P2_ODD_C:
            users = torch.randint(0, N_USERS, (b,), generator=g).cuda()
            cand = torch.randint(0, N_ITEMS, (b, c), generator=g).cuda()
            odd_mismatch[f"{b}x{c}"] = p2_mismatch(torch, pk, ue_i, users,
                                                   cand, tab_i)
    torch.cuda.synchronize()
    check(err["int"] == 0.0, f"P2 scores differ on integer tables: {err}")
    check(err["randn"] <= P2_RANDOM_ATOL,
          f"P2 max abs err {err['randn']} over {P2_RANDOM_ATOL}")
    check(int32_mismatch == 0,
          f"P2 scores on int32 ids differ from int64 strided ones at "
          f"{int32_mismatch} places")
    check(oor_mismatch == 0,
          f"P2 differs from its plain version at {oor_mismatch} places on "
          f"out-of-range ids")
    check(not any(odd_mismatch.values()),
          f"P2 differs from its plain version on odd shapes: {odd_mismatch}")

    ue_t, tab = tables["randn"]
    tab_t = tab.T.contiguous()

    def per_batch(fn, parts, iters, timer=cuda_ms):
        return timer(lambda: [fn(*p) for p in parts], iters) / nb

    def plain(u, c):
        return pk.candidate_scores_plain(ue_t, u, c, tab)

    def library(u, c):
        return torch.gather(torch.mm(ue_t[u], tab_t, out_dtype=torch.float32),
                            1, c)

    out = {"phase": "P2", "B": EVAL_BATCH, "C": n_cand, "users": N_USERS,
           "items": N_ITEMS, "d": DIM, "max_abs_err": err,
           "int32_vs_int64_mismatch": int32_mismatch,
           "out_of_range_mismatch": oor_mismatch,
           "odd_shape_mismatch": odd_mismatch}
    # the library route on the probe's ids, by eager launches (the host's
    # launch cost included, as the probe pays it) and by CUDA-graph replay
    # (the device alone)
    out["library_ms"] = per_batch(library, probe, 10)
    out["library_graph_ms"] = per_batch(library, probe, 20, graph_ms)
    out["library_calls"] = 3
    out["plain_ms"] = per_batch(plain, probe, 3)
    # the scorer, one launch of the kernel, as the probe calls it (int64
    # strided ids), on contiguous int32 ids (run G's inputs) and on one
    # table row: eager and graph ms, and the device kernels of one call by
    # torch.profiler
    scorer = scorer_timing.measure((ue_t, tab), rows, N_ITEMS)
    out["scorer"] = {k: scorer[k] for k in ("probe", "int32", "one_row")}
    out["ms"], out["graph_ms"] = (scorer["probe"]["ms"],
                                  scorer["probe"]["graph_ms"])
    kernels = scorer["probe"]["kernels"]
    out["device_kernels_per_call"] = sum(n for n, _ in kernels.values())
    check(out["device_kernels_per_call"] == 1
          and all("candidate_scores_kernel" in k for k in kernels),
          f"one P2 scorer call launched {kernels}, expected one "
          f"candidate_scores_kernel")
    # the rate at which the candidates' table rows arrive from L2, and the
    # floor of a gather design at the K2 and P3 phases' best L2 rate
    out["l2_gather_bytes"] = scorer["l2_gather_bytes"]
    out["l2_gather_tb_s"] = scorer["l2_gather_tb_s"]
    out["l2_rates_k2_p3_tb_s"] = l2_rates
    out["l2_gather_floor_ms"] = out["l2_gather_bytes"] / max(l2_rates) * 1e-9
    # per call, the mean over the batches, for the probe's int64 ids and
    # for int32 ones
    out["flops"] = 2 * EVAL_BATCH * n_cand * DIM
    for key, parts in (("", probe), ("int32_", int32)):
        out[f"{key}bytes"] = sum(p2_bytes(torch, u, c) for u, c in parts) / nb
        out[f"{key}bound_ms"], out[f"{key}bound_by"] = bound_ms(
            out["flops"], out[f"{key}bytes"], PEAK_BF16_FLOPS)
    out["tpu_design_flops"] = 2 * EVAL_BATCH * N_ITEMS * DIM
    log = _build.build_log()
    out["build"] = {ids: build_usage(log, f"candidate_scores_kernelI{mangled}")
                    for ids, mangled in (("int64", "ll"), ("int32", "ii"))}
    emit(out)
    return {"max_abs_err": err["randn"],
            **{k: out[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")}}


def phase_p3(torch, rows):
    from sml_tpu_torch import _build
    from sml_tpu_torch.ops import probe_kernels as pk
    from sml_tpu_torch.scripts.eval_variants import build_candidate_mask

    ipad = -(-N_ITEMS // 2048) * 2048
    maskm = build_candidate_mask(rows, ipad)                  # targets in
    check(int(maskm.sum(dtype=torch.int64)) == EVAL_ROWS * (rows.shape[1] - 1),
          "the dense masks do not hold one entry per distinct candidate")
    tgt = rows[:, 1]
    g = torch.Generator().manual_seed(SEED + 93)
    mismatch = {"int": 0, "randn": 0}
    max_diff = 0
    tables = {}
    for kind in ("int", "randn"):
        tab = torch.zeros(ipad, DIM, dtype=torch.bfloat16, device="cuda")
        tab[:N_ITEMS] = int_or_randn(torch, g, (N_ITEMS, DIM), kind)
        ue = int_or_randn(torch, g, (EVAL_ROWS, DIM), kind)
        tables[kind] = (tab, ue)
        for s in range(0, EVAL_ROWS, EVAL_BATCH):
            sl = slice(s, s + EVAL_BATCH)
            want = pk.dense_mask_rank_plain(tab, ue[sl], tgt[sl], maskm[sl])
            got = pk.dense_mask_rank_cuda(tab, ue[sl], tgt[sl], maskm[sl])
            mismatch[kind] += int((got != want).sum())
            max_diff = max(max_diff, int((got - want).abs().max()))
    # edge-case rows on the integer tables, exact
    tab, ue = tables["int"]
    edge, edge_tgt = maskm[:EDGE_ROWS].clone(), tgt[:EDGE_ROWS].clone()
    p3_edge_rows(edge, edge_tgt, N_ITEMS, ipad)
    want = pk.dense_mask_rank_plain(tab, ue[:EDGE_ROWS], edge_tgt, edge)
    check(int(want[0]) == 0 and 0 < int(want[1]) < N_ITEMS,
          f"P3 edge rows: plain ranks {want[:4].tolist()}")
    edge_mismatch = int((pk.dense_mask_rank_cuda(
        tab, ue[:EDGE_ROWS], edge_tgt, edge) != want).sum())
    torch.cuda.synchronize()
    check(mismatch["int"] == 0,
          f"P3 ranks differ on integer tables: {mismatch}")
    check(edge_mismatch == 0,
          f"P3 ranks differ on {edge_mismatch} edge-case rows")
    check(mismatch["randn"] <= K2_RANDOM_FLIPS_PER_16K,
          f"P3 random-table flips {mismatch} over "
          f"{K2_RANDOM_FLIPS_PER_16K} per {EVAL_ROWS} rows")

    tab, ue = tables["randn"]
    tab_t = tab.T.contiguous()
    parts = [(ue[s:s + EVAL_BATCH], tgt[s:s + EVAL_BATCH],
              maskm[s:s + EVAL_BATCH]) for s in range(0, EVAL_ROWS,
                                                      EVAL_BATCH)]
    nb = len(parts)

    def per_batch(fn, iters, timer=cuda_ms):
        return timer(lambda: [fn(*b) for b in parts], iters) / nb

    def p3(u, t, m):
        return pk.dense_mask_rank_cuda(tab, u, t, m)

    zero = torch.zeros_like(maskm[:EVAL_BATCH])

    def empty(u, t, m):
        return p3(u, t, zero)

    def library(u, t, m):
        return torch.mm(u, tab_t, out_dtype=torch.float32)

    out = {"phase": "P3", "B": EVAL_BATCH, "I_pad": ipad, "d": DIM,
           "candidates": rows.shape[1] - 1, "rank_mismatch": mismatch,
           "edge_rows": EDGE_ROWS, "edge_rank_mismatch": edge_mismatch,
           "max_abs_rank_diff": max_diff}
    # each by eager launches (as every kernel is timed and as the probe
    # pays) and by CUDA-graph replay (the device alone)
    for key, fn in (("", p3), ("empty_mask_", empty), ("library_", library)):
        out[f"{key}ms"] = per_batch(fn, 10)
        out[f"{key}graph_ms"] = per_batch(fn, 20, graph_ms)
    out["plain_ms"] = per_batch(
        lambda u, t, m: pk.dense_mask_rank_plain(tab, u, t, m), 3)
    out["build"] = build_usage(_build.build_log(), "dense_mask_rank_kernel")
    # per call: the int8 mask, the bf16 table, ue, tgt and rank once each;
    # the scores of the set entries and of each row's target
    set_entries = int(maskm.sum(dtype=torch.int64)) / nb
    nbytes = EVAL_BATCH * ipad + ipad * DIM * 2 + EVAL_BATCH * DIM * 2 \
        + 2 * EVAL_BATCH * 4
    flops = 2 * DIM * (set_entries + EVAL_BATCH)
    out["bound_ms"], out["bound_by"] = bound_ms(flops, nbytes,
                                                PEAK_BF16_FLOPS)
    out["flops"], out["bytes"] = flops, nbytes
    out["tpu_design_flops"] = 2 * 2 * EVAL_BATCH * ipad * DIM
    out["l2_gather_bytes"] = (set_entries + EVAL_BATCH) * DIM * 2
    out["l2_gather_tb_s"] = out["l2_gather_bytes"] / (
        out["graph_ms"] - out["empty_mask_graph_ms"]) * 1e-9
    emit(out)
    return {"max_abs_err": max_diff,
            **{k: out[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")}}, out["l2_gather_tb_s"]


def phase_eval_probes(torch):
    from sml_tpu_torch.ops import probe_kernels as pk
    from sml_tpu_torch.scripts import eval_variants as ev

    pk.candidate_scores_cuda.launches = 0
    pk.dense_mask_rank_cuda.launches = 0
    t0 = time.perf_counter()
    res = quiet_main(ev.main, ["--device", "cuda", "--rounds",
                               str(PROBE_ROUNDS)])
    wall = time.perf_counter() - t0
    launches = {"candidate_scores_kernel": pk.candidate_scores_cuda.launches,
                "dense_mask_rank_kernel": pk.dense_mask_rank_cuda.launches}
    names = ("v0_gather_f32", "v1_gather_bf16", "v2_matmul_gather",
             "v3_matmul_bf16", "v4_pallas", "v5_masked_xla_f32",
             "v5b_masked_xla_bf16", "v6_masked_pallas")
    missing = [n for n in names if n not in res or "error" in res[n]]
    check(not missing, f"eval_variants variants failed: "
                       f"{ {n: res.get(n) for n in missing} }")
    # one launch per 1024-row batch, in the warm-up run and every round
    want = res["rows"] // ev.BATCH * (1 + PROBE_ROUNDS)
    check(launches == {"candidate_scores_kernel": want,
                       "dense_mask_rank_kernel": want},
          f"probe launches {launches}, expected {want} each")
    # P2 and P3 score bf16 inputs exactly; only sums in another order
    # separate them from the bf16 gather and masked matmul variants
    for a, b in (("v4_pallas", "v1_gather_bf16"),
                 ("v6_masked_pallas", "v5b_masked_xla_bf16")):
        check(abs(res[a]["hit_sum@20"] - res[b]["hit_sum@20"])
              <= SLICE_HIT_TOL, f"{a} and {b} hit sums differ: "
                                f"{res[a]['hit_sum@20']} {res[b]['hit_sum@20']}")
    emit({"phase": "eval-probes", "rows": res["rows"], "items": res["items"],
          "cands": res["cands"], "rounds": PROBE_ROUNDS, "wall_s": wall,
          "mask_build_ms": res["mask_build_ms"], "launches": launches,
          "variants": {n: {k: res[n][k] for k in (
              "total_ms", "speedup_vs_v0", "hit_sum@20",
              "max_hit_delta_vs_v0")} for n in names}})
    return launches


def recall_floor(z: float) -> float:
    p = RANDOM_RECALL20
    return p + z * math.sqrt(p * (1.0 - p) / PRE_ROWS)


def write_pretrain_dataset(root: str):
    from sml_tpu_torch.config import DataSpec
    from sml_tpu_torch.data.synthetic import (SyntheticSpec,
                                              generate_synthetic_dataset)
    generate_synthetic_dataset(os.path.join(root, "synth"), SyntheticSpec(
        n_users=N_USERS, n_items=N_ITEMS, n_periods=PRE_PERIODS,
        interactions_per_period=PRE_ROWS, first_test_period=PRE_TEST,
        neg_num=NEG, seed=SEED))
    return DataSpec(root=root, name="synth", num_periods=PRE_PERIODS,
                    online_train_start=1, online_test_start=PRE_TEST + 1)


class Records:
    """A metrics logger that keeps the records."""

    def __init__(self):
        self.records = []

    def log(self, **record):
        self.records.append(record)


class EagerEpochs:
    """The MF epochs called one by one, as the loops ran them before their
    epoch programs (``PlainEpochProgram``'s and ``EpochProgram``'s
    interfaces): what a graphed run is held to."""

    def __init__(self, epoch, *_):
        self.epoch = epoch

    def run(self, mf, opt, padded, gen, index):
        return self.epoch(mf, opt, padded.rows, padded.mask, padded.n_real,
                          gen, index)

    def run_taken(self, mf, opt, inputs, index, taken, gen):
        return self.epoch(mf, opt, *inputs, taken, gen, index)


def same_tables(torch, a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def phase_pretrain(torch, spec, data_s):
    from sml_tpu_torch.config import PretrainConfig
    from sml_tpu_torch.data.feeder import StreamingPeriods
    from sml_tpu_torch.models.mf import MFParams
    from sml_tpu_torch.ops import adam_kernel as ak
    from sml_tpu_torch.ops.batching import pad_rows
    from sml_tpu_torch.ops.sampling import build_period_index
    from sml_tpu_torch.train.graphs import GraphSite
    from sml_tpu_torch.train.optim import adam_init
    from sml_tpu_torch.train.pretrain import pretrain_mf
    from sml_tpu_torch.train.steps import (PlainEpochProgram,
                                           make_plain_mf_epoch)

    cfg = PretrainConfig(batch_size=PRE_BATCH, max_epochs=PRE_EPOCHS,
                         eval_every=1, emb_init_scale=PRE_INIT_SCALE)
    logger = Records()
    ak.decay_adam_cuda.launches = 0
    site = GraphSite("cuda")
    t0 = time.perf_counter()
    params, metrics = pretrain_mf(cfg, spec, PRE_TEST, logger=logger,
                                  device="cuda", site=site)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k3_auto = ak.decay_adam_cuda.launches
    evals = [{k: r[k] for k in ("epoch", "loss", "recall@20")}
             for r in logger.records]

    # PRE_GRAPH_EPOCHS dense and forced fast_lr (K3) plain epochs from the
    # best tables through an epoch program (the warm-up, a capture, then
    # replays) and called eagerly, from one generator seed: equal tables,
    # moments and generators
    train, _ = StreamingPeriods(spec).get_next(PRE_TEST)
    padded = pad_rows(train, PRE_BATCH, device="cuda")
    index = build_period_index(train, N_ITEMS, device="cuda")
    steps = -(-padded.n_real // PRE_BATCH)
    modes = {}
    for name, fast_lr in (("dense", None), ("fast", cfg.lr)):
        epoch = make_plain_mf_epoch(PRE_BATCH, cfg.l2_user, cfg.l2_item,
                                    cfg.lr, fast_lr=fast_lr)
        runs = {}
        for route in ("eager", "graph"):
            mf = MFParams(*(t.clone() for t in params))
            opt = adam_init(mf._asdict())
            gen = torch.Generator(device="cuda").manual_seed(SEED + 101)
            ep_site = GraphSite("cuda")
            runner = (EagerEpochs(epoch) if route == "eager" else
                      PlainEpochProgram(epoch, ep_site, mf, opt, padded,
                                        index, PRE_BATCH))
            ak.decay_adam_cuda.launches = 0
            epoch_s, losses = [], None
            for _ in range(PRE_GRAPH_EPOCHS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mf, opt, losses = runner.run(mf, opt, padded, gen, index)
                torch.cuda.synchronize()
                epoch_s.append(time.perf_counter() - t0)
            check(bool(torch.isfinite(losses).all()),
                  f"{name} {route} losses not finite")
            runs[route] = {"mf": mf, "opt": opt, "gen": gen,
                           "epoch_s": epoch_s, "stats": dict(ep_site.stats),
                           "k3": ak.decay_adam_cuda.launches}
        eager, graph = runs["eager"], runs["graph"]
        stats = graph["stats"]
        modes[name] = {
            "eager_step_ms": [1e3 * t / steps for t in eager["epoch_s"]],
            "graph_epoch_s": graph["epoch_s"], "graph_stats": stats,
            # the last epoch is a replay alone
            "replay_step_ms": 1e3 * graph["epoch_s"][-1] / steps,
            "k3_launches": {r: runs[r]["k3"] for r in runs},
            "tables_equal": same_tables(torch, graph["mf"], eager["mf"]),
            "moments_equal": all(
                torch.equal(getattr(graph["opt"], part)[k],
                            getattr(eager["opt"], part)[k])
                for part in ("mu", "nu") for k in graph["opt"].mu),
            "generators_equal": bool(torch.equal(
                graph["gen"].get_state(), eager["gen"].get_state()))}
        want_k3 = steps * PRE_GRAPH_EPOCHS if fast_lr else 0
        check([stats[k] for k in ("programs", "warmups", "captures",
                                  "replays")]
              == [1, 1, 1, PRE_GRAPH_EPOCHS - 1]
              and modes[name]["k3_launches"] == {"eager": want_k3,
                                                 "graph": want_k3}
              and modes[name]["tables_equal"]
              and modes[name]["moments_equal"]
              and modes[name]["generators_equal"],
              f"{name}: the graphed epochs against the eager ones: "
              f"{modes[name]}")
    emit({"phase": "pretrain", "users": N_USERS, "items": N_ITEMS,
          "periods": PRE_TEST, "train_rows": int(train.shape[0]),
          "batch": PRE_BATCH, "data_s": data_s, "wall_s": wall,
          "graphs": site.stats, "evals": evals, "metrics": metrics,
          "random_recall@20": RANDOM_RECALL20,
          "recall@20_floor": recall_floor(PRE_RECALL_Z),
          "k3_launches_auto": k3_auto, "plain_epoch_steps": steps,
          "epochs": modes})
    check(k3_auto == 0, f"K3 launched {k3_auto} times under the auto rule "
                        f"at {N_USERS + N_ITEMS} table rows, expected 0")
    check([site.stats[k] for k in ("programs", "captures")] == [1, 1]
          and site.stats["warmups"] + site.stats["replays"] == len(evals),
          f"pretrain's epoch program: {site.stats} for {len(evals)} epochs")
    check(all(math.isfinite(e["loss"]) for e in evals),
          "a pretrain loss is not finite")
    check(metrics["recall@20"] >= recall_floor(PRE_RECALL_Z),
          f"pretrain recall@20 {metrics['recall@20']} is not clearly above "
          f"random ({RANDOM_RECALL20})")
    return params


def phase_baselines(torch, spec, pretrained):
    from sml_tpu_torch.config import BaselineConfig
    from sml_tpu_torch.train import baselines

    def run(method, epochs):
        cfg = BaselineConfig(method=method, epochs=epochs,
                             batch_size=PRE_BATCH, pool_size=BASE_POOL,
                             start_period=PRE_TEST + 1, seed=SEED)
        logger = Records()
        t0 = time.perf_counter()
        driver = baselines.BaselineDriver(cfg, spec, pretrained=pretrained,
                                          logger=logger, device="cuda")
        summary = driver.run()
        torch.cuda.synchronize()
        return driver, summary, logger, time.perf_counter() - t0

    out = {"phase": "baselines", "periods": [PRE_TEST + 1, PRE_TEST + 2],
           "epochs": BASE_EPOCHS, "batch": PRE_BATCH, "methods": {},
           "graphed_against_eager": {}}
    draw_cdf, cdf_s = baselines.draw_cdf, []

    def timed_cdf(probs):
        # spmf's draw distribution, scanned on the host before every epoch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cdf = draw_cdf(probs)
        torch.cuda.synchronize()
        cdf_s.append(time.perf_counter() - t0)
        return cdf
    for method in ("full", "fine", "spmf"):
        baselines.draw_cdf = timed_cdf if method == "spmf" else draw_cdf
        try:
            driver, summary, logger, wall = run(method, BASE_EPOCHS)
        finally:
            baselines.draw_cdf = draw_cdf
        out["methods"][method] = {
            "wall_s": wall, "summary": summary,
            "graphs": dict(driver.graph_stats),
            "records": [{k: v for k, v in r.items() if k != "ts"}
                        for r in logger.records]}
    # the host scan's share of spmf's wall: its calls (one an epoch) and
    # their mean and total milliseconds
    out["methods"]["spmf"]["host_cdf"] = {
        "calls": len(cdf_s), "mean_ms": 1e3 * sum(cdf_s) / len(cdf_s),
        "total_ms": 1e3 * sum(cdf_s)}
    # each method over BASE_GRAPH_EPOCHS epochs a period: the epoch
    # program (one capture for the run) against the epochs called eagerly
    for method in ("full", "fine", "spmf"):
        runs = {}
        for route in ("graph", "eager"):
            saved = (baselines.PlainEpochProgram, baselines.EpochProgram)
            if route == "eager":
                baselines.PlainEpochProgram = EagerEpochs
                baselines.EpochProgram = EagerEpochs
            try:
                runs[route] = run(method, BASE_GRAPH_EPOCHS)
            finally:
                baselines.PlainEpochProgram, baselines.EpochProgram = saved
        (gd, gsum, _, gwall), (ed, esum, _, ewall) = (runs["graph"],
                                                      runs["eager"])
        res = {"graph_wall_s": gwall, "eager_wall_s": ewall,
               "graphs": dict(gd.graph_stats),
               "tables_equal": same_tables(torch, gd.mf, ed.mf),
               "moments_equal": all(
                   torch.equal(getattr(gd.opt, part)[k],
                               getattr(ed.opt, part)[k])
                   for part in ("mu", "nu") for k in gd.opt.mu),
               "recall_equal": gd.recall == ed.recall,
               "generators_equal": bool(torch.equal(gd.gen.get_state(),
                                                    ed.gen.get_state()))}
        out["graphed_against_eager"][method] = res
        runs_n = 2 * BASE_GRAPH_EPOCHS
        check([res["graphs"][k] for k in ("programs", "warmups", "captures",
                                          "replays")]
              == [1, 1, 1, runs_n - 1] and res["tables_equal"]
              and res["moments_equal"] and res["recall_equal"]
              and res["generators_equal"],
              f"{method}: the graphed epochs against the eager ones: {res}")
    out["recall@20_floor"] = recall_floor(BASE_RECALL_Z)
    emit(out)
    for method, res in out["methods"].items():
        recs = res["records"]
        check([r["period"] for r in recs] == out["periods"]
              and all(r["kind"] == "baseline_test" for r in recs),
              f"{method}: expected baseline_test records for "
              f"{out['periods']}: {recs}")
        for r in recs:
            vals = {k: v for k, v in r.items()
                    if k.startswith(("recall", "ndcg", "hit_new"))}
            check("hit_new_user@20" in vals and "hit_new_item@20" in vals,
                  f"{method}: no attributed fields in {r}")
            check(all(0.0 <= v <= 1.0 for v in vals.values()),
                  f"{method}: metrics out of [0, 1]: {r}")
        check(all(0.0 <= v <= 1.0 for v in res["summary"].values()),
              f"{method}: summary out of [0, 1]: {res['summary']}")
        # one program a method, the first epoch its warm-up, the second
        # its capture (spmf's too since its epoch became a program)
        check([res["graphs"][k] for k in ("programs", "warmups",
                                          "captures")] == [1, 1, 1],
              f"{method}: epoch programs {res['graphs']}")
    full = out["methods"]["full"]["records"]
    check(min(r["recall@20"] for r in full) >= out["recall@20_floor"],
          f"full retrain recall@20 not above random: {full}")


def kinds_cfg(kind: str):
    """The replay-mode engine config of one transfer kind, with H as the
    ``sml`` CLI sets it (1024 for conv_com_root, 512 otherwise; mlp_delta
    and gated have their own fixed width)."""
    from sml_tpu_torch.config import TransferConfig, yelp_sml
    return yelp_sml().replace(
        replay_mode=True, tr_batch_size=KINDS_OUTER_ROWS,
        transfer=TransferConfig(
            latent_dim=DIM, kind=kind,
            fc_hidden=1024 if kind == "conv_com_root" else HIDDEN))


def kinds_state(torch, eng, hat, last):
    """A fresh state whose snapshots are ``hat`` and ``last`` (CPU MF
    tables), copied to the engine's device."""
    state = eng.init_state(pretrained_mf=hat)
    dev = eng.device
    return state._replace(last_user=last.user_emb.to(dev, copy=True),
                          last_item=last.item_emb.to(dev, copy=True))


def phase_transfer_kinds(torch, dev: str = "cuda"):
    """Each transfer kind at the Yelp widths: one full-table refresh and
    one replay-mode outer (Θ) step on ``dev`` and on the CPU."""
    from sml_tpu_torch.models.transfer import theta_leaves
    from sml_tpu_torch.ops import transfer_kernel as tk
    from sml_tpu_torch.train.engine import SMLEngine

    t_phase = time.perf_counter()
    hat = random_tables(torch, SEED + 91)
    last = random_tables(torch, SEED + 92)
    rows = seeded_rows(KINDS_OUTER_ROWS, SEED + 93)
    out = {}
    for kind in TRANSFER_KINDS:
        cfg = kinds_cfg(kind)
        runs = {}
        for where in (dev, "cpu"):
            eng = SMLEngine(cfg, N_USERS, N_ITEMS, device=where)
            state = kinds_state(torch, eng, hat, last)
            eng.refresh(state)                       # warm-up
            if where == "cuda":
                torch.cuda.synchronize()
            tk.transfer_rows_cuda.launches = 0
            t0 = time.perf_counter()
            state = eng.refresh(state)
            if where == "cuda":
                torch.cuda.synchronize()
            refresh_ms = (time.perf_counter() - t0) * 1e3
            k1 = tk.transfer_rows_cuda.launches
            state, loss = eng.outer_epoch(state, *eng.prep_outer(rows))
            runs[where] = dict(
                state=state, loss=float(loss[0]), refresh_ms=refresh_ms,
                k1=k1, theta={k: v.detach().cpu()
                              for k, v in theta_leaves(state.theta).items()})
        g, c = runs[dev], runs["cpu"]
        want_k1 = 2 if (kind == "conv_com" and dev == "cuda") else 0
        check(g["k1"] == want_k1, f"{kind}: K1 launched {g['k1']} times in "
                                  f"one refresh, expected {want_k1}")
        check(c["k1"] == 0, f"{kind}: K1 launched on the CPU")
        err = max((getattr(g["state"].mf, f).cpu()
                   - getattr(c["state"].mf, f)).abs().max().item()
                  for f in ("user_emb", "item_emb"))
        check(err <= KINDS_TOL, f"{kind}: refresh differs from the CPU by "
                                f"{err} > {KINDS_TOL}")
        theta_err = max((g["theta"][k] - c["theta"][k]).abs().max().item()
                        for k in g["theta"])
        check(theta_err <= KINDS_TOL, f"{kind}: Θ after one outer step "
                                      f"differs by {theta_err}")
        rel = abs(g["loss"] - c["loss"]) / abs(c["loss"])
        check(math.isfinite(g["loss"]) and rel <= LOSS_RTOL,
              f"{kind}: outer loss {g['loss']} vs CPU {c['loss']}")
        out[kind] = {"hidden": cfg.transfer.fc_hidden,
                     "refresh_ms": g["refresh_ms"],
                     "cpu_refresh_ms": c["refresh_ms"],
                     "refresh_max_abs_err": err, "k1_launches": g["k1"],
                     "outer_loss": g["loss"], "outer_loss_rel_err": rel,
                     "theta_max_abs_err": theta_err}
    emit({"phase": "transfer-kinds", "users": N_USERS, "items": N_ITEMS,
          "d": DIM, "outer_rows": KINDS_OUTER_ROWS, "kinds": out,
          "phase_s": time.perf_counter() - t_phase})
    return out


def write_ingest_csv(path: str, seed: int) -> int:
    """A raw event log with a header: 64-bit non-dense user and item ids
    (N_USERS users, N_ITEMS items, each at least once), integer
    timestamps laid out so that a 4-period time split holds
    INGEST_PERIOD_EVENTS events per period, rows out of time order.
    Returns the event count."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n = sum(INGEST_PERIOD_EVENTS)

    def raw_ids(count):
        ids = np.unique(rng.integers(2 ** 40, 2 ** 62, count + 1000))
        return rng.permutation(ids)[:count]

    def cover(count):
        idx = np.concatenate([np.arange(count),
                              rng.integers(0, count, n - count)])
        return rng.permutation(idx)

    base, w = 1_500_000_000, INGEST_PERIOD_SECONDS
    ts = np.concatenate([base + p * w + rng.integers(0, w, c)
                         for p, c in enumerate(INGEST_PERIOD_EVENTS)])
    ts[0], ts[-1] = base, base + len(INGEST_PERIOD_EVENTS) * w
    users = raw_ids(N_USERS)[cover(N_USERS)]
    items = raw_ids(N_ITEMS)[cover(N_ITEMS)]
    order = rng.permutation(n)
    with open(path, "w") as fh:
        fh.write("user_id,item_id,timestamp\n")
        np.savetxt(fh, np.stack([users, items, ts[order]], axis=1),
                   fmt="%d", delimiter=",")
    return n


def check_ingested(path: str, n_events: int) -> dict:
    """The ingested dataset's periods, and the eval-row contract of its
    test file: 999 distinct negatives per row from the catalog, none in
    the user's history."""
    import numpy as np
    from sml_tpu_torch.data.formats import load_info, load_test, load_train
    info = load_info(path)
    check((info.n_interactions, info.n_users, info.n_items)
          == (n_events, N_USERS, N_ITEMS), f"ingested info {info}")
    train = [load_train(path, p) for p in range(len(INGEST_PERIOD_EVENTS))]
    check(tuple(len(t) for t in train) == INGEST_PERIOD_EVENTS,
          f"period sizes {[len(t) for t in train]}")
    test = load_test(path, len(train) - 1)
    check(test.shape == (INGEST_PERIOD_EVENTS[-1], 2 + NEG),
          f"test file shape {test.shape}")
    check(np.array_equal(test[:, :2], train[-1]),
          "test rows are not the last period's events")
    negs = np.sort(test[:, 2:], axis=1)
    check(bool((np.diff(negs, axis=1) != 0).all()),
          "a test row repeats a negative")
    check(bool(((negs >= 0) & (negs < N_ITEMS)).all()),
          "a negative lies outside the catalog")
    hist = np.concatenate(train)
    seen = np.unique(hist[:, 0] * N_ITEMS + hist[:, 1])
    check(not np.isin(test[:, :1] * N_ITEMS + negs, seen).any(),
          "a negative is in its user's history")
    return {"periods": [len(t) for t in train],
            "test_file_bytes": os.path.getsize(
                os.path.join(path, "test", f"{len(train) - 1}.npy"))}


def read_trace(path: str, busy_in=(), count_in=()) -> dict:
    """From a Chrome trace of ``torch.profiler``: the union of the device
    kernels' intervals, the five kernels with the most total time, the
    calls and wall ms of each annotated span, for the spans named in
    ``busy_in`` the kernels' busy ms inside them, and for those in
    ``count_in`` the kernels launched inside them, counted by name (a
    kernel belongs to the runtime call with its correlation id: a graph's
    kernels to its ``cudaGraphLaunch``)."""
    import bisect
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                     if e.get("cat") == "kernel")
    busy_us, end = 0.0, -math.inf
    merged = []
    for s, e in kernels:
        if e > end:
            busy_us += e - max(s, end)
            merged.append([max(s, end), e])
            end = e
    starts = [m[0] for m in merged]

    def busy_between(lo, hi):
        us = 0.0
        for s, e in merged[max(bisect.bisect_right(starts, lo) - 1, 0):]:
            if s >= hi:
                break
            us += max(0.0, min(e, hi) - max(s, lo))
        return us
    span_busy = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"] in busy_in:
            span_busy[e["name"]] = span_busy.get(e["name"], 0.0) + \
                busy_between(e["ts"], e["ts"] + e["dur"]) / 1e3
    by_name, spans = {}, {}
    for e in events:
        if e.get("cat") == "kernel":
            t = by_name.setdefault(e["name"], [0, 0.0])
            t[0] += 1
            t[1] += e["dur"] / 1e3
        elif e.get("cat") == "user_annotation":
            t = spans.setdefault(e["name"], [0, 0.0])
            t[0] += 1
            t[1] += e["dur"] / 1e3
    span_kernels = {}
    for name in count_in:
        ranges = [(e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") == "user_annotation" and e["name"] == name]
        corr = {e["args"]["correlation"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})
                and any(lo <= e["ts"] <= hi for lo, hi in ranges)}
        counts = span_kernels[name] = {}
        for e in events:
            if (e.get("cat") == "kernel"
                    and e.get("args", {}).get("correlation") in corr):
                counts[e["name"]] = counts.get(e["name"], 0) + 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:5]
    return {"kernel_events": len(kernels), "busy_ms": busy_us / 1e3,
            "span_busy_ms": span_busy, "span_kernels": span_kernels,
            "top_kernels": [{"name": k[:120], "count": c, "ms": ms}
                            for k, (c, ms) in top],
            "spans": {k: {"calls": c, "ms": ms} for k, (c, ms) in
                      sorted(spans.items())}}


def split_eval(torch, path: str, period: int, dev: str = "cuda") -> dict:
    """``make_eval_set`` of the ingested test file and an attributed
    evaluation of it, called directly under ``torch.profiler`` after a
    warm-up (on a fresh engine, so the eval set is built, not fetched from
    the upload cache): their wall ms, the trace's spans (the engine's
    hash, padding and upload, and mask) and the device busy ms of the
    evaluation."""
    import numpy as np
    from sml_tpu_torch.config import yelp_sml
    from sml_tpu_torch.data.formats import load_test
    from sml_tpu_torch.train.driver import _load_new_entity_ids
    from sml_tpu_torch.train.engine import SMLEngine
    from sml_tpu_torch.utils.profiling import maybe_trace

    rows = load_test(path, period)
    cfg = yelp_sml().replace(eval_scoring="masked")
    mf = random_tables(torch, SEED + 94)
    mf = type(mf)(*(t.to(dev) for t in mf))
    eng = SMLEngine(cfg, N_USERS, N_ITEMS, device=dev)
    masks = eng.new_entity_masks(*_load_new_entity_ids(path))
    eng.evaluate_attributed(mf, eng.make_eval_set(rows, build_mask=True),
                            *masks)                  # warm-up
    eng = SMLEngine(cfg, N_USERS, N_ITEMS, device=dev)
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)

    def traced(fn):
        """``fn()``, its wall ms and its trace, read."""
        prof = tempfile.mkdtemp(prefix="sml_eval_trace_")
        try:
            with maybe_trace(prof, dev) as trace:
                sync()
                t0 = time.perf_counter()
                out = fn()
                sync()
                ms = (time.perf_counter() - t0) * 1e3
            return out, ms, read_trace(trace)
        finally:
            shutil.rmtree(prof, ignore_errors=True)

    padded, set_ms, set_tr = traced(
        lambda: eng.make_eval_set(rows, build_mask=True))
    rec, eval_ms, eval_tr = traced(
        lambda: eng.evaluate_attributed(mf, padded, *masks))
    check(all(np.isfinite(v) for v in rec.values()),
          f"attributed record not finite: {rec}")
    parts = {k: set_tr["spans"].get(k) for k in
             ("eval_set_check", "eval_set_hash", "eval_set_pad_upload",
              "eval_set_mask")}
    check(all(v is not None and v["calls"] == 1 for v in parts.values()),
          f"make_eval_set's spans missing from its trace: {set_tr['spans']}")
    return {"make_eval_set_ms": set_ms, "make_eval_set_parts": parts,
            "evaluate_attributed_ms": eval_ms,
            "evaluate_device_busy_ms": eval_tr["busy_ms"],
            "evaluate_kernel_events": eval_tr["kernel_events"]}


def check_attribution_records(recs) -> None:
    """Each ``test`` record of an attributed ``sml`` run is followed by
    its ``test_attribution`` record, whose ``_of_test`` buckets sum to the
    test's recall@20 within 1e-5."""
    tests = [r for r in recs if r["kind"] == "test"]
    attrs = [r for r in recs if r["kind"] == "test_attribution"]
    order = [(r["kind"], r.get("period")) for r in recs
             if r["kind"] in ("test", "test_attribution")]
    check(len(tests) == len(attrs) >= 1
          and [t["period"] for t in tests] == [a["period"] for a in attrs]
          and all(("test_attribution", p) in order[i + 1:]
                  for i, (k, p) in enumerate(order) if k == "test"),
          f"test / test_attribution records out of order: {order}")
    buckets = ("old_user_old_item", "old_user_new_item",
               "new_user_old_item", "new_user_new_item")
    for t, a in zip(tests, attrs):
        of_test = sum(a[f"{b}_of_test"] for b in buckets)
        check(abs(of_test - t["recall@20"]) <= 1e-5,
              f"_of_test buckets sum to {of_test}, recall@20 "
              f"{t['recall@20']}")


def phase_ingest_sweep(torch, dev: str = "cuda"):
    """``python -m sml_tpu_torch ingest`` on a seeded raw log at the Yelp
    widths, then the ``sml`` CLI on its output with attribution, once
    untraced and once with the profiler: its K2, K3 and K1 launches
    against the counts derived from the data and its config, its records,
    and its trace."""
    from sml_tpu_torch import cli
    from sml_tpu_torch.config import DataSpec
    from sml_tpu_torch.data.formats import row_count
    from sml_tpu_torch.ops import adam_kernel as ak
    from sml_tpu_torch.ops import eval_kernel as ek
    from sml_tpu_torch.ops import transfer_kernel as tk

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="sml_ingest_")
    try:
        csv = os.path.join(root, "log.csv")
        t0 = time.perf_counter()
        n_events = write_ingest_csv(csv, SEED + 95)
        csv_s = time.perf_counter() - t0
        out = os.path.join(root, "ingested")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "sml_tpu_torch", "ingest", "--csv", csv,
             "--out", out, "--periods", str(len(INGEST_PERIOD_EVENTS)),
             "--first-test", str(len(INGEST_PERIOD_EVENTS) - 1),
             "--neg-num", str(NEG), "--split", "time"],
            capture_output=True, text=True, timeout=600)
        ingest_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"ingest failed:\n{proc.stderr}")
        info = json.loads(proc.stdout.strip().splitlines()[-1])
        contract = check_ingested(out, n_events)

        spec = DataSpec(root=root, name="ingested",
                        num_periods=len(INGEST_PERIOD_EVENTS),
                        online_train_start=1,
                        online_test_start=len(INGEST_PERIOD_EVENTS) - 1)
        base = ["--device", dev, "sml", "--data-root", root,
                "--data-name", spec.name,
                "--num-periods", str(spec.num_periods),
                "--online-train-start", str(spec.online_train_start),
                "--online-test-start", str(spec.online_test_start),
                *INGEST_SML_ARGS]
        cfg = cli.sml_config(cli.build_parser().parse_args(base))
        want = expected_sweep_launches(
            spec, cfg, lambda kind, p: row_count(spec.path, kind, p),
            lambda n: -(-n // cfg.eval_batch_size))
        check(want["masked_rank_gather_kernel"] > 0,
              f"the ingested sweep tests nothing: {want}")

        def run_sml(name, *extra):
            """The sml CLI on the ingested dataset: its wall s, launches
            and records, checked."""
            jl = os.path.join(root, f"{name}.jsonl")
            zero_counts(ak, tk, ek)
            t0 = time.perf_counter()
            rc = quiet_main(cli.main, [*base, "--metrics-jsonl", jl, *extra])
            if dev == "cuda":
                torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches = kernel_counts(ak, tk, ek)
            check(rc == 0, f"sml ({name}) exited {rc}")
            if dev == "cuda":
                check(launches == want, f"sml ({name}) launches {launches}, "
                      f"derived from the data {want}")
            with open(jl) as fh:
                recs = [json.loads(line) for line in fh]
            check_attribution_records(recs)
            return wall_s, launches, recs

        # the same run untraced, then with period 0 traced: the traced
        # period's wall holds the profiler's own cost, the untraced one
        # does not
        sml_s, launches, recs = run_sml("untraced")
        prof = os.path.join(root, "profile")
        traced_s, _, traced_recs = run_sml("traced", "--profile-dir", prof)
        traces = [f for f in os.listdir(prof) if f.endswith(".json")]
        check(len(traces) == 1, f"expected one trace, found {traces}")
        trace_bytes = os.path.getsize(os.path.join(prof, traces[0]))
        t0 = time.perf_counter()
        tr = read_trace(os.path.join(prof, traces[0]))
        read_trace_s = time.perf_counter() - t0

        def period0_ms(rs):
            return 1e3 * next(r["seconds"] for r in rs
                              if r["kind"] == "period" and r["d_time"] == 0)
        wall_ms, untraced_ms = period0_ms(traced_recs), period0_ms(recs)
        check(tr["kernel_events"] > 0 or dev != "cuda",
              "the trace holds no device kernel")
        # "auto" fuses on the card: the traced warm-up period is one
        # period_step (a replay enters no per-epoch span), then a refresh
        want_spans = ({"refresh", "period_step"} if dev == "cuda"
                      and cfg.fuse_phases and cfg.fuse_period == "auto"
                      else {"refresh", "inner_epoch", "outer_epoch"})
        check(want_spans <= set(tr["spans"]),
              f"annotated spans missing from the trace: {tr['spans']}")
        split = split_eval(torch, out, spec.online_test_start, dev)
        emit({"phase": "ingest-sweep", "events": n_events, "info": info,
              **contract, "csv_s": csv_s, "ingest_s": ingest_s,
              "sml_args": INGEST_SML_ARGS, "sml_s": sml_s, "traced_sml_s": traced_s,
              "launches": launches, "derived_launches": want,
              "period_s": [r["seconds"] for r in recs
                           if r["kind"] == "period"],
              "traced_period_s": [r["seconds"] for r in traced_recs
                                  if r["kind"] == "period"],
              "tests": [{k: t[k] for k in ("period", "n_test", "recall@20")}
                        for t in recs if t["kind"] == "test"],
              "attribution": [a for a in recs
                              if a["kind"] == "test_attribution"],
              "trace": {"bytes": trace_bytes, "read_s": read_trace_s,
                        "period_wall_ms": wall_ms,
                        "untraced_period_wall_ms": untraced_ms,
                        "device_busy_share": tr["busy_ms"] / wall_ms,
                        "device_busy_share_of_untraced":
                            tr["busy_ms"] / untraced_ms, **tr},
              **split, "phase_s": time.perf_counter() - t_phase})
    finally:
        shutil.rmtree(root, ignore_errors=True)


def scale_refresh_error(torch, state) -> float:
    """The largest difference between the final tables and K1's plain
    version on the same snapshots and Θ, over each side's first and last
    ``SCALE_SAMPLE`` rows and ``SCALE_SAMPLE`` drawn at random."""
    from sml_tpu_torch.ops.transfer_kernel import transfer_rows_plain
    g = torch.Generator(device="cuda").manual_seed(SEED + 61)
    err = 0.0
    for table, last, hat, tower in (
            (state.mf.user_emb, state.last_user, state.hat_user,
             state.theta.user),
            (state.mf.item_emb, state.last_item, state.hat_item,
             state.theta.item)):
        n = table.shape[0]
        rows = torch.cat([
            torch.arange(SCALE_SAMPLE, device="cuda"),
            torch.arange(n - SCALE_SAMPLE, n, device="cuda"),
            torch.randint(0, n, (SCALE_SAMPLE,), generator=g,
                          device="cuda")])
        want = transfer_rows_plain(tower, last[rows], hat[rows])
        err = max(err, (table[rows] - want).abs().max().item())
    return err


def scale_recount(torch, mf, rows) -> dict:
    """The card's ranks of eval-format ``rows`` on the tables ``mf`` (the
    engine's gather ranker) against a recount in f64 on the CPU: each rank
    must lie between the candidates whose f64 score beats the target's by
    more than ``bound`` and those within ``bound`` of it or above, where
    ``bound`` is twice the worst-case f32 rounding of a dot product of
    n = 64 terms in any order (n · 2^-24 · the sum of |products|, with
    66 for n as a margin). Tables whose rows lie within a few units of
    the last place of each other (Θ's untrained refresh pulls them
    together) leave many candidates inside the bound: their ranks are
    rounding, and the line says how many rows and how far apart the rows
    are."""
    from sml_tpu_torch.eval.evaluator import _make_ranker
    r = torch.from_numpy(rows).cuda()
    prep, rank = _make_ranker("gather")
    card = rank(prep(mf), r, None, slice(0, rows.shape[0])).long().cpu()
    u = mf.user_emb[r[:, 0]].double().cpu()
    v = mf.item_emb[r[:, 1:]].double().cpu()
    score = torch.einsum("bd,bcd->bc", u, v)
    size = torch.einsum("bd,bcd->bc", u.abs(), v.abs())
    bound = 2 * 66 * 2.0 ** -24 * torch.maximum(size[:, 1:], size[:, :1])
    gap = score[:, 1:] - score[:, :1]
    lo, hi = (gap > bound).sum(1), (gap >= -bound).sum(1)
    item = mf.item_emb
    return {"rows": rows.shape[0],
            "rows_outside_bounds": int(((card < lo) | (card > hi)).sum()),
            "rows_with_ties_in_bound": int((hi > lo).sum()),
            "card_hits@20": int((card < 20).sum()),
            "f64_hits@20": int(((gap > 0).sum(1) < 20).sum()),
            "item_spread": (item.std(0).mean() / item.abs().mean()).item()}


def scale_cap(torch) -> tuple:
    """K2 at the engine's mask cap: the masked evaluation of ``CAP_ROWS``
    rows through an engine at ``CAP_USERS`` x ``CAP_ITEMS`` (its launches
    counted), its hits and its ranks against the gather path's on the same
    integer-valued tables."""
    from sml_tpu_torch.config import SMLConfig, TransferConfig
    from sml_tpu_torch.eval.evaluator import _make_ranker
    from sml_tpu_torch.models.mf import MFParams
    from sml_tpu_torch.ops import adam_kernel as ak
    from sml_tpu_torch.ops import eval_kernel as ek
    from sml_tpu_torch.ops import transfer_kernel as tk
    from sml_tpu_torch.train.engine import SMLEngine

    cfg = SMLConfig(latent_dim=DIM, transfer=TransferConfig(latent_dim=DIM),
                    eval_scoring="masked")
    check(CAP_ITEMS == cfg.eval_mask_max_items, "the cap moved")
    eng = SMLEngine(cfg, CAP_USERS, CAP_ITEMS, device="cuda")
    st = eng.init_state()
    mf = MFParams(torch.round(st.mf.user_emb * 2),
                  torch.round(st.mf.item_emb * 2), st.mf.user_bias,
                  st.mf.item_bias)
    del st
    rows = distinct_eval_rows(torch, CAP_ROWS, CAP_USERS, CAP_ITEMS,
                              SEED + 63)
    padded = eng.make_eval_set(rows, build_mask=True)
    check(padded.cand_mask is not None, "no mask at the cap")
    torch.cuda.synchronize()
    zero_counts(ak, tk, ek)
    t0 = time.perf_counter()
    masked = eng.evaluate(mf, padded)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = kernel_counts(ak, tk, ek)
    check(launches["masked_rank_gather_kernel"] == CAP_ROWS // EVAL_BATCH
          and launches["decay_adam_kernel"] == 0
          and launches["transfer_rows_kernel"] == 0,
          f"cap launches {launches}")
    gather = SMLEngine(cfg.replace(eval_scoring="gather"), CAP_USERS,
                       CAP_ITEMS, device="cuda").evaluate(mf, rows)
    hits = {k: (round(masked[k]["recall"] * CAP_ROWS),
                round(gather[k]["recall"] * CAP_ROWS)) for k in masked}
    check(all(a == b for a, b in hits.values()),
          f"masked hits {hits} differ from the gather path's at the cap")
    ranks = {}
    for mode in ("masked", "gather"):
        prep, rank = _make_ranker(mode)
        ctx = prep(mf)
        ranks[mode] = torch.cat([
            rank(ctx, padded.rows[s:s + EVAL_BATCH],
                 padded.cand_mask[s:s + EVAL_BATCH] if mode == "masked"
                 else None, slice(s, s + EVAL_BATCH))
            for s in range(0, CAP_ROWS, EVAL_BATCH)])
    check(torch.equal(ranks["masked"].long(), ranks["gather"].long()),
          f"K2 ranks differ from the gather path's at the cap in "
          f"{int((ranks['masked'].long() != ranks['gather'].long()).sum())}"
          f" rows")
    out = {"users": CAP_USERS, "items": CAP_ITEMS, "rows": CAP_ROWS,
           "eval_s": eval_s, "launches": launches,
           "hits_masked_gather": hits, "ranks_equal": True}
    del eng, mf, padded
    torch.cuda.empty_cache()
    return out, launches


def scale_edge(torch) -> dict:
    """K3 on one f32 table and K1 on as many bf16 rows past 2^31 elements,
    each against its plain version on windows of rows at the start, on
    both sides of element 2^31 and at the end; seconds per call, peak."""
    from sml_tpu_torch.config import TransferConfig, yelp_sml
    from sml_tpu_torch.models.transfer import init_transfer
    from sml_tpu_torch.ops import adam_kernel as ak
    from sml_tpu_torch.ops import transfer_kernel as tk
    from sml_tpu_torch.train.optim import (ADAM_B1, ADAM_B2, ADAM_EPS,
                                           BiasTable, bias_corrections)

    n, w = EDGE_TABLE_ROWS, EDGE_WINDOW
    elems = n * DIM
    check(elems > 2 ** 31, "the edge table does not pass 2^31 elements")
    mid = 2 ** 31 // DIM
    wins = [slice(0, w), slice(mid - w, mid + w), slice(n - w, n)]
    g = torch.Generator(device="cuda").manual_seed(SEED + 64)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = {"rows": n, "elements": elems}

    p = torch.randn(n, DIM, generator=g, device="cuda")
    mu = torch.randn(n, DIM, generator=g, device="cuda") * 0.1
    nu = torch.rand(n, DIM, generator=g, device="cuda") * 0.01
    saved = [(p[s].clone(), mu[s].clone(), nu[s].clone()) for s in wins]
    bc1, bc2 = bias_corrections(K3_STEP)
    table = BiasTable(1, "cuda")
    table.fill(K3_STEP - 1)
    bc_dev = table.at(K3_STEP, ADAM_B1, ADAM_B2)
    kw = dict(lr=yelp_sml().mf_lr, b1=ADAM_B1, b2=ADAM_B2, eps=ADAM_EPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ak.fused_decay_adam(p, mu, nu, *bc_dev, **kw)
    torch.cuda.synchronize()
    out["k3_first_call_s"] = time.perf_counter() - t0
    err, p_not_equal = 0.0, 0
    for (ps, ms, ns), s in zip(saved, wins):
        ak.decay_adam_plain(ps, ms, ns, bc1, bc2, **kw)
        check(torch.equal(mu[s], ms) and torch.equal(nu[s], ns),
              f"K3 mu/nu past 2^31 differ from the plain version at {s}")
        check(torch.allclose(p[s], ps, rtol=K3_RTOL, atol=0.0),
              f"K3 p past 2^31 outside rtol {K3_RTOL} at {s}")
        p_not_equal += int((p[s] != ps).sum())
        err = max(err, (p[s] - ps).abs().max().item())
    out["k3_max_abs_err"], out["k3_p_not_bit_equal"] = err, p_not_equal
    out["k3_ms"] = cuda_ms(
        lambda: ak.fused_decay_adam(p, mu, nu, *bc_dev, **kw), 3)
    out["k3_bound_ms"], _ = bound_ms(8 * elems, 24 * elems)
    del p, mu, nu, saved
    torch.cuda.empty_cache()

    tower = init_transfer(torch.Generator().manual_seed(SEED + 65),
                          TransferConfig(latent_dim=DIM),
                          device="cuda").user
    last = torch.randn(n, DIM, generator=g, device="cuda",
                       dtype=torch.bfloat16)
    hat = torch.randn(n, DIM, generator=g, device="cuda",
                      dtype=torch.bfloat16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = tk.transfer_rows_cuda(tower, last, hat)
    torch.cuda.synchronize()
    out["k1_first_call_s"] = time.perf_counter() - t0
    err = 0.0
    for s in wins:
        want = tk.transfer_rows_plain(tower, last[s], hat[s])
        check(bool(torch.isfinite(got[s]).all()), f"K1 not finite at {s}")
        err = max(err, (got[s] - want).abs().max().item())
    check(err <= K1_TOL, f"K1 past 2^31 elements off its plain version by "
                         f"{err}")
    out["k1_max_abs_err"] = err
    out["k1_ms"] = cuda_ms(
        lambda: tk.transfer_rows_cuda(tower, last, hat, out=got), 3)
    out["k1_bound_ms"], _ = bound_ms(k1_flops(n, DIM),
                                     n * DIM * (2 + 2 + 4))
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del last, hat, got
    torch.cuda.empty_cache()
    return out


def scale_serve_5m(torch) -> dict:
    """Top-``SCALE_K`` over ``SERVE5M_ITEMS`` items on the card, one batch
    of ``SCALE_SERVE`` users, f32 and bf16 inputs (``dense_full_topk``, as
    ``rank`` serves): ms a batch, the peak over the resident tables, and
    ``SCALE_CHECK`` users' ids against a CPU top-K (rounded the same way
    for bf16) but at ties."""
    from sml_tpu_torch.eval.full_ranking import dense_full_topk
    from sml_tpu_torch.scripts.scale_serve import untied_rows

    g = torch.Generator(device="cuda").manual_seed(SEED + 67)
    items = torch.randn(SERVE5M_ITEMS, DIM, generator=g, device="cuda")
    users = torch.randn(SERVE5M_USERS, DIM, generator=g, device="cuda")
    ids = torch.randperm(SERVE5M_USERS, generator=g,
                         device="cuda")[:SCALE_SERVE]
    rows = users[ids]
    items_cpu = items.cpu().numpy()
    out = {"users": SERVE5M_USERS, "items": SERVE5M_ITEMS,
           "batch": SCALE_SERVE, "k": SCALE_K}
    for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _, got = dense_full_topk(rows, items, SCALE_K, compute_dtype=dtype)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        check_rows = untied_rows(rows[:SCALE_CHECK].cpu().numpy(), items_cpu,
                                 got[:SCALE_CHECK].cpu().numpy(), SCALE_K,
                                 PAR_TIE, bf16=dtype is not None)
        check(check_rows["rows_differ_untied"] == 0,
              f"5M-item top-{SCALE_K} ({name}) differs from the CPU's other "
              f"than at ties: {check_rows}")
        out[name] = {
            "ms": cuda_ms(lambda: dense_full_topk(rows, items, SCALE_K,
                                                  compute_dtype=dtype), 3),
            "peak_gib": peak / 2 ** 30,
            "serve_gib": (peak - base) / 2 ** 30,
            "check": check_rows}
    del items, users, rows, items_cpu
    torch.cuda.empty_cache()
    return out


def phase_scale(torch) -> dict:
    from sml_tpu_torch.models.mf import MFParams, init_mf
    from sml_tpu_torch.ops import adam_kernel as ak
    from sml_tpu_torch.ops import eval_kernel as ek
    from sml_tpu_torch.ops import transfer_kernel as tk
    from sml_tpu_torch.scripts import scale_engine_run
    from sml_tpu_torch.scripts.scale_serve import untied_rows
    from sml_tpu_torch.train.engine import SMLEngine
    import numpy as np

    t_phase = time.perf_counter()
    args = scale_engine_run.build_parser().parse_args(SCALE_ARGS)
    torch.cuda.synchronize()
    zero_counts(ak, tk, ek)
    eng, state, res, info = scale_engine_run.run_scale(args, "cuda")
    torch.cuda.synchronize()
    launches = kernel_counts(ak, tk, ek)
    run_s = time.perf_counter() - t_phase
    steps = info["inner_steps"] * args.phases
    out = {"phase": "scale", "result": res, "run_s": run_s,
           "init_s": info["init_seconds"],
           "fast_table_adam": info["fast_table_adam"],
           "inner_steps": info["inner_steps"],
           "outer_steps": info["outer_steps"],
           "peak_gib": {k: v / 2 ** 30
                        for k, v in info["peak_bytes"].items()},
           "launches": dict(launches)}
    check(info["fast_table_adam"] is True,
          "the auto rule kept 6M rows on dense gradients")
    check(state.hat_user.dtype == torch.bfloat16,
          "the snapshots are not bf16")
    check(launches["decay_adam_kernel"] == steps,
          f"K3 launched {launches['decay_adam_kernel']} times for {steps} "
          f"inner steps")
    check(launches["transfer_rows_kernel"] == 2 * 2 * args.phases,
          f"K1 launched {launches['transfer_rows_kernel']} times, not 2 "
          f"per refresh")
    check(launches["masked_rank_gather_kernel"] == 0,
          "K2 launched on the gather path")
    check(all(math.isfinite(x) for part in info["losses"].values()
              for phase in part for x in phase), "a loss is not finite")

    out["refresh_max_abs_err"] = scale_refresh_error(torch, state)
    check(out["refresh_max_abs_err"] <= K1_TOL,
          f"the scale refresh is off K1's plain version by "
          f"{out['refresh_max_abs_err']}")

    rows = info["test_rows"][:SCALE_RECOUNT]
    out["recount"] = scale_recount(torch, state.mf, rows)
    check(out["recount"]["rows_outside_bounds"] == 0,
          f"card ranks outside the f64 recount's bounds: {out['recount']}")
    # the run's first tables (drawn again from the seed: N(0,1) rows, well
    # apart) through the same evaluation on the card and on the CPU: hits
    # equal
    first = init_mf(torch.Generator().manual_seed(eng.cfg.seed),
                    eng.n_users, eng.n_items, eng.cfg.latent_dim,
                    device="cpu", emb_scale=eng.cfg.emb_init_scale)
    card = eng.evaluate(MFParams(*(t.cuda() for t in first)), rows)
    host = SMLEngine(eng.cfg, eng.n_users, eng.n_items,
                     device="cpu").evaluate(first, rows)
    recount = {k: (round(card[k]["recall"] * SCALE_RECOUNT),
                   round(host[k]["recall"] * SCALE_RECOUNT)) for k in card}
    check(all(a == b for a, b in recount.values()),
          f"eval hits on the first tables (card, cpu) {recount} differ")
    out["first_tables_hits_card_cpu"] = recount
    del first
    mf_cpu = MFParams(*(t.cpu() for t in state.mf))

    users = torch.from_numpy(np.random.default_rng(SEED + 66).choice(
        eng.n_users, SCALE_SERVE, replace=False)).cuda()
    torch.cuda.reset_peak_memory_stats()
    eng.serve_topk(state.mf, users, SCALE_K)
    torch.cuda.synchronize()
    out["serve_ms"] = cuda_ms(lambda: eng.serve_topk(state.mf, users,
                                                     SCALE_K), 5)
    out["serve_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    _, ids = eng.serve_topk(state.mf, users, SCALE_K)
    out["serve_check"] = untied_rows(
        mf_cpu.user_emb[users[:SCALE_CHECK].cpu()].numpy(),
        mf_cpu.item_emb.numpy(), ids[:SCALE_CHECK].cpu().numpy(), SCALE_K,
        PAR_TIE)
    check(out["serve_check"]["rows_differ_untied"] == 0,
          f"served top-{SCALE_K} differs from the CPU's other than at ties: "
          f"{out['serve_check']}")
    del mf_cpu

    rng = np.random.default_rng(SEED + 62)
    out["crossover"] = crossover(
        torch, eng.cfg, eng.n_users, eng.n_items,
        np.stack([rng.integers(0, n, SCALE_CROSS_ROWS)
                  for n in (eng.n_users, eng.n_items, eng.n_items)], 1),
        state.mf)
    del eng, state
    torch.cuda.empty_cache()
    out["serve_5m"] = scale_serve_5m(torch)
    out["cap"], cap_launches = scale_cap(torch)
    out["edge"] = scale_edge(torch)
    out["sweep"], sweep_launches = scale_sweep_cut(torch)
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return {k: launches[k] + cap_launches[k] + sweep_launches[k]
            for k in launches}


def scale_sweep_cut(torch) -> tuple:
    """``SMLDriver`` at 5M x 1M, eager and then fused, through
    ``scripts/scale_sweep.py``'s functions (``SCALE_SWEEP_ARGS``); returns
    its report and both runs' launches."""
    from sml_tpu_torch.scripts import scale_sweep
    args = scale_sweep.build_parser().parse_args(SCALE_SWEEP_ARGS)
    card = torch.device("cuda")
    root = tempfile.mkdtemp(prefix="sml_scale_sweep_")
    try:
        spec, data_s = scale_sweep.write_data(args, root)
        runs = {run: scale_sweep.run_sweep(args, spec, card, None, run)
                for run in scale_sweep.RUNS}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    checks = scale_sweep.checks(runs, card)
    info = {run: runs[run]["info"] for run in scale_sweep.RUNS}
    out = {"args": SCALE_SWEEP_ARGS, "data_s": data_s, "checks": checks,
           **info}
    check(not checks["failed"],
          f"the fused sweep at 5M x 1M fails {checks['failed']}: {out}")
    check(all(want[k] > 0 for run in info
              for want in info[run]["derived_launches"]
              for k in ("decay_adam_kernel", "transfer_rows_kernel")),
          f"no K1 or K3 launch derived for the sweep at 5M x 1M: {info}")
    launches = {k: sum(info[run]["launches"][k] for run in info)
                for k in info["eager"]["launches"]}
    return out, launches


def protocol_launches(proto, cfg, test_rows, eval_batches,
                      masks: bool) -> dict:
    """K1 and K2 launches a protocol sweep must make, from its
    configuration: per trained period ``t`` two K1 launches per refresh
    (one after each phase's inner block and outer epoch, one at the
    period's end); with masks, one K2 launch per batch of every
    in-training eval of the val rows ``test/(t+1)`` and of the test of
    ``test/(t+1)`` once ``t + 1`` reaches the test span. K3 none: the
    protocols' tables stay on dense gradients by the auto rule."""
    k1 = k2 = 0
    evals = (cfg.mf_epochs * cfg.eval_during_inner
             + cfg.tr_epochs * cfg.eval_during_outer)
    for t in range(proto.train_start, proto.n_periods - 1):
        k1 += 2 * (cfg.multi_num * (1 + cfg.tr_epochs) + 1)
        if masks:
            batches = eval_batches(test_rows(t + 1))
            k2 += cfg.multi_num * evals * batches
            if t + 1 >= proto.test_start:
                k2 += batches
    return {"decay_adam_kernel": 0, "transfer_rows_kernel": k1,
            "masked_rank_gather_kernel": k2}


def protocol_pair(torch, run_phase, args, proto, key: str, root: str,
                  want: dict) -> dict:
    """One protocol sweep fused (``--fuse-period on``) and on the eager
    path (``off``), each with its records (``--log``) and its launches
    counted: records and ``results.json`` entries equal but for clocks
    (``protocol_runs.compare_pair``) and final state bit-equal, three
    programs (the phase program and phase 0's epoch programs) and a
    capture each for the fused run and none for the eager one, launches
    equal to ``want`` in both."""
    from sml_tpu_torch.ops import adam_kernel as ak
    from sml_tpu_torch.ops import eval_kernel as ek
    from sml_tpu_torch.ops import transfer_kernel as tk
    from sml_tpu_torch.scripts.protocol_runs import compare_pair

    runs, out = {}, {}
    for fuse in ("on", "off"):
        args.fuse_period, args.key = fuse, f"{key}_{fuse}"
        args.log = os.path.join(root, f"{key}_{fuse}.jsonl")
        torch.cuda.synchronize()
        zero_counts(ak, tk, ek)
        runs[fuse] = run_phase(args, proto)
        torch.cuda.synchronize()
        out[fuse] = {"seconds": runs[fuse].seconds,
                     "peak_gib": runs[fuse].line["peak_gib"],
                     "graphs": runs[fuse].line["graph_stats"],
                     "launches": kernel_counts(ak, tk, ek)}
        check(out[fuse]["launches"] == want,
              f"{key} fuse={fuse} launches {out[fuse]['launches']}, the "
              f"configuration's {want}")
    args.key = args.log = None
    with open(os.path.join(root, "results.json")) as fh:
        results = json.load(fh)
    out["pair"] = compare_pair(root, results, f"{key}_on", f"{key}_off")
    errors = state_errors(torch, runs["on"].state, runs["off"].state)
    graphs = out["on"]["graphs"]
    out.update(state_errors=errors, summary=results[f"{key}_on"]["summary"],
               per_period_recall20=results[f"{key}_on"][
                   "per_period_recall@20"])
    check(out["pair"]["records_equal"] and out["pair"]["results_equal"],
          f"{key}: the fused and eager records differ: {out['pair']}")
    check(all(errors[k] == 0.0 for k in ("tables", "snapshots", "theta",
                                          "moments"))
          and errors["counts_equal"] and errors["generator_equal"],
          f"{key}: the fused and eager final states differ: {errors}")
    check(graphs["programs"] == graphs["captures"] == 3
          and out["off"]["graphs"]["programs"] == 0,
          f"{key}: the fused run made {graphs} (three programs, a capture "
          f"each), the eager one {out['off']['graphs']} (none)")
    metrics = {k: v for k, v in out["summary"].items()
               if k != "total_seconds"}
    check(bool(metrics) and all(0.0 <= v <= 1.0 for v in metrics.values()),
          f"{key}: summary metrics out of [0, 1]: {out['summary']}")
    return out


def phase_protocols(torch) -> dict:
    """The protocol scripts' phase functions at full width and a cut depth
    (``PROTO_*_CUT``): gen, pretrain, the sweep fused and unfused, and the
    baselines (Adressa: all three for ``PROTO_BASE_PERIODS`` test period;
    Yelp-scale: fine). Returns the sweeps' launches."""
    from sml_tpu_torch.data.formats import row_count
    from sml_tpu_torch.ops.batching import bucket_rows
    from sml_tpu_torch.scripts import adressa_run, yelp_scale_sweep

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="sml_protocols_")
    out = {"phase": "protocols"}
    launches = {}
    try:
        for name, mod, cut, phase, base_args in (
                ("adressa", adressa_run, PROTO_ADRESSA_CUT,
                 adressa_run.phase_sml, []),
                ("yelp", yelp_scale_sweep, PROTO_YELP_CUT,
                 yelp_scale_sweep.phase_ours, ["--evals"])):
            proto = mod.PROTOCOL._replace(**cut)
            sub = os.path.join(root, name)
            args = mod.build_parser().parse_args(
                ["--phase", "gen", "--root", sub] + base_args)
            part = {"protocol": proto._asdict()}
            t0 = time.perf_counter()
            part["dataset"] = mod.phase_gen(args, proto)
            part["gen_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            part["pretrain"] = mod.phase_pretrain(args, proto)
            part["pretrain_s"] = time.perf_counter() - t0
            cfg = (adressa_run.sml_config(args, proto) if name == "adressa"
                   else yelp_scale_sweep.ours_config(args, proto))
            spec_path = os.path.join(sub, proto.name)
            bound = max(row_count(spec_path, "test", p)
                        for p in range(proto.train_start, proto.n_periods))
            want = protocol_launches(
                proto, cfg, lambda p: row_count(spec_path, "test", p),
                lambda n: max(bucket_rows(n, cfg.eval_batch_size),
                              bucket_rows(bound, cfg.eval_batch_size))
                // cfg.eval_batch_size,
                masks=cfg.eval_during_inner or cfg.eval_during_outer)
            part["derived_launches"] = want
            part["sweep"] = protocol_pair(torch, phase, args, proto, name,
                                          sub, want)
            for fuse in ("on", "off"):
                for k, v in part["sweep"][fuse]["launches"].items():
                    launches[k] = launches.get(k, 0) + v
            t0 = time.perf_counter()
            if name == "adressa":
                base = adressa_run.phase_baselines(
                    args, proto, max_periods=PROTO_BASE_PERIODS)
                drivers = base.pop("drivers")
                check(all(d.cfg.pool_init_type == 1 and d._early_stop
                          for d in drivers.values()),
                      "the Adressa baselines run without the early stop")
                part["baselines"] = base
            else:
                driver = yelp_scale_sweep.phase_baseline(args, proto)
                part["baselines"] = {"fine": {
                    "recall@20": driver.recall, "graphs": driver.graph_stats}}
            part["baselines_s"] = time.perf_counter() - t0
            out[name] = part
            shutil.rmtree(sub, ignore_errors=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return launches


def write_parallel_data(torch, path: str) -> None:
    """The parallel phase's inputs, one ``.npz`` that every rank reads:
    the train-lockstep phase's replay rows and pretrained tables, a
    16,384-row test with 999 distinct negatives, 4 x 1024 served users."""
    import numpy as np
    pre = random_tables(torch, SEED + 61)
    g = torch.Generator().manual_seed(SEED + 71)
    np.savez(path, inner_rows=seeded_rows(INNER_ROWS, SEED + 62),
             outer_rows=seeded_rows(OUTER_ROWS, SEED + 63),
             test_rows=distinct_eval_rows(torch, EVAL_ROWS, N_USERS,
                                          N_ITEMS, SEED + 72),
             serve_users=torch.randint(0, N_USERS,
                                       (SERVE_BATCHES * EVAL_BATCH,),
                                       generator=g).numpy(),
             **{f: t.numpy() for f, t in zip(pre._fields, pre)})


def served_agreement(torch, ref: dict, got: dict) -> dict:
    """A world's served top-K against R=1's: rows whose id sets differ
    where R=1's scores do not tie (every differing id scored within
    ``PAR_TIE`` of R=1's k-th score under R=1's tables), and the served
    scores against a dense top-K over the world's own whole tables."""
    from sml_tpu_torch.eval.full_ranking import dense_full_topk
    users = torch.from_numpy(ref["serve_users"]).cuda()
    ref_u = torch.from_numpy(ref["user_emb"]).cuda()[users]
    ref_i = torch.from_numpy(ref["item_emb"]).cuda()
    s_ref, i_ref = (torch.from_numpy(x) for x in ref["served"]["exact"])
    s_got, i_got = (torch.from_numpy(x) for x in got["served"]["exact"])
    untied, differ = 0, 0
    for b in range(i_ref.shape[0]):
        a, c = set(i_ref[b].tolist()), set(i_got[b].tolist())
        if a == c:
            continue
        differ += 1
        ids = torch.tensor(sorted(a ^ c), device="cuda")
        scores = (ref_u[b:b + 1] @ ref_i[ids].T).cpu()
        if (scores - s_ref[b, -1]).abs().max().item() > PAR_TIE:
            untied += 1
    dense_s, _ = dense_full_topk(
        torch.from_numpy(got["user_emb"]).cuda()[users],
        torch.from_numpy(got["item_emb"]).cuda(), s_got.shape[1])
    score_err = (dense_s.cpu().sort(1).values
                 - s_got.sort(1).values).abs().max().item()
    return {"rows_differ": differ, "rows_differ_untied": untied,
            "score_err_vs_dense": score_err}


def phase_parallel_cli(root: str) -> dict:
    """The multi-process CLI on the card: ``sml`` and ``rank --shard`` as
    two processes sharing it, against one process
    (``scripts.multicard_check.cli_against_one_process``)."""
    from sml_tpu_torch.scripts.multicard_check import cli_against_one_process
    os.makedirs(root)
    report, failed = cli_against_one_process(root, 2, "cuda", PAR_CLI_DATA,
                                             PAR_TIMEOUT_S)
    check(not failed, f"the two-process CLI differs from one process in "
          f"{failed}: {report}")
    return report


def par_worlds(cards: int) -> list:
    """The parallel phase's worlds on a machine of ``cards`` cards: ``(name,
    ranks, mesh, hosts, spec fields, the world it is held to)``. One card:
    ``PAR_WORLDS``, each held to R1. Two or more: R2_hosts one card a
    host (2 ranks, or 4 with four cards), over NCCL, fused, against
    R1_fused_ref."""
    worlds = [(name, n, mesh, hosts, {}, None if n == 1 else "R1")
              for name, n, mesh, hosts in PAR_WORLDS]
    if cards >= 2:
        fused = dict(phases=PAR_FUSED_PHASES, fused=True)
        worlds[-1] = ("R2_hosts", 4 if cards >= 4 else 2, "global", 2,
                      fused, "R1_fused_ref")
        worlds.append(("R1_fused_ref", 1, None, 1,
                       dict(phases=PAR_FUSED_PHASES), None))
    return worlds


def phase_parallel(torch) -> dict:
    """Four worlds of one replay phase, a test and serving at the Yelp
    shape (R=1; two ranks sharing the card on a (1, 2) mesh, row-sharded;
    two on (2, 1), data parallel; two simulated hosts, :func:`par_worlds`),
    each held to its reference with its launches per rank counted; then
    the multi-process CLI."""
    import dataclasses

    from sml_tpu_torch.config import yelp_sml
    from sml_tpu_torch.parallel.dryrun import StepSpec, run_world
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="sml_parallel_")
    try:
        data = os.path.join(root, "data.npz")
        write_parallel_data(torch, data)
        cfg = yelp_sml().replace(replay_mode=True, fast_table_adam=True,
                                 eval_scoring="masked")
        base = StepSpec(cfg, N_USERS, N_ITEMS, data, serve_k=SERVE_K)
        worlds, out = {}, {"phase": "parallel", "users": N_USERS,
                           "items": N_ITEMS, "eval_rows": EVAL_ROWS,
                           "cards": torch.cuda.device_count(),
                           "worlds": {}}
        plan = par_worlds(torch.cuda.device_count())
        for name, n, mesh, hosts, kw, _ in plan:
            t0 = time.perf_counter()
            worlds[name] = run_world(
                "sml_tpu_torch.parallel.dryrun:full_step", n, "cuda",
                (dataclasses.replace(base, mesh=mesh, **kw),), PAR_TIMEOUT_S,
                hosts)
            spawn_s = time.perf_counter() - t0
            d = hosts if mesh == "global" else 1 if mesh is None else mesh[0]
            phases = kw.get("phases", 1)
            want = {"transfer_rows_kernel": 4 * phases,
                    "decay_adam_kernel": phases * -(-INNER_ROWS
                                                    // cfg.mf_batch_size),
                    "masked_rank_gather_kernel": EVAL_ROWS // EVAL_BATCH // d}
            for r, res in enumerate(worlds[name]):
                check(res["launches"] == want,
                      f"{name} rank {r} launched {res['launches']}, "
                      f"expected {want}")
                if kw.get("fused"):
                    check(res["graphs"]["captures"] == 1,
                          f"{name} rank {r}: graphs {res['graphs']}, "
                          "expected one capture")
            out["worlds"][name] = {
                "ranks": n, "mesh": mesh, "hosts": hosts,
                "phases": phases, "fused": bool(kw.get("fused")),
                "spawn_wall_s": spawn_s,
                "step_wall_s": [r["wall_s"] for r in worlds[name]],
                "transport": worlds[name][0]["transport"],
                "host_by_rank": [r["host"] for r in worlds[name]],
                "graphs": worlds[name][0]["graphs"],
                "launches_per_rank": want}
        for name, _, mesh, _, _, held_to in plan:
            if held_to is None:
                continue
            ref, got = worlds[held_to][0], worlds[name][0]
            errs = {"user": float(abs(got["user_emb"] - ref["user_emb"])
                                  .max()),
                    "item": float(abs(got["item_emb"] - ref["item_emb"])
                                  .max()),
                    "theta": max(float(abs(got["theta"][k] - v).max())
                                 for k, v in ref["theta"].items())}
            loss_err = max(
                float((abs(got[k] - ref[k]) / abs(ref[k]).clip(1e-30)).max())
                for k in ("inner_losses", "outer_losses"))
            hits = {k: abs(got["eval"][k][0] - ref["eval"][k][0])
                    for k in ref["eval"]}
            serve = served_agreement(torch, ref, got)
            check(max(errs.values()) <= TRAIN_ATOL,
                  f"{name}: tables/Θ differ from {held_to} by {errs}")
            check(loss_err <= LOSS_RTOL,
                  f"{name}: losses differ from {held_to} by rtol {loss_err}")
            check(max(hits.values()) <= SLICE_HIT_TOL,
                  f"{name}: hit counts differ from {held_to}: {hits}")
            check(serve["rows_differ_untied"] == 0,
                  f"{name}: served ids differ where {held_to} does not tie: "
                  f"{serve}")
            check(serve["score_err_vs_dense"] <= PAR_SCORE_ATOL,
                  f"{name}: served scores differ from dense serving: "
                  f"{serve}")
            out["worlds"][name].update(
                held_to=held_to, max_abs_err_vs_ref=errs,
                loss_max_rel_err_vs_ref=loss_err,
                hit_diff_vs_ref={str(k): v for k, v in hits.items()},
                **serve)
        out["worlds"]["R1"]["eval_hits"] = {
            str(k): v[0] for k, v in worlds["R1"][0]["eval"].items()}
        # the transport: every collective the port calls, on CUDA tensors
        # of two ranks sharing the card (each two-rank world checks them
        # before its step), handed to the group's backend as they are (the
        # port copies nothing to the host; ProcessGroupGloo stages CUDA
        # tensors through pinned host buffers inside itself)
        from sml_tpu_torch.parallel.collective import GLOO_CUDA_COLLECTIVES
        checked = [r["collectives"] for name, n, *_ in plan if n > 1
                   for r in worlds[name]]
        for res in checked:
            check(res["on_device"] and res["device"].startswith("cuda")
                  and max(res["errors"].values()) == 0.0
                  and set(res["errors"]) == GLOO_CUDA_COLLECTIVES,
                  f"collectives on CUDA tensors: {res}")
        out["transport_rule"] = {
            "backend": checked[0]["transport"], "ranks_checked": len(checked),
            "collectives_checked_on_cuda_tensors": sorted(
                checked[0]["errors"]),
            "gloo_cuda": "staged through pinned host memory inside "
                         "ProcessGroupGloo; the port stages nothing itself"}
        # the fused programs on ranks sharing the card: gloo cannot be
        # captured, so "auto" stays unfused and fuse_period=True raises,
        # naming the reason and the ways out; a world whose ranks hold a
        # card each (NCCL) and one rank alone fuse
        for name, n, *_ in plan:
            for r in worlds[name]:
                rule = r["fusion"]
                if n > 1 and "nccl" not in r["transport"].values():
                    check(rule["auto"] is False
                          and isinstance(rule["True"], str)
                          and "gloo" in rule["True"]
                          and "fuse_period=False" in rule["True"],
                          f"{name}: the fusion rule over gloo on the card: "
                          f"{rule}")
                else:
                    check(rule["auto"] is True and rule["True"] is True,
                          f"{name}: 'auto' does not fuse: {rule}")
        out["fusion_rule"] = {name: worlds[name][0]["fusion"]
                              for name, *_ in plan}
        t0 = time.perf_counter()
        out["cli"] = phase_parallel_cli(os.path.join(root, "cli"))
        out["cli"]["wall_s"] = time.perf_counter() - t0
        out["phase_s"] = time.perf_counter() - t_phase
        emit(out)
        # launches on the card in this phase, every rank of every world
        return {k: sum(r["launches"][k] for w in worlds.values() for r in w)
                for k in worlds["R1"][0]["launches"]}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main() -> int:
    import faulthandler

    import torch
    # a fault inside a native library prints every thread's Python stack
    faulthandler.enable(all_threads=True)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi_line = phase_env(torch)
    phase_build()
    phase_sanitize()
    k1 = phase_k1(torch)
    k2, k2_l2_rate = phase_k2(torch)
    phase_slice(torch)
    k3 = phase_k3(torch)
    phase_crossover(torch)
    phase_train_lockstep(torch)
    # the sweep dataset stays until the traced fused period, the last phase
    sweep_root = tempfile.mkdtemp(prefix="sml_sweep_")
    try:
        t0 = time.perf_counter()
        write_sweep_dataset(torch, sweep_root)
        launches, ref = phase_train_sweep(torch, sweep_root,
                                          time.perf_counter() - t0)
        fused_launches, fused_period1_s, fused_call1 = phase_fused_sweep(
            torch, sweep_root, ref)
        del ref
        for k, v in fused_launches.items():
            launches[k] += v
        for k, v in phase_fused_evals(torch, sweep_root).items():
            launches[k] += v
        for k, v in phase_mesh_fused(torch, sweep_root).items():
            launches[k] += v
        p1 = phase_p1(torch)
        probe_rows = probe_eval_rows(torch)
        p3, p3_l2_rate = phase_p3(torch, probe_rows)
        p2 = phase_p2(torch, probe_rows, (k2_l2_rate, p3_l2_rate))
        del probe_rows
        probe_launches = phase_eval_probes(torch)
        root = tempfile.mkdtemp(prefix="sml_pretrain_")
        try:
            t0 = time.perf_counter()
            spec = write_pretrain_dataset(root)
            pretrained = phase_pretrain(torch, spec, time.perf_counter() - t0)
            phase_baselines(torch, spec, pretrained)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        phase_transfer_kinds(torch)
        phase_ingest_sweep(torch)
        for k, v in phase_scale(torch).items():
            launches[k] += v
        for k, v in phase_protocols(torch).items():
            launches[k] += v
        par_launches = phase_parallel(torch)
        for k, v in par_launches.items():
            launches[k] += v
        phase_fused_trace(torch, sweep_root, fused_period1_s, fused_call1)
    finally:
        shutil.rmtree(sweep_root, ignore_errors=True)

    kernels = [
        {"name": "transfer_rows_kernel", "route": "cuda",
         "source": "sml_tpu_torch/csrc/transfer_kernel.cu",
         "replaces": "sml_tpu/ops/transfer_kernel.py:87",
         "launches": launches["transfer_rows_kernel"], **k1},
        {"name": "masked_rank_gather_kernel", "route": "cuda",
         "source": "sml_tpu_torch/csrc/masked_rank_gather.cu",
         "replaces": "sml_tpu/ops/eval_kernel.py:159",
         "launches": launches["masked_rank_gather_kernel"], **k2},
        {"name": "decay_adam_kernel", "route": "cuda",
         "source": "sml_tpu_torch/csrc/adam_kernel.cu",
         "replaces": "sml_tpu/ops/adam_kernel.py:71",
         "launches": launches["decay_adam_kernel"], **k3},
        {"name": "masked_rank_kernel", "route": "cuda",
         "source": "sml_tpu_torch/csrc/eval_kernel.cu",
         "replaces": "scripts/eval_kernel_probe.py:74", **p1},
        {"name": "candidate_scores_kernel", "route": "cuda",
         "source": "sml_tpu_torch/csrc/candidate_scores.cu",
         "replaces": "scripts/eval_variants.py:155",
         "launches": probe_launches["candidate_scores_kernel"], **p2},
        {"name": "dense_mask_rank_kernel", "route": "cuda",
         "source": "sml_tpu_torch/csrc/dense_mask_rank.cu",
         "replaces": "scripts/eval_variants.py:284",
         "launches": probe_launches["dense_mask_rank_kernel"], **p3},
    ]
    print(smi_line, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
