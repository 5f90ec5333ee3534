"""Drive the PyTorch/CUDA port's serving, training, checkpoint-interop and
feature-extraction paths on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

1. Requires a CUDA card (exits non-zero without one) and prints its name
   and power limit as nvidia-smi reports them.  TF32 is turned off for
   matmuls and cuDNN convolutions: every comparison below is in f32.
2. Builds the port's kernels from ``transformer_clip_eeg_tpu_torch/csrc``.
3. Holds each kernel against its plain PyTorch twin on the card at the
   flagship's shapes (seeded inputs): the block forward in eval and in
   training mode (same seed, so the same dropout masks), the LSTM forward,
   and the two backward kernels against autograd through the twins.  Times
   kernel, plain twin and the nearest single PyTorch call with CUDA events
   (median of 20 runs).  For the block's forward (#1) also what it saves for
   the backward (q, k, v, the dropped-out context, x1, the log-sum-exp)
   against the twin's intermediates, its three kernels timed apart under
   ``torch.profiler`` in eval and in training, exactly 3 device launches a
   call, a bit-for-bit repeat of out and ``saved``, what ``ptxas -v``
   reported (no spills), and that it is under the library layer; then #1 and
   #2 at T=256 and T=320 (batch 128) against the twins, timed, and #1 at
   batch 8.  For the block's backward (#2) also its parts timed
   apart under ``torch.profiler`` (row kernels, attention, the weight
   gradients' products with their TFLOP/s, sums), the device launches per
   call, a bit-for-bit repeat and what ``ptxas -v`` reported.  For the LSTM
   kernels (up to H=256 one thread-block cluster per recurrence) also the launch plan,
   microseconds per step, what ``ptxas -v`` reported (registers, spills),
   the backward's recurrence and its dwhh reduction timed apart; beside the
   flagship's two biLSTMs (D=2, H=128 and H=4) the zoo's unidirectional
   recurrence (D=1, H=128, B=128), also against a unidirectional
   ``nn.LSTM``; then H=256 (clusters of 8 CTAs, its slice in shared memory and
   its product on the tensor cores; D=2 and D=1: also the clusters the card
   holds at once beside the plan's, a bit-for-bit repeat of both kernels,
   and a spill fails the run), the widths
   that run zero-padded, H=100 (to 128) and H=2 (to 4), and past 256 the
   wide kernels (one persistent cooperative grid): H=512 (D=2 and D=1),
   H=300 (padded to 320) and H=1024, each against the twin, timed, with its
   bound, ``nn.LSTM``'s time, the plan, registers and spills.
4. Builds the flagship model (``TrainConfig()``: EEGConformerInterleaved
   depth 10, convLSTM, clip_sim_no_latent_proj) with seeded weights, serves
   it over HTTP on localhost, answers a request on every route, checks the
   answers, and checks that the serving path launched the kernels: 10 fused
   blocks per EEG chunk and 2 LSTM recurrences per speech chunk.  8 windows
   are compared with a CPU session holding the same weights.
   Then times one full 128-window chunk through each embedder (host clock)
   and profiles it (``torch.profiler``): device time per chunk, the device's
   idle share and the operations that take the most device time.
5. Runs the reference's default command line on the flagship at full width
   through the port's CLI (``cli.main`` with ``--data_dir``, ``--epochs 2``
   and ``--results_folder`` only): a synthetic SparrKULee fixture with
   1024-dim wav2vec-19 features and its ``icassp/`` challenge tree, batch
   128, every other flag at its default.  Checks that ``--data_mode auto``
   took the device-resident chunk store, ``loss.txt`` in the device-mode
   format (epoch 0 uploads every train chunk once, epoch 1 none), the
   checkpoint, the memory bank, the exact kernel launches of training (10
   block forwards, 10 block backwards, 2 LSTM forwards and 2 LSTM backwards
   per train step; 10 and 2 forwards per validation step) and of the
   evaluation suite apart (10 block forwards per EEG-encoder call, 2 LSTM
   forwards per speech-encoder call, nothing else), that
   ``release_host_data`` gives back at least the bytes the stores held, and
   the eight evaluation JSONs (present, finite, no ``error_regression.txt``).
   Then the same training with ``--data_mode host --skip_eval yes``, and
   both modes once more on cuDNN's deterministic algorithms (their losses
   held to each other), ``--only_evaluate yes`` on the first
   run (the match-mismatch JSONs rewritten with the same values), one step
   at batch 8 with dropout on, card against CPU; the trained run served from
   its results directory against the trainer's model; the median step time
   of epoch 2 in each mode, the gather of one batch timed, and a
   ``torch.profiler`` pass over 3 device-mode steps (a ``{"train": ...}``
   line).
6. The model zoo (``zoo_path``): six configurations Z1-Z6 that between them
   run every encoder and head of the JAX registry at full width (batch 128,
   T=192, depth 10, latent 8, ``--lstm_units 128``).  For each, one train
   step at batch 8 with dropout on, card against CPU (losses, every
   gradient, the memory bank, the batch norms' running statistics); then
   ``cli.main`` on the same fixture on the card (device store, ``--epochs
   1 --skip_eval yes``; Z1 the whole default run, evaluation suite
   included) with the exact launches of kernels #1-#4, printed per train
   step, and the median step time; then the Z3 run (a head without a memory
   bank) served by ``from_results_dir``, one 128-window chunk against the
   CPU.  Prints the phase's seconds.
7. The conv kernels at the flagship's shapes (B=128, T=192, C=64): the
   fused BasicBlock forward (#5) against its plain twin in eval and in
   training (dropout 0.2, fixed seed) for K=64 (EEG) and K=32 (speech), its
   backward (#6) against autograd through the twin (all five gradients; its
   parts timed apart, launches per call, a bit-for-bit repeat and ``ptxas``
   as for #2), and the conv alone (#7) against ``F.conv1d``; each timed beside its plain twin
   and a yardstick (the port's unfused ``BasicBlock``, its backward, and
   ``F.conv1d``; cuDNN with TF32 off).
8. The fused path: the flagship with ``fused=True`` on its 11 square
   BasicBlocks (10 EEG blocks at K=64, the speech block at K=32).  8 windows
   on the card against the same model unfused on the card and against a CPU
   copy; one train step at batch 8 with dropout on, card against CPU; the
   exact launches (10 #5 per EEG chunk, 1 per speech chunk; 11 #5, 11 #6 and
   11 #7 per train step); the median step time at batch 128 on a batch
   already on the card, fused and unfused in turns, and a ``torch.profiler``
   pass over 3 fused steps.  The default serving and training paths above
   launch none of #5-#7.
9. The long window: the flagship built with ``window_length_s=4`` (T=256). 8
   windows through both embedders on the card against a CPU copy, one train
   step at batch 8 with dropout on, card against CPU, and the exact launches
   of each (10 block forwards and 2 LSTM recurrences per embedding; 10, 10,
   2 and 2 forwards and backwards per step).
10. The augmentations (``augment_phase``, after the serving path): the
    eight transforms of ``ops/augment.py``, the train step's batch mixup and
    the chunk mixup at the flagship batch [128, 192, 64], at p=1 and p=0.5,
    run on the card under ``torch.cuda.set_sync_debug_mode("error")`` (a
    host sync fails the phase); card against CPU on the same seeds (1e-5 of
    max |x|, SignFlip, ChannelsDropout and ChannelsShuffle exact, the masks
    equal), the augmented share within 5 sigma of p, device ms of each.
11. The augmented run (``augmented_train_path``, after the default run): one
    train step at batch 8 with each transform and mixup on, card against
    CPU; ``cli.main`` with ``--data_augmentation FTSurrogate --addEEG yes
    --epochs 2 --skip_eval yes --profile_dir``, once on the device store
    (timed: its epoch-2 median step beside the default run's) and once more
    in each data mode on cuDNN's deterministic algorithms (losses held to
    each other): exact launches of #1-#4 (10/10/2/2 a train step), the
    profiler's ``loss.txt`` line, and a trace that names #1-#4's kernels.
12. The serve CLI (``serve_cli_path``) on the default run's results
    directory: ``serve.main`` for 256 EEG windows, 128 speech windows and
    top-5 retrieval over 130 candidates, against an ``InferenceSession`` of
    the run on the card (1e-6) and on the CPU (8 windows, 1e-3), its wall
    time (the run loaded each call) and exact launches.
13. The server CLI (``server_cli_path``): the server's ``main`` in a
    subprocess on the card (``--port 0 --candidates``), its URL read from its
    output within 120 s, five rounds of /healthz, both embed routes, top-k
    and match_mismatch whose answers equal the serve CLI's, SIGINT and exit
    code 0; the time to the first /healthz, the median request times and
    the subprocess's exact launches.
14. The bf16 compute mode (``--compute_dtype bfloat16``): kernels #1 and #2
    in their bf16 instantiation (``check_block_bf16``) against their plain
    twins on bf16 input at [128, 192, 64], [128, 256, 64] and [8, 1699, 64],
    dropout on and off (out and dx within 8e-3 of max |twin|, the parameter
    gradients within 2.5e-3 of each one's largest), with cuBLAS's bf16 sums
    in f32 (``f32_sums``); the f32 instantiation on the same bf16-valued
    inputs must miss the gradients' limit (the control); timed by CUDA events beside their f32 instantiations,
    the twins and ``nn.TransformerEncoderLayer`` in bf16, forward and
    backward, with a bit-for-bit repeat, the launches per call and no spill
    in any instantiation.  The LSTM (H=128, D=2 and D=1) and the fused conv
    block (K=64) on bf16 input against the same modules on their twins
    (``check_lstm_conv_bf16``).  Then ``bf16_train_path``: the flagship's
    command line with ``--compute_dtype bfloat16`` (device store, 2 epochs,
    evaluation suite): exactly 10/10/2/2 launches of #1-#4 a train step with
    every #1 and #2 of training in bf16 and none in validation, the suite or
    ``--only_evaluate``; every loss finite; both data paths on cuDNN's
    deterministic algorithms within 1e-5; the epoch-2 median step beside the
    f32 run's and 3 bf16 steps profiled; one bf16 step at batch 8, card
    against CPU, for the flagship and its fused variant on 9 batches and
    for Z1-Z5 on one (each loss within 1e-2 on every batch, each gradient
    within 5e-2 of its largest value at the median over the batches, bank
    and running statistics within 1e-2 on every batch).
15. The LSTM widths of ``K1`` (``k1_path``): ``--lstm_units 256`` and
    ``--lstm_units 100`` (the double_lstm encoders, D=1) and the flagship at
    ``--latent_dim 4`` (H=2): one train step at batch 8, card against CPU
    (``STEP_TOL``), and one epoch of ``cli.main --skip_eval yes`` with the
    exact launches of #1-#4.  Then those of ``K2`` (``k2_path``), run by
    the wide kernels: ``--lstm_units 512`` and ``1024`` (double_lstm) and
    the flagship at ``--latent_dim 1024`` (its speech encoder's second
    biLSTM at H=512), the same way (``--lstm_units 1024`` against the CPU's
    step in float64), and the ``--lstm_units 512`` run served from its
    results directory, card against CPU.
16. The cross-validation driver (``cv_path``, ``cv.main`` at the
    flagship's widths on the same fixture, whose 6 stories put one story in
    each of folds 0-4): ``--parallel yes --folds 0 1 2 3 4 --epochs 2``
    with the evaluation suites (``cv_summary.json`` with 5 folds, every
    number finite; exact launches of training and of each suite; one upload
    per union chunk in epoch 0 and none in epoch 1, not one per fold; the
    epoch-2 aggregate pairs/s of ``loss.txt``) and fold 2 alone, timed;
    then, on cuDNN's deterministic algorithms and each in a process of its
    own, 2 epochs, folds 0-2, fold 2 alone and folds 0-2 with
    ``--fold_group_size 1``: fold 2's train and val CE of
    every epoch and its best weights, and every fold of the groups against
    the ungrouped run, bit for bit; ``--parallel no --folds 0 1 --epochs 1``
    (its summary, its launches); one fold-parallel chunk (3 rows x 5 folds)
    under ``torch.profiler``; host RSS before and after each heap trim; the
    phase's seconds.
17. The reference's ``model.ckpt`` (``reference_ckpt_path``, right after
    the default run, on its results): the ``torch_export`` CLI in a
    subprocess writes the run's checkpoint as ``model.ckpt`` in the layout
    of the flagship's ``reference_layout`` (a template file), imported back
    bit for bit; ``--only_evaluate yes`` on a directory holding only
    ``args.txt`` and that ``model.ckpt``, and on one holding the port's own
    checkpoint, each in a fresh process on deterministic algorithms: the 8
    JSON files equal number for number, the suite's exact launches;
    ``cli.main --epochs 1 --skip_eval yes`` into a directory holding only
    ``model.ckpt``: ``loaded model from``, the model before its first step
    equal to the export bit for bit, training's exact launches; Z1-Z6 at
    full width exported and imported on the card bit for bit.
18. wav2vec2 extraction at XLSR-53 width (``wav2vec_path``): random weights
    from seed 0 written as an HF checkpoint directory (``pytorch_model.bin``
    with the ``wav2vec2.`` prefix and the positional conv's weight norm as
    ``weight_g``/``weight_v``) and two synthetic stories at 48 kHz (60 s,
    and 24.5 s whose remainder after whole 8 s segments takes the
    reference's duplicated tail); the extraction CLI in a subprocess writes
    ``[round(frames * 64 / 50), 1024]`` layer-19 features (frames from the
    chunk arithmetic), finite, and a second run (its ``main`` in this
    process) skips both stories; a slab
    of 16 chunks of 10 s timed by CUDA events in f32 and bf16, profiled
    once, its peak memory and bound; a 60 s story through the extractor;
    two chunks card against CPU in f32 (``W2V_TOL``, beside the CPU's own
    f32-against-f64 spread); bf16 against f32 at JAX's limit; no kernel of
    the port launched.
19. The baselines (``baselines_phase``): ``FCNN``, ``CNN`` and
    ``ClassificationHead`` at their JAX default widths, batch 128, one
    forward and backward in training mode with dropout off, card against
    CPU within ``STEP_TOL``.
20. Data parallelism (``ddp_path``, after the reference phase): (a)
    ``--n_data_shards 1`` (one NCCL rank) against the plain run, 1 epoch
    each in a fresh process on deterministic cuDNN, the loss lines bit for
    bit; then two ranks sharing the card over gloo, started by the port's
    ``parallel.launch`` (each re-imports this module): (b) one step at
    global batch 128, dropout on, for the flagship, Z4 and the fused
    variant against one process on the same weights, batch and seed (losses,
    every gradient before AdamW, bank, running statistics; the buffers bit
    for bit across the ranks; Z4's float32 gradient is ill-conditioned, so
    it is held against the CPU's float64 step); (c) the default command line
    with ``--n_data_shards 2`` (2 epochs, the eval suite on deterministic
    algorithms): exact launches a rank-step (10/10/2/2) and of the suite, the
    replicas' checksum line, the losses against the one-process run above,
    a chunk's embeddings and the 8 eval files against a one-process
    ``--only_evaluate`` on the same checkpoint; (d) each rank's epoch-2
    median step beside the one process's, the all-gather and the gradient
    all-reduce.  #1-#4 at a rank's batch of 64 beside their bound there are
    timed with the kernel checks (``kernels_at_b64``).
21. The fold-sharded mesh (``cv_mesh_path``, after ``cv_path``): ``cv
    --parallel yes --n_data_shards 2 --folds 0 1 2 3 --epochs 1`` on two
    ranks sharing the card over gloo (the port's ``launch``; each rank's
    ``cv.main`` joins the group), twice in the same ranks: first with
    ``--skip_eval yes``, cuDNN off and torch's and cuBLAS's deterministic
    algorithms (cuDNN's deterministic algorithms give other bits in a
    process that shares the card), then on the default algorithms with its
    4 suites; beside each the unsharded run of the same folds with
    ``--skip_eval yes`` in a fresh process on the same algorithms: every
    fold's train and val CE and best weights bit for bit on the first pair,
    within ``CV_MESH_DEFAULT_LOSS_TOL`` / ``CV_MESH_DEFAULT_PARAM_TOL`` on the
    second; exact launches of #1-#4 a rank-step and of each rank's 2 suites,
    none of the bf16 instantiations; every suite file finite,
    ``cv_summary.json`` of 4 folds; the aggregate pairs/s of the runs.
22. Sharded serving (``shard_serve_path``, on the serve CLI phase's files):
    ``serve.main --shard 2`` on two ranks sharing the card (256 EEG windows,
    128 speech windows, top-5 of the 256 over 130 candidates) against the
    one-process CLI (1e-5 of max |x|; the indices equal but where two
    candidates' scores lie within that, with the closest such pair of the
    run); exact launches a rank-chunk; the wall time of each call.
23. DP x TP extraction (``tp_extraction_path``, after ``wav2vec_path``, on
    its XLSR-53-width weights): one 24.5 s story with ``--n_data_shards 2
    --n_model_shards 1`` and ``--n_data_shards 1 --n_model_shards 2`` on two
    ranks sharing the card against the one-process CLI (``W2V_TOL``); the
    1 x 2 grid's bf16 taps against f32 (JAX's 0.05); ms per slab of 16
    chunks, the all-reduces' host ms per slab, each rank's peak memory.
24. The learning-quality gate (``learning_quality_path``,
    ``tools/learning_quality.py``): JAX's recipe at the flagship's depth 10
    and widths, 12 epochs at batch 8 on the correlated fixture, then the
    match-mismatch evaluation, in float32 and in bfloat16; each must clear
    best val CE < 1.4, accuracy >= 0.7, top-1 >= 0.3; the launches of each.
25. The rehearsals (``rehearsal_path``) at a cut shape
    (``REHEARSAL_SHAPE``): ``tools/scale_rehearsal.py``'s ``gen``,
    ``ingest``, ``evict`` (equal digests, the tiny budget paying uploads)
    and a 1-epoch flagship ``train`` at batch 128, each stage a process of
    its own; ``tools/wav2vec_rehearsal.py`` on 2 stories of 2 min at
    XLSR-53 width (the first pass ends after its first story; the resume
    extracts exactly the other; bf16 within 0.05); ``tools/
    serve_rehearsal.py``: the index at 100,000 rows of 1,536 and 8
    concurrent clients through the micro-batcher (coalesced answers equal to
    one-at-a-time ones).  Each phase's seconds are printed.
26. Prints one JSON line of per-kernel numbers (``launches_by_path`` with
    ``train_augmented``, ``serve_cli``, ``server_cli``, ``train_bf16``,
    ``cv_parallel``, ``cv_sequential``, the ``K1`` runs,
    ``reference_only_evaluate``, ``reference_resume``,
    ``wav2vec_extraction``, ``baselines``, ``ddp_train`` and ``ddp_eval``
    (rank 0's), ``shard_serve``, ``cv_mesh_train``, ``cv_mesh_eval`` (rank
    0's), ``tp_extraction``, ``learning_quality``,
    ``learning_quality_bf16``, ``rehearsal_train``, ``rehearsal_extraction``
    and ``rehearsal_serve``; #1-#4 with ``ms_b64`` and ``bound_ms_b64``;
    the bf16 instantiations of #1 and #2 as entries of their own), then,
    last, the ``{"ok": true, "device": ...}`` line.

The kernel checks (3, 7, 14) and #1-#4 at batch 64, the serving path and
the augmentations run first, with nothing else on the card; then, as
alone, every phase whose processes take cuDNN algorithms by the free
memory and hold their numbers to another process's: the default run (5),
the zoo (6), 17, 20, 14's run, 11 and 16 (alone on the card, a process on
cuDNN's deterministic algorithms took up to 68 GiB, the zoo 44 GiB:
workspaces as large as the free memory, so a process beside them ran out
of memory, and one held to another limit took other algorithms).  The
rest run in three lanes at once (``LANES``): this process runs 14's steps
at batch 8, 15, 12, 13 and 22; a process of its own runs 21 and 24,
another 18, 23 and 25 (``python3 chip_smoke.py --lane NAME DATA_DIR OUT``,
each with ``LANE_THREADS`` CPU threads, its output printed when it ends,
its results returned in a pickle).  Meanwhile each lane's process may hold
at most ``MAIN_LANE_MEMORY`` or ``LANE_MEMORY`` of the card, and each rank
and fresh deterministic process ``CHILD_MEMORY`` (``capped``,
``cap_rank``).  Every phase gives its cached blocks back when it ends,
its peak printed in ``phase_peak_reserved_gib``.  So the lanes' host-clock and
CUDA-event times are taken beside the other lanes' work; the ``kernels``
line's ``ms``, ``plain_ms``, ``library_ms`` and ``ms_b64`` are not.  Then
8, 9 and 19.

Any failure raises and exits non-zero; a lane that fails fails the script,
and the script stops every lane's processes when it ends.  Imports nothing
of JAX.
"""

from __future__ import annotations

import contextlib
import gzip
import inspect
import io
import json
import os
import pickle
import re
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is False; this script needs a "
          "CUDA card", file=sys.stderr)
    sys.exit(1)

from transformer_clip_eeg_tpu_torch import _build, cli  # noqa: E402
from transformer_clip_eeg_tpu_torch.data.fixtures import make_fixture  # noqa: E402
from transformer_clip_eeg_tpu_torch.models.encoders import BasicBlock  # noqa: E402
from transformer_clip_eeg_tpu_torch.models.registry import (  # noqa: E402
    build_model_from_config as build_model,
)
from transformer_clip_eeg_tpu_torch.ops.augment import (  # noqa: E402
    AUGMENT_STREAM,
    BEST_AUG_PARAMS,
    DRAWS,
    MIXUP_STREAM,
    TRANSFORMS,
    draw_batch_mixup,
    draw_mixup_eeg,
    make_augmentation_fn,
    mixup_eeg,
)
from transformer_clip_eeg_tpu_torch.ops.dropout import (  # noqa: E402
    fold_seed,
    set_dropout_seeds,
)
from transformer_clip_eeg_tpu_torch.ops.fused_block import (  # noqa: E402
    DropoutConfig,
    fused_block_backward,
    fused_block_backward_reference,
    fused_block_forward_cuda,
    fused_block_saved_reference,
    fused_transformer_block,
    fused_transformer_block_reference,
)
from transformer_clip_eeg_tpu_torch.ops.fused_conv import (  # noqa: E402
    conv1d_reference,
    conv1d_same,
    fused_basic_block,
    fused_basic_block_reference,
    fused_conv_backward,
    fused_conv_forward_cuda,
)
from transformer_clip_eeg_tpu_torch.ops.lstm import LSTM  # noqa: E402
from transformer_clip_eeg_tpu_torch.parallel import attach, launch, shard_batch  # noqa: E402
from transformer_clip_eeg_tpu_torch.parallel.collectives import (  # noqa: E402
    all_gather_rows,
    checksum,
    gather_objects,
    mean_gradients,
)
from transformer_clip_eeg_tpu_torch.ops.lstm_scan import (  # noqa: E402
    _backward_recurrence as lstm_backward_recurrence,
    _dwhh as lstm_dwhh,
    _launch_forward as lstm_forward_cuda,
    PLAN_HIDDEN,
    MidPlan,
    WidePlan,
    lstm_launch_plan,
    mid_coresident,
    lstm_scan_backward,
    lstm_scan_packed,
    lstm_scan_reference,
    pad_hidden,
    plan_hidden,
)
from transformer_clip_eeg_tpu_torch.serve import (  # noqa: E402
    InferenceSession,
    RetrievalIndex,
    build_model_from_config,
    match_mismatch_decide,
)
from transformer_clip_eeg_tpu_torch.serve import main as serve_main  # noqa: E402
from transformer_clip_eeg_tpu_torch.server import (  # noqa: E402
    NPY_CONTENT_TYPE,
    EmbeddingService,
    make_server,
)
from transformer_clip_eeg_tpu_torch.train import checkpoint as ckpt_lib  # noqa: E402
from transformer_clip_eeg_tpu_torch.train.config import TrainConfig  # noqa: E402
from transformer_clip_eeg_tpu_torch.train.device_data import (  # noqa: E402
    DeviceChunkStore,
    gather_batch,
)
from transformer_clip_eeg_tpu_torch.train.loop import (  # noqa: E402
    PROFILE_TRACE,
    Trainer,
    batch_iterator,
)
from transformer_clip_eeg_tpu_torch.tools import kernel_launches  # noqa: E402
from transformer_clip_eeg_tpu_torch.train.state import make_optimizer  # noqa: E402
from transformer_clip_eeg_tpu_torch.train.steps import (  # noqa: E402
    _apply_mixup,
    _split_outputs as split_outputs,
    chunk_train_step,
    make_embed_fns,
    train_step,
)
from transformer_clip_eeg_tpu_torch.utils import torch_export, torch_import  # noqa: E402

# H100 SXM published peaks (dense): f32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
BLOCK_TOL = 1e-4   # f32 sums of 64-256 terms in another order than cuBLAS
LSTM_TOL = 1e-5    # 192 contracting steps of f32 gate math
# backward kernels: max abs error over max(1, max |reference|) per gradient.
# The block's dW sums 24,576 rows in another order than autograd's; the
# LSTM's backward carries a 4H-term dot product through 192 reverse steps
BLOCK_BWD_TOL = 1e-4
LSTM_BWD_TOL = 1e-5
# the conv kernels: K*C = 4,096-term f32 sums in another order than cuDNN's,
# then a LayerNorm over 12,288 values; the backward's dW sums 24,576 rows
CONV_TOL = 1e-4
CONV_BWD_TOL = 1e-4  # of max(1, max |reference|), per gradient
SERVE_TOL = 1e-3   # whole model, GPU vs CPU, after L2 normalisation
STEP_TOL = 1e-3    # one whole train step, card vs CPU, gradients and losses
STEP_GRAD_FLOOR = 1e-4  # of the largest gradient: the least scale a leaf is held to
BANK_SIZE = 1000   # memory-bank rows; unused by serving, carried as state
REPS = 20
FLAGSHIP_DROP = DropoutConfig(True, 1234, 0.5, 0.5)  # the block's rates in training
CONV_DROP = DropoutConfig(True, 4321, 0.2)  # the conv blocks' rate in training
N_FUSED_BLOCKS = 11  # the flagship's square BasicBlocks: 10 EEG (K=64), 1 speech (K=32)
RUN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_run")
# the share of the card each rank and each fresh deterministic process may
# hold while the lanes run (``capped``, ``cap_rank``; see ``LANES``)
CHILD_MEMORY = 0.12
LANES_ENV = "CHIP_SMOKE_LANES"  # "1" in the lanes' processes and what they start


def capped(script: str) -> str:
    """A ``python -c`` script that, while the lanes run, holds its process
    to ``CHILD_MEMORY``."""
    line = "torch.backends.cudnn.allow_tf32 = False\n"
    if line not in script:
        raise ValueError("the script sets no cuDNN flags to follow")
    if os.environ.get(LANES_ENV) != "1":
        return script
    return script.replace(line, line + f"torch.cuda.set_per_process_memory_fraction({CHILD_MEMORY})\n")


def cap_rank() -> None:
    """A rank started while the lanes run holds its process to ``CHILD_MEMORY``."""
    if os.environ.get(LANES_ENV) == "1":
        torch.cuda.set_per_process_memory_fraction(CHILD_MEMORY)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def block_case(gen: torch.Generator):
    """Flagship block inputs on the card: x [128, 192, 64] and the 16
    parameters (torch's default init, LayerNorms perturbed)."""
    b, t, e, f = 128, 192, 64, 256
    dev = "cuda"

    def u(*shape, fan_in):
        lim = 1.0 / fan_in ** 0.5
        return ((torch.rand(*shape, generator=gen) * 2 - 1) * lim).to(dev)

    def ln(n):
        return ((1 + 0.1 * torch.randn(n, generator=gen)).to(dev),
                (0.1 * torch.randn(n, generator=gen)).to(dev))

    g1, be1 = ln(e)
    g2, be2 = ln(e)
    wq, wk, wv, wo = (u(e, e, fan_in=e) for _ in range(4))
    bq, bk, bv, bo = (u(e, fan_in=e) for _ in range(4))
    w1, bb1 = u(f, e, fan_in=e), u(f, fan_in=e)
    w2, bb2 = u(e, f, fan_in=f), u(e, fan_in=f)
    params = (g1, be1, wq, wk, wv, bq, bk, bv, wo, bo, g2, be2, w1, bb1, w2, bb2)
    return torch.randn(b, t, e, generator=gen).to(dev), params


def library_layer(params, e=64, h=8, f=256, scale=8.0, dropout=0.0):
    """The nearest single torch call: a pre-LN TransformerEncoderLayer with
    the block's weights.  Its attention divides by sqrt(head dim); folding
    sqrt(d)/sqrt(E) into the Q projection makes it compute this block's
    function exactly (without dropout; with ``dropout`` in training mode it
    is the yardstick of the block's training forward)."""
    (g1, be1, wq, wk, wv, bq, bk, bv, wo, bo, g2, be2, w1, bb1, w2, bb2) = params
    lib = torch.nn.TransformerEncoderLayer(
        e, h, f, dropout=dropout, activation="gelu", batch_first=True,
        norm_first=True, device="cuda",
    )
    q_fold = (e // h) ** 0.5 / scale
    with torch.no_grad():
        lib.self_attn.in_proj_weight.copy_(torch.cat([wq * q_fold, wk, wv]))
        lib.self_attn.in_proj_bias.copy_(torch.cat([bq * q_fold, bk, bv]))
        lib.self_attn.out_proj.weight.copy_(wo)
        lib.self_attn.out_proj.bias.copy_(bo)
        lib.linear1.weight.copy_(w1)
        lib.linear1.bias.copy_(bb1)
        lib.linear2.weight.copy_(w2)
        lib.linear2.bias.copy_(bb2)
        lib.norm1.weight.copy_(g1)
        lib.norm1.bias.copy_(be1)
        lib.norm2.weight.copy_(g2)
        lib.norm2.bias.copy_(be2)
    return lib


def block_flops(b, t, e=64, f=256):
    """Forward products of the block: QKV, scores, P V, out-projection, FFN."""
    return b * (2 * t * e * e * 4 + 2 * 2 * t * t * e + 2 * 2 * t * e * f)


# (each part's f32 and bf16 kernels: the bf16 attentions and the bf16
# backward's row kernels are kernels of their own)
BLOCK_FWD_PARTS = {"ln_qkv": ("ln_qkv_kernel",),
                   "attention": ("attn_fwd_kernel", "attn_fwd_bf16_kernel"),
                   "proj_ffn": ("proj_ffn_kernel",)}
BLOCK_BWD_PARTS = {"rows": ("ffn_bwd_kernel", "qkv_bwd_kernel", "ffn_bwd_bf16_kernel",
                            "qkv_bwd_bf16_kernel"),
                   "attention": ("attn_bwd_kernel", "attn_bwd_bf16_kernel"),
                   "dw": ("products_kernel", "products_bf16_kernel"),
                   "sums": ("sums_kernel",)}
BLOCK_FWD_LAUNCHES = 3  # device launches of one call of kernel #1
SAVED_NAMES = ("q", "k", "v", "ctx", "x1", "lse")


def block_forward_errors(x, params) -> dict:
    """Kernel #1 against its twin on ``x``: the output in eval and in training
    (the flagship's rates, the same seed, so the same masks) and what the
    training forward saves for #2 (q, k, v, the dropped-out context, x1 and
    the log-sum-exp) against the twin's intermediates; raises past
    ``BLOCK_TOL``."""
    b, t, e = x.shape
    h, scale = 8, e ** 0.5
    with torch.inference_mode():
        got = fused_transformer_block(x, params, h, scale)
        torch.cuda.synchronize()
        errs = {"eval": float((got - fused_transformer_block_reference(
            x, params, h, scale)).abs().max())}
        got_tr, saved = fused_block_forward_cuda(x, params, h, scale, FLAGSHIP_DROP, save=True)
        torch.cuda.synchronize()
        errs["training"] = float((got_tr - fused_transformer_block_reference(
            x, params, h, scale, *FLAGSHIP_DROP)).abs().max())
        diff = (saved - fused_block_saved_reference(x, params, h, scale, FLAGSHIP_DROP)).abs()
        n = x.numel()
        for i, name in enumerate(SAVED_NAMES):
            errs[f"saved_{name}"] = float(diff[i * n:(i + 1) * n if i < 5 else None].max())
    log(f"fused_transformer_block x{tuple(x.shape)}: max_abs_err {json.dumps(errs)} "
        f"(tol {BLOCK_TOL:g})")
    if not max(errs.values()) <= BLOCK_TOL:
        raise AssertionError(f"fused block disagrees with its twin: {errs}")
    return errs


def block_forward_parts(run) -> dict:
    """One call of kernel #1 by part under the profiler; exactly
    ``BLOCK_FWD_LAUNCHES`` device launches a call.  Every call launches the
    same kernels, so a trace with a fraction of a launch a call lost records
    (seen once: 14 of 15) and is taken again, up to ``PROFILE_ATTEMPTS``
    times in all; the count is held to the trace kept."""
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        parts = kernel_parts(run, BLOCK_FWD_PARTS)
        if float(parts["launches_per_call"]).is_integer():
            break
        log(f"torch.profiler lost device records: {parts['launches_per_call']:g} launches "
            f"a call of kernel #1 (attempt {attempt} of {PROFILE_ATTEMPTS})")
    if parts["launches_per_call"] != BLOCK_FWD_LAUNCHES:
        raise AssertionError(f"fused_transformer_block takes {parts['launches_per_call']} "
                             f"device launches a call, want {BLOCK_FWD_LAUNCHES}")
    return parts


def check_block(x, params) -> dict:
    b, t, e = x.shape
    h, f = 8, 256
    scale = e ** 0.5
    errs = block_forward_errors(x, params)
    run_eval = lambda: fused_block_forward_cuda(x, params, h, scale)[:1]  # noqa: E731
    run_tr = lambda: fused_block_forward_cuda(x, params, h, scale, FLAGSHIP_DROP,  # noqa: E731
                                              save=True)
    with torch.inference_mode():
        assert_repeats("fused_transformer_block (eval)", run_eval)
        assert_repeats("fused_transformer_block (training: out and saved)", run_tr)
        lib = library_layer(params).eval()
        want = fused_transformer_block_reference(x, params, h, scale)
        lib_err = float((lib(x) - want).abs().max())
        ms_tr = time_ms(run_tr)
        ms = time_ms(lambda: fused_transformer_block(x, params, h, scale))
        plain_ms = time_ms(lambda: fused_transformer_block_reference(x, params, h, scale))
        library_ms = time_ms(lambda: lib(x))
        parts = {"eval": block_forward_parts(run_eval), "training": block_forward_parts(run_tr)}
    # the training forward's yardstick: the layer at the block's rate, in
    # training mode, recording its graph for the backward
    lib_tr = library_layer(params, dropout=0.5).train()
    library_training_ms = time_ms(lambda: lib_tr(x))
    usage = ptxas_of(*(k for keys in BLOCK_FWD_PARTS.values() for k in keys))
    spills = {k: u for k, u in usage.items() if u["spill_stores"] or u["spill_loads"]}
    if spills:
        raise AssertionError(f"kernel #1 spills registers: {spills}")

    flops = block_flops(b, t)
    nbytes = 2 * x.numel() * 4 + sum(p.numel() for p in params) * 4
    bound_ms, bound_by = bound(flops, nbytes)
    log(f"  kernel {ms:.4f} ms (training, saving for the backward: {ms_tr:.4f} ms), "
        f"plain {plain_ms:.4f} ms, TransformerEncoderLayer "
        f"{library_ms:.4f} ms (its max_abs_err {lib_err:.3e}; in training at dropout 0.5 "
        f"{library_training_ms:.4f} ms), bound {bound_ms:.4f} ms "
        f"({bound_by}, {flops / 1e9:.3f} GFLOP)")
    log(f"  parts (device ms per call, torch.profiler): eval "
        f"{json.dumps(parts['eval']['parts_ms'])}, training "
        f"{json.dumps(parts['training']['parts_ms'])}; {BLOCK_FWD_LAUNCHES} device launches "
        f"per call; ptxas {json.dumps(usage)}")
    if not (ms < library_ms and ms_tr < library_ms):
        raise AssertionError(f"kernel #1 ({ms:.4f} ms eval, {ms_tr:.4f} ms training) is not "
                             f"under the library layer ({library_ms:.4f} ms)")
    return {
        "name": "fused_transformer_block", "route": "cuda",
        "source": "transformer_clip_eeg_tpu_torch/csrc/fused_block.cu",
        "replaces": "transformer_clip_eeg_tpu/ops/pallas_block.py:458",
        "max_abs_err": max(errs.values()), "max_abs_err_eval": errs["eval"],
        "max_abs_err_training": errs["training"], "max_abs_err_by_output": errs,
        "tol": BLOCK_TOL, "ms": ms, "kernel_ms": ms,
        "training_ms": ms_tr,
        "plain_ms": plain_ms, "library_ms": library_ms,
        "library_training_ms": library_training_ms,
        "library_call": "torch.nn.TransformerEncoderLayer(norm_first=True), eval",
        "library_max_abs_err": lib_err,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "parts_ms": {mode: p["parts_ms"] for mode, p in parts.items()},
        "device_launches_per_call": BLOCK_FWD_LAUNCHES, "repeats_bit_for_bit": True,
        "ptxas": usage,
        "shape": {"x": list(x.shape), "heads": h, "ffn": f},
    }


def check_block_windows(gen: torch.Generator, params) -> dict:
    """Kernels #1 and #2 away from the flagship's window: T=256 and T=320 at
    batch 128 (``--window_length_s`` 4 and 5) against the twins, timed, and #1
    at batch 8, T=192 (a small request), timed."""
    h = 8
    out = {}
    for b, t in ((128, 256), (128, 320), (8, 192)):
        x = torch.randn(b, t, 64, generator=gen).to("cuda")
        scale = x.shape[-1] ** 0.5
        entry = {"x": list(x.shape), "max_abs_err": block_forward_errors(x, params)}
        with torch.inference_mode():
            entry["ms"] = time_ms(lambda: fused_transformer_block(x, params, h, scale))
            entry["training_ms"] = time_ms(lambda: fused_block_forward_cuda(
                x, params, h, scale, FLAGSHIP_DROP, save=True))
            # the three kernels' device time: at a small batch the CUDA-event
            # time of a call is the host's time to enqueue it
            entry["device_ms"] = sum(block_forward_parts(
                lambda: fused_block_forward_cuda(x, params, h, scale)[:1])["parts_ms"].values())
        entry["bound_ms"] = bound(block_flops(b, t), 0)[0]
        if b == 128:
            g = torch.randn(b, t, 64, generator=gen).to("cuda")
            errs, _, _, _ = block_backward_errors(x, params, g)
            _, saved = fused_block_forward_cuda(x, params, h, scale, FLAGSHIP_DROP, save=True)
            entry["backward_max_grad_err"] = max(errs)
            entry["backward_ms"] = time_ms(lambda: fused_block_backward(
                x, params, g, saved, h, scale, FLAGSHIP_DROP))
            del g, saved
        log(f"  B={b}, T={t}: #1 {entry['ms']:.4f} ms eval ({entry['device_ms']:.4f} ms on the "
            f"device), {entry['training_ms']:.4f} ms training (bound {entry['bound_ms']:.4f} ms)"
            + (f"; #2 {entry['backward_ms']:.4f} ms, worst gradient error "
               f"{entry['backward_max_grad_err']:.3e}" if b == 128 else ""))
        out[f"B{b}_T{t}"] = entry
        del x
        torch.cuda.empty_cache()
    return out


def ptxas_usage(kind: str, hidden: int, plan) -> dict:
    """What ``ptxas -v`` reported for the kernel that runs ``hidden`` under
    ``plan`` (``lstm_{kind}_cluster<hidden>``, ``lstm_{kind}_mid<tile / 8>``
    at 256, or ``lstm_{kind}_wide`` past 256): registers, spill stores and
    loads, stack bytes.  Raises if an H=256 kernel spills."""
    if isinstance(plan, MidPlan):
        ptxas_spills(f"lstm_{kind}_mid")
        name = f"lstm_{kind}_midILi{plan.batch_tile // 8}E"
    elif hidden in PLAN_HIDDEN:
        name = f"lstm_{kind}_clusterILi{hidden}E"
    else:
        name = f"lstm_{kind}_wide"
    return ptxas_of(name)[name]


def mid_waves(plan) -> dict:
    """An H=256 plan's clusters beside those each kernel's tile holds on
    this card at once (``cudaOccupancyMaxActiveClusters``); raises if a plan
    that claims one wave does not fit."""
    clusters = plan.ctas // plan.cluster
    out = {"clusters": clusters, "waves": plan.waves,
           "coresident": {k: mid_coresident(k, plan) for k in ("fwd", "bwd")}}
    if plan.waves == 1 and min(out["coresident"].values()) < clusters:
        raise AssertionError(f"the H=256 plan is not one wave on this card: {out}")
    return out


def plan_text(plan) -> str:
    if isinstance(plan, WidePlan):
        return (f"wide (forward / backward): {plan.ctas_fwd} / {plan.ctas_bwd} CTAs of "
                f"{plan.threads} threads x {plan.launches_fwd} / {plan.launches_bwd} launches, "
                f"{plan.units_fwd} / {plan.units_bwd} units a CTA in {plan.groups_fwd} / "
                f"{plan.groups_bwd} batch groups, whh rows resident "
                f"{plan.resident_fwd} / {plan.resident_bwd}, smem {plan.smem_fwd} / "
                f"{plan.smem_bwd} B")
    text = (f"clusters of {plan.cluster} CTAs x {plan.batch_tile} rows, {plan.ctas} CTAs of "
            f"{plan.threads} threads")
    if isinstance(plan, MidPlan):
        w = mid_waves(plan)
        text += (f", {w['clusters']} clusters in {w['waves']} wave(s), co-resident on this "
                 f"card: {w['coresident']['fwd']} (forward) / {w['coresident']['bwd']} "
                 f"(backward)")
    return text


# the recurrences timed in the kernel phase: (H, input width, D).  The
# flagship's speech encoder packs both directions (D=2) of a biLSTM of H=128
# (input 64) and one of H=4 (input 256); the zoo's double_lstm and lstm
# encoders run unidirectional ones (D=1) at H=--lstm_units=128.  Then the
# other hidden sizes the flags give: H=256 (--lstm_units 256, both
# packings), H=100 (--lstm_units 100, padded to 128) and H=2 (--latent_dim
# 4's second biLSTM, padded to 4).  Past 256 the wide kernels: H=512 both
# packings (--lstm_units 512; --latent_dim 1024's second biLSTM), H=300
# (padded to 320), H=1024 at D=2 and at D=1 (--lstm_units 1024), where part
# of each CTA's slice of whh is streamed from L2 every step
LSTM_SHAPES = ((128, 64, 2), (4, 256, 2), (128, 128, 1),
               (256, 64, 2), (256, 256, 1), (100, 100, 2), (2, 256, 2),
               (512, 64, 2), (512, 512, 1), (300, 64, 2), (1024, 64, 2), (1024, 1024, 1))
FLAGSHIP_LSTMS = ((128, 2), (4, 2))  # (H, D) of the flagship's two recurrences


def _flagship_lstm(shape: dict) -> bool:
    return (shape["hidden"], shape["directions"]) in FLAGSHIP_LSTMS


def check_lstm(gen: torch.Generator) -> dict:
    """The recurrences of ``LSTM_SHAPES`` at batch 128, T=192 (an H the
    kernels are not built for runs padded, ``padded_to``); the entry's
    totals are the flagship's two, the others are in ``shapes``."""
    t, b = 192, 128
    dev = "cuda"
    shapes = []
    with torch.inference_mode():
        for hidden, in_dim, d in LSTM_SHAPES:
            lim = 1.0 / hidden ** 0.5
            xw = (0.5 * torch.randn(t, d, b, 4 * hidden, generator=gen)).to(dev)
            whh = ((torch.rand(d, hidden, 4 * hidden, generator=gen) * 2 - 1) * lim).to(dev)
            got = lstm_scan_packed(xw, whh)
            torch.cuda.synchronize()
            want = lstm_scan_reference(xw, whh)
            err = float((got - want).abs().max())
            log(f"lstm_scan_packed xw{tuple(xw.shape)}: max_abs_err {err:.3e} "
                f"(tol {LSTM_TOL:g})")
            if not err <= LSTM_TOL:
                raise AssertionError(f"LSTM recurrence disagrees with its twin: {err}")
            # yardstick: cuDNN's LSTM (bidirectional at D=2), input projection included
            lib = torch.nn.LSTM(in_dim, hidden, batch_first=True, bidirectional=d == 2,
                                device=dev).eval()
            x = torch.randn(b, t, in_dim, generator=gen).to(dev)
            ms = time_ms(lambda: lstm_scan_packed(xw, whh))
            plain_ms = time_ms(lambda: lstm_scan_reference(xw, whh))
            library_ms = time_ms(lambda: lib(x))
            flops = 2 * hidden * 4 * hidden * t * b * d
            nbytes = (xw.numel() + whh.numel() + t * d * b * hidden) * 4
            bound_ms, bound_by = bound(flops, nbytes)
            hp = plan_hidden(hidden)
            plan = lstm_launch_plan(b, d, hp)
            usage = ptxas_usage("fwd", hp, plan)
            if isinstance(plan, MidPlan):
                assert_repeats(f"lstm_scan_packed H={hidden} D={d}",
                               lambda: (lstm_scan_packed(xw, whh),))
            log(f"  H={hidden}{f' (padded to {hp})' if hp != hidden else ''}, D={d}: kernel "
                f"{ms:.4f} ms ({ms / t * 1e3:.3f} us/step), plain "
                f"{plain_ms:.4f} ms, nn.LSTM {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by}); {plan_text(plan)}; ptxas {usage}")
            shape = {
                "hidden": hidden, "padded_to": hp, "directions": d, "xw": list(xw.shape),
                "max_abs_err": err, "ms": ms,
                "us_per_step": ms / t * 1e3, "plain_ms": plain_ms,
                "library_ms": library_ms, "beats_library": ms < library_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "plan": plan._asdict(), "ptxas": usage,
            }
            if isinstance(plan, MidPlan):
                shape.update(mid_waves(plan), repeats_bit_for_bit=True)
            shapes.append(shape)
    flagship = [s for s in shapes if _flagship_lstm(s)]
    total = lambda key: sum(s[key] for s in flagship)  # noqa: E731
    return {
        "name": "lstm_scan_packed", "route": "cuda",
        "source": "transformer_clip_eeg_tpu_torch/csrc/lstm_scan.cu",
        "replaces": "transformer_clip_eeg_tpu/ops/pallas_lstm.py:219",
        "max_abs_err": max(s["max_abs_err"] for s in shapes), "tol": LSTM_TOL,
        "ms": total("ms"), "kernel_ms": total("ms"), "plain_ms": total("plain_ms"),
        "library_ms": total("library_ms"),
        "library_call": "torch.nn.LSTM(bidirectional=True), input projection included",
        "bound_ms": total("bound_ms"),
        "bound_by": max(flagship, key=lambda s: s["bound_ms"])["bound_by"],
        "times_are": "sums over the two recurrences of one flagship speech chunk (D=2); "
                     "shapes also holds D=1, H=256, the padded H=100 and H=2, and the wide "
                     "kernels' H=512, 300 (padded to 320) and 1024",
        "shapes": shapes,
    }


def grad_err(got, want) -> float:
    """max abs error over max(1, max |want|): relative for large gradients,
    absolute for ones that are zero in exact arithmetic (the key bias's)."""
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1.0)


def block_backward_errors(x, params, g):
    """Kernel #2 through the autograd Function against autograd through the
    twin, in training mode at the flagship's rates, dx and the 16 dparams:
    the errors per leaf (raises past ``BLOCK_BWD_TOL``), the largest absolute
    error, and the twin's output and leaves (to time its backward)."""
    h, scale = 8, x.shape[-1] ** 0.5
    leaves = [x.clone().requires_grad_()] + [p.clone().requires_grad_() for p in params]
    out = fused_transformer_block(leaves[0], leaves[1:], h, scale, training=True,
                                  seed=FLAGSHIP_DROP.seed, drop_p=0.5, ffn_drop_p=0.5)
    got = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    ref = [x.clone().requires_grad_()] + [p.clone().requires_grad_() for p in params]
    want_out = fused_transformer_block_reference(ref[0], ref[1:], h, scale, *FLAGSHIP_DROP)
    want = torch.autograd.grad(want_out, ref, g, retain_graph=True)
    errs = [grad_err(a, w) for a, w in zip(got, want)]
    abs_err = max(float((a - w).abs().max()) for a, w in zip(got, want))
    log(f"fused_block_backward x{tuple(x.shape)} (training, drop 0.5/0.5): worst gradient "
        f"error {max(errs):.3e} (tol {BLOCK_BWD_TOL:g} x max(1, max|ref|)), max_abs_err "
        f"{abs_err:.3e}; per leaf {[f'{v:.1e}' for v in errs]}")
    if not max(errs) <= BLOCK_BWD_TOL:
        raise AssertionError(f"block backward disagrees with autograd through its twin: {errs}")
    return errs, abs_err, want_out, ref


def check_block_backward(x, params, gen: torch.Generator) -> dict:
    """Kernel #2 at the flagship shape: against autograd through the twin,
    its parts, its launches, a bit-for-bit repeat and its times."""
    b, t, e = x.shape
    h, scale = 8, e ** 0.5
    g = torch.randn(b, t, e, generator=gen).to("cuda")
    errs, abs_err, want_out, ref = block_backward_errors(x, params, g)

    _, saved = fused_block_forward_cuda(x, params, h, scale, FLAGSHIP_DROP, save=True)

    def run():
        dx, dparams = fused_block_backward(x, params, g, saved, h, scale, FLAGSHIP_DROP)
        return (dx, *dparams)

    assert_repeats("fused_block_backward", run)
    ms = time_ms(run)
    parts = kernel_parts(run, BLOCK_BWD_PARTS)
    dw_flops = 2.0 * b * t * (2 * e * 256 + 4 * e * e)
    dw_tflops = dw_flops / (parts["parts_ms"]["dw"] * 1e-3) / 1e12
    usage = ptxas_of("ffn_bwd_kernel", "attn_bwd_kernel", "qkv_bwd_kernel", "products_kernel",
                     "sums_kernel")
    log(f"  parts (device ms per call, torch.profiler): {json.dumps(parts['parts_ms'])}; "
        f"{parts['launches_per_call']:g} device launches per call; dW products "
        f"{dw_flops / 1e9:.3f} GFLOP at {dw_tflops:.2f} TFLOP/s (f32 peak "
        f"{PEAK_F32_FLOPS / 1e12:g}); ptxas {json.dumps(usage)}")
    if parts["launches_per_call"] > 6:
        raise AssertionError(f"fused_block_backward takes {parts['launches_per_call']} "
                             f"launches a call, want at most 6")
    plain_ms = time_ms(lambda: torch.autograd.grad(want_out, ref, g, retain_graph=True))
    lib = library_layer(params).train()
    xl = x.clone().requires_grad_()
    lib_leaves = [xl] + list(lib.parameters())
    lib_out = lib(xl)
    library_ms = time_ms(lambda: torch.autograd.grad(lib_out, lib_leaves, g, retain_graph=True))
    # dX and dW for each forward product: twice the forward's operations;
    # bytes: x, g, the saved activations and the parameters in, dx and dparams out
    flops = 2 * block_flops(b, t)
    n_par = sum(p.numel() for p in params)
    nbytes = 4 * (2 * x.numel() + saved.numel() + n_par + x.numel() + n_par)
    bound_ms, bound_by = bound(flops, nbytes)
    log(f"  kernel {ms:.4f} ms, plain (autograd through the twin) {plain_ms:.4f} ms, "
        f"TransformerEncoderLayer backward {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}, {flops / 1e9:.3f} GFLOP)")
    return {
        "name": "fused_block_backward", "route": "cuda",
        "source": "transformer_clip_eeg_tpu_torch/csrc/fused_block_bwd.cu",
        "replaces": "transformer_clip_eeg_tpu/ops/pallas_block.py:498",
        "max_abs_err": abs_err, "max_grad_err": max(errs), "tol": BLOCK_BWD_TOL,
        "tol_is": "max abs error / max(1, max|ref|), per gradient",
        "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "library_call": "backward of torch.nn.TransformerEncoderLayer(norm_first=True)",
        "bound_ms": bound_ms, "bound_by": bound_by,
        "parts_ms": parts["parts_ms"], "parts_launches": parts["parts_launches"],
        "device_launches_per_call": parts["launches_per_call"],
        "dw_tflops": dw_tflops, "repeats_bit_for_bit": True, "ptxas": usage,
        "shape": {"x": list(x.shape), "heads": h, "ffn": 256, "drop": [0.5, 0.5]},
    }


def check_lstm_backward(gen: torch.Generator) -> dict:
    """Kernel #4 through the autograd Function against autograd through the
    twin, for the recurrences of ``LSTM_SHAPES`` (an H the kernels are not
    built for through the padding, its parts timed on the padded inputs);
    the entry's totals are the flagship's two."""
    t, b = 192, 128
    dev = "cuda"
    shapes = []
    for hidden, in_dim, d in LSTM_SHAPES:
        lim = 1.0 / hidden ** 0.5
        xw = (0.5 * torch.randn(t, d, b, 4 * hidden, generator=gen)).to(dev)
        whh = ((torch.rand(d, hidden, 4 * hidden, generator=gen) * 2 - 1) * lim).to(dev)
        g = torch.randn(t, d, b, hidden, generator=gen).to(dev)
        a, w = xw.clone().requires_grad_(), whh.clone().requires_grad_()
        got = torch.autograd.grad(lstm_scan_packed(a, w), (a, w), g)
        torch.cuda.synchronize()
        ra, rw = xw.clone().requires_grad_(), whh.clone().requires_grad_()
        ref_h = lstm_scan_reference(ra, rw)
        want = torch.autograd.grad(ref_h, (ra, rw), g, retain_graph=True)
        errs = [grad_err(u, v) for u, v in zip(got, want)]
        abs_err = max(float((u - v).abs().max()) for u, v in zip(got, want))
        log(f"lstm_scan_backward H={hidden}, D={d}: dxw error {errs[0]:.3e}, dwhh error "
            f"{errs[1]:.3e} (tol {LSTM_BWD_TOL:g} x max(1, max|ref|)), max_abs_err {abs_err:.3e}")
        if not max(errs) <= LSTM_BWD_TOL:
            raise AssertionError(f"LSTM backward disagrees with autograd through its twin: {errs}")
        # the kernel alone, and its two parts apart: the recurrence (dxw) and
        # the dwhh reduction, on the inputs padded to the H the kernel runs
        hp = plan_hidden(hidden)
        xw_p, whh_p = pad_hidden(xw, whh, hp)
        g_p = torch.nn.functional.pad(g, (0, hp - hidden)).contiguous()
        h, c, gates = lstm_forward_cuda(xw_p, whh_p, return_c=True, save_gates=True)
        ms = time_ms(lambda: lstm_scan_backward(whh_p, h, c, gates, g_p))
        dxw = lstm_backward_recurrence(whh_p, c, gates, g_p)
        recurrence_ms = time_ms(lambda: lstm_backward_recurrence(whh_p, c, gates, g_p))
        dwhh_ms = time_ms(lambda: lstm_dwhh(h, dxw))
        dwhh_tflops = 2.0 * (t - 1) * d * b * hp * 4 * hp / (dwhh_ms * 1e-3) / 1e12
        plan = lstm_launch_plan(b, d, hp)
        usage = ptxas_usage("bwd", hp, plan)
        if isinstance(plan, MidPlan):
            assert_repeats(f"lstm_scan_backward H={hidden} D={d} (recurrence, dwhh)",
                           lambda: (lstm_backward_recurrence(whh_p, c, gates, g_p),
                                    lstm_dwhh(h, dxw)))
        plain_ms = time_ms(lambda: torch.autograd.grad(ref_h, (ra, rw), g, retain_graph=True),
                           reps=5, warmup=1)
        lib = torch.nn.LSTM(in_dim, hidden, batch_first=True, bidirectional=d == 2,
                            device=dev)
        xl = torch.randn(b, t, in_dim, generator=gen).to(dev).requires_grad_()
        lib_leaves = [xl] + list(lib.parameters())
        lib_out, _ = lib(xl)
        g_lib = torch.randn(b, t, d * hidden, generator=gen).to(dev)
        library_ms = time_ms(lambda: torch.autograd.grad(lib_out, lib_leaves, g_lib,
                                                         retain_graph=True))
        rows = t * d * b
        flops = 2 * rows * 4 * hidden * hidden * 2  # dpre whh^T and h_prev^T dpre
        nbytes = 4 * (2 * rows * 4 * hidden + 3 * rows * hidden + 2 * whh.numel())
        bound_ms, bound_by = bound(flops, nbytes)
        log(f"  H={hidden}{f' (padded to {hp})' if hp != hidden else ''}, D={d}: kernel "
            f"{ms:.4f} ms ({ms / t * 1e3:.3f} us/step): recurrence "
            f"{recurrence_ms:.4f} ms ({recurrence_ms / t * 1e3:.3f} us/step), dwhh "
            f"{dwhh_ms:.4f} ms ({dwhh_tflops:.2f} TFLOP/s, two launches); plain {plain_ms:.4f} ms, nn.LSTM backward {library_ms:.4f} "
            f"ms, bound {bound_ms:.4f} ms ({bound_by}); {plan_text(plan)}; ptxas {usage}")
        shape = {
            "hidden": hidden, "padded_to": hp, "directions": d, "xw": list(xw.shape),
            "max_abs_err": abs_err,
            "max_grad_err": max(errs), "ms": ms, "us_per_step": ms / t * 1e3,
            "recurrence_ms": recurrence_ms, "recurrence_us_per_step": recurrence_ms / t * 1e3,
            "dwhh_ms": dwhh_ms, "dwhh_tflops": dwhh_tflops, "plain_ms": plain_ms,
            "library_ms": library_ms, "beats_library": ms < library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "plan": plan._asdict(),
            "ptxas": usage,
        }
        if isinstance(plan, MidPlan):
            shape.update(mid_waves(plan), repeats_bit_for_bit=True)
        shapes.append(shape)
    flagship = [s for s in shapes if _flagship_lstm(s)]
    total = lambda key: sum(s[key] for s in flagship)  # noqa: E731
    return {
        "name": "lstm_scan_backward", "route": "cuda",
        "source": "transformer_clip_eeg_tpu_torch/csrc/lstm_scan_bwd.cu",
        "replaces": "transformer_clip_eeg_tpu/ops/pallas_lstm.py:290",
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "max_grad_err": max(s["max_grad_err"] for s in shapes), "tol": LSTM_BWD_TOL,
        "tol_is": "max abs error / max(1, max|ref|), per gradient",
        "ms": total("ms"), "kernel_ms": total("ms"), "plain_ms": total("plain_ms"),
        "library_ms": total("library_ms"),
        "library_call": "backward of torch.nn.LSTM(bidirectional=True), input "
                        "projection's gradients included",
        "bound_ms": total("bound_ms"),
        "bound_by": max(flagship, key=lambda s: s["bound_ms"])["bound_by"],
        "times_are": "sums over the two recurrences of one flagship train step (D=2); "
                     "shapes also holds D=1, H=256, the padded H=100 and H=2, and the wide "
                     "kernels' H=512, 300 (padded to 320) and 1024",
        "shapes": shapes,
    }


def conv_case(gen: torch.Generator, k: int, b: int = 128, t: int = 192, c: int = 64):
    """Flagship conv-block inputs on the card: x [128, 192, 64], w [64, 64, K]
    and b at torch's init scale, a perturbed [T, C] LayerNorm affine, and an
    upstream gradient."""
    lim = 1.0 / (c * k) ** 0.5
    x = torch.randn(b, t, c, generator=gen)
    w = (torch.rand(c, c, k, generator=gen) * 2 - 1) * lim
    bb = (torch.rand(c, generator=gen) * 2 - 1) * lim
    scale = 1 + 0.1 * torch.randn(t, c, generator=gen)
    bias = 0.1 * torch.randn(t, c, generator=gen)
    g = torch.randn(b, t, c, generator=gen)
    return [v.to("cuda") for v in (x, w, bb, scale, bias, g)]


def unfused_block(w, bb, scale, bias) -> BasicBlock:
    """The port's unfused BasicBlock (cuDNN conv, LayerNorm, GELU) holding
    the same parameters: the yardstick of kernels #5 and #6."""
    c, _, k = w.shape
    block = BasicBlock(c, c, k, scale.shape[0], CONV_DROP.drop_p).to("cuda")
    with torch.no_grad():
        for dst, src in ((block.conv.weight, w), (block.conv.bias, bb),
                         (block.normalization.weight, scale), (block.normalization.bias, bias)):
            dst.copy_(src)
    return block


def conv_flops(x, k) -> float:
    b, t, c = x.shape
    return 2.0 * b * t * k * c * c


def check_conv(gen: torch.Generator):
    """Kernels #5, #6 and #7 at the flagship's shapes, for the EEG blocks'
    K=64 and the speech block's K=32: one dict each, whose top-level numbers
    are K=64's (10 of a step's 11 launches) and whose ``shapes`` hold both."""
    fwd, bwd, alone = [], [], []
    for k in (64, 32):
        x, w, bb, scale, bias, g = conv_case(gen, k)
        b, t, c = x.shape
        lib = unfused_block(w, bb, scale, bias)
        with torch.inference_mode():
            errs = {}
            for mode, drop in (("eval", DropoutConfig()), ("training", CONV_DROP)):
                got = fused_basic_block(x, w, bb, scale, bias, drop.seed, k, drop.drop_p,
                                        drop.training)
                torch.cuda.synchronize()
                want = fused_basic_block_reference(x, w, bb, scale, bias, drop.seed, k,
                                                   drop.drop_p, drop.training)
                errs[mode] = float((got - want).abs().max())
            lib_err = float((lib.eval()(x) - fused_basic_block_reference(
                x, w, bb, scale, bias, 0, k, 0.0, False)).abs().max())
            log(f"fused_basic_block K={k} x{tuple(x.shape)}: max_abs_err eval "
                f"{errs['eval']:.3e}, training (drop 0.2) {errs['training']:.3e} "
                f"(tol {CONV_TOL:g}); unfused BasicBlock {lib_err:.3e}")
            if not max(errs.values()) <= CONV_TOL:
                raise AssertionError(f"fused conv block disagrees with its twin: {errs}")
            ms = time_ms(lambda: fused_basic_block(x, w, bb, scale, bias, 0, k, 0.0, False))
            ms_tr = time_ms(lambda: fused_conv_forward_cuda(x, w, bb, scale, bias, CONV_DROP,
                                                            save=True))
            plain_ms = time_ms(lambda: fused_basic_block_reference(x, w, bb, scale, bias, 0, k,
                                                                   0.0, False))
            library_ms = time_ms(lambda: lib(x))
        nbytes = 4 * (2 * x.numel() + w.numel() + c + 2 * t * c)
        bound_ms, bound_by = bound(conv_flops(x, k), nbytes)
        log(f"  kernel {ms:.4f} ms (training, saving for the backward: {ms_tr:.4f} ms), "
            f"plain {plain_ms:.4f} ms, unfused BasicBlock {library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}, {conv_flops(x, k) / 1e9:.3f} GFLOP)")
        fwd.append({"k": k, "x": list(x.shape), "max_abs_err_eval": errs["eval"],
                    "max_abs_err_training": errs["training"], "ms": ms, "training_ms": ms_tr,
                    "plain_ms": plain_ms, "library_ms": library_ms,
                    "library_max_abs_err": lib_err, "bound_ms": bound_ms,
                    "bound_by": bound_by})

        # #6 through the autograd Function against autograd through the twin
        leaves = [v.clone().requires_grad_() for v in (x, w, bb, scale, bias)]
        out = fused_basic_block(*leaves, CONV_DROP.seed, k, CONV_DROP.drop_p, True)
        got = torch.autograd.grad(out, leaves, g)
        torch.cuda.synchronize()
        ref = [v.clone().requires_grad_() for v in (x, w, bb, scale, bias)]
        want_out = fused_basic_block_reference(*ref, CONV_DROP.seed, k, CONV_DROP.drop_p, True)
        want = torch.autograd.grad(want_out, ref, g, retain_graph=True)
        names = ("dx", "dw", "db", "dscale", "dbias")
        gerrs = {n: grad_err(a, r) for n, a, r in zip(names, got, want)}
        abs_err = max(float((a - r).abs().max()) for a, r in zip(got, want))
        log(f"fused_conv_backward K={k} (training, drop 0.2): gradient errors "
            f"{ {n: f'{v:.1e}' for n, v in gerrs.items()} } (tol {CONV_BWD_TOL:g} x max(1, "
            f"max|ref|)), max_abs_err {abs_err:.3e}")
        if not max(gerrs.values()) <= CONV_BWD_TOL:
            raise AssertionError(f"conv backward disagrees with autograd through its twin: "
                                 f"{gerrs}")
        _, z, stats = fused_conv_forward_cuda(x, w, bb, scale, bias, CONV_DROP, save=True)
        run = lambda: fused_conv_backward(x, w, scale, bias, g, z, stats, CONV_DROP)  # noqa: E731
        assert_repeats(f"fused_conv_backward K={k}", run)
        ms = time_ms(run)
        # the rest is dx: #7 on dconv and the copies that flip and re-lay its weights
        parts = kernel_parts(run, {"rows": ("conv_bwd_rows_kernel",),
                                   "dw": ("dw_partial_kernel",), "sums": ("sums_kernel",)},
                             rest="dx")
        own = parts["launches_per_call"] - parts["parts_launches"]["dx"]
        dw_tflops = conv_flops(x, k) / (parts["parts_ms"]["dw"] * 1e-3) / 1e12
        usage = ptxas_of("conv_bwd_rows_kernel", "dw_partial_kernel", "sums_kernel")
        log(f"  parts (device ms per call, torch.profiler): {json.dumps(parts['parts_ms'])}; "
            f"{own:g} device launches per call without dx, {parts['launches_per_call']:g} "
            f"with; dW {conv_flops(x, k) / 1e9:.3f} GFLOP at {dw_tflops:.2f} TFLOP/s (f32 "
            f"peak {PEAK_F32_FLOPS / 1e12:g}); ptxas {json.dumps(usage)}")
        if own > 5:
            raise AssertionError(f"fused_conv_backward takes {own} launches a call without "
                                 f"its dx, want at most 5")
        plain_ms = time_ms(lambda: torch.autograd.grad(want_out, ref, g, retain_graph=True))
        lib.train()
        lib.dropout.dropout_seed = CONV_DROP.seed
        xl = x.clone().requires_grad_()
        lib_leaves = [xl] + list(lib.parameters())
        lib_out = lib(xl)
        library_ms = time_ms(lambda: torch.autograd.grad(lib_out, lib_leaves, g,
                                                         retain_graph=True))
        # dW and dx; bytes: x, g, z, stats and the parameters in, the gradients out
        flops = 2 * conv_flops(x, k)
        nbytes = 4 * (4 * x.numel() + 2 * b + 2 * (w.numel() + c + 2 * t * c))
        bound_ms, bound_by = bound(flops, nbytes)
        log(f"  kernel (dx by #7 included) {ms:.4f} ms, plain (autograd through the twin) "
            f"{plain_ms:.4f} ms, unfused BasicBlock backward {library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}, {flops / 1e9:.3f} GFLOP)")
        bwd.append({"k": k, "x": list(x.shape), "max_abs_err": abs_err,
                    "max_grad_err": max(gerrs.values()), "grad_err": gerrs, "ms": ms,
                    "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "parts_ms": parts["parts_ms"],
                    "parts_launches": parts["parts_launches"],
                    "device_launches_per_call": parts["launches_per_call"],
                    "device_launches_without_dx": own,
                    "dw_tflops": dw_tflops, "repeats_bit_for_bit": True, "ptxas": usage})

        # #7, the conv alone, against F.conv1d
        with torch.inference_mode():
            lo, hi = (k - 1) // 2, k - 1 - (k - 1) // 2
            got = conv1d_same(x, w)
            torch.cuda.synchronize()
            err = float((got - conv1d_reference(x, w, (lo, hi))).abs().max())
            log(f"conv1d_same K={k}: max_abs_err against F.conv1d {err:.3e} (tol {CONV_TOL:g})")
            if not err <= CONV_TOL:
                raise AssertionError(f"conv1d_same disagrees with F.conv1d: {err}")
            xcp = torch.nn.functional.pad(x.transpose(1, 2), (lo, hi)).contiguous()
            ms = time_ms(lambda: conv1d_same(x, w))
            plain_ms = time_ms(lambda: conv1d_reference(x, w, (lo, hi)))
            library_ms = time_ms(lambda: torch.nn.functional.conv1d(xcp, w))
        bound_ms, bound_by = bound(conv_flops(x, k), 4 * (2 * x.numel() + w.numel()))
        log(f"  kernel {ms:.4f} ms, plain (pad + F.conv1d + transposes) {plain_ms:.4f} ms, "
            f"F.conv1d on the padded [B, C, T] input {library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by})")
        alone.append({"k": k, "x": list(x.shape), "max_abs_err": err, "ms": ms,
                      "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by})
        del x, w, bb, scale, bias, g, lib, leaves, out, got, ref, want_out, want, z, stats
        torch.cuda.empty_cache()

    def entry(name, source, replaces, shapes, tol, library_call, **extra):
        top = shapes[0]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "max_abs_err": max(s.get("max_abs_err", 0.0) for s in shapes), "tol": tol,
                "ms": top["ms"], "kernel_ms": top["ms"], "plain_ms": top["plain_ms"],
                "library_ms": top["library_ms"], "library_call": library_call,
                "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
                "times_are": "K=64 (the EEG blocks), per launch; shapes holds K=32",
                "shapes": shapes, **extra}

    for s in fwd:
        s["max_abs_err"] = max(s["max_abs_err_eval"], s["max_abs_err_training"])
    return [
        entry("fused_basic_block", "transformer_clip_eeg_tpu_torch/csrc/fused_conv.cu",
              "transformer_clip_eeg_tpu/ops/pallas_conv.py:267", fwd, CONV_TOL,
              "the port's unfused BasicBlock in eval (cuDNN conv, layer_norm, gelu)",
              training_ms=fwd[0]["training_ms"]),
        entry("fused_conv_backward", "transformer_clip_eeg_tpu_torch/csrc/fused_conv_bwd.cu",
              "transformer_clip_eeg_tpu/ops/pallas_conv.py:308", bwd, CONV_BWD_TOL,
              "backward of the port's unfused BasicBlock in training",
              max_grad_err=max(s["max_grad_err"] for s in bwd),
              tol_is="max abs error / max(1, max|ref|), per gradient"),
        entry("conv1d_same", "transformer_clip_eeg_tpu_torch/csrc/fused_conv.cu",
              "scripts/bench_conv_algo.py:74", alone, CONV_TOL,
              "torch.nn.functional.conv1d on the padded [B, C, T] input"),
    ]


def _post(url, payload=None, body=None, headers=None):
    data = body if body is not None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers=headers or {})
    with urllib.request.urlopen(req, timeout=300) as resp:
        raw = resp.read()
        ctype = resp.headers.get("Content-Type", "")
    if ctype.startswith(NPY_CONTENT_TYPE):
        return np.load(io.BytesIO(raw))
    return json.loads(raw)


def _npy(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _check_embeddings(name: str, emb: np.ndarray, n: int, dim: int) -> None:
    if emb.shape != (n, dim):
        raise AssertionError(f"{name}: shape {emb.shape}, want {(n, dim)}")
    if not np.isfinite(emb).all():
        raise AssertionError(f"{name}: non-finite values")
    norm_err = float(np.abs(np.linalg.norm(emb, axis=1) - 1.0).max())
    if norm_err > 1e-4:
        raise AssertionError(f"{name}: norms off by {norm_err}")


def _device_us(evt) -> float:
    val = getattr(evt, "self_device_time_total", None)
    return float(val if val is not None else evt.self_cuda_time_total)


PROFILE_ATTEMPTS = 3  # an empty trace is taken again (seen once in 16 runs of this script)


def profile_calls(fn, reps: int, top: int = 8) -> dict:
    """Where the time of ``reps`` calls of ``fn()`` goes, under
    ``torch.profiler``: host clock per call, device time per call summed
    over every device operation, the device operations (kernels, copies) per
    call, the device's idle share of the window, and the ``top`` operations
    that took the most device time.  A trace with no device record is taken
    again, up to ``PROFILE_ATTEMPTS`` times in all, then it fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        # device-side records only (kernels, copies); the CPU operator that
        # launched a kernel reports the same time again and is left out
        rows = [(evt.key, _device_us(evt), evt.count) for evt in prof.key_averages()
                if evt.device_type == DeviceType.CUDA
                and not evt.key.startswith("Activity Buffer")]
        rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
        if rows:
            break
        log(f"torch.profiler recorded no device time (attempt {attempt} of "
            f"{PROFILE_ATTEMPTS})")
    if not rows:
        raise AssertionError("the profiler recorded no device time")
    device_us = sum(r[1] for r in rows)
    return {
        "reps": reps,
        "host_ms_per_call": wall_s / reps * 1e3,
        "device_ms_per_call": device_us / reps / 1e3,
        "device_ops_per_call": sum(r[2] for r in rows) / reps,
        "device_idle_share": max(0.0, 1 - device_us / 1e6 / wall_s),
        "top_ops": [
            {"op": key[:80], "device_ms_per_call": us / reps / 1e3,
             "share_of_device": us / device_us, "calls_per_call": count / reps}
            for key, us, count in rows[:top]
        ],
    }


def kernel_parts(fn, parts: dict, rest: str = "", reps: int = 5) -> dict:
    """The device time and the device launches of one call of ``fn()`` by
    part, under ``torch.profiler``: ``parts`` maps a part's name to the
    kernel names (substrings) that make it up; any other device operation
    goes to the part ``rest``, or fails the run when there is none."""
    prof = profile_calls(fn, reps, top=64)
    names = list(parts) + ([rest] if rest else [])
    ms, launches = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0.0)
    for op in prof["top_ops"]:
        hits = [name for name, keys in parts.items() if any(k in op["op"] for k in keys)]
        if len(hits) > 1 or not (hits or rest):
            raise AssertionError(f"device operation {op['op']!r} belongs to parts {hits}")
        part = hits[0] if hits else rest
        ms[part] += op["device_ms_per_call"]
        launches[part] += op["calls_per_call"]
    return {"parts_ms": ms, "parts_launches": launches,
            "launches_per_call": prof["device_ops_per_call"]}


def ptxas_of(*names: str) -> dict:
    """What ``ptxas -v`` reported for the kernels whose mangled name holds one
    of ``names``, by that name (of a kernel compiled into several translation
    units, the copy with the most registers)."""
    out = {}
    for mangled, usage in _build.ptxas_usage().items():
        for name in names:
            if name in mangled and usage["registers"] >= out.get(name, usage)["registers"]:
                out[name] = usage
    if sorted(out) != sorted(names):
        raise AssertionError(f"ptxas -v reported {sorted(out)}, want {sorted(names)}")
    return out


def assert_repeats(name: str, run) -> None:
    """Two calls of ``run()`` (a tuple of tensors) give the same bits."""
    first, second = run(), run()
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(first, second)):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: output {i} differs between two calls")
    log(f"{name}: two calls give the same bits in all {len(first)} outputs")


def profile_chunk(name: str, fn, windows: np.ndarray, reps: int = 5) -> dict:
    """One full chunk through an embedder, ``reps`` times (copies included)."""
    return {"embedder": name, **profile_calls(lambda: fn(windows), reps)}


def serve_path() -> dict:
    cfg = TrainConfig()  # the flagship run's defaults
    t_win, sp_dim = cfg.window_length, cfg.speech_dimension
    t0 = time.perf_counter()
    model = build_model_from_config(cfg, bank_size=BANK_SIZE, device="cuda", seed=0)
    session = InferenceSession(model, chunk=128, device="cuda")
    dim = model.eegModel.get_output_dim(t_win)
    index = RetrievalIndex(dim, capacity=4096, device="cuda")
    service = EmbeddingService(session, index, info={
        "model_arch": cfg.model_arch, "eeg_encoder": cfg.eeg_encoder,
        "speech_encoder": cfg.speech_encoder, "window_length": t_win,
    })
    httpd = make_server(service, port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    log(f"serving the flagship model ({sum(p.numel() for p in model.parameters())} "
        f"parameters, embedding dim {dim}) at {url}, set up in "
        f"{time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    eeg = rng.standard_normal((300, t_win, 64)).astype(np.float32)
    speech = rng.standard_normal((130, t_win, sp_dim)).astype(np.float32)
    mm_eeg, cand_a, cand_b = eeg[:4], speech[:4], speech[4:8]
    npy_headers = {"Content-Type": NPY_CONTENT_TYPE, "Accept": NPY_CONTENT_TYPE}
    timings = {}
    try:
        zero_counts()
        t0 = time.perf_counter()
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        t1 = time.perf_counter()
        eeg_emb = _post(f"{url}/v1/embed/eeg?normalize=1", body=_npy(eeg),
                        headers=npy_headers)
        t2 = time.perf_counter()
        sp_emb = _post(f"{url}/v1/embed/speech", body=_npy(speech), headers=npy_headers)
        t3 = time.perf_counter()
        added = _post(f"{url}/v1/retrieval/add", {"embeddings": sp_emb.tolist()})
        top = _post(f"{url}/v1/retrieval/topk?k=5", body=_npy(eeg_emb[:16]),
                    headers={"Content-Type": NPY_CONTENT_TYPE})
        t4 = time.perf_counter()
        mm = _post(f"{url}/v1/match_mismatch", {
            "eeg": mm_eeg.tolist(), "cand_a": cand_a.tolist(), "cand_b": cand_b.tolist(),
        })
        t5 = time.perf_counter()
        torch.cuda.synchronize()
        launches = counts()
        timings = {
            "healthz_s": t1 - t0, "embed_eeg_300_s": t2 - t1,
            "embed_speech_130_s": t3 - t2, "retrieval_add_topk_s": t4 - t3,
            "match_mismatch_4_s": t5 - t4,
        }
        log(f"routes answered; host seconds per request: {json.dumps(timings)}")

        # what the routes should have launched: 300 + 4 EEG windows are 3 + 1
        # chunks of 128; 130 + 4 + 4 speech windows are 2 + 1 + 1 chunks; no
        # backward and no conv kernel (the conv blocks are unfused by default)
        want = dict.fromkeys(launches, 0)
        want.update(fused_transformer_block=10 * 4, lstm_scan_packed=2 * 4)
        if launches != want:
            raise AssertionError(f"kernel launches on the serving path {launches}, "
                                 f"want {want}")
        log(f"kernel launches on the serving path: {launches}")

        if health.get("status") != "ok" or health.get("index_capacity") != 4096:
            raise AssertionError(f"bad /healthz answer {health}")
        _check_embeddings("embed/eeg", eeg_emb, 300, dim)
        _check_embeddings("embed/speech", sp_emb, 130, dim)
        if added["ids"] != list(range(130)) or added["size"] != 130:
            raise AssertionError(f"bad /v1/retrieval/add answer: size {added['size']}")
        sims = eeg_emb[:16] @ sp_emb.T
        want_ids = np.argsort(-sims, axis=1, kind="stable")[:, :5]
        got_ids = np.asarray(top["ids"])
        got_scores = np.asarray(top["scores"])
        want_scores = np.take_along_axis(sims, want_ids, 1)
        if float(np.abs(got_scores - want_scores).max()) > 1e-4:
            raise AssertionError("top-k scores disagree with numpy")
        if not np.array_equal(got_ids, want_ids):
            # ids may differ only where scores tie to within the tolerance
            gap = np.abs(np.take_along_axis(sims, got_ids, 1) - want_scores).max()
            if gap > 1e-5:
                raise AssertionError("top-k ids disagree with numpy")

        # the same answers straight from the session (no HTTP)
        direct = session.embed_eeg(eeg, normalize=True)
        http_err = float(np.abs(direct - eeg_emb).max())
        emb_mm = session.embed_eeg(mm_eeg)
        want_dec = match_mismatch_decide(emb_mm, session.embed_speech(cand_a),
                                         session.embed_speech(cand_b))
        if mm["decisions"] != want_dec.tolist():
            raise AssertionError(f"match_mismatch {mm['decisions']} != {want_dec}")
        if http_err > 1e-5:
            raise AssertionError(f"HTTP and direct EEG embeddings differ by {http_err}")

        # 8 windows against a CPU session holding the same weights
        cpu_model = build_model_from_config(cfg, bank_size=BANK_SIZE, device="cpu", seed=0)
        cpu_session = InferenceSession(cpu_model, chunk=8, device="cpu")
        eeg_err = float(np.abs(cpu_session.embed_eeg(eeg[:8]) - session.embed_eeg(eeg[:8])).max())
        sp_err = float(np.abs(cpu_session.embed_speech(speech[:8])
                              - session.embed_speech(speech[:8])).max())
        log(f"card vs CPU session, 8 windows: eeg max_abs_err {eeg_err:.3e}, speech "
            f"{sp_err:.3e} (tol {SERVE_TOL:g})")
        if not (eeg_err <= SERVE_TOL and sp_err <= SERVE_TOL):
            raise AssertionError("card and CPU sessions disagree")

        # steady-state time of one full chunk through each embedder
        chunk_eeg, chunk_sp = eeg[:128], speech[:128]
        for _ in range(2):
            session.embed_eeg(chunk_eeg)
            session.embed_speech(chunk_sp)
        reps = {"eeg": [], "speech": []}
        for _ in range(10):
            t0 = time.perf_counter()
            session.embed_eeg(chunk_eeg)
            reps["eeg"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            session.embed_speech(chunk_sp)
            reps["speech"].append(time.perf_counter() - t0)
        chunk_ms = {k: statistics.median(v) * 1e3 for k, v in reps.items()}
        log(f"one 128-window chunk, host clock incl. copies, median of 10: "
            f"eeg {chunk_ms['eeg']:.3f} ms, speech {chunk_ms['speech']:.3f} ms")
        profiles = [profile_chunk("eeg", session.embed_eeg, chunk_eeg),
                    profile_chunk("speech", session.embed_speech, chunk_sp)]
        for p in profiles:
            log(json.dumps({"profile": p}))
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()
        thread.join(timeout=30)
    return {"launches": launches, "http_s": timings, "chunk_ms": chunk_ms,
            "cpu_err": {"eeg": eeg_err, "speech": sp_err}}


# loss.txt of a 2-epoch run, line by line: the JAX trainer's formats; in
# device mode the phases line also carries the chunk store's uploads
PHASES = {
    "host": r'\{"dispatch_s": \S+, "fetch_s": \S+, "block_s": \S+\}',
    "device": (r'\{"dispatch_s": \S+, "fetch_s": \S+, "block_s": \S+, "uploads": \d+, '
               r'"upload_gb": \S+, "upload_s": \S+, "upload_wait_s": \S+\}'),
}


def loss_lines(mode: str, profile_dir: str = "") -> list:
    """The line formats of a 2-epoch run's ``loss.txt``; with ``profile_dir``
    the profiler's line follows epoch 0's phases."""
    traced = [re.escape(f"profiler trace written to {profile_dir}")] if profile_dir else []
    return [r"number of parameters \d+", r"no model found at .*, training from scratch"] + [
        line.replace("{e}", str(e)) for e in range(2) for line in (
            r"train epoch {e} batch 0 loss_ce (\S+) loss average eeg (\S+)",
            r"epoch {e} done in \d+\.\ds \(\d+ pairs/s\)",
            r"epoch {e} phases " + PHASES[mode],
            *(traced if e == 0 else []),
            r"validation epoch {e}: mean loss ce : (\S+), mean loss average: (\S+), "
            r"mean loss total: (\S+)",
        )] + [r"training done: best val loss_ce \S+ at epoch \d"]


# what the evaluation suite writes into a run's results directory (the JAX
# package's run_eval_suite); the last has entries only for challenge subjects
# with a probe of their own, which the fixture's challenge subjects lack
MM_JSONS = ("evaluation_challenge_set_2023_mm.json",
            "evaluation_challenge_set_2023_mm_logits.json",
            "evaluation_challenge_set_2023_mm_top_x.json",
            "evaluation_challenge_set_2023_mm_top_x_logits.json")
EVAL_JSONS = MM_JSONS + ("evaluation_regression.json",
                         "evaluation_regression_general_model_env.json",
                         "evaluation_challenge_set_2023_regression.json",
                         "evaluation_challenge_set_2023_regression_sub_specific.json")
HOST_DEVICE_TOL = 1e-5  # relative, every loss in loss.txt of the two data paths
COUNTERS = (fused_transformer_block, fused_block_backward, lstm_scan_packed,
            lstm_scan_backward, fused_basic_block, fused_conv_backward, conv1d_same)


def set_fused(model, on: bool = True) -> int:
    """``fused`` on every BasicBlock of ``model``; returns how many take the
    fused path (those that are square and undilated, when ``on``)."""
    n = 0
    for m in model.modules():
        if isinstance(m, BasicBlock):
            m.fused = on
            n += m.takes_fused_path
    return n


def step_grads(cfg, host_batch, dev: str, dtype=torch.float32, fused: bool = False,
               augmentations=(), add_eeg: bool = False, compute_dtype=None) -> dict:
    """One training step's forward and gradients at batch 8, dropout on, on
    ``dev`` in ``dtype``: weights from seed 0, the step seed's masks; with
    ``add_eeg`` the EEG mixed with rows 8-15 of the batch and with
    ``augmentations`` augmented, at p=0.5, from the train step's streams of
    the step seed; then, with ``compute_dtype``, the EEG and speech cast to
    it as the train step casts them.  The losses (named as the trainer names
    them), every gradient and every buffer after the step (the memory bank
    after its EMA update, the batch norms' running statistics), on the CPU."""
    model = build_model(cfg, cfg.bank_size, device=dev, seed=0).to(dtype).train()
    set_fused(model, fused)
    step_seed = fold_seed(99, 0)
    set_dropout_seeds(model, step_seed)
    batch = [torch.from_numpy(host_batch[k][:8]).to(dev) for k in ("eeg", "speech", "ids")]
    batch[:2] = [x.to(dtype) for x in batch[:2]]
    if add_eeg:
        partner = torch.from_numpy(host_batch["eeg"][8:16]).to(dev).to(dtype)
        batch[0] = _apply_mixup(fold_seed(step_seed, MIXUP_STREAM), batch[0], partner, 0.5)
    if augmentations:
        batch[0] = make_augmentation_fn(augmentations, 0.5)(
            fold_seed(step_seed, AUGMENT_STREAM), batch[0])
    if compute_dtype is not None:
        batch[:2] = [x.to(compute_dtype) for x in batch[:2]]
    losses = split_outputs(cfg.model_arch, model(*batch))
    if losses["loss_ce"].dtype != dtype:
        raise AssertionError(f"loss_ce is {losses['loss_ce'].dtype}, the parameters {dtype}")
    params = list(model.parameters())
    grads = torch.autograd.grad(losses["loss_total"], params, allow_unused=True)
    return {
        "losses": {k: float(v.detach()) for k, v in losses.items()},
        "grads": [(torch.zeros_like(p) if g is None else g).detach().cpu().double()
                  for g, p in zip(grads, params)],
        "names": [n for n, _ in model.named_parameters()],
        "buffers": {n: b.detach().cpu().double() for n, b in model.named_buffers()},
    }


def step_errors(got: dict, want: dict) -> dict:
    """``got`` against ``want`` (two ``step_grads``): the losses relative to
    max(1, |want|); each gradient relative to its own largest value, the
    floor only keeping a leaf that is zero in exact arithmetic (each block's
    key bias) finite; the bank's rows (in [0, 1]) absolutely and the running
    statistics relative to max(1, their largest value)."""
    loss_err = max(abs(got["losses"][k] - v) / max(1.0, abs(v)) for k, v in want["losses"].items())
    top = max(float(g.abs().max()) for g in want["grads"])
    grad_errs = {n: float((a - b).abs().max()) / max(float(b.abs().max()), STEP_GRAD_FLOOR * top)
                 for n, a, b in zip(want["names"], got["grads"], want["grads"])}
    buffer_errs = {n: float((got["buffers"][n] - b).abs().max()) / max(1.0, float(b.abs().max()))
                   for n, b in want["buffers"].items()}
    stats = [v for n, v in buffer_errs.items() if n.endswith(("running_mean", "running_var"))]
    return {"loss_err": loss_err, "grad_err": max(grad_errs.values()),
            "bank_err": buffer_errs.get("eegMemoryBank.memory", 0.0),
            "batch_stats_err": max(stats, default=0.0), "buffer_errs": buffer_errs,
            "grad_floor": STEP_GRAD_FLOOR * top, "grad_err_by_leaf": grad_errs}


def card_vs_cpu_step(cfg, host_batch, fused: bool = False, name: str = "",
                     dtype=torch.float32, augmentations=(), add_eeg: bool = False,
                     ref_dtype=None) -> dict:
    """One training step at batch 8, dropout on, on the card in ``dtype`` and
    on the CPU in ``ref_dtype`` (default ``dtype``): same weights (seed 0),
    same batch, same step seed, so the same masks.  The losses, every
    gradient, the bank's rows and the running statistics must agree within
    ``STEP_TOL`` (``step_errors``).  ``fused`` sets ``fused`` on the
    BasicBlocks of both models; ``augmentations`` and ``add_eeg`` mix and
    augment the batch on each device (``step_grads``).  Against another
    ``ref_dtype`` the CPU's own step in ``dtype`` is held to nothing but
    reported beside (``cpu_spread``): how far ``dtype`` itself is from it."""
    ref_dtype = ref_dtype or dtype
    gpu, cpu = (step_grads(cfg, host_batch, dev, dt, fused, augmentations, add_eeg)
                for dev, dt in (("cuda", dtype), ("cpu", ref_dtype)))
    errs = step_errors(gpu, cpu)
    spread = {}
    if ref_dtype != dtype:
        own = step_errors(step_grads(cfg, host_batch, "cpu", dtype, fused, augmentations,
                                     add_eeg), cpu)
        spread = {"cpu_spread": {"grad_err": own["grad_err"], "loss_err": own["loss_err"],
                                 "worst_leaf": max(own["grad_err_by_leaf"],
                                                   key=own["grad_err_by_leaf"].get)}}
    worst = sorted(errs["grad_err_by_leaf"].items(), key=lambda kv: -kv[1])[:6]
    n_norms = sum(n.endswith("running_var") for n in errs["buffer_errs"])
    log(f"one train step at batch 8, dropout on{', conv blocks fused' if fused else ''}"
        f"{', ' + name if name else ''}{', float64' if dtype == torch.float64 else ''}, "
        f"card vs CPU{f' ({ref_dtype})' if ref_dtype != dtype else ''}: losses "
        f"{gpu['losses']} vs {cpu['losses']} (err {errs['loss_err']:.2e}); "
        f"worst gradient error {errs['grad_err']:.2e} (max abs error over max(leaf max, "
        f"{STEP_GRAD_FLOOR:g} x largest gradient)) over {len(errs['grad_err_by_leaf'])} "
        f"leaves, worst {[(n, f'{v:.1e}') for n, v in worst]}; bank rows {errs['bank_err']:.2e}; "
        f"running statistics of {n_norms} batch norms {errs['batch_stats_err']:.2e} "
        f"(tol {STEP_TOL:g}){'; ' + json.dumps(spread) if spread else ''}")
    if not max(errs["loss_err"], errs["grad_err"],
               max(errs["buffer_errs"].values(), default=0.0)) <= STEP_TOL:
        raise AssertionError("the card's train step disagrees with the CPU's")
    return {**errs, **spread, "dtype": str(dtype), "reference": f"cpu {ref_dtype}",
            "n_grads": len(gpu["grads"]),
            "losses_card": gpu["losses"], "losses_cpu": cpu["losses"]}


def counts() -> dict:
    """The launches of #1-#7 by wrapper (a wrapper's count holds its bf16
    instantiation's too), read through ``tools.kernel_launches``."""
    return {k: v for k, v in kernel_launches().items() if not k.endswith("_bf16")}


# the wrappers that count their bf16 instantiation's launches apart too
BF16_COUNTERS = (fused_transformer_block, fused_block_backward)


def bf16_counts() -> dict:
    """The launches of #1/#2's bf16 instantiations, by wrapper."""
    return {k[:-len("_bf16")]: v for k, v in kernel_launches().items() if k.endswith("_bf16")}


def zero_counts() -> None:
    for f in COUNTERS:
        f.launches = 0
    for f in BF16_COUNTERS:
        f.launches_bf16 = 0


def read_loss_txt(path: str, mode: str, profile_dir: str = ""):
    """The losses of a 2-epoch run's ``loss.txt`` (every line in the JAX
    trainer's format for ``mode``, every loss finite) and its phases records."""
    lines, fmts = open(path).read().splitlines(), loss_lines(mode, profile_dir)
    if len(lines) != len(fmts):
        raise AssertionError(f"{path}: {len(lines)} lines, want {len(fmts)}: {lines}")
    values, phases = [], []
    for line, fmt in zip(lines, fmts):
        m = re.fullmatch(fmt, line)
        if m is None:
            raise AssertionError(f"loss.txt line {line!r} does not match {fmt!r}")
        values += [float(v) for v in m.groups()]
        if " phases " in line:
            phases.append(json.loads(line.split(" phases ", 1)[1]))
    if not all(np.isfinite(values)):
        raise AssertionError(f"{path}: losses {values}")
    return values, phases


def _numbers(obj) -> list:
    """Every number in a JSON tree."""
    if isinstance(obj, dict):
        return [v for x in obj.values() for v in _numbers(x)]
    if isinstance(obj, list):
        return [v for x in obj for v in _numbers(x)]
    return [float(obj)] if isinstance(obj, (int, float)) else []


def check_eval_files(results_dir: str) -> dict:
    """Each file of ``EVAL_JSONS`` exists, and every number in it is finite;
    all but the challenge's sub-specific file have entries.  Returns the
    count of numbers per file."""
    out = {}
    for name in EVAL_JSONS:
        with open(os.path.join(results_dir, name)) as f:
            obj = json.load(f)
        nums = _numbers(obj)
        if not all(np.isfinite(nums)) or (not obj and not name.endswith("_sub_specific.json")):
            raise AssertionError(f"{name}: {str(obj)[:300]}")
        out[name] = len(nums)
    if os.path.exists(os.path.join(results_dir, "error_regression.txt")):
        raise AssertionError("error_regression.txt written: the batched probe trainer failed")
    return out


@contextlib.contextmanager
def instrumented():
    """``Trainer.fit``, ``Trainer.release_host_data`` and
    ``cli.run_eval_suite`` wrapped for the runs inside: yields ``seen``, which
    collects each trainer, the counts of training's kernel launches (read
    where training ends, at ``release_host_data``), the chunks, steps and
    resident bytes of the stores then, the device memory that call gave
    back, and per evaluation suite its wall time, kernel launches and
    encoder calls."""
    seen: dict = {"trainers": [], "eval": []}
    real = (Trainer.fit, Trainer.release_host_data, cli.run_eval_suite)

    def fit(self):
        seen["trainers"].append(self)
        return real[0](self)

    def release_host_data(self):
        # training's launches end here; what the stores hold goes next
        torch.cuda.synchronize()
        seen["train_launches"] = counts()
        seen["train_launches_bf16"] = bf16_counts()
        seen["chunks"] = [sum("eeg" in c for c in ds.chunks.values())
                          for ds in (self.train_dataset, self.val_dataset)]
        seen["steps"] = steps_per_epoch(self)
        seen["resident_bytes"] = sum(s._resident_bytes
                                     for s in (self.chunk_store, self.val_chunk_store))
        before = torch.cuda.memory_allocated()
        real[1](self)
        torch.cuda.synchronize()
        seen["memory_allocated"] = (before, torch.cuda.memory_allocated())

    def run_eval_suite(model, *args, **kw):
        zero_counts()
        calls = {"eeg": 0, "speech": 0}

        def hook(name):
            return lambda *_: calls.__setitem__(name, calls[name] + 1)

        hooks = [model.eegModel.register_forward_pre_hook(hook("eeg")),
                 model.speechModel.register_forward_pre_hook(hook("speech"))]
        t0 = time.perf_counter()
        try:
            real[2](model, *args, **kw)
            torch.cuda.synchronize()
        finally:
            for h in hooks:
                h.remove()
        seen["eval"].append({"wall_s": time.perf_counter() - t0, "launches": counts(),
                             "launches_bf16": bf16_counts(), "encoder_calls": calls})

    Trainer.fit, Trainer.release_host_data, cli.run_eval_suite = (
        fit, release_host_data, run_eval_suite)
    try:
        yield seen
    finally:
        Trainer.fit, Trainer.release_host_data, cli.run_eval_suite = real


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms inside (several times slower at the
    flagship's convolutions, so no timed run uses them).  The two data
    paths are held to each other loss for loss (``HOST_DEVICE_TOL``); with
    cuDNN's default algorithms a convolution's backward may sum in another
    order in each run, and 24 AdamW steps amplify that past the limit on
    some cards."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def steps_per_epoch(trainer) -> list:
    """Train and validation steps of one epoch: a step per subject row of
    each chunk."""
    return [sum(c["eeg"].shape[0] for c in ds.chunks.values() if "eeg" in c)
            for ds in (trainer.train_dataset, trainer.val_dataset)]


def two_epoch_launches(n_train: int, n_val: int) -> dict:
    """The flagship's kernel launches in 2 epochs of ``n_train`` train and
    ``n_val`` validation steps: 10 block forwards and 2 LSTM forwards a step,
    10 block backwards and 2 LSTM backwards a train step, no conv kernel."""
    return {"fused_transformer_block": 2 * 10 * (n_train + n_val),
            "fused_block_backward": 2 * 10 * n_train,
            "lstm_scan_packed": 2 * 2 * (n_train + n_val),
            "lstm_scan_backward": 2 * 2 * n_train,
            "fused_basic_block": 0, "fused_conv_backward": 0, "conv1d_same": 0}


def suite_launches(calls: dict) -> dict:
    """The flagship's kernel launches in an evaluation suite of ``calls``
    encoder calls: 10 block forwards an EEG call, 2 LSTM forwards a speech
    call, nothing else."""
    out = dict.fromkeys(two_epoch_launches(0, 0), 0)
    out.update(fused_transformer_block=10 * calls["eeg"], lstm_scan_packed=2 * calls["speech"])
    return out


def write_fixture() -> str:
    """The synthetic SparrKULee fixture the training phases share, under
    ``RUN_DIR`` (which ``main`` deletes at the end)."""
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    data_dir = os.path.join(RUN_DIR, "data")
    t0 = time.perf_counter()
    # 6 stories: the default --run 4 validates on fold 4, which the fixture's
    # round robin over stories[:-1] fills only from 5 stories on; 400 s per
    # story is one chunk of 133 windows at batch 128.  The fixture also
    # writes the icassp/ tree the evaluation suite reads, and wav2vec-19,
    # mel and envelope features for every story
    make_fixture(data_dir, n_stories=6, n_subjects=3, story_seconds=400, speech_dim=1024)
    log(f"fixture written in {time.perf_counter() - t0:.1f} s")
    return data_dir


def train_path(data_dir: str) -> dict:
    """The reference's default run on the card through the port's CLI
    (``cli.main``): train on the device-resident chunk store, keep the best
    checkpoint, run the evaluation suite; the same training on the host
    path, and both paths again on cuDNN's deterministic algorithms, their
    losses held to each other; then ``--only_evaluate yes`` on the first
    run's results."""
    with instrumented() as seen:
        # 1. the default command line: training, then the evaluation suite
        zero_counts()
        t0 = time.perf_counter()
        if cli.main(["--data_dir", data_dir, "--epochs", "2", "--results_folder",
                     os.path.join(RUN_DIR, "device")], device="cuda") != 0:
            raise AssertionError("the default run returned non-zero")
        default_s = time.perf_counter() - t0
        dev = seen["trainers"][-1]
        cfg, history = dev.cfg, dev.history
        if not (cfg.data_mode == "auto" and dev.device_data
                and isinstance(dev.chunk_store, DeviceChunkStore)):
            raise AssertionError("--data_mode auto did not resolve to the device store on CUDA")
        n_train, n_val = seen["steps"]
        want = two_epoch_launches(n_train, n_val)
        train_launches = seen["train_launches"]
        log(f"default run: trained 2 epochs ({n_train} train and {n_val} validation steps "
            f"each, {seen['chunks']} train and validation chunks) on the device store; "
            f"training's kernel launches {train_launches}")
        if train_launches != want or [len(h["step_s"]) for h in history] != [n_train] * 2:
            raise AssertionError(f"launches in training {train_launches}, want {want}")
        suite = seen["eval"][-1]
        calls = suite["encoder_calls"]
        want_eval = dict.fromkeys(want, 0)
        want_eval.update(fused_transformer_block=10 * calls["eeg"],
                         lstm_scan_packed=2 * calls["speech"])
        log(f"evaluation suite in {suite['wall_s']:.1f} s: {calls} encoder calls, kernel "
            f"launches {suite['launches']}")
        if suite["launches"] != want_eval or not (calls["eeg"] and calls["speech"]):
            raise AssertionError(f"launches in the evaluation suite {suite['launches']}, "
                                 f"want {want_eval}")
        launches = {k: train_launches[k] + suite["launches"][k] for k in want}

        dev_values, phases = read_loss_txt(dev.loss_file, "device")
        uploads = [p["uploads"] for p in phases]
        if uploads != [seen["chunks"][0], 0]:
            raise AssertionError(f"uploads per epoch {uploads}: want every train chunk once "
                                 f"in epoch 0 ({seen['chunks'][0]}) and none in epoch 1")
        before, after = seen["memory_allocated"]
        if not before - after >= seen["resident_bytes"] > 0:
            raise AssertionError(f"memory_allocated {before} -> {after} after "
                                 f"release_device_data; the stores held "
                                 f"{seen['resident_bytes']} bytes")
        eval_files = check_eval_files(dev.results_dir)
        log(f"loss.txt in the device-mode format, losses finite; phases {phases}; "
            f"release_host_data freed {(before - after) / 2**20:.1f} MiB of device memory "
            f"(the stores held {seen['resident_bytes'] / 2**20:.1f} MiB); evaluation "
            f"files {eval_files}, no error_regression.txt")
        ckpt_dir = dev.checkpoint_dir
        for name in ("model_ckpt.pt", "best_meta.json"):
            if not os.path.exists(os.path.join(ckpt_dir, name)):
                raise AssertionError(f"no {name} in {ckpt_dir}")
        bank0 = build_model(cfg, cfg.bank_size, device="cpu", seed=cfg.seed).eegMemoryBank.memory
        moved = int((dev.model.eegMemoryBank.memory.cpu() != bank0).any(dim=1).sum())
        if moved == 0:
            raise AssertionError("training left the memory bank as it was")

        # 2. the same training on the host path, same seed
        zero_counts()
        if cli.main(["--data_dir", data_dir, "--epochs", "2", "--data_mode", "host",
                     "--skip_eval", "yes", "--results_folder", os.path.join(RUN_DIR, "host")],
                    device="cuda") != 0:
            raise AssertionError("the host-mode run returned non-zero")
        host = seen["trainers"][-1]
        if host.device_data or counts() != want:
            raise AssertionError(f"host mode: device_data {host.device_data}, launches "
                                 f"{counts()}, want {want}")
        host_values, _ = read_loss_txt(host.loss_file, "host")

        # the two data paths against each other, loss for loss: the same
        # training in each mode again, both on cuDNN's deterministic
        # algorithms, so that only the batches could make them differ
        paired = {}
        with deterministic_cudnn():
            for mode in ("device", "host"):
                if cli.main(["--data_dir", data_dir, "--epochs", "2", "--data_mode", mode,
                             "--skip_eval", "yes", "--results_folder",
                             os.path.join(RUN_DIR, f"paired_{mode}")], device="cuda") != 0:
                    raise AssertionError(f"the paired {mode}-mode run returned non-zero")
                paired[mode], _ = read_loss_txt(seen["trainers"][-1].loss_file, mode)

        def rel(a, b):
            return max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b))

        loss_rel, timed_rel = rel(paired["device"], paired["host"]), rel(dev_values, host_values)
        log(f"device vs host data path, {len(paired['device'])} losses of loss.txt, both on "
            f"cuDNN's deterministic algorithms: max relative difference {loss_rel:.3e} (tol "
            f"{HOST_DEVICE_TOL:g}); the timed runs above differ by {timed_rel:.3e}")
        if not loss_rel <= HOST_DEVICE_TOL:
            raise AssertionError(f"losses differ: device {paired['device']}, host "
                                 f"{paired['host']}")

        # 3. --only_evaluate yes on the default run's results
        mm = {}
        for name in MM_JSONS:
            with open(os.path.join(dev.results_dir, name)) as f:
                mm[name] = json.load(f)
        if cli.main(["--only_evaluate", "yes", "--results_folder", dev.results_dir],
                    device="cuda") != 0:
            raise AssertionError("--only_evaluate returned non-zero")
        for name in MM_JSONS:
            with open(os.path.join(dev.results_dir, name)) as f:
                if json.load(f) != mm[name]:
                    raise AssertionError(f"--only_evaluate rewrote {name} with other values")
        check_eval_files(dev.results_dir)
        log(f"--only_evaluate yes: evaluation suite again in {seen['eval'][-1]['wall_s']:.1f} "
            f"s, the match-mismatch files identical")

        # serve what was trained
        rng = np.random.default_rng(4)
        eeg = rng.standard_normal((8, cfg.window_length, 64)).astype(np.float32)
        speech = rng.standard_normal((8, cfg.window_length, 1024)).astype(np.float32)
        served = InferenceSession.from_results_dir(dev.results_dir, device="cuda")
        live = InferenceSession(dev.model, device="cuda")
        serve_err = max(float(np.abs(served.embed_eeg(eeg) - live.embed_eeg(eeg)).max()),
                        float(np.abs(served.embed_speech(speech) - live.embed_speech(speech)).max()))
        log(f"from_results_dir vs the trainer's model, 8 windows: max_abs_err {serve_err:.2e}")
        if not serve_err <= 1e-5:
            raise AssertionError("the served checkpoint is not the trained model")

        host_batch = next(batch_iterator(host.train_dataset))
        step = card_vs_cpu_step(cfg, host_batch)

        # step time: epoch 2's steps, host clock (the last closed by the drain)
        step_ms = {name: statistics.median(t.history[1]["step_s"]) * 1e3
                   for name, t in (("device", dev), ("host", host))}
        log(f"epoch-2 median train step, host clock: device store {step_ms['device']:.2f} ms, "
            f"host path {step_ms['host']:.2f} ms")
        # where a device-mode step's time goes: a resident chunk, one batch's
        # index vectors on the card, the gather and the step
        ds = host.train_dataset
        store = DeviceChunkStore(ds, device="cuda", prefetch=False)
        key = next(k for k in ds.batches_keys if "eeg" in ds.chunks[k])
        eeg_c, sp_c, ids_c, _, _ = store.get(key)
        idx_m, subs_m = ds.create_eeg_indices(ds.chunks[key]["eeg"])
        idx, subs = (torch.from_numpy(np.asarray(m[0], np.int64)).to("cuda")
                     for m in (idx_m, subs_m))
        run_step = lambda: chunk_train_step(host.model, host.optimizer, eeg_c,  # noqa: E731
                                            sp_c, ids_c, idx, subs, cfg.seed + 1, False)
        run_step()
        profile = profile_calls(run_step, reps=3)
        gather = gather_batch(eeg_c, sp_c, ids_c, idx, subs)
        gather_bytes = 2 * sum(v.numel() * v.element_size() for v in gather.values())
        gather_ms = time_ms(lambda: gather_batch(eeg_c, sp_c, ids_c, idx, subs))
        log(f"gather of one batch: {gather_ms:.4f} ms for {gather_bytes / 1e6:.1f} MB read "
            f"and written (bound {gather_bytes / PEAK_BYTES * 1e3:.4f} ms)")
        store.release()
        train = {
            "config": "TrainConfig() defaults at full width, --epochs 2", "batch": cfg.batch_size,
            "train_steps_per_epoch": n_train, "val_steps_per_epoch": n_val,
            "chunks_train_val": seen["chunks"],
            "default_run_s": default_s, "eval_suite_s": suite["wall_s"],
            "only_evaluate_s": seen["eval"][-1]["wall_s"],
            "step_ms_median_epoch2": step_ms,
            "step_ms_all_epoch2": {name: [v * 1e3 for v in t.history[1]["step_s"]]
                                   for name, t in (("device", dev), ("host", host))},
            "epoch_s": {name: [h["epoch_time_s"] for h in t.history]
                        for name, t in (("device", dev), ("host", host))},
            "phases_device": phases,
            "val_loss_ce": [h["val_loss_ce"] for h in history],
            "host_vs_device_loss_rel": loss_rel, "host_vs_device_loss_rel_timed": timed_rel,
            "launches": launches, "launches_train": train_launches,
            "launches_eval": suite["launches"], "eval_encoder_calls": calls,
            "eval_files": eval_files,
            "memory_allocated_release": seen["memory_allocated"],
            "card_vs_cpu_step": step, "serve_err": serve_err, "results_dir": dev.results_dir,
            "gather_ms": gather_ms, "gather_bytes": gather_bytes,
            "profile_3_device_steps": profile,
        }
        log(json.dumps({"train": train}))
        return train, cfg, host_batch


# the model zoo's configurations (PERF.md §4): every encoder and head of the
# JAX registry at full width, each on the kernels the table there puts it on
ZOO = {
    "Z1": dict(eeg_encoder="conformer", speech_encoder="convLSTM", model_arch="clip_sim"),
    "Z2": dict(eeg_encoder="convLSTM", speech_encoder="smallConv", model_arch="clip_mp"),
    "Z3": dict(eeg_encoder="convLSTMnew", speech_encoder="convLSTM", model_arch="clip_kld"),
    "Z4": dict(eeg_encoder="lstm", speech_encoder="lstm", stimulus_features="mel",
               model_arch="no_contrastive_learning"),
    "Z5": dict(eeg_encoder="double_lstm", speech_encoder="double_lstm",
               model_arch="clip_kld_latent_proj"),
    "Z6": dict(eeg_encoder="vlaai", speech_encoder="Wav2vecSmallModel", model_arch="clip_sim"),
}
# launches per train step of kernels #1 (block forward), #2 (its backward),
# #3 (LSTM forward: one per LSTM layer, both directions packed) and #4; a
# validation step launches the forwards alone
ZOO_STEP_LAUNCHES = {
    "Z1": (10, 10, 2, 2),  # conformer: one depth-10 stack; convLSTM: two biLSTMs
    "Z2": (0, 0, 2, 2),    # convLSTM EEG encoder; smallConv has no recurrence
    "Z3": (0, 0, 3, 3),    # convLSTMnew: one biLSTM (H=4); convLSTM: two
    "Z4": (0, 0, 1, 1),    # lstm speech (MelModel): one LSTM, D=1, H=128
    "Z5": (0, 0, 4, 4),    # double_lstm both sides: two LSTMs each, D=1, H=128
    "Z6": (0, 0, 0, 0),    # VLAAI and Wav2vecSmallModel reach no kernel
}
KERNEL_NAMES = ("fused_transformer_block", "fused_block_backward", "lstm_scan_packed",
                "lstm_scan_backward")
# Z6 reaches no float32-only kernel, and its full-width gradient is too
# ill-conditioned in float32 for the step limit to mean anything there: the
# CPU's own float32 gradient is as far from its float64 one as the card's.
# Its card-vs-CPU step is held to STEP_TOL in float64, and the float32
# spread (card and CPU against the CPU's float64) is reported beside it
ZOO_STEP_DTYPE = {"Z6": torch.float64}


def float32_spread(cfg, batch, ref_dtype) -> dict:
    """The float32 step on the card and on the CPU, each against the CPU's
    step in ``ref_dtype``, and against each other: the worst gradient and
    loss errors, reported (not held to a limit)."""
    ref = step_grads(cfg, batch, "cpu", ref_dtype)
    card, cpu = (step_grads(cfg, batch, dev) for dev in ("cuda", "cpu"))
    out = {}
    for what, got, want in (("card_vs_reference", card, ref), ("cpu_vs_reference", cpu, ref),
                            ("card_vs_cpu", card, cpu)):
        e = step_errors(got, want)
        out[what] = {"grad_err": e["grad_err"], "loss_err": e["loss_err"],
                     "worst_leaf": max(e["grad_err_by_leaf"], key=e["grad_err_by_leaf"].get)}
    log(f"  float32 spread of that step (worst gradient error, against the CPU in {ref_dtype}): "
        f"{json.dumps(out)}")
    return out


def zoo_launches(z: str, n_train: int, n_val: int) -> dict:
    """The exact kernel launches of one epoch of ``z``."""
    return step_launches(ZOO_STEP_LAUNCHES[z], n_train, n_val)


def step_launches(per_train_step, n_train: int, n_val: int) -> dict:
    """The exact kernel launches of ``n_train`` train and ``n_val``
    validation steps, from #1-#4's launches per train step (a validation
    step launches the forwards alone)."""
    fwd, bwd, lstm_fwd, lstm_bwd = per_train_step
    want = dict.fromkeys(counts(), 0)
    want.update(fused_transformer_block=fwd * (n_train + n_val),
                fused_block_backward=bwd * n_train,
                lstm_scan_packed=lstm_fwd * (n_train + n_val),
                lstm_scan_backward=lstm_bwd * n_train)
    return want


def zoo_path(data_dir: str) -> dict:
    """Each zoo configuration at full width (batch 128, T=192, depth 10,
    latent 8, --lstm_units 128): (a) one train step at batch 8, dropout on,
    card against CPU (losses, every gradient, bank rows, running
    statistics); (b) ``cli.main`` on the fixture on the card with the device
    store, ``--epochs 1 --skip_eval yes`` (Z1: the whole default run, eval
    suite included), with the exact launches of kernels #1-#4 and the
    median step time; (c) the Z3 run (a head without a bank) served by
    ``from_results_dir``, one 128-window chunk card against CPU."""
    t_start = time.perf_counter()
    out = {}
    rng = np.random.default_rng(7)
    with instrumented() as seen:
        for z, flags in ZOO.items():
            cfg = TrainConfig(**flags, bank_size=BANK_SIZE)
            t = cfg.window_length
            batch = {"eeg": rng.standard_normal((8, t, 64)).astype(np.float32),
                     "speech": rng.standard_normal((8, t, cfg.speech_dimension)).astype(
                         np.float32),
                     "ids": np.arange(1, 9, dtype=np.int64)}
            dtype = ZOO_STEP_DTYPE.get(z, torch.float32)
            step = card_vs_cpu_step(cfg, batch, name=f"{z} {flags}", dtype=dtype)
            del step["grad_err_by_leaf"]  # the log line names the worst leaves
            if dtype != torch.float32:
                step["float32_spread"] = float32_spread(cfg, batch, dtype)

            argv = ["--data_dir", data_dir, "--epochs", "1", "--results_folder",
                    os.path.join(RUN_DIR, "zoo", z)]
            for k, v in flags.items():
                argv += [f"--{k}", v]
            if z != "Z1":
                argv += ["--skip_eval", "yes"]
            zero_counts()
            t0 = time.perf_counter()
            if cli.main(argv, device="cuda") != 0:
                raise AssertionError(f"{z}: cli.main returned non-zero")
            run_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            trainer = seen["trainers"][-1]
            if not trainer.device_data:
                raise AssertionError(f"{z}: the run did not take the device store")
            if z == "Z1":
                n_train, n_val = seen["steps"]
                launches, suite = seen["train_launches"], seen["eval"][-1]
                calls = suite["encoder_calls"]
                want_eval = dict.fromkeys(launches, 0)
                want_eval.update(fused_transformer_block=10 * calls["eeg"],
                                 lstm_scan_packed=2 * calls["speech"])
                eval_files = check_eval_files(trainer.results_dir)
                log(f"{z}: evaluation suite in {suite['wall_s']:.1f} s, {calls} encoder "
                    f"calls, kernel launches {suite['launches']}; evaluation files finite")
                if suite["launches"] != want_eval or not (calls["eeg"] and calls["speech"]):
                    raise AssertionError(f"{z}: launches in the evaluation suite "
                                         f"{suite['launches']}, want {want_eval}")
            else:
                n_train, n_val = steps_per_epoch(trainer)
                launches, suite, eval_files = counts(), None, None
            want = zoo_launches(z, n_train, n_val)
            step_s = trainer.history[0]["step_s"]
            if launches != want or len(step_s) != n_train:
                raise AssertionError(f"{z}: launches in training {launches}, want {want} "
                                     f"({n_train} train and {n_val} validation steps)")
            # a validation step launches the forwards alone
            val_fwd = zoo_launches(z, 0, 1)
            per_step = {k: (launches[k] - val_fwd[k] * n_val) / n_train for k in KERNEL_NAMES}
            val = trainer.history[0]["val_loss_ce"]
            if not np.isfinite(val):
                raise AssertionError(f"{z}: validation loss_ce {val}")
            step_ms = statistics.median(step_s) * 1e3
            log(f"{z} {flags}: cli.main in {run_s:.1f} s, {n_train} train and {n_val} "
                f"validation steps on the device store, median train step {step_ms:.2f} ms "
                f"(epoch 1, host clock), kernel launches {launches}, per train step {per_step}; "
                f"validation loss_ce {val:.4f}")
            out[z] = {"flags": flags, "card_vs_cpu_step": step, "cli_s": run_s,
                      "train_steps": n_train, "val_steps": n_val, "launches": launches,
                      "launches_per_train_step": per_step, "step_ms_median": step_ms,
                      "step_ms_all": [v * 1e3 for v in step_s], "val_loss_ce": val,
                      "eval_suite_s": suite and suite["wall_s"], "eval_files": eval_files,
                      "results_dir": trainer.results_dir}
            if z != "Z1":  # the default run released its data before the suite
                trainer.release_host_data()

    # (c) a head without a memory bank, served from its results directory
    results_dir = out["Z3"]["results_dir"]
    cfg = TrainConfig.load(os.path.join(results_dir, "args.txt"))
    eeg = rng.standard_normal((128, cfg.window_length, 64)).astype(np.float32)
    speech = rng.standard_normal((128, cfg.window_length, cfg.speech_dimension)).astype(
        np.float32)
    sessions = {dev: InferenceSession.from_results_dir(results_dir, device=dev)
                for dev in ("cuda", "cpu")}
    if hasattr(sessions["cuda"].model, "eegMemoryBank"):
        raise AssertionError("the clip_kld head holds a memory bank")
    zero_counts()
    emb = {dev: (s.embed_eeg(eeg), s.embed_speech(speech)) for dev, s in sessions.items()}
    served_launches = counts()
    errs = {name: float(np.abs(emb["cuda"][i] - emb["cpu"][i]).max())
            for i, name in enumerate(("eeg", "speech"))}
    want = dict.fromkeys(served_launches, 0)
    want["lstm_scan_packed"] = 3  # convLSTMnew's biLSTM, convLSTM's two
    log(f"Z3 (clip_kld, no bank, bank_size {cfg.bank_size} from args.txt) served by "
        f"from_results_dir, one 128-window chunk, card vs CPU: max_abs_err {errs} (tol "
        f"{SERVE_TOL:g}); launches {served_launches}")
    if not max(errs.values()) <= SERVE_TOL or served_launches != want:
        raise AssertionError(f"Z3 serving: errors {errs}, launches {served_launches}, "
                             f"want {want}")
    del sessions
    for z in out:
        del out[z]["results_dir"]
    out["Z3"]["served_err"] = errs
    out["Z3"]["served_launches"] = served_launches
    zoo_s = time.perf_counter() - t_start
    log(f"zoo phase: {zoo_s:.1f} s")
    out["seconds"] = zoo_s
    log(json.dumps({"zoo": out}))
    return out


def fused_path(cfg, host_batch) -> dict:
    """The flagship with its 11 square BasicBlocks fused: embeddings against
    the unfused model and a CPU copy, one step card vs CPU, the exact
    launches per chunk and per step, and the step time fused and unfused."""
    rng = np.random.default_rng(5)
    eeg = rng.standard_normal((128, cfg.window_length, 64)).astype(np.float32)
    speech = rng.standard_normal((128, cfg.window_length, cfg.speech_dimension)
                                 ).astype(np.float32)
    models = {}
    for name, dev, fused in (("fused", "cuda", True), ("unfused", "cuda", False),
                             ("cpu", "cpu", True)):
        models[name] = build_model(cfg, cfg.bank_size, device=dev, seed=0)
        n = set_fused(models[name], fused)
        if n != (N_FUSED_BLOCKS if fused else 0):
            raise AssertionError(f"{name}: {n} BasicBlocks take the fused path")
    sessions = {name: InferenceSession(m, chunk=8 if name == "cpu" else 128,
                                       device="cpu" if name == "cpu" else "cuda")
                for name, m in models.items()}
    emb = {name: (sess.embed_eeg(eeg[:8]), sess.embed_speech(speech[:8]))
           for name, sess in sessions.items()}
    emb_err = {f"{other}_{i}": float(np.abs(emb["fused"][j] - emb[other][j]).max())
               for other in ("unfused", "cpu") for j, i in enumerate(("eeg", "speech"))}
    log(f"fused conv blocks, 8 windows: card fused vs card unfused and vs CPU fused, "
        f"max_abs_err {emb_err} (tol {SERVE_TOL:g})")
    if not max(emb_err.values()) <= SERVE_TOL:
        raise AssertionError("the fused model's embeddings disagree")

    launches = {}
    for what, fn, x in (("eeg_chunk", sessions["fused"].embed_eeg, eeg),
                        ("speech_chunk", sessions["fused"].embed_speech, speech)):
        zero_counts()
        fn(x)
        torch.cuda.synchronize()
        launches[what] = counts()
    step = card_vs_cpu_step(cfg, host_batch, fused=True)

    batch = {k: torch.from_numpy(v).to("cuda") for k, v in host_batch.items()}
    runs = {}
    for name in ("fused", "unfused"):
        model = models[name]
        opt = make_optimizer(model.parameters(), cfg.optimizer, cfg.learning_rate, cfg.beta1,
                             cfg.beta2, cfg.weight_decay, cfg.amsgrad_b)
        runs[name] = lambda model=model, opt=opt: train_step(model, opt, batch, cfg.seed,
                                                             False)
    zero_counts()
    runs["fused"]()
    torch.cuda.synchronize()
    launches["train_step"] = counts()
    want = {
        "eeg_chunk": {"fused_transformer_block": 10, "lstm_scan_packed": 0,
                      "fused_basic_block": 10},
        "speech_chunk": {"fused_transformer_block": 0, "lstm_scan_packed": 2,
                         "fused_basic_block": 1},
        "train_step": {"fused_transformer_block": 10, "fused_block_backward": 10,
                       "lstm_scan_packed": 2, "lstm_scan_backward": 2,
                       "fused_basic_block": N_FUSED_BLOCKS,
                       "fused_conv_backward": N_FUSED_BLOCKS, "conv1d_same": N_FUSED_BLOCKS},
    }
    for what, per_kernel in want.items():
        full = dict.fromkeys(launches[what], 0)
        full.update(per_kernel)
        if launches[what] != full:
            raise AssertionError(f"launches on the fused path, {what}: {launches[what]}, "
                                 f"want {full}")
    log(f"kernel launches on the fused path: {launches}")

    # step time on a batch already on the card, fused and unfused in turns
    for run in runs.values():
        run()
    times = {"fused": [], "unfused": []}
    for name in ("fused", "unfused", "unfused", "fused") * 5:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[name]()
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3)
    step_ms = {k: statistics.median(v) for k, v in times.items()}
    log(f"train step at batch 128 on a batch on the card, host clock, median of 10: fused "
        f"{step_ms['fused']:.3f} ms, unfused {step_ms['unfused']:.3f} ms")
    profile = profile_calls(runs["fused"], reps=3)
    result = {"launches": launches, "embedding_err": emb_err, "card_vs_cpu_step": step,
              "step_ms_median": step_ms, "step_ms_all": times,
              "profile_3_fused_steps": profile}
    log(json.dumps({"fused_path": result}))
    return result


def long_window_path() -> dict:
    """The flagship built for 4 s windows (``window_length_s=4``, T=256, longer
    than a block kernel that keeps a sample in shared memory could take): 8
    windows through both embedders on the card against a CPU copy, then one
    train step at batch 8 with dropout on, card against CPU, with the kernel
    launches of each counted."""
    cfg = TrainConfig(window_length_s=4, bank_size=BANK_SIZE)
    t = cfg.window_length
    if t != 256:
        raise AssertionError(f"window_length_s=4 gives T={t}, want 256")
    rng = np.random.default_rng(6)
    batch = {"eeg": rng.standard_normal((8, t, 64)).astype(np.float32),
             "speech": rng.standard_normal((8, t, cfg.speech_dimension)).astype(np.float32),
             "ids": np.arange(1, 9, dtype=np.int64)}
    sessions = {dev: InferenceSession(build_model(cfg, cfg.bank_size, device=dev, seed=0),
                                      chunk=8, device=dev) for dev in ("cuda", "cpu")}
    launches = {}
    zero_counts()
    emb = {dev: (s.embed_eeg(batch["eeg"]), s.embed_speech(batch["speech"]))
           for dev, s in sessions.items()}
    torch.cuda.synchronize()
    launches["embed"] = counts()
    dim = sessions["cuda"].model.eegModel.get_output_dim(t)
    _check_embeddings("embed_eeg at T=256", emb["cuda"][0], 8, dim)
    errs = {name: float(np.abs(emb["cuda"][i] - emb["cpu"][i]).max())
            for i, name in enumerate(("eeg", "speech"))}
    log(f"window_length_s=4 (T={t}), 8 windows, card vs CPU: max_abs_err {errs} "
        f"(tol {SERVE_TOL:g})")
    if not max(errs.values()) <= SERVE_TOL:
        raise AssertionError("card and CPU embeddings disagree at T=256")
    del sessions
    zero_counts()
    step = card_vs_cpu_step(cfg, batch)
    launches["train_step"] = counts()
    want = {"embed": {"fused_transformer_block": 10, "lstm_scan_packed": 2},
            "train_step": {"fused_transformer_block": 10, "fused_block_backward": 10,
                           "lstm_scan_packed": 2, "lstm_scan_backward": 2}}
    for what, per_kernel in want.items():
        full = dict.fromkeys(launches[what], 0)
        full.update(per_kernel)
        if launches[what] != full:
            raise AssertionError(f"launches at T=256, {what}: {launches[what]}, want {full}")
    log(f"kernel launches at T=256: {launches}")
    result = {"window_length": t, "launches": launches, "embedding_err": errs,
              "card_vs_cpu_step": step}
    log(json.dumps({"long_window_path": result}))
    return result


# -- augmentations, the augmented run, the serving command lines --------------

AUG_TOL = 1e-5  # of max |x|: cuFFT and the card's f32 math against the CPU's
AUG_EXACT = ("SignFlip", "ChannelsDropout", "ChannelsShuffle")  # no arithmetic on the values
AUG_KEY = 20240917


def _share_ok(mask: torch.Tensor, p: float) -> tuple:
    """The augmented share of ``mask`` and whether it lies within 5 sigma of
    ``p`` (exactly 1 at p=1)."""
    share = float(mask.float().mean())
    return share, abs(share - p) <= 5 * (p * (1 - p) / mask.numel()) ** 0.5


def augment_phase() -> dict:
    """The eight transforms, the train step's batch mixup and the host
    iterator's chunk mixup at the flagship batch ``[128, 192, 64]`` (a chunk
    of 3 subjects x 133 windows for the chunk mixup), at p=1 and p=0.5, on
    the card under ``torch.cuda.set_sync_debug_mode("error")`` (a host sync
    raises); then card against CPU on the same seeds, the augmented share,
    and the ms of each by CUDA events beside its device busy time and
    launches under ``torch.profiler`` and the bytes it must move."""
    gen = torch.Generator().manual_seed(9)
    host = {"x": torch.randn(128, 192, 64, generator=gen),
            "partner": torch.randn(128, 192, 64, generator=gen),
            "chunk": torch.randn(3, 133, 192, 64, generator=gen)}
    card = {k: v.cuda() for k, v in host.items()}
    torch.cuda.synchronize()

    def transform(name, p, t):
        if name == "batch_mixup":
            return _apply_mixup(AUG_KEY, t["x"], t["partner"], p)
        if name == "chunk_mixup":
            return mixup_eeg(AUG_KEY, t["chunk"], p)
        return TRANSFORMS[name](AUG_KEY, t["x"], p, **BEST_AUG_PARAMS.get(name, {}))

    def changed(name, p, t):
        """Which samples (rows; subject windows of the chunk) it changes."""
        if name == "batch_mixup":
            return draw_batch_mixup(AUG_KEY, 128, p, t["x"].device)["do_aug"]
        if name == "chunk_mixup":
            return draw_mixup_eeg(AUG_KEY, t["chunk"], p)["do_aug"]
        return DRAWS[name](AUG_KEY, t["x"], p, **BEST_AUG_PARAMS.get(name, {}))["mask"]

    def run(name, p, t):
        return transform(name, p, t), changed(name, p, t)

    names = list(TRANSFORMS) + ["batch_mixup", "chunk_mixup"]
    out = {}
    torch.cuda.set_sync_debug_mode("error")
    try:
        for name in names:
            for p in (1.0, 0.5):
                out[(name, p)] = run(name, p, card)
        composed = make_augmentation_fn(list(TRANSFORMS), 0.5)(AUG_KEY, card["x"])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("augmentations: the 8 transforms, both mixups and the 8 composed ran on the card "
        "with set_sync_debug_mode('error'): no host sync")
    rows = {}
    for (name, p), (y, on_card) in out.items():
        y_cpu, on_cpu = run(name, p, host)
        inp = host["chunk" if name == "chunk_mixup" else "x"]
        err = float((y.cpu() - y_cpu).abs().max()) / float(inp.abs().max())
        share, share_ok = _share_ok(on_card, p)
        row = rows.setdefault(name, {})
        row[f"p{p:g}"] = {"err": err, "share": share, "masks_equal":
                          bool(torch.equal(on_card.cpu(), on_cpu))}
        exact = name in AUG_EXACT
        if not (row[f"p{p:g}"]["masks_equal"] and share_ok
                and (err == 0.0 if exact else err <= AUG_TOL)
                and bool(torch.isfinite(y).all()) and y.shape == inp.shape):
            raise AssertionError(f"augmentation {name} at p={p}: {row[f'p{p:g}']} (tol "
                                 f"{0 if exact else AUG_TOL:g} of max |x|, share within 5 sigma)")
    comp_err = float((composed.cpu() - make_augmentation_fn(list(TRANSFORMS), 0.5)(
        AUG_KEY, host["x"])).abs().max()) / float(host["x"].abs().max())
    if not comp_err <= AUG_TOL:
        raise AssertionError(f"the 8 transforms composed: card vs CPU {comp_err}")
    for name in names:
        fn = (lambda name=name: transform(name, 0.5, card))
        prof = profile_calls(fn, reps=5)
        nbytes = 2 * card["chunk" if name == "chunk_mixup" else "x"].nbytes  # read + write
        rows[name].update(ms=time_ms(fn), device_ms=prof["device_ms_per_call"],
                          host_ms=prof["host_ms_per_call"],
                          device_launches=prof["device_ops_per_call"],
                          bound_ms=nbytes / PEAK_BYTES * 1e3)
    ms_composed = time_ms(lambda: make_augmentation_fn(list(TRANSFORMS), 0.5)(AUG_KEY, card["x"]))
    result = {"by_name": rows, "composed_err": comp_err, "composed_ms": ms_composed,
              "tol": AUG_TOL, "exact": list(AUG_EXACT), "batch": [128, 192, 64]}
    log("augmentations, card vs CPU (error over max |x|), share at p=0.5, ms by CUDA events "
        "(device busy ms under the profiler, device launches, bytes bound ms): " +
        "; ".join(f"{n} {max(r['p1']['err'], r['p0.5']['err']):.2e} {r['p0.5']['share']:.3f} "
                  f"{r['ms']:.4f} ({r['device_ms']:.4f}, {r['device_launches']:.0f}, "
                  f"{r['bound_ms']:.4f})" for n, r in rows.items())
        + f"; all 8 composed {comp_err:.2e}, {ms_composed:.4f} ms")
    log(json.dumps({"augment": result}))
    return result


AUG_FLAGS = ["--data_augmentation", "FTSurrogate", "--addEEG", "yes"]
# the kernels of the augmented run's trace, by kernel (substrings of the names)
TRACE_KERNELS = {"fused_transformer_block": ("ln_qkv_kernel", "attn_fwd_kernel",
                                             "proj_ffn_kernel"),
                 "fused_block_backward": ("qkv_bwd_kernel", "attn_bwd_kernel",
                                          "ffn_bwd_kernel"),
                 "lstm_scan_packed": ("lstm_fwd_cluster",),
                 "lstm_scan_backward": ("lstm_bwd_cluster",)}


def check_trace(profile_dir: str) -> dict:
    """The Chrome trace ``--profile_dir`` wrote: present, and naming every
    kernel of #1-#4; returns the kernel events counted by kernel."""
    path = os.path.join(profile_dir, PROFILE_TRACE)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    found = {k: sum(any(n in name for n in names) for name in kernels)
             for k, names in TRACE_KERNELS.items()}
    if not all(found.values()):
        raise AssertionError(f"{path}: kernel events by kernel {found}")
    return {"bytes": os.path.getsize(path), "kernel_events": len(kernels),
            "events_by_kernel": found}


def augmented_train_path(data_dir: str, cfg, host_batch, default_step_ms: float) -> dict:
    """The flagship with augmentation and mixup: one step at batch 8 with
    each augmentation and mixup on, card against CPU; then ``cli.main`` with
    ``--data_augmentation FTSurrogate --addEEG yes --epochs 2 --skip_eval yes
    --profile_dir``: the device store (timed, launches counted), then the
    device store and the host path on cuDNN's deterministic algorithms, their
    losses held to each other."""
    steps = {name: card_vs_cpu_step(cfg, host_batch, name=f"{name} and mixup",
                                    augmentations=[name], add_eeg=True)
             for name in TRANSFORMS}
    runs = {}
    with instrumented() as seen:
        for name, mode, determ in (("timed", "device", False), ("paired_device", "device", True),
                                   ("paired_host", "host", True)):
            profile_dir = os.path.join(RUN_DIR, f"trace_{name}")
            zero_counts()
            with deterministic_cudnn() if determ else contextlib.nullcontext():
                rc = cli.main(["--data_dir", data_dir, "--epochs", "2", "--skip_eval", "yes",
                               "--data_mode", mode, *AUG_FLAGS, "--profile_dir", profile_dir,
                               "--results_folder", os.path.join(RUN_DIR, f"aug_{name}")],
                              device="cuda")
            torch.cuda.synchronize()
            if rc != 0:
                raise AssertionError(f"the augmented {name} run returned {rc}")
            trainer = seen["trainers"][-1]
            n_train, n_val = steps_per_epoch(trainer)
            want = two_epoch_launches(n_train, n_val)
            if counts() != want or trainer.device_data != (mode == "device"):
                raise AssertionError(f"augmented {name} run: launches {counts()}, want {want}")
            values, _ = read_loss_txt(trainer.loss_file, mode, profile_dir)
            runs[name] = {"launches": counts(), "losses": values, "trace": check_trace(profile_dir),
                          "steps_per_epoch": [n_train, n_val],
                          "step_ms_epoch2": [v * 1e3 for v in trainer.history[1]["step_s"]]}
    rel = max(abs(x - y) / max(abs(y), 1e-30)
              for x, y in zip(runs["paired_device"]["losses"], runs["paired_host"]["losses"]))
    if not rel <= HOST_DEVICE_TOL:
        raise AssertionError(f"augmented runs, device vs host losses differ by {rel}")
    step_ms = statistics.median(runs["timed"]["step_ms_epoch2"])
    n_train, n_val = runs["timed"]["steps_per_epoch"]
    per_step = {k: v // (2 * n_train) for k, v in runs["timed"]["launches"].items()
                if k in ("fused_block_backward", "lstm_scan_backward")}
    log(f"augmented run ({' '.join(AUG_FLAGS)}), 2 epochs of {n_train} train and {n_val} "
        f"validation steps: launches {runs['timed']['launches']} (a train step: 10/10/2/2 of "
        f"#1-#4, {per_step}); device vs host losses on cuDNN's deterministic algorithms "
        f"{rel:.3e} (tol {HOST_DEVICE_TOL:g}); epoch-2 median step {step_ms:.2f} ms against "
        f"the default run's {default_step_ms:.2f} ms; traces "
        f"{ {k: r['trace']['events_by_kernel'] for k, r in runs.items()} }")
    summary = ("loss_err", "grad_err", "bank_err", "batch_stats_err")
    result = {"flags": AUG_FLAGS, "runs": runs,
              "card_vs_cpu_steps": {n: {k: st[k] for k in summary} for n, st in steps.items()},
              "host_vs_device_loss_rel": rel, "step_ms_median_epoch2": step_ms,
              "default_step_ms_median_epoch2": default_step_ms,
              "launches": runs["timed"]["launches"]}
    log(json.dumps({"augmented_train": result}))
    return result


def _get_json(url: str):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return json.loads(resp.read())


def _wall(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def serve_cli_path(results_dir: str) -> dict:
    """``serve.main`` on the flagship run's results directory, on the card:
    EEG embeddings (256 windows), speech embeddings (128) and top-5
    retrieval of the EEG over 130 candidates, each against an
    ``InferenceSession`` of the run on the card and, on 8 windows, on the
    CPU; the wall time of each invocation (loading the run included) and its
    kernel launches."""
    cfg = TrainConfig.load(os.path.join(results_dir, "args.txt"))
    rng = np.random.default_rng(11)
    arrays = {"eeg": rng.standard_normal((256, cfg.window_length, 64)),
              "speech": rng.standard_normal((128, cfg.window_length, cfg.speech_dimension)),
              "cand": rng.standard_normal((130, cfg.window_length, cfg.speech_dimension))}
    paths = {}
    for k, v in arrays.items():
        arrays[k] = v.astype(np.float32)
        paths[k] = os.path.join(RUN_DIR, f"serve_{k}.npy")
        np.save(paths[k], arrays[k])
    outs = {"eeg": os.path.join(RUN_DIR, "serve_eeg_emb.npy"),
            "speech": os.path.join(RUN_DIR, "serve_speech_emb.npy"),
            "topk": os.path.join(RUN_DIR, "serve_topk.json")}
    invocations = {"eeg": ["--eeg", paths["eeg"], "--out", outs["eeg"]],
                   "speech": ["--speech", paths["speech"], "--out", outs["speech"]],
                   "topk": ["--eeg", paths["eeg"], "--candidates", paths["cand"], "--topk", "5",
                            "--out", outs["topk"]]}
    wall, launches = {}, {}
    zero_counts()
    for name, argv in invocations.items():
        before = counts()
        rc, wall[name] = _wall(lambda argv=argv: serve_main(["--results_folder", results_dir,
                                                              *argv]))
        torch.cuda.synchronize()
        if rc != 0:
            raise AssertionError(f"serve CLI {name} returned {rc}")
        launches[name] = {k: v - before[k] for k, v in counts().items()}
    total = counts()
    want = dict.fromkeys(total, 0)
    want.update(fused_transformer_block=10 * (2 + 2), lstm_scan_packed=2 * (1 + 2))
    if total != want:
        raise AssertionError(f"serve CLI launches {launches}, want {want} in all")
    session = InferenceSession.from_results_dir(results_dir, device="cuda")
    cpu = InferenceSession.from_results_dir(results_dir, chunk=8, device="cpu")
    got = {"eeg": np.load(outs["eeg"]), "speech": np.load(outs["speech"])}
    want_emb = {"eeg": session.embed_eeg(arrays["eeg"]),
                "speech": session.embed_speech(arrays["speech"])}
    errs = {f"{k}_vs_session": float(np.abs(got[k] - want_emb[k]).max()) for k in got}
    errs["eeg_vs_cpu"] = float(np.abs(got["eeg"][:8] - cpu.embed_eeg(arrays["eeg"][:8])).max())
    errs["speech_vs_cpu"] = float(np.abs(got["speech"][:8]
                                         - cpu.embed_speech(arrays["speech"][:8])).max())
    with open(outs["topk"]) as f:
        topk = json.load(f)
    cand_emb = session.embed_speech(arrays["cand"])
    paths["cand_emb"] = os.path.join(RUN_DIR, "serve_cand_emb.npy")
    np.save(paths["cand_emb"], cand_emb)
    index = RetrievalIndex.from_embeddings(cand_emb, device="cuda")
    scores, ids = index.topk(want_emb["eeg"], 5)
    errs["topk_scores_vs_session"] = float(np.abs(np.asarray(topk["scores"]) - scores).max())
    ids_equal = topk["indices"] == ids.tolist()
    log(f"serve CLI on the flagship run: wall s {wall} (run loaded each time), launches "
        f"{launches}; errors {errs} (tol 1e-6 against the card's session, {SERVE_TOL:g} "
        f"against the CPU's); top-5 ids equal {ids_equal}")
    if not (set(topk) == {"indices", "scores"} and ids_equal
            and max(v for k, v in errs.items() if "cpu" not in k) <= 1e-6
            and max(errs["eeg_vs_cpu"], errs["speech_vs_cpu"]) <= SERVE_TOL):
        raise AssertionError("the serve CLI disagrees with the sessions")
    for k in ("eeg", "speech"):
        _check_embeddings(f"serve CLI {k}", got[k], len(arrays[k]), got[k].shape[1])
    result = {"wall_s": wall, "launches_by_invocation": launches, "launches": total,
              "errors": errs, "paths": paths, "outs": outs}
    log(json.dumps({"serve_cli": result}))
    return result


SERVER_ROUNDS = 5
SERVER_WAIT_S = 120


def server_cli_path(results_dir: str, serve: dict) -> dict:
    """``python -m transformer_clip_eeg_tpu_torch.server --port 0
    --candidates ...`` on the card in a subprocess: its URL read from its
    standard output within ``SERVER_WAIT_S``; /healthz, both embed routes,
    top-k and match_mismatch, ``SERVER_ROUNDS`` times, whose answers equal the
    serve CLI's; SIGINT, after which it must exit 0.  The subprocess prints
    its kernel launches as its last line (the same ``main`` the module runs,
    wrapped to read its counters, with TF32 off as in this process)."""
    paths, outs = serve["paths"], serve["outs"]
    code = ("import json, sys\n"
            "import torch\n"
            "torch.backends.cuda.matmul.allow_tf32 = False\n"
            "torch.backends.cudnn.allow_tf32 = False\n"
            "from transformer_clip_eeg_tpu_torch import server\n"
            "from transformer_clip_eeg_tpu_torch.tools import kernel_launches\n"
            "rc = server.main()\n"
            "print('launches ' + json.dumps({k: v for k, v in kernel_launches().items()"
            " if not k.endswith('_bf16')}), flush=True)\n"
            "sys.exit(rc)\n")
    t_start = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-c", code, "--results_folder", results_dir, "--port", "0",
         "--candidates", paths["cand"]],
        cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    lines: list = []
    got_url = threading.Event()
    reader = threading.Thread(target=lambda: [(lines.append(ln), ln.startswith("serving ")
                                               and got_url.set()) for ln in proc.stdout],
                              daemon=True)
    reader.start()
    try:
        if not got_url.wait(SERVER_WAIT_S):
            proc.kill()
            raise AssertionError(f"the server printed no URL in {SERVER_WAIT_S} s: {lines}; "
                                 f"exit code {proc.wait(timeout=60)}, standard error "
                                 f"{proc.stderr.read()[-3000:]}")
        url = next(ln for ln in lines if ln.startswith("serving ")).rsplit(" on ", 1)[1].strip()
        t_url = time.perf_counter() - t_start
        health = _get_json(f"{url}/healthz")
        t_health = time.perf_counter() - t_start
        eeg, speech = np.load(paths["eeg"]), np.load(paths["speech"])
        npy = {"Content-Type": NPY_CONTENT_TYPE, "Accept": NPY_CONTENT_TYPE}
        times = {k: [] for k in ("healthz", "embed_eeg", "embed_speech", "topk",
                                 "match_mismatch")}
        answers = {}
        for _ in range(SERVER_ROUNDS):
            for route, fn in (
                    ("healthz", lambda: _get_json(f"{url}/healthz")),
                    ("embed_eeg", lambda: _post(f"{url}/v1/embed/eeg", body=_npy(eeg),
                                                headers=npy)),
                    ("embed_speech", lambda: _post(f"{url}/v1/embed/speech",
                                                   body=_npy(speech), headers=npy)),
                    ("topk", lambda: _post(f"{url}/v1/retrieval/topk?k=5",
                                           body=_npy(eeg[:16]), headers={
                                               "Content-Type": NPY_CONTENT_TYPE})),
                    ("match_mismatch", lambda: _post(f"{url}/v1/match_mismatch", {
                        "eeg": eeg[:4].tolist(), "cand_a": speech[:4].tolist(),
                        "cand_b": speech[4:8].tolist()}))):
                answers[route], dt = _wall(fn)
                times[route].append(dt)
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=60)
        reader.join(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    err_text = proc.stderr.read()
    proc.stdout.close()
    proc.stderr.close()
    if rc != 0:
        raise AssertionError(f"the server exited {rc} after SIGINT: {err_text[-2000:]}")
    launch_line = [ln for ln in lines if ln.startswith("launches ")]
    launches = json.loads(launch_line[-1].split(" ", 1)[1])
    # 256 EEG windows are 2 chunks of 128, the 16 top-k queries and the 4
    # match-mismatch trials 1 each; 130 candidates 2 speech chunks (at start),
    # 128 speech windows 1, each match-mismatch candidate set 1
    want = dict.fromkeys(launches, 0)
    want.update(fused_transformer_block=10 * SERVER_ROUNDS * (2 + 1 + 1),
                lstm_scan_packed=2 * (2 + SERVER_ROUNDS * (1 + 2)))
    cli_eeg, cli_speech = np.load(outs["eeg"]), np.load(outs["speech"])
    with open(outs["topk"]) as f:
        cli_topk = json.load(f)
    errs = {"embed_eeg": float(np.abs(answers["embed_eeg"] - cli_eeg).max()),
            "embed_speech": float(np.abs(answers["embed_speech"] - cli_speech).max()),
            "topk_scores": float(np.abs(np.asarray(answers["topk"]["scores"])
                                        - np.asarray(cli_topk["scores"])[:16]).max())}
    want_mm = match_mismatch_decide(cli_eeg[:4], cli_speech[:4], cli_speech[4:8]).tolist()
    checks = {"healthz": health.get("status") == "ok" and health.get("index_size") == 130
              and health.get("window_length") == 192,
              "topk_ids": answers["topk"]["ids"] == cli_topk["indices"][:16],
              "match_mismatch": answers["match_mismatch"]["decisions"] == want_mm,
              "launches": launches == want,
              "errors": max(errs.values()) <= 1e-6}
    median_ms = {k: statistics.median(v) * 1e3 for k, v in times.items()}
    log(f"server CLI (subprocess on the card): URL after {t_url:.1f} s, first /healthz "
        f"answered after {t_health:.1f} s; median request ms over {SERVER_ROUNDS} rounds "
        f"{median_ms}; against the serve CLI {errs}; checks {checks}; launches {launches} "
        f"(want {want}); exit code {rc} after SIGINT")
    if not all(checks.values()):
        raise AssertionError(f"server CLI checks failed: {checks}")
    result = {"url_s": t_url, "first_healthz_s": t_health, "request_ms_median": median_ms,
              "request_ms_all": {k: [x * 1e3 for x in v] for k, v in times.items()},
              "errors": errs, "launches": launches, "exit_code": rc, "healthz": health}
    log(json.dumps({"server_cli": result}))
    return result


# ---- the bf16 compute mode (--compute_dtype bfloat16) ------------------------------
# The agreed limits: both sides round the same operands to bf16 and sum in f32
# in another order, so an intermediate may flip by one bf16 unit (2^-8
# relative) where the two sums straddle a rounding boundary
BF16_OUT_TOL = 8e-3    # bf16 outputs (block out, dx, LSTM hs, conv out): of max |ref|
BF16_GRAD_TOL = 1e-2   # f32 parameter gradients of one module: of each one's largest value
# #1/#2's 16 parameter gradients against the twin, tightened: the kernels read
# at most 8.6e-4, and the float32 instantiation on the same bf16-rounded
# inputs (products on unrounded operands) 3.9e-3 to 6.0e-3 (the twins on the
# CPU at these shapes), which this limit must tell apart (the control)
BF16_BLOCK_GRAD_TOL = 2.5e-3
BF16_STEP_LOSS_TOL = 1e-2   # one whole train step: each loss, relative
BF16_STEP_GRAD_TOL = 5e-2   # each gradient, of its largest value
BF16_STEP_STATE_TOL = 1e-2  # the bank's rows and the running statistics
# a leaf that is zero in exact arithmetic (each block's key bias) holds only
# rounding noise: in a bf16 step it is held at this share of the largest
# gradient (one bf16 unit), where the f32 step's floor is STEP_GRAD_FLOOR
BF16_STEP_GRAD_FLOOR = 4e-3
# The flagship's step is held on this many batches of 8 (rows 8i to 8i+7 of
# the default run's first batch), each gradient at the median of its error
# over them, each loss and the state on every batch.  A few of its gradients
# are sums that cancel most of their terms at the seed's weights (the last
# EEG bias, the temperature, the speech LSTMs' biases): on some batches a
# bf16 rounding apart moves them past 5e-2 of their value, the CPU's as far
# from its float64 step as the card's, and which batch the check gets
# follows the fixture's file order, a property of the machine.  A wrong
# product or cast moves a gradient on every batch.
BF16_STEP_BATCHES = 9
BF16_PLANES = 4  # q, k, v and ctx, the saved planes that hold bf16 values
PEAK_BF16_FLOPS = 989e12  # dense bf16 on the tensor cores
BF16_WINDOWS = ((128, 192), (128, 256), (8, 1699))  # (B, T): the flagship, 4 s, the longest
DBK, DBQ = 6, 5  # the key and query biases' places in the block's 16-tuple
BF16_NAMES = {"fused_transformer_block": "fused_transformer_block (bf16)",
              "fused_block_backward": "fused_block_backward (bf16)"}


def bound_bf16(flops: float, nbytes: float):
    """The least time of ``flops`` bf16 tensor-core operations and ``nbytes``."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def rel_err(got, want) -> float:
    """max abs error over max |want|, in float32."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / float(want.abs().max())


def dparam_errs(got, want) -> list:
    """Each of the block's 16 parameter gradients: max abs error over its own
    largest value; the key bias's (zero in exact arithmetic: a softmax does
    not move when one vector is added to every key) over the query bias's."""
    return [float((a - w).abs().max()) / float(want[DBQ if i == DBK else i].abs().max())
            for i, (a, w) in enumerate(zip(got, want))]


@contextlib.contextmanager
def f32_sums():
    """cuBLAS's bf16 products with f32 sums only (PyTorch lets it sum part of
    a bf16 product in bf16 by default, where JAX sums in f32): on while the
    card is held against the CPU or a twin, off for the timed runs."""
    flag = torch.backends.cuda.matmul
    before = flag.allow_bf16_reduced_precision_reduction
    flag.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        flag.allow_bf16_reduced_precision_reduction = before


def ptxas_spills(*names: str) -> dict:
    """The registers of every compiled instantiation of each kernel in
    ``names`` (a list a name, in the order ``ptxas -v`` reported them);
    raises if one spills."""
    usage = {m: u for m, u in _build.ptxas_usage().items() if any(n in m for n in names)}
    spills = {m: u for m, u in usage.items() if u["spill_stores"] or u["spill_loads"]}
    if spills:
        raise AssertionError(f"kernels spill registers: {spills} (all: {usage})")
    return {n: [u["registers"] for m, u in usage.items() if n in m] for n in names}


def block_bf16_errors(x, params, g, drop) -> dict:
    """#1 and #2 in their bf16 instantiations on a bf16 ``x`` and ``g``
    against the plain twins on the card: out, what the forward saves, dx
    (all of max |twin|, ``BF16_OUT_TOL``) and the 16 parameter gradients
    (``dparam_errs``, ``BF16_BLOCK_GRAD_TOL``); then the control: the float32
    instantiation on the same (bf16-valued) inputs, whose products take
    unrounded operands, must miss the parameter gradients' limit.  Raises
    past the limits or if the control passes them."""
    h, scale = 8, x.shape[-1] ** 0.5
    with torch.inference_mode():
        out, saved = fused_block_forward_cuda(x, params, h, scale, drop, save=True)
        dx, dparams = fused_block_backward(x, params, g, saved, h, scale, drop)
        torch.cuda.synchronize()
        if out.dtype != torch.bfloat16 or dx.dtype != torch.bfloat16 or any(
                d.dtype != torch.float32 for d in dparams):
            raise AssertionError("the bf16 block's outputs are not bf16 out and dx and f32 "
                                 "parameter gradients")
        errs = {"out": rel_err(out, fused_transformer_block_reference(x, params, h, scale,
                                                                       *drop))}
        want_saved = fused_block_saved_reference(x, params, h, scale, drop)
        n = x.numel()
        for i, name in enumerate(SAVED_NAMES):
            sl = slice(i * n, (i + 1) * n if i < 5 else None)
            errs[f"saved_{name}"] = rel_err(saved[sl], want_saved[sl])
        del want_saved, saved
        want_dx, want_dp = fused_block_backward_reference(x, params, g, h, scale, drop)
        errs["dx"] = rel_err(dx, want_dx)
        grad_errs = dparam_errs(dparams, want_dp)
        x32, g32 = x.float(), g.float()
        out32, saved32 = fused_block_forward_cuda(x32, params, h, scale, drop, save=True)
        dx32, dparams32 = fused_block_backward(x32, params, g32, saved32, h, scale, drop)
        control = {"out": rel_err(out32, out), "dx": rel_err(dx32, want_dx),
                   "dparams_worst": max(dparam_errs(dparams32, want_dp))}
        del saved32
    errs["dparams_worst"] = max(grad_errs)
    errs["f32_control"] = control
    log(f"  bf16 #1/#2 x{tuple(x.shape)}, drop {drop.active}: {json.dumps(errs)} (tol "
        f"{BF16_OUT_TOL:g} of max|twin|; dparams {BF16_BLOCK_GRAD_TOL:g} of each one's "
        f"largest, which the f32 control must miss); dparams "
        f"{[f'{v:.1e}' for v in grad_errs]}")
    if not (max(v for k, v in errs.items() if k.startswith(("out", "saved_", "dx")))
            <= BF16_OUT_TOL and errs["dparams_worst"] <= BF16_BLOCK_GRAD_TOL):
        raise AssertionError(f"the bf16 block disagrees with its twins: {errs}")
    if control["dparams_worst"] <= BF16_BLOCK_GRAD_TOL:
        raise AssertionError(f"the f32 block on the same inputs passes the bf16 block's "
                             f"limits, which cannot tell the modes apart: {control}")
    return errs


def check_block_bf16(gen: torch.Generator, params) -> list:
    """Kernels #1 and #2 in their bf16 mode: against the twins at the
    flagship's window, at T=256 and at T=1,699 (batch 8), dropout on and off,
    with cuBLAS's f32 sums; then timed at the flagship's shape by CUDA events
    beside their f32 instantiations, the twins and ``nn.TransformerEncoderLayer``
    in bf16 (forward, and backward), with a bit-for-bit repeat, the launches
    per call and what ``ptxas -v`` reported for every instantiation.  Returns
    the two entries of the ``kernels`` line."""
    h, e = 8, 64
    scale = e ** 0.5
    windows = {}
    with f32_sums():
        for b, t in BF16_WINDOWS:
            x = torch.randn(b, t, e, generator=gen).to("cuda").to(torch.bfloat16)
            g = torch.randn(b, t, e, generator=gen).to("cuda").to(torch.bfloat16)
            windows[f"B{b}_T{t}"] = {
                ("dropout" if drop.active else "eval"): block_bf16_errors(x, params, g, drop)
                for drop in (DropoutConfig(), FLAGSHIP_DROP)}
            del x, g
            torch.cuda.empty_cache()
    worst = {k: max(w[mode][k] for w in windows.values() for mode in w)
             for k in ("out", "dx", "dparams_worst")}
    control_worst = min(w[mode]["f32_control"]["dparams_worst"] for w in windows.values()
                        for mode in w)

    b, t = 128, 192
    x = torch.randn(b, t, e, generator=gen).to("cuda").to(torch.bfloat16)
    g = torch.randn(b, t, e, generator=gen).to("cuda").to(torch.bfloat16)
    x32, g32 = x.float(), g.float()
    run_eval = lambda: fused_block_forward_cuda(x, params, h, scale)[:1]  # noqa: E731
    run_tr = lambda: fused_block_forward_cuda(x, params, h, scale, FLAGSHIP_DROP,  # noqa: E731
                                              save=True)
    lib = library_layer(params).to(torch.bfloat16).eval()
    with torch.inference_mode():
        assert_repeats("fused_transformer_block (bf16, eval)", run_eval)
        assert_repeats("fused_transformer_block (bf16, training: out and saved)", run_tr)
        _, saved = run_tr()
        _, saved32 = fused_block_forward_cuda(x32, params, h, scale, FLAGSHIP_DROP, save=True)

        def run_bwd():
            dx, dparams = fused_block_backward(x, params, g, saved, h, scale, FLAGSHIP_DROP)
            return (dx, *dparams)

        assert_repeats("fused_block_backward (bf16)", run_bwd)
        fwd_parts = block_forward_parts(run_eval)
        bwd_parts = kernel_parts(run_bwd, BLOCK_BWD_PARTS)
        ms = time_ms(run_eval)
        ms_tr = time_ms(run_tr)
        bwd_ms = time_ms(run_bwd)
        f32_ms = time_ms(lambda: fused_block_forward_cuda(x32, params, h, scale))
        f32_bwd_ms = time_ms(lambda: fused_block_backward(x32, params, g32, saved32, h, scale,
                                                          FLAGSHIP_DROP))
        plain_ms = time_ms(lambda: fused_transformer_block_reference(x, params, h, scale))
        plain_bwd_ms = time_ms(lambda: fused_block_backward_reference(x, params, g, h, scale,
                                                                      FLAGSHIP_DROP))
        library_ms = time_ms(lambda: lib(x))
    lib.train()
    xl = x.clone().requires_grad_()
    lib_leaves = [xl] + list(lib.parameters())
    lib_out = lib(xl)
    library_bwd_ms = time_ms(lambda: torch.autograd.grad(lib_out, lib_leaves, g,
                                                         retain_graph=True))
    usage = ptxas_spills("ln_qkv_kernel", "attn_fwd_bf16_kernel", "proj_ffn_kernel",
                         "ffn_bwd_bf16_kernel", "attn_bwd_bf16_kernel", "qkv_bwd_bf16_kernel",
                         "products_bf16_kernel")
    flops = block_flops(b, t)
    n_par = sum(p.numel() for p in params)
    bound_ms, bound_by = bound_bf16(flops, 2 * 2 * x.numel() + 4 * n_par)
    # training: also the saved planes out (q, k, v and ctx hold bf16 values:
    # 2 bytes each; x1 and the lse f32), as #2's bound counts them in
    bound_tr_ms, bound_tr_by = bound_bf16(
        flops, 2 * 2 * x.numel() + 2 * BF16_PLANES * x.numel()
        + 4 * (saved.numel() - BF16_PLANES * x.numel() + n_par))
    # backward: x, g (bf16) and what the forward saved in (q, k, v and ctx
    # hold bf16 values: 2 bytes each, the rest f32), dx (bf16) and the
    # parameters' gradients out
    bwd_bound_ms, bwd_bound_by = bound_bf16(
        2 * flops, 2 * 3 * x.numel() + 2 * BF16_PLANES * x.numel()
        + 4 * (saved.numel() - BF16_PLANES * x.numel() + 2 * n_par))
    log(f"  bf16 #1 at [128, 192, 64]: {ms:.4f} ms eval, {ms_tr:.4f} ms training (the f32 "
        f"kernel {f32_ms:.4f} ms), plain {plain_ms:.4f} ms, TransformerEncoderLayer in bf16 "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; training "
        f"{bound_tr_ms:.4f} ms, {bound_tr_by}); parts {json.dumps(fwd_parts['parts_ms'])}")
    log(f"  bf16 #2: {bwd_ms:.4f} ms (the f32 kernel {f32_bwd_ms:.4f} ms), plain "
        f"{plain_bwd_ms:.4f} ms, the layer's backward in bf16 {library_bwd_ms:.4f} ms, bound "
        f"{bwd_bound_ms:.4f} ms ({bwd_bound_by}); parts {json.dumps(bwd_parts['parts_ms'])}, "
        f"{bwd_parts['launches_per_call']:g} device launches a call; ptxas {json.dumps(usage)}")
    common = {"route": "cuda", "tol": BF16_OUT_TOL, "grad_tol": BF16_BLOCK_GRAD_TOL,
              "f32_control_dparams_least": control_worst,
              "cublas_bf16_sums": "f32 (reduced-precision reduction off)",
              "registers_by_instantiation": usage}
    return [
        {"name": BF16_NAMES["fused_transformer_block"], **common,
         "source": "transformer_clip_eeg_tpu_torch/csrc/fused_block.cu",
         "replaces": "transformer_clip_eeg_tpu/ops/pallas_block.py:458",
         "max_abs_err": worst["out"], "tol_is": "max abs error / max |twin|",
         "ms": ms, "training_ms": ms_tr, "f32_ms": f32_ms, "plain_ms": plain_ms,
         "library_ms": library_ms,
         "library_call": "torch.nn.TransformerEncoderLayer(norm_first=True) in bf16, eval",
         "bound_ms": bound_ms, "bound_by": bound_by,
         "training_bound_ms": bound_tr_ms, "training_bound_by": bound_tr_by,
         "parts_ms": fwd_parts["parts_ms"],
         "device_launches_per_call": BLOCK_FWD_LAUNCHES, "repeats_bit_for_bit": True,
         "windows_with_backward": windows},
        {"name": BF16_NAMES["fused_block_backward"], **common,
         "source": "transformer_clip_eeg_tpu_torch/csrc/fused_block_bwd.cu",
         "replaces": "transformer_clip_eeg_tpu/ops/pallas_block.py:498",
         "max_abs_err": worst["dx"], "max_grad_err": worst["dparams_worst"],
         "tol_is": "dx: max abs error / max |twin|; dparams: of each one's largest",
         "ms": bwd_ms, "f32_ms": f32_bwd_ms, "plain_ms": plain_bwd_ms,
         "library_ms": library_bwd_ms,
         "library_call": "backward of torch.nn.TransformerEncoderLayer(norm_first=True) "
                         "in bf16",
         "bound_ms": bwd_bound_ms, "bound_by": bwd_bound_by, "parts_ms": bwd_parts["parts_ms"],
         "device_launches_per_call": bwd_parts["launches_per_call"],
         "repeats_bit_for_bit": True},
    ]


def check_lstm_conv_bf16(gen: torch.Generator) -> dict:
    """Kernels #3/#4 and #5/#6 under bf16 inputs, through the port's modules
    on the card, against the same modules computing with the plain twins on
    the card: the flagship's biLSTM (H=128, D=2) and the zoo's
    unidirectional one (D=1) on bf16 input [128, 192, 64], and the fused
    conv block at K=64.  Outputs and dx in bf16 within ``BF16_OUT_TOL``, the
    weights' gradients in f32 within ``BF16_GRAD_TOL``; ``whh``'s gradient
    holds bf16 values (JAX rounds it there)."""
    import transformer_clip_eeg_tpu_torch.ops.lstm as lstm_mod

    out = {}
    x = torch.randn(128, 192, 64, generator=gen).to("cuda").to(torch.bfloat16)
    with f32_sums():
        for d in (2, 1):
            mod = LSTM(64, 128, bidirectional=d == 2)
            mod.reset_parameters(torch.Generator().manual_seed(d))
            mod = mod.to("cuda")
            g_h = torch.randn(128, 192, 128 * d, generator=gen).to("cuda").to(torch.bfloat16)
            results = []
            for twin in (False, True):
                if twin:  # the recurrence as the plain twin, under autograd
                    lstm_mod.lstm_scan_packed = lambda xw, whh: lstm_scan_reference(xw, whh)
                try:
                    xl = x.clone().requires_grad_()
                    hs = mod(xl)
                    grads = torch.autograd.grad(hs, [xl, *mod.parameters()], g_h)
                    torch.cuda.synchronize()
                finally:
                    lstm_mod.lstm_scan_packed = lstm_scan_packed
                results.append((hs.detach(), grads))
            (hs, grads), (hs_t, grads_t) = results
            names = [n for n, _ in mod.named_parameters()]
            whh_grads = [gr for n, gr in zip(names, grads[1:]) if n.startswith("weight_hh")]
            if hs.dtype != torch.bfloat16 or grads[0].dtype != torch.bfloat16 or not all(
                    torch.equal(gr, gr.to(torch.bfloat16).float()) for gr in whh_grads):
                raise AssertionError("the bf16 LSTM's hs and dx are not bf16, or whh's "
                                     "gradient holds values bf16 cannot")
            errs = {"hs": rel_err(hs, hs_t), "dx": rel_err(grads[0], grads_t[0]),
                    "dweights": max(rel_err(a, w) for a, w in zip(grads[1:], grads_t[1:]))}
            log(f"  bf16 LSTM H=128 D={d} on x[128, 192, 64]: kernels vs twins {errs}")
            if not (max(errs["hs"], errs["dx"]) <= BF16_OUT_TOL
                    and errs["dweights"] <= BF16_GRAD_TOL):
                raise AssertionError(f"the bf16 LSTM disagrees with its twin: {errs}")
            out[f"lstm_D{d}"] = errs
        xc, w, bb, scale, bias, g = conv_case(gen, 64)
        xc, g = xc.to(torch.bfloat16), g.to(torch.bfloat16)
        results = []
        for twin in (False, True):
            leaves = [xc.clone().requires_grad_()] + [
                v.clone().requires_grad_() for v in (w, bb, scale, bias)]
            if twin:
                y = fused_basic_block_reference(leaves[0].float(), *leaves[1:],
                                                CONV_DROP.seed, 64, CONV_DROP.drop_p,
                                                True).to(torch.bfloat16)
            else:
                y = fused_basic_block(leaves[0], *leaves[1:], CONV_DROP.seed, 64,
                                      CONV_DROP.drop_p, True)
            results.append((y.detach(), torch.autograd.grad(y, leaves, g)))
        (y, grads), (y_t, grads_t) = results
        if y.dtype != torch.bfloat16 or grads[0].dtype != torch.bfloat16 or any(
                gr.dtype != torch.float32 for gr in grads[1:]):
            raise AssertionError("the bf16 conv block's out and dx are not bf16, or its "
                                 "weight gradients not f32")
        errs = {"out": rel_err(y, y_t), "dx": rel_err(grads[0], grads_t[0]),
                "dweights": max(rel_err(a, w_) for a, w_ in zip(grads[1:], grads_t[1:]))}
        log(f"  bf16 fused conv block K=64, dropout 0.2: kernels vs twins {errs}")
        if not (max(errs["out"], errs["dx"]) <= BF16_OUT_TOL
                and errs["dweights"] <= BF16_GRAD_TOL):
            raise AssertionError(f"the bf16 conv block disagrees with its twin: {errs}")
        out["conv_K64"] = errs
    return out


def bf16_step_errors(got: dict, want: dict) -> dict:
    """``got`` against ``want``, two bf16 ``step_grads`` on two devices, held
    to the agreed whole-step limits: each loss within ``BF16_STEP_LOSS_TOL``
    relative; each gradient within ``BF16_STEP_GRAD_TOL`` of max(its largest
    value, ``BF16_STEP_GRAD_FLOOR`` x the largest gradient); the bank's rows
    and the running statistics within ``BF16_STEP_STATE_TOL``."""
    loss_err = max(abs(got["losses"][k] - v) / max(abs(v), 1e-6)
                   for k, v in want["losses"].items())
    top = max(float(g.abs().max()) for g in want["grads"])
    rel = {n: float((a - b).abs().max()) / max(float(b.abs().max()), BF16_STEP_GRAD_FLOOR * top)
           for n, a, b in zip(want["names"], got["grads"], want["grads"])}
    buffer_errs = {n: float((got["buffers"][n] - b).abs().max()) / max(1.0, float(b.abs().max()))
                   for n, b in want["buffers"].items()}
    return {"loss_err": loss_err, "grad_err": max(rel.values()),
            "grad_err_leaf": max(rel, key=rel.get), "grad_err_by_leaf": rel,
            "state_err": max(buffer_errs.values(), default=0.0)}


def bf16_card_vs_cpu_step(cfg, host_batch, fused: bool = False, name: str = "",
                          n_batches: int = 1) -> dict:
    """One bf16 train step at batch 8, dropout on, card against CPU (same
    weights, batch and masks), with cuBLAS's f32 sums, on each of
    ``n_batches`` batches of 8 rows of ``host_batch``: every loss and the
    state held by ``bf16_step_errors`` on every batch, each gradient at the
    median of its error over the batches (one batch: its error).  For the
    batch with the largest error, that leaf on both devices against the
    CPU's float64 step (a record, not a limit)."""
    runs, worst = [], None
    with f32_sums():
        for i in range(n_batches):
            rows = {k: v[8 * i:] for k, v in host_batch.items()}
            steps = {dev: step_grads(cfg, rows, dev, fused=fused, compute_dtype=torch.bfloat16)
                     for dev in ("cuda", "cpu")}
            runs.append(bf16_step_errors(steps["cuda"], steps["cpu"]))
            if worst is None or runs[-1]["grad_err"] > runs[worst[0]]["grad_err"]:
                worst = (i, rows, steps)
    by_leaf = {n: statistics.median(r["grad_err_by_leaf"][n] for r in runs)
               for n in runs[0]["grad_err_by_leaf"]}
    errs = {"batches": n_batches,
            "loss_err": max(r["loss_err"] for r in runs),
            "grad_err": max(by_leaf.values()), "grad_err_leaf": max(by_leaf, key=by_leaf.get),
            "state_err": max(r["state_err"] for r in runs),
            "worst_leaf_by_batch": [[r["grad_err_leaf"], r["grad_err"]] for r in runs]}
    if n_batches > 1:
        i, rows, steps = worst
        exact = step_grads(cfg, rows, "cpu", dtype=torch.float64, fused=fused)
        leaf = runs[i]["grad_err_leaf"]
        errs["largest_vs_float64"] = {
            "batch": i, "leaf": leaf,
            **{f"{dev}_vs_float64": bf16_step_errors(steps[dev], exact)["grad_err_by_leaf"][leaf]
               for dev in ("cuda", "cpu")}}
    log(f"  bf16 step at batch 8{', fused' if fused else ''}{', ' + name if name else ''}, "
        f"card vs CPU: {json.dumps(errs)} (losses {BF16_STEP_LOSS_TOL:g}; gradients "
        f"{BF16_STEP_GRAD_TOL:g} of max(leaf, {BF16_STEP_GRAD_FLOOR:g} x largest), the "
        f"median over {n_batches} batch(es); state {BF16_STEP_STATE_TOL:g})")
    if not (errs["loss_err"] <= BF16_STEP_LOSS_TOL and errs["grad_err"] <= BF16_STEP_GRAD_TOL
            and errs["state_err"] <= BF16_STEP_STATE_TOL):
        raise AssertionError(f"the card's bf16 step disagrees with the CPU's: {errs}")
    return errs


BF16_FLAGS = ["--compute_dtype", "bfloat16"]


def bf16_train_path(data_dir: str, cfg, host_batch, f32_step_ms: float) -> dict:
    """The flagship's command line with ``--compute_dtype bfloat16`` on the
    card: ``cli.main`` on the device store, 2 epochs, then the evaluation
    suite; exactly 10/10/2/2 launches of #1-#4 a train step with every #1
    and #2 of training in its bf16 instantiation and none in validation or
    the suite; every loss finite; ``args.txt`` keeps the mode and
    ``--only_evaluate`` evaluates float32.  Both data paths again on cuDNN's
    deterministic algorithms (losses within ``HOST_DEVICE_TOL``); the
    epoch-2 median step beside the float32 run's (``f32_step_ms``) and 3
    device-mode steps profiled (the steps at batch 8 are ``bf16_step_path``'s)."""
    with instrumented() as seen:
        zero_counts()
        t0 = time.perf_counter()
        if cli.main(["--data_dir", data_dir, "--epochs", "2", "--results_folder",
                     os.path.join(RUN_DIR, "bf16"), *BF16_FLAGS], device="cuda") != 0:
            raise AssertionError("the bf16 run returned non-zero")
        run_s = time.perf_counter() - t0
        dev = seen["trainers"][-1]
        saved = TrainConfig.load(os.path.join(dev.results_dir, "args.txt"))
        if not (dev.device_data and dev.cfg.compute_dtype == saved.compute_dtype == "bfloat16"):
            raise AssertionError("the bf16 run did not train on the device store in bf16")
        n_train, n_val = seen["steps"]
        want = two_epoch_launches(n_train, n_val)
        want_bf16 = dict.fromkeys(bf16_counts(), 0)
        want_bf16.update(fused_transformer_block=2 * 10 * n_train,
                         fused_block_backward=2 * 10 * n_train)
        launches, launches_bf16 = seen["train_launches"], seen["train_launches_bf16"]
        log(f"bf16 run: {n_train} train and {n_val} validation steps an epoch in {run_s:.1f} s; "
            f"training's launches {launches}, in the bf16 instantiation {launches_bf16}")
        if launches != want or launches_bf16 != want_bf16:
            raise AssertionError(f"bf16 run: launches {launches} / bf16 {launches_bf16}, want "
                                 f"{want} / {want_bf16}")
        suite = seen["eval"][-1]
        calls = suite["encoder_calls"]
        want_eval = dict.fromkeys(want, 0)
        want_eval.update(fused_transformer_block=10 * calls["eeg"],
                         lstm_scan_packed=2 * calls["speech"])
        if suite["launches"] != want_eval or any(suite["launches_bf16"].values()):
            raise AssertionError(f"bf16 run's evaluation suite: launches {suite['launches']} "
                                 f"(bf16 {suite['launches_bf16']}), want {want_eval} in float32")
        values, phases = read_loss_txt(dev.loss_file, "device")
        eval_files = check_eval_files(dev.results_dir)
        step_ms = statistics.median(dev.history[1]["step_s"]) * 1e3
        log(f"  every loss of loss.txt finite, evaluation suite in {suite['wall_s']:.1f} s in "
            f"float32 ({calls} encoder calls), files finite; epoch-2 median train step "
            f"{step_ms:.2f} ms in bf16 against {f32_step_ms:.2f} ms in float32 (host clock, "
            f"cuBLAS's default bf16 sums)")

        zero_counts()
        if cli.main(["--only_evaluate", "yes", "--results_folder", dev.results_dir],
                    device="cuda") != 0:
            raise AssertionError("--only_evaluate of the bf16 run returned non-zero")
        if any(bf16_counts().values()) or not counts()["fused_transformer_block"]:
            raise AssertionError(f"--only_evaluate of the bf16 run launched {counts()}, bf16 "
                                 f"{bf16_counts()}: want float32 blocks only")
        check_eval_files(dev.results_dir)

        paired = {}
        with deterministic_cudnn():
            for mode in ("device", "host"):
                if cli.main(["--data_dir", data_dir, "--epochs", "2", "--data_mode", mode,
                             "--skip_eval", "yes", *BF16_FLAGS, "--results_folder",
                             os.path.join(RUN_DIR, f"bf16_{mode}")], device="cuda") != 0:
                    raise AssertionError(f"the bf16 {mode}-mode run returned non-zero")
                paired[mode], _ = read_loss_txt(seen["trainers"][-1].loss_file, mode)
        host = seen["trainers"][-1]
        loss_rel = max(abs(a - b) / max(abs(b), 1e-30)
                       for a, b in zip(paired["device"], paired["host"]))
        log(f"  bf16 device vs host data path on cuDNN's deterministic algorithms: max relative "
            f"difference of {len(paired['device'])} losses {loss_rel:.3e} (tol "
            f"{HOST_DEVICE_TOL:g})")
        if not loss_rel <= HOST_DEVICE_TOL:
            raise AssertionError(f"bf16 losses differ: {paired}")

        # where a bf16 device-mode step's time goes
        ds = host.train_dataset
        store = DeviceChunkStore(ds, device="cuda", prefetch=False)
        key = next(k for k in ds.batches_keys if "eeg" in ds.chunks[k])
        eeg_c, sp_c, ids_c, _, _ = store.get(key)
        idx_m, subs_m = ds.create_eeg_indices(ds.chunks[key]["eeg"])
        idx, subs = (torch.from_numpy(np.asarray(m[0], np.int64)).to("cuda")
                     for m in (idx_m, subs_m))
        run_step = lambda: chunk_train_step(host.model, host.optimizer, eeg_c,  # noqa: E731
                                            sp_c, ids_c, idx, subs, cfg.seed + 1, False,
                                            compute_dtype="bfloat16")
        run_step()
        profile = profile_calls(run_step, reps=3, top=16)
        store.release()
        log(f"  3 bf16 device-mode steps profiled: {json.dumps(profile)}")
    result = {"run_s": run_s, "train_steps_per_epoch": n_train, "val_steps_per_epoch": n_val,
              "launches_train": launches, "launches_train_bf16": launches_bf16,
              "launches_eval": suite["launches"], "eval_suite_s": suite["wall_s"],
              "eval_files": eval_files, "losses": values, "phases_device": phases,
              "step_ms_median_epoch2": step_ms, "f32_step_ms_median_epoch2": f32_step_ms,
              "step_ms_all_epoch2": [v * 1e3 for v in dev.history[1]["step_s"]],
              "host_vs_device_loss_rel": loss_rel, "profile_3_device_steps": profile}
    log(json.dumps({"bf16_train": result}))
    return result


def bf16_step_path(cfg, host_batch) -> dict:
    """One bf16 train step at batch 8, card against CPU (``bf16_card_vs_cpu_step``),
    for the flagship and its fused variant on ``BF16_STEP_BATCHES`` batches
    of ``host_batch`` and for Z1-Z5 on one."""
    steps = {"flagship": bf16_card_vs_cpu_step(cfg, host_batch, name="flagship",
                                               n_batches=BF16_STEP_BATCHES),
             "fused": bf16_card_vs_cpu_step(cfg, host_batch, fused=True, name="flagship",
                                            n_batches=BF16_STEP_BATCHES)}
    rng = np.random.default_rng(7)
    for z in ("Z1", "Z2", "Z3", "Z4", "Z5"):
        zcfg = TrainConfig(**ZOO[z], bank_size=BANK_SIZE)
        t = zcfg.window_length
        batch = {"eeg": rng.standard_normal((8, t, 64)).astype(np.float32),
                 "speech": rng.standard_normal((8, t, zcfg.speech_dimension)).astype(np.float32),
                 "ids": np.arange(1, 9, dtype=np.int64)}
        steps[z] = bf16_card_vs_cpu_step(zcfg, batch, name=z)
    log(json.dumps({"bf16_steps": steps}))
    return {"card_vs_cpu_steps": steps}


# LSTM widths off the 4 ... 128 the kernels were first built for (ROADMAP §3
# K1), each at the registry's full widths: the flags, #1-#4's launches per
# train step, and the dtype of the CPU step the card's is held against.
# --lstm_units sizes the double_lstm encoders' LSTMs (D=1): 256 runs the
# H=256 instantiation, 100 runs padded to 128; --latent_dim 4 gives the
# flagship's second biLSTM H=2, padded to 4
K1 = {
    "lstm_units_256": (dict(eeg_encoder="double_lstm", speech_encoder="double_lstm",
                            model_arch="clip_kld_latent_proj", lstm_units=256), (0, 0, 4, 4),
                       torch.float32),
    "lstm_units_100": (dict(eeg_encoder="double_lstm", speech_encoder="double_lstm",
                            model_arch="clip_kld_latent_proj", lstm_units=100), (0, 0, 4, 4),
                       torch.float32),
    "latent_dim_4": (dict(latent_dim=4), (10, 10, 2, 2), torch.float32),
}


# LSTM widths past 256 (ROADMAP §3 K2), run by the wide kernels.
# --lstm_units sizes the double_lstm encoders' LSTMs (D=1): 512 and 1024.
# The convLSTM encoders fix their first biLSTM at 128 units whatever
# --lstm_units says (JAX models/registry.py:66-68, 157-159); their second
# biLSTM is --latent_dim // 2 wide, so --latent_dim 1024 runs the default
# model with its speech encoder's second biLSTM at H=512 (D=2).  The card's
# float32 step at --lstm_units 1024 is held against the CPU's step in
# float64 (at STEP_TOL, as every step): there the float32 step is
# ill-conditioned in the heads' last biases at batch 8 (the CPU's float32
# gradient of eeg_mu_linear.last_linear.bias is 6.17e-4 of its largest value
# from its float64 one), so two float32 steps differ by up to twice that;
# the CPU's float32 spread is reported beside it
K2 = {
    "lstm_units_512": (dict(eeg_encoder="double_lstm", speech_encoder="double_lstm",
                            model_arch="clip_kld_latent_proj", lstm_units=512), (0, 0, 4, 4),
                       torch.float32),
    "latent_dim_1024": (dict(latent_dim=1024), (10, 10, 2, 2), torch.float32),
    "lstm_units_1024": (dict(eeg_encoder="double_lstm", speech_encoder="double_lstm",
                             model_arch="clip_kld_latent_proj", lstm_units=1024), (0, 0, 4, 4),
                        torch.float64),
}
K2_SERVED = "lstm_units_512"


def width_path(data_dir: str, configs: dict, tag: str) -> dict:
    """Each configuration of ``configs`` (``K1`` or ``K2``): one train step
    at batch 8, dropout on, card against the CPU's step in the entry's dtype
    (``STEP_TOL``; beside a float64 one, the CPU's float32 spread); then ``cli.main
    --epochs 1 --skip_eval yes`` on the fixture on the card with the exact
    launches of #1-#4 and a finite validation loss.  Each run's entry names
    its results directory (``results_dir``)."""
    t_start = time.perf_counter()
    out = {}
    rng = np.random.default_rng(8)
    with instrumented() as seen:
        for name, (flags, per_step, ref_dtype) in configs.items():
            cfg = TrainConfig(**flags, bank_size=BANK_SIZE)
            t = cfg.window_length
            batch = {"eeg": rng.standard_normal((8, t, 64)).astype(np.float32),
                     "speech": rng.standard_normal((8, t, cfg.speech_dimension)).astype(
                         np.float32),
                     "ids": np.arange(1, 9, dtype=np.int64)}
            step = card_vs_cpu_step(cfg, batch, name=f"{name} {flags}", ref_dtype=ref_dtype)
            del step["grad_err_by_leaf"]
            argv = ["--data_dir", data_dir, "--epochs", "1", "--skip_eval", "yes",
                    "--results_folder", os.path.join(RUN_DIR, tag, name)]
            for k, v in flags.items():
                argv += [f"--{k}", str(v)]
            zero_counts()
            if cli.main(argv, device="cuda") != 0:
                raise AssertionError(f"{name}: cli.main returned non-zero")
            torch.cuda.synchronize()
            trainer = seen["trainers"][-1]
            n_train, n_val = steps_per_epoch(trainer)
            launches, want = counts(), step_launches(per_step, n_train, n_val)
            val = trainer.history[0]["val_loss_ce"]
            step_ms = statistics.median(trainer.history[0]["step_s"]) * 1e3
            log(f"{name} {flags}: trained 1 epoch on the card ({n_train} train, {n_val} "
                f"validation steps), median step {step_ms:.2f} ms, launches {launches}, "
                f"validation loss_ce {val:.4f}")
            if launches != want or not np.isfinite(val):
                raise AssertionError(f"{name}: launches {launches}, want {want}; val {val}")
            trainer.release_host_data()
            out[name] = {"flags": flags, "step": step, "launches": launches,
                         "step_ms_median": step_ms, "val_loss_ce": val,
                         "results_dir": trainer.results_dir}
    out["seconds"] = time.perf_counter() - t_start
    log(f"{tag.upper()} phase: {out['seconds']:.1f} s")
    return out


def k1_path(data_dir: str) -> dict:
    """The ``K1`` widths through :func:`width_path`."""
    out = width_path(data_dir, K1, "k1")
    log(json.dumps({"k1": out}))
    return out


def k2_path(data_dir: str) -> dict:
    """The ``K2`` widths through :func:`width_path`, then the
    ``--lstm_units 512`` run served from its results directory: one
    128-window chunk of each side, card against CPU (``SERVE_TOL``), with
    exactly 2 launches of #3 a chunk (the two LSTMs of each double_lstm
    encoder) and none of the others."""
    out = width_path(data_dir, K2, "k2")
    results_dir = out[K2_SERVED]["results_dir"]
    cfg = TrainConfig.load(os.path.join(results_dir, "args.txt"))
    rng = np.random.default_rng(9)
    eeg = rng.standard_normal((128, cfg.window_length, 64)).astype(np.float32)
    speech = rng.standard_normal((128, cfg.window_length, cfg.speech_dimension)).astype(
        np.float32)
    sessions = {dev: InferenceSession.from_results_dir(results_dir, device=dev)
                for dev in ("cuda", "cpu")}
    zero_counts()
    emb = {"cuda": (sessions["cuda"].embed_eeg(eeg), sessions["cuda"].embed_speech(speech))}
    served = counts()
    emb["cpu"] = (sessions["cpu"].embed_eeg(eeg), sessions["cpu"].embed_speech(speech))
    errs = {side: float(np.abs(emb["cuda"][i] - emb["cpu"][i]).max())
            for i, side in enumerate(("eeg", "speech"))}
    want = dict.fromkeys(served, 0)
    want["lstm_scan_packed"] = 4  # 2 LSTMs a double_lstm encoder, one chunk each side
    log(f"{K2_SERVED} served by from_results_dir, one 128-window chunk each side, card vs "
        f"CPU: max_abs_err {errs} (tol {SERVE_TOL:g}); launches {served}")
    if not max(errs.values()) <= SERVE_TOL or served != want:
        raise AssertionError(f"{K2_SERVED} serving: errors {errs}, launches {served}, "
                             f"want {want}")
    out[K2_SERVED].update(served_err=errs, served_launches=served)
    log(json.dumps({"k2": out}))
    return out


CV_FOLDS = ["0", "1", "2", "3", "4"]  # the fixture's 6 stories: one per fold, then the test set
CV_ISOLATED_FOLD = 2
# the deterministic isolation and group runs: 2 epochs on folds 0-2 (fold 2
# among others, a best epoch to choose per fold) keep every check of the 5
# folds with 3/5 of their training steps
CV_DET_FOLDS = ["0", "1", "2"]


@contextlib.contextmanager
def phase_launches():
    """The runs inside, kernel launch counts by phase: ``FoldParallelTrainer``
    and ``Trainer`` count from 0 at ``fit`` and are read (with each fold's
    train and validation steps an epoch) at ``release_host_data``; each
    evaluation suite counts from 0 and is read at its end, with its encoder
    calls.  Yields ``seen``: ``train`` and ``eval`` records."""
    from transformer_clip_eeg_tpu_torch.train.fold_parallel import FoldParallelTrainer

    seen: dict = {"train": [], "eval": []}
    classes = (Trainer, FoldParallelTrainer)
    real = {c: (c.fit, c.release_host_data) for c in classes}
    real_suite = cli.run_eval_suite

    def fit(cls):
        def wrapped(self):
            zero_counts()
            return real[cls][0](self)
        return wrapped

    def release(cls):
        def wrapped(self):
            torch.cuda.synchronize()
            if cls is Trainer:
                steps = [steps_per_epoch(self)]
            else:  # a fold's steps: the rows of its train and val chunks
                chunks = [(k.rsplit("_batch_", 1)[0], c["eeg"].shape[0])
                          for k, c in self.dataset.chunks.items() if "eeg" in c]
                steps = [[sum(n for st, n in chunks if st in member[j])
                          for member in (self.train_stories, self.val_stories)]
                         for j in range(len(self.folds))]
            seen["train"].append({"launches": counts(), "launches_bf16": bf16_counts(),
                                  "steps": steps,
                                  "chunks": None if cls is Trainer else len(chunks)})
            real[cls][1](self)
        return wrapped

    def suite(model, *args, **kw):
        zero_counts()
        calls = {"eeg": 0, "speech": 0}
        hooks = [getattr(model, m).register_forward_pre_hook(
            lambda *_, k=k: calls.__setitem__(k, calls[k] + 1))
            for m, k in (("eegModel", "eeg"), ("speechModel", "speech"))]
        t0 = time.perf_counter()
        try:
            real_suite(model, *args, **kw)
            torch.cuda.synchronize()
        finally:
            for h in hooks:
                h.remove()
        seen["eval"].append({"wall_s": time.perf_counter() - t0, "launches": counts(),
                             "launches_bf16": bf16_counts(), "encoder_calls": calls,
                             "results_dir": args[1]})

    for c in classes:
        c.fit, c.release_host_data = fit(c), release(c)
    cli.run_eval_suite = suite
    try:
        yield seen
    finally:
        for c in classes:
            c.fit, c.release_host_data = real[c]
        cli.run_eval_suite = real_suite


def _sum_launches(records) -> dict:
    out = dict.fromkeys(counts(), 0)
    for r in records:
        for k, v in r["launches"].items():
            out[k] += v
    return out


def _check_suites(records, n: int) -> dict:
    """``n`` evaluation suites, each with 10 block forwards per EEG-encoder
    call, 2 LSTM forwards per speech-encoder call and nothing else, every
    evaluation file finite; returns their launches summed."""
    if len(records) != n:
        raise AssertionError(f"{len(records)} evaluation suites ran, want {n}")
    for r in records:
        calls = r["encoder_calls"]
        want = dict.fromkeys(counts(), 0)
        want.update(fused_transformer_block=10 * calls["eeg"],
                    lstm_scan_packed=2 * calls["speech"])
        if r["launches"] != want or not (calls["eeg"] and calls["speech"]):
            raise AssertionError(f"suite in {r['results_dir']}: launches {r['launches']}, "
                                 f"want {want}")
        check_eval_files(r["results_dir"])
    return _sum_launches(records)


CV_EPOCH = re.compile(r"^epoch (\d+): train loss_ce \[([^]]+)\] val loss_ce \[([^]]+)\] "
                      r"\((\d+) pairs/s aggregate\)$")


def read_cv_loss_txt(path: str, n_folds: int, epochs: int):
    """A fold-parallel run's root ``loss.txt``: per epoch the folds' train
    and val CE (to 4 places, finite), its aggregate pairs/s and its phases."""
    rows, phases = [], []
    for line in open(path).read().splitlines():
        m = CV_EPOCH.match(line)
        if m:
            tr, va = (np.array(g.split(), float) for g in (m[2], m[3]))
            if len(tr) != n_folds or len(va) != n_folds or not np.isfinite([*tr, *va]).all():
                raise AssertionError(f"{path}: {line!r}")
            rows.append({"train": tr.tolist(), "val": va.tolist(), "pairs_per_s": int(m[4])})
        elif " phases " in line:
            phases.append(json.loads(line.split(" phases ", 1)[1]))
    if len(rows) != epochs or len(phases) != epochs:
        raise AssertionError(f"{path}: {len(rows)} epoch lines and {len(phases)} phases, "
                             f"want {epochs}")
    return rows, phases


def cv_path(data_dir: str) -> dict:
    """The cross-validation driver on the card (``cv.main``) at the flagship's
    widths on the fixture (6 stories: folds 0-4 hold one each, the last is
    the test set): (1) ``--parallel yes`` over folds 0-4, 2 epochs, with the
    evaluation suites: ``cv_summary.json`` with 5 folds and every number
    finite, exact launches, one upload per union chunk (not per fold), the
    aggregate pairs/s; (2) fold 2 alone, timed; (3) on cuDNN's
    deterministic algorithms, each in a fresh process, 2 epochs, folds 0-2,
    fold 2 alone and folds 0-2 in groups of one: fold 2's CE every epoch
    and its best weights equal, and the groups equal the ungrouped run, bit
    for bit; (4) ``--parallel no
    --folds 0 1 --epochs 1``; (5) one fold-parallel chunk under the profiler;
    host RSS around the final heap trim."""
    from transformer_clip_eeg_tpu_torch import cv
    from transformer_clip_eeg_tpu_torch.train.fold_parallel import FoldParallelTrainer
    from transformer_clip_eeg_tpu_torch.utils.platform import host_rss_gb

    t_start = time.perf_counter()
    root = os.path.join(RUN_DIR, "cv")
    rss = []
    real_trim = cv.trim_host_heap

    def trim():
        before = host_rss_gb()
        real_trim()
        rss.append((before, host_rss_gb()))

    def run(name: str, *flags: str):
        results = os.path.join(root, name)
        t0 = time.perf_counter()
        if cv.main(["--data_dir", data_dir, "--results_folder", results, *flags],
                   device="cuda") != 0:
            raise AssertionError(f"cv {name}: cv.main returned non-zero")
        with open(os.path.join(results, "cv_summary.json")) as f:
            return results, json.load(f), time.perf_counter() - t0

    out = {}
    cv.trim_host_heap = trim
    try:
        with phase_launches() as seen:
            # (1) the 5 folds in one run, with the evaluation suites
            results, summary, wall_s = run("parallel", "--parallel", "yes", "--folds",
                                           *CV_FOLDS, "--epochs", "2")
            train_rec = seen["train"][-1]
            nums = _numbers(summary)
            if set(summary["folds"]) != set(CV_FOLDS) or not nums or \
                    not all(np.isfinite(nums)) or summary["mm_accuracy_mean_over_folds"] is None:
                raise AssertionError(f"cv_summary.json: {summary}")
            for f in CV_FOLDS:
                if set(summary["folds"][f]) != {"results_dir", "mm_accuracy_mean",
                                                "regression_loss_mean"}:
                    raise AssertionError(f"cv_summary.json fold {f}: {summary['folds'][f]}")
            steps = train_rec["steps"]
            n_train, n_val = (sum(s[i] for s in steps) for i in (0, 1))
            want = two_epoch_launches(n_train, n_val)
            if train_rec["launches"] != want:
                raise AssertionError(f"cv parallel training launches {train_rec['launches']}, "
                                     f"want {want} (folds' steps {steps})")
            eval_launches = _check_suites(seen["eval"], len(CV_FOLDS))
            rows, phases = read_cv_loss_txt(os.path.join(results, "loss.txt"), 5, 2)
            uploads, union = [p["uploads"] for p in phases], train_rec["chunks"]
            log(f"cv --parallel yes, folds {CV_FOLDS}, 2 epochs, suites: {wall_s:.1f} s; folds' "
                f"train/val steps an epoch {steps}; training launches {train_rec['launches']}; "
                f"{len(seen['eval'])} suites, launches {eval_launches}; epochs {rows}; "
                f"uploads per epoch {uploads}; summary {summary['mm_accuracy_mean_over_folds']}")
            if uploads != [union, 0]:
                raise AssertionError(f"uploads per epoch {uploads}: want each of the union's "
                                     f"{union} chunks once in epoch 0 and none in epoch 1 "
                                     f"(not once per fold)")
            out["parallel"] = {"wall_s": wall_s, "epochs": rows, "phases": phases,
                               "fold_steps": steps, "union_chunks": union,
                               "launches_train": train_rec["launches"],
                               "launches_eval": eval_launches, "summary": summary}
            parallel_launches = {k: train_rec["launches"][k] + eval_launches[k]
                                 for k in eval_launches}
            parallel_bf16 = train_rec["launches_bf16"]

            # (2) fold 2 alone, timed beside the 5 folds
            solo_results, _, _ = run("solo", "--parallel", "yes", "--folds",
                                     str(CV_ISOLATED_FOLD), "--epochs", "2", "--skip_eval",
                                     "yes")
            solo_rows, _ = read_cv_loss_txt(os.path.join(solo_results, "loss.txt"), 1, 2)
            agg, alone = rows[1]["pairs_per_s"], solo_rows[1]["pairs_per_s"]
            log(f"epoch-2 pairs/s: 5 folds {agg} aggregate, fold {CV_ISOLATED_FOLD} alone "
                f"{alone} ({agg / alone:.2f}x)")
            out["pairs_per_s_epoch2"] = {"aggregate_5_folds": agg, "one_fold_alone": alone}

            # (3) isolation and fold groups, bit for bit on deterministic cuDNN,
            # each run the first of a fresh process (see det_cv_run)
            det = {name: det_cv_run(os.path.join(root, name), data_dir, folds, *flags)
                   for name, folds, flags in (
                       ("det_all", CV_DET_FOLDS, ()),
                       ("det_solo", [str(CV_ISOLATED_FOLD)], ()),
                       ("det_g1", CV_DET_FOLDS, ("--fold_group_size", "1")))}
            j = CV_DET_FOLDS.index(str(CV_ISOLATED_FOLD))
            iso = fold_differences(det["det_all"], j, det["det_solo"], 0)
            groups = [fold_differences(det["det_all"], i, det["det_g1"], i)
                      for i in range(len(CV_DET_FOLDS))]
            if iso["epochs"] != 2:
                raise AssertionError(f"the isolation runs trained {iso['epochs']} epochs, not 2")
            log(f"deterministic cuDNN: fold {CV_ISOLATED_FOLD} among folds {CV_DET_FOLDS} vs "
                f"alone: {iso}; "
                f"groups of 1 vs ungrouped, per fold: {groups}")
            if iso["max_loss_diff"] or iso["max_param_diff"] or \
                    any(g["max_loss_diff"] or g["max_param_diff"] for g in groups):
                raise AssertionError("fold isolation or fold groups: not bit for bit")
            out["isolation"] = iso
            out["groups"] = groups
            del det

            # (4) sequential folds
            _, seq_summary, seq_s = run("sequential", "--parallel", "no", "--folds", "0", "1",
                                        "--epochs", "1")
            seq_train = seen["train"][-2:]
            seq_eval = seen["eval"][-2:]
            if set(seq_summary["folds"]) != {"0", "1"} or \
                    not all(np.isfinite(_numbers(seq_summary))):
                raise AssertionError(f"sequential cv_summary.json: {seq_summary}")
            for r in seq_train:
                (n_tr, n_va), = r["steps"]
                want = {k: v // 2 for k, v in two_epoch_launches(n_tr, n_va).items()}
                if r["launches"] != want:
                    raise AssertionError(f"sequential fold: launches {r['launches']}, "
                                         f"want {want}")
            seq_eval_launches = _check_suites(seq_eval, 2)
            sequential_launches = {k: v + seq_eval_launches[k]
                                   for k, v in _sum_launches(seq_train).items()}
            log(f"cv --parallel no --folds 0 1 --epochs 1: {seq_s:.1f} s, summary "
                f"{seq_summary['mm_accuracy_mean_over_folds']}, launches {sequential_launches}")
            out["sequential"] = {"wall_s": seq_s, "summary": seq_summary,
                                 "launches": sequential_launches}
            bf16_total = sum(parallel_bf16.values()) + sum(
                v for r in seq_train + seq_eval for v in r["launches_bf16"].values())
            if bf16_total:
                raise AssertionError(f"the f32 cv runs launched bf16 kernels: {bf16_total}")
    finally:
        cv.trim_host_heap = real_trim

    # (5) one fold-parallel chunk under the profiler: its rows for all 5 folds
    cfg = TrainConfig(data_dir=data_dir)
    files = cv_split(cfg, 0)
    trainer = FoldParallelTrainer(cfg, [int(f) for f in CV_FOLDS], sorted(files[0] + files[1]),
                                  sorted(files[4] + files[5]), os.path.join(root, "profile"),
                                  device="cuda")
    key = trainer.dataset.batches_keys[0]
    member = [{key.rsplit("_batch_", 1)[0]}] * len(CV_FOLDS)
    active = np.ones(len(CV_FOLDS), bool)
    one_chunk = lambda: trainer._epoch(member, active, train=True)  # noqa: E731
    one_chunk()
    rows_per_chunk = trainer.dataset.chunks[key]["eeg"].shape[0]
    profile = profile_calls(one_chunk, reps=1)
    trainer.release_host_data()
    del trainer
    log(f"one fold-parallel chunk ({rows_per_chunk} rows x {len(CV_FOLDS)} folds = "
        f"{rows_per_chunk * len(CV_FOLDS)} steps) under torch.profiler: "
        f"{json.dumps({k: v for k, v in profile.items() if k != 'top_ops'})}")
    out["profile_one_chunk"] = {**profile, "steps": rows_per_chunk * len(CV_FOLDS)}
    out["rss_gb_around_trims"] = rss
    out["launches"] = {"cv_parallel": parallel_launches, "cv_sequential": sequential_launches}
    out["seconds"] = time.perf_counter() - t_start
    log(f"host RSS around the heap trims (GiB, before and after): {rss}")
    log(f"cv phase: {out['seconds']:.1f} s")
    log(json.dumps({"cv": out}))
    return out


def cv_split(cfg, fold: int):
    from transformer_clip_eeg_tpu_torch.data.discovery import get_train_val_test_files_final

    return get_train_val_test_files_final(cfg.data_dir, fold, cfg.stimulus_features,
                                          cfg.fold_split_path,
                                          cfg.number_of_training_subjects)


# One fold-parallel run of ``cv.main`` on cuDNN's deterministic algorithms
# in a process of its own, which writes fit()'s history to history.json.
# Measured on the card: within one process a later run can land on other
# algorithms of a library than an earlier run (the 4th of four identical
# runs differed by 1-2 ulps of the loss, with torch's deterministic
# algorithms on as well), so the runs held to each other bit for bit each
# start a fresh process.
_DET_CV_RUN = """
import json, sys, torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.deterministic = True
from transformer_clip_eeg_tpu_torch import cv
from transformer_clip_eeg_tpu_torch.train.fold_parallel import FoldParallelTrainer
fit = FoldParallelTrainer.fit
def recorded(self):
    out = fit(self)
    with open(self.results_root + "/history.json", "w") as f:
        json.dump(out["history"], f)
    return out
FoldParallelTrainer.fit = recorded
sys.exit(cv.main(sys.argv[1:]))
"""


# What the cv mesh's runs take to give the same bits in a process that shares
# the card with another: cuDNN off (PyTorch's own convolutions on cuBLAS),
# torch's and cuBLAS's deterministic algorithms.  On an H100 80GB HBM3
# (700 W) cuDNN's deterministic algorithms were not enough there: the
# sharded fold mesh then differed from the unsharded run in the last bits of
# its losses and weights, and with cuDNN off the two agree bit for bit
# (PERF.md section 6)
DETERMINISTIC_TORCH = ("torch.backends.cudnn.enabled = False\n"
                       "torch.use_deterministic_algorithms(True, warn_only=True)\n")
CUBLAS_DETERMINISTIC = ":4096:8"


def det_cv_run(results: str, data_dir: str, folds, *flags: str,
               algorithms: str = "cudnn_deterministic") -> dict:
    """``cv --parallel yes --epochs 2 --skip_eval yes`` over ``folds`` in a
    fresh process on ``algorithms``: ``"cudnn_deterministic"`` (cuDNN's
    deterministic algorithms), ``"strict"`` (cuDNN off, torch's and cuBLAS's
    deterministic algorithms, ``DETERMINISTIC_TORCH``) or ``"default"``
    (what a user's run takes; TF32 off in every mode): its per-epoch history
    and each fold's best checkpoint (weights and bank)."""
    script, env = capped(_DET_CV_RUN), None
    if algorithms == "strict":
        script = script.replace("from transformer_clip_eeg_tpu_torch import cv\n",
                                DETERMINISTIC_TORCH + "from transformer_clip_eeg_tpu_torch "
                                "import cv\n")
        env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=CUBLAS_DETERMINISTIC)
    elif algorithms == "default":
        script = script.replace("torch.backends.cudnn.deterministic = True\n", "")
    elif algorithms != "cudnn_deterministic":
        raise ValueError(f"algorithms {algorithms!r}")
    proc = subprocess.run(
        [sys.executable, "-c", script, "--data_dir", data_dir, "--results_folder",
         results, "--parallel", "yes", "--folds", *folds, "--epochs", "2", "--skip_eval",
         "yes", *flags],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
        timeout=600, env=env)
    if proc.returncode != 0:
        raise AssertionError(f"cv run in {results} exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    with open(os.path.join(results, "history.json")) as f:
        history = json.load(f)
    return {"history": history, "ckpts": fold_checkpoints(results, folds)}


def fold_checkpoints(results: str, folds) -> list:
    """Each fold's best checkpoint (weights and bank) of a cv run."""
    return [torch.load(os.path.join(results, f"fold_{f}", "checkpoints", "model_ckpt.pt"),
                       map_location="cpu", weights_only=True)["model"] for f in folds]


def fold_differences(a: dict, ja: int, b: dict, jb: int) -> dict:
    """Fold ``ja`` of run ``a`` against fold ``jb`` of run ``b``
    (``det_cv_run``): the largest difference of their per-epoch train and
    val CE and of their best weights and bank, the latter also as a share of
    each tensor's largest value in ``b`` (``max_param_rel``, over tensors
    whose largest value is at least ``PARAM_REL_FLOOR``)."""
    loss = max(abs(ea[k][ja] - eb[k][jb])
               for ea, eb in zip(a["history"], b["history"], strict=True)
               for k in ("train_loss_ce", "val_loss_ce"))
    sa, sb = a["ckpts"][ja], b["ckpts"][jb]
    param = max(float((sa[n] - sb[n]).abs().max()) for n in sa)
    rel = max((float((sa[n] - sb[n]).abs().max()) / max(float(sb[n].abs().max()),
                                                        PARAM_REL_FLOOR), n)
              for n in sa if sb[n].is_floating_point() and sb[n].numel())
    return {"max_loss_diff": loss, "max_param_diff": param, "max_param_rel": rel[0],
            "max_param_rel_at": rel[1], "epochs": len(a["history"])}


PARAM_REL_FLOOR = 1e-6  # a tensor's largest value below this counts as this


# --- the reference's model.ckpt (slice 12) -----------------------------------

# ``cli.main --only_evaluate yes`` in a process of its own, on cuDNN's and
# torch's deterministic algorithms (two suites held to each other number for
# number: within one process a later run can land on other algorithms of a
# library), counting the kernels' launches and the encoders' calls of the
# evaluation suite; its last line is that JSON
_ONLY_EVALUATE_RUN = """
import json, sys, torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.deterministic = True
torch.use_deterministic_algorithms(True, warn_only=True)
from transformer_clip_eeg_tpu_torch import cli
from transformer_clip_eeg_tpu_torch.tools import kernel_launches
calls = {"eeg": 0, "speech": 0}
suite = cli.run_eval_suite
def counted(model, *a, **k):
    for m, n in (("eegModel", "eeg"), ("speechModel", "speech")):
        getattr(model, m).register_forward_pre_hook(
            lambda *_, n=n: calls.__setitem__(n, calls[n] + 1))
    return suite(model, *a, **k)
cli.run_eval_suite = counted
rc = cli.main(["--only_evaluate", "yes", "--results_folder", sys.argv[1]])
torch.cuda.synchronize()
launched = kernel_launches()
print(json.dumps({"rc": rc,
                  "launches": {k: v for k, v in launched.items() if not k.endswith("_bf16")},
                  "launches_bf16": {k[:-5]: v for k, v in launched.items() if k.endswith("_bf16")},
                  "encoder_calls": calls}))
"""


def only_evaluate_run(results_dir: str) -> dict:
    """``_ONLY_EVALUATE_RUN`` on ``results_dir``: its printed record, the
    wall time, and the 8 JSON files it wrote."""
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", capped(_ONLY_EVALUATE_RUN), results_dir],
                          cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                          text=True, timeout=600, env=env)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"--only_evaluate on {results_dir} exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    record = json.loads(proc.stdout.strip().splitlines()[-1])
    if record["rc"] != 0 or "loaded model from" not in proc.stdout:
        raise AssertionError(f"--only_evaluate on {results_dir}: {proc.stdout[-2000:]}")
    check_eval_files(results_dir)
    files = {}
    for name in EVAL_JSONS:
        with open(os.path.join(results_dir, name)) as f:
            files[name] = json.load(f)
    return {**record, "wall_s": wall, "files": files}


def state_on_cpu(model) -> dict:
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def equal_states(got: dict, want: dict, what: str) -> None:
    if got.keys() != want.keys():
        raise AssertionError(f"{what}: keys differ {sorted(set(got) ^ set(want))[:10]}")
    bad = [k for k in want if not (got[k].dtype == want[k].dtype
                                    and torch.equal(got[k].cpu(), want[k].cpu()))]
    if bad:
        raise AssertionError(f"{what}: {len(bad)} leaves differ, e.g. {bad[:5]}")


def reference_ckpt_path(results_dir: str, data_dir: str) -> dict:
    """The reference's ``checkpoints/model.ckpt`` on the card (F4 closed),
    from the default run's results: (1) the flagship's ``reference_layout``
    written as a template, the ``torch_export`` CLI in a subprocess writes
    ``model.ckpt`` from the run's checkpoint, imported back every leaf equal
    bit for bit; (2) a results directory holding only ``args.txt`` and
    ``model.ckpt`` and another holding ``args.txt`` and the port's own
    checkpoint, each ``--only_evaluate yes`` in a fresh process on
    deterministic algorithms: the 8 JSON files equal, number for number, and
    the suite's exact launches; (3) ``cli.main --epochs 1 --skip_eval yes``
    into a directory holding only ``model.ckpt``: ``loaded model from``, the
    parameters, bank and batch-norm statistics before the first step equal
    the exported ones bit for bit, training's exact launches; (4) Z1-Z6 at
    full width: export, then import on the card, bit for bit."""
    t_start = time.perf_counter()
    work = os.path.join(RUN_DIR, "reference_ckpt")
    os.makedirs(work)
    cfg = TrainConfig.load(os.path.join(results_dir, "args.txt"))
    saved = ckpt_lib.load_checkpoint(os.path.join(results_dir, "checkpoints"))["model"]
    model = build_model(cfg, cfg.bank_size, device="cuda", seed=cfg.seed)
    model.load_state_dict(saved)
    template = os.path.join(work, "template.ckpt")
    torch.save(torch_export.reference_layout(
        build_model(cfg, cfg.bank_size, device="cpu", seed=cfg.seed + 1)), template)

    # 1. export through the CLI, import back
    ref_dir, own_dir = os.path.join(work, "reference_run"), os.path.join(work, "own_run")
    for d in (ref_dir, own_dir):
        os.makedirs(os.path.join(d, "checkpoints"))
        shutil.copy(os.path.join(results_dir, "args.txt"), d)
    shutil.copy(ckpt_lib.checkpoint_path(os.path.join(results_dir, "checkpoints")),
                os.path.join(own_dir, "checkpoints"))
    ref_ckpt = os.path.join(ref_dir, "checkpoints", ckpt_lib.REFERENCE_CKPT_NAME)
    proc = subprocess.run(
        [sys.executable, "-m", "transformer_clip_eeg_tpu_torch.utils.torch_export", "--run",
         results_dir, "--template", template, "--out", ref_ckpt],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
        timeout=300)
    if proc.returncode != 0 or f"wrote {ref_ckpt}" not in proc.stdout:
        raise AssertionError(f"torch_export exited {proc.returncode}: {proc.stdout[-1000:]} "
                             f"{proc.stderr[-2000:]}")
    exported = torch.load(ref_ckpt, map_location="cpu", weights_only=True)
    merged, report = torch_import.load_torch_state_dict(exported, model)
    if report:
        raise AssertionError(f"importing the exported model.ckpt reported {report}")
    equal_states(merged, saved, "the exported model.ckpt imported back")
    log(f"torch_export CLI: {len(exported)} reference keys ({os.path.getsize(ref_ckpt) / 1e6:.1f} "
        f"MB), imported back: every one of {len(saved)} leaves equal bit for bit")

    # 2. --only_evaluate on the reference directory and on the port's
    own, ref = only_evaluate_run(own_dir), only_evaluate_run(ref_dir)
    differ = [n for n in EVAL_JSONS if own["files"][n] != ref["files"][n]]
    if differ:
        raise AssertionError(f"--only_evaluate from model.ckpt differs from the run's own "
                             f"checkpoint in {differ}")
    calls = ref["encoder_calls"]
    want_eval = dict.fromkeys(counts(), 0)
    want_eval.update(fused_transformer_block=10 * calls["eeg"],
                     lstm_scan_packed=2 * calls["speech"])
    for name, run in (("own", own), ("reference", ref)):
        if run["launches"] != want_eval or run["encoder_calls"] != calls \
                or not (calls["eeg"] and calls["speech"]):
            raise AssertionError(f"--only_evaluate ({name}): launches {run['launches']}, "
                                 f"encoder calls {run['encoder_calls']}, want {want_eval}")
    n_numbers = sum(len(_numbers(f)) for f in ref["files"].values())
    log(f"--only_evaluate yes, fresh processes on deterministic algorithms: from model.ckpt "
        f"{ref['wall_s']:.1f} s, from the port's checkpoint {own['wall_s']:.1f} s; the 8 files "
        f"equal ({n_numbers} numbers); launches {ref['launches']} for {calls} encoder calls")

    # 3. resume from model.ckpt alone, in the run directory cli.main names
    # (its timestamp fixed for the call)
    resume_root = os.path.join(work, "resume")
    resume_dir = os.path.join(resume_root, cfg.results_dir_name("resume"))
    os.makedirs(os.path.join(resume_dir, "checkpoints"))
    shutil.copy(ref_ckpt, os.path.join(resume_dir, "checkpoints"))
    before = {}
    real, strftime = ckpt_lib.restore_torch_checkpoint, time.strftime

    def restore(checkpoint_dir, m):
        out = real(checkpoint_dir, m)
        before["state"] = state_on_cpu(m)
        return out

    ckpt_lib.restore_torch_checkpoint = restore
    time.strftime = lambda *a: "resume"
    out = io.StringIO()
    try:
        with instrumented() as seen, contextlib.redirect_stdout(out):
            zero_counts()
            rc = cli.main(["--data_dir", data_dir, "--epochs", "1", "--skip_eval", "yes",
                           "--results_folder", resume_root], device="cuda")
            torch.cuda.synchronize()
            resume_launches, resume_bf16 = counts(), bf16_counts()
    finally:
        ckpt_lib.restore_torch_checkpoint, time.strftime = real, strftime
    trainer = seen["trainers"][-1]
    if rc != 0 or "loaded model from" not in out.getvalue() or trainer.results_dir != resume_dir:
        raise AssertionError(f"resume from model.ckpt: rc {rc}, {trainer.results_dir}, "
                             f"{out.getvalue()[-1500:]}")
    equal_states(before["state"], saved, "the model before the first resumed step")
    n_train, n_val = steps_per_epoch(trainer)
    want_resume = step_launches((10, 10, 2, 2), n_train, n_val)
    if resume_launches != want_resume:
        raise AssertionError(f"resumed training launched {resume_launches}, want {want_resume}")
    if not os.path.exists(ckpt_lib.checkpoint_path(trainer.checkpoint_dir)):
        raise AssertionError("the resumed run wrote no checkpoint of its own")
    val = trainer.history[0]["val_loss_ce"]
    trainer.release_host_data()  # --skip_eval left its chunk stores on the card
    log(f"resume from model.ckpt alone: 'loaded model from', the {len(saved)} leaves before "
        f"the first step equal the exported ones bit for bit; 1 epoch ({n_train} + {n_val} "
        f"steps) val loss_ce {val:.4f}; launches {resume_launches}")

    # 4. the zoo: export, then import on the card
    zoo = {}
    for z, flags in ZOO.items():
        zcfg = TrainConfig(**flags)
        m = build_model(zcfg, BANK_SIZE, device="cuda", seed=3)
        layout = torch_export.reference_layout(m)
        sd, kept = torch_export.export_state_dict(m, layout)
        merged, report = torch_import.load_torch_state_dict(
            {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, m)
        fresh = build_model(zcfg, BANK_SIZE, device="cuda", seed=4)
        fresh.load_state_dict(merged)
        if report:
            raise AssertionError(f"{z}: the import reported {report}")
        equal_states(state_on_cpu(fresh), state_on_cpu(m), f"{z} exported and imported")
        zoo[z] = {"reference_keys": len(layout), "leaves": len(merged), "kept": len(kept)}
    log(f"Z1-Z6 exported and imported on the card, bit for bit: {json.dumps(zoo)}")
    del model, m, fresh, trainer
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_start
    log(f"reference_ckpt_path in {seconds:.1f} s")
    return {"exported_keys": len(exported), "leaves": len(saved), "eval_numbers": n_numbers,
            "only_evaluate_s": {"reference": ref["wall_s"], "own": own["wall_s"]},
            "encoder_calls": calls, "resume_val_loss_ce": val, "zoo": zoo, "seconds": seconds,
            "launches": {"reference_only_evaluate": ref["launches"],
                         "reference_resume": resume_launches},
            "launches_bf16": {"reference_only_evaluate": ref["launches_bf16"],
                              "reference_resume": resume_bf16}}


# --- wav2vec2 extraction at XLSR-53 width (slice 12) --------------------------

W2V_LAYER = 19          # the reference's tap (ref create_wav2vec.py:109)
W2V_SLAB = 16           # --max_chunk_batch's default
W2V_CHUNK = 10 * 16000  # segment 8 s + overlap 2 s at 16 kHz
W2V_STORIES = {"audiobook_1": 60.0, "audiobook_2": 24.5}  # 24.5 mod 8 = 0.5 s: the tail quirk
W2V_FS = 48000          # the stimuli's rate: the resampler runs
# card vs CPU on the same weights, float32 (TF32 off), 2 chunks to layer 19,
# as a fraction of max |CPU|.  Measured on an H100 80GB HBM3 (700 W): card
# vs CPU 2.01e-6, the CPU's float32 against its float64 6.79e-7, the card's
# 1.98e-6; the limit is 15x the CPU's spread, 5x the card's (PERF.md §2)
W2V_TOL = 1e-5
W2V_BF16_LIMIT = 0.05   # mean |bf16 - f32| / mean |f32|, JAX tests/test_wav2vec_extraction.py:245


def wav2vec_flops(cfg, n_samples: int, tap: int) -> float:
    """Operations of one chunk to ``tap``: the conv stack, the feature
    projection, the positional conv and ``tap`` layers (4 d x d products,
    the FFN, q kᵀ and the attention-weighted sum)."""
    flops, t, c_in = 0.0, n_samples, 1
    for c, k, s in zip(cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride):
        t = (t - k) // s + 1
        flops += 2.0 * c * c_in * k * t
        c_in = c
    d, f = cfg.hidden_size, cfg.intermediate_size
    flops += 2.0 * c_in * d * t
    flops += 2.0 * d * (d // cfg.num_conv_pos_embedding_groups) * cfg.num_conv_pos_embeddings * t
    flops += tap * (2.0 * 4 * d * d * t + 2.0 * 2 * d * f * t + 2.0 * 2 * t * t * d)
    return flops


def expected_frames(cfg, n_samples: int, overlap: int = 2, segment: int = 8,
                    sr: int = 16000, fps: int = 50) -> int:
    """The extraction's rows before the 50 → 64 Hz resample, from the chunk
    arithmetic alone: full chunks keep frames - 2 strip + 1, each tail chunk
    frames - strip, and the loop has no break."""
    def frames(t):
        for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
            t = (t - k) // s + 1
        return t

    half, seg = overlap // 2, segment * sr
    padded = n_samples + half * sr
    strip, rows, tail = half * fps, 0, False
    for i in range(n_samples // seg + 1):
        start = i * seg
        if not tail and start + seg + overlap * sr < padded:
            rows += frames(seg + overlap * sr) - 2 * strip + 1
        else:
            tail = True
            if padded > start:
                rows += max(0, frames(padded - start) - strip)
    return rows


def wav2vec_path() -> dict:
    """The extraction at XLSR-53 width (``Wav2Vec2Config()``: 315 M
    parameters), random weights from seed 0, written as an HF checkpoint
    directory (``config.json``, ``pytorch_model.bin`` with the ``wav2vec2.``
    prefix, the positional conv as ``weight_g``/``weight_v``, an
    ``lm_head``), and two synthetic stories at 48 kHz: the CLI in a
    subprocess writes ``{story}_-_wav2vec_19.npy`` of ``[round(frames * 64 /
    50), 1024]``, finite, frames from the chunk arithmetic; a second run
    (the CLI's ``main`` in this process) skips both stories.  Then, in
    this process (TF32 off): one slab of 16 chunks of 10 s timed by CUDA
    events, under the profiler once, its peak memory and bound; one 60 s
    story through the extractor, host clock; two chunks card against CPU
    float32 (and the CPU's float32 against its
    float64, the spread the limit rests on); the bf16 forward against f32 at
    JAX's limit."""
    from transformer_clip_eeg_tpu_torch.models.wav2vec2 import (
        Wav2Vec2Config,
        Wav2Vec2Model,
        load_wav2vec2,
    )
    from transformer_clip_eeg_tpu_torch.preprocess.wav2vec import Wav2Vec2FeatureExtractor
    from transformer_clip_eeg_tpu_torch.preprocess.wav2vec import main as extraction_main
    from transformer_clip_eeg_tpu_torch.tools.wav2vec_rehearsal import build_model_dir

    t_start = time.perf_counter()
    root = os.path.join(RUN_DIR, "wav2vec")
    model_dir, stim = os.path.join(root, "xlsr53_random"), os.path.join(root, "stimuli", "eeg")
    os.makedirs(stim)
    cfg = Wav2Vec2Config()
    build_model_dir(model_dir, cfg, seed=0)
    with torch.device("meta"):
        n_params = sum(p.numel() for p in Wav2Vec2Model(cfg).state_dict().values())
    bin_gb = os.path.getsize(os.path.join(model_dir, "pytorch_model.bin")) / 1e9
    rng = np.random.default_rng(0)
    for story, seconds in W2V_STORIES.items():
        raw = os.path.join(root, f"{story}.npz")
        n = int(seconds * W2V_FS)
        t = np.arange(n) / W2V_FS
        audio = (0.1 * rng.standard_normal(n) + 0.3 * np.sin(2 * np.pi * 220 * t)).astype(
            np.float32)
        np.savez(raw, audio=audio, fs=W2V_FS)
        with open(raw, "rb") as f_in, gzip.open(os.path.join(stim, f"{story}.npz.gz"),
                                                "wb") as f_out:
            shutil.copyfileobj(f_in, f_out)
    log(f"wav2vec: XLSR-53 width, {n_params / 1e6:.1f} M parameters, pytorch_model.bin "
        f"{bin_gb:.2f} GB; stories {W2V_STORIES} s at {W2V_FS} Hz; written in "
        f"{time.perf_counter() - t_start:.1f} s")

    # the CLI in a subprocess, then its main again in this process (a second
    # process only paid the start-up again), which must skip both stories
    cli_args = ["--dataset_root", root, "--model_path", model_dir, "--layers", str(W2V_LAYER)]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m",
                           "transformer_clip_eeg_tpu_torch.preprocess.wav2vec", *cli_args],
                          cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=600)
    runs = [{"wall_s": time.perf_counter() - t0, "stdout": proc.stdout}]
    if proc.returncode != 0:
        raise AssertionError(f"the extraction CLI exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        rc = extraction_main(cli_args, device="cuda")
    runs.append({"wall_s": time.perf_counter() - t0, "stdout": printed.getvalue()})
    if rc != 0:
        raise AssertionError(f"the extraction CLI's main returned {rc}")
    save_dir = os.path.join(root, "derivatives", "preprocessed_stimuli")
    shapes = {}
    for story, seconds in W2V_STORIES.items():
        path = os.path.join(save_dir, f"{story}_-_wav2vec_{W2V_LAYER}.npy")
        feats = np.load(path)
        frames = expected_frames(cfg, int(round(seconds * W2V_FS / 3)))
        want = (round(frames * 64 / 50), cfg.hidden_size)
        if feats.shape != want or not np.isfinite(feats).all():
            raise AssertionError(f"{path}: {feats.shape}, want {want}, finite")
        shapes[story] = list(feats.shape)
    if runs[0]["stdout"].count("Saved to") != 2 or "Saved to" in runs[1]["stdout"]:
        raise AssertionError(f"the CLI's runs: {runs[0]['stdout'][-800:]} / "
                             f"{runs[1]['stdout'][-800:]}")
    log(f"extraction CLI: {shapes} at 64 Hz, finite; {runs[0]['wall_s']:.1f} s (model load "
        f"included), the second run skipped both stories in {runs[1]['wall_s']:.1f} s")

    # timing, card against CPU, bf16
    zero_counts()
    model = load_wav2vec2(model_dir, device="cuda")
    slab = torch.from_numpy(rng.standard_normal((W2V_SLAB, W2V_CHUNK)).astype(np.float32) * 0.1
                            ).cuda()
    taps = (W2V_LAYER,)
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        slab_ms = time_ms(lambda: model.hidden_states(slab, taps), reps=5, warmup=1)
        peak = torch.cuda.max_memory_allocated()
        profile = profile_calls(lambda: model.hidden_states(slab, taps), reps=1)
        model.dtype = torch.bfloat16
        slab_bf16_ms = time_ms(lambda: model.hidden_states(slab, taps), reps=5, warmup=1)
        model.dtype = torch.float32
    flops = wav2vec_flops(cfg, W2V_CHUNK, W2V_LAYER) * W2V_SLAB
    weight_bytes = 4 * sum(p.numel() for n, p in model.named_parameters()
                           if not n.startswith("encoder.layers.") or
                           int(n.split(".")[2]) < W2V_LAYER)
    slab_bound_ms, slab_bound_by = bound(flops, weight_bytes + slab.numel() * 4
                                         + W2V_SLAB * 499 * cfg.hidden_size * 4)
    s_per_min_slab = slab_ms / 1e3 / (W2V_SLAB * 8) * 60
    story_audio = rng.standard_normal(int(60 * 16000)).astype(np.float32) * 0.1
    extractor = Wav2Vec2FeatureExtractor(model, [W2V_LAYER])
    extractor.get_hidden_output(story_audio[:16000 * 12])  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    extractor.get_hidden_output(story_audio)
    torch.cuda.synchronize()
    story_s = time.perf_counter() - t0
    log(f"wav2vec slab of {W2V_SLAB} x 10 s chunks to layer {W2V_LAYER}: {slab_ms:.2f} ms f32 "
        f"({slab_ms / W2V_SLAB:.3f} ms a chunk; bound {slab_bound_ms:.2f} ms by {slab_bound_by}, "
        f"{flops / 1e12:.3f} TFLOP: {flops / slab_ms / 1e9:.1f} TFLOP/s), {slab_bf16_ms:.2f} ms "
        f"bf16; {s_per_min_slab:.4f} s per audio minute from the slab; a 60 s story through "
        f"the extractor {story_s:.3f} s host clock; peak memory {peak / 2**30:.2f} GiB; "
        f"profile {json.dumps({k: v for k, v in profile.items() if k != 'top_ops'})}")

    pair = slab[:2]
    with torch.no_grad():
        card = model.hidden_states(pair, taps)[W2V_LAYER].cpu()
        model.dtype = torch.bfloat16
        card_bf16 = model.hidden_states(pair, taps)[W2V_LAYER].cpu()
        model.dtype = torch.float32
    del model, slab
    torch.cuda.empty_cache()
    cpu_model = load_wav2vec2(model_dir, device="cpu")
    pair = pair.cpu()
    with torch.no_grad():
        cpu32 = cpu_model.hidden_states(pair, taps)[W2V_LAYER]
        cpu_model.double()
        cpu_model.dtype = torch.float64
        cpu64 = cpu_model.hidden_states(pair.double(), taps)[W2V_LAYER]
    del cpu_model
    scale = float(cpu32.abs().max())
    err = float((card - cpu32).abs().max()) / scale
    spread = float((cpu32.double() - cpu64).abs().max()) / float(cpu64.abs().max())
    card64 = float((card.double() - cpu64).abs().max()) / float(cpu64.abs().max())
    bf16_err = float((card_bf16 - card).abs().mean() / card.abs().mean())
    launched, launched_bf16 = counts(), bf16_counts()
    log(f"wav2vec card vs CPU, 2 chunks at layer {W2V_LAYER}, float32: {err:.3e} of max |CPU| "
        f"(limit {W2V_TOL:g}); the CPU's float32 against its float64 {spread:.3e}, the card's "
        f"{card64:.3e}; bf16 against f32 mean |d| {bf16_err:.4f} of mean |f32| (limit "
        f"{W2V_BF16_LIMIT}); kernels of the port launched {launched}")
    if not err <= W2V_TOL:
        raise AssertionError("the card's wav2vec2 forward disagrees with the CPU's")
    if not 0 < bf16_err < W2V_BF16_LIMIT:
        raise AssertionError("the bf16 forward is past JAX's limit")
    if any(launched.values()) or any(launched_bf16.values()):
        raise AssertionError(f"the extraction launched kernels of the port: {launched}")
    seconds = time.perf_counter() - t_start
    log(f"wav2vec_path in {seconds:.1f} s")
    return {"params_M": n_params / 1e6, "shapes": shapes, "cli_wall_s": [r["wall_s"] for r in runs],
            "slab_ms": slab_ms, "slab_bf16_ms": slab_bf16_ms, "chunk_ms": slab_ms / W2V_SLAB,
            "slab_bound_ms": slab_bound_ms, "slab_bound_by": slab_bound_by,
            "slab_tflop": flops / 1e12, "s_per_audio_minute_slab": s_per_min_slab,
            "story_60s_s": story_s, "peak_gib": peak / 2**30,
            "profile_slab": {k: v for k, v in profile.items() if k != "top_ops"},
            "top_ops": profile["top_ops"][:5], "card_vs_cpu": err, "cpu_f32_vs_f64": spread,
            "card_vs_f64": card64, "bf16_vs_f32": bf16_err, "seconds": seconds,
            "launches": launched, "launches_bf16": launched_bf16}


# --- the baselines (slice 12) ---------------------------------------------------

# --- data parallelism (slice 13) ---------------------------------------------

DDP_RANKS = 2  # on the one card: ranks outnumber cards, so gloo on the CUDA tensors
DDP_BATCH = 128  # the flagship's global batch: 64 rows a rank
DDP_SEED = 5  # the step seed of the one-step checks
DDP_LOSS_RTOL = 1e-5  # the one-step checks' losses, 2 ranks against 1 process
DDP_GRAD_TOL = 1e-4  # each gradient, of its leaf's largest value (step_errors' floor)
DDP_STATE_TOL = 1e-6  # the bank's rows and the running statistics after the step
DDP_EVAL_TOL = 1e-5  # every number of the 8 eval files, 2 ranks against 1 process
# the 2-epoch run's loss.txt losses against the one-process default run's in
# the same call: the same batches and masks, only the order of f32 sums
# differs (split gradients, 64-row convolutions); 4x the largest spread two
# data paths of the default run ever showed on default cuDNN algorithms
# (2.67e-5, PERF.md section 2 "data-path agreement")
DDP_CE_RTOL = 1e-4
DDP_STEP_CASES = {"flagship": ({}, False), "z4": (ZOO["Z4"], False), "fused": ({}, True)}
# Z4's float32 gradient at batch 128 is ill-conditioned: on the CPU one
# process's float32 step is 2.2e-3 of a leaf's largest value from its float64
# step, and two ranks' differ from one process's by as much (float64: 1e-14).
# Its two ranks are held against the CPU's float64 step, to be no further from
# it than the one-process float32 step on the card is (this margin), or
# within DDP_GRAD_TOL
DDP_F64_HELD = {"z4": 1.5}
DDP_DIR = os.path.join(RUN_DIR, "ddp")

# ``cli.main`` in a fresh process on cuDNN's deterministic algorithms, for
# the one-rank run held to the plain run bit for bit
_DET_CLI_RUN = """
import sys, torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.deterministic = True
from transformer_clip_eeg_tpu_torch import cli
sys.exit(cli.main(sys.argv[1:]))
"""


class _GradCapture:
    """Stands in for the optimizer: keeps the gradients it is handed (under a
    mesh, the ranks' mean) and bumps the step."""

    def __init__(self, params):
        self.params, self.step, self.grads = list(params), 0, None

    def apply(self, grads):
        self.grads = [g.detach().cpu().double() for g in grads]
        self.step += 1


def ddp_batch(cfg, device) -> dict:
    """A global batch of ``DDP_BATCH`` seeded windows (the same on every
    rank): EEG, the config's speech features, distinct bank ids."""
    gen = torch.Generator().manual_seed(13)
    t = cfg.window_length
    return {"eeg": torch.randn(DDP_BATCH, t, 64, generator=gen).to(device),
            "speech": (1.0 + torch.randn(DDP_BATCH, t, cfg.speech_dimension,
                                         generator=gen)).to(device),
            "ids": (torch.randperm(BANK_SIZE, generator=gen)[:DDP_BATCH] + 1).to(device)}


def ddp_step(cfg, fused: bool, batch: dict, mesh, dtype=torch.float32) -> dict:
    """One train step of ``train_step`` at full width, dropout on, weights
    from seed 0, in ``dtype``: on ``mesh``'s rows, or the whole batch
    without one.  The losses, the gradients handed to the optimizer and the
    buffers after (``step_grads``' record, for ``step_errors``)."""
    model = build_model(cfg, BANK_SIZE, device=batch["eeg"].device, seed=0).to(dtype)
    batch = {k: v.to(dtype) if v.is_floating_point() else v for k, v in batch.items()}
    set_fused(model, fused)
    attach(model, mesh)
    opt = _GradCapture(model.parameters())
    local = batch if mesh is None else shard_batch(mesh, batch)
    losses = train_step(model, opt, local, DDP_SEED, warmup=False, model_arch=cfg.model_arch)
    return {"losses": {k: float(v) for k, v in losses.items()}, "grads": opt.grads,
            "names": [n for n, _ in model.named_parameters()],
            "buffers": {n: b.detach().cpu().double() for n, b in model.named_buffers()}}


def ddp_step_checks(mesh) -> dict:
    """(b) of ``ddp_path``: for the flagship, Z4 (batch norms on global
    statistics) and the flagship fused (#5/#6's masks by global sample), one
    step on the two ranks against one process on rank 0, same weights,
    batch and seed: the losses, every gradient before AdamW, the bank and
    the running statistics; the buffers bit for bit across the ranks."""
    out = {}
    for name, (flags, fused) in DDP_STEP_CASES.items():
        cfg = TrainConfig(**flags)
        batch = ddp_batch(cfg, mesh.device)
        got = ddp_step(cfg, fused, batch, mesh)
        digests = gather_objects(checksum(list(got["buffers"].values())), mesh)
        if len(set(digests)) != 1:
            raise AssertionError(f"{name}: the ranks' banks and statistics differ: {digests}")
        if mesh.rank != 0:
            continue
        want = ddp_step(cfg, fused, batch, None)
        errs = step_errors(got, want)
        loss_rel = max(abs(got["losses"][k] - v) / abs(v) for k, v in want["losses"].items())
        state_err = max(errs["buffer_errs"].values())
        grad_err, grad_tol = errs["grad_err"], DDP_GRAD_TOL
        rec = {}
        if name in DDP_F64_HELD:
            exact = ddp_step(cfg, fused, {k: v.cpu() for k, v in batch.items()}, None,
                             torch.float64)
            one_f32 = step_errors(want, exact)["grad_err"]
            grad_err = step_errors(got, exact)["grad_err"]
            grad_tol = max(DDP_GRAD_TOL, DDP_F64_HELD[name] * one_f32)
            rec = {"two_ranks_vs_one_process_f32": errs["grad_err"],
                   "one_process_f32_vs_f64": one_f32}
        worst = sorted(errs["grad_err_by_leaf"].items(), key=lambda kv: -kv[1])[:4]
        log(f"ddp one step, {name}: losses {got['losses']} vs one process {want['losses']} "
            f"(rel {loss_rel:.2e}); gradient error {grad_err:.2e} (tol {grad_tol:.2e}{'' if not rec else ', against the CPU float64 step; ' + json.dumps(rec)}) "
            f"over {len(got['grads'])} leaves, worst against one process "
            f"{[(n, f'{v:.1e}') for n, v in worst]}; bank {errs['bank_err']:.2e}, running "
            f"statistics {errs['batch_stats_err']:.2e}; buffers bit-identical across ranks")
        if not (loss_rel <= DDP_LOSS_RTOL and grad_err <= grad_tol
                and state_err <= DDP_STATE_TOL):
            raise AssertionError(f"ddp step {name} disagrees with the one-process step: loss "
                                 f"{loss_rel:.3e}, gradient {grad_err:.3e} (tol {grad_tol:.3e}), "
                                 f"state {state_err:.3e}")
        out[name] = {"loss_rel": loss_rel, "grad_err": grad_err, "grad_tol": grad_tol,
                     "bank_err": errs["bank_err"], "batch_stats_err": errs["batch_stats_err"],
                     "n_grads": len(got["grads"]), **rec}
    return out


def ddp_windows(cfg) -> dict:
    """A chunk of 128 seeded EEG and speech windows."""
    rng = np.random.default_rng(21)
    return {"eeg": rng.standard_normal((128, cfg.window_length, 64)).astype(np.float32),
            "speech": rng.standard_normal((128, cfg.window_length, cfg.speech_dimension)
                                          ).astype(np.float32)}


def ddp_collective_ms(mesh, model, reps: int = 20) -> dict:
    """Host clock (synchronised) of the step's two collectives at the
    flagship's sizes: the all-gather of a rank's 64 rows of both flattened
    embeddings, and the all-reduce of the flat gradient."""
    width = sum(model.widths())
    rows = torch.randn(DDP_BATCH // mesh.n_data, width, device=mesh.device)
    grads = [torch.randn_like(p) for p in model.parameters()]

    def median_ms(fn):
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    return {"all_gather_ms": median_ms(lambda: all_gather_rows(rows, mesh)),
            "all_gather_shape": [DDP_BATCH // mesh.n_data, width],
            "grad_all_reduce_ms": median_ms(lambda: mean_gradients(grads, mesh)),
            "grad_floats": sum(g.numel() for g in grads)}


@contextlib.contextmanager
def deterministic_suite():
    """``cli.run_eval_suite`` on cuDNN's and torch's deterministic algorithms
    inside, as the one-process ``--only_evaluate`` it is held to runs
    (``_ONLY_EVALUATE_RUN``): on default algorithms the probes' training may
    sum in another order each run, and one early stop that moves changes a
    file by 1e-2 (1.547e-2 in one run on an H100 80GB HBM3)."""
    real = cli.run_eval_suite

    def suite(*a, **k):
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with deterministic_cudnn():
                return real(*a, **k)
        finally:
            torch.use_deterministic_algorithms(False)

    cli.run_eval_suite = suite
    try:
        yield
    finally:
        cli.run_eval_suite = real


def _ddp_rank(data_dir: str, mesh) -> int:
    """One of the two ranks of ``ddp_path`` (started by the port's
    ``parallel.launch``): the one-step checks, then the default command line
    with ``--n_data_shards 2`` (this rank joins the group; training on the
    default algorithms, timed, the eval suite on the deterministic ones), its
    launches and step times, then the collectives timed.  Writes
    ``rank<r>.json``."""
    cap_rank()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    steps = ddp_step_checks(mesh)
    zero_counts()
    with instrumented() as seen, deterministic_suite():
        rc = cli.main(["--data_dir", data_dir, "--epochs", "2", "--n_data_shards",
                       str(DDP_RANKS), "--results_folder", os.path.join(DDP_DIR, "run")])
    trainer = seen["trainers"][-1]
    # one chunk through the suite's embedding functions (split over the ranks)
    embed_eeg, embed_speech = make_embed_fns(trainer.model)
    windows = ddp_windows(trainer.cfg)
    for kind, fn in (("eeg", embed_eeg), ("speech", embed_speech)):
        x = torch.from_numpy(windows[kind]).to(mesh.device)
        np.save(os.path.join(DDP_DIR, f"emb_{kind}.npy"), fn(x).cpu().numpy())
    record = {
        "rank": mesh.rank, "device": str(mesh.device), "mesh": mesh.describe(), "rc": rc,
        "steps": steps, "results_dir": trainer.results_dir, "steps_per_epoch": seen["steps"],
        "launches_train": seen["train_launches"],
        "launches_train_bf16": seen["train_launches_bf16"],
        "eval": seen["eval"][-1],
        "step_ms_epoch2": [v * 1e3 for v in trainer.history[1]["step_s"]],
        "collectives": ddp_collective_ms(mesh, trainer.model),
    }
    with open(os.path.join(DDP_DIR, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(record, f)
    return rc


def loss_numbers(path: str) -> list:
    """A run's train and validation loss lines, as written."""
    return [line for line in open(path).read().splitlines()
            if line.startswith(("train epoch", "validation epoch"))]


def loss_values(path: str) -> list:
    """The losses of those lines."""
    pattern = (r"loss_ce (\S+) loss average eeg (\S+)$|mean loss ce : (\S+), mean loss "
               r"average: (\S+), mean loss total: (\S+)$")
    return [float(v) for line in loss_numbers(path)
            for v in re.search(pattern, line).groups() if v is not None]


def ddp_one_rank(data_dir: str) -> dict:
    """(a) of ``ddp_path``: ``--n_data_shards 1`` (one rank over NCCL, in
    the process) against the plain run, 1 epoch each in a fresh process on
    cuDNN's deterministic algorithms: their loss lines equal, bit for bit."""
    lines = {}
    for name, extra in (("plain", []), ("one_rank", ["--n_data_shards", "1"])):
        results = os.path.join(DDP_DIR, name)
        proc = subprocess.run(
            [sys.executable, "-c", capped(_DET_CLI_RUN), "--data_dir", data_dir, "--epochs", "1",
             "--skip_eval", "yes", "--results_folder", results, *extra],
            cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
            timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"{name} run exited {proc.returncode}: {proc.stderr[-3000:]}")
        (run,) = os.listdir(results)
        lines[name] = loss_numbers(os.path.join(results, run, "loss.txt"))
        if name == "one_rank":
            head = open(os.path.join(results, run, "loss.txt")).readline().strip()
    if not head.startswith("data parallel: 1 ranks over nccl"):
        raise AssertionError(f"the one-rank run's first line: {head!r}")
    if lines["one_rank"] != lines["plain"] or not lines["plain"]:
        raise AssertionError(f"--n_data_shards 1 differs from the plain run: "
                             f"{lines['one_rank']} vs {lines['plain']}")
    log(f"ddp (a): --n_data_shards 1 ({head}) equals the plain run, "
        f"{len(lines['plain'])} loss lines bit for bit")
    return {"loss_lines": len(lines["plain"]), "first_line": head}


def kernels_at_b64(gen: torch.Generator) -> dict:
    """Kernels #1-#4 at a rank's batch of 64 (the flagship's shapes
    otherwise), each timed by CUDA events beside its bound and its library
    call at that batch: #1 in training (dropout on, saving for #2; the
    library layer in training at the same rate), #2 (the layer's backward),
    and #3/#4 summed over the flagship's two recurrences (H=128 and H=4,
    D=2; ``nn.LSTM``'s forward and backward, input projection included)."""
    b, t, e, h = 64, 192, 64, 8
    x, params = block_case(gen)
    x = x[:b].contiguous()
    g = torch.randn(b, t, e, generator=gen).to("cuda")
    n_par = sum(p.numel() for p in params)
    with torch.inference_mode():
        _, saved = fused_block_forward_cuda(x, params, h, e ** 0.5, FLAGSHIP_DROP, save=True)
        fwd_ms = time_ms(lambda: fused_block_forward_cuda(x, params, h, e ** 0.5, FLAGSHIP_DROP,
                                                          save=True))
    bwd_ms = time_ms(lambda: fused_block_backward(x, params, g, saved, h, e ** 0.5,
                                                  FLAGSHIP_DROP))
    lib = library_layer(params, dropout=0.5).train()
    xl = x.clone().requires_grad_()
    lib_leaves = [xl] + list(lib.parameters())
    lib_out = lib(xl)
    library = {
        "fused_transformer_block": time_ms(lambda: lib(xl)),
        "fused_block_backward": time_ms(
            lambda: torch.autograd.grad(lib_out, lib_leaves, g, retain_graph=True)),
        "lstm_scan_packed": 0.0, "lstm_scan_backward": 0.0,
    }
    out = {
        "fused_transformer_block": (fwd_ms, bound(block_flops(b, t),
                                                  2 * x.numel() * 4 + n_par * 4)),
        "fused_block_backward": (bwd_ms, bound(2 * block_flops(b, t), 4 * (
            3 * x.numel() + saved.numel() + 2 * n_par))),
    }
    lstm = {"lstm_scan_packed": [0.0, 0.0, 0.0], "lstm_scan_backward": [0.0, 0.0, 0.0]}
    for (hidden, d), in_dim in zip(FLAGSHIP_LSTMS, (64, 256)):
        cell = torch.nn.LSTM(in_dim, hidden, batch_first=True, bidirectional=d == 2,
                             device="cuda")
        xc = torch.randn(b, t, in_dim, generator=gen).to("cuda").requires_grad_()
        cell_out, _ = cell(xc)
        g_cell = torch.randn(b, t, d * hidden, generator=gen).to("cuda")
        with torch.inference_mode():
            library["lstm_scan_packed"] += time_ms(lambda: cell(xc))
        library["lstm_scan_backward"] += time_ms(lambda: torch.autograd.grad(
            cell_out, [xc, *cell.parameters()], g_cell, retain_graph=True))
        lim = 1.0 / hidden ** 0.5
        xw = (0.5 * torch.randn(t, d, b, 4 * hidden, generator=gen)).to("cuda")
        whh = ((torch.rand(d, hidden, 4 * hidden, generator=gen) * 2 - 1) * lim).to("cuda")
        gh = torch.randn(t, d, b, hidden, generator=gen).to("cuda")
        hs, c, gates = lstm_forward_cuda(xw, whh, return_c=True, save_gates=True)
        rows = t * d * b
        for name, ms, flops, nbytes in (
                ("lstm_scan_packed", time_ms(lambda: lstm_scan_packed(xw, whh)),
                 2 * hidden * 4 * hidden * rows, (xw.numel() + whh.numel() + rows * hidden) * 4),
                ("lstm_scan_backward", time_ms(lambda: lstm_scan_backward(whh, hs, c, gates, gh)),
                 2 * rows * 4 * hidden * hidden * 2,
                 4 * (2 * rows * 4 * hidden + 3 * rows * hidden + 2 * whh.numel()))):
            lstm[name][0] += ms
            lstm[name][1] += flops
            lstm[name][2] += nbytes
    for name, (ms, flops, nbytes) in lstm.items():
        out[name] = (ms, bound(flops, nbytes))
    res = {name: {"ms": ms, "bound_ms": bd[0], "bound_by": bd[1], "library_ms": library[name]}
           for name, (ms, bd) in out.items()}
    log(f"kernels #1-#4 at batch 64 (a rank's rows): {json.dumps(res)}")
    return res


def ddp_path(data_dir: str, train: dict) -> dict:
    """``--n_data_shards`` on the card: (a) one rank against the plain run;
    (b)-(c) two ranks sharing the card over gloo (the port's
    ``parallel.launch``), each running ``_ddp_rank``, then their records
    checked here: the launches per rank-step, the replicas' checksum, the
    losses against the one-process default run, and the 8 eval files against
    a one-process ``--only_evaluate`` on the same checkpoint; (d) the times."""
    t0 = time.perf_counter()
    shutil.rmtree(DDP_DIR, ignore_errors=True)
    os.makedirs(DDP_DIR)
    one_rank = ddp_one_rank(data_dir)
    t_ranks = time.perf_counter()
    # the ranks' deterministic cuBLAS (read when a rank's cuBLAS starts)
    before = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    try:
        if launch(DDP_RANKS, _ddp_rank, (data_dir,), device="cuda") != 0:
            raise AssertionError("a ddp rank returned non-zero")
    finally:
        if before is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = before
    ranks_s = time.perf_counter() - t_ranks
    records = []
    for r in range(DDP_RANKS):
        with open(os.path.join(DDP_DIR, f"rank{r}.json")) as f:
            records.append(json.load(f))
    run_dir = records[0]["results_dir"]
    if {rec["results_dir"] for rec in records} != {run_dir}:
        raise AssertionError(f"the ranks named other results directories: {records}")
    if not records[0]["mesh"].startswith(f"data parallel: {DDP_RANKS} ranks over gloo"):
        raise AssertionError(f"backend: {records[0]['mesh']}")

    # (c) launches per rank-step: each rank steps every global batch on its rows
    for rec in records:
        n_train, n_val = rec["steps_per_epoch"]
        want = two_epoch_launches(n_train, n_val)
        want_eval = suite_launches(rec["eval"]["encoder_calls"])
        if (rec["launches_train"] != want or rec["eval"]["launches"] != want_eval
                or any(rec["launches_train_bf16"].values())
                or any(rec["eval"]["launches_bf16"].values())):
            raise AssertionError(f"rank {rec['rank']}: train launches {rec['launches_train']} "
                                 f"(want {want}), eval {rec['eval']['launches']} (want "
                                 f"{want_eval})")
    # the replicas' check and the losses against the one-process default run
    text = open(os.path.join(run_dir, "loss.txt")).read()
    digest = re.search(rf"replicas identical on {DDP_RANKS} ranks \(checksum (0x[0-9a-f]+)\)",
                       text)
    if digest is None:
        raise AssertionError(f"no replica check in {run_dir}/loss.txt")
    mine = loss_values(os.path.join(run_dir, "loss.txt"))
    base = loss_values(os.path.join(train["results_dir"], "loss.txt"))
    ce_rel = max(abs(a - b) / abs(b) for a, b in zip(mine, base))
    if len(mine) != len(base) or not ce_rel <= DDP_CE_RTOL:
        raise AssertionError(f"the 2-rank run's losses {mine} vs one process {base}")
    # the eval suite of two ranks against one process on the same checkpoint
    two = {}
    for name in EVAL_JSONS:
        with open(os.path.join(run_dir, name)) as f:
            two[name] = _numbers(json.load(f))
    single = os.path.join(DDP_DIR, "one_process_eval")
    shutil.copytree(os.path.join(run_dir, "checkpoints"), os.path.join(single, "checkpoints"))
    saved = TrainConfig.load(os.path.join(run_dir, "args.txt"))
    if saved.n_data_shards != DDP_RANKS:
        raise AssertionError(f"args.txt keeps n_data_shards={saved.n_data_shards}")
    saved.n_data_shards = 0
    saved.save(os.path.join(single, "args.txt"))
    one = only_evaluate_run(single)
    by_file = {}
    for name in EVAL_JSONS:
        ref = np.asarray(_numbers(one["files"][name]))
        got = np.asarray(two[name])
        if len(ref) != len(got):
            raise AssertionError(f"{name}: {len(got)} numbers vs {len(ref)}")
        diff = np.abs(got - ref)
        over = np.flatnonzero(diff > DDP_EVAL_TOL)
        by_file[name] = {"n": len(ref), "max_abs_diff": float(diff.max(initial=0.0)),
                         "n_over_tol": len(over),
                         "over": [(int(i), float(got[i]), float(ref[i])) for i in over[:6]]}
    eval_err = max(f["max_abs_diff"] for f in by_file.values())
    # the embeddings the suite's chunks give on two ranks against one process
    emb = {k: np.load(os.path.join(DDP_DIR, f"emb_{k}.npy")) for k in ("eeg", "speech")}
    served = InferenceSession.from_results_dir(run_dir, device="cuda")
    windows = ddp_windows(saved)
    emb_err = max(float(np.abs(emb["eeg"] - served.embed_eeg(windows["eeg"])).max()),
                  float(np.abs(emb["speech"] - served.embed_speech(windows["speech"])).max()))
    log(f"ddp (c): the eval files, 2 ranks vs one process: {json.dumps(by_file)}; a chunk's "
        f"embeddings, 2 ranks vs one process: {emb_err:.3e}")
    if not eval_err <= DDP_EVAL_TOL:
        raise AssertionError(f"2-rank eval suite vs one process: {eval_err:.3e}")
    # (d) times
    one_ms = train["step_ms_median_epoch2"]["device"]
    rank_ms = [statistics.median(rec["step_ms_epoch2"]) for rec in records]
    out = {
        "mesh": records[0]["mesh"], "one_rank": one_rank,
        "steps": records[0]["steps"],
        "launches_train": records[0]["launches_train"],
        "launches_train_bf16": records[0]["launches_train_bf16"],
        "launches_eval": records[0]["eval"]["launches"],
        "launches_eval_bf16": records[0]["eval"]["launches_bf16"],
        "eval_encoder_calls": records[0]["eval"]["encoder_calls"],
        "eval_suite_s": [rec["eval"]["wall_s"] for rec in records],
        "replica_checksum": digest.group(1), "loss_rel_vs_one_process": ce_rel,
        "eval_max_abs_diff": eval_err, "eval_numbers": sum(len(v) for v in two.values()),
        "step_ms_median_epoch2": {"two_ranks": rank_ms, "one_process": one_ms},
        "pairs_per_s_epoch2": {"two_ranks": DDP_BATCH / max(rank_ms) * 1e3,
                               "one_process": DDP_BATCH / one_ms * 1e3},
        "collectives": [rec["collectives"] for rec in records],
        "ranks_s": ranks_s, "seconds": time.perf_counter() - t0,
    }
    log(f"ddp (b)-(c): 2 ranks on one card ({out['mesh']}): launches a rank "
        f"{out['launches_train']} (train) {out['launches_eval']} (eval); replicas "
        f"{out['replica_checksum']}; losses vs one process {ce_rel:.2e} (tol {DDP_CE_RTOL:g}); "
        f"eval files vs one process {eval_err:.2e} over {out['eval_numbers']} numbers (tol "
        f"{DDP_EVAL_TOL:g})")
    log(f"ddp (d): epoch-2 median step {rank_ms} ms on 2 ranks vs {one_ms:.2f} ms one "
        f"process; collectives {json.dumps(out['collectives'][0])}")
    log(json.dumps({"ddp": out}))
    return out


def baselines_phase() -> dict:
    """``FCNN``, ``CNN`` and ``ClassificationHead`` at their JAX default
    widths, batch 128, random weights from seed 0, training mode (batch
    norms on batch statistics) with dropout off: one forward and backward on
    the card against the CPU, the output and every gradient within
    ``STEP_TOL`` of max(1, the largest), the running statistics likewise."""
    from transformer_clip_eeg_tpu_torch.models import baselines
    from transformer_clip_eeg_tpu_torch.ops.layers import Dropout, init_parameters

    rng = np.random.default_rng(12)
    cases = {"FCNN": (baselines.FCNN, (128, 50, 63)), "CNN": (baselines.CNN, (128, 63, 50)),
             "ClassificationHead": (baselines.ClassificationHead, (128, 40, 61))}
    zero_counts()
    out = {}
    for name, (cls, shape) in cases.items():
        x = rng.standard_normal(shape).astype(np.float32)
        runs = {}
        for dev in ("cuda", "cpu"):
            m = cls()
            init_parameters(m, torch.Generator().manual_seed(0))
            for mod in m.modules():
                if isinstance(mod, Dropout):
                    mod.rate = 0.0
            m = m.to(dev).train()
            y = m(torch.from_numpy(x).to(dev))
            y = y[1] if isinstance(y, tuple) else y
            torch.sin(y).sum().backward()
            runs[dev] = (y.detach().cpu(), {n: p.grad.cpu() for n, p in m.named_parameters()},
                         {n: b.cpu() for n, b in m.named_buffers()})
        (yg, gg, bg), (yc, gc, bc) = runs["cuda"], runs["cpu"]
        scale = max(1.0, max(float(g.abs().max()) for g in gc.values()))
        errs = {"out": float((yg - yc).abs().max()) / max(1.0, float(yc.abs().max())),
                "grad": max(float((gg[n] - gc[n]).abs().max()) for n in gc) / scale,
                "buffers": max((float((bg[n] - bc[n]).abs().max()) for n in bc), default=0.0)}
        out[name] = errs
        if not max(errs.values()) <= STEP_TOL:
            raise AssertionError(f"{name}: card vs CPU {errs}")
    launched, launched_bf16 = counts(), bf16_counts()
    if any(launched.values()) or any(launched_bf16.values()):
        raise AssertionError(f"the baselines launched kernels of the port: {launched}")
    log(f"baselines, batch 128, one forward and backward card vs CPU: {json.dumps(out)}")
    return {"errors": out, "launches": launched, "launches_bf16": launched_bf16}


# --- sharded serving, the fold-sharded mesh, DP x TP extraction (slice 14) ---

SHARD_RANKS = 2  # on the one card: ranks outnumber cards, so gloo on the CUDA tensors
SHARD_DIR = os.path.join(RUN_DIR, "shard")
SHARD_SERVE_DIR = os.path.join(RUN_DIR, "shard_serve")  # cleared by shard_serve_path
# the sharded serve CLI against the one-process CLI in the same call: each
# rank's 64 rows of a chunk may take other cuDNN algorithms than 128 rows
SHARD_SERVE_TOL = 1e-5  # of max |one process|, embeddings and top-k scores
CV_MESH_FOLDS = ["0", "1", "2", "3"]


def topk_places_that_differ(got, want, full: np.ndarray, scale: float) -> list:
    """The places of two top-k index lists ``[Q, k]`` that hold different
    candidates: each with its query, place, the two indices, and the gap
    between their scores in ``full [Q, N]`` over ``scale``."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return [{"query": -1, "place": -1, "ids": [], "gap": float("inf")}]
    return [{"query": int(q), "place": int(i), "ids": [int(got[q, i]), int(want[q, i])],
             "gap": float(abs(full[q, got[q, i]] - full[q, want[q, i]])) / scale}
            for q, i in zip(*np.nonzero(got != want))]


def _shard_serve_rank(results_dir: str, invocations: dict, mesh) -> int:
    """One of the two ranks of ``shard_serve_path``: ``serve.main --shard 2``
    for each invocation, twice (this rank joins the group; rank 0 writes),
    the wall time of each call (the first pass pays this fresh process's
    start-up on the card) and this rank's kernel launches in each pass.
    Writes ``serve_rank<r>.json``."""
    cap_rank()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    passes = []
    for _ in range(2):
        wall, launches = {}, {}
        zero_counts()
        for name, argv in invocations.items():
            before = counts()
            rc, wall[name] = _wall(lambda argv=argv: serve_main(
                ["--results_folder", results_dir, "--shard", str(SHARD_RANKS), *argv]))
            torch.cuda.synchronize()
            if rc != 0:
                raise AssertionError(f"serve --shard {name} returned {rc} on rank {mesh.rank}")
            launches[name] = {k: v - before[k] for k, v in counts().items()}
        passes.append({"wall_s": wall, "launches": counts(), "launches_bf16": bf16_counts(),
                       "launches_by_invocation": launches})
    with open(os.path.join(SHARD_SERVE_DIR, f"serve_rank{mesh.rank}.json"), "w") as f:
        json.dump({"rank": mesh.rank, "mesh": mesh.describe(), "passes": passes}, f)
    return 0


def shard_serve_path(results_dir: str, serve_cli: dict) -> dict:
    """``serve --shard 2`` on the default run: two ranks sharing the card
    over gloo, each running ``serve.main --shard 2`` (joined to the group the
    port's ``launch`` made) for 256 EEG windows, 128 speech windows and top-5
    of the 256 over 130 candidates (the serve CLI phase's files); rank 0's
    outputs against the one-process CLI's in this call (embeddings and
    scores within ``SHARD_SERVE_TOL`` of max |x|; the indices equal at every
    place but where two candidates' scores lie within that of each other,
    which the two GEMM shapes may order either way); exact
    launches a rank-chunk (10 #1 a chunk of EEG, 2 #3 a chunk of speech, each
    of a rank's 64 rows); wall time of each call."""
    t0 = time.perf_counter()
    shutil.rmtree(SHARD_SERVE_DIR, ignore_errors=True)
    os.makedirs(SHARD_SERVE_DIR)
    paths, one = serve_cli["paths"], serve_cli["outs"]
    outs = {k: os.path.join(SHARD_SERVE_DIR, os.path.basename(v)) for k, v in one.items()}
    invocations = {"eeg": ["--eeg", paths["eeg"], "--out", outs["eeg"]],
                   "speech": ["--speech", paths["speech"], "--out", outs["speech"]],
                   "topk": ["--eeg", paths["eeg"], "--candidates", paths["cand"], "--topk", "5",
                            "--out", outs["topk"]]}
    if launch(SHARD_RANKS, _shard_serve_rank, (results_dir, invocations), device="cuda") != 0:
        raise AssertionError("a serve --shard rank returned non-zero")
    records = []
    for r in range(SHARD_RANKS):
        with open(os.path.join(SHARD_SERVE_DIR, f"serve_rank{r}.json")) as f:
            records.append(json.load(f))
    # a chunk is 128 windows, 64 rows a rank: 2 EEG chunks per EEG call, 1 and
    # 2 speech chunks (128 speech windows, 130 candidates)
    chunks = {"eeg": {"eeg": 2, "speech": 0}, "speech": {"eeg": 0, "speech": 1},
              "topk": {"eeg": 2, "speech": 2}}
    for rec in records:
        for p in rec["passes"]:
            for name, c in chunks.items():
                want = dict.fromkeys(counts(), 0)
                want.update(fused_transformer_block=10 * c["eeg"],
                            lstm_scan_packed=2 * c["speech"])
                if p["launches_by_invocation"][name] != want:
                    raise AssertionError(f"rank {rec['rank']} serve --shard {name}: launches "
                                         f"{p['launches_by_invocation'][name]}, want {want}")
            if any(p["launches_bf16"].values()):
                raise AssertionError(f"serve --shard launched bf16 kernels: {p['launches_bf16']}")
    errs = {}
    for k in ("eeg", "speech"):
        got, want = np.load(outs[k]), np.load(one[k])
        _check_embeddings(f"serve --shard {k}", got, want.shape[0], want.shape[1])
        errs[k] = float(np.abs(got - want).max()) / float(np.abs(want).max())
    with open(outs["topk"]) as f:
        topk = json.load(f)
    with open(one["topk"]) as f:
        want_topk = json.load(f)
    scores, want_scores = np.asarray(topk["scores"]), np.asarray(want_topk["scores"])
    scale = float(np.abs(want_scores).max())
    errs["topk_scores"] = float(np.abs(scores - want_scores).max()) / scale
    # a rank's GEMM over its 65 candidates rounds otherwise than one over
    # 130, so two candidates whose scores lie within SHARD_SERVE_TOL may
    # trade places; every other place must hold the same index.  A place
    # that differs is held to the one-process embeddings' scores (float64)
    full = np.load(one["eeg"]).astype(np.float64) @ np.load(
        paths["cand_emb"]).astype(np.float64).T
    swaps = topk_places_that_differ(topk["indices"], want_topk["indices"], full, scale)
    # how near this run came to such a tie: the least gap between neighbours
    # among each query's 6 best, over max |score|
    best = -np.sort(-full, axis=1)[:, :6]
    closest = float((best[:, :-1] - best[:, 1:]).min()) / scale
    ids_equal = not swaps
    ids_ok = (all(s["gap"] <= SHARD_SERVE_TOL for s in swaps)
              and all(len(set(row)) == len(row) for row in topk["indices"]))
    out = {"mesh": records[0]["mesh"], "errors": errs, "indices_equal": ids_equal,
           "index_swaps": swaps, "closest_top6_gap": closest,
           "wall_s": [rec["passes"][1]["wall_s"] for rec in records],
           "wall_s_first_pass": [rec["passes"][0]["wall_s"] for rec in records],
           "one_process_wall_s": serve_cli["wall_s"],
           "launches": records[0]["passes"][0]["launches"],
           "launches_bf16": records[0]["passes"][0]["launches_bf16"],
           "seconds": time.perf_counter() - t0}
    log(f"serve --shard {SHARD_RANKS} ({out['mesh']}): against the one-process CLI {errs} of "
        f"max |x| (tol {SHARD_SERVE_TOL:g}), top-5 indices equal {ids_equal} (places that "
        f"differ, each with its two candidates' score gap of max |score|: {swaps}; the "
        f"closest neighbours among a query's 6 best {closest:.3e}); wall s a rank "
        f"{out['wall_s']} (the first pass {out['wall_s_first_pass']}) vs one process "
        f"{serve_cli['wall_s']}; launches a rank a pass {out['launches']}")
    if not (ids_ok and max(errs.values()) <= SHARD_SERVE_TOL):
        raise AssertionError(f"serve --shard disagrees with the one-process CLI: errors {errs} "
                             f"of max |x| (tol {SHARD_SERVE_TOL:g}); top-5 places that differ "
                             f"{swaps[:8]} ({len(swaps)} in all)")
    log(json.dumps({"shard_serve": out}))
    return out


def _cv_mesh_rank(data_dir: str, results: dict, mesh) -> int:
    """One of the two ranks of ``cv_mesh_path``: ``cv.main --parallel yes
    --n_data_shards 2`` over folds 0-3, 1 epoch (this rank joins the group),
    twice: first (the process's first training) with ``--skip_eval yes``,
    cuDNN off and torch's deterministic algorithms (``DETERMINISTIC_TORCH``)
    into ``results["strict"]``, then on the default algorithms with the
    suites into ``results["default"]``; of each its folds' history and
    launches by phase.  Writes ``cv_rank<r>.json``."""
    cap_rank()
    from transformer_clip_eeg_tpu_torch import cv
    from transformer_clip_eeg_tpu_torch.train.fold_parallel import (
        FoldParallelTrainer,
        local_folds,
    )

    import warnings

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fit, record = FoldParallelTrainer.fit, {}
    mine = local_folds(len(CV_MESH_FOLDS), mesh)

    def recorded(self):
        out = fit(self)
        record["history"] = out["history"]
        return out

    def run(mode: str, *flags: str) -> dict:
        with phase_launches() as seen:
            t0 = time.perf_counter()
            rc = cv.main(["--data_dir", data_dir, "--results_folder", results[mode],
                          "--parallel", "yes", "--n_data_shards", str(SHARD_RANKS), "--folds",
                          *CV_MESH_FOLDS, "--epochs", "1", *flags], device="cuda")
            wall = time.perf_counter() - t0
        train = seen["train"][-1]
        n_train, n_val = (sum(train["steps"][j][i] for j in mine) for i in (0, 1))
        want = {k: v // 2 for k, v in two_epoch_launches(n_train, n_val).items()}
        if rc != 0 or train["launches"] != want or any(train["launches_bf16"].values()):
            raise AssertionError(f"cv mesh rank {mesh.rank} ({mode}): rc {rc}, training "
                                 f"launches {train['launches']} (bf16 {train['launches_bf16']}),"
                                 f" want {want} (its folds' steps "
                                 f"{[train['steps'][j] for j in mine]})")
        return {"rc": rc, "wall_s": wall, "steps": [train["steps"][j] for j in mine],
                "history": record.pop("history"), "launches_train": train["launches"],
                "launches_bf16": train["launches_bf16"], "eval": seen["eval"]}

    FoldParallelTrainer.fit = recorded
    out = {"rank": mesh.rank, "folds": mine}
    try:
        torch.backends.cudnn.enabled = False  # as DETERMINISTIC_TORCH
        torch.use_deterministic_algorithms(True, warn_only=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out["strict"] = run("strict", "--skip_eval", "yes")
        out["nondeterministic_ops"] = sorted({str(w.message)[:160] for w in caught
                                              if "deterministic" in str(w.message)})
        torch.backends.cudnn.enabled = True
        torch.use_deterministic_algorithms(False)
        out["default"] = run("default")
    finally:
        FoldParallelTrainer.fit = fit
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.enabled = True
    if out["strict"]["eval"]:
        raise AssertionError(f"cv mesh rank {mesh.rank}: --skip_eval yes ran a suite")
    suites = out["default"].pop("eval")
    out["strict"].pop("eval")
    out["default"]["launches_eval"] = _check_suites(suites, len(mine))
    out["default"]["launches_eval_bf16"] = {
        k: sum(e["launches_bf16"][k] for e in suites) for k in suites[0]["launches_bf16"]}
    out["default"]["suite_s"] = [e["wall_s"] for e in suites]
    with open(os.path.join(SHARD_DIR, f"cv_rank{mesh.rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


# The fold mesh on cuDNN's default algorithms against the unsharded run on
# the same algorithms, each fold's train and val CE (absolute) and each best
# weight and bank (a share of its tensor's largest value): cuDNN's default
# algorithms are not run-to-run reproducible, so the two are not held bit
# for bit there.  Measured on an H100 80GB HBM3 (700 W), 4 folds, 1 epoch:
# two unsharded runs differ by up to 3.2e-7 in CE and 2.5e-4 of a tensor's
# largest weight, the sharded run and an unsharded one by 4.8e-7 and
# 2.3e-4 (the phase measures and prints both each run).  The limits are
# cross-validation's against JAX on the CPU, 1e-4 in CE and 1e-3 of each
# tensor's largest value: 4x the weights' measured spread
CV_MESH_DEFAULT_LOSS_TOL = 1e-4
CV_MESH_DEFAULT_PARAM_TOL = 1e-3


def cv_mesh_path(data_dir: str) -> dict:
    """``cv --parallel yes --n_data_shards 2 --folds 0 1 2 3``, 1 epoch: two
    ranks sharing the card over gloo (the port's ``launch``; each rank runs
    ``cv.main``, which joins the group), two folds each, twice
    (``_cv_mesh_rank``): with cuDNN off and deterministic algorithms
    (``DETERMINISTIC_TORCH``) and ``--skip_eval yes``, then on the default
    algorithms with the 4 suites.  Beside each the unsharded fold-parallel
    run of the same folds with ``--skip_eval yes`` in a fresh process on the
    same algorithms (``det_cv_run``): every fold's train and val CE and its
    best weights bit for bit on the first pair, within
    ``CV_MESH_DEFAULT_LOSS_TOL`` and ``CV_MESH_DEFAULT_PARAM_TOL`` on the
    second, beside the spread of a second unsharded default run; exact launches of #1-#4 a rank-step and of each rank's suites,
    none of the bf16 instantiations; every suite file finite and
    ``cv_summary.json`` of 4 folds; the aggregate pairs/s of every run."""
    t0 = time.perf_counter()
    os.makedirs(SHARD_DIR, exist_ok=True)
    sharded = {mode: os.path.join(SHARD_DIR, f"cv_mesh_{mode}") for mode in ("strict", "default")}
    plain_dirs = {mode: os.path.join(SHARD_DIR, f"cv_plain_{mode}")
                  for mode in ("strict", "default")}
    before = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS_DETERMINISTIC  # read as a rank's cuBLAS starts
    try:
        if launch(SHARD_RANKS, _cv_mesh_rank, (data_dir, sharded), device="cuda") != 0:
            raise AssertionError("a cv --n_data_shards rank returned non-zero")
    finally:
        if before is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = before
    records = []
    for r in range(SHARD_RANKS):
        with open(os.path.join(SHARD_DIR, f"cv_rank{r}.json")) as f:
            records.append(json.load(f))
    with open(os.path.join(sharded["default"], "cv_summary.json")) as f:
        summary = json.load(f)
    nums = _numbers(summary)
    if set(summary["folds"]) != set(CV_MESH_FOLDS) or not nums or not all(np.isfinite(nums)):
        raise AssertionError(f"cv --n_data_shards cv_summary.json: {summary}")
    plain_s, diffs = {}, {}
    for mode in ("strict", "default"):
        t_plain = time.perf_counter()
        plain = det_cv_run(plain_dirs[mode], data_dir, CV_MESH_FOLDS, "--epochs", "1",
                           algorithms=mode)
        plain_s[mode] = time.perf_counter() - t_plain
        if mode == "default":  # what the default algorithms alone spread, run to run
            again = det_cv_run(plain_dirs[mode] + "_again", data_dir, CV_MESH_FOLDS,
                               "--epochs", "1", algorithms=mode)
            diffs["default_run_to_run"] = [fold_differences(again, j, plain, j)
                                           for j in range(len(CV_MESH_FOLDS))]
        if records[1][mode]["history"] != records[0][mode]["history"]:
            raise AssertionError(f"the two ranks' histories differ ({mode})")
        mesh_run = {"history": records[0][mode]["history"],
                    "ckpts": fold_checkpoints(sharded[mode], CV_MESH_FOLDS)}
        diffs[mode] = [fold_differences(mesh_run, j, plain, j)
                       for j in range(len(CV_MESH_FOLDS))]
    pairs = {f"{name}_{mode}": read_cv_loss_txt(os.path.join(d[mode], "loss.txt"),
                                                 len(CV_MESH_FOLDS), 1)[0][0]["pairs_per_s"]
             for name, d in (("sharded", sharded), ("plain", plain_dirs))
             for mode in ("strict", "default")}
    default = [rec["default"] for rec in records]
    per_step = []
    for rec in default:
        n_train = sum(s[0] for s in rec["steps"])
        per_step.append({k: v / max(n_train, 1) for k, v in rec["launches_train"].items()
                         if "backward" in k})
    out = {"folds_by_rank": [rec["folds"] for rec in records], "fold_diffs": diffs,
           "limits_default": {"loss": CV_MESH_DEFAULT_LOSS_TOL,
                              "param_rel": CV_MESH_DEFAULT_PARAM_TOL},
           "pairs_per_s_epoch1": pairs,
           "wall_s": {mode: [rec[mode]["wall_s"] for rec in records]
                      for mode in ("strict", "default")},
           "plain_wall_s": plain_s, "suite_s": [rec["suite_s"] for rec in default],
           "uploads_by_rank": default[0]["history"][0].get("uploads_by_rank"),
           "launches_train": default[0]["launches_train"],
           "launches_eval": default[0]["launches_eval"],
           "launches_bf16": default[0]["launches_bf16"],
           "launches_eval_bf16": default[0]["launches_eval_bf16"],
           "backward_launches_per_train_step": per_step,
           "nondeterministic_ops": sorted({m for rec in records
                                           for m in rec["nondeterministic_ops"]}),
           "summary": summary["mm_accuracy_mean_over_folds"], "seconds": 0.0}
    out["seconds"] = time.perf_counter() - t0
    log(f"cv --parallel yes --n_data_shards {SHARD_RANKS}, folds {CV_MESH_FOLDS}, 1 epoch: "
        f"folds by rank {out['folds_by_rank']}; against the unsharded run per fold, cuDNN off "
        f"and deterministic algorithms {diffs['strict']}, the default algorithms "
        f"{diffs['default']}, two unsharded runs on them {diffs['default_run_to_run']} "
        f"(limits CE {CV_MESH_DEFAULT_LOSS_TOL:g}, weights "
        f"{CV_MESH_DEFAULT_PARAM_TOL:g} of each tensor's largest); pairs/s {pairs}; launches "
        f"rank 0 {out['launches_train']} (train) {out['launches_eval']} (its 2 suites), bf16 "
        f"{out['launches_bf16']} / {out['launches_eval_bf16']}; uploads by rank "
        f"{out['uploads_by_rank']}; torch ops without a deterministic algorithm "
        f"{out['nondeterministic_ops']}")
    if any(d["max_loss_diff"] or d["max_param_diff"] for d in diffs["strict"]):
        raise AssertionError("the fold-sharded mesh is not bit for bit the unsharded run")
    if any(d["max_loss_diff"] > CV_MESH_DEFAULT_LOSS_TOL
           or d["max_param_rel"] > CV_MESH_DEFAULT_PARAM_TOL for d in diffs["default"]):
        raise AssertionError("the fold-sharded mesh on the default algorithms is outside its "
                             "limits against the unsharded run")
    if any(out["launches_eval_bf16"].values()):
        raise AssertionError(f"the cv mesh's suites launched bf16 kernels: "
                             f"{out['launches_eval_bf16']}")
    log(json.dumps({"cv_mesh": out}))
    return out


def _timed_tp_all_reduce(real, totals: dict):
    """``real`` (``models.wav2vec2._tp_all_reduce``), its host time
    (synchronised) and calls summed into ``totals``."""
    def reduce(y, group):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real(y, group)
        torch.cuda.synchronize()
        totals["s"] += time.perf_counter() - t0
        totals["calls"] += 1
    return reduce


def _tp_rank(model_dir: str, story: str, mesh) -> int:
    """One of the two ranks of ``tp_extraction_path``, for each grid of the
    two ranks (``(2, 1)``: the launch's mesh; ``(1, 2)``): the extraction CLI
    with that grid's flags on a root holding ``story`` (this rank joins the
    group; rank 0 writes), a slab of 16 chunks of 10 s timed (host clock,
    synchronised) with and without the all-reduces timed apart, this rank's
    peak memory; on ``(1, 2)`` the story's taps in bf16.  Writes
    ``tp_rank<r>.json`` and, rank 0, the bf16 taps."""
    cap_rank()
    from transformer_clip_eeg_tpu_torch.models import wav2vec2 as w2v
    from transformer_clip_eeg_tpu_torch.parallel import make_mesh
    from transformer_clip_eeg_tpu_torch.preprocess import wav2vec as extraction

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = mesh.rank  # the launch's mesh is 2 x 1
    rng = np.random.default_rng(0)
    slab = (rng.standard_normal((W2V_SLAB, W2V_CHUNK)) * 0.1).astype(np.float32)
    record = {"rank": rank, "grids": {}}
    real = w2v._tp_all_reduce
    for n_data, n_model in ((2, 1), (1, 2)):
        grid = f"{n_data}x{n_model}"
        root = os.path.join(SHARD_DIR, f"w2v_{grid}")
        t0 = time.perf_counter()
        rc = extraction.main(["--dataset_root", root, "--model_path", model_dir, "--layers",
                              str(W2V_LAYER), "--n_data_shards", str(n_data),
                              "--n_model_shards", str(n_model)])
        cli_s = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"extraction --n_data_shards {n_data} --n_model_shards "
                                 f"{n_model} returned {rc}")
        grid_mesh = mesh if n_model == 1 else make_mesh(n_data, n_model)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = w2v.load_wav2vec2(model_dir, mesh=grid_mesh)
        ext = extraction.Wav2Vec2FeatureExtractor(model, [W2V_LAYER], mesh=grid_mesh)
        times = []
        for i in range(4):  # one warm-up
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ext._forward(slab)
            torch.cuda.synchronize()
            if i:
                times.append((time.perf_counter() - t1) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        reduces = {"s": 0.0, "calls": 0}
        w2v._tp_all_reduce = _timed_tp_all_reduce(real, reduces)
        try:
            ext._forward(slab)
        finally:
            w2v._tp_all_reduce = real
        record["grids"][grid] = {
            "cli_s": cli_s, "slab_ms": statistics.median(times), "slab_ms_all": times,
            "all_reduce_ms_per_slab": reduces["s"] * 1e3,
            "all_reduces_per_slab": reduces["calls"], "peak_gib": peak / 2**30,
            "weights_gib": sum(p.numel() * 4 for p in model.parameters()) / 2**30}
        if n_model == 2:
            bf16 = w2v.load_wav2vec2(model_dir, dtype=torch.bfloat16, mesh=grid_mesh)
            taps = extraction.Wav2Vec2FeatureExtractor(bf16, [W2V_LAYER], mesh=grid_mesh
                                                       ).get_hidden_output(story)[W2V_LAYER]
            if rank == 0:
                np.save(os.path.join(SHARD_DIR, "tp_bf16_taps.npy"), taps)
            del bf16
        del model, ext
    record["launches"], record["launches_bf16"] = counts(), bf16_counts()
    with open(os.path.join(SHARD_DIR, f"tp_rank{rank}.json"), "w") as f:
        json.dump(record, f)
    return 0


def tp_extraction_path() -> dict:
    """The extraction at XLSR-53 width (``wav2vec_path``'s random weights)
    on two ranks sharing the card over gloo: one synthetic story (24.5 s at
    48 kHz, the reference's tail quirk) with ``--n_data_shards 2
    --n_model_shards 1`` and with ``--n_data_shards 1 --n_model_shards 2``
    (Megatron-sharded layers, 2 all-reduces a layer), each file against the
    one-process CLI's in this call within ``W2V_TOL`` of max |one process|;
    the story's taps in bf16 on the 1 x 2 grid against the one-process f32
    taps at JAX's bf16 limit; ms per slab of 16 chunks, the all-reduces' host
    ms per slab, each rank's peak memory; no kernel of the port launched."""
    from transformer_clip_eeg_tpu_torch.models.wav2vec2 import load_wav2vec2
    from transformer_clip_eeg_tpu_torch.preprocess import wav2vec as extraction

    t0 = time.perf_counter()
    os.makedirs(SHARD_DIR, exist_ok=True)
    src = os.path.join(RUN_DIR, "wav2vec")
    model_dir = os.path.join(src, "xlsr53_random")
    story = "audiobook_2"  # 24.5 s
    gz = os.path.join(src, "stimuli", "eeg", f"{story}.npz.gz")
    roots = {g: os.path.join(SHARD_DIR, f"w2v_{g}") for g in ("one", "2x1", "1x2")}
    for root in roots.values():
        os.makedirs(os.path.join(root, "stimuli", "eeg"))
        shutil.copy(gz, os.path.join(root, "stimuli", "eeg"))
    if extraction.main(["--dataset_root", roots["one"], "--model_path", model_dir, "--layers",
                        str(W2V_LAYER)]) != 0:
        raise AssertionError("the one-process extraction CLI failed")
    unzipped = os.path.join(roots["one"], "stimuli", "eeg", f"{story}.npz")
    model = load_wav2vec2(model_dir, device="cuda")
    f32_taps = extraction.Wav2Vec2FeatureExtractor(model, [W2V_LAYER]).get_hidden_output(
        unzipped)[W2V_LAYER]
    del model
    torch.cuda.empty_cache()
    zero_counts()
    if launch(SHARD_RANKS, _tp_rank, (model_dir, unzipped), device="cuda") != 0:
        raise AssertionError("a tensor-parallel extraction rank returned non-zero")
    records = []
    for r in range(SHARD_RANKS):
        with open(os.path.join(SHARD_DIR, f"tp_rank{r}.json")) as f:
            records.append(json.load(f))
    name = f"{story}_-_wav2vec_{W2V_LAYER}.npy"
    want = np.load(os.path.join(roots["one"], "derivatives", "preprocessed_stimuli", name))
    errs = {}
    for g in ("2x1", "1x2"):
        got = np.load(os.path.join(roots[g], "derivatives", "preprocessed_stimuli", name))
        if got.shape != want.shape or not np.isfinite(got).all():
            raise AssertionError(f"{g}: {got.shape} vs {want.shape}, finite")
        errs[g] = float(np.abs(got - want).max()) / float(np.abs(want).max())
    bf16 = np.load(os.path.join(SHARD_DIR, "tp_bf16_taps.npy"))
    bf16_err = float(np.abs(bf16 - f32_taps).mean() / np.abs(f32_taps).mean())
    launched = {k: v for rec in records for k, v in rec["launches"].items() if v}
    out = {"errors": errs, "bf16_vs_f32": bf16_err, "frames": list(want.shape),
           "grids": {r["rank"]: r["grids"] for r in records},
           "launches": records[0]["launches"], "launches_bf16": records[0]["launches_bf16"],
           "seconds": time.perf_counter() - t0}
    log(f"extraction on 2 ranks sharing the card, {story} at XLSR-53 width: against the "
        f"one-process CLI {errs} of max |x| (limit {W2V_TOL:g}); bf16 on 1 x 2 against f32 "
        f"mean |d| {bf16_err:.4f} of mean |f32| (limit {W2V_BF16_LIMIT}); per rank and grid "
        f"{json.dumps(out['grids'])}; kernels of the port launched {launched or 'none'}")
    if not max(errs.values()) <= W2V_TOL:
        raise AssertionError("the sharded extraction disagrees with the one-process CLI")
    if not 0 < bf16_err < W2V_BF16_LIMIT:
        raise AssertionError("the tensor-parallel bf16 extraction is past JAX's limit")
    if launched or any(v for rec in records for v in rec["launches_bf16"].values()):
        raise AssertionError(f"the extraction launched kernels of the port: {launched}")
    log(json.dumps({"tp_extraction": out}))
    return out


# --- the learning-quality gate and the scale rehearsals ----------------------

LQ_DIR = os.path.join(RUN_DIR, "learning_quality")
REHEARSAL_DIR = os.path.join(RUN_DIR, "rehearsal")
# the scale rehearsal's cut: SparrKULee's story length and feature width and
# the flagship model, with 5 stories (fold 0's training split then holds 3
# chunks, more than the tiny budget's 2.5) and 8 + 2 subjects of 4 stories each
REHEARSAL_SHAPE = dict(n_stories=5, n_subjects=8, n_test_subjects=2, story_seconds=600,
                       speech_dim=1024, stories_per_subject=4)
W2V_REHEARSAL = ["--stories", "2", "--story_min", "2", "--stop_after", "1"]
SERVE_ROWS = 100_000
SERVE_DIM = 1536  # the flagship's embedding: 192 x 8
LQ_RUNS = {"learning_quality": "float32", "learning_quality_bf16": "bfloat16"}


def _launched(counted: dict, names, what: str) -> None:
    missing = [n for n in names if not counted.get(n)]
    if missing:
        raise AssertionError(f"{what} launched no {missing}: {counted}")


def _unlaunched(counted: dict, names, what: str) -> None:
    extra = {n: counted[n] for n in names if counted.get(n)}
    if extra:
        raise AssertionError(f"{what} launched {extra}")


CONV_NAMES = ("fused_basic_block", "fused_conv_backward", "conv1d_same")
BF16_KEYS = ("fused_transformer_block_bf16", "fused_block_backward_bf16")


def learning_quality_path() -> dict:
    """JAX's learning-quality gate at the flagship's depth 10 (widths of
    ``TrainConfig()``, 12 epochs at batch 8 on the correlated fixture, then
    the match-mismatch evaluation), ``tools/learning_quality.run_gate`` on
    the card in float32 and in bfloat16: each must clear best val CE < 1.4,
    accuracy >= 0.7 and top-1 >= 0.3.  Each run's kernel launches from 0:
    #1-#4 (the bf16 run trains with #1/#2's bf16 instantiations and
    validates in float32, so it launches no float32 #2), none of #5-#7."""
    from transformer_clip_eeg_tpu_torch.tools import learning_quality as lq

    out = {"launches": {}}
    for path, dtype in LQ_RUNS.items():
        zero_counts()
        rec = lq.run_gate(LQ_DIR, compute_dtype=dtype)
        launched = kernel_launches()
        log(json.dumps({path: rec, "launches": launched}))
        if not rec["passed"]:
            raise AssertionError(f"the {dtype} gate missed JAX's thresholds: {rec}")
        _unlaunched(launched, CONV_NAMES, path)
        if dtype == "float32":
            _launched(launched, KERNEL_NAMES, path)
            _unlaunched(launched, BF16_KEYS, path)
        else:  # a wrapper's count holds its bf16 instantiation's too
            _launched(launched, ("fused_transformer_block", "lstm_scan_packed",
                                 "lstm_scan_backward") + BF16_KEYS, path)
            if launched["fused_block_backward"] != launched["fused_block_backward_bf16"]:
                raise AssertionError(f"{path} launched the float32 #2: {launched}")
        out[path] = rec
        out["launches"][path] = launched
    return out


def rehearsal_path() -> dict:
    """The port's rehearsals at a cut shape (``REHEARSAL_SHAPE``: the story
    length, the feature width and the model kept).  The scale rehearsal's
    ``gen``, ``ingest``, ``evict`` and a 1-epoch flagship ``train`` at batch
    128 without the suite, each stage a process of its own: the eviction's
    digests equal with the tiny budget paying uploads; the epoch uploading
    each training chunk once; #1-#4 launched by the training process and
    none of #5-#7 or the bf16 instantiations.  The wav2vec rehearsal on 2
    stories of 2 min at XLSR-53 width, on ``wav2vec_path``'s checkpoint
    directory (run after it): its first pass ends itself after its first
    story, the resume extracts exactly the other, bf16 within JAX's 0.05;
    no pass launches a kernel of the port.  The serving rehearsal:
    the index at 100,000 rows of 1,536, then 8 clients x 6 requests of 8
    windows through the flagship's service, coalesced answers equal to
    one-at-a-time ones and #1 launched by them."""
    from transformer_clip_eeg_tpu_torch.tools import scale_rehearsal as sr
    from transformer_clip_eeg_tpu_torch.tools import serve_rehearsal as sv
    from transformer_clip_eeg_tpu_torch.tools import wav2vec_rehearsal as wr

    torch.cuda.empty_cache()  # the stage processes budget the card's free memory
    out, seconds = {"launches": {}}, {}
    t0 = time.perf_counter()
    root = os.path.join(REHEARSAL_DIR, "corpus")
    rc = sr.main(["--root", root, "--stages", "gen", "ingest", "evict", "train",
                  "--epochs", "1", "--batch_size", "128", "--skip_eval"]
                 + [f"--{k}={v}" for k, v in REHEARSAL_SHAPE.items()])
    if rc != 0:
        raise AssertionError(f"the scale rehearsal exited {rc}")
    with open(os.path.join(root, "_scale_out", "scale_results.jsonl")) as f:
        scale = {r["stage"]: r for r in map(json.loads, f)}
    ev, tr = scale["evict"], scale["train"]
    if not (ev["correct"] and ev["tiny"]["uploads"] > ev["ample"]["uploads"]
            == ev["n_chunks"]):
        raise AssertionError(f"eviction: {ev}")
    if tr["rc"] != 0 or [p["uploads"] for p in tr["phases"]] != [
            scale["ingest"]["fold0_train_chunks"]]:
        raise AssertionError(f"the rehearsal's training: {tr}")
    _launched(tr["kernel_launches"], KERNEL_NAMES, "rehearsal_train")
    _unlaunched(tr["kernel_launches"], CONV_NAMES + BF16_KEYS, "rehearsal_train")
    out["scale"] = scale
    out["launches"]["rehearsal_train"] = tr["kernel_launches"]
    seconds["scale"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    w2v_root = os.path.join(REHEARSAL_DIR, "w2v")
    os.makedirs(w2v_root)
    # wav2vec_path's checkpoint directory: the same writer, seed and width
    os.symlink(os.path.join(RUN_DIR, "wav2vec", "xlsr53_random"),
               os.path.join(w2v_root, "hf_model"))
    wr.main(["--root", w2v_root] + W2V_REHEARSAL)
    with open(os.path.join(w2v_root, "rehearsal.jsonl")) as f:
        w2v = {r["stage"]: r for r in map(json.loads, f)}
    if not (w2v["first_pass_cut"]["stopped"] and len(w2v["first_pass_cut"]["files"]) == 1
            and w2v["resume_to_completion"]["extracted_exactly_the_missing"]):
        raise AssertionError(f"the extraction's resume: {w2v}")
    passes = [w2v[stage]["kernel_launches"]
              for stage in ("first_pass_cut", "resume_to_completion", "bf16_delta")]
    extraction = {k: sum(p[k] for p in passes) for k in passes[0]}
    _unlaunched(extraction, tuple(extraction), "rehearsal_extraction")
    out["wav2vec"] = w2v
    out["launches"]["rehearsal_extraction"] = extraction
    seconds["wav2vec"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    zero_counts()
    index = sv.bench_index(SERVE_ROWS, SERVE_DIM, "cuda")
    clients = sv.bench_microbatch()
    served = kernel_launches()
    log(json.dumps({"serve_rehearsal": {"index": index, "microbatch": clients,
                                        "launches": served}}))
    _launched(served, ("fused_transformer_block",), "rehearsal_serve")
    _unlaunched(served, ("fused_block_backward", "lstm_scan_backward") + CONV_NAMES
                + BF16_KEYS, "rehearsal_serve")
    out["serve"] = {"index": index, "microbatch": clients}
    out["launches"]["rehearsal_serve"] = served
    seconds["serve"] = time.perf_counter() - t0
    out["seconds"] = seconds
    log(f"rehearsal_path: {json.dumps(seconds)} s")
    return out


PHASE_SECONDS: dict = {}
PHASE_PEAK_GIB: dict = {}  # the most a phase's process held on the card (reserved)


def timed(fn, *args):
    """``fn(*args)``, its seconds kept in ``PHASE_SECONDS`` and the most
    this process reserved on the card meanwhile in ``PHASE_PEAK_GIB``, under
    its name; then the process's unused cached blocks go back to the card
    (a fresh process that a later phase starts may take the card's free
    memory)."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        PHASE_SECONDS[fn.__name__] = time.perf_counter() - t0
        PHASE_PEAK_GIB[fn.__name__] = torch.cuda.max_memory_reserved() / 2**30
        torch.cuda.empty_cache()


# After the phases that must have the card alone, the rest run in three
# lanes at once: this process runs the first, a process of its own each of
# these (``python3 chip_smoke.py --lane NAME DATA_DIR OUT``).  The lanes
# share only the fixture, which they read, and each keeps its own files
# under ``RUN_DIR``.
LANES = {
    "mesh_gate": ("cv_mesh_path", "learning_quality_path"),
    "extraction": ("wav2vec_path", "tp_extraction_path", "rehearsal_path"),
}
LANE_THREADS = 4  # each lane process's CPU threads (the host has 8 cores)
LANE_TIMEOUT_S = 1500
# While the lanes run, each lane's process may hold at most this share of the
# card (its allocator gives back cached blocks when it would pass it; a
# cuDNN workspace that does not fit takes the next algorithm), so the lanes
# and the processes they start share the card's memory.  Alone on the card
# a process on cuDNN's deterministic algorithms took up to 68 GiB and the
# zoo 44 GiB (H100 80GB HBM3, ``chip_memory_probe.py``): workspaces as large
# as the free memory
MAIN_LANE_MEMORY = 0.25
LANE_MEMORY = {"mesh_gate": 0.2, "extraction": 0.2}


def _picklable(obj):
    """``obj`` with every value that is not plain data, an array or a tensor
    (on the CPU) replaced by its ``repr``."""
    if isinstance(obj, dict):
        return {k: _picklable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_picklable(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if obj is None or isinstance(obj, (str, bytes, bool, int, float, np.ndarray, np.generic)):
        return obj
    return repr(obj)


def lane_main(name: str, data_dir: str, out_path: str) -> int:
    """The phases of lane ``name`` in turn (those that take it get
    ``data_dir``); their results and seconds pickled to ``out_path``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(LANE_THREADS)
    torch.cuda.init()
    torch.cuda.set_per_process_memory_fraction(LANE_MEMORY[name])
    _build.load()
    results = {}
    for phase in LANES[name]:
        fn = globals()[phase]
        takes_data = "data_dir" in inspect.signature(fn).parameters
        results[phase] = timed(fn, *((data_dir,) if takes_data else ()))
    with open(out_path, "wb") as f:
        pickle.dump({"results": _picklable(results), "seconds": PHASE_SECONDS,
                     "peak_gib": PHASE_PEAK_GIB}, f)
    return 0


def start_lane(name: str, data_dir: str) -> dict:
    """Lane ``name`` started in a process of its own (and its own session,
    so that :func:`stop_lane` reaches the processes it starts); its output
    goes to ``RUN_DIR/lane_<name>.log``."""
    base = os.path.join(RUN_DIR, f"lane_{name}")
    env = {**os.environ, "OMP_NUM_THREADS": str(LANE_THREADS), "PYTHONUNBUFFERED": "1"}
    with open(base + ".log", "w") as out:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--lane", name, data_dir, base + ".pkl"],
            stdout=out, stderr=subprocess.STDOUT, env=env, start_new_session=True)
    return {"name": name, "proc": proc, "base": base, "t0": time.perf_counter()}


def finish_lane(lane: dict):
    """Waits for ``lane`` and prints its output; returns its phases' results
    by phase name, or None if it failed (after printing the end of its
    output to standard error)."""
    rc = lane["proc"].wait(timeout=LANE_TIMEOUT_S)
    PHASE_SECONDS[f"lane_{lane['name']}"] = time.perf_counter() - lane["t0"]
    with open(lane["base"] + ".log") as f:
        text = f.read()
    log(f"--- lane {lane['name']}: its phases' output ---")
    print(text, end="", flush=True)
    if rc != 0:
        print(f"lane {lane['name']} exited {rc}; the end of its output:\n{text[-8000:]}",
              file=sys.stderr, flush=True)
        return None
    with open(lane["base"] + ".pkl", "rb") as f:
        got = pickle.load(f)
    PHASE_SECONDS.update(got["seconds"])
    PHASE_PEAK_GIB.update(got["peak_gib"])
    return got["results"]


def stop_lane(lane: dict) -> None:
    """Kills whatever of ``lane``'s session still runs."""
    with contextlib.suppress(ProcessLookupError):
        os.killpg(lane["proc"].pid, signal.SIGKILL)
    lane["proc"].wait()


def main() -> int:
    t_start = time.perf_counter()
    # a SIGTERM unwinds main, so that the lanes are stopped
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.load()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator().manual_seed(0)
    x, params = block_case(gen)
    block = timed(check_block, x, params)
    block_bwd = timed(check_block_backward, x, params, gen)
    block["windows"] = timed(check_block_windows, gen, params)
    # the bf16 checks draw from a generator of their own: the earlier checks'
    # inputs stay as they were
    gen_bf16 = torch.Generator().manual_seed(10)
    bf16_kernels = timed(check_block_bf16, gen_bf16, params)
    del x, params
    lstm = timed(check_lstm, gen)
    lstm_bwd = timed(check_lstm_backward, gen)
    convs = timed(check_conv, gen)
    bf16_inputs = timed(check_lstm_conv_bf16, gen_bf16)
    # #1-#4 at a rank's batch of 64 (the 2-rank run's shapes), timed while
    # the card runs nothing else
    b64 = timed(kernels_at_b64, torch.Generator().manual_seed(64))
    torch.cuda.empty_cache()
    serve = timed(serve_path)
    log(json.dumps({"serve": serve}))
    augment = timed(augment_phase)
    data_dir = write_fixture()
    lanes = []
    try:
        train, cfg, host_batch = timed(train_path, data_dir)
        zoo = timed(zoo_path, data_dir)
        reference = timed(reference_ckpt_path, train["results_dir"], data_dir)
        ddp = timed(ddp_path, data_dir, train)
        bf16_train = timed(bf16_train_path, data_dir, cfg, host_batch,
                           train["step_ms_median_epoch2"]["device"])
        augmented = timed(augmented_train_path, data_dir, cfg, host_batch,
                          train["step_ms_median_epoch2"]["device"])
        cv_run = timed(cv_path, data_dir)
        os.environ[LANES_ENV] = "1"
        torch.cuda.set_per_process_memory_fraction(MAIN_LANE_MEMORY)
        torch.cuda.empty_cache()
        lanes = [start_lane(name, data_dir) for name in LANES]
        bf16_train.update(timed(bf16_step_path, cfg, host_batch))
        k1 = timed(k1_path, data_dir)
        k2 = timed(k2_path, data_dir)
        serve_cli = timed(serve_cli_path, train["results_dir"])
        server_cli = timed(server_cli_path, train["results_dir"], serve_cli)
        shard_serve = timed(shard_serve_path, train["results_dir"], serve_cli)
        finished = {lane["name"]: finish_lane(lane) for lane in lanes}
        failed = [name for name, got in finished.items() if got is None]
        if failed:
            raise AssertionError(f"lanes {failed} failed (their output is above)")
        torch.cuda.set_per_process_memory_fraction(1.0)
        del os.environ[LANES_ENV]
    finally:
        for lane in lanes:
            stop_lane(lane)
        shutil.rmtree(RUN_DIR, ignore_errors=True)
    lane_results = {k: v for got in finished.values() for k, v in got.items()}
    cv_mesh, learning = (lane_results[p] for p in LANES["mesh_gate"])
    wav2vec, tp, rehearsal = (lane_results[p] for p in LANES["extraction"])
    fused = timed(fused_path, cfg, host_batch)
    long_window = timed(long_window_path)
    baselines = timed(baselines_phase)
    kernels = [block, block_bwd, lstm, lstm_bwd]
    for k in kernels:
        k["launches"] = train["launches"][k["name"]]
        k["launches_by_path"] = {
            "serve": serve["launches"][k["name"]], "train": train["launches_train"][k["name"]],
            "eval_suite": train["launches_eval"][k["name"]],
            **{f"t256_{what}": per_kernel[k["name"]]
               for what, per_kernel in long_window["launches"].items()},
            **{f"zoo_{z}": zoo[z]["launches"][k["name"]] for z in ZOO}}
    # #5-#7 run on the fused path; the default paths launch none of them
    for k in convs:
        k["launches"] = fused["launches"]["train_step"][k["name"]]
        k["launches_by_path"] = {
            "serve": serve["launches"][k["name"]], "train": train["launches"][k["name"]],
            **{f"fused_{what}": per_kernel[k["name"]]
               for what, per_kernel in fused["launches"].items()},
            **{f"zoo_{z}": zoo[z]["launches"][k["name"]] for z in ZOO}}
    kernels += convs
    # the gate's and the rehearsals' runs, each counted from 0 (bf16 rows: "<name>_bf16")
    gate_and_rehearsals = {**learning["launches"], **rehearsal["launches"]}
    for k in kernels:
        k["launches_by_path"].update(
            train_augmented=augmented["launches"][k["name"]],
            serve_cli=serve_cli["launches"][k["name"]],
            server_cli=server_cli["launches"][k["name"]],
            train_bf16=bf16_train["launches_train"][k["name"]],
            cv_parallel=cv_run["launches"]["cv_parallel"][k["name"]],
            cv_sequential=cv_run["launches"]["cv_sequential"][k["name"]],
            **{f"k1_{n}": k1[n]["launches"][k["name"]] for n in K1},
            **{f"k2_{n}": k2[n]["launches"][k["name"]] for n in K2},
            k2_served=k2[K2_SERVED]["served_launches"][k["name"]],
            **{path: counts_[k["name"]] for path, counts_ in reference["launches"].items()},
            wav2vec_extraction=wav2vec["launches"][k["name"]],
            baselines=baselines["launches"][k["name"]],
            ddp_train=ddp["launches_train"][k["name"]],
            ddp_eval=ddp["launches_eval"][k["name"]],
            shard_serve=shard_serve["launches"][k["name"]],
            cv_mesh_train=cv_mesh["launches_train"][k["name"]],
            cv_mesh_eval=cv_mesh["launches_eval"][k["name"]],
            tp_extraction=tp["launches"][k["name"]],
            **{path: c[k["name"]] for path, c in gate_and_rehearsals.items()})
    # #1-#4 at a rank's batch of 64 (the 2-rank run's shapes), beside their bound there
    for k in kernels[:4]:
        k.update({f"{key}_b64": v for key, v in b64[k["name"]].items()})
    # #3-#7 take bf16 at their boundary (the kernels are float32 inside)
    lstm["bf16_input"] = {d: bf16_inputs[d] for d in ("lstm_D2", "lstm_D1")}
    lstm_bwd["bf16_input"] = lstm["bf16_input"]
    for k in convs:
        k["bf16_input_K64"] = bf16_inputs["conv_K64"]
    # #1 and #2's bf16 instantiations: launched by the bf16 run's training
    # alone (its validation, evaluation suite and --only_evaluate run float32)
    for k in bf16_kernels:
        base = next(n for n, b in BF16_NAMES.items() if b == k["name"])
        k["launches"] = bf16_train["launches_train_bf16"][base]
        # the cv runs are float32: cv_path and cv_mesh_path check that they
        # launched none
        k["launches_by_path"] = {"train_bf16": k["launches"], "eval_suite_bf16": 0,
                                 "cv_parallel": 0, "cv_sequential": 0,
                                 **{path: counts_[base] for path, counts_
                                    in reference["launches_bf16"].items()},
                                 "wav2vec_extraction": wav2vec["launches_bf16"][base],
                                 "baselines": baselines["launches_bf16"][base],
                                 "ddp_train": ddp["launches_train_bf16"][base],
                                 "ddp_eval": ddp["launches_eval_bf16"][base],
                                 "shard_serve": shard_serve["launches_bf16"][base],
                                 "cv_mesh_train": cv_mesh["launches_bf16"][base],
                                 "cv_mesh_eval": cv_mesh["launches_eval_bf16"][base],
                                 "tp_extraction": tp["launches_bf16"][base],
                                 **{path: c[f"{base}_bf16"]
                                    for path, c in gate_and_rehearsals.items()}}
    kernels += bf16_kernels
    log(json.dumps({"augment_and_cli": {
        "augment_ms": {n: r["ms"] for n, r in augment["by_name"].items()},
        "augmented_step_ms": augmented["step_ms_median_epoch2"],
        "default_step_ms": augmented["default_step_ms_median_epoch2"],
        "serve_cli_wall_s": serve_cli["wall_s"],
        "server_first_healthz_s": server_cli["first_healthz_s"],
        "server_request_ms": server_cli["request_ms_median"]}}))
    log(json.dumps({"cv_and_k1": {
        "pairs_per_s_epoch2": cv_run["pairs_per_s_epoch2"],
        "uploads_per_epoch": [p["uploads"] for p in cv_run["parallel"]["phases"]],
        "union_chunks": cv_run["parallel"]["union_chunks"],
        "isolation": cv_run["isolation"], "profile_one_chunk": {
            k: v for k, v in cv_run["profile_one_chunk"].items() if k != "top_ops"},
        "rss_gb_around_trims": cv_run["rss_gb_around_trims"], "cv_s": cv_run["seconds"],
        "k1_s": k1["seconds"], "k1_step_grad_err": {
            n: k1[n]["step"]["grad_err"] for n in K1},
        "k2_s": k2["seconds"], "k2_step_grad_err": {
            n: k2[n]["step"]["grad_err"] for n in K2},
        "k2_step_ms": {n: k2[n]["step_ms_median"] for n in K2},
        "k2_served_err": k2[K2_SERVED]["served_err"]}}))
    log(json.dumps({"reference_wav2vec_baselines": {
        "reference_ckpt": {k: v for k, v in reference.items() if not k.startswith("launches")},
        "wav2vec": {k: v for k, v in wav2vec.items() if k not in ("top_ops",)},
        "baselines": baselines["errors"]}}))
    log(json.dumps({"multi_device": {
        "shard_serve_wall_s": shard_serve["wall_s"], "shard_serve_errors": shard_serve["errors"],
        "shard_serve_index_swaps": shard_serve["index_swaps"],
        "shard_serve_closest_top6_gap": shard_serve["closest_top6_gap"],
        "cv_mesh_pairs_per_s": cv_mesh["pairs_per_s_epoch1"],
        "cv_mesh_fold_diffs": cv_mesh["fold_diffs"], "tp_errors": tp["errors"],
        "tp_grids": tp["grids"], "seconds": {"shard_serve": shard_serve["seconds"],
                                            "cv_mesh": cv_mesh["seconds"],
                                            "tp_extraction": tp["seconds"]}}}))
    log(json.dumps({"learning_quality_and_rehearsals": {
        "gate": {path: {k: learning[path][k] for k in (
            "best_val_loss_ce", "val_loss_ce", "mm_mean_accuracy", "top1_retrieval", "train_s")}
            for path in LQ_RUNS},
        "scale": rehearsal["scale"], "wav2vec": rehearsal["wav2vec"],
        "serve": rehearsal["serve"], "seconds": rehearsal["seconds"]}}))
    log(json.dumps({"phase_seconds": PHASE_SECONDS}))
    log(json.dumps({"phase_peak_reserved_gib": PHASE_PEAK_GIB}))
    log(f"chip_smoke finished in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--lane"]:
        sys.exit(lane_main(*sys.argv[2:5]))
    sys.exit(main())
