"""Drive the PyTorch port (vivqa_tpu_torch) on one CUDA card.

    python3 chip_smoke.py                # every phase
    python3 chip_smoke.py --phase mesh   # the build, phase 15 and path_check
    python3 chip_smoke.py --phase tools  # ... phase 16 (examples: 17)

Phases, in order; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: every CUDA source of the port with nvcc for sm_90a, each in
   the parts ``ops/cuda_build.py:PARTS`` gives it (by dtype and head
   dim), every part at once, with ptxas' register, spill and
   shared-memory report (the main path's templates' registers held);
3. kernels: each kernel against its plain version on the card at the
   shapes the serving paths give it (the classification forward's, the
   generative path's: encoders and fusion at batch 16, the single-query
   decode calls over the KV cache at several steps and over the encoder
   memory; and a few edge cases), in f32, bf16 and f16 (bf16 and f16 in
   the form ``flash_attention.forward_plan`` picks; two long-form calls
   bit-equal), one JSON line per case with its time (CUDA-graph replay),
   its form, the plain version's, the bound and
   scaled_dot_product_attention's time as a yardstick, and a line with
   the serving forward's time per flagship forward, per generate and per
   decode call beside SDPA's and the bound; then the training kernels
   (forward with stats, the one-pass backward; in f32 the backward is the
   dQ and dK/dV pair) the same way at the training step's shapes (batch
   128) and edge cases, with attention dropout on and off, o, m, l, dq, dk
   and dv checked in f32, bf16 and f16, and two backward calls bit-equal;
4. serving: the flagship classification model (CLIP-style ViT-B/32,
   PhoBERT-style text encoder, MCAN, dense top-2 MoE, 1,000 answers) with
   seeded random weights behind VQAPredictor, answering batches of 8
   requests with questions of different lengths; every attention call
   must go through the kernel (36 launches per forward), and one batch is
   checked on a copy with 2 layers a stack against the same weights on
   the CPU (the plain path; every card-vs-CPU check below runs such a
   copy, its card half too); then
   one batch's forward eager, as one CUDA graph, and under torch.profiler
   (the device's busy time and idle share);
5. generative serving: bench_serving's model (12 + 12 encoder layers, 3
   fusion layers, 6 decoder layers, 64,001-token vocab) with seeded
   random weights, greedy and beam (4 beams) generates of 32 tokens at
   batch 16 and 64 through build_generate_fn, timed with the port's
   bench_serving functions (answers/s, p50/p95); every attention call
   goes through the forward kernel (411 launches per generate, none of
   the training kernels); the greedy sequences against the card's own
   teacher forcing, card against CPU at batch 2, one greedy and one beam
   generate under torch.profiler;
6. training: the same classification model with bench.py's synthetic
   batch of 128, loss and optimizer (cross-entropy + 0.01 x router aux
   loss, AdamW with warmup-cosine, decay mask and global-norm clipping),
   dropout on; a few warm-up steps, then timed steps (step ms, QA-pairs/s,
   loss and grad_norm per step, peak memory); every attention call must
   go through the training kernels (36 launches of each per step,
   none of the inference forward); one step under torch.profiler; then
   two steps of the same weights at dropout 0 on a ragged batch of 4, on
   the card and on the CPU (the plain versions), whose losses, grad norms
   and updated parameters must agree;
7. generative training (bench_convergence_gen.py's flagship mode:
   bench_serving's model, dropout 0.05, batch 32, questions of 3-60
   tokens, answers of 1-6 tokens through the port's GenerativeVQADataset
   targets, AdamW at lr 1e-3 with warmup-cosine): the training
   kernels at the step's five shapes under its masks (the decoder's
   causal AND padding self-attention, whose rows are mostly keyless, the
   cross-attention's stride-0 query mask, the fusion's 113 x 113 q/k
   mask) against their plain versions in f32, f16 and bf16 with and
   without dropout, timed beside SDPA, and their totals per step; the
   train step timed (step ms, answer tokens/s, QA-pairs/s, peak memory;
   39 launches of each training kernel per step, none of the forward)
   and profiled; two steps card against CPU at batch 4; one short
   GenerativeTrainingPipeline.run (an epoch of 3 steps, a one-batch
   greedy validation at batch 16 through the forward kernel, a
   checkpoint that restore_best gives back bit for bit);
8. the classification CLI pipeline (VQAPipeline, as ``python -m
   vivqa_tpu_torch.pipelines.vqa_pipeline`` runs it) at the flagship's
   width and depth on a learnable synthetic corpus of 320 images at 224
   px (vocab and answer count follow the corpus): train (2 epochs of 8
   steps at batch 32, medium augmentation, validation and
   best-checkpointing), evaluate and inference from the checkpoint, with
   each run's launches checked; the best checkpoint reloaded through
   ModelPipeline.load_checkpoint validates to the final evaluation's
   metrics; the loader's host time, the pipeline's own steps (timed
   inside TrainingPipeline.run) against the bare step, one step and one
   validation under the profiler (36 launches of each training kernel,
   36 of the forward, no library attention);
9. the generative CLI pipeline (``python -m
   vivqa_tpu_torch.pipelines.generative_vqa_pipeline``, driven through
   its ``main`` with a YAML config) at bench_serving's width and depth on
   a learnable seq_answers corpus of 160 images at 224 px (the vocab
   follows the corpus): train (one epoch of 4 steps at batch 32, a greedy
   validation, a checkpoint), evaluate (beam 4) and inference from the
   checkpoint, ``vivqa_evaluation.main`` and the fitted serving bench's
   function (greedy and beam at batch 16, early exit against the fixed
   loop) on it, each run's launches held to 39 a step for the training
   kernels and 27 a generate plus 12 a decode step for the forward; every
   resumed parameter on the card; the bare step (host clock and events),
   a generate and a step under the profiler (idle share, no library
   attention);
10. the MoE ablation study (``python -m
   vivqa_tpu_torch.ablation.run_ablation``, driven through its ``main``):
   first the four kernels at the study's 20 attention shapes (slot
   queries against the 80 fused tokens and back, the 88-token joint
   encoder, the fusion's query-side mask) against their plain versions in
   f32 and bf16 and timed beside SDPA, with their totals per training
   step and per validation forward; then the round-3 study's model
   (hidden 256, 4 layers, 64 px, the six specialized experts, noisy top-2)
   on a learnable corpus of 320 samples, one epoch at batch 32, for the
   full model, the dense one, a leave-one-out and its post-hoc twin, a
   post-hoc single expert and the soft router swap; each must complete
   with router telemetry and a per-sample mask that agrees with its
   exact match, with 42 launches of each training kernel a step (16
   without the MoE) and as many forward launches a validation forward;
   the same command again skips every experiment and ``--report-only``
   rewrites the reports, neither launching a kernel; the card against
   the CPU (eval logits, two soft-router train steps, the CLI's default
   2/2/2/0 composition's logits); the bare step against the pipeline's,
   a step and a validation under the profiler;
11. the knowledge (RAG) path: the four kernels at its new shapes
   (KnowledgeAttention's one query over K = 5 contexts under a mask with
   padded and fully masked rows, at batch 8, 32 and, training, 128; the
   generative decoder's cross-attention over 113 + 5 = 118 keys under
   the concatenated memory mask, 32 queries at batch 32 and one query at
   the greedy and beam rows of a generate at batch 16) against their
   plain versions in f32, f16 and bf16, timed beside SDPA, and their
   totals per classification forward and step and per generative step
   and generate; the flagship with KnowledgeAttention (contexts from a
   KnowledgeProvider over a synthetic knowledge base): card against CPU
   logits, a validation forward (37 launches), the train step at batch
   128 (37 of each training kernel) beside the bare step, profiled, and
   two steps card against CPU; bench_serving's model with the knowledge
   memory: greedy and beam generates at batch 16 (411 launches each),
   cache against teacher forcing, greedy tokens card against CPU, the
   train step at batch 32 (39); both CLIs with ``--use-knowledge`` (train,
   evaluate, inference; 37 launches a forward with the knowledge, 36
   without, 39 a generative step, 27 + 12 a decode step; the provider's
   host ms a batch, cold and cached); dense retrieval through the
   flagship's text tower (12 launches a chunk of 32, embeddings and top-5
   against the CPU);
12. the trainer and the training extras at the flagship's width, batch
   32: ``VQATrainer`` with gradual_unfreeze over 3 epochs of 2 steps,
   layer-wise decay 0.9, lookahead and the resource manager attached (two
   stage changes, each a fresh state with zero moments and count 0; the
   frozen encoders bit-equal through their frozen epochs; 36 launches of
   each training kernel a step and 36 of the forward a validation
   forward; the manager's JSON report with the card's used memory above
   0), ``emergency_save`` of its state read back bit for bit;
   ``VQATrainer`` with gradient checkpointing and freeze_visual (one
   step's loss and every gradient against the plain forward's, within
   the card's own spread over three plain steps; 72 forward-with-stats
   launches, 36 dQ and 36 dK/dV a step); two mixed steps (mix_mode
   both, freeze_visual) card against CPU on given draws; one update of
   each optimizer (adam, sgd, radam, lamb, adafactor, AdamW with a bf16
   first moment) over the full parameter set, card against CPU; the
   generative CLI's train mode with ``--freeze-visual`` and
   ``--enable-resource-management`` (39 launches a step, the visual
   encoder bit-equal);
13. the model zoo at full width: first the four kernels at its new
   shapes (the Q-Former's 32 x 32, 32 x 50, 32 x 49 and masked 32 x 64
   calls, single-stream's 115 x 115 under the query-AND-key mask, the
   vision-token embedding's 32 x 784 with 4 heads; and the flagship's
   towers at the zoo's and the trainer's step batch of 32) against their
   plain versions in f32, f16 and bf16, timed beside SDPA with their
   bounds, and their totals per forward and step of each zoo path; then
   BASELINE.json's Swin-B + PhoBERT + MCAN (with the dense MoE) and
   ResNet-50 (GroupNorm) + BERT-style text + bilinear fusion, and the
   flagship's towers with qformer + sparse MoE, single_stream +
   hierarchical MoE and mutan + dense MoE: VQAPredictor at batch 8
   (24, 12, 36, 28 and 24 launches a forward, predicted from the
   configs), train steps at batch 32 (as many of each training kernel),
   the card's logits against the CPU's (and the sparse layer's dropped
   fraction equal), two steps card against CPU (at the same widths,
   every layer stack cut to 2: the CPU half was most of the phase);
   Swin-B's window
   attention (outside the kernels: it adds a learned bias) by the
   profiler against its step, beside SDPA with an additive mask; the
   classification CLI with ``--visual-backbone swin --fusion qformer``
   (train one epoch, evaluate); bench_serving's generative model with
   the sparse MoE (two steps card against CPU, a greedy generate at 16:
   411 launches); DeBERTa-v3-base and the three image representations
   forward and backward card against CPU (the vision-token embedding: 2
   launches of each kernel);
14. pretrained HF towers (``hf_import``): the forward kernel at the
   towers' new shapes (ViT-B/16's 197 tokens, DINOv2-B's 1,370 at 518 px,
   BARTpho's 16 heads over 64 masked tokens) against its plain version
   in f32, f16 and bf16, timed beside SDPA with its bound; seeded
   checkpoints of CLIP ViT-B/32, PhoBERT-base, ViT-B/16, DINOv2-B and
   BARTpho-syllable's encoder written at their published sizes in the HF
   layout (safetensors by the script's own writer, ``pytorch_model.bin``,
   safetensors shards with their index) and read by the port's reader
   without ``transformers``; ``ModelPipeline`` with
   ``pretrained_visual`` / ``pretrained_text`` on the card and the CPU:
   every grafted tower parameter bit-equal to the files' tensors (mapped
   by hand), 36 launches a forward, the card's logits against the CPU's;
   the classification CLI with ``--pretrained-visual`` and
   ``--pretrained-text`` (one epoch of 4 steps at batch 32, evaluate), the
   generative CLI with the same towers (2 steps, a greedy evaluate) and
   the resumed model's greedy generate at 16 (411 launches); ViT-B/16,
   DINOv2-B at 518 px and the BARTpho encoder card against CPU at batch
   1-2 (one launch a layer);
15. the ('data', 'model') mesh: the four kernels at the (1, 2) mesh's
   per-rank shapes (batch 32, half the heads: ViT and text 6 of 12,
   MCAN 4 of 8) against their plain versions in f32, f16 and bf16, timed
   beside SDPA with their bounds; then two ranks on the one card over a
   gloo group (NCCL refuses two ranks on one device; the kernels built
   here, loaded there): the flagship at full width (bf16, dropout 0) on
   the (2, 1) and (1, 2) meshes, 2 steps each of a global batch of 32
   from the same seeded weights as one process's steps, held to
   train_check's tolerances, a 2-layer f32 copy held to 1e-4, 36
   launches of each training kernel a step and of the forward an
   evaluation forward on each rank; the same with KnowledgeAttention
   (its ``k_proj`` gathered on (1, 2); 37 launches) and its evaluation
   logits against one process's; adafactor on (1, 2) (the f32 copy's
   factored statistics within 1e-3 of one process's); bench_serving's
   generative model on (1, 2): a greedy generate of 32 tokens at batch
   16 (411 launches a rank), its teacher-forced logits against one
   process (``compare_logits``); both CLIs with ``--use-knowledge`` on
   the YAML's (1, 2) mesh; the ablation CLI on (2, 1), two rows within
   0.05 of one process's exact match, each result written once by rank
   0; step ms per rank by CUDA events, the collectives' host ms and bytes
   a step, peak memory per rank (two ranks on one card: not a
   multi-card figure);
16. the step-budget tools (``vivqa_tpu_torch/tools/``) at the flagship's
   full width and depth: ``profile_components``' five modes at batch 64
   (wall ms by CUDA events beside the profiler's busy ms; 36 launches of
   each training kernel a step, 36 of the forward an eval forward),
   ``profile_towers``' five towers at batch 128 and
   ``bench_input_pipeline`` over 256 JPEGs (images/s, PIL and native);
17. the ten walkthroughs of ``vivqa_tpu_torch/examples/`` on the card,
   each printing every section title of its JAX file, while
   ``vivqa_tpu_torch/cli/setup_pipeline.sh --synthetic --skip-eval`` runs
   its stages in a subprocess whose launches reach this process
   (``--recorded``);
18. path shapes: each wrapper call of phases 4-17 is recorded by its
   kernel, dtype, shapes, mask layout, causal, dropout rate and tile
   rows; each such launch the kernel phases did not hold against the
   plain version (the classification pipeline's batches of 32, 2 and 1,
   say) is held now on random inputs of that kind, and the script fails
   if any launch of a main path stays unchecked;
19. the seconds by phase (``phase_seconds``), the card line (nvidia-smi's
   name and power limit), the kernels line, and the device line, which
   is the last line.

Each path's launch counts are set to 0 just before it runs and read just
after.

Depth cuts: the CLI and plumbing phases' models run at their paths'
widths with every layer stack cut to CUT_LAYERS (2): phase 8
(cls_pipeline), 9 (gen_cli), 11's CLIs, 12 (the trainer), 13's zoo
paths but Swin-B's, its CLI and its generative model, 14's seeded HF
checkpoints (``hf_models_at``), grafted models and CLIs, and 15's ranks
and CLIs; their launch counts follow the cut configs. The timed paths
(4-7, 11's steps and generates, Swin-B's profiled step, 16) and every
kernel phase's per-step totals stay at full depth; each card-vs-CPU
check runs a copy of 2 layers a stack whose weights are drawn on the
card (``cpu_copy``).
The script imports nothing of JAX or of the JAX package. Without a CUDA
device it prints no result and exits 2.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import inspect
import json
import math
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import time
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from vivqa_tpu_torch import bench, bench_serving
from vivqa_tpu_torch.bench import (bench_optimizer, flagship_config,
                                   synthetic_batch)
from vivqa_tpu_torch.data import fastloader
from vivqa_tpu_torch.data.augmentation import ImageAugmentation
from vivqa_tpu_torch.data.dataset import (IGNORE_INDEX, GenerativeVQADataset,
                                          generative_collate)
from vivqa_tpu_torch.data.loader import host_tensor
from vivqa_tpu_torch.data.synthetic import generate_synthetic_vivqa
from vivqa_tpu_torch.data.schema import OneSample
from vivqa_tpu_torch.data.tokenizer import WhitespaceTokenizer
from vivqa_tpu_torch.device import card_line, resolve_device
from vivqa_tpu_torch.eval.predictor import VQAPredictor
from vivqa_tpu_torch.knowledge import (VIETNAMESE_STOPWORDS, DenseRetriever,
                                       Document, DocumentStore,
                                       InMemoryVectorStore,
                                       KnowledgeProvider,
                                       KnowledgeProviderConfig,
                                       TextKnowledgeEncoder)
from vivqa_tpu_torch.models.config import (GenerativeVQAConfig,
                                           VisualEncoderConfig,
                                           VQAModelConfig)
from vivqa_tpu_torch.models.decoding import DecodeConfig, build_generate_fn
from vivqa_tpu_torch.models.encoders import representation
from vivqa_tpu_torch.models.encoders.deberta import (DeBERTaConfig,
                                                     DeBERTaEncoder)
from vivqa_tpu_torch.models.encoders.swin import (SwinEncoder,
                                                  window_attention)
from vivqa_tpu_torch.models.generative import GenerativeVQAModel
from vivqa_tpu_torch.models.moe.layer import SparseMOELayer
from vivqa_tpu_torch.models.layers import (init_weights,
                                           make_attention_mask,
                                           make_causal_mask)
from vivqa_tpu_torch.models.vqa_model import (SPECIALIZED_ORDER,
                                              VietnameseVQAModel,
                                              create_vqa_model)
from vivqa_tpu_torch.ops import batch_mix, cuda_build
from vivqa_tpu_torch.ops import flash_attention as fa
from vivqa_tpu_torch.pipelines.data_pipeline import (DataPipeline,
                                                     DataPipelineConfig)
from vivqa_tpu_torch.pipelines.generative_training_pipeline import (
    GenerativeTrainingConfig, GenerativeTrainingPipeline, batch_to_device)
from vivqa_tpu_torch.pipelines.model_pipeline import (ModelPipeline,
                                                      ModelPipelineConfig)
from vivqa_tpu_torch.pipelines.training_pipeline import (
    TrainingPipeline, TrainingPipelineConfig)
from vivqa_tpu_torch.pipelines.vqa_pipeline import (VQAPipeline,
                                                    VQAPipelineConfig)
from vivqa_tpu_torch.train.checkpoint import (CheckpointConfig,
                                              CheckpointManager,
                                              emergency_save,
                                              restore_emergency)
from vivqa_tpu_torch.train.optimizers import (OptimizerConfig,
                                              SchedulerConfig,
                                              create_optimizer)
from vivqa_tpu_torch.train.state import (KNOWLEDGE_KEYS, TrainState,
                                         classification_loss_fn,
                                         generative_loss_fn, make_train_step)
from vivqa_tpu_torch.train.trainer import TrainerConfig, VQATrainer
from vivqa_tpu_torch.utils import profiling

# H100 SXM published peaks (NVIDIA data sheet, dense), at a 700 W limit
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}

KERNEL_SOURCES = ("flash_attn_fwd", "flash_attn_bwd", "flash_attn_bwd_dq",
                  "flash_attn_bwd_dkv")
TRAIN_KERNELS = bench.TRAIN_KERNELS
# the kernels a main path launches; the others (the f32 backward pair, the
# one-pass backward's long-form dQ sum) launch on a path only where its
# check names them
PATH_KERNELS = ("flash_attn_fwd",) + TRAIN_KERNELS
# the backward of an f32 model (the mesh phase's f32 copies): the SIMT pair
F32_BACKWARD = ("flash_attn_bwd_dq", "flash_attn_bwd_dkv")


def path_counts(counts: dict) -> dict:
    """``counts`` by launch count name (``fa.launch_counts``, or a
    profile's ``fa.attention_kernel_counts``) without the kernels off the
    main paths that did not launch: a check's ``want`` names the path
    kernels, so any other kernel that launched shows as a key it lacks."""
    return {n: c for n, c in counts.items()
            if n in PATH_KERNELS or n == "library" or c}


def launch_snapshot() -> dict:
    """The launch counts as the checks compare them (``path_counts``)."""
    return path_counts(fa.launch_counts)

# kernel vs plain version on the same inputs. bf16: the plain version
# rounds the normalised probabilities to bf16 before P.V (as
# _xla_attention does); the kernels' tensor-core templates (serving and
# training) round the unnormalised ones; both round the output to bf16
# (2**-8 relative), so a few bf16 ulps of outputs of size <= ~2. f16 has
# 3 more bits and takes the same bound. f32 (the SIMT templates): the same
# arithmetic in another order, f32 rounding only.
ATTN_TOL = {torch.bfloat16: 2e-2, torch.float16: 2e-2, torch.float32: 2e-5}

# The templates each kernel runs on the main paths (bf16, head dim 64; the
# forwards' tile form, 64-query units of one warpgroup over 64-key tiles
# and, for calls of at most 32 keys, over one 32-key tile, the serving
# forward's decode form at one query row for the decoder's
# masked calls; the backward with one and two 64-key tiles a unit (L <= 64
# and the 113-118 key shapes) and its long form (the zoo's 784 keys); the
# calls with a mask and those without take separate instantiations), as
# ptxas names them
_BF16_64 = "I13__nv_bfloat16Li64E"
MAIN_TEMPLATES = {
    "flash_attn_fwd": [
        f"flash_attn_fwd_serve_kernel{_BF16_64}Li{nk}ELi1ELb{m}EE"
        for nk in (64, 32) for m in (0, 1)]
    + [f"flash_attn_fwd_serve_dec_kernel{_BF16_64}Li1ELb1EE"],
    "flash_attn_fwd_lse": [
        f"flash_attn_fwd_train_kernel{_BF16_64}Li{nk}ELi1ELb{m}EE"
        for nk in (64, 32) for m in (0, 1)],
    "flash_attn_bwd": [f"flash_attn_bwd_kernel{_BF16_64}Li{nkt}ELb{m}ELb{lng}EE"
                       for nkt, lng in ((1, 0), (2, 0), (1, 1))
                       for m in (0, 1)]}

# (name, B, H, Lq, Lk, D, mask kind, causal, calls per flagship forward)
ATTN_CASES = [
    ("vit_self", 8, 12, 50, 50, 64, None, False, 12),
    ("text_self", 8, 12, 64, 64, 64, "query_key", False, 12),
    ("mcan_enc_self", 8, 8, 64, 64, 64, "query_key", False, 4),
    ("mcan_dec_self", 8, 8, 49, 49, 64, None, False, 4),
    ("mcan_cross", 8, 8, 49, 64, 64, "key", False, 4),
    ("causal_lq_eq_lk", 8, 8, 64, 64, 64, None, True, 0),
    ("causal_lq_lt_lk", 8, 8, 24, 64, 64, None, True, 0),
    ("causal_lq_gt_lk", 8, 8, 64, 24, 64, None, True, 0),
    ("gen_fusion_113", 8, 8, 113, 113, 64, "key", False, 0),
    ("long_1024", 2, 8, 1024, 1024, 64, None, False, 0),
    ("head_dim_128", 8, 4, 64, 64, 128, "query_key", False, 0),
]

ATTN_CALLS_PER_FORWARD = sum(c[-1] for c in ATTN_CASES)    # 36

# The generative path's attention at bench_serving's config
# (vivqa_tpu_torch/bench_serving.py): (name, B, H, Lq, Lk, D, the path's
# mask kind, a padded mask kind checked as well, calls per beam generate
# at batch 16). That generate runs the encoders and the fusion at batch
# 16 and 32 decode steps at 16 x 4 beams = 64 rows; each step makes, per
# decoder layer, one self call over the 32-position cache (keys at
# positions <= the step: "cache_pos") and one cross call over the
# 113-token memory under its key mask. Greedy runs the steps at the
# batch, beam at batch 64 at 256 rows. bench_serving's questions have no
# padding, so the text, fusion and memory masks the path builds allow
# every key ("full_*"); each case is timed with the path's mask, and
# checked with it and with random padding. A cache_pos case is checked at
# each of CACHE_INDICES and timed at the middle one; its bytes and flops
# are the mean over a generate's steps (cur_index 0 .. Lk - 1).
GEN_CASES = [
    ("gen_vit_self", 16, 12, 50, 50, 64, None, None, 12),
    ("gen_text_self", 16, 12, 64, 64, 64, "full_query_key", "query_key",
     12),
    ("gen_fusion_self", 16, 8, 113, 113, 64, "full_query_key", "query_key",
     3),
    ("dec_self_16", 16, 8, 1, 32, 64, "cache_pos", None, 0),
    ("dec_self_64", 64, 8, 1, 32, 64, "cache_pos", None, 192),
    ("dec_self_256", 256, 8, 1, 32, 64, "cache_pos", None, 0),
    ("dec_cross_16", 16, 8, 1, 113, 64, "full_key", "key", 0),
    ("dec_cross_64", 64, 8, 1, 113, 64, "full_key", "key", 192),
    ("dec_cross_256", 256, 8, 1, 113, 64, "full_key", "key", 0),
]
CACHE_INDICES = (0, 15, 31)
GEN_HEAD = "beam_b16"          # the generate GEN_CASES' calls describe

# The training kernels against their plain versions (the backward ones fed
# the kernel forward's o, m, l). o, dq, dk and dv are held relative to
# each tensor's largest value (at least 1): dropout scales o by 1/0.9 and
# a row with few keys reaches |o| ~ 4, where a bf16 ulp is 2**-6; o as
# ATTN_TOL, the gradients as GRAD_TOL (f32 differs by summation order
# only; in bf16 both round their outputs once to bf16, 2**-8 relative).
# m and l are f32 in both (1e-5, elementwise relative). In bf16 and f16
# the one-pass backward also rounds p z and dS to the input dtype as
# product operands (dS once, for dK and dQ), which the plain version does
# not (ROADMAP.md, Queue C); the bound holds it.
STAT_TOL = 1e-5
GRAD_TOL = {torch.bfloat16: 1e-2, torch.float16: 1e-2, torch.float32: 1e-4}
TRAIN_BATCH = 128                     # bench.py's batch per chip
# the depth of every layer stack (``check_depth``, ``gen_check_depth``)
# in the card-vs-CPU checks' copies of a model, whose CPU half at full
# depth was most of their time, and in the CLI and plumbing phases'
# models (cls_pipeline, gen_cli, rag's CLIs, trainer, the zoo's paths but
# Swin-B and its CLI and generative model, hf_import's checkpoints and
# CLIs, the mesh ranks and CLIs), each of which, built at full depth on
# the host, wrote or read a 1 GB checkpoint. Their widths, token counts
# and heads are the paths' own, so the kernels see the same shapes, and
# their launch counts follow the config. The timed paths (serving,
# generative, training, gen_training, rag's steps and generates) and the
# kernels' per-step totals stay at full depth
CUT_LAYERS = 2
DROPOUT = 0.1                 # text and MCAN (models/config.py:81,97)

# (name, B, H, Lq, Lk, D, mask kind, causal, calls per flagship step, the
# dropout rate those calls use); every case runs with dropout 0 and 0.1
TRAIN_CASES = [
    ("vit_self", 128, 12, 50, 50, 64, None, False, 12, 0.0),
    ("text_self", 128, 12, 64, 64, 64, "query_key", False, 12, DROPOUT),
    ("mcan_enc_self", 128, 8, 64, 64, 64, "query_key", False, 4, DROPOUT),
    ("mcan_dec_self", 128, 8, 49, 49, 64, None, False, 4, DROPOUT),
    ("mcan_cross", 128, 8, 49, 64, 64, "key", False, 4, DROPOUT),
    ("causal_lq_eq_lk", 8, 8, 64, 64, 64, None, True, 0, None),
    ("causal_lq_lt_lk", 8, 8, 24, 64, 64, None, True, 0, None),
    ("causal_lq_gt_lk", 8, 8, 96, 24, 64, None, True, 0, None),
    ("gen_fusion_113", 8, 8, 113, 113, 64, "key", False, 0, None),
    ("long_1024", 2, 8, 1024, 1024, 64, None, False, 0, None),
    ("head_dim_128", 8, 4, 64, 64, 128, "query_key", False, 0, None),
]
ATTN_CALLS_PER_STEP = sum(c[8] for c in TRAIN_CASES)        # 36

# The generative train step (bench_convergence_gen.py:83-130's flagship
# mode): batch 32, dropout 0.05 in the fusion and the decoder (the text
# encoder keeps its config's 0.1, the ViT its 0.0), questions of 3-60
# tokens padded to 64, answers of 1-6 tokens (2-7 of the decoder's 32
# positions, BOS first).
GEN_TRAIN_BATCH = 32
GEN_DROPOUT = 0.05
# the pipeline run's validation batch: the batch at which GEN_CASES hold
# the forward kernel's encoder, fusion and decode calls, padded masks too
GEN_VAL_BATCH = GEN_CASES[0][1]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# seconds by phase (dotted names: a phase's parts), printed on one line
PHASE_SECONDS: dict = {}


@contextlib.contextmanager
def timed(name: str):
    """Adds the block's wall seconds to PHASE_SECONDS[name]."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) \
            + time.perf_counter() - t0


def _events_ms(run, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def eager_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Time per call of ``fn`` issued from Python, from CUDA events over
    ``iters`` back-to-back calls: at these sizes the host's dispatch, not
    the device, sets it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    return _events_ms(fn, iters)


def captured(fn, calls: int = 1) -> torch.cuda.CUDAGraph:
    """``calls`` calls of ``fn`` captured in one CUDA graph on a side
    stream. ``torch.cuda.graph`` would also run ``gc.collect()`` and
    ``empty_cache()`` at each capture, which took 0.1-4 s a capture in a
    process that holds the models' tensors."""
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph.capture_begin()
        try:
            for _ in range(calls):
                fn()
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    return graph


def device_ms(fn, calls: int = 20, replays: int = 20) -> float:
    """Device time per call of ``fn``: ``calls`` calls captured in one CUDA
    graph, replayed ``replays`` times, timed with CUDA events. The host's
    dispatch drops out; each launch still costs its device-side latency.
    Kernels, plain versions and SDPA all take the same calls a graph, so
    the gap between replays weighs on each alike."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = captured(fn, calls)
    graph.replay()
    torch.cuda.synchronize()
    return _events_ms(graph.replay, replays) / calls


def profiled(fn, calls: int = 10, tries: int = 5) -> dict:
    """Device time per call of ``fn``: the sum of the durations of the
    kernels it launches, under torch.profiler, over ``calls`` calls (for
    calls whose host side, as autograd's, would set an eager rate). The
    profiler at times drops a kernel, which leaves a count that the calls
    do not divide, so profiles are taken until one holds a whole number
    of kernels a call (at most ``tries``; a profiler session costs about
    half a second here); the time is that profile's. Returns ``ms``,
    ``kernels_per_call`` and ``complete`` (False when no profile held a
    whole number: the time is then the fullest one's and may be
    short)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = device_kernels(prof).values()
        seen.append((sum(c for c, _ in kernels), sum(t for _, t in kernels)))
        if seen[-1][0] and seen[-1][0] % calls == 0:
            break
    count, us = seen[-1] if seen[-1][0] and seen[-1][0] % calls == 0 \
        else max(seen)
    if not count:
        raise AssertionError(f"torch.profiler recorded no kernel in "
                             f"{tries} tries")
    return {"ms": us / 1e3 / calls, "kernels_per_call": count / calls,
            "complete": count % calls == 0}


def profiled_ms(fn, calls: int = 10, tries: int = 5) -> float:
    """``profiled``'s time alone."""
    return profiled(fn, calls, tries)["ms"]


def device_kernels(prof) -> dict:
    """{kernel name: [launches, device us]} of a torch.profiler run, read
    from the profiler's raw events (building its function events, CPU
    operators and all, takes seconds for a train step). User annotations
    that the profiler also places on the device's timeline (such as
    ``Optimizer.step#AdamW.step``) span kernels counted already and are
    left out, as are the events it hides."""
    kernels: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA \
                and not e.is_user_annotation() and not e.is_hidden_event():
            k = kernels.setdefault(e.name(), [0, 0.0])
            k[0] += 1
            k[1] += e.duration_ns() / 1e3
    return kernels


# -- what the main paths launch, against what the checks held ----------------
# The wrappers, by launch count name
WRAPPERS = {"flash_attn_fwd": "flash_attention_cuda",
            "flash_attn_fwd_lse": "flash_attention_fwd_lse_cuda",
            "flash_attn_bwd": "flash_attention_bwd_fused_cuda",
            "flash_attn_bwd_dq": "flash_attention_bwd_dq_cuda",
            "flash_attn_bwd_dkv": "flash_attention_bwd_dkv_cuda"}
# the launch keys of the calls held against the plain versions
CHECKED: set = set()


def launch_key(name, q, k, mask, causal, rate) -> tuple:
    """What a kernel's check depends on: the kernel, the dtype, q's shape
    (which, with the key count, sets the forward's form), the key count,
    the mask's stored shape (broadcast dims as 1), causal and the dropout
    rate."""
    return (name, str(q.dtype).removeprefix("torch."), tuple(q.shape),
            k.shape[2], None if mask is None else tuple(mask.shape),
            bool(causal), float(rate))


@contextlib.contextmanager
def recording_launches(keys: set):
    """Adds to ``keys`` the ``launch_key`` of every call of the four
    wrappers made inside (the model and the ops module reach them through
    the module's names); calls and launch counts are otherwise as they
    were."""
    originals = {name: getattr(fa, w) for name, w in WRAPPERS.items()}

    def recorder(name, fn):
        params = inspect.signature(fn).parameters
        names = list(params)
        defaults = {n: p.default for n, p in params.items()}

        def wrapped(*args, **kwargs):
            a = {**defaults, **dict(zip(names, args)), **kwargs}
            keys.add(launch_key(name, a["q"], a["k"], a["mask"], a["causal"],
                                a.get("dropout_rate", 0.0)))
            return fn(*args, **kwargs)
        return wrapped
    for name, fn in originals.items():
        setattr(fa, WRAPPERS[name], recorder(name, fn))
    try:
        yield keys
    finally:
        for name, fn in originals.items():
            setattr(fa, WRAPPERS[name], fn)


# -- phase 2: build ----------------------------------------------------------
def ptxas_usage(report: str) -> dict:
    """{mangled kernel name: {registers, spill_store_bytes,
    spill_load_bytes}} from nvcc's ``-Xptxas -v`` report."""
    usage, current = {}, None
    for line in report.splitlines():
        name = re.search(r"(?:Compiling entry function '|Function properties "
                         r"for )([^' ]+)", line)
        if name:
            current = usage.setdefault(name.group(1), {})
            continue
        if current is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if spill:
            current["spill_store_bytes"] = int(spill.group(1))
            current["spill_load_bytes"] = int(spill.group(2))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            current["registers"] = int(regs.group(1))
    return usage


def build_phase() -> dict:
    """Build every source at once; return, for each kernel of the main
    path, ptxas' usage of the template that path runs."""
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        results = list(pool.map(cuda_build.build, KERNEL_SOURCES))
    usage = {}
    for name, res in zip(KERNEL_SOURCES, results):
        print(f"[build] {name}: {res.seconds:.1f} s -> {res.library.name}")
        for line in res.report.splitlines():
            if "ptxas" in line and ("registers" in line or "Compiling" in line
                                    or "smem" in line) or "spill" in line:
                print(f"[build]   {line.strip()}")
        usage.update(ptxas_usage(res.report))
    out = {}
    for kernel, templates in MAIN_TEMPLATES.items():
        each = {}
        for template in templates:
            found = [u for n, u in usage.items() if template in n]
            if len(found) != 1 or "registers" not in found[0]:
                raise AssertionError(f"ptxas report has {len(found)} entries "
                                     f"for {template}")
            each[template] = found[0]
        out[kernel] = {
            "templates": each,
            **{key: max(u.get(key, 0) for u in each.values())
               for key in ("registers", "spill_store_bytes",
                           "spill_load_bytes")}}
    emit({"ptxas": out})
    return out


# -- phase 3: kernels --------------------------------------------------------
def cache_pos_mask(Lk: int, cur_index: int) -> torch.Tensor:
    """The decoder's cache at step ``cur_index``: keys <= the step."""
    return (torch.arange(Lk, device="cuda") <= cur_index).view(1, 1, 1, Lk)


def attention_inputs(B, H, Lq, Lk, D, kind, dtype, gen, cur_index=None):
    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    q, k, v = rand(B, H, Lq, D), rand(B, H, Lk, D), rand(B, H, Lk, D)
    mask = None
    if kind == "cache_pos":
        mask = cache_pos_mask(Lk, cur_index)
    elif kind == "full_key":    # make_attention_mask(None, no padding)
        mask = torch.ones(B, 1, 1, Lk, dtype=torch.bool, device="cuda")
    elif kind == "full_query_key":      # make_attention_mask(ones, ones)
        mask = torch.ones(B, 1, Lq, Lk, dtype=torch.bool, device="cuda")
    elif kind in ("knowledge", "memory_knowledge"):
        mask = knowledge_key_mask(B, Lk, kind, gen)
    elif kind is not None:
        klen = torch.randint(1, Lk + 1, (B,), generator=gen, device="cuda")
        kv = torch.arange(Lk, device="cuda")[None] < klen[:, None]
        if kind == "key":
            qv = torch.ones(B, Lq, dtype=torch.bool, device="cuda")
        else:   # query AND key padding, as the text encoder builds it
            qv = torch.arange(Lq, device="cuda")[None] < klen[:, None]
        mask = qv[:, None, :, None] & kv[:, None, None, :]
    return q, k, v, mask


def attention_work(q, k, mask, causal):
    """(bytes moved, flops needed, key rows needed) of the call's data:
    q and o once; of k and v only the key rows that some query of the same
    (batch, head) takes (a row no query takes need not be read); the mask
    once; 4*D flops per (query, key) pair that enters the softmax. A query
    row with no allowed key averages all Lk keys, so it takes every key."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    allowed = torch.ones(B, 1, Lq, Lk, dtype=torch.bool, device=q.device)
    if causal:
        allowed = allowed & torch.ones(Lq, Lk, dtype=torch.bool,
                                       device=q.device).tril(Lk - Lq)
    if mask is not None:
        allowed = allowed & mask
    allowed = allowed | ~allowed.any(-1, keepdim=True)
    pairs = int(allowed.sum()) * H
    key_rows = int(allowed.any(2).sum()) * H
    nbytes = (2 * q.numel() + 2 * key_rows * D) * q.element_size()
    if mask is not None:
        nbytes += mask.numel()
    return nbytes, 4 * D * pairs, key_rows


def forward_form(q, k) -> dict:
    """The forward's form for a bf16/f16 call of q's and k's shapes
    (``fa.forward_plan``), with its split partials' bytes
    (``fwd_scratch_bytes``)."""
    plan = fa.forward_plan(*q.shape[:3], k.shape[2], q.shape[3])
    return {"form": plan["form"], "launches": plan["launches"],
            "key_splits": plan["splits"],
            "scratch_bytes": fwd_scratch_bytes(q, k)}


def forward_twice_equal(fn) -> bool:
    """Two calls of a forward on the same inputs are bit-equal (every
    output: o, or o, m and l)."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    a, b = (x if isinstance(x, tuple) else (x,) for x in (a, b))
    return all(torch.equal(x, y) for x, y in zip(a, b))


def attention_case(name, B, H, Lq, Lk, D, kind, causal, gen,
                   calls_per_forward=0, calls_per_generate=0,
                   check_kind=None) -> dict:
    """One case: the forward kernel against its plain version in f32, f16
    and bf16 (a cache_pos case at each of CACHE_INDICES; with ``kind``'s
    mask and ``check_kind``'s; in the long form two calls bit-equal),
    then, in bf16 with ``kind``'s mask, its time (graph replay), its
    form, the plain version's time, the bound and SDPA's."""
    errs = {}
    variants = [(kind, cur) for cur in
                (CACHE_INDICES if kind == "cache_pos" else (None,))]
    if check_kind is not None:
        variants.append((check_kind, None))
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        errs[dtype] = 0.0
        for mask_kind, cur in variants:
            q, k, v, mask = attention_inputs(B, H, Lq, Lk, D, mask_kind,
                                             dtype, gen, cur)
            ref = fa.attention_reference(q, k, v, mask, causal)
            with recording_launches(CHECKED):
                out = fa.flash_attention_cuda(q, k, v, mask, causal)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            if not math.isfinite(err) or err > ATTN_TOL[dtype]:
                raise AssertionError(
                    f"{name} {dtype} mask {mask_kind} cur_index {cur}: "
                    f"kernel vs plain max |err| {err} > {ATTN_TOL[dtype]}")
            errs[dtype] = max(errs[dtype], err)
            if dtype != torch.float32 and fa.forward_plan(
                    B, H, Lq, Lk, D)["form"] == "long" \
                    and not forward_twice_equal(lambda: fa.flash_attention_cuda(
                        q, k, v, mask, causal)):
                raise AssertionError(f"{name} {dtype}: two long-form calls "
                                     f"on the same inputs differ")
    # timing and bounds at the main path's dtype and mask, bf16 (a
    # cache_pos case at the middle index, whose mask keeps half the keys)
    q, k, v, mask = attention_inputs(
        B, H, Lq, Lk, D, kind, torch.bfloat16, gen,
        CACHE_INDICES[1] if kind == "cache_pos" else None)
    sdpa_mask = mask
    if causal:
        tri = torch.ones(Lq, Lk, dtype=torch.bool,
                         device="cuda").tril(Lk - Lq)
        sdpa_mask = tri if mask is None else mask & tri

    def kernel():
        return fa.flash_attention_cuda(q, k, v, mask, causal)

    def plain():
        return fa.attention_reference(q, k, v, mask, causal)

    def library():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask)
    times = {f"{label}_ms": device_ms(fn) for label, fn in
             (("kernel", kernel), ("plain", plain), ("library", library))}
    times.update({f"{label}_eager_ms": eager_ms(fn) for label, fn in
                  (("kernel", kernel), ("library", library))})
    if kind == "cache_pos":     # the mean over a generate's steps
        works = [attention_work(q, k, cache_pos_mask(Lk, cur), causal)
                 for cur in range(Lk)]
        nbytes, flops = (sum(w[i] for w in works) / Lk for i in (0, 1))
    else:
        nbytes, flops, _ = attention_work(q, k, mask, causal)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
    row = {"case": name, "B": B, "H": H, "Lq": Lq, "Lk": Lk, "D": D,
           "mask": kind, "mask_checked_also": check_kind, "causal": causal,
           **forward_form(q, k),
           "calls_per_forward": calls_per_forward,
           "calls_per_generate": calls_per_generate,
           "max_abs_err_bf16": errs[torch.bfloat16],
           "max_abs_err_f16": errs[torch.float16],
           "max_abs_err_f32": errs[torch.float32],
           "tol_bf16": ATTN_TOL[torch.bfloat16],
           "tol_f16": ATTN_TOL[torch.float16],
           "tol_f32": ATTN_TOL[torch.float32],
           **times, "bytes": nbytes, "flops": flops,
           "bound_us": max(t_bytes, t_flops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_flops else "operations"}
    if kind == "cache_pos":
        row["cur_indices_checked"] = list(CACHE_INDICES)
        row["cur_index_timed"] = CACHE_INDICES[1]
        row["work_over_cur_indices"] = [0, Lk - 1]
    emit({"attention_case": row})
    return row


def kernel_phase() -> dict:
    """Rows keyed by case: the classification serving forward's cases
    (ATTN_CASES) and the generative path's (GEN_CASES)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for name, B, H, Lq, Lk, D, kind, causal, calls in ATTN_CASES:
        rows[name] = attention_case(name, B, H, Lq, Lk, D, kind, causal, gen,
                                    calls_per_forward=calls)
    for name, B, H, Lq, Lk, D, kind, check_kind, calls in GEN_CASES:
        rows[name] = attention_case(name, B, H, Lq, Lk, D, kind, False, gen,
                                    calls_per_generate=calls,
                                    check_kind=check_kind)
    return rows


def forward_line(rows: dict) -> dict:
    """The serving forward's bf16 time by graph replay, with SDPA's and
    the bound beside it: per flagship forward (its 36 calls at the five
    serving shapes), per beam generate at batch 16 (its 411 calls) and per
    call at each single-query decode shape."""
    def per(calls_key):
        t = _path_totals(rows, calls_key)
        return {k: t[k] for k in ("ms", "library_ms", "bound_ms", "bound_by")}
    return {"serving_forward": {
        "per_flagship_forward": per("calls_per_forward"),
        "per_beam_generate_b16": per("calls_per_generate"),
        "decode_calls": {
            r["case"]: {"ms": r["kernel_ms"], "library_ms": r["library_ms"],
                        "bound_ms": r["bound_us"] / 1e3, "form": r["form"]}
            for r in rows.values() if r["Lq"] == 1}}}


# -- phase 3, training kernels ----------------------------------------------
def train_attention_work(q, k, mask, causal) -> dict:
    """Bytes (each input read once, each output written once) and flops of
    each training kernel, for the (query, key) pairs the softmax takes (a
    row with no allowed key takes all Lk): the forward reads q, k, v,
    writes o, m, l, 4*D flops per pair; the one-pass backward reads q, o,
    dO, m, l and writes dq, reads of k and v only the key rows some query
    takes (``attention_work``) and writes dk and dv whole, 10*D flops per
    pair (s, dP, dV, dK, dQ). The long form's f32 dQ partials are that
    kernel's own traffic, not the function's, and stay out of the bound
    (``bwd_scratch_bytes``). The mask, where there is one, is read once as
    it is stored (a (B, 1, 1, Lk) key mask is B * Lk bytes: the kernels
    read its query axis with stride 0)."""
    B, H, Lq, D = q.shape
    nbytes, flops, key_rows = attention_work(q, k, mask, causal)
    pairs = flops // (4 * D)
    e, nq, nk, nk_read = q.element_size(), q.numel(), k.numel(), key_rows * D
    stats = B * H * Lq * 4
    mask_b = 0 if mask is None else mask.numel()
    bwd_bytes = (4 * nq + 2 * nk_read + 2 * nk) * e + 2 * stats + mask_b
    return {"flash_attn_fwd_lse": (nbytes + 2 * stats, 4 * D * pairs),
            "flash_attn_bwd": (bwd_bytes, 10 * D * pairs)}


def fwd_scratch_bytes(q, k) -> int:
    """Bytes of the forward's f32 split partials (o, m and l of every
    split, batch row, head and query), written and read once: its long
    form's overhead over the bound where it splits the keys (0
    otherwise)."""
    scratch = fa.forward_plan(*q.shape[:3], k.shape[2], q.shape[3])[
        "scratch"]
    return 0 if scratch is None else 2 * math.prod(scratch) * 4


def bwd_scratch_bytes(q, k) -> int:
    """Bytes of the one-pass backward's f32 dQ partials, written and read
    once: its long form's overhead over the bound (0 in the short form)."""
    scratch = fa.backward_plan(*q.shape[:3], k.shape[2], q.shape[3])[
        "scratch"]
    return 0 if scratch is None else 2 * math.prod(scratch) * 4


def _grad_err(got, want) -> float:
    """max |got - want| relative to want's largest value (at least 1)."""
    want = want.float()
    return float((got.float() - want).abs().max()) / max(
        1.0, float(want.abs().max()))


def _stat_err(got, want) -> float:
    """max |got - want| / (1 + |want|), elementwise (m is -1e30 on fully
    masked rows in both)."""
    return float(((got - want).abs() / (1 + want.abs())).max())


def train_kernels_once(q, k, v, do, mask, causal, rate, key):
    """The training forward, then the backward as the model calls it (the
    one-pass kernel in bf16 and f16, the dQ and dK/dV pair in f32), twice;
    (o, m, l, dq, dk, dv) and whether the two backward calls agree bit
    for bit."""
    o, m, l = fa.flash_attention_fwd_lse_cuda(q, k, v, mask, causal, rate,
                                              key)
    grads = fa.flash_attention_bwd_cuda(q, k, v, o, m, l, do, mask, causal,
                                        rate, key)
    again = fa.flash_attention_bwd_cuda(q, k, v, o, m, l, do, mask, causal,
                                        rate, key)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(grads, again))
    return (o, m, l, *grads), same


def check_train_kernels(q, k, v, do, mask, causal, rate, key) -> dict:
    """Each training kernel against its plain version on the same inputs;
    the backward gets the kernel forward's o, m and l, and two backward
    calls must be bit-equal."""
    dtype = q.dtype
    with recording_launches(CHECKED):
        (o, m, l, dq, dk, dv), same = train_kernels_once(
            q, k, v, do, mask, causal, rate, key)
    if not same:
        raise AssertionError(f"backward ({dtype}, dropout {rate}): two "
                             f"calls on the same inputs differ")
    if dtype != torch.float32 and forward_form(q, k)["form"] == "long" \
            and not forward_twice_equal(lambda: fa.flash_attention_fwd_lse_cuda(
                q, k, v, mask, causal, rate, key)):
        raise AssertionError(f"training forward ({dtype}, dropout {rate}): "
                             f"two long-form calls on the same inputs "
                             f"differ")
    o_r, m_r, l_r = fa.attention_forward_lse_reference(q, k, v, mask, causal,
                                                       rate, key)
    dq_r, dk_r, dv_r = fa.attention_backward_reference(
        q, k, v, o, m, l, do, mask, causal, rate, key)
    torch.cuda.synchronize()
    errs = {"o": _grad_err(o, o_r),
            "m": _stat_err(m, m_r), "l": _stat_err(l, l_r),
            "dq": _grad_err(dq, dq_r), "dk": _grad_err(dk, dk_r),
            "dv": _grad_err(dv, dv_r)}
    tols = {"o": ATTN_TOL[dtype], "m": STAT_TOL, "l": STAT_TOL,
            "dq": GRAD_TOL[dtype], "dk": GRAD_TOL[dtype],
            "dv": GRAD_TOL[dtype]}
    for name, err in errs.items():
        if not math.isfinite(err) or err > tols[name]:
            raise AssertionError(f"{name} ({dtype}, dropout {rate}): kernel "
                                 f"vs plain error {err} > {tols[name]}")
    return errs


def train_kernel_phase() -> dict:
    """Rows keyed (case, dropout rate)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    for name, B, H, Lq, Lk, D, kind, causal, calls, path_rate in TRAIN_CASES:
        for rate in (0.0, DROPOUT):
            key = fa.dropout_key(2026, len(rows))
            errs = {}
            for dtype in (torch.float32, torch.float16, torch.bfloat16):
                q, k, v, mask = attention_inputs(B, H, Lq, Lk, D, kind,
                                                 dtype, gen)
                do = torch.randn(q.shape, generator=gen,
                                 device="cuda").to(dtype)
                errs[dtype] = check_train_kernels(q, k, v, do, mask, causal,
                                                  rate, key)
            row = {"case": name, "B": B, "H": H, "Lq": Lq, "Lk": Lk, "D": D,
                   "mask": kind, "causal": causal, "dropout": rate,
                   "calls_per_step": calls if rate == path_rate else 0,
                   "max_err_bf16": errs[torch.bfloat16],
                   "max_err_f16": errs[torch.float16],
                   "max_err_f32": errs[torch.float32],
                   "tol": {"o_rel_16bit": ATTN_TOL[torch.bfloat16],
                           "o_rel_f32": ATTN_TOL[torch.float32],
                           "m_l_rel": STAT_TOL,
                           "grad_rel_16bit": GRAD_TOL[torch.bfloat16],
                           "grad_rel_f32": GRAD_TOL[torch.float32]},
                   **time_train_kernels(q, k, v, do, mask, causal, rate, key)}
            emit({"training_attention_case": row})
            rows[(name, rate)] = row
    return rows


def time_train_kernels(q, k, v, do, mask, causal, rate, key) -> dict:
    """At bf16, the main path's dtype: each kernel's device time (CUDA
    graph of 20 calls, CUDA events), its plain version's, the bound, and
    scaled_dot_product_attention through autograd as the yardstick, timed
    the same way (``device_ms``: a profiler session, which summed its
    kernels' durations before, costs a third of a second): its
    forward for the forward kernel, and its backward (the forward and
    backward less the forward), which like the one-pass kernel computes
    dq, dk and dv in one call, for the backward (every launch of the
    kernel's call: two in its long form)."""
    o, m, l = fa.flash_attention_fwd_lse_cuda(q, k, v, mask, causal, rate,
                                              key)
    kernels = {
        "flash_attn_fwd_lse": lambda: fa.flash_attention_fwd_lse_cuda(
            q, k, v, mask, causal, rate, key),
        "flash_attn_bwd": lambda: fa.flash_attention_bwd_fused_cuda(
            q, k, v, o, m, l, do, mask, causal, rate, key)}
    plains = {
        "flash_attn_fwd_lse": lambda: fa.attention_forward_lse_reference(
            q, k, v, mask, causal, rate, key),
        "flash_attn_bwd": lambda: fa.attention_backward_reference(
            q, k, v, o, m, l, do, mask, causal, rate, key)}
    Lq, Lk = q.shape[2], k.shape[2]
    sdpa_mask = mask
    if causal:
        tri = torch.ones(Lq, Lk, dtype=torch.bool, device="cuda").tril(Lk - Lq)
        sdpa_mask = tri if mask is None else mask & tri
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qg, kg, vg, attn_mask=sdpa_mask,
                                              dropout_p=rate)
    lib_fwd = device_ms(sdpa)
    lib_fwd_bwd = device_ms(
        lambda: torch.autograd.grad(sdpa(), (qg, kg, vg), do))
    library = {"flash_attn_fwd_lse": lib_fwd,
               "flash_attn_bwd": lib_fwd_bwd - lib_fwd}
    work = train_attention_work(q, k, mask, causal)
    times = {}
    for name in TRAIN_KERNELS:
        nbytes, flops = work[name]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_flops = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
        times[name] = {
            "kernel_ms": device_ms(kernels[name]),
            "plain_ms": device_ms(plains[name]),
            "library_ms": library[name],
            "bytes": nbytes, "flops": flops,
            "bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations"}
    times["flash_attn_fwd_lse"].update(forward_form(q, k))
    times["flash_attn_bwd"]["scratch_bytes"] = bwd_scratch_bytes(q, k)
    times["library_fwd_bwd_ms"] = lib_fwd_bwd
    return times


# -- phase 3, the generative step's training kernels -------------------------
def gen_train_cases(cfg: GenerativeVQAConfig, batch: int) -> list:
    """(name, B, H, Lq, Lk, mask kind, calls per step, the dropout rate
    of those calls) of the generative train step's attention: the ViT and
    text self-attention, the fusion over [49 patch tokens; 64 question
    tokens] under the query-AND-key mask, and per decoder layer one
    self-attention call under causal AND answer padding and one
    cross-attention call over the memory under its key mask."""
    vis = cfg.visual
    n_vis = (vis.image_size // vis.patch_size) ** 2
    Lq, La = cfg.text.max_length, cfg.max_answer_length
    return [
        ("gen_vit_self", batch, vis.num_heads, n_vis + 1, n_vis + 1, None,
         vis.num_layers, vis.dropout),
        ("gen_text_self", batch, cfg.text.num_heads, Lq, Lq, "text",
         cfg.text.num_layers, cfg.text.dropout),
        ("gen_fusion_self", batch, cfg.fusion_heads, n_vis + Lq, n_vis + Lq,
         "fusion", cfg.fusion_layers, cfg.dropout),
        ("gen_dec_self", batch, cfg.decoder_heads, La, La, "dec_self",
         cfg.decoder_layers, cfg.dropout),
        ("gen_dec_cross", batch, cfg.decoder_heads, La, n_vis + Lq, "cross",
         cfg.decoder_layers, cfg.dropout)]


def gen_train_masks(cfg: GenerativeVQAConfig, batch: int, gen) -> dict:
    """The masks the generative model builds for a batch of questions of
    3-60 tokens and answers of 1-6 tokens, by the model's own functions:
    (B, 1, Lq, Lk) bool, the cross mask (B, 1, 1, Lk), whose query axis
    the kernels read with stride 0."""
    vis = cfg.visual
    n_vis = (vis.image_size // vis.patch_size) ** 2
    Lq, La = cfg.text.max_length, cfg.max_answer_length
    dev = gen.device
    q_len = torch.randint(3, 61, (batch,), generator=gen, device=dev)
    a_len = torch.randint(1, 7, (batch,), generator=gen, device=dev) + 1
    q_mask = (torch.arange(Lq, device=dev)[None] < q_len[:, None]).int()
    d_mask = (torch.arange(La, device=dev)[None] < a_len[:, None]).int()
    memory = torch.cat([torch.ones(batch, n_vis, dtype=torch.int32,
                                   device=dev), q_mask], dim=1)
    return {"text": make_attention_mask(q_mask, q_mask),
            "fusion": make_attention_mask(memory, memory),
            "dec_self": make_causal_mask(d_mask)
            & make_attention_mask(d_mask, d_mask),
            "cross": make_attention_mask(None, memory)}


def gen_train_kernel_phase(cfg: GenerativeVQAConfig,
                           batch: int = GEN_TRAIN_BATCH) -> dict:
    """Rows keyed (case, dropout rate): each of the training kernels
    at the generative step's shapes and masks, against its plain version
    in f32, f16 and bf16, with attention dropout at 0 and at GEN_DROPOUT
    (and at the path's rate where that is another), then timed in bf16
    as ``time_train_kernels`` times the classification cases."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = {}
    for name, B, H, Lq, Lk, kind, calls, path_rate in gen_train_cases(cfg,
                                                                      batch):
        masks = gen_train_masks(cfg, B, gen)
        mask = None if kind is None else masks[kind]
        for rate in sorted({0.0, GEN_DROPOUT, path_rate}):
            key = fa.dropout_key(2027, len(rows))
            errs = {}
            for dtype in (torch.float32, torch.float16, torch.bfloat16):
                q, k, v, do = (torch.randn(B, H, L, 64, generator=gen,
                                           device="cuda").to(dtype)
                               for L in (Lq, Lk, Lk, Lq))
                errs[dtype] = check_train_kernels(q, k, v, do, mask, False,
                                                  rate, key)
            row = {"case": name, "B": B, "H": H, "Lq": Lq, "Lk": Lk, "D": 64,
                   "mask": kind,
                   "mask_shape": None if mask is None else list(mask.shape),
                   "keyless_rows": 0 if mask is None else int(
                       (~mask.expand(B, 1, Lq, Lk).any(-1)).sum()),
                   "dropout": rate,
                   "calls_per_step": calls if rate == path_rate else 0,
                   "max_err_bf16": errs[torch.bfloat16],
                   "max_err_f16": errs[torch.float16],
                   "max_err_f32": errs[torch.float32],
                   **time_train_kernels(q, k, v, do, mask, False, rate, key)}
            emit({"gen_training_attention_case": row})
            rows[(name, rate)] = row
    return rows


def step_totals(rows: dict) -> dict:
    """Per training kernel, the rows' numbers over one step's calls (each
    shape's number times its calls at the dropout those calls use): ms,
    profiler ms, plain ms, the bound from the summed bytes and flops, and
    SDPA's time (its backward under the backward kernel)."""
    main = [r for r in rows.values() if r["calls_per_step"]]
    err_keys = {"flash_attn_fwd_lse": ("o", "m", "l"),
                "flash_attn_bwd": ("dq", "dk", "dv")}
    out = {}
    for name in TRAIN_KERNELS:
        def total(key):
            return sum(r[name][key] * r["calls_per_step"] for r in main)
        t_bytes = total("bytes") / HBM_BYTES_PER_S * 1e3
        t_flops = total("flops") / PEAK_FLOPS[torch.bfloat16] * 1e3
        out[name] = {
            "calls_per_step": sum(r["calls_per_step"] for r in main),
            "max_abs_err": max(r["max_err_bf16"][k] for r in main
                               for k in err_keys[name]),
            "ms": total("kernel_ms"), "plain_ms": total("plain_ms"),
            "bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations",
            "library_ms": total("library_ms"),
            "by_case_ms": {r["case"]: r[name]["kernel_ms"] * r["calls_per_step"]
                           for r in main}}
    return out


# -- phase 4: serving --------------------------------------------------------
WORDS = ("cái gì màu có bao nhiêu con mèo chó người đàn ông phụ nữ đang làm "
         "ở trên dưới bàn ghế xe đạp máy bay nhà cửa sổ bên trái phải "
         "trong ảnh này là không vậy").split()


def make_requests(n: int, seed: int, image_hw=(256, 320)):
    """Seeded uint8 images and questions of 3 to 60 words."""
    rs = np.random.RandomState(seed)
    images = [rs.randint(0, 256, (*image_hw, 3), dtype=np.uint8)
              for _ in range(n)]
    lengths = rs.randint(3, 61, n)
    questions = [" ".join(rs.choice(WORDS, size=L)) for L in lengths]
    return images, questions


def compare_logits(card: np.ndarray, cpu: np.ndarray) -> dict:
    """Card vs CPU logits of the same weights and inputs. Both compute the
    trunk in bf16 but round and sum in different places over ~40 layers,
    so the tolerance scales with the logits: max |diff| <= 5% of
    max |logit|. Top-1 must agree on every request whose CPU margin
    between its top two answers exceeds twice that tolerance."""
    diff = float(np.abs(card - cpu).max())
    tol = 0.05 * float(np.abs(cpu).max())
    top_card, top_cpu = card.argmax(-1), cpu.argmax(-1)
    srt = np.sort(cpu, axis=-1)
    margin = srt[:, -1] - srt[:, -2]
    decided = margin > 2 * tol
    out = {"max_abs_logit_diff": diff, "tolerance": tol,
           "top1_agree": int((top_card == top_cpu).sum()),
           "requests": int(len(cpu)),
           "decided": int(decided.sum()),
           "decided_agree": int((top_card == top_cpu)[decided].sum())}
    if not math.isfinite(diff) or diff > tol \
            or out["decided_agree"] != out["decided"]:
        raise AssertionError(f"card vs CPU logits disagree: {out}")
    return out


def serving_phase(cfg: VQAModelConfig, device: str, batches: int = 10,
                  batch: int = 8, seed: int = 0,
                  calls_per_forward: int = ATTN_CALLS_PER_FORWARD,
                  profile: bool = True) -> dict:
    """Answer ``batches`` batches of ``batch`` requests through
    VQAPredictor on ``device``; count kernel launches (``calls_per_forward``
    a forward); check one batch on a copy of the model with every stack
    cut to ``check_depth``'s layers, on the card against the same weights
    on the CPU (and, where the model has the sparse MoE, the layer's
    dropped fraction on the CPU model's own MoE input, which must be equal
    on both); with ``profile``, one batch's forward eager, as a CUDA graph
    and under the profiler."""
    image_size = cfg.visual.image_size
    tok = WhitespaceTokenizer(max_length=cfg.text.max_length)
    tok.build_vocab(WORDS)
    id2answer = {i: f"answer_{i}" for i in range(cfg.num_answers)}
    t0 = time.perf_counter()
    model = model_on(cfg, device, seed)
    predictor = VQAPredictor(model, tok, id2answer, image_size=image_size,
                             top_k=5, batch_pad=batch, device=device)
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())

    warm_images, warm_questions = make_requests(batch, seed + 100)
    predictor.predict_batch(warm_images, warm_questions)     # warm-up

    requests = [make_requests(batch, seed + 1 + i) for i in range(batches)]
    fa.reset_launch_counts()
    latencies, forward_ms, answers = [], [], []
    for images, questions in requests:
        t = time.perf_counter()
        results = predictor.predict_batch(images, questions)
        latencies.append((time.perf_counter() - t) * 1e3)
        forward_ms.append(results[0].inference_ms * len(results))
        answers.append([r.answer for r in results])
        for r in results:
            if not (math.isfinite(r.confidence) and 0 < r.confidence <= 1
                    and len(r.top_answers) == 5):
                raise AssertionError(f"bad prediction {r}")
    launches = launch_snapshot()
    want = calls_per_forward * batches if device == "cuda" else 0
    if launches["flash_attn_fwd"] != want:
        raise AssertionError(f"attention launches {launches} != {want} "
                             f"({calls_per_forward} x {batches})")

    images, questions = requests[0]
    px = np.stack([predictor.transform(im) for im in images])
    enc = tok.encode_batch(questions, cfg.text.max_length)
    args = (torch.from_numpy(px), torch.from_numpy(enc["input_ids"]),
            torch.from_numpy(enc["attention_mask"]))
    dev_args = tuple(a.to(predictor.device) for a in args)
    cpu_model = cpu_copy(check_depth(cfg), predictor.device, seed)
    small = copy.deepcopy(cpu_model).to(predictor.device)
    sparse = isinstance(getattr(cpu_model, "moe", None), SparseMOELayer)
    moe_in = []
    hook = cpu_model.moe.register_forward_hook(
        lambda m, a, out: moe_in.append(a[0])) if sparse else None
    with torch.inference_mode():
        card_out = small(*dev_args)
        t = time.perf_counter()
        cpu_out = cpu_model(*args)
        cpu_s = time.perf_counter() - t
        if sparse:
            hook.remove()
            same_input = small.moe(moe_in[0].to(small.moe.ln_out.weight
                                                 .device))[1]["metrics"]
    card_logits = card_out["logits"].float().cpu().numpy()
    cpu_logits = cpu_out["logits"].float().numpy()
    if card_logits.shape != (batch, cfg.num_answers) \
            or not np.isfinite(card_logits).all():
        raise AssertionError(f"bad logits {card_logits.shape}")
    check = compare_logits(card_logits, cpu_logits)
    check["depth"] = CUT_LAYERS
    if sparse:
        # the card's fused tokens differ from the CPU's by bf16 noise, so
        # a token whose top-2 or queue place is within that noise may
        # route differently in the whole model; on the CPU model's MoE
        # input the layer must drop the same assignments
        frac = {"card": float(same_input["dropped_token_fraction"]),
                "cpu": float(cpu_out["moe_metrics"]
                             ["dropped_token_fraction"])}
        check["dropped_token_fraction_same_input"] = frac
        check["dropped_token_fraction_in_the_model"] = {
            dev: float(out["moe_metrics"]["dropped_token_fraction"])
            for dev, out in (("card", card_out), ("cpu", cpu_out))}
        if frac["card"] != frac["cpu"]:
            raise AssertionError(f"the sparse MoE drops other assignments "
                                 f"on the card: {check}")
    profile = profile_phase(model, dev_args) \
        if device == "cuda" and profile else None
    mean_latency = float(np.mean(latencies))
    return {"params": n_params, "setup_s": setup_s, "batches": batches,
            "batch": batch,
            "question_lengths": [int(m.sum()) for m in enc["attention_mask"]],
            "batch_latency_ms": latencies, "forward_ms": forward_ms,
            "mean_batch_latency_ms": mean_latency,
            "median_batch_latency_ms": float(np.median(latencies)),
            "answers_per_s": batch * 1e3 / mean_latency,
            "launches": launches, "launches_per_forward":
                launches["flash_attn_fwd"] / batches,
            "first_answers": answers[0], "cpu_check": check,
            "profile": profile,
            "cpu_forward_s": cpu_s}


# -- phase 4, end: where the serving forward's time goes ---------------------
def profile_phase(model, args, forwards: int = 3) -> dict:
    """One batch's forward three ways: eager (host clock to a
    synchronize), replayed as one CUDA graph (the device's own time with
    the host's dispatch removed), and under torch.profiler (the kernels'
    device time, so the device's idle share of the eager forward)."""
    from torch.profiler import ProfilerActivity, profile

    def forward():
        return model(*args)["logits"]

    with torch.inference_mode():
        for _ in range(2):
            forward()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(forwards):
            forward()
        torch.cuda.synchronize()
        eager = (time.perf_counter() - t0) * 1e3 / forwards

        graph = captured(forward)
        graph.replay()
        torch.cuda.synchronize()
        graphed = _events_ms(graph.replay, 10)

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(forwards):
                forward()
            torch.cuda.synchronize()
    kernels = device_kernels(prof)
    busy = sum(t for _, t in kernels.values()) / 1e3 / forwards
    fwd = fa.DEVICE_KERNEL_NAMES["flash_attn_fwd"]
    attn = sum(t for n, (_, t) in kernels.items()
               if fwd in n) / 1e3 / forwards
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
    return {
        "eager_forward_ms": eager, "graph_forward_ms": graphed,
        "device_busy_ms": busy if kernels else None,
        "device_idle_share": 1 - busy / eager if kernels else None,
        "attention_device_ms": attn if kernels else None,
        "kernels_per_forward": sum(c for c, _ in kernels.values())
        / forwards,
        "top_kernels": [{"name": n[:90], "calls": c / forwards,
                         "ms": t / 1e3 / forwards} for n, (c, t) in top]}


# -- phase 6: training ------------------------------------------------------
def training_phase(cfg: VQAModelConfig, device: str = "cuda",
                   steps: int = 10, warmup: int = 3,
                   batch: int = TRAIN_BATCH, seed: int = 0,
                   calls_per_step: int = ATTN_CALLS_PER_STEP,
                   profile: bool = True) -> dict:
    """``steps`` timed train steps on ``device`` after ``warmup``; every
    step ends in a synchronize, so step_ms is what a training loop that
    reads its loss pays; ``calls_per_step`` launches of each training
    kernel a step; with ``profile``, one step under the profiler. (On the
    CPU, a rehearsal at a tiny size: no events, launches or profile.)"""
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t0 = time.perf_counter()
    model = model_on(cfg, device, seed)
    state = TrainState.create(model, bench_optimizer(model), seed=seed)
    train_step = make_train_step(classification_loss_fn())
    data = synthetic_batch(cfg, batch, device)
    sync()
    setup_s = time.perf_counter() - t0
    for _ in range(warmup):
        train_step(state, data)
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    host_ms, event_ms, metrics = profiling.time_train_steps(train_step,
                                                              state, data,
                                                              steps)
    launches = launch_snapshot()
    calls = calls_per_step * steps if on_card else 0
    want = {name: calls for name in TRAIN_KERNELS}
    want["flash_attn_fwd"] = 0
    if launches != want:
        raise AssertionError(f"training launches {launches} != {want}")
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"non-finite loss {losses} or grad_norm {norms}")
    step_ms = float(np.median(host_ms))
    return {"params": sum(p.numel() for p in model.parameters()),
            "batch": batch, "steps": steps, "warmup_steps": warmup,
            "setup_s": setup_s, "step_ms": host_ms, "step_event_ms": event_ms,
            "median_step_ms": step_ms,
            "qa_pairs_per_s": batch * 1e3 / step_ms,
            "loss": losses, "grad_norm": norms,
            "max_memory_allocated_gib":
                torch.cuda.max_memory_allocated() / 2 ** 30 if on_card
                else None,
            "launches": launches,
            "launches_per_step": {n: launches[n] / steps
                                  for n in TRAIN_KERNELS},
            "profile": train_profile(state, train_step, data, step_ms)
            if on_card and profile else None}


def train_profile(state, train_step, data, step_ms: float) -> dict:
    """One train step under torch.profiler: the kernels' device time, so
    the device's idle share of the eager step, each attention kernel's
    device ms, and the f32 GEMMs' (cuBLAS' f32 kernels, the generative
    step's tied logits forward and backward)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train_step(state, data)
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    busy = sum(t for _, t in kernels.values()) / 1e3
    attention = {name: sum(t for n, (_, t) in kernels.items()
                           if fa.DEVICE_KERNEL_NAMES[name] in n) / 1e3
                 for name in ("flash_attn_fwd",) + TRAIN_KERNELS}
    f32_gemms = [(c, t) for n, (c, t) in kernels.items()
                 if "f32f32" in n or "sgemm" in n]
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:12]
    return {"device_busy_ms": busy if kernels else None,
            "device_idle_share": 1 - busy / step_ms if kernels else None,
            "attention_device_ms": attention,
            "f32_gemm_device_ms": sum(t for _, t in f32_gemms) / 1e3,
            "f32_gemm_launches": sum(c for c, _ in f32_gemms),
            "kernels_per_step": sum(c for c, _ in kernels.values()),
            "top_kernels": [{"name": n[:90], "calls": c, "ms": t / 1e3}
                            for n, (c, t) in top]}


def train_check(cfg: VQAModelConfig, device: str = "cuda", steps: int = 2,
                seed: int = 0,
                calls_per_step: int = ATTN_CALLS_PER_STEP) -> dict:
    """The same weights, dropout 0, on the card and on the CPU (the plain
    versions): ``steps`` train steps on a batch of 4 with questions of
    64, 40, 17 and 5 tokens, so padded query rows are fully masked and
    their backward runs. bench.py's optimizer with a one-step warmup, so
    the second step moves the weights at lr 1e-4.

    Tolerances: the trunk is bf16 on both and rounds at other points, so
    the loss and grad_norm of each step agree to 2% and 5%. An Adam step
    moves each weight by about lr whatever the gradient's size, and a
    gradient at bf16 noise may flip sign, so elementwise the updates
    agree only to 3 lr; over all weights the two updates must point the
    same way (cosine >= 0.9)."""
    cfg0 = cfg.replace(text=cfg.text.replace(dropout=0.0),
                       fusion=cfg.fusion.replace(dropout=0.0),
                       head=cfg.head.replace(dropout=0.0))
    S, L = cfg.visual.image_size, cfg.text.max_length
    rs = np.random.RandomState(seed + 7)
    lengths = np.array([L, 40, 17, 5])
    mask = (np.arange(L)[None] < lengths[:, None]).astype(np.int64)
    data = {"pixel_values": rs.rand(4, S, S, 3).astype(np.float32),
            "input_ids": rs.randint(4, cfg.text.vocab_size - 1, (4, L)) * mask,
            "attention_mask": mask,
            "labels": rs.randint(0, cfg.num_answers, (4,))}

    weights = cpu_copy(cfg0, device, seed)

    def build(dev):
        model = no_dropout(copy.deepcopy(weights).to(dev))
        return TrainState.create(model, bench_optimizer(model, 1), seed=seed)
    out = card_vs_cpu_steps(build, classification_loss_fn(), data, device,
                            steps, calls_per_step)
    return {"batch": 4, "question_lengths": lengths.tolist(),
            "depth": cfg.text.num_layers, **out}


def card_vs_cpu_steps(build, loss_fn, data: dict, device: str, steps: int,
                      calls_per_step: int) -> dict:
    """``steps`` train steps of the same weights (``build(device)`` gives
    a TrainState) on the CPU and on ``device`` over ``data`` (numpy
    arrays), held to ``train_check``'s tolerances; every attention call
    on the card goes through the training kernels, none on the CPU."""
    runs, before = {}, None
    for dev in ("cpu", device):
        t0 = time.perf_counter()
        state = build(dev)
        model = state.model
        if before is None:
            before = {n: p.detach().clone() for n, p in
                      model.named_parameters()}
        train_step = make_train_step(loss_fn)
        batch = batch_to_device(data, torch.device(dev))
        fa.reset_launch_counts()
        metrics = [train_step(state, batch)[1] for _ in range(steps)]
        runs[dev] = {"loss": [float(m["loss"]) for m in metrics],
                     "grad_norm": [float(m["grad_norm"]) for m in metrics],
                     "launches": launch_snapshot(),
                     "seconds": time.perf_counter() - t0,
                     "update": {n: p.detach().cpu() - before[n]
                                for n, p in model.named_parameters()}}
    cpu, card = runs["cpu"], runs[device]
    lr_sum = sum(state.schedule(i) for i in range(steps))
    dot = sum(float((card["update"][n] * u).sum())
              for n, u in cpu["update"].items())
    n_cpu = math.sqrt(sum(float(u.square().sum())
                          for u in cpu["update"].values()))
    n_card = math.sqrt(sum(float(u.square().sum())
                           for u in card["update"].values()))
    max_diff = max(float((card["update"][n] - u).abs().max())
                   for n, u in cpu["update"].items())
    out = {"steps": steps,
           "loss_cpu": cpu["loss"], "loss_card": card["loss"],
           "grad_norm_cpu": cpu["grad_norm"],
           "grad_norm_card": card["grad_norm"],
           "update_cosine": dot / max(n_cpu * n_card, 1e-30),
           "update_norm_cpu": n_cpu, "update_norm_card": n_card,
           "max_abs_param_diff": max_diff, "lr_sum": lr_sum,
           "card_launches": card["launches"],
           "cpu_seconds": cpu["seconds"], "card_seconds": card["seconds"],
           "tolerance": {"loss_rel": 2e-2, "grad_norm_rel": 5e-2,
                         "param_abs": 3 * lr_sum, "update_cosine_min": 0.9}}
    rel = lambda a, b: max(abs(x - y) / abs(y) for x, y in zip(a, b))
    per_step = calls_per_step * steps if device == "cuda" else 0
    if (rel(card["loss"], cpu["loss"]) > 2e-2
            or rel(card["grad_norm"], cpu["grad_norm"]) > 5e-2
            or max_diff > 3 * lr_sum or out["update_cosine"] < 0.9
            or any(card["launches"][n] != per_step for n in TRAIN_KERNELS)
            or any(cpu["launches"].values())):
        raise AssertionError(f"card vs CPU training disagree: {out}")
    return out


# -- phase 5: generative serving ---------------------------------------------
GEN_BATCHES = (16, 64)
GEN_STRATEGIES = ("greedy", "beam")
# card vs card and card vs CPU, as compare_logits: teacher-forced tokens
# must equal the cached decode's wherever the teacher-forced top-1/top-2
# margin exceeds twice CACHE_TOL x max |logit|. Both run the same bf16
# trunk on the card; they differ in the shapes of their products (one
# query a step against 32), whose sums cuBLAS may order differently, so a
# few bf16 ulps of the logits' scale (2**-8 relative each).
CACHE_TOL = 0.02


def attention_calls_per_generate(cfg: GenerativeVQAConfig,
                                 new_tokens: int) -> int:
    """ViT and text self-attention, fusion, then per step one self and
    one cross call per decoder layer: 12 + 12 + 3 + 32 x 6 x 2 = 411 at
    bench_serving's config."""
    return (cfg.visual.num_layers + cfg.text.num_layers + cfg.fusion_layers
            + new_tokens * cfg.decoder_layers * 2)


def _first_eos_mask(seqs: torch.Tensor, eos: int) -> torch.Tensor:
    """True up to and including each row's first EOS: the positions whose
    token the decode chose (later ones hold pad)."""
    after = torch.cumsum((seqs == eos).long(), dim=1) - (seqs == eos).long()
    return after == 0


def cache_consistency(model, args, seqs, decode_cfg, **knowledge) -> dict:
    """The card's greedy sequences against its own teacher-forced argmax
    on the same tokens (BOS, then each sequence but its last token); the
    knowledge arrays, if the generate had them, reach the forward too."""
    bos = torch.full_like(seqs[:, :1], decode_cfg.bos_token_id)
    with torch.inference_mode():
        logits = model(*args, torch.cat([bos, seqs[:, :-1]], dim=1),
                       **knowledge)["logits"].float()
    top2 = logits.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    tol = CACHE_TOL * float(logits.abs().max())
    chosen = _first_eos_mask(seqs, decode_cfg.eos_token_id)
    decided = chosen & (margin > 2 * tol)
    agree = logits.argmax(-1) == seqs
    out = {"positions": int(chosen.sum()), "decided": int(decided.sum()),
           "decided_agree": int((agree & decided).sum()),
           "agree": int((agree & chosen).sum()), "tolerance": tol}
    if out["decided"] == 0 or out["decided_agree"] != out["decided"]:
        raise AssertionError(f"cached decode vs teacher forcing: {out}")
    return out


def generate_profile(generate, args, reps: int = 1) -> dict:
    """One generate eager (host clock to a synchronize, median of
    ``reps``) and under torch.profiler: device busy time, idle share, the
    forward attention kernel's device time, kernels per generate."""
    from torch.profiler import ProfilerActivity, profile
    eager = []
    for _ in range(reps):
        t0 = time.perf_counter()
        generate(*args)
        torch.cuda.synchronize()
        eager.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        generate(*args)
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    busy = sum(t for _, t in kernels.values()) / 1e3
    eager_median = float(np.median(eager))
    fwd = fa.DEVICE_KERNEL_NAMES["flash_attn_fwd"]
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
    return {"eager_generate_ms": eager_median,
            "device_busy_ms": busy if kernels else None,
            "device_idle_share": 1 - busy / eager_median if kernels else None,
            "attention_device_ms": sum(
                t for n, (_, t) in kernels.items() if fwd in n) / 1e3,
            "attention_launches": sum(
                c for n, (c, _) in kernels.items() if fwd in n),
            "kernels_per_generate": sum(c for c, _ in kernels.values()),
            "top_kernels": [{"name": n[:90], "calls": c, "ms": t / 1e3}
                            for n, (c, t) in top]}


def model_on(cfg, device: str | torch.device = "cuda", seed: int = 0):
    """The classification (or, for a ``GenerativeVQAConfig``, generative)
    model of ``cfg`` in eval mode with seeded weights drawn where it runs:
    built on ``device`` and initialised there by flax's laws from a
    generator of that device (a card-vs-CPU check builds its weights on
    the CPU instead, where drawing a full-width model takes seconds)."""
    dev = resolve_device(device)
    with dev:
        model = (GenerativeVQAModel if isinstance(cfg, GenerativeVQAConfig)
                 else VietnameseVQAModel)(cfg)
    model = model.to(dev)
    init_weights(model, torch.Generator(device=dev).manual_seed(seed))
    return model.eval()


def cpu_copy(cfg, device: str | torch.device = "cuda", seed: int = 0):
    """The CPU half of a card-vs-CPU check: ``model_on``'s model of
    ``cfg``, its weights drawn where ``device`` is, copied to the CPU (the
    card half copies it back). Drawn on the CPU, a full-width copy took
    seconds a check: the 64,001-token table and nn.Linear's own default
    draw before flax's law draws again."""
    return model_on(cfg, device, seed).cpu()


def gen_check_depth(cfg: GenerativeVQAConfig,
                    layers: int = CUT_LAYERS) -> GenerativeVQAConfig:
    """``cfg`` at its widths with every layer stack (the towers, the
    fusion, the decoder) cut to ``layers``: the model of a generative
    card-vs-CPU check or plumbing phase."""
    return cfg.replace(
        visual=cfg.visual.replace(num_layers=min(cfg.visual.num_layers,
                                                 layers)),
        text=cfg.text.replace(num_layers=min(cfg.text.num_layers, layers)),
        fusion_layers=min(cfg.fusion_layers, layers),
        decoder_layers=min(cfg.decoder_layers, layers))


def generative_phase(cfg: GenerativeVQAConfig, device: str = "cuda",
                     batches=GEN_BATCHES, new_tokens: int = 32,
                     windows: int = 1, iters: int = 5, lat_calls: int = 5,
                     seed: int = 0) -> dict:
    """bench_serving's model with seeded weights on ``device``: greedy and
    beam at each batch through ``build_generate_fn``, timed with the
    port's bench_serving functions (every forward-kernel launch counted,
    none of the training kernels); each call's sequences (B, new_tokens)
    and finite scores; the greedy sequences against teacher forcing on the
    card; card against CPU at batch 2 on a copy of the model with every
    stack cut to ``gen_check_depth``'s layers; one greedy and one beam
    generate profiled. (On the CPU, a rehearsal at a tiny size.)"""
    on_card = device == "cuda"
    t0 = time.perf_counter()
    model = model_on(cfg, device, seed)
    px, q = (torch.from_numpy(a).to(device) for a in
             bench_serving.synthetic_requests(cfg, max(batches)))
    setup_s = time.perf_counter() - t0
    per_generate = attention_calls_per_generate(cfg, new_tokens)
    gens = {s: build_generate_fn(model, bench_serving.decode_config(
        s, new_tokens)) for s in GEN_STRATEGIES}

    results, outputs, n_generates = {}, {}, 0
    fa.reset_launch_counts()
    for B in batches:
        for strategy in GEN_STRATEGIES:
            key = f"{strategy}_b{B}"
            results[key], (seqs, scores) = bench_serving.bench_one(
                gens[strategy], (px[:B], q[:B]), B, windows, iters,
                lat_calls)
            n_generates += 1 + windows * iters + lat_calls
            if seqs.shape != (B, new_tokens) \
                    or not bool(torch.isfinite(scores).all()):
                raise AssertionError(f"{key}: sequences {tuple(seqs.shape)}"
                                     f", scores {scores}")
            outputs[key] = seqs
            print(f"[generative] {key}: {results[key]}", flush=True)
    launches = launch_snapshot()
    want = {name: 0 for name in launches}
    want["flash_attn_fwd"] = per_generate * n_generates if on_card else 0
    if launches != want:
        raise AssertionError(f"generative launches {launches} != {want} "
                             f"({per_generate} x {n_generates} generates)")

    B0 = batches[0]
    decode_cfg = bench_serving.decode_config("greedy", new_tokens)
    consistency = cache_consistency(model, (px[:B0], q[:B0]),
                                    outputs[f"greedy_b{B0}"], decode_cfg)
    # card against CPU at batch 2 on the cut copy, teacher-forced on its
    # greedy sequences on the card: compare_logits' rule (5% of max
    # |logit|)
    cpu_model = cpu_copy(gen_check_depth(cfg), device, seed)
    small = copy.deepcopy(cpu_model).to(device)
    seqs2, _ = build_generate_fn(small, decode_cfg)(px[:2], q[:2])
    bos = torch.full_like(seqs2[:, :1], decode_cfg.bos_token_id)
    dec_in = torch.cat([bos, seqs2[:, :-1]], dim=1)
    with torch.inference_mode():
        card = small(px[:2], q[:2], dec_in)["logits"].float().cpu()
        t = time.perf_counter()
        cpu = cpu_model(px[:2].cpu(), q[:2].cpu(), dec_in.cpu())[
            "logits"].float()
        cpu_s = time.perf_counter() - t
    V = cpu.shape[-1]
    cpu_check = compare_logits(card.reshape(-1, V).numpy(),
                               cpu.reshape(-1, V).numpy())
    cpu_check["cpu_forward_s"] = cpu_s
    cpu_check["depth"] = CUT_LAYERS
    del small, cpu_model
    profiles = {key: generate_profile(gens[key.split("_b")[0]],
                                      (px[:B0], q[:B0]))
                for key in (f"greedy_b{B0}", f"beam_b{B0}")} \
        if on_card else None
    return {"params": sum(p.numel() for p in model.parameters()),
            "setup_s": setup_s, "new_tokens": new_tokens,
            "windows": windows, "window_iters": iters,
            "latency_calls": lat_calls, "results": results,
            "generates": n_generates, "launches": launches,
            "launches_per_generate": launches["flash_attn_fwd"]
            / n_generates,
            "attention_calls_per_generate": per_generate,
            "first_sequences": {k: v[:2].tolist() for k, v in
                                outputs.items()},
            "cache_consistency": consistency, "cpu_check": cpu_check,
            "profile": profiles}


# -- phase 7: generative training --------------------------------------------
def gen_training_config(tok: WhitespaceTokenizer) -> GenerativeVQAConfig:
    """bench_convergence_gen.py:83-96's flagship mode (bench_serving's
    model, dropout 0.05, label smoothing 0), with the tokenizer's special
    ids."""
    return bench_serving.serving_config().replace(
        dropout=GEN_DROPOUT, label_smoothing=0.0,
        bos_token_id=tok.bos_token_id, eos_token_id=tok.eos_token_id,
        pad_token_id=tok.pad_token_id)


def gen_optimizer(model, total_steps: int = 1000):
    """bench_convergence_gen.py:120-125: AdamW at lr 1e-3, weight decay
    0.01 under the no-decay mask, global-norm clipping at 1.0,
    warmup_cosine with a warmup ratio of 0.05 (of a 1,000-step run)."""
    return create_optimizer(
        OptimizerConfig(learning_rate=1e-3, weight_decay=0.01), model,
        SchedulerConfig(name="warmup_cosine", warmup_ratio=0.05,
                        total_steps=total_steps))


def gen_tokenizer() -> WhitespaceTokenizer:
    tok = WhitespaceTokenizer(max_length=64)
    tok.build_vocab(WORDS)
    return tok


def gen_train_batch(cfg: GenerativeVQAConfig, tok: WhitespaceTokenizer,
                    n: int, seed: int) -> dict:
    """``n`` seeded requests (questions of 3-60 words) with answers of 1-6
    words, through the port's GenerativeVQADataset (eval pixels,
    teacher-forcing targets) and generative_collate: numpy arrays."""
    images, questions = make_requests(n, seed)
    rs = np.random.RandomState(seed + 1000)
    answers = [" ".join(rs.choice(WORDS, size=L))
               for L in rs.randint(1, 7, n)]
    ds = GenerativeVQADataset(
        [OneSample(im, q, [a]) for im, q, a in zip(images, questions,
                                                    answers)],
        tok, ImageAugmentation(cfg.visual.image_size, mode="eval"),
        max_question_length=cfg.text.max_length,
        max_answer_length=cfg.max_answer_length)
    return generative_collate([ds[i] for i in range(n)])


def gen_calls_per_step(cfg: GenerativeVQAConfig) -> int:
    """12 ViT + 12 text + 3 fusion + 6 decoder self + 6 cross = 39."""
    return (cfg.visual.num_layers + cfg.text.num_layers + cfg.fusion_layers
            + 2 * cfg.decoder_layers)


def gen_training_phase(cfg: GenerativeVQAConfig, tok: WhitespaceTokenizer,
                       device: str = "cuda", steps: int = 10,
                       warmup: int = 3, batch: int = GEN_TRAIN_BATCH,
                       seed: int = 0) -> dict:
    """The generative train step at ``cfg`` on ``device``: ``steps`` timed
    steps after ``warmup`` on one batch (step ms by host clock and CUDA
    events, answer tokens/s and QA-pairs/s, peak memory, launches per
    step: every attention call through the training kernels, none
    through the forward), then one step under torch.profiler. (On the
    CPU, a rehearsal at a tiny size.)"""
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t0 = time.perf_counter()
    model = model_on(cfg, device, seed)
    state = TrainState.create(model, gen_optimizer(model), seed=seed)
    train_step = make_train_step(generative_loss_fn(label_smoothing=0.0))
    host = gen_train_batch(cfg, tok, batch, seed)
    data = batch_to_device(host, torch.device(device))
    n_tokens = int((host["labels"] != IGNORE_INDEX).sum())
    sync()
    setup_s = time.perf_counter() - t0
    for _ in range(warmup):
        train_step(state, data)
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    host_ms, event_ms, metrics = profiling.time_train_steps(train_step,
                                                              state, data,
                                                              steps)
    launches = launch_snapshot()
    per_step = gen_calls_per_step(cfg)
    want = {name: per_step * steps if on_card else 0
            for name in TRAIN_KERNELS}
    want["flash_attn_fwd"] = 0
    if launches != want:
        raise AssertionError(f"generative training launches {launches} != "
                             f"{want}")
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    if not all(math.isfinite(x) for x in losses + norms) \
            or int(metrics[0]["n_tokens"]) != n_tokens:
        raise AssertionError(f"loss {losses}, grad_norm {norms}, n_tokens "
                             f"{int(metrics[0]['n_tokens'])} != {n_tokens}")
    step_ms = float(np.median(host_ms))
    return {"params": sum(p.numel() for p in model.parameters()),
            "batch": batch, "steps": steps, "warmup_steps": warmup,
            "setup_s": setup_s,
            "question_tokens": host["question_mask"].sum(1).tolist(),
            "answer_positions": host["decoder_mask"].sum(1).tolist(),
            "answer_tokens_per_batch": n_tokens,
            "step_ms": host_ms, "step_event_ms": event_ms,
            "median_step_ms": step_ms,
            "median_step_event_ms": float(np.median(event_ms))
            if event_ms else None,
            "answer_tokens_per_s": n_tokens * 1e3 / step_ms,
            "qa_pairs_per_s": batch * 1e3 / step_ms,
            "loss": losses, "grad_norm": norms,
            "max_memory_allocated_gib":
                torch.cuda.max_memory_allocated() / 2 ** 30 if on_card
                else None,
            "launches": launches,
            "launches_per_step": {n: launches[n] / steps
                                  for n in TRAIN_KERNELS},
            "profile": train_profile(state, train_step, data, step_ms)
            if on_card else None}


def gen_train_check(cfg: GenerativeVQAConfig, tok: WhitespaceTokenizer,
                    device: str = "cuda", steps: int = 2,
                    seed: int = 0) -> dict:
    """The generative step card against CPU: the same weights at dropout
    0 (the text encoder's too), two steps on a batch of 4 (questions and
    answers of mixed lengths, so padded query rows and the decoder's
    keyless rows run their backward), with ``gen_optimizer``'s AdamW at a
    one-step warmup, so the second step moves the weights at lr 1e-3.
    ``train_check``'s tolerances, for the same reasons (a bf16 trunk on
    both sides, rounded at other points). The model is a copy with every
    stack cut to ``gen_check_depth``'s layers."""
    cfg0 = gen_check_depth(cfg)
    cfg0 = cfg0.replace(dropout=0.0, text=cfg0.text.replace(dropout=0.0))
    data = gen_train_batch(cfg0, tok, 4, seed + 7)
    weights = cpu_copy(cfg0, device, seed)

    def build(dev):
        model = copy.deepcopy(weights).to(dev)
        return TrainState.create(model, gen_optimizer(model, 20), seed=seed)
    out = card_vs_cpu_steps(build, generative_loss_fn(label_smoothing=0.0),
                            data, device, steps, gen_calls_per_step(cfg0))
    return {"batch": 4, "depth": CUT_LAYERS,
            "question_tokens": data["question_mask"].sum(1).tolist(),
            "answer_positions": data["decoder_mask"].sum(1).tolist(), **out}


def decode_steps_taken(seqs: torch.Tensor, eos: int) -> int:
    """Steps an early-exit greedy decode took to give ``seqs`` (B, L):
    up to the one at which its last row emitted EOS, else all L."""
    ended = seqs == eos
    if not bool(ended.any(1).all()):
        return seqs.shape[1]
    return int(ended.int().argmax(1).max()) + 1


def pipeline_phase(cfg: GenerativeVQAConfig, tok: WhitespaceTokenizer,
                   device: str = "cuda", steps: int = 3,
                   batch: int = GEN_TRAIN_BATCH,
                   val_batch: int = GEN_VAL_BATCH, seed: int = 0) -> dict:
    """One short ``GenerativeTrainingPipeline.run`` on ``device``: one
    epoch of ``steps`` steps under its default onecycle schedule, a
    one-batch greedy validation (every attention call of the generate
    through the forward kernel), a checkpoint in a temporary directory
    whose restore_best gives back the model's parameters bit for bit."""
    model = model_on(cfg, device, seed)
    train = [gen_train_batch(cfg, tok, batch, seed + 10 + i)
             for i in range(steps)]
    val = [gen_train_batch(cfg, tok, val_batch, seed + 20)]
    with tempfile.TemporaryDirectory() as directory:
        pcfg = GenerativeTrainingConfig(
            num_epochs=1, label_smoothing=0.0, checkpoint_dir=directory,
            optimizer=OptimizerConfig(learning_rate=1e-3, weight_decay=0.01),
            log_every=1, max_eval_batches=1)
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        out = GenerativeTrainingPipeline(pcfg).run(model, train, val, tok)
        seconds = time.perf_counter() - t0
        launches = launch_snapshot()
        ckpt = CheckpointManager(CheckpointConfig(directory=directory,
                                                  best_metric="bleu"))
        saved, meta = ckpt.restore_best()
        steps_saved = ckpt.all_steps()
    on_card = device == "cuda"
    same = all(torch.equal(saved["params"][n], p.detach().cpu())
               for n, p in model.named_parameters())
    # the validation generate runs the encoders' calls, then 2 x
    # decoder_layers calls a step until every row has emitted EOS (the
    # pipeline's DecodeConfig keeps early_exit); the same greedy generate
    # on the saved (so the validated) parameters says how many steps that
    # took, from its sequences
    vb = batch_to_device(val[0], torch.device(device))
    seqs, _ = build_generate_fn(model, DecodeConfig(
        max_length=cfg.max_answer_length, bos_token_id=cfg.bos_token_id,
        eos_token_id=cfg.eos_token_id, pad_token_id=cfg.pad_token_id))(
        vb["pixel_values"], vb["question_ids"], vb["question_mask"])
    decode_steps = decode_steps_taken(seqs.cpu(), cfg.eos_token_id)
    want = {name: gen_calls_per_step(cfg) * steps if on_card else 0
            for name in TRAIN_KERNELS}
    want["flash_attn_fwd"] = (attention_calls_per_generate(cfg, 0)
                              + 2 * cfg.decoder_layers * decode_steps
                              if on_card else 0)
    history = out.history
    if launches != want or len(history) != 1 \
            or not all(math.isfinite(v) for v in history[0].values()) \
            or steps_saved != [steps] or not same:
        raise AssertionError(
            f"pipeline run: launches {launches} (want {want}), history "
            f"{history}, checkpoints {steps_saved}, restore_best equal "
            f"{same}")
    return {"steps": steps, "batch": batch, "val_batch": val_batch,
            "seconds": seconds, "history": history, "launches": launches,
            "validation_decode_steps": decode_steps,
            "checkpoint_steps": steps_saved, "checkpoint_epoch":
                meta["epoch"], "restore_best_bit_equal": same}


# -- phase 8: the classification CLI pipeline --------------------------------
CLS_CORPUS = 320            # 256 / 32 / 32 samples after the 0.8 / 0.1 split
CLS_EPOCHS = 2
CLS_BATCH = 32


def cls_profile(fn, tries: int = 5) -> dict:
    """``fn`` under torch.profiler (device activity only): its attention
    kernels by name (``fa.attention_kernel_counts``), the device's busy
    time, and the host time of the same call to a synchronize, of which
    the busy time gives the device's idle share (the profiler's own host
    cost included). The profiler at times drops a kernel of a call that
    launches thousands, so ``fn`` is profiled until two profiles hold the
    most kernels any has held (at most ``tries``), and the first of those
    is returned, with the number of profiles taken and ``complete``
    (False when no two agreed)."""
    from torch.profiler import ProfilerActivity, profile
    seen = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
        kernels = device_kernels(prof)
        busy = sum(t for _, t in kernels.values()) / 1e3
        seen.append({
            "kernels": path_counts(fa.attention_kernel_counts(
                {n: c for n, (c, _) in kernels.items()})),
            "kernels_total": sum(c for c, _ in kernels.values()),
            "device_busy_ms": busy, "host_ms": host_ms,
            "device_idle_share": 1 - busy / host_ms if kernels else None})
        most = max(s["kernels_total"] for s in seen)
        fullest = [s for s in seen if s["kernels_total"] == most]
        if most and len(fullest) >= 2:
            break
    return {**fullest[0], "profiles": len(seen),
            "complete": len(fullest) >= 2}


def cls_pipeline_phase(cfg: VQAModelConfig, device: str = "cuda",
                       n: int = CLS_CORPUS, image_size: int = 224,
                       epochs: int = CLS_EPOCHS, batch: int = CLS_BATCH,
                       seed: int = 0) -> dict:
    """The classification CLI pipeline as a user drives it
    (``VQAPipeline``, as ``python -m vivqa_tpu_torch.pipelines.vqa_pipeline``
    runs it) on the learnable synthetic corpus of ``n`` images: train
    (``epochs`` epochs, medium augmentation, validation each epoch,
    best-checkpointing, the final evaluation on the best checkpoint),
    evaluate and inference from the checkpoint, each with the launch
    counts set to 0 just before and read just after. Then, through the
    same pipeline objects: the best checkpoint restored by
    ``ModelPipeline.load_checkpoint`` and validated again (its metrics
    must equal the final evaluation's); the loader's host time per batch;
    the bare step on one resident batch, against the train run's own
    steps as ``TrainingPipeline.run`` timed them; one step and one
    validation under the profiler (kernel counts by name, idle share)."""
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    calls = {"vit": cfg.visual.num_layers, "text": cfg.text.num_layers,
             "fusion": 3 * cfg.fusion.num_layers}
    per_forward = sum(calls.values()) if on_card else 0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        csv, imgs = generate_synthetic_vivqa(f"{tmp}/data", n=n,
                                             image_size=image_size,
                                             learnable=True, seed=seed)
        corpus_s = time.perf_counter() - t0
        ckpt_dir, out_dir = f"{tmp}/ckpt", f"{tmp}/out"
        vcfg = VQAPipelineConfig(
            mode="train",
            data=DataPipelineConfig(
                csv_path=str(csv), image_dir=str(imgs),
                image_size=image_size, max_question_length=cfg.text.max_length,
                batch_size=batch, augmentation_strength="medium", seed=seed),
            model=ModelPipelineConfig(model=cfg, device=device, seed=seed),
            training=TrainingPipelineConfig(
                num_epochs=epochs, checkpoint_dir=ckpt_dir, log_every=4,
                seed=seed),
            output_dir=out_dir, seed=seed)

        runs = {}
        for mode in ("train", "evaluate", "inference"):
            run_cfg = vcfg.replace(mode=mode,
                                   resume="" if mode == "train" else ckpt_dir)
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            fa.reset_launch_counts()
            t0 = time.perf_counter()
            summary = VQAPipeline(run_cfg).run()
            sync()
            with open(f"{out_dir}/run_stats.json") as f:
                stages = json.load(f)["stages"]
            runs[mode] = {"seconds": time.perf_counter() - t0,
                          "launches": launch_snapshot(),
                          "summary": summary, "stages": stages,
                          "max_memory_allocated_gib":
                              torch.cuda.max_memory_allocated() / 2 ** 30
                              if on_card else None}
        with open(f"{out_dir}/inference_results.json") as f:
            predictions = json.load(f)

        # the same data and model objects the pipeline builds
        data = DataPipeline(vcfg.data).run()
        steps = len(data.train_loader)
        n_val = len(data.val_loader.dataset)
        n_test = len(data.test_loader.dataset)
        synced = cfg.replace(
            visual=cfg.visual.replace(image_size=image_size),
            text=cfg.text.replace(vocab_size=data.tokenizer.vocab_size))
        model_out, meta = ModelPipeline(
            vcfg.model.replace(model=synced)).load_checkpoint(ckpt_dir)
        model = model_out.model
        tp = TrainingPipeline(vcfg.training)
        reload_metrics = tp.validate(model, data.val_loader, data.id2answer)

        t0 = time.perf_counter()
        for batches, host_batch in enumerate(data.train_loader, 1):
            pass
        loader_ms = (time.perf_counter() - t0) * 1e3 / batches

        state = tp._build_state(model, steps)
        train_step = make_train_step(classification_loss_fn(
            vcfg.training.moe_aux_weight, vcfg.training.label_smoothing))
        resident = batch_to_device(host_batch, model_out.device)
        bare_host, bare_event, bare_metrics = profiling.time_train_steps(
            train_step, state, resident, steps)
        losses = [float(m["loss"]) for m in bare_metrics]
        profiles = None
        if on_card:
            profiles = {
                "step": cls_profile(lambda: train_step(state, resident)),
                "validation": cls_profile(
                    lambda: tp.validate(model, data.val_loader,
                                        data.id2answer))}

    train, evaluate, infer = (runs[m]["summary"] for m in
                              ("train", "evaluate", "inference"))
    history, final = train["history"], train["final_metrics"]
    step_ms = float(np.median([t * 1e3 for epoch in train["step_seconds"]
                               for t in epoch]))
    val_batches = math.ceil(n_val / batch)
    test_batches = math.ceil(n_test / batch)
    zero = {name: 0 for name in TRAIN_KERNELS}
    want = {
        # the dummy forward of ModelPipeline, a validation per epoch and
        # the final one on the best checkpoint
        "train": {**{name: per_forward * steps * epochs
                     for name in TRAIN_KERNELS},
                  "flash_attn_fwd": per_forward
                  * (1 + (epochs + 1) * val_batches)},
        "evaluate": {**zero,
                     "flash_attn_fwd": per_forward * (1 + test_batches)},
        "inference": {**zero,
                      "flash_attn_fwd": per_forward * (1 + n_test)}}
    problems = []
    for mode, w in want.items():
        if runs[mode]["launches"] != w:
            problems.append(f"{mode} launches {runs[mode]['launches']} != "
                            f"{w}")
    finite = [h["train_loss"] for h in history] + \
        [h["val_loss"] for h in history] + [final["val_loss"]] + losses
    if len(history) != epochs or not all(math.isfinite(x) for x in finite):
        problems.append(f"history {history}, losses {losses}")
    for k, v in final.items():
        same = v == reload_metrics[k] if k != "val_loss" else \
            abs(v - reload_metrics[k]) <= 1e-3 * abs(v)
        if not same:
            problems.append(f"reloaded checkpoint {k} {reload_metrics[k]} "
                            f"!= final evaluation {v}")
    if meta["num_answers"] != train["num_answers"] \
            or model.config.num_answers != train["num_answers"]:
        problems.append(f"checkpoint num_answers {meta['num_answers']}")
    if len(predictions) != n_test or infer["num_predictions"] != n_test:
        problems.append(f"{len(predictions)} predictions for {n_test} test "
                        f"samples")
    if sorted(evaluate["metrics"]) != sorted(final) or not all(
            math.isfinite(v) for v in evaluate["metrics"].values()):
        problems.append(f"evaluate metrics {evaluate['metrics']}")
    if profiles is not None:
        step_want = {**{name: per_forward for name in TRAIN_KERNELS},
                     "flash_attn_fwd": 0, "library": []}
        val_want = {**zero, "flash_attn_fwd": per_forward * val_batches,
                    "library": []}
        if profiles["step"]["kernels"] != step_want:
            problems.append(f"profiled step {profiles['step']['kernels']} "
                            f"!= {step_want}")
        if profiles["validation"]["kernels"] != val_want:
            problems.append(f"profiled validation "
                            f"{profiles['validation']['kernels']} != "
                            f"{val_want}")
    if problems:
        raise AssertionError("cls_pipeline: " + "; ".join(problems))
    return {
        "corpus": {"n": n, "image_size": image_size,
                   "split": [len(data.train_loader.dataset), n_val, n_test],
                   "answers": train["num_answers"],
                   "text_vocab": data.tokenizer.vocab_size,
                   "seconds": corpus_s},
        "params": sum(p.numel() for p in model.parameters()),
        "batch": batch, "epochs": epochs, "steps_per_epoch": steps,
        "image_path": "native" if fastloader.is_available() else "pil",
        "loader_host_ms_per_batch": loader_ms,
        "run_seconds": {m: runs[m]["seconds"] for m in runs},
        "stage_seconds": {m: runs[m]["stages"] for m in runs},
        "train_stage_s_per_epoch":
            runs["train"]["stages"]["training_pipeline"]["seconds"] / epochs,
        "history": history, "final_metrics": final,
        "reload_metrics": reload_metrics,
        "evaluate_metrics": evaluate["metrics"],
        "predictions": len(predictions),
        "qa_pairs_per_sec_history": [h["qa_pairs_per_sec"] for h in history],
        "launches": {m: runs[m]["launches"] for m in runs},
        # by the profiler's names, in one profiled step and one validation
        "launches_per_step": None if profiles is None else {
            name: profiles["step"]["kernels"][name]
            for name in TRAIN_KERNELS},
        "launches_per_validation_forward": None if profiles is None else
            profiles["validation"]["kernels"]["flash_attn_fwd"]
            / val_batches,
        # the train run's own steps, as TrainingPipeline.run timed them
        "pipeline_step_ms": [[t * 1e3 for t in epoch]
                             for epoch in train["step_seconds"]],
        "median_pipeline_step_ms": step_ms,
        "pipeline_loop_s": train["loop_seconds"],
        "pipeline_loop_ms_per_step": [t * 1e3 / steps
                                      for t in train["loop_seconds"]],
        "pipeline_qa_pairs_per_s": batch * 1e3 / step_ms,
        "bare_step_ms": bare_host, "bare_step_event_ms": bare_event,
        "median_bare_step_ms": float(np.median(bare_host)),
        "median_bare_step_event_ms":
            float(np.median(bare_event)) if bare_event else None,
        "max_memory_allocated_gib": runs["train"]["max_memory_allocated_gib"],
        "run_max_memory_allocated_gib":
            {m: runs[m]["max_memory_allocated_gib"] for m in runs},
        "profile": profiles}


# -- phase 9: the generative CLI pipeline -------------------------------------
GEN_CLI_CORPUS = 160        # 128 / 16 / 16 samples: 4 train steps of 32
GEN_CLI_BATCH = 32
GEN_CLI_FITTED_BATCH = 16


@contextlib.contextmanager
def counting_decode(counts: dict):
    """Counts, into ``counts``, the generates (``encode`` calls in
    inference mode, as ``build_generate_fn`` makes them; a training
    forward encodes with autograd on) and the decode steps of every
    GenerativeVQAModel used inside."""
    from vivqa_tpu_torch.models.generative import GenerativeVQAModel
    encode, step = GenerativeVQAModel.encode, GenerativeVQAModel.decode_step

    def counted_encode(self, *a, **kw):
        counts["generates"] += torch.is_inference_mode_enabled()
        return encode(self, *a, **kw)

    def counted_step(self, *a, **kw):
        counts["decode_steps"] += 1
        return step(self, *a, **kw)
    GenerativeVQAModel.encode = counted_encode
    GenerativeVQAModel.decode_step = counted_step
    try:
        yield counts
    finally:
        GenerativeVQAModel.encode = encode
        GenerativeVQAModel.decode_step = step


def gen_cli_phase(cfg: GenerativeVQAConfig, device: str = "cuda",
                  n: int = GEN_CLI_CORPUS, image_size: int = 224,
                  batch: int = GEN_CLI_BATCH,
                  fitted_batch: int = GEN_CLI_FITTED_BATCH,
                  fitted_iters: int = 2, seed: int = 0) -> dict:
    """The generative CLI as a user drives it: ``generative_vqa_pipeline.
    main([...])`` with a YAML config on the learnable ``seq_answers``
    corpus of ``n`` images (bench_convergence_gen.py's flagship recipe:
    dropout 0.05, AdamW at lr 1e-3, warmup-cosine, medium augmentation):
    train (one epoch, a greedy validation, a checkpoint), then from
    ``--resume`` evaluate with beam 4 and inference, then
    ``vivqa_evaluation.main([...])`` and the fitted bench's function on
    the same checkpoint (greedy and beam at ``fitted_batch``, early exit
    against the fixed loop). Each run's launch counts are set to 0 just
    before it and read just after, and held to the config's count: 39 of
    each training kernel a step; 27 forward calls a generate and 12 a
    decode step (generates and decode steps counted at the model, the
    train run's validation steps also read from its sequences). Then the
    resumed model (every parameter on the device), the bare train step
    (host clock and events) on one resident batch, the validation's
    generate and one step under the profiler (kernels by name, idle
    share)."""
    from vivqa_tpu_torch.data import ensure_synthetic_vivqa
    from vivqa_tpu_torch.pipelines import generative_vqa_pipeline as gvp
    from vivqa_tpu_torch.pipelines import vivqa_evaluation as ve
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    per_step = gen_calls_per_step(cfg)
    enc_calls = attention_calls_per_generate(cfg, 0)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        csv, imgs = ensure_synthetic_vivqa(f"{tmp}/data", n=n,
                                           image_size=image_size,
                                           learnable=True, seq_answers=True)
        corpus_s = time.perf_counter() - t0
        ckpt, out = f"{tmp}/ckpt", f"{tmp}/out"
        pcfg = gvp.GenerativeVQAPipelineConfig(
            data=DataPipelineConfig(
                csv_path=str(csv), image_dir=str(imgs),
                image_size=image_size,
                max_question_length=cfg.text.max_length,
                max_answer_length=cfg.max_answer_length, batch_size=batch,
                augmentation_strength="medium", generative=True, seed=seed),
            model=cfg.replace(dropout=GEN_DROPOUT, label_smoothing=0.0),
            training=GenerativeTrainingConfig(
                num_epochs=1, label_smoothing=0.0, checkpoint_dir=ckpt,
                optimizer=OptimizerConfig(learning_rate=1e-3,
                                          weight_decay=0.01),
                scheduler=SchedulerConfig(name="warmup_cosine",
                                          warmup_ratio=0.05),
                log_every=1, seed=seed),
            device=device, output_dir=out, seed=seed)
        yaml_path = f"{tmp}/gen_cli.yaml"
        pcfg.to_yaml(yaml_path)
        base = ["--config", yaml_path]
        argvs = {"train": ["--mode", "train"],
                 "evaluate": ["--mode", "evaluate", "--resume", ckpt,
                              "--decode", "beam", "--num-beams", "4"],
                 "inference": ["--mode", "inference", "--resume", ckpt]}
        runs = {}

        def measured(name, fn):
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            counts = {"generates": 0, "decode_steps": 0}
            fa.reset_launch_counts()
            t0 = time.perf_counter()
            with counting_decode(counts):
                result = fn()
            sync()
            runs[name] = {"seconds": time.perf_counter() - t0,
                          "launches": launch_snapshot(), **counts,
                          "max_memory_allocated_gib":
                              torch.cuda.max_memory_allocated() / 2 ** 30
                              if on_card else None}
            return result
        summaries = {mode: measured(mode, lambda: gvp.main(base + argv))
                     for mode, argv in argvs.items()}
        vivqa = measured("vivqa_evaluation", lambda: ve.main([
            "--checkpoint-dir", ckpt, "--csv-path", str(csv),
            "--image-dir", str(imgs), "--output-dir", f"{tmp}/vivqa",
            "--device", device]))
        with open(f"{tmp}/vivqa/predictions.json") as f:
            vivqa_predictions = len(json.load(f))
        with open(summaries["inference"]["results_path"]) as f:
            inference_results = len(json.load(f))

        # the resumed model, as evaluate and inference built it
        pipe = gvp.GenerativeVQAPipeline(pcfg.replace(resume=ckpt))
        data, model = pipe._setup()
        saved, _ = CheckpointManager(CheckpointConfig(
            directory=ckpt)).restore_best()
        dev = torch.device(device)
        resumed_on_device = all(
            p.device.type == dev.type and torch.equal(
                p.detach().cpu(), saved["params"][name])
            for name, p in model.named_parameters())
        # the train run's validation generate, again on the saved
        # parameters: its steps, from its sequences
        val = batch_to_device(next(iter(data.val_loader)), dev)
        generate = build_generate_fn(model, pipe._decode_cfg(model))
        seqs, _ = generate(val["pixel_values"], val["question_ids"],
                           val["question_mask"])
        val_steps = decode_steps_taken(seqs.cpu(), model.config.eos_token_id)
        args = (val["pixel_values"], val["question_ids"], val["question_mask"])
        profiles = {"generate": cls_profile(lambda: generate(*args))} \
            if on_card else None

        fitted_model, _ = ve.load_model_from_checkpoint(ckpt, device=dev)
        host = bench_serving.fitted_batch(fitted_model.config, fitted_batch,
                                          n, f"{tmp}/data")
        fitted = measured("fitted_bench", lambda: bench_serving.bench_fitted(
            fitted_model, host, [fitted_batch], ["greedy", "beam"], 1,
            fitted_iters, fitted_iters))
        fitted_on_device = all(p.device.type == dev.type
                               for p in fitted_model.parameters())
        del fitted_model

        # the bare step and one generate on resident inputs, profiled
        steps = len(data.train_loader)
        state = TrainState.create(model, gen_optimizer(model), seed=seed)
        train_step = make_train_step(generative_loss_fn(label_smoothing=0.0))
        resident = batch_to_device(next(iter(data.train_loader)), dev)
        train_step(state, resident)
        bare_host, bare_event, bare_metrics = profiling.time_train_steps(
            train_step, state, resident, steps)
        if on_card:
            profiles["step"] = cls_profile(lambda: train_step(state, resident))

    train = summaries["train"]
    zero = {name: 0 for name in TRAIN_KERNELS}

    def fwd(mode):
        r = runs[mode]
        return (enc_calls * r["generates"]
                + 2 * cfg.decoder_layers * r["decode_steps"]) if on_card \
            else 0
    want = {mode: {**zero, "flash_attn_fwd": fwd(mode)} for mode in runs}
    want["train"].update({name: per_step * steps if on_card else 0
                          for name in TRAIN_KERNELS})
    problems = []
    for mode, w in want.items():
        if runs[mode]["launches"] != w:
            problems.append(f"{mode} launches {runs[mode]['launches']} != "
                            f"{w}")
    if runs["train"]["generates"] != 1 \
            or runs["train"]["decode_steps"] != val_steps:
        problems.append(f"train run: {runs['train']['generates']} "
                        f"generates of {runs['train']['decode_steps']} "
                        f"decode steps; its validation takes {val_steps}")
    history = train["history"]
    metrics = [summaries["evaluate"]["metrics"], vivqa["metrics"]]
    losses = [h["train_loss"] for h in history] + \
        [float(m["loss"]) for m in bare_metrics]
    if len(history) != 1 or not all(math.isfinite(v) for m in metrics
                                    for v in m.values()) \
            or not all(math.isfinite(x) for x in losses):
        problems.append(f"history {history}, metrics {metrics}, losses "
                        f"{losses}")
    if vivqa_predictions != vivqa["num_samples"] or vivqa["num_samples"] != n:
        problems.append(f"{vivqa_predictions} ViVQA predictions for "
                        f"{vivqa['num_samples']} samples read ({n} in the "
                        f"CSV)")
    n_test = len(data.test_loader.dataset)
    if inference_results != n_test:
        problems.append(f"{inference_results} generations for {n_test} "
                        f"test samples")
    if not (resumed_on_device and fitted_on_device):
        problems.append(f"resumed parameters on {device} and equal to the "
                        f"checkpoint: {resumed_on_device}; the fitted "
                        f"bench's on {device}: {fitted_on_device}")
    if profiles is not None:
        step_want = {**{name: per_step for name in TRAIN_KERNELS},
                     "flash_attn_fwd": 0, "library": []}
        gen_want = {**zero, "flash_attn_fwd": enc_calls + 2
                    * cfg.decoder_layers * val_steps, "library": []}
        for name, w in (("step", step_want), ("generate", gen_want)):
            p = profiles[name]
            if p["kernels"] != w:
                problems.append(f"profiled {name} {p['kernels']} != {w} "
                                f"(the fullest of {p['profiles']} "
                                f"profiles, complete: {p['complete']})")
    if problems:
        raise AssertionError("gen_cli: " + "; ".join(problems))
    return {
        "corpus": {"n": n, "image_size": image_size,
                   "split": [len(data.train_loader.dataset),
                             len(data.val_loader.dataset), n_test],
                   "text_vocab": data.tokenizer.vocab_size,
                   "seconds": corpus_s},
        "params": sum(p.numel() for p in model.parameters()),
        "batch": batch, "steps_per_epoch": steps,
        "run_seconds": {m: r["seconds"] for m, r in runs.items()},
        "launches": {m: r["launches"] for m, r in runs.items()},
        "generates": {m: r["generates"] for m, r in runs.items()},
        "decode_steps": {m: r["decode_steps"] for m, r in runs.items()},
        "validation_decode_steps": val_steps,
        "history": history,
        "evaluate_metrics": summaries["evaluate"]["metrics"],
        "vivqa_metrics": vivqa["metrics"],
        "vivqa_predictions": vivqa_predictions,
        "inference_results": inference_results,
        "resumed_on_device": resumed_on_device,
        "fitted": fitted,
        "bare_step_ms": bare_host, "bare_step_event_ms": bare_event,
        "median_bare_step_ms": float(np.median(bare_host)),
        "median_bare_step_event_ms":
            float(np.median(bare_event)) if bare_event else None,
        "max_memory_allocated_gib":
            {m: r["max_memory_allocated_gib"] for m, r in runs.items()},
        "profile": profiles}


# -- phase 10: the MoE ablation study -----------------------------------------
# The round-3 study's corpus and scale (reports/ablation_r3/run_study.sh),
# its corpus cut to 320 samples: 224 / 64 / 32 after the 0.7 / 0.2 / 0.1
# split, so 7 train steps and 2 validation batches of 32 an epoch
ABL_CORPUS = 320
ABL_BATCH = 32
ABL_EPOCHS = 1
ABL_SCALE = ["--image-size", "64", "--train-ratio", "0.7", "--val-ratio",
             "0.2"]
ABL_STUDY = ["--specialized-experts", "6", "--vision-experts", "0",
             "--text-experts", "0", "--multimodal-experts", "0"]
ABL_CLI_DEFAULT = ["--specialized-experts", "0", "--vision-experts", "2",
                   "--text-experts", "2", "--multimodal-experts", "2"]
# the experiments of the phase's selection: the full baseline, the dense
# model, one retrained leave-one-out and its post-hoc twin, a post-hoc
# single-expert row (whose router must then use one expert) and the soft
# router swap
ABL_SELECTION = ("full__noisy_topk_k2_lb0.01", "no_moe__noisy_topk_k2_lb0.01",
                 "leave_one_out_3__noisy_topk_k2_lb0.01",
                 "ph_leave_one_out_3__noisy_topk_k2_lb0.01",
                 "ph_single_expert_5__noisy_topk_k2_lb0.01",
                 "full__soft_k0_lb0.01")
# attention calls of one forward of each expert type (models/moe/
# experts.py, specialized.py): a query decoder layer makes two
EXPERT_ATTENTION_CALLS = {
    "vision": 1, "text": 1, "multimodal": 1,
    "object_detection": 2 * 3 + 1, "counting": 2 * 2,
    "scene_understanding": 2 + 1, "ocr": 2 * 2 + 2,
    "segmentation": 2 * 2 + 1, "spatial_reasoning": 1}


def abl_model_config(scale: tuple = ()) -> VQAModelConfig:
    """The study's classification model at the CLI's scale (or
    ``scale``'s flags), as ``run_ablation.base_model_config`` builds it;
    its vocabulary and answers are the corpus', which no kernel shape
    depends on."""
    from vivqa_tpu_torch.ablation import AblationConfig
    from vivqa_tpu_torch.ablation import run_ablation as RA
    args = RA.build_argparser().parse_args([*ABL_SCALE, *scale, *ABL_STUDY])
    study = AblationConfig(batch_size=ABL_BATCH)
    return RA.base_model_config(args, study,
                                types.SimpleNamespace(vocab_size=100),
                                RA.data_config(args, study))


def abl_study_config(tmp: str, output_dir: str) -> str:
    """reports/ablation_r3/study.yaml's search over the six specialized
    experts, with single-expert rows and post-hoc twins so that the
    selection can take them; returns the YAML's path."""
    from vivqa_tpu_torch.ablation import AblationConfig, AblationSearchSpace
    path = f"{tmp}/study.yaml"
    AblationConfig(
        search=AblationSearchSpace(
            num_experts=6, include_single_expert=True,
            include_leave_one_out=True, router_types=("noisy_topk", "soft"),
            post_hoc_masks=True),
        model_type="classification", num_epochs=6, batch_size=32,
        learning_rate=3e-4, output_dir=output_dir,
        primary_metric="exact_match", seed=42,
        expert_names=SPECIALIZED_ORDER).to_yaml(path)
    return path


def attention_calls_per_forward(cfg: VQAModelConfig) -> int:
    """The classification model's attention calls through the kernels per
    forward: each ViT-family and text encoder layer one (ResNet none;
    Swin's window attention adds its bias to the scores outside the
    kernels), each cross-attention fusion layer four (two per stream),
    MCAN and the Q-Former three per layer, single-stream one, the pooled
    fusions none, the VQA-MoE's experts theirs (the other MoE layers
    none), and KnowledgeAttention one."""
    visual = cfg.visual.num_layers if cfg.visual.backbone in (
        "vit", "clip", "dino") else 0
    per_layer = {"cross_attention": 4, "mcan": 3, "qformer": 3,
                 "single_stream": 1}.get(cfg.fusion.fusion_type, 0)
    calls = visual + cfg.text.num_layers + per_layer * cfg.fusion.num_layers \
        + int(cfg.knowledge.use_knowledge)
    if cfg.moe.use_moe and cfg.moe.moe_type == "vqa":
        m = cfg.moe
        calls += (m.num_vision_experts + m.num_text_experts
                  + m.num_multimodal_experts)
        calls += sum(EXPERT_ATTENTION_CALLS[s] for s in
                     SPECIALIZED_ORDER[:m.num_specialized_experts])
    return calls


def abl_cases(cfg: VQAModelConfig, batch: int) -> list:
    """(name, B, H, Lq, Lk, D, mask kind, calls per step, dropout) of one
    training step of the study's full model: the ViT (patches + CLS), the
    text encoder under its query-AND-key mask, the cross-attention
    fusion's four calls per layer (image self, image to text under the
    key mask, text self, text to image under the query-side mask), and
    the experts' calls over the fused tokens, unmasked, at the experts'
    width (``expert_hidden_dim``, 8 heads)."""
    vis, txt, fus = cfg.visual, cfg.text, cfg.fusion
    n_vis = (vis.image_size // vis.patch_size) ** 2
    Lt = txt.max_length
    L = n_vis + Lt
    Hf, Df = fus.num_heads, fus.hidden_dim // fus.num_heads
    He, De = 8, cfg.moe.expert_hidden_dim // 8
    r = 0.1          # the text encoder's, the fusion's and the experts'
    cases = [("abl_vit_self", batch, vis.num_heads, n_vis + 1, n_vis + 1,
              vis.hidden_dim // vis.num_heads, None, vis.num_layers,
              vis.dropout),
             ("abl_text_self", batch, txt.num_heads, Lt, Lt,
              txt.hidden_dim // txt.num_heads, "t2t", txt.num_layers,
              txt.dropout),
             ("abl_fusion_v_self", batch, Hf, n_vis, n_vis, Df, None,
              fus.num_layers, fus.dropout),
             ("abl_fusion_v2t", batch, Hf, n_vis, Lt, Df, "v2t",
              fus.num_layers, fus.dropout),
             ("abl_fusion_t_self", batch, Hf, Lt, Lt, Df, "t2t",
              fus.num_layers, fus.dropout),
             ("abl_fusion_t2v", batch, Hf, Lt, n_vis, Df, "t2v",
              fus.num_layers, fus.dropout)]
    # (Lq, Lk): calls, over the six specialized experts
    moe = {}
    for lq, lk, calls in (
            (32, 32, 3), (32, L, 3), (L, 32, 1),        # object detection
            (21, 21, 2), (21, L, 2),                    # counting
            (L + 8, L + 8, 2), (L, 9, 1),               # scene
            (16, 16, 3), (16, L, 2), (L, 16, 1),        # OCR
            (8, 8, 2), (8, L, 2), (L, 8, 1),            # segmentation
            (L, L, 1)):                                 # spatial reasoning
        moe[(lq, lk)] = moe.get((lq, lk), 0) + calls
    cases += [(f"abl_expert_{lq}x{lk}", batch, He, lq, lk, De, None, calls,
               r) for (lq, lk), calls in moe.items()]
    return cases


def abl_masks(cfg: VQAModelConfig, batch: int, gen) -> dict:
    """The fusion's and the text encoder's masks for questions of 3-64
    tokens, by the model's own function: t2t (B, 1, 64, 64), v2t (B, 1,
    16, 64) and t2v (B, 1, 64, 16), whose padded query rows are fully
    masked."""
    n_vis = (cfg.visual.image_size // cfg.visual.patch_size) ** 2
    Lt = cfg.text.max_length
    dev = gen.device
    q_len = torch.randint(3, Lt + 1, (batch,), generator=gen, device=dev)
    t_mask = (torch.arange(Lt, device=dev)[None] < q_len[:, None]).int()
    v_mask = torch.ones(batch, n_vis, dtype=torch.int32, device=dev)
    return {"t2t": make_attention_mask(t_mask, t_mask),
            "v2t": make_attention_mask(v_mask, t_mask),
            "t2v": make_attention_mask(t_mask, v_mask)}


def abl_kernel_phase(cfg: VQAModelConfig, batch: int = ABL_BATCH) -> dict:
    """Rows keyed by case: each of the four kernels at the study's shapes
    and masks against its plain version in f32 and bf16 (the training
    kernels at the call's dropout, the forward as the serving path calls
    it),
    then in bf16 the training kernels timed as ``time_train_kernels``
    times them and the forward by graph replay, beside
    its plain version, its bound and SDPA's forward."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = {}
    for name, B, H, Lq, Lk, D, kind, calls, rate in abl_cases(cfg, batch):
        mask = None if kind is None else abl_masks(cfg, B, gen)[kind]
        key = fa.dropout_key(2029, len(rows))
        errs, fwd_errs = {}, {}
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (torch.randn(B, H, L, D, generator=gen,
                                       device="cuda").to(dtype)
                           for L in (Lq, Lk, Lk, Lq))
            errs[dtype] = check_train_kernels(q, k, v, do, mask, False,
                                              rate, key)
            with recording_launches(CHECKED):
                out = fa.flash_attention_cuda(q, k, v, mask)
            ref = fa.attention_reference(q, k, v, mask)
            torch.cuda.synchronize()
            fwd_errs[dtype] = float((out.float() - ref.float()).abs().max())
            if not math.isfinite(fwd_errs[dtype]) \
                    or fwd_errs[dtype] > ATTN_TOL[dtype]:
                raise AssertionError(f"{name} {dtype}: forward kernel vs "
                                     f"plain {fwd_errs[dtype]}")
        nbytes, flops, _ = attention_work(q, k, mask, False)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_flops = flops / PEAK_FLOPS[torch.bfloat16] * 1e3

        def kernel():
            return fa.flash_attention_cuda(q, k, v, mask)
        row = {"case": name, "B": B, "H": H, "Lq": Lq, "Lk": Lk, "D": D,
               "mask": kind,
               "mask_shape": None if mask is None else list(mask.shape),
               "keyless_rows": 0 if mask is None else int(
                   (~mask.expand(B, 1, Lq, Lk).any(-1)).sum()),
               "dropout": rate, "calls_per_step": calls,
               "calls_per_forward": calls,
               "max_err_bf16": errs[torch.bfloat16],
               "max_err_f32": errs[torch.float32],
               **time_train_kernels(q, k, v, do, mask, False, rate, key),
               "flash_attn_fwd": {
                   "max_abs_err": fwd_errs[torch.bfloat16],
                   "max_abs_err_f32": fwd_errs[torch.float32],
                   "kernel_ms": device_ms(kernel),
                   "plain_ms": device_ms(
                       lambda: fa.attention_reference(q, k, v, mask)),
                   "library_ms": device_ms(
                       lambda: F.scaled_dot_product_attention(
                           q, k, v, attn_mask=mask)),
                   "bytes": nbytes, "flops": flops,
                   "bound_ms": max(t_bytes, t_flops),
                   "bound_by": "bytes" if t_bytes >= t_flops
                   else "operations"}}
        emit({"ablation_attention_case": row})
        rows[name] = row
    return rows


def abl_forward_totals(rows: dict) -> dict:
    """The forward kernel over one validation forward of the full model
    (each shape's number times its calls)."""
    def total(key):
        return sum(r["flash_attn_fwd"][key] * r["calls_per_forward"]
                   for r in rows.values())
    t_bytes = total("bytes") / HBM_BYTES_PER_S * 1e3
    t_flops = total("flops") / PEAK_FLOPS[torch.bfloat16] * 1e3
    return {"calls_per_forward": sum(r["calls_per_forward"]
                                     for r in rows.values()),
            "max_abs_err": max(r["flash_attn_fwd"]["max_abs_err"]
                               for r in rows.values()),
            "ms": total("kernel_ms"),
            "plain_ms": total("plain_ms"), "library_ms": total("library_ms"),
            "bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations"}


def abl_profile(fn, want: dict, tries: int = 3) -> dict:
    """``cls_profile`` of ``fn`` until its attention kernels by name are
    ``want`` (at most ``tries`` times: at ~7,000 kernels a step the
    profiler at times loses a kernel, which the launch counts, exact,
    do not); the last profile, with ``want`` and the ``attempts``."""
    for attempt in range(1, tries + 1):
        prof = cls_profile(fn)
        if prof["kernels"] == want:
            break
    return {**prof, "want": want, "attempts": attempt}


@contextlib.contextmanager
def recording_experiments(records: list):
    """Each ``AblationTrainer.run_experiment`` call made inside appends
    {id, seconds, launches} with the launch counts set to 0 just before
    it and read just after, and each ``TrainingPipeline.run`` its
    output's step and loop times."""
    from vivqa_tpu_torch.ablation.trainer import AblationTrainer
    run_experiment, run = AblationTrainer.run_experiment, TrainingPipeline.run

    def experiment(self, exp):
        sync = torch.cuda.synchronize if self.device.type == "cuda" \
            else (lambda: None)
        records.append({"id": exp.experiment_id, "pipelines": []})
        sync()
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        result = run_experiment(self, exp)
        sync()
        records[-1].update(seconds=time.perf_counter() - t0,
                           launches=launch_snapshot(),
                           train_steps=len(self.data.train_loader),
                           val_batches=len(self.data.val_loader))
        return result

    def pipeline(self, *args, **kwargs):
        out = run(self, *args, **kwargs)
        records[-1]["pipelines"].append(
            {"step_seconds": out.step_seconds,
             "loop_seconds": out.loop_seconds})
        return out
    AblationTrainer.run_experiment = experiment
    TrainingPipeline.run = pipeline
    try:
        yield records
    finally:
        AblationTrainer.run_experiment = run_experiment
        TrainingPipeline.run = run


def no_dropout(model: torch.nn.Module) -> torch.nn.Module:
    """Every dropout rate of ``model`` at 0 (the experts' 0.1 comes from
    VQAMoEConfig, which VQAModelConfig does not reach)."""
    for m in model.modules():
        for attr in ("dropout", "dropout_rate"):
            if isinstance(getattr(m, attr, None), float):
                setattr(m, attr, 0.0)
    return model


def abl_card_vs_cpu(cfg: VQAModelConfig, cli_default: VQAModelConfig,
                    device: str = "cuda", seed: int = 0) -> dict:
    """The study's model, the same weights on the card and on the CPU, on
    a batch of 4 questions of 64, 40, 17 and 5 tokens: eval logits with
    the noisy router (deterministic in eval) by ``compare_logits``; two
    train steps with the soft router (a noisy draw differs between the
    devices) and dropout 0 by ``card_vs_cpu_steps``; and eval logits of
    the CLI's default composition (vision, text and multimodal experts:
    80 x 80 at head dim 32, 80 x 1). Each model is a copy with every
    stack cut to ``check_depth``'s layers."""
    cfg, cli_default = check_depth(cfg), check_depth(cli_default)
    S, L = cfg.visual.image_size, cfg.text.max_length
    rs = np.random.RandomState(seed + 11)
    lengths = np.array([L, 40, 17, 5])
    mask = (np.arange(L)[None] < lengths[:, None]).astype(np.int64)
    data = {"pixel_values": rs.rand(4, S, S, 3).astype(np.float32),
            "input_ids": rs.randint(4, cfg.text.vocab_size - 1, (4, L)) * mask,
            "attention_mask": mask,
            "labels": rs.randint(0, cfg.num_answers, (4,))}

    def logits(c):
        out = {}
        weights = cpu_copy(c, device, seed)
        for dev in ("cpu", device):
            model = copy.deepcopy(weights).to(dev)
            batch = batch_to_device(data, torch.device(dev))
            with torch.no_grad():
                out[dev] = model(batch["pixel_values"], batch["input_ids"],
                                 batch["attention_mask"])["logits"]
        return compare_logits(out[device].float().cpu().numpy(),
                              out["cpu"].float().cpu().numpy())

    soft = cfg.replace(
        text=cfg.text.replace(dropout=0.0),
        fusion=cfg.fusion.replace(dropout=0.0),
        head=cfg.head.replace(dropout=0.0),
        moe=cfg.moe.replace(router_type="soft"))

    def build(dev):
        model = no_dropout(create_vqa_model(
            soft, device=dev, generator=torch.Generator().manual_seed(seed)))
        return TrainState.create(model, bench_optimizer(model, 1), seed=seed)
    calls = attention_calls_per_forward(cfg) if device == "cuda" else 0
    return {"batch": 4, "question_lengths": lengths.tolist(),
            "depth": CUT_LAYERS, "study_logits": logits(cfg),
            "soft_train_steps": card_vs_cpu_steps(
                build, classification_loss_fn(), data, device, 2, calls),
            "cli_default_logits": logits(cli_default)}


def ablation_phase(device: str = "cuda", n: int = ABL_CORPUS,
                   epochs: int = ABL_EPOCHS, batch: int = ABL_BATCH,
                   scale: tuple = (), seed: int = 0) -> dict:
    """The MoE ablation study as a user drives it, through
    ``vivqa_tpu_torch.ablation.run_ablation.main``: the round-3 study's
    model (hidden 256, 4 layers, 64 px, patch 16, expert hidden 512; or
    ``scale``'s flags) with the six specialized experts on a learnable
    synthetic corpus of ``n`` samples, ``epochs`` epochs at ``batch``,
    the experiments of ABL_SELECTION; then the same command again, which
    must skip them all (resume), and ``--report-only``. Each experiment
    runs with the launch counts set to 0 just before it and read just
    after; it must complete with router telemetry and a per-sample mask
    that agree with its metrics, and launch each training kernel the
    config's calls per forward per step and the forward kernel that many
    per validation forward. Then the card against the CPU
    (``abl_card_vs_cpu``), the bare step against the pipeline's, one step
    and one validation under the profiler."""
    from vivqa_tpu_torch.ablation import run_ablation as RA
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = f"{tmp}/out"
        image_size = RA.build_argparser().parse_args(
            [*ABL_SCALE, *scale]).image_size
        t0 = time.perf_counter()
        csv, imgs = generate_synthetic_vivqa(f"{tmp}/data", n=n,
                                             image_size=image_size,
                                             learnable=True, seed=seed)
        corpus_s = time.perf_counter() - t0
        common = ["--config", abl_study_config(tmp, out_dir),
                  "--csv-path", str(csv), "--image-dir", str(imgs),
                  "--epochs", str(epochs), "--batch-size", str(batch),
                  "--device", device, *ABL_SCALE, *scale]
        argv = common + ABL_STUDY
        args = RA.build_argparser().parse_args(argv)
        study = RA.AblationConfig.from_yaml(args.config).replace(
            num_epochs=epochs, batch_size=batch)
        matrix = [e.experiment_id for e in
                  study.generate_experiment_matrix()]
        selection = ",".join(str(matrix.index(e)) for e in ABL_SELECTION)

        records = []
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with recording_experiments(records):
            results = RA.main(argv + ["--experiments", selection])
        sync()
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card \
            else None
        fa.reset_launch_counts()
        resumed_records = []
        with recording_experiments(resumed_records):
            resumed = RA.main(argv + ["--experiments", selection])
        resume_launches = launch_snapshot()
        files = RA.main(argv + ["--report-only"])
        report_launches = launch_snapshot()
        written = {k: Path(v).stat().st_size for k, v in files.items()}
        written["manifest"] = Path(f"{out_dir}/manifest.json").stat().st_size

        # the bare step and the profiles, on the CLI's data and model
        data_cfg = RA.data_config(args, study)
        data = DataPipeline(data_cfg).run()
        base = RA.base_model_config(args, study, data.tokenizer, data_cfg)
        base = base.replace(num_answers=len(data.answer2id))
        model = model_on(base, device, 42)
        steps = len(data.train_loader)
        tp = TrainingPipeline(TrainingPipelineConfig(
            num_epochs=epochs, optimizer=OptimizerConfig(learning_rate=3e-4),
            seed=42))
        state = tp._build_state(model, steps)
        train_step = make_train_step(classification_loss_fn())
        host_batch = next(iter(data.train_loader))
        resident = batch_to_device(host_batch, torch.device(device))
        bare = profiling.time_train_steps(train_step, state, resident, steps)
        per_forward = attention_calls_per_forward(base) if on_card else 0
        val_batches = len(data.val_loader)
        profiles = None
        if on_card:
            profiles = {
                "step": abl_profile(
                    lambda: train_step(state, resident),
                    {**{name: per_forward for name in TRAIN_KERNELS},
                     "flash_attn_fwd": 0, "library": []}),
                "validation": abl_profile(
                    lambda: tp.validate(model, data.val_loader,
                                        data.id2answer),
                    {**{name: 0 for name in TRAIN_KERNELS},
                     "flash_attn_fwd": per_forward * val_batches,
                     "library": []})}
        cli_args = RA.build_argparser().parse_args(common + ABL_CLI_DEFAULT)
        cli_default = RA.base_model_config(cli_args, study, data.tokenizer,
                                           data_cfg).replace(
            num_answers=len(data.answer2id))
        n_train = len(data.train_loader.dataset)
        n_val = len(data.val_loader.dataset)

    dense = attention_calls_per_forward(
        base.replace(moe=base.moe.replace(use_moe=False))) if on_card else 0
    problems = []
    by_id = {r.experiment_id: r for r in results}
    if sorted(by_id) != sorted(ABL_SELECTION):
        problems.append(f"results {sorted(by_id)}")
    rows = {}
    for rec in records:
        eid = rec["id"]
        r = by_id[eid]
        post_hoc = eid.startswith("ph_")
        calls = dense if eid.startswith("no_moe") else per_forward
        S, V = rec["train_steps"], rec["val_batches"]
        if post_hoc:     # the mask over the val set, the telemetry batch
            want = {**{k: 0 for k in TRAIN_KERNELS},
                    "flash_attn_fwd": calls * (V + 1)}
        else:            # a validation an epoch, the best checkpoint's,
            #              the telemetry batch and the mask
            want = {**{k: calls * S * epochs for k in TRAIN_KERNELS},
                    "flash_attn_fwd": calls * (V * (epochs + 2) + 1)}
        if rec["launches"] != want:
            problems.append(f"{eid} launches {rec['launches']} != {want}")
        if r.status != "completed" or r.moe_metrics is None \
                or r.correct_mask is None:
            problems.append(f"{eid}: status {r.status}, moe_metrics "
                            f"{r.moe_metrics}, correct_mask "
                            f"{'None' if r.correct_mask is None else 'set'}"
                            f"; {r.error[-400:]}")
            continue
        em = r.metrics.get("exact_match")
        mask_mean = sum(r.correct_mask) / max(len(r.correct_mask), 1)
        if len(r.correct_mask) != n_val or em is None \
                or abs(mask_mean - em) > 0.02:
            problems.append(f"{eid}: mask of {len(r.correct_mask)} with "
                            f"mean {mask_mean} against exact_match {em}")
        if eid.startswith("ph_single_expert") \
                and r.moe_metrics.get("num_active_experts", 99) > 1:
            problems.append(f"{eid}: {r.moe_metrics['num_active_experts']} "
                            f"active experts under a single-expert mask")
        loop = [t for p in rec["pipelines"] for t in p["loop_seconds"]]
        step = [t for p in rec["pipelines"] for epoch in p["step_seconds"]
                for t in epoch]
        rows[eid] = {
            "seconds": rec["seconds"], "launches": rec["launches"],
            "exact_match": em, "n_eval": len(r.correct_mask),
            "moe": {k: r.moe_metrics.get(k) for k in
                    ("num_active_experts", "routing_entropy",
                     "load_imbalance", "expert_usage")},
            "history": [{k: h[k] for k in ("epoch", "train_loss",
                                           "val_loss", "exact_match")}
                        for h in r.history],
            "pipeline_loop_s": loop,
            "median_pipeline_step_ms":
                float(np.median(step)) * 1e3 if step else None}
    if resumed_records or sorted(r.experiment_id for r in resumed) \
            != sorted(ABL_SELECTION) or any(resume_launches.values()) \
            or any(report_launches.values()):
        problems.append(f"resume ran {[r['id'] for r in resumed_records]}, "
                        f"launches {resume_launches}, report-only "
                        f"{report_launches}")
    if set(written) != {"report", "csv", "latex", "analysis", "manifest"} \
            or not all(written.values()):
        problems.append(f"reports {written}")
    for name, prof in (profiles or {}).items():
        if prof["kernels"] != prof["want"]:
            problems.append(f"profiled {name} {prof['kernels']} != "
                            f"{prof['want']}")
    if problems:
        raise AssertionError("ablation: " + "; ".join(problems))
    check = abl_card_vs_cpu(base, cli_default, device) if on_card else None
    return {
        "corpus": {"n": n, "image_size": image_size,
                   "split": [n_train, n_val], "seconds": corpus_s},
        "params": sum(p.numel() for p in model.parameters()),
        "batch": batch, "epochs": epochs, "steps_per_epoch": steps,
        "val_batches": val_batches,
        "attention_calls_per_forward": per_forward,
        "attention_calls_per_forward_no_moe": dense,
        "selection": list(ABL_SELECTION), "run_seconds": run_s,
        "experiments": rows, "reports": written,
        "launches": {eid: row["launches"] for eid, row in rows.items()},
        "launches_per_step": {
            name: rows[ABL_SELECTION[0]]["launches"][name]
            / (steps * epochs) for name in TRAIN_KERNELS},
        "launches_per_validation_forward": None if profiles is None else
            profiles["validation"]["kernels"]["flash_attn_fwd"]
            / val_batches,
        "bare_step_ms": bare.host_ms, "bare_step_event_ms": bare.event_ms,
        "median_bare_step_ms": float(np.median(bare.host_ms)),
        "median_bare_step_event_ms":
            float(np.median(bare.event_ms)) if bare.event_ms else None,
        "max_memory_allocated_gib": peak, "profile": profiles,
        "card_vs_cpu": check}


# -- phase 11: the knowledge (RAG) path ---------------------------------------
# K retrieved contexts per question, embedded by the provider's hashing
# encoder (KnowledgeProviderConfig.encoder_dim, 256). KnowledgeAttention
# is one query (the fused vector) over K keys under the knowledge mask; the
# generative memory grows from 113 to 113 + K = 118 keys.
RAG_K = 5
RAG_MEMORY = 49 + 64 + RAG_K
RAG_CLI_CORPUS = 160        # 128 / 16 / 16 samples: 4 train steps of 32
RAG_CLI_BATCH = 32
# (name, B, H, Lq, Lk, D, mask kind, calls per classification forward at
# batch 8, calls per beam generate at batch 16): the forward kernel's new
# shapes. KnowledgeAttention at the serving batch and at the CLI's
# validation batch; the decoder's cross calls over the memory with the
# knowledge tokens at the greedy (16) and beam (64) rows of a generate
# at batch 16 (32 steps x 6 layers each)
RAG_FWD_CASES = [
    ("know_attn_b8", 8, 8, 1, RAG_K, 64, "knowledge", 1, 0),
    ("know_attn_b32", 32, 8, 1, RAG_K, 64, "knowledge", 0, 0),
    ("dec_cross_118_16", 16, 8, 1, RAG_MEMORY, 64, "memory_knowledge", 0, 0),
    ("dec_cross_118_64", 64, 8, 1, RAG_MEMORY, 64, "memory_knowledge", 0,
     192),
]
# (name, B, H, Lq, Lk, mask kind, calls per classification step at batch
# 128, calls per generative step at batch 32, the dropout rate of those
# calls): KnowledgeAttention in the classification step (flax MHDPA's
# dropout is 0) and the decoder's cross-attention over 118 keys
RAG_TRAIN_CASES = [
    ("know_attn_b128", TRAIN_BATCH, 8, 1, RAG_K, "knowledge", 1, 0, 0.0),
    ("gen_dec_cross_118", GEN_TRAIN_BATCH, 8, 32, RAG_MEMORY,
     "memory_knowledge", 0, 6, GEN_DROPOUT),
]


def knowledge_key_mask(B: int, Lk: int, kind: str, gen) -> torch.Tensor:
    """(B, 1, 1, Lk) key masks as the models build them from a provider's
    knowledge mask, row b keeping K - (b mod (K + 1)) of the K contexts
    (so every count from K down to none, a fully masked row): "knowledge"
    is KnowledgeAttention's (Lk = K); "memory_knowledge" the generative
    decoder's cross mask over [49 patch tokens; 64 question tokens of
    which 3-60 are real; K contexts], the concatenation of the fusion's
    mask and the knowledge mask."""
    dev = gen.device
    k = torch.tensor([RAG_K - b % (RAG_K + 1) for b in range(B)],
                     device=dev)
    know = torch.arange(RAG_K, device=dev)[None] < k[:, None]
    if kind == "memory_knowledge":
        L = Lk - 49 - RAG_K
        q_len = torch.randint(3, min(60, L) + 1, (B,), generator=gen,
                              device=dev)
        know = torch.cat([torch.ones(B, 49, dtype=torch.bool, device=dev),
                          torch.arange(L, device=dev)[None] < q_len[:, None],
                          know], dim=1)
    return make_attention_mask(None, know.int())


def rag_kernel_phase() -> dict:
    """The four kernels at the knowledge path's shapes against their plain
    versions: the forward (``attention_case``: f32, f16 and bf16, timed
    beside its plain version and SDPA) at RAG_FWD_CASES;
    the training kernels (``check_train_kernels``: f32, f16, bf16,
    at dropout 0 and at the path's rate) at RAG_TRAIN_CASES, timed in
    bf16 by ``time_train_kernels``. Rows keyed by case ((case, rate) for
    the training ones)."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    fwd, train = {}, {}
    for name, B, H, Lq, Lk, D, kind, per_fwd, per_gen in RAG_FWD_CASES:
        fwd[name] = attention_case(name, B, H, Lq, Lk, D, kind, False, gen,
                                   calls_per_forward=per_fwd,
                                   calls_per_generate=per_gen)
    for name, B, H, Lq, Lk, kind, cls_calls, gen_calls, path_rate \
            in RAG_TRAIN_CASES:
        mask = knowledge_key_mask(B, Lk, kind, gen)
        for rate in sorted({0.0, path_rate}):
            key = fa.dropout_key(2030, len(train))
            errs = {}
            for dtype in (torch.float32, torch.float16, torch.bfloat16):
                q, k, v, do = (torch.randn(B, H, L, 64, generator=gen,
                                           device="cuda").to(dtype)
                               for L in (Lq, Lk, Lk, Lq))
                errs[dtype] = check_train_kernels(q, k, v, do, mask, False,
                                                  rate, key)
            on_path = rate == path_rate
            row = {"case": name, "B": B, "H": H, "Lq": Lq, "Lk": Lk, "D": 64,
                   "mask": kind, "mask_shape": list(mask.shape),
                   "keyless_rows": int((~mask.any(-1)).sum()),
                   "dropout": rate,
                   "calls_per_cls_step": cls_calls if on_path else 0,
                   "calls_per_gen_step": gen_calls if on_path else 0,
                   "max_err_bf16": errs[torch.bfloat16],
                   "max_err_f16": errs[torch.float16],
                   "max_err_f32": errs[torch.float32],
                   **time_train_kernels(q, k, v, do, mask, False, rate, key)}
            emit({"rag_training_attention_case": row})
            train[(name, rate)] = row
    return {"forward": fwd, "training": train}


def rag_totals(rag_rows: dict, rows: dict, train_rows: dict,
               gen_rows: dict) -> dict:
    """Each kernel over one pass of a knowledge path, from the kernel
    phases' rows (each shape's number times its calls): the forward per
    classification forward at batch 8 (the 36 serving calls and
    KnowledgeAttention's) and per beam generate at batch 16 (its cross
    calls over 118 keys in place of 113); the training kernels per
    classification step at batch 128 (36 + 1) and per generative step at
    batch 32 (the decoder's cross calls over 118 keys)."""
    fwd, train = rag_rows["forward"], rag_rows["training"]
    cls_step = {**train_rows, **{k: {**r, "calls_per_step":
                                     r["calls_per_cls_step"]}
                                 for k, r in train.items()}}
    gen_step = {**{k: r for k, r in gen_rows.items()
                   if r["case"] != "gen_dec_cross"},
                **{k: {**r, "calls_per_step": r["calls_per_gen_step"]}
                   for k, r in train.items()}}
    generate = {**{k: r for k, r in rows.items() if k != "dec_cross_64"},
                **fwd}
    return {"per_forward": _path_totals({**rows, **fwd},
                                        "calls_per_forward"),
            "per_generate": _path_totals(generate, "calls_per_generate"),
            "per_step": step_totals(cls_step),
            "per_generative_step": step_totals(gen_step)}


def rag_documents() -> list:
    """The knowledge base of the model phases: one fact per content word
    of WORDS (stopwords left out, as BM25 leaves them out), so that a
    question of 3-60 of those words retrieves from none to K facts."""
    words = [w for w in dict.fromkeys(WORDS) if w not in VIETNAMESE_STOPWORDS]
    return [Document(content=f"{w} : sự kiện số {i}", source="rag",
                     category="fact") for i, w in enumerate(words)]


def rag_provider() -> KnowledgeProvider:
    """BM25 over ``rag_documents``, K facts a question."""
    return KnowledgeProvider(KnowledgeProviderConfig(
        retriever="sparse", num_retrieved=RAG_K), documents=rag_documents())


def rag_questions(n: int, seed: int) -> list:
    """``make_requests``' questions after three short ones: one of
    stopwords only (its knowledge row is fully masked), one that finds
    two facts, one four."""
    questions = make_requests(n, seed, image_hw=(8, 8))[1]
    return (["có là không vậy", "con mèo đang ngủ", "bàn ghế xe đạp"]
            + questions)[:n]


def knowledge_arrays(provider: KnowledgeProvider, questions) -> dict:
    emb, mask = provider.contexts_for(list(questions))
    return {"knowledge_embeddings": emb, "knowledge_mask": mask}


def with_knowledge(cfg, dim: int):
    return cfg.replace(knowledge=cfg.knowledge.replace(
        use_knowledge=True, knowledge_dim=dim, num_retrieved=RAG_K))


def rag_cls_batch(cfg: VQAModelConfig, provider, n: int, seed: int) -> dict:
    """``n`` requests as numpy arrays: pixels uniform in [0, 1), the
    questions tokenized (3-60 words, padded to the text length), answer
    labels, and the provider's knowledge for those questions."""
    tok = WhitespaceTokenizer(max_length=cfg.text.max_length)
    tok.build_vocab(WORDS)
    questions = rag_questions(n, seed)
    enc = tok.encode_batch(questions, cfg.text.max_length)
    rs = np.random.RandomState(seed)
    S = cfg.visual.image_size
    return {"pixel_values": rs.rand(n, S, S, 3).astype(np.float32),
            "input_ids": enc["input_ids"].astype(np.int64),
            "attention_mask": enc["attention_mask"].astype(np.int64),
            "labels": rs.randint(0, cfg.num_answers, (n,)),
            **knowledge_arrays(provider, questions)}


def rag_cls_phase(cfg: VQAModelConfig, provider, device: str = "cuda",
                  batch: int = TRAIN_BATCH, val_batch: int = CLS_BATCH,
                  steps: int = 5, warmup: int = 2, seed: int = 0) -> dict:
    """The flagship with ``use_knowledge`` (K contexts of the provider's
    dim): logits card against CPU at batch 2 (``compare_logits``); a
    validation forward at ``val_batch`` (36 + 1 forward launches); the
    train step through ``make_train_step`` at ``batch`` (36 + 1 launches
    of each training kernel a step), timed by
    ``profiling.time_train_steps`` beside the bare flagship step of the
    same model (the batch without its knowledge arrays: 36 a step), one
    after the other, ``steps`` steps each; one step
    profiled (idle share), peak memory; then two steps card against CPU
    at batch 4 (``card_vs_cpu_steps``, dropout 0). The card-vs-CPU checks
    run a copy with every stack cut to ``check_depth``'s layers."""
    on_card = device == "cuda"
    dev = torch.device(device)
    kcfg = with_knowledge(cfg, provider.dim)
    per_forward = ATTN_CALLS_PER_FORWARD + 1 if on_card else 0
    model = model_on(kcfg, dev, seed)
    n_params = sum(p.numel() for p in model.parameters())

    pair = rag_cls_batch(kcfg, provider, 2, seed + 1)
    inputs = ("pixel_values", "input_ids", "attention_mask")
    know = {k: pair[k] for k in KNOWLEDGE_KEYS}
    cpu_model = cpu_copy(check_depth(kcfg), dev, seed)
    small = copy.deepcopy(cpu_model).to(dev)
    with torch.inference_mode():
        card = small(*(host_tensor(pair[k]).to(dev) for k in inputs),
                     **{k: host_tensor(v).to(dev) for k, v in know.items()}
                     )["logits"].float().cpu().numpy()
        cpu = cpu_model(*(host_tensor(pair[k]) for k in inputs),
                        **{k: host_tensor(v) for k, v in know.items()}
                        )["logits"].float().numpy()
    cpu_check = compare_logits(card, cpu)
    cpu_check["depth"] = CUT_LAYERS
    del cpu_model, small

    val = batch_to_device(rag_cls_batch(kcfg, provider, val_batch,
                                        seed + 2), dev)
    fa.reset_launch_counts()
    with torch.inference_mode():
        logits = model(*(val[k] for k in inputs),
                       **{k: val[k] for k in KNOWLEDGE_KEYS})["logits"]
    val_launches = launch_snapshot()

    host = rag_cls_batch(kcfg, provider, batch, seed + 3)
    data = batch_to_device(host, dev)
    bare = {k: v for k, v in data.items() if k not in KNOWLEDGE_KEYS}
    state = TrainState.create(model, bench_optimizer(model), seed=seed)
    train_step = make_train_step(classification_loss_fn())
    for _ in range(warmup):
        train_step(state, data)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    # the two steps in turn (knowledge, bare), with their launches
    host_ms, event_ms, metrics = [], [], []
    bare_host, bare_event, bare_metrics = [], [], []
    for turn in range(1):
        for batch_, out in ((data, (host_ms, event_ms, metrics)),
                            (bare, (bare_host, bare_event, bare_metrics))):
            fa.reset_launch_counts()
            for acc, got in zip(out, profiling.time_train_steps(
                    train_step, state, batch_, steps)):
                acc.extend(got)
            if turn == 0 and batch_ is data:
                launches = launch_snapshot()
                peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
                    if on_card else None
            elif turn == 0:
                bare_launches = launch_snapshot()
    profile = cls_profile(lambda: train_step(state, data)) if on_card \
        else None

    problems = []
    want = {**{n: per_forward * steps for n in TRAIN_KERNELS},
            "flash_attn_fwd": 0}
    want_bare = {**{n: (per_forward - 1) * steps if on_card else 0
                    for n in TRAIN_KERNELS}, "flash_attn_fwd": 0}
    want_val = {**{n: 0 for n in TRAIN_KERNELS},
                "flash_attn_fwd": per_forward}
    for label, got, w in (("step", launches, want),
                          ("bare step", bare_launches, want_bare),
                          ("validation forward", val_launches, want_val)):
        if got != w:
            problems.append(f"{label} launches {got} != {w}")
    if profile is not None:
        step_want = {**{n: per_forward for n in TRAIN_KERNELS},
                     "flash_attn_fwd": 0, "library": []}
        if profile["kernels"] != step_want:
            problems.append(f"profiled step {profile['kernels']} != "
                            f"{step_want}")
    losses = [float(m["loss"]) for m in metrics + bare_metrics]
    if tuple(logits.shape) != (val_batch, kcfg.num_answers) \
            or not bool(torch.isfinite(logits.float()).all()) \
            or not all(math.isfinite(x) for x in losses):
        problems.append(f"logits {tuple(logits.shape)}, losses {losses}")
    if problems:
        raise AssertionError("rag classification: " + "; ".join(problems))
    del state, model, data, bare, val
    if on_card:
        torch.cuda.empty_cache()

    kcfg0 = check_depth(kcfg)
    kcfg0 = kcfg0.replace(text=kcfg0.text.replace(dropout=0.0),
                          fusion=kcfg0.fusion.replace(dropout=0.0),
                          head=kcfg0.head.replace(dropout=0.0))
    four = rag_cls_batch(kcfg0, provider, 4, seed + 4)
    weights = cpu_copy(kcfg0, dev, seed)

    def build(d):
        m = copy.deepcopy(weights).to(d)
        m.moe.dropout = 0.0
        return TrainState.create(m, bench_optimizer(m, 1), seed=seed)
    steps_check = card_vs_cpu_steps(build, classification_loss_fn(), four,
                                    device, 2,
                                    attention_calls_per_forward(kcfg0))
    steps_check["depth"] = CUT_LAYERS
    return {
        "params": n_params,
        "knowledge": {"K": RAG_K, "dim": provider.dim,
                      "contexts_per_row": host["knowledge_mask"].sum(1)
                      .tolist(),
                      "fully_masked_rows": int(
                          (host["knowledge_mask"].sum(1) == 0).sum())},
        "batch": batch, "steps": steps, "val_batch": val_batch,
        "step_ms": host_ms, "step_event_ms": event_ms,
        "median_step_ms": float(np.median(host_ms)),
        "median_step_event_ms": float(np.median(event_ms))
        if event_ms else None,
        "bare_step_ms": bare_host, "bare_step_event_ms": bare_event,
        "median_bare_step_ms": float(np.median(bare_host)),
        "median_bare_step_event_ms": float(np.median(bare_event))
        if bare_event else None,
        "loss": [float(m["loss"]) for m in metrics],
        "launches": launches, "bare_launches": bare_launches,
        "validation_launches": val_launches,
        "launches_per_step": {n: launches[n] / steps for n in TRAIN_KERNELS},
        "max_memory_allocated_gib": peak, "profile": profile, "turns": 1,
        "cpu_check": cpu_check, "train_check": steps_check}


def rag_gen_phase(provider, cfg: GenerativeVQAConfig | None = None,
                  device: str = "cuda", batch: int = GEN_VAL_BATCH,
                  train_batch: int = GEN_TRAIN_BATCH, steps: int = 3,
                  warmup: int = 1, reps: int = 1, seed: int = 0) -> dict:
    """bench_serving's model in gen_training_config's recipe (``cfg``, if
    given, in its place) with the knowledge memory: greedy and 4-beam
    generates of 32 tokens at ``batch`` with the provider's contexts (27 +
    12 x 32 = 411 forward launches each, the cross calls over 118 keys),
    timed (host clock to a synchronize, median of ``reps``); the greedy
    sequences against the card's own teacher forcing with the knowledge;
    on a copy with every stack cut to ``gen_check_depth``'s layers, greedy
    tokens card against CPU at batch 2 (equal up to the first step whose
    CPU top-1/top-2 margin is within twice ``compare_logits``' tolerance,
    and the logits teacher-forced on the CPU's tokens by
    ``compare_logits``); then
    the teacher-forced train step at ``train_batch`` (39 launches of each
    training kernel a step), timed by ``profiling.time_train_steps``."""
    on_card = device == "cuda"
    dev = torch.device(device)
    tok = gen_tokenizer()
    cfg = cfg or with_knowledge(gen_training_config(tok), provider.dim)
    model = model_on(cfg, dev, seed)
    host = gen_train_batch(cfg, tok, batch, seed)
    host.update(knowledge_arrays(provider, rag_questions(batch, seed)))
    b = batch_to_device(host, dev)
    args = (b["pixel_values"], b["question_ids"], b["question_mask"])
    know = {k: b[k] for k in KNOWLEDGE_KEYS}
    per_generate = attention_calls_per_generate(cfg, bench_serving.NEW_TOKENS)
    gens = {s: build_generate_fn(model, bench_serving.decode_config(s))
            for s in GEN_STRATEGIES}
    for s in GEN_STRATEGIES:                 # warm-up
        gens[s](*args, **know)
    outputs, launches, ms = {}, {}, {}
    for s in GEN_STRATEGIES:
        fa.reset_launch_counts()
        outputs[s] = gens[s](*args, **know)
        launches[s] = launch_snapshot()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            gens[s](*args, **know)
            if on_card:
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        ms[s] = float(np.median(times))
    with torch.inference_mode():
        enc = model.encode(*args, **know)
    decode_cfg = bench_serving.decode_config("greedy")
    consistency = cache_consistency(model, args[:2], outputs["greedy"][0],
                                    decode_cfg, question_mask=args[2],
                                    **know)

    two = {k: v[:2] for k, v in b.items() if isinstance(v, torch.Tensor)}
    two_args = (two["pixel_values"], two["question_ids"],
                two["question_mask"])
    two_know = {k: two[k] for k in KNOWLEDGE_KEYS}
    cpu_args = tuple(a.cpu() for a in two_args)
    cpu_know = {k: v.cpu() for k, v in two_know.items()}
    cpu_model = cpu_copy(gen_check_depth(cfg), dev, seed)
    small = copy.deepcopy(cpu_model).to(dev)
    card_seqs, _ = build_generate_fn(small, decode_cfg)(*two_args,
                                                        **two_know)
    cpu_seqs, _ = build_generate_fn(cpu_model, decode_cfg)(*cpu_args,
                                                           **cpu_know)
    bos = torch.full_like(cpu_seqs[:, :1], decode_cfg.bos_token_id)
    with torch.inference_mode():
        cpu_logits = cpu_model(*cpu_args[:2], torch.cat(
            [bos, cpu_seqs[:, :-1]], dim=1), cpu_args[2],
            **cpu_know)["logits"].float()
        card_logits = small(*two_args[:2], torch.cat(
            [bos, cpu_seqs[:, :-1]], dim=1).to(dev), two_args[2],
            **two_know)["logits"].float().cpu()
    V = cpu_logits.shape[-1]
    tol = 0.05 * float(cpu_logits.abs().max())
    top2 = cpu_logits.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * tol
    undecided_before = torch.cumsum((~decided).long(), dim=1) == 0
    same = card_seqs.cpu() == cpu_seqs
    greedy_check = {"decided_prefix": undecided_before.sum(1).tolist(),
                    "tokens_equal": same.sum(1).tolist(),
                    "tolerance": tol}
    if not bool(same[undecided_before].all()):
        raise AssertionError(f"rag greedy tokens card vs CPU: {greedy_check}"
                             f" {card_seqs.tolist()} {cpu_seqs.tolist()}")
    greedy_check["logits"] = compare_logits(
        card_logits.reshape(-1, V).numpy(), cpu_logits.reshape(-1, V).numpy())
    greedy_check["depth"] = CUT_LAYERS
    del cpu_model, small

    tb = gen_train_batch(cfg, tok, train_batch, seed + 1)
    tb.update(knowledge_arrays(provider, rag_questions(train_batch,
                                                       seed + 1)))
    data = batch_to_device(tb, dev)
    model.train()
    state = TrainState.create(model, gen_optimizer(model), seed=seed)
    train_step = make_train_step(generative_loss_fn(label_smoothing=0.0))
    for _ in range(warmup):
        train_step(state, data)
    fa.reset_launch_counts()
    host_ms, event_ms, metrics = profiling.time_train_steps(
        train_step, state, data, steps)
    train_launches = launch_snapshot()

    per_step = gen_calls_per_step(cfg) if on_card else 0
    want_gen = {**{n: 0 for n in TRAIN_KERNELS},
                "flash_attn_fwd": per_generate if on_card else 0}
    want_step = {**{n: per_step * steps for n in TRAIN_KERNELS},
                 "flash_attn_fwd": 0}
    problems = [f"{s} launches {launches[s]} != {want_gen}"
                for s in GEN_STRATEGIES if launches[s] != want_gen]
    if train_launches != want_step:
        problems.append(f"step launches {train_launches} != {want_step}")
    n_vis = (cfg.visual.image_size // cfg.visual.patch_size) ** 2
    if tuple(enc["memory"].shape[:2]) != (batch, n_vis + cfg.text.max_length
                                          + RAG_K):
        problems.append(f"memory {tuple(enc['memory'].shape)}")
    losses = [float(m["loss"]) for m in metrics]
    for s in GEN_STRATEGIES:
        seqs, scores = outputs[s]
        if seqs.shape != (batch, bench_serving.NEW_TOKENS) \
                or not bool(torch.isfinite(scores).all()):
            problems.append(f"{s}: {tuple(seqs.shape)}, {scores}")
    if not all(math.isfinite(x) for x in losses):
        problems.append(f"losses {losses}")
    if problems:
        raise AssertionError("rag generative: " + "; ".join(problems))
    return {"params": sum(p.numel() for p in model.parameters()),
            "batch": batch, "memory": list(enc["memory"].shape),
            "memory_keys_kept": enc["memory_mask"].sum(1).tolist(),
            "generate_ms": ms, "launches_per_generate": launches,
            "attention_calls_per_generate": per_generate,
            "cache_consistency": consistency, "cpu_greedy": greedy_check,
            "train_batch": train_batch, "steps": steps,
            "step_ms": host_ms, "step_event_ms": event_ms,
            "median_step_ms": float(np.median(host_ms)),
            "median_step_event_ms": float(np.median(event_ms))
            if event_ms else None,
            "loss": losses, "launches": train_launches,
            "launches_per_step": {n: train_launches[n] / steps
                                  for n in TRAIN_KERNELS}}


@contextlib.contextmanager
def timing_retrieval(calls: list):
    """Appends to ``calls``, for each ``KnowledgeProvider.contexts_for``
    made inside: its host ms, its questions, and how many of them the
    memo cache did not hold yet."""
    original = KnowledgeProvider.contexts_for

    def timed(self, questions):
        missing = len({q for q in questions if q not in self._cache})
        t0 = time.perf_counter()
        out = original(self, questions)
        calls.append({"ms": (time.perf_counter() - t0) * 1e3,
                      "questions": len(questions), "missing": missing})
        return out
    KnowledgeProvider.contexts_for = timed
    try:
        yield calls
    finally:
        KnowledgeProvider.contexts_for = original


def _retrieval_ms(calls: list) -> dict:
    cold = [c["ms"] for c in calls if c["missing"]]
    cached = [c["ms"] for c in calls if not c["missing"]]
    return {"calls": len(calls),
            "cold_ms_per_batch": float(np.mean(cold)) if cold else None,
            "cached_ms_per_batch": float(np.mean(cached)) if cached
            else None,
            "cold_batches": len(cold), "cached_batches": len(cached)}


def rag_cli_phase(cls_cfg: VQAModelConfig, gen_cfg: GenerativeVQAConfig,
                  device: str = "cuda", n: int = RAG_CLI_CORPUS,
                  image_size: int = 224, batch: int = RAG_CLI_BATCH,
                  seed: int = 0) -> dict:
    """Both CLIs with ``--use-knowledge`` as a user drives them, one epoch
    each on learnable corpora of ``n`` images (the cls_pipeline and
    gen_cli recipes cut to one epoch and ``n`` samples): the
    classification one through ``vqa_pipeline.main`` (the provider from
    the training QA pairs, hybrid retrieval), the generative one through
    ``generative_vqa_pipeline.main`` with a YAML config and ``--kb-path``
    (sparse retrieval over rag_documents as JSON); train, then from the
    checkpoint evaluate (beam 4 for the generative one) and inference.
    Each run's launches are set to 0 just before it and read just after,
    and held to the count its batches give: 37 of each training kernel a
    classification step and 37 forward calls a forward that has the
    knowledge (ModelPipeline's dummy forward, validation, evaluate), 36
    one that does not (inference, through VQAPredictor); 39 a generative
    step, 27 a generate and 12 a decode step. The provider's host ms a
    batch, cold and from its memo cache."""
    from vivqa_tpu_torch.data import ensure_synthetic_vivqa
    from vivqa_tpu_torch.pipelines import generative_vqa_pipeline as gvp
    from vivqa_tpu_torch.pipelines import vqa_pipeline as vp
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    runs = {}

    def measured(name, fn):
        counts = {"generates": 0, "decode_steps": 0}
        calls = []
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        with counting_decode(counts), timing_retrieval(calls):
            result = fn()
        sync()
        runs[name] = {"seconds": time.perf_counter() - t0,
                      "launches": launch_snapshot(), **counts,
                      "retrieval": _retrieval_ms(calls),
                      "retrieval_calls": calls}
        return result

    with tempfile.TemporaryDirectory() as tmp:
        kb = Path(tmp) / "kb.json"
        kb.write_text(json.dumps([{"content": d.content,
                                   "category": d.category}
                                  for d in rag_documents()],
                                 ensure_ascii=False))
        csv, imgs = generate_synthetic_vivqa(f"{tmp}/cls", n=n,
                                             image_size=image_size,
                                             learnable=True, seed=seed)
        vcfg = VQAPipelineConfig(
            data=DataPipelineConfig(
                csv_path=str(csv), image_dir=str(imgs),
                image_size=image_size,
                max_question_length=cls_cfg.text.max_length,
                batch_size=batch, augmentation_strength="medium",
                seed=seed),
            model=ModelPipelineConfig(
                model=cls_cfg.replace(knowledge=cls_cfg.knowledge.replace(
                    num_retrieved=RAG_K)), device=device, seed=seed),
            training=TrainingPipelineConfig(
                num_epochs=1, checkpoint_dir=f"{tmp}/ck_cls", log_every=4,
                seed=seed),
            output_dir=f"{tmp}/out_cls", seed=seed)
        cls_yaml = f"{tmp}/cls.yaml"
        vcfg.to_yaml(cls_yaml)
        cls_base = ["--config", cls_yaml, "--use-knowledge"]
        cls_sum = {
            mode: measured(f"cls_{mode}", lambda mode=mode: vp.main(
                cls_base + ["--mode", mode]
                + ([] if mode == "train" else
                   ["--resume", f"{tmp}/ck_cls"])))
            for mode in ("train", "evaluate", "inference")}
        data = DataPipeline(vcfg.data).run()
        cls_split = [len(data.train_loader.dataset),
                     len(data.val_loader.dataset),
                     len(data.test_loader.dataset)]

        gcsv, gimgs = ensure_synthetic_vivqa(f"{tmp}/gen", n=n,
                                             image_size=image_size,
                                             learnable=True,
                                             seq_answers=True)
        pcfg = gvp.GenerativeVQAPipelineConfig(
            data=DataPipelineConfig(
                csv_path=str(gcsv), image_dir=str(gimgs),
                image_size=image_size,
                max_question_length=gen_cfg.text.max_length,
                max_answer_length=gen_cfg.max_answer_length,
                batch_size=batch, augmentation_strength="medium",
                generative=True, seed=seed),
            model=gen_cfg.replace(dropout=GEN_DROPOUT, label_smoothing=0.0,
                                  knowledge=gen_cfg.knowledge.replace(
                                      num_retrieved=RAG_K)),
            training=GenerativeTrainingConfig(
                num_epochs=1, label_smoothing=0.0,
                checkpoint_dir=f"{tmp}/ck_gen",
                optimizer=OptimizerConfig(learning_rate=1e-3,
                                          weight_decay=0.01),
                log_every=1, seed=seed),
            knowledge=KnowledgeProviderConfig(retriever="sparse"),
            device=device, output_dir=f"{tmp}/out_gen", seed=seed)
        gen_yaml = f"{tmp}/gen.yaml"
        pcfg.to_yaml(gen_yaml)
        gen_base = ["--config", gen_yaml, "--use-knowledge", "--kb-path",
                    str(kb)]
        gen_argv = {"train": ["--mode", "train"],
                    "evaluate": ["--mode", "evaluate", "--resume",
                                 f"{tmp}/ck_gen", "--decode", "beam",
                                 "--num-beams", "4"],
                    "inference": ["--mode", "inference", "--resume",
                                  f"{tmp}/ck_gen"]}
        gen_sum = {mode: measured(f"gen_{mode}", lambda argv=argv: gvp.main(
            gen_base + argv)) for mode, argv in gen_argv.items()}
        gdata = DataPipeline(pcfg.data).run()
        gen_steps = len(gdata.train_loader)
        with open(gen_sum["inference"]["results_path"]) as f:
            gen_results = len(json.load(f))

    steps = math.ceil(cls_split[0] / batch)
    val_batches = math.ceil(cls_split[1] / batch)
    test_batches = math.ceil(cls_split[2] / batch)
    per_fwd = attention_calls_per_forward(cls_cfg) + 1 if on_card else 0
    zero = {name: 0 for name in TRAIN_KERNELS}
    enc_calls = attention_calls_per_generate(gen_cfg, 0)
    want = {
        "cls_train": {**{n: per_fwd * steps for n in TRAIN_KERNELS},
                      "flash_attn_fwd": per_fwd * (1 + 2 * val_batches)},
        "cls_evaluate": {**zero,
                         "flash_attn_fwd": per_fwd * (1 + test_batches)},
        "cls_inference": {**zero, "flash_attn_fwd": per_fwd + (
            per_fwd - 1 if on_card else 0) * cls_split[2]}}
    for mode in ("train", "evaluate", "inference"):
        r = runs[f"gen_{mode}"]
        want[f"gen_{mode}"] = {
            **zero, "flash_attn_fwd": enc_calls * r["generates"]
            + 2 * gen_cfg.decoder_layers * r["decode_steps"]
            if on_card else 0}
    want["gen_train"].update({
        n: gen_calls_per_step(gen_cfg) * gen_steps if on_card else 0
        for n in TRAIN_KERNELS})
    problems = [f"{name} launches {runs[name]['launches']} != {w}"
                for name, w in want.items() if runs[name]["launches"] != w]
    history = cls_sum["train"]["history"] + gen_sum["train"]["history"]
    if len(history) != 2 or not all(
            math.isfinite(h["train_loss"]) for h in history):
        problems.append(f"history {history}")
    if cls_sum["inference"]["num_predictions"] != cls_split[2] \
            or gen_results != len(gdata.test_loader.dataset):
        problems.append(f"predictions {cls_sum['inference']} / "
                        f"{gen_results}")
    if runs["gen_train"]["generates"] != 1 \
            or runs["gen_evaluate"]["generates"] < 1:
        problems.append(f"generates {runs}")
    if problems:
        raise AssertionError("rag CLIs: " + "; ".join(problems))
    return {
        "cls": {"split": cls_split, "batch": batch, "steps": steps,
                "history": cls_sum["train"]["history"],
                "evaluate_metrics": cls_sum["evaluate"]["metrics"],
                "knowledge_dim": cls_sum["train"]["config"]["knowledge"][
                    "encoder_dim"]},
        "gen": {"split": [len(gdata.train_loader.dataset),
                          len(gdata.val_loader.dataset),
                          len(gdata.test_loader.dataset)],
                "batch": batch, "steps": gen_steps,
                "history": gen_sum["train"]["history"],
                "evaluate_metrics": gen_sum["evaluate"]["metrics"]},
        "run_seconds": {m: r["seconds"] for m, r in runs.items()},
        "launches": {m: r["launches"] for m, r in runs.items()},
        "generates": {m: r["generates"] for m, r in runs.items()},
        "decode_steps": {m: r["decode_steps"] for m, r in runs.items()},
        "retrieval": {m: r["retrieval"] for m, r in runs.items()},
        "launches_per_step": {
            "cls": {n: runs["cls_train"]["launches"][n] / steps
                    for n in TRAIN_KERNELS},
            "gen": {n: runs["gen_train"]["launches"][n] / gen_steps
                    for n in TRAIN_KERNELS}}}


def rag_dense_phase(cfg: VQAModelConfig, provider, device: str = "cuda",
                    queries: int = 16, batch_size: int = 32,
                    seed: int = 0) -> dict:
    """Dense retrieval through the flagship's text tower at full width
    (12 layers, 64 tokens, seeded weights): ``TextKnowledgeEncoder``
    encodes the provider's documents on the card (12 forward launches a
    chunk of ``batch_size``, timed); then, on a copy of the tower cut to
    ``check_depth``'s layers, the documents and ``queries`` questions on
    the card and on the CPU: the card's embeddings within
    ``compare_logits``' tolerance (5% of the largest) of the CPU's; a
    ``DenseRetriever`` over each, whose top-5 ids on the card equal the
    CPU's at every rank whose CPU score margins to its neighbours exceed
    twice the largest score difference the two embeddings allow (the sum
    of the largest query and document row differences)."""
    from vivqa_tpu_torch.models.encoders import create_text_encoder
    from vivqa_tpu_torch.models.layers import init_weights
    dev = torch.device(device)
    tok = WhitespaceTokenizer(max_length=cfg.text.max_length)
    tok.build_vocab(WORDS + [w for d in provider.documents
                             for w in d.content.split()])
    with dev:
        tower = create_text_encoder(cfg.text)
    tower = tower.to(dev)
    init_weights(tower, torch.Generator(device=dev).manual_seed(seed))
    tower.eval()
    cpu_tower = create_text_encoder(check_depth(cfg).text)
    init_weights(cpu_tower, torch.Generator().manual_seed(seed))
    cpu_tower.eval()
    card_tower = copy.deepcopy(cpu_tower).to(dev)
    docs = provider.documents
    texts = [d.content for d in docs]
    qs = rag_questions(queries, seed + 5)
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    TextKnowledgeEncoder(tower, tok, batch_size=batch_size).encode(texts)
    if device == "cuda":
        torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = launch_snapshot()
    chunks = math.ceil(len(texts) / batch_size)
    del tower
    enc = {d: TextKnowledgeEncoder(t, tok, batch_size=batch_size)
           for d, t in (("card", card_tower), ("cpu", cpu_tower))}
    card_docs, card_q = enc["card"].encode(texts), enc["card"].encode(qs)
    cpu_docs, cpu_q = enc["cpu"].encode(texts), enc["cpu"].encode(qs)
    diff = max(float(np.abs(card_docs - cpu_docs).max()),
               float(np.abs(card_q - cpu_q).max()))
    tol = 0.05 * max(float(np.abs(cpu_docs).max()),
                     float(np.abs(cpu_q).max()))
    score_tol = float(np.linalg.norm(card_docs - cpu_docs, axis=1).max()
                      + np.linalg.norm(card_q - cpu_q, axis=1).max())
    results = {}
    for d in ("card", "cpu"):
        r = DenseRetriever(enc[d], InMemoryVectorStore(), DocumentStore())
        r.index(docs)
        results[d] = r.retrieve_batch(qs, RAG_K + 1)
    decided = agree = 0
    for card_r, cpu_r in zip(results["card"], results["cpu"]):
        s = [x.score for x in cpu_r]
        for i in range(RAG_K):
            gaps = [s[i] - s[i + 1]] + ([s[i - 1] - s[i]] if i else [])
            if min(gaps) > 2 * score_tol:
                decided += 1
                agree += card_r[i].doc_id == cpu_r[i].doc_id
    want = {**{n: 0 for n in TRAIN_KERNELS},
            "flash_attn_fwd": cfg.text.num_layers * chunks
            if device == "cuda" else 0}
    out = {"documents": len(texts), "queries": len(qs),
           "check_depth": CUT_LAYERS,
           "chunks": chunks, "launches": launches,
           "launches_per_chunk": launches["flash_attn_fwd"] / chunks,
           "encode_s": card_s, "max_abs_diff": diff, "tolerance": tol,
           "score_tolerance": score_tol, "decided_ranks": decided,
           "decided_agree": agree,
           "top5_equal": sum(
               [x.doc_id for x in a[:RAG_K]] == [x.doc_id for x in b[:RAG_K]]
               for a, b in zip(results["card"], results["cpu"]))}
    if launches != want or not math.isfinite(diff) or diff > tol \
            or agree != decided:
        raise AssertionError(f"rag dense retrieval: {out} (launches want "
                             f"{want})")
    return out


# -- phase 12: the trainer and the training extras -----------------------------
TRAINER_BATCH = 32
TRAINER_STEPS = 2           # steps an epoch of the trainer runs
TRAINER_EPOCHS = 3          # gradual_unfreeze's three stages
# one update of each optimizer (constant lr 1e-3, clipping at 1.0) over
# the flagship's parameters, card against CPU from the same gradients
TRAINER_OPTIMIZERS = {
    "adam": OptimizerConfig(name="adam", learning_rate=1e-3),
    "sgd": OptimizerConfig(name="sgd", learning_rate=1e-3),
    "radam": OptimizerConfig(name="radam", learning_rate=1e-3),
    "lamb": OptimizerConfig(name="lamb", learning_rate=1e-3),
    "adafactor": OptimizerConfig(name="adafactor", learning_rate=1e-3),
    "adamw_bf16_mu": OptimizerConfig(learning_rate=1e-3,
                                     mu_dtype="bfloat16")}
# each element of the card's update within this share of the largest
# element of the CPU's, past one f32 rounding of the updated parameter
# (the update is read back as p' - p): both compute in f32, in other
# orders
OPTIMIZER_TOL = 1e-4
F32_EPS = torch.finfo(torch.float32).eps
# the given draws of the mixed steps: MixUp on the first, CutMix (a box
# clipped at the image's bottom edge) on the second
MIX_DRAWS = ({"lam": 0.6, "cx": 150, "cy": 60, "use_mixup": True},
             {"lam": 0.7, "cx": 20, "cy": 210, "use_mixup": False})


class ListLoader:
    """Collated numpy batches with a length, re-iterable, as the trainer
    takes a BatchLoader."""

    def __init__(self, batches):
        self.batches = list(batches)

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter([dict(b) for b in self.batches])


def trainer_batch(cfg: VQAModelConfig, batch: int, seed: int) -> dict:
    """A classification batch of numpy arrays at the model's shapes:
    pixels in [0, 1), questions of 5 to L tokens (the first of L), labels."""
    S, L = cfg.visual.image_size, cfg.text.max_length
    rs = np.random.RandomState(seed)
    lengths = rs.randint(5, L + 1, batch)
    lengths[0] = L
    mask = (np.arange(L)[None] < lengths[:, None]).astype(np.int64)
    return {"pixel_values": rs.rand(batch, S, S, 3).astype(np.float32),
            "input_ids": rs.randint(4, cfg.text.vocab_size - 1,
                                    (batch, L)) * mask,
            "attention_mask": mask,
            "labels": rs.randint(0, cfg.num_answers, (batch,))}


def _weights(model, prefixes=("visual_encoder", "text_encoder")) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()
            if n.startswith(prefixes)}


class StageRecorder(VQATrainer):
    """The trainer, recording each state it builds: its epoch, step and
    optimizer count, whether every moment is zero, and the encoders'
    weights at that moment."""

    def _build_state(self, steps_per_epoch, epoch=0):
        state = super()._build_state(steps_per_epoch, epoch)
        self.stages = getattr(self, "stages", [])
        self.stages.append({
            "epoch": epoch, "step": state.step, "optimizer": state.optimizer,
            "count": state.optimizer.count,
            "zero": all(not bool(t.any()) for ts in
                        state.optimizer.state.values() for t in ts),
            "encoders": _weights(self.model)})
        return state


def trainer_unfreeze_run(cfg: VQAModelConfig, device: str, rm, tmp: str,
                         batch: int, steps: int, seed: int) -> tuple:
    """``VQATrainer`` with gradual_unfreeze over three epochs of ``steps``
    steps, layer-wise decay 0.9, lookahead (synced every 2 updates) and
    the resource manager attached, validating one batch an epoch. Holds
    the two stage changes (each a fresh state: zero moments, count and
    step 0; each stage's optimizer applied its updates), the frozen
    encoders bit-equal through their frozen epochs and moved by the end,
    36 launches of each training kernel a step and 36 forward launches a
    validation forward. Returns (its record, the final state, the
    trainer's config)."""
    on_card = device == "cuda"
    calls = attention_calls_per_forward(cfg)
    model = model_on(cfg, device, seed)
    start = _weights(model)
    train = ListLoader(trainer_batch(cfg, batch, seed + i)
                       for i in range(steps))
    val = ListLoader([trainer_batch(cfg, batch, seed + 99)])
    tcfg = TrainerConfig(
        num_epochs=TRAINER_EPOCHS, strategy="gradual_unfreeze",
        optimizer=OptimizerConfig(learning_rate=1e-4, layer_decay=0.9,
                                  lookahead=True, lookahead_sync=2),
        scheduler=SchedulerConfig(name="warmup_cosine", warmup_steps=1),
        checkpoint_dir=f"{tmp}/trainer", max_checkpoints=1, resume=False,
        log_every=1, early_stopping_patience=10, seed=seed)
    trainer = StageRecorder(tcfg, model, device=device, resource_manager=rm)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    result = trainer.train(train, val)
    if on_card:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_snapshot()
    want = {n: calls * steps * TRAINER_EPOCHS for n in TRAIN_KERNELS}
    want["flash_attn_fwd"] = calls * TRAINER_EPOCHS
    stages = trainer.stages
    final = _weights(model)
    frozen_held = {
        "text_encoder through epoch 0": all(
            torch.equal(stages[1]["encoders"][n], p) for n, p in start.items()
            if n.startswith("text_encoder")),
        "visual_encoder through epochs 0-1": all(
            torch.equal(stages[2]["encoders"][n], p) for n, p in start.items()
            if n.startswith("visual_encoder"))}
    moved = {head: any(not torch.equal(final[n], p) for n, p in start.items()
                       if n.startswith(head))
             for head in ("visual_encoder", "text_encoder")}
    out = {"batch": batch, "epochs": TRAINER_EPOCHS, "steps_per_epoch": steps,
           "seconds": seconds, "launches": launches, "want": want,
           "stage_epochs": [s["epoch"] for s in stages],
           "fresh_at_build": [s["zero"] and s["count"] == 0 and s["step"] == 0
                              for s in stages],
           "updates_per_stage": [s["optimizer"].count for s in stages],
           "frozen_held": frozen_held, "moved": moved,
           "history": result["history"],
           "progress": rm.progress.summary() if rm is not None else None,
           "max_memory_allocated_gib":
               torch.cuda.max_memory_allocated() / 2 ** 30 if on_card
               else None}
    if (out["stage_epochs"] != [0, 1, 2] or not all(out["fresh_at_build"])
            or out["updates_per_stage"] != [steps] * TRAINER_EPOCHS
            or not all(frozen_held.values()) or not all(moved.values())
            or launches != want
            or rm.progress.tasks["training"].status != "completed"):
        raise AssertionError(f"trainer gradual_unfreeze: {out}")
    # the step's time by CUDA events, on the final state (every tower
    # trains): the stopwatch of bench.py and the training phase
    data = batch_to_device(train.batches[0], torch.device(device))
    step_fn = make_train_step(trainer._loss_fn())
    times = profiling.time_train_steps(step_fn, result["state"], data, 3)
    out["step_ms"] = times.host_ms
    out["step_event_ms"] = times.event_ms
    out["median_step_event_ms"] = float(np.median(times.event_ms)) \
        if times.event_ms else None
    out["profile"] = train_profile(result["state"], step_fn, data,
                                   out["median_step_event_ms"]) \
        if on_card else None
    return out, result["state"], tcfg


def trainer_emergency(state, tcfg, tmp: str) -> dict:
    """``emergency_save`` of the trainer's full state, then
    ``restore_emergency`` and a fresh optimizer loading it: the
    parameters, every optimizer tensor, the count and the lookahead's
    slow copy come back bit for bit."""
    sd = VQATrainer.state_dict(state)
    t0 = time.perf_counter()
    path = emergency_save(sd, f"{tmp}/emergency_trainer",
                          metadata={"epoch": TRAINER_EPOCHS - 1})
    saved_s = time.perf_counter() - t0
    got, meta = restore_emergency(path)
    params_equal = all(torch.equal(got["params"][n], t)
                       for n, t in sd["params"].items())
    fresh = create_optimizer(tcfg.optimizer, state.model)
    fresh.load_state_dict(got["optimizer"])
    mine = state.optimizer
    state_equal = all(torch.equal(a.cpu(), b.cpu()) for f in mine.state
                      for a, b in zip(mine.state[f], fresh.state[f])) \
        and all(torch.equal(a.cpu(), b.cpu())
                for a, b in zip(mine.slow, fresh.slow))
    out = {"path": str(path), "save_seconds": saved_s, "metadata": meta,
           "params_equal": params_equal, "optimizer_equal": state_equal,
           "count": fresh.count, "step": got["step"],
           "bytes": (Path(path) / "state.pt").stat().st_size}
    if not (params_equal and state_equal and fresh.count == mine.count
            and got["step"] == state.step):
        raise AssertionError(f"trainer emergency save: {out}")
    return out


def trainer_checkpoint_run(cfg: VQAModelConfig, device: str, tmp: str,
                           batch: int, steps: int, seed: int) -> dict:
    """Gradient checkpointing under freeze_visual, dropout on (the
    flagship's 0.1): one step's loss and every gradient leaf against the
    plain forward's from the same weights and generator state, three
    plain steps first to measure the card's own run-to-run spread (each
    leaf held to twice its spread, bit for bit where the plain steps
    agree bit for bit); the checkpointed step's launches (both passes of
    every attention call record the graph: 72 forward-with-stats, none of
    the serving forward, 36 dQ and 36 dK/dV); then ``VQATrainer`` with
    both options for ``steps`` steps, the visual encoder bit-equal."""
    on_card = device == "cuda"
    calls = attention_calls_per_forward(cfg)
    dev = torch.device(device)
    model = model_on(cfg, device, seed + 1)
    data = batch_to_device(trainer_batch(cfg, batch, seed + 5), dev)
    base = TrainerConfig(strategy="freeze_visual", num_epochs=1,
                         checkpoint_dir=f"{tmp}/trainer_ckpt",
                         max_checkpoints=1, resume=False, log_every=1,
                         seed=seed)
    plain_fn = VQATrainer(base, model, device=device)._loss_fn()
    ckpt_cfg = base.replace(gradient_checkpointing=True)
    ckpt_fn = VQATrainer(ckpt_cfg, model, device=device)._loss_fn()

    def one_step(fn):
        model.train()
        for p in model.parameters():
            p.grad = None
        gen = torch.Generator(device=dev).manual_seed(seed + 7)
        loss, _ = fn(model, data, gen)
        loss.backward()
        return loss.detach(), {n: p.grad.detach().clone()
                               for n, p in model.named_parameters()}
    plain = [one_step(plain_fn) for _ in range(3)]
    fa.reset_launch_counts()
    c_loss, c_grads = one_step(ckpt_fn)
    if on_card:
        torch.cuda.synchronize()
    step_launches = launch_snapshot()
    loss_spread = max(float((a[0] - b[0]).abs()) for a in plain
                      for b in plain)
    spread = {n: max(float((a[1][n] - b[1][n]).abs().max()) for a in plain
                     for b in plain) for n in c_grads}
    diff = {n: float((g - plain[0][1][n]).abs().max())
            for n, g in c_grads.items()}
    loss_diff = float((c_loss - plain[0][0]).abs())
    over = [n for n in diff if diff[n] > 2 * spread[n]]
    del plain, c_grads
    want_step = {"flash_attn_fwd": 0, "flash_attn_fwd_lse": 2 * calls,
                 "flash_attn_bwd": calls}
    start = _weights(model, ("visual_encoder",))
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    VQATrainer(ckpt_cfg, model, device=device).train(
        ListLoader(trainer_batch(cfg, batch, seed + i)
                   for i in range(steps)))
    if on_card:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_snapshot()
    want = {n: steps * c for n, c in want_step.items()}
    frozen = all(torch.equal(p.detach(), start[n])
                 for n, p in model.named_parameters() if n in start)
    # the checkpointed step's time by CUDA events, and one step profiled
    trainer = VQATrainer(ckpt_cfg, model, device=device)
    state = trainer._build_state(steps)
    step_fn = make_train_step(trainer._loss_fn())
    times = profiling.time_train_steps(step_fn, state, data, 3)
    step_ms = float(np.median(times.event_ms)) if times.event_ms else None
    out = {"batch": batch, "loss": float(c_loss), "loss_diff": loss_diff,
           "loss_spread": loss_spread,
           "leaves": len(diff),
           "leaves_bit_equal": sum(d == 0.0 for d in diff.values()),
           "leaves_with_spread": sum(s > 0.0 for s in spread.values()),
           "max_leaf_diff": max(diff.values()),
           "max_leaf_spread": max(spread.values()),
           "leaves_over_twice_their_spread": over,
           "step_launches": step_launches, "step_want": want_step,
           "train_seconds": seconds, "train_steps": steps,
           "train_launches": launches, "train_want": want,
           "visual_encoder_unchanged": frozen,
           "max_memory_allocated_gib":
               torch.cuda.max_memory_allocated() / 2 ** 30 if on_card
               else None,
           "step_event_ms": times.event_ms, "median_step_event_ms": step_ms,
           "profile": train_profile(state, step_fn, data, step_ms)
           if on_card else None,
           "tolerance": "each gradient leaf and the loss within twice the "
                        "spread of three plain steps (0: bit for bit)"}
    if (over or loss_diff > 2 * loss_spread or step_launches != want_step
            or launches != want or not frozen):
        raise AssertionError(f"trainer gradient checkpointing: {out}")
    return out


def trainer_mix_check(cfg: VQAModelConfig, device: str, seed: int) -> dict:
    """Two steps of the classification training pipeline's step with
    mix_mode "both" and freeze_visual (``TrainingPipeline._build_state``'s
    optimizer, its mixed loss) on the same weights at dropout 0, card
    against CPU, on the given draws ``MIX_DRAWS`` (MixUp, then CutMix),
    held to ``train_check``'s tolerances; the visual encoder bit-equal on
    both. The model is a copy with every stack cut to ``check_depth``'s
    layers."""
    cfg0 = check_depth(cfg)
    cfg0 = cfg0.replace(text=cfg0.text.replace(dropout=0.0),
                        fusion=cfg0.fusion.replace(dropout=0.0),
                        head=cfg0.head.replace(dropout=0.0))
    S, L = cfg.visual.image_size, cfg.text.max_length
    rs = np.random.RandomState(seed + 11)
    lengths = np.array([L, 40, 17, 5]) if L >= 40 else np.array([L, L - 1,
                                                                  3, 1])
    mask = (np.arange(L)[None] < lengths[:, None]).astype(np.int64)
    data = {"pixel_values": rs.rand(4, S, S, 3).astype(np.float32),
            "input_ids": rs.randint(4, cfg.text.vocab_size - 1, (4, L)) * mask,
            "attention_mask": mask,
            "labels": rs.randint(0, cfg.num_answers, (4,))}
    pipe = TrainingPipeline(TrainingPipelineConfig(
        mix_mode="both", mix_alpha=0.4, strategy="freeze_visual",
        optimizer=OptimizerConfig(learning_rate=1e-4),
        scheduler=SchedulerConfig(name="warmup_cosine", warmup_steps=1),
        seed=seed))
    drawn = {"n": 0}
    built = {}

    def given_draw(generator, mode, alpha, height, width):
        d = MIX_DRAWS[drawn["n"] % len(MIX_DRAWS)]
        drawn["n"] += 1
        return {k: torch.tensor(v, device=generator.device)
                for k, v in d.items()}

    weights = cpu_copy(cfg0, device, seed)

    def build(dev):
        drawn["n"] = 0
        model = copy.deepcopy(weights).to(dev)
        model.moe.dropout = 0.0
        built[dev] = (model, _weights(model, ("visual_encoder",)))
        # the pipeline's schedule spans 10 epochs of 1,000 steps here
        return pipe._build_state(model, 1000)
    loss_fn = classification_loss_fn(pipe.config.moe_aux_weight,
                                     pipe.config.label_smoothing, None,
                                     "both", pipe.config.mix_alpha)
    real = batch_mix.draw_mix
    batch_mix.draw_mix = given_draw
    try:
        out = card_vs_cpu_steps(build, loss_fn, data, device, 2,
                                attention_calls_per_forward(cfg0))
    finally:
        batch_mix.draw_mix = real
    out["depth"] = CUT_LAYERS
    frozen = {dev: all(torch.equal(p.detach(), start[n])
                       for n, p in model.named_parameters() if n in start)
              for dev, (model, start) in built.items()}
    if not all(frozen.values()) or drawn["n"] != 2:
        raise AssertionError(f"mixed steps: visual encoder unchanged "
                             f"{frozen}, draws taken {drawn['n']}")
    return {"batch": 4, "draws": list(MIX_DRAWS), **out,
            "visual_encoder_unchanged": frozen}


def optimizer_check(cfg: VQAModelConfig, device: str, seed: int) -> dict:
    """One update of each optimizer of ``TRAINER_OPTIMIZERS`` over the
    parameter set of the flagship's copy with every stack cut to
    ``check_depth``'s layers (every kind of leaf, at the full width),
    from the same gradients (normal, scale 1e-2, seeded), on the card and
    on the CPU: every element of the two updates (read back as p' - p)
    within ``OPTIMIZER_TOL`` of the CPU update's largest, past one f32
    rounding of p'."""
    model0 = cpu_copy(check_depth(cfg), device, seed)
    g = torch.Generator().manual_seed(seed + 3)
    grads = {n: torch.randn(p.shape, generator=g) * 1e-2
             for n, p in model0.named_parameters()}
    start = {n: p.detach().clone() for n, p in model0.named_parameters()}
    rows = {}
    for name, ocfg in TRAINER_OPTIMIZERS.items():
        updates, seconds = {}, {}
        for dev in ("cpu", device):
            model = copy.deepcopy(model0).to(dev)
            opt = create_optimizer(ocfg, model, SchedulerConfig(
                name="constant"))
            for n, p in model.named_parameters():
                # a copy: the clip scales the gradients in place
                p.grad = grads[n].to(dev, copy=True)
            t0 = time.perf_counter()
            opt.step()
            if dev == "cuda":
                torch.cuda.synchronize()
            seconds[dev] = time.perf_counter() - t0
            updates[dev] = {n: p.detach().cpu() - start[n]
                            for n, p in model.named_parameters()}
            del model, opt
        cpu, card = updates["cpu"], updates[device]
        scale = max(float(u.abs().max()) for u in cpu.values())
        diff = max(float((card[n] - u).abs().max()) for n, u in cpu.items())
        # past one rounding of the updated parameter, |p'| f32 eps
        past = {n: (card[n] - u).abs() - F32_EPS * (start[n] + u).abs()
                for n, u in cpu.items()}
        worst = max(past, key=lambda n: float(past[n].max()))
        i = int(past[worst].argmax())
        excess = float(past[worst].view(-1)[i])
        rows[name] = {"max_abs_update": scale, "max_abs_diff": diff,
                      "max_diff_past_one_rounding": excess,
                      "worst": {"param": worst, "index": i,
                                "p": float(start[worst].view(-1)[i]),
                                "grad": float(grads[worst].view(-1)[i]),
                                "update_cpu": float(cpu[worst].view(-1)[i]),
                                "update_card": float(card[worst].view(-1)[i])},
                      "step_seconds": seconds}
        del updates, cpu, card, past
    bad = [n for n, r in rows.items()
           if not math.isfinite(r["max_abs_diff"]) or r["max_abs_update"] == 0
           or r["max_diff_past_one_rounding"]
           > OPTIMIZER_TOL * r["max_abs_update"]]
    if bad:
        raise AssertionError(f"optimizers {bad} card vs CPU: {rows}")
    return {"params": sum(t.numel() for t in start.values()),
            "depth": CUT_LAYERS,
            "tolerance_of_largest_update": OPTIMIZER_TOL, "optimizers": rows}


def trainer_gen_cli(cfg: GenerativeVQAConfig, device: str, tmp: str,
                    n: int, image_size: int, batch: int, seed: int) -> dict:
    """The generative CLI in train mode with ``--freeze-visual`` and
    ``--enable-resource-management`` (``gen_cli``'s corpus and recipe, one
    epoch): the visual encoder bit-equal through the epoch while the rest
    trains, the manager running during the mode and stopped after, 39
    launches of each training kernel a step and 27 + 12 forward launches
    a generate and decode step of the validation."""
    from vivqa_tpu_torch import resources
    from vivqa_tpu_torch.data import ensure_synthetic_vivqa
    from vivqa_tpu_torch.pipelines import generative_vqa_pipeline as gvp
    on_card = device == "cuda"
    csv, imgs = ensure_synthetic_vivqa(f"{tmp}/gen_data", n=n,
                                       image_size=image_size, learnable=True,
                                       seq_answers=True)
    pcfg = gvp.GenerativeVQAPipelineConfig(
        data=DataPipelineConfig(
            csv_path=str(csv), image_dir=str(imgs), image_size=image_size,
            max_question_length=cfg.text.max_length,
            max_answer_length=cfg.max_answer_length, batch_size=batch,
            augmentation_strength="medium", generative=True, seed=seed),
        model=cfg.replace(dropout=GEN_DROPOUT, label_smoothing=0.0),
        training=GenerativeTrainingConfig(
            num_epochs=1, label_smoothing=0.0,
            checkpoint_dir=f"{tmp}/gen_ckpt",
            optimizer=OptimizerConfig(learning_rate=1e-3, weight_decay=0.01),
            scheduler=SchedulerConfig(name="warmup_cosine",
                                      warmup_ratio=0.05),
            log_every=1, seed=seed),
        device=device, output_dir=f"{tmp}/gen_out", seed=seed)
    yaml_path = f"{tmp}/trainer_gen.yaml"
    pcfg.to_yaml(yaml_path)
    rm = resources.get_resource_manager(resources.ResourceConfig(
        backup=resources.BackupConfig(emergency_dir=f"{tmp}/gen_em"),
        report=resources.ReportIntervalConfig(report_dir=f"{tmp}/gen_rep"),
        enable_signal_handlers=False), reset=True)
    seen = {}
    real = GenerativeTrainingPipeline.run

    def run(self, model, *args):
        seen["strategy"] = self.config.strategy
        seen["manager_running"] = rm._running
        seen["steps"] = len(args[0])
        seen["before"] = {n: p.detach().clone()
                          for n, p in model.named_parameters()}
        result = real(self, model, *args)
        seen["after"] = {n: p.detach() for n, p in model.named_parameters()}
        return result
    GenerativeTrainingPipeline.run = run
    counts = {"generates": 0, "decode_steps": 0}
    try:
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        with counting_decode(counts):
            summary = gvp.main(["--config", yaml_path, "--mode", "train",
                                "--freeze-visual",
                                "--enable-resource-management"])
        if on_card:
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        GenerativeTrainingPipeline.run = real
        resources.get_resource_manager(reset=True)
    launches = launch_snapshot()
    steps = seen["steps"]
    per_step = gen_calls_per_step(cfg) if on_card else 0
    enc = attention_calls_per_generate(cfg, 0) if on_card else 0
    dec = attention_calls_per_generate(cfg, 1) - attention_calls_per_generate(
        cfg, 0) if on_card else 0
    want = {name: per_step * steps for name in TRAIN_KERNELS}
    want["flash_attn_fwd"] = enc * counts["generates"] \
        + dec * counts["decode_steps"]
    before, after = seen["before"], seen["after"]
    frozen = all(torch.equal(after[n], p) for n, p in before.items()
                 if n.startswith("visual_encoder"))
    moved = {head: any(not torch.equal(after[n], p)
                       for n, p in before.items() if n.startswith(head))
             for head in ("question_encoder", "fusion", "decoder")}
    out = {"steps": steps, "batch": batch, "seconds": seconds,
           "strategy": seen["strategy"],
           "manager_running_during_train": seen["manager_running"],
           "manager_stopped_after": not rm._running,
           "launches": launches, "want": want, **counts,
           "launches_per_step": {k: launches[k] / steps
                                 for k in TRAIN_KERNELS},
           "visual_encoder_unchanged": frozen, "moved": moved,
           "history": summary["history"]}
    if (seen["strategy"] != "freeze_visual" or not seen["manager_running"]
            or rm._running or launches != want or not frozen
            or not all(moved.values())):
        raise AssertionError(f"generative CLI --freeze-visual: {out}")
    return out


def trainer_phase(cfg: VQAModelConfig, gen_cfg: GenerativeVQAConfig,
                  device: str = "cuda", batch: int = TRAINER_BATCH,
                  steps: int = TRAINER_STEPS, gen_n: int = GEN_CLI_CORPUS,
                  gen_image_size: int = 224, gen_batch: int = GEN_CLI_BATCH,
                  seed: int = 0) -> dict:
    """The JAX package's trainer and its options on the card, at the
    flagship's width: ``trainer_unfreeze_run`` with the resource manager
    (started for it; its JSON report read back, the card's used memory
    above 0), ``trainer_emergency`` on its final state,
    ``trainer_checkpoint_run``, ``trainer_mix_check``,
    ``optimizer_check`` and ``trainer_gen_cli`` (on ``gen_cfg``). (On the
    CPU, a rehearsal at a tiny size: no launches, the card's memory 0.)"""
    from vivqa_tpu_torch import resources
    on_card = device == "cuda"
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        rm = resources.ResourceManager(resources.ResourceConfig(
            intervals=resources.MonitoringIntervals(
                cpu_seconds=0.5, memory_seconds=0.5, disk_seconds=1.0,
                device_seconds=0.5),
            backup=resources.BackupConfig(emergency_dir=f"{tmp}/em"),
            report=resources.ReportIntervalConfig(
                report_dir=f"{tmp}/reports"),
            enable_signal_handlers=False))
        rm.start()
        try:
            run, state, tcfg = trainer_unfreeze_run(cfg, device, rm, tmp,
                                                    batch, steps, seed)
            report = rm.reports.save(rm.reports.combined_report())
        finally:
            rm.stop()
        rep = json.loads(Path(report).read_text())
        card = rep["snapshot"]["device"]
        used = card.get("0", {}).get("used_gb", 0.0)
        run["resource_report"] = {
            "path": Path(report).name, "device_percent": card["percent"],
            "device_used_gb": used, "tasks": rep["tasks"],
            "memory_percent": rep["snapshot"]["memory"]["percent"]}
        if on_card and not used > 0:
            raise AssertionError(f"resource report: {run['resource_report']}")
        out["gradual_unfreeze"] = run
        out["emergency"] = trainer_emergency(state, tcfg, tmp)
        del state
        out["checkpointing"] = trainer_checkpoint_run(cfg, device, tmp,
                                                      batch, steps, seed)
        out["mix"] = trainer_mix_check(cfg, device, seed)
        out["optimizers"] = optimizer_check(cfg, device, seed)
        out["gen_cli"] = trainer_gen_cli(gen_cfg, device, tmp, gen_n,
                                         gen_image_size, gen_batch, seed)
    return out


# -- phase 13: the model zoo -------------------------------------------------
ZOO_BATCH = 32              # the zoo's train steps
ZOO_SERVE_BATCH = 8         # its serving forwards
ZOO_CLI_CORPUS = 160        # 128 / 16 / 16 samples: 4 train steps of 32
ZOO_LIB_BATCH = 8           # the image representations at 224 px
ZOO_DEBERTA_BATCH = 32      # DeBERTa-v3-base at 64 tokens
ZOO_CHECK_BATCH = 4         # the library encoders card against the CPU
ZOO_DROPOUT = 0.1           # the flagship's text and fusion dropout


def swin_b_config() -> VQAModelConfig:
    """BASELINE.json's "Swin-B + PhoBERT, cross-attention and MCAN
    fusion": Swin-B (embed 128, depths (2, 2, 18, 2), heads (4, 8, 16,
    32), window 7, 224 px) in place of the flagship's ViT; the rest (the
    PhoBERT-style text tower, MCAN 512 x 8 heads x 4 layers, the dense
    top-2 MoE, 1,000 answers) the flagship's."""
    cfg = flagship_config()
    return cfg.replace(visual=cfg.visual.replace(
        backbone="swin", swin_embed_dim=128, swin_depths=(2, 2, 18, 2),
        swin_heads=(4, 8, 16, 32), swin_window=7))


def resnet50_config() -> VQAModelConfig:
    """BASELINE.json's "ResNet-50 + BERT, bilinear fusion": ResNet-50
    (stages (3, 4, 6, 3), width 64, GroupNorm), a BERT-style text tower
    (``backbone="bert"``: post-LN, two token types) at the flagship's
    widths, bilinear fusion, no MoE."""
    cfg = flagship_config()
    return cfg.replace(
        visual=cfg.visual.replace(backbone="resnet"),
        text=cfg.text.replace(backbone="bert", norm_style="post",
                              type_vocab_size=2),
        fusion=cfg.fusion.replace(fusion_type="bilinear"),
        moe=cfg.moe.replace(use_moe=False))


def zoo_fusion_config(fusion: str, moe_type: str) -> VQAModelConfig:
    """The flagship's towers with ``fusion`` (its 512 x 8 heads x 4
    layers, 32 Q-Former queries) and the ``moe_type`` MoE layer (4
    experts, top-2, capacity factor 1.25; hierarchical: 2 groups)."""
    cfg = flagship_config()
    return cfg.replace(fusion=cfg.fusion.replace(fusion_type=fusion),
                       moe=cfg.moe.replace(moe_type=moe_type))


# (path, its config, the launches of the forward kernel a forward and of
# each training kernel a step, predicted from the config before any run)
# (name, config, launches a forward at full depth); Swin-B's path runs at
# full depth (its profiled step is the window attention's denominator),
# the others at CUT_LAYERS
ZOO_PATHS = [
    ("swin_b", swin_b_config, 24),
    ("resnet50", resnet50_config, 12),
    ("qformer_sparse", lambda: zoo_fusion_config("qformer", "sparse"), 36),
    ("single_stream_hierarchical",
     lambda: zoo_fusion_config("single_stream", "hierarchical"), 28),
    ("mutan_dense", lambda: zoo_fusion_config("mutan", "standard"), 24),
]
# the forward kernel's new shapes: (name, B, H, Lq, Lk, D, mask kind) at
# the serving batch; the Q-Former's self-attention over its 32 queries,
# its cross-attention to the ViT's 50 tokens or to Swin's or ResNet's 49
# (the CLI path), to the 64 question tokens under their key mask,
# single-stream's 1 + 50 + 64 tokens under the query-AND-key mask, and
# VisionTokenEmbedding's 32 queries over its 28 x 28 map, 4 heads
ZOO_FWD_CASES = [
    ("qf_self", 8, 8, 32, 32, 64, None),
    ("qf_cross_vit", 8, 8, 32, 50, 64, None),
    ("qf_cross_49", 8, 8, 32, 49, 64, None),
    ("qf_cross_text", 8, 8, 32, 64, 64, "key"),
    ("stream_115", 8, 8, 115, 115, 64, "query_key"),
    ("vision_tokens", ZOO_LIB_BATCH, 4, 32, 784, 64, None),
]
# the training kernels' shapes at the zoo's step batch: the flagship's
# towers and MCAN at batch 32 (the zoo's steps and the trainer phase's),
# then the new ones; (name, B, H, Lq, Lk, mask kind, dropout of those
# calls); each is checked at dropout 0 and at its path's rate, timed at
# the path's rate
ZOO_TRAIN_CASES = [
    ("vit_self_b32", ZOO_BATCH, 12, 50, 50, None, 0.0),
    ("text_self_b32", ZOO_BATCH, 12, 64, 64, "query_key", ZOO_DROPOUT),
    ("mcan_enc_self_b32", ZOO_BATCH, 8, 64, 64, "query_key", ZOO_DROPOUT),
    ("mcan_dec_self_b32", ZOO_BATCH, 8, 49, 49, None, ZOO_DROPOUT),
    ("mcan_cross_b32", ZOO_BATCH, 8, 49, 64, "key", ZOO_DROPOUT),
    ("qf_self_b32", ZOO_BATCH, 8, 32, 32, None, ZOO_DROPOUT),
    ("qf_cross_vit_b32", ZOO_BATCH, 8, 32, 50, None, ZOO_DROPOUT),
    ("qf_cross_49_b32", ZOO_BATCH, 8, 32, 49, None, ZOO_DROPOUT),
    ("qf_cross_text_b32", ZOO_BATCH, 8, 32, 64, "key", ZOO_DROPOUT),
    ("stream_115_b32", ZOO_BATCH, 8, 115, 115, "query_key", ZOO_DROPOUT),
    ("vision_tokens_b8", ZOO_LIB_BATCH, 4, 32, 784, None, 0.0),
]
_TOWERS_FWD = {"text_self": 12}
_VIT_FWD = {"vit_self": 12}
_MCAN_FWD = {"mcan_enc_self": 4, "mcan_dec_self": 4, "mcan_cross": 4}
_QF_FWD = {"qf_self": 4, "qf_cross_vit": 4, "qf_cross_text": 4}
# each path's forward calls at batch 8 by kernel-phase row (the serving
# rows of ATTN_CASES and ZOO_FWD_CASES) and its step's calls at batch 32
# by ZOO_TRAIN_CASES row; the trainer phase's step is the flagship's
ZOO_FORWARD_CALLS = {
    "swin_b": {**_TOWERS_FWD, **_MCAN_FWD},
    "resnet50": dict(_TOWERS_FWD),
    "qformer_sparse": {**_VIT_FWD, **_TOWERS_FWD, **_QF_FWD},
    "single_stream_hierarchical": {**_VIT_FWD, **_TOWERS_FWD,
                                   "stream_115": 4},
    "mutan_dense": {**_VIT_FWD, **_TOWERS_FWD},
    "vision_token_embedding": {"vision_tokens": 2},
}
ZOO_STEP_CALLS = {
    path: {f"{name}_b32": n for name, n in calls.items()}
    for path, calls in ZOO_FORWARD_CALLS.items()
    if path != "vision_token_embedding"}
ZOO_STEP_CALLS["vision_token_embedding"] = {"vision_tokens_b8": 2}
ZOO_STEP_CALLS["trainer"] = {f"{n}_b32": c for n, c in
                             {**_VIT_FWD, **_TOWERS_FWD, **_MCAN_FWD}.items()}


def zoo_kernel_phase(rows: dict) -> dict:
    """The four kernels at the zoo's new shapes against their plain
    versions: the forward (``attention_case``: f32, f16 and bf16, timed
    beside its plain version and SDPA) at ZOO_FWD_CASES;
    the training kernels (``check_train_kernels``: f32, f16 and
    bf16 at dropout 0 and at the path's rate; ``time_train_kernels`` at
    the path's rate in bf16) at ZOO_TRAIN_CASES, where each case of the
    flagship's towers also times the forward kernel at batch 32 (the
    trainer's validation forward) beside SDPA's forward, with its bound.
    Then each path's totals: the forward per serving forward at batch 8
    (with ``rows``, the serving phase's), the training kernels per step.
    Rows keyed by case."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    fwd, train = {}, {}
    for name, B, H, Lq, Lk, D, kind in ZOO_FWD_CASES:
        fwd[name] = attention_case(name, B, H, Lq, Lk, D, kind, False, gen)
    for name, B, H, Lq, Lk, kind, path_rate in ZOO_TRAIN_CASES:
        q, k, v, mask = attention_inputs(B, H, Lq, Lk, 64, kind,
                                         torch.bfloat16, gen)
        errs = {}
        for rate in sorted({0.0, path_rate}):
            key = fa.dropout_key(2032, len(errs))
            for dtype in (torch.float32, torch.float16, torch.bfloat16):
                qd, kd, vd, do = (t.to(dtype) for t in (
                    q, k, v, torch.randn(B, H, Lq, 64, generator=gen,
                                         device="cuda")))
                errs[(rate, dtype)] = check_train_kernels(
                    qd, kd, vd, do, mask, False, rate, key)
        do = torch.randn(B, H, Lq, 64, generator=gen,
                         device="cuda").to(torch.bfloat16)
        row = {"case": name, "B": B, "H": H, "Lq": Lq, "Lk": Lk, "D": 64,
               "mask": kind, "dropout": path_rate,
               "checked_dropout": sorted({0.0, path_rate}),
               "max_err_bf16": {
                   e: max(errs[(r, torch.bfloat16)][e] for r in
                          (0.0, path_rate)) for e in ("o", "m", "l", "dq",
                                                      "dk", "dv")},
               "max_err_f32": {
                   e: max(errs[(r, torch.float32)][e] for r in
                          (0.0, path_rate)) for e in ("o", "m", "l", "dq",
                                                      "dk", "dv")},
               **time_train_kernels(q, k, v, do, mask, False, path_rate,
                                    fa.dropout_key(2033, len(train)))}
        if name in ZOO_STEP_CALLS["trainer"]:
            nbytes, flops, _ = attention_work(q, k, mask, False)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_flops = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
            with recording_launches(CHECKED):
                out = fa.flash_attention_cuda(q, k, v, mask)
            err = float((out.float() - fa.attention_reference(
                q, k, v, mask).float()).abs().max())
            if not math.isfinite(err) or err > ATTN_TOL[torch.bfloat16]:
                raise AssertionError(f"{name} forward: kernel vs plain "
                                     f"{err}")
            row["flash_attn_fwd"] = {
                "kernel_ms": device_ms(
                    lambda: fa.flash_attention_cuda(q, k, v, mask)),
                "plain_ms": device_ms(
                    lambda: fa.attention_reference(q, k, v, mask)),
                "library_ms": device_ms(
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask)),
                "max_abs_err_bf16": err, "bytes": nbytes, "flops": flops,
                "bound_ms": max(t_bytes, t_flops),
                "bound_by": "bytes" if t_bytes >= t_flops
                else "operations"}
        emit({"zoo_training_attention_case": row})
        train[name] = row
    per_forward = {
        path: _path_totals({n: {**({**rows, **fwd}[n]),
                                "calls_per_forward": c}
                            for n, c in calls.items()}, "calls_per_forward")
        for path, calls in ZOO_FORWARD_CALLS.items()}
    per_step = {path: step_totals({n: {**train[n], "calls_per_step": c}
                                   for n, c in calls.items()})
                for path, calls in ZOO_STEP_CALLS.items()}
    trainer_fwd = [train[n]["flash_attn_fwd"] for n in
                   ZOO_STEP_CALLS["trainer"]]
    calls = list(ZOO_STEP_CALLS["trainer"].values())

    def total(key):
        return sum(r[key] * c for r, c in zip(trainer_fwd, calls))
    t_bytes = total("bytes") / HBM_BYTES_PER_S * 1e3
    t_flops = total("flops") / PEAK_FLOPS[torch.bfloat16] * 1e3
    trainer_forward = {
        "ms": total("kernel_ms"), "plain_ms": total("plain_ms"),
        "library_ms": total("library_ms"),
        "bound_ms": max(t_bytes, t_flops),
        "bound_by": "bytes" if t_bytes >= t_flops else "operations",
        "max_abs_err": max(r["max_abs_err_bf16"] for r in trainer_fwd),
        "per": f"one flagship validation forward at batch {ZOO_BATCH} "
               f"({sum(calls)} calls), bf16"}
    return {"forward": fwd, "training": train,
            "per_forward": per_forward, "per_step": per_step,
            "trainer_forward": trainer_forward}


def window_attention_profile(cfg: VQAModelConfig, batch: int = ZOO_BATCH,
                             seed: int = 0) -> dict:
    """Swin's window attention (``swin.window_attention``: f32 scores plus
    the learned bias, the shift mask, an f32 softmax, the product with v;
    the projections left out) at each block's shape at ``batch``, in
    bf16, forward and forward + backward by the profiler's summed kernel
    durations, beside SDPA on the same q, k and v with the bias and mask
    as one additive bf16 mask (the library's form of the same function),
    and the bound (q, k, v read, o written, the f32 bias and the mask
    read once; 4 hd flops per pair forward, 8 more backward); summed over
    the encoder's blocks, a forward's and a step's."""
    with torch.device("cuda"):      # buffers made from numpy stay on
        enc = SwinEncoder(cfg.visual.replace(dtype="bfloat16"))
    enc = enc.to("cuda")            # the CPU: .to moves them
    init_weights(enc, torch.Generator(device="cuda").manual_seed(seed))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shapes = {}
    for names, _ in enc.stages:
        for name in names:
            blk = getattr(enc, name)
            H, ws = blk.input_hw[0], blk.window_size
            key = (H, ws, blk.attn.num_heads, blk.attn.qkv.in_features,
                   blk.shift > 0)
            shapes.setdefault(key, {"blocks": 0, "block": blk})
            shapes[key]["blocks"] += 1
    rows, totals = [], {"fwd_ms": 0.0, "fwd_bwd_ms": 0.0,
                        "library_fwd_ms": 0.0, "library_fwd_bwd_ms": 0.0,
                        "bound_fwd_ms": 0.0, "bound_fwd_bwd_ms": 0.0}
    for (H, ws, h, C, shifted), s in shapes.items():
        blk = s["block"]
        nW, L, hd = (H // ws) ** 2, ws * ws, C // h
        nB = batch * nW
        q, k, v = (torch.randn(nB, h, L, hd, generator=gen, device="cuda")
                   .to(torch.bfloat16).requires_grad_(True)
                   for _ in range(3))
        do = torch.randn(nB, h, L, hd, generator=gen,
                         device="cuda").to(torch.bfloat16)
        with torch.no_grad():
            bias = blk.attn.bias().detach()
        mask = blk.shift_mask
        add = bias[None] if mask is None else torch.where(
            mask[None, :, None], bias[None, None], -1e9).expand(
                nB // nW, -1, -1, -1, -1).reshape(nB, h, L, L)
        add = add.to(torch.bfloat16)

        def port():
            return window_attention(q, k, v, bias, mask)

        def library():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=add)
        row = {"H": H, "window": ws, "heads": h, "dim": C, "hd": hd,
               "shifted": shifted, "windows": nB, "blocks": s["blocks"],
               "max_abs_err_vs_library": float(
                   (port().float() - library().float()).abs().max()
                   .detach())}
        for label, fn in (("", port), ("library_", library)):
            row[f"{label}fwd_ms"] = profiled_ms(
                lambda fn=fn: fn().detach())
            row[f"{label}fwd_bwd_ms"] = profiled_ms(
                lambda fn=fn: torch.autograd.grad(fn(), (q, k, v), do))
        elem = q.element_size()
        pairs = nB * h * L * L
        fwd_bytes = 4 * nB * h * L * hd * elem + bias.numel() * 4 + (
            0 if mask is None else mask.numel())
        bwd_bytes = fwd_bytes + 4 * nB * h * L * hd * elem
        for label, nbytes, flops in (("fwd", fwd_bytes, 4 * hd * pairs),
                                     ("fwd_bwd", fwd_bytes + bwd_bytes,
                                      12 * hd * pairs)):
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_flops = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
            row[f"bound_{label}_ms"] = max(t_bytes, t_flops)
            row[f"bound_{label}_by"] = "bytes" if t_bytes >= t_flops \
                else "operations"
        for key in totals:
            totals[key] += row[key] * s["blocks"]
        rows.append(row)
    return {"batch": batch, "shapes": rows,
            "per_forward": {k: v for k, v in totals.items()
                            if "bwd" not in k},
            "per_step": {k: v for k, v in totals.items() if "bwd" in k},
            "blocks": sum(r["blocks"] for r in rows)}




def check_depth(cfg: VQAModelConfig,
                layers: int = CUT_LAYERS) -> VQAModelConfig:
    """``cfg`` at its widths with every layer stack cut to ``layers``
    (Swin's stages each to ``layers`` blocks; ResNet's stages as they
    are): the config of a card-vs-CPU check, whose CPU half is most of
    the phase at full depth, or of a plumbing phase."""
    v = cfg.visual
    if v.backbone in ("vit", "clip", "dino"):
        v = v.replace(num_layers=min(v.num_layers, layers))
    elif v.backbone == "swin":
        v = v.replace(swin_depths=tuple(min(d, layers)
                                        for d in v.swin_depths))
    return cfg.replace(
        visual=v, text=cfg.text.replace(num_layers=min(cfg.text.num_layers,
                                                       layers)),
        fusion=cfg.fusion.replace(num_layers=min(cfg.fusion.num_layers,
                                                 layers)))


def zoo_model_path(name: str, cfg: VQAModelConfig, calls: int,
                   device: str = "cuda", serve_batches: int = 2,
                   steps: int = 2, batch: int = ZOO_BATCH,
                   serve_batch: int = ZOO_SERVE_BATCH,
                   profile: bool = False, seed: int = 0) -> dict:
    """One zoo model through the user's entry points: ``serving_phase``
    (VQAPredictor at ``serve_batch``, ``calls`` forward launches a
    forward, the card's logits against the CPU's, and the sparse layer's
    dropped fraction equal on both), ``training_phase`` (``steps`` steps
    at ``batch`` after one warm-up, ``calls`` launches of each training
    kernel a step; with ``profile`` one step profiled), each model built
    from ``seed``, and ``train_check`` (two steps card against CPU at its
    batch of 4, its bounds: the first step's warmup moves no weight) on
    ``check_depth(cfg)``."""
    on_card = device == "cuda"
    predicted = attention_calls_per_forward(cfg)
    if predicted != calls:
        raise AssertionError(f"{name}: the config gives {predicted} "
                             f"attention calls a forward, not {calls}")
    t0 = time.perf_counter()
    seconds = {}
    serving = serving_phase(cfg, device, batches=serve_batches,
                            batch=serve_batch, seed=seed,
                            calls_per_forward=calls, profile=False)
    seconds["serving"] = time.perf_counter() - t0 - sum(seconds.values())
    training = training_phase(cfg, device, steps=steps, warmup=1,
                              batch=batch, seed=seed,
                              calls_per_step=calls,
                              profile=profile and on_card)
    seconds["training"] = time.perf_counter() - t0 - sum(seconds.values())
    check_cfg = check_depth(cfg)
    check = train_check(check_cfg, device, seed=seed,
                        calls_per_step=attention_calls_per_forward(check_cfg))
    check["depth"] = CUT_LAYERS
    seconds["train_check"] = time.perf_counter() - t0 - sum(seconds.values())
    out = {"config": name, "attention_calls_per_forward": calls,
           "params": serving["params"],
           "serving": {k: serving[k] for k in (
               "batch", "batches", "mean_batch_latency_ms",
               "answers_per_s", "launches", "launches_per_forward",
               "cpu_check", "cpu_forward_s", "first_answers")},
           "training": {k: training[k] for k in (
               "batch", "steps", "median_step_ms", "step_event_ms",
               "qa_pairs_per_s", "loss", "grad_norm",
               "max_memory_allocated_gib", "launches",
               "launches_per_step", "profile")},
           "train_check": check, "seconds_by_part": seconds,
           "seconds": time.perf_counter() - t0}
    print(f"[zoo] {name}: {serving['params'] / 1e6:.1f}M parameters, "
          f"{serving['mean_batch_latency_ms']:.1f} ms a serving batch of "
          f"{serve_batch} ({serving['launches_per_forward']:.0f} launches "
          f"a forward), step {training['median_step_ms']:.1f} ms at batch "
          f"{batch}, logits card/CPU max diff "
          f"{serving['cpu_check']['max_abs_logit_diff']:.3g} (tolerance "
          f"{serving['cpu_check']['tolerance']:.3g}), train check loss "
          f"{check['loss_card']} / {check['loss_cpu']} "
          f"({out['seconds']:.1f} s: " + ", ".join(
              f"{k} {v:.1f}" for k, v in seconds.items()) + ")", flush=True)
    return out


def zoo_cli_phase(cfg: VQAModelConfig, device: str = "cuda",
                  n: int = ZOO_CLI_CORPUS, image_size: int = 224,
                  batch: int = ZOO_BATCH, seed: int = 0) -> dict:
    """The classification CLI (``vqa_pipeline.main``) with
    ``--visual-backbone swin --fusion qformer`` over a YAML config that
    holds ``cfg`` (the Swin-B widths, the flagship's text tower, MCAN and
    MoE), on a learnable corpus of ``n`` images: train (one epoch, a
    validation, the final evaluation on the best checkpoint) and evaluate
    from the checkpoint, each with its launches (per forward the text
    encoder's and the Q-Former's calls; none from Swin)."""
    from vivqa_tpu_torch.pipelines import vqa_pipeline
    on_card = device == "cuda"
    built = cfg.replace(visual=cfg.visual.replace(backbone="swin"),
                        fusion=cfg.fusion.replace(fusion_type="qformer"))
    per_forward = attention_calls_per_forward(built) if on_card else 0
    with tempfile.TemporaryDirectory() as tmp:
        csv, imgs = generate_synthetic_vivqa(f"{tmp}/data", n=n,
                                             image_size=image_size,
                                             learnable=True, seed=seed)
        ckpt_dir, out_dir = f"{tmp}/ckpt", f"{tmp}/out"
        vcfg = VQAPipelineConfig(
            data=DataPipelineConfig(
                csv_path=str(csv), image_dir=str(imgs),
                image_size=image_size,
                max_question_length=cfg.text.max_length, batch_size=batch,
                augmentation_strength="medium", seed=seed),
            model=ModelPipelineConfig(model=cfg, device=device, seed=seed),
            training=TrainingPipelineConfig(num_epochs=1,
                                            checkpoint_dir=ckpt_dir,
                                            log_every=4, seed=seed),
            output_dir=out_dir, seed=seed)
        path = f"{tmp}/zoo.yaml"
        vcfg.to_yaml(path)
        flags = ["--config", path, "--visual-backbone", "swin", "--fusion",
                 "qformer", "--device", device]
        runs = {}
        for mode, extra in (("train", []), ("evaluate",
                                            ["--resume", ckpt_dir])):
            fa.reset_launch_counts()
            t0 = time.perf_counter()
            summary = vqa_pipeline.main(flags + ["--mode", mode] + extra)
            runs[mode] = {"seconds": time.perf_counter() - t0,
                          "launches": launch_snapshot(),
                          "summary": summary}
        data = DataPipeline(vcfg.data).run()
        steps = len(data.train_loader)
        val_batches = math.ceil(len(data.val_loader.dataset) / batch)
        test_batches = math.ceil(len(data.test_loader.dataset) / batch)
    train, evaluate = runs["train"]["summary"], runs["evaluate"]["summary"]
    zero = {name: 0 for name in TRAIN_KERNELS}
    want = {"train": {**{name: per_forward * steps
                         for name in TRAIN_KERNELS},
                      "flash_attn_fwd": per_forward * (1 + 2 * val_batches)},
            "evaluate": {**zero,
                         "flash_attn_fwd": per_forward * (1 + test_batches)}}
    history = train["history"]
    finite = [h["train_loss"] for h in history] + \
        [h["val_loss"] for h in history] + list(evaluate["metrics"].values())
    problems = [f"{m} launches {runs[m]['launches']} != {w}"
                for m, w in want.items() if runs[m]["launches"] != w]
    if len(history) != 1 or not all(math.isfinite(x) for x in finite):
        problems.append(f"history {history}, metrics {evaluate['metrics']}")
    if problems:
        raise AssertionError(f"zoo CLI: {problems}")
    return {"flags": flags[2:6], "corpus": n, "batch": batch,
            "steps": steps, "attention_calls_per_forward": per_forward,
            "run_seconds": {m: r["seconds"] for m, r in runs.items()},
            "launches": {m: r["launches"] for m, r in runs.items()},
            "history": history, "evaluate_metrics": evaluate["metrics"]}


def zoo_gen_phase(cfg: GenerativeVQAConfig, tok: WhitespaceTokenizer,
                  device: str = "cuda", batch: int = 16,
                  new_tokens: int = 32, seed: int = 0) -> dict:
    """bench_serving's generative model with the sparse MoE in its fusion
    (as ``--use-moe --moe-type sparse`` sets it): two train steps card
    against CPU (``gen_train_check``: 39 launches of each training kernel
    a step) and one greedy generate at ``batch`` (27 forward launches
    and 12 a decode step), its sequences and scores finite and the cache
    against teacher forcing."""
    on_card = device == "cuda"
    check = gen_train_check(cfg, tok, device, seed=seed)
    model = model_on(cfg, device, seed)
    px, q = (torch.from_numpy(a).to(device) for a in
             bench_serving.synthetic_requests(cfg, batch))
    decode_cfg = bench_serving.decode_config("greedy", new_tokens)
    generate = build_generate_fn(model, decode_cfg)
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    seqs, scores = generate(px, q)
    if on_card:
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = launch_snapshot()
    per_generate = attention_calls_per_generate(cfg, new_tokens)
    want = {name: 0 for name in launches}
    want["flash_attn_fwd"] = per_generate if on_card else 0
    if launches != want or seqs.shape != (batch, new_tokens) \
            or not bool(torch.isfinite(scores).all()):
        raise AssertionError(f"zoo generate: launches {launches} != {want},"
                             f" sequences {tuple(seqs.shape)}")
    consistency = cache_consistency(model, (px, q), seqs, decode_cfg)
    return {"moe": cfg.moe.to_dict(), "train_check": check,
            "generate_batch": batch, "generate_ms": ms,
            "launches_per_generate": launches["flash_attn_fwd"],
            "cache_vs_teacher_forcing": consistency}


def fwd_bwd_card_vs_cpu(build, inputs: tuple, device: str = "cuda",
                        keys=("pooled", "tokens"), seed: int = 0) -> dict:
    """``build(device)`` gives a module with seeded weights; its forward
    on ``inputs`` (CPU tensors) and the backward of sum <out, c> (seeded
    normal cotangents) on the CPU and on the card: each output to
    ``compare_logits``' rule (5% of its largest value), the gradient's
    norm to 5% and the cosine of the two gradients >= 0.9
    (``train_check``'s bounds), and the launches of the card's run."""
    runs = {}
    for label, dev in (("cpu", "cpu"), ("card", device)):
        module = build(dev)
        args = [a.to(dev) for a in inputs]
        fa.reset_launch_counts()
        out = module(*args)
        outs = [out[k] for k in keys]
        gen = torch.Generator().manual_seed(seed)
        cots = [torch.randn(o.shape, generator=gen).to(dev) for o in outs]
        loss = sum((o.float() * c).sum() for o, c in zip(outs, cots))
        grads = torch.autograd.grad(loss, list(module.parameters()),
                                    allow_unused=True)
        if dev == "cuda":
            torch.cuda.synchronize()
        runs[label] = {"outs": [o.detach().float().cpu() for o in outs],
                     "grads": [torch.zeros(p.shape) if g is None
                               else g.float().cpu() for p, g in
                               zip(module.parameters(), grads)],
                     "launches": launch_snapshot()}
    cpu, card = runs["cpu"], runs["card"]
    result = {"outputs": {}, "launches": card["launches"]}
    for k, a, b in zip(keys, card["outs"], cpu["outs"]):
        diff = float((a - b).abs().max())
        tol = 0.05 * float(b.abs().max())
        result["outputs"][k] = {"max_abs_diff": diff, "tolerance": tol}
        if not math.isfinite(diff) or diff > tol:
            raise AssertionError(f"card vs CPU {k}: {diff} > {tol}")
    n_card = math.sqrt(sum(float(g.square().sum()) for g in card["grads"]))
    n_cpu = math.sqrt(sum(float(g.square().sum()) for g in cpu["grads"]))
    dot = sum(float((a * b).sum()) for a, b in zip(card["grads"],
                                                     cpu["grads"]))
    result.update(grad_norm_card=n_card, grad_norm_cpu=n_cpu,
                  grad_cosine=dot / max(n_card * n_cpu, 1e-30))
    if abs(n_card - n_cpu) > 0.05 * n_cpu or result["grad_cosine"] < 0.9:
        raise AssertionError(f"card vs CPU gradients: {result}")
    return result


def zoo_library_phase(device: str = "cuda",
                      deberta: DeBERTaConfig | None = None,
                      visual: VisualEncoderConfig | None = None,
                      image_size: int = 224, lib_batch: int = ZOO_LIB_BATCH,
                      deberta_batch: int = ZOO_DEBERTA_BATCH,
                      check_batch: int = ZOO_CHECK_BATCH,
                      seed: int = 0) -> dict:
    """The library encoders, each built by the representation factories
    with seeded weights in bf16: DeBERTa-v3-base (768 wide, 12 layers, 12
    heads, vocab 128,100, 64 tokens with padding) and the three image
    representations at ``image_size``: forward and backward card against
    CPU (``fwd_bwd_card_vs_cpu``; DeBERTa at ``check_batch``, the images
    at ``lib_batch``), then on the card at DeBERTa's ``deberta_batch`` and
    the images' ``lib_batch`` the forward's ms (events, no grad) and its
    forward-kernel launches, and a forward and backward's ms and training
    kernel launches (VisionTokenEmbedding: 2 of each; the others none)."""
    on_card = device == "cuda"
    deberta = deberta or DeBERTaConfig()
    visual = visual or VisualEncoderConfig(image_size=image_size)
    modules = {
        "deberta_v3_base": lambda dev: DeBERTaEncoder(deberta),
        **{kind: (lambda dev, kind=kind:
                  representation.create_image_representation(kind,
                                                             visual))
           for kind in ("region_based", "multi_resolution", "vision_token")}}
    want_calls = {"deberta_v3_base": 0, "region_based": 0,
                  "multi_resolution": 0, "vision_token": 2}

    bases = {}

    def built(name):
        """One seeded CPU module per name, copied to each device."""
        if name not in bases:
            bases[name] = modules[name]("cpu")
            init_weights(bases[name], torch.Generator().manual_seed(seed))

        def build(dev):
            return copy.deepcopy(bases[name]).to(dev).eval()
        return build

    def inputs(name, B):
        rs = np.random.RandomState(seed + B)
        if name.startswith("deberta"):
            L = deberta.max_length
            lengths = rs.randint(3, L + 1, B)
            lengths[0] = L
            mask = (np.arange(L)[None] < lengths[:, None]).astype(np.int64)
            ids = rs.randint(4, deberta.vocab_size, (B, L)) * mask
            return (torch.from_numpy(ids), torch.from_numpy(mask))
        return (torch.from_numpy(rs.rand(B, image_size, image_size,
                                         3).astype(np.float32)),)
    out = {}
    for name in modules:
        t0 = time.perf_counter()
        is_deberta = name.startswith("deberta")
        row = {"card_vs_cpu": fwd_bwd_card_vs_cpu(
            built(name), inputs(name, check_batch if is_deberta
                                else lib_batch), device, seed=seed),
            "check_batch": check_batch if is_deberta else lib_batch}
        B = deberta_batch if is_deberta else lib_batch
        module = built(name)(device)
        args = [a.to(device) for a in inputs(name, B)]
        sync = torch.cuda.synchronize if on_card else (lambda: None)
        with torch.no_grad():
            module(*args)
            sync()
            fa.reset_launch_counts()
            t = time.perf_counter()
            res = module(*args)
            sync()
            row["forward_ms"] = (time.perf_counter() - t) * 1e3
            row["forward_launches"] = launch_snapshot()
        fa.reset_launch_counts()
        t = time.perf_counter()
        res = module(*args)
        (res["tokens"].float().sum() + res["pooled"].float().sum()).backward()
        sync()
        row["fwd_bwd_ms"] = (time.perf_counter() - t) * 1e3
        row["fwd_bwd_launches"] = launch_snapshot()
        calls = want_calls[name] if on_card else 0
        want_fwd = {n: 0 for n in row["forward_launches"]}
        want_fwd["flash_attn_fwd"] = calls
        want_bwd = {n: calls for n in TRAIN_KERNELS}
        want_bwd["flash_attn_fwd"] = 0
        if name == "vision_token" and on_card:
            # its 32 x 784 calls take the backward's long form (the dQ sum
            # launches once a call) and the forwards' long form, whose key
            # splits at this batch are merged by a second launch
            want_bwd["flash_attn_bwd_sum"] = calls
            merges = calls * (fa.forward_plan(B, 4, 32, 784, 64)[
                "launches"] - 1)
            if merges:
                want_fwd["flash_attn_fwd_merge"] = merges
                want_bwd["flash_attn_fwd_merge"] = merges
        if row["forward_launches"] != want_fwd \
                or row["fwd_bwd_launches"] != want_bwd \
                or not bool(torch.isfinite(res["tokens"]).all()):
            raise AssertionError(f"{name}: launches {row}")
        row.update(batch=B, params=sum(p.numel()
                                        for p in module.parameters()),
                   tokens_shape=list(res["tokens"].shape),
                   seconds=time.perf_counter() - t0)
        out[name] = row
        print(f"[zoo] {name}: {row['params'] / 1e6:.1f}M parameters, "
              f"forward {row['forward_ms']:.2f} ms, forward and backward "
              f"{row['fwd_bwd_ms']:.2f} ms at batch {B}; card vs CPU "
              f"grad cosine {row['card_vs_cpu']['grad_cosine']:.4f}",
              flush=True)
    return out


def zoo_phase(device: str = "cuda") -> dict:
    """The model zoo's paths at full width, bf16, seeded weights (phase
    13), each path's launch counts set to 0 just before it and read just
    after: ``ZOO_PATHS`` (``zoo_model_path``; Swin-B's step profiled and
    its window attention's share of the step by the profiler), the
    classification CLI with ``--visual-backbone swin --fusion qformer``,
    bench_serving's generative model with the sparse MoE, and the library
    encoders. (``zoo_kernel_phase`` holds the kernels at its shapes.)"""
    t0 = time.perf_counter()
    paths = {}
    for name, config, calls in ZOO_PATHS:
        baseline = name in ("swin_b", "resnet50")   # BASELINE.json's own
        full = config()
        if attention_calls_per_forward(full) != calls:
            raise AssertionError(f"zoo {name}: the config makes "
                                 f"{attention_calls_per_forward(full)} "
                                 f"calls a forward, not {calls}")
        cfg = full if name == "swin_b" else check_depth(full)
        paths[name] = zoo_model_path(name, cfg,
                                     attention_calls_per_forward(cfg),
                                     device,
                                     serve_batches=2 if baseline else 1,
                                     steps=2 if baseline else 1,
                                     profile=name == "swin_b")
    window = window_attention_profile(swin_b_config())
    busy = paths["swin_b"]["training"]["profile"]["device_busy_ms"]
    window["share_of_step_device_busy"] = window["per_step"]["fwd_bwd_ms"] \
        / busy
    window["step_device_busy_ms"] = busy
    print(f"[zoo] Swin-B window attention: "
          f"{window['per_step']['fwd_bwd_ms']:.3f} ms of a step's "
          f"{busy:.1f} device-busy ms at batch {window['batch']} "
          f"({100 * window['share_of_step_device_busy']:.1f}%); SDPA with "
          f"an additive mask {window['per_step']['library_fwd_bwd_ms']:.3f}"
          f" ms; bound {window['per_step']['bound_fwd_bwd_ms']:.3f} ms",
          flush=True)
    # the CLI's flags turn the YAML's ViT to Swin (its stages cut too)
    swin = check_depth(swin_b_config())
    cli = zoo_cli_phase(swin.replace(visual=swin.visual.replace(
        backbone="clip")), device)
    tok = gen_tokenizer()
    gen_cfg = gen_training_config(tok).replace(
        moe=bench_serving.serving_config().moe.replace(use_moe=True,
                                                       moe_type="sparse"))
    gen = zoo_gen_phase(gen_check_depth(gen_cfg), tok,
                        device)
    library = zoo_library_phase(device)
    return {"paths": paths, "window_attention": window, "cli": cli,
            "generative": gen, "library": library,
            "seconds": time.perf_counter() - t0}


# -- phase 14: pretrained HF towers ------------------------------------------
HF_CLI_CORPUS = 160         # 128 / 16 / 16 samples: 4 train steps of 32
HF_GEN_CORPUS = 80          # 64 / 8 / 8 samples: 2 train steps of 32
HF_BATCH = 32               # both CLIs' batch
HF_SERVE_BATCH = 8          # the classification forward whose launches count
HF_CHECK_BATCH = 4          # the grafted model's logits card against CPU
HF_GEN_BATCH = 16           # the greedy generate's
HF_TOWER_BATCH = {"vit_b16": 2, "dinov2_b_518": 1, "bartpho_encoder": 2}
# the published architectures, as their public config.json gives them
# (only the fields the port reads, and the model type): CLIP ViT-B/32,
# PhoBERT-base, ViT-B/16, DINOv2-B at its 518 px, BARTpho-syllable's
# mBART (of which the encoder and the shared table are written)
HF_MODELS = {
    "openai/clip-vit-base-patch32": {
        "model_type": "clip", "architectures": ["CLIPModel"],
        "projection_dim": 512,
        "vision_config": {"model_type": "clip_vision_model",
                          "hidden_size": 768, "intermediate_size": 3072,
                          "num_hidden_layers": 12,
                          "num_attention_heads": 12, "image_size": 224,
                          "patch_size": 32, "hidden_act": "quick_gelu",
                          "layer_norm_eps": 1e-5}},
    "vinai/phobert-base": {
        "model_type": "roberta", "architectures": ["RobertaForMaskedLM"],
        "vocab_size": 64001, "hidden_size": 768, "num_hidden_layers": 12,
        "num_attention_heads": 12, "intermediate_size": 3072,
        "max_position_embeddings": 258, "type_vocab_size": 1,
        "pad_token_id": 1, "hidden_act": "gelu", "layer_norm_eps": 1e-5},
    "google/vit-base-patch16-224": {
        "model_type": "vit", "architectures": ["ViTForImageClassification"],
        "hidden_size": 768, "num_hidden_layers": 12,
        "num_attention_heads": 12, "intermediate_size": 3072,
        "image_size": 224, "patch_size": 16, "hidden_act": "gelu",
        "layer_norm_eps": 1e-12},
    "facebook/dinov2-base": {
        "model_type": "dinov2", "architectures": ["Dinov2Model"],
        "hidden_size": 768, "num_hidden_layers": 12,
        "num_attention_heads": 12, "mlp_ratio": 4, "patch_size": 14,
        "image_size": 518, "layerscale_value": 1.0,
        "layer_norm_eps": 1e-6},
    "vinai/bartpho-syllable": {
        "model_type": "mbart",
        "architectures": ["MBartForConditionalGeneration"],
        "vocab_size": 40030, "d_model": 1024, "encoder_layers": 12,
        "decoder_layers": 12, "encoder_attention_heads": 16,
        "decoder_attention_heads": 16, "encoder_ffn_dim": 4096,
        "decoder_ffn_dim": 4096, "max_position_embeddings": 1024,
        "activation_function": "gelu", "scale_embedding": False,
        "pad_token_id": 1},
}
# how each is written: the script's own safetensors writer, torch.save's
# pytorch_model.bin, or safetensors shards with their index
HF_FORMATS = {"openai/clip-vit-base-patch32": "safetensors",
              "vinai/phobert-base": "bin",
              "google/vit-base-patch16-224": "safetensors",
              "facebook/dinov2-base": "bin",
              "vinai/bartpho-syllable": "sharded_safetensors"}
# the forward kernel's new shapes at the tower checks' batches: ViT-B/16's
# 197 tokens, DINOv2-B's 1,370 at 518 px, BARTpho's 16 heads over the
# question's 64 tokens under its padding mask
HF_FWD_CASES = [
    ("hf_vit_b16", HF_TOWER_BATCH["vit_b16"], 12, 197, 197, 64, None),
    ("hf_dinov2_518", HF_TOWER_BATCH["dinov2_b_518"], 12, 1370, 1370, 64,
     None),
    ("hf_bartpho", HF_TOWER_BATCH["bartpho_encoder"], 16, 64, 64, 64,
     "query_key"),
]


def _hf_state(name: str, cfg: dict, gen: torch.Generator) -> dict:
    """Seeded tensors under the HF key names of ``name``'s architecture:
    weights and tables normal(0.02), LayerNorm scales 1 + normal(0.02),
    LayerScale gains 1 + normal(0.02), biases normal(0.02)."""
    out = {}

    def w(key, *shape, base=0.0):
        out[key] = base + 0.02 * torch.randn(shape, generator=gen)

    def linear(p, n_out, n_in):
        w(p + ".weight", n_out, n_in)
        w(p + ".bias", n_out)

    def ln(p, d):
        w(p + ".weight", d, base=1.0)
        w(p + ".bias", d)
    mt = cfg["model_type"]
    if mt == "clip":
        v = cfg["vision_config"]
        D, F_, p = v["hidden_size"], v["intermediate_size"], "vision_model."
        n = (v["image_size"] // v["patch_size"]) ** 2 + 1
        w(p + "embeddings.class_embedding", D)
        w(p + "embeddings.patch_embedding.weight", D, 3, v["patch_size"],
          v["patch_size"])
        w(p + "embeddings.position_embedding.weight", n, D)
        ln(p + "pre_layrnorm", D)
        for i in range(v["num_hidden_layers"]):
            q = f"{p}encoder.layers.{i}."
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                linear(q + "self_attn." + proj, D, D)
            ln(q + "layer_norm1", D)
            linear(q + "mlp.fc1", F_, D)
            linear(q + "mlp.fc2", D, F_)
            ln(q + "layer_norm2", D)
        ln(p + "post_layernorm", D)
        w("visual_projection.weight", cfg["projection_dim"], D)
        out["logit_scale"] = torch.tensor(2.6592)
    elif mt == "roberta":
        D, F_, p = cfg["hidden_size"], cfg["intermediate_size"], "roberta."
        w(p + "embeddings.word_embeddings.weight", cfg["vocab_size"], D)
        w(p + "embeddings.position_embeddings.weight",
          cfg["max_position_embeddings"], D)
        w(p + "embeddings.token_type_embeddings.weight",
          cfg["type_vocab_size"], D)
        ln(p + "embeddings.LayerNorm", D)
        # an old checkpoint's buffer, which the reader ignores
        out[p + "embeddings.position_ids"] = torch.arange(
            cfg["max_position_embeddings"])[None]
        for i in range(cfg["num_hidden_layers"]):
            q = f"{p}encoder.layer.{i}."
            for proj in ("query", "key", "value"):
                linear(q + "attention.self." + proj, D, D)
            linear(q + "attention.output.dense", D, D)
            ln(q + "attention.output.LayerNorm", D)
            linear(q + "intermediate.dense", F_, D)
            linear(q + "output.dense", D, F_)
            ln(q + "output.LayerNorm", D)
        w("lm_head.bias", cfg["vocab_size"])        # the MLM head: ignored
    elif mt in ("vit", "dinov2"):
        D = cfg["hidden_size"]
        F_ = cfg.get("intermediate_size") or int(D * cfg["mlp_ratio"])
        p = "vit." if mt == "vit" else ""
        ps = cfg["patch_size"]
        n = (cfg["image_size"] // ps) ** 2 + 1
        w(p + "embeddings.cls_token", 1, 1, D)
        w(p + "embeddings.position_embeddings", 1, n, D)
        w(p + "embeddings.patch_embeddings.projection.weight", D, 3, ps, ps)
        w(p + "embeddings.patch_embeddings.projection.bias", D)
        if mt == "dinov2":
            w("embeddings.mask_token", 1, D)
        for i in range(cfg["num_hidden_layers"]):
            q = f"{p}encoder.layer.{i}."
            for proj in ("query", "key", "value"):
                linear(q + "attention.attention." + proj, D, D)
            linear(q + "attention.output.dense", D, D)
            if mt == "vit":
                ln(q + "layernorm_before", D)
                ln(q + "layernorm_after", D)
                linear(q + "intermediate.dense", F_, D)
                linear(q + "output.dense", D, F_)
            else:
                ln(q + "norm1", D)
                ln(q + "norm2", D)
                linear(q + "mlp.fc1", F_, D)
                linear(q + "mlp.fc2", D, F_)
                w(q + "layer_scale1.lambda1", D, base=cfg["layerscale_value"])
                w(q + "layer_scale2.lambda1", D, base=cfg["layerscale_value"])
        ln(p + "layernorm", D)
        if mt == "vit":
            linear("classifier", 1000, D)           # the head: ignored
    elif mt == "mbart":
        D, F_ = cfg["d_model"], cfg["encoder_ffn_dim"]
        w("shared.weight", cfg["vocab_size"], D)     # tied: no embed_tokens
        w("encoder.embed_positions.weight",
          cfg["max_position_embeddings"] + 2, D)
        ln("encoder.layernorm_embedding", D)
        for i in range(cfg["encoder_layers"]):
            q = f"encoder.layers.{i}."
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                linear(q + "self_attn." + proj, D, D)
            ln(q + "self_attn_layer_norm", D)
            linear(q + "fc1", F_, D)
            linear(q + "fc2", D, F_)
            ln(q + "final_layer_norm", D)
        ln("encoder.layer_norm", D)
    return out


_SAFE_NAMES = {torch.float32: "F32", torch.int64: "I64"}


def write_safetensors(path, tensors: dict) -> None:
    """The safetensors layout: a little-endian u64 header length, a JSON
    header (dtype, shape, byte offsets of each tensor), the raw bytes."""
    header, blobs, offset = {"__metadata__": {"format": "pt"}}, [], 0
    for key, t in tensors.items():
        raw = t.contiguous().reshape(-1).view(torch.uint8).numpy()
        header[key] = {"dtype": _SAFE_NAMES[t.dtype], "shape": list(t.shape),
                       "data_offsets": [offset, offset + raw.size]}
        blobs.append(raw)
        offset += raw.size
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for raw in blobs:
            f.write(memoryview(raw))


def hf_models_at(layers: int) -> dict:
    """HF_MODELS' config.json dicts with every layer stack cut to
    ``layers``; widths, heads, vocabularies and image sizes as
    published."""
    out = {}
    for name, cfg in HF_MODELS.items():
        cfg = copy.deepcopy(cfg)
        for d in (cfg, cfg.get("vision_config", {})):
            for key in ("num_hidden_layers", "encoder_layers",
                        "decoder_layers"):
                if key in d:
                    d[key] = min(d[key], layers)
        out[name] = cfg
    return out


def write_hf_checkpoints(root: str, seed: int = 0,
                         models: dict = HF_MODELS) -> dict:
    """Each of ``models`` (name: its config.json) as a local HF model
    directory under ``root`` (config.json and its weights in
    ``HF_FORMATS``' form), its tensors from ``seed``. Returns {name:
    (directory, tensors by key)}."""
    out = {}
    for i, (name, cfg) in enumerate(models.items()):
        state = _hf_state(name, cfg, torch.Generator().manual_seed(seed + i))
        d = Path(root) / name.replace("/", "--")
        d.mkdir(parents=True, exist_ok=True)
        (d / "config.json").write_text(json.dumps(cfg))
        form = HF_FORMATS[name]
        if form == "bin":
            torch.save(state, d / "pytorch_model.bin")
        elif form == "safetensors":
            write_safetensors(d / "model.safetensors", state)
        else:
            keys = list(state)
            half = len(keys) // 2
            shards = {"model-00001-of-00002.safetensors": keys[:half],
                      "model-00002-of-00002.safetensors": keys[half:]}
            for shard, ks in shards.items():
                write_safetensors(d / shard, {k: state[k] for k in ks})
            (d / "model.safetensors.index.json").write_text(json.dumps({
                "metadata": {"total_size": sum(
                    t.numel() * t.element_size() for t in state.values())},
                "weight_map": {k: s for s, ks in shards.items()
                               for k in ks}}))
        out[name] = (str(d), state)
    return out


def grafted_tower_mismatches(model, clip: dict, phobert: dict) -> dict:
    """Every tower parameter of a grafted classification model against
    the files' tensors under their HF names, mapped by hand (the port's
    Dense weights are HF's (out, in) Linear weights; CLIP's class
    embedding and position table gain leading axes, its patch conv has no
    bias; PhoBERT's positions start at row 2 with its one type row added):
    {parameter: max |diff|} of those that are not bit-equal, and the
    count checked."""
    v, t = "vision_model.", "roberta."
    L = model.config.text.max_length
    want = {
        "visual_encoder.cls_token":
            clip[v + "embeddings.class_embedding"].reshape(1, 1, -1),
        "visual_encoder.pos_embed":
            clip[v + "embeddings.position_embedding.weight"][None],
        "visual_encoder.patch_embed.weight":
            clip[v + "embeddings.patch_embedding.weight"],
        "visual_encoder.patch_embed.bias":
            torch.zeros(model.config.visual.hidden_dim),
        "text_encoder.token_embed.weight":
            phobert[t + "embeddings.word_embeddings.weight"],
        "text_encoder.pos_embed.weight":
            phobert[t + "embeddings.position_embeddings.weight"][2: 2 + L]
            + phobert[t + "embeddings.token_type_embeddings.weight"][0],
    }
    for a, b in (("ln_pre", "pre_layrnorm"), ("ln_final", "post_layernorm")):
        for leaf in ("weight", "bias"):
            want[f"visual_encoder.{a}.{leaf}"] = clip[f"{v}{b}.{leaf}"]
    for leaf in ("weight", "bias"):
        want[f"text_encoder.ln_embed.{leaf}"] = \
            phobert[f"{t}embeddings.LayerNorm.{leaf}"]
    clip_names = {"self_attn.query": "self_attn.q_proj",
                  "self_attn.key": "self_attn.k_proj",
                  "self_attn.value": "self_attn.v_proj",
                  "self_attn.out": "self_attn.out_proj",
                  "mlp.wi": "mlp.fc1", "mlp.wo": "mlp.fc2",
                  "ln1": "layer_norm1", "ln2": "layer_norm2"}
    text_names = {"self_attn.query": "attention.self.query",
                  "self_attn.key": "attention.self.key",
                  "self_attn.value": "attention.self.value",
                  "self_attn.out": "attention.output.dense",
                  "mlp.wi": "intermediate.dense", "mlp.wo": "output.dense",
                  "ln1": "attention.output.LayerNorm",
                  "ln2": "output.LayerNorm"}
    for i in range(model.config.visual.num_layers):
        for ours, theirs in clip_names.items():
            for leaf in ("weight", "bias"):
                want[f"visual_encoder.layers.{i}.{ours}.{leaf}"] = \
                    clip[f"{v}encoder.layers.{i}.{theirs}.{leaf}"]
    for i in range(model.config.text.num_layers):
        for ours, theirs in text_names.items():
            for leaf in ("weight", "bias"):
                want[f"text_encoder.layers.{i}.{ours}.{leaf}"] = \
                    phobert[f"{t}encoder.layer.{i}.{theirs}.{leaf}"]
    params = {n: p for n, p in model.named_parameters()
              if n.startswith(("visual_encoder.", "text_encoder."))}
    if set(params) != set(want):
        raise AssertionError(f"grafted towers' parameters "
                             f"{sorted(set(params) ^ set(want))[:4]} are "
                             f"not the files' tensors")
    bad = {n: float((p.detach().cpu() - want[n]).abs().max())
           for n, p in params.items()
           if not torch.equal(p.detach().cpu(), want[n])}
    return {"checked": len(params), "not_bit_equal": bad}


def hf_cli_phase(cfg: VQAModelConfig, clip: str, phobert: str,
                 device: str = "cuda", n: int = HF_CLI_CORPUS,
                 image_size: int = 224, batch: int = HF_BATCH,
                 seed: int = 0) -> dict:
    """The classification CLI (``vqa_pipeline.main``) with
    ``--pretrained-visual`` and ``--pretrained-text`` over a YAML config
    that holds ``cfg`` (its towers re-derived from the checkpoints):
    train (one epoch, a validation, the final evaluation on the best
    checkpoint) and evaluate from the checkpoint, each with its launches
    (a forward's: the config's count; a step's: as many of each training
    kernel)."""
    from vivqa_tpu_torch.pipelines import vqa_pipeline
    on_card = device == "cuda"
    per_forward = attention_calls_per_forward(cfg) if on_card else 0
    with tempfile.TemporaryDirectory() as tmp:
        csv, imgs = generate_synthetic_vivqa(f"{tmp}/data", n=n,
                                             image_size=image_size,
                                             learnable=True, seed=seed)
        ckpt_dir, out_dir = f"{tmp}/ckpt", f"{tmp}/out"
        vcfg = VQAPipelineConfig(
            data=DataPipelineConfig(
                csv_path=str(csv), image_dir=str(imgs),
                image_size=image_size,
                max_question_length=cfg.text.max_length, batch_size=batch,
                augmentation_strength="medium", seed=seed),
            model=ModelPipelineConfig(model=cfg, device=device, seed=seed),
            training=TrainingPipelineConfig(num_epochs=1,
                                            checkpoint_dir=ckpt_dir,
                                            log_every=4, seed=seed),
            output_dir=out_dir, seed=seed)
        path = f"{tmp}/hf.yaml"
        vcfg.to_yaml(path)
        flags = ["--config", path, "--pretrained-visual", clip,
                 "--pretrained-text", phobert, "--device", device]
        runs = {}
        for mode, extra in (("train", []), ("evaluate",
                                            ["--resume", ckpt_dir])):
            fa.reset_launch_counts()
            t0 = time.perf_counter()
            summary = vqa_pipeline.main(flags + ["--mode", mode] + extra)
            runs[mode] = {"seconds": time.perf_counter() - t0,
                          "launches": launch_snapshot(),
                          "summary": summary}
        data = DataPipeline(vcfg.data).run()
        steps = len(data.train_loader)
        val_batches = math.ceil(len(data.val_loader.dataset) / batch)
        test_batches = math.ceil(len(data.test_loader.dataset) / batch)
    train, evaluate = runs["train"]["summary"], runs["evaluate"]["summary"]
    zero = {name: 0 for name in TRAIN_KERNELS}
    want = {"train": {**{name: per_forward * steps
                         for name in TRAIN_KERNELS},
                      "flash_attn_fwd": per_forward * (1 + 2 * val_batches)},
            "evaluate": {**zero,
                         "flash_attn_fwd": per_forward * (1 + test_batches)}}
    history = train["history"]
    finite = [h["train_loss"] for h in history] + \
        [h["val_loss"] for h in history] + list(evaluate["metrics"].values())
    problems = [f"{m} launches {runs[m]['launches']} != {w}"
                for m, w in want.items() if runs[m]["launches"] != w]
    if len(history) != 1 or not all(math.isfinite(x) for x in finite):
        problems.append(f"history {history}, metrics {evaluate['metrics']}")
    if problems:
        raise AssertionError(f"hf_import classification CLI: {problems}")
    return {"flags": flags[2:6], "corpus": n, "batch": batch,
            "steps": steps, "attention_calls_per_forward": per_forward,
            "run_seconds": {m: r["seconds"] for m, r in runs.items()},
            "launches": {m: r["launches"] for m, r in runs.items()},
            "history": history, "evaluate_metrics": evaluate["metrics"]}


def hf_gen_phase(cfg: GenerativeVQAConfig, clip: str, phobert: str,
                 device: str = "cuda", n: int = HF_GEN_CORPUS,
                 image_size: int = 224, batch: int = HF_BATCH,
                 gen_batch: int = HF_GEN_BATCH, new_tokens: int = 32,
                 seed: int = 0) -> dict:
    """The generative CLI (``generative_vqa_pipeline.main``) with the same
    towers: train (one epoch of 2 steps, a greedy validation, a
    checkpoint) and a greedy evaluate from ``--resume``, each held to
    the config's launches (a step's, a generate's encoder and decode
    steps as the model counted them); then the resumed model's greedy
    generate at ``gen_batch`` over ``new_tokens`` without early exit (411
    launches at bench_serving's config)."""
    from vivqa_tpu_torch.pipelines import generative_vqa_pipeline as gvp
    on_card = device == "cuda"
    per_step = gen_calls_per_step(cfg)
    enc_calls = attention_calls_per_generate(cfg, 0)
    with tempfile.TemporaryDirectory() as tmp:
        csv, imgs = generate_synthetic_vivqa(
            f"{tmp}/data", n=n, image_size=image_size, learnable=True,
            seq_answers=True, seed=seed)
        ckpt, out = f"{tmp}/ckpt", f"{tmp}/out"
        pcfg = gvp.GenerativeVQAPipelineConfig(
            data=DataPipelineConfig(
                csv_path=str(csv), image_dir=str(imgs),
                image_size=image_size,
                max_question_length=cfg.text.max_length,
                max_answer_length=cfg.max_answer_length, batch_size=batch,
                augmentation_strength="medium", generative=True, seed=seed),
            model=cfg.replace(dropout=GEN_DROPOUT, label_smoothing=0.0),
            training=GenerativeTrainingConfig(
                num_epochs=1, label_smoothing=0.0, checkpoint_dir=ckpt,
                optimizer=OptimizerConfig(learning_rate=1e-3,
                                          weight_decay=0.01),
                log_every=1, seed=seed),
            device=device, output_dir=out, seed=seed,
            pretrained_visual=clip, pretrained_text=phobert)
        yaml_path = f"{tmp}/hf_gen.yaml"
        pcfg.to_yaml(yaml_path)
        runs = {}
        for mode, extra in (("train", []),
                            ("evaluate", ["--resume", ckpt, "--decode",
                                          "greedy"])):
            counts = {"generates": 0, "decode_steps": 0}
            fa.reset_launch_counts()
            t0 = time.perf_counter()
            with counting_decode(counts):
                summary = gvp.main(["--config", yaml_path, "--mode", mode]
                                   + extra)
            runs[mode] = {"seconds": time.perf_counter() - t0,
                          "launches": launch_snapshot(), **counts,
                          "summary": summary}
        pipe = gvp.GenerativeVQAPipeline(pcfg.replace(resume=ckpt))
        data, model = pipe._setup()
        steps = len(data.train_loader)
    px, q = (torch.from_numpy(a).to(device) for a in
             bench_serving.synthetic_requests(model.config, gen_batch))
    generate = build_generate_fn(model, bench_serving.decode_config(
        "greedy", new_tokens))
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    seqs, scores = generate(px, q)
    if on_card:
        torch.cuda.synchronize()
    generate_ms = (time.perf_counter() - t0) * 1e3
    gen_launches = launch_snapshot()
    zero = {name: 0 for name in TRAIN_KERNELS}

    def fwd(mode):
        r = runs[mode]
        return (enc_calls * r["generates"]
                + 2 * cfg.decoder_layers * r["decode_steps"]) if on_card \
            else 0
    want = {mode: {**zero, "flash_attn_fwd": fwd(mode)} for mode in runs}
    want["train"].update({name: per_step * steps if on_card else 0
                          for name in TRAIN_KERNELS})
    per_generate = attention_calls_per_generate(cfg, new_tokens)
    want_gen = {**zero, "flash_attn_fwd": per_generate if on_card else 0}
    problems = [f"{m} launches {runs[m]['launches']} != {w}"
                for m, w in want.items() if runs[m]["launches"] != w]
    if gen_launches != want_gen:
        problems.append(f"greedy generate launches {gen_launches} != "
                        f"{want_gen}")
    history = runs["train"]["summary"]["history"]
    metrics = runs["evaluate"]["summary"]["metrics"]
    if len(history) != 1 or not math.isfinite(history[0]["train_loss"]) \
            or runs["evaluate"]["generates"] < 1 \
            or seqs.shape != (gen_batch, new_tokens) \
            or not bool(torch.isfinite(scores).all()):
        problems.append(f"history {history}, evaluate generates "
                        f"{runs['evaluate']['generates']}, sequences "
                        f"{tuple(seqs.shape)}")
    if problems:
        raise AssertionError("hf_import generative CLI: "
                             + "; ".join(problems))
    return {"steps": steps, "batch": batch,
            "run_seconds": {m: r["seconds"] for m, r in runs.items()},
            "launches": {m: r["launches"] for m, r in runs.items()},
            "generates": {m: r["generates"] for m, r in runs.items()},
            "decode_steps": {m: r["decode_steps"] for m, r in runs.items()},
            "history": history, "evaluate_metrics": metrics,
            "text_vocab": model.config.text.vocab_size,
            "greedy_generate": {"batch": gen_batch,
                                "new_tokens": new_tokens, "ms": generate_ms,
                                "launches": gen_launches["flash_attn_fwd"]}}


def hf_tower_check(name: str, path: str, device: str = "cuda",
                   seed: int = 0, batch: int | None = None,
                   max_length: int = 64) -> dict:
    """One published tower at its own size, loaded from ``path`` by the
    port's loader in bf16 (DINOv2 at 518 px, which the loader keeps from
    the config it is given): its forward on the CPU and on the card at
    ``HF_TOWER_BATCH`` on the same inputs (each output held to 5% of its
    largest value, ``compare_logits``' rule) and the card's launches (one
    a layer)."""
    from vivqa_tpu_torch.models.config import TextEncoderConfig
    from vivqa_tpu_torch.models.convert import (
        load_pretrained_text_encoder, load_pretrained_visual_encoder)
    from vivqa_tpu_torch.models.from_jax import load_flax_params
    B = batch or HF_TOWER_BATCH[name]
    rs = np.random.RandomState(seed + B)
    t0 = time.perf_counter()
    if name == "bartpho_encoder":
        enc, tree = load_pretrained_text_encoder(
            path, TextEncoderConfig(max_length=max_length))
        L = enc.config.max_length
        lengths = rs.randint(5, L + 1, B)
        lengths[0] = L
        mask = (np.arange(L)[None] < lengths[:, None]).astype(np.int64)
        ids = rs.randint(4, enc.config.vocab_size, (B, L)) * mask
        inputs = (torch.from_numpy(ids), torch.from_numpy(mask))
    else:
        with open(Path(path) / "config.json") as f:
            size = json.load(f)["image_size"]
        enc, tree = load_pretrained_visual_encoder(
            path, VisualEncoderConfig(image_size=size))
        inputs = (torch.from_numpy(rs.rand(B, size, size, 3).astype(
            np.float32)),)
    load_flax_params(enc, tree)
    load_s = time.perf_counter() - t0
    outs = {}
    for label, dev in (("cpu", "cpu"), ("card", device)):
        module = copy.deepcopy(enc).to(dev).eval()
        fa.reset_launch_counts()
        t = time.perf_counter()
        with torch.no_grad():
            res = module(*(a.to(dev) for a in inputs))
        if dev == "cuda":
            torch.cuda.synchronize()
        outs[label] = {"seconds": time.perf_counter() - t,
                       "launches": launch_snapshot(),
                       **{k: res[k].float().cpu() for k in
                          ("tokens", "pooled")}}
    result = {"batch": B, "config": {
        k: getattr(enc.config, k) for k in (
            "hidden_dim", "num_layers", "num_heads") if hasattr(enc.config,
                                                               k)},
        "tokens": list(outs["card"]["tokens"].shape),
        "load_seconds": load_s, "outputs": {},
        "card_launches": outs["card"]["launches"],
        "seconds": {k: v["seconds"] for k, v in outs.items()}}
    for k in ("tokens", "pooled"):
        a, b = outs["card"][k], outs["cpu"][k]
        diff = float((a - b).abs().max())
        tol = 0.05 * float(b.abs().max())
        result["outputs"][k] = {"max_abs_diff": diff, "tolerance": tol}
        if not math.isfinite(diff) or diff > tol:
            raise AssertionError(f"hf_import {name}: card vs CPU {k} "
                                 f"{diff} > {tol}")
    layers = enc.config.num_layers
    want = {n: 0 for n in outs["card"]["launches"]}
    want["flash_attn_fwd"] = layers if device == "cuda" else 0
    if name != "bartpho_encoder" and device == "cuda":
        # a visual tower's calls over its patch tokens and the class
        # token; where they take the long form with key splits, each call
        # also launches the merge
        cfg = enc.config
        L = (cfg.image_size // cfg.patch_size) ** 2 + 1
        merges = layers * (fa.forward_plan(
            B, cfg.num_heads, L, L, cfg.hidden_dim // cfg.num_heads)[
                "launches"] - 1)
        if merges:
            want["flash_attn_fwd_merge"] = merges
    if outs["card"]["launches"] != want:
        raise AssertionError(f"hf_import {name}: launches "
                             f"{outs['card']['launches']} != {want}")
    return result


def hf_kernel_phase() -> dict:
    """The forward kernel at the pretrained towers' new shapes
    (``attention_case``: f32, f16 and bf16 against the plain version, timed
    beside SDPA with its bound)."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    return {name: attention_case(name, B, H, Lq, Lk, D, kind, False, gen)
            for name, B, H, Lq, Lk, D, kind in HF_FWD_CASES}


def hf_import_phase(device: str = "cuda", seed: int = 0,
                    models: dict = HF_MODELS,
                    cfg: VQAModelConfig | None = None,
                    gen_cfg: GenerativeVQAConfig | None = None,
                    image_size: int = 224, cli_n: int = HF_CLI_CORPUS,
                    gen_n: int = HF_GEN_CORPUS, batch: int = HF_BATCH,
                    serve_batch: int = HF_SERVE_BATCH,
                    check_batch: int = HF_CHECK_BATCH,
                    gen_batch: int = HF_GEN_BATCH, new_tokens: int = 32,
                    tower_batch: int | None = None) -> dict:
    """Pretrained HF towers through the user's entry points (phase 14):
    seeded checkpoints of the five published architectures written in
    the HF layout (safetensors by ``write_safetensors``, a
    ``pytorch_model.bin``, safetensors shards), read back by the port's
    reader (no ``transformers`` on the card's machine); the grafted
    classification model's towers bit-equal to the files' tensors, its
    forward's launches (36 at the flagship's structure) and its logits
    against the CPU's; both CLIs with ``--pretrained-visual`` CLIP
    ViT-B/32 and ``--pretrained-text`` PhoBERT-base; ViT-B/16, DINOv2-B at
    518 px and BARTpho's encoder at the tower level, card against CPU."""
    t0 = time.perf_counter()
    on_card = device == "cuda"
    cfg = cfg or flagship_config()
    gen_cfg = gen_cfg or bench_serving.serving_config()
    with tempfile.TemporaryDirectory() as tmp:
        files = write_hf_checkpoints(tmp, seed, models)
        write_s = time.perf_counter() - t0
        clip_dir, clip = files["openai/clip-vit-base-patch32"]
        pho_dir, pho = files["vinai/phobert-base"]
        sizes = {name: {"files": sorted(p.name for p in Path(d).iterdir()),
                        "bytes": sum(p.stat().st_size
                                     for p in Path(d).iterdir()),
                        "tensors": len(state)}
                 for name, (d, state) in files.items()}

        # the grafted model on the card and on the CPU, from one seed
        built = {}
        for label, dev in (("card", device), ("cpu", "cpu")):
            fa.reset_launch_counts()
            out = ModelPipeline(ModelPipelineConfig(
                model=cfg, device=dev, seed=seed,
                pretrained_visual=clip_dir,
                pretrained_text=pho_dir)).run(num_answers=cfg.num_answers)
            built[label] = out.model
        card_model = built["card"]
        graft = grafted_tower_mismatches(card_model, clip, pho)
        if graft["not_bit_equal"]:
            raise AssertionError(f"hf_import: grafted towers differ from "
                                 f"the files: {graft['not_bit_equal']}")
        grafted_cfg = card_model.config
        calls = attention_calls_per_forward(grafted_cfg)
        b = trainer_batch(grafted_cfg, serve_batch, seed)
        args = [torch.from_numpy(b[k]).to(device) for k in (
            "pixel_values", "input_ids", "attention_mask")]
        fa.reset_launch_counts()
        with torch.no_grad():
            logits = card_model(*args)["logits"]
        forward_launches = launch_snapshot()
        want = {n: 0 for n in forward_launches}
        want["flash_attn_fwd"] = calls if on_card else 0
        if forward_launches != want \
                or calls != attention_calls_per_forward(cfg):
            raise AssertionError(f"hf_import forward launches "
                                 f"{forward_launches} != {want}")
        cb = trainer_batch(grafted_cfg, check_batch, seed + 1)
        with torch.no_grad():
            got = {label: m(*[torch.from_numpy(cb[k]).to(
                next(m.parameters()).device) for k in (
                    "pixel_values", "input_ids", "attention_mask")])[
                        "logits"].float().cpu().numpy()
                for label, m in built.items()}
        logits_check = compare_logits(got["card"], got["cpu"])
        del built, card_model
        print(f"[hf_import] checkpoints written in {write_s:.1f} s; grafted "
              f"towers: {graft['checked']} parameters bit-equal to the "
              f"files; a forward {forward_launches['flash_attn_fwd']} "
              f"launches; logits card/CPU max diff "
              f"{logits_check['max_abs_logit_diff']:.3g} (tolerance "
              f"{logits_check['tolerance']:.3g})", flush=True)

        cli = hf_cli_phase(cfg, clip_dir, pho_dir, device, n=cli_n,
                           image_size=image_size, batch=batch, seed=seed)
        gen = hf_gen_phase(gen_cfg, clip_dir, pho_dir, device, n=gen_n,
                           image_size=image_size, batch=batch,
                           gen_batch=gen_batch, new_tokens=new_tokens,
                           seed=seed)
        towers = {
            name: hf_tower_check(name, files[hub][0], device, seed,
                                 tower_batch, cfg.text.max_length)
            for name, hub in (("vit_b16", "google/vit-base-patch16-224"),
                              ("dinov2_b_518", "facebook/dinov2-base"),
                              ("bartpho_encoder", "vinai/bartpho-syllable"))}
    return {"checkpoints": sizes, "write_seconds": write_s,
            "graft": {"checked": graft["checked"], "bit_equal": True},
            "grafted_config": {"visual": grafted_cfg.visual.to_dict(),
                               "text": grafted_cfg.text.to_dict()},
            "forward_launches": forward_launches,
            "logits_card_vs_cpu": logits_check, "cli": cli,
            "generative": gen, "towers": towers,
            "seconds": time.perf_counter() - t0}


# -- phase 15: the ('data', 'model') mesh -------------------------------------
MESH_BATCH = 32                 # the global batch of the mesh's train steps
MESH_SHAPES = ((2, 1), (1, 2))
MESH_STEPS = 2
MESH_SMALL_LAYERS = 2           # the f32 copy's depth
MESH_GEN_BATCH = 16
MESH_KNOWLEDGE_DIM = 256        # the knowledge provider's encoder_dim
MESH_CLI_CORPUS = 80            # 64 / 8 / 8 samples: 2 train steps of 32
MESH_CLI_STEPS = 2
# the ablation phase's rows that the study runs on two ranks: the full
# model and a post-hoc masked twin of the leave-one-out row
MESH_ABL_ROWS = ("full__noisy_topk_k2_lb0.01",
                 "ph_leave_one_out_3__noisy_topk_k2_lb0.01")
# The flagship's attention at the per-rank shapes of the (1, 2) mesh: all
# MESH_BATCH rows, half the heads (ViT and text 6 of 12, MCAN 4 of 8);
# (name, B, H, Lq, Lk, D, mask kind, causal, calls per step and per
# forward). The (2, 1) mesh's calls (16 rows, every head) and the
# generative model's are held by path_check.
MESH_CASES = [
    ("mesh_vit_self_h6", MESH_BATCH, 6, 50, 50, 64, None, False, 12),
    ("mesh_text_self_h6", MESH_BATCH, 6, 64, 64, 64, "query_key", False, 12),
    ("mesh_mcan_enc_self_h4", MESH_BATCH, 4, 64, 64, 64, "query_key", False,
     4),
    ("mesh_mcan_dec_self_h4", MESH_BATCH, 4, 49, 49, 64, None, False, 4),
    ("mesh_mcan_cross_h4", MESH_BATCH, 4, 49, 64, 64, "key", False, 4),
]
# KnowledgeAttention on the meshes: one query over RAG_K keys under the
# knowledge mask, at 4 of 8 heads for all rows on (1, 2) (counted in the
# (1, 2) rank's totals) and at 8 heads for half the rows on (2, 1)
MESH_KNOWLEDGE_CASES = [
    ("mesh_know_attn_h4", MESH_BATCH, 4, 1, RAG_K, 64, "knowledge", False,
     1),
    ("mesh_know_attn_b16", MESH_BATCH // 2, 8, 1, RAG_K, 64, "knowledge",
     False, 0),
]


def mesh_training_row(name, B, H, Lq, Lk, D, kind, causal, calls, rate,
                      gen) -> dict:
    """The training kernels at one per-rank shape against their
    plain versions in f32, f16 and bf16 at dropout ``rate``, timed in
    bf16 beside SDPA with their bounds."""
    key = fa.dropout_key(2031, B * 1000 + H * 10 + Lq) if rate else None
    errs = {}
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        q, k, v, mask = attention_inputs(B, H, Lq, Lk, D, kind, dtype, gen)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
        errs[dtype] = check_train_kernels(q, k, v, do, mask, causal, rate,
                                          key)
    row = {"case": name, "B": B, "H": H, "Lq": Lq, "Lk": Lk, "D": D,
           "mask": kind, "causal": causal, "dropout": rate,
           "calls_per_step": calls,
           "max_err_bf16": errs[torch.bfloat16],
           "max_err_f16": errs[torch.float16],
           "max_err_f32": errs[torch.float32],
           **time_train_kernels(q, k, v, do, mask, causal, rate, key)}
    emit({"mesh_training_attention_case": row})
    return row


def mesh_kernel_phase() -> dict:
    """The four kernels at the mesh phase's per-rank shapes against their
    plain versions, timed beside SDPA with their bounds: the forward
    (``attention_case``, as an evaluation forward calls it) and the three
    training kernels (``mesh_training_row``) at the flagship's shapes on
    (1, 2) at dropout 0 (the mesh runs its steps at dropout 0); at
    KnowledgeAttention's on both meshes, the training kernels also at
    dropout 0.1; and at the ablation study's per-rank batch
    (``abl_kernel_phase``). {flagship, knowledge: rows keyed by case (and
    rate), ablation: the study's rows}."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    rows = {"flagship": {}, "knowledge": {}}
    for part, cases in (("flagship", MESH_CASES),
                        ("knowledge", MESH_KNOWLEDGE_CASES)):
        for name, B, H, Lq, Lk, D, kind, causal, calls in cases:
            fwd = attention_case(name, B, H, Lq, Lk, D, kind, causal, gen,
                                 calls_per_forward=calls)
            rates = (0.0,) if part == "flagship" else (0.0, 0.1)
            for rate in rates:
                train = mesh_training_row(name, B, H, Lq, Lk, D, kind,
                                          causal, calls if rate == 0 else 0,
                                          rate, gen)
                key = name if part == "flagship" else (name, rate)
                rows[part][key] = {"forward": fwd, "training": train}
    rows["ablation"] = abl_kernel_phase(abl_model_config(),
                                        batch=ABL_BATCH // 2)
    return rows


def mesh_totals(rows: dict) -> dict:
    """Each kernel's time, plain version's, bound and SDPA's time over one
    rank's evaluation forward (the forward) or train step (the training
    kernels), each shape's number times its calls: the flagship on the
    (1, 2) mesh, with KnowledgeAttention (``knowledge``), and the study's
    full model at its per-rank batch on (2, 1) (``ablation``)."""
    def totals(part_rows):
        fwd = {str(n): r["forward"] for n, r in part_rows.items()}
        out = {"flash_attn_fwd": _path_totals(fwd, "calls_per_forward")}
        out.update(step_totals({str(n): r["training"]
                                for n, r in part_rows.items()}))
        return out
    out = totals(rows["flagship"])
    out["knowledge"] = totals({**rows["flagship"], **rows["knowledge"]})
    out["ablation"] = {"per_step": step_totals(rows["ablation"]),
                       "per_validation_forward":
                           abl_forward_totals(rows["ablation"])}
    return out


def mesh_flagship(cfg: VQAModelConfig, seed: int,
                  device: str = "cuda") -> torch.nn.Module:
    """The model of ``cfg`` on ``device`` with seeded weights drawn there
    (the same on every rank of the card), dropout 0."""
    model = VietnameseVQAModel(cfg).to(device)
    init_weights(model, torch.Generator(device=device).manual_seed(seed))
    return no_dropout(model)


def mesh_batch(cfg: VQAModelConfig, seed: int = 0,
               batch: int = MESH_BATCH) -> dict:
    """The global batch: train_check's ragged questions (64, 40, 17, 5
    tokens) repeated over MESH_BATCH rows, so that every rank's rows hold
    padded, fully masked query rows."""
    S, L = cfg.visual.image_size, cfg.text.max_length
    rs = np.random.RandomState(seed + 7)
    lengths = np.resize(np.minimum([L, 40, 17, 5], L), batch)
    mask = (np.arange(L)[None] < lengths[:, None]).astype(np.int64)
    return {"pixel_values": rs.rand(batch, S, S, 3).astype(np.float32),
            "input_ids": rs.randint(4, cfg.text.vocab_size - 1,
                                    (batch, L)) * mask,
            "attention_mask": mask,
            "labels": rs.randint(0, cfg.num_answers, (batch,))}


def _f32_everywhere(model: torch.nn.Module) -> torch.nn.Module:
    for m in model.modules():
        if getattr(m, "dtype", None) in (torch.bfloat16, torch.float16):
            m.dtype = torch.float32
    return model


def mesh_optimizer(name: str):
    """The mesh phase's optimizer by name: bench.py's AdamW (a one-step
    warmup, so the second step moves the weights at lr 1e-4), or
    adafactor as the JAX package's ``create_optimizer`` builds it at the
    same rate and schedule."""
    if name == "adamw":
        return lambda model: bench_optimizer(model, 1)
    return lambda model: create_optimizer(
        OptimizerConfig(name="adafactor", learning_rate=1e-4), model,
        SchedulerConfig(name="warmup_cosine", warmup_steps=1,
                        total_steps=10000))


def mesh_train(cfg: VQAModelConfig, mesh, data: dict, seed: int,
               device: str = "cuda", f32: bool = False,
               keys: set | None = None, optimizer: str = "adamw",
               logits: bool = False, statistics: bool = False) -> dict:
    """MESH_STEPS steps of the global batch on ``mesh`` (None: one
    process): per step the loss, the grad norm, the CUDA-event ms and the
    collectives' host ms and bytes; the launches of each kernel; the peak
    memory; then one evaluation forward's launches (with ``logits`` its
    logits, gathered over 'data'). The batch's knowledge arrays reach
    the model. The update (after - before, whole: gathered over 'model')
    stays on the card for the caller, and with ``statistics`` the
    optimizer's factored statistics, whole."""
    from vivqa_tpu_torch.parallel.collectives import (all_gather,
                                                      reset_stats, stats)
    from vivqa_tpu_torch.parallel.mesh import full_tensor, local_rows
    from vivqa_tpu_torch.train.checkpoint import gathered_optimizer_state
    from vivqa_tpu_torch.train.state import (ShardedStep, knowledge_of,
                                             place_state)
    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    model = mesh_flagship(cfg, seed, device)
    if f32:
        _f32_everywhere(model)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = TrainState.create(model, mesh_optimizer(optimizer)(model),
                              seed=seed)
    if mesh is not None:
        place_state(state, mesh)
        step = ShardedStep(mesh, make_train_step(
            classification_loss_fn())).compile(state)[0]
    else:
        step = make_train_step(classification_loss_fn())
    batch = batch_to_device(data, torch.device(device))
    out = {"loss": [], "grad_norm": [], "step_event_ms": [],
           "collective_host_ms": [], "collective_bytes": [],
           "collective_calls": []}
    fa.reset_launch_counts()
    with recording_launches(keys if keys is not None else set()):
        for _ in range(MESH_STEPS):
            reset_stats()
            t0 = time.perf_counter()
            if cuda:
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
            state, metrics = step(state, batch)
            if cuda:
                end.record()
                torch.cuda.synchronize()
            out["loss"].append(float(metrics["loss"]))
            out["grad_norm"].append(float(metrics["grad_norm"]))
            out["step_event_ms"].append(
                start.elapsed_time(end) if cuda
                else (time.perf_counter() - t0) * 1e3)
            out["collective_host_ms"].append(stats["seconds"] * 1e3)
            out["collective_bytes"].append(stats["bytes"])
            out["collective_calls"].append(stats["calls"])
        out["launches_per_step"] = {n: c / MESH_STEPS for n, c in
                                    fa.launch_counts.items()
                                    if n != "flash_attn_fwd"}
        fa.reset_launch_counts()
        model.eval()
        local = local_rows(batch, mesh) if mesh is not None else batch
        with torch.no_grad():
            got = model(local["pixel_values"], local["input_ids"],
                        local["attention_mask"], **knowledge_of(local))
        out["launches_per_forward"] = fa.launch_counts["flash_attn_fwd"]
    if logits:
        got = got["logits"].float()
        out["logits"] = (all_gather(got, mesh.data) if mesh is not None
                         else got).cpu().numpy()
    out["attention_calls"] = attention_calls_per_forward(cfg)
    out["max_memory_allocated_gib"] = (
        torch.cuda.max_memory_allocated() / 2**30 if cuda else None)
    placements = state.sharding.placements if state.sharding else {}
    out["update"] = {
        n: (full_tensor(p.detach(), placements[n], mesh) if n in placements
            else p.detach()) - before[n]
        for n, p in model.named_parameters()}
    if statistics:
        whole = gathered_optimizer_state(state.optimizer, state.sharding,
                                         mesh)["state"]
        out["statistics"] = {f: {n: t for n, t in whole[f].items()
                                 if t.numel() > 1}
                             for f in ("v_row", "v_col")}
    del state, model, before
    return out


def statistics_compare(got: dict, ref: dict, rel: float | None) -> dict:
    """adafactor's factored statistics on a mesh against one process's:
    per field, the norm of the difference over all leaves relative to
    the norm of one process's, held to ``rel`` (None: reported only)."""
    out = {}
    for field, want in ref.items():
        diff = math.sqrt(sum(float((got[field][n].double() - w.double())
                                   .square().sum())
                             for n, w in want.items()))
        norm = math.sqrt(sum(float(w.double().square().sum())
                             for w in want.values()))
        out[field] = {"leaves": len(want),
                      "rel_diff": diff / norm if want else 0.0}
    out["tolerance"] = rel
    if rel is not None and not all(v["rel_diff"] <= rel
                                   for k, v in out.items()
                                   if k != "tolerance"):
        raise AssertionError(f"adafactor statistics on the mesh: {out}")
    return out


def mesh_compare(got: dict, ref: dict, loss_rel: float, norm_rel: float,
                 cosine_min: float) -> dict:
    """A mesh run against the one-process run: each step's loss and grad
    norm (relative), the cosine of the two updates over all weights."""
    rel = lambda a, b: max(abs(x - y) / abs(y) for x, y in zip(a, b))
    dot = n_got = n_ref = 0.0
    for n, u in ref["update"].items():
        g = got["update"][n].float()
        dot += float((g * u.float()).sum())
        n_got += float(g.square().sum())
        n_ref += float(u.float().square().sum())
    out = {"loss": got["loss"], "loss_one_process": ref["loss"],
           "grad_norm": got["grad_norm"],
           "grad_norm_one_process": ref["grad_norm"],
           "loss_rel_diff": rel(got["loss"], ref["loss"]),
           "grad_norm_rel_diff": rel(got["grad_norm"], ref["grad_norm"]),
           "update_cosine": dot / max(math.sqrt(n_got * n_ref), 1e-30),
           "tolerance": {"loss_rel": loss_rel, "grad_norm_rel": norm_rel,
                         "update_cosine_min": cosine_min}}
    if not (out["loss_rel_diff"] <= loss_rel
            and out["grad_norm_rel_diff"] <= norm_rel
            and out["update_cosine"] >= cosine_min):
        raise AssertionError(f"mesh step against one process: {out}")
    return out


def mesh_gen_inputs(cfg: GenerativeVQAConfig, batch: int) -> tuple:
    """bench_serving's requests at ``batch``, and a fixed answer of
    max_answer_length tokens for the teacher-forced logits."""
    px, q = bench_serving.synthetic_requests(cfg, batch)
    dec = np.random.RandomState(3).randint(
        3, cfg.vocab_size, (batch, cfg.max_answer_length))
    dec[:, 0] = 0
    return px, q, dec


def mesh_generate(cfg: GenerativeVQAConfig, mesh, seed: int,
                  device: str = "cuda", keys: set | None = None,
                  batch: int = MESH_GEN_BATCH) -> dict:
    """bench_serving's model (bf16) with its heads and MLPs split over
    the mesh's 'model' axis (None: one process): a greedy generate of 32
    tokens at MESH_GEN_BATCH (its launches), and the teacher-forced
    logits of a fixed answer."""
    from vivqa_tpu_torch.models.generative import GenerativeVQAModel
    from vivqa_tpu_torch.parallel.mesh import logical_to_mesh
    model = GenerativeVQAModel(cfg).to(device)
    init_weights(model, torch.Generator(device=device).manual_seed(seed))
    model.eval()
    if mesh is not None:
        logical_to_mesh(model, mesh)
    px, q, dec = (torch.from_numpy(np.asarray(a)).to(device)
                  for a in mesh_gen_inputs(cfg, batch))
    generate = build_generate_fn(model, bench_serving.decode_config(
        "greedy", cfg.max_answer_length))
    fa.reset_launch_counts()
    with recording_launches(keys if keys is not None else set()):
        seqs, _ = generate(px, q)
        launches = fa.launch_counts["flash_attn_fwd"]
        with torch.no_grad():
            logits = model(px, q, dec)["logits"]
    out = {"launches_per_generate": launches,
           "logits": logits.float().cpu().numpy(),
           "seqs": seqs.cpu().numpy()}
    del model
    return out


def mesh_knowledge_batch(data: dict, seed: int,
                         dim: int = MESH_KNOWLEDGE_DIM) -> dict:
    """``data`` with K = RAG_K retrieved contexts a row of width ``dim``,
    row b keeping K - (b mod (K + 1)) of them, as ``knowledge_key_mask``
    (so every count, a fully masked row too)."""
    n = len(data["labels"])
    rs = np.random.RandomState(seed + 13)
    keep = np.array([RAG_K - b % (RAG_K + 1) for b in range(n)])
    return dict(data, knowledge_embeddings=rs.standard_normal(
        (n, RAG_K, dim)).astype(np.float32),
        knowledge_mask=(np.arange(RAG_K)[None] < keep[:, None]).astype(
            np.int64))


def mesh_rank(rank: int, cfg: VQAModelConfig, gen_cfg: GenerativeVQAConfig,
              seed: int, device: str = "cuda", batch: int = MESH_BATCH,
              gen_batch: int = MESH_GEN_BATCH, cli: dict | None = None,
              study: list | None = None) -> dict:
    """One rank of the mesh phase (two ranks sharing cuda:0 over gloo).
    Rank 0 first runs the one-process references (and keeps only their
    updates, on the card); then both ranks run each mesh: the flagship,
    its f32 copy, the flagship with knowledge, and on (1, 2) the
    generative model and adafactor; then both CLIs with
    ``--use-knowledge`` on the YAML's (1, 2) mesh (``cli``: their YAMLs,
    from ``mesh_cli_configs``), and the ablation CLI on (2, 1) (``study``:
    its argv)."""
    import torch.distributed as dist
    from vivqa_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    torch.set_num_threads(4)
    resolve_device(device)
    # dropout 0 (the text encoder's embedding dropout reads its config)
    cfg = cfg.replace(text=cfg.text.replace(dropout=0.0),
                      fusion=cfg.fusion.replace(dropout=0.0),
                      head=cfg.head.replace(dropout=0.0))
    kcfg = with_knowledge(cfg, MESH_KNOWLEDGE_DIM)
    data = mesh_batch(cfg, seed, batch)
    kdata = mesh_knowledge_batch(data, seed)
    small = cfg.replace(
        visual=cfg.visual.replace(num_layers=MESH_SMALL_LAYERS),
        text=cfg.text.replace(num_layers=MESH_SMALL_LAYERS),
        fusion=cfg.fusion.replace(num_layers=MESH_SMALL_LAYERS))
    out, keys = {"rank": rank, "runs": {}}, set()
    # the one-process references, half on each rank (both share the
    # card); each rank holds the runs on the meshes to its own
    refs = {0: {"flagship": lambda: mesh_train(cfg, None, data, seed,
                                               device),
                "f32": lambda: mesh_train(small, None, data, seed, device,
                                          f32=True),
                "f32_adafactor": lambda: mesh_train(
                    small, None, data, seed, device, f32=True,
                    optimizer="adafactor", statistics=True),
                "generative": lambda: mesh_generate(gen_cfg, None, seed,
                                                    device,
                                                    batch=gen_batch)},
            1: {"knowledge": lambda: mesh_train(kcfg, None, kdata, seed,
                                                device, logits=True),
                "adafactor": lambda: mesh_train(cfg, None, data, seed,
                                                device,
                                                optimizer="adafactor",
                                                statistics=True)}}[rank]
    t0 = time.perf_counter()
    refs = {part: run() for part, run in refs.items()}
    out["reference_s"] = time.perf_counter() - t0
    dist.barrier()
    # (loss, grad norm, update cosine) limits of each part against one
    # process: train_check's for the bf16 flagship, 1e-4 for f32
    limits = {"flagship": (2e-2, 5e-2, 0.9), "knowledge": (2e-2, 5e-2, 0.9),
              "adafactor": (2e-2, 5e-2, 0.9),
              "f32": (1e-4, 1e-4, 1 - 1e-4),
              "f32_adafactor": (1e-4, 1e-4, 1 - 1e-4)}
    for shape in MESH_SHAPES:
        mesh = create_mesh(MeshConfig(*shape), device)
        out["backend"] = mesh.backend
        t1 = time.perf_counter()
        run = {"flagship": mesh_train(cfg, mesh, data, seed, device,
                                      keys=keys),
               "f32": mesh_train(small, mesh, data, seed, device, f32=True,
                                 keys=keys),
               "knowledge": mesh_train(kcfg, mesh, kdata, seed, device,
                                       keys=keys, logits=True)}
        if shape == (1, 2):
            run["generative"] = mesh_generate(gen_cfg, mesh, seed, device,
                                              keys, gen_batch)
            run["adafactor"] = mesh_train(cfg, mesh, data, seed, device,
                                          keys=keys, optimizer="adafactor",
                                          statistics=True)
            run["f32_adafactor"] = mesh_train(
                small, mesh, data, seed, device, f32=True, keys=keys,
                optimizer="adafactor", statistics=True)
        for part, ref in refs.items():
            if part not in run:
                continue
            got = run[part]
            if part == "generative":
                got["against_one_process"] = compare_logits(
                    got["logits"].reshape(-1, gen_cfg.vocab_size),
                    ref["logits"].reshape(-1, gen_cfg.vocab_size))
                got["reference_launches_per_generate"] = \
                    ref["launches_per_generate"]
                continue
            got["against_one_process"] = mesh_compare(got, ref,
                                                      *limits[part])
            if "logits" in ref:
                got["logits_against_one_process"] = compare_logits(
                    got["logits"], ref["logits"])
            if "statistics" in ref:
                # the f32 copy's are held to 1e-3; the bf16 flagship's
                # differ by its gradients' roundings and are reported
                got["statistics_against_one_process"] = statistics_compare(
                    got["statistics"], ref["statistics"],
                    1e-3 if part == "f32_adafactor" else None)
        for r in run.values():
            for k in ("update", "logits", "seqs", "statistics"):
                r.pop(k, None)
        run["seconds"] = time.perf_counter() - t1
        out["runs"][str(shape)] = run
        if device == "cuda":
            torch.cuda.empty_cache()
    del refs
    if cli is not None:
        t1 = time.perf_counter()
        with recording_launches(keys):
            out["cli"] = mesh_cli_rank(cli, device)
        out["cli"]["seconds"] = time.perf_counter() - t1
    if study is not None:
        t1 = time.perf_counter()
        with recording_launches(keys):
            out["ablation"] = mesh_ablation_rank(study)
        out["ablation"]["seconds"] = time.perf_counter() - t1
    out["launch_keys"] = sorted(keys, key=str)
    return out


def mesh_cli_configs(tmp: str, cls_cfg: VQAModelConfig,
                     gen_cfg: GenerativeVQAConfig, device: str = "cuda",
                     n: int = MESH_CLI_CORPUS, image_size: int = 224,
                     batch: int = MESH_BATCH, seed: int = 0) -> dict:
    """Both CLIs' corpora of ``n`` learnable images and YAML configs with
    ``mesh`` (1, 2), one epoch at ``batch`` (2 steps of the 64 training
    samples), for ``--use-knowledge`` (``rag_cli_phase``'s recipes; the
    generative one with ``--kb-path``): {cls, gen, kb: their paths}."""
    from vivqa_tpu_torch.data import ensure_synthetic_vivqa
    from vivqa_tpu_torch.parallel.mesh import MeshConfig
    from vivqa_tpu_torch.pipelines import generative_vqa_pipeline as gvp
    mesh = MeshConfig(1, 2)
    Path(tmp).mkdir(parents=True, exist_ok=True)
    kb = Path(tmp) / "kb.json"
    kb.write_text(json.dumps([{"content": d.content, "category": d.category}
                              for d in rag_documents()], ensure_ascii=False))
    csv, imgs = generate_synthetic_vivqa(f"{tmp}/cls", n=n,
                                         image_size=image_size,
                                         learnable=True, seed=seed)
    VQAPipelineConfig(
        data=DataPipelineConfig(
            csv_path=str(csv), image_dir=str(imgs), image_size=image_size,
            max_question_length=cls_cfg.text.max_length, batch_size=batch,
            augmentation_strength="medium", seed=seed),
        model=ModelPipelineConfig(
            model=cls_cfg.replace(knowledge=cls_cfg.knowledge.replace(
                num_retrieved=RAG_K)), device=device, seed=seed, mesh=mesh),
        training=TrainingPipelineConfig(
            num_epochs=1, checkpoint_dir=f"{tmp}/ck_cls", log_every=4,
            seed=seed),
        output_dir=f"{tmp}/out_cls", seed=seed).to_yaml(f"{tmp}/cls.yaml")
    gcsv, gimgs = ensure_synthetic_vivqa(f"{tmp}/gen", n=n,
                                         image_size=image_size,
                                         learnable=True, seq_answers=True)
    gvp.GenerativeVQAPipelineConfig(
        data=DataPipelineConfig(
            csv_path=str(gcsv), image_dir=str(gimgs), image_size=image_size,
            max_question_length=gen_cfg.text.max_length,
            max_answer_length=gen_cfg.max_answer_length, batch_size=batch,
            augmentation_strength="medium", generative=True, seed=seed),
        model=gen_cfg.replace(dropout=GEN_DROPOUT, label_smoothing=0.0,
                              knowledge=gen_cfg.knowledge.replace(
                                  num_retrieved=RAG_K)),
        training=GenerativeTrainingConfig(
            num_epochs=1, label_smoothing=0.0,
            checkpoint_dir=f"{tmp}/ck_gen",
            optimizer=OptimizerConfig(learning_rate=1e-3, weight_decay=0.01),
            log_every=1, seed=seed),
        knowledge=KnowledgeProviderConfig(retriever="sparse"),
        device=device, output_dir=f"{tmp}/out_gen", seed=seed,
        mesh=mesh).to_yaml(f"{tmp}/gen.yaml")
    return {"cls": f"{tmp}/cls.yaml", "gen": f"{tmp}/gen.yaml",
            "kb": str(kb), "cls_model": cls_cfg, "gen_model": gen_cfg}


def mesh_cli_rank(cli: dict, device: str = "cuda") -> dict:
    """This rank's part of both CLIs' train runs with ``--use-knowledge``
    on the YAML's (1, 2) mesh, each with the launch counts set to 0 just
    before it and read just after and held to the counts of
    ``rag_cli_phase``: 37 of each training kernel a classification step
    and 37 forward calls a forward (ModelPipeline's dummy forward, the
    validations), 39 a generative step, 27 a generate and 12 a decode
    step."""
    from vivqa_tpu_torch.pipelines import generative_vqa_pipeline as gvp
    from vivqa_tpu_torch.pipelines import vqa_pipeline as vp
    on_card = device == "cuda"
    runs, summaries = {}, {}
    for name, fn in (
            ("cls", lambda: vp.main(["--config", cli["cls"],
                                     "--use-knowledge", "--mode", "train"])),
            ("gen", lambda: gvp.main(["--config", cli["gen"],
                                      "--use-knowledge", "--kb-path",
                                      cli["kb"], "--mode", "train"]))):
        counts = {"generates": 0, "decode_steps": 0}
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        with counting_decode(counts):
            summaries[name] = fn()
        if on_card:
            torch.cuda.synchronize()
        runs[name] = {"seconds": time.perf_counter() - t0,
                      "launches": launch_snapshot(), **counts}
    cls_cfg, gen_cfg = cli["cls_model"], cli["gen_model"]
    vcfg = VQAPipelineConfig.from_yaml(cli["cls"])
    data = DataPipeline(vcfg.data).run()
    steps, val_batches = len(data.train_loader), len(data.val_loader)
    gcfg = gvp.GenerativeVQAPipelineConfig.from_yaml(cli["gen"])
    gen_steps = len(DataPipeline(gcfg.data).run().train_loader)
    per_fwd = (attention_calls_per_forward(cls_cfg) + 1) if on_card else 0
    zero = {n: 0 for n in TRAIN_KERNELS}
    r = runs["gen"]
    want = {"cls": {**{n: per_fwd * steps for n in TRAIN_KERNELS},
                    "flash_attn_fwd": per_fwd * (1 + 2 * val_batches)},
            "gen": {**{n: gen_calls_per_step(gen_cfg) * gen_steps
                       if on_card else 0 for n in TRAIN_KERNELS},
                    "flash_attn_fwd": attention_calls_per_generate(
                        gen_cfg, 0) * r["generates"]
                    + 2 * gen_cfg.decoder_layers * r["decode_steps"]
                    if on_card else 0}}
    problems = [f"{n} launches {runs[n]['launches']} != {w}"
                for n, w in want.items() if runs[n]["launches"] != w]
    history = summaries["cls"]["history"] + summaries["gen"]["history"]
    if len(history) != 2 or not all(math.isfinite(h["train_loss"])
                                    for h in history) \
            or steps != MESH_CLI_STEPS or gen_steps != MESH_CLI_STEPS:
        problems.append(f"history {history}, steps {steps} / {gen_steps}")
    if problems:
        raise AssertionError("mesh CLIs with knowledge: "
                             + "; ".join(problems))
    return {"steps": {"cls": steps, "gen": gen_steps},
            "run_seconds": {n: r["seconds"] for n, r in runs.items()},
            "launches": {n: r["launches"] for n, r in runs.items()},
            "launches_per_step": {
                n: {k: runs[n]["launches"][k] / s for k in TRAIN_KERNELS}
                for n, s in (("cls", steps), ("gen", gen_steps))},
            "history": history}


def mesh_ablation_rank(study: list) -> dict:
    """This rank's part of the ablation CLI on two ranks: the study
    (``run_ablation.main`` with ``study``'s argv, whose mesh is (2, 1):
    every rank on 'data'), each experiment with the launch counts set to
    0 just before it and read just after, and every file the rank
    writes; then the same command again (it must train nothing)."""
    from vivqa_tpu_torch.ablation import run_ablation as RA
    records, writes = [], []
    with recording_experiments(records), recording_writes(writes):
        results = RA.main(study)
    again = []
    with recording_experiments(again):
        resumed = RA.main(study)
    return {"results": {r.experiment_id: {
                "status": r.status, "error": r.error[-400:],
                "exact_match": r.metrics.get("exact_match"),
                "n_eval": len(r.correct_mask or [])}
                for r in results},
            "experiments": {rec["id"]: {
                "seconds": rec["seconds"], "launches": rec["launches"],
                "train_steps": rec["train_steps"],
                "val_batches": rec["val_batches"]} for rec in records},
            "writes": writes,
            "resumed": sorted(r.experiment_id for r in resumed),
            "resume_ran": [rec["id"] for rec in again]}


@contextlib.contextmanager
def recording_writes(writes: list):
    """Each file written inside (``Path.write_text``, ``open`` for
    writing, ``torch.save``) appended to ``writes``."""
    import builtins
    write_text, open_, save = Path.write_text, builtins.open, torch.save

    def patched_write_text(self, *args, **kwargs):
        writes.append(str(self))
        return write_text(self, *args, **kwargs)

    def patched_open(file, mode="r", *args, **kwargs):
        if any(c in mode for c in "wax"):
            writes.append(str(file))
        return open_(file, mode, *args, **kwargs)

    def patched_save(obj, f, *args, **kwargs):
        writes.append(str(f))
        return save(obj, f, *args, **kwargs)
    Path.write_text, builtins.open, torch.save = (
        patched_write_text, patched_open, patched_save)
    try:
        yield writes
    finally:
        Path.write_text, builtins.open, torch.save = write_text, open_, save


def mesh_study(tmp: str, device: str = "cuda", n: int = ABL_CORPUS,
               scale: tuple = (), seed: int = 0) -> list:
    """The ablation CLI's argv for the mesh: the ablation phase's study
    (its YAML, corpus, round-3 model and flags) cut to MESH_ABL_ROWS,
    everything under ``tmp`` (the output in ``tmp``/out)."""
    from vivqa_tpu_torch.ablation import run_ablation as RA
    image_size = RA.build_argparser().parse_args(
        [*ABL_SCALE, *scale]).image_size
    csv, imgs = generate_synthetic_vivqa(f"{tmp}/data", n=n,
                                         image_size=image_size,
                                         learnable=True, seed=seed)
    argv = ["--config", abl_study_config(tmp, f"{tmp}/out"),
            "--csv-path", str(csv), "--image-dir", str(imgs),
            "--epochs", str(ABL_EPOCHS), "--batch-size", str(ABL_BATCH),
            "--device", device, *ABL_SCALE, *scale, *ABL_STUDY]
    study = RA.AblationConfig.from_yaml(argv[1])
    matrix = [e.experiment_id for e in study.generate_experiment_matrix()]
    return argv + ["--experiments",
                   ",".join(str(matrix.index(e)) for e in MESH_ABL_ROWS)]


def mesh_ablation_check(ranks: list, reference: dict, calls: int,
                        out_dir: str) -> dict:
    """The two ranks' study against one process's (``reference``: {id:
    {exact_match, seconds}}): every row completes on both ranks with the
    same exact match, within 0.05 of one process's; each result file is
    written once, by rank 0, and parses; the second run trained nothing;
    each rank launches each training kernel ``calls`` times a step and
    the forward ``calls`` times a validation forward (as
    ``ablation_phase`` counts them)."""
    problems, rows = [], {}
    for eid in MESH_ABL_ROWS:
        got = [r["ablation"]["results"].get(eid, {}) for r in ranks]
        em = [g.get("exact_match") for g in got]
        ref = reference[eid]["exact_match"]
        if any(g.get("status") != "completed" for g in got) \
                or em[0] != em[1] or em[0] is None \
                or abs(em[0] - ref) > 0.05:
            problems.append(f"{eid}: {got} against one process's {ref}")
        recs = [r["ablation"]["experiments"].get(eid) for r in ranks]
        for rank, rec in enumerate(recs):
            if rec is None:
                problems.append(f"{eid}: rank {rank} ran no experiment")
                continue
            S, V = rec["train_steps"], rec["val_batches"]
            if eid.startswith("ph_"):
                want = {**{k: 0 for k in TRAIN_KERNELS},
                        "flash_attn_fwd": calls * (V + 1)}
            else:
                want = {**{k: calls * S * ABL_EPOCHS for k in TRAIN_KERNELS},
                        "flash_attn_fwd": calls * (V * (ABL_EPOCHS + 2) + 1)}
            if rec["launches"] != want:
                problems.append(f"{eid} rank {rank} launches "
                                f"{rec['launches']} != {want}")
        result = Path(out_dir) / "results" / f"{eid}.json"
        written = [sum(w == str(result) for w in r["ablation"]["writes"])
                   for r in ranks]
        try:
            json.loads(result.read_text())
        except (OSError, ValueError) as e:
            problems.append(f"{result}: {e}")
        if written != [1, 0]:
            problems.append(f"{eid}: result written {written} times by "
                            f"ranks 0, 1")
        rows[eid] = {"exact_match": em[0], "one_process_exact_match": ref,
                     "seconds_two_ranks": [rec["seconds"] if rec else None
                                           for rec in recs],
                     "seconds_one_process": reference[eid]["seconds"],
                     "launches": recs[0]["launches"] if recs[0] else None,
                     "launches_per_step": {
                         k: recs[0]["launches"][k]
                         / (recs[0]["train_steps"] * ABL_EPOCHS)
                         for k in TRAIN_KERNELS} if recs[0] else None,
                     "writes_by_rank": written}
    for r in ranks:
        if r["ablation"]["resume_ran"] or \
                r["ablation"]["resumed"] != sorted(MESH_ABL_ROWS):
            problems.append(f"rank {r['rank']} resume: ran "
                            f"{r['ablation']['resume_ran']}, results "
                            f"{r['ablation']['resumed']}")
        if r["rank"] == 1 and any(w.startswith(out_dir)
                                  for w in r["ablation"]["writes"]):
            problems.append(f"rank 1 wrote {r['ablation']['writes'][:5]}")
    if problems:
        raise AssertionError("mesh ablation: " + "; ".join(problems))
    return rows


def mesh_study_reference(study: list, device: str = "cuda") -> dict:
    """The mesh study's rows on one process (the ``--phase mesh`` run's
    reference; the whole run takes the ablation phase's)."""
    from vivqa_tpu_torch.ablation import run_ablation as RA
    records = []
    with recording_experiments(records):
        results = RA.main(study)
    seconds = {rec["id"]: rec["seconds"] for rec in records}
    return {r.experiment_id: {"exact_match": r.metrics.get("exact_match"),
                              "seconds": seconds[r.experiment_id]}
            for r in results}


def mesh_phase(device: str = "cuda", seed: int = 0,
               cfg: VQAModelConfig | None = None,
               gen_cfg: GenerativeVQAConfig | None = None,
               batch: int = MESH_BATCH,
               gen_batch: int = MESH_GEN_BATCH, abl: dict | None = None,
               cli_n: int = MESH_CLI_CORPUS, cli_image_size: int = 224,
               abl_n: int = ABL_CORPUS, abl_scale: tuple = ()) -> dict:
    """Two ranks on the one card over a gloo group (NCCL refuses two ranks
    on one device): the flagship at full width (bf16, dropout 0) on the
    (2, 1) and (1, 2) meshes, MESH_STEPS steps each of a global batch of
    MESH_BATCH, from the same seeded weights as one process's steps
    (each rank runs half of them), held to train_check's tolerances; a copy of MESH_SMALL_LAYERS
    layers in f32 held to 1e-4; the flagship with knowledge (K = RAG_K)
    on both meshes, held the same way, its evaluation logits by
    ``compare_logits``; adafactor on (1, 2), on the flagship (held as the
    flagship; its factored statistics against one process's reported)
    and on the f32 copy (held as the copy; its factored statistics
    within 1e-3 of one process's); bench_serving's generative model on
    (1, 2): a greedy generate of 32 tokens at MESH_GEN_BATCH (411
    launches on each rank) and its teacher-forced logits against one
    process (``compare_logits``). The attention kernels launch 36 times a
    step and 36 a forward on every rank (37 with knowledge). Then both
    CLIs with ``--use-knowledge`` on the YAML's (1, 2) mesh, two steps
    each, and the ablation CLI on two ranks (MESH_ABL_ROWS of the
    ablation phase's study, 42 launches a step), each row's exact match
    within 0.05 of one process's (``abl``: the ablation phase's result;
    without it one process runs them here first). The kernels were built
    by this process; the ranks load them. Returns the ranks' reports and
    ``launch_keys`` for path_check."""
    from vivqa_tpu_torch.parallel.launch import run_ranks
    t0 = time.perf_counter()
    cfg = cfg or flagship_config()
    gen_cfg = gen_cfg or bench_serving.serving_config()
    cuda = device == "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        cli = mesh_cli_configs(f"{tmp}/cli", cfg, gen_cfg, device, cli_n,
                               cli_image_size, batch, seed)
        study = mesh_study(f"{tmp}/abl", device, abl_n, abl_scale, seed)
        if abl is not None:
            reference = {eid: abl["experiments"][eid]
                         for eid in MESH_ABL_ROWS}
        else:
            reference = mesh_study_reference(mesh_study(
                f"{tmp}/abl_one", device, abl_n, abl_scale, seed), device)
        t_ranks = time.perf_counter()
        ranks = run_ranks(mesh_rank, 2, cfg, gen_cfg, seed, device, batch,
                          gen_batch, cli, study, timeout=900)
        ranks_s = time.perf_counter() - t_ranks
        abl_calls = attention_calls_per_forward(abl_model_config(abl_scale)) \
            if cuda else 0
        abl_rows = mesh_ablation_check(ranks, reference, abl_calls,
                                       f"{tmp}/abl/out")
    # each rank held the runs against its own references: both get all
    held = ("against_one_process", "logits_against_one_process",
            "statistics_against_one_process",
            "reference_launches_per_generate")
    for shape, run in ranks[0]["runs"].items():
        for part in run:
            if part == "seconds":
                continue
            got = {k: v for r in ranks
                   for k, v in r["runs"][shape][part].items() if k in held}
            for r in ranks:
                r["runs"][shape][part].update(got)
    per_generate = attention_calls_per_generate(
        gen_cfg, gen_cfg.max_answer_length) if cuda else 0
    keys = {tuple(tuple(x) if isinstance(x, list) else x for x in k)
            for r in ranks for k in r["launch_keys"]}
    for r in ranks:
        print(f"[mesh] rank {r['rank']}: references {r['reference_s']:.1f} s, "
              + ", ".join(f"{s} {run['seconds']:.1f} s"
                          for s, run in r["runs"].items())
              + f", CLIs {r['cli']['seconds']:.1f} s, ablation "
                f"{r['ablation']['seconds']:.1f} s", flush=True)
    for r in ranks:
        for shape, run in r["runs"].items():
            for part, got in run.items():
                if part in ("generative", "seconds"):
                    continue
                calls = got["attention_calls"] * cuda
                backward = F32_BACKWARD if part.startswith("f32") \
                    else ("flash_attn_bwd",)
                want = {n: calls if n in ("flash_attn_fwd_lse",) + backward
                        else 0 for n in got["launches_per_step"]}
                if got["launches_per_forward"] != calls or \
                        got["launches_per_step"] != want:
                    raise AssertionError(
                        f"mesh {shape} rank {r['rank']} {part}: launches "
                        f"{got['launches_per_step']} a step, "
                        f"{got['launches_per_forward']} a forward")
            g = run.get("generative")
            if g is not None and g["launches_per_generate"] != per_generate:
                raise AssertionError(f"mesh {shape} rank {r['rank']}: "
                                     f"{g['launches_per_generate']} "
                                     f"launches a generate")
    for r in ranks:
        r.pop("launch_keys")
        r["ablation"].pop("writes")
    return {"ranks": ranks, "launch_keys": keys, "ablation": abl_rows,
            "seconds": time.perf_counter() - t0, "ranks_seconds": ranks_s,
            "global_batch": batch, "steps": MESH_STEPS,
            "note": "two ranks share one card over gloo: the step times "
                    "are not multi-card figures"}


# -- phase 16: the step-budget tools ------------------------------------------
TOOLS_STEPS = 10            # each mode's and tower's timed window
TOOLS_BATCH = 64            # profile_components' default batch
TOWERS_BATCH = 128          # profile_towers' default batch
INPUT_IMAGES = 256          # bench_input_pipeline's default corpus
INPUT_SIZE = 224            # and its image size


def tools_phase() -> dict:
    """The port's step-budget tools (``vivqa_tpu_torch/tools/``) as a user
    runs them, at the flagship's full width and depth: ``profile_components``
    in its five modes at TOOLS_BATCH (each mode's wall ms by CUDA events,
    its busy ms by the profiler over a second, profiled window, its
    launches a call: 36 of each training kernel a full step and a forward
    and backward, 36 forward launches an eval forward, 36 attention calls
    a training forward, none an optimizer update), ``profile_towers`` for
    its five towers at TOWERS_BATCH and the JAX tool's sizes (12 launches
    a call of each training kernel for the visual, text and trunk towers
    and the fusion's MCAN, none for the table), and
    ``bench_input_pipeline`` over INPUT_IMAGES JPEGs (images/s, PIL and
    the native loader, NaN where its library is absent). Fails if a
    launch count is off, or a busy time is missing or exceeds its
    window."""
    from vivqa_tpu_torch.tools import (bench_input_pipeline,
                                       profile_components, profile_towers)
    dev = torch.device("cuda")
    cfg = flagship_config()
    sizes = profile_towers.TowerSizes()
    batch, steps = TOOLS_BATCH, TOOLS_STEPS
    t0 = time.perf_counter()
    comp = profile_components.profile(cfg, batch, steps, dev)
    comp_s = time.perf_counter() - t0
    zero = {n: 0.0 for n in fa.launch_counts}

    def training(c):
        return {**zero, **{n: float(c) for n in TRAIN_KERNELS}}

    def forward_only(launches, c):
        """A training forward with no gradient: each call on the forward
        kernel (no dropout) or the forward with stats, none backward."""
        return (launches["flash_attn_fwd"] + launches["flash_attn_fwd_lse"]
                == c and not any(launches[n] for n in launches
                                 if n.startswith("flash_attn_bwd")))
    calls = attention_calls_per_forward(cfg)
    want = {"full": training(calls), "fwd_bwd": training(calls),
            "fwd_eval": {**zero, "flash_attn_fwd": float(calls)},
            "opt": zero}
    modes = comp["modes"]
    problems = [f"{m} launches {modes[m]['launches_per_call']} != {w}"
                for m, w in want.items()
                if modes[m]["launches_per_call"] != w]
    if not forward_only(modes["fwd"]["launches_per_call"], calls):
        problems.append(f"fwd launches {modes['fwd']['launches_per_call']}")
    tower_calls = {"visual": sizes.layers, "text": sizes.layers, "embed": 0,
                   "trunk": sizes.layers, "fusion": 3 * sizes.fusion_layers}
    towers = {}
    t1 = time.perf_counter()
    for name in profile_towers.TOWERS:
        r = profile_towers.profile_tower(name, TOWERS_BATCH, steps, dev,
                                         sizes=sizes)
        c = tower_calls[name]
        if r["fwd_bwd"]["launches_per_call"] != training(c) \
                or not forward_only(r["forward"]["launches_per_call"], c):
            problems.append(f"tower {name} launches: forward "
                            f"{r['forward']['launches_per_call']}, forward "
                            f"and backward {r['fwd_bwd']['launches_per_call']}"
                            f" (want {c} a call)")
        towers[name] = r
    towers_s = time.perf_counter() - t1
    t2 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        paths = bench_input_pipeline.make_corpus(Path(tmp), INPUT_IMAGES)
        loader = bench_input_pipeline.bench(paths, INPUT_SIZE, batch, dev)
    loader_s = time.perf_counter() - t2
    timed_runs = [(f"{m}", r) for m, r in modes.items()] + [
        (f"{t} {p}", r[p]) for t, r in towers.items()
        for p in ("forward", "fwd_bwd")]
    for label, r in timed_runs:
        # one stream: the kernels' summed time cannot exceed their window
        if not (math.isfinite(r["wall_ms"]) and r["wall_ms"] > 0) \
                or r["busy_ms"] is None \
                or not 0 < r["busy_ms"] <= r["profiled_window_ms"]:
            problems.append(f"{label}: wall {r['wall_ms']} busy "
                            f"{r['busy_ms']} over a window of "
                            f"{r['profiled_window_ms']} ms")
    for mode, r in loader.items():
        nat = r["native_images_per_s"]
        if not r["pil_images_per_s"] > 0 or not (math.isnan(nat) or nat > 0):
            problems.append(f"input pipeline {mode}: {r}")
    if problems:
        raise AssertionError("tools phase: " + "; ".join(problems))
    return {"profile_components": {"batch": batch, "steps": steps, **comp,
                                   "seconds": comp_s},
            "profile_towers": {"batch": TOWERS_BATCH, "steps": steps,
                               "towers": towers, "seconds": towers_s},
            "bench_input_pipeline": {
                "n": INPUT_IMAGES, "size": INPUT_SIZE, "batch": batch,
                "native_available": fastloader.is_available(),
                "modes": {m: {k: None if math.isnan(v) else v
                              for k, v in r.items()}
                          for m, r in loader.items()},
                "seconds": loader_s}}


# -- phase 17: the walkthroughs and the setup script --------------------------
EXAMPLES = ("complete_vqa_pipeline", "vivqa_examples", "fusion_examples",
            "generative_decoding_examples", "image_representation_examples",
            "text_representation_examples", "knowledge_base_examples",
            "moe_examples", "resource_management_examples",
            "ablation_study_examples")


def recorded_run(log: str, module: str, args: list) -> int:
    """``python -m module args`` in this process, every kernel launch
    recorded; the launch keys go to ``log`` as JSON lines, also when the
    module exits or raises (``chip_smoke.py --recorded LOG -m MODULE
    ...``: the examples phase reads a subprocess's launches this way)."""
    import runpy
    keys: set = set()
    sys.argv = [module, *args]
    try:
        with recording_launches(keys):
            runpy.run_module(module, run_name="__main__", alter_sys=True)
    except SystemExit as e:
        return e.code if isinstance(e.code, int) else int(e.code is not None)
    finally:
        with open(log, "a") as f:
            for k in keys:
                f.write(json.dumps(k) + "\n")
    return 0


def start_setup(tmp: str, log: str):
    """``vivqa_tpu_torch/cli/setup_pipeline.sh --synthetic --skip-eval`` at
    its own sizes on the card, started in ``tmp``: its ``python -m`` runs
    go through ``recorded_run`` (a ``python`` on the PATH that hands them
    to this script), so their launches reach ``log``. Returns (the
    process, its output file)."""
    here = Path(__file__).resolve()
    bin_dir = Path(tmp) / "bin"
    bin_dir.mkdir()
    wrapper = bin_dir / "python"
    wrapper.write_text(
        "#!/bin/sh\n"
        f'if [ "$1" = "-m" ]; then exec "{sys.executable}" "{here}" '
        f'--recorded "{log}" "$@"; fi\n'
        f'exec "{sys.executable}" "$@"\n')
    wrapper.chmod(0o755)
    out = open(Path(tmp) / "setup.log", "w")
    env = {**os.environ, "PATH": f"{bin_dir}:{os.environ.get('PATH', '')}"}
    proc = subprocess.Popen(
        ["bash", str(here.parent / "vivqa_tpu_torch" / "cli" /
                     "setup_pipeline.sh"), "--synthetic", "--skip-eval",
         "--device", "cuda"], cwd=tmp, env=env, stdout=out,
        stderr=subprocess.STDOUT, start_new_session=True)
    return proc, out


def examples_phase() -> dict:
    """The ten walkthroughs of ``vivqa_tpu_torch/examples/`` as ``python3
    -m vivqa_tpu_torch.examples.<name>`` runs them on the card, in
    this process (each one's launches counted from 0), each printing every
    section title of its JAX file (``examples/<name>.py``, read by
    ``banner_titles``); meanwhile ``setup_pipeline.sh --synthetic
    --skip-eval`` in a subprocess (``start_setup``), which must pass its
    four stages. Returns each walkthrough's seconds, sections and
    launches, the setup's seconds and stages, and ``setup_launch_keys``
    (its launches' keys, for path_check)."""
    import importlib
    import io
    from vivqa_tpu_torch.examples import banner_titles
    root = Path(__file__).resolve().parent
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        log = f"{tmp}/setup_launches.jsonl"
        t_setup = time.perf_counter()
        proc, setup_out = start_setup(tmp, log)
        try:
            for name in EXAMPLES:
                mod = importlib.import_module(
                    f"vivqa_tpu_torch.examples.{name}")
                buf = io.StringIO()
                fa.reset_launch_counts()
                t = time.perf_counter()
                try:
                    with contextlib.redirect_stdout(buf):
                        mod.main([])
                except Exception as e:
                    raise AssertionError(
                        f"walkthrough {name}: {e!r}; its output's end:\n"
                        f"{buf.getvalue()[-3000:]}") from e
                torch.cuda.synchronize()
                text = buf.getvalue()
                titles = banner_titles(root / "examples" / f"{name}.py")
                missing = [s for s in titles if s not in text]
                out[name] = {"seconds": time.perf_counter() - t,
                             "sections": len(titles),
                             "launches": launch_snapshot(),
                             "printed_lines": text.count("\n")}
                if missing or not titles:
                    raise AssertionError(f"walkthrough {name}: sections "
                                         f"{missing} not printed")
            rc = proc.wait(timeout=600)
            setup_out.close()
            text = (Path(tmp) / "setup.log").read_text()
            stages = [f"Stage {i}/5" for i in range(1, 6)
                      if f"Stage {i}/5" in text]
            if rc != 0 or len(stages) != 5 \
                    or "smoke train run OK" not in text:
                raise AssertionError(f"setup_pipeline.sh rc {rc}:\n"
                                     f"{text[-4000:]}")
            keys = set()
            if Path(log).is_file():
                keys = {tuple(tuple(x) if isinstance(x, list) else x
                              for x in json.loads(line))
                        for line in Path(log).read_text().splitlines()}
            setup_res = {"seconds": time.perf_counter() - t_setup,
                         "stages": stages, "launch_keys": len(keys),
                         "setup_launch_keys": keys}
        finally:
            if proc.poll() is None:
                # the script and the python it runs
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    return {"walkthroughs": out, "setup": setup_res}


# -- phase 18: every launch shape of the main paths held ---------------------
def path_check_phase(launched: dict) -> dict:
    """``launched``: {path: the launch keys its run recorded}. Each key no
    kernel check held yet is held now against the plain version on inputs
    of that key (normal q, k, v and dO; a mask of the key's stored shape,
    each element kept with probability 0.8; the key's dropout rate): the
    forward to ATTN_TOL, a training kernel's key by
    the training kernels' forward and backward (``check_train_kernels``).
    Fails if a path launched a key that stays unchecked."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    every = set().union(*launched.values())
    held_before = every & CHECKED
    rows = []
    for key in sorted(every - CHECKED, key=str):
        if key in CHECKED:      # held with the training kernels of its call
            continue
        name, dtype, (B, H, Lq, D), Lk, mask_shape, causal, rate = key
        dt = getattr(torch, dtype)
        q, k, v, do = (torch.randn(B, H, L, D, generator=gen,
                                   device="cuda").to(dt)
                       for L in (Lq, Lk, Lk, Lq))
        mask = None if mask_shape is None else torch.rand(
            mask_shape, generator=gen, device="cuda") < 0.8
        if name == "flash_attn_fwd":
            with recording_launches(CHECKED):
                out = fa.flash_attention_cuda(q, k, v, mask, causal)
            ref = fa.attention_reference(q, k, v, mask, causal)
            torch.cuda.synchronize()
            errs = {"o": float((out.float() - ref.float()).abs().max())}
            if not math.isfinite(errs["o"]) or errs["o"] > ATTN_TOL[dt]:
                raise AssertionError(f"path launch {key}: kernel vs plain "
                                     f"max |err| {errs['o']} > "
                                     f"{ATTN_TOL[dt]}")
        else:
            errs = check_train_kernels(q, k, v, do, mask, causal, rate,
                                       fa.dropout_key(2028, len(rows)))
        rows.append({"key": key, "max_err": errs})
    unchecked = every - CHECKED
    if unchecked:
        raise AssertionError(f"launches of the main paths no check held: "
                             f"{sorted(unchecked, key=str)}")
    return {"launch_keys": {p: len(keys) for p, keys in launched.items()},
            "held_by_kernel_phases": len(held_before),
            "held_here": rows,
            "key": ["kernel", "dtype", "q shape", "Lk", "mask shape",
                    "causal", "dropout"]}


def kernels_line(rows: dict, launches: int, generative: dict,
                 train_rows: dict, train_launches: dict,
                 ptxas: dict, gen_rows: dict, gen_training: dict,
                 cls_pipeline: dict, gen_cli: dict, abl_totals: dict,
                 ablation: dict, rag_tot: dict, rag: dict,
                 trainer: dict, zoo_kernels: dict, zoo: dict,
                 hf_rows: dict, hf: dict, mesh_rows: dict, mesh_tot: dict,
                 mesh: dict, tools: dict, examples: dict) -> dict:
    """One entry per kernel. The forward's numbers are for one flagship
    forward at batch 8 (its 36 calls of the five serving shapes, each
    shape's time times its calls), and, under ``generate``, for one beam
    generate at batch 16 (its 411 calls); the training kernels' for one
    flagship train step at batch 128 (36 calls each, at the dropout each
    call uses), and, under ``generative_step``, for one generative train
    step at batch 32 (39 calls each). ``ms`` is CUDA-graph replay
    (``library_ms`` SDPA's, the same way);
    registers and spills are ptxas' for the
    template the main path runs. ``cls_pipeline`` holds each kernel's
    launches in the classification CLI pipeline's runs (train, evaluate,
    inference), per train step and per validation forward; ``gen_cli``
    each kernel's launches in the generative CLI's runs (train, evaluate,
    inference, vivqa_evaluation, the fitted bench); ``ablation`` each
    kernel's launches in the ablation CLI's experiments and its times, at
    the study's shapes, over one validation forward (the forward) or one
    training step (the training kernels) of the full model at batch
    32; ``rag`` each kernel's on the knowledge path: per classification
    forward at batch 8 and per beam generate at batch 16 (the forward),
    per classification step at batch 128 and generative step at batch 32
    (the training kernels), with the knowledge, and its launches in the
    rag phase's runs; ``trainer`` each kernel's launches in the trainer
    phase's runs (the gradual_unfreeze trainer, the checkpointed trainer,
    the generative CLI with ``--freeze-visual``) with the step's time by
    CUDA events, and the kernel phase's time, bound and SDPA's time over
    a trainer step at batch 32 (the training kernels) or a validation
    forward at batch 32 (the forward); ``zoo`` each kernel's at the
    zoo's new shapes (time, bound, SDPA's time), its totals and launches
    per forward or step of each zoo path, and its launches in the zoo's
    runs; ``hf_import`` each kernel's with the pretrained towers: the
    forward at their new shapes (time, plain version, bound, SDPA's time)
    with its launches a forward, a greedy generate and a tower's forward,
    and each kernel's launches in both CLIs' runs; ``mesh`` each kernel's
    on the ('data', 'model') mesh (two ranks on the card): per call at the
    (1, 2) mesh's per-rank shapes (half the heads) and per rank's step or
    evaluation forward there (time, plain version, bound, SDPA's time),
    and its launches per rank a step and a forward on each mesh; ``tools``
    each kernel's launches a call in profile_components' five modes at
    batch 64 and profile_towers' towers at batch 128 (forward, forward and
    backward); ``examples`` its launches in each walkthrough's run."""
    abl_launches = {name: sum(r.get(name, 0)
                              for r in ablation["launches"].values())
                    for name in fa.launch_counts}
    rag_cli = rag["cli"]["launches"]
    abl_per = (f"the ablation CLI's {len(ablation['experiments'])} "
               f"experiments ({ablation['epochs']} epoch of "
               f"{ablation['steps_per_epoch']} steps at batch "
               f"{ablation['batch']}); times per ")
    cli_launches = gen_cli["launches"]
    cli_per = (f"GenerativeVQAPipeline train ({gen_cli['steps_per_epoch']} "
               f"steps at batch {gen_cli['batch']}), evaluate (beam 4), "
               f"inference, vivqa_evaluation and fitted-bench runs")
    entries = [forward_entry(rows, launches, ptxas["flash_attn_fwd"])]
    entries[0]["generate"] = generate_entry(rows, generative)
    cls_launches = cls_pipeline["launches"]
    entries[0]["cls_pipeline"] = {
        "launches": {m: cls_launches[m]["flash_attn_fwd"]
                     for m in cls_launches},
        "launches_per_validation_forward":
            cls_pipeline["launches_per_validation_forward"],
        "per": f"VQAPipeline train ({cls_pipeline['epochs']} epochs of "
               f"{cls_pipeline['steps_per_epoch']} steps at batch "
               f"{cls_pipeline['batch']}), evaluate and inference runs"}
    entries[0]["gen_cli"] = {
        "launches": {m: cli_launches[m]["flash_attn_fwd"]
                     for m in cli_launches},
        "generates": gen_cli["generates"],
        "decode_steps": gen_cli["decode_steps"], "per": cli_per}
    entries[0]["ablation"] = {
        **abl_totals["per_validation_forward"],
        "launches": abl_launches["flash_attn_fwd"],
        "launches_per_validation_forward":
            ablation["launches_per_validation_forward"],
        "per": abl_per + "validation forward of the full model, bf16"}
    entries[0]["rag"] = {
        **rag_tot["per_forward"],
        "generate": rag_tot["per_generate"],
        "launches_per_validation_forward":
            rag["cls"]["validation_launches"]["flash_attn_fwd"],
        "launches_per_generate": rag["gen"]["launches_per_generate"],
        "dense_retrieval_launches_per_chunk":
            rag["dense"]["launches_per_chunk"],
        "cli_launches": {m: r["flash_attn_fwd"] for m, r in rag_cli.items()},
        "per": f"one flagship forward at batch 8 with KnowledgeAttention "
               f"(K = {RAG_K}; {ATTN_CALLS_PER_FORWARD + 1} calls), and "
               f"under generate one beam generate at batch 16 over a "
               f"{RAG_MEMORY}-token memory, bf16"}
    runs = {"gradual_unfreeze": trainer["gradual_unfreeze"],
            "checkpointing": {"launches": trainer["checkpointing"][
                "train_launches"]},
            "gen_cli_freeze_visual": trainer["gen_cli"]}
    trainer_per = (f"VQATrainer gradual_unfreeze ({TRAINER_EPOCHS} epochs "
                   f"of {trainer['gradual_unfreeze']['steps_per_epoch']} "
                   f"steps at batch {trainer['gradual_unfreeze']['batch']},"
                   f" a validation forward an epoch), VQATrainer with "
                   f"gradient checkpointing and freeze_visual "
                   f"({trainer['checkpointing']['train_steps']} steps), the"
                   f" generative CLI's train with --freeze-visual "
                   f"({trainer['gen_cli']['steps']} steps)")

    def trainer_entry(name):
        profiles = {r: trainer[r]["profile"]["attention_device_ms"][name]
                    for r in ("gradual_unfreeze", "checkpointing")}
        timed = zoo_kernels["trainer_forward"] if name == "flash_attn_fwd" \
            else {k: v for k, v in
                  zoo_kernels["per_step"]["trainer"][name].items()
                  if k != "by_case_ms"}
        return {**timed,
                "launches": {r: v["launches"][name] for r, v in runs.items()},
                "checkpointed_step_launches":
                    trainer["checkpointing"]["step_launches"][name],
                "profiled_ms_per_step": profiles,
                "step_event_ms": {
                    r: trainer[r]["median_step_event_ms"]
                    for r in ("gradual_unfreeze", "checkpointing")},
                "per": trainer_per + "; profiled_ms_per_step: the kernel's "
                       "device ms in one profiled step at batch 32 (every "
                       "tower training; checkpointed with freeze_visual); "
                       "ms, bound_ms, library_ms: the kernel phase's over "
                       + ("a validation forward" if name == "flash_attn_fwd"
                          else "a step") + " at batch 32"}

    def zoo_entry(name):
        """The kernel at each new shape and its totals per zoo path."""
        if name == "flash_attn_fwd":
            shapes = {n: {k: r[k] for k in (
                "B", "H", "Lq", "Lk", "mask", "kernel_ms", "plain_ms",
                "library_ms", "bound_us", "bound_by", "max_abs_err_bf16")}
                for n, r in zoo_kernels["forward"].items()}
            totals = zoo_kernels["per_forward"]
            launches = {n: p["serving"]["launches_per_forward"]
                        for n, p in zoo["paths"].items()}
            launches["vision_token_embedding"] = \
                zoo["library"]["vision_token"]["forward_launches"][name]
            launches["cli_swin_qformer"] = {
                m: r[name] for m, r in zoo["cli"]["launches"].items()}
            launches["generative_sparse_greedy_generate"] = \
                zoo["generative"]["launches_per_generate"]
            per = (f"per serving forward at batch {ZOO_SERVE_BATCH} (the "
                   f"vision-token embedding at {ZOO_LIB_BATCH}), bf16")
        else:
            shapes = {n: {"B": r["B"], "H": r["H"], "Lq": r["Lq"],
                          "Lk": r["Lk"], "mask": r["mask"],
                          "dropout": r["dropout"],
                          **{k: r[name][k] for k in (
                              "kernel_ms", "plain_ms", "library_ms",
                              "bound_ms", "bound_by")}}
                      for n, r in zoo_kernels["training"].items()}
            totals = {p: {k: v for k, v in t[name].items()
                          if k != "by_case_ms"}
                      for p, t in zoo_kernels["per_step"].items()}
            launches = {n: p["training"]["launches_per_step"][name]
                        for n, p in zoo["paths"].items()}
            launches["vision_token_embedding"] = \
                zoo["library"]["vision_token"]["fwd_bwd_launches"][name]
            launches["cli_swin_qformer"] = zoo["cli"]["launches"][
                "train"][name]
            launches["generative_sparse_step"] = zoo["generative"][
                "train_check"]["card_launches"][name]
            per = (f"per train step at batch {ZOO_BATCH} (the "
                   f"vision-token embedding's forward and backward at "
                   f"{ZOO_LIB_BATCH}), bf16, at each call's dropout")
        return {"shapes": shapes, "per_path": totals, "launches": launches,
                "per": per}
    entries[0]["trainer"] = trainer_entry("flash_attn_fwd")
    entries[0]["zoo"] = zoo_entry("flash_attn_fwd")

    def hf_entry(name):
        """The kernel with the pretrained towers."""
        out = {"cls_cli_launches": {m: r[name] for m, r in
                                    hf["cli"]["launches"].items()},
               "gen_cli_launches": {m: r[name] for m, r in
                                    hf["generative"]["launches"].items()}}
        if name == "flash_attn_fwd":
            out.update(
                shapes={n: {k: r[k] for k in (
                    "B", "H", "Lq", "Lk", "mask", "kernel_ms", "plain_ms",
                    "library_ms", "bound_us", "bound_by",
                    "max_abs_err_bf16")} for n, r in hf_rows.items()},
                launches_per_forward=hf["forward_launches"][name],
                launches_per_greedy_generate=hf["generative"][
                    "greedy_generate"]["launches"],
                launches_per_tower_forward={
                    n: r["card_launches"][name]
                    for n, r in hf["towers"].items()},
                per=f"per call at each tower's batch "
                    f"({HF_TOWER_BATCH}), bf16; a classification forward "
                    f"at batch {HF_SERVE_BATCH}, a greedy generate at "
                    f"{HF_GEN_BATCH}")
        else:
            out["per"] = (f"the CLIs' train runs at batch {HF_BATCH} "
                          f"({hf['cli']['steps']} and "
                          f"{hf['generative']['steps']} steps)")
        return out
    entries[0]["hf_import"] = hf_entry("flash_attn_fwd")

    entries[0]["mesh"] = mesh_entry("flash_attn_fwd", mesh_rows, mesh_tot,
                                    mesh)
    totals = step_totals(train_rows)
    gen_totals = step_totals(gen_rows)
    replaces = {
        "flash_attn_fwd_lse": ("flash_attn_fwd.cu", ":142 (_flash_kernel_lse, "
                               "via _flash_forward_lse :196, pallas_call "
                               "at :206)"),
        "flash_attn_bwd": ("flash_attn_bwd.cu", ":230 "
                           "(_flash_bwd_dkv_kernel, pallas_call at :351) "
                           "and :285 (_flash_bwd_dq_kernel, pallas_call at "
                           ":377)")}
    for name in TRAIN_KERNELS:
        source, where = replaces[name]
        step = {k: v for k, v in totals[name].items()
                if k not in ("calls_per_step", "by_case_ms")}
        entries.append({
            "name": name, "route": "cuda",
            "source": f"vivqa_tpu_torch/csrc/{source}",
            "replaces": f"vivqa_tpu/ops/flash_attention.py{where}",
            "launches": train_launches[name], **step, **ptxas[name],
            **({"design": FORWARD_DESIGN}
               if name == "flash_attn_fwd_lse" else {}),
            "per": f"one flagship train step at batch {TRAIN_BATCH} "
                   f"({ATTN_CALLS_PER_STEP} calls), bf16; max_abs_err is "
                   f"relative to each tensor's largest value for dq/dk/dv "
                   f"and m/l",
            "generative_step": {
                **gen_totals[name],
                "launches": gen_training["launches"][name],
                "launches_per_step":
                    gen_training["launches_per_step"][name],
                "per": f"one generative train step at batch "
                       f"{gen_training['batch']}, bf16"},
            "cls_pipeline": {
                "launches": cls_launches["train"][name],
                "launches_per_step":
                    cls_pipeline["launches_per_step"][name],
                "per": f"VQAPipeline train run, "
                       f"{cls_pipeline['epochs']} epochs of "
                       f"{cls_pipeline['steps_per_epoch']} steps at batch "
                       f"{cls_pipeline['batch']}"},
            "gen_cli": {
                "launches": {m: cli_launches[m][name]
                             for m in cli_launches},
                "per": cli_per},
            "ablation": {
                **{k: v for k, v in abl_totals["per_step"][name].items()
                   if k != "by_case_ms"},
                "launches": abl_launches[name],
                "launches_per_step": ablation["launches_per_step"][name],
                "per": abl_per + "training step of the full model, bf16"},
            "rag": {
                **{k: v for k, v in rag_tot["per_step"][name].items()
                   if k != "by_case_ms"},
                "launches": rag["cls"]["launches"][name],
                "launches_per_step": rag["cls"]["launches_per_step"][name],
                "generative_step": {
                    **{k: v for k, v in
                       rag_tot["per_generative_step"][name].items()
                       if k != "by_case_ms"},
                    "launches": rag["gen"]["launches"][name],
                    "launches_per_step":
                        rag["gen"]["launches_per_step"][name]},
                "cli_launches": {m: r[name] for m, r in rag_cli.items()},
                "per": f"one flagship train step at batch {TRAIN_BATCH} "
                       f"with KnowledgeAttention "
                       f"({ATTN_CALLS_PER_STEP + 1} calls), and under "
                       f"generative_step one generative step at batch "
                       f"{GEN_TRAIN_BATCH} over a {RAG_MEMORY}-token "
                       f"memory, bf16"},
            "trainer": trainer_entry(name),
            "zoo": zoo_entry(name),
            "hf_import": hf_entry(name),
            "mesh": mesh_entry(name, mesh_rows, mesh_tot, mesh)})
    comp, towers = tools["profile_components"], tools["profile_towers"]
    for e in entries:
        n = e["name"]
        e["tools"] = {
            "profile_components": {m: r["launches_per_call"][n]
                                   for m, r in comp["modes"].items()},
            "profile_towers": {t: {p: r[p]["launches_per_call"][n]
                                   for p in ("forward", "fwd_bwd")}
                               for t, r in towers["towers"].items()},
            "per": f"launches a call: profile_components' modes at batch "
                   f"{comp['batch']}, profile_towers' towers at batch "
                   f"{towers['batch']}"}
        e["examples"] = {"launches": {w: r["launches"][n] for w, r in
                                      examples["walkthroughs"].items()},
                         "per": "each walkthrough's run on the card"}
    return {"kernels": entries}


def mesh_entry(name: str, mesh_rows: dict, mesh_tot: dict,
               mesh: dict) -> dict:
    """The kernel ``name`` on the mesh phase's two ranks, for the kernels
    line: ``mesh_report``'s kernel rows, their totals and the ranks'
    results."""
    part = "forward" if name == "flash_attn_fwd" else "training"

    def shape_row(r):
        r = r[part]
        row = {"B": r["B"], "H": r["H"], "Lq": r["Lq"], "Lk": r["Lk"],
               "mask": r["mask"]}
        if part == "forward":
            return {**row, **{k: r[k] for k in (
                "kernel_ms", "plain_ms", "library_ms", "bound_us",
                "bound_by", "max_abs_err_bf16")}}
        return {**row, "dropout": r["dropout"], **{k: r[name][k] for k in (
            "kernel_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by")}}
    shapes = {n: shape_row(r) for n, r in mesh_rows["flagship"].items()}
    shapes.update({f"{n} dropout {rate}": shape_row(r)
                   for (n, rate), r in mesh_rows["knowledge"].items()
                   if part == "training" or rate == 0.0})
    launches = {
        f"rank{r['rank']} {shape} {part_}": (
            got["launches_per_forward"] if name == "flash_attn_fwd"
            else got["launches_per_step"][name])
        for r in mesh["ranks"] for shape, run in r["runs"].items()
        for part_, got in run.items()
        if part_ not in ("generative", "seconds")}
    if name == "flash_attn_fwd":
        launches.update({
            f"rank{r['rank']} (1, 2) generate":
                r["runs"]["(1, 2)"]["generative"]["launches_per_generate"]
            for r in mesh["ranks"]})
    launches.update({
        f"rank{r['rank']} (1, 2) {cli} CLI with knowledge":
            r["cli"]["launches"][cli][name]
        for r in mesh["ranks"] for cli in ("cls", "gen")})
    launches.update({
        f"rank{r['rank']} (2, 1) ablation {eid.split('__')[0]}":
            rec["launches"][name]
        for r in mesh["ranks"]
        for eid, rec in r["ablation"]["experiments"].items()})
    abl_part = ("per_validation_forward" if name == "flash_attn_fwd"
                else "per_step")
    abl_tot = mesh_tot["ablation"][abl_part]
    abl_tot = abl_tot if name == "flash_attn_fwd" else abl_tot[name]
    return {**{k: v for k, v in mesh_tot[name].items()
               if k != "by_case_ms"},
            "shapes": shapes, "launches": launches,
            "with_knowledge": {k: v for k, v in
                               mesh_tot["knowledge"][name].items()
                               if k != "by_case_ms"},
            "ablation": {k: v for k, v in abl_tot.items()
                         if k != "by_case_ms"},
            "per": ("a rank's evaluation forward" if part == "forward"
                    else "a rank's train step") + f" on the (1, 2) mesh "
                   f"(global batch {MESH_BATCH}, half the heads a rank),"
                   f" bf16; with_knowledge: the same with "
                   f"KnowledgeAttention (1 x {RAG_K}, 4 heads); "
                   f"ablation: the study's full model at its per-rank "
                   f"batch {ABL_BATCH // 2} on (2, 1); launches a "
                   f"forward (a step, a generate) per rank, and each "
                   f"rank's in the CLIs' train runs and the ablation "
                   f"experiments"}


def _path_totals(rows: dict, calls_key: str) -> dict:
    """The rows' times, bound and largest bf16 error over one pass of a
    path (each shape's number times its calls)."""
    main = [r for r in rows.values() if r[calls_key]]

    def total(key):
        return sum(r[key] * r[calls_key] for r in main)
    t_bytes = total("bytes") / HBM_BYTES_PER_S * 1e3
    t_flops = total("flops") / PEAK_FLOPS[torch.bfloat16] * 1e3
    return {"max_abs_err": max(r["max_abs_err_bf16"] for r in main),
            "ms": total("kernel_ms"),
            "plain_ms": total("plain_ms"),
            "bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations",
            "library_ms": total("library_ms")}


def generate_entry(rows: dict, generative: dict) -> dict:
    """The forward kernel per generate: the launches counted per generate
    in the generative phase, and the kernel-phase times of the calls of
    one beam generate at batch 16, with the profiler's attention time of
    that generate."""
    profile = (generative["profile"] or {}).get(GEN_HEAD) or {}
    return {"launches_per_generate": generative["launches_per_generate"],
            "launches": generative["launches"]["flash_attn_fwd"],
            "generates": generative["generates"],
            **_path_totals(rows, "calls_per_generate"),
            "profiled_in_generate_ms": profile.get("attention_device_ms"),
            "per": f"one {GEN_HEAD.replace('_b', ' generate at batch ')} "
                   f"at bench_serving's config "
                   f"({generative['attention_calls_per_generate']} calls),"
                   f" bf16"}


FORWARD_DESIGN = ("one Hopper forward for both entries: a TMA-fed, "
                  "persistent wgmma kernel (tile form for Lk <= 128, over "
                  "one 32-key tile for Lk <= 32; long form over 64- or "
                  "128-key tiles, its keys split over units where (b, h, "
                  "query tile) units are fewer than the SMs, merged by a "
                  "second kernel; branchless masking and causal rules) and "
                  "a CUDA-core decode form for Lq <= 4; "
                  "flash_attention.forward_plan picks the form")


def forward_entry(rows: dict, launches: int, ptxas: dict) -> dict:
    totals = _path_totals(rows, "calls_per_forward")
    return {
        "name": "flash_attn_fwd", "route": "cuda",
        "source": "vivqa_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "vivqa_tpu/ops/flash_attention.py:61 (_flash_kernel, "
                    "via _flash_forward :116, pallas_call at :127)",
        "launches": launches, **totals, **ptxas,
        "design": FORWARD_DESIGN,
        "per": f"one flagship forward at batch 8 "
               f"({ATTN_CALLS_PER_FORWARD} calls), bf16"}


def mesh_report(card: str, t_start: float, launched: dict,
                abl: dict | None = None) -> tuple:
    """Phase 15 with its report: the kernels at the per-rank shapes, then
    the ranks; the ranks' launch keys go into ``launched['mesh']``.
    ``abl``: the ablation phase's result (its rows are the two-rank
    study's reference). Returns (kernel rows, their totals, the ranks'
    results)."""
    t_mesh = time.perf_counter()
    with timed("mesh.kernels"):
        mesh_rows = mesh_kernel_phase()
    mesh_tot = mesh_totals(mesh_rows)
    emit({"mesh_attention": mesh_tot, "card": card})
    with timed("mesh.ranks"):
        mesh = mesh_phase(
            cfg=check_depth(flagship_config()),
            gen_cfg=gen_check_depth(bench_serving.serving_config()), abl=abl)
    launched["mesh"] = mesh.pop("launch_keys")
    emit({"mesh": mesh, "card": card})
    runs = mesh["ranks"][0]["runs"]

    def against(run, part):
        a = run[part]["against_one_process"]
        return (f"{part} loss/grad-norm rel diff {a['loss_rel_diff']:.2e}/"
                f"{a['grad_norm_rel_diff']:.2e} cosine "
                f"{a['update_cosine']:.5f}")
    print("[mesh] two ranks on one card over " + mesh["ranks"][0]["backend"]
          + "; " + "; ".join(
        f"{shape}: flagship steps " + " / ".join(
            ", ".join(f"{ms:.1f}" for ms in
                      r["runs"][shape]["flagship"]["step_event_ms"])
            for r in mesh["ranks"]) + " ms by events (ranks 0 / 1), "
        f"collectives " + ", ".join(
            f"{ms:.1f}" for ms in run["flagship"]["collective_host_ms"])
        + f" host ms and "
        f"{run['flagship']['collective_bytes'][-1] / 2**20:.1f} MiB a step, "
        f"peak " + "/".join(
            f"{r['runs'][shape]['flagship']['max_memory_allocated_gib']:.2f}"
            for r in mesh["ranks"]) + " GiB, " + ", ".join(
                against(run, part) for part in ("flagship", "knowledge",
                                                "adafactor") if part in run)
        + f", knowledge logits max diff "
          f"{run['knowledge']['logits_against_one_process']['max_abs_logit_diff']:.3g}"
          f", f32 copy loss rel diff "
          f"{run['f32']['against_one_process']['loss_rel_diff']:.2e}"
        for shape, run in runs.items())
        + "; adafactor statistics rel diff " + "; ".join(
            f"{part} " + ", ".join(
                f"{f} {v['rel_diff']:.2e}" for f, v in
                runs["(1, 2)"][part]["statistics_against_one_process"]
                .items() if f != "tolerance")
            for part in ("adafactor", "f32_adafactor"))
        + f"; generative (1, 2) logits max diff "
          f"{runs['(1, 2)']['generative']['against_one_process']['max_abs_logit_diff']:.3g}"
          f" (tolerance "
          f"{runs['(1, 2)']['generative']['against_one_process']['tolerance']:.3g}),"
          f" {runs['(1, 2)']['generative']['launches_per_generate']} launches "
          f"a generate; CLIs with knowledge on (1, 2) " + ", ".join(
              f"{n} {t:.1f} s" for n, t in
              mesh["ranks"][0]["cli"]["run_seconds"].items())
        + "; ablation on (2, 1): " + ", ".join(
            f"{eid.split('__')[0]} em {r['exact_match']:.3f} (one process "
            f"{r['one_process_exact_match']:.3f}), "
            f"{r['seconds_two_ranks'][0]:.1f} s (one process "
            f"{r['seconds_one_process']:.1f})"
            for eid, r in mesh["ablation"].items())
        + "; attention per rank step on (1, 2) " + ", ".join(
              f"{n} {mesh_tot[n]['ms']:.3f} ms" for n in
              ("flash_attn_fwd",) + TRAIN_KERNELS)
        + f" on {card} ({time.perf_counter() - t_mesh:.1f} s of the phase, "
          f"{mesh['seconds']:.1f} s of it the ranks; "
          f"{time.perf_counter() - t_start:.1f} s)", flush=True)
    return mesh_rows, mesh_tot, mesh


def tools_report(card: str, launched: dict) -> dict:
    """Phase 16 with its report; its launch keys go into
    ``launched['tools']``."""
    with recording_launches(launched.setdefault("tools", set())), \
            timed("tools"):
        tools = tools_phase()
    emit({"tools": tools, "card": card})
    comp, towers = tools["profile_components"], tools["profile_towers"]

    def wall_busy(r):
        return (f"{r['wall_ms']:.1f}/{r['profiled_window_ms']:.1f}/"
                f"{r['busy_ms']:.1f}")
    full = comp["modes"]["full"]["launches_per_call"]
    print(f"[tools] profile_components at batch {comp['batch']}, wall/"
          f"profiled window/busy ms: " + ", ".join(f"{m} {wall_busy(r)}"
                              for m, r in comp["modes"].items())
          + "; implied " + ", ".join(f"{k} {v:.1f}" for k, v in
                                     comp["implied_ms"].items())
          + f" ms; launches a full step {full}; profile_towers at batch "
          f"{towers['batch']}, forward and forward+backward wall/profiled "
          f"window/busy ms: "
          + ", ".join(f"{n} {wall_busy(r['forward'])} and "
                      f"{wall_busy(r['fwd_bwd'])}"
                      for n, r in towers["towers"].items())
          + "; input pipeline images/s " + ", ".join(
              f"{m} PIL {r['pil_images_per_s']:.1f} native "
              f"{r['native_images_per_s']}" for m, r in
              tools["bench_input_pipeline"]["modes"].items())
          + f" on {card}", flush=True)
    return tools


def examples_report(card: str, launched: dict) -> dict:
    """Phase 17 with its report; the walkthroughs' launch keys and the
    setup script's go into ``launched['examples']``."""
    keys = launched.setdefault("examples", set())
    with recording_launches(keys), timed("examples"):
        examples = examples_phase()
    keys |= examples["setup"].pop("setup_launch_keys")
    emit({"examples": examples, "card": card})
    setup = examples["setup"]
    print("[examples] " + ", ".join(
        f"{n} {r['seconds']:.1f} s ({r['sections']} sections, "
        f"{sum(r['launches'].values())} launches)"
        for n, r in examples["walkthroughs"].items())
        + f"; setup_pipeline.sh --synthetic --skip-eval {setup['seconds']:.1f}"
          f" s, stages {len(setup['stages'])} of 5 reported, "
          f"{setup['launch_keys']} launch keys on {card}", flush=True)
    return examples


def path_report(launched: dict) -> None:
    """Phase 16 with its report."""
    paths = path_check_phase(launched)
    emit({"path_check": paths})
    print(f"[path_check] launch keys by path {paths['launch_keys']}: "
          f"{paths['held_by_kernel_phases']} held by the kernel phases, "
          f"{len(paths['held_here'])} held here", flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--recorded"] and argv[2:3] == ["-m"]:
        return recorded_run(argv[1], argv[3], argv[4:])
    parser = argparse.ArgumentParser(description="Drive the port on one "
                                     "CUDA card (see the module docstring).")
    parser.add_argument("--phase", choices=("all", "mesh", "tools",
                                            "examples"), default="all",
                        help="'mesh', 'tools' or 'examples': the build, "
                             "that phase and path_check alone (no kernels "
                             "line and no device line)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    resolve_device("cuda")          # also turns TF32 off for f32 products
    torch.set_num_threads(8)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[device] {kind} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | nvidia-smi: {card}", flush=True)

    with timed("build"):
        ptxas = build_phase()
    if args.phase != "all":
        launched = {}
        if args.phase == "mesh":
            with timed("mesh"):
                mesh_report(card, t_start, launched)
        elif args.phase == "tools":
            tools_report(card, launched)
        else:
            examples_report(card, launched)
        with timed("path_check"):
            path_report(launched)
        print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
        emit({"phase_seconds": {**PHASE_SECONDS,
                                "total": time.perf_counter() - t_start}})
        print(card)
        return 0
    with timed("kernels"):
        rows = kernel_phase()
    fwd_line = forward_line(rows)
    emit(fwd_line)
    line = fwd_line["serving_forward"]
    print("[kernels] serving forward (bf16): " + "; ".join(
        f"per {label.replace('_', ' ')} {t['ms']:.4f} ms (SDPA "
        f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms)"
        for label, t in (("flagship forward", line["per_flagship_forward"]),
                         ("beam generate at 16",
                          line["per_beam_generate_b16"])))
          + "; decode calls: " + ", ".join(
              f"{n} {t['ms'] * 1e3:.2f} us (SDPA {t['library_ms'] * 1e3:.2f})"
              for n, t in line["decode_calls"].items()), flush=True)
    with timed("kernels"):
        train_rows = train_kernel_phase()
    print(f"[kernels] {time.perf_counter() - t_start:.1f} s", flush=True)
    cfg = flagship_config()
    launched = {}           # path: its launch keys (path_check_phase)
    with recording_launches(launched.setdefault("serving", set())), \
            timed("serving"):
        serving = serving_phase(cfg, "cuda")
    emit({"serving": serving, "card": card})
    print(f"[serving] {serving['batches']} batches of {serving['batch']}: "
          f"{serving['mean_batch_latency_ms']:.2f} ms per batch, "
          f"{serving['answers_per_s']:.1f} answers/s on {card}", flush=True)
    with recording_launches(launched.setdefault("generative", set())), \
            timed("generative"):
        generative = generative_phase(bench_serving.serving_config())
    emit({"generative": generative, "card": card})
    print("[generative] " + ", ".join(
        f"{k} {r['answers_per_sec']:.1f} answers/s p50 "
        f"{r['latency_ms_p50']:.1f} ms" for k, r in
        generative["results"].items())
        + f"; {generative['launches_per_generate']:.0f} attention launches "
          f"per generate on {card} ({time.perf_counter() - t_start:.1f} s)",
        flush=True)
    with recording_launches(launched.setdefault("training", set())), \
            timed("training"):
        training = training_phase(cfg)
    emit({"training": training, "card": card})
    print(f"[training] batch {training['batch']}: median step "
          f"{training['median_step_ms']:.1f} ms, "
          f"{training['qa_pairs_per_s']:.1f} QA-pairs/s, peak "
          f"{training['max_memory_allocated_gib']:.1f} GiB on {card}",
          flush=True)
    with recording_launches(launched["training"]), \
            timed("training.train_check"):
        check = train_check(check_depth(cfg), calls_per_step=
                            attention_calls_per_forward(check_depth(cfg)))
    emit({"train_check": check})
    print(f"[training] {time.perf_counter() - t_start:.1f} s", flush=True)

    tok = gen_tokenizer()
    gen_cfg = gen_training_config(tok)
    with timed("gen_training.kernels"):
        gen_rows = gen_train_kernel_phase(gen_cfg)
    gen_totals = step_totals(gen_rows)
    emit({"gen_training_attention_per_step": gen_totals, "card": card})
    with recording_launches(launched.setdefault("gen_training", set())), \
            timed("gen_training"):
        gen_training = gen_training_phase(gen_cfg, tok)
    emit({"gen_training": gen_training, "card": card})
    print(f"[gen_training] batch {gen_training['batch']}: median step "
          f"{gen_training['median_step_ms']:.1f} ms (events "
          f"{gen_training['median_step_event_ms']:.1f}), "
          f"{gen_training['answer_tokens_per_s']:.1f} answer tokens/s, "
          f"{gen_training['qa_pairs_per_s']:.1f} QA-pairs/s, peak "
          f"{gen_training['max_memory_allocated_gib']:.1f} GiB; attention "
          f"per step " + ", ".join(f"{n} {t['ms']:.3f} ms" for n, t in
                                   gen_totals.items())
          + f" on {card}", flush=True)
    with recording_launches(launched["gen_training"]), \
            timed("gen_training.train_check"):
        gen_check = gen_train_check(gen_cfg, tok)
    emit({"gen_train_check": gen_check})
    with recording_launches(launched.setdefault("gen_pipeline", set())), \
            timed("gen_pipeline"):
        pipeline = pipeline_phase(gen_cfg, tok)
    emit({"gen_pipeline": pipeline})
    print(f"[gen_pipeline] {pipeline['steps']} steps and a validation in "
          f"{pipeline['seconds']:.1f} s: {pipeline['history'][0]}",
          flush=True)
    with recording_launches(launched.setdefault("cls_pipeline", set())), \
            timed("cls_pipeline"):
        cls = cls_pipeline_phase(check_depth(cfg))
    emit({"cls_pipeline": cls, "card": card})
    prof = cls["profile"]
    print(f"[cls_pipeline] train {cls['run_seconds']['train']:.1f} s "
          f"({cls['train_stage_s_per_epoch']:.1f} s per epoch of training "
          f"stage), evaluate {cls['run_seconds']['evaluate']:.1f} s, "
          f"inference {cls['run_seconds']['inference']:.1f} s; the "
          f"pipeline's own loop: "
          + ", ".join(f"{s:.2f} s" for s in cls["pipeline_loop_s"])
          + f" an epoch, median step {cls['median_pipeline_step_ms']:.1f} "
          f"ms by host clock, against the bare step's "
          f"{cls['median_bare_step_ms']:.1f} ms (events "
          f"{cls['median_bare_step_event_ms']:.1f}) at batch "
          f"{cls['batch']}; qa_pairs_per_sec in the history "
          f"{cls['qa_pairs_per_sec_history']}; loader "
          f"{cls['loader_host_ms_per_batch']:.1f} host ms per batch on the "
          f"{cls['image_path']} image path; idle "
          f"{prof['step']['device_idle_share']:.3f} of a profiled step "
          f"({prof['step']['host_ms']:.1f} ms), "
          f"{prof['validation']['device_idle_share']:.3f} of a profiled "
          f"validation; peak {cls['max_memory_allocated_gib']:.2f} GiB on "
          f"{card}", flush=True)
    with recording_launches(launched.setdefault("gen_cli", set())), \
            timed("gen_cli"):
        gen_cli = gen_cli_phase(gen_check_depth(
            bench_serving.serving_config()))
    emit({"gen_cli": gen_cli, "card": card})
    prof = gen_cli["profile"]
    fitted = gen_cli["fitted"]
    print("[gen_cli] " + ", ".join(
        f"{m} {t:.1f} s" for m, t in gen_cli["run_seconds"].items())
        + f"; bare step median {gen_cli['median_bare_step_ms']:.1f} ms by "
          f"host clock, {gen_cli['median_bare_step_event_ms']:.1f} ms by "
          f"events at batch {gen_cli['batch']}; idle "
          f"{prof['step']['device_idle_share']:.3f} of a profiled step, "
          f"{prof['generate']['device_idle_share']:.3f} of a profiled "
          f"generate ({gen_cli['validation_decode_steps']} decode steps); "
          f"fitted bench early/fixed "
          + ", ".join(f"{k} {r['speedup_vs_fixed']:.3f}x"
                      for k, r in fitted.items() if k.endswith("early"))
          + "; peak " + ", ".join(
              f"{m} {g:.2f} GiB" for m, g in
              gen_cli["max_memory_allocated_gib"].items())
          + f" on {card} ({time.perf_counter() - t_start:.1f} s)",
        flush=True)
    abl_cfg = abl_model_config()
    with timed("ablation.kernels"):
        abl_rows = abl_kernel_phase(abl_cfg)
    abl_totals = {"per_step": step_totals(abl_rows),
                  "per_validation_forward": abl_forward_totals(abl_rows)}
    emit({"ablation_attention": abl_totals, "card": card})
    with recording_launches(launched.setdefault("ablation", set())), \
            timed("ablation"):
        abl = ablation_phase()
    emit({"ablation": abl, "card": card})
    prof = abl["profile"]
    print("[ablation] " + ", ".join(
        f"{eid.split('__')[0]}__{eid.split('__')[1][:4]} "
        f"{r['seconds']:.1f} s em {r['exact_match']:.3f}"
        for eid, r in abl["experiments"].items())
        + f"; {abl['attention_calls_per_forward']} attention calls per "
          f"forward ({abl['attention_calls_per_forward_no_moe']} without "
          f"the MoE); bare step median {abl['median_bare_step_ms']:.1f} ms "
          f"({abl['median_bare_step_event_ms']:.1f} by events) at batch "
          f"{abl['batch']}; idle {prof['step']['device_idle_share']:.3f} of "
          f"a profiled step; peak {abl['max_memory_allocated_gib']:.2f} GiB;"
          f" attention per step " + ", ".join(
              f"{n} {t['ms']:.3f} ms" for n, t in
              abl_totals["per_step"].items())
        + f" on {card} ({time.perf_counter() - t_start:.1f} s)", flush=True)
    with timed("rag.kernels"):
        rag_rows = rag_kernel_phase()
    rag_tot = rag_totals(rag_rows, rows, train_rows, gen_rows)
    emit({"rag_attention": rag_tot, "card": card})
    provider = rag_provider()
    rag = {}
    with recording_launches(launched.setdefault("rag", set())):
        for part, run in (
                ("cls", lambda: rag_cls_phase(cfg, provider)),
                ("gen", lambda: rag_gen_phase(provider)),
                ("cli", lambda: rag_cli_phase(
                    check_depth(cfg), gen_check_depth(
                        bench_serving.serving_config()))),
                ("dense", lambda: rag_dense_phase(cfg, provider))):
            with timed(f"rag.{part}"):
                rag[part] = run()
    emit({"rag": rag, "card": card})
    retrieval = rag["cli"]["retrieval"]["cls_train"]
    print(f"[rag] classification step with knowledge "
          f"{rag['cls']['median_step_ms']:.1f} ms (bare "
          f"{rag['cls']['median_bare_step_ms']:.1f}) at batch "
          f"{rag['cls']['batch']}, idle "
          f"{rag['cls']['profile']['device_idle_share']:.3f} of a profiled "
          f"step, peak {rag['cls']['max_memory_allocated_gib']:.2f} GiB; "
          f"generate over {RAG_MEMORY} keys " + ", ".join(
              f"{s} {ms:.1f} ms" for s, ms in rag["gen"]["generate_ms"]
              .items())
          + f"; generative step {rag['gen']['median_step_ms']:.1f} ms; "
          f"retrieval {retrieval['cold_ms_per_batch']} ms a cold batch, "
          f"{retrieval['cached_ms_per_batch']} cached; attention per step "
          + ", ".join(f"{n} {t['ms']:.3f} ms" for n, t in
                      rag_tot["per_step"].items())
          + f" on {card} ({time.perf_counter() - t_start:.1f} s)",
          flush=True)
    with recording_launches(launched.setdefault("trainer", set())), \
            timed("trainer"):
        trainer = trainer_phase(
            check_depth(cfg),
            gen_check_depth(bench_serving.serving_config()))
    emit({"trainer": trainer, "card": card})
    unfreeze, ckpt = trainer["gradual_unfreeze"], trainer["checkpointing"]
    print(f"[trainer] gradual_unfreeze at batch {unfreeze['batch']}: "
          f"{unfreeze['epochs']} epochs of {unfreeze['steps_per_epoch']} "
          f"steps in {unfreeze['seconds']:.1f} s, step "
          f"{unfreeze['median_step_event_ms']:.1f} ms by events (layer "
          f"decay, lookahead), launches {unfreeze['launches']}, idle "
          f"{unfreeze['profile']['device_idle_share']:.3f} of a profiled "
          f"step, peak {unfreeze['max_memory_allocated_gib']:.2f} GiB, the "
          f"resource report's card memory "
          f"{unfreeze['resource_report']['device_used_gb']:.2f} GB; "
          f"gradient checkpointing: launches a step "
          f"{ckpt['step_launches']}, step "
          f"{ckpt['median_step_event_ms']:.1f} ms by events, "
          f"{ckpt['leaves_bit_equal']} of "
          f"{ckpt['leaves']} gradient leaves bit-equal to the plain step's "
          f"(largest difference {ckpt['max_leaf_diff']:.3g}, the card's "
          f"spread {ckpt['max_leaf_spread']:.3g}), peak "
          f"{ckpt['max_memory_allocated_gib']:.2f} GiB; mixed steps loss "
          f"card/CPU {trainer['mix']['loss_card']}/{trainer['mix']['loss_cpu']}"
          f"; optimizers card vs CPU: max |diff| past one rounding of "
          f"p' / max |update| "
          + ", ".join(f"{n} {r['max_diff_past_one_rounding'] / r['max_abs_update']:.2e}"
                      for n, r in trainer["optimizers"]["optimizers"].items())
          + f"; generative CLI --freeze-visual {trainer['gen_cli']['steps']}"
          f" steps, {trainer['gen_cli']['launches_per_step']} launches a "
          f"step on {card} ({time.perf_counter() - t_start:.1f} s)",
          flush=True)
    t_zoo = time.perf_counter()
    with timed("zoo.kernels"):
        zoo_kernels = zoo_kernel_phase(rows)
    emit({"zoo_attention": {k: zoo_kernels[k] for k in (
        "per_forward", "per_step", "trainer_forward")}, "card": card})
    with recording_launches(launched.setdefault("zoo", set())), \
            timed("zoo"):
        zoo = zoo_phase()
    emit({"zoo": zoo, "card": card})
    window = zoo["window_attention"]
    print("[zoo] launches a forward (a step): " + ", ".join(
        f"{n} {p['serving']['launches_per_forward']:.0f} "
        f"({p['training']['launches_per_step']['flash_attn_fwd_lse']:.0f})"
        for n, p in zoo["paths"].items())
        + f"; Swin-B window attention "
          f"{100 * window['share_of_step_device_busy']:.1f}% of a step's "
          f"device time; CLI --visual-backbone swin --fusion "
          f"qformer train {zoo['cli']['run_seconds']['train']:.1f} s, "
          f"evaluate {zoo['cli']['run_seconds']['evaluate']:.1f} s; "
          f"generative sparse MoE {zoo['generative']['launches_per_generate']}"
          f" launches a greedy generate; library encoders "
          + ", ".join(f"{n} {r['fwd_bwd_ms']:.1f} ms" for n, r in
                      zoo["library"].items())
          + f" on {card} ({time.perf_counter() - t_zoo:.1f} s of the zoo, "
            f"{time.perf_counter() - t_start:.1f} s)", flush=True)
    t_hf = time.perf_counter()
    with timed("hf_import.kernels"):
        hf_rows = hf_kernel_phase()
    with recording_launches(launched.setdefault("hf_import", set())), \
            timed("hf_import"):
        hf = hf_import_phase(
            models=hf_models_at(CUT_LAYERS),
            cfg=check_depth(cfg),
            gen_cfg=gen_check_depth(bench_serving.serving_config()))
    emit({"hf_import": hf, "card": card})
    print("[hf_import] classification CLI with CLIP ViT-B/32 + PhoBERT-base"
          f" train {hf['cli']['run_seconds']['train']:.1f} s "
          f"({hf['cli']['steps']} steps, "
          f"{hf['cli']['launches']['train']['flash_attn_fwd_lse']} launches "
          f"of each training kernel), evaluate "
          f"{hf['cli']['run_seconds']['evaluate']:.1f} s; generative CLI "
          f"train {hf['generative']['run_seconds']['train']:.1f} s, greedy "
          f"evaluate {hf['generative']['run_seconds']['evaluate']:.1f} s, a "
          f"greedy generate {hf['generative']['greedy_generate']['launches']}"
          f" launches; towers card/CPU " + ", ".join(
              f"{n} {r['outputs']['tokens']['max_abs_diff']:.3g} (tolerance "
              f"{r['outputs']['tokens']['tolerance']:.3g})"
              for n, r in hf["towers"].items())
          + "; forward kernel " + ", ".join(
              f"{n} {r['kernel_ms'] * 1e3:.2f} us (SDPA "
              f"{r['library_ms'] * 1e3:.2f})" for n, r in hf_rows.items())
          + f" on {card} ({time.perf_counter() - t_hf:.1f} s of the phase, "
            f"{time.perf_counter() - t_start:.1f} s)", flush=True)
    with timed("mesh"):
        mesh_rows, mesh_tot, mesh = mesh_report(card, t_start, launched,
                                                abl)
    tools = tools_report(card, launched)
    print(f"[tools] {time.perf_counter() - t_start:.1f} s", flush=True)
    examples = examples_report(card, launched)
    print(f"[examples] {time.perf_counter() - t_start:.1f} s", flush=True)
    with timed("path_check"):
        path_report(launched)
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    emit({"phase_seconds": {**PHASE_SECONDS,
                            "total": time.perf_counter() - t_start}})
    print(card)
    emit(kernels_line(rows, serving["launches"]["flash_attn_fwd"],
                      generative, train_rows, training["launches"], ptxas,
                      gen_rows, gen_training, cls, gen_cli, abl_totals, abl,
                      rag_tot, rag, trainer, zoo_kernels, zoo, hf_rows,
                      hf, mesh_rows, mesh_tot, mesh, tools, examples))
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
