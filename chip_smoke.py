#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`multimodal_sae_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases; any failure raises and ends the run with a non-zero exit code:

1. build: print the card's name and power limit, build the CUDA kernels of
   `multimodal_sae_tpu_torch/csrc/` with nvcc for sm_90a (one process per
   source, in parallel);
2. block_max (K1) against its plain version, bit-exact, at the shapes of the
   text and image caches' two filter levels (16,384 and 9,360 tokens) and at
   bf16 block 128, then at every block it takes;
3. flash_attention (K3) against its plain version at LLaMA-3-8B's attention
   shape, unmasked and with one row left-padded by 100, each timed as the
   median, min and max of 5 repeats beside its bound, its TFLOP/s and SDPA
   (with the pad mask where there is one), with the forward kernel's
   registers, shared memory and blocks per SM at hd 128 and 64; then at the
   image cache's two shapes, (4, 32, 8, 2,341, 128) unmasked and
   (4, 32, 8, 2,929, 128) right-padded to valid lengths 2,341, 1,177, 2,329
   and 2,929, every row compared (pad queries included) and timed the same
   way; then at edge shapes, two of them right-padded with pads that end
   inside a 64-key tile;
4. flash_attention_bwd (K3 backward): the kernels' forward and backward
   against the plain pair at (2, 32, 8, 2,432, 128) bf16, unmasked and with
   row 0 left-padded by 300 (dO zero on its rows without a valid key): the
   forward's output and logsumexp, then dq, dk and dv, each side from its
   own forward, and a second backward equal bit for bit; then an edge set
   (S = 1, 17, 65, 130, 300; kvH = H and 1; hd 64; left pads past one
   64-row tile) held the same way; then timed at B = 8 (the D pass, dK/dV
   and dQ apart, with each product kernel's registers, shared memory and
   blocks per SM) beside its bound and SDPA's GQA backward, and the
   forward with lse (5 repeats, its TFLOP/s) beside its bound and SDPA's
   GQA forward;
4b. sae_encode: the SAE encoder's split fp32 product (`ops/sae_encode.py`)
   at the released SAE shape and the main path's row counts (a text cache
   batch, an image cache batch, the steering clamp's chunk, one prompt):
   timed beside both bounds, its split pass, its plain version and the
   sgemm path (`torch.matmul`, add_, relu_); its error and the sgemm's against float64 on
   8,192 latents (the kernel's no worse than twice the sgemm's); the top-k
   of a seeded 2,048-row slice equal to the sgemm path's but at near-ties;
5. cache_path: a random LLaMA-3-8B-width subject (25 layers for hookpoint
   layers.24, bf16, flash attention) feeding a 131,072-latent k=256 fp32 SAE
   (saved with `save_to_disk`, read back through `load_saes`) through
   `FeatureCache` with streaming splits over 4 batches of 8 x 2,048 tokens,
   then `save_splits` and `concate_safetensors`; checks the launch counts,
   the merged entries, the feature ranges and one batch's top-k;
   hub_sae_path, right after it: the same SAE, with its decoder, written
   as a HuggingFace cache's snapshot of HUB_REPO and read by that name,
   offline, through `load_saes` (with and without a filter) and
   `load_single_sae`, every tensor equal bit for bit to `load_from_disk`'s;
   the cache path's first batch encoded and selected with it (K1 twice),
   its top-k equal to the cache path's; kth_search_path: `kth_value`
   (the JAX package's search forms are its aliases) at the AuxK
   threshold's shape in fp32, bf16 and float16, its values equal to
   `torch.kthvalue`'s, timed beside the bytes bound;
   loader_path, in the cache path's directory, on its merged splits: a
   `FeatureDataset` filtered to 2,000 features drawn with a seed
   from those the cache holds (some under `min_examples`, skipped), loaded
   with `pool_max_activation_windows` on the cache's token rows and
   `sample`, sequentially and on LOADER_WORKERS threads, through the
   merge's `.featidx` sidecars; then 8 splits unfiltered, their sidecars
   removed, on the scan path (which heals them) and then through the
   sidecars; every record against an independent numpy reconstruction from
   the raw split (tokens and activations bit for bit), threaded equal to
   sequential, scan equal to sidecar, no kernel launched; smoke readings of
   seconds, records/s, entries/s and the host CPU's share per build;
   dp_cache_path, right after the cache phase: the cache CLI's flow
   (`launch.cache.cache.run_cache`: contiguous shards, streamed
   `Rank{r}_*` splits, a barrier, rank 0's merge, a barrier) as two ranks
   sharing the card, subprocesses of this script (`--rank dp_cache`), each
   on card 0 with a gloo group it brings up itself before
   `initialize_distributed` (NCCL refuses two ranks on one device), with
   the cache phase's subject (seed 0), SAE (read from its directory) and
   rows; the merged splits and `.featidx` sidecars equal the cache phase's
   byte for byte; per rank tokens/s, peak memory, K1 and K3 launches and
   the seconds waited at each barrier; the merge's seconds and the card's
   peak used memory from `nvidia-smi`;
   nccl_path: one process under torchrun's environment for world 1
   (`--rank nccl`): the cache flow (2 layers, hookpoint layers.1, the
   cache phase's SAE, 8 rows) with no group, then `initialize_distributed()`
   brings NCCL up on the card and the flow runs again, byte for byte the
   same; one all_reduce and one barrier on the NCCL group;
   explain_score_path, on the loader's kept records: `SimpleExplainer` then
   `SimpleScorer` through `Pipeline` on in-process stub clients, one
   explanation file and one score file per record, each read back; smoke
   readings of records/s; no kernel launched;
6. gather_rows (K2), inside the attribution phase after its counted run,
   on the subject's clean top-k (2,432 tokens x 256 rows of a
   131,072 x 4,096 fp32 decoder): copy mode bit-exact against
   `W[idx]` and timed beside it, decode mode within a stated fp32 bound of
   its plain version, deterministic, its tile pre-pass equal to the plain
   one, timed beside its bound and `embedding_bag`, here and on a seeded
   uniform index set of the same shape, with the rows a tile of 8, 16, 32
   or 64 tokens names (printed for every index set K2 is checked on);
   then its splice mode (`splice_decode`, the attribution chunk's decode)
   equal bit for bit to the parent path (`gather_decode` of `reselect`'s
   lists + b_dec, cast to the splice's dtype) and within a stated bound of
   its plain version (equal bits on the rows it copies) on the full-width
   chunk of the 8 inside features, the chunk of the 8 outside ones, 1
   feature, 32 features on 256 tokens, a small k == width case and a small
   bf16 decoder; both chunks timed (median of 5) beside the parent path,
   the hit count, the two bound terms and `embedding_bag`;
7. attribution_path: the full 32-layer random LLaMA-3-8B-width subject
   (bf16, flash attention, LM head) and the 131,072-latent SAE with its
   decoder (saved, then loaded with `decoder=True`); `fast_attribution_maps`
   at layers.24 over one 2,432-token prompt, 16 features at feature_batch 8
   (8 from the clean top-k at the last position, 8 in no token's top-(k+1)
   pool); checks the launch counts, finite saliency, exact zeros for the 8
   outside features, and the fast path against the general path for 2
   features; then a masked run (2 prompts of 512, row 1 left-padded by 100)
   with exact zeros at the pad positions and the fast path against the
   general path for 2 features; one chunk is timed stage by stage
   (CUDA events) and once under torch.profiler;
   general_attribution_path, on that subject: `general_attribution_maps`
   over two hookpoints, a second SAE of the same shape at layers.16 beside
   the one at layers.24, one 2,432-token prompt, 3 features from each
   hook's last-token top-k and 1 outside every top-k (exact zeros at both
   hooks), the launch counts per feature asserted, the stage split (clean
   forward once; corrupted forward, backward, saliency products per
   feature, CUDA events), ms per feature, features/s and peak memory; K2's
   dvals mode at the upper splice's indices (2,432 x 256) and on a uniform
   set of that shape, and the K3
   backward at one prompt (1, 32, 8, 2,432, 128) against their plain
   versions, dvals' share of a feature; and the call at reduced depth (4
   layers, 256 tokens, full widths, fp32, eager attention) on the card
   against the CPU within GENERAL_CPU_L2_REL, the CPU taking every splice's
   top-k selection from the card's run (where its own would differ, the
   card's pick must be a near-tie);
   stats_path, after the attribution phase, on that subject's LM head and that SAE's
   decoder: `get_neighbors` for the loader's 2,000 features at k = 10, `logits` for
   the loader's records (a stub tokenizer), `PcaReducer.fit_sae_list` at
   the full decoder, the thin SVD of the decoder timed beside it; 16 features recomputed in float64 on the card
   (neighbour and top-token orders equal but for near-ties, cosines within
   STATS_ATOL), the two components orthonormal and their variance equal to
   the covariance's top two eigenvalues (float64); ms and peak memory per
   call; no kernel launched;
8. train_path: `SaeTrainer` at the README's command shape (131,072
   latents, k = 256, fp32, batch 8 x 2,048, grad_acc_steps 4,
   micro_acc_steps TRAIN_MICRO, lr_warmup_steps 0) on the 25-layer random
   LLaMA-3-8B-width subject (bf16, flash attention, layers.24), reading a
   uint32 `MemmapDataset`: eight batches (two optimizer steps, b_dec from
   the geometric median), `save` and `load_state` into a fresh trainer
   (parameters, moments, counters equal bit for bit), one batch on the
   resumed trainer and one with AuxK (half the latents made dead,
   micro_acc_steps AUXK_MICRO); checks finite losses, unit decoder rows
   after `accumulate`, the projected gradient orthogonal to the rows, the
   counters against the window's fired mask and K1's launches; times
   tokens/s, one batch's stages (CUDA events) and the peak memory; then
   the card's `accumulate` against the CPU's (d 4,096, 16,384 latents,
   1,024 tokens on an exact grid: equal masks, gradients within
   TRAIN_CPU_L2_REL), `forward(fast=False)` and its backward against the
   fast path at full width on 4,096 tokens (a counted run: K1, K2's decode
   and dvals modes), and K2's dvals mode against its plain version (equal
   bits twice, timed beside its bound);
   dp_train_path: `SaeTrainer` data-parallel as two gloo ranks sharing the
   card (`--rank dp_train`): the subject cut to DP_TRAIN_LAYERS layers
   (hookpoint DP_TRAIN_HOOK), 131,072 latents, k = 256, AuxK, dead
   threshold 0, DP_TRAIN_ROWS x 2,048 ids a rank a batch,
   DP_TRAIN_BATCHES batches, grad_acc_steps 2, each rank its contiguous
   shard, rank 0 saving between barriers; against one trainer in this process over the same global
   batches (rank 0's rows, then rank 1's): the parameters within
   DP_TRAIN_UPDATE_REL, `opt_step` equal, the counters equal once the
   ranks' are doubled; per rank the gradient all-reduce's ms a step (gloo
   stages CUDA tensors through the host), tokens/s, peak memory and
   launches;
9. image_cache_path: a random LLaVA-NeXT at llama3-llava-next-8b's widths
   (CLIP-L/336 tower, projector, LLaMA-3-8B text cut to the 25 layers
   model.layers.24 reads; bf16, flash attention) feeding the 131,072-latent
   SAE (saved, read back) through `FeatureImageCache` (BOS dropped, streaming
   splits, 128 of them) over 4 batches of 4 images of 480 x 640 (2,341
   tokens a row) and one of 4 geometries right-padded to 2,929, prepared
   here with seeded pixels (one array per image, so the tower runs once per
   image); checks the row lengths, the launch counts, the splits and their
   `.featidx` sidecars, every cached row against an independent top-k of
   its hidden (captured again after the counted run), and each image of the
   mixed batch alone against its padded row (equal bits); prints smoke
   readings of images/s, tokens/s and peak memory over the five batches,
   and one batch's stages (CUDA events);
10. clip_path: full CLIP (`models/clip_full.py`) at
   openai/clip-vit-base-patch16's widths with random fp32 weights, 64
   seeded pixel arrays and 64 id rows: ms per image and per text, 8 of each
   against the CPU within CLIP_L2_REL, the scores against max(0, 100 cos)
   of the embeddings in float64; no kernel launched;
11. steering_path, after the stats phase, on the attribution phase's
   subject and SAE: `SteeringController` (stub chat template: LLaMA-3's
   headers around 64 seeded ids, 74 tokens), 64 features in one chunk (16
   from the last prompt token's top-k, 48 seeded), clamp 50, 128 greedy
   tokens, counted; the same steered and baseline generates again with
   marks (prefill ms, decode ms a step, the prefill's and the decode
   steps' launches apart: K3 32 and K1 2, K2 1 per token chunk of the clamp
   in the prefill, nothing in a decode step), 8 features clamped at every
   step (16 tokens), a sampled run (temperature 0.6, top_p 0.9, 32 tokens);
   checks: each generated token against a cache-free forward's argmax
   wherever its top-2 gap exceeds STEER_NEAR_TIE (baseline, steered and
   every-step rows), 4 features steered alone against their batched rows
   up to the first near tie, one token chunk of the clamp against its
   plain chain (K1's top-k as sets, K2's decode within an fp32 bound),
   and a reduced run (2 layers, fp32, 32 ids, 2 features, 16 tokens) on
   the card against the CPU, the CPU replaying the card's clamp
   selections; readings: 16 decode steps under torch.profiler, the decode
   step's bound, K3 at the prefill shape (64, 32, 8, 74, 128);
   image_steering_path, after the image cache phase: a random LLaVA-NeXT
   at llama3-llava-next-8b widths with all 32 text layers and the LM head,
   one 480 x 640 image (seeded pixels; `prepare_inputs` and the image
   loader are stood in for, as the card's machine has no PIL) and a short
   prompt (2,360 tokens), 8 features, 32 greedy tokens: the tower once per
   generate, the launch counts, the cache-free check, K3 at
   (8, 32, 8, 2,360, 128);
   image_train_path, on the image cache phase's 25-layer subject:
   `SaeTrainer` with a collator of this script over prepared rows
   (131,072 latents, k = 256, fp32, batch 4, grad_acc_steps 2), four
   batches of 480 x 640 images and two of the mixed geometries
   (right-padded to 2,929), AuxK on those two with half the latents dead;
   checks the row lengths, the launch counts, finite losses, the AuxK loss,
   the first window's dead-feature counters (8 planted dead latents at
   the window's collated positions, every other latent at 0), and the
   card's `accumulate` against the CPU's on 1,024 captured rows of a
   mixed batch (512 of them pad rows); expanded positions/s (what the
   trainer counts here, pads included; on the `--mm_data` route it counts
   un-expanded ids) and valid tokens/s over batches 3-6, host
   preprocessing excluded, one batch's stages, the peak;
   image_attribution_path, on the image steering phase's subject and SAE:
   `fast_attribution_maps` at model.layers.24 over one probe row (a 480 x
   640 image in the chat prompt, 2,358 tokens), 16 features at
   feature_batch 8 (8 from the last position's pool, 8 in no token's
   pool), the tower once, the launch counts, exact zeros outside, K2's
   decode and splice checks at this prompt; the fast path against the
   general path for 2 features (the general path replaying the fast
   path's selections); a ragged batch (that row and a 1,000 x 1,000 image
   row of 2,946 tokens, left-repacked) with exact zeros at the pads, each
   row equal bit for bit to the row alone with its pad, and the padded row
   against itself without pads, the batch's pool replayed (the hook's
   hidden state, the splice's gradient and the saliency within
   IMAGE_PAD_SHIFT_*; at 4 text layers in fp32 within
   IMAGE_PAD_SHIFT_FP32_REL, read in bf16 with K3 and eager); then K3's chain (forward with lse, backward) at
   the suffix's two shapes (8, 32, 8, 2,358, 128) and (8, 32, 8, 2,946,
   128) left-padded, against the plain pair and timed;
12. the int8 and module-sharded phases (models/quant.py,
   train/module_sharded.py): int8_cache_path, after nccl_path in the cache
   phase's directory: cache_path's subject quantised on the card leaf by
   leaf, its quantised leaves held bit for bit against a host quantisation,
   both quantised products at one layer's shapes against their plain
   versions (`check_qmatmul`: W8A8's int32 sums equal, padded rows and k
   included; W8A16 within W8A16_REL), then 2 batches in each of three modes
   (W8A16, W8A8, W8A8 with the SAE's encoder int8) through `FeatureCache`,
   the splits checked, the entries shared with cache_path's splits and the
   hidden state's error reported; int8_subject_path, after the steering
   phase: the attribution phase's subject and SAE in bf16, then quantised
   with W8A8 products, one `fast_attribution_maps` call (16 features) and a
   16-token greedy generate at batch 1 on each, the saliency correlations
   reported; module_sharded_train_path, after dp_train_path: `SaeTrainer`
   with `distribute_modules` as two gloo ranks sharing the card (layers.1
   and layers.3 of a 4-layer subject, one a rank, the full-width SAE with
   AuxK, the hidden states exchanged through pinned host memory) against
   one process training both on the same global batches, within
   MS_UPDATE_REL; int8_image_path, after K3's image attribution chains: the
   image cache phase's subject quantised (W8A16 tower), then with the
   tower's products W8A8, one batch of 4 images each;
13. tensor parallelism and the --dp replicas (parallel/): tp_cache_path,
   after nccl_path: the cache CLI's flow at --tp 2 as two gloo ranks
   sharing the card (`--rank tp_cache`; each rank cache_path's subject cut
   to its slices, 16 query and 4 KV heads, rank 0 writing), 2 batches of
   2 x 2,048 ids, against the unsharded subject on the same batches here:
   the hidden state at layers.24 within TP_HIDDEN_REL, at least TP_KEPT_MIN
   of its entries kept, the splits valid, per rank the launches, the
   collectives, tokens/s, one all-reduce's ms and the peak;
   dp_replicas_path, after it: the cache CLI's flow at --dp 2 with both
   replicas on this card, against one card at the same batch size (equal
   bytes) and at twice it (whether it differs from the first; if so at
   least DP_KEPT_MIN of its entries kept, within DP_VALUE_REL), then
   training capture at --dp 2 (each replica's rows equal to the rows
   captured alone, the update within DP_TRAIN_UPDATE_REL of one card's);
   tp_subject_path, after int8_subject_path: the 32-layer subject with its
   LM head at --tp 2 (`--rank tp_subject`): `fast_attribution_maps` at
   layers.24 for one chunk of 8 features on the 2,432-token prompt and a
   16-token greedy generate, against the unsharded subject here (each
   feature's saliency, on the ranks' prefix, within TP_SALIENCY_REL of the
   largest feature's norm, and on its own prefix reported; each generated
   token the cache-free forward's argmax wherever the top-2 gap exceeds
   STEER_NEAR_TIE), the collectives counted; then K3's
   chain at the suffix's per-rank shape (8, 16, 4, 2,432, 128) and its
   forward at tp_cache_path's (2, 16, 4, 2,048, 128), each against the
   plain version and timed beside its bound and SDPA; tp_train_path, after
   module_sharded_train_path: `SaeTrainer.fit` at --tp 2 (`--rank
   tp_train`) on dp_train_path's 4-layer subject with the full-width SAE
   and AuxK, under MMSAE_PROFILE_DIR, against one trainer here on the
   hidden states rank 0 trained on (the update within DP_TRAIN_UPDATE_REL)
   and one on the unsharded subject (reported), each rank's trace naming
   K1's and K3's kernels;
14. the researcher tools (`multimodal_sae_tpu_torch/tools/`), each
   tool's core timed and its launches counted: tools_path, after
   steering_path on its subject and SAE: model_steering's `steer` on one
   feature (the last prompt token's largest latent, clamp 10, TOOLS_NEW
   tokens a generate), equal bit for bit to direct generates without and
   with the same `clamp_features_max` intervention; probe_activations'
   `probe` on the attribution prompt (2,432 ids), its top 10 and their
   columns against float64 on the host (PROBE_*); text_activation_vis'
   `feature_activations` for 16 features on that prompt, every written
   activation equal to the encode's value and the page parsed;
   image_tools_path, after image_attribution_path on its subject and SAE:
   create_filters_from_attribution's `create_filters` on that phase's
   saliency maps (no PNGs) against float64 pools, and `probe` on an
   image-only prompt of one 480 x 640 image, against float64; the launches
   a tool (K3, K1, K2's decode) and the peak in `tools_summary`;
15. `--remat` and `--distribute_modules` under `--tp` (slice 13):
   remat_attribution_path, after general_attribution_path on its subject,
   SAE and prompt: one flash chunk of the last position's 8 pool features
   without and with `--remat` (equal bits, K3's forward 7 and 14 times,
   its backward 7 each; ms and peak of each), eager attention at fb 8 with
   remat in one chunk against fb 2 without within ATTRIBUTION_L2_REL (the
   no-remat fb 8 peak reckoned from fb 2's), and one general feature each
   way (equal bits, K3's forward 64 and 71); remat_attribution_path_image_row,
   after image_tools_path: the image probe row's chunk each way, equal
   bits; tp_module_sharded_train_path, after tp_train_path: `SaeTrainer` at
   --tp 2 with `distribute_modules` as two gloo ranks (`--rank
   tp_module_train`) on module_sharded_train_path's subject and hookpoints
   with the full-width SAE and AuxK, each rank one hookpoint, its SAE
   equal bit for bit to the flagless --tp 2 trainer's, tokens/s and the
   peak a rank;
16. a `kernels` JSON line, the card line, and the result line.

Needs one CUDA card; exits non-zero without one.  Imports nothing of JAX.
Every rank process has a timeout (DP_PROC_TIMEOUT_S) and so does every
process group; a rank that fails or hangs fails the run.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
INT8_OPS = 1979e12  # dense int8 tensor-core peak, H100 SXM data sheet
FP32_FMAS = 33.5e12  # 67 TFLOP/s fp32 on the CUDA cores, H100 SXM data sheet
K3_ATOL = 2e-2
K3_RTOL = 2e-2
# K3 tolerance, |kernel - plain| <= atol + rtol * |plain|: both outputs are
# bf16 (one ulp is 2^-8 relative) and the kernel rounds the softmax weights
# to bf16 before the PV product (2^-9 relative each); the plain version keeps
# them in fp32.  The outputs are averages of N(0, 1) values, |o| < ~4.
K3_LSE_ATOL = 1e-4
# K3 logsumexp tolerance, |kernel - plain| <= 1e-4 on rows with a valid key
# (+inf on both sides on rows without one): each logit sums hd = 128 exact
# products of bf16 values in fp32, which the two sum in different orders
# (at most 128 * 2^-24 * sum |qs * k|, about 5e-5 here where the sum is
# about 7); a logsumexp moves by at most its logits' largest error, plus a
# few fp32 ulps of |lse| < 10 from exp2/log2 against exp/log.
K3_BWD_MAX_REL = 2e-2
K3_BWD_L2_REL = 1e-2
# K3 backward tolerance, per gradient: max |kernel - plain| <= 2e-2 * max
# |plain| and ||kernel - plain|| <= 1e-2 * ||plain||.  The outputs are bf16
# (2^-9 relative rounding), dk and dv of a kv head sum 4 query heads in bf16
# products, and the kernel rounds P and dS to bf16 as the A operand of the
# products that consume them (2^-9 relative a term) where the plain version
# keeps fp32; the sums run over up to 2,432 queries or keys.  Each side
# starts from its own forward: the kernel's o and lse against the plain
# version's, so a fault in the forward's lse shows here.
K3_BWD_ZERO = 1e-3
# A gradient that is 0 in exact arithmetic is held to max |kernel| <= 1e-3
# instead: at S = 1 the one key's P is 1, so dS = dP - D, two fp32 sums of
# the same 128 products of bf16 values (|do . v| < ~40 here) in different
# orders, and dq and dk are that rounding (under 1e-4) times k or qs; the
# plain version's are rounding too, so a relative bound would compare noise
# with noise.  Every other gradient here has max |plain| > 1.
TRAIN_MICRO = 1
AUXK_MICRO = 1
# micro_acc_steps of the training batches and of the AuxK batch: the least
# that fits (train_memory.py on an NVIDIA H100 80GB HBM3 at 700 W: peak
# 61.3 GB at 1 and 46.9 GB at 2 without AuxK, 72.5 GB at 1 with it).
UNIT_NORM_TOL = 1e-5
# Decoder rows after `accumulate`'s renorm: max |‖row‖ - 1| <= 1e-5 (each
# row is divided by its fp32 norm + eps, a few ulps from 1).
ORTHO_REL = 5e-4
# The projected decoder gradient g' against the unit rows w:
# max |g'_l . w_l| <= 5e-4 * max ‖g'_l‖.  Both the projection's dot and
# this one are fp32 sums of d = 4,096 products, each within d * 2^-24 =
# 2.4e-4 relative of exact.
TRAIN_CPU_L2_REL = 1e-4
# The card's `accumulate` against the CPU's on one chunk: every gradient
# within relative L2 1e-4 (fp32 matmuls and reductions summed in other
# orders; the renormalised decoders differ by ulps).  The inputs lie on a
# grid on which the encoder's products and sums are exact, so both sides'
# pre-activations, and with them every selection mask, are equal bit for bit.
FAST_SLOW_REL = 1e-4
# forward(fast=False) against the fast path on one full-width chunk: fvu
# within 1e-4 relative and each gradient within relative L2 1e-4 (the same
# selection, decoded and differentiated by other fp32 sums).
STATS_ATOL = 1e-5
# Neighbour cosines against float64 on the card: |fp32 - float64| <= 1e-5
# (each is an fp32 dot of two unit rows of d = 4,096, within about
# d * 2^-24 = 2.4e-4 in the worst case and ~1e-6 in practice).
STATS_NEAR_TIE = 2e-5
# A neighbour or top token may differ from the float64 order only where the
# two candidates' float64 values lie within 2e-5 (twice STATS_ATOL).
PCA_ORTHO = 1e-5
PCA_EV_REL = 1e-4
# PCA's two components: orthonormal within 1e-5; the variance along each
# (a float64 Rayleigh quotient of the decoder's covariance) within 1e-4
# relative of the covariance's top two eigenvalues (float64 eigvalsh).
LOADER_WORKERS = 4
ATTRIBUTION_L2_REL = 1e-3
# Fast against general attribution, ||fast - general|| <= 1e-3 * ||general||
# per feature: the two select the same top-k in the same order, decode it
# with the same deterministic kernel and run the same kernels row by row, so
# they can differ only where a library matmul picks another reduction order
# for another row count (F * B rows against B); one bf16 ulp (2^-8) at a few
# scattered elements stays well under the bound.


GENERAL_CPU_L2_REL = 1e-3
# The two-hookpoint general path on the card against the same call on the
# CPU at reduced depth (4 layers, 256 tokens, full widths), both fp32 with
# eager attention (K3 takes bf16 only; it is held to its plain version at
# the full run's shapes), the CPU taking the card's top-k selection at every
# splice: ||card - cpu|| <= 1e-3 * ||cpu|| per hook.  Each side sums its
# fp32 products in its own order (about 1e-6 relative apart).  The feature
# outside every top-k is exactly 0 at both hooks on both sides.
GENERAL_NEAR_TIE = 1e-4
# Where the CPU's own top-k would select another set than the card's, the
# card's weakest pick must lie within 1e-4 relative of the CPU's own k-th
# latent: a tie within the sides' fp32 noise (about 1e-6 relative, 1e-5 at
# the most), not a wrong latent.
CLIP_L2_REL = 1e-4
# CLIP embeddings on the card against the same call on the CPU, per row:
# ||card - cpu|| <= 1e-4 * ||cpu||.  Both run in fp32 (TF32 off), 12 layers
# of fp32 sums in other orders, each about 1e-6 relative apart.
CLIP_SCORE_ATOL = 1e-3
# The card's scores against max(0, 100 * cos) of its own embeddings taken
# in float64: within 1e-3 on the 0-100 scale (fp32 norms and a 512-term dot).


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device milliseconds per call, from CUDA events around `iters`
    calls after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_repeats(fn, repeats: int = 5) -> dict:
    """Median, min and max of `repeats` calls of time_ms(fn), and them all."""
    ts = sorted(time_ms(fn) for _ in range(repeats))
    return {"median": ts[len(ts) // 2], "min": ts[0], "max": ts[-1], "all": ts}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def _counted_modules():
    from multimodal_sae_tpu_torch.ops import block_max, flash_attention, gather_rows, sae_encode

    return {
        "block_max": (block_max, "launches"),
        "flash_attention": (flash_attention, "launches"),
        "flash_attention_bwd_delta": (flash_attention, "bwd_delta_launches"),
        "flash_attention_bwd_dkdv": (flash_attention, "bwd_dkdv_launches"),
        "flash_attention_bwd_dq": (flash_attention, "bwd_dq_launches"),
        "gather_rows": (gather_rows, "launches"),
        "splice_decode": (gather_rows, "splice_launches"),
        "decode_dvals": (gather_rows, "dvals_launches"),
        "sae_encode": (sae_encode, "launches"),
    }


def reset_kernel_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for module, attr in _counted_modules().values():
        setattr(module, attr, 0)


def kernel_counts() -> dict:
    return {name: getattr(module, attr) for name, (module, attr) in _counted_modules().items()}


def phase_build() -> str:
    from multimodal_sae_tpu_torch import kernels

    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    logs = kernels.build()
    build_s = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas[{name}]: {line.strip()}")
    emit({"phase": "build", "card": card, "build_s": build_s, "built": sorted(logs)})
    return card


def _bits_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Raise unless bit-equal outside NaNs with NaN at the same places;
    returns the max |a - b| (0.0)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    ib = torch.int32 if a.dtype == torch.float32 else torch.int16
    if not (torch.equal(na, nb) and torch.equal(a.view(ib)[~na], b.view(ib)[~nb])):
        raise AssertionError("block_max differs from its plain version")
    return (a.float()[~na] - b.float()[~nb]).abs().max().item()


def phase_block_max(dev) -> dict:
    """K1 at the main path's two filter levels (level 1 over the 131,072
    latents at block 64, level 2 over the 16,384 candidates at block 8, fp32),
    for the text cache's 8 x 2,048 tokens, the image cache's 9,360 (4
    images of 2,341 tokens less the BOS), one attribution prompt's 2,432
    (each splice's top-k on the general path) and the image training
    batches' 9,364 (4 x 2,341) and 11,716 (4 x 2,929, pads included), and
    at bf16 block 128."""
    from multimodal_sae_tpu_torch.ops import block_max as bm

    gen = torch.Generator(device=dev).manual_seed(1)
    zero = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    per_step = {step: dict(zero) for step in ("text", "image", "prompt", "train_uniform", "train_mixed")}
    max_abs_err = 0.0
    for n, w, block, dtype, step in (
        (16384, 131072, 64, torch.float32, "text"),
        (16384, 16384, 8, torch.float32, "text"),
        (9360, 131072, 64, torch.float32, "image"),
        (9360, 16384, 8, torch.float32, "image"),
        (2432, 131072, 64, torch.float32, "prompt"),
        (2432, 16384, 8, torch.float32, "prompt"),
        (9364, 131072, 64, torch.float32, "train_uniform"),
        (9364, 16384, 8, torch.float32, "train_uniform"),
        (11716, 131072, 64, torch.float32, "train_mixed"),
        (11716, 16384, 8, torch.float32, "train_mixed"),
        (4096, 131072, 128, torch.bfloat16, None),
    ):
        x = torch.randn(n, w, generator=gen, device=dev, dtype=torch.float32).to(dtype)
        x[1, 5] = float("nan")
        x[2, :block] = float("-inf")
        got = bm.block_max(x, block)
        ref = bm.block_max_plain(x, block)
        torch.cuda.synchronize()
        err = _bits_err(got, ref)
        if not torch.isnan(got[1, 0]) or got[2, 0] != float("-inf"):
            raise AssertionError("block_max lost a NaN or an -inf block")
        kernel_ms = time_ms(lambda: bm.block_max(x, block))
        plain_ms = time_ms(lambda: bm.block_max_plain(x, block))
        library_ms = time_ms(lambda: torch.amax(x.view(n, w // block, block), dim=-1))
        bound_ms = (n * w + n * w // block) * x.element_size() / HBM_BYTES_PER_S * 1e3
        emit({
            "phase": "block_max", "shape": [n, w], "block": block,
            "dtype": str(dtype).replace("torch.", ""), "bitexact": True,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
        })
        if step is not None:  # a main path's two calls per step
            for key, val in (("ms", kernel_ms), ("plain_ms", plain_ms),
                             ("library_ms", library_ms), ("bound_ms", bound_ms)):
                per_step[step][key] += val
        max_abs_err = max(max_abs_err, err)
        del x, got, ref
    for block in bm.BLOCKS:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(64, 16384, generator=gen, device=dev, dtype=torch.float32).to(dtype)
            x[3, 1000] = float("nan")
            _bits_err(bm.block_max(x, block), bm.block_max_plain(x, block))
    emit({"phase": "block_max_blocks", "shape": [64, 16384], "blocks": list(bm.BLOCKS),
          "dtypes": ["float32", "bfloat16"], "bitexact": True})
    torch.cuda.empty_cache()
    return {**per_step["text"], "max_abs_err": max_abs_err, "image_step": per_step["image"],
            "prompt_step": per_step["prompt"],
            "image_train_steps": {"uniform": per_step["train_uniform"], "mixed": per_step["train_mixed"]}}


def _check_attention(fa, q, k, v, pad_mask, scale, what) -> float:
    got = fa.flash_attention(q, k, v, pad_mask, scale)
    ref = fa.flash_attention_plain(q, k, v, pad_mask, scale)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"flash_attention gave non-finite output at {what}")
    err = (got.float() - ref.float()).abs()
    if not bool((err <= K3_ATOL + K3_RTOL * ref.float().abs()).all()):
        raise AssertionError(f"flash_attention off by {err.max().item()} at {what}")
    return err.max().item()


def phase_flash_attention(dev) -> dict:
    """K3 at LLaMA-3-8B's attention shape on the main path (B=8, H=32,
    kvH=8, S=2048, hd=128, bf16), unmasked (the main path's call) and with
    row 0 left-padded by 100; then the image cache's two shapes (uniform,
    and right-padded); then edge shapes, left- and right-padded, all rows
    compared."""
    import torch.nn.functional as F

    from multimodal_sae_tpu_torch.ops import flash_attention as fa

    B, H, kvH, S, hd = 8, 32, 8, 2048, 128
    scale = hd ** -0.5
    gen = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn(B, H, S, hd, generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn(B, kvH, S, hd, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(B, kvH, S, hd, generator=gen, device=dev).to(torch.bfloat16)
    kr = k.repeat_interleave(H // kvH, dim=1)
    vr = v.repeat_interleave(H // kvH, dim=1)
    result = {"max_abs_err": 0.0}
    for padded in (False, True):
        pad_mask, real = None, torch.ones(B, S, dtype=torch.bool, device=dev)
        sdpa_mask = None
        if padded:
            real[0, :100] = False
            pad_mask = real.to(torch.int32)
            sdpa_mask = torch.ones(S, S, dtype=torch.bool, device=dev).tril() & real[:, None, None, :]
            sdpa_mask[0, :, :100, 0] = True  # SDPA needs a key per row; timing only
        err = _check_attention(fa, q, k, v, pad_mask, scale, f"main shape, padded={padded}")
        # The work this data needs: causal (query, key) pairs with a valid
        # key, 4 * hd operations each (QK^T and PV); q, k, v read, o written.
        pairs = torch.tril(torch.ones(S, S, device=dev))[None] * real[:, None, :].float()
        flops = 4.0 * hd * H * pairs.sum().item()
        nbytes = (2 * B * H * S * hd + 2 * B * kvH * S * hd) * 2
        repeats = time_repeats(lambda: fa.flash_attention(q, k, v, pad_mask, scale))
        line = {
            "phase": "flash_attention", "shape": [B, H, kvH, S, hd], "padded": padded,
            "max_abs_err": err, "atol": K3_ATOL, "rtol": K3_RTOL,
            "kernel_ms": repeats["median"], "kernel_ms_repeats": repeats,
            "tflops": flops / repeats["median"] / 1e9,
            "plain_ms": time_ms(lambda: fa.flash_attention_plain(q, k, v, pad_mask, scale), iters=3),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q, kr, vr, attn_mask=sdpa_mask, is_causal=sdpa_mask is None, scale=scale)),
            "bound_ms": max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3,
            "bound_by": "operations" if flops / BF16_FLOPS > nbytes / HBM_BYTES_PER_S else "bytes",
        }
        if not padded:
            line["resources"] = {hd_: fa.fwd_resources(hd_) for hd_ in (128, 64)}
        emit(line)
        result["max_abs_err"] = max(result["max_abs_err"], err)
        if not padded:
            result.update({key: line[key] for key in ("plain_ms", "library_ms", "bound_ms", "bound_by")})
            result["ms"] = line["kernel_ms"]
    del q, k, v, kr, vr
    torch.cuda.empty_cache()
    # The image cache's two shapes: a uniform batch of 4 images of 2,341
    # tokens (no mask), and the mixed batch of 4 geometries right-padded to
    # 2,929 (valid lengths 2,341, 1,177, 2,329 and 2,929).
    result["image_shapes"] = [
        _attention_case(fa, gen, dev, 4, 32, 8, 2341, 128, None),
        _attention_case(fa, gen, dev, 4, 32, 8, 2929, 128, [2341, 1177, 2329, 2929]),
    ]
    result["max_abs_err"] = max([result["max_abs_err"]] + [c["max_abs_err"] for c in result["image_shapes"]])
    # Edges: one token, ragged tiles, kvH = H and kvH = 1, hd 64, rows of
    # pads only, pad queries past one 64-row tile; then right pads (valid
    # lengths) that end inside a 64-key tile.
    edges = ((1, 2, 2, 1, 128, None), (2, 4, 1, 65, 128, [0, 30]), (1, 8, 2, 130, 64, [129]),
             (3, 4, 4, 64, 128, [0, 63, 10]), (2, 2, 1, 17, 64, [17, 3]), (1, 4, 2, 300, 128, [150]))
    right_edges = ((3, 4, 2, 150, 128, [100, 150, 37]), (2, 8, 2, 200, 64, [130, 75]))
    right_err = 0.0
    for B_, H_, kvH_, S_, hd_, pads in edges + right_edges:
        q = torch.randn(B_, H_, S_, hd_, generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn(B_, kvH_, S_, hd_, generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn(B_, kvH_, S_, hd_, generator=gen, device=dev).to(torch.bfloat16)
        pad_mask = None
        if pads is not None:
            bound = torch.tensor(pads, device=dev)[:, None]
            pos = torch.arange(S_, device=dev)[None, :]
            pad_mask = (pos < bound if (B_, H_, kvH_, S_, hd_, pads) in right_edges else pos >= bound).int()
        err = _check_attention(fa, q, k, v, pad_mask, hd_ ** -0.5, (B_, H_, kvH_, S_, hd_, pads))
        result["max_abs_err"] = max(result["max_abs_err"], err)
        if (B_, H_, kvH_, S_, hd_, pads) in right_edges:
            right_err = max(right_err, err)
    result["right_pad_edges_max_abs_err"] = right_err
    emit({"phase": "flash_attention_edges", "cases": [list(e[:5]) for e in edges],
          "right_pad_cases": [list(e) for e in right_edges], "right_pad_max_abs_err": right_err,
          "max_abs_err": result["max_abs_err"], "atol": K3_ATOL, "rtol": K3_RTOL})
    torch.cuda.empty_cache()
    return result


def _attention_case(fa, gen, dev, B, H, kvH, S, hd, valid, phase: str = "flash_attention_image") -> dict:
    """K3 at one shape against its plain version on every row (pad queries
    included), timed (median of 5 repeats) beside its bound, the plain
    version and SDPA; `valid` gives each row's valid length (right pads), or
    None for no mask.  The line is emitted under `phase`."""
    import torch.nn.functional as F

    scale = hd ** -0.5
    q = torch.randn(B, H, S, hd, generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn(B, kvH, S, hd, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(B, kvH, S, hd, generator=gen, device=dev).to(torch.bfloat16)
    real = torch.ones(B, S, dtype=torch.bool, device=dev)
    pad_mask = sdpa_mask = None
    if valid is not None:
        real = torch.arange(S, device=dev)[None, :] < torch.tensor(valid, device=dev)[:, None]
        pad_mask = real.to(torch.int32)
        sdpa_mask = torch.ones(S, S, dtype=torch.bool, device=dev).tril() & real[:, None, None, :]
    what = f"({B}, {H}, {kvH}, {S}, {hd}), valid lengths {valid}"
    err = _check_attention(fa, q, k, v, pad_mask, scale, what)
    torch.cuda.empty_cache()
    # The work this data needs: causal (query, key) pairs with a valid key,
    # 4 * hd operations each; q, k, v read, o written.
    pairs = (torch.tril(torch.ones(S, S, device=dev))[None] * real[:, None, :].float()).sum().item()
    flops = 4.0 * hd * H * pairs
    nbytes = (2 * B * H * S * hd + 2 * B * kvH * S * hd) * 2
    repeats = time_repeats(lambda: fa.flash_attention(q, k, v, pad_mask, scale))
    line = {
        "phase": phase, "shape": [B, H, kvH, S, hd], "valid_lengths": valid,
        "max_abs_err": err, "atol": K3_ATOL, "rtol": K3_RTOL,
        "ms": repeats["median"], "kernel_ms_repeats": repeats, "tflops": flops / repeats["median"] / 1e9,
        "plain_ms": time_ms(lambda: fa.flash_attention_plain(q, k, v, pad_mask, scale), iters=2, warmup=1),
        "bound_ms": max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3,
        "bound_by": "operations" if flops / BF16_FLOPS > nbytes / HBM_BYTES_PER_S else "bytes",
    }
    if sdpa_mask is None:
        line["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale, enable_gqa=True))
    else:  # SDPA's masked kernels take k and v repeated to H heads
        kr, vr = (t.repeat_interleave(H // kvH, dim=1) for t in (k, v))
        line["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            q, kr, vr, attn_mask=sdpa_mask, scale=scale))
        del kr, vr
    emit(line)
    del q, k, v, sdpa_mask
    torch.cuda.empty_cache()
    return {key: val for key, val in line.items() if key not in ("phase", "kernel_ms_repeats", "atol", "rtol")}


def _grad_errors(got: torch.Tensor, ref: torch.Tensor, what: str) -> dict:
    """Hold one gradient of the K3 backward against its plain version (a
    gradient that is 0 in exact arithmetic against K3_BWD_ZERO)."""
    if not torch.isfinite(got).all():
        raise AssertionError(f"flash_attention_bwd gave non-finite {what}")
    diff = got.float() - ref.float()
    out = {"max_abs_err": diff.abs().max().item(), "max_abs_plain": ref.float().abs().max().item()}
    if out["max_abs_plain"] <= K3_BWD_ZERO:
        out["max_abs_kernel"] = got.float().abs().max().item()
        if not out["max_abs_kernel"] <= K3_BWD_ZERO:
            raise AssertionError(f"flash_attention_bwd {what} off: {out}, 0 expected")
        return out
    out["l2_rel"] = (diff.norm() / ref.float().norm()).item()
    if not (out["max_abs_err"] <= K3_BWD_MAX_REL * out["max_abs_plain"] and out["l2_rel"] <= K3_BWD_L2_REL):
        raise AssertionError(f"flash_attention_bwd {what} off: {out}")
    return out


def _check_bwd_chain(fa, q, k, v, pad_mask, do, scale, what) -> dict:
    """The kernels' chain (forward with lse, then the backward on its o and
    lse) against the plain pair's, each from its own forward; a second
    backward on the same inputs must give the same bits, and dq must be
    exactly 0 on rows without a valid key."""
    o, lse = fa.flash_attention_fwd(q, k, v, pad_mask, scale, need_lse=True)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, pad_mask, scale)
    torch.cuda.synchronize()
    lse_err = _check_lse(lse, lse_ref, what)
    o_err = (o.float() - o_ref.float()).abs()
    if not bool((o_err <= K3_ATOL + K3_RTOL * o_ref.float().abs()).all()):
        raise AssertionError(f"flash_attention off by {o_err.max().item()} at {what}")
    got = fa.flash_attention_bwd(q, k, v, pad_mask, o, lse, do, scale)
    again = fa.flash_attention_bwd(q, k, v, pad_mask, o, lse, do, scale)
    ref = fa.flash_attention_bwd_plain(q, k, v, pad_mask, o_ref, lse_ref, do, scale)
    torch.cuda.synchronize()
    errors = {name: _grad_errors(a, b, f"{name} at {what}") for name, a, b in zip(("dq", "dk", "dv"), got, ref)}
    if not all(torch.equal(a.view(torch.int16), b.view(torch.int16)) for a, b in zip(got, again)):
        raise AssertionError(f"flash_attention_bwd: two calls differ at {what}")
    no_key = torch.isinf(lse)  # (B, H, S): rows without a valid key
    if bool(got[0][no_key].any()):
        raise AssertionError(f"flash_attention_bwd: dq not 0 on rows without a valid key at {what}")
    return {"lse_max_abs_err": lse_err, "lse_inf_rows": int(no_key.sum()), "o_max_abs_err": o_err.max().item(),
            "errors": errors, "deterministic": True}


def _check_lse(got: torch.Tensor, ref: torch.Tensor, what: str) -> float:
    """Hold the forward's logsumexp against the plain version's: +inf at the
    same rows (those without a valid key), within K3_LSE_ATOL elsewhere."""
    inf = torch.isinf(ref)
    if torch.isnan(got).any() or not torch.equal(torch.isinf(got), inf) or bool((got[inf] < 0).any()):
        raise AssertionError(f"flash_attention lse: non-finite rows differ from the plain version's at {what}")
    err = (got[~inf] - ref[~inf]).abs().max().item()
    if not err <= K3_LSE_ATOL:
        raise AssertionError(f"flash_attention lse off by {err} at {what}")
    return err


def phase_flash_attention_bwd(dev) -> dict:
    """The K3 forward and backward at the attribution suffix's attention
    shape (H=32, kvH=8, S=2,432, hd=128, bf16): the kernels' chain (forward
    with lse, then backward on its o and lse) against the plain pair's at
    B=2 (the plain versions build (B, 32, S, S) fp32 tensors), unmasked and
    with row 0 left-padded by 300; then timed at B=8, the suffix's feature
    chunk."""
    from multimodal_sae_tpu_torch.ops import flash_attention as fa

    H, kvH, S, hd = 32, 8, 2432, 128
    scale = hd ** -0.5
    gen = torch.Generator(device=dev).manual_seed(3)

    def inputs(B):
        q = torch.randn(B, H, S, hd, generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn(B, kvH, S, hd, generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn(B, kvH, S, hd, generator=gen, device=dev).to(torch.bfloat16)
        do = torch.randn(B, H, S, hd, generator=gen, device=dev).to(torch.bfloat16)
        return q, k, v, do

    result = {"max_abs_err": 0.0}
    q, k, v, do = inputs(2)
    for pad in (0, 300):
        pad_mask, do_ = None, do
        if pad:
            real = torch.ones(2, S, dtype=torch.bool, device=dev)
            real[0, :pad] = False
            pad_mask = real.to(torch.int32)
            # Rows without a valid key (row 0's leading pads) are read by no
            # caller, so their dO is 0 on every path; the kernel's contract
            # (dq = 0 there, nothing added to dk, dv) holds the plain
            # version's only under that condition.
            do_ = do * real[:, None, :, None]
        line = _check_bwd_chain(fa, q, k, v, pad_mask, do_, scale, f"(2, {H}, {kvH}, {S}, {hd}), left pad {pad}")
        result["max_abs_err"] = max([result["max_abs_err"]] + [e["max_abs_err"] for e in line["errors"].values()])
        emit({"phase": "flash_attention_bwd_check", "shape": [2, H, kvH, S, hd], "left_pad_row0": pad, **line,
              "lse_atol": K3_LSE_ATOL, "max_rel": K3_BWD_MAX_REL, "l2_rel": K3_BWD_L2_REL})
        torch.cuda.empty_cache()
    del q, k, v, do
    torch.cuda.empty_cache()

    # Edges: one token, ragged tiles (17, 65, 130, 300), kvH = H and kvH = 1,
    # hd 64, left pads past one 64-row tile; dO zero on rows without a key.
    edges = ((1, 2, 2, 1, 128, None), (2, 4, 1, 17, 64, [0, 5]), (2, 4, 1, 65, 128, [0, 30]),
             (1, 8, 2, 130, 64, [100]), (2, 4, 4, 300, 128, [150, 0]), (1, 4, 2, 300, 64, None))
    edge_errors = {}
    for B_, H_, kvH_, S_, hd_, pads in edges:
        q_ = torch.randn(B_, H_, S_, hd_, generator=gen, device=dev).to(torch.bfloat16)
        k_ = torch.randn(B_, kvH_, S_, hd_, generator=gen, device=dev).to(torch.bfloat16)
        v_ = torch.randn(B_, kvH_, S_, hd_, generator=gen, device=dev).to(torch.bfloat16)
        do_ = torch.randn(B_, H_, S_, hd_, generator=gen, device=dev).to(torch.bfloat16)
        pad_mask = None
        if pads is not None:
            real = torch.arange(S_, device=dev)[None, :] >= torch.tensor(pads, device=dev)[:, None]
            pad_mask = real.int()
            do_ = do_ * real[:, None, :, None]
        what = str((B_, H_, kvH_, S_, hd_, pads))
        line = _check_bwd_chain(fa, q_, k_, v_, pad_mask, do_, hd_ ** -0.5, what)
        edge_errors[what] = {name: e["max_abs_err"] for name, e in line["errors"].items()}
        result["max_abs_err"] = max([result["max_abs_err"]] + list(edge_errors[what].values()))
    emit({"phase": "flash_attention_bwd_edges", "max_abs_err": edge_errors, "deterministic": True,
          "max_rel": K3_BWD_MAX_REL, "l2_rel": K3_BWD_L2_REL, "zero_atol": K3_BWD_ZERO})

    B = 8
    q, k, v, do = inputs(B)
    o, lse = fa.flash_attention_fwd(q, k, v, None, scale, need_lse=True)
    kernel_ms = time_ms(lambda: fa.flash_attention_bwd(q, k, v, None, o, lse, do, scale))
    forward = time_repeats(lambda: fa.flash_attention_fwd(q, k, v, None, scale, need_lse=True))
    forward_library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=scale, enable_gqa=True))
    delta, qs = fa.bwd_delta(q, o, do, scale)
    delta_ms = time_ms(lambda: fa.bwd_delta(q, o, do, scale))
    dkdv_ms = time_ms(lambda: fa.bwd_dkdv(qs, k, v, None, lse, do, delta))
    dq_ms = time_ms(lambda: fa.bwd_dq(qs, k, v, None, lse, do, delta, scale))
    plain_ms = time_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, None, o, lse, do, scale), iters=2, warmup=1)
    # SDPA's backward alone (its forward outside the timing) on the same
    # kvH = 8 tensors with enable_gqa, so it too sums dk and dv over each
    # group; and, for comparison, with k and v repeated to H heads (dk and
    # dv then left at H heads).
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg, is_causal=True, scale=scale, enable_gqa=True)
    library_ms = time_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True))
    kr = k.repeat_interleave(H // kvH, dim=1).requires_grad_()
    vr = v.repeat_interleave(H // kvH, dim=1).requires_grad_()
    out_r = torch.nn.functional.scaled_dot_product_attention(qg, kr, vr, is_causal=True, scale=scale)
    repeat_ms = time_ms(lambda: torch.autograd.grad(out_r, (qg, kr, vr), do, retain_graph=True))
    # The work: 5 products of 2 * hd operations per causal (query, key)
    # pair (the dK/dV kernel runs 4 of them, the dQ kernel 3); q, o, do, dq
    # and k, v, dk, dv moved once, lse read.  The forward: 2 products (4 * hd
    # per pair); q, k, v read, o and lse written.
    pairs = B * H * S * (S + 1) / 2
    nbytes = (4 * B * H * S * hd + 4 * B * kvH * S * hd) * 2 + B * H * S * 4
    flops = 10 * hd * pairs
    bound_ms = max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
    fwd_flops = 4 * hd * pairs
    fwd_bytes = (2 * B * H * S * hd + 2 * B * kvH * S * hd) * 2 + B * H * S * 4
    line = {
        "phase": "flash_attention_bwd", "shape": [B, H, kvH, S, hd], "kernel_ms": kernel_ms,
        "delta_ms": delta_ms, "dkdv_ms": dkdv_ms, "dq_ms": dq_ms,
        "plain_ms": plain_ms, "library_ms": library_ms, "library_repeat_kv_ms": repeat_ms,
        "bound_ms": bound_ms, "bound_by": "operations" if flops / BF16_FLOPS > nbytes / HBM_BYTES_PER_S else "bytes",
        # The D pass reads q, o and do and writes qs and delta.
        "delta_bound_ms": (4 * B * H * S * hd * 2 + B * H * S * 4) / HBM_BYTES_PER_S * 1e3,
        "dkdv_bound_ms": 8 * hd * pairs / BF16_FLOPS * 1e3, "dq_bound_ms": 6 * hd * pairs / BF16_FLOPS * 1e3,
        "tflops": flops / kernel_ms / 1e9,
        "dkdv_tflops": 8 * hd * pairs / dkdv_ms / 1e9, "dq_tflops": 6 * hd * pairs / dq_ms / 1e9,
        "resources": fa.bwd_resources(hd),
        "forward_with_lse_ms": forward["median"], "forward_with_lse_ms_repeats": forward,
        "forward_with_lse_tflops": fwd_flops / forward["median"] / 1e9,
        "forward_with_lse_library_ms": forward_library_ms,
        "forward_with_lse_bound_ms": max(fwd_flops / BF16_FLOPS, fwd_bytes / HBM_BYTES_PER_S) * 1e3,
    }
    emit(line)
    del q, k, v, do, o, lse, delta, qs, qg, kg, vg, out, kr, vr, out_r
    torch.cuda.empty_cache()
    result.update({"ms": kernel_ms, **{key: line[key] for key in ("plain_ms", "library_ms", "bound_ms", "bound_by")}})
    return result


SAE_ENCODE_ROWS = (65536, 9412, 4096, 2432)
"""Rows of the split product's calls on the main path: a text cache batch
(32 x 2,048), an image cache batch (4 x 2,353, pads included), the steering
clamp's chunk and one attribution prompt."""
SAE_ENCODE_SLICE = 8192  # latents held against float64 at every row count
SAE_ENCODE_TOPK_ROWS = 2048  # rows whose top-k the kernel and the sgemm path must share
SAE_ENCODE_PLAIN_MAX_ROWS = 9412  # the plain version's two (rows, L) fp32 sums fit beside the rest


def _abs_errors(got: torch.Tensor, exact: torch.Tensor) -> dict:
    err = (got.double() - exact).abs()
    return {"max": err.max().item(), "mean": err.mean().item()}


def _topk_near_ties(got: torch.Tensor, lib: torch.Tensor, a: torch.Tensor, W: torch.Tensor, b_enc: torch.Tensor,
                    k: int, tol: float) -> dict:
    """The kernel's and the sgemm path's top-k of the same rows as sets;
    every latent in one set and not the other lies within `tol` of the
    row's float64 k-th value (a near-tie that rounding decides)."""
    from multimodal_sae_tpu_torch.ops import top_k

    ig = torch.sort(top_k(got, k, assume_finite=True)[1], dim=1).values
    il = torch.sort(top_k(lib, k, assume_finite=True)[1], dim=1).values
    differ = (ig != il).any(dim=1).nonzero().flatten()
    gap, swaps = 0.0, 0
    if differ.numel():
        exact = (a[differ].double() @ W.double() + b_enc.double()).relu_()
        kth = exact.topk(k, dim=1).values[:, -1:]
        for row, r in enumerate(differ.tolist()):
            left, right = set(ig[r].tolist()), set(il[r].tolist())
            swapped = torch.tensor(sorted(left ^ right), device=got.device)
            swaps += len(swapped)
            gap = max(gap, (exact[row, swapped] - kth[row]).abs().max().item())
    return {"rows": got.shape[0], "rows_differ": differ.numel(), "swapped_latents": swaps,
            "max_gap_to_kth": gap, "near_tie_tol": tol}


def phase_sae_encode(dev, d_in: int = 4096, L: int = 131072, row_counts=SAE_ENCODE_ROWS) -> dict:
    """The SAE encoder's split fp32 product (`ops/sae_encode.py`) at the
    released SAE shape (4,096 -> 131,072 latents, W_enc ~ U(+-1/64), bf16
    hiddens at a residual stream's scale with a few large channels) at
    every row count of SAE_ENCODE_ROWS: the kernel (split pass and product)
    timed beside both bounds, the split pass alone, the plain version (on
    every row up to SAE_ENCODE_PLAIN_MAX_ROWS, above it on the top-k slice
    of the same call's rows, `plain_rows`) and the library path (fp32
    sgemm, then add_ and relu_: `library_ms`); the max and mean absolute
    error of the kernel, the plain version and the sgemm path against
    float64 on SAE_ENCODE_SLICE latents (the kernel's and the plain
    version's no worse than twice the sgemm's), and the kernel's largest
    difference from the plain version on the same rows; the top-k of a
    seeded SAE_ENCODE_TOPK_ROWS-row slice equal to the sgemm path's but at
    near-ties; `launches` one higher a call.  `d_in`, `L` and `row_counts`
    shrink it for a rehearsal."""
    from multimodal_sae_tpu_torch.device import set_precision
    from multimodal_sae_tpu_torch.ops import sae_encode as se

    set_precision()
    gen = torch.Generator(device=dev).manual_seed(24)
    k, S = 256, min(SAE_ENCODE_SLICE, L)
    W = torch.empty(d_in, L, device=dev).uniform_(-1 / 64, 1 / 64, generator=gen)
    b_enc = torch.randn(L, generator=gen, device=dev) * 0.05
    b_dec = torch.randn(d_in, generator=gen, device=dev) * 0.2

    def library(x):
        return ((x.float() - b_dec) @ W).add_(b_enc).relu_()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    se.weight_planes(W)
    torch.cuda.synchronize()
    weight_split_s = time.perf_counter() - t0
    cases, failures = [], []
    with torch.no_grad():
        for rows in row_counts:
            x = torch.randn(rows, d_in, generator=gen, device=dev) * 3.0
            x[:, :8] *= 40.0
            x = x.to(torch.bfloat16)
            a = x.float() - b_dec
            exact = (a.double() @ W[:, :S].double() + b_enc[:S].double()).relu_()
            iters = 5 if rows > 16384 else 10
            case = {"rows": rows, "inputs_gb": torch.cuda.memory_allocated() / 1e9}
            n0 = se.launches
            got = se.encode(x, W, b_enc, b_dec)
            torch.cuda.synchronize()
            if se.launches != n0 + 1:
                raise AssertionError(f"sae_encode launches {se.launches - n0} in one call")
            case["allocated_gb"] = torch.cuda.memory_allocated() / 1e9
            if not math.isfinite(got.amax().item()):
                raise AssertionError(f"sae_encode gave non-finite output at {rows} rows")
            case["kernel_err"] = _abs_errors(got[:, :S], exact)
            r0 = int(torch.randint(0, rows - SAE_ENCODE_TOPK_ROWS + 1, (1,), generator=gen, device=dev)) \
                if rows > SAE_ENCODE_TOPK_ROWS else 0
            got_rows = got[r0:r0 + SAE_ENCODE_TOPK_ROWS].clone()
            del got
            # The plain version on the same call's rows: all of them up to
            # SAE_ENCODE_PLAIN_MAX_ROWS, above it the top-k slice.
            p0 = 0 if rows <= SAE_ENCODE_PLAIN_MAX_ROWS else r0
            p1 = rows if rows <= SAE_ENCODE_PLAIN_MAX_ROWS else r0 + SAE_ENCODE_TOPK_ROWS
            plain = se.encode_plain(x[p0:p1], W, b_enc, b_dec)
            case["plain_rows"] = p1 - p0
            case["plain_err"] = _abs_errors(plain[:, :S], exact[p0:p1])
            case["max_abs_diff_plain"] = (got_rows - plain[r0 - p0:r0 - p0 + SAE_ENCODE_TOPK_ROWS]).abs().max().item()
            del plain
            case["plain_ms"] = time_ms(lambda: se.encode_plain(x[p0:p1], W, b_enc, b_dec), 2, 1)
            lib = library(x)
            case["library_err"] = _abs_errors(lib[:, :S], exact)
            lib_rows = lib[r0:r0 + SAE_ENCODE_TOPK_ROWS].clone()
            del lib
            case["max_abs_diff_library"] = (got_rows - lib_rows).abs().max().item()
            tol = 4 * max(case["kernel_err"]["max"], case["library_err"]["max"])
            case["topk"] = _topk_near_ties(got_rows, lib_rows, a[r0:r0 + SAE_ENCODE_TOPK_ROWS], W, b_enc, k, tol)
            del got_rows, lib_rows
            del a, exact
            case["ms"] = time_ms(lambda: se.encode(x, W, b_enc, b_dec), iters, 1)
            case["split_ms"] = time_ms(lambda: se.split(x, b_dec), iters, 1)
            case["library_ms"] = time_ms(lambda: library(x), iters, 1)
            ops_ms = 6 * 2 * rows * d_in * L / BF16_FLOPS * 1e3
            bytes_ms = (3 * 2 * (rows * d_in + d_in * L) + 4 * rows * L) / HBM_BYTES_PER_S * 1e3
            case.update(bound_ms=max(ops_ms, bytes_ms), bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                        ops_bound_ms=ops_ms, bytes_bound_ms=bytes_ms,
                        split_bound_ms=(2 + 6) * rows * d_in / HBM_BYTES_PER_S * 1e3,
                        tflops=6 * 2 * rows * d_in * L / (case["ms"] - case["split_ms"]) / 1e9)
            checked = {"kernel": case["kernel_err"]}
            if "plain_err" in case:
                checked["plain"] = case["plain_err"]
            for name, errs in checked.items():
                if errs["max"] > 2 * case["library_err"]["max"] or errs["mean"] > 2 * case["library_err"]["mean"]:
                    failures.append(f"{name} error {errs} over twice the sgemm's {case['library_err']} at {rows} rows")
            if case["topk"]["max_gap_to_kth"] > tol:
                failures.append(f"top-k differs from the sgemm path's beyond near-ties at {rows} rows: {case['topk']}")
            emit({"phase": "sae_encode", **case})
            cases.append(case)
            del x
            gc.collect()
            torch.cuda.empty_cache()
    del W, b_enc, b_dec
    gc.collect()
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))
    main = cases[0]
    return {"name": "sae_encode", "route": "cuda", "source": "multimodal_sae_tpu_torch/csrc/sae_encode.cu",
            "replaces": "none: XLA's product at Precision.HIGHEST (multimodal_sae_tpu/sae/model.py::pre_acts)",
            "max_abs_err_vs_float64": main["kernel_err"]["max"], "ms": main["ms"], "plain_ms": main["plain_ms"],
            "plain_rows": main["plain_rows"], "max_abs_diff_plain": main["max_abs_diff_plain"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "weight_split_s": weight_split_s, "cases": cases}


def _check_topk_as_sets(latents: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor, k: int):
    """The port's top-k against `torch.topk` on the same latents: equal value
    multisets, and equal index sets up to ties at the k-th value."""
    ref_v, ref_i = torch.topk(latents, k, dim=-1)
    if not torch.equal(torch.sort(vals, dim=-1, descending=True).values, ref_v):
        raise AssertionError("top-k values differ from torch.topk")
    kth = ref_v[:, -1:]
    ref_set = torch.zeros_like(latents, dtype=torch.bool).scatter_(1, ref_i, True)
    got_set = torch.zeros_like(latents, dtype=torch.bool).scatter_(1, idx.long(), True)
    if bool(((ref_set != got_set) & (latents != kth)).any()):
        raise AssertionError("top-k index set differs from torch.topk beyond k-th-value ties")


def counting(cache_cls):
    """`cache_cls` counting the top-k values above the extraction threshold
    that its host step receives (the number of entries the splits must
    hold)."""

    class Counting(cache_cls):
        above = 0

        def _host_step(self, dev_out, batch_number, n_rows):
            for vals, _idx, event in dev_out.values():
                event.synchronize()
                self.above += int((vals.abs() > 1e-5).sum())
            super()._host_step(dev_out, batch_number, n_rows)

    return Counting


def check_splits(module_dir: str, n_splits: int, width: int) -> tuple:
    """The merged splits of one hookpoint: `n_splits` files, each with its
    features inside its range and a `.featidx` sidecar that reads back;
    returns every split's (locations, activations) concatenated."""
    from multimodal_sae_tpu_torch.features.split_index import read_index
    from multimodal_sae_tpu_torch.utils.safetensors_io import load_file

    splits = sorted((f for f in os.listdir(module_dir) if f.endswith(".safetensors")),
                    key=lambda f: int(f.split("_")[0]))
    if len(splits) != n_splits or any(f.startswith("Rank") for f in splits):
        raise AssertionError(f"expected {n_splits} merged splits, found {splits[:3]}...")
    locs_all, acts_all = [], []
    for f in splits:
        start, end = (int(x) for x in f[: -len(".safetensors")].split("_"))
        data = load_file(os.path.join(module_dir, f))
        locs, acts = data["locations"].numpy(), data["activations"].numpy()
        feats = locs[:, 2]
        if len(feats) and (feats.min() < start or feats.max() > end):
            raise AssertionError(f"split {f} holds features outside [{start}, {end}]")
        if not os.path.exists(os.path.join(module_dir, f.replace(".safetensors", ".featidx"))):
            raise AssertionError(f"split {f} has no .featidx sidecar")
        index = read_index(os.path.join(module_dir, f), len(acts))
        if index is None or not np.array_equal(feats[np.asarray(index[0])], np.asarray(index[1])):
            raise AssertionError(f"split {f}'s .featidx does not read back its features")
        locs_all.append(locs)
        acts_all.append(acts)
    locs, acts = np.concatenate(locs_all), np.concatenate(acts_all)
    if not ((locs[:, 2] >= 0).all() and (locs[:, 2] < width).all()):
        raise AssertionError("merged feature indices out of range")
    if not (np.isfinite(acts).all() and (np.abs(acts) > 1e-5).all()):
        raise AssertionError("merged activations non-finite or under the threshold")
    return locs, acts


def cache_rows(vocab: int, n: int, ctx_len: int, seed: int = 0) -> list:
    """The cache phases' token rows, drawn from `seed`."""
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, vocab, size=ctx_len)} for _ in range(n)]


def phase_cache_path(dev, card: str, work_dir: str) -> dict:
    """The cache path at LLaMA-3-8B width (random bf16 weights, depth cut to
    the 25 layers hookpoint layers.24 reads) and the released SAE's width
    (131,072 latents, k=256, fp32), through the entry points a user calls.
    Writes under `work_dir`, which the caller removes; returns the merged
    cache's directory, hookpoint and token rows for the loader phase."""
    from multimodal_sae_tpu_torch.config import SaeConfig
    from multimodal_sae_tpu_torch.device import setup
    from multimodal_sae_tpu_torch.features import FeatureCache
    from multimodal_sae_tpu_torch.interp_utils import load_saes
    from multimodal_sae_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from multimodal_sae_tpu_torch.ops import top_k
    from multimodal_sae_tpu_torch.sae import Sae, pre_acts

    setup(dev)
    n_batches, batch_size, ctx_len, n_splits, hook = 4, 8, 2048, 128, "layers.24"
    seconds = {}
    t0 = time.perf_counter()
    cfg = LlamaConfig(num_hidden_layers=25, flash_attention=True)
    model = LlamaModel.random(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    seconds["init_subject"] = time.perf_counter() - t0

    CountingCache = counting(FeatureCache)
    rows = cache_rows(cfg.vocab_size, n_batches * batch_size, ctx_len)
    batch0 = {"input_ids": np.stack([r["input_ids"] for r in rows[:batch_size]])}
    t0 = time.perf_counter()
    Sae(4096, SaeConfig(num_latents=131072, k=256), decoder=False, seed=0, device=dev) \
        .save_to_disk(os.path.join(work_dir, "saes", hook))
    saes = load_saes(os.path.join(work_dir, "saes"), device=dev)
    sae = saes[hook]
    torch.cuda.synchronize()
    seconds["init_sae_save_load"] = time.perf_counter() - t0

    # Warm-up (cuBLAS handles, allocator) outside the counted run.
    t0 = time.perf_counter()
    h = model.capture(batch0, [hook])[hook]
    top_k(pre_acts(sae.params, h.reshape(-1, h.shape[-1])), sae.cfg.k, assume_finite=True)
    torch.cuda.synchronize()
    seconds["warmup"] = time.perf_counter() - t0
    del h

    save_dir = os.path.join(work_dir, "cache")
    fc = CountingCache(lambda b: model.capture(b, [hook]), saes, batch_size=batch_size)
    fc.enable_streaming(save_dir, n_splits=n_splits)
    torch.cuda.reset_peak_memory_stats()
    # Collect garbage before each timed run, so that no collection pass
    # (a long one once the profiler's events are garbage) lands inside it.
    gc.collect()
    reset_kernel_counts()
    t0 = time.perf_counter()
    fc.run(ctx_len, rows, progress=False)
    torch.cuda.synchronize()
    seconds["run"] = time.perf_counter() - t0
    launches = kernel_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expected = {"block_max": 2 * n_batches, "flash_attention": 25 * n_batches,
                "flash_attention_bwd_delta": 0, "flash_attention_bwd_dkdv": 0,
                "flash_attention_bwd_dq": 0, "gather_rows": 0, "splice_decode": 0, "decode_dvals": 0,
                "sae_encode": n_batches}
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} over {n_batches} batches, expected {expected}")
    t0 = time.perf_counter()
    fc.save_splits(n_splits, save_dir)
    fc.concate_safetensors(n_splits, save_dir)
    seconds["save_and_merge"] = time.perf_counter() - t0

    locs, acts = check_splits(os.path.join(save_dir, hook), n_splits, 131072)
    n_entries = len(acts)
    if n_entries != fc.above:
        raise AssertionError(f"merged splits hold {n_entries} entries, top-k gave {fc.above} above 1e-5")
    if not ((locs[:, 0] < n_batches * batch_size).all() and (locs[:, 1] < ctx_len).all()):
        raise AssertionError("merged locations out of range")

    # Batch 0 again, stage by stage: its top-k against torch.topk as sets.
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    h = model.capture(batch0, [hook])[hook]
    ev[1].record()
    latents = pre_acts(sae.params, h.reshape(-1, h.shape[-1]))
    ev[2].record()
    vals, idx = top_k(latents, sae.cfg.k, assume_finite=True)
    ev[3].record()
    torch.cuda.synchronize()
    _check_topk_as_sets(latents, vals, idx, sae.cfg.k)
    del latents

    tokens = n_batches * batch_size * ctx_len
    emit({
        "phase": "cache_path", "subject": "LLaMA-3-8B widths, 25 layers, bf16, flash attention",
        "sae": "4096 -> 131072 latents, k=256, fp32", "hookpoint": hook,
        "batches": n_batches, "batch_size": batch_size, "ctx_len": ctx_len, "tokens": tokens,
        "tokens_per_s": tokens / seconds["run"], "seconds": seconds,
        "stage_ms_batch0": {"subject_forward": ev[0].elapsed_time(ev[1]),
                            "encode": ev[1].elapsed_time(ev[2]),
                            "top_k": ev[2].elapsed_time(ev[3])},
        "launches": launches, "entries": n_entries, "n_splits": n_splits,
        "peak_gb": peak_gb, "card": card,
    })
    return {"launches": launches, "cache_dir": save_dir, "hook": hook, "sae_dir": os.path.join(work_dir, "saes"),
            "rows": len(rows), "n_splits": n_splits, "tokens": np.stack([r["input_ids"] for r in rows]),
            "sae": sae, "hidden0": h, "batch0_topk": (vals, idx)}


HUB_REPO = "org/llama3-sae-131k"
HUB_REVISION = "0123456789abcdef0123456789abcdef01234567"


@contextlib.contextmanager
def _offline_hub(cache_dir: str):
    """Within the block, `huggingface_hub` reads the cache `cache_dir` with
    every HTTP session offline; yields the module, or None where it is not
    installed.  The environment is set before the import, which reads it; a
    module imported earlier has its constants set and its sessions dropped.
    On exit the environment and the constants are put back."""
    env = {name: os.environ.get(name) for name in ("HF_HUB_OFFLINE", "HF_HUB_CACHE")}
    os.environ.update(HF_HUB_OFFLINE="1", HF_HUB_CACHE=cache_dir)
    saved = None
    try:
        try:
            import huggingface_hub
            from huggingface_hub import constants
        except ImportError:
            yield None
            return
        saved = {name: getattr(constants, name) for name in ("HF_HUB_OFFLINE", "HF_HUB_CACHE")}
        constants.HF_HUB_OFFLINE, constants.HF_HUB_CACHE = True, cache_dir
        with contextlib.suppress(ImportError):
            from huggingface_hub.utils._http import reset_sessions

            reset_sessions()
        yield huggingface_hub
    finally:
        for name, value in env.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value
        if saved is not None:
            for name, value in saved.items():
                setattr(constants, name, value)


def phase_hub_sae_path(dev, card: str, work_dir: str, cache: dict) -> dict:
    """The cache path's SAE (seed 0, here with its decoder, which is drawn
    after the encoder) written as HUB_REPO's snapshot in a HuggingFace cache
    layout under `work_dir` (`models--org--name/refs/main`,
    `snapshots/<revision>/<hook>/`) and read by name through `load_saes`
    (all hookpoints, and a filter) and `load_single_sae`, offline: every
    tensor equal bit for bit to `Sae.load_from_disk`'s of the snapshot and
    the encoder to the cache path's SAE; then the cache path's first batch
    encoded and selected with the hub-loaded SAE on the card (K1 launched
    twice), its values and indices equal to the cache path's.  Where
    `huggingface_hub` is not installed, a hub name must raise
    FileNotFoundError, and the loads read the snapshot as a local path."""
    from multimodal_sae_tpu_torch.interp_utils import load_saes, load_single_sae
    from multimodal_sae_tpu_torch.ops import top_k
    from multimodal_sae_tpu_torch.sae import Sae, pre_acts

    t_phase = time.perf_counter()
    hook, disk_sae, h = cache["hook"], cache.pop("sae"), cache.pop("hidden0")
    want_vals, want_idx = cache.pop("batch0_topk")
    hub_dir = os.path.join(work_dir, "hf_cache")
    folder = os.path.join(hub_dir, "models--" + HUB_REPO.replace("/", "--"))
    snapshot = os.path.join(folder, "snapshots", HUB_REVISION)
    os.makedirs(os.path.join(folder, "refs"))
    with open(os.path.join(folder, "refs", "main"), "w") as f:
        f.write(HUB_REVISION)
    seconds = {}
    t0 = time.perf_counter()
    Sae(disk_sae.d_in, disk_sae.cfg, seed=0, device=dev).save_to_disk(os.path.join(snapshot, hook))
    seconds["write"] = time.perf_counter() - t0

    with _offline_hub(hub_dir) as hub:
        if hub is None:
            try:
                load_saes(HUB_REPO, device=dev)
            except FileNotFoundError as e:
                unchecked = f"huggingface_hub is not installed here: {HUB_REPO} raised {type(e).__name__} ({e})"
            else:
                raise AssertionError("a hub name loaded without huggingface_hub")
            print(f"hub_sae_path: the name's resolution went unchecked on this machine; {unchecked}", flush=True)
            name = snapshot
        else:
            name, unchecked = HUB_REPO, None
        t0 = time.perf_counter()
        ref = Sae.load_from_disk(os.path.join(snapshot, hook), device=dev)
        seconds["load_from_disk"] = time.perf_counter() - t0
        for what, load in (("load_saes", lambda: load_saes(name, device=dev)),
                           ("load_saes_filter", lambda: load_saes(name, {hook: np.arange(8)}, device=dev)),
                           ("load_single_sae", lambda: {hook: load_single_sae(name, hook, device=dev)})):
            t0 = time.perf_counter()
            saes = load()
            torch.cuda.synchronize()
            seconds[what] = time.perf_counter() - t0
            if list(saes) != [hook]:
                raise AssertionError(f"{what} loaded {list(saes)}")
            keys = ["W_enc", "b_enc", "b_dec"] + (["W_dec"] if what == "load_single_sae" else [])
            if list(saes[hook].params) != keys or not all(_bits_equal(saes[hook].params[key], ref.params[key])
                                                           for key in keys):
                raise AssertionError(f"{what} differs from load_from_disk's bits")
            if what == "load_saes":
                sae = saes[hook]
    del ref, saes
    if not all(_bits_equal(sae.params[key], disk_sae.params[key]) for key in disk_sae.params):
        raise AssertionError("the snapshot's encoder is not the cache path's SAE")
    del disk_sae
    torch.cuda.empty_cache()

    x = h.reshape(-1, h.shape[-1])
    gc.collect()
    reset_kernel_counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    latents = pre_acts(sae.params, x)
    ev[1].record()
    vals, idx = top_k(latents, sae.cfg.k, assume_finite=True)
    ev[2].record()
    torch.cuda.synchronize()
    launches = kernel_counts()
    if launches != {**dict.fromkeys(launches, 0), "block_max": 2, "sae_encode": 1}:
        raise AssertionError(f"hub SAE encode launched {launches}, expected block_max 2 and sae_encode 1")
    if not (torch.equal(idx, want_idx) and _bits_equal(vals, want_vals)):
        raise AssertionError("the hub-loaded SAE's top-k differs from the cache path's")
    del latents, sae
    emit({
        "phase": "hub_sae_path", "repo": HUB_REPO, "resolved_by": "huggingface_hub (offline cache)" if hub else
        "local path (huggingface_hub absent)", "huggingface_hub": getattr(hub, "__version__", None),
        "unchecked": unchecked, "sae": "4096 -> 131072 latents, k=256, fp32", "hookpoint": hook,
        "loads_equal_to_load_from_disk": ["load_saes", "load_saes_filter", "load_single_sae"],
        "tokens": x.shape[0], "topk_equal_to_cache_path": True, "launches": launches,
        "stage_ms": {"encode": ev[0].elapsed_time(ev[1]), "top_k": ev[1].elapsed_time(ev[2])},
        "seconds": seconds, "phase_s": time.perf_counter() - t_phase, "card": card,
    })
    return {"launches": launches}


KTH_ROWS, KTH_WIDTH, KTH_K = 16384, 131072, 2048
# kth_search_path: the AuxK threshold's call on train_path, `kth_value` of
# the dead latents' scores (8 x 2,048 rows x 131,072 latents, half of them
# -inf, k = d_in / 2).


def phase_kth_search_path(dev, card: str) -> dict:
    """`kth_value` at the AuxK threshold's shape (KTH_ROWS x KTH_WIDTH, the
    odd latents -inf, the rest relu of a seeded normal, k = KTH_K) in fp32,
    bf16 and float16 (the JAX package's search forms are its aliases): its
    values equal to `torch.kthvalue`'s on the same rows, each timed with
    CUDA events beside the bytes bound of one read of the input and one
    write of the output.  A measurement, not a path: no kernel of the port
    runs."""
    from multimodal_sae_tpu_torch.ops import kth_value, kth_value_bitwise, kth_value_histogram

    t_phase = time.perf_counter()
    if not (kth_value_bitwise is kth_value and kth_value_histogram is kth_value):
        raise AssertionError("the k-th value's search forms are not kth_value")
    gen = torch.Generator(device=dev).manual_seed(5)
    scores = torch.randn(KTH_ROWS, KTH_WIDTH, generator=gen, device=dev).relu_()
    scores[:, 1::2] = float("-inf")
    gc.collect()
    reset_kernel_counts()
    out = {}
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        x = scores if dtype == torch.float32 else scores.to(dtype)
        got = kth_value(x, KTH_K)
        want = torch.kthvalue(x, KTH_WIDTH - KTH_K + 1, dim=-1, keepdim=True).values
        if not (torch.equal(got, want) and bool((got > 0).all())):
            raise AssertionError(f"{dtype}: kth_value differs from torch.kthvalue, or is not positive")
        nbytes = x.numel() * x.element_size() + got.numel() * got.element_size()
        out[str(dtype).replace("torch.", "")] = {
            "shape": list(x.shape), "k": KTH_K, "equal_to_torch_kthvalue": True,
            "kth_value_ms": time_ms(lambda: kth_value(x, KTH_K), iters=2, warmup=0),
            "torch_kthvalue_ms": time_ms(lambda: torch.kthvalue(x, KTH_WIDTH - KTH_K + 1, dim=-1), iters=2,
                                         warmup=0),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
        del x, got, want
    del scores
    launches = kernel_counts()
    if any(launches.values()):
        raise AssertionError(f"kth_value launched {launches}")
    emit({"phase": "kth_search_path", "what": "AuxK threshold's kth_value input (train_path)", "dtypes": out,
          "seconds": time.perf_counter() - t_phase, "card": card})
    return {"launches": launches}


def k2_decode_bound(N: int, k: int, d: int, distinct: int) -> dict:
    """K2's decode mode over (N, k) selections of an fp32 decoder with d
    columns: the larger of the bytes it must move (each distinct row read
    once, the output written once, the indices and values read) over the
    memory rate and its N * k * d fp32 FMAs over the CUDA cores' rate."""
    bytes_ms = (distinct * d * 4 + N * d * 4 + N * k * 8) / HBM_BYTES_PER_S * 1e3
    fma_ms = N * k * d / FP32_FMAS * 1e3
    return {"bound_ms": max(bytes_ms, fma_ms), "bound_bytes_ms": bytes_ms, "bound_fma_ms": fma_ms,
            "bound_by": "bytes" if bytes_ms >= fma_ms else "operations"}


TILE_SIZES = (8, 16, 32, 64)


def tile_stats(idx: torch.Tensor) -> dict:
    """The rows each tile of T consecutive tokens names (|U|, the rows K2's
    decode mode would stage to read each once), at T = 8, 16, 32 and 64:
    mean and largest over the tiles, and the pairs a row serves."""
    from multimodal_sae_tpu_torch.ops import gather_rows as gr

    out = {}
    for T in TILE_SIZES:
        U = gr.tile_union_sizes(idx, T).float()
        out[str(T)] = {"mean": U.mean().item(), "max": U.max().item(), "pairs_per_row": T * idx.shape[1] / U.mean().item()}
    return out


def check_tile_union(idx: torch.Tensor, L: int, tile: int, cap: int) -> dict:
    """The decode mode's pre-pass on the card against its plain version at
    the decode's tiling: codes and tile info equal, and each tile's staged
    rows; with how many tiles take the staged path and the share of pairs
    their staged rows cover."""
    from multimodal_sae_tpu_torch.ops import gather_rows as gr

    code, rows, info = gr.tile_union(idx, L, tile, cap)
    p_code, p_rows, p_info = gr.tile_union_plain(idx, L, tile, cap)
    torch.cuda.synchronize()
    staged = torch.arange(p_rows.shape[1], device=idx.device)[None] < p_info[:, :1]
    if not (torch.equal(code, p_code) and torch.equal(info, p_info) and torch.equal(rows[staged], p_rows[staged])):
        raise AssertionError(f"the tile pre-pass differs from its plain version (tiles of {tile}, {cap} rows)")
    return {"tile": tile, "rows": cap, "tiles": info.shape[0], "staged_tiles": int(info[:, 1].sum()),
            "pairs_on_staged_rows": info[:, 3].sum().item() / idx.numel(), "equal_plain": True}


def _uniform_set(W: torch.Tensor, N: int = 2432, k: int = 256):
    """A seeded uniform index set (N, k) over W's rows, with descending
    values: tiles share almost no rows."""
    gen = torch.Generator(device=W.device).manual_seed(5)
    idx = torch.randint(0, W.shape[0], (N, k), generator=gen, device=W.device, dtype=torch.int32)
    return idx, torch.rand(N, k, generator=gen, device=W.device).sort(dim=1, descending=True).values.to(W.dtype)


def _check_decode(W: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> dict:
    """K2's decode mode at (tokens, k) = idx's shape: within an fp32 bound of
    its plain version, equal bits over two calls, its pre-pass equal to the
    plain one; timed beside the plain version, `embedding_bag` and the
    bound, with the rows a tile names."""
    import torch.nn.functional as F

    from multimodal_sae_tpu_torch.ops import gather_rows as gr

    N, k = idx.shape
    d = W.shape[1]
    got, ref = gr.gather_decode(idx, vals, W), gr.gather_decode_plain(idx, vals, W)
    again = gr.gather_decode(idx, vals, W)
    torch.cuda.synchronize()
    # Both sum k fp32 products in their own order: each differs from the
    # exact sum by at most k * 2^-24 * sum_j |vals_j| * max |W|.
    err_bound = 2 * k * 2.0 ** -24 * vals.abs().sum(-1).max().item() * W.abs().max().item()
    err = (got - ref).abs().max().item()
    if not (torch.isfinite(got).all() and err <= err_bound):
        raise AssertionError(f"gather_decode off by {err} (bound {err_bound})")
    if not torch.equal(got, again):
        raise AssertionError("gather_decode is not deterministic")
    del got, ref, again
    tile, rows, _ = gr.decode_tiling(N, k)
    tiles = check_tile_union(idx, W.shape[0], tile, rows) if tile else None
    idx_long = idx.long()
    distinct = torch.unique(idx).numel()
    return {
        "tokens": N, "k": k, "distinct_rows": distinct, "rows_a_tile_names": tile_stats(idx), "tiles": tiles,
        "max_abs_err": err, "err_bound": err_bound, "deterministic": True,
        "kernel_ms": time_ms(lambda: gr.gather_decode(idx, vals, W)),
        "plain_ms": time_ms(lambda: gr.gather_decode_plain(idx, vals, W), iters=3),
        "library_ms": time_ms(lambda: F.embedding_bag(idx_long, W, per_sample_weights=vals, mode="sum")),
        **k2_decode_bound(N, k, d, distinct), "no_reuse_gb": N * k * d * 4 / 1e9,
    }


def check_gather_rows(W: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor, chunk, uniform: bool = False) -> dict:
    """K2 on the attribution prefix's clean top-k (`idx`, `vals`: tokens x k)
    of the decoder `W`: copy mode bit-exact against `W[idx]` on the first 128
    tokens' rows, decode mode within an fp32 bound of its plain version and
    deterministic, each timed; decode mode also at a chunk's re-selected
    top-k (`chunk` = (vals, idx) of 8 features stacked) and, with `uniform`,
    on a seeded uniform index set of the same shape, where tiles share no
    rows.  The decode's pre-pass is held to its plain version, and the
    rows a tile names are printed for both index sets."""
    import torch.nn.functional as F

    from multimodal_sae_tpu_torch.ops import gather_rows as gr

    N, k = idx.shape
    d = W.shape[1]
    flat = idx[:128].reshape(-1)
    got, ref = gr.gather_rows(W, flat), gr.gather_rows_plain(W, flat)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
        raise AssertionError("gather_rows differs from W[idx]")
    # The 128 tokens' top-k repeat rows: the work reads each distinct row
    # once and writes every row.
    flat_long = flat.long()
    copy_distinct = torch.unique(flat).numel()
    copy = {"rows": flat.numel(), "distinct_rows": copy_distinct, "bitexact": True,
            "kernel_ms": time_ms(lambda: gr.gather_rows(W, flat)),
            "plain_ms": time_ms(lambda: gr.gather_rows_plain(W, flat)),
            "library_ms": time_ms(lambda: W[flat_long]),
            "bound_ms": ((copy_distinct + flat.numel()) * d * W.element_size() + flat.numel() * 4)
            / HBM_BYTES_PER_S * 1e3}
    del got, ref

    decode = _check_decode(W, idx, vals)
    c_vals, c_idx = chunk
    c_distinct = torch.unique(c_idx).numel()
    decode_chunk = {
        "tokens": c_idx.shape[0], "distinct_rows": c_distinct, "rows_a_tile_names": tile_stats(c_idx),
        "kernel_ms": time_ms(lambda: gr.gather_decode(c_idx, c_vals, W)),
        "library_ms": time_ms(lambda: F.embedding_bag(c_idx.long(), W, per_sample_weights=c_vals, mode="sum")),
        **k2_decode_bound(c_idx.shape[0], c_idx.shape[1], d, c_distinct), "no_reuse_gb": c_idx.numel() * d * 4 / 1e9,
    }
    line = {"phase": "gather_rows", "W": [W.shape[0], d], "dtype": "float32", "copy": copy,
            "decode_clean_topk": decode, "decode_chunk_of_8": decode_chunk}
    if uniform:
        line["decode_uniform"] = _check_decode(W, *_uniform_set(W, N, k))
    emit(line)
    torch.cuda.empty_cache()
    return {"ms": decode["kernel_ms"], "plain_ms": decode["plain_ms"], "bound_ms": decode["bound_ms"],
            "bound_by": decode["bound_by"], "library_ms": decode["library_ms"], "max_abs_err": decode["max_abs_err"]}


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    a, b = a.detach(), b.detach()
    if not a.is_floating_point():
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    ib = torch.int32 if a.dtype == torch.float32 else torch.int16
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(ib), b.view(ib))


def _splice_parent(wide_idx, wide_vals, drop, k, W, b, clean):
    """The parent path: `reselect`'s (F·N, k) lists (the pool without the
    dropped entry, cut to k), K2's decode mode, + b in W's dtype, cast."""
    from multimodal_sae_tpu_torch.ops import gather_rows as gr

    N = wide_idx.shape[0]
    rows = torch.arange(N, device=drop.device).repeat(drop.shape[0])
    vals, idx = gr.splice_lists(wide_idx, wide_vals, rows, drop.reshape(-1), k)
    return (gr.gather_decode(idx, vals, W) + b).to(clean.dtype), (vals, idx)


def _small_pool(gen, dev, N, width, kw, d, dtype):
    """A random decoder (width, d) of `dtype` with a bias, and N tokens'
    descending top-kw pools over it."""
    W = torch.randn(width, d, generator=gen, device=dev).to(dtype)
    b = torch.randn(d, generator=gen, device=dev).to(dtype)
    vals, idx = torch.topk(torch.rand(N, width, generator=gen, device=dev), kw)
    return W, b, idx.to(torch.int32), vals.to(dtype)


def _splice_err_bound(pool_vals, W, b, k, out_dtype) -> float:
    """Bound on |splice - plain| for one case.  Both sum at most k fp32
    products in their own order (check_gather_rows' bound, with the pool's
    sum of |vals| bounding any list's); then each rounds to W's dtype, adds b
    there and casts to the splice's dtype.  A rounding of unit roundoff u
    moves two values e apart to at most e + 2u·M apart, M their largest
    magnitude: the sum's bound plus max |b|."""
    s = pool_vals.float().abs().sum(-1).max().item() * W.float().abs().max().item()
    err = 2 * k * 2.0 ** -24 * s
    m = s + b.float().abs().max().item() + err
    if W.dtype == torch.bfloat16:  # the sum rounds to bf16, + b rounds in bf16; the cast is exact
        roundings = (2.0 ** -8, 2.0 ** -8)
    else:  # + b rounds in fp32, then the cast to a bf16 splice
        roundings = (2.0 ** -24,) + ((2.0 ** -8,) if out_dtype == torch.bfloat16 else ())
    return err + sum(2 * u * m for u in roundings)


def _check_splice_case(name, args) -> tuple:
    """One case of K2's splice mode: equal bits to the parent path (integer
    views), and against the plain version within `_splice_err_bound`, with
    equal bits on every copy row (drop >= k)."""
    from multimodal_sae_tpu_torch.ops import gather_rows as gr

    wide_idx, wide_vals, drop, k, W, b, clean = args
    got = gr.splice_decode(*args)
    ref, lists = _splice_parent(*args)
    plain = gr.splice_decode_plain(*args)
    torch.cuda.synchronize()
    if not _bits_equal(got, ref):
        raise AssertionError(f"splice_decode differs from the parent path on {name}")
    copy = (drop >= k).reshape(-1)
    if not _bits_equal(got[copy], plain[copy]):
        raise AssertionError(f"splice_decode's copy rows differ from the plain version's on {name}")
    err = (got.float() - plain.float()).abs().max().item() if got.numel() else 0.0
    bound = _splice_err_bound(wide_vals, W, b, k, clean.dtype)
    if not (bool(torch.isfinite(got).all()) and err <= bound):
        raise AssertionError(f"splice_decode off its plain version by {err} (bound {bound}) on {name}")
    hits = drop < k
    line = {"features": drop.shape[0], "tokens": drop.shape[1], "hit_pairs": int(hits.sum()),
            "hit_tokens": int(hits.any(0).sum()), "bit_equal_parent": True, "copy_rows_equal_plain": True,
            "max_abs_err_plain": err, "err_bound": bound}
    return line, lists


def check_splice_decode(step, inside, outside, W, b) -> dict:
    """K2's splice mode, each case against the parent path bit for bit and
    against its plain version within a stated bound (`_check_splice_case`):
    the attribution chunk of the 8 inside features (F = 8, the prompt's
    2,432 tokens, W_dec 131,072 x 4,096 fp32, bf16 splice), the chunk of the
    8 outside ones, F = 1, F = 32 on 256 tokens, a small k == width case
    (fp32 splice) and a small bf16 decoder (bf16 and fp32 splices).  Both
    chunks timed, median of 5, beside the parent path."""
    import torch.nn.functional as F_

    from multimodal_sae_tpu_torch.ops import gather_rows as gr

    dev = W.device
    k = step.k
    clean = step.clean.reshape(-1, W.shape[1])
    pool_vals = step.wide_vals.to(W.dtype)
    cases = {"inside_F8": inside, "outside_F8": outside, "inside_F1": inside[:1]}
    sub = 256  # F = 32 (the auto width under 512 tokens) on the first 256 tokens
    cases["F32_on_256_tokens"] = step.wide_idx[sub - 1, :32].long().tolist()
    checked, out = {}, {}
    for name, feats in cases.items():
        n = sub if name.startswith("F32") else clean.shape[0]
        drop = step.drop_positions(torch.tensor(feats, device=dev))[:, :n]
        args = (step.wide_idx[:n], pool_vals[:n], drop, k, W, b, clean[:n])
        checked[name], lists = _check_splice_case(name, args)
        if name in ("inside_F8", "outside_F8"):
            out[name] = (args, lists)
        del lists
    gen = torch.Generator(device=dev).manual_seed(7)
    small = {  # name: (N, width, k, kw, d, W dtype, splice dtype, features)
        "k_equals_width": (64, 256, 256, 256, 512, torch.float32, torch.float32, 4),
        "bf16_decoder": (300, 4096, 32, 33, 1024, torch.bfloat16, torch.bfloat16, 8),
        "bf16_decoder_fp32_splice": (300, 4096, 32, 33, 1024, torch.bfloat16, torch.float32, 8),
    }
    for name, (n, width, k_, kw, d, wt, ct, F) in small.items():
        W_, b_, idx, vals = _small_pool(gen, dev, n, width, kw, d, wt)
        clean_ = (gr.gather_decode(idx[:, :k_], vals[:, :k_], W_) + b_).to(ct)
        # Features at pool positions 0, k_ - 1, kw - 1 of some tokens, and 1 absent.
        feats = [int(idx[0, 0]), int(idx[1, k_ - 1]), int(idx[2, kw - 1])]
        in_pool = torch.zeros(width, dtype=torch.bool, device=dev)
        in_pool[idx.long().reshape(-1)] = True
        feats += torch.nonzero(~in_pool).reshape(-1)[:1].tolist()
        feats = (feats * F)[:F]
        drop = gr.drop_positions(idx, torch.tensor(feats, device=dev))
        checked[name], _ = _check_splice_case(name, (idx, vals, drop, k_, W_, b_, clean_))
        checked[name].update({"width": width, "k": k_, "k_wide": kw, "d": d,
                              "W": str(wt).replace("torch.", ""), "splice": str(ct).replace("torch.", "")})
    max_err = max(c["max_abs_err_plain"] for c in checked.values())
    emit({"phase": "splice_decode_check", "cases": checked})

    timed = {}
    d = W.shape[1]
    for name, (args, (vals, idx)) in out.items():
        wide_idx, wide_vals, drop = args[:3]
        feats_t = torch.tensor(cases[name], device=dev)
        F, N = drop.shape
        kernel = time_repeats(lambda: gr.splice_decode(*args))
        parent_kernel = time_repeats(lambda: gr.gather_decode(idx, vals, W))
        parent_path = time_repeats(lambda: (gr.gather_decode(*step.reselect(feats_t)[::-1], W) + b).to(clean.dtype))
        new_path = time_repeats(lambda: gr.splice_decode(
            wide_idx, wide_vals, step.drop_positions(feats_t), k, W, b, clean))
        drop_ms = time_ms(lambda: step.drop_positions(feats_t))
        plain_ms = time_ms(lambda: gr.splice_decode_plain(*args), iters=2, warmup=1)
        library_ms = time_ms(lambda: F_.embedding_bag(idx.long(), W, per_sample_weights=vals, mode="sum"))
        hits = drop < k
        hit_pairs, hit_tokens = int(hits.sum()), hits.any(0)
        distinct = torch.unique(wide_idx[hit_tokens]).numel() if bool(hit_tokens.any()) else 0
        # The kernel reads a token's pool only where the token has a hit.
        nbytes = (F * N * d * clean.element_size() + N * d * clean.element_size() + F * N * 4
                  + int(hit_tokens.sum()) * wide_idx.shape[1] * (4 + W.element_size()) + d * W.element_size()
                  + distinct * d * W.element_size())
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        fma_ms = hit_pairs * k * d / FP32_FMAS * 1e3
        timed[name] = {
            "features": F, "tokens": N, "hit_pairs": hit_pairs, "hit_tokens": int(hit_tokens.sum()),
            "distinct_rows_of_hit_tokens": distinct,
            "kernel_ms": kernel["median"], "kernel_ms_repeats": kernel,
            "parent_kernel_ms": parent_kernel["median"], "parent_kernel_ms_repeats": parent_kernel,
            "parent_path_ms": parent_path["median"], "new_path_ms": new_path["median"],
            "drop_positions_ms": drop_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_bytes_ms": bytes_ms, "bound_fma_ms": fma_ms, "bound_ms": max(bytes_ms, fma_ms),
            "bound_by": "operations" if fma_ms > bytes_ms else "bytes",
        }
    emit({"phase": "splice_decode", "W": [W.shape[0], d], "dtype": str(W.dtype).replace("torch.", ""),
          "splice": str(clean.dtype).replace("torch.", ""), "max_abs_err_plain": max_err, "chunks": timed})
    torch.cuda.empty_cache()
    inside_line = timed["inside_F8"]
    return {"ms": inside_line["kernel_ms"], "plain_ms": inside_line["plain_ms"],
            "bound_ms": inside_line["bound_ms"], "bound_by": inside_line["bound_by"],
            "library_ms": inside_line["library_ms"], "max_abs_err": max_err}


STAGES = ("reselect", "decode", "forward", "backward", "saliency")


def time_stages(step, feats: torch.Tensor) -> dict:
    """Device milliseconds of each stage of one attribution chunk (CUDA
    events at the step's stage marks)."""
    marks = {"start": torch.cuda.Event(enable_timing=True)}

    def mark(stage):
        marks[stage] = torch.cuda.Event(enable_timing=True)
        marks[stage].record()

    marks["start"].record()
    step(feats, mark=mark)
    torch.cuda.synchronize()
    names = ("start",) + STAGES
    out = {stage: marks[a].elapsed_time(marks[stage]) for a, stage in zip(names, STAGES)}
    out["total"] = marks["start"].elapsed_time(marks[STAGES[-1]])
    return out


KERNEL_GROUPS = (
    ("flash_attention_bwd", ("dkdv_kernel", "dq_kernel", "delta_kernel")),
    ("flash_attention", ("flash_fwd_kernel",)),
    ("splice_decode", ("splice_decode_kernel",)),
    ("gather_rows", ("gather_decode_kernel", "gather_rows_kernel", "decode_tile_kernel")),
    ("decode_dvals", ("decode_dvals_kernel",)),
    ("k2_tile_pre_pass", ("tile_union_kernel",)),
    ("block_max", ("block_max_kernel",)),
    ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "cublas")),
)


def profile_chunk(step, feats: torch.Tensor) -> dict:
    """One attribution chunk under torch.profiler: device time by kernel
    group and the device's busy share of the chunk's wall time.  Reports
    null where the profiler recorded no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(feats)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return summarize_profile(prof, wall_ms)


def summarize_profile(prof, wall_ms: float) -> dict:
    """Device time by kernel group of a finished torch.profiler run over
    `wall_ms` of wall time, and the device's busy and idle shares of it."""
    kernels = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if str(getattr(e, "device_type", "")).endswith("CUDA") and us > 0:
            kernels[e.key] = kernels.get(e.key, 0.0) + us / 1e3
    busy_ms = sum(kernels.values())
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    for key, ms in kernels.items():
        low = key.lower()
        group = next((name for name, parts in KERNEL_GROUPS if any(p in low for p in parts)), "other")
        groups[group] += ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms or None,
            "device_idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
            "by_group_ms": groups if busy_ms else None,
            "top_kernels_ms": [[key[:80], ms] for key, ms in top]}


def _saliency(out: dict, hook: str) -> np.ndarray:
    sal = np.stack(out[hook])
    if not np.isfinite(sal).all():
        raise AssertionError("non-finite saliency")
    return sal


def phase_attribution_path(dev, card: str) -> dict:
    """Attribution patching at LLaMA-3-8B width (random bf16 weights, all 32
    layers, LM head) and the released SAE's width (131,072 latents, k=256,
    fp32, with its decoder), through `fast_attribution_maps`."""
    from functools import partial

    from multimodal_sae_tpu_torch.config import SaeConfig
    from multimodal_sae_tpu_torch.device import setup
    from multimodal_sae_tpu_torch.features.patching import (
        build_fast_attribution, fast_attribution_maps, general_attribution_maps, get_logit_diff,
    )
    from multimodal_sae_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from multimodal_sae_tpu_torch.sae import Sae

    setup(dev)
    hook, S, fb, width = "layers.24", 2432, 8, 131072
    n_suffix = 32 - 25
    seconds = {}
    t0 = time.perf_counter()
    cfg = LlamaConfig(flash_attention=True)
    model = LlamaModel.random(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    seconds["init_subject"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t0 = time.perf_counter()
        Sae(4096, SaeConfig(num_latents=width, k=256), decoder=True, seed=0, device=dev) \
            .save_to_disk(os.path.join(tmp, hook))
        sae = Sae.load_from_disk(os.path.join(tmp, hook), decoder=True, device=dev)
        torch.cuda.synchronize()
        seconds["init_sae_save_load"] = time.perf_counter() - t0

    rng = np.random.default_rng(1)
    batch = {"input_ids": rng.integers(0, cfg.vocab_size, size=(1, S))}
    metric = partial(get_logit_diff, answer_token_indices=torch.tensor([[1000, 2000]], device=dev))

    # Outside the counted run: the prefix once, to choose the features and
    # feed K2's checks; one chunk as warm-up, then one timed stage by stage
    # and one under the profiler.  K2's checks (seconds of heavy card work)
    # run after the counted run, so that they do not precede it.
    t0 = time.perf_counter()
    step = build_fast_attribution(model, hook, sae, batch, metric)
    k = sae.cfg.k
    inside = step.wide_idx[-1, :8].long().tolist()  # the last position's 8 largest
    in_pool = torch.zeros(width, dtype=torch.bool, device=dev)
    in_pool[step.wide_idx.long().reshape(-1)] = True
    pool_free = torch.nonzero(~in_pool).squeeze(1).cpu().numpy()
    outside = sorted(rng.choice(pool_free, size=8, replace=False).tolist())
    feats = inside + outside
    chunk = torch.tensor(inside)
    step(chunk)  # warm-up
    torch.cuda.synchronize()
    seconds["prefix_and_warmup_chunk"] = time.perf_counter() - t0
    stage_ms = time_stages(step, chunk)
    profile = profile_chunk(step, chunk)
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    gc.collect()
    alloc_before = torch.cuda.memory_stats()
    reset_kernel_counts()
    t0 = time.perf_counter()
    out = fast_attribution_maps(model, hook, sae, batch, metric, feats, feature_batch=fb, progress=False)
    torch.cuda.synchronize()
    seconds["run"] = time.perf_counter() - t0
    launches = kernel_counts()
    # The caching allocator's work inside the counted run: cudaMalloc calls
    # (new segments), frees back to the driver, and retries after a failed
    # cudaMalloc (which free cached blocks first).
    alloc_after = torch.cuda.memory_stats()
    alloc = {key: alloc_after.get(key, 0) - alloc_before.get(key, 0)
             for key in ("num_device_alloc", "num_device_free", "num_alloc_retries", "segment.all.allocated",
                         "segment.all.freed", "allocation.all.allocated")}
    alloc["reserved_gb_before"] = alloc_before.get("reserved_bytes.all.current", 0) / 1e9
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    k2 = check_gather_rows(sae.params["W_dec"], step.wide_idx[:, :k], step.wide_vals[:, :k],
                           step.reselect(torch.tensor(inside, device=dev)), uniform=True)
    splice = check_splice_decode(step, inside, outside, sae.params["W_dec"], sae.params["b_dec"])
    del step
    torch.cuda.empty_cache()
    chunks = len(feats) // fb
    # Prefix: 25 forward attentions, the encode and the two block-max
    # levels of the top-(k+1) pool, the clean decode; per chunk: one splice
    # and the suffix's 7 attentions forward and backward.
    expected = {"block_max": 2, "flash_attention": 25 + n_suffix * chunks,
                "flash_attention_bwd_delta": n_suffix * chunks, "flash_attention_bwd_dkdv": n_suffix * chunks,
                "flash_attention_bwd_dq": n_suffix * chunks, "gather_rows": 1, "splice_decode": chunks,
                "decode_dvals": 0, "sae_encode": 1}
    if launches != expected:
        raise AssertionError(f"attribution kernel launches {launches}, expected {expected}")
    sal = _saliency(out, hook)  # (16, 1, S)
    if sal.shape != (len(feats), 1, S):
        raise AssertionError(f"saliency shape {sal.shape}")
    if np.any(sal[8:] != 0):
        raise AssertionError("saliency of a feature outside every top-k is not exactly 0")
    if not np.any(sal[:8] != 0):
        raise AssertionError("saliency of the in-top-k features is all 0")

    # The general path (full spliced forward and backward) for 2 features.
    t0 = time.perf_counter()
    general = general_attribution_maps(model, {hook: sae}, batch, metric, inside[:2], progress=False)
    torch.cuda.synchronize()
    seconds["general_2_features"] = time.perf_counter() - t0
    agreement = []
    for f, g in zip(sal[:2], general[hook]):
        rel = float(np.linalg.norm(f - g) / np.linalg.norm(g))
        agreement.append(rel)
        if not rel <= ATTRIBUTION_L2_REL:
            raise AssertionError(f"fast and general attribution differ: relative L2 {rel}")

    # Masked run: 2 prompts of 512 tokens, row 1 left-padded by 100.
    S2, pad = 512, 100
    mask = np.ones((2, S2), dtype=np.int64)
    mask[1, :pad] = 0
    batch2 = {"input_ids": rng.integers(0, cfg.vocab_size, size=(2, S2)), "attention_mask": mask}
    metric2 = partial(get_logit_diff, answer_token_indices=torch.tensor([[1000, 2000], [3000, 4000]], device=dev))
    step2 = build_fast_attribution(model, hook, sae, batch2, metric2)
    feats2 = step2.wide_idx[S2 - 1, :4].long().tolist() + step2.wide_idx[2 * S2 - 1, :4].long().tolist()
    del step2
    gc.collect()
    reset_kernel_counts()
    t0 = time.perf_counter()
    out2 = fast_attribution_maps(model, hook, sae, batch2, metric2, feats2, feature_batch=fb, progress=False)
    torch.cuda.synchronize()
    seconds["masked_run"] = time.perf_counter() - t0
    launches2 = kernel_counts()
    expected2 = {"block_max": 2, "flash_attention": 25 + n_suffix, "flash_attention_bwd_delta": n_suffix,
                 "flash_attention_bwd_dkdv": n_suffix, "flash_attention_bwd_dq": n_suffix, "gather_rows": 1,
                 "splice_decode": 1, "decode_dvals": 0, "sae_encode": 1}
    if launches2 != expected2:
        raise AssertionError(f"masked attribution kernel launches {launches2}, expected {expected2}")
    sal2 = _saliency(out2, hook)  # (8, 2, 512)
    if np.any(sal2[:, 1, :pad] != 0):
        raise AssertionError("saliency at pad positions is not exactly 0")
    if not np.any(sal2[:, 1, pad:] != 0):
        raise AssertionError("saliency at row 1's real positions is all 0")
    # The general path on the masked batch for one feature of each row's
    # top-k (the fast path tiles the mask F times; the general path not).
    general2 = general_attribution_maps(model, {hook: sae}, batch2, metric2, [feats2[0], feats2[4]], progress=False)
    for f, g in zip(sal2[[0, 4]], general2[hook]):
        rel = float(np.linalg.norm(f - g) / np.linalg.norm(g))
        agreement.append(rel)
        if not rel <= ATTRIBUTION_L2_REL:
            raise AssertionError(f"fast and general attribution differ on the masked batch: relative L2 {rel}")

    emit({
        "phase": "attribution_path", "subject": "LLaMA-3-8B widths, 32 layers, bf16, flash attention, LM head",
        "sae": "4096 -> 131072 latents, k=256, fp32, decoder", "hookpoint": hook, "prompt_tokens": S,
        "features": len(feats), "feature_batch": fb, "seconds": seconds,
        "ms_per_feature": seconds["run"] * 1e3 / len(feats), "features_per_s": len(feats) / seconds["run"],
        "outside_chunks_ms": seconds["run"] * 1e3 - chunks * stage_ms["total"], "allocator": alloc,
        "chunk_stage_ms": stage_ms, "chunk_profile": profile, "launches": launches, "peak_gb": peak_gb,
        "outside_topk_exact_zero": True, "fast_vs_general_l2_rel": agreement[:2], "l2_rel_bound": ATTRIBUTION_L2_REL,
        "masked": {"prompts": 2, "tokens": S2, "left_pad_row1": pad, "features": len(feats2),
                   "launches": launches2, "pad_positions_exact_zero": True,
                   "fast_vs_general_l2_rel": agreement[2:]},
        "card": card,
    })
    return {"launches": {name: launches[name] + launches2[name] for name in launches}, "k2": k2,
            "splice": splice, "model": model, "sae": sae}


TRAIN_STAGES = ("capture", "encode", "top_k", "masked_decode", "losses", "backward", "clip", "apply", "bookkeeping")


class StageMarks:
    """CUDA events at the trainer's stage marks; `ms()` sums the time of
    each stage (from the previous mark to its own) over one batch."""

    def __init__(self):
        self.events = [("start", torch.cuda.Event(enable_timing=True))]
        self.events[0][1].record()
        self.on_apply = None

    def __call__(self, stage: str):
        if stage == "apply" and self.on_apply is not None:
            self.on_apply()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        self.events.append((stage, event))

    def ms(self) -> dict:
        torch.cuda.synchronize()
        out = {}
        for (_, a), (stage, b) in zip(self.events, self.events[1:]):
            out[stage] = out.get(stage, 0.0) + a.elapsed_time(b)
        out["total"] = self.events[0][1].elapsed_time(self.events[-1][1])
        return out


def _trainer_state_equal(a, b, hook: str) -> bool:
    """Parameters, optimizer leaves and counters of two trainers equal bit
    for bit."""
    from multimodal_sae_tpu_torch.ops.adam import flatten_state

    pa, pb = a.saes[hook].params, b.saes[hook].params
    if set(pa) != set(pb) or not all(_bits_equal(pa[n], pb[n]) for n in pa):
        return False
    la, lb = flatten_state(a.opt_states[hook]), flatten_state(b.opt_states[hook])
    if len(la) != len(lb) or not all(_bits_equal(x, y) for x, y in zip(la, lb)):
        return False
    return (np.array_equal(a.num_tokens_since_fired[hook], b.num_tokens_since_fired[hook])
            and (a.global_step, a.opt_step) == (b.global_step, b.opt_step))


def _l2_rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    got, ref = got.detach().float().cpu(), ref.detach().float().cpu()
    return ((got - ref).norm() / ref.norm()).item()


def check_accumulate_cpu(chunk: torch.Tensor, dev) -> dict:
    """The card's `accumulate` against the CPU's on one chunk (1,024 tokens
    of the subject's hidden states) at d 4,096 and 16,384 latents, k 256,
    AuxK on with every other latent dead.  Parameters and chunk lie on a
    grid (W_enc multiples of 2^-7 up to 2^-4, biases and inputs multiples
    of 2^-4 and 2^-11, inputs clamped to [-8, 8]) on which every product
    and partial sum of the encoder is exact in fp32, so the two devices'
    pre-activations agree bit for bit and the masks must be equal."""
    from multimodal_sae_tpu_torch.config import SaeConfig, TrainConfig
    from multimodal_sae_tpu_torch.ops.sparse_decode import topk_mask_decode
    from multimodal_sae_tpu_torch.sae import pre_acts
    from multimodal_sae_tpu_torch.train.trainer import accumulate

    d, L, k = chunk.shape[1], 16384, 256
    rng = np.random.default_rng(3)
    W_enc = rng.integers(-8, 9, size=(d, L)).astype(np.float32) / 2**7
    W_dec = rng.standard_normal((L, d)).astype(np.float32)
    host = {"W_enc": W_enc, "b_enc": rng.integers(-8, 9, size=L).astype(np.float32) / 2**11,
            "W_dec": W_dec, "b_dec": rng.integers(-4, 5, size=d).astype(np.float32) / 2**4}
    x = (chunk.float() * 16).round().clamp(-128, 128).cpu() / 16
    cfg = TrainConfig(sae=SaeConfig(num_latents=L, k=k), auxk_alpha=1 / 32)
    dead = torch.zeros(L, dtype=torch.bool)
    dead[::2] = True
    out = {}
    for where in ("cuda", "cpu"):
        device = dev if where == "cuda" else torch.device("cpu")
        params = {n: torch.from_numpy(a.copy()).to(device).requires_grad_(True) for n, a in host.items()}
        t0 = time.perf_counter()
        fired, sums = accumulate(params, x.to(device), dead.to(device), cfg)
        mask = topk_mask_decode(pre_acts(params, x.to(device)).detach(), params["W_dec"].detach(), k)[2]
        if where == "cuda":
            torch.cuda.synchronize()
        out[where] = {"fired": fired.cpu(), "mask": mask.cpu(), "sums": {n: v.item() for n, v in sums.items()},
                      "grads": {n: p.grad.cpu() for n, p in params.items()}, "s": time.perf_counter() - t0}
        del params, fired, mask
    gpu, cpu = out["cuda"], out["cpu"]
    if not (torch.equal(gpu["mask"], cpu["mask"]) and torch.equal(gpu["fired"], cpu["fired"])):
        raise AssertionError("the card's selection or fired mask differs from the CPU's")
    rel = {n: _l2_rel(gpu["grads"][n], cpu["grads"][n]) for n in host}
    if not all(r <= TRAIN_CPU_L2_REL for r in rel.values()):
        raise AssertionError(f"the card's accumulate differs from the CPU's: relative L2 {rel}")
    line = {"tokens": x.shape[0], "d": d, "latents": L, "k": k, "masks_equal": True,
            "selected": int(gpu["mask"].sum()), "fired": int(gpu["fired"].sum()), "grad_l2_rel": rel,
            "l2_rel_bound": TRAIN_CPU_L2_REL, "sums_card": gpu["sums"], "sums_cpu": cpu["sums"],
            "seconds_card": gpu["s"], "seconds_cpu": cpu["s"]}
    torch.cuda.empty_cache()
    return line


def check_fast_vs_slow(params: dict, x: torch.Tensor, cfg) -> tuple:
    """`forward(fast=False)` (select_topk, then the sparse decode with its
    backward: K2's decode and dvals modes) against the fast path on one
    chunk at full width: fvu and each gradient, and each path's forward and
    backward timed once by CUDA events (the first calls at this shape).
    The slow run is counted.  Returns (line, launches, the slow path's
    top-k indices)."""
    from multimodal_sae_tpu_torch.sae import forward

    grads, fvu, ms = {}, {}, {}
    for fast in (True, False):
        p = {n: t.detach().clone().requires_grad_(True) for n, t in params.items()}
        gc.collect()
        if not fast:
            reset_kernel_counts()
        events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        events[0].record()
        out = forward(p, x, cfg.sae, fast=fast)
        events[1].record()
        out.fvu.backward()
        events[2].record()
        torch.cuda.synchronize()
        ms["fast" if fast else "slow"] = {"forward": events[0].elapsed_time(events[1]),
                                          "backward": events[1].elapsed_time(events[2])}
        if not fast:
            launches = kernel_counts()
            idx = out.latent_indices
        fvu[fast] = out.fvu.item()
        grads[fast] = {n: t.grad for n, t in p.items()}
        del p, out
    expected = {"block_max": 2, "flash_attention": 0, "flash_attention_bwd_delta": 0, "flash_attention_bwd_dkdv": 0,
                "flash_attention_bwd_dq": 0, "gather_rows": 1, "splice_decode": 0, "decode_dvals": 1,
                "sae_encode": 0}
    if launches != expected:
        raise AssertionError(f"forward(fast=False) kernel launches {launches}, expected {expected}")
    rel = {n: _l2_rel(grads[False][n], grads[True][n]) for n in params}
    fvu_rel = abs(fvu[False] - fvu[True]) / fvu[True]
    if not (np.isfinite(fvu[False]) and fvu_rel <= FAST_SLOW_REL and all(r <= FAST_SLOW_REL for r in rel.values())):
        raise AssertionError(f"forward(fast=False) differs from the fast path: fvu {fvu}, gradients {rel}")
    del grads
    torch.cuda.empty_cache()
    return ({"tokens": x.shape[0], "fvu_fast": fvu[True], "fvu_slow": fvu[False], "fvu_rel": fvu_rel,
             "grad_l2_rel": rel, "bound": FAST_SLOW_REL, "ms": ms, "launches": launches}, launches, idx)


def check_decode_dvals(W: torch.Tensor, idx: torch.Tensor, uniform: bool = False) -> dict:
    """K2's dvals mode at (tokens, k) = idx's shape on the decoder W, with a
    seeded g: within an fp32 bound of its plain version, equal bits over two
    calls, timed (median of 5) beside its bound and the plain version, with
    the rows a tile names; with `uniform`, also on a seeded uniform index
    set of the same shape."""
    from multimodal_sae_tpu_torch.ops import gather_rows as gr

    N, k = idx.shape
    d = W.shape[1]
    g = torch.randn(N, d, generator=torch.Generator(device=W.device).manual_seed(4), device=W.device)
    got = gr.decode_dvals(g, idx, W, torch.float32)
    again = gr.decode_dvals(g, idx, W, torch.float32)
    ref = gr.decode_dvals_plain(g, idx, W, torch.float32)
    torch.cuda.synchronize()
    # Each side sums d fp32 products in its own order: each differs from the
    # exact sum by at most d * 2^-24 * sum_d |g[n, d] * W[r, d]|.
    err_bound = 2 * d * 2.0 ** -24 * g.abs().sum(-1).max().item() * W.abs().max().item()
    err = (got - ref).abs().max().item()
    if not (torch.isfinite(got).all() and err <= err_bound):
        raise AssertionError(f"decode_dvals off by {err} (bound {err_bound})")
    if not _bits_equal(got, again):
        raise AssertionError("decode_dvals is not deterministic")
    distinct = torch.unique(idx).numel()
    nbytes = distinct * d * W.element_size() + N * d * 4 + N * k * 8
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    fma_ms = N * k * d / FP32_FMAS * 1e3
    repeats = time_repeats(lambda: gr.decode_dvals(g, idx, W, torch.float32))
    line = {"tokens": N, "k": k, "W": [W.shape[0], d], "distinct_rows": distinct,
            "rows_a_tile_names": tile_stats(idx), "max_abs_err": err,
            "err_bound": err_bound, "deterministic": True, "kernel_ms": repeats["median"],
            "kernel_ms_repeats": repeats, "plain_ms": time_ms(lambda: gr.decode_dvals_plain(g, idx, W, torch.float32), iters=3),
            "bound_ms": max(bytes_ms, fma_ms), "bound_bytes_ms": bytes_ms, "bound_fma_ms": fma_ms,
            "bound_by": "bytes" if bytes_ms >= fma_ms else "operations", "no_reuse_gb": N * k * d * W.element_size() / 1e9}
    del g, got, again, ref
    torch.cuda.empty_cache()
    if uniform:
        line["uniform"] = check_decode_dvals(W, _uniform_set(W, N, k)[0])
    return line


def phase_train_path(dev, card: str) -> dict:
    """SAE training at the README's command shape on the LLaMA-3-8B-width
    subject (random bf16 weights, 25 layers, hookpoint layers.24), through
    `SaeTrainer`'s `step`, `save` and `load_state`."""
    from collections import defaultdict

    from multimodal_sae_tpu_torch.config import SaeConfig, TrainConfig
    from multimodal_sae_tpu_torch.device import setup
    from multimodal_sae_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from multimodal_sae_tpu_torch.train import MemmapDataset, SaeTrainer
    from multimodal_sae_tpu_torch.train.trainer import _iter_batches

    setup(dev)
    hook, B, S, L, k, acc = "layers.24", 8, 2048, 131072, 256, 4
    n_batches = 10  # 8, then one resumed, then one with AuxK
    seconds = {}
    t0 = time.perf_counter()
    cfg_subject = LlamaConfig(num_hidden_layers=25, flash_attention=True)
    model = LlamaModel.random(cfg_subject, seed=0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    seconds["init_subject"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # LLaMA-3's ids need more than the reference's uint16 tokens.
        ids = np.random.default_rng(2).integers(0, cfg_subject.vocab_size, size=(n_batches * B, S), dtype=np.uint32)
        ids.tofile(os.path.join(tmp, "tokens.bin"))
        dataset = MemmapDataset(os.path.join(tmp, "tokens.bin"), S, dtype=np.uint32)
        batches = list(_iter_batches(dataset, B))

        def config():
            return TrainConfig(sae=SaeConfig(num_latents=L, k=k), batch_size=B, grad_acc_steps=acc,
                               micro_acc_steps=TRAIN_MICRO, lr_warmup_steps=0, log_to_wandb=False,
                               hookpoints=[hook], save_every=10**9, run_name=os.path.join(tmp, "run"))

        t0 = time.perf_counter()
        trainer = SaeTrainer(config(), dataset, model, device=dev)
        torch.cuda.synchronize()
        seconds["init_trainer"] = time.perf_counter() - t0
        metrics = {hook: defaultdict(float)}
        losses = []

        def step(tr, batch, mark=None):
            tr.step(batch, metrics, mark=mark)
            losses.append({key: val * tr.cfg.grad_acc_steps for key, val in metrics[hook].items()})
            metrics[hook].clear()

        # The projected gradient the optimizer is handed at the first
        # boundary, against the decoder rows.
        ortho = {}
        update = trainer.optimizer.update

        def spy(grads, state):
            W, g = trainer.saes[hook].W_dec.detach(), grads["W_dec"]
            ortho["max_dot"] = torch.einsum("ld,ld->l", g, W).abs().max().item()
            ortho["max_row_norm"] = torch.linalg.vector_norm(g, dim=1).max().item()
            return update(grads, state)

        torch.cuda.reset_peak_memory_stats()
        gc.collect()
        reset_kernel_counts()
        t0 = time.perf_counter()
        for i, batch in enumerate(batches[:8]):
            if i == 2:
                torch.cuda.synchronize()
                t_steady = time.perf_counter()
            trainer.optimizer.update = spy if i == 3 else update
            if i == 6:
                step(trainer, batch)  # not a boundary: the decoder as `accumulate` stored it
                W = trainer.saes[hook].W_dec.detach()
                unit_err = (torch.linalg.vector_norm(W, dim=1) - 1).abs().max().item()
            elif i == 7:
                marks = StageMarks()
                window = {}
                marks.on_apply = lambda: window.update(fired=trainer._fired_dev[hook].clone())
                step(trainer, batch, mark=marks)
            else:
                step(trainer, batch)
        torch.cuda.synchronize()
        seconds["eight_batches"] = time.perf_counter() - t0
        steady_s = time.perf_counter() - t_steady
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        stage_ms = marks.ms()
        trainer.optimizer.update = update
        if not unit_err <= UNIT_NORM_TOL:
            raise AssertionError(f"decoder rows after accumulate off unit norm by {unit_err}")
        if not ortho["max_dot"] <= ORTHO_REL * ortho["max_row_norm"]:
            raise AssertionError(f"projected decoder gradient not orthogonal to the rows: {ortho}")
        counts = trainer.num_tokens_since_fired[hook]
        fired = window["fired"].cpu().numpy()
        if not (np.array_equal(counts == 0, fired) and set(np.unique(counts)) <= {0, acc * B * S, 2 * acc * B * S}
                and torch.equal(trainer._dead_mask_dev[hook].cpu(), torch.from_numpy(counts > trainer.cfg.dead_feature_threshold))):
            raise AssertionError("dead-feature counters disagree with the window's fired mask")

        t0 = time.perf_counter()
        trainer.save()
        seconds["save"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        resumed = SaeTrainer(config(), dataset, model, device=dev)
        resumed.load_state(os.path.join(tmp, "run"))
        torch.cuda.synchronize()
        seconds["init_and_load_state"] = time.perf_counter() - t0
        if not _trainer_state_equal(trainer, resumed, hook):
            raise AssertionError("the resumed trainer's state differs from the saved one")
        del trainer
        gc.collect()
        torch.cuda.empty_cache()

        step(resumed, batches[8])
        # AuxK: half the latents dead (65,536 against k_aux = 2,048: scale 1).
        resumed.cfg.auxk_alpha = 1 / 32
        resumed.cfg.micro_acc_steps = AUXK_MICRO
        resumed.num_tokens_since_fired[hook][::2] = resumed.cfg.dead_feature_threshold + 1
        resumed._refresh_dead_mask(hook)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        step(resumed, batches[9])
        torch.cuda.synchronize()
        seconds["auxk_batch"] = time.perf_counter() - t0
        auxk_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launches = kernel_counts()
        # The trainer's SAE (W_enc requires grad) encodes by torch.matmul.
        expected = {"block_max": 2 * (9 * TRAIN_MICRO + AUXK_MICRO), "flash_attention": 25 * n_batches,
                    "flash_attention_bwd_delta": 0, "flash_attention_bwd_dkdv": 0, "flash_attention_bwd_dq": 0,
                    "gather_rows": 0, "splice_decode": 0, "decode_dvals": 0, "sae_encode": 0}
        if launches != expected:
            raise AssertionError(f"training kernel launches {launches}, expected {expected}")
        if not all(np.isfinite(v) for line in losses for v in line.values()):
            raise AssertionError(f"non-finite training loss: {losses}")
        if not losses[-1]["auxk"] > 0:
            raise AssertionError(f"AuxK loss {losses[-1]['auxk']} with half the latents dead")

        # Cross-checks on one captured batch.
        with torch.no_grad():
            h = model.capture(batches[0], [hook])[hook].reshape(-1, cfg_subject.hidden_size)
        t0 = time.perf_counter()
        cpu_line = check_accumulate_cpu(h[:1024], dev)
        seconds["cpu_cross_check"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        slow_line, slow_launches, idx = check_fast_vs_slow(resumed.saes[hook].params, h[:4096], resumed.cfg)
        seconds["fast_vs_slow"] = time.perf_counter() - t0
        dvals = check_decode_dvals(resumed.saes[hook].W_dec.detach(), idx)
        del resumed, h, idx
    torch.cuda.empty_cache()

    tokens_steady = 6 * B * S
    emit({
        "phase": "train_path", "subject": "LLaMA-3-8B widths, 25 layers, bf16, flash attention",
        "sae": "4096 -> 131072 latents, k=256, fp32", "hookpoint": hook, "batch_size": B, "ctx_len": S,
        "grad_acc_steps": acc, "micro_acc_steps": TRAIN_MICRO, "auxk_micro_acc_steps": AUXK_MICRO,
        "tokens_per_s": tokens_steady / steady_s, "tokens_per_s_over": "batches 3-8", "seconds": seconds,
        "stage_ms_batch8": stage_ms, "peak_gb": peak_gb, "auxk_peak_gb": auxk_peak_gb,
        "losses": losses, "decoder_unit_norm_err": unit_err, "unit_norm_tol": UNIT_NORM_TOL,
        "projected_grad": ortho, "ortho_rel": ORTHO_REL, "launches": launches,
        "cpu_cross_check": cpu_line, "fast_vs_slow": slow_line, "decode_dvals": dvals, "card": card,
    })
    return {"launches": {name: launches[name] + slow_launches[name] for name in launches}, "dvals": dvals}


UNIFORM_HW = (480, 640)
MIXED_HW = ((480, 640), (336, 336), (300, 900), (1000, 1000))
MIXED_LENGTHS = (2341, 1177, 2329, 2929)
# The image cache's batches (as bench.py's image headline): 4 images of
# 480 x 640 (5 crops, 2,341 tokens a row with the BOS), and 4 geometries
# whose rows the subject right-pads to 2,929.
IMAGE_BOS = 128000
# Each image of the mixed batch run alone (a batch of 1, no mask, its own
# ragged length) must give its row of the mixed batch (right-padded to
# 2,929) bit for bit over its valid tokens at model.layers.24, as every
# chip run has.  Causality keeps right-pad keys away from every valid
# query, so this check cannot see a pad key read: it holds the tower, the
# scatter and K3 consistent across sequence lengths and ragged last tiles.
# K3's key mask is held by phase_flash_attention's right-pad cases.


def _image_rows(cfg, sizes, rng) -> list:
    """Prepared LLaVA-NeXT rows, one image each: the prompt [BOS, <image>]
    and a pixel array of the image's crops drawn from `rng`, one array per
    image so that the tower runs once per image."""
    from multimodal_sae_tpu_torch.models.llava_next import image_size_to_num_patches

    S = cfg.vision_config.image_size
    return [{"prompt_ids": [IMAGE_BOS, cfg.image_token_index], "image_size": (h, w),
             "pixel_values": rng.standard_normal(
                 (image_size_to_num_patches((h, w), cfg.image_grid_pinpoints, S), 3, S, S), dtype=np.float32)}
            for h, w in sizes]


def _collate_prepared(cfg, rows: list) -> dict:
    """A batch of `_image_rows` rows as `prepare_inputs` builds it (the
    card's machine has no PIL): each `<image>` placeholder expanded to its
    image's token count, the rows right-padded with a mask."""
    from multimodal_sae_tpu_torch.models.llava_next import get_number_of_features

    expanded = [[t for t0 in row["prompt_ids"]
                 for t in ([t0] * get_number_of_features(*row["image_size"], cfg)
                           if t0 == cfg.image_token_index else [t0])] for row in rows]
    ids = np.zeros((len(rows), max(map(len, expanded))), np.int64)
    mask = np.zeros_like(ids)
    for i, row in enumerate(expanded):
        ids[i, : len(row)] = row
        mask[i, : len(row)] = 1
    return {"input_ids": ids, "attention_mask": mask, "pixel_values": [row["pixel_values"] for row in rows],
            "image_sizes": [row["image_size"] for row in rows]}


def _image_batch(cfg, sizes, rng) -> dict:
    """A prepared batch of one [BOS, <image>] row per image of `sizes`."""
    return _collate_prepared(cfg, _image_rows(cfg, sizes, rng))


def check_cached_topk(locs, acts, h, row0: int, sae) -> None:
    """The cached rows row0 .. row0 + B of one batch against an independent
    top-k of its hidden `h` (B, S, D; BOS dropped): each entry's activation
    equals the recomputed latent bit for bit and is at least its token's
    k-th value, no (token, feature) pair repeats, and each token holds as
    many entries as its top-k has values above 1e-5, so the cached set is
    the top-k up to ties at the k-th value."""
    from multimodal_sae_tpu_torch.sae import pre_acts

    B, S1 = h.shape[0], h.shape[1] - 1
    latents = pre_acts(sae.params, h[:, 1:].reshape(-1, h.shape[-1]))
    top = torch.topk(latents, sae.cfg.k, dim=-1).values
    sel = (locs[:, 0] >= row0) & (locs[:, 0] < row0 + B)
    loc = torch.from_numpy(locs[sel]).to(h.device)
    act = torch.from_numpy(acts[sel]).to(h.device)
    tok = (loc[:, 0] - row0) * S1 + loc[:, 1]
    if not torch.equal(latents[tok, loc[:, 2]], act):
        raise AssertionError("a cached activation differs from its recomputed latent")
    if bool((act < top[tok, -1]).any()):
        raise AssertionError("a cached entry lies below its token's k-th value")
    if torch.unique(tok * sae.W_enc.shape[1] + loc[:, 2]).numel() != len(tok):
        raise AssertionError("a (token, feature) pair is cached twice")
    if not torch.equal(torch.bincount(tok, minlength=B * S1), (top > 1e-5).sum(-1)):
        raise AssertionError("a token's cached entries differ in number from its top-k above 1e-5")


def phase_image_cache_path(dev, card: str) -> dict:
    """The image cache at llama3-llava-next-8b's widths (random bf16 weights:
    the CLIP-L/336 tower, the projector and LLaMA-3-8B's text widths cut to
    the 25 layers model.layers.24 reads, flash attention) and the released
    SAE's width (131,072 latents, k=256, fp32), through `FeatureImageCache`
    as the cache_image CLI drives it, on prepared batches."""
    from multimodal_sae_tpu_torch.config import SaeConfig
    from multimodal_sae_tpu_torch.device import setup
    from multimodal_sae_tpu_torch.features import FeatureImageCache
    from multimodal_sae_tpu_torch.interp_utils import load_saes
    from multimodal_sae_tpu_torch.models.llama import LlamaConfig
    from multimodal_sae_tpu_torch.models.llava_next import LlavaNextConfig, LlavaNextModel
    from multimodal_sae_tpu_torch.ops import sort_pairs_by_index, top_k
    from multimodal_sae_tpu_torch.sae import Sae, pre_acts

    setup(dev)
    hook, n_uniform, batch_size, n_splits = "model.layers.24", 4, 4, 128
    seconds = {}
    t0 = time.perf_counter()
    # The placeholder id 128,256 must index the embedding table.
    cfg = LlavaNextConfig(text_config=LlamaConfig(vocab_size=128257, num_hidden_layers=25, flash_attention=True))
    model = LlavaNextModel.random(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    seconds["init_subject"] = time.perf_counter() - t0

    rng = np.random.default_rng(0)
    batches = [_image_batch(cfg, [UNIFORM_HW] * batch_size, rng) for _ in range(n_uniform)]
    batches.append(_image_batch(cfg, MIXED_HW, rng))
    lengths = [tuple(int(n) for n in b["attention_mask"].sum(1)) for b in batches]
    if lengths != [(MIXED_LENGTHS[0],) * batch_size] * n_uniform + [MIXED_LENGTHS]:
        raise AssertionError(f"placeholder expansion gave row lengths {lengths}")
    n_images = sum(len(b["image_sizes"]) for b in batches)
    n_tokens = sum(sum(row) for row in lengths)
    positions = sum(b["input_ids"].size for b in batches)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t0 = time.perf_counter()
        Sae(4096, SaeConfig(num_latents=131072, k=256), decoder=False, seed=0, device=dev) \
            .save_to_disk(os.path.join(tmp, "saes", hook))
        saes = load_saes(os.path.join(tmp, "saes"), device=dev)
        sae = saes[hook]
        torch.cuda.synchronize()
        seconds["init_sae_save_load"] = time.perf_counter() - t0

        # Warm-up (cuBLAS handles, allocator) outside the counted run.
        t0 = time.perf_counter()
        h = model.capture(batches[0], [hook])[hook]
        top_k(pre_acts(sae.params, h[:, 1:].reshape(-1, h.shape[-1])), sae.cfg.k, assume_finite=True)
        torch.cuda.synchronize()
        seconds["warmup"] = time.perf_counter() - t0
        del h

        # The counted run keeps nothing and counts nothing on the host: the
        # checks below capture each batch again.
        save_dir = os.path.join(tmp, "cache")
        fc = FeatureImageCache(lambda batch: model.capture(batch, [hook]), saes, batch_size=batch_size)
        fc.enable_streaming(save_dir, n_splits=n_splits)
        torch.cuda.reset_peak_memory_stats()
        gc.collect()
        reset_kernel_counts()
        t0 = time.perf_counter()
        fc.run(positions, iter(batches), progress=False)
        torch.cuda.synchronize()
        seconds["run"] = time.perf_counter() - t0
        launches = kernel_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        expected = {"block_max": 2 * len(batches), "flash_attention": 25 * len(batches),
                    "flash_attention_bwd_delta": 0, "flash_attention_bwd_dkdv": 0,
                    "flash_attention_bwd_dq": 0, "gather_rows": 0, "splice_decode": 0, "decode_dvals": 0,
                    "sae_encode": len(batches)}
        if launches != expected:
            raise AssertionError(f"kernel launches {launches} over {len(batches)} batches, expected {expected}")
        t0 = time.perf_counter()
        fc.save_splits(n_splits, save_dir)
        fc.concate_safetensors(n_splits, save_dir)
        seconds["save_and_merge"] = time.perf_counter() - t0

        locs, acts = check_splits(os.path.join(save_dir, hook), n_splits, 131072)
        n_entries = len(acts)
        rows = sum(len(b["image_sizes"]) for b in batches)
        if not ((locs[:, 0] < rows).all() and set(np.unique(locs[:, 0])) == set(range(rows))):
            raise AssertionError("merged rows out of range")
        # Every batch captured again (the forward is deterministic: the cached
        # activations must equal its latents bit for bit); the per-token
        # counts over every row also hold the splits' total.
        t0 = time.perf_counter()
        row0 = 0
        for batch in batches:
            h = model.capture(batch, [hook])[hook]
            check_cached_topk(locs, acts, h, row0, sae)
            row0 += h.shape[0]
        seconds["check_topk"] = time.perf_counter() - t0
        h_mixed = h
        del locs, acts

    # Each image of the mixed batch alone, a batch of 1 without a mask.
    mixed = batches[-1]
    alone = []
    for i, (hw, n) in enumerate(zip(MIXED_HW, MIXED_LENGTHS)):
        single = {"input_ids": mixed["input_ids"][i : i + 1, :n], "attention_mask": mixed["attention_mask"][i : i + 1, :n],
                  "pixel_values": [mixed["pixel_values"][i]], "image_sizes": [hw]}
        h1 = model.capture(single, [hook])[hook][0]
        ref = h_mixed[i, :n]
        err = (h1.float() - ref.float()).norm(dim=-1) / ref.float().norm(dim=-1)
        line = {"size": list(hw), "tokens": n, "equal_bits": _bits_equal(h1, ref),
                "max_row_l2_rel": err.max().item(), "max_abs_err": (h1.float() - ref.float()).abs().max().item()}
        if not line["equal_bits"]:
            raise AssertionError(f"image {hw} alone differs from its row of the mixed batch: {line}")
        alone.append(line)
    del h_mixed

    # Batch 0 again, stage by stage (CUDA events).
    marks = StageMarks()
    embed, pack = model._embed_multimodal, model._project_pack_group

    def timed_pack(*args):
        marks("pixels_to_device")
        out = pack(*args)
        marks("tower_projector_pack")
        return out

    def timed_embed(batch):
        out = embed(batch)
        marks("placeholder_scatter")
        return out

    model._project_pack_group, model._embed_multimodal = timed_pack, timed_embed
    h = model.capture(batches[0], [hook])[hook]
    marks("subject_forward")
    latents = pre_acts(sae.params, h[:, 1:].contiguous().reshape(-1, h.shape[-1]))
    marks("encode")
    vals, idx = top_k(latents, sae.cfg.k, assume_finite=True)
    sort_pairs_by_index(idx, vals)
    marks("top_k")
    stage_ms = marks.ms()
    del model._project_pack_group, model._embed_multimodal, h, latents, vals, idx

    emit({
        "phase": "image_cache_path",
        "subject": "llama3-llava-next-8b widths: CLIP-L/336 tower, projector, LLaMA-3-8B text cut to 25 "
                   "layers, bf16, flash attention",
        "sae": "4096 -> 131072 latents, k=256, fp32", "hookpoint": hook,
        "batches": [b["image_sizes"] for b in batches], "row_lengths": lengths,
        "images": n_images, "tokens": n_tokens, "positions_cached": positions - len(batches) * batch_size,
        # Five batches, a window of seconds: smoke readings, not the cache's
        # throughput or memory, until a benchmark times a longer run.
        "smoke_images_per_s": n_images / seconds["run"], "smoke_tokens_per_s": n_tokens / seconds["run"],
        "smoke_peak_gb": peak_gb, "seconds": seconds, "stage_ms_batch0": stage_ms, "launches": launches,
        "entries": n_entries, "n_splits": n_splits, "alone_vs_mixed": alone, "card": card,
    })
    del saes, sae
    return {"launches": launches, "model": model}


def _record_key(record) -> tuple:
    """A loader record as comparable bytes: tokens exactly, activations bit
    for bit, the sampled `train`."""
    def ex(examples):
        return tuple((e.tokens.dtype.str, e.tokens.tobytes(), e.activations.dtype.str, e.activations.tobytes())
                     for e in examples or ())

    return record.feature.module_name, record.feature.feature_index, ex(record.examples), ex(record.train)


def _timed_load(dataset, constructor, sampler, num_workers: int) -> tuple:
    """(records, {wall_s, cpu_s, constructor_s, sampler_s}) of one collated
    load; the constructor's and sampler's own seconds are summed only on a
    sequential load (None on a threaded one)."""
    spent = {"constructor_s": 0.0, "sampler_s": 0.0}

    def timed(name, fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent[name] += time.perf_counter() - t0

        return call

    if num_workers <= 1:
        constructor, sampler = timed("constructor_s", constructor), timed("sampler_s", sampler)
    else:
        spent = {"constructor_s": None, "sampler_s": None}
    t0, c0 = time.perf_counter(), time.process_time()
    records = dataset.load(collate=True, constructor=constructor, sampler=sampler, num_workers=num_workers)
    return records, {"wall_s": time.perf_counter() - t0, "cpu_s": time.process_time() - c0, **spent}


def check_records(records, module_dir: str, edges: np.ndarray, tokens: np.ndarray, cfg, n_train: int) -> int:
    """Every record against a numpy reconstruction from the raw split, read
    whole (`load_file`, no mmap, no sidecar): the feature's entries by a
    boolean mask in file order, scattered into the dense (rows, seq) batch,
    cut into windows, ranked by their max with ties in window order, the
    top `max_examples` nonzero ones.  Returns the entries checked."""
    from multimodal_sae_tpu_torch.utils.safetensors_io import load_file

    by_split: dict = {}
    for r in records:
        by_split.setdefault(int(np.searchsorted(edges, r.feature.feature_index, side="right")) - 1, []).append(r)
    rows, seq = tokens.shape
    tok_windows = tokens[:, : seq // cfg.example_ctx_len * cfg.example_ctx_len].reshape(-1, cfg.example_ctx_len)
    checked = 0
    for split, recs in by_split.items():
        data = load_file(os.path.join(module_dir, f"{edges[split]}_{edges[split + 1] - 1}.safetensors"))
        locs, acts = data["locations"].numpy(), data["activations"].numpy()
        for r in recs:
            mask = locs[:, 2] == r.feature.feature_index
            checked += int(mask.sum())
            dense = np.zeros((rows, seq), acts.dtype)
            np.add.at(dense, (locs[mask, 0], locs[mask, 1]), acts[mask])
            windows = dense[:, : tok_windows.size // rows].reshape(-1, cfg.example_ctx_len)
            pools = windows.max(axis=1)
            order = np.lexsort((np.arange(len(pools)), -pools))[: min(cfg.max_examples, int((pools != 0).sum()))]
            want = tuple((tok_windows.dtype.str, tok_windows[i].tobytes(), windows.dtype.str, windows[i].tobytes())
                         for i in order)
            got = _record_key(r)
            if got[2] != want:
                raise AssertionError(f"record {r.feature} differs from its reconstruction from the raw split")
            if got[3] != want[:n_train]:
                raise AssertionError(f"record {r.feature}'s train is not its top {n_train} examples")
    return checked


def phase_loader_path(card: str, cache_dir: str, hook: str, tokens: np.ndarray) -> dict:
    """Feature loading (`FeatureDataset`) over the 128 splits the cache path
    merged, through the entry points a user calls: a filtered
    build of 2,000 features drawn with a seed from those the cache holds
    (`pool_max_activation_windows` on the cache's token rows, `sample`),
    sequential and threaded; then 8 splits unfiltered, first on the scan
    path (their sidecars removed; the load heals them), then through the
    sidecars.  Host numpy only: no kernel of the port runs."""
    from functools import partial

    from multimodal_sae_tpu_torch.config import ExperimentConfig, FeatureConfig
    from multimodal_sae_tpu_torch.features import FeatureDataset, loader, pool_max_activation_windows, sample
    from multimodal_sae_tpu_torch.features.split_index import index_path, mmap_safetensors

    width, n_splits, n_filter, n_unfiltered = 131072, 128, 2000, 8
    module_dir = os.path.join(cache_dir, hook)
    fcfg = FeatureConfig(width=width, n_splits=n_splits, example_ctx_len=64)
    ecfg = ExperimentConfig()
    edges = np.linspace(0, width, n_splits + 1).astype(np.int64)
    counts = np.zeros(width, np.int64)
    for start, end in zip(edges[:-1], edges[1:]):
        feats = mmap_safetensors(os.path.join(module_dir, f"{start}_{end - 1}.safetensors"))["locations"][:, 2]
        counts += np.bincount(feats, minlength=width)
    held = np.flatnonzero(counts)
    selected = np.sort(np.random.default_rng(7).choice(held, size=n_filter, replace=False))
    kept = selected[counts[selected] >= fcfg.min_examples]
    if not 0 < len(kept) < n_filter:
        raise AssertionError(f"{len(kept)} of the {n_filter} drawn features reach min_examples; "
                             "the draw must keep some and skip some")
    load_kw = dict(constructor=partial(pool_max_activation_windows, tokens=tokens, cfg=fcfg),
                   sampler=partial(sample, cfg=ecfg))
    hits = {"sidecar": 0, "scan": 0}
    hits_lock = threading.Lock()
    read_index = loader.read_index

    def counted_read_index(*args, **kw):
        out = read_index(*args, **kw)
        with hits_lock:
            hits["scan" if out is None else "sidecar"] += 1
        return out

    loader.read_index = counted_read_index
    builds = {}
    gc.collect()
    reset_kernel_counts()
    try:
        ds = FeatureDataset(cache_dir, fcfg, modules=[hook], features={hook: selected})
        filtered, times = _timed_load(ds, num_workers=1, **load_kw)
        builds["filtered_sequential"] = dict(buffers=len(ds), entries=int(counts[selected].sum()),
                                             records=len(filtered), **times)
        ds = FeatureDataset(cache_dir, fcfg, modules=[hook], features={hook: selected})
        threaded, times = _timed_load(ds, num_workers=LOADER_WORKERS, **load_kw)
        builds[f"filtered_{LOADER_WORKERS}_workers"] = dict(buffers=len(ds), entries=int(counts[selected].sum()),
                                                            records=len(threaded), **times)
        filtered_hits = dict(hits)
        # Unfiltered: the first 8 splits, their merge-time sidecars removed.
        for start, end in zip(edges[:n_unfiltered], edges[1 : n_unfiltered + 1]):
            os.remove(index_path(os.path.join(module_dir, f"{start}_{end - 1}.safetensors")))
        unfiltered = {}
        for path in ("scan", "sidecar"):
            ds = FeatureDataset(cache_dir, fcfg, modules=[hook])
            ds.buffers = ds.buffers[:n_unfiltered]
            before = dict(hits)
            unfiltered[path], times = _timed_load(ds, num_workers=1, **load_kw)
            if hits[path] - before[path] != n_unfiltered:
                raise AssertionError(f"the unfiltered {path} build read {hits} (before: {before})")
            builds[f"unfiltered_{path}"] = dict(buffers=n_unfiltered, entries=int(counts[: edges[n_unfiltered]].sum()),
                                                records=len(unfiltered[path]), **times)
    finally:
        loader.read_index = read_index
    launches = kernel_counts()
    if any(launches.values()):
        raise AssertionError(f"the loader launched kernels: {launches}")
    n_buffers = builds["filtered_sequential"]["buffers"]
    if filtered_hits != {"sidecar": 2 * n_buffers, "scan": 0}:
        raise AssertionError(f"the filtered builds did not read through the merge's sidecars: {filtered_hits}")
    keys = [_record_key(r) for r in filtered]
    if [r.feature.feature_index for r in filtered] != kept.tolist():
        raise AssertionError("the filtered build's records are not the drawn features that reach min_examples")
    if [_record_key(r) for r in threaded] != keys:
        raise AssertionError("the threaded load differs from the sequential one")
    if [_record_key(r) for r in unfiltered["sidecar"]] != [_record_key(r) for r in unfiltered["scan"]]:
        raise AssertionError("the sidecar path's records differ from the scan path's")
    t0 = time.perf_counter()
    checked = check_records(filtered, module_dir, edges, tokens, fcfg, ecfg.n_examples_train)
    checked += check_records(unfiltered["scan"], module_dir, edges, tokens, fcfg, ecfg.n_examples_train)
    check_s = time.perf_counter() - t0
    for b in builds.values():
        b.update(records_per_s=b["records"] / b["wall_s"], entries_per_s=b["entries"] / b["wall_s"],
                 host_cpu_share=b["cpu_s"] / b["wall_s"])
    emit({
        "phase": "loader_path", "note": "smoke readings of one short run, not throughput",
        "cache": f"{hook}, {n_splits} splits, {int(counts.sum())} entries, {len(held)} features held",
        "filter": {"drawn": n_filter, "kept": len(kept), "skipped_under_min_examples": n_filter - len(kept)},
        "min_examples": fcfg.min_examples, "example_ctx_len": fcfg.example_ctx_len, "builds": builds,
        "records_checked_against_raw_splits": len(filtered) + len(unfiltered["scan"]),
        "entries_checked": checked, "check_s": check_s, "threaded_equals_sequential": True,
        "scan_equals_sidecar": True, "launches": launches, "card": card,
    })
    return {"launches": launches, "records": filtered, "selected": selected}


class _StubTokenizer:
    """Token ids as strings (the card's machine has no tokenizer library)."""

    def batch_decode(self, ids):
        return [str(int(np.asarray(i).ravel()[0])) for i in ids]


def _near_tie_order(got_idx, ref: torch.Tensor, what: str) -> None:
    """`got_idx` (rows, k) against the float64 values `ref` (rows, n): at
    each rank the chosen candidate's value must be within STATS_NEAR_TIE of
    the float64 order's value at that rank."""
    got_idx = torch.as_tensor(np.asarray(got_idx), device=ref.device)
    want = torch.sort(ref, dim=-1, descending=True, stable=True).values[:, : got_idx.shape[1]]
    gap = (torch.gather(ref, 1, got_idx) - want).abs().max().item()
    if not gap <= STATS_NEAR_TIE:
        raise AssertionError(f"{what}: an index differs from the float64 order by {gap} (> {STATS_NEAR_TIE})")


def phase_stats_path(dev, card: str, model, sae, records, selected) -> dict:
    """Feature statistics and PCA on the card, on the attribution phase's
    SAE decoder (131,072 x 4,096 fp32) and subject's LM head (128,256 x
    4,096 bf16): `get_neighbors` for the loader's 2,000 drawn features at
    k = 10, `logits` for the loader's records, `PcaReducer.fit_sae_list` at
    the full decoder (the thin SVD timed beside it); each held against
    float64 on the card."""
    from multimodal_sae_tpu_torch.features import stats
    from multimodal_sae_tpu_torch.features.dim_reduce import PcaReducer

    hook = "layers.24"
    W_dec, W_U = sae.params["W_dec"], model.params["lm_head"]
    out, base_gb = {}, torch.cuda.memory_allocated() / 1e9

    def timed(name, fn):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        out[name] = {"ms": (time.perf_counter() - t0) * 1e3,
                     "peak_gb_above_resident": torch.cuda.max_memory_allocated() / 1e9 - base_gb}
        return result

    reset_kernel_counts()
    timed("get_neighbors_warmup", lambda: stats.get_neighbors({hook: sae}, {hook: selected[:16]}, k=10, device=dev))
    neighbors, _ = timed("get_neighbors", lambda: stats.get_neighbors({hook: sae}, {hook: selected}, k=10, device=dev))
    top = timed("logits", lambda: stats.logits(records, W_U, W_dec.T, k=10, tokenizer=_StubTokenizer(), device=dev))
    pca = timed("pca_fit_sae_list", lambda: PcaReducer(n_components=2, device=dev).fit_sae_list([sae]))
    # The JAX package's route, the thin SVD of the centred decoder, timed
    # beside the port's Gram route as the reason for taking the latter.
    svd = timed("pca_svd_reference", lambda: torch.linalg.svd(W_dec - W_dec.mean(dim=0), full_matrices=False).Vh[:2])
    launches = kernel_counts()
    if any(launches.values()):
        raise AssertionError(f"the stats phase launched kernels: {launches}")
    out["get_neighbors"].update(features=len(selected), k=10, cos_gb=len(selected) * W_dec.shape[0] * 4 / 1e9)
    out["logits"].update(records=len(records), k=10)
    out["pca_fit_sae_list"].update(rows=W_dec.shape[0], cols=W_dec.shape[1])

    # float64 on the card for 16 features.
    t0 = time.perf_counter()
    sel = torch.as_tensor(selected[:16], device=dev)
    W64 = W_dec.double()
    unit = W64 / (torch.linalg.vector_norm(W64, dim=1, keepdim=True) + 1e-12)
    cos64 = unit[sel] @ unit.T  # (16, L)
    got_idx = np.array([[int(f)] + neighbors[hook][i]["indices"] for i, f in enumerate(selected[:16])])
    _near_tie_order(got_idx, cos64, "get_neighbors")
    got_vals = torch.tensor([neighbors[hook][i]["values"] for i in range(16)], dtype=torch.float64, device=dev)
    cos_err = (got_vals - torch.gather(cos64, 1, torch.as_tensor(got_idx[:, 1:], device=dev))).abs().max().item()
    if not cos_err <= STATS_ATOL:
        raise AssertionError(f"neighbour cosines differ from float64 by {cos_err}")
    del unit, cos64
    feats16 = torch.tensor([r.feature.feature_index for r in records[:16]], device=dev)
    logits64 = W_U.double() @ W64[feats16].T  # (V, 16)
    _near_tie_order(np.array([[int(t) for t in r.top_logits] for r in records[:16]]), logits64.T.contiguous(), "logits")
    del logits64
    c = pca.components_.double()
    eye = torch.eye(2, device=dev, dtype=torch.float64)
    ortho = (c @ c.T - eye).abs().max().item()
    svd_ortho = (svd.double() @ svd.double().T - eye).abs().max().item()
    del svd
    Xc = W64 - W64.mean(dim=0)
    del W64
    cov = Xc.T @ Xc / (Xc.shape[0] - 1)
    del Xc
    eig = torch.linalg.eigvalsh(cov)[-2:].flip(0)
    ev = ((c @ cov) * c).sum(dim=1)
    ev_rel = ((ev - eig).abs() / eig).max().item()
    del cov
    if not ortho <= PCA_ORTHO:
        raise AssertionError(f"PCA components are orthonormal only within {ortho}")
    if not ev_rel <= PCA_EV_REL:
        raise AssertionError(f"PCA explained variance {ev.tolist()} against eigenvalues {eig.tolist()}: rel {ev_rel}")
    emit({
        "phase": "stats_path", "decoder": "131072 x 4096 fp32", "lm_head": "128256 x 4096 bf16",
        "calls": out, "float64_check_s": time.perf_counter() - t0, "checked_features": 16,
        "neighbor_cos_max_abs_err": cos_err, "pca_ortho_err": ortho, "svd_reference_ortho_err": svd_ortho,
        "pca_explained_variance": ev.tolist(),
        "cov_top_eigenvalues": eig.tolist(), "pca_ev_rel_err": ev_rel, "launches": launches, "card": card,
    })
    return {"launches": launches}


def check_flash_chain(dev, B: int, S: int, left_pads=None, seed: int = 11, H: int = 32, kvH: int = 8) -> dict:
    """The K3 chain at (B, H, kvH, S, 128) bf16 against the plain pair on
    its first min(B, 2) rows, row b left-padded by left_pads[b % len] (None:
    no mask; dO is 0 on the rows without a valid key, as on every caller's
    path); then the backward, and the forward with lse, on all B rows, each
    timed beside its bound, SDPA's call (GQA, or k and v repeated under a
    mask) and the plain version."""
    import torch.nn.functional as F

    from multimodal_sae_tpu_torch.ops import flash_attention as fa

    hd = 128
    scale = hd ** -0.5
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, H, S, hd, generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn(B, kvH, S, hd, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(B, kvH, S, hd, generator=gen, device=dev).to(torch.bfloat16)
    do = torch.randn(B, H, S, hd, generator=gen, device=dev).to(torch.bfloat16)
    pads = [left_pads[b % len(left_pads)] for b in range(B)] if left_pads else [0] * B
    pad_mask = sdpa_mask = None
    if left_pads:
        real = torch.arange(S, device=dev)[None, :] >= torch.tensor(pads, device=dev)[:, None]
        pad_mask = real.to(torch.int32)
        do = do * real[:, None, :, None]
        sdpa_mask = torch.ones(S, S, dtype=torch.bool, device=dev).tril() & real[:, None, None, :]
    n = min(B, 2)
    what = f"({n}, {H}, {kvH}, {S}, {hd}), left pads {pads[:n]}"
    line = _check_bwd_chain(fa, q[:n], k[:n], v[:n], None if pad_mask is None else pad_mask[:n], do[:n], scale, what)
    torch.cuda.empty_cache()
    o, lse = fa.flash_attention_fwd(q, k, v, pad_mask, scale, need_lse=True)
    kernel_ms = time_ms(lambda: fa.flash_attention_bwd(q, k, v, pad_mask, o, lse, do, scale))
    plain_ms = time_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, pad_mask, o, lse, do, scale), iters=2, warmup=1)
    torch.cuda.empty_cache()
    if sdpa_mask is None:
        kr, vr, sdpa = k, v, dict(is_causal=True, scale=scale, enable_gqa=True)
    else:  # SDPA's masked kernels take k and v repeated to H heads
        kr, vr = (t.repeat_interleave(H // kvH, dim=1) for t in (k, v))
        sdpa = dict(attn_mask=sdpa_mask, scale=scale)
    forward = {"ms": time_repeats(lambda: fa.flash_attention_fwd(q, k, v, pad_mask, scale, need_lse=True))["median"],
               "plain_ms": time_ms(lambda: fa.flash_attention_fwd_plain(q, k, v, pad_mask, scale), iters=2, warmup=1),
               "library_ms": time_ms(lambda: F.scaled_dot_product_attention(q, kr, vr, **sdpa))}
    torch.cuda.empty_cache()
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, kr, vr))
    out = F.scaled_dot_product_attention(qg, kg, vg, **sdpa)
    library_ms = time_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True))
    # Causal (query, key) pairs with a valid key: L (L + 1) / 2 a head for
    # a row of L real tokens.
    pairs = H * sum((S - p) * (S - p + 1) / 2 for p in pads)
    nbytes = (4 * B * H * S * hd + 4 * B * kvH * S * hd) * 2 + B * H * S * 4
    flops = 10 * hd * pairs
    fwd_flops, fwd_bytes = 4 * hd * pairs, (2 * B * H * S * hd + 2 * B * kvH * S * hd) * 2 + B * H * S * 4
    forward.update(bound_ms=max(fwd_flops / BF16_FLOPS, fwd_bytes / HBM_BYTES_PER_S) * 1e3,
                   bound_by="operations" if fwd_flops / BF16_FLOPS > fwd_bytes / HBM_BYTES_PER_S else "bytes",
                   tflops=fwd_flops / forward["ms"] / 1e9)
    del q, k, v, do, o, lse, qg, kg, vg, out, kr, vr, sdpa_mask
    torch.cuda.empty_cache()
    return {"shape": [B, H, kvH, S, hd], "left_pads": pads if left_pads else None, "forward_with_lse": forward,
            "max_abs_err": max(e["max_abs_err"] for e in line["errors"].values()), "errors": line["errors"],
            "lse_max_abs_err": line["lse_max_abs_err"], "deterministic": True, "ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3,
            "bound_by": "operations" if flops / BF16_FLOPS > nbytes / HBM_BYTES_PER_S else "bytes",
            "tflops": flops / kernel_ms / 1e9}


def _topk_at_hooks(model, batch, sae_dict) -> dict:
    """{hook: (N, k) top-k indices} of every token at each hook of the clean
    spliced forward (each SAE reads the output of the splices below it)."""
    from multimodal_sae_tpu_torch.features.patching import sae_splice_intervention

    tops = {}

    def recorder(name, sae):
        splice = sae_splice_intervention(sae)

        def iv(h):
            tops[name] = sae.encode(h.reshape(-1, h.shape[-1])).top_indices
            return splice(h)

        return iv

    with torch.no_grad():
        model.forward(batch, capture=tuple(sae_dict), return_logits=False,
                      interventions={name: recorder(name, sae) for name, sae in sae_dict.items()})
    return tops


def _selections(record: list, replay: bool, module=None):
    """A context in which every `select_topk` of `module` (the general
    path's splices, features.patching.utils, by default; fast attribution's
    prefix pool is features.patching.attribution's) is recorded or
    replayed.  Recording appends each call's selected indices to `record`.
    Replaying takes the entries back in order: the selected values are the
    latents gathered at the recorded indices (the same gradient into them
    as top-k's), and each call appends, for the tokens whose own top-k
    would select another set, the gap between their own k-th latent and
    the weakest recorded pick, relative to that k-th latent; an entry
    (indices, values) that carries the recording run's values measures the
    gap relative to the token's noise instead, the largest |own - recorded|
    over its picks."""
    import contextlib

    from multimodal_sae_tpu_torch.features.patching import utils as splice_utils
    from multimodal_sae_tpu_torch.sae.model import EncoderOutput

    module = module or splice_utils
    real, recorded = module.select_topk, iter(list(record))
    gaps = []

    def record_call(latents, k):
        out = real(latents, k)
        record.append(out.top_indices.detach().cpu())
        return out

    def replay_call(latents, k):
        entry = next(recorded)
        idx, recorded_vals = entry if isinstance(entry, tuple) else (entry, None)
        idx = idx.to(latents.device)
        vals = latents.gather(-1, idx.long())
        own = torch.topk(latents.detach(), k, dim=-1)
        rows = (own.indices.sort(-1).values != idx.long().sort(-1).values).any(-1)
        kth = own.values[:, -1]
        scale = kth if recorded_vals is None else (vals.detach() - recorded_vals.to(vals.device)).abs().max(-1).values
        gap = (kth - vals.detach().min(-1).values) / scale.clamp_min(torch.finfo(kth.dtype).tiny)
        gaps.append(gap[rows].cpu())
        return EncoderOutput(vals, idx)

    @contextlib.contextmanager
    def patched():
        module.select_topk = replay_call if replay else record_call
        try:
            yield gaps
        finally:
            module.select_topk = real
        if replay and next(recorded, None) is not None:
            raise AssertionError("the replaying run made fewer selections than were recorded")

    return patched()


def _reduced_comparison(model, sae_dict, dev, layers=4, S=256) -> dict:
    """The two-hookpoint general path on the card and on the CPU at reduced
    depth: the subject's first `layers` layers and its LM head in fp32 with
    eager attention, the two SAEs at `layers.1` and `layers.2`, one prompt
    of S ids; one feature from the lower hook's last-token top-k and one
    outside every top-k.

    The gradient at the lower splice runs through the upper splice's k
    selected latents, so a latent that ties the k-th within the two sides'
    fp32 noise and is selected on one side only would move that token's
    gradient by a step.  The card's selections are therefore recorded and
    the CPU run takes the same ones: the saliency must then agree within
    GENERAL_CPU_L2_REL.  Where the CPU's own top-k would have selected
    another set, the card's weakest pick must lie within GENERAL_NEAR_TIE of
    the CPU's own k-th latent; the count of such tokens is reported."""
    from functools import partial

    import dataclasses

    from multimodal_sae_tpu_torch.features.patching import general_attribution_maps, get_logit_diff
    from multimodal_sae_tpu_torch.models.llama import LlamaModel
    from multimodal_sae_tpu_torch.sae import Sae

    cfg = dataclasses.replace(model.cfg, num_hidden_layers=layers, flash_attention=False)

    def subject(device):
        p = {name: t.to(device=device, dtype=torch.float32) for name, t in model.params.items() if name != "layers"}
        p["layers"] = [{name: t.to(device=device, dtype=torch.float32) for name, t in lp.items()}
                       for lp in model.params["layers"][:layers]]
        return LlamaModel(p, cfg)

    def saes(device):
        return {f"layers.{i + 1}": Sae(sae.d_in, sae.cfg, params={n: t.to(device) for n, t in sae.params.items()})
                for i, sae in enumerate(sae_dict.values())}

    batch = {"input_ids": np.random.default_rng(100).integers(0, cfg.vocab_size, size=(1, S))}
    sides = {"card": (subject(dev), saes(dev), torch.tensor([[1000, 2000]], device=dev)),
             "cpu": (subject("cpu"), saes("cpu"), torch.tensor([[1000, 2000]]))}
    gpu_model, gpu_saes, _ = sides["card"]
    tops = _topk_at_hooks(gpu_model, batch, gpu_saes)
    held = torch.zeros(gpu_saes["layers.1"].W_dec.shape[0], dtype=torch.bool, device=dev)
    for idx in tops.values():
        held[idx.long().reshape(-1)] = True
    feats = [int(tops["layers.1"][-1, 0]), int(torch.nonzero(~held)[-1])]
    out, seconds, card_picks = {}, {}, []
    for side, (m, saes_, answers) in sides.items():
        t0 = time.perf_counter()
        with _selections(card_picks, replay=side == "cpu") as gaps:
            out[side] = general_attribution_maps(m, saes_, batch, partial(get_logit_diff, answer_token_indices=answers),
                                                 feats, progress=False)
        torch.cuda.synchronize()
        seconds[side] = time.perf_counter() - t0
    gaps = torch.cat(gaps)
    worst_gap = gaps.max().item() if len(gaps) else 0.0
    if worst_gap > GENERAL_NEAR_TIE:
        raise AssertionError(f"reduced run: the card's top-k lies {worst_gap} below the CPU's own k-th latent")
    for name in out["cpu"]:
        for f, got, want in zip(feats[1:], out["card"][name][1:], out["cpu"][name][1:]):
            if np.any(got != 0) or np.any(want != 0):
                raise AssertionError(f"reduced run: feature {f}, outside every top-k, is not 0 at {name}")
    rel = {}
    for name in out["cpu"]:
        got, want = out["card"][name][0], out["cpu"][name][0]
        rel[name] = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        if not (np.isfinite(got).all() and np.any(want != 0) and rel[name] <= GENERAL_CPU_L2_REL):
            raise AssertionError(f"reduced run: card and CPU differ at {name}, feature {feats[0]}: {rel}")
    return {"layers": layers, "tokens": S, "dtype": "float32, eager attention", "features": feats,
            "selections_replayed": len(card_picks), "cpu_would_select_differently": len(gaps),
            "largest_gap_of_those": worst_gap, "near_tie": GENERAL_NEAR_TIE,
            "l2_rel": rel, "l2_rel_bound": GENERAL_CPU_L2_REL,
            "outside_exact_zero": True, "card_s": seconds["card"], "cpu_s": seconds["cpu"]}


def phase_general_attribution_path(dev, card: str, model, sae24) -> dict:
    """The general attribution path over two hookpoints at full width: the
    32-layer LLaMA-3-8B-width subject of the attribution phase, its SAE at
    layers.24 and a second one (131,072 latents, k = 256, fp32, decoder) at
    layers.16, one prompt of 2,432 ids, 3 features from each hook's
    last-token top-k and 1 outside every top-k, through
    `general_attribution_maps`; then K2's dvals mode at the upper splice's
    indices and the K3 backward at one prompt against their plain versions,
    and the two-hookpoint call at reduced depth on the card against the CPU."""
    from functools import partial

    from multimodal_sae_tpu_torch.config import SaeConfig
    from multimodal_sae_tpu_torch.features.patching import general_attribution_maps, get_logit_diff
    from multimodal_sae_tpu_torch.sae import Sae

    S, width, n_layers, lower, upper = 2432, 131072, 32, "layers.16", "layers.24"
    t0 = time.perf_counter()
    sae16 = Sae(4096, SaeConfig(num_latents=width, k=256), decoder=True, seed=1, device=dev)
    sae_dict = {lower: sae16, upper: sae24}
    batch = {"input_ids": np.random.default_rng(1).integers(0, model.cfg.vocab_size, size=(1, S))}
    metric = partial(get_logit_diff, answer_token_indices=torch.tensor([[1000, 2000]], device=dev))
    tops = _topk_at_hooks(model, batch, sae_dict)
    held = {name: torch.zeros(width, dtype=torch.bool, device=dev) for name in sae_dict}
    for name, idx in tops.items():
        held[name][idx.long().reshape(-1)] = True
    free = torch.nonzero(~(held[lower] | held[upper])).squeeze(1).cpu().numpy()
    chosen = []
    for name in sae_dict:
        chosen += [f for f in tops[name][-1].long().tolist() if f not in chosen][:3]
    outside = int(np.random.default_rng(2).choice(free))
    feats = chosen + [outside]
    in_lower = held[lower][torch.tensor(feats, device=dev)].tolist()
    upper_idx = tops[upper]
    del tops, held
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    general_attribution_maps(model, sae_dict, batch, metric, feats[:1], progress=False)  # warm-up
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    reset_kernel_counts()
    marks = StageMarks()
    t0 = time.perf_counter()
    out = general_attribution_maps(model, sae_dict, batch, metric, feats, progress=False, mark=marks)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = kernel_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stages = marks.ms()
    F, n_above = len(feats), n_layers - 1 - int(lower.split(".")[1])
    # The clean spliced forward once, then per feature the corrupted forward
    # (32 attentions, an encode, a top-k of two block-max levels and a
    # decode at each splice: the upper splice's encode records its graph
    # and still runs the kernel), the backward through the 15 layers above
    # the lower splice, and the upper splice's decode backward (dvals; the
    # lower splice's values take no gradient).
    clean = {"block_max": 4, "flash_attention": n_layers, "gather_rows": 2, "sae_encode": 2}
    expected = {"block_max": 4 * (F + 1), "flash_attention": n_layers * (F + 1),
                "flash_attention_bwd_delta": n_above * F, "flash_attention_bwd_dkdv": n_above * F,
                "flash_attention_bwd_dq": n_above * F, "gather_rows": 2 * (F + 1), "splice_decode": 0,
                "decode_dvals": F, "sae_encode": 2 * (F + 1)}
    if launches != expected:
        raise AssertionError(f"general attribution kernel launches {launches}, expected {expected}")
    # A splice's output changes, and its saliency is nonzero, exactly where
    # the ablated feature is in some token's top-k at that hook or at a hook
    # below it: at the lower hook only the features of its own top-k; at the
    # upper hook every feature but the one outside both.
    for name in sae_dict:
        sal = _saliency(out, name)
        if sal.shape != (F, 1, S):
            raise AssertionError(f"general saliency shape {sal.shape} at {name}")
        nonzero = [bool(np.any(s != 0)) for s in sal]
        want = in_lower if name == lower else [True] * (F - 1) + [False]
        if nonzero != want:
            raise AssertionError(f"saliency nonzero for {nonzero} of features {feats} at {name}, expected {want}")
    del out
    profile = profile_chunk(lambda f: general_attribution_maps(model, sae_dict, batch, metric, f, progress=False),
                            feats[:1])
    dvals = check_decode_dvals(sae24.params["W_dec"], upper_idx, uniform=True)
    del upper_idx
    k3_bwd = check_flash_chain(dev, 1, 2432)
    reduced = _reduced_comparison(model, sae_dict, dev)
    del sae_dict, sae16
    gc.collect()
    torch.cuda.empty_cache()
    per_feature = {stage: stages[stage] / len(feats) for stage in ("forward", "backward", "saliency")}
    ms_per_feature = sum(per_feature.values())
    emit({
        "phase": "general_attribution_path",
        "subject": "LLaMA-3-8B widths, 32 layers, bf16, flash attention, LM head",
        "saes": {name: "4096 -> 131072 latents, k=256, fp32, decoder" for name in (lower, upper)},
        "prompt_tokens": S, "features": feats, "setup_s": setup_s, "run_s": run_s,
        "clean_forward_ms": stages["clean"], "stage_ms_per_feature": per_feature,
        "ms_per_feature": ms_per_feature, "features_per_s": F / run_s,
        "peak_gb": peak_gb, "resident_gb": resident_gb, "launches": launches,
        "launches_per_feature": {name: (n - clean.get(name, 0)) / F for name, n in launches.items()},
        "dvals_ms": dvals["kernel_ms"], "dvals_share_of_feature": dvals["kernel_ms"] / ms_per_feature,
        "dvals_check": {key: dvals[key] for key in ("tokens", "k", "distinct_rows", "max_abs_err", "err_bound",
                                                    "plain_ms", "bound_ms", "bound_by", "rows_a_tile_names",
                                                    "uniform")},
        "one_call_profile": profile, "in_lower_topk": in_lower, "flash_attention_bwd_b1": k3_bwd, "outside_topk_exact_zero": True,
        "reduced_card_vs_cpu": reduced,
        "card": card,
    })
    return {"launches": launches, "dvals": dvals, "k3_bwd_b1": k3_bwd}


# ---- rematerialisation (`--remat`, LlamaConfig.remat) -------------------------------


def _subject_with(model, **text):
    """The same subject (its parameters shared) with the language model's
    config fields `text` replaced (`remat`, `flash_attention`)."""
    import dataclasses

    cfg = model.cfg
    if hasattr(cfg, "text_config"):
        return type(model)(model.params, dataclasses.replace(cfg, text_config=dataclasses.replace(cfg.text_config,
                                                                                                  **text)))
    return type(model)(model.params, dataclasses.replace(cfg, **text))


def _counted_chunk(step, model, chunk: torch.Tensor) -> dict:
    """One attribution chunk of `step` with its suffix on `model`: the
    saliency, the launches, the device ms (CUDA events) and the peak, whole
    and above the memory held before the chunk."""
    step.model = model
    gc.collect()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    sal = step(chunk)
    end.record()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return {"sal": sal, "launches": kernel_counts(), "ms": start.elapsed_time(end), "peak_gb": peak / 1e9,
            "peak_above_held_gb": (peak - held) / 1e9}


def _remat_pair(step, model, chunk: torch.Tensor, n_suffix: int, what: str) -> dict:
    """`step`'s chunk with the suffix on `model` without and with remat,
    each after one warm-up chunk: the saliency equal bit for bit (raises
    otherwise), K3's forward n_suffix and 2 n_suffix launches, its backward
    n_suffix each kernel both times.  Returns each run's ms, peak and
    launches."""
    runs = {}
    for tag, subject in (("no_remat", _subject_with(model, remat=False)),
                         ("remat", _subject_with(model, remat=True))):
        step.model = subject
        step(chunk)  # warm-up
        runs[tag] = _counted_chunk(step, subject, chunk)
    step.model = model
    for tag, fwd in (("no_remat", n_suffix), ("remat", 2 * n_suffix)):
        _expect_launches(runs[tag]["launches"], {"flash_attention": fwd, "flash_attention_bwd_delta": n_suffix,
                                                 "flash_attention_bwd_dkdv": n_suffix,
                                                 "flash_attention_bwd_dq": n_suffix, "splice_decode": 1,
                                                 "block_max": 0, "gather_rows": 0, "decode_dvals": 0},
                         f"{what} ({tag})")
    a, b = runs["no_remat"].pop("sal"), runs["remat"].pop("sal")
    if not torch.equal(a, b):
        raise AssertionError(f"{what}: the saliency with remat differs from without it by up to "
                             f"{(a - b).abs().max().item()}")
    if not a.any():
        raise AssertionError(f"{what}: the chunk's saliency is all 0")
    runs["equal_bits"] = True
    runs["remat_over_no_remat_ms"] = runs["remat"]["ms"] / runs["no_remat"]["ms"]
    runs["peak_saved_gb"] = runs["no_remat"]["peak_gb"] - runs["remat"]["peak_gb"]
    return runs


def phase_remat_attribution_path(dev, card: str, model, sae) -> dict:
    """`--remat` on the attribution phase's subject (LLaMA-3-8B widths, 32
    layers, LM head, bf16) and SAE at layers.24 (131,072 latents, k = 256),
    on its 2,432-id prompt: (a) with flash attention, one chunk of the 8
    features of the last position's pool without and with remat, equal bit
    for bit, K3's forward 7 and 14 times, its backward 7 times each kernel,
    ms and peak of each; (b) with eager attention (the CLI's default) and
    remat, `fast_attribution_maps` at feature_batch 8 in one chunk (one
    splice: the out-of-memory loop did not halve it), against eager
    attention without remat at feature_batch 2 within ATTRIBUTION_L2_REL,
    the measured peak beside the one reckoned for fb 8 without remat;
    (d) `general_attribution_maps` for one feature without and with remat,
    equal bit for bit.  Counted: (b)'s remat run and (d)'s remat feature."""
    from functools import partial

    from multimodal_sae_tpu_torch.features.patching import (
        build_fast_attribution, fast_attribution_maps, general_attribution_maps, get_logit_diff,
    )

    t_phase = time.perf_counter()
    hook, S, n_suffix = "layers.24", 2432, 32 - 25
    rng = np.random.default_rng(1)  # the attribution phase's prompt
    batch = {"input_ids": rng.integers(0, model.cfg.vocab_size, size=(1, S))}
    metric = partial(get_logit_diff, answer_token_indices=torch.tensor([[1000, 2000]], device=dev))
    step = build_fast_attribution(model, hook, sae, batch, metric)
    inside = step.wide_idx[-1, :8].long().tolist()
    flash = _remat_pair(step, model, torch.tensor(inside), n_suffix, "flash attention chunk")
    del step
    gc.collect()
    torch.cuda.empty_cache()

    # (b) eager attention at fb 8 with remat, then without remat at fb 2.
    held_gb = torch.cuda.memory_allocated() / 1e9
    eager = {}
    launches = None
    for tag, remat, fb in (("remat_fb8", True, 8), ("no_remat_fb2", False, 2)):
        subject = _subject_with(model, flash_attention=False, remat=remat)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_kernel_counts()
        t0 = time.perf_counter()
        out = fast_attribution_maps(subject, hook, sae, batch, metric, inside, feature_batch=fb, progress=False)
        torch.cuda.synchronize()
        eager[tag] = {"s": time.perf_counter() - t0, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "launches": kernel_counts(), "sal": _saliency(out, hook)}
        if launches is None:
            launches = eager[tag]["launches"]
        del subject, out
        torch.cuda.empty_cache()
    chunks = {tag: run["launches"]["splice_decode"] for tag, run in eager.items()}
    if chunks != {"remat_fb8": 1, "no_remat_fb2": 4}:
        raise AssertionError(f"eager attention ran {chunks} chunks: the out-of-memory loop halved a batch")
    for tag, run in eager.items():
        if run["launches"]["flash_attention"] or run["launches"]["flash_attention_bwd_dq"]:
            raise AssertionError(f"eager attention ({tag}) launched K3: {run['launches']}")
    eager_rel = [float(np.linalg.norm(a - b) / np.linalg.norm(b))
                 for a, b in zip(eager["remat_fb8"].pop("sal"), eager["no_remat_fb2"].pop("sal"))]
    if not max(eager_rel) <= ATTRIBUTION_L2_REL:
        raise AssertionError(f"eager attention with remat at fb 8 against fb 2 without: relative L2 {eager_rel}")
    # Without remat the tape grows with the chunk: fb 8 keeps 4 times fb 2's.
    eager["reckoned_no_remat_fb8_peak_gb"] = held_gb + 4 * (eager["no_remat_fb2"]["peak_gb"] - held_gb)
    F, H = 8, model.cfg.num_attention_heads
    eager["reckoned_no_remat_fb8_attention_tape_gb"] = n_suffix * F * H * S * S * (4 + 2) / 1e9
    eager["held_gb"] = held_gb
    eager["saliency_l2_rel_fb8_remat_vs_fb2"] = eager_rel
    eager["l2_rel_bound"] = ATTRIBUTION_L2_REL

    # (d) one general feature without and with remat.
    general = {}
    for tag, remat in (("no_remat", False), ("remat", True)):
        subject = _subject_with(model, remat=remat)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_kernel_counts()
        t0 = time.perf_counter()
        out = general_attribution_maps(subject, {hook: sae}, batch, metric, inside[:1], progress=False)
        torch.cuda.synchronize()
        general[tag] = {"s": time.perf_counter() - t0, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                        "launches": kernel_counts(), "sal": _saliency(out, hook)}
        del subject, out
    counted = {name: launches[name] + general["remat"]["launches"][name] for name in launches}
    for tag, fwd in (("no_remat", 64), ("remat", 64 + n_suffix)):
        # The clean forward and the feature's: 32 attentions, two block-max
        # levels and a decode each; the backward through the 7 layers above
        # the splice (recomputed under remat), which stops at the splice's
        # delta (no dvals: no splice lies below it).
        _expect_launches(general[tag]["launches"], {"flash_attention": fwd, "flash_attention_bwd_delta": n_suffix,
                                                    "flash_attention_bwd_dkdv": n_suffix,
                                                    "flash_attention_bwd_dq": n_suffix, "block_max": 4,
                                                    "gather_rows": 2, "sae_encode": 2},
                         f"general feature ({tag})")
    a, b = general["no_remat"].pop("sal"), general["remat"].pop("sal")
    if not np.array_equal(a, b) or not a.any():
        raise AssertionError(f"the general feature with remat differs from without it by up to {np.abs(a - b).max()}")
    general["equal_bits"] = True
    emit({
        "phase": "remat_attribution_path",
        "subject": "LLaMA-3-8B widths, 32 layers, bf16, LM head", "hookpoint": hook, "prompt_tokens": S,
        "sae": "4096 -> 131072 latents, k=256, fp32, decoder", "features": inside,
        "flash_chunk_fb8": flash, "eager": eager, "general_one_feature": general,
        "seconds": time.perf_counter() - t_phase, "card": card,
    })
    return {"launches": counted, "flash": flash}


def phase_remat_image_row(dev, card: str, model, sae, probe: dict) -> dict:
    """(c) of `--remat`: one chunk of image_attribution_path's probe row
    (2,358 tokens, its 8 pool features) on the LLaVA-NeXT subject without
    and with remat, equal bit for bit, K3's forward 7 and 14 times."""
    from multimodal_sae_tpu_torch.features.patching import build_fast_attribution

    t_phase = time.perf_counter()
    step = build_fast_attribution(model, "model.layers.24", sae, probe["batch"], probe["metric"])
    runs = _remat_pair(step, model, torch.tensor(probe["inside"]), 32 - 25, "image row chunk")
    del step
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "remat_attribution_path_image_row", "tokens": probe["tokens"], "features": probe["inside"],
          "subject": "llama3-llava-next-8b widths, 32 text layers, bf16, flash attention", "chunk_fb8": runs,
          "seconds": time.perf_counter() - t_phase, "card": card})
    return runs


def _tree_to(tree, device):
    """A copy of a nest of dicts and lists of tensors on `device`."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def phase_clip_path(dev, card: str) -> dict:
    """Full CLIP at the widths of the CLIP scorer's default model
    (openai/clip-vit-base-patch16: vision 12 x 768 at 224 px, patch 16; text
    12 x 512, 77 positions; projection 512), random fp32 weights from a
    seed, 64 pixel arrays and 64 id rows made here (no PIL, no tokenizer on
    this machine): image and text embeddings and scores on the card, 8 of
    each held against the same call on the CPU, the scores against
    max(0, 100 cos) of the embeddings in float64.  No kernel of the port."""
    from multimodal_sae_tpu_torch.models import clip_full
    from multimodal_sae_tpu_torch.models.clip_vit import ClipVisionConfig

    vision = ClipVisionConfig(hidden_size=768, intermediate_size=3072, num_hidden_layers=12, num_attention_heads=12,
                              image_size=224, patch_size=16, projection_dim=512)
    text = clip_full.ClipTextConfig()
    n, n_cpu = 64, 8
    params = clip_full.init_clip_model_params(vision, text, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(3)
    pixels = torch.from_numpy(rng.normal(size=(n, 3, 224, 224)).astype(np.float32)).to(dev)
    ids = np.zeros((n, text.max_position_embeddings), dtype=np.int64)
    for row, length in enumerate(rng.integers(3, text.max_position_embeddings, size=n)):
        ids[row, : length - 1] = rng.integers(1, text.eos_token_id - 1, size=length - 1)
        ids[row, length - 1] = text.eos_token_id
    ids = torch.from_numpy(ids).to(dev)
    reset_kernel_counts()
    with torch.no_grad():
        clip_full.clip_score(params, vision, text, pixels[:2], ids[:2])  # warm-up
        image_ms = time_ms(lambda: clip_full.clip_embed_image(params, vision, pixels), iters=3, warmup=1)
        text_ms = time_ms(lambda: clip_full.clip_embed_text(params, text, ids), iters=3, warmup=1)
        img, txt = clip_full.clip_embed_image(params, vision, pixels), clip_full.clip_embed_text(params, text, ids)
        score = clip_full.clip_score(params, vision, text, pixels, ids)
        torch.cuda.synchronize()
        launches = kernel_counts()
        cos = torch.nn.functional.cosine_similarity(img.double(), txt.double(), dim=-1)
        score_err = (score.double() - torch.clamp_min(100 * cos, 0)).abs().max().item()
        cpu = _tree_to(params, "cpu")
        t0 = time.perf_counter()
        img_cpu = clip_full.clip_embed_image(cpu, vision, pixels[:n_cpu].cpu())
        txt_cpu = clip_full.clip_embed_text(cpu, text, ids[:n_cpu].cpu())
        cpu_s = time.perf_counter() - t0

    def rel(got, want):
        return ((got.cpu() - want).norm(dim=-1) / want.norm(dim=-1)).max().item()

    img_rel, txt_rel = rel(img[:n_cpu], img_cpu), rel(txt[:n_cpu], txt_cpu)
    if any(launches.values()):
        raise AssertionError(f"the CLIP phase launched kernels: {launches}")
    if not (torch.isfinite(img).all() and torch.isfinite(txt).all() and img.shape == txt.shape == (n, 512)):
        raise AssertionError(f"CLIP embeddings {tuple(img.shape)}, {tuple(txt.shape)} or not finite")
    if not (img_rel <= CLIP_L2_REL and txt_rel <= CLIP_L2_REL):
        raise AssertionError(f"CLIP embeddings differ from the CPU's: image {img_rel}, text {txt_rel}")
    if not score_err <= CLIP_SCORE_ATOL:
        raise AssertionError(f"CLIP scores differ from max(0, 100 cos) by {score_err}")
    emit({"phase": "clip_path", "model": "openai/clip-vit-base-patch16 widths, random fp32 weights",
          "images": n, "texts": n, "ms_per_image": image_ms / n, "ms_per_text": text_ms / n,
          "image_batch_ms": image_ms, "text_batch_ms": text_ms, "cpu_rows": n_cpu, "cpu_s": cpu_s,
          "image_l2_rel": img_rel, "text_l2_rel": txt_rel, "l2_rel_bound": CLIP_L2_REL,
          "score_max_abs_err": score_err, "score_atol": CLIP_SCORE_ATOL,
          "score_range": [score.min().item(), score.max().item()], "launches": launches, "card": card})
    del params, pixels, ids, img, txt, score, cpu
    torch.cuda.empty_cache()
    return {"launches": launches}


class _StubClient:
    """An in-process LLM client: canned replies, one per prompt, counted."""

    def __init__(self, reply: str):
        self.reply, self.calls = reply, 0

    async def generate(self, prompt, **kwargs):
        self.calls += 1
        return self.reply


def phase_explain_score_path(card: str, records, work_dir: str) -> dict:
    """The loader phase's kept records through `Pipeline`: `SimpleExplainer`
    then `SimpleScorer` (threshold 0.5, activations) on stub clients, one
    explanation file and one score file per record, each read back; host
    only, no kernel."""
    import asyncio

    from multimodal_sae_tpu_torch.agents import SimpleExplainer, SimpleScorer, explanation_loader
    from multimodal_sae_tpu_torch.pipeline import Pipeline, process_wrapper

    explanation_dir, scores_dir = os.path.join(work_dir, "explanations"), os.path.join(work_dir, "scores")
    os.makedirs(explanation_dir)
    os.makedirs(scores_dir)
    explainer_client = _StubClient("Some thoughts.\n[EXPLANATION]: tokens of a random subject")
    scorer_client = _StubClient("[1, 0, 2, 3, 1]")
    explainer = SimpleExplainer(explainer_client, _StubTokenizer(), activations=True)
    scorer = SimpleScorer(scorer_client, _StubTokenizer(), verbose=True, threshold=0.5, activations=True)

    def save_explanation(result):
        with open(os.path.join(explanation_dir, f"{result.record.feature}.txt"), "w") as f:
            json.dump(result.explanation, f)
        result.record.explanation = result.explanation
        return result.record

    def save_scores(out):
        prompts, _replies, result = out
        rows = [{"examples": p, "scores": s, "max_activations": m}
                for p, s, m in zip(prompts, result.scores, result.max_activations)]
        with open(os.path.join(scores_dir, f"{result.record.feature}.json"), "w") as f:
            json.dump(rows, f)
        return result

    pipeline = Pipeline(lambda collate: [records], process_wrapper(explainer, postprocess=save_explanation),
                        process_wrapper(scorer, postprocess=save_scores))
    reset_kernel_counts()
    t0, c0 = time.perf_counter(), time.process_time()
    asyncio.run(pipeline.run(max_processes=16))
    wall_s, cpu_s = time.perf_counter() - t0, time.process_time() - c0
    launches = kernel_counts()
    names = sorted(os.listdir(explanation_dir))
    if len(names) != len(records) or len(os.listdir(scores_dir)) != len(records):
        raise AssertionError(f"{len(names)} explanation and {len(os.listdir(scores_dir))} score files "
                             f"for {len(records)} records")
    for r in records:
        got = asyncio.run(explanation_loader(r, explanation_dir)).explanation
        with open(os.path.join(scores_dir, f"{r.feature}.json")) as f:
            rows = json.load(f)
        if got != "tokens of a random subject" or not rows or any(row["scores"] != [1, 0, 2, 3, 1] for row in rows):
            raise AssertionError(f"record {r.feature}: explanation {got!r}, scores {rows[:1]}")
    if any(launches.values()):
        raise AssertionError(f"the explain/score phase launched kernels: {launches}")
    emit({"phase": "explain_score_path", "note": "smoke readings, stub clients in process",
          "records": len(records), "explainer_calls": explainer_client.calls, "scorer_calls": scorer_client.calls,
          "wall_s": wall_s, "records_per_s": len(records) / wall_s, "host_cpu_share": cpu_s / wall_s,
          "files": {"explanations": len(names), "scores": len(records)}, "launches": launches, "card": card})
    return {"launches": launches}


STEER_NEAR_TIE = 0.125
# Cache against no cache, and batched against sequential, on the bf16
# subjects: a generated token must be the cache-free forward's argmax
# wherever that forward's top-2 logit gap exceeds 0.125, four bf16 ulps at
# the top logits' size (4 to 8: the random LM head gives logits a spread of
# about 1.3).  The two forwards run other attention kernels (a decode step's
# fp32-softmax matmuls over the cache against K3 over the whole sequence) and
# other matmul shapes, each rounding to bf16 at every layer.  Every position
# is compared; the ones under the margin are counted as skipped.
REPLAY_NOISE_FACTOR = 4.0
# The cache-free forward and a sequential generate take the clamp's top-k
# selections that the checked generate made (recorded there with their
# values, replayed token by token): at 131,072 latents the values near the
# 256th lie about 1e-3 apart, closer than the bf16 noise between two
# computations of a hidden state, and a swapped latent moves the clamp's
# output by a whole decoder row.  Where a forward's own top-k would select
# another set, the gap between its own k-th latent and the weakest replayed
# pick must be explained by that noise: at most 4 times the token's largest
# difference between the two computations' values of its replayed latents
# (a swap needs the noise of two latents, the unrecorded one's bounded by
# twice the largest recorded).
REDUCED_NEAR_TIE = 1e-3
# The reduced fp32 run: a token may differ between the card and the CPU only
# from a step whose CPU-side top-2 logit gap is under 1e-3 (the two sides'
# fp32 logits, about 5 in size, lie about 1e-5 apart).
REDUCED_L2_REL = 1e-4
# Its prefill's last logits: ||card - cpu|| <= 1e-4 * ||cpu|| (two layers of
# fp32 sums in other orders, about 1e-6 relative apart).
CHAT_HEAD = [128000, 128006, 882, 128007, 271]  # begin_of_text, user header, "\n\n"
CHAT_TAIL = [128009, 128006, 78191, 128007, 271]  # eot, assistant header, "\n\n"
EOT = 128009
CLAMP = 50.0  # the steering CLI's default clamp value


class _StubChat:
    """A chat template and tokenizer for the card's machine, which has no
    tokenizer library: the templated prompt is LLaMA-3's user and assistant
    headers around fixed ids (with the image token before them when the
    conversation holds an image); decoding writes the ids as numbers."""

    eos_token_id = EOT

    def __init__(self, prompt_ids, image_token=None):
        self.prompt_ids, self.image_token = [int(t) for t in prompt_ids], image_token
        self.tokenizer = self

    def apply_chat_template(self, conversation, add_generation_prompt=False, tokenize=False):
        return "<image>" if any(c.get("type") == "image" for c in conversation[0]["content"]) else ""

    def __call__(self, text, **kw):
        image = [self.image_token] if text == "<image>" else []
        return {"input_ids": CHAT_HEAD + image + self.prompt_ids + CHAT_TAIL}

    def batch_decode(self, ids, skip_special_tokens=True):
        return [" ".join(str(int(t)) for t in row) for row in np.asarray(ids)]


def _answer_ids(text: str, new: int, vocab: int) -> list:
    """The token ids of one steering answer (`_StubChat` writes them as
    numbers), checked: `new` ids in the vocabulary."""
    ids = [int(t) for t in text.split()]
    if len(ids) != new or not all(0 <= t < vocab for t in ids):
        raise AssertionError(f"a steering answer has {len(ids)} ids, or one outside the vocabulary")
    return ids


def _timed_generate(model, batch, interventions, new: int, record=None, **kw):
    """`model.generate` with CUDA events at its prefill and step marks and
    the kernel counts at the prefill mark: (output, readings).  The counts
    are set to 0 first.  With `record` (a list) the clamp's top-k
    selections are appended to it (`_recording_topk`)."""
    import contextlib

    start = torch.cuda.Event(enable_timing=True)
    events, at_prefill = [], {}

    def mark(stage):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        events.append(event)
        if stage == "prefill":
            at_prefill.update(kernel_counts())

    recording = _recording_topk(record) if record is not None else contextlib.nullcontext()
    with recording:
        reset_kernel_counts()
        start.record()
        out = model.generate(batch, max_new_tokens=new, interventions=interventions, mark=mark, **kw)
        torch.cuda.synchronize()
        total = kernel_counts()
    steps = sorted(a.elapsed_time(b) for a, b in zip(events, events[1:]))
    return out, {
        "rows": out.shape[0], "prompt_tokens": out.shape[1] - new, "new_tokens": new,
        "prefill_ms": start.elapsed_time(events[0]),
        "step_ms": {"median": steps[len(steps) // 2], "min": steps[0], "max": steps[-1], "steps": len(steps)}
        if steps else None,
        "launches": {"prefill": dict(at_prefill), "decode": {k: total[k] - at_prefill[k] for k in total}},
    }


def _expect_launches(got: dict, want: dict, what: str) -> None:
    want = {name: want.get(name, 0) for name in got}
    if got != want:
        raise AssertionError(f"{what}: kernel launches {got}, expected {want}")


def _recording_topk(record: list):
    """A context in which each call of the steering clamp's top-k appends
    its (indices, values), (tokens, k) each, on the host, to `record`."""
    import contextlib

    from multimodal_sae_tpu_torch.features import steering

    real = steering.select_topk

    def recorded(latents, k):
        out = real(latents, k)
        record.append((out.top_indices.cpu(), out.top_acts.cpu()))
        return out

    @contextlib.contextmanager
    def patched():
        steering.select_topk = recorded
        try:
            yield record
        finally:
            steering.select_topk = real

    return patched()


def _replaying_topk(picks):
    """A context in which the steering clamp's top-k takes its selections
    from `picks` = (indices, values), (N, k) each, recorded by
    `_recording_topk`, token after token in the order the clamp meets them;
    the selected values are the forward's own latents at those indices.
    It yields a dict that gathers, over the calls, the tokens whose own
    top-k would select another set, the largest gap there between the own
    k-th latent and the weakest replayed pick as a multiple of the token's
    noise (the largest difference between its recorded and its own values
    at the replayed indices), and that noise's largest share of the k-th
    latent.  It raises past REPLAY_NOISE_FACTOR."""
    import contextlib

    from multimodal_sae_tpu_torch.features import steering
    from multimodal_sae_tpu_torch.sae.model import EncoderOutput

    real, cursor = steering.select_topk, [0]
    stats = {"own_selection_differs": 0, "largest_gap_over_noise": 0.0, "largest_noise_of_kth": 0.0}
    picks_idx, picks_vals = picks

    def replay(latents, k):
        n = latents.shape[0]
        idx = picks_idx[cursor[0]:cursor[0] + n].to(latents.device)
        recorded = picks_vals[cursor[0]:cursor[0] + n].to(latents.device)
        if idx.shape[0] != n:
            raise AssertionError("the replayed top-k selections ran out")
        cursor[0] += n
        vals = latents.gather(-1, idx.long())
        own = torch.topk(latents, k, dim=-1)
        rows = (own.indices.sort(-1).values != idx.long().sort(-1).values).any(-1)
        kth = own.values[:, -1]
        noise = (vals - recorded).abs().max(-1).values
        gap = (kth - vals.min(-1).values)[rows]
        over = gap / noise[rows].clamp_min(torch.finfo(gap.dtype).tiny)
        stats["own_selection_differs"] += int(rows.sum())
        stats["largest_gap_over_noise"] = max(stats["largest_gap_over_noise"], over.max().item() if len(over) else 0.0)
        stats["largest_noise_of_kth"] = max(stats["largest_noise_of_kth"], (noise / kth).max().item())
        return EncoderOutput(vals, idx)

    @contextlib.contextmanager
    def patched():
        steering.select_topk = replay
        try:
            yield stats
        finally:
            steering.select_topk = real
        if cursor[0] != picks_idx.shape[0]:
            raise AssertionError(f"{picks_idx.shape[0] - cursor[0]} replayed top-k selections were not taken")
        if stats["largest_gap_over_noise"] > REPLAY_NOISE_FACTOR:
            raise AssertionError(f"a replayed top-k pick lies {stats['largest_gap_over_noise']} times its token's "
                                 f"noise below the forward's own k-th latent")

    return patched()


def _picks(record: list, rows: int, prompt: int):
    """A generate's recorded clamp selections as (indices, values), each
    (rows, positions, k): the prefill's calls (rows x prompt tokens, in
    chunks) and then one call of `rows` tokens a decode step, if the clamp
    ran in the decode steps."""
    out = []
    for part in zip(*record):
        flat = torch.cat(part)
        pre = flat[:rows * prompt].view(rows, prompt, -1)
        steps = flat[rows * prompt:].view(-1, rows, flat.shape[-1]).transpose(0, 1)
        out.append(torch.cat([pre, steps], dim=1))
    return tuple(out)


def _merge_replays(replays: list) -> dict:
    return {"own_selection_differs": sum(r["own_selection_differs"] for r in replays),
            "largest_gap_over_noise": max((r["largest_gap_over_noise"] for r in replays), default=0.0),
            "largest_noise_of_kth": max((r["largest_noise_of_kth"] for r in replays), default=0.0),
            "noise_factor": REPLAY_NOISE_FACTOR}


def _cache_free_top2(params, cfg, seqs: torch.Tensor, new: int, clamp=None, embeds=None, rows_at_once: int = 16):
    """(argmax, gap, replay) of a cache-free forward over the prompt and the
    generated ids but the last, at the positions that predicted each
    generated token: the top-1 id, the top-2 logit gap (B, new), and what
    the replayed selections showed (`_replaying_topk`).  `clamp` = (hook,
    sae, features, picks): the hookpoint's clamp for each row's feature at
    the positions `picks` (`_picks`: (B, P, k) indices and values) covers
    (the prompt's, for a prefill-only generate, or every position), taking
    those selections.  With `embeds` (the prompt's embeddings, as a LLaVA
    subject makes them) the generated ids are embedded and appended."""
    from multimodal_sae_tpu_torch.features.steering import clamp_features_max_batched
    from multimodal_sae_tpu_torch.models.llama import lm_head_logits, llama_forward

    B, T = seqs.shape
    S_p = T - new
    argmax, gap, replayed = [], [], []
    for r0 in range(0, B, rows_at_once):
        rows = slice(r0, min(B, r0 + rows_at_once))
        ivs = None
        if clamp is not None:
            hook, sae, feats, picks = clamp
            fn = clamp_features_max_batched(sae, feats[rows], CLAMP)

            def iv(h, fn=fn, picks=picks, rows=rows):
                L = picks[0].shape[1]
                with _replaying_topk(tuple(p[rows, :L].reshape(-1, p.shape[-1]) for p in picks)) as stats:
                    out = fn(h[:, :L])
                replayed.append(stats)
                return torch.cat([out, h[:, L:]], dim=1)

            ivs = {hook: iv}
        kw = {"input_ids": seqs[rows, :-1]}
        if embeds is not None:
            kw = {"inputs_embeds": torch.cat([embeds[rows], params["embed_tokens"][seqs[rows, S_p:-1]]], dim=1)}
        with torch.no_grad():
            h = llama_forward(params, cfg, interventions=ivs, return_logits=False, return_hidden=True, **kw)["hidden"]
            top = lm_head_logits(params, h[:, S_p - 1:]).float().topk(2, dim=-1)
        argmax.append(top.indices[..., 0])
        gap.append(top.values[..., 0] - top.values[..., 1])
        del h, top
    return torch.cat(argmax), torch.cat(gap), _merge_replays(replayed)


def _check_cache_free(gen: torch.Tensor, argmax: torch.Tensor, gap: torch.Tensor, replay: dict, what: str) -> dict:
    """Generated ids (B, new) against the cache-free argmax wherever its gap
    exceeds STEER_NEAR_TIE, up to and including each row's first stop id
    (after it the loop writes the fill id)."""
    stopped = torch.cumsum((gen == EOT).int(), dim=1)
    live = (stopped - (gen == EOT).int()) == 0
    compared = live & (gap > STEER_NEAR_TIE)
    wrong = compared & (argmax != gen)
    if bool(wrong.any()):
        b, i = (int(x) for x in torch.nonzero(wrong)[0])
        raise AssertionError(f"{what}: row {b} step {i} generated {int(gen[b, i])}, the cache-free forward's argmax "
                             f"is {int(argmax[b, i])} with a top-2 gap of {float(gap[b, i])}")
    return {"positions": int(live.sum()), "compared": int(compared.sum()),
            "skipped_near_ties": int((live & ~compared).sum()), "near_tie": STEER_NEAR_TIE,
            "disagreements_under_the_margin": int((live & ~compared & (argmax != gen)).sum()),
            "replayed_selections": replay}


def _decode_bound(model_params: dict, cfg, rows: int, prompt: int, new: int) -> dict:
    """The least time of a decode step on the card, averaged over the steps
    of a generate: the bytes it must read (every layer's weights, the final
    norm and the LM head once, the rows' embedding rows, and the k and v of
    every live cache slot) over HBM_BYTES_PER_S, against its operations
    (2 per weight per row) over BF16_FLOPS."""
    layer_bytes = sum(t.numel() * t.element_size() for layer in model_params["layers"] for t in layer.values())
    head = model_params.get("lm_head", model_params["embed_tokens"])
    weights = layer_bytes + head.numel() * head.element_size() + model_params["norm"].numel() * 2
    slot = 2 * cfg.num_hidden_layers * rows * cfg.num_key_value_heads * cfg.head_dim_ * head.element_size()
    mean_live = prompt + new / 2
    nbytes = weights + rows * cfg.hidden_size * 2 + slot * mean_live
    flops = 2 * (layer_bytes + head.numel() * head.element_size()) / head.element_size() * rows
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "weight_gb": weights / 1e9, "mean_cache_read_gb": slot * mean_live / 1e9}


def _profile_decode(model, batch, interventions, steps: int, **kw) -> dict:
    """`steps` decode steps of one generate under torch.profiler (from the
    prefill's mark to the last step's, each end synchronised): device time
    by kernel group and the device's idle share of the window."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    state = {"steps": 0}

    def mark(stage):
        if stage == "prefill":
            torch.cuda.synchronize()
            prof.start()
            state["t0"] = time.perf_counter()
            return
        state["steps"] += 1
        if state["steps"] == steps:
            torch.cuda.synchronize()
            state["wall_ms"] = (time.perf_counter() - state["t0"]) * 1e3
            prof.stop()

    model.generate(batch, max_new_tokens=steps + 1, interventions=interventions, mark=mark, **kw)
    if "wall_ms" not in state:
        raise AssertionError(f"the profiled generate stopped before {steps} decode steps")
    return {"decode_steps": steps, **summarize_profile(prof, state["wall_ms"])}


def _check_clamp_chunk(sae, x: torch.Tensor, feats_of_tokens: torch.Tensor, prompt_len: int) -> dict:
    """One token chunk of the clamp on the card against its plain chain on
    the same pre-activations: the top-k (K1's two block-max levels) against
    `torch.topk` as sets, and the decode (K2's decode mode) within its fp32
    bound of `gather_decode_plain` of the same selection; each kernel timed
    at this chunk beside its bound, its plain version and the library call.
    The chunk's rows of one prompt of `prompt_len` tokens are flattened
    row-major, as `clamp_hidden` flattens them; the rows a tile names are
    printed in that order and position-major (a tile one position across
    rows)."""
    import torch.nn.functional as F

    from multimodal_sae_tpu_torch.ops import block_max as bm, gather_rows as gr, top_k
    from multimodal_sae_tpu_torch.sae import pre_acts

    W, k = sae.params["W_dec"], sae.cfg.k
    N, width, d = x.shape[0], W.shape[0], W.shape[1]
    latents = pre_acts(sae.params, x)
    latents[torch.arange(N, device=x.device), feats_of_tokens] = CLAMP
    vals, idx = top_k(latents, k, assume_finite=True)
    _check_topk_as_sets(latents, vals, idx, k)
    got, ref = gr.gather_decode(idx, vals, W), gr.gather_decode_plain(idx, vals, W)
    err_bound = 2 * k * 2.0 ** -24 * vals.abs().sum(-1).max().item() * W.abs().max().item()
    err = (got - ref).abs().max().item()
    if not (torch.isfinite(got).all() and err <= err_bound):
        raise AssertionError(f"the clamp's decode is off by {err} (bound {err_bound})")
    cand = latents.view(N, width // 64, 64).gather(
        1, torch.topk(bm.block_max(latents, 64), k, dim=-1).indices[:, :, None].expand(N, k, 64)).reshape(N, k * 64)
    levels = []
    for inp, block in ((latents, 64), (cand, 8)):
        n, w = inp.shape
        levels.append({"shape": [n, w], "block": block, "ms": time_ms(lambda: bm.block_max(inp, block)),
                       "plain_ms": time_ms(lambda: bm.block_max_plain(inp, block)),
                       "library_ms": time_ms(lambda: torch.amax(inp.view(n, w // block, block), dim=-1)),
                       "bound_ms": (n * w + n * w // block) * 4 / HBM_BYTES_PER_S * 1e3})
    k1 = {key: sum(level[key] for level in levels) for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    k1.update(bound_by="bytes", levels=levels, max_abs_err=0.0, topk_as_sets=True)
    idx_long, distinct = idx.long(), torch.unique(idx).numel()
    t = torch.arange(N, device=x.device)
    position_major = torch.argsort((t % prompt_len) * N + t)
    k2 = {"tokens": N, "k": k, "distinct_rows": distinct, "max_abs_err": err, "err_bound": err_bound,
          "rows_a_tile_names": tile_stats(idx), "rows_a_tile_names_position_major": tile_stats(idx[position_major]),
          "ms": time_ms(lambda: gr.gather_decode(idx, vals, W)),
          "plain_ms": time_ms(lambda: gr.gather_decode_plain(idx, vals, W), iters=3),
          "library_ms": time_ms(lambda: F.embedding_bag(idx_long, W, per_sample_weights=vals, mode="sum")),
          **k2_decode_bound(N, k, d, distinct)}
    del latents, cand, got, ref
    torch.cuda.empty_cache()
    return {"block_max": k1, "gather_decode": k2}


def _reduced_steering(model, sae, dev, hook: str = "layers.0", layers: int = 2, S: int = 32, new: int = 16) -> dict:
    """Steered generation on the card against the CPU at reduced depth: the
    subject's first `layers` layers and its LM head in fp32 with eager
    attention, the SAE at `hook`, one prompt of S ids on 2 rows steered by
    2 features (the last token's top feature and one drawn with a seed),
    `new` greedy tokens.  The card's clamp selections are recorded and the
    CPU replays them (`_replaying_topk`: a latent that ties the k-th within
    fp32 noise could otherwise be selected on one side only).  The
    prefill's last logits must agree within REDUCED_L2_REL, and the ids up
    to the first step whose CPU-side top-2 gap is under REDUCED_NEAR_TIE."""
    import dataclasses

    from multimodal_sae_tpu_torch.features import steering
    from multimodal_sae_tpu_torch.models.llama import KVCache, LlamaModel, llama_forward
    from multimodal_sae_tpu_torch.sae import Sae

    cfg = dataclasses.replace(model.cfg, num_hidden_layers=layers, flash_attention=False)

    def side(device):
        p = {name: t.to(device=device, dtype=torch.float32) for name, t in model.params.items() if name != "layers"}
        p["layers"] = [{name: t.to(device=device, dtype=torch.float32) for name, t in lp.items()}
                       for lp in model.params["layers"][:layers]]
        return LlamaModel(p, cfg), Sae(sae.d_in, sae.cfg, params={n: t.to(device) for n, t in sae.params.items()})

    rng = np.random.default_rng(14)
    ids = np.repeat(rng.integers(0, 128000, size=(1, S)), 2, axis=0)
    sides = {"card": side(dev), "cpu": side("cpu")}
    m_card, sae_card = sides["card"]
    h = m_card.capture({"input_ids": ids[:1]}, [hook])[hook]
    first = int(sae_card.encode(h[0, -1:]).top_indices[0, 0])
    feats = [first, int(rng.choice(np.setdiff1d(np.arange(sae.num_latents), [first])))]
    out, last_logits, picks, seconds = {}, {}, {"generate": [], "prefill": []}, {}

    def selections(name, record):
        if name == "card":
            return _recording_topk(record)
        return _replaying_topk(tuple(torch.cat(part) for part in zip(*record)))

    for name, (m, s) in sides.items():
        iv = {hook: steering.clamp_features_max_batched(s, feats, CLAMP)}
        t0 = time.perf_counter()
        with selections(name, picks["generate"]) as generate_stats:
            out[name] = m.generate({"input_ids": ids}, max_new_tokens=new, interventions=iv).cpu()
        with selections(name, picks["prefill"]) as prefill_stats:
            x = torch.as_tensor(ids, device=m.device)
            res = llama_forward(m.params, cfg, x, interventions=iv, cache=KVCache.init(cfg, 2, S + new, device=m.device))
            last_logits[name] = res["logits"][:, -1].float().cpu()
        if name == "card":
            torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
    rel = _l2_rel(last_logits["card"], last_logits["cpu"])
    if not rel <= REDUCED_L2_REL:
        raise AssertionError(f"reduced steering: the prefill's last logits differ by relative L2 {rel}")
    m_cpu, s_cpu = sides["cpu"]
    _, cpu_gap, _ = _cache_free_top2(m_cpu.params, cfg, out["cpu"], new,
                                     clamp=(hook, s_cpu, feats, _picks(picks["generate"], 2, S)))
    diff = (out["card"][:, S:] != out["cpu"][:, S:]).any(0)
    first_diff = int(torch.nonzero(diff)[0]) if bool(diff.any()) else None
    if first_diff is not None and float(cpu_gap[:, first_diff].min()) >= REDUCED_NEAR_TIE:
        raise AssertionError(f"reduced steering: the card's and the CPU's ids differ at step {first_diff}, "
                             f"where the CPU's top-2 gap is {float(cpu_gap[:, first_diff].min())}")
    del sides, m_card, sae_card, m_cpu, s_cpu
    gc.collect()
    torch.cuda.empty_cache()
    return {"layers": layers, "tokens": S, "new_tokens": new, "dtype": "float32, eager attention", "hook": hook,
            "features": feats, "prefill_last_logits_l2_rel": rel, "l2_rel_bound": REDUCED_L2_REL,
            "first_differing_step": first_diff, "near_tie": REDUCED_NEAR_TIE,
            "replayed_selections": _merge_replays([generate_stats, prefill_stats]),
            "card_s": seconds["card"], "cpu_s": seconds["cpu"]}


def phase_steering_path(dev, card: str, model, sae) -> dict:
    """Steering and generation on the attribution phase's subject (LLaMA-3-8B
    widths, 32 layers, bf16, flash attention, LM head) and SAE (layers.24,
    131,072 latents, k = 256, fp32, decoder), through `SteeringController`
    as the steering CLI drives it: a 74-id chat prompt (LLaMA-3's headers
    around 64 ids drawn with a seed), 64 features in one chunk (16 from the
    last prompt token's top-k, 48 drawn with a seed), clamp 50, 128 greedy
    tokens; then a sampled run and a run that clamps at every step; the
    checks and readings of PERF.md's steering_path."""
    from multimodal_sae_tpu_torch.features.steering import CLAMP_CHUNK, SteeringController, clamp_features_max_batched
    from multimodal_sae_tpu_torch.ops import flash_attention as fa

    hook, F_, new, width = "layers.24", 64, 128, sae.num_latents
    vocab, cfg = model.cfg.vocab_size, model.cfg
    rng = np.random.default_rng(12)
    chat = _StubChat(rng.integers(0, 128000, size=64))
    S_p = len(chat("")["input_ids"])
    prompt = np.asarray([chat("")["input_ids"]])
    h = model.capture({"input_ids": prompt}, [hook])[hook]
    top = sae.encode(h[0, -1:]).top_indices[0, :16].long().tolist()
    feats = top + sorted(rng.choice(np.setdiff1d(np.arange(width), top), F_ - len(top), replace=False).tolist())
    chunks = -(-F_ * S_p // CLAMP_CHUNK)
    x_chunk = h[0].repeat(F_, 1)[:CLAMP_CHUNK]
    feats_of_tokens = torch.tensor(feats, device=dev).repeat_interleave(S_p)[:CLAMP_CHUNK]
    del h

    def controller(features, fbs, n_new, gen_cfg=None):
        return SteeringController(sae, hook, features, model, chat, prompt="(stub template)", k=CLAMP,
                                  max_new_tokens=n_new, feature_batch_size=fbs, generation_config=gen_cfg)

    controller(feats[:2], 2, 2).run()  # warm-up: cuBLAS handles, the allocator
    seconds = {}
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ctl = controller(feats, F_, new)
    reset_kernel_counts()
    t0 = time.perf_counter()
    result = ctl.run()
    torch.cuda.synchronize()
    seconds["run"] = time.perf_counter() - t0
    launches = kernel_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # The baseline's prefill runs 32 attentions; the chunk's too, and its
    # clamp an encode, two block-max levels and one decode per token chunk;
    # no decode step launches a kernel.
    _expect_launches(launches, {"flash_attention": 64, "block_max": 2 * chunks, "gather_rows": chunks,
                                "sae_encode": chunks}, "SteeringController.run")
    keys = [f"{hook}_feature{f}" for f in feats]
    if list(result) != keys:
        raise AssertionError("the steering result's keys differ from the features")
    steered = torch.tensor([_answer_ids(result[k]["clamped_resps"], new, vocab) for k in keys])
    baseline = _answer_ids(result[keys[0]]["original_resps"], new, vocab)
    runs = [launches]

    # The same two generates with marks: prefill and step times, and the
    # launches of the prefill and of the decode steps apart.
    iv = {hook: clamp_features_max_batched(sae, feats, CLAMP)}
    kw = dict(ctl._sample_kwargs)
    record_steered, record_every = [], []
    out_steered, timed_steered = _timed_generate(model, ctl._replicate_batch(F_), iv, new, record=record_steered,
                                                 **kw)
    runs.append(timed_steered["launches"]["prefill"])
    _expect_launches(timed_steered["launches"]["prefill"],
                     {"flash_attention": 32, "block_max": 2 * chunks, "gather_rows": chunks, "sae_encode": chunks},
                     "the steered prefill")
    _expect_launches(timed_steered["launches"]["decode"], {}, "the steered decode steps")
    if not torch.equal(out_steered[:, S_p:].cpu(), steered):
        raise AssertionError("a second steered generate gave other tokens")
    out_base, timed_base = _timed_generate(model, ctl.batch, None, new, **kw)
    runs.append(timed_base["launches"]["prefill"])
    _expect_launches(timed_base["launches"]["prefill"], {"flash_attention": 32}, "the baseline's prefill")
    _expect_launches(timed_base["launches"]["decode"], {}, "the baseline's decode steps")
    if out_base[0, S_p:].tolist() != baseline:
        raise AssertionError("a second baseline generate gave other tokens")

    # Clamping at every step: 8 features, 16 tokens.
    iv8 = {hook: clamp_features_max_batched(sae, feats[:8], CLAMP)}
    out_every, timed_every = _timed_generate(model, ctl._replicate_batch(8), iv8, 16, record=record_every,
                                             intervene_prefill_only=False, **kw)
    steps = timed_every["step_ms"]["steps"]
    runs += [timed_every["launches"]["prefill"], timed_every["launches"]["decode"]]
    _expect_launches(timed_every["launches"]["prefill"], {"flash_attention": 32, "block_max": 2, "gather_rows": 1,
                                                          "sae_encode": 1}, "the every-step prefill")
    _expect_launches(timed_every["launches"]["decode"], {"block_max": 2 * steps, "gather_rows": steps,
                                                         "sae_encode": steps}, "the every-step decode steps")

    # A sampled run: temperature 0.6 and top_p 0.9 (LLaMA-3-8B-Instruct's
    # generation_config.json), 32 tokens, the same 64 features.
    sample_cfg = {"do_sample": True, "temperature": 0.6, "top_p": 0.9, "seed": 0}
    sampled_ctl = controller(feats, F_, 32, sample_cfg)
    reset_kernel_counts()
    t0 = time.perf_counter()
    sampled = sampled_ctl.run()
    torch.cuda.synchronize()
    seconds["sampled_run"] = time.perf_counter() - t0
    runs.append(kernel_counts())
    _expect_launches(runs[-1], {"flash_attention": 64, "block_max": 2 * chunks, "gather_rows": chunks,
                                "sae_encode": chunks}, "the sampled run")
    for k_ in keys:
        _answer_ids(sampled[k_]["clamped_resps"], 32, vocab)

    # Check 1: the cache against no cache, the clamp taking the checked
    # generate's selections.
    picks_steered = _picks(record_steered, F_, S_p)
    seq_steered = torch.cat([torch.as_tensor(prompt).repeat(F_, 1), steered], dim=1).to(dev)
    argmax_steered, gap_steered, replay_steered = _cache_free_top2(model.params, cfg, seq_steered, new,
                                                                   clamp=(hook, sae, feats, picks_steered))
    cache_free = {
        "baseline": _check_cache_free(out_base[:, S_p:], *_cache_free_top2(model.params, cfg, out_base, new),
                                      "the baseline"),
        "steered_64": _check_cache_free(steered.to(dev), argmax_steered, gap_steered, replay_steered,
                                        "the steered rows"),
        "every_step_8": _check_cache_free(out_every[:, S_p:], *_cache_free_top2(
            model.params, cfg, out_every, 16, clamp=(hook, sae, feats[:8], _picks(record_every, 8, S_p))),
            "the every-step rows"),
    }
    del seq_steered, argmax_steered, record_steered, record_every

    # Check 2: batched equals sequential up to the first near tie, each
    # feature alone taking its batched row's clamp selections.
    alone = feats[:2] + feats[16:18]
    rows_alone = [feats.index(f) for f in alone]
    t0 = time.perf_counter()
    with _replaying_topk(tuple(p[rows_alone].reshape(-1, p.shape[-1]) for p in picks_steered)) as stats:
        sequential = controller(alone, 1, new).run()
    torch.cuda.synchronize()
    seconds["sequential_4"] = time.perf_counter() - t0
    replay_sequential = _merge_replays([stats])
    first_divergence = {}
    for f, row in zip(alone, rows_alone):
        seq = _answer_ids(sequential[f"{hook}_feature{f}"]["clamped_resps"], new, vocab)
        diff = [i for i in range(new) if seq[i] != int(steered[row, i])]
        first_divergence[f] = diff[0] if diff else None
        if diff and not float(gap_steered[row, diff[0]]) <= STEER_NEAR_TIE:
            raise AssertionError(f"feature {f} alone differs from its batched row at step {diff[0]}, where the "
                                 f"top-2 gap is {float(gap_steered[row, diff[0]])}")
    del picks_steered

    # Check 3: one token chunk of the clamp against its plain chain.
    clamp_chunk = _check_clamp_chunk(sae, x_chunk, feats_of_tokens, S_p)
    del x_chunk, feats_of_tokens

    # Readings: 16 decode steps under the profiler, the decode step's bound,
    # K3 at the prefill shape.
    profile = _profile_decode(model, ctl._replicate_batch(F_), iv, 16, **kw)
    bound = _decode_bound(model.params, cfg, F_, S_p, new)
    k3_prefill = _attention_case(fa, torch.Generator(device=dev).manual_seed(15), dev, F_, 32, 8, S_p, 128, None,
                                 phase="flash_attention_prefill")
    reduced = _reduced_steering(model, sae, dev)
    gc.collect()
    torch.cuda.empty_cache()
    generated = (1 + F_) * new
    emit({
        "phase": "steering_path", "subject": "LLaMA-3-8B widths, 32 layers, bf16, flash attention, LM head",
        "sae": "layers.24, 4096 -> 131072 latents, k=256, fp32, decoder", "prompt_tokens": S_p,
        "features": F_, "feature_batch": F_, "new_tokens": new, "clamp": CLAMP, "token_chunk": CLAMP_CHUNK,
        "clamp_chunks": chunks, "seconds": seconds, "generated_tokens_per_s": generated / seconds["run"],
        "features_per_s": F_ / seconds["run"], "peak_gb": peak_gb, "launches": launches,
        "steered_generate": timed_steered, "baseline_generate": timed_base, "every_step_generate": timed_every,
        "decode_step_bound": bound, "decode_profile": profile, "cache_vs_no_cache": cache_free,
        "batched_vs_sequential": {"features": alone, "first_divergence": first_divergence,
                                  "near_tie": STEER_NEAR_TIE, "replayed_selections": replay_sequential},
        "sampled": {"temperature": 0.6, "top_p": 0.9, "new_tokens": 32, "seconds": seconds["sampled_run"]},
        "clamp_chunk_check": clamp_chunk, "k3_prefill": k3_prefill, "reduced_card_vs_cpu": reduced, "card": card,
    })
    launches_total = {name: sum(run[name] for run in runs) for name in runs[0]}
    return {"launches": launches_total, "k3_prefill": k3_prefill, "clamp_chunk": clamp_chunk,
            "decode_step": {"ms": timed_steered["step_ms"], **bound}}


def phase_image_steering_path(dev, card: str) -> dict:
    """Steering on a random LLaVA-NeXT at llama3-llava-next-8b's widths (the
    CLIP-L/336 tower, the projector and all 32 text layers with the LM head;
    bf16, flash attention) with a 131,072-latent k = 256 fp32 SAE at
    model.layers.24: one 480 x 640 image (seeded pixels, prepared here: the
    card's machine has no PIL) and a short chat prompt, 2,360 tokens a row,
    8 features in one chunk (4 from the last prompt token's top-k, 4 drawn
    with a seed), 32 greedy tokens, through `SteeringController`."""
    from multimodal_sae_tpu_torch.config import SaeConfig
    from multimodal_sae_tpu_torch.device import setup
    from multimodal_sae_tpu_torch.features import steering
    from multimodal_sae_tpu_torch.features.steering import CLAMP_CHUNK, SteeringController, clamp_features_max_batched
    from multimodal_sae_tpu_torch.models import llava_next
    from multimodal_sae_tpu_torch.models.llama import LlamaConfig
    from multimodal_sae_tpu_torch.models.llava_next import LlavaNextConfig, LlavaNextModel, get_number_of_features
    from multimodal_sae_tpu_torch.ops import flash_attention as fa
    from multimodal_sae_tpu_torch.sae import Sae

    setup(dev)
    hook, F_, new = "model.layers.24", 8, 32
    t0 = time.perf_counter()
    cfg = LlavaNextConfig(text_config=LlamaConfig(vocab_size=128257, flash_attention=True))
    model = LlavaNextModel.random(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    sae = Sae(4096, SaeConfig(num_latents=131072, k=256), decoder=True, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(13)
    crops = _image_batch(cfg, [UNIFORM_HW], rng)["pixel_values"][0]
    n_image = get_number_of_features(*UNIFORM_HW, cfg)

    def prepare_inputs(images=None, prompt_ids=None, input_ids=None):
        """`prepare_inputs` for the one prepared image: placeholders
        expanded, the crops' one pixel array."""
        row = [t for t0_ in prompt_ids[0] for t in ([t0_] * n_image if t0_ == cfg.image_token_index else [t0_])]
        return {"input_ids": np.asarray([row]), "attention_mask": np.ones((1, len(row)), np.int64),
                "pixel_values": [crops], "image_sizes": [UNIFORM_HW]}

    model.prepare_inputs = prepare_inputs
    chat = _StubChat(rng.integers(0, 128000, size=8), image_token=cfg.image_token_index)
    tower_calls = []
    real_tower, real_load = llava_next.project_image_features, steering.load_image

    def counted_tower(params, cfg_, pixel_values):
        tower_calls.append(pixel_values.shape[0])
        return real_tower(params, cfg_, pixel_values)

    llava_next.project_image_features, steering.load_image = counted_tower, lambda path: path
    try:
        def controller(features, n_new):
            return SteeringController(sae, hook, features, model, chat, prompt="(stub template)",
                                      image_path="480 x 640, seeded pixels", k=CLAMP, max_new_tokens=n_new,
                                      feature_batch_size=F_)

        ctl = controller([0], new)
        S_p = ctl.batch["input_ids"].shape[1]
        h = model.capture(ctl.batch, [hook])[hook]
        top = sae.encode(h[0, -1:]).top_indices[0, :4].long().tolist()
        feats = top + sorted(rng.choice(np.setdiff1d(np.arange(sae.num_latents), top), F_ - len(top),
                                        replace=False).tolist())
        del h
        controller(feats[:2], 2).run()  # warm-up
        chunks = -(-F_ * S_p // CLAMP_CHUNK)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ctl = controller(feats, new)
        tower_calls.clear()
        reset_kernel_counts()
        t0 = time.perf_counter()
        result = ctl.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = kernel_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        n_crops, tower_run = crops.shape[0], list(tower_calls)
        if tower_run != [n_crops, n_crops]:
            raise AssertionError(f"the tower ran on {tower_run} crops; once per generate on {n_crops} expected")
        _expect_launches(launches, {"flash_attention": 64, "block_max": 2 * chunks, "gather_rows": chunks,
                                    "sae_encode": chunks}, "image SteeringController.run")
        keys = [f"{hook}_feature{f}" for f in feats]
        vocab = cfg.text_config.vocab_size
        steered = torch.tensor([_answer_ids(result[k]["clamped_resps"], new, vocab) for k in keys])
        iv = {hook: clamp_features_max_batched(sae, feats, CLAMP)}
        batch8 = ctl._replicate_batch(F_)
        record = []
        out8, timed = _timed_generate(model, batch8, iv, new, record=record, **ctl._sample_kwargs)
        runs = [launches, timed["launches"]["prefill"]]
        _expect_launches(timed["launches"]["prefill"], {"flash_attention": 32, "block_max": 2 * chunks,
                                                       "gather_rows": chunks, "sae_encode": chunks},
                         "the image prefill")
        _expect_launches(timed["launches"]["decode"], {}, "the image decode steps")
        if not torch.equal(out8[:, S_p:].cpu(), steered):
            raise AssertionError("a second image generate gave other tokens")
        embeds = model._embed_multimodal(batch8)
        lm = model.params["language_model"]
        cache_free = _check_cache_free(out8[:, S_p:], *_cache_free_top2(
            lm, cfg.text_config, out8, new, embeds=embeds, rows_at_once=2,
            clamp=("layers.24", sae, feats, _picks(record, F_, S_p))), "the image rows")
        del embeds, record
        bound = _decode_bound(lm, cfg.text_config, F_, S_p, new)
    finally:
        llava_next.project_image_features, steering.load_image = real_tower, real_load
        del model.prepare_inputs  # the class's own again, for the attribution phase
    k3_prefill = _attention_case(fa, torch.Generator(device=dev).manual_seed(16), dev, F_, 32, 8, S_p, 128, None,
                                 phase="flash_attention_prefill")
    gc.collect()
    torch.cuda.empty_cache()
    emit({
        "phase": "image_steering_path",
        "subject": "llama3-llava-next-8b widths (CLIP-L/336, projector, 32 text layers, LM head), bf16, flash attention",
        "sae": "model.layers.24, 4096 -> 131072 latents, k=256, fp32, decoder", "image": list(UNIFORM_HW),
        "prompt_tokens": S_p, "features": F_, "new_tokens": new, "clamp_chunks": chunks, "init_s": init_s,
        "run_s": run_s, "generated_tokens_per_s": (1 + F_) * new / run_s, "features_per_s": F_ / run_s,
        "peak_gb": peak_gb, "launches": launches, "tower_calls_crops": tower_run, "steered_generate": timed,
        "decode_step_bound": bound, "cache_vs_no_cache": cache_free, "k3_prefill": k3_prefill, "card": card,
    })
    total = {name: sum(run[name] for run in runs) for name in runs[0]}
    return {"launches": total, "k3_prefill": k3_prefill, "decode_step": {"ms": timed["step_ms"], **bound},
            "model": model, "sae": sae}


def phase_image_train_path(dev, card: str, model) -> dict:
    """SAE training on multimodal rows at llama3-llava-next-8b's widths (the
    image cache phase's random model: CLIP-L/336, projector, 25 text
    layers; bf16, flash attention) through `SaeTrainer` with a collator:
    model.layers.24, 131,072 latents, k = 256, fp32, batch 4, grad_acc_steps
    2, AuxK on.  Six batches: four of 480 x 640 images, then two of the
    four mixed geometries (right-padded to 2,929); the rows carry prepared
    pixel arrays and a collator of this script builds the batches (the
    card's machine has no PIL; the PIL route's collator is held on the CPU)."""
    from collections import defaultdict

    from multimodal_sae_tpu_torch.config import SaeConfig, TrainConfig
    from multimodal_sae_tpu_torch.device import setup
    from multimodal_sae_tpu_torch.train import SaeTrainer
    from multimodal_sae_tpu_torch.train.trainer import _iter_batches

    setup(dev)
    hook, B, acc, L, k = "model.layers.24", 4, 2, 131072, 256
    cfg = model.cfg
    rng = np.random.default_rng(31)
    rows = _image_rows(cfg, [UNIFORM_HW] * 4 * B + list(MIXED_HW) * 2, rng)

    def collate(batch_rows):
        return _collate_prepared(cfg, batch_rows)

    config = TrainConfig(sae=SaeConfig(num_latents=L, k=k), batch_size=B, grad_acc_steps=acc,
                         micro_acc_steps=TRAIN_MICRO, lr_warmup_steps=0, auxk_alpha=1 / 32, log_to_wandb=False,
                         hookpoints=[hook], save_every=10**9, mm_data=True)
    seconds = {}
    t0 = time.perf_counter()
    trainer = SaeTrainer(config, rows, model, device=dev, collator=collate)
    torch.cuda.synchronize()
    seconds["init_trainer"] = time.perf_counter() - t0
    # Planted dead latents: a zero encoder column and a negative bias give
    # a pre-activation of exactly 0, so they never enter a top-k (every
    # token has far more than k positive latents), get no gradient and stay
    # dead through the first window; their counters must then hold the
    # window's positions.
    planted = torch.arange(0, L, L // 8, device=dev)
    sae_params = trainer.saes[hook].params
    with torch.no_grad():
        sae_params["W_enc"][:, planted] = 0
        sae_params["b_enc"][planted] = -1.0
    batches = list(_iter_batches(rows, B, collator=trainer.collator))
    lengths = [tuple(int(n) for n in b["attention_mask"].sum(1)) for b in batches]
    if lengths != [(MIXED_LENGTHS[0],) * B] * 4 + [MIXED_LENGTHS] * 2:
        raise AssertionError(f"the collator gave row lengths {lengths}")
    metrics = {hook: defaultdict(float)}
    losses = []
    # The trainer counts every position of the collated ids toward the
    # dead-feature threshold.  This script's collator hands it expanded rows
    # (pads included), so here it counts expanded positions; on the
    # `--mm_data` route it collates un-expanded ids, an image one token
    # (`pil_route`), and counts about a thousandth as many.
    positions = [b["input_ids"].size for b in batches]
    valid = [int(b["attention_mask"].sum()) for b in batches]
    pil_route = [sum(len(r["prompt_ids"]) for r in rows[i * B:(i + 1) * B]) for i in range(len(batches))]

    def step(batch, mark=None):
        trainer.step(batch, metrics, mark=mark)
        losses.append({key: val * acc for key, val in metrics[hook].items()})
        metrics[hook].clear()

    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    t0 = time.perf_counter()
    for i, batch in enumerate(batches):
        if i == 2:
            torch.cuda.synchronize()
            t_steady = time.perf_counter()
        if i == 4:
            # AuxK on the mixed batches: half the latents dead (65,536
            # against k_aux = 2,048).
            trainer.num_tokens_since_fired[hook][::2] = config.dead_feature_threshold + 1
            trainer._refresh_dead_mask(hook)
        if i == 5:
            marks = StageMarks()
            step(batch, mark=marks)
        else:
            step(batch)
        if i == 1:  # the first boundary: each latent's count is 0 or the window's positions
            counts = trainer.num_tokens_since_fired[hook]
            window = positions[0] + positions[1]
            window_counts = {int(c): int(n) for c, n in zip(*np.unique(counts, return_counts=True))}
            if set(window_counts) != {0, window} or not np.all(counts[planted.cpu().numpy()] == window):
                raise AssertionError(f"dead-feature counters {window_counts} after the first window of {window} "
                                     f"positions, planted dead latents {counts[planted.cpu().numpy()].tolist()}")
    torch.cuda.synchronize()
    seconds["six_batches"] = time.perf_counter() - t0
    steady_s = time.perf_counter() - t_steady
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stage_ms = marks.ms()
    launches = kernel_counts()
    _expect_launches(launches, {"block_max": 2 * TRAIN_MICRO * len(batches), "flash_attention": 25 * len(batches)},
                     "image training")
    if not all(np.isfinite(v) for line in losses for v in line.values()):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not all(line["auxk"] > 0 for line in losses[4:]):
        raise AssertionError(f"AuxK loss {[line['auxk'] for line in losses[4:]]} with half the latents dead")
    if not peak_gb < 80:
        raise AssertionError(f"image training peaked at {peak_gb} GB")
    if (trainer.global_step, trainer.opt_step) != (len(batches), len(batches) // acc):
        raise AssertionError(f"step counters {(trainer.global_step, trainer.opt_step)}")

    # One accumulate against the CPU on captured rows of a mixed batch: the
    # end of the 336 x 336 image's row and the pad rows after it.
    with torch.no_grad():
        h = model.capture(batches[4], [hook])[hook]
    S = h.shape[1]
    cut = S + MIXED_LENGTHS[1]  # row 1's first pad position in the flattened rows
    t0 = time.perf_counter()
    cpu_line = check_accumulate_cpu(h.reshape(-1, h.shape[-1])[cut - 512: cut + 512], dev)
    seconds["cpu_cross_check"] = time.perf_counter() - t0
    cpu_line["pad_rows"] = 512
    del trainer, h
    gc.collect()
    torch.cuda.empty_cache()
    emit({
        "phase": "image_train_path",
        "subject": "llama3-llava-next-8b widths (CLIP-L/336, projector, 25 text layers), bf16, flash attention",
        "sae": "4096 -> 131072 latents, k=256, fp32", "hookpoint": hook, "batch_size": B, "grad_acc_steps": acc,
        "micro_acc_steps": TRAIN_MICRO, "auxk_alpha": config.auxk_alpha, "auxk_from_batch": 5,
        "batches": [b["image_sizes"] for b in batches], "row_lengths": lengths,
        "expanded_positions_per_s": sum(positions[2:]) / steady_s, "tokens_per_s_valid": sum(valid[2:]) / steady_s,
        "tokens_per_s_over": "batches 3-6, host preprocessing excluded",
        "expanded_positions_per_batch": positions, "window_counts_to_latents": window_counts,
        "planted_dead_latents": planted.tolist(), "valid_tokens_per_batch": valid,
        "pil_route_ids_per_batch": pil_route,
        "images_per_s": (len(batches) - 2) * B / steady_s, "seconds": seconds, "stage_ms_batch6": stage_ms,
        "peak_gb": peak_gb, "losses": losses, "launches": launches, "cpu_cross_check": cpu_line, "card": card,
    })
    return {"launches": launches}


RAGGED_HW = (1000, 1000)
# The ragged probe row: its image takes 2,928 tokens, the row 2,946 with the
# chat prompt; the 480 x 640 row beside it (2,358) is left-padded by 588.
IMAGE_PAD_SHIFT_HIDDEN_REL = 5e-2
IMAGE_PAD_SHIFT_GRAD_REL = 5e-2
IMAGE_PAD_SHIFT_SALIENCY = 0.15
# The left-padded probe row of the ragged batch against the same row alone
# without pads, on the bf16 subject: the hidden state at the hook within
# 5e-2 relative L2 at every real position, the gradient at the splice
# (times 2: the batch's metric means over its rows) within 5e-2 relative
# L2 over the row, and each feature's saliency within 0.15 of the largest
# feature's saliency norm (L2 over the row).  Left padding moves the row's
# RoPE positions by the pad (588), which changes nothing in exact
# arithmetic and leaves bf16 rounding at each of the 25 prefix layers and
# the 7 suffix layers forward and backward (2^-9 relative a rounding,
# compounding through the random subject).  The saliency is held against
# the largest feature's norm, not its own: a feature's saliency is a
# projection of the gradient that can nearly cancel, and its own norm is
# then no scale for that rounding (on an H100, one feature at a fifteenth
# of the largest norm read 130% of its own norm and 8.7% of the largest;
# eager bf16 attention at 4 layers reads up to 6.9%).  A pad key read, or a lost
# or misplaced row, moves them by O(1).
IMAGE_PAD_SHIFT_FP32_REL = 1e-3
# The same comparison on the subject cut to 4 text layers in fp32 with
# eager attention (the hook at model.layers.2): each feature's saliency,
# and the gradient, within 1e-3 of its own L2 norm.  Without bf16
# rounding the pad shift must leave the positions, masks, metric token and
# pool as they are; the same cut in bf16, with K3 and with eager
# attention, is read beside it.


def _splice_gradient(model, hook: str, batch: dict, metric):
    """(the hook's hidden state, the gradient of the metric at the splice):
    the prefix capture and the suffix `forward_from_layer` that fast
    attribution runs, without the SAE."""
    with torch.no_grad():
        h = model.capture(batch, [hook])[hook]
    delta = torch.zeros(h.shape, dtype=torch.float32, device=h.device, requires_grad=True)
    (grad,) = torch.autograd.grad(metric(model.forward_from_layer(h + delta.to(h.dtype), hook, batch)), delta)
    return h, grad


def _at_depth(model, layers: int, dtype, flash: bool):
    """`model` (a LlavaNextModel) cut to its first `layers` text layers,
    every weight cast to `dtype`, with K3 or eager attention."""
    import dataclasses

    from multimodal_sae_tpu_torch.models.llava_next import LlavaNextModel

    def cast(tree):
        if isinstance(tree, dict):
            return {key: cast(val) for key, val in tree.items()}
        if isinstance(tree, list):
            return [cast(val) for val in tree]
        return tree.to(dtype) if torch.is_tensor(tree) and tree.is_floating_point() else tree

    params = dict(model.params, language_model=dict(model.params["language_model"]))
    params["language_model"]["layers"] = params["language_model"]["layers"][:layers]
    text = dataclasses.replace(model.cfg.text_config, num_hidden_layers=layers, flash_attention=flash)
    return LlavaNextModel(cast(params), dataclasses.replace(model.cfg, text_config=text))


def _pad_shift(model, hook: str, sae, padded: tuple, single: tuple, pad: int) -> dict:
    """Row 0 of the ragged probe batch `padded` (batch, metric), left-padded
    by `pad`, against the same row alone without pads `single`, as
    `Attribution` builds the probe row alone: the hook's hidden state, the
    splice's gradient (exactly 0 at the pads), and the saliency of each
    row's 2 largest features at its last position, the row alone
    replaying the batch's prefix pool (its own would differ at near ties).
    Returns each as its relative L2 reading."""
    from multimodal_sae_tpu_torch.features.patching import attribution, build_fast_attribution, fast_attribution_maps

    (batch2, metric2), (one, metric1) = padded, single
    S2 = batch2["input_ids"].shape[1]
    h_pad, g_pad = _splice_gradient(model, hook, batch2, metric2)
    h_one, g_one = _splice_gradient(model, hook, one, metric1)
    if bool(g_pad[0, :pad].any()):
        raise AssertionError("the splice's gradient at the pad positions is not exactly 0")
    h_pad, h_one = h_pad[0, pad:].float(), h_one[0].float()
    hidden_rel = ((h_pad - h_one).norm(dim=-1) / h_one.norm(dim=-1)).max().item()
    grad_rel = ((2 * g_pad[0, pad:] - g_one[0]).norm() / g_one[0].norm()).item()
    del h_pad, g_pad, h_one, g_one
    step = build_fast_attribution(model, hook, sae, batch2, metric2)
    pool = tuple(t.view(2, S2, -1)[0, pad:].cpu() for t in (step.wide_idx, step.wide_vals))
    feats = step.wide_idx[S2 - 1, :2].long().tolist() + step.wide_idx[2 * S2 - 1, :2].long().tolist()
    del step
    torch.cuda.empty_cache()
    got = 2 * _saliency(fast_attribution_maps(model, hook, sae, batch2, metric2, feats, feature_batch=2,
                                              progress=False), hook)[:, 0, pad:]
    with _selections([pool], replay=True, module=attribution) as gaps:
        want = _saliency(fast_attribution_maps(model, hook, sae, one, metric1, feats, feature_batch=2,
                                               progress=False), hook)[:, 0]
    gaps = torch.cat(gaps)
    norms, err = np.linalg.norm(want, axis=-1), np.linalg.norm(got - want, axis=-1)
    return {"features": feats, "hidden_max_row_l2_rel": hidden_rel, "grad_l2_rel": grad_rel,
            "own_pool_would_differ": len(gaps), "worst_gap_to_noise": gaps.max().item() if len(gaps) else 0.0,
            "saliency_norm_to_largest": (norms / norms.max()).tolist(),
            "saliency_l2_rel": (err / np.maximum(norms, np.finfo(np.float32).tiny)).tolist(),
            "saliency_l2_rel_to_largest": (err / norms.max()).tolist()}


def phase_image_attribution_path(dev, card: str, model, sae) -> dict:
    """Fast attribution on the LLaVA-NeXT subject at llama3-llava-next-8b's
    widths (the image steering phase's random model: CLIP-L/336, projector,
    32 text layers and the LM head, bf16, flash attention) with its SAE at
    model.layers.24 (131,072 latents, k = 256, fp32, decoder), through
    `fast_attribution_maps` on probe batches built as `Attribution` builds
    them (chat prompt, placeholder expanded, left-repacked; seeded pixels,
    no PIL on the card's machine)."""
    from functools import partial

    from multimodal_sae_tpu_torch.features.patching import (
        build_fast_attribution, fast_attribution_maps, general_attribution_maps, get_logit_diff,
    )
    from multimodal_sae_tpu_torch.models import llava_next
    from multimodal_sae_tpu_torch.models.llava_next import repack_left_padded

    hook, fb, width, k = "model.layers.24", 8, sae.num_latents, sae.cfg.k
    n_suffix = 32 - 25
    cfg = model.cfg
    rng = np.random.default_rng(21)
    vocab = cfg.text_config.vocab_size - 1  # the last id is the image placeholder
    pixels = {hw: _image_rows(cfg, [hw], rng)[0]["pixel_values"] for hw in (UNIFORM_HW, RAGGED_HW)}
    prompts = [rng.integers(0, 128000, size=8).tolist() for _ in range(2)]
    answers = rng.integers(0, vocab, size=(2, 2))

    def metric_of(rows):
        return partial(get_logit_diff, answer_token_indices=torch.tensor(answers[rows], device=dev))

    def probe(rows):
        """(batch, metric) of probe rows (image size, row index) as
        `Attribution` builds them: left-repacked, an all-ones mask dropped."""
        batch = repack_left_padded(_collate_prepared(cfg, [
            {"prompt_ids": CHAT_HEAD + [cfg.image_token_index] + prompts[r] + CHAT_TAIL, "image_size": hw,
             "pixel_values": pixels[hw]} for hw, r in rows]))
        if batch["attention_mask"].all():
            batch = {key: val for key, val in batch.items() if key != "attention_mask"}
        return batch, metric_of([r for _, r in rows])

    tower_calls = []
    real_tower = llava_next.project_image_features

    def counted_tower(params, cfg_, pixel_values):
        tower_calls.append(pixel_values.shape[0])
        return real_tower(params, cfg_, pixel_values)

    llava_next.project_image_features = counted_tower
    seconds = {}
    try:
        batch, metric = probe([(UNIFORM_HW, 0)])
        S = batch["input_ids"].shape[1]
        if S != 2358:
            raise AssertionError(f"the probe row has {S} tokens, 2,358 expected")
        # Outside the counted run: the prefix once to choose the features and
        # feed K2's checks, one chunk as warm-up, one timed stage by stage.
        t0 = time.perf_counter()
        step = build_fast_attribution(model, hook, sae, batch, metric)
        inside = step.wide_idx[-1, :8].long().tolist()  # the last position's 8 largest
        in_pool = torch.zeros(width, dtype=torch.bool, device=dev)
        in_pool[step.wide_idx.long().reshape(-1)] = True
        outside = sorted(rng.choice(torch.nonzero(~in_pool).squeeze(1).cpu().numpy(), size=8, replace=False).tolist())
        feats = inside + outside
        chunk = torch.tensor(inside)
        step(chunk)  # warm-up
        torch.cuda.synchronize()
        seconds["prefix_and_warmup_chunk"] = time.perf_counter() - t0
        stage_ms = time_stages(step, chunk)
        # The general path's splices replay the fast path's selections: the
        # clean top-k, then each feature's re-selected list.
        general_picks = [step.wide_idx[:, :k].cpu()] + [
            step.reselect(torch.tensor([f], device=dev))[1].cpu() for f in inside[:2]]
        torch.cuda.empty_cache()

        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        tower_calls.clear()
        reset_kernel_counts()
        t0 = time.perf_counter()
        out = fast_attribution_maps(model, hook, sae, batch, metric, feats, feature_batch=fb, progress=False)
        torch.cuda.synchronize()
        seconds["run"] = time.perf_counter() - t0
        launches = kernel_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        tower_run = list(tower_calls)
        n_crops = pixels[UNIFORM_HW].shape[0]
        if tower_run != [n_crops]:
            raise AssertionError(f"the tower ran on {tower_run} crops; once on {n_crops} expected")
        chunks = len(feats) // fb
        # Prefix: 25 forward attentions, the two block-max levels of the
        # top-(k+1) pool, the clean decode; per chunk one splice and the
        # suffix's 7 attentions forward and backward.
        _expect_launches(launches, {"block_max": 2, "flash_attention": 25 + n_suffix * chunks,
                                    "flash_attention_bwd_delta": n_suffix * chunks,
                                    "flash_attention_bwd_dkdv": n_suffix * chunks,
                                    "flash_attention_bwd_dq": n_suffix * chunks, "gather_rows": 1,
                                    "splice_decode": chunks, "sae_encode": 1}, "image attribution")
        sal = _saliency(out, hook)  # (16, 1, S)
        if sal.shape != (len(feats), 1, S):
            raise AssertionError(f"saliency shape {sal.shape}")
        if np.any(sal[8:] != 0):
            raise AssertionError("saliency of a feature outside every top-k is not exactly 0")
        if not np.any(sal[:8] != 0):
            raise AssertionError("saliency of the in-top-k features is all 0")
        k2 = check_gather_rows(sae.params["W_dec"], step.wide_idx[:, :k], step.wide_vals[:, :k],
                               step.reselect(torch.tensor(inside, device=dev)))
        splice = check_splice_decode(step, inside, outside, sae.params["W_dec"], sae.params["b_dec"])
        del step
        torch.cuda.empty_cache()

        # Check 1: the general path (full spliced forward and backward, the
        # tower again) for 2 features, on the fast path's selections.
        t0 = time.perf_counter()
        with _selections(general_picks, replay=True) as gaps:
            general = general_attribution_maps(model, {hook: sae}, batch, metric, inside[:2], progress=False)
        torch.cuda.synchronize()
        seconds["general_2_features"] = time.perf_counter() - t0
        gaps = torch.cat(gaps)
        general_gap = gaps.max().item() if len(gaps) else 0.0
        if general_gap > GENERAL_NEAR_TIE:
            raise AssertionError(f"the general path's own top-k lies {general_gap} from the fast path's")
        agreement = []
        for f, g in zip(sal[:2], general[hook]):
            rel = float(np.linalg.norm(f - g) / np.linalg.norm(g))
            agreement.append(rel)
            if not rel <= ATTRIBUTION_L2_REL:
                raise AssertionError(f"fast and general image attribution differ: relative L2 {rel}")

        # Check 2: a ragged batch of two geometries against each row alone.
        batch2, metric2 = probe([(UNIFORM_HW, 0), (RAGGED_HW, 1)])
        S2 = batch2["input_ids"].shape[1]
        lengths = batch2["attention_mask"].sum(1).tolist()
        step2 = build_fast_attribution(model, hook, sae, batch2, metric2)
        feats2 = (step2.wide_idx[S2 - 1, :2].long().tolist() + step2.wide_idx[2 * S2 - 1, :2].long().tolist())
        del step2
        torch.cuda.empty_cache()
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        tower_calls.clear()
        reset_kernel_counts()
        t0 = time.perf_counter()
        out2 = fast_attribution_maps(model, hook, sae, batch2, metric2, feats2, feature_batch=4, progress=False)
        torch.cuda.synchronize()
        seconds["ragged_run"] = time.perf_counter() - t0
        launches2 = kernel_counts()
        ragged_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if tower_calls != [pixels[hw].shape[0] for hw in (UNIFORM_HW, RAGGED_HW)]:
            raise AssertionError(f"the tower ran on {tower_calls} crops in the ragged run")
        _expect_launches(launches2, {"block_max": 2, "flash_attention": 25 + n_suffix,
                                     "flash_attention_bwd_delta": n_suffix, "flash_attention_bwd_dkdv": n_suffix,
                                     "flash_attention_bwd_dq": n_suffix, "gather_rows": 1, "splice_decode": 1,
                                     "sae_encode": 1}, "ragged image attribution")
        sal2 = _saliency(out2, hook)  # (4, 2, S2)
        pad = S2 - lengths[0]
        if np.any(sal2[:, 0, :pad] != 0):
            raise AssertionError("saliency at the left-padded row's pad positions is not exactly 0")
        # Each row alone as a batch of one with the pad it has in the batch
        # (row 0 its 588 leading pads, row 1 none): the same computation at
        # the same positions, so the same bits (the batch's metric means over
        # its 2 rows, and the halving is exact).
        alone = []
        for r in range(2):
            one = {key: val[r:r + 1] if key in ("input_ids", "attention_mask") else [val[r]]
                   for key, val in batch2.items()}
            if one["attention_mask"].all():
                one = {key: val for key, val in one.items() if key != "attention_mask"}
            ref = _saliency(fast_attribution_maps(model, hook, sae, one, metric_of([r]), feats2, feature_batch=4,
                                                  progress=False), hook)
            if not np.array_equal(sal2[:, r] * 2, ref[:, 0]):
                raise AssertionError(f"row {r} of the ragged batch differs from the row alone with its pad")
            alone.append({"tokens": lengths[r], "left_pad": S2 - lengths[r], "equal_bits": True})
        # Row 0 without its pads, as `Attribution` builds the probe row alone:
        # its RoPE positions move by the pad, which changes nothing in exact
        # arithmetic and leaves bf16 rounding.  Held on this subject within
        # IMAGE_PAD_SHIFT_*, and in fp32 at 4 layers within
        # IMAGE_PAD_SHIFT_FP32_REL.
        single = probe([(UNIFORM_HW, 0)])
        unpadded = _pad_shift(model, hook, sae, (batch2, metric2), single, pad)
        if not (unpadded["hidden_max_row_l2_rel"] <= IMAGE_PAD_SHIFT_HIDDEN_REL
                and unpadded["grad_l2_rel"] <= IMAGE_PAD_SHIFT_GRAD_REL
                and max(unpadded["saliency_l2_rel_to_largest"]) <= IMAGE_PAD_SHIFT_SALIENCY
                and unpadded["worst_gap_to_noise"] <= REPLAY_NOISE_FACTOR):
            raise AssertionError(f"row 0 without its pads differs: {unpadded}")
        unpadded.update(tokens=lengths[0], hidden_bound=IMAGE_PAD_SHIFT_HIDDEN_REL,
                        grad_bound=IMAGE_PAD_SHIFT_GRAD_REL, saliency_bound_to_largest=IMAGE_PAD_SHIFT_SALIENCY)
        reduced = {}
        for name, dtype, flash in (("fp32_eager", torch.float32, False), ("bf16_flash", torch.bfloat16, True),
                                   ("bf16_eager", torch.bfloat16, False)):
            cut = _at_depth(model, 4, dtype, flash)
            reduced[name] = _pad_shift(cut, "model.layers.2", sae, (batch2, metric2), single, pad)
            del cut
            torch.cuda.empty_cache()
        fp32 = reduced["fp32_eager"]
        if not (max(fp32["saliency_l2_rel"]) <= IMAGE_PAD_SHIFT_FP32_REL
                and fp32["grad_l2_rel"] <= IMAGE_PAD_SHIFT_FP32_REL):
            raise AssertionError(f"fp32 at 4 layers: row 0 without its pads differs: {fp32}")
        reduced.update(layers=4, hook="model.layers.2", fp32_bound=IMAGE_PAD_SHIFT_FP32_REL)
    finally:
        llava_next.project_image_features = real_tower

    emit({
        "phase": "image_attribution_path",
        "subject": "llama3-llava-next-8b widths (CLIP-L/336, projector, 32 text layers, LM head), bf16, flash attention",
        "sae": "model.layers.24, 4096 -> 131072 latents, k=256, fp32, decoder", "image": list(UNIFORM_HW),
        "prompt_tokens": S, "features": len(feats), "feature_batch": fb, "seconds": seconds,
        "ms_per_feature": seconds["run"] * 1e3 / len(feats), "features_per_s": len(feats) / seconds["run"],
        "outside_chunks_ms": seconds["run"] * 1e3 - chunks * stage_ms["total"], "chunk_stage_ms": stage_ms,
        "tower_calls_crops": tower_run, "peak_gb": peak_gb, "launches": launches, "outside_topk_exact_zero": True,
        "fast_vs_general_l2_rel": agreement, "l2_rel_bound": ATTRIBUTION_L2_REL,
        "general_own_topk_would_differ": len(gaps), "general_largest_gap": general_gap,
        "ragged": {"sizes": [list(UNIFORM_HW), list(RAGGED_HW)], "row_lengths": lengths, "tokens": S2,
                   "features": feats2, "feature_batch": 4, "launches": launches2, "peak_gb": ragged_peak_gb,
                   "pad_positions_exact_zero": True, "rows_alone_with_their_pads": alone,
                   "row0_without_pads": unpadded, "row0_without_pads_at_4_layers": reduced},
        "k2_decode": k2, "k2_splice": splice, "card": card,
    })
    return {"launches": {name: launches[name] + launches2[name] for name in launches}, "k2": k2, "splice": splice,
            "pads": [pad, 0], "S2": S2, "S": S,
            "remat_probe": {"batch": batch, "metric": metric, "inside": inside, "tokens": S},
            "saliency": {"maps": sal[:, 0], "prompt_ids": CHAT_HEAD + [cfg.image_token_index] + prompts[0] + CHAT_TAIL}}


# ---- the researcher tools (multimodal_sae_tpu_torch/tools/) ------------------------

TOOLS_NEW = 32
# model_steering's core generates 32 tokens a generate, not the tool's 512,
# to bound the time (decode steps are host-bound, 25-44 ms each).
TOOLS_CLAMP = 10.0  # model_steering's default --clamp-value
PROBE_CANDIDATES = 256
PROBE_NEAR_TIE = 1e-4
# The probe's ranking against float64 on the host: the card's fp32 mean
# (one fp32 product of 4,096 terms a latent and token, summed over the
# tokens) lies about 1e-6 of the largest mean from float64's, so at each
# rank the float64 means of the card's feature and of float64's own must
# agree within 1e-4 of the largest mean.  float64 recomputes the card's top
# 256 candidates only (the host would take minutes for all 131,072 over
# 2,432 tokens); nothing outside them can rank in the top 10 when the 10th
# float64 mean exceeds the card's 256th by more than the margin, which is
# checked.
PROBE_ACT_REL = 1e-4
# The chosen columns against float64: within 1e-4 of the largest float64
# pre-activation of those columns (fp32 products of 4,096 terms).
FILTERS_NEAR_TIE = 1e-6
# create_filters' float32 pooling (numpy's) against float64's: at each
# rank the float64 pools agree within 1e-6 of the largest |pool|.
TOOLS_HEATMAP_FEATURES = 16
TOOLS_FILTERS_TOP_K = 8


def _probe_against_float64(features, acts, card_mean, hidden: torch.Tensor, sae, n: int, what: str) -> dict:
    """The probe core's top-n `features` and their (n, tokens) `acts`
    against a float64 recomputation on the host from the captured `hidden`
    (tokens, d), over the card mean's top PROBE_CANDIDATES latents."""
    cands = np.argsort(-card_mean, kind="stable")[:PROBE_CANDIDATES]
    params = {name: t.detach() for name, t in sae.params.items()}
    cols = torch.as_tensor(cands, device=params["W_enc"].device)
    W = params["W_enc"][:, cols].double().cpu()
    b_enc, b_dec = params["b_enc"][cols].double().cpu(), params["b_dec"].double().cpu()
    lat = ((hidden.double().cpu() - b_dec) @ W + b_enc).clamp_min(0)  # (tokens, candidates)
    mean64 = lat.mean(0).numpy()
    order = np.argsort(-mean64, kind="stable")[:n]
    margin = PROBE_NEAR_TIE * float(mean64.max())
    position = {int(f): i for i, f in enumerate(cands)}
    missing = [int(f) for f in features if int(f) not in position]
    if missing:
        raise AssertionError(f"{what}: features {missing} are not among the card mean's top {PROBE_CANDIDATES}")
    got = np.array([mean64[position[int(f)]] for f in features])
    rank_err = float(np.abs(got - mean64[order]).max())
    if not rank_err <= margin:
        raise AssertionError(f"{what}: the top {n} differ from float64's beyond near ties ({rank_err} > {margin})")
    excluded_by = float(mean64[order[-1]] - card_mean[cands[-1]])
    if not excluded_by > margin:
        raise AssertionError(f"{what}: the {PROBE_CANDIDATES}th candidate's mean is within the margin of the "
                             f"{n}th ({excluded_by})")
    ref = lat[:, [position[int(f)] for f in features]].T.numpy()
    act_err = float(np.abs(acts - ref).max())
    act_bound = PROBE_ACT_REL * float(np.abs(ref).max())
    if not act_err <= act_bound:
        raise AssertionError(f"{what}: the chosen columns differ from float64's by {act_err} (bound {act_bound})")
    return {"features": [int(f) for f in features], "equal_positions": int((np.asarray(features) == cands[order]).sum()),
            "largest_rank_mean_err": rank_err, "near_tie_margin": margin, "exclusion_gap": excluded_by,
            "max_abs_err_columns": act_err, "columns_bound": act_bound,
            "mean_max_abs_err_candidates": float(np.abs(card_mean[cands] - mean64).max())}


def _timed_core(fn):
    """(result, ms, launches) of `fn()`: the kernel counts set to 0 first,
    host time around it with the card synchronised."""
    gc.collect()
    torch.cuda.synchronize()
    reset_kernel_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, kernel_counts()


def _tool_launches(launches: dict) -> dict:
    return {name: launches[name] for name in ("flash_attention", "block_max", "gather_rows", "sae_encode")}


def _parse_heatmap(page: str) -> dict:
    """Parse the heatmap page: its h2 headings and every span's alpha."""
    import html.parser

    class Page(html.parser.HTMLParser):
        def __init__(self):
            super().__init__()
            self.headings, self.alphas, self._h2 = [], [], False

        def handle_starttag(self, tag, attrs):
            self._h2 = tag == "h2"
            style = dict(attrs).get("style") or ""
            if tag == "span":
                self.alphas.append(float(style.rsplit(", ", 1)[1].rstrip(");")))

        def handle_data(self, data):
            if self._h2:
                self.headings.append(data)
                self._h2 = False

    parser = Page()
    parser.feed(page)
    parser.close()
    return {"headings": parser.headings, "alphas": parser.alphas}


def phase_tools_path(dev, card: str, model, sae) -> dict:
    """The cores of the card tools on the attribution phase's subject
    (LLaMA-3-8B widths, 32 layers, bf16, flash attention, LM head) and SAE
    (layers.24, 131,072 latents, k = 256, fp32, decoder): model_steering's
    `steer` on one feature (a 74-id chat prompt through
    `prepare_prompt_batch` and the stub chat template), probe_activations'
    `probe` and text_activation_vis' `feature_activations` on the
    attribution prompt (2,432 ids), each timed and its launches counted."""
    from multimodal_sae_tpu_torch.features.steering import clamp_features_max
    from multimodal_sae_tpu_torch.launch.utils import prepare_prompt_batch
    from multimodal_sae_tpu_torch.tools import model_steering, probe_activations, text_activation_vis

    hook, vocab = "layers.24", model.cfg.vocab_size
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(31)
    chat = _StubChat(rng.integers(0, 128000, size=64))
    _, _, batch = prepare_prompt_batch(model, None, chat, "(stub template)", use_chat_template=True)
    S_p = model_steering.prompt_length(batch)
    h = model.capture(batch, [hook])[hook]
    feature = int(sae.encode(h[0, -1:]).top_indices[0, 0])  # the last prompt token's largest latent
    del h
    model_steering.steer(model, sae, batch, hook, feature, TOOLS_CLAMP, max_new_tokens=2)  # warm-up
    (original, steered), steer_ms, steer_launches = _timed_core(
        lambda: model_steering.steer(model, sae, batch, hook, feature, TOOLS_CLAMP, max_new_tokens=TOOLS_NEW))
    # Two prefills of 32 attentions; the clamp (74 tokens, one chunk) an
    # encode, two block-max levels and one decode; no decode step launches
    # a kernel.
    _expect_launches(steer_launches, {"flash_attention": 64, "block_max": 2, "gather_rows": 1, "sae_encode": 1},
                     "model_steering's core")
    direct = model.generate(batch, max_new_tokens=TOOLS_NEW)
    direct_steered = model.generate(batch, max_new_tokens=TOOLS_NEW, intervene_prefill_only=True,
                                    interventions={hook: clamp_features_max(sae, feature, k=TOOLS_CLAMP)})
    if not (torch.equal(original, direct[:, S_p:]) and torch.equal(steered, direct_steered[:, S_p:])):
        raise AssertionError("model_steering's core differs from direct generates")
    texts = [model_steering.decode_first(chat, t) for t in (original, steered)]
    for text in texts:
        _answer_ids(text, TOOLS_NEW, vocab)
    first_diff = [i for i in range(TOOLS_NEW) if int(original[0, i]) != int(steered[0, i])]

    # The attribution prompt.
    ids = np.random.default_rng(1).integers(0, vocab, size=(1, 2432))
    interval = [0, 10]
    probe_activations.probe(model, sae, {"input_ids": ids[:, :64]}, hook, interval)  # warm-up
    (feats, acts, mean), probe_ms, probe_launches = _timed_core(
        lambda: probe_activations.probe(model, sae, {"input_ids": ids}, hook, interval))
    # A capture runs the 25 layers up to the hookpoint, then one encode; no top-k.
    _expect_launches(probe_launches, {"flash_attention": 25, "sae_encode": 1}, "probe_activations' core")
    hidden = model.capture({"input_ids": ids}, [hook])[hook][0]
    if acts.shape != (10, ids.shape[1]) or not np.isfinite(acts).all():
        raise AssertionError(f"probe columns of shape {acts.shape}, or not finite")
    probe_check = _probe_against_float64(feats, acts, mean, hidden, sae, interval[1], "the text probe")

    vals, idx = sae.encode(hidden)
    selected = torch.unique(idx.long()).cpu().numpy()
    unselected = np.setdiff1d(np.arange(sae.num_latents), selected)
    hm_feats = sorted(rng.choice(selected, TOOLS_HEATMAP_FEATURES - 2, replace=False).tolist()
                      + rng.choice(unselected, 2, replace=False).tolist())
    text_activation_vis.feature_activations(model, {hook: sae}, ids[0, :64].tolist(), {hook: hm_feats})  # warm-up
    columns, heatmap_ms, heatmap_launches = _timed_core(
        lambda: text_activation_vis.feature_activations(model, {hook: sae}, ids[0].tolist(), {hook: hm_feats}))
    # The capture's 25 attentions; the encode and its two block-max levels.
    _expect_launches(heatmap_launches, {"flash_attention": 25, "block_max": 2, "sae_encode": 1},
                     "text_activation_vis' core")
    columns = columns[hook]
    # Every written activation is the encode's value: idx and vals on the
    # host, each feature's column scattered there.
    idx_h, vals_h = idx.cpu().numpy(), vals.cpu().numpy()
    want = np.zeros((ids.shape[1], len(hm_feats)), np.float32)
    for j, f in enumerate(hm_feats):
        rows, slots = np.nonzero(idx_h == f)
        want[rows, j] = vals_h[rows, slots]
    if not np.array_equal(columns, want):
        raise AssertionError("text_activation_vis' columns differ from the encode's values")
    page = text_activation_vis.HTML_START + "".join(
        text_activation_vis.generate_feature_html(f"{hook}_feature{f}", [str(t) for t in ids[0]], columns[:, j],
                                                  f"explanation {f}")
        for j, f in enumerate(hm_feats)) + text_activation_vis.HTML_END
    parsed = _parse_heatmap(page)
    if (parsed["headings"] != [f"{hook}_feature{f}" for f in hm_feats]
            or len(parsed["alphas"]) != len(hm_feats) * ids.shape[1]
            or not all(0.0 <= a <= 1.0 for a in parsed["alphas"])):
        raise AssertionError("the heatmap page does not parse to its features' spans")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del hidden, vals, idx
    gc.collect()
    torch.cuda.empty_cache()
    launches = {"model_steering": _tool_launches(steer_launches), "probe_activations": _tool_launches(probe_launches),
                "text_activation_vis": _tool_launches(heatmap_launches)}
    emit({
        "phase": "tools_path", "subject": "LLaMA-3-8B widths, 32 layers, bf16, flash attention, LM head",
        "sae": "layers.24, 4096 -> 131072 latents, k=256, fp32, decoder",
        "model_steering": {"prompt_tokens": S_p, "feature": feature, "clamp": TOOLS_CLAMP, "new_tokens": TOOLS_NEW,
                           "ms": steer_ms, "equal_to_direct_generates": True,
                           "first_step_steered_differs": first_diff[0] if first_diff else None},
        "probe_activations": {"prompt_tokens": ids.shape[1], "interval": interval, "ms": probe_ms,
                              "float64_check": probe_check},
        "text_activation_vis": {"prompt_tokens": ids.shape[1], "features": hm_feats, "ms": heatmap_ms,
                                "written_equal_to_encode": True, "nonzero": int(np.count_nonzero(columns)),
                                "page_bytes": len(page), "spans": len(parsed["alphas"])},
        "launches": launches, "peak_gb": peak_gb, "card": card,
    })
    total = {name: steer_launches[name] + probe_launches[name] + heatmap_launches[name] for name in steer_launches}
    return {"launches": total, "per_tool": launches, "ms": {"model_steering": steer_ms, "probe_activations": probe_ms,
                                                            "text_activation_vis": heatmap_ms}, "peak_gb": peak_gb}


def _filters_against_float64(filters, maps: np.ndarray, tokens, image_token: int, trim: bool, k: int) -> dict:
    """create_filters' ranking of one hookpoint's (features, tokens) map
    against float64 pools: the image span, the placeholder's expansion,
    and the text after it (its last 4 positions dropped with `trim`)."""
    prev = list(tokens).index(image_token)
    n_image = maps.shape[1] - (len(tokens) - 1)
    m = maps.astype(np.float64)
    image_pool = m[:, prev:prev + n_image].mean(1)
    text_pool = m[:, prev + n_image:maps.shape[1] - (4 if trim else 0)].mean(1)
    errs = []
    for got, pool in ((filters[:k], image_pool), (filters[k:], text_pool)):
        want = np.argsort(-pool, kind="stable")[:k]
        errs.append(float(np.abs(pool[np.asarray(got)] - pool[want]).max()))
        margin = FILTERS_NEAR_TIE * float(np.abs(pool).max())
        if not errs[-1] <= margin:
            raise AssertionError(f"create_filters' ranking differs from float64's beyond near ties ({errs[-1]})")
    return {"image_tokens": n_image, "largest_rank_pool_err": errs, "near_tie_rel": FILTERS_NEAR_TIE}


def phase_image_tools_path(dev, card: str, model, sae, saliency: dict) -> dict:
    """The tools on the image steering phase's LLaVA-NeXT (llama3-llava-next-8b
    widths, 32 text layers, bf16, flash attention) and SAE: create_filters_
    from_attribution's `create_filters` (no PNGs: the card's machine has no
    PIL) on the image attribution phase's saliency maps, and
    probe_activations' `probe` on an image-only prompt ([BOS, <image>]) of
    one 480 x 640 image from the image steering phase's seeded pixels, the
    leading BOS skipped as the tool skips it for a LLaMA subject."""
    from multimodal_sae_tpu_torch.tools import create_filters_from_attribution, probe_activations

    hook, cfg = "model.layers.24", model.cfg
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tokens = saliency["prompt_ids"][1:]
    names = {EOT: create_filters_from_attribution.EOT_MARKER}
    tokens_str = [names.get(t, str(t)) for t in tokens]
    maps = {hook: saliency["maps"][:, 1:]}  # the token axis without BOS
    t0 = time.perf_counter()
    filters, pages, grids = create_filters_from_attribution.create_filters(
        maps, tokens, tokens_str, cfg.image_token_index, top_k=TOOLS_FILTERS_TOP_K)
    filters_ms = (time.perf_counter() - t0) * 1e3
    filters_check = _filters_against_float64(filters[hook], maps[hook], tokens, cfg.image_token_index, True,
                                             TOOLS_FILTERS_TOP_K)
    if (len(filters[hook]) != 2 * TOOLS_FILTERS_TOP_K or pages[hook].count("<p>feature_") != TOOLS_FILTERS_TOP_K
            or [g.shape for _, g in grids[hook]] != [(24, 24)] * TOOLS_FILTERS_TOP_K):
        raise AssertionError("create_filters' outputs have the wrong counts or shapes")

    batch = _image_batch(cfg, [UNIFORM_HW], np.random.default_rng(13))
    interval = [0, 10]
    probe_activations.probe(model, sae, batch, hook, interval, skip_bos=True)  # warm-up
    (feats, acts, mean), probe_ms, launches = _timed_core(
        lambda: probe_activations.probe(model, sae, batch, hook, interval, skip_bos=True))
    _expect_launches(launches, {"flash_attention": 25, "sae_encode": 1}, "the image probe's core")
    hidden = model.capture(batch, [hook])[hook][0, 1:]
    if acts.shape != (10, hidden.shape[0]) or not np.isfinite(acts).all():
        raise AssertionError(f"image probe columns of shape {acts.shape}, or not finite")
    probe_check = _probe_against_float64(feats, acts, mean, hidden, sae, interval[1], "the image probe")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del hidden
    gc.collect()
    torch.cuda.empty_cache()
    emit({
        "phase": "image_tools_path",
        "subject": "llama3-llava-next-8b widths (CLIP-L/336, projector, 32 text layers, LM head), bf16, flash attention",
        "create_filters_from_attribution": {"features": int(maps[hook].shape[0]), "tokens": int(maps[hook].shape[1]),
                                            "top_k": TOOLS_FILTERS_TOP_K, "ms": filters_ms, "filters": filters[hook],
                                            "float64_check": filters_check},
        "probe_activations": {"image": list(UNIFORM_HW), "tokens": int(batch["input_ids"].shape[1]),
                              "interval": interval, "ms": probe_ms, "float64_check": probe_check},
        "launches": {"probe_activations": _tool_launches(launches), "create_filters_from_attribution": {}},
        "peak_gb": peak_gb, "card": card,
    })
    return {"launches": launches, "ms": {"create_filters_from_attribution": filters_ms, "probe_activations": probe_ms},
            "peak_gb": peak_gb}


# ---- multi-process phases: ranks as subprocesses of this script --------------------

DP_WORLD = 2
DP_GROUP_TIMEOUT_S = 600
DP_PROC_TIMEOUT_S = 600
# Every collective of a rank's process group, and each rank process, is
# bounded: a rank that fails or hangs ends the phase with an error.
DP_TRAIN_LAYERS, DP_TRAIN_HOOK = 4, "layers.3"
DP_TRAIN_ROWS, DP_TRAIN_BATCHES = 1, 2
# dp_train_path: the subject cut to 4 layers and 1 x 2,048 ids a rank a
# batch so that two full-width trainers with AuxK fit on one card beside
# each other with room to spare (train_path's one trainer at 8 x 2,048
# peaks at 61.3 GB with 25 layers, 74.7 GB with AuxK; at 2 x 2,048 a rank
# the card held 77.0 GB in all, nvidia-smi); 2 batches, one optimizer
# step, here and in module_sharded_train_path, since each step's 4.3 GB
# gradient all-reduce through the host takes 5-7 s of the script's time.
DP_TRAIN_UPDATE_REL = 1e-2
# The data-parallel run's parameters against the solo run's on the same
# global batches, per tensor: ||dp - solo|| <= 1e-2 * ||solo - init||.
# Each rank's subject runs 2 rows where the solo run's runs 4, so cuBLAS
# may sum the bf16 hidden states in another order, and the gradients are
# summed across ranks where the solo run sums them in one product: fp32
# noise, which Adam's first step (about lr * sign(g)) turns into a whole
# step of 2 * lr on elements whose gradient is within that noise of 0.
NCCL_LAYERS, NCCL_HOOK = 2, "layers.1"


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class CardMemorySampler:
    """The card's used memory from `nvidia-smi` every 0.5 s, in a thread;
    `stop()` returns the largest reading in GB (every process on the card)."""

    def __init__(self):
        self.peak_mib, self._stop = 0, threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits", "-i", "0"],
                                 capture_output=True, text=True, timeout=30).stdout.strip()
            if out:
                self.peak_mib = max(self.peak_mib, int(out.splitlines()[0]))
            self._stop.wait(0.5)

    def stop(self) -> float:
        self._stop.set()
        self._thread.join(timeout=60)
        return self.peak_mib * 2**20 / 1e9


def spawn_ranks(phase: str, args: dict, world: int) -> tuple:
    """Run `world` ranks of `phase` (this script with `--rank`), each with
    torchrun's environment, all on card 0; returns (each rank's result, in
    rank order; the card's peak used memory in GB).  A rank that fails or
    outlives DP_PROC_TIMEOUT_S raises, every rank killed."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", phase, json.dumps(args)],
                                      env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    sampler = CardMemorySampler()
    deadline = time.monotonic() + DP_PROC_TIMEOUT_S
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                outs.append(p.communicate()[0] + "\n<TIMEOUT>")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        peak_gb = sampler.stop()
    if any(p.returncode for p in procs):
        raise AssertionError(f"{phase}: " + "\n".join(f"--- rank {i} (rc={p.returncode}) ---\n{o[-3000:]}"
                                                      for i, (p, o) in enumerate(zip(procs, outs))))
    results = [json.loads(line[len("RANK_RESULT "):]) for out in outs for line in out.splitlines()
               if line.startswith("RANK_RESULT ")]
    if [r["rank"] for r in results] != list(range(world)):
        raise AssertionError(f"{phase}: rank results {results}")
    return results, peak_gb


def _dirs_byte_equal(a: str, b: str) -> int:
    """Raise unless directories `a` and `b` hold the same files with the
    same bytes; returns the file count."""
    import filecmp

    files = sorted(os.listdir(a))
    if files != sorted(os.listdir(b)):
        raise AssertionError(f"{a} and {b} hold different files")
    _, mismatch, errors = filecmp.cmpfiles(a, b, files, shallow=False)
    if mismatch or errors:
        raise AssertionError(f"{len(mismatch) + len(errors)} files differ between {a} and {b}: {(mismatch + errors)[:3]}")
    return len(files)


def rank_dp_cache(args: dict) -> dict:
    """One rank of dp_cache_path: the cache CLI's flow (`run_cache`) on
    cache_path's subject, SAE and rows, this rank's contiguous shard."""
    from multimodal_sae_tpu_torch.config import CacheConfig
    from multimodal_sae_tpu_torch.interp_utils import load_saes
    from multimodal_sae_tpu_torch.launch.cache.cache import run_cache
    from multimodal_sae_tpu_torch.launch.utils import shard_info
    from multimodal_sae_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from multimodal_sae_tpu_torch.ops import top_k
    from multimodal_sae_tpu_torch.parallel import shard_dataset_contiguous
    from multimodal_sae_tpu_torch.sae import pre_acts

    dev = torch.device("cuda")
    rank, world = shard_info()
    hook, batch_size, ctx_len = "layers.24", 8, 2048
    cfg = LlamaConfig(num_hidden_layers=25, flash_attention=True)
    model = LlamaModel.random(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    saes = load_saes(args["sae_dir"], device=dev)
    rows = cache_rows(cfg.vocab_size, args["rows"], ctx_len)
    shard, _ = shard_dataset_contiguous(rows, world, rank)
    # Warm-up (cuBLAS handles, allocator) outside the counted run.
    h = model.capture({"input_ids": np.stack([r["input_ids"] for r in shard[:batch_size]])}, [hook])[hook]
    top_k(pre_acts(saes[hook].params, h.reshape(-1, h.shape[-1])), saes[hook].cfg.k, assume_finite=True)
    del h
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gc.collect()
    reset_kernel_counts()
    seconds = run_cache(CacheConfig(save_dir=args["save_dir"], batch_size=batch_size, ctx_len=ctx_len,
                                    n_splits=args["n_splits"]),
                        lambda b: model.capture(b, [hook]), saes, rows)
    tokens = len(shard) * ctx_len
    return {"rank": rank, "rows": len(shard), "tokens": tokens, "tokens_per_s": tokens / seconds["run"],
            "seconds": seconds, "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": kernel_counts()}


def phase_dp_cache_path(card: str, work_dir: str, cache: dict) -> dict:
    """The cache CLI's flow as two ranks sharing the card (gloo: NCCL
    refuses two ranks on one device), each caching its contiguous half of
    cache_path's rows with cache_path's subject and SAE; the merged splits
    and sidecars must equal cache_path's byte for byte."""
    t0 = time.perf_counter()
    save_dir = os.path.join(work_dir, "dp_cache")
    n_rows = cache["rows"]
    results, card_peak_gb = spawn_ranks("dp_cache", {"sae_dir": cache["sae_dir"], "save_dir": save_dir,
                                                     "rows": n_rows, "n_splits": cache["n_splits"]}, DP_WORLD)
    n_files = _dirs_byte_equal(os.path.join(save_dir, cache["hook"]), os.path.join(cache["cache_dir"], cache["hook"]))
    batches = n_rows // 8 // DP_WORLD
    expected = {"block_max": 2 * batches, "flash_attention": 25 * batches, "flash_attention_bwd_delta": 0,
                "flash_attention_bwd_dkdv": 0, "flash_attention_bwd_dq": 0, "gather_rows": 0, "splice_decode": 0,
                "decode_dvals": 0, "sae_encode": batches}
    for r in results:
        if r["launches"] != expected:
            raise AssertionError(f"rank {r['rank']} launched {r['launches']}, expected {expected}")
    line = {
        "phase": "dp_cache_path", "world": DP_WORLD, "backend": "gloo (two ranks on one card)",
        "subject": "LLaMA-3-8B widths, 25 layers, bf16, flash attention", "sae": "4096 -> 131072 latents, k=256, fp32",
        "rows": n_rows, "batch_size": 8, "ctx_len": 2048, "splits_byte_equal_cache_path": n_files,
        "ranks": [{key: r[key] for key in ("rank", "rows", "tokens", "tokens_per_s", "peak_gb", "launches")}
                  | {"barrier_wait_s": {"save": r["seconds"]["barrier_save"], "merge": r["seconds"]["barrier_merge"]},
                     "run_s": r["seconds"]["run"], "save_s": r["seconds"]["save"]} for r in results],
        "merge_s": results[0]["seconds"]["merge"], "card_peak_gb_nvidia_smi": card_peak_gb,
        "seconds": time.perf_counter() - t0, "card": card,
    }
    emit(line)
    return {"launches": {name: sum(r["launches"][name] for r in results) for name in expected},
            "per_rank": [r["launches"] for r in results]}


DP_TRAIN_N_ROWS = DP_WORLD * DP_TRAIN_ROWS * DP_TRAIN_BATCHES


def _dp_train_rows(vocab: int, n: int) -> list:
    """The training phases' first `n` rows of 2,048 seeded ids; a phase that
    takes fewer rows gets a prefix of a longer call's."""
    rng = np.random.default_rng(3)
    return [{"input_ids": rng.integers(0, vocab, size=2048)} for _ in range(n)]


def _dp_train_config(batch_size: int, run_name: str):
    from multimodal_sae_tpu_torch.config import SaeConfig, TrainConfig

    return TrainConfig(sae=SaeConfig(num_latents=131072, k=256), batch_size=batch_size, grad_acc_steps=2,
                       micro_acc_steps=1, lr_warmup_steps=0, auxk_alpha=1 / 32, dead_feature_threshold=0,
                       log_to_wandb=False, hookpoints=[DP_TRAIN_HOOK], save_every=10**9, run_name=run_name)


def rank_dp_train(args: dict) -> dict:
    """One rank of dp_train_path: `SaeTrainer` on this rank's contiguous
    shard of the rows (as the training CLI shards them), step by step, then
    `save` (rank 0 writes between barriers)."""
    from multimodal_sae_tpu_torch.launch.utils import shard_info
    from multimodal_sae_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from multimodal_sae_tpu_torch.parallel import shard_dataset_contiguous
    from multimodal_sae_tpu_torch.train import SaeTrainer
    from multimodal_sae_tpu_torch.train.trainer import _iter_batches

    dev = torch.device("cuda")
    rank, world = shard_info()
    cfg = LlamaConfig(num_hidden_layers=DP_TRAIN_LAYERS, flash_attention=True)
    model = LlamaModel.random(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    shard, _ = shard_dataset_contiguous(_dp_train_rows(cfg.vocab_size, DP_TRAIN_N_ROWS), world, rank)
    t0 = time.perf_counter()
    trainer = SaeTrainer(_dp_train_config(DP_TRAIN_ROWS, args["run_dir"]), shard, model, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    gc.collect()
    reset_kernel_counts()
    steps = []
    for i, batch in enumerate(_iter_batches(shard, DP_TRAIN_ROWS)):
        if i == 1:
            torch.cuda.synchronize()
            t_steady = time.perf_counter()
        marks = StageMarks()
        trainer.step(batch, mark=marks)
        steps.append(marks.ms())
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t_steady
    launches = kernel_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    trainer.save()
    save_s = time.perf_counter() - t0
    hook = DP_TRAIN_HOOK
    return {"rank": rank, "tokens_per_s": (len(steps) - 1) * DP_TRAIN_ROWS * 2048 / steady_s,
            "all_reduce_ms": [round(m["all_reduce"], 3) for m in steps],
            "step_ms": [round(m["total"], 3) for m in steps], "peak_gb": peak_gb, "launches": launches,
            "init_s": init_s, "save_s": save_s,
            "unfired_in_last_window": int((trainer.num_tokens_since_fired[hook] > 0).sum())}


def _update_rel(got: dict, want: dict, init: dict, dev) -> tuple:
    """Per tensor, ||got - want|| / ||want - init|| and max |got - want|:
    the fp32 differences taken on the card, their norms summed in float64
    there (`want` and `init` on the host while the ranks hold the card)."""
    rel, max_abs = {}, {}
    for name, w in want.items():
        w = w.to(dev)
        step = torch.linalg.vector_norm((w - init[name].to(dev)).double()).item()
        diff = got[name].to(dev) - w
        rel[name] = torch.linalg.vector_norm(diff.double()).item() / max(step, 1e-30)
        max_abs[name] = diff.abs().max().item()
        del w, diff
    return rel, max_abs


def phase_dp_train_path(dev, card: str, work_dir: str) -> dict:
    """Data-parallel `SaeTrainer` as two ranks sharing the card (gloo), at
    the SAE's full width with AuxK, against one trainer in this process on
    the same global batches (each rank's rows in turn, JAX
    tests/test_multiprocess.py:178-185): the parameters within
    DP_TRAIN_UPDATE_REL, `opt_step` equal, and the dead-feature counters
    equal once the ranks' (each counts its own ids) are doubled."""
    from multimodal_sae_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from multimodal_sae_tpu_torch.sae import Sae
    from multimodal_sae_tpu_torch.train import SaeTrainer
    from multimodal_sae_tpu_torch.train.trainer import _iter_batches
    from multimodal_sae_tpu_torch.utils.safetensors_io import load_file

    t_phase = time.perf_counter()
    hook, B, n = DP_TRAIN_HOOK, DP_TRAIN_ROWS, DP_TRAIN_BATCHES
    cfg = LlamaConfig(num_hidden_layers=DP_TRAIN_LAYERS, flash_attention=True)
    model = LlamaModel.random(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    rows = _dp_train_rows(cfg.vocab_size, DP_TRAIN_N_ROWS)
    order = [r * B * n + s * B + i for s in range(n) for r in range(DP_WORLD) for i in range(B)]
    solo_rows = [rows[j] for j in order]
    trainer = SaeTrainer(_dp_train_config(DP_WORLD * B, os.path.join(work_dir, "solo_run")), solo_rows, model,
                         device=dev)
    init = {name: t.detach().cpu().clone() for name, t in trainer.saes[hook].params.items()}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for batch in _iter_batches(solo_rows, DP_WORLD * B):
        trainer.step(batch)
    torch.cuda.synchronize()
    solo_s = time.perf_counter() - t0
    solo = {name: t.detach().cpu() for name, t in trainer.saes[hook].params.items()}
    solo_counts, solo_opt_step = trainer.num_tokens_since_fired[hook].copy(), trainer.opt_step
    solo_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del trainer, model
    gc.collect()
    torch.cuda.empty_cache()

    run_dir = os.path.join(work_dir, "dp_run")
    results, card_peak_gb = spawn_ranks("dp_train", {"run_dir": run_dir}, DP_WORLD)
    dp = Sae.load_from_disk(os.path.join(run_dir, hook), device=dev).params
    with open(os.path.join(run_dir, "state.json")) as f:
        state = json.load(f)
    counts = load_file(os.path.join(run_dir, "state.safetensors"))[f"num_tokens_since_fired/{hook}"].numpy()
    rel, max_abs = _update_rel(dp, solo, init, dev)
    del dp
    if not all(v <= DP_TRAIN_UPDATE_REL for v in rel.values()):
        raise AssertionError(f"data-parallel parameters off the solo run's: {rel}")
    if state["opt_step"] != solo_opt_step or state["global_step"] != n:
        raise AssertionError(f"steps {state} against solo opt_step {solo_opt_step}")
    counters_equal = bool(np.array_equal(counts * DP_WORLD, solo_counts))
    if not counters_equal:
        raise AssertionError(f"dead-feature counters differ at {int((counts * DP_WORLD != solo_counts).sum())} latents")
    expected = {"block_max": 2 * n, "flash_attention": DP_TRAIN_LAYERS * n}
    for r in results:
        if {k: r["launches"][k] for k in expected} != expected:
            raise AssertionError(f"rank {r['rank']} launched {r['launches']}, expected {expected}")
    emit({
        "phase": "dp_train_path", "world": DP_WORLD, "backend": "gloo (two ranks on one card; CUDA tensors "
        "staged through the host)", "subject": f"LLaMA-3-8B widths cut to {DP_TRAIN_LAYERS} layers, bf16, flash "
        f"attention, {hook}", "sae": "4096 -> 131072 latents, k=256, fp32, AuxK 1/32, dead threshold 0",
        "rows_a_rank_a_batch": B, "ctx_len": 2048, "batches": n, "grad_acc_steps": 2,
        "update_rel_l2": rel, "update_rel_bound": DP_TRAIN_UPDATE_REL, "max_abs_diff": max_abs,
        "opt_step": state["opt_step"], "counters_equal_doubled": counters_equal,
        "ranks": results, "card_peak_gb_nvidia_smi": card_peak_gb,
        "solo": {"tokens_per_s": n * DP_WORLD * B * 2048 / solo_s, "peak_gb": solo_peak_gb},
        "seconds": time.perf_counter() - t_phase, "card": card,
    })
    names = tuple(_counted_modules())
    return {"launches": {name: sum(r["launches"][name] for r in results) for name in names},
            "per_rank": [r["launches"] for r in results]}


def rank_nccl(args: dict) -> dict:
    """nccl_path's process, under torchrun's environment for one rank:
    the cache flow before any group is up, then `initialize_distributed()`
    brings NCCL up on the card and the flow runs again; one all_reduce and
    one barrier on the NCCL group."""
    import torch.distributed as dist

    from multimodal_sae_tpu_torch.config import CacheConfig
    from multimodal_sae_tpu_torch.device import setup
    from multimodal_sae_tpu_torch.interp_utils import load_saes
    from multimodal_sae_tpu_torch.launch.cache.cache import run_cache
    from multimodal_sae_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from multimodal_sae_tpu_torch.parallel import all_gather_objects, barrier, initialize_distributed

    dev = setup(None)
    cfg = LlamaConfig(num_hidden_layers=NCCL_LAYERS, flash_attention=True)
    model = LlamaModel.random(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    saes = load_saes(args["sae_dir"], device=dev)
    rows = cache_rows(cfg.vocab_size, 8, 2048, seed=5)

    def flow(save_dir):
        return run_cache(CacheConfig(save_dir=save_dir, batch_size=4, ctx_len=2048, n_splits=16),
                         lambda b: model.capture(b, [NCCL_HOOK]), saes, rows)

    if dist.is_initialized():
        raise AssertionError("a process group is up before initialize_distributed")
    solo = flow(os.path.join(args["work_dir"], "solo"))
    t0 = time.perf_counter()
    if not initialize_distributed(timeout=300) or dist.get_backend() != "nccl":
        raise AssertionError("initialize_distributed did not bring NCCL up")
    bring_up_s = time.perf_counter() - t0
    reset_kernel_counts()
    seconds = flow(os.path.join(args["work_dir"], "nccl"))
    launches = kernel_counts()
    x = torch.full((1 << 20,), 2.0, device=dev)
    dist.all_reduce(x)
    dist.barrier()
    barrier("nccl_path")
    if not bool((x == 2.0).all()) or all_gather_objects("x") != ["x"]:
        raise AssertionError("the world-1 NCCL collectives changed their inputs")
    dist.destroy_process_group()
    return {"rank": 0, "backend": "nccl", "bring_up_s": bring_up_s, "seconds": seconds, "solo_seconds": solo,
            "launches": launches}


def phase_nccl_path(card: str, work_dir: str, cache: dict) -> dict:
    """One process under torchrun's environment for world 1: the cache flow
    on NCCL against the same flow with no group (2 layers, hookpoint
    layers.1, cache_path's SAE), byte for byte."""
    t0 = time.perf_counter()
    sae_dir = os.path.join(work_dir, "saes_layers_1")
    os.makedirs(sae_dir, exist_ok=True)
    os.symlink(os.path.join(cache["sae_dir"], cache["hook"]), os.path.join(sae_dir, NCCL_HOOK))
    nccl_dir = os.path.join(work_dir, "nccl_path")
    (result,), _ = spawn_ranks("nccl", {"sae_dir": sae_dir, "work_dir": nccl_dir}, 1)
    n_files = _dirs_byte_equal(os.path.join(nccl_dir, "nccl", NCCL_HOOK), os.path.join(nccl_dir, "solo", NCCL_HOOK))
    expected = {"block_max": 4, "flash_attention": 2 * NCCL_LAYERS, "sae_encode": 2}
    if {k: result["launches"][k] for k in expected} != expected:
        raise AssertionError(f"nccl_path launched {result['launches']}, expected {expected}")
    emit({"phase": "nccl_path", "world": 1, "backend": result["backend"], "layers": NCCL_LAYERS, "hookpoint": NCCL_HOOK,
          "rows": 8, "ctx_len": 2048, "splits_byte_equal_solo": n_files, "bring_up_s": result["bring_up_s"],
          "flow_seconds": result["seconds"], "launches": result["launches"], "all_reduce_and_barrier": True,
          "seconds": time.perf_counter() - t0, "card": card})
    return {"launches": result["launches"], "per_rank": [result["launches"]]}


# ---- int8 quantisation (models/quant.py) and module sharding ---------------------

W8A16_REL = 2.0**-7
# A W8A16 product (bf16 activations, int8 weights cast to bf16, fp32 sums,
# the scale, a bf16 output) against the fp32 product of the same
# activations and the dequantised weight with TF32 off: max |diff| <=
# 2^-7 * max |fp32|.  The output's bf16 rounding is at most 2^-8 of each
# value; the fp32 sums of exact products differ only in their order.
QBWD_REL = 2.0**-7
# The quantised products' backward, dx = (g * scale) @ q8 with bf16
# operands and fp32 sums, returned in the activations' dtype (bf16), against
# the fp32 product of the same bf16-rounded g * scale and q8 with TF32 off:
# max |diff| <= 2^-7 * max |fp32|.  The products are exact on both sides and
# the sums differ only in their order; the bf16 result is within 2^-8 of
# each value.
INT8_CACHE_BATCHES, INT8_CACHE_SPLITS = 2, 16
INT8_GENERATE_NEW, INT8_PROMPT = 16, 74


def _cpu_quantized_equal(card_leaf: dict, host_dense: torch.Tensor, dim: int) -> bool:
    """A leaf quantised on the card against the same dense weight quantised
    on the host: q8 and scale equal bit for bit."""
    from multimodal_sae_tpu_torch.models.quant import quantize_weight

    want = quantize_weight(host_dense, dim=dim)
    return (torch.equal(card_leaf["q8"].cpu(), want["q8"])
            and torch.equal(card_leaf["scale"].cpu().view(torch.int32), want["scale"].view(torch.int32)))


def check_qmatmul(x: torch.Tensor, w: dict) -> dict:
    """Both quantised products at one layer's shapes against their plain
    versions on the card: W8A8's int32 sums equal to a float64 product of
    the same int8 operands (exact: |sum| < 2^53), at the layer's rows and at
    padded ones (1, 16 and 64 decode rows; k = 588 of CLIP-L/336's patch
    embedding); W8A16 within W8A16_REL of the fp32 product with the
    dequantised weight; both modes' backward within QBWD_REL of its plain
    version.  Each forward timed beside the bf16 product with the
    dequantised weight."""
    import torch.nn.functional as F

    from multimodal_sae_tpu_torch.models.quant import dequantize_weight, int8_mm, qmatmul, quantize_rows

    def exact(xq, q8):
        got = int8_mm(xq, q8)
        plain = (xq.double() @ q8.double().t()).to(torch.int64)
        if got.dtype != torch.int32 or not torch.equal(got.to(torch.int64), plain):
            raise AssertionError(f"W8A8 int32 sums differ from the plain product at {tuple(xq.shape)} x "
                                 f"{tuple(q8.shape)}")
        return tuple(xq.shape), tuple(q8.shape)

    xq, _ = quantize_rows(x)
    shapes = [exact(xq, w["q8"])] + [exact(xq[:m], w["q8"]) for m in (1, 16, 64)]
    gen = torch.Generator(device=x.device).manual_seed(5)
    patch_w = {"q8": torch.randint(-127, 128, (1024, 588), generator=gen, device=x.device, dtype=torch.int8)}
    patch_x = torch.randint(-127, 128, (3, 588), generator=gen, device=x.device, dtype=torch.int8)
    shapes.append(exact(patch_x, patch_w["q8"]))
    out = qmatmul(x, w)
    ref = x.float() @ dequantize_weight(w).t()
    rel = ((out.float() - ref).abs().max() / ref.abs().max()).item()
    if not rel <= W8A16_REL:
        raise AssertionError(f"W8A16 off the fp32 product by {rel} of its largest value")
    del out, ref
    bwd_rel = {}
    g = torch.randn((x.shape[0], w["q8"].shape[0]), generator=gen, device=x.device).to(x.dtype)
    for mode, int8 in (("w8a8", True), ("w8a16", False)):
        xg = x.detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(qmatmul(xg, w, int8=int8), xg, g)
        plain = (g.float() * w["scale"]).to(torch.bfloat16).float() @ w["q8"].float()
        bwd_rel[mode] = ((grad.float() - plain).abs().max() / plain.abs().max()).item()
        if not bwd_rel[mode] <= QBWD_REL:
            raise AssertionError(f"{mode} backward off its plain version by {bwd_rel[mode]} of its largest value")
        del grad, plain
    dense = dequantize_weight(w, dtype=torch.bfloat16)
    M, K = x.shape
    N = w["q8"].shape[0]
    return {"x": [M, K], "w": [N, K], "w8a8_exact_shapes": shapes, "w8a16_max_rel": rel,
            "w8a16_rel_bound": W8A16_REL, "backward_max_rel": bwd_rel, "backward_rel_bound": QBWD_REL,
            "ms": {"w8a8": time_ms(lambda: qmatmul(x, w, int8=True)), "w8a16": time_ms(lambda: qmatmul(x, w)),
                   "bf16": time_ms(lambda: F.linear(x, dense)), "int_mm_only": time_ms(lambda: int8_mm(xq, w["q8"]))},
            "bound_ms": {"int8": 2 * M * K * N / INT8_OPS * 1e3, "bf16": 2 * M * K * N / BF16_FLOPS * 1e3}}


def _split_keys(module_dir: str, rows: int, ctx_len: int, width: int) -> np.ndarray:
    """The (row, position, feature) triples of a merged cache's rows below
    `rows`, as sorted int64 keys."""
    locs, _ = check_splits(module_dir, len([f for f in os.listdir(module_dir) if f.endswith(".safetensors")]), width)
    locs = locs[locs[:, 0] < rows].astype(np.int64)
    return np.sort((locs[:, 0] * ctx_len + locs[:, 1]) * width + locs[:, 2])


def phase_int8_cache_path(dev, card: str, cache: dict) -> dict:
    """The text cache with an int8 subject: cache_path's subject (25 layers
    at LLaMA-3-8B widths, seed 0) quantised on the card leaf by leaf
    (`quantize_llama_params`), then 2 of cache_path's batches of 8 x 2,048
    ids through `FeatureCache` in three modes: W8A16, W8A8 (`int8_matmul`)
    and W8A8 with the SAE encoder quantised (`load_saes(int8_encoder=True)`,
    the CLI's `--sae_int8`).  Checks: the quantised leaves of layer 0, the
    last layer's o_proj and the embedding equal a host quantisation of the
    same weights bit for bit; `check_qmatmul` at layer 0's gate_proj; the
    splits valid and the launches counted.  Reports the weight bytes,
    tokens/s, the encode's ms and the peak per mode, the hidden state's
    relative error at layers.24 against the bf16 subject and the cached
    entries shared with cache_path's splits (not gated)."""
    from multimodal_sae_tpu_torch.features import FeatureCache
    from multimodal_sae_tpu_torch.interp_utils import load_saes
    from multimodal_sae_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from multimodal_sae_tpu_torch.models.quant import LLAMA_QUANT_KEYS, leaf_bytes, quantize_llama_params
    from multimodal_sae_tpu_torch.ops import top_k
    from multimodal_sae_tpu_torch.sae import pre_acts

    t_phase = time.perf_counter()
    hook, batch_size, ctx_len, width = cache["hook"], 8, 2048, 131072
    n_rows = INT8_CACHE_BATCHES * batch_size
    cfg = LlamaConfig(num_hidden_layers=25, flash_attention=True)
    model = LlamaModel.random(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    rows = [{"input_ids": ids} for ids in cache["tokens"][:n_rows]]
    batch0 = {"input_ids": np.stack([r["input_ids"] for r in rows[:batch_size]])}
    h_bf16 = model.capture(batch0, [hook])[hook]
    bytes_bf16 = leaf_bytes(model.params)
    host = {"embed_tokens": model.params["embed_tokens"].cpu(), "layers.24.o_proj": model.params["layers"][24]["o_proj"].cpu(),
            **{f"layers.0.{k}": t.cpu() for k, t in model.params["layers"][0].items() if k in LLAMA_QUANT_KEYS}}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    quantize_llama_params(model.params)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    bytes_int8 = leaf_bytes(model.params)
    layers = model.params["layers"]
    card_leaf = {"embed_tokens": model.params["embed_tokens"], "layers.24.o_proj": layers[24]["o_proj"],
                 **{f"layers.0.{k}": layers[0][k] for k in LLAMA_QUANT_KEYS if k in layers[0]}}
    unequal = [name for name, t in host.items()
               if not _cpu_quantized_equal(card_leaf[name], t, dim=0 if name == "embed_tokens" else 1)]
    if unequal:
        raise AssertionError(f"leaves quantised on the card differ from the host's: {unequal}")
    del host
    x0 = model.capture(batch0, ["layers.0"])["layers.0"].reshape(-1, cfg.hidden_size)
    products = check_qmatmul(x0, layers[0]["gate_proj"])
    del x0
    torch.cuda.empty_cache()

    base_keys = _split_keys(os.path.join(cache["cache_dir"], hook), n_rows, ctx_len, width)
    modes = {}
    launches_total = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_int8_") as tmp:
        for mode, int8_matmul, sae_int8 in (("w8a16", False, False), ("w8a8", True, False),
                                           ("w8a8_sae_int8", True, True)):
            model.cfg = dataclasses.replace(cfg, int8_matmul=int8_matmul)
            saes = load_saes(cache["sae_dir"], device=dev, int8_encoder=sae_int8)
            sae = saes[hook]
            h = model.capture(batch0, [hook])[hook]  # warm-up, then the stages of batch 0
            top_k(pre_acts(sae.params, h.reshape(-1, h.shape[-1])), sae.cfg.k, assume_finite=True)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            h = model.capture(batch0, [hook])[hook]
            ev[1].record()
            latents = pre_acts(sae.params, h.reshape(-1, h.shape[-1]))
            ev[2].record()
            top_k(latents, sae.cfg.k, assume_finite=True)
            ev[3].record()
            torch.cuda.synchronize()
            hidden_rel = (torch.linalg.vector_norm((h - h_bf16).float())
                          / torch.linalg.vector_norm(h_bf16.float())).item()
            del h, latents
            save_dir = os.path.join(tmp, mode)
            fc = FeatureCache(lambda b: model.capture(b, [hook]), saes, batch_size=batch_size)
            fc.enable_streaming(save_dir, n_splits=INT8_CACHE_SPLITS)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            gc.collect()
            reset_kernel_counts()
            t0 = time.perf_counter()
            fc.run(ctx_len, rows, progress=False)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches = kernel_counts()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            # The int8 encoder runs its W8A8 product, not the split kernel.
            expected = {"block_max": 2 * INT8_CACHE_BATCHES, "flash_attention": 25 * INT8_CACHE_BATCHES,
                        "sae_encode": 0 if sae_int8 else INT8_CACHE_BATCHES}
            if {k: launches[k] for k in expected} != expected or sum(launches.values()) != sum(expected.values()):
                raise AssertionError(f"{mode}: launches {launches}, expected {expected}")
            for name, n in launches.items():
                launches_total[name] = launches_total.get(name, 0) + n
            fc.save_splits(INT8_CACHE_SPLITS, save_dir)
            fc.concate_safetensors(INT8_CACHE_SPLITS, save_dir)
            keys = _split_keys(os.path.join(save_dir, hook), n_rows, ctx_len, width)
            modes[mode] = {
                "tokens_per_s": n_rows * ctx_len / run_s, "run_s": run_s, "peak_gb": peak_gb,
                "stage_ms_batch0": {"subject_forward": ev[0].elapsed_time(ev[1]), "encode": ev[1].elapsed_time(ev[2]),
                                    "top_k": ev[2].elapsed_time(ev[3])},
                "hidden_rel_l2_vs_bf16": hidden_rel, "entries": len(keys),
                "entries_shared_with_cache_path": float(len(np.intersect1d(keys, base_keys, assume_unique=True))
                                                        / len(base_keys)),
                "launches": launches,
            }
            del fc, saes, sae
            gc.collect()
            torch.cuda.empty_cache()
    emit({
        "phase": "int8_cache_path", "subject": "LLaMA-3-8B widths, 25 layers, quantised on the card (int8 "
        "projections, LM head and embedding; bf16 norms), flash attention", "hookpoint": hook,
        "sae": "4096 -> 131072 latents, k=256 (fp32, or its encoder int8 in w8a8_sae_int8)",
        "batches": INT8_CACHE_BATCHES, "batch_size": batch_size, "ctx_len": ctx_len,
        "weight_bytes": {"bf16": bytes_bf16, "int8": bytes_int8}, "quantize_s": quantize_s,
        "host_quantisation_equal": sorted(card_leaf), "products": products, "modes": modes,
        "seconds": time.perf_counter() - t_phase, "card": card,
    })
    return {"launches": launches_total}


def phase_int8_subject_path(dev, card: str) -> dict:
    """The whole subject in int8: the attribution phase's subject (32 layers
    and the LM head at LLaMA-3-8B widths, seed 0) and SAE (layers.24,
    131,072 latents, k = 256, seed 0), first in bf16 and then quantised on
    the card with W8A8 products: one `fast_attribution_maps` call on the
    2,432-token prompt (16 features at feature_batch 8: K2's splice and K3's
    backward through the straight-through products) and a 16-token greedy
    generate at batch 1 (its decode steps take the padded `_int_mm` rows).
    Checks the launches, finite saliency and tokens in the vocabulary;
    reports features/s, the peak, the subject's bytes, each feature's
    saliency correlation with the bf16 subject's and the tokens both
    generate alike (not gated)."""
    from functools import partial

    from multimodal_sae_tpu_torch.config import SaeConfig
    from multimodal_sae_tpu_torch.features.patching import build_fast_attribution, fast_attribution_maps, get_logit_diff
    from multimodal_sae_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from multimodal_sae_tpu_torch.models.quant import leaf_bytes, quantize_llama_params
    from multimodal_sae_tpu_torch.sae import Sae

    t_phase = time.perf_counter()
    hook, S, fb, width, n_suffix = "layers.24", 2432, 8, 131072, 32 - 25
    cfg = LlamaConfig(flash_attention=True)
    model = LlamaModel.random(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    sae = Sae(4096, SaeConfig(num_latents=width, k=256), decoder=True, seed=0, device=dev)
    rng = np.random.default_rng(1)
    batch = {"input_ids": rng.integers(0, cfg.vocab_size, size=(1, S))}
    metric = partial(get_logit_diff, answer_token_indices=torch.tensor([[1000, 2000]], device=dev))
    step = build_fast_attribution(model, hook, sae, batch, metric)
    inside = step.wide_idx[-1, :8].long().tolist()
    in_pool = torch.zeros(width, dtype=torch.bool, device=dev)
    in_pool[step.wide_idx.long().reshape(-1)] = True
    outside = sorted(rng.choice(torch.nonzero(~in_pool).squeeze(1).cpu().numpy(), size=8, replace=False).tolist())
    feats = inside + outside
    del step, in_pool
    prompt = {"input_ids": rng.integers(0, cfg.vocab_size, size=(1, INT8_PROMPT))}

    def attribute():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        gc.collect()
        reset_kernel_counts()
        t0 = time.perf_counter()
        out = fast_attribution_maps(model, hook, sae, batch, metric, feats, feature_batch=fb, progress=False)
        torch.cuda.synchronize()
        return _saliency(out, hook), time.perf_counter() - t0, kernel_counts(), torch.cuda.max_memory_allocated() / 1e9

    sal_bf16, bf16_s, _, bf16_peak = attribute()
    gen_bf16, _ = _timed_generate(model, prompt, None, INT8_GENERATE_NEW)
    bytes_bf16 = leaf_bytes(model.params)
    t0 = time.perf_counter()
    quantize_llama_params(model.params)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    model.cfg = dataclasses.replace(cfg, int8_matmul=True)
    bytes_int8 = leaf_bytes(model.params)
    attribute()  # warm-up of the int8 products
    sal, run_s, launches, peak_gb = attribute()
    chunks = len(feats) // fb
    expected = {"block_max": 2, "flash_attention": 25 + n_suffix * chunks,
                "flash_attention_bwd_delta": n_suffix * chunks, "flash_attention_bwd_dkdv": n_suffix * chunks,
                "flash_attention_bwd_dq": n_suffix * chunks, "gather_rows": 1, "splice_decode": chunks,
                "decode_dvals": 0, "sae_encode": 1}
    if launches != expected:
        raise AssertionError(f"int8 attribution launches {launches}, expected {expected}")
    if sal.shape != (len(feats), 1, S) or not np.any(sal[:8] != 0):
        raise AssertionError(f"int8 saliency of shape {sal.shape}, in-top-k features all 0: {not np.any(sal[:8])}")
    # The last position dominates each map (its own gradient, not one
    # through attention) and its saliency nets the feature's decoder row
    # against the pool's (k+1)-th, which the quantised hidden state may
    # change: reported apart.
    corr, corr_before_last, last = [], [], []
    for a, b in zip(sal_bf16[:, 0], sal[:, 0]):
        corr.append(float(np.corrcoef(a, b)[0, 1]) if a.any() and b.any() else None)
        corr_before_last.append(float(np.corrcoef(a[:-1], b[:-1])[0, 1]) if a[:-1].any() and b[:-1].any() else None)
        last.append([float(a[-1]), float(b[-1])])
    gen, gen_readings = _timed_generate(model, prompt, None, INT8_GENERATE_NEW)
    tokens = gen[0, INT8_PROMPT:].cpu().numpy()
    if gen.shape != (1, INT8_PROMPT + INT8_GENERATE_NEW) or not ((tokens >= 0) & (tokens < cfg.vocab_size)).all():
        raise AssertionError(f"int8 generate gave {gen.shape}, tokens {tokens}")
    if gen_readings["launches"]["prefill"]["flash_attention"] != 32:
        raise AssertionError(f"int8 prefill launches {gen_readings['launches']}")
    same = gen[0, INT8_PROMPT:] == gen_bf16[0, INT8_PROMPT:]
    gen_launches = {k: gen_readings["launches"]["prefill"][k] + gen_readings["launches"]["decode"][k]
                    for k in launches}
    emit({
        "phase": "int8_subject_path", "subject": "LLaMA-3-8B widths, 32 layers and the LM head, quantised on the "
        "card, W8A8 products (int8_matmul), flash attention", "hookpoint": hook,
        "sae": "4096 -> 131072 latents, k=256, fp32", "prompt_tokens": S, "features": len(feats),
        "feature_batch": fb, "subject_bytes": {"bf16": bytes_bf16, "int8": bytes_int8}, "quantize_s": quantize_s,
        "features_per_s": len(feats) / run_s, "run_s": run_s, "peak_gb": peak_gb,
        "bf16": {"features_per_s": len(feats) / bf16_s, "peak_gb": bf16_peak},
        "saliency_corr_vs_bf16": corr, "saliency_corr_vs_bf16_before_the_last_position": corr_before_last,
        "last_position_saliency_bf16_int8": last, "launches": launches,
        "generate": {**gen_readings, "tokens_equal_to_bf16": int(same.sum()),
                     "leading_tokens_equal_to_bf16": int(torch.cumprod(same.int(), 0).sum())},
        "seconds": time.perf_counter() - t_phase, "card": card,
    })
    return {"launches": {k: launches[k] + gen_launches[k] for k in launches}}


def phase_int8_image_path(dev, card: str) -> dict:
    """The image cache phase's subject (llama3-llava-next-8b widths, text
    cut to 25 layers, seed 0) quantised on the card as `--load_in_8bit`
    quantises it (the language model and the CLIP tower; W8A16), then with
    the tower's products W8A8 (`--int8_vision`: the patch embedding's k =
    588 padded to 592): one batch of 4 images of 480 x 640 each through
    `FeatureImageCache`.  Checks the launches and the splits; reports
    images/s, the tower's ms, the weight bytes and the two modes' hidden
    states' relative difference at model.layers.24."""
    from multimodal_sae_tpu_torch.config import SaeConfig
    from multimodal_sae_tpu_torch.features import FeatureImageCache
    from multimodal_sae_tpu_torch.models.clip_vit import clip_vision_forward
    from multimodal_sae_tpu_torch.models.llama import LlamaConfig
    from multimodal_sae_tpu_torch.models.llava_next import LlavaNextConfig, LlavaNextModel
    from multimodal_sae_tpu_torch.models.quant import leaf_bytes, quantize_clip_params, quantize_llama_params
    from multimodal_sae_tpu_torch.sae import Sae

    t_phase = time.perf_counter()
    hook, batch_size, n_splits = "model.layers.24", 4, 16
    cfg = LlavaNextConfig(text_config=LlamaConfig(vocab_size=128257, num_hidden_layers=25, flash_attention=True))
    model = LlavaNextModel.random(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    bytes_bf16 = leaf_bytes(model.params)
    quantize_llama_params(model.params["language_model"])
    quantize_clip_params(model.params["vision_tower"])
    bytes_int8 = leaf_bytes(model.params)
    saes = {hook: Sae(4096, SaeConfig(num_latents=131072, k=256), decoder=False, seed=0, device=dev)}
    batch = _image_batch(cfg, [UNIFORM_HW] * batch_size, np.random.default_rng(0))
    positions = batch["input_ids"].size
    pixels = torch.from_numpy(np.concatenate(batch["pixel_values"])).to(dev)
    modes, hidden, launches_total = {}, {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_int8_image_") as tmp:
        for mode, vision in (("load_in_8bit", False), ("int8_vision", True)):
            model.cfg = dataclasses.replace(cfg, vision_config=dataclasses.replace(cfg.vision_config,
                                                                                   int8_matmul=vision))
            hidden[mode] = model.capture(batch, [hook])[hook]  # also the warm-up
            tower_ms = time_ms(lambda: clip_vision_forward(model.params["vision_tower"], model.cfg.vision_config,
                                                           pixels, feature_layer=cfg.vision_feature_layer), iters=5)
            save_dir = os.path.join(tmp, mode)
            fc = FeatureImageCache(lambda b: model.capture(b, [hook]), saes, batch_size=batch_size)
            fc.enable_streaming(save_dir, n_splits=n_splits)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            gc.collect()
            reset_kernel_counts()
            t0 = time.perf_counter()
            fc.run(positions, iter([batch]), progress=False)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches = kernel_counts()
            expected = {"block_max": 2, "flash_attention": 25, "sae_encode": 1}
            if {k: launches[k] for k in expected} != expected or sum(launches.values()) != sum(expected.values()):
                raise AssertionError(f"{mode}: launches {launches}, expected {expected}")
            for name, n in launches.items():
                launches_total[name] = launches_total.get(name, 0) + n
            fc.save_splits(n_splits, save_dir)
            fc.concate_safetensors(n_splits, save_dir)
            _, acts = check_splits(os.path.join(save_dir, hook), n_splits, 131072)
            modes[mode] = {"images_per_s": batch_size / run_s, "run_s": run_s, "tower_ms": tower_ms,
                           "tower_crops": int(pixels.shape[0]), "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                           "entries": len(acts), "launches": launches}
            del fc
    a, b = hidden["load_in_8bit"].float(), hidden["int8_vision"].float()
    emit({
        "phase": "int8_image_path", "subject": "llama3-llava-next-8b widths (text cut to 25 layers), quantised on "
        "the card: the language model W8A16, the CLIP-L/336 tower W8A16 then W8A8", "hookpoint": hook,
        "images": batch_size, "image_hw": list(UNIFORM_HW), "positions": positions,
        "weight_bytes": {"bf16": bytes_bf16, "int8": bytes_int8}, "modes": modes,
        "hidden_rel_l2_int8_vision_vs_w8a16_tower": (torch.linalg.vector_norm(b - a)
                                                     / torch.linalg.vector_norm(a)).item(),
        "seconds": time.perf_counter() - t_phase, "card": card,
    })
    return {"launches": launches_total}


MS_LAYERS, MS_HOOKS = 4, ("layers.1", "layers.3")
MS_UPDATE_REL = 1e-2
# module_sharded_train_path: each rank's SAE against the world-1 run's on
# the same global batches, per tensor ||ranks - solo|| <= 1e-2 * ||solo -
# init||.  The ranks' subjects run 1 row where the solo run's runs 2, so
# cuBLAS may sum the bf16 hidden states in another order: fp32 noise, which
# Adam's first step (about lr * sign(g)) turns into a whole step of 2 * lr
# on elements whose gradient is within that noise of 0 (DP_TRAIN_UPDATE_REL's
# reasoning; no gradient crosses ranks here).


def _ms_train_config(batch_size: int, run_name: str):
    from multimodal_sae_tpu_torch.config import SaeConfig, TrainConfig

    return TrainConfig(sae=SaeConfig(num_latents=131072, k=256), batch_size=batch_size, grad_acc_steps=2,
                       micro_acc_steps=1, lr_warmup_steps=0, auxk_alpha=1 / 32, dead_feature_threshold=0,
                       log_to_wandb=False, hookpoints=list(MS_HOOKS), distribute_modules=True, save_every=10**9,
                       run_name=run_name)


def rank_module_train(args: dict) -> dict:
    """One rank of module_sharded_train_path: `SaeTrainer` with
    `distribute_modules` on this rank's contiguous shard of the rows; the
    rank trains its one hookpoint on the global batch that the all-to-all
    brings it, then `save` (each rank its own SAE, rank 0 the shared files)."""
    from multimodal_sae_tpu_torch.launch.utils import shard_info
    from multimodal_sae_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from multimodal_sae_tpu_torch.parallel import shard_dataset_contiguous
    from multimodal_sae_tpu_torch.parallel.collectives import staging_route
    from multimodal_sae_tpu_torch.train import SaeTrainer
    from multimodal_sae_tpu_torch.train.trainer import _iter_batches

    dev = torch.device("cuda")
    rank, world = shard_info()
    cfg = LlamaConfig(num_hidden_layers=MS_LAYERS, flash_attention=True)
    model = LlamaModel.random(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    shard, _ = shard_dataset_contiguous(_dp_train_rows(cfg.vocab_size, DP_TRAIN_N_ROWS), world, rank)
    trainer = SaeTrainer(_ms_train_config(DP_TRAIN_ROWS, args["run_dir"]), shard, model, device=dev)
    torch.cuda.reset_peak_memory_stats()
    gc.collect()
    reset_kernel_counts()
    steps = []
    for i, batch in enumerate(_iter_batches(shard, DP_TRAIN_ROWS)):
        if i == 1:
            torch.cuda.synchronize()
            t_steady = time.perf_counter()
        marks = StageMarks()
        trainer.step(batch, mark=marks)
        steps.append(marks.ms())
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t_steady
    launches = kernel_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    trainer.save()
    return {"rank": rank, "hooks": list(trainer.saes), "route": staging_route(dev),
            "tokens_per_s": (len(steps) - 1) * DP_TRAIN_ROWS * 2048 / steady_s,
            "exchange_ms": [round(m["exchange"], 3) for m in steps], "step_ms": [round(m["total"], 3) for m in steps],
            "peak_gb": peak_gb, "launches": launches, "save_s": time.perf_counter() - t0}


def phase_module_sharded_train_path(dev, card: str, work_dir: str) -> dict:
    """Module-sharded `SaeTrainer` (`distribute_modules`) as two gloo ranks
    sharing the card, one hookpoint each (layers.1 on rank 0, layers.3 on
    rank 1), the full-width SAE with AuxK, against one process training
    both hookpoints with the flag at world 1 on the same global batches:
    each hookpoint's parameters within MS_UPDATE_REL, `opt_step` equal; the
    counters' relation (each rank counts its own ids, so doubled they equal
    the world-1 run's where the fired masks agree) is reported."""
    from multimodal_sae_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from multimodal_sae_tpu_torch.sae import Sae
    from multimodal_sae_tpu_torch.train import SaeTrainer
    from multimodal_sae_tpu_torch.train.trainer import _iter_batches
    from multimodal_sae_tpu_torch.utils.safetensors_io import load_file

    t_phase = time.perf_counter()
    B, n = DP_TRAIN_ROWS, DP_TRAIN_BATCHES
    cfg = LlamaConfig(num_hidden_layers=MS_LAYERS, flash_attention=True)
    model = LlamaModel.random(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    rows = _dp_train_rows(cfg.vocab_size, DP_TRAIN_N_ROWS)
    order = [r * B * n + s * B + i for s in range(n) for r in range(DP_WORLD) for i in range(B)]
    solo_rows = [rows[j] for j in order]
    trainer = SaeTrainer(_ms_train_config(DP_WORLD * B, os.path.join(work_dir, "ms_solo")), solo_rows, model,
                         device=dev)
    init = {hook: {name: t.detach().cpu().clone() for name, t in trainer.saes[hook].params.items()}
            for hook in MS_HOOKS}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for batch in _iter_batches(solo_rows, DP_WORLD * B):
        trainer.step(batch)
    torch.cuda.synchronize()
    solo_s = time.perf_counter() - t0
    solo = {hook: {name: t.detach().cpu() for name, t in trainer.saes[hook].params.items()} for hook in MS_HOOKS}
    solo_counts = {hook: trainer.num_tokens_since_fired[hook].copy() for hook in MS_HOOKS}
    solo_opt_step, solo_peak_gb = trainer.opt_step, torch.cuda.max_memory_allocated() / 1e9
    del trainer, model
    gc.collect()
    torch.cuda.empty_cache()

    run_dir = os.path.join(work_dir, "ms_run")
    results, card_peak_gb = spawn_ranks("module_train", {"run_dir": run_dir}, DP_WORLD)
    if [r["hooks"] for r in results] != [[hook] for hook in MS_HOOKS]:
        raise AssertionError(f"ranks trained {[r['hooks'] for r in results]}")
    with open(os.path.join(run_dir, "state.json")) as f:
        state = json.load(f)
    if state["opt_step"] != solo_opt_step or state["global_step"] != n:
        raise AssertionError(f"steps {state} against solo opt_step {solo_opt_step}")
    state_counts = load_file(os.path.join(run_dir, "state.safetensors"))
    rel, max_abs, counters = {}, {}, {}
    for hook in MS_HOOKS:
        got = Sae.load_from_disk(os.path.join(run_dir, hook), device=dev).params
        rel[hook], max_abs[hook] = _update_rel(got, solo[hook], init[hook], dev)
        counts = state_counts[f"num_tokens_since_fired/{hook}"].numpy()
        counters[hook] = int((counts * DP_WORLD != solo_counts[hook]).sum())
    if not all(v <= MS_UPDATE_REL for per_hook in rel.values() for v in per_hook.values()):
        raise AssertionError(f"module-sharded parameters off the world-1 run's: {rel}")
    expected = {"block_max": 2 * n, "flash_attention": MS_LAYERS * n}
    for r in results:
        if {k: r["launches"][k] for k in expected} != expected:
            raise AssertionError(f"rank {r['rank']} launched {r['launches']}, expected {expected}")
    hidden_mb = B * 2048 * 4096 * 2 / 1e6
    emit({
        "phase": "module_sharded_train_path", "world": DP_WORLD, "backend": "gloo (two ranks on one card)",
        "exchange_route": results[0]["route"], "exchange_mb_a_hookpoint_a_rank": hidden_mb,
        "subject": f"LLaMA-3-8B widths cut to {MS_LAYERS} layers, bf16, flash attention",
        "hookpoints": list(MS_HOOKS), "sae": "4096 -> 131072 latents, k=256, fp32, AuxK 1/32, dead threshold 0",
        "rows_a_rank_a_batch": B, "ctx_len": 2048, "batches": n, "grad_acc_steps": 2,
        "update_rel_l2": rel, "update_rel_bound": MS_UPDATE_REL, "max_abs_diff": max_abs,
        "opt_step": state["opt_step"], "counters_differing_from_doubled": counters,
        "ranks": results, "card_peak_gb_nvidia_smi": card_peak_gb,
        "solo": {"tokens_per_s": n * DP_WORLD * B * 2048 / solo_s, "peak_gb": solo_peak_gb},
        "seconds": time.perf_counter() - t_phase, "card": card,
    })
    names = tuple(_counted_modules())
    return {"launches": {name: sum(r["launches"][name] for r in results) for name in names},
            "per_rank": [r["launches"] for r in results]}


TP_WORLD = 2
TP_CACHE_ROWS, TP_CACHE_BATCH = 4, 2
TP_HIDDEN_REL = 5e-2
# tp_cache_path: the --tp 2 subject's hidden state at layers.24 against the
# unsharded subject's on the same batch, relative L2.  Each rank rounds its
# partial sum of o_proj and down_proj to bf16 before the fp32 sum, where
# the unsharded product rounds once: bf16 noise of the kind that put the
# padded image row 1.8% off itself (IMAGE_PAD_SHIFT_*).
TP_KEPT_MIN = 0.9
# The share of the unsharded run's cache entries (same rows, same batch
# size) that the --tp 2 cache holds: the noise above moves latents near the
# 256th across it (int8's 6.7% kept 91.4%).
TP_SALIENCY_REL = 0.15
# tp_subject_path: each feature's saliency against the unsharded suffix's
# on the ranks' own prefix (the hook's hidden state, so the same pool and
# splice), by L2, relative to the largest feature's norm: the suffix's bf16
# partial sums, forward and backward (the image pad-shift check's bound).
# Each path's own prefix moves the pool's (k+1)-th latent at the last
# position, which the saliency there nets against (PR 16), so the whole
# run is reported beside it, unbounded.
TP_SUBJECT_PROMPT, TP_GENERATE_PROMPT, TP_GENERATE_NEW = 2432, 64, 16
TP_TRAIN_BATCHES = 2
TP_GRAD_REL = 0.2
TP_UPDATE_REL = 0.75
# tp_train_path: the gradient the --tp 2 trainer hands its optimizer at its
# first step (two batches, after the clip, before Adam), and that step's
# update, against one unsharded trainer's, relative L2 per parameter.  The
# hidden states' bf16 noise moves latents near the 256th across it, and a
# latent that enters or leaves the top-k adds or drops its whole row of
# the gradient; Adam's first step, about lr * sign(g), turns each element
# whose sign flips into a whole step.  On an H100 the --tp 2 gradient was
# 0.096 (W_enc), 0.069 (b_enc), 0.006 (b_dec) and 0.043 (W_dec) off and
# the update 0.369, 0.299, 0.082 and 0.339; the unsharded captures plus
# Gaussian noise of the same norm (1.2% of the hidden states) gave 0.096,
# 0.069, 0.006, 0.043 and 0.369, 0.298, 0.084, 0.340.  Each bound is twice
# the larger reading: below the 0.33 or more of a gradient off by a
# factor of 1.5 either way, and the 1.4 of an update in a random direction.
DP_REPLICAS = 2
DP_REPLICA_ROWS, DP_REPLICA_BATCH = 8, 2
DP_KEPT_MIN = 0.98
DP_VALUE_REL = 2e-2
# dp_replicas_path, where one card at batch_size b and at 2b differ: the
# share of the 2b run's entries the --dp 2 cache keeps, and the largest
# difference of a kept activation relative to the largest activation.


def _tp_subject(layers: int, dev):
    """The random LLaMA-3-8B-width subject (seed 0, bf16, flash attention)
    cut to `layers`, made whole on the card and cut to this rank's --tp
    slices (the whole tree is freed)."""
    from multimodal_sae_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from multimodal_sae_tpu_torch.parallel import shard_subject_model

    cfg = LlamaConfig(num_hidden_layers=layers, flash_attention=True)
    model = LlamaModel.random(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    shard_subject_model(model, TP_WORLD)
    gc.collect()
    torch.cuda.empty_cache()
    return model


def _all_reduce_ms(layout, shape, dev) -> float:
    """Wall ms of one of the layer body's all-reduces (`sum_partials`) of a
    bf16 tensor of `shape` over this rank's TP group; every rank calls it."""
    from multimodal_sae_tpu_torch.parallel import tensor_parallel

    x = torch.randn(shape, device=dev).to(torch.bfloat16)
    for _ in range(2):
        tensor_parallel.sum_partials(x, layout)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        tensor_parallel.sum_partials(x, layout)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / 5 * 1e3


def _reset_collectives() -> None:
    from multimodal_sae_tpu_torch.parallel import tensor_parallel

    for key in tensor_parallel.collective_counts:
        tensor_parallel.collective_counts[key] = 0


def _collectives() -> dict:
    from multimodal_sae_tpu_torch.parallel import tensor_parallel

    return dict(tensor_parallel.collective_counts)


def rank_tp_cache(args: dict) -> dict:
    """One rank of tp_cache_path: the cache CLI's flow (`run_cache`) at
    --tp 2 on cache_path's subject (this rank's slices), SAE and first
    rows; rank 0 also keeps batch 0's hidden state at layers.24."""
    from multimodal_sae_tpu_torch.config import CacheConfig
    from multimodal_sae_tpu_torch.interp_utils import load_saes
    from multimodal_sae_tpu_torch.launch.cache.cache import run_cache
    from multimodal_sae_tpu_torch.parallel import process_index

    dev, hook = torch.device("cuda"), "layers.24"
    t0 = time.perf_counter()
    model = _tp_subject(25, dev)
    saes = load_saes(args["sae_dir"], device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rows = cache_rows(model.cfg.vocab_size, TP_CACHE_ROWS, 2048)
    h = model.capture({"input_ids": np.stack([r["input_ids"] for r in rows[:TP_CACHE_BATCH]])}, [hook])[hook]
    if process_index() == 0:
        torch.save(h.cpu(), args["h_path"])
    del h
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gc.collect()
    reset_kernel_counts()
    _reset_collectives()
    seconds = run_cache(CacheConfig(save_dir=args["save_dir"], batch_size=TP_CACHE_BATCH, ctx_len=2048,
                                    n_splits=args["n_splits"], tp=TP_WORLD),
                        lambda b: model.capture(b, [hook]), saes, rows)
    launches, collectives = kernel_counts(), _collectives()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ar_ms = _all_reduce_ms(model.tensor_parallel, (TP_CACHE_BATCH, 2048, 4096), dev)
    layout = model.tensor_parallel
    return {"rank": process_index(), "tp_rank": layout.rank, "writes": layout.writes_outputs, "init_s": init_s,
            "tokens_per_s": TP_CACHE_ROWS * 2048 / seconds["run"], "seconds": seconds, "peak_gb": peak_gb,
            "launches": launches, "collectives": collectives, "all_reduce_ms": ar_ms,
            "all_reduce_ms_per_layer": 2 * ar_ms,
            "weights_gb": sum(_leaf_bytes(t) for t in _leaves(model.params)) / 1e9}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _leaf_bytes(t) -> int:
    return t.numel() * t.element_size()


def _entry_keys(locs: np.ndarray, ctx_len: int, width: int) -> np.ndarray:
    """(row, position, feature) triples as sorted int64 keys."""
    return np.sort((locs[:, 0].astype(np.int64) * ctx_len + locs[:, 1]) * width + locs[:, 2])


def phase_tp_cache_path(dev, card: str, work_dir: str, cache: dict) -> dict:
    """The cache CLI's flow at --tp 2 as two gloo ranks sharing the card
    (`--rank tp_cache`): cache_path's subject cut into each rank's slices
    (16 query and 4 KV heads a rank), SAE and first TP_CACHE_ROWS rows at
    batch size TP_CACHE_BATCH, rank 0 writing; then the unsharded subject
    here on the same batches: the hidden state at layers.24 within
    TP_HIDDEN_REL, the share of its entries kept at least TP_KEPT_MIN, the
    splits valid, the launches and collectives counted per rank."""
    from multimodal_sae_tpu_torch.features.cache import topk_latents_step
    from multimodal_sae_tpu_torch.interp_utils import load_saes
    from multimodal_sae_tpu_torch.models.llama import LlamaConfig, LlamaModel

    t_phase = time.perf_counter()
    hook, width, ctx_len = cache["hook"], 131072, 2048
    save_dir, h_path = os.path.join(work_dir, "tp_cache"), os.path.join(work_dir, "tp_h24.pt")
    results, card_peak_gb = spawn_ranks("tp_cache", {"sae_dir": cache["sae_dir"], "save_dir": save_dir,
                                                     "h_path": h_path, "n_splits": cache["n_splits"]}, TP_WORLD)
    n_batches = TP_CACHE_ROWS // TP_CACHE_BATCH
    for r in results:
        want = {"block_max": 2 * n_batches if r["writes"] else 0, "flash_attention": 25 * n_batches}
        if {k: r["launches"][k] for k in want} != want or r["collectives"] != {"all_reduce": 2 * 25 * n_batches,
                                                                            "all_gather": 0}:
            raise AssertionError(f"rank {r['rank']}: launches {r['launches']}, collectives {r['collectives']}")
    locs, acts = check_splits(os.path.join(save_dir, hook), cache["n_splits"], width)

    cfg = LlamaConfig(num_hidden_layers=25, flash_attention=True)
    model = LlamaModel.random(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    sae = load_saes(cache["sae_dir"], device=dev)[hook]
    rows = cache_rows(cfg.vocab_size, TP_CACHE_ROWS, ctx_len)
    ref = []
    for i in range(0, TP_CACHE_ROWS, TP_CACHE_BATCH):
        h = model.capture({"input_ids": np.stack([r["input_ids"] for r in rows[i:i + TP_CACHE_BATCH]])}, [hook])[hook]
        if i == 0:
            h_tp = torch.load(h_path).to(dev)
            hidden_rel = (torch.linalg.vector_norm((h_tp - h).float()) / torch.linalg.vector_norm(h.float())).item()
            del h_tp
        vals, idx = topk_latents_step(sae.params, h, sae.cfg)
        keep = (vals.abs() > 1e-5).cpu().numpy()
        b, s, _ = np.nonzero(keep)
        ref.append(np.stack([b + i, s, idx.cpu().numpy()[keep]], axis=1))
        del h, vals, idx
    del model, sae
    gc.collect()
    torch.cuda.empty_cache()
    ref_keys, tp_keys = (_entry_keys(x, ctx_len, width) for x in (np.concatenate(ref), locs))
    kept = len(np.intersect1d(ref_keys, tp_keys, assume_unique=True)) / len(ref_keys)
    if hidden_rel > TP_HIDDEN_REL or kept < TP_KEPT_MIN:
        raise AssertionError(f"--tp 2 cache: hidden {hidden_rel} off (bound {TP_HIDDEN_REL}), {kept} of the "
                             f"unsharded entries kept (at least {TP_KEPT_MIN})")
    emit({
        "phase": "tp_cache_path", "world": TP_WORLD, "tp": TP_WORLD, "backend": "gloo (two ranks on one card; the "
        "partial sums staged through pinned host memory, added in fp32)",
        "subject": "LLaMA-3-8B widths, 25 layers, bf16, flash attention; 16 query and 4 KV heads a rank",
        "sae": "4096 -> 131072 latents, k=256, fp32", "rows": TP_CACHE_ROWS, "batch_size": TP_CACHE_BATCH,
        "ctx_len": ctx_len, "hidden_rel_l2_layers24": hidden_rel, "hidden_rel_bound": TP_HIDDEN_REL,
        "entries": int(len(tp_keys)), "unsharded_entries": int(len(ref_keys)), "kept_share": kept,
        "kept_min": TP_KEPT_MIN, "ranks": results, "card_peak_gb_nvidia_smi": card_peak_gb,
        "seconds": time.perf_counter() - t_phase, "card": card,
    })
    names = tuple(_counted_modules())
    return {"launches": {name: sum(r["launches"][name] for r in results) for name in names},
            "per_rank": [r["launches"] for r in results]}


def _tp_subject_inputs(vocab: int) -> tuple:
    """tp_subject_path's attribution prompt (attribution_path's), metric
    answers and generate prompt."""
    rng = np.random.default_rng(1)
    batch = {"input_ids": rng.integers(0, vocab, size=(1, TP_SUBJECT_PROMPT))}
    prompt = np.random.default_rng(5).integers(0, vocab, size=(1, TP_GENERATE_PROMPT))
    return batch, prompt


def rank_tp_subject(args: dict) -> dict:
    """One rank of tp_subject_path: the 32-layer subject with its LM head at
    --tp 2 and attribution_path's SAE; `fast_attribution_maps` at layers.24
    for the last position's 8 largest features (one chunk), then a 16-token
    greedy generate; rank 0 writes the saliency."""
    from functools import partial

    from multimodal_sae_tpu_torch.config import SaeConfig
    from multimodal_sae_tpu_torch.features.patching import (
        build_fast_attribution, fast_attribution_maps, get_logit_diff,
    )
    from multimodal_sae_tpu_torch.parallel import process_index
    from multimodal_sae_tpu_torch.sae import Sae

    dev, hook = torch.device("cuda"), "layers.24"
    t0 = time.perf_counter()
    model = _tp_subject(32, dev)
    sae = Sae(4096, SaeConfig(num_latents=131072, k=256), decoder=True, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch, prompt = _tp_subject_inputs(model.cfg.vocab_size)
    metric = partial(get_logit_diff, answer_token_indices=torch.tensor([[1000, 2000]], device=dev))
    feats = build_fast_attribution(model, hook, sae, batch, metric).wide_idx[-1, :8].long().tolist()
    prefix = model.capture(batch, [hook])[hook]
    if process_index() == 0:
        torch.save(prefix.cpu(), args["prefix_path"])
    del prefix
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gc.collect()
    reset_kernel_counts()
    _reset_collectives()
    t0 = time.perf_counter()
    out = fast_attribution_maps(model, hook, sae, batch, metric, feats, feature_batch=8, progress=False)
    torch.cuda.synchronize()
    attribution_s = time.perf_counter() - t0
    attribution = {"launches": kernel_counts(), "collectives": _collectives(), "seconds": attribution_s,
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    if process_index() == 0:
        np.save(args["saliency_path"], np.stack(out[hook]))
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    _reset_collectives()
    t0 = time.perf_counter()
    gen = model.generate({"input_ids": prompt}, max_new_tokens=TP_GENERATE_NEW, eos_token_id=None)
    torch.cuda.synchronize()
    generate = {"launches": kernel_counts(), "collectives": _collectives(), "seconds": time.perf_counter() - t0,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    return {"rank": process_index(), "init_s": init_s, "features": feats, "attribution": attribution,
            "generate": generate, "generated": gen[0, TP_GENERATE_PROMPT:].tolist()}


def phase_tp_subject_path(dev, card: str, work_dir: str) -> dict:
    """Attribution and generation at --tp 2 as two gloo ranks sharing the
    card (`--rank tp_subject`): the 32-layer subject with its LM head, 16
    query and 4 KV heads a rank, its suffix backward through the layer
    body's autograd collectives; then here, on the unsharded subject and
    the same SAE, the same features' saliency on the ranks' prefix (each
    within TP_SALIENCY_REL of the largest feature's norm; on its own
    prefix reported beside it) and a cache-free forward over the ranks'
    generated ids (each token its argmax wherever the top-2 gap exceeds
    STEER_NEAR_TIE, as steering_path checks); then K3's chain at the
    suffix's per-rank shape (8, 16, 4, 2,432, 128) and its forward at
    tp_cache_path's (2, 16, 4, 2,048, 128)."""
    import copy
    from functools import partial

    from multimodal_sae_tpu_torch.config import SaeConfig
    from multimodal_sae_tpu_torch.features.patching import fast_attribution_maps, get_logit_diff
    from multimodal_sae_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from multimodal_sae_tpu_torch.ops import flash_attention as fa
    from multimodal_sae_tpu_torch.sae import Sae

    t_phase = time.perf_counter()
    hook = "layers.24"
    saliency_path, prefix_path = os.path.join(work_dir, "tp_saliency.npy"), os.path.join(work_dir, "tp_prefix.pt")
    results, card_peak_gb = spawn_ranks("tp_subject", {"saliency_path": saliency_path, "prefix_path": prefix_path},
                                        TP_WORLD)
    if results[0]["generated"] != results[1]["generated"] or results[0]["features"] != results[1]["features"]:
        raise AssertionError("the two --tp ranks generated or chose differently")
    for r in results:  # one chunk: the prefix to layers.24, the suffix's 7 layers forward and backward
        att, gen = r["attribution"], r["generate"]
        if (att["launches"]["flash_attention"], att["launches"]["flash_attention_bwd_dq"]) != (32, 7) \
                or att["collectives"] != {"all_reduce": 2 * 25 + 2 * 7 + 2 * 7 + 1, "all_gather": 1}:
            raise AssertionError(f"rank {r['rank']} attribution: {att}")
        if gen["launches"]["flash_attention"] != 32 or gen["collectives"] != {
                "all_reduce": 2 * 32 * TP_GENERATE_NEW, "all_gather": TP_GENERATE_NEW}:
            raise AssertionError(f"rank {r['rank']} generate: {gen}")
    tp_sal = np.load(saliency_path)
    feats = results[0]["features"]

    cfg = LlamaConfig(flash_attention=True)
    model = LlamaModel.random(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    sae = Sae(4096, SaeConfig(num_latents=131072, k=256), decoder=True, seed=0, device=dev)
    batch, prompt = _tp_subject_inputs(cfg.vocab_size)
    metric = partial(get_logit_diff, answer_token_indices=torch.tensor([[1000, 2000]], device=dev))
    h_tp = torch.load(prefix_path).to(dev)
    replayed = copy.copy(model)
    replayed.capture = lambda b, hooks: {hook: h_tp}
    sal = {}
    for name, subject in (("ranks_prefix", replayed), ("own_prefix", model)):
        sal[name] = np.stack(fast_attribution_maps(subject, hook, sae, batch, metric, feats, feature_batch=8,
                                                   progress=False)[hook])
    del sae, replayed, h_tp
    err, corr = {}, {}
    for name, ref in sal.items():
        norms = np.linalg.norm(ref.reshape(len(feats), -1), axis=1)
        err[name] = (np.linalg.norm((tp_sal - ref).reshape(len(feats), -1), axis=1) / norms.max()).tolist()
        corr[name] = [float(np.corrcoef(a.ravel(), b.ravel())[0, 1]) for a, b in zip(tp_sal, ref)]
    if not (np.isfinite(tp_sal).all() and max(err["ranks_prefix"]) <= TP_SALIENCY_REL):
        raise AssertionError(f"--tp 2 saliency off the unsharded suffix's: {err} (bound {TP_SALIENCY_REL})")
    gen_tp = torch.tensor([results[0]["generated"]], device=dev)
    seqs = torch.cat([torch.as_tensor(prompt, device=dev), gen_tp], dim=1)
    argmax, gap, replay = _cache_free_top2(model.params, cfg, seqs, TP_GENERATE_NEW)
    cache_free = _check_cache_free(gen_tp, argmax, gap, replay, "--tp 2 generate")
    solo = model.generate({"input_ids": prompt}, max_new_tokens=TP_GENERATE_NEW, eos_token_id=None)[0, TP_GENERATE_PROMPT:]
    same = (solo == gen_tp[0]).int()
    leading_equal = int(same.cumprod(0).sum())
    del model
    gc.collect()
    torch.cuda.empty_cache()
    k3_chain = check_flash_chain(dev, 8, TP_SUBJECT_PROMPT, seed=14, H=16, kvH=4)
    k3_cache = _attention_case(fa, torch.Generator(device=dev).manual_seed(15), dev, TP_CACHE_BATCH, 16, 4, 2048, 128,
                               None, phase="flash_attention_tp_cache")
    emit({
        "phase": "tp_subject_path", "world": TP_WORLD, "tp": TP_WORLD,
        "subject": "LLaMA-3-8B widths, 32 layers, bf16, flash attention, LM head split by vocabulary",
        "sae": "4096 -> 131072 latents, k=256, fp32, with its decoder", "hookpoint": hook,
        "prompt": TP_SUBJECT_PROMPT, "features": feats, "saliency_err_vs_largest_norm": err,
        "saliency_bound_ranks_prefix": TP_SALIENCY_REL, "saliency_corr": corr, "generate_prompt": TP_GENERATE_PROMPT,
        "generated": TP_GENERATE_NEW, "cache_free": cache_free, "leading_tokens_equal_unsharded": leading_equal,
        "ranks": results, "card_peak_gb_nvidia_smi": card_peak_gb,
        "k3_chain_rank_shape": k3_chain, "k3_forward_tp_cache_shape": k3_cache,
        "seconds": time.perf_counter() - t_phase, "card": card,
    })
    names = tuple(_counted_modules())
    launches = [{n: r["attribution"]["launches"][n] + r["generate"]["launches"][n] for n in names} for r in results]
    return {"launches": {n: sum(run[n] for run in launches) for n in names}, "per_rank": launches,
            "k3_chain": k3_chain, "k3_cache": k3_cache}


def _recording_capture(model, hook: str, into: list) -> None:
    """Wraps `model.capture` so that each call also appends its `hook`
    hidden states to `into` (on the card)."""
    capture = model.capture

    def recording(batch, hooks):
        out = capture(batch, hooks)
        into.append(out[hook].detach().clone())
        return out

    model.capture = recording


@contextlib.contextmanager
def _first_step(into: dict, keep=lambda t: t.detach().clone()):
    """While the block runs, records `keep` of each parameter's gradient
    that `SaeTrainer` first hands its optimizer (after the gradient
    all-reduce and the clip, before Adam) and of each parameter before and
    after that step, into `into["gradient"]`, `["before"]` and `["after"]`."""
    from multimodal_sae_tpu_torch.train import trainer as trainer_module

    apply = trainer_module.apply_updates

    def recording(params, *args, **kw):
        if into:
            return apply(params, *args, **kw)
        into["gradient"] = {name: keep(p.grad) for name, p in params.items()}
        into["before"] = {name: keep(p) for name, p in params.items()}
        out = apply(params, *args, **kw)
        into["after"] = {name: keep(p) for name, p in params.items()}
        return out

    trainer_module.apply_updates = recording
    try:
        yield into
    finally:
        trainer_module.apply_updates = apply


def _fingerprint(t: torch.Tensor) -> list:
    """(sum, sum of squares) of `t` in float64, chunk by chunk in a fixed
    order: equal bits give equal fingerprints."""
    s = q = 0.0
    for c in t.detach().flatten().split(1 << 24):
        c = c.double()
        s += c.sum().item()
        q += c.square().sum().item()
    return [s, q]


def rank_tp_train(args: dict) -> dict:
    """One rank of tp_train_path: `SaeTrainer.fit` on dp_train_path's
    4-layer subject at --tp 2 over TP_TRAIN_BATCHES batches (both ranks
    train on the same hidden states), under MMSAE_PROFILE_DIR; rank 0 keeps
    the hidden states it trained on, and each rank the fingerprints of the
    gradient it handed its optimizer and of that step's update.  `fit`'s closing checkpoint (13 GB
    with Adam's moments) is not written: the card's machine allows a call
    45 GiB of disk writes, which dp_train_path's and
    module_sharded_train_path's checkpoints mostly take, and those phases
    check a checkpoint."""
    from multimodal_sae_tpu_torch.parallel import process_index
    from multimodal_sae_tpu_torch.train import SaeTrainer

    os.environ["MMSAE_PROFILE_DIR"] = args["profile_dir"]
    dev = torch.device("cuda")
    model = _tp_subject(DP_TRAIN_LAYERS, dev)
    rows = _dp_train_rows(model.cfg.vocab_size, TP_TRAIN_BATCHES)
    captured, step = [], {}
    _recording_capture(model, DP_TRAIN_HOOK, captured)
    trainer = SaeTrainer(_dp_train_config(1, args["run_dir"]), rows, model, device=dev)
    trainer.save = lambda: None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gc.collect()
    reset_kernel_counts()
    _reset_collectives()
    t0 = time.perf_counter()
    with _first_step(step, keep=_fingerprint):
        trainer.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    out = {"rank": process_index(), "fit_s_traced": fit_s, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": kernel_counts(), "collectives": _collectives(), "opt_step": trainer.opt_step,
           "global_step": trainer.global_step, "fingerprints": step}
    if process_index() == 0:
        torch.save([h.cpu() for h in captured], args["hidden_path"])
    trace_path = os.path.join(args["profile_dir"], "sae_train", f"rank{process_index()}.trace.json")
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    out["trace"] = {"bytes": os.path.getsize(trace_path), "kernel_events": len(kernels),
                    "block_max_kernel": sum("block_max_kernel" in k for k in kernels),
                    "flash_fwd_kernel": sum("flash_fwd_kernel" in k for k in kernels)}
    return out


def phase_tp_train_path(dev, card: str, work_dir: str) -> dict:
    """`SaeTrainer` at --tp 2 as two gloo ranks sharing the card (`--rank
    tp_train`; a world of 2 is one TP group, so no gradient crosses ranks),
    at the SAE's full width with AuxK on dp_train_path's 4-layer subject,
    TP_TRAIN_BATCHES batches of 1 x 2,048 ids (one optimizer step), `fit`
    traced through MMSAE_PROFILE_DIR: each rank's trace names K1's and
    K3's kernels.  Against one trainer on the unsharded subject: the hidden
    states within TP_HIDDEN_REL, the gradient the --tp trainer hands its
    optimizer within TP_GRAD_REL, and the update of that step within
    TP_UPDATE_REL.  Both are recomputed here by one trainer on rank 0's
    captures and held to both ranks' by their fingerprints.  A control
    trainer on the unsharded captures plus Gaussian noise of the --tp
    difference's norm gives their spread under noise of that size,
    reported beside them."""
    from multimodal_sae_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from multimodal_sae_tpu_torch.train import SaeTrainer
    from multimodal_sae_tpu_torch.train.trainer import _iter_batches

    t_phase = time.perf_counter()
    hook = DP_TRAIN_HOOK
    profile_dir, hidden_path = os.path.join(work_dir, "tp_profile"), os.path.join(work_dir, "tp_hidden.pt")
    results, card_peak_gb = spawn_ranks("tp_train", {"run_dir": os.path.join(work_dir, "tp_run"),
                                                     "profile_dir": profile_dir, "hidden_path": hidden_path},
                                        TP_WORLD)
    want = {"block_max": 2 * TP_TRAIN_BATCHES, "flash_attention": DP_TRAIN_LAYERS * TP_TRAIN_BATCHES}
    for r in results:
        if not (r["trace"]["block_max_kernel"] and r["trace"]["flash_fwd_kernel"]):
            raise AssertionError(f"rank {r['rank']}'s trace lacks K1's or K3's kernel: {r['trace']}")
        if {k: r["launches"][k] for k in want} != want:
            raise AssertionError(f"rank {r['rank']} launched {r['launches']}, expected {want}")
        if (r["opt_step"], r["global_step"]) != (1, TP_TRAIN_BATCHES):
            raise AssertionError(f"rank {r['rank']} ended at opt_step {r['opt_step']}, step {r['global_step']}")

    cfg = LlamaConfig(num_hidden_layers=DP_TRAIN_LAYERS, flash_attention=True)
    rows = _dp_train_rows(cfg.vocab_size, TP_TRAIN_BATCHES)

    def first_step(subject, fingerprints=None) -> dict:
        """The first step's gradient and update of one trainer on
        `subject`; `fingerprints` gets those of its gradient and
        parameters."""
        step = {}
        trainer = SaeTrainer(_dp_train_config(1, os.path.join(work_dir, "tp_reference_run")), rows, subject,
                             device=dev)
        with _first_step(step):
            for batch in _iter_batches(rows, 1):
                trainer.step(batch)
        del trainer
        if fingerprints is not None:
            fingerprints.update({key: {name: _fingerprint(t) for name, t in part.items()} for key, part in step.items()})
        before, after = step.pop("before"), step.pop("after")
        step["update"] = {name: after[name] - before[name] for name in after}
        del before, after
        gc.collect()
        torch.cuda.empty_cache()
        return step

    t_ref = time.perf_counter()
    model = LlamaModel.random(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    unsharded_h = []
    _recording_capture(model, hook, unsharded_h)
    unsharded = first_step(model)
    del model
    tp_h = [h.to(dev) for h in torch.load(hidden_path)]
    fingerprints = {}
    tp = first_step(_ReplayedCaptures(cfg, hook, tp_h, dev), fingerprints)
    for r in results:
        if r["fingerprints"] != fingerprints:
            raise AssertionError(f"the first step on rank 0's captures {fingerprints} is not rank {r['rank']}'s "
                                 f"{r['fingerprints']}")
    noisy_h = []
    for i, (a, b) in enumerate(zip(tp_h, unsharded_h)):
        z = torch.randn(b.shape, generator=torch.Generator(device=dev).manual_seed(i), device=dev)
        diff = torch.linalg.vector_norm((a - b).float())
        noisy_h.append((b.float() + z * (diff / torch.linalg.vector_norm(z))).to(b.dtype))
    noise = first_step(_ReplayedCaptures(cfg, hook, noisy_h, dev))
    ref_s = time.perf_counter() - t_ref

    def rel(xs, ys) -> float:
        num = sum(torch.linalg.vector_norm(x.float() - y.float()).item() ** 2 for x, y in zip(xs, ys))
        return (num / sum(torch.linalg.vector_norm(y.float()).item() ** 2 for y in ys)) ** 0.5

    hidden_rel = {"tp": rel(tp_h, unsharded_h), "noise": rel(noisy_h, unsharded_h)}
    step_rel = {part: {key: {name: rel([got[part][name]], [unsharded[part][name]]) for name in unsharded[part]}
                       for key, got in (("tp", tp), ("noise", noise))} for part in ("gradient", "update")}
    del tp_h, unsharded_h, noisy_h, tp, noise, unsharded
    gc.collect()
    torch.cuda.empty_cache()
    if (hidden_rel["tp"] > TP_HIDDEN_REL or not all(v <= TP_GRAD_REL for v in step_rel["gradient"]["tp"].values())
            or not all(v <= TP_UPDATE_REL for v in step_rel["update"]["tp"].values())):
        raise AssertionError(f"--tp 2 training off the unsharded trainer's: hidden {hidden_rel}, first step {step_rel}")
    emit({
        "phase": "tp_train_path", "world": TP_WORLD, "tp": TP_WORLD,
        "subject": f"LLaMA-3-8B widths cut to {DP_TRAIN_LAYERS} layers, bf16, flash attention, {hook}",
        "sae": "4096 -> 131072 latents, k=256, fp32, AuxK 1/32, dead threshold 0", "batches": TP_TRAIN_BATCHES,
        "rows_a_batch": 1, "grad_acc_steps": 2, "hidden_rel_l2_vs_unsharded": hidden_rel,
        "hidden_rel_bound": TP_HIDDEN_REL, "first_gradient_rel_l2_vs_unsharded": step_rel["gradient"],
        "first_gradient_rel_bound": TP_GRAD_REL, "first_update_rel_l2_vs_unsharded": step_rel["update"],
        "first_update_rel_bound": TP_UPDATE_REL, "ranks_fingerprints_equal_replayed": True,
        "reference_trainers_s": ref_s, "ranks": results, "card_peak_gb_nvidia_smi": card_peak_gb,
        "seconds": time.perf_counter() - t_phase, "card": card,
    })
    names = tuple(_counted_modules())
    return {"launches": {name: sum(r["launches"][name] for r in results) for name in names},
            "per_rank": [r["launches"] for r in results]}


class _ReplayedCaptures:
    """A subject for `SaeTrainer` that hands back saved hidden states of
    `hook`, one batch after another, on `dev` (a subject of `cfg`'s
    widths)."""

    def __init__(self, cfg, hook: str, hiddens: list, dev):
        self.cfg, self.hook, self.hiddens, self.dev = cfg, hook, list(hiddens), dev

    def hookpoint_names(self):
        return [f"layers.{i}" for i in range(self.cfg.num_hidden_layers)]

    def layers_name(self):
        return "layers"

    def resolve_widths(self, hookpoints):
        return {h: self.cfg.hidden_size for h in hookpoints}

    def capture(self, batch, hookpoints):
        return {self.hook: self.hiddens.pop(0).to(self.dev)}


TP_MS_BATCHES = 4


def rank_tp_module_train(args: dict) -> dict:
    """One rank of tp_module_sharded_train_path: `SaeTrainer` at --tp 2 with
    `distribute_modules` on MS_HOOKS (this rank trains one of them on its
    TP group's hidden states; no row moves), TP_MS_BATCHES batches of one
    2,048-id row, timed; then the --tp 2 trainer without the flag on the
    same batches for this rank's hookpoint (the other hookpoint captured
    too, so that both ranks run the same layers and collectives; the SAE
    seeded by its index among MS_HOOKS, as the flagless trainer over both
    seeds it).  Returns whether the two SAEs are equal bit for bit."""
    from multimodal_sae_tpu_torch.parallel import process_index
    from multimodal_sae_tpu_torch.sae import Sae
    from multimodal_sae_tpu_torch.train import SaeTrainer
    from multimodal_sae_tpu_torch.train.trainer import _iter_batches

    dev = torch.device("cuda")
    model = _tp_subject(MS_LAYERS, dev)
    rows = _dp_train_rows(model.cfg.vocab_size, TP_MS_BATCHES)
    trainer = SaeTrainer(_ms_train_config(1, args["run_dir"]), rows, model, device=dev)
    hooks = list(trainer.saes)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gc.collect()
    reset_kernel_counts()
    step_ms = []
    for i, batch in enumerate(_iter_batches(rows, 1)):
        if i == 1:
            torch.cuda.synchronize()
            t_steady = time.perf_counter()
        marks = StageMarks()
        trainer.step(batch, mark=marks)
        step_ms.append(marks.ms()["total"])
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t_steady
    out = {"rank": process_index(), "hooks": hooks, "plan": trainer.module_plan,
           "tokens_per_s": (len(step_ms) - 1) * 2048 / steady_s, "step_ms": step_ms,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": kernel_counts(),
           "opt_step": trainer.opt_step}
    (hook,) = hooks
    sharded = {name: t.detach().cpu() for name, t in trainer.saes[hook].params.items()}
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    capture = model.capture
    model.capture = lambda batch, hookpoints: capture(batch, list(MS_HOOKS))
    cfg = _ms_train_config(1, args["run_dir"] + "_reference")
    cfg.distribute_modules, cfg.hookpoints = False, [hook]
    reference = SaeTrainer(cfg, rows, model, device=dev)
    seeded = Sae(4096, cfg.sae, seed=MS_HOOKS.index(hook), device=dev)
    with torch.no_grad():
        for name, t in reference.saes[hook].params.items():
            t.copy_(seeded.params[name])
    del seeded
    for batch in _iter_batches(rows, 1):
        reference.step(batch)
    diff = {name: (t.detach().cpu() - sharded[name]).abs().max().item()
            for name, t in reference.saes[hook].params.items()}
    out["equal_bits"] = all(torch.equal(t.detach().cpu(), sharded[name])
                            for name, t in reference.saes[hook].params.items())
    out["max_abs_diff"] = diff
    return out


def phase_tp_module_sharded_train_path(dev, card: str, work_dir: str) -> dict:
    """`SaeTrainer` at --tp 2 with `distribute_modules` as two gloo ranks
    sharing the card (`--rank tp_module_train`) on module_sharded_train_path's
    4-layer subject cut to each rank's slices, the full-width SAE with AuxK at
    layers.1 and layers.3: each rank trains one hookpoint on its TP group's
    hidden states, and its SAE equals the --tp 2 trainer's for that
    hookpoint bit for bit (each rank runs that trainer after its own);
    tokens/s and the peak a rank."""
    t_phase = time.perf_counter()
    results, card_peak_gb = spawn_ranks("tp_module_train", {"run_dir": os.path.join(work_dir, "tp_ms_run")}, TP_WORLD)
    if [r["hooks"] for r in results] != [[hook] for hook in MS_HOOKS]:
        raise AssertionError(f"ranks trained {[r['hooks'] for r in results]}, one of {MS_HOOKS} each expected")
    want = {"block_max": 2 * TP_MS_BATCHES, "flash_attention": MS_LAYERS * TP_MS_BATCHES}
    for r in results:
        if not r["equal_bits"]:
            raise AssertionError(f"rank {r['rank']}'s SAE differs from the --tp 2 trainer's: {r['max_abs_diff']}")
        if {k: r["launches"][k] for k in want} != want or r["opt_step"] != TP_MS_BATCHES // 2:
            raise AssertionError(f"rank {r['rank']} launched {r['launches']} over {r['opt_step']} steps, "
                                 f"expected {want}")
    emit({
        "phase": "tp_module_sharded_train_path", "world": TP_WORLD, "tp": TP_WORLD,
        "backend": "gloo (two ranks on one card)",
        "subject": f"LLaMA-3-8B widths cut to {MS_LAYERS} layers, bf16, flash attention, --tp 2 slices",
        "hookpoints": list(MS_HOOKS), "sae": "4096 -> 131072 latents, k=256, fp32, AuxK 1/32, dead threshold 0",
        "rows_a_batch": 1, "ctx_len": 2048, "batches": TP_MS_BATCHES, "grad_acc_steps": 2,
        "equal_bits_to_tp_trainer": True, "ranks": results, "card_peak_gb_nvidia_smi": card_peak_gb,
        "seconds": time.perf_counter() - t_phase, "card": card,
    })
    names = tuple(_counted_modules())
    return {"launches": {name: sum(r["launches"][name] for r in results) for name in names},
            "per_rank": [r["launches"] for r in results]}


def _split_entries(module_dir: str, n_splits: int) -> tuple:
    locs, acts = check_splits(module_dir, n_splits, 131072)
    keys = (locs[:, 0].astype(np.int64) * 2048 + locs[:, 1]) * 131072 + locs[:, 2]
    order = np.argsort(keys)
    return keys[order], acts[order]


def phase_dp_replicas_path(dev, card: str, work_dir: str, cache: dict) -> dict:
    """The in-process --dp 2 replicas, both on this card: the cache CLI's
    flow (`run_cache`) at --dp 2 and batch_size DP_REPLICA_BATCH on
    cache_path's subject and SAE (each replica captures its rows and
    encodes them with its copy of the SAE), against one device at twice
    that batch size over the same DP_REPLICA_ROWS rows, byte for byte (JAX
    launch/cache/cache.py:60-64).  Only where they differ does one device
    at DP_REPLICA_BATCH run: the --dp run must then equal it byte for byte
    and keep at least DP_KEPT_MIN of the larger batch's entries with
    activations within DP_VALUE_REL.  Then training capture at --dp 2: one
    `SaeTrainer` step on 2 rows of dp_train_path's 4-layer subject, whose
    captured rows equal each row captured alone bit for bit."""
    import copy

    from multimodal_sae_tpu_torch.config import CacheConfig
    from multimodal_sae_tpu_torch.interp_utils import load_saes
    from multimodal_sae_tpu_torch.launch.cache.cache import run_cache
    from multimodal_sae_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from multimodal_sae_tpu_torch.parallel import replicate_saes, shard_subject_model_dp
    from multimodal_sae_tpu_torch.train import SaeTrainer
    from multimodal_sae_tpu_torch.train.trainer import _iter_batches

    t_phase = time.perf_counter()
    hook, n_splits = cache["hook"], cache["n_splits"]
    model = LlamaModel.random(LlamaConfig(num_hidden_layers=25, flash_attention=True), seed=0,
                              dtype=torch.bfloat16, device=dev)
    saes = load_saes(cache["sae_dir"], device=dev)
    rows = cache_rows(model.cfg.vocab_size, DP_REPLICA_ROWS, 2048)
    one = copy.copy(model)
    one_saes = {name: type(sae)(sae.d_in, sae.cfg, params=sae.params) for name, sae in saes.items()}  # shared
    shard_subject_model_dp(model, DP_REPLICAS, devices=[dev] * DP_REPLICAS)
    replicate_saes(model, saes.values())
    runs = {}

    def run(name, subject, subject_saes, batch_size, dp):
        gc.collect()
        reset_kernel_counts()
        seconds = run_cache(CacheConfig(save_dir=os.path.join(work_dir, name), batch_size=batch_size, ctx_len=2048,
                                        n_splits=n_splits, dp=dp), lambda b: subject.capture(b, [hook]),
                            subject_saes, rows)
        runs[name] = {"tokens_per_s": DP_REPLICA_ROWS * 2048 / seconds["run"], "launches": kernel_counts()}
        return os.path.join(work_dir, name, hook)

    dp_dir = run("dp", model, saes, DP_REPLICA_BATCH, DP_REPLICAS)
    two_b_dir = run("one_2b", one, one_saes, DP_REPLICAS * DP_REPLICA_BATCH, 0)
    steps = DP_REPLICA_ROWS // (DP_REPLICAS * DP_REPLICA_BATCH)
    want = {"block_max": 2 * DP_REPLICAS * steps, "flash_attention": 25 * DP_REPLICAS * steps}
    if {k: runs["dp"]["launches"][k] for k in want} != want:
        raise AssertionError(f"--dp 2 cache launched {runs['dp']['launches']}, expected {want}")
    try:
        _dirs_byte_equal(dp_dir, two_b_dir)
        equal_2b, kept, value_rel = True, 1.0, 0.0
    except AssertionError:
        equal_2b = False
        _dirs_byte_equal(dp_dir, run("one_b", one, one_saes, DP_REPLICA_BATCH, 0))
        dp_keys, dp_acts = _split_entries(dp_dir, n_splits)
        ref_keys, ref_acts = _split_entries(two_b_dir, n_splits)
        shared, i_dp, i_ref = np.intersect1d(dp_keys, ref_keys, assume_unique=True, return_indices=True)
        kept = len(shared) / len(ref_keys)
        value_rel = float(np.abs(dp_acts[i_dp] - ref_acts[i_ref]).max() / np.abs(ref_acts).max()) if len(shared) else 0.0
        if kept < DP_KEPT_MIN or value_rel > DP_VALUE_REL:
            raise AssertionError(f"--dp 2 cache against one card at twice the batch: {kept} kept, {value_rel}")
    del model, one, saes, one_saes
    gc.collect()
    torch.cuda.empty_cache()

    t_train = time.perf_counter()
    cfg = LlamaConfig(num_hidden_layers=DP_TRAIN_LAYERS, flash_attention=True)
    base = LlamaModel.random(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    replicated = shard_subject_model_dp(copy.copy(base), DP_REPLICAS, devices=[dev] * DP_REPLICAS)[0]
    train_rows = _dp_train_rows(cfg.vocab_size, 2)
    trained_on = []
    _recording_capture(replicated, DP_TRAIN_HOOK, trained_on)
    trainer = SaeTrainer(_dp_train_config(2, os.path.join(work_dir, "dp_replicas_run")), train_rows, replicated,
                         device=dev)
    for batch in _iter_batches(train_rows, 2):
        trainer.step(batch)
    del trainer
    alone = torch.cat([base.capture({"input_ids": r["input_ids"][None]}, [DP_TRAIN_HOOK])[DP_TRAIN_HOOK]
                       for r in train_rows])
    capture_equal = len(trained_on) == 1 and _bits_equal(trained_on[0], alone)
    if not capture_equal:
        raise AssertionError("--dp 2 training capture differs from each row captured alone")
    del base, replicated, trained_on, alone
    gc.collect()
    torch.cuda.empty_cache()
    emit({
        "phase": "dp_replicas_path", "dp": DP_REPLICAS, "devices": "both replicas on this card",
        "subject": "LLaMA-3-8B widths, 25 layers, bf16, flash attention", "sae": "4096 -> 131072 latents, k=256",
        "rows": DP_REPLICA_ROWS, "batch_size": DP_REPLICA_BATCH, "runs": runs,
        "dp_files_byte_equal_one_card_at_2b": equal_2b,
        "dp_files_byte_equal_one_card_at_b": True if "one_b" in runs else "not run: equal at 2b",
        "kept_share_vs_2b": kept, "kept_min": DP_KEPT_MIN, "max_value_diff_vs_2b_rel": value_rel,
        "value_bound": DP_VALUE_REL, "train": {"trainer_capture_bits_equal_rows_alone": capture_equal,
                                               "seconds": time.perf_counter() - t_train},
        "seconds": time.perf_counter() - t_phase, "card": card,
    })
    return {"launches": runs["dp"]["launches"]}


RANK_PHASES = {"dp_cache": rank_dp_cache, "dp_train": rank_dp_train, "nccl": rank_nccl,
               "module_train": rank_module_train, "tp_cache": rank_tp_cache, "tp_subject": rank_tp_subject,
               "tp_train": rank_tp_train, "tp_module_train": rank_tp_module_train}


def rank_main(phase: str, args: dict) -> int:
    """A rank process (`chip_smoke.py --rank PHASE ARGS`): dp phases bring a
    gloo group up on card 0 themselves, before `initialize_distributed`,
    which keeps it; nccl_path leaves the bring-up to
    `initialize_distributed`.  Prints its result as `RANK_RESULT {json}`."""
    import datetime

    import torch.distributed as dist

    from multimodal_sae_tpu_torch.device import setup
    from multimodal_sae_tpu_torch.parallel import initialize_distributed

    if phase != "nccl":
        torch.cuda.set_device(0)
        setup(torch.device("cuda"))
        dist.init_process_group("gloo", init_method="env://", rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]),
                                timeout=datetime.timedelta(seconds=DP_GROUP_TIMEOUT_S))
        if not initialize_distributed() or dist.get_backend() != "gloo":
            raise AssertionError("initialize_distributed did not keep the gloo group")
    result = RANK_PHASES[phase](args)
    if dist.is_initialized():
        dist.destroy_process_group()
    print("RANK_RESULT " + json.dumps(result), flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--rank"]:
        return rank_main(sys.argv[2], json.loads(sys.argv[3]))
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    card = phase_build()
    k1 = phase_block_max(dev)
    k3 = phase_flash_attention(dev)
    k3_bwd = phase_flash_attention_bwd(dev)
    sae_encode = phase_sae_encode(dev)
    # The loader reads the splits the cache phase merged, in its directory.
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work_dir:
        cache = phase_cache_path(dev, card, work_dir)
        hub = phase_hub_sae_path(dev, card, work_dir, cache)
        gc.collect()
        torch.cuda.empty_cache()
        kth = phase_kth_search_path(dev, card)
        gc.collect()
        torch.cuda.empty_cache()
        dp_cache = phase_dp_cache_path(card, work_dir, cache)
        nccl = phase_nccl_path(card, work_dir, cache)
        tp_cache = phase_tp_cache_path(dev, card, work_dir, cache)
        gc.collect()
        torch.cuda.empty_cache()
        dp_replicas = phase_dp_replicas_path(dev, card, work_dir, cache)
        gc.collect()
        torch.cuda.empty_cache()
        int8_cache = phase_int8_cache_path(dev, card, cache)
        gc.collect()
        torch.cuda.empty_cache()
        loaded = phase_loader_path(card, cache.pop("cache_dir"), cache.pop("hook"), cache.pop("tokens"))
        explained = phase_explain_score_path(card, loaded["records"], work_dir)
    # The stats phase needs only each record's feature: drop the examples
    # (about a million Python objects and their arrays) before the
    # attribution phase, whose host-bound run they slow.
    for r in loaded["records"]:
        r.examples = r.train = None
    gc.collect()
    torch.cuda.empty_cache()
    attribution = phase_attribution_path(dev, card)
    model, sae = attribution.pop("model"), attribution.pop("sae")
    general = phase_general_attribution_path(dev, card, model, sae)
    remat = phase_remat_attribution_path(dev, card, model, sae)
    gc.collect()
    torch.cuda.empty_cache()
    stats = phase_stats_path(dev, card, model, sae, loaded["records"], loaded["selected"])
    steering = phase_steering_path(dev, card, model, sae)
    tools = phase_tools_path(dev, card, model, sae)
    del model, sae
    loader_launches = loaded["launches"]
    del loaded
    gc.collect()
    torch.cuda.empty_cache()
    int8_subject = phase_int8_subject_path(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work_dir:
        tp_subject = phase_tp_subject_path(dev, card, work_dir)
    gc.collect()
    torch.cuda.empty_cache()
    train = phase_train_path(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work_dir:
        dp_train = phase_dp_train_path(dev, card, work_dir)
        gc.collect()
        torch.cuda.empty_cache()
        module_train = phase_module_sharded_train_path(dev, card, work_dir)
        gc.collect()
        torch.cuda.empty_cache()
        tp_train = phase_tp_train_path(dev, card, work_dir)
        gc.collect()
        torch.cuda.empty_cache()
        tp_module_train = phase_tp_module_sharded_train_path(dev, card, work_dir)
    gc.collect()
    torch.cuda.empty_cache()
    image = phase_image_cache_path(dev, card)
    image_train = phase_image_train_path(dev, card, image.pop("model"))
    gc.collect()
    torch.cuda.empty_cache()
    image_steering = phase_image_steering_path(dev, card)
    llava, llava_sae = image_steering.pop("model"), image_steering.pop("sae")
    image_attribution = phase_image_attribution_path(dev, card, llava, llava_sae)
    image_tools = phase_image_tools_path(dev, card, llava, llava_sae, image_attribution.pop("saliency"))
    remat_image = phase_remat_image_row(dev, card, llava, llava_sae, image_attribution.pop("remat_probe"))
    del llava, llava_sae
    gc.collect()
    torch.cuda.empty_cache()
    # K3 at the image attribution suffix's shapes: a chunk of 8 features on
    # the probe row, and 4 features on the ragged two-row batch (row 0 of
    # each pair left-padded).
    k3_image_attribution = [check_flash_chain(dev, 8, image_attribution["S"], seed=12),
                            check_flash_chain(dev, 8, image_attribution["S2"], image_attribution["pads"], seed=13)]
    emit({"phase": "flash_attention_image_attribution", "shapes": k3_image_attribution})
    int8_image = phase_int8_image_path(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    clip = phase_clip_path(dev, card)
    runs = (cache["launches"], dp_cache["launches"], nccl["launches"], int8_cache["launches"], loader_launches,
            explained["launches"], attribution["launches"], general["launches"], stats["launches"],
            steering["launches"], int8_subject["launches"], train["launches"], dp_train["launches"],
            module_train["launches"], image["launches"], image_train["launches"], image_steering["launches"],
            image_attribution["launches"], int8_image["launches"], clip["launches"], tp_cache["launches"],
            dp_replicas["launches"], tp_subject["launches"], tp_train["launches"], tools["launches"],
            image_tools["launches"], remat["launches"], tp_module_train["launches"], hub["launches"],
            kth["launches"])
    per_rank = {phase: [{name: counts[name] for name in ("block_max", "flash_attention")} for counts in run["per_rank"]]
                for phase, run in (("dp_cache_path", dp_cache), ("nccl_path", nccl), ("dp_train_path", dp_train),
                                   ("module_sharded_train_path", module_train), ("tp_cache_path", tp_cache),
                                   ("tp_subject_path", tp_subject), ("tp_train_path", tp_train),
                                   ("tp_module_sharded_train_path", tp_module_train))}
    new_phases = {"int8_cache_path": int8_cache, "int8_subject_path": int8_subject,
                  "module_sharded_train_path": module_train, "int8_image_path": int8_image,
                  "tp_cache_path": tp_cache, "dp_replicas_path": dp_replicas, "tp_subject_path": tp_subject,
                  "tp_train_path": tp_train}
    total = {name: sum(run[name] for run in runs) for name in runs[0]}
    k2, splice, dvals = attribution["k2"], attribution["splice"], train["dvals"]
    bwd_launches = {part: total[f"flash_attention_bwd_{part}"] for part in ("delta", "dkdv", "dq")}
    kernels_line = {"kernels": [
        {"name": "block_max", "route": "cuda",
         "source": "multimodal_sae_tpu_torch/csrc/block_max.cu",
         "replaces": "multimodal_sae_tpu/ops/pallas_topk.py:48",
         "launches": total["block_max"], "max_abs_err": k1["max_abs_err"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": "bytes", "library_ms": k1["library_ms"], "image_step": k1["image_step"],
         "prompt_step": k1["prompt_step"], "clamp_chunk": steering["clamp_chunk"]["block_max"],
         "image_train_steps": k1["image_train_steps"],
         "launches_per_rank": {phase: [c["block_max"] for c in ranks] for phase, ranks in per_rank.items()}},
        {"name": "flash_attention", "route": "cuda",
         "source": "multimodal_sae_tpu_torch/csrc/flash_attention.cu",
         "replaces": "multimodal_sae_tpu/models/llama.py:341",
         "launches": total["flash_attention"], "max_abs_err": k3["max_abs_err"],
         "ms": k3["ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": k3["library_ms"], "image_shapes": k3["image_shapes"],
         "right_pad_edges_max_abs_err": k3["right_pad_edges_max_abs_err"],
         "prefill_shapes": [steering["k3_prefill"], image_steering["k3_prefill"]],
         "image_attribution_with_lse": [{"shape": c["shape"], "left_pads": c["left_pads"], **c["forward_with_lse"]}
                                        for c in k3_image_attribution],
         "tp_rank_shapes": [{key: tp_subject["k3_cache"][key] for key in ("shape", "max_abs_err", "ms", "plain_ms",
                                                                          "bound_ms", "bound_by", "library_ms")},
                            {"shape": tp_subject["k3_chain"]["shape"], **tp_subject["k3_chain"]["forward_with_lse"]}],
         "launches_per_rank": {phase: [c["flash_attention"] for c in ranks] for phase, ranks in per_rank.items()},
         "launches_a_chunk_without_and_with_remat": {
             what: [runs[tag]["launches"]["flash_attention"] for tag in ("no_remat", "remat")]
             for what, runs in (("text", remat["flash"]), ("image_row", remat_image))}},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "multimodal_sae_tpu_torch/csrc/flash_attention_bwd.cu",
         "replaces": "multimodal_sae_tpu/models/llama.py:341 (jax flash_attention.py:1121 dkv, :1456 dq)",
         "launches": bwd_launches["delta"] + bwd_launches["dkdv"] + bwd_launches["dq"],
         "launches_by_kernel": bwd_launches, "max_abs_err": k3_bwd["max_abs_err"],
         "ms": k3_bwd["ms"], "plain_ms": k3_bwd["plain_ms"], "bound_ms": k3_bwd["bound_ms"],
         "bound_by": k3_bwd["bound_by"], "library_ms": k3_bwd["library_ms"],
         "one_prompt": {key: general["k3_bwd_b1"][key] for key in ("shape", "max_abs_err", "ms", "plain_ms",
                                                                 "bound_ms", "bound_by", "library_ms")},
         "image_attribution": [{key: c[key] for key in ("shape", "left_pads", "max_abs_err", "ms", "plain_ms",
                                                        "bound_ms", "bound_by", "library_ms")}
                               for c in k3_image_attribution],
         "tp_rank_shape": {key: tp_subject["k3_chain"][key] for key in ("shape", "max_abs_err", "ms", "plain_ms",
                                                                       "bound_ms", "bound_by", "library_ms")},
         "launches_per_rank": {phase: [c["flash_attention_bwd_dq"] for c in run["per_rank"]]
                               for phase, run in (("tp_subject_path", tp_subject),)}},
        {"name": "gather_rows", "route": "cuda",
         "source": "multimodal_sae_tpu_torch/csrc/gather_rows.cu",
         "replaces": "multimodal_sae_tpu/ops/pallas_gather.py:50",
         "launches": total["gather_rows"], "max_abs_err": k2["max_abs_err"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": k2["library_ms"],
         "clamp_chunk": steering["clamp_chunk"]["gather_decode"], "image_prompt": image_attribution["k2"]},
        {"name": "splice_decode", "route": "cuda",
         "source": "multimodal_sae_tpu_torch/csrc/gather_rows.cu",
         "replaces": "multimodal_sae_tpu/ops/pallas_gather.py:50",
         "launches": total["splice_decode"], "max_abs_err": splice["max_abs_err"],
         "ms": splice["ms"], "plain_ms": splice["plain_ms"], "bound_ms": splice["bound_ms"],
         "bound_by": splice["bound_by"], "library_ms": splice["library_ms"],
         "image_prompt": image_attribution["splice"]},
        {"name": "decode_dvals", "route": "cuda",
         "source": "multimodal_sae_tpu_torch/csrc/gather_rows.cu",
         "replaces": "multimodal_sae_tpu/ops/sparse_decode.py:132",
         "launches": total["decode_dvals"], "max_abs_err": dvals["max_abs_err"],
         "ms": dvals["kernel_ms"], "plain_ms": dvals["plain_ms"], "bound_ms": dvals["bound_ms"],
         "bound_by": dvals["bound_by"], "library_ms": None,
         "general_path": {"tokens": general["dvals"]["tokens"], "k": general["dvals"]["k"],
                          "max_abs_err": general["dvals"]["max_abs_err"], "ms": general["dvals"]["kernel_ms"],
                          "plain_ms": general["dvals"]["plain_ms"], "bound_ms": general["dvals"]["bound_ms"],
                          "bound_by": general["dvals"]["bound_by"], "library_ms": None}},
    ]}
    parts = {"flash_attention_bwd": ("flash_attention_bwd_delta", "flash_attention_bwd_dkdv",
                                     "flash_attention_bwd_dq")}
    for entry in kernels_line["kernels"]:
        names = parts.get(entry["name"], (entry["name"],))
        entry["launches_in_phases_of_slices_10_and_11"] = {
            phase: sum(run["launches"][name] for name in names) for phase, run in new_phases.items()}
    for entry in kernels_line["kernels"]:
        names = parts.get(entry["name"], (entry["name"],))
        entry["launches_in_phases_of_slice_13"] = {
            phase: sum(run["launches"][name] for name in names)
            for phase, run in (("remat_attribution_path", remat), ("tp_module_sharded_train_path", tp_module_train))}
    for entry in kernels_line["kernels"]:
        names = parts.get(entry["name"], (entry["name"],))
        entry["launches_in_phases_of_slice_14"] = {
            phase: sum(run["launches"][name] for name in names)
            for phase, run in (("hub_sae_path", hub), ("kth_search_path", kth))}
    for entry in kernels_line["kernels"]:
        names = parts.get(entry["name"], (entry["name"],))
        entry["launches_in_tools_path"] = {
            phase: sum(run["launches"][name] for name in names)
            for phase, run in (("tools_path", tools), ("image_tools_path", image_tools))}
    emit({"phase": "tools_summary", "ms": {**tools["ms"], **{f"image_{k}": v for k, v in image_tools["ms"].items()}},
          "launches": {"tools_path": tools["per_tool"], "image_tools_path": {"probe_activations": {
              name: image_tools["launches"][name] for name in ("flash_attention", "block_max", "gather_rows")}}},
          "peak_gb": max(tools["peak_gb"], image_tools["peak_gb"])})
    # The split product's launches on the main paths (the kernel's own
    # phase is not among them): one a cache batch, a no-grad prompt encode,
    # a clamp chunk, a probe, a spliced forward's hook; none in training.
    sae_encode["launches"] = total["sae_encode"]
    sae_encode["launches_by_phase"] = {phase: run["sae_encode"] for phase, run in (
        ("cache_path", cache["launches"]), ("hub_sae_path", hub["launches"]), ("dp_cache_path", dp_cache["launches"]),
        ("nccl_path", nccl["launches"]), ("int8_cache_path", int8_cache["launches"]),
        ("attribution_path", attribution["launches"]), ("general_attribution_path", general["launches"]),
        ("remat_attribution_path", remat["launches"]), ("steering_path", steering["launches"]),
        ("tools_path", tools["launches"]), ("int8_subject_path", int8_subject["launches"]),
        ("train_path", train["launches"]), ("image_cache_path", image["launches"]),
        ("image_train_path", image_train["launches"]), ("image_steering_path", image_steering["launches"]),
        ("image_attribution_path", image_attribution["launches"]), ("image_tools_path", image_tools["launches"]),
        ("int8_image_path", int8_image["launches"]))}
    kernels_line["kernels"].append(sae_encode)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit(kernels_line)
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
