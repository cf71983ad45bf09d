#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --parent DIR   # phases 1-3, then the flash_attn
                                         # and trimmed_wavg kernels of the
                                         # checkout in DIR timed beside
                                         # this one's
    python3 chip_smoke.py --allocator-ab # phases 1-2, then host-driver
                                         # rounds with the allocator's
                                         # expandable segments off and on
    python3 chip_smoke.py --tp-only      # phases 1-2, then phase 10 with
                                         # its own tp=1 serving reference
    python3 chip_smoke.py --zoo-only     # phases 1-2, then phase 11
    python3 chip_smoke.py --conditioned-only  # phases 1-2, phase 3's
                                         # flash_attn check, then phase 12
    python3 chip_smoke.py --launch-only  # phases 1-2, phase 3's ssd_scan
                                         # and flash_attn checks, then
                                         # phase 13 with 13b (granite at
                                         # 20 layers), which the whole
                                         # script leaves out

Phases, in order; any failure exits non-zero:
  1. device   the card's name and power limit (nvidia-smi); TF32 off for
              matmuls and cuDNN convolutions, so float32 means float32
  2. build    every kernel of the main paths (wavg, trimmed_wavg,
              ssd_scan, flash_attn, ring_accum), compiled with nvcc from
              src/repro_torch/csrc/, one nvcc per source, all started
              together
  3. kernels  each kernel against its plain PyTorch version at the main
              paths' shapes and at edge shapes; timed with CUDA events
              beside its bound and, where one exists, a PyTorch library
              call; wavg and trimmed_wavg (trim 0 and 1) also at phase
              8's fleets of 5 and 8 on the DCGAN payload;
              trimmed_wavg at K 1-64 (every exact-K instance
              kind and both KMAX buckets), N % 4 != 0 and a payload 4
              bytes off 16-byte alignment (the scalar path), its HBM
              share beside wavg's on the same payload, and the honest
              rows' range; flash_attn at 70 shapes, D 32-256 with
              zamba2-2.7b's D 80 (ragged tiles, windows, bidirectional,
              bf16, strided and unaligned q; phase 11's shapes:
              granite-moe-3b-a800m's round, zamba2-2.7b's round and
              prefill of 520 tokens, mixtral-8x22b's 520 and 8,192
              tokens in a 4,096-key window; keys of a length t of their
              own: t < s, t > s, ragged, 1 and below one key tile,
              causal and windowed, bf16, at every head_dim; phase 12's
              shapes: whisper-base's encoder and cross-attention,
              llama-3.2-vision-90b's cross- and self-attention, its
              logits check and both serving prefills), its refusal of
              D 96, timed at the main shape, qwen3-1.7b's heads,
              gemma3-12b's D 256, minitron-4b's shape, gemma3-12b's
              windowed local layers (2 x 2048 tokens, window 1024),
              zamba2-2.7b's D 80, and phase 12's whisper encoder (4 x
              1,500 frames), whisper cross-attention (4 x 448 tokens
              over 1,500 frames) and llama-vision cross-attention (2,048
              tokens over 1,600 image tokens, D 128) beside SDPA (an
              explicit boolean mask for the window; is_causal=False for
              the bidirectional ones), each SDPA call first held to the
              plain version;
              ssd_scan at 27 shapes (one chunk, 128 chunks, ragged last
              chunks, groups, p 32-128, n 16-160, bf16 x at the main
              shape, zamba2-2.7b's 80 heads of 64 with 64 states), timed
              at the main shape and zamba2-2.7b's, its
              four CUDA kernels' device times, its f32 SIMT and f32-
              accurate tensor-core bounds (flash_attn's too); ring_accum
              for the three wire dtypes, in the ring's chunks at non-zero
              row offsets, at the int16 extremes, through the ring's
              RowAccumulator, whose launch path is timed at 1,356 and 339
              rows beside acc.addcmul_ on the same slices
  4. check    small rounds on the card (kernels) and on the CPU (plain
              versions) from the same draws: one plain protocol round,
              one protocol round and one FedGAN round under a fault
              program with the trimmed mean, one backbone-GAN round on
              the reduced mamba2-130m and one on the reduced granite-3-2b
              with 2 kv heads at seq_len 520 (the flash branch); then
              small mesh rounds, card against card: 4 gloo ranks on this
              card (ring, pallas and jnp serial, ring parallel, FedGAN
              ring) against the stacked round on the card
  5. train    seven main paths, through `Trainer.run` (the last through
              the backbone spec), each with the launch counts set to 0
              just before it and read just after;
              the first three on the full-width DCGAN (K=10, 64x64):
              a. the protocol: 3 serial rounds and 3 parallel rounds with
                 best-channel scheduling at ratio 0.5; one wavg launch per
                 round, finite values, a moving discriminator, one FID
              b. hostile workers (dropout, free-riders, byzantine devices,
                 stragglers): 3 serial rounds with the trimmed mean (one
                 trimmed_wavg launch, no wavg launch each), 1 with
                 norm_clip and 1 with krum (one wavg launch each), then
                 FedGAN: 2 rounds without faults or reducer (two wavg
                 launches each) and 2 under the faults with the trimmed
                 mean (one trimmed_wavg launch each)
              e. the mesh layout: 10 ranks (one a worker) share this card
                 over gloo, `Trainer(layout="mesh")`: 2 serial and 1
                 parallel ring round, 1 pallas round, 1 FedGAN ring round,
                 1 ring round under dropout and stragglers, then 2 fused
                 ring rounds (best_channel, dropout); per rank 37
                 ring_accum launches a ring round and 1 wavg launch on the
                 pallas round, the ring's wire bytes, masks and weights
                 as a stacked Trainer's of the same driver
              c. the backbone-GAN on the full-width mamba2-130m (K=4,
                 seq_len 512, token data): 1 serial round (cut from 2)
                 and 1 parallel round with best-channel scheduling at ratio
                 0.5; 528 ssd_scan launches and one wavg launch per
                 round, finite values, one token FID
              d. the same protocol on granite-3-2b at full width, its 40
                 layers cut to 4 (K=4, m=4, seq_len 1024): 88 flash_attn
                 launches and one wavg launch per round, finite values,
                 one token FID, the peak device memory
              f. minitron-4b at full width, its 32 layers cut to 2 and its
                 vocabulary to 32,768 (K=4, m=4, seq_len 1024), as d: 44
                 flash_attn launches and one wavg launch per round
              g. gemma3-12b at full width, one 5:1 group of its 48 layers
                 and vocabulary 32,768: D on 2 real sequences of 2,048
                 tokens, G, D on G's output, the backward of D's
                 objective into D and G; 18 flash_attn launches (15 with
                 the window of 1,024), finite gradients, the peak device
                 memory, D's logit of the first sequence against the port
                 on the CPU (rtol 1e-4). Its GAN round waits for tensor
                 parallelism or
                 bf16 (ROADMAP A items 8 and 10)
  6. profile  one more round of the DCGAN protocol (after 5b; that trainer
              is then freed) and of the granite-3-2b backbone-GAN (after
              5d) under torch.profiler: device-busy share, the kernels
              that take the most device time (the GEMMs and the float32
              ones among them), and the device time of the
              FlashAttention backward (a record_function range);
              mamba2-130m's profiled round was cut for the script's
              time (PERF.md keeps its earlier readings)
  7. fused    the fused driver (Step 1 on the card, each round after the
              first replayed as one captured CUDA graph) against the host
              driver, same seed, fading off: the DCGAN protocol (K=10,
              2 serial and 2 parallel rounds, round_robin at 0.5), its
              hostile path under the trimmed mean (2 rounds), FedGAN (2
              rounds), the MLP-GAN (K=8, rounds a second over 50 rounds),
              mamba2-130m at full width (2 host-driver rounds only: its
              fused run was cut for the script's time when 13e came),
              granite-3-2b (4 layers) and minitron-4b (2 layers) (K=4, 2
              rounds each, peak device memory; the DCGAN's, granite's
              and minitron's runs were cut from 3 rounds), under cuDNN's
              deterministic algorithms: masks,
              weights, every round's metrics and the parameters bitwise
              equal, wallclocks within rtol 1e-6, a planted stale replay
              caught by the same check, two host runs with cuDNN's
              nondeterministic algorithms read beside it; seconds a
              round, and one replayed round profiled (a second one if
              the profiler dropped a record): 1 wavg (0 under the
              trimmed mean, 1 trimmed_wavg), 88 flash_attn a granite
              round, 44 a minitron round, device busy against wall
              (mamba2's replay, 528 of each ssd_scan kernel, is no
              longer profiled: cut for the script's time). The first fused round runs eagerly
              under set_sync_debug_mode("error"). (The mesh path 5e has
              a fused run too: ranks run uncaptured, gloo goes through
              the host.)
  8. experiments  a. resume on the card: the full DCGAN (K=10, fused,
              deterministic cuDNN, fading on), 4 rounds against 2
              rounds, `save_checkpoint`, 2 more (the graph captured),
              `restore` of round 2 into that Trainer and 2 rounds (graph
              replays), and against a fresh Trainer restored from round
              2: masks, weights, every round's metrics and the
              parameters bitwise equal, wallclock within rtol 1e-6; for
              the protocol, its hostile path (the free-riders' stale
              cache, trimmed mean) and FedGAN
              b. a centralized step and a microbatched round
              (micro_batch_d=2, micro_batch_g=4) at phase 4's small
              DCGAN, card against CPU from the same draws; the MLP-GAN's
              microbatched round against its whole-batch round on the
              card (no batch-norm: equal to f32 round-off)
              c. the "experiments" path: the quickstart twin at its
              defaults (20 rounds, its checkpoint read back), then fig3,
              fig4, fig5 (under cuDNN's deterministic algorithms, as
              d's ranks) and fig6 at the paper's full width
              (REPRO_BENCH_FULL=1, 2 rounds, FID at round 2) and
              fig_robust --smoke with its identity gate; each figure's
              seconds, seconds a round, final FIDs and the wavg and
              trimmed_wavg launches that ran on the device (the
              wrappers' calls less those recorded in a graph capture,
              plus the captured calls once a replay; the quickstart's
              held to its profiled device timeline); then each kernel
              against its plain version at every shape the path gave
              its wrapper
              d. the "mesh_experiments" path, every rank's launches
              counted and summed: fig5_fedgan --layout mesh --smoke (10
              gloo ranks on the card, started once for both settings)
              against c's stacked runs of the same two settings, and
              mamba2-130m at full width on 4 ranks (host driver, 1
              round (cut from 2), each group recomputed in the backward)
              against the first of phase 7's host-driver rounds: masks,
              weights and wallclock bitwise, metrics within 1e-5
              relative, FIDs within 1e-4; then wavg against its plain
              version at every shape the ranks gave it.
              (fedgan_compare --layout mesh, the same two algorithms on
              the same ranks, is left to the CPU tests, which hold it to
              its stacked run.)
  9. serving  the engine (`repro_torch.serving`), each run with the
              launch counts at 0 (the engine launches no hand-written
              kernel, as the JAX engine reaches no Pallas kernel):
              a. granite-3-2b at full width, 4 of its 40 layers (cut
                 to make room for phases 11 and 12; vocabulary 49,155, the
                 generator alone) at batch 8,
                 max_len 1,024, 16-token blocks, 32-token prefill chunks,
                 16 seeded requests (prompts 16-512, 32-64 new tokens,
                 every other at temperature 0.8) through the paged engine
                 (each step program captured as a CUDA graph), the dense
                 one, and the paged one stepped uncaptured: tokens equal
                 bit for bit, and the captured engine's cache leaves the
                 uncaptured one's; 4 greedy requests against the full
                 forward up to the first step with a top-2 logit margin
                 under 1e-4; a profiled decode-only replay; one
                 mode="prefill" call of 600 tokens (40 flash_attn
                 launches) and 4 decode steps against the engine's
                 chunked prefill at rtol 1e-4
              d. the front end: two threads submit a's greedy requests to
                 a ServingFrontend over a's engine; its futures give a's
                 tokens, a request that cannot fit raises RuntimeError
              b. phase 7's host-trained mamba2-130m generator, saved with
                 save_checkpoint and served by `launch.serve.main` on the
                 card and on the CPU: the same greedy tokens up to the
                 first near tie; one mode="prefill" of 512 tokens (24
                 ssd_scan launches) and 4 decode steps against the
                 chunked prefill at rtol 1e-4
              c. gemma3-12b at full width, one 5:1 group, vocabulary
                 32,768, prompts of 1,100-1,500 tokens (the 1,024-key
                 rings wrap in chunked prefill; the global layer pages):
                 paged = dense tokens, the first sampled position's
                 logits against the full forward at rtol 1e-4
              The "serving" path's launches are the mode="prefill" calls'.
  10. tp     tensor parallelism (TP=2), gloo ranks sharing the card,
              each model group a Megatron feed-forward; first flash_attn
              with k/v repeated to KV = H (flash_repeat_kv) at D 64 and
              128 against its plain version (comparison launches):
              a. the MLP-GAN (K=4 workers x TP=2 = 8 ranks), proposed
                 and FedGAN, serial and parallel, host and fused mesh
                 drivers, 2 rounds each (cut from 3), 16-bit uplink,
                 SGD, fading off,
                 against the stacked tp=1 runs of the same seed: masks,
                 weights and the wallclock bit for bit, metrics within
                 1e-4 relative, the gathered parameters within 1e-5
                 (one quantization step more on the quantized nets);
                 the per-rank Algorithm-2 payload (`tp_local_size`)
                 beside tp=1's; 1 wavg launch a rank a round
              b. granite-3-2b at full width, 2 of its 40 layers, K=2 x
                 TP=2 = 4 ranks, m=4, seq_len 1024, SGD, 1 serial
                 round (cut from 2) on the host driver, against the stacked tp=1
                 K=2 run of the same seed (run first here, then freed):
                 as a, and half-width MLP leaves on every rank; per
                 rank and round 1 wavg and 20 flash_attn launches; peak
                 memory a rank and seconds a round; wavg timed at the
                 1/TP payload beside the whole one
              c. 9a's granite-3-2b (4 layers) served at TP=2 on 2 ranks,
                 loaded from a global-shaped checkpoint written here (as
                 `launch.serve` loads one), 9a's greedy requests through
                 the paged and the dense engine (uncaptured: gloo): each
                 request's tokens 9a's up to 9a's first near tie, on
                 both ranks, handed out by rank 0 alone; the decode-only
                 step beside 9a's; no kernel launch in the engines
              The "tp" path's launches are a's and b's, summed over
              the ranks.
  11. zoo    the MoE and hybrid families at full width, under cuDNN's
              deterministic algorithms:
              a. granite-moe-3b-a800m (40 experts top-8), 32 layers cut
                 to 2, K=4, m=4, seq_len 1024, n_d=n_g=2, Adam, on
                 phase 5d's token data: 2 host rounds (the "moe" path,
                 44 flash_attn launches a round), one more host round
                 profiled (the dispatch, the experts, the combine and
                 attention), then 2 fused rounds bit for bit the host's
                 and one replay profiled
              b. zamba2-2.7b, 9 groups cut to 2 (12 Mamba-2 layers, the
                 shared block called twice), K=2, m=4, seq_len 1024,
                 n_d=n_g=1, Adam: as a (the "hybrid" path, 84 ssd_scan
                 and 14 flash_attn launches a round)
              c. mixtral-8x22b, one layer in G and D: forward and
                 backward at 8,192 tokens (the "mixtral" path, 3
                 flash_attn launches in the 4,096-key window), finite
                 gradients, peak memory; D's logits at 520 tokens
                 against the CPU (rtol 1e-4)
              d. both generators (granite-moe at 8 of its 32 layers,
                 zamba2 at full depth, 54) behind
                 the paged, dense and uncaptured engines (batch 4, 16-
                 token blocks, the serve CLI's 4 demo prompts, 20 greedy
                 tokens each): tokens and cache leaves bit for bit, the
                 greedy tokens against the dropless full forward, one
                 mode="prefill" (zamba2 520 tokens, granite-moe 512, its
                 dropless limit) against the chunked prefill (its
                 launches join the "serving" path), and
                 `launch.serve --arch zamba2-2.7b` giving the engine's
                 tokens
  12. conditioned  the encoder-decoder and vision families, their stub
              frontend's features from `make_stub_enc_feats`:
              a. whisper-base at full width and depth (6 decoder and 6
                 encoder layers over 1,500 frames), K=4, m=4, seq_len 448,
                 n_d=n_g=2, Adam, on granite-3-2b's token data cut to 448
                 tokens: 2 host rounds (the "encdec" path, 264
                 flash_attn launches a round: each net's 6 encoder layers
                 and 6 cross-attentions), one more host round profiled
                 (the encoder, the cross-attention and the flash
                 backward), then 2 fused rounds bit for bit the host's and
                 one replay profiled, under cuDNN's deterministic
                 algorithms
              b. llama-3.2-vision-90b at full width, one group (4 self +
                 1 gated cross layer) in G and in D, vocabulary 32,768,
                 the gates opened: G's forward and backward at 2,048
                 tokens over 1,600 image tokens, then D's on real tokens
                 and G's output (the "vlm" path: 15 flash_attn launches,
                 their shapes checked), one net on the card at a time;
                 finite gradients, the gates' and the cross k/v
                 projections' non-zero; D's logits at 520 tokens against
                 the CPU (rtol 1e-4)
              c. whisper-base's generator at full depth (batch 8,
                 max_len 448, 16 seeded requests) and llama-vision's
                 group at its full vocabulary (batch 4, the demo
                 prompts, 20 greedy tokens) behind the paged, dense and
                 uncaptured engines, their cross caches filled once:
                 tokens and cache leaves bit for bit, the greedy tokens
                 against the full forward, one mode="prefill" (448 and
                 600 tokens) against the chunked prefill (its launches
                 join the "serving" path), the replayed decode step
                 beside its weight-read bound
              d. `repro_torch.examples.train_distgan` on the card, 2
                 reduced rounds of each conditioned architecture
  13. launch  the launch layer (`launch/steps.py`, `launch/train.py`) in
              the JAX launch step's all-bfloat16 state, each part with
              the launch counts at 0 (the "launch" path), in the order
              a, d, e, b, c; the whole script leaves b to `--launch-only`
              for its time, and runs c on the reduced mamba2-130m when
              it reaches c past CLI_FULL_BY_S (a slow host):
              a. granite-3-2b at full width, 4 layers, phase 5d's
                 protocol (K=4, m=4, n_d=n_g=2, seq_len 1024) with SGD
                 (Adam's float32 update on the bfloat16 state is refused
                 first, as JAX's scan refuses it) through
                 build_train_step: an eager round (168 flash_attn
                 launches: the launch spec recomputes each group in the
                 backward), a profiled eager round (GEMMs, the float32
                 ones, FlashAttention.backward) beside phase 5d's float32
                 round and phase 7's replay, the fused step
                 (fuse_rounds=2) with one replay profiled, peak memory
              d. the prefill (8 x 1,024 tokens, 4 flash_attn launches)
                 and decode steps on a's generator: the prefill's caches
                 the decode step's, a decode at the last position
                 against the prefill's logits
              e. the dry run (`launch.dryrun`, `launch.hlo_costs`)
                 against one measured round of a's configuration: the
                 step once on the meta device on the host, timed, then
                 its eager round on the card under the same op counter
                 after reset_peak_memory_stats, timed; FLOPs within 1%,
                 each kernel's calls equal to the card's launch counts,
                 the reckoned peak within 15% of max_memory_allocated
                 (less what earlier phases hold), compute_s at most a's
                 replay; under `--launch-only` also b's reckoned peak,
                 printed beside the peak b measures
              b. granite-3-2b at LAUNCH_B's depth with the launch
                 protocol (SGD, n_d=n_g=5, K=4, m=4, M=4, seq_len 1024):
                 the memory reckoning, wavg at its payload, one chunk of
                 the fused step (fuse_rounds=2: round 0 eager, the
                 capture, round 1 replayed), peak memory
              c. `python -m repro_torch.launch.train` on mamba2-130m at
                 full size (bfloat16 ssd_scan) through main(argv): 2
                 rounds with checkpoints, the round-1 checkpoint resumed
                 to 2 bit for bit; then --layout mesh --data-dim 2
                 --avg-impl ring on 2 gloo ranks, 2 rounds; on the same
                 ranks the ring's and the flat gather's average of the
                 same bfloat16 uploads, every element within two
                 bfloat16 steps; each net's update against the stacked
                 run's within CLI_UPDATE_TOL
              Phase 3 holds flash_attn at the main shape in bf16 and
              ssd_scan at the main shape with bf16 x, B and C (the
              launch step's) to their plain versions, timed beside
              their float32 times, both tensor-core bounds and SDPA in
              bf16.
The last two lines are the `kernels` JSON line and
{"ok": true, "device": {...}}.
"""
import argparse
import concurrent.futures
import contextlib
import copy
import dataclasses
import functools
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# NVIDIA H100 SXM data sheet: HBM bandwidth and the float32 rate outside
# the tensor cores ...
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# ... and the TF32 tensor-core rate: a float32-accurate product takes
# three TF32 passes (the 3xTF32 split of ssd_scan.cu)
TF32_FLOPS_PER_S = 495e12
BF16_FLOPS_PER_S = 989e12
TF32X3_PASSES = 3

RTOL, ATOL = 1e-5, 1e-6        # f32 sums of K terms in another order
K_MAIN, N_MAIN = 10, 2_765_568  # Algorithm 2 on the DCGAN discriminator
# Algorithm 2 on the full-width mamba2-130m discriminator and on the
# 4-layer granite-3-2b one, K = 4 devices
K_BACKBONE, N_BACKBONE = 4, 129_574_080
N_GRANITE = 348_153_856
N_MINITRON = 330_319_872        # 2 of minitron-4b's 32 layers
N_FEDGAN = 6_342_272            # FedGAN's payload: discriminator + generator
EDGE_N = (1, 3, 2048, 2049)
EDGE_K = (1, 7, 64)
# every instance kind of the kernel: exact K up to 16 (the paper's 10),
# KMAX 32 and 64 past it, and the edges between them
TRIM_EDGE_K = (1, 2, 3, 5, 10, 13, 16, 17, 32, 33, 64)
TRIM_EDGE = (0, 1, 3)
# the fleets of phase 8's figures on the DCGAN payload besides K_MAIN:
# fig4's K=5, and fig_robust's K=8 (trimmed mean at trim 1, trim 0 in
# its identity gate)
EXPERIMENT_K = (5, 8)
# The Mamba-2 SSD scan of the full-width mamba2-130m backbone-GAN:
# b = m = 8 sequences of 512 tokens, 24 heads of 64, one group of 128.
SSD_MAIN = dict(b=8, s=512, h=24, p=64, g=1, n=128, chunk=128)
SSD_ATOL, SSD_ATOL_BF16 = 1e-4, 0.05   # as tests/test_kernels.py
# the launch step's scan inputs: x, B and C slices of the bfloat16 conv
# output (dt float32); B and C scaled as the bf16 case above
LAUNCH_SSD = dict(x_dtype="bfloat16", bc_dtype="bfloat16",
                  bc_scale=128 ** -0.5, strided=True)
# The four CUDA kernels of one scan (csrc/ssd_scan.cu)
SSD_KERNELS = ("ssd_cb_kernel", "ssd_state_kernel", "ssd_prefix_kernel",
               "ssd_out_kernel")
# Causal GQA attention of the full-width granite-3-2b backbone-GAN: b = m
# = 4 sequences of 1024 tokens, 32 heads of 64 over 8 kv heads; and
# qwen3-1.7b's heads (16 of 128 over 8).
FLASH_MAIN = dict(b=4, s=1024, h=32, kv=8, d=64)
FLASH_QWEN3 = dict(b=4, s=1024, h=16, kv=8, d=128)
# gemma3-12b's head_dim (256) over 16 heads and 8 kv heads, one sequence
FLASH_GEMMA3 = dict(b=1, s=1024, h=16, kv=8, d=256)
# The attention of the full-width minitron-4b backbone-GAN (b = m = 4
# sequences of 1024 tokens, 24 heads of 128 over 8), and of gemma3-12b's
# local layers on phase 5's 2 sequences of 2048 tokens, whose sliding
# window of 1024 keys masks a quarter of the causal pairs.
FLASH_MINITRON = dict(b=4, s=1024, h=24, kv=8, d=128)
FLASH_GEMMA3_LOCAL = dict(b=2, s=2048, h=16, kv=8, d=256)
GEMMA3_WINDOW = 1024
# The attention of phase 11's paths: granite-moe-3b-a800m (b = m = 4
# sequences of 1024 tokens, 24 heads of 64 over 8), zamba2-2.7b's shared
# block (11b's b = m = 4 sequences of 1,024 tokens, 32 heads of 80, as
# many kv heads; 11d's mode="prefill" call of 520 tokens) and
# mixtral-8x22b's one layer (48 heads of 128 over 8; 11c's check of 520
# tokens, then 8,192 tokens, its window of 4,096 keys binding)
FLASH_GRANITE_MOE = dict(b=4, s=1024, h=24, kv=8, d=64)
FLASH_ZAMBA2 = dict(b=4, s=1024, h=32, kv=32, d=80)
FLASH_ZAMBA2_PREFILL = dict(FLASH_ZAMBA2, b=1, s=520)
FLASH_MIXTRAL = dict(b=1, s=8192, h=48, kv=8, d=128)
FLASH_MIXTRAL_CHECK = dict(FLASH_MIXTRAL, s=520)
MIXTRAL_WINDOW = 4096
# The attention of phase 12's paths, each bidirectional but the vlm's
# self-attention: whisper-base's encoder over 1,500 frames and its
# decoder's cross-attention from 448 tokens to them (12a's b = m = 4; 8
# heads of 64; the decoder's causal self-attention, 448 x 448, stays
# below the flash threshold); llama-3.2-vision-90b's cross-attention
# from 2,048 tokens to 1,600 image tokens and its causal self-attention
# (12b, b = 1, 64 heads of 128 over 8); 12b's logits check at 520
# tokens; 12c's mode="prefill" calls: whisper's of 448 tokens (its
# encoder at b = 1) and llama-vision's of 600 tokens.
FLASH_WHISPER_ENC = dict(b=4, s=1500, t=1500, h=8, kv=8, d=64)
FLASH_WHISPER_CROSS = dict(b=4, s=448, t=1500, h=8, kv=8, d=64)
FLASH_VLM_CROSS = dict(b=1, s=2048, t=1600, h=64, kv=8, d=128)
FLASH_VLM_SELF = dict(b=1, s=2048, h=64, kv=8, d=128)
FLASH_COND_OTHER = (
    ("whisper_prefill_encoder", dict(FLASH_WHISPER_ENC, b=1), False),
    ("whisper_prefill_cross", dict(FLASH_WHISPER_CROSS, b=1), False),
    ("vlm_check_self", dict(FLASH_VLM_SELF, s=520), True),
    ("vlm_check_cross", dict(FLASH_VLM_CROSS, s=520), False),
    ("vlm_prefill_self", dict(FLASH_VLM_SELF, s=600), True),
    ("vlm_prefill_cross", dict(FLASH_VLM_CROSS, s=600), False))
# zamba2-2.7b's Mamba-2 layers on 11b's 4 sequences of 1,024 tokens: 80
# heads of 64 (d_inner 5,120), one group of 64 states
SSD_ZAMBA2 = dict(b=4, s=1024, h=80, p=64, g=1, n=64, chunk=128)
FLASH_ATOL, FLASH_ATOL_BF16 = 2e-5, 0.05   # as tests/test_kernels.py
# The backbone-GAN paths: full width, K = 4 devices, 4,096 tokens a
# batch; granite-3-2b's 40 layers cut to 4, so that K discriminators with
# Adam fit one card. sizes: (G, D) parameters; per_round: the launches
# of the path's kernel in a round.
MAMBA = dict(arch="mamba2-130m", k=4, n_d=2, n_g=2, m=8, seq=512,
             layers=24, sizes=(168_286_656, 129_574_080), per_round=528)
GRANITE = dict(arch="granite-3-2b", k=4, n_d=2, n_g=2, m=4, seq=1024,
               layers=4, sizes=(449_083_392, 348_153_856), per_round=88)
# minitron-4b at full width: 32 layers cut to 2 and the vocabulary of
# 256,000 to 32,768 (the synthetic token table is (8, vocab, vocab // 16)
# int64: 262 GB at the full vocabulary, 4.3 GB here), so that K
# discriminators with Adam fit one card beside the generator: K D + G
# = 1.75 G parameters, granite's path 1.84 G.
MINITRON = dict(arch="minitron-4b", k=4, n_d=2, n_g=2, m=4, seq=1024,
                layers=2, vocab=32_768, sizes=(431_373_312, 330_319_872),
                per_round=44)
# gemma3-12b at full width: one 5:1 group (5 windowed layers and a global
# one) of its 48 layers, the vocabulary cut to 32,768, 2 sequences of
# 2,048 tokens, forward and backward only. Its GAN round waits for
# tensor parallelism across cards or bf16 (ROADMAP A items 8 and 10):
# K=2 discriminators with float32 Adam need (2 D + G) x 16 B = 73 GB
# before activations.
GEMMA3 = dict(arch="gemma3-12b", layers=6, vocab=32_768, b=2, seq=2048,
              sizes=(1_611_747_072, 1_485_430_272))


def launches_per_round(bb):
    """One kernel launch per sublayer forward: n_d (L + 2 K L) + n_g 2 L
    (the generator once and K discriminators on real and fake per local
    step; generator and discriminator per server step)."""
    return (bb["n_d"] * (bb["layers"] + 2 * bb["k"] * bb["layers"])
            + bb["n_g"] * 2 * bb["layers"])


# The hostile-worker population of the full-width run.
HOSTILE = dict(n_devices=10, dropout_prob=0.1, n_free_riders=2,
               n_byzantine=2, byz_scale=10.0, straggler_factor=2.0, seed=0)


def time_ms(fn, inputs, reps=20, per_rep=12, warmup=3):
    """Milliseconds per call of `fn`, by CUDA events: the median over
    `reps` samples, each the mean of `per_rep` back-to-back calls (so
    the host's launch latency overlaps the device's work). Call i takes
    inputs[i % len(inputs)]: distinct buffers, so no call finds its
    input left in L2 by the call before."""
    import torch
    for i in range(warmup):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(per_rep):
            fn(*inputs[i % len(inputs)])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_rep)
    return statistics.median(times)


def check_wavg(torch, ops):
    """Kernel vs plain version at every listed shape; timings at both
    main-path shapes, the DCGAN's and the mamba2-130m backbone's.
    Returns the kernel's JSON entry (launches unset)."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(k, n):
        x = torch.randn((k, n), generator=gen, device="cuda")
        w = torch.rand(k, generator=gen, device="cuda")
        return x, w / w.sum()

    mains = [(K_MAIN, N_MAIN), (K_BACKBONE, N_BACKBONE),
             (K_BACKBONE, N_GRANITE), (K_BACKBONE, N_MINITRON)]
    # FedGAN's two nets as one flat payload: the mesh layout's all-gather
    shapes = mains + [(k, N_MAIN) for k in EXPERIMENT_K] + [
        (K_MAIN, N_FEDGAN)] + [(k, n) for k in EDGE_K for n in EDGE_N]
    max_err = {}
    for k, n in shapes:
        x, w = inputs(k, n)
        out = ops.weighted_average(x, w)
        torch.cuda.synchronize()
        ref = ops.wavg_ref(x, w)
        torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)
        max_err[(k, n)] = float((out - ref).abs().max())
        del x, w, out, ref
    print(f"wavg matches its plain version at {len(shapes)} shapes "
          f"(rtol {RTOL}, atol {ATOL}); max abs err "
          f"{max(max_err.values()):.3e}")

    timed = {}
    for k, n in mains:
        # three payloads, together well past the 50 MB L2
        main = [inputs(k, n) for _ in range(3)]
        kernel_ms = time_ms(ops.weighted_average, main)
        plain_ms = time_ms(ops.wavg_ref, main)
        library_ms = time_ms(lambda x, w: torch.matmul(w, x), main)
        n_bytes = (k * n + k + n) * 4
        flops = 2 * k * n
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        flops_ms = flops / F32_FLOPS_PER_S * 1e3
        print(f"wavg K={k} N={n}: kernel {kernel_ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, w @ x {library_ms:.4f} ms, bound "
              f"{max(bytes_ms, flops_ms):.4f} ms ({n_bytes} B); "
              f"{bytes_ms / kernel_ms:.3f} of HBM peak")
        timed[(k, n)] = dict(
            max_abs_err=max_err[(k, n)], ms=kernel_ms, plain_ms=plain_ms,
            bound_ms=max(bytes_ms, flops_ms),
            bound_by="bytes" if bytes_ms >= flops_ms else "operations",
            library_ms=library_ms)
        del main
    return {"name": "wavg", "route": "cuda",
            "source": "src/repro_torch/csrc/wavg.cu",
            "replaces": "src/repro/kernels/wavg/kernel.py:31",
            "launches": None, **timed[(K_MAIN, N_MAIN)],
            "backbone_shape": {"k": K_BACKBONE, "n": N_BACKBONE,
                               **timed[(K_BACKBONE, N_BACKBONE)]},
            "granite_shape": {"k": K_BACKBONE, "n": N_GRANITE,
                              **timed[(K_BACKBONE, N_GRANITE)]},
            "minitron_shape": {"k": K_BACKBONE, "n": N_MINITRON,
                               **timed[(K_BACKBONE, N_MINITRON)]}}


def check_trimmed(torch, ops):
    """The trimmed_wavg kernel against its plain version at the main
    paths' shapes and at edge shapes (dropped rows, duplicated rows,
    integer-valued rows whose ties the index rule breaks; N % 4 != 0 and
    a payload whose start is not 16-byte aligned, both on the kernel's
    scalar path), the honest-range property, and timings at both main
    shapes beside wavg's on the same payload. Returns the kernel's JSON
    entry (launches unset)."""
    gen = torch.Generator(device="cuda").manual_seed(1)

    def inputs(k, n, *, n_zero=0, ties=False):
        if ties:
            x = torch.randint(-2, 3, (k, n), generator=gen,
                              device="cuda").float()
        else:
            x = torch.randn((k, n), generator=gen, device="cuda")
        if k >= 3:
            x[k - 1] = x[k - 2]            # exact ties, as free-riders make
        w = torch.rand(k, generator=gen, device="cuda") + 0.5
        w[:n_zero] = 0.0
        return x, w

    cases = [((K_MAIN, N_MAIN), 2, 1, False), ((K_MAIN, N_FEDGAN), 1, 1,
                                                False),
             ((K_MAIN, N_MAIN + 2), 2, 1, False)]   # N % 4 != 0
    cases += [((k, N_MAIN), trim, 1, False) for k in EXPERIMENT_K
              for trim in (0, 1)]
    cases += [((k, n), trim, k // 4, trim == 3) for k in TRIM_EDGE_K
              for n in EDGE_N for trim in TRIM_EDGE]
    max_err = {}

    def check(key, x, w, trim):
        out = ops.trimmed_average(x, w, trim=trim)
        torch.cuda.synchronize()
        ref = ops.trimmed_mean_ref(x, w, trim)
        torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)
        max_err[key] = float((out - ref).abs().max())

    for (k, n), trim, n_zero, ties in cases:
        check((k, n, trim), *inputs(k, n, n_zero=n_zero, ties=ties), trim)
    # a contiguous payload that starts 4 bytes past a 16-byte boundary
    x, w = inputs(K_MAIN, N_MAIN, n_zero=1)
    carved = torch.empty(K_MAIN * N_MAIN + 1, device="cuda")[1:].view(
        K_MAIN, N_MAIN)
    carved.copy_(x)
    if carved.data_ptr() % 16 != 4:
        raise AssertionError("the carved payload is 16-byte aligned")
    check("unaligned", carved, w, 2)
    del x, carved
    print(f"trimmed_wavg matches its plain version at {len(cases) + 1} "
          f"shapes, K in {TRIM_EDGE_K}, one payload 4 bytes off 16-byte "
          f"alignment (rtol {RTOL}, atol {ATOL}); max abs err "
          f"{max(max_err.values()):.3e}")

    x = torch.randn((K_MAIN, N_MAIN), generator=gen, device="cuda")
    x[8:] *= 10.0                          # 2 hostile rows of 10 N(0, 1)
    out = ops.trimmed_average(x, torch.ones(K_MAIN, device="cuda"), trim=2)
    honest = x[:8]
    if not bool(((out >= honest.amin(0)) & (out <= honest.amax(0))).all()):
        raise AssertionError("trimmed mean left the honest rows' range")
    print("trimmed_wavg keeps every coordinate inside the 8 honest rows' "
          "range (2 rows of 10x noise, trim=2)")

    timed = {}
    for n, trim in ((N_MAIN, 2), (N_FEDGAN, 1)):
        # three payloads, together past the 50 MB L2; all rows take part
        main = [(torch.randn((K_MAIN, n), generator=gen, device="cuda"),
                 torch.ones(K_MAIN, device="cuda")) for _ in range(3)]
        kernel_ms = time_ms(lambda x, w: ops.trimmed_average(x, w,
                                                             trim=trim),
                            main)
        plain_ms = time_ms(lambda x, w: ops.trimmed_mean_ref(x, w, trim),
                           main)
        wavg_ms = time_ms(ops.wavg_ops.weighted_average,
                          [(x, w / w.sum()) for x, w in main])
        pairs = min(trim, (K_MAIN - 1) // 2)
        n_bytes = (K_MAIN * n + K_MAIN + n) * 4
        # per column: 2 * pairs passes of K compares, K multiply-adds,
        # K adds of the weights, one divide
        ops_count = n * (2 * pairs * K_MAIN + 3 * K_MAIN + 1)
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops_count / F32_FLOPS_PER_S * 1e3
        timed[n] = dict(ms=kernel_ms, plain_ms=plain_ms,
                        bound_ms=max(bytes_ms, ops_ms),
                        bound_by="bytes" if bytes_ms >= ops_ms
                        else "operations", wavg_ms=wavg_ms)
        print(f"trimmed_wavg K={K_MAIN} N={n} trim={trim}: kernel "
              f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{max(bytes_ms, ops_ms):.4f} ms ({n_bytes} B, {ops_count} "
              f"ops); {bytes_ms / kernel_ms:.3f} of HBM peak, wavg on the "
              f"same payload {wavg_ms:.4f} ms, {bytes_ms / wavg_ms:.3f}; no "
              f"single PyTorch call computes it")
        del main
    return {"name": "trimmed_wavg", "route": "cuda",
            "source": "src/repro_torch/csrc/trimmed_wavg.cu",
            "replaces": "src/repro/kernels/robust_avg/kernel.py:68",
            "launches": None,
            "max_abs_err": max(max_err[(K_MAIN, N_MAIN, 2)],
                               max_err[(K_MAIN, N_FEDGAN, 1)]),
            **timed[N_MAIN], "library_ms": None,
            "fedgan_shape": {"n": N_FEDGAN, "trim": 1, **timed[N_FEDGAN]}}


def ssd_inputs(torch, gen, b, s, h, p, g, n, *, x_dtype=None,
               bc_dtype=None, bc_scale=None, strided=False):
    """x, dt (softplus of normals), A (negative), B, C on the card, the
    distribution of tests/test_kernels.py::TestSSDScan (n = 8) carried to
    any n: B and C are scaled by (8 / n) ** 0.5 by default, so the scores
    C.B^T, and with them |y|, keep that test's spread and its absolute
    tolerance keeps its meaning. strided=True slices x, B and C out of
    one (b, s, h*p + 2*g*n) tensor, as the mixer does; x_dtype and
    bc_dtype cast x and B, C (the launch step's are all bfloat16)."""
    if bc_scale is None:
        bc_scale = (8 / n) ** 0.5
    x_dtype, bc_dtype = (getattr(torch, t) if isinstance(t, str) else t
                         for t in (x_dtype, bc_dtype))
    f = functools.partial(torch.randn, generator=gen, device="cuda")
    if strided:
        xbc = f((b, s, h * p + 2 * g * n))
        x = xbc[..., :h * p].reshape(b, s, h, p)
        B = xbc[..., h * p:h * p + g * n].reshape(b, s, g, n)
        C = xbc[..., h * p + g * n:].reshape(b, s, g, n)
    else:
        x, B, C = f((b, s, h, p)), f((b, s, g, n)), f((b, s, g, n))
    if x_dtype is not None:
        x = x.to(x_dtype)
    dt = torch.nn.functional.softplus(f((b, s, h)))
    A = -torch.exp(f((h,)) * 0.4)
    B, C = B * bc_scale, C * bc_scale
    if bc_dtype is not None:
        B, C = B.to(bc_dtype), C.to(bc_dtype)
    return x, dt, A, B, C


def check_ssd(torch, ops, ref, ssm):
    """The ssd_scan kernel against its plain version (the sequential
    recurrence) at the main path's shape, with and without the final
    state, and at the edges of its design: one chunk, many chunks (s =
    2048 at chunk 16 and 128), a ragged last chunk, two heads a group,
    p = 32 and 128, bfloat16 x at the main shape; timings of the kernel,
    the plain version and the port's chunked torch scan at the main
    shape. Returns the kernel's JSON entry (launches unset)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    edge = [dict(b=2, s=s, h=4, p=64, g=1, n=64, chunk=128)
            for s in (1, 100, 129, 512)]
    edge += [dict(b=2, s=200, h=4, p=64, g=1, n=64, chunk=c)
             for c in (16, 64, 128)]
    edge += [dict(b=1, s=2048, h=2, p=64, g=1, n=128, chunk=c)
             for c in (16, 128)]
    edge += [dict(b=2, s=160, h=4, p=64, g=g, n=64, chunk=128)
             for g in (1, 2)]
    edge += [dict(b=2, s=160, h=4, p=p, g=1, n=n, chunk=128)
             for p in (32, 64, 128) for n in (16, 64, 128)]
    edge += [dict(b=1, s=300, h=4, p=64, g=2, n=128, chunk=128),
             dict(b=1, s=200, h=2, p=64, g=1, n=36, chunk=48),
             dict(b=1, s=200, h=2, p=64, g=1, n=160, chunk=64)]
    cases = [(SSD_MAIN, dict(strided=True))] + [(c, {}) for c in edge]
    # bfloat16 x: B and C scaled by n ** -0.5 keep |y| below 8, where
    # bfloat16's spacing (<= 1/16) stays within the tolerance; y is
    # rounded to bfloat16 on both sides
    cases += [(dict(b=2, s=200, h=4, p=64, g=2, n=64, chunk=64),
               dict(x_dtype=torch.bfloat16, bc_scale=64 ** -0.5)),
              (SSD_MAIN, dict(x_dtype=torch.bfloat16, bc_scale=128 ** -0.5,
                              strided=True)),
              (SSD_MAIN, LAUNCH_SSD),
              (SSD_ZAMBA2, dict(strided=True))]
    max_err, failed = {}, []
    for i, (shape, kw) in enumerate(cases):
        shape = dict(shape)
        chunk = shape.pop("chunk")
        args = ssd_inputs(torch, gen, **shape, **kw)
        atol = SSD_ATOL if args[0].dtype == torch.float32 else SSD_ATOL_BF16
        y_plain, st_plain = ref.ssd_scan_plain(*args, chunk=chunk,
                                               return_final_state=True)
        y, st = ops.ssd_scan(*args, chunk=chunk, return_final_state=True)
        y_only = ops.ssd_scan(*args, chunk=chunk)
        torch.cuda.synchronize()
        if y.dtype != args[0].dtype or st.dtype != torch.float32:
            raise AssertionError(f"ssd_scan dtypes {y.dtype}, {st.dtype}")
        max_err[i] = max(float((got.float() - want.float()).abs().max())
                         for got, want in ((y, y_plain), (y_only, y_plain),
                                           (st, st_plain)))
        ok = max_err[i] <= atol      # False for NaN too
        print(f"  ssd_scan {shape} chunk {chunk} {args[0].dtype}"
              f"{' strided' if kw.get('strided') else ''}: max abs err "
              f"{max_err[i]:.3e} (atol {atol}){'' if ok else '  FAILED'}")
        if not ok:
            failed.append(i)
    if failed:
        raise AssertionError(f"ssd_scan disagrees with its plain version at "
                             f"cases {failed}")
    print(f"ssd_scan matches its plain version at {len(cases)} shapes, y "
          f"and final state (atol {SSD_ATOL} f32, {SSD_ATOL_BF16} bf16); "
          f"max abs err {max(max_err.values()):.3e}, at the main shape "
          f"{max_err[0]:.3e}")

    main = time_ssd(torch, ops, ref, ssm, gen, SSD_MAIN, "main")
    launch = time_ssd(torch, ops, ref, ssm, gen, SSD_MAIN,
                      "main, bf16 x, B and C (the launch step's)",
                      **{k: v for k, v in LAUNCH_SSD.items()
                         if k != "strided"})
    zamba2 = time_ssd(torch, ops, ref, ssm, gen, SSD_ZAMBA2, "zamba2-2.7b")
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan/kernel.py:81",
            "launches": None, "max_abs_err": max_err[0], **main,
            "main_bf16_shape": {**SSD_MAIN, "dtype": "bfloat16", **launch,
                                "max_abs_err": max_err[len(cases) - 2]},
            "zamba2_shape": {**SSD_ZAMBA2, **zamba2,
                             "max_abs_err": max_err[len(cases) - 1]}}


def time_ssd(torch, ops, ref, ssm, gen, shape, label, **kw):
    """The ssd_scan kernel at `shape` (no final state) timed beside the
    plain version (the sequential recurrence), the port's chunked torch
    scan and the bounds, and its four CUDA kernels' device times; `kw`
    goes to `ssd_inputs` (the launch step's bfloat16 x, B and C)."""
    main = dict(shape)
    chunk = main.pop("chunk")
    # three input sets (x, dt, B, C; ~31 MB each at the main shape),
    # together past L2
    sets = [ssd_inputs(torch, gen, **main, strided=True, **kw)
            for _ in range(3)]
    kernel_ms = time_ms(lambda *a: ops.ssd_scan(*a, chunk=chunk), sets)
    torch_ms = time_ms(lambda *a: ssm.ssd_scan_ref(*a, chunk=chunk), sets,
                       reps=5, per_rep=3, warmup=1)
    plain_ms = time_ms(lambda *a: ref.ssd_scan_plain(*a, chunk=chunk), sets,
                       reps=3, per_rep=1, warmup=1)
    b, s, h, p, g, n = (main[k] for k in "b s h p g n".split())
    n_chunks = -(-s // chunk)
    # bytes: x, y, dt, A, B and C once each, no repeat of B and C (x, y,
    # B and C in their own dtype; dt and A float32)
    xb, bcb = (sets[0][0].element_size(), sets[0][3].element_size())
    n_bytes = (2 * xb * b * s * h * p + 4 * (b * s * h + h)
               + 2 * bcb * b * s * g * n)
    # operations: the least this call (no final state) needs: for every
    # chunk the causal triangle of C.B^T once per group and of the
    # score-times-x product per head; per head, C.state for every chunk
    # but the first (its state is zero) and the state update for every
    # chunk but the last (nothing reads it)
    tri = chunk * (chunk + 1) // 2
    flops = b * (n_chunks * (2 * tri * n * g + h * 2 * tri * p)
                 + h * 2 * (n_chunks - 1) * 2 * chunk * n * p)
    # the TPU kernel's algorithm: full L x L blocks, C.B^T per head
    flops_tpu = b * h * n_chunks * (2 * chunk * chunk * (n + p)
                                    + 4 * chunk * n * p)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / F32_FLOPS_PER_S * 1e3
    simt_ms = max(bytes_ms, flops_ms)
    tc_ms = max(bytes_ms, TF32X3_PASSES * flops / TF32_FLOPS_PER_S * 1e3)
    bf16_ms = max(bytes_ms, flops / BF16_FLOPS_PER_S * 1e3)
    print(f"ssd_scan {label} b={b} s={s} h={h} p={p} g={g} n={n} "
          f"chunk={chunk}: "
          f"kernel {kernel_ms:.4f} ms, plain (sequential) {plain_ms:.4f} ms, "
          f"chunked torch scan {torch_ms:.4f} ms; bounds: f32 SIMT "
          f"{simt_ms:.4f} ms ({n_bytes} B = {bytes_ms:.4f} ms, {flops} flop "
          f"= {flops_ms:.4f} ms), f32-accurate tensor core {tc_ms:.4f} ms "
          f"(3 TF32 passes); the TPU kernel's algorithm {flops_tpu} flop = "
          f"{flops_tpu / F32_FLOPS_PER_S * 1e3:.4f} ms; "
          f"{flops / kernel_ms / 1e9:.3f} TFLOP/s, {tc_ms / kernel_ms:.3f} "
          f"of the tensor-core bound; the bf16 tensor-core bound "
          f"{bf16_ms:.4f} ms ({bf16_ms / kernel_ms:.3f} of it)")
    by_kernel = kernel_device_ms(
        torch, lambda *a: ops.ssd_scan(*a, chunk=chunk), sets, SSD_KERNELS)
    print(f"ssd_scan's kernels at {label}, device time a launch "
          f"(profiler): " + ", ".join(
        f"{name} {'not seen' if ms is None else f'{ms:.4f} ms'}"
        for name, ms in by_kernel.items()))
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": tc_ms,
            "bound_by": "bytes" if tc_ms == bytes_ms else "operations",
            "library_ms": None, "bound_f32_simt_ms": simt_ms,
            "bound_bf16_ms": bf16_ms, "chunked_torch_ms": torch_ms,
            "kernels_device_ms": by_kernel}


def flash_inputs(torch, gen, b, s, h, kv, d, *, t=None, dtype=None,
                 strided=False, unaligned=False):
    """q (b, s, h, d), k, v (b, t, kv, d) (t = s by default) standard
    normal on the card, as tests/test_kernels.py::TestFlashAttn draws
    them. strided=True slices them out of one (b, s, h + 2 kv, d) tensor
    (t = s); unaligned=True starts q one element past a 16-byte boundary
    (the wrapper copies it)."""
    f = functools.partial(torch.randn, generator=gen, device="cuda")
    t = s if t is None else t
    if strided:
        qkv = f((b, s, h + 2 * kv, d))
        q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kv], qkv[:, :, h + kv:]
    else:
        q, k, v = f((b, s, h, d)), f((b, t, kv, d)), f((b, t, kv, d))
    if dtype is not None:
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    if unaligned:
        q = torch.empty(q.numel() + 1, dtype=q.dtype,
                        device="cuda")[1:].view(q.shape).copy_(q)
    return q, k, v


def causal_pairs(s, window=None):
    """The (query, key) pairs of a causal call over s positions: query i
    sees i + 1 keys, or the last `window` of them."""
    w = s if window is None else min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def flash_cost(b, s, h, kv, d, window=None, t=None, causal=True):
    """(bytes, flop) of one call of s queries over t keys (t = s by
    default): q, k, v, out and lse once each; the (row, key) pairs it
    computes, 2 D flops each of q.k and of p.v: the causal pairs (inside
    the window) of a causal call, all s t of a bidirectional one."""
    t = s if t is None else t
    pairs = causal_pairs(s, window) if causal else s * t
    return (4 * (2 * b * s * h * d + 2 * b * t * kv * d + b * h * s),
            4 * b * h * d * pairs)


def flash_bounds(n_bytes, flops):
    """(f32 SIMT bound, f32-accurate tensor-core bound) in ms: the bytes'
    time or the flops at 67 TFLOP/s f32, or as three TF32 passes at 495
    TFLOP/s, whichever is larger."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return (max(bytes_ms, flops / F32_FLOPS_PER_S * 1e3),
            max(bytes_ms, TF32X3_PASSES * flops / TF32_FLOPS_PER_S * 1e3))


def check_flash(torch, ops, ref):
    """The flash_attn kernel, out and lse, against its plain version (the
    port's blockwise flash_ref) at the main path's shape and at edge
    shapes, D 32 to 256; the wrapper's refusal of another head_dim;
    timings of the kernel, the plain version and PyTorch's
    scaled_dot_product_attention (never called by the port; held to the
    plain version first, a window as an explicit boolean mask) at the
    main shape, qwen3-1.7b's heads, gemma3-12b's (D 256), minitron-4b's
    and gemma3-12b's windowed local layers. Returns the kernel's JSON
    entry (launches unset)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    small = dict(b=2, h=4, kv=2, d=64)
    bf16 = torch.bfloat16
    cases = [(FLASH_MAIN, {}), (dict(FLASH_MAIN, b=1), dict(strided=True)),
             (FLASH_MAIN, dict(dtype=bf16))]   # the launch step's (13a)
    cases += [(dict(small, s=s), {}) for s in (1, 63, 64, 65, 520)]
    cases += [(dict(small, s=200, d=d), {}) for d in (32, 64, 128, 256)]
    cases += [(dict(small, s=130, h=h, kv=kv), {})
              for h, kv in ((4, 4), (8, 2))]
    cases += [(dict(small, s=300), dict(window=w)) for w in (9, 100)]
    cases += [(dict(small, s=200), dict(causal=False)),
              (dict(small, s=200), dict(causal=False, window=50))]
    cases += [(dict(small, s=200), dict(dtype=bf16)),
              (dict(small, s=200, d=128), dict(dtype=bf16, window=9)),
              (dict(FLASH_MAIN, b=1), dict(dtype=bf16)),
              (FLASH_QWEN3, {})]
    # head_dim 256 (gemma3-12b): causal, windowed, bidirectional, ragged
    # last tiles, bf16, strided
    cases += [(dict(small, s=300, d=256), dict(window=100)),
              (dict(small, s=77, d=256), dict(causal=False)),
              (dict(small, s=131, d=256), dict(dtype=bf16)),
              (dict(small, s=200, d=256), dict(dtype=bf16, window=9)),
              (dict(FLASH_GEMMA3, s=257), dict(strided=True))]
    cases += [(dict(small, s=100), dict(unaligned=True))]
    # head_dim 80 (zamba2-2.7b): causal, windowed, bidirectional, ragged
    # last tiles, GQA, bf16, strided; phase 11's shapes: granite-moe-3b-
    # a800m's, mixtral-8x22b's 520 and 8,192 tokens in its window of
    # 4,096, zamba2-2.7b's prefill and round
    cases += [(dict(small, s=200, d=80), {}),
              (dict(small, s=300, d=80), dict(window=100)),
              (dict(small, s=77, d=80), dict(causal=False)),
              (dict(small, s=130, h=8, kv=2, d=80), {}),
              (dict(small, s=131, d=80), dict(dtype=bf16)),
              (dict(FLASH_ZAMBA2, b=1, s=257), dict(strided=True)),
              (FLASH_GRANITE_MOE, {}),
              (FLASH_MIXTRAL_CHECK, dict(window=MIXTRAL_WINDOW)),
              (FLASH_MIXTRAL, dict(window=MIXTRAL_WINDOW)),
              (FLASH_ZAMBA2_PREFILL, {}),
              (FLASH_ZAMBA2, {})]
    # key lengths of their own (t != s, query i and key j at positions i
    # and j): t < s, t > s, ragged, one key and below one key tile, causal
    # and windowed (every query sees a key), bf16, and at each head_dim
    # bidirectional and causal in bf16
    cross_from = len(cases)
    cases += [(dict(small, s=200, t=77), dict(causal=False)),
              (dict(small, s=100, t=300), dict(causal=False)),
              (dict(small, s=130, t=131), dict(causal=False)),
              (dict(small, s=150, t=5), dict(causal=False)),
              (dict(small, s=64, t=1), dict(causal=False)),
              (dict(small, s=200, t=90), {}),
              (dict(small, s=90, t=200), {}),
              (dict(small, s=120, t=300), dict(window=50)),
              (dict(small, s=200, t=150), dict(window=100)),
              (dict(small, s=100, t=257), dict(causal=False, dtype=bf16))]
    cases += [(dict(small, s=70, t=150, d=d), dict(causal=False))
              for d in ops.HEAD_DIMS]
    cases += [(dict(small, s=150, t=45, d=d), dict(dtype=bf16))
              for d in ops.HEAD_DIMS]
    # phase 12's shapes: whisper-base's encoder and cross-attention,
    # llama-3.2-vision-90b's cross- and self-attention, the logits check
    # and the serving prefills
    cond = [("whisper_encoder", FLASH_WHISPER_ENC, False),
            ("whisper_cross", FLASH_WHISPER_CROSS, False),
            ("vlm_cross", FLASH_VLM_CROSS, False),
            ("vlm_self", FLASH_VLM_SELF, True), *FLASH_COND_OTHER]
    cases += [(shape, {} if causal else dict(causal=False))
              for _, shape, causal in cond]
    cross_to = len(cases)
    # minitron-4b's shape; gemma3-12b's local layers, where the window
    # bites
    cases += [(FLASH_MINITRON, {}),
              (FLASH_GEMMA3_LOCAL, dict(window=GEMMA3_WINDOW))]
    max_err = {}
    for i, (shape, kw) in enumerate(cases):
        kw = dict(kw)
        causal, window = kw.pop("causal", True), kw.pop("window", None)
        q, k, v = flash_inputs(torch, gen, **shape, **kw)
        out, lse = ops._kernel_forward(q, k, v, causal, window)
        torch.cuda.synchronize()
        out_plain, lse_plain = ref.flash_attention_plain(
            q, k, v, causal=causal, window=window)
        atol = FLASH_ATOL if q.dtype == torch.float32 else FLASH_ATOL_BF16
        for got, want in ((out, out_plain), (lse, lse_plain)):
            if got.dtype != torch.float32 or got.shape != want.shape:
                raise AssertionError(f"flash_attn gave {got.dtype} "
                                     f"{tuple(got.shape)}")
            torch.testing.assert_close(got, want, rtol=0, atol=atol)
        max_err[i] = max(float((out - out_plain).abs().max()),
                         float((lse - lse_plain).abs().max()))
        del q, k, v, out, lse, out_plain, lse_plain
    d256, d80 = ([e for i, e in max_err.items() if cases[i][0]["d"] == d]
                 for d in (256, 80))
    cross_err = max(max_err[i] for i in range(cross_from, cross_to))
    print(f"flash_attn matches its plain version at {len(cases)} shapes, out "
          f"and lse (atol {FLASH_ATOL} f32, {FLASH_ATOL_BF16} bf16); max abs "
          f"err {max(max_err.values()):.3e}, at the main shape "
          f"{max_err[0]:.3e}, at D 256 {max(d256):.3e}, at D 80 "
          f"{max(d80):.3e}, at the {cross_to - cross_from} shapes with a key "
          f"length of their own (phase 12's among them) {cross_err:.3e}")
    cond_err = {}
    for name, shape, causal in cond:
        cond_err[name] = max_err[cases.index(
            (shape, {} if causal else dict(causal=False)))]
        print(f"  flash_attn {name} {shape} "
              f"{'causal' if causal else 'bidirectional'}: max abs err "
              f"{cond_err[name]:.3e}")
    zoo_err = {name: max_err[cases.index((shape, kw))] for name, shape, kw in
               (("zamba2", FLASH_ZAMBA2, {}),
                ("zamba2_prefill", FLASH_ZAMBA2_PREFILL, {}),
                ("granite_moe", FLASH_GRANITE_MOE, {}),
                ("mixtral", FLASH_MIXTRAL, dict(window=MIXTRAL_WINDOW)),
                ("mixtral_check", FLASH_MIXTRAL_CHECK,
                 dict(window=MIXTRAL_WINDOW)))}
    try:
        ops._kernel_forward(*flash_inputs(torch, gen, **dict(small, s=8,
                                                              d=96)),
                            True, None)
    except ValueError as err:
        print(f"flash_attn refuses head_dim 96: {err}")
    else:
        raise AssertionError("flash_attn took head_dim 96")

    sdpa = torch.nn.functional.scaled_dot_product_attention
    timed = {}
    for name, shape, window, causal, dtype in (
            ("main", FLASH_MAIN, None, True, None),
            ("main_bf16", FLASH_MAIN, None, True, bf16),
            ("qwen3", FLASH_QWEN3, None, True, None),
            ("gemma3", FLASH_GEMMA3, None, True, None),
            ("minitron", FLASH_MINITRON, None, True, None),
            ("gemma3_local", FLASH_GEMMA3_LOCAL, GEMMA3_WINDOW, True, None),
            ("zamba2", FLASH_ZAMBA2, None, True, None),
            ("whisper_encoder", FLASH_WHISPER_ENC, None, False, None),
            ("whisper_cross", FLASH_WHISPER_CROSS, None, False, None),
            ("vlm_cross", FLASH_VLM_CROSS, None, False, None)):
        b, s, h, kv, d = (shape[key] for key in "b s h kv d".split())
        t = shape.get("t", s)
        # three input sets, together past L2
        sets = [flash_inputs(torch, gen, **shape, dtype=dtype)
                for _ in range(3)]
        kernel_ms = time_ms(lambda q, k, v: ops._kernel_forward(
            q, k, v, causal, window), sets)
        plain_ms = time_ms(lambda q, k, v: ref.flash_attention_plain(
            q, k, v, causal=causal, window=window), sets, reps=5,
            per_rep=3, warmup=1)
        heads_first = [tuple(x.transpose(1, 2).contiguous() for x in qkv)
                       for qkv in sets]
        if window is None:
            library = functools.partial(sdpa, is_causal=causal,
                                        enable_gqa=True)
        else:    # SDPA takes a window as an explicit boolean mask
            pos = torch.arange(s, device="cuda")
            band = ((pos[None, :] <= pos[:, None])
                    & (pos[None, :] > pos[:, None] - window))
            library = functools.partial(sdpa, attn_mask=band,
                                        enable_gqa=True)
        # the library call computes the same function (in bf16 to the
        # kernel's bf16 tolerance: SDPA's output is bf16)
        torch.testing.assert_close(
            library(*heads_first[0]).transpose(1, 2).float(),
            ref.flash_attention_plain(*sets[0], causal=causal,
                                      window=window)[0],
            rtol=0, atol=1e-4 if dtype is None else FLASH_ATOL_BF16)
        library_ms = time_ms(library, heads_first)
        n_bytes, flops = flash_cost(b, s, h, kv, d, window, t, causal)
        if dtype is not None:     # q, k and v in 2 bytes; out, lse in 4
            n_bytes -= 2 * (b * s * h * d + 2 * b * t * kv * d)
        simt_ms, tc_ms = flash_bounds(n_bytes, flops)
        bf16_ms = max(n_bytes / HBM_BYTES_PER_S * 1e3,
                      flops / BF16_FLOPS_PER_S * 1e3)
        print(f"flash_attn {name} b={b} s={s} t={t} H={h} KV={kv} D={d} "
              f"{'causal' if causal else 'bidirectional'}"
              f"{'' if window is None else f' window {window}'} "
              f"{'f32' if dtype is None else 'bf16'}: kernel "
              f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
              f"{library_ms:.4f} ms; {flops} flop, {n_bytes} B: "
              f"{flops / kernel_ms / 1e9:.3f} TFLOP/s; the f32 SIMT bound "
              f"{simt_ms:.4f} ms ({simt_ms / kernel_ms:.3f} of it), the "
              f"f32-accurate tensor-core bound (3 TF32 passes) {tc_ms:.4f} "
              f"ms ({tc_ms / kernel_ms:.3f} of it), the bf16 tensor-core "
              f"bound {bf16_ms:.4f} ms ({bf16_ms / kernel_ms:.3f} of it)")
        timed[name] = dict(
            ms=kernel_ms, plain_ms=plain_ms, bound_ms=tc_ms,
            bound_by="bytes" if tc_ms == n_bytes / HBM_BYTES_PER_S * 1e3
            else "operations", library_ms=library_ms,
            bound_f32_simt_ms=simt_ms, bound_bf16_ms=bf16_ms)
        del sets, heads_first
    return {"name": "flash_attn", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attn.cu",
            "replaces": "src/repro/kernels/flash_attn/kernel.py:83",
            "launches": None, "max_abs_err": max_err[0], **timed["main"],
            "main_bf16_shape": {**FLASH_MAIN, "dtype": "bfloat16",
                                **timed["main_bf16"], "max_abs_err":
                                max_err[cases.index(
                                    (FLASH_MAIN, dict(dtype=bf16)))]},
            "qwen3_shape": {**FLASH_QWEN3, **timed["qwen3"]},
            "gemma3_shape": {**FLASH_GEMMA3, **timed["gemma3"]},
            "minitron_shape": {**FLASH_MINITRON, **timed["minitron"],
                               "max_abs_err": max_err[len(cases) - 2]},
            "gemma3_local_shape": {**FLASH_GEMMA3_LOCAL,
                                   "window": GEMMA3_WINDOW,
                                   **timed["gemma3_local"],
                                   "max_abs_err": max_err[len(cases) - 1]},
            "zamba2_shape": {**FLASH_ZAMBA2, **timed["zamba2"],
                             "max_abs_err": zoo_err["zamba2"]},
            "zamba2_prefill_shape": {**FLASH_ZAMBA2_PREFILL,
                                     "max_abs_err": zoo_err["zamba2_prefill"]},
            "granite_moe_shape": {**FLASH_GRANITE_MOE,
                                  "max_abs_err": zoo_err["granite_moe"]},
            "mixtral_shape": {**FLASH_MIXTRAL, "window": MIXTRAL_WINDOW,
                              "max_abs_err": zoo_err["mixtral"]},
            "mixtral_check_shape": {**FLASH_MIXTRAL_CHECK,
                                    "window": MIXTRAL_WINDOW,
                                    "max_abs_err": zoo_err["mixtral_check"]},
            "key_length_of_its_own_max_abs_err": cross_err,
            **{f"{name}_shape": {**shape, "causal": causal,
                                 **timed.get(name, {}),
                                 "max_abs_err": cond_err[name]}
               for name, shape, causal in cond}}


@contextlib.contextmanager
def launching(kernel_ops, fn):
    """kernel_ops' wrapper, launching `fn` (an entry point of the same C
    signature) in place of its own library's."""
    own = kernel_ops._kernel
    kernel_ops._kernel = lambda: fn
    try:
        yield
    finally:
        kernel_ops._kernel = own


def compare_with_parent(torch, parent, flash_ops, robust_ops):
    """The flash_attn and trimmed_wavg kernels of another checkout (their
    C entry points as this checkout's), built from `parent`/src/
    repro_torch/csrc, timed beside this checkout's through the same
    wrappers on the same inputs, in turns: parent, this, this, parent."""
    from repro_torch.kernels._build import load_library
    csrc = os.path.join(os.path.abspath(parent), "src", "repro_torch", "csrc")

    def entry(kernel_ops, name, symbol):
        fn = getattr(load_library(f"{name}_parent",
                                  (os.path.join(csrc, f"{name}.cu"),)),
                     symbol)
        own = kernel_ops._kernel()
        fn.argtypes, fn.restype = own.argtypes, own.restype
        return fn

    gen = torch.Generator(device="cuda").manual_seed(7)
    flash_parent = entry(flash_ops, "flash_attn", "flash_attn")
    import re
    with open(os.path.join(csrc, "flash_attn.cu")) as f:
        parent_takes_t = re.search(r"int s,\s*int t,", f.read()) is not None
    if not parent_takes_t:
        # a parent from before the key length of its own: its entry point
        # has no `t` (argument 8), and takes t = s
        own = flash_ops._kernel()
        flash_parent.argtypes = own.argtypes[:8] + own.argtypes[9:]

        def flash_parent(*args, _fn=flash_parent):
            if args[7] != args[8]:
                raise ValueError("the parent's flash_attn takes t = s")
            return _fn(*args[:8], *args[9:])
    trimmed_parent = entry(robust_ops, "trimmed_wavg", "trimmed_wavg_f32")
    runs = []
    for name, shape in (("main", FLASH_MAIN), ("qwen3", FLASH_QWEN3)):
        runs.append((f"flash_attn {name} {shape}", flash_ops, flash_parent,
                     functools.partial(flash_ops._kernel_forward,
                                       causal=True, window=None),
                     [flash_inputs(torch, gen, **shape) for _ in range(3)],
                     FLASH_ATOL))
    for n, trim in ((N_MAIN, 2), (N_FEDGAN, 1)):
        runs.append((f"trimmed_wavg K={K_MAIN} N={n} trim={trim}",
                     robust_ops, trimmed_parent,
                     functools.partial(robust_ops.trimmed_average, trim=trim),
                     [(torch.randn((K_MAIN, n), generator=gen, device="cuda"),
                       torch.ones(K_MAIN, device="cuda")) for _ in range(3)],
                     ATOL))
    for label, kernel_ops, parent_fn, run, sets, atol in runs:
        with launching(kernel_ops, parent_fn):
            before = run(*sets[0])
        # each is held to the plain version at atol; so they agree at 2 atol
        torch.testing.assert_close(run(*sets[0]), before, rtol=RTOL,
                                   atol=2 * atol)
        times = {"parent": [], "this": []}
        for who in ("parent", "this", "this", "parent"):
            if who == "parent":
                with launching(kernel_ops, parent_fn):
                    times[who].append(time_ms(run, sets))
            else:
                times[who].append(time_ms(run, sets))
        print(f"{label}: parent {times['parent'][0]:.4f} "
              f"{times['parent'][1]:.4f} ms, this checkout "
              f"{times['this'][0]:.4f} {times['this'][1]:.4f} ms (parent, "
              f"this, this, parent); outputs agree")
        del sets


def check_backbone_round_against_cpu(torch, kernel_ops, kernel, cfg, seq):
    """One backbone-GAN round (SGD, K=3) of a reduced config on the card
    and on the CPU from the same weights and draws. The card's round
    (the sublayers' kernel forward, wavg) must agree with the CPU's
    (plain versions) to float32 round-off, or to one quantization step
    where a stochastic rounding flips; the kernel launches once per
    sublayer forward."""
    from repro_torch.configs import ProtocolConfig
    from repro_torch.core import protocol
    from repro_torch.models import gan
    from repro_torch.models.specs import make_backbone_spec
    from repro_torch.tree import tree_leaves

    k = 3
    spec = make_backbone_spec(cfg, seq, remat=False,
                              gen_loss_variant="nonsaturating")
    pcfg = ProtocolConfig(n_devices=k, n_d=2, n_g=2, sample_size=4,
                          server_sample_size=4, lr_d=1e-3, lr_g=1e-3)
    gen = torch.Generator().manual_seed(4)
    params = gan.gan_init(gen, cfg)
    data = torch.randint(0, cfg.vocab, (k, 8, seq), generator=gen)
    n_params = protocol.count_params(params["disc"])
    draws = protocol.DrawSampler(spec, pcfg, seed=4, n_local=8,
                                 n_params=n_params, device="cpu")(0)
    weights = torch.tensor([4.0, 0.0, 4.0])
    out = {}
    for dev in ("cpu", "cuda"):
        state = protocol.make_train_state(lambda g: params, pcfg, k,
                                          device=dev)
        moved = protocol.RoundDraws(
            *(None if t is None else t.to(dev) for t in
              (draws.z_dev, draws.z_srv, draws.idx, draws.quant_u)))
        before = kernel_ops.launches
        out[dev] = protocol.gan_round(spec, pcfg, state, data.to(dev),
                                      weights.to(dev), moved)
    torch.cuda.synchronize()
    launched = kernel_ops.launches - before
    (s_cpu, m_cpu), (s_gpu, m_gpu) = out["cpu"], out["cuda"]
    for a, b in zip(tree_leaves(s_cpu["disc"]), tree_leaves(s_gpu["disc"])):
        step = float(a.abs().max()) / 32767
        torch.testing.assert_close(b.cpu(), a, rtol=0, atol=step + 1e-5)
    for a, b in zip(tree_leaves(s_cpu["gen"]), tree_leaves(s_gpu["gen"])):
        torch.testing.assert_close(b.cpu(), a, rtol=0, atol=1e-5)
    for key in m_cpu:
        torch.testing.assert_close(m_gpu[key].cpu(), m_cpu[key], rtol=0,
                                   atol=1e-5)
    layers = cfg.n_layers
    want = pcfg.n_d * (layers + 2 * k * layers) + pcfg.n_g * 2 * layers
    if launched != want:
        raise AssertionError(f"{launched} {kernel} launches in the small "
                             f"round, expected {want}")
    print(f"small backbone-GAN round on the card ({cfg.name} reduced, "
          f"seq_len {seq}: {launched} {kernel} launches) matches the CPU "
          f"round (D objective {float(m_gpu['disc_objective']):+.6f})")


def check_round_against_cpu(torch):
    """One small protocol round on the card and on the CPU, same
    weights and draws: the card's round (wavg kernel, cuDNN) must agree
    with the CPU's (plain version) to float32 round-off, or to one
    quantization step where a stochastic rounding flips."""
    from repro_torch.configs import DCGANConfig, ProtocolConfig
    from repro_torch.core import protocol
    from repro_torch.models import dcgan
    from repro_torch.models.specs import make_dcgan_spec
    from repro_torch.tree import tree_leaves

    cfg = DCGANConfig(nz=16, ngf=8, ndf=8, nc=3, image_size=16)
    spec = make_dcgan_spec(cfg)
    pcfg = ProtocolConfig(n_devices=4, n_d=2, n_g=2, sample_size=16,
                          server_sample_size=16, lr_d=1e-3, lr_g=1e-3)
    gen = torch.Generator().manual_seed(1)
    params = dcgan.gan_init(gen, cfg)
    data = torch.rand((4, 32, 16, 16, 3), generator=gen) * 2 - 1
    n_params = protocol.count_params(params["disc"])
    draws = protocol.DrawSampler(spec, pcfg, seed=1, n_local=32,
                                 n_params=n_params, device="cpu")(0)
    weights = torch.tensor([16.0, 0.0, 16.0, 16.0])

    out = {}
    for dev in ("cpu", "cuda"):
        state = protocol.make_train_state(lambda g: params, pcfg, 4,
                                          device=dev)
        moved = protocol.RoundDraws(
            *(None if t is None else t.to(dev) for t in
              (draws.z_dev, draws.z_srv, draws.idx, draws.quant_u)))
        out[dev] = protocol.gan_round(spec, pcfg, state, data.to(dev),
                                      weights.to(dev), moved)
    torch.cuda.synchronize()
    (s_cpu, m_cpu), (s_gpu, m_gpu) = out["cpu"], out["cuda"]
    for a, b in zip(tree_leaves(s_cpu["disc"]), tree_leaves(s_gpu["disc"])):
        step = float(a.abs().max()) / 32767
        torch.testing.assert_close(b.cpu(), a, rtol=0, atol=step + 1e-6)
    for a, b in zip(tree_leaves(s_cpu["gen"]), tree_leaves(s_gpu["gen"])):
        torch.testing.assert_close(b.cpu(), a, rtol=0, atol=1e-5)
    for k in m_cpu:
        torch.testing.assert_close(m_gpu[k].cpu(), m_cpu[k], rtol=0,
                                   atol=1e-5)
    print("small round on the card matches the CPU round "
          f"(D objective {float(m_gpu['disc_objective']):+.6f})")


def check_faulted_rounds_against_cpu(torch):
    """One protocol round and one FedGAN round on a small DCGAN under a
    fault program (dropout, a free-rider, a byzantine device, stragglers)
    with the trimmed mean, on the card and on the CPU from the same
    draws. Agreement to float32 round-off, or to one quantization step
    where a stochastic rounding flips: the weights are equal, so the
    trimmed mean's order statistics move by at most that step."""
    import numpy as np
    from repro_torch.configs import DCGANConfig, ProtocolConfig
    from repro_torch.core import faults, fedgan, protocol
    from repro_torch.kernels.robust_avg.ops import RobustConfig
    from repro_torch.models import dcgan
    from repro_torch.models.specs import make_dcgan_spec
    from repro_torch.tree import tree_leaves

    cfg = DCGANConfig(nz=16, ngf=8, ndf=8, nc=3, image_size=16)
    spec = make_dcgan_spec(cfg)
    k = 6
    pcfg = ProtocolConfig(n_devices=k, n_d=2, n_g=2, sample_size=16,
                          server_sample_size=16, lr_d=1e-3, lr_g=1e-3)
    fcfg = faults.FaultConfig(n_devices=k, dropout_prob=0.25,
                              n_free_riders=1, n_byzantine=1,
                              straggler_factor=2.0)
    prog = faults.fault_program(fcfg)
    reducer = RobustConfig(method="trimmed_mean", trim=1)
    gen = torch.Generator().manual_seed(2)
    params = dcgan.gan_init(gen, cfg)
    data = torch.rand((k, 32, 16, 16, 3), generator=gen) * 2 - 1

    for name, make_state, round_fn, payload_fn in (
            ("protocol", protocol.make_train_state, protocol.gan_round,
             lambda st: st["disc"]),
            ("FedGAN", fedgan.make_fedgan_state, fedgan.fedgan_round,
             lambda st: {"gen": st["gen"], "disc": st["disc"]})):
        state0 = make_state(lambda g: params, pcfg, k, device="cpu")
        n_params = protocol.count_params(payload_fn(state0))
        # seed 1 drops one honest device: the byzantine device and the
        # free-rider take part, and 5 participants let one pair be trimmed
        draws = protocol.DrawSampler(spec, pcfg, seed=1, n_local=32,
                                     n_params=n_params, device="cpu",
                                     faults=fcfg)(0)
        weights = torch.tensor(np.where(prog.dropout_mask(draws.drop_u),
                                        0.0, 16.0), dtype=torch.float32)
        if int((weights > 0).sum()) != 5:
            raise AssertionError(f"expected 5 participants, {weights}")
        out = {}
        for dev in ("cpu", "cuda"):
            state = faults.attach_fault_state(
                make_state(lambda g: params, pcfg, k, device=dev), fcfg,
                payload_fn)
            moved = protocol.RoundDraws(*(
                t.to(dev) if isinstance(t, torch.Tensor) else t
                for t in (getattr(draws, f.name)
                          for f in dataclasses.fields(draws))))
            out[dev] = round_fn(spec, pcfg, state, data.to(dev),
                                weights.to(dev), moved, faults=fcfg,
                                reducer=reducer)
        torch.cuda.synchronize()
        (s_cpu, m_cpu), (s_gpu, m_gpu) = out["cpu"], out["cuda"]
        # the uploaded nets to one quantization step, the protocol's
        # generator (trained on the server, never quantized) to round-off
        for part in ("gen", "disc"):
            quantized = part == "disc" or name == "FedGAN"
            for a, b in zip(tree_leaves(s_cpu[part]),
                            tree_leaves(s_gpu[part])):
                step = float(a.abs().max()) / 32767
                torch.testing.assert_close(
                    b.cpu(), a, rtol=0,
                    atol=step + 1e-6 if quantized else 1e-5)
        for key in m_cpu:
            torch.testing.assert_close(m_gpu[key].cpu(), m_cpu[key], rtol=0,
                                       atol=1e-5)
        print(f"small {name} round under faults with the trimmed mean on "
              f"the card matches the CPU round (weights "
              f"{weights.tolist()})")


def train_hostile(torch, wavg_ops, robust_ops, spec, cfg, shards):
    """The hostile-worker path at full width: faults and robust reducers
    for the protocol, then FedGAN. Returns the launch counts of the
    path's run, {"wavg": n, "trimmed_wavg": n}."""
    import numpy as np
    from repro_torch.configs import ProtocolConfig
    from repro_torch.core import Trainer
    from repro_torch.core.faults import FaultConfig
    from repro_torch.kernels.robust_avg.ops import RobustConfig
    from repro_torch.models import dcgan
    from repro_torch.tree import tree_leaves

    pcfg = ProtocolConfig(n_devices=10, n_d=5, n_g=5, sample_size=128,
                          server_sample_size=128, optimizer="adam",
                          schedule="serial", scheduler="all")
    hostile = FaultConfig(**HOSTILE)
    runs = [  # (algorithm, faults, reducer, rounds, (wavg, trimmed) a round)
        ("proposed", hostile, RobustConfig("trimmed_mean", trim=2), 3,
         (0, 1)),
        ("proposed", hostile, RobustConfig("norm_clip"), 1, (1, 0)),
        ("proposed", hostile, RobustConfig("krum", krum_f=2), 1, (1, 0)),
        ("fedgan", None, None, 2, (2, 0)),
        ("fedgan", hostile, RobustConfig("trimmed_mean", trim=2), 2, (0, 1)),
    ]
    wavg_ops.launches = robust_ops.launches = 0   # the path starts here
    for algorithm, faults, reducer, n_rounds, per_round in runs:
        trainer = Trainer(spec, pcfg, lambda g: dcgan.gan_init(g, cfg),
                          shards, seed=1, algorithm=algorithm, faults=faults,
                          reducer=reducer, driver="host")
        label = (f"{algorithm}/{reducer.method if reducer else 'mean'}"
                 f"{'' if faults else ' (no faults)'}")
        for _ in range(n_rounds):
            before = (wavg_ops.launches, robust_ops.launches)
            disc0 = copy.deepcopy(trainer.state["disc"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec = trainer.run(1)[-1]
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            got = (wavg_ops.launches - before[0],
                   robust_ops.launches - before[1])
            if got != per_round:
                raise AssertionError(f"{label} round {rec.round}: (wavg, "
                                     f"trimmed_wavg) launches {got}, "
                                     f"expected {per_round}")
            if not all(np.isfinite(v) for v in rec.metrics.values()):
                raise AssertionError(f"non-finite objectives {rec.metrics}")
            if not all(bool(torch.isfinite(x).all())
                       for x in tree_leaves(trainer.state)
                       if x.is_floating_point()):
                raise AssertionError(f"{label}: non-finite parameters")
            moved = max(float((a - b).abs().max()) for a, b in
                        zip(tree_leaves(disc0),
                            tree_leaves(trainer.state["disc"])))
            if not moved > 0:
                raise AssertionError(f"{label}: the discriminator did not "
                                     f"change")
            objective = rec.metrics.get("disc_objective")
            print(f"hostile {label:28s} round {rec.round}: "
                  + (f"D {objective:+.5f}  " if objective is not None
                     else "")
                  + f"weights {rec.weights.tolist()}  disc moved "
                  f"{moved:.3e}  {secs:.3f} s")
    launches = {"wavg": wavg_ops.launches,            # ... and ends here
                "trimmed_wavg": robust_ops.launches}
    want = {"wavg": sum(r[3] * r[4][0] for r in runs),
            "trimmed_wavg": sum(r[3] * r[4][1] for r in runs)}
    if launches != want:
        raise AssertionError(f"hostile path launches {launches}, expected "
                             f"{want}")
    print(f"hostile path: {launches['wavg']} wavg and "
          f"{launches['trimmed_wavg']} trimmed_wavg launches")
    return launches


def train(torch, ops, robust_ops):
    """The protocol's path: Trainer.run on the full DCGAN, both
    schedules. Returns its wavg launches, the last trainer, the (spec,
    cfg, shards) that the hostile path reuses and the metrics of the
    first serial round, which the mesh path's first round repeats."""
    import numpy as np
    from repro_torch.configs import DCGANConfig, ProtocolConfig
    from repro_torch.core import Trainer, protocol
    from repro_torch.data import make_image_dataset, partition
    from repro_torch.metrics import fid_score, make_feature_extractor
    from repro_torch.models import dcgan
    from repro_torch.models.specs import make_dcgan_spec
    from repro_torch.tree import tree_leaves

    cfg = DCGANConfig()
    spec = make_dcgan_spec(cfg, gen_loss_variant="nonsaturating")
    imgs, _ = make_image_dataset("celeba", 10 * 512, seed=0)
    shards = partition(imgs, 10)
    runs = [dict(schedule="serial", scheduler="all", scheduling_ratio=1.0),
            dict(schedule="parallel", scheduler="best_channel",
                 scheduling_ratio=0.5)]

    ops.launches = robust_ops.launches = 0  # the path starts here
    trainer = first_round = None
    for run in runs:
        pcfg = ProtocolConfig(n_devices=10, n_d=5, n_g=5, sample_size=128,
                              server_sample_size=128, optimizer="adam", **run)
        trainer = Trainer(spec, pcfg, lambda g: dcgan.gan_init(g, cfg),
                          shards, seed=0, driver="host")
        n_gen = protocol.count_params(trainer.state["gen"])
        n_disc = protocol.count_params(trainer.state["disc"])
        if (n_gen, n_disc) != (3_576_704, 2_765_568):
            raise AssertionError(f"DCGAN sizes {n_gen}, {n_disc}")
        disc0 = copy.deepcopy(trainer.state["disc"])
        for r in range(3):
            before = ops.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec = trainer.run(1)[-1]
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            if ops.launches != before + 1:
                raise AssertionError(f"round {r}: {ops.launches - before} "
                                     f"wavg launches, expected 1")
            if not all(np.isfinite(v) for v in rec.metrics.values()):
                raise AssertionError(f"non-finite objectives {rec.metrics}")
            print(f"{run['schedule']:8s} round {rec.round}: "
                  f"D {rec.metrics['disc_objective']:+.5f}  "
                  f"G {rec.metrics['gen_objective']:+.5f}  "
                  f"weights {rec.weights.tolist()}  {secs:.3f} s")
        first_round = first_round or trainer.history[0].metrics
        leaves = tree_leaves(trainer.state)
        if not all(bool(torch.isfinite(x).all()) for x in leaves
                   if x.is_floating_point()):
            raise AssertionError("non-finite parameters")
        moved = max(float((a - b).abs().max()) for a, b in
                    zip(tree_leaves(disc0),
                        tree_leaves(trainer.state["disc"])))
        if not moved > 0:
            raise AssertionError("the discriminator did not change")
        if run["scheduler"] == "best_channel":
            if not all((rec.weights == 0).sum() == 5
                       for rec in trainer.history):
                raise AssertionError("best_channel at 0.5 must drop 5 of 10")
        print(f"{run['schedule']}: {n_gen} G / {n_disc} D parameters, "
              f"discriminator moved by up to {moved:.3e}")
    launches = ops.launches                # ... and ends here
    if launches != 2 * 3 or robust_ops.launches != 0:
        raise AssertionError(f"{launches} wavg and {robust_ops.launches} "
                             f"trimmed_wavg launches over 6 rounds")

    feat = make_feature_extractor(cfg.nc)
    real = feat(torch.as_tensor(imgs[:512], device="cuda"))
    with torch.no_grad():
        z = torch.randn((256, cfg.nz), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
        fake = dcgan.generator_apply(trainer.state["gen"], cfg, z)
    fid = fid_score(real, feat(fake))
    if not np.isfinite(fid):
        raise AssertionError(f"FID {fid}")
    print(f"FID after the last round: {fid:.4f}")
    return launches, trainer, (spec, cfg, shards), first_round


def backbone_config(bb):
    """The full-width config of `bb["arch"]`, its depth cut to
    bb["layers"] and its vocabulary to bb.get("vocab"), where less, and
    its discriminator's depth to bb.get("disc_layers")."""
    from repro_torch.configs import get_arch_config
    cfg = get_arch_config(bb["arch"])
    return dataclasses.replace(
        cfg, n_layers=min(cfg.n_layers, bb["layers"]),
        vocab=min(cfg.vocab, bb.get("vocab", cfg.vocab)),
        disc_layers=bb.get("disc_layers", cfg.disc_layers))


def token_shards(bb, cfg):
    """The path's token data, K shards of 32 sequences of bb["seq"]
    tokens from `make_token_dataset`'s seed: (the tokens, the shards)."""
    import resource
    from repro_torch.data import make_token_dataset, partition
    t0 = time.perf_counter()
    toks, _ = make_token_dataset(bb["k"] * 32, bb["seq"], cfg.vocab)
    print(f"{cfg.name} token data ({bb['k'] * 32} x {bb['seq']}, vocab "
          f"{cfg.vocab}): {time.perf_counter() - t0:.2f} s on the host, "
          f"peak RSS "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f}"
          f" GiB")
    return toks, partition(toks, bb["k"])


def train_backbone(torch, wavg_ops, kernel_ops, kernel, bb):
    """A backbone-GAN path: Trainer.run on the full-width `bb["arch"]`
    (depth and vocabulary cut by `backbone_config`) with K=4, n_d=n_g=2,
    m=M=bb["m"], seq_len bb["seq"], Adam at 1e-3, 16-bit uplink, over
    token data: 1 serial round with every device scheduled, then 1
    parallel round with best-channel scheduling at ratio 0.5. Each round
    launches wavg once and `kernel` once per sublayer forward. Returns
    the path's launch counts, its last trainer and its token shards."""
    import numpy as np
    from repro_torch.configs import ProtocolConfig
    from repro_torch.core import Trainer, protocol
    from repro_torch.metrics import fid_score, make_token_feature_extractor
    from repro_torch.models import gan
    from repro_torch.models.specs import make_backbone_spec
    from repro_torch.tree import tree_leaves

    cfg = backbone_config(bb)
    per_round = bb["per_round"]
    if launches_per_round(bb) != per_round:
        raise AssertionError(f"{cfg.name}: {launches_per_round(bb)} "
                             f"sublayer forwards a round, not {per_round}")
    spec = make_backbone_spec(cfg, bb["seq"], remat=False,
                              gen_loss_variant="nonsaturating")
    toks, shards = token_shards(bb, cfg)
    runs = [(1, dict(schedule="serial", scheduler="all",
                     scheduling_ratio=1.0)),
            (1, dict(schedule="parallel", scheduler="best_channel",
                     scheduling_ratio=0.5))]

    torch.cuda.reset_peak_memory_stats()
    wavg_ops.launches = kernel_ops.launches = 0   # the path starts here
    trainer = None
    for n_rounds, run in runs:
        pcfg = ProtocolConfig(n_devices=bb["k"], n_d=bb["n_d"],
                              n_g=bb["n_g"], sample_size=bb["m"],
                              server_sample_size=bb["m"], lr_d=1e-3,
                              lr_g=1e-3, optimizer="adam", **run)
        trainer = None                       # free the last run's state
        trainer = Trainer(spec, pcfg, lambda g: gan.gan_init(g, cfg),
                          shards, seed=0, driver="host")
        n_gen = protocol.count_params(trainer.state["gen"])
        n_disc = protocol.count_params(trainer.state["disc"])
        if (n_gen, n_disc) != bb["sizes"]:
            raise AssertionError(f"{cfg.name} sizes {n_gen}, {n_disc}")
        if trainer.data.dtype != torch.int64:
            raise AssertionError(f"token shards as {trainer.data.dtype}")
        for _ in range(n_rounds):
            before = (wavg_ops.launches, kernel_ops.launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec = trainer.run(1)[-1]
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            got = (wavg_ops.launches - before[0],
                   kernel_ops.launches - before[1])
            if got != (1, per_round):
                raise AssertionError(f"{cfg.name} round {rec.round}: (wavg, "
                                     f"{kernel}) launches {got}, expected "
                                     f"(1, {per_round})")
            if not all(np.isfinite(v) for v in rec.metrics.values()):
                raise AssertionError(f"non-finite objectives {rec.metrics}")
            print(f"{cfg.name} {run['schedule']:8s} round {rec.round}: "
                  f"D {rec.metrics['disc_objective']:+.5f}  "
                  f"G {rec.metrics['gen_objective']:+.5f}  "
                  f"weights {rec.weights.tolist()}  {secs:.3f} s")
        if not all(bool(torch.isfinite(x).all())
                   for x in tree_leaves(trainer.state)
                   if x.is_floating_point()):
            raise AssertionError(f"non-finite {cfg.name} parameters")
        if run["scheduler"] == "best_channel" and not all(
                (r.weights == 0).sum() == 2 for r in trainer.history):
            raise AssertionError("best_channel at 0.5 must drop 2 of 4")
    launches = {"wavg": wavg_ops.launches,     # ... and ends here
                kernel: kernel_ops.launches}
    n_total = sum(r[0] for r in runs)
    if launches != {"wavg": n_total, kernel: n_total * per_round}:
        raise AssertionError(f"{cfg.name} path launches {launches} over "
                             f"{n_total} rounds")
    print(f"{cfg.name} path ({cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"K={bb['k']}, seq_len {bb['seq']}): {n_gen} G / {n_disc} D "
          f"parameters; {launches['wavg']} wavg and {launches[kernel]} "
          f"{kernel} launches over {n_total} rounds; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    feat = make_token_feature_extractor(cfg.vocab)
    real = feat(torch.as_tensor(toks[:128], device="cuda"))
    with torch.no_grad():
        z = spec.sample_z(torch.Generator("cuda").manual_seed(0), 64)
        fake = spec.gen_apply(trainer.state["gen"], z)
    fid = fid_score(real, feat(fake))
    if not np.isfinite(fid):
        raise AssertionError(f"token FID {fid}")
    print(f"token FID after the last {cfg.name} round: {fid:.4f}")
    return launches, trainer, shards


def check_gemma3(torch, flash_ops):
    """Phase 5f, the gemma3-12b path: one 5:1 group at full width (d_model
    3,840, 16 heads of 256 over 8, d_ff 15,360), vocabulary 32,768, on
    GEMMA3's 2 sequences of 2,048 tokens through `make_backbone_spec`:
    D on real tokens, G, D on G's output, then the backward of D's
    objective into D and G. Each backbone pass launches flash_attn 6
    times, 5 with the window of 1,024 keys and 1 without; the gradients
    are finite; D's logits on the real tokens equal the port's on the
    CPU from the same parameters (rtol 1e-4; the first sequence's: the
    CPU forward of both took 35 s). Returns the path's
    flash_attn launches."""
    import numpy as np
    from repro_torch.core import protocol
    from repro_torch.models import gan
    from repro_torch.models.specs import make_backbone_spec
    from repro_torch.tree import tree_leaves, tree_map
    bb = GEMMA3
    cfg = backbone_config(bb)
    spec = make_backbone_spec(cfg, bb["seq"], remat=False,
                              gen_loss_variant="nonsaturating")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = gan.gan_init(torch.Generator("cuda").manual_seed(0), cfg)
    sizes = tuple(protocol.count_params(params[p]) for p in ("gen", "disc"))
    if sizes != bb["sizes"]:
        raise AssertionError(f"{cfg.name} sizes {sizes}")
    for x in tree_leaves(params):
        x.requires_grad_(True)
    tokens = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (bb["b"], bb["seq"])), device="cuda")
    z = spec.sample_z(torch.Generator("cuda").manual_seed(1), bb["b"])
    windows = []
    wrapper = flash_ops.flash_attention

    def recording(q, k, v, *, causal=True, window=None):
        windows.append(window)
        return wrapper(q, k, v, causal=causal, window=window)

    flash_ops.flash_attention = recording
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flash_ops.launches = 0                     # the path starts here
        real = spec.disc_real(params["disc"], tokens)
        fake = spec.disc_fake(params["disc"],
                              spec.gen_apply(params["gen"], z))
        objective = (torch.nn.functional.softplus(-real).mean()
                     + torch.nn.functional.softplus(fake).mean())
        torch.cuda.synchronize()
        forward_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        objective.backward()
        torch.cuda.synchronize()
        backward_s = time.perf_counter() - t0
        launches = flash_ops.launches              # ... and ends here
    finally:
        flash_ops.flash_attention = wrapper
    group = [GEMMA3_WINDOW] * 5 + [None]
    if launches != 3 * 6 or windows != group * 3:
        raise AssertionError(f"{cfg.name}: {launches} flash_attn launches, "
                             f"windows {windows}")
    # G's embedding table and lm_head serve the LM mode; GAN training
    # reads neither (models/gan.py), so they take no gradient
    unused = {id(x) for x in tree_leaves({k: params["gen"][k]
                                          for k in ("embed", "lm_head")})}
    grads = [x.grad for x in tree_leaves(params) if id(x) not in unused]
    if any(g is None or not bool(torch.isfinite(g).all()) for g in grads):
        raise AssertionError(f"{cfg.name}: a missing or non-finite "
                             f"gradient")
    if any(x.grad is not None for x in tree_leaves(params)
           if id(x) in unused):
        raise AssertionError(f"{cfg.name}: a gradient into G's LM-mode "
                             f"leaves")
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not bool(torch.isfinite(objective)):
        raise AssertionError(f"{cfg.name}: objective {objective}")
    print(f"{cfg.name} path (one 5:1 group of its 48 layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab}, {bb['b']} x {bb['seq']} "
          f"tokens): {sizes[0]} G / {sizes[1]} D parameters; forward "
          f"(D real, G, D fake) {forward_s:.3f} s, backward into D and G "
          f"{backward_s:.3f} s; {launches} flash_attn launches, 3 passes "
          f"of 5 windowed ({GEMMA3_WINDOW} keys) and 1 global; "
          f"{len(grads)} gradients, every one finite (none into G's "
          f"embedding and lm_head); peak device memory {peak:.2f} GiB")

    # the first sequence's logit (2,048 tokens, the window binding) on
    # the CPU: D pools each sequence apart
    disc_cpu = tree_map(lambda x: x.detach().cpu(), params["disc"])
    t0 = time.perf_counter()
    with torch.no_grad():
        real_cpu = spec.disc_real(disc_cpu, tokens[:1].cpu())
    cpu_s = time.perf_counter() - t0
    torch.testing.assert_close(real.detach()[:1].cpu(), real_cpu, rtol=1e-4,
                               atol=0)
    print(f"{cfg.name} D logit on the first sequence of real tokens, card "
          f"{real.detach()[:1].cpu().tolist()} against the CPU "
          f"{real_cpu.tolist()} (rtol 1e-4; the CPU forward {cpu_s:.2f} s "
          f"on {torch.get_num_threads()} threads). Its GAN round waits for "
          f"tensor parallelism across cards or bf16 (ROADMAP A items 8 and "
          f"10): K=2 discriminators with float32 Adam need "
          f"(2 x {sizes[1]} + {sizes[0]}) x 16 B = "
          f"{(2 * sizes[1] + sizes[0]) * 16 / 1e9:.1f} GB before "
          f"activations")
    del params, grads, disc_cpu
    torch.cuda.empty_cache()
    return {"flash_attn": launches, "forward_s": forward_s,
            "backward_s": backward_s, "peak_gib": peak, "cpu_s": cpu_s}


# The backwards that run plain torch code, each inside a named
# torch.profiler.record_function range (the kernels' autograd Functions)
BACKWARD_RANGES = ("SSDScan.backward", "FlashAttention.backward")


def _merged(intervals):
    """Sorted, disjoint (start, end) intervals covering `intervals`."""
    out = []
    for start, stop in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], stop)
        else:
            out.append([start, stop])
    return out


def _overlap_us(a, b):
    """The length of the intersection of two merged interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _device_records(torch, prof):
    """(name, start_ns, end_ns, is_user_annotation) of every record on the
    device's timeline of a finished profile, read from the raw kineto
    results: the profiler's event tree (`prof.events()`) takes minutes to
    build for a mamba2 round's quarter of a million kernels and their
    host records."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
             e.is_user_annotation())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA
            and not e.is_hidden_event()]


def profile_round(torch, trainer, label, ranges=BACKWARD_RANGES,
                  kernels=()):
    """Where a round's time goes: one more round of `trainer` under
    torch.profiler (after the main paths' launch counts were read), its
    device-busy share, the kernels that take the most device time, and
    the device time inside each of `ranges` (record_function names) and
    of the kernels whose names match each regular expression of
    `kernels`. Host activity is recorded too: the profiler puts a
    record_function range on the device's timeline only then. Returns
    {wall_s, busy_s, ranges_s, kernels_s} (None without device events)."""
    import re
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.run(1)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    spans, by_name = [], {}
    ranges = {name: [] for name in ranges}
    matched = {pattern: [] for pattern in kernels}
    for name, start_ns, stop_ns, annotation in _device_records(torch, prof):
        interval = (start_ns / 1e3, stop_ns / 1e3)          # microseconds
        if annotation:               # a range's span, not device work
            if name in ranges:
                ranges[name].append(interval)
            continue
        spans.append(interval)
        by_name[name] = by_name.get(name, 0.0) + interval[1] - interval[0]
        for pattern in kernels:
            if re.search(pattern, name):
                matched[pattern].append(interval)
    if not spans:
        print(f"profile of one {label} round: the profiler saw no device "
              f"events; device busy share not measured")
        return None
    busy = _merged(spans)
    busy_us = sum(stop - start for start, stop in busy)
    print(f"profile of one {label} round (profiler on): {wall_s:.3f} s wall, "
          f"{busy_us / 1e6:.3f} s device busy "
          f"({busy_us / 1e6 / wall_s:.3f}), {len(spans)} device ops")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {us / 1e3:9.3f} ms  {name[:100]}")
    ranges_s = {}
    for name, intervals in ranges.items():
        if intervals:
            us = _overlap_us(busy, _merged(intervals))
            ranges_s[name] = us / 1e6
            print(f"  {name}: {us / 1e3:.3f} ms of device time in "
                  f"{len(intervals)} calls, {us / busy_us:.3f} of device "
                  f"busy")
    kernels_s = {pattern: sum(us for name, us in by_name.items()
                              if re.search(pattern, name)) / 1e6
                 for pattern in kernels}
    in_ranges_s = {}
    for pattern, secs in kernels_s.items():
        inside = {name: _overlap_us(_merged(matched[pattern]),
                                    _merged(intervals)) / 1e6
                  for name, intervals in ranges.items() if intervals}
        in_ranges_s[pattern] = inside
        print(f"  kernels /{pattern}/: {secs * 1e3:.3f} ms of device time, "
              f"{secs * 1e6 / busy_us:.3f} of device busy"
              + "".join(f"; {ms * 1e3:.3f} ms of it in {name}"
                        for name, ms in inside.items()))
    return dict(wall_s=wall_s, busy_s=busy_us / 1e6, ranges_s=ranges_s,
                kernels_s=kernels_s, kernels_in_ranges_s=in_ranges_s)


RING_TIMED = (1_356, 63_269, 169_997)  # the DCGAN, mamba2-130m, granite D
RING_ATOL, RING_RTOL = 1e-6, 1e-5    # one FMA rounding vs mul-then-add


def ring_inputs(torch, gen, nb, dtype):
    """acc (nb, 2048) f32, q (nb, 2048) of the wire dtype, coef (nb,) f32
    as the ring makes them: int16 over its whole range (the quantizer
    emits both extremes) with coef = w_norm * amax / 32767; int32 over
    +-2**23 (24 bits); f32 unquantized with coef = w_norm."""
    acc = torch.randn((nb, 2048), generator=gen, device="cuda")
    w = torch.rand(nb, generator=gen, device="cuda")
    if dtype == torch.float32:
        return acc, torch.randn((nb, 2048), generator=gen, device="cuda"), w
    hi = 32767 if dtype == torch.int16 else 2 ** 23 - 1
    q = torch.randint(-hi - 1, hi + 1, (nb, 2048), generator=gen,
                      device="cuda", dtype=dtype)
    q[0, :4] = torch.tensor([-hi - 1, hi, -hi - 1, hi], dtype=dtype)
    return acc, q, w / hi


def kernel_device_ms(torch, fn, inputs, kernel_names, n=24):
    """{name: the mean device time of one launch of each kernel whose
    name contains it} over `n` calls of `fn`, from torch.profiler's CUDA
    activity: at small shapes the CUDA-event time of back-to-back calls
    is the host's launch rate, not the kernel's. None for a name the
    profiler did not see."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            fn(*inputs[i % len(inputs)])
        torch.cuda.synchronize()
    out = {}
    for name in kernel_names:
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and name in e.name]
        out[name] = sum(us) / len(us) / 1e3 if us else None
    return out


def ring_library(acc, q, coef):
    """The one PyTorch call that computes ring_accum: addcmul promotes the
    wire to f32 inside its own kernel and accumulates in place. Timed
    beside the kernel only; the port does not call it."""
    return acc.addcmul_(coef[:, None], q)


def check_ring_accum(torch, ops):
    """The ring_accum kernel against its plain version for the three wire
    dtypes, whole and chunk by chunk at the ring's row offsets (a ragged
    split included, the rows outside a chunk unchanged), at the int16
    extremes; timings at the DCGAN's, mamba2-130m's and granite-3-2b's
    discriminator payloads, beside the plain version and `ring_library`
    (checked against the plain version first). Returns the kernel's JSON
    entry (launches unset)."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    max_err, n_cases = {}, 0
    for dtype in (torch.int16, torch.int32, torch.float32):
        for nb in (1, 3, 5, RING_TIMED[0], RING_TIMED[0] + 1):
            acc, q, coef = ring_inputs(torch, gen, nb, dtype)
            want = ops.ring_accum_ref(acc.clone(), q, coef)
            whole = ops.ring_accum_(acc.clone(), q, coef)
            # the ring's chunks: row slices at non-zero offsets, one launch
            # each, 4 chunks (ragged at nb = 5 and 1,357)
            chunked = acc.clone()
            for r0, r1 in ops._chunk_bounds(nb, ops.DEFAULT_CHUNKS):
                ops.ring_accum_(chunked[r0:r1], q[r0:r1], coef[r0:r1])
                torch.cuda.synchronize()
                if r1 < nb and not torch.equal(chunked[r1:], acc[r1:]):
                    raise AssertionError(f"ring_accum wrote past rows "
                                         f"[{r0}, {r1}) of {nb}")
            # the ring's own path: one RowAccumulator over the whole
            # tensors, one call a chunk
            launched = acc.clone()
            accumulate = ops.RowAccumulator(launched, q, coef)
            for r0, r1 in ops._chunk_bounds(nb, ops.DEFAULT_CHUNKS):
                accumulate(r0, r1)
            torch.cuda.synchronize()
            for got in (whole, chunked, launched):
                torch.testing.assert_close(got, want, rtol=RING_RTOL,
                                           atol=RING_ATOL)
            max_err[(dtype, nb)] = float((whole - want).abs().max())
            n_cases += 1
    print(f"ring_accum matches its plain version for int16, int32 and f32 "
          f"wires at {n_cases} shapes, whole, in the ring's chunks and "
          f"through the ring's RowAccumulator (rtol "
          f"{RING_RTOL}, atol {RING_ATOL}); max abs err "
          f"{max(max_err.values()):.3e}")

    timed = {}
    for nb in RING_TIMED:
        set_bytes = nb * 2048 * 6
        n_sets = max(3, -(-150_000_000 // set_bytes))   # together past L2
        sets = [ring_inputs(torch, gen, nb, torch.int16)
                for _ in range(n_sets)]
        acc, q, coef = sets[0]
        torch.testing.assert_close(
            ring_library(acc.clone(), q, coef),
            ops.ring_accum_ref(acc.clone(), q, coef),
            rtol=RING_RTOL, atol=RING_ATOL)
        kernel_ms = time_ms(ops.ring_accum_, sets)
        plain_ms = time_ms(ops.ring_accum_ref, sets)
        library_ms = time_ms(ring_library, sets)
        # bytes: acc read and written, q read (int16), coef read once
        n_bytes = nb * 2048 * (4 + 2 + 4) + nb * 4
        flops = 2 * nb * 2048
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        flops_ms = flops / F32_FLOPS_PER_S * 1e3
        print(f"ring_accum int16 rows={nb}: kernel {kernel_ms:.4f} ms "
              f"(CUDA events, back to back), plain {plain_ms:.4f} ms, "
              f"acc.addcmul_ {library_ms:.4f} ms, bound "
              f"{max(bytes_ms, flops_ms):.4f} ms ({n_bytes} B); "
              f"{bytes_ms / kernel_ms:.3f} of HBM peak")
        timed[nb] = dict(ms=kernel_ms, plain_ms=plain_ms,
                         bound_ms=max(bytes_ms, flops_ms),
                         bound_by="bytes" if bytes_ms >= flops_ms
                         else "operations", library_ms=library_ms)
        if nb == RING_TIMED[0]:
            timed[nb]["device_ms"] = kernel_device_ms(
                torch, ops.ring_accum_, sets,
                ("ring_accum_kernel",))["ring_accum_kernel"]
            timed[nb]["library_device_ms"] = kernel_device_ms(
                torch, ring_library, sets, ("addcmul",))["addcmul"]
        del sets
    main = timed[RING_TIMED[0]]
    for what, key in (("kernel", "device_ms"),
                      ("acc.addcmul_", "library_device_ms")):
        print(f"ring_accum int16 rows={RING_TIMED[0]}: {what}'s device time "
              f"a launch " + ("not measured (the profiler saw no kernel)"
                              if main[key] is None else
                              f"{main[key]:.4f} ms (profiler), "
                              f"{main['bound_ms'] / main[key]:.3f} of the "
                              f"bound"))
    ring_path = time_ring_path(torch, ops, gen)
    return {"name": "ring_accum", "route": "cuda",
            "source": "src/repro_torch/csrc/ring_accum.cu",
            "replaces": "src/repro/kernels/ring_wavg/kernel.py:35",
            "launches": None,
            "max_abs_err": max_err[(torch.int16, RING_TIMED[0])],
            **timed[RING_TIMED[0]], "ring_path": ring_path,
            "backbone_shape": {"rows": RING_TIMED[1], **timed[RING_TIMED[1]]},
            "granite_shape": {"rows": RING_TIMED[2], **timed[RING_TIMED[2]]}}


def time_ring_path(torch, ops, gen):
    """The ring's own launch path at the DCGAN's payload: one
    RowAccumulator a ring call over the whole (1,356, 2048) tensors, one
    call a chunk. Timed back to back by CUDA events and by the kernel's
    device time (profiler) for the whole payload (hop 0) and for the
    ring's second chunk of 339 rows (hops 1..k-1), beside acc.addcmul_
    and the public ring_accum_ on the same slices."""
    nb = RING_TIMED[0]
    r0, r1 = ops._chunk_bounds(nb, ops.DEFAULT_CHUNKS)[1]
    sets = [ring_inputs(torch, gen, nb, torch.int16) for _ in range(9)]
    accumulators = [(ops.RowAccumulator(*t),) for t in sets]
    out = {}
    for lo, hi in ((0, nb), (r0, r1)):
        sliced = [(acc[lo:hi], q[lo:hi], coef[lo:hi])
                  for acc, q, coef in sets]
        n_bytes = (hi - lo) * (2048 * (4 + 2 + 4) + 4)

        def launcher(accumulate, lo=lo, hi=hi):
            accumulate(lo, hi)
        row = {"rows": hi - lo,
               "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
               "launcher_ms": time_ms(launcher, accumulators),
               "ring_accum_ms": time_ms(ops.ring_accum_, sliced),
               "library_ms": time_ms(ring_library, sliced),
               "launcher_device_ms": kernel_device_ms(
                   torch, launcher, accumulators,
                   ("ring_accum_kernel",))["ring_accum_kernel"],
               "library_device_ms": kernel_device_ms(
                   torch, ring_library, sliced, ("addcmul",))["addcmul"]}
        print(f"ring_accum int16, the ring's path, rows [{lo}, {hi}): "
              f"launcher {row['launcher_ms']:.4f} ms, public ring_accum_ "
              f"{row['ring_accum_ms']:.4f} ms, acc.addcmul_ "
              f"{row['library_ms']:.4f} ms (CUDA events, back to back); "
              f"device time a launch (profiler): launcher "
              f"{row['launcher_device_ms']}, acc.addcmul_ "
              f"{row['library_device_ms']} ms; bound "
              f"{row['bound_ms']:.4f} ms")
        out[f"rows_{hi - lo}"] = row
    return out


def _rank_torch():
    """A mesh rank's torch, with TF32 off as in the parent, and one host
    thread: up to 10 ranks share the machine's cores, and their default
    per-core OpenMP threads would spin against each other."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    return torch


def _small_mesh_setup(torch):
    """The reduced DCGAN, config and data of the small mesh rounds, the
    same in every process (seeded on the CPU)."""
    from repro_torch.configs import DCGANConfig, ProtocolConfig
    from repro_torch.models import dcgan
    from repro_torch.models.specs import make_dcgan_spec
    cfg = DCGANConfig(nz=16, ngf=8, ndf=8, nc=3, image_size=16)
    pcfg = ProtocolConfig(n_devices=4, n_d=2, n_g=2, sample_size=16,
                          server_sample_size=16, lr_d=1e-3, lr_g=1e-3,
                          optimizer="adam")
    gen = torch.Generator().manual_seed(7)
    params = dcgan.gan_init(gen, cfg)
    data = torch.rand((4, 32, 16, 16, 3), generator=gen) * 2 - 1
    weights = torch.tensor([16.0, 0.0, 16.0, 16.0])
    return make_dcgan_spec(cfg), pcfg, params, data, weights


def _small_round_setup(torch, algorithm, schedule, n_devices, device):
    """(pcfg, make_state, round draws) of one small mesh round."""
    from repro_torch.core import fedgan, protocol
    spec, pcfg, params, data, weights = _small_mesh_setup(torch)
    pcfg = dataclasses.replace(pcfg, schedule=schedule)
    make_state = (fedgan.make_fedgan_state if algorithm == "fedgan"
                  else protocol.make_train_state)
    payload = (params["disc"] if algorithm == "proposed"
               else {"gen": params["gen"], "disc": params["disc"]})
    draws = protocol.DrawSampler(
        spec, pcfg, seed=7, n_local=32,
        n_params=protocol.count_params(payload), device=device)(0)
    state = make_state(lambda g: params, pcfg, n_devices, device=device)
    return spec, pcfg, state, data, weights, draws


SMALL_MESH_RUNS = (("proposed", "ring", "serial"),
                   ("proposed", "pallas", "serial"),
                   ("proposed", "jnp", "serial"),
                   ("proposed", "ring", "parallel"),
                   ("fedgan", "ring", "serial"))


def small_mesh_rank(rank, world_size, device):
    """One small mesh round of each of SMALL_MESH_RUNS on this rank: (new
    state, metrics, (ring_accum, wavg) launches)."""
    torch = _rank_torch()
    from repro_torch.core import shard_round
    from repro_torch.kernels.ring_wavg import ops as ring_ops
    from repro_torch.kernels.wavg import ops as wavg_ops
    from repro_torch.tree import tree_index
    out = []
    for algorithm, impl, schedule in SMALL_MESH_RUNS:
        spec, pcfg, state, data, weights, draws = _small_round_setup(
            torch, algorithm, schedule, 1, device)
        fedgan = algorithm == "fedgan"
        keys = (shard_round.FEDGAN_STACKED_KEYS if fedgan
                else shard_round.PROPOSED_STACKED_KEYS)
        state = {k: tree_index(v, 0) if k in keys else v
                 for k, v in state.items()}
        before = (ring_ops.launches, wavg_ops.launches)
        fn = shard_round.fedgan_mesh_round if fedgan else shard_round.mesh_round
        new_state, metrics = fn(spec, pcfg, state, data[rank].to(device),
                                weights[rank], draws, avg_impl=impl)
        torch.cuda.synchronize()
        out.append((new_state, {k: float(v) for k, v in metrics.items()},
                    (ring_ops.launches - before[0],
                     wavg_ops.launches - before[1])))
    return out


def check_small_mesh_rounds(torch):
    """Small mesh rounds, card against card: K=4 ranks on this card over
    gloo, one round of each of SMALL_MESH_RUNS, against the stacked round
    on the card from the same weights and draws. Globals to one
    quantization step (the generator of the proposed protocol, trained on
    the server, to round-off), every rank's own optimizer state, the
    metrics, and the globals equal on every rank."""
    from repro_torch.core import fedgan, protocol
    from repro_torch.kernels.ring_wavg import ops as ring_ops
    from repro_torch.launch import mesh
    from repro_torch.tree import tree_leaves
    t0 = time.perf_counter()
    per_rank = mesh.spawn(small_mesh_rank, 4, backend="gloo", timeout_s=300)
    secs = time.perf_counter() - t0
    for i, (algorithm, impl, schedule) in enumerate(SMALL_MESH_RUNS):
        spec, pcfg, state, data, weights, draws = _small_round_setup(
            torch, algorithm, schedule, 4, "cuda")
        round_fn = (fedgan.fedgan_round if algorithm == "fedgan"
                    else protocol.gan_round)
        want, want_m = round_fn(spec, pcfg, state, data.cuda(),
                                weights.cuda(), draws)
        quantized = ("gen", "disc") if algorithm == "fedgan" else ("disc",)
        own = (("gen_opt", "disc_opt") if algorithm == "fedgan"
               else ("disc_opt",))
        n_blocks = ring_ops._n_blocks({p: state[p] for p in quantized})
        for r, (st, metrics, launched) in enumerate(
                out[i] for out in per_rank):
            ring_want = 1 + 3 * min(4, n_blocks) if impl == "ring" else 0
            if launched != (ring_want, int(impl == "pallas")):
                raise AssertionError(f"mesh {algorithm}/{impl} rank {r}: "
                                     f"(ring_accum, wavg) launches "
                                     f"{launched}")
            for part in ("gen", "disc"):
                for a, b in zip(tree_leaves(want[part]),
                                tree_leaves(st[part])):
                    step = float(a.abs().max()) / 32767
                    torch.testing.assert_close(
                        torch.from_numpy(b), a.cpu(), rtol=0,
                        atol=step + 1e-6 if part in quantized else 1e-5)
            for part in own:
                for a, b in zip(tree_leaves(want[part]),
                                tree_leaves(st[part])):
                    torch.testing.assert_close(torch.from_numpy(b),
                                               a[r].cpu(), rtol=0, atol=1e-5)
            for key, value in want_m.items():
                if abs(metrics[key] - float(value)) > 1e-5:
                    raise AssertionError(f"mesh {algorithm}/{impl} rank {r}"
                                         f" {key}: {metrics[key]} vs "
                                         f"{float(value)}")
            first = per_rank[0][i][0]
            for part in ("gen", "disc"):      # the ring: each rank's order
                for a, b in zip(tree_leaves(first[part]),
                                tree_leaves(st[part])):
                    torch.testing.assert_close(torch.from_numpy(b),
                                               torch.from_numpy(a),
                                               rtol=1e-6, atol=1e-6)
        print(f"small mesh {algorithm} {schedule} round, avg_impl={impl}, "
              f"4 gloo ranks on this card: matches the stacked round on the "
              f"card ({per_rank[0][i][1]})")
    print(f"small mesh rounds: {secs:.2f} s, process start-up included")


# The mesh path at full width: one rank per DCGAN worker (K=10) on this
# card over gloo. (rounds, algorithm, avg_impl, seed, protocol settings,
# fault program, driver) of each Trainer, in order. The fused driver's
# mesh rounds run uncaptured: gloo's collectives go through the host.
MESH_RUNS = (
    (2, "proposed", "ring", 0, dict(schedule="serial", scheduler="all"),
     None, "host"),
    (1, "proposed", "ring", 0, dict(schedule="parallel",
                                    scheduler="best_channel",
                                    scheduling_ratio=0.5), None, "host"),
    (1, "proposed", "pallas", 0, dict(schedule="serial", scheduler="all"),
     None, "host"),
    (1, "fedgan", "ring", 1, dict(schedule="serial", scheduler="all"), None,
     "host"),
    (1, "proposed", "ring", 2, dict(schedule="serial", scheduler="all"),
     dict(n_devices=10, dropout_prob=0.1, straggler_factor=2.0), "host"),
    (2, "proposed", "ring", 3, dict(schedule="serial",
                                    scheduler="best_channel",
                                    scheduling_ratio=0.5),
     dict(n_devices=10, dropout_prob=0.1, straggler_factor=2.0), "fused"),
)


def _mesh_trainer(torch, shards, run, device, layout):
    from repro_torch.configs import DCGANConfig, ProtocolConfig
    from repro_torch.core import Trainer
    from repro_torch.core.faults import FaultConfig
    from repro_torch.models import dcgan
    from repro_torch.models.specs import make_dcgan_spec
    _, algorithm, impl, seed, settings, fcfg, driver = run
    cfg = DCGANConfig()
    pcfg = ProtocolConfig(n_devices=10, n_d=5, n_g=5, sample_size=128,
                          server_sample_size=128, optimizer="adam",
                          **settings)
    return Trainer(make_dcgan_spec(cfg, gen_loss_variant="nonsaturating"),
                   pcfg, lambda g: dcgan.gan_init(g, cfg), shards, seed=seed,
                   algorithm=algorithm, layout=layout,
                   avg_impl=impl if layout == "mesh" else "pallas",
                   faults=FaultConfig(**fcfg) if fcfg else None,
                   driver=driver, device=device)


def mesh_rank(shards_path, rank, world_size, device):
    """The mesh path on one rank: every run of MESH_RUNS through
    `Trainer(layout="mesh")`, with this rank's launch and wire-byte counts
    set to 0 just before the path and read around every round."""
    import numpy as np
    torch = _rank_torch()
    import torch.distributed as dist
    from repro_torch.kernels.ring_wavg import ops as ring_ops
    from repro_torch.kernels.robust_avg import ops as robust_ops
    from repro_torch.kernels.wavg import ops as wavg_ops
    from repro_torch.tree import tree_leaves
    shards = np.load(shards_path, mmap_mode="c")

    def counts():
        return (ring_ops.launches, wavg_ops.launches, robust_ops.launches,
                ring_ops.wire_bytes_sent)

    ring_ops.launches = wavg_ops.launches = robust_ops.launches = 0
    ring_ops.wire_bytes_sent = 0                  # the path starts here
    out = []
    for run in MESH_RUNS:
        trainer = _mesh_trainer(torch, shards, run, device, "mesh")
        payload = (trainer.state["disc"] if run[1] == "proposed" else
                   {"gen": trainer.state["gen"], "disc": trainer.state["disc"]})
        disc0 = [x.clone() for x in tree_leaves(trainer.state["disc"])]
        rounds = []
        for _ in range(run[0]):
            before = counts()
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            rec = trainer.run(1)[-1]
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            rounds.append(dict(mask=rec.mask, weights=rec.weights,
                               metrics=rec.metrics, secs=secs,
                               counts=tuple(a - b for a, b in
                                            zip(counts(), before))))
        finite = all(bool(torch.isfinite(x).all())
                     for x in tree_leaves(trainer.state)
                     if x.is_floating_point())
        moved = max(float((a - b).abs().max()) for a, b in
                    zip(disc0, tree_leaves(trainer.state["disc"])))
        out.append(dict(rounds=rounds, finite=finite, moved=moved,
                        wire_want=ring_ops.ring_wire_bytes_per_rank(
                            payload, trainer.pcfg.quantize_bits, world_size)))
        del trainer
        torch.cuda.empty_cache()
    return out, counts()                          # ... and ends here


def train_mesh(torch, shards, first_round):
    """The mesh path at full width: K=10 ranks on this card over gloo,
    the DCGAN of path 5a, each run of MESH_RUNS; per rank and round 37
    ring_accum launches on a ring round (1 + 4 chunks x 9 hops), one wavg
    launch on the pallas round, no trimmed_wavg launch, the ring's wire
    bytes as `ring_wire_bytes_per_rank`; masks and weights as a stacked
    Trainer's of the same seed and driver (the host driver's Step 1, or
    the fused driver's whole rounds: fading, dropout and the schedule
    from the same device slots on every rank). The first ring round is
    path 5a's first serial round (same seed and settings): its
    objectives must be `first_round`'s to f32 round-off. Returns the
    path's launch counts summed over the ranks."""
    import tempfile
    import numpy as np
    from repro_torch.launch import mesh
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "shards.npy")
        np.save(path, shards)
        t0 = time.perf_counter()
        per_rank = mesh.spawn(functools.partial(mesh_rank, path), 10,
                              backend="gloo", timeout_s=900)
    print(f"mesh path: 10 ranks share one card; the ring's wire is gloo "
          f"over host loopback (not a measure of an NCCL ring); "
          f"{time.perf_counter() - t0:.2f} s with process start-up")
    for i, run in enumerate(MESH_RUNS):
        n_rounds, algorithm, impl = run[:3]
        ref = _mesh_trainer(torch, shards, run, "cuda", "stacked")
        if ref.driver == "fused":            # whole rounds, on the card
            ref.run(n_rounds)
        for t in range(n_rounds):
            if ref.driver == "fused":
                mask, weights = ref.history[t].mask, ref.history[t].weights
            else:
                mask, weights, _ = ref.schedule(ref.sampler(t))
            recs = [out[i]["rounds"][t] for out, _ in per_rank]
            for r, rec in enumerate(recs):
                if not (np.array_equal(rec["mask"], mask)
                        and np.array_equal(rec["weights"], weights)):
                    raise AssertionError(
                        f"mesh {algorithm}/{impl} round {t} rank {r}: mask "
                        f"{rec['mask']} weights {rec['weights']}, the "
                        f"stacked Trainer's {mask} {weights}")
                want = ((1 + 4 * 9, 0, 0, per_rank[r][0][i]["wire_want"])
                        if impl == "ring" else (0, 1, 0, 0))
                if rec["counts"] != want:
                    raise AssertionError(
                        f"mesh {algorithm}/{impl} round {t} rank {r}: "
                        f"(ring_accum, wavg, trimmed_wavg, wire bytes) "
                        f"{rec['counts']}, expected {want}")
                if not all(np.isfinite(v) for v in rec["metrics"].values()):
                    raise AssertionError(f"non-finite objectives "
                                         f"{rec['metrics']}")
            objective = recs[0]["metrics"].get("disc_objective")
            print(f"mesh {algorithm:8s} {run[4]['schedule']:8s} "
                  f"avg_impl={impl:6s} {run[6]:5s} round {t}: "
                  + (f"D {objective:+.5f}  " if objective is not None
                     else "")
                  + f"weights {weights.tolist()}  {max(r['secs'] for r in recs):.3f} s"
                  f" (slowest rank), {recs[0]['counts'][3]} wire bytes a "
                  f"rank"
                  + (", uncaptured (gloo through the host), masks as the "
                     "stacked fused Trainer's" if run[6] == "fused" else ""))
        del ref
        for r, (out, _) in enumerate(per_rank):
            if not (out[i]["finite"] and out[i]["moved"] > 0):
                raise AssertionError(f"mesh {algorithm}/{impl} rank {r}: "
                                     f"finite {out[i]['finite']}, disc "
                                     f"moved {out[i]['moved']}")
    for r, (out, _) in enumerate(per_rank):
        got = out[0]["rounds"][0]["metrics"]
        for key, want in first_round.items():
            if abs(got[key] - want) > 1e-5 + 1e-4 * abs(want):
                raise AssertionError(f"mesh rank {r} first round {key} "
                                     f"{got[key]}, the stacked path's "
                                     f"{want}")
    print(f"mesh path's first round repeats the protocol path's first "
          f"serial round on every rank: {per_rank[0][0][0]['rounds'][0]['metrics']}"
          f" vs {first_round}")
    totals = [c for _, c in per_rank]
    launches = {"ring_accum": sum(c[0] for c in totals),
                "wavg": sum(c[1] for c in totals),
                "trimmed_wavg": sum(c[2] for c in totals)}
    ring_rounds = sum(run[0] for run in MESH_RUNS if run[2] == "ring")
    pallas_rounds = sum(run[0] for run in MESH_RUNS if run[2] == "pallas")
    want = {"ring_accum": 10 * ring_rounds * 37, "wavg": 10 * pallas_rounds,
            "trimmed_wavg": 0}
    if launches != want:
        raise AssertionError(f"mesh path launches {launches}, expected "
                             f"{want}")
    print(f"mesh path: {launches['ring_accum']} ring_accum, "
          f"{launches['wavg']} wavg and 0 trimmed_wavg launches over the "
          f"10 ranks")
    return launches


# ---------------------------------------------------------------------------
# 7. The fused driver against the host driver
# ---------------------------------------------------------------------------

# The kernels of a replayed round, by the names on the device timeline
# (a regular expression each: wavg_kernel ends trimmed_wavg_kernel too).
REPLAY_KERNELS = {"wavg": r"(?<!trimmed_)wavg_kernel",
                  "trimmed_wavg": r"trimmed_wavg_kernel",
                  "flash_attn": r"flash_attn_kernel",
                  **{name: name for name in SSD_KERNELS}}


def profile_replay(torch, trainer, label, rounds=1):
    """One more round of a fused `trainer`, whose graph is captured, under
    torch.profiler's CUDA activity: the launches of each REPLAY_KERNELS
    kernel in the replay (by name, from the device timeline: a replay
    calls no Python wrapper), device busy against wall, device ops.
    `rounds`: the replays that `trainer.run(1)` makes (a launch step's
    chunk)."""
    import re
    from torch.profiler import ProfilerActivity, profile
    graph = trainer._graph
    if not graph.captured:
        raise AssertionError(f"{label}: the fused round is not captured")
    replays = graph.replays
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.run(1)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    if graph.replays != replays + rounds:
        raise AssertionError(f"{label}: the profiled round was not a replay")
    events = [e[:3] for e in _device_records(torch, prof) if not e[3]]
    counts = {name: sum(1 for e in events if re.search(pattern, e[0]))
              for name, pattern in REPLAY_KERNELS.items()}
    busy_s = sum(b - a for a, b in _merged(e[1:] for e in events)) / 1e9
    gemm_s, f32_gemm_s = (sum(e[2] - e[1] for e in events
                              if re.search(pattern, e[0])) / 1e9
                          for pattern in (GEMM_KERNELS, F32_GEMM_KERNELS))
    print(f"profile of one replayed {label} round: {wall_s:.4f} s wall, "
          f"{busy_s:.4f} s device busy ({busy_s / wall_s:.3f}), "
          f"{len(events)} device ops; GEMMs {gemm_s:.4f} s (float32 "
          f"{f32_gemm_s:.4f} s); kernels by name "
          f"{ {k: v for k, v in counts.items() if v} }")
    return counts, busy_s, wall_s, len(events)


def _timed_round(torch, trainer):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = trainer.run(1)[-1]
    torch.cuda.synchronize()
    return rec, time.perf_counter() - t0


def _params(trainer):
    """The trainer's G and D parameters, on the host."""
    from repro_torch.tree import tree_leaves
    return [x.detach().cpu() for x in tree_leaves(
        {"gen": trainer.state["gen"], "disc": trainer.state["disc"]})]


def _max_diff(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def driver_mismatch(host, fused):
    """What differs between two runs' (records, parameters): masks,
    weights, any round's metrics or the parameters not bit for bit, a
    wallclock by more than float32 round-off (rtol 1e-6: the host
    driver's channel runs in float64, the fused one in float32); None
    if nothing does."""
    import numpy as np
    (h_recs, h_params), (f_recs, f_params) = host, fused
    for h, f in zip(h_recs, f_recs):
        if not (np.array_equal(h.mask, f.mask)
                and np.array_equal(h.weights, f.weights)):
            return (f"round {h.round}: mask {f.mask} weights {f.weights}, "
                    f"host {h.mask} {h.weights}")
        if f.metrics != h.metrics:
            return f"round {h.round}: metrics {f.metrics}, host {h.metrics}"
        if abs(f.wallclock_s - h.wallclock_s) > 1e-6 * h.wallclock_s:
            return (f"round {h.round}: wallclock {f.wallclock_s}, host "
                    f"{h.wallclock_s}")
    diff = _max_diff(h_params, f_params)
    return f"parameters differ by up to {diff:.3e}" if diff else None


def compare_drivers(torch, label, make_trainer, n_rounds, *, want,
                    peak=False, planted=False, keep=None, keep_gen=False,
                    kernel_mods=None, after_host=None, profile=True,
                    fused=True):
    """`n_rounds` rounds of `make_trainer("host")`, then of
    `make_trainer("fused")`, under cuDNN's deterministic algorithms
    (`train_fused`), so that the two drivers run the same kernels on the
    same draws: every round's masks, weights and metrics and the final
    parameters must be equal bit for bit, wallclocks within rtol 1e-6
    (`driver_mismatch`). Prints seconds a round for both (the fused
    driver's first round is its eager warm-up plus the capture) and,
    with `peak`, peak device memory; then profiles one replayed round,
    whose kernels must launch `want` times. With `planted`, the check
    must also fail on a fused run whose slots keep round 0's draws (a
    replay that is not refilled). With `keep`, the host run's records
    go to keep[label]; with `keep_gen` too, its generator's parameters,
    on the host, to keep[label + " generator"]. With `kernel_mods`
    ({name: wrapper module}), every count is set to 0 just before the
    host run and read just after its rounds (out["host_launches"]);
    `after_host(trainer)` then runs on the host trainer (a profiled
    round) and its result goes to out["after_host"]. With profile=False
    the replay is not profiled (mamba2-130m's 245,000 kernels a round;
    cut for the script's time); with fused=False only the host driver
    runs (its records and generator kept as above). Returns a summary
    for the `fused` JSON line."""
    out, runs = {}, {}
    for driver in ("host", "fused") if fused else ("host",):
        gc.collect()     # a former trainer's cycles hold device memory
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trainer = make_trainer(driver)
        if trainer.driver != driver:
            raise AssertionError(f"{label}: driver {trainer.driver}")
        if kernel_mods is not None and driver == "host":
            zero_counts(kernel_mods)           # the path starts here
        recs, secs = zip(*(_timed_round(torch, trainer)
                           for _ in range(n_rounds)))
        if kernel_mods is not None and driver == "host":
            out["host_launches"] = kernel_counts(kernel_mods)  # ... ends
        out[f"{driver}_s"] = list(secs)
        if peak:
            out[f"{driver}_peak_gib"] = (torch.cuda.max_memory_allocated()
                                         / 2**30)
        runs[driver] = (recs, _params(trainer))
        if after_host is not None and driver == "host":
            out["after_host"] = after_host(trainer)
        if driver == "host":
            if keep_gen:
                from repro_torch.tree import tree_map
                keep[f"{label} generator"] = tree_map(
                    lambda t: t.detach().cpu(), trainer.state["gen"])
            del trainer
    if keep is not None:
        keep[label] = runs["host"][0]
    if not fused:
        print(f"{label}: host driver only, s/round "
              f"{[round(x, 4) for x in out['host_s']]}"
              + (f"; peak device memory {out['host_peak_gib']:.2f} GiB"
                 if peak else ""))
        return out
    graph = trainer._graph
    if not (graph.captured and graph.eager_rounds == 1
            and graph.replays == n_rounds - 1):
        raise AssertionError(f"{label}: eager {graph.eager_rounds}, "
                             f"replays {graph.replays}")
    wrong = driver_mismatch(runs["host"], runs["fused"])
    if wrong:
        raise AssertionError(f"{label}: the fused driver differs from the "
                             f"host driver: {wrong}")
    if planted:
        stale = make_trainer("fused")
        first = stale.sampler
        stale.sampler = lambda t: first(0)
        recs = stale.run(n_rounds)
        stale_params = _params(stale)
        caught = driver_mismatch(runs["host"], (recs, stale_params))
        del stale
        if not caught:
            raise AssertionError(f"{label}: the check passed a replay "
                                 f"whose slots kept round 0's draws")
        out.update(planted_caught=caught, planted_param_diff=_max_diff(
            runs["host"][1], stale_params))
    walls = max(abs(f.wallclock_s - h.wallclock_s) / h.wallclock_s
                for h, f in zip(runs["host"][0], runs["fused"][0]))
    steady = out["fused_s"][1:]
    print(f"fused {label}: masks, weights, every round's metrics and the "
          f"parameters bitwise equal to the host driver's in {n_rounds} "
          f"rounds ({[h.weights.tolist() for h in runs['host'][0]]}), "
          f"wallclock within {walls:.1e} (rtol 1e-6)"
          + (f"; a planted stale replay is caught ({caught}; its "
             f"parameters {out['planted_param_diff']:.3e} away)"
             if planted else "")
          + f"; s/round host {[round(x, 4) for x in out['host_s']]}, "
          f"fused first (eager under set_sync_debug_mode('error') + "
          f"capture) {out['fused_s'][0]:.4f}, replayed "
          f"{[round(x, 4) for x in steady]}"
          + (f"; peak device memory host {out['host_peak_gib']:.2f} GiB, "
             f"fused {out['fused_peak_gib']:.2f} GiB" if peak else ""))
    if not profile:
        return out
    counts, busy_s, wall_s, n_ops = profile_replay(torch, trainer, label)
    if any(counts[name] != n for name, n in want.items()):
        # the profiler drops a device record now and then (one
        # flash_attn of 44 once, of 168 another time): a second replayed
        # round's profile must then give the counts
        print(f"{label}: the profile saw {counts}; profiling one more "
              f"replayed round")
        counts, busy_s, wall_s, n_ops = profile_replay(torch, trainer,
                                                       label)
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(f"{label}: {counts[name]} {name} launches "
                                 f"in a replayed round, expected {n}")
    out.update(wallclock_rel=walls, replay_counts=counts,
               replay_busy_s=busy_s, replay_wall_s=wall_s,
               replay_device_ops=n_ops)
    return out


def nondeterministic_floor(torch, make_trainer, n_rounds):
    """Two host-driver runs of `make_trainer("host")` with cuDNN free to
    pick nondeterministic algorithms (as in phases 5 and 6): how far
    apart its parameters land with nothing else changed."""
    torch.backends.cudnn.deterministic = False
    try:
        params = []
        for _ in range(2):
            trainer = make_trainer("host")
            trainer.run(n_rounds)
            params.append(_params(trainer))
            del trainer
    finally:
        torch.backends.cudnn.deterministic = True
    return _max_diff(*params)


def mlp_rounds_per_s(torch, n_rounds=50):
    """The JAX package's driver benchmark model (models/gan.py's MLP-GAN:
    d_z 8, 16 hidden, 64-dim data, K=8, n_d=n_g=1, m=M=4, 16-bit uplink)
    for `n_rounds` rounds under each driver, as one `run` call, after
    one round (the fused driver's warm-up and capture): rounds a second,
    and the two runs held equal by `driver_mismatch`."""
    import numpy as np
    from repro_torch.configs import ProtocolConfig
    from repro_torch.core import Trainer
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.models import gan
    k = 8
    pcfg = ProtocolConfig(n_devices=k, n_d=1, n_g=1, sample_size=4,
                          server_sample_size=4, lr_d=1e-3, lr_g=1e-3,
                          scheduler="round_robin", scheduling_ratio=0.5)
    data = np.random.default_rng(9).standard_normal((k, 8, 64)).astype(
        np.float32)
    out, runs = {}, {}
    for driver in ("host", "fused"):
        trainer = Trainer(gan.mlp_gan_spec(d_z=8), pcfg,
                          lambda g: gan.mlp_gan_init(g, d_z=8, d_hidden=16,
                                                     d_data=64),
                          data, seed=0, driver=driver,
                          channel_cfg=ChannelConfig(n_devices=k,
                                                    fading=False))
        trainer.run(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recs = trainer.run(n_rounds)
        torch.cuda.synchronize()
        out[driver] = n_rounds / (time.perf_counter() - t0)
        runs[driver] = (recs, _params(trainer))
    wrong = driver_mismatch(runs["host"], runs["fused"])
    if wrong:
        raise AssertionError(f"MLP-GAN: the fused driver differs from the "
                             f"host driver: {wrong}")
    print(f"fused MLP-GAN (K={k}, 16-bit uplink), {n_rounds} rounds each: "
          f"host {out['host']:.1f} rounds/s, fused {out['fused']:.1f} "
          f"rounds/s ({out['fused'] / out['host']:.2f}x); masks, weights, "
          f"metrics and parameters bitwise equal")
    return out


def train_fused(torch, shards, card, tokens):
    """Phase 7 on `card` (nvidia-smi's name and power limit, printed with
    the results): each run under the host driver, then the fused driver,
    from the same seed, fading off (round_robin masks deterministic):
    the full DCGAN protocol (K=10, serial and parallel, round_robin at
    0.5), its hostile-worker path under the trimmed mean (dropout from
    the shared slots), FedGAN, the MLP-GAN's rounds a second, and the
    backbone-GANs of phase 5 (K=4, with their peak memory, on phase 5's
    `tokens`): mamba2-130m, granite-3-2b (4 layers) and minitron-4b (2
    layers, vocabulary 32,768). Returns the results and each backbone's
    host-driver records, by architecture (and mamba2-130m's host-trained
    generator, for phase 9)."""
    from repro_torch.configs import DCGANConfig, ProtocolConfig
    from repro_torch.core import Trainer
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.faults import FaultConfig
    from repro_torch.kernels.robust_avg.ops import RobustConfig
    from repro_torch.models import dcgan, gan
    from repro_torch.models.specs import make_backbone_spec, make_dcgan_spec

    cfg = DCGANConfig()
    spec = make_dcgan_spec(cfg, gen_loss_variant="nonsaturating")
    results, host_records = {}, {}

    def dcgan_run(driver, algorithm="proposed", faults=None, reducer=None,
                  **settings):
        pcfg = ProtocolConfig(n_devices=10, n_d=5, n_g=5, sample_size=128,
                              server_sample_size=128, optimizer="adam",
                              **settings)
        return Trainer(spec, pcfg, lambda g: dcgan.gan_init(g, cfg), shards,
                       seed=0, algorithm=algorithm, faults=faults,
                       reducer=reducer, driver=driver,
                       channel_cfg=ChannelConfig(n_devices=10, fading=False))

    rr = dict(scheduler="round_robin", scheduling_ratio=0.5)
    runs = [
        ("DCGAN serial", dict(schedule="serial", **rr), 2, {"wavg": 1}),
        ("DCGAN parallel", dict(schedule="parallel", **rr), 2, {"wavg": 1}),
        ("DCGAN hostile trimmed_mean", dict(
            schedule="serial", scheduler="all", faults=FaultConfig(**HOSTILE),
            reducer=RobustConfig("trimmed_mean", trim=2)), 2,
         {"wavg": 0, "trimmed_wavg": 1}),
        ("DCGAN FedGAN", dict(schedule="serial", algorithm="fedgan", **rr), 2,
         {"wavg": 2}),
    ]
    def backbone_run(bb, driver):
        cfg = backbone_config(bb)
        pcfg = ProtocolConfig(n_devices=bb["k"], n_d=bb["n_d"],
                              n_g=bb["n_g"], sample_size=bb["m"],
                              server_sample_size=bb["m"], lr_d=1e-3,
                              lr_g=1e-3, optimizer="adam", schedule="serial",
                              scheduler="round_robin", scheduling_ratio=0.5)
        return Trainer(make_backbone_spec(cfg, bb["seq"], remat=False,
                                          gen_loss_variant="nonsaturating"),
                       pcfg, lambda g: gan.gan_init(g, cfg),
                       tokens[bb["name"]], seed=0, driver=driver,
                       channel_cfg=ChannelConfig(n_devices=bb["k"],
                                                 fading=False))

    # cuDNN's deterministic algorithms: the DCGAN's convolutions then
    # give the same bits in every run, so the drivers are held bitwise
    # (nondeterministic_floor reads what they give otherwise)
    torch.backends.cudnn.deterministic = True
    try:
        for label, settings, n_rounds, want in runs:
            make = functools.partial(dcgan_run, **settings)
            results[label] = compare_drivers(
                torch, label, make, n_rounds, want=want,
                planted=label == "DCGAN serial")
            if label == "DCGAN serial":
                floor = nondeterministic_floor(torch, make, n_rounds)
                results[label]["nondeterministic_host_diff"] = floor
                print(f"DCGAN serial, two host runs with cuDNN's "
                      f"nondeterministic algorithms allowed: parameters "
                      f"{floor:.3e} apart after {n_rounds} rounds")
        results["MLP-GAN rounds/s"] = mlp_rounds_per_s(torch)
        # mamba2-130m's host rounds are host-bound (~10 s each): 2 rounds,
        # enough for 8d's comparison; its fused run (the first round
        # eager under sync-debug mode, ~41 s) was cut for the script's
        # time when phase 13e came: granite and minitron hold the fused
        # driver to the host driver with flash_attn, phase 11's zamba2
        # with ssd_scan
        for name, bb, kernels, n_rounds in (
                ("mamba2", MAMBA, SSD_KERNELS, 2),
                ("granite", GRANITE, ("flash_attn",), 2),
                ("minitron", MINITRON, ("flash_attn",), 2)):
            bb = dict(bb, name=name)
            results[bb["arch"]] = compare_drivers(
                torch, bb["arch"], functools.partial(backbone_run, bb),
                n_rounds,
                peak=True, keep=host_records, keep_gen=name == "mamba2",
                profile=name != "mamba2", fused=name != "mamba2",
                want={"wavg": 1, **{kernel: bb["per_round"]
                                    for kernel in kernels}})
    finally:
        torch.backends.cudnn.deterministic = False
    print(f"fused phase on {card}")
    print(json.dumps({"fused": results}, default=float))
    return results, host_records


# ---------------------------------------------------------------------------
# 8. Experiments: checkpoints and resume, the centralized baseline,
#    microbatching, the quickstart twin and the paper's figures
# ---------------------------------------------------------------------------

def _rounds_since(trainer, n, first):
    """The last `n` records of `trainer`, which must be rounds `first`,
    `first` + 1, ..."""
    recs = trainer.history[-n:]
    if [r.round for r in recs] != list(range(first, first + n)):
        raise AssertionError(f"rounds {[r.round for r in recs]}, expected "
                             f"{first}..{first + n - 1}")
    return recs


def resume_matches(torch, label, make_trainer, directory):
    """`make_trainer()` (a fused Trainer) for 4 uninterrupted rounds,
    against 2 rounds, `save_checkpoint`, 2 more rounds (the round graph
    captured), `restore` of round 2 into the same Trainer and 2 rounds;
    and against a fresh Trainer restored from round 2 for 2 rounds.
    Rounds 2-3 of each must equal the uninterrupted run's bit for bit
    (masks, weights, metrics, parameters; wallclock rtol 1e-6,
    `driver_mismatch`). Returns seconds and sizes for the JSON line."""
    whole = make_trainer()
    whole.run(4)
    want = (_rounds_since(whole, 2, 2), _params(whole))
    del whole
    part = make_trainer()
    part.run(2)
    t0 = time.perf_counter()
    path = part.save_checkpoint(directory)
    save_s = time.perf_counter() - t0
    part.run(2)
    graph = part._graph
    if not graph.captured:
        raise AssertionError(f"{label}: the round graph is not captured")
    replays = graph.replays
    t0 = time.perf_counter()
    part.restore(directory, step=2)
    restore_s = time.perf_counter() - t0
    if part.state is not graph.state:
        raise AssertionError(f"{label}: restore rebound a captured state")
    part.run(2)
    if graph.replays != replays + 2:
        raise AssertionError(f"{label}: the resumed rounds were not replays")
    fresh = make_trainer()
    fresh.restore(directory)
    fresh.run(2)
    for who, trainer in (("the same Trainer", part), ("a fresh Trainer",
                                                       fresh)):
        wrong = driver_mismatch(want, (_rounds_since(trainer, 2, 2),
                                       _params(trainer)))
        if wrong:
            raise AssertionError(f"{label}: resumed on {who}: {wrong}")
    size = os.path.getsize(path)
    print(f"resume {label}: 4 rounds against 2 + save + 2 + restore + 2 "
          f"(replays on the captured graph) and against a fresh Trainer "
          f"restored from round 2: masks, weights, metrics and parameters "
          f"bitwise equal, wallclock within rtol 1e-6; checkpoint "
          f"{size / 2**20:.1f} MiB, save {save_s:.3f} s, restore into the "
          f"graph {restore_s:.3f} s")
    del part, fresh
    return {"checkpoint_mib": size / 2**20, "save_s": save_s,
            "restore_s": restore_s}


def check_resume(torch, shards, directory):
    """8a: resume on the card, the full DCGAN (K=10) under the fused
    driver and deterministic cuDNN (as in phase 7), fading on (its draws
    are keyed by (seed, round) as well): the protocol, its hostile path
    (free-riders' stale cache, trimmed mean) and FedGAN."""
    from repro_torch.configs import DCGANConfig, ProtocolConfig
    from repro_torch.core import Trainer
    from repro_torch.core.faults import FaultConfig
    from repro_torch.kernels.robust_avg.ops import RobustConfig
    from repro_torch.models import dcgan
    from repro_torch.models.specs import make_dcgan_spec

    cfg = DCGANConfig()
    spec = make_dcgan_spec(cfg, gen_loss_variant="nonsaturating")
    pcfg = ProtocolConfig(n_devices=10, n_d=5, n_g=5, sample_size=128,
                          server_sample_size=128, optimizer="adam",
                          schedule="serial", scheduler="round_robin",
                          scheduling_ratio=0.5)

    def make(**kw):
        return lambda: Trainer(spec, pcfg, lambda g: dcgan.gan_init(g, cfg),
                               shards, seed=0, driver="fused", **kw)

    runs = [("DCGAN serial", make()),
            ("DCGAN hostile trimmed_mean", make(
                faults=FaultConfig(**HOSTILE),
                reducer=RobustConfig("trimmed_mean", trim=2))),
            ("DCGAN FedGAN", make(algorithm="fedgan"))]
    out = {}
    torch.backends.cudnn.deterministic = True
    try:
        for label, make_trainer in runs:
            ckpt = os.path.join(directory, label)
            out[label] = resume_matches(torch, label, make_trainer, ckpt)
            shutil.rmtree(ckpt)     # up to 0.6 GB a checkpoint
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
    return out


def check_centralized_and_microbatched(torch):
    """8b: on the card and on the CPU from the same weights and draws, at
    phase 4's small DCGAN: a centralized step (one worker on the pooled
    shards), and a protocol round with micro_batch_d=2, micro_batch_g=4
    (per-chunk batch statistics); agreement to float32 round-off (one
    quantization step for the uploaded discriminator). Then the MLP-GAN,
    which has no batch-norm: its microbatched round on the card equals
    the unbatched one to float32 round-off (SGD, a float32 uplink)."""
    from repro_torch.configs import DCGANConfig, ProtocolConfig
    from repro_torch.core import protocol
    from repro_torch.kernels.wavg import ops as wavg_ops
    from repro_torch.models import dcgan, gan
    from repro_torch.models.specs import make_dcgan_spec
    from repro_torch.tree import tree_leaves

    cfg = DCGANConfig(nz=16, ngf=8, ndf=8, nc=3, image_size=16)
    spec = make_dcgan_spec(cfg)
    k = 4
    pcfg = ProtocolConfig(n_devices=k, n_d=2, n_g=2, sample_size=16,
                          server_sample_size=16, lr_d=1e-3, lr_g=1e-3,
                          optimizer="adam")
    gen = torch.Generator().manual_seed(3)
    params = dcgan.gan_init(gen, cfg)
    data = torch.rand((k, 32, 16, 16, 3), generator=gen) * 2 - 1
    n_disc = protocol.count_params(params["disc"])

    def on(draws, dev):
        return protocol.RoundDraws(*(None if t is None else t.to(dev) for t in
                                     (draws.z_dev, draws.z_srv, draws.idx,
                                      draws.quant_u)))

    def agree(label, out, quantized):
        torch.cuda.synchronize()
        (s_cpu, m_cpu), (s_gpu, m_gpu) = out["cpu"], out["cuda"]
        for part in ("gen", "disc"):
            for a, b in zip(tree_leaves(s_cpu[part]),
                            tree_leaves(s_gpu[part])):
                step = (float(a.abs().max()) / 32767
                        if part in quantized else 0.0)
                torch.testing.assert_close(b.cpu(), a, rtol=0,
                                           atol=step + 1e-5)
        for key in m_cpu:
            torch.testing.assert_close(m_gpu[key].cpu(), m_cpu[key], rtol=0,
                                       atol=1e-5)
        print(f"{label} on the card matches the CPU's (D objective "
              f"{float(m_gpu['disc_objective']):+.6f})")

    # the centralized step: one device's draws over the K·32 pooled rows
    one = dataclasses.replace(pcfg, n_devices=1)
    pooled = data.reshape((-1,) + data.shape[2:])
    draws = protocol.DrawSampler(spec, one, seed=1, n_local=pooled.shape[0],
                                 n_params=n_disc, device="cpu")(0)
    out = {dev: protocol.centralized_step(
        spec, one, protocol.make_train_state(lambda g: params, one, 1,
                                             device=dev),
        pooled.to(dev), on(draws, dev)) for dev in ("cpu", "cuda")}
    agree("centralized step (K=4 shards pooled, 128 rows)", out, ())

    micro = dataclasses.replace(pcfg, micro_batch_d=2, micro_batch_g=4)
    draws = protocol.DrawSampler(spec, micro, seed=1, n_local=32,
                                 n_params=n_disc, device="cpu")(0)
    weights = torch.tensor([16.0, 0.0, 16.0, 16.0])
    before = wavg_ops.launches
    out = {dev: protocol.gan_round(
        spec, micro, protocol.make_train_state(lambda g: params, micro, k,
                                               device=dev),
        data.to(dev), weights.to(dev), on(draws, dev))
        for dev in ("cpu", "cuda")}
    if wavg_ops.launches != before + 1:
        raise AssertionError("the microbatched round launched wavg "
                             f"{wavg_ops.launches - before} times")
    agree("microbatched round (micro_batch_d=2, micro_batch_g=4, "
          "per-chunk batch statistics)", out, ("disc",))

    k = 8
    mlp = ProtocolConfig(n_devices=k, n_d=2, n_g=2, sample_size=16,
                         server_sample_size=16, lr_d=1e-2, lr_g=1e-2,
                         quantize_bits=32)
    mspec = gan.mlp_gan_spec(d_z=8)
    mparams = gan.mlp_gan_init(torch.Generator().manual_seed(4), d_z=8,
                               d_hidden=16, d_data=64)
    mdata = torch.randn((k, 32, 64), generator=torch.Generator()
                        .manual_seed(5)).cuda()
    draws = on(protocol.DrawSampler(mspec, mlp, seed=2, n_local=32,
                                    n_params=0, device="cpu")(0), "cuda")
    w = torch.full((k,), 16.0, device="cuda")
    rounds = {}
    for label, p in (("whole", mlp), ("micro", dataclasses.replace(
            mlp, micro_batch_d=2, micro_batch_g=4))):
        state = protocol.make_train_state(lambda g: mparams, p, k,
                                          device="cuda")
        rounds[label] = protocol.gan_round(mspec, p, state, mdata, w, draws)
    (s_w, m_w), (s_m, m_m) = rounds["whole"], rounds["micro"]
    diff = max(float((a - b).abs().max()) for a, b in
               zip(tree_leaves(s_w), tree_leaves(s_m)))
    if diff > 1e-6 or any(abs(float(m_w[key]) - float(m_m[key])) > 1e-6
                          for key in m_w):
        raise AssertionError(f"MLP-GAN: the microbatched round differs "
                             f"from the whole batch by {diff:.3e}")
    print(f"MLP-GAN (K={k}, no batch-norm): the microbatched round on the "
          f"card equals the whole-batch round to {diff:.3e} (atol 1e-6)")
    return {"mlp_micro_vs_whole": diff}


# The paper's experiments on the card at full width, 2 rounds a setting
# with FID at round 2: (name, (wavg, trimmed_wavg) launches on the
# device). A fused Trainer runs its averaging kernel once a round: the
# eager first round, then one replay a round; the centralized baseline
# runs on the host driver and averages nothing.
EXPERIMENTS = [
    ("quickstart", (20, 0)),             # one fused Trainer, 20 rounds
    ("fig3_schedules", (12, 0)),         # 6 settings
    ("fig4_devices", (4, 0)),            # centralized, K=5, K=10
    ("fig5_fedgan", (3 * 2 + 2 * 4, 0)),  # 3 proposed, 2 FedGAN (2 nets)
    ("fig6_scheduling", (6, 0)),         # 3 ratios
    # mean x4 (fr0, fr4, byz3, identity), krum x2: wavg; trimmed x3
    ("fig_robust --smoke", (12, 6)),
]


class PathWatch:
    """The kernels of a path that replays CUDA graphs, watched from
    outside the program. A fused Trainer calls a wrapper in its eager
    first round and again while it captures the round graph, which
    records the launch without running it; each replay runs the
    recorded launches and calls no wrapper. So the launches that ran on
    the device are the wrappers' counts, less the calls made during a
    capture, plus each graph's captured calls once per replay. The
    watch also keeps the arguments' shapes of every wrapper call, so
    the kernels can be held against their plain versions at exactly
    the path's shapes.

    kernels: {name: (ops module, wrapper name, shape(args, kwargs))}."""

    def __init__(self, torch, kernels):
        self.torch, self.kernels = torch, kernels
        self.shapes = {name: set() for name in kernels}
        self.calls = dict.fromkeys(kernels, 0)     # seen by the watch
        self.captured = dict.fromkeys(kernels, 0)
        self.replayed = dict.fromkeys(kernels, 0)

    def counts(self):
        """The wrappers' own counts."""
        return {name: mod.launches for name, (mod, _, _) in
                self.kernels.items()}

    def launches(self):
        """Device launches since the watch began (the counts start at 0
        with it)."""
        return {name: n - self.captured[name] + self.replayed[name]
                for name, n in self.counts().items()}

    def __enter__(self):
        torch, watch = self.torch, self
        self._saved = [(torch.cuda, "graph", torch.cuda.graph),
                       (torch.cuda.CUDAGraph, "replay",
                        torch.cuda.CUDAGraph.replay)]
        for name, (mod, attr, shape) in self.kernels.items():
            self._saved.append((mod, attr, getattr(mod, attr)))

            def wrapper(*args, _name=name, _fn=getattr(mod, attr),
                        _shape=shape, **kwargs):
                watch.shapes[_name].add(_shape(args, kwargs))
                watch.calls[_name] += 1
                return _fn(*args, **kwargs)
            setattr(mod, attr, wrapper)

        class graph(torch.cuda.graph):
            def __enter__(inner):
                inner.before = watch.counts()
                return super().__enter__()

            def __exit__(inner, *exc):
                out = super().__exit__(*exc)
                calls = {name: n - inner.before[name]
                         for name, n in watch.counts().items()}
                inner.cuda_graph.path_calls = calls
                for name, n in calls.items():
                    watch.captured[name] += n
                return out

        replay = torch.cuda.CUDAGraph.replay

        def replayed(graph_self):
            replay(graph_self)
            for name, n in getattr(graph_self, "path_calls", {}).items():
                watch.replayed[name] += n
        torch.cuda.graph = graph
        torch.cuda.CUDAGraph.replay = replayed
        for mod in {mod for mod, _, _ in self.kernels.values()}:
            mod.launches = 0
        return self

    def __exit__(self, *exc):
        for owner, attr, value in reversed(self._saved):
            setattr(owner, attr, value)
        missed = {name: n for name, n in self.counts().items()
                  if n != self.calls[name]}
        if missed and not exc[0]:
            raise AssertionError(f"wrapper counts {missed} include calls "
                                 f"the watch did not see: {self.calls}")


def check_path_shapes(torch, watch, wavg_ops, robust_ops,
                      path="experiments"):
    """Every wrapper of the watched path against its plain version, on
    fresh random inputs at each shape the path gave it (rtol RTOL, atol
    ATOL); returns the largest error per kernel."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    err = {}
    for k, n in sorted(watch.shapes["wavg"]):
        x = torch.randn((k, n), generator=gen, device="cuda")
        w = torch.rand(k, generator=gen, device="cuda")
        w = w / w.sum()
        out = wavg_ops.weighted_average(x, w)
        ref = wavg_ops.wavg_ref(x, w)
        torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)
        err["wavg"] = max(err.get("wavg", 0.0),
                          float((out - ref).abs().max()))
    for k, n, trim in sorted(watch.shapes["trimmed_wavg"]):
        x = torch.randn((k, n), generator=gen, device="cuda")
        x[k - 1] = x[k - 2]                # exact ties, as free-riders make
        w = torch.rand(k, generator=gen, device="cuda") + 0.5
        w[0] = 0.0                         # a dropped worker
        out = robust_ops.trimmed_average(x, w, trim=trim)
        ref = robust_ops.trimmed_mean_ref(x, w, trim)
        torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)
        err["trimmed_wavg"] = max(err.get("trimmed_wavg", 0.0),
                                  float((out - ref).abs().max()))
    torch.cuda.synchronize()
    print(f"the {path} path's shapes, each kernel against its plain "
          f"version (rtol {RTOL}, atol {ATOL}): wavg (K, N) "
          f"{sorted(watch.shapes['wavg'])}, trimmed_wavg (K, N, trim) "
          f"{sorted(watch.shapes['trimmed_wavg'])}; max abs err {err}")
    return err


def run_experiments(torch, wavg_ops, robust_ops, directory):
    """8c: the quickstart twin at its defaults, then every figure at the
    paper's full width (REPRO_BENCH_FULL=1, 2 rounds, FID at round 2)
    through `repro_torch.experiments`, under a `PathWatch` (the path's
    counts start at 0 here): each setting's device launches of wavg and
    trimmed_wavg, the quickstart's read beside its device timeline.
    Every curve has its rounds, a finite last FID and a growing
    wallclock; the robustness sweep passes its identity gate; the
    quickstart's checkpoint holds its trained state bit for bit. Then
    each kernel against its plain version at the path's own shapes.
    fig5 runs under cuDNN's deterministic algorithms: its curves, also
    returned, are the stacked twins of 8d's mesh settings."""
    os.environ.update(REPRO_BENCH_FULL="1", REPRO_BENCH_ROUNDS="2",
                      REPRO_BENCH_EVAL_EVERY="2")
    import re
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.examples import quickstart
    from repro_torch.experiments import (common, fig3_schedules,
                                         fig4_devices, fig5_fedgan,
                                         fig6_scheduling, fig_robust)
    from repro_torch.tree import tree_leaves
    if (common.FULL, common.ROUNDS, common.EVAL_EVERY) != (True, 2, 2):
        raise AssertionError("repro_torch.experiments was imported before "
                             "phase 8 set its environment")
    out_dir = os.path.join(directory, "figures")
    timeline = {}

    def quickstart_run():
        ckpt = os.path.join(directory, "quickstart_ckpt")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            trainer = quickstart.main(["--ckpt-dir", ckpt])
            torch.cuda.synchronize()
        names = [e[0] for e in _device_records(torch, prof) if not e[3]]
        timeline.update({kernel: sum(1 for name in names
                                     if re.search(REPLAY_KERNELS[kernel],
                                                  name))
                         for kernel in ("wavg", "trimmed_wavg")})
        fids = [r.fid for r in trainer.history if r.fid is not None]
        if len(trainer.history) != 20 or len(fids) != 4 or not all(
                np.isfinite(fids)):
            raise AssertionError(f"quickstart: {len(trainer.history)} "
                                 f"rounds, FIDs {fids}")
        if not (trainer.driver == "fused" and trainer._graph.captured
                and trainer._graph.replays == 19):
            raise AssertionError("quickstart: not a captured fused run of "
                                 "19 replays")
        tree, step, _ = load_checkpoint(ckpt)
        if step != 20 or not all(
                np.array_equal(a.detach().cpu().numpy(), b) for a, b in
                zip(tree_leaves(trainer.state), tree_leaves(tree))):
            raise AssertionError("quickstart: the checkpoint is not the "
                                 "trained state")
        return [common.Curve("quickstart", [r.round for r in trainer.history],
                             [r.cumulative_s for r in trainer.history],
                             [r.fid for r in trainer.history])]

    def robust_run():
        rc = fig_robust.main(["--smoke", "--rounds", "2", "--json",
                              os.path.join(directory, "robust.json")])
        if rc != 0:
            raise AssertionError(f"fig_robust --smoke exited {rc}")
        with open(os.path.join(directory, "robust.json")) as f:
            sweeps = json.load(f)["sweeps"]
        return [common.Curve(**cell["curve"]) for sweep in sweeps.values()
                for cell in sweep.values()]

    def fig5_run():
        torch.backends.cudnn.deterministic = True
        try:
            return fig5_fedgan.main(out_dir)
        finally:
            torch.backends.cudnn.deterministic = False

    mains = {"quickstart": quickstart_run,
             "fig3_schedules": lambda: fig3_schedules.main(out_dir),
             "fig4_devices": lambda: fig4_devices.main(out_dir),
             "fig5_fedgan": fig5_run,
             "fig6_scheduling": lambda: fig6_scheduling.main(out_dir),
             "fig_robust --smoke": robust_run}
    results, fig5 = {}, None
    with PathWatch(torch, {
            "wavg": (wavg_ops, "weighted_average",
                     lambda a, kw: tuple(a[0].shape)),
            "trimmed_wavg": (robust_ops, "trimmed_average",
                             lambda a, kw: (*a[0].shape, int(kw["trim"])))
    }) as watch:                                    # the path starts here
        for name, want in EXPERIMENTS:
            before = watch.launches()
            calls_before = watch.counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            curves = mains[name]()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            if name == "fig5_fedgan":
                fig5 = curves
            now, calls = watch.launches(), watch.counts()
            got = tuple(now[k] - before[k] for k in ("wavg", "trimmed_wavg"))
            if got != want:
                raise AssertionError(f"{name}: (wavg, trimmed_wavg) device "
                                     f"launches {got}, expected {want}")
            if name == "quickstart" and got != (timeline["wavg"],
                                                timeline["trimmed_wavg"]):
                raise AssertionError(f"quickstart: {got} launches counted, "
                                     f"{timeline} on the device timeline")
            for c in curves:
                n = 20 if name == "quickstart" else 2
                if (c.rounds != list(range(n)) or not np.isfinite(c.fid[-1])
                        or c.wallclock != sorted(c.wallclock)
                        or not c.wallclock[0] > 0):
                    raise AssertionError(f"{name} {c.label}: rounds "
                                         f"{c.rounds}, FID {c.fid}, "
                                         f"wallclock {c.wallclock}")
            n_rounds = sum(len(c.rounds) for c in curves)
            wrapped = tuple(calls[k] - calls_before[k]
                            for k in ("wavg", "trimmed_wavg"))
            results[name] = {"seconds": secs, "settings": len(curves),
                             "s_per_round": secs / n_rounds,
                             "final_fid": {c.label: common.last_fid(c)
                                           for c in curves},
                             "wavg": got[0], "trimmed_wavg": got[1],
                             "wrapper_calls": wrapped}
            print(f"experiment {name}: {len(curves)} setting(s), "
                  f"{secs:.2f} s ({secs / n_rounds:.3f} s a round with "
                  f"set-up and FID), final FID "
                  + ", ".join(f"{c.label} {common.last_fid(c):.3f}"
                              for c in curves)
                  + f"; {got[0]} wavg and {got[1]} trimmed_wavg launches on "
                  f"the device ({wrapped} wrapper calls)"
                  + (f"; device timeline {timeline}"
                     if name == "quickstart" else ""))
        launches = watch.launches()                  # ... and ends here
    print(f"experiments path: device launches {launches}, wrapper calls "
          f"{watch.calls}, of them recorded in a capture {watch.captured}, "
          f"replayed {watch.replayed}")
    errors = check_path_shapes(torch, watch, wavg_ops, robust_ops)
    return results, launches, errors, fig5


# ---------------------------------------------------------------------------
# 8d. The mesh experiments: the figures and mamba2-130m on gloo ranks
# ---------------------------------------------------------------------------

def counted_call(fn, directory, device):
    """`fn(device)` on a mesh rank, watched from the script: the kernels'
    launch counts set to 0 before it and written after it into
    `directory` (a file a rank and call), with the (K, N) shapes the wavg
    wrapper was given; returns fn's result."""
    import torch.distributed as dist
    from repro_torch.kernels.ring_wavg import ops as ring_ops
    from repro_torch.kernels.robust_avg import ops as robust_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.wavg import ops as wavg_ops
    mods = {"wavg": wavg_ops, "trimmed_wavg": robust_ops,
            "ssd_scan": ssd_ops, "ring_accum": ring_ops}
    shapes = set()
    average = wavg_ops.weighted_average

    def recorded(x, w):
        shapes.add(tuple(x.shape))
        return average(x, w)

    for mod in mods.values():
        mod.launches = 0
    wavg_ops.weighted_average = recorded
    try:
        result = fn(device)
    finally:
        wavg_ops.weighted_average = average
    name = f"{dist.get_rank()}_{time.time_ns()}.json"
    with open(os.path.join(directory, name), "w") as f:
        json.dump({"launches": {k: m.launches for k, m in mods.items()},
                   "wavg_shapes": sorted(shapes)}, f)
    return result


class MeshWatch:
    """The kernels that ran on the ranks of the experiments' mesh runs,
    watched from outside the program: `experiments.common.run_on_mesh`
    runs each fn through `counted_call`; `take()` sums every rank's
    counts since the last take and keeps the wavg shapes."""

    def __init__(self, directory):
        self.directory = directory
        self.shapes = {"wavg": set(), "trimmed_wavg": set()}

    def take(self):
        total = {}
        for name in os.listdir(self.directory):
            path = os.path.join(self.directory, name)
            with open(path) as f:
                seen = json.load(f)
            os.remove(path)
            self.shapes["wavg"].update(map(tuple, seen["wavg_shapes"]))
            for kernel, n in seen["launches"].items():
                total[kernel] = total.get(kernel, 0) + n
        return total

    def __enter__(self):
        from repro_torch.experiments import common
        run_on_mesh = self._run_on_mesh = common.run_on_mesh

        def watched(fns, k, device=None, timeout_s=900.0):
            return run_on_mesh([functools.partial(counted_call, fn,
                                                  self.directory)
                                for fn in fns], k, device, timeout_s)
        common.run_on_mesh = watched
        return self

    def __exit__(self, *exc):
        from repro_torch.experiments import common
        common.run_on_mesh = self._run_on_mesh


def records_mismatch(mesh_recs, stacked_recs):
    """What differs between two runs' records: masks, weights, wallclock
    or cumulative clock not bit for bit, a metric beyond 1e-5 relative
    (1e-6 absolute), a FID beyond 1e-4 relative; None if nothing does."""
    import numpy as np
    if len(mesh_recs) != len(stacked_recs):
        return f"{len(mesh_recs)} rounds, stacked {len(stacked_recs)}"
    for m, s in zip(mesh_recs, stacked_recs):
        if not (np.array_equal(m.mask, s.mask)
                and np.array_equal(m.weights, s.weights)
                and (m.wallclock_s, m.cumulative_s) == (s.wallclock_s,
                                                        s.cumulative_s)):
            return (f"round {s.round}: mask {m.mask} weights {m.weights} "
                    f"wallclock {m.wallclock_s}, stacked {s.mask} "
                    f"{s.weights} {s.wallclock_s}")
        if m.metrics.keys() != s.metrics.keys() or any(
                abs(m.metrics[k] - v) > 1e-6 + 1e-5 * abs(v)
                for k, v in s.metrics.items()):
            return f"round {s.round}: metrics {m.metrics}, {s.metrics}"
        if (m.fid is None) != (s.fid is None) or (
                s.fid is not None and abs(m.fid - s.fid) > 1e-4 * s.fid):
            return f"round {s.round}: FID {m.fid}, stacked {s.fid}"
    return None


def _max_rel(mesh_recs, stacked_recs):
    """The largest relative differences of the metrics and FIDs."""
    metric = max((abs(m.metrics[k] - v) / max(abs(v), 1e-30)
                  for m, s in zip(mesh_recs, stacked_recs)
                  for k, v in s.metrics.items()), default=0.0)
    fid = max((abs(m.fid - s.fid) / s.fid for m, s in
               zip(mesh_recs, stacked_recs) if s.fid is not None),
              default=0.0)
    return metric, fid


def _mamba_mesh_run(shards_path, device):
    """mamba2-130m at full width on this rank: `Trainer(layout="mesh")`,
    MAMBA_MESH's host-driver rounds on this rank's shard; returns (the
    records, the seconds of each round, the state finite?)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.tree import tree_leaves
    torch.backends.cudnn.deterministic = True      # as the parent's 8d
    trainer = mamba_trainer(np.load(shards_path, mmap_mode="c"), device,
                            "mesh")
    secs = []
    for _ in range(MAMBA_MESH["rounds"]):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        trainer.run(1)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    finite = all(bool(torch.isfinite(x).all())
                 for x in tree_leaves(trainer.state)
                 if x.is_floating_point())
    return trainer.history, secs, finite


def mamba_mesh_rank(shards_path, directory, rank, world_size, device):
    """`_mamba_mesh_run` on one rank, watched by `counted_call`."""
    _rank_torch()
    return counted_call(functools.partial(_mamba_mesh_run, shards_path),
                        directory, device)


# mamba2-130m on the mesh: K=4 ranks on this card, the host driver,
# phase 7's settings (serial, round_robin at 0.5, fading off), the flat
# all-gather (one wavg launch a rank a round). Each group recomputed in
# the backward (remat, the same math): without it a rank holds 19 GiB,
# 4 ranks more than the card.
MAMBA_MESH = dict(rounds=1, scheduler="round_robin", scheduling_ratio=0.5,
                  schedule="serial", remat=True)


def mamba_trainer(shards, device, layout):
    from repro_torch.configs import ProtocolConfig
    from repro_torch.core import Trainer
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.models import gan
    from repro_torch.models.specs import make_backbone_spec
    bb = MAMBA
    cfg = backbone_config(bb)
    pcfg = ProtocolConfig(
        n_devices=bb["k"], n_d=bb["n_d"], n_g=bb["n_g"],
        sample_size=bb["m"], server_sample_size=bb["m"], lr_d=1e-3,
        lr_g=1e-3, optimizer="adam", schedule=MAMBA_MESH["schedule"],
        scheduler=MAMBA_MESH["scheduler"],
        scheduling_ratio=MAMBA_MESH["scheduling_ratio"])
    return Trainer(make_backbone_spec(cfg, bb["seq"],
                                      remat=MAMBA_MESH["remat"],
                                      gen_loss_variant="nonsaturating"),
                   pcfg, lambda g: gan.gan_init(g, cfg), shards, seed=0,
                   driver="host", layout=layout, device=device,
                   channel_cfg=ChannelConfig(n_devices=bb["k"],
                                             fading=False))


def train_mesh_experiments(torch, directory, mamba_shards, fig5_twin,
                           mamba_twin):
    """8d, the "mesh_experiments" path, under cuDNN's deterministic
    algorithms (the ranks take the setting; with cuDNN free to choose,
    two processes' convolutions differ in the last bits and a 16-bit
    rounding flips): fig5_fedgan --layout mesh --smoke at the paper's
    full width (K=10 gloo ranks on this card, 2 rounds, FID at round 2)
    against `fig5_twin`, 8c's stacked curves of the same settings;
    mamba2-130m at full width on K=4 ranks, 2 rounds, against
    `mamba_twin`, phase 7's host-driver records of the same settings.
    Masks, weights and the wallclock bit for bit, metrics and FIDs as
    `records_mismatch`; each rank's launches summed (wavg once a rank a
    round; 432 ssd_scan launches a mamba2 rank a round: one device's
    n_d (L + 2 L) + n_g 2 L sublayer forwards, L = 24, the 2 L and 2 L
    once more in their backwards). Returns the path's records, its
    launches and the wavg shapes the ranks gave it."""
    torch.backends.cudnn.deterministic = True
    try:
        return _mesh_experiments(torch, directory, mamba_shards, fig5_twin,
                                 mamba_twin)
    finally:
        torch.backends.cudnn.deterministic = False


def _mesh_experiments(torch, directory, mamba_shards, fig5_twin,
                      mamba_twin):
    import tempfile
    import numpy as np
    from repro_torch.experiments import fig5_fedgan
    from repro_torch.launch import mesh
    out, launches = {}, {}
    counts = tempfile.mkdtemp(dir=directory)
    name, want_wavg = "fig5_fedgan --layout mesh --smoke", 10 * 2 * 2
    twin = {c.label: c for c in fig5_twin}
    with MeshWatch(counts) as watch:              # the path starts here
        t0 = time.perf_counter()
        got = fig5_fedgan.main(os.path.join(directory, "mesh"),
                               layout="mesh", smoke=True)
        secs = time.perf_counter() - t0
        seen = watch.take()
        if seen.get("wavg") != want_wavg or any(
                seen.get(k) for k in ("trimmed_wavg", "ssd_scan",
                                      "ring_accum")):
            raise AssertionError(f"{name}: launches {seen}, expected "
                                 f"{want_wavg} wavg")
        pairs = [(c.label, c.records, twin[c.label].records) for c in got]
        for label, mesh_recs, stacked_recs in pairs:
            wrong = records_mismatch(mesh_recs, stacked_recs)
            if wrong:
                raise AssertionError(f"{label}: the mesh run differs from "
                                     f"the stacked run: {wrong}")
        rel = [_max_rel(m, s) for _, m, s in pairs]
        out[name] = {"seconds": secs, "wavg": seen["wavg"],
                     "max_rel_metric": max(r[0] for r in rel),
                     "max_rel_fid": max(r[1] for r in rel)}
        for k, n in seen.items():
            launches[k] = launches.get(k, 0) + n
        print(f"mesh experiment {name}: {secs:.2f} s with 10 ranks' "
              f"start-up; every setting's masks, weights and wallclock "
              f"bitwise 8c's stacked run's, metrics within "
              f"{out[name]['max_rel_metric']:.2e} and FIDs within "
              f"{out[name]['max_rel_fid']:.2e} relative; {seen['wavg']}"
              f" wavg launches over the ranks")

        path = os.path.join(directory, "mamba_shards.npy")
        np.save(path, mamba_shards)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        per_rank = mesh.spawn(functools.partial(mamba_mesh_rank, path,
                                                counts),
                              MAMBA["k"], backend="gloo", timeout_s=600)
        secs = time.perf_counter() - t0
        seen = watch.take()                        # ... and ends here
    rounds, layers = MAMBA_MESH["rounds"], MAMBA["layers"]
    # a rank's sublayer forwards a round: n_d (G without a gradient, D on
    # real and fake) + n_g (G and D), each differentiated pass once more
    # in its backward (remat)
    remat = 2 if MAMBA_MESH["remat"] else 1
    want = {"wavg": MAMBA["k"] * rounds, "trimmed_wavg": 0,
            "ssd_scan": MAMBA["k"] * rounds * (
                MAMBA["n_d"] * (layers + 2 * layers * remat)
                + MAMBA["n_g"] * 2 * layers * remat),
            "ring_accum": 0}
    if seen != want:
        raise AssertionError(f"mamba2-130m on the mesh: launches {seen}, "
                             f"expected {want}")
    for k, n in seen.items():
        launches[k] = launches.get(k, 0) + n
    stacked_recs = list(mamba_twin[:rounds])
    for r, (recs, _, finite) in enumerate(per_rank):
        wrong = records_mismatch(recs, stacked_recs)
        if wrong or not finite:
            raise AssertionError(f"mamba2-130m mesh rank {r}: finite "
                                 f"{finite}; {wrong}")
    if all(rec.mask.all() for rec in stacked_recs):
        raise AssertionError("mamba2-130m on the mesh: round_robin at 0.5 "
                             "scheduled every device")
    metric_rel, _ = _max_rel(per_rank[0][0], stacked_recs)
    round_s = [max(rank[1][t] for rank in per_rank) for t in range(rounds)]
    out["mamba2-130m mesh"] = {"seconds": secs, "round_s": round_s,
                               "max_rel_metric": metric_rel, **seen}
    print(f"mamba2-130m on the mesh (K={MAMBA['k']} gloo ranks on this card, "
          f"host driver, {rounds} rounds): {secs:.2f} s with start-up, "
          f"rounds {[round(x, 3) for x in round_s]} s (slowest rank); "
          f"masks, weights and wallclock bitwise phase 7's host-driver "
          f"rounds on every rank, metrics within "
          f"{metric_rel:.2e} relative; {seen['wavg']} wavg and "
          f"{seen['ssd_scan']} ssd_scan launches over the ranks")
    return out, launches, watch.shapes


def train_experiments(torch, shards, card, wavg_ops, robust_ops,
                      mamba_shards, mamba_records):
    """Phase 8 on `card`; `mamba_records` are phase 7's host-driver
    rounds of mamba2-130m, the stacked twin of its mesh run. Returns the
    "experiments" and "mesh_experiments" paths' launches."""
    import tempfile
    base = os.path.join(ROOT, "results", "torch")
    os.makedirs(base, exist_ok=True)
    directory = tempfile.mkdtemp(prefix="chip_smoke_", dir=base)
    try:
        resume = check_resume(torch, shards, directory)
        stamp("experiments: resume")
        checks = check_centralized_and_microbatched(torch)
        stamp("experiments: centralized and microbatched rounds")
        results, launches, errors, fig5 = run_experiments(
            torch, wavg_ops, robust_ops, directory)
        stamp("experiments: quickstart and figures")
        mesh_runs, mesh_launches, shapes = train_mesh_experiments(
            torch, directory, mamba_shards, fig5, mamba_records)
        errors["mesh"] = check_path_shapes(
            torch, types.SimpleNamespace(shapes=shapes), wavg_ops,
            robust_ops, path="mesh_experiments")
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    print(f"experiments phase on {card}")
    print(json.dumps({"experiments": {"resume": resume, "checks": checks,
                                      "runs": results,
                                      "mesh_runs": mesh_runs,
                                      "path_shapes_max_abs_err": errors}},
                     default=float))
    return {"experiments": launches, "mesh_experiments": mesh_launches}


# ---------------------------------------------------------------------------
# Phase 9: serving
# ---------------------------------------------------------------------------

# The serving paths: granite-3-2b at full width, 4 of its 40 layers (cut
# from full depth to make room for phases 11 and 12; vocabulary 49,155, the
# generator alone) behind the engine at batch 8,
# max_len 1,024, 16-token blocks, 32-token prefill chunks, on 16 seeded
# requests (prompts of 16-512 tokens, 32-64 new, every other one at
# temperature 0.8); gemma3-12b at full width, one 5:1 group and the
# vocabulary cut to 32,768 (as phase 5g), on prompts of 1,100-1,500
# tokens, so that chunked prefill wraps the 1,024-key rings.
SERVE_GRANITE = dict(arch="granite-3-2b", layers=4, batch=8, max_len=1024,
                     block=16, chunk=32, requests=16, prompt=(16, 512),
                     new=(32, 64), prefill=600, gen_size=449_083_392)
SERVE_GEMMA3 = dict(arch="gemma3-12b", layers=6, vocab=32_768, batch=2,
                    max_len=1600, block=16, chunk=32, requests=3,
                    prompt=(1100, 1500), new=(8, 16), gen_size=1_611_747_072)
NEAR_TIE = 1e-4          # a greedy step whose top-2 logit margin is less
SERVE_RTOL = 1e-4        # logits, of the largest |logit| (see close_logits)


def serving_traffic(vocab, setting, seed=0):
    """`setting["requests"]` seeded (prompt, max_new, temperature):
    prompt lengths and new tokens uniform in the setting's ranges, even
    rids greedy and odd ones at temperature 0.8."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lo, hi = setting["prompt"]
    return [(rng.integers(0, vocab, int(rng.integers(lo, hi + 1))).astype(
        np.int32), int(rng.integers(setting["new"][0],
                                    setting["new"][1] + 1)),
             0.0 if rid % 2 == 0 else 0.8)
            for rid in range(setting["requests"])]


def kernel_counts(kernel_mods):
    return {name: mod.launches for name, mod in kernel_mods.items()}


def zero_counts(kernel_mods):
    for mod in kernel_mods.values():
        mod.launches = 0


def serve_traffic(torch, engine, work, kernel_mods):
    """Serve `work` (rids 0..) through `engine` with every launch count
    at 0: {rid: tokens}, the wall seconds, each step's (bucket, seconds)
    and the counts, which must stay 0 (the engine runs no hand-written
    kernel, as the JAX engine reaches no Pallas kernel)."""
    from repro_torch.serving import Request
    steps = []
    get = engine._get_step

    def recording(chunk):        # the bucket of each step
        steps.append([chunk])
        return get(chunk)

    engine._get_step = recording
    for i, (p, n, t) in enumerate(work):
        engine.submit(Request(rid=i, prompt=p, max_new_tokens=n,
                              temperature=t))
    zero_counts(kernel_mods)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while engine.queue or any(s is not None for s in engine.slots):
        t1 = time.perf_counter()
        if not engine.step():
            raise AssertionError("the engine stalled")
        steps[-1].append(time.perf_counter() - t1)   # ends in a readback
    wall = time.perf_counter() - t0
    del engine._get_step
    counts = kernel_counts(kernel_mods)
    if any(counts.values()):
        raise AssertionError(f"hand-written kernels inside the engine: "
                             f"{counts}")
    if engine.rejected or len(engine.finished) != len(work):
        raise AssertionError(f"{len(engine.finished)} of {len(work)} "
                             f"requests finished, rejected "
                             f"{[r.failed for r in engine.rejected]}")
    return ({r.rid: list(r.out_tokens) for r in engine.finished}, wall,
            steps, counts)


def decode_only_ms(steps):
    """Mean ms of the decode-only steps after each program's first."""
    seen, ms = set(), []
    for chunk, secs in steps:
        if chunk is None and chunk in seen:
            ms.append(secs * 1e3)
        seen.add(chunk)
    return statistics.mean(ms), len(ms)


def close_logits(torch, got, want, label):
    """got against want within SERVE_RTOL relative, with an absolute
    floor of SERVE_RTOL times the largest |want| (a logit near 0 has no
    relative scale); returns the max abs error."""
    got, want = got.float(), want.float()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, rtol=SERVE_RTOL,
                               atol=SERVE_RTOL * scale, msg=lambda m:
                               f"{label}: {m}")
    return err, scale


def teacher_forced(torch, gan, params, cfg, prompt, tokens, mode="train",
                   enc_feats=None):
    """The full forward's logits before each of `tokens`, fed the prompt
    and `tokens`: (len(tokens), vocab) float32. mode="prefill" routes
    every MoE token (serving's dropless forward; "train" drops at
    capacity); enc_feats: a conditioned family's (1, t, d) features."""
    import numpy as np
    seq = torch.from_numpy(np.concatenate(
        [np.asarray(prompt), np.asarray(tokens[:-1])]).astype(np.int64)).to(
        params["embed"]["table"].device)[None]
    with torch.no_grad():
        logits = gan.generator_lm_apply(params, cfg, seq, mode=mode,
                                        enc_feats=enc_feats,
                                        remat=False)["logits"][0]
    return logits[len(prompt) - 1:].float()


def held_until_tie(tokens, ref_tokens, ref_logits, label):
    """`tokens` equal `ref_tokens` up to the first step whose reference
    top-2 logit margin is under NEAR_TIE; returns that step (None: no
    near tie)."""
    top2 = ref_logits.topk(2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).cpu().tolist()
    for j, (a, b) in enumerate(zip(tokens, ref_tokens)):
        if margin[j] < NEAR_TIE:
            return j
        if a != b:
            raise AssertionError(f"{label}: step {j} gives {a}, the "
                                 f"reference {b} (its top-2 margin "
                                 f"{margin[j]:.3e})")
    return None


def chunked_prefill(torch, gan, cfg, params, prompt, chunk, cache_len,
                    enc_feats=None):
    """The engine's chunked prefill of one prompt, as its step runs it:
    `generator_lm_apply` in decode mode over chunks of `chunk` tokens
    (the last padded to a power-of-two bucket, its tail masked) at their
    positions, against dense float32 caches of `cache_len` (a conditioned
    family's cross caches filled first from `enc_feats`, as the engine
    fills them). Returns the prompt's logits and the caches."""
    from repro_torch.models.backbone import (fill_cross_caches,
                                             init_decode_caches)
    from repro_torch.serving.engine import _pow2_bucket
    device = params["embed"]["table"].device
    caches = init_decode_caches(cfg, 1, cache_len, dtype=torch.float32,
                                device=device)
    if enc_feats is not None:
        fill_cross_caches(caches, params, cfg, enc_feats)
    logits = []
    with torch.no_grad():
        for p0 in range(0, len(prompt), chunk):
            piece = torch.as_tensor(prompt[p0:p0 + chunk], device=device)
            n = len(piece)
            bucket = chunk if n == chunk else _pow2_bucket(n)
            steps = torch.arange(bucket, device=device)
            toks = torch.zeros((1, bucket), dtype=torch.int64, device=device)
            toks[0, :n] = piece
            out = gan.generator_lm_apply(
                params, cfg, toks, mode="decode", caches=caches,
                positions=(p0 + steps)[None],
                cache_write_mask=(steps < n)[None], remat=False)
            logits.append(out["logits"][0, :n])
    return torch.cat(logits), caches


def prefill_against_chunked(torch, gan, cfg, params, prompt, names,
                            kernel_mods, n_decode=4, chunk=32,
                            enc_feats=None):
    """One `mode="prefill"` call on `prompt` (it launches the kernels
    `names`: the flash attention, the SSD scan with its final state, or
    both for a hybrid), then `n_decode` greedy decode steps from its
    caches (scalar cache_index); the same prompt through the engine's
    chunked prefill and the same tokens decoded at their positions.
    enc_feats: a conditioned family's (1, t, d) features (the prefill
    call's encoder or image states; the chunked prefill's cross caches).
    Logits held at SERVE_RTOL. Returns {name: launches} of the prefill
    call and the errors."""
    device = params["embed"]["table"].device
    n = len(prompt)
    toks = torch.as_tensor(prompt, device=device)[None]
    zero_counts(kernel_mods)
    with torch.no_grad():
        pre = gan.generator_lm_apply(params, cfg, toks, mode="prefill",
                                     prefill_cache_len=n + n_decode,
                                     enc_feats=enc_feats, remat=False)
    torch.cuda.synchronize()
    launches = kernel_counts(kernel_mods)
    if any(v for k, v in launches.items() if k not in names):
        raise AssertionError(f"prefill launched {launches}")
    ref, caches = chunked_prefill(torch, gan, cfg, params, prompt, chunk,
                                  n + n_decode, enc_feats)
    errs = {"prefill": close_logits(torch, pre["logits"][0], ref,
                                    f"{cfg.name} prefill")}
    cur = pre["logits"][0, -1].argmax()
    pre_caches = pre["caches"]
    dec = []
    with torch.no_grad():
        for t in range(n_decode):
            tok = cur.reshape(1, 1)
            a = gan.generator_lm_apply(params, cfg, tok, mode="decode",
                                       caches=pre_caches, cache_index=n + t,
                                       remat=False)["logits"][0, 0]
            b = gan.generator_lm_apply(
                params, cfg, tok, mode="decode", caches=caches,
                positions=torch.full((1, 1), n + t, device=device),
                remat=False)["logits"][0, 0]
            dec.append(close_logits(torch, a, b,
                                    f"{cfg.name} decode step {t}"))
            cur = a.argmax()
    zero_counts(kernel_mods)
    errs["decode"] = max(dec)
    return {name: launches[name] for name in names}, errs


def serving_engine(torch, cfg, params, setting, *, paged, capture=True,
                   enc_feats_fn=None):
    from repro_torch.serving import ServingEngine
    torch.cuda.empty_cache()
    eng = ServingEngine(cfg, params, batch_size=setting["batch"],
                        max_len=setting["max_len"],
                        block_size=setting["block"] if paged else None,
                        prefill_chunk=setting["chunk"],
                        enc_feats_fn=enc_feats_fn, seed=0, device="cuda")
    eng._capture = capture
    return eng


def serve_granite(torch, kernel_mods, out):
    """9a: granite-3-2b at full width (SERVE_GRANITE's depth): the traffic
    through the
    paged engine (captured), the dense engine (captured) and the paged
    engine stepped uncaptured; the greedy tokens against the full
    forward; one mode="prefill" call of 600 tokens against the engine's
    chunked prefill. Returns the paged engine, the greedy requests and
    their tokens, and the path's flash_attn launches."""
    from repro_torch.core.protocol import count_params
    from repro_torch.models import gan
    from repro_torch.tree import tree_leaves
    setting = SERVE_GRANITE
    cfg = backbone_config(setting)
    torch.cuda.reset_peak_memory_stats()
    params = gan.generator_init(torch.Generator("cuda").manual_seed(0), cfg)
    size = count_params(params)
    if size != setting["gen_size"]:
        raise AssertionError(f"{cfg.name} generator {size}")
    lm_bytes = 4 * (count_params(params["backbone"])
                    + params["lm_head"].numel())
    work = serving_traffic(cfg.vocab, setting)
    runs = {}
    for label, paged, capture in (("paged", True, True),
                                  ("dense", False, True),
                                  ("paged uncaptured", True, False)):
        eng = serving_engine(torch, cfg, params, setting, paged=paged,
                             capture=capture)
        toks, wall, steps, _ = serve_traffic(torch, eng, work, kernel_mods)
        runs[label] = dict(tokens=toks, wall=wall, steps=steps, engine=eng,
                           bytes=eng.cache_bytes())
        if label == "dense":
            del eng, runs[label]["engine"]
    paged, dense, eager = (runs[k] for k in ("paged", "dense",
                                             "paged uncaptured"))
    if dense["tokens"] != paged["tokens"]:
        raise AssertionError("granite: paged and dense tokens differ")
    if eager["tokens"] != paged["tokens"]:
        raise AssertionError("granite: captured and uncaptured tokens "
                             "differ")
    for a, b in zip(tree_leaves(paged["engine"].caches),
                    tree_leaves(eager["engine"].caches)):
        if not torch.equal(a, b):
            raise AssertionError("granite: captured and uncaptured cache "
                                 "leaves differ")
    engine = paged["engine"]
    del eager["engine"]
    torch.cuda.empty_cache()
    greedy = [rid for rid, (_, _, t) in enumerate(work) if t == 0.0][:4]
    ties = {}
    for rid in greedy:
        prompt, _, _ = work[rid]
        toks = paged["tokens"][rid]
        ref = teacher_forced(torch, gan, params, cfg, prompt, toks)
        ties[rid] = held_until_tie(toks, ref.argmax(-1).tolist(), ref,
                                   f"granite rid {rid}")
    prompt = serving_traffic(cfg.vocab, dict(setting, requests=1,
                                             prompt=(setting["prefill"],) * 2),
                             seed=5)[0][0]
    launched, errs = prefill_against_chunked(torch, gan, cfg, params, prompt,
                                             ("flash_attn",), kernel_mods)
    flash = launched["flash_attn"]
    if flash != cfg.n_layers:
        raise AssertionError(f"granite prefill: {flash} flash_attn "
                             f"launches, expected {cfg.n_layers}")
    prof = profile_decode(torch, engine, cfg.vocab)
    n_tok = sum(len(t) for t in paged["tokens"].values())
    dec_ms, n_dec = decode_only_ms(paged["steps"])
    eager_ms, _ = decode_only_ms(eager["steps"])
    first = paged["steps"][0][1]
    out["granite-3-2b"] = dict(
        generator_params=size, tokens=n_tok,
        tokens_per_s=n_tok / paged["wall"], wall_s=paged["wall"],
        steps=engine.dispatch_count, captures=engine.compile_count,
        first_step_s=first,
        first_step_per_program_s={str(c): s for c, s in
                                  _first_steps(paged["steps"]).items()},
        decode_step_ms=dec_ms, decode_steps=n_dec,
        uncaptured_decode_step_ms=eager_ms,
        uncaptured_wall_s=eager["wall"], dense_wall_s=dense["wall"],
        weight_read_bound_ms=lm_bytes / HBM_BYTES_PER_S * 1e3,
        lm_weight_bytes=lm_bytes, cache_bytes_paged=paged["bytes"],
        cache_bytes_dense=dense["bytes"], decode_step_profile=prof,
        first_near_tie=ties,
        prefill_flash_attn=flash, prefill_max_abs_err=errs,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    r = out["granite-3-2b"]
    print(f"9a granite-3-2b ({cfg.n_layers} layers, {size:,} generator "
          f"parameters): "
          f"{len(work)} requests, {n_tok} tokens in {paged['wall']:.3f} s "
          f"({r['tokens_per_s']:.1f} tokens/s), {engine.dispatch_count} "
          f"steps, {engine.compile_count} captures; first step (eager + "
          f"capture) {first:.3f} s; decode-only step replayed "
          f"{dec_ms:.3f} ms (mean of {n_dec}), uncaptured {eager_ms:.3f} "
          f"ms, weight-read bound {r['weight_read_bound_ms']:.3f} ms "
          f"({lm_bytes / 1e9:.2f} GB at 3.35 TB/s); cache bytes dense "
          f"{dense['bytes']:,}, paged {paged['bytes']:,}; paged = dense = "
          f"uncaptured tokens, captured = uncaptured cache leaves, bit for "
          f"bit; 0 kernel launches in the engine; greedy against the full "
          f"forward, first near tie (margin < {NEAR_TIE}) by rid: {ties}; "
          f"prefill of {len(prompt)} tokens: {flash} flash_attn launches, "
          f"logits max abs err {errs}; peak {r['peak_gib']:.2f} GiB; a "
          f"profiled decode-only replay: {prof['wall_ms']:.3f} ms wall, "
          f"{prof['busy_ms']:.3f} ms device busy, "
          f"{prof['device_ops']:.0f} device ops, top kernels (ms) "
          f"{prof['top_kernels_ms']}")
    greedy_work = [(work[rid][0], work[rid][1]) for rid in greedy]
    greedy_tokens = [paged["tokens"][rid] for rid in greedy]
    return (engine, greedy_work, greedy_tokens, [ties[rid] for rid in greedy],
            flash)


def profile_decode(torch, engine, vocab, n_steps=3):
    """Where a replayed decode-only step's time goes: the idle `engine`
    takes one 16-token request a slot, steps until every slot decodes,
    then `n_steps` decode-only steps run under torch.profiler's CUDA
    activity: wall and device-busy ms a step, device ops a step, and
    the kernels that take the most device time."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import Request
    rng = np.random.default_rng(7)
    for i in range(engine.b):
        engine.submit(Request(
            rid=1000 + i, prompt=rng.integers(0, vocab, 16).astype(np.int32),
            max_new_tokens=engine.b + n_steps + 2))
    while not all(s is not None and s.prefilled for s in engine.slots):
        engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            engine.step()
        wall = time.perf_counter() - t0
    events = [e[:3] for e in _device_records(torch, prof) if not e[3]]
    busy = sum(b - a for a, b in _merged(e[1:] for e in events)) / 1e9
    by_name = {}
    for name, start, stop in events:
        by_name[name] = by_name.get(name, 0) + (stop - start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    engine.run()
    engine.finished.clear()
    return dict(wall_ms=wall / n_steps * 1e3,
                busy_ms=busy / n_steps * 1e3,
                device_ops=len(events) / n_steps,
                top_kernels_ms=[(name[:70], ns / n_steps / 1e6)
                                for name, ns in top])


def _first_steps(steps):
    first = {}
    for chunk, secs in steps:
        first.setdefault(chunk, secs)
    return first


def serve_mamba2(torch, gen, directory, kernel_mods, out):
    """9b: phase 7's host-trained mamba2-130m generator (on the host),
    saved with the port's save_checkpoint in the Trainer layout and
    served through `launch.serve.main` on the card and on the CPU: the
    card's greedy tokens held to the CPU's up to the first near tie; one
    mode="prefill" of 512 tokens against the engine's chunked prefill.
    Returns the path's ssd_scan launches."""
    import io
    import re
    import numpy as np
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs import get_arch_config
    from repro_torch.launch import serve
    from repro_torch.models import gan
    from repro_torch.tree import tree_map
    cfg = get_arch_config("mamba2-130m")
    ckpt = os.path.join(directory, "mamba2_gen")
    t0 = time.perf_counter()
    save_checkpoint(ckpt, 3, {"state": {"gen": gen}})
    save_s = time.perf_counter() - t0
    argv = ["--arch", "mamba2-130m", "--ckpt-dir", ckpt, "--demo", "6",
            "--max-new", "24", "--batch", "4", "--max-len", "128",
            "--block-size", "16", "--prefill-chunk", "8"]
    served = {}
    for where, device in (("card", "cuda"), ("host", "cpu")):
        buf = io.StringIO()
        zero_counts(kernel_mods)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            if serve.main(argv + ["--device", device]) != 0:
                raise AssertionError(f"serve.main on {device} failed")
        secs = time.perf_counter() - t0
        if where == "card" and any(kernel_counts(kernel_mods).values()):
            raise AssertionError(f"kernels inside the engine: "
                                 f"{kernel_counts(kernel_mods)}")
        text = buf.getvalue()
        served[where] = ({int(m.group(1)): json.loads(m.group(2))
                          for m in re.finditer(r"rid=(\d+): (\[.*\])",
                                               text)}, secs, text)
    card, cpu = served["card"][0], served["host"][0]
    if sorted(card) != sorted(cpu) or not card:
        raise AssertionError(f"mamba2 served {sorted(card)} on the card, "
                             f"{sorted(cpu)} on the CPU")
    params_cpu = tree_map(lambda t: t.float(), gen)
    rng = np.random.default_rng(0)     # serve.main's demo prompts
    ties = {}
    for rid in sorted(cpu):
        prompt = rng.integers(1, cfg.vocab, rng.integers(4, 17))
        ref = teacher_forced(torch, gan, params_cpu, cfg, prompt, cpu[rid])
        held_until_tie(cpu[rid], ref.argmax(-1).tolist(), ref,
                       f"mamba2 CPU rid {rid}")
        ties[rid] = held_until_tie(card[rid], cpu[rid], ref,
                                   f"mamba2 card rid {rid}")
    params = tree_map(lambda t: t.to("cuda"), gen)
    prompt = np.random.default_rng(6).integers(0, cfg.vocab, 512)
    launched, errs = prefill_against_chunked(torch, gan, cfg, params, prompt,
                                             ("ssd_scan",), kernel_mods)
    ssd = launched["ssd_scan"]
    if ssd != cfg.n_layers:
        raise AssertionError(f"mamba2 prefill: {ssd} ssd_scan launches, "
                             f"expected {cfg.n_layers}")
    out["mamba2-130m"] = dict(save_s=save_s, serve_card_s=served["card"][1],
                              serve_cpu_s=served["host"][1],
                              first_near_tie=ties, prefill_ssd_scan=ssd,
                              prefill_max_abs_err=errs)
    print(f"9b mamba2-130m, phase 7's host-trained generator: saved in "
          f"{save_s:.2f} s, served by launch.serve.main on the card in "
          f"{served['card'][1]:.2f} s and on the CPU in "
          f"{served['host'][1]:.2f} s; card = CPU greedy tokens, first near "
          f"tie by rid: {ties}; the card's summary: "
          f"{served['card'][2].strip().splitlines()[-1]}; prefill of 512 "
          f"tokens: {ssd} ssd_scan launches, logits max abs err {errs}")
    return ssd


def serve_gemma3(torch, kernel_mods, out):
    """9c: gemma3-12b at full width (one 5:1 group, vocabulary 32,768):
    prompts of 1,100-1,500 tokens wrap the 1,024-key rings in chunked
    prefill; the global layer pages. Paged and dense tokens bit for bit;
    the first sampled position's logits (the engine's chunked prefill)
    against the full forward."""
    from repro_torch.core.protocol import count_params
    from repro_torch.models import gan
    setting = SERVE_GEMMA3
    cfg = backbone_config(setting)
    torch.cuda.empty_cache()
    params = gan.generator_init(torch.Generator("cuda").manual_seed(0), cfg)
    if count_params(params) != setting["gen_size"]:
        raise AssertionError(f"{cfg.name} generator {count_params(params)}")
    work = serving_traffic(cfg.vocab, setting, seed=1)
    runs = {}
    for paged in (True, False):
        eng = serving_engine(torch, cfg, params, setting, paged=paged)
        runs[paged] = serve_traffic(torch, eng, work, kernel_mods)[:2]
        del eng
    if runs[True][0] != runs[False][0]:
        raise AssertionError("gemma3: paged and dense tokens differ")
    prompt = work[0][0]
    chunked, _ = chunked_prefill(torch, gan, cfg, params, prompt,
                                 setting["chunk"], setting["max_len"])
    with torch.no_grad():
        full = gan.generator_lm_apply(
            params, cfg, torch.as_tensor(prompt, device="cuda")[None],
            mode="train", remat=False)["logits"][0, -1]
    zero_counts(kernel_mods)
    err = close_logits(torch, chunked[-1], full, "gemma3 first sample")
    out["gemma3-12b"] = dict(paged_wall_s=runs[True][1],
                             dense_wall_s=runs[False][1],
                             tokens=sum(len(t) for t in runs[True][0].values()),
                             first_sample_max_abs_err=err)
    print(f"9c gemma3-12b (one 5:1 group, vocab 32,768): prompts "
          f"{[len(p) for p, _, _ in work]} tokens, paged = dense tokens bit "
          f"for bit ({runs[True][1]:.2f} / {runs[False][1]:.2f} s); the "
          f"first sampled position's logits against the full forward: max "
          f"abs err {err}")
    del params


def serve_frontend(torch, engine, greedy_work, greedy_tokens):
    """9d: two threads submit 9a's greedy requests to a ServingFrontend
    over 9a's paged engine (its graphs replay on the driver thread):
    the futures resolve to 9a's tokens; a request that cannot fit
    raises RuntimeError."""
    import threading
    import numpy as np
    from repro_torch.serving import ServingFrontend
    engine.finished.clear()
    engine.rejected.clear()
    futures = {}
    with ServingFrontend(engine) as front:
        def submit(idx):
            for i in idx:
                p, n = greedy_work[i]
                futures[i] = front.submit(p, max_new_tokens=n)

        threads = [threading.Thread(target=submit, args=(idx,))
                   for idx in (range(0, len(greedy_work), 2),
                               range(1, len(greedy_work), 2))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        too_long = front.submit(np.ones(engine.max_len, np.int32), 8)
        got = [futures[i].result(timeout=300).out_tokens
               for i in range(len(greedy_work))]
        try:
            too_long.result(timeout=300)
            raise AssertionError("the frontend served a request that "
                                 "cannot fit")
        except RuntimeError as exc:
            reason = str(exc)
    if got != greedy_tokens:
        raise AssertionError("frontend tokens differ from 9a's")
    print(f"9d frontend: two threads, {len(got)} greedy requests resolved "
          f"to 9a's tokens; a request that cannot fit: RuntimeError "
          f"({reason})")


def serve_phase(torch, card, kernel_mods, mamba_gen):
    """Phase 9 on `card`. Returns the "serving" path's launches by
    kernel: the mode="prefill" calls' (9a's flash_attn, 9b's ssd_scan);
    the engines launch none; and what phase 10c serves again at tp=2:
    9a's greedy requests, their tokens and first near ties, and 9a's
    decode-only step ms, replayed and uncaptured."""
    import tempfile
    out = {}
    engine, greedy_work, greedy_tokens, greedy_ties, flash = serve_granite(
        torch, kernel_mods, out)
    stamp("serving: granite-3-2b")
    serve_frontend(torch, engine, greedy_work, greedy_tokens)
    del engine
    torch.cuda.empty_cache()
    stamp("serving: frontend")
    base = os.path.join(ROOT, "results", "torch")
    os.makedirs(base, exist_ok=True)
    directory = tempfile.mkdtemp(prefix="chip_smoke_serve_", dir=base)
    try:
        ssd = serve_mamba2(torch, mamba_gen, directory, kernel_mods, out)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    stamp("serving: mamba2-130m")
    serve_gemma3(torch, kernel_mods, out)
    torch.cuda.empty_cache()
    stamp("serving: gemma3-12b")
    print(f"serving phase on {card}")
    print(json.dumps({"serving": out}, default=float))
    granite = out["granite-3-2b"]
    return ({"flash_attn": flash, "ssd_scan": ssd},
            (greedy_work, greedy_tokens, greedy_ties,
             {"replayed": granite["decode_step_ms"],
              "uncaptured": granite["uncaptured_decode_step_ms"]}))


# ---------------------------------------------------------------------------
# Phase 10: tensor parallelism
# ---------------------------------------------------------------------------

TP = 2
# 10a: phase 7's MLP-GAN (d_z 8, 16 hidden, 64-dim data, m=M=4, 16-bit
# uplink, SGD, round_robin at 0.5) on K = 4 workers of TP model ranks:
# 8 gloo ranks share the card. Every algorithm x schedule x mesh driver.
TP_MLP = dict(k=4, rounds=2, d_z=8, d_hidden=16, d_data=64, n_local=8)
TP_MLP_RUNS = tuple((algorithm, schedule, driver)
                    for algorithm in ("proposed", "fedgan")
                    for schedule in ("serial", "parallel")
                    for driver in ("host", "fused"))
# 10b: granite-3-2b at full width, 2 of its 40 layers, K = 2 workers of
# TP ranks (4 ranks), m = 4 sequences of 1,024 tokens, n_d = n_g = 2,
# 16-bit uplink, SGD at 1e-3 (the paper's optimizer; Adam's first step
# would move an element whose gradient is round-off by up to its
# learning rate, which no tolerance on the TP arithmetic could name).
# sizes: the worker's global (G, D) parameters; per_round: flash_attn
# launches a rank a round (launches_per_round at K = 1).
TP_GRANITE = dict(arch="granite-3-2b", k=2, n_d=2, n_g=2, m=4, seq=1024,
                  layers=2, rounds=1, sizes=(327_440_384, 226_510_848),
                  per_round=20)
TP_PARAM_ATOL = 1e-5      # parameters: f32 round-off of the w_out sums ...
TP_METRIC_RTOL = 1e-4     # ... objectives, relative (JAX's tp test: 1e-4)


def _tp_mlp_trainer(run, data, device, tp):
    """10a's Trainer of `run` (algorithm, schedule, driver): the stacked
    layout at tp=1, the mesh layout at tp > 1."""
    from repro_torch.configs import ProtocolConfig
    from repro_torch.core import Trainer
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.models import gan
    algorithm, schedule, driver = run
    s = TP_MLP
    pcfg = ProtocolConfig(n_devices=s["k"], n_d=1, n_g=1, sample_size=4,
                          server_sample_size=4, lr_d=1e-3, lr_g=1e-3,
                          schedule=schedule, scheduler="round_robin",
                          scheduling_ratio=0.5)
    return Trainer(
        gan.mlp_gan_spec(d_z=s["d_z"], tp_axis="model" if tp > 1 else None),
        pcfg, lambda g: gan.mlp_gan_init(g, d_z=s["d_z"],
                                         d_hidden=s["d_hidden"],
                                         d_data=s["d_data"]),
        data, seed=0, algorithm=algorithm, driver=driver, device=device,
        layout="mesh" if tp > 1 else "stacked", tp=tp,
        channel_cfg=ChannelConfig(n_devices=s["k"], fading=False))


def tp_mlp_rank(data, rank, world_size, device):
    """10a on one rank: every run of TP_MLP_RUNS through
    `Trainer(layout="mesh", tp=TP)`, the wavg count set to 0 just before
    the path and read around every round. Returns ([per run: rounds,
    the gathered global state, the rank's payload elements], wavg
    launches)."""
    _rank_torch()
    from repro_torch.kernels.wavg import ops as wavg_ops
    from repro_torch.tree import tree_leaves
    wavg_ops.launches = 0                          # the path starts here
    out = []
    for run in TP_MLP_RUNS:
        trainer = _tp_mlp_trainer(run, data, device, TP)
        local = sum(x.numel() for x in
                    tree_leaves(trainer._algo.payload(trainer.state)))
        rounds = []
        for _ in range(TP_MLP["rounds"]):
            before = wavg_ops.launches
            rec = trainer.run(1)[-1]
            rounds.append(dict(mask=rec.mask, weights=rec.weights,
                               wall=rec.wallclock_s, metrics=rec.metrics,
                               wavg=wavg_ops.launches - before))
        out.append(dict(rounds=rounds, state=trainer._global_state(),
                        local=local))
    return out, wavg_ops.launches                  # ... and ends here


def _tp_diff(torch, got, want, quantized, bits=16):
    """Max |got - want| over a state entry, less one quantization step
    of the leaf (its global abs-max / levels) on a quantized net; and
    the raw max."""
    from repro_torch.tree import tree_leaves
    worst, raw = 0.0, 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        a = torch.as_tensor(a).float().cpu()
        b = torch.as_tensor(b).float().cpu()
        d = float((a - b).abs().max()) if a.numel() else 0.0
        step = (float(b.abs().max()) / (2 ** (bits - 1) - 1)
                if quantized and b.numel() else 0.0)
        worst, raw = max(worst, d - step), max(raw, d)
    return worst, raw


def tp_mlp_phase(torch):
    """10a: 8 gloo ranks (K=4 x TP=2) on the card, each run of
    TP_MLP_RUNS against the stacked tp=1 Trainer of the same seed and
    driver (fading off): masks, weights and the wallclock bit for bit,
    metrics within TP_METRIC_RTOL, the gathered parameters within
    TP_PARAM_ATOL (plus one quantization step on the quantized nets);
    the per-rank Algorithm-2 payload (`tp_local_size`) against tp=1's;
    1 wavg launch a rank a round. Returns its summary."""
    import numpy as np
    from repro_torch.core import protocol
    from repro_torch.launch import mesh
    from repro_torch.sharding import rules
    s = TP_MLP
    data = np.tanh(np.random.default_rng(9).standard_normal(
        (s["k"], s["n_local"], s["d_data"]))).astype(np.float32)
    world = s["k"] * TP
    t0 = time.perf_counter()
    per_rank = mesh.spawn(functools.partial(tp_mlp_rank, data), world,
                          backend="gloo", timeout_s=600, tp=TP)
    secs = time.perf_counter() - t0
    summary = {"ranks": world, "seconds": secs, "runs": {}}
    for i, run in enumerate(TP_MLP_RUNS):
        ref = _tp_mlp_trainer(run, data, "cuda", 1)
        want = ref.run(s["rounds"])
        payload = ref._algo.payload(ref.state)
        full = protocol.count_params(payload)
        local = rules.tp_local_size(payload, TP)
        worst = {}
        for r, (out, _) in enumerate(per_rank):
            got = out[i]
            if got["local"] != local:
                raise AssertionError(f"10a {run} rank {r}: payload "
                                     f"{got['local']}, tp_local_size "
                                     f"{local}")
            for t, (rec, g) in enumerate(zip(want, got["rounds"])):
                if not (np.array_equal(g["mask"], rec.mask)
                        and np.array_equal(g["weights"], rec.weights)
                        and g["wall"] == rec.wallclock_s):
                    raise AssertionError(
                        f"10a {run} round {t} rank {r}: mask {g['mask']} "
                        f"weights {g['weights']} wall {g['wall']!r}, tp=1 "
                        f"{rec.mask} {rec.weights} {rec.wallclock_s!r}")
                for key, value in rec.metrics.items():
                    if abs(g["metrics"][key] - value) > TP_METRIC_RTOL * max(
                            1.0, abs(value)):
                        raise AssertionError(f"10a {run} round {t} rank {r} "
                                             f"{key} {g['metrics'][key]} vs "
                                             f"{value}")
                if g["wavg"] != 1:
                    raise AssertionError(f"10a {run} round {t} rank {r}: "
                                         f"{g['wavg']} wavg launches")
            quantized = (("gen", "disc") if run[0] == "fedgan"
                         else ("disc",))
            for part in ("gen", "disc"):
                d, raw = _tp_diff(torch, got["state"][part],
                                  ref.state[part], part in quantized)
                worst[part] = max(worst.get(part, 0.0), raw)
                if d > TP_PARAM_ATOL:
                    raise AssertionError(f"10a {run} rank {r} {part}: "
                                         f"{raw} from tp=1")
        summary["runs"]["/".join(run)] = dict(
            payload_per_rank=local, payload_tp1=full,
            max_abs_diff=worst)
        print(f"10a MLP-GAN {'/'.join(run):24s}: masks, weights and "
              f"wallclock bitwise tp=1's on all {world} ranks; max |param "
              f"- tp=1| gen {worst['gen']:.3e} disc {worst['disc']:.3e}; "
              f"Algorithm-2 payload a rank {local} of tp=1's {full}")
        del ref
    launches = sum(c for _, c in per_rank)
    want_launches = world * len(TP_MLP_RUNS) * s["rounds"]
    if launches != want_launches:
        raise AssertionError(f"10a: {launches} wavg launches, expected "
                             f"{want_launches}")
    summary["wavg"] = launches
    print(f"10a: {launches} wavg launches over {world} ranks (1 a rank a "
          f"round), {secs:.2f} s with process start-up")
    return summary


def _tp_granite_trainer(shards, device, tp):
    from repro_torch.configs import ProtocolConfig
    from repro_torch.core import Trainer
    from repro_torch.models import gan
    from repro_torch.models.specs import make_backbone_spec
    bb = TP_GRANITE
    cfg = backbone_config(bb)
    pcfg = ProtocolConfig(n_devices=bb["k"], n_d=bb["n_d"], n_g=bb["n_g"],
                          sample_size=bb["m"], server_sample_size=bb["m"],
                          lr_d=1e-3, lr_g=1e-3, optimizer="sgd",
                          schedule="serial", scheduler="all")
    spec = make_backbone_spec(cfg, bb["seq"], remat=False,
                              gen_loss_variant="nonsaturating",
                              tp_axis="model" if tp > 1 else None)
    return Trainer(spec, pcfg, lambda g: gan.gan_init(g, cfg), shards,
                   seed=0, driver="host", device=device,
                   layout="mesh" if tp > 1 else "stacked", tp=tp)


def _tp_param_diffs(torch, trainer, reference, r, device):
    """Per net on this rank: max |shard - tp=1's|, less one quantization
    step (the leaf's global abs-max / levels) on the discriminator, the
    quantized upload; and the raw max. `reference` holds tp=1's leaves,
    one .npy a leaf (`_save_leaves`)."""
    import numpy as np
    levels = 2 ** (trainer.pcfg.quantize_bits - 1) - 1
    out = {}
    for part in ("gen", "disc"):
        worst = raw = 0.0
        for (name, x), d in zip(_named_leaves(trainer.state[part]),
                                trainer._tp_dims[part]):
            full = torch.from_numpy(np.load(os.path.join(
                reference, f"{part}{name.replace('/', '.')}.npy"))).to(device)
            want = (full if d is None else
                    full.narrow(d, r * x.shape[d], x.shape[d]))
            diff = float((x - want).abs().max())
            step = float(full.abs().max()) / levels if part == "disc" else 0.0
            worst, raw = max(worst, diff - step), max(raw, diff)
            del full, want
        out[part] = (worst, raw)
    return out


def _save_leaves(state, directory):
    """Every leaf of state["gen"] and state["disc"] as one .npy file."""
    import numpy as np
    for part in ("gen", "disc"):
        for name, x in _named_leaves(state[part]):
            np.save(os.path.join(directory,
                                 f"{part}{name.replace('/', '.')}.npy"),
                    x.detach().cpu().numpy())


def tp_granite_rank(shards, reference, serve_dir, work, rank, world_size,
                    device):
    """10b, then 10c, on one rank. 10b: TP_GRANITE's rounds through
    `Trainer(layout="mesh", tp=TP)`, the wavg and flash_attn counts set
    to 0 just before the path; the MLP leaves' shard shapes, each
    round's record, seconds and launches, the peak device memory, and
    the shards against tp=1's (`_tp_param_diffs`). 10c, on worker 0's
    model group once its trainer is freed: `tp_serve`; worker 1's ranks
    are done."""
    torch = _rank_torch()
    import torch.distributed as dist
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.kernels.wavg import ops as wavg_ops
    from repro_torch.launch import mesh
    k = dist.get_rank(mesh.axis_group("data"))
    r = dist.get_rank(mesh.axis_group("model"))
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    trainer = _tp_granite_trainer(shards, device, TP)
    ff = trainer.state["disc"]["backbone"]["groups"]["sub0"]["ff"]
    out = dict(shapes={n: tuple(v.shape) for n, v in ff.items()},
               init_s=time.perf_counter() - t0)
    flash_ops.launches = wavg_ops.launches = 0     # the path starts here
    rounds = []
    for _ in range(TP_GRANITE["rounds"]):
        before = (wavg_ops.launches, flash_ops.launches)
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        rec = trainer.run(1)[-1]
        torch.cuda.synchronize()
        rounds.append(dict(mask=rec.mask, weights=rec.weights,
                           wall=rec.wallclock_s, metrics=rec.metrics,
                           secs=time.perf_counter() - t0,
                           launches=(wavg_ops.launches - before[0],
                                     flash_ops.launches - before[1])))
    out["counts"] = (wavg_ops.launches, flash_ops.launches)  # ... ends here
    out["rounds"] = rounds
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    t0 = time.perf_counter()
    out["diffs"] = _tp_param_diffs(torch, trainer, reference, r, device)
    out["compare_s"] = time.perf_counter() - t0
    del trainer, rec
    torch.cuda.empty_cache()
    if k == 0:
        out["serve"] = tp_serve(torch, serve_dir, work, device)
    return out


def time_wavg_tp(torch, wavg_ops, n_full, n_local):
    """wavg at K=2 on the worker's whole payload and on its 1/TP shard:
    kernel, plain and w @ x ms beside the HBM bound."""
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, n in (("tp1", n_full), ("tp2", n_local)):
        xs = [(torch.randn((2, n), generator=gen, device="cuda"),
               torch.full((2,), 0.5, device="cuda")) for _ in range(2)]
        got = wavg_ops.weighted_average(*xs[0])
        torch.testing.assert_close(got, wavg_ops.wavg_ref(*xs[0]),
                                   rtol=RTOL, atol=ATOL)
        n_bytes = (2 * n + 2 + n) * 4
        out[label] = dict(
            k=2, n=n, ms=time_ms(wavg_ops.weighted_average, xs),
            plain_ms=time_ms(wavg_ops.wavg_ref, xs),
            library_ms=time_ms(lambda x, w: torch.matmul(w, x), xs),
            bound_ms=max(n_bytes / HBM_BYTES_PER_S,
                         4 * n / F32_FLOPS_PER_S) * 1e3)
        del xs, got
    return out


def _named_leaves(tree, prefix=""):
    """(path, leaf) pairs of a tree in leaf order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _named_leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def tp_serve(torch, directory, work, device):
    """10c on one rank of worker 0's model group: the generator of the
    global checkpoint in `directory` loaded as `launch.serve` loads it,
    cut to this rank's shards by `ServingEngine(tp=TP)`, serving `work`
    through the paged and the dense engine (uncaptured: gloo), every
    launch count at 0. Returns each engine's tokens (what `run` hands
    out, and the rank's own), decode-only and prefill ms a step, wall
    seconds; the load seconds and the peak device memory."""
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.kernels.wavg import ops as wavg_ops
    from repro_torch.launch.serve import load_generator_params
    from repro_torch.serving import Request, ServingEngine
    setting = SERVE_GRANITE
    cfg = backbone_config(setting)
    t0 = time.perf_counter()
    params, _ = load_generator_params(directory)
    out = dict(load_s=time.perf_counter() - t0, engines={})
    torch.cuda.reset_peak_memory_stats()
    for label, block in (("paged", setting["block"]), ("dense", None)):
        eng = ServingEngine(cfg, params, batch_size=setting["batch"],
                            max_len=setting["max_len"], block_size=block,
                            prefill_chunk=setting["chunk"], seed=0, tp=TP,
                            device=device)
        steps, get = [], eng._get_step
        eng._get_step = lambda chunk: (steps.append([chunk]), get(chunk))[1]
        for i, (p, n) in enumerate(work):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=n))
        flash_ops.launches = wavg_ops.launches = 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        while eng.queue or any(s is not None for s in eng.slots):
            t2 = time.perf_counter()
            if not eng.step():
                raise AssertionError("the engine stalled")
            steps[-1].append(time.perf_counter() - t2)
        wall = time.perf_counter() - t1
        if flash_ops.launches or wavg_ops.launches:
            raise AssertionError("hand-written kernels inside the engine")
        handed = eng.run()
        prefill = [secs * 1e3 for chunk, secs in steps if chunk is not None]
        out["engines"][label] = dict(
            handed={q.rid: list(q.out_tokens) for q in handed},
            own={q.rid: list(q.out_tokens) for q in eng.finished},
            decode_ms=decode_only_ms(steps),
            prefill_ms=(statistics.mean(prefill), len(prefill)),
            first_step_s=steps[0][1], wall=wall,
            w_out=tuple(eng.params["backbone"]["groups"]["sub0"]["ff"]
                        ["w_out"].shape))
        del eng
        torch.cuda.empty_cache()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def tp_granite_phase(torch, wavg_ops, flash_ops, shards, serving_inputs):
    """10b and 10c in one spawn of 4 gloo ranks (K=2 x TP=2). First, in
    this process: the stacked tp=1 run of 10b (same seed; phase 5's
    first two granite token shards), its parameters saved a leaf a file
    and freed; 9a's generator (seed 0) written as a global-shaped
    checkpoint. 10b: the ranks' masks, weights and wallclock bit for bit
    tp=1's, objectives within TP_METRIC_RTOL, every rank's shards within
    TP_PARAM_ATOL of tp=1's (plus one quantization step on the
    discriminator); half-width MLP leaves; per rank and round 1 wavg and
    TP_GRANITE["per_round"] flash_attn launches; per-rank peak memory
    and seconds a round; wavg timed at the 1/TP payload. 10c: worker 0's
    model group serves 9a's greedy requests, paged and dense, from the
    checkpoint: each request's tokens 9a's (tp=1) up to 9a's first near
    tie, on both ranks, and only rank 0 hands them out; the uncaptured
    decode step beside 9a's."""
    import tempfile
    import numpy as np
    from repro_torch import checkpoint
    from repro_torch.core import protocol
    from repro_torch.launch import mesh
    from repro_torch.models import gan
    from repro_torch.sharding import rules
    bb = TP_GRANITE
    cfg = backbone_config(bb)
    greedy_work, greedy_tokens, greedy_ties, tp1_decode_ms = serving_inputs
    ref = _tp_granite_trainer(shards, "cuda", 1)
    sizes = (protocol.count_params(ref.state["gen"]),
             protocol.count_params(ref.state["disc"]))
    if sizes != bb["sizes"]:
        raise AssertionError(f"10b sizes {sizes}")
    n_local = rules.tp_local_size(ref.state["disc"], TP)
    flash_before = flash_ops.launches
    torch.cuda.reset_peak_memory_stats()
    want = []
    for _ in range(bb["rounds"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = ref.run(1)[-1]
        torch.cuda.synchronize()
        want.append((rec, time.perf_counter() - t0))
    ref_flash = flash_ops.launches - flash_before
    flash_ops.launches = flash_before        # the reference is no path
    ref_peak = torch.cuda.max_memory_allocated() / 2**30
    base = os.path.join(ROOT, "results", "torch")
    os.makedirs(base, exist_ok=True)
    reference = tempfile.mkdtemp(prefix="chip_smoke_tp_ref_", dir=base)
    serve_dir = tempfile.mkdtemp(prefix="chip_smoke_tp_serve_", dir=base)
    try:
        _save_leaves(ref.state, reference)
        del ref, rec
        torch.cuda.empty_cache()
        serve_cfg = backbone_config(SERVE_GRANITE)
        params = gan.generator_init(torch.Generator("cuda").manual_seed(0),
                                    serve_cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = checkpoint.save_checkpoint(serve_dir, 0,
                                          {"state": {"gen": params}})
        write_s = time.perf_counter() - t0
        ckpt_bytes = os.path.getsize(path)
        del params
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        per_rank = mesh.spawn(
            functools.partial(tp_granite_rank, shards, reference, serve_dir,
                              greedy_work),
            bb["k"] * TP, backend="gloo", timeout_s=900, tp=TP)
        secs = time.perf_counter() - t0
    finally:
        shutil.rmtree(reference, ignore_errors=True)
        shutil.rmtree(serve_dir, ignore_errors=True)

    # 10b
    half = {"w_in": (bb["layers"], cfg.d_model, cfg.d_ff // TP),
            "w_gate": (bb["layers"], cfg.d_model, cfg.d_ff // TP),
            "w_out": (bb["layers"], cfg.d_ff // TP, cfg.d_model)}
    diffs = {"gen": 0.0, "disc": 0.0}
    for g, out in enumerate(per_rank):
        if out["shapes"] != half:
            raise AssertionError(f"10b rank {g} MLP shards {out['shapes']}")
        for t, ((rec, _), got) in enumerate(zip(want, out["rounds"])):
            if not (np.array_equal(got["mask"], rec.mask)
                    and np.array_equal(got["weights"], rec.weights)
                    and got["wall"] == rec.wallclock_s):
                raise AssertionError(f"10b round {t} rank {g}: mask, "
                                     f"weights or wallclock differ")
            for key, value in rec.metrics.items():
                if abs(got["metrics"][key] - value) > TP_METRIC_RTOL * max(
                        1.0, abs(value)):
                    raise AssertionError(f"10b round {t} rank {g} {key} "
                                         f"{got['metrics'][key]} vs {value}")
            if got["launches"] != (1, bb["per_round"]):
                raise AssertionError(f"10b round {t} rank {g}: (wavg, "
                                     f"flash_attn) {got['launches']}")
        for part, (worst, raw) in out["diffs"].items():
            diffs[part] = max(diffs[part], raw)
            if worst > TP_PARAM_ATOL:
                raise AssertionError(f"10b rank {g} {part}: {raw} from "
                                     f"tp=1")
    counts = [out["counts"] for out in per_rank]
    launches = {"wavg": sum(c[0] for c in counts),
                "flash_attn": sum(c[1] for c in counts)}
    n_rounds = bb["rounds"] * len(per_rank)
    if launches != {"wavg": n_rounds,
                    "flash_attn": n_rounds * bb["per_round"]}:
        raise AssertionError(f"10b launches {launches}")
    wavg_tp = time_wavg_tp(torch, wavg_ops, sizes[1], n_local)
    round_s = [max(out["rounds"][t]["secs"] for out in per_rank)
               for t in range(bb["rounds"])]
    granite = dict(
        layers=bb["layers"], ranks=len(per_rank), sizes=sizes,
        disc_payload_per_rank=n_local,
        peak_gib_per_rank=[out["peak_gib"] for out in per_rank],
        tp1_peak_gib=ref_peak, round_s=round_s,
        tp1_round_s=[s for _, s in want], tp1_flash_attn=ref_flash,
        max_abs_diff=diffs, launches=launches,
        init_s=[out["init_s"] for out in per_rank],
        compare_s=[out["compare_s"] for out in per_rank],
        objectives=[got["metrics"] for got in per_rank[0]["rounds"]],
        tp1_objectives=[rec.metrics for rec, _ in want],
        wavg_at_1_over_tp=wavg_tp)
    print(f"10b granite-3-2b ({bb['layers']} of 40 layers, full width, "
          f"K={bb['k']} x tp={TP} = {len(per_rank)} ranks, seq_len "
          f"{bb['seq']}, SGD): masks, weights and wallclock bitwise the "
          f"stacked tp=1 run's; objectives {granite['objectives']} vs "
          f"{granite['tp1_objectives']}; max |param - tp=1| gen "
          f"{diffs['gen']:.3e} disc {diffs['disc']:.3e}; MLP leaves "
          f"half-width on every rank; per rank and round 1 wavg and "
          f"{bb['per_round']} flash_attn launches; s/round (slowest rank) "
          f"{[round(x, 3) for x in round_s]} vs tp=1 "
          f"{[round(x, 3) for x in granite['tp1_round_s']]}; peak GiB a "
          f"rank {[round(x, 2) for x in granite['peak_gib_per_rank']]} "
          f"(tp=1 K=2 stacked {ref_peak:.2f}); Algorithm-2 payload a rank "
          f"{n_local:,} of {sizes[1]:,}; wavg K=2 at the 1/tp payload "
          f"{wavg_tp['tp2']['ms']:.4f} ms (bound "
          f"{wavg_tp['tp2']['bound_ms']:.4f}), whole "
          f"{wavg_tp['tp1']['ms']:.4f} ms (bound "
          f"{wavg_tp['tp1']['bound_ms']:.4f}); rank set-up "
          f"{max(granite['init_s']):.2f} s, comparison "
          f"{max(granite['compare_s']):.2f} s")

    # 10c
    served = [out["serve"] for out in per_rank if "serve" in out]
    want_toks = dict(enumerate(greedy_tokens))
    half = (serve_cfg.n_layers, serve_cfg.d_ff // TP, serve_cfg.d_model)
    agree = {}
    for label in ("paged", "dense"):
        runs = [out["engines"][label] for out in served]
        if (len(runs) != TP or any(run["handed"] for run in runs[1:])
                or runs[0]["handed"] != runs[0]["own"]):
            raise AssertionError(f"10c {label}: rank 0 must hand out the "
                                 f"requests, the others none")
        for r, run in enumerate(runs):
            if run["w_out"] != half:
                raise AssertionError(f"10c rank {r} w_out {run['w_out']}")
            for rid, toks in want_toks.items():
                tie = greedy_ties[rid]
                got = run["own"][rid]
                upto = len(toks) if tie is None else tie
                if got[:upto] != toks[:upto] or len(got) != len(toks):
                    raise AssertionError(
                        f"10c {label} rank {r} rid {rid}: {got} vs 9a's "
                        f"{toks} (first near tie {tie})")
                agree[f"{label}/{rid}"] = (
                    sum(a == b for a, b in zip(got, toks)), len(toks))
    serving = dict(
        checkpoint_bytes=ckpt_bytes, checkpoint_write_s=write_s,
        load_s=[out["load_s"] for out in served],
        peak_gib_per_rank=[out["peak_gib"] for out in served],
        decode_step_ms={label: max(out["engines"][label]["decode_ms"][0]
                                   for out in served)
                        for label in ("paged", "dense")},
        prefill_step_ms={label: max(out["engines"][label]["prefill_ms"][0]
                                    for out in served)
                         for label in ("paged", "dense")},
        first_step_s={label: max(out["engines"][label]["first_step_s"]
                                 for out in served)
                      for label in ("paged", "dense")},
        tp1_decode_step_ms=tp1_decode_ms,
        wall_s={label: served[0]["engines"][label]["wall"]
                for label in ("paged", "dense")},
        tokens_equal=agree, first_near_tie=dict(enumerate(greedy_ties)))
    print(f"10c granite-3-2b serving at tp={TP} ({serve_cfg.n_layers} "
          f"layers, worker 0's 2 gloo ranks, w_out {half} a rank): "
          f"{len(want_toks)} greedy requests, paged and dense, tokens as "
          f"9a's tp=1 up to 9a's first near tie "
          f"{serving['first_near_tie']} (equal tokens of all: "
          f"{agree}); only rank 0 hands them out; 0 kernel launches in "
          f"the engines; uncaptured (gloo) decode-only step "
          f"{serving['decode_step_ms']} ms and prefill step "
          f"{serving['prefill_step_ms']} ms, first step "
          f"{serving['first_step_s']} s, vs 9a's tp=1 decode-only step "
          f"{tp1_decode_ms} ms; global checkpoint "
          f"{ckpt_bytes / 1e9:.2f} GB written in {write_s:.2f} s, loaded "
          f"in {[round(x, 2) for x in serving['load_s']]} s a rank; peak "
          f"GiB a rank {[round(x, 2) for x in serving['peak_gib_per_rank']]}"
          f"; the spawn (10b and 10c) {secs:.2f} s with process start-up")
    return granite, serving


def check_flash_repeat_kv(torch, flash_ops, flash_ref):
    """The k/v-repeating flash layout on the card: the kernel with KV = H
    at granite-3-2b's D 64 (32 heads) and minitron-4b's D 128 (24 heads),
    against its plain version; and `attention_apply(flash_repeat_kv=
    True)` against the unrepeated layout at granite's width. These
    launches compare and are no path's."""
    from repro_torch.nn import attention
    before = flash_ops.launches
    gen = torch.Generator(device="cuda").manual_seed(3)
    errs = {}
    for h, kv, d in ((32, 8, 64), (24, 8, 128)):
        q = torch.randn((1, 1024, h, d), generator=gen, device="cuda")
        k = torch.randn((1, 1024, kv, d), generator=gen, device="cuda")
        v = torch.randn((1, 1024, kv, d), generator=gen, device="cuda")
        kr, vr = (t.repeat_interleave(h // kv, dim=2) for t in (k, v))
        got = flash_ops.flash_attention(q, kr, vr)
        want = flash_ref.flash_attention_plain(q, kr, vr)[0]
        torch.testing.assert_close(got, want, rtol=0, atol=FLASH_ATOL)
        grouped = flash_ops.flash_attention(q, k, v)
        errs[f"D{d}"] = (float((got - want).abs().max()),
                         float((got - grouped).abs().max()))
    cfg = backbone_config(dict(arch="granite-3-2b", layers=1))
    params = attention.attention_init(torch.Generator("cuda").manual_seed(4),
                                      cfg.d_model, cfg.n_heads,
                                      cfg.n_kv_heads, cfg.resolved_head_dim)
    x = torch.randn((2, 1024, cfg.d_model), generator=gen, device="cuda")
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads)
    with torch.no_grad():
        rep = attention.attention_apply(params, x, flash_repeat_kv=True,
                                        **kw)
        base = attention.attention_apply(params, x, **kw)
    torch.testing.assert_close(rep, base, rtol=1e-5, atol=1e-5)
    errs["granite_attention"] = float((rep - base).abs().max())
    flash_ops.launches = before
    print(f"flash_attn with k/v repeated to KV = H (flash_repeat_kv): D 64 "
          f"(H 32) and D 128 (H 24) against the plain version and the "
          f"grouped layout, and granite-3-2b's attention against the "
          f"unrepeated layout: max abs err {errs}")
    return errs


def tp_phase(torch, card, wavg_ops, flash_ops, flash_ref, granite_shards,
             serving_inputs):
    """Phase 10 on `card`: 10a; 10b and 10c (one spawn) on
    `granite_shards` (K=2 token shards of 1,024 tokens) and 9a's
    `serving_inputs`. Returns the "tp" path's launches by kernel (10a's
    and 10b's, summed over the ranks; 10c's engines launch none)."""
    torch.cuda.empty_cache()
    print(f"phase 10 starts with {torch.cuda.memory_allocated() / 2**30:.2f}"
          f" GiB allocated in this process")
    out = {"flash_repeat_kv_max_abs_err": check_flash_repeat_kv(
        torch, flash_ops, flash_ref)}
    out["mlp_gan"] = tp_mlp_phase(torch)
    stamp("tp: MLP-GAN")
    out["granite"], out["serving"] = tp_granite_phase(
        torch, wavg_ops, flash_ops, granite_shards, serving_inputs)
    torch.cuda.empty_cache()
    stamp("tp: granite-3-2b and serving")
    print(f"tensor-parallel phase on {card}")
    print(json.dumps({"tp": out}, default=str))
    return {"wavg": out["mlp_gan"]["wavg"]
            + out["granite"]["launches"]["wavg"],
            "flash_attn": out["granite"]["launches"]["flash_attn"]}


def tp1_serving_reference(torch, kernel_mods):
    """`--tp-only`'s stand-in for phase 9a's outputs: 9a's greedy
    requests through the captured paged engine at tp=1, each held to the
    full forward up to its first near tie; (work, tokens, ties, the
    engine's decode-only ms)."""
    from repro_torch.models import gan
    setting = SERVE_GRANITE
    cfg = backbone_config(setting)
    params = gan.generator_init(torch.Generator("cuda").manual_seed(0), cfg)
    work = serving_traffic(cfg.vocab, setting)
    greedy = [rid for rid, (_, _, t) in enumerate(work) if t == 0.0][:4]
    work = [work[rid] for rid in greedy]
    eng = serving_engine(torch, cfg, params, setting, paged=True)
    toks, _, steps, _ = serve_traffic(torch, eng, work, kernel_mods)
    del eng
    ties = []
    for rid, (prompt, _, _) in enumerate(work):
        ref = teacher_forced(torch, gan, params, cfg, prompt, toks[rid])
        ties.append(held_until_tie(toks[rid], ref.argmax(-1).tolist(), ref,
                                   f"granite rid {rid}"))
    del params
    torch.cuda.empty_cache()
    return ([(p, n) for p, n, _ in work], [toks[i] for i in range(len(work))],
            ties, {"replayed": decode_only_ms(steps)[0]})


# ---------------------------------------------------------------------------
# --allocator-ab: host-driver rounds under the allocator's two segment kinds
# ---------------------------------------------------------------------------

ALLOC_CONFS = ("", "expandable_segments:True", "expandable_segments:True",
               "")


# ---------------------------------------------------------------------------
# Phase 11: the zoo: the MoE and hybrid families
# ---------------------------------------------------------------------------

# 11a granite-moe-3b-a800m (hf:ibm-granite/granite-3.0-3b-a800m-base) at
# full width (d_model 1,536, 24 heads of 64 over 8, 40 experts top-8 of
# 512, groups of 1,024 tokens), 32 layers cut to 2 so that K = 4
# discriminators with Adam fit the card beside G (K D + G = 1.47 G
# parameters); m = 4 sequences of 1,024 tokens of granite-3-2b's token
# data (the same vocabulary, 49,155).
ZOO_MOE = dict(arch="granite-moe-3b-a800m", k=4, n_d=2, n_g=2, m=4,
               seq=1024, layers=2, sizes=(355_017_216, 279_320_064),
               per_round=44)
# 11b zamba2-2.7b (arXiv:2411.15242) at full width (d_model 2,560, 32
# heads of 80, d_ff 10,240, Mamba-2 with 64 states and heads of 64): 9
# groups cut to 2 (12 Mamba-2 layers, the shared block called twice), K =
# 2, m = 4 sequences of 1,024 tokens, n_d = n_g = 1 (K D + G = 2.10 G
# parameters); a round runs 7 backbone passes: 84 scans, 14 attentions.
ZOO_HYBRID = dict(arch="zamba2-2.7b", k=2, n_d=1, n_g=1, m=4, seq=1024,
                  layers=12, sizes=(754_245_440, 672_000_320),
                  per_round=84, attn_per_round=14)
# 11c mixtral-8x22b (arXiv:2401.04088) at full width (d_model 6,144, 48
# heads of 128 over 8, 8 experts top-2 of 16,384, a window of 4,096
# keys): one layer in G and in D, forward and backward only (a K=2 round
# with float32 Adam needs (2 D + G) x 16 B = 135 GB before activations);
# D's logits against the CPU at 520 tokens, then 8,192 tokens.
ZOO_MIXTRAL = dict(arch="mixtral-8x22b", layers=1, disc_layers=1, b=1,
                   seq=8192, check_seq=520,
                   sizes=(2_945_255_424, 2_743_148_544))
# 11d the generators of granite-moe-3b-a800m (at full width, 8 of its 32
# layers, to make room for phase 12) and zamba2-2.7b (at full
# width and depth, 54 layers, which the serve CLI builds) behind the
# engine at batch 4, max_len 64,
# 16-token blocks, 32-token prefill chunks: the serve CLI's 4 demo
# prompts (4-16 tokens, seed 0), 20 greedy tokens each, so that every
# request crosses a block boundary; one mode="prefill" call against the
# chunked prefill: zamba2's of 520 tokens (past the flash threshold),
# granite-moe's of 512, the most that routes dropless exactly at top-8
# (4,096 pairs; past it the capacity dispatch with factor 2 drops pairs
# where the router crowds an expert, as in the JAX package, which the
# 32-token chunks never do).
SERVE_ZOO = dict(batch=4, max_len=64, block=16, chunk=32, demo=4, new=20,
                 prefill={"granite-moe-3b-a800m": 512, "zamba2-2.7b": 520},
                 layers={"granite-moe-3b-a800m": 8, "zamba2-2.7b": 54},
                 sizes={"granite-moe-3b-a800m": 959_384_064,
                        "zamba2-2.7b": 2_429_551_520})
ZOO_RANGES = ("moe.dispatch", "moe.experts", "moe.combine",
              "moe.gather.backward", "FlashAttention.backward",
              "SSDScan.backward")


def zoo_trainer(bb, cfg, shards, driver):
    """A Trainer of a phase 11 or 12 backbone-GAN: Adam at 1e-3, 16-bit
    uplink, every device scheduled, fading off (the drivers then draw the
    same masks), each pass whole (remat off); a conditioned family takes
    the stub frontend's features (`make_stub_enc_feats`, on the card)."""
    from repro_torch.configs import ProtocolConfig
    from repro_torch.core import Trainer
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.models import gan
    from repro_torch.models.specs import (make_backbone_spec,
                                          make_stub_enc_feats)
    pcfg = ProtocolConfig(n_devices=bb["k"], n_d=bb["n_d"], n_g=bb["n_g"],
                          sample_size=bb["m"], server_sample_size=bb["m"],
                          lr_d=1e-3, lr_g=1e-3, optimizer="adam",
                          schedule="serial", scheduler="all")
    return Trainer(make_backbone_spec(
        cfg, bb["seq"], remat=False, gen_loss_variant="nonsaturating",
        enc_feats_fn=make_stub_enc_feats(cfg, device="cuda")),
                   pcfg, lambda g: gan.gan_init(g, cfg), shards, seed=0,
                   driver=driver,
                   channel_cfg=ChannelConfig(n_devices=bb["k"],
                                             fading=False))


def zoo_train(torch, bb, shards, kernel_mods, want, n_rounds=2, phase="11",
              ranges=ZOO_RANGES):
    """11a / 11b / 12a: `n_rounds` rounds of the host driver (the path:
    every launch count at 0 just before, read just after), one more host
    round profiled (`ranges`), then `n_rounds` rounds of the fused driver
    (all but the first replays) bitwise equal to the host's
    (`compare_drivers`, under cuDNN's deterministic algorithms), and one
    replay profiled: `want` launches by kernel a round. Returns the
    path's launches and the summary."""
    from repro_torch.core.protocol import count_params
    cfg = backbone_config(bb)

    def make(driver):
        trainer = zoo_trainer(bb, cfg, shards, driver)
        sizes = tuple(count_params(trainer.state[p]) for p in ("gen", "disc"))
        if sizes != bb["sizes"]:
            raise AssertionError(f"{cfg.name} sizes {sizes}")
        return trainer

    def profiled(trainer):
        return profile_round(torch, trainer, f"{cfg.name} host",
                             ranges=ranges, kernels=(
                                 r"flash_attn_kernel", r"ssd_\w+_kernel",
                                 r"gemm|Gemm|sm90_xmma|cutlass"))

    torch.backends.cudnn.deterministic = True
    try:
        out = compare_drivers(torch, cfg.name, make, n_rounds, want=want,
                              peak=True, kernel_mods=kernel_mods,
                              after_host=profiled)
    finally:
        torch.backends.cudnn.deterministic = False
    launches = {k: v for k, v in out["host_launches"].items() if v}
    expect = {"wavg": n_rounds,
              **{("ssd_scan" if k.startswith("ssd_") else k): n_rounds * n
                 for k, n in want.items() if k != "wavg"}}
    if launches != expect:
        raise AssertionError(f"{cfg.name}: host rounds launched {launches}, "
                             f"expected {expect}")
    prof = out["after_host"]
    if prof is not None:
        split = {**prof["ranges_s"], **prof["kernels_s"]}
        print(f"{phase} {cfg.name}: one profiled host round "
              f"{prof['wall_s']:.3f} s wall, {prof['busy_s']:.3f} s device "
              f"busy; device s by part: "
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    print(f"{phase} {cfg.name} ({cfg.n_layers} layers, K={bb['k']}, seq_len "
          f"{bb['seq']}): host {[round(x, 4) for x in out['host_s']]} s a "
          f"round, fused {[round(x, 4) for x in out['fused_s']]}; peak host "
          f"{out['host_peak_gib']:.2f} GiB, fused {out['fused_peak_gib']:.2f} "
          f"GiB; launches in the host rounds {launches}")
    return launches, out


def check_mixtral(torch, flash_ops):
    """11c, mixtral-8x22b at full width, one layer in G and D: at
    ZOO_MIXTRAL's 8,192 tokens D on real tokens, G, D on G's output, the
    backward of D's objective into D and G (the path: 3 flash_attn
    launches, each with the window of 4,096 keys), finite gradients, the
    peak device memory; then D's logits at 520 tokens on the card against
    the port on the CPU from the same parameters (rtol 1e-4). Returns the
    path's launches and the summary."""
    import numpy as np
    from repro_torch.core import protocol
    from repro_torch.models import gan
    from repro_torch.models.specs import make_backbone_spec
    from repro_torch.tree import tree_leaves, tree_map
    bb = ZOO_MIXTRAL
    cfg = backbone_config(bb)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = gan.gan_init(torch.Generator("cuda").manual_seed(0), cfg)
    sizes = tuple(protocol.count_params(params[p]) for p in ("gen", "disc"))
    if sizes != bb["sizes"]:
        raise AssertionError(f"{cfg.name} sizes {sizes}")
    for x in tree_leaves(params):
        x.requires_grad_(True)
    spec = make_backbone_spec(cfg, bb["seq"], remat=False,
                              gen_loss_variant="nonsaturating")
    tokens = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab, (bb["b"], bb["seq"])), device="cuda")
    z = spec.sample_z(torch.Generator("cuda").manual_seed(1), bb["b"])
    windows = []
    wrapper = flash_ops.flash_attention

    def recording(q, k, v, *, causal=True, window=None):
        windows.append(window)
        return wrapper(q, k, v, causal=causal, window=window)

    flash_ops.flash_attention = recording
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flash_ops.launches = 0                     # the path starts here
        real = spec.disc_real(params["disc"], tokens)
        fake = spec.disc_fake(params["disc"],
                              spec.gen_apply(params["gen"], z))
        objective = (torch.nn.functional.softplus(-real).mean()
                     + torch.nn.functional.softplus(fake).mean())
        torch.cuda.synchronize()
        forward_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        objective.backward()
        torch.cuda.synchronize()
        backward_s = time.perf_counter() - t0
        launches = flash_ops.launches              # ... and ends here
    finally:
        flash_ops.flash_attention = wrapper
    if launches != 3 or windows != [MIXTRAL_WINDOW] * 3:
        raise AssertionError(f"{cfg.name}: {launches} flash_attn launches, "
                             f"windows {windows}")
    unused = {id(x) for x in tree_leaves({k: params["gen"][k]
                                          for k in ("embed", "lm_head")})}
    grads = [x.grad for x in tree_leaves(params) if id(x) not in unused]
    if any(g is None or not bool(torch.isfinite(g).all()) for g in grads):
        raise AssertionError(f"{cfg.name}: a missing or non-finite "
                             f"gradient")
    if not bool(torch.isfinite(objective)):
        raise AssertionError(f"{cfg.name}: objective {objective}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    del real, fake, objective, grads
    for x in tree_leaves(params):
        x.grad = None
        x.requires_grad_(False)
    print(f"11c {cfg.name} (one layer in G and D, d_model {cfg.d_model}, "
          f"{bb['b']} x {bb['seq']} tokens, window {cfg.window}): "
          f"{sizes[0]} G / {sizes[1]} D parameters; forward (D real, G, D "
          f"fake) {forward_s:.3f} s, backward into D and G "
          f"{backward_s:.3f} s; {launches} flash_attn launches, each "
          f"windowed; every gradient finite; peak device memory "
          f"{peak:.2f} GiB")

    check = make_backbone_spec(cfg, bb["check_seq"], remat=False,
                               gen_loss_variant="nonsaturating")
    short = tokens[:, :bb["check_seq"]]
    with torch.no_grad():
        card = check.disc_real(params["disc"], short).cpu()
    disc_cpu = tree_map(lambda x: x.detach().cpu(), params["disc"])
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with torch.no_grad():
        host = check.disc_real(disc_cpu, short.cpu())
    cpu_s = time.perf_counter() - t0
    torch.testing.assert_close(card, host, rtol=1e-4, atol=0)
    print(f"11c {cfg.name} D logits on {bb['check_seq']} real tokens, card "
          f"{card.tolist()} against the CPU {host.tolist()} (rtol 1e-4; the "
          f"CPU forward {cpu_s:.2f} s on {torch.get_num_threads()} "
          f"threads)")
    del disc_cpu
    return {"flash_attn": launches}, dict(
        forward_s=forward_s, backward_s=backward_s, peak_gib=peak,
        cpu_s=cpu_s, logits_card=card.tolist(), logits_cpu=host.tolist())


def demo_work(vocab, setting):
    """The serve CLI's demo requests (`launch/serve.py`, seed 0): prompts
    of 4-16 tokens, `setting["new"]` greedy tokens each."""
    import numpy as np
    rng = np.random.default_rng(0)
    return [(rng.integers(1, vocab, rng.integers(4, 17)).astype(np.int32),
             setting["new"], 0.0) for _ in range(setting["demo"])]


def serve_zoo_model(torch, name, kernels, kernel_mods, out):
    """11d for one architecture at full width and depth: the demo requests
    through the paged engine (captured), the dense one and the paged one
    uncaptured (tokens, and the captured and uncaptured cache leaves,
    bit for bit; no kernel launch in the engines); the greedy tokens held
    to the dropless full forward up to the first near tie; one
    mode="prefill" call of 520 tokens against the chunked prefill
    (`kernels` launched, one a layer of each kind, flash_attn past its
    threshold). Returns its launches."""
    import numpy as np
    from repro_torch.core.protocol import count_params
    from repro_torch.models import gan
    from repro_torch.tree import tree_leaves
    setting = SERVE_ZOO
    cfg = backbone_config(dict(arch=name, layers=setting["layers"][name]))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = gan.generator_init(torch.Generator("cuda").manual_seed(0), cfg)
    size = count_params(params)
    if size != setting["sizes"][name]:
        raise AssertionError(f"{name} generator {size}")
    work = demo_work(cfg.vocab, setting)
    runs = {}
    for label, paged, capture in (("paged", True, True),
                                  ("dense", False, True),
                                  ("paged uncaptured", True, False)):
        eng = serving_engine(torch, cfg, params, setting, paged=paged,
                             capture=capture)
        toks, wall, steps, _ = serve_traffic(torch, eng, work, kernel_mods)
        runs[label] = dict(tokens=toks, wall=wall, steps=steps, engine=eng,
                           steps_n=eng.dispatch_count,
                           captures=eng.compile_count)
        if label == "dense":
            del eng, runs[label]["engine"]
    paged, dense, eager = (runs[k] for k in ("paged", "dense",
                                             "paged uncaptured"))
    if not paged["tokens"] == dense["tokens"] == eager["tokens"]:
        raise AssertionError(f"{name}: paged, dense and uncaptured tokens "
                             f"differ")
    for a, b in zip(tree_leaves(paged["engine"].caches),
                    tree_leaves(eager["engine"].caches)):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: captured and uncaptured cache "
                                 f"leaves differ")
    del paged["engine"], eager["engine"]
    torch.cuda.empty_cache()
    ties = {}
    for rid, (prompt, _, _) in enumerate(work):
        toks = paged["tokens"][rid]
        ref = teacher_forced(torch, gan, params, cfg, prompt, toks,
                             mode="prefill")
        ties[rid] = held_until_tie(toks, ref.argmax(-1).tolist(), ref,
                                   f"{name} rid {rid}")
    prompt = np.random.default_rng(8).integers(0, cfg.vocab,
                                               setting["prefill"][name])
    launched, errs = prefill_against_chunked(torch, gan, cfg, params, prompt,
                                             kernels, kernel_mods)
    n_attn = sum(1 for k in cfg.group_pattern if k != "ssm")
    flash = len(prompt) ** 2 > 512 * 512
    want = {"flash_attn": cfg.n_groups_stack * n_attn * flash,
            "ssd_scan": cfg.n_layers if cfg.ssm is not None else 0}
    if launched != {k: want[k] for k in kernels}:
        raise AssertionError(f"{name} prefill: {launched}, expected {want}")
    dec_ms, n_dec = decode_only_ms(paged["steps"])
    eager_ms, _ = decode_only_ms(eager["steps"])
    n_tok = sum(len(t) for t in paged["tokens"].values())
    out[name] = dict(
        layers=cfg.n_layers, generator_params=size, tokens=n_tok,
        paged_wall_s=paged["wall"], dense_wall_s=dense["wall"],
        uncaptured_wall_s=eager["wall"], steps=paged["steps_n"],
        captures=paged["captures"],
        first_step_per_program_s={str(c): x for c, x in
                                  _first_steps(paged["steps"]).items()},
        decode_step_ms=dec_ms, decode_steps=n_dec,
        uncaptured_decode_step_ms=eager_ms, first_near_tie=ties,
        prefill_launches=launched, prefill_max_abs_err=errs,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    print(f"11d {name} ({cfg.n_layers} layers, {size:,} generator "
          f"parameters): {len(work)} requests, {n_tok} tokens, paged = "
          f"dense = uncaptured tokens and captured = uncaptured cache "
          f"leaves bit for bit; paged {paged['wall']:.3f} s, dense "
          f"{dense['wall']:.3f} s, uncaptured {eager['wall']:.3f} s; "
          f"{paged['steps_n']} steps, {paged['captures']} captures; "
          f"decode-only step replayed {dec_ms:.3f} ms (mean of {n_dec}), "
          f"uncaptured {eager_ms:.3f} ms; greedy against the dropless full "
          f"forward, first near tie by rid: {ties}; prefill of "
          f"{len(prompt)} tokens: {launched}, logits max abs err {errs}; "
          f"peak {out[name]['peak_gib']:.2f} GiB")
    del params
    torch.cuda.empty_cache()
    return launched, paged["tokens"]


def serve_zoo_cli(torch, tokens, kernel_mods, out):
    """11d, the serve CLI: `launch.serve.main --arch zamba2-2.7b` at
    SERVE_ZOO's settings on the card (its own random generator from seed
    0, the same as the engine's above): its tokens are the paged
    engine's `tokens`, bit for bit."""
    import io
    import re
    from repro_torch.launch import serve
    s = SERVE_ZOO
    argv = ["--arch", "zamba2-2.7b", "--demo", str(s["demo"]), "--max-new",
            str(s["new"]), "--batch", str(s["batch"]), "--max-len",
            str(s["max_len"]), "--block-size", str(s["block"]),
            "--prefill-chunk", str(s["chunk"]), "--device", "cuda"]
    buf = io.StringIO()
    zero_counts(kernel_mods)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        if serve.main(argv) != 0:
            raise AssertionError("serve.main --arch zamba2-2.7b failed")
    secs = time.perf_counter() - t0
    if any(kernel_counts(kernel_mods).values()):
        raise AssertionError(f"kernels inside the engine: "
                             f"{kernel_counts(kernel_mods)}")
    text = buf.getvalue()
    got = {int(m.group(1)): json.loads(m.group(2))
           for m in re.finditer(r"rid=(\d+): (\[.*\])", text)}
    if got != tokens:
        raise AssertionError(f"the serve CLI's zamba2 tokens {got} differ "
                             f"from the engine's {tokens}")
    out["zamba2-2.7b serve CLI"] = dict(seconds=secs)
    print(f"11d serve CLI --arch zamba2-2.7b on the card: {secs:.2f} s, the "
          f"engine's tokens bit for bit; its summary: "
          f"{text.strip().splitlines()[-1]}")
    torch.cuda.empty_cache()


def zoo_phase(torch, card, kernel_mods, moe_shards):
    """Phase 11 on `card`: 11a granite-moe-3b-a800m on `moe_shards` (K=4
    shards of granite-3-2b's token data), 11b zamba2-2.7b, 11c
    mixtral-8x22b, 11d serving. Returns the launches of each path by
    kernel: "moe", "hybrid", "mixtral", and "serving" (11d's
    mode="prefill" calls)."""
    t0 = time.perf_counter()
    gc.collect()         # what earlier phases left in reference cycles
    torch.cuda.empty_cache()
    out, launches = {}, {}
    launches["moe"], out["granite-moe-3b-a800m"] = zoo_train(
        torch, ZOO_MOE, moe_shards, kernel_mods,
        want={"wavg": 1, "flash_attn": ZOO_MOE["per_round"]})
    stamp("zoo: granite-moe-3b-a800m")
    bb = ZOO_HYBRID
    _, shards = token_shards(bb, backbone_config(bb))
    launches["hybrid"], out["zamba2-2.7b"] = zoo_train(
        torch, bb, shards, kernel_mods,
        want={"wavg": 1, "flash_attn": bb["attn_per_round"],
              **{name: bb["per_round"] for name in SSD_KERNELS}})
    del shards
    stamp("zoo: zamba2-2.7b")
    launches["mixtral"], out["mixtral-8x22b"] = check_mixtral(
        torch, kernel_mods["flash_attn"])
    stamp("zoo: mixtral-8x22b")
    serving = {}
    moe, _ = serve_zoo_model(torch, "granite-moe-3b-a800m", ("flash_attn",),
                             kernel_mods, out)   # 512 tokens: flash idle
    hybrid, tokens = serve_zoo_model(torch, "zamba2-2.7b",
                                     ("flash_attn", "ssd_scan"), kernel_mods,
                                     out)
    serve_zoo_cli(torch, tokens, kernel_mods, out)
    for part in (moe, hybrid):
        for k, n in part.items():
            serving[k] = serving.get(k, 0) + n
    launches["serving"] = serving
    stamp("zoo: serving")
    out["phase_s"] = time.perf_counter() - t0
    print(f"zoo phase on {card}: {out['phase_s']:.1f} s")
    print(json.dumps({"zoo": out}, default=float))
    return launches


# ---------------------------------------------------------------------------
# Phase 12: the conditioned families
# ---------------------------------------------------------------------------

# 12a whisper-base (arXiv:2212.04356) at full width and depth (6 decoder
# and 6 encoder layers, d_model 512, 8 heads of 64, vocabulary 51,865;
# the conv/mel frontend a stub of 1,500 frames): K = 4, m = 4 sequences
# of 448 tokens (Whisper's text context), n_d = n_g = 2, Adam, on
# granite-3-2b's token data cut to 448 tokens (its ids, < 49,155, are
# whisper tokens; whisper's own table would take 10.8 GB of host
# memory). A net's call launches 12 flash_attn: 6 encoder layers over
# 1,500 frames and 6 cross-attentions from 448 tokens to them (the
# decoder's 448 x 448 self-attention stays below the flash threshold).
COND_WHISPER = dict(arch="whisper-base", k=4, n_d=2, n_g=2, m=4, seq=448,
                    layers=6, sizes=(97_577_984, 70_958_080),
                    per_round=2 * (12 + 2 * 4 * 12) + 2 * 2 * 12)
# 12b llama-3.2-vision-90b (hf:meta-llama/Llama-3.2-90B-Vision) at full
# width (d_model 8,192, 64 heads of 128 over 8, d_ff 28,672), one group
# (4 self-attention layers and one gated cross-attention layer) of its
# 100 layers in G and in D, vocabulary 32,768: forward and backward of
# one net at a time at 1 x 2,048 tokens over 1,600 image tokens (a GAN
# round with float32 Adam needs (2 D + G) x 16 B = 226 GB); D's logits
# at 520 tokens against the CPU.
COND_VLM = dict(arch="llama-3.2-vision-90b", layers=5, disc_layers=None,
                vocab=32_768, b=1, seq=2048, check_seq=520,
                sizes=(4_883_308_546, 4_613_832_706))
# 12c the generators behind the engine: whisper-base at full depth, batch
# 8, max_len 448, 16-token blocks, 32-token prefill chunks, 16 seeded
# requests (prompts of 16-384 tokens, 32-64 new, every other one at
# temperature 0.8), a mode="prefill" call of 448 tokens; llama-3.2-
# vision-90b's group at its full vocabulary of 128,256 (6.45 G
# parameters, 25.8 GB), batch 4, the serve CLI's 4 demo prompts, 20
# greedy tokens each, a mode="prefill" call of 600 tokens.
SERVE_WHISPER = dict(arch="whisper-base", layers=6, batch=8, max_len=448,
                     block=16, chunk=32, requests=16, prompt=(16, 384),
                     new=(32, 64), prefill=448, gen_size=97_577_984,
                     prefill_flash=12)
SERVE_VLM = dict(arch="llama-3.2-vision-90b", layers=5, batch=4,
                 max_len=64, block=16, chunk=32, demo=4, new=20,
                 prefill=600, gen_size=6_447_783_938, prefill_flash=5)
COND_RANGES = ("encoder", "cross_attention", "FlashAttention.backward")
GATES = {"gate_attn": 0.5, "gate_ff": -0.4}   # tanh 0.46 and -0.38


def open_gates(torch, params):
    """The vision family's cross-layer gates (0 at init, which hides the
    layer and the gradients of its weights) set to GATES, in place."""
    with torch.no_grad():
        for sub in params["backbone"]["groups"].values():
            for name, value in GATES.items():
                if name in sub:
                    sub[name].fill_(value)
    return params


def check_vlm(torch, flash_ops):
    """12b, llama-3.2-vision-90b at full width, one group in G and D,
    the gates open: G's forward at COND_VLM's 2,048 tokens over 1,600
    stub image tokens and its backward (of a fixed random cotangent of
    its output), G freed; D on real tokens and on G's output and the
    backward of D's objective into D (the path: 15 flash_attn launches,
    each net's 4 causal self-attentions and one cross-attention, their
    shapes checked); every gradient finite, the gates' and the cross
    layer's k/v projections' non-zero; the peak device memory of each
    net; then D's logits at 520 tokens on the card against the port on
    the CPU from the same parameters (rtol 1e-4). Returns the path's
    launches and the summary."""
    import numpy as np
    from repro_torch.core import protocol
    from repro_torch.models import gan
    from repro_torch.models.specs import (make_backbone_spec,
                                          make_stub_enc_feats)
    from repro_torch.tree import tree_leaves, tree_map
    bb = COND_VLM
    cfg = backbone_config(bb)
    enc = make_stub_enc_feats(cfg, device="cuda")
    spec = make_backbone_spec(cfg, bb["seq"], enc_feats_fn=enc, remat=False,
                              gen_loss_variant="nonsaturating")
    calls = []
    wrapper = flash_ops.flash_attention

    def recording(q, k, v, *, causal=True, window=None):
        calls.append((tuple(q.shape), tuple(k.shape), causal, window))
        return wrapper(q, k, v, causal=causal, window=window)

    def grads_of(params, label, unused=()):
        skip = {id(x) for x in tree_leaves(unused)}
        grads = [x.grad for x in tree_leaves(params) if id(x) not in skip]
        if any(g is None or not bool(torch.isfinite(g).all())
               for g in grads):
            raise AssertionError(f"{cfg.name} {label}: a missing or "
                                 f"non-finite gradient")
        cross = params["backbone"]["groups"]["sub4"]
        moved = {name: float(t.grad.abs().max()) for name, t in (
            ("gate_attn", cross["gate_attn"]), ("gate_ff", cross["gate_ff"]),
            ("wk", cross["attn"]["wk"]), ("wv", cross["attn"]["wv"]))}
        if not all(v > 0 for v in moved.values()):
            raise AssertionError(f"{cfg.name} {label}: zero gradients "
                                 f"{moved}")
        return moved

    def build(init, seed):
        params = open_gates(torch, init(torch.Generator("cuda").manual_seed(
            seed), cfg))
        for x in tree_leaves(params):
            x.requires_grad_(True)
        return params

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = {}
    flash_ops.flash_attention = recording
    try:
        flash_ops.launches = 0                     # the path starts here
        params = build(gan.generator_init, 0)
        size_g = protocol.count_params(params)
        z = spec.sample_z(torch.Generator("cuda").manual_seed(1), bb["b"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fake = spec.gen_apply(params, z)
        torch.cuda.synchronize()
        out["g_forward_s"] = time.perf_counter() - t0
        cot = torch.randn(fake.shape, generator=torch.Generator(
            "cuda").manual_seed(2), device="cuda")
        t0 = time.perf_counter()
        (fake * cot).sum().backward()
        torch.cuda.synchronize()
        out["g_backward_s"] = time.perf_counter() - t0
        out["g_grad_max"] = grads_of(params, "G", unused={
            k: params[k] for k in ("embed", "lm_head")})
        out["g_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        fake = fake.detach()
        del params, cot, z
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = build(gan.discriminator_init, 3)
        size_d = protocol.count_params(params)
        tokens = torch.as_tensor(np.random.default_rng(4).integers(
            0, cfg.vocab, (bb["b"], bb["seq"])), device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real = spec.disc_real(params, tokens)
        fake_logits = spec.disc_fake(params, fake)
        objective = (torch.nn.functional.softplus(-real).mean()
                     + torch.nn.functional.softplus(fake_logits).mean())
        torch.cuda.synchronize()
        out["d_forward_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        objective.backward()
        torch.cuda.synchronize()
        out["d_backward_s"] = time.perf_counter() - t0
        launches = flash_ops.launches              # ... and ends here
        out["d_grad_max"] = grads_of(params, "D")
        out["d_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    finally:
        flash_ops.flash_attention = wrapper
    if (size_g, size_d) != bb["sizes"]:
        raise AssertionError(f"{cfg.name} sizes {(size_g, size_d)}")
    h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q, t = (bb["b"], bb["seq"], h, d), cfg.n_image_tokens
    net = [(q, (bb["b"], bb["seq"], kv, d), True, None)] * 4 + [
        (q, (bb["b"], t, kv, d), False, None)]
    if launches != 15 or calls != net * 3:
        raise AssertionError(f"{cfg.name}: {launches} flash_attn launches, "
                             f"calls {calls}")
    if not bool(torch.isfinite(objective)):
        raise AssertionError(f"{cfg.name}: objective {objective}")
    del real, fake_logits, objective, fake
    for x in tree_leaves(params):
        x.grad = None
        x.requires_grad_(False)
    print(f"12b {cfg.name} (one group, 4 self + 1 gated cross layer, "
          f"d_model {cfg.d_model}, {bb['b']} x {bb['seq']} tokens over {t} "
          f"image tokens, gates {GATES}): {size_g} G / {size_d} D "
          f"parameters; G forward {out['g_forward_s']:.3f} s, backward "
          f"{out['g_backward_s']:.3f} s, peak {out['g_peak_gib']:.2f} GiB; "
          f"D forward (real, fake) {out['d_forward_s']:.3f} s, backward "
          f"{out['d_backward_s']:.3f} s, peak {out['d_peak_gib']:.2f} GiB; "
          f"{launches} flash_attn launches (a net: 4 causal {q} over "
          f"{bb['seq']} keys, 1 bidirectional over {t}); every gradient "
          f"finite; largest |grad| of the gates and cross wk/wv: G "
          f"{out['g_grad_max']}, D {out['d_grad_max']}")

    check = make_backbone_spec(cfg, bb["check_seq"], enc_feats_fn=enc,
                               remat=False)
    short = tokens[:, :bb["check_seq"]]
    with torch.no_grad():
        card = check.disc_real(params, short).cpu()
    disc_cpu = tree_map(lambda x: x.detach().cpu(), params)
    del params
    torch.cuda.empty_cache()
    base = enc(1).cpu()
    check_cpu = make_backbone_spec(
        cfg, bb["check_seq"], remat=False,
        enc_feats_fn=lambda n: base.expand(n, -1, -1))
    t0 = time.perf_counter()
    with torch.no_grad():
        host = check_cpu.disc_real(disc_cpu, short.cpu())
    cpu_s = time.perf_counter() - t0
    torch.testing.assert_close(card, host, rtol=1e-4, atol=0)
    print(f"12b {cfg.name} D logits on {bb['check_seq']} real tokens over "
          f"{t} image tokens, card {card.tolist()} against the CPU "
          f"{host.tolist()} (rtol 1e-4; the CPU forward {cpu_s:.2f} s on "
          f"{torch.get_num_threads()} threads)")
    del disc_cpu
    out.update(launches=launches, cpu_s=cpu_s, logits_card=card.tolist(),
               logits_cpu=host.tolist())
    return {"flash_attn": launches}, out


def serve_conditioned(torch, setting, kernel_mods, out):
    """12c for one conditioned generator (`setting`): its requests
    through the paged engine (captured), the dense one and the paged one
    uncaptured, each filling its cross caches once from the stub
    frontend's features: tokens, and the captured and uncaptured cache
    leaves, bit for bit, no kernel launch in the engines; the greedy
    tokens against the full forward up to the first near tie; one
    mode="prefill" call against the chunked prefill (its flash_attn
    launches `setting["prefill_flash"]`); the replayed decode-only step
    beside its weight-read bound (the backbone, the lm_head and every
    slot's cross caches, once each). Returns the prefill's launches."""
    import numpy as np
    from repro_torch.core.protocol import count_params
    from repro_torch.models import gan
    from repro_torch.models.specs import make_stub_enc_feats
    from repro_torch.tree import tree_leaves
    cfg = backbone_config(setting)
    name = cfg.name
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = open_gates(torch, gan.generator_init(
        torch.Generator("cuda").manual_seed(0), cfg))
    size = count_params(params)
    if size != setting["gen_size"]:
        raise AssertionError(f"{name} generator {size}")
    enc = make_stub_enc_feats(cfg, device="cuda")
    work = (serving_traffic(cfg.vocab, setting) if "requests" in setting
            else demo_work(cfg.vocab, setting))
    runs = {}
    for label, paged, capture in (("paged", True, True),
                                  ("dense", False, True),
                                  ("paged uncaptured", True, False)):
        eng = serving_engine(torch, cfg, params, setting, paged=paged,
                             capture=capture, enc_feats_fn=enc)
        toks, wall, steps, _ = serve_traffic(torch, eng, work, kernel_mods)
        runs[label] = dict(tokens=toks, wall=wall, steps=steps, engine=eng,
                           steps_n=eng.dispatch_count,
                           captures=eng.compile_count,
                           bytes=eng.cache_bytes())
        if label == "dense":
            del eng, runs[label]["engine"]
    paged, dense, eager = (runs[k] for k in ("paged", "dense",
                                             "paged uncaptured"))
    if not paged["tokens"] == dense["tokens"] == eager["tokens"]:
        raise AssertionError(f"{name}: paged, dense and uncaptured tokens "
                             f"differ")
    for a, b in zip(tree_leaves(paged["engine"].caches),
                    tree_leaves(eager["engine"].caches)):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: captured and uncaptured cache "
                                 f"leaves differ")
    cross_bytes = sum(t.numel() * t.element_size()
                      for i, kind in enumerate(cfg.group_pattern)
                      if kind == "cross"
                      for t in paged["engine"].caches[f"sub{i}"].values())
    del paged["engine"], eager["engine"]
    torch.cuda.empty_cache()
    greedy = [rid for rid, (_, _, t) in enumerate(work) if t == 0.0][:4]
    ties = {}
    for rid in greedy:
        prompt, _, _ = work[rid]
        toks = paged["tokens"][rid]
        ref = teacher_forced(torch, gan, params, cfg, prompt, toks,
                             enc_feats=enc(1))
        ties[rid] = held_until_tie(toks, ref.argmax(-1).tolist(), ref,
                                   f"{name} rid {rid}")
    prompt = np.random.default_rng(8).integers(0, cfg.vocab,
                                               setting["prefill"])
    launched, errs = prefill_against_chunked(
        torch, gan, cfg, params, prompt, ("flash_attn",), kernel_mods,
        enc_feats=enc(1))
    if launched["flash_attn"] != setting["prefill_flash"]:
        raise AssertionError(f"{name} prefill: {launched}, expected "
                             f"{setting['prefill_flash']} flash_attn")
    lm_bytes = 4 * (count_params(params["backbone"])
                    + params["lm_head"].numel()) + cross_bytes
    dec_ms, n_dec = decode_only_ms(paged["steps"])
    eager_ms, _ = decode_only_ms(eager["steps"])
    n_tok = sum(len(t) for t in paged["tokens"].values())
    bound_ms = lm_bytes / HBM_BYTES_PER_S * 1e3
    out[name] = dict(
        layers=cfg.n_layers, generator_params=size, tokens=n_tok,
        tokens_per_s=n_tok / paged["wall"], paged_wall_s=paged["wall"],
        dense_wall_s=dense["wall"], uncaptured_wall_s=eager["wall"],
        steps=paged["steps_n"], captures=paged["captures"],
        first_step_per_program_s={str(c): x for c, x in
                                  _first_steps(paged["steps"]).items()},
        decode_step_ms=dec_ms, decode_steps=n_dec,
        uncaptured_decode_step_ms=eager_ms, weight_read_bound_ms=bound_ms,
        weight_and_cross_bytes=lm_bytes, cross_cache_bytes=cross_bytes,
        cache_bytes_paged=paged["bytes"], cache_bytes_dense=dense["bytes"],
        first_near_tie=ties, prefill_launches=launched,
        prefill_max_abs_err=errs,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    print(f"12c {name} ({cfg.n_layers} layers, {size:,} generator "
          f"parameters): {len(work)} requests, {n_tok} tokens, paged = dense "
          f"= uncaptured tokens and captured = uncaptured cache leaves bit "
          f"for bit; paged {paged['wall']:.3f} s "
          f"({out[name]['tokens_per_s']:.1f} tokens/s), dense "
          f"{dense['wall']:.3f} s, uncaptured {eager['wall']:.3f} s; "
          f"{paged['steps_n']} steps, {paged['captures']} captures; "
          f"decode-only step replayed {dec_ms:.3f} ms (mean of {n_dec}), "
          f"uncaptured {eager_ms:.3f} ms, weight-read bound {bound_ms:.3f} "
          f"ms ({lm_bytes / 1e9:.3f} GB at 3.35 TB/s, {cross_bytes:,} B of "
          f"cross caches); cache bytes dense {dense['bytes']:,}, paged "
          f"{paged['bytes']:,}; greedy against the full forward, first near "
          f"tie by rid: {ties}; prefill of {len(prompt)} tokens: "
          f"{launched}, logits max abs err {errs}; peak "
          f"{out[name]['peak_gib']:.2f} GiB")
    del params
    torch.cuda.empty_cache()
    return launched


def run_train_distgan_twin(torch, out):
    """12d: `python -m repro_torch.examples.train_distgan` on the card,
    2 rounds of each conditioned architecture, reduced, on its default
    (fused) driver: finite metrics and FIDs, and the seconds it took."""
    import io
    import numpy as np
    from repro_torch.examples import train_distgan
    for name in ("whisper-base", "llama-3.2-vision-90b"):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            hist = train_distgan.main(["--arch", name, "--rounds", "2",
                                       "--devices", "2", "--seq-len", "16"])
        secs = time.perf_counter() - t0
        values = [v for r in hist for v in r.metrics.values()] + [
            r.fid for r in hist if r.fid is not None]
        if len(hist) != 2 or not all(np.isfinite(v) for v in values):
            raise AssertionError(f"train_distgan --arch {name}: {hist}")
        out[f"train_distgan {name}"] = dict(
            seconds=secs, fid=[r.fid for r in hist])
        print(f"12d train_distgan --arch {name} (reduced, 2 rounds, fused) "
              f"on the card: {secs:.2f} s; its last line: "
              f"{buf.getvalue().strip().splitlines()[-1]}")


def conditioned_phase(torch, card, kernel_mods, whisper_shards):
    """Phase 12 on `card`: 12a whisper-base on `whisper_shards` (K=4
    shards of 448-token sequences), 12b llama-3.2-vision-90b's group,
    12c both generators served, 12d the train_distgan twin. Returns the
    launches of each path by kernel: "encdec" (12a's host rounds), "vlm"
    (12b), and "serving" (12c's mode="prefill" calls)."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out, launches = {}, {}
    launches["encdec"], out["whisper-base"] = zoo_train(
        torch, COND_WHISPER, whisper_shards, kernel_mods,
        want={"wavg": 1, "flash_attn": COND_WHISPER["per_round"]},
        n_rounds=2, phase="12a", ranges=COND_RANGES)
    stamp("conditioned: whisper-base")
    launches["vlm"], out["llama-3.2-vision-90b"] = check_vlm(
        torch, kernel_mods["flash_attn"])
    stamp("conditioned: llama-3.2-vision-90b")
    serving = {}
    for setting in (SERVE_WHISPER, SERVE_VLM):
        for k, n in serve_conditioned(torch, setting, kernel_mods,
                                      out).items():
            serving[k] = serving.get(k, 0) + n
    launches["serving"] = serving
    stamp("conditioned: serving")
    zero_counts(kernel_mods)
    run_train_distgan_twin(torch, out)
    zero_counts(kernel_mods)
    stamp("conditioned: train_distgan")
    out["phase_s"] = time.perf_counter() - t0
    print(f"conditioned phase on {card}: {out['phase_s']:.1f} s")
    print(json.dumps({"conditioned": out}, default=float))
    return launches


def host_rounds(torch):
    """`--host-rounds`: seconds a host-driver round in this process, under
    the PYTORCH_CUDA_ALLOC_CONF it was started with: the full DCGAN
    (K=10, serial, every device scheduled, 4 rounds) and mamba2-130m at
    phase 5's full width (3 serial rounds); one JSON line."""
    from repro_torch.configs import DCGANConfig, ProtocolConfig
    from repro_torch.core import Trainer
    from repro_torch.data import make_image_dataset, partition
    from repro_torch.models import dcgan, gan
    from repro_torch.models.specs import make_backbone_spec, make_dcgan_spec
    cfg = DCGANConfig()
    imgs, _ = make_image_dataset("celeba", 10 * 512, seed=0)
    trainer = Trainer(
        make_dcgan_spec(cfg, gen_loss_variant="nonsaturating"),
        ProtocolConfig(n_devices=10, n_d=5, n_g=5, sample_size=128,
                       server_sample_size=128, optimizer="adam"),
        lambda g: dcgan.gan_init(g, cfg), partition(imgs, 10), seed=0,
        driver="host")
    out = {"dcgan_s": [_timed_round(torch, trainer)[1] for _ in range(4)]}
    del trainer, imgs
    bb = MAMBA
    cfg = backbone_config(bb)
    _, shards = token_shards(bb, cfg)
    trainer = Trainer(
        make_backbone_spec(cfg, bb["seq"], remat=False,
                           gen_loss_variant="nonsaturating"),
        ProtocolConfig(n_devices=bb["k"], n_d=bb["n_d"], n_g=bb["n_g"],
                       sample_size=bb["m"], server_sample_size=bb["m"],
                       lr_d=1e-3, lr_g=1e-3, optimizer="adam"),
        lambda g: gan.gan_init(g, cfg), shards, seed=0, driver="host")
    out["mamba2_s"] = [_timed_round(torch, trainer)[1] for _ in range(3)]
    print(json.dumps({"alloc_conf": os.environ.get(
        "PYTORCH_CUDA_ALLOC_CONF", ""), **out}))


def allocator_ab(card):
    """`--allocator-ab`: `--host-rounds` in one process for each of
    ALLOC_CONFS in turn (fixed segments, expandable, expandable, fixed),
    the kernels already built; their seconds a round beside `card`."""
    runs = []
    for conf in ALLOC_CONFS:
        env = {k: v for k, v in os.environ.items()
               if k != "PYTORCH_CUDA_ALLOC_CONF"}
        if conf:
            env["PYTORCH_CUDA_ALLOC_CONF"] = conf
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--host-rounds"],
            env=env, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"--host-rounds under {conf!r} exited "
                               f"{proc.returncode}:\n{proc.stderr[-4000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(f"host rounds, PYTORCH_CUDA_ALLOC_CONF={conf!r}: DCGAN "
              f"{[round(x, 4) for x in runs[-1]['dcgan_s']]} s, mamba2-130m "
              f"{[round(x, 4) for x in runs[-1]['mamba2_s']]} s")
    print(f"allocator A/B on {card}")
    print(json.dumps({"allocator_ab": runs}))


# ---------------------------------------------------------------------------
# 13. The launch layer: launch/steps.py's train, prefill and decode steps
#     and the launch/train.py CLI, in the JAX launch step's bfloat16
# ---------------------------------------------------------------------------

# 13a: phase 5d's configuration and protocol (granite-3-2b, 4 layers, K=4,
# m=M=4, n_d=n_g=2, lr 1e-3, seq_len 1024) through build_train_step, with
# SGD: Adam's float32 update on the bfloat16 state is refused, as JAX's
# scan over the local steps refuses it (`optim.apply_updates`).
LAUNCH_A = dict(GRANITE, n_local=32)
# 13b: the launch step's own protocol (SGD, n_d=n_g=5, m = n_k = 4, M = K
# = 4, seq_len 1024) on granite-3-2b cut to `layers` of its 40: the
# deepest that fits one card (PERF.md section 4 has the reckoning; 20
# layers ran out of memory in the fused chunk's first round).
LAUNCH_B = dict(arch="granite-3-2b", layers=20, k=4, n_local=4, seq=1024)
# 13c: the CLI on mamba2-130m at full size, K=2 workers of 2 sequences of
# 64 tokens (the CLI's default length), the launch step's protocol.
LAUNCH_CLI = ("--arch", "mamba2-130m", "--data-dim", "2", "--batch", "4",
              "--seq-len", "64")
# 13c's bound on a net's update after 2 rounds, the mesh ring run's
# against the stacked run's (`update_residual`). The ring averages the
# dequantized uploads in float32 where the stacked run averages them
# rounded to bfloat16: on the same uploads the two means lie within one
# bfloat16 step of each other on every element (`ring_against_flat`), and
# at the launch step's learning rate (most updates below a step of their
# parameter) the rounding decisions that differ are carried on by the next
# round. Measured on the card at full size: 0.199 (G) and 0.091 (D), the
# flat gather's mesh run within a step of the stacked run everywhere (0);
# on the reduced model on the CPU 0.0073 and 0.038.
CLI_UPDATE_TOL = 0.3
# 13c at full size took 118-123 s on the card (PERF.md); the whole script,
# whose limit is 1,200 s, runs it there only when it starts by this time
CLI_FULL_BY_S = 1030.0
# 13d: prefill of 8 prompts of 1,024 tokens on 13a's generator, then
# decode steps against its caches.
LAUNCH_SERVE = dict(batch=8, seq=1024)
# cuBLAS's and CUTLASS's matrix-product kernels, by name, and the float32
# ones among them (FFMA: TF32 is off)
GEMM_KERNELS = r"(?i)gemm|nvjet|xmma"
F32_GEMM_KERNELS = r"(?i)f32f32|sgemm"


def launch_flash_per_round(bb, n_d, n_g):
    """flash_attn launches of a launch-step round: every sublayer forward
    once, and again in the backward (the launch spec recomputes each
    group, `remat=True`): n_d (L + 4 K L) + n_g 4 L (the generator once
    without a gradient and K discriminators on real and fake per local
    step; generator and discriminator forward and backward per server
    step)."""
    layers, k = bb["layers"], bb["k"]
    return n_d * (layers + 4 * k * layers) + n_g * 4 * layers


def _dtypes(tree):
    from repro_torch.tree import tree_leaves
    return sorted({str(x.dtype).replace("torch.", "")
                   for x in tree_leaves(tree) if x.is_floating_point()})


def _launch_state(torch, cfg, pcfg, k):
    """The launch CLI's start state on the card: the float32 init cast to
    bfloat16 (`steps._bf16_floats`)."""
    from repro_torch.core import protocol
    from repro_torch.launch import steps
    from repro_torch.models import gan
    return steps._bf16_floats(protocol.make_train_state(
        lambda g: gan.gan_init(g, cfg), pcfg, k, seed=0, device="cuda"))


def _timed_call(torch, fn, *args):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def launch_a(torch, kernel_mods, tokens, f32_ref):
    """13a: granite-3-2b (4 layers) with phase 5d's protocol, SGD in
    place of Adam (LAUNCH_A), through `launch.steps.build_train_step`
    from the bfloat16 start state: Adam refused first, then round 0
    eager (the path's launch counts), a profiled round from a fresh
    bfloat16 state (GEMMs, the float32 ones, FlashAttention.backward)
    beside phase 5d's float32 round, then rounds 1-4 through the fused
    step (fuse_rounds=2: the warm-up, the capture and replays), timed
    and one chunk profiled; the state stays bfloat16. Returns (summary,
    the path's launches, the generator)."""
    import numpy as np
    from repro_torch.configs import ProtocolConfig, ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.tree import tree_leaves
    bb = LAUNCH_A
    cfg = backbone_config(bb)
    k = bb["k"]
    pcfg = ProtocolConfig(n_devices=k, n_d=bb["n_d"], n_g=bb["n_g"],
                          sample_size=bb["m"], server_sample_size=bb["m"],
                          lr_d=1e-3, lr_g=1e-3)
    shape = ShapeConfig("launch_a", bb["seq"], k * bb["n_local"], "train")
    single, args = steps.build_train_step(cfg, shape, k, pcfg=pcfg)
    fused, _ = steps.build_train_step(cfg, shape, k, pcfg=pcfg,
                                      fuse_rounds=2)
    batch = {"tokens": torch.as_tensor(tokens[:, :bb["n_local"]])}
    weights = torch.full((k,), float(bb["m"]), device="cuda")
    per_round = launch_flash_per_round(bb, pcfg.n_d, pcfg.n_g)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    adam_pcfg = dataclasses.replace(pcfg, optimizer="adam")
    adam, _ = steps.build_train_step(cfg, shape, k, pcfg=adam_pcfg)
    state = _launch_state(torch, cfg, adam_pcfg, k)
    try:
        adam(state, batch, weights, 0)
    except TypeError as err:
        print(f"13a: Adam on the bfloat16 launch state is refused, as in "
              f"the JAX package: {str(err)[:160]}...")
    else:
        raise AssertionError("13a: Adam's float32 update was taken on the "
                             "bfloat16 state")
    del adam, state
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = _launch_state(torch, cfg, pcfg, k)
    if _dtypes(state) != ["bfloat16"] or [
            (tuple(a.shape), a.dtype) for a in tree_leaves(state)] != [
            (tuple(a.shape), a.dtype) for a in tree_leaves(args[0])]:
        raise AssertionError("13a: the start state is not the step's "
                             "abstract state")
    zero_counts(kernel_mods)              # the path starts here
    (state, metrics), first_s = _timed_call(torch, single, state, batch,
                                            weights, 0)
    launches = kernel_counts(kernel_mods)  # ... and ends here
    if (launches["wavg"], launches["flash_attn"]) != (1, per_round):
        raise AssertionError(f"13a round 0 launches {launches}, expected 1 "
                             f"wavg and {per_round} flash_attn")
    metrics = {k_: float(v) for k_, v in metrics.items()}
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"13a non-finite objectives {metrics}")
    print(f"13a granite-3-2b (4 layers, K=4, m=4, n_d=n_g=2, SGD, "
          f"seq_len 1024) launch step, round 0 from the bfloat16 state: "
          f"{first_s:.3f} s, D {metrics['disc_objective']:+.5f} G "
          f"{metrics['gen_objective']:+.5f}; {launches['flash_attn']} "
          f"flash_attn and {launches['wavg']} wavg launches; the state's "
          f"float dtypes after it {_dtypes(state)}")

    fresh = _launch_state(torch, cfg, pcfg, k)
    prof = profile_round(torch, types.SimpleNamespace(
        run=lambda n: single(fresh, batch, weights, 0)),
        "13a bfloat16 launch-step", kernels=(GEMM_KERNELS, F32_GEMM_KERNELS))
    del fresh
    gc.collect()
    torch.cuda.empty_cache()

    (state, m12), chunk1_s = _timed_call(torch, fused, state, batch,
                                         weights, 1)
    (state, m34), chunk2_s = _timed_call(torch, fused, state, batch,
                                         weights, 3)
    graph = fused.graph
    if not (graph.captured and graph.eager_rounds == 1
            and graph.replays == 3):
        raise AssertionError(f"13a: eager {graph.eager_rounds}, replays "
                             f"{graph.replays}")
    objs = [float(v) for v in np.concatenate([m12["disc_objective"],
                                              m34["disc_objective"]])]
    replay_s = chunk2_s / 2
    # one replay of the step's graph, round 5's draws in its slots (a
    # chunk of two holds ~50,000 kernels, past what the profiler keeps
    # whole)
    counts, busy_s, wall_s, n_ops = profile_replay(torch, types.SimpleNamespace(
        _graph=graph, run=lambda n: graph.run(1, lambda i: fused.sampler(
            5, out=fused.slots["draws"]))), "13a launch step")
    # the launches come from the wrappers (the eager round above); the
    # profiler drops a record now and then at ~25,000 kernels a round,
    # so the replay's count by name is reported, not held exact
    if counts["wavg"] > 1 or counts["flash_attn"] > per_round:
        raise AssertionError(f"13a replayed round: {counts}")
    print(f"13a: the profiler saw {counts['flash_attn']} of the replay's "
          f"{per_round} flash_attn kernels and {counts['wavg']} of its 1 "
          f"wavg")
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not all(np.isfinite(objs)) or _dtypes(state) != ["bfloat16"]:
        raise AssertionError(f"13a objectives {objs}, state dtypes "
                             f"{_dtypes(state)}")
    print(f"13a fused launch step (fuse_rounds=2): rounds 1-2 (eager "
          f"warm-up + capture + replay) {chunk1_s:.3f} s, rounds 3-4 "
          f"replayed {chunk2_s:.3f} s ({replay_s:.4f} s a round); D "
          f"{[round(x, 5) for x in objs]}; peak device memory "
          f"{peak:.2f} GiB")
    out = dict(round0_s=first_s, replay_s=replay_s, chunk1_s=chunk1_s,
               replay_busy_s=busy_s, replay_device_ops=n_ops,
               peak_gib=peak, profile=prof, flash_per_round=per_round)
    if f32_ref is not None:
        def part(p, key, name=None):
            p = (p or {}).get(key)
            return p if name is None or p is None else p.get(name)
        ref_prof = f32_ref["profile"]
        print(f"13a bfloat16 against phase 5d's float32 granite round "
              f"(the same model, data and protocol but the optimizer; 5d "
              f"and 7: Adam, remat off and the non-saturating loss, 13a: "
              f"SGD, the launch spec's remat and minimax): replay {replay_s:.4f} s a round against phase "
              f"7's float32 replays {f32_ref['replay_s']} and host rounds "
              f"{f32_ref['host_s']}; the profiled eager round's device "
              f"busy {part(prof, 'busy_s')} s against "
              f"{part(ref_prof, 'busy_s')}, GEMMs "
              f"{part(prof, 'kernels_s', GEMM_KERNELS)} s against "
              f"{part(ref_prof, 'kernels_s', GEMM_KERNELS)}, "
              f"FlashAttention.backward "
              f"{part(prof, 'ranges_s', 'FlashAttention.backward')} s "
              f"against "
              f"{part(ref_prof, 'ranges_s', 'FlashAttention.backward')}")
        out["f32"] = f32_ref
    gen = state["gen"]
    del state, single, fused, graph
    return out, launches, gen


def time_wavg_at(torch, wavg_ops, k, n):
    """wavg at the launch path's (K, N) float32 payload: the kernel, its
    plain version and `w @ x` beside the bytes bound (one payload, far
    past L2), and the kernel held to its plain version."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((k, n), generator=gen, device="cuda")
    w = torch.rand(k, generator=gen, device="cuda")
    w = w / w.sum()
    out = wavg_ops.weighted_average(x, w)
    ref = wavg_ops.wavg_ref(x, w)
    torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)
    err = float((out - ref).abs().max())
    del out, ref
    main = [(x, w)]
    kernel_ms = time_ms(wavg_ops.weighted_average, main, reps=5, per_rep=3)
    plain_ms = time_ms(wavg_ops.wavg_ref, main, reps=3, per_rep=1)
    library_ms = time_ms(lambda x, w: torch.matmul(w, x), main, reps=5,
                         per_rep=3)
    n_bytes = (k * n + k + n) * 4
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    print(f"wavg at 13b's payload K={k} N={n}: kernel {kernel_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, w @ x {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({n_bytes} B); {bound_ms / kernel_ms:.3f} of "
          f"HBM peak; max abs err {err:.3e}")
    del x, w, main
    gc.collect()
    torch.cuda.empty_cache()
    return dict(k=k, n=n, ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=library_ms,
                max_abs_err=err)


def launch_b(torch, kernel_mods, tokens):
    """13b: the launch step's own protocol on granite-3-2b at LAUNCH_B's
    depth, all-bfloat16 SGD state: the memory reckoning, wavg at its
    payload, one chunk of the fused step (fuse_rounds=2): round 0 eager
    (the warm-up), the capture and round 1 replayed, each timed. Returns
    (summary, the path's launches)."""
    import numpy as np
    from repro_torch.configs import ShapeConfig
    from repro_torch.core import graphs, protocol
    from repro_torch.launch import steps
    bb = LAUNCH_B
    cfg = backbone_config(bb)
    k = bb["k"]
    shape = ShapeConfig("launch_b", bb["seq"], k * bb["n_local"], "train")
    fused, args = steps.build_train_step(cfg, shape, k, fuse_rounds=2)
    pcfg = fused.pcfg
    d = protocol.count_params(args[0]["disc"])
    g = protocol.count_params(args[0]["gen"])
    gb = lambda n_bytes: n_bytes / 1e9
    print(f"13b granite-3-2b at {cfg.n_layers} of 40 layers, the launch "
          f"step's protocol ({pcfg}): D {d}, G {g} parameters; reckoned: "
          f"state (D + G) x 2 B {gb((d + g) * 2):.1f} GB, K uploads "
          f"{gb(k * d * 2):.1f} GB (twice while stacked), the (K, N) "
          f"float32 payload {gb(k * d * 4):.1f} GB and the quantizer's "
          f"uniforms {gb(k * d * 4):.1f} GB, its mean {gb(d * 4):.1f} GB")
    wavg = time_wavg_at(torch, kernel_mods["wavg"], k, d)
    batch = {"tokens": torch.as_tensor(tokens[:, :bb["n_local"]])}
    weights = torch.full((k,), float(bb["n_local"]), device="cuda")
    per_round = launch_flash_per_round(bb, pcfg.n_d, pcfg.n_g)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = _launch_state(torch, cfg, pcfg, k)
    # one chunk of the fused step, timed by part from the script: the
    # graph's first body call is the eager warm-up, which the graph
    # synchronises before it captures; the second is the capture (host
    # work only); what follows it is round 1's replay and the chunk's
    # copy to the host
    graph_round = graphs.RoundGraph._round
    parts = []

    def timed_round(graph):
        t0 = time.perf_counter()
        row = graph_round(graph)
        parts.append((t0, time.perf_counter()))
        return row

    zero_counts(kernel_mods)              # the path starts here
    graphs.RoundGraph._round = timed_round
    try:
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        state, m01 = fused(state, batch, weights, 0)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
    except torch.OutOfMemoryError:
        print(torch.cuda.memory_summary(abbreviated=True))
        raise
    finally:
        graphs.RoundGraph._round = graph_round
    launches = kernel_counts(kernel_mods)  # ... and ends here
    peak = torch.cuda.max_memory_allocated() / 2**30
    graph = fused.graph
    # the wrappers count the warm-up's launches and the capture's
    # records; the replay runs the captured kernels without calling them
    if not (graph.captured and graph.replays == 1 and len(parts) == 2) or (
            launches["wavg"], launches["flash_attn"]) != (2, 2 * per_round):
        raise AssertionError(f"13b: replays {graph.replays}, body calls "
                             f"{len(parts)}, launches {launches}")
    (warm0, _), (capture0, capture1) = parts
    chunk_s, eager_s = t_end - t_start, capture0 - warm0
    capture_s, replay_s = capture1 - capture0, t_end - capture1
    objs = [float(v) for v in m01["disc_objective"]]
    if _dtypes(state) != ["bfloat16"] or not all(np.isfinite(objs)):
        raise AssertionError(f"13b state dtypes {_dtypes(state)}, "
                             f"objectives {objs}")
    print(f"13b launch step, one fused chunk (fuse_rounds=2) "
          f"{chunk_s:.3f} s: round 0 eager {eager_s:.3f} s, the capture "
          f"{capture_s:.3f} s, round 1 replayed {replay_s:.3f} s; peak "
          f"device memory {peak:.2f} GiB (max_memory_allocated); "
          f"{per_round} flash_attn and 1 wavg launches a round (the "
          f"wrappers' calls: {launches['flash_attn']} and "
          f"{launches['wavg']}, the warm-up's and the capture's); D "
          f"{[round(x, 5) for x in objs]}")
    out = dict(layers=cfg.n_layers, d_params=d, g_params=g,
               eager_s=eager_s, capture_s=capture_s, replay_s=replay_s,
               chunk_s=chunk_s, peak_gib=peak, flash_per_round=per_round,
               wavg=wavg)
    del state, fused, graph
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches


# 13e's checks of the dry run against the card: FLOPs (the same ops,
# counted the same way on the meta device and on the card) and the
# reckoned peak memory against max_memory_allocated
DRY_FLOPS_RTOL, DRY_PEAK_RTOL = 0.01, 0.15


def _launch_a_step():
    """13a's configuration (LAUNCH_A) as a fresh step of
    `launch.steps.build_train_step`: (config, step, its meta args)."""
    from repro_torch.configs import ProtocolConfig, ShapeConfig
    from repro_torch.launch import steps
    bb = LAUNCH_A
    cfg = backbone_config(bb)
    k = bb["k"]
    pcfg = ProtocolConfig(n_devices=k, n_d=bb["n_d"], n_g=bb["n_g"],
                          sample_size=bb["m"], server_sample_size=bb["m"],
                          lr_d=1e-3, lr_g=1e-3)
    shape = ShapeConfig("launch_a", bb["seq"], k * bb["n_local"], "train")
    step, args = steps.build_train_step(cfg, shape, k, pcfg=pcfg)
    return cfg, step, args


def launch_dryrun(torch, kernel_mods, tokens, replay_s):
    """13e: the dry run against one measured round of 13a's
    configuration: `launch.dryrun.dry_call` on the meta device (on the
    host, timed), then the same step's eager round on the card under
    the same counter (`launch.hlo_costs`) from 13a's bfloat16 start
    state, after reset_peak_memory_stats, timed with a synchronise.
    Holds FLOPs within DRY_FLOPS_RTOL, each kernel's calls to the card's
    launch counts, the reckoned peak within DRY_PEAK_RTOL of
    max_memory_allocated less what earlier phases hold, and compute_s
    to at most 13a's replay (`replay_s`). Returns (summary, the
    launches of the card's round)."""
    import numpy as np
    from repro_torch.launch import analysis, dryrun, hlo_costs
    bb = LAUNCH_A
    t0 = time.perf_counter()
    cfg, step, args = _launch_a_step()
    meta = dryrun.dry_call(step, (*args[:3], 0))
    dry_s = time.perf_counter() - t0
    costs, mem = meta.totals(), meta.memory()
    roof = analysis.analyze(costs, mem, 1)["roofline"]
    del step, args, meta
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()       # what earlier phases keep
    cfg, step, _ = _launch_a_step()
    state = _launch_state(torch, cfg, step.pcfg, bb["k"])
    batch = {"tokens": torch.as_tensor(tokens[:, :bb["n_local"]])}
    weights = torch.full((bb["k"],), float(bb["m"]), device="cuda")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernel_mods)              # the path starts here
    t0 = time.perf_counter()
    (_, metrics), card = hlo_costs.count_costs(step, state, batch, weights,
                                               0)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = kernel_counts(kernel_mods)  # ... and ends here
    max_alloc = torch.cuda.max_memory_allocated()
    measured = max_alloc - held
    got = card.totals()
    calls = {name: costs["kernels"].get(name, {}).get("calls", 0)
             for name in launches}
    gib = lambda n: n / 2**30
    print(f"13e dry run of 13a's step (granite-3-2b, 4 layers, K=4, m=4, "
          f"n_d=n_g=2, SGD, seq_len 1024, bfloat16) on the meta device: "
          f"{dry_s:.2f} s on the host; the same step's eager round on the "
          f"card under the counter {card_s:.3f} s (13a's replay "
          f"{replay_s:.4f} s a round)")
    print(f"13e FLOPs: meta {costs['flops']:.6e}, card {got['flops']:.6e} "
          f"(rel {abs(costs['flops'] - got['flops']) / got['flops']:.2e}); "
          f"hbm_bytes meta {costs['hbm_bytes']:.6e}, card "
          f"{got['hbm_bytes']:.6e}; kernel calls meta {calls}, the card's "
          f"launch counters {launches}")
    print(f"13e memory: reckoned peak {gib(mem['peak_bytes']):.3f} GiB "
          f"(arguments {gib(mem['argument_bytes']):.3f}, temporaries "
          f"{gib(mem['temp_bytes']):.3f}); measured max_memory_allocated "
          f"{gib(max_alloc):.3f} GiB, less {gib(held):.3f} GiB held by "
          f"earlier phases: {gib(measured):.3f} GiB "
          f"(reckoned / measured {mem['peak_bytes'] / measured:.4f})")
    print(f"13e roofline (H100 SXM published peaks): compute_s "
          f"{roof['compute_s']:.4f}, memory_s {roof['memory_s']:.4f}, "
          f"dominant {roof['dominant']}; the eager round {card_s:.3f} s, "
          f"13a's replay {replay_s:.4f} s")
    failed = []
    if not abs(costs["flops"] - got["flops"]) <= DRY_FLOPS_RTOL * got["flops"]:
        failed.append("FLOPs")
    if calls != launches:
        failed.append("kernel calls")
    if not abs(mem["peak_bytes"] - measured) <= DRY_PEAK_RTOL * measured:
        failed.append("peak memory")
    if not roof["compute_s"] <= replay_s:
        failed.append("compute_s above the replay")
    if not all(np.isfinite(float(v)) for v in metrics.values()):
        failed.append("non-finite objectives")
    if failed:
        raise AssertionError(f"13e: the dry run misses the card on "
                             f"{failed}")
    out = dict(dry_s=dry_s, card_s=card_s, replay_s=replay_s,
               flops_meta=costs["flops"], flops_card=got["flops"],
               hbm_bytes_meta=costs["hbm_bytes"],
               hbm_bytes_card=got["hbm_bytes"], kernel_calls_meta=calls,
               launches=launches, reckoned=mem,
               max_memory_allocated=max_alloc, held=held,
               measured_peak=measured, roofline=roof)
    del state, step, card
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches


def reckon_launch_b():
    """13b's step (LAUNCH_B, the launch step's own protocol) dry-run on
    the meta device: (its memory reckoning, the host seconds)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun, steps
    bb = LAUNCH_B
    t0 = time.perf_counter()
    shape = ShapeConfig("launch_b", bb["seq"], bb["k"] * bb["n_local"],
                        "train")
    step, args = steps.build_train_step(backbone_config(bb), shape, bb["k"])
    mem = dryrun.dry_call(step, (*args[:3], 0)).memory()
    return mem, time.perf_counter() - t0


def _memo_token_dataset(train, cache):
    """Make `train.make_token_dataset` (the CLI's token table, 10 GB of
    transition tables drawn on the host at vocab 50,280) compute each
    argument set once and hand out copies, keeping them in `cache`, a
    dict: the runs of 13c, and the mesh ranks given the cache, draw the
    same table. Returns the function to put back."""
    real = train.make_token_dataset

    def memo(*args, **kw):
        key = (args, tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = real(*args, **kw)
        return tuple(x.copy() for x in cache[key])

    train.make_token_dataset = memo
    return real


def _bf16_step(torch, x, y):
    """The bfloat16 spacing at the larger of |x| and |y|, elementwise."""
    mag = torch.maximum(x.abs(), y.abs()).clamp_min(1e-30)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def ring_against_flat(torch, uploads, rank):
    """On each of 2 gloo ranks sharing the card: Algorithm 2's average of
    the same bfloat16 uploads (this rank's `uploads` tree) through the
    ring (`ring_average_psum`, the 16-bit wire, the dequantized uploads
    accumulated in float32) and through the flat gather (each upload
    quantized and dequantized to bfloat16 by `roundtrip`, then the wavg
    kernel), with the same uniforms and weights 1 and 3. The two differ
    by the uploads' rounding to bfloat16 (half a step of the largest
    upload at most) and each result's own (half a step each), so every
    element must lie within two steps at the largest of the uploads'
    and the results' magnitudes. Returns this rank's largest
    |ring - flat| in those steps, the share of elements within one
    step and the element count."""
    from repro_torch.core import quantize
    from repro_torch.core.averaging import weighted_average_psum
    from repro_torch.kernels.ring_wavg import ops as ring_ops
    from repro_torch.launch import mesh
    from repro_torch.tree import tree_leaves
    n = sum(x.numel() for x in tree_leaves(uploads))
    uniforms = torch.rand(n, device="cuda", generator=torch.Generator(
        "cuda").manual_seed(100 + rank))
    w = torch.tensor(1.0 + 2 * rank, device="cuda")
    ring = ring_ops.ring_average_psum(uploads, w, uniforms=uniforms, bits=16)
    sent = quantize.roundtrip(uniforms, uploads, 16)
    flat = weighted_average_psum(sent, w, impl="pallas")
    worst, within, count = 0.0, 0, 0
    for u, a, b in zip(tree_leaves(sent), tree_leaves(ring),
                       tree_leaves(flat)):
        largest = mesh.all_gather(u.float().reshape(-1).abs(),
                                  None).amax(0).reshape(u.shape)
        a, b = a.float(), b.float()
        step = _bf16_step(torch, torch.maximum(largest, a.abs()), b)
        gap = (a - b).abs() / step
        worst = max(worst, float(gap.max()))
        within += int((gap <= 1).sum())
        count += gap.numel()
    return worst, within / count, count


def launch_cli_rank(argv, uploads_dir, tokens, rank, world_size, device):
    """A rank of the CLI's mesh layout (`launch.train._train_rank`, which
    `main` spawns) on the token tables in `tokens` (a
    `_memo_token_dataset` cache), with the kernels' launch counts set to 0
    before it and read after it; then `ring_against_flat` on the
    discriminator of the stacked run's checkpoint at round 2 in
    `uploads_dir`. Returns (the launches, the witness)."""
    import torch
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.kernels.ring_wavg import ops as ring_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.wavg import ops as wavg_ops
    from repro_torch.launch import train
    from repro_torch.tree import tree_map
    mods = {"wavg": wavg_ops, "ssd_scan": ssd_ops, "ring_accum": ring_ops}
    _memo_token_dataset(train, tokens)
    for mod in mods.values():
        mod.launches = 0
    args, faults, reducer = train._checked_args(argv)
    train._train_rank(args, faults, reducer, rank, world_size, device)
    launches = {name: mod.launches for name, mod in mods.items()}
    # rank 1 sends each leaf's elements in reverse order: uploads of one
    # magnitude whose values differ, so that a lost or misweighted upload
    # moves the average by many steps
    disc = load_checkpoint(uploads_dir, 2)[0]["state"]["disc"]
    uploads = tree_map(lambda x: (x.flip(tuple(range(x.dim()))) if rank
                                  else x).to("cuda"), disc)
    return launches, ring_against_flat(torch, uploads, rank)


def _leaf_bytes(torch, tree):
    """A tree's leaves as (dtype, shape, bytes): equal iff bit for bit."""
    import numpy as np
    from repro_torch.tree import tree_leaves
    out = []
    for x in tree_leaves(tree):
        if torch.is_tensor(x):
            x = (x.view(torch.int16) if x.dtype == torch.bfloat16
                 else x).numpy()
        x = np.asarray(x)
        out.append((str(x.dtype), x.shape, x.tobytes()))
    return out


def update_residual(torch, got, want, start):
    """How far a net's update (got - start) lies from the reference's
    (want - start) beyond the rounding of the stored results: the norm of
    each element's |got - want| less one bfloat16 step (two roundings to
    bfloat16 of the same float32 value differ by less), at least 0, over
    the norm of the reference's update, all leaves together; and the
    largest such share of a single leaf."""
    from repro_torch.tree import tree_leaves
    res = upd = worst = 0.0
    for x, y, x0 in zip(tree_leaves(got), tree_leaves(want),
                        tree_leaves(start)):
        x, y, x0 = (t.to("cuda").float() for t in (x, y, x0))
        r = float(torch.linalg.vector_norm(
            ((x - y).abs() - _bf16_step(torch, x, y)).clamp_min(0)))
        u = float(torch.linalg.vector_norm(y - x0))
        res, upd = res + r * r, upd + u * u
        worst = max(worst, r / u if u > 0 else (0.0 if r == 0 else 1e30))
    return (res / upd) ** 0.5, worst


def launch_cli(torch, kernel_mods, directory, reduced):
    """13c: `python -m repro_torch.launch.train` on mamba2-130m at full
    size (bfloat16 ssd_scan; `reduced`: its reduced config), through
    `main(argv)` in this process: an
    uninterrupted 2-round run (checkpoints at rounds 1 and 2), and its
    round-1 checkpoint --resume'd to 2, held to it bit for bit; then
    --layout mesh --data-dim 2 --avg-impl ring for 2 rounds on 2 gloo
    ranks sharing the card (the stacked runs' token table handed to
    them), and on those ranks `ring_against_flat` on the stacked run's
    discriminator. Each net's update after 2 rounds, the
    ring run's against the stacked run's, must lie within
    CLI_UPDATE_TOL (`update_residual`). Returns (summary, the stacked
    runs' launches, the ranks')."""
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.configs import ProtocolConfig, get_arch_config
    from repro_torch.launch import mesh, train
    base = list(LAUNCH_CLI) + (["--reduced"] if reduced else [])
    d = {name: os.path.join(directory, name)
         for name in ("whole", "cut", "ring")}
    tokens = {}
    real_tokens = _memo_token_dataset(train, tokens)
    try:
        zero_counts(kernel_mods)               # the path starts here
        t0 = time.perf_counter()
        train.main(base + ["--rounds", "2", "--ckpt-every", "1",
                           "--ckpt-dir", d["whole"]])
        whole_s = time.perf_counter() - t0
        # the run as it stood at its round-1 checkpoint (written while
        # round 2 updated the live state), resumed to round 2
        os.makedirs(d["cut"])
        for ext in ("npz", "json"):
            shutil.copy(os.path.join(d["whole"], f"ckpt_00000001.{ext}"),
                        d["cut"])
        t0 = time.perf_counter()
        train.main(base + ["--rounds", "2", "--ckpt-dir", d["cut"],
                           "--resume"])
        resume_s = time.perf_counter() - t0
        launches = kernel_counts(kernel_mods)  # ... and ends here
    finally:
        train.make_token_dataset = real_tokens
    got, want = (load_checkpoint(d[name], 2)[0] for name in ("cut", "whole"))
    if _leaf_bytes(torch, got) != _leaf_bytes(torch, want):
        raise AssertionError("13c: the resumed run's round 2 is not the "
                             "uninterrupted run's")
    print(f"13c the CLI on mamba2-130m ({' '.join(base)}): the "
          f"uninterrupted 2-round run (checkpoints at 1 and 2) "
          f"{whole_s:.2f} s with its token table; its round-1 checkpoint "
          f"resumed to round 2 ({resume_s:.2f} s) is bit for bit its round "
          f"2; wrapper calls {launches}")
    argv = base + ["--rounds", "2", "--layout", "mesh", "--avg-impl", "ring",
                   "--ckpt-dir", d["ring"]]
    t0 = time.perf_counter()
    ranks = mesh.spawn(functools.partial(launch_cli_rank, argv, d["whole"],
                                         tokens),
                       2, device="cuda", backend="gloo")
    mesh_s = time.perf_counter() - t0
    rank_launches = {name: sum(r[0][name] for r in ranks)
                     for name in ranks[0][0]}
    if min(r[0]["ring_accum"] for r in ranks) < 1 or rank_launches["wavg"]:
        raise AssertionError(f"13c mesh ring: launches {ranks}")
    witness = [r[1] for r in ranks]
    print(f"13c the ring against the flat gather on the same bfloat16 "
          f"uploads (mamba2-130m's discriminator, {witness[0][2]} "
          f"parameters, rank 1's reversed, weights 1 and 3, the 16-bit "
          f"wire): the largest gap in bfloat16 steps and the share within "
          f"one step by rank "
          f"{[(round(w[0], 3), round(w[1], 6)) for w in witness]} "
          f"(bound 2)")
    ring = load_checkpoint(d["ring"], 2)[0]
    if int(ring["trainer"]["round_index"]) != 2:
        raise AssertionError(f"13c mesh ring: round "
                             f"{ring['trainer']['round_index']}")
    # the CLI's start state: the proposed algorithm's float32 init (seed
    # 0) cast to bfloat16
    cfg = get_arch_config("mamba2-130m")
    start = _launch_state(torch, cfg.reduced() if reduced else cfg,
                          ProtocolConfig(n_devices=2), 2)
    within = {part: update_residual(torch, ring["state"][part],
                                    want["state"][part], start[part])
              for part in ("gen", "disc")}
    del start
    shown = {k: (round(v[0], 5), round(v[1], 5)) for k, v in within.items()}
    print(f"13c --layout mesh --data-dim 2 --avg-impl ring on 2 gloo "
          f"ranks: {mesh_s:.2f} s with the ranks' start-up; launches on the "
          f"ranks {rank_launches}; at round 2 each net's update against the "
          f"stacked run's beyond a bfloat16 step of rounding (share of the "
          f"update's norm, the largest of a leaf): {shown} (bound "
          f"{CLI_UPDATE_TOL} on the first)")
    if max(w[0] for w in witness) > 2 or not all(
            v[0] <= CLI_UPDATE_TOL for v in within.values()):
        raise AssertionError(f"13c: the ring's average of the same "
                             f"bfloat16 uploads beyond two steps of the flat "
                             f"path's ({witness}), or updates beyond "
                             f"{CLI_UPDATE_TOL} ({within})")
    return (dict(whole_s=whole_s, resume_s=resume_s, mesh_s=mesh_s,
                 ring_against_flat=witness, updates_within=within),
            launches, rank_launches)


def launch_serve(torch, kernel_mods, gen_params):
    """13d: the prefill and decode steps on 13a's generator cast to
    bfloat16: a prefill of LAUNCH_SERVE's prompts (one flash_attn launch
    a layer), its caches the decode step's abstract ones, then a decode
    step that rewrites the last position with the last prompt token,
    whose logits must be the prefill's (the same row, bfloat16
    round-off), and the decode step timed."""
    import numpy as np
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.tree import tree_leaves
    cfg = backbone_config(LAUNCH_A)
    b, s = LAUNCH_SERVE["batch"], LAUNCH_SERVE["seq"]
    prefill, pargs = steps.build_prefill_step(
        cfg, ShapeConfig("launch_prefill", s, b, "prefill"))
    decode, dargs = steps.build_decode_step(
        cfg, ShapeConfig("launch_decode", s, b, "decode"))
    params = steps._bf16_floats(gen_params)
    tokens = torch.randint(0, cfg.vocab, (b, s), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(3),
                           dtype=torch.int32)
    zero_counts(kernel_mods)               # the path starts here
    (logits, caches), prefill_s = _timed_call(torch, prefill, params,
                                              {"tokens": tokens})
    launches = kernel_counts(kernel_mods)  # ... and ends here
    if launches["flash_attn"] != cfg.n_layers:
        raise AssertionError(f"13d prefill: {launches}")
    if [(tuple(x.shape), x.dtype) for x in tree_leaves(caches)] != [
            (tuple(a.shape), a.dtype) for a in tree_leaves(dargs[2])]:
        raise AssertionError("13d: the prefill's caches are not the decode "
                             "step's")
    (dlogits, caches), first_s = _timed_call(
        torch, decode, params, tokens[:, -1:], caches, s - 1)
    scale = float(logits.float().abs().max())
    diff = float((dlogits.float() - logits.float()).abs().max())
    if not (np.isfinite(scale) and diff <= 2e-2 * scale):
        raise AssertionError(f"13d: decode at the last position {diff} "
                             f"from the prefill's logits (max {scale})")
    steps_s = [_timed_call(torch, decode, params, tokens[:, -1:], caches,
                           s - 1)[1] for _ in range(5)]
    print(f"13d the prefill step on 13a's generator ({b} x {s} tokens, "
          f"bfloat16): {prefill_s:.4f} s, {launches['flash_attn']} "
          f"flash_attn launches; the decode step at the last position "
          f"within {diff:.3e} of the prefill's logits (max |logit| "
          f"{scale:.3f}); decode step {first_s:.4f} s first, then "
          f"{[round(x, 5) for x in steps_s]} s (eager)")
    return dict(prefill_s=prefill_s, decode_s=steps_s,
                decode_vs_prefill=diff), launches


def launch_phase(torch, card, kernel_mods, granite_tokens, f32_ref, *,
                 with_b):
    """Phase 13, the launch layer: 13a, d, b (`with_b`: `--launch-only`)
    and c, in that order; returns the launches (13c's mesh ranks'
    included) and wavg at 13b's payload (None without 13b). The whole
    script leaves 13b out for its time, and runs 13c on the reduced
    model when it reaches 13c past CLI_FULL_BY_S (PERF.md section 4)."""
    t0 = time.perf_counter()
    a, launches_a, gen = launch_a(torch, kernel_mods, granite_tokens,
                                  f32_ref)
    serve, launches_d = launch_serve(torch, kernel_mods, gen)
    del gen
    gc.collect()
    torch.cuda.empty_cache()
    stamp("launch: 13a and 13d")
    e, launches_e = launch_dryrun(torch, kernel_mods, granite_tokens,
                                  a["replay_s"])
    stamp("launch: 13e")
    b, launches_b = None, {}
    if with_b:
        b, launches_b = launch_b(torch, kernel_mods, granite_tokens)
        b["reckoned"], b["reckon_s"] = reckon_launch_b()
        print(f"13e/13b: the dry run's reckoned peak for 13b's step (one "
              f"eager round, {b['layers']} layers, on the meta device, "
              f"{b['reckon_s']:.1f} s on the host) "
              f"{b['reckoned']['peak_bytes'] / 2**30:.2f} GiB against "
              f"13b's measured {b['peak_gib']:.2f} GiB (the fused chunk's "
              f"max_memory_allocated)")
        stamp("launch: 13b")
    directory = os.path.join(ROOT, "results", "torch", "launch")
    shutil.rmtree(directory, ignore_errors=True)
    # 13c at full size takes ~125 s; the whole script runs it there when
    # it starts by CLI_FULL_BY_S, else on the reduced model, so that a
    # slow host keeps the script within its 1,200 s (PERF.md section 4)
    elapsed = time.perf_counter() - T_START
    reduced = not with_b and elapsed > CLI_FULL_BY_S
    print(f"13c starts {elapsed:.1f} s into the script: mamba2-130m "
          f"{'reduced' if reduced else 'at full size'} (full size when it "
          f"starts by {CLI_FULL_BY_S:.0f} s)")
    cli, launches_c, ranks = launch_cli(torch, kernel_mods, directory,
                                        reduced)
    cli["reduced"] = reduced
    shutil.rmtree(directory, ignore_errors=True)
    stamp("launch: 13c")
    parts = [launches_a, launches_d, launches_e, launches_b, launches_c,
             ranks]
    launches = {name: sum(part.get(name, 0) for part in parts)
                for name in launches_a}
    print(f"launch phase on {card}: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"launch": dict(a=a, b=b, c=cli, d=serve, e=e,
                                     launches=launches)}, default=float))
    return launches, None if b is None else b["wavg"]


T_START = time.perf_counter()


def stamp(phase):
    """Seconds since the script started, at the end of a phase."""
    print(f"[{time.perf_counter() - T_START:7.1f} s] {phase} done")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--parent", metavar="DIR",
        help="after phase 3, time the flash_attn and trimmed_wavg kernels "
             "of the checkout in DIR (e.g. a `git archive` of the parent "
             "commit) beside this one's, and stop")
    parser.add_argument(
        "--allocator-ab", action="store_true",
        help="after phase 2, time host-driver rounds of the DCGAN and "
             "mamba2-130m with the caching allocator's expandable segments "
             "off and on, each in its own process, and stop")
    parser.add_argument("--host-rounds", action="store_true",
                        help=argparse.SUPPRESS)
    parser.add_argument(
        "--tp-only", action="store_true",
        help="after phase 2, run phase 10 alone (with its own tp=1 "
             "serving reference in place of phase 9a's), and stop")
    parser.add_argument(
        "--zoo-only", action="store_true",
        help="after phase 2, run phase 11 alone (with granite-3-2b's "
             "token data made for it), and stop")
    parser.add_argument(
        "--launch-only", action="store_true",
        help="after phase 2, check the flash_attn and ssd_scan kernels "
             "(phase 3's parts, their bfloat16 instances among them), run "
             "phase 13 alone (with granite-3-2b's token data made for "
             "it), and stop")
    parser.add_argument(
        "--conditioned-only", action="store_true",
        help="after phase 2, check the flash_attn kernel (phase 3's part), "
             "run phase 12 alone (with 448-token sequences of granite-3-2b's "
             "vocabulary made for it), and stop")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_arch_config
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.kernels.flash_attn import ref as flash_ref
    from repro_torch.kernels.ring_wavg import ops as ring_ops
    from repro_torch.kernels.robust_avg import ops as robust_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.kernels.wavg import ops
    from repro_torch.nn import ssm
    if args.host_rounds:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        host_rounds(torch)
        return 0

    # 1. device
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; allow_tf32 "
          f"matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    kernel_mods = (ops, robust_ops, ssd_ops, flash_ops, ring_ops)
    with concurrent.futures.ThreadPoolExecutor(len(kernel_mods)) as pool:
        list(pool.map(lambda m: m.build(), kernel_mods))
    print(f"built wavg, trimmed_wavg, ssd_scan, flash_attn and ring_accum in "
          f"{time.perf_counter() - t0:.2f} s")
    stamp("build")
    if args.tp_only:
        kernel_mods = {"wavg": ops, "trimmed_wavg": robust_ops,
                       "ssd_scan": ssd_ops, "flash_attn": flash_ops,
                       "ring_accum": ring_ops}
        inputs = tp1_serving_reference(torch, kernel_mods)
        stamp("tp=1 serving reference")
        shards = token_shards(TP_GRANITE, backbone_config(TP_GRANITE))[1]
        print(json.dumps({"tp_launches": tp_phase(
            torch, card, ops, flash_ops, flash_ref, shards, inputs)}))
        stamp("tensor parallelism")
        return 0
    if args.allocator_ab:
        allocator_ab(card)
        stamp("allocator A/B")
        return 0
    if args.zoo_only:
        kernel_mods = {"wavg": ops, "trimmed_wavg": robust_ops,
                       "ssd_scan": ssd_ops, "flash_attn": flash_ops,
                       "ring_accum": ring_ops}
        shards = token_shards(GRANITE, backbone_config(GRANITE))[1]
        print(json.dumps({"zoo_launches": zoo_phase(torch, card, kernel_mods,
                                                     shards)}))
        stamp("zoo")
        return 0
    if args.conditioned_only:
        kernel_mods = {"wavg": ops, "trimmed_wavg": robust_ops,
                       "ssd_scan": ssd_ops, "flash_attn": flash_ops,
                       "ring_accum": ring_ops}
        flash = check_flash(torch, flash_ops, flash_ref)
        stamp("kernels: flash_attn")
        shards = token_shards(COND_WHISPER, backbone_config(GRANITE))[1]
        launches = conditioned_phase(torch, card, kernel_mods, shards)
        flash["launches_by_path"] = {path: counts.get("flash_attn", 0)
                                     for path, counts in launches.items()}
        print(json.dumps({"conditioned_launches": launches,
                          "flash_attn": flash}, default=float))
        stamp("conditioned")
        return 0

    if args.launch_only:
        kernel_mods = {"wavg": ops, "trimmed_wavg": robust_ops,
                       "ssd_scan": ssd_ops, "flash_attn": flash_ops,
                       "ring_accum": ring_ops}
        ssd = check_ssd(torch, ssd_ops, ssd_ref, ssm)
        flash = check_flash(torch, flash_ops, flash_ref)
        stamp("kernels: ssd_scan and flash_attn")
        tokens = token_shards(GRANITE, backbone_config(GRANITE))[1]
        launches, wavg_launch = launch_phase(torch, card, kernel_mods,
                                             tokens, None, with_b=True)
        print(json.dumps({"launch_launches": launches, "wavg_launch_shape":
                          wavg_launch, "ssd_scan": ssd, "flash_attn": flash},
                         default=float))
        stamp("launch")
        return 0

    # 3. kernels
    wavg = check_wavg(torch, ops)
    trimmed = check_trimmed(torch, robust_ops)
    ssd = check_ssd(torch, ssd_ops, ssd_ref, ssm)
    flash = check_flash(torch, flash_ops, flash_ref)
    ring = check_ring_accum(torch, ring_ops)
    stamp("kernels")
    if args.parent:
        compare_with_parent(torch, args.parent, flash_ops, robust_ops)
        stamp("parent comparison")
        return 0

    # 4. small rounds, card vs CPU
    check_round_against_cpu(torch)
    check_faulted_rounds_against_cpu(torch)
    check_backbone_round_against_cpu(
        torch, ssd_ops, "ssd_scan", get_arch_config("mamba2-130m").reduced(),
        40)   # the last chunk of 16 padded
    check_backbone_round_against_cpu(
        torch, flash_ops, "flash_attn", dataclasses.replace(
            get_arch_config("granite-3-2b").reduced(), n_kv_heads=2),
        520)  # s * s past the flash threshold, 4 query heads a kv head
    check_small_mesh_rounds(torch)
    stamp("check")

    # 5. train: the protocol's path, the hostile-worker path, the mesh
    # path, then the backbone-GAN paths; 6. one profiled round after the
    # DCGAN's, mamba2-130m's and granite-3-2b's paths (each trainer is
    # freed before the next path). This process never runs the ring: its
    # ring_accum count stays 0.
    flash_ops.launches = ring_ops.launches = 0
    protocol_launches, trainer, setup, first_round = train(torch, ops,
                                                           robust_ops)
    hostile = train_hostile(torch, ops, robust_ops, *setup)
    stamp("train: DCGAN protocol and hostile paths")
    profile_round(torch, trainer, "DCGAN protocol")
    del trainer
    torch.cuda.empty_cache()
    stamp("profile: DCGAN")
    shards = setup[2]
    mesh = train_mesh(torch, shards, first_round)
    del setup
    import multiprocessing
    print(f"after the mesh path: {len(multiprocessing.active_children())} "
          f"child processes alive; host load average "
          f"{os.getloadavg()[0]:.2f} (1 min), {os.cpu_count()} cores")
    stamp("train: DCGAN mesh path")
    tokens = {}           # each backbone path's token shards, for phase 7
    mamba, backbone_trainer, tokens["mamba2"] = train_backbone(
        torch, ops, ssd_ops, "ssd_scan", MAMBA)
    stamp("train: mamba2-130m backbone path")
    # (its profiled round, 41-50 s of raw kineto records, was cut for
    # the script's time; PERF.md keeps its earlier readings)
    del backbone_trainer
    torch.cuda.empty_cache()
    if flash_ops.launches != 0:
        raise AssertionError("flash_attn launched on the DCGAN or mamba2 "
                             "paths")
    ssd_before = ssd_ops.launches
    granite, backbone_trainer, tokens["granite"] = train_backbone(
        torch, ops, flash_ops, "flash_attn", GRANITE)
    stamp("train: granite-3-2b backbone path")
    granite_profile = profile_round(torch, backbone_trainer,
                                    "granite-3-2b backbone-GAN",
                                    kernels=(GEMM_KERNELS, F32_GEMM_KERNELS))
    del backbone_trainer
    torch.cuda.empty_cache()
    stamp("profile: granite-3-2b")
    minitron, backbone_trainer, tokens["minitron"] = train_backbone(
        torch, ops, flash_ops, "flash_attn", MINITRON)
    del backbone_trainer
    torch.cuda.empty_cache()
    stamp("train: minitron-4b backbone path")
    gemma3 = check_gemma3(torch, flash_ops)
    stamp("train: gemma3-12b forward and backward")
    if robust_ops.launches != hostile["trimmed_wavg"]:
        raise AssertionError("trimmed_wavg launched on a backbone path")
    if ssd_ops.launches != ssd_before:
        raise AssertionError("ssd_scan launched on a dense path")
    if ring_ops.launches != 0:
        raise AssertionError("ring_accum launched outside the mesh path")
    by_path = {"wavg": {"protocol": protocol_launches,
                        "hostile": hostile["wavg"], "mesh": mesh["wavg"],
                        "mamba2": mamba["wavg"], "granite": granite["wavg"],
                        "minitron": minitron["wavg"]},
               "trimmed_wavg": {"hostile": hostile["trimmed_wavg"],
                                "mesh": mesh["trimmed_wavg"]},
               "ssd_scan": {"mamba2": mamba["ssd_scan"]},
               "flash_attn": {"granite": granite["flash_attn"],
                              "minitron": minitron["flash_attn"],
                              "gemma3": gemma3["flash_attn"]},
               "ring_accum": {"mesh": mesh["ring_accum"]}}
    for entry in (wavg, trimmed, ssd, flash, ring):
        paths = {"protocol": 0, "hostile": 0, "mesh": 0, "mamba2": 0,
                 "granite": 0, "minitron": 0, "gemma3": 0,
                 **by_path[entry["name"]]}
        entry["launches"] = sum(paths.values())
        entry["launches_by_path"] = paths

    # 7. fused: the fused driver against the host driver
    fused_results, host_records = train_fused(torch, shards, card, tokens)
    stamp("fused")

    # 8. experiments: resume, centralized and microbatched rounds, the
    # quickstart twin and the figures (the "experiments" path), then the
    # mesh figures and mamba2-130m on the mesh (the "mesh_experiments"
    # path, launches summed over the ranks)
    experiments = train_experiments(torch, shards, card, ops, robust_ops,
                                    tokens["mamba2"],
                                    host_records["mamba2-130m"])
    for entry in (wavg, trimmed, ssd, flash, ring):
        for path in ("experiments", "mesh_experiments"):
            n = experiments[path].get(entry["name"], 0)
            entry["launches_by_path"][path] = n
            entry["launches"] += n
    stamp("experiments")

    # 9. serving: the engine, its front end and the serve CLI on
    # granite-3-2b, mamba2-130m (phase 7's host-trained generator) and
    # gemma3-12b; the mode="prefill" calls' launches form the path's
    kernel_mods = {"wavg": ops, "trimmed_wavg": robust_ops,
                   "ssd_scan": ssd_ops, "flash_attn": flash_ops,
                   "ring_accum": ring_ops}
    serving, serving_inputs = serve_phase(
        torch, card, kernel_mods, host_records.pop("mamba2-130m generator"))
    for entry in (wavg, trimmed, ssd, flash, ring):
        n = serving.get(entry["name"], 0)
        entry["launches_by_path"]["serving"] = n
        entry["launches"] += n
    stamp("serving")

    # 10. tensor parallelism: the MLP-GAN and granite-3-2b on TP=2 gloo
    # ranks against their tp=1 runs, and 9a's greedy requests served at
    # tp=2 (the "tp" path: 10a's and 10b's launches, over the ranks)
    tp = tp_phase(torch, card, ops, flash_ops, flash_ref,
                  tokens["granite"][:TP_GRANITE["k"]], serving_inputs)
    for entry in (wavg, trimmed, ssd, flash, ring):
        n = tp.get(entry["name"], 0)
        entry["launches_by_path"]["tp"] = n
        entry["launches"] += n
    stamp("tensor parallelism")

    # 11. the zoo: granite-moe-3b-a800m and zamba2-2.7b through both
    # drivers, mixtral-8x22b's layer forward and backward, both
    # generators served at full depth (11d's mode="prefill" calls join
    # the "serving" path)
    zoo = zoo_phase(torch, card, kernel_mods, tokens["granite"])
    for entry in (wavg, trimmed, ssd, flash, ring):
        for path in ("moe", "hybrid", "mixtral"):
            n = zoo[path].get(entry["name"], 0)
            entry["launches_by_path"][path] = n
            entry["launches"] += n
        n = zoo["serving"].get(entry["name"], 0)
        entry["launches_by_path"]["serving"] += n
        entry["launches"] += n
    stamp("zoo")

    # 12. the conditioned families: whisper-base through both drivers at
    # full depth, llama-3.2-vision-90b's group forward and backward, both
    # generators served with their cross caches (12c's mode="prefill"
    # calls join the "serving" path), the train_distgan twin
    import numpy as np
    whisper_shards = np.ascontiguousarray(
        tokens["granite"][:COND_WHISPER["k"], :, :COND_WHISPER["seq"]])
    cond = conditioned_phase(torch, card, kernel_mods, whisper_shards)
    for entry in (wavg, trimmed, ssd, flash, ring):
        for path in ("encdec", "vlm"):
            n = cond[path].get(entry["name"], 0)
            entry["launches_by_path"][path] = n
            entry["launches"] += n
        n = cond["serving"].get(entry["name"], 0)
        entry["launches_by_path"]["serving"] += n
        entry["launches"] += n
    stamp("conditioned")

    # 13. the launch layer: launch/steps.py's train step in the launch
    # step's bfloat16 on granite-3-2b (phase 5d's protocol beside its
    # float32 round; the launch protocol at depth), the CLI on
    # mamba2-130m (resume, the mesh ring), the prefill and decode steps
    granite_f32 = fused_results["granite-3-2b"]
    launch, _ = launch_phase(
        torch, card, kernel_mods, tokens["granite"],
        dict(profile=granite_profile, host_s=granite_f32["host_s"],
             replay_s=granite_f32["fused_s"][1:]), with_b=False)
    for entry in (wavg, trimmed, ssd, flash, ring):
        n = launch.get(entry["name"], 0)
        entry["launches_by_path"]["launch"] = n
        entry["launches"] += n
    stamp("launch")

    print(json.dumps({"kernels": [wavg, trimmed, ssd, flash, ring]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
