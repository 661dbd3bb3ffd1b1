"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line on stdout (logs go to stderr):

  1. build    compile every CUDA kernel from the sources in this checkout
              (one nvcc per source, started together) into build/kernels/
  2. k1       the fused EF + segmented top-k sweep kernel against its plain
              PyTorch version on the same inputs, bitwise, at llama3.2-1b's
              full-width flat-gradient layout (4 layers): alpha = 0.001,
              where "auto" resolves the bitonic rule (128Ki blocks), and
              alpha = 0.0001, where it resolves the loop rule; and at
              alpha = 0.001 on a special-values input (a third of g, u, v
              NaNs of several payloads, +-inf, +-0, subnormals), every
              output compared as bits
  3. k6       the block top-k kernel against its plain version, bitwise,
              at each per-leaf block shape that select_topk(backend=
              "pallas") gives that layout (alpha = 0.001), and at the
              MLP leaves' shape on a ties-heavy input (x rounded to 2^-10
              steps); and ops.global_topk on the card against the
              torch.topk leaf selection, bitwise, for one leaf of each
              shape
  4. k2       the segmented sweep kernel against its plain version,
              bitwise, at that layout under both block rules and on the
              special-values input, as k1; then
              its path: select_topk(v, layout, backend="fused") with the
              launch counts reset before and read after, equal to
              backend="jnp" bitwise
  5. k3       the fused matmul + bias + LeakyReLU kernel against its plain
              version at the AE encoder's five im2col shapes for that
              layout's mu_pad, within |err| <= 1e-5 * max(1, max|y|); the
              route (3xTF32 on the tensor cores) and two bounds
  6. k7       the threshold EF pass against its plain version, bitwise on
              all three outputs (compared slice by slice), at the main
              path's flat gradient (n = 505,956,352; g ~ N(0,1), u ~
              0.1·N(0,1), v ~ 0.3·N(0,1)) with tau the sampled threshold
              of v' for k = mu; its path, ops.estimate_threshold +
              ops.sparsify_ef, with the launch counts reset before and
              read after; and the device ms of the exact-FMA
              momentum_correct (the dgc --topk-backend pallas accumulate)
  7. bitpack  the packed wire's kernels (K4 quantize_pack, K5a pack_bits,
              K5b unpack_bits) against their plain versions, bitwise, at
              the path's shapes (the topk / support PackPlan of that
              layout: 243296 pairs, 16 low bits, 7603 words per plane) and
              at edge cases (k from 1 to two tiles, widths 1 to 31, zero
              and all-ones values; K5a at every width on values with the
              bits above the width set; NaN/Inf, all-zero blocks and .5
              ties at scale blocks 1, 64, 256 and 1000 for K4), K5b also
              on a stack of two payloads; then the codec on the card
              against the CPU, and on a gathered table of two payloads
  8. flash    flash attention (models/flash.py: online softmax over
              chunks, recompute backward; plain PyTorch, as the
              reference's is plain jnp) at one layer of llama3.2-1b (B 1,
              S 2048, 32/8 heads, head_dim 64, f32), causal with window 0
              and 512: the output and dq, dk, dv on the card against the
              CPU within FLASH_REL of their largest entry, device ms of a
              forward and of a forward + backward; the peak of one
              forward + backward at S 8192 beside the 8 GiB one (1, 32,
              S, S) f32 score matrix would take
  8b. moe     layers.moe_fwd (plain PyTorch, as the reference's is plain
              jnp) at arctic-480b's widths (d_model 7168, d_ff_expert
              4864, the dense residual), experts cut to 8, f32, 1024
              tokens, capacity (G = 32, C = 10) and dropless: the output,
              the aux loss and every gradient on the card against the CPU
              within MOE_REL; device ms of a forward and a forward +
              backward
  8c. ssd     models/mamba2.py at mamba2-130m's width: ssd_chunked and
              mamba_fwd at S 2048 and 4097 (the padded chunk plan), the
              output within SSD_REL and every gradient within
              SSD_GRAD_REL of the CPU's; device ms
  8d. mla     layers.mla_fwd (the expanded form: flash over q, k of width
              192 and v of 128) at deepseek-v3-671b's geometry, f32,
              batch 2, S 512 and 1025 (padded chunks): the output, the
              cache (c_kv, k_rope) and every gradient on the card against
              the CPU within MLA_REL / MLA_GRAD_REL; device ms; then 3
              absorbed decode steps (mla_decode) after a 512-token prefill
              against the expanded form over 515 tokens (MLA_DECODE_REL)
  8e. cross   cross_attention_kv and cross_attention_fwd at
              llama-3.2-vision-90b's widths (1601 encoder tokens of 1280,
              padded to 2048 keys), f32, batch 2, S 512, the gate at 0.5:
              the output and every gradient (the gate's, the embeddings')
              on the card against the CPU within CROSS_REL /
              CROSS_GRAD_REL; device ms; a bf16 call with f32 embeddings
              must give k, v in f32 and the output in bf16
  9. train    repro_torch.launch.train's run(): llama3.2-1b at published
              widths (d_model 2048, 32/8 heads, d_ff 8192, vocab 128256,
              bf16) with n_layers cut from 16 to 4, K=2 nodes on this card,
              eight runs: lgc_rar with the fused sweep and the kernel
              encoder, 6 steps through all three phases, on the mesh wire
              and on the packed ring (--transport ring_packed: the support
              set through K5a/K5b); dgc with the block top-k
              (--topk-backend pallas) on the mesh wire and on the packed
              ring (each node's pairs through K4, the gathered table of
              the K payloads through one K5b launch: every node holds the
              same table, so one decode serves all), and sparse_gd with
              the fused sweep (momentum off), each 2 warm-up + 3
              sparsified steps; lgc_ps on the
              mesh wire and on the packed ring (each node's innovations
              through K4, their gathered table through one K5b) and
              lgc_rar_q8 on the int8 ring (--transport ring_q8), each 6
              steps as lgc_rar; then the bucketed wire (--wire-buckets 4):
              lgc_rar_q8 on ring_q8, and dgc on ring_packed (each node's
              pairs in 4 buckets through 4 K4 launches, the gathered table
              of the 8 payloads through one K5b); and lgc_rar with K = 4
              nodes on a 2 x 2 (pod x data) mesh over the hierarchical ring
              (--transport ring_hier --pod-shards 2), unbucketed with the
              garbage collector off (its peak held under a stated bound:
              a tensor kept alive by a reference cycle raises it) and in
              4 buckets, whose losses must be equal; then lgc_rar at
              train_4k's sequence length (--seq 4096, batch 8: train_4k's
              256 cut to 4 sequences a node), 6 steps; then lgc_rar (K1
              and K3 counted per step) on mamba2-130m at full width and
              depth (24 layers, bf16, the SSM's leaves) at seq 128 and
              4096, and on arctic-480b at published widths with n_layers
              cut from 35 to 1 and num_experts from 128 to 4 (the 3-D
              expert stacks; G = 32, C = 10), 6 steps each; then lgc_rar
              on deepseek-v3-671b at published widths (the MLA leaves,
              the shared expert, the MTP subtree) cut to 1 layer, 4
              experts of top-2 and vocab 8192 (its MTP loss finite every
              step), and on llama-3.2-vision-90b at reduced() (the
              cross layers' gates, the encoder stream on the card).
              Every block and
              cross-entropy chunk is rematerialised.  Each
              run resets the launch counts before and reads them after;
              launch counts per phase, finite losses and per-op
              wire-byte rows (priced for the run's own transport, mesh
              and bucket count) are checked
  9b. pg_train one node per process: repro_torch.launch.train under
              torchrun (this script as each rank, --pg-rank), the K
              processes sharing this card over a gloo process group
              (every message staged through pinned host memory), each
              against its emulated twin of the same flags among the train
              runs: lgc_rar on mesh (K = 2), dgc on ring_packed in 4
              buckets (K = 2), lgc_rar_q8 on ring_q8 (K = 2), lgc_rar on
              ring_hier over 2 pods x 2 (K = 4, at PG_HIER_LAYERS with
              its twin cut the same); every rank's per-step losses
              bitwise the twin's, its per-op wire rows (the nodes' mean
              of the bytes each rank handed to its sends) equal to the
              twin's and the pricer's, the digest of its final params
              and AE equal to every other rank's and the twin's; each
              rank's kernel launches per step, step ms per phase beside
              the twin's, and peak GiB.  A rank that fails fails the
              launch, and the phase raises
 10. guard    the chaos wire under the guard policies: (a) dgc on
              chaos:ring_packed with the checksum word, --guard scrub and
              2 bit flips, 2 NaNs and 1 inf on its top-k exchange each
              step: the fault tally, fault/topk >= 3 and guard_ok = 0 on
              every sparsified step, +4 bytes per payload, and the
              composed encode (K5a per node, no K4: K4 cannot count the
              non-finites it zeroes); (b) lgc_rar_q8 on chaos:ring_q8
              with --guard skip_round and a NaN on its encoding: every
              compressed step guard_ok = 0, and one compressed step of
              the run's compressor driven directly gives a zero gradient
              and leaves each node's u, v its accumulators before the
              clear; (c) lgc_rar on chaos:mesh with --guard fail_fast
              must raise WireFaultError naming the encoding at step 4
 11. resume   lgc_rar with a checkpoint every 3 steps, stopped after step
              3, then resumed from the file (the full state: bf16
              params, AdamW moments, both nodes' u and v, the AE): its
              losses at steps 4 and 5 must equal the uninterrupted
              lgc_rar run's bit for bit; the file's bytes and the save
              and load seconds; the file is deleted
 12. convnet5 the paper's ConvNet5 at its full widths (config(): channels
              32-256, 200 classes, 32x32 images, n = 588,008), K = 4 nodes
              of 8 images, through launch.steps.sim_sgd_step (the
              reference's single-host loop: per-node gradients, sim_step,
              p - lr g): first K1 (alpha = 0.05), K6 (every leaf shape of
              alpha = 0.01), K3 (mu_pad 26,784 and 544), and K4, K5a and
              K5b (every PackPlan of the two ring_packed runs) against
              their plain versions at its shapes; then lgc_rar (fused sweep,
              kernel encoder, mesh; alpha = 0.05, 10 warm-up + 20 AE
              steps of 120, lr 0.08), its 10 warm-up steps held against
              the same code on the CPU (CONVNET_GRAD_REL on one step's
              gradients, CONVNET_TRAJ_REL on the trajectory); lgc_ps on
              ring_packed (alpha = 0.05, innovation 0.005, 60 steps, lr
              0.05); dgc with the block top-k on ring_packed (alpha =
              0.01, 10 warm-up of 60 steps, lr 0.05), each checked as the
              train runs are (launches per step, finite losses, wire rows
              the pricer's), with the steady step ms per phase, the loss
              and accuracy of the first and last 15 steps; and the
              information plane's MI fraction per layer after 10 SGD steps
              (examples.information_plane.mi_fractions at config())
 13. serve    repro_torch.launch.serve's run() on llama3.2-1b at published
              widths and all 16 layers, bf16: batch 4, prompt 64, gen 32
              (the entry point's defaults, after one run of them that
              pays the one-off set-up) and batch 8, prompt 512, gen 64;
              decoding from the cache equals a full prefill's last-token
              logits at three positions of each within SERVE_REL; prefill
              ms, median decode ms per step, tokens/s (decoded tokens over
              the decode loop's time), peak GiB; one
              profiled decode step; a prefill alone at batch 4, prompt
              4096, and one at batch 1, prompt 32768 (prefill_32k's length,
              its batch of 32 cut to 1), then 8 decode steps from its
              cache, the first against a full prefill of length 32769;
              then qwen2-1.5b (28 layers) as llama3.2-1b (B4 P64 G32, B8
              P512 G64, three positions each), and granite-8b (36 layers),
              phi3-medium-14b (40) and musicgen-medium (48) at B4 P64 G16
              with the check at one position, each at published widths
              and full depth, bf16, freed before the next; then
              mamba2-130m at full depth as llama3.2-1b (B4 P64 G32, B8
              P512 G64, the check held), and a batch-1 prompt of 32768
              with 8 decode steps from its O(1) state against a 32769
              prefill; arctic-480b cut to 2 layers (B4 P64 G16, B8 P512
              G16: G = 32, C = 2) and jamba-v0.1-52b cut to one
              superblock (8 layers, B4 P64 G16), decode vs prefill
              printed, not held (the prefill's capacity drops tokens);
              then arctic at 1 layer and jamba at one superblock in f32
              at capacity_factor = E / K, decode vs a full prefill held
              to SERVE_F32_REL; then deepseek-v3-671b at 1 layer with
              its MTP block (all 256 experts; B4 P64 G16, B8 P512 G16,
              and B1 P32768 decoding from the latent cache against a
              32769 prefill, printed, not held: capacity drops) and
              llama-3.2-vision-90b at 2 superblocks with its gates at 0.5
              (B4 P64 G16, B8 P512 G16, held to SERVE_REL); f32 at
              capacity_factor = E / K: deepseek at 1 layer and 32
              experts, vision at one superblock
 14. timings  each kernel's ms beside its plain version's, its bound and,
              where there is one, one PyTorch call computing the same
              function (K6 and K3 also per shape, with their ratio to it);
              K4, K5a and K5b (one payload and the two-payload table) also
              as device_ms (200 calls in one CUDA graph) and host_us (the
              wrapper's host time per call)

then the kernel list, the card's name and power limit, and on the last
line {"ok": true, "device": {...}}.  Any failed check raises: the script
exits non-zero and prints no result.  Without a CUDA device it refuses.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import subprocess
import sys
import time

# one allocator segment per block would strand gigabytes between phases
# of other shapes: arctic's 1.10B-parameter run needs ~72 GiB of the
# card's 79 and failed with 14 GiB reserved but unallocated.  Read when
# CUDA starts, so set before anything touches the card
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import torch  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
F32_FLOPS = 67e12                  # H100 SXM f32 outside the tensor cores
TF32_FLOPS = 495e12                # H100 SXM TF32 tensor cores, dense
N_LAYERS = 4                       # the only cut: 16 -> 4 layers
# the K = 4 process run (lgc_rar ring_hier, 2 pods x 2) and its twin:
# four processes on the one card each hold their own params, AdamW
# moments, u, v and gradients, and ~2.6 GiB outside the allocator (its
# context and libraries).  One K = 2 rank at 4 layers peaks at 23.67 GiB;
# at 2 layers the four ranks ran out of the card (16.35 GiB allocated
# each, 76.9 of 79.18 GiB in use)
PG_HIER_LAYERS = 1
PG_BACKEND = "gloo"                # the only backend for K ranks on a card
PG_TIMEOUT_S = 600                 # one torchrun launch
# lgc_rar ring_hier's peak at K = 4 with the garbage collector off,
# 45.49 GiB on the H100, plus 1 GiB: less than one n-sized f32 tensor
# (1.88 GiB) kept alive by a reference cycle
HIER_PEAK_GIB = 46.5
CONVNET_K = 4                      # nodes of the ConvNet5 runs
CONVNET_PER_NODE = 8               # images a node takes per step
# the card's warm-up steps against the same port code on the CPU.  One
# step from the same weights and images: the per-node gradients to 1e-5
# of their largest entry, the CPU tests' tolerance against the reference
# (f32 sums in another order: cuDNN's convolution algorithms, the card's
# reductions).  The 10-step trajectory: losses (relative) and weights (of
# the largest) to 2.5e-4, about 3x the largest reading, since SGD through
# batch-norm grows each step's rounding differences (on an NVIDIA H100
# 80GB HBM3, 700 W: 3.0e-6 in one step's gradients became 4.2e-5 to
# 8.0e-5 in the weights after 10 steps; losses 1.8e-7 to 1.4e-6)
CONVNET_GRAD_REL = 1e-5
CONVNET_TRAJ_REL = 2.5e-4
# decode from the cache against a full prefill, bf16: each keeps 8
# significant bits (a step of 2^-8 = 0.4% of a value); the prefill's and
# the decode's matmuls round at other shapes, so single bf16 steps differ
# and 16 layers carry them on to the logits.  0.05 of the largest logit is
# ~12 such steps of it
SERVE_REL = 0.05
# the prompt of the first prefill alone, at batch 4: (4, 32, S, S) f32
# scores would be 8.6 GB a layer, and the full-matrix attention the port
# had before flash took 27.46 GiB for it
SERVE_LONG_PROMPT = 4096
# the reference's prefill_32k length (its batch of 32 cut to 1), prefilled
# alone; decoding from its cache is held against a full prefill at length
# 32769, which the reference's chunk rule would cut into 1-row chunks
PREFILL_32K = 32768
PREFILL_32K_DECODE = 8               # decode steps from its cache
# flash attention on the card against the same function on the CPU, at
# one layer of llama3.2-1b (B, S, H, KH, D; f32): the output and dq, dk,
# dv within FLASH_REL of each one's largest entry (f32 sums in another
# order: the card's matmuls), and the peak of one forward + backward at
# FLASH_PEAK_SEQ against the one (B, H, S, S) f32 score matrix it avoids
FLASH_SHAPE = (1, 2048, 32, 8, 64)
FLASH_WINDOWS = (0, 512)
FLASH_REL = 1e-5
FLASH_PEAK_SEQ = 8192
# train_4k's sequence length; its batch of 256 cut to 8 (4 a node)
TRAIN_SEQ = 4096
# the archs served besides llama3.2-1b, at published widths and full
# depth, bf16: (batch, prompt, gen, decode-vs-prefill positions) each
SERVE_ARCHS = (("qwen2-1.5b", ((4, 64, 32, 3), (8, 512, 64, 3))),
               ("granite-8b", ((4, 64, 16, 1),)),
               ("phi3-medium-14b", ((4, 64, 16, 1),)),
               ("musicgen-medium", ((4, 64, 16, 1),)))
# moe_fwd on the card against the CPU: arctic-480b's published widths
# with its 128 experts cut to 8, f32, (B, S) = 2 x 512 tokens: the
# output, the aux loss and every gradient within MOE_REL of their
# largest entry (f32 sums in another order).  The experts draw with the
# reference's std 1/sqrt(E), so the gate's pre-activations reach ~30 and
# w_gate's gradient is the least exact: one f32 evaluation lies 7.1e-6
# of its largest entry from an f64 one at 128 tokens (every other output
# <= 1.2e-6; tools/f32_floor.py moe, on the CPU), and the card against
# the CPU gave 1.39e-5 at these 1024 (NVIDIA H100 80GB HBM3, 700.00 W)
MOE_EXPERTS = 8
MOE_TOKENS = (2, 512)
MOE_REL = 5e-5
# ssd_chunked and mamba_fwd on the card against the CPU at mamba2-130m's
# width, f32.  One f32 evaluation of the chunked scan lies from an f64
# one by up to 2.0e-5 of the largest output entry and 9.7e-5 of the
# largest gradient entry at these lengths (the decay's exp of
# differences of cumulative sums; tools/f32_floor.py ssd, on the
# CPU), so two f32 evaluations are held to ~5x and ~10x that
SSD_LENGTHS = (2048, 4097)
SSD_REL = 1e-4
SSD_GRAD_REL = 1e-3
# arctic-480b trained at published widths with n_layers cut from 35 to 1
# and num_experts from 128 to 4 (~1.10B parameters); served bf16 at 2
# layers (~27.7B parameters, 55.4 GB)
ARCTIC_TRAIN_EXPERTS = 4
ARCTIC_SERVE_LAYERS = 2
# decode vs a full prefill in f32 (TF32 off) at capacity_factor = E / K,
# where the prefill drops no token: the dropless decode and the no-drop
# capacity path, the recurrent and the chunked SSM, sum in another order;
# the chunked scan's f32 floor is ~2e-5 of its output (above), and the
# stack carries it to the logits
SERVE_F32_REL = 1e-3
# latent attention (layers.mla_fwd, mla_decode) on the card against the
# CPU at deepseek-v3-671b's geometry (d_model 7168, 128 heads, q_lora
# 1536, kv_lora 512, nope 128, rope 64, v 128), f32, batch MLA_BATCH, at
# each of MLA_LENGTHS (1025: the reference's chunks would be 1 row, the
# port pads): the output and the cache within MLA_REL, every gradient
# within MLA_GRAD_REL of its largest entry; then 3 absorbed decode steps
# after a prefill of MLA_LENGTHS[0] tokens on the card, against the
# expanded form over the longer prompt within MLA_DECODE_REL.  The gates
# are about 10x the f32 floor (tools/f32_floor.py mla --device cuda: one
# f32 evaluation against an f64 one; NVIDIA H100 80GB HBM3, 700.00 W):
# <= 1.72e-6 on the output and cache, <= 3.71e-6 on the gradients, and
# 1.6e-6 + 1.3e-7 for the expanded and the absorbed forms' outputs
MLA_BATCH = 2
MLA_LENGTHS = (512, 1025)
MLA_REL = 2e-5
MLA_GRAD_REL = 4e-5
MLA_DECODE_REL = 2e-5
# cross-attention on the card against the CPU at llama-3.2-vision-90b's
# widths (d_model 8192, 64 / 8 heads of 128, 1601 encoder tokens of
# 1280), f32, (batch, queries) = CROSS_SHAPE, the tanh gate at
# CROSS_GATE (at its initial 0 the layer adds nothing and its weights'
# gradients are 0): the output within CROSS_REL, every gradient (the
# gate's and the embeddings' included) within CROSS_GRAD_REL: about 10x
# the f32 floor as MLA's (tools/f32_floor.py cross --device cuda, same
# card: 1.15e-7 on the output, which the residual x dominates, and <=
# 3.15e-6 on the gradients)
CROSS_SHAPE = (2, 512)
CROSS_GATE = 0.5
CROSS_REL = 2e-6
CROSS_GRAD_REL = 3e-5
# deepseek-v3-671b served bf16 at 1 layer with its MTP block (every
# width, all 256 experts, top-8, the shared expert: 24,970,726,400
# parameters), and in f32 at 1 layer with num_experts cut to
# DEEPSEEK_F32_EXPERTS (5,237,509,120); trained at 1 layer with
# num_experts and top_k cut to 4 and 2 (arctic's cut) and the vocab to
# DEEPSEEK_TRAIN_VOCAB (1,034,939,392 parameters: the embedding and
# lm_head alone are 1.85B at the published vocab, which no card's K = 2
# emulation holds at ~69 B a parameter)
DEEPSEEK_SERVE_LAYERS = 1
DEEPSEEK_F32_EXPERTS = 32
DEEPSEEK_TRAIN_EXPERTS = (4, 2)
DEEPSEEK_TRAIN_VOCAB = 8192
# llama-3.2-vision-90b served bf16 at 2 superblocks (10 layers,
# 10,629,586,946 parameters: a wrong block index into the stacked cross
# cache would show), in f32 at one superblock; trained at reduced()
VISION_SERVE_LAYERS = 10


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device ms of fn() over ``reps`` runs after one warm-up."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device ms of fn() over ``reps`` calls captured in one CUDA
    graph and replayed: the kernels' own time, without the host's work
    between launches (the wrappers launch on the current stream, which
    is the capture stream)."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int) -> float:
    """Mean host us of fn() over ``reps`` calls with no synchronise
    between them, after a warm-up: what the wrapper costs the host."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / reps * 1e6


def build_phase(card: str):
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    report = build.build_all()
    emit("build", card=card, seconds=time.perf_counter() - t0,
         nvcc={k: v["seconds"] for k, v in report.items()},
         ptxas={k: v["ptxas"] for k, v in report.items()})


def llama_layout(sparsity: float):
    from repro_torch.configs import get_arch
    from repro_torch.core import sparsify as SP
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(get_arch("llama3.2-1b"), n_layers=N_LAYERS)
    meta = build_model(cfg).init(torch.Generator(), "meta")
    return SP.build_layout(meta, sparsity)


# bit patterns of the special-values inputs: NaNs of several payloads and
# signs, +-inf, +-0.0, subnormals
SPECIAL_BITS = (0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFFFFFFF, 0x7F800000,
                0xFF800000, 0x00000000, 0x80000000, 0x00000001, 0x80000001,
                0x00012345, 0x807FFFFF)


def special_values(n: int, gen, dev):
    """1e-3 N(0,1) with a third of the values replaced by special ones."""
    x = torch.randn(n, generator=gen, device=dev) * 1e-3
    at = torch.rand(n, generator=gen, device=dev) < 1 / 3
    bits = torch.tensor([b - (1 << 32) if b >> 31 else b
                         for b in SPECIAL_BITS], dtype=torch.int32,
                        device=dev)
    pick = torch.randint(0, len(SPECIAL_BITS), (n,), generator=gen,
                         device=dev, dtype=torch.int32)
    special = bits.index_select(0, pick).view(torch.float32)
    return torch.where(at, special, x)


def same_bits(a, b) -> bool:
    """Equal as bits (f32 through int32 views: NaN payloads, +-0.0)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def sweep_scratch_bytes(active, block: int) -> int:
    """The sweep kernels' radix scratch: 12 B per element of each active
    block (a 64-bit and a 32-bit word)."""
    return (int(active.max()) + 1) * block * 12


def k1_phase(dev):
    """Kernel vs plain, bitwise, at both block rules, and on the
    special-values input at alpha = 0.001 (the main path's layout), where
    it is also timed."""
    from repro_torch.core import sparsify as SP
    from repro_torch.kernels import sparsify_ef as EF
    roles = (SP.ROLE_COMPRESSED, SP.ROLE_TOPK_ONLY)
    gen = torch.Generator(device=dev).manual_seed(0)
    timing = None
    for sparsity, rule, kind in ((0.001, "bitonic", "normal"),
                                 (0.001, "bitonic", "special"),
                                 (0.0001, "loop", "normal")):
        layout = llama_layout(sparsity)
        ex, block, seg, kcap, n_cand, _ = SP._fused_meta(layout, roles,
                                                         "auto")
        assert ex == rule, (sparsity, ex)
        n = layout.n_total
        if kind == "special":
            g, u, v = (special_values(n, gen, dev) for _ in range(3))
        else:
            g, u, v = (torch.randn(n, generator=gen, device=dev) * 1e-3
                       for _ in range(3))
        seg_t = torch.from_numpy(seg).to(dev)
        kcap_t = torch.from_numpy(kcap).to(dev)
        active = EF.active_blocks(seg_t, block)
        args = (g, u, v, seg_t, kcap_t, 0.9, True, n_cand, block)
        out_k = EF.sparsify_ef_topk(*args, active=active)
        torch.cuda.synchronize()
        out_p = EF.sparsify_ef_topk_plain(*args)
        names = ("u", "v", "cand_vals", "cand_idx", "cand_seg")
        equal = {nm: same_bits(a, b)
                 for nm, a, b in zip(names, out_k, out_p)}
        # u' NaN payloads aside: the card's FMA gives its canonical NaN,
        # the plain version's exact FMA (f64 operations) another NaN
        nan = out_k[0].isnan()
        equal["u"] = bool(torch.equal(nan, out_p[0].isnan())) and \
            same_bits(out_k[0][~nan], out_p[0][~nan])
        err = max(float((a.float() - b.float()).abs().nan_to_num(0.0).max())
                  for a, b in zip(out_k, out_p))
        kept = int((out_k[4] >= 0).sum())
        emit("k1" if kind == "normal" else "k1_special", extract=ex,
             block=block, n=n, n_cand=n_cand,
             n_blocks=out_k[2].numel() // n_cand, kept=kept,
             bitwise=equal, max_abs_err=err)
        if not all(equal.values()):
            raise AssertionError(f"fused_ef_topk differs from its plain "
                                 f"version at {ex} on {kind} input: "
                                 f"{equal}")
        if timing is None:
            del out_k, out_p
            ms = cuda_ms(lambda: EF.sparsify_ef_topk(*args, active=active), 3)
            plain_ms = cuda_ms(lambda: EF.sparsify_ef_topk_plain(*args), 1)
            pool = (-(-n // block)) * n_cand
            nbytes = n * (4 * 3 + 4) + n * 4 * 2 + pool * 12
            timing = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
                      "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S
                      * 1e3, "bound_by": "bytes", "library_ms": None,
                      "scratch_bytes": sweep_scratch_bytes(active, block),
                      "block": block, "n": n, "n_cand": n_cand}
        del g, u, v, seg_t, active, args
        torch.cuda.empty_cache()
    return timing


def pallas_shapes(layout):
    """{(n_blocks, block, kb): [leaves]}: the block top-k launches that
    the pallas backend makes for ``layout``, one per compressed and
    top-k-only leaf (select_topk, select_topk_last)."""
    from repro_torch.core import sparsify as SP
    shapes = {}
    for leaf in layout.compressed + layout.topk_only:
        block = SP.pallas_block(leaf.k)
        key = (-(-leaf.size // block), block, min(leaf.k, block))
        shapes.setdefault(key, []).append(leaf)
    return shapes


def k6_phase(dev):
    """Kernel vs plain, bitwise, at every leaf shape of the main path's
    layout, and global_topk vs the torch.topk leaf selection; at the MLP
    leaves' shape also on a ties-heavy input (x rounded to 2^-10 steps, so
    the stable order decides most of each block); times per shape and
    summed over the leaves, each beside torch.topk's."""
    import torch.nn.functional as F
    from repro_torch.core import sparsify as SP
    from repro_torch.kernels import block_topk as BT
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(6)
    shapes, err = [], 0.0
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for (nb, block, kb), leaves in sorted(pallas_shapes(
            llama_layout(0.001)).items()):
        leaf, count = leaves[0], len(leaves)
        x = torch.randn(leaf.size, generator=gen, device=dev) * 1e-3
        xb = F.pad(x, (0, nb * block - leaf.size)).view(nb, block)
        out = BT.block_topk(xb, kb)
        torch.cuda.synchronize()
        plain = BT.block_topk_plain(xb, kb)
        equal = all(torch.equal(a, b) for a, b in zip(out, plain))
        e = float((out[0] - plain[0]).abs().max())
        gv, gi = ops.global_topk(x, leaf.k, block=block)
        lv, li = SP._leaf_topk(x, leaf.k, 0)
        global_equal = torch.equal(gv, lv) and torch.equal(gi.long(), li)
        emit("k6", leaf=leaf.path, size=leaf.size, k=leaf.k, n_blocks=nb,
             block=block, kb=kb, leaves=count, bitwise=equal,
             global_topk_bitwise=global_equal, max_abs_err=e)
        if not (equal and global_equal):
            raise AssertionError(f"block_topk differs at {(nb, block, kb)}: "
                                 f"kernel {equal}, global {global_equal}")
        err = max(err, e)
        del out, plain, gv, gi, lv, li
        if block == max(b for _, b, _ in pallas_shapes(
                llama_layout(0.001))):
            ties = torch.round(xb * 1024.0) / 1024.0
            out, plain = BT.block_topk(ties, kb), BT.block_topk_plain(ties, kb)
            distinct = torch.unique(ties[0].abs()).numel()
            equal = all(torch.equal(a, b) for a, b in zip(out, plain))
            emit("k6_ties", n_blocks=nb, block=block, kb=kb, step=2 ** -10,
                 distinct_magnitudes_in_block_0=distinct, bitwise=equal)
            if not equal:
                raise AssertionError(f"block_topk differs on the ties-heavy "
                                     f"input at {(nb, block, kb)}")
            del ties, out, plain
        mag = xb.abs()
        t = {"ms": cuda_ms(lambda: BT.block_topk(xb, kb), 3),
             "plain_ms": cuda_ms(lambda: BT.block_topk_plain(xb, kb), 1),
             "library_ms": cuda_ms(lambda: torch.topk(mag, kb, dim=1), 1),
             "bound_ms": (nb * block * 4 + nb * kb * 8) / HBM_BYTES_PER_S
             * 1e3}
        for key in tot:
            tot[key] += count * t[key]
        shapes.append({"n_blocks": nb, "block": block, "kb": kb,
                       "leaves": count, **t,
                       "to_library": t["ms"] / t["library_ms"]})
        del x, xb, mag
        torch.cuda.empty_cache()
    emit("k6_times", shapes=shapes, summed_over_leaves=tot,
         to_library=tot["ms"] / tot["library_ms"])
    return {**tot, "max_abs_err": err, "bound_by": "bytes", "shapes": shapes}


def k2_phase(dev):
    """Kernel vs plain, bitwise, at both block rules; then the kernel's
    path, select_topk(backend="fused"), with its launches counted; times
    at alpha = 0.001."""
    from repro_torch.core import sparsify as SP
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels import segmented_topk as ST
    roles = (SP.ROLE_COMPRESSED,)
    gen = torch.Generator(device=dev).manual_seed(2)
    timing = launches = None
    for sparsity, rule, kind in ((0.001, "bitonic", "normal"),
                                 (0.001, "bitonic", "special"),
                                 (0.0001, "loop", "normal")):
        layout = llama_layout(sparsity)
        ex, block, seg, kcap, n_cand, _ = SP._fused_meta(layout, roles,
                                                         "auto")
        assert ex == rule, (sparsity, ex)
        n = layout.n_total
        x = special_values(n, gen, dev) if kind == "special" else \
            torch.randn(n, generator=gen, device=dev) * 1e-3
        seg_t = torch.from_numpy(seg).to(dev)
        kcap_t = torch.from_numpy(kcap).to(dev)
        active = ST.active_blocks(seg_t, block)
        args = (x, seg_t, kcap_t, n_cand, block)
        out_k = ST.segmented_topk(*args, active=active)
        torch.cuda.synchronize()
        out_p = ST.segmented_topk_plain(*args)
        names = ("cand_vals", "cand_idx", "cand_seg")
        equal = {nm: same_bits(a, b)
                 for nm, a, b in zip(names, out_k, out_p)}
        err = max(float((a.float() - b.float()).abs().nan_to_num(0.0).max())
                  for a, b in zip(out_k, out_p))
        kept = int((out_k[2] >= 0).sum())
        emit("k2" if kind == "normal" else "k2_special", extract=ex,
             block=block, n=n, n_cand=n_cand,
             n_blocks=out_k[0].numel() // n_cand, kept=kept,
             bitwise=equal, max_abs_err=err)
        if not all(equal.values()):
            raise AssertionError(f"segmented_topk differs from its plain "
                                 f"version at {ex} on {kind} input: "
                                 f"{equal}")
        del out_k, out_p
        if timing is None:
            pool = (-(-n // block)) * n_cand
            nbytes = n * 8 + pool * 12
            timing = {
                "ms": cuda_ms(lambda: ST.segmented_topk(
                    *args, active=active), 3),
                "plain_ms": cuda_ms(lambda: ST.segmented_topk_plain(*args),
                                    1),
                "max_abs_err": err, "bytes": nbytes,
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes", "library_ms": None,
                "scratch_bytes": sweep_scratch_bytes(active, block),
                "block": block, "n": n, "n_cand": n_cand}
            # the kernel's path: the public selection through the sweep
            want = SP.select_topk(x, layout, backend="jnp")
            torch.cuda.synchronize()
            reset_launches()
            got = SP.select_topk(x, layout, backend="fused")
            torch.cuda.synchronize()
            launches = dict(LAUNCHES)
            path_equal = all(torch.equal(a, b) for a, b in zip(got, want))
            emit("k2_path", entry="select_topk(backend='fused')",
                 launches=launches, equal_to_jnp_backend=path_equal)
            if not path_equal or launches.get("segmented_topk", 0) != 1:
                raise AssertionError(f"select_topk(backend='fused') on the "
                                     f"card: equal {path_equal}, launches "
                                     f"{launches}")
            del want, got
        del x, seg_t, active, args
        SP._device_meta.cache_clear()
        torch.cuda.empty_cache()
    return timing, launches


def k3_phase(dev):
    """Kernel vs plain at the encoder's im2col shapes for the main path's
    mu_pad; times each layer and one encoder pass (the five launches back
    to back) beside addmm + leaky_relu's, with two bounds: f32 operations
    outside the tensor cores (the table's) and the kernel's route, three
    TF32 products (3xTF32) on the tensor cores."""
    import torch.nn.functional as F
    from repro_torch.core import autoencoder as AE
    from repro_torch.kernels import matmul_lrelu as MM
    from repro_torch.kernels import ops
    mu_pad = llama_layout(0.001).mu_pad
    gen = torch.Generator(device=dev).manual_seed(1)
    ae = AE.init_lgc_autoencoder(gen, dev)
    x = torch.randn((mu_pad, 1), generator=gen, device=dev) * 1e-3
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes_ms": 0.0,
           "ops_ms": 0.0, "bound_ms": 0.0, "tf32x3_ops_ms": 0.0,
           "tf32x3_bound_ms": 0.0}
    err, shapes, layers = 0.0, [], []
    for p, (_c, k, s) in zip(ae["encoder"], AE.ENCODER_SPEC):
        cols = ops._im2col_1d(x, k, s).contiguous()
        w = p["w"].reshape(-1, p["w"].shape[-1]).contiguous()
        b = torch.randn(p["b"].shape, generator=gen, device=dev) * 0.1
        y = MM.matmul_bias_lrelu(cols, w, b)
        torch.cuda.synchronize()
        yp = MM.matmul_bias_lrelu_plain(cols, w, b)
        e = float((y - yp).abs().max())
        tol = 1e-5 * max(1.0, float(yp.abs().max()))
        if e > tol:
            raise AssertionError(f"matmul_bias_lrelu off by {e} > {tol} at "
                                 f"{tuple(cols.shape)} @ {tuple(w.shape)}")
        err = max(err, e)
        (M, Kd), N = cols.shape, w.shape[1]
        t = {"ms": cuda_ms(lambda: MM.matmul_bias_lrelu(cols, w, b), 20),
             "plain_ms": cuda_ms(lambda: MM.matmul_bias_lrelu_plain(
                 cols, w, b), 20),
             "library_ms": cuda_ms(lambda: F.leaky_relu(
                 torch.addmm(b, cols, w), 0.01), 20),
             "bytes_ms": (M * Kd + Kd * N + N + M * N) * 4
             / HBM_BYTES_PER_S * 1e3,
             "ops_ms": 2.0 * M * N * Kd / F32_FLOPS * 1e3,
             "tf32x3_ops_ms": 3 * 2.0 * M * N * Kd / TF32_FLOPS * 1e3}
        t["bound_ms"] = max(t["bytes_ms"], t["ops_ms"])
        t["tf32x3_bound_ms"] = max(t["bytes_ms"], t["tf32x3_ops_ms"])
        for key in tot:
            tot[key] += t[key]
        shapes.append({"M": M, "K": Kd, "N": N, "max_abs_err": e,
                       "tol": tol, **t,
                       "to_library": t["ms"] / t["library_ms"]})
        layers.append((cols, w, b))
        x = y
    # one encode as the path runs it: the five layers back to back, so the
    # host's launch overhead hides behind the large layers as it does there
    chained = {
        "ms": cuda_ms(lambda: [MM.matmul_bias_lrelu(*a) for a in layers], 20),
        "plain_ms": cuda_ms(lambda: [MM.matmul_bias_lrelu_plain(*a)
                                     for a in layers], 20),
        "library_ms": cuda_ms(lambda: [F.leaky_relu(torch.addmm(b, c, w), 0.01)
                                       for c, w, b in layers], 20)}
    emit("k3", mu_pad=mu_pad, route="3xTF32 mma.sync m16n8k8 (K >= 8), f32 "
         "FMA (K < 8)", shapes=shapes, max_abs_err=err,
         summed_over_layers={k: tot[k] for k in ("ms", "plain_ms",
                                                  "library_ms")},
         summed_to_library=tot["ms"] / tot["library_ms"], encode=chained,
         encode_to_library=chained["ms"] / chained["library_ms"],
         bound_ms=tot["bound_ms"], tf32x3_bound_ms=tot["tf32x3_bound_ms"])
    return {**tot, **chained, "summed_ms": tot["ms"],
            "summed_library_ms": tot["library_ms"],
            "bound_by": "bytes" if tot["bytes_ms"] >= tot["ops_ms"]
            else "operations", "max_abs_err": err}


def k7_phase(dev):
    """K7 against its plain version, bitwise, at the main path's flat
    gradient; its path (estimate_threshold + sparsify_ef) with its
    launches counted; times; and the exact-FMA momentum_correct."""
    from repro_torch.core import sparsify as SP
    from repro_torch.kernels import LAUNCHES, ops, reset_launches
    from repro_torch.kernels import sparsify_ef as EF
    from repro_torch.utils import fma_f32
    layout = llama_layout(0.001)
    n, k, m = layout.n_total, layout.mu, 0.9
    gen = torch.Generator(device=dev).manual_seed(7)
    g = torch.randn(n, generator=gen, device=dev)
    u = torch.randn(n, generator=gen, device=dev) * 0.1
    v = torch.randn(n, generator=gen, device=dev) * 0.3
    v_acc = v + fma_f32(m, u, g)
    tau = ops.estimate_threshold(v_acc, k)
    del v_acc
    torch.cuda.synchronize()
    reset_launches()
    out = ops.sparsify_ef(g, u, v, tau, m)          # the kernel's path
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    if launches.get("sparsify_ef", 0) != 1:
        raise AssertionError(f"ops.sparsify_ef on the card: launches "
                             f"{launches}")
    equal, err, step = [True] * 3, 0.0, 1 << 26
    for s in range(0, n, step):
        sl = slice(s, s + step)
        want = EF.sparsify_ef_plain(g[sl], u[sl], v[sl], tau, m)
        for j, (a, b) in enumerate(zip(out, want)):
            a = a[sl]
            equal[j] &= bool(torch.equal(a.view(torch.int32),
                                         b.view(torch.int32)))
            err = max(err, float((a - b).abs().nan_to_num(0.0).max()))
        del want
    kept = int((out[2] != 0).sum())
    names = ("u_out", "v_out", "sent")
    emit("k7", n=n, k=k, tau=float(tau), kept=kept, kept_over_k=kept / k,
         launches=launches, bitwise=dict(zip(names, equal)),
         max_abs_err=err)
    if not all(equal):
        raise AssertionError(f"sparsify_ef differs from its plain version: "
                             f"{dict(zip(names, equal))}")
    del out
    nbytes = 6 * 4 * n
    timing = {"ms": cuda_ms(lambda: EF.sparsify_ef(g, u, v, tau, m), 5),
              "plain_ms": cuda_ms(lambda: EF.sparsify_ef_plain(
                  g, u, v, tau, m), 1),
              "max_abs_err": err, "bytes": nbytes,
              "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
              "bound_by": "bytes", "library_ms": None, "n": n}
    # the dgc --topk-backend pallas accumulate: u' = fma(m, u, g) exactly,
    # v' = v + u', beside the product and the sum rounded apart
    mc = {"momentum_correct_ms": cuda_ms(
              lambda: SP.momentum_correct(u, v, g, m), 3),
          "unfused_ms": cuda_ms(lambda: (lambda uu: (uu, v + uu))(
              m * u + g), 3)}
    emit("k7_times", **timing, **mc)
    del g, u, v
    torch.cuda.empty_cache()
    return timing, launches


def _sorted_pairs(n: int, k: int, dev, seed: int):
    """k pairs over [0, n] as the path ships them: distinct indices in
    ascending order, the last few the sentinel n, and small values."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    cand = torch.unique(torch.randint(0, n, (2 * k,), generator=gen))
    idx = cand[torch.randperm(cand.numel(), generator=gen)[:k - 9]]
    idx = torch.cat([torch.sort(idx)[0],
                     torch.full((9,), n)]).to(torch.int32)
    vals = torch.randn(k, generator=gen) * 1e-3
    return vals.to(dev), idx.to(dev)


def _edge_ints(kind: str, k: int, width: int, dev):
    if kind == "random":
        return torch.randint(0, 2 ** width, (k,), dtype=torch.int32,
                             device=dev)
    fill = 2 ** width - 1 if kind == "max" else 0
    return torch.full((k,), fill, dtype=torch.int32, device=dev)


def bitpack_phase(dev):
    """K4, K5a and K5b against their plain versions, bitwise, at the
    path's PackPlan and at edge cases, K5b also on stacks of B = 2
    payloads (a gathered table); the codec on the card against the CPU,
    and on a gathered table; times at the path's shapes."""
    from repro_torch.dist import packed as PK
    from repro_torch.dist import quantize as Q
    from repro_torch.kernels import bitpack as BP
    layout = llama_layout(0.001)
    n, k = layout.n_total, layout.mu_pad
    plan = PK.make_plan(n, k)
    width, W, sb = plan.lo_bits, BP.word_count(k), plan.scale_block
    m = -(-k // sb)
    vals, idx = _sorted_pairs(n, k, dev, 4)
    lo = idx & ((1 << width) - 1)
    checks = {}

    def same(name, got, want):
        ok = all(torch.equal(a, b) for a, b in zip(got, want))
        checks[name] = checks.get(name, True) and ok

    words = BP.pack_bits(lo, width)
    same("pack_bits", [words], [BP.pack_bits_plain(lo, width)])
    same("pack_bits", [BP.pack_bits(idx, plan.width)],
         [BP.pack_bits_plain(idx, plan.width)])
    same("unpack_bits", [BP.unpack_bits(words, k)],
         [BP.unpack_bits_plain(words, k), lo])
    # the gathered table of K = 2 payloads, decoded in one launch
    vals2, idx2 = _sorted_pairs(n, k, dev, 5)
    lo2 = idx2 & ((1 << width) - 1)
    table = torch.stack([words, BP.pack_bits(lo2, width)])
    same("unpack_bits_table", [BP.unpack_bits(table, k)],
         [BP.unpack_bits_plain(table, k), torch.stack([lo, lo2])])
    qp = BP.quantize_pack(vals, lo, width, sb, Q._EPS)
    same("quantize_pack", qp,
         BP.quantize_pack_plain(vals, lo, width, sb, Q._EPS))
    for kk in (1, 31, 32, 33, 4096 + 7, 32 * 128 * 2 + 5):
        for w in (1, 2, 16, 29, 31):
            for kind in ("random", "zeros", "max"):
                x = _edge_ints(kind, kk, w, dev)
                wds = BP.pack_bits(x, w)
                same("pack_bits", [wds], [BP.pack_bits_plain(x, w)])
                same("unpack_bits", [BP.unpack_bits(wds, kk)], [x])
                tbl = torch.stack([wds, BP.pack_bits(
                    _edge_ints("random", kk, w, dev), w)])
                same("unpack_bits_table", [BP.unpack_bits(tbl, kk)],
                     [BP.unpack_bits_plain(tbl, kk)])
    # K5a's tile pack at every width, on values whose bits above the width
    # are set (the pack drops them)
    for kk in (1, 31, 32, 33, 1024, 2 * 32 * 32 + 5):
        for w in range(1, BP.MAX_WIDTH + 1):
            x = torch.randint(-2 ** 31, 2 ** 31 - 1, (kk,), device=dev,
                              dtype=torch.int32)
            same("pack_bits", [BP.pack_bits(x, w)],
                 [BP.pack_bits_plain(x, w)])
    for kk in (1, 255, 256, 257, 1000, 1300):
        for blk in (256, 64, 1, 1000):
            v = torch.randn(kk, device=dev)
            v[::97], v[5::101], v[7::103] = (float("nan"), float("inf"),
                                             -float("inf"))
            if kk >= 1024:
                v[256:512] = 0.0
                v[768:812] = torch.arange(-22, 22, device=dev) + 0.5
                v[812] = 127.0
            x = _edge_ints("random", kk, 16, dev)
            same("quantize_pack", BP.quantize_pack(v, x, 16, blk, Q._EPS),
                 BP.quantize_pack_plain(v, x, 16, blk, Q._EPS))
    perm = torch.randperm(k, device=dev)
    enc = PK.encode_sparse_fused(vals[perm], idx[perm], plan)
    cpu = PK.encode_sparse_fused(vals[perm].cpu(), idx[perm].cpu(), plan)
    same("codec", [a.cpu() for a in enc], cpu)
    dv, di = PK.decode_sparse(enc, plan)
    same("codec", [dv.cpu(), di], [PK.decode_sparse(cpu, plan)[0], idx])
    same("codec", [PK.decode_indices(PK.encode_indices(idx, plan), plan)],
         [idx])
    # the gathered table as RingPackedTransport decodes it: one call
    enc2 = PK.encode_sparse_fused(vals2, idx2, plan)
    tv, ti = PK.decode_sparse(tuple(torch.stack(p) for p in zip(enc, enc2)),
                              plan)
    same("codec_table", [tv[0], tv[1], ti], [dv, PK.decode_sparse(
        enc2, plan)[0], torch.stack([idx, idx2])])
    torch.cuda.synchronize()
    emit("bitpack", n=n, k=k, width=plan.width, lo_bits=width,
         n_buckets=plan.n_buckets, words_per_plane=W, scale_blocks=m,
         packed_bytes=PK.wire_nbytes(plan), raw_bytes=k * 8,
         packed_to_raw=PK.wire_nbytes(plan) / (k * 8), bitwise=checks)
    if not all(checks.values()):
        raise AssertionError(f"bitpack kernels differ from their plain "
                             f"versions: {checks}")
    return bitpack_times(dev, batched=True)


def bitpack_times(dev, batched: bool):
    """K4, K5a and K5b at the path's shapes, each as ``ms`` (CUDA events
    around 200 back-to-back wrapper calls: host and device work), as
    ``device_ms`` (the same 200 calls captured in one CUDA graph and
    replayed) and as ``host_us`` (1000 calls, no synchronise); with
    ``batched``, also K5b on the K = 2 gathered table in one launch
    (``unpack_bits_table``)."""
    from repro_torch.dist import packed as PK
    from repro_torch.dist import quantize as Q
    from repro_torch.kernels import bitpack as BP
    layout = llama_layout(0.001)
    n, k = layout.n_total, layout.mu_pad
    plan = PK.make_plan(n, k)
    width, W, sb = plan.lo_bits, BP.word_count(k), plan.scale_block
    m = -(-k // sb)
    vals, idx = _sorted_pairs(n, k, dev, 4)
    lo = idx & ((1 << width) - 1)
    words = BP.pack_bits(lo, width)
    plane_bytes = width * W * 4
    rows = {
        "pack_bits": (lambda: BP.pack_bits(lo, width),
                      lambda: BP.pack_bits_plain(lo, width),
                      k * 4 + plane_bytes),
        "unpack_bits": (lambda: BP.unpack_bits(words, k),
                        lambda: BP.unpack_bits_plain(words, k),
                        plane_bytes + k * 4),
        "quantize_pack": (
            lambda: BP.quantize_pack(vals, lo, width, sb, Q._EPS),
            lambda: BP.quantize_pack_plain(vals, lo, width, sb, Q._EPS),
            k * 8 + plane_bytes + m * sb + m * 4),
    }
    if batched:
        table = torch.stack([words, BP.pack_bits(
            _sorted_pairs(n, k, dev, 5)[1] & ((1 << width) - 1), width)])
        rows["unpack_bits_table"] = (
            lambda: BP.unpack_bits(table, k),
            lambda: BP.unpack_bits_plain(table, k),
            2 * (plane_bytes + k * 4))
    out = {}
    for name, (kern, plain, nbytes) in rows.items():
        out[name] = {"ms": cuda_ms(kern, 200),
                     "device_ms": graph_ms(kern, 200),
                     "host_us": host_us(kern, 1000),
                     "plain_ms": cuda_ms(plain, 20),
                     "max_abs_err": 0.0, "bytes": nbytes,
                     "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                     "bound_by": "bytes", "library_ms": None}
    emit("bitpack_times", k=k, lo_bits=width, words_per_plane=W, **out)
    return out


def flash_phase(dev) -> dict:
    """Flash attention (models/flash.py, plain PyTorch) on the card
    against the same function on the CPU at FLASH_SHAPE, causal, for each
    of FLASH_WINDOWS: the output and the three gradients of one forward +
    backward within FLASH_REL of their largest entry; the device ms of a
    forward and of a forward + backward; then the peak above the inputs
    of one forward + backward at FLASH_PEAK_SEQ."""
    from repro_torch.models import flash
    from repro_torch.utils import disable_tf32
    disable_tf32()
    B, S, H, KH, D = FLASH_SHAPE
    gen = torch.Generator().manual_seed(0)

    def inputs(seq):
        return [torch.randn(shape, generator=gen) for shape in (
            (B, seq, H, D), (B, seq, KH, D), (B, seq, KH, D), (B, seq, H, D))]

    def fwd_bwd(q, k, v, do, window):
        q, k, v = (x.detach().requires_grad_(True) for x in (q, k, v))
        o = flash.flash_attention(q, k, v, True, window)
        o.backward(do)
        return [o.detach(), q.grad, k.grad, v.grad]

    q, k, v, do = inputs(S)
    on_card = [x.to(dev) for x in (q, k, v, do)]
    out = {"shape": dict(zip(("B", "S", "H", "KH", "D"), FLASH_SHAPE)),
           "dtype": "float32", "tol_rel": FLASH_REL}
    for window in FLASH_WINDOWS:
        want = fwd_bwd(q, k, v, do, window)
        got = fwd_bwd(*on_card, window)
        rel = {name: float((a.cpu() - b).abs().max() / b.abs().max())
               for name, a, b in zip(("o", "dq", "dk", "dv"), got, want)}
        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: flash.flash_attention(
                *on_card[:3], True, window), 5)
        out[f"window {window}"] = {
            "rel_err": rel, "fwd_ms": fwd_ms,
            "fwd_bwd_ms": cuda_ms(lambda: fwd_bwd(*on_card, window), 3)}
        if max(rel.values()) > FLASH_REL:
            raise AssertionError(f"flash window {window}: card against CPU "
                                 f"{rel} > {FLASH_REL}")
    del on_card
    long = [x.to(dev) for x in inputs(FLASH_PEAK_SEQ)]
    gc_cuda()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    grads = fwd_bwd(*long, 0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base
    finite = all(bool(g.isfinite().all()) for g in grads)
    del long, grads
    out[f"S {FLASH_PEAK_SEQ}"] = {
        "fwd_bwd_s": seconds, "peak_gib": peak / 2 ** 30,
        "one_score_matrix_gib": B * H * FLASH_PEAK_SEQ ** 2 * 4 / 2 ** 30,
        "finite": finite}
    emit("flash", **out)
    if not finite:
        raise AssertionError(f"flash S {FLASH_PEAK_SEQ}: non-finite result")
    gc_cuda()
    return out


def _fwd_bwd(fn, params, inputs, r):
    """fn(params, *inputs) -> (y, extra) with extra a scalar or None:
    (y, extra, the gradients of sum(y * r) + extra with respect to every
    leaf of ``params`` and then every input)."""
    from repro_torch.utils.tree import tree_leaves, tree_unflatten
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    ins = [t.detach().requires_grad_(True) for t in inputs]
    y, extra = fn(tree_unflatten(params, leaves), *ins)
    obj = (y * r).sum() + (0 if extra is None else extra)
    grads = torch.autograd.grad(obj, leaves + ins)
    return y.detach(), None if extra is None else extra.detach(), grads


def _rel(got, want) -> float:
    """max |got - want| over max |want| (got on any device)."""
    want = want.double()
    return float((got.cpu().double() - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def card_vs_cpu(fn, params, inputs, r, names, dev):
    """fn once on the CPU and once on the card from the same tensors:
    {name: rel error} for y, the extra scalar (if any) and every gradient
    (``names``: the params' leaf paths, then the inputs')."""
    from repro_torch.utils.tree import tree_map
    want = _fwd_bwd(fn, params, inputs, r)
    got = _fwd_bwd(fn, tree_map(lambda t: t.to(dev), params),
                   [t.to(dev) for t in inputs], r.to(dev))
    rel = {"y": _rel(got[0], want[0])}
    if want[1] is not None:
        rel["aux"] = _rel(got[1], want[1])
    rel.update({"d" + n: _rel(a, b) for n, a, b in zip(names, got[2],
                                                        want[2])})
    return rel


def moe_phase(dev) -> dict:
    """layers.moe_fwd (plain PyTorch, as the reference's is plain jnp) on
    the card against the CPU at arctic-480b's published widths (d_model
    7168, d_ff_expert 4864, the dense residual), experts cut from 128 to
    MOE_EXPERTS, f32 (TF32 off), MOE_TOKENS tokens, capacity dispatch
    (G = 32 groups, C = 10) and dropless: y, the aux loss, the input's
    and every weight's gradient within MOE_REL of their largest entry;
    device ms of a forward and of a forward + backward."""
    from repro_torch.configs import get_arch
    from repro_torch.models import layers as L
    from repro_torch.utils import disable_tf32
    from repro_torch.utils.tree import keystr_path, tree_leaves_with_path, \
        tree_map
    disable_tf32()
    base = get_arch("arctic-480b")
    cfg = dataclasses.replace(base, dtype="float32", moe=dataclasses.replace(
        base.moe, num_experts=MOE_EXPERTS))
    gen = torch.Generator().manual_seed(0)
    p = L.init_moe(gen, cfg, torch.float32, "cpu")
    x = torch.randn(MOE_TOKENS + (cfg.d_model,), generator=gen)
    r = torch.randn(x.shape, generator=gen)
    names = [keystr_path(q) for q, _ in tree_leaves_with_path(p)] + ["x"]
    out = {"tokens": x.shape[0] * x.shape[1], "experts": MOE_EXPERTS,
           "d_model": cfg.d_model, "d_ff_expert": cfg.moe.d_ff_expert,
           "dtype": "float32", "tol_rel": MOE_REL, "reduced":
           ["num_experts"]}
    p_dev = tree_map(lambda t: t.to(dev), p)
    x_dev = x.to(dev)
    T = out["tokens"]
    for dropless in (False, True):
        def fn(pp, xx):
            return L.moe_fwd(pp, cfg, xx, dropless=dropless)
        rel = card_vs_cpu(fn, p, [x], r, names, dev)
        with torch.no_grad():
            h = L.rmsnorm(p_dev["norm"], x_dev).reshape(T, -1)
            probs = torch.softmax(L.linear(p_dev["router"], h), -1)
            _, gsel, _ = L.moe_route(probs, cfg.moe, dropless)
            fwd_ms = cuda_ms(lambda: fn(p_dev, x_dev), 3)
        name = "dropless" if dropless else "capacity"
        out[name] = {"G": gsel.shape[0], "C": gsel.shape[2],
                     "kept": int((gsel > 0).sum()),
                     "assigned": T * cfg.moe.top_k, "rel_err": rel,
                     "fwd_ms": fwd_ms, "fwd_bwd_ms": cuda_ms(
                         lambda: _fwd_bwd(fn, p_dev, [x_dev], r.to(dev)),
                         2)}
        if max(rel.values()) > MOE_REL:
            raise AssertionError(f"moe {name}: card against CPU {rel} > "
                                 f"{MOE_REL}")
    emit("moe", **out)
    del p_dev, x_dev
    gc_cuda()
    return out


def ssd_phase(dev) -> dict:
    """models/mamba2.py on the card against the CPU at mamba2-130m's
    width (24 heads of 64, d_state 128, chunk 256, f32): ssd_chunked on
    N(0, 1) inputs (dt = softplus(N(0, 1)), A = -exp(U[0, log 16])) and
    mamba_fwd with the block's seeded weights, at each of SSD_LENGTHS
    (4097 takes the padded chunk plan), batch 2: the output within
    SSD_REL and every gradient within SSD_GRAD_REL of its largest entry;
    device ms of a forward and of a forward + backward."""
    from repro_torch.configs import get_arch
    from repro_torch.models import mamba2 as M
    from repro_torch.utils import disable_tf32
    from repro_torch.utils.tree import keystr_path, tree_leaves_with_path, \
        tree_map
    disable_tf32()
    cfg = dataclasses.replace(get_arch("mamba2-130m"), dtype="float32")
    s, d_inner, H = M._dims(cfg)
    P, N, b = s.head_dim, s.d_state, 2
    gen = torch.Generator().manual_seed(0)
    p = M.init_mamba(gen, cfg, torch.float32, "cpu")
    p_dev = tree_map(lambda t: t.to(dev), p)
    names = [keystr_path(q) for q, _ in tree_leaves_with_path(p)] + ["x"]
    out = {"heads": H, "head_dim": P, "d_state": N, "chunk": s.chunk_size,
           "batch": b, "dtype": "float32", "tol_rel": SSD_REL,
           "grad_tol_rel": SSD_GRAD_REL}

    def ssd(_, *a):
        return M.ssd_chunked(*a, chunk=s.chunk_size), None

    def block(pp, xx):
        return M.mamba_fwd(pp, cfg, xx), None

    for S in SSD_LENGTHS:
        def randn(*shape):
            return torch.randn(shape, generator=gen)
        ins = [randn(b, S, H, P),
               torch.nn.functional.softplus(randn(b, S, H)),
               -torch.exp(torch.rand(H, generator=gen) * math.log(16.0)),
               randn(b, S, N), randn(b, S, N), randn(H)]
        rel_ssd = card_vs_cpu(ssd, {}, ins, randn(b, S, H, P),
                              ["x", "dt", "A", "B", "C", "D"], dev)
        x = randn(b, S, cfg.d_model)
        rel_block = card_vs_cpu(block, p, [x], randn(*x.shape), names, dev)
        ins_dev = [t.to(dev) for t in ins]
        x_dev = x.to(dev)
        r_ssd = torch.randn(ins[0].shape, device=dev)
        r_x = torch.randn(x.shape, device=dev)
        with torch.no_grad():
            t = {"ssd_fwd_ms": cuda_ms(lambda: ssd(None, *ins_dev), 3),
                 "block_fwd_ms": cuda_ms(lambda: block(p_dev, x_dev), 3)}
        t["ssd_fwd_bwd_ms"] = cuda_ms(
            lambda: _fwd_bwd(ssd, {}, ins_dev, r_ssd), 3)
        t["block_fwd_bwd_ms"] = cuda_ms(
            lambda: _fwd_bwd(block, p_dev, [x_dev], r_x), 3)
        Q, Sp = M.chunk_plan(S, s.chunk_size)
        out[f"S {S}"] = {"chunk_plan": [Q, Sp], "ssd_rel_err": rel_ssd,
                         "block_rel_err": rel_block, **t}
        for where, rel in (("ssd_chunked", rel_ssd), ("mamba_fwd",
                                                      rel_block)):
            grads = {k: v for k, v in rel.items() if k != "y"}
            if rel["y"] > SSD_REL or max(grads.values()) > SSD_GRAD_REL:
                raise AssertionError(
                    f"ssd S {S} {where}: card against CPU {rel} > "
                    f"{SSD_REL} (output) / {SSD_GRAD_REL} (gradients)")
    emit("ssd", **out)
    del p_dev
    gc_cuda()
    return out


def set_gates(params, cfg, value: float = CROSS_GATE):
    """Every cross-attention gate of ``params`` set to ``value`` in place
    (they start at 0, where the layers add nothing).  Returns params."""
    for i, kind in enumerate(cfg.block_pattern):
        if kind == "cross":
            params["blocks"][f"p{i}"]["mixer"]["gate"].fill_(value)
    return params


def _mla_fwd_bwd(p, cfg, x, cots):
    """mla_fwd's output, c_kv and k_rope, and the gradients of sum(y *
    r) + sum(c_kv * rc) + sum(k_rope * rk) with respect to every weight
    leaf and x."""
    from repro_torch.models import layers as L
    from repro_torch.utils.tree import tree_leaves, tree_unflatten
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(p)]
    xx = x.detach().requires_grad_(True)
    y, (c, k) = L.mla_fwd(tree_unflatten(p, leaves), cfg, xx,
                          torch.arange(x.shape[1], device=x.device))
    obj = sum((t * r).sum() for t, r in zip((y, c, k), cots))
    grads = torch.autograd.grad(obj, leaves + [xx])
    return [y.detach(), c.detach(), k.detach()] + list(grads)


def mla_phase(dev) -> dict:
    """Latent attention (layers.mla_fwd in the expanded form, mla_decode
    in the absorbed form; plain PyTorch, as the reference's is plain
    jnp) at deepseek-v3-671b's geometry, f32 (TF32 off), seeded weights:
    at each of MLA_LENGTHS the output, the cache and every gradient on
    the card against the CPU (MLA_REL, MLA_GRAD_REL), device ms of a
    forward and of a forward + backward; then a prefill of
    MLA_LENGTHS[0] tokens and 3 decode steps on the card against the
    expanded form over the longer prompt (MLA_DECODE_REL), with the
    decode's device ms a step."""
    from repro_torch.configs import get_arch
    from repro_torch.models import flash
    from repro_torch.models import layers as L
    from repro_torch.utils import disable_tf32
    from repro_torch.utils.tree import keystr_path, tree_leaves_with_path, \
        tree_map
    disable_tf32()
    cfg = dataclasses.replace(get_arch("deepseek-v3-671b"), dtype="float32")
    m, B = cfg.mla, MLA_BATCH
    gen = torch.Generator().manual_seed(0)
    p = L.init_mla(gen, cfg, torch.float32, "cpu")
    p_dev = tree_map(lambda t: t.to(dev), p)
    names = ["y", "c_kv", "k_rope"] + ["d" + keystr_path(q) for q, _ in
                                        tree_leaves_with_path(p)] + ["dx"]
    out = {"d_model": cfg.d_model, "heads": cfg.n_heads,
           "q_lora": m.q_lora_rank, "kv_lora": m.kv_lora_rank,
           "nope": m.qk_nope_head_dim, "rope": m.qk_rope_head_dim,
           "v": m.v_head_dim, "batch": B, "dtype": "float32",
           "tol_rel": MLA_REL, "grad_tol_rel": MLA_GRAD_REL,
           "decode_tol_rel": MLA_DECODE_REL}

    def randn(*shape):
        return torch.randn(shape, generator=gen)
    for S in MLA_LENGTHS:
        x = randn(B, S, cfg.d_model)
        cots = [randn(B, S, cfg.d_model), randn(B, S, m.kv_lora_rank),
                randn(B, S, m.qk_rope_head_dim)]
        want = _mla_fwd_bwd(p, cfg, x, cots)
        x_dev, c_dev = x.to(dev), [c.to(dev) for c in cots]
        got = _mla_fwd_bwd(p_dev, cfg, x_dev, c_dev)
        rel = {n: _rel(a, b) for n, a, b in zip(names, got, want)}
        del want, got
        pos = torch.arange(S, device=dev)
        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: L.mla_fwd(p_dev, cfg, x_dev, pos), 3)
        out[f"S {S}"] = {
            "chunk_plan": list(flash.chunk_plan(S, S)), "rel_err": rel,
            "fwd_ms": fwd_ms, "fwd_bwd_ms": cuda_ms(
                lambda: _mla_fwd_bwd(p_dev, cfg, x_dev, c_dev), 2)}
        fwd = max(rel[n] for n in names[:3])
        grads = max(rel[n] for n in names[3:])
        if fwd > MLA_REL or grads > MLA_GRAD_REL:
            raise AssertionError(f"mla S {S}: card against CPU {rel} > "
                                 f"{MLA_REL} (output, cache) / "
                                 f"{MLA_GRAD_REL} (gradients)")
    # the absorbed decode against the expanded form, on the card
    P, G = MLA_LENGTHS[0], 3
    x = randn(B, P + G, cfg.d_model).to(dev)
    with torch.no_grad():
        cache = L.init_mla_cache(cfg, B, P + G, torch.float32, dev)
        _, (c, k) = L.mla_fwd(p_dev, cfg, x[:, :P], torch.arange(P,
                                                                 device=dev))
        cache["c_kv"][:, :P], cache["k_rope"][:, :P] = c, k
        cache["pos"][:P] = torch.arange(P, dtype=torch.int32, device=dev)
        dec = torch.cat([L.mla_decode(p_dev, cfg, x[:, i:i + 1], cache,
                                      i)[0] for i in range(P, P + G)], 1)
        full, _ = L.mla_fwd(p_dev, cfg, x, torch.arange(P + G, device=dev))
        rel = _rel(dec, full[:, P:].cpu())
        # the last step again: it rewrites its own slot
        step_ms = cuda_ms(lambda: L.mla_decode(
            p_dev, cfg, x[:, -1:], cache, P + G - 1), 5)
    out["decode"] = {"prefill": P, "steps": G, "rel_err": rel,
                     "cache_len": P + G, "step_ms": step_ms}
    emit("mla", **out)
    if rel > MLA_DECODE_REL:
        raise AssertionError(f"mla decode: absorbed against expanded {rel} "
                             f"> {MLA_DECODE_REL}")
    del p_dev, cache
    gc_cuda()
    return out


def cross_phase(dev) -> dict:
    """Cross-attention (layers.cross_attention_kv and cross_attention_fwd:
    non-causal flash over the encoder tokens, 1601 padded to 2048 keys;
    plain PyTorch, as the reference's is plain jnp) at
    llama-3.2-vision-90b's widths, f32 (TF32 off), seeded weights, the
    gate at CROSS_GATE: the output and every gradient (the gate's and
    the embeddings' too) on the card against the CPU (CROSS_REL,
    CROSS_GRAD_REL); device ms of kv, of a forward and of a forward +
    backward; then a bf16 call with f32 embeddings, which must give k
    and v in f32 (as jnp's promotion does) and the output in bf16."""
    from repro_torch.configs import get_arch
    from repro_torch.models import flash
    from repro_torch.models import layers as L
    from repro_torch.utils import disable_tf32
    from repro_torch.utils.tree import keystr_path, tree_leaves_with_path, \
        tree_map
    disable_tf32()
    cfg = dataclasses.replace(get_arch("llama-3.2-vision-90b"),
                              dtype="float32")
    B, S = CROSS_SHAPE
    T = cfg.num_encoder_tokens
    gen = torch.Generator().manual_seed(0)
    p = L.init_cross_attention(gen, cfg, torch.float32, "cpu")
    p["gate"].fill_(CROSS_GATE)
    x = torch.randn((B, S, cfg.d_model), generator=gen)
    enc = torch.randn((B, T, cfg.encoder_dim), generator=gen)
    r = torch.randn(x.shape, generator=gen)
    names = [keystr_path(q) for q, _ in tree_leaves_with_path(p)] + [
        "x", "enc"]

    def fn(pp, xx, ee):
        return L.cross_attention_fwd(pp, cfg, xx,
                                     L.cross_attention_kv(pp, cfg, ee)), None
    rel = card_vs_cpu(fn, p, [x, enc], r, names, dev)
    p_dev = tree_map(lambda t: t.to(dev), p)
    x_dev, enc_dev = x.to(dev), enc.to(dev)
    with torch.no_grad():
        kv = L.cross_attention_kv(p_dev, cfg, enc_dev)
        t = {"kv_ms": cuda_ms(lambda: L.cross_attention_kv(p_dev, cfg,
                                                           enc_dev), 5),
             "fwd_ms": cuda_ms(lambda: L.cross_attention_fwd(
                 p_dev, cfg, x_dev, kv), 5)}
        ref32 = L.cross_attention_fwd(p_dev, cfg, x_dev, kv)
    t["fwd_bwd_ms"] = cuda_ms(lambda: _fwd_bwd(fn, p_dev, [x_dev, enc_dev],
                                               r.to(dev)), 3)
    # bf16 weights and activations, f32 embeddings
    c16 = dataclasses.replace(cfg, dtype="bfloat16")
    p16 = tree_map(lambda t: t.to(torch.bfloat16), p_dev)
    with torch.no_grad():
        k16, v16 = L.cross_attention_kv(p16, c16, enc_dev)
        y16 = L.cross_attention_fwd(p16, c16, x_dev.bfloat16(), (k16, v16))
    dtypes = [str(u.dtype).split(".")[-1] for u in (k16, v16, y16)]
    out = {"batch": B, "queries": S, "encoder_tokens": T,
           "encoder_dim": cfg.encoder_dim, "d_model": cfg.d_model,
           "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
           "gate": CROSS_GATE, "chunk_plan": list(flash.chunk_plan(S, T)),
           "dtype": "float32", "tol_rel": CROSS_REL,
           "grad_tol_rel": CROSS_GRAD_REL, "rel_err": rel, **t,
           "bf16": {"k, v, y dtypes": dtypes,
                    "y_rel_to_f32": _rel(y16, ref32.cpu())}}
    emit("cross", **out)
    grads = max(v for k_, v in rel.items() if k_ != "y")
    if rel["y"] > CROSS_REL or grads > CROSS_GRAD_REL:
        raise AssertionError(f"cross: card against CPU {rel} > {CROSS_REL} "
                             f"(output) / {CROSS_GRAD_REL} (gradients)")
    if dtypes != ["float32", "float32", "bfloat16"]:
        raise AssertionError(f"cross bf16: k, v, y dtypes {dtypes}, not "
                             "float32, float32, bfloat16")
    del p_dev, p16
    gc_cuda()
    return out


def gc_cuda() -> None:
    """Collect what reference cycles hold, then return the cached blocks."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


class _Interrupt(Exception):
    """Raised by a run's step hook to stop it after a given step, as a
    crash would (the resume check)."""


def train_phase(dev, name: str, flags, steps: int, *expects,
                gc_off: bool = False, stop_after=None, raises=None,
                reduced=("n_layers",), cfg=None):
    """One training run through launch.train.run(): the launch counts are
    reset just before and read just after; each ``expect(launches,
    phases)`` raises unless the path went through its kernels (``phases``:
    those of the steps that finished).  Losses must be finite and the
    per-op wire rows equal the pricer's for the run's mesh and bucket
    count.  ``gc_off`` disables the garbage collector for the run, so
    whatever a reference cycle holds stays until the end and shows in the
    peak.  ``stop_after`` stops the run after that step; ``raises`` is
    the exception class the run must raise (nothing else is caught).
    ``cfg``: the model (default llama3.2-1b at N_LAYERS layers);
    ``reduced``: the cuts of the run, printed with it."""
    import gc
    from repro_torch.configs import get_arch
    from repro_torch.core import sparsify as SP
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import train
    if cfg is None:
        cfg = dataclasses.replace(get_arch("llama3.2-1b"),
                                  n_layers=N_LAYERS)
    args = train.parse_args([
        "--data-shards", "2", "--batch", "8", "--seq", "128",
        "--warmup-steps", "2", "--steps", str(steps), "--log-every", "1",
        "--device", "cuda"] + flags)
    records = []

    def on_step(rec):
        records.append(rec)
        if rec["step"] == stop_after:
            raise _Interrupt

    gc.collect()        # what the phases before left in reference cycles
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    if gc_off:
        gc.disable()
    out, error = None, None
    try:
        out = train.run(cfg, args, on_step=on_step)
    except (raises or _Interrupt) as e:
        # the type and message only: the traceback holds the run's frames,
        # and with them its state
        error = (type(e), str(e))
    finally:
        gc.enable()
    launches = dict(LAUNCHES)
    if raises is not None and (error is None or error[0] is not raises):
        raise AssertionError(f"{name}: the run did not raise "
                             f"{raises.__name__}")
    if stop_after is not None and (error is None
                                   or error[0] is not _Interrupt):
        raise AssertionError(f"{name}: the run was not stopped")
    wire = out["wire"] if out is not None else {}
    comp = out["compressor"] if out is not None else None
    losses, step_ms = check_run(name, records, launches, expects, wire, comp)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    guard = {h["step"]: {k: h[k] for k in ("guard_ok", "fault", "faults",
                                           "fault_ops") if k in h}
             for h in records if "guard_ok" in h or "fault_ops" in h}
    emit("train", run=name, transport=args.transport, arch=cfg.name,
         n_layers=cfg.n_layers, seq=args.seq, batch=args.batch,
         reduced=list(reduced), d_model=cfg.d_model, dtype=cfg.dtype,
         mtp_losses=[r["mtp_loss"] for r in records]
         if cfg.mtp_depth else None,
         n_params=comp.layout.n_total if comp else None,
         nodes=args.pod_shards * args.data_shards,
         mesh=comp.Ks if comp else None,
         wire_buckets=args.wire_buckets, gc_off=gc_off, losses=losses,
         step_ms=step_ms, launches=launches, wire=wire, peak_mem_gib=peak,
         guard=guard or None,
         error=None if error is None else f"{error[0].__name__}: {error[1]}",
         rate_bytes_per_node=out["rate"].bytes_per_node if out else None)
    result = {"launches": launches, "losses": losses, "wire": wire,
              "peak_gib": peak, "history": records, "step_ms": step_ms,
              "n_params": comp.layout.n_total if comp else None,
              "error": None if error is None else error[1],
              "compressor": comp,
              "resumed": out["resumed"] if out is not None else None,
              "report": out["report"] if out is not None else None}
    del out, comp
    SP._device_meta.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    return result


def check_run(name: str, records, launches, expects, wire, comp):
    """The checks of every training run: finite losses; each ``expect(
    launches, phases)``; each phase's measured wire rows equal the
    pricer's for ``comp``'s plan and mesh.  Returns the losses and the
    step ms grouped by phase."""
    from repro_torch.dist import plan as XP
    losses = [r["loss"] for r in records]
    if not all(l == l and abs(l) != float("inf") for l in losses):
        raise AssertionError(f"{name}: non-finite loss: {losses}")
    for expect in expects:
        expect(launches, [r["phase"] for r in records])
    for phase, rows in wire.items():
        plan = XP.build_plan(comp.cc, comp.layout, comp.K, phase=phase)
        priced = XP.wire_terms_by_op(plan, axis_sizes=comp.Ks)
        if rows != priced:
            raise AssertionError(f"{name} {phase}: measured wire rows {rows}"
                                 f" != priced {priced}")
    step_ms = {}
    for r in records:
        step_ms.setdefault(r["phase"], []).append(r["ms"])
    return losses, step_ms


def launched(*names):
    def expect(launches, _phases):
        for nm in names:
            if launches.get(nm, 0) <= 0:
                raise AssertionError(f"{nm} never launched on the path: "
                                     f"{launches}")
    return expect


def per_step(compressed=None, **per_sparsified_step):
    """Each named kernel launched exactly that many times per sparsified
    step of the run, plus ``compressed[name]`` more per compressed-phase
    step."""
    def expect(launches, phases):
        sparsified = sum(p != "warmup" for p in phases)
        n_comp = sum(p == "compressed" for p in phases)
        extra = compressed or {}
        for nm in set(per_sparsified_step) | set(extra):
            want = per_sparsified_step.get(nm, 0) * sparsified \
                + extra.get(nm, 0) * n_comp
            if launches.get(nm, 0) != want:
                raise AssertionError(
                    f"{nm} launched {launches.get(nm, 0)} times, not "
                    f"{per_sparsified_step.get(nm, 0)} x {sparsified} "
                    f"sparsified + {extra.get(nm, 0)} x {n_comp} compressed "
                    f"steps: {launches}")
    return expect



def pg_report_flags(name: str):
    """``--report`` into build/pg/<name>/: the run's record, with the
    digest of its final params and AE."""
    slug = "".join(c if c.isalnum() else "_" for c in name)
    return ["--report", os.path.join(ROOT, "build", "pg", slug)]


def pg_rank(spec_path: str) -> None:
    """One rank of a pg_train launch (torchrun runs this script with
    ``--pg-rank SPEC``): launch.train's run() on llama3.2-1b cut to the
    spec's depth, with the spec's flags, as one node of the process
    group torchrun's environment describes."""
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s %(message)s")
    from repro_torch.configs import get_arch
    from repro_torch.launch import train
    with open(spec_path) as f:
        spec = json.load(f)
    cfg = dataclasses.replace(get_arch("llama3.2-1b"),
                              n_layers=spec["n_layers"])
    train.run(cfg, train.parse_args(spec["flags"]))


def pg_launch(name: str, flags, steps: int, K: int, n_layers: int):
    """torchrun of K ranks of this script on the card; returns each rank's
    record.  Raises when the launch fails (torchrun stops every rank when
    one fails) or outlives PG_TIMEOUT_S."""
    report = pg_report_flags("pg " + name)
    out_dir = report[1]
    os.makedirs(out_dir, exist_ok=True)
    for f in os.listdir(out_dir):
        os.remove(os.path.join(out_dir, f))
    spec = os.path.join(ROOT, "build", "pg", "spec.json")
    with open(spec, "w") as f:
        json.dump({"n_layers": n_layers, "flags": [
            "--data-shards", "2", "--batch", "8", "--seq", "128",
            "--warmup-steps", "2", "--steps", str(steps), "--log-every",
            "1", "--device", "cuda", "--dist-backend", PG_BACKEND] + flags
            + report}, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    used = subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                           "--format=csv,noheader,nounits"],
                          capture_output=True, text=True).stdout.split()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(K), os.path.join(ROOT, "chip_smoke.py"),
         "--pg-rank", spec], env=env, capture_output=True, text=True,
        timeout=PG_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    with open(os.path.join(out_dir, "torchrun.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        # each rank's last lines: the first to fail names the cause, the
        # others lost their peer
        tails = []
        for r in range(K):
            lines = [ln for ln in proc.stderr.splitlines()
                     if ln.startswith(f"[rank{r}]:")]
            tails.append("\n".join(lines[-12:]))
        raise AssertionError(f"pg {name}: torchrun exited "
                             f"{proc.returncode}:\n" + "\n".join(tails))
    recs = []
    for r in range(K):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    return recs, {"launch_s": seconds, "card_mib_used_before":
                  float(used[0]) if used else None}


def train_flags():
    """The training runs' flags: the lgc_rar main path (K1, K3), dgc with
    the block top-k (K6), the packed ring, 4 buckets, lgc_rar_q8 on the
    int8 ring, lgc_rar on ring_hier over 2 pods."""
    lgc = ["--compression", "lgc_rar", "--topk-backend", "fused",
           "--ae-backend", "pallas", "--ae-train-steps", "2"]
    return {"lgc": lgc,
            "dgc": ["--compression", "dgc", "--topk-backend", "pallas"],
            "packed": ["--transport", "ring_packed"],
            "buckets": ["--wire-buckets", "4"],
            "q8": ["--compression", "lgc_rar_q8"] + lgc[2:] + [
                "--transport", "ring_q8"],
            "hier": lgc + ["--transport", "ring_hier", "--pod-shards", "2"]}


def pg_train_phase(dev, runs, smi: str, n_leaves: int,
                   n_encoder: int) -> None:
    """Each process run against its emulated twin (``runs[twin]``, run here
    when missing or at another depth): losses bitwise, rows equal, the
    final digest equal on every rank and to the twin's; each rank's
    launches per step."""
    from repro_torch.dist import plan as XP
    fl = train_flags()
    lgc, dgc, packed, buckets, q8, hier = (
        fl[k] for k in ("lgc", "dgc", "packed", "buckets", "q8", "hier"))
    per_node = dict(fused_ef_topk=1,
                    compressed={"matmul_bias_lrelu": n_encoder})
    specs = [
        ("lgc_rar mesh", "lgc_rar", lgc, 6, 2, N_LAYERS,
         per_step(**per_node)),
        # each rank: its 4 buckets through 4 K4 launches, the gathered
        # table of the 8 payloads through one K5b
        ("dgc ring_packed B4", "dgc ring_packed B4", dgc + packed + buckets,
         5, 2, N_LAYERS,
         per_step(block_topk=n_leaves, quantize_pack=4, unpack_bits=1)),
        ("lgc_rar_q8 ring_q8", "lgc_rar_q8 ring_q8", q8, 6, 2, N_LAYERS,
         per_step(**per_node)),
        ("lgc_rar ring_hier", "lgc_rar ring_hier", hier, 6, 4,
         PG_HIER_LAYERS, per_step(**per_node)),
    ]
    for name, twin_name, flags, steps, K, layers, expect in specs:
        twin = runs.get(twin_name)
        if twin is None or twin.get("report") is None or layers != N_LAYERS:
            twin_name = twin_name + ("" if layers == N_LAYERS
                                     else f" {layers} layers")
            cfg = None
            if layers != N_LAYERS:
                from repro_torch.configs import get_arch
                cfg = dataclasses.replace(get_arch("llama3.2-1b"),
                                          n_layers=layers)
            twin = train_phase(
                dev, twin_name, flags + pg_report_flags(twin_name), steps,
                cfg=cfg)
            runs[twin_name] = twin
        gc_cuda()
        recs, launch = pg_launch(name, flags, steps, K, layers)
        comp = twin["compressor"]
        for r, rec in enumerate(recs):
            where = f"pg {name} rank {r}"
            losses = [h["loss"] for h in rec["history"]]
            if losses != twin["losses"]:
                raise AssertionError(f"{where}: losses {losses} != the "
                                     f"twin's {twin['losses']}")
            if rec["wire"] != twin["wire"]:
                raise AssertionError(f"{where}: rows {rec['wire']} != the "
                                     f"twin's {twin['wire']}")
            for phase, rows in rec["wire"].items():
                plan = XP.build_plan(comp.cc, comp.layout, comp.K,
                                     phase=phase)
                if rows != XP.wire_terms_by_op(plan, axis_sizes=comp.Ks):
                    raise AssertionError(f"{where} {phase}: rows != priced")
            if rec["digest"] != twin["report"]["digest"]:
                mine, theirs = rec["leaf_digests"], \
                    twin["report"]["leaf_digests"]
                differ = sorted(k for k in theirs if mine.get(k) != theirs[k])
                raise AssertionError(f"{where}: the params and AE differ "
                                     f"from the twin's in {differ}")
            expect(rec["launches"], [h["phase"] for h in rec["history"]])
        step_ms = [{} for _ in recs]
        for r, rec in enumerate(recs):
            for h in rec["history"]:
                step_ms[r].setdefault(h["phase"], []).append(h["ms"])
        emit("pg_train", run=name, twin=twin_name, card=smi,
             backend=PG_BACKEND, nodes=K, mesh=comp.Ks, n_layers=layers,
             seq=128, batch=8, reduced=["n_layers"], **launch,
             losses=twin["losses"], digest=twin["report"]["digest"],
             equal={"losses": True, "rows": True, "digest": True},
             step_ms=step_ms, twin_step_ms=twin["step_ms"],
             peak_gib=[rec["peak_gib"] for rec in recs],
             twin_peak_gib=twin["peak_gib"],
             launches=[rec["launches"] for rec in recs],
             twin_launches=twin["launches"],
             sent={phase: [rec["sent"][phase] for rec in recs]
                   for phase in recs[0]["sent"]},
             wire=twin["wire"])
        runs["pg " + name] = {"launches": {
            k: sum(rec["launches"].get(k, 0) for rec in recs)
            for k in set().union(*(rec["launches"] for rec in recs))}}


def moe_ssm_train_runs(dev, runs, K: int, lgc, n_encoder: int) -> None:
    """lgc_rar (K1 and K3) on the mesh wire, K = 2, batch 8, 6 steps
    through the three phases, on the new gradient layouts: mamba2-130m
    at full width and depth (the SSM's leaves) at seq 128 and at
    train_4k's 4096 (batch 256 cut to 8), and arctic-480b at published
    widths cut to 1 layer and ARCTIC_TRAIN_EXPERTS experts (the 3-D expert
    stacks; 4 sequences of 128 a node: G = 32 groups of 16, C = 10)."""
    from repro_torch.configs import get_arch
    expect = per_step(fused_ef_topk=K,
                      compressed={"matmul_bias_lrelu": n_encoder * K})
    mamba = get_arch("mamba2-130m")
    runs["mamba2-130m lgc_rar"] = train_phase(
        dev, "mamba2-130m lgc_rar", lgc, 6, expect, cfg=mamba, reduced=())
    runs["mamba2-130m lgc_rar seq 4096"] = train_phase(
        dev, "mamba2-130m lgc_rar seq 4096", lgc + ["--seq", str(TRAIN_SEQ)],
        6, expect, cfg=mamba, reduced=("batch",))
    arctic = get_arch("arctic-480b")
    arctic = dataclasses.replace(arctic, n_layers=1, moe=dataclasses.replace(
        arctic.moe, num_experts=ARCTIC_TRAIN_EXPERTS))
    runs["arctic-480b lgc_rar"] = train_phase(
        dev, "arctic-480b lgc_rar", lgc, 6, expect, cfg=arctic,
        reduced=("n_layers", "num_experts"))


def mla_cross_train_runs(dev, runs, K: int, lgc, n_encoder: int) -> None:
    """lgc_rar (K1 and K3) on the mesh wire, K = 2, batch 8, seq 128, 6
    steps through the three phases, on the new gradient layouts:
    deepseek-v3-671b at published widths (the MLA leaves, expert width
    2048 and the shared expert, the MTP subtree) cut to 1 layer, 4
    experts of top-2 and a vocab of DEEPSEEK_TRAIN_VOCAB, its MTP loss
    finite every step; llama-3.2-vision-90b at its reduced() config (the
    cross layers' gates; the encoder stream on the card).  One
    self-attention layer of vision at published width is 856M
    parameters and its embedding and lm_head 2.1B, so no published-
    width run of it fits one card's K = 2 emulation."""
    from repro_torch.configs import get_arch
    expect = per_step(fused_ef_topk=K,
                      compressed={"matmul_bias_lrelu": n_encoder * K})
    ds = get_arch("deepseek-v3-671b")
    E, top_k = DEEPSEEK_TRAIN_EXPERTS
    ds = dataclasses.replace(ds, n_layers=1, vocab_size=DEEPSEEK_TRAIN_VOCAB,
                             moe=dataclasses.replace(ds.moe, num_experts=E,
                                                     top_k=top_k))
    name = "deepseek-v3-671b lgc_rar"
    runs[name] = train_phase(
        dev, name, lgc, 6, expect, cfg=ds,
        reduced=("n_layers", "num_experts", "top_k", "vocab_size"))
    mtp = [h["mtp_loss"] for h in runs[name]["history"]]
    if len(mtp) != 6 or not all(math.isfinite(v) for v in mtp):
        raise AssertionError(f"{name}: MTP losses {mtp}")
    vision = get_arch("llama-3.2-vision-90b").reduced()
    name = "llama-3.2-vision-90b smoke lgc_rar"
    runs[name] = train_phase(dev, name, lgc, 6, expect, cfg=vision,
                             reduced=("reduced()",))


def guard_runs(dev, runs, n_leaves: int, K: int, lgc, dgc, q8) -> None:
    """The chaos wire under the guard policies, at the path's widths: (a)
    dgc on the packed ring with the checksum word, bit flips, NaNs and
    infs on its top-k exchange, scrubbed; (b) lgc_rar_q8 on the int8 ring
    with a NaN on its encoding, the round skipped, and one compressed
    step of that run's compressor driven directly, whose gradient must be
    zero and whose u, v must be the nodes' accumulators before the clear;
    (c) lgc_rar under fail_fast, which must raise WireFaultError naming
    the encoding at the first compressed step."""
    from repro_torch.core.autoencoder import ENCODER_SPEC as ENCODER
    from repro_torch.dist import chaos as CH
    faults = ["--fault-seed", "3", "--fault-nans", "2", "--fault-infs", "1",
              "--fault-bitflips", "2", "--fault-ops", "topk"]
    # under a guard each node's pairs still go through K4, their
    # non-finites counted beside it (the reference takes its composed
    # encode there: the same payload bits and counts).  The gathered table
    # is decoded once (K5b), and that decode is what each payload's
    # validation reads
    a = runs["dgc chaos:ring_packed scrub"] = train_phase(
        dev, "dgc chaos:ring_packed scrub",
        dgc + ["--transport", "chaos:ring_packed", "--guard", "scrub",
               "--guard-checksum"] + faults, 5,
        per_step(block_topk=n_leaves * K, quantize_pack=K, pack_bits=0,
                 unpack_bits=1))
    injected = {"topk": {"bitflip": 2, "nan": 2, "inf": 1}}
    for h in a["history"]:
        sparsified = h["phase"] != "warmup"
        if sparsified and not (h.get("fault_ops") == injected
                               and h["fault"]["topk"] >= 3
                               and h["guard_ok"] == 0):
            raise AssertionError(f"dgc chaos:ring_packed step {h}")
        if not sparsified and (h["guard_ok"] != 1 or "fault_ops" in h):
            raise AssertionError(f"dgc chaos:ring_packed warm-up step {h}")
    plain = runs["dgc ring_packed"]["wire"]["topk_ae"]
    extra = {op: row["all_gather_packed"] - plain[op]["all_gather_packed"]
             for op, row in a["wire"]["topk_ae"].items()
             if "all_gather_packed" in row}
    emit("guard_checksum_bytes", extra_per_node=extra,
         per_payload=4, nodes=K)
    if set(extra.values()) != {4 * (K - 1)}:
        raise AssertionError(f"the checksum word costs {extra}, not 4 bytes "
                             f"per payload")

    b = runs["lgc_rar_q8 chaos:ring_q8 skip_round"] = train_phase(
        dev, "lgc_rar_q8 chaos:ring_q8 skip_round",
        q8[:-1] + ["chaos:ring_q8", "--guard", "skip_round",
                   "--fault-nans", "1", "--fault-ops", "encoding"], 6,
        per_step(fused_ef_topk=K,
                 compressed={"matmul_bias_lrelu": len(ENCODER) * K}))
    for h in b["history"]:
        if h["phase"] == "compressed" and not (
                h["guard_ok"] == 0 and h["fault"]["encoding"] >= 1
                and h["fault_ops"] == {"encoding": {"nan": 1}}):
            raise AssertionError(f"lgc_rar_q8 chaos:ring_q8 step {h}")
    comp = b["compressor"]
    gen = torch.Generator(device=dev).manual_seed(9)
    states = comp.init_sim_states(gen, dev)
    g = torch.randn(states["u"].shape, generator=gen, device=dev) * 1e-3
    states["u"].normal_(generator=gen).mul_(1e-3)
    states["v"].normal_(generator=gen).mul_(1e-3)
    want_u, want_v = states["u"].clone(), states["v"].clone()
    for k in range(K):
        comp._accumulate_select(want_u[k], want_v[k], g[k])
    CH.reset_fault_tally()
    gg, states, stats = comp.sim_step(states, g, 4, "compressed")
    checks = {"guard_ok": int(stats["guard_ok"]) == 0,
              "gradient_zero": int(gg.count_nonzero()) == 0,
              "u_uncleared": same_bits(states["u"], want_u),
              "v_uncleared": same_bits(states["v"], want_v)}
    emit("skip_round_step", fault={k: int(v) for k, v in stats.items()
                                   if k.startswith("fault/")},
         fault_ops=CH.fault_report(), checks=checks)
    del states, g, gg, want_u, want_v, comp
    b["compressor"] = None
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise AssertionError(f"skip_round step: {checks}")

    c = runs["lgc_rar chaos:mesh fail_fast"] = train_phase(
        dev, "lgc_rar chaos:mesh fail_fast",
        lgc + ["--transport", "chaos:mesh", "--guard", "fail_fast",
               "--fault-nans", "1", "--fault-ops", "encoding"], 6,
        launched("fused_ef_topk", "matmul_bias_lrelu"),
        raises=CH.WireFaultError)
    if "encoding" not in c["error"] or "at step 4" not in c["error"]:
        raise AssertionError(f"fail_fast raised {c['error']!r}, not at "
                             f"step 4 on the encoding")


def resume_run(dev, runs, K: int, lgc) -> None:
    """(d) lgc_rar with the main path's flags and a checkpoint every 3
    steps, stopped after step 3 as a crash would stop it (the file then
    holds the state after step 3, to resume at step 4), then resumed from
    that file: steps 4 and 5, the compressed phase on the u, v and AE
    read back, must give the uninterrupted lgc_rar run's losses bit for
    bit.  The file's bytes and the save and load seconds are printed; the
    file is deleted."""
    import shutil
    from repro_torch.core.autoencoder import ENCODER_SPEC as ENCODER
    ckdir = os.path.join(ROOT, "build", "ckpt_smoke")
    path = os.path.join(ckdir, "ckpt.npz")
    try:
        first = runs["lgc_rar stopped"] = train_phase(
            dev, "lgc_rar stopped after step 3",
            lgc + ["--checkpoint-dir", ckdir, "--checkpoint-every", "3"], 6,
            per_step(fused_ef_topk=K), stop_after=3)
        nbytes = os.path.getsize(path)
        second = runs["lgc_rar resumed"] = train_phase(
            dev, "lgc_rar resumed at step 4", lgc + ["--resume", path], 6,
            per_step(fused_ef_topk=K,
                     compressed={"matmul_bias_lrelu": len(ENCODER) * K}))
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    want = runs["lgc_rar"]["losses"]
    equal = first["losses"] == want[:4] and second["losses"] == want[4:] \
        and [h["step"] for h in second["history"]] == [4, 5]
    emit("resume", file_bytes=nbytes,
         save_s=first["history"][3]["checkpoint_s"],
         load_s=second["resumed"]["seconds"],
         resumed_at=second["resumed"]["step"],
         losses={"uninterrupted": want, "stopped": first["losses"],
                 "resumed": second["losses"]}, bitwise=equal)
    if not equal:
        raise AssertionError("the resumed run's losses differ from the "
                             "uninterrupted run's")


def convnet5_layout(sparsity: float):
    from repro_torch.configs.convnet5 import config
    from repro_torch.core import sparsify as SP
    from repro_torch.models.convnet import init_convnet5
    return SP.build_layout(init_convnet5(torch.Generator(), config()),
                           sparsity)


def convnet5_pack_plans(packed_runs):
    """Each distinct PackPlan that build_plan gives ConvNet5's runs on the
    packed ring (``packed_runs``: their CompressionConfig fields), at
    K = CONVNET_K, in the sparsified phases they take: {(n, k, lo_bits):
    (label, plan)}, raw-index plans (no bit planes) left out."""
    from repro_torch.configs.base import CompressionConfig
    from repro_torch.core.phases import PHASE_TOPK_AE
    from repro_torch.dist import plan as XP
    plans = {}
    for fields in packed_runs:
        cc = CompressionConfig(**fields)
        layout = convnet5_layout(cc.sparsity)
        for phase in sorted({PHASE_TOPK_AE, XP.steady_phase(cc.method)}):
            for op in XP.build_plan(cc, layout, CONVNET_K, phase=phase).ops:
                pk = getattr(op, "pack", None)
                if pk is not None and not pk.raw_index:
                    plans.setdefault((pk.n, pk.k, pk.lo_bits),
                                     (f"{cc.method} {op.label}", pk))
    return plans


def convnet5_kernels(dev, packed_runs):
    """K1, K6, K3, K4, K5a and K5b against their plain versions at
    ConvNet5's shapes (config(), n = 588,008): K1 bitwise at alpha = 0.05
    (the lgc runs: 14 slots, BN leaves with k = 3 to 13); K6 bitwise at
    every leaf shape of alpha = 0.01 (the dgc run: k = 1 on the 64-entry
    BN leaves), and global_topk against the torch.topk leaf selection; K3
    within 1e-5 of max(1, max|y|) at the encoder's im2col shapes for alpha
    = 0.05's mu_pad (26,784) and alpha = 0.001's (544, below one tile);
    K4, K5a and K5b bitwise at every PackPlan of the ``packed_runs``
    (k 514 to 26,784 at 8 to 15 low bits): K4 and K5a on each of K
    payloads, K5b on one payload and on the K-payload table."""
    import torch.nn.functional as F
    from repro_torch.core import autoencoder as AE
    from repro_torch.core import sparsify as SP
    from repro_torch.dist import quantize as Q
    from repro_torch.kernels import bitpack as BP
    from repro_torch.kernels import block_topk as BT
    from repro_torch.kernels import matmul_lrelu as MM
    from repro_torch.kernels import ops
    from repro_torch.kernels import sparsify_ef as EF
    gen = torch.Generator(device=dev).manual_seed(5)
    checks, err = {}, {}
    layout = convnet5_layout(0.05)
    ex, block, seg, kcap, n_cand, _ = SP._fused_meta(
        layout, (SP.ROLE_COMPRESSED, SP.ROLE_TOPK_ONLY), "auto")
    n = layout.n_total
    g, u, v = (torch.randn(n, generator=gen, device=dev) * 1e-3
               for _ in range(3))
    seg_t = torch.from_numpy(seg).to(dev)
    kcap_t = torch.from_numpy(kcap).to(dev)
    args = (g, u, v, seg_t, kcap_t, 0.9, True, n_cand, block)
    out_k = EF.sparsify_ef_topk(*args, active=EF.active_blocks(seg_t, block))
    torch.cuda.synchronize()
    out_p = EF.sparsify_ef_topk_plain(*args)
    checks["k1"] = all(same_bits(a, b) for a, b in zip(out_k, out_p))
    err["k1"] = max(float((a.float() - b.float()).abs().max())
                    for a, b in zip(out_k, out_p))
    k1 = {"n": n, "extract": ex, "block": block, "n_cand": n_cand,
          "slots": len(kcap), "k": [int(k) for k in kcap]}
    k6 = []
    lay = convnet5_layout(0.01)
    ok6 = True
    for (nb, blk, kb), leaves in sorted(pallas_shapes(lay).items()):
        leaf = leaves[0]
        x = torch.randn(leaf.size, generator=gen, device=dev) * 1e-3
        xb = F.pad(x, (0, nb * blk - leaf.size)).view(nb, blk)
        got = BT.block_topk(xb, kb)
        torch.cuda.synchronize()
        equal = all(torch.equal(a, b) for a, b in
                    zip(got, BT.block_topk_plain(xb, kb)))
        gv, gi = ops.global_topk(x, leaf.k, block=blk)
        lv, li = SP._leaf_topk(x, leaf.k, 0)
        equal &= torch.equal(gv, lv) and torch.equal(gi.long(), li)
        ok6 &= equal
        k6.append({"leaf": leaf.path, "size": leaf.size, "k": leaf.k,
                   "n_blocks": nb, "block": blk, "kb": kb,
                   "leaves": len(leaves), "bitwise": equal})
    checks["k6"] = ok6
    ae = AE.init_lgc_autoencoder(gen, dev)
    k3, err["k3"], ok3 = [], 0.0, True
    for sparsity in (0.05, 0.001):
        mu_pad = convnet5_layout(sparsity).mu_pad
        x = torch.randn((mu_pad, 1), generator=gen, device=dev) * 1e-3
        for p, (_c, k, st) in zip(ae["encoder"], AE.ENCODER_SPEC):
            cols = ops._im2col_1d(x, k, st).contiguous()
            w = p["w"].reshape(-1, p["w"].shape[-1]).contiguous()
            b = torch.randn(p["b"].shape, generator=gen, device=dev) * 0.1
            y = MM.matmul_bias_lrelu(cols, w, b)
            torch.cuda.synchronize()
            yp = MM.matmul_bias_lrelu_plain(cols, w, b)
            e = float((y - yp).abs().max())
            tol = 1e-5 * max(1.0, float(yp.abs().max()))
            ok3 &= e <= tol
            err["k3"] = max(err["k3"], e)
            k3.append({"mu_pad": mu_pad, "M": cols.shape[0],
                       "K": cols.shape[1], "N": w.shape[1],
                       "max_abs_err": e, "tol": tol})
            x = y
    checks["k3"] = ok3
    k45 = []
    for (n, k, lo), (label, pk) in sorted(convnet5_pack_plans(
            packed_runs).items()):
        pairs = [_sorted_pairs(n, k, dev, 10 + j) for j in range(CONVNET_K)]
        v = pairs[1][0]
        v[::97], v[5::101], v[7::103] = (float("nan"), float("inf"),
                                         -float("inf"))
        los = [idx & ((1 << lo) - 1) for _, idx in pairs]
        sb = pk.scale_block
        got = [BP.quantize_pack(v, x, lo, sb, Q._EPS)
               for (v, _), x in zip(pairs, los)]
        words = [BP.pack_bits(x, lo) for x in los]
        table = torch.stack(words)
        one, tbl = BP.unpack_bits(words[0], k), BP.unpack_bits(table, k)
        torch.cuda.synchronize()
        ok = {"quantize_pack": all(
                  all(same_bits(a, b) for a, b in zip(
                      q, BP.quantize_pack_plain(v, x, lo, sb, Q._EPS)))
                  for q, (v, _), x in zip(got, pairs, los)),
              "pack_bits": all(torch.equal(w, BP.pack_bits_plain(x, lo))
                               for w, x in zip(words, los)),
              "unpack_bits": torch.equal(one, los[0]) and torch.equal(
                  one, BP.unpack_bits_plain(words[0], k)),
              "unpack_bits_table": torch.equal(tbl, torch.stack(los))
              and torch.equal(tbl, BP.unpack_bits_plain(table, k))}
        k45.append({"plan": label, "n": n, "k": k, "lo_bits": lo,
                    "words_per_plane": BP.word_count(k), "payloads": CONVNET_K,
                    "bitwise": ok})
        for name, equal in ok.items():
            checks[name] = checks.get(name, True) and equal
    emit("convnet5_kernels", k1=k1, k6=k6, k3=k3, k4_k5=k45,
         bitwise_or_within_tol=checks, max_abs_err=err)
    if not all(checks.values()):
        raise AssertionError(f"a kernel differs from its plain version at "
                             f"ConvNet5's shapes: {checks}")
    SP._device_meta.cache_clear()


def convnet5_run(dev, name: str, cc_fields: dict, steps: int, lr: float,
                 data_seed: int, *expects, cpu_steps: int = 0):
    """One run of the reference's single-host ConvNet5 loop
    (launch.steps.sim_sgd_step) at config(), K = 4 nodes of 8 images:
    launch counts reset before and read after, each ``expect``
    checked; finite losses; the wire rows of each phase equal the
    pricer's.  ``cpu_steps`` > 0 runs the first steps again on the CPU
    from the same weights and holds the card's first step's gradients
    (CONVNET_GRAD_REL), losses and weights (CONVNET_TRAJ_REL) to
    them."""
    from repro_torch.configs.base import CompressionConfig
    from repro_torch.configs.convnet5 import config
    from repro_torch.core import sparsify as SP
    from repro_torch.core.compressors import build_compressor
    from repro_torch.data import synthetic_image_batches
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.steps import node_grads, sim_sgd_step
    from repro_torch.models.convnet import convnet5_loss, init_convnet5
    from repro_torch.utils import disable_tf32
    from repro_torch.utils.tree import (keystr_path, tree_leaves,
                                        tree_leaves_with_path, tree_map)
    disable_tf32()
    cfg = config()
    cc = CompressionConfig(**cc_fields)

    def loss_fn(p, b):
        return convnet5_loss(p, cfg, b)

    def loop(device, n_steps, params, keep_at=-1):
        """``n_steps`` steps from ``params``; returns the compressor, the
        per-step records and the params after step ``keep_at``."""
        gen = torch.Generator(device=device).manual_seed(1)
        comp = build_compressor(cc, params, CONVNET_K)
        states = comp.init_sim_states(gen, device)
        data = synthetic_image_batches(cfg.num_classes,
                                       CONVNET_K * CONVNET_PER_NODE,
                                       cfg.image_size, seed=data_seed)
        records, kept = [], None
        for step in range(n_steps):
            batch = {k: torch.from_numpy(x).to(device)
                     for k, x in next(data).items()}
            t0 = time.perf_counter()
            params, states, _, m = sim_sgd_step(loss_fn, comp, params,
                                                states, batch, step, lr)
            loss, acc = float(m["loss"]), float(m["accuracy"])
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            records.append({"phase": m["phase"], "loss": loss, "acc": acc,
                            "ms": (time.perf_counter() - t0) * 1e3,
                            "wire": m["wire"]})
            if step == keep_at:
                kept = tree_map(lambda t: t.cpu(), params)
        return comp, records, kept

    params0 = init_convnet5(torch.Generator(device=dev).manual_seed(0), cfg,
                            dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    comp, records, p_card = loop(dev, steps, tree_map(torch.clone, params0),
                                 keep_at=cpu_steps - 1)
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    wire = {}
    for r in records:
        wire.setdefault(r["phase"], r["wire"])
    losses, step_ms = check_run(f"convnet5 {name}", records, launches,
                                expects, wire, comp)
    # a phase's first step pays its one-off set-up
    steady = {ph: sorted(ms[1:])[len(ms[1:]) // 2] if len(ms) > 1 else ms[0]
              for ph, ms in step_ms.items()}
    cpu = None
    if cpu_steps:
        # the same code on the CPU from the same weights, for the first
        # (warm-up) steps
        _, r_cpu, p_cpu = loop(torch.device("cpu"), cpu_steps,
                               tree_map(lambda t: t.cpu(), params0),
                               keep_at=cpu_steps - 1)
        scale = max(float(t.abs().max()) for t in tree_leaves(p_cpu))
        p_err = max(float((a - b).abs().max())
                    for a, b in zip(tree_leaves(p_card), tree_leaves(p_cpu)))
        l_err = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                    for a, b in zip(records, r_cpu))
        # one step from the same weights and images: the per-node
        # gradients on the card against the CPU's
        batch0 = {k: torch.from_numpy(x) for k, x in next(
            synthetic_image_batches(cfg.num_classes,
                                    CONVNET_K * CONVNET_PER_NODE,
                                    cfg.image_size, seed=data_seed)).items()}
        g_cpu, _ = node_grads(loss_fn, tree_map(lambda t: t.cpu(), params0),
                              batch0, CONVNET_K, comp.layout.n_total)
        g_card, _ = node_grads(loss_fn, params0,
                               {k: x.to(dev) for k, x in batch0.items()},
                               CONVNET_K, comp.layout.n_total)
        g_err = float((g_card.cpu() - g_cpu).abs().max()) \
            / float(g_cpu.abs().max())
        cpu = {"steps": cpu_steps, "phases": sorted({r["phase"]
                                                     for r in r_cpu}),
               "params_max_abs_err_over_max": p_err / scale,
               "params_err_by_leaf": {
                   keystr_path(path): float((a - b).abs().max() / scale)
                   for (path, a), b in zip(tree_leaves_with_path(p_card),
                                           tree_leaves(p_cpu))},
               "step0_grad_err_over_max": g_err,
               "loss_max_rel_err": l_err,
               "tol": {"grad": CONVNET_GRAD_REL, "traj": CONVNET_TRAJ_REL}}
        if g_err > CONVNET_GRAD_REL \
                or p_err > CONVNET_TRAJ_REL * scale \
                or l_err > CONVNET_TRAJ_REL:
            raise AssertionError(f"convnet5 {name}: the card's first "
                                 f"{cpu_steps} steps against the CPU's: {cpu}")
    accs = [r["acc"] for r in records]
    emit("convnet5", run=name, arch=cfg.name, channels=list(cfg.channels),
         num_classes=cfg.num_classes, image_size=cfg.image_size,
         reduced=[], nodes=CONVNET_K, images_per_node=CONVNET_PER_NODE,
         n_params=comp.layout.n_total, mu_pad=comp.layout.mu_pad,
         k_last=comp.layout.k_last, lr=lr, compression=cc_fields,
         steady_step_ms=steady, launches=launches, wire=wire,
         peak_mem_gib=peak, losses=losses,
         first15={"loss": sum(losses[:15]) / 15, "acc": sum(accs[:15]) / 15},
         last15={"loss": sum(losses[-15:]) / 15, "acc": sum(accs[-15:]) / 15},
         cpu_check=cpu)
    SP._device_meta.cache_clear()
    return {"launches": launches, "losses": losses, "wire": wire,
            "steady_ms": steady, "peak_gib": peak}


def convnet5_phase(dev, runs) -> None:
    """The paper's ConvNet5 at its full widths, K = 4 nodes of 8 images,
    through the ported compressors: K1, K6, K3, K4, K5a and K5b at its
    shapes first; then (1) lgc_rar, fused sweep and kernel encoder, on
    the mesh wire, alpha = 0.05, 10 warm-up + 20 AE-training steps of
    120, lr 0.08 (tests/test_system.py), its 10 warm-up steps held
    against the CPU;
    (2) lgc_ps on ring_packed, alpha = 0.05, innovation alpha = 0.005
    (benchmarks/fig14), 60 steps with the same phases, lr 0.05; (3) dgc,
    block top-k, on ring_packed, alpha = 0.01, 10 warm-up steps of 60,
    lr 0.05 (benchmarks/fig13); and the information plane's MI fraction
    per layer after 10 SGD steps (examples/information_plane.py's loop
    at config())."""
    from repro_torch.configs.convnet5 import config
    from repro_torch.core.autoencoder import ENCODER_SPEC as ENCODER
    from repro_torch.examples import information_plane as IP
    from repro_torch.models.convnet import init_convnet5
    K = CONVNET_K
    lgc = dict(sparsity=0.05, warmup_steps=10, ae_train_steps=20,
               topk_backend="fused", ae_backend="pallas")
    lgc_ps = dict(lgc, method="lgc_ps", innovation_sparsity=0.005,
                  transport="ring_packed")
    dgc = dict(method="dgc", sparsity=0.01, warmup_steps=10,
               topk_backend="pallas", transport="ring_packed")
    convnet5_kernels(dev, (lgc_ps, dgc))
    n_leaves = len(convnet5_layout(0.01).compressed) \
        + len(convnet5_layout(0.01).topk_only)
    runs["convnet5 lgc_rar"] = convnet5_run(
        dev, "lgc_rar", dict(lgc, method="lgc_rar"), 120, 0.08, 0,
        per_step(fused_ef_topk=K,
                 compressed={"matmul_bias_lrelu": len(ENCODER) * K}),
        cpu_steps=10)
    runs["convnet5 lgc_ps ring_packed"] = convnet5_run(
        dev, "lgc_ps ring_packed", lgc_ps, 60, 0.05, 2,
        # + the exempt-last pairs (fc/*): each node's through K4 and
        # their gathered table through one K5b, every sparsified step
        per_step(fused_ef_topk=K, pack_bits=1, unpack_bits=2,
                 quantize_pack=K,
                 compressed={"matmul_bias_lrelu": len(ENCODER),
                             "quantize_pack": K, "unpack_bits": 1}))
    runs["convnet5 dgc ring_packed"] = convnet5_run(
        dev, "dgc ring_packed", dgc, 60, 0.05, 1,
        # the compressed and the exempt-last pairs: two packed exchanges
        per_step(block_topk=n_leaves * K, quantize_pack=2 * K,
                 unpack_bits=2))
    params = init_convnet5(torch.Generator(device=dev).manual_seed(0),
                           config(), dev)
    fracs = IP.mi_fractions(params, config(), steps=11, every=10)
    emit("convnet5_information_plane", bins=IP.BINS, nodes=IP.NODES,
         batch=IP.BATCH, lr=IP.LR, mi_fraction_at_step_0=fracs[0],
         mi_fraction_after_10_sgd_steps=fracs[10])
    if not all(0.0 <= f <= 1.0 for row in fracs.values() for f in row):
        raise AssertionError(f"MI fractions out of [0, 1]: {fracs}")


def serve_checked(dev, cfg, model, params, batch: int, plen: int,
                  gen: int, n_checks: int, gate: bool = True,
                  reduced=()) -> dict:
    """One run of repro_torch.launch.serve's run() with ``params``, then
    its tokens fed back through prefill + decode_step: whether the
    replayed greedy tokens are the run's, and at ``n_checks`` positions
    (3: the first, the middle and the last decoded; 1: the last) the
    logits from the cache must equal a full prefill's last-token logits
    of the same prefix within SERVE_REL of their largest entry (with
    ``gate`` False the error is printed, not held: an MoE prefill drops
    tokens at its capacity that the dropless decode keeps).  Prints the
    prefill ms, the median decode ms per step (the latency), tokens/s (the
    batch's decoded tokens over the decode loop's time) and the peak GiB;
    ``reduced``: the run's cuts."""
    from repro_torch.launch import serve
    args = serve.parse_args(["--arch", cfg.name, "--batch", str(batch),
                             "--prompt-len", str(plen), "--gen", str(gen)])
    gc_cuda()
    torch.cuda.reset_peak_memory_stats(dev)
    run = serve.run(cfg, args, params=params)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    toks = torch.cat([torch.from_numpy(run["prompt"]),
                      torch.from_numpy(run["tokens"])], 1).to(dev).long()
    enc = {} if run["encoder_embeds"] is None else {
        "encoder_embeds": torch.from_numpy(run["encoder_embeds"]).to(dev)}
    # decoded positions are plen .. plen + gen - 2
    check_at = ((plen, plen + gen // 2, plen + gen - 2) if n_checks == 3
                else (plen + gen - 2,))
    checks, replayed = {}, True
    with torch.no_grad():
        _, cache = model.prefill(params, {"tokens": toks[:, :plen], **enc},
                                 cache_len=plen + gen)
        for pos in range(plen, plen + gen - 1):
            logits, cache = model.decode_step(params, cache,
                                              toks[:, pos:pos + 1], pos)
            replayed &= bool(torch.equal(logits[:, 0].argmax(-1),
                                         toks[:, pos + 1]))
            if pos in check_at:
                full, _ = model.prefill(params, {"tokens": toks[:, :pos + 1],
                                                 **enc})
                checks[pos] = decode_check(logits, full)
        del cache
    step_ms = sorted(run["step_ms"])
    name = f"B{batch} prompt {plen} gen {gen}"
    result = {
        "batch": batch, "prompt_len": plen, "gen": gen,
        "prefill_ms": run["prefill_ms"],
        "decode_ms_median": step_ms[len(step_ms) // 2],
        "decode_ms_min": step_ms[0], "decode_ms_max": step_ms[-1],
        # the loop decodes gen - 1 tokens a sequence (prefill gave the
        # first): all of them over all of its time
        "tokens_per_s": batch * (gen - 1) / run["decode_s"],
        "peak_gib": peak, "decode_vs_prefill": checks,
        "tol_rel": SERVE_REL if gate else None,
        "replayed_tokens_equal": replayed}
    emit("serve", run=name, arch=cfg.name, n_layers=cfg.n_layers,
         dtype=cfg.dtype, reduced=list(reduced), **result)
    if gate and not all(c["max_abs_err"] <= SERVE_REL * c["max_abs_logit"]
                        for c in checks.values()):
        raise AssertionError(f"serve {cfg.name} {name}: decoding from the "
                             f"cache differs from a full prefill: {checks}")
    return result


def decode_check(logits, full) -> dict:
    """Decode's logits against a full prefill's, (B, 1, V) each."""
    return {"max_abs_err": float((logits - full).abs().max()),
            "max_abs_logit": float(full.abs().max()),
            "argmax_agree": float((logits.argmax(-1) == full.argmax(-1))
                                  .float().mean())}


def serve_arch(dev, arch: str, shapes, cfg=None, gate: bool = True,
               reduced=(), prepare=None):
    """``arch`` at published widths and full depth (or ``cfg``, cut as
    ``reduced`` says), bf16, random weights from seed 0, through
    serve.run(): one run at the first shape pays the one-off set-up
    (cuBLAS's handles and heuristics), then each of ``shapes`` through
    serve_checked (``gate``: whether decode vs prefill is held;
    ``prepare(params, cfg)``, if given, edits the params in place after
    the set-up run: set_gates).  Returns (results, model, params)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models.model import build_model
    cfg = cfg or get_arch(arch)
    model = build_model(cfg)
    b, p, g, _ = shapes[0]
    params = serve.run(cfg, serve.parse_args([
        "--arch", arch, "--batch", str(b), "--prompt-len", str(p), "--gen",
        str(g)]))["params"]
    if prepare is not None:
        prepare(params, cfg)
    results = {f"B{b} prompt {p} gen {g}":
               serve_checked(dev, cfg, model, params, b, p, g, n, gate,
                             reduced)
               for b, p, g, n in shapes}
    return results, model, params


def serve_phase(dev) -> dict:
    """llama3.2-1b at published widths and all 16 layers (no cut), bf16,
    random weights from seed 0 (serve_arch): the defaults (batch 4,
    prompt 64, gen 32) and a longer prompt (batch 8, prompt 512, gen 64),
    each with the decode-vs-prefill check at three positions; one
    profiled decode step (its kernels and device busy ms against the
    weights' read); a prefill alone at batch 4, prompt SERVE_LONG_PROMPT:
    its ms and peak; then PREFILL_32K at batch 1: its ms, peak and finite
    logits, PREFILL_32K_DECODE decode steps from its cache, the first held
    against a full prefill of length PREFILL_32K + 1.  Then each arch of
    SERVE_ARCHS, freed before the next."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.profile import kernel_times
    from repro_torch.utils.tree import tree_leaves
    result, model, params = serve_arch(
        dev, "llama3.2-1b", ((4, 64, 32, 3), (8, 512, 64, 3)))
    cfg = model.cfg
    # one decode step under the profiler, at the defaults' shapes
    with torch.no_grad():
        prompt = torch.randint(0, cfg.vocab_size, (4, 64), device=dev)
        _, cache = model.prefill(params, {"tokens": prompt}, cache_len=96)
        nxt = prompt[:, -1:]
        for pos in (64, 65):                   # warm-up
            model.decode_step(params, cache, nxt, pos)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.decode_step(params, cache, nxt, 66)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        kernels = kernel_times(prof)
        del cache
    n_weights = sum(p.numel() * p.element_size()
                    for p in tree_leaves(params))
    busy = sum(ms for _, ms, _ in kernels)
    result["decode_profile"] = {
        "wall_ms_profiled": wall, "device_busy_ms": busy,
        "idle_share": 1.0 - busy / wall,
        "kernel_launches": sum(c for _, _, c in kernels),
        "weight_bytes": n_weights,
        "bound_ms": n_weights / HBM_BYTES_PER_S * 1e3,
        "top": [{"kernel": k[:80], "ms": ms, "calls": c}
                for k, ms, c in kernels[:6]]}
    emit("serve_decode_profile", **result["decode_profile"])
    # a prefill alone at batch 4, prompt SERVE_LONG_PROMPT
    gc_cuda()
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        prompt = torch.randint(0, cfg.vocab_size, (4, SERVE_LONG_PROMPT),
                               device=dev, generator=gen)
        model.prefill(params, {"tokens": prompt[:, :64]})   # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {"tokens": prompt})
        finite = bool(logits.isfinite().all())
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        del logits, cache
    result["long_prefill"] = {
        "batch": 4, "prompt_len": SERVE_LONG_PROMPT, "prefill_ms": ms,
        "finite": finite,
        "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
    emit("serve_long_prefill", **result["long_prefill"])
    if not finite:
        raise AssertionError(f"serve: non-finite logits at prompt "
                             f"{SERVE_LONG_PROMPT}")
    result["prefill_32k"] = prefill_32k(dev, model, params, gen)
    del params
    gc_cuda()
    for arch, shapes in SERVE_ARCHS:
        result[arch], _, params = serve_arch(dev, arch, shapes)
        del params
        gc_cuda()
    return result


def prefill_32k(dev, model, params, gen, gate: bool = True,
                reduced=("batch",)) -> dict:
    """PREFILL_32K tokens at batch 1 into a cache of PREFILL_32K +
    PREFILL_32K_DECODE slots, greedy decode steps from it, and the first
    step's logits against a full prefill of the prompt and its token
    (held to SERVE_REL unless ``gate`` is False: an MoE prefill's
    capacity drops tokens)."""
    P, n = PREFILL_32K, PREFILL_32K_DECODE
    gc_cuda()
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        prompt = torch.randint(0, model.cfg.vocab_size, (1, P), device=dev,
                               generator=gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {"tokens": prompt},
                                      cache_len=P + n)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        finite = bool(logits.isfinite().all())
        toks, step_ms = [logits[:, -1].argmax(-1)], []
        for pos in range(P, P + n):
            t0 = time.perf_counter()
            logits, cache = model.decode_step(params, cache,
                                              toks[-1][:, None], pos)
            toks.append(logits[:, 0].argmax(-1))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if pos == P:
                first = logits
        del cache
        finite &= bool(first.isfinite().all())
        t0 = time.perf_counter()
        full, _ = model.prefill(params, {"tokens": torch.cat(
            [prompt, toks[0][:, None]], 1)})
        torch.cuda.synchronize()
        full_ms = (time.perf_counter() - t0) * 1e3
        check = decode_check(first, full)
    out = {"batch": 1, "prompt_len": P, "prefill_ms": ms, "peak_gib": peak,
           "finite": finite, "decode_steps": n,
           "decode_ms_median": sorted(step_ms)[n // 2],
           "decode_ms_max": max(step_ms), "full_prefill_len": P + 1,
           "full_prefill_ms": full_ms, "decode_vs_prefill": check,
           "tol_rel": SERVE_REL if gate else None, "reduced": list(reduced)}
    emit("serve_prefill_32k", arch=model.cfg.name,
         n_layers=model.cfg.n_layers, **out)
    if not finite:
        raise AssertionError(f"serve: non-finite logits at prompt {P}")
    if gate and check["max_abs_err"] > SERVE_REL * check["max_abs_logit"]:
        raise AssertionError(f"serve prompt {P}: decoding from the cache "
                             f"differs from a full prefill: {check}")
    return out


def serve_moe_ssm_phase(dev) -> dict:
    """The MoE and Mamba2 archs served at published widths, bf16, seeded
    random weights (serve_arch): mamba2-130m at full depth (B4 P64 G32,
    B8 P512 G64, decode vs prefill held to SERVE_REL), then PREFILL_32K
    at batch 1 and decode from its O(1) state against a PREFILL_32K + 1
    prefill (the padded chunk plan); arctic-480b cut to ARCTIC_SERVE_LAYERS
    layers (B4 P64 G16, G = 1 and C = 5; B8 P512 G16, the grouped capacity
    path, G = 32 and C = 2) and jamba-v0.1-52b cut to one superblock (8
    layers: every block kind of the arch; B4 P64 G16), decode vs prefill
    printed, not held (the prefill's capacity drops tokens the dropless
    decode keeps); then decode_f32_check for arctic and jamba."""
    from repro_torch.configs import get_arch
    result, model, params = serve_arch(
        dev, "mamba2-130m", ((4, 64, 32, 3), (8, 512, 64, 3)))
    gen = torch.Generator(device=dev).manual_seed(0)
    result["prefill_32k"] = prefill_32k(dev, model, params, gen)
    del params
    gc_cuda()
    out = {"mamba2-130m": result}
    arctic = dataclasses.replace(get_arch("arctic-480b"),
                                 n_layers=ARCTIC_SERVE_LAYERS)
    jamba = dataclasses.replace(get_arch("jamba-v0.1-52b"), n_layers=8)
    for cfg, shapes in ((arctic, ((4, 64, 16, 1), (8, 512, 16, 1))),
                        (jamba, ((4, 64, 16, 1),))):
        out[cfg.name], _, params = serve_arch(
            dev, cfg.name, shapes, cfg=cfg, gate=False,
            reduced=("n_layers",))
        del params
        gc_cuda()
    for cfg in (dataclasses.replace(arctic, n_layers=1), jamba):
        out[cfg.name]["f32"] = decode_f32_check(dev, cfg)
        gc_cuda()
    return out


def serve_mla_cross_phase(dev) -> dict:
    """The latent-attention and cross-attention archs served bf16 with
    seeded random weights (serve_arch): deepseek-v3-671b cut to
    DEEPSEEK_SERVE_LAYERS layer with its MTP block's params (B4 P64
    G16, B8 P512 G16), then PREFILL_32K at batch 1 (decode_32k's
    context, its batch of 128 cut to 1) and decode from the 512 + 64
    latent cache against a PREFILL_32K + 1 prefill, decode vs prefill
    printed, not held (the prefill's capacity drops tokens the dropless
    decode keeps); llama-3.2-vision-90b cut to VISION_SERVE_LAYERS layers
    (2 superblocks) with its gates at CROSS_GATE (B4 P64 G16, B8 P512
    G16), held to SERVE_REL; then decode_f32_check for deepseek at 1
    layer and DEEPSEEK_F32_EXPERTS experts and for vision at one
    superblock."""
    from repro_torch.configs import get_arch
    ds = get_arch("deepseek-v3-671b")
    ds = dataclasses.replace(ds, n_layers=DEEPSEEK_SERVE_LAYERS)
    out = {}
    out[ds.name], model, params = serve_arch(
        dev, ds.name, ((4, 64, 16, 1), (8, 512, 16, 1)), cfg=ds, gate=False,
        reduced=("n_layers",))
    gen = torch.Generator(device=dev).manual_seed(0)
    out[ds.name]["prefill_32k"] = prefill_32k(
        dev, model, params, gen, gate=False, reduced=("n_layers", "batch"))
    del params, model
    gc_cuda()
    vision = dataclasses.replace(get_arch("llama-3.2-vision-90b"),
                                 n_layers=VISION_SERVE_LAYERS)
    out[vision.name], _, params = serve_arch(
        dev, vision.name, ((4, 64, 16, 1), (8, 512, 16, 1)), cfg=vision,
        reduced=("n_layers",), prepare=set_gates)
    del params
    gc_cuda()
    out[ds.name]["f32"] = decode_f32_check(
        dev, dataclasses.replace(ds, moe=dataclasses.replace(
            ds.moe, num_experts=DEEPSEEK_F32_EXPERTS)),
        reduced=("n_layers", "num_experts", "capacity_factor"))
    gc_cuda()
    out[vision.name]["f32"] = decode_f32_check(
        dev, dataclasses.replace(vision, n_layers=len(vision.block_pattern)),
        reduced=("n_layers",))
    gc_cuda()
    return out


def decode_f32_check(dev, cfg, batch: int = 4, plen: int = 64,
                     gen: int = 3, reduced=("n_layers", "capacity_factor")
                     ) -> dict:
    """``cfg`` in f32 (TF32 off) with capacity_factor = E / K, so the
    prefill's capacity (C = Tg) drops no token (an MoE arch), its
    cross-attention gates at CROSS_GATE and N(0, 1) encoder embeddings
    (a cross arch): a prefill of ``plen`` tokens, ``gen`` greedy decode
    steps from its cache (MoE dropless), and the last step's logits
    against a full prefill of the same prefix within SERVE_F32_REL of
    its largest logit.  ``reduced``: the cuts, printed."""
    from repro_torch.models.model import build_model
    from repro_torch.utils import disable_tf32
    disable_tf32()
    mo = cfg.moe
    cfg = dataclasses.replace(cfg, dtype="float32", moe=None if mo is None
                              else dataclasses.replace(
                                  mo, capacity_factor=mo.num_experts
                                  / mo.top_k))
    model = build_model(cfg)
    gc_cuda()
    torch.cuda.reset_peak_memory_stats(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    params = set_gates(model.init(g, dev), cfg)
    with torch.no_grad():
        toks = torch.randint(0, cfg.vocab_size, (batch, plen), device=dev,
                             generator=g)
        enc = {} if not cfg.num_encoder_tokens else {
            "encoder_embeds": torch.randn(
                (batch, cfg.num_encoder_tokens, cfg.encoder_dim),
                device=dev, generator=g)}
        logits, cache = model.prefill(params, {"tokens": toks, **enc},
                                      cache_len=plen + gen)
        for pos in range(plen, plen + gen):
            toks = torch.cat([toks, logits[:, -1].argmax(-1)[:, None]], 1)
            logits, cache = model.decode_step(params, cache,
                                              toks[:, pos:pos + 1], pos)
        full, _ = model.prefill(params, {"tokens": toks, **enc})
        check = decode_check(logits, full)
    del params, cache
    out = {"batch": batch, "prompt_len": plen, "decode_steps": gen,
           "n_layers": cfg.n_layers, "capacity_factor": None if mo is None
           else cfg.moe.capacity_factor, "decode_vs_prefill": check,
           "tol_rel": SERVE_F32_REL,
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
    emit("serve_f32_decode_check", arch=cfg.name, dtype="float32",
         reduced=list(reduced), **out)
    if check["max_abs_err"] > SERVE_F32_REL * check["max_abs_logit"]:
        raise AssertionError(f"serve {cfg.name} f32: decoding from the "
                             f"cache differs from a full prefill: {check}")
    return out


def main() -> None:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s %(message)s")
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        sys.exit("chip_smoke: run from a checkout of the repository")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    build_phase(smi)
    k1 = k1_phase(dev)
    k6 = k6_phase(dev)
    k2, k2_launches = k2_phase(dev)
    k3 = k3_phase(dev)
    k7, k7_launches = k7_phase(dev)
    bp = bitpack_phase(dev)
    flash_phase(dev)
    moe_phase(dev)
    ssd_phase(dev)
    mla_phase(dev)
    cross_phase(dev)
    n_leaves = len(llama_layout(0.001).compressed)
    K = 2
    from repro_torch.core.autoencoder import ENCODER_SPEC as ENCODER
    fl = train_flags()
    lgc, dgc, packed, buckets, q8, hier = (
        fl[k] for k in ("lgc", "dgc", "packed", "buckets", "q8", "hier"))
    ps = ["--compression", "lgc_ps"] + lgc[2:]
    runs = {
        "lgc_rar": train_phase(
            dev, "lgc_rar", lgc + pg_report_flags("lgc_rar"), 6,
            launched("fused_ef_topk", "matmul_bias_lrelu")),
        # the support set: one encode (K5a) and one decode (K5b) per step
        "lgc_rar ring_packed": train_phase(
            dev, "lgc_rar ring_packed", lgc + packed, 6,
            launched("fused_ef_topk", "matmul_bias_lrelu"),
            per_step(pack_bits=1, unpack_bits=1)),
        "dgc": train_phase(dev, "dgc", dgc, 5,
                           per_step(block_topk=n_leaves * K)),
        # topk: one K4 encode per node, one K5b decode of the gathered
        # table (every node holds the same K payloads)
        "dgc ring_packed": train_phase(
            dev, "dgc ring_packed", dgc + packed, 5,
            per_step(block_topk=n_leaves * K, quantize_pack=K,
                     unpack_bits=1)),
        "sparse_gd": train_phase(
            dev, "sparse_gd", ["--compression", "sparse_gd",
                               "--topk-backend", "fused"], 5,
            launched("fused_ef_topk")),
        # K1 once per node per sparsified step; the leader's common
        # encoding alone goes through K3 (5 launches per compressed step)
        "lgc_ps": train_phase(
            dev, "lgc_ps", ps, 6,
            per_step(fused_ef_topk=K,
                     compressed={"matmul_bias_lrelu": len(ENCODER)})),
        # + the support (K5a, K5b) every sparsified step, and each node's
        # innovations encoded (K4) and their gathered table decoded once
        # (K5b)
        "lgc_ps ring_packed": train_phase(
            dev, "lgc_ps ring_packed", ps + packed, 6,
            per_step(fused_ef_topk=K, pack_bits=1, unpack_bits=1,
                     compressed={"matmul_bias_lrelu": len(ENCODER),
                                 "quantize_pack": K, "unpack_bits": 1})),
        # every node encodes (K3) for the int8 ring's mean
        "lgc_rar_q8 ring_q8": train_phase(
            dev, "lgc_rar_q8 ring_q8", q8 + pg_report_flags(
                "lgc_rar_q8 ring_q8"), 6,
            per_step(fused_ef_topk=K,
                     compressed={"matmul_bias_lrelu": len(ENCODER) * K})),
        # the bucketed int8 ring: the scale blocks regroup per bucket
        "lgc_rar_q8 ring_q8 B4": train_phase(
            dev, "lgc_rar_q8 ring_q8 B4", q8 + buckets, 6,
            per_step(fused_ef_topk=K,
                     compressed={"matmul_bias_lrelu": len(ENCODER) * K})),
        # topk in 4 buckets: one K4 encode per node and bucket, the
        # gathered table of the 4 x K payloads through one K5b launch
        "dgc ring_packed B4": train_phase(
            dev, "dgc ring_packed B4", dgc + packed + buckets
            + pg_report_flags("dgc ring_packed B4"), 5,
            per_step(block_topk=n_leaves * K, quantize_pack=4 * K,
                     unpack_bits=1)),
    }
    # K = 4 nodes on a (2 pod x 2 data) mesh over the hierarchical ring:
    # unbucketed with the garbage collector off, then in 4 buckets
    hier_expect = per_step(fused_ef_topk=2 * K, compressed={
        "matmul_bias_lrelu": len(ENCODER) * 2 * K})
    runs["lgc_rar ring_hier"] = train_phase(
        dev, "lgc_rar ring_hier",
        hier + pg_report_flags("lgc_rar ring_hier"), 6, hier_expect,
        gc_off=True)
    runs["lgc_rar ring_hier B4"] = train_phase(
        dev, "lgc_rar ring_hier B4", hier + buckets, 6, hier_expect)
    hier_runs = [runs["lgc_rar ring_hier"], runs["lgc_rar ring_hier B4"]]
    emit("ring_hier", losses=[r["losses"] for r in hier_runs],
         peak_gib={"B1 collector off": hier_runs[0]["peak_gib"],
                   "B4": hier_runs[1]["peak_gib"]},
         peak_bound_gib=HIER_PEAK_GIB,
         equal=hier_runs[0]["losses"] == hier_runs[1]["losses"],
         compressed_rows={b: r["wire"]["compressed"]
                          for b, r in zip(("B1", "B4"), hier_runs)})
    if hier_runs[0]["losses"] != hier_runs[1]["losses"]:
        raise AssertionError("ring_hier: bucketed losses differ from "
                             "unbucketed")
    if hier_runs[0]["peak_gib"] > HIER_PEAK_GIB:
        raise AssertionError(
            f"ring_hier: peak {hier_runs[0]['peak_gib']} GiB with the "
            f"collector off exceeds {HIER_PEAK_GIB} GiB: a reference cycle "
            "keeps tensors alive")
    pg_train_phase(dev, runs, smi, n_leaves, len(ENCODER))
    # train_4k's sequence length (its batch of 256 cut to 8: 4 sequences
    # a node): flash attention and each block rematerialised
    runs["lgc_rar seq 4096"] = train_phase(
        dev, "lgc_rar seq 4096", lgc + ["--seq", str(TRAIN_SEQ)], 6,
        per_step(fused_ef_topk=K,
                 compressed={"matmul_bias_lrelu": len(ENCODER) * K}),
        reduced=("n_layers", "batch"))
    moe_ssm_train_runs(dev, runs, K, lgc, len(ENCODER))
    mla_cross_train_runs(dev, runs, K, lgc, len(ENCODER))
    guard_runs(dev, runs, n_leaves, K, lgc, dgc, q8)
    resume_run(dev, runs, K, lgc)
    convnet5_phase(dev, runs)
    serve_phase(dev)
    serve_moe_ssm_phase(dev)
    serve_mla_cross_phase(dev)
    packed_b = runs["dgc ring_packed"]["wire"]["topk_ae"]["topk"]
    raw_b = runs["dgc"]["wire"]["topk_ae"]["topk"]
    emit("topk_bytes", packed=packed_b, raw=raw_b,
         packed_to_raw=packed_b["all_gather_packed"] / raw_b["all_gather"])
    emit("lgc_rar_losses", mesh=runs["lgc_rar"]["losses"],
         ring_packed=runs["lgc_rar ring_packed"]["losses"],
         equal=runs["lgc_rar"]["losses"]
         == runs["lgc_rar ring_packed"]["losses"])
    emit("lgc_ps_bytes", **{
        name: {op: runs[name]["wire"]["compressed"][op]
               for op in ("z_common", "innovations")}
        for name in ("lgc_ps", "lgc_ps ring_packed")},
        encoding_ring_q8=runs["lgc_rar_q8 ring_q8"]["wire"]["compressed"][
            "encoding"],
        encoding_mesh=runs["lgc_rar"]["wire"]["compressed"]["encoding"])
    emit("timings", card=smi, fused_ef_topk=k1, matmul_bias_lrelu=k3,
         block_topk=k6, segmented_topk=k2, sparsify_ef=k7, **bp)

    def count(name):
        return sum(r["launches"].get(name, 0) for r in runs.values()) \
            + k2_launches.get(name, 0) + k7_launches.get(name, 0)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    rows = [("fused_ef_topk", "sparsify_ef.cu", "sparsify_ef.py:117", k1),
            ("matmul_bias_lrelu", "matmul_lrelu.cu", "matmul_lrelu.py:46",
             k3),
            ("block_topk", "block_topk.cu", "block_topk.py:53", k6),
            ("segmented_topk", "segmented_topk.cu", "segmented_topk.py:126",
             k2),
            ("quantize_pack", "bitpack.cu", "bitpack.py:112",
             bp["quantize_pack"]),
            ("pack_bits", "bitpack.cu", "bitpack.py:172", bp["pack_bits"]),
            ("unpack_bits", "bitpack.cu", "bitpack.py:206",
             bp["unpack_bits"]),
            ("sparsify_ef", "sparsify_ef.cu", "sparsify_ef.py:59", k7)]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"src/repro_torch/kernels/csrc/{src}",
         "replaces": f"src/repro/kernels/{site}",
         "launches": count(name), **{k: t[k] for k in keys}}
        for name, src, site, t in rows]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--pg-rank"]:
        pg_rank(sys.argv[2])
    else:
        main()
