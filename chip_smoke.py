#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's nvcc; it exits non-zero without a card, and when the port's
sources are not beside it. Phases, each fatal on failure:

1. build the kernels from ``src/repro_torch/csrc`` (one nvcc per source,
   all at once) and print the build seconds and ptxas report;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes and dtypes the main paths give it (K1 also at the float32 grow of
   both AdamW moments, v with the squared operator, and K1, K2 and K3 at
   the quickstart's float32 shapes) and at ragged shapes, and time the
   kernel, the plain version and one library call computing the same
   function, beside the least time the card could take (``bound_ms``):
   K1 (the LiGO blend-expand) and K2 (its backward: dw, dB and dW, each
   checked on its own, K2 taking K1's U and computing dW only where W takes
   a gradient; where the plan puts a group's right expansion between K1's
   U and its blend, each of K1's two steps and K2's two halves), each also
   run twice, to agree bit for bit, and K1's U equal bit for bit to the U
   K2 computes for itself; the same at both vision pairs' groups; on the
   GEMM core they share, the bf16 main-path shapes and an aligned ragged
   bf16 shape must take the tensor-core GEMM, an unaligned bf16 shape and
   the float32 ones the float32 GEMM in the tile and split its plan picks
   (``kernels/_gemm.py::f32_gemm_plan``; one profile of every such call
   must name that instance and no other GEMM); and
   K3 (flash attention: the gpt2-medium and llama3-8b prefills, a sliding
   window, bert-large's bidirectional shape, ragged bf16 and float32 shapes,
   unaligned bf16 rows (at dh 64, 48 and 80), the vision evals at T = 197
   (deit at dh 64, cait at dh 48), and zamba2's exact-length engine
   prefills at B = 1, T = 1, 37 and 509, d_head 80 and 120, with SDPA's
   time; routes checked: bf16 with aligned rows at every dh up to 128 on
   the TMA + wgmma kernel (dh padded to its 64- or 128-wide tile), whose
   V^T pass and kernel are also timed apart under the profiler, float32
   and unaligned rows on the FMA kernel);
3. drive the serving path at full width through its entry point —
   gpt2-base initialised on the card, hot-grown to gpt2-medium, 8 prompts of
   128 tokens prefilled and 31 tokens decoded greedily — with the launch
   counters set to 0 just before and read just after; check that K1
   launched once per eligible group and K3 once per layer of the prefill,
   that the kernel-grown tree matches a grow through the plain path, that
   the prefill logits through K3 match a prefill through the plain
   attention, and that logits and tokens are sane; then profile one warm
   hot-grow on the kernel route (K1's six GEMMs must show as tensor-core
   GEMM launches, none as float32 GEMM launches), and hold the float32 grow of
   both AdamW moments on the kernel route against the plain route, each
   route timed;
3b. drive the serving path of llama3-8b at full width (32 layers, d 4096,
   GQA 32/8, random weights from the seed, no grow): 4 prompts of 2048
   tokens prefilled through K3 and 31 tokens decoded greedily, with the same
   launch, logit and token checks; then profile one warm prefill, and
   hold one more to the K3 check of 14 (c) and 16 (every layer's launch
   routed to the tensor-core kernel; the trace names it and its V^T pass,
   never the FMA kernel);
4. drive the training path at full width through its entry point —
   gpt2-base pretrained 2 AdamW steps, grown to gpt2-medium by 4 LiGO steps
   (K1 forward and K2 backward on every eligible group of every step), then
   4 AdamW steps of gpt2-medium, batch 8 × 128 tokens — with the counters
   set to 0 just before and read just after; check the launch counts (K3
   none: every forward there records autograd), that the supervisor
   restarted nothing, that every loss is finite, and that the LiGO-loss
   gradient at the starting operator is the same on the kernel route and
   the plain route; then profile one LiGO step (K1's product and K2's three
   products of every group must show as tensor-core GEMM launches, none as
   float32 GEMM launches; the right expansions' share of it timed) and one
   train step (``torch.profiler``);
6. drive the trajectory path at full width through the train launcher
   (``--trajectory``, ``--ckpt-dir``, ``--ledger``), with deterministic
   algorithms on: trajectory A trains gpt2-base 4 steps, learns the LiGO
   operator into gpt2-medium for 4 steps (chunks of 2) and trains 4 more,
   batch 8 × 128, checkpointing every 2 steps; trajectory B runs the same
   schedule, dies after its LiGO-phase checkpoint at step 2 and is
   relaunched, and must resume the phase at step 2; A's and B's ledgers
   must be record-identical and their final params and AdamW state (m, v,
   count) bitwise equal; A's launches must be K2 once per group per LiGO
   step and K1 once per group per LiGO step and per grow (params and both
   moments), each twice for a group whose right expansion runs between
   K1's steps; the measured FLOPs of the train steps, of the full-width
   LiGO step on the kernel route (printed beside the plain route's count
   of the same step) and of a kernel-route LiGO step at the JAX package's
   CI shape must lie within [0.5, 2.0] of the 6ND model, and the
   full-width LiGO step's kernel count must be its groups'; a gpt2-medium
   run from scratch gives the savings report's
   baseline; ``serve --ckpt`` of A's directory must prefill through 24 K3
   launches to logits bitwise equal to A's final params; and the
   checkpoint size, write and restore ms and the ledger's cost are printed;
7. run the quickstart twin (``repro_torch.examples.quickstart``) at the
   script's own widths and 50 LiGO steps, its small model's pretraining
   cut to 100 steps and each finetune to 20: LiGO's initial loss must be
   below scratch's;
8. run the paper's vision pairs at full width, bf16, batch 32 images:
   deit-s -> deit-b (12 layers, d 384 -> 768, 6 -> 12 heads, 197 tokens,
   1000 classes) and cait-xs -> cait-s (24 layers, d 288 -> 384, dh 48, at
   fewer steps): the source from a seeded generator, AdamW steps on
   ``dummy_batch`` batches, a LiGO phase (K1 forward, K2 backward),
   ``grow()`` with the AdamW moments (K1), an autograd-free eval forward
   of the grown model (K3, bidirectional at T = 197) and AdamW steps of
   it, with the counters set to 0 just before and read just after (each
   kernel launched, in the counts the plan gives); the same on the plain
   route in bf16 and in float32, the kernel route's LiGO and target losses,
   eval loss and grown tree held against them; the vision LiGO step's
   measured / modelled FLOPs printed on both routes;
9. drive the live serving engine at full width, bf16, under the
   deterministic algorithms of phase 6: (a) ``serve --live-grow-at 8``,
   gpt2-base -> gpt2-medium, 8 slots, 16 requests of 64-128 tokens, 32 new
   tokens, paged KV, the grow (K1) in a background thread on its own
   stream: the hop must complete on attempt 1 by re-prefill, every
   request done, none dropped, K1 launched for ``warm()`` (its eager
   fill, then one timed replay of the grow it captured into a CUDA graph;
   the capture counts none) and the hop (one replay), 3 x a grow's, and
   K3 once per layer of every prefill and re-prefill the engine counted;
   (b) the same run with the hop synchronous on the kernel route and on
   the plain route: first-token logits within the bf16 tolerance; (c)
   paged against dense on the kernel route; (d) a LEMON hop gpt2-medium ->
   gpt2-medium-ff2 (the cache grows in place) against a run with no hop;
   (e) chaos at every hop stage at smoke size, each rollback's cause the
   injected one; (f) llama3-8b (phase 3b's params) through the engine,
   4 slots, prompts of 1024-2048 tokens, 16 new, with a profiled decode
   step;
10. speculative decoding through the live hop, under phase 9's settings
   (auto-disable off): (a) ``serve --live-grow-at 8 --hop-sync
   --speculative 4`` (9 (b)'s run, gpt2-base drafting 4 tokens a round for
   gpt2-medium): every request's tokens equal 9 (b)'s, one draft and one
   verify build, K1 21 and K3 9 (b)'s plus one a layer for every drafter
   prefill; the acceptance, the speedup estimate, draft and verify ms a
   round and decode tok/s after the hop with and without speculation
   printed; (b) the same dense, tokens equal 9 (c)'s; (c) the LEMON hop
   with speculation (first-round acceptance printed) and the reference
   test's float32 pair on the card (first round 1.0); (d) sampled,
   temperature 0.8, top-p 0.9, 16 new tokens: one seed repeats, another
   differs; (e) a
   second hop failing at swap while the smoke pair drafts: rolled back for
   the injected cause, 0 dropped, 0 rejected, the retry landing;
11. the observability layer through both launchers' flags, under phase
   9's settings: (a) 9 (a)'s background-hop serve with ``--fail-at-hop
   cache-grow --obs-log --obs-report --timeline --metrics-port 0``: the
   log opens and closes with its meta lines and holds ``hop.warm``,
   ``hop.begin``, two ``hop.grow`` spans on ``hop-grow-N`` threads,
   ``hop.cache-grow`` failing on attempt 1 and re-prefilling on attempt 2,
   one ``hop.rollback`` (cache-grow, 0 dropped), one ``hop.retry``,
   ``hop.swap``, ``serve.install``, ``hop.complete`` and one
   ``serve.prefill`` span per admission; exactly one
   ``flightrec-*-hop-cache-grow.jsonl``; the timeline's ``B``/``E``
   matched on every tid, one async pair per ``hop.*`` span; a scrape of
   ``/metrics`` before shutdown counts the engine's decode steps; the
   report prints the hop stages; K1 28 (``warm()``'s fill and replay, and
   two replays) and K3
   by the engine's prefill counters; (b) ``train --trajectory`` (gpt2-base
   2 steps, LiGO into gpt2-medium 2 steps in chunks of 1, gpt2-medium 2
   steps, batch 8 x 128) with ``--ledger --obs-log --timeline
   --obs-report``: 2 ``ligo.chunk``, at least 1 ``ligo.checkpoint``, 2
   ``traj.train`` and 1 ``traj.grow`` spans, the histograms' counts the
   same, the timeline's ledger track one loss point a step; (d) (a)'s
   serve without the obs flags and with ``obs.set_enabled(False)``, decode
   step p50/p99 printed beside (a)'s (not gated); (c) last, (a)'s serve cut
   to 4 requests of 16 new tokens with ``--obs-profile``: the Chrome trace
   names K1's tensor-core GEMM and ``flash_fwd_wgmma``;
12. the adaptive growth controller through ``train --autogrow`` at full
   width, under phase 6's deterministic algorithms (run before phase 11,
   whose profiler slows the host for the rest of the process): a schedule
   of gpt2-base under a ``probe`` policy (tol 1.0, so it fires at stage
   step 3; candidates ligo, stackbert and interpolation, 4 probe steps, 2
   LiGO steps for the ligo candidate) and gpt2-medium under ``rpf_decay``
   to its cap of 4 steps, batch 8 x 128, ``--ledger``: A uninterrupted, B
   paused at global step 2 and relaunched. The decision at stage step 3,
   finite scores, ``picked`` their argmin and the ledger's ``probe`` and
   ``hop.begin`` events naming it; A's and B's decisions and scores
   bit-equal, ledgers record-identical, final params and AdamW state
   bitwise equal; ``cum_flops`` in the checkpoints' telemetry snapshots
   the measured FLOPs of a step added once a step; A's post-growth
   snapshot bitwise ``grow()`` of the stage-end state (a static twin of
   stage 0 paused at step 3) with the picked method; K1 and K2 launches
   as the plan predicts for the three candidates and the committed hop
   (printed before the run); ``--trajectory`` refusing the schedule;
   each candidate's probe wall and the phase's peak memory printed;
13. the MoE family at full width, under phase 6's deterministic
   algorithms (after phase 12, before phase 11): (a) ``serve --arch
   phi4-mini-3.8b --live-grow-at 8 --hop-operator upcycle`` (16 requests
   of 64-128 tokens through 8 slots, 16 new, paged): the dense model hops
   to its MoE twin (E 4, top 2) with 0 dropped and 0 rejected, the cache
   grown in place, K1 launched once per kernel-route group of the plan
   for each of warm()'s fill, its replay and the hop's replay, the served
   tree bitwise the plain route's, the E
   expert copies bitwise equal and the router a float32 zero; decode
   p50/p99 before and after the hop, the peak memory and the grown tree
   the graph's pool holds from warm() to the swap printed; (b) the
   upcycled model's first-token logits against the dense model's at a
   capacity of E/k = 2.0 (no token dropped), and the dropped share at the
   inherited 1.25 printed; (c) ``grow(method="ligo", ligo_steps=2)`` from
   ``half_config(mixtral-8x7b)`` cut to 2 layers into mixtral cut to 4
   (full width), K1 and K2 launches as the plan predicts, a 4608-token
   prefill past the 4096 window through K3 against the plain route and 8
   decode steps through the ring cache, then K1 and K2 against their
   plain versions at the expert groups' shapes (E 8) and the float32
   router's (Bd 8); (d) qwen3-moe-30b-a3b at its 48 layers (or the
   deepest cut leaving 10 GB free): a 4 x 2048 prefill through K3 against
   the plain attention route, and 8 decode steps;
14. the GQA merge and the sequence-mixer families at full width, bf16
   (after phase 13, before phase 11): (a) ``grow(method="gqa_merge")`` of
   llama3-8b's MHA twin (kv 32) into llama3-8b (kv 8), both cut to 4
   layers: K1 once per plan group, the merged tree against the plain
   route, both AdamW moments on K1's float32 route against the plain route
   (1e-5), a 4 x 2048 prefill of the merged model through K3 (G = 4)
   against the plain attention; (b) ``serve --arch xlstm-125m --grow-to
   2x`` lock-step (24 layers, d 1152; 4 x 2048 prompts, 32 new tokens):
   K1 once per plan group, the grown tree against the plain route, the
   decode logits against one full forward (float32 copy, 1e-4); one LiGO
   step xlstm-125m -> its grow_target through K1 and K2 (launches as the
   plan predicts, a finite loss) and its measured / modelled FLOPs
   printed; K1 and K2 against their plain versions at every group shape of
   that step (the seg groups, the gates' Bd 8); (c) ``serve --arch
   zamba2-2.7b`` at all 54 layers (4 x 2048): 9 K3 launches at d_head 80,
   the prefill against the plain attention route, one warm prefill
   profiled (all 9 launches routed to the tensor-core kernel; the trace
   names it and its V^T pass, never the FMA kernel); ``--grow-to 2x`` to 108
   layers x 3840 (K1 once per plan group, the tree against the plain
   route, 2 x 1024 prompts through K3 at d_head 120); one LiGO step from a
   6-layer cut (one shared-attention group) to 12 layers x 3840 through K1
   and K2, its FLOP ratio printed, and K1 and K2 at its group shapes;
15. the live engine on the recurrent families at full width, under phase
   6's deterministic algorithms (after phase 14, before phase 11): (a)
   ``serve --arch xlstm-125m --grow-to 2x --live-grow-at 8`` (8 slots, 16
   requests of 32-64 tokens, 16 new): each prompt prefilled at its exact
   length, the hop in the
   background re-prefilling every live history, 0 dropped, 0 rejected, K1
   once per plan group at ``warm()``'s fill and replay and at the hop's
   replay, no K3; (b) the same
   for zamba2-2.7b at 54 layers (4 slots, 8 requests of 256-512 tokens, 8
   new) hopping to 108 x 3840: K1 likewise, K3 once per shared-block
   insertion of every prefill and re-prefill the engine counted, then K3
   against its plain version at every exact length it was sent; (c) the
   runs of (a) and (b) in float32 through the engine API ((a) with 8
   requests and 3 more of 1, 2 and 5 tokens, zamba2 cut to 12 layers), the
   hop
   synchronous: each request's greedy tokens equal to
   a lock-step ``prefill`` + ``decode_step`` of the same models at its
   true length, its first-token logits and its logits on its first step
   after the swap within 1e-4; (d) chaos at cache-grow on (a)'s model,
   the hop synchronous: one rollback, the engine's state bitwise as it was
   before the failing poll, the retry landing with 0 dropped. Decode
   p50/p99 before, during and after each hop, its stage walls, the state
   a slot holds and the peak memory printed;
16. the audio and VLM families at full width, under phase 6's
   deterministic algorithms (after phase 15, before phase 11): (a)
   hubert-xlarge (48 x 1280, 16 heads of 80, bidirectional) grown from its
   half model (24 x 640) by 2 LiGO steps on target-width batches of 8 x
   512 frames, 15 % masked, then ``grow()`` with the AdamW moments and an
   autograd-free encode (K3 once a layer, the tensor cores at d_head 80;
   one warm encode profiled as 14 (c)'s prefill, 48 launches) and
   its MLM loss at the masked frames; the same on the bf16 and float32
   plain routes, the kernel route held against them as phase 8 holds the
   vision pairs; K1, K2 and K3 launches as the plan and the layers
   predict; the LiGO step's FLOP ratio printed; (b) qwen2-vl-72b at full
   width cut to 8 layers (9.51 B) hot-grown through K1 from its half model
   cut to 4 (4096 wide, 64 heads of 64), the tree against the plain
   route; a 4 x 2048 prefill through K3 (once a layer, 64/8 heads at
   d_head 128, the tensor cores) whose first 256 tokens are patch
   embeddings on Qwen2-VL's 16 x 16 grid positions, held against the plain
   attention route in bf16 and float32, then 31 greedy decode steps with
   positions; the same prefill check in the launcher's form
   (``serve.lockstep_batch``: zero patches, arange positions); one LiGO
   step from the half model cut to 2 layers into the target cut to 4 at 4
   x 512 tokens (256 of them patches) through K1 and K2, its FLOP ratio
   printed; the peak memory printed (the cut shrinks if the card cannot
   leave 10 GB free); (c) ``serve --arch qwen2-vl-72b --smoke --grow-to
   2x`` through the launcher, float32, on the kernel route and on the
   plain route: greedy tokens equal, logits within 1e-4. Phase 2 holds K1
   and K2 at every group shape of (a) and (b) and K3 at hubert's encode
   (d_head 80, and 40 for its half model) and qwen2-vl's prefill (d_head
   128, and 64 for its half model);
17. the serving example's twin (``repro_torch.examples.serve_decode``),
   under phase 6's deterministic algorithms (after phase 16, before phase
   11): (a) its ``__main__`` as the JAX script runs it (llama3-8b,
   mixtral-8x7b, zamba2-2.7b and xlstm-125m at ``smoke_config``, float32,
   batch 2, 48-token prompts, 12 new tokens) on the kernel route and on
   the plain route: tokens equal, logits within 1e-5, K3 once per
   attention layer of each prefill; (b) its ``serve()`` at full width in
   bf16, batch 2, 12 new tokens: llama3-8b whole on 512-token prompts (K3
   32), mixtral cut to 4 layers on 4160-token prompts past its 4096 window
   (K3 4, the ring holding the window), zamba2-2.7b at 54 layers (K3 9 at
   d_head 80) and xlstm-125m whole (no K3) on 512-token prompts, each
   prefill held to the plain attention route (the MoE with its expert
   choices replayed), decode tok/s, the cache's kind, rows and bytes a
   slot, and the peak memory printed; (c) mixtral's 4-layer cut in
   float32 at capacity E/k: the prefill and 11 decode steps' logits
   through the ring against one windowed forward of the prompt and the
   generated tokens on the plain route, with the serve run's expert
   choices replayed, within 1e-4; (d) the JAX package's public kernel
   wrappers on CUDA tensors against their plain versions: ``ligo_blend_
   expand`` and ``ligo_grow`` at one gpt2-base -> gpt2-medium leaf (bf16
   and float32), ``ligo_blend_expand_vjp``'s forward and gradients (one K1
   and one K2 launch), ``ligo_blend_expand_bwd_fused`` (K2),
   ``flash_attention`` at llama3-8b's prefill shape, each call's launches
   and ``LAUNCH_COUNTS`` counted; then K3 against its plain version at
   every shape (a)-(c) sent it;
5. print, last, the kernels' JSON line, the card's name and power limit,
   and the result line ``{"ok": true, "device": {...}}``.

Float32 matrix products run in full float32 here
(``torch.backends.cuda.matmul.allow_tf32 = False``).
"""
import importlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import urllib.request

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")

# Peak rates of one H100 SXM (data sheet, dense): bf16 tensor cores, f32 FMA
# pipes, HBM3. Used only to compute bound_ms.
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# Normalised tolerance (max |kernel - plain| / max |plain|): bf16 output is
# rounded once from an f32 sum on both sides, so the two may differ by an
# ulp of bf16 (2^-8 relative) where the sums round differently; f32 differs
# only by summation order.
TOL = {"bfloat16": 1e-2, "float32": 1e-5}

# K3 against its plain version: the JAX kernel test's tolerance
# (tests/test_kernels.py::test_flash_attention), elementwise
# |kernel - plain| <= tol + tol |plain|.
K3_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# name, dtype, (B, H, KV, T, S, dh, causal, window[, pad]): q, k and v are
# made in the model's (B, T, heads, dh) layout, with `pad` more elements in
# each row of the storage (default 0). bf16 with 16-byte aligned rows takes
# the tensor cores (flash_fwd_wgmma) at every dh up to 128, padded to the
# kernel's 64- or 128-wide tile; float32 and unaligned rows take the FMA
# kernel. "bf16 ragged" puts T off the 128-row tile and T != S; "bf16
# ragged window" puts S off a multiple of 8 (the V^T pad and TMA's zero
# fill past S); "bf16 unaligned rows" has 136-byte rows, so the FMA kernel,
# as have the two unaligned rows at dh 48 and 80 (the FMA kernel's bf16
# bodies at 16 and 32 columns a thread); "quickstart eval" is the
# quickstart's evaluation of its grown model.
K3_SHAPES = [
    ("gpt2-medium prefill", "bfloat16", (8, 16, 16, 128, 128, 64, True, 0)),
    ("llama3-8b prefill", "bfloat16", (4, 32, 8, 2048, 2048, 128, True, 0)),
    ("sliding window", "bfloat16", (1, 32, 8, 4096, 4096, 128, True, 1024)),
    ("bert-large bidir", "bfloat16", (8, 16, 16, 512, 512, 64, False, 0)),
    ("ragged", "float32", (2, 6, 2, 200, 328, 64, True, 0)),
    ("ragged window", "float32", (2, 6, 2, 200, 328, 64, True, 100)),
    ("gpt2-medium f32", "float32", (8, 16, 16, 128, 128, 64, True, 0)),
    ("bf16 ragged", "bfloat16", (2, 6, 2, 200, 328, 128, True, 0)),
    ("bf16 ragged window", "bfloat16", (2, 6, 2, 77, 333, 64, True, 100)),
    ("bf16 unaligned rows", "bfloat16", (2, 6, 2, 200, 328, 64, True, 0, 4)),
    ("bf16 unaligned dh48", "bfloat16", (2, 6, 2, 200, 328, 48, True, 0, 4)),
    ("bf16 unaligned dh80", "bfloat16", (2, 6, 2, 200, 328, 80, False, 0, 4)),
    ("quickstart eval", "float32", (32, 8, 8, 64, 64, 16, True, 0)),
    # phase 8's eval forwards, bidirectional over the cls token and 196
    # patches (T = 197, off the 128-row tile): deit-b (its main path) and
    # deit-s at dh 64 and cait-s at dh 48 (padded to 64), on the tensor cores
    ("deit-b eval", "bfloat16", (32, 12, 12, 197, 197, 64, False, 0)),
    ("deit-s", "bfloat16", (32, 6, 6, 197, 197, 64, False, 0)),
    ("cait-s eval", "bfloat16", (32, 8, 8, 197, 197, 48, False, 0)),
    # phase 9's engine: one prefill per admitted request, right-padded to
    # the prompt budget (gpt2-base before the hop, gpt2-medium after it,
    # llama3-8b), and one re-prefill per live session at max_len = 160
    # after the LiGO hop
    ("engine prefill gpt2-base", "bfloat16", (1, 12, 12, 128, 128, 64, True, 0)),
    ("engine prefill gpt2-medium", "bfloat16",
     (1, 16, 16, 128, 128, 64, True, 0)),
    ("engine re-prefill gpt2-medium", "bfloat16",
     (1, 16, 16, 160, 160, 64, True, 0)),
    ("engine prefill llama3-8b", "bfloat16",
     (1, 32, 8, 2048, 2048, 128, True, 0)),
    # phase 13: the engine's phi4-mini-3.8b prefills before and after the
    # upcycle hop (the MoE twin keeps the attention), (b)'s 4 x 128
    # prefills, mixtral's 4608-token prefill past its 4096 window and
    # qwen3-moe's 4 x 2048 prefill (32 query heads of 128: q width 4096,
    # twice d_model)
    ("engine prefill phi4-mini-3.8b", "bfloat16",
     (1, 24, 8, 128, 128, 128, True, 0)),
    ("phi4-mini prefill", "bfloat16", (4, 24, 8, 128, 128, 128, True, 0)),
    ("mixtral prefill window", "bfloat16",
     (1, 32, 8, 4608, 4608, 128, True, 4096)),
    ("qwen3-moe prefill", "bfloat16", (4, 32, 4, 2048, 2048, 128, True, 0)),
    # phase 14: zamba2-2.7b's shared attention block at d_head 80 (4 x 2048,
    # all 54 layers) and, grown 2x, at d_head 120 (2 x 1024): the tensor
    # cores, dh padded to the 128-wide tile
    ("zamba2 prefill", "bfloat16", (4, 32, 32, 2048, 2048, 80, True, 0)),
    ("zamba2-grown prefill", "bfloat16",
     (2, 32, 32, 1024, 1024, 120, True, 0)),
    # phase 15: the engine prefills a recurrent family's prompt (and
    # re-prefills its history) at its exact length, B = 1: T off the
    # kernel's tiles, at zamba2's d_head 80 and, grown, 120 (tensor cores)
    ("zamba2 engine T=1", "bfloat16", (1, 32, 32, 1, 1, 80, True, 0)),
    ("zamba2 engine T=37", "bfloat16", (1, 32, 32, 37, 37, 80, True, 0)),
    ("zamba2 engine T=509", "bfloat16", (1, 32, 32, 509, 509, 80, True, 0)),
    ("zamba2-grown engine T=1", "bfloat16",
     (1, 32, 32, 1, 1, 120, True, 0)),
    ("zamba2-grown engine T=37", "bfloat16",
     (1, 32, 32, 37, 37, 120, True, 0)),
    ("zamba2-grown engine T=509", "bfloat16",
     (1, 32, 32, 509, 509, 120, True, 0)),
    # phase 16: hubert-xlarge's autograd-free encode of 8 x 512 frames
    # (bidirectional, d_head 80) and its half model's (d_head 40, padded to
    # 64); qwen2-vl-72b's 4 x 2048 prefills (64 query heads over 8, d_head
    # 128) and its half model's (d_head 64); all on the tensor cores
    ("hubert encode", "bfloat16", (8, 16, 16, 512, 512, 80, False, 0)),
    ("hubert-half encode", "bfloat16", (8, 16, 16, 512, 512, 40, False, 0)),
    ("qwen2-vl prefill", "bfloat16", (4, 64, 8, 2048, 2048, 128, True, 0)),
    ("qwen2-vl-half prefill", "bfloat16",
     (4, 64, 8, 2048, 2048, 64, True, 0)),
]

# K1's and K2's shapes besides the main path's six groups (gpt2-base ->
# gpt2-medium, read from the GrowthPlan, seeds 100 + i for K1 and 200 + i
# for K2): name, dtype, (G, L2, L1, E, I, A, Bd), seed. "pinned" (I * Bd
# odd) takes the scalar paths of both kernels' blends; "aligned ragged"
# takes the tensor-core GEMM with TMA's zero fill at every edge; "unaligned"
# is bf16 on the float32 GEMM.
K1_EXTRA_SHAPES = [
    ("ragged", "float32", (3, 5, 3, 2, 200, 50, 130), 99),
    ("pinned", "float32", (1, 1, 1, 2, 1, 50, 45), 92),
    ("aligned ragged", "bfloat16", (2, 5, 3, 2, 200, 136, 72), 94),
    ("unaligned", "bfloat16", (2, 5, 3, 2, 200, 50, 130), 93),
]
K2_EXTRA_SHAPES = [
    ("ragged", "float32", (3, 5, 3, 2, 200, 50, 130), 98),
    ("pinned", "float32", (1, 1, 1, 2, 1, 50, 45), 97),
    ("aligned ragged", "bfloat16", (2, 5, 3, 2, 200, 136, 72), 96),
    ("unaligned", "bfloat16", (2, 5, 3, 2, 200, 50, 130), 95),
]

MAIN_ARGS = ["--arch", "gpt2-base", "--grow-to", "gpt2-medium", "--batch", "8",
             "--prompt-len", "128", "--gen", "32"]
LLAMA_ARGS = ["--arch", "llama3-8b", "--batch", "4", "--prompt-len", "2048",
              "--gen", "32"]
LIGO_STEPS = 4
TRAIN_ARGS = ["--arch", "gpt2-medium", "--grow-from", "gpt2-base", "--method",
              "ligo", "--pretrain-steps", "2", "--ligo-steps", str(LIGO_STEPS),
              "--steps", "4", "--batch", "8", "--seq", "128"]


# K2's min-FLOP library order is timed only where its dw contraction
# (E·I·Bd products an output) is at most this long
MINFLOP_MAX_ROWS = 10 ** 8

# A call longer than this is timed once: repeating it would spend seconds
# of the script's time limit (the float32 plain K2 at mixtral's and
# qwen2-vl-72b's widest groups takes 7-14 s a call) to save set-up costs
# far smaller than that (SDPA's first calls, the longest set-up seen, take
# under 1.6 s).
LONG_CALL_MS = 5000.0


def _timed(torch, fn):
    """(fn(), its ms by CUDA events)."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def _time_ms(torch, fn, reps, first_ms=None):
    """Mean ms of ``reps`` calls of ``fn`` after one warm-up call.
    ``first_ms``: the ms of a call the caller has just made on the same
    inputs, which is then the warm-up. A warm-up over LONG_CALL_MS is the
    time."""
    if first_ms is None:
        _, first_ms = _timed(torch, fn)
    if first_ms > LONG_CALL_MS:
        return first_ms
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _k1_shapes(torch, cfg1, cfg2):
    """One dict per kernel-route group of the pair's GrowthPlan: name, G,
    the leaves' dtype (an MoE router is float32 in a bf16 model), L2 (in
    the target's kind: an upcycle hop lands "attn" groups in "moe"), L1, E,
    I, A, the source width b and target width j of its right
    expansion (j None where it has none), and where the plan puts that
    expansion for a forward alone (``right``) and for a LiGO step
    (``right_grad``)."""
    from repro_torch.core.ligo import _kind_counts
    from repro_torch.core.plan import _expr_dims, plan_for
    from repro_torch.models.model import init_params
    from repro_torch.core.ligo import _flatten
    params = init_params(cfg1, torch.Generator().manual_seed(0),
                         device="meta")
    plan = plan_for(cfg1, cfg2, params)
    leaves = {kind: _flatten(stack)
              for kind, stack in params["layers"].items()}
    shapes = []
    for g in plan.groups:
        if not g.kernel_ok:
            continue
        j = (_expr_dims(plan.exprs[g.out_ref], cfg1, cfg2)[0]
             if g.out_ref else None)
        shapes.append({
            "name": "+".join(g.paths), "G": len(g.paths),
            "dtype": leaves[g.kind][g.paths[0]].dtype,
            "L2": _kind_counts(cfg2)[g.dst_kind], "L1": g.shape[0],
            "E": g.shape[1] if len(g.shape) == 4 else 1,
            "I": _expr_dims(plan.exprs[g.in_ref], cfg1, cfg2)[0],
            "A": g.shape[-2], "b": g.shape[-1], "j": j,
            "right": g.right if j else None,
            "right_grad": g.right_grad if j else None})
    return shapes


def _dims(sh, Bd):
    return (sh["G"], sh["L2"], sh["L1"], sh["E"], sh["I"], sh["A"], Bd)


def _k1_calls(sh, grad):
    """K1's launches in one forward of the group: [(stage, dims)]."""
    place = sh["right_grad" if grad else "right"]
    if place == "between":
        return [("expand", _dims(sh, sh["b"])), ("blend", _dims(sh, sh["j"]))]
    return [("both", _dims(sh, sh["j"] if place == "before" else sh["b"]))]


def _k2_calls(sh):
    """K2's launches in one LiGO backward of the group: [(kind, dims,
    need_dW)]: the whole of K2 (from K1's U), or its two halves around a
    right expansion between K1's U and its blend. W takes a gradient only
    where the expansion runs before K1."""
    place = sh["right_grad"]
    if place == "between":
        return [("blend", _dims(sh, sh["j"]), False),
                ("products", _dims(sh, sh["b"]), False)]
    return [("whole", _dims(sh, sh["j"] if place == "before" else sh["b"]),
             place == "before")]


def _kernel_operations(shapes):
    """K1's and K2's operation counts over one LiGO step of the groups."""
    from repro_torch.kernels import ligo_expand, ligo_expand_bwd
    n = 0
    for sh in shapes:
        for stage, d in _k1_calls(sh, True):
            n += ligo_expand.operation_count(*d, stage=stage)
        for kind, d, need_dW in _k2_calls(sh):
            n += ligo_expand_bwd.operation_count(
                *d, u_given=kind != "products", need_dW=need_dW,
                q_given=kind == "products", need_dB=kind != "blend",
                need_dw=kind != "products")
    return n


def _launches(shapes, grad):
    """(K1, K2) launches of one forward (and, with ``grad``, backward)."""
    return (sum(len(_k1_calls(sh, grad)) for sh in shapes),
            sum(len(_k2_calls(sh)) for sh in shapes) if grad else 0)


def _k1_checks(shapes):
    """The distinct K1 checks the groups' forwards need, with and without
    gradients: (name, dims, j), j the width of a right expansion between
    K1's U and its blend."""
    out = {}
    for sh in shapes:
        for grad in (False, True):
            calls = _k1_calls(sh, grad)
            key = (sh["name"], calls[0][1],
                   calls[1][1][-1] if len(calls) == 2 else None)
            out.setdefault(key, None)
    return [(name, d, j) for name, d, j in out]


def _k2_checks(shapes):
    """The K2 checks of the groups' LiGO backward: (name, dims, j,
    need_dW), j as in :func:`_k1_checks`."""
    out = []
    for sh in shapes:
        calls = _k2_calls(sh)
        if len(calls) == 2:
            out.append((sh["name"], calls[1][1], calls[0][1][-1], False))
        else:
            out.append((sh["name"], calls[0][1], None, calls[0][2]))
    return out


def _ligo_inputs(torch, dtype, G, L2, L1, E, I, A, Bd, seed, cotangent):
    """w, B, W (and dP where ``cotangent``) of a K1 or K2 check, on the card
    from ``seed``: blend rows and expander rows of norm ~1, so the output is
    of unit scale."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn((G, L2, L1), generator=gen, device="cuda") / L1 ** 0.5
    B = (torch.randn((I, A), generator=gen, device="cuda") / A ** 0.5
         ).to(dtype)
    W = torch.randn((G, L1, E, A, Bd), generator=gen, device="cuda").to(dtype)
    if not cotangent:
        return w, B, W
    dP = torch.randn((G, L2, E, I, Bd), generator=gen, device="cuda").to(dtype)
    return w, B, W, dP


def _norm_err(got, want):
    diff = (got.float() - want.float()).abs().max().item()
    return diff, diff / (want.float().abs().max().item() + 1e-30)


def _expanded(torch, U, R, dtype):
    """U Rᵀ as the plan's between placement computes it: U rounded to the
    working dtype, one matmul, read back in float32."""
    return (U.to(dtype).reshape(-1, U.shape[-1]) @ R.T).reshape(
        U.shape[:-1] + (R.shape[0],)).float()


# (product tag, f32 tile) -> [launches wanted, traced]: every float32-GEMM
# call of phase 2's K1 and K2 checks, profiled once (``_trace_f32``) while
# TRACE_F32[0]
F32_TRACE = {}
TRACE_F32 = [True]


def _f32_name(plan):
    """The float32 GEMM instance of a plan, as the rows print it."""
    from repro_torch.kernels._gemm import F32_TILES
    bm, bn = F32_TILES[plan.tile]
    return f"f32 {bm}x{bn}" + (f" split {plan.split}" if plan.split > 1
                               else "")


def _trace_f32(torch, fn, want):
    """``fn()`` once more under the profiler (device kernels only): add its
    GEMM launches by (core, product tag, f32 tile) to F32_TRACE beside
    ``want`` {(tag, tile): n}, the instances the f32 plans predict. A GEMM
    of another core, or the old FMA kernel's name, fails at once; the
    counts are held at the end of phase 2 (:func:`_check_f32_trace`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    for key, n in want.items():
        F32_TRACE.setdefault(key, [0, 0])[0] += n
    for e in prof.key_averages():
        m = re.search(r"ligo_(\w+)_gemm_kernel<(\d+), (\w+)", e.key)
        if not m or e.device_type != DeviceType.CUDA:
            continue
        if m.group(1) != "f32":
            raise AssertionError(f"a float32-route call launched "
                                 f"{e.key[:80]}: want only the f32 GEMM")
        key = (int(m.group(2)), int(m.group(3)))
        F32_TRACE.setdefault(key, [0, 0])[1] += e.count


def _check_f32_trace():
    """Every (product, tile) instance the f32 plans predicted was traced,
    none unplanned, none more often than planned (the profiler can lose a
    record that was launched: :func:`_check_gemm_launches`)."""
    print(f"[f32] float32 GEMM launches by (product tag, tile): traced / "
          f"planned {dict((k, (v[1], v[0])) for k, v in F32_TRACE.items())}",
          flush=True)
    bad = {k: v for k, v in F32_TRACE.items()
           if v[1] > v[0] or (v[0] and not v[1])}
    if bad:
        raise AssertionError(f"float32 GEMM trace against its plans: {bad}")


def _check_k1(torch, name, dtype, G, L2, L1, E, I, A, Bd, seed,
              square=False, j=None):
    """K1 against its plain version; ``square`` gives it the inputs of an
    AdamW second moment's grow: the squared blend and expander, and a
    moment that is not negative. With ``j``, the group's right expansion
    (Bd -> j) runs between K1's two steps, as the plan runs it: each step
    is held against its plain version on the same inputs (the blend on
    the expanded U of the kernel's own U)."""
    from repro_torch.kernels import ligo_expand, ref
    w, B, W = _ligo_inputs(torch, dtype, G, L2, L1, E, I, A, Bd, seed, False)
    if square:
        w, B, W = w * w, B * B, W * W
    tname = str(dtype).replace("torch.", "")
    Bj = j or Bd                            # the blend's width
    if j:
        gen = torch.Generator(device="cuda").manual_seed(seed + 1000)
        R = (torch.randn((j, Bd), generator=gen, device="cuda")
             / Bd ** 0.5).to(dtype)
        if square:
            R = R * R
        UR = _expanded(torch, ligo_expand.ligo_expand(B, W), R, dtype)

        def kernel():
            return (ligo_expand.ligo_expand(B, W),
                    ligo_expand.ligo_blend(w, UR, dtype))

        def plain():
            return (ref.ligo_expand_ref(B, W),
                    ref.ligo_blend_ref(w, UR, dtype))

        def library():   # K1's two steps as a batched matmul and einsum
            return (torch.matmul(B, W),
                    torch.einsum("gkl,gleib->gkeib", w.to(dtype),
                                 UR.to(dtype)))
        library_minflop = library
    else:
        def kernel():
            return (ligo_expand.ligo_blend_expand_grouped(w, B, W),)

        def plain():
            return (ref.ligo_blend_expand_grouped_ref(w, B, W),)

        def library():   # einsum blend in the working dtype, then a matmul
            bl = torch.einsum("gkl,gleab->gkeab", w.to(dtype), W)
            return (torch.matmul(B, bl),)

        def library_minflop():   # K1's own order: a batched matmul, blend
            return (torch.einsum("gkl,gleib->gkeib", w.to(dtype),
                                 torch.matmul(B, W)),)

    got = kernel()
    want, plain_first = _timed(torch, plain)
    again = kernel()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"K1 is not deterministic at {name}: two runs "
                             f"on the same inputs differ")
    del again
    errs = [_norm_err(a, b) for a, b in zip(got, want)]
    diff, norm = max(e[0] for e in errs), max(e[1] for e in errs)
    ok = norm <= TOL[tname] and all(bool(torch.isfinite(x).all())
                                    for x in got)
    # The bound counts the fewest operations the function needs
    # (ligo_expand.least_operations: the least of blend-then-expand and
    # K1's own expand-then-blend); split, K1's two steps as they run.
    if j:
        k1_flops = (ligo_expand.operation_count(G, L2, L1, E, I, A, Bd,
                                                stage="expand")
                    + ligo_expand.operation_count(G, L2, L1, E, I, A, j,
                                                  stage="blend"))
        flops = k1_flops
    else:
        k1_flops = ligo_expand.operation_count(G, L2, L1, E, I, A, Bd)
        flops = ligo_expand.least_operations(G, L2, L1, E, I, A, Bd)
    tc = ligo_expand.tensor_core_route(dtype, I, A, Bd)
    plan = ligo_expand.f32_gemm_plan(I, Bd, A, 1, G * L1 * E)
    gemm = "wgmma" if tc else _f32_name(plan)
    if not tc and TRACE_F32[0]:
        _trace_f32(torch, kernel, {(3, plan.tile): 1})
    elt = got[-1].element_size()
    nbytes = (4 * G * L2 * L1 + elt * (I * A + G * L1 * E * A * Bd
                                       + G * L2 * E * I * Bj))
    if j:      # U written, its expansion read back, both f32
        nbytes += 4 * G * L1 * E * I * (Bd + j)
    t_ops, t_bytes = flops / PEAK_OPS[tname], nbytes / PEAK_BYTES
    reps = 1 if t_ops > 1e-3 else 3 if flops > 1e11 else 10
    row = {
        "shape": name, "dtype": tname, "square": square,
        "G": G, "L2": L2, "L1": L1, "E": E, "I": I, "A": A, "Bd": Bd,
        "j": j, "max_abs_err": diff, "max_norm_err": norm, "tol": TOL[tname],
        "ms": _time_ms(torch, kernel, reps),
        "plain_ms": _time_ms(torch, plain, reps, plain_first),
        "library_ms": _time_ms(torch, library, reps),
        "library_minflop_ms": _time_ms(torch, library_minflop, reps),
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "gflop": flops / 1e9, "kernel_gflop": k1_flops / 1e9,
        "mbytes": nbytes / 1e6, "tensor_cores": tc, "gemm": gemm,
    }
    split = f" (U at {Bd}, blend at {j})" if j else ""
    print(f"[k1] {name:>14} {tname:>8} G={G} L2={L2} L1={L1} E={E} I={I} "
          f"A={A} Bd={Bd}{split} ({gemm}): norm err "
          f"{norm:.2e} (tol {TOL[tname]:.0e}) | kernel {row['ms']:.3f} ms, "
          f"plain {row['plain_ms']:.3f} ms, library {row['library_ms']:.3f} "
          f"ms, library in K1's order {row['library_minflop_ms']:.3f} ms, "
          f"bound {row['bound_ms']:.3f} ms ({row['bound_by']}) "
          f"{'OK' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"K1 disagrees with its plain version at {name} "
                             f"({tname}): normalised error {norm:.3e}")
    del got, want
    return row


def _dw_terms(torch, dP, U):
    """Σ_e |dP[g,k,e]| |U[g,l,e]|: the size of dw's terms, which bounds its
    rounding error entry by entry (dw is a long sum that cancels)."""
    with torch.no_grad():
        return torch.einsum("gkeib,gleib->gkl", dP.float().abs(),
                            U.float().abs())


def _check_k2(torch, name, dtype, G, L2, L1, E, I, A, Bd, seed,
              need_dW=True, j=None):
    """K2 against its plain version, taking K1's U as the LiGO step does,
    and computing dW only with ``need_dW``. Checks first that K1's U and
    the U K2 computes for itself are equal bit for bit, and that K2 fed
    K1's U gives the bits of K2 on its own. With ``j``, the group's right
    expansion (Bd -> j) sits between K1's U and its blend: K2's two halves
    (the dP blend and dw against the expanded U at width j; dB from the
    narrow Q R) are each held against their plain versions."""
    from repro_torch.kernels import ligo_expand, ligo_expand_bwd, ref
    tname = str(dtype).replace("torch.", "")
    w, B, W = _ligo_inputs(torch, dtype, G, L2, L1, E, I, A, Bd, seed, False)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1000)
    _, U = ligo_expand.ligo_blend_expand_grouped(w, B, W, keep_u=True)
    bitwise = None
    if j:
        R = (torch.randn((j, Bd), generator=gen, device="cuda")
             / Bd ** 0.5).to(dtype)
        UR = _expanded(torch, U, R, dtype)
        dP = torch.randn((G, L2, E, I, j), generator=gen,
                         device="cuda").to(dtype)
        dU = (ligo_expand_bwd.ligo_blend_bwd(w, dP, UR)[1].reshape(-1, j)
              @ R).reshape(G, L1, E, I, Bd).contiguous()

        def kernel():
            dw, Q = ligo_expand_bwd.ligo_blend_bwd(w, dP, UR)
            return (dw, Q) + ligo_expand_bwd.ligo_expand_bwd(
                B, W, dU, need_dW=need_dW)

        def plain():
            return (ref.ligo_blend_bwd_ref(w, dP, UR)
                    + ref.ligo_expand_bwd_ref(B, W, dU, need_dW=need_dW))

        def library_minflop():   # the same four products as einsums
            Q = torch.einsum("gkl,gkeib->gleib", w.to(dtype), dP)
            return (torch.einsum("gkeib,gleib->gkl", dP.float(), UR), Q,
                    torch.einsum("gleib,gleab->ia", dU, W))
        library = library_minflop
        keys = ("dw", "Q", "dB", "dW")
        terms = _dw_terms(torch, dP, UR)
    else:
        dP = torch.randn((G, L2, E, I, Bd), generator=gen,
                         device="cuda").to(dtype)
        own = ligo_expand_bwd.ligo_blend_expand_bwd(w, B, W, dP, keep_u=True)
        fed = ligo_expand_bwd.ligo_blend_expand_bwd(w, B, W, dP, U=U)
        torch.cuda.synchronize()
        bitwise = bool(torch.equal(U, own[3])) and all(
            torch.equal(a, b) for a, b in zip(own[:3], fed))
        if not bitwise:
            du = (U - own[3]).abs().max().item()
            raise AssertionError(f"K2 at {name}: K1's U and K2's own U "
                                 f"differ (max {du:.3e}), or K2 fed K1's U "
                                 f"differs from K2 on its own")
        del own, fed

        def kernel():
            return ligo_expand_bwd.ligo_blend_expand_bwd(
                w, B, W, dP, U=U, need_dW=need_dW)

        def plain():
            return ref.ligo_blend_expand_bwd_ref(w, B, W, dP,
                                                 need_dW=need_dW)

        def library():   # the einsum formulation in the working dtype
            wd = w.to(dtype)
            T = torch.einsum("ia,gkeib->gkeab", B, dP)
            bl = torch.einsum("gkl,gleab->gkeab", wd, W)
            return (torch.einsum("gkeab,gleab->gkl", T, W),
                    torch.einsum("gkeib,gkeab->ia", dP, bl),
                    torch.einsum("gkl,gkeab->gleab", wd, T)
                    if need_dW else None)

        def library_minflop():   # K2's own order, given U, as einsums
            Q = torch.einsum("gkl,gkeib->gleib", w.to(dtype), dP)
            return (torch.einsum("gkeib,gleib->gkl", dP.float(), U),
                    torch.einsum("gleib,gleab->ia", Q, W),
                    torch.einsum("ia,gleib->gleab", B, Q)
                    if need_dW else None)
        keys = ("dw", "dB", "dW")
        terms = _dw_terms(torch, dP, U)

    got = kernel()
    want, plain_first = _timed(torch, plain)
    again = kernel()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)
               if a is not None):
        raise AssertionError(f"K2 is not deterministic at {name}: two runs "
                             f"on the same inputs differ")
    del again
    errs, diffs = {}, []
    for key, a, b in zip(keys, got, want):
        if (a is None) != (b is None) or (a is None and key != "dW"):
            raise AssertionError(f"K2 at {name}: {key} is "
                                 f"{'missing' if a is None else 'extra'}")
        if a is None or key == "dw":
            continue
        diff, errs[key] = _norm_err(a, b)
        diffs.append(diff)
    if (got[-1] is None) == need_dW:
        raise AssertionError(f"K2 at {name}: dW {'missing' if need_dW else 'computed'}")
    dw_diff = (got[0].float() - want[0].float()).abs()
    errs["dw"] = (dw_diff / (terms + 1e-30)).max().item()
    diffs.append(dw_diff.max().item())
    ok = (all(e <= TOL[tname] for e in errs.values())
          and all(bool(torch.isfinite(x).all()) for x in got
                  if x is not None))
    # The bound counts the fewest operations the function needs given U
    # (ligo_expand_bwd.least_operations); split, K2's two halves as they
    # run.
    if j:
        flops = (ligo_expand_bwd.operation_count(
                     G, L2, L1, E, I, A, j, u_given=True, need_dW=False,
                     need_dB=False)
                 + ligo_expand_bwd.operation_count(
                     G, L2, L1, E, I, A, Bd, q_given=True, need_dW=need_dW,
                     need_dw=False))
    else:
        flops = ligo_expand_bwd.least_operations(
            G, L2, L1, E, I, A, Bd, u_given=True, need_dW=need_dW)
    tc = ligo_expand_bwd.tensor_core_route(dtype, I, A, Bd)
    plans = ligo_expand_bwd.f32_plans(G, L1, E, I, A, Bd)
    gemm = ("wgmma" if tc else f"dB {_f32_name(plans['dB'])}" + (
        f", dW {_f32_name(plans['dW'])}" if need_dW else ""))
    if not tc and TRACE_F32[0]:
        want = {(1, plans["dB"].tile): 1}
        if need_dW:
            want[(0, plans["dW"].tile)] = 1
        _trace_f32(torch, kernel, want)
    elt = B.element_size()
    Bj = j or Bd
    nbytes = (2 * 4 * G * L2 * L1 + elt * (2 * I * A + G * L1 * E * A * Bd
                                           + G * L2 * E * I * Bj)
              + 4 * G * L1 * E * I * Bj)                   # U read
    if need_dW:
        nbytes += elt * G * L1 * E * A * Bd
    if j:      # Q written, Q R read
        nbytes += elt * G * L1 * E * I * (j + Bd)
    t_ops, t_bytes = flops / PEAK_OPS[tname], nbytes / PEAK_BYTES
    reps = 1 if t_ops > 1e-3 else 2 if flops > 1e11 else 10
    row = {
        "shape": name, "dtype": tname, "need_dW": need_dW, "j": j,
        "G": G, "L2": L2, "L1": L1, "E": E, "I": I, "A": A, "Bd": Bd,
        "max_abs_err": max(diffs), "norm_err": errs, "tol": TOL[tname],
        "u_bitwise": bitwise,
        "ms": _time_ms(torch, kernel, reps),
        "plain_ms": _time_ms(torch, plain, reps, plain_first),
        "library_ms": _time_ms(torch, library, reps),
        # the min-FLOP order's dw einsum folds e·i·b into one K-huge
        # contraction of L2·L1 outputs, which cuBLAS runs on a handful of
        # blocks (7-14 s a call at qwen2-vl's and mixtral's widest groups on
        # an NVIDIA H100 80GB HBM3 at 700 W): not timed there (no main-path
        # row)
        "library_minflop_ms": (None if E * I * Bd > MINFLOP_MAX_ROWS
                               else _time_ms(torch, library_minflop, reps)),
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "gflop": flops / 1e9, "mbytes": nbytes / 1e6, "tensor_cores": tc,
        "gemm": gemm,
    }
    minflop = row["library_minflop_ms"]
    split = f" (halves: blend at {j}, dB at {Bd})" if j else ""
    ubits = ("" if j else ", K1's U = K2's own U bit for bit")
    shown = " ".join(f"{k} {v:.2e}" for k, v in errs.items())
    print(f"[k2] {name:>14} {tname:>8} G={G} L2={L2} L1={L1} E={E} I={I} "
          f"A={A} Bd={Bd}{split} dW {'yes' if need_dW else 'no'} "
          f"({gemm}){ubits}: norm err {shown} (tol "
          f"{TOL[tname]:.0e}) | kernel {row['ms']:.3f} ms, plain "
          f"{row['plain_ms']:.3f} ms, library {row['library_ms']:.3f} ms, "
          f"library min-FLOP order "
          f"{'not timed' if minflop is None else f'{minflop:.3f} ms'}, bound "
          f"{row['bound_ms']:.3f} ms ({row['bound_by']}) "
          f"{'OK' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"K2 disagrees with its plain version at {name} "
                             f"({tname}): normalised errors {errs}")
    del got, want, terms
    return row


def _visible_pairs(T, S, causal, window):
    """(query, key) pairs that the mask keeps: the work K3 needs."""
    qpos = [t + S - T for t in range(T)]
    hi = [min(S, qp + 1) if causal else S for qp in qpos]
    lo = [max(0, qp - window + 1) if window else 0 for qp in qpos]
    return sum(max(0, h - l) for h, l in zip(hi, lo))


def _k3_device_ms(torch, fn, reps=3):
    """Device ms per call of K3's two launches on the tensor-core route, from
    ``torch.profiler``: {"transpose": the V^T pass, "kernel":
    flash_fwd_wgmma}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ms = {"transpose": 0.0, "kernel": 0.0}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        if "k3_vt_transpose_kernel" in e.key:
            ms["transpose"] += e.self_device_time_total / 1e3 / reps
        elif "flash_fwd_wgmma" in e.key:
            ms["kernel"] += e.self_device_time_total / 1e3 / reps
    # late in this script the profiler may hold no record of a short window
    return ms if ms["kernel"] > 0 else {}


def _check_k3(torch, name, dtype, B, H, KV, T, S, dh, causal, window, pad=0,
              *, seed):
    """K3 against its plain version on the model's layout: q, k and v are
    made as (B, T, heads, dh), as the model holds them (``pad`` more
    elements a row), and handed in as transposed views, as
    ``layers.full_attention`` does."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    flash_attention = importlib.import_module(
        "repro_torch.kernels.flash_attention")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((B, n, heads, dh + pad), generator=gen,
                           device="cuda").to(dt)[..., :dh].transpose(1, 2)
               for n, heads in ((T, H), (S, KV), (S, KV)))
    qpos = torch.arange(T, device="cuda")[:, None] + (S - T)
    kpos = torch.arange(S, device="cuda")[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device="cuda")
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    # SDPA's own causal mask is top-left aligned: pass it only where that is
    # the same mask (T == S, no window), an explicit mask otherwise.
    sdpa_causal = causal and T == S and not window
    sdpa_mask = None if sdpa_causal or not (causal or window) else mask

    def kernel():
        return flash_attention.flash_attention(q, k, v, causal=causal,
                                               window=window)

    def plain():
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)

    def library():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask,
                                              is_causal=sdpa_causal,
                                              enable_gqa=True)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    tol = K3_TOL[dtype]
    ok = (bool((diff <= tol + tol * want.float().abs()).all())
          and bool(torch.isfinite(got).all()))
    max_abs = diff.max().item()
    norm = max_abs / (want.float().abs().max().item() + 1e-30)
    pairs = _visible_pairs(T, S, causal, window)
    flops = 4 * B * H * dh * pairs
    nbytes = got.element_size() * (2 * B * H * T * dh + 2 * B * KV * S * dh)
    t_ops, t_bytes = flops / PEAK_OPS[dtype], nbytes / PEAK_BYTES
    tc = flash_attention.uses_tensor_cores(q, k, v)
    row = {
        "shape": name, "dtype": dtype, "B": B, "H": H, "KV": KV, "T": T,
        "S": S, "dh": dh, "causal": causal, "window": window, "pad": pad,
        "tensor_cores": tc,
        "max_abs_err": max_abs, "max_norm_err": norm, "tol": tol,
        "ms": _time_ms(torch, kernel, 20),
        "plain_ms": _time_ms(torch, plain, 3 if flops > 5e10 else 20),
        "library_ms": _time_ms(torch, library, 20),
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
    }
    # the tensor-core route's two launches, each on its own
    split = _k3_device_ms(torch, kernel) if tc else {}
    row.update({f"{key}_ms": val for key, val in split.items()})
    parts = (f" (V^T pass {split['transpose']:.4f}, kernel "
             f"{split['kernel']:.4f} ms on the device)" if split
             else " (device split: no record in the trace)" if tc else "")
    print(f"[k3] {name:>20} {dtype:>8} B={B} H={H} KV={KV} T={T} S={S} "
          f"dh={dh} causal={causal} window={window} pad={pad} "
          f"({'wgmma' if tc else 'fma'}): max abs err "
          f"{max_abs:.2e}, norm {norm:.2e} (tol {tol:.0e} + {tol:.0e}|plain|)"
          f" | kernel {row['ms']:.4f} ms{parts}, {row['gflop'] / row['ms']:.1f}"
          f" TFLOP/s, plain {row['plain_ms']:.3f} ms, library "
          f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} "
          f"ms ({row['bound_by']}; {row['gflop']:.2f} GFLOP) "
          f"{'OK' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"K3 disagrees with its plain version at {name} "
                             f"({dtype}): max abs error {max_abs:.3e}")
    del got, want, diff
    return row


def _prefill_check(torch, res, tol16, tol32, tol_far,
                   turns=("kernel", "plain")):
    """The serve run's prefill logits (through K3) against a prefill of the
    same parameters and prompts through the plain attention
    (``use_kernel=False``), and a warm prefill timed on each route in
    ``turns`` (which holds the plain route at least once: its first run is
    the check's bf16 plain prefill).

    With every parameter cast to float32 the two routes must agree to
    ``tol32`` (normalised max error), and the bf16 K3 route may lie no
    farther from the float32 logits than twice the bf16 plain route's
    distance plus ``tol_far`` (the rule ``_ligo_grad_check`` applies to the
    LiGO gradient).
    The bf16 routes must also agree to ``tol16`` where it is given; where
    the bf16 rounding of the whole depth sets the gap between them, it is
    None and the gap is printed only. ``res["batch"]``, where it is given,
    is the prefill's batch (a VLM's patches and positions). Returns the
    warm ms of each route."""
    from repro_torch.models.model import prefill
    from repro_torch.tree import tree_map
    cfg = res["cfg"]
    batch = res.get("batch") or {"tokens": res["prompts"]}

    def run(params, use_kernel):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = prefill(params, cfg, batch, use_kernel=use_kernel)
        torch.cuda.synchronize()
        return logits.float(), (time.perf_counter() - t0) * 1e3

    def err(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    warm, logits = {"kernel": [], "plain": []}, {}
    with torch.no_grad():
        for route in turns:
            logits[route], ms = run(res["params"],
                                    None if route == "kernel" else False)
            warm[route].append(ms)
        k16, p16 = res["prefill_logits"].float(), logits["plain"]
        params32 = tree_map(lambda x: x.float(), res["params"])
        k32, _ = run(params32, None)
        p32, _ = run(params32, False)
        del params32
    e16, e32 = err(k16, p16), err(k32, p32)
    ek, ep = err(k16, p32), err(p16, p32)
    rerun = (f"; warm K3 rerun vs first call "
             f"{err(logits['kernel'], k16):.2e}" if "kernel" in logits
             else "")
    held = f"tol {tol16:.0e}" if tol16 is not None else "not held"
    print(f"[{cfg.name}] prefill logits, K3 route vs plain route, normalised "
          f"max error: bf16 {e16:.2e} ({held}), float32 {e32:.2e} "
          f"(tol {tol32:.0e}); bf16 vs the float32 plain route: K3 route "
          f"{ek:.2e}, plain route {ep:.2e} (K3 within 2x plain + "
          f"{tol_far:.0e}){rerun}", flush=True)
    if not (bool(torch.isfinite(k16).all()) and bool(torch.isfinite(k32).all())
            and (tol16 is None or e16 <= tol16) and e32 <= tol32
            and ek <= 2 * ep + tol_far):
        raise AssertionError(f"{cfg.name}: prefill logits through K3 disagree "
                             f"with the plain route (bf16 {e16:.3e}, float32 "
                             f"{e32:.3e}, bf16 vs float32 {ek:.3e} against "
                             f"{ep:.3e})")
    return warm


def _check_serve(torch, res, batch, gen):
    """Logit shapes, finiteness and token range of one serve run."""
    V = res["cfg"].vocab_size
    pl, dl, toks = res["prefill_logits"], res["decode_logits"], res["tokens"]
    if tuple(pl.shape) != (batch, V) or tuple(dl.shape) != (gen - 1, batch, V):
        raise AssertionError(f"logit shapes {tuple(pl.shape)}, "
                             f"{tuple(dl.shape)}")
    if not (torch.isfinite(pl).all() and torch.isfinite(dl).all()):
        raise AssertionError("non-finite logits")
    if tuple(toks.shape) != (batch, gen) or not (
            (toks >= 0).all() and (toks < V).all()):
        raise AssertionError(f"bad tokens {tuple(toks.shape)}")


def _check_trees(torch, got, want, tol):
    """The worst per-leaf normalised error of two trees; each leaf is read
    in float32 a block of its leading dim at a time, 2^27 elements at most
    (two whole float32 copies of zamba2's grown in_proj stack, 108 x 3840
    x 15552, do not fit beside the trees)."""
    from repro_torch.core.ligo import _flatten
    fg, fw = _flatten(got), _flatten(want)
    if sorted(fg) != sorted(fw):
        raise AssertionError("grown trees differ in structure")
    worst = 0.0
    for path in sorted(fw):
        a, b = fg[path], fw[path]
        if a.shape != b.shape:
            raise AssertionError(f"{path}: shape {tuple(a.shape)} vs "
                                 f"{tuple(b.shape)}")
        n = a.shape[0] if a.dim() else 1
        step = max(1, n * (1 << 27) // max(a.numel(), 1))
        diff = top = torch.zeros((), device=b.device)
        for i in range(0, n, step):
            x, y = (t[i:i + step].float() if t.dim() else t.float()
                    for t in (a, b))
            diff = torch.maximum(diff, (x - y).abs().max())
            top = torch.maximum(top, y.abs().max())
        err = diff.item() / (top.item() + 1e-30)
        if not err <= tol:
            raise AssertionError(f"{path}: kernel grow vs plain grow "
                                 f"normalised error {err:.3e} > {tol:.0e}")
        worst = max(worst, err)
    return worst


def _ligo_grad_check(torch, res, tol32, tol16):
    """The LiGO-loss gradient at the starting operator on the kernel route
    (K1 forward, K2 backward) and on the plain route, with the pretrained
    source in float32 and as trained (bf16).

    In float32 the two routes differ only in summation order: they must
    agree to ``tol32`` per leaf. In bf16 each route rounds at its own
    places, and the whole 24-layer forward and backward rounds activations
    and their gradients to bf16 on both: the bf16 gradient of either route
    lies a few per cent from the float32 one (my chip runs 2-3, PR 12), so
    the bf16 routes cannot agree to 1e-2. The bf16 kernel route is held to
    the float32 gradient instead: no farther than twice the plain route's
    own distance to it, plus ``tol16``.

    Each leaf's error is normalised by its largest entry, floored at 1e-3
    of the tree's largest gradient: the depth blend of the key bias has a
    gradient of 0 in exact arithmetic (softmax is shift-invariant for each
    query) and carries only rounding noise."""
    from repro_torch.core.grow import ligo_loss
    from repro_torch.data import batch_for_step
    from repro_torch.training import to_device, value_and_grad
    from repro_torch.tree import tree_leaves, tree_map
    small_cfg, cfg = res["small_cfg"], res["cfg"]
    op = res["grow_info"]["operator_init"]
    batch = to_device(batch_for_step(small_cfg, 0, 8, 128, seed=1), "cuda")
    small16 = res["small"]
    small32 = tree_map(lambda x: x.float(), small16)
    names = _leaf_names(op)

    def grads(small, use_kernel):
        def fn(o, b):
            return ligo_loss(o, small, small_cfg, cfg, b,
                             use_kernel=use_kernel), {}
        (loss, _), g = value_and_grad(fn, op, batch)
        return float(loss), [x.float() for x in tree_leaves(g)]

    (lk16, k16), (lp16, p16) = grads(small16, None), grads(small16, False)
    (lk32, k32), (lp32, p32) = grads(small32, None), grads(small32, False)
    torch.cuda.synchronize()
    top = max(float(b.abs().max()) for b in p32)

    def errs(got, want):
        return [float((a - b).abs().max())
                / max(float(b.abs().max()), 1e-3 * top)
                for a, b in zip(got, want)]

    def worst(e):
        i = max(range(len(e)), key=e.__getitem__)
        return f"{e[i]:.2e} ({names[i]})"

    e32, e16 = errs(k32, p32), errs(k16, p16)
    ek, ep = errs(k16, p32), errs(p16, p32)
    print(f"[train] LiGO-loss gradient at the start operator, kernel route "
          f"vs plain route, worst per-leaf normalised error: float32 "
          f"{worst(e32)} (tol {tol32:.0e}), loss {lk32:.6f} vs {lp32:.6f}; "
          f"bf16 {worst(e16)}, loss {lk16:.6f} vs {lp16:.6f}", flush=True)
    print(f"[train] bf16 gradient vs the float32 plain-route gradient: "
          f"kernel route {worst(ek)}, plain route {worst(ep)}", flush=True)
    bad = [n for n, a, b in zip(names, ek, ep) if not a <= 2 * b + tol16]
    if max(e32) > tol32 or bad:
        raise AssertionError(f"kernel-route LiGO gradient disagrees with the "
                             f"plain route: float32 {worst(e32)}; bf16 "
                             f"kernel route off the float32 gradient at "
                             f"{bad}")


def _saved_u_gb(torch, tres):
    """GB of float32 U (K1's, and the expanded U of a group whose right
    expansion runs between K1's steps) that the growth of one bf16 LiGO
    forward on the kernel route keeps for K2: the float32 tensors autograd
    saves during the plan's apply, summed by a saved-tensors hook."""
    from repro_torch.core.ligo import apply_ligo
    from repro_torch.tree import tree_map
    total = [0]

    def pack(t):
        if t.dtype == torch.float32 and t.dim() == 5:
            total[0] += t.numel() * 4
        return t
    op = tree_map(lambda x: x.detach().requires_grad_(True),
                  tres["grow_info"]["operator_init"])
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        big = apply_ligo(op, tres["small"], tres["small_cfg"], tres["cfg"])
    del big, op
    torch.cuda.empty_cache()
    return total[0] / 1e9


def _moment_grow_check(torch, plan, ligo, small):
    """The float32 grow of both AdamW moments that rides a trajectory's hop
    (m by the operator, v by its elementwise square), here of moments made
    from the source params (v = p², not negative): the kernel route against
    the plain route, held to float32's tolerance, each route timed
    (synchronised host clock) in turns."""
    from repro_torch.tree import tree_map
    m = tree_map(lambda x: x.float(), small)
    v = tree_map(lambda x: x.float() ** 2, small)
    got, ms = {}, {"kernel": [], "plain": []}
    for route in ("kernel", "plain", "plain", "kernel"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = (plan.apply(ligo, m, use_kernel=route == "kernel"),
               plan.apply(ligo, v, use_kernel=route == "kernel",
                          square=True))
        torch.cuda.synchronize()
        ms[route].append((time.perf_counter() - t0) * 1e3)
        got.setdefault(route, out)
    worst = [_check_trees(torch, k, p, TOL["float32"])
             for k, p in zip(got["kernel"], got["plain"])]
    print(f"[main] float32 grow of both AdamW moments: kernel route vs plain "
          f"route, worst per-leaf normalised error m {worst[0]:.2e}, v "
          f"{worst[1]:.2e} (tol {TOL['float32']:.0e}) | warm kernel route "
          f"{ms['kernel']} ms, plain route {ms['plain']} ms", flush=True)
    return ms


def _right_expansion_ms(torch, tres):
    """Device ms (CUDA events) of the right expansions of one bf16 LiGO
    step on the kernel route, forward and backward, at the shapes and
    places the plan gives them: before K1 on the source layers (the
    expander's gradient only), between K1's U and its blend on the L1
    expanded slabs, or after K1 on the target layers (the expander's and
    its input's gradients)."""
    from repro_torch.core.ligo import _flatten, _kind_counts
    from repro_torch.core.plan import GrowthPlan, _expr_dims, plan_for
    small_cfg, cfg, small = tres["small_cfg"], tres["cfg"], tres["small"]
    plan = plan_for(small_cfg, cfg, small)
    table = plan._expander_table(tres["grow_info"]["operator_init"]["width"])
    stacks = {kind: _flatten(st) for kind, st in small["layers"].items()}
    gen = torch.Generator(device="cuda").manual_seed(23)
    work = []
    for g in plan.groups:
        if not (g.kernel_ok and g.out_ref):
            continue
        X = torch.stack([stacks[g.kind][p] for p in g.paths])
        if g.right_grad != "before":
            i = _expr_dims(plan.exprs[g.in_ref], small_cfg, cfg)[0]
            n = (g.shape[0] if g.right_grad == "between"
                 else _kind_counts(cfg)[g.kind])
            X = torch.randn((len(g.paths), n, i, X.shape[-1]),
                            generator=gen, device="cuda",
                            dtype=X.dtype).requires_grad_(True)
        E = table[g.out_ref].detach().requires_grad_(True)
        with torch.no_grad():
            dY = torch.randn_like(GrowthPlan._expand_out(X, E))
        work.append((X, E, dY))

    def run():
        for X, E, dY in work:
            wrt = [E, X] if X.requires_grad else [E]
            torch.autograd.grad(GrowthPlan._expand_out(X, E), wrt, dY)
    return _time_ms(torch, run, 3)


def _leaf_names(tree, prefix=""):
    out = []
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out += _leaf_names(v, p) if isinstance(v, dict) else [p]
    return out


def _gemm_routes(fn):
    """``fn()`` once with each route decision of K1 and K2 recorded (the
    wrappers' ``tensor_core_route``, which picks the GEMM that a launch's
    products run on): {"k1": [...], "k2": [...]}, True for the tensor-core
    GEMM. K1 decides once per launch that runs its product (tag 3), K2 once
    per launch that runs any of its products."""
    from repro_torch.kernels import ligo_expand, ligo_expand_bwd
    decided = {"k1": [], "k2": []}
    mods = {"k1": ligo_expand, "k2": ligo_expand_bwd}
    routes = {key: m.tensor_core_route for key, m in mods.items()}

    def recorder(key):
        def recorded(*args):
            decided[key].append(routes[key](*args))
            return decided[key][-1]
        return recorded
    for key, m in mods.items():
        m.tensor_core_route = recorder(key)
    try:
        fn()
    finally:
        for key, m in mods.items():
            m.tensor_core_route = routes[key]
    return decided


def _profile(torch, label, fn):
    """``fn`` once under ``torch.profiler``, after a warm-up call: the wall
    time (host clock, synchronised, profiler on), the device's busy time (the
    sum of the device time of every kernel and copy, as the profiler's table
    sums it: one stream, so no overlap) and the ops that take the most of
    it. The profiler adds host time to every op, so the wall time here is
    longer than an unprofiled call's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ev = prof.key_averages()
    busy = sum(e.self_device_time_total for e in ev
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation) / 1e3
    print(f"[profile] {label}: wall {wall:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / wall:.0f} %), profiler on", flush=True)
    print(ev.table(sort_by="self_device_time_total", row_limit=12,
                   max_name_column_width=48), flush=True)
    # K1's, K2's and K3's launches by kernel, full names: the table above
    # cuts names short
    for e in sorted((e for e in ev if e.device_type == DeviceType.CUDA
                     and re.search(r"\b(k1_|k2_|k3_|ligo_|flash_)", e.key)),
                    key=lambda e: -e.self_device_time_total):
        print(f"[profile] {label}: {e.self_device_time_total / 1e3:8.3f} ms "
              f"in {e.count:3d} launches of {e.key}", flush=True)
    return ev


def _check_gemm_launches(torch, label, ev, fn, want):
    """Every bf16 product of ``fn`` on the tensor-core GEMM: ``want`` is
    {(core, tag): n} (core "wgmma" or "f32"; tag the product,
    ``csrc/ligo_gemm.cuh``: 0-2 K2's dW, dB and U, 3 K1's U). The counts are
    held exactly on the route decisions of one more call of ``fn`` (all on
    the tensor cores, K1's as many as its tag-3 products); the profile ``ev``
    of ``fn`` must name K1's tensor-core GEMM and no (core, tag) outside
    ``want``, none on the float32 GEMM, none more often than ``want``, its
    counts printed beside them: the profiler can lose a record that was
    launched (:func:`_check_k3_launches`; once one of hot-grow's six)."""
    from torch.autograd import DeviceType
    got = {}
    for e in ev:
        m = re.search(r"ligo_(wgmma|f32)_gemm_kernel<(\d+),", e.key)
        if m and e.device_type == DeviceType.CUDA:
            key = (m.group(1), int(m.group(2)))
            got[key] = got.get(key, 0) + e.count
    decided = _gemm_routes(fn)
    torch.cuda.synchronize()
    n_k1 = want.get(("wgmma", 3), 0)
    k2 = any(t in (0, 1, 2) for _, t in want)
    print(f"[profile] {label}: GEMM route decisions on the tensor cores: K1 "
          f"{sum(decided['k1'])} of {len(decided['k1'])}, want {n_k1} of "
          f"{n_k1}; K2 {sum(decided['k2'])} of {len(decided['k2'])}; traced "
          f"launches by (core, product tag) {got}, want {want}", flush=True)
    if (decided["k1"] != [True] * n_k1 or not all(decided["k2"])
            or bool(decided["k2"]) != k2 or not got.get(("wgmma", 3))
            or any(got[key] > want.get(key, 0) for key in got)):
        raise AssertionError(f"{label}: GEMM routes {decided}, traced {got}, "
                             f"want {want} (every bf16 product on the tensor "
                             f"cores, none on the float32 GEMM)")


def _check_k3_launches(torch, label, fn, n):
    """The one check that a main path's K3 launches ran on the tensor-core
    kernel (llama3-8b's, zamba2-2.7b's prefill, hubert-xlarge's encode):
    ``fn`` once warm, then once more with every K3 route decision recorded
    (the wrapper's ``uses_tensor_cores``, which picks the kernel each
    launch runs) under the profiler, recording the device's kernels only
    (a deep model's host ops make a full trace take tens of seconds to
    read). All ``n`` launches must be routed to the tensor cores, and the
    trace must name the tensor-core kernel and its V^T pass, each at most
    ``n`` times, and the FMA kernel never. The trace's counts are printed
    beside ``n``, not held to it: late in this script the profiler lost
    one of hubert-xlarge's 48 tensor-core launches and its V^T pass in four
    runs, from the middle of the window (its other records lay between the
    block's first and last host times), while the counters saw 48 and the
    same code traced 48 of 48 in a fresh process (this script and a one-off
    run on an NVIDIA H100 80GB HBM3, 700 W)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    flash_attention = importlib.import_module(
        "repro_torch.kernels.flash_attention")
    route = flash_attention.uses_tensor_cores
    fn()
    torch.cuda.synchronize()
    decided = []

    def recorded(q, k, v):
        decided.append(route(q, k, v))
        return decided[-1]
    flash_attention.uses_tensor_cores = recorded
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        flash_attention.uses_tensor_cores = route
    got = {"flash_fwd_wgmma": 0, "k3_vt_transpose_kernel": 0,
           "flash_fwd_simt": 0}
    for e in prof.key_averages():
        for name in got:
            if e.device_type == DeviceType.CUDA and name in e.key:
                got[name] += e.count
    print(f"[profile] {label}: wall {wall:.1f} ms, kernels only; K3 "
          f"launches routed to the tensor cores {sum(decided)} of "
          f"{len(decided)}, want {n} of {n}; traced by kernel {got}",
          flush=True)
    if (decided != [True] * n or got["flash_fwd_simt"]
            or not 1 <= got["flash_fwd_wgmma"] <= n
            or not 1 <= got["k3_vt_transpose_kernel"] <= n):
        raise AssertionError(f"{label}: K3 routes {decided}, traced {got}, "
                             f"want {n} launches on the tensor-core kernel "
                             f"and its V^T pass, none on the FMA kernel")


def _profile_steps(torch, tres):
    """One LiGO step and one train step of the full-width pair, profiled."""
    from repro_torch.configs import TrainConfig
    from repro_torch.core.grow import ligo_loss
    from repro_torch.data import batch_for_step
    from repro_torch.optim import adamw_init
    from repro_torch.training import make_train_step, to_device, value_and_grad
    small_cfg, cfg = tres["small_cfg"], tres["cfg"]
    sbatch = to_device(batch_for_step(small_cfg, 0, 8, 128, seed=21), "cuda")
    batch = to_device(batch_for_step(cfg, 0, 8, 128, seed=22), "cuda")
    step = make_train_step(cfg, TrainConfig(steps=4, warmup_steps=5, lr=1e-3))
    params, opt = tres["params"], adamw_init(tres["params"])

    def ligo_step():
        return value_and_grad(
            lambda op, b: (ligo_loss(op, tres["small"], small_cfg, cfg, b),
                           {}),
            tres["grow_info"]["operator_init"], sbatch)

    def train_step():
        return step(params, opt, batch, 1)

    ev = _profile(torch, f"LiGO step of {small_cfg.name} -> {cfg.name}",
                  ligo_step)
    # the bf16 LiGO step runs K1's product (tag 3) and K2's dB (tag 1) of
    # every group, and K2's dW (tag 0) where W takes a gradient, on the
    # tensor-core GEMM; K2's own U (tag 2) never (it takes K1's), and
    # nothing on the float32 GEMM
    shapes = tres["shapes"]
    n_dW = sum(1 for sh in shapes for _, _, need in _k2_calls(sh) if need)
    want = {("wgmma", 3): len(shapes), ("wgmma", 1): len(shapes)}
    if n_dW:
        want[("wgmma", 0)] = n_dW
    _check_gemm_launches(torch, "LiGO step", ev, ligo_step, want)
    from torch.autograd import DeviceType
    busy = sum(e.self_device_time_total for e in ev
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation) / 1e3
    right = _right_expansion_ms(torch, tres)
    print(f"[train] the LiGO step's right expansions (forward and backward, "
          f"CUDA events): {right:.2f} ms, {100 * right / busy:.0f} % of the "
          f"step's {busy:.1f} ms of device time (profile above)", flush=True)
    _profile(torch, f"train step of {small_cfg.name} -> {cfg.name}",
             train_step)


# Phase 6: trajectory A (uninterrupted) and B (killed mid-LiGO-phase, then
# resumed) of the same schedule, and a from-scratch baseline, all through
# the train launcher, at full width and depth.
TRAJ = {"arch": "gpt2-base", "batch": 8, "seq": 128, "lr": 1e-3,
        "checkpoint_every": 2, "seed": 0,
        "stages": [{"steps": 4},
                   {"steps": 4, "arch": "gpt2-medium", "method": "ligo",
                    "ligo_steps": LIGO_STEPS, "ligo_scan_chunk": 2}]}
SCRATCH = {"arch": "gpt2-medium", "batch": 8, "seq": 128, "lr": 1e-3,
           "checkpoint_every": 8, "seed": 0, "stages": [{"steps": 8}]}
FAIL_AT = 2
# The reference's CI gate on measured / modelled FLOPs (its
# tests/test_ledger.py): held for every train step at full width, for the
# full-width LiGO step on the kernel route (its K1 and K2 count checked
# against the plan's groups, and the plain route's count of the same step
# printed beside it), and for the LiGO step at the reference's own CI shape
# (tr0 -> tr1, batch 4 x 16) on the kernel route.
FLOPS_GATE = (0.5, 2.0)


class _Tee:
    """stdout that is printed and kept."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def _main_teed(launcher, argv):
    """``launcher.main(argv)`` with its stdout printed and returned."""
    import contextlib
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        res = launcher.main(argv)
    return res, "".join(tee.text)


def _assert_equal_trees(torch, a, b, label):
    from repro_torch.checkpoint import flatten_tree
    fa, fb = flatten_tree(a), flatten_tree(b)
    if list(fa) != list(fb):
        raise AssertionError(f"{label}: the trees differ in structure")
    for k in fa:
        if fa[k].dtype != fb[k].dtype or not torch.equal(fa[k], fb[k]):
            raise AssertionError(f"{label}: {k} differs")
    return sum(t.numel() for t in fa.values())


def _gate_ratio(label, m):
    lo, hi = FLOPS_GATE
    print(f"[flops] {label}: measured {m['flops']:.4e} (aten "
          f"{m['flops_aten']:.4e}, K1+K2 {m['flops_kernels']:.4e}) / "
          f"modelled {m['modelled_flops']:.4e} = {m['ratio']:.3f} (gate "
          f"[{lo}, {hi}]); FlopCounter pass {m['pass_ms']:.1f} ms",
          flush=True)
    if not lo <= m["ratio"] <= hi:
        raise AssertionError(f"{label}: measured / modelled FLOPs "
                             f"{m['ratio']:.3f} outside [{lo}, {hi}]")


def _reference_ci_ligo_gate(torch):
    """The reference's CI gate at its own shape (tr0 -> tr1 of its
    tests/test_trajectory.py, batch 4 x 16, f32), on the kernel route: the
    measured-cost pass of one LiGO step on CUDA inputs."""
    from repro_torch.configs.paper_models import BERT_SMALL
    from repro_torch.core import init_ligo_params
    from repro_torch.core.grow import ligo_loss
    from repro_torch.data import batch_for_step
    from repro_torch.kernels import ops
    from repro_torch.models.model import init_params
    from repro_torch.obs import costs
    from repro_torch.roofline import train_flops_per_step
    from repro_torch.training import to_device, value_and_grad
    t0 = BERT_SMALL.scaled(name="tr0", n_layers=2, d_model=32, n_heads=4,
                           n_kv_heads=4, d_head=8, d_ff=64, vocab_size=64,
                           max_seq=64, dtype="float32", objective="clm",
                           encoder_only=False, causal=True)
    t1 = t0.scaled(name="tr1", n_layers=3, d_model=48, n_heads=6,
                   n_kv_heads=6, d_ff=96)
    gen = torch.Generator(device="cuda").manual_seed(0)
    small = init_params(t0, gen, device="cuda")
    op = init_ligo_params(gen, t0, t1, device="cuda")
    batch = to_device(batch_for_step(t0, 0, 4, 16), "cuda")

    def step(o, b, sp):
        return value_and_grad(
            lambda oo, bb: (ligo_loss(oo, sp, t0, t1, bb), {}), o, b)
    before = ops.launch_counts()
    m = costs.measure_step("ligo_step[tr1]", step, op, batch, small,
                           modelled_flops=train_flops_per_step(t1, 4, 16))
    if ops.launch_counts() != before or not m["flops_kernels"] > 0:
        raise AssertionError(f"the counting pass launched a kernel or "
                             f"counted no kernel work: {m}")
    _gate_ratio("LiGO step tr0 -> tr1 (the reference's CI shape, kernel "
                "route)", m)
    return m


def _plain_route_ligo_flops(torch, modelled):
    """The measured-cost pass over phase 6's LiGO step (gpt2-base ->
    gpt2-medium, batch 8 x 128) on the plain route, for comparison with the
    kernel route's count; the inputs are meta tensors: only shapes count."""
    from repro_torch.configs import get_config
    from repro_torch.core import init_ligo_params
    from repro_torch.core.grow import ligo_loss
    from repro_torch.data import batch_for_step
    from repro_torch.models.model import init_params
    from repro_torch.obs import costs
    from repro_torch.training import to_device, value_and_grad
    c1, c2 = get_config("gpt2-base"), get_config("gpt2-medium")
    gen = torch.Generator().manual_seed(0)
    small = init_params(c1, gen, device="meta")
    op = init_ligo_params(gen, c1, c2, device="meta")
    batch = to_device(batch_for_step(c1, 0, 8, 128), "meta")

    def step(o, b, sp):
        return value_and_grad(lambda oo, bb: (
            ligo_loss(oo, sp, c1, c2, bb, use_kernel=False), {}), o, b)
    return costs.measure_step("ligo_step[gpt2-medium, plain route]", step,
                              op, batch, small, modelled_flops=modelled)


def _trajectory_phase(torch, tmp, shapes):
    """Phase 6: trajectories A and B, the scratch baseline, the ledger and
    FLOPs checks, and serve --ckpt of A's directory."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels import ops
    from repro_torch.launch import serve, train
    from repro_torch.models.model import prefill
    from repro_torch.obs import costs
    from repro_torch.obs.ledger import (RunLedger, normalize_records,
                                        read_ledger, savings_report)
    t_phase = time.perf_counter()
    free = shutil.disk_usage(tmp).free / 1e9
    print(f"[traj] working directory {tmp}: {free:.1f} GB free", flush=True)
    paths = {}
    for name, sched in (("traj", TRAJ), ("scratch", SCRATCH)):
        paths[name] = os.path.join(tmp, f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(sched, f)

    def args(run, sched, *extra):
        return ["--trajectory", paths[sched], "--ckpt-dir",
                os.path.join(tmp, f"ck_{run}"), "--ledger",
                os.path.join(tmp, f"{run}.jsonl"), "--keep-checkpoints", "2",
                *extra]
    k1_grad, k2_grad = _launches(shapes, True)
    k1_grow = _launches(shapes, False)[0]
    launches = {}

    # -- A: uninterrupted ---------------------------------------------------
    costs.clear_measurements()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res_a, _ = _main_teed(train, args("A", "traj"))
    launches["A"] = ops.launch_counts()
    sec_a = time.perf_counter() - t0
    # K2 on every eligible group of every LiGO step; K1 on every LiGO
    # forward, on the grow of the parameters and on the grows of the two
    # AdamW moments that ride the hop; K3 never (every forward records
    # autograd); the counting passes launch nothing
    want = {"ligo_blend_expand_grouped": (k1_grad * LIGO_STEPS
                                          + 3 * k1_grow),
            "ligo_blend_expand_bwd_fused": k2_grad * LIGO_STEPS,
            "flash_attention": 0}
    print(f"[traj] A: {sec_a:.1f} s, launches {launches['A']}", flush=True)
    if launches["A"] != want or res_a["status"] != "done":
        raise AssertionError(f"trajectory A: status {res_a['status']}, "
                             f"launches {launches['A']}, want {want}")

    # -- B: killed after the LiGO-phase checkpoint at step FAIL_AT, resumed -
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        _main_teed(train, args("B", "traj", "--fail-at-ligo-step",
                                str(FAIL_AT)))
    except RuntimeError as e:
        if f"injected LiGO-phase failure at step {FAIL_AT}/" not in str(e):
            raise
        print(f"[traj] B died as asked: {e}", flush=True)
    else:
        raise AssertionError("trajectory B ran through its injected failure")
    res_b, out_b = _main_teed(train, args("B", "traj"))
    launches["B"] = ops.launch_counts()
    sec_b = time.perf_counter() - t0
    if f"resumed LiGO phase at step {FAIL_AT}/{LIGO_STEPS}" not in out_b:
        raise AssertionError("trajectory B did not resume its LiGO phase at "
                             f"step {FAIL_AT}")
    if res_b["resumed_at"] != (0, TRAJ["stages"][0]["steps"]):
        raise AssertionError(f"trajectory B resumed at {res_b['resumed_at']}")
    print(f"[traj] B: {sec_b:.1f} s for the killed and the resumed run, "
          f"launches {launches['B']}", flush=True)
    recs_a = read_ledger(os.path.join(tmp, "A.jsonl"))
    recs_b = read_ledger(os.path.join(tmp, "B.jsonl"))
    if normalize_records(recs_a) != normalize_records(recs_b):
        raise AssertionError("the ledgers of A and B differ")
    n_par = _assert_equal_trees(torch, res_a["params"], res_b["params"],
                                "final params of A and B")
    n_opt = _assert_equal_trees(torch, res_a["opt"], res_b["opt"],
                                "final AdamW state (m, v, count) of A and B")
    print(f"[traj] A and B: {len(recs_a)} ledger records identical "
          f"(wall_ms, run_id masked); final params ({n_par} values) and "
          f"AdamW state (m, v and count: {n_opt} values) bitwise equal",
          flush=True)
    del res_b
    shutil.rmtree(os.path.join(tmp, "ck_B"))

    # -- the FLOPs of the programs A ran --------------------------------------
    archs = list(dict.fromkeys(r["arch"] for r in recs_a
                               if r["type"] == "step"))
    for arch in archs:
        _gate_ratio(f"train step {arch}",
                    costs.measurement(f"train_step[{arch}]"))
    train_pass_ms = costs.measurement(f"train_step[{archs[-1]}]")["pass_ms"]
    m_ligo = costs.measurement(f"ligo_step[{archs[-1]}]")
    want_k = _kernel_operations(shapes)
    m_plain = _plain_route_ligo_flops(torch, m_ligo["modelled_flops"])
    print(f"[flops] the same LiGO step on the plain route (min-FLOP "
          f"contractions, no kernel): measured {m_plain['flops']:.4e} / "
          f"modelled = {m_plain['ratio']:.3f}", flush=True)
    _gate_ratio("LiGO step gpt2-base -> gpt2-medium (batch 8 x 128, kernel "
                "route)", m_ligo)
    if m_ligo["flops_kernels"] != want_k:
        raise AssertionError(f"LiGO step: K1+K2 counted "
                             f"{m_ligo['flops_kernels']:.6e}, the plan's "
                             f"groups need {want_k:.6e}")
    m_ci = _reference_ci_ligo_gate(torch)

    # -- the scratch baseline and the savings report --------------------------
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res_s, _ = _main_teed(train, args("S", "scratch"))
    launches["S"] = ops.launch_counts()
    sec_s = time.perf_counter() - t0
    del res_s
    shutil.rmtree(os.path.join(tmp, "ck_S"))
    target = [r for r in recs_a if r["type"] == "step"][-1]["loss"]
    rep = savings_report(target, os.path.join(tmp, "A.jsonl"),
                         baseline=os.path.join(tmp, "S.jsonl"))
    print(f"[savings] target loss {target:.4f} (A's last step): basis "
          f"{rep['basis']}; grown run {rep['run']['flops']:.4e} FLOPs at "
          f"step {rep['run']['step']} ({rep['run']['arch']}); scratch "
          f"baseline {rep['baseline']['flops']:.4e} FLOPs at step "
          f"{rep['baseline']['step']} (loss {rep['baseline']['loss']:.4f}, "
          f"{'censored: never reached the target' if rep['censored_baseline'] else 'reached'}"
          f"); savings {rep['savings_frac']:.3f}. Smoke step counts: this "
          f"exercises the mechanism and claims nothing ({sec_s:.1f} s)",
          flush=True)

    # -- serve --ckpt of A's directory ----------------------------------------
    ops.reset_launch_counts()
    res_v = serve.main(["--arch", "gpt2-medium", "--ckpt",
                        os.path.join(tmp, "ck_A"), "--batch", "8",
                        "--prompt-len", "128", "--gen", "2"])
    launches["serve"] = ops.launch_counts()
    cfg = res_v["cfg"]
    if launches["serve"]["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"serve --ckpt: K3 launches "
                             f"{launches['serve']}, want {cfg.n_layers}")
    with torch.no_grad():
        want_logits, _ = prefill(res_a["params"], cfg,
                                 {"tokens": res_v["prompts"]}, max_len=130)
    if not torch.equal(res_v["prefill_logits"], want_logits):
        raise AssertionError("serve --ckpt: prefill logits differ from the "
                             "prefill of A's final params")
    _check_serve(torch, res_v, 8, 2)
    print(f"[serve] --ckpt of A: {cfg.n_layers} K3 launches, prefill logits "
          f"bitwise equal to A's final params in this process", flush=True)
    del res_v, want_logits

    # -- ledger overhead, checkpoint write and restore ------------------------
    # the ledger first: a cursor snapshot fsyncs, and its cost grows with the
    # dirty pages a checkpoint write leaves behind
    led = RunLedger(os.path.join(tmp, "overhead.jsonl"))
    led.restore(None)
    record_s, snapshot_ms = 0.0, []     # 1000 records: s in all = ms each
    for i in range(1000):
        t0 = time.perf_counter()
        led.record_step(stage=1, arch="gpt2-medium", step=i, loss=3.0,
                        tokens=1024.0, wall_ms=100.0, flops_modelled=2e12,
                        flops_measured=6e12)
        record_s += time.perf_counter() - t0
        if i % 100 == 99:
            t0 = time.perf_counter()
            led.snapshot()
            snapshot_ms.append((time.perf_counter() - t0) * 1e3)
    led.close()
    snapshot_ms = sorted(snapshot_ms)[len(snapshot_ms) // 2]
    bench = os.path.join(tmp, "bench")
    mgr = CheckpointManager(bench)
    state = {"params": res_a["params"], "opt": res_a["opt"]}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(8, state, block=True)
    write_ms = (time.perf_counter() - t0) * 1e3
    d = os.path.join(bench, "step_00000008")
    gb = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)) / 1e9
    t0 = time.perf_counter()
    got, _ = mgr.restore(8, state)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    _assert_equal_trees(torch, got, state, "checkpoint round trip")
    del got, state
    shutil.rmtree(bench)
    steps_a = [r for r in recs_a if r["type"] == "step"]
    step_ms = sum(r["wall_ms"] for r in steps_a) / len(steps_a)
    sec = time.perf_counter() - t_phase
    print(f"[traj] phase {sec:.1f} s | one gpt2-medium checkpoint (bf16 "
          f"params, f32 AdamW moments) {gb:.3f} GB: write {write_ms:.0f} ms "
          f"(host copy + npz, blocking), restore to the card "
          f"{restore_ms:.0f} ms | ledger: {record_s:.4f} ms a record, "
          f"{snapshot_ms:.3f} ms a cursor snapshot (fsync, median of 10), "
          f"against {step_ms:.1f} ms a step of A | FlopCounter passes: "
          f"train {train_pass_ms:.0f} ms, LiGO {m_ligo['pass_ms']:.0f} ms, "
          f"each once per program",
          flush=True)
    del res_a
    torch.cuda.empty_cache()
    return {"launches": launches, "seconds": sec, "ckpt_gb": gb,
            "write_ms": write_ms, "restore_ms": restore_ms,
            "ligo_ratio": m_ligo["ratio"], "ci_ratio": m_ci["ratio"]}


# Phase 8: the paper's vision pairs through the train path's pieces at
# full width: (source, target, batch, source AdamW steps, LiGO steps,
# target AdamW steps). CaiT (K3 at dh 48, padded to the tensor-core
# kernel's 64-wide tile) runs at a reduced step count.
VISION = [("deit-s", "deit-b", 32, 3, 4, 3), ("cait-xs", "cait-s", 32, 2, 2, 2)]
# kernel route against the plain route: a value of the bf16 kernel route
# may lie no farther from the float32 plain route than twice the bf16 plain
# route's distance plus this (normalised), the rule of _ligo_grad_check
VISION_TOL = 1e-2


def _vision_batches(torch, cfg, batch, seed, n, f32=False, seq=0):
    """``n`` ``dummy_batch`` training batches of ``cfg`` on the card, seeds
    ``seed``, ``seed + 1``, ...; with ``f32`` their patches (an audio
    model's frames) in float32. ``seq``: an audio model's frames a row."""
    from repro_torch.models.inputs import dummy_batch
    for i in range(n):
        b = dummy_batch(cfg, batch, seq, "train", seed=seed + i)
        yield {k: v.float() if f32 and v.is_floating_point() else v
               for k, v in b.items()}


def _vision_source(torch, c1, batch, steps, seq=0):
    """``c1`` from a seeded generator, then ``steps`` AdamW steps on
    ``dummy_batch`` batches: (params, AdamW state, losses)."""
    from repro_torch.configs import TrainConfig
    from repro_torch.training import init_train_state, make_train_step
    params, opt = init_train_state(
        c1, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    step = make_train_step(c1, TrainConfig(steps=steps, warmup_steps=1,
                                           lr=1e-3))
    losses = []
    for s_, b in enumerate(_vision_batches(torch, c1, batch, 100, steps,
                                           seq=seq)):
        params, opt, m = step(params, opt, b, s_)
        losses.append(float(m["loss"]))
    return params, opt, losses


def _vision_run(torch, c1, c2, small, opt, batch, ligo_steps, tsteps, route,
                seq=0):
    """The rest of the paper's pipeline for one vision pair (or the audio
    pair, ``seq`` frames a row) on one route,
    from the trained source ``small`` and its AdamW state ``opt``: a LiGO
    phase of ``ligo_steps`` SGD steps on target batches, ``grow()`` with the
    AdamW moments, an autograd-free eval forward of the grown model, then
    ``tsteps`` AdamW steps of it. ``route``: "kernel" (K1, K2 and K3 on
    CUDA tensors), "plain" (the legacy per-leaf growth walk and the plain
    attention), or "plain32" (the plain route in float32, from the same
    source and batches upcast)."""
    from repro_torch.configs import TrainConfig
    from repro_torch.core import grow
    from repro_torch.models.losses import loss_fn
    from repro_torch.training import make_train_step
    from repro_torch.tree import tree_map
    f32 = route == "plain32"
    d1, d2 = ((c.scaled(dtype="float32") for c in (c1, c2)) if f32
              else (c1, c2))
    if f32:
        small = tree_map(lambda x: x.float(), small)
    big, info = grow(small, d1, d2, method="ligo",
                     gen=torch.Generator(device="cuda").manual_seed(1),
                     data_it=_vision_batches(torch, c2, batch, 200,
                                             ligo_steps, f32, seq),
                     ligo_steps=ligo_steps,
                     engine="plan" if route == "kernel" else "legacy",
                     opt_state=opt)
    grown = tree_map(lambda x: x.clone(), big)
    eval_b = next(_vision_batches(torch, c2, batch, 300, 1, f32, seq))
    with torch.no_grad():
        eval_loss, _ = loss_fn(big, d2, eval_b,
                               use_kernel=None if route == "kernel"
                               else False)
    step = make_train_step(d2, TrainConfig(steps=max(tsteps, 1),
                                           warmup_steps=1, lr=1e-3))
    opt2, tgt = info["opt_state"], []
    for s_, b in enumerate(_vision_batches(torch, c2, batch, 400, tsteps,
                                           f32, seq)):
        big, opt2, m = step(big, opt2, b, s_)
        tgt.append(float(m["loss"]))
    torch.cuda.synchronize()
    return {"ligo": info["ligo_losses"], "grown": grown,
            "eval": float(eval_loss), "tgt": tgt, "operator": info["operator"]}


def _tree_dist(torch, got, want):
    """The worst per-leaf distance of two trees, each leaf's max error
    normalised by its largest entry, floored at 1e-3 of the tree's largest
    (a leaf that starts at 0, such as the key bias, whose LiGO gradient is
    0 in exact arithmetic, carries only rounding noise)."""
    from repro_torch.core.ligo import _flatten
    fg, fw = _flatten(got), _flatten(want)
    if sorted(fg) != sorted(fw):
        raise AssertionError("grown trees differ in structure")
    top = max(float(x.float().abs().max()) for x in fw.values())
    return max(float((fg[k].float() - fw[k].float()).abs().max())
               / max(float(fw[k].float().abs().max()), 1e-3 * top)
               for k in fw)


def _vision_flops(torch, c1, c2, batch, operator, small, seq=0):
    """The measured-cost pass over one LiGO step of the pair (batch of
    ``batch`` images) on the kernel route and on the plain route (the
    plan's min-FLOP contractions), against the 6ND model at 196 tokens an
    image (``seq`` frames a row for the audio pair)."""
    from repro_torch.core.grow import ligo_loss
    from repro_torch.models.inputs import dummy_batch
    from repro_torch.obs import costs
    from repro_torch.roofline import train_flops_per_step
    from repro_torch.training import value_and_grad
    b = dummy_batch(c2, batch, seq, "train", seed=500)
    modelled = train_flops_per_step(c2, batch, seq or c2.num_patches - 1)
    out = {}
    for route, uk in (("kernel", None), ("plain", False)):
        def step(o, bb, sp, uk=uk):
            return value_and_grad(lambda oo, b3: (
                ligo_loss(oo, sp, c1, c2, b3, use_kernel=uk), {}), o, bb)
        out[route] = costs.measure_step(f"ligo_step[{c2.name}, {route}]",
                                        step, operator, b, small,
                                        modelled_flops=modelled)
    return out


def _pair_routes(torch, c1, c2, batch, steps, lsteps, tsteps, seq=0,
                 tag="vision", profile_eval=False):
    """One pair through the train path's pieces on the kernel route
    (launches counted from 0 just before and read just after), the bf16
    plain route and the float32 plain route: the kernel route held against
    the plain routes, the LiGO step's FLOPs on both routes. With
    ``profile_eval``, one warm eval forward of the grown model on the
    kernel route is profiled: every layer's K3 on the tensor-core kernel.
    Returns the kernel route's launches and the report's numbers."""
    from repro_torch.kernels import ops
    a, b = c1.name, c2.name
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    small, opt, src = _vision_source(torch, c1, batch, steps, seq)
    res = _vision_run(torch, c1, c2, small, opt, batch, lsteps, tsteps,
                      "kernel", seq)
    got = ops.launch_counts()
    sec_k = time.perf_counter() - t0
    shapes = _k1_shapes(torch, c1, c2)
    k1_grad, k2_grad = _launches(shapes, True)
    want = {"ligo_blend_expand_grouped": (lsteps * k1_grad + 3
                                          * _launches(shapes, False)[0]),
            "ligo_blend_expand_bwd_fused": lsteps * k2_grad,
            "flash_attention": c2.n_layers}
    print(f"[{tag}] {a} -> {b} kernel route ({sec_k:.1f} s): launches "
          f"{got}, want {want}", flush=True)
    if got != want or not all(v > 0 for v in got.values()):
        raise AssertionError(f"{a} -> {b}: launches {got}, want {want} "
                             f"(K1 and K2 on every LiGO step's groups and "
                             f"K1 on the grow of the params and both "
                             f"moments; K3 once a layer of the eval)")
    if profile_eval:
        from repro_torch.models.losses import loss_fn
        eval_b = next(_vision_batches(torch, c2, batch, 300, 1, False, seq))
        with torch.no_grad():
            _check_k3_launches(torch, f"{b} eval forward",
                        lambda: loss_fn(res["grown"], c2, eval_b),
                        c2.n_layers)
        del eval_b
    plain, ref32 = (_vision_run(torch, c1, c2, small, opt, batch, lsteps,
                                tsteps, route, seq)
                    for route in ("plain", "plain32"))

    def rel(x, y):
        return abs(x - y) / max(abs(y), 1e-30)
    worst = {}
    for key in ("ligo", "tgt"):
        for i, (k, p, r) in enumerate(zip(res[key], plain[key],
                                          ref32[key])):
            ek, ep = rel(k, r), rel(p, r)
            worst[f"{key}[{i}]"] = (ek, ep)
    worst["eval"] = (rel(res["eval"], ref32["eval"]),
                     rel(plain["eval"], ref32["eval"]))
    worst["grown"] = (_tree_dist(torch, res["grown"], ref32["grown"]),
                      _tree_dist(torch, plain["grown"], ref32["grown"]))
    bad = {k: v for k, v in worst.items()
           if not v[0] <= 2 * v[1] + VISION_TOL}
    finite = all(math.isfinite(x) for x in src) and all(
        math.isfinite(x) for r in (res, plain) for key in ("ligo", "tgt")
        for x in r[key])
    print(f"[{tag}] {a} -> {b}: losses source {src}, LiGO "
          f"{res['ligo']}, eval {res['eval']:.4f}, target {res['tgt']} "
          f"(kernel route) | plain route LiGO {plain['ligo']}, eval "
          f"{plain['eval']:.4f} | float32 plain LiGO {ref32['ligo']}, "
          f"eval {ref32['eval']:.4f}", flush=True)
    print(f"[{tag}] {a} -> {b}: normalised distance to the float32 "
          f"plain route (bf16 kernel route, bf16 plain route): "
          + ", ".join(f"{k} {v[0]:.2e}/{v[1]:.2e}"
                      for k, v in worst.items())
          + f" (kernel within 2x plain + {VISION_TOL:.0e})", flush=True)
    if bad or not finite or not math.isfinite(res["eval"]):
        raise AssertionError(f"{a} -> {b}: the kernel route disagrees "
                             f"with the plain route at {bad}, or a loss "
                             f"is not finite")
    del plain, ref32
    torch.cuda.empty_cache()
    m = _vision_flops(torch, c1, c2, batch, res["operator"], small, seq)
    tokens = seq or c2.num_patches - 1
    print(f"[flops] LiGO step {a} -> {b} (batch {batch} x {tokens} "
          f"{'frames' if seq else 'patches'}): kernel route measured "
          f"{m['kernel']['flops']:.4e} (aten {m['kernel']['flops_aten']:.4e}"
          f", K1+K2 {m['kernel']['flops_kernels']:.4e}) / modelled "
          f"{m['kernel']['modelled_flops']:.4e} = "
          f"{m['kernel']['ratio']:.3f}; plain route "
          f"{m['plain']['flops']:.4e} = {m['plain']['ratio']:.3f}",
          flush=True)
    want_k = _kernel_operations(shapes)
    if m["kernel"]["flops_kernels"] != want_k:
        raise AssertionError(f"{a} -> {b}: K1+K2 counted "
                             f"{m['kernel']['flops_kernels']:.6e}, the "
                             f"plan's groups need {want_k:.6e}")
    report = {"ratio": m["kernel"]["ratio"],
              "plain_ratio": m["plain"]["ratio"], "eval": res["eval"],
              "seconds": time.perf_counter() - t0}
    del res, small, opt
    torch.cuda.empty_cache()
    return got, report


def _vision_phase(torch):
    """Phase 8: each vision pair on the kernel route, the bf16 plain route
    and the float32 plain route (:func:`_pair_routes`)."""
    from repro_torch.configs import get_config
    launches, report = {}, {}
    for a, b, batch, steps, lsteps, tsteps in VISION:
        launches[b], report[b] = _pair_routes(
            torch, get_config(a), get_config(b), batch, steps, lsteps,
            tsteps)
    return launches, report


# Phase 9: the live engine through serve --live-grow-at, at full width,
# bf16: continuous batching over the paged KV cache, the zero-downtime hop
# gpt2-base -> gpt2-medium (K1 on a side stream of a background thread,
# re-prefill through K3), a LEMON hop, chaos at every stage, and llama3-8b
# through the engine.
LIVE_REQ, LIVE_GEN = 16, 32
LIVE_ARGS = ["--arch", "gpt2-base", "--grow-to", "gpt2-medium",
             "--live-grow-at", "8", "--batch", "8", "--requests",
             str(LIVE_REQ), "--prompt-len", "128", "--gen", str(LIVE_GEN)]
LEMON_ARGS = ["--arch", "gpt2-medium", "--hop-operator", "lemon",
              "--live-grow-at", "8", "--batch", "8", "--requests",
              str(LIVE_REQ), "--prompt-len", "128", "--gen", str(LIVE_GEN),
              "--hop-sync"]
# first-token logits, kernel route against plain route and LEMON hop
# against no hop: _prefill_check's bf16 tolerance at gpt2-medium (phase 3);
# paged against dense: the same functions on the same inputs but for the
# gather, so held tighter
LIVE_TOL = 2e-2
LAYOUT_TOL = 1e-3
# llama3-8b through the engine: slots, requests, prompt budget (prompts of
# 1024-2048 tokens), new tokens
LLAMA_LIVE = (4, 8, 2048, 16)


def _logit_err(a, b):
    import numpy as np
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _live_check(res, n_req, gen):
    """Every request of a live run done at ``gen`` tokens with finite
    first- and last-token logits, none dropped or rejected."""
    import numpy as np
    eng = res["engine"]
    c = eng.counts()
    if not (c["done"] == n_req and c["dropped"] == 0 and c["rejected"] == 0
            and len(eng.requests) == n_req
            and all(len(r.tokens) == r.max_new == gen
                    for r in eng.requests)):
        raise AssertionError(f"live run: {c}, tokens "
                             f"{[len(r.tokens) for r in eng.requests]}")
    for r in eng.requests:
        if not (np.isfinite(r.first_logits).all()
                and np.isfinite(r.last_logits).all()):
            raise AssertionError("live run: non-finite logits")
    return eng, res["hop"]


def _k3_want(eng, cfg1, cfg2):
    """K3 launches of a live run by the engine's own prefill counters: one
    per layer of every admission prefill, every drafter prefill (a request
    admitted while the pre-hop model drafts) and every re-prefill."""
    pc = eng.prefill_counts
    return (cfg1.n_layers * (pc[(cfg1.name, "admit")]
                             + pc[(cfg1.name, "draft")])
            + cfg2.n_layers * (pc[(cfg2.name, "admit")]
                               + pc[(cfg2.name, "reprefill")]))


def _hop_walls(hop):
    """A hop's grow walls: warm()'s parts (the untimed eager fill, the
    capture into a CUDA graph, the timed replay that seeds the watchdog),
    the budget it seeded, and the live grow's wall (its ``hop.grow``
    span, one replay in the grow thread)."""
    grow = hop.timings.get("grow")
    return (", ".join(f"warm {k} {v:.2f} ms" for k, v in hop.warm_ms.items())
            + f", seeded budget {hop.seeded_budget_s:.3f} s, live grow "
            + (f"{grow:.2f} ms" if grow is not None else "not recorded"))


def _decode_report(label, eng, hop=None):
    """Decode tok/s (decode tokens over the decode steps' walls) and step
    p50/p99, before, during and after the hop where there is one."""
    ms = eng.decode_step_ms()
    toks = sum(len(r.tokens) - 1 for r in eng.requests)
    line = (f"[live] {label}: {len(ms)} decode steps, "
            f"{toks / (sum(ms) / 1e3):.1f} decode tok/s")
    spans = [("all", (0, None))]
    if hop is not None and hop.completed:
        spans = [("before", (0, hop.begin_at_step)),
                 ("during", (hop.begin_at_step, hop.swap_at_step)),
                 ("after", (hop.swap_at_step, None))]
    for name, steps in spans:
        p50, p99 = eng.decode_step_percentiles(50, 99, steps=steps)
        n = len(eng.decode_step_ms(steps))
        line += f" | {name} ({n} steps) p50 {p50:.2f} ms p99 {p99:.2f} ms"
    print(line, flush=True)


def _chaos_phase(torch, stage, device="cuda"):
    """One hop gpt2-base-smoke -> 2x on the card with a one-shot failure
    injected at ``stage``: it must roll back once, for the injected cause
    alone (a watchdog HopError for "hang"), then complete on attempt 2 with
    every request done and none dropped. For "hang" the watchdog's floor
    is 0.25 s: the hung grow is aborted after 0.25 s, while 64 requests
    still decode, and the retry, a background grow beside decode steps,
    has as long."""
    from repro_torch.configs import get_config, grow_target, smoke_config
    from repro_torch.core import init_ligo_params
    from repro_torch.launch.serve import live_prompts
    from repro_torch.models.model import init_params
    from repro_torch.serving import HopController, HopError, ServingEngine
    cfg = smoke_config(get_config("gpt2-base"))
    cfg2 = grow_target(cfg)
    params = init_params(cfg, torch.Generator(device).manual_seed(0),
                         device=device)
    op = init_ligo_params(torch.Generator(device).manual_seed(1), cfg, cfg2,
                          device=device)
    eng = ServingEngine(params, cfg, slots=4, prompt_budget=16,
                        gen_budget=16, device=device)
    n_req = 64
    for p in live_prompts(n_req, 16, cfg.vocab_size):
        eng.submit(p, max_new=16)
    hop = HopController(eng, cfg2, op, fail_at=stage, backoff=0.01,
                        background=stage == "hang",
                        watchdog_floor=0.25 if stage == "hang" else 0.0)
    hop.warm()

    def on_step(e):
        if e.decode_steps >= 2 and hop.attempts == 0:
            hop.begin()
        if hop.attempts:
            hop.poll()

    eng.run(on_step=on_step)
    while not hop.poll():
        time.sleep(0.002)
    causes = [(where, type(err).__name__, str(err))
              for where, err in hop.rollbacks]
    want_where = "grow" if stage == "hang" else stage
    want_text = "watchdog" if stage == "hang" else "injected"
    c = eng.counts()
    ok = (hop.completed and hop.attempts == 2 and len(hop.rollbacks) == 1
          and hop.rollbacks[0][0] == want_where
          and isinstance(hop.rollbacks[0][1], HopError)
          and want_text in str(hop.rollbacks[0][1])
          and c["done"] == n_req and c["dropped"] == 0
          and all(len(r.tokens) == r.max_new for r in eng.requests))
    print(f"[live] chaos at {stage!r}: attempts {hop.attempts}, rollbacks "
          f"{causes}, {c['done']} done, {c['dropped']} dropped, cache "
          f"{hop.cache_path}, swap at decode step {hop.swap_at_step} of "
          f"{eng.decode_steps}; hop: {_hop_walls(hop)}", flush=True)
    if not ok:
        raise AssertionError(f"chaos at {stage!r}: the hop must roll back "
                             f"once for the injected cause alone and land "
                             f"on attempt 2 with 0 dropped; rollbacks "
                             f"{causes}, attempts {hop.attempts}, {c}")


def _live_phase(torch, shapes, llama):
    """Phase 9 (a)-(f). Returns the kernel-route runs' launches by run, the
    K3 launches by engine shape (for the JSON line's times), and what phase
    10 holds its speculative runs against: (b)'s and (c)'s tokens, (b)'s
    swap step, K3 launches and decode rate after the swap."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.serve import live_prompts
    from repro_torch.serving import ServingEngine
    t0 = time.perf_counter()
    k1_grow = _launches(shapes, False)[0]
    n_req, gen = LIVE_REQ, LIVE_GEN
    runs = {}

    def serve_run(label, argv, use_kernel=None):
        ops.reset_launch_counts()
        res = serve.main(argv, use_kernel=use_kernel)
        runs[label] = ops.launch_counts()
        return res

    # (a) the hop in the background, paged, on the kernel route
    a = serve_run("live a", LIVE_ARGS)
    cfg1, cfg2 = a["small_cfg"], a["cfg2"]
    eng, hop = _live_check(a, n_req, gen)
    if not (hop.completed and hop.attempts == 1 and not hop.rollbacks
            and hop.cache_path == "reprefill" and eng.kv_layout == "paged"
            and eng.cfg.name == cfg2.name):
        raise AssertionError(f"(a): hop completed {hop.completed}, attempts "
                             f"{hop.attempts}, rollbacks {hop.rollbacks}, "
                             f"cache {hop.cache_path}, layout "
                             f"{eng.kv_layout}")
    pc = eng.prefill_counts
    n_pre, n_post = pc[(cfg1.name, "admit")], pc[(cfg2.name, "admit")]
    n_rep = pc[(cfg2.name, "reprefill")]
    want = {"ligo_blend_expand_grouped": 3 * k1_grow,
            "ligo_blend_expand_bwd_fused": 0,
            "flash_attention": _k3_want(eng, cfg1, cfg2)}
    print(f"[live] (a) launches {runs['live a']}, want {want} (K1: warm()'s "
          f"fill and replay and the hop's replay, {k1_grow} each; K3: "
          f"{n_pre} gpt2-base prefills x "
          f"{cfg1.n_layers} + ({n_post} gpt2-medium prefills + {n_rep} "
          f"re-prefills) x {cfg2.n_layers})", flush=True)
    if runs["live a"] != want or not (n_pre and n_post and n_rep):
        raise AssertionError(f"(a) launches {runs['live a']}, want {want}")
    print(f"[live] (a) hop: {_hop_walls(hop)}; cache migration "
          f"({n_rep} re-prefills) {hop.timings['cache-grow']:.2f} ms, swap "
          f"{hop.timings['swap']:.3f}, begin to swap {hop.hop_ms:.2f}; "
          f"steps {hop.begin_at_step} -> {hop.swap_at_step}; "
          f"{a['tok_s']:.1f} tok/s over {a['wall_s']:.2f} s; paged "
          f"{a['kib_per_slot']:.1f} KiB/slot at peak ({a['peak_blocks']} "
          f"blocks) vs {a['dense_kib_per_slot']:.1f} dense", flush=True)
    _decode_report("(a) gpt2-base -> gpt2-medium, background hop", eng, hop)
    k3_engine = {"engine prefill gpt2-base": cfg1.n_layers * n_pre,
                 "engine prefill gpt2-medium": cfg2.n_layers * n_post,
                 "engine re-prefill gpt2-medium": cfg2.n_layers * n_rep}
    # the tree the grow thread published from its side stream, against a
    # grow of the same params and operator on the engine's stream: bit for
    # bit (K1 is bit-deterministic), or the background hop served a tree
    # it had not finished
    from repro_torch.core.ligo import _flatten
    from repro_torch.core.plan import plan_for
    with torch.no_grad():
        again = _flatten(plan_for(cfg1, cfg2, a["small"]).apply(
            a["ligo"], a["small"]))
    served = _flatten(eng.params)
    if sorted(served) != sorted(again) or not all(
            torch.equal(served[k], again[k]) for k in again):
        raise AssertionError("(a) the background hop's grown tree differs "
                             "from the same grow on the engine's stream")
    print(f"[live] (a) the grown tree served after the background hop: "
          f"bitwise equal to a grow on the engine's stream "
          f"({len(again)} leaves)", flush=True)
    first_a = [r.first_logits for r in eng.requests]
    del a, eng, hop, again, served

    # (b) kernel route against the plain route, the hop synchronous in both
    kb = serve_run("live b", LIVE_ARGS + ["--hop-sync"])
    pb = serve.main(LIVE_ARGS + ["--hop-sync"], use_kernel=False)
    ekb, hkb = _live_check(kb, n_req, gen)
    epb, hpb = _live_check(pb, n_req, gen)
    plain_launch = ops.launch_counts()
    if plain_launch != runs["live b"] or not (
            hkb.completed and hpb.completed
            and hkb.swap_at_step == hpb.swap_at_step):
        raise AssertionError(f"(b): the plain route launched a kernel "
                             f"({plain_launch} against {runs['live b']}) "
                             f"or the hops differ ({hkb.swap_at_step}, "
                             f"{hpb.swap_at_step})")
    errs = [_logit_err(rk.first_logits, rp.first_logits)
            for rk, rp in zip(ekb.requests, epb.requests)]
    same = sum(rk.tokens == rp.tokens
               for rk, rp in zip(ekb.requests, epb.requests))
    print(f"[live] (b) first-token logits, kernel route vs plain route, "
          f"normalised max error per request: max {max(errs):.2e} (tol "
          f"{LIVE_TOL:.0e}); tokens equal in {same}/{n_req} requests", flush=True)
    if max(errs) > LIVE_TOL:
        raise AssertionError(f"(b) first-token logits {errs}")
    vanilla = {"paged": [list(r.tokens) for r in ekb.requests],
               "swap": hkb.swap_at_step,
               "k3": runs["live b"]["flash_attention"],
               "tok_s_after": ekb.decode_tok_s((hkb.swap_at_step, None)),
               "p50_after": ekb.decode_step_percentiles(
                   50, steps=(hkb.swap_at_step, None))[0]}
    # (a) hopped in the background, (b) synchronously: one step apart, but
    # each request's first token comes from its prompt and the same model
    bg = max(_logit_err(fa, r.first_logits)
             for fa, r in zip(first_a, ekb.requests))
    print(f"[live] (a) background vs (b) synchronous hop, first-token "
          f"logits: {bg:.2e} (tol {LAYOUT_TOL:.0e})", flush=True)
    if bg > LAYOUT_TOL:
        raise AssertionError(f"(a) vs (b) first-token logits {bg:.3e}")
    del pb, epb, hpb

    # (c) paged against dense on the kernel route
    kd = serve_run("live c", LIVE_ARGS + ["--hop-sync", "--kv-layout",
                                          "dense"])
    ekd, hkd = _live_check(kd, n_req, gen)
    same = [rp.tokens == rd.tokens
            for rp, rd in zip(ekb.requests, ekd.requests)]
    first = max(_logit_err(rd.first_logits, rp.first_logits)
                for rp, rd in zip(ekb.requests, ekd.requests))
    last = max([_logit_err(rd.last_logits, rp.last_logits)
                for rp, rd, s in zip(ekb.requests, ekd.requests, same)
                if s] or [0.0])
    bitwise = all(same) and all(
        (rp.last_logits == rd.last_logits).all()
        for rp, rd in zip(ekb.requests, ekd.requests))
    print(f"[live] (c) paged vs dense: tokens equal in {sum(same)}/{n_req} "
          f"requests, bitwise equal tokens and last logits: {bitwise}; "
          f"first-token logits {first:.2e}, last-token logits {last:.2e} "
          f"(tol {LAYOUT_TOL:.0e}); KiB/slot paged {kb['kib_per_slot']:.1f} "
          f"at peak vs dense {kb['dense_kib_per_slot']:.1f}", flush=True)
    if (not hkd.completed or hkd.swap_at_step != hkb.swap_at_step
            or first > LAYOUT_TOL or last > LAYOUT_TOL):
        raise AssertionError(f"(c) paged vs dense: first {first:.3e}, last "
                             f"{last:.3e}, swap {hkd.swap_at_step} vs "
                             f"{hkb.swap_at_step}")
    vanilla["dense"] = [list(r.tokens) for r in ekd.requests]
    del kb, ekb, hkb, kd, ekd, hkd

    # (d) a LEMON hop gpt2-medium -> gpt2-medium-ff2: the cache grows in
    # place; the served logits against a run of the same requests with no
    # hop
    d = serve_run("live d", LEMON_ARGS)
    ed, hd = _live_check(d, n_req, gen)
    if not (hd.completed and hd.attempts == 1
            and hd.cache_path == "grow"):
        raise AssertionError(f"(d) LEMON hop: completed {hd.completed}, "
                             f"attempts {hd.attempts}, cache "
                             f"{hd.cache_path}")
    eng = d["engine"]
    ref = ServingEngine(d["small"], d["small_cfg"], slots=eng.slots,
                        prompt_budget=eng.prompt_budget,
                        gen_budget=eng.max_len - eng.prompt_budget,
                        device=eng.device)
    for p in live_prompts(n_req, eng.prompt_budget,
                          d["small_cfg"].vocab_size):
        ref.submit(p, max_new=gen)
    ref.run()
    same = [r.tokens == q.tokens for r, q in zip(ed.requests, ref.requests)]
    first = max(_logit_err(r.first_logits, q.first_logits)
                for r, q in zip(ed.requests, ref.requests))
    last = max([_logit_err(r.last_logits, q.last_logits)
                for r, q, s in zip(ed.requests, ref.requests, same) if s]
               or [0.0])
    print(f"[live] (d) LEMON hop {d['small_cfg'].name} -> {d['cfg2'].name}: "
          f"cache {hd.cache_path}, hop: {_hop_walls(hd)}; cache growth "
          f"{hd.timings['cache-grow']:.2f} ms, swap "
          f"{hd.timings['swap']:.3f}; against no hop: tokens equal in "
          f"{sum(same)}/{n_req} requests, first-token logits {first:.2e}, "
          f"last-token logits {last:.2e} (tol {LIVE_TOL:.0e}); launches "
          f"{runs['live d']}", flush=True)
    if first > LIVE_TOL or last > LIVE_TOL:
        raise AssertionError(f"(d) LEMON hop vs no hop: first {first:.3e}, "
                             f"last {last:.3e}")
    del d, ed, hd, ref, eng

    # (e) chaos at every stage, at smoke size
    for stage in ("grow", "cache-grow", "swap", "hang"):
        _chaos_phase(torch, stage)

    # (f) llama3-8b through the engine, no hop: phase 3b's params
    lcfg, lparams = llama
    slots, n_req, budget, gen = LLAMA_LIVE
    ops.reset_launch_counts()
    eng = ServingEngine(lparams, lcfg, slots=slots, prompt_budget=budget,
                        gen_budget=gen, device=lparams["final_norm"][
                            "scale"].device)
    for p in live_prompts(n_req, budget, lcfg.vocab_size):
        eng.submit(p, max_new=gen)
    for _ in range(4):              # first wave admitted, 3 decode steps
        eng.step()
    torch.cuda.synchronize()
    ev = _profile(torch, "llama3-8b engine decode step (4 slots, paged)",
                  eng.step)
    eng.run()
    runs["live f"] = ops.launch_counts()
    _live_check({"engine": eng, "hop": None}, n_req, gen)
    n_adm = eng.prefill_counts[(lcfg.name, "admit")]
    want = {"ligo_blend_expand_grouped": 0, "ligo_blend_expand_bwd_fused": 0,
            "flash_attention": lcfg.n_layers * n_adm}
    if runs["live f"] != want or eng.kv_layout != "paged":
        raise AssertionError(f"(f) launches {runs['live f']}, want {want}")
    k3_engine["engine prefill llama3-8b"] = lcfg.n_layers * n_adm
    _decode_report(f"(f) llama3-8b, {slots} slots, {n_req} requests of "
                   f"{min(len(r.prompt) for r in eng.requests)}-"
                   f"{max(len(r.prompt) for r in eng.requests)} tokens",
                   eng)
    del eng, ev
    print(f"[live] phase 9 {time.perf_counter() - t0:.1f} s", flush=True)
    return runs, k3_engine, vanilla


# Phase 10: speculative decoding through the live hop at full width, under
# phase 9's settings: the pre-hop model drafts K tokens a slot each round
# and the grown model verifies them. (a) greedy through phase 9 (b)'s hop,
# paged; (b) the same, dense; (c) the LEMON hop, and the float32 smoke pair;
# (d) sampled; (e) a hop failing at swap while drafting, at smoke size.
SPEC_K = 4
SPEC_ARGS = LIVE_ARGS + ["--hop-sync", "--speculative", str(SPEC_K)]
# request counts cut for time (the widths stay full): (b), (c) and (d) take
# the first 8 requests, the first wave, which the hop meets in every slot,
# so each request decodes as it did among 16
SPEC_REQ = 8
LEMON_SPEC_ARGS = ["--arch", "gpt2-medium", "--hop-operator", "lemon",
                   "--live-grow-at", "8", "--batch", "8", "--requests",
                   str(SPEC_REQ), "--prompt-len", "128", "--gen",
                   str(LIVE_GEN), "--hop-sync", "--speculative", str(SPEC_K)]
SAMPLED = dict(temperature=0.8, top_p=0.9)
# (d)'s new tokens a request, cut from LIVE_GEN for time: the hop at step 8
# still meets every slot mid-request, and rounds follow the swap
SAMPLED_GEN = 16


def _spec_smoke_cfgs():
    """The reference speculative test's float32 pair (its TINY and WIDE,
    ``tests/test_spec_decode.py``) and a third width for a second hop."""
    from repro_torch.configs.paper_models import BERT_SMALL
    tiny = BERT_SMALL.scaled(
        name="spec-tiny", n_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
        d_head=8, d_ff=64, vocab_size=64, max_seq=96, dtype="float32",
        objective="clm", encoder_only=False, causal=True)
    wide = tiny.scaled(name="spec-wide", n_heads=8, n_kv_heads=8, d_ff=96)
    wider = wide.scaled(name="spec-wider", n_heads=16, n_kv_heads=16,
                        d_ff=128)
    return tiny, wide, wider


def _hop_drive(eng, hops, hop_at):
    """Drain ``eng`` through synchronous hops: ``hops[0]`` begins at decode
    step ``hop_at``, each later one two decode steps (rounds) after the one
    before it completed, every begun one polled between steps."""
    for _ in range(100_000):
        if not eng.has_work():
            return
        eng.step()
        for prev, h in zip([None] + hops[:-1], hops):
            if h.attempts == 0 and (
                    eng.decode_steps >= hop_at if prev is None
                    else prev.completed
                    and eng.decode_steps >= prev.swap_at_step + 2):
                h.begin()
            if h.attempts:
                h.poll()
    raise AssertionError("engine did not drain")


def _spec_report(label, eng, hop, walls, vanilla=None):
    """The speculative run's acceptance, speedup estimate, draft and verify
    ms per round (p50 of the walls each round measured) and decode tok/s
    after the swap, beside the same requests' without speculation where
    given."""
    import numpy as np
    st = eng.spec_stats
    if not st.get("rounds") or len(walls) != st["rounds"]:
        raise AssertionError(f"{label}: {len(walls)} round walls, {st}")
    d50, v50 = np.percentile(np.asarray(walls), 50, axis=0)
    tok_s = eng.decode_tok_s((hop.swap_at_step, None))
    p50 = eng.decode_step_percentiles(50, steps=(hop.swap_at_step, None))[0]
    acc = st["accepted"] / max(1, st["drafted"])
    line = (f"[spec] {label}: acceptance {st['accepted']}/{st['drafted']} "
            f"({acc:.3f}) in {st['rounds']} rounds, first round "
            f"{st['first_round_acc']:.3f}, est_speedup "
            f"{st['est_speedup']:.3f}x | a round: draft p50 {d50:.2f} ms, "
            f"verify p50 {v50:.2f} ms, wall p50 {p50:.2f} ms | after the "
            f"swap {tok_s:.1f} decode tok/s")
    if vanilla is not None:
        line += (f"; without speculation {vanilla['tok_s_after']:.1f} "
                 f"decode tok/s, step p50 {vanilla['p50_after']:.2f} ms: "
                 f"measured {tok_s / vanilla['tok_s_after']:.3f}x against "
                 f"est {st['est_speedup']:.3f}x")
    print(line, flush=True)


def _spec_phase(torch, shapes, vanilla, device="cuda"):
    """Phase 10 (a)-(e). Returns the launches of its full-width runs by run
    and (a)'s K3 launches by engine shape."""
    from repro_torch.core.operators import lemon_operator
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.serve import live_prompts
    from repro_torch.models.model import init_params
    from repro_torch.serving import HopController, HopError, ServingEngine
    from repro_torch.serving import speculative as spec
    t0 = time.perf_counter()
    k1_grow = _launches(shapes, False)[0]
    dev = torch.device(device)
    runs, walls = {}, []
    # each round's draft and verify walls, as the engine measures them
    telemetry = ServingEngine._spec_telemetry

    def recorded(self, n_active, acc_total, t_draft, t_verify):
        walls.append((t_draft * 1e3, t_verify * 1e3))
        return telemetry(self, n_active, acc_total, t_draft, t_verify)

    def serve_run(label, argv):
        ops.reset_launch_counts()
        walls.clear()
        # deterministic rounds: the auto-disable reads wall clocks
        res = serve.main(argv, spec_autodisable=False)
        runs[label] = ops.launch_counts()
        return res

    ServingEngine._spec_telemetry = recorded
    try:
        # (a) greedy speculation through phase 9 (b)'s hop, paged
        for fn in (spec.make_draft_fn, spec.make_sampled_draft_fn,
                   spec.make_verify_fn):
            fn.cache_clear()
        spec.BUILD_COUNTS.clear()
        a = serve_run("spec a", SPEC_ARGS)
        eng, hop = _live_check(a, LIVE_REQ, LIVE_GEN)
        builds = dict(spec.BUILD_COUNTS.items())
        cfg1, cfg2 = a["small_cfg"], a["cfg2"]
        st, pc = eng.spec_stats, eng.prefill_counts
        n_draft = pc[(cfg1.name, "draft")]
        toks = [list(r.tokens) for r in eng.requests]
        same = sum(t == v for t, v in zip(toks, vanilla["paged"]))
        want = {"ligo_blend_expand_grouped": 3 * k1_grow,
                "ligo_blend_expand_bwd_fused": 0,
                "flash_attention": vanilla["k3"] + cfg1.n_layers * n_draft}
        print(f"[spec] (a) {cfg1.name} drafts K={SPEC_K} for {cfg2.name}, "
              f"paged: tokens equal to phase 9 (b) in {same}/{LIVE_REQ} "
              f"requests; swap at step {hop.swap_at_step} (9 (b): "
              f"{vanilla['swap']}); {n_draft} drafter prefills; launches "
              f"{runs['spec a']}, want {want} (K1: warm()'s fill and "
              f"replay and the hop's replay; K3: 9 (b)'s "
              f"{vanilla['k3']} + {cfg1.n_layers} x {n_draft}); "
              f"serve.spec.builds {builds}; hop: {_hop_walls(hop)}",
              flush=True)
        if not (hop.completed and hop.attempts == 1
                and hop.cache_path == "reprefill"
                and hop.swap_at_step == vanilla["swap"]
                and st["rounds"] > 0 and st["drafter"] == cfg1.name
                and st["disabled"] is None
                and n_draft == pc[(cfg2.name, "admit")] > 0):
            raise AssertionError(f"(a): hop {hop.completed}/{hop.attempts} "
                                 f"{hop.cache_path} at {hop.swap_at_step}, "
                                 f"spec {st}, prefills {dict(pc)}")
        if same != LIVE_REQ:
            raise AssertionError(f"(a) greedy speculation differs from "
                                 f"greedy decoding in {LIVE_REQ - same} "
                                 f"requests")
        if builds != {"draft": 1, "verify": 1}:
            raise AssertionError(f"(a) serve.spec.builds {builds}: one "
                                 f"draft and one verify build")
        if runs["spec a"] != want:
            raise AssertionError(f"(a) launches {runs['spec a']}, want "
                                 f"{want}")
        _spec_report("(a) paged", eng, hop, walls, vanilla)
        _decode_report("(a) speculative, gpt2-base -> gpt2-medium", eng,
                       hop)
        k3_spec = {"engine prefill gpt2-base": cfg1.n_layers * (
                       pc[(cfg1.name, "admit")] + n_draft),
                   "engine prefill gpt2-medium":
                       cfg2.n_layers * pc[(cfg2.name, "admit")],
                   "engine re-prefill gpt2-medium":
                       cfg2.n_layers * pc[(cfg2.name, "reprefill")]}
        small, ligo = a["small"], a["ligo"]
        del a, eng, hop

        # (b) the same, dense, the first SPEC_REQ requests
        b = serve_run("spec b", SPEC_ARGS + ["--kv-layout", "dense",
                                             "--requests", str(SPEC_REQ)])
        eb, hb = _live_check(b, SPEC_REQ, LIVE_GEN)
        same = sum(list(r.tokens) == v
                   for r, v in zip(eb.requests, vanilla["dense"]))
        print(f"[spec] (b) dense, the first {SPEC_REQ} requests: tokens "
              f"equal to phase 9 (c) (dense, no speculation) in "
              f"{same}/{SPEC_REQ}; swap at step {hb.swap_at_step}; "
              f"{eb.spec_stats['rounds']} rounds; launches {runs['spec b']}",
              flush=True)
        if (same != SPEC_REQ or hb.swap_at_step != vanilla["swap"]
                or eb.kv_layout != "dense" or not eb.spec_stats["rounds"]
                or runs["spec b"]["flash_attention"]
                != _k3_want(eb, cfg1, cfg2)):
            raise AssertionError(f"(b) dense speculation differs from dense "
                                 f"decoding: {same}/{SPEC_REQ}, swap "
                                 f"{hb.swap_at_step}, {runs['spec b']}")
        _spec_report("(b) dense", eb, hb, walls)
        del b, eb, hb

        # (c) the LEMON hop with speculation, bf16 at full width (no bound
        # on its acceptance: bf16 GEMMs at the doubled d_ff sum in another
        # order) ...
        c = serve_run("spec c", LEMON_SPEC_ARGS)
        ec, hc = _live_check(c, SPEC_REQ, LIVE_GEN)
        if not (hc.completed and hc.cache_path == "grow"
                and ec.spec_stats["rounds"] > 0
                and runs["spec c"]["flash_attention"]
                == _k3_want(ec, c["small_cfg"], c["cfg2"])):
            raise AssertionError(f"(c) LEMON: hop {hc.completed}, cache "
                                 f"{hc.cache_path}, spec {ec.spec_stats}, "
                                 f"launches {runs['spec c']}")
        _spec_report(f"(c) LEMON {c['small_cfg'].name} -> "
                     f"{c['cfg2'].name}", ec, hc, walls)
        del c, ec, hc
        # ... and the float32 smoke pair: the first round accepts every draft
        tiny, wide, wider = _spec_smoke_cfgs()
        tp = init_params(tiny, torch.Generator(dev).manual_seed(0),
                         device=dev)
        prompts = live_prompts(6, 8, tiny.vocab_size)

        def smoke_run(hop_list, gen=24):
            e = ServingEngine(tp, tiny, slots=2, prompt_budget=8,
                              gen_budget=gen, spec_k=SPEC_K,
                              spec_autodisable=False, device=dev)
            for p in prompts:
                e.submit(p, max_new=gen)
            hs = [HopController(e, c2, op, backoff=0.01, background=False,
                                **hkw) for c2, op, hkw in hop_list]
            _hop_drive(e, hs, 3)
            return e, hs

        es, hs = smoke_run([(wide, lemon_operator(tiny, wide, device=dev),
                             {})])
        print(f"[spec] (c) float32 smoke pair {tiny.name} -> {wide.name}: "
              f"first round {es.spec_stats['first_round_acc']}, acceptance "
              f"{es.spec_stats['accepted']}/{es.spec_stats['drafted']}",
              flush=True)
        if not (hs[0].completed and es.spec_stats["first_round_acc"] == 1.0):
            raise AssertionError("(c) float32 LEMON: the first round must "
                                 "accept every draft")

        # (d) sampled speculation through (a)'s hop: one seed twice gives
        # the same tokens, another seed others
        sampled = {}
        for label, seed in (("42", 42), ("42 again", 42), ("7", 7)):
            ops.reset_launch_counts()
            walls.clear()
            e = ServingEngine(small, cfg1, slots=8, prompt_budget=128,
                              gen_budget=SAMPLED_GEN, spec_k=SPEC_K,
                              spec_autodisable=False, seed=seed, device=dev,
                              **SAMPLED)
            for p in live_prompts(SPEC_REQ, 128, cfg1.vocab_size):
                e.submit(p, max_new=SAMPLED_GEN)
            h = HopController(e, cfg2, ligo, background=False)
            _hop_drive(e, [h], 8)
            runs[f"spec d seed {label}"] = ops.launch_counts()
            _live_check({"engine": e, "hop": h}, SPEC_REQ, SAMPLED_GEN)
            sampled[label] = [list(r.tokens) for r in e.requests]
            _spec_report(f"(d) sampled, seed {label}", e, h, walls)
            del e, h
        print(f"[spec] (d) seed 42 twice: tokens equal "
              f"{sampled['42'] == sampled['42 again']}; seed 7 differs: "
              f"{sampled['42'] != sampled['7']}", flush=True)
        if (sampled["42"] != sampled["42 again"]
                or sampled["42"] == sampled["7"]):
            raise AssertionError("(d) sampled speculation must repeat under "
                                 "one seed and change under another")
        del small, ligo

        # (e) a second hop failing at swap while the first hop's drafter
        # drafts: rolled back for the injected cause, nothing dropped or
        # rejected, and the retry lands while drafting
        e, hs = smoke_run([
            (wide, lemon_operator(tiny, wide, device=dev), {}),
            (wider, lemon_operator(wide, wider, device=dev),
             {"fail_at": "swap"})], gen=32)
        rb = [(w, type(err).__name__, str(err)) for w, err in hs[1].rollbacks]
        cnt = e.counts()
        print(f"[spec] (e) second hop failing at 'swap' while drafting: "
              f"rollbacks {rb}, attempts {hs[1].attempts}, serving "
              f"{e.cfg.name}, drafter {e.spec_stats['drafter']} "
              f"({e.spec_stats['rounds']} rounds since), {cnt}", flush=True)
        if not (hs[0].completed and hs[1].completed and hs[1].attempts == 2
                and len(rb) == 1 and rb[0][0] == "swap"
                and isinstance(hs[1].rollbacks[0][1], HopError)
                and "injected" in rb[0][2] and e.cfg.name == wider.name
                and e.spec_stats["drafter"] == wide.name
                and e.spec_stats["rounds"] > 0
                and cnt["dropped"] == 0 and cnt["rejected"] == 0
                and cnt["done"] == len(prompts)):
            raise AssertionError("(e) a hop failing at swap while drafting "
                                 "must roll back for the injected cause "
                                 "with 0 dropped and land on its retry")
        del e, hs
    finally:
        ServingEngine._spec_telemetry = telemetry
    print(f"[spec] phase 10 {time.perf_counter() - t0:.1f} s", flush=True)
    return runs, k3_spec


# Phase 11: the observability layer at full width, on phase 9's live serve
# and a cut-down phase 6 trajectory, through the launchers' obs flags.
OBS_TRAJ = {"arch": "gpt2-base", "batch": 8, "seq": 128, "lr": 1e-3,
            "checkpoint_every": 2, "seed": 0,
            "stages": [{"steps": 2},
                       {"steps": 2, "arch": "gpt2-medium", "method": "ligo",
                        "ligo_steps": 2, "ligo_scan_chunk": 1}]}
# (c): the profiled serve's requests and new tokens (a smaller trace to
# write and read; the hop at step 8 still meets live sessions)
OBS_PROFILE_REQ, OBS_PROFILE_GEN = 4, 16


def _obs_log(path):
    """The records of an ``--obs-log`` file, which must open and close with
    its meta lines."""
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    if not (recs and recs[0].get("event") == "obs-log-open"
            and recs[-1].get("event") == "obs-log-close"):
        raise AssertionError(f"{path}: the log does not open and close with "
                             f"its meta lines")
    return recs


def _timeline_balanced(label, events):
    """Every ``B`` matched by an ``E`` on its tid, one async pair per
    ``hop.*`` span; returns the number of duration spans."""
    stacks, n = {}, 0
    for e in events:
        if e["ph"] == "B":
            stacks.setdefault(e["tid"], []).append(e["name"])
            n += 1
        elif e["ph"] == "E":
            st = stacks.get(e["tid"])
            if not st or st.pop() != e["name"]:
                raise AssertionError(f"{label}: an E without its B: {e}")
    hop_b = sorted(e["name"] for e in events
                   if e["ph"] == "B" and e["name"].startswith("hop."))
    pairs = [sorted(e["name"] for e in events if e["ph"] == ph)
             for ph in ("b", "e")]
    if any(stacks.values()) or pairs != [hop_b, hop_b]:
        raise AssertionError(f"{label}: unmatched B/E {stacks} or async "
                             f"pairs {pairs} against hop spans {hop_b}")
    return n


def _live_launch_check(label, launches, eng, cfg1, cfg2, k1_grows, k1_grow):
    want = {"ligo_blend_expand_grouped": k1_grows * k1_grow,
            "ligo_blend_expand_bwd_fused": 0,
            "flash_attention": _k3_want(eng, cfg1, cfg2)}
    if launches != want:
        raise AssertionError(f"{label} launches {launches}, want {want}")


def _k3_by_shape(eng, cfg1, cfg2):
    pc = eng.prefill_counts
    return {"engine prefill gpt2-base": cfg1.n_layers * pc[(cfg1.name,
                                                            "admit")],
            "engine prefill gpt2-medium": cfg2.n_layers * pc[(cfg2.name,
                                                              "admit")],
            "engine re-prefill gpt2-medium": cfg2.n_layers * pc[
                (cfg2.name, "reprefill")]}


def _obs_phase(torch, shapes):
    """Phase 11 (a)-(d). Returns the launches of its runs by run and their
    K3 launches by engine shape."""
    from repro_torch import obs
    from repro_torch.kernels import ops
    from repro_torch.launch import serve, train
    t0 = time.perf_counter()
    k1_grow = _launches(shapes, False)[0]
    k1_grad, k2_grad = _launches(shapes, True)
    runs, k3 = {}, {}
    steps = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    chaos = LIVE_ARGS + ["--fail-at-hop", "cache-grow"]

    def serve_run(label, argv, n_req=LIVE_REQ, gen=LIVE_GEN):
        ops.reset_launch_counts()
        res, out = _main_teed(serve, argv)
        runs[label] = ops.launch_counts()
        eng, hop = _live_check(res, n_req, gen)
        cfg1, cfg2 = res["small_cfg"], res["cfg2"]
        for shape, n in _k3_by_shape(eng, cfg1, cfg2).items():
            k3[shape] = k3.get(shape, 0) + n
        steps[label] = (eng.decode_steps,) + eng.decode_step_percentiles(
            50, 99)
        return res, out, eng, hop, cfg1, cfg2

    try:
        # (a) phase 9 (a)'s serve with the hop failing once at cache-grow,
        # and every obs flag but the profiler
        d = os.path.join(tmp, "a")
        obs.REGISTRY.reset()
        obs.FLIGHT.clear()
        res, out, eng, hop, cfg1, cfg2 = serve_run("obs a", chaos + [
            "--obs-log", os.path.join(d, "run.jsonl"), "--obs-report",
            "--timeline", os.path.join(d, "timeline.json"),
            "--metrics-port", "0"])
        srv = res["metrics_server"]
        try:
            url = f"http://127.0.0.1:{srv.server_address[1]}/metrics"
            with urllib.request.urlopen(url, timeout=30) as r:
                scrape = r.read().decode()
        finally:
            srv.shutdown()
            srv.server_close()
        obs.set_dump_dir(None)
        # warm()'s fill and replay, and one replay an attempt
        _live_launch_check("(a)", runs["obs a"], eng, cfg1, cfg2, 4, k1_grow)
        if not (hop.completed and hop.attempts == 2
                and [s for s, _ in hop.rollbacks] == ["cache-grow"]):
            raise AssertionError(f"(a): attempts {hop.attempts}, rollbacks "
                                 f"{hop.rollbacks}")
        recs = _obs_log(os.path.join(d, "run.jsonl"))
        spans = [r for r in recs if r["type"] == "span"]
        events = [r for r in recs if r["type"] == "event"]

        def named(rs, name):
            return [r for r in rs if r["name"] == name]

        grows = named(spans, "hop.grow")
        caches = named(spans, "hop.cache-grow")
        (rb,) = named(events, "hop.rollback")
        n_pre = sum(n for (_, kind), n in eng.prefill_counts.items()
                    if kind == "admit")
        dumps = [f for f in os.listdir(d) if f.startswith("flightrec-")]
        with open(os.path.join(d, dumps[0]) if dumps else os.devnull) as f:
            dump = [json.loads(line) for line in f]
        with open(os.path.join(d, "timeline.json")) as f:
            tl = json.load(f)["traceEvents"]
        n_tl = _timeline_balanced("(a) timeline", tl)
        m = re.search(r"^serve_decode_step_ms_count (\d+)$", scrape, re.M)
        checks = {
            "hop.warm": len(named(spans, "hop.warm")) == 1,
            "hop.begin": len(named(events, "hop.begin")) == 1,
            "hop.grow on hop-grow-N": len(grows) == 2 and all(
                g["thread"].startswith("hop-grow-") for g in grows),
            "hop.cache-grow error, then reprefill": len(caches) == 2
            and "error" in caches[0] and caches[0]["attrs"]["attempt"] == 1
            and "error" not in caches[1]
            and caches[1]["attrs"]["mode"] == "reprefill",
            "hop.rollback": rb["attrs"]["stage"] == "cache-grow"
            and rb["attrs"]["dropped"] == 0,
            "hop.retry": len(named(events, "hop.retry")) == 1,
            "hop.swap": len(named(spans, "hop.swap")) == 1,
            "serve.install": len(named(events, "serve.install")) == 1,
            "hop.complete": len(named(events, "hop.complete")) == 1,
            "one dump": len(dumps) == 1
            and dumps[0].endswith("-hop-cache-grow.jsonl")
            and dump[0]["type"] == "dump",
            "serve.prefill = admissions": len(named(spans, "serve.prefill"))
            == n_pre,
            "scrape": m is not None and int(m.group(1)) == eng.decode_steps,
            "report": "[obs] hop stages:" in out
            and "rollback at stage=cache-grow" in out,
        }
        by_stage = {f"{s['name']}#{s['attrs']['attempt']}": s["dur_ms"]
                    for s in spans if s["name"] in (
                        "hop.grow", "hop.cache-grow", "hop.swap")}
        print(f"[obs] (a) serve with --fail-at-hop cache-grow: "
              f"{len(recs)} log lines ({len(spans)} spans, {len(events)} "
              f"events), {len(tl)} timeline events ({n_tl} spans), dump "
              f"{dumps}, /metrics decode steps {m and m.group(1)} of "
              f"{eng.decode_steps}, serve.prefill spans "
              f"{len(named(spans, 'serve.prefill'))} = admissions {n_pre}; "
              f"launches {runs['obs a']}; hop span ms {by_stage}, hop.warm "
              f"{named(spans, 'hop.warm')[0]['dur_ms']}; hop: "
              f"{_hop_walls(hop)}", flush=True)
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"(a) obs checks failed: {failed}")
        del res, eng, hop

        # (b) a trajectory through the train launcher with its obs flags
        d = os.path.join(tmp, "b")
        os.makedirs(d)
        sched = os.path.join(d, "traj.json")
        with open(sched, "w") as f:
            json.dump(OBS_TRAJ, f)
        obs.REGISTRY.reset()
        obs.FLIGHT.clear()
        ops.reset_launch_counts()
        tb = time.perf_counter()
        tres, out = _main_teed(train, [
            "--trajectory", sched, "--ckpt-dir", os.path.join(d, "ck"),
            "--keep-checkpoints", "1", "--ledger",
            os.path.join(d, "ledger.jsonl"), "--obs-log",
            os.path.join(d, "run.jsonl"), "--timeline",
            os.path.join(d, "timeline.json"), "--obs-report"])
        runs["obs b"] = ops.launch_counts()
        n_ligo = OBS_TRAJ["stages"][1]["ligo_steps"]
        want = {"ligo_blend_expand_grouped": k1_grad * n_ligo + 3 * k1_grow,
                "ligo_blend_expand_bwd_fused": k2_grad * n_ligo,
                "flash_attention": 0}
        recs = _obs_log(os.path.join(d, "run.jsonl"))
        names = [r["name"] for r in recs if r["type"] == "span"]
        count = {n: names.count(n) for n in (
            "ligo.chunk", "ligo.checkpoint", "traj.train", "traj.grow")}
        hist = {h: obs.histogram(h).count for h in (
            "ligo.chunk_ms", "ligo.checkpoint_ms", "traj.stage.train_ms",
            "traj.stage.grow_ms")}
        with open(os.path.join(d, "timeline.json")) as f:
            tl = json.load(f)["traceEvents"]
        _timeline_balanced("(b) timeline", tl)
        ledger_track = [e for e in tl if e.get("tid") == 0
                        and e["ph"] in ("C", "i")]
        n_steps = sum(st["steps"] for st in OBS_TRAJ["stages"]) + n_ligo
        walls = {r["name"]: r["dur_ms"] for r in recs
                 if r["type"] == "span" and r["name"] == "traj.grow"}
        chunk_ms = [r["dur_ms"] for r in recs if r.get("name") ==
                    "ligo.chunk"]
        print(f"[obs] (b) trajectory {time.perf_counter() - tb:.1f} s: spans "
              f"{count}, histograms {hist}, ligo.chunk ms {chunk_ms}, "
              f"traj.grow ms {walls.get('traj.grow')}; timeline ledger "
              f"track {len(ledger_track)} events; launches {runs['obs b']}",
              flush=True)
        if not (tres["status"] == "done" and count["ligo.chunk"] == n_ligo
                and count["ligo.checkpoint"] >= 1
                and count["traj.train"] == 2 and count["traj.grow"] == 1
                and list(hist.values()) == list(count.values())
                and sum(e["ph"] == "C" and e["name"] == "ledger.loss"
                        for e in ledger_track) == n_steps
                and "[obs] ligo chunk: n=2" in out
                and runs["obs b"] == want):
            raise AssertionError(f"(b): status {tres['status']}, spans "
                                 f"{count}, histograms {hist}, ledger track "
                                 f"{len(ledger_track)}, launches "
                                 f"{runs['obs b']} (want {want})")
        del tres

        # (d) the cost of the layer, printed and not gated: (a)'s serve
        # without the obs flags, and with the layer switched off
        serve_run("obs d plain", chaos)
        obs.set_enabled(False)
        try:
            serve_run("obs d off", chaos)
        finally:
            obs.set_enabled(True)
        print("[obs] (d) decode step through the hop, host clock (not "
              "gated; host clocks move +-40 % between calls): " + "; ".join(
                  f"{label} {n} steps p50 {p50:.2f} ms p99 {p99:.2f} ms"
                  for label, (n, p50, p99) in (
                      ("(a) obs flags on", steps["obs a"]),
                      ("no obs flags", steps["obs d plain"]),
                      ("obs.set_enabled(False)", steps["obs d off"]))),
              flush=True)

        # (c) the profiler gate, last: the profiler slows the host for the
        # rest of the process
        d = os.path.join(tmp, "c")
        res, _, eng, hop, cfg1, cfg2 = serve_run("obs c", LIVE_ARGS + [
            "--requests", str(OBS_PROFILE_REQ), "--gen",
            str(OBS_PROFILE_GEN), "--obs-profile", d],
            n_req=OBS_PROFILE_REQ, gen=OBS_PROFILE_GEN)
        _live_launch_check("(c)", runs["obs c"], eng, cfg1, cfg2, 3, k1_grow)
        (trace,) = os.listdir(d)
        with open(os.path.join(d, trace)) as f:
            kern = [e["name"] for e in json.load(f)["traceEvents"]
                    if e.get("cat") == "kernel"]
        n_k1 = sum("ligo_wgmma_gemm_kernel<3," in k for k in kern)
        n_k3 = sum("flash_fwd_wgmma" in k for k in kern)
        print(f"[obs] (c) profiled serve of {OBS_PROFILE_REQ} requests: "
              f"{len(kern)} CUDA kernels in the trace, {n_k1} of K1's "
              f"tensor-core GEMM, {n_k3} flash_fwd_wgmma (launches "
              f"{runs['obs c']})", flush=True)
        if not (n_k1 and n_k3):
            raise AssertionError("(c) the profiler trace names no K1 "
                                 "tensor-core GEMM or no flash_fwd_wgmma")
        del res, eng, hop
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[obs] phase 11 {time.perf_counter() - t0:.1f} s", flush=True)
    return runs, k3


# Phase 12: the adaptive growth controller through train --autogrow at full
# width. Stage 0 trains gpt2-base under a probe policy whose tol 1.0 fires
# as soon as the ring is full: stage step 3 (min_steps 3, window 3); the
# probe then short-trains the three candidates into gpt2-medium. Stage 1
# learns the picked operator (2 LiGO steps in chunks of 1 when ligo wins)
# and trains gpt2-medium under rpf_decay to its cap of 4 steps (its ring of
# 16 never fills, so it records no decision).
AUTO = {"arch": "gpt2-base", "batch": 8, "seq": 128, "lr": 1e-3,
        "checkpoint_every": 2, "seed": 0,
        "stages": [
            {"steps": "auto",
             "policy": {"kind": "probe", "max_steps": 8, "min_steps": 3,
                        "window": 3, "tol": 1.0,
                        "probe_candidates": ["ligo", "stackbert",
                                             "interpolation"],
                        "probe_steps": 4, "probe_ligo_steps": 2}},
            {"steps": "auto", "arch": "gpt2-medium", "method": "ligo",
             "ligo_steps": 2, "ligo_scan_chunk": 1,
             "policy": {"kind": "rpf_decay", "max_steps": 4}}]}
AUTO_FIRES_AT = 3
# stage 0 of AUTO as a static stage of the same budget (so the same
# learning-rate schedule), paused at AUTO_FIRES_AT: the stage-end state the
# hop grows from
AUTO_STAGE0 = {**AUTO, "stages": [{"steps": AUTO["stages"][0]["policy"][
    "max_steps"]}]}


def _autogrow_predictions(shapes):
    """K1 and K2 launches of AUTO's probe and committed hop, by the method
    the probe picks: the ligo candidate's probe_ligo_steps LiGO steps and
    every candidate's three grows (params, m, v), then the committed hop:
    the stage's LiGO steps when ligo wins, and three grows."""
    k1_grad, k2_grad = _launches(shapes, True)
    k1_grow = _launches(shapes, False)[0]
    pol = AUTO["stages"][0]["policy"]
    n_ligo = AUTO["stages"][1]["ligo_steps"]
    probe = {"ligo_blend_expand_grouped": (k1_grad * pol["probe_ligo_steps"]
                                           + 3 * k1_grow
                                           * len(pol["probe_candidates"])),
             "ligo_blend_expand_bwd_fused": k2_grad * pol["probe_ligo_steps"],
             "flash_attention": 0}
    out = {}
    for method in pol["probe_candidates"]:
        steps = n_ligo if method == "ligo" else 0
        out[method] = {
            "ligo_blend_expand_grouped": (probe["ligo_blend_expand_grouped"]
                                          + k1_grad * steps + 3 * k1_grow),
            "ligo_blend_expand_bwd_fused": (
                probe["ligo_blend_expand_bwd_fused"] + k2_grad * steps),
            "flash_attention": 0}
    return out


def _autogrow_phase(torch, shapes):
    """Phase 12: run AUTO uninterrupted (A) and paused at global step 2 and
    relaunched (B); hold the decisions, the probe's scores, the ledgers,
    the final state, the telemetry snapshots and the post-growth snapshot.
    Returns the launches of its runs by run."""
    from repro_torch import obs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.grow import grow
    from repro_torch.data import GlobalBatchLoader
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models.model import init_params
    from repro_torch.obs import costs
    from repro_torch.obs.ledger import normalize_records, read_ledger
    from repro_torch.optim import adamw_init
    from repro_torch.trajectory import TrajectoryConfig
    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True)
    obs.set_enabled(True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_auto_")
    runs = {}
    want = _autogrow_predictions(shapes)
    print("[auto] predicted K1/K2 launches of A (probe of "
          f"{AUTO['stages'][0]['policy']['probe_candidates']} + the committed "
          "hop), by the pick: " + "; ".join(
              f"{m}: K1 {w['ligo_blend_expand_grouped']}, K2 "
              f"{w['ligo_blend_expand_bwd_fused']}" for m, w in want.items()),
          flush=True)
    paths = {}
    for name, sched in (("auto", AUTO), ("stage0", AUTO_STAGE0)):
        paths[name] = os.path.join(tmp, f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(sched, f)

    def args(run, *extra):
        return ["--autogrow", paths["auto"], "--ckpt-dir",
                os.path.join(tmp, f"ck_{run}"), "--ledger",
                os.path.join(tmp, f"{run}.jsonl"), "--keep-checkpoints", "3",
                *extra]
    c1, c2 = (st.cfg for st in TrajectoryConfig.from_json(AUTO).stages)
    try:
        try:
            train.main(["--trajectory", paths["auto"], "--ckpt-dir",
                        os.path.join(tmp, "ck_refused")])
        except SystemExit as e:
            if "run it with --autogrow" not in str(e):
                raise
            print(f"[auto] --trajectory refuses the schedule: {e}",
                  flush=True)
        else:
            raise AssertionError("--trajectory ran a schedule with auto "
                                 "stages")

        # -- A: uninterrupted ----------------------------------------------
        costs.clear_measurements()
        obs.FLIGHT.clear()
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t_a = time.perf_counter()
        res_a, out_a = _main_teed(train, args("A"))
        runs["autogrow A"] = ops.launch_counts()
        sec_a = time.perf_counter() - t_a
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        dec = res_a["decisions"]
        if res_a["status"] != "done" or len(dec) != 2:
            raise AssertionError(f"A: status {res_a['status']}, decisions "
                                 f"{dec}")
        fired, probe = dec
        if (fired["kind"], fired["stage"], fired["stage_step"],
                fired["global_step"]) != ("probe", 0, AUTO_FIRES_AT,
                                          AUTO_FIRES_AT):
            raise AssertionError(f"A: the plateau decision {fired}, want "
                                 f"stage 0 step {AUTO_FIRES_AT}")
        scores, picked = probe["scores"], probe["picked"]
        if (list(scores) != AUTO["stages"][0]["policy"]["probe_candidates"]
                or not all(math.isfinite(v) for v in scores.values())
                or picked != min(scores, key=scores.get)):
            raise AssertionError(f"A: probe decision {probe}")
        if out_a.count("[train] autogrow decision: ") != 2:
            raise AssertionError("A: not one decision line per decision")
        if runs["autogrow A"] != want[picked]:
            raise AssertionError(f"A: launches {runs['autogrow A']}, the "
                                 f"plan predicts {want[picked]} for a "
                                 f"probe picking {picked}")
        walls = {s["attrs"]["method"]: s["dur_ms"]
                 for s in obs.FLIGHT.events(type="span")
                 if s["name"] == "autogrow.probe"}
        recs_a = read_ledger(os.path.join(tmp, "A.jsonl"))
        ev = {r["name"]: r["attrs"] for r in recs_a if r["type"] == "event"}
        if (ev["probe"]["picked"] != picked
                or ev["probe"]["scores"] != dict(sorted(scores.items()))
                or ev["hop.begin"]["method"] != picked):
            raise AssertionError(f"A: ledger events {ev}")
        print(f"[auto] A: {sec_a:.1f} s; fired at stage step "
              f"{fired['stage_step']} ({fired['why']}); probe picked "
              f"{picked}: " + ", ".join(
                  f"{m} {v:.6f} ({walls[m]:.0f} ms)"
                  for m, v in scores.items())
              + f"; launches {runs['autogrow A']} as predicted; peak "
              f"memory {peak_gb:.2f} GB (torch.cuda.max_memory_allocated)",
              flush=True)

        # the telemetry snapshots: cum_flops is the measured FLOPs of a
        # step, added once per recorded step
        fps = [costs.measurement(f"train_step[{c.name}]")["flops_per_unit"]
               for c in (c1, c2)]
        mgr_a = CheckpointManager(os.path.join(tmp, "ck_A"))
        last = mgr_a.latest_meta()["autogrow"]
        _tele_check(last, fps[1],
                    AUTO["stages"][1]["policy"]["max_steps"], "A's last")

        # -- the post-growth snapshot against a direct grow() -------------
        ops.reset_launch_counts()
        res_c, _ = _main_teed(train, [
            "--trajectory", paths["stage0"], "--ckpt-dir",
            os.path.join(tmp, "ck_C"), "--max-steps", str(AUTO_FIRES_AT)])
        runs["autogrow stage-end"] = ops.launch_counts()
        st1 = AUTO["stages"][1]
        with torch.no_grad():
            tmpl = init_params(c2, torch.Generator().manual_seed(0),
                               device="meta")
        snap, meta = mgr_a.restore(AUTO_FIRES_AT, {
            "params": tmpl, "opt": adamw_init(tmpl)}, "cuda")
        if (meta["stage"], meta["stage_step"]) != (1, 0):
            raise AssertionError(f"step {AUTO_FIRES_AT} of A is not the "
                                 f"post-growth snapshot: {meta}")
        big, info = grow(
            res_c["params"], c1, c2, method=picked,
            gen=torch.Generator(device="cuda").manual_seed(AUTO["seed"] + 7),
            data_it=iter(GlobalBatchLoader(
                c1, AUTO["batch"], AUTO["seq"],
                seed=AUTO["seed"] + 101 + 53, device="cuda")),
            ligo_steps=st1["ligo_steps"],
            ligo_scan_chunk=st1["ligo_scan_chunk"], opt_state=res_c["opt"])
        n_snap = _assert_equal_trees(torch, snap["params"], big,
                                     "A's post-growth params and a direct "
                                     f"grow({picked}) of the stage-end "
                                     "state")
        _assert_equal_trees(torch, snap["opt"], info["opt_state"],
                            "A's post-growth AdamW state and the direct "
                            "grow's")
        print(f"[auto] A's post-growth snapshot (step {AUTO_FIRES_AT}) "
              f"equals grow(method={picked}) of the stage-end state "
              f"bitwise ({n_snap} params, AdamW m, v and count)", flush=True)
        del res_c, snap, big, info
        shutil.rmtree(os.path.join(tmp, "ck_C"))

        # -- B: paused at global step 2, relaunched -----------------------
        ops.reset_launch_counts()
        t_b = time.perf_counter()
        res_b1, _ = _main_teed(train, args("B", "--max-steps", "2"))
        if res_b1["status"] != "paused" or res_b1["global_step"] != 2:
            raise AssertionError(f"B: {res_b1['status']} at "
                                 f"{res_b1['global_step']}")
        del res_b1
        mid = CheckpointManager(os.path.join(tmp, "ck_B")).latest_meta()
        _tele_check(mid["autogrow"], fps[0], 2, "B's paused")
        res_b, _ = _main_teed(train, args("B"))
        runs["autogrow B"] = ops.launch_counts()
        sec_b = time.perf_counter() - t_b
        if res_b["resumed_at"] != (0, 2) or res_b["decisions"] != dec:
            raise AssertionError(f"B: resumed at {res_b['resumed_at']}, "
                                 f"decisions {res_b['decisions']} against "
                                 f"A's {dec}")
        recs_b = read_ledger(os.path.join(tmp, "B.jsonl"))
        if normalize_records(recs_a) != normalize_records(recs_b):
            raise AssertionError("the ledgers of A and B differ")
        n_par = _assert_equal_trees(torch, res_a["params"], res_b["params"],
                                    "final params of A and B")
        _assert_equal_trees(torch, res_a["opt"], res_b["opt"],
                            "final AdamW state of A and B")
        print(f"[auto] B: {sec_b:.1f} s for the paused and the relaunched "
              f"run; decisions and probe scores bit-equal to A's; "
              f"{len(recs_a)} ledger records identical; final params "
              f"({n_par} values) and AdamW state bitwise equal; launches "
              f"{runs['autogrow B']}", flush=True)
        del res_a, res_b
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    print(f"[auto] phase 12 {time.perf_counter() - t0:.1f} s", flush=True)
    return runs


def _tele_check(snap, fps, n, label):
    """A checkpoint's telemetry snapshot holds ``n`` recorded steps whose
    cumulative FLOPs are the measured ``fps`` added once a step."""
    cum = 0.0
    for _ in range(n):
        cum += fps
    if (snap["total_steps"] != n or snap["cum_flops"] != cum
            or snap["ring"][-1][3] != cum):
        raise AssertionError(f"{label} telemetry snapshot: {snap}, want "
                             f"{n} steps of {fps} FLOPs")
    print(f"[auto] {label} telemetry snapshot: {n} steps, cum_flops "
          f"{cum:.6e} = {n} x the measured {fps:.6e} a step", flush=True)


# Phase 7's quickstart twin: its 50 LiGO steps (K1 and K2 every step), with
# the small model's pretraining and each finetune cut from 300 and 100 steps
# for time (the widths stay the script's own)
QS_ARGS = ["--small-steps", "100", "--finetune-steps", "20"]


def _quickstart_phase():
    """Phase 7: the quickstart twin at the script's own widths and LiGO
    steps (``QS_ARGS``); returns its kernel launches."""
    from repro_torch.examples import quickstart
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = quickstart.main(QS_ARGS)
    launches = ops.launch_counts()
    init, fine = out["initial"], out["finetuned"]
    print(f"[quickstart] initial losses {init} | finetuned {fine} | "
          f"launches {launches} | {time.perf_counter() - t0:.1f} s",
          flush=True)
    if not init["ligo"] < init["scratch"]:
        raise AssertionError(f"quickstart: ligo's initial loss "
                             f"{init['ligo']:.4f} is not below scratch's "
                             f"{init['scratch']:.4f}")
    if not all(math.isfinite(x) for x in [*init.values(), *fine.values()]):
        raise AssertionError("quickstart: non-finite losses")
    if not launches["ligo_blend_expand_bwd_fused"] > 0:
        raise AssertionError(f"quickstart: its LiGO phase launched no K2: "
                             f"{launches}")
    return launches


# ---------------------------------------------------------------------------
# Phase 13: the MoE family at full width, under phase 6's deterministic
# algorithms (after phase 12, before phase 11's profiler slows the host).
# (a) serve --live-grow-at 8 --hop-operator upcycle: phi4-mini-3.8b hops
# to its MoE twin (moe_target: E 4, top 2, moe_d_ff 8192) while 16
# requests decode through 8 slots, paged; (b) the upcycled model's
# function against the dense model's; (c) MoE -> MoE LiGO growth at
# mixtral's full width, cut in depth; (d) qwen3-moe-30b-a3b at full width.
UPCYCLE_REQ, UPCYCLE_GEN = 16, 16
UPCYCLE_ARGS = ["--arch", "phi4-mini-3.8b", "--hop-operator", "upcycle",
                "--live-grow-at", "8", "--batch", "8", "--requests",
                str(UPCYCLE_REQ), "--prompt-len", "128", "--gen",
                str(UPCYCLE_GEN)]
# (b): first-token logits of 4 x 128 prompts, the upcycled model at a
# capacity that drops no token (E / k = 2.0: a zero router sends every
# token to experts 0..k-1) against the dense model: LIVE_TOL, phase 9's
# bf16 tolerance for a lossless (LEMON) hop
UPCYCLE_PROMPTS = (4, 128)
# (c): source half_config(mixtral-8x7b) cut to 2 layers, target mixtral cut
# to 4 layers (46.7 B parameters, 93 GB of bf16, do not fit one card); a
# LiGO phase of 2 steps on 4 x 128 batches; then a prefill of one
# 4608-token prompt, past the 4096 window (the ring cache), and 8 decode
# steps
MIX_SRC_LAYERS, MIX_LAYERS = 2, 4
MIX_BATCH, MIX_SEQ, MIX_LIGO_STEPS = 4, 128, 2
MIX_PREFILL_T = 4608
MOE_DECODE = 8
# (d): qwen3-moe at its 48 layers when QWEN_FREE_GB stays free after init,
# else the deepest cut that leaves as much; a prefill of 4 x 2048
QWEN_BATCH, QWEN_T, QWEN_FREE_GB = 4, 2048, 10.0


def _moe_drop_shares(torch, fn):
    """Run ``fn`` with every MoE layer recording the share of its routed
    rows that the capacity dropped; returns (fn's result, the shares)."""
    from repro_torch.models import blocks
    orig, shares = blocks.apply_moe, []

    def recording(p, x, cfg):
        out, aux, keep = orig(p, x, cfg, return_keep=True)
        shares.append(float((~keep).float().mean()))
        return out, aux
    blocks.apply_moe = recording
    try:
        return fn(), shares
    finally:
        blocks.apply_moe = orig


def _moe_routes(mode, recorded):
    """A stand-in for ``models.moe.route`` that records each call's expert
    choice (``mode`` "record") or replays the recorded ones in call order
    (``mode`` "replay"; it counts in ``recorded["flips"]`` the routed rows
    whose own choice differs) while the gate weights come from the
    call's own probabilities."""
    import torch
    from repro_torch.models import moe
    orig = moe.route

    def route(p, xf, cfg):
        probs, top_w, top_e = orig(p, xf, cfg)
        if mode == "record":
            recorded["top_e"].append(top_e)
            return probs, top_w, top_e
        want = recorded["top_e"][recorded["i"]]
        recorded["i"] += 1
        recorded["flips"] += int((torch.sort(top_e, -1)[0]
                                  != torch.sort(want, -1)[0]).any(-1).sum())
        top_w = torch.gather(probs, -1, want)
        return probs, top_w / torch.sum(top_w, -1, keepdim=True), want
    return orig, route


def _moe_prefill_check(torch, params, cfg, tokens, max_len):
    """A prefill of ``tokens`` through K3 (bf16, the model's own entry
    point) against the plain attention route, both in bf16 and, layer by
    layer with each layer's parameters cast on the fly, in float32: the
    routes held as ``_prefill_check`` holds them (float32 to 1e-4; the
    bf16 K3 route within twice the bf16 plain route's distance from the
    float32 plain route, plus 1e-2). Every run after the first takes the
    first run's expert choices (``_moe_routes``): a token whose router
    margin lies within the routes' rounding would otherwise pick another
    expert on each route, a jump no tolerance on the logits bounds; the
    choices the replayed runs would have made otherwise are counted and
    printed. Returns (bf16 K3 route's decode state, its last-position
    logits, the K3 launches of its prefill, a summary for the log)."""
    from repro_torch.kernels import ops
    from repro_torch.models import blocks, model, moe
    from repro_torch.models.layers import apply_norm
    from repro_torch.tree import tree_map
    rec = {"top_e": [], "i": 0, "flips": 0}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def layers32(use_kernel):
        """The prefill's last-position logits in float32, layer by layer."""
        top = tree_map(lambda t: t.float(),
                       {k: v for k, v in params.items() if k != "layers"})
        x, pos = model.embed(top, cfg, {"tokens": tokens})
        stack = params["layers"][cfg.blocks[0]]
        for i in range(cfg.n_layers):
            p = tree_map(lambda t: t.float(), model._index(stack, i))
            x, _, _ = blocks.apply_moe_block(p, x, cfg, pos, mode="prefill",
                                             use_kernel=use_kernel)
        x = apply_norm(top["final_norm"], x, cfg.norm)
        return model.unembed(top, cfg, x[:, -1])

    def err(a, b):
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max()).item()

    orig, record = _moe_routes("record", rec)
    _, replay = _moe_routes("replay", rec)
    ops.reset_launch_counts()
    with torch.no_grad():
        try:
            moe.route = record
            (k16, state), ms_k = timed(lambda: model.prefill(
                params, cfg, {"tokens": tokens}, max_len=max_len))
            n_k3 = ops.launch_counts()["flash_attention"]
            moe.route = replay
            p16, ms_p = timed(lambda: model.prefill(
                params, cfg, {"tokens": tokens}, use_kernel=False)[0])
            flips16 = rec["flips"]
            rec.update(i=0, flips=0)
            k32, ms_k32 = timed(lambda: layers32(None))
            rec["i"] = 0
            p32, ms_p32 = timed(lambda: layers32(False))
        finally:
            moe.route = orig
    e16, e32 = err(k16, p16), err(k32, p32)
    ek, ep = err(k16, p32), err(p16, p32)
    n_rows = sum(t.shape[0] for t in rec["top_e"])
    line = (f"prefill {tuple(tokens.shape)}: K3 route {ms_k:.1f} ms ({n_k3} "
            f"K3 launches), plain route {ms_p:.1f} ms; last-position logits, "
            f"K3 vs plain, normalised: bf16 {e16:.2e} (not held), float32 "
            f"{e32:.2e} (tol 1e-4; float32 runs {ms_k32:.0f} / {ms_p32:.0f} "
            f"ms); bf16 vs the float32 plain route: K3 {ek:.2e}, plain "
            f"{ep:.2e} (K3 within 2x plain + 1e-2); expert choices replayed "
            f"from the bf16 K3 run, {flips16} of {n_rows} token-layer choices "
            f"the bf16 plain route would have made otherwise, "
            f"{rec['flips']} the float32 plain route")
    ok = (e32 <= 1e-4 and ek <= 2 * ep + 1e-2 and n_k3 == cfg.n_layers
          and all(bool(torch.isfinite(x).all()) for x in (k16, k32)))
    return state, k16, n_k3, line, ok


def _upcycle_live(torch, runs, k3):
    """13 (a) and (b)."""
    import numpy as np
    from repro_torch.configs import get_config, moe_target
    from repro_torch.core.ligo import _flatten
    from repro_torch.core.plan import plan_for
    from repro_torch.data import gen_tokens
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import model
    from repro_torch.tree import tree_leaves
    cfg1 = get_config("phi4-mini-3.8b")
    cfg2 = moe_target(cfg1)
    shapes = _k1_shapes(torch, cfg1, cfg2)
    k1_grow = _launches(shapes, False)[0]
    print(f"[moe] (a) {cfg1.name} ({cfg1.param_count() / 1e9:.2f} B "
          f"parameters) -> {cfg2.name} ({cfg2.param_count() / 1e9:.2f} B; E "
          f"{cfg2.n_experts}, top {cfg2.experts_top_k}, moe_d_ff "
          f"{cfg2.moe_d_ff}, capacity {cfg2.capacity_factor}): predicted K1 "
          f"{k1_grow} a grow over {len(shapes)} kernel-route groups "
          f"({[sh['name'] for sh in shapes]})", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    a = serve.main(UPCYCLE_ARGS)
    runs["moe a"] = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    eng, hop = _live_check(a, UPCYCLE_REQ, UPCYCLE_GEN)
    if not (a["cfg2"] == cfg2 and hop.completed and hop.attempts == 1
            and not hop.rollbacks and hop.cache_path == "grow"
            and eng.kv_layout == "paged" and eng.cfg == cfg2):
        raise AssertionError(f"(a): hop completed {hop.completed}, attempts "
                             f"{hop.attempts}, rollbacks {hop.rollbacks}, "
                             f"cache {hop.cache_path}, layout "
                             f"{eng.kv_layout}, target {a['cfg2'].name}")
    pc = eng.prefill_counts
    n_pre, n_post = pc[(cfg1.name, "admit")], pc[(cfg2.name, "admit")]
    want = {"ligo_blend_expand_grouped": 3 * k1_grow,
            "ligo_blend_expand_bwd_fused": 0,
            "flash_attention": _k3_want(eng, cfg1, cfg2)}
    print(f"[moe] (a) launches {runs['moe a']}, want {want} (K1: warm()'s "
          f"fill and replay and the hop's replay, {k1_grow} each; K3: "
          f"({n_pre} dense + {n_post} MoE "
          f"admissions) x {cfg1.n_layers}, no re-prefill: the cache grew in "
          f"place)", flush=True)
    if runs["moe a"] != want or not (n_pre and n_post):
        raise AssertionError(f"(a) launches {runs['moe a']}, want {want}")
    k3["engine prefill phi4-mini-3.8b"] = cfg1.n_layers * (n_pre + n_post)
    tree_gb = sum(t.numel() * t.element_size()
                  for t in tree_leaves(eng.params)) / 1e9
    print(f"[moe] (a) 0 dropped, 0 rejected, cache {hop.cache_path}; hop: "
          f"{_hop_walls(hop)}; cache growth "
          f"{hop.timings['cache-grow']:.2f} ms, swap "
          f"{hop.timings['swap']:.3f} ms, "
          f"begin to swap {hop.hop_ms:.2f}; steps {hop.begin_at_step} -> "
          f"{hop.swap_at_step}; {a['tok_s']:.1f} tok/s over "
          f"{a['wall_s']:.2f} s; peak device memory {peak:.1f} GB "
          f"(max_memory_allocated), of which the grown tree that the grow's "
          f"graph pool holds from warm() to the swap {tree_gb:.2f} GB",
          flush=True)
    _decode_report("(a) phi4-mini-3.8b -> phi4-mini-3.8b-moe, background "
                   "upcycle hop", eng, hop)
    # the grown tree on the kernel route (the grow thread's, served) against
    # the plain route: bit for bit (every factor is an identity or [I; 0],
    # so each product is a copy); every expert a copy of expert 0; the
    # router zero and float32
    served = _flatten(eng.params)
    with torch.no_grad():
        plain = _flatten(plan_for(cfg1, cfg2, a["small"]).apply(
            a["ligo"], a["small"], use_kernel=False))
    if sorted(served) != sorted(plain) or not all(
            torch.equal(served[k], plain[k]) for k in plain):
        raise AssertionError("(a) the kernel route's upcycled tree differs "
                             "from the plain route's")
    del plain
    experts = {k: v for k, v in served.items()
               if k.startswith("layers/moe/moe/w")}
    router = served["layers/moe/moe/router"]
    if not (len(experts) == 3 and all(
            v.shape[1] == cfg2.n_experts
            and all(torch.equal(v[:, e], v[:, 0])
                    for e in range(1, cfg2.n_experts))
            for v in experts.values())
            and router.dtype == torch.float32 and not bool(router.any())):
        raise AssertionError("(a) the expert copies differ, or the router "
                             "is not a float32 zero")
    print(f"[moe] (a) the served tree: bitwise equal to the plain route's "
          f"({len(served)} leaves); the "
          f"{cfg2.n_experts} copies of each of {sorted(experts)} bitwise "
          f"equal; router float32 zeros", flush=True)

    # (b) function preservation, and the inherited capacity's drops
    B, T = UPCYCLE_PROMPTS
    toks = torch.as_tensor(gen_tokens(0, 13, B, T, cfg1.vocab_size)[:, :T],
                           device="cuda")
    twin = cfg2.scaled(name=f"{cfg2.name}-cf2",
                       capacity_factor=cfg2.n_experts / cfg2.experts_top_k)
    ops.reset_launch_counts()
    with torch.no_grad():
        dense = model.prefill(a["small"], cfg1, {"tokens": toks})[0]
        up, twin_drop = _moe_drop_shares(torch, lambda: model.prefill(
            eng.params, twin, {"tokens": toks})[0])
        inh, inh_drop = _moe_drop_shares(torch, lambda: model.prefill(
            eng.params, cfg2, {"tokens": toks})[0])
    runs["moe b"] = ops.launch_counts()
    k3["phi4-mini prefill"] = runs["moe b"]["flash_attention"]
    dense, up, inh = (x.float().cpu().numpy() for x in (dense, up, inh))
    err, err_inh = _logit_err(up, dense), _logit_err(inh, dense)
    same = int((up.argmax(-1) == dense.argmax(-1)).sum())
    print(f"[moe] (b) first-token logits of {B} x {T} prompts, upcycled at "
          f"capacity {twin.capacity_factor} vs dense: normalised max error "
          f"{err:.2e} (tol {LIVE_TOL:.0e}), argmax equal in {same}/{B}; "
          f"dropped share of routed rows {max(twin_drop):.4f} (every "
          f"layer); at the inherited capacity {cfg2.capacity_factor}: "
          f"dropped share {min(inh_drop):.4f}-{max(inh_drop):.4f} over "
          f"{len(inh_drop)} layers, logits error {err_inh:.2e} vs dense "
          f"(not gated: the JAX package's behaviour too)", flush=True)
    if (err > LIVE_TOL or max(twin_drop) != 0.0 or len(twin_drop)
            != cfg2.n_layers or runs["moe b"]["flash_attention"]
            != 3 * cfg1.n_layers):
        raise AssertionError(f"(b) upcycled logits {err:.3e}, drops "
                             f"{twin_drop}, launches {runs['moe b']}")
    del a, eng, hop, served, experts, router
    torch.cuda.empty_cache()


def _mixtral_growth(torch, runs, k3):
    """13 (c)."""
    from repro_torch.configs import get_config, half_config
    from repro_torch.core.grow import grow
    from repro_torch.data import batch_for_step, gen_tokens
    from repro_torch.kernels import ops
    from repro_torch.models import model
    from repro_torch.training import to_device
    mix = get_config("mixtral-8x7b")
    c2 = mix.scaled(name=f"{mix.name}-{MIX_LAYERS}l", n_layers=MIX_LAYERS)
    c1 = half_config(mix)
    c1 = c1.scaled(name=f"{c1.name}-{MIX_SRC_LAYERS}l",
                   n_layers=MIX_SRC_LAYERS)
    shapes = _k1_shapes(torch, c1, c2)
    k1_grad, k2_grad = _launches(shapes, True)
    k1_grow = _launches(shapes, False)[0]
    want = {"ligo_blend_expand_grouped": k1_grad * MIX_LIGO_STEPS + k1_grow,
            "ligo_blend_expand_bwd_fused": k2_grad * MIX_LIGO_STEPS,
            "flash_attention": 0}
    print(f"[moe] (c) {c1.name} ({c1.param_count() / 1e9:.2f} B) -> "
          f"{c2.name} ({c2.param_count() / 1e9:.2f} B, "
          f"{2 * c2.param_count() / 1e9:.1f} GB bf16; the whole "
          f"{mix.name}: {mix.param_count() / 1e9:.1f} B): groups "
          + ", ".join(f"{sh['name']} (G {sh['G']}, L1 {sh['L1']}, E "
                      f"{sh['E']}, A {sh['A']}, b {sh['b']}, "
                      f"{str(sh['dtype']).replace('torch.', '')})"
                      for sh in shapes)
          + f"; predicted launches {want}", flush=True)
    # K1 and K2 against their plain versions at the expert groups' shapes,
    # first, on a clean allocator (the float32 plain K2 at moe/w1+moe/w3
    # takes ~50 GB)
    moe = [sh for sh in shapes if sh["name"].startswith("moe/")]
    dt = {sh["name"]: sh["dtype"] for sh in moe}
    k1_rows = [_check_k1(torch, f"mixtral {name}", dt[name], *d,
                         seed=400 + i, j=j)
               for i, (name, d, j) in enumerate(_k1_checks(moe))]
    k2_rows = [_check_k2(torch, f"mixtral {name}", dt[name], *d,
                         seed=420 + i, need_dW=need, j=j)
               for i, (name, d, j, need) in enumerate(_k2_checks(moe))]
    if not any(r["Bd"] == c2.n_experts and r["dtype"] == "float32"
               for r in k1_rows) or not any(r["E"] == c2.n_experts
                                            for r in k1_rows + k2_rows):
        raise AssertionError("(c) the checks missed the router's Bd = 8 "
                             "group or the E = 8 expert stacks")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    small = model.init_params(c1, torch.Generator("cuda").manual_seed(0),
                              device="cuda")

    def data():
        step = 0
        while True:
            yield to_device(batch_for_step(c2, step, MIX_BATCH, MIX_SEQ,
                                           seed=13), "cuda")
            step += 1
    step_ms = []
    ops.reset_launch_counts()
    big, info = grow(small, c1, c2, method="ligo",
                     gen=torch.Generator("cuda").manual_seed(1),
                     data_it=data(), ligo_steps=MIX_LIGO_STEPS,
                     ligo_step_ms=step_ms)
    torch.cuda.synchronize()
    runs["moe c"] = ops.launch_counts()
    losses = info["ligo_losses"]
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[moe] (c) LiGO phase losses {losses}, ms a step {step_ms}, "
          f"launches {runs['moe c']}, peak device memory {peak:.1f} GB",
          flush=True)
    router = big["layers"]["moe"]["moe"]["router"]
    if (runs["moe c"] != want or len(losses) != MIX_LIGO_STEPS
            or not all(math.isfinite(x) for x in losses)
            or router.dtype != torch.float32
            or tuple(big["layers"]["moe"]["moe"]["w1"].shape)
            != (c2.n_layers, c2.n_experts, c2.d_model, c2.moe_d_ff)):
        raise AssertionError(f"(c) launches {runs['moe c']}, want {want}; "
                             f"losses {losses}; router {router.dtype}")
    del small, info
    # a prefill past the window through K3 against the plain route, and
    # decode steps through the ring cache
    T = MIX_PREFILL_T
    toks = torch.as_tensor(gen_tokens(0, 14, 1, T, c2.vocab_size)[:, :T],
                           device="cuda")
    st, lk, n_k3, line, ok = _moe_prefill_check(torch, big, c2, toks,
                                                T + MOE_DECODE)
    k3["mixtral prefill window"] = n_k3
    runs["moe c prefill"] = {"ligo_blend_expand_grouped": 0,
                             "ligo_blend_expand_bwd_fused": 0,
                             "flash_attention": n_k3}
    with torch.no_grad():
        nxt = torch.argmax(lk, -1)[:, None]
        dec, fin = [], True
        for _ in range(MOE_DECODE):
            t0 = time.perf_counter()
            lg, st = model.decode_step(big, c2, st, {"tokens": nxt})
            torch.cuda.synchronize()
            dec.append((time.perf_counter() - t0) * 1e3)
            fin = fin and bool(torch.isfinite(lg).all())
            nxt = torch.argmax(lg, -1)[:, None]
    ring = st["caches"]["k"].shape[2]
    print(f"[moe] (c) window {c2.window}, {line}; {MOE_DECODE} decode steps "
          f"through the {ring}-slot ring cache, ms "
          f"{[round(x, 2) for x in dec]}", flush=True)
    if not (ok and fin and ring == c2.window):
        raise AssertionError(f"(c) the prefill through K3 disagrees with the "
                             f"plain route, or decode: finite {fin}, ring "
                             f"{ring}")
    del big, st, lk, lg
    torch.cuda.empty_cache()
    return k1_rows, k2_rows


def _qwen3_moe(torch, runs, k3):
    """13 (d)."""
    from repro_torch.configs import get_config
    from repro_torch.data import gen_tokens
    from repro_torch.kernels import ops
    from repro_torch.models import model
    q = get_config("qwen3-moe-30b-a3b")
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    base = 2 * q.scaled(n_layers=0).param_count()
    per_layer = 2 * (q.param_count() - q.scaled(n_layers=0).param_count()
                     ) / q.n_layers
    # init's float32 temporaries: the largest whole-stack attention draw
    # (wq, 48 x 2048 x 4096) and the embedding's
    margin = 4 * (q.n_layers * q.d_model * q.q_dim
                  + q.vocab_size * q.d_model)
    L = q.n_layers
    while L > 1 and free0 - base - per_layer * L - margin \
            < QWEN_FREE_GB * 1e9:
        L -= 1
    cfg = q if L == q.n_layers else q.scaled(name=f"{q.name}-{L}l",
                                             n_layers=L)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                               device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    free1 = torch.cuda.mem_get_info()[0]
    print(f"[moe] (d) {cfg.name}: {L} of {q.n_layers} layers, "
          f"{cfg.param_count() / 1e9:.2f} B parameters "
          f"({2 * cfg.param_count() / 1e9:.1f} GB bf16; E {cfg.n_experts}, "
          f"top {cfg.experts_top_k}, q width {cfg.q_dim} vs d_model "
          f"{cfg.d_model}); init {init_s:.1f} s; free after init "
          f"{free1 / 1e9:.1f} GB (need {QWEN_FREE_GB:.0f})", flush=True)
    if free1 < QWEN_FREE_GB * 1e9:
        raise AssertionError(f"(d) {free1 / 1e9:.1f} GB free after init")
    toks = torch.as_tensor(gen_tokens(0, 15, QWEN_BATCH, QWEN_T,
                                      cfg.vocab_size)[:, :QWEN_T],
                           device="cuda")
    st, lk, n_k3, line, ok = _moe_prefill_check(torch, params, cfg, toks,
                                                QWEN_T + MOE_DECODE)
    runs["moe d"] = {"ligo_blend_expand_grouped": 0,
                     "ligo_blend_expand_bwd_fused": 0, "flash_attention": n_k3}
    k3["qwen3-moe prefill"] = n_k3
    with torch.no_grad():
        nxt = torch.argmax(lk, -1)[:, None]
        dec, fin = [], True
        for _ in range(MOE_DECODE):
            t0 = time.perf_counter()
            lg, st = model.decode_step(params, cfg, st, {"tokens": nxt})
            torch.cuda.synchronize()
            dec.append((time.perf_counter() - t0) * 1e3)
            fin = fin and bool(torch.isfinite(lg).all())
            nxt = torch.argmax(lg, -1)[:, None]
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[moe] (d) {line}; {MOE_DECODE} decode steps of {QWEN_BATCH} "
          f"rows, ms {[round(x, 2) for x in dec]}; peak device memory "
          f"{peak:.1f} GB", flush=True)
    if not (ok and fin):
        raise AssertionError(f"(d) the prefill through K3 disagrees with the "
                             f"plain route, or decode is not finite ({fin})")
    del params, st, lk, lg
    torch.cuda.empty_cache()


def _moe_phase(torch):
    """Phase 13 (a)-(d). Returns the launches of its runs by run, the K3
    launches by K3_SHAPES row, and (c)'s K1 and K2 check rows."""
    import gc
    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[moe] phase 13 starts with "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated by "
          f"earlier phases", flush=True)
    runs, k3 = {}, {}
    _upcycle_live(torch, runs, k3)
    k1_rows, k2_rows = _mixtral_growth(torch, runs, k3)
    _qwen3_moe(torch, runs, k3)
    print(f"[moe] phase 13 {time.perf_counter() - t0:.1f} s", flush=True)
    return runs, k3, k1_rows, k2_rows


# ---------------------------------------------------------------------------
# Phase 14: the GQA merge and the sequence-mixer families at full width,
# bf16 (after phase 13, before phase 11's profiler slows the host).
# (a) llama3-8b's MHA twin (n_kv_heads 32) -> llama3-8b (kv 8), both cut to
# GQA_LAYERS layers, by grow(method="gqa_merge"); (b) xlstm-125m; (c)
# zamba2-2.7b at all 54 layers, hot-grown to 108 x 3840, and a LiGO step
# from a one-group cut.
GQA_LAYERS = 4
GQA_PROMPTS = (4, 2048)
# (b): the lock-step serve of xlstm-125m hot-grown 2x (24 layers, d 1152);
# the decode logits against a full forward run in float32 on a float32
# copy (tol 1e-4, the CPU tests' bound); a LiGO step xlstm-125m ->
# xlstm-125m-grown on SEQ_LIGO batches, its FLOP ratio measured at
# XLSTM_FLOP_SEQ tokens (the counting pass steps the sLSTM in Python)
XLSTM_ARGS = ["--arch", "xlstm-125m", "--grow-to", "2x", "--batch", "4",
              "--prompt-len", "2048", "--gen", "32"]
SEQ_LIGO = (4, 256)
XLSTM_FLOP_SEQ = 64
SEQMIX_TOL32 = 1e-4
# (c): the lock-step serve at all 54 layers (4 x 2048, 8 new tokens; the
# prefill held to the plain attention route), the hot-grow of the same
# seeded model to grow_target (108 x 3840) served on 2 x 1024 prompts, and
# a LiGO step from ZAMBA_CUT layers (one shared-attention group) to
# grow_target of the cut (12 x 3840)
ZAMBA_ARGS = ["--arch", "zamba2-2.7b", "--batch", "4", "--prompt-len",
              "2048", "--gen", "8"]
ZAMBA_GROW_ARGS = ["--arch", "zamba2-2.7b", "--grow-to", "2x", "--batch",
                   "2", "--prompt-len", "1024", "--gen", "4"]
ZAMBA_CUT = 6


def _group_line(shapes):
    return ", ".join(
        f"{sh['name']} (G {sh['G']}, L1 {sh['L1']}, I {sh['I']}, A "
        f"{sh['A']}, b {sh['b']}" + (f" -> j {sh['j']} {sh['right']}/"
                                     f"{sh['right_grad']}" if sh["j"] else "")
        + ")" for sh in shapes)


def _seqmix_kernel_checks(torch, label, shapes, seed):
    """K1 and K2 against their plain versions at every group shape of a
    LiGO step of the pair (bf16), each run twice for bits by the checks."""
    k1 = [_check_k1(torch, f"{label} {name}", torch.bfloat16, *d,
                    seed=seed + i, j=j)
          for i, (name, d, j) in enumerate(_k1_checks(shapes))]
    k2 = [_check_k2(torch, f"{label} {name}", torch.bfloat16, *d,
                    seed=seed + 50 + i, need_dW=need, j=j)
          for i, (name, d, j, need) in enumerate(_k2_checks(shapes))]
    return k1, k2


SEQMIX_FLOP_NOTE = ("the 6ND model counts neither the sequence mixers' "
                    "scans nor the block-diagonal seg products")


def _seqmix_ligo(torch, label, c1, c2, batch, seq, flop_seq, runs, key,
                 make=None, tag="seqmix", note=SEQMIX_FLOP_NOTE):
    """grow(method="ligo", ligo_steps=1) from a seeded source on the card:
    K1 and K2 launches as the plan predicts, a finite loss, the grown tree's
    layout; the step's measured / modelled FLOPs printed (not gated).
    ``make(step, seq)`` gives the target's batch of a step on the card (the
    synthetic corpus by default). Returns the group shapes."""
    from repro_torch.core import init_ligo_params
    from repro_torch.core.grow import grow, ligo_loss
    from repro_torch.data import batch_for_step
    from repro_torch.kernels import ops
    from repro_torch.models import model
    from repro_torch.obs import costs
    from repro_torch.roofline import train_flops_per_step
    from repro_torch.training import to_device, value_and_grad
    shapes = _k1_shapes(torch, c1, c2)
    k1_grad, k2_grad = _launches(shapes, True)
    want = {"ligo_blend_expand_grouped": (k1_grad
                                          + _launches(shapes, False)[0]),
            "ligo_blend_expand_bwd_fused": k2_grad, "flash_attention": 0}
    print(f"[{tag}] {label} LiGO step {c1.name} ({c1.param_count() / 1e9:.3f}"
          f" B) -> {c2.name} ({c2.param_count() / 1e9:.3f} B), batch "
          f"{batch} x {seq}: groups {_group_line(shapes)}; predicted "
          f"launches {want}", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    small = model.init_params(c1, torch.Generator("cuda").manual_seed(0),
                              device="cuda")

    if make is None:
        def make(step, s):
            return to_device(batch_for_step(c2, step, batch, s, seed=14),
                             "cuda")

    def data():
        step = 0
        while True:
            yield make(step, seq)
            step += 1
    step_ms = []
    ops.reset_launch_counts()
    big, info = grow(small, c1, c2, method="ligo",
                     gen=torch.Generator("cuda").manual_seed(1),
                     data_it=data(), ligo_steps=1, ligo_step_ms=step_ms)
    torch.cuda.synchronize()
    runs[key] = ops.launch_counts()
    losses = info["ligo_losses"]
    ref = model.init_params(c2, torch.Generator().manual_seed(0),
                            device="meta")
    from repro_torch.tree import sorted_leaves
    layout = ([tuple(x.shape) for x in sorted_leaves(big)]
              == [tuple(x.shape) for x in sorted_leaves(ref)])
    print(f"[{tag}] {label} LiGO loss {losses}, step wall {step_ms} ms, "
          f"launches {runs[key]}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB", flush=True)
    if (runs[key] != want or len(losses) != 1
            or not math.isfinite(losses[0]) or not layout):
        raise AssertionError(f"{label}: launches {runs[key]}, want {want}; "
                             f"losses {losses}; grown layout {layout}")
    op = info["operator_init"]
    del big, info
    b = make(0, flop_seq)

    def step(o, bb, sp):
        return value_and_grad(
            lambda oo, b3: (ligo_loss(oo, sp, c1, c2, b3), {}), o, bb)
    m = costs.measure_step(f"ligo_step[{c2.name}]", step, op, b, small,
                           modelled_flops=train_flops_per_step(
                               c2, batch, flop_seq))
    print(f"[flops] {label} LiGO step at {batch} x {flop_seq} (kernel route): "
          f"measured {m['flops']:.4e} (aten {m['flops_aten']:.4e}, K1+K2 "
          f"{m['flops_kernels']:.4e}) / modelled {m['modelled_flops']:.4e} = "
          f"{m['ratio']:.3f} (printed, not gated; {note})", flush=True)
    del small, op
    torch.cuda.empty_cache()
    return shapes


def _gqa_merge(torch, runs, k3):
    """14 (a)."""
    from repro_torch.configs import get_config
    from repro_torch.core import grow, plan_for
    from repro_torch.data import gen_tokens
    from repro_torch.kernels import ops
    from repro_torch.models import model
    from repro_torch.models.model import prefill
    from repro_torch.optim import AdamWState, grow_adamw_state
    from repro_torch.tree import tree_map
    llama = get_config("llama3-8b")
    c2 = llama.scaled(name=f"{llama.name}-{GQA_LAYERS}l",
                      n_layers=GQA_LAYERS)
    c1 = c2.scaled(name=f"{llama.name}-mha-{GQA_LAYERS}l",
                   n_kv_heads=llama.n_heads)
    shapes = _k1_shapes(torch, c1, c2)
    want = {"ligo_blend_expand_grouped": _launches(shapes, False)[0],
            "ligo_blend_expand_bwd_fused": 0, "flash_attention": 0}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    small = model.init_params(c1, torch.Generator("cuda").manual_seed(0),
                              device="cuda")
    ops.reset_launch_counts()
    with torch.no_grad():
        big, info = grow(small, c1, c2, method="gqa_merge")
    torch.cuda.synchronize()
    runs["seqmix a"] = ops.launch_counts()
    print(f"[seqmix] (a) {c1.name} (kv {c1.n_kv_heads}, "
          f"{c1.param_count() / 1e9:.2f} B) -> {c2.name} (kv "
          f"{c2.n_kv_heads}) by grow(method='gqa_merge'): groups "
          f"{_group_line(shapes)}; launches {runs['seqmix a']}, predicted "
          f"{want}", flush=True)
    if runs["seqmix a"] != want:
        raise AssertionError(f"(a) launches {runs['seqmix a']}, want {want}")
    plan = plan_for(c1, c2, small)
    op = info["operator"]
    with torch.no_grad():
        plain = plan.apply(op, small, use_kernel=False)
        worst = _check_trees(torch, big, plain, 1e-2)
        del plain
        # the AdamW moments, float32, on K1's FMA route against the plain
        # route, one moment at a time
        gen = torch.Generator("cuda").manual_seed(2)
        st = AdamWState(
            m=tree_map(lambda p: torch.randn(p.shape, generator=gen,
                                             device="cuda"), small),
            v=tree_map(lambda p: torch.rand(p.shape, generator=gen,
                                            device="cuda"), small), count=3)
        grown = grow_adamw_state(st, op, c1, c2)
        worst_m = _check_trees(torch, grown.m,
                               plan.apply(op, st.m, use_kernel=False), 1e-5)
        worst_v = _check_trees(torch, grown.v,
                               plan.apply(op, st.v, use_kernel=False,
                                          square=True), 1e-5)
        del st, grown
    print(f"[seqmix] (a) merged tree, K1 route vs plain route: worst "
          f"normalised {worst:.2e} (tol 1e-02, bf16); AdamW m {worst_m:.2e}, "
          f"v {worst_v:.2e} (tol 1e-05, float32 K1 route)", flush=True)
    del small
    torch.cuda.empty_cache()
    B, T = GQA_PROMPTS
    toks = torch.as_tensor(gen_tokens(0, 16, B, T, c2.vocab_size)[:, :T],
                           device="cuda")
    ops.reset_launch_counts()
    with torch.no_grad():
        logits, _ = prefill(big, c2, {"tokens": toks})
    torch.cuda.synchronize()
    runs["seqmix a prefill"] = ops.launch_counts()
    k3["llama3-8b prefill"] = runs["seqmix a prefill"]["flash_attention"]
    if runs["seqmix a prefill"]["flash_attention"] != c2.n_layers:
        raise AssertionError(f"(a) prefill launches "
                             f"{runs['seqmix a prefill']}")
    _prefill_check(torch, {"cfg": c2, "params": big, "prompts": toks,
                           "prefill_logits": logits}, None, 1e-4, 1e-2)
    del big, logits
    torch.cuda.empty_cache()


def _decode_consistency(torch, res, label):
    """prefill + decode_step logits against one full forward of the same
    tokens, on a float32 copy of the served parameters (``res`` is a
    lock-step serve's result)."""
    from repro_torch.models import model
    from repro_torch.tree import tree_map
    cfg = res["cfg"]
    params = tree_map(lambda t: t.float(), res["params"])
    cfg32 = cfg.scaled(dtype="float32")
    toks = torch.cat([res["prompts"], res["tokens"][:, :-1]], dim=1)
    T = res["prompts"].shape[1]
    with torch.no_grad():
        t0 = time.perf_counter()
        lg, st = model.prefill(params, cfg32, {"tokens": res["prompts"]},
                               max_len=toks.shape[1])
        steps = [lg]
        for i in range(T, toks.shape[1]):
            lg, st = model.decode_step(params, cfg32, st,
                                       {"tokens": toks[:, i:i + 1]})
            steps.append(lg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        hidden, _ = model.forward(params, cfg32, {"tokens": toks})
        full = model.unembed(params, cfg32, hidden[:, T - 1:])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    got = torch.stack(steps, dim=1)
    err = ((got - full).abs().max() / full.abs().max()).item()
    print(f"[seqmix] {label} float32 prefill + {len(steps) - 1} decode steps "
          f"vs one forward of {toks.shape[1]} tokens: normalised max error "
          f"{err:.2e} (tol {SEQMIX_TOL32:.0e}); {(t1 - t0) * 1e3:.0f} ms, "
          f"{(t2 - t1) * 1e3:.0f} ms", flush=True)
    if not (err <= SEQMIX_TOL32 and bool(torch.isfinite(got).all())):
        raise AssertionError(f"{label}: decode logits disagree with the full "
                             f"forward ({err:.3e})")
    del params


def _serve_grow_check(torch, res, label, runs, key, k3_layers):
    """A lock-step hot-grow serve: K1 once per plan group (twice for a
    right expansion between its steps), K3 once per attention layer of the
    prefill, the grown tree against the plain route, sane logits."""
    from repro_torch.core import plan_for
    shapes = _k1_shapes(torch, res["small_cfg"], res["cfg"])
    want = {"ligo_blend_expand_grouped": _launches(shapes, False)[0],
            "ligo_blend_expand_bwd_fused": 0, "flash_attention": k3_layers}
    runs[key] = res["launches"]
    print(f"[seqmix] {label} hot-grow {res['small_cfg'].name} -> "
          f"{res['cfg'].name} ({res['cfg'].param_count() / 1e9:.2f} B) in "
          f"{res['hot_grow_ms']:.1f} ms: groups {_group_line(shapes)}; "
          f"launches {runs[key]}, want {want}; prefill "
          f"{res['prefill_ms']:.1f} ms, decode {res['decode_tok_s']:.1f} "
          f"tok/s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB", flush=True)
    if runs[key] != want:
        raise AssertionError(f"{label}: launches {runs[key]}, want {want}")
    _check_serve(torch, res, *res["tokens"].shape)
    with torch.no_grad():
        plan = plan_for(res["small_cfg"], res["cfg"], res["small"])
        plain = plan.apply(res["ligo"], res["small"], use_kernel=False)
        worst = _check_trees(torch, res["params"], plain, 1e-2)
        del plain
    print(f"[seqmix] {label} kernel grow vs plain grow: worst per-leaf "
          f"normalised error {worst:.2e} (tol 1e-02, bf16)", flush=True)
    return shapes


def _xlstm(torch, runs):
    """14 (b)."""
    from repro_torch.configs import get_config, grow_target
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = serve.main(XLSTM_ARGS)
    _serve_grow_check(torch, res, "(b)", runs, "seqmix b serve", 0)
    _decode_consistency(torch, res, "(b)")
    del res
    c1 = get_config("xlstm-125m")
    shapes = _seqmix_ligo(torch, "(b)", c1, grow_target(c1), *SEQ_LIGO,
                          XLSTM_FLOP_SEQ, runs, "seqmix b ligo")
    k1, k2 = _seqmix_kernel_checks(torch, "xlstm", shapes, 500)
    if not any(r["Bd"] == 2 * c1.n_heads for r in k1):
        raise AssertionError("(b) the checks missed the gates' Bd-8 group")
    return k1, k2


def _zamba(torch, runs, k3):
    """14 (c)."""
    from repro_torch.configs import get_config, grow_target
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.model import prefill
    z = get_config("zamba2-2.7b")
    G = z.n_layers // z.shared_attn_every
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = serve.main(ZAMBA_ARGS)
    runs["seqmix c serve"] = res["launches"]
    k3["zamba2 prefill"] = res["launches"]["flash_attention"]
    want = {"ligo_blend_expand_grouped": 0, "ligo_blend_expand_bwd_fused": 0,
            "flash_attention": G}
    print(f"[seqmix] (c) {z.name}: {z.n_layers} layers, "
          f"{z.param_count() / 1e9:.2f} B parameters, d_head {z.d_head}, "
          f"{G} shared-attention insertions: prefill {res['prefill_ms']:.1f} "
          f"ms, decode {res['decode_tok_s']:.1f} tok/s, launches "
          f"{res['launches']}, want {want}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB", flush=True)
    if res["launches"] != want:
        raise AssertionError(f"(c) launches {res['launches']}, want {want}")
    _check_serve(torch, res, *res["tokens"].shape)
    _prefill_check(torch, res, None, 1e-4, 1e-2)
    # the main path's K3 at d_head 80: every insertion on the tensor cores
    with torch.no_grad():
        _check_k3_launches(torch, f"{z.name} prefill", lambda: prefill(
            res["params"], res["cfg"], {"tokens": res["prompts"]}), G)
    del res
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = serve.main(ZAMBA_GROW_ARGS)
    k3["zamba2-grown prefill"] = res["launches"]["flash_attention"]
    _serve_grow_check(torch, res, "(c)", runs, "seqmix c grow",
                      2 * G)
    del res
    torch.cuda.empty_cache()
    c1 = z.scaled(name=f"{z.name}-{ZAMBA_CUT}l", n_layers=ZAMBA_CUT)
    shapes = _seqmix_ligo(torch, "(c)", c1, grow_target(c1), *SEQ_LIGO,
                          SEQ_LIGO[1], runs, "seqmix c ligo")
    return _seqmix_kernel_checks(torch, "zamba2", shapes, 600)


def _seqmix_phase(torch):
    """Phase 14 (a)-(c). Returns the launches of its runs by run, the K3
    launches by K3_SHAPES row, and the K1 and K2 check rows."""
    import gc
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[seqmix] phase 14 starts with "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated by "
          f"earlier phases", flush=True)
    runs, k3 = {}, {}
    t = time.perf_counter()
    _gqa_merge(torch, runs, k3)
    print(f"[seqmix] (a) {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    k1, k2 = _xlstm(torch, runs)
    print(f"[seqmix] (b) {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    zk1, zk2 = _zamba(torch, runs, k3)
    print(f"[seqmix] (c) {time.perf_counter() - t:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[seqmix] phase 14 {time.perf_counter() - t0:.1f} s", flush=True)
    return runs, k3, k1 + zk1, k2 + zk2


# ---------------------------------------------------------------------------
# Phase 15: the live engine on the recurrent families at full width, bf16,
# under phase 6's deterministic algorithms (after phase 14, before phase
# 11). (a) xlstm-125m through `serve --live-grow-at` with a background LiGO
# hop (re-prefill); (b) zamba2-2.7b at its 54 layers the same way, K3 at
# every exact prompt and history length it sent held against its plain
# version; (c) float32 runs of (a), with prompts of 1, 2 and 5 tokens added
# through the engine API, and of (b) ((b) cut to RECUR_F32_ZAMBA layers: the
# float32 grown model at 108 layers, 39 GB, and its double-buffered grow
# do not fit beside the source) held to a lock-step prefill + decode_step
# of the same models at each request's true length; (d) chaos at
# cache-grow on (a)'s model, hop synchronous: the failing poll leaves the
# engine's state bitwise as it was.
RECUR_XLSTM_ARGS = ["--arch", "xlstm-125m", "--grow-to", "2x",
                    "--live-grow-at", "8", "--batch", "8", "--requests",
                    "16", "--prompt-len", "64", "--gen", "16"]
RECUR_SHORT = (1, 2, 5)          # (c)'s extra prompts, below the conv tail
RECUR_ZAMBA_ARGS = ["--arch", "zamba2-2.7b", "--grow-to", "2x",
                    "--live-grow-at", "3", "--batch", "4", "--requests", "8",
                    "--prompt-len", "512", "--gen", "8"]
RECUR_F32_ZAMBA = 12
RECUR_TOL32 = 1e-4               # engine vs lock-step logits, float32


def _short_prompts(vocab):
    from repro_torch.data import gen_tokens
    rows = gen_tokens(0, 15, len(RECUR_SHORT), max(RECUR_SHORT), vocab)
    return [[int(t) for t in rows[i, :n]] for i, n in enumerate(RECUR_SHORT)]


def _attn_layers(cfg):
    """K3 launches of one prefill: the hybrid's shared-block insertions."""
    return cfg.n_layers // cfg.shared_attn_every if cfg.family == "hybrid" \
        else 0


def _recur_k3_want(eng, cfgs):
    return sum(n * _attn_layers(cfgs[name])
               for (name, _, _), n in eng.prefill_lengths.items())


def _recur_live_serve(torch, argv, label, runs):
    """(a) or (b): one `serve --live-grow-at` run; checks done / dropped /
    rejected, the hop (attempt 1, re-prefill), K1 once per plan group at
    warm() and at the hop, K3 once per attention layer of every prefill
    the engine counted; prints decode p50/p99 before, during and after the
    hop, the hop's stage walls and the per-slot state."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = serve.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    runs[f"recurrent {label}"] = ops.launch_counts()
    eng, hop = res["engine"], res["hop"]
    cfg1, cfg2 = res["small_cfg"], res["cfg2"]
    shapes = _k1_shapes(torch, cfg1, cfg2)
    k1 = _launches(shapes, False)[0]
    want = {"ligo_blend_expand_grouped": 3 * k1,
            "ligo_blend_expand_bwd_fused": 0,
            "flash_attention": _recur_k3_want(eng, {cfg1.name: cfg1,
                                                    cfg2.name: cfg2})}
    gen = int(argv[argv.index("--gen") + 1])
    n_req = int(argv[argv.index("--requests") + 1])
    _live_check(res, n_req, gen)
    pc = eng.prefill_counts
    print(f"[recur] {label} {cfg1.name} ({cfg1.param_count() / 1e9:.3f} B) -> "
          f"{cfg2.name} ({cfg2.param_count() / 1e9:.3f} B): {n_req} requests "
          f"(prompt lengths {sorted(len(r.prompt) for r in eng.requests)}) "
          f"through {eng.slots} slots, hop attempt {hop.attempts} cache "
          f"{hop.cache_path}, prefills {dict(pc)}; launches "
          f"{runs[f'recurrent {label}']} (hop alone: {res['launches']}), want "
          f"{want}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB; {wall:.1f} s",
          flush=True)
    _decode_report(f"{label} {cfg1.name}", eng, hop)
    sb = res["slot_bytes"]
    print(f"[recur] {label} hop: {_hop_walls(hop)}; stages ms "
          f"{hop.timings} (migration = "
          f"cache-grow, {pc[(cfg2.name, 'reprefill')]} re-prefills); state a "
          f"slot: {cfg1.name} recurrent {sb['before']['recurrent']} B + "
          f"attention {sb['before']['attention']} B -> {cfg2.name} recurrent "
          f"{sb['after']['recurrent']} B + attention "
          f"{sb['after']['attention']} B ({eng.cap} cache rows)", flush=True)
    if not (hop.completed and hop.attempts == 1
            and hop.cache_path == "reprefill"
            and res["launches"]["ligo_blend_expand_grouped"] == k1
            and runs[f"recurrent {label}"] == want):
        raise AssertionError(f"{label}: hop {hop.completed} attempt "
                             f"{hop.attempts} cache {hop.cache_path}; "
                             f"launches {runs[f'recurrent {label}']}, want "
                             f"{want}")
    return res


def _recur_k3_rows(torch, eng, cfgs, label, seed):
    """K3 against its plain version at every (config, prefill length) the
    engine sent it: B = 1, the exact prompt and history lengths, off the
    kernel's tiles. Returns the rows and their launches by row name."""
    rows, counts = [], {}
    for i, ((name, kind, T), n) in enumerate(sorted(
            eng.prefill_lengths.items())):
        cfg = cfgs[name]
        key = f"{label} {name} T={T}"
        if key not in counts:
            rows.append(_check_k3(
                torch, key, cfg.dtype,
                1, cfg.n_heads, cfg.n_kv_heads, T, T, cfg.d_head, True, 0,
                seed=seed + i))
            counts[key] = 0
        counts[key] += n * _attn_layers(cfg)
    return rows, counts


class _Recorder:
    """A live run through the engine API: the engine records the logits of
    every pick by (request uid, token index), and the run loop notes each
    request's token count at the swap (None: done before it; 0: admitted
    after it)."""

    def __init__(self, torch, params, cfg, cfg2, ligo, prompts, *, slots,
                 budget, gen, hop_at, fail_at=None, bitwise=False):
        from repro_torch.serving import HopController, ServingEngine
        from repro_torch.tree import tree_leaves

        class Engine(ServingEngine):
            def _pick_token(self, req, logits_row):
                self.picked[(req.uid, len(req.tokens))] = logits_row
                return super()._pick_token(req, logits_row)

        eng = Engine(params, cfg, slots=slots, prompt_budget=budget,
                     gen_budget=gen, kv_layout="dense", device="cuda")
        eng.picked = {}
        for p in prompts:
            eng.submit(p, max_new=gen)
        hop = HopController(eng, cfg2, ligo, fail_at=fail_at, backoff=0.01,
                            background=False)
        self.eng, self.hop, self.at_swap, self.rolled = eng, hop, {}, []

        def poll(e):
            before = ([t.clone() for t in tree_leaves(e.state["caches"])]
                      if bitwise else None)
            cfg0, params0, n = e.cfg, e.params, len(hop.rollbacks)
            hop.poll()
            if len(hop.rollbacks) > n and bitwise:
                after = tree_leaves(e.state["caches"])
                same = (e.cfg is cfg0 and e.params is params0
                        and len(after) == len(before)
                        and all(torch.equal(a, b)
                                for a, b in zip(after, before)))
                self.rolled.append((hop.rollbacks[-1][0], same))
            if hop.completed and not self.at_swap:
                for r in e.requests:
                    self.at_swap[r.uid] = (
                        len(r.tokens) if r.status == "running"
                        else 0 if r.status == "queued" else None)

        def on_step(e):
            if e.decode_steps >= hop_at and hop.attempts == 0:
                hop.begin()
            if hop.attempts and not hop.completed:
                poll(e)

        t0 = time.perf_counter()
        eng.run(on_step=on_step)
        while not (hop.completed or hop.failed):
            time.sleep(0.002)
            poll(eng)
        torch.cuda.synchronize()
        self.wall = time.perf_counter() - t0


def _lockstep_hold(torch, rec, small, big, label):
    """Each request of a recorded run against the lock-step path of the
    same models at its true length (``model.prefill`` of the prompt, or
    of the history after the swap, then ``decode_step`` a token, batch 1):
    its first-token logits and its logits on its first step after the
    swap within RECUR_TOL32 (normalised max error), its greedy tokens
    equal. ``small``/``big``: (params, cfg) before and after the hop."""
    import numpy as np
    from repro_torch.models import model
    eng = rec.eng
    worst = {"first": 0.0, "after hop": 0.0}
    n_after = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        for r in eng.requests:
            k = rec.at_swap.get(r.uid)

            def side(i):
                return big if k is not None and i >= k else small
            params, cfg = side(0)
            lg, st = model.prefill(params, cfg, {"tokens": torch.tensor(
                [r.prompt], device="cuda")}, max_len=eng.max_len)
            toks, logits = [], {0: lg[0].float().cpu().numpy()}
            toks.append(int(np.argmax(logits[0])))
            for i in range(1, len(r.tokens)):
                if side(i) is not side(i - 1):
                    params, cfg = side(i)
                    hist = r.prompt + toks[:-1]
                    _, st = model.prefill(params, cfg, {"tokens": torch.tensor(
                        [hist], device="cuda")}, max_len=eng.max_len)
                lg, st = model.decode_step(params, cfg, st, {
                    "tokens": torch.tensor([[toks[-1]]], device="cuda")})
                logits[i] = lg[0].float().cpu().numpy()
                toks.append(int(np.argmax(logits[i])))
            if toks != r.tokens:
                raise AssertionError(f"{label}: request of {len(r.prompt)} "
                                     f"tokens (swap at {k}): engine tokens "
                                     f"{r.tokens}, lock-step {toks}")
            worst["first"] = max(worst["first"], _logit_err(
                eng.picked[(r.uid, 0)], logits[0]))
            if k:
                n_after += 1
                worst["after hop"] = max(worst["after hop"], _logit_err(
                    eng.picked[(r.uid, k)], logits[k]))
    print(f"[recur] {label} float32: {len(eng.requests)} requests' greedy "
          f"tokens equal to the lock-step path's; logits vs lock-step, "
          f"normalised max error: first token {worst['first']:.2e}, first "
          f"step after the hop {worst['after hop']:.2e} over {n_after} "
          f"sessions live at the swap (tol {RECUR_TOL32:.0e}); engine run "
          f"{rec.wall:.1f} s, lock-step {time.perf_counter() - t0:.1f} s",
          flush=True)
    if not (max(worst.values()) <= RECUR_TOL32 and n_after > 0
            and any(k == 0 for k in rec.at_swap.values())):
        raise AssertionError(f"{label}: logits {worst} (tol {RECUR_TOL32}); "
                             f"{n_after} sessions live at the swap, at swap "
                             f"{rec.at_swap}")


def _recur_f32(torch, cfg, prompts, slots, budget, gen, hop_at, label, runs):
    """(c): a float32 run of ``cfg`` from the launcher's seeds through the
    engine API, the hop synchronous at ``hop_at``, held to the lock-step
    path. Returns the engine (for its prefill lengths) and the configs."""
    from repro_torch.configs import grow_target
    from repro_torch.core import init_ligo_params
    from repro_torch.kernels import ops
    from repro_torch.models.model import init_params
    cfg2 = grow_target(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0),
                         device="cuda")
    ligo = init_ligo_params(torch.Generator("cuda").manual_seed(1), cfg,
                            cfg2, device="cuda")
    ops.reset_launch_counts()
    rec = _Recorder(torch, params, cfg, cfg2, ligo, prompts, slots=slots,
                    budget=budget, gen=gen, hop_at=hop_at)
    runs[f"recurrent {label}"] = ops.launch_counts()
    eng = rec.eng
    want = {"ligo_blend_expand_grouped":
            _launches(_k1_shapes(torch, cfg, cfg2), False)[0],
            "ligo_blend_expand_bwd_fused": 0,
            "flash_attention": _recur_k3_want(eng, {cfg.name: cfg,
                                                    cfg2.name: cfg2})}
    print(f"[recur] {label} {cfg.name} -> {cfg2.name}, float32: prefills "
          f"{dict(eng.prefill_counts)}, launches {runs[f'recurrent {label}']}"
          f", want {want}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB", flush=True)
    if runs[f"recurrent {label}"] != want or not rec.hop.completed:
        raise AssertionError(f"{label}: launches {runs[f'recurrent {label}']}"
                             f", want {want}; hop {rec.hop.completed}")
    _lockstep_hold(torch, rec, (params, cfg), (eng.params, cfg2), label)
    out = (eng, {cfg.name: cfg, cfg2.name: cfg2})
    del rec, params, ligo
    return out


def _recur_chaos(torch, res, prompts, runs):
    """(d): (a)'s bf16 model and operator, a failure injected at
    cache-grow, the hop synchronous: one rollback for the injected cause,
    the state bitwise as it was before the failing poll, the retry landing
    with 0 dropped."""
    from repro_torch.kernels import ops
    cfg, cfg2 = res["small_cfg"], res["cfg2"]
    ops.reset_launch_counts()
    rec = _Recorder(torch, res["small"], cfg, cfg2, res["ligo"], prompts,
                    slots=8, budget=64, gen=16, hop_at=8,
                    fail_at="cache-grow", bitwise=True)
    runs["recurrent d"] = ops.launch_counts()
    hop, c = rec.hop, rec.eng.counts()
    k1 = _launches(_k1_shapes(torch, cfg, cfg2), False)[0]
    print(f"[recur] (d) chaos at 'cache-grow' on {cfg.name}: rollbacks "
          f"{[(w, str(e)) for w, e in hop.rollbacks]}, state bitwise "
          f"unchanged by the failing poll {rec.rolled}, attempts "
          f"{hop.attempts}, {c['done']} done, {c['dropped']} dropped; "
          f"launches {runs['recurrent d']}", flush=True)
    if not (hop.completed and hop.attempts == 2
            and rec.rolled == [("cache-grow", True)]
            and "injected" in str(hop.rollbacks[0][1])
            and c["done"] == len(prompts) and c["dropped"] == 0
            and runs["recurrent d"]["ligo_blend_expand_grouped"] == 2 * k1):
        raise AssertionError(f"(d): {rec.rolled}, {hop.rollbacks}, {c}, "
                             f"{runs['recurrent d']}")


def _recurrent_phase(torch):
    """Phase 15 (a)-(d). Returns the launches of its runs by run, K3's
    launches by row name and the K3 rows at the phase's exact lengths."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import live_prompts
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    runs, k3, rows = {}, {}, []
    t = time.perf_counter()
    xl = get_config("xlstm-125m")
    res = _recur_live_serve(torch, RECUR_XLSTM_ARGS, "(a)", runs)
    _recur_chaos(torch, res, live_prompts(8, 64, xl.vocab_size), runs)
    del res
    print(f"[recur] (a), (d) {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    res = _recur_live_serve(torch, RECUR_ZAMBA_ARGS, "(b)", runs)
    cfgs = {c.name: c for c in (res["small_cfg"], res["cfg2"])}
    r, n = _recur_k3_rows(torch, res["engine"], cfgs, "engine prefill", 700)
    rows += r
    k3.update(n)
    del res
    gc.collect()
    print(f"[recur] (b) {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    xl32 = xl.scaled(dtype="float32")
    eng, _ = _recur_f32(torch, xl32, live_prompts(8, 64, xl.vocab_size)
                        + _short_prompts(xl.vocab_size), 8, 64, 16, 8,
                        "(c) xlstm", runs)
    if sorted(len(r.prompt) for r in eng.requests)[:3] != list(RECUR_SHORT):
        raise AssertionError("(c) xlstm: the short prompts were not served")
    del eng
    z = get_config("zamba2-2.7b")
    z32 = z.scaled(name=f"{z.name}-{RECUR_F32_ZAMBA}l",
                   n_layers=RECUR_F32_ZAMBA, dtype="float32")
    eng, cfgs = _recur_f32(torch, z32, live_prompts(8, 512, z.vocab_size),
                           4, 512, 8, 3, "(c) zamba2", runs)
    r, n = _recur_k3_rows(torch, eng, cfgs, "engine prefill f32", 760)
    rows += r
    k3.update(n)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[recur] (c) {time.perf_counter() - t:.1f} s", flush=True)
    print(f"[recur] phase 15 {time.perf_counter() - t0:.1f} s", flush=True)
    return runs, k3, rows


# ---------------------------------------------------------------------------
# Phase 16: the audio and VLM families at full width, bf16, under phase 6's
# deterministic algorithms (after phase 15, before phase 11). (a)
# hubert-xlarge grown from its half model through a LiGO phase, grow() with
# the AdamW moments and an autograd-free encode, on the kernel route and the
# bf16 and float32 plain routes; (b) qwen2-vl-72b at full width cut to
# VLM_LAYERS layers, hot-grown from its half model cut to half as many,
# prefilled through K3 with patches on Qwen2-VL's grid positions and with
# the launcher's positions, decoded, and a LiGO step of a shallower cut;
# (c) `serve --arch qwen2-vl-72b --smoke --grow-to 2x` on the kernel route
# against the plain route.
# (a): batch, frames a row, source AdamW steps, LiGO steps (target batches
# of hubert-xlarge's width, 15 % of the frames masked)
HUBERT_RUN = (8, 512, 2, 2)
# (b): the target's layers (the source has half as many), prompts of
# VLM_PROMPTS[0] x VLM_PROMPTS[1] tokens whose first VLM_SIDE^2 are patch
# embeddings on a VLM_SIDE x VLM_SIDE grid, VLM_GEN tokens a row (the first
# from the prefill), and the LiGO step's (source layers, target layers,
# batch, tokens a row); the cut is the deepest (even, at most VLM_LAYERS)
# that leaves VLM_FREE_GB free beside the source, both grows and the
# float32 copy of the prefill check
VLM_LAYERS = 8
VLM_PROMPTS = (4, 2048)
VLM_SIDE = 16
VLM_GEN = 32
VLM_LIGO = (2, 4, 4, 512)
VLM_FREE_GB = 10
# (c): float32 smoke models, grown 2 -> 4 layers, 64 -> 96 wide
VLM_SERVE_ARGS = ["--arch", "qwen2-vl-72b", "--smoke", "--grow-to", "2x",
                  "--batch", "4", "--prompt-len", "64", "--gen", "16"]
VLM_TOL32 = 1e-4                  # (c) kernel vs plain route logits


def _audio_vlm_pairs():
    """The pairs whose K1 and K2 group shapes phase 2 checks: (a)'s grow
    and LiGO step, (b)'s hot-grow and (b)'s LiGO step."""
    from repro_torch.configs import get_config, half_config
    h = get_config("hubert-xlarge")
    q = get_config("qwen2-vl-72b")
    hq = half_config(q)
    s1, s2 = VLM_LIGO[:2]
    return {"hubert": (half_config(h), h),
            "qwen2-vl grow": (hq.scaled(name=f"{hq.name}-{VLM_LAYERS // 2}l",
                                        n_layers=VLM_LAYERS // 2),
                              q.scaled(name=f"{q.name}-{VLM_LAYERS}l",
                                       n_layers=VLM_LAYERS)),
            "qwen2-vl ligo": (hq.scaled(name=f"{hq.name}-{s1}l",
                                        n_layers=s1),
                              q.scaled(name=f"{q.name}-{s2}l", n_layers=s2))}


def _audio_vlm_kernel_checks(torch):
    """Phase 2's rows at the audio and VLM pairs' groups, bf16: K1 at every
    group of each grow and LiGO forward, K2 at every group of the LiGO
    steps (hubert's and qwen2-vl's, not the hot-grow's), each held against
    its plain version and run twice for bits by the checks."""
    k1, k2 = [], []
    for i, (label, (c1, c2)) in enumerate(_audio_vlm_pairs().items()):
        shapes = _k1_shapes(torch, c1, c2)
        k1 += [_check_k1(torch, f"{label} {name}", torch.bfloat16, *d,
                         seed=800 + 20 * i + n, j=j)
               for n, (name, d, j) in enumerate(_k1_checks(shapes))]
        if label != "qwen2-vl grow":
            k2 += [_check_k2(torch, f"{label} {name}", torch.bfloat16, *d,
                             seed=900 + 20 * i + n, need_dW=need, j=j)
                   for n, (name, d, j, need) in enumerate(_k2_checks(shapes))]
        torch.cuda.empty_cache()
    return k1, k2


def _vlm_cut(torch):
    """(source, target) of (b): the deepest even cut of qwen2-vl-72b up to
    VLM_LAYERS whose bf16 tree twice (the kernel and the plain grow) beside
    the source, then once in bf16 and once in float32 (the prefill check),
    leaves VLM_FREE_GB free."""
    from repro_torch.configs import get_config, half_config
    q = get_config("qwen2-vl-72b")
    hq = half_config(q)
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]

    def nbytes(cfg, per_param):
        return per_param * cfg.param_count()

    L = VLM_LAYERS
    while True:
        c2 = q.scaled(name=f"{q.name}-{L}l", n_layers=L)
        c1 = hq.scaled(name=f"{hq.name}-{L // 2}l", n_layers=L // 2)
        need = max(nbytes(c1, 2) + nbytes(c2, 4), nbytes(c2, 6))
        if L <= 2 or free0 - need >= VLM_FREE_GB * 1e9:
            break
        L -= 2
    print(f"[vlm] (b) cut: {c1.name} ({c1.param_count() / 1e9:.2f} B) -> "
          f"{c2.name} ({c2.param_count() / 1e9:.2f} B, "
          f"{2 * c2.param_count() / 1e9:.1f} GB bf16); {free0 / 1e9:.1f} GB "
          f"free, {need / 1e9:.1f} GB needed at the peak", flush=True)
    return c1, c2


def _vlm_grid_batch(torch, cfg, B, T, seed):
    """A prefill batch of ``B`` x ``T`` tokens from the synthetic corpus
    whose first VLM_SIDE^2 are patch embeddings (normal, in the model's
    dtype) at Qwen2-VL's grid positions: patch i at (t 0, h i // VLM_SIDE,
    w i % VLM_SIDE), the text after it counting on from VLM_SIDE on all
    three streams (positions that make M-RoPE differ from RoPE)."""
    from repro_torch.data import gen_tokens
    from repro_torch.models.model import DTYPES
    P = VLM_SIDE ** 2
    toks = torch.as_tensor(gen_tokens(0, 16, B, T, cfg.vocab_size)[:, :T],
                           device="cuda")
    gen = torch.Generator("cuda").manual_seed(seed)
    pe = torch.randn((B, P, cfg.d_model), generator=gen,
                     device="cuda").to(DTYPES[cfg.dtype])
    i = torch.arange(P, device="cuda")
    pos = torch.zeros((B, T, 3), dtype=torch.int32, device="cuda")
    pos[:, :P, 1], pos[:, :P, 2] = i // VLM_SIDE, i % VLM_SIDE
    pos[:, P:] = (VLM_SIDE + torch.arange(T - P, device="cuda")
                  ).to(torch.int32)[None, :, None]
    return {"tokens": toks, "patch_embeds": pe, "positions": pos}


def _vlm_prefill(torch, params, cfg, batch, label, runs, key, max_len):
    """One counted prefill of ``batch`` (K3 once a layer), then
    ``_prefill_check``: the K3 route against the plain attention route,
    in bf16 and float32. Returns (logits, state)."""
    from repro_torch.kernels import ops
    from repro_torch.models.model import prefill
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, state = prefill(params, cfg, batch, max_len=max_len)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    runs[key] = ops.launch_counts()
    want = {"ligo_blend_expand_grouped": 0, "ligo_blend_expand_bwd_fused": 0,
            "flash_attention": cfg.n_layers}
    print(f"[vlm] (b) {label} prefill of {tuple(batch['tokens'].shape)} "
          f"tokens: {ms:.1f} ms (first call), launches {runs[key]}, want "
          f"{want}", flush=True)
    if runs[key] != want or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"(b) {label} prefill: launches {runs[key]}, "
                             f"want {want}, or the logits are not finite")
    _prefill_check(torch, {"cfg": cfg, "params": params, "batch": batch,
                           "prefill_logits": logits}, None, 1e-4, 1e-2)
    return logits, state


def _hubert(torch, runs):
    """16 (a)."""
    from repro_torch.configs import get_config, half_config
    c2 = get_config("hubert-xlarge")
    c1 = half_config(c2)
    batch, seq, steps, lsteps = HUBERT_RUN
    print(f"[audio] (a) {c1.name} ({c1.n_layers} x {c1.d_model}, d_head "
          f"{c1.d_head}, {c1.param_count() / 1e9:.3f} B) -> {c2.name} "
          f"({c2.n_layers} x {c2.d_model}, d_head {c2.d_head}, "
          f"{c2.param_count() / 1e9:.3f} B), batch {batch} x {seq} frames",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    runs["audio a"], rep = _pair_routes(torch, c1, c2, batch, steps, lsteps,
                                        0, seq, tag="audio",
                                        profile_eval=True)
    print(f"[audio] (a) encode MLM loss at the masked frames (kernel route) "
          f"{rep['eval']:.4f}; LiGO step FLOPs / 6ND {rep['ratio']:.3f} "
          f"(plain route {rep['plain_ratio']:.3f}); {rep['seconds']:.1f} s; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.1f} "
          f"GB", flush=True)


def _qwen2_vl(torch, runs):
    """16 (b)."""
    from repro_torch.core import init_ligo_params, plan_for
    from repro_torch.data import gen_tokens
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import lockstep_batch
    from repro_torch.models import model
    from repro_torch.models.inputs import dummy_batch
    c1, c2 = _vlm_cut(torch)
    torch.cuda.reset_peak_memory_stats()
    shapes = _k1_shapes(torch, c1, c2)
    with torch.no_grad():
        small = model.init_params(c1, torch.Generator("cuda").manual_seed(0),
                                  device="cuda")
        ligo = init_ligo_params(torch.Generator("cuda").manual_seed(1), c1,
                                c2, device="cuda")
        plan = plan_for(c1, c2, small)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        big = plan.apply(ligo, small)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        runs["vlm b grow"] = ops.launch_counts()
        want = {"ligo_blend_expand_grouped": _launches(shapes, False)[0],
                "ligo_blend_expand_bwd_fused": 0, "flash_attention": 0}
        print(f"[vlm] (b) hot-grow {c1.name} -> {c2.name} in {ms:.1f} ms "
              f"(first call): groups {_group_line(shapes)}; launches "
              f"{runs['vlm b grow']}, want {want}", flush=True)
        if runs["vlm b grow"] != want:
            raise AssertionError(f"(b) grow launches {runs['vlm b grow']}, "
                                 f"want {want}")
        plain = plan.apply(ligo, small, use_kernel=False)
        worst = _check_trees(torch, big, plain, 1e-2)
        del plain, small, ligo, plan
    torch.cuda.empty_cache()
    print(f"[vlm] (b) kernel grow vs plain grow: worst per-leaf normalised "
          f"error {worst:.2e} (tol 1e-02, bf16)", flush=True)
    B, T = VLM_PROMPTS
    grid = _vlm_grid_batch(torch, c2, B, T, seed=16)
    logits, state = _vlm_prefill(torch, big, c2, grid, "grid positions",
                                 runs, "vlm b prefill grid", T + VLM_GEN)
    # greedy decode, each step at the text's next position on all streams
    nxt = torch.argmax(logits, -1)[:, None]
    toks, dec, fin = [nxt], [], True
    start = VLM_SIDE + T - VLM_SIDE ** 2
    with torch.no_grad():
        for i in range(VLM_GEN - 1):
            t0 = time.perf_counter()
            lg, state = model.decode_step(big, c2, state,
                                          lockstep_batch(c2, nxt, start + i))
            torch.cuda.synchronize()
            dec.append((time.perf_counter() - t0) * 1e3)
            fin = fin and bool(torch.isfinite(lg).all())
            nxt = torch.argmax(lg, -1)[:, None]
            toks.append(nxt)
    toks = torch.cat(toks, 1)
    ok = (fin and state["pos"] == T + VLM_GEN - 1
          and bool(((toks >= 0) & (toks < c2.vocab_size)).all()))
    print(f"[vlm] (b) {VLM_GEN - 1} decode steps of {B} rows at positions "
          f"{start}..{start + VLM_GEN - 2}: ms "
          f"{[round(x, 2) for x in dec]}; row 0 {toks[0, :16].tolist()}",
          flush=True)
    if not ok:
        raise AssertionError("(b) decode: logits not finite or tokens out "
                             "of range")
    del state, logits, lg, grid
    # the launcher's form: zero patches, arange positions on all streams
    prompts = torch.as_tensor(gen_tokens(0, 0, B, T, c2.vocab_size)[:, :T],
                              device="cuda")
    lb = lockstep_batch(c2, prompts)
    _vlm_prefill(torch, big, c2, lb, "launcher positions", runs,
                 "vlm b prefill launcher", T)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[vlm] (b) peak device memory {peak:.1f} GB", flush=True)
    del big, lb
    torch.cuda.empty_cache()
    s1, s2, lbatch, lseq = VLM_LIGO
    l1, l2 = _audio_vlm_pairs()["qwen2-vl ligo"]

    def make(step, s):
        return dummy_batch(l2, lbatch, s, "train", seed=40 + step)
    _seqmix_ligo(torch, "(b)", l1, l2, lbatch, lseq, lseq, runs,
                 "vlm b ligo", make=make, tag="vlm",
                 note=f"{min(l2.num_patches, lseq)} of the {lseq} tokens a "
                      f"row are patch embeddings")


def _vlm_serve(torch, runs):
    """16 (c)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    out = {}
    for route, uk in (("kernel", None), ("plain", False)):
        ops.reset_launch_counts()
        res = serve.main(VLM_SERVE_ARGS, use_kernel=uk)
        out[route] = res
        runs[f"vlm c serve {route}"] = ops.launch_counts()
    k, p = out["kernel"], out["plain"]
    cfg, cfg1 = k["cfg"], k["small_cfg"]
    want = {"ligo_blend_expand_grouped": _launches(
                _k1_shapes(torch, cfg1, cfg), False)[0],
            "ligo_blend_expand_bwd_fused": 0,
            "flash_attention": cfg.n_layers}
    zero = dict.fromkeys(want, 0)

    def err(a, b):
        return float((a - b).abs().max() / (b.abs().max() + 1e-30))
    e_pre = err(k["prefill_logits"], p["prefill_logits"])
    e_dec = err(k["decode_logits"], p["decode_logits"])
    same = bool(torch.equal(k["tokens"], p["tokens"]))
    print(f"[vlm] (c) serve {cfg1.name} -> {cfg.name} ({cfg.dtype}): "
          f"launches kernel route {runs['vlm c serve kernel']} (want {want}),"
          f" plain route {runs['vlm c serve plain']}; logits kernel vs plain "
          f"prefill {e_pre:.2e}, decode {e_dec:.2e} (tol {VLM_TOL32:.0e}); "
          f"greedy tokens equal {same}", flush=True)
    _check_serve(torch, k, *k["tokens"].shape)
    if not (runs["vlm c serve kernel"] == want
            and runs["vlm c serve plain"] == zero and same
            and e_pre <= VLM_TOL32 and e_dec <= VLM_TOL32):
        raise AssertionError(f"(c): launches {runs['vlm c serve kernel']}, "
                             f"{runs['vlm c serve plain']}; tokens equal "
                             f"{same}; logits {e_pre:.3e}, {e_dec:.3e}")


def _audio_vlm_phase(torch):
    """Phase 16 (a)-(c). Returns the launches of its runs by run and K3's
    launches by K3_SHAPES row."""
    import gc
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[audio] phase 16 starts with "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated by "
          f"earlier phases", flush=True)
    runs = {}
    t = time.perf_counter()
    _hubert(torch, runs)
    print(f"[audio] (a) {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    _qwen2_vl(torch, runs)
    print(f"[vlm] (b) {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    _vlm_serve(torch, runs)
    print(f"[vlm] (c) {time.perf_counter() - t:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    k3 = {"hubert encode": runs["audio a"]["flash_attention"],
          "qwen2-vl prefill": (runs["vlm b prefill grid"]["flash_attention"]
                               + runs["vlm b prefill launcher"][
                                   "flash_attention"])}
    print(f"[audio] phase 16 {time.perf_counter() - t0:.1f} s", flush=True)
    return runs, k3


# ---------------------------------------------------------------------------
# Phase 17: the serving example's twin (repro_torch.examples.serve_decode),
# under phase 6's deterministic algorithms, after phase 16 and before phase
# 11's profiler. (a) its __main__ as the JAX script runs it (smoke_config,
# float32), on the kernel route and on the plain route; (b) serve() at full
# width in bf16, batch 2, 12 new tokens: llama3-8b whole on 512-token
# prompts (a linear KV cache), mixtral cut to 4 layers as phase 13 (c) cuts
# it on prompts past its 4096 window (the ring buffer), zamba2-2.7b at its
# 54 layers (SSM states and the shared block's KV cache) and xlstm-125m
# whole (recurrent memories) on 512-token prompts; (c) mixtral's ring at
# full width in float32, held against one windowed forward; (d) the JAX
# package's public kernel wrappers on CUDA tensors.
SD_BATCH, SD_GEN = 2, 12
# arch, prompt length, depth cut (0: whole)
SD_FULL = (("llama3-8b", 512, 0), ("mixtral-8x7b", 4160, MIX_LAYERS),
           ("zamba2-2.7b", 512, 0), ("xlstm-125m", 512, 0))
# (a): the float32 smoke models' logits, K3 route against the plain route
# (only the summation order differs); (c): the ring's decode logits against
# the full forward (the CPU tests' bound for decode against a forward)
SD_ROUTES_TOL = 1e-5
SD_RING_TOL = 1e-4


def _prefill_k3(cfg):
    """K3 launches of one prefill: one per attention layer."""
    if cfg.family == "ssm":
        return 0
    return _attn_layers(cfg) if cfg.family == "hybrid" else cfg.n_layers


def _sd_k3_dims(cfg, T):
    return (SD_BATCH, cfg.n_heads, cfg.n_kv_heads, T, T, cfg.d_head, True,
            cfg.window)


def _sd_launch_check(label, got, cfg):
    want = {"ligo_blend_expand_grouped": 0, "ligo_blend_expand_bwd_fused": 0,
            "flash_attention": _prefill_k3(cfg)}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, want {want} (K3 once "
                             f"per attention layer of the prefill)")


def _sd_smoke(torch, runs, k3, shapes):
    """17 (a): the twin's __main__ on both routes."""
    from repro_torch.examples import serve_decode
    from repro_torch.kernels import ops
    out = {}
    for route, use_kernel in (("kernel", None), ("plain", False)):
        ops.reset_launch_counts()
        out[route] = serve_decode.main([], use_kernel=use_kernel)
        got = ops.launch_counts()
        want = sum(_prefill_k3(r["cfg"]) for r in out[route].values())
        if got != {"ligo_blend_expand_grouped": 0,
                   "ligo_blend_expand_bwd_fused": 0,
                   "flash_attention": want if use_kernel is None else 0}:
            raise AssertionError(f"(a) {route} route launches {got}, K3 "
                                 f"{want} on the kernel route, none on the "
                                 f"plain route")
        if use_kernel is None:
            runs["serve_decode a"] = got
    for arch in serve_decode.ARCHS:
        kr, pr = out["kernel"][arch], out["plain"][arch]
        lk, lp = (torch.cat([r["prefill_logits"][None], r["decode_logits"]])
                  for r in (kr, pr))
        err = ((lk - lp).abs().max() / lp.abs().max()).item()
        same = torch.equal(kr["tokens"], pr["tokens"])
        cfg = kr["cfg"]
        print(f"[sd] (a) {arch} smoke ({cfg.n_layers} layers, "
              f"{cfg.dtype}): cache {kr['cache']}, K3 "
              f"{_prefill_k3(cfg)} a prefill; tokens on the K3 route equal "
              f"to the plain route's: {same}; logits normalised max error "
              f"{err:.2e} (tol {SD_ROUTES_TOL:.0e})", flush=True)
        if not (same and err <= SD_ROUTES_TOL
                and bool(torch.isfinite(lk).all())):
            raise AssertionError(f"(a) {arch}: tokens equal {same}, logits "
                                 f"{err:.3e}")
        if _prefill_k3(cfg):
            name = f"serve_decode smoke {arch}"
            k3[name] = _prefill_k3(cfg)
            shapes.append((name, cfg.dtype, _sd_k3_dims(cfg, 48)))


def _sd_cache_line(torch, state):
    """The decode state's kind, its KV cache's rows, and one slot's bytes."""
    from repro_torch.models.model import slot_bytes
    caches = state["caches"]
    kv = [b for b in (caches if isinstance(caches, tuple) else (caches,))
          if isinstance(b, dict) and set(b) == {"k", "v"}]
    rows = kv[0]["k"].shape[2] if kv else 0
    per = slot_bytes(caches)
    return (f"cache {type(caches).__name__} ({rows} KV rows a slot; "
            f"recurrent {per['recurrent'] / 1e6:.3f} MB + attention "
            f"{per['attention'] / 1e6:.3f} MB a slot)"), rows


def _sd_full(torch, runs, k3, shapes):
    """17 (b): serve() at full width, bf16."""
    from repro_torch.configs import get_config
    from repro_torch.examples import serve_decode
    from repro_torch.kernels import ops
    for arch, T, cut in SD_FULL:
        cfg = get_config(arch)
        if cut:
            cfg = cfg.scaled(name=f"{cfg.name}-{cut}l", n_layers=cut)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        res = serve_decode.serve(arch, batch=SD_BATCH, prompt_len=T,
                                 gen=SD_GEN, cfg=cfg)
        got = ops.launch_counts()
        _sd_launch_check(f"(b) {arch}", got, cfg)
        runs[f"serve_decode b {arch}"] = got
        peak = torch.cuda.max_memory_allocated() / 1e9
        res["prompts"] = res["batch"]["tokens"]
        _check_serve(torch, res, SD_BATCH, SD_GEN)
        line, rows = _sd_cache_line(torch, res["state"])
        if cfg.window and rows != cfg.window:
            raise AssertionError(f"(b) {arch}: the ring holds {rows} rows, "
                                 f"want the window {cfg.window}")
        print(f"[sd] (b) {cfg.name} ({cfg.param_count() / 1e9:.2f} B, "
              f"bf16), {SD_BATCH} x {T} tokens: launches {got}; prefill "
              f"{res['prefill_ms']:.1f} ms (first call), decode "
              f"{res['tok_s']:.1f} tok/s; {line}; peak device memory "
              f"{peak:.1f} GB", flush=True)
        if _prefill_k3(cfg):
            name = f"serve_decode {arch}"
            k3[name] = _prefill_k3(cfg)
            shapes.append((name, "bfloat16", _sd_k3_dims(cfg, T)))
        if cfg.family == "moe":
            _, _, _, mline, ok = _moe_prefill_check(
                torch, res["params"], cfg, res["prompts"], T + SD_GEN)
            print(f"[sd] (b) {cfg.name} {mline}", flush=True)
            if not ok:
                raise AssertionError(f"(b) {arch}: the prefill through K3 "
                                     f"disagrees with the plain route")
        else:
            _prefill_check(torch, res, None, 1e-4, 1e-2, turns=("plain",))
        del res
    torch.cuda.empty_cache()


def _sd_ring(torch, runs, k3, shapes):
    """17 (c): mixtral's ring at full width in float32 (the 4-layer cut,
    capacity E / k, so no token drops): the 12 steps' logits against one
    windowed forward of the prompt and the generated tokens, on the plain
    attention route, each MoE layer of the forward taking the expert
    choices the serve run made (``_moe_routes``: a near tie may route a
    token otherwise on another path)."""
    from repro_torch.configs import get_config
    from repro_torch.examples import serve_decode
    from repro_torch.kernels import ops
    from repro_torch.models import model, moe
    mix = get_config("mixtral-8x7b")
    cfg = mix.scaled(name=f"{mix.name}-{MIX_LAYERS}l-f32", n_layers=MIX_LAYERS,
                     dtype="float32",
                     capacity_factor=mix.n_experts / mix.experts_top_k)
    T = SD_FULL[1][1]
    rec = {"top_e": [], "i": 0, "flips": 0}
    orig, record = _moe_routes("record", rec)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    try:
        moe.route = record
        res = serve_decode.serve("mixtral-8x7b", batch=SD_BATCH, prompt_len=T,
                                 gen=SD_GEN, cfg=cfg)
    finally:
        moe.route = orig
    got = ops.launch_counts()
    _sd_launch_check("(c)", got, cfg)
    runs["serve_decode c"] = got
    name = "serve_decode mixtral float32"
    k3[name] = _prefill_k3(cfg)
    shapes.append((name, "float32", _sd_k3_dims(cfg, T)))
    # the expert choices of each layer, the prefill's rows then each decode
    # step's, in the full forward's row order (b, t)
    L, k = cfg.n_layers, cfg.experts_top_k
    steps = SD_GEN - 1
    if len(rec["top_e"]) != L * (1 + steps):
        raise AssertionError(f"(c) {len(rec['top_e'])} routing calls, want "
                             f"{L * (1 + steps)}")
    rep = {"i": 0, "flips": 0, "top_e": [
        torch.cat([rec["top_e"][l].view(SD_BATCH, T, k)]
                  + [rec["top_e"][L * (1 + i) + l].view(SD_BATCH, 1, k)
                     for i in range(steps)], dim=1).reshape(-1, k)
        for l in range(L)]}
    _, replay = _moe_routes("replay", rep)
    toks = torch.cat([res["batch"]["tokens"], res["tokens"][:, :-1]], dim=1)
    t0 = time.perf_counter()
    try:
        moe.route = replay
        with torch.no_grad():
            hidden, _ = model.forward(res["params"], cfg, {"tokens": toks},
                                      use_kernel=False)
            full = model.unembed(res["params"], cfg, hidden[:, T - 1:])
        torch.cuda.synchronize()
    finally:
        moe.route = orig
    ms = (time.perf_counter() - t0) * 1e3
    served = torch.cat([res["prefill_logits"][None],
                        res["decode_logits"]]).transpose(0, 1)
    err = ((served - full).abs().max() / full.abs().max()).item()
    line, rows = _sd_cache_line(torch, res["state"])
    print(f"[sd] (c) {cfg.name} ({cfg.param_count() / 1e9:.2f} B, float32, "
          f"capacity {cfg.capacity_factor:g}), {SD_BATCH} x {T} tokens, "
          f"window {cfg.window}: {line}; prefill + {steps} decode steps "
          f"against one forward of {toks.shape[1]} tokens on the plain "
          f"route ({ms:.0f} ms): normalised max error {err:.2e} (tol "
          f"{SD_RING_TOL:.0e}); expert choices replayed from the serve run, "
          f"{rep['flips']} of {toks.numel() * L} token-layer choices the "
          f"forward would have made otherwise; launches {got}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB",
          flush=True)
    if not (err <= SD_RING_TOL and rows == cfg.window
            and bool(torch.isfinite(served).all())):
        raise AssertionError(f"(c) the ring's decode disagrees with the "
                             f"windowed forward: {err:.3e} (ring {rows})")
    del res, full, hidden
    torch.cuda.empty_cache()


def _sd_wrappers(torch):
    """17 (d): the JAX package's public wrappers on CUDA tensors, each
    against its plain version on the same inputs with phase 2's tolerances:
    ``ligo_blend_expand`` and ``ligo_grow`` at one gpt2-base ->
    gpt2-medium leaf (bf16 and float32), ``ligo_blend_expand_vjp``'s
    gradients (one K1 and one K2 launch) and ``ligo_blend_expand_bwd_fused``
    (bf16), ``flash_attention`` at llama3-8b's prefill shape; each call's
    launches and ``LAUNCH_COUNTS`` counted. Check launches: none joins the
    main path's count."""
    import repro_torch.kernels as tk
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    c1, c2 = get_config("gpt2-base"), get_config("gpt2-medium")
    L2, L1, I, A = c2.n_layers, c1.n_layers, c2.d_model, c1.d_model

    def counted(fn):
        n0, c0 = ops.launch_counts(), dict(tk.LAUNCH_COUNTS)
        out = fn()
        torch.cuda.synchronize()
        n1, c1_ = ops.launch_counts(), dict(tk.LAUNCH_COUNTS)
        return out, ({k: n1[k] - n0[k] for k in n1},
                     {k: c1_.get(k, 0) - c0.get(k, 0) for k in ("fwd", "bwd")})

    def held(label, got, want, tol, launches, want_launches):
        _, err = _norm_err(got, want)
        ok = (err <= tol and bool(torch.isfinite(got).all())
              and launches == want_launches)
        print(f"[sd] (d) {label}: normalised max error {err:.2e} (tol "
              f"{tol:.0e}); launches {launches[0]}, LAUNCH_COUNTS "
              f"{launches[1]} {'OK' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"(d) {label}: {err:.3e}, launches "
                                 f"{launches}, want {want_launches}")

    def k(n1=0, n2=0, n3=0):
        return ({"ligo_blend_expand_grouped": n1,
                 "ligo_blend_expand_bwd_fused": n2, "flash_attention": n3},
                {"fwd": n1, "bwd": n2})

    for i, dt in enumerate((torch.bfloat16, torch.float32)):
        name = str(dt).replace("torch.", "")
        tol = TOL[name]
        gen = torch.Generator(device="cuda").manual_seed(700 + i)
        w = torch.randn((L2, L1), generator=gen, device="cuda") / L1
        B, W, R = (torch.randn(shape, generator=gen, device="cuda").mul(
            0.05).to(dt) for shape in ((I, A), (L1, A, A), (I, A)))
        P, n = counted(lambda: tk.ligo_blend_expand(w, B, W))
        held(f"ligo_blend_expand {name} (L2 {L2}, L1 {L1}, I {I}, A {A}, Bd "
             f"{A})", P, ref.ligo_blend_expand_ref(w, B, W), tol, n, k(1))
        G_, n = counted(lambda: tk.ligo_grow(w, B, R, W))
        held(f"ligo_grow {name} (right expansion to {I})", G_,
             ref.ligo_grow_ref(w, B, R, W), tol, n, k(1))
    # the vjp's gradients and the fused backward, bf16
    dt, tol = torch.bfloat16, TOL["bfloat16"]
    gen = torch.Generator(device="cuda").manual_seed(710)
    w = torch.randn((L2, L1), generator=gen, device="cuda") / L1
    B, W, C = (torch.randn(shape, generator=gen, device="cuda").mul(
        0.05).to(dt) for shape in ((I, A), (L1, A, A), (L2, I, A)))

    def grads(use_kernel):
        xs = [x.clone().requires_grad_() for x in (w, B, W)]
        P = tk.ligo_blend_expand_vjp(*xs, use_kernel=use_kernel)
        P.backward(C)
        return [P.detach()] + [x.grad for x in xs]
    got, n = counted(lambda: grads(None))
    want, n_plain = counted(lambda: grads(False))
    terms = _dw_terms(torch, C[None, :, None],
                      ref.ligo_expand_ref(B, W[None, :, None]))[0]
    dw_err = ((got[1] - want[1]).abs() / (terms + 1e-30)).max().item()
    held("ligo_blend_expand_vjp forward", got[0], want[0], tol, n, k(1, 1))
    for label, g, p in (("dB", got[2], want[2]), ("dW", got[3], want[3])):
        held(f"ligo_blend_expand_vjp {label}", g, p, tol, n, k(1, 1))
    print(f"[sd] (d) ligo_blend_expand_vjp dw: max error over the size of "
          f"its terms {dw_err:.2e} (tol {tol:.0e}); the plain route "
          f"launched {n_plain[0]}", flush=True)
    if dw_err > tol or n_plain != k():
        raise AssertionError(f"(d) vjp dw {dw_err:.3e}, plain route "
                             f"launches {n_plain}")
    (dw, dB, dW), n = counted(lambda: tk.ligo_blend_expand_bwd_fused(
        w[None], B, W[None, :, None], C[None, :, None]))
    rw, rB, rW = ref.ligo_blend_expand_bwd_ref(w[None], B, W[None, :, None],
                                               C[None, :, None])
    dw_err = ((dw - rw).abs() / (terms[None] + 1e-30)).max().item()
    held("ligo_blend_expand_bwd_fused dB", dB, rB, tol, n, k(0, 1))
    held("ligo_blend_expand_bwd_fused dW", dW, rW, tol, n, k(0, 1))
    if dw_err > tol:
        raise AssertionError(f"(d) bwd_fused dw {dw_err:.3e}")
    # K3's public function at llama3-8b's prefill shape
    gen = torch.Generator(device="cuda").manual_seed(720)
    q, kk, v = (torch.randn(shape, generator=gen, device="cuda").to(dt)
                for shape in ((4, 32, 2048, 128), (4, 8, 2048, 128),
                              (4, 8, 2048, 128)))
    o, n = counted(lambda: tk.flash_attention(q, kk, v))
    want = tk.flash_attention_ref(q, kk, v)
    diff = (o.float() - want.float()).abs()
    tol3 = K3_TOL["bfloat16"]
    ok = bool((diff <= tol3 + tol3 * want.float().abs()).all())
    print(f"[sd] (d) flash_attention bfloat16 (4, 32/8 heads, 2048, 128): "
          f"max abs error {diff.max().item():.2e} (tol {tol3:.0e} + "
          f"{tol3:.0e}|plain|); launches {n[0]} "
          f"{'OK' if ok and n[0] == k(n3=1)[0] else 'FAIL'}", flush=True)
    if not (ok and n[0] == k(n3=1)[0]):
        raise AssertionError(f"(d) flash_attention: {diff.max().item():.3e}, "
                             f"launches {n[0]}")


def _serve_decode_phase(torch):
    """Phase 17 (a)-(d). Returns the launches of its runs by run, K3's
    launches by shape, and K3's rows at those shapes (held against its
    plain version)."""
    import gc
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[sd] phase 17 starts with "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated by "
          f"earlier phases", flush=True)
    runs, k3, shapes = {}, {}, []
    for label, fn in (("a", _sd_smoke), ("b", _sd_full), ("c", _sd_ring)):
        t = time.perf_counter()
        fn(torch, runs, k3, shapes)
        print(f"[sd] ({label}) {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    _sd_wrappers(torch)
    print(f"[sd] (d) {time.perf_counter() - t:.1f} s", flush=True)
    rows = [_check_k3(torch, name, dtype, *dims, seed=800 + i)
            for i, (name, dtype, dims) in enumerate(shapes)]
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[sd] phase 17 {time.perf_counter() - t0:.1f} s", flush=True)
    return runs, k3, rows


def main() -> int:
    # cuBLAS is deterministic under use_deterministic_algorithms (phase 6)
    # only with a fixed workspace, set before its first handle
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs on "
              "the card only", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: the port's sources are missing ({SRC}/repro_torch)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.configs import get_config
    from repro_torch.core.plan import plan_for
    from repro_torch.examples import quickstart
    from repro_torch.kernels import _build, ops
    from repro_torch.launch import serve, train
    from repro_torch.models.model import prefill

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | "
          f"allow_tf32=False (f32 matmuls in full f32)", flush=True)

    # -- phase 1: build -----------------------------------------------------
    secs = _build.build()
    for name in _build.SOURCES:
        print(f"[build] {name}.cu: "
              + (f"compiled in {secs[name]:.1f} s (builds run concurrently)"
                 if name in secs else "current build reused"), flush=True)
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[ptxas] {name}: {line.strip()}")

    # -- phase 2: each kernel against its plain version -----------------------
    # at every shape and dtype the main paths give K1 and K2: the bf16 grow
    # and LiGO step of gpt2-base -> gpt2-medium (seeds 100 + i for K1, 200 +
    # i for K2), the float32 grow of the AdamW moments that rides the
    # trajectory's hop (m by the operator, v by its square; 110 + i and
    # 120 + i) and the quickstart's float32 LiGO phase (130 + i, 230 + i)
    cfg1, cfg2 = get_config("gpt2-base"), get_config("gpt2-medium")
    shapes = _k1_shapes(torch, cfg1, cfg2)
    qs_shapes = _k1_shapes(torch, quickstart.SMALL, quickstart.BIG)
    k1_main = _k1_checks(shapes)
    rows = [_check_k1(torch, name, torch.bfloat16, *d, seed=100 + i, j=j)
            for i, (name, d, j) in enumerate(k1_main)]
    main_rows = rows[:]
    rows += [_check_k1(torch, f"{name} {mom}", torch.float32, *d,
                       seed=seed + i, square=mom == "v", j=j)
             for mom, seed in (("m", 110), ("v", 120))
             for i, (name, d, j) in enumerate(_k1_checks(shapes))]
    qs_k1 = _k1_checks(qs_shapes)
    rows += [_check_k1(torch, f"qs {name}", torch.float32, *d, seed=130 + i,
                       j=j)
             for i, (name, d, j) in enumerate(qs_k1)]
    rows += [_check_k1(torch, name, getattr(torch, dt), *dims, seed=seed)
             for name, dt, dims, seed in K1_EXTRA_SHAPES]
    routes = [r["tensor_cores"] for r in rows]
    if routes != ([True] * len(k1_main) + [False] * (2 * len(k1_main)
                                                     + len(qs_k1))
                  + [False, False, True, False]):
        raise AssertionError(f"K1 routes {routes}: the bf16 main-path and "
                             f"aligned shapes must take the tensor cores, the "
                             f"float32 and unaligned ones the float32 GEMM")
    k2_main = _k2_checks(shapes)
    rows2 = [_check_k2(torch, name, torch.bfloat16, *d, seed=200 + i,
                       need_dW=need, j=j)
             for i, (name, d, j, need) in enumerate(k2_main)]
    main_rows2 = rows2[:]
    qs_k2 = _k2_checks(qs_shapes)
    rows2 += [_check_k2(torch, f"qs {name}", torch.float32, *d, seed=230 + i,
                        need_dW=need, j=j)
              for i, (name, d, j, need) in enumerate(qs_k2)]
    rows2 += [_check_k2(torch, name, getattr(torch, dt), *dims, seed=seed)
              for name, dt, dims, seed in K2_EXTRA_SHAPES]
    routes = [r["tensor_cores"] for r in rows2]
    if routes != ([True] * len(k2_main) + [False] * len(qs_k2)
                  + [False, False, True, False]):
        raise AssertionError(f"K2 routes {routes}: the bf16 main-path and "
                             f"aligned shapes must take the tensor cores, the "
                             f"float32 and unaligned ones the float32 GEMM")
    _check_f32_trace()
    TRACE_F32[0] = False
    n_bits = sum(1 for r in rows2 if r["u_bitwise"])
    print(f"[k2] K1's U equal bit for bit to the U K2 computes for itself, "
          f"and K2 fed K1's U equal bit for bit to K2 on its own, at "
          f"{n_bits} shapes (every K2 check without a split)", flush=True)
    mom_rows = rows[len(k1_main):3 * len(k1_main)]
    print(f"[k1] one float32 grow of both AdamW moments (phase 2, "
          f"{2 * _launches(shapes, False)[0]} launches): kernel "
          f"{sum(r['ms'] for r in mom_rows):.1f} ms, plain "
          f"{sum(r['plain_ms'] for r in mom_rows):.1f} ms, library "
          f"{sum(r['library_ms'] for r in mom_rows):.1f} ms, bound "
          f"{sum(r['bound_ms'] for r in mom_rows):.1f} ms", flush=True)
    # phase 8's groups: both vision pairs' LiGO steps and grows, bf16
    vision = {}
    for i, (a, b, *_) in enumerate(VISION):
        vshapes = _k1_shapes(torch, get_config(a), get_config(b))
        vision[b] = (
            [_check_k1(torch, f"{b} {name}", torch.bfloat16, *d,
                       seed=140 + 10 * i + n, j=j)
             for n, (name, d, j) in enumerate(_k1_checks(vshapes))],
            [_check_k2(torch, f"{b} {name}", torch.bfloat16, *d,
                       seed=240 + 10 * i + n, need_dW=need, j=j)
             for n, (name, d, j, need) in enumerate(_k2_checks(vshapes))])
        if not all(r["tensor_cores"] for r in vision[b][0] + vision[b][1]):
            raise AssertionError(f"{b}: every bf16 K1 and K2 shape of the "
                                 f"pair has widths that are multiples of 8 "
                                 f"and must take the tensor cores")
        rows += vision[b][0]
        rows2 += vision[b][1]
    # phase 9's LEMON hop gpt2-medium -> gpt2-medium-ff2 (its grow, bf16)
    lemon_shapes = _k1_shapes(torch, cfg2, cfg2.scaled(
        name=f"{cfg2.name}-ff2", d_ff=2 * cfg2.d_ff))
    lemon_rows = [_check_k1(torch, f"lemon {sh['name']}", torch.bfloat16,
                            *d, seed=160 + n)
                  for n, sh in enumerate(lemon_shapes)
                  for _, d in _k1_calls(sh, False)]
    if not all(r["tensor_cores"] for r in lemon_rows):
        raise AssertionError("the LEMON hop's bf16 K1 shapes must take the "
                             "tensor cores")
    rows += lemon_rows
    # phase 16's groups: hubert-xlarge's grow and LiGO step, qwen2-vl-72b's
    # hot-grow and LiGO step, bf16
    av_k1, av_k2 = _audio_vlm_kernel_checks(torch)
    if not all(r["tensor_cores"] for r in av_k1 + av_k2):
        raise AssertionError("the audio and VLM pairs' bf16 K1 and K2 shapes "
                             "have widths that are multiples of 8 and must "
                             "take the tensor cores")
    rows += av_k1
    rows2 += av_k2

    k3_rows = [_check_k3(torch, name, dtype, *dims, seed=300 + i)
               for i, (name, dtype, dims) in enumerate(K3_SHAPES)]
    routes = [r["tensor_cores"] for r in k3_rows]
    want_routes = [r["dtype"] == "bfloat16" and r["pad"] == 0
                   and r["dh"] <= 128 and r["dh"] % 8 == 0 for r in k3_rows]
    if routes != want_routes:
        raise AssertionError(f"K3 routes {routes}, want {want_routes}: bf16 "
                             f"with aligned rows takes the tensor cores at "
                             f"every dh up to 128, float32 and unaligned "
                             f"rows the FMA kernel")

    # -- phase 3: the serving main path at full width ------------------------
    ops.reset_launch_counts()
    res = serve.main(MAIN_ARGS)
    launches = ops.launch_counts()
    print(f"[main] launches during the serving path: {launches}", flush=True)
    want = {"ligo_blend_expand_grouped": _launches(shapes, False)[0],
            "ligo_blend_expand_bwd_fused": 0,
            "flash_attention": cfg2.n_layers}
    if launches != want:
        raise AssertionError(f"kernel launches on the serving path: "
                             f"{launches}, want {want} (K1 once per eligible "
                             f"group, twice where the right expansion runs "
                             f"between its steps; K3 once per layer of the "
                             f"prefill)")
    with torch.no_grad():
        plan = plan_for(res["small_cfg"], res["cfg"], res["small"])
        plain = plan.apply(res["ligo"], res["small"], use_kernel=False)
        worst = _check_trees(torch, res["params"], plain, 1e-2)
        print(f"[main] kernel grow vs plain grow: worst per-leaf normalised "
              f"error {worst:.2e} (tol 1e-02, bf16)", flush=True)
        _check_serve(torch, res, 8, 32)
        # warm hot-grow, kernel path and plain path in turns
        small, ligo = res["small"], res["ligo"]
        warm = {"kernel": [], "plain": []}
        for route in ("kernel", "plain", "plain", "kernel"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plan.apply(ligo, small, use_kernel=(route == "kernel"))
            torch.cuda.synchronize()
            warm[route].append((time.perf_counter() - t0) * 1e3)
        # K1's GEMMs of one warm hot-grow: all six on the tensor cores
        ev = _profile(torch, "warm hot-grow, kernel route",
                      lambda: plan.apply(ligo, small, use_kernel=True))
        _check_gemm_launches(torch, "hot-grow", ev,
                             lambda: plan.apply(ligo, small, use_kernel=True),
                             {("wgmma", 3): len(shapes)})
        _moment_grow_check(torch, plan, ligo, small)
    del plain, plan, small, ligo, ev
    warm_pf = _prefill_check(torch, res, 2e-2, 1e-4, 1e-2)
    k1 = {key: sum(r[key] for r in main_rows)
          for key in ("ms", "library_ms", "library_minflop_ms", "bound_ms",
                      "gflop", "kernel_gflop", "mbytes")}
    print(f"[k1] one hot-grow (6 groups, bf16, phase 2): kernel "
          f"{k1['ms']:.3f} ms, library {k1['library_ms']:.3f} ms, library in "
          f"K1's order {k1['library_minflop_ms']:.3f} ms, bound "
          f"{k1['bound_ms']:.3f} ms | {k1['gflop']:.1f} GFLOP needed at least, "
          f"{k1['kernel_gflop']:.1f} GFLOP done by K1 (its own min-FLOP "
          f"order: {k1['kernel_gflop'] / k1['ms']:.1f} TFLOP/s), "
          f"{k1['mbytes']:.1f} MB moved at least", flush=True)
    print(f"[main] hot-grow {res['hot_grow_ms']:.1f} ms (first call) | warm "
          f"kernel path {warm['kernel']} ms, plain path {warm['plain']} ms | "
          f"prefill {res['prefill_ms']:.1f} ms (first call), warm K3 route "
          f"{warm_pf['kernel']} ms, plain route {warm_pf['plain']} ms | "
          f"decode {res['decode_tok_s']:.1f} tok/s", flush=True)
    del res

    # -- phase 3b: llama3-8b serving at full width ---------------------------
    t_llama = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    lres = serve.main(LLAMA_ARGS)
    llaunch = ops.launch_counts()
    print(f"[main] launches during the llama3-8b serving path: {llaunch}",
          flush=True)
    want = {"ligo_blend_expand_grouped": 0, "ligo_blend_expand_bwd_fused": 0,
            "flash_attention": lres["cfg"].n_layers}
    if llaunch != want:
        raise AssertionError(f"kernel launches on the llama3-8b serving path: "
                             f"{llaunch}, want {want} (K3 once per layer of "
                             f"the prefill)")
    _check_serve(torch, lres, 4, 32)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # 32 bf16 layers: the two bf16 routes lay 2.02e-2 apart, each 1.7-1.8e-2
    # from the float32 logits, while the float32 routes agreed to 4.3e-6
    # (this script on an NVIDIA H100 80GB HBM3, 700 W): the rounding sets
    # the bf16 gap, not K3.
    warm_pf = _prefill_check(torch, lres, None, 1e-4, 1e-2)
    k3_ms = lres["cfg"].n_layers * k3_rows[1]["ms"]
    print(f"[llama3-8b] {lres['cfg'].param_count() / 1e9:.2f} B parameters, "
          f"peak device memory {peak_gb:.1f} GB (serve run) | prefill "
          f"{lres['prefill_ms']:.1f} ms (first call), warm K3 route "
          f"{warm_pf['kernel']} ms, plain route {warm_pf['plain']} ms; K3 "
          f"{k3_ms:.1f} ms of it (32 x {k3_rows[1]['ms']:.3f} ms, phase 2), "
          f"{100 * k3_ms / min(warm_pf['kernel']):.0f} % of the faster warm "
          f"K3-route prefill | decode {lres['decode_tok_s']:.1f} tok/s | "
          f"phase {time.perf_counter() - t_llama:.1f} s", flush=True)
    with torch.no_grad():
        ev = _profile(torch, "llama3-8b prefill, K3 route",
                      lambda: prefill(lres["params"], lres["cfg"],
                                      {"tokens": lres["prompts"]}))
        _check_k3_launches(torch, "llama3-8b prefill",
                           lambda: prefill(lres["params"], lres["cfg"],
                                           {"tokens": lres["prompts"]}),
                           lres["cfg"].n_layers)
    # phase 9 (f) serves these parameters again through the engine
    llama = (lres["cfg"], lres["params"])
    del lres, ev
    torch.cuda.empty_cache()

    # -- phase 4: the training main path at full width -----------------------
    ops.reset_launch_counts()
    tres = train.main(TRAIN_ARGS)
    tlaunch = ops.launch_counts()
    print(f"[main] launches during the training path: {tlaunch}", flush=True)
    k1_ligo, k2_ligo = _launches(shapes, True)
    want = {"ligo_blend_expand_grouped": (k1_ligo * LIGO_STEPS
                                          + _launches(shapes, False)[0]),
            "ligo_blend_expand_bwd_fused": k2_ligo * LIGO_STEPS,
            "flash_attention": 0}
    if tlaunch != want:
        raise AssertionError(f"kernel launches on the training path: "
                             f"{tlaunch}, want {want} (K1 and K2 once per "
                             f"eligible group per LiGO step, twice where the "
                             f"right expansion runs between K1's steps, K1 "
                             f"also on the final grow, K3 never: every "
                             f"forward there records autograd)")
    if tres["restarts"] != 0:
        raise AssertionError(f"the training path's supervisor restarted "
                             f"{tres['restarts']} times: a step raised")
    losses = (tres["source_losses"] + tres["ligo_losses"]
              + tres["train_losses"])
    if len(tres["ligo_losses"]) != LIGO_STEPS or not all(
            math.isfinite(x) for x in losses):
        raise AssertionError(f"training losses: {losses}")
    _ligo_grad_check(torch, tres, 1e-4, 1e-2)
    tres["shapes"] = shapes
    u_gb = _saved_u_gb(torch, tres)
    print(f"[train] K1's float32 U kept for K2 by the growth of one LiGO "
          f"forward (saved-tensors hook): {u_gb:.3f} GB", flush=True)
    _profile_steps(torch, tres)
    print(f"[train] losses: source {tres['source_losses']}, LiGO "
          f"{tres['ligo_losses']}, gpt2-medium {tres['train_losses']}")
    print(f"[train] ms per LiGO step {tres['ligo_step_ms']} | ms per train "
          f"step {tres['train_step_ms']} | {tres['tok_s']:.0f} tokens/s "
          f"(median step, first left out)", flush=True)
    del tres          # not read again: free its trees for the later phases
    k2 = {key: sum(r[key] for r in main_rows2)
          for key in ("ms", "library_ms", "library_minflop_ms", "bound_ms",
                      "gflop", "mbytes")}
    print(f"[k2] one LiGO backward (6 groups, bf16, phase 2): kernel "
          f"{k2['ms']:.3f} ms, library {k2['library_ms']:.3f} ms, library in "
          f"the min-FLOP order {k2['library_minflop_ms']:.3f} ms, bound "
          f"{k2['bound_ms']:.3f} ms | {k2['gflop']:.1f} GFLOP (min-FLOP "
          f"order, K2's own: {k2['gflop'] / k2['ms']:.1f} TFLOP/s), "
          f"{k2['mbytes']:.1f} MB moved at least", flush=True)

    # -- phase 6: the trajectory path at full width --------------------------
    # bitwise kill-and-resume needs deterministic kernels throughout: any op
    # without a deterministic implementation raises here
    torch.use_deterministic_algorithms(True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_traj_")
    try:
        traj = _trajectory_phase(torch, tmp, shapes)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # -- phase 7: the quickstart twin at the script's own size ---------------
    traj["launches"]["quickstart"] = _quickstart_phase()

    # -- phase 8: the paper's vision pairs at full width ---------------------
    vlaunch, vreport = _vision_phase(torch)
    traj["launches"].update({f"vision {b}": n for b, n in vlaunch.items()})
    by_name = {r["shape"]: r for r in k3_rows}
    for a, b, batch, *_ in VISION:
        k1r, k2r = vision[b]
        k3r = by_name[f"{b} eval"]
        n3 = vlaunch[b]["flash_attention"]
        print(f"[report] {a} -> {b} (phase 2 rows, bf16): K1 one grow "
              f"{sum(r['ms'] for r in k1r):.3f} ms (plain "
              f"{sum(r['plain_ms'] for r in k1r):.3f}, library "
              f"{sum(r['library_ms'] for r in k1r):.3f}, bound "
              f"{sum(r['bound_ms'] for r in k1r):.3f}); K2 one LiGO "
              f"backward {sum(r['ms'] for r in k2r):.3f} ms (plain "
              f"{sum(r['plain_ms'] for r in k2r):.3f}, library "
              f"{sum(r['library_ms'] for r in k2r):.3f}, bound "
              f"{sum(r['bound_ms'] for r in k2r):.3f}); K3 one eval "
              f"forward {n3} x {k3r['ms']:.4f} ms (SDPA {k3r['library_ms']:.4f}"
              f", bound {k3r['bound_ms']:.4f}, "
              f"{'wgmma' if k3r['tensor_cores'] else 'fma'}); launches "
              f"{vlaunch[b]}; LiGO step FLOPs / 6ND "
              f"{vreport[b]['ratio']:.3f} (plain route "
              f"{vreport[b]['plain_ratio']:.3f}); phase "
              f"{vreport[b]['seconds']:.1f} s", flush=True)

    # -- phase 9: the live engine at full width -----------------------------
    live_runs, k3_engine, vanilla = _live_phase(torch, shapes, llama)
    del llama
    traj["launches"].update(live_runs)

    # -- phase 10: speculative decoding through the live hop -----------------
    spec_runs, k3_spec = _spec_phase(torch, shapes, vanilla)
    traj["launches"].update(spec_runs)
    for shape, n in k3_spec.items():
        k3_engine[shape] += n

    # -- phase 12: the adaptive growth controller at full width -------------
    # (before phase 11, whose profiler slows the host for the rest of the
    # process)
    traj["launches"].update(_autogrow_phase(torch, shapes))

    # -- phase 13: the MoE family at full width -----------------------------
    moe_runs, k3_moe, moe_k1, moe_k2 = _moe_phase(torch)
    traj["launches"].update(moe_runs)
    for shape, n in k3_moe.items():
        k3_engine[shape] = k3_engine.get(shape, 0) + n
    rows += moe_k1
    rows2 += moe_k2

    # -- phase 14: the GQA merge and the sequence-mixer families -----------
    seq_runs, k3_seq, seq_k1, seq_k2 = _seqmix_phase(torch)
    traj["launches"].update(seq_runs)
    for shape, n in k3_seq.items():
        k3_engine[shape] = k3_engine.get(shape, 0) + n
    rows += seq_k1
    rows2 += seq_k2

    # -- phase 15: the live engine on the recurrent families ----------------
    recur_runs, k3_recur, recur_rows = _recurrent_phase(torch)
    traj["launches"].update(recur_runs)
    k3_engine.update(k3_recur)
    k3_rows += recur_rows

    # -- phase 16: the audio and VLM families -------------------------------
    av_runs, k3_av = _audio_vlm_phase(torch)
    traj["launches"].update(av_runs)
    k3_engine.update(k3_av)

    # -- phase 17: the serving example's twin --------------------------------
    sd_runs, k3_sd, sd_rows = _serve_decode_phase(torch)
    traj["launches"].update(sd_runs)
    k3_engine.update(k3_sd)
    k3_rows += sd_rows

    # -- phase 11: the observability layer at full width ---------------------
    obs_runs, k3_obs = _obs_phase(torch, shapes)
    traj["launches"].update(obs_runs)
    for shape, n in k3_obs.items():
        k3_engine[shape] += n

    # -- phase 5: report ------------------------------------------------------
    def entry(name, source, replaces, n, rows_, main_):
        t_ops = sum(r["gflop"] * 1e9 for r in main_) / PEAK_OPS["bfloat16"]
        t_bytes = sum(r["mbytes"] * 1e6 for r in main_) / PEAK_BYTES
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n,
            "max_abs_err": max(r["max_abs_err"] for r in rows_),
            "ms": sum(r["ms"] for r in main_),
            "plain_ms": sum(r["plain_ms"] for r in main_),
            "bound_ms": sum(r["bound_ms"] for r in main_),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": sum(r["library_ms"] for r in main_),
        }

    # launches: every main-path run, phases 6's and 7's included
    def total(name):
        return (launches[name] + llaunch[name] + tlaunch[name]
                + sum(c[name] for c in traj["launches"].values()))

    kernels = [
        entry("ligo_blend_expand_grouped", "src/repro_torch/csrc/ligo_expand.cu",
              "src/repro/kernels/ligo_expand.py:116",
              total("ligo_blend_expand_grouped"), rows, main_rows),
        entry("ligo_blend_expand_bwd_fused",
              "src/repro_torch/csrc/ligo_expand_bwd.cu",
              "src/repro/kernels/ligo_expand_bwd.py:141",
              total("ligo_blend_expand_bwd_fused"), rows2, main_rows2),
        # K3's times: its work in one gpt2-medium prefill (24 launches at
        # shape (a)) plus one llama3-8b prefill (32 launches at shape (b)),
        # plus the engine's prefills and re-prefills of phase 9 (a) and (f)
        # and phase 10 (a) (its drafter prefills too), and phases 13-17's
        # prefills (phase 15's at each exact length it sent; phase 16's
        # hubert encode and qwen2-vl prefills; phase 17's serving-example
        # twin)
        entry("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:72",
              total("flash_attention"), k3_rows,
              [k3_rows[0]] * launches["flash_attention"]
              + [k3_rows[1]] * llaunch["flash_attention"]
              + [r for r in k3_rows for _ in range(k3_engine.get(
                  r["shape"], 0))]),
    ]
    print(f"[done] {time.perf_counter() - t_start:.1f} s in all", flush=True)
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
